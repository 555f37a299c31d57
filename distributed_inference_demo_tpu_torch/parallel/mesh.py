"""Device meshes on ``torch.distributed``: ranks as processes, rank 0 drives.

Counterpart of ``distributed_inference_demo_tpu/parallel/mesh.py``.  The
reference is one controller over many devices (``jax.sharding.Mesh``
under ``shard_map``); PyTorch's idiom is one process per rank.  Here:

- :class:`Mesh` keeps the reference's named axes (``AXES``, tp
  innermost) and its ``shape`` mapping, and holds this rank's
  coordinates, its device and one process group per axis of size > 1
  (:class:`AxisGroup`, the collectives the forward uses;
  :class:`GradGroup` wraps one so that its collectives carry gradients,
  for training).  The mesh owns
  its groups: they are built on its own ``TCPStore``, never on the
  default group, so one process can build many meshes.
- :func:`local_tp_mesh` / :func:`local_sp_mesh` / :func:`local_mesh`
  start ``n - 1`` follower processes (``spawn``, daemon) and make the
  calling process rank 0.  A mesh is a context manager; ``close()``
  stops the followers (joined with a timeout, then killed).
- Rank 0 owns the engine, the scheduler, the page allocator, sampling
  and HTTP.  Followers hold their weight shard and their plane of every
  cache and page pool, in the mesh's object table (``mesh.objects``).
  Every device-side operation is issued by rank 0 as
  :meth:`Mesh.spmd`: a module-level function of the port, sent by
  reference with its arguments, that every rank then runs on its own
  objects and shard with the group's collectives.  Tensors in the
  arguments travel through host memory and land on each rank's device.
  The commands the engines issue are listed in ``parallel/tensor.py``.
- Backends, chosen once (:func:`choose_backend`) and shown in
  ``Mesh.describe()``: NCCL where each rank has its own card, gloo on the
  CPU, and gloo where ranks share one card (NCCL refuses two ranks on
  one device).  Under gloo a collective on device tensors goes through
  an explicit copy to pinned host memory, counted in
  ``stats["staged_bytes"]``; nothing swaps backends quietly.
- Headers and arguments go over a control group (gloo, host tensors)
  with a long timeout, since a follower waits there for as long as rank
  0 is idle; the data groups carry the forward's collectives under the
  mesh's ``timeout`` (``DWT_MESH_TIMEOUT_S``, default 300 s), so a hung
  rank fails its caller instead of hanging it.
"""

import dataclasses
import datetime
import os
import pickle
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

AXES = ("dp", "pp", "ep", "sp", "tp")

# a follower waits on the control group while rank 0 is idle (a server
# between requests): that wait must not time out
_CONTROL_TIMEOUT = datetime.timedelta(days=7)
_JOIN_TIMEOUT_S = 30.0


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.ep * self.tp * self.sp

    def axis_sizes(self) -> dict:
        return {"dp": self.dp, "pp": self.pp, "ep": self.ep,
                "tp": self.tp, "sp": self.sp}


def mesh_timeout_s() -> float:
    """The data groups' collective timeout (``DWT_MESH_TIMEOUT_S``)."""
    return float(os.environ.get("DWT_MESH_TIMEOUT_S", "") or 300.0)


def choose_backend(device: torch.device, world: int) -> str:
    """"nccl" where every rank can have its own card, else "gloo": on the
    CPU, and on one card shared by several ranks."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_device(device: torch.device, backend: str, rank: int
                ) -> torch.device:
    """Rank ``rank``'s device: its own card under NCCL, the one shared
    card (or the CPU) under gloo."""
    if device.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda":
        return torch.device("cuda", device.index or 0)
    return device


class _Arena:
    """Pinned host buffers a gloo collective stages device tensors
    through, one growable byte buffer per slot (an op needs at most an
    input and an output)."""

    def __init__(self):
        self._bufs = {}

    def get(self, slot: int, like: torch.Tensor) -> torch.Tensor:
        n = like.numel() * like.element_size()
        buf = self._bufs.get(slot)
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1 << 16), dtype=torch.uint8,
                              pin_memory=True)
            self._bufs[slot] = buf
        return buf[:n].view(like.dtype).view(like.shape)


class AxisGroup:
    """One mesh axis' process group and the collectives over it.  Every
    call is synchronous and returns a tensor on the caller's device;
    reductions in place.  Under gloo, device tensors are staged through
    pinned host memory (counted); non-reducing collectives move bytes."""

    def __init__(self, mesh: "Mesh", axis: str, pg, size: int, rank: int):
        self.mesh, self.axis, self.pg = mesh, axis, pg
        self.size, self.rank = size, rank
        self._arena = _Arena()

    # -- staging -------------------------------------------------------

    def _staged(self, t: torch.Tensor, slot: int):
        if self.mesh.backend != "gloo" or not t.is_cuda:
            return t.contiguous()
        h = self._arena.get(slot, t)
        h.copy_(t)
        self.mesh.stats["staged_bytes"] += t.numel() * t.element_size()
        return h

    def _unstage(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if h.device == like.device:
            return h
        self.mesh.stats["staged_bytes"] += h.numel() * h.element_size()
        return h.to(like.device)

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        st = self.mesh.stats
        st["collectives"] += 1
        st["collective_s"] += time.perf_counter() - t0
        return out

    # -- collectives ---------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max) over the axis, written into ``t``."""
        from torch.distributed import AllreduceOptions, ReduceOp
        opts = AllreduceOptions()
        opts.reduceOp = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX}[op]

        def run():
            h = self._staged(t, 0)
            self.pg.allreduce([h], opts).wait()
            if h.data_ptr() != t.data_ptr():
                t.copy_(h)
            return t
        return self._timed(run)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        def run():
            src = self._staged(t, 0)
            flat = _as_bytes(src)
            outs = [torch.empty_like(flat) for _ in range(self.size)]
            self.pg.allgather([outs], [flat]).wait()
            parts = [o.view(t.dtype).view(t.shape) for o in outs]
            return self._unstage(torch.cat(parts, dim=dim), t)
        return self._timed(run)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Split ``t`` into ``size`` equal blocks along dim 0, send block
        j to rank j, and return the received blocks in rank order (the
        reference's ``all_to_all(split_axis=0, concat_axis=0)``)."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 ({t.shape[0]}) not "
                             f"divisible by the axis size {self.size}")

        def run():
            src = _as_bytes(self._staged(t, 0))
            out = torch.empty_like(src)
            self.pg.alltoall_base(out, src, [], []).wait()
            return self._unstage(out.view(t.dtype).view(t.shape), t)
        return self._timed(run)

    def rotate(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The ring hop (the reference's ``ppermute`` i -> i + 1): send
        ``t`` to rank + ``shift``, return what rank - ``shift`` sent
        (``shift=-1`` is the hop back).  One ``alltoall_base`` with one
        non-empty split each way."""
        n = self.size

        def run():
            src = _as_bytes(self._staged(t, 0))
            m = src.numel()
            out = torch.empty_like(src)
            send = [0] * n
            recv = [0] * n
            send[(self.rank + shift) % n] = m
            recv[(self.rank - shift) % n] = m
            self.pg.alltoall_base(out, src, recv, send).wait()
            return self._unstage(out.view(t.dtype).view(t.shape), t)
        return self._timed(run)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` from axis rank ``src`` into every rank's ``t``."""
        from torch.distributed import BroadcastOptions
        opts = BroadcastOptions()
        opts.rootRank = src

        def run():
            h = self._staged(t, 0)
            self.pg.broadcast([_as_bytes(h)], opts).wait()
            if h.data_ptr() != t.data_ptr():
                t.copy_(h)
            return t
        return self._timed(run)


class _RingHop(torch.autograd.Function):
    """The ring hop i -> i + 1; its backward is the hop back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.rotate(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.rotate(g.contiguous(), shift=-1), None


class _SumOver(torch.autograd.Function):
    """The sum over an axis after a row-parallel product; its backward
    is the sum of the gradients (a psum's transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


class _GatherOver(torch.autograd.Function):
    """The vocab-parallel head's all-gather along ``dim``; its backward
    is the reduce-scatter: the gradients summed over the axis, this
    rank's slice kept."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        full = ctx.group.all_reduce(g.clone())
        part = full.narrow(ctx.dim, ctx.group.rank * ctx.width, ctx.width)
        return part.contiguous(), None, None


class GradGroup:
    """An :class:`AxisGroup` whose collectives carry gradients, under the
    sum/sum convention: every rank backpropagates its own copy of what a
    collective replicated, so a gradient through an axis of n ranks
    comes out n times the single-device one (``parallel/pipeline.py``
    divides it back).  ``models/decoder.py`` takes it as its ``tp``
    (``rank``, ``size``, ``all_reduce``, ``all_gather``); the pipeline's
    hop is :meth:`rotate`."""

    def __init__(self, group: AxisGroup):
        self.group = group
        self.axis, self.rank, self.size = group.axis, group.rank, group.size

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _SumOver.apply(t, self.group)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherOver.apply(t, self.group, dim)

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        return _RingHop.apply(t, self.group)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view (gloo moves any
    dtype that way, float8 and bf16 included)."""
    if not t.numel():
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    flat = t.contiguous().reshape(-1)
    if flat.stride(0) != 1:       # a broadcast one-element view
        flat = flat.new_empty(flat.shape).copy_(flat)
    return flat.view(torch.uint8)


class _Packed:
    """A tensor on the wire: its bytes, dtype and shape (pickle cannot
    carry every dtype, float8 among them)."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu().contiguous()
        self.dtype, self.shape = str(t.dtype), tuple(t.shape)
        self.data = _as_bytes(t).numpy().tobytes()

    def unpack(self, device) -> torch.Tensor:
        dtype = getattr(torch, self.dtype.replace("torch.", ""))
        raw = torch.frombuffer(bytearray(self.data), dtype=torch.uint8) \
            if self.data else torch.empty(0, dtype=torch.uint8)
        return raw.view(dtype).view(self.shape).to(device)


def _pack(obj):
    return _map_tensors(obj, _Packed)


def _unpack(obj, device):
    if isinstance(obj, _Packed):
        return obj.unpack(device)
    if isinstance(obj, tuple):
        return tuple(_unpack(o, device) for o in obj)
    if isinstance(obj, list):
        return [_unpack(o, device) for o in obj]
    if isinstance(obj, dict):
        return {k: _unpack(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _replace_fields(obj, lambda v: _unpack(v, device))
    return obj


def _replace_fields(obj, fn):
    """A dataclass (a quantized leaf, a page pool, a config) with ``fn``
    over its init fields."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name))
        for f in dataclasses.fields(obj) if f.init})


def _map_tensors(obj, fn):
    """``fn`` over every tensor in nested tuples, lists and dicts."""
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_tensors(o, fn) for o in obj)
    if isinstance(obj, list):
        return [_map_tensors(o, fn) for o in obj]
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if (dataclasses.is_dataclass(obj) and not isinstance(obj, type)
            and any(torch.is_tensor(getattr(obj, f.name))
                    for f in dataclasses.fields(obj))):
        # a quantized leaf or page pool
        return _replace_fields(obj, lambda v: _map_tensors(v, fn))
    return obj


def _make_pg(backend: str, store, rank: int, size: int,
             timeout: datetime.timedelta, device: torch.device):
    from torch.distributed import ProcessGroupGloo
    if backend == "gloo":
        return ProcessGroupGloo(store, rank, size, timeout)
    from torch.distributed import ProcessGroupNCCL
    opts = ProcessGroupNCCL.Options()
    opts._timeout = timeout
    torch.cuda.set_device(device)
    return ProcessGroupNCCL(store, rank, size, opts)


class Mesh:
    """This rank's view of a named mesh of ``world`` processes."""

    def __init__(self, cfg: MeshConfig, rank: int, store, device,
                 backend: str, timeout_s: Optional[float] = None,
                 procs=None):
        self.config = cfg
        self.shape = cfg.axis_sizes()
        self.world = cfg.num_devices
        self.rank = rank
        self.backend = backend
        self.device = rank_device(torch.device(device), backend, rank)
        self.timeout_s = (mesh_timeout_s() if timeout_s is None
                          else float(timeout_s))
        dims = tuple(self.shape[a] for a in AXES)
        coords = np.unravel_index(rank, dims)
        self.coords = {a: int(c) for a, c in zip(AXES, coords)}
        self.stats = {"staged_bytes": 0, "collectives": 0,
                      "collective_s": 0.0, "commands": 0}
        self.objects: dict = {}
        self._handles: dict = {}
        self._next_handle = 0
        self._procs = list(procs or [])
        self._store = store
        self._broken: Optional[BaseException] = None
        self._closed = False
        self._lock = threading.RLock()
        from torch.distributed import PrefixStore
        timeout = datetime.timedelta(seconds=self.timeout_s)
        self._ctl = _make_pg("gloo", PrefixStore("ctl", store), rank,
                             self.world, _CONTROL_TIMEOUT, self.device)
        self.groups = {}
        ranks = np.arange(self.world).reshape(dims)
        for i, axis in enumerate(AXES):
            if dims[i] <= 1:
                continue
            # the ranks that share every other coordinate with this one
            idx = tuple(slice(None) if j == i else coords[j]
                        for j in range(len(AXES)))
            members = [int(r) for r in ranks[idx].reshape(-1)]
            key = f"{axis}:{','.join(map(str, members))}"
            pg = _make_pg(backend, PrefixStore(key, store),
                          members.index(rank), len(members), timeout,
                          self.device)
            self.groups[axis] = AxisGroup(self, axis, pg, len(members),
                                          members.index(rank))

    # -- topology ------------------------------------------------------

    def group(self, axis: str) -> Optional[AxisGroup]:
        """The axis' group, or None for an axis of size 1."""
        return self.groups.get(axis)

    def describe(self) -> str:
        axes = " ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1)
        return (f"mesh {axes or 'single'} backend={self.backend} "
                f"device={self.device}")

    # -- the command channel -------------------------------------------

    def new_handle(self) -> int:
        """A fresh object-table key (rank 0 allocates them)."""
        self._next_handle += 1
        return self._next_handle

    def register(self, obj, handle: int) -> None:
        """Rank 0: ``obj`` (its own plane of a distributed object) is
        addressed by ``handle`` in commands."""
        self._handles[id(obj)] = handle

    def unregister(self, obj) -> None:
        self._handles.pop(id(obj), None)

    def handle_of(self, obj) -> Optional[int]:
        """The handle rank 0 registered ``obj`` under, or None."""
        return self._handles.get(id(obj))

    @property
    def closed(self) -> bool:
        return self._closed

    def send(self, t: torch.Tensor, dst: int) -> None:
        """A tensor's bytes to rank ``dst`` over the control group, through
        host memory (weights at load time, not the forward)."""
        h = _as_bytes(t.detach().cpu())
        self.stats["staged_bytes"] += h.numel()
        self._ctl.send([h], dst, 0).wait()

    def recv(self, shape, dtype, src: int, device=None) -> torch.Tensor:
        """The tensor :meth:`send` sent from ``src``, on ``device``
        (default this rank's)."""
        h = torch.empty(shape, dtype=dtype)
        self._ctl.recv([_as_bytes(h)], src, 0).wait()
        return h.to(device if device is not None else self.device)

    def _bcast_bytes(self, payload: Optional[bytes]) -> bytes:
        from torch.distributed import BroadcastOptions
        opts = BroadcastOptions()
        opts.rootRank = 0
        n = torch.tensor([len(payload) if payload is not None else 0],
                         dtype=torch.int64)
        self._ctl.broadcast([n], opts).wait()
        if payload is not None:
            buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        else:
            buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self._ctl.broadcast([buf], opts).wait()
        return payload if payload is not None else buf.numpy().tobytes()

    def _check(self) -> None:
        if self._closed:
            raise RuntimeError("the mesh is closed")
        if self._broken is not None:
            raise RuntimeError(
                f"the mesh is broken after {self._broken!r}; close it")
        for r, p in enumerate(self._procs, start=1):
            if not p.is_alive():
                self._broken = RuntimeError(
                    f"follower rank {r} exited with code {p.exitcode}")
                raise self._broken

    def spmd(self, fn: Callable, *args) -> Any:
        """Run ``fn(mesh, *args)`` on every rank (rank 0 only calls this)
        and return rank 0's result.  ``fn`` is a module-level function of
        the port, sent by reference; tensors in ``args`` travel through
        host memory to each rank's device.  A failure on rank 0 breaks
        the mesh (its followers may be inside a collective)."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 issues commands")
        with self._lock:
            self._check()
            if self.world > 1:
                self._bcast_bytes(pickle.dumps((fn, _pack(args))))
            self.stats["commands"] += 1
            try:
                return fn(self, *args)
            except BaseException as e:
                if self.world > 1:
                    self._broken = e
                raise

    def serve(self) -> None:
        """A follower's loop: run rank 0's commands until it closes."""
        while True:
            fn, args = pickle.loads(self._bcast_bytes(None))
            if fn is None:
                return
            fn(self, *_unpack(args, self.device))

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` (pickled, tensors through the host) at
        rank 0, in rank order; None on the other ranks.  For checks, not
        for the forward."""
        data = pickle.dumps(_pack(obj))
        n = torch.tensor([len(data)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
        self._ctl.allgather([sizes], [n]).wait()
        m = int(max(int(s[0]) for s in sizes))
        buf = torch.zeros(m, dtype=torch.uint8)
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        outs = [torch.empty(m, dtype=torch.uint8) for _ in range(self.world)]
        self._ctl.allgather([outs], [buf]).wait()
        if self.rank != 0:
            return None
        return [_unpack(pickle.loads(o[:int(s[0])].numpy().tobytes()), "cpu")
                for o, s in zip(outs, sizes)]

    # -- lifetime ------------------------------------------------------

    def close(self) -> None:
        """Rank 0: stop the followers (a close command, a join with a
        timeout, then kill) and drop the groups.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.rank == 0 and self.world > 1 and self._broken is None:
            try:
                with self._lock:
                    self._bcast_bytes(pickle.dumps((None, ())))
            except RuntimeError:
                pass
        for p in self._procs:
            p.join(timeout=_JOIN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join(timeout=_JOIN_TIMEOUT_S)
        self._procs = []
        self.objects.clear()
        self.groups = {}
        self._ctl = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _collective_probe(mesh, axis: str, dtype_name: str):
    """Command: every collective of ``axis``' group on small tensors whose
    right answers follow from the ranks (see :func:`collective_probe`);
    each rank's results, gathered at rank 0."""
    g = mesh.group(axis)
    r, n, dev = g.rank, g.size, mesh.device
    dt = getattr(torch, dtype_name)
    x = torch.full((2, 3), float(r + 1), device=dev).to(dt)
    return mesh.gather({
        "sum": g.all_reduce(x.clone()),
        "max": g.all_reduce(x.clone(), op="max"),
        "gather": g.all_gather((torch.arange(2, device=dev) + 10 * r)
                               .to(dt), dim=0),
        "all_to_all": g.all_to_all((torch.arange(2 * n, device=dev)
                                    + 16 * r).reshape(n, 2).to(dt)),
        "rotate": g.rotate(torch.tensor([r], device=dev).to(dt)),
        "broadcast": g.broadcast(torch.tensor([7.0 * r + 1], device=dev)
                                 .to(dt), src=0)})


def collective_probe(mesh, axis: str, dtype=torch.float32) -> list:
    """Each rank's answers to one call of every collective over ``axis``
    (in rank order): the sum and max of ``rank + 1``, the all-gather of
    ``10 r + [0, 1]``, the all-to-all of ``16 r + arange(2n)``, the
    ring hop of ``r`` and the broadcast of rank 0's ``1``.  A check of
    the backend (gloo through host memory, NCCL) on the mesh's device."""
    return mesh.spmd(_collective_probe, axis, str(dtype).split(".")[-1])


def _loaded_modules(mesh):
    """Command: the names in every rank's ``sys.modules``."""
    return mesh.gather(sorted(n for n, m in sys.modules.items()
                              if m is not None))


def loaded_modules(mesh) -> list:
    """Every rank's imported module names, in rank order: what a
    follower's entry point and the commands it ran pulled in."""
    return mesh.spmd(_loaded_modules)


def _follower_main(port: int, rank: int, cfg: MeshConfig, device: str,
                   backend: str, timeout_s: float) -> None:
    """A spawned follower: join the mesh, then serve rank 0's commands.
    A failure prints its traceback and exits non-zero, which closes this
    rank's connections, so rank 0's next collective fails."""
    torch.set_num_threads(1)
    from torch.distributed import TCPStore
    # the command functions live in these modules; importing them here
    # keeps a follower's first command from paying the import
    from . import expert, pipeline, sequence, tensor, ulysses  # noqa: F401
    try:
        store = TCPStore("127.0.0.1", port, cfg.num_devices, False,
                         timeout=datetime.timedelta(seconds=timeout_s))
        store.set(f"ready/{rank}", "1")
        mesh = Mesh(cfg, rank, store, device, backend, timeout_s)
        mesh.serve()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)


def _await_followers(store, procs, timeout_s: float) -> None:
    """Wait until every follower has started (its ``ready`` key), failing
    at once on one that died and after ``timeout_s`` on one that hangs:
    a group's construction would otherwise wait for it unboundedly."""
    deadline = time.monotonic() + timeout_s
    pending = {r: p for r, p in enumerate(procs, start=1)}
    while pending:
        for r, p in list(pending.items()):
            if store.check([f"ready/{r}"]):
                del pending[r]
            elif not p.is_alive():
                raise RuntimeError(f"follower rank {r} exited with code "
                                   f"{p.exitcode} before joining the mesh")
        if pending and time.monotonic() > deadline:
            raise TimeoutError(f"follower ranks {sorted(pending)} did not "
                               f"start within {timeout_s} s")
        time.sleep(0.01)


def local_mesh(cfg: MeshConfig, device=None, timeout_s: Optional[float] = None
               ) -> Mesh:
    """A mesh over ``cfg.num_devices`` local ranks: this process is rank
    0, the others are spawned followers (``spawn``, daemon).  ``device``:
    CUDA unless the CPU is asked for."""
    from ..device import resolve_device
    from torch.distributed import TCPStore
    device = resolve_device(device)
    world = cfg.num_devices
    backend = choose_backend(device, world)
    timeout_s = mesh_timeout_s() if timeout_s is None else float(timeout_s)
    store = TCPStore("127.0.0.1", 0, world, True,
                     timeout=datetime.timedelta(seconds=timeout_s),
                     wait_for_workers=False)
    procs = []
    if world > 1:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        for r in range(1, world):
            p = ctx.Process(target=_follower_main,
                            args=(store.port, r, cfg, str(device), backend,
                                  timeout_s),
                            daemon=True, name=f"mesh-follower-{r}")
            p.start()
            procs.append(p)
    try:
        _await_followers(store, procs, timeout_s)
        return Mesh(cfg, 0, store, device, backend, timeout_s, procs)
    except BaseException:
        for p in procs:
            p.kill()
            p.join(timeout=_JOIN_TIMEOUT_S)
        raise


def multihost_mesh(cfg: MeshConfig, multihost: dict, device=None
                   ) -> Optional[Mesh]:
    """A mesh over the processes of :func:`init_multihost` (one rank a
    process).  Process 0 gets its :class:`Mesh`; every other process
    serves rank 0's commands until it closes the mesh, then gets None."""
    from ..device import resolve_device
    n = multihost["num_processes"]
    if cfg.num_devices != n:
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} processes, "
                         f"the multi-host group has {n}")
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    mesh = Mesh(cfg, multihost["process_id"], multihost["store"], device,
                backend)
    if mesh.rank == 0:
        return mesh
    try:
        mesh.serve()
    finally:
        mesh.close()
    return None


def local_tp_mesh(tp: int, device=None, timeout_s: Optional[float] = None):
    """tp mesh over ``tp`` local ranks, or None for tp <= 1: the one
    mesh-selection rule of the CLI's engine constructors."""
    if tp <= 1:
        return None
    return local_mesh(MeshConfig(tp=tp), device, timeout_s)


def local_sp_mesh(sp: int, device=None, timeout_s: Optional[float] = None):
    """sp (sequence-parallel) mesh over ``sp`` local ranks, or None for
    sp <= 1 (``generate`` / ``serve --sp``)."""
    if sp <= 1:
        return None
    return local_mesh(MeshConfig(sp=sp), device, timeout_s)


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   local_device_count: Optional[int] = None) -> dict:
    """Join this process to a multi-host group: ``coordinator``
    ("host:port") runs the ``TCPStore`` that process 0 hosts.  Keeps the
    reference's topology checks and messages; returns what the caller
    needs to build its meshes (the store, the process id and count, the
    local device count).  Call once at startup."""
    if num_processes < 1 or not (0 <= process_id < num_processes):
        raise ValueError(
            f"bad process topology: id {process_id} of {num_processes}")
    if local_device_count is not None and local_device_count < 1:
        raise ValueError(
            f"local_device_count must be >= 1, got {local_device_count}")
    from torch.distributed import TCPStore
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be host:port, got "
                         f"{coordinator!r}")
    store = TCPStore(host, int(port), num_processes, process_id == 0,
                     timeout=datetime.timedelta(seconds=mesh_timeout_s()))
    return {"store": store, "process_id": process_id,
            "num_processes": num_processes,
            "local_device_count": local_device_count}
