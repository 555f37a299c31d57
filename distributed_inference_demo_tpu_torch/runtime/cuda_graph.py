"""One decode step captured as a CUDA graph and replayed.

No module of the JAX package corresponds to this one: it stands for
``jax.jit`` of the reference's decode programs (``runtime/engine.py``'s
``decode_loop`` / ``decode_one``, ``runtime/batching.py``'s
``paged_step`` / ``paged_multi_step``).  A jitted program costs the host
one dispatch; PyTorch runs eagerly, so a decode step costs the host one
launch per kernel (~1900 for a TinyLlama step).  On CUDA the counterpart
of the compiled program is a captured graph: the step's kernels are
recorded once, and each replay is one host call.

A step is a Python callable that reads and writes STATIC buffers in
place: tensors that outlive the graph, at fixed addresses, which the
caller fills before a replay and reads after it.  :class:`StepGraph`

- warms the step up with one eager call on a side stream before the
  capture: it builds the ``nvcc`` kernels, fills the ALiBi slopes cache
  (``ops/attention.alibi_slopes``), makes cuBLAS's workspaces and the
  paged hook's plan, none of which a capture may do.  The warm-up
  writes the static buffers like any step, so the caller captures
  before it fills them;
- captures into one memory pool shared by the graphs of one engine
  (:class:`StepGraphs`, ``torch.cuda.graph_pool_handle``).  A pool
  lives while a graph captured into it does, so it belongs to the
  engine, not to the process: once every graph of a pool is gone, a
  new capture into it fails.  Replays go to the current stream, in
  order, so graphs never run at the same time; each step leaves its
  results in the caller's static buffers, never in a tensor of the
  pool;
- registers the caller's ``torch.Generator`` with the graph, so that a
  replay advances it exactly as the eager draw does, and restores the
  generator's state after the warm-up and the capture;
- carries the kernel wrappers' launch counts: they count in Python, which
  runs at capture only, so the capture's count is taken back and added
  again at every replay;
- counts replays (``replays``);
- runs the step eagerly when the device is the CPU, or when the caller
  asks for eager steps (``enabled`` False).

A capture that fails raises :class:`GraphCaptureError` with the cause.
There is no fallback to eager steps.
"""

import gc
import threading
from typing import Callable, Optional

import torch

from ..ops import flash_attention as _fa
from ..ops import paged_attention as _pa
from ..ops import quant_dense as _qd

# every kernel wrapper's counts, with the lock its wrapper counts under
_COUNTERS = (
    (_pa.paged_flash_attention, ("launches", "int8_launches",
                                 "fp8_launches"), _pa._count_lock),
    (_pa.paged_prefill_attention, ("launches", "int8_launches",
                                   "fp8_launches"), _pa._count_lock),
    (_fa.flash_attention, ("launches", "wide_launches"), _fa._count_lock),
    (_qd.quant_dense, ("launches", "decode_launches"), _qd._count_lock),
)
# one capture at a time in the process (CUDA's rule for stream capture);
# engines may capture from different threads
_capture_lock = threading.Lock()


class GraphCaptureError(RuntimeError):
    """Capturing a decode step as a CUDA graph failed."""


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _counts() -> list:
    return [getattr(fn, a) for fn, attrs, _ in _COUNTERS for a in attrs]


def _add_counts(delta: list) -> None:
    it = iter(delta)
    for fn, attrs, lock in _COUNTERS:
        with lock:
            for a in attrs:
                setattr(fn, a, getattr(fn, a) + next(it))


def _warm_up(step: Callable[[], None], device: torch.device) -> None:
    """One eager call of ``step`` on a side stream, before the capture."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)


def _capture(step: Callable[[], None], generator: Optional[torch.Generator],
             pool) -> "torch.cuda.CUDAGraph":
    """Capture ``step`` into ``pool``.  The capture runs in
    ``thread_local`` mode: a server's other threads may touch CUDA
    meanwhile, and only this thread's calls bear on the capture."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        step()
    return graph


class StepGraph:
    """``step`` (a callable over static buffers) as a replayable graph on
    the card, or run eagerly on the CPU or with ``enabled`` False.
    Calling the object runs one step."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 enabled: bool = True, pool=None):
        self.step = step
        self.replays = 0
        self.graph = None
        self._delta = None
        if not (enabled and _on_card(device)):
            return
        saved = generator.get_state() if generator is not None else None
        with _capture_lock:
            _warm_up(step, device)
            before = _counts()
            # a graph freed during the capture (an engine dropped in a
            # reference cycle, collected by the GC) would destroy its
            # executable there, which CUDA refuses and which spoils the
            # capture: collect first, and hold the collector off
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph = _capture(step, generator, pool)
            except Exception as e:
                raise GraphCaptureError(
                    f"capturing the decode step as a CUDA graph failed: "
                    f"{e!r} (cuda_graph=False runs it eagerly)") from e
            finally:
                if collecting:
                    gc.enable()
            # the capture recorded launches and ran none: its counts come
            # back, and every replay adds them
            self._delta = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-d for d in self._delta])
        if saved is not None:
            generator.set_state(saved)
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self.step()
            return
        self.graph.replay()
        self.replays += 1
        if any(self._delta):
            _add_counts(self._delta)


class StepGraphs:
    """The decode steps of one engine and the memory pool their graphs
    share, made at the first capture.  ``enabled`` False (the engines'
    ``cuda_graph=False``) runs every step eagerly."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 enabled: bool = True):
        self.device, self.generator = device, generator
        self.enabled = bool(enabled)
        self.steps = []
        self._pool = None

    def capture(self, step: Callable[[], None]) -> StepGraph:
        if self.enabled and _on_card(self.device) and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = StepGraph(step, self.device, self.generator, self.enabled,
                          self._pool)
        self.steps.append(graph)
        return graph

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.steps)
