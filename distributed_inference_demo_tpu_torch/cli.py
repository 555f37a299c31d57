"""Command line: ``python -m distributed_inference_demo_tpu_torch CMD``.

    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b --http-port 5000
    python -m distributed_inference_demo_tpu_torch serve \\
        --model llama-test --device cpu --greedy
    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b --batch-slots 8 --prefill-chunk 64
    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b --batch-slots 8 --prefill-chunk 64 \\
        --decode-block 4 --mixed-token-budget 288 --kv-dtype int8
    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b-int8 --checkpoint /path/to/hf-checkpoint
    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b --kv-cache-blocks 256 --prefill-chunk 64
    python -m distributed_inference_demo_tpu_torch serve \\
        --model llama-test --device cpu --tokenizer tokenizer.model
    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b --draft-model mixtral-tpu-1b-dense
    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b --batch-slots 8 --prompt-lookup
    python -m distributed_inference_demo_tpu_torch generate \\
        --model llama-test --device cpu --prompt-ids 5,17,99 --greedy
    python -m distributed_inference_demo_tpu_torch classify \\
        --model llama-test --device cpu --dataset rows.csv \\
        --label-token-ids 4,9
    python -m distributed_inference_demo_tpu_torch chat \\
        --url http://127.0.0.1:5000
    python -m distributed_inference_demo_tpu_torch serve \\
        --model tinyllama-1.1b --batch-slots 8 \\
        --kv-host-tier-bytes 1073741824
    python -m distributed_inference_demo_tpu_torch gateway \\
        --replicas 127.0.0.1:5000,127.0.0.1:5001 --http-port 5080
    python -m distributed_inference_demo_tpu_torch worker --elastic \\
        --model llama-test --device cpu --device-id w1 --port 6001 \\
        --header header@127.0.0.1:6000
    python -m distributed_inference_demo_tpu_torch serve \\
        --model llama-test --device cpu --port 6000 \\
        --chain w1@127.0.0.1:6001 --pool-size 4
    python -m distributed_inference_demo_tpu_torch server \\
        --model llama-test --device cpu --num-workers 2 --greedy
    python -m distributed_inference_demo_tpu_torch worker --auto \\
        --registry 127.0.0.1:PORT --device-id w1 --device cpu
    python -m distributed_inference_demo_tpu_torch plan \\
        --model tinyllama-1.1b --devices devices.json --ctx 2048
    python -m distributed_inference_demo_tpu_torch bench \\
        --model tinyllama-1.1b --batch 8 --prompt-len 64

The single-node serve modes of the JAX package's CLI, with the weights
of an HF safetensors directory (``--checkpoint``) or random weights from
``--weights-seed``, quantized for an ``-int8`` / ``-int4`` model, behind
``InferenceHTTPServer``: plain (one
``InferenceEngine``, with its block KV prefix pool under
``--kv-cache-blocks``), ``--draft-model M`` (a ``SpeculativeEngine``;
``--draft-checkpoint``, ``--num-draft``), ``--prompt-lookup`` (a
``PromptLookupEngine``) and ``--batch-slots N`` (a
``ContinuousBatchingEngine`` over the paged KV pool, with
``--decode-block``, ``--admission-queue-depth``,
``--mixed-token-budget``, and either proposer, ``--no-spec-adaptive``
pinning the mixed dispatch's draft length).  Each takes
``--kv-cache-blocks``, ``--kv-block-tokens``, ``--prefill-chunk``,
``--kv-dtype`` and ``--kv-cache-dtype``, and the tier below the
page pool, ``--kv-host-tier-bytes`` with an optional
``--kv-disk-tier-path`` / ``--kv-disk-tier-bytes`` segment (the flags
also set their ``DWT_KV_*_TIER_*`` env knobs, which every engine's pool
reads).  ``--tokenizer`` (an HF ``tokenizer.json`` or a
sentencepiece ``.model``) lets requests carry text and stop strings;
``--run-log`` appends JSONL run-log events; ``--postmortem-dir`` writes
postmortem bundles (and installs the crash handler, as does
``DWT_POSTMORTEM_DIR``).

``generate`` runs one prompt (``--prompt-ids`` or ``--prompt`` with
``--tokenizer``) through an ``InferenceEngine`` (or either speculative
engine, whose acceptance stats it adds) and prints its tokens as JSON; ``classify`` runs a ``text,label`` CSV through
``InferenceEngine.classify`` and prints the accuracy and predictions;
``chat`` is the streaming REPL client of a running server;
``gateway`` is the prefix-aware router over running ``serve`` replicas
(``runtime/gateway``), with ``--drain`` / ``--undrain`` as its client
mode.  The engine
commands run on CUDA unless ``--device cpu`` is given.

The ring pipeline: ``worker`` runs one stage process
(``runtime/worker_main.py``; ``--role prefill|decode`` the disaggregated
roles; ``--elastic`` a reshard-capable stage holding the full weights),
and ``serve --chain id@addr,...`` serves as the pipeline's header over
those workers (an ``ElasticHeader``, whose first reshard pushes the
layer plan), with ``--pool-size`` (dynamic batching over the chain),
``--step-timeout``, ``--device-id``, ``--bind-host`` / ``--port`` (the
header's data-plane address) and ``--chaos`` / ``--fault-plan``.  Both
talk over ``ZmqTransport``: without pyzmq they fail with its import
error.

The root server (``server_app.py``): ``server`` collects ``--num-workers``
registrations, runs a monitor round, plans the layer split over the
measured profiles (the header pinned as stage 0), ships each worker its
stage weights over the lifecycle channel and serves HTTP as the
pipeline's header (``--pool-size`` > 1: dynamic batching); ``worker
--auto --registry host:port --device-id ID`` is the bare worker that
needs nothing else.  Both use ZMQ sockets for the control and data
planes, and fail with its import error without pyzmq.  ``plan`` prints
the planner's JSON for a ``--devices`` file of ``DeviceProfile``s (or
reloads a ``--load`` cache); ``bench`` times ``InferenceEngine`` decode
(and, with ``--draft-model`` / ``--prompt-lookup``, the speculative
engine on the same workload) and prints one JSON line.

Multiple devices (``parallel/``): ``--tp N`` runs ``serve`` (plain and
``--batch-slots``), ``generate`` and ``classify`` tensor-parallel over N
local ranks (rank 0 here, N - 1 spawned followers; gloo on the CPU and
on one shared card, NCCL where each rank has its own card; the step
runs eagerly, ``graph=off``); ``--sp N --sp-strategy ring|ulysses``
runs ``generate`` and ``serve`` sequence-parallel
(``runtime/sp_backend.py``, ``--sp-queue-depth``).  The leading
``--jax-coordinator`` / ``--jax-num-processes`` / ``--jax-process-id``
(the reference's names) join a multi-host group: process 0 drives, the
others serve as followers.

``serve --vision`` serves a LLaVA-style tower (``--vision-preset``,
``--vision-checkpoint``) in front of the decoder
(``runtime/multimodal.py``): ``/generate`` takes an ``image`` field.
Every other mode flag of the JAX package's
CLI exits 1 with "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

class _FollowerDone(Exception):
    """A multi-host follower served its mesh until rank 0 closed it."""


def _mesh_from_args(args, device, axis: str = "tp"):
    """The ``--tp`` / ``--sp`` mesh (``parallel.mesh`` owns the rule), or
    None for 1.  Prints the mesh line once: backend and the step's graph
    mode."""
    n = getattr(args, axis, 1)
    if n <= 1:
        return None
    from .parallel.mesh import MeshConfig, local_mesh, multihost_mesh
    mcfg = MeshConfig(**{axis: n})
    mh = getattr(args, "multihost", None)
    mesh = (multihost_mesh(mcfg, mh, device) if mh is not None
            else local_mesh(mcfg, device))
    if mesh is None:
        raise _FollowerDone()
    print(f"MESH {mesh.describe()} graph=off ({mesh.backend})", flush=True)
    return mesh


def _load_tokenizer(path: Optional[str]):
    if not path:
        return None
    from .tokenizer import Tokenizer
    # auto-detects sentencepiece .model protobufs vs HF tokenizer.json
    return Tokenizer.from_file(path)


def _sampling_from_args(args):
    from .ops.sampling import SamplingParams
    if args.greedy:
        return SamplingParams(greedy=True)
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          min_p=args.min_p)


def _params(args):
    """(device, cfg, params): ``--checkpoint`` if given, else random
    weights from ``--weights-seed`` (quantized during init for an
    ``-int8`` / ``-int4`` model), through ``load_or_init`` as the
    reference's CLI resolves them, on the plain and the batching path
    alike."""
    from .device import resolve_device
    from .models.loader import load_or_init
    from .models.registry import get_model_config

    device = resolve_device(args.device)
    cfg = get_model_config(args.model)
    return device, cfg, load_or_init(args.model, cfg, args.checkpoint,
                                     seed=args.weights_seed, device=device)


def _draft_params(args, device):
    """(draft_cfg, draft_params) from ``--draft-model`` /
    ``--draft-checkpoint``, as the target's are resolved (random weights
    from the same ``--weights-seed`` without a checkpoint)."""
    from .models.loader import load_or_init
    from .models.registry import get_model_config

    dcfg = get_model_config(args.draft_model)
    return dcfg, load_or_init(args.draft_model, dcfg,
                              args.draft_checkpoint or None,
                              seed=args.weights_seed, device=device)


def _draft_for_mesh(args, device, mesh):
    """:func:`_draft_params`, sharded onto ``mesh`` when serving
    tensor-parallel (the reference's ``_load_draft_for_mesh``)."""
    dcfg, params = _draft_params(args, device)
    if mesh is not None:
        from .runtime.engine import shard_engine_params
        params = shard_engine_params(params, dcfg, mesh)
    return dcfg, params


def _kv_tier_from_args(args) -> dict:
    """The tier kwargs of the one engine that takes them explicitly
    (``ContinuousBatchingEngine``); every other pool reads the env knobs
    :func:`_export_kv_tier_env` sets."""
    return {"kv_host_tier_bytes": args.kv_host_tier_bytes,
            "kv_disk_tier_path": args.kv_disk_tier_path or None,
            "kv_disk_tier_bytes": args.kv_disk_tier_bytes}


def _export_kv_tier_env(args) -> None:
    """The tier flags over their env knobs, through the env: every
    ``make_kv_backend`` call resolves the tier from there."""
    import os
    if args.kv_host_tier_bytes is not None:
        os.environ["DWT_KV_HOST_TIER_BYTES"] = str(args.kv_host_tier_bytes)
    if args.kv_disk_tier_path:
        os.environ["DWT_KV_DISK_TIER_PATH"] = args.kv_disk_tier_path
    if args.kv_disk_tier_bytes is not None:
        os.environ["DWT_KV_DISK_TIER_BYTES"] = str(args.kv_disk_tier_bytes)


def _refuse_stream_block(args, flag: str) -> None:
    if args.stream_block is not None:
        raise ValueError(
            f"--stream-block is not supported with {flag} (the "
            "draft/verify round is already the fused dispatch unit)")


def _spec_engine_kwargs(args, device) -> dict:
    """The engine flags both speculative engines take."""
    return dict(max_seq=args.max_seq, sampling=_sampling_from_args(args),
                num_draft=args.num_draft, attn_backend=args.attn_backend,
                eos_id=args.eos_id, kv_cache_dtype=args.kv_cache_dtype,
                prefill_chunk=args.prefill_chunk or None,
                kv_cache_blocks=args.kv_cache_blocks,
                kv_block_tokens=args.kv_block_tokens,
                kv_dtype=args.kv_dtype, kv_layout=args.kv_layout,
                device=device)


def build_spec_engine(args):
    """The ``SpeculativeEngine`` of ``generate`` / ``serve
    --draft-model``, both models over the ``--tp`` mesh when one is
    asked for (``engine.mesh``)."""
    from .runtime.speculative import SpeculativeEngine

    _refuse_stream_block(args, "--draft-model")
    device, cfg, params, mesh = _params_for_mesh(args)
    try:
        dcfg, dparams = _draft_for_mesh(args, device, mesh)
        return SpeculativeEngine(cfg, params, dcfg, dparams, mesh=mesh,
                                 cuda_graph=mesh is None,
                                 **_spec_engine_kwargs(args, device))
    except BaseException:
        if mesh is not None:
            mesh.close()
        raise


def build_prompt_lookup_engine(args):
    """The ``PromptLookupEngine`` of ``generate`` / ``serve
    --prompt-lookup``, over the ``--tp`` mesh when one is asked for."""
    from .runtime.prompt_lookup import PromptLookupEngine

    _refuse_stream_block(args, "--prompt-lookup")
    device, cfg, params, mesh = _params_for_mesh(args)
    try:
        return PromptLookupEngine(cfg, params, mesh=mesh,
                                  cuda_graph=mesh is None,
                                  **_spec_engine_kwargs(args, device))
    except BaseException:
        if mesh is not None:
            mesh.close()
        raise


def _params_for_mesh(args):
    """(device, cfg, params, mesh): :func:`_params`, sharded onto the
    ``--tp`` mesh when one is asked for (the full tree is dropped, so
    each rank keeps its slice only)."""
    device, cfg, params = _params(args)
    mesh = _mesh_from_args(args, device)
    if mesh is not None:
        from .runtime.engine import shard_engine_params
        try:
            params = shard_engine_params(params, cfg, mesh)
        except BaseException:
            mesh.close()
            raise
    return device, cfg, params, mesh


def _paged_backend(args) -> str:
    """The paged hook's backend for ``--attn-backend`` ("flash" is the
    CUDA kernels)."""
    return "cuda" if args.attn_backend == "flash" else args.attn_backend


def build_batching_engine(args):
    """(cfg, ContinuousBatchingEngine) for ``serve --batch-slots N``, with
    the draft model or prompt lookup when asked for, over the ``--tp``
    mesh when one is asked for (``engine.mesh``)."""
    from .runtime.batching import ContinuousBatchingEngine

    device, cfg, params, mesh = _params_for_mesh(args)
    dcfg = dparams = None
    if args.draft_model:
        dcfg, dparams = _draft_for_mesh(args, device, mesh)
    return cfg, ContinuousBatchingEngine(
        cfg, params, max_seq=args.max_seq, max_batch=args.batch_slots,
        sampling=_sampling_from_args(args), seed=args.seed,
        eos_id=args.eos_id, decode_block=args.decode_block,
        draft_cfg=dcfg, draft_params=dparams, num_draft=args.num_draft,
        prompt_lookup=args.prompt_lookup,
        spec_adaptive=not args.no_spec_adaptive,
        prefill_chunk=args.prefill_chunk or None,
        max_queue_depth=args.admission_queue_depth,
        mixed_token_budget=args.mixed_token_budget or None,
        kv_dtype=args.kv_dtype, kv_cache_dtype=args.kv_cache_dtype,
        kv_cache_blocks=args.kv_cache_blocks,
        kv_block_tokens=args.kv_block_tokens, **_kv_tier_from_args(args),
        attn_backend=_paged_backend(args), kv_layout=args.kv_layout,
        device=device, mesh=mesh, cuda_graph=mesh is None)


def build_engine(args):
    """(cfg, InferenceEngine) for the parsed plain serve flags, over the
    ``--tp`` mesh when one is asked for (``engine.mesh``)."""
    from .runtime.engine import InferenceEngine

    device, cfg, params, mesh = _params_for_mesh(args)
    return cfg, InferenceEngine(
        cfg, params, max_seq=args.max_seq,
        sampling=_sampling_from_args(args),
        attn_backend=args.attn_backend, eos_id=args.eos_id,
        prefill_chunk=args.prefill_chunk or None,
        kv_cache_blocks=args.kv_cache_blocks,
        kv_block_tokens=args.kv_block_tokens, kv_dtype=args.kv_dtype,
        kv_cache_dtype=args.kv_cache_dtype, kv_layout=args.kv_layout,
        stream_block=args.stream_block, device=device, mesh=mesh,
        cuda_graph=mesh is None)


def vision_config(preset: str):
    """The ``--vision-preset`` tower geometry (the reference's three)."""
    from .models.vision import VisionConfig
    if preset == "llava15":
        # the CLIP-ViT-L/14-336 geometry LLaVA-1.5 ships: class token,
        # pre-layernorm, projection biases, quick_gelu, penultimate-layer
        # feature select; HF CLIP / LLaVA checkpoints load as they are
        return VisionConfig(image_size=336, patch_size=14, hidden_size=1024,
                            num_layers=24, num_heads=16,
                            intermediate_size=4096, dtype_name="bfloat16",
                            clip_arch=True, feature_layer=-2,
                            hidden_act="quick_gelu")
    if preset == "clip-test":
        # the same architecture flags at toy scale, for tests and drives
        return VisionConfig(image_size=28, patch_size=14, hidden_size=32,
                            num_layers=3, num_heads=4, intermediate_size=64,
                            dtype_name="float32", clip_arch=True,
                            feature_layer=-2, hidden_act="quick_gelu")
    # "small": a CLIP-base-like tower for modest decoders
    return VisionConfig(image_size=224, patch_size=14, hidden_size=256,
                        num_layers=6, num_heads=8, intermediate_size=1024,
                        dtype_name="bfloat16")


def build_vision_backend(args):
    """``MultimodalBackend`` for ``serve --vision``: the decoder's params
    as every engine command resolves them, the tower from
    ``--vision-checkpoint`` or, without one, drawn from
    ``--weights-seed`` (so one seed reproduces the whole model whatever
    the sampling ``--seed``)."""
    import torch

    from .models.loader import load_vision_params
    from .models.vision import init_vision_params
    from .runtime.multimodal import MultimodalBackend, MultimodalEngine

    device, cfg, params = _params(args)
    vcfg = vision_config(args.vision_preset)
    if args.vision_checkpoint:
        vparams = load_vision_params(args.vision_checkpoint, vcfg,
                                     cfg.hidden_size,
                                     seed=args.weights_seed, device=device)
    else:
        vparams = init_vision_params(
            torch.Generator(device=device).manual_seed(args.weights_seed),
            vcfg, cfg.hidden_size, device)
    return MultimodalBackend(MultimodalEngine(
        cfg, params, vcfg, vparams, max_seq=args.max_seq,
        sampling=_sampling_from_args(args), eos_id=args.eos_id,
        attn_backend=args.attn_backend, kv_layout=args.kv_layout,
        kv_dtype=args.kv_dtype, device=device))


def _close_mesh(engine) -> None:
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        mesh.close()


def _sp_unsupported_flags(args, allow_eos: bool = False) -> list:
    """Engine flags the sp paths have no plumbing for, one rule for
    ``generate --sp`` and ``serve --sp`` (the reference's); ``serve``
    allows ``--eos-id`` (its backend stops through the stream
    programs)."""
    return [flag for flag, on in [
        ("--eos-id", not allow_eos and args.eos_id is not None),
        ("--prefill-chunk", bool(args.prefill_chunk)),
        ("--stream-block", args.stream_block is not None),
        ("--kv-cache-blocks", _kvcache_flags_set(args)),
        ("--attn-backend", args.attn_backend != "auto")] if on]


def _kvcache_flags_set(args) -> bool:
    return (args.kv_cache_blocks is not None
            or args.kv_block_tokens is not None)


def _dtype_name(dtype) -> str:
    """A storage cast's name for the banner ("none" for the model's)."""
    from .runtime.engine import dtype_name
    return "none" if dtype is None else dtype_name(dtype)


def build_chain_backend(args, fault_plan):
    """``serve --chain``: (backend, header, specs, transport).  The
    header's stage is an ``ElasticStageRuntime`` over the full weights
    (``_params``, the rule ``worker`` derives its own by); its first
    reshard pushes the authoritative layer plan, so the workers may
    start with any placeholder range."""
    from .comm.faults import maybe_wrap
    from .comm.transport import ZmqTransport
    from .models.base import split_layer_ranges
    from .runtime.elastic import ElasticHeader, ElasticStageRuntime
    from .runtime.http_server import HeaderBackend

    device, cfg, full = _params(args)
    peers = [p.split("@", 1) for p in args.chain.split(",")]
    chain = [args.device_id] + [pid for pid, _ in peers]
    specs = split_layer_ranges(cfg.num_layers, len(chain))
    rt = ElasticStageRuntime(
        cfg, specs[0], full, args.max_seq, _sampling_from_args(args),
        seed=args.seed, kv_cache_dtype=args.kv_cache_dtype,
        kv_layout=args.kv_layout, kv_dtype=args.kv_dtype,
        attn_backend=_paged_backend(args), device=device)
    transport = maybe_wrap(
        ZmqTransport(args.device_id, bind_host=args.bind_host,
                     port=args.port), fault_plan)
    try:
        for pid, addr in peers:
            transport.connect(pid, addr)
        header = ElasticHeader(rt, transport, chain, eos_id=args.eos_id,
                               step_timeout=args.step_timeout)
        header.reshard(chain)
        if args.pool_size > 1:
            # concurrent HTTP requests group into generate_many windows,
            # pool_size rids interleaving through the stages
            from .runtime.dynamic_batch import DynamicBatchingHeaderBackend
            backend = DynamicBatchingHeaderBackend(
                header, max_seq=args.max_seq, num_stages=len(chain),
                pool_size=args.pool_size)
        else:
            backend = HeaderBackend(header, max_seq=args.max_seq,
                                    num_stages=len(chain))
    except BaseException:
        transport.close()
        raise
    return backend, header, specs, transport


def cmd_serve(args) -> int:
    from .runtime.http_server import InferenceHTTPServer

    _export_kv_tier_env(args)
    modes = [name for name, on in [("--chain", args.chain),
                                   ("--draft-model", args.draft_model),
                                   ("--prompt-lookup", args.prompt_lookup),
                                   ("--batch-slots", args.batch_slots),
                                   ("--sp", args.sp > 1),
                                   ("--vision", args.vision)]
             if on]
    # --batch-slots composes with --draft-model OR --prompt-lookup
    if len(modes) > 1 and set(modes) not in (
            {"--batch-slots", "--draft-model"},
            {"--batch-slots", "--prompt-lookup"}):
        print(f"choose one serve mode, got {' + '.join(modes)}",
              file=sys.stderr)
        return 1
    if args.no_spec_adaptive and not (
            args.batch_slots and (args.draft_model or args.prompt_lookup)):
        # adaptive K_row lives in the mixed slot loop; anywhere else the
        # flag would silently do nothing
        print("--no-spec-adaptive requires --batch-slots with "
              "--draft-model or --prompt-lookup", file=sys.stderr)
        return 1
    if args.tp > 1 and "--chain" in modes:
        print("--tp is not supported with --chain (stages are whole-model "
              "slices per worker)", file=sys.stderr)
        return 1
    if args.pool_size > 1 and not args.chain:
        # reject loudly rather than silently serializing requests
        print("--pool-size requires --chain (pipeline dynamic batching); "
              "--batch-slots is the single-node batching mode",
              file=sys.stderr)
        return 1
    # the chaos fault plan resolves early, so a leaked DWT_FAULT_PLAN
    # fails at startup instead of silently injecting faults
    from .comm.faults import FaultConfigError, load_fault_plan
    try:
        fault_plan = load_fault_plan(args.fault_plan, args.chaos)
    except FaultConfigError as e:
        print(str(e), file=sys.stderr)
        return 1
    if fault_plan is not None and not args.chain:
        print("--fault-plan applies to the data-plane transport and "
              "requires --chain (single-process engine modes have no "
              "transport to fault)", file=sys.stderr)
        return 1
    if args.chain:
        refusal = next((text for on, text in [
            (args.prefill_chunk,
             "--prefill-chunk is not supported with --chain"),
            # the ring's topology caps a circuit at one token
            (args.stream_block is not None,
             "--stream-block is not supported with --chain"),
            (_kvcache_flags_set(args),
             "--kv-cache-blocks/--kv-block-tokens are not supported with "
             "--chain (pipeline stages see activations, not tokens — "
             "there is no prompt key to match blocks by)")] if on), None)
        if refusal:
            print(refusal, file=sys.stderr)
            return 1
    if args.sp > 1:
        if args.tp > 1:
            print("--sp is exclusive with --tp", file=sys.stderr)
            return 1
        unsupported = _sp_unsupported_flags(args, allow_eos=True)
        if unsupported:
            print(f"{'/'.join(unsupported)} not supported with --sp",
                  file=sys.stderr)
            return 1
    if args.vision:
        unsupported = [flag for flag, on in [
            ("--kv-cache-dtype", bool(args.kv_cache_dtype)),
            ("--prefill-chunk", bool(args.prefill_chunk)),
            ("--stream-block", args.stream_block is not None),
            ("--kv-cache-blocks", _kvcache_flags_set(args)),
            ("--tp", args.tp > 1)] if on]
        if unsupported:
            print(f"{'/'.join(unsupported)} not supported with --vision",
                  file=sys.stderr)
            return 1
    if args.batch_slots and args.stream_block is not None:
        # the scheduler's fused block is --decode-block; a second K knob
        # is rejected, never silently ignored
        print("--stream-block is not supported with --batch-slots "
              "(use --decode-block)", file=sys.stderr)
        return 1
    if args.run_log:
        from .telemetry.runlog import RunLog, set_run_log
        rl = RunLog(args.run_log)
        set_run_log(rl)
        rl.event("serve_start", model=args.model, max_seq=args.max_seq,
                 chain=bool(args.chain), batch_slots=args.batch_slots)
    # black-box capture for this serving process: --postmortem-dir
    # installs the writer; DWT_POSTMORTEM_DIR alone is honored too, and
    # either configuration gets the crash handler
    from .telemetry import postmortem
    if args.postmortem_dir:
        postmortem.set_postmortem_writer(
            postmortem.PostmortemWriter(args.postmortem_dir))
    if postmortem.get_postmortem_writer() is not None:
        postmortem.install_crash_handler(config=dict(vars(args)))
    tokenizer = _load_tokenizer(args.tokenizer)
    chain_transport = None
    if args.chain:
        engine, header, specs, chain_transport = build_chain_backend(
            args, fault_plan)
        kv_dtype = args.kv_cache_dtype
        if kv_dtype:
            # each stage owns its cache dtype: this flag reaches only the
            # header's stage
            print(f"note: --kv-cache-dtype={kv_dtype} applies to the "
                  "header stage only; start each worker with its own "
                  "--kv-cache-dtype to reduce its cache too",
                  file=sys.stderr)
        print(f"SERVE_PIPELINE {header.chain} ranges="
              f"{[(s.layer_start, s.layer_end) for s in specs]}"
              + (f" header_kv_cache_dtype={kv_dtype}" if kv_dtype else "")
              + f" pool_size={args.pool_size} device={header.rt.device}",
              flush=True)
    elif args.batch_slots:
        cfg, engine = build_batching_engine(args)
        kvc = engine.kv_cache
        spec = ((f" draft={args.draft_model} k={args.num_draft}"
                 if args.draft_model else "")
                + (f" prompt_lookup k={args.num_draft}"
                   if args.prompt_lookup else "")
                + (" k_adaptive" if engine.spec_adaptive else ""))
        print(f"SERVE_BATCHING {args.model} slots={args.batch_slots} "
              f"kv_cache={kvc.num_blocks}x{kvc.block_tokens}tok "
              f"{engine.kv_layout} kv_dtype={engine.kv_dtype} "
              f"mixed_token_budget={engine.mixed_token_budget} "
              f"kv_cache_dtype={_dtype_name(engine.kv_cache_dtype)} "
              f"tp={args.tp} "
              f"attn={engine.attn_backend} device={engine.device}{spec}",
              flush=True)
    elif args.vision:
        engine = build_vision_backend(args)
        vcfg = engine.mm.vcfg
        print(f"SERVE_VISION {args.model} tower={args.vision_preset} "
              f"image={vcfg.image_size} patches={vcfg.num_patches}",
              flush=True)
    elif args.sp > 1:
        engine = build_sp_backend(args)
        print(f"SERVE_SP {args.model} sp={args.sp} "
              f"strategy={args.sp_strategy} max_seq={args.max_seq}",
              flush=True)
    elif args.draft_model or args.prompt_lookup:
        from .runtime.speculative import SpeculativeBackend
        engine = SpeculativeBackend(
            build_spec_engine(args) if args.draft_model
            else build_prompt_lookup_engine(args))
        print((f"SERVE_SPECULATIVE {args.model} draft={args.draft_model} "
               if args.draft_model else
               f"SERVE_PROMPT_LOOKUP {args.model} ")
              + f"k={args.num_draft} attn={engine.engine.attn_backend} "
              f"device={engine.device}", flush=True)
    else:
        cfg, engine = build_engine(args)
        kvc = engine.kv_cache
        pool = ("off" if kvc is None else
                f"{kvc.num_blocks}x{kvc.block_tokens}tok {kvc.layout} "
                f"kv_dtype={kvc.kv_dtype}")
        print(f"SERVE_ENGINE {args.model} attn={engine.attn_backend} "
              f"kv_cache={pool} "
              f"kv_cache_dtype={_dtype_name(engine.kv_cache_dtype)} "
              f"device={engine.device} tp={args.tp}", flush=True)
    try:
        server = InferenceHTTPServer(engine, host=args.http_host,
                                     port=args.http_port,
                                     tokenizer=tokenizer,
                                     model_name=args.model,
                                     default_max_new=args.max_new_tokens,
                                     request_timeout=args.request_timeout
                                     or None)
    except BaseException:
        _close_mesh(engine)
        if chain_transport is not None:
            chain_transport.close()
        raise
    print(f"HTTP_READY http://{server.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        if args.batch_slots or args.pool_size > 1:
            # the scheduler threads drain their waiters on the way out
            engine.close()
        _close_mesh(engine)
        if chain_transport is not None:
            chain_transport.close()
        if args.run_log:
            set_run_log(None)
            rl.close()
    return 0


def _add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The flags of the engine commands (serve, generate, classify)."""
    ap.add_argument("--model", required=True)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--weights-seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="an HF safetensors checkpoint directory (else "
                         "random weights from --weights-seed)")
    ap.add_argument("--tokenizer", default="",
                    help="tokenizer.json or sentencepiece .model path for "
                         "text in/out")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed; with serve --batch-slots it seeds "
                         "the engine's one sampling stream, and a "
                         "request's own seed is not honored")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-k", type=int, default=7)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="process prompts in fixed chunks of N tokens "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--stream-block", type=int, default=None,
                    help="decode steps per streaming dispatch; default "
                         "DWT_STREAM_BLOCK or 1")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "flash", "plain"],
                    help="auto: the CUDA kernels on the card; flash: the "
                         "CUDA kernels, card only; plain: PyTorch attention "
                         "(with --batch-slots, the paged gather path)")
    ap.add_argument("--kv-cache-blocks", type=int, default=None,
                    help="page-pool size in blocks (default "
                         "DWT_KVCACHE_BLOCKS; else, with --batch-slots, "
                         "slots x table width, and without, no prefix "
                         "pool)")
    ap.add_argument("--kv-block-tokens", type=int, default=None,
                    help="tokens per KV page (default "
                         "DWT_KVCACHE_BLOCK_TOKENS, else 16)")
    ap.add_argument("--kv-host-tier-bytes", type=int, default=None,
                    help="tiered KV: byte budget of the host-RAM ring "
                         "that catches KV blocks evicted from the page "
                         "pool; a prompt whose prefix sits demoted "
                         "promotes it back instead of re-prefilling.  "
                         "Default DWT_KV_HOST_TIER_BYTES, else 0 (off)")
    ap.add_argument("--kv-disk-tier-path", default=None,
                    help="optional mmap'd disk segment below the host "
                         "ring (host overflow spills here, oldest first); "
                         "needs --kv-host-tier-bytes > 0 and "
                         "--kv-disk-tier-bytes.  Default "
                         "DWT_KV_DISK_TIER_PATH")
    ap.add_argument("--kv-disk-tier-bytes", type=int, default=None,
                    help="byte budget of the disk segment (0 = no disk "
                         "tier; default DWT_KV_DISK_TIER_BYTES)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["bf16", "int8", "int4"],
                    help="the KV page width: bf16 stores full-width pages "
                         "(the default); int8 / packed int4 quantize each "
                         "page at write time with a per-token scale beside "
                         "it.  Default DWT_KV_DTYPE, else bf16")
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=["float8_e4m3fn"],
                    help="store the KV cache and pages as float8 e4m3 "
                         "(half the bytes of bf16; the plain engine then "
                         "takes plain attention); not with --kv-dtype "
                         "int8/int4")
    ap.add_argument("--kv-layout", default=None, choices=["paged"],
                    help="the KV cache layout: paged (device page pool + "
                         "block tables) is the only one")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism over N local ranks "
                         "(Megatron-sliced weights, kv-head-sharded cache "
                         "and pages; rank 0 drives, N - 1 followers are "
                         "spawned)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def build_sp_backend(args):
    """``SequenceParallelBackend`` over the ``--sp`` mesh (``serve
    --sp``); its ``mesh`` closes with the server."""
    from .runtime.sp_backend import SequenceParallelBackend
    device, cfg, params = _params(args)
    mesh = _mesh_from_args(args, device, "sp")
    try:
        return SequenceParallelBackend(
            cfg, params, mesh, max_seq=args.max_seq,
            strategy=args.sp_strategy, sampling=_sampling_from_args(args),
            kv_cache_dtype=args.kv_cache_dtype, eos_id=args.eos_id,
            max_queue_depth=args.sp_queue_depth, kv_layout=args.kv_layout)
    except BaseException:
        mesh.close()
        raise


def _add_sp_args(ap: argparse.ArgumentParser) -> None:
    """Sequence-parallel flags, shared by generate and serve."""
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence parallelism over N local ranks for long "
                         "prompts: the prompt shards by contiguous chunk, "
                         "prefill runs ring attention (or Ulysses), the KV "
                         "cache stays sharded; prompt length must divide "
                         "by N")
    ap.add_argument("--sp-strategy", default="ring",
                    choices=["ring", "ulysses"],
                    help="ring = sequence-sharded cache + ring-attention "
                         "prefill; ulysses = all-to-all to head-sharded "
                         "attention (needs heads divisible by N)")
    ap.add_argument("--sp-queue-depth", type=int, default=None,
                    help="serve --sp: max requests allowed to wait behind "
                         "the one running before arrivals get 429 + "
                         "Retry-After; default DWT_SP_QUEUE_DEPTH or 8, 0 "
                         "= unbounded")


def _add_draft_args(ap: argparse.ArgumentParser) -> None:
    """Speculative-decoding flags, shared by generate and serve."""
    ap.add_argument("--draft-model", default="",
                    help="speculative decoding: draft model name (must "
                         "share the target's vocab)")
    ap.add_argument("--draft-checkpoint", default="",
                    help="checkpoint for the draft model weights")
    ap.add_argument("--num-draft", type=int, default=4,
                    help="draft tokens proposed per verify round")
    ap.add_argument("--prompt-lookup", action="store_true",
                    help="draft-free speculation: n-gram lookup over the "
                         "context proposes, the target verifies")
    ap.add_argument("--no-spec-adaptive", action="store_true",
                    help="pin K_row = --num-draft in the mixed dispatch "
                         "instead of adapting per-row draft length to "
                         "measured acceptance (serve --batch-slots only)")


def _serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch serve",
        description="HTTP inference server (PyTorch/CUDA port)")
    _add_engine_args(ap)
    _add_draft_args(ap)
    _add_sp_args(ap)
    ap.add_argument("--chain", default="",
                    help="pipeline mode: comma list of workerid@host:port "
                         "(start the workers first with the worker "
                         "command)")
    ap.add_argument("--device-id", default="header",
                    help="with --chain: the header's id on the data plane")
    ap.add_argument("--bind-host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="data-plane port (pipeline mode)")
    ap.add_argument("--step-timeout", type=float, default=120.0)
    ap.add_argument("--pool-size", type=int, default=1,
                    help="with --chain: dynamic batching — concurrent HTTP "
                         "requests group into windows of up to N in-flight "
                         "rids interleaving through the pipeline stages "
                         "(1 = serialized requests)")
    ap.add_argument("--request-timeout", type=float, default=0.0,
                    help="per-request deadline in seconds for blocking "
                         "/generate: on expiry the request is cancelled "
                         "and the client gets 504 (0 = no deadline)")
    ap.add_argument("--fault-plan", default="",
                    help="CHAOS TESTING ONLY: JSON fault-plan spec (path "
                         "or inline) injected into the data-plane "
                         "transport; requires --chaos and --chain (env "
                         "DWT_FAULT_PLAN)")
    ap.add_argument("--chaos", action="store_true",
                    help="explicitly acknowledge fault injection; "
                         "--fault-plan/DWT_FAULT_PLAN are rejected "
                         "without it")
    ap.add_argument("--vision", action="store_true",
                    help="LLaVA-style multimodal serving: /generate takes "
                         "an optional 'image' field ([H][W][C] floats); "
                         "text-only requests serve unchanged")
    ap.add_argument("--vision-preset", default="small",
                    choices=["small", "llava15", "clip-test"],
                    help="ViT tower geometry: small = 224px/6 layers, "
                         "llava15 = CLIP-ViT-L/14-336 (class token, "
                         "pre-layernorm, quick_gelu, penultimate feature "
                         "select), clip-test = a tiny tower of the same "
                         "architecture for tests")
    ap.add_argument("--vision-checkpoint", default="",
                    help="safetensors dir with HF CLIP/LLaVA vision tower "
                         "weights (vision_model.* names; LLaVA's "
                         "multi_modal_projector loads too when present); "
                         "empty = random init from --weights-seed")
    ap.add_argument("--batch-slots", type=int, default=0,
                    help="continuous batching with N slots: concurrent "
                         "requests join the running decode batch between "
                         "steps")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="with --batch-slots: fuse N decode steps per "
                         "dispatch when no admission could land anyway")
    ap.add_argument("--mixed-token-budget", type=int, default=0,
                    help="with --batch-slots and --prefill-chunk: pack "
                         "prefill chunk tokens from admitting prompts "
                         "into the SAME dispatch as the fused decode "
                         "block, up to N tokens total per step (decode "
                         "fusion survives admission; default "
                         "DWT_MIXED_TOKEN_BUDGET or 0 = serialized)")
    ap.add_argument("--admission-queue-depth", type=int, default=0,
                    help="with --batch-slots: answer 503 + Retry-After "
                         "once this many requests wait for a slot (0 = "
                         "unbounded)")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=5000)
    ap.add_argument("--run-log", default="",
                    help="append structured JSONL run-log events "
                         "(serve start, per-request generate/classify "
                         "summaries) to this file")
    ap.add_argument("--postmortem-dir", default="",
                    help="write postmortem bundles (flight-recorder ring "
                         "+ metrics + trace + run-log tail) here on "
                         "anomalies, scheduler stalls and crashes (default "
                         "DWT_POSTMORTEM_DIR)")
    return ap


def _generate_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch generate",
        description="one-shot local generation")
    _add_engine_args(ap)
    _add_draft_args(ap)
    _add_sp_args(ap)
    ap.add_argument("--prompt-ids", default="")
    ap.add_argument("--prompt", default=None)
    return ap


def _classify_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch classify",
        description="CSV dataset classification accuracy run")
    _add_engine_args(ap)
    ap.add_argument("--dataset", required=True,
                    help="CSV file of text,label rows")
    ap.add_argument("--label-token-ids", required=True,
                    help="comma list: one verbalizer token id per class, "
                         "in dataset label-name order")
    ap.add_argument("--batch", type=int, default=8)
    return ap


def _chat_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch chat",
        description="streaming chat REPL against a serve HTTP endpoint")
    ap.add_argument("--url", default="http://127.0.0.1:5000")
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--stop", action="append", default=None,
                    help="stop sequence (repeatable); needs a server-side "
                         "tokenizer: generation ends at the earliest "
                         "match, which is not rendered")
    ap.add_argument("--tokenizer", default="",
                    help="local tokenizer for encode/decode (else the "
                         "server's tokenizer handles text)")
    ap.add_argument("--ids", action="store_true",
                    help="input lines are comma-separated token ids")
    ap.add_argument("--template", default="User: {msg}. Response:",
                    help="prompt template")
    ap.add_argument("--seed", type=int, default=0)
    return ap


# ---------------------------------------------------------------------------
# generate / classify / chat
# ---------------------------------------------------------------------------

def cmd_generate(args) -> int:
    """One-shot local generation (ids in, ids/text out)."""
    import numpy as np

    _export_kv_tier_env(args)
    if args.no_spec_adaptive:
        print("--no-spec-adaptive requires serve --batch-slots with "
              "--draft-model or --prompt-lookup", file=sys.stderr)
        return 1
    tokenizer = _load_tokenizer(args.tokenizer)
    if args.prompt_ids:
        ids = np.asarray([[int(t) for t in args.prompt_ids.split(",")]],
                         dtype=np.int32)
    elif args.prompt is not None:
        if tokenizer is None:
            print("--prompt requires --tokenizer", file=sys.stderr)
            return 1
        ids = np.asarray([tokenizer.encode(args.prompt)], dtype=np.int32)
    else:
        print("need --prompt-ids or --prompt", file=sys.stderr)
        return 1
    if args.draft_model and args.prompt_lookup:
        print("choose one of --draft-model / --prompt-lookup",
              file=sys.stderr)
        return 1
    if args.sp > 1:
        if args.draft_model or args.prompt_lookup or args.tp > 1:
            print("--sp is exclusive with --draft-model/--prompt-lookup/"
                  "--tp", file=sys.stderr)
            return 1
        return _generate_sp(args, ids, tokenizer)
    stats = None
    if args.prompt_lookup or args.draft_model:
        spec = (build_prompt_lookup_engine(args) if args.prompt_lookup
                else build_spec_engine(args))
        try:
            res, stats = spec.generate(ids, args.max_new_tokens,
                                       seed=args.seed)
        finally:
            _close_mesh(spec)
    else:
        _, engine = build_engine(args)
        try:
            res = engine.generate(ids, args.max_new_tokens, seed=args.seed)
        finally:
            _close_mesh(engine)
    out = {"tokens": res.tokens.tolist(),
           "tokens_per_second": res.tokens_per_second}
    if stats is not None:
        from .runtime.speculative import stats_json
        out["speculative"] = stats_json(stats, args.num_draft)
    if tokenizer is not None:
        out["text"] = [tokenizer.decode(r) for r in res.tokens.tolist()]
    print(json.dumps(out))
    return 0


def _generate_sp(args, ids, tokenizer) -> int:
    """``generate --sp N``: one-shot long-context generation over a local
    sequence-parallel mesh (``--sp-strategy ring`` or ``ulysses``).  The
    prompt length must be a multiple of N."""
    import time as _time

    from .parallel.sequence import validate_sp_prompt

    unsupported = _sp_unsupported_flags(args)
    if unsupported:
        print(f"{'/'.join(unsupported)} not supported with --sp",
              file=sys.stderr)
        return 1
    # the shared rule fails fast, before the weights load
    validate_sp_prompt(ids.shape[1], args.sp, args.max_seq,
                       args.max_new_tokens)
    device, cfg, params = _params(args)
    mesh = _mesh_from_args(args, device, "sp")
    try:
        kw = dict(max_seq=args.max_seq, num_new_tokens=args.max_new_tokens,
                  sampling=_sampling_from_args(args),
                  kv_cache_dtype=args.kv_cache_dtype)
        if args.sp_strategy == "ring":
            from .parallel.sequence import make_sp_generate_fn
            gen = make_sp_generate_fn(cfg, mesh, **kw)
        else:
            from .parallel.ulysses import make_ulysses_generate_fn
            gen = make_ulysses_generate_fn(cfg, mesh, **kw)
        t0 = _time.perf_counter()
        toks = gen(params, ids, args.seed).cpu().numpy()
        dt = _time.perf_counter() - t0
    finally:
        mesh.close()
    out = {"tokens": toks.tolist(), "tokens_per_second": toks.size / dt,
           "sp": args.sp, "sp_strategy": args.sp_strategy}
    if tokenizer is not None:
        out["text"] = [tokenizer.decode(r) for r in toks.tolist()]
    print(json.dumps(out))
    return 0


def cmd_classify(args) -> int:
    """Dataset classification accuracy run: CSV ``text,label`` rows in,
    accuracy and predictions out.  With ``--tokenizer`` the text is
    encoded, otherwise it must be space-separated token ids."""
    import numpy as np

    from .tasks import evaluate_classifier, load_csv_dataset

    ds = load_csv_dataset(args.dataset)
    tokenizer = _load_tokenizer(args.tokenizer)
    prompts = []
    for text in ds.texts:
        if tokenizer is not None:
            ids = tokenizer.encode(text)
        else:
            try:
                ids = [int(t) for t in text.split()]
            except ValueError:
                print("without --tokenizer, dataset text must be "
                      "space-separated token ids", file=sys.stderr)
                return 1
        prompts.append(np.asarray([ids], dtype=np.int32))

    label_ids = [int(t) for t in args.label_token_ids.split(",")]
    if len(label_ids) != len(ds.label_names):
        print(f"--label-token-ids has {len(label_ids)} entries but the "
              f"dataset has {len(ds.label_names)} classes "
              f"({ds.label_names})", file=sys.stderr)
        return 1

    _, engine = build_engine(args)
    try:
        result = evaluate_classifier(
            lambda batch: engine.classify(batch, label_ids),
            prompts, ds.labels, batch_size=args.batch)
    finally:
        _close_mesh(engine)
    result["label_names"] = ds.label_names
    print(json.dumps(result))
    return 0


def _parse_url(url: str):
    from urllib.parse import urlparse
    u = urlparse(url if "//" in url else f"http://{url}")
    return u.hostname or "127.0.0.1", u.port or 5000


def stream_generate(host: str, port: int, payload: dict,
                    timeout: float = 600):
    """POST /generate with stream=true; yield each JSONL line as a dict
    the moment its chunk arrives."""
    import http.client

    payload = dict(payload, stream=True)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/generate", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(
                f"HTTP {resp.status}: {resp.read().decode(errors='replace')}")
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if line:
                yield json.loads(line)
    finally:
        conn.close()


def cmd_chat(args) -> int:
    """Terminal chat REPL over the streaming HTTP endpoint: one message
    per line, POSTed with ``stream: true``, rendered as each chunk
    arrives.  With ``--ids`` the input line is comma-separated token ids
    (drives tokenizer-less servers); otherwise the message is wrapped in
    ``--template`` and tokenized locally (``--tokenizer``) or by the
    server."""
    import http.client

    from .tokenizer import StreamDetokenizer

    tokenizer = _load_tokenizer(args.tokenizer)
    host, port = _parse_url(args.url)

    print(f"chat -> http://{host}:{port}  (/quit to exit)", flush=True)
    while True:
        sys.stdout.write("> ")
        sys.stdout.flush()
        line = sys.stdin.readline()
        if not line:
            break                       # EOF
        line = line.strip()
        if not line:
            continue
        if line in ("/quit", "/exit"):
            break

        payload = {"max_new_tokens": args.max_new_tokens, "seed": args.seed}
        if args.stop:
            payload["stop"] = args.stop
        if args.ids:
            try:
                payload["prompt_ids"] = [[int(t) for t in line.split(",")]]
            except ValueError:
                print("[error] --ids mode expects comma-separated ints",
                      file=sys.stderr)
                continue
        else:
            prompt = args.template.format(msg=line)
            if tokenizer is not None:
                payload["prompt_ids"] = [tokenizer.encode(prompt)]
            else:
                payload["prompt"] = prompt   # server-side tokenizer

        try:
            detok = (StreamDetokenizer(tokenizer)
                     if tokenizer is not None else None)
            for item in stream_generate(host, port, payload):
                if "error" in item:
                    # a mid-stream server failure arrives as an error line
                    raise RuntimeError(item["error"])
                if item.get("done"):
                    break              # stop-mode summary line
                if "text" in item:
                    piece = item["text"][0]
                elif detok is not None:
                    piece = detok.push(int(item["tokens"][0]))
                else:
                    piece = ("" if item["step"] == 0 else " ") + \
                        str(item["tokens"][0])
                sys.stdout.write(piece)
                sys.stdout.flush()
            if detok is not None:
                sys.stdout.write(detok.flush())
                sys.stdout.flush()
        except (ConnectionError, OSError, RuntimeError,
                http.client.HTTPException, json.JSONDecodeError) as e:
            # a server dying mid-stream must not kill the REPL: report
            # and take the next prompt
            print(f"\n[error] {e}", file=sys.stderr)
            continue
        sys.stdout.write("\n")
        sys.stdout.flush()
    return 0


def _parse_replicas(spec: str):
    """``host:port,host:port,...`` -> ``[(host, port), ...]``."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad replica {part!r}: expected host:port")
        out.append((host, int(port)))
    if not out:
        raise ValueError("--replicas needs at least one host:port")
    return out


def cmd_gateway(args) -> int:
    """The prefix-aware replicated serving gateway: spread /generate
    traffic across N ``serve`` replicas, routing each request to the
    replica most likely to hold its prompt prefix.  Holds no engine:
    start the replicas first, then point the gateway at them."""
    from .runtime.gateway import (GatewayHTTPServer, PrefixAwareRouter,
                                  ReplicaRegistry)

    if args.drain or args.undrain:
        # client mode: flip the drain flag on a running gateway at
        # --http-host/--http-port, print its answer, exit
        from http.client import HTTPConnection
        rid = args.drain or args.undrain
        body = json.dumps({"replica": rid,
                           "draining": bool(args.drain)}).encode()
        conn = HTTPConnection(args.http_host, args.http_port, timeout=5.0)
        try:
            conn.request("POST", "/drain", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            print(resp.read().decode("utf-8", "replace"))
            return 0 if resp.status == 200 else 1
        except OSError as e:
            print(f"gateway at {args.http_host}:{args.http_port} "
                  f"unreachable: {e}", file=sys.stderr)
            return 1
        finally:
            conn.close()
    if not args.replicas:
        print("--replicas is required (except with --drain/--undrain)",
              file=sys.stderr)
        return 1
    try:
        replicas = _parse_replicas(args.replicas)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    registry = ReplicaRegistry(
        replicas, sustain=args.evict_sustain,
        readmit_cooldown_s=args.readmit_cooldown,
        probe_interval_s=args.health_interval,
        probe_timeout_s=args.probe_timeout)
    router = PrefixAwareRouter(
        registry, min_prefix_tokens=args.min_prefix_tokens,
        block_tokens=args.route_block_tokens,
        load_factor=args.load_factor)
    server = GatewayHTTPServer(
        registry, router, host=args.http_host, port=args.http_port,
        retry_limit=args.retry_limit, resume_limit=args.resume_limit,
        proxy_timeout_s=args.proxy_timeout or None)
    print(f"GATEWAY_READY http://{server.host}:{server.port} "
          f"replicas={','.join(registry.replica_ids())}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def _gateway_parser() -> argparse.ArgumentParser:
    gw = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch gateway",
        description="replicated serving gateway: prefix-aware routing "
                    "over N serve replicas")
    gw.add_argument("--replicas", default="",
                    help="comma list of replica host:port (each a running "
                         "'serve' process); required except with "
                         "--drain/--undrain")
    gw.add_argument("--drain", default="",
                    help="client mode: mark REPLICA (host:port) draining "
                         "on the running gateway at --http-host/--http-"
                         "port: new requests stop routing to it while "
                         "in-flight streams finish")
    gw.add_argument("--undrain", default="",
                    help="client mode: clear REPLICA's draining flag")
    gw.add_argument("--http-host", default="127.0.0.1")
    gw.add_argument("--http-port", type=int, default=5080)
    gw.add_argument("--health-interval", type=float, default=1.0,
                    help="seconds between /stats health probes")
    gw.add_argument("--probe-timeout", type=float, default=2.0)
    gw.add_argument("--evict-sustain", type=int, default=3,
                    help="consecutive failures before a replica is "
                         "evicted from routing")
    gw.add_argument("--readmit-cooldown", type=float, default=5.0,
                    help="seconds a recovered replica must wait before "
                         "readmission")
    gw.add_argument("--min-prefix-tokens", type=int, default=16,
                    help="shortest prefix match that beats the hash "
                         "fallback")
    gw.add_argument("--route-block-tokens", type=int, default=16,
                    help="prefix-index granularity in tokens (match the "
                         "replicas' --kv-block-tokens)")
    gw.add_argument("--load-factor", type=float, default=2.0,
                    help="hashed picks above load_factor x (1 + fleet "
                         "mean load) are skipped down the rendezvous "
                         "order")
    gw.add_argument("--retry-limit", type=int, default=1,
                    help="alternate replicas tried when the routed one "
                         "dies before first token")
    gw.add_argument("--resume-limit", type=int, default=1,
                    help="mid-stream failover attempts: a replica dying "
                         "after first token is resumed on a survivor "
                         "this many times before the error-line "
                         "fallback (0 = disable)")
    gw.add_argument("--proxy-timeout", type=float, default=0.0,
                    help="per-socket replica timeout in seconds "
                         "(0 = none)")
    return gw


def cmd_server(args) -> int:
    """The full root-server composition (``server_app.ServerApp``):
    collection window → monitor round → cost-model plan → lifecycle
    broadcast with weight-artifact distribution → pipeline header +
    HTTP."""
    import logging
    logging.basicConfig(level=logging.INFO)
    from .server_app import ServerApp

    if args.tp > 1:
        print("--tp is not supported by the server app (the planner "
              "assigns whole layer ranges per worker)", file=sys.stderr)
        return 1

    app = ServerApp(
        model=args.model, num_workers=args.num_workers,
        checkpoint=args.checkpoint or "", weights_seed=args.weights_seed,
        max_seq=args.max_seq, max_new_tokens=args.max_new_tokens,
        greedy=args.greedy, temperature=args.temperature, top_k=args.top_k,
        min_p=args.min_p, bind_host=args.bind_host,
        http_host=args.http_host, http_port=args.http_port,
        collect_window=args.collect_window,
        collect_timeout=args.collect_timeout,
        monitor_timeout=args.monitor_timeout,
        step_timeout=args.step_timeout,
        # broadcast in the OPEN RunConfig, so every auto worker's stage
        # cache uses it too: no mixed-precision pipeline
        kv_cache_dtype=args.kv_cache_dtype or None,
        pool_size=args.pool_size, device=args.device)
    return app.run()


def _server_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch server",
        description="integrated root server: collect, profile, plan, "
                    "distribute, serve")
    _add_engine_args(ap)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--pool-size", type=int, default=1,
                    help="dynamic batching at the composed server's HTTP "
                         "surface: concurrent requests group into windows "
                         "of up to N in-flight pipeline requests")
    ap.add_argument("--bind-host", default="127.0.0.1")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=0)
    ap.add_argument("--collect-window", type=float, default=10.0,
                    help="quiet window closing device collection")
    ap.add_argument("--collect-timeout", type=float, default=120.0)
    ap.add_argument("--monitor-timeout", type=float, default=60.0)
    ap.add_argument("--step-timeout", type=float, default=120.0)
    return ap


def _auto_worker(rest) -> int:
    """``worker --auto``: connects to a ``server`` app and receives its
    role, layer range and weights from the control plane."""
    ap = argparse.ArgumentParser(prog="worker --auto")
    ap.add_argument("--registry", required=True,
                    help="server registration address host:port (the "
                         "only address a bare worker needs)")
    ap.add_argument("--device-id", required=True)
    ap.add_argument("--bind-host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--step-timeout", type=float, default=120.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(rest)
    from .server_app import run_auto_worker
    return run_auto_worker(a.registry, a.device_id, bind_host=a.bind_host,
                           port=a.port, step_timeout=a.step_timeout,
                           device=a.device)


def cmd_worker(args) -> int:
    """One pipeline stage process (``runtime/worker_main.py``);
    ``--elastic`` makes it reshard-capable (it holds the full weights
    and takes live migration); ``--auto`` connects to a ``server`` app
    and receives its role, layer range and weights from the control
    plane."""
    from .runtime import worker_main

    if args.auto:
        return _auto_worker(args.rest)
    if not args.elastic:
        return worker_main.main(args.rest)

    from .comm.faults import FaultConfigError, load_fault_plan
    from .models.base import StageSpec
    from .parallel.mesh import local_tp_mesh
    from .runtime.elastic import ElasticStageRuntime, ElasticWorker

    ap = argparse.ArgumentParser(prog="worker --elastic")
    for flag in ("--model", "--device-id", "--header"):
        ap.add_argument(flag, required=True)
    # stage placement is a placeholder: the serving header pushes the
    # real plan with its first reshard
    ap.add_argument("--stage-id", type=int, default=1)
    ap.add_argument("--num-stages", type=int, default=2)
    ap.add_argument("--layer-start", type=int, default=0)
    ap.add_argument("--layer-end", type=int, default=-1,
                    help="-1 = whole model (placeholder until reshard)")
    ap.add_argument("--bind-host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--next", default="")
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--dtype", default="")
    ap.add_argument("--weights-seed", type=int, default=0)
    ap.add_argument("--weights-npz", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-k", type=int, default=7)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--step-timeout", type=float, default=120.0)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism per stage over N local "
                         "ranks (pipeline x tp)")
    ap.add_argument("--kv-cache-dtype", default="",
                    help="reduced-precision KV cache storage for this "
                         "stage, e.g. float8_e4m3fn")
    ap.add_argument("--kv-layout", default=None, choices=["paged"])
    ap.add_argument("--fault-plan", default="",
                    help="CHAOS TESTING ONLY: JSON fault-plan spec "
                         "(path or inline); requires --chaos")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(args.rest)
    try:
        load_fault_plan(a.fault_plan, a.chaos)
    except FaultConfigError as e:
        print(str(e), file=sys.stderr)
        return 1
    cfg, device = worker_main._model(a)
    full = worker_main._full_params(a, cfg, device)
    layer_end = a.layer_end if a.layer_end >= 0 else cfg.num_layers
    spec = StageSpec(a.stage_id, a.num_stages, a.layer_start, layer_end)
    mesh = local_tp_mesh(a.tp, device)
    try:
        rt = ElasticStageRuntime(cfg, spec, full, a.max_seq,
                                 worker_main._sampling(a), seed=a.seed,
                                 kv_cache_dtype=a.kv_cache_dtype or None,
                                 kv_layout=a.kv_layout, device=device,
                                 mesh=mesh)
    except BaseException:
        if mesh is not None:
            mesh.close()
        raise
    transport = worker_main._transport(a)
    try:
        next_id = None
        if a.next:
            next_id, next_addr = a.next.split("@", 1)
            transport.connect(next_id, next_addr)
        header_id, header_addr = a.header.split("@", 1)
        transport.connect(header_id, header_addr)
        worker = ElasticWorker(rt, transport, next_id=next_id,
                               header_id=header_id,
                               step_timeout=a.step_timeout)
        print(f"WORKER_READY {a.device_id} {transport.address}",
              flush=True)
        worker.serve_forever()
    finally:
        transport.close()
        worker_main.close_stage_mesh(rt)
    return 0


def _worker_parser() -> argparse.ArgumentParser:
    """``worker``'s own two flags; the rest go to the stage's parser."""
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch worker",
        description="pipeline stage worker", add_help=False)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--auto", action="store_true",
                    help="receive role/range/weights from a `server` app")
    return ap


# ---------------------------------------------------------------------------
# plan / bench
# ---------------------------------------------------------------------------

def cmd_plan(args) -> int:
    """Offline partition planning from device profiles: the planner's
    JSON, equal to the JAX package's."""
    from .models.registry import get_model_config
    from .planner.cost_model import model_cost_profile
    from .planner.planner import (DeviceProfile, PartitionPlan,
                                  plan_partition, round_robin_plan,
                                  save_plan_cache)

    cfg = get_model_config(args.model)
    if args.load:
        with open(args.load) as f:
            plan = PartitionPlan.from_json(json.load(f))   # validates shape
        if plan.model != args.model:
            print(f"cached plan is for {plan.model!r}, not {args.model!r}",
                  file=sys.stderr)
            return 1
        print(json.dumps(plan.to_json(), indent=2))
        return 0

    with open(args.devices) as f:
        dev_json = json.load(f)
    devs = [DeviceProfile(**d) for d in dev_json]
    if args.round_robin:
        plan = round_robin_plan(cfg, args.model, devs)
    else:
        plan = plan_partition(cfg, args.model, devs, ctx=args.ctx,
                              profile=model_cost_profile(cfg, ctx=args.ctx))
    if args.save:
        save_plan_cache(args.save, plan)
    print(json.dumps(plan.to_json(), indent=2))
    return 0


def _plan_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch plan",
        description="partition planning")
    ap.add_argument("--model", required=True)
    ap.add_argument("--devices", help="JSON file: list of DeviceProfile")
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--round-robin", action="store_true",
                    help="the even round-robin split instead of the "
                         "cost-model DP")
    ap.add_argument("--save", default="")
    ap.add_argument("--load", default="")
    return ap


def cmd_bench(args) -> int:
    """Engine decode benchmark: one ``InferenceEngine.generate`` to warm,
    one timed, on a ``--batch`` x ``--prompt-len`` prompt.

    With ``--prompt-lookup`` or ``--draft-model`` it also times the
    speculative engine on the same workload and reports the speedup with
    acceptance stats."""
    import numpy as np

    want_pld = bool(args.prompt_lookup)
    want_draft = bool(args.draft_model)
    if want_pld and want_draft:
        print("choose one of --draft-model / --prompt-lookup",
              file=sys.stderr)
        return 1
    spec = None
    if want_pld or want_draft:
        # build the speculative engine first and reuse its target weights
        # for the baseline: a large checkpoint loaded twice would hold two
        # copies in device memory
        spec = (build_prompt_lookup_engine(args) if want_pld
                else build_spec_engine(args))
        from .runtime.engine import InferenceEngine
        try:
            engine = InferenceEngine(
                spec.cfg, spec.params, max_seq=args.max_seq,
                sampling=_sampling_from_args(args),
                attn_backend=args.attn_backend, device=spec.device,
                mesh=spec.mesh, cuda_graph=spec.mesh is None)
        except BaseException:
            _close_mesh(spec)
            raise
    else:
        _, engine = build_engine(args)

    prompt = np.arange(args.batch * args.prompt_len).reshape(
        args.batch, args.prompt_len) % 1000
    try:
        engine.generate(prompt, args.max_new_tokens, seed=0)   # warm
        res = engine.generate(prompt, args.max_new_tokens, seed=0)
        out = {
            "metric": f"decode tokens/sec ({args.model}, batch="
                      f"{args.batch}, prompt={args.prompt_len}, new="
                      f"{args.max_new_tokens})",
            "value": round(res.tokens_per_second, 2),
            "unit": "tokens/sec",
        }
        if spec is not None:
            from .runtime.speculative import stats_json
            spec.generate(prompt, args.max_new_tokens, seed=0)     # warm
            sres, stats = spec.generate(prompt, args.max_new_tokens, seed=0)
            out["speculative"] = dict(
                stats_json(stats, args.num_draft),
                tokens_per_sec=round(sres.tokens_per_second, 2),
                speedup=round(sres.tokens_per_second
                              / res.tokens_per_second, 3))
    finally:
        _close_mesh(engine)
    print(json.dumps(out))
    return 0


def _bench_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch bench",
        description="decode throughput benchmark")
    _add_engine_args(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    _add_draft_args(ap)
    return ap


COMMANDS = {"serve": (_serve_parser, cmd_serve),
            "generate": (_generate_parser, cmd_generate),
            "classify": (_classify_parser, cmd_classify),
            "chat": (_chat_parser, cmd_chat),
            "gateway": (_gateway_parser, cmd_gateway),
            "worker": (_worker_parser, cmd_worker),
            "server": (_server_parser, cmd_server),
            "plan": (_plan_parser, cmd_plan),
            "bench": (_bench_parser, cmd_bench)}


def _global_parser() -> argparse.ArgumentParser:
    """The flags before the command: the reference's multi-host trio."""
    ap = argparse.ArgumentParser(prog="distributed_inference_demo_tpu_torch",
                                 add_help=False)
    ap.add_argument("--jax-coordinator", default="",
                    help="host:port of process 0 (its TCPStore): joins a "
                         "multi-host group")
    ap.add_argument("--jax-num-processes", type=int, default=1)
    ap.add_argument("--jax-process-id", type=int, default=0)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    lead = []
    while argv and argv[0].startswith("--jax-"):
        lead.append(argv.pop(0))
        if "=" not in lead[-1] and argv:
            lead.append(argv.pop(0))
    gargs = _global_parser().parse_args(lead)
    multihost = None
    if gargs.jax_coordinator:
        from .parallel.mesh import init_multihost
        multihost = init_multihost(gargs.jax_coordinator,
                                   gargs.jax_num_processes,
                                   gargs.jax_process_id)
    elif gargs.jax_num_processes != 1 or gargs.jax_process_id != 0:
        # a forgotten coordinator must not silently run single-host
        print("error: --jax-num-processes/--jax-process-id require "
              "--jax-coordinator", file=sys.stderr)
        return 2
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m distributed_inference_demo_tpu_torch "
              "{serve,generate,classify,chat,gateway,worker,server,plan,"
              "bench} [options]  "
              "(see CMD --help)")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"error: unknown command {cmd!r}", file=sys.stderr)
        return 2
    parser, fn = COMMANDS[cmd]
    args, unknown = parser().parse_known_args(rest)
    args.multihost = multihost
    if cmd == "worker":
        args.rest, unknown = unknown, []
    if unknown:
        flags = [a for a in unknown if a.startswith("-")] or unknown
        print(f"error: {cmd} {' '.join(flags)}: not yet ported",
              file=sys.stderr)
        return 1
    if cmd == "plan" and not (args.devices or args.load):
        print("error: plan needs --devices or --load", file=sys.stderr)
        return 2
    try:
        return fn(args)
    except _FollowerDone:
        return 0
    except NotImplementedError as e:
        print(f"error: not yet ported: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        # configuration errors render as one line, like the JAX CLI's
        print(f"error: {e}", file=sys.stderr)
        return 1
