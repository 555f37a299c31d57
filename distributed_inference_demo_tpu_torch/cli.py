"""Command line: ``python -m distributed_inference_demo_tpu_torch serve``.

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

Two serve modes of the JAX package's CLI, with the weights of an HF
safetensors directory (``--checkpoint``) or random weights from
``--weights-seed``, quantized for an ``-int8`` / ``-int4`` model, behind
``InferenceHTTPServer``: plain (one
``InferenceEngine``) and ``--batch-slots N`` (a ``ContinuousBatchingEngine``
over the paged KV pool, with ``--kv-cache-blocks``, ``--kv-block-tokens``,
``--decode-block``, ``--prefill-chunk``, ``--admission-queue-depth``,
``--mixed-token-budget`` and ``--kv-dtype``).
It runs on CUDA unless ``--device cpu`` is given.  Every other subcommand
and mode flag of the JAX package's CLI exits 1 with "not yet ported".
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED_COMMANDS = ("gateway", "server", "worker", "plan", "chat",
                       "generate", "bench", "classify")


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


def build_batching_engine(args):
    """(cfg, ContinuousBatchingEngine) for ``serve --batch-slots N``."""
    from .runtime.batching import ContinuousBatchingEngine

    device, cfg, params = _params(args)
    return cfg, ContinuousBatchingEngine(
        cfg, params, max_seq=args.max_seq, max_batch=args.batch_slots,
        sampling=_sampling_from_args(args), seed=args.seed,
        eos_id=args.eos_id, decode_block=args.decode_block,
        prefill_chunk=args.prefill_chunk or None,
        max_queue_depth=args.admission_queue_depth,
        mixed_token_budget=args.mixed_token_budget or None,
        kv_dtype=args.kv_dtype,
        kv_cache_blocks=args.kv_cache_blocks,
        kv_block_tokens=args.kv_block_tokens,
        attn_backend="cuda" if args.attn_backend == "flash"
        else args.attn_backend, device=device)


def build_engine(args):
    """(cfg, InferenceEngine) for the parsed plain serve flags."""
    from .runtime.engine import InferenceEngine

    device, cfg, params = _params(args)
    return cfg, InferenceEngine(
        cfg, params, max_seq=args.max_seq,
        sampling=_sampling_from_args(args),
        attn_backend=args.attn_backend, eos_id=args.eos_id,
        prefill_chunk=args.prefill_chunk or None,
        kv_cache_blocks=args.kv_cache_blocks,
        kv_block_tokens=args.kv_block_tokens, kv_dtype=args.kv_dtype,
        stream_block=args.stream_block, device=device)


def cmd_serve(args) -> int:
    from .runtime.http_server import InferenceHTTPServer

    if args.batch_slots:
        if args.stream_block is not None:
            # the scheduler's fused block is --decode-block; a second K
            # knob is rejected, never silently ignored
            print("--stream-block is not supported with --batch-slots "
                  "(use --decode-block)", file=sys.stderr)
            return 1
        cfg, engine = build_batching_engine(args)
        kvc = engine.kv_cache
        print(f"SERVE_BATCHING {args.model} slots={args.batch_slots} "
              f"kv_cache={kvc.num_blocks}x{kvc.block_tokens}tok "
              f"{engine.kv_layout} kv_dtype={engine.kv_dtype} "
              f"mixed_token_budget={engine.mixed_token_budget} tp=1 "
              f"attn={engine.attn_backend} device={engine.device}",
              flush=True)
    else:
        cfg, engine = build_engine(args)
        print(f"SERVE_ENGINE {args.model} attn={engine.attn_backend} "
              f"device={engine.device}", flush=True)
    server = InferenceHTTPServer(engine, host=args.http_host,
                                 port=args.http_port, model_name=args.model,
                                 default_max_new=args.max_new_tokens)
    print(f"HTTP_READY http://{server.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        if args.batch_slots:
            engine.close()
    return 0


def _serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="distributed_inference_demo_tpu_torch serve",
        description="HTTP inference server (PyTorch/CUDA port)")
    ap.add_argument("--model", required=True)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--weights-seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="an HF safetensors checkpoint directory (else "
                         "random weights from --weights-seed)")
    ap.add_argument("--seed", type=int, default=0,
                    help="with --batch-slots: seeds the engine's one "
                         "sampling stream, and a request's own seed is not "
                         "honored; otherwise unused, requests carry their "
                         "own seed")
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
    ap.add_argument("--batch-slots", type=int, default=0,
                    help="continuous batching with N slots: concurrent "
                         "requests join the running decode batch between "
                         "steps")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="with --batch-slots: fuse N decode steps per "
                         "dispatch when no admission could land anyway")
    ap.add_argument("--kv-cache-blocks", type=int, default=None,
                    help="with --batch-slots: page-pool size in blocks "
                         "(default DWT_KVCACHE_BLOCKS, else slots x "
                         "table width)")
    ap.add_argument("--kv-block-tokens", type=int, default=None,
                    help="tokens per KV page (default "
                         "DWT_KVCACHE_BLOCK_TOKENS, else 16)")
    ap.add_argument("--mixed-token-budget", type=int, default=0,
                    help="with --batch-slots and --prefill-chunk: pack "
                         "prefill chunk tokens from admitting prompts "
                         "into the SAME dispatch as the fused decode "
                         "block, up to N tokens total per step (decode "
                         "fusion survives admission; default "
                         "DWT_MIXED_TOKEN_BUDGET or 0 = serialized)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["bf16", "int8", "int4"],
                    help="with --batch-slots: the KV page width: bf16 "
                         "stores full-width pages (the default); int8 / "
                         "packed int4 quantize each page at write time "
                         "with a per-token scale beside it.  Default "
                         "DWT_KV_DTYPE, else bf16")
    ap.add_argument("--admission-queue-depth", type=int, default=0,
                    help="with --batch-slots: answer 503 + Retry-After "
                         "once this many requests wait for a slot (0 = "
                         "unbounded)")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=5000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m distributed_inference_demo_tpu_torch serve "
              "--model MODEL [options]  (see serve --help)")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in NOT_PORTED_COMMANDS:
        print(f"error: the '{cmd}' command is not yet ported",
              file=sys.stderr)
        return 1
    if cmd != "serve":
        print(f"error: unknown command {cmd!r}", file=sys.stderr)
        return 2
    args, unknown = _serve_parser().parse_known_args(rest)
    if unknown:
        flags = [a for a in unknown if a.startswith("-")] or unknown
        print(f"error: serve {' '.join(flags)}: not yet ported",
              file=sys.stderr)
        return 1
    try:
        return cmd_serve(args)
    except NotImplementedError as e:
        print(f"error: not yet ported: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        # configuration errors render as one line, like the JAX CLI's
        print(f"error: {e}", file=sys.stderr)
        return 1
