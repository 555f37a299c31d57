"""Standalone worker process entry point: pipeline stage, or a
disaggregated prefill/decode role.

Counterpart of ``distributed_inference_demo_tpu/runtime/worker_main.py``:

    python -m distributed_inference_demo_tpu_torch.runtime.worker_main \\
        --model llama-test --device cpu --stage-id 1 --num-stages 2 \\
        --layer-start 1 --layer-end 2 --device-id w1 --port 0 \\
        --header header@127.0.0.1:5555 --greedy

``--role stage`` (the default) runs one pipeline stage over the socket
transport (``ZmqTransport``; without pyzmq it fails with the import
error) and prints ``WORKER_READY {id} {address}`` once it listens.
``--role prefill`` / ``--role decode`` run the disaggregated serving
roles (``runtime/disagg.py``; ``--live-migration`` co-serves
``runtime/migration.py``'s protocol on a decode worker), with their
peers dialed by repeatable ``--peer id@host:port`` flags.

Weights: every process derives the same full tree from
``--weights-seed`` (the port's ``init_full_params`` over a generator
seeded with it, quantized for an ``-int8`` / ``-int4`` model, as
``serve --chain`` derives the header's), then slices its stage; or
``--weights-npz`` reads a tree written by
``models.bridge.save_npz_tree``, e.g. the reference's weights.  The
stage runs on ``--device`` (CUDA unless "cpu").  ``--tp`` > 1 is
refused: a tp mesh per stage is a later slice.
"""

from __future__ import annotations

import argparse
import sys


def _full_params(args, cfg, device):
    """The full tree: ``--weights-npz`` if given, else the seed rule."""
    if args.weights_npz:
        from ..models.bridge import params_from_numpy
        return params_from_numpy(args.weights_npz, cfg, device)
    from ..models.loader import load_or_init
    return load_or_init(args.model, cfg, None, seed=args.weights_seed,
                        device=device)


def _model(args):
    from ..device import resolve_device
    from ..models.registry import get_model_config
    cfg = get_model_config(args.model)
    if args.dtype:
        cfg = cfg.replace(dtype_name=args.dtype)
    return cfg, resolve_device(args.device)


def _sampling(args):
    from ..ops.sampling import SamplingParams
    if args.greedy:
        return SamplingParams(greedy=True)
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          min_p=args.min_p)


def _transport(args):
    from ..comm.faults import load_fault_plan, maybe_wrap
    from ..comm.transport import ZmqTransport
    return maybe_wrap(
        ZmqTransport(args.device_id, bind_host=args.bind_host,
                     port=args.port),
        load_fault_plan(getattr(args, "fault_plan", ""),
                        getattr(args, "chaos", False)))


def build_worker(args):
    """(PipelineWorker, transport) for ``--role stage``; the stage runs
    tp-sharded over ``--tp`` local ranks (``worker.rt.mesh``)."""
    from ..models.base import StageSpec, slice_stage
    from ..parallel.mesh import local_tp_mesh
    from .distributed import PipelineWorker, StageRuntime

    cfg, device = _model(args)
    spec = StageSpec(args.stage_id, args.num_stages,
                     args.layer_start, args.layer_end)
    params = slice_stage(_full_params(args, cfg, device), cfg, spec)
    # pipeline x tensor parallelism: each worker picks its own tp
    mesh = local_tp_mesh(args.tp, device)
    try:
        runtime = StageRuntime(cfg, spec, params, max_seq=args.max_seq,
                               sampling=_sampling(args), seed=args.seed,
                               kv_cache_dtype=args.kv_cache_dtype or None,
                               kv_layout=args.kv_layout or None,
                               device=device, mesh=mesh)
    except BaseException:
        if mesh is not None:
            mesh.close()
        raise
    transport = _transport(args)
    next_id = None
    if args.next:
        next_id, next_addr = args.next.split("@", 1)
        transport.connect(next_id, next_addr)
    header_id, header_addr = args.header.split("@", 1)
    transport.connect(header_id, header_addr)
    worker = PipelineWorker(runtime, transport, next_id=next_id,
                            header_id=header_id,
                            step_timeout=args.step_timeout)
    return worker, transport


def build_role_worker(args):
    """Build a disaggregated-role worker (``--role prefill|decode``) on
    a ZMQ transport with its ``--peer`` connections dialed.  As the
    reference's, these roles run on one device whatever ``--tp`` says."""
    from .disagg import DecodeWorker, PrefillWorker

    cfg, device = _model(args)
    params = _full_params(args, cfg, device)
    transport = _transport(args)
    for peer in args.peer or ():
        pid, addr = peer.split("@", 1)
        transport.connect(pid, addr)
    if args.role == "prefill":
        worker = PrefillWorker(
            cfg, params, transport, max_seq=args.max_seq,
            prefill_chunk=args.prefill_chunk or 32,
            kv_cache_blocks=args.kv_cache_blocks,
            kv_block_tokens=args.kv_block_tokens,
            ack_timeout=args.migration_ack_timeout,
            migration_retries=args.migration_retries, device=device)
        return worker, transport, None
    from .batching import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(
        cfg, params, max_seq=args.max_seq, max_batch=args.batch_slots,
        sampling=_sampling(args), seed=args.seed, eos_id=args.eos_id,
        decode_block=args.decode_block,
        kv_cache_blocks=args.kv_cache_blocks,
        kv_block_tokens=args.kv_block_tokens,
        kv_cache_dtype=args.kv_cache_dtype or None, device=device)
    worker = DecodeWorker(engine, transport)
    if args.live_migration:
        # both protocols share ONE PageStager, so their pg:/pgx: frames
        # resolve to the same staging records
        from .migration import CoServingWorker, MigrationWorker
        mig = MigrationWorker(engine, transport,
                              ack_timeout=args.migration_ack_timeout,
                              retries=args.migration_retries,
                              stager=worker.stager)
        worker = CoServingWorker(worker, mig)
    return worker, transport, engine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="pipeline stage / "
                                 "disaggregated-role worker")
    ap.add_argument("--model", required=True)
    ap.add_argument("--role", default="stage",
                    choices=["stage", "prefill", "decode"],
                    help="stage = one pipeline stage (default); "
                         "prefill/decode = the disaggregated serving "
                         "roles: prefill runs chunked prefill and "
                         "migrates KV pages to its decode peer; decode "
                         "adopts migrated pages into a "
                         "continuous-batching engine")
    ap.add_argument("--stage-id", type=int, default=None)
    ap.add_argument("--num-stages", type=int, default=None)
    ap.add_argument("--layer-start", type=int, default=None)
    ap.add_argument("--layer-end", type=int, default=None)
    ap.add_argument("--device-id", required=True)
    ap.add_argument("--bind-host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--next", default="",
                    help="next stage as id@host:port (empty on the tail)")
    ap.add_argument("--header", default="",
                    help="header as id@host:port (token return edge; "
                         "required for --role stage)")
    ap.add_argument("--peer", action="append", default=[],
                    help="disagg roles: connect a peer as id@host:port "
                         "(repeatable)")
    ap.add_argument("--batch-slots", type=int, default=8,
                    help="--role decode: continuous-batching slots")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="--role decode: fuse N decode steps per "
                         "dispatch when no admission could land")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="--role prefill: chunk size of the chunked "
                         "prefill whose chunk boundaries the page "
                         "migration streams on")
    ap.add_argument("--migration-ack-timeout", type=float, default=None,
                    help="--role prefill (or decode --live-migration): "
                         "seconds to wait for a migration ack before "
                         "retransmitting (default "
                         "DWT_DISAGG_ACK_TIMEOUT_S, else 2.0)")
    ap.add_argument("--migration-retries", type=int, default=None,
                    help="--role prefill (or decode --live-migration): "
                         "bounded end/retransmit rounds before the "
                         "handoff is reported failed (default "
                         "DWT_DISAGG_MIGRATION_RETRIES, else 5)")
    ap.add_argument("--live-migration", action="store_true",
                    help="--role decode: co-serve the live decode-to-"
                         "decode migration protocol on this worker's "
                         "transport")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--dtype", default="",
                    help="override model dtype (e.g. float32 for CPU runs)")
    ap.add_argument("--weights-seed", type=int, default=0)
    ap.add_argument("--weights-npz", default="",
                    help="the full parameter tree from an .npz written by "
                         "models.bridge.save_npz_tree (else "
                         "--weights-seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-k", type=int, default=7)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--step-timeout", type=float, default=120.0)
    ap.add_argument("--kv-cache-dtype", default="",
                    help="reduced-precision KV cache storage for this "
                         "stage, e.g. float8_e4m3fn")
    ap.add_argument("--kv-layout", default=None, choices=["paged"],
                    help="this stage's request-cache layout (paged is "
                         "the only layout: every rid backed by one "
                         "per-stage page pool, blocks reserved per chunk "
                         "actually run, freed on end:{rid})")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism per stage over N local "
                         "ranks (pipeline x tp)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve Prometheus GET /metrics on this port "
                         "(0 = ephemeral, -1 = disabled)")
    ap.add_argument("--kv-cache-blocks", type=int, default=None,
                    help="block-level KV prefix cache: pool size for the "
                         "prefill/decode roles; refused on pipeline "
                         "stage workers (a stage sees activations, not "
                         "token ids)")
    ap.add_argument("--kv-block-tokens", type=int, default=None,
                    help="tokens per KV cache block (see "
                         "--kv-cache-blocks; refused on stage workers)")
    ap.add_argument("--fault-plan", default="",
                    help="CHAOS TESTING ONLY: JSON fault-plan spec (path "
                         "or inline) injected into this stage's "
                         "transport; requires --chaos (env "
                         "DWT_FAULT_PLAN)")
    ap.add_argument("--chaos", action="store_true",
                    help="explicitly acknowledge fault injection; "
                         "--fault-plan/DWT_FAULT_PLAN are rejected "
                         "without it")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from ..comm.faults import FaultConfigError, load_fault_plan
    try:
        load_fault_plan(args.fault_plan, args.chaos)  # validate early
    except FaultConfigError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.live_migration and args.role != "decode":
        print("--live-migration requires --role decode (live handoffs "
              "move mid-flight requests between decode replicas)",
              file=sys.stderr)
        return 1
    if args.role == "stage":
        if args.kv_cache_blocks or args.kv_block_tokens:
            print("--kv-cache-blocks/--kv-block-tokens are not supported "
                  "on pipeline stage workers (stages see activations, "
                  "not tokens; block KV reuse lives in the engine-backed "
                  "serve modes — serve --batch-slots, the plain engine, "
                  "or the disagg --role prefill/decode workers)",
                  file=sys.stderr)
            return 1
        missing = [f for f, v in (("--stage-id", args.stage_id),
                                  ("--num-stages", args.num_stages),
                                  ("--layer-start", args.layer_start),
                                  ("--layer-end", args.layer_end),
                                  ("--header", args.header))
                   if v in (None, "")]
        if missing:
            print(f"--role stage requires {'/'.join(missing)}",
                  file=sys.stderr)
            return 1

    # black-box capture: the flight ring is labeled with this worker's
    # identity, and an unhandled crash dumps a postmortem bundle (when
    # DWT_POSTMORTEM_DIR is configured) before the process dies
    from ..telemetry import flightrecorder, postmortem
    flightrecorder.get_flight_recorder().proc = args.device_id
    postmortem.install_crash_handler(config=vars(args))

    engine = None
    try:
        if args.role == "stage":
            worker, transport = build_worker(args)
        else:
            worker, transport, engine = build_role_worker(args)
    except NotImplementedError as e:
        print(f"error: not yet ported: {e}", file=sys.stderr)
        return 1
    metrics_srv = None
    if args.metrics_port >= 0:
        from ..telemetry import MetricsHTTPServer
        from ..telemetry import catalog as _catalog

        def _debugz() -> dict:
            out = {"device_id": args.device_id,
                   "flight": flightrecorder.debug_state(),
                   "postmortem": postmortem.debug_state()}
            if args.role == "stage":
                out["stats"] = worker.stats.snapshot()
            else:
                out["disagg"] = worker.debug_state()
            return out

        if args.role == "stage":
            def _render():
                return _catalog.render_worker(worker.stats,
                                              args.device_id)
        else:
            def _render():
                return _catalog.scrape(engine if engine is not None
                                       else worker)
        metrics_srv = MetricsHTTPServer(
            _render, host=args.bind_host, port=args.metrics_port,
            debug_provider=_debugz)
        metrics_srv.start()
        print(f"METRICS_READY http://{metrics_srv.host}:"
              f"{metrics_srv.port}/metrics", flush=True)
    print(f"WORKER_READY {args.device_id} {transport.address}", flush=True)
    try:
        worker.serve_forever()
    finally:
        if metrics_srv is not None:
            metrics_srv.shutdown()
        if engine is not None:
            engine.close()
        transport.close()
        close_stage_mesh(getattr(worker, "rt", None))
    return 0


def close_stage_mesh(runtime) -> None:
    """Close a stage runtime's tp mesh, so that no follower outlives the
    worker."""
    mesh = getattr(runtime, "mesh", None)
    if mesh is not None:
        mesh.close()


if __name__ == "__main__":
    sys.exit(main())
