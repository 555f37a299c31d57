"""The torch port imports neither JAX nor any module of the JAX package."""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "distributed_inference_demo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "distributed_inference_demo_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{line}: {name}"
           for f in files for line, name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter in which
    ``import jax`` and ``import distributed_inference_demo_tpu`` fail."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import distributed_inference_demo_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_port_imports_with_zmq_and_ml_dtypes_blocked():
    """The card machine has neither ``zmq``, ``msgpack`` nor
    ``ml_dtypes``: every module of the port (and ``chip_smoke.py``)
    imports with them blocked, as with jax blocked; in the sources
    ``zmq`` is imported only inside the function ``ZmqTransport`` calls,
    ``msgpack`` and ``ml_dtypes`` nowhere."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    top = [f"{f.relative_to(REPO)}:{node.lineno}"
           for f in files
           for node in ast.parse(f.read_text()).body
           if isinstance(node, (ast.Import, ast.ImportFrom))
           and any(n.split(".")[0] in ("zmq", "ml_dtypes", "msgpack")
                   for n in ([a.name for a in node.names]
                             if isinstance(node, ast.Import)
                             else [node.module or ""]))]
    assert not top, top
    assert not [f for f in files for _, name in _imports(f)
                if name.split(".")[0] in ("ml_dtypes", "msgpack")]
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu',\n"
        "          'zmq', 'ml_dtypes', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import distributed_inference_demo_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "from distributed_inference_demo_tpu_torch.comm import transport\n"
        "try:\n"
        "    transport.ZmqTransport('z')\n"
        "except ImportError:\n"
        "    print('zmq-lazy')\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = res.stdout.split()
    assert out[0] == "zmq-lazy" and int(out[1]) >= 25


def test_mesh_follower_entry_point_imports_no_jax():
    """A spawned follower (``parallel.mesh._follower_main``) and the
    commands it runs (a tp forward, an sp generation, an ep MLP) import
    neither JAX nor the JAX package, with both blocked in rank 0."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from distributed_inference_demo_tpu_torch.models import "
        "get_model_config\n"
        "from distributed_inference_demo_tpu_torch.models.decoder import "
        "init_full_params\n"
        "from distributed_inference_demo_tpu_torch.parallel import mesh "
        "as M, tensor as T, sequence as S\n"
        "from distributed_inference_demo_tpu_torch.runtime.engine import "
        "InferenceEngine\n"
        "if __name__ == '__main__':\n"
        "    cfg = get_model_config('llama-test')\n"
        "    p = init_full_params(torch.Generator().manual_seed(0), cfg, "
        "'cpu')\n"
        "    with M.local_tp_mesh(2, 'cpu', 60) as mesh:\n"
        "        InferenceEngine(cfg, p, device='cpu', mesh=mesh"
        ").generate([[1, 2, 3, 4]], 2)\n"
        "        mods = M.loaded_modules(mesh)\n"
        "    with M.local_sp_mesh(2, 'cpu', 60) as mesh:\n"
        "        S.make_sp_generate_fn(cfg, mesh, max_seq=16, "
        "num_new_tokens=2)(p, [[1, 2, 3, 4]])\n"
        "        mods += M.loaded_modules(mesh)\n"
        "    bad = sorted({n for ms in mods for n in ms\n"
        "                  if n.split('.')[0] in ('jax', 'jaxlib',\n"
        "                  'distributed_inference_demo_tpu')})\n"
        "    print('BAD', bad, len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("BAD")]
    assert line == ["BAD [] 4"], res.stdout


CHAIN_MODULES = ("runtime.stats", "runtime.distributed", "runtime.elastic",
                 "runtime.dynamic_batch", "runtime.worker_main",
                 "runtime.http_server")


def test_chain_runs_with_jax_zmq_and_ml_dtypes_blocked():
    """The card machine's case: the ring pipeline's modules import, and
    an in-process elastic chain over ``LoopbackTransport`` (with
    ``HeaderBackend`` on top) generates, with jax, the JAX package, zmq
    and ml_dtypes all blocked; a ``worker`` process there fails with
    zmq's import error instead of falling back to anything."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu',\n"
        "          'zmq', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, threading, torch\n"
        f"for n in {CHAIN_MODULES!r}:\n"
        "    importlib.import_module('distributed_inference_demo_tpu_torch.'"
        " + n)\n"
        "from distributed_inference_demo_tpu_torch.comm.transport import "
        "LoopbackNetwork, LoopbackTransport\n"
        "from distributed_inference_demo_tpu_torch.models import "
        "get_model_config\n"
        "from distributed_inference_demo_tpu_torch.models.base import "
        "split_layer_ranges\n"
        "from distributed_inference_demo_tpu_torch.models.decoder import "
        "init_full_params\n"
        "from distributed_inference_demo_tpu_torch.runtime.elastic import "
        "ElasticHeader, ElasticStageRuntime, ElasticWorker\n"
        "from distributed_inference_demo_tpu_torch.runtime.http_server "
        "import HeaderBackend\n"
        "from distributed_inference_demo_tpu_torch.runtime import "
        "worker_main\n"
        "cfg = get_model_config('llama-test')\n"
        "full = init_full_params(torch.Generator().manual_seed(0), cfg, "
        "'cpu')\n"
        "specs = split_layer_ranges(cfg.num_layers, 2)\n"
        "net = LoopbackNetwork()\n"
        "rt = [ElasticStageRuntime(cfg, s, full, 32, device='cpu') "
        "for s in specs]\n"
        "w = ElasticWorker(rt[1], LoopbackTransport('s1', net), None, "
        "'s0', 30)\n"
        "th = threading.Thread(target=w.serve_forever, daemon=True)\n"
        "th.start()\n"
        "h = ElasticHeader(rt[0], LoopbackTransport('s0', net), "
        "['s0', 's1'], step_timeout=30)\n"
        "h.reshard(['s0', 's1'])\n"
        "res = HeaderBackend(h, 32).generate([[1, 2, 3]], 3)\n"
        "h.shutdown_pipeline()\n"
        "th.join(30)\n"
        "try:\n"
        "    worker_main.main(['--model', 'llama-test', '--device', 'cpu',"
        " '--stage-id', '1', '--num-stages', '2', '--layer-start', '0',"
        " '--layer-end', '2', '--device-id', 'w', '--port', '0',"
        " '--header', 'h@127.0.0.1:1'])\n"
        "except ImportError:\n"
        "    print('zmq-refused')\n"
        "print('TOKENS', res.tokens.shape)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[-3:-1] == ["zmq-refused",
                                             "TOKENS (1, 3)"], res.stdout


CONTROL_MODULES = ("planner", "planner.cost_model", "planner.planner",
                   "control", "control.messages", "control.pool",
                   "control.router", "control.service", "control.lifecycle",
                   "monitor", "monitor.probes", "monitor.agent",
                   "monitor.aggregator", "server_app")


def test_control_plane_runs_with_jax_zmq_msgpack_and_ml_dtypes_blocked():
    """The card machine's case for the root server: the control plane's
    modules import; the registration, monitor and lifecycle handlers
    answer in process (``bind=False``) with envelopes of the port's own
    codec; a stage blob round-trips; ``server`` and ``worker --auto``
    fail with zmq's import error, with no fallback."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu',\n"
        "          'zmq', 'ml_dtypes', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, torch\n"
        f"for n in {CONTROL_MODULES!r}:\n"
        "    importlib.import_module('distributed_inference_demo_tpu_torch.'"
        " + n)\n"
        "from distributed_inference_demo_tpu_torch import cli\n"
        "from distributed_inference_demo_tpu_torch.control import (\n"
        "    DevicePoolManager, LifecycleServer, RegistrationService,\n"
        "    RunConfig, MsgType, decode)\n"
        "from distributed_inference_demo_tpu_torch.control.messages import "
        "make\n"
        "from distributed_inference_demo_tpu_torch.monitor import (\n"
        "    MonitorAggregator, MonitorService)\n"
        "from distributed_inference_demo_tpu_torch.models import "
        "get_model_config, loader\n"
        "from distributed_inference_demo_tpu_torch.models.decoder import "
        "init_full_params\n"
        "reg = RegistrationService(DevicePoolManager(), bind=False)\n"
        "[r] = reg.dispatch('w1', make(MsgType.REGISTER, device_id='w1', "
        "address='loopback:w1'))\n"
        "agg = MonitorAggregator(['w1'])\n"
        "mon = MonitorService(agg, bind=False)\n"
        "[m] = mon.dispatch('w1', make(MsgType.MONITOR_REPORT, report={}))\n"
        "cfg = get_model_config('llama-test')\n"
        "p = init_full_params(torch.Generator().manual_seed(0), cfg, 'cpu')\n"
        "blob = loader.stage_params_to_bytes(p)\n"
        "back = loader.stage_params_from_bytes(blob, 'cpu')\n"
        "lc = LifecycleServer(RunConfig(device_ids=['w1']), "
        "lambda d, n: blob, bind=False)\n"
        "[o] = lc.dispatch('w1', make(MsgType.READY))\n"
        "lc.dispatch('w1', make(MsgType.INITIALIZED))\n"
        "print(decode(r).get('ok'), decode(m).type.value, "
        "decode(o).type.value, lc.take_pushed('w1') != [], "
        "torch.equal(back.layers['wq'], p.layers['wq']))\n"
        "for argv in (['server', '--model', 'llama-test', '--device', "
        "'cpu'], ['worker', '--auto', '--registry', '127.0.0.1:1', "
        "'--device-id', 'w1', '--device', 'cpu']):\n"
        "    try:\n"
        "        cli.main(argv)\n"
        "    except ImportError:\n"
        "        print('zmq-refused')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[-4:-1] == [
        "True monitor_stop open True True", "zmq-refused",
        "zmq-refused"], res.stdout


MULTIMODAL_MODULES = ("models.vision", "runtime.multimodal",
                      "comm.native_codec", "comm.native.build", "tokenizer")


def test_multimodal_and_native_run_with_jax_zmq_and_ml_dtypes_blocked():
    """The card machine's case for the multimodal slice: its modules
    import, ``MultimodalHeader`` + ``VisionWorker`` generate over
    ``LoopbackTransport``, and the native library builds from the port's
    own sources (no file of the JAX package is read) and gives the wire's
    bytes and the python tokenizer's ids, with jax, the JAX package, zmq
    and ml_dtypes all blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu',\n"
        "          'zmq', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, json, threading, numpy as np, torch\n"
        f"for n in {MULTIMODAL_MODULES!r}:\n"
        "    importlib.import_module('distributed_inference_demo_tpu_torch.'"
        " + n)\n"
        "from distributed_inference_demo_tpu_torch import cli\n"
        "from distributed_inference_demo_tpu_torch.comm import wire, "
        "native_codec\n"
        "from distributed_inference_demo_tpu_torch.comm.native import build\n"
        "from distributed_inference_demo_tpu_torch.comm.transport import "
        "LoopbackNetwork, LoopbackTransport\n"
        "from distributed_inference_demo_tpu_torch.models import "
        "get_model_config\n"
        "from distributed_inference_demo_tpu_torch.models.base import "
        "slice_stage, split_layer_ranges\n"
        "from distributed_inference_demo_tpu_torch.models.decoder import "
        "init_full_params\n"
        "from distributed_inference_demo_tpu_torch.models.vision import "
        "init_vision_params\n"
        "from distributed_inference_demo_tpu_torch.runtime.distributed "
        "import PipelineWorker, StageRuntime\n"
        "from distributed_inference_demo_tpu_torch.runtime.multimodal "
        "import MultimodalEngine, MultimodalHeader, VisionWorker\n"
        "from distributed_inference_demo_tpu_torch.tokenizer import "
        "Tokenizer\n"
        "from distributed_inference_demo_tpu_torch.ops.sampling import "
        "SamplingParams\n"
        "g = SamplingParams(greedy=True)\n"
        "cfg = get_model_config('llama-test')\n"
        "full = init_full_params(torch.Generator().manual_seed(0), cfg, "
        "'cpu')\n"
        "vcfg = cli.vision_config('clip-test')\n"
        "vp = init_vision_params(torch.Generator().manual_seed(1), vcfg, "
        "cfg.hidden_size, 'cpu')\n"
        "img = np.ones((1, 28, 28, 3), np.float32)\n"
        "text = np.array([[1, 2, 3]], np.int32)\n"
        "want = MultimodalEngine(cfg, full, vcfg, vp, 32, g, device='cpu')"
        ".generate(img, text, 3).tokens\n"
        "specs = split_layer_ranges(cfg.num_layers, 2)\n"
        "net = LoopbackNetwork()\n"
        "rt = [StageRuntime(cfg, s, slice_stage(full, cfg, s), 32, g, "
        "device='cpu') for s in specs]\n"
        "w = PipelineWorker(rt[1], LoopbackTransport('s1', net), None, "
        "'s0', step_timeout=30)\n"
        "v = VisionWorker(vp, vcfg, LoopbackTransport('vis', net), 's0', "
        "30)\n"
        "ths = [threading.Thread(target=x.serve_forever, args=(30,), "
        "daemon=True) for x in (w, v)]\n"
        "[t.start() for t in ths]\n"
        "h = MultimodalHeader(rt[0], LoopbackTransport('s0', net), 's1', "
        "'vis', step_timeout=30)\n"
        "got = h.generate_mm(img, text, 3)\n"
        "h.shutdown_pipeline()\n"
        "h.transport.send('vis', 'stop', b'')\n"
        "[t.join(30) for t in ths]\n"
        "arrs = [np.arange(6, dtype=np.float32), "
        "wire.bf16_view(np.arange(4, dtype=np.uint16))]\n"
        "same = native_codec.serialize_tensors(arrs) == "
        "wire.serialize_tensors(arrs)\n"
        "spec = json.dumps({'model': {'type': 'BPE', 'vocab': {'a': 0, "
        "'b': 1, 'ab': 2}, 'merges': ['a b']}, 'pre_tokenizer': "
        "{'type': 'ByteLevel'}})\n"
        "ids = [Tokenizer.from_json(spec, backend=b).encode('abab') "
        "for b in ('native', 'python')]\n"
        "print('SOURCES', build.SRC_DIR.parent.parent.name)\n"
        "print('OK', bool((got == want).all()), same, ids[0] == ids[1])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[-3:-1] == [
        "SOURCES distributed_inference_demo_tpu_torch",
        "OK True True True"], res.stdout


TRAIN_BLOCKED = ("jax", "jaxlib", "distributed_inference_demo_tpu", "optax",
                 "orbax", "safetensors", "ml_dtypes")


def test_train_save_restore_with_jax_optax_orbax_safetensors_blocked():
    """The card machine's case for training: a pp=2 train step over two
    spawned ranks, a ``TrainCheckpointManager`` save and a restore in a
    fresh manager, with jax, the JAX package, optax, orbax, safetensors
    and ml_dtypes blocked in rank 0; no rank loads any of them."""
    code = (
        "import sys\n"
        f"for m in {TRAIN_BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import functools, shutil, tempfile, torch\n"
        "from distributed_inference_demo_tpu_torch import checkpoint as C\n"
        "from distributed_inference_demo_tpu_torch.models import "
        "get_model_config\n"
        "from distributed_inference_demo_tpu_torch.parallel import mesh "
        "as M, pipeline as P\n"
        "if __name__ == '__main__':\n"
        "    cfg = get_model_config('llama-test')\n"
        "    opt = functools.partial(torch.optim.AdamW, lr=1e-3, "
        "weight_decay=1e-4)\n"
        "    d = tempfile.mkdtemp()\n"
        "    mgr = C.TrainCheckpointManager(d, cfg, opt, device='cpu')\n"
        "    _, p, _ = mgr.restore_or_init(seed=0)\n"
        "    ids = torch.arange(32).reshape(4, 8) % cfg.vocab_size\n"
        "    with M.local_mesh(M.MeshConfig(pp=2), 'cpu', 60) as mesh:\n"
        "        step = P.make_pipeline_train_step(cfg, mesh, opt, 2)\n"
        "        p2, o, loss = step(p, None, ids, ids)\n"
        "        got = P.gather_pipeline_params(p2, cfg)\n"
        "        mods = M.loaded_modules(mesh)\n"
        "    one = M.local_mesh(M.MeshConfig(), 'cpu')\n"
        "    p1, o1, _ = P.make_pipeline_train_step(cfg, one, opt, 2)(\n"
        "        p, None, ids, ids)\n"
        "    mgr.save(1, p1, o1)\n"
        "    r, ro = C.TrainCheckpointManager(d, cfg, opt, device='cpu')"
        ".restore()\n"
        "    same = all(torch.equal(r.layers[k], p1.layers[k]) for k in "
        "p1.layers)\n"
        "    st = ro.state_dict()['state']\n"
        "    same_opt = all(torch.equal(st[i]['exp_avg'], "
        "o1.state_dict()['state'][i]['exp_avg']) for i in st)\n"
        "    one.close()\n"
        "    shutil.rmtree(d)\n"
        f"    bad = sorted({{n for ms in mods for n in ms if n.split('.')[0]"
        f" in {TRAIN_BLOCKED!r}}})\n"
        "    print('BAD', bad, len(mods))\n"
        "    print('OK', bool(torch.isfinite(loss)), same, same_opt, "
        "torch.allclose(got[('layers', 'wq')], p1.layers['wq'].detach(), "
        "atol=1e-6))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split("\n")[-3:-1] == [
        "BAD [] 2", "OK True True True True"], res.stdout


TP_SLICE_MODULES = ("runtime", "runtime.kvcache", "runtime.kvcache.manager",
                    "runtime.kvcache.device", "runtime.kvcache.tiered",
                    "runtime.speculative", "runtime.prompt_lookup",
                    "runtime.batching", "runtime.distributed",
                    "runtime.elastic", "runtime.worker_main",
                    "parallel.tensor", "parallel.pipeline", "checkpoint")


def test_tp_slice_runs_with_jax_zmq_and_ml_dtypes_blocked():
    """The card machine's case for tensor parallelism under the proposers,
    the tier and the stages: their modules import, the runtime's lazy
    exports and the host ``KVCacheManager`` resolve, and over a tp=2 CPU
    mesh a speculative engine, a batching engine with prompt lookup and
    the tier, and a stage run, with jax, the JAX package, zmq and
    ml_dtypes blocked in rank 0; the follower loads none of them."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu',\n"
        "          'zmq', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, numpy as np, torch\n"
        f"for n in {TP_SLICE_MODULES!r}:\n"
        "    importlib.import_module('distributed_inference_demo_tpu_torch.'"
        " + n)\n"
        "from distributed_inference_demo_tpu_torch import runtime as R\n"
        "from distributed_inference_demo_tpu_torch.models import "
        "get_model_config\n"
        "from distributed_inference_demo_tpu_torch.models.base import "
        "split_layer_ranges\n"
        "from distributed_inference_demo_tpu_torch.models.decoder import "
        "init_full_params\n"
        "from distributed_inference_demo_tpu_torch.ops.sampling import "
        "SamplingParams\n"
        "from distributed_inference_demo_tpu_torch.parallel import mesh as M"
        "\n"
        "if __name__ == '__main__':\n"
        "    cfg = get_model_config('llama-test')\n"
        "    p = init_full_params(torch.Generator().manual_seed(0), cfg, "
        "'cpu')\n"
        "    g = SamplingParams(greedy=True)\n"
        "    kv = R.KVCacheManager(2, 2, 4, 8, 4, torch.bfloat16)\n"
        "    kv.store(np.arange(9), torch.zeros(2, 1, 2, 16, 4), "
        "torch.zeros(2, 1, 2, 16, 4))\n"
        "    assert kv.match(np.arange(9)).tokens == 8\n"
        "    with M.local_tp_mesh(2, 'cpu', 60) as mesh:\n"
        "        R.SpeculativeEngine(cfg, p, cfg, p, max_seq=32, sampling=g,"
        " device='cpu', mesh=mesh).generate([[1, 2, 3, 4]], 3)\n"
        "        with R.ContinuousBatchingEngine(cfg, p, max_seq=32, "
        "sampling=g, device='cpu', mesh=mesh, prompt_lookup=True, "
        "kv_block_tokens=4, kv_host_tier_bytes=1 << 20) as e:\n"
        "            e.generate(np.asarray([[1, 2, 3, 4, 1, 2]]), 3)\n"
        "        s = split_layer_ranges(cfg.num_layers, 2)[0]\n"
        "        rt = R.ElasticStageRuntime(cfg, s, p, 32, device='cpu', "
        "mesh=mesh)\n"
        "        rt.run_chunk(1, np.asarray([[1, 2, 3]]))\n"
        "        rt.free_tp()\n"
        "        mods = M.loaded_modules(mesh)\n"
        "    bad = sorted({n for ms in mods for n in ms\n"
        "                  if n.split('.')[0] in ('jax', 'jaxlib', 'zmq',\n"
        "                  'ml_dtypes', 'distributed_inference_demo_tpu')})\n"
        "    print('BAD', bad, len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("BAD")]
    assert line == ["BAD [] 2"], res.stdout
