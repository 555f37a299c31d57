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
    """The card machine has neither ``zmq`` nor ``ml_dtypes``: every
    module of the port (and ``chip_smoke.py``) imports with both blocked,
    as with jax blocked; in the sources ``zmq`` is imported only inside
    the function ``ZmqTransport`` calls, and ``ml_dtypes`` nowhere."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    top = [f"{f.relative_to(REPO)}:{node.lineno}"
           for f in files
           for node in ast.parse(f.read_text()).body
           if isinstance(node, (ast.Import, ast.ImportFrom))
           and any(n.split(".")[0] in ("zmq", "ml_dtypes")
                   for n in ([a.name for a in node.names]
                             if isinstance(node, ast.Import)
                             else [node.module or ""]))]
    assert not top, top
    assert not [f for f in files for _, name in _imports(f)
                if name.split(".")[0] == "ml_dtypes"]
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'distributed_inference_demo_tpu',\n"
        "          'zmq', 'ml_dtypes'):\n"
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
