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
