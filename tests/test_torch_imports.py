"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package, and so does ``chip_smoke.py``, which drives it on the card
(a machine without JAX)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "theanompi_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "theanompi_tpu"}
# every module of the port, by slice; each must import with jax blocked
EXPECTED_MODULES = {
    # slice 1: serving
    "cuda_build", "device", "convert", "ops.layers", "ops.attention",
    "ops.paged_attention", "models.transformer", "serving",
    "serving.engine", "serving.paging", "serving.scheduler",
    # slice 2: AlexNet-128 BSP training
    "ops.lrn", "ops.pool", "ops.losses", "ops.optim", "ops.augment",
    "data.providers", "data.loader", "runtime.config", "runtime.dist",
    "runtime.recorder", "parallel.bucketing", "parallel.exchanger",
    "parallel.workers", "parallel.rules", "models.base",
    "models.alex_net", "presets", "utils.benchmark",
}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'theanompi_tpu'):\n"
        "    sys.modules[name] = None  # any import of them now raises\n"
        "import importlib, pkgutil\n"
        "import theanompi_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    theanompi_tpu_torch.__path__, 'theanompi_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from theanompi_tpu_torch import BSP\n"
        "print(' '.join(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    walked = {m[len("theanompi_tpu_torch."):]
              for m in proc.stdout.split()}
    assert EXPECTED_MODULES <= walked, EXPECTED_MODULES - walked


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_jax_or_reference_import(path):
    """Compare the first component of every imported dotted name for
    equality: ``theanompi_tpu_torch`` starts with ``theanompi_tpu`` but
    is the port itself."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert bad == []
