"""PyTorch port boundaries: no module of the port, and not chip_smoke.py,
imports JAX, Flax, Optax or the JAX package; the whole port imports with
those blocked, and also with the plotting and image libraries blocked,
which the card's machine does not have (the figures import them where
they draw)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "deep_active_inference_mc_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deep_active_inference_mc_tpu")
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def import_all_with(blocked):
    """Import every module of the port in a fresh interpreter with
    ``blocked`` unimportable; returns the number of modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import deep_active_inference_mc_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return int(res.stdout.strip())


def test_package_imports_with_jax_blocked():
    assert import_all_with(FORBIDDEN) >= 20


def test_package_imports_without_plotting_libraries():
    n = import_all_with(FORBIDDEN + ("matplotlib", "PIL", "sklearn", "seaborn"))
    assert n >= 35  # every app included: distill, demo, train_causal, viz


def test_parallel_and_tool_modules_import_with_jax_blocked():
    """The modules of the multi-device slice by name: the mesh, its
    collectives, the profiler and the kernel cache."""
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "from deep_active_inference_mc_torch.parallel import comm, mesh\n"
        "from deep_active_inference_mc_torch.utils import compcache, profiling\n"
        "print(mesh.tp_spec('mid.fc.0.weight', (512, 14), 2))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "0", res.stderr
