"""PyTorch port: the tooling modules, ``utils/compcache.py`` (where the CUDA
kernels' build cache lives; tests/test_compcache.py is the JAX
counterpart) and ``utils/profiling.py`` (the trainer's ``--profile_dir``
trace)."""

import json

import pytest
import torch

from deep_active_inference_mc_torch.ops.cuda import build
from deep_active_inference_mc_torch.parallel import mesh as mesh_lib
from deep_active_inference_mc_torch.utils import compcache, profiling


@pytest.fixture
def build_dir():
    """Restore the kernel cache's location after a test moves it."""
    before = build.BUILD_DIR
    yield
    build.BUILD_DIR = before


def test_enable_persistent_cache_points_the_kernel_build_there(tmp_path, build_dir,
                                                               monkeypatch):
    monkeypatch.delenv("DAIF_COMP_CACHE", raising=False)
    default = build.BUILD_DIR
    assert compcache.enable_persistent_cache() == str(default)  # unchanged
    d = str(tmp_path / "kernels")
    assert compcache.enable_persistent_cache(d) == d and build.BUILD_DIR == tmp_path / "kernels"
    assert compcache.enable_persistent_cache(d) == d  # idempotent
    assert build.library_path("render").parent == tmp_path / "kernels"
    monkeypatch.setenv("DAIF_COMP_CACHE", str(tmp_path / "from_env"))
    assert compcache.enable_persistent_cache() == str(tmp_path / "from_env")
    assert (tmp_path / "from_env").is_dir()


def test_enable_persistent_cache_unwritable_keeps_the_default(tmp_path, build_dir):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    before = build.BUILD_DIR
    # A path under a file cannot be created: the cache stays where it was.
    assert compcache.enable_persistent_cache(str(blocker / "sub")) == ""
    assert build.BUILD_DIR == before


def test_build_kernels_is_a_no_op_on_the_cpu():
    mesh = mesh_lib.Mesh(rank=0, world=1, n_model=1, device=torch.device("cpu"),
                         backend="gloo")
    compcache.build_kernels(mesh)  # no nvcc, no barrier, no raise


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "epoch_trace.json").read_text())
    assert any("aten::mm" in e.get("name", "") for e in trace["traceEvents"])
    with profiling.trace(None):  # a no-op
        pass
