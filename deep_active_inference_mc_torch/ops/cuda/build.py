"""Build and load the port's hand-written CUDA kernels.

Each ``<name>.cu`` beside this file exposes a plain ``extern "C"`` entry
point. It is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/`` (ignored by git), named by the hash of its source and
flags, at first use, and loaded with ``ctypes``. No PyTorch headers and no
``ninja`` are involved, so a build takes seconds. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from deep_active_inference_mc_torch.ops.cuda import KERNELS
from deep_active_inference_mc_torch.utils import profiling

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR / "_build"
NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    source = (SOURCE_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns per name the build seconds
    (0 if it was already built) and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in dict.fromkeys(names):
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in dict.fromkeys(names)}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


@profiling.spanned("k1.load")
def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built first if needed together with
    every other missing kernel, so that a checkout's first run waits for the
    longest build and not for their sum. A span: ``k1.load``, the name it
    took when K1 was the one kernel."""
    build([name, *KERNELS])
    return ctypes.CDLL(str(library_path(name)))
