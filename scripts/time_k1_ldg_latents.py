#!/usr/bin/env python3
"""Time K1's first design reading the latents itself, against K1, on one CUDA card.

    python3 scripts/time_k1_ldg_latents.py                  # B = 1 ... 4096
    python3 scripts/time_k1_ldg_latents.py --batches 512,4096

K1 (``ops/cuda/render.cu``) loads each window with the TMA and stores each
frame with a bulk copy, one launch per render straight from the (B, 6)
int64 latents. Its first design loads with scalar ``__ldg`` and stores
float4s, but from an int32 sprite index and offsets that earlier launches
computed. This script builds a candidate of its own (the source below): the
first design's body with K1's index math and clamps in front of it, so
that it too renders in one launch from the latents. At each batch it holds
the candidate bit for bit to K1's plain version (and on latents off the
grid), then times K1, the first design's kernel alone, the candidate and a
same-bytes ``copy_`` in turns, as ``chip_smoke.py`` phase 2 times K1 (clean
L2, no events around any call). Prints one line per batch.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRes = 64, kCanvas = 96, kSprites = 720, kMaxOffset = 32, kLatents = 6;
constexpr int kQuadsPerRow = kRes / 4, kThreads = 256;
constexpr int kRowsPerPass = kThreads / kQuadsPerRow, kPasses = kRes / kRowsPerPass;

__device__ __forceinline__ int xla_start(long long start, long long size, long long limit) {
  if (start < 0) start += size;
  return static_cast<int>(start < 0 ? 0 : (start > limit ? limit : start));
}

__global__ void __launch_bounds__(kThreads)
render_frames_ldg_latents(const float* __restrict__ lut, const long long* __restrict__ latents,
                          const float* __restrict__ last_r, float4* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const long long* l = latents + b * kLatents;
  const int s = xla_start(__ldg(l + 1) * 240 + __ldg(l + 2) * 40 + __ldg(l + 3), kSprites,
                          kSprites - 1);
  const int row0 = xla_start(kMaxOffset - __ldg(l + 5), kCanvas, kMaxOffset);
  const int col0 = xla_start(kMaxOffset - __ldg(l + 4), kCanvas, kMaxOffset);
  const float r = __ldg(last_r + b);
  const int i0 = threadIdx.x / kQuadsPerRow;
  const int j = (threadIdx.x % kQuadsPerRow) * 4;
  const float* src = lut + (static_cast<int64_t>(s) * kCanvas + row0 + i0) * kCanvas + col0 + j;
  float4 v[kPasses];
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const float* p = src + k * kRowsPerPass * kCanvas;
    v[k] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  if (i0 < 3) {
    if (j < kRes / 2) {
      if (r >= 0.0f) v[0] = make_float4(r, r, r, r);
    } else if (r < 0.0f) {
      v[0] = make_float4(-r, -r, -r, -r);
    }
  }
  float4* dst = out + b * (kRes * kQuadsPerRow) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPasses; ++k) dst[k * kThreads] = v[k];
}

}  // namespace

extern "C" int render_ldg_latents(const float* lut, const long long* latents,
                                  const float* last_r, float* out, int64_t batch, void* stream) {
  render_frames_ldg_latents<<<static_cast<unsigned int>(batch), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      lut, latents, last_r, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def load_candidate():
    """The candidate's entry point, compiled with the port's nvcc flags into
    the port's build directory (ignored by git)."""
    from deep_active_inference_mc_torch.ops.cuda import build

    digest = hashlib.sha256((SOURCE + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"ldg_latents_{digest}.cu"
    lib = src.with_suffix(".so")
    if not lib.exists():
        src.write_text(SOURCE)
        done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        print(done.stdout + done.stderr, flush=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc exited {done.returncode}")
    fn = ctypes.CDLL(str(lib)).render_ldg_latents
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="1,256,512,1024,2048,4096")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as smoke

    smoke.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from deep_active_inference_mc_torch.envs import dsprites as env_lib
    from deep_active_inference_mc_torch.envs import raster
    from deep_active_inference_mc_torch.ops.cuda import render as k_render

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    fn = load_candidate()
    lut = raster.build_sprite_lut(dev)
    l2 = torch.zeros(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    bw = smoke.hbm_bytes_per_s(torch.cuda.get_device_name(0))
    print(f"[ldg_latents] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    def candidate(latents, last_r):
        def run():
            out = torch.empty((latents.shape[0], 1, raster.RES, raster.RES), device=dev)
            err = fn(lut.data_ptr(), latents.data_ptr(), last_r.data_ptr(), out.data_ptr(),
                     latents.shape[0], torch.cuda.current_stream().cuda_stream)
            smoke.check(err == 0, f"candidate: launch failed, cudaError_t {err}")
            return out
        return run

    for B in (int(b) for b in args.batches.split(",")):
        off = env_lib.sample_latents(gen, B, dev)
        off[:, 1:] += torch.randint(-200, 200, (B, 5), generator=gen, device=dev)
        off_r = torch.rand((B,), generator=gen, device=dev) * 2 - 1
        smoke.check(torch.equal(candidate(off, off_r)(),
                                k_render.render_frames_plain(lut, off, off_r)),
                    f"B={B}: the candidate differs from the plain version off the grid")
        latents = env_lib.sample_latents(gen, B, dev)
        last_r = torch.rand((B,), generator=gen, device=dev) * 2 - 1
        want = k_render.render_frames_plain(lut, latents, last_r)
        ldg = candidate(latents, last_r)
        first, _ = smoke.first_design(torch, lut, latents, last_r)
        for name, run in (("candidate", ldg), ("first design", first)):
            smoke.check(torch.equal(run(), want), f"B={B}: {name} differs from the plain version")
        kernel = lambda: k_render.render_frames_cuda(lut, latents, last_r)
        smoke.check(torch.equal(kernel(), want), f"B={B}: K1 differs from the plain version")
        copy_dst = torch.empty_like(want)
        smoke.warm_up_clocks(torch, dev)
        t = smoke.time_clean_l2_ms(torch, {"K1 (TMA)": kernel, "first design": first,
                                           "ldg from latents": ldg,
                                           "copy_": lambda: copy_dst.copy_(want)}, l2.sum)
        bound_ms = smoke.render_bound_bytes(torch, lut, latents) / bw * 1e3
        spread = ", ".join(f"{k} {q[1]:.5f} ({q[0]:.5f}-{q[2]:.5f}, {bound_ms / q[1]:.1%})"
                           for k, q in t.items())
        print(f"[ldg_latents] B={B}: bit for bit; clean L2, no events, ms per call median "
              f"(min-max of {2 * smoke.CLEAN_L2_ROUNDS} runs of {smoke.TIMING_REPS}, share of "
              f"bound {bound_ms:.5f}): {spread} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
