// K1: fused dSprites frame render, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// deep_active_inference_mc_tpu/ops/pallas/render.py (launched by
// `_pallas_render`, wrapped by `render_frames`). For each env b it copies
// the 64x64 window at (r0[b], c0[b]) of LUT sprite idx[b] and paints the
// 3-row reward strip: the left half takes r if r >= 0, the right half takes
// -r if r < 0.
//
// Bound: pure data movement. Per env it reads at most one 64x64 window of
// the LUT (16 KB; windows of one sprite overlap) and writes one 64x64 frame
// (16 KB), so the floor is about 32 KB * B over the card's HBM bandwidth;
// there is no arithmetic to speak of. The TPU kernel DMA'd 64x128
// lane-padded windows of 32 envs into VMEM and rotated lanes to cut the
// 64-column window; none of that carries over.
// Design: one block of 256 threads per env. Thread t owns the 4-pixel quad
// at column 4*(t%16) of rows t/16, t/16+16, t/16+32 and t/16+48: it issues
// its 16 LUT loads before its 4 stores, so each thread keeps 4 rows of
// reads in flight, and each store is one aligned 16-byte float4 (a frame
// row is 256 B; 16 consecutive threads write one row). The window column
// is arbitrary, so the LUT loads are scalar and unaligned, but a warp's
// loads still fall in 2-3 consecutive 128-byte lines of each LUT row. The
// unpadded (720, 96, 96) LUT (26.5 MB) fits in the 50 MB L2. Any B works.
// The sprite index and window offsets are clamped into range, as the JAX
// gather and dynamic_slice clamp them, so no input reads outside the LUT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRes = 64;
constexpr int kCanvas = 96;
constexpr int kSprites = 720;
constexpr int kMaxOffset = kCanvas - kRes;  // 32
constexpr int kQuadsPerRow = kRes / 4;      // 16
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kQuadsPerRow;  // 16
constexpr int kPasses = kRes / kRowsPerPass;           // 4

__global__ void __launch_bounds__(kThreads)
render_frames_kernel(const float* __restrict__ lut, const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ r0, const int32_t* __restrict__ c0,
                     const float* __restrict__ last_r, float4* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int s = min(max(__ldg(idx + b), 0), kSprites - 1);
  const int row0 = min(max(__ldg(r0 + b), 0), kMaxOffset);
  const int col0 = min(max(__ldg(c0 + b), 0), kMaxOffset);
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
  if (i0 < 3) {  // the strip is in the first pass; a quad lies in one half
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

// Launches K1 on `stream` and returns the launch's cudaError_t (0 = ok).
// All pointers are device pointers; `out` holds B*64*64 floats and is
// 16-byte aligned.
extern "C" int daimc_render_frames(const float* lut, const int32_t* idx,
                                   const int32_t* r0, const int32_t* c0,
                                   const float* last_r, float* out,
                                   int64_t batch, void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (batch > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % alignof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  render_frames_kernel<<<static_cast<unsigned int>(batch), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lut, idx, r0, c0, last_r, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
