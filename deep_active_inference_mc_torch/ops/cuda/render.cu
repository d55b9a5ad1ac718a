// K1: fused dSprites frame render, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// deep_active_inference_mc_tpu/ops/pallas/render.py:50 (launched by
// `_pallas_render`; `_render_frames_impl` computes the sprite index and the
// window offsets inside the same jit). For each env it takes the 64x64 window
// at (32 - posY, 32 - posX) of LUT sprite shape*240 + scale*40 + orient and
// paints the 3-row reward strip: the left half takes r if r >= 0, the right
// half takes -r if r < 0.
//
// Bound on this card: bytes. Per env it reads at most one 16 KB window of the
// (720, 96, 96) float32 LUT (windows of one sprite overlap), 40 B of latents
// and 4 B of reward, and writes one 16 KB frame: about 32 KB * B over the
// HBM's 3.35 TB/s, 4.5 us at B = 512. There is no arithmetic to speak of.
// Below a few hundred envs the launch's own fixed cost (~2.5 us back to back)
// exceeds that bound, and no design can reach it there. Measured with a clean
// L2, the frames' write-back counts too: on an H100 80GB HBM3 at 700 W a
// same-bytes copy_ of the frames reaches 41 % of this bound at B = 512 and
// 50 % at 4096 (PERF.md).
//
// Design: one launch per render, straight from the (B, 6) int64 latents, one
// 256-thread block per env (grid = B).
// - Thread 0 reads the env's latents and computes its sprite index and
//   window offsets, clamped as XLA's gather and dynamic_slice clamp them (a
//   negative start counts once from the end of its axis, then the start is
//   clamped into range).
// - Load: thread 0 has the Tensor Memory Accelerator copy the window into
//   shared memory through a 3-D tiled tensor map over the LUT (dims 96, 96,
//   720 innermost first, no swizzle), and the copy completes on an mbarrier
//   (expect_tx), so no thread spends registers or instructions on global
//   loads. The TMA refuses a start column that is not 16-byte aligned (an
//   illegal instruction on the card), and a window's column is arbitrary, so
//   the box is the window's aligned cover: 68 x 64 x 1 (17 KB) at column
//   c0 & ~3.
// - Shift and paint: after the barrier, every thread moves 4 float4s of the
//   window, c0 & 3 floats into each 68-float row, into a 64x64 frame buffer
//   in shared memory, painting the strip (3 rows x 32 floats) as it goes,
//   then fences its generic-proxy writes for the async proxy. One block
//   barrier follows.
// - Store: thread 0 writes the whole frame with one 1-D bulk copy
//   (cp.async.bulk.global.shared::cta): a frame is 16 KB, contiguous and
//   16-byte aligned, so the store needs no tensor map.
// - A persistent grid above one wave, each block walking its envs through a
//   ring of TMA stages, was measured at 512-4096 envs and gained 0-2 %,
//   within the spread of its timings (PERF.md), so it was not kept.
// - The tensor map is encoded on the host (cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint, so nothing links libcuda), cached per
//   (device, LUT address), and passed as a __grid_constant__ parameter.
//
// The first design (one 256-thread block per env, 16 scalar unaligned __ldg
// loads before 4 float4 stores per thread, from int32 index and offsets
// computed by separate launches) stays below under its own entry point,
// `daimc_render_frames_first_design`, as the yardstick that chip_smoke.py
// times in turns with this one. No path of the port launches it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kRes = 64;
constexpr int kCanvas = 96;
constexpr int kShapes = 3;
constexpr int kScales = 6;
constexpr int kOrients = 40;
constexpr int kSprites = kShapes * kScales * kOrients;  // 720
constexpr int kMaxOffset = kCanvas - kRes;              // 32
constexpr int kLatents = 6;  // color, shape, scale, orientation, posX, posY
constexpr int kFrameFloats = kRes * kRes;
constexpr uint32_t kFrameBytes = kFrameFloats * sizeof(float);  // 16384

// ---- the TMA design ---------------------------------------------------------

constexpr int kThreads = 256;        // 8 warps
constexpr int kBoxCols = kRes + 4;   // 68: the 16-byte-aligned cover of a window row
constexpr int kBoxQuads = kBoxCols / 4;  // 17 float4s per loaded row
constexpr int kRowQuads = kRes / 4;      // 16 float4s per frame row
constexpr uint32_t kBoxBytes = kRes * kBoxCols * sizeof(float);  // 17408
constexpr int kFrameQuads = kFrameFloats / 4;
constexpr int kQuadsPerThread = kFrameQuads / kThreads;  // 4
constexpr int kBlocksPerSm = 6;  // 6 x 256 threads at <= 40 registers, 33 KB each
constexpr int kMaxDevices = 64;

struct Env {
  int col;     // window column, 0-32
  int row;     // window row, 0-32
  int sprite;  // LUT row, 0-719
  float r;     // last reward
};

constexpr size_t kSmemBytes = kBoxBytes + kFrameBytes + sizeof(Env) + sizeof(uint64_t);

__device__ __forceinline__ int xla_start(int64_t start, int64_t size, int64_t limit) {
  if (start < 0) start += size;
  return static_cast<int>(start < 0 ? 0 : (start > limit ? limit : start));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// The 68x64 box at (col, row) of sprite `sprite` into `dst`, completing on
// `bar`. `col` must be a multiple of 4: the TMA refuses a start that is not
// 16-byte aligned in the innermost dimension.
__device__ __forceinline__ void tma_load_box(float4* dst, const CUtensorMap* map, int col,
                                             int row, int sprite, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
        "r"(sprite), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store_frame(float* dst, const float4* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(src)), "r"(kFrameBytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Frame quad q (row q / 16, columns 4(q % 16)...) of a window that starts
// `shift` floats into its loaded box, with the reward strip painted.
__device__ __forceinline__ float4 frame_quad(const float4* box, int q, int shift, float r) {
  const int row = q / kRowQuads, k = q % kRowQuads;
  if (row < 3) {  // the strip; a quad lies in one half
    if (k < kRowQuads / 2) {
      if (r >= 0.0f) return make_float4(r, r, r, r);
    } else if (r < 0.0f) {  // NaN paints neither half
      return make_float4(-r, -r, -r, -r);
    }
  }
  const float4 a = box[row * kBoxQuads + k];
  if (shift == 0) return a;
  const float4 b = box[row * kBoxQuads + k + 1];
  if (shift == 1) return make_float4(a.y, a.z, a.w, b.x);
  if (shift == 2) return make_float4(a.z, a.w, b.x, b.y);
  return make_float4(a.w, b.x, b.y, b.z);
}

// One env per block: env blockIdx.x's frame into out[blockIdx.x].
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
render_frames_tma(const __grid_constant__ CUtensorMap lut_map,
                  const int64_t* __restrict__ latents, const float* __restrict__ last_r,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  float4* frame = box + kBoxBytes / 16;
  Env* env = reinterpret_cast<Env*>(frame + kFrameQuads);
  uint64_t* full = reinterpret_cast<uint64_t*>(env + 1);
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;

  if (t == 0) {  // the descriptor's fetch overlaps the latents' loads
    asm volatile("prefetch.tensormap [%0];"
                 ::"l"(reinterpret_cast<uint64_t>(&lut_map)) : "memory");
    mbar_init(full);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const long long* l = reinterpret_cast<const long long*>(latents) + b * kLatents;
    const Env e{xla_start(kMaxOffset - __ldg(l + 4), kCanvas, kMaxOffset),
                xla_start(kMaxOffset - __ldg(l + 5), kCanvas, kMaxOffset),
                xla_start(__ldg(l + 1) * (kScales * kOrients) + __ldg(l + 2) * kOrients +
                              __ldg(l + 3), kSprites, kSprites - 1),
                __ldg(last_r + b)};
    *env = e;
    mbar_expect_tx(full, kBoxBytes);
    tma_load_box(box, &lut_map, e.col & ~3, e.row, e.sprite, full);
  }
  __syncthreads();  // the barrier is initialised and the env written
  const Env e = *env;
  mbar_wait(full, 0);
#pragma unroll
  for (int m = 0; m < kQuadsPerThread; ++m) {
    const int q = t + m * kThreads;
    frame[q] = frame_quad(box, q, e.col & 3, e.r);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();  // the frame is written and fenced
  if (t == 0) {
    bulk_store_frame(out + b * kFrameFloats, frame);
    // Shared memory must outlive the store's read of it.
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Every LUT has the same shape and strides, so a map stays valid for any LUT
// at its address: a few (device, address) entries, replaced in turn.
struct MapEntry {
  int device;
  const float* lut;
  CUtensorMap map;
};
constexpr int kMapCache = 8;
MapEntry g_maps[kMapCache];
int g_maps_used = 0, g_maps_next = 0;
bool g_configured[kMaxDevices] = {};
std::mutex g_mutex;

// The LUT's tensor map on `device` into `map`; CUDA_SUCCESS or the encoder's error.
CUresult lut_map(int device, const float* lut, CUtensorMap* map) {
  for (int i = 0; i < g_maps_used; ++i) {
    if (g_maps[i].device == device && g_maps[i].lut == lut) {
      *map = g_maps[i].map;
      return CUDA_SUCCESS;
    }
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {kCanvas, kCanvas, kSprites};
  const cuuint64_t strides[2] = {kCanvas * sizeof(float), kCanvas * kCanvas * sizeof(float)};
  const cuuint32_t box[3] = {kBoxCols, kRes, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(lut),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return res;
  g_maps[g_maps_next] = MapEntry{device, lut, *map};
  g_maps_next = (g_maps_next + 1) % kMapCache;
  if (g_maps_used < kMapCache) ++g_maps_used;
  return CUDA_SUCCESS;
}

// ---- the first design -------------------------------------------------------

constexpr int kQuadsPerRow = kRes / 4;  // 16
constexpr int kLdgThreads = 256;
constexpr int kRowsPerPass = kLdgThreads / kQuadsPerRow;  // 16
constexpr int kPasses = kRes / kRowsPerPass;           // 4

__global__ void __launch_bounds__(kLdgThreads)
render_frames_ldg(const float* __restrict__ lut, const int32_t* __restrict__ idx,
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
  for (int k = 0; k < kPasses; ++k) dst[k * kLdgThreads] = v[k];
}

}  // namespace

// Launches K1 on `stream`: `batch` frames into `out` from the (batch, 6)
// int64 `latents` and the (batch,) float32 `last_r`, one block per env. All
// pointers are device pointers of the current device; `lut` and `out` are
// 16-byte aligned. Returns 0, a cudaError_t of the launch (> 0), or minus the
// CUresult of a failed tensor-map encode (< 0).
extern "C" int daimc_render_frames(const float* lut, const int64_t* latents, const float* last_r,
                                   float* out, int64_t batch, void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (batch < 0 || batch > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(lut) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(g_mutex);
  CUtensorMap map;
  const CUresult res = lut_map(device, lut, &map);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  if (!g_configured[device]) {  // six blocks' shared memory on an SM
    err = cudaFuncSetAttribute(render_frames_tma, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_configured[device] = true;
  }
  render_frames_tma<<<static_cast<unsigned int>(batch), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(map, latents, last_r, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the first design on `stream` and returns the launch's cudaError_t
// (0 = ok): int32 sprite index and window offsets already in range (it clamps
// them into range, but does not count a negative start from the end as XLA
// does). `out` holds batch*64*64 floats and is 16-byte aligned.
extern "C" int daimc_render_frames_first_design(const float* lut, const int32_t* idx,
                                                const int32_t* r0, const int32_t* c0,
                                                const float* last_r, float* out, int64_t batch,
                                                void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (batch < 0 || batch > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % alignof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  render_frames_ldg<<<static_cast<unsigned int>(batch), kLdgThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      lut, idx, r0, c0, last_r, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
