// The decoder's four SAME transposed convolutions, hand-written for Hopper
// (sm_90a): one launch per layer, NHWC from the dense layer's output to the
// frame, with bias, ReLU, the SAME crop and the last layer's sigmoid fused.
//
// It replaces no TPU kernel: the JAX package leaves these convolutions to
// XLA (deep_active_inference_mc_tpu/models/networks.py, Decoder's
// nn.ConvTranspose layers). The port ran them through cuDNN's TF32 dgrad
// kernels on NCHW tensors, with layout passes around every call, a separate
// bias add, the stride-2 layers' SAME crop as a strided view and a ReLU over
// it, so that more than half of the G estimator's device time moved bytes
// (PERF.md).
//
// Bound on this card: bytes. Per decoded row (resolution 64, one channel)
// the four layers do 77.9 MFLOP and, with every intermediate in device
// memory, move 1.74 MB: at 4096 rows 0.64 ms of TF32 tensor-core time
// against 2.1 ms at 3.35 TB/s. The third layer's output (512 KB a row) is
// most of those bytes.
//
// Design:
// - Layers with Cin 64 (the first three) are implicit GEMMs on TF32 tensor
//   cores, mma.sync m16n8k8 with FP32 accumulation, operands fed by
//   ldmatrix: M = rows x output pixels, N = Cout, K = taps x Cin.
// - A stride-2 layer runs by sub-pixel phase. With PyTorch's weight
//   w[ci, co, ky, kx], out[2i] = in[i] w[0] + in[i-1] w[2] and
//   out[2i+1] = in[i] w[1] along each axis, so the four output phases sum
//   4, 2, 2 and 1 taps: no multiply is by an inserted zero, and the row and
//   column that SAME crops are never computed. The phase table is
//   deconv.py's (TAPS_1D), passed as a kernel parameter.
// - A persistent grid, one block per SM. The layer's weights, all nine
//   taps, rounded to TF32, stay in shared memory (156.7 KB for 64 -> 64);
//   input tiles (TY rows and their halo, every column, NHWC) stream through
//   a double buffer by cp.async, zero-filled outside the image. Eight warps
//   share a tile, each 32 output channels of one or two 16-pixel fragments:
//   a stride-1 layer's warps one fragment, a stride-2 layer's two (their B
//   fragments serve both), half of them over the phases of 4 and 1 taps,
//   half over those of 2 and 2.
// - Epilogue: bias, ReLU, rounding to TF32 (what the next layer's tensor
//   cores read), NHWC stores of 32-byte runs.
// - The first layer applies the dense layer's ReLU and the TF32 rounding as
//   it loads its tiles.
// - The last layer (Cin 32 -> 1 or 3 channels) has no tensor-core work: FP32
//   FMAs over the same tile stream, four pixels a thread, bias and sigmoid,
//   the (B, C, res, res) frame written by float4s.
// - Deterministic and row-independent: every output is summed by one thread
//   in a fixed order; no atomics, no split-K.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int kMaxPhases = 4;
constexpr int kTaps = 9;  // every phase table covers the 3x3 kernel once
constexpr int kMaxDevices = 64;

// A layer's sub-pixel phases: phase p writes output pixels
// (stride * y + py[p], stride * x + px[p]) and sums taps
// [begin[p], begin[p + 1]); tap t reads input pixel (y + dy[t], x + dx[t])
// through the weight slice w[:, :, ky[t], kx[t]]. The layout is deconv.py's
// packed table, int32 throughout.
struct Taps {
  int n_phases;
  int py[kMaxPhases], px[kMaxPhases];
  int begin[kMaxPhases + 1];
  int dy[kTaps], dx[kTaps], ky[kTaps], kx[kTaps];
};
static_assert(sizeof(Taps) == 50 * sizeof(int), "Taps must match deconv.py's packed table");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` into shared memory, or 16 zero bytes if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float tf32(float x) {  // round to nearest, ties away
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile `tile` of a (batch, W, W, CIN) NHWC input: rows y0 - 1 ... y0 - 1 + IR
// and columns -1 ... IC - 2, where tile = b * (W / TY) + y0 / TY. Pixel
// (r, c) goes to buf[r * ROW + c * PIX], CIN floats; outside the image, zeros.
template <int CIN, int W, int TY, int IR, int IC, int ROW, int PIX, int THREADS>
__device__ __forceinline__ void load_tile(const float* __restrict__ in, int64_t tile,
                                          float* buf) {
  constexpr int kChunks = CIN / 4;
  const int64_t b = tile / (W / TY);
  const int y0 = static_cast<int>(tile % (W / TY)) * TY;
  const float* src_b = in + b * W * W * CIN;
  for (int i = threadIdx.x; i < IR * IC * kChunks; i += THREADS) {
    const int q = i % kChunks, pix = i / kChunks;
    const int r = pix / IC, c = pix % IC;
    const int y = y0 - 1 + r, x = c - 1;
    const bool ok = static_cast<unsigned>(y) < static_cast<unsigned>(W) &&
                    static_cast<unsigned>(x) < static_cast<unsigned>(W);
    const float* src = ok ? src_b + (static_cast<int64_t>(y) * W + x) * CIN + q * 4 : in;
    cp_async16(smem_addr(buf + r * ROW + c * PIX + q * 4), src, ok);
  }
}

// ---- layers with Cin 64: TF32 tensor cores ----------------------------------

template <int CIN, int COUT, int STRIDE, int W, int TY>
struct Mma {
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPix = CIN + 4;  // floats per pixel: ldmatrix rows hit 8 bank groups
  static constexpr int kHaloHi = STRIDE == 1 ? 1 : 0;  // a stride-2 tap looks back only
  static constexpr int kIR = TY + 1 + kHaloHi;
  static constexpr int kIC = W + 1 + kHaloHi;
  static constexpr int kRow = kIC * kPix;
  static constexpr int kTileFloats = kIR * kRow;
  static constexpr int kWeightFloats = kTaps * COUT * kPix;  // [tap][co][ci]
  static constexpr int kSmem = (kWeightFloats + 2 * kTileFloats) * 4;
  static constexpr int kNGroups = COUT / 32;  // warps across Cout, 32 channels each
  static constexpr int kMFrags = TY * W / 16;  // 16-pixel fragments of a phase's tile
  // A stride-2 layer's warps take two fragments each, and half of them the
  // phases of 4 and 1 taps, the other half those of 2 and 2; a stride-1
  // layer's take one fragment each of its one phase.
  static constexpr int kGroups = STRIDE == 2 ? 2 : 1;
  static constexpr int kMPerWarp = STRIDE == 2 ? 2 : 1;
  static constexpr int kWarpsPerGroup = kWarps / kGroups;
  static constexpr int kWo = STRIDE * W;
  static_assert(CIN % 8 == 0 && COUT % 32 == 0 && W % 16 == 0 && W % TY == 0, "shape");
  static_assert(kMFrags * kNGroups == kWarpsPerGroup * kMPerWarp, "every fragment one warp's");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int CIN, int COUT, int STRIDE, int W, int TY, bool RELU_IN>
__global__ void __launch_bounds__(256, 1)
deconv_mma(const float* __restrict__ in, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ out, int64_t n_tiles,
           const __grid_constant__ Taps taps) {
  using L = Mma<CIN, COUT, STRIDE, W, TY>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int tap_of[kTaps];
  float* ws = smem;
  float* tiles = smem + L::kWeightFloats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < kTaps) tap_of[taps.ky[tid] * 3 + taps.kx[tid]] = tid;
  const int64_t first = blockIdx.x;
  load_tile<CIN, W, TY, L::kIR, L::kIC, L::kRow, L::kPix, L::kThreads>(in, first, tiles);
  cp_async_commit();
  __syncthreads();  // tap_of
  // The weights, w[ci][co][ky][kx] read in order, into ws[tap][co][ci] as TF32.
  for (int i = tid; i < CIN * COUT * kTaps; i += L::kThreads) {
    const int k = i % kTaps, co = (i / kTaps) % COUT, ci = i / (kTaps * COUT);
    ws[(tap_of[k] * COUT + co) * L::kPix + ci] = tf32(__ldg(w + i));
  }

  constexpr int M = L::kMPerWarp;
  const int group = warp / L::kWarpsPerGroup, wg = warp % L::kWarpsPerGroup;
  const int ng = wg % L::kNGroups, mf0 = (wg / L::kNGroups) * M;
  int ty[M], x0[M];  // the warp's fragments: phase row in the tile, first column
#pragma unroll
  for (int m = 0; m < M; ++m) {
    ty[m] = (mf0 + m) / (W / 16);
    x0[m] = ((mf0 + m) % (W / 16)) * 16;
  }
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix rows. A: pixel x0 + (lane & 15), channels +4 for lanes 16-31.
  // B: output channel (lane >> 4) * 8 + (lane & 7), channels +4 for lanes 8-15, 24-31.
  const int a_k = (lane >> 4) * 4;
  const int b_co = ng * 32 + (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 4;
  float bias_r[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias_r[j][0] = __ldg(bias + ng * 32 + 8 * j + 2 * t);
    bias_r[j][1] = __ldg(bias + ng * 32 + 8 * j + 2 * t + 1);
  }

  int buf = 0;
  for (int64_t tile = first; tile < n_tiles; tile += gridDim.x) {
    float* cur = tiles + buf * L::kTileFloats;
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) {
      load_tile<CIN, W, TY, L::kIR, L::kIC, L::kRow, L::kPix, L::kThreads>(
          in, next, tiles + (buf ^ 1) * L::kTileFloats);
    }
    cp_async_commit();
    cp_async_wait_prior();
    if constexpr (RELU_IN) {  // this thread's own chunks of the tile, as loaded
      for (int i = tid; i < L::kIR * L::kIC * (CIN / 4); i += L::kThreads) {
        const int pix = i / (CIN / 4);
        float4* p = reinterpret_cast<float4*>(cur + (pix / L::kIC) * L::kRow +
                                              (pix % L::kIC) * L::kPix + (i % (CIN / 4)) * 4);
        float4 v = *p;
        v.x = tf32(fmaxf(v.x, 0.0f));
        v.y = tf32(fmaxf(v.y, 0.0f));
        v.z = tf32(fmaxf(v.z, 0.0f));
        v.w = tf32(fmaxf(v.w, 0.0f));
        *p = v;
      }
    }
    __syncthreads();  // the tile (and, the first time, the weights) are in

    const int64_t b = tile / (W / TY);
    const int y0 = static_cast<int>(tile % (W / TY)) * TY;
    const int n_mine = L::kGroups == 1 ? taps.n_phases : 2;
    for (int q = 0; q < n_mine; ++q) {
      const int p = L::kGroups == 1 ? q : (q == 0 ? group : 3 - group);
      float acc[M][4][4] = {};
      for (int tp = taps.begin[p]; tp < taps.begin[p + 1]; ++tp) {
        uint32_t a_addr[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          a_addr[m] = smem_addr(cur + (ty[m] + taps.dy[tp] + 1) * L::kRow +
                                (x0[m] + (lane & 15) + taps.dx[tp] + 1) * L::kPix + a_k);
        }
        const uint32_t b_addr = smem_addr(ws + (tp * COUT + b_co) * L::kPix + b_k);
#pragma unroll
        for (int k = 0; k < CIN; k += 8) {
          uint32_t a[M][4], b01[4], b23[4];
#pragma unroll
          for (int m = 0; m < M; ++m) ldmatrix_x4(a[m], a_addr[m] + k * 4);
          ldmatrix_x4(b01, b_addr + k * 4);                   // channels +0 ... +15
          ldmatrix_x4(b23, b_addr + (16 * L::kPix + k) * 4);  // channels +16 ... +31
#pragma unroll
          for (int m = 0; m < M; ++m) {
            mma_tf32(acc[m][0], a[m], b01[0], b01[1]);
            mma_tf32(acc[m][1], a[m], b01[2], b01[3]);
            mma_tf32(acc[m][2], a[m], b23[0], b23[1]);
            mma_tf32(acc[m][3], a[m], b23[2], b23[3]);
          }
        }
      }
      // acc[m][j]: pixels x0[m] + g (0, 1) and x0[m] + g + 8 (2, 3), channels
      // ng * 32 + 8 j + 2 t (+1).
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int oy = STRIDE * (y0 + ty[m]) + taps.py[p];
        float* orow = out + (b * L::kWo + oy) * L::kWo * COUT + ng * 32 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ox = STRIDE * (x0[m] + g + 8 * h) + taps.px[p];
          float* o = orow + static_cast<int64_t>(ox) * COUT;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 v =
                make_float2(tf32(fmaxf(acc[m][j][2 * h] + bias_r[j][0], 0.0f)),
                            tf32(fmaxf(acc[m][j][2 * h + 1] + bias_r[j][1], 0.0f)));
            *reinterpret_cast<float2*>(o + 8 * j) = v;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with `cur` before it is loaded again
    buf ^= 1;
  }
}

// ---- the last layer: Cin 32 -> C channels, FP32 FMA, sigmoid ----------------

template <int C, int W>
struct Fma {
  static constexpr int kCin = 32;
  static constexpr int kThreads = 128;
  static constexpr int kWX = W / 16;          // warps across a row, 16 columns each
  static constexpr int kTY = 8 * (4 / kWX);   // 8 rows a warp
  static constexpr int kIR = kTY + 2, kIC = W + 2;
  static constexpr int kPix = kCin;
  // Floats per tile row, = 4 (mod 32): a warp's lanes 0-7 read 8 rows at one
  // column, so their 16-byte loads fall in 8 distinct bank groups.
  static constexpr int kRow = kIC * kPix + 4;
  static constexpr int kTileFloats = kIR * kRow;
  static constexpr int kWq = (3 * C + 3) / 4;  // float4s of weights per (ci, ky)
  static constexpr int kWeightFloats = kCin * 3 * kWq * 4;  // [ci][ky][kx * C + c], padded
  static constexpr int kSmem = (2 * kTileFloats + kWeightFloats) * 4;
  static_assert(W % 16 == 0 && 4 % kWX == 0 && W % kTY == 0, "shape");
  static_assert(kRow % 32 == 4, "bank groups");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int C, int W>
__global__ void __launch_bounds__(128, 1)
deconv_fma(const float* __restrict__ in, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ out, int64_t n_tiles) {
  using L = Fma<C, W>;
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;
  float* ws = smem + 2 * L::kTileFloats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int64_t first = blockIdx.x;
  load_tile<L::kCin, W, L::kTY, L::kIR, L::kIC, L::kRow, L::kPix, L::kThreads>(in, first, tiles);
  cp_async_commit();
  // The weights, w[ci][c][ky][kx] in order, into ws[ci][ky][kx * C + c] (zero padded).
  for (int i = tid; i < L::kWeightFloats; i += L::kThreads) ws[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < L::kCin * C * 9; i += L::kThreads) {
    const int kx = i % 3, ky = (i / 3) % 3, c = (i / 9) % C, ci = i / (9 * C);
    ws[(ci * 3 + ky) * L::kWq * 4 + kx * C + c] = __ldg(w + i);
  }
  float bias_r[C];
#pragma unroll
  for (int c = 0; c < C; ++c) bias_r[c] = __ldg(bias + c);

  // The thread's outputs: row wy * 8 + (lane & 7), columns x0 ... x0 + 3.
  const int wy = warp / L::kWX;
  const int r = wy * 8 + (lane & 7);
  const int x0 = (warp % L::kWX) * 16 + (lane >> 3) * 4;

  int buf = 0;
  for (int64_t tile = first; tile < n_tiles; tile += gridDim.x) {
    float* cur = tiles + buf * L::kTileFloats;
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) {
      load_tile<L::kCin, W, L::kTY, L::kIR, L::kIC, L::kRow, L::kPix, L::kThreads>(
          in, next, tiles + (buf ^ 1) * L::kTileFloats);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    float acc[4][C];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[u][c] = 0.0f;
    }
    // out[y][x] = sum over (ky, kx) of in[y + 1 - ky][x + 1 - kx] w[ky][kx]:
    // tile row r + 2 - ky, tile column x0 + u + 2 - kx.
#pragma unroll 1
    for (int ci4 = 0; ci4 < L::kCin; ci4 += 4) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* row = cur + (r + 2 - ky) * L::kRow + x0 * L::kPix + ci4;
        float4 v[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) v[i] = *reinterpret_cast<const float4*>(row + i * L::kPix);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float wk[L::kWq * 4];
          const float4* wq =
              reinterpret_cast<const float4*>(ws + ((ci4 + cc) * 3 + ky) * L::kWq * 4);
#pragma unroll
          for (int q = 0; q < L::kWq; ++q) {
            const float4 f = wq[q];
            wk[4 * q] = f.x;
            wk[4 * q + 1] = f.y;
            wk[4 * q + 2] = f.z;
            wk[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 vv = v[u + 2 - kx];
              const float x = cc == 0 ? vv.x : cc == 1 ? vv.y : cc == 2 ? vv.z : vv.w;
#pragma unroll
              for (int c = 0; c < C; ++c) acc[u][c] = fmaf(x, wk[kx * C + c], acc[u][c]);
            }
          }
        }
      }
    }
    const int64_t b = tile / (W / L::kTY);
    const int y = static_cast<int>(tile % (W / L::kTY)) * L::kTY + r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float4 s;
      s.x = 1.0f / (1.0f + expf(-(acc[0][c] + bias_r[c])));
      s.y = 1.0f / (1.0f + expf(-(acc[1][c] + bias_r[c])));
      s.z = 1.0f / (1.0f + expf(-(acc[2][c] + bias_r[c])));
      s.w = 1.0f / (1.0f + expf(-(acc[3][c] + bias_r[c])));
      *reinterpret_cast<float4*>(out + ((b * C + c) * W + y) * W + x0) = s;
    }
    __syncthreads();
    buf ^= 1;
  }
}

// ---- launches ---------------------------------------------------------------

std::mutex g_mutex;
bool g_configured[kMaxDevices] = {};

template <int CIN, int COUT, int STRIDE, int W, int TY, bool RELU_IN>
cudaError_t allow_mma() {
  return cudaFuncSetAttribute(deconv_mma<CIN, COUT, STRIDE, W, TY, RELU_IN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Mma<CIN, COUT, STRIDE, W, TY>::kSmem);
}

template <int C, int W>
cudaError_t allow_fma() {
  return cudaFuncSetAttribute(deconv_fma<C, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Fma<C, W>::kSmem);
}

// Every instantiation's shared memory allowance on the current device, once.
cudaError_t configure() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_configured[device]) return cudaSuccess;
  const cudaError_t errs[] = {
      allow_mma<64, 64, 1, 16, 4, true>(), allow_mma<64, 64, 2, 16, 4, false>(),
      allow_mma<64, 32, 2, 32, 4, false>(), allow_mma<64, 32, 1, 32, 4, false>(),
      allow_fma<1, 64>(), allow_fma<3, 64>(), allow_fma<1, 32>(), allow_fma<3, 32>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return e;
  }
  g_configured[device] = true;
  return cudaSuccess;
}

int64_t grid_for(int64_t n_tiles, int sms) { return n_tiles < sms ? n_tiles : sms; }

template <int CIN, int COUT, int STRIDE, int W, int TY, bool RELU_IN>
cudaError_t launch_mma(const float* in, const float* w, const float* bias, float* out,
                       int64_t batch, const Taps& taps, int sms, cudaStream_t stream) {
  using L = Mma<CIN, COUT, STRIDE, W, TY>;
  const int64_t n_tiles = batch * (W / TY);
  deconv_mma<CIN, COUT, STRIDE, W, TY, RELU_IN>
      <<<static_cast<unsigned int>(grid_for(n_tiles, sms)), L::kThreads, L::kSmem, stream>>>(
          in, w, bias, out, n_tiles, taps);
  return cudaGetLastError();
}

template <int C, int W>
cudaError_t launch_fma(const float* in, const float* w, const float* bias, float* out,
                       int64_t batch, int sms, cudaStream_t stream) {
  using L = Fma<C, W>;
  const int64_t n_tiles = batch * (W / L::kTY);
  deconv_fma<C, W><<<static_cast<unsigned int>(grid_for(n_tiles, sms)), L::kThreads, L::kSmem,
                     stream>>>(in, w, bias, out, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// Launches one layer on `stream`. `in` is the (batch, width, width, cin)
// NHWC input (the first layer's: the dense layer's output before its ReLU),
// `w` PyTorch's (cin, cout, 3, 3) ConvTranspose2d weight, `bias` (cout,).
// `out` is NHWC (batch, s * width, s * width, cout), or the (batch, cout,
// width, width) frame after a sigmoid when `last`. `taps` is deconv.py's
// packed phase table for the stride (50 int32 on the host); `sms` the grid's
// upper bound (one block per SM). Every pointer but `taps` is a 16-byte
// aligned device pointer of the current device. Returns 0, a cudaError_t of
// the launch (> 0), or -1 for a layer no instantiation takes.
extern "C" int daimc_deconv_layer(const float* in, const float* w, const float* bias, float* out,
                                  int64_t batch, int cin, int cout, int stride, int width,
                                  int first, int last, const int32_t* taps, int sms,
                                  void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (batch < 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  Taps t;
  memcpy(&t, taps, sizeof(Taps));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (last) {
    if (cin != 32 || stride != 1 || first) return -1;
    if (cout == 1 && width == 64) err = launch_fma<1, 64>(in, w, bias, out, batch, sms, s);
    else if (cout == 3 && width == 64) err = launch_fma<3, 64>(in, w, bias, out, batch, sms, s);
    else if (cout == 1 && width == 32) err = launch_fma<1, 32>(in, w, bias, out, batch, sms, s);
    else if (cout == 3 && width == 32) err = launch_fma<3, 32>(in, w, bias, out, batch, sms, s);
    else return -1;
    return static_cast<int>(err);
  }
  if (cin != 64) return -1;
  if (first) {
    if (cout != 64 || stride != 1 || width != 16) return -1;
    err = launch_mma<64, 64, 1, 16, 4, true>(in, w, bias, out, batch, t, sms, s);
  } else if (cout == 64 && stride == 2 && width == 16) {
    err = launch_mma<64, 64, 2, 16, 4, false>(in, w, bias, out, batch, t, sms, s);
  } else if (cout == 32 && stride == 2 && width == 32) {
    err = launch_mma<64, 32, 2, 32, 4, false>(in, w, bias, out, batch, t, sms, s);
  } else if (cout == 32 && stride == 1 && width == 32) {
    err = launch_mma<64, 32, 1, 32, 4, false>(in, w, bias, out, batch, t, sms, s);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
