// The encoder's four SAME stride-2 convolutions, hand-written for Hopper
// (sm_90a): from the (B, C, res, res) frame to the NHWC flatten that the
// first dense layer reads, with the SAME pad, bias and ReLU fused. Three
// launches an encode: layers 1 and 2 together, then layer 3, then layer 4.
//
// It replaces no TPU kernel: the JAX package leaves these convolutions to
// XLA (deep_active_inference_mc_tpu/models/networks.py, Encoder's nn.Conv
// layers). The port ran each as an F.pad copy, a cuDNN fprop on NCHW, and
// separate bias and ReLU passes, then a permute for the NHWC flatten, so that
// the passes around the convolutions cost more than the convolutions
// (PERF.md).
//
// Bound on this card: operations. Per row (resolution 64, one channel) the
// four layers do 8.85 MFLOP and need only the 16 KB frame in and the 4 KB
// flatten out: at 4096 rows 0.073 ms at the TF32 tensor-core peak against
// 0.025 ms of bytes. As launched, layer 2's and layer 3's outputs (32 and
// 16 KB a row) go through device memory: 116 KB a row, 0.145 ms at 4096.
//
// Design:
// - Layer 1 (K = 9 C, too thin for mma) runs on FP32 FMAs into shared
//   memory: a thread takes 4 pixels of a row and 16 output channels, the
//   weights broadcast from shared memory. Its output, bias, ReLU and the TF32
//   rounding applied, stays in shared memory for layer 2: 1024 pixels a tile
//   (one frame at resolution 64, four at 32), 145 KB. Where they fit (one
//   colour channel) the next tile's frames stream into shared memory by
//   cp.async while layer 2 runs; otherwise layer 1 reads device memory.
// - Layers 2-4 are implicit GEMMs on TF32 tensor cores, mma.sync m16n8k8
//   with FP32 accumulation, operands fed by ldmatrix: M = output pixels of
//   the tile's frames, N = Cout, K = 9 taps x Cin; a warp takes 32 pixels x
//   32 channels in layer 2, 16 x 32 in layers 3 and 4. The layer's weights,
//   all nine taps, rounded to TF32, stay in shared memory for the block's
//   life; layers 3 and 4 stream their input tiles (64 output pixels of 1-16
//   frames) by cp.async, double buffered where shared memory allows (layer
//   3), single buffered beside layer 4's 153 KB of weights. (Two groups of
//   8 warps a block, each on half-frame bands, measured slower: a warp's
//   16-pixel fragment in layer 2 reads 1.5 x the shared memory per mma.)
// - A stride-2 tap reads every other column, so each input row is kept with
//   its even columns first, then its odd ones: the 8 pixels an ldmatrix
//   reads lie side by side, 4 banks apart (a pixel's stride is Cin + 4
//   floats), without conflict.
// - The SAME pad (one zero row and column past the end, none before the
//   start) is a predicated load: a lane whose tap falls on it points
//   ldmatrix at a zero pixel in shared memory; layer 1 loads a zero.
// - Epilogue: bias, ReLU and, where a tensor-core layer reads the output,
//   rounding to TF32; NHWC stores. Layer 4's output is the flatten.
// - A persistent grid, one block of 8 warps per SM. Deterministic and
//   row-independent: every output is summed by one thread or one mma row in
//   a fixed order; no atomics, no split-K, and no sum mixes two frames.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kC1 = 32;  // output channels of layers 1 and 2
constexpr int kC3 = 64;  // of layers 3 and 4

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest N groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Where column x of a W-wide row is kept: even columns first, then odd ones.
template <int W>
__device__ __forceinline__ int col_slot(int x) {
  return (x & 1) * (W / 2) + (x >> 1);
}

// A warp's MF 16-pixel fragments x 32 output channels, one tap: K = CIN.
// a_addr: this lane's ldmatrix row of each fragment (its pixel's channel
// 0 or 4); b_addr: its row of the tap's weights [co][ci] (channels +0 ... +15,
// then +16 ... +31 at 16 rows further). acc[m][j]: channels 8 j + 2 t (+1)
// of pixels g (0, 1) and g + 8 (2, 3).
template <int CIN, int KPIX, int MF>
__device__ __forceinline__ void mma_tap(float (&acc)[MF][4][4], const uint32_t (&a_addr)[MF],
                                        uint32_t b_addr) {
#pragma unroll
  for (int k = 0; k < CIN; k += 8) {
    uint32_t a[MF][4], b01[4], b23[4];
#pragma unroll
    for (int m = 0; m < MF; ++m) ldmatrix_x4(a[m], a_addr[m] + k * 4);
    ldmatrix_x4(b01, b_addr + k * 4);
    ldmatrix_x4(b23, b_addr + (16 * KPIX + k) * 4);
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      mma_tf32(acc[m][0], a[m], b01[0], b01[1]);
      mma_tf32(acc[m][1], a[m], b01[2], b01[3]);
      mma_tf32(acc[m][2], a[m], b23[0], b23[1]);
      mma_tf32(acc[m][3], a[m], b23[2], b23[3]);
    }
  }
}

// The weights of a 3x3 conv, PyTorch's w[co][ci][ky][kx] read in order by
// float4s, eight in flight a thread, into ws[tap][co][ci] (a pixel's stride
// KPIX) as TF32.
template <int CIN, int COUT, int KPIX, int THREADS>
__device__ __forceinline__ void load_weights_tf32(const float* __restrict__ w, float* ws) {
  constexpr int kVecs = COUT * CIN * kTaps / 4, kBatch = 8;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int base = threadIdx.x; base < kVecs; base += kBatch * THREADS) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS;
      if (i < kVecs) v[u] = __ldg(w4 + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS;
      if (i >= kVecs) continue;
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 4 * i + k;
        const int tap = n % kTaps, ci = (n / kTaps) % CIN, co = n / (kTaps * CIN);
        ws[(tap * COUT + co) * KPIX + ci] = tf32(e[k]);
      }
    }
  }
}

// ---- layers 1 and 2: the frame to (B, res/4, res/4, 32) ----------------------

template <int C, int R>
struct L12 {
  static constexpr int kN1 = R / 2, kN2 = R / 4;  // layer 1's and layer 2's output widths
  static constexpr int kFrames = 1024 / (kN1 * kN1);  // a tile: 1024 layer-1 pixels
  static constexpr int kP1 = kFrames * kN1 * kN1;
  static constexpr int kP2 = kFrames * kN2 * kN2;  // 256 output pixels: 16 fragments
  static constexpr int kPix = kC1 + 4;
  // Floats per row of layer 1's output, = 4 (mod 32): a warp's layer-1 stores
  // (4 rows x 8 column groups) fall in distinct banks.
  static constexpr int kRow1 = kN1 * kPix + 4;
  static constexpr int kW2Floats = kTaps * kC1 * kPix;  // [tap][co][ci]
  static constexpr int kH1Floats = kFrames * kN1 * kRow1;
  static constexpr int kW1Floats = C * kTaps * kC1 + kC1;  // [c][ky][kx][co], FP32; bias
  static constexpr int kFrameFloats = kFrames * C * R * R;  // the tile's frames, NCHW
  static constexpr int kBaseFloats = kW2Floats + kH1Floats + kW1Floats + kPix;
  // The next tile's frames stream into shared memory during layer 2 where
  // they fit (one colour channel); otherwise layer 1 reads device memory.
  static constexpr bool kStaged = (kBaseFloats + kFrameFloats) * 4 <= 232448;
  static constexpr int kSmem = (kBaseFloats + (kStaged ? kFrameFloats : 0)) * 4;
  static_assert(kP1 == 1024 && kP2 == 256 && kN1 % 4 == 0 && kRow1 % 32 == 4, "shape");
  static_assert(kSmem <= 232448, "shared memory");
};

// The frames of tile `tile` into `buf` as they lie in device memory, zeros
// past the batch.
template <int C, int R>
__device__ __forceinline__ void load_frames(const float* __restrict__ frames, int64_t tile,
                                            int64_t batch, float* buf) {
  using L = L12<C, R>;
  constexpr int kChunks = L::kFrameFloats / 4, kPerFrame = C * R * R / 4;
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const bool ok = tile * L::kFrames + i / kPerFrame < batch;
    const float* src = ok ? frames + tile * L::kFrameFloats + 4 * i : frames;
    cp_async16(smem_addr(buf + 4 * i), src, ok);
  }
}

template <int C, int R>
__global__ void __launch_bounds__(kThreads, 1)
encoder_l12(const float* __restrict__ frames, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out, int64_t batch,
            int64_t n_tiles) {
  using L = L12<C, R>;
  constexpr int N1 = L::kN1, N2 = L::kN2, KP = L::kPix, ROW1 = L::kRow1;
  extern __shared__ __align__(16) float smem[];
  float* ws2 = smem;
  float* h1 = ws2 + L::kW2Floats;
  float* ws1 = h1 + L::kH1Floats;
  float* bias1 = ws1 + C * kTaps * kC1;
  float* zero = ws1 + L::kW1Floats;
  float* staged = zero + KP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if constexpr (L::kStaged) {
    load_frames<C, R>(frames, blockIdx.x, batch, staged);
    cp_async_commit();
  }
  load_weights_tf32<kC1, kC1, KP, kThreads>(w2, ws2);
  for (int i = tid; i < kC1 * C * kTaps; i += kThreads) {  // w1[co][c][ky][kx]
    ws1[(i % (C * kTaps)) * kC1 + i / (C * kTaps)] = __ldg(w1 + i);
  }
  if (tid < kC1) bias1[tid] = __ldg(b1 + tid);
  if (tid < KP) zero[tid] = 0.0f;

  // Layer 2's warp tile: fragments 2 warp and 2 warp + 1, all 32 channels.
  const int g = lane >> 2, t = lane & 3;
  const int a_k = (lane >> 4) * 4;
  const int b_co = (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 4;
  int frag_f[2], frag_y[2], frag_x[2];  // this lane's ldmatrix pixel of each fragment
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = (2 * warp + m) * 16 + (lane & 15);
    frag_f[m] = p / (N2 * N2);
    frag_y[m] = (p / N2) % N2;
    frag_x[m] = p % N2;
  }
  float bias2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias2[j][0] = __ldg(b2 + 8 * j + 2 * t);
    bias2[j][1] = __ldg(b2 + 8 * j + 2 * t + 1);
  }
  __syncthreads();

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t f0 = tile * L::kFrames;
    if constexpr (L::kStaged) {
      cp_async_wait<0>();
      __syncthreads();  // the tile's frames are in
    }

    // Layer 1: 4 pixels (row y, columns x0 ... x0 + 3) x 16 channels a pass.
    for (int item = tid; item < L::kP1 / 4; item += kThreads) {
      const int px0 = item * 4;
      const int f = px0 / (N1 * N1), y = (px0 / N1) % N1, x0 = px0 % N1;
      if (f0 + f >= batch) continue;
      const float* frame = L::kStaged ? staged + f * C * R * R : frames + (f0 + f) * C * R * R;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float acc[4][16];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[u][j] = 0.0f;
        }
#pragma unroll 1
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            // Input columns 2 x0 ... 2 x0 + 8 of row 2 y + ky; past the end, the pad.
            const int iy = 2 * y + ky;
            float in[9];
            if (iy < R) {
              const float* row = frame + (c * R + iy) * R + 2 * x0;
              float4 v0, v1;
              if constexpr (L::kStaged) {
                v0 = reinterpret_cast<const float4*>(row)[0];
                v1 = reinterpret_cast<const float4*>(row)[1];
                in[8] = 2 * x0 + 8 < R ? row[8] : 0.0f;
              } else {
                v0 = __ldg(reinterpret_cast<const float4*>(row));
                v1 = __ldg(reinterpret_cast<const float4*>(row + 4));
                in[8] = 2 * x0 + 8 < R ? __ldg(row + 8) : 0.0f;
              }
              in[0] = v0.x; in[1] = v0.y; in[2] = v0.z; in[3] = v0.w;
              in[4] = v1.x; in[5] = v1.y; in[6] = v1.z; in[7] = v1.w;
            } else {
#pragma unroll
              for (int i = 0; i < 9; ++i) in[i] = 0.0f;
            }
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float4* wq =
                  reinterpret_cast<const float4*>(ws1 + ((c * 3 + ky) * 3 + kx) * kC1 + half * 16);
              float wk[16];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float4 v = wq[q];
                wk[4 * q] = v.x; wk[4 * q + 1] = v.y; wk[4 * q + 2] = v.z; wk[4 * q + 3] = v.w;
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int j = 0; j < 16; ++j) acc[u][j] = fmaf(in[2 * u + kx], wk[j], acc[u][j]);
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b = reinterpret_cast<const float4*>(bias1 + half * 16)[q];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float4 v;
            v.x = tf32(fmaxf(acc[u][4 * q] + b.x, 0.0f));
            v.y = tf32(fmaxf(acc[u][4 * q + 1] + b.y, 0.0f));
            v.z = tf32(fmaxf(acc[u][4 * q + 2] + b.z, 0.0f));
            v.w = tf32(fmaxf(acc[u][4 * q + 3] + b.w, 0.0f));
            reinterpret_cast<float4*>(h1 + (f * N1 + y) * ROW1 + col_slot<N1>(x0 + u) * KP +
                                      half * 16)[q] = v;
          }
        }
      }
    }
    __syncthreads();  // layer 1's tile is in, and the frames are read
    if constexpr (L::kStaged) {
      if (tile + gridDim.x < n_tiles) load_frames<C, R>(frames, tile + gridDim.x, batch, staged);
      cp_async_commit();
    }

    // Layer 2: output pixel (y, x) sums layer-1 pixels (2 y + ky, 2 x + kx).
    float acc[2][4][4] = {};
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t a_addr[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int iy = 2 * frag_y[m] + ky, ix = 2 * frag_x[m] + kx;
        const float* px = iy < N1 && ix < N1
                              ? h1 + (frag_f[m] * N1 + iy) * ROW1 + col_slot<N1>(ix) * KP
                              : zero;
        a_addr[m] = smem_addr(px + a_k);
      }
      mma_tap<kC1, KP, 2>(acc, a_addr, smem_addr(ws2 + (tap * kC1 + b_co) * KP + b_k));
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (2 * warp + m) * 16 + g + 8 * h;
        if (f0 + p / (N2 * N2) >= batch) continue;
        float* o = out + (tile * L::kP2 + p) * kC1 + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(tf32(fmaxf(acc[m][j][2 * h] + bias2[j][0], 0.0f)),
                          tf32(fmaxf(acc[m][j][2 * h + 1] + bias2[j][1], 0.0f)));
        }
      }
    }
    __syncthreads();  // every warp is done with layer 1's tile before it is written again
  }
}

// ---- layers 3 and 4: (B, W, W, CIN) to (B, W/2, W/2, 64) -----------------------

template <int CIN, int W>
struct S2 {
  static constexpr int kN = W / 2;                 // output width
  static constexpr int kFrames = 64 / (kN * kN);   // a tile: 64 output pixels
  static constexpr int kPin = kFrames * W * W;     // its 256 input pixels
  static constexpr int kPix = CIN + 4;
  static constexpr int kWeightFloats = kTaps * kC3 * kPix;  // [tap][co][ci]
  static constexpr int kTileFloats = kPin * kPix;
  // Two input buffers where they fit beside the weights; layer 4's do not.
  static constexpr int kStages =
      (kWeightFloats + 2 * kTileFloats + kPix) * 4 <= 232448 ? 2 : 1;
  static constexpr int kSmem = (kWeightFloats + kStages * kTileFloats + kPix) * 4;
  static_assert(kFrames * kN * kN == 64 && CIN % 8 == 0, "shape");
  static_assert(kSmem <= 232448, "shared memory");
};

// Tile `tile` of the input: frames tile * kFrames ..., zeros past the batch.
template <int CIN, int W>
__device__ __forceinline__ void load_input(const float* __restrict__ in, int64_t tile,
                                           int64_t batch, float* buf) {
  using L = S2<CIN, W>;
  constexpr int kChunks = CIN / 4;
  for (int i = threadIdx.x; i < L::kPin * kChunks; i += kThreads) {
    const int q = i % kChunks, pix = i / kChunks;
    const int f = pix / (W * W), y = (pix / W) % W, x = pix % W;
    const bool ok = tile * L::kFrames + f < batch;
    const float* src = ok ? in + (tile * L::kPin + pix) * CIN + q * 4 : in;
    cp_async16(smem_addr(buf + ((f * W + y) * W + col_slot<W>(x)) * L::kPix + q * 4), src, ok);
  }
}

template <int CIN, int W, bool ROUND_OUT>
__global__ void __launch_bounds__(kThreads, 1)
encoder_s2(const float* __restrict__ in, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ out, int64_t batch,
           int64_t n_tiles) {
  using L = S2<CIN, W>;
  constexpr int N = L::kN, KP = L::kPix;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* tiles = ws + L::kWeightFloats;
  float* zero = tiles + L::kStages * L::kTileFloats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int64_t first = blockIdx.x;
  if constexpr (L::kStages == 2) {
    load_input<CIN, W>(in, first, batch, tiles);
    cp_async_commit();
  }
  load_weights_tf32<CIN, kC3, KP, kThreads>(w, ws);
  if (tid < KP) zero[tid] = 0.0f;

  // The warp's tile: fragment warp % 4 (16 pixels), channels (warp / 4) * 32 ...
  const int mf = warp & 3, nh = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int a_k = (lane >> 4) * 4;
  const int b_co = nh * 32 + (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 4;
  const int p_lane = mf * 16 + (lane & 15);
  const int fr = p_lane / (N * N), oy = (p_lane / N) % N, ox = p_lane % N;
  float bias_r[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias_r[j][0] = __ldg(bias + nh * 32 + 8 * j + 2 * t);
    bias_r[j][1] = __ldg(bias + nh * 32 + 8 * j + 2 * t + 1);
  }

  int buf = 0;
  for (int64_t tile = first; tile < n_tiles; tile += gridDim.x) {
    float* cur = tiles + buf * L::kTileFloats;
    if constexpr (L::kStages == 2) {
      const int64_t next = tile + gridDim.x;
      if (next < n_tiles) load_input<CIN, W>(in, next, batch, tiles + (buf ^ 1) * L::kTileFloats);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_input<CIN, W>(in, tile, batch, cur);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, the first time, the weights) are in

    float acc[1][4][4] = {};
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int iy = 2 * oy + ky, ix = 2 * ox + kx;
      const float* px = iy < W && ix < W ? cur + ((fr * W + iy) * W + col_slot<W>(ix)) * KP : zero;
      const uint32_t a_addr[1] = {smem_addr(px + a_k)};
      mma_tap<CIN, KP, 1>(acc, a_addr, smem_addr(ws + (tap * kC3 + b_co) * KP + b_k));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mf * 16 + g + 8 * h;
      if (tile * L::kFrames + p / (N * N) >= batch) continue;
      float* o = out + (tile * 64 + p) * kC3 + nh * 32 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v0 = fmaxf(acc[0][j][2 * h] + bias_r[j][0], 0.0f);
        float v1 = fmaxf(acc[0][j][2 * h + 1] + bias_r[j][1], 0.0f);
        if constexpr (ROUND_OUT) {
          v0 = tf32(v0);
          v1 = tf32(v1);
        }
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(v0, v1);
      }
    }
    __syncthreads();  // every warp is done with `cur` before it is loaded again
    buf ^= L::kStages - 1;
  }
}

// ---- launches ---------------------------------------------------------------

std::mutex g_mutex;
bool g_configured[kMaxDevices] = {};

template <int C, int R>
cudaError_t allow_l12() {
  return cudaFuncSetAttribute(encoder_l12<C, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              L12<C, R>::kSmem);
}

template <int CIN, int W, bool ROUND_OUT>
cudaError_t allow_s2() {
  return cudaFuncSetAttribute(encoder_s2<CIN, W, ROUND_OUT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, S2<CIN, W>::kSmem);
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
      allow_l12<1, 64>(), allow_l12<3, 64>(), allow_l12<1, 32>(), allow_l12<3, 32>(),
      allow_s2<32, 16, true>(), allow_s2<64, 8, false>(),
      allow_s2<32, 8, true>(), allow_s2<64, 4, false>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return e;
  }
  g_configured[device] = true;
  return cudaSuccess;
}

int64_t grid_for(int64_t n_tiles, int sms) { return n_tiles < sms ? n_tiles : sms; }

template <int C, int R>
cudaError_t launch_l12(const float* frames, const float* w1, const float* b1, const float* w2,
                       const float* b2, float* out, int64_t batch, int sms,
                       cudaStream_t stream) {
  using L = L12<C, R>;
  const int64_t n_tiles = (batch + L::kFrames - 1) / L::kFrames;
  encoder_l12<C, R><<<static_cast<unsigned int>(grid_for(n_tiles, sms)), kThreads, L::kSmem,
                      stream>>>(frames, w1, b1, w2, b2, out, batch, n_tiles);
  return cudaGetLastError();
}

template <int CIN, int W, bool ROUND_OUT>
cudaError_t launch_s2(const float* in, const float* w, const float* bias, float* out,
                      int64_t batch, int sms, cudaStream_t stream) {
  using L = S2<CIN, W>;
  const int64_t n_tiles = (batch + L::kFrames - 1) / L::kFrames;
  encoder_s2<CIN, W, ROUND_OUT><<<static_cast<unsigned int>(grid_for(n_tiles, sms)), kThreads,
                                  L::kSmem, stream>>>(in, w, bias, out, batch, n_tiles);
  return cudaGetLastError();
}

bool misaligned(const void* a, const void* b, const void* c, const void* d) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16 != 0;
}

}  // namespace

// Layers 1 and 2 on `stream`: `frames` (batch, colours, res, res) float32,
// `w1` (32, colours, 3, 3), `w2` (32, 32, 3, 3) PyTorch Conv2d weights with
// biases (32,); `out` (batch, res/4, res/4, 32) NHWC, after bias and ReLU,
// rounded to TF32. `sms` is the grid's upper bound (one block per SM). Every
// pointer is a 16-byte aligned device pointer of the current device.
// Returns 0, a cudaError_t of the launch (> 0), or -1 for a shape no
// instantiation takes.
extern "C" int daimc_encoder_l12(const float* frames, const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out, int64_t batch,
                                 int colours, int resolution, int sms, void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (batch < 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(frames, w1, w2, out) || misaligned(b1, b2, out, out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (colours == 1 && resolution == 64) {
    err = launch_l12<1, 64>(frames, w1, b1, w2, b2, out, batch, sms, s);
  } else if (colours == 3 && resolution == 64) {
    err = launch_l12<3, 64>(frames, w1, b1, w2, b2, out, batch, sms, s);
  } else if (colours == 1 && resolution == 32) {
    err = launch_l12<1, 32>(frames, w1, b1, w2, b2, out, batch, sms, s);
  } else if (colours == 3 && resolution == 32) {
    err = launch_l12<3, 32>(frames, w1, b1, w2, b2, out, batch, sms, s);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}

// Layer 3 or 4 on `stream`: `in` (batch, width, width, cin) NHWC, `w`
// (64, cin, 3, 3) and `bias` (64,); `out` (batch, width/2, width/2, 64) NHWC
// after bias and ReLU, rounded to TF32 if `round_out` (layer 3, whose output
// layer 4's tensor cores read). Layer 4's output is the encoder's NHWC
// flatten. Pointers and return as daimc_encoder_l12's.
extern "C" int daimc_encoder_s2(const float* in, const float* w, const float* bias, float* out,
                                int64_t batch, int cin, int width, int round_out, int sms,
                                void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  if (batch < 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(in, w, bias, out)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 32 && width == 16 && round_out) {
    err = launch_s2<32, 16, true>(in, w, bias, out, batch, sms, s);
  } else if (cin == 64 && width == 8 && !round_out) {
    err = launch_s2<64, 8, false>(in, w, bias, out, batch, sms, s);
  } else if (cin == 32 && width == 8 && round_out) {
    err = launch_s2<32, 8, true>(in, w, bias, out, batch, sms, s);
  } else if (cin == 64 && width == 4 && !round_out) {
    err = launch_s2<64, 4, false>(in, w, bias, out, batch, sms, s);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
