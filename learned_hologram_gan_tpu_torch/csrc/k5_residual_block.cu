// K5: the eval-mode residual block with its BatchNorms folded,
//
//   out = relu( conv3x3(y1, w2) + b2 + conv1x1(x, w3) + b3 ),
//   y1  = relu( conv3x3(x, w1) + b1 ),
//
// NHWC, SAME padding, stride 1, float32 accumulation, in two element types:
// float32 (no TF32, no tensor cores), and bfloat16 for x, the weights, y1
// and the output, with float32 biases.  In bfloat16 y1 is rounded once to
// bfloat16 (round to nearest even) as it is stored, and the output once,
// after the shortcut add and the final ReLU: the JAX kernel's roundings
// (conv_block.py:138, :169).  It replaces
// learned_hologram_gan_tpu/ops/pallas/conv_block.py:_block_kernel (the
// pl.pallas_call at conv_block.py:223), as nn/fused_unet.py:_block_eval
// calls it.
//
// What bounds it on this card: operations.  The full-width UNet (384^2,
// base 64, four levels) does ~219 GFLOP per image in its nine blocks,
// 2*H*W*(9*Cin*C + 9*C*C + Cin*C) each, so a batch of 16 is ~3.5 TFLOP:
// >= 52 ms at 67 TFLOP/s of float32 outside the tensor cores, >= 3.5 ms at
// 989 TFLOP/s of bfloat16 on them.  Its activations, ~1.3 GB at batch 16 in
// float32, take < 0.5 ms at 3.35 TB/s.
//
// Design (a first, simple kernel): a direct 3x3 convolution tiled in shared
// memory, as an implicit GEMM over (pixels) x (output channels) x (9 taps x
// input channels).  Both element types share the tiling: a block owns an
// 8 x 32 tile of output pixels of one image and 64 output channels, 256
// threads, and the input channels go through shared memory 16 at a time
// (the chunk of input with its 1-pixel halo, zeros outside the image as
// SAME padding, and the chunk's weights for the block's 64 channels).
//   * float32, on the SIMT cores: the 32 lanes of a warp own 8 neighbouring
//     columns each (4 lanes per tile row), the 8 warps own 8 output
//     channels each, so a weight read from shared memory is a broadcast and
//     each thread keeps 8 x 8 accumulators in registers.  The halo row
//     stride is odd (35), so the lanes' rows start in distinct banks.  Per
//     channel a thread reads 10 inputs per kernel row and reuses them over
//     the 3 column taps: 30 input and 18 vector weight reads for 576 FMAs.
//   * bfloat16, on the tensor cores: mma.sync m16n8k16 with float32
//     accumulators.  Warp w owns tile rows 2 (w % 4) and 2 (w % 4) + 1 (four
//     16-pixel m-tiles) and 32 output channels (four n-tiles): per tap and
//     chunk it loads 4 A and 4 B fragments with 32-bit shared loads and
//     issues 16 mma.  Shared memory keeps 16 channels per pixel (and per
//     output channel of the weights, which come with the input channels
//     last) padded to 24, a 12-word stride, so the 8 x 4 lanes of a
//     fragment load hit 32 distinct banks; both fill in 16-byte loads.
//   * Neither the weights nor the activations have to fit whole: every
//     block shape of the UNet, 4 -> 64 at 384^2 to 1024 -> 512 at 48^2,
//     goes through the same loop.  Partial tiles and channel chunks are
//     masked.
//   * Two launches per block.  The first writes y1 = relu(conv1 + b1) to a
//     scratch buffer the wrapper allocates; the second reads y1 with a zero
//     halo (exactly the SAME padding of conv2 on y1, so no ring has to be
//     re-zeroed), accumulates conv2 and then the 1x1 shortcut on x into the
//     same registers, adds b2 + b3 and applies the final ReLU.  The TPU
//     kernel keeps y1 on chip in one residency; that redesign, and
//     double-buffered, asynchronous loads (TMA) and wgmma, are a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;   // output tile: 8 rows
constexpr int kTileCols = 32;  // x 32 columns
constexpr int kTileN = 64;     // output channels per block
constexpr int kChunk = 16;     // input channels per pass through shared memory
constexpr int kPx = 8;         // neighbouring columns per thread
constexpr int kCn = 8;         // output channels per thread (one warp's share)
constexpr int kThreads = 256;
constexpr int kHaloRows = kTileRows + 2;
constexpr int kHaloCols = kTileCols + 2;
constexpr int kRowStride = 35;  // >= kHaloCols and odd
constexpr int kInFloats = kChunk * kHaloRows * kRowStride;
constexpr int kWFloats = kChunk * 9 * kTileN;
constexpr size_t kSmemBytes = (kInFloats + kWFloats) * sizeof(float);

static_assert(kThreads == 32 * (kTileN / kCn), "one warp per channel group");
static_assert(kTileRows * (kTileCols / kPx) == 32, "one lane per pixel group");
static_assert(kInFloats % 4 == 0, "weights must start 16-byte aligned");

// One chunk of `c_total`-channel NHWC input `src` (image b already applied)
// into in_s[c][row][col], rows/cols of the tile's halo (origin y0-1, x0-1).
// `halo` = 0 loads only the tile itself, at halo coordinates (1, 1) on.
__device__ __forceinline__ void load_input(float* in_s, const float* src,
                                           int c_total, int c0, int y0,
                                           int x0, int h, int w, int halo) {
  const int rows = halo ? kHaloRows : kTileRows;
  const int cols = halo ? kHaloCols : kTileCols;
  const int off = halo ? 0 : 1;
  for (int i = threadIdx.x; i < kChunk * rows * cols; i += kThreads) {
    const int c = i % kChunk;
    const int pos = i / kChunk;
    const int hr = pos / cols + off;
    const int hc = pos % cols + off;
    const int gy = y0 + hr - 1;
    const int gx = x0 + hc - 1;
    float v = 0.f;
    if (c0 + c < c_total && gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = src[(static_cast<size_t>(gy) * w + gx) * c_total + c0 + c];
    }
    in_s[(c * kHaloRows + hr) * kRowStride + hc] = v;
  }
}

// Weights `wt` laid out (taps, c_total, cout) for input channels c0.. and
// output channels n0..: w_s[(c * taps + tap) * kTileN + n].
__device__ __forceinline__ void load_weights(float* w_s, const float* wt,
                                             int taps, int c_total, int c0,
                                             int cout, int n0) {
  for (int i = threadIdx.x; i < kChunk * taps * kTileN; i += kThreads) {
    const int n = i % kTileN;
    const int rest = i / kTileN;
    const int c = rest % kChunk;
    const int tap = rest / kChunk;
    float v = 0.f;
    if (c0 + c < c_total && n0 + n < cout) {
      v = wt[(static_cast<size_t>(tap) * c_total + c0 + c) * cout + n0 + n];
    }
    w_s[(c * taps + tap) * kTileN + n] = v;
  }
}

__device__ __forceinline__ void fma_row(float (&acc)[kPx][kCn],
                                        const float* v, const float* wp) {
  const float4 lo = *reinterpret_cast<const float4*>(wp);
  const float4 hi = *reinterpret_cast<const float4*>(wp + 4);
  const float wv[kCn] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
#pragma unroll
    for (int k = 0; k < kCn; ++k) acc[p][k] = fmaf(v[p], wv[k], acc[p][k]);
  }
}

// out = relu(conv3x3(a, wa) [+ conv1x1(x, wx)] + bias_a [+ bias_x]).
// a: (B, H, W, ca), wa: (9, ca, cout); x: (B, H, W, cx), wx: (cx, cout).
// Grid: (tiles of the image, tiles of cout, B).
template <bool kShortcut>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_kernel(const float* __restrict__ a, int ca,
                   const float* __restrict__ wa, const float* __restrict__ x,
                   int cx, const float* __restrict__ wx,
                   const float* __restrict__ bias_a,
                   const float* __restrict__ bias_x, float* __restrict__ out,
                   int h, int w, int cout, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);
  float* w_s = in_s + kInFloats;

  const int y0 = (blockIdx.x / tiles_x) * kTileRows;
  const int x0 = (blockIdx.x % tiles_x) * kTileCols;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int pr = lane >> 2;               // tile row
  const int pc = (lane & 3) * kPx;        // first tile column
  const int cn = (threadIdx.x >> 5) * kCn;  // first channel within the tile
  const size_t img = static_cast<size_t>(h) * w;

  float acc[kPx][kCn];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
#pragma unroll
    for (int k = 0; k < kCn; ++k) acc[p][k] = 0.f;
  }

  const float* a_b = a + b * img * ca;
  for (int c0 = 0; c0 < ca; c0 += kChunk) {
    __syncthreads();  // the previous chunk has been consumed
    load_input(in_s, a_b, ca, c0, y0, x0, h, w, 1);
    load_weights(w_s, wa, 9, ca, c0, cout, n0);
    __syncthreads();
    const int cmax = min(kChunk, ca - c0);
    for (int c = 0; c < cmax; ++c) {
      const float* in_c = in_s + (c * kHaloRows + pr) * kRowStride + pc;
      const float* w_c = w_s + c * 9 * kTileN + cn;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[kPx + 2];
#pragma unroll
        for (int j = 0; j < kPx + 2; ++j) v[j] = in_c[dy * kRowStride + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          fma_row(acc, v + dx, w_c + (dy * 3 + dx) * kTileN);
        }
      }
    }
  }

  if (kShortcut) {
    const float* x_b = x + b * img * cx;
    for (int c0 = 0; c0 < cx; c0 += kChunk) {
      __syncthreads();
      load_input(in_s, x_b, cx, c0, y0, x0, h, w, 0);
      load_weights(w_s, wx, 1, cx, c0, cout, n0);
      __syncthreads();
      const int cmax = min(kChunk, cx - c0);
      for (int c = 0; c < cmax; ++c) {
        const float* in_c =
            in_s + (c * kHaloRows + pr + 1) * kRowStride + pc + 1;
        float v[kPx];
#pragma unroll
        for (int j = 0; j < kPx; ++j) v[j] = in_c[j];
        fma_row(acc, v, w_s + c * kTileN + cn);
      }
    }
  }

  float bias[kCn];
#pragma unroll
  for (int k = 0; k < kCn; ++k) {
    const int n = n0 + cn + k;
    bias[k] = 0.f;
    if (n < cout) bias[k] = kShortcut ? bias_a[n] + bias_x[n] : bias_a[n];
  }
  const int oy = y0 + pr;
  if (oy >= h) return;
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int ox = x0 + pc + p;
    if (ox >= w) break;
    float* o = out + ((b * static_cast<size_t>(h) + oy) * w + ox) * cout + n0 + cn;
#pragma unroll
    for (int k = 0; k < kCn; ++k) {
      if (n0 + cn + k < cout) o[k] = fmaxf(acc[p][k] + bias[k], 0.f);
    }
  }
}

template <bool kShortcut>
int launch(const float* a, int ca, const float* wa, const float* x, int cx,
           const float* wx, const float* bias_a, const float* bias_x,
           float* out, int batch, int h, int w, int cout,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<kShortcut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + kTileCols - 1) / kTileCols;
  const int tiles_y = (h + kTileRows - 1) / kTileRows;
  const dim3 grid(tiles_x * tiles_y, (cout + kTileN - 1) / kTileN, batch);
  conv3x3_kernel<kShortcut><<<grid, kThreads, kSmemBytes, stream>>>(
      a, ca, wa, x, cx, wx, bias_a, bias_x, out, h, w, cout, tiles_x);
  return static_cast<int>(cudaGetLastError());
}


// ---- bfloat16 on the tensor cores ----------------------------------------

constexpr int kPixStride = 24;  // bf16 per pixel: 16 channels + 8 of padding
constexpr int kPixWords = kPixStride / 2;
constexpr int kMmaInElems = kHaloRows * kHaloCols * kPixStride;
constexpr int kMmaWElems = 9 * kTileN * kPixStride;
constexpr size_t kMmaSmemBytes = (kMmaInElems + kMmaWElems) * sizeof(__nv_bfloat16);

static_assert(kChunk == 16, "one m16n8k16 step per tap and chunk");
static_assert((kMmaInElems * sizeof(__nv_bfloat16)) % 16 == 0, "weights 16-byte aligned");
static_assert(kPixStride % 8 == 0, "16-byte shared stores");

// Channels c .. c + 7 of one pixel (or one output channel's weights),
// zeros past c_total: one 16-byte load where the row allows it (`vec`:
// c_total a multiple of 8, so every such group is 16-byte aligned).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int c,
                                       int c_total, bool vec) {
  if (vec && c + 8 <= c_total) return *reinterpret_cast<const uint4*>(row + c);
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r.h[k] = c + k < c_total ? row[c + k] : __float2bfloat16_rn(0.f);
  }
  return r.u;
}

// The bfloat16 counterpart of load_input: in_s[(row * kHaloCols + col) *
// kPixStride + c], channels contiguous, 8 at a time.
__device__ __forceinline__ void load_input_bf16(__nv_bfloat16* in_s,
                                                const __nv_bfloat16* src,
                                                int c_total, int c0, int y0,
                                                int x0, int h, int w,
                                                int halo) {
  const int rows = halo ? kHaloRows : kTileRows;
  const int cols = halo ? kHaloCols : kTileCols;
  const int off = halo ? 0 : 1;
  const bool vec = c_total % 8 == 0;
  for (int i = threadIdx.x; i < 2 * rows * cols; i += kThreads) {
    const int half = i & 1;
    const int pos = i >> 1;
    const int hr = pos / cols + off;
    const int hc = pos % cols + off;
    const int gy = y0 + hr - 1;
    const int gx = x0 + hc - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = load8(src + (static_cast<size_t>(gy) * w + gx) * c_total, c0 + 8 * half, c_total, vec);
    }
    *reinterpret_cast<uint4*>(in_s + (hr * kHaloCols + hc) * kPixStride + 8 * half) = v;
  }
}

// The bfloat16 counterpart of load_weights, from weights laid out (taps,
// cout, c_total): w_s[(tap * kTileN + n) * kPixStride + c], input channels
// contiguous (B is "col" for mma), 8 at a time.
__device__ __forceinline__ void load_weights_bf16(__nv_bfloat16* w_s,
                                                  const __nv_bfloat16* wt,
                                                  int taps, int c_total,
                                                  int c0, int cout, int n0) {
  const bool vec = c_total % 8 == 0;
  for (int i = threadIdx.x; i < 2 * taps * kTileN; i += kThreads) {
    const int half = i & 1;
    const int n = (i >> 1) % kTileN;
    const int tap = (i >> 1) / kTileN;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + n < cout) {
      v = load8(wt + (static_cast<size_t>(tap) * cout + n0 + n) * c_total, c0 + 8 * half,
                c_total, vec);
    }
    *reinterpret_cast<uint4*>(w_s + (tap * kTileN + n) * kPixStride + 8 * half) = v;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One tap of one 16-channel chunk: a warp's 4 x 4 m16n8 tiles.  a_off[i]
// is the word offset of m-tile i's fragment row `g` (row g + 8 lies 8
// pixels on), b_off[j] that of n-tile j's output channel g, each already
// at channel pair t; a_tap and b_tap move them to the tap.
__device__ __forceinline__ void mma_tap(float (&acc)[4][4][4],
                                        const uint32_t* in_w,
                                        const uint32_t* w_w,
                                        const int (&a_off)[4],
                                        const int (&b_off)[4], int a_tap,
                                        int b_tap) {
  uint32_t bf[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bf[j][0] = w_w[b_tap + b_off[j]];
    bf[j][1] = w_w[b_tap + b_off[j] + 4];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t* p = in_w + a_tap + a_off[i];
    const uint32_t a0 = p[0], a2 = p[4];
    const uint32_t a1 = p[8 * kPixWords], a3 = p[8 * kPixWords + 4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
  }
}

// The bfloat16 form of conv3x3_kernel, rounded once to bfloat16 on store.
template <bool kShortcut>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ a, int ca,
                        const __nv_bfloat16* __restrict__ wa,
                        const __nv_bfloat16* __restrict__ x, int cx,
                        const __nv_bfloat16* __restrict__ wx,
                        const float* __restrict__ bias_a,
                        const float* __restrict__ bias_x,
                        __nv_bfloat16* __restrict__ out, int h, int w,
                        int cout, int tiles_x) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* w_s = in_s + kMmaInElems;
  const uint32_t* in_w = reinterpret_cast<const uint32_t*>(in_s);
  const uint32_t* w_w = reinterpret_cast<const uint32_t*>(w_s);

  const int y0 = (blockIdx.x / tiles_x) * kTileRows;
  const int x0 = (blockIdx.x % tiles_x) * kTileCols;
  const int n0 = blockIdx.y * kTileN;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;      // fragment row (pixel) / column (channel)
  const int t = lane & 3;       // channel pair within the fragment
  const int wr = 2 * (warp & 3);       // the warp's first tile row
  const int wn = 32 * (warp >> 2);     // the warp's first output channel
  const size_t img = static_cast<size_t>(h) * w;

  int a_off[4], b_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // m-tile i: tile row wr + i / 2, columns (i % 2) * 16 ..
    a_off[i] = ((wr + (i >> 1)) * kHaloCols + (i & 1) * 16 + g) * kPixWords + t;
    b_off[i] = (wn + i * 8 + g) * kPixWords + t;
  }
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
    }
  }

  const __nv_bfloat16* a_b = a + b * img * ca;
  for (int c0 = 0; c0 < ca; c0 += kChunk) {
    __syncthreads();  // the previous chunk has been consumed
    load_input_bf16(in_s, a_b, ca, c0, y0, x0, h, w, 1);
    load_weights_bf16(w_s, wa, 9, ca, c0, cout, n0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      mma_tap(acc, in_w, w_w, a_off, b_off,
              ((tap / 3) * kHaloCols + tap % 3) * kPixWords, tap * kTileN * kPixWords);
    }
  }

  if (kShortcut) {
    const __nv_bfloat16* x_b = x + b * img * cx;
    for (int c0 = 0; c0 < cx; c0 += kChunk) {
      __syncthreads();
      load_input_bf16(in_s, x_b, cx, c0, y0, x0, h, w, 0);
      load_weights_bf16(w_s, wx, 1, cx, c0, cout, n0);
      __syncthreads();
      mma_tap(acc, in_w, w_w, a_off, b_off, (kHaloCols + 1) * kPixWords, 0);
    }
  }

  // accumulator (i, j, k): pixel row g (k < 2) or g + 8 of m-tile i,
  // output channel 2 t + (k & 1) of n-tile j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oy = y0 + wr + (i >> 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + (i & 1) * 16 + g + 8 * half;
      if (oy >= h || ox >= w) continue;
      __nv_bfloat16* o = out + ((b * static_cast<size_t>(h) + oy) * w + ox) * cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          if (n < cout) {
            const float bias = kShortcut ? bias_a[n] + bias_x[n] : bias_a[n];
            o[n] = __float2bfloat16_rn(fmaxf(acc[i][j][2 * half + e] + bias, 0.f));
          }
        }
      }
    }
  }
}

template <bool kShortcut>
int launch_bf16(const __nv_bfloat16* a, int ca, const __nv_bfloat16* wa,
                const __nv_bfloat16* x, int cx, const __nv_bfloat16* wx,
                const float* bias_a, const float* bias_x, __nv_bfloat16* out,
                int batch, int h, int w, int cout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bf16_kernel<kShortcut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + kTileCols - 1) / kTileCols;
  const int tiles_y = (h + kTileRows - 1) / kTileRows;
  const dim3 grid(tiles_x * tiles_y, (cout + kTileN - 1) / kTileN, batch);
  conv3x3_bf16_kernel<kShortcut><<<grid, kThreads, kMmaSmemBytes, stream>>>(
      a, ca, wa, x, cx, wx, bias_a, bias_x, out, h, w, cout, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// One folded residual block: the argument checks, then conv1 into y1 and
// conv2 + the shortcut into out, through `Launch` (float32 or bfloat16).
template <typename T, int (*Launch1)(const T*, int, const T*, const T*, int,
                                      const T*, const float*, const float*,
                                      T*, int, int, int, int, cudaStream_t),
          int (*Launch2)(const T*, int, const T*, const T*, int, const T*,
                         const float*, const float*, T*, int, int, int, int,
                         cudaStream_t)>
int residual_block(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, void* y1, void* out, int batch, int h,
                   int w, int cin, int cout, int device, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || w < 1 || cin < 1 || cout < 1 ||
      (cout + kTileN - 1) / kTileN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = static_cast<long long>((w + kTileCols - 1) / kTileCols) *
                          ((h + kTileRows - 1) / kTileRows);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* y1t = static_cast<T*>(y1);
  int code = Launch1(xt, cin, static_cast<const T*>(w1), nullptr, 0, nullptr,
                     static_cast<const float*>(b1), nullptr, y1t, batch, h, w,
                     cout, s);
  if (code != 0) return code;
  return Launch2(y1t, cout, static_cast<const T*>(w2), xt, cin,
                 static_cast<const T*>(w3), static_cast<const float*>(b2),
                 static_cast<const float*>(b3), static_cast<T*>(out), batch, h,
                 w, cout, s);
}

}  // namespace

// One folded residual block on `stream`: x (B, H, W, cin), w1 (9, cin, C),
// w2 (9, C, C), w3 (cin, C), biases (C,), all float32 and contiguous; y1 is
// (B, H, W, C) scratch, out (B, H, W, C).  Returns a cudaError_t value, 0
// on success.  The Python wrapper checks devices, shapes and types.
extern "C" int k5_residual_block(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2,
                                 const void* w3, const void* b3, void* y1,
                                 void* out, int batch, int h, int w, int cin,
                                 int cout, int device, void* stream) {
  return residual_block<float, launch<false>, launch<true>>(
      x, w1, b1, w2, b2, w3, b3, y1, out, batch, h, w, cin, cout, device, stream);
}

// The same in bfloat16: x, w1, w2, w3, y1 and out bfloat16, the biases
// float32, and the weights laid out with the input channels last: w1
// (9, C, cin), w2 (9, C, C), w3 (C, cin).
extern "C" int k5_residual_block_bf16(const void* x, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, const void* w3,
                                      const void* b3, void* y1, void* out,
                                      int batch, int h, int w, int cin,
                                      int cout, int device, void* stream) {
  return residual_block<__nv_bfloat16, launch_bf16<false>, launch_bf16<true>>(
      x, w1, b1, w2, b2, w3, b3, y1, out, batch, h, w, cin, cout, device, stream);
}

extern "C" const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
