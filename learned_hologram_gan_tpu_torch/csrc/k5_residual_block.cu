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
// Two launches per block in both types.  The first writes y1 = relu(conv1
// + b1) to a scratch buffer the wrapper allocates; the second reads y1
// with a zero halo (exactly the SAME padding of conv2 on y1), accumulates
// conv2 and then the 1x1 shortcut on x into the same registers, adds b2 +
// b3 and applies the final ReLU.  The TPU kernel keeps y1 on chip in one
// residency; on this card y1's round trip is small beside the products
// (in bfloat16 2 x 302 MB at 384^2, ~0.2 ms; at 48^2 and below it stays in
// the 50 MB L2), so the split stays.
//
// float32 (a first, simple kernel): a direct 3x3 convolution tiled in
// shared memory, as an implicit GEMM over (pixels) x (output channels) x
// (9 taps x input channels).  A block owns an 8 x 32 tile of output pixels
// of one image and 64 output channels, 256 threads, and the input channels
// go through shared memory 16 at a time (the chunk of input with its
// 1-pixel halo, zeros outside the image as SAME padding, and the chunk's
// weights for the block's 64 channels).  The 32 lanes of a warp own 8
// neighbouring columns each (4 lanes per tile row), the 8 warps own 8
// output channels each, so a weight read from shared memory is a broadcast
// and each thread keeps 8 x 8 accumulators in registers.  The halo row
// stride is odd (35), so the lanes' rows start in distinct banks.  Per
// channel a thread reads 10 inputs per kernel row and reuses them over the
// 3 column taps: 30 input and 18 vector weight reads for 576 FMAs.  Every
// block shape of the UNet goes through the same loop; partial tiles and
// channel chunks are masked.
//
// bfloat16: an implicit GEMM on wgmma, fed by a ring of asynchronous
// copies (the section below says how).

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


// One folded residual block in float32: the argument checks, then conv1
// into y1 and conv2 + the shortcut into out.
int residual_block_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* b3, void* y1, void* out,
                       int batch, int h, int w, int cin, int cout, int device, void* stream) {
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
  const float* xt = static_cast<const float*>(x);
  float* y1t = static_cast<float*>(y1);
  int code = launch<false>(xt, cin, static_cast<const float*>(w1), nullptr, 0, nullptr,
                           static_cast<const float*>(b1), nullptr, y1t, batch, h, w, cout, s);
  if (code != 0) return code;
  return launch<true>(y1t, cout, static_cast<const float*>(w2), xt, cin,
                      static_cast<const float*>(w3), static_cast<const float*>(b2),
                      static_cast<const float*>(b3), static_cast<float*>(out), batch, h, w,
                      cout, s);
}


// ---- bfloat16 on the tensor cores: an implicit GEMM with wgmma ------------
//
// GEMM view of one convolution: M = the B * H * W output pixels in their
// flattened (b, y, x) order, N = the output channels, K = the taps times
// the input channels of one or two segments (conv2 appends the 1x1
// shortcut's K to its own, so both sum into one set of accumulators).  A
// segment's K runs chunk by chunk, tap by tap, channel by channel:
// kk = chunk * kchunk + tap * width + ci for channel chunk * width + ci,
// where width is 64 channels, or all of them when there are fewer (enc_0's
// 4: the K step then spans taps, 9 * 4 = 36 values padded to 48), and
// kchunk = taps * width padded to a multiple of 16.  The wrapper lays the
// weights out as (cout, kseg) matrices in that order
// (ops/cuda/conv_block.py:gemm_weights) and picks the tile
// (conv_block.py:bf16_tiling); the CPU tests emulate this K order, the
// loads' zero fill and the shared-memory layout.
//
// A block of 384 threads is one producer warpgroup and two consumer
// warpgroups, persistent over tiles of 128 pixels x BN channels (BN = 64,
// 128 or 256, the widest that the output channels fill).  Through a ring of
// kStages stages, each with an mbarrier that fills and one that empties:
//   * the producer fills a stage with the A tile (128 pixels x 64 K) by
//     cp.async, 16 bytes a copy where the channels allow it (8 or 4 where a
//     segment's channel count is 4 or 12; 2-byte loads when it is odd),
//     zero-filled (src-size 0) outside the image (SAME padding), past the
//     channels and past the last pixel, each copy landing 128-byte
//     swizzled: element (row, k) at row * 128 + ((k / 8) ^ (row % 8)) * 16 +
//     (k % 8) * 2, the layout the wgmma descriptors name.  The B atoms (BN
//     channels x 64 K each) come in one bulk copy (cp.async.bulk, counted
//     on the stage's barrier in bytes): the wrapper lays the weights out
//     atom by atom, already swizzled;
//   * each consumer warpgroup runs wgmma.mma_async m64nBNk16 on its 64
//     rows, four per atom, float32 accumulators in registers, one
//     stage's group in flight while it waits for the next, then releases
//     the stage;
//   * the epilogue adds the biases, applies the ReLU, rounds once to
//     bfloat16 and stores 16 bytes a lane (the lanes of a quad trade their
//     channel pairs by shuffles); meanwhile the producer fills the next
//     tile.

constexpr int kBM = 128;          // output pixels of a tile (M)
constexpr int kBK = 64;           // K of a stage: one 128-byte row of bf16
constexpr int kConsumers = 2;     // consumer warpgroups of 64 rows each
constexpr int kGemmThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 2;
// A stage holds AT K atoms of kBK (one 128-byte row each) of the A and
// the B tile: two where BN <= 128 and K > kBK (atoms_for), so that a
// step's products outweigh its handshakes; the ring, as many stages as
// 192 KB holds: 4 at BN = 256 (one atom), 3 at 128, 4 at 64 (two atoms).
constexpr int atoms_for(int bn, int ktot) { return bn == 256 || ktot <= kBK ? 1 : 2; }
template <int BN, int AT>
constexpr int kStageBytes = AT * (kABytes + BN * kBK * 2);
template <int BN, int AT>
constexpr int kStages = (192 * 1024) / kStageBytes<BN, AT>;

struct Seg {
  const __nv_bfloat16* src;  // activations (B, H, W, cs)
  int cs, taps, width, kchunk, kseg, vec;
};

struct ConvParams {
  Seg seg[2];
  int nseg;
  int ktot;                  // the segments' kseg summed
  const __nv_bfloat16* wtiles;  // B: (n_tiles, steps * AT, BN, 64), as the stages hold it
  const float* bias_a;
  const float* bias_x;       // null, or the shortcut's bias (added to bias_a)
  __nv_bfloat16* out;        // (B, H, W, cout)
  long long m_total;         // B * H * W
  long long tiles;           // m_tiles * n_tiles, n fastest
  int n_tiles, h, w, cout;
  int sync_loads;            // a segment's channel count is odd: 2-byte loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// mbar_wait, the warp converged again after it (for the aligned wgmma
// instructions that follow).
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// One arrival that also expects `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` contiguous bytes from global src to shared dst by the copy
// engine, counted on `bar` as they land.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The barrier counts this thread's arrival once all its cp.async so far land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// `bytes` (4, 8 or 16) from src to shared dst, zeros where `ok` is false.
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, int bytes, bool ok) {
  const int n = ok ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(dst), "l"(src), "r"(n) : "memory");
  }
}

// A K-major operand in shared memory, 128-byte swizzled: 8-row groups 1024
// bytes apart (the stride byte offset), the leading byte offset unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += A (64 x 16, shared, desc_a) * B (16 x 256, shared, desc_b), bf16 in,
// float32 accumulators in the wgmma fragment layout (128 a thread).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// acc += A (64 x 16, shared, desc_a) * B (16 x 128, shared, desc_b), bf16 in,
// float32 accumulators in the wgmma fragment layout (64 a thread).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// acc += A (64 x 16, shared, desc_a) * B (16 x 64, shared, desc_b), bf16 in,
// float32 accumulators in the wgmma fragment layout (32 a thread).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 256) {
    wgmma_n256(d, desc_a, desc_b);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, desc_a, desc_b);
  } else {
    wgmma_n64(d, desc_a, desc_b);
  }
}

// The producer warpgroup: thread i copies the 16-byte column q = i % 8 of
// rows i / 8 + 16 r of the A tile (r < 8) and of the B tile (r < BN / 16),
// so that a row's 128 bytes come from 8 neighbouring lanes.  Per tile it
// notes each of its rows' pixel and, as 9 bits, which of the stencil's
// taps land inside the image (bit dy * 3 + dx; bit 4, the centre, for the
// shortcut), so that a step costs an add, a bit test and a copy per row.
// A segment of 64-channel chunks (every UNet block but enc_0's 4 input
// channels) takes one (chunk, tap) a step; the others decode each copy's
// K index (taps spanned, ragged channels, odd channel counts).
// One K atom of this producer thread's part of the A tile at `a_s`: the 8
// K values k_step + 8 q .. + 7 of rows row0 + 16 r, r < 8, whose pixels
// and in-image taps are pix[r] and taps_in[r].  The 8 values lie in one
// segment (segments are multiples of 16 long) or past the last K (zeros).
__device__ __forceinline__ void load_a_atom(const ConvParams& p, uint32_t a_s, int k_step, int q,
                                            int row0, int swz, const long long (&pix)[8],
                                            const uint32_t (&taps_in)[8]) {
#ifdef LHG_ABLATE_A
  return;  // a measurement build of k5_ablation.py: A left as it was, a wrong result
#endif
  const int kk = k_step + 8 * q;
  const bool k_ok = kk < p.ktot;
  const bool second = p.nseg > 1 && kk >= p.seg[0].kseg;
  const Seg& sg = p.seg[second ? 1 : 0];
  const int kl = kk - (second ? p.seg[0].kseg : 0);
  if (sg.width == kBK && sg.vec == 8 && k_ok) {
    // 64-channel chunks: the 8 values lie in one (chunk, tap), a 16-byte
    // copy a row (the segment need not start on an atom: conv2's own
    // segment is 9 C long)
    const int j = kl / kBK;
    const int chunk = sg.taps == 9 ? j / 9 : j;
    const int tap = sg.taps == 9 ? j - 9 * chunk : 4;
    const int c = chunk * kBK + (kl - j * kBK);
    const bool c_ok = c < sg.cs;
    const long long off = (static_cast<long long>(tap / 3 - 1) * p.w + (tap % 3 - 1)) * sg.cs + c;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const bool good = c_ok && ((taps_in[r] >> tap) & 1u);
      cp_async_ca(a_s + (row0 + 16 * r) * 128 + swz,
                  good ? sg.src + (pix[r] * sg.cs + off) : sg.src, 16, good);
    }
    return;
  }
  if (!k_ok) {  // past the last K: zeros, 16 bytes a row
#pragma unroll
    for (int r = 0; r < 8; ++r) cp_async_ca(a_s + (row0 + 16 * r) * 128 + swz, sg.src, 16, false);
    return;
  }
  // fewer channels: each copy of vec channels decodes its own tap
  const int chunk = kl / sg.kchunk;
  const int rem = kl - chunk * sg.kchunk;
  for (int e = 0; e < 8; e += sg.vec) {
    const int t = (rem + e) / sg.width;
    const int c = chunk * sg.width + (rem + e - t * sg.width);
    const bool ok = t < sg.taps && c < sg.cs;
    const int tap = sg.taps == 9 ? t : 4;
    const long long off = (static_cast<long long>(tap / 3 - 1) * p.w + (tap % 3 - 1)) * sg.cs + c;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const bool good = ok && ((taps_in[r] >> tap) & 1u);
      const __nv_bfloat16* src = good ? sg.src + (pix[r] * sg.cs + off) : sg.src;
      const uint32_t dst = a_s + (row0 + 16 * r) * 128 + swz + 2 * e;
      if (sg.vec > 1) {
        cp_async_ca(dst, src, 2 * sg.vec, good);
      } else {
        const __nv_bfloat16 v = good ? *src : __float2bfloat16_rn(0.f);
        asm volatile("st.shared.b16 [%0], %1;\n" :: "r"(dst),
                     "h"(*reinterpret_cast<const unsigned short*>(&v)) : "memory");
      }
    }
  }
}

// The producer warpgroup: thread i copies the 16-byte column q = i % 8 of
// rows i / 8 + 16 r (r < 8) of each A atom, so that a row's 128 bytes come
// from 8 neighbouring lanes, and thread 0 issues the B tile's bulk copy.
// Per tile it notes each of its rows' pixel and, as 9 bits, which of the
// stencil's taps land inside the image (bit dy * 3 + dx; bit 4, the
// centre, for the shortcut), so that a copy costs an add and a bit test.
template <int BN, int AT>
__device__ __forceinline__ void produce(const ConvParams& p, uint8_t* smem, uint32_t full,
                                        uint32_t empty, int steps) {
  const int i = threadIdx.x - 128 * kConsumers;
  const int q = i & 7;
  const int row0 = i >> 3;
  const int swz = ((q ^ (row0 & 7)) << 4);  // row0 + 16 r has the same row % 8
  long long it = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long m0 = (tile / p.n_tiles) * kBM;
    long long pix[8];
    uint32_t taps_in[8];
    // the tile's first pixel (y0, x0) once; its rows m0 + k, k < 128, from it
    const long long hw = static_cast<long long>(p.h) * p.w;
    const int y0 = static_cast<int>((m0 % hw) / p.w), x0 = static_cast<int>(m0 % p.w);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = row0 + 16 * r;
      const int xs = x0 + k;
      const int y = (y0 + xs / p.w) % p.h, x = xs % p.w;
      const uint32_t cols = 0x2u | (x > 0 ? 0x1u : 0u) | (x + 1 < p.w ? 0x4u : 0u);
      const uint32_t rows = 0x2u | (y > 0 ? 0x1u : 0u) | (y + 1 < p.h ? 0x4u : 0u);
      uint32_t bits = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) bits |= ((rows >> dy) & 1u) ? cols << (3 * dy) : 0u;
      const bool in = m0 + k < p.m_total;
      pix[r] = in ? m0 + k : 0;
      taps_in[r] = in ? bits : 0u;
    }
    for (int s = 0; s < steps; ++s, ++it) {
      const int stage = static_cast<int>(it % kStages<BN, AT>);
      mbar_wait_warp(empty + 8 * stage, (static_cast<uint32_t>(it / kStages<BN, AT>) & 1) ^ 1);
      const uint32_t a_s = smem_u32(smem + stage * kStageBytes<BN, AT>);
      if (i == 0) {  // B: one copy of the tile, which the wrapper laid out as the stage holds it
        constexpr int kBytes = AT * BN * kBK * 2;
        mbar_arrive_expect_tx(full + 8 * stage, kBytes);
        bulk_copy(a_s + AT * kABytes,
                  p.wtiles + ((tile % p.n_tiles) * steps + s) * (AT * BN * kBK), kBytes,
                  full + 8 * stage);
      }
#pragma unroll
      for (int atom = 0; atom < AT; ++atom) {
        load_a_atom(p, a_s + atom * kABytes, (s * AT + atom) * kBK, q, row0, swz, pix,
                    taps_in);
      }
      if (p.sync_loads) {  // plain stores among the copies: wait, then arrive
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        mbar_arrive(full + 8 * stage);
      } else {
        cp_async_arrive(full + 8 * stage);
      }
    }
  }
}

// The epilogue's bias at channel n < cout: b1, or b2 + b3.
__device__ __forceinline__ float bias_at(const ConvParams& p, int n) {
  return p.bias_x != nullptr ? p.bias_a[n] + p.bias_x[n] : p.bias_a[n];
}

// relu(a), relu(b) rounded once each to bfloat16 (to nearest even), packed.
__device__ __forceinline__ uint32_t pack_relu(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x[k] for k < 4 without indexing the registers at run time.
__device__ __forceinline__ uint32_t pick(const uint32_t (&x)[4], int k) {
  return k == 0 ? x[0] : k == 1 ? x[1] : k == 2 ? x[2] : x[3];
}

// A consumer warpgroup (wg 0 or 1): rows 64 wg .. 64 wg + 63 of each tile.
template <int BN, int AT>
__device__ __forceinline__ void consume(const ConvParams& p, uint8_t* smem, uint32_t full,
                                        uint32_t empty, int steps, int wg) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  float acc[BN / 2];
  long long it = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long m0 = (tile / p.n_tiles) * kBM;
    const int n0 = static_cast<int>(tile % p.n_tiles) * BN;
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[k] = 0.f;
    int prev = -1;
    for (int s = 0; s < steps; ++s, ++it) {
      const int stage = static_cast<int>(it % kStages<BN, AT>);
      mbar_wait_warp(full + 8 * stage, static_cast<uint32_t>(it / kStages<BN, AT>) & 1);
      // the copies landed through the generic proxy; wgmma reads through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t a_s = smem_u32(smem + stage * kStageBytes<BN, AT>);
      const uint64_t da = smem_desc(a_s + wg * 64 * 128);
      const uint64_t db = smem_desc(a_s + AT * kABytes);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // all four K steps of 16, also past the last K, where A and B are
      // zero-filled (a wgmma in a branch would serialize them all)
#ifndef LHG_ABLATE_MMA  // a measurement build of k5_ablation.py: no products
#pragma unroll
      for (int atom = 0; atom < AT; ++atom) {
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {  // + 32 bytes of K a step, + an atom's bytes an atom
          wgmma<BN>(acc, da + ((atom * kABytes) >> 4) + 2 * k,
                    db + ((atom * BN * kBK * 2) >> 4) + 2 * k);
        }
      }
#endif
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_operands(acc);
      if (prev >= 0 && leader) mbar_arrive(empty + 8 * prev);  // its products are done
      prev = stage;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    if (leader) mbar_arrive(empty + 8 * prev);

    // accumulator 4 j + 2 i + e: row 16 warp + g + 8 i, channel 8 j + 2 tq + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + wg * 64 + warp * 16 + g + 8 * i;
      __nv_bfloat16* o = p.out + (m < p.m_total ? m : 0) * p.cout;
      if ((p.cout & 7) == 0) {
        // 16-byte stores: the quad's lanes trade their channel pairs so
        // that lane tq holds the 8 channels of block 4 jj + tq
#pragma unroll
        for (int jj = 0; jj < BN / 32; ++jj) {
          uint32_t pk[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 4 * jj + u;
            const int n = min(n0 + 8 * j + 2 * tq, p.cout - 2);
            pk[u] = pack_relu(acc[4 * j + 2 * i] + bias_at(p, n), acc[4 * j + 2 * i + 1] + bias_at(p, n + 1));
          }
          uint32_t got[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // round r: lane s sends pk[(s + r) % 4], gets lane (s - r)'s
            const int u = (tq + r) & 3;
            const uint32_t send = u == 0 ? pk[0] : u == 1 ? pk[1] : u == 2 ? pk[2] : pk[3];
            got[r] = __shfl_sync(0xffffffffu, send, (lane & ~3) | ((tq - r) & 3));
          }
          uint4 v;  // channel pair k of the block came from lane k, in round (tq - k) % 4
          v.x = pick(got, tq & 3);
          v.y = pick(got, (tq - 1) & 3);
          v.z = pick(got, (tq - 2) & 3);
          v.w = pick(got, (tq - 3) & 3);
          const int n = n0 + 8 * (4 * jj + tq);
#ifndef LHG_ABLATE_STORE  // a measurement build of k5_ablation.py: no stores
          if (m < p.m_total && n < p.cout) *reinterpret_cast<uint4*>(o + n) = v;
#endif
        }
      } else if (m < p.m_total) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * j + 2 * tq + e;
            if (n < p.cout) o[n] = __float2bfloat16_rn(fmaxf(acc[4 * j + 2 * i + e] + bias_at(p, n), 0.f));
          }
        }
      }
    }
  }
}

template <int BN, int AT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ ConvParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the stages 1024-byte aligned, as the 128-byte swizzle requires
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem + kStages<BN, AT> * kStageBytes<BN, AT>);
  const uint32_t empty = full + 8 * kStages<BN, AT>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages<BN, AT>; ++s) {
      mbar_init(full + 8 * s, 129);          // each producer thread's copies, and B's
      mbar_init(empty + 8 * s, kConsumers);  // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int steps = (p.ktot + AT * kBK - 1) / (AT * kBK);
  const int wg = threadIdx.x >> 7;
  if (wg == kConsumers) {
    produce<BN, AT>(p, smem, full, empty, steps);
  } else {
    consume<BN, AT>(p, smem, full, empty, steps, wg);
  }
}

template <int BN, int AT>
size_t wgmma_smem_bytes() {
  return 1024 + static_cast<size_t>(kStages<BN, AT>) * kStageBytes<BN, AT> + 16 * kStages<BN, AT>;
}

template <int BN, int AT>
int launch_wgmma(const ConvParams& p, int grid, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes<BN, AT>();
  cudaError_t err = cudaFuncSetAttribute(conv_wgmma_kernel<BN, AT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_wgmma_kernel<BN, AT><<<grid, kGemmThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A segment from the wrapper's four integers (width, kchunk, kseg, vec),
// checked against the rules of conv_block.py:segment.
bool make_seg(Seg* sg, const void* src, int cs, int taps, const int* f) {
  *sg = Seg{static_cast<const __nv_bfloat16*>(src), cs, taps, f[0], f[1], f[2], f[3]};
  const int chunks = (cs + sg->width - 1) / sg->width;
  const int vec = sg->vec;
  return sg->width == (cs >= kBK ? kBK : cs) && sg->kchunk == (taps * sg->width + 15) / 16 * 16 &&
         sg->kseg == chunks * sg->kchunk && (vec == 1 || vec == 2 || vec == 4 || vec == 8) &&
         cs % vec == 0;
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
  return residual_block_f32(x, w1, b1, w2, b2, w3, b3, y1, out, batch, h, w, cin, cout,
                            device, stream);
}

// The same block in bfloat16 (x, the weights, y1 and out; the biases
// float32), on the tensor cores.  w1 and w2 are the wrapper's B tiles
// (conv_block.py:weight_tiles): conv1's, and conv2's with the shortcut's
// K appended, each (n_tiles, steps, BN, 64) with every (BN, 64) tile
// 128-byte swizzled as a stage holds it.  tiling (host memory) is
// conv_block.py:Bf16Tiling.ints: the tile width BN, the grid, then (width,
// kchunk, kseg, vec) of conv1's segment, conv2's and the shortcut's.
extern "C" int k5_residual_block_bf16(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, const void* b3,
                                      void* y1, void* out, int batch, int h, int w, int cin,
                                      int cout, const int* tiling, int device, void* stream) {
  const int bn = tiling[0], grid = tiling[1];
  if (batch < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || grid < 1 ||
      (bn != 64 && bn != 128 && bn != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvParams c1{}, c2{};
  if (!make_seg(&c1.seg[0], x, cin, 9, tiling + 2) ||
      !make_seg(&c2.seg[0], y1, cout, 9, tiling + 6) ||
      !make_seg(&c2.seg[1], x, cin, 1, tiling + 10)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m_total = static_cast<long long>(batch) * h * w;
  const int n_tiles = (cout + bn - 1) / bn;
  ConvParams* const convs[2] = {&c1, &c2};
  for (ConvParams* c : convs) {
    c->nseg = c == &c1 ? 1 : 2;
    c->ktot = c->seg[0].kseg + (c->nseg > 1 ? c->seg[1].kseg : 0);
    c->m_total = m_total;
    c->tiles = (m_total + kBM - 1) / kBM * n_tiles;
    c->n_tiles = n_tiles;
    c->h = h;
    c->w = w;
    c->cout = cout;
    c->sync_loads = c->seg[0].vec == 1 || (c->nseg > 1 && c->seg[1].vec == 1);
  }
  c1.wtiles = static_cast<const __nv_bfloat16*>(w1);
  c1.bias_a = static_cast<const float*>(b1);
  c1.out = static_cast<__nv_bfloat16*>(y1);
  c2.wtiles = static_cast<const __nv_bfloat16*>(w2);
  c2.bias_a = static_cast<const float*>(b2);
  c2.bias_x = static_cast<const float*>(b3);
  c2.out = static_cast<__nv_bfloat16*>(out);
  if (grid > c1.tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (const ConvParams* c : convs) {
    const bool two = atoms_for(bn, c->ktot) == 2;
    const int code = bn == 256   ? launch_wgmma<256, 1>(*c, grid, s)
                     : bn == 128 ? (two ? launch_wgmma<128, 2>(*c, grid, s)
                                        : launch_wgmma<128, 1>(*c, grid, s))
                                 : (two ? launch_wgmma<64, 2>(*c, grid, s)
                                        : launch_wgmma<64, 1>(*c, grid, s));
    if (code != 0) return code;
  }
  return 0;
}

extern "C" const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
