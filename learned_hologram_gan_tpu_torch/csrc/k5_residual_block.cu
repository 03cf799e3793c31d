// K5: the eval-mode residual block with its BatchNorms folded,
//
//   out = relu( conv3x3(y1, w2) + b2 + conv1x1(x, w3) + b3 ),
//   y1  = relu( conv3x3(x, w1) + b1 ),
//
// NHWC, SAME padding, stride 1, float32 accumulation, in two element types,
// both as an implicit GEMM on the tensor cores (wgmma): float32, its
// products taken to near-float32 precision as three TF32 products each
// (below), and bfloat16 for x, the weights, y1 and the output, with float32
// biases.  In bfloat16 y1 is rounded once to bfloat16 (round to nearest
// even) as it is stored, and the output once, after the shortcut add and
// the final ReLU: the JAX kernel's roundings (conv_block.py:138, :169).  It
// replaces learned_hologram_gan_tpu/ops/pallas/conv_block.py:_block_kernel
// (the pl.pallas_call at conv_block.py:223), as nn/fused_unet.py:_block_eval
// calls it.
//
// What bounds it on this card: operations.  The full-width UNet (384^2,
// base 64, four levels) does ~219 GFLOP per image in its nine blocks,
// 2*H*W*(9*Cin*C + 9*C*C + Cin*C) each, so a batch of 16 is ~3.5 TFLOP.  In
// float32 the tensor cores take three TF32 passes of it: >= 21.3 ms at 495
// TFLOP/s (float32 FMAs outside the tensor cores could not pass 52 ms at 67
// TFLOP/s).  In bfloat16: >= 3.5 ms at 989 TFLOP/s.  Its activations, ~1.3
// GB at batch 16 in float32, take < 0.5 ms at 3.35 TB/s.
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
// ---- The implicit GEMM on wgmma --------------------------------------------
//
// GEMM view of one convolution: M = the B * H * W output pixels in their
// flattened (b, y, x) order, N = the output channels, K = the taps times
// the input channels of one or two segments (conv2 appends the 1x1
// shortcut's K to its own, so both sum into one set of accumulators).  A
// K atom is one 128-byte row: BK = 64 bfloat16 or 32 float32 values.  A
// segment's K runs chunk by chunk, tap by tap, channel by channel:
// kk = chunk * kchunk + tap * width + ci for channel chunk * width + ci,
// where width is BK channels, or all of them when there are fewer (enc_0's
// 4: the K step then spans taps, 9 * 4 = 36 values padded to 48 in
// bfloat16, to 40 in float32), and kchunk = taps * width padded to a
// multiple of one wgmma's K (32 bytes: 16 bfloat16, 8 TF32).  The wrapper
// lays the weights out as (cout, kseg) matrices in that order
// (ops/cuda/conv_block.py:gemm_weights) and picks the tile
// (conv_block.py:tiling); the CPU tests (tests/test_torch_k5_tiles.py)
// emulate this K order, the loads' zero fill, the shared-memory layout, the
// TF32 fragment and the split.
//
// A block of 384 threads is one producer warpgroup and two consumer
// warpgroups, persistent over tiles of 128 pixels x BN channels (BN = 64,
// 128 or, in bfloat16, 256: the widest that the output channels fill, as
// a wider tile reads each pixel's inputs fewer times).  Through a ring of stages in 192 KB of
// shared memory, each stage with an mbarrier that fills and one that empties:
//   * the producer fills a stage with the A tile (128 pixels x BK K) by
//     cp.async, 16 bytes a copy where the channels allow it (fewer bytes
//     where a segment's channel count is not a multiple of 16 bytes' worth;
//     2-byte loads when a bfloat16 count is odd), zero-filled (src-size 0)
//     outside the image (SAME padding), past the channels and past the last
//     pixel, each copy landing 128-byte swizzled: 16-byte chunk j of row r
//     at r * 128 + (j ^ (r % 8)) * 16, so that element (r, k) lies at
//     r * 128 + ((k / V) ^ (r % 8)) * 16 + (k % V) * size with V = 8
//     bfloat16 or 4 float32 values a chunk: the layout the wgmma
//     descriptors name.  The B atoms (BN channels x BK K each) come in one
//     bulk copy (cp.async.bulk, counted on the stage's barrier in bytes):
//     the wrapper lays the weights out atom by atom, already swizzled;
//   * each consumer warpgroup runs wgmma on its 64 rows, float32
//     accumulators in registers, then releases the stage;
//   * the epilogue adds the biases, applies the ReLU and stores (in
//     bfloat16 rounded once, 16 bytes a lane: the lanes of a quad trade
//     their channel pairs by shuffles; in float32 8 bytes a lane, a quad's
//     32 contiguous bytes); meanwhile the producer fills the next tile.
//
// bfloat16: A and B from shared memory (descriptors), m64nBNk16, four per
// atom, one stage's group in flight while the next is awaited.  A stage
// holds AT atoms of A and of B: two where BN <= 128 and K > 64 (atoms_for),
// so that a step's products outweigh its handshakes; the ring holds 4
// stages at BN = 256 (one atom), 3 at 128, 4 at 64 (two atoms).
//
// float32, split precision (3xTF32): a TF32 product keeps 10 of float32's
// 23 mantissa bits, ~5e-4 relative over a sum of thousands of terms, far
// outside float32's gates.  So each value is split into two TF32 values,
// x = x_hi + x_lo + O(2^-22 x), hi = rna(x), lo = rna(x - hi), rna being
// cvt.rna.tf32.f32 (round to nearest, ties away; never the tensor core's
// own truncation of the low 13 bits, which would bias every product the
// same way), and x * w = x_hi w_hi + x_hi w_lo + x_lo w_hi + O(2^-22 x w):
// three wgmma m64nBNk8 per 8 K (lo x B_hi, hi x B_lo, then hi x B_hi), each
// product exact.  The wrapper splits the weights once per call (B_hi and
// B_lo, one atom each a stage, in the one bulk copy); the consumers split
// the activations in registers: each thread reads its A fragment from the
// stage (rows 64 wg + 16 warp + g and + 8, K tq and tq + 4 of each 8, the
// m64k8 TF32 fragment) and rounds it into hi and lo.  TF32 takes K-major A
// and B only, which both are: NHWC puts the channels (K) innermost, and
// gemm_weights lays B out as (cout, K).
//   The tensor core adds its products into the accumulators with
// truncation; over the ~3,600 accumulating wgmma of a 1024-channel block's
// conv2 that read 1.8e-5 of max |out| at p99.9 on the card, over float32's
// 1e-5.  So a stage's 12 products go into partial sums of their own (the
// first with scale-d 0), which round-to-nearest adds then take into the
// tile's sums: the truncation acts on 32 K of products at a time.  The
// partial sums double the accumulators, so the tiles are 64 or 128
// channels wide (at 128: 64 + 64 accumulators and 32 fragment registers
// outgrow the 168 a thread of 384 gets, and the producer hands registers
// to the consumers, setmaxnreg 72 and 216).  One atom a stage (12 wgmma
// already outweigh a handshake): 4 stages at BN = 128 (16 KB of A, 32 KB
// of B_hi and B_lo), 6 at 64.  The fragment registers are read by the
// wgmma in flight, so a stage's group is waited for before the next
// stage's fragment is loaded; the other consumer warpgroup's products fill
// that gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels of a tile (M)
constexpr int kConsumers = 2;     // consumer warpgroups of 64 rows each
constexpr int kGemmThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * 128;  // an A atom: 128 rows of 128 bytes
constexpr int kRingBytes = 192 * 1024;
// K values of an atom (a 128-byte row): 64 bfloat16, 32 float32
template <typename T>
constexpr int kBK = static_cast<int>(128 / sizeof(T));
// K of one wgmma (32 bytes): 16 bfloat16, 8 TF32
template <typename T>
constexpr int kKStep = static_cast<int>(32 / sizeof(T));
// B atoms a K atom takes: one in bfloat16; B_hi and B_lo in float32
template <typename T>
constexpr int kSplit = sizeof(T) == 4 ? 2 : 1;
template <typename T>
constexpr int atoms_for(int bn, int ktot) {
  return sizeof(T) == 4 ? 1 : (bn == 256 || ktot <= kBK<T> ? 1 : 2);
}
template <typename T, int BN, int AT>
constexpr int kStageBytes = AT * (kABytes + kSplit<T> * BN * 128);
template <typename T, int BN, int AT>
constexpr int kStages = kRingBytes / kStageBytes<T, BN, AT>;
// float32 at BN = 128: registers the producer hands to the consumers
// (2 x 216 + 72 <= 512, the 64K registers of an SM over 128-thread groups)
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;

template <typename T>
struct Seg {
  const T* src;  // activations (B, H, W, cs)
  int cs, taps, width, kchunk, kseg, vec;
};

template <typename T>
struct ConvParams {
  Seg<T> seg[2];
  int nseg;
  int ktot;                  // the segments' kseg summed
  const T* wtiles;           // B: (n_tiles, steps * AT, split, BN, BK), as the stages hold it
  const float* bias_a;
  const float* bias_x;       // null, or the shortcut's bias (added to bias_a)
  T* out;                    // (B, H, W, cout)
  long long m_total;         // B * H * W
  long long tiles;           // m_tiles * n_tiles, n fastest
  int n_tiles, h, w, cout;
  int sync_loads;            // a bfloat16 segment's channel count is odd: 2-byte loads
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

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// acc = A (64 x 8: a0..a3, TF32 values in registers) * B (8 x 128, shared,
// desc_b) + (scale_d ? acc : 0), float32 accumulators in the wgmma fragment
// layout (64 a thread).
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// acc = A (64 x 8: a0..a3, TF32 values in registers) * B (8 x 64, shared,
// desc_b) + (scale_d ? acc : 0), float32 accumulators in the wgmma fragment
// layout (32 a thread).
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
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

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t* a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 128) {
    wgmma_tf32_n128(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
  } else {
    wgmma_tf32_n64(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
  }
}

// One K atom of this producer thread's part of the A tile at `a_s`: the V
// K values k_step + V q .. + V - 1 (V = 16 bytes' worth: 8 bfloat16, 4
// float32) of rows row0 + 16 r, r < 8, whose pixels and in-image taps are
// pix[r] and taps_in[r].  The V values lie in one segment (segments are
// multiples of one wgmma's K long) or past the last K (zeros).
template <typename T>
__device__ __forceinline__ void load_a_atom(const ConvParams<T>& p, uint32_t a_s, int k_step, int q,
                                            int row0, int swz, const long long (&pix)[8],
                                            const uint32_t (&taps_in)[8]) {
#ifdef LHG_ABLATE_A
  return;  // a measurement build of k5_ablation.py: A left as it was, a wrong result
#endif
  constexpr int kV = 16 / sizeof(T);
  const int kk = k_step + kV * q;
  const bool k_ok = kk < p.ktot;
  const bool second = p.nseg > 1 && kk >= p.seg[0].kseg;
  const Seg<T>& sg = p.seg[second ? 1 : 0];
  const int kl = kk - (second ? p.seg[0].kseg : 0);
  if (sg.width == kBK<T> && sg.vec == kV && k_ok) {
    // BK-channel chunks: the V values lie in one (chunk, tap), a 16-byte
    // copy a row (the segment need not start on an atom: conv2's own
    // segment is 9 C long)
    const int j = kl / kBK<T>;
    const int chunk = sg.taps == 9 ? j / 9 : j;
    const int tap = sg.taps == 9 ? j - 9 * chunk : 4;
    const int c = chunk * kBK<T> + (kl - j * kBK<T>);
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
  for (int e = 0; e < kV; e += sg.vec) {
    const int t = (rem + e) / sg.width;
    const int c = chunk * sg.width + (rem + e - t * sg.width);
    const bool ok = t < sg.taps && c < sg.cs;
    const int tap = sg.taps == 9 ? t : 4;
    const long long off = (static_cast<long long>(tap / 3 - 1) * p.w + (tap % 3 - 1)) * sg.cs + c;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const bool good = ok && ((taps_in[r] >> tap) & 1u);
      const T* src = good ? sg.src + (pix[r] * sg.cs + off) : sg.src;
      const uint32_t dst = a_s + (row0 + 16 * r) * 128 + swz + static_cast<int>(sizeof(T)) * e;
      if (sizeof(T) == 4 || sg.vec > 1) {
        cp_async_ca(dst, src, static_cast<int>(sizeof(T)) * sg.vec, good);
      } else {  // a single bfloat16: below cp.async's 4 bytes
        const unsigned short v = good ? *reinterpret_cast<const unsigned short*>(src) : 0;
        asm volatile("st.shared.b16 [%0], %1;\n" :: "r"(dst), "h"(v) : "memory");
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
template <typename T, int BN, int AT>
__device__ __forceinline__ void produce(const ConvParams<T>& p, uint8_t* smem, uint32_t full,
                                        uint32_t empty, int steps) {
  constexpr int kSt = kStages<T, BN, AT>;
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
      const int stage = static_cast<int>(it % kSt);
      mbar_wait_warp(empty + 8 * stage, (static_cast<uint32_t>(it / kSt) & 1) ^ 1);
      const uint32_t a_s = smem_u32(smem + stage * kStageBytes<T, BN, AT>);
      if (i == 0) {  // B: one copy of the step's atoms, which the wrapper laid out as the stage holds them
        constexpr int kBytes = kSplit<T> * AT * BN * 128;
#ifdef LHG_ABLATE_B  // a measurement build of k5_ablation.py: B left as it was, a wrong result
        mbar_arrive(full + 8 * stage);
#else
        mbar_arrive_expect_tx(full + 8 * stage, kBytes);
        bulk_copy(a_s + AT * kABytes,
                  reinterpret_cast<const uint8_t*>(p.wtiles) +
                      ((tile % p.n_tiles) * steps + s) * kBytes,
                  kBytes, full + 8 * stage);
#endif
      }
#pragma unroll
      for (int atom = 0; atom < AT; ++atom) {
        load_a_atom(p, a_s + atom * kABytes, (s * AT + atom) * kBK<T>, q, row0, swz, pix,
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
template <typename T>
__device__ __forceinline__ float bias_at(const ConvParams<T>& p, int n) {
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

// A bfloat16 consumer warpgroup (wg 0 or 1): rows 64 wg .. 64 wg + 63 of each tile.
template <int BN, int AT>
__device__ __forceinline__ void consume_bf16(const ConvParams<__nv_bfloat16>& p, uint8_t* smem,
                                             uint32_t full, uint32_t empty, int steps, int wg) {
  constexpr int kSt = kStages<__nv_bfloat16, BN, AT>;
  constexpr int kBK16 = kBK<__nv_bfloat16>;
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
      const int stage = static_cast<int>(it % kSt);
      mbar_wait_warp(full + 8 * stage, static_cast<uint32_t>(it / kSt) & 1);
      // the copies landed through the generic proxy; wgmma reads through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t a_s = smem_u32(smem + stage * kStageBytes<__nv_bfloat16, BN, AT>);
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
        for (int k = 0; k < kBK16 / 16; ++k) {  // + 32 bytes of K a step, + an atom's bytes an atom
          wgmma<BN>(acc, da + ((atom * kABytes) >> 4) + 2 * k,
                    db + ((atom * BN * 128) >> 4) + 2 * k);
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
#ifdef LHG_ABLATE_STORE  // a measurement build of k5_ablation.py: the stores skipped at run time
          if (p.m_total > 0) continue;
#endif
          if (m < p.m_total && n < p.cout) *reinterpret_cast<uint4*>(o + n) = v;
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

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// x = hi + lo + O(2^-22 x): hi = rna(x), lo = rna(x - hi), each a TF32
// value (the low 13 bits 0), rounded to nearest with ties away from zero.
// x - hi is exact in float32.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(__uint_as_float(x)));
  hi &= 0xFFFFE000u;
  const float r = __fsub_rn(__uint_as_float(x), __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
  lo &= 0xFFFFE000u;
}

// A float32 consumer warpgroup (wg 0 or 1): rows 64 wg .. 64 wg + 63 of
// each tile, three TF32 products per 8 K into a stage's partial sums, which
// round-to-nearest adds take into the tile's sums (the note at the top).
template <int BN>
__device__ __forceinline__ void consume_f32(const ConvParams<float>& p, uint8_t* smem, uint32_t full,
                                            uint32_t empty, int steps, int wg) {
  constexpr int kSt = kStages<float, BN, 1>;
  constexpr uint64_t kLo = (BN * 128) >> 4;  // B_lo after B_hi, in descriptor units
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  // the fragment's rows r = 64 wg + 16 warp + g and r + 8 (both with r % 8
  // = g), value tq of a 16-byte chunk
  const uint32_t a_off = (wg * 64 + warp * 16 + g) * 128 + tq * 4;
  float acc[BN / 2], part[BN / 2];
  long long it = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long m0 = (tile / p.n_tiles) * kBM;
    const int n0 = static_cast<int>(tile % p.n_tiles) * BN;
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[k] = 0.f;
    for (int s = 0; s < steps; ++s, ++it) {
      const int stage = static_cast<int>(it % kSt);
      mbar_wait_warp(full + 8 * stage, static_cast<uint32_t>(it / kSt) & 1);
      const uint32_t a_s = smem_u32(smem + stage * kStageBytes<float, BN, 1>);
      // the m64k8 fragment of each K step ks: a0 (r, 8 ks + tq), a1 (r + 8,
      // 8 ks + tq), a2 (r, 8 ks + tq + 4), a3 (r + 8, 8 ks + tq + 4); K
      // 8 ks + tq lies in 16-byte chunk 2 ks, + 4 in chunk 2 ks + 1
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const uint32_t chunk = static_cast<uint32_t>((2 * ks + (v >> 1)) ^ g);
          split_tf32(lds32(a_s + a_off + (v & 1) * 1024 + (chunk << 4)), hi[4 * ks + v],
                     lo[4 * ks + v]);
        }
      }
      const uint64_t db = smem_desc(a_s + kABytes);
      fence_operands(part);
      fence_operands(hi);
      fence_operands(lo);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#ifndef LHG_ABLATE_MMA  // a measurement build of k5_ablation.py: no products
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // + 32 bytes of B a step of 8 K; the first starts part
        wgmma_tf32<BN>(part, lo + 4 * ks, db + 2 * ks, ks > 0);
        wgmma_tf32<BN>(part, hi + 4 * ks, db + kLo + 2 * ks, 1);
        wgmma_tf32<BN>(part, hi + 4 * ks, db + 2 * ks, 1);
      }
#endif
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the fragment's registers and the stage's B stay in use until the
      // products are done
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
      fence_operands(hi);
      fence_operands(lo);
      if (leader) mbar_arrive(empty + 8 * stage);
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
    }

    // accumulator 4 j + 2 i + e: row 16 warp + g + 8 i, channel 8 j + 2 tq + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + wg * 64 + warp * 16 + g + 8 * i;
      if (m >= p.m_total) continue;
      float* o = p.out + m * p.cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * tq;
        if (n >= p.cout) continue;
        const float v0 = fmaxf(acc[4 * j + 2 * i] + bias_at(p, n), 0.f);
#ifdef LHG_ABLATE_STORE  // a measurement build of k5_ablation.py: the stores skipped at run time
        if (p.m_total > 0) continue;
#endif
        if ((p.cout & 1) == 0) {  // n even: 8-byte stores, a quad's 32 bytes contiguous
          *reinterpret_cast<float2*>(o + n) =
              make_float2(v0, fmaxf(acc[4 * j + 2 * i + 1] + bias_at(p, n + 1), 0.f));
        } else {
          o[n] = v0;
          if (n + 1 < p.cout) o[n + 1] = fmaxf(acc[4 * j + 2 * i + 1] + bias_at(p, n + 1), 0.f);
        }
      }
    }
  }
}

template <typename T, int BN, int AT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ ConvParams<T> p) {
  constexpr int kSt = kStages<T, BN, AT>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the stages 1024-byte aligned, as the 128-byte swizzle requires
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem + kSt * kStageBytes<T, BN, AT>);
  const uint32_t empty = full + 8 * kSt;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + 8 * s, 129);          // each producer thread's copies, and B's
      mbar_init(empty + 8 * s, kConsumers);  // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int steps = (p.ktot + AT * kBK<T> - 1) / (AT * kBK<T>);
  const int wg = threadIdx.x >> 7;
  constexpr bool kMoveRegs = sizeof(T) == 4 && BN == 128;
  if (wg == kConsumers) {
    if constexpr (kMoveRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    produce<T, BN, AT>(p, smem, full, empty, steps);
  } else {
    if constexpr (kMoveRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    if constexpr (sizeof(T) == 4) {
      consume_f32<BN>(p, smem, full, empty, steps, wg);
    } else {
      consume_bf16<BN, AT>(p, smem, full, empty, steps, wg);
    }
  }
}

template <typename T, int BN, int AT>
int launch_wgmma(const ConvParams<T>& p, int grid, cudaStream_t stream) {
  constexpr int kSt = kStages<T, BN, AT>;
  const size_t smem = 1024 + static_cast<size_t>(kSt) * kStageBytes<T, BN, AT> + 16 * kSt;
  cudaError_t err = cudaFuncSetAttribute(conv_wgmma_kernel<T, BN, AT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_wgmma_kernel<T, BN, AT><<<grid, kGemmThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A segment from the wrapper's four integers (width, kchunk, kseg, vec),
// checked against the rules of conv_block.py:segment.
template <typename T>
bool make_seg(Seg<T>* sg, const void* src, int cs, int taps, const int* f) {
  *sg = Seg<T>{static_cast<const T*>(src), cs, taps, f[0], f[1], f[2], f[3]};
  const int chunks = (cs + sg->width - 1) / sg->width;
  const int vec = sg->vec;
  return sg->width == (cs >= kBK<T> ? kBK<T> : cs) &&
         sg->kchunk == (taps * sg->width + kKStep<T> - 1) / kKStep<T> * kKStep<T> &&
         sg->kseg == chunks * sg->kchunk && vec >= 1 && vec <= 16 / static_cast<int>(sizeof(T)) &&
         (vec & (vec - 1)) == 0 && cs % vec == 0;
}

// One folded residual block in T: conv1 into y1, then conv2 + the shortcut
// into out (the entries below say what each argument holds).
template <typename T>
int residual_block(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* b3, void* y1, void* out, int batch, int h, int w, int cin,
                   int cout, const int* tiling, int device, void* stream) {
  const int bn = tiling[0], grid = tiling[1];
  if (batch < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || grid < 1 ||
      (bn != 64 && bn != 128 && (bn != 256 || sizeof(T) == 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvParams<T> c1{}, c2{};
  if (!make_seg(&c1.seg[0], x, cin, 9, tiling + 2) ||
      !make_seg(&c2.seg[0], y1, cout, 9, tiling + 6) ||
      !make_seg(&c2.seg[1], x, cin, 1, tiling + 10)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m_total = static_cast<long long>(batch) * h * w;
  const int n_tiles = (cout + bn - 1) / bn;
  ConvParams<T>* const convs[2] = {&c1, &c2};
  for (ConvParams<T>* c : convs) {
    c->nseg = c == &c1 ? 1 : 2;
    c->ktot = c->seg[0].kseg + (c->nseg > 1 ? c->seg[1].kseg : 0);
    c->m_total = m_total;
    c->tiles = (m_total + kBM - 1) / kBM * n_tiles;
    c->n_tiles = n_tiles;
    c->h = h;
    c->w = w;
    c->cout = cout;
    c->sync_loads = sizeof(T) == 2 && (c->seg[0].vec == 1 || (c->nseg > 1 && c->seg[1].vec == 1));
  }
  c1.wtiles = static_cast<const T*>(w1);
  c1.bias_a = static_cast<const float*>(b1);
  c1.out = static_cast<T*>(y1);
  c2.wtiles = static_cast<const T*>(w2);
  c2.bias_a = static_cast<const float*>(b2);
  c2.bias_x = static_cast<const float*>(b3);
  c2.out = static_cast<T*>(out);
  if (grid > c1.tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (const ConvParams<T>* c : convs) {
    int code;
    if constexpr (sizeof(T) == 4) {
      code = bn == 128 ? launch_wgmma<T, 128, 1>(*c, grid, s) : launch_wgmma<T, 64, 1>(*c, grid, s);
    } else {
      const bool two = atoms_for<T>(bn, c->ktot) == 2;
      code = bn == 256   ? launch_wgmma<T, 256, 1>(*c, grid, s)
             : bn == 128 ? (two ? launch_wgmma<T, 128, 2>(*c, grid, s)
                                : launch_wgmma<T, 128, 1>(*c, grid, s))
                         : (two ? launch_wgmma<T, 64, 2>(*c, grid, s)
                                : launch_wgmma<T, 64, 1>(*c, grid, s));
    }
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

// One folded residual block in float32 on `stream`: x (B, H, W, cin), y1
// (B, H, W, C) scratch and out (B, H, W, C), biases (C,), all float32 and
// contiguous.  w1 and w2 are the wrapper's B tiles
// (conv_block.py:weight_tiles, then the split): conv1's, and conv2's with
// the shortcut's K appended, each (n_tiles, steps, 2, BN, 32), the TF32
// values hi and lo of every (BN, 32) atom 128-byte swizzled as a stage
// holds them.  tiling (host memory) is conv_block.py:Tiling.ints: the tile
// width BN, the grid, then (width, kchunk, kseg, vec) of conv1's segment,
// conv2's and the shortcut's.  Returns a cudaError_t value, 0 on success.
// The Python wrapper checks devices, shapes and types.
extern "C" int k5_residual_block(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* b3, void* y1, void* out, int batch,
                                 int h, int w, int cin, int cout, const int* tiling, int device,
                                 void* stream) {
  return residual_block<float>(x, w1, b1, w2, b2, b3, y1, out, batch, h, w, cin, cout, tiling,
                               device, stream);
}

// The same block in bfloat16 (x, the weights, y1 and out; the biases
// float32): w1 and w2 are (n_tiles, steps, BN, 64) tiles of bfloat16.
extern "C" int k5_residual_block_bf16(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, const void* b3, void* y1,
                                      void* out, int batch, int h, int w, int cin, int cout,
                                      const int* tiling, int device, void* stream) {
  return residual_block<__nv_bfloat16>(x, w1, b1, w2, b2, b3, y1, out, batch, h, w, cin, cout,
                                       tiling, device, stream);
}

extern "C" const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
