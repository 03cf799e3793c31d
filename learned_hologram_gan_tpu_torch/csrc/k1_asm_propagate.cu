// K1: fused band-limited ASM propagation, forward (the row pass), and
// K2: its adjoint, the backward of K1.
//
// K1 replaces learned_hologram_gan_tpu/ops/pallas/spectral.py:_middle_pass
// (reduce_d=False) as called by _planes_fwd_impl.  The caller has already
// transformed the field along its columns; this kernel does, per plane p and
// distance d,
//
//   out[p, d] = crop_rows( IFFT_rows( S[p] * H(p, d) * mask ) ),
//   S[p] = FFT_rows( pad_rows(x[p]) )      (field mode: x is (P, rows, cp))
//   S[p] = x[p]                            (from_spectrum: x is (P, rp, cp))
//
// and the caller finishes with the inverse column transform and crop.  In
// per_plane mode D = 1 and plane p takes its distance from dists[p].
//
// K2 replaces the same pallas_call in its reduce_d=True form, as called by
// _planes_bwd_impl.  It applies the adjoint of K1's row pass to a cotangent
// g (P, D, rows, cp) that the caller has transformed along its columns:
//
//   out[p] = crop_rows( IFFT_rows( A[p] ) )        (field mode, (P, rows, cp))
//   out[p] = A[p] / rp                              (from_spectrum, (P, rp, cp))
//   A[p]   = sum_d conj(H(p, d)) * mask * FFT_rows( pad_rows(g[p, d]) )
//
// The FFT is linear, so the distance sum is taken in the spectrum: D forward
// transforms and one inverse, not 2D.
//
// Design of K1, for Hopper rather than the TPU's DFT-as-GEMM form:
//   * One block owns plane p and cpb neighbouring columns, interleaved
//     across the lanes: each row is read and written as a segment of
//     cpb * 8 bytes (64 at cpb = 8).  Only the `rows` nonzero rows are read
//     (padded rows r0..r0+rows-1); the zero padding never reaches memory.
//   * The rp-point FFTs along the rows run in registers on the core of
//     fft_hopper.cuh: at rp = 1024 each thread holds 32 values of its
//     column and does two 32-point DFTs with one exchange through shared
//     memory (interleaved by column, padded free of bank conflicts).  Any
//     other 2*3*5-smooth rp runs the same way on its own library, the plan
//     compiled in (1280 = 16 * 5 * 16 on E = 16, 1728 = 24 * 24 * 3, 2880 =
//     12 * 20 * 12 on E = 60), 8 columns a block wherever they fit (the plan's
//     LHG_FFT_MAX_THREADS and 227 KB: one block an SM at 2880).  The
//     spectrum comes out in natural order, in the order the inverse
//     transform takes its input: it is multiplied by the mask once, kept
//     in shared memory (thread-private slots) across the distances, and
//     multiplied by H, computed one value at a time, for each of them
//     (where the masked spectrum is not 0).  The inverse transform is
//     conj(F(conj(.))), folded into that multiply and the store, and only
//     the crop window [r0, r0+rows) is written.
// Design of K2, the mirror of K1 on the same core: one block owns plane p
// and cpb interleaved columns; per distance it reads the `rows` nonzero
// rows of the cotangent, runs the forward row FFT in registers
// (fft_hopper.cuh), stages the spectrum in thread-private shared-memory
// slots (the exchange's space, which no FFT is using then) and multiplies
// it by conj(H) * mask one value at a time, skipping H where the mask is
// 0.  The distance sum stays in those slots when D = 1 and in a second
// thread-private array, as K1 keeps `spec`, when D > 1.  Field mode
// finishes with one inverse, conj(F(conj(.))) folded into the multiply and
// the store, and writes only the crop window; from_spectrum stores the full
// spectrum scaled by 1 / rp straight from the multiply.
//
// H repeats the float32 operation order of spectral.py:_h_tile and
// asm.py:_w_grid exactly: fx = k * f32(1/(rp*pitch)), fx*fx + fy*fy (no FMA
// contraction), clamp, IEEE sqrt, theta = (f32(+-2pi) * z) * w, then the
// full-precision sincosf.  theta reaches ~1.4e4 rad, so this file must not
// be built with --use_fast_math.  K2 negates the f32 sign, which negates
// theta exactly: its H is the exact conjugate of K1's.  K2 multiplies H by
// the mask; K1 multiplies the spectrum by it, once for all distances, and
// skips H where that product is 0: the same result bit for bit with the
// plans' 0/1 masks, one rounding apart with a caller's fractional mask.
//
// Bound at the main path's inference shapes (P = 48 planes, rows = 384,
// rp = cp = 1024; one call with D = 1, one with D = 3): each call reads its
// (P, rows, cp) complex64 input once (151 MB) and writes D row-cropped
// outputs, ~0.91 GB in all or ~0.27 ms at 3.35 TB/s; its arithmetic (the
// row FFTs at 5 n log2 n, ~14 FLOP of H and complex multiply per element
// and distance where the mask is not 0) is ~1.7e10 FLOP or ~0.25 ms at 67
// TFLOP/s f32.  In training (from_spectrum, P = 24 planes, D = 1 per
// plane) the row pass needs the spectrum only inside the mask, 128 of its
// 201 MB at filter 0.45, and writes 75 MB: it is bound by bytes.  K2 is
// bound by bytes in every mode of the train step: at 24 planes
// from_spectrum + per_plane it reads the (24, 384, 1024) cotangent (75 MB)
// and writes the full spectrum (201 MB, 0 outside the mask), ~0.08 ms;
// the conj_h and two-H calls (12 planes, field) move ~0.08 GB, ~0.025 ms.
// Everything between the read and the write stays on chip.  The kernels'
// instructions outrun both counts: the full-precision sincosf of H is ~30
// an element and distance, and the DFTs' adds do not fuse into FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_hopper.cuh"

namespace {

using lhg::hopper::FftPlan;
using lhg::hopper::cmul;
using lhg::hopper::LineSync;
using lhg::hopper::fft_line;
using lhg::hopper::max_block_threads;  // K1's and K2's largest block (cpb * T)

// H at padded row k (fx) and padded column col (fy), for the plane's
// 1/lambda^2 `wl2_p` and sz = f32(+-2pi) * z.
__device__ __forceinline__ float2 h_transfer(int k, int col, int rp, int cp, float wl2_p,
                                             float sz, float inv_rp_pitch,
                                             float inv_cp_pitch) {
#ifdef LHG_ABLATE_H
  return make_float2(1.0f, 0.0f);  // a measurement build of fft_ablation.py: H = 1
#endif
  const int kr = k >= (rp + 1) / 2 ? k - rp : k;
  const int kc = col >= (cp + 1) / 2 ? col - cp : col;
  const float fx = __fmul_rn(static_cast<float>(kr), inv_rp_pitch);
  const float fy = __fmul_rn(static_cast<float>(kc), inv_cp_pitch);
  const float sq = __fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy));
  const float w = __fsqrt_rn(fmaxf(__fsub_rn(wl2_p, sq), 0.0f));
  const float theta = __fmul_rn(sz, w);
  float hs, hc;
  sincosf(theta, &hs, &hc);
  return make_float2(hc, hs);
}

// H * m, m the mask's value at (k, col) (no mask: H).
__device__ __forceinline__ float2 h_masked(int k, int col, int rp, int cp,
                                           float wl2_p, float sz,
                                           float inv_rp_pitch,
                                           float inv_cp_pitch, bool masked, float m) {
  float2 h = h_transfer(k, col, rp, cp, wl2_p, sz, inv_rp_pitch, inv_cp_pitch);
  if (masked) h = make_float2(__fmul_rn(h.x, m), __fmul_rn(h.y, m));
  return h;
}

// K1.  Thread t works on column col0 + t % cpb and holds, as thread
// j = t / cpb of that column's line, padded rows j + T c in v[c].  Its
// slot c in a thread-private array of shared memory is [c * blockDim + t]:
// `spec` (the spectrum, when D > 1) and `work` (the spectrum times H, in
// the exchange's space, which no FFT is using at the time).
#ifdef LHG_FFT_RADICES
template <int E, int kCpb>  // kCpb: one of the plan's compiled column counts
#else
template <int E>
#endif
__global__ void __launch_bounds__(LHG_FFT_LAUNCH_BOUND(E))  // max_block_threads(E)
asm_row_pass_kernel(const float2* __restrict__ x,      // (P, rows|rp, cp)
                    float2* __restrict__ out,          // (P, D, rows, cp)
                    const float* __restrict__ wl2,     // (P,)
                    const float* __restrict__ dists,   // (D,) or (P,)
                    const float* __restrict__ mask,    // (rp, cp) or null
                    const float2* __restrict__ twiddle,  // the plan's tables
                    const __grid_constant__ FftPlan plan, int cpb,
                    int rows, int cp, int rp, int r0, int num_d,
                    int from_spectrum, int per_plane, float inv_rp_pitch,
                    float inv_cp_pitch, float two_pi_signed) {
  extern __shared__ float2 smem[];
#ifdef LHG_FFT_RADICES
  cpb = kCpb;  // compiled in: the slots' and the exchange's strides are constants
  constexpr int nt = kCpb * FftPlan::threads;
#else
  const int nt = blockDim.x;
#endif
  const int T = plan.threads;
  const int t = threadIdx.x;
  const int l = t % cpb;
  const int j = t / cpb;
  const int p = blockIdx.y;
  const int col = blockIdx.x * cpb + l;
  const bool valid = col < cp;
  const int colc = valid ? col : cp - 1;  // a column to compute H at; not stored
  float2* work = smem;  // the exchange's space, at least rp values a column
  const int work_len = plan.buffer > rp ? plan.buffer : rp;
  float2* spec = num_d > 1 ? smem + static_cast<size_t>(cpb) * work_len : work;
  const LineSync sync{false};

  float2 v[E];
  if (from_spectrum) {
    const float2* xs = x + static_cast<size_t>(p) * rp * cp + colc;
#pragma unroll
    for (int c = 0; c < E; ++c) {
      const int k = j + c * T;
      v[c] = valid ? xs[static_cast<size_t>(k) * cp] : make_float2(0.f, 0.f);
    }
  } else {
    const float2* xp = x + static_cast<size_t>(p) * rows * cp + colc;
#pragma unroll
    for (int c = 0; c < E; ++c) {
      const int r = j + c * T - r0;
      v[c] = (valid && r >= 0 && r < rows) ? xp[static_cast<size_t>(r) * cp]
                                           : make_float2(0.f, 0.f);
    }
    fft_line<E>(v, plan, j, smem + l, cpb, twiddle, sync);
  }
  __syncthreads();  // the forward transform's exchange reads are done
  // the spectrum times the mask, once for all distances: in registers, or
  // where the values take most of them (a mixed-radix plan of E >= 48) to
  // the slots first and then the mask a value at a time, since its loads
  // issued beside the 2E registers of v spilled at E = 60
#ifdef LHG_FFT_RADICES
  constexpr bool kMaskFromSlots = E >= 48;
#else
  constexpr bool kMaskFromSlots = false;
#endif
  if constexpr (kMaskFromSlots) {
#pragma unroll
    for (int c = 0; c < E; ++c) spec[c * nt + t] = v[c];
    if (mask != nullptr) {
#pragma unroll 4
      for (int c = 0; c < E; ++c) {
        const float m = mask[static_cast<size_t>(j + c * T) * cp + colc];
        const float2 s = spec[c * nt + t];
        spec[c * nt + t] = make_float2(__fmul_rn(s.x, m), __fmul_rn(s.y, m));
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < E; ++c) {
      const float m = mask != nullptr ? mask[static_cast<size_t>(j + c * T) * cp + colc] : 1.0f;
      spec[c * nt + t] = mask != nullptr ? make_float2(__fmul_rn(v[c].x, m), __fmul_rn(v[c].y, m))
                                         : v[c];
    }
  }

  const float wl2_p = wl2[p];
  const float scale = 1.0f / static_cast<float>(rp);
  for (int d = 0; d < num_d; ++d) {
    if (d > 0) __syncthreads();  // the last inverse transform's exchange reads are done
    const int jd = lhg::hopper::loop_index(j);  // this distance's (fft_hopper.cuh)
    const float sz = __fmul_rn(two_pi_signed, per_plane ? dists[p] : dists[d]);
    // (S * mask) * H, conjugated for the inverse transform, one value at a
    // time (few registers); H is skipped where S * mask is 0
#pragma unroll 2
    for (int c = 0; c < E; ++c) {
      const float2 s = spec[c * nt + t];
      float2 z = make_float2(0.f, 0.f);
      if (s.x != 0.0f || s.y != 0.0f) {
        const float2 sh =
            cmul(s, h_transfer(jd + c * T, colc, rp, cp, wl2_p, sz, inv_rp_pitch, inv_cp_pitch));
        z = make_float2(sh.x, -sh.y);
      }
      work[c * nt + t] = z;
    }
#pragma unroll
    for (int c = 0; c < E; ++c) v[c] = work[c * nt + t];
    fft_line<E>(v, plan, jd, smem + l, cpb, twiddle, sync);
    if (valid) {
      float2* op = out + (static_cast<size_t>(p) * num_d + d) * rows * cp + col;
#pragma unroll
      for (int c = 0; c < E; ++c) {
        const int r = jd + c * T - r0;
        if (r >= 0 && r < rows) {
          op[static_cast<size_t>(r) * cp] = make_float2(v[c].x * scale, -v[c].y * scale);
        }
      }
    }
  }
}

// K2, laid out as K1: thread t holds padded rows j + T c of column
// col0 + t % cpb in v[c]; its slot c of a thread-private array is
// [c * blockDim + t]: `work` (the spectrum of the current distance, then
// the product or the conjugated sum that the inverse takes, in the
// exchange's space) and `acc` (the distance sum, when D > 1).
#ifdef LHG_FFT_RADICES
template <int E, int kCpb>  // kCpb: one of the plan's compiled column counts
#else
template <int E>
#endif
__global__ void __launch_bounds__(LHG_FFT_LAUNCH_BOUND(E))  // max_block_threads(E)
asm_row_adjoint_kernel(const float2* __restrict__ g,      // (P, D, rows, cp)
                       float2* __restrict__ out,          // (P, rows|rp, cp)
                       const float* __restrict__ wl2,     // (P,)
                       const float* __restrict__ dists,   // (D,) or (P,)
                       const float* __restrict__ mask,    // (rp, cp) or null
                       const float2* __restrict__ twiddle,  // the plan's tables
                       const __grid_constant__ FftPlan plan, int cpb,
                       int rows, int cp, int rp, int r0, int num_d,
                       int from_spectrum, int per_plane, float inv_rp_pitch,
                       float inv_cp_pitch, float two_pi_signed) {
  extern __shared__ float2 smem[];
#ifdef LHG_FFT_RADICES
  cpb = kCpb;  // compiled in: the slots' and the exchange's strides are constants
  constexpr int nt = kCpb * FftPlan::threads;
#else
  const int nt = blockDim.x;
#endif
  const int T = plan.threads;
  const int t = threadIdx.x;
  const int l = t % cpb;
  const int j = t / cpb;
  const int p = blockIdx.y;
  const int col = blockIdx.x * cpb + l;
  const bool valid = col < cp;
  const int colc = valid ? col : cp - 1;  // a column to read and compute H at; not stored
  float2* work = smem;  // the exchange's space, at least rp values a column
  const int work_len = plan.buffer > rp ? plan.buffer : rp;
  float2* acc = num_d > 1 ? smem + static_cast<size_t>(cpb) * work_len : work;
  const LineSync sync{false};
  const float wl2_p = wl2[p];
  const float conj_sign = -two_pi_signed;  // conj(H): theta negated exactly
  const float scale = 1.0f / static_cast<float>(rp);
  const bool masked = mask != nullptr;

  float2 v[E];
  for (int d = 0; d < num_d; ++d) {
    const int jd = lhg::hopper::loop_index(j);  // this distance's (fft_hopper.cuh)
    const float2* gp = g + (static_cast<size_t>(p) * num_d + d) * rows * cp + colc;
#pragma unroll
    for (int c = 0; c < E; ++c) {
      const int r = jd + c * T - r0;
      v[c] = (r >= 0 && r < rows) ? gp[static_cast<size_t>(r) * cp] : make_float2(0.f, 0.f);
    }
    fft_line<E>(v, plan, jd, smem + l, cpb, twiddle, sync);
    __syncthreads();  // the exchange's reads are done: its space holds `work`
#pragma unroll
    for (int c = 0; c < E; ++c) work[c * nt + t] = v[c];
    const float sz = __fmul_rn(conj_sign, per_plane ? dists[p] : dists[d]);
    const bool last = d + 1 == num_d;
    // spectrum * conj(H) * mask, one value at a time (few registers), H
    // skipped where the mask is 0; summed over the distances
#pragma unroll 2
    for (int c = 0; c < E; ++c) {
      const int k = jd + c * T;
      const float m = masked ? mask[static_cast<size_t>(k) * cp + colc] : 1.0f;
      float2 a = make_float2(0.f, 0.f);
      if (m != 0.0f) {
        a = cmul(work[c * nt + t],
                 h_masked(k, colc, rp, cp, wl2_p, sz, inv_rp_pitch, inv_cp_pitch, masked, m));
      }
      if (d > 0) {
        const float2 s = acc[c * nt + t];
        a = make_float2(s.x + a.x, s.y + a.y);
      }
      if (!last) {
        acc[c * nt + t] = a;
      } else if (from_spectrum) {
        if (valid) {
          out[(static_cast<size_t>(p) * rp + k) * cp + col] = make_float2(a.x * scale, a.y * scale);
        }
      } else {
        work[c * nt + t] = make_float2(a.x, -a.y);  // conjugated for the inverse
      }
    }
  }
  if (from_spectrum) return;
  // the inverse: conj(F(conj(sum))), only the crop window stored
#pragma unroll
  for (int c = 0; c < E; ++c) v[c] = work[c * nt + t];
  fft_line<E>(v, plan, j, smem + l, cpb, twiddle, sync);
  if (!valid) return;
  float2* op = out + static_cast<size_t>(p) * rows * cp + col;
#pragma unroll
  for (int c = 0; c < E; ++c) {
    const int r = j + c * T - r0;
    if (r >= 0 && r < rows) {
      op[static_cast<size_t>(r) * cp] = make_float2(v[c].x * scale, -v[c].y * scale);
    }
  }
}

struct Args {
  const float2* in;
  float2* out;
  const float* wl2;
  const float* dists;
  const float* mask;
  const float2* twiddle;
  int num_planes, rows, cp, rp, r0, num_d, from_spectrum, per_plane;
  float inv_rp_pitch, inv_cp_pitch, two_pi_signed;
};

bool valid_args(const Args& a) {
  return a.rp >= 2 && a.r0 >= 0 && a.rows + a.r0 <= a.rp &&
         a.num_planes <= 65535 && (!a.per_plane || a.num_d == 1);
}

// K1 or K2 (`kernel`): cpb columns of a plane to a block, the exchange's
// space (at least rp values a column) and, when D > 1, a second array of rp
// values a column in shared memory.
template <class Kernel>
int launch_kernel(Kernel kernel, const Args& a, const FftPlan& plan, int cpb, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cpb) *
                      ((plan.buffer > a.rp ? plan.buffer : a.rp) + (a.num_d > 1 ? a.rp : 0)) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.cp + cpb - 1) / cpb, a.num_planes);
  kernel<<<grid, cpb * plan.threads, smem, stream>>>(
      a.in, a.out, a.wl2, a.dists, a.mask, a.twiddle, plan, cpb, a.rows, a.cp, a.rp,
      a.r0, a.num_d, a.from_spectrum, a.per_plane, a.inv_rp_pitch,
      a.inv_cp_pitch, a.two_pi_signed);
  return static_cast<int>(cudaGetLastError());
}

// K1 (adjoint false) or K2 (true); a mixed-radix library has an
// instantiation for each column count its plan compiled in.
#ifdef LHG_FFT_RADICES
template <int E, int kCpb>
int launch_columns(bool adjoint, const Args& a, const FftPlan& plan, cudaStream_t stream) {
  return launch_kernel(adjoint ? asm_row_adjoint_kernel<E, kCpb> : asm_row_pass_kernel<E, kCpb>, a,
                       plan, kCpb, stream);
}

template <int E>
int launch_row(bool adjoint, const Args& a, const FftPlan& plan, int cpb, cudaStream_t stream) {
  using lhg::hopper::compiled::kK1Columns;
  using lhg::hopper::compiled::kK1KeptColumns;
  if constexpr (kK1Columns > 0) {
    if (cpb == kK1Columns) return launch_columns<E, kK1Columns>(adjoint, a, plan, stream);
  }
  if constexpr (kK1KeptColumns > 0 && kK1KeptColumns != kK1Columns) {
    if (cpb == kK1KeptColumns) return launch_columns<E, kK1KeptColumns>(adjoint, a, plan, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
template <int E>
int launch_row(bool adjoint, const Args& a, const FftPlan& plan, int cpb, cudaStream_t stream) {
  return launch_kernel(adjoint ? asm_row_adjoint_kernel<E> : asm_row_pass_kernel<E>, a, plan, cpb,
                       stream);
}
#endif

Args make_args(const void* in, void* out, const void* wl2, const void* dists,
               const void* mask, const void* twiddle, int num_planes, int rows,
               int cp, int rp, int r0, int num_d, int from_spectrum,
               int per_plane, float inv_rp_pitch, float inv_cp_pitch,
               float two_pi_signed) {
  return Args{static_cast<const float2*>(in), static_cast<float2*>(out),
              static_cast<const float*>(wl2), static_cast<const float*>(dists),
              static_cast<const float*>(mask), static_cast<const float2*>(twiddle),
              num_planes, rows, cp, rp, r0, num_d, from_spectrum, per_plane,
              inv_rp_pitch, inv_cp_pitch, two_pi_signed};
}

// Checks the arguments and the plan, then launches K1 or K2.
int launch(bool adjoint, const void* in, void* out, const void* wl2, const void* dists,
           const void* mask, const void* twiddle, const int* plan_ints, int num_planes,
           int rows, int cp, int rp, int r0, int num_d, int cpb, int from_spectrum,
           int per_plane, float inv_rp_pitch, float inv_cp_pitch, float two_pi_signed,
           int device, void* stream) {
  const Args a = make_args(in, out, wl2, dists, mask, twiddle, num_planes, rows,
                           cp, rp, r0, num_d, from_spectrum, per_plane,
                           inv_rp_pitch, inv_cp_pitch, two_pi_signed);
  const FftPlan plan = lhg::hopper::plan_from_ints(plan_ints);
#ifdef LHG_FFT_RADICES
  if (!lhg::hopper::plan_ints_match(plan_ints)) return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (!valid_args(a) || plan.n != rp || plan.elems * plan.threads != rp || cpb < 1 ||
      (cpb & (cpb - 1)) != 0 || cpb * plan.threads > max_block_threads(plan.elems)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LHG_K1_CASE(E) \
  case E:              \
    return launch_row<E>(adjoint, a, plan, cpb, s);
  switch (plan.elems) {
    LHG_FFT_KERNEL_ELEMS(LHG_K1_CASE)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LHG_K1_CASE
}

}  // namespace

// Launches K1 on `stream`.  Returns a cudaError_t value: 0 on success.
// x is (P, rows, cp), or (P, rp, cp) when from_spectrum; out is
// (P, num_d, rows, cp).  plan_ints (host memory) is fft_plan.py:plan_ints
// for rp and twiddle its tables on the device; cpb columns go to a block.
// The Python wrapper checks devices, shapes, types and contiguity, and picks
// cpb; this checks the plan against rp, rows + r0 <= rp and the block size.
extern "C" int k1_asm_row_pass(const void* x, void* out, const void* wl2,
                               const void* dists, const void* mask,
                               const void* twiddle, const int* plan_ints,
                               int num_planes, int rows, int cp, int rp, int r0,
                               int num_d, int cpb, int from_spectrum, int per_plane,
                               float inv_rp_pitch, float inv_cp_pitch,
                               float two_pi_signed, int device, void* stream) {
  return launch(false, x, out, wl2, dists, mask, twiddle, plan_ints, num_planes, rows, cp, rp,
                r0, num_d, cpb, from_spectrum, per_plane, inv_rp_pitch, inv_cp_pitch,
                two_pi_signed, device, stream);
}

// Launches K2 on `stream`, with K1's arguments and checks: g is
// (P, num_d, rows, cp); out is (P, rows, cp), or (P, rp, cp) when
// from_spectrum.  two_pi_signed is the forward's sign.
extern "C" int k2_asm_row_adjoint(const void* g, void* out, const void* wl2,
                                  const void* dists, const void* mask,
                                  const void* twiddle, const int* plan_ints,
                                  int num_planes, int rows, int cp, int rp, int r0,
                                  int num_d, int cpb, int from_spectrum, int per_plane,
                                  float inv_rp_pitch, float inv_cp_pitch,
                                  float two_pi_signed, int device, void* stream) {
  return launch(true, g, out, wl2, dists, mask, twiddle, plan_ints, num_planes, rows, cp, rp,
                r0, num_d, cpb, from_spectrum, per_plane, inv_rp_pitch, inv_cp_pitch,
                two_pi_signed, device, stream);
}

extern "C" const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
