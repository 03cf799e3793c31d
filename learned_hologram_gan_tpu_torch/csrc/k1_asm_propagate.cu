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
// Design, for Hopper rather than the TPU's DFT-as-GEMM form:
//   * One block owns plane p and TC neighbouring columns.  Its `rows`
//     nonzero rows are read once into shared memory at padded rows
//     r0..r0+rows-1; the zero padding never reaches device memory.
//   * The rp-point FFTs along the rows run in shared memory (radix-2, in
//     place, fft_radix2.cuh): rows are stored in bit-reversed order and come
//     out in natural order.  K1's stage-1 spectrum stays in shared memory
//     for all D distances; K2 accumulates its distance sum there.
//   * H * mask is computed in registers; only the crop window [r0, r0+rows)
//     is written (all rp rows for K2 in from_spectrum mode).
//   * In from_spectrum mode K1 needs one (rp, TC) buffer, not two: it reads
//     the spectrum rows straight from device memory (L2) per distance.
//
// H repeats the float32 operation order of spectral.py:_h_tile and
// asm.py:_w_grid exactly: fx = k * f32(1/(rp*pitch)), fx*fx + fy*fy (no FMA
// contraction), clamp, IEEE sqrt, theta = (f32(+-2pi) * z) * w, then the
// full-precision sincosf.  theta reaches ~1.4e4 rad, so this file must not
// be built with --use_fast_math.  K2 negates the f32 sign, which negates
// theta exactly: its H is the exact conjugate of K1's.
//
// Bound at the main path's inference shapes (P = 48 planes, rows = 384,
// rp = cp = 1024; one call with D = 1, one with D = 3): each call reads its
// (P, rows, cp) complex64 input once (151 MB) and writes D row-cropped
// outputs, ~0.91 GB in all or ~0.27 ms at 3.35 TB/s; its arithmetic (the
// row FFTs at 5 n log2 n, ~14 FLOP of H and complex multiply per element
// and distance) is ~1.8e10 FLOP or ~0.27 ms at 67 TFLOP/s f32.  In training
// (from_spectrum, P = 24 planes, D = 1 per plane) the row pass reads the
// full (P, rp, cp) spectrum, 201 MB, and writes 75 MB: it is bound by
// bytes.  Everything between the read and the write stays in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"

namespace {

using lhg::bit_reverse;
using lhg::cmul;
using lhg::fft_rows;
using lhg::log2_int;

constexpr int kThreads = 512;

// H * mask at padded row k (fx) and padded column col (fy), for the plane's
// 1/lambda^2 `wl2_p` and sz = f32(+-2pi) * z.
__device__ __forceinline__ float2 h_masked(int k, int col, int rp, int cp,
                                           float wl2_p, float sz,
                                           float inv_rp_pitch,
                                           float inv_cp_pitch,
                                           const float* __restrict__ mask) {
  const int kr = k >= (rp + 1) / 2 ? k - rp : k;
  const int kc = col >= (cp + 1) / 2 ? col - cp : col;
  const float fx = __fmul_rn(static_cast<float>(kr), inv_rp_pitch);
  const float fy = __fmul_rn(static_cast<float>(kc), inv_cp_pitch);
  const float sq = __fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy));
  const float w = __fsqrt_rn(fmaxf(__fsub_rn(wl2_p, sq), 0.0f));
  const float theta = __fmul_rn(sz, w);
  float hs, hc;
  sincosf(theta, &hs, &hc);
  if (mask != nullptr) {
    const float m = mask[static_cast<size_t>(k) * cp + col];
    hc = __fmul_rn(hc, m);
    hs = __fmul_rn(hs, m);
  }
  return make_float2(hc, hs);
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
asm_row_pass_kernel(const float2* __restrict__ x,      // (P, rows|rp, cp)
                    float2* __restrict__ out,          // (P, D, rows, cp)
                    const float* __restrict__ wl2,     // (P,)
                    const float* __restrict__ dists,   // (D,) or (P,)
                    const float* __restrict__ mask,    // (rp, cp) or null
                    const float2* __restrict__ twiddle,  // (rp / 2,)
                    int rows, int cp, int rp, int r0, int num_d,
                    int from_spectrum, int per_plane, float inv_rp_pitch,
                    float inv_cp_pitch, float two_pi_signed) {
  extern __shared__ float2 smem[];
  float2* tw = smem;                   // (rp / 2,) twiddles
  float2* work = smem + rp / 2;        // (rp, TC) per-distance buffer
  float2* spec = work + rp * TC;       // (rp, TC) stage-1 spectrum (field mode)

  const int p = blockIdx.y;
  const int col0 = blockIdx.x * TC;
  const int log2rp = log2_int(rp);
  const int shift = 32 - log2rp;

  for (int i = threadIdx.x; i < rp / 2; i += blockDim.x) tw[i] = twiddle[i];
  if (!from_spectrum) {
    for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
      spec[i] = make_float2(0.f, 0.f);
    }
    __syncthreads();
    const float2* xp = x + static_cast<size_t>(p) * rows * cp + col0;
    for (int i = threadIdx.x; i < rows * TC; i += blockDim.x) {
      const int r = i / TC;
      const int c = i % TC;
      spec[bit_reverse(r0 + r, shift) * TC + c] = xp[static_cast<size_t>(r) * cp + c];
    }
    __syncthreads();
    fft_rows<TC>(spec, tw, rp, log2rp, false);
  } else {
    __syncthreads();
  }

  const float wl2_p = wl2[p];
  const float scale = 1.0f / static_cast<float>(rp);
  const float2* xs = from_spectrum ? x + static_cast<size_t>(p) * rp * cp + col0 : x;
  for (int d = 0; d < num_d; ++d) {
    const float sz = __fmul_rn(two_pi_signed, per_plane ? dists[p] : dists[d]);
    for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
      const int k = i / TC;
      const int c = i % TC;
      const float2 s = from_spectrum ? xs[static_cast<size_t>(k) * cp + c] : spec[i];
      const float2 h = h_masked(k, col0 + c, rp, cp, wl2_p, sz, inv_rp_pitch,
                                inv_cp_pitch, mask);
      work[bit_reverse(k, shift) * TC + c] = cmul(s, h);
    }
    __syncthreads();
    fft_rows<TC>(work, tw, rp, log2rp, true);

    float2* op = out + (static_cast<size_t>(p) * num_d + d) * rows * cp + col0;
    for (int i = threadIdx.x; i < rows * TC; i += blockDim.x) {
      const int r = i / TC;
      const int c = i % TC;
      const float2 v = work[(r0 + r) * TC + c];
      op[static_cast<size_t>(r) * cp + c] = make_float2(v.x * scale, v.y * scale);
    }
    __syncthreads();
  }
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
asm_row_adjoint_kernel(const float2* __restrict__ g,    // (P, D, rows, cp)
                       float2* __restrict__ out,        // (P, rows|rp, cp)
                       const float* __restrict__ wl2,   // (P,)
                       const float* __restrict__ dists,  // (D,) or (P,)
                       const float* __restrict__ mask,  // (rp, cp) or null
                       const float2* __restrict__ twiddle,  // (rp / 2,)
                       int rows, int cp, int rp, int r0, int num_d,
                       int from_spectrum, int per_plane, float inv_rp_pitch,
                       float inv_cp_pitch, float two_pi_signed) {
  extern __shared__ float2 smem[];
  float2* tw = smem;                   // (rp / 2,) twiddles
  float2* work = smem + rp / 2;        // (rp, TC) per-distance buffer
  float2* acc = work + rp * TC;        // (rp, TC) distance sum, natural order

  const int p = blockIdx.y;
  const int col0 = blockIdx.x * TC;
  const int log2rp = log2_int(rp);
  const int shift = 32 - log2rp;

  for (int i = threadIdx.x; i < rp / 2; i += blockDim.x) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
    acc[i] = make_float2(0.f, 0.f);
  }

  const float wl2_p = wl2[p];
  const float conj_sign = -two_pi_signed;
  for (int d = 0; d < num_d; ++d) {
    for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
      work[i] = make_float2(0.f, 0.f);
    }
    __syncthreads();
    const float2* gp = g + (static_cast<size_t>(p) * num_d + d) * rows * cp + col0;
    for (int i = threadIdx.x; i < rows * TC; i += blockDim.x) {
      const int r = i / TC;
      const int c = i % TC;
      work[bit_reverse(r0 + r, shift) * TC + c] = gp[static_cast<size_t>(r) * cp + c];
    }
    __syncthreads();
    fft_rows<TC>(work, tw, rp, log2rp, false);

    const float sz = __fmul_rn(conj_sign, per_plane ? dists[p] : dists[d]);
    for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
      const int k = i / TC;
      const int c = i % TC;
      const float2 h = h_masked(k, col0 + c, rp, cp, wl2_p, sz, inv_rp_pitch,
                                inv_cp_pitch, mask);
      const float2 v = cmul(work[i], h);
      acc[i] = make_float2(acc[i].x + v.x, acc[i].y + v.y);
    }
    __syncthreads();
  }

  const float scale = 1.0f / static_cast<float>(rp);
  if (from_spectrum) {
    float2* op = out + static_cast<size_t>(p) * rp * cp + col0;
    for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
      const int k = i / TC;
      const int c = i % TC;
      op[static_cast<size_t>(k) * cp + c] = make_float2(acc[i].x * scale, acc[i].y * scale);
    }
    return;
  }
  for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
    const int k = i / TC;
    const int c = i % TC;
    work[bit_reverse(k, shift) * TC + c] = acc[i];
  }
  __syncthreads();
  fft_rows<TC>(work, tw, rp, log2rp, true);
  float2* op = out + static_cast<size_t>(p) * rows * cp + col0;
  for (int i = threadIdx.x; i < rows * TC; i += blockDim.x) {
    const int r = i / TC;
    const int c = i % TC;
    const float2 v = work[(r0 + r) * TC + c];
    op[static_cast<size_t>(r) * cp + c] = make_float2(v.x * scale, v.y * scale);
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

template <int TC, bool kAdjoint>
int launch(const Args& a, cudaStream_t stream) {
  const int buffers = (kAdjoint || !a.from_spectrum) ? 2 : 1;
  const size_t smem =
      (static_cast<size_t>(buffers) * a.rp * TC + a.rp / 2) * sizeof(float2);
  auto kernel = kAdjoint ? asm_row_adjoint_kernel<TC> : asm_row_pass_kernel<TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.cp / TC, a.num_planes);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.in, a.out, a.wl2, a.dists, a.mask, a.twiddle, a.rows, a.cp, a.rp,
      a.r0, a.num_d, a.from_spectrum, a.per_plane, a.inv_rp_pitch,
      a.inv_cp_pitch, a.two_pi_signed);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAdjoint>
int dispatch(const Args& a, int tc, int device, void* stream) {
  const int rp = a.rp;
  if (rp < 2 || (rp & (rp - 1)) != 0 || a.rows + a.r0 > rp || a.cp % tc != 0 ||
      a.num_planes > 65535 || (a.per_plane && a.num_d != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc) {
    case 4: return launch<4, kAdjoint>(a, s);
    case 2: return launch<2, kAdjoint>(a, s);
    case 1: return launch<1, kAdjoint>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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

}  // namespace

// Launches K1 on `stream`.  Returns a cudaError_t value: 0 on success.
// x is (P, rows, cp), or (P, rp, cp) when from_spectrum; out is
// (P, num_d, rows, cp).  The Python wrapper checks devices, shapes, types and
// contiguity; this checks rp a power of two, rows + r0 <= rp, cp % tc == 0.
extern "C" int k1_asm_row_pass(const void* x, void* out, const void* wl2,
                               const void* dists, const void* mask,
                               const void* twiddle, int num_planes, int rows,
                               int cp, int rp, int r0, int num_d, int tc,
                               int from_spectrum, int per_plane,
                               float inv_rp_pitch, float inv_cp_pitch,
                               float two_pi_signed, int device, void* stream) {
  const Args a = make_args(x, out, wl2, dists, mask, twiddle, num_planes, rows,
                           cp, rp, r0, num_d, from_spectrum, per_plane,
                           inv_rp_pitch, inv_cp_pitch, two_pi_signed);
  return dispatch<false>(a, tc, device, stream);
}

// Launches K2 on `stream`: g is (P, num_d, rows, cp); out is (P, rows, cp),
// or (P, rp, cp) when from_spectrum.  two_pi_signed is the forward's sign.
extern "C" int k2_asm_row_adjoint(const void* g, void* out, const void* wl2,
                                  const void* dists, const void* mask,
                                  const void* twiddle, int num_planes, int rows,
                                  int cp, int rp, int r0, int num_d, int tc,
                                  int from_spectrum, int per_plane,
                                  float inv_rp_pitch, float inv_cp_pitch,
                                  float two_pi_signed, int device, void* stream) {
  const Args a = make_args(g, out, wl2, dists, mask, twiddle, num_planes, rows,
                           cp, rp, r0, num_d, from_spectrum, per_plane,
                           inv_rp_pitch, inv_cp_pitch, two_pi_signed);
  return dispatch<true>(a, tc, device, stream);
}

extern "C" const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
