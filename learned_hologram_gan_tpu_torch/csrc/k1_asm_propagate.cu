// K1: fused band-limited ASM propagation, forward (the row pass).
//
// Replaces learned_hologram_gan_tpu/ops/pallas/spectral.py:_middle_pass
// (reduce_d=False) as called by _planes_fwd_impl.  The caller has already
// transformed the unpadded field along its columns (a (P, rows, cp) complex
// spectrum); this kernel does, per plane p and distance d,
//
//   out[p, d] = crop_rows( IFFT_rows( FFT_rows( pad_rows(x[p]) ) * H(p, d) * mask ) )
//
// and the caller finishes with the inverse column transform and crop.
//
// Design, for Hopper rather than the TPU's DFT-as-GEMM form:
//   * One block owns plane p and TC neighbouring columns.  The `rows`
//     nonzero rows are read once from device memory into shared memory at
//     padded rows r0..r0+rows-1; the zero padding is never stored in device
//     memory.
//   * The rp-point forward FFT along the rows runs in shared memory
//     (radix-2, in place: rows are stored in bit-reversed order, the result
//     comes out in natural order).  This stage-1 spectrum stays in shared
//     memory for all D distances.
//   * Per distance, H * mask is computed in registers, multiplied into a
//     second shared buffer (again in bit-reversed order), inverse-FFTed, and
//     only the crop window [r0, r0+rows) is written, scaled by 1/rp.
//   * Twiddles come from a host table computed in float64 and cast to f32.
//
// H repeats the float32 operation order of spectral.py:_h_tile and
// asm.py:_w_grid exactly: fx = k * f32(1/(rp*pitch)), fx*fx + fy*fy (no FMA
// contraction), clamp, IEEE sqrt, theta = (f32(+-2pi) * z) * w, then the
// full-precision sincosf.  theta reaches ~1.4e4 rad, so this file must not
// be built with --use_fast_math.
//
// Bound of this kernel alone at the main path's shapes (P = 48 planes,
// rows = 384, rp = cp = 1024; one call with D = 1, one with D = 3): each call
// reads its (P, rows, cp) complex64 input once (151 MB) and writes D
// row-cropped (P, rows, cp) outputs, 302 MB read + 604 MB written + the 4 MB
// mask, ~0.91 GB or ~0.27 ms at 3.35 TB/s.  Its arithmetic, 6 * P * cp
// 1024-point FFTs (5 n log2 n each) plus ~14 FLOP of H and complex multiply
// per element and distance, is ~1.8e10 FLOP or ~0.27 ms at 67 TFLOP/s f32.
// Everything between the read and the write stays in shared memory.  The
// bound that chip_smoke.py prints, k1_bound_ms, is that of the whole
// propagate_planes call, the column transforms included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bit_reverse(int k, int shift) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> shift);
}

// In-place radix-2 decimation-in-time FFT along the n rows of a (n, TC)
// row-major tile whose rows are stored in bit-reversed order.  The result is
// in natural order, unscaled.  tw[k] = (cos, sin)(2*pi*k/n), k < n/2.
template <int TC>
__device__ void fft_rows(float2* buf, const float2* tw, int n, int log2n,
                         bool inverse) {
  const int total = (n >> 1) * TC;
  for (int s = 1; s <= log2n; ++s) {
    const int h = 1 << (s - 1);
    const int tw_stride = n >> s;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int c = idx % TC;
      const int b = idx / TC;
      const int k = b & (h - 1);
      const int i = ((b >> (s - 1)) << s) + k;
      const int j = i + h;
      float2 w = tw[k * tw_stride];
      if (!inverse) w.y = -w.y;
      const float2 u = buf[i * TC + c];
      const float2 v = cmul(buf[j * TC + c], w);
      buf[i * TC + c] = make_float2(u.x + v.x, u.y + v.y);
      buf[j * TC + c] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
asm_row_pass_kernel(const float2* __restrict__ x,      // (P, rows, cp)
                    float2* __restrict__ out,          // (P, D, rows, cp)
                    const float* __restrict__ wl2,     // (P,)
                    const float* __restrict__ dists,   // (D,)
                    const float* __restrict__ mask,    // (rp, cp) or null
                    const float2* __restrict__ twiddle,  // (rp / 2,)
                    int rows, int cp, int rp, int log2rp, int r0, int num_d,
                    float inv_rp_pitch, float inv_cp_pitch,
                    float two_pi_signed) {
  extern __shared__ float2 smem[];
  float2* spec = smem;                 // (rp, TC) stage-1 spectrum
  float2* work = smem + rp * TC;       // (rp, TC) per-distance buffer
  float2* tw = smem + 2 * rp * TC;     // (rp / 2,) twiddles

  const int p = blockIdx.y;
  const int col0 = blockIdx.x * TC;
  const int shift = 32 - log2rp;

  for (int i = threadIdx.x; i < rp / 2; i += blockDim.x) tw[i] = twiddle[i];
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

  const float wl2_p = wl2[p];
  const int half_r = (rp + 1) / 2;
  const int half_c = (cp + 1) / 2;
  const float scale = 1.0f / static_cast<float>(rp);
  for (int d = 0; d < num_d; ++d) {
    const float sz = __fmul_rn(two_pi_signed, dists[d]);
    for (int i = threadIdx.x; i < rp * TC; i += blockDim.x) {
      const int k = i / TC;
      const int c = i % TC;
      const int col = col0 + c;
      const int kr = k >= half_r ? k - rp : k;
      const int kc = col >= half_c ? col - cp : col;
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
      work[bit_reverse(k, shift) * TC + c] = cmul(spec[i], make_float2(hc, hs));
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
int launch(const float2* x, float2* out, const float* wl2, const float* dists,
           const float* mask, const float2* twiddle, int num_planes, int rows,
           int cp, int rp, int log2rp, int r0, int num_d, float inv_rp_pitch,
           float inv_cp_pitch, float two_pi_signed, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(2) * rp * TC + rp / 2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      asm_row_pass_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cp / TC, num_planes);
  asm_row_pass_kernel<TC><<<grid, kThreads, smem, stream>>>(
      x, out, wl2, dists, mask, twiddle, rows, cp, rp, log2rp, r0, num_d,
      inv_rp_pitch, inv_cp_pitch, two_pi_signed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream`.  Returns a cudaError_t value: 0 on success.
// Requirements (checked by the Python wrapper): rp a power of two, cp % tc
// == 0, rows + r0 <= rp, all pointers on `device`, contiguous.
extern "C" int k1_asm_row_pass(const void* x, void* out, const void* wl2,
                               const void* dists, const void* mask,
                               const void* twiddle, int num_planes, int rows,
                               int cp, int rp, int r0, int num_d, int tc,
                               float inv_rp_pitch, float inv_cp_pitch,
                               float two_pi_signed, int device, void* stream) {
  int log2rp = 0;
  while ((1 << log2rp) < rp) ++log2rp;
  if ((1 << log2rp) != rp || log2rp < 1 || rows + r0 > rp || cp % tc != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* xc = static_cast<const float2*>(x);
  float2* oc = static_cast<float2*>(out);
  const float* w = static_cast<const float*>(wl2);
  const float* z = static_cast<const float*>(dists);
  const float* m = static_cast<const float*>(mask);
  const float2* t = static_cast<const float2*>(twiddle);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc) {
    case 4:
      return launch<4>(xc, oc, w, z, m, t, num_planes, rows, cp, rp, log2rp, r0,
                       num_d, inv_rp_pitch, inv_cp_pitch, two_pi_signed, s);
    case 2:
      return launch<2>(xc, oc, w, z, m, t, num_planes, rows, cp, rp, log2rp, r0,
                       num_d, inv_rp_pitch, inv_cp_pitch, two_pi_signed, s);
    case 1:
      return launch<1>(xc, oc, w, z, m, t, num_planes, rows, cp, rp, log2rp, r0,
                       num_d, inv_rp_pitch, inv_cp_pitch, two_pi_signed, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
