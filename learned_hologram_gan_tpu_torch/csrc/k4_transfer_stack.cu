// K4: the transfer-stack apply,
//
//   out[b, d, c] = g0[b, c] * exp(-2*pi*i * z_d * w[c]) * mask,
//
// g0 (B, C, Rp, Cp) complex64, w (C, Rp, Cp) float32, mask (Rp, Cp) float32,
// z (D,) float32 -> out (B, D, C, Rp, Cp) complex64, interleaved (re, im) as
// torch.view_as_real lays it out.  It replaces
// learned_hologram_gan_tpu/ops/pallas/transfer.py:_kernel (the
// pl.pallas_call at transfer.py:104, apply_transfer_stack).
//
// Numerics follow _kernel's float32 order exactly: theta = (f32(-2*pi) * z)
// * w with no FMA contraction, the full-precision sincosf (theta reaches
// ~1e4 rad, so this file must not be built with --use_fast_math), then
// (g0r*hr - g0i*hi) * m and (g0r*hi + g0i*hr) * m.
//
// What bounds it on this card: bytes.  At the training focal stack's shape
// (B 4, C 3, 1024^2, D 20) it writes 4*20*3*1024^2*8 B = 2.01 GB and reads
// ~0.06 GB (g0, the w-grid and the mask once): >= 0.64 ms at 3.35 TB/s.
// H depends on (d, c, pixel) only, so the sincos it needs are D*C*Rp*Cp,
// ~63 M here; evaluated once per output element, as a first kernel did,
// they were B times that, ~0.5 ms of issue that competed with the stores.
// Design: a thread owns two neighbouring pixels of one channel c; it reads
// their w, mask and the B images' g0 once (g0 in registers, kGroup images
// at a time), then for each distance computes H once and applies it to
// every image it holds, storing each image's two complex results as one
// 16-byte streaming store (st.global.cs: the output does not fit in the 50
// MB L2 and is not read back here).  A warp's store covers 512 contiguous
// bytes of one (b, d, c) plane.  Where Rp * Cp is odd a plane's pairs are
// not 16-byte aligned, and a thread owns one pixel instead (8-byte stores).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // images of g0 a thread holds in registers at once

// One pixel pair's (V = 2) or one pixel's (V = 1) complex values.
template <int V>
struct Cplx;
template <>
struct Cplx<2> {
  using T = float4;
};
template <>
struct Cplx<1> {
  using T = float2;
};

__device__ __forceinline__ void apply(float gr, float gi, float hr, float hi, float m, float& r,
                                      float& i) {
  r = __fmul_rn(__fsub_rn(__fmul_rn(gr, hr), __fmul_rn(gi, hi)), m);
  i = __fmul_rn(__fadd_rn(__fmul_rn(gr, hi), __fmul_rn(gi, hr)), m);
}

__device__ __forceinline__ void sincos_h(float sz, float w, float& hi, float& hr) {
#ifdef LHG_ABLATE_SINCOS  // a measurement build of k5_ablation.py: H = (w, sz), a wrong result
  hi = w;
  hr = sz;
#else
  sincosf(__fmul_rn(sz, w), &hi, &hr);
#endif
}

// Thread (blockIdx.x * kThreads + threadIdx.x) owns position idx < C * n_pos
// of channel c = idx / n_pos, pixels V p .. V p + V - 1, p = idx % n_pos.
template <int V>
__global__ void __launch_bounds__(kThreads)
    transfer_stack_kernel(const float2* __restrict__ g0, const float* __restrict__ w_grid,
                          const float* __restrict__ mask, const float* __restrict__ dists,
                          float2* __restrict__ out, int batch, int num_d, int channels,
                          int plane_size, float neg_two_pi) {
  using Vec = typename Cplx<V>::T;
  const int n_pos = plane_size / V;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(channels) * n_pos) return;
  const int c = static_cast<int>(idx / n_pos);
  const int px = static_cast<int>(idx - static_cast<long long>(c) * n_pos) * V;
  const size_t plane = static_cast<size_t>(plane_size);
  float w[V], m[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    w[v] = w_grid[c * plane + px + v];
    m[v] = mask[px + v];
  }
  for (int b0 = 0; b0 < batch; b0 += kGroup) {
    Vec g[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (b0 + j < batch) {
        g[j] = *reinterpret_cast<const Vec*>(g0 + ((b0 + j) * static_cast<size_t>(channels) + c) * plane + px);
      }
    }
    for (int d = 0; d < num_d; ++d) {
      const float sz = __fmul_rn(neg_two_pi, dists[d]);
      float hi[V], hr[V];
#pragma unroll
      for (int v = 0; v < V; ++v) sincos_h(sz, w[v], hi[v], hr[v]);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (b0 + j >= batch) break;
        const float* gv = reinterpret_cast<const float*>(&g[j]);
        Vec o;
        float* ov = reinterpret_cast<float*>(&o);
#pragma unroll
        for (int v = 0; v < V; ++v) apply(gv[2 * v], gv[2 * v + 1], hr[v], hi[v], m[v], ov[2 * v], ov[2 * v + 1]);
        __stcs(reinterpret_cast<Vec*>(
                   out + (((b0 + j) * static_cast<size_t>(num_d) + d) * channels + c) * plane + px),
               o);
      }
    }
  }
}

template <int V>
void launch(const void* g0, const void* w_grid, const void* mask, const void* dists, void* out,
            int batch, int num_d, int channels, int plane_size, float neg_two_pi, unsigned blocks,
            cudaStream_t stream) {
  transfer_stack_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float2*>(g0), static_cast<const float*>(w_grid),
      static_cast<const float*>(mask), static_cast<const float*>(dists),
      static_cast<float2*>(out), batch, num_d, channels, plane_size, neg_two_pi);
}

}  // namespace

// Launches K4 on `stream`.  Returns a cudaError_t value, 0 on success.  The
// Python wrapper checks devices, shapes, types and contiguity.
extern "C" int k4_transfer_stack(const void* g0, const void* w_grid,
                                 const void* mask, const void* dists, void* out,
                                 int batch, int num_d, int channels,
                                 int plane_size, float neg_two_pi, int device,
                                 void* stream) {
  if (batch < 1 || num_d < 1 || channels < 1 || plane_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v = plane_size % 2 == 0 ? 2 : 1;
  const long long blocks =
      (static_cast<long long>(channels) * (plane_size / v) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == 2) {
    launch<2>(g0, w_grid, mask, dists, out, batch, num_d, channels, plane_size, neg_two_pi,
              static_cast<unsigned>(blocks), s);
  } else {
    launch<1>(g0, w_grid, mask, dists, out, batch, num_d, channels, plane_size, neg_two_pi,
              static_cast<unsigned>(blocks), s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
