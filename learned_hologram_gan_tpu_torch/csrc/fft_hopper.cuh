// Register-resident FFT core for Hopper, shared by K1 and K2
// (k1_asm_propagate.cu: the row pass and its adjoint) and K3 (k3_fft.cu).
//
// A line of n = 2^m points is transformed by T = n / E threads that each
// hold E = min(n, 32) of its values in registers: thread j holds element
// j + T * c in v[c], on the way in and on the way out (natural order).
// The transform is a mixed-radix Stockham FFT (decimation in time), as the
// plan says (ops/cuda/fft_plan.py, built in float64 and rounded to
// complex64 by the wrapper): pass i of radix R = 2^lg_radix[i] and stride
// Ns = 2^lg_ns[i] takes butterfly jj < n / R from the elements
// jj + r * n / R, multiplies element r by w^(r * (jj mod Ns)),
// w = exp(-2 pi i / (Ns R)) (the plan's table), runs an R-point DFT in
// registers and hands element r on to (jj div Ns) Ns R + jj mod Ns + r Ns.
// Thread j runs butterflies jj = j + b T, b < E / R, with butterfly b's
// element r in v[b + r E / R].  Every pass but the last has radix 32, so a
// 1024-point line is two 32-point DFTs per thread with one exchange through
// shared memory, and no line needs more than two.
//
// An exchange stores element e at fft_plan.py:pad_index(e) (one gap of Ns after
// every Ns R values), scaled by the layout's stride: a half-warp's 8-byte
// accesses then fall on 16 distinct bank pairs, both when a pass writes and
// when the next one reads.  Each exchange is bracketed by two barriers of
// the line's threads (a warp's or the block's, as the caller says); the
// twiddles are read through the read-only cache, consecutive threads on
// consecutive entries.  Only forward transforms are run: the inverse is
// conj(F(conj(x))), which the callers fold into their loads and stores.

#pragma once

#include <cuda_runtime.h>

namespace lhg {
namespace hopper {

constexpr int kMaxPasses = 3;  // 16384 = 32 * 32 * 16, fft_plan.py:MAX_PASSES

// ops/cuda/fft_plan.py:plan_ints, field for field
struct FftPlan {
  int n, elems, threads, passes, buffer;
  int lg_radix[kMaxPasses];
  int lg_ns[kMaxPasses];
  int tw_off[kMaxPasses];
};

// The struct from plan_ints' 14 integers (host memory).
inline FftPlan plan_from_ints(const int* f) {
  static_assert(sizeof(FftPlan) == 14 * sizeof(int), "FftPlan must match plan_ints");
  FftPlan plan;
  plan.n = f[0];
  plan.elems = f[1];
  plan.threads = f[2];
  plan.passes = f[3];
  plan.buffer = f[4];
  for (int i = 0; i < kMaxPasses; ++i) {
    plan.lg_radix[i] = f[5 + i];
    plan.lg_ns[i] = f[5 + kMaxPasses + i];
    plan.tw_off[i] = f[5 + 2 * kMaxPasses + i];
  }
  return plan;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__host__ __device__ constexpr int log2_const(int n) {
  return n <= 1 ? 0 : 1 + log2_const(n >> 1);
}

// i's lowest `bits` bits reversed; a constant when i and bits are
__host__ __device__ __forceinline__ constexpr int bit_reverse(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r = (r << 1) | ((i >> b) & 1);
  return r;
}

// d * w_32^q, w_32 = exp(-2 pi i / 32), q < 16 (a constant once unrolled);
// (cos, sin)(2 pi q / 32) rounded to float32, as the CPU tests check
__device__ __forceinline__ float2 mul_w32(float2 d, int q) {
  constexpr float kCos[16] = {
      1.0f, 0.980785251f, 0.923879504f, 0.831469595f, 0.707106769f, 0.555570245f,
      0.382683426f, 0.195090324f, 0.0f, -0.195090324f, -0.382683426f,
      -0.555570245f, -0.707106769f, -0.831469595f, -0.923879504f, -0.980785251f};
  constexpr float kSin[16] = {
      0.0f, 0.195090324f, 0.382683426f, 0.555570245f, 0.707106769f, 0.831469595f,
      0.923879504f, 0.980785251f, 1.0f, 0.980785251f, 0.923879504f, 0.831469595f,
      0.707106769f, 0.555570245f, 0.382683426f, 0.195090324f};
  if (q == 0) return d;
  if (q == 8) return make_float2(d.y, -d.x);  // times -i
  const float c = kCos[q], s = kSin[q];
  return make_float2(d.x * c + d.y * s, d.y * c - d.x * s);
}

// One radix-2 decimation-in-frequency stage of span HALF over a[0..R),
// then the stages below it.
template <int R, int HALF>
struct DifStages {
  static __device__ __forceinline__ void run(float2 (&a)[R]) {
#pragma unroll
    for (int start = 0; start < R; start += 2 * HALF) {
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const float2 u = a[start + k];
        const float2 t = a[start + k + HALF];
        a[start + k] = make_float2(u.x + t.x, u.y + t.y);
        a[start + k + HALF] = mul_w32(make_float2(u.x - t.x, u.y - t.y), k * (16 / HALF));
      }
    }
    DifStages<R, HALF / 2>::run(a);
  }
};

template <int R>
struct DifStages<R, 0> {
  static __device__ __forceinline__ void run(float2 (&)[R]) {}
};

// Forward R-point DFT, in registers, of x[0], x[S], ..., x[(R-1) S]:
// radix-2 decimation in frequency, then the bit-reversed result renamed
// into natural order (no instructions once unrolled).
template <int R, int S>
__device__ __forceinline__ void dft(float2* x) {
  constexpr int kLog = log2_const(R);
  float2 a[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = x[i * S];
  DifStages<R, R / 2>::run(a);
#pragma unroll
  for (int i = 0; i < R; ++i) x[i * S] = a[bit_reverse(i, kLog)];
}

// The barrier of a line's threads: its warp's, or the block's.
struct LineSync {
  bool warp;
  __device__ __forceinline__ void operator()() const {
    if (warp) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
};

// Pass i of radix R.  The exchange positions are pad_index's, written as
// base + r * stride (the padding gap falls between the r's of a butterfly,
// never inside its stride): pass i writes element r of butterfly jj at
// ((jj >> lg_ns) << (lg_ns + log2 R)) + jj + r * Ns, and pass i reads its
// element r, jj + r n / R, at jj + ((jj >> lg_ns) << plg_ns) + r * (n / R +
// ((n / R) >> lg_ns) << plg_ns), where plg_ns is the previous pass's stride.
template <int E, int R>
__device__ __forceinline__ void run_pass(float2 (&v)[E], const FftPlan& p, int i, int j,
                                         float2* buf, int bs, const float2* __restrict__ tw,
                                         LineSync sync) {
  constexpr int B = E / R;
  constexpr int kLogR = log2_const(R);
  const int T = p.threads;
  const int lg_ns = p.lg_ns[i];
  const int ns = 1 << lg_ns;
  if (i > 0) {
    const int plg_ns = p.lg_ns[i - 1];
    const int span = p.n >> kLogR;
    const int stride = (span + ((span >> lg_ns) << plg_ns)) * bs;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int jj = j + b * T;
      const float2* src = buf + (jj + ((jj >> lg_ns) << plg_ns)) * bs;
#pragma unroll
      for (int r = 0; r < R; ++r) v[b + r * B] = src[r * stride];
    }
  }
  const float2* __restrict__ w = tw + p.tw_off[i];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    if (ns > 1) {
      const float2* __restrict__ wm = w + ((j + b * T) & (ns - 1));
#pragma unroll
      for (int r = 1; r < R; ++r) v[b + r * B] = cmul(v[b + r * B], __ldg(wm + (r - 1) * ns));
    }
    dft<R, B>(&v[b]);
  }
  if (i + 1 < p.passes) {
    sync();  // the previous reads of the buffer are done
    const int stride = ns * bs;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int jj = j + b * T;
      float2* dst = buf + (((jj >> lg_ns) << (lg_ns + kLogR)) + jj) * bs;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * stride] = v[b + r * B];
    }
    sync();  // the writes are visible to the next pass
  }
}

// Forward FFT of one line held as described at the top.  `buf` is the
// line's exchange (element position q at buf[q * bs]), `tw` the plan's
// twiddles on the device.  Every thread of the block must call it.
template <int E>
__device__ __forceinline__ void fft_line(float2 (&v)[E], const FftPlan& p, int j, float2* buf,
                                         int bs, const float2* __restrict__ tw, LineSync sync) {
#ifdef LHG_ABLATE_FFT
  return;  // a measurement build of fft_ablation.py: no transform, a wrong result
#endif
  for (int i = 0; i < p.passes; ++i) {
    switch (p.lg_radix[i]) {
      case 1: run_pass<E, 2>(v, p, i, j, buf, bs, tw, sync); break;
      case 2: if constexpr (E >= 4) run_pass<E, 4>(v, p, i, j, buf, bs, tw, sync); break;
      case 3: if constexpr (E >= 8) run_pass<E, 8>(v, p, i, j, buf, bs, tw, sync); break;
      case 4: if constexpr (E >= 16) run_pass<E, 16>(v, p, i, j, buf, bs, tw, sync); break;
      case 5: if constexpr (E >= 32) run_pass<E, 32>(v, p, i, j, buf, bs, tw, sync); break;
      default: break;
    }
  }
}

}  // namespace hopper
}  // namespace lhg
