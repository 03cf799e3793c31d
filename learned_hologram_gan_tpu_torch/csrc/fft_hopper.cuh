// Register-resident FFT core for Hopper, shared by K1 and K2
// (k1_asm_propagate.cu: the row pass and its adjoint) and K3 (k3_fft.cu).
//
// A line of n = 2^a 3^b 5^c points is transformed by T = n / E threads
// that each hold E of its values in registers: thread j holds element
// j + T * c in v[c], on the way in and on the way out (natural order).
// The transform is a mixed-radix Stockham FFT (decimation in time), as the
// plan says (ops/cuda/fft_plan.py, built in float64 and rounded to
// complex64 by the wrapper): pass i of radix R = radix[i] and stride
// Ns = ns[i] takes butterfly jj < n / R from the elements jj + r * n / R,
// multiplies element r by w^(r * (jj mod Ns)), w = exp(-2 pi i / (Ns R))
// (the plan's table), runs an R-point DFT in registers and hands element r
// on to (jj div Ns) Ns R + jj mod Ns + r Ns.  Thread j runs butterflies
// jj = j + b T, b < B = ceil(n / (R T)), with butterfly b's element r in
// slot b + r B.
//
// Powers of two (no LHG_FFT_RADICES): E = min(n, 32) and radix 32 for
// every pass but the last, so a 1024-point line is two 32-point DFTs per
// thread with one exchange through shared memory, and no such line needs
// more than two.  The library reads its radices and strides as log2 in a
// plan of 14 integers at run time and divides by Ns with shifts.
//
// Any other length: one library per plan, the plan compiled in
// (fft_plan.py:build_defines): LHG_FFT_ELEMS = E, LHG_FFT_RADICES and
// LHG_FFT_GAPS the radices and the exchanges' gaps as '.'-separated lists
// (read from their spelling at compile time), LHG_FFT_MAX_THREADS the
// kernels' block limit and LHG_FFT_COLUMNS the lines a block interleaves
// (K3 along axis -2, K1 and K2).  The passes unroll with constant radices,
// strides, twiddle offsets and divisions, and with the column count
// constant the exchange's and the thread-private slots' strides are too;
// the kernels' FftPlan is an empty struct whose static members are the
// plan's sizes.  The first and the last radix divide E (the loads' and the
// stores' natural order); a middle pass takes any radix and runs
// ceil(n / (R T)) butterflies a thread, the last one guarded where they do
// not divide evenly, so that a thread holds few values (1280 = 16 * 5 * 16:
// E = 16, T = 80, the radix-5 pass 4 butterflies a thread, 20 values).
//
// The register DFTs: a power of two by radix-2 decimation in frequency
// (constants of w_32); 3 and 5 by their direct formulas; any other radix
// R = P M (P = 5 or 3) as P-point DFTs at stride M, twiddles w_R^(n1 k2)
// (constants computed in double at compile time and rounded to float), then
// M-point DFTs, renamed into natural order (no instructions once unrolled).
//
// An exchange stores element e at fft_plan.py:pad_index(e) (a gap after
// every Ns R values: Ns for the powers of two, the plan's gap otherwise),
// scaled by the layout's stride: for powers of two a half-warp's 8-byte
// accesses then fall on 16 distinct bank pairs, both when a pass writes
// and when the next one reads (other lengths: the gap fft_plan.py's bank
// model picks, and the bound tests/test_torch_fft_plan.py states).  Each
// exchange is bracketed by two barriers of the line's threads (a warp's or
// the block's, as the caller says); the twiddles are read through the
// read-only cache, consecutive threads on consecutive entries.  Only
// forward transforms are run: the inverse is conj(F(conj(x))), which the
// callers fold into their loads and stores.

#pragma once

#include <cuda_runtime.h>
#include <string.h>

namespace lhg {
namespace hopper {

// The E a library instantiates its kernels for: the powers of two's, or the
// one E of its mixed-radix plan.  A thread may use up to 255 registers in a
// power-of-two library's blocks of at most 512 threads; a mixed-radix
// library's blocks hold at most LHG_FFT_MAX_THREADS (fft_plan.py:
// FftPlan.max_threads), its kernels' __launch_bounds__.
// K3's blocks of whole lines (axis -1) hold at most line_block_threads():
// the same in a power-of-two library, max(T, 128) in a mixed-radix one
// (fft_plan.py:FftPlan.line_threads), so that its register cap is not the
// interleaved columns'.
#ifdef LHG_FFT_RADICES
#define LHG_FFT_KERNEL_ELEMS(X) X(LHG_FFT_ELEMS)
#define LHG_FFT_LAUNCH_BOUND(E) LHG_FFT_MAX_THREADS
#define LHG_FFT_K3_LAUNCH_BOUND(E, kColumns) (kColumns ? LHG_FFT_MAX_THREADS : LHG_FFT_LINE_THREADS)
#else
#define LHG_FFT_KERNEL_ELEMS(X) X(32) X(16) X(8) X(4) X(2)
#define LHG_FFT_LAUNCH_BOUND(E) E > 32 ? 256 : 512
#define LHG_FFT_K3_LAUNCH_BOUND(E, kColumns) E > 32 ? 256 : 512
__host__ __device__ constexpr int max_block_threads(int elems) { return elems > 32 ? 256 : 512; }
__host__ __device__ constexpr int line_block_threads(int elems) { return elems > 32 ? 256 : 512; }
#endif

#ifdef LHG_FFT_RADICES
#define LHG_FFT_STR2(x) #x
#define LHG_FFT_STR(x) LHG_FFT_STR2(x)

// The count of a '.'-separated list of decimal integers, and its item i
__host__ __device__ constexpr int list_size(const char* s) {
  int count = 1;
  for (; *s; ++s) count += *s == '.';
  return count;
}

__host__ __device__ constexpr int list_item(const char* s, int i) {
  int value = 0;
  for (; *s; ++s) {
    if (*s == '.') {
      if (i-- == 0) return value;
      value = 0;
    } else {
      value = 10 * value + (*s - '0');
    }
  }
  return i == 0 ? value : -1;
}

// The plan compiled into this library, as fft_plan.py:make_plan builds it
namespace compiled {
__host__ __device__ constexpr int radix(int i) { return list_item(LHG_FFT_STR(LHG_FFT_RADICES), i); }
__host__ __device__ constexpr int gap(int i) { return list_item(LHG_FFT_STR(LHG_FFT_GAPS), i); }
constexpr int kPasses = list_size(LHG_FFT_STR(LHG_FFT_RADICES));
__host__ __device__ constexpr int stride(int i) {  // Ns_i
  int ns = 1;
  for (int k = 0; k < i; ++k) ns *= radix(k);
  return ns;
}
constexpr int kN = stride(kPasses);
constexpr int kElems = LHG_FFT_ELEMS;
constexpr int kThreads = kN / kElems;
// the lines a block interleaves (fft_plan.py:FftPlan.columns): K3 along
// axis -2, K1 / K2 with D = 1, and with their second array (0: none fits)
constexpr int kK3Columns = list_item(LHG_FFT_STR(LHG_FFT_COLUMNS), 0);
constexpr int kK1Columns = list_item(LHG_FFT_STR(LHG_FFT_COLUMNS), 1);
constexpr int kK1KeptColumns = list_item(LHG_FFT_STR(LHG_FFT_COLUMNS), 2);
__host__ __device__ constexpr int tw_offset(int i) {  // pass i's table (0 where Ns = 1)
  int offset = 0;
  for (int k = 0; k < i; ++k) offset += stride(k) > 1 ? (radix(k) - 1) * stride(k) : 0;
  return stride(i) > 1 ? offset : 0;
}
__host__ __device__ constexpr int buffer() {  // fft_plan.py: the padded exchange of a line
  int b = 0;
  for (int i = 0; i + 1 < kPasses; ++i) {
    const int last = kN - 1 + gap(i) * ((kN - 1) / stride(i + 1)) + 1;
    b = last > b ? last : b;
  }
  return b ? b + ((kThreads - b) % 16 + 16) % 16 : 0;
}
static_assert(kN % kElems == 0 && kN >= 2 && kPasses <= 6, "a plan of fft_plan.py");
static_assert(kElems % radix(0) == 0 && kElems % radix(kPasses - 1) == 0,
              "the first and the last radix divide E");
}  // namespace compiled

#define LHG_FFT_LINE_THREADS \
  (::lhg::hopper::compiled::kThreads > 128 ? ::lhg::hopper::compiled::kThreads : 128)
__host__ __device__ constexpr int max_block_threads(int) { return LHG_FFT_MAX_THREADS; }
__host__ __device__ constexpr int line_block_threads(int) { return LHG_FFT_LINE_THREADS; }

// The kernels' plan argument: empty, its sizes static members
struct FftPlan {
  static constexpr int n = compiled::kN;
  static constexpr int elems = compiled::kElems;
  static constexpr int threads = compiled::kThreads;
  static constexpr int passes = compiled::kPasses;
  static constexpr int buffer = compiled::buffer();
};

// The struct from plan_ints' integers (host memory): nothing to read
inline FftPlan plan_from_ints(const int*) { return FftPlan{}; }

// True if plan_ints' head (n, elems, threads, passes, buffer) is this
// library's plan: a wrapper that loaded another plan's library is refused.
inline bool plan_ints_match(const int* f) {
  return f[0] == FftPlan::n && f[1] == FftPlan::elems && f[2] == FftPlan::threads &&
         f[3] == FftPlan::passes && f[4] == FftPlan::buffer;
}
#else
// ops/cuda/fft_plan.py:plan_ints, field for field
constexpr int kMaxPasses = 3;  // 16384 = 32 * 32 * 16, fft_plan.py:POW2_MAX_PASSES
struct FftPlan {
  int n, elems, threads, passes, buffer;
  int lg_radix[kMaxPasses];
  int lg_ns[kMaxPasses];
  int tw_off[kMaxPasses];
};
static_assert(sizeof(FftPlan) == 14 * sizeof(int), "FftPlan must match plan_ints");

// The struct from plan_ints' integers (host memory).
inline FftPlan plan_from_ints(const int* f) {
  FftPlan plan;
  memcpy(&plan, f, sizeof(FftPlan));
  return plan;
}
#endif

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

// Forward R-point DFT, in registers, of a[0..R) for R a power of two:
// radix-2 decimation in frequency, then the bit-reversed result renamed
// into natural order (no instructions once unrolled).
template <int R>
__device__ __forceinline__ void dft_pow2(float2 (&a)[R]) {
  constexpr int kLog = log2_const(R);
  DifStages<R, R / 2>::run(a);
  float2 b[R];
#pragma unroll
  for (int i = 0; i < R; ++i) b[i] = a[bit_reverse(i, kLog)];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = b[i];
}

// cos and sin in double by their Taylor series, |x| <= pi, for constants
// computed at compile time (error ~1e-16 before the rounding to float)
__host__ __device__ constexpr double taylor_sin(double x) {
  double term = x, sum = x;
  for (int k = 1; k < 30; ++k) {
    term *= -x * x / ((2 * k) * (2 * k + 1));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double taylor_cos(double x) {
  double term = 1.0, sum = 1.0;
  for (int k = 1; k < 30; ++k) {
    term *= -x * x / ((2 * k - 1) * (2 * k));
    sum += term;
  }
  return sum;
}

// (cos, sin)(2 pi q / R), q < R, rounded to float (the angle taken in
// (-pi, pi]), as the CPU tests check
template <int R>
struct RootTable {
  float c[R];
  float s[R];
};

template <int R>
__host__ __device__ constexpr RootTable<R> make_root_table() {
  RootTable<R> t{};
  for (int q = 0; q < R; ++q) {
    const int qq = 2 * q > R ? q - R : q;
    const double x = 2.0 * 3.14159265358979323846 * qq / R;
    t.c[q] = static_cast<float>(taylor_cos(x));
    t.s[q] = static_cast<float>(taylor_sin(x));
  }
  return t;
}

// d * w_R^q, w_R = exp(-2 pi i / R), q < R (a constant once unrolled); the
// quarter turns exact
template <int R>
__device__ __forceinline__ float2 mul_root(float2 d, int q) {
  constexpr RootTable<R> kRoots = make_root_table<R>();
  if (q == 0) return d;
  if (2 * q == R) return make_float2(-d.x, -d.y);
  if (4 * q == R) return make_float2(d.y, -d.x);      // times -i
  if (4 * q == 3 * R) return make_float2(-d.y, d.x);  // times +i
  const float c = kRoots.c[q], s = kRoots.s[q];
  return make_float2(d.x * c + d.y * s, d.y * c - d.x * s);
}

// Forward R-point DFT of a[0..R) in place, natural order in and out, for
// R = 2^a 3^b 5^c (the header's comment).
template <int R>
__device__ __forceinline__ void dft_regs(float2 (&a)[R]) {
  if constexpr ((R & (R - 1)) == 0) {
    dft_pow2<R>(a);
  } else if constexpr (R == 3) {
    constexpr float kS3 = 0.866025388f;  // sin(2 pi / 3)
    const float2 s = make_float2(a[1].x + a[2].x, a[1].y + a[2].y);
    const float2 d = make_float2(a[1].x - a[2].x, a[1].y - a[2].y);
    const float2 m = make_float2(a[0].x - 0.5f * s.x, a[0].y - 0.5f * s.y);
    a[0] = make_float2(a[0].x + s.x, a[0].y + s.y);
    a[1] = make_float2(m.x + kS3 * d.y, m.y - kS3 * d.x);
    a[2] = make_float2(m.x - kS3 * d.y, m.y + kS3 * d.x);
  } else if constexpr (R == 5) {
    constexpr float kC1 = 0.309017003f;   // cos(2 pi / 5)
    constexpr float kC2 = -0.809017003f;  // cos(4 pi / 5)
    constexpr float kS1 = 0.95105654f;    // sin(2 pi / 5)
    constexpr float kS2 = 0.587785244f;   // sin(4 pi / 5)
    const float2 s14 = make_float2(a[1].x + a[4].x, a[1].y + a[4].y);
    const float2 d14 = make_float2(a[1].x - a[4].x, a[1].y - a[4].y);
    const float2 s23 = make_float2(a[2].x + a[3].x, a[2].y + a[3].y);
    const float2 d23 = make_float2(a[2].x - a[3].x, a[2].y - a[3].y);
    const float2 m1 = make_float2(a[0].x + kC1 * s14.x + kC2 * s23.x,
                                  a[0].y + kC1 * s14.y + kC2 * s23.y);
    const float2 m2 = make_float2(a[0].x + kC2 * s14.x + kC1 * s23.x,
                                  a[0].y + kC2 * s14.y + kC1 * s23.y);
    const float2 n1 = make_float2(kS1 * d14.x + kS2 * d23.x, kS1 * d14.y + kS2 * d23.y);
    const float2 n2 = make_float2(kS2 * d14.x - kS1 * d23.x, kS2 * d14.y - kS1 * d23.y);
    a[0] = make_float2(a[0].x + s14.x + s23.x, a[0].y + s14.y + s23.y);
    a[1] = make_float2(m1.x + n1.y, m1.y - n1.x);  // m1 - i n1
    a[4] = make_float2(m1.x - n1.y, m1.y + n1.x);  // m1 + i n1
    a[2] = make_float2(m2.x + n2.y, m2.y - n2.x);
    a[3] = make_float2(m2.x - n2.y, m2.y + n2.x);
  } else {
    constexpr int P = R % 5 == 0 ? 5 : 3;
    constexpr int M = R / P;
    // X[P k1 + k2] = sum_n1 w_M^(n1 k1) w_R^(n1 k2) sum_n2 x[n1 + M n2] w_P^(n2 k2)
#pragma unroll
    for (int n1 = 0; n1 < M; ++n1) {
      float2 t[P];
#pragma unroll
      for (int n2 = 0; n2 < P; ++n2) t[n2] = a[n1 + M * n2];
      dft_regs<P>(t);
#pragma unroll
      for (int k2 = 0; k2 < P; ++k2) a[n1 + M * k2] = mul_root<R>(t[k2], n1 * k2);
    }
    float2 out[R];
#pragma unroll
    for (int k2 = 0; k2 < P; ++k2) {
      float2 t[M];
#pragma unroll
      for (int k1 = 0; k1 < M; ++k1) t[k1] = a[M * k2 + k1];
      dft_regs<M>(t);
#pragma unroll
      for (int k1 = 0; k1 < M; ++k1) out[P * k1 + k2] = t[k1];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = out[i];
  }
}

// Forward R-point DFT, in registers, of x[0], x[S], ..., x[(R-1) S]; a
// power of two renames its bit-reversed result straight into x.
template <int R, int S>
__device__ __forceinline__ void dft(float2* x) {
  float2 a[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = x[i * S];
  if constexpr ((R & (R - 1)) == 0) {
    DifStages<R, R / 2>::run(a);
#pragma unroll
    for (int i = 0; i < R; ++i) x[i * S] = a[bit_reverse(i, log2_const(R))];
  } else {
    dft_regs<R>(a);
#pragma unroll
    for (int i = 0; i < R; ++i) x[i * S] = a[i];
  }
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

// True where a line's T threads lie in one warp (a block's lines lie one
// after another), so that its exchange needs only __syncwarp: T divides
// 32 (a line of 20 threads would straddle two warps), which for the
// powers of two is T <= 32.
__device__ __forceinline__ bool line_in_warp(int threads) {
#ifdef LHG_FFT_RADICES
  return 32 % threads == 0;
#else
  return threads <= 32;
#endif
}

// j as a kernel uses it inside a loop (the FFT's exchange addresses, the
// rows of H): in a mixed-radix library an opaque copy, so that the
// arithmetic on it (constant divisions, the rows' frequencies) stays in the
// loop; hoisted out of K1's and K2's per-distance loops it held registers
// across them and spilled at E = 60.
__device__ __forceinline__ int loop_index(int j) {
#ifdef LHG_FFT_RADICES
  asm volatile("" : "+r"(j));
#endif
  return j;
}

// Pass I of the compiled plan, radix R: butterflies jj = j + b T, b < B,
// the last guarded where B T > n / R.  The exchange positions are
// pad_index's with the plan's gaps, written as base + r * stride (the gap
// falls between the r's of a butterfly, never inside its stride): with
// q = jj div Ns, pass I writes element r of butterfly jj at
// q (Ns R + G) + jj mod Ns + r Ns, G its exchange's gap, and reads its
// element r, jj + r n / R, at jj + G' (jj div Ns) + r (n / R + G' (n / R) / Ns),
// G' the previous exchange's gap.  The first pass takes the loads' registers
// and the last hands the stores theirs (B R = E there); a middle pass holds
// its B R values in `u` alone.
#ifdef LHG_FFT_RADICES
template <int E, int I>
__device__ __forceinline__ void run_plan_pass(float2 (&v)[E], int j, float2* buf, int bs,
                                              const float2* __restrict__ tw, LineSync sync) {
  constexpr int R = compiled::radix(I);
  constexpr int NS = compiled::stride(I);
  constexpr int T = compiled::kThreads;
  constexpr int SPAN = compiled::kN / R;
  constexpr int B = (SPAN + T - 1) / T;
  constexpr bool kGuard = B * T != SPAN;
  constexpr bool kFirst = I == 0;
  constexpr bool kLast = I + 1 == compiled::kPasses;
  static_assert(!(kFirst || kLast) || B * R == E, "the first and the last pass hold E values");
  float2 u[B * R];
  if constexpr (kFirst) {
#pragma unroll
    for (int c = 0; c < E; ++c) u[c] = v[c];
  } else {
    constexpr int G = compiled::gap(I - 1);
    const int stride = (SPAN + G * (SPAN / NS)) * bs;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int jj = j + b * T;
      if (!kGuard || b + 1 < B || jj < SPAN) {
        const float2* src = buf + (jj + G * (jj / NS)) * bs;
#pragma unroll
        for (int r = 0; r < R; ++r) u[b + r * B] = src[r * stride];
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int jj = j + b * T;
    if (!kGuard || b + 1 < B || jj < SPAN) {
      if constexpr (NS > 1) {
        const float2* __restrict__ wm = tw + compiled::tw_offset(I) + jj % NS;
#pragma unroll
        for (int r = 1; r < R; ++r) u[b + r * B] = cmul(u[b + r * B], __ldg(wm + (r - 1) * NS));
      }
      dft<R, B>(&u[b]);
    }
  }
  if constexpr (kLast) {
#pragma unroll
    for (int c = 0; c < E; ++c) v[c] = u[c];
  } else {
    constexpr int G = compiled::gap(I);
    sync();  // the previous reads of the buffer are done
    const int stride = NS * bs;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int jj = j + b * T;
      if (!kGuard || b + 1 < B || jj < SPAN) {
        const int q = jj / NS;
        float2* dst = buf + (q * (NS * R + G) + jj - q * NS) * bs;
#pragma unroll
        for (int r = 0; r < R; ++r) dst[r * stride] = u[b + r * B];
      }
    }
    sync();  // the writes are visible to the next pass
  }
}

template <int E, int I>
__device__ __forceinline__ void run_plan_passes(float2 (&v)[E], int j, float2* buf, int bs,
                                                const float2* __restrict__ tw, LineSync sync) {
  run_plan_pass<E, I>(v, j, buf, bs, tw, sync);
  if constexpr (I + 1 < compiled::kPasses) run_plan_passes<E, I + 1>(v, j, buf, bs, tw, sync);
}
#else
// Pass i of radix R in the power-of-two library, Ns = 2^lg_ns: with
// q = jj >> lg_ns it writes element r of butterfly jj at q Ns R + jj + r Ns
// (pad_index with the gap Ns) and reads element r, jj + r n / R, at
// jj + q pNs + r (n / R + (n / R >> lg_ns) pNs), pNs the previous pass's
// stride; the positions are shifts.
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
#endif

// Forward FFT of one line held as described at the top.  `buf` is the
// line's exchange (element position q at buf[q * bs]), `tw` the plan's
// twiddles on the device.  Every thread of the block must call it.
template <int E>
__device__ __forceinline__ void fft_line(float2 (&v)[E], const FftPlan& p, int j, float2* buf,
                                         int bs, const float2* __restrict__ tw, LineSync sync) {
#ifdef LHG_ABLATE_FFT
  return;  // a measurement build of fft_ablation.py: no transform, a wrong result
#endif
#ifdef LHG_FFT_RADICES
  run_plan_passes<E, 0>(v, j, buf, bs, tw, sync);
#else
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
#endif
}

}  // namespace hopper
}  // namespace lhg
