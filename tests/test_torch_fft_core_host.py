"""The FFT core's own source, ``csrc/fft_hopper.cuh``, compiled for the host
and run against numpy's DFT.

The CPU tests have no card and no nvcc, so ``tests/test_torch_fft_plan.py``
re-derives the kernel's index arithmetic in numpy.  This file takes the
header itself:
g++ (C++20) compiles it with a few definitions standing in for CUDA's
(``float2``, ``__ldg``, the barriers), and a line of T threads runs
``fft_line`` as the kernels run it, one ``std::thread`` a CUDA thread,
``__syncthreads``/``__syncwarp`` a ``std::barrier`` of the line's threads,
the exchange in an ordinary array.  The plans and twiddles are the
wrappers' (``fft_plan.plan_ints``), and each length runs in the build the
wrappers load for it (the power-of-two library, or its own plan's with
``fft_plan.build_defines``: the radices, gaps and E compiled in), so what
runs is the kernels' code path for every power of two and mixed-radix plan
listed, guarded butterflies of the middle passes included, up to the
compiler; then every candidate plan ``fft_ablation.py`` times on the card.
The libraries build in parallel, once each.  Skips where g++ is absent.

Tolerance: as ``test_torch_fft_plan.py``'s emulation, <= 1e-5 of
max |ref| against float64 ``np.fft``.
"""

import concurrent.futures
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from learned_hologram_gan_tpu_torch.fft_ablation import MIXED_CANDIDATES
from learned_hologram_gan_tpu_torch.ops.cuda import fft_plan

CSRC = Path(fft_plan.__file__).resolve().parents[2] / "csrc"
LENGTHS = [2, 32, 64, 1024, 16384, 3, 5, 6, 12, 24, 48, 96, 384, 768, 1280, 1728, 2880, 5000,
           75, 12800]
# every candidate plan of the paths' lengths, (n, E, radices)
CANDIDATES = [(n, e, r) for n, plans in MIXED_CANDIDATES.items() for e, r in plans]

SHIM = r"""
#pragma once
#include <barrier>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
template <class T> inline T __ldg(const T* p) { return *p; }
extern thread_local std::barrier<>* g_bar;
inline void __syncwarp() { g_bar->arrive_and_wait(); }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
"""

HOST_MAIN = r"""
#include <cstdio>
#include <thread>
#include <vector>
#include "fft_hopper.cuh"
thread_local std::barrier<>* g_bar;
using namespace lhg::hopper;
#ifndef LHG_FFT_RADICES
inline bool plan_ints_match(const int*) { return true; }
#endif

template <int E>
void run(const FftPlan& p, const std::vector<float2>& tw, std::vector<float2>& x) {
  const int T = p.threads;
  std::vector<float2> buf(p.buffer > 0 ? p.buffer : 1);
  std::barrier<> bar(T);
  std::vector<std::thread> threads;
  for (int j = 0; j < T; ++j) {
    threads.emplace_back([&, j] {
      g_bar = &bar;
      float2 v[E];
      for (int c = 0; c < E; ++c) v[c] = x[j + c * T];
      bar.arrive_and_wait();
      fft_line<E>(v, p, j, buf.data(), 1, tw.data(), LineSync{false});
      bar.arrive_and_wait();
      for (int c = 0; c < E; ++c) x[j + c * T] = v[c];
    });
  }
  for (auto& t : threads) t.join();
}

int main() {
  int count;
  if (scanf("%d", &count) != 1 || count > 64) return 2;
  int f[64];
  for (int i = 0; i < count; ++i) if (scanf("%d", &f[i]) != 1) return 2;
  if (!plan_ints_match(f)) return 4;
  const FftPlan p = plan_from_ints(f);
  int ntw;
  if (scanf("%d", &ntw) != 1) return 2;
  std::vector<float2> tw(ntw), x(p.n);
  for (auto& w : tw) if (scanf("%a %a", &w.x, &w.y) != 2) return 2;
  for (auto& v : x) if (scanf("%a %a", &v.x, &v.y) != 2) return 2;
#define CASE(E) case E: run<E>(p, tw, x); break;
  switch (p.elems) {
    LHG_FFT_KERNEL_ELEMS(CASE)
    default: return 3;
  }
  for (auto& v : x) printf("%a %a\n", v.x, v.y);
  return 0;
}
"""


def _plans():
    return ([fft_plan.make_plan(n) for n in LENGTHS]
            + [fft_plan._plan_of(n, e, r) for n, e, r in CANDIDATES])


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """The host build of each plan's library, as the wrappers pick it
    (``fft_plan.build_defines``: the powers of two, or one plan), built in
    parallel once per library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ absent: the host build of the FFT core cannot run")
    d = tmp_path_factory.mktemp("fft_core")
    (d / "shim.h").write_text(SHIM)
    (d / "cuda_runtime.h").write_text("")
    (d / "main.cpp").write_text(HOST_MAIN)
    jobs = {}
    for plan in _plans():
        defines = fft_plan.build_defines(plan)
        jobs.setdefault(defines, d / f"core{len(jobs)}")

    def build(item):
        defines, path = item
        subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", *(f"-D{v}" for v in defines),
                        "-include", str(d / "shim.h"), f"-I{d}", f"-I{CSRC}", str(d / "main.cpp"),
                        "-o", str(path)], check=True, capture_output=True, timeout=300)

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(build, jobs.items()))
    return lambda plan: jobs[fft_plan.build_defines(plan)]


def _hex(v: np.ndarray) -> str:
    return "\n".join(f"{float(a.real).hex()} {float(a.imag).hex()}" for a in v)


def _run(exe, plan):
    n = plan.n
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    ints = fft_plan.plan_ints(plan)
    stdin = "\n".join([" ".join(map(str, [ints.size, *ints])), str(plan.twiddles.size),
                       _hex(plan.twiddles), _hex(x)])
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = np.array([complex(*(float.fromhex(v) for v in line.split()))
                    for line in out.stdout.splitlines()])
    want = np.fft.fft(x.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", LENGTHS)
def test_header_fft_line_matches_numpy(core, n):
    plan = fft_plan.make_plan(n)
    _run(core(plan), plan)


@pytest.mark.parametrize("n,elems,radices", CANDIDATES)
def test_header_candidate_plans_match_numpy(core, n, elems, radices):
    """The candidates fft_ablation.py times on the card, each its own
    library: every one computes the DFT."""
    plan = fft_plan._plan_of(n, elems, tuple(radices))
    _run(core(plan), plan)


def test_header_refuses_another_plans_integers(core):
    """A mixed-radix library checks the integers it is handed against the
    plan compiled into it (a wrapper that loaded the wrong library)."""
    plan, other = fft_plan.make_plan(1280), fft_plan.make_plan(768)
    ints = fft_plan.plan_ints(other)
    stdin = " ".join(map(str, [ints.size, *ints]))
    out = subprocess.run([str(core(plan))], input=stdin, capture_output=True, text=True, timeout=60)
    assert out.returncode == 4
