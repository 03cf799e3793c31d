"""Plans of the register-resident FFT core (``csrc/fft_hopper.cuh``) that K1
and K3 run on.

A line of n complex values, n = 2^a 3^b 5^c, is transformed by
``threads`` = n / E threads, each holding ``elems`` = E of its values in
registers.  Thread j holds element j + threads * c in register c, on the
way in and on the way out (natural order both ways).  The transform is a
mixed-radix Stockham FFT (decimation in time): pass i of radix R_i, with
Ns_i = R_0 * ... * R_{i-1}, takes each butterfly jj < n / R_i from the
elements jj + r * n / R_i, multiplies element r by w^(r * (jj mod Ns_i)),
w = exp(-2 pi i / (Ns_i R_i)), runs an R_i-point DFT in registers and
hands element r on to position (jj div Ns_i) Ns_i R_i + jj mod Ns_i + r Ns_i.
Thread j runs the butterflies jj = j + b * threads, b < E / R_i, and keeps
butterfly b's element r in register b + r * E / R_i, so every radix of the
plan divides E.

A power of two takes E = min(n, 32) and radix 32 for every pass but the
last, which takes what is left (2 to 32): n <= 1024 takes one exchange and
n <= 32768 two.  Any other length takes E from :data:`MIXED_ELEMS` (the
values the kernels are compiled for, all <= 60) and the fewest passes of
radices that divide E; among plans of as many passes, one whose E <= 32
first (a block of up to 512 threads, as for the powers of two), then the
largest such E, else the smallest E (a block of up to 256 threads, so that
a thread may use up to 255 registers).  768 = 48 * 16 (E = 48), 1280 =
40 * 8 * 4 (E = 40), 1728 = 24 * 24 * 3 (E = 24), 2880 = 60 * 12 * 4
(E = 60), 5000 = 50 * 50 * 2 (E = 50).  A length has a plan where such an
E gives at most :func:`max_threads` threads a line.

Between two passes the values go through one shared-memory exchange per
line (:func:`pad_index`): no access conflicts on a bank for the powers of
two; a bounded number for the other lengths (``tests/test_torch_fft_plan.py``).
The kernel divides by Ns_i as (x * magic) >> shift (:func:`div_magic`),
exact for x < 2^14; for a power of two it shifts by log2 Ns_i, and its
library reads the plan as log2 values (:func:`plan_ints`).

The plan is built once per length, in float64, and rounded to complex64:
the per-pass twiddle tables, then the integers the kernel reads
(:func:`plan_ints`).  The CPU tests emulate the kernel's index arithmetic
from the same plan (``tests/test_torch_fft_plan.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...utils.fftlen import is_smooth

MAX_RADIX = 32  # largest radix of a power-of-two plan
MAX_LENGTH = 16384
# elems of the plans of lengths that are not powers of two: the kernels'
# instantiations (fft_hopper.cuh:LHG_FFT_MIXED_ELEMS)
MIXED_ELEMS = (3, 5, 6, 9, 10, 12, 15, 18, 20, 24, 25, 27, 30, 36, 40, 45, 48, 50, 54, 60)
# the radices the register DFTs take (fft_hopper.cuh:fft_line's cases)
RADICES = (2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16, 18, 20, 24, 25, 27, 30, 32, 36, 40, 45, 48,
           50, 54, 60)
# passes of the longest plan (12800 = 50 * 2^8, 13824 = 54 * 2^8: E = 50 and
# 54 hold one factor 2 each), and of the longest power of two's (16384 =
# 32 * 32 * 16)
MAX_PASSES = 9
POW2_MAX_PASSES = 3
# dynamic shared memory a Hopper block may use (227 KB), and the threads a
# block of K1 or K3 may have (the kernels' __launch_bounds__): 512, or 256
# where E > 32
SMEM_LIMIT = 232448
MAX_THREADS = 512
MAX_THREADS_WIDE = 256
# numerators the kernel divides by Ns_i: element indices, below 2^14
DIV_BITS = 14


def max_threads(elems: int) -> int:
    """Threads a block of K1 or K3 may have for a plan of ``elems`` values a
    thread (the kernels' ``__launch_bounds__``)."""
    return MAX_THREADS if elems <= MAX_RADIX else MAX_THREADS_WIDE


@dataclasses.dataclass(frozen=True)
class FftPlan:
    n: int
    elems: int  # E: values each thread holds, a compile-time constant of the kernel
    threads: int  # threads per line, n / E
    radices: Tuple[int, ...]
    strides: Tuple[int, ...]  # Ns_i, the product of the earlier radices
    tw_offsets: Tuple[int, ...]  # start of pass i's table in `twiddles` (0 where Ns_i = 1)
    twiddles: np.ndarray  # complex64; pass i: (R_i - 1, Ns_i), [r - 1, m] = w^(r m)
    buffer: int  # complex values of one line's padded exchange (0: no exchange)


def pad_index(e, ns: int, radix: int):
    """Position of element ``e`` in the exchange written by the pass of stride
    ``ns`` and radix ``radix``: one gap of ``ns`` values after every block of
    ``ns * radix``.  For powers of two a half-warp then writes 16 distinct
    banks, and the next pass reads 16 consecutive values."""
    return e + ns * (e // (ns * radix))


def div_magic(d: int) -> Tuple[int, int]:
    """(magic, shift) with (x * magic) >> shift == x // d for 0 <= x <
    2^DIV_BITS, in 32-bit arithmetic: (1, log2 d) for a power of two, else
    magic = ceil(2^(DIV_BITS + l) / d), l = ceil(log2 d)."""
    if d & (d - 1) == 0:
        return 1, d.bit_length() - 1
    shift = DIV_BITS + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


@functools.lru_cache(maxsize=None)
def _fewest_radices(n: int, elems: int) -> Optional[Tuple[int, ...]]:
    """The fewest radices from :data:`RADICES` dividing ``elems`` whose
    product is ``n``, largest first (the lexicographically largest such
    list); None if there is none."""
    if n == 1:
        return ()
    best = None
    for radix in sorted((r for r in RADICES if elems % r == 0 and n % r == 0), reverse=True):
        rest = _fewest_radices(n // radix, elems)
        if rest is not None and (best is None or len(rest) + 1 < len(best)):
            best = (radix,) + rest
    return best


def _choose(n: int) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """(elems, radices) of the plan for ``n``, or None."""
    if n & (n - 1) == 0:
        radices = []
        rest = n
        while rest > 1:
            radices.append(min(rest, MAX_RADIX))
            rest //= radices[-1]
        return min(n, MAX_RADIX), tuple(radices)
    best = None
    for elems in MIXED_ELEMS:
        if n % elems or n // elems > max_threads(elems):
            continue
        radices = _fewest_radices(n, elems)
        if radices is None or len(radices) > MAX_PASSES:
            continue
        wide = elems > MAX_RADIX
        key = (len(radices), wide, elems if wide else -elems)
        if best is None or key < best[0]:
            best = (key, elems, tuple(sorted(radices, reverse=True)))
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=None)
def make_plan(n: int) -> FftPlan:
    """The plan for lines of ``n`` points, n = 2^a 3^b 5^c from 2 to
    :data:`MAX_LENGTH`, where one exists (module docstring)."""
    chosen = _choose(n) if 2 <= n <= MAX_LENGTH and is_smooth(n) else None
    if chosen is None:
        raise ValueError(f"no FFT plan for length {n}")
    elems, radices = chosen
    strides, offsets, tables = [], [], []
    ns, offset = 1, 0
    for radix in radices:
        strides.append(ns)
        offsets.append(offset if ns > 1 else 0)
        if ns > 1:
            r = np.arange(1, radix, dtype=np.float64)[:, None]
            m = np.arange(ns, dtype=np.float64)[None, :]
            tables.append(np.exp(-2j * np.pi * r * m / (ns * radix)).reshape(-1))
            offset += (radix - 1) * ns
        ns *= radix
    twiddles = (np.concatenate(tables) if tables else np.ones(1)).astype(np.complex64)
    buffer = 0
    for ns_i, radix in zip(strides[:-1], radices[:-1]):
        buffer = max(buffer, int(pad_index(n - 1, ns_i, radix)) + 1)
    if buffer:
        # lines of a block lie `buffer` apart: == threads (mod 16), so that the
        # lines of fewer than 16 threads that share a half-warp use distinct banks
        buffer += (n // elems - buffer) % 16
    return FftPlan(n, elems, n // elems, tuple(radices), tuple(strides), tuple(offsets),
                   twiddles, buffer)


def build_defines(plan: FftPlan) -> Tuple[str, ...]:
    """The macros of the K1 / K3 library that holds ``plan``'s kernels:
    none for the powers of two (E = 2 ... 32), ``LHG_FFT_ELEMS=E`` for a
    mixed-radix plan (one library per E, built at its first use;
    fft_hopper.cuh:LHG_FFT_KERNEL_ELEMS)."""
    if plan.n & (plan.n - 1) == 0:
        return ()
    return (f"LHG_FFT_ELEMS={plan.elems}",)


def all_build_defines() -> Tuple[Tuple[str, ...], ...]:
    """Every K1 / K3 library's macros: the powers of two, then each
    :data:`MIXED_ELEMS`."""
    return ((),) + tuple((f"LHG_FFT_ELEMS={e}",) for e in MIXED_ELEMS)


def lines_per_block(plan: FftPlan, min_lines: int, bytes_per_line: int) -> Optional[int]:
    """Lines one block of K1 or K3 transforms, a power of two: at least
    ``min_lines``, more where a line takes fewer than 128 threads, halved
    until the block has at most :func:`max_threads` threads and two blocks'
    ``bytes_per_line`` each fit in shared memory, or one line is left; None
    if no block fits."""
    lines = max(min_lines, 128 // plan.threads)
    lines = 1 << (lines.bit_length() - 1)
    limit = max_threads(plan.elems)
    while lines > 1 and (lines * plan.threads > limit
                         or lines * bytes_per_line > SMEM_LIMIT // 2):
        lines //= 2
    if lines * plan.threads > limit or lines * bytes_per_line > SMEM_LIMIT:
        return None
    return lines


def plan_ints(plan: FftPlan) -> np.ndarray:
    """The plan as the kernel's ``FftPlan`` struct reads it (int32): n,
    elems, threads, passes, buffer, then per pass: for a power of two (up
    to POW2_MAX_PASSES) log2 of the radix and of the stride Ns and the
    table offset; for any other length (up to MAX_PASSES, the library of
    :func:`build_defines`) the radix, the stride, the magic and shift that
    divide by Ns (:func:`div_magic`) and the table offset."""
    head = [plan.n, plan.elems, plan.threads, len(plan.radices), plan.buffer]
    if plan.n & (plan.n - 1) == 0:
        pad = [0] * (POW2_MAX_PASSES - len(plan.radices))
        fields = ([r.bit_length() - 1 for r in plan.radices], [s.bit_length() - 1 for s in plan.strides],
                  list(plan.tw_offsets))
        return np.array(head + [v for f in fields for v in f + pad], dtype=np.int32)
    magic = [div_magic(s) for s in plan.strides]
    pad = [0] * (MAX_PASSES - len(plan.radices))
    fields = (list(plan.radices), list(plan.strides), [m for m, _ in magic], [s for _, s in magic],
              list(plan.tw_offsets))
    return np.array(head + [v for f in fields for v in f + pad], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def device_plan(n: int, device: torch.device):
    """The plan for length n, its integers (host) and its twiddles on ``device``."""
    plan = make_plan(n)
    return plan, plan_ints(plan), torch.from_numpy(plan.twiddles).to(device)
