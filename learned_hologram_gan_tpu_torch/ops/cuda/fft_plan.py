"""Plans of the register-resident FFT core (``csrc/fft_hopper.cuh``) that K1,
K2 and K3 run on.

A line of n complex values, n = 2^a 3^b 5^c, is transformed by
``threads`` = T = n / E threads, each holding ``elems`` = E of its values in
registers.  Thread j holds element j + T * c in register c, on the way in
and on the way out (natural order both ways).  The transform is a
mixed-radix Stockham FFT (decimation in time): pass i of radix R_i, with
Ns_i = R_0 * ... * R_{i-1}, takes each butterfly jj < n / R_i from the
elements jj + r * n / R_i, multiplies element r by w^(r * (jj mod Ns_i)),
w = exp(-2 pi i / (Ns_i R_i)), runs an R_i-point DFT in registers and
hands element r on to position (jj div Ns_i) Ns_i R_i + jj mod Ns_i + r Ns_i.
Thread j runs the butterflies jj = j + b * T, b < B_i = ceil(n / (R_i T))
(:meth:`FftPlan.butterflies`), and keeps butterfly b's element r in slot
b + r * B_i.  Where B_i T > n / R_i the last butterfly is guarded (jj <
n / R_i).  The first pass takes its values from the loads and the last
hands them to the stores in natural order, so their radices divide E
(B = E / R, no guard there); a middle pass reads and writes only the
exchange and takes any radix of :data:`RADICES`.

A power of two takes E = min(n, 32) and radix 32 for every pass but the
last, which takes what is left (2 to 32): n <= 1024 takes one exchange and
n <= 32768 two.  Its library reads the plan at run time as 14 integers
(:func:`plan_ints`, log2 of the radices and strides).

Any other length has its plan fixed at compile time, one library per plan
(:func:`build_defines`: E, the radices, the exchanges' gaps and the block's
thread limit as macros), so that the kernel unrolls its passes with
constant radices, strides and divisions.  The lengths of the paths take
the plans of :data:`CHOSEN`, each picked from the candidates
``fft_ablation.py`` times on the card (:func:`candidates`).  Every other
length takes the rule of :func:`_rule_key`: a plan whose threads hold at
most :data:`TARGET_VALUES` values in every pass where there is one, then
the fewest passes, the largest E, the fewest values.  The kernels'
``__launch_bounds__`` is the plan's ``max_threads``: :data:`COLUMNS` lines
(or fewer, a power of two) of T threads, as many as an SM's registers hold
at the plan's estimated registers a thread (:func:`_max_threads`).

Between two passes the values go through one shared-memory exchange per
line (:func:`pad_index`: a gap after every Ns_i R_i values).  A power of
two takes the gap Ns_i, free of bank conflicts.  A mixed-radix plan takes,
per exchange, the gap below 16 that its bank model finds the fewest
conflicts at (:func:`_choose_gap`), within a quarter of n of padding (less
where a long line's block would not fit); the bound it reaches is stated
by ``tests/test_torch_fft_plan.py``.

The plan is built once per length, in float64, and rounded to complex64:
the per-pass twiddle tables, then the integers the kernel reads
(:func:`plan_ints`).  The CPU tests emulate the kernel's index arithmetic
from the same plan (``tests/test_torch_fft_plan.py``) and run the header
itself under g++ (``tests/test_torch_fft_core_host.py``).
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
# the radices the register DFTs take (fft_hopper.cuh:dft_regs)
RADICES = (2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16, 18, 20, 24, 25, 27, 30, 32, 36, 40, 45, 48,
           50, 54, 60)
# passes of the longest power of two's plan (16384 = 32 * 32 * 16), and the
# most a mixed-radix plan may take
POW2_MAX_PASSES = 3
MAX_PASSES = 6
# values a thread of a mixed-radix plan holds at the most, and what the
# rule keeps to where the length allows
MAX_ELEMS = 64
TARGET_VALUES = 32
# dynamic shared memory a Hopper block may use (227 KB), the threads of a
# power-of-two plan's blocks (the kernels' __launch_bounds__(512)), of any
# block, the registers of an SM, and the lines a block interleaves along a
# strided axis (64-byte row segments)
SMEM_LIMIT = 232448
MAX_THREADS = 512
MAX_BLOCK_THREADS = 1024
SM_REGISTERS = 65536
COLUMNS = 8
# 8-byte positions a half-warp's accesses spread over without a conflict
BANK_PAIRS = 16

# The plans of the paths' mixed-radix lengths, (E, radices): the portrait
# grid's 1280 x 768, 1080p's rp 1728 and the 4K grid's 2880 x 5000.  Each
# is the fastest of fft_ablation.py's candidates on the card that spills
# nothing and keeps 8 columns a block (PERF.md §6): at 2880, E = 30 and 24
# ran K1 faster but spilled, and at 1728 12 * 12 * 12 ran K2 faster in 4
# columns.
CHOSEN = {
    768: (16, (16, 3, 16)),
    1280: (16, (16, 5, 16)),
    1728: (24, (24, 24, 3)),
    2880: (60, (12, 20, 12)),
    5000: (40, (40, 25, 5)),
}


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
    gaps: Tuple[int, ...]  # exchange i's gap after every strides[i] * radices[i] values
    max_threads: int  # the threads a block may have (the kernels' __launch_bounds__)
    # lines a block interleaves (0: none fits): K3 along axis -2, K1 / K2
    # with D = 1, and with the spectrum (K2: the distance sum) kept; a
    # mixed-radix library compiles them in (k3_columns, k1_columns)
    columns: Tuple[int, int, int] = (0, 0, 0)

    @property
    def pow2(self) -> bool:
        return self.n & (self.n - 1) == 0

    def butterflies(self, i: int) -> int:
        """B_i: the butterflies a thread runs in pass i (the last one guarded
        where B_i T > n / R_i)."""
        return -(-(self.n // self.radices[i]) // self.threads)

    @property
    def line_threads(self) -> int:
        """The threads a block of whole lines may have (K3 along axis -1):
        the power-of-two library's 512, a mixed-radix plan's max(T, 128)."""
        return self.max_threads if self.pow2 else max(self.threads, 128)

    @property
    def peak_values(self) -> int:
        """The most values a thread holds in any pass (its registers' load)."""
        return _peak(self.n, self.elems, self.radices)


def pad_index(e, ns: int, radix: int, gap: Optional[int] = None):
    """Position of element ``e`` in the exchange written by the pass of stride
    ``ns`` and radix ``radix``: a gap of ``gap`` values (``ns`` by default,
    the power-of-two plans') after every block of ``ns * radix``.  For powers
    of two a half-warp then writes 16 distinct banks, and the next pass reads
    16 consecutive values."""
    return e + (ns if gap is None else gap) * (e // (ns * radix))


def _peak(n: int, elems: int, radices: Tuple[int, ...]) -> int:
    t = n // elems
    return max(-(-(n // r) // t) * r for r in radices)


@functools.lru_cache(maxsize=None)
def _factorizations(m: int, parts: int) -> Tuple[Tuple[int, ...], ...]:
    """Every multiset of ``parts`` radices of :data:`RADICES` whose product
    is ``m``, each in descending order."""
    if parts == 0:
        return ((),) if m == 1 else ()
    out = []
    for r in RADICES:
        if m % r == 0:
            out += [(r,) + rest for rest in _factorizations(m // r, parts - 1) if not rest or rest[0] <= r]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def candidates(n: int) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """Every mixed-radix plan (E, radices) for ``n``: E divides n, E <=
    :data:`MAX_ELEMS`, T = n / E <= :data:`MAX_BLOCK_THREADS`, the first and
    the last radix divide E, the middle ones in descending order (their
    order moves only the strides), at most :data:`MAX_PASSES` passes."""
    out = []
    for elems in range(2, min(n, MAX_ELEMS) + 1):
        if n % elems or n // elems > MAX_BLOCK_THREADS:
            continue
        if elems == n and n in RADICES:
            out.append((elems, (n,)))
        ends = [r for r in RADICES if elems % r == 0 and n % r == 0]
        for first in ends:
            for last in ends:
                if n % (first * last):
                    continue
                for parts in range(MAX_PASSES - 1):
                    out += [(elems, (first,) + middle + (last,))
                            for middle in _factorizations(n // (first * last), parts)]
    return tuple(out)


def _rule_key(n: int, elems: int, radices: Tuple[int, ...]):
    """The rule's order of the candidates of a length not in :data:`CHOSEN`:
    at most :data:`TARGET_VALUES` values a thread first, then the fewest
    passes, the largest E (fewer threads, each with more work to overlap),
    the fewest values."""
    peak = _peak(n, elems, radices)
    return (peak > TARGET_VALUES, len(radices), -elems, peak, radices)


def _choose(n: int) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """(elems, radices) of the plan for ``n``, or None."""
    if n & (n - 1) == 0:
        radices = []
        rest = n
        while rest > 1:
            radices.append(min(rest, MAX_RADIX))
            rest //= radices[-1]
        return min(n, MAX_RADIX), tuple(radices)
    if n in CHOSEN:
        return CHOSEN[n]
    options = candidates(n)
    return min(options, key=lambda c: _rule_key(n, *c)) if options else None


def _max_threads(n: int, elems: int, radices: Tuple[int, ...]) -> int:
    """A mixed-radix plan's block limit: :data:`COLUMNS` lines of T threads
    (or 128 threads' worth of short lines), halved as long as they take more
    than an SM's registers hold at 2 * peak + 16 registers a thread (the
    values and the indexing), one line at least.  ptxas' report says
    whether the plan's kernels fit it (``fft_ablation.py``)."""
    t = n // elems
    cap = min(MAX_BLOCK_THREADS, SM_REGISTERS // (2 * _peak(n, elems, radices) + 16))
    lines = max(COLUMNS, 128 // t)
    lines = 1 << (lines.bit_length() - 1)
    while lines > 1 and lines * t > cap:
        lines //= 2
    return lines * t


def _exchange_residues(n, elems, radices, gaps, i, write, modulus):
    """Positions mod ``modulus`` of the exchange between passes i and i + 1
    as pass i writes it (``write``) or pass i + 1 reads it, per butterfly
    jj of that pass (-1 where a guarded butterfly is off); element r only
    adds a constant, so r = 0 stands for all."""
    t = n // elems
    k = i if write else i + 1
    radix, ns = radices[k], int(np.prod(radices[:k], dtype=np.int64))
    span = n // radix
    jj = np.arange(-(-span // t) * t)
    if write:
        pos = (jj // ns) * (ns * radix + gaps[i]) + jj % ns
    else:
        pos = jj + gaps[i] * (jj // ns)
    return np.where(jj < span, pos % modulus, -1), t


def _window_ways(res, t, width):
    """The most accesses one bank pair takes over the windows of ``width``
    consecutive threads of a line (for each butterfly b, threads j of the
    window run jj = j + b T); ``res`` as _exchange_residues gives it."""
    b_count = res.size // t
    j = np.arange(-(-t // width) * width)
    starts = j[::width]
    win = (starts[:, None] + np.arange(width)[None, :])  # (windows, width) thread ids
    inside = win < t
    idx = np.clip(win, 0, t - 1)[None, :, :] + t * np.arange(b_count)[:, None, None]
    vals = np.where(inside[None], res[idx], -1).reshape(-1, width)
    valid = vals >= 0
    codes = np.arange(vals.shape[0])[:, None] * width + np.where(valid, vals, 0)
    counts = np.bincount(codes[valid], minlength=vals.shape[0] * width)
    return int(counts.max()) if counts.size else 1


def _choose_gap(n, elems, radices, gaps, i):
    """Exchange i's gap, below 16, its padding at most a quarter of n and,
    where a line's exchange and a second array of n values (K1 keeping its
    spectrum) can fit one block, small enough that they still do: the fewest conflicts of a line's
    half-warps (K3 along axis -1), then of the interleaved columns' (pairs
    of threads, 8 columns: K3 along axis -2, K1, K2), then the smallest."""
    block = int(np.prod(radices[:i + 1], dtype=np.int64))
    kept = SMEM_LIMIT // 8 - 2 * n - BANK_PAIRS  # what K1 keeping its spectrum leaves
    budget = n // 4 if kept < 0 else min(n // 4, kept)
    best = None
    for gap in range(BANK_PAIRS):
        if gap and gap * (n // block) > budget:
            break
        trial = gaps[:i] + (gap,)
        key = []
        for modulus, width in ((BANK_PAIRS, BANK_PAIRS), (2, 2)):
            ways = [_window_ways(*_exchange_residues(n, elems, radices, trial, i, w, modulus), width)
                    for w in (True, False)]
            key.append(max(ways))
        key.append(gap)
        if best is None or key < best[0]:
            best = (key, gap)
    return best[1]


@functools.lru_cache(maxsize=None)
def make_plan(n: int) -> FftPlan:
    """The plan for lines of ``n`` points, n = 2^a 3^b 5^c from 2 to
    :data:`MAX_LENGTH`, where one exists (module docstring)."""
    chosen = _choose(n) if 2 <= n <= MAX_LENGTH and is_smooth(n) else None
    if chosen is None:
        raise ValueError(f"no FFT plan for length {n}")
    return _plan_of(n, *chosen)


@functools.lru_cache(maxsize=None)
def _plan_of(n: int, elems: int, radices: Tuple[int, ...]) -> FftPlan:
    """The plan for ``n`` with the given E and radices (a candidate's)."""
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
    pow2 = n & (n - 1) == 0
    gaps = ()
    for i in range(len(radices) - 1):
        gaps += (strides[i] if pow2 else _choose_gap(n, elems, radices, gaps, i),)
    buffer = 0
    for ns_i, radix, gap in zip(strides, radices, gaps):
        buffer = max(buffer, int(pad_index(n - 1, ns_i, radix, gap)) + 1)
    if buffer:
        # lines of a block lie `buffer` apart: == threads (mod 16), so that the
        # lines of fewer than 16 threads that share a half-warp use distinct banks
        buffer += (n // elems - buffer) % 16
    max_threads = MAX_THREADS if pow2 else _max_threads(n, elems, radices)
    plan = FftPlan(n, elems, n // elems, tuple(radices), tuple(strides), tuple(offsets),
                   twiddles, buffer, gaps, max_threads)
    columns = (k3_columns(plan), k1_columns(plan, False), k1_columns(plan, True))
    return dataclasses.replace(plan, columns=tuple(c or 0 for c in columns))


def build_defines(plan: FftPlan) -> Tuple[str, ...]:
    """The macros of the K1 / K3 library that holds ``plan``'s kernels: none
    for the powers of two (E = 2 ... 32, the plan read at run time), and for
    any other length its plan, one library each (fft_hopper.cuh): E, the
    radices and the exchanges' gaps, the block's thread limit and its
    interleaved column counts (the lists ``.``-separated, a single
    preprocessing number that the header reads as a string; nvcc splits a
    -D value at commas)."""
    if plan.pow2:
        return ()
    return (f"LHG_FFT_ELEMS={plan.elems}", f"LHG_FFT_RADICES={'.'.join(map(str, plan.radices))}",
            f"LHG_FFT_GAPS={'.'.join(map(str, plan.gaps or (0,)))}",
            f"LHG_FFT_MAX_THREADS={plan.max_threads}",
            f"LHG_FFT_COLUMNS={'.'.join(map(str, plan.columns))}")


def lines_per_block(plan: FftPlan, min_lines: int, bytes_per_line: int,
                    limit: Optional[int] = None) -> Optional[int]:
    """Lines one block of K1 or K3 transforms, a power of two: at least
    ``min_lines``, more where a line takes fewer than 128 threads, halved
    until the block has at most ``limit`` threads (``plan.max_threads``
    by default) and two blocks' ``bytes_per_line`` each fit in shared
    memory, or one line is left; a mixed-radix plan keeps ``min_lines``
    over a second block an SM, halving below it only where one block's
    threads or shared memory do not fit.  None if no block fits."""
    lines = max(min_lines, 128 // plan.threads)
    lines = 1 << (lines.bit_length() - 1)
    limit = plan.max_threads if limit is None else limit
    floor = 1 if plan.pow2 else min_lines
    while lines > floor and (lines * plan.threads > limit or lines * bytes_per_line > SMEM_LIMIT // 2):
        lines //= 2
    while lines > 1 and (lines * plan.threads > limit or lines * bytes_per_line > SMEM_LIMIT):
        lines //= 2
    if lines * plan.threads > limit or lines * bytes_per_line > SMEM_LIMIT:
        return None
    return lines


def k3_columns(plan: FftPlan) -> Optional[int]:
    """K3's columns a block along axis -2: at least :data:`COLUMNS` (64-byte
    row segments) where they fit; None if no block fits."""
    return lines_per_block(plan, COLUMNS, plan.buffer * 8)


def k1_columns(plan: FftPlan, keep_spectrum: bool) -> Optional[int]:
    """K1's and K2's columns a block: at least :data:`COLUMNS` (64-byte row
    segments) where they fit.  A column takes its exchange, which also holds
    the thread-private slots of S * H (at least rp values), and a second
    array of rp values when D > 1 (K1's spectrum, K2's distance sum).  At
    rp = 1024: 8 columns, 256 threads, 68 KB; with the second array 4
    columns, 67 KB.  None if no block fits."""
    values = max(plan.buffer, plan.n) + (plan.n if keep_spectrum else 0)
    return lines_per_block(plan, COLUMNS, values * 8)


def plan_ints(plan: FftPlan) -> np.ndarray:
    """The plan as the kernel's library reads it (int32): n, elems, threads,
    passes, buffer, then for a power of two (up to POW2_MAX_PASSES) per pass
    log2 of the radix and of the stride Ns and the table offset: the
    ``FftPlan`` struct its kernels take.  A mixed-radix library has its plan
    compiled in and checks these five against it."""
    head = [plan.n, plan.elems, plan.threads, len(plan.radices), plan.buffer]
    if not plan.pow2:
        return np.array(head, dtype=np.int32)
    pad = [0] * (POW2_MAX_PASSES - len(plan.radices))
    fields = ([r.bit_length() - 1 for r in plan.radices], [s.bit_length() - 1 for s in plan.strides],
              list(plan.tw_offsets))
    return np.array(head + [v for f in fields for v in f + pad], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def device_plan(n: int, device: torch.device):
    """The plan for length n, its integers (host) and its twiddles on ``device``."""
    plan = make_plan(n)
    return plan, plan_ints(plan), torch.from_numpy(plan.twiddles).to(device)
