"""Plans of the register-resident FFT core (``csrc/fft_hopper.cuh``) that K1
and K3 run on.

A line of n = 2^m complex values is transformed by ``threads`` = n / E
threads, each holding ``elems`` = E = min(n, 32) of its values in
registers.  Thread j holds element j + threads * c in register c, on the
way in and on the way out (natural order both ways).  The transform is a
mixed-radix Stockham FFT (decimation in time): pass i of radix R_i, with
Ns_i = R_0 * ... * R_{i-1}, takes each butterfly jj < n / R_i from the
elements jj + r * n / R_i, multiplies element r by w^(r * (jj mod Ns_i)),
w = exp(-2 pi i / (Ns_i R_i)), runs an R_i-point DFT in registers and
hands element r on to position (jj div Ns_i) Ns_i R_i + jj mod Ns_i + r Ns_i.
Thread j runs the butterflies jj = j + b * threads, b < E / R_i, and keeps
butterfly b's element r in register b + r * E / R_i.

Between two passes the values go through one shared-memory exchange per
line, laid out so that no access conflicts on a bank (:func:`pad_index`).
Every pass but the last has radix 32, so n <= 1024 takes one exchange and
n <= 32768 two; the last pass takes what is left (2 to 32).

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

MAX_RADIX = 32
MAX_LENGTH = 16384
# passes of the longest line: 16384 = 32 * 32 * 16
MAX_PASSES = -(-(MAX_LENGTH.bit_length() - 1) // (MAX_RADIX.bit_length() - 1))
# dynamic shared memory a Hopper block may use (227 KB), and the threads a
# block of K1 or K3 may have (the kernels' __launch_bounds__)
SMEM_LIMIT = 232448
MAX_THREADS = 512


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
    ``ns * radix``.  A half-warp then writes 16 distinct banks, and the next
    pass reads 16 consecutive values."""
    return e + ns * (e // (ns * radix))


@functools.lru_cache(maxsize=None)
def make_plan(n: int) -> FftPlan:
    """The plan for lines of ``n`` points, a power of two from 2 to
    :data:`MAX_LENGTH`."""
    if n < 2 or n & (n - 1) or n > MAX_LENGTH:
        raise ValueError(f"no FFT plan for length {n}")
    elems = min(n, MAX_RADIX)
    radices = []
    rest = n
    while rest > 1:
        radices.append(min(rest, MAX_RADIX))
        rest //= radices[-1]
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


def lines_per_block(plan: FftPlan, min_lines: int, bytes_per_line: int) -> Optional[int]:
    """Lines one block of K1 or K3 transforms: at least ``min_lines``, more
    where a line takes fewer than 128 threads, halved until the block has
    at most :data:`MAX_THREADS` threads and two blocks' ``bytes_per_line``
    each fit in shared memory, or one line is left; None if no block fits."""
    lines = max(min_lines, 128 // plan.threads)
    while lines > 1 and (lines * plan.threads > MAX_THREADS
                         or lines * bytes_per_line > SMEM_LIMIT // 2):
        lines //= 2
    if lines * plan.threads > MAX_THREADS or lines * bytes_per_line > SMEM_LIMIT:
        return None
    return lines


def plan_ints(plan: FftPlan) -> np.ndarray:
    """The plan as the kernel's ``FftPlan`` struct reads it (int32): n,
    elems, threads, passes, buffer, then per pass (up to MAX_PASSES) log2
    of the radix, log2 of the stride and the table offset."""
    head = [plan.n, plan.elems, plan.threads, len(plan.radices), plan.buffer]
    lg_r = [int(r).bit_length() - 1 for r in plan.radices]
    lg_ns = [int(s).bit_length() - 1 for s in plan.strides]
    pad = [0] * (MAX_PASSES - len(plan.radices))
    return np.array(head + lg_r + pad + lg_ns + pad + list(plan.tw_offsets) + pad, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def device_plan(n: int, device: torch.device):
    """The plan for length n, its integers (host) and its twiddles on ``device``."""
    plan = make_plan(n)
    return plan, plan_ints(plan), torch.from_numpy(plan.twiddles).to(device)
