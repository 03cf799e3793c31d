"""The register-resident FFT core of K1 and K3, emulated on the CPU.

``csrc/fft_hopper.cuh`` runs only on the card.  These tests repeat its
index arithmetic in numpy, thread by thread and register by register, from
the plan and the twiddle tables the wrappers hand the kernels
(``ops/cuda/fft_plan.py``): the loads (thread j holds element j + T c in
register c), each pass's reads from and writes to the padded exchange, its
twiddles, its register DFT (radix-2 decimation in frequency with the
kernel's float32 constants) and the stores.  They hold the result to
``np.fft`` at every length the kernels take, K1's row pass (loads of the
nonzero rows, the mask and H at the spectral row each register holds, the
inverse as conj(F(conj(.))), the crop) and K2's row adjoint (the forward
transform of each distance's nonzero rows, conj(H) * mask, the distance
sum, then the inverse and crop or the scaled spectrum) to the port's plain
versions and to the JAX package's (``jax.vjp`` of its ``propagate_planes``
in Pallas interpret mode), the exchanges to a model of Hopper's
shared-memory banks (8-byte accesses: a half-warp's 16 lanes must fall on
16 distinct bank pairs), and the wrappers' predicates to the lengths and
grids the radix-2 kernels took.

The mixed-radix plans (lengths 2^a 3^b 5^c that are not powers of two,
each compiled into a library of its own) are emulated the same way: their
register DFTs (radix 3 and 5 by their direct formulas, composites as
P-point DFTs, the kernel's compile-time twiddles w_R^(n1 k2), then M-point
DFTs), the guarded butterflies of a middle pass whose radix does not
divide E (ceil(n / (R T)) a thread, the last off where jj >= n / R), the
exchanges' per-plan gaps, and a bank model that states their bound; the
block shapes the wrappers pick (8 interleaved columns where they fit) and
K1's and K2's row passes at the paths' rp 1280 and 2880.

Tolerance: float32 FFTs of up to 16384 points against float64 ``np.fft``,
<= 1e-5 of max |ref| (the rounding grows as log2 n, ~1e-6 here); K1's row
pass and K2's row adjoint against their plain versions at the card tests'
bounds (1e-4 at worst, 1e-5 at the 99.9th percentile); K2 against JAX at
``tests/test_torch_ops.py``'s 5e-5 of max |grad| (the JAX side's
split-bf16 DFT GEMMs).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.ops.pallas import spectral as jspectral
from learned_hologram_gan_tpu_torch.config import OpticsConfig
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.ops.cuda import fft, fft_plan, spectral

LENGTHS = [2**k for k in range(1, 15)]
# lengths of mixed-radix plans: small ones for the tests, the portrait grid
# (1280 x 768), 1080p's rp (1728) and the 4K grid's rows (2880)
MIXED_LENGTHS = [6, 12, 24, 48, 96, 384, 768, 1280, 1728, 2880]
CSRC = Path(spectral.__file__).resolve().parents[2] / "csrc"
# the constants of the kernel's register DFTs, w_32^q = cos - i sin of
# 2 pi q / 32 for q < 16, rounded to float32 (q = 8, -i, exact)
DFT_COS = np.cos(2 * np.pi * np.arange(16) / 32).astype(np.float32)
DFT_SIN = np.sin(2 * np.pi * np.arange(16) / 32).astype(np.float32)
DFT_COS[8] = 0.0


def _dft_pow2(a):
    """The kernel's dft_pow2: radix-2 decimation in frequency over the last
    axis, twiddles w_32^q from the float32 constants, bit-reversed result
    renamed into natural order."""
    a = a.copy()
    size = a.shape[-1]
    w = (DFT_COS - 1j * DFT_SIN).astype(np.complex64)
    half = size // 2
    while half >= 1:
        for start in range(0, size, 2 * half):
            for k in range(half):
                u, t = a[..., start + k].copy(), a[..., start + k + half].copy()
                a[..., start + k] = u + t
                q = k * (16 // half)
                a[..., start + k + half] = (u - t) if q == 0 else (u - t) * w[q]
        half //= 2
    bits = size.bit_length() - 1
    rev = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(size)]
    return a[..., rev]


def taylor_cos_sin(q, r):
    """fft_hopper.cuh:make_root_table, transcribed: (cos, sin)(2 pi q / r) by
    the Taylor series in double, the angle in (-pi, pi], rounded to float32."""
    qq = q - r if 2 * q > r else q
    x = 2.0 * 3.14159265358979323846 * qq / r
    ts, tc, s_, c_ = x, 1.0, x, 1.0
    for k in range(1, 30):
        ts *= -x * x / ((2 * k) * (2 * k + 1))
        s_ += ts
        tc *= -x * x / ((2 * k - 1) * (2 * k))
        c_ += tc
    return np.float32(c_), np.float32(s_)


def _mul_root(d, q, r):
    """fft_hopper.cuh:mul_root: d * w_r^q, the quarter turns exact."""
    if q == 0:
        return d
    if 2 * q == r:
        return -d
    if 4 * q == r:
        return (d * np.complex64(-1j)).astype(np.complex64)
    if 4 * q == 3 * r:
        return (d * np.complex64(1j)).astype(np.complex64)
    c, s_ = taylor_cos_sin(q, r)
    return (d * np.complex64(complex(c, -s_))).astype(np.complex64)


S3 = np.float32(np.sin(2 * np.pi / 3))
C5 = (np.float32(np.cos(2 * np.pi / 5)), np.float32(np.cos(4 * np.pi / 5)))
S5 = (np.float32(np.sin(2 * np.pi / 5)), np.float32(np.sin(4 * np.pi / 5)))


def _dft(a):
    """The kernel's dft_regs over the last axis, natural order in and out:
    powers of two by _dft_pow2, 3 and 5 by their direct formulas, any
    other R = P M (P = 5, else 3) as P-point DFTs at stride M, the twiddles
    w_R^(n1 k2), then M-point DFTs on contiguous blocks, renamed."""
    size = a.shape[-1]
    if size & (size - 1) == 0:
        return _dft_pow2(a)
    a = a.astype(np.complex64)
    mi = np.complex64(-1j)
    if size == 3:
        s_, d = a[..., 1] + a[..., 2], a[..., 1] - a[..., 2]
        m = a[..., 0] - np.float32(0.5) * s_
        return np.stack([a[..., 0] + s_, m + mi * (S3 * d), m - mi * (S3 * d)], axis=-1)
    if size == 5:
        s14, d14 = a[..., 1] + a[..., 4], a[..., 1] - a[..., 4]
        s23, d23 = a[..., 2] + a[..., 3], a[..., 2] - a[..., 3]
        m1 = a[..., 0] + C5[0] * s14 + C5[1] * s23
        m2 = a[..., 0] + C5[1] * s14 + C5[0] * s23
        n1 = S5[0] * d14 + S5[1] * d23
        n2 = S5[1] * d14 - S5[0] * d23
        return np.stack([a[..., 0] + s14 + s23, m1 + mi * n1, m2 + mi * n2, m2 - mi * n2,
                         m1 - mi * n1], axis=-1)
    p = 5 if size % 5 == 0 else 3
    m = size // p
    a = a.copy()
    for n1 in range(m):
        t = _dft(a[..., [n1 + m * n2 for n2 in range(p)]])
        for k2 in range(p):
            a[..., n1 + m * k2] = _mul_root(t[..., k2], n1 * k2, size)
    out = np.empty_like(a)
    for k2 in range(p):
        t = _dft(a[..., m * k2 : m * (k2 + 1)])
        for k1 in range(m):
            out[..., p * k1 + k2] = t[..., k1]
    return out


def _exchange_writes(plan, i, j):
    """Exchange positions pass ``i`` writes, per thread j (array) and slot
    b + r B_i: {slot: position}, -1 where butterfly b is guarded off (jj >=
    n / R_i), as the kernel computes them (q (Ns R + G) + jj mod Ns + r Ns,
    q = jj div Ns, G the exchange's gap: Ns for a power of two), held to
    pad_index of the Stockham output position."""
    radix, ns, t, gap = plan.radices[i], plan.strides[i], plan.threads, plan.gaps[i]
    b_count = plan.butterflies(i)
    span = plan.n // radix
    out = {}
    for b in range(b_count):
        jj = j + b * t
        valid = jj < span
        q = jj // ns
        base = q * (ns * radix + gap) + jj - q * ns
        for r in range(radix):
            pos = base + r * ns
            e = q * ns * radix + (jj % ns) + r * ns
            np.testing.assert_array_equal(pos[valid], fft_plan.pad_index(e, ns, radix, gap)[valid])
            out[b + r * b_count] = np.where(valid, pos, -1)
    return out


def _exchange_reads(plan, i, j):
    """Exchange positions pass ``i`` (> 0) reads, as the kernel computes
    them (jj + G (jj div Ns) + r (n / R + G (n / R) / Ns), G the previous
    exchange's gap), held to pad_index of the input position jj + r n / R;
    -1 where the butterfly is guarded off."""
    radix, t, n = plan.radices[i], plan.threads, plan.n
    ns, gap = plan.strides[i], plan.gaps[i - 1]
    b_count = plan.butterflies(i)
    span = n // radix
    stride = span + gap * (span // ns)
    out = {}
    for b in range(b_count):
        jj = j + b * t
        valid = jj < span
        for r in range(radix):
            pos = jj + gap * (jj // ns) + r * stride
            want = fft_plan.pad_index(jj + r * span, plan.strides[i - 1], plan.radices[i - 1], gap)
            np.testing.assert_array_equal(pos[valid], want[valid])
            out[b + r * b_count] = np.where(valid, pos, -1)
    return out


def emulate_line_fft(v, plan):
    """fft_line on registers v (lines, T, E) complex64: the forward FFT,
    through the exchange buffer as the kernel goes through it.  A pass holds
    B_i R_i slots a thread (E in the first and the last)."""
    v = v.astype(np.complex64).copy()
    lines, t, e = v.shape
    assert (t, e) == (plan.threads, plan.elems)
    j = np.arange(t)
    buf = None
    passes = len(plan.radices)
    for i, (radix, ns, off) in enumerate(zip(plan.radices, plan.strides, plan.tw_offsets)):
        b_count = plan.butterflies(i)
        if i == 0:
            assert b_count * radix == e, "the first radix divides E"
            u = v
        else:
            u = np.zeros((lines, t, b_count * radix), dtype=np.complex64)
            for slot, pos in _exchange_reads(plan, i, j).items():
                ok = pos >= 0
                assert not np.isnan(buf[:, pos[ok]]).any(), "read of a position no thread wrote"
                u[:, ok, slot] = buf[:, pos[ok]]
        for b in range(b_count):
            if ns > 1:
                m = (j + b * t) % ns
                for r in range(1, radix):
                    u[:, :, b + r * b_count] *= plan.twiddles[off + (r - 1) * ns + m]
            u[:, :, b::b_count] = _dft(u[:, :, b::b_count])
        if i + 1 < passes:
            buf = np.full((lines, plan.buffer), np.nan, dtype=np.complex64)
            written = np.zeros(plan.buffer, dtype=int)
            for slot, pos in _exchange_writes(plan, i, j).items():
                ok = pos >= 0
                assert pos.max() < plan.buffer
                np.add.at(written, pos[ok], 1)
                buf[:, pos[ok]] = u[:, ok, slot]
            assert written.max() == 1, "two threads wrote one position"
            assert written.sum() == plan.n, "a position no thread wrote"
        else:
            assert b_count * radix == e, "the last radix divides E"
            v = u
    return v


def emulate_fft(x, inverse=False):
    """K3 on lines x (lines, n): load, fft_line, store; the inverse as
    conj(F(conj(x))), unscaled."""
    n = x.shape[-1]
    plan = fft_plan.make_plan(n)
    idx = np.arange(plan.threads)[:, None] + plan.threads * np.arange(plan.elems)[None, :]
    v = x[:, idx].astype(np.complex64)
    v = emulate_line_fft(np.conj(v) if inverse else v, plan)
    y = np.empty_like(x, dtype=np.complex64)
    y[:, idx] = np.conj(v) if inverse else v
    return y


@pytest.mark.parametrize("n", LENGTHS + MIXED_LENGTHS)
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_core_emulation_matches_numpy(n, inverse):
    rng = np.random.default_rng(n)
    lines = max(2, 4096 // n)
    x = (rng.standard_normal((lines, n)) + 1j * rng.standard_normal((lines, n))).astype(np.complex64)
    got = emulate_fft(x, inverse)
    want = np.fft.ifft(x.astype(np.complex128)) * n if inverse else np.fft.fft(x.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", LENGTHS + MIXED_LENGTHS + [5000])
def test_plan_tables(n):
    """The plan's radices multiply to n, the first and the last divide E; a
    power of two keeps radix 32 for every pass but the last and its
    library reads the 14-int plan, any other length is its own library,
    the plan spelled in its macros; the twiddle tables are exp(-2 pi i r m
    / (Ns R)) rounded once to complex64, and the integers the kernel reads
    say the same."""
    plan = fft_plan.make_plan(n)
    assert np.prod(plan.radices) == n and plan.elems * plan.threads == n
    assert all(r in fft_plan.RADICES for r in plan.radices)
    assert plan.elems % plan.radices[0] == 0 and plan.elems % plan.radices[-1] == 0
    assert plan.threads <= plan.max_threads and plan.max_threads % plan.threads == 0
    assert len(plan.gaps) == len(plan.radices) - 1
    if n & (n - 1) == 0:
        assert plan.elems == min(n, 32) and plan.max_threads == fft_plan.MAX_THREADS
        assert all(r == fft_plan.MAX_RADIX for r in plan.radices[:-1])
        assert all(plan.elems % r == 0 for r in plan.radices)
        assert plan.gaps == plan.strides[:-1]
        assert fft_plan.build_defines(plan) == ()
    else:
        assert plan.elems <= fft_plan.MAX_ELEMS and len(plan.radices) <= fft_plan.MAX_PASSES
        assert plan.max_threads <= fft_plan.MAX_BLOCK_THREADS
        assert all(0 <= g < fft_plan.BANK_PAIRS for g in plan.gaps)
        assert plan.columns == (fft._pick_lpb(plan, True) or 0, spectral._pick_cpb(plan, False) or 0,
                                spectral._pick_cpb(plan, True) or 0)
        assert fft_plan.build_defines(plan) == (
            f"LHG_FFT_ELEMS={plan.elems}", "LHG_FFT_RADICES=" + ".".join(map(str, plan.radices)),
            "LHG_FFT_GAPS=" + (".".join(map(str, plan.gaps)) or "0"),
            f"LHG_FFT_MAX_THREADS={plan.max_threads}",
            "LHG_FFT_COLUMNS=" + ".".join(map(str, plan.columns)))
    for radix, ns, off in zip(plan.radices, plan.strides, plan.tw_offsets):
        if ns == 1:
            continue
        r, m = np.meshgrid(np.arange(1, radix), np.arange(ns), indexing="ij")
        want = np.exp(-2j * np.pi * r * m / (ns * radix)).astype(np.complex64).reshape(-1)
        np.testing.assert_array_equal(plan.twiddles[off:off + want.size], want)
    ints = fft_plan.plan_ints(plan)
    passes = len(plan.radices)
    assert ints.dtype == np.int32 and list(ints[:5]) == [n, plan.elems, plan.threads, passes, plan.buffer]
    if n & (n - 1) == 0:
        # the power-of-two library's struct: log2 radix, log2 Ns, offsets
        assert ints.size == 5 + 3 * fft_plan.POW2_MAX_PASSES
        lg_radix, lg_ns, tw_off = (ints[5 + k * fft_plan.POW2_MAX_PASSES:][:passes] for k in range(3))
        assert [1 << int(v) for v in lg_radix] == list(plan.radices)
        assert [1 << int(v) for v in lg_ns] == list(plan.strides)
        assert list(tw_off) == list(plan.tw_offsets)
    else:
        assert ints.size == 5  # the head the library checks against its compiled plan


# (n, E, radices): the paths' lengths take fft_plan.CHOSEN (the fastest of
# fft_ablation.py's candidates on the card that spill nothing and keep 8
# columns), the others the rule
@pytest.mark.parametrize("n,elems,radices", [
    (768, 16, (16, 3, 16)), (1280, 16, (16, 5, 16)), (1728, 24, (24, 24, 3)), (2880, 60, (12, 20, 12)),
    (5000, 40, (40, 25, 5)), (6, 6, (6,)), (96, 24, (4, 24)), (384, 24, (2, 8, 24))])
def test_mixed_radix_plans(n, elems, radices):
    """The plans of the grids' lengths, and the rule's for others: at most
    32 values a thread in every pass where a rule's plan has them (2880
    takes E = 60 in 8 columns of 48 threads, 5000 E = 40: the candidates of
    fewer values spilled or lost), one line at least a block, and 8
    columns a block at the paths' strided lengths."""
    plan = fft_plan.make_plan(n)
    assert (plan.elems, plan.radices) == (elems, radices)
    if n not in fft_plan.CHOSEN:
        assert plan.peak_values <= fft_plan.TARGET_VALUES
        assert min(fft_plan.candidates(n), key=lambda c: fft_plan._rule_key(n, *c)) == (elems, radices)
    assert plan.max_threads >= plan.threads
    if n in (1280, 1728, 2880):
        assert plan.max_threads == fft_plan.COLUMNS * plan.threads


def test_every_smooth_length_has_a_plan_but_five():
    """make_plan takes every 2^a 3^b 5^c from 2 to 16384 (the five the
    fewest-passes plans left out, 9375, 15552, 15625, 16000 and 16200, now
    too: their threads hold fewer values in more passes), and nothing
    else."""
    smooth = [n for n in range(2, fft_plan.MAX_LENGTH + 1) if fft_plan.is_smooth(n)]
    missing = []
    for n in smooth:
        try:
            plan = fft_plan.make_plan(n)
        except ValueError:
            missing.append(n)
            continue
        assert len(plan.radices) <= max(fft_plan.MAX_PASSES, fft_plan.POW2_MAX_PASSES)
    assert missing == []
    for n in (1, 7, 14, 34, 3048, 16385, 32768):
        with pytest.raises(ValueError):
            fft_plan.make_plan(n)


def test_kernel_sources_match_plan():
    """The header's DFT constants are the float32 values the emulation
    uses; the power-of-two library keeps its 14-int plan, its E list and
    its block limit; a mixed-radix library reads its plan from its macros
    alone (no radix switch, no plan struct of integers at run time) and
    launches with the plan's limit; the compile-time twiddles (Taylor
    series, transcribed) round to numpy's float32 cos and sin wherever they
    are read."""
    src = (CSRC / "fft_hopper.cuh").read_text()
    for name, want in (("kCos", DFT_COS), ("kSin", DFT_SIN)):
        body = re.search(name + r"\[16\] = \{([^}]*)\}", src).group(1)
        got = np.array([float(v.strip().rstrip("f")) for v in body.split(",")], dtype=np.float32)
        np.testing.assert_array_equal(got, want)
    mixed, pow2 = src.split("#ifdef LHG_FFT_RADICES\n#define LHG_FFT_STR2", 1)[1].split("#else", 1)
    assert "LHG_FFT_STR(LHG_FFT_RADICES)" in mixed and "LHG_FFT_STR(LHG_FFT_GAPS)" in mixed
    assert f"kPasses <= {fft_plan.MAX_PASSES}" in mixed and "int lg_ns" not in mixed
    assert f"kMaxPasses = {fft_plan.POW2_MAX_PASSES};" in pow2 and "int lg_ns[kMaxPasses];" in pow2
    assert f"sizeof(FftPlan) == {5 + 3 * fft_plan.POW2_MAX_PASSES} * sizeof(int)" in pow2.split("#endif")[0]
    assert "switch (p.radix" not in src and "magic" not in src
    assert "#define LHG_FFT_KERNEL_ELEMS(X) X(32) X(16) X(8) X(4) X(2)" in src
    assert "#define LHG_FFT_KERNEL_ELEMS(X) X(LHG_FFT_ELEMS)" in src
    assert "#define LHG_FFT_LAUNCH_BOUND(E) LHG_FFT_MAX_THREADS" in src
    assert "#define LHG_FFT_LAUNCH_BOUND(E) E > 32 ? 256 : 512" in src
    consts = {name: np.float32(float(v)) for name, v in re.findall(r"k(S3|C1|C2|S1|S2) = (-?[0-9.]+)f", src)}
    assert consts == {"S3": S3, "C1": C5[0], "C2": C5[1], "S1": S5[0], "S2": S5[1]}
    assert "__launch_bounds__(LHG_FFT_K3_LAUNCH_BOUND(E, kColumns))" in (CSRC / "k3_fft.cu").read_text()
    assert "#define LHG_FFT_K3_LAUNCH_BOUND(E, kColumns) E > 32 ? 256 : 512" in src
    assert "__launch_bounds__(LHG_FFT_LAUNCH_BOUND(E))" in (CSRC / "k1_asm_propagate.cu").read_text()
    for kernel in ("k3_fft.cu", "k1_asm_propagate.cu"):
        assert "plan_ints_match" in (CSRC / kernel).read_text()
    assert "LHG_FFT_STR(LHG_FFT_COLUMNS)" in mixed
    for r in sorted({r for r in fft_plan.RADICES if r & (r - 1)}):
        for q in range(1, r):
            if 4 * q % r:  # the quarter turns are exact, never read from the table
                assert taylor_cos_sin(q, r) == (np.float32(np.cos(2 * np.pi * q / r)),
                                                np.float32(np.sin(2 * np.pi * q / r))), (r, q)


def _half_warp_conflicts(addresses):
    """Extra shared-memory wavefronts of one warp-wide 8-byte access:
    ``addresses`` (32,) float2 positions (-1: lane idle); a half-warp's
    distinct positions must fall on distinct bank pairs (position mod 16)."""
    extra = 0
    for half in (addresses[:16], addresses[16:]):
        pos = np.unique(half[half >= 0])
        extra += len(pos) - len(np.unique(pos % 16))
    return extra


def _layouts(plan):
    """(name, lines per block, columns interleaved) of every block shape
    the wrappers launch for this plan."""
    out = [("K3 axis -1", fft._pick_lpb(plan, False), False),
           ("K3 axis -2", fft._pick_lpb(plan, True), True)]
    if spectral.supported(plan.n, 8):
        # K2 launches K1's block shapes (its distance sum takes the second
        # array where K1 keeps the spectrum)
        out += [(f"{k} {label}", spectral._pick_cpb(plan, keep), True)
                for k in ("K1", "K2") for label, keep in (("D = 1", False), ("D > 1", True))]
    return out


@pytest.mark.parametrize("n", [n for n in LENGTHS if n > fft_plan.MAX_RADIX])
def test_exchanges_free_of_bank_conflicts(n):
    """Every warp's reads and writes of every exchange, in every block
    shape the wrappers launch, fall on distinct bank pairs per half-warp,
    and lie inside the block's shared memory."""
    plan = fft_plan.make_plan(n)
    t = plan.threads
    for name, lpb, columns in _layouts(plan):
        threads = lpb * t
        tid = np.arange(threads)
        line = tid % lpb if columns else tid // t
        j = tid // lpb if columns else tid % t
        for i in range(len(plan.radices)):
            accesses = []
            if i + 1 < len(plan.radices):
                accesses.append(_exchange_writes(plan, i, j))
            if i > 0:
                accesses.append(_exchange_reads(plan, i, j))
            for regs in accesses:
                for pos in regs.values():
                    addr = pos * lpb + line if columns else line * plan.buffer + pos
                    addr = np.where(pos >= 0, addr, -1)
                    assert addr.max() < lpb * plan.buffer
                    for w in range(0, threads, 32):
                        warp = np.full(32, -1)
                        warp[: min(32, threads - w)] = addr[w:w + 32]
                        assert _half_warp_conflicts(warp) == 0, (name, n, i)


def _max_ways(plan, columns_only=False):
    """The most accesses one bank pair takes in a half-warp, over every
    warp's reads and writes of every exchange in every block shape the
    wrappers launch (``columns_only``: those of interleaved columns, K3
    along axis -2, K1 and K2) (1: conflict-free); each address inside the
    block's shared memory."""
    t = plan.threads
    ways = 1
    for name, lpb, columns in _layouts(plan):
        if columns_only and not columns:
            continue
        threads = lpb * t
        tid = np.arange(threads)
        line = tid % lpb if columns else tid // t
        j = tid // lpb if columns else tid % t
        for i in range(len(plan.radices)):
            accesses = []
            if i + 1 < len(plan.radices):
                accesses.append(_exchange_writes(plan, i, j))
            if i > 0:
                accesses.append(_exchange_reads(plan, i, j))
            for regs in accesses:
                for pos in regs.values():
                    addr = pos * lpb + line if columns else line * plan.buffer + pos
                    addr = np.where(pos >= 0, addr, -1)
                    assert addr.max() < lpb * plan.buffer
                    for w in range(0, threads, 16):
                        half = np.unique(addr[w:w + 16])
                        half = half[half >= 0]
                        if half.size:
                            ways = max(ways, int(np.bincount(half % 16).max()))
    return ways


@pytest.mark.parametrize("n,bound", [(96, 1), (384, 2), (768, 1), (1280, 1), (1728, 2), (2880, 2),
                                     (5000, 2), (75, 4), (375, 3)])
def test_mixed_radix_exchanges_bank_conflicts_bounded(n, bound):
    """The gap each exchange of a mixed-radix plan takes (fft_plan.py's
    bank model, below 16) bounds its conflicts: 768 and 1280 are
    conflict-free in every block shape, and so are 63 of the 173 multi-pass
    mixed lengths up to 16384; 95 take at most 2 accesses a bank pair
    (1728 and 2880 only along axis -1, on no path; 5000 where its second
    pass reads across a block of 40, since the gap that frees that read
    makes the first pass's writes 8-way), 10 take 3 (45, 54, 72, 81, 90,
    270, 360, 375, 600, 1800) and 5 take 4 (50, 75, 100, 125, 150).  The
    gap Ns of the fewest-passes plans took up to 16 (375) and 2 at every
    path length."""
    plan = fft_plan.make_plan(n)
    assert len(plan.radices) > 1
    assert _max_ways(plan) == bound


@pytest.mark.parametrize("n", [1280, 1728, 2880])
def test_mixed_radix_column_exchanges_free_of_bank_conflicts(n):
    """The lengths the paths run as interleaved columns (K3 along axis -2
    at 1280 and 2880, K1 and K2 at rp 1280, 1728 and 2880): every block
    shape's exchanges are conflict-free."""
    assert _max_ways(fft_plan.make_plan(n), columns_only=True) == 1


def _old_supported_length(n):
    # the radix-2 K3: one (n, 1) tile and n/2 twiddles in 227 KB
    return n >= 2 and n & (n - 1) == 0 and (n + n // 2) * 8 <= 232448


def _old_k1_supported(rp, cp):
    # the radix-2 K1/K2: two (rp, tc) buffers and rp/2 twiddles, tc | cp
    return rp >= 2 and rp & (rp - 1) == 0 and any(
        cp % tc == 0 and (2 * rp * tc + rp // 2) * 8 <= 232448 for tc in (4, 2, 1))


def test_predicates_accept_what_the_radix2_kernels_did():
    """K3's lengths and K1's grids are a superset of what they were before
    the register-resident core: every power of two from 2 to 16384, and the
    card tests' grids plus rp = 2048, 4096 and 8192."""
    old = [n for n in range(1, 40000) if _old_supported_length(n)]
    assert old == LENGTHS
    assert all(fft.supported_length(n) for n in old)
    grids = [(32, 40), (64, 64), (1024, 1024), (2048, 2048), (4096, 4096), (8192, 8192),
             (2048, 1000), (8192, 7)]
    for rp in [2**k for k in range(0, 16)]:
        for cp in [1, 2, 3, 8, 40, 42, 64, 1000, 1024, 1027]:
            grids.append((rp, cp))
    for rp, cp in grids:
        if _old_k1_supported(rp, cp):
            assert spectral.supported(rp, cp), (rp, cp)
    assert all(_old_k1_supported(*g) for g in [(32, 40), (64, 64), (1024, 1024), (2048, 2048),
                                              (4096, 4096), (8192, 8192)])


def test_predicates_accept_the_mixed_radix_lengths():
    """K3 takes the portrait grid (1280 x 768), the 4K grid (2880 x 5000)
    and 1728; K1 and K2 take rp = 768, 1280, 1728, 2880 and 5000 at any
    cp; both refuse lengths with another prime factor (1080p's 3048 =
    8 * 3 * 127 columns: K3 declines that grid, K1 takes it).  K3 takes the
    five smooth lengths the fewest-passes plans had none for, K1 the one
    whose line and kept spectrum fit a block (9375).  K3's length predicate
    is exactly "has a plan whose blocks fit"."""
    for n in (6, 12, 24, 48, 96, 384, 768, 1280, 1728, 2880, 5000, 9375):
        assert fft.supported_length(n), n
        assert spectral.supported(n, 7) and spectral.supported(n, 3048), n
    for n in (15552, 15625, 16000, 16200):
        assert fft.supported_length(n) and not spectral.supported(n, 7), n
    assert fft.supported(1280, 768) and fft.supported(2880, 5000)
    assert not fft.supported(1728, 3048)
    for n in (14, 34, 3048, 16385):
        assert not fft.supported_length(n) and not spectral.supported(n, 64), n
    for n in range(2, fft_plan.MAX_LENGTH + 1):
        try:
            plan = fft_plan.make_plan(n)
        except ValueError:
            assert not fft.supported_length(n)
            continue
        fits = fft._pick_lpb(plan, False) is not None and fft._pick_lpb(plan, True) is not None
        assert fft.supported_length(n) == fits


def _emulate_row_pass(x, wl2, dists, mask, cfg):
    """K1's row pass on the column-transformed input x (numpy, as the
    kernel holds it): per plane and column, load the nonzero rows (or the
    spectrum) into registers, FFT, then per distance H * mask at the row
    each register holds (times the spectrum, which the mask multiplied once;
    skipped where that product is 0), conj(F(conj(.))), and the crop window
    stored."""
    pitch, conj_h, from_spectrum, per_plane, num_d, rp, cp, r0, rows, _, _ = spectral._unpack(cfg)
    plan = fft_plan.make_plan(rp)
    k = np.arange(plan.threads)[:, None] + plan.threads * np.arange(plan.elems)[None, :]
    p_count = x.shape[0]
    lines = x.transpose(0, 2, 1).reshape(p_count * cp, -1)  # (P * cp, rows | rp)
    if from_spectrum:
        v = lines[:, k]
    else:
        inside = (k >= r0) & (k < r0 + rows)
        v = np.where(inside, lines[:, np.clip(k - r0, 0, rows - 1)], 0)
        v = emulate_line_fft(v, plan)
    # H in the kernel's float32 order (h_masked)
    f32 = np.float32
    kr = np.where(k >= (rp + 1) // 2, k - rp, k).astype(f32)
    col = np.tile(np.arange(cp), p_count)
    kc = np.where(col >= (cp + 1) // 2, col - cp, col).astype(f32)
    fx = kr * f32(1.0 / (rp * pitch))
    fy = kc * f32(1.0 / (cp * pitch))
    sq = (fx * fx)[None] + (fy * fy)[:, None, None]
    wl2_line = np.repeat(wl2.reshape(-1), cp)[:, None, None]
    w = np.sqrt(np.maximum(wl2_line - sq, f32(0)))
    sign = f32(2 * np.pi if conj_h else -2 * np.pi)
    out = np.zeros((p_count, num_d, rows, cp), dtype=np.complex64)
    keep = (k >= r0) & (k < r0 + rows)
    if mask is not None:  # the spectrum times the mask, once
        v = v * np.tile(mask.T, (p_count, 1))[:, k]
    for d in range(num_d):
        z = np.repeat(dists.reshape(-1), cp)[:, None, None] if per_plane else dists.reshape(-1)[d]
        theta = (sign * f32(z)) * w
        h = (np.cos(theta) + 1j * np.sin(theta)).astype(np.complex64)
        y = np.conj(emulate_line_fft(np.conj(np.where(v != 0, v * h, 0)), plan)) / f32(rp)
        for line in range(p_count * cp):
            p, c = divmod(line, cp)
            out[p, d, k[keep] - r0, c] = y[line][keep]
    return out


# (conj_h, num_d, from_spectrum, per_plane, mask_override), as tests/test_torch_cuda.py:MODES
MODES = {
    "backward": (True, 1, False, False, False),
    "stack": (False, 3, False, False, False),
    "from_spectrum": (False, 3, True, False, False),
    "from_spectrum_per_plane": (False, 1, True, True, False),
    "field_per_plane_mask_override": (False, 1, False, True, True),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rows,cols,pad", [(24, 32, 4), (40, 24, 12), (40, 24, 20)])
def test_k1_row_pass_emulation_matches_plain_version(mode, rows, cols, pad):
    """K1's index arithmetic in every mode, on a 32-row grid (one pass, no
    exchange), a 64-row grid (two passes) and the portrait grid's shape at
    1/16 (40 x 24 at pads 20 / 12: 80 x 48, rp = 80 = 20 * 4 on E = 20),
    with a seeded field in the caller's mask so that a mirrored row or
    column read shows."""
    conj_h, num_d, from_spectrum, per_plane, override = MODES[mode]
    optics = OpticsConfig(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45)
    plan = asm.make_plan(optics, distances=np.linspace(4e-4, 1e-3, 3 if per_plane else num_d), device="cpu")
    rng = np.random.default_rng(7)
    batch = 2
    shape = (batch, 3) + ((optics.padded_rows, optics.padded_cols) if from_spectrum else (rows, cols))
    amp = torch.from_numpy(rng.random(shape).astype(np.float32))
    phs = torch.from_numpy((2 * np.pi * rng.random(shape)).astype(np.float32))
    dists = plan.distances[torch.arange(batch) % 3] if per_plane else plan.distances
    mask = None
    if override:
        mask = plan.mask * torch.from_numpy(rng.uniform(0.5, 1.0, tuple(plan.mask.shape)).astype(np.float32))
    args = asm.fused_args(plan, asm.field(amp, phs), dists, conj_h=conj_h, from_spectrum=from_spectrum,
                          per_plane=per_plane, use_mask=not conj_h, mask_override=mask)
    fr, fi, wl2, dvec, m, cfg = args
    _, _, _, _, _, rp, cp, r0, crop_rows, c0, crop_cols = spectral._unpack(cfg)
    g = torch.complex(fr, fi)
    if not from_spectrum:  # the wrapper's column transform (torch.fft)
        g = torch.fft.fft(torch.nn.functional.pad(g, (c0, cp - crop_cols - c0)), dim=-1)
    y = _emulate_row_pass(g.numpy(), wl2.numpy(), dvec.numpy(), None if m is None else m.numpy(), cfg)
    y = torch.fft.ifft(torch.from_numpy(y), dim=-1)[..., c0:c0 + crop_cols]
    rr, ri = spectral.propagate_planes_reference(*args)
    err = torch.sqrt((y.real - rr) ** 2 + (y.imag - ri) ** 2).flatten()
    rel = err / torch.sqrt(rr**2 + ri**2).max()
    assert float(rel.max()) <= 1e-4
    assert float(rel.sort().values[int(0.999 * (rel.numel() - 1))]) <= 1e-5


def _radix2_era_lines_per_block(plan, min_lines, bytes_per_line):
    # the block-size search as K3's and K1's wrappers each wrote it out
    # before they shared fft_plan.lines_per_block
    lines = max(min_lines, 128 // plan.threads)
    while lines > 1 and (lines * plan.threads > 512 or lines * bytes_per_line > 232448 // 2):
        lines //= 2
    if lines * plan.threads > 512 or lines * bytes_per_line > 232448:
        return None
    return lines


# (K3 axis -1, K3 axis -2, K1/K2 D = 1, K1/K2 D > 1) lines a block at the
# paths' mixed-radix lengths: 8 interleaved columns (64-byte row segments)
# wherever one block's threads and shared memory hold them (2880 with the
# spectrum kept: 4, 46 KB a column)
MIXED_BLOCK_SHAPES = {768: (2, 8, 8, 8), 1280: (1, 8, 8, 8), 1728: (1, 8, 8, 8), 2880: (2, 8, 8, 4),
                      5000: (1, 4, 4, 2)}


@pytest.mark.parametrize("n", LENGTHS + list(MIXED_BLOCK_SHAPES))
def test_block_shapes_match_the_wrappers_own_searches(n):
    """K3's lines per block along either axis and K1's columns per block,
    with the spectrum kept or not: for the powers of two as each wrapper
    picked them with its own copy of the search; for the paths' mixed
    lengths 8 columns a block where they fit, within the plan's block limit
    and 227 KB.  The plan never needs more passes than its library takes."""
    plan = fft_plan.make_plan(n)
    assert len(plan.radices) <= (fft_plan.POW2_MAX_PASSES if plan.pow2 else fft_plan.MAX_PASSES)
    shapes = (fft._pick_lpb(plan, False), fft._pick_lpb(plan, True), spectral._pick_cpb(plan, False),
              spectral._pick_cpb(plan, True))
    if not plan.pow2:
        assert shapes == MIXED_BLOCK_SHAPES[n]
        limits = (plan.line_threads,) + (plan.max_threads,) * 3
        for lines, per_line, limit in zip(shapes, (plan.buffer, plan.buffer, max(plan.buffer, n),
                                                   max(plan.buffer, n) + n), limits):
            assert lines * plan.threads <= limit and lines * per_line * 8 <= fft_plan.SMEM_LIMIT
        assert plan.columns == shapes[1:]
        return
    for columns in (False, True):
        assert fft._pick_lpb(plan, columns) == _radix2_era_lines_per_block(
            plan, 8 if columns else 1, plan.buffer * 8)
    for keep in (False, True):
        values = max(plan.buffer, plan.n) + (plan.n if keep else 0)
        assert spectral._pick_cpb(plan, keep) == _radix2_era_lines_per_block(plan, 8, values * 8)
    if n == 1024:
        assert (fft._pick_lpb(plan, False), fft._pick_lpb(plan, True)) == (4, 8)
        assert (spectral._pick_cpb(plan, False), spectral._pick_cpb(plan, True)) == (8, 4)


def _emulate_row_adjoint(x, wl2, dists, mask, cfg):
    """K2's row adjoint on the column-transformed cotangent x (P, D, rows,
    cp), as the kernel runs it: per plane, column and distance, load the
    nonzero rows into registers, FFT, then conj(H) * mask at the row each
    register holds (H with the forward's sign negated; skipped where the
    mask is 0), summed over the distances; then the sum scaled by 1 / rp
    (from_spectrum, (P, rp, cp)) or conj(F(conj(sum))) / rp with the crop
    window stored ((P, rows, cp))."""
    pitch, conj_h, from_spectrum, per_plane, num_d, rp, cp, r0, rows, _, _ = spectral._unpack(cfg)
    plan = fft_plan.make_plan(rp)
    k = np.arange(plan.threads)[:, None] + plan.threads * np.arange(plan.elems)[None, :]
    p_count = x.shape[0]
    f32 = np.float32
    kr = np.where(k >= (rp + 1) // 2, k - rp, k).astype(f32)
    col = np.tile(np.arange(cp), p_count)
    kc = np.where(col >= (cp + 1) // 2, col - cp, col).astype(f32)
    fx = kr * f32(1.0 / (rp * pitch))
    fy = kc * f32(1.0 / (cp * pitch))
    sq = (fx * fx)[None] + (fy * fy)[:, None, None]
    wl2_line = np.repeat(wl2.reshape(-1), cp)[:, None, None]
    w = np.sqrt(np.maximum(wl2_line - sq, f32(0)))
    sign = f32(-2 * np.pi if conj_h else 2 * np.pi)  # the forward's, negated
    m = np.ones_like(w) if mask is None else np.tile(mask.T, (p_count, 1))[:, k]
    inside = (k >= r0) & (k < r0 + rows)
    acc = np.zeros((p_count * cp,) + k.shape, dtype=np.complex64)
    for d in range(num_d):
        lines = x[:, d].transpose(0, 2, 1).reshape(p_count * cp, rows)
        v = np.where(inside, lines[:, np.clip(k - r0, 0, rows - 1)], 0)
        v = emulate_line_fft(v, plan)
        z = np.repeat(dists.reshape(-1), cp)[:, None, None] if per_plane else dists.reshape(-1)[d]
        theta = (sign * f32(z)) * w
        h = (np.cos(theta) + 1j * np.sin(theta)).astype(np.complex64)
        if mask is not None:
            h = (h.real * m + 1j * (h.imag * m)).astype(np.complex64)
        acc = acc + np.where(m != 0, v * h, 0).astype(np.complex64)
    scale = f32(1.0 / rp)
    if from_spectrum:
        out = np.zeros((p_count, rp, cp), dtype=np.complex64)
        y = acc * scale
        for line in range(p_count * cp):
            p, c = divmod(line, cp)
            out[p, k.reshape(-1), c] = y[line].reshape(-1)
        return out
    y = np.conj(emulate_line_fft(np.conj(acc), plan)) * scale
    out = np.zeros((p_count, rows, cp), dtype=np.complex64)
    for line in range(p_count * cp):
        p, c = divmod(line, cp)
        out[p, k[inside] - r0, c] = y[line][inside]
    return out


# (conj_h, num_d, from_spectrum, per_plane, mask): every mode K2 runs:
# AP2POH's conj(H) step (no mask); field input with the plan's mask at 1,
# 3 and 20 distances; the train step's from_spectrum + per_plane; the two-H
# hat path's field + per_plane with a caller's fractional mask
K2_MODES = {
    "conj_h": (True, 1, False, False, None),
    "field_d1": (False, 1, False, False, "plan"),
    "field_d3": (False, 3, False, False, "plan"),
    "field_d20": (False, 20, False, False, "plan"),
    "from_spectrum_per_plane": (False, 1, True, True, "plan"),
    "field_per_plane_fractional_mask": (False, 1, False, True, "override"),
}


@pytest.mark.parametrize("mode", list(K2_MODES))
@pytest.mark.parametrize("rows,cols,pad", [(24, 32, 4), (40, 23, 12), (40, 24, 20)])
def test_k2_row_adjoint_emulation_matches_plain_version_and_jax(mode, rows, cols, pad):
    """K2's index arithmetic in every mode, on a 32-row grid (one pass), a
    64-row grid of 47 columns (two passes; a column count no block of 8
    divides) and the portrait grid's shape at 1/16 (80 x 48, a mixed-radix
    rp), through the wrapper's column transforms, against the plain
    adjoint and against jax.vjp of the JAX package's propagate_planes."""
    conj_h, num_d, from_spectrum, per_plane, mask_kind = K2_MODES[mode]
    optics = OpticsConfig(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45)
    plan = asm.make_plan(optics, distances=np.linspace(-4e-4, 1e-3, 3 if per_plane else num_d),
                         device="cpu")
    rng = np.random.default_rng(11)
    batch = 2
    rp, cp = optics.padded_rows, optics.padded_cols
    shape = (batch, 3) + ((rp, cp) if from_spectrum else (rows, cols))
    g = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64))
    dists = plan.distances[torch.arange(batch) % 3] if per_plane else plan.distances
    mask = None
    if mask_kind == "override":
        mask = plan.mask * torch.from_numpy(rng.uniform(0.5, 1.0, (rp, cp)).astype(np.float32))
    fr, fi, wl2, dvec, m, cfg = asm.fused_args(
        plan, g, dists, conj_h=conj_h, from_spectrum=from_spectrum, per_plane=per_plane,
        use_mask=mask_kind is not None, mask_override=mask)
    _, _, _, _, _, _, _, r0, crop_rows, c0, crop_cols = spectral._unpack(cfg)
    gshape = (fr.shape[0], num_d, rows, cols)
    gr = torch.from_numpy(rng.standard_normal(gshape).astype(np.float32))
    gi = torch.from_numpy(rng.standard_normal(gshape).astype(np.float32))
    # the wrapper around K2 (spectral._adjoint_cuda): column transform of
    # the embedded cotangent, the row adjoint, then / cp or the inverse
    # column transform and crop
    x = torch.fft.fft(torch.nn.functional.pad(torch.complex(gr, gi), (c0, cp - crop_cols - c0)), dim=-1)
    y = torch.from_numpy(_emulate_row_adjoint(x.numpy(), wl2.numpy(), dvec.numpy(),
                                              None if m is None else m.numpy(), cfg))
    y = y / cp if from_spectrum else torch.fft.ifft(y, dim=-1)[..., c0:c0 + crop_cols]
    rr, ri = spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, m, cfg)
    err = torch.sqrt((y.real - rr) ** 2 + (y.imag - ri) ** 2).flatten()
    rel = err / torch.sqrt(rr**2 + ri**2).max()
    assert float(rel.max()) <= 1e-4
    assert float(rel.sort().values[int(0.999 * (rel.numel() - 1))]) <= 1e-5

    consts = [None if a is None else jnp.asarray(a.numpy()) for a in (wl2, dvec, m)]
    _, vjp = jax.vjp(lambda a, b: jspectral.propagate_planes(a, b, *consts, cfg),
                     jnp.asarray(fr.numpy()), jnp.asarray(fi.numpy()))
    jdr, jdi = jax.jit(vjp)((jnp.asarray(gr.numpy()), jnp.asarray(gi.numpy())))
    want = np.asarray(jdr) + 1j * np.asarray(jdi)
    assert np.max(np.abs(y.numpy() - want)) / np.abs(want).max() <= 5e-5


def _blocks_cover_every_column_once(plan, cp, cpb):
    """The launch's blocks (cpb columns of T threads each, thread t on
    column block * cpb + t % cpb as its thread t // cpb) cover every
    (column, line thread) of the grid once."""
    t = np.arange(cpb * plan.threads)
    seen = np.zeros((cp, plan.threads), dtype=int)
    for block in range(-(-cp // cpb)):
        col = block * cpb + t % cpb
        ok = col < cp
        np.add.at(seen, (col[ok], (t // cpb)[ok]), 1)
    return bool((seen == 1).all())


@pytest.mark.parametrize("rp", [1280, 2880])
@pytest.mark.parametrize("kind,mode", [("K1", "backward"), ("K1", "stack"), ("K2", "conj_h"),
                                       ("K2", "from_spectrum_per_plane")])
def test_row_passes_at_the_paths_rp_with_their_column_groups(rp, kind, mode):
    """K1's row pass and K2's row adjoint emulated at the portrait's rp
    1280 (E = 20, a guarded middle pass) and 4K's 2880 (E = 60) on 13
    columns, against the plain versions at the card tests' bounds; the
    wrapper's column groups are 8 (4 at 2880 with the spectrum or the
    distance sum kept), and their blocks cover every column and line thread
    once, the last group ragged."""
    rows, pad = {1280: (640, 320), 2880: (2176, 352)}[rp]
    optics = OpticsConfig(rows=rows, cols=9, pad_size=pad, pad_cols_override=2,
                          filter_radius_coefficient=0.45)
    if kind == "K1":
        conj_h, num_d, from_spectrum, per_plane, _ = MODES[mode]
        mask_kind = None if conj_h else "plan"
    else:
        conj_h, num_d, from_spectrum, per_plane, mask_kind = K2_MODES[mode]
    plan = asm.make_plan(optics, distances=np.linspace(4e-4, 1e-3, 3 if per_plane else num_d), device="cpu")
    rng = np.random.default_rng(rp)
    cp = optics.padded_cols
    shape = (1, 3) + ((rp, cp) if from_spectrum else (rows, optics.cols))
    g = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64))
    dists = plan.distances[torch.arange(1) % 3] if per_plane else plan.distances
    fr, fi, wl2, dvec, m, cfg = args = asm.fused_args(
        plan, g, dists, conj_h=conj_h, from_spectrum=from_spectrum, per_plane=per_plane,
        use_mask=mask_kind is not None)
    _, _, _, _, _, _, _, r0, crop_rows, c0, crop_cols = spectral._unpack(cfg)
    fplan = fft_plan.make_plan(rp)
    cpb = spectral._pick_cpb(fplan, num_d > 1)
    assert cpb == (4 if rp == 2880 and num_d > 1 else fft_plan.COLUMNS)
    assert _blocks_cover_every_column_once(fplan, cp, cpb)
    pad_cols = (c0, cp - crop_cols - c0)
    if kind == "K1":
        x = torch.complex(fr, fi)
        if not from_spectrum:
            x = torch.fft.fft(torch.nn.functional.pad(x, pad_cols), dim=-1)
        y = _emulate_row_pass(x.numpy(), wl2.numpy(), dvec.numpy(), None if m is None else m.numpy(), cfg)
        y = torch.fft.ifft(torch.from_numpy(y), dim=-1)[..., c0:c0 + crop_cols]
        rr, ri = spectral.propagate_planes_reference(*args)
    else:
        gshape = (fr.shape[0], num_d, rows, optics.cols)
        gr = torch.from_numpy(rng.standard_normal(gshape).astype(np.float32))
        gi = torch.from_numpy(rng.standard_normal(gshape).astype(np.float32))
        x = torch.fft.fft(torch.nn.functional.pad(torch.complex(gr, gi), pad_cols), dim=-1)
        y = torch.from_numpy(_emulate_row_adjoint(x.numpy(), wl2.numpy(), dvec.numpy(),
                                                  None if m is None else m.numpy(), cfg))
        y = y / cp if from_spectrum else torch.fft.ifft(y, dim=-1)[..., c0:c0 + crop_cols]
        rr, ri = spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, m, cfg)
    err = torch.sqrt((y.real - rr) ** 2 + (y.imag - ri) ** 2).flatten()
    rel = err / torch.sqrt(rr**2 + ri**2).max()
    assert float(rel.max()) <= 1e-4
    assert float(rel.sort().values[int(0.999 * (rel.numel() - 1))]) <= 1e-5
