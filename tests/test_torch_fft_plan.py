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
CSRC = Path(spectral.__file__).resolve().parents[2] / "csrc"
# the constants of the kernel's register DFTs, w_32^q = cos - i sin of
# 2 pi q / 32 for q < 16, rounded to float32 (q = 8, -i, exact)
DFT_COS = np.cos(2 * np.pi * np.arange(16) / 32).astype(np.float32)
DFT_SIN = np.sin(2 * np.pi * np.arange(16) / 32).astype(np.float32)
DFT_COS[8] = 0.0


def _dft(a):
    """The kernel's dft<R>: radix-2 decimation in frequency over the last
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


def _exchange_writes(plan, i, j):
    """Exchange positions pass ``i`` writes, per thread j (array) and
    register: {register: position}, as the kernel computes them (base + r *
    stride), held to pad_index of the Stockham output position."""
    radix, ns, t = plan.radices[i], plan.strides[i], plan.threads
    lg_ns, lg_r = ns.bit_length() - 1, radix.bit_length() - 1
    b_count = plan.elems // radix
    out = {}
    for b in range(b_count):
        jj = j + b * t
        base = ((jj >> lg_ns) << (lg_ns + lg_r)) + jj
        for r in range(radix):
            pos = base + r * ns
            e = (jj // ns) * ns * radix + (jj % ns) + r * ns
            np.testing.assert_array_equal(pos, fft_plan.pad_index(e, ns, radix))
            out[b + r * b_count] = pos
    return out


def _exchange_reads(plan, i, j):
    """Exchange positions pass ``i`` (> 0) reads, as the kernel computes
    them, held to pad_index of the input position jj + r n / R."""
    radix, t, n = plan.radices[i], plan.threads, plan.n
    lg_ns, plg_ns = plan.strides[i].bit_length() - 1, plan.strides[i - 1].bit_length() - 1
    b_count = plan.elems // radix
    span = n // radix
    stride = span + ((span >> lg_ns) << plg_ns)
    out = {}
    for b in range(b_count):
        jj = j + b * t
        for r in range(radix):
            pos = jj + ((jj >> lg_ns) << plg_ns) + r * stride
            want = fft_plan.pad_index(jj + r * span, plan.strides[i - 1], plan.radices[i - 1])
            np.testing.assert_array_equal(pos, want)
            out[b + r * b_count] = pos
    return out


def emulate_line_fft(v, plan):
    """fft_line on registers v (lines, T, E) complex64: the forward FFT,
    through the exchange buffer as the kernel goes through it."""
    v = v.astype(np.complex64).copy()
    lines, t, e = v.shape
    assert (t, e) == (plan.threads, plan.elems)
    j = np.arange(t)
    buf = None
    for i, (radix, ns, off) in enumerate(zip(plan.radices, plan.strides, plan.tw_offsets)):
        b_count = e // radix
        if i > 0:
            for reg, pos in _exchange_reads(plan, i, j).items():
                assert not np.isnan(buf[:, pos]).any(), "read of a position no thread wrote"
                v[:, :, reg] = buf[:, pos]
        for b in range(b_count):
            if ns > 1:
                m = (j + b * t) & (ns - 1)
                for r in range(1, radix):
                    v[:, :, b + r * b_count] *= plan.twiddles[off + (r - 1) * ns + m]
            v[:, :, b::b_count] = _dft(v[:, :, b::b_count])
        if i + 1 < len(plan.radices):
            buf = np.full((lines, plan.buffer), np.nan, dtype=np.complex64)
            written = np.zeros(plan.buffer, dtype=int)
            for reg, pos in _exchange_writes(plan, i, j).items():
                assert pos.max() < plan.buffer
                np.add.at(written, pos, 1)
                buf[:, pos] = v[:, :, reg]
            assert written.max() == 1, "two threads wrote one position"
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


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_core_emulation_matches_numpy(n, inverse):
    rng = np.random.default_rng(n)
    lines = max(2, 4096 // n)
    x = (rng.standard_normal((lines, n)) + 1j * rng.standard_normal((lines, n))).astype(np.complex64)
    got = emulate_fft(x, inverse)
    want = np.fft.ifft(x.astype(np.complex128)) * n if inverse else np.fft.fft(x.astype(np.complex128))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", LENGTHS)
def test_plan_tables(n):
    """The plan's radices multiply to n, every pass but the last is radix
    32, the twiddle tables are exp(-2 pi i r m / (Ns R)) rounded once to
    complex64, and the integers the kernel reads say the same."""
    plan = fft_plan.make_plan(n)
    assert np.prod(plan.radices) == n and plan.elems * plan.threads == n
    assert all(r == fft_plan.MAX_RADIX for r in plan.radices[:-1])
    assert all(plan.elems % r == 0 for r in plan.radices)
    for radix, ns, off in zip(plan.radices, plan.strides, plan.tw_offsets):
        if ns == 1:
            continue
        r, m = np.meshgrid(np.arange(1, radix), np.arange(ns), indexing="ij")
        want = np.exp(-2j * np.pi * r * m / (ns * radix)).astype(np.complex64).reshape(-1)
        np.testing.assert_array_equal(plan.twiddles[off:off + want.size], want)
    ints = fft_plan.plan_ints(plan)
    passes = len(plan.radices)
    assert ints.dtype == np.int32 and ints.size == 5 + 3 * fft_plan.MAX_PASSES
    assert list(ints[:5]) == [n, plan.elems, plan.threads, passes, plan.buffer]
    lg_r, lg_ns, tw_off = (5 + k * fft_plan.MAX_PASSES for k in range(3))
    assert [1 << int(v) for v in ints[lg_r:lg_r + passes]] == list(plan.radices)
    assert [1 << int(v) for v in ints[lg_ns:lg_ns + passes]] == list(plan.strides)
    assert list(ints[tw_off:tw_off + passes]) == list(plan.tw_offsets)


def test_kernel_sources_match_plan():
    """The header's DFT constants are the float32 values the emulation
    uses, and the C struct reads as many integers as plan_ints writes."""
    src = (CSRC / "fft_hopper.cuh").read_text()
    for name, want in (("kCos", DFT_COS), ("kSin", DFT_SIN)):
        body = re.search(name + r"\[16\] = \{([^}]*)\}", src).group(1)
        got = np.array([float(v.strip().rstrip("f")) for v in body.split(",")], dtype=np.float32)
        np.testing.assert_array_equal(got, want)
    assert f"kMaxPasses = {fft_plan.MAX_PASSES};" in src
    assert f"sizeof(FftPlan) == {5 + 3 * fft_plan.MAX_PASSES} * sizeof(int)" in src


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
                    assert addr.max() < lpb * plan.buffer
                    for w in range(0, threads, 32):
                        warp = np.full(32, -1)
                        warp[: min(32, threads - w)] = addr[w:w + 32]
                        assert _half_warp_conflicts(warp) == 0, (name, n, i)


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
@pytest.mark.parametrize("rows,cols,pad", [(24, 32, 4), (40, 24, 12)])
def test_k1_row_pass_emulation_matches_plain_version(mode, rows, cols, pad):
    """K1's index arithmetic in every mode, on a 32-row grid (one pass, no
    exchange) and a 64-row grid (two passes), with a seeded field in the
    caller's mask so that a mirrored row or column read shows."""
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


@pytest.mark.parametrize("n", LENGTHS)
def test_block_shapes_match_the_wrappers_own_searches(n):
    """K3's lines per block along either axis and K1's columns per block,
    with the spectrum kept or not, as each wrapper picked them with its own
    copy of the search; the plan never needs more passes than MAX_PASSES."""
    plan = fft_plan.make_plan(n)
    assert len(plan.radices) <= fft_plan.MAX_PASSES
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
@pytest.mark.parametrize("rows,cols,pad", [(24, 32, 4), (40, 23, 12)])
def test_k2_row_adjoint_emulation_matches_plain_version_and_jax(mode, rows, cols, pad):
    """K2's index arithmetic in every mode, on a 32-row grid (one pass) and
    a 64-row grid of 47 columns (two passes; a column count no block of 8
    divides), through the wrapper's column transforms, against the plain
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
