"""K5's kernel (an implicit GEMM on wgmma) emulated on the CPU, in both
element types.

``csrc/k5_residual_block.cu``'s ``conv_wgmma_kernel`` runs only on the
card.  These tests repeat, from the wrapper's own choices
(``ops/cuda/conv_block.py``: ``tiling``, ``segments``, ``gemm_weights``,
``weight_tiles``, ``split_tf32``), what the kernel does with them: its
persistent grid's walk over the tiles, the producer's K decode and zero
fill (SAME padding, ragged channels, the K step that spans taps where a
segment has fewer channels than an atom), the 128-byte swizzled stage
layout (2-byte bfloat16 and 4-byte float32 elements) and the wgmma
descriptors' reads of it, the float32 consumers' TF32 register fragment,
and the GEMM in the kernel's K order:
* bfloat16: float32 sums of bf16 products, y1 and the output rounded once
  each, held to ``residual_block_reference`` in bfloat16 within K5 bf16's
  bounds (``fused_smoke.K5_BF16_*``: 9 u of max |plain| at worst, 2 u at
  p99.9, u = 2^-8);
* float32: three TF32 products per product (hi hi, hi lo, lo hi, each
  value split as hi = rna(x), lo = rna(x - hi) with round to nearest, ties
  away), summed in float32, held to the plain version in float32 within
  the kernels' float32 bounds (``cuda_measure``: 1e-4 of max |plain| at
  worst, 1e-5 at p99.9), which one TF32 pass misses.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import fused_smoke
from learned_hologram_gan_tpu_torch.ops.cuda import conv_block
from learned_hologram_gan_tpu_torch.utils.cuda_measure import MAX_REL_TOL, P999_REL_TOL

CSRC = Path(conv_block.__file__).resolve().parents[2] / "csrc"
SMS = 132  # an H100 SXM's SMs
# (B, H, W, Cin, Cout) of the card tests (tests/test_torch_cuda.py:K5_SHAPES)
K5_SHAPES = [(2, 16, 32, 8, 8), (3, 13, 37, 5, 12), (1, 20, 12, 40, 72), (2, 24, 40, 4, 64)]
# and the full-width UNet's nine blocks at batch 16
ALL_SHAPES = K5_SHAPES + [(16, hw, hw, cin, cout) for _, hw, cin, cout in fused_smoke.UNET_BLOCKS]
A_BYTES = conv_block.GEMM_BM * 128
# the element types by size: bfloat16, float32
ITEMSIZES = {"bf16": 2, "f32": 4}
BOTH = pytest.mark.parametrize("itemsize", list(ITEMSIZES.values()), ids=list(ITEMSIZES))


def decode(sg, kl):
    """(tap, channel, valid) of segment K index ``kl`` (arrays welcome) in
    the kernel's K order: kk = chunk * kchunk + tap * width + ci reads
    channel chunk * width + ci, valid for tap < taps and channel < cs."""
    chunk = kl // sg.kchunk
    tap = (kl % sg.kchunk) // sg.width
    c = chunk * sg.width + (kl % sg.kchunk) % sg.width
    return tap, c, (tap < sg.taps) & (c < sg.channels)


def swizzled_offset(row, k, itemsize=2):
    """Byte offset of element (row, k) of a stage's A or B atom (k < one
    atom's 128 // itemsize values), as the producer writes it: 128-byte
    rows whose 16-byte chunks (16 // itemsize values each) are permuted by
    XOR with row % 8 (the 128-byte swizzle)."""
    per_chunk = 16 // itemsize
    return row * 128 + (((k // per_chunk) ^ (row % 8)) * 16) + (k % per_chunk) * itemsize


def wgmma_operand_offset(start, row, k, itemsize=2):
    """Byte offset at which wgmma reads element (row, k) of a K-major,
    128-byte swizzled operand whose descriptor starts at byte ``start`` (a
    1024-byte aligned stage plus the 32-byte steps of K, an atom's bytes
    and the 8192-byte step of the second consumer's rows): 8-row groups
    1024 bytes apart (the descriptor's stride byte offset), rows 128 bytes
    apart, then the swizzle, which XORs address bits 4-6 with bits 7-9."""
    addr = start + (row // 8) * 1024 + (row % 8) * 128 + k * itemsize
    return addr ^ (((addr >> 7) & 7) << 4)


def _tiles_of_block(t, block):
    return range(block, t.tiles, t.grid)


@BOTH
@pytest.mark.parametrize("shape", ALL_SHAPES, ids=str)
def test_grid_covers_every_output_once(shape, itemsize):
    """The persistent grid's blocks walk disjoint sets of tiles that cover
    every (pixel tile, channel tile) once, and the tiles cover every output
    pixel and channel once: exactly where the tensors are small enough to
    count element by element, and by the tile arithmetic elsewhere."""
    b, h, w, cin, cout = shape
    t = conv_block.tiling(b, h, w, cin, cout, SMS, itemsize)
    assert t.bn == (64 if cout <= 64 else 128 if cout <= 128 or itemsize == 4 else 256)
    assert 1 <= t.grid <= min(t.tiles, SMS * conv_block.GEMM_BLOCKS_PER_SM)
    assert t.m_total == b * h * w
    assert (t.m_tiles - 1) * conv_block.GEMM_BM < t.m_total <= t.m_tiles * conv_block.GEMM_BM
    assert (t.n_tiles - 1) * t.bn < cout <= t.n_tiles * t.bn
    seen = np.zeros(t.tiles, dtype=np.int64)
    for block in range(t.grid):
        tiles = np.asarray(_tiles_of_block(t, block))
        np.add.at(seen, tiles, 1)
    assert (seen == 1).all()
    if t.m_total * cout <= 1 << 22:
        cover = np.zeros((t.m_total, cout), dtype=np.int64)
        for tile in range(t.tiles):
            m0, n0 = (tile // t.n_tiles) * conv_block.GEMM_BM, (tile % t.n_tiles) * t.bn
            cover[m0:m0 + conv_block.GEMM_BM, n0:n0 + t.bn] += 1
        assert (cover == 1).all()


def _segments(cin, cout, itemsize=2):
    conv1, (conv2, shortcut) = conv_block.segments(cin, cout, itemsize)
    return conv1, conv2, shortcut


@BOTH
@pytest.mark.parametrize("cin,cout", sorted({(s[3], s[4]) for s in ALL_SHAPES}), ids=str)
def test_segment_copies_stay_inside_one_tap(cin, cout, itemsize):
    """Every copy the producer issues (``vec`` channels at a K index that
    is a multiple of ``vec``) reads one tap's consecutive channels, all
    valid or all padding, from a source offset aligned to the copy; a
    segment's K is a multiple of one wgmma's K (16 bf16, 8 TF32 values),
    so no 16-byte group straddles conv2's two segments; each chunk takes
    at most one atom's channels (64 bf16, 32 float32)."""
    bk, kstep = conv_block.gemm_bk(itemsize), 32 // itemsize
    for sg in _segments(cin, cout, itemsize):
        assert sg.kseg % kstep == 0 and sg.kchunk % kstep == 0 and sg.width <= bk
        assert sg.channels % sg.vec == 0 and sg.width % sg.vec == 0 and sg.vec * itemsize <= 16
        assert sg.width == sg.channels or sg.width == bk
        kl = np.arange(0, sg.kseg, sg.vec)
        tap, c, ok = decode(sg, kl)
        for e in range(1, sg.vec):
            tap_e, c_e, ok_e = decode(sg, kl + e)
            assert (tap_e == tap).all() and (ok_e == ok).all() and (c_e[ok] == c[ok] + e).all()
        assert (c % sg.vec == 0).all()
        # each (tap, channel) the convolution needs is read exactly once
        pairs = set(zip(tap[ok].tolist(), c[ok].tolist()))
        assert len(pairs) == ok.sum() and len(pairs) * sg.vec == sg.taps * sg.channels


def im2col_a(src, sg, h, w):
    """The A matrix (M, kseg) that the producer writes for one segment, from
    the segment's K decode: 0 outside the image, past the channels and in
    the padding of each chunk."""
    b = src.shape[0]
    m = np.arange(b * h * w)
    y, x = (m // w) % h, m % w
    kl = np.arange(sg.kseg)
    tap, c, ok = decode(sg, kl)
    if sg.taps == 9:
        dy, dx = np.minimum(tap, 8) // 3 - 1, np.minimum(tap, 8) % 3 - 1
    else:
        dy = dx = np.zeros_like(tap)
    yy, xx = y[:, None] + dy[None], x[:, None] + dx[None]
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w) & ok[None]
    flat = src.reshape(b * h * w, -1)
    pix = np.clip(m[:, None] + dy[None] * w + dx[None], 0, b * h * w - 1)
    return np.where(inside, flat[pix, np.minimum(c, sg.channels - 1)[None]], 0).astype(np.float32)


@BOTH
@pytest.mark.parametrize("shape", K5_SHAPES + [(2, 6, 5, 4, 64), (1, 4, 7, 64, 128)], ids=str)
def test_zero_fill_is_same_padding(shape, itemsize):
    """The A matrix the producer's decode writes equals an independent
    im2col of the zero-padded input (np.pad, SAME) in the segment's K
    order, for every segment: ragged channels, the tap-spanning K step
    (Cin below an atom) and the shortcut's centre tap included."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(0)
    for sg in _segments(cin, cout, itemsize):
        src = rng.standard_normal((b, h, w, sg.channels)).astype(np.float32)
        got = im2col_a(src, sg, h, w)
        padded = np.pad(src, ((0, 0), (1, 1), (1, 1), (0, 0)))
        want = np.zeros_like(got)
        chunks = sg.kseg // sg.kchunk
        for chunk in range(chunks):
            for tap in range(sg.taps):
                dy, dx = (tap // 3, tap % 3) if sg.taps == 9 else (1, 1)
                for ci in range(sg.width):
                    c = chunk * sg.width + ci
                    if c < sg.channels:
                        want[:, chunk * sg.kchunk + tap * sg.width + ci] = \
                            padded[:, dy:dy + h, dx:dx + w, c].reshape(-1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bn,atoms,itemsize", [(64, 1, 2), (64, 2, 2), (128, 1, 2), (128, 2, 2),
                                               (256, 1, 2), (64, 1, 4), (128, 1, 4)])
def test_swizzled_stage_matches_wgmma_descriptors(bn, atoms, itemsize):
    """A stage holds ``atoms`` A atoms, then as many B atoms (in float32 a
    B_hi and a B_lo atom each).  The producer's copies (thread i: the
    16-byte column i % 8 of rows i / 8 + 16 r of each A atom, at the
    swizzled offset) fill every byte of the A atoms once, the bulk copy of
    the weight tiles fills the B atoms, and each descriptor (A in
    bfloat16: + 8192 wg bytes; B_lo: + bn * 128 bytes; both: + 32 bytes
    per wgmma K step, + an atom's bytes per atom) reads element (row, k) of
    each atom exactly where it was put, 2-byte bfloat16 or 4-byte float32
    elements alike."""
    bm, bk, kstep = conv_block.GEMM_BM, conv_block.gemm_bk(itemsize), 32 // itemsize
    split = conv_block.b_split(itemsize)
    b_base = atoms * A_BYTES
    assert conv_block.ring_stages(bn, atoms, itemsize) * atoms * (A_BYTES + split * bn * 128) \
        <= conv_block.RING_BYTES
    written = np.zeros(b_base, dtype=np.int64)
    for atom in range(atoms):
        for i in range(128):
            q, row0 = i % 8, i // 8
            for r in range(bm // 16):
                row = row0 + 16 * r
                start = atom * A_BYTES + swizzled_offset(row, (16 // itemsize) * q, itemsize)
                assert start == atom * A_BYTES + row * 128 + ((q ^ (row0 % 8)) << 4)  # the kernel's `swz`
                written[start:start + 16] += 1
    assert (written == 1).all()
    for atom in range(atoms):
        for ks in range(bk // kstep):
            if itemsize == 2:  # bfloat16 reads A by descriptor too
                for wg in range(2):
                    for row in range(64):
                        for k in range(kstep):
                            got = wgmma_operand_offset(
                                atom * A_BYTES + wg * 64 * 128 + 32 * ks, row, k, itemsize)
                            assert got == atom * A_BYTES + swizzled_offset(
                                wg * 64 + row, kstep * ks + k, itemsize)
            for part in range(split):  # B, or B_hi then B_lo
                base = b_base + (atom * split + part) * bn * 128
                for n in range(bn):
                    for k in range(kstep):
                        got = wgmma_operand_offset(base + 32 * ks, n, k, itemsize)
                        assert got == base + swizzled_offset(n, kstep * ks + k, itemsize)


def tf32_fragment(warp, lane, reg):
    """(row, k) of a m64k8 TF32 A fragment that register ``reg`` (a0..a3)
    of ``lane`` of ``warp`` holds: the warp's 16 rows, then a0 (g, t), a1
    (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) with g = lane / 4 and t =
    lane % 4 (the PTX ISA's wgmma .tf32 fragment for A in registers, the
    mma.m16n8k8 .tf32 layout per warp)."""
    g, t = lane // 4, lane % 4
    return 16 * warp + g + 8 * (reg & 1), t + 4 * (reg >> 1)


def consumer_fragment_address(wg, warp, lane, ks, v):
    """The byte address in the stage's A atom from which consume_f32 loads
    register v of K step ks: a_off + (v & 1) * 1024 + (((2 ks + (v >> 1))
    ^ g) << 4), a_off = (64 wg + 16 warp + g) * 128 + 4 tq (transcribed
    from the kernel)."""
    g, tq = lane // 4, lane % 4
    a_off = (wg * 64 + warp * 16 + g) * 128 + tq * 4
    return a_off + (v & 1) * 1024 + (((2 * ks + (v >> 1)) ^ g) << 4)


def test_tf32_fragment_reads_the_swizzled_stage():
    """Each float32 consumer thread loads, for each of an atom's four K
    steps, the four values of the TF32 fragment that wgmma expects in its
    registers, from where the producer put them (4-byte swizzle); the two
    warpgroups read every element of the A atom once; and each load of a
    warp hits 32 distinct banks."""
    seen = np.zeros(A_BYTES // 4, dtype=np.int64)
    for wg in range(2):
        for warp in range(4):
            for ks in range(4):
                for v in range(4):
                    banks = set()
                    for lane in range(32):
                        row, k = tf32_fragment(warp, lane, v)
                        addr = consumer_fragment_address(wg, warp, lane, ks, v)
                        assert addr == swizzled_offset(wg * 64 + row, 8 * ks + k, 4)
                        seen[addr // 4] += 1
                        banks.add((addr // 4) % 32)
                    assert len(banks) == 32
    assert (seen == 1).all()
    src = (CSRC / "k5_residual_block.cu").read_text()
    body = re.search(r"void consume_f32\(.*?\n}\n", src, re.S).group(0)
    assert "const uint32_t a_off = (wg * 64 + warp * 16 + g) * 128 + tq * 4;" in body
    assert "(2 * ks + (v >> 1)) ^ g" in body and "a_s + a_off + (v & 1) * 1024 + (chunk << 4)" in body


def test_kernel_source_matches_the_wrapper():
    """The kernel's tile constants, its reading of the tiling integers and
    its descriptor fields are the ones the wrapper and these tests assume."""
    src = (CSRC / "k5_residual_block.cu").read_text()
    assert f"constexpr int kBM = {conv_block.GEMM_BM};" in src
    assert "constexpr int kBK = static_cast<int>(128 / sizeof(T));" in src
    assert [conv_block.gemm_bk(s) for s in (2, 4)] == [64, 32]
    assert "constexpr int kKStep = static_cast<int>(32 / sizeof(T));" in src
    assert "constexpr int kSplit = sizeof(T) == 4 ? 2 : 1;" in src
    assert [conv_block.b_split(s) for s in (2, 4)] == [1, 2]
    # atoms_for, as stage_atoms
    assert "return sizeof(T) == 4 ? 1 : (bn == 256 || ktot <= kBK<T> ? 1 : 2);" in src
    assert f"constexpr int kRingBytes = {conv_block.RING_BYTES // 1024} * 1024;" in src
    assert "constexpr int kStageBytes = AT * (kABytes + kSplit<T> * BN * 128);" in src
    assert "constexpr int kStages = kRingBytes / kStageBytes<T, BN, AT>;" in src
    assert [conv_block.stage_atoms(bn, 592, 2) for bn in (64, 128, 256)] == [2, 2, 1]
    assert [conv_block.stage_atoms(bn, 592, 4) for bn in (64, 128, 256)] == [1, 1, 1]
    assert conv_block.stage_atoms(64, 48, 2) == 1  # enc_0's conv1
    assert [conv_block.ring_stages(bn, 2, 2) for bn in (64, 128)] == [4, 3]
    assert [conv_block.ring_stages(bn, 1, 2) for bn in (64, 128, 256)] == [8, 6, 4]
    assert [conv_block.ring_stages(bn, 1, 4) for bn in (64, 128)] == [6, 4]
    assert "constexpr bool kMoveRegs = sizeof(T) == 4 && BN == 128;" in src
    assert "__launch_bounds__(kGemmThreads, 1)" in src and conv_block.GEMM_BLOCKS_PER_SM == 1
    # setmaxnreg: 2 consumer warpgroups and the producer within an SM's 64K registers
    regs = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kProducerRegs", "kConsumerRegs")}
    assert 2 * regs["kConsumerRegs"] + regs["kProducerRegs"] <= 512
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in regs.values())
    for itemsize in (2, 4):
        ints = conv_block.tiling(2, 8, 8, 4, 64, SMS, itemsize).ints()
        assert ints.dtype == np.int32 and ints.size == 14
    assert "const int bn = tiling[0], grid = tiling[1];" in src
    for off in (2, 6, 10):
        assert f"tiling + {off})" in src
    # start address >> 4, stride byte offset 1024 >> 4 at bit 32, 128-byte swizzle at bit 62
    desc = re.search(r"uint64_t smem_desc\(uint32_t addr\) \{(.*?)\}", src, re.S).group(1)
    assert "(addr & 0x3FFFF) >> 4" in desc and "(1024 >> 4) << 32" in desc and "<< 62" in desc
    assert all(f"m64n{n}k16.f32.bf16.bf16" in src for n in (64, 128, 256))
    assert all(f"m64n{n}k8.f32.tf32.tf32" in src for n in (64, 128))
    # the split rounds with cvt.rna (ties away) and keeps TF32 values
    split = re.search(r"void split_tf32\(.*?\n}\n", src, re.S).group(0)
    assert split.count("cvt.rna.tf32.f32") == 2 and split.count("0xFFFFE000u") == 2
    # lo x B_hi, hi x B_lo, hi x B_hi per K step into a stage's partial sums
    # (the first product with scale-d 0), B_lo after B_hi; the partial sums
    # added to the tile's with round-to-nearest adds
    body = re.search(r"void consume_f32\(.*?\n}\n", src, re.S).group(0)
    assert re.search(r"wgmma_tf32<BN>\(part, lo \+ 4 \* ks, db \+ 2 \* ks, ks > 0\);\s*"
                     r"wgmma_tf32<BN>\(part, hi \+ 4 \* ks, db \+ kLo \+ 2 \* ks, 1\);\s*"
                     r"wgmma_tf32<BN>\(part, hi \+ 4 \* ks, db \+ 2 \* ks, 1\);", body)
    assert "constexpr uint64_t kLo = (BN * 128) >> 4;" in body
    assert "acc[k] = __fadd_rn(acc[k], part[k]);" in body


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).bfloat16().float().numpy()


def emulate_bf16_block(x, w1, b1, w2, b2, w3, b3):
    """K5's bfloat16 entry in numpy: conv1 and conv2 + shortcut as GEMMs of
    the producer's A matrices and the wrapper's weight matrices in the
    kernel's K order, float32 sums of bf16 products taken one wgmma K step
    (16) at a time in K order, the biases added in float32, y1 and the
    output rounded once each to bfloat16."""
    b, h, w, cin = x.shape
    cout = w1.shape[-1]
    conv1, conv2, shortcut = _segments(cin, cout)

    def gemm(a, wm, bias):
        acc = np.zeros((a.shape[0], wm.shape[0]), dtype=np.float32)
        for k0 in range(0, a.shape[1], 16):
            acc += a[:, k0:k0 + 16] @ wm[:, k0:k0 + 16].T
        return np.maximum(acc + bias[None], np.float32(0))

    def wmat(wt, sg):
        return conv_block.gemm_weights(torch.from_numpy(wt).bfloat16(), sg).float().numpy()

    xb = _bf16(x)
    y1 = _bf16(gemm(im2col_a(xb, conv1, h, w), wmat(w1, conv1), b1)).reshape(b, h, w, cout)
    a2 = np.concatenate([im2col_a(y1, conv2, h, w), im2col_a(xb, shortcut, h, w)], axis=1)
    wm2 = np.concatenate([wmat(w2, conv2), wmat(w3, shortcut)], axis=1)
    return _bf16(gemm(a2, wm2, (b2 + b3).astype(np.float32))).reshape(b, h, w, cout)


def _draw_block(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)

    def draw(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    x = draw(b, h, w, cin)
    args = (draw(3, 3, cin, cout, scale=(9 * cin) ** -0.5), draw(cout),
            draw(3, 3, cout, cout, scale=(9 * cout) ** -0.5), draw(cout),
            draw(cin, cout, scale=cin ** -0.5), draw(cout))
    return x, args


@pytest.mark.parametrize("shape", K5_SHAPES + [(2, 12, 12, 4, 64), (1, 6, 6, 64, 128),
                                              (1, 3, 3, 128, 256)], ids=str)
def test_gemm_emulation_matches_plain_version(shape):
    """The kernel's GEMM in its K order against the plain version in
    bfloat16 (cuDNN's order of roundings on the card; torch's CPU
    convolutions here), within K5 bf16's bounds, on Xavier-scaled weights."""
    x, args = _draw_block(shape, 5)
    got = emulate_bf16_block(x, *args)
    want = conv_block.residual_block_reference(
        torch.from_numpy(x).bfloat16(), *(torch.from_numpy(a) for a in args)).float().numpy()
    err = np.abs(got - want).reshape(-1) / np.abs(want).max()
    assert err.max() <= fused_smoke.K5_BF16_MAX_REL_TOL
    assert np.sort(err)[int(0.999 * (err.size - 1))] <= fused_smoke.K5_BF16_P999_REL_TOL


def tf32_rna_reference(a):
    """float32 ``a`` rounded to 11 significant bits (TF32), to nearest with
    ties away from zero, in float64 arithmetic (independent of the bit
    trick of conv_block.tf32_rna)."""
    a = np.asarray(a, dtype=np.float64)
    mag = np.abs(a)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 10), 1.0)
    return (np.sign(a) * np.floor(mag / ulp + 0.5) * ulp).astype(np.float32)


def test_weight_split_rebuilds_the_weights():
    """split_tf32 (the wrapper's, for the weights; the kernel's split_tf32
    does the same to the activations): hi and lo are TF32 values (the low
    13 bits 0), hi is the float32 value rounded to nearest with ties away,
    lo the remainder rounded so, and hi + lo is within 2^-22 of the value,
    relative."""
    rng = np.random.default_rng(8)
    w = np.concatenate([rng.standard_normal(100_000) * 10.0 ** rng.integers(-6, 4, 100_000),
                        [1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11, 0.0, 2.0**-20]])
    w = w.astype(np.float32)
    parts = conv_block.split_tf32(torch.from_numpy(w).reshape(1, 1, -1)).numpy()
    hi, lo = parts[0, 0, 0], parts[0, 0, 1]
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, tf32_rna_reference(w))
    np.testing.assert_array_equal(lo, tf32_rna_reference(w - hi))
    assert hi[-5] == np.float32(1.0 + 2.0**-10) and hi[-4] == -hi[-5]  # ties away from zero
    rebuilt = hi.astype(np.float64) + lo
    assert (np.abs(rebuilt - w) <= 2.0**-22 * np.abs(w)).all()
    assert np.abs(rebuilt - w).max() > 0  # lo's own rounding shows: the bound is not loose


def emulate_f32_block(x, w1, b1, w2, b2, w3, b3, passes=3):
    """K5's float32 entry in numpy: conv1 and conv2 + shortcut as GEMMs of
    the producer's A matrices and the wrapper's weight matrices in the
    kernel's K order, each value split into TF32 hi = rna(x), lo =
    rna(x - hi), and per wgmma K step (8) the products lo x B_hi, hi x B_lo
    and hi x B_hi, each exact, added in float32 into a stage's partial sums
    (32 K), which are added to the tile's (``passes`` = 1: hi x B_hi alone,
    one TF32 pass); the biases added in float32, the ReLUs."""
    b, h, w, cin = x.shape
    cout = w1.shape[-1]
    conv1, conv2, shortcut = _segments(cin, cout, 4)

    def split(a):
        hi = tf32_rna_reference(a)
        return hi, tf32_rna_reference(a - hi)

    def gemm(a, wm, bias):
        (a_hi, a_lo), (w_hi, w_lo) = split(a), split(wm)
        acc = np.zeros((a.shape[0], wm.shape[0]), dtype=np.float32)
        for s0 in range(0, a.shape[1], 32):
            part = np.zeros_like(acc)
            for k0 in range(s0, min(s0 + 32, a.shape[1]), 8):
                ks = slice(k0, k0 + 8)
                if passes == 3:
                    part += a_lo[:, ks] @ w_hi[:, ks].T
                    part += a_hi[:, ks] @ w_lo[:, ks].T
                part += a_hi[:, ks] @ w_hi[:, ks].T
            acc += part
        return np.maximum(acc + bias[None], np.float32(0))

    def wmat(wt, sg):
        return conv_block.gemm_weights(torch.from_numpy(wt), sg).numpy()

    y1 = gemm(im2col_a(x, conv1, h, w), wmat(w1, conv1), b1).reshape(b, h, w, cout)
    a2 = np.concatenate([im2col_a(y1, conv2, h, w), im2col_a(x, shortcut, h, w)], axis=1)
    wm2 = np.concatenate([wmat(w2, conv2), wmat(w3, shortcut)], axis=1)
    return gemm(a2, wm2, (b2 + b3).astype(np.float32)).reshape(b, h, w, cout)


def _rel_errors(got, want):
    err = np.abs(got - want).reshape(-1) / np.abs(want).max()
    return err.max(), np.sort(err)[int(0.999 * (err.size - 1))]


# the full-width UNet's nine blocks, cut to 4 x 4 pixels (the bottleneck to
# 3 x 3) but not in channels, then the small fused generator's blocks with
# C = 16 and 32, whose conv2 segments (9 x 16 and 9 x 32 values) end off
# and on a 32-value atom
F32_EMULATED = ([(1, 3 if cin == 512 and cout == 1024 else 4, 4, cin, cout)
                 for _, _, cin, cout in fused_smoke.UNET_BLOCKS]
                + [(2, 6, 6, 16, 32), (2, 3, 3, 32, 64), (2, 6, 6, 64, 32), (2, 12, 12, 32, 16),
                   (2, 12, 12, 8, 16)])


@pytest.mark.parametrize("shape", F32_EMULATED, ids=str)
def test_tf32_split_emulation_matches_plain_version(shape):
    """The float32 kernel's 3xTF32 GEMM in its K order against the plain
    version in float32 (TF32 off), within the kernels' float32 bounds (1e-4
    of max |plain|, 1e-5 at p99.9), at the UNet's channel counts; one TF32
    pass misses them, so the split is what holds the bounds."""
    x, args = _draw_block(shape, 9)
    x = np.abs(x)  # as the blocks see after a ReLU
    want = conv_block.residual_block_reference(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in args)).numpy()
    worst, p999 = _rel_errors(emulate_f32_block(x, *args), want)
    assert worst <= MAX_REL_TOL and p999 <= P999_REL_TOL
    worst1, p999_1 = _rel_errors(emulate_f32_block(x, *args, passes=1), want)
    assert worst1 > MAX_REL_TOL or p999_1 > P999_REL_TOL


@BOTH
def test_prepare_lays_weights_out_as_gemm_matrices(itemsize):
    """gemm_weights puts w[tap // 3, tap % 3, c, n] at (n, kk) for every K
    index the segment decodes as valid, and 0 elsewhere."""
    rng = np.random.default_rng(1)
    for cin, cout in ((4, 64), (5, 12), (72, 8), (130, 3)):
        for sg, shape in ((conv_block.segment(cin, 9, itemsize), (3, 3, cin, cout)),
                          (conv_block.segment(cin, 1, itemsize), (cin, cout))):
            wt = rng.standard_normal(shape).astype(np.float32)
            got = conv_block.gemm_weights(torch.from_numpy(wt), sg).numpy()
            assert got.shape == (cout, sg.kseg)
            tap, c, ok = decode(sg, np.arange(sg.kseg))
            w9 = wt.reshape(sg.taps, cin, cout)
            want = np.where(ok[None], w9[np.minimum(tap, sg.taps - 1), np.minimum(c, cin - 1)].T, 0)
            np.testing.assert_array_equal(got, want)


@BOTH
@pytest.mark.parametrize("c,k,bn", [(64, 48, 64), (12, 128, 64), (300, 200, 256), (72, 1200, 128)])
def test_weight_tiles_are_stages_in_memory(c, k, bn, itemsize):
    """B atom (j, a), which a step's bulk copy moves into a stage with the
    step's other atoms, holds at the swizzled offset of (n, kk) the GEMM
    weight (j bn + n, a bk + kk), and 0 past the channels and the K, which
    pads to whole steps."""
    rng = np.random.default_rng(2)
    wm = torch.from_numpy(rng.standard_normal((c, k)).astype(np.float32))
    atoms = conv_block.stage_atoms(bn, k, itemsize)
    tiles = conv_block.weight_tiles(wm, bn, atoms, itemsize).numpy()
    bk = conv_block.gemm_bk(itemsize)
    assert tiles.shape == (-(-c // bn), -(-k // (atoms * bk)) * atoms, bn, bk)
    flat = tiles.reshape(tiles.shape[0], tiles.shape[1], -1)  # a tile's elements
    padded = np.zeros((tiles.shape[0] * bn, tiles.shape[1] * bk), dtype=np.float32)
    padded[:c, :k] = wm.numpy()
    n, kk = np.meshgrid(np.arange(bn), np.arange(bk), indexing="ij")
    pos = swizzled_offset(n, kk, itemsize) // itemsize
    for j in range(tiles.shape[0]):
        for s in range(tiles.shape[1]):
            np.testing.assert_array_equal(flat[j, s][pos], padded[j * bn + n, s * bk + kk])


def producer_copies(sg, kl, itemsize=2):
    """The copies load_a_atom issues for one thread's V K values (V = 16
    bytes' worth) at segment K index ``kl`` (a multiple of V): [(first K
    offset, tap, first channel, valid, channels)], transcribed from the
    kernel's two paths (atom-wide channel chunks; the per-copy decode)."""
    bk, per_copy = conv_block.gemm_bk(itemsize), 16 // itemsize
    if sg.width == bk and sg.vec == per_copy:
        j = kl // bk
        chunk, tap = (j // 9, j % 9) if sg.taps == 9 else (j, 0)
        c = chunk * bk + (kl - j * bk)
        return [(0, tap, c, c < sg.channels, per_copy)]
    chunk, rem = kl // sg.kchunk, kl % sg.kchunk
    out = []
    for e in range(0, per_copy, sg.vec):
        t = (rem + e) // sg.width
        c = chunk * sg.width + (rem + e - t * sg.width)
        out.append((e, t, c, t < sg.taps and c < sg.channels, sg.vec))
    return out


# the small fused generator's blocks (card_check.FUSED: 48^2, base 4):
# conv2's own segments of 9 x 32 and 9 x 16 values end off a 64-value atom
# (and 9 x 16 off a 32-value one)
SMALL_UNET = [(2, 48, 48, 4, 4), (2, 24, 24, 4, 8), (2, 12, 12, 8, 16), (2, 6, 6, 16, 32),
              (2, 3, 3, 32, 64), (2, 6, 6, 64, 32), (2, 12, 12, 32, 16), (2, 24, 24, 16, 8),
              (2, 48, 48, 8, 4)]


@BOTH
@pytest.mark.parametrize("shape", ALL_SHAPES + SMALL_UNET, ids=str)
def test_producer_decode_matches_the_k_order(shape, itemsize):
    """Every copy the producer issues for conv1 and for conv2 + shortcut
    (each thread's 16 bytes of K values, the segment chosen from the global
    K, the atoms of a step in turn) reads the (tap, channels) the segment's
    K order assigns those values, and each K value is read once."""
    _, _, _, cin, cout = shape
    per_copy = 16 // itemsize
    conv1, conv2, shortcut = _segments(cin, cout, itemsize)
    for segs in ((conv1,), (conv2, shortcut)):
        ktot = sum(sg.kseg for sg in segs)
        seen = np.zeros(ktot, dtype=np.int64)
        for kk in range(0, ktot, per_copy):
            second = len(segs) > 1 and kk >= segs[0].kseg
            sg = segs[1 if second else 0]
            kl = kk - (segs[0].kseg if second else 0)
            for e, tap, c, ok, n in producer_copies(sg, kl, itemsize):
                want_tap, want_c, want_ok = decode(sg, np.arange(kl + e, kl + e + n))
                assert (want_ok == ok).all()
                if ok:
                    assert (want_tap == tap).all() and (want_c == c + np.arange(n)).all()
                seen[kk + e:kk + e + n] += 1
        assert (seen == 1).all()


@BOTH
@pytest.mark.parametrize("shape", K5_SHAPES + SMALL_UNET[:5], ids=str)
def test_prepare_gathers_the_weight_tiles(shape, itemsize):
    """prepare()'s cached gather gives the B tiles that weight_tiles lays
    out from the gemm_weights matrices: conv1's, and conv2's with the
    shortcut's K appended (the kernel's layout, held by the tests above);
    in float32 split_tf32 then stacks each step's hi and lo atoms, as one
    bulk copy moves them."""
    _, _, _, cin, cout = shape
    rng = np.random.default_rng(4)
    w1, w2, w3 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((3, 3, cin, cout), (3, 3, cout, cout), (cin, cout)))
    conv1, conv2, shortcut = _segments(cin, cout, itemsize)
    bn = conv_block.tile_bn(cout, itemsize)
    idx1, idx2 = conv_block._tile_index(cin, cout, itemsize, torch.device("cpu"))
    zero = torch.zeros(1)
    want1 = conv_block.weight_tiles(conv_block.gemm_weights(w1, conv1), bn,
                                    conv_block.stage_atoms(bn, conv1.kseg, itemsize), itemsize)
    got1 = torch.cat([zero, w1.reshape(-1)])[idx1.long()]
    np.testing.assert_array_equal(got1.numpy(), want1.numpy())
    want2 = conv_block.weight_tiles(torch.cat([conv_block.gemm_weights(w2, conv2),
                                               conv_block.gemm_weights(w3, shortcut)], dim=1),
                                    bn, conv_block.stage_atoms(bn, conv2.kseg + shortcut.kseg,
                                                               itemsize), itemsize)
    got2 = torch.cat([zero, w2.reshape(-1), w3.reshape(-1)])[idx2.long()]
    np.testing.assert_array_equal(got2.numpy(), want2.numpy())
    if itemsize == 4:
        split = conv_block.split_tf32(got2).numpy()
        assert split.shape == got2.shape[:2] + (2,) + got2.shape[2:]
        np.testing.assert_array_equal(split[:, :, 0], tf32_rna_reference(got2.numpy()))
        np.testing.assert_array_equal(split[:, :, 1],
                                      tf32_rna_reference(got2.numpy() - split[:, :, 0]))
