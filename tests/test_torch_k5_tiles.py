"""K5's bfloat16 kernel (an implicit GEMM on wgmma) emulated on the CPU.

``csrc/k5_residual_block.cu``'s ``conv_wgmma_kernel`` runs only on the
card.  These tests repeat, from the wrapper's own choices
(``ops/cuda/conv_block.py``: ``bf16_tiling``, ``bf16_segments``,
``gemm_weights``), what the kernel does with them: its persistent grid's
walk over the tiles, the producer's K decode and zero fill (SAME padding,
ragged channels, the K step that spans taps where a segment has fewer than
64 channels), the 128-byte swizzled stage layout and the wgmma
descriptors' reads of it, and the GEMM in the kernel's K order (float32
sums of bf16 products, y1 and the output rounded once each), held to
``residual_block_reference`` in bfloat16 within K5 bf16's bounds
(``fused_smoke.K5_BF16_*``: 9 u of max |plain| at worst, 2 u at p99.9,
u = 2^-8).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import fused_smoke
from learned_hologram_gan_tpu_torch.ops.cuda import conv_block

CSRC = Path(conv_block.__file__).resolve().parents[2] / "csrc"
SMS = 132  # an H100 SXM's SMs
# (B, H, W, Cin, Cout) of the card tests (tests/test_torch_cuda.py:K5_SHAPES)
K5_SHAPES = [(2, 16, 32, 8, 8), (3, 13, 37, 5, 12), (1, 20, 12, 40, 72), (2, 24, 40, 4, 64)]
# and the full-width UNet's nine blocks at batch 16
ALL_SHAPES = K5_SHAPES + [(16, hw, hw, cin, cout) for _, hw, cin, cout in fused_smoke.UNET_BLOCKS]
A_BYTES = conv_block.BF16_BM * conv_block.BF16_BK * 2


def decode(sg, kl):
    """(tap, channel, valid) of segment K index ``kl`` (arrays welcome) in
    the kernel's K order: kk = chunk * kchunk + tap * width + ci reads
    channel chunk * width + ci, valid for tap < taps and channel < cs."""
    chunk = kl // sg.kchunk
    tap = (kl % sg.kchunk) // sg.width
    c = chunk * sg.width + (kl % sg.kchunk) % sg.width
    return tap, c, (tap < sg.taps) & (c < sg.channels)


def swizzled_offset(row, k):
    """Byte offset of bf16 element (row, k) of a stage's A or B atom (k <
    64), as the producer writes it: 128-byte rows whose 16-byte chunks are
    permuted by XOR with row % 8 (the 128-byte swizzle)."""
    return row * 128 + (((k // 8) ^ (row % 8)) * 16) + (k % 8) * 2


def wgmma_operand_offset(start, row, k):
    """Byte offset at which wgmma reads element (row, k) of a K-major,
    128-byte swizzled operand whose descriptor starts at byte ``start`` (a
    1024-byte aligned stage plus the 32-byte steps of K, an atom's bytes
    and the 8192-byte step of the second consumer's rows): 8-row groups
    1024 bytes apart (the descriptor's stride byte offset), rows 128 bytes
    apart, then the swizzle, which XORs address bits 4-6 with bits 7-9."""
    addr = start + (row // 8) * 1024 + (row % 8) * 128 + (k // 8) * 16 + (k % 8) * 2
    return addr ^ (((addr >> 7) & 7) << 4)


def _tiles_of_block(t, block):
    return range(block, t.tiles, t.grid)


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=str)
def test_grid_covers_every_output_once(shape):
    """The persistent grid's blocks walk disjoint sets of tiles that cover
    every (pixel tile, channel tile) once, and the tiles cover every output
    pixel and channel once: exactly where the tensors are small enough to
    count element by element, and by the tile arithmetic elsewhere."""
    b, h, w, cin, cout = shape
    t = conv_block.bf16_tiling(b, h, w, cin, cout, SMS)
    assert t.bn == (64 if cout <= 64 else 128 if cout <= 128 else 256)
    assert 1 <= t.grid <= min(t.tiles, SMS * conv_block.BF16_BLOCKS_PER_SM)
    assert t.m_total == b * h * w
    assert (t.m_tiles - 1) * conv_block.BF16_BM < t.m_total <= t.m_tiles * conv_block.BF16_BM
    assert (t.n_tiles - 1) * t.bn < cout <= t.n_tiles * t.bn
    seen = np.zeros(t.tiles, dtype=np.int64)
    for block in range(t.grid):
        tiles = np.asarray(_tiles_of_block(t, block))
        np.add.at(seen, tiles, 1)
    assert (seen == 1).all()
    if t.m_total * cout <= 1 << 22:
        cover = np.zeros((t.m_total, cout), dtype=np.int64)
        for tile in range(t.tiles):
            m0, n0 = (tile // t.n_tiles) * conv_block.BF16_BM, (tile % t.n_tiles) * t.bn
            cover[m0:m0 + conv_block.BF16_BM, n0:n0 + t.bn] += 1
        assert (cover == 1).all()


def _segments(cin, cout):
    conv1, (conv2, shortcut) = conv_block.bf16_segments(cin, cout)
    return conv1, conv2, shortcut


@pytest.mark.parametrize("cin,cout", sorted({(s[3], s[4]) for s in ALL_SHAPES}), ids=str)
def test_segment_copies_stay_inside_one_tap(cin, cout):
    """Every copy the producer issues (``vec`` channels at a K index that
    is a multiple of ``vec``) reads one tap's consecutive channels, all
    valid or all padding, from a source offset aligned to the copy; a
    segment's K is a multiple of 16 (one wgmma's K), so no 8-value group
    straddles conv2's two segments; each chunk takes at most 64 channels."""
    for sg in _segments(cin, cout):
        assert sg.kseg % 16 == 0 and sg.kchunk % 16 == 0 and sg.width <= conv_block.BF16_BK
        assert sg.channels % sg.vec == 0 and sg.width % sg.vec == 0
        assert sg.width == sg.channels or sg.width == conv_block.BF16_BK
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


@pytest.mark.parametrize("shape", K5_SHAPES + [(2, 6, 5, 4, 64), (1, 4, 7, 64, 128)], ids=str)
def test_zero_fill_is_same_padding(shape):
    """The A matrix the producer's decode writes equals an independent
    im2col of the zero-padded input (np.pad, SAME) in the segment's K
    order, for every segment: ragged channels, the tap-spanning K step
    (Cin < 64) and the shortcut's centre tap included."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(0)
    for sg in _segments(cin, cout):
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


@pytest.mark.parametrize("bn,atoms", [(64, 1), (64, 2), (128, 1), (128, 2), (256, 1)])
def test_swizzled_stage_matches_wgmma_descriptors(bn, atoms):
    """A stage holds ``atoms`` A atoms, then as many B atoms.  The
    producer's copies (thread i: the 16-byte column i % 8 of rows i / 8 +
    16 r of each A atom, at the swizzled offset) fill every byte of the A
    atoms once, the bulk copy of weight_tiles fills the B atoms, and each
    consumer warpgroup's descriptor (+ 8192 wg bytes for A, + 32 bytes per
    k16 step, + an atom's bytes per atom) reads element (row, k) of each
    atom exactly where it was put."""
    bm, bk = conv_block.BF16_BM, conv_block.BF16_BK
    b_base = atoms * A_BYTES
    assert conv_block.bf16_stages(bn, atoms) * atoms * (A_BYTES + bn * bk * 2) <= 192 * 1024
    written = np.zeros(b_base, dtype=np.int64)
    for atom in range(atoms):
        for i in range(128):
            q, row0 = i % 8, i // 8
            for r in range(bm // 16):
                row = row0 + 16 * r
                start = atom * A_BYTES + swizzled_offset(row, 8 * q)
                assert start == atom * A_BYTES + row * 128 + ((q ^ (row0 % 8)) << 4)  # the kernel's `swz`
                written[start:start + 16] += 1
    assert (written == 1).all()
    for atom in range(atoms):
        for kstep in range(bk // 16):
            for wg in range(2):
                for row in range(64):
                    for k in range(16):
                        got = wgmma_operand_offset(
                            atom * A_BYTES + wg * 64 * 128 + 32 * kstep, row, k)
                        assert got == atom * A_BYTES + swizzled_offset(wg * 64 + row,
                                                                                  16 * kstep + k)
            for n in range(bn):
                for k in range(16):
                    got = wgmma_operand_offset(b_base + atom * bn * 128 + 32 * kstep, n, k)
                    assert got == b_base + atom * bn * 128 + swizzled_offset(n, 16 * kstep + k)


def test_kernel_source_matches_the_wrapper():
    """The kernel's tile constants, its reading of the tiling integers and
    its descriptor fields are the ones the wrapper and these tests assume."""
    src = (CSRC / "k5_residual_block.cu").read_text()
    assert f"constexpr int kBM = {conv_block.BF16_BM};" in src
    assert f"constexpr int kBK = {conv_block.BF16_BK};" in src
    assert "return bn == 256 || ktot <= kBK ? 1 : 2;" in src  # atoms_for, as bf16_atoms
    assert "constexpr int kStages = (192 * 1024) / kStageBytes<BN, AT>;" in src
    assert [conv_block.bf16_atoms(bn, 592) for bn in (64, 128, 256)] == [2, 2, 1]
    assert conv_block.bf16_atoms(64, 48) == 1  # enc_0's conv1
    assert [conv_block.bf16_stages(bn, 2) for bn in (64, 128)] == [4, 3]
    assert [conv_block.bf16_stages(bn, 1) for bn in (64, 128, 256)] == [8, 6, 4]
    assert "__launch_bounds__(kGemmThreads, 1)" in src and conv_block.BF16_BLOCKS_PER_SM == 1
    ints = conv_block.bf16_tiling(2, 8, 8, 4, 64, SMS).ints()
    assert ints.dtype == np.int32 and ints.size == 14
    assert "const int bn = tiling[0], grid = tiling[1];" in src
    for off in (2, 6, 10):
        assert f"tiling + {off})" in src
    # start address >> 4, stride byte offset 1024 >> 4 at bit 32, 128-byte swizzle at bit 62
    desc = re.search(r"uint64_t smem_desc\(uint32_t addr\) \{(.*?)\}", src, re.S).group(1)
    assert "(addr & 0x3FFFF) >> 4" in desc and "(1024 >> 4) << 32" in desc and "<< 62" in desc
    assert all(f"m64n{n}k16.f32.bf16.bf16" in src for n in (64, 128, 256))


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


@pytest.mark.parametrize("shape", K5_SHAPES + [(2, 12, 12, 4, 64), (1, 6, 6, 64, 128),
                                              (1, 3, 3, 128, 256)], ids=str)
def test_gemm_emulation_matches_plain_version(shape):
    """The kernel's GEMM in its K order against the plain version in
    bfloat16 (cuDNN's order of roundings on the card; torch's CPU
    convolutions here), within K5 bf16's bounds, on Xavier-scaled weights."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(5)

    def draw(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    x = draw(b, h, w, cin)
    args = (draw(3, 3, cin, cout, scale=(9 * cin) ** -0.5), draw(cout),
            draw(3, 3, cout, cout, scale=(9 * cout) ** -0.5), draw(cout),
            draw(cin, cout, scale=cin ** -0.5), draw(cout))
    got = emulate_bf16_block(x, *args)
    want = conv_block.residual_block_reference(
        torch.from_numpy(x).bfloat16(), *(torch.from_numpy(a) for a in args)).float().numpy()
    err = np.abs(got - want).reshape(-1) / np.abs(want).max()
    assert err.max() <= fused_smoke.K5_BF16_MAX_REL_TOL
    assert np.sort(err)[int(0.999 * (err.size - 1))] <= fused_smoke.K5_BF16_P999_REL_TOL


def test_prepare_lays_weights_out_as_gemm_matrices():
    """gemm_weights puts w[tap // 3, tap % 3, c, n] at (n, kk) for every K
    index the segment decodes as valid, and 0 elsewhere."""
    rng = np.random.default_rng(1)
    for cin, cout in ((4, 64), (5, 12), (72, 8), (130, 3)):
        for sg, shape in ((conv_block.segment(cin, 9), (3, 3, cin, cout)),
                          (conv_block.segment(cin, 1), (cin, cout))):
            wt = rng.standard_normal(shape).astype(np.float32)
            got = conv_block.gemm_weights(torch.from_numpy(wt), sg).numpy()
            assert got.shape == (cout, sg.kseg)
            tap, c, ok = decode(sg, np.arange(sg.kseg))
            w9 = wt.reshape(sg.taps, cin, cout)
            want = np.where(ok[None], w9[np.minimum(tap, sg.taps - 1), np.minimum(c, cin - 1)].T, 0)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,k,bn", [(64, 48, 64), (12, 128, 64), (300, 200, 256), (72, 1200, 128)])
def test_weight_tiles_are_stages_in_memory(c, k, bn):
    """B atom (j, a), which a step's bulk copy moves into a stage with the
    step's other atoms, holds at the swizzled offset of (n, kk) the GEMM
    weight (j bn + n, a 64 + kk), and 0 past the channels and the K, which
    pads to whole steps."""
    rng = np.random.default_rng(2)
    wm = torch.from_numpy(rng.standard_normal((c, k)).astype(np.float32))
    atoms = conv_block.bf16_atoms(bn, k)
    tiles = conv_block.weight_tiles(wm, bn, atoms).numpy()
    bk = conv_block.BF16_BK
    assert tiles.shape == (-(-c // bn), -(-k // (atoms * bk)) * atoms, bn, bk)
    flat = tiles.reshape(tiles.shape[0], tiles.shape[1], -1)  # a tile's bytes / 2
    padded = np.zeros((tiles.shape[0] * bn, tiles.shape[1] * bk), dtype=np.float32)
    padded[:c, :k] = wm.numpy()
    n, kk = np.meshgrid(np.arange(bn), np.arange(bk), indexing="ij")
    pos = swizzled_offset(n, kk) // 2
    for j in range(tiles.shape[0]):
        for s in range(tiles.shape[1]):
            np.testing.assert_array_equal(flat[j, s][pos], padded[j * bn + n, s * bk + kk])


def producer_copies(sg, kl):
    """The copies load_a_atom issues for one thread's 8 K values at
    segment K index ``kl`` (a multiple of 8): [(first K offset, tap,
    first channel, valid, channels)], transcribed from the kernel's two
    paths (64-channel chunks; the per-copy decode)."""
    if sg.width == conv_block.BF16_BK and sg.vec == 8:
        j = kl // conv_block.BF16_BK
        chunk, tap = (j // 9, j % 9) if sg.taps == 9 else (j, 0)
        c = chunk * conv_block.BF16_BK + (kl - j * conv_block.BF16_BK)
        return [(0, tap, c, c < sg.channels, 8)]
    chunk, rem = kl // sg.kchunk, kl % sg.kchunk
    out = []
    for e in range(0, 8, sg.vec):
        t = (rem + e) // sg.width
        c = chunk * sg.width + (rem + e - t * sg.width)
        out.append((e, t, c, t < sg.taps and c < sg.channels, sg.vec))
    return out


# the small fused generator's blocks (card_check.FUSED: 48^2, base 4):
# conv2's own segments of 9 x 32 and 9 x 16 values end off a 64-value atom
SMALL_UNET = [(2, 48, 48, 4, 4), (2, 24, 24, 4, 8), (2, 12, 12, 8, 16), (2, 6, 6, 16, 32),
              (2, 3, 3, 32, 64), (2, 6, 6, 64, 32), (2, 12, 12, 32, 16), (2, 24, 24, 16, 8),
              (2, 48, 48, 8, 4)]


@pytest.mark.parametrize("shape", ALL_SHAPES + SMALL_UNET, ids=str)
def test_producer_decode_matches_the_k_order(shape):
    """Every copy the producer issues for conv1 and for conv2 + shortcut
    (each thread's 8 K values, the segment chosen from the global K, the
    atoms of a step in turn) reads the (tap, channels) the segment's K
    order assigns those values, and each K value is read once."""
    _, _, _, cin, cout = shape
    conv1, conv2, shortcut = _segments(cin, cout)
    for segs in ((conv1,), (conv2, shortcut)):
        ktot = sum(sg.kseg for sg in segs)
        seen = np.zeros(ktot, dtype=np.int64)
        for kk in range(0, ktot, 8):
            second = len(segs) > 1 and kk >= segs[0].kseg
            sg = segs[1 if second else 0]
            kl = kk - (segs[0].kseg if second else 0)
            for e, tap, c, ok, n in producer_copies(sg, kl):
                want_tap, want_c, want_ok = decode(sg, np.arange(kl + e, kl + e + n))
                assert (want_ok == ok).all()
                if ok:
                    assert (want_tap == tap).all() and (want_c == c + np.arange(n)).all()
                seen[kk + e:kk + e + n] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("shape", K5_SHAPES + SMALL_UNET[:5], ids=str)
def test_prepare_gathers_the_weight_tiles(shape):
    """prepare()'s cached gather gives the B tiles that weight_tiles lays
    out from the gemm_weights matrices: conv1's, and conv2's with the
    shortcut's K appended (the kernel's layout, held by the tests above)."""
    _, _, _, cin, cout = shape
    rng = np.random.default_rng(4)
    w1, w2, w3 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((3, 3, cin, cout), (3, 3, cout, cout), (cin, cout)))
    conv1, conv2, shortcut = _segments(cin, cout)
    bn = conv_block.bf16_bn(cout)
    idx1, idx2 = conv_block._bf16_tile_index(cin, cout, torch.device("cpu"))
    zero = torch.zeros(1)
    np.testing.assert_array_equal(
        torch.cat([zero, w1.reshape(-1)])[idx1.long()].numpy(),
        conv_block.weight_tiles(conv_block.gemm_weights(w1, conv1), bn,
                                conv_block.bf16_atoms(bn, conv1.kseg)).numpy())
    want = conv_block.weight_tiles(torch.cat([conv_block.gemm_weights(w2, conv2),
                                              conv_block.gemm_weights(w3, shortcut)], dim=1),
                                   bn, conv_block.bf16_atoms(bn, conv2.kseg + shortcut.kseg))
    np.testing.assert_array_equal(torch.cat([zero, w2.reshape(-1), w3.reshape(-1)])[idx2.long()].numpy(),
                                  want.numpy())
