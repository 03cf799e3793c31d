"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where no CUDA device is present (decided
inside the fixture, never at import).  The module imports neither jax nor
the JAX package, so on the GPU machine it runs without the repo's
conftest::

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance for K1, K2 and K3 against their plain versions: relative to
max |plain|, 1e-4 at worst and 1e-5 at the 99.9th percentile (float32 FFT
rounding over a few 1024-point transforms is ~1e-6; H is computed in the
same f32 operation order on both sides).  K4 and K5 are held to the same
bound: K4 repeats the plain version's float32 theta and differs only in
sincosf against torch's cos/sin (~1 ulp); K5 takes each float32 product as
three TF32 products (split precision, each within ~2^-22 of the product)
and sums them in float32, against cuDNN with TF32 off (a few 1e-7 of the
largest output over 9 * Cin terms; one TF32 pass would miss the bound,
tests/test_torch_k5_tiles.py).  K5's bfloat16 variant is held to the bfloat16 bounds
derived in ``fused_smoke.py`` (9 u at worst, 2 u at p99.9, u = 2^-8), and
the bfloat16 slices to those of ``card_check.py``.
"""

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import card_check, fused_smoke
from learned_hologram_gan_tpu_torch.config import OpticsConfig
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.ops.cuda import conv_block, fft, fft_plan, spectral, transfer

pytestmark = pytest.mark.cuda

MAX_REL, P999_REL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def _fft_libraries():
    """K1's and K3's libraries, built in parallel once (each mixed-radix
    plan is a library of its own, fft_plan.build_defines): K3's for every
    length it takes, K1's for the powers of two and the padded rows of
    GRIDS_MIXED."""
    from learned_hologram_gan_tpu_torch.ops.cuda import build

    k3 = [()] + [fft_plan.build_defines(fft_plan.make_plan(n)) for n in K3_MIXED_LENGTHS]
    k1 = [()] + [fft_plan.build_defines(fft_plan.make_plan(rows + 2 * pad)) for rows, _, pad, _, _ in GRIDS_MIXED]
    build.build_jobs([(fft.KERNEL_NAME, d) for d in k3] + [(spectral.KERNEL_NAME, d) for d in k1])


@pytest.fixture
def device(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    request.getfixturevalue("_fft_libraries")
    return torch.device("cuda")


def assert_rel_close(kr, ki, rr, ri):
    err = torch.sqrt((kr - rr) ** 2 + (ki - ri) ** 2).flatten()
    rel = err / torch.sqrt(rr**2 + ri**2).max()
    assert float(rel.max()) <= MAX_REL
    assert float(rel.sort().values[int(0.999 * (rel.numel() - 1))]) <= P999_REL


# (conj_h, num_d, from_spectrum, per_plane, mask_override): the inference
# modes, then the training ones (the eval step's from_spectrum stack, the
# random distances, and the two-H hat path's field input with a distance
# per plane and a caller's mask: the plan's mask times a seeded field in
# [0.5, 1], computed on the card)
MODES = {
    "backward": (True, 1, False, False, False),
    "stack": (False, 3, False, False, False),
    "stack_d20": (False, 20, False, False, False),
    "from_spectrum": (False, 3, True, False, False),
    "from_spectrum_per_plane": (False, 1, True, True, False),
    "field_per_plane_mask_override": (False, 1, False, True, True),
}


def _k1_case(device, rows, cols, pad, batch, mode, seed=0, pad_cols=None):
    conj_h, num_d, from_spectrum, per_plane, override = MODES[mode]
    optics = OpticsConfig(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45,
                          pad_cols_override=pad_cols)
    plan = asm.make_plan(optics, distances=np.linspace(4e-4, 1e-3, 3 if per_plane else num_d),
                         device=device)
    rng = np.random.default_rng(seed)
    shape = (batch, 3) + ((optics.padded_rows, optics.padded_cols) if from_spectrum else (rows, cols))
    amp = torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)
    phs = torch.from_numpy((2 * np.pi * rng.random(shape)).astype(np.float32)).to(device)
    dists = plan.distances[torch.arange(batch, device=device) % 3] if per_plane else plan.distances
    mask = None
    if override:
        field = rng.uniform(0.5, 1.0, tuple(plan.mask.shape)).astype(np.float32)
        mask = plan.mask * torch.from_numpy(field).to(device)
    return asm.fused_args(plan, asm.field(amp, phs), dists, conj_h=conj_h,
                          from_spectrum=from_spectrum, per_plane=per_plane, use_mask=not conj_h,
                          mask_override=mask)


GRIDS = [
    (24, 32, 4, 2),      # 32 x 40 grid: one FFT pass
    (24, 25, 4, 2),      # 32 x 33: an odd column count, a ragged last block of columns
    (40, 23, 12, 1),     # 64 x 47: two passes, ragged columns
    (48, 48, 8, 2),      # 64 x 64
    (384, 384, 320, 1),  # the main path's 1024 x 1024 grid
    (768, 768, 640, 1),  # 2048 x 2048: three passes, two exchanges in K1
]


@pytest.mark.parametrize("rows,cols,pad,batch", GRIDS)
@pytest.mark.parametrize("mode", list(MODES))
def test_k1_matches_plain_version(device, rows, cols, pad, batch, mode):
    args = _k1_case(device, rows, cols, pad, batch, mode)
    before = spectral.row_pass.launches
    kr, ki = spectral.propagate_planes(*args)
    torch.cuda.synchronize()
    assert spectral.row_pass.launches == before + 1
    assert_rel_close(kr, ki, *spectral.propagate_planes_reference(*args))


@pytest.mark.parametrize("rows,cols,pad,batch", GRIDS)
@pytest.mark.parametrize("mode", list(MODES))
def test_k2_matches_plain_version(device, rows, cols, pad, batch, mode):
    """K2 through its wrapper (column transforms, the row adjoint, the
    inverse column transform or the scaled spectrum) against the plain
    adjoint, on a seeded cotangent."""
    fr, fi, wl2, dists, mask, cfg = _k1_case(device, rows, cols, pad, batch, mode)
    rng = np.random.default_rng(2)
    shape = (fr.shape[0], cfg[4], rows, cols)
    gr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    gi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    before = spectral.row_adjoint.launches
    kr, ki = spectral._adjoint_cuda(gr, gi, wl2, dists, mask, cfg)
    torch.cuda.synchronize()
    assert spectral.row_adjoint.launches == before + 1
    assert_rel_close(kr, ki, *spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dists, mask, cfg))


@pytest.mark.parametrize("rows,cols,pad,batch", GRIDS)
@pytest.mark.parametrize("mode", list(MODES))
def test_k2_matches_autograd_through_plain_version(device, rows, cols, pad, batch, mode):
    """K2 (the backward of propagate_planes on the card) against
    torch.autograd through K1's plain version, on the same cotangent."""
    fr, fi, *rest = _k1_case(device, rows, cols, pad, batch, mode)
    fr, fi = fr.requires_grad_(True), fi.requires_grad_(True)
    kr, ki = spectral.propagate_planes(fr, fi, *rest)
    rng = np.random.default_rng(1)
    gr = torch.from_numpy(rng.standard_normal(kr.shape).astype(np.float32)).to(device)
    gi = torch.from_numpy(rng.standard_normal(kr.shape).astype(np.float32)).to(device)
    before = spectral.row_adjoint.launches
    got = torch.autograd.grad((kr * gr + ki * gi).sum(), (fr, fi))
    torch.cuda.synchronize()
    assert spectral.row_adjoint.launches == before + 1
    rr, ri = spectral.propagate_planes_reference(fr, fi, *rest)
    want = torch.autograd.grad((rr * gr + ri * gi).sum(), (fr, fi))
    assert_rel_close(*got, *want)


# (rows, cols, pad, batch, pad_cols): padded rows rp of lengths that are
# not powers of two, one mixed-radix plan (and library) each: 12 (E = 12,
# one pass), 96 (4 * 24 on E = 24), 384 (2 * 8 * 24), 768 (16 * 3 * 16), the
# portrait 1280 (16 * 5 * 16 on E = 16, a guarded middle pass; 640 x 384 at
# pads 320 / 192, the 1280 x 768 grid), 1728 (1080p's rp; 24 * 24 * 3),
# 2880 (12 * 20 * 12 on E = 60) and 5000 (40 * 25 * 5), with ragged column counts
GRIDS_MIXED = [
    (8, 8, 2, 2, 3),
    (40, 23, 28, 1, 5),
    (256, 100, 64, 1, 14),
    (384, 64, 192, 1, 100),
    (640, 384, 320, 1, 192),
    (1080, 40, 324, 1, 300),
    (2000, 16, 440, 1, 200),
    (4000, 8, 500, 1, 100),
]


@pytest.mark.parametrize("rows,cols,pad,batch,pad_cols", GRIDS_MIXED)
@pytest.mark.parametrize("mode", list(MODES))
def test_k1_k2_mixed_radix_match_plain_versions(device, rows, cols, pad, batch, pad_cols, mode):
    """K1, and K2 through its wrapper, on grids whose padded row count is a
    2*3*5-smooth length other than a power of two, against the plain
    versions."""
    args = _k1_case(device, rows, cols, pad, batch, mode, pad_cols=pad_cols)
    assert spectral.supported(args[-1][5], args[-1][6])
    before = spectral.row_pass.launches
    kr, ki = spectral.propagate_planes(*args)
    torch.cuda.synchronize()
    assert spectral.row_pass.launches == before + 1
    assert_rel_close(kr, ki, *spectral.propagate_planes_reference(*args))
    del kr, ki
    fr, fi, wl2, dists, mask, cfg = args
    rng = np.random.default_rng(2)
    shape = (fr.shape[0], cfg[4], rows, cols)
    gr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    gi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    before = spectral.row_adjoint.launches
    kr, ki = spectral._adjoint_cuda(gr, gi, wl2, dists, mask, cfg)
    torch.cuda.synchronize()
    assert spectral.row_adjoint.launches == before + 1
    assert_rel_close(kr, ki, *spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dists, mask, cfg))


@pytest.mark.parametrize("shape", [(12, 1024, 1024), (2, 3, 64, 32), (5, 2, 8)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fft2", "ifft2"])
def test_k3_matches_torch_fft(device, shape, inverse):
    """fft2/ifft2 through K3 against torch.fft, forward and backward (torch's
    complex convention: the backward of fft2 is N * ifft2)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         .astype(np.complex64)).to(device).requires_grad_(True)
    g = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         .astype(np.complex64)).to(device)
    ours, ref = (fft.ifft2, torch.fft.ifft2) if inverse else (fft.fft2, torch.fft.fft2)
    before = fft.fft_axis.launches
    y = ours(x)
    (gx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    assert fft.fft_axis.launches == before + 4
    y_ref = ref(x)
    (gx_ref,) = torch.autograd.grad(y_ref, x, g)
    assert_rel_close(y.real, y.imag, y_ref.real, y_ref.imag)
    assert_rel_close(gx.real, gx.imag, gx_ref.real, gx_ref.imag)


K3_LENGTHS = [2**k for k in range(1, 15)]
# every other 2*3*5-smooth length up to 16384 that K3 takes: each mixed-radix
# plan (a library each, 1 to 6 passes); pure Python, the same on every host
K3_MIXED_LENGTHS = [n for n in range(2, fft_plan.MAX_LENGTH + 1)
                    if n & (n - 1) and fft_plan.is_smooth(n) and fft.supported_length(n)]


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("n", K3_LENGTHS + K3_MIXED_LENGTHS)
def test_k3_axis_matches_torch_fft(device, n, axis):
    """One K3 pass at every length it takes, along each axis, forward and
    inverse (scale 1/n), on 3 planes of 37 lines: a count no block's lines
    divide, so the last block is ragged."""
    rng = np.random.default_rng(n)
    shape = (3, 37, n) if axis == -1 else (3, n, 37)
    x = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         .astype(np.complex64)).to(device)
    before = fft.fft_axis.launches
    y = fft.fft_axis(x, axis, False, 1.0)
    yi = fft.fft_axis(x, axis, True, 1.0 / n)
    torch.cuda.synchronize()
    assert fft.fft_axis.launches == before + 2
    want = torch.fft.fft(x, dim=axis)
    assert_rel_close(y.real, y.imag, want.real, want.imag)
    want = torch.fft.ifft(x, dim=axis)
    assert_rel_close(yi.real, yi.imag, want.real, want.imag)


@pytest.mark.parametrize("n", K3_LENGTHS + [768, 1280, 1728, 2880, 5000])
def test_k3_fft2_backward_matches_torch_fft(device, n):
    """fft2 and ifft2 through K3 with their backward, on (3, n, 64) planes."""
    rng = np.random.default_rng(n + 1)
    shape = (3, n, 64)
    x = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         .astype(np.complex64)).to(device).requires_grad_(True)
    g = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         .astype(np.complex64)).to(device)
    for ours, ref in ((fft.fft2, torch.fft.fft2), (fft.ifft2, torch.fft.ifft2)):
        before = fft.fft_axis.launches
        y = ours(x)
        (gx,) = torch.autograd.grad(y, x, g)
        torch.cuda.synchronize()
        assert fft.fft_axis.launches == before + 4
        y_ref = ref(x)
        (gx_ref,) = torch.autograd.grad(y_ref, x, g)
        assert_rel_close(y.real, y.imag, y_ref.real, y_ref.imag)
        assert_rel_close(gx.real, gx.imag, gx_ref.real, gx_ref.imag)


def test_kernels_raise_instead_of_falling_back(device):
    """A CUDA tensor the kernels do not take raises; it never takes a plain
    version."""
    args = _k1_case(device, 24, 24, 5, 1, "stack")  # 34 x 34: 34 = 2 * 17, no plan
    with pytest.raises(ValueError):
        spectral.propagate_planes(*args)
    fr, fi, wl2, dists, mask, cfg = args
    g = torch.zeros((3, 3, 24, 34), dtype=torch.complex64, device=device)
    with pytest.raises(ValueError):
        spectral.row_adjoint(g, wl2, dists, mask, cfg)  # K2 on the same grid
    with pytest.raises(ValueError):
        fft.fft_axis(torch.zeros((2, 14, 64), dtype=torch.complex64, device=device), -2, False, 1.0)
    with pytest.raises(ValueError):
        fft.fft2(torch.zeros((2, 64, 64), dtype=torch.complex128, device=device))


def test_small_slice_on_card_matches_cpu(device):
    """generate_poh on the card (kernels) against the CPU (plain versions),
    with TF32 left at torch's default: the port itself must keep every
    float32 convolution out of TF32."""
    assert torch.backends.cudnn.allow_tf32  # torch's default, untouched
    stats = card_check.card_vs_cpu(device)
    assert stats["convs"] > 0 and stats["convs_tf32"] == 0
    card_check.check(stats)


def test_train_step_on_card_matches_cpu(device):
    """One GAN train step on the card (K1, K2, K3) against the CPU, from the
    same weights and draws, TF32 off in every convolution forward and
    backward."""
    assert torch.backends.cudnn.allow_tf32  # torch's default, untouched
    card_check.check_train_step(card_check.train_step_card_vs_cpu(device))


def test_stage2_step_on_card_matches_cpu(device):
    """One stage-2 pretraining loss and its gradients on the card (K1
    conj_h once; K3 forward, and its adjoint in the backward, twelve
    launches) against the CPU."""
    card_check.check_stage2_step(card_check.stage2_step_card_vs_cpu(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("option", [dict(two_h_hat=True), dict(critic_batching="separate"),
                                    dict(critic_batching="full")],
                         ids=["two_h_hat", "separate", "full"])
def test_train_step_option_on_card_matches_cpu(device, option, dtype):
    """The two-H hat path (K1 and K2 on field input, a distance per plane
    and the product mask; no K3) and the separate and full critic
    batchings, card against CPU at the same bounds."""
    card_check.check_train_step(card_check.train_step_card_vs_cpu(device, dtype=dtype, **option))


# (B, H, W, Cin, Cout): 8 -> 8 channels; odd image sizes with Cin != Cout
# (5 and 12 channels: 4- and 8-byte copies, a ragged 64-channel tile); more
# output channels than one 64-channel tile and more input channels than one
# atom (32 float32, 64 bfloat16 values), both ragged; enc_0's 4 -> 64
K5_SHAPES = [(2, 16, 32, 8, 8), (3, 13, 37, 5, 12), (1, 20, 12, 40, 72), (2, 24, 40, 4, 64)]


@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_matches_plain_version(device, shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(3)

    def draw(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(device)

    args = (draw(b, h, w, cin), draw(3, 3, cin, cout, scale=(9 * cin) ** -0.5), draw(cout),
            draw(3, 3, cout, cout, scale=(9 * cout) ** -0.5), draw(cout),
            draw(cin, cout, scale=cin ** -0.5), draw(cout))
    before = conv_block.fused_residual_block.launches
    got = conv_block.fused_residual_block(*args)
    torch.cuda.synchronize()
    assert conv_block.fused_residual_block.launches == before + 1
    want = conv_block.residual_block_reference(*args)
    assert got.shape == want.shape == (b, h, w, cout)
    zeros = torch.zeros_like(want)
    assert_rel_close(got, zeros, want, zeros)


@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_bf16_matches_plain_version(device, shape):
    """K5's bfloat16 entry on a bfloat16 input with float32 folded weights
    (the wrapper casts them, as the JAX wrapper does)."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(5)

    def draw(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(device)

    x = draw(b, h, w, cin).bfloat16()
    args = (draw(3, 3, cin, cout, scale=(9 * cin) ** -0.5), draw(cout),
            draw(3, 3, cout, cout, scale=(9 * cout) ** -0.5), draw(cout),
            draw(cin, cout, scale=cin ** -0.5), draw(cout))
    before = conv_block.fused_residual_block.launches
    got = conv_block.fused_residual_block(x, *args)
    torch.cuda.synchronize()
    assert conv_block.fused_residual_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, cout)
    want = conv_block.residual_block_reference(x, *args).float()
    err = (got.float() - want).abs().flatten() / want.abs().max()
    assert float(err.max()) <= fused_smoke.K5_BF16_MAX_REL_TOL
    assert float(err.sort().values[int(0.999 * (err.numel() - 1))]) <= fused_smoke.K5_BF16_P999_REL_TOL


# (B, H, W, Cin, Cout): the full-width UNet's nine blocks at batch 2, then
# the small fused generator's (card_check.FUSED: 48^2, base 4), whose conv2
# segments of 9 x 32 and 9 x 16 values end off a 64-value bfloat16 K atom
# (9 x 16 also off a 32-value float32 one)
K5_UNET_SHAPES = ([(2, hw, hw, cin, cout) for _, hw, cin, cout in fused_smoke.UNET_BLOCKS]
                  + [(2, 48 >> i, 48 >> i, max(4, 2 << i), 4 << i) for i in range(4)]
                  + [(2, 3, 3, 32, 64)]
                  + [(2, 48 >> i, 48 >> i, 8 << i, 4 << i) for i in reversed(range(4))])


@pytest.mark.parametrize("shape", K5_UNET_SHAPES, ids=str)
def test_k5_unet_blocks_match_plain_version(device, shape):
    """K5's float32 entry (3xTF32) at the UNet's block shapes, on a
    non-negative input (as the blocks see after a ReLU), within the float32
    bounds; one launch of the entry per block."""
    b, hw, _, cin, cout = shape
    rng = np.random.default_rng(7)

    def draw(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(device)

    x = draw(b, hw, hw, cin).abs()
    args = (draw(3, 3, cin, cout, scale=(9 * cin) ** -0.5), draw(cout, scale=0.1),
            draw(3, 3, cout, cout, scale=(9 * cout) ** -0.5), draw(cout, scale=0.1),
            draw(cin, cout, scale=cin ** -0.5), draw(cout, scale=0.1))
    before = conv_block.fused_residual_block.launches
    got = conv_block.fused_residual_block(x, *args)
    torch.cuda.synchronize()
    assert conv_block.fused_residual_block.launches == before + 1
    want = conv_block.residual_block_reference(x, *args)
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, hw, hw, cout)
    zeros = torch.zeros_like(want)
    assert_rel_close(got, zeros, want, zeros)


@pytest.mark.parametrize("shape", K5_UNET_SHAPES, ids=str)
def test_k5_bf16_unet_blocks_match_plain_version(device, shape):
    """K5's bfloat16 entry at the UNet's block shapes, on a non-negative
    input (as the blocks see after a ReLU)."""
    b, hw, _, cin, cout = shape
    rng = np.random.default_rng(6)

    def draw(*s, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(device)

    x = draw(b, hw, hw, cin).abs().bfloat16()
    args = (draw(3, 3, cin, cout, scale=(9 * cin) ** -0.5), draw(cout, scale=0.1),
            draw(3, 3, cout, cout, scale=(9 * cout) ** -0.5), draw(cout, scale=0.1),
            draw(cin, cout, scale=cin ** -0.5), draw(cout, scale=0.1))
    got = conv_block.fused_residual_block(x, *args)
    torch.cuda.synchronize()
    want = conv_block.residual_block_reference(x, *args).float()
    err = (got.float() - want).abs().flatten() / want.abs().max()
    assert float(err.max()) <= fused_smoke.K5_BF16_MAX_REL_TOL
    assert float(err.sort().values[int(0.999 * (err.numel() - 1))]) <= fused_smoke.K5_BF16_P999_REL_TOL


def test_k5_bf16_refusals(device):
    """prepare() takes bfloat16 x with bfloat16 weights and float32 biases
    and nothing else; launch() wants bfloat16 buffers for it."""
    x = torch.zeros((1, 8, 8, 4), device=device, dtype=torch.bfloat16)
    w1, w2, w3 = (torch.zeros(s, device=device, dtype=torch.bfloat16)
                  for s in ((3, 3, 4, 8), (3, 3, 8, 8), (4, 8)))
    b = torch.zeros(8, device=device)
    args = conv_block.prepare(x, w1, b, w2, b, w3, b)
    with pytest.raises(ValueError):
        conv_block.prepare(x, w1.float(), b, w2, b, w3, b)  # float32 weights
    with pytest.raises(ValueError):
        conv_block.prepare(x, w1, b.bfloat16(), w2, b, w3, b)  # bfloat16 bias
    with pytest.raises(ValueError):
        conv_block.fused_residual_block(x.half(), w1, b, w2, b, w3, b)  # float16
    y1 = torch.empty((1, 8, 8, 8), device=device)
    with pytest.raises(ValueError):
        conv_block.launch(*args, y1, y1)  # float32 buffers for a bfloat16 block


def test_small_slice_bf16_on_card_matches_cpu(device):
    card_check.check(card_check.card_vs_cpu(device, dtype="bfloat16"))


def test_train_step_bf16_on_card_matches_cpu(device):
    card_check.check_train_step(card_check.train_step_card_vs_cpu(device, dtype="bfloat16"))


def test_fused_generator_bf16_on_card_matches_cpu(device):
    card_check.check_fused(card_check.fused_card_vs_cpu(device, dtype="bfloat16"))


@pytest.mark.parametrize("rows,cols,batch,num_d", [(16, 16, 2, 3), (32, 48, 1, 1), (1024, 1024, 1, 4)])
def test_k4_matches_plain_version(device, rows, cols, batch, num_d):
    optics = OpticsConfig(rows=rows, cols=cols, pad_size=0, filter_radius_coefficient=0.45)
    ds = np.linspace(-4e-4, 1e-3, num_d).astype(np.float32)
    plan = asm.make_plan(optics, distances=ds, device=device)
    rng = np.random.default_rng(4)
    shape = (batch, 3, rows, cols)
    g0 = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                          .astype(np.complex64)).to(device)
    args = (g0, plan.w_grid, plan.mask, plan.distances)
    before = transfer.apply_transfer_stack.launches
    got = transfer.apply_transfer_stack(*args)
    torch.cuda.synchronize()
    assert transfer.apply_transfer_stack.launches == before + 1
    want = transfer.apply_transfer_stack_reference(*args)
    assert got.shape == want.shape == (batch, num_d, 3, rows, cols)
    assert_rel_close(got.real, got.imag, want.real, want.imag)


def test_k4_k5_raise_instead_of_falling_back(device):
    x = torch.zeros((1, 8, 8, 4), device=device)
    w1, w2, w3, b = (torch.zeros(s, device=device) for s in ((3, 3, 4, 8), (3, 3, 8, 8), (4, 8), (8,)))
    with pytest.raises(ValueError):
        conv_block.fused_residual_block(x.double(), w1, b, w2, b, w3, b)
    with pytest.raises(ValueError):
        conv_block.fused_residual_block(x, w1, b, w1, b, w3, b)  # w2 of the wrong shape
    g0 = torch.zeros((1, 3, 16, 16), dtype=torch.complex64, device=device)
    w_grid, mask = torch.zeros((3, 16, 16), device=device), torch.ones((16, 16), device=device)
    with pytest.raises(ValueError):
        transfer.apply_transfer_stack(g0, w_grid, mask, torch.zeros(2, device=device).double())
    with pytest.raises(ValueError):
        transfer.apply_transfer_stack(g0.to(torch.complex128), w_grid, mask, torch.zeros(2, device=device))


def test_fused_generator_on_card_matches_cpu(device):
    """generator_apply_fused at 48 x 48 on the card (K5 on
    all nine blocks, seven with polyphase level 0) against the CPU."""
    card_check.check_fused(card_check.fused_card_vs_cpu(device))


def test_int8_executor_on_card_matches_cpu(device):
    """im2col + torch._int_mm (cuBLASLt's int8 GEMM) at every conv and
    up-conv shape of a base-8 UNet at batch 2 of 32^2, bit for bit against
    the exact CPU products (serve_smoke._exact_cpu)."""
    from learned_hologram_gan_tpu_torch import serve_smoke
    from learned_hologram_gan_tpu_torch.ops import int8

    rng = np.random.default_rng(3)
    for path, xs, ws in serve_smoke.executor_shapes(batch=2, rows=32, cols=32, base=8):
        x = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, ws, dtype=np.int8))
        if len(ws) == 2:
            got = int8.matmul(x.to(device).reshape(-1, xs[-1]), w.to(device)).reshape(*xs[:3], -1)
        else:
            got = int8.conv2d(x.to(device), w.to(device))
        assert torch.equal(got.cpu(), serve_smoke._exact_cpu(x, w)), path


def test_int_mm_refuses_unpadded_shapes_and_the_wrapper_pads(device):
    a = torch.ones(8, 36, dtype=torch.int8, device=device)
    b = torch.ones(36, 6, dtype=torch.int8, device=device)
    with pytest.raises(RuntimeError):
        torch._int_mm(a, b)
    from learned_hologram_gan_tpu_torch.ops import int8

    assert torch.equal(int8.matmul(a, b), torch.full((8, 6), 36, dtype=torch.int32, device=device))


def test_serving_path_on_card_matches_cpu(device):
    """PohService in float32 and int8 on the card (K1, K3) against the CPU
    (plain versions), launches as the server makes them."""
    card_check.check_serving(card_check.serving_card_vs_cpu(device))
