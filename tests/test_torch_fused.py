"""The port's fused eval path against the JAX package: BN folding, the
residual block (K5's plain version), the polyphase primitives, the fused
UNet and generator, and the transfer-stack apply (K4's plain version).

Inputs and weights are seeded numpy, carried into the port through
``convert`` (test_torch_models.jax_variables: every leaf randomized,
BatchNorm statistics included, so folding is exercised).  On the CPU the
port's wrappers take their plain versions; the JAX side runs its Pallas
kernels in interpret mode where a test names them.

Bounds are the JAX package's own: 2e-4 for the residual block
(tests/test_conv_block.py), 2e-5 and 3e-5 for the fused UNet, plain and
polyphase (tests/test_fused_unet.py), 5e-5 for the fused generator against
its module forward, the POH phasor bounds of PERF.md section 2 against JAX,
and 1e-6 for the transfer stack (tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import OpticsConfig as JaxOpticsConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import generator_apply_fused as jax_generator_apply_fused
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.nn import blocks as jblocks
from learned_hologram_gan_tpu.nn import polyphase as jpoly
from learned_hologram_gan_tpu.nn.fused_unet import unet_apply_fused as jax_unet_apply_fused
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.ops.pallas import apply_transfer_stack as jax_transfer_stack
from learned_hologram_gan_tpu.ops.pallas import (
    apply_transfer_stack_reference as jax_transfer_stack_reference,
)
from learned_hologram_gan_tpu.ops.pallas import conv_block as jcb
from learned_hologram_gan_tpu_torch import card_check, convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, OpticsConfig
from learned_hologram_gan_tpu_torch.models import (
    Generator,
    generator_apply_fused,
    make_generator_plan,
)
from learned_hologram_gan_tpu_torch.nn import blocks, fused_unet, polyphase
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.ops.cuda import conv_block as cb
from learned_hologram_gan_tpu_torch.ops.cuda import transfer
from test_torch_models import jax_variables, to_jax


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# BN folding and the residual block (K5's plain version)
# ---------------------------------------------------------------------------


def _block_pair(cin, cout, seed):
    """A JAX ResidualBlock's randomized variables and the port block
    carrying them, in eval mode."""
    x = np.random.default_rng(seed).standard_normal((2, 8, 8, cin)).astype(np.float32)
    variables = jax_variables(jblocks.ResidualBlock(cout, use_1x1conv=True), jnp.asarray(x),
                              train=False, seed=seed)
    m = blocks.ResidualBlock(cin, cout, use_1x1conv=True).eval()
    m.load_state_dict(convert.generator_state_dict(variables))
    return variables, m


@pytest.mark.parametrize("idx", [0, 1])
def test_fold_conv_bn_matches_jax(idx):
    variables, m = _block_pair(3, 8, seed=31)
    p, s = variables["params"], variables["batch_stats"]
    want_w, want_b = jcb.fold_conv_bn(p[f"Conv_{idx}"], p[f"BatchNorm_{idx}"], s[f"BatchNorm_{idx}"])
    got_w, got_b = cb.fold_conv_bn(getattr(m, f"Conv_{idx}"), getattr(m, f"BatchNorm_{idx}"))
    assert got_w.dtype == got_b.dtype == torch.float32
    assert tuple(got_w.shape) == want_w.shape
    # the same f32 products; rsqrt may round 1 ulp apart between the two
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-7)


RNG = np.random.default_rng(17)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 8), (1, 24, 16, 4, 8)])
def test_residual_block_reference_matches_jax(shape):
    """The plain version against the JAX oracle and against the Pallas
    kernel in interpret mode (tests/test_conv_block.py's shapes and
    bound)."""
    b, h, w, cin, cout = shape
    args = [RNG.normal(size=s).astype(np.float32) for s in
            [(b, h, w, cin), (3, 3, cin, cout), (cout,), (3, 3, cout, cout), (cout,),
             (cin, cout), (cout,)]]
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jcb.residual_block_reference(*jargs))
    want_kernel = np.asarray(jcb.fused_residual_block(*jargs, row_block=8))
    before = cb.fused_residual_block.launches
    got = cb.residual_block_reference(*map(t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-4, atol=2e-4)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    torch.testing.assert_close(cb.fused_residual_block(*map(t, args)), torch.from_numpy(got))
    assert cb.fused_residual_block.launches == before


def test_folded_block_matches_module():
    """fold_conv_bn + the plain version against the port's eval-mode
    ResidualBlock, borders included."""
    _, m = _block_pair(4, 8, seed=32)
    x = np.random.default_rng(33).standard_normal((2, 12, 10, 4)).astype(np.float32)
    with torch.no_grad():
        want = m(nchw(x)).permute(0, 2, 3, 1).numpy()
        got = cb.residual_block_reference(t(x), *fused_unet._folded(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_k5_support_predicate():
    """K5 admits all nine blocks of the full-width UNet (384^2, base 64, four
    levels) and refuses empty sizes."""
    full = [(384, 4, 64), (192, 64, 128), (96, 128, 256), (48, 256, 512), (24, 512, 1024),
            (48, 1024, 512), (96, 512, 256), (192, 256, 128), (384, 128, 64)]
    assert all(cb.supported(hw, hw, cin, cout) for hw, cin, cout in full)
    assert cb.supported(13, 37, 3, 5)
    assert not cb.supported(0, 16, 4, 4) and not cb.supported(16, 16, 4, 0)


# ---------------------------------------------------------------------------
# polyphase primitives
# ---------------------------------------------------------------------------


def _poly_case(name, rng):
    x4 = rng.standard_normal((2, 5, 6, 12)).astype(np.float32)  # 4 phases x 3 channels
    if name == "space_to_depth":
        return (rng.standard_normal((2, 6, 8, 3)).astype(np.float32),)
    if name in ("depth_to_space", "poly_pool"):
        return (x4,)
    if name == "tile4":
        return (rng.standard_normal(5).astype(np.float32),)
    if name == "poly_conv3x3":
        return x4, rng.standard_normal((3, 3, 3, 4)).astype(np.float32), \
            rng.standard_normal(4).astype(np.float32)
    if name == "poly_conv1x1":
        return x4, rng.standard_normal((1, 1, 3, 4)).astype(np.float32), \
            rng.standard_normal(4).astype(np.float32)
    if name == "poly_upconv_gemm":
        return rng.standard_normal((2, 5, 6, 3)).astype(np.float32), \
            rng.standard_normal((2, 2, 3, 4)).astype(np.float32), \
            rng.standard_normal(4).astype(np.float32)
    if name == "poly_concat":
        return x4, rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    raise KeyError(name)


POLY = ["space_to_depth", "depth_to_space", "tile4", "poly_conv3x3", "poly_conv1x1",
        "poly_upconv_gemm", "poly_concat", "poly_pool"]


@pytest.mark.parametrize("name", POLY)
def test_polyphase_primitive_matches_jax(name):
    args = _poly_case(name, np.random.default_rng(40 + POLY.index(name)))
    want = np.asarray(getattr(jpoly, name)(*map(jnp.asarray, args)))
    with blocks.full_f32_convs():
        got = getattr(polyphase, name)(*map(t, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_poly_conv3x3_is_the_spatial_conv():
    """A 3x3 SAME conv in the phase domain is the spatial conv, exactly up
    to float32 reassociation."""
    rng = np.random.default_rng(48)
    x = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    want = torch.nn.functional.conv2d(nchw(x), t(k).permute(3, 2, 0, 1), padding=1)
    got = polyphase.depth_to_space(polyphase.poly_conv3x3(polyphase.space_to_depth(t(x)), t(k)))
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the fused UNet and generator
# ---------------------------------------------------------------------------


def _unet_pair(levels, seed):
    size = 16 if levels == 2 else 32
    x = np.random.default_rng(seed).random((2, size, size, 4)).astype(np.float32)
    jm = jblocks.UNet(output_channels=6, base_features=4, levels=levels)
    variables = jax_variables(jm, jnp.asarray(x), train=False, seed=seed)
    m = blocks.UNet(in_channels=4, output_channels=6, base_features=4, levels=levels).eval()
    m.load_state_dict(convert.generator_state_dict(variables))
    return variables, m, x


@pytest.mark.parametrize("polyphase_level0", [False, True], ids=["plain", "polyphase"])
@pytest.mark.parametrize("levels", [2, 4])
def test_unet_fused_matches_jax_and_module(levels, polyphase_level0):
    """Against JAX's unet_apply_fused and the port's module forward at the
    JAX tests' bounds; on the CPU every block takes K5's plain version, so
    nothing is launched."""
    variables, m, x = _unet_pair(levels, seed=50 + levels)
    want = np.asarray(jax.jit(
        lambda v, a: jax_unet_apply_fused(v["params"], v["batch_stats"], a,
                                          polyphase_level0=polyphase_level0)
    )(to_jax(variables), jnp.asarray(x)))
    before = cb.fused_residual_block.launches
    got = fused_unet.unet_apply_fused(m, t(x), polyphase_level0=polyphase_level0).numpy()
    assert cb.fused_residual_block.launches == before
    with torch.no_grad():
        module = m(nchw(x)).permute(0, 2, 3, 1).numpy()
    tol = 3e-5 if polyphase_level0 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, module, rtol=tol, atol=tol)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_unet_fused_refuses_bfloat16_and_identity_shortcuts():
    """A bfloat16 input, refused before bfloat16 was ported, now runs (in
    bfloat16; tests/test_torch_bf16.py holds its numbers); a UNet without
    its 1x1 shortcuts is still refused."""
    _, m, x = _unet_pair(2, seed=52)
    y = fused_unet.unet_apply_fused(m, t(x).bfloat16())
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    assert fused_unet.supported(m) and not fused_unet.supported(torch.nn.Identity())
    m.enc_1.Conv_2 = None
    assert not fused_unet.supported(m)
    with pytest.raises(ValueError, match="1x1 shortcut"):
        fused_unet.unet_apply_fused(m, t(x))


SMALL = dict(rows=32, cols=32, pad_size=16, filter_radius_coefficient=0.45,
             unet_base_features=4, distance=1e-3)


@pytest.fixture(scope="module")
def generators():
    jcfg = JaxGenConfig(**SMALL)
    jplan = jax_gen_plan(jcfg)
    rgbd = np.random.default_rng(60).random((2, 4, 32, 32)).astype(np.float32)
    jgen = JaxGenerator(jcfg)
    variables = jax_variables(jgen, jplan, jnp.asarray(rgbd[:1]), train=False, seed=61)
    model = Generator(GeneratorConfig(**SMALL)).eval()
    model.load_state_dict(convert.generator_state_dict(variables))
    return jgen, jplan, variables, model, rgbd


@pytest.mark.parametrize("polyphase_level0", [False, True], ids=["plain", "polyphase"])
def test_generator_fused_matches_jax_and_module(generators, polyphase_level0):
    """The POH against JAX's generator_apply_fused within PERF.md section
    2's phasor bounds (the double-phase acos amplifies rounding), and
    against the port's own module forward at tests/test_fused_unet.py's
    5e-5."""
    jgen, jplan, variables, model, rgbd = generators
    want = np.asarray(jax.jit(
        lambda v, plan, a: jax_generator_apply_fused(jgen, v, plan, a,
                                                     polyphase_level0=polyphase_level0)
    )(to_jax(variables), jplan, jnp.asarray(rgbd)))
    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    got = generator_apply_fused(model, plan, torch.from_numpy(rgbd),
                                polyphase_level0=polyphase_level0).numpy()
    mean, p99, worst = card_check.poh_phasor_errors(got, want)
    assert mean <= 2e-3 and p99 <= 1e-2 and worst <= 5e-2, (mean, p99, worst)
    with torch.no_grad():
        module = model(plan, torch.from_numpy(rgbd)).numpy()
    np.testing.assert_allclose(got, module, rtol=5e-5, atol=5e-5)


def test_fused_card_check_on_cpu():
    """The fused card-vs-CPU check with the CPU in both places: identical
    POHs, no K5 launch (the CPU takes the plain version), and check_fused()
    names the launch count it misses."""
    stats = card_check.fused_card_vs_cpu("cpu")
    assert stats["poh_max"] == 0 and stats["finite"]
    assert stats["k5_launches"] == stats["k5_launches_polyphase"] == 0
    with pytest.raises(AssertionError, match="K5 launched 0 times"):
        card_check.check_fused(stats)
    card_check.check_fused(dict(stats, k5_launches=9, k5_launches_polyphase=7))


def test_fused_card_check_bf16_on_cpu():
    """The same in bfloat16: identical POHs, held to the bfloat16 gate."""
    stats = card_check.fused_card_vs_cpu("cpu", dtype="bfloat16")
    assert stats["poh_gate"] == 0 and stats["finite"]
    card_check.check_fused(dict(stats, k5_launches=9, k5_launches_polyphase=7))
    with pytest.raises(AssertionError, match="poh_gate"):
        card_check.check_fused(dict(stats, k5_launches=9, k5_launches_polyphase=7, poh_gate=0.1))


# ---------------------------------------------------------------------------
# the transfer-stack apply (K4's plain version)
# ---------------------------------------------------------------------------

# tests/test_pallas.py's cases: (rows, cols, distances, batch, tile_rows)
TRANSFER = [(16, 16, np.linspace(4e-4, 1e-3, 3), 2, 8), (32, 16, np.array([1e-3]), 1, 16)]


@pytest.mark.parametrize("rows,cols,ds,batch,tile_rows", TRANSFER)
def test_transfer_stack_plain_matches_jax(rows, cols, ds, batch, tile_rows):
    """Both sides get the JAX plan's own w-grid and mask: one ulp of w moves
    theta by ~1.6e-3 rad at w ~ 2.2e6 / m and z = 1 mm, far above 1e-6."""
    optics = JaxOpticsConfig(rows=rows, cols=cols, pad_size=0, filter_radius_coefficient=0.45)
    ds = ds.astype(np.float32)
    jplan = jasm.make_plan(optics, distances=ds)
    w_grid, mask = np.asarray(jplan.w_grid), np.asarray(jplan.mask)
    rng = np.random.default_rng(70 + rows)
    shape = (batch, 3, rows, cols)
    g0 = (rng.random(shape) + 1j * rng.random(shape)).astype(np.complex64)
    args = (jnp.asarray(g0), jnp.asarray(w_grid), jnp.asarray(mask), jnp.asarray(ds))
    want_kernel = np.asarray(jax_transfer_stack(*args, tile_rows=tile_rows, interpret=True))
    want = np.asarray(jax_transfer_stack_reference(*args))
    targs = (torch.from_numpy(g0), t(w_grid), t(mask), t(ds))
    got = transfer.apply_transfer_stack_reference(*targs).numpy()
    assert got.shape == (batch, len(ds), 3, rows, cols) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want_kernel, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)
    before = transfer.apply_transfer_stack.launches
    np.testing.assert_array_equal(transfer.apply_transfer_stack(*targs).numpy(), got)
    assert transfer.apply_transfer_stack.launches == before


@pytest.mark.parametrize("rows,cols,ds,batch,tile_rows", TRANSFER)
def test_transfer_stack_w_grid_matches_jax(rows, cols, ds, batch, tile_rows):
    """The w-grid and mask K4 takes from a port plan (asm._w_grid) are the
    JAX plan's, bit for bit (the same numpy float32 operation order)."""
    o = dict(rows=rows, cols=cols, pad_size=0, filter_radius_coefficient=0.45)
    jplan = jasm.make_plan(JaxOpticsConfig(**o), distances=ds.astype(np.float32))
    plan = asm.make_plan(OpticsConfig(**o), distances=ds, device="cpu")
    np.testing.assert_array_equal(plan.w_grid.numpy(), np.asarray(jplan.w_grid))
    np.testing.assert_array_equal(plan.mask.numpy(), np.asarray(jplan.mask))
