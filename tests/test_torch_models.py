"""The port's generator and critic against the JAX package through carried
weights.

JAX variables are drawn from a seed with numpy, the constant-initialized
leaves (biases, BatchNorm scale and bias, batch_stats) included so that a
wrong mapping cannot hide behind zeros and ones, and
``convert.generator_state_dict`` carries them into the port.  The JAX side
runs compiled (``jax.jit``).

Tolerances: the UNet and the critic agree to float32 conv rounding (1e-5;
1e-4 for the critic in train mode, whose batch statistics sum ~1e3
terms).  The POH is a
phase, compared as phasors (a 2*pi wrap is the same SLM state); acos
amplifies upstream rounding by up to 1/sqrt(1 - A^2) ~ 7 at the normalized
maximum, so it gets the tests/test_parity_torch.py double-phase bounds.  The
focal stack gets the propagation bound (<= 1e-3 at p99.9, 4e-3 worst).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.nn import blocks as jblocks
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig
from learned_hologram_gan_tpu_torch.models import (
    Generator,
    double_phase_encode,
    make_generator,
    make_generator_plan,
)
from learned_hologram_gan_tpu_torch.models.discriminator import WGANGPDiscriminator192
from learned_hologram_gan_tpu_torch.nn import blocks
from learned_hologram_gan_tpu_torch.ops import asm

SMALL = dict(rows=32, cols=32, pad_size=16, filter_radius_coefficient=0.45,
             unet_base_features=4, distance=1e-3)


def _fill(tree, rng):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = _fill(value, rng)
            continue
        shape = value.shape
        if key == "kernel":  # HWIO: Xavier-scaled normal, the JAX package's scale
            rf = int(np.prod(shape[:-2]))
            a = rng.normal(0.0, np.sqrt(2.0 / (rf * (shape[-2] + shape[-1]))), shape)
        elif key == "radial_weights":
            a = np.abs(rng.normal(0.0, 1.0, shape))
        elif key in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key in ("bias", "mean"):
            a = rng.normal(0.0, 0.1, shape)
        else:
            raise KeyError(f"no fill for variable {key!r}")
        out[key] = a.astype(np.float32)
    return out


def jax_variables(module, *args, seed=0, **kwargs):
    """Seeded numpy variables with the tree ``module.init`` would give.

    Only the shapes come from flax (``jax.eval_shape``; running init costs
    seconds of compilation).  Every leaf that init leaves constant (biases,
    BatchNorm scale and bias, batch_stats) gets seeded noise too, so that a
    wrong mapping cannot hide behind zeros and ones.
    """
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs), jax.random.key(seed), *args)
    rng = np.random.default_rng(seed + 100)
    return {k: _fill(v, rng) for k, v in shapes.items()}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_apply(module, variables, *args, **kwargs):
    """``module.apply`` compiled once (a fresh function, so nothing traced
    under another FFT backend is reused)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(to_jax(variables), *args)


def test_up_conv_delta_probe():
    """lax.conv_transpose flips the taps: a delta through the 2x2 kernel
    arange(4) gives [[3, 2], [1, 0]] (nn/blocks.py:284-287).  The carried
    torch weight must give the same."""
    kernel = np.arange(4, dtype=np.float32).reshape(2, 2, 1, 1)
    delta = np.ones((1, 1, 1, 1), np.float32)
    jax_out = jblocks.PixelShuffleConvTranspose(1).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.zeros(1)}},
        jnp.asarray(delta),
    )
    np.testing.assert_array_equal(np.asarray(jax_out)[0, :, :, 0], [[3, 2], [1, 0]])

    up = blocks.PixelShuffleConvTranspose(1, 1)
    with torch.no_grad():
        up.weight.copy_(convert.conv_transpose_kernel(kernel))
        up.bias.zero_()
        got = up(torch.from_numpy(delta))
    np.testing.assert_array_equal(got.numpy()[0, 0], [[3, 2], [1, 0]])


def test_up_conv_matches_jax_multichannel():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)  # NHWC
    variables = jax_variables(jblocks.PixelShuffleConvTranspose(4), jnp.asarray(x))
    want = np.asarray(jax_apply(jblocks.PixelShuffleConvTranspose(4), variables, jnp.asarray(x)))
    up = blocks.PixelShuffleConvTranspose(3, 4)
    with torch.no_grad():
        up.weight.copy_(convert.conv_transpose_kernel(variables["params"]["kernel"]))
        up.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_1x1conv", [True, False])
def test_residual_block_matches_jax_eval(use_1x1conv):
    rng = np.random.default_rng(2)
    cin = 3 if use_1x1conv else 8
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    jm = jblocks.ResidualBlock(8, use_1x1conv=use_1x1conv)
    variables = jax_variables(jm, jnp.asarray(x), train=False)
    want = np.asarray(jax_apply(jm, variables, jnp.asarray(x), train=False))
    m = blocks.ResidualBlock(cin, 8, use_1x1conv=use_1x1conv).eval()
    m.load_state_dict(convert.generator_state_dict(variables))
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def carried():
    """JAX generator variables (randomized constants) and the port model
    holding the same weights, plus one seeded RGBD batch."""
    jcfg = JaxGenConfig(**SMALL)
    jplan = jax_gen_plan(jcfg)
    rgbd = np.random.default_rng(3).random((2, 4, 32, 32)).astype(np.float32)
    jgen = JaxGenerator(jcfg)
    variables = jax_variables(jgen, jplan, jnp.asarray(rgbd[:1]), train=False)
    model = Generator(GeneratorConfig(**SMALL)).eval()
    model.load_state_dict(convert.generator_state_dict(variables))
    return jgen, jplan, variables, model, rgbd


def test_weight_carry_is_complete(carried):
    _, _, variables, model, _ = carried
    sd = convert.generator_state_dict(variables)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(variables))
    n_port = sum(t.numel() for k, t in sd.items() if not k.endswith("num_batches_tracked"))
    assert n_jax == n_port


def test_rgbd2ap_matches_jax(carried):
    jgen, _, variables, model, rgbd = carried
    ja, jp = jax_apply(jgen, variables, jnp.asarray(rgbd), train=False, method=JaxGenerator.stage1)
    with torch.no_grad():
        a, p = model.part1(torch.from_numpy(rgbd))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=5e-5)


def assert_poh_close(got, want):
    d = np.abs(np.exp(1j * np.asarray(got, np.float64)) - np.exp(1j * np.asarray(want, np.float64)))
    assert np.mean(d) <= 2e-3, np.mean(d)
    assert np.quantile(d, 0.99) <= 1e-2, np.quantile(d, 0.99)
    assert np.max(d) <= 5e-2, np.max(d)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_slice_poh_and_focal_stack_match_jax(carried, backend):
    """RGBD -> POH -> 3-plane focal stack, end to end, through carried
    weights.  The port runs fused (64 x 64 padded grid): K1's plain version
    on the CPU."""
    jgen, jplan, variables, model, rgbd = carried
    distances = np.linspace(4e-4, 1e-3, 3)
    prev = jasm.get_fft_backend()
    try:
        jasm.set_fft_backend(backend)
        jpoh = jax_apply(jgen, variables, jplan, jnp.asarray(rgbd), train=False)
        jrecon = jasm.make_plan(JaxGenConfig(**SMALL).optics(), distances=distances)
        jstack = np.asarray(jax.jit(
            lambda plan, p: jasm.propagate_batch_multi(plan, jnp.ones_like(p), p)
        )(jrecon, jpoh))
    finally:
        jasm.set_fft_backend(prev)

    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    recon = asm.make_plan(GeneratorConfig(**SMALL).optics(), distances=distances, device="cpu")
    assert asm._fused_ok(plan) and asm._fused_ok(recon)
    with torch.inference_mode():
        poh = model(plan, torch.from_numpy(rgbd))
        stack = asm.propagate_batch_multi(recon, torch.ones_like(poh), poh)
    assert tuple(poh.shape) == (2, 3, 32, 32)
    assert tuple(stack.shape) == jstack.shape == (6, 3, 32, 32)
    assert_poh_close(poh.numpy(), np.asarray(jpoh))
    d = np.abs(stack.numpy() - jstack)
    assert np.quantile(d, 0.999) <= 1e-3 and np.max(d) <= 4e-3


def test_double_phase_encode_matches_jax():
    from learned_hologram_gan_tpu.models import double_phase_encode as jdpe

    rng = np.random.default_rng(4)
    amp = (rng.random((2, 3, 8, 10)) * 0.99).astype(np.float32)
    phs = (rng.random((2, 3, 8, 10)) * 2 * np.pi - np.pi).astype(np.float32)
    want = np.asarray(jdpe(jnp.asarray(amp), jnp.asarray(phs)))
    got = double_phase_encode(torch.from_numpy(amp), torch.from_numpy(phs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)


def test_random_init_follows_jax_scheme():
    """Seeded init is reproducible and has the JAX package's statistics:
    zero biases, unit BN scale, |N(0,1)| radial weights, Xavier-scaled
    conv kernels."""
    cfg = GeneratorConfig(**SMALL)
    a = make_generator(cfg, seed=5, device="cpu")
    b = make_generator(cfg, seed=5, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    sd = a.state_dict()
    assert torch.all(sd["part1.unet.enc_0.BatchNorm_0.weight"] == 1)
    assert torch.all(sd["part1.unet.enc_0.Conv_0.bias"] == 0)
    assert torch.all(sd["part2.modulation.conv_r.radial_weights"] >= 0)
    w = sd["part1.unet.dec_0.Conv_1.weight"]  # 3x3, 4 -> 4 channels
    std = np.sqrt(2.0 / ((4 + 4) * 9))
    assert 0.5 * std < float(w.std()) < 1.5 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6


# ---------------------------------------------------------------------------
# BatchNorm in train mode (flax's statistics), the critic
# ---------------------------------------------------------------------------


def nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def batch_stats_of(module):
    """{path: (mean, var)} of every BatchNorm, flax-path keyed."""
    return {name: (m.running_mean.numpy().copy(), m.running_var.numpy().copy())
            for name, m in module.named_modules() if isinstance(m, blocks.BatchNorm)}


def flax_stats(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if "mean" in v:
            out[prefix + k] = (np.asarray(v["mean"]), np.asarray(v["var"]))
        else:
            out.update(flax_stats(v, prefix + k + "."))
    return out


def assert_stats_close(port_module, jax_tree, rtol=1e-5, atol=1e-6):
    got, want = batch_stats_of(port_module), flax_stats(jax_tree)
    assert set(got) == set(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


def test_residual_block_train_mode_updates_stats_as_flax():
    """Train mode: batch-statistics output and the running-stat update with
    the biased variance and momentum 0.99, against flax's mutable apply,
    from randomized batch_stats."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((3, 6, 6, 2)).astype(np.float32) * 2 + 0.5
    jm = jblocks.ResidualBlock(4, use_1x1conv=True)
    variables = jax_variables(jm, jnp.asarray(x), train=True)
    want, mut = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        to_jax(variables), jnp.asarray(x))
    m = blocks.ResidualBlock(2, 4, use_1x1conv=True).train()
    m.load_state_dict(convert.generator_state_dict(variables))
    got = m(nchw(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert_stats_close(m, mut["batch_stats"])
    # inside frozen_batch_stats the output is the same and nothing updates
    before = batch_stats_of(m)
    with blocks.frozen_batch_stats(m):
        again = m(nchw(x))
    torch.testing.assert_close(again, got)
    for k, (mean, var) in batch_stats_of(m).items():
        np.testing.assert_array_equal(mean, before[k][0])
        np.testing.assert_array_equal(var, before[k][1])


def _critic_pair(seed, feature_d=2, hw=(20, 22)):
    rng = np.random.default_rng(seed)
    x = rng.random((3, 3) + hw).astype(np.float32)
    jm = JaxCritic(feature_d=feature_d)
    variables = jax_variables(jm, jnp.asarray(x), train=False, seed=seed)
    m = WGANGPDiscriminator192(feature_d)
    m.load_state_dict(convert.discriminator_state_dict(variables))
    return jm, variables, m, x


@pytest.mark.parametrize("hw", [(20, 22), (21, 17)], ids=["even", "odd"])
def test_critic_matches_jax_eval_and_train(hw):
    """Eval mode (running stats) and train mode (batch stats, the stats
    update) on inputs whose sizes exercise flax's asymmetric SAME padding
    of the strided convs."""
    jm, variables, m, x = _critic_pair(21, hw=hw)
    want = np.asarray(jax_apply(jm, variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    want, mut = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = m.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert_stats_close(m, mut["batch_stats"])


def test_critic_weight_carry_is_complete():
    _, variables, m, _ = _critic_pair(22)
    sd = convert.discriminator_state_dict(variables)
    assert set(sd) == set(m.state_dict())
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(variables))
    assert n_jax == sum(t.numel() for k, t in sd.items() if not k.endswith("num_batches_tracked"))
    assert convert.discriminator_state_dict({"params": {"a": np.ones(1)}})["a"].shape == (1,)
