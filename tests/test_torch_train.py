"""The port's GAN training slice against the JAX package, on the CPU.

Variables come from seeded numpy (``jax.eval_shape`` for the tree, as in
tests/test_torch_models.py) and are carried into the port with
``convert``; random draws (distance indices, GP alphas) are recomputed
from the JAX key here and handed to the port.  The JAX side runs compiled
on its ``xla`` FFT backend (its default off the TPU); the port's 32 x 32
padded grids take the fused path, K1's and K2's plain versions.

Tolerances, with their reasons:
  * losses, metrics, the penalty: float32 rounding of convs and
    reductions, rtol 1e-5 (1e-4 where a value sums ~1e3 terms);
  * the train step: FFT propagation (<= 1e-3 at p99.9, the propagation
    bound of tests/test_torch_ops.py) upstream of every loss, so losses
    agree to 2e-3 relative and gradients to 1e-2 of the largest |g| of
    their network (a conv bias feeding a train-mode BatchNorm has a
    gradient of exactly 0, rounding noise on both sides).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learned_hologram_gan_tpu import losses as jlosses
from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import LossConfig as JaxLossConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.train import steps as jsteps
from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
from learned_hologram_gan_tpu_torch import convert, losses
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, LossConfig
from learned_hologram_gan_tpu_torch.models import Generator, make_generator_plan
from learned_hologram_gan_tpu_torch.models.discriminator import WGANGPDiscriminator192
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.train import steps
from learned_hologram_gan_tpu_torch.train.state import TrainState
from test_torch_models import _critic_pair, assert_stats_close, batch_stats_of, jax_variables, to_jax

HW = 16
PAD = 8  # a 32 x 32 padded grid: the port's fused path
DISTANCES = np.linspace(-4e-4, 0.0, 5)[:-1]
SMALL = dict(rows=HW, cols=HW, pad_size=PAD, filter_radius_coefficient=0.45,
             unet_base_features=2, distance=1e-3)


def test_gradient_penalty_matches_jax():
    """Same alpha, same carried critic: the penalty and its gradient in the
    critic's parameters, and no running-stat update."""
    jm, variables, m, _ = _critic_pair(23, hw=(16, 16))
    rng = np.random.default_rng(24)
    real = rng.random((2, 3, 16, 16)).astype(np.float32)
    fake = rng.random((2, 3, 16, 16)).astype(np.float32)
    alpha = rng.random((2, 1, 1, 1)).astype(np.float32)

    def jgp(params):
        return jsteps.gradient_penalty(jm, params, variables["batch_stats"] and to_jax(variables["batch_stats"]),
                                       jnp.asarray(real), jnp.asarray(fake), alpha=jnp.asarray(alpha))

    want, want_g = jax.jit(jax.value_and_grad(jgp))(to_jax(variables["params"]))
    m.train()
    before = batch_stats_of(m)
    gp = steps.gradient_penalty(m, torch.from_numpy(real), torch.from_numpy(fake), torch.from_numpy(alpha))
    gp.backward()
    np.testing.assert_allclose(float(gp.detach()), float(want), rtol=1e-4)
    want_g = convert.discriminator_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, want_g), "batch_stats": variables["batch_stats"]})
    # relative to the largest |g| of the net: a conv bias feeding a train-mode
    # BatchNorm has a gradient of exactly 0, here rounding noise on both sides
    scale = max(float(w.abs().max()) for w in want_g.values())
    for k, p in m.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # the last bias: not in the graph
        assert float((g - want_g[k]).abs().max()) <= 1e-4 * scale, k
    for k, (mean, var) in batch_stats_of(m).items():
        np.testing.assert_array_equal(mean, before[k][0])


# ---------------------------------------------------------------------------
# Losses and metrics
# ---------------------------------------------------------------------------


LOSS_FNS = ["total_variation", "total_variation_for_poh", "total_variation_loss", "mse",
            "amp_loss", "amp_phs_loss", "focal_freq_loss", "focal_sincos_phase_gradient_loss",
            "phase_sincos_gradient_loss", "focal_sincos_phase_loss", "plain_phase_loss"]


@pytest.mark.parametrize("name", LOSS_FNS)
def test_loss_matches_jax_with_gradient(name):
    rng = np.random.default_rng(25)
    shape = (2, 3, 9, 11)
    args = [rng.random(shape).astype(np.float32) * 3 for _ in range(4)]
    arity = {"total_variation": 1, "total_variation_for_poh": 1, "amp_phs_loss": 4}.get(name, 2)
    args = args[:arity]
    jfn, fn = getattr(jlosses, name), getattr(losses, name)
    want, want_g = jax.jit(jax.value_and_grad(jfn))(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = fn(*t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t[0].grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-7)


def test_phase_loss_table_matches_jax():
    assert set(losses.PHASE_LOSSES) == set(jlosses.PHASE_LOSSES)
    for k, fn in losses.PHASE_LOSSES.items():
        assert fn.__name__ == jlosses.PHASE_LOSSES[k].__name__


@pytest.mark.parametrize("plane_chunk", [None, 4])
def test_psnr_ssim_match_jax(plane_chunk):
    rng = np.random.default_rng(26)
    a = rng.random((3, 3, 24, 20)).astype(np.float32) + 2.0
    b = (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
    np.testing.assert_allclose(float(losses.psnr(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    want = float(jlosses.ssim(jnp.asarray(a), jnp.asarray(b), plane_chunk=plane_chunk))
    got = float(losses.ssim(torch.from_numpy(a), torch.from_numpy(b), plane_chunk=plane_chunk))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert float(losses.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-6)


@pytest.fixture(scope="module")
def vgg_carried():
    """VGG19 variables from seeded numpy, in both packages."""
    x = jnp.zeros((1, 3, 16, 16), jnp.float32)
    variables = jax_variables(jlosses.VGG19Features(), x, seed=27)
    vgg = losses.make_vgg19(convert.vgg19_state_dict(variables["params"]), "cpu")
    return variables["params"], vgg


def test_perceptual_loss_matches_jax(vgg_carried):
    jparams, vgg = vgg_carried
    rng = np.random.default_rng(28)
    hat = rng.random((2, 3, 16, 16)).astype(np.float32)
    tgt = rng.random((2, 3, 16, 16)).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda h: jlosses.perceptual_loss(to_jax(jparams), h, jnp.asarray(tgt))))(jnp.asarray(hat))
    h = torch.from_numpy(hat).requires_grad_(True)
    got = losses.perceptual_loss(vgg, h, torch.from_numpy(tgt))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    scale = np.abs(np.asarray(want_g)).max()
    assert np.abs(h.grad.numpy() - np.asarray(want_g)).max() <= 1e-4 * scale


def test_vgg19_npz_and_modes(tmp_path, vgg_carried):
    jparams, vgg = vgg_carried
    npz = {}
    for k, v in jparams.items():
        npz[f"{k}_kernel"], npz[f"{k}_bias"] = v["kernel"], v["bias"]
    np.savez(tmp_path / "vgg.npz", **npz)
    sd, pretrained = losses.load_vgg19_params(str(tmp_path / "vgg.npz"))
    assert pretrained and set(sd) == set(vgg.state_dict())
    for k, v in vgg.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="--perceptual random"):
        losses.load_vgg19_params(str(tmp_path / "missing.npz"))
    sd_a, pre = losses.load_vgg19_params(mode="random")
    sd_b, _ = losses.load_vgg19_params(mode="random")
    assert not pre and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    with pytest.raises(ValueError):
        losses.load_vgg19_params(mode="alexnet")


# ---------------------------------------------------------------------------
# One train step and the eval step, against JAX
# ---------------------------------------------------------------------------

RATIO = 2
LR_G, LR_D = 1.0, 1e-4  # SGD: the update reads back the gradient


@pytest.fixture(scope="module")
def carried_state(vgg_carried):
    """JAX and port train states on the same carried weights, SGD optimizers
    (so a step's update is lr * gradient), a batch and the JAX draws."""
    jparams_vgg, vgg = vgg_carried
    jcfg = JaxGenConfig(**SMALL)
    jplan = jax_gen_plan(jcfg)
    jmulti = jasm.make_plan(jcfg.optics(), distances=DISTANCES)
    rng = np.random.default_rng(30)
    batch = (rng.random((2, 4, HW, HW)).astype(np.float32),
             rng.random((2, 3, HW, HW)).astype(np.float32),
             rng.random((2, 3, HW, HW)).astype(np.float32))
    jgen, jcritic = JaxGenerator(jcfg), JaxCritic(feature_d=2)
    vg = jax_variables(jgen, jplan, jnp.asarray(batch[0][:1]), train=False, seed=31)
    vd = jax_variables(jcritic, jnp.asarray(batch[1][:1]), train=False, seed=32)
    tx_G, tx_D = optax.sgd(LR_G), optax.sgd(LR_D)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), key=jax.random.key(33),
        params_G=to_jax(vg["params"]), batch_stats_G=to_jax(vg["batch_stats"]),
        params_D=to_jax(vd["params"]), batch_stats_D=to_jax(vd["batch_stats"]),
        opt_state_G=tx_G.init(to_jax(vg["params"])), opt_state_D=tx_D.init(to_jax(vd["params"])),
        vgg_params=to_jax(jparams_vgg),
    )
    # the train step's draws, recomputed from its key
    _, dist_key, gp_base = jax.random.split(jstate.key, 3)
    idx = np.asarray(jax.random.permutation(dist_key, len(DISTANCES))[:2])
    alphas = np.stack([np.asarray(jax.random.uniform(k, (2, 1, 1, 1)))
                       for k in jax.random.split(gp_base, RATIO)])
    return dict(jgen=jgen, jcritic=jcritic, jplan=jplan, jmulti=jmulti, jstate=jstate,
                tx=(tx_G, tx_D), vg=vg, vd=vd, vgg=vgg, batch=batch, idx=idx, alphas=alphas)


def _port_state(c):
    g = Generator(GeneratorConfig(**SMALL))
    g.load_state_dict(convert.generator_state_dict(c["vg"]))
    d = WGANGPDiscriminator192(2)
    d.load_state_dict(convert.discriminator_state_dict(c["vd"]))
    return TrainState(step=0, generator=g.train(), discriminator=d.train(),
                      opt_G=torch.optim.SGD(g.parameters(), lr=LR_G),
                      opt_D=torch.optim.SGD(d.parameters(), lr=LR_D),
                      rng=torch.Generator().manual_seed(0), vgg=c["vgg"])


LOSS_CFG = dict(perceptual_loss_weight=0.1, discriminator_loss_weight=0.1, perceptual="none")  # VGG: its own tests above


def step_against_jax(c, **options):
    """One GAN step (ratio 2, VGG on carried weights) with
    ``build_train_step``'s ``options`` in both packages, from the carried
    state ``c``: the metrics, the G and D gradients (read back from SGD
    updates) and both nets' batch_stats.  The JAX update, carried back with
    ``convert``, names exactly the port's state_dict entries."""
    jstep = jsteps.build_train_step(
        c["jgen"], c["jcritic"], *c["tx"], JaxLossConfig(**LOSS_CFG), use_gan=True,
        discriminator_train_ratio=RATIO, discriminator_lambda=10.0, **options)
    jstate = jax.tree_util.tree_map(jnp.copy, c["jstate"])  # the step donates its state
    jnew, jm = jstep(jstate, tuple(map(jnp.asarray, c["batch"])), c["jplan"], c["jmulti"])

    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    multi = asm.make_plan(GeneratorConfig(**SMALL).optics(), distances=DISTANCES, device="cpu")
    assert asm._fused_ok(plan) and asm._fused_ok(multi)
    state = _port_state(c)
    old_g = {k: v.detach().clone() for k, v in state.generator.named_parameters()}
    old_d = {k: v.detach().clone() for k, v in state.discriminator.named_parameters()}
    step = steps.build_train_step(LossConfig(**LOSS_CFG), True, RATIO, 10.0, **options)
    batch = tuple(torch.from_numpy(a) for a in c["batch"])
    state, m = step(state, batch, plan, multi, idx=torch.from_numpy(c["idx"]),
                    alphas=torch.from_numpy(c["alphas"]))

    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)

    for net, old, jold, jnew_p, lr in (
        (state.generator, old_g, c["vg"]["params"], jnew.params_G, LR_G),
        (state.discriminator, old_d, c["vd"]["params"], jnew.params_D, LR_D),
    ):
        conv = convert.generator_state_dict if net is state.generator else convert.discriminator_state_dict
        jdelta = conv({"params": jax.tree_util.tree_map(
            lambda a, b: (np.asarray(a) - np.asarray(b)) / lr, jold, jnew_p),
            "batch_stats": c["vg" if net is state.generator else "vd"]["batch_stats"]})
        assert set(jdelta) == set(net.state_dict())
        scale = max(float(jdelta[k].abs().max()) for k, _ in net.named_parameters())
        for k, p in net.named_parameters():
            got = (old[k] - p.detach()) / lr
            assert float((got - jdelta[k]).abs().max()) <= 1e-2 * scale, k
    assert_stats_close(state.generator, jnew.batch_stats_G, rtol=1e-4, atol=1e-5)
    assert_stats_close(state.discriminator, jnew.batch_stats_D, rtol=1e-4, atol=1e-5)


def test_train_step_matches_jax(carried_state):
    """One GAN step with pair batching, the composed reconstruction."""
    step_against_jax(carried_state)


def test_eval_step_matches_jax(carried_state):
    c = carried_state
    jeval = jsteps.build_eval_step(c["jgen"], c["jcritic"], JaxLossConfig(**LOSS_CFG))
    jm = jeval(c["jstate"], tuple(map(jnp.asarray, c["batch"])), c["jplan"], c["jmulti"])
    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    multi = asm.make_plan(GeneratorConfig(**SMALL).optics(), distances=DISTANCES, device="cpu")
    state = _port_state(c)
    m = steps.build_eval_step(LossConfig(**LOSS_CFG))(
        state, tuple(torch.from_numpy(a) for a in c["batch"]), plan, multi)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-3, atol=1e-6, err_msg=k)
