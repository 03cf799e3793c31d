"""bfloat16 (``dtype="bfloat16"``) in the port against the JAX package, on
the CPU: the UNet, the generator's POH, the fused eval path, the critic, one
GAN train step and K5's plain version, all in bfloat16 from the same seeded
numpy inputs and weights carried across with ``convert``; and a dtype probe
that bfloat16 really runs where the JAX package runs it and float32 where it
does not.

Both sides follow flax's dtype rules: float32 parameters, every conv's
input, kernel and bias cast to bfloat16 at the call, BatchNorm statistics
and normalization in float32 with one rounding.  Single ops agree exactly
(a bfloat16 conv, its bias add, a BatchNorm in either mode).  Whole nets do
not: XLA keeps excess precision inside its fusions (``xla_allow_excess_
precision``, on by default), so where the port rounds a conv output to
bfloat16 before the BatchNorm, as flax's nominal rule says, the JAX side
may not, and the two differ by one bfloat16 ulp there and by what that
ulp grows into downstream.

Bounds.  u = 2^-8 is bfloat16's unit roundoff (8 significant bits, round to
nearest), the most a single rounding moves a value, relative to it.  Where
the JAX package states a bfloat16 bound it is used as it is: 2e-2 for the
UNet, plain and fused, and 5e-2 for the POH (tests/test_fused_unet.py:49,
:83, :122).  Where it states none, the bound is n * u relative to the
largest value, n the number of roundings on the longest path, each
assumed to carry its full u to the output (a gain of at most one per
normalized layer): written beside each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import LossConfig as JaxLossConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic
from learned_hologram_gan_tpu.models import generator_apply_fused as jax_generator_apply_fused
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.nn import blocks as jblocks
from learned_hologram_gan_tpu.nn.fused_unet import unet_apply_fused as jax_unet_apply_fused
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.ops.pallas import conv_block as jcb
from learned_hologram_gan_tpu.train import steps as jsteps
from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, LossConfig
from learned_hologram_gan_tpu_torch.models import (
    Generator,
    generator_apply_fused,
    make_generator_plan,
)
from learned_hologram_gan_tpu_torch.models.discriminator import WGANGPDiscriminator192
from learned_hologram_gan_tpu_torch.nn import blocks, fused_unet
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.ops.cuda import conv_block as cb
from learned_hologram_gan_tpu_torch.ops.cuda import spectral
from learned_hologram_gan_tpu_torch.train import steps
from learned_hologram_gan_tpu_torch.train.state import TrainState
from test_torch_models import (
    assert_stats_close,
    jax_apply,
    jax_variables,
    to_jax,
)
from test_torch_train import DISTANCES, HW, LOSS_CFG, SMALL as TRAIN_SMALL, vgg_carried  # noqa: F401

BF16 = jnp.bfloat16
U = 2.0**-8
# the JAX package's own bfloat16 gates (tests/test_fused_unet.py:49, :83, :122)
UNET_TOL, POH_TOL = 2e-2, 5e-2
GEN_SMALL = dict(rows=32, cols=32, pad_size=16, filter_radius_coefficient=0.45,
                 unet_base_features=4, distance=1e-3)


def nchw(x):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2)


def _unet_pair(levels, seed):
    size = 16 if levels == 2 else 32
    x = np.random.default_rng(seed).random((2, size, size, 4)).astype(np.float32)
    jm = jblocks.UNet(output_channels=6, base_features=4, levels=levels, dtype=BF16)
    variables = jax_variables(jm, jnp.asarray(x), train=False, seed=seed)
    m = blocks.UNet(4, 6, 4, levels, dtype=torch.bfloat16).eval()
    m.load_state_dict(convert.generator_state_dict(variables))
    return jm, variables, m, x


@pytest.mark.parametrize("levels", [2, 4])
def test_unet_bf16_matches_jax(levels):
    """The eval-mode UNet in bfloat16, module path: the JAX gate 2e-2."""
    jm, variables, m, x = _unet_pair(levels, seed=61)
    want = np.asarray(jax_apply(jm, variables, jnp.asarray(x), train=False), np.float32)
    with torch.no_grad():
        got = m(nchw(x))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=UNET_TOL, atol=UNET_TOL)
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("polyphase_level0", [False, True], ids=["plain", "polyphase"])
@pytest.mark.parametrize("levels", [2, 4])
def test_unet_fused_bf16_matches_jax(levels, polyphase_level0):
    """unet_apply_fused in bfloat16 (K5's plain version here) against the
    JAX fused function and the port's own module path: the JAX gate 2e-2."""
    jm, variables, m, x = _unet_pair(levels, seed=62)
    xb = jnp.asarray(x, BF16)
    want = np.asarray(jax.jit(lambda v, a: jax_unet_apply_fused(
        v["params"], v["batch_stats"], a, polyphase_level0=polyphase_level0))(
            to_jax(variables), xb), np.float32)
    before = cb.fused_residual_block.launches
    got = fused_unet.unet_apply_fused(m, torch.from_numpy(x).bfloat16(),
                                      polyphase_level0=polyphase_level0)
    assert cb.fused_residual_block.launches == before  # the plain version on the CPU
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=UNET_TOL, atol=UNET_TOL)
    with torch.no_grad():
        module = m(nchw(x)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, module, rtol=UNET_TOL, atol=UNET_TOL)


def _poh_err(got, want):
    """|exp(i got) - exp(i want)| / (1 + |want|): the JAX gate
    |got - want| <= tol * (1 + |want|) on phases, wrap-free."""
    d = np.abs(np.exp(1j * np.asarray(got, np.float64)) - np.exp(1j * np.asarray(want, np.float64)))
    return float((d / (1.0 + np.abs(want))).max())


@pytest.fixture(scope="module")
def generators():
    cfg = dict(GEN_SMALL, dtype="bfloat16")
    jgen = JaxGenerator(JaxGenConfig(**cfg))
    jplan = jax_gen_plan(JaxGenConfig(**cfg))
    rgbd = np.random.default_rng(63).random((2, 4, 32, 32)).astype(np.float32)
    variables = jax_variables(jgen, jplan, jnp.asarray(rgbd), train=False, seed=63)
    g = Generator(GeneratorConfig(**cfg)).eval()
    g.load_state_dict(convert.generator_state_dict(variables))
    plan = make_generator_plan(GeneratorConfig(**cfg), device="cpu")
    return jgen, jplan, variables, g, plan, rgbd


def test_generator_poh_bf16_matches_jax(generators):
    """The bfloat16 generator's POH, module path and fused path (plain and
    polyphase), against JAX's: the JAX gate 5e-2."""
    jgen, jplan, variables, g, plan, rgbd = generators
    want = np.asarray(jax_apply(jgen, variables, jplan, jnp.asarray(rgbd), train=False))
    jfused = np.asarray(jax.jit(lambda v, p, r: jax_generator_apply_fused(jgen, v, p, r))(
        to_jax(variables), jplan, jnp.asarray(rgbd)))
    with torch.no_grad():
        got = g(plan, torch.from_numpy(rgbd))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _poh_err(got.numpy(), want) <= POH_TOL
    for poly in (False, True):
        fused = generator_apply_fused(g, plan, torch.from_numpy(rgbd), polyphase_level0=poly)
        assert fused.dtype == torch.float32
        assert _poh_err(fused.numpy(), jfused) <= POH_TOL
        assert _poh_err(fused.numpy(), got.numpy()) <= POH_TOL


# The critic: 7 convs (output and bias add rounded: 2 each), 5 BatchNorms
# (1 each), 6 LeakyReLUs (0.2 x rounded: 1 each), n = 25 roundings on the
# path, so |port - JAX| <= 25 u = 9.8e-2 of max |score|.  Train-mode batch
# statistics reduce in float32 from the bfloat16 conv outputs, which differ
# by the same roundings upstream: a mean moves by at most n u of max |x| of
# its layer, the running mean by momentum 0.01 times that: rtol 1e-3 plus
# atol 25 u * 0.01 * max|x| (max|x| ~ 4 here) = 4e-3.
CRITIC_TOL, STATS_RTOL, STATS_ATOL = 25 * U, 1e-3, 4e-3


@pytest.mark.parametrize("hw", [(20, 22), (21, 17)], ids=["even", "odd"])
def test_critic_bf16_matches_jax_eval_and_train(hw):
    rng = np.random.default_rng(64)
    x = rng.random((3, 3) + hw).astype(np.float32)
    jm = JaxCritic(feature_d=2, dtype=BF16)
    variables = jax_variables(jm, jnp.asarray(x), train=False, seed=64)
    m = WGANGPDiscriminator192(2, dtype="bfloat16")
    m.load_state_dict(convert.discriminator_state_dict(variables))
    want = np.asarray(jax_apply(jm, variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= CRITIC_TOL * np.abs(want).max()

    want, mut = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = m.train()(torch.from_numpy(x))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= CRITIC_TOL * np.abs(want).max()
    assert_stats_close(m, mut["batch_stats"], rtol=STATS_RTOL, atol=STATS_ATOL)


# ---------------------------------------------------------------------------
# K5's plain version in bfloat16
# ---------------------------------------------------------------------------

# The plain version against JAX's residual_block_reference, both bfloat16:
# the same roundings in the same places (conv output, bias add, ReLU, sum),
# so they differ only where a float32 accumulation order flips a rounding,
# one ulp, which conv2 carries to the output: 2 u of max |out|.  Against
# the JAX kernel in interpret mode, which rounds only y1 and the output (as
# K5 does), the plain version's 7 roundings count: 7 u.
K5_PLAIN_TOL, K5_KERNEL_TOL = 2 * U, 7 * U


@pytest.mark.parametrize("cin,cout", [(4, 8), (8, 8)])
def test_residual_block_bf16_plain_matches_jax(cin, cout):
    rng = np.random.default_rng(65)

    def draw(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    x = np.abs(draw(2, 16, 16, cin)).astype(jnp.bfloat16).astype(np.float32)
    args = (draw(3, 3, cin, cout, scale=(9 * cin) ** -0.5), draw(cout, scale=0.1),
            draw(3, 3, cout, cout, scale=(9 * cout) ** -0.5), draw(cout, scale=0.1),
            draw(cin, cout, scale=cin ** -0.5), draw(cout, scale=0.1))
    xb = jnp.asarray(x, BF16)
    want = np.asarray(jax.jit(jcb.residual_block_reference)(xb, *map(jnp.asarray, args)), np.float32)
    kernel = np.asarray(jcb.fused_residual_block(xb, *map(jnp.asarray, args)), np.float32)
    got = cb.fused_residual_block(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, args))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= K5_PLAIN_TOL * scale
    assert np.abs(got - kernel).max() <= K5_KERNEL_TOL * scale


# ---------------------------------------------------------------------------
# One bfloat16 GAN train step against JAX, with the dtype probe
# ---------------------------------------------------------------------------

RATIO = 2
# SGD, so that the update reads back the gradient.  The critic's rate is
# small enough that its first update moves the second's batch statistics
# by nothing the statistics bound sees: the penalty's gradients reach ~4e3,
# their bfloat16 departure 68 u of that (below), 1e-6 times which is 1e-3
# in a parameter.
LR_G, LR_D = 1.0, 1e-6


def _jax_step(dtype, vg, vd, vgg_params, batch, loss_cfg, **options):
    """One JAX GAN step in ``dtype`` from the carried variables, with
    ``build_train_step``'s ``options``; returns the new state, the metrics
    and the draws recomputed from its key."""
    jcfg = JaxGenConfig(**TRAIN_SMALL, dtype=dtype)
    jplan, jmulti = jax_gen_plan(jcfg), jasm.make_plan(jcfg.optics(), distances=DISTANCES)
    jgen = JaxGenerator(jcfg)
    jcritic = JaxCritic(feature_d=2, dtype=BF16 if dtype == "bfloat16" else jnp.float32)
    tx_G, tx_D = optax.sgd(LR_G), optax.sgd(LR_D)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), key=jax.random.key(69),
        params_G=to_jax(vg["params"]), batch_stats_G=to_jax(vg["batch_stats"]),
        params_D=to_jax(vd["params"]), batch_stats_D=to_jax(vd["batch_stats"]),
        opt_state_G=tx_G.init(to_jax(vg["params"])), opt_state_D=tx_D.init(to_jax(vd["params"])),
        vgg_params=to_jax(vgg_params),
    )
    _, dist_key, gp_base = jax.random.split(jstate.key, 3)
    idx = np.asarray(jax.random.permutation(dist_key, len(DISTANCES))[:2])
    alphas = np.stack([np.asarray(jax.random.uniform(k, (2, 1, 1, 1)))
                       for k in jax.random.split(gp_base, RATIO)])
    jstep = jsteps.build_train_step(jgen, jcritic, tx_G, tx_D, JaxLossConfig(**loss_cfg),
                                    use_gan=True, discriminator_train_ratio=RATIO,
                                    discriminator_lambda=10.0, **options)
    jnew, jm = jstep(jstate, tuple(map(jnp.asarray, batch)), jplan, jmulti)
    return jnew, jm, idx, alphas


def _updates(net_variables, new_params, lr, conv):
    """(old - new) / lr of a JAX SGD step, as the port's state_dict keys."""
    return conv({"params": jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a) - np.asarray(b)) / lr, net_variables["params"], new_params),
        "batch_stats": net_variables["batch_stats"]})


def jax_generator_vjp(vg, rgbd, cotangent):
    """The gradient of <POH, ``cotangent``> in the generator's parameters,
    from JAX's bfloat16 generator in train mode (batch statistics), compiled
    with XLA's excess precision off so that it rounds where flax's dtype
    rule says, as the port does; as the port's state_dict keys (running
    statistics included, as they were)."""
    jcfg = JaxGenConfig(**TRAIN_SMALL, dtype="bfloat16")
    jgen, jplan = JaxGenerator(jcfg), jax_gen_plan(jcfg)
    ct, x = jnp.asarray(np.asarray(cotangent)), jnp.asarray(np.asarray(rgbd))

    def inner(params):
        poh, _ = jgen.apply({"params": params, "batch_stats": to_jax(vg["batch_stats"])}, jplan, x,
                            True, mutable=["batch_stats"])
        return (poh * ct).sum()

    params = to_jax(vg["params"])
    nominal = jax.jit(jax.grad(inner)).lower(params).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return convert.generator_state_dict({"params": jax.tree_util.tree_map(np.asarray, nominal(params)),
                                         "batch_stats": vg["batch_stats"]})


def pre_norm_biases(net):
    """The names of the conv biases that feed a train-mode BatchNorm (each
    residual block's Conv_0 and Conv_1): their exact gradient is 0."""
    return {f"{name}.{conv}.bias" for name, m in net.named_modules()
            if isinstance(m, blocks.ResidualBlock) for conv in ("Conv_0", "Conv_1")}


def assert_generator_grads_close(generator, got, want, tol):
    """The port's bfloat16 generator gradients ``got`` against JAX's ``want``
    (:func:`jax_generator_vjp`), within ``tol`` of the largest |want| over
    the parameters.  A conv bias in front of a train-mode BatchNorm is held
    to its exact gradient, 0, instead: JAX's nominal-rounding compile sums
    it in bfloat16, so its value there is that sum's rounding noise."""
    zero = pre_norm_biases(generator)
    scale = max(float(want[k].abs().max()) for k in got)
    for k in got:
        ref = torch.zeros_like(got[k]) if k in zero else want[k]
        assert float((got[k] - ref).abs().max()) <= tol * scale, k


def poh_cotangent_hook(generator, store):
    """A forward hook on ``generator`` that appends the gradient its POH
    receives in the backward to ``store``."""
    def hook(module, args, out):
        out.register_hook(lambda c: store.append(c.detach().clone()))

    return generator.register_forward_hook(hook)


@pytest.fixture(scope="module")
def bf16_state(vgg_carried):  # noqa: F811
    """One bfloat16 step in the port under the dtype probe, the same step in
    JAX in bfloat16 (losses, statistics) and in float32 (gradients)."""
    jparams_vgg, vgg = vgg_carried
    rng = np.random.default_rng(66)
    batch = (rng.random((2, 4, HW, HW)).astype(np.float32),
             rng.random((2, 3, HW, HW)).astype(np.float32),
             rng.random((2, 3, HW, HW)).astype(np.float32))
    jcfg = JaxGenConfig(**TRAIN_SMALL, dtype="bfloat16")
    vg = jax_variables(JaxGenerator(jcfg), jax_gen_plan(jcfg), jnp.asarray(batch[0][:1]),
                       train=False, seed=67)
    vd = jax_variables(JaxCritic(feature_d=2), jnp.asarray(batch[1][:1]), train=False, seed=68)
    loss_cfg = dict(LOSS_CFG, perceptual="random")
    jnew, jm, idx, alphas = _jax_step("bfloat16", vg, vd, jparams_vgg, batch, loss_cfg)
    jnew32, _, _, _ = _jax_step("float32", vg, vd, jparams_vgg, batch, loss_cfg)
    cfg = GeneratorConfig(**TRAIN_SMALL, dtype="bfloat16")
    g = Generator(cfg)
    g.load_state_dict(convert.generator_state_dict(vg))
    d = WGANGPDiscriminator192(2, dtype="bfloat16")
    d.load_state_dict(convert.discriminator_state_dict(vd))
    state = TrainState(step=0, generator=g.train(), discriminator=d.train(),
                       opt_G=torch.optim.SGD(g.parameters(), lr=LR_G),
                       opt_D=torch.optim.SGD(d.parameters(), lr=LR_D),
                       rng=torch.Generator().manual_seed(0), vgg=vgg)
    old = {name: {k: v.detach().clone() for k, v in net.named_parameters()}
           for name, net in (("G", g), ("D", d))}
    plan = make_generator_plan(cfg, device="cpu")
    multi = asm.make_plan(cfg.optics(), distances=DISTANCES, device="cpu")
    step = steps.build_train_step(LossConfig(**loss_cfg), True, RATIO, 10.0)

    convs, planes, scores = [], [], []
    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, blocks.ChannelWiseSymmetricConv)
    owner = {id(m): net for net, root in (("G", g), ("D", d), ("VGG", vgg))
             for m in root.modules() if isinstance(m, kinds)}

    def hook(module, args, out):
        if id(module) in owner:
            convs.append((owner[id(module)], out.dtype))
        if module is d:
            scores.append(float(out.detach().abs().max()))

    real = spectral.propagate_planes

    def probe(fr, fi, *rest):
        planes.append((fr.dtype, fi.dtype))
        return real(fr, fi, *rest)

    cotangent = []
    handles = [torch.nn.modules.module.register_module_forward_hook(hook),
               poh_cotangent_hook(g, cotangent)]
    spectral.propagate_planes = probe
    try:
        state, m = step(state, tuple(map(torch.from_numpy, batch)), plan, multi,
                        idx=torch.from_numpy(idx), alphas=torch.from_numpy(alphas))
    finally:
        for handle in handles:
            handle.remove()
        spectral.propagate_planes = real
    got = {name: {k: (old[name][k] - p.detach()) / lr for k, p in net.named_parameters()}
           for name, net, lr in (("G", g, LR_G), ("D", d, LR_D))}
    (cotangent,) = cotangent
    want = dict(G=jax_generator_vjp(vg, batch[0], cotangent),
                D=_updates(vd, jnew32.params_D, LR_D, convert.discriminator_state_dict))
    return dict(jnew=jnew, jm=jm, state=state, m=m, got=got, want=want,
                convs=convs, planes=planes, scores=scores)


def test_bf16_runs_where_jax_runs_it(bf16_state):
    """Every generator and critic conv computed in bfloat16, every VGG19
    conv and every propagation (K1's wrapper) in float32: bfloat16 is not
    silently float32, nor float32 silently bfloat16."""
    seen = {}
    for net, dtype in bf16_state["convs"]:
        seen.setdefault(net, set()).add(dtype)
    assert seen == {"G": {torch.bfloat16}, "D": {torch.bfloat16}, "VGG": {torch.float32}}
    assert bf16_state["planes"]
    assert set(bf16_state["planes"]) == {(torch.float32, torch.float32)}


# One step in bfloat16.  Metrics against JAX's bfloat16 step: every loss
# reads the reconstruction, whose amplitudes come from the POH through
# float32 propagation; the POH carries the UNet's bfloat16 roundings, 2e-2
# relative on each side (the JAX gate), and a loss averages their effect
# over its terms: rtol 2 * 2e-2, SSIM (near 0 here) atol 2 * 2e-2.  The
# critic's term, weight 0.1 times the mean of scores that nearly cancel,
# gets the critic bound on each side, absolute: 2 * 0.1 * 25 u * max |score|
# of its last call.  D_loss is the penalty's lambda * (n - 1)^2, n the
# norm of the critic's input gradient, which sums squares of many entries
# and so rounds like a loss (2e-2 a side); (n - 1)^2 amplifies that by
# 2 n / (n - 1), n from D_loss itself.
# The critic's gradients are held to JAX's float32 step's (the port's
# float32 gradients equal them to ~1e-7), relative to the net's largest
# |g| over its parameters.  Its gradient is the penalty's: the critic
# forward (25 roundings, as above), its backward to the input (18: each
# conv's, BatchNorm's and LeakyReLU's input gradient) and that backward's
# backward (25 again): 68 u.
# The generator's gradients are held to JAX's bfloat16 generator backward
# (:func:`jax_generator_vjp`, XLA's excess precision off) at the cotangent
# the port's step gave its POH, relative to the largest |g| over the
# parameters: 48 u, one rounding of each conv's input gradient and weight
# gradient on the longest path (the first conv lies behind the UNet's 24
# convs).  Not to the float32 step's: bfloat16's forward roundings, grown
# by the train-mode BatchNorm at batch 2, by acos near the normalized
# amplitude's maximum and by that maximum's argmax, move the generator's
# gradients from float32's by 156 u of max |g| here in the port and 109 u
# in JAX compiled without excess precision, and by 1414 u at another seed
# (tests/bf16_grad_survey.py).
# Batch statistics against JAX's bfloat16 step, as in the critic test.
STEP_LOSS_RTOL, STEP_GRAD_TOL = 2 * 2e-2, dict(G=48 * U, D=68 * U)


def test_train_step_bf16_matches_jax(bf16_state):
    c = bf16_state
    jm, m = c["jm"], c["m"]
    assert set(m) == set(jm)
    gan_atol = 2 * LOSS_CFG["discriminator_loss_weight"] * CRITIC_TOL * c["scores"][-1]
    n = 1.0 + np.sqrt(float(jm["D_loss"]) / 10.0)  # lambda 10; the penalty dominates D_loss
    for k in jm:
        rtol, atol = STEP_LOSS_RTOL, 1e-6
        if k in ("gan_loss", "G_loss"):
            atol = gan_atol
        elif k == "SSIM":
            rtol, atol = 0.0, STEP_LOSS_RTOL
        elif k == "D_loss":
            rtol = STEP_LOSS_RTOL * 2 * n / (n - 1)
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, atol=atol, err_msg=k)
    assert_generator_grads_close(c["state"].generator, c["got"]["G"], c["want"]["G"], STEP_GRAD_TOL["G"])
    want, got = c["want"]["D"], c["got"]["D"]
    scale = max(float(want[k].abs().max()) for k in got)  # the parameters' gradients alone
    for k in got:
        assert float((got[k] - want[k]).abs().max()) <= STEP_GRAD_TOL["D"] * scale, k
    state, jnew = c["state"], c["jnew"]
    assert_stats_close(state.generator, jnew.batch_stats_G, rtol=STATS_RTOL, atol=STATS_ATOL)
    assert_stats_close(state.discriminator, jnew.batch_stats_D, rtol=STATS_RTOL, atol=STATS_ATOL)
