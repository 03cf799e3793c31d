"""Three float32 GAN train steps with ``torch.optim.Adam`` against
``optax.adam`` in the JAX package, with the (random, carried) VGG19
perceptual term on: the optimizer the trainers use, which the one-step
parity test (tests/test_torch_train.py) swaps for SGD.

Same carried weights, batches and draws (each step's distance permutation
and GP alphas recomputed from JAX's key, which each step splits as
``key, dist_key, gp_base = split(key, 3)``); both optimizers with their
defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square root).

The rate is 1e-4, not the trainer's 1e-3.  Adam moves an element by about
lr * sign(g) a step whatever |g| is, so an element whose gradient is
rounding noise (a conv bias feeding a train-mode BatchNorm has a gradient
of exactly 0; the critic's penalty gradients agree to ~1e-4 of their
largest) may move either way on either side.  At 1e-3 those moves make
the nets of the second step differ enough that its losses part by ~1e-2
(7.7e-3 measured), which says nothing of the optimizer; at 1e-4 they stay
below the one-step bounds.

Bounds.  Metrics, each step: 2e-3 relative, the one-step bound (FFT
propagation upstream of every loss).  Parameters after three steps, only
where |g| >= 1e-2 of the net's max |g| on the first step (the one-step
gradient bound, beyond which the sign is certain): there a gradient's
relative error is at most d = 1e-2 * max|g| / |g| <= 1.  Adam's update
lr * m / sqrt(v) (bias-corrected) moves by at most 2 d lr C, the 2 for m
and sqrt(v) each carrying d, and C = sqrt(sum a_t^2 / b_t) ~ 1.0 over three
steps (Cauchy-Schwarz, a_t and b_t the bias-corrected weights of g_t and
g_t^2); three updates: 6 d lr per element.  The update rule alone is held
to float32 rounding on identical gradients (``test_adam_rule_matches_optax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import LossConfig as JaxLossConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.train import steps as jsteps
from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, LossConfig
from learned_hologram_gan_tpu_torch.models import Generator, make_generator_plan
from learned_hologram_gan_tpu_torch.models.discriminator import WGANGPDiscriminator192
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.train import steps
from learned_hologram_gan_tpu_torch.train.state import TrainState
from test_torch_models import jax_variables, to_jax
from test_torch_train import DISTANCES, HW, LOSS_CFG, SMALL, vgg_carried  # noqa: F401

RATIO, STEPS, LR = 2, 3, 1e-4
METRIC_RTOL, GRAD_FLOOR = 2e-3, 1e-2


def test_adam_rule_matches_optax():
    """torch.optim.Adam and optax.adam on the same gradients, three steps,
    including gradients far below and far above eps: float32 rounding."""
    rng = np.random.default_rng(70)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [(rng.standard_normal(64) * 10.0 ** rng.uniform(-10, 2, 64)).astype(np.float32)
             for _ in range(STEPS)]
    tx = optax.adam(LR)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([tp], lr=LR)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_adam_steps_match_optax(vgg_carried):  # noqa: F811
    jparams_vgg, vgg = vgg_carried
    jcfg = JaxGenConfig(**SMALL)
    jplan, jmulti = jax_gen_plan(jcfg), jasm.make_plan(jcfg.optics(), distances=DISTANCES)
    rng = np.random.default_rng(71)
    batches = [tuple(rng.random((2, c, HW, HW)).astype(np.float32) for c in (4, 3, 3))
               for _ in range(STEPS)]
    jgen, jcritic = JaxGenerator(jcfg), JaxCritic(feature_d=2)
    vg = jax_variables(jgen, jplan, jnp.asarray(batches[0][0][:1]), train=False, seed=72)
    vd = jax_variables(jcritic, jnp.asarray(batches[0][1][:1]), train=False, seed=73)
    tx_G, tx_D = optax.adam(LR), optax.adam(LR)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), key=jax.random.key(74),
        params_G=to_jax(vg["params"]), batch_stats_G=to_jax(vg["batch_stats"]),
        params_D=to_jax(vd["params"]), batch_stats_D=to_jax(vd["batch_stats"]),
        opt_state_G=tx_G.init(to_jax(vg["params"])), opt_state_D=tx_D.init(to_jax(vd["params"])),
        vgg_params=to_jax(jparams_vgg),
    )
    loss_cfg = dict(LOSS_CFG, perceptual="random")
    jstep = jsteps.build_train_step(jgen, jcritic, tx_G, tx_D, JaxLossConfig(**loss_cfg), use_gan=True,
                                    discriminator_train_ratio=RATIO, discriminator_lambda=10.0)

    cfg = GeneratorConfig(**SMALL)
    g = Generator(cfg)
    g.load_state_dict(convert.generator_state_dict(vg))
    d = WGANGPDiscriminator192(2)
    d.load_state_dict(convert.discriminator_state_dict(vd))
    state = TrainState(step=0, generator=g.train(), discriminator=d.train(),
                       opt_G=torch.optim.Adam(g.parameters(), lr=LR),
                       opt_D=torch.optim.Adam(d.parameters(), lr=LR),
                       rng=torch.Generator().manual_seed(0), vgg=vgg)
    plan = make_generator_plan(cfg, device="cpu")
    multi = asm.make_plan(cfg.optics(), distances=DISTANCES, device="cpu")
    step = steps.build_train_step(LossConfig(**loss_cfg), True, RATIO, 10.0)

    key = jstate.key
    first_grads = None
    for batch in batches:
        key, dist_key, gp_base = jax.random.split(key, 3)
        idx = np.asarray(jax.random.permutation(dist_key, len(DISTANCES))[:2])
        alphas = np.stack([np.asarray(jax.random.uniform(k, (2, 1, 1, 1)))
                           for k in jax.random.split(gp_base, RATIO)])
        jstate, jm = jstep(jstate, tuple(map(jnp.asarray, batch)), jplan, jmulti)
        state, m = step(state, tuple(map(torch.from_numpy, batch)), plan, multi,
                        idx=torch.from_numpy(idx), alphas=torch.from_numpy(alphas))
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=METRIC_RTOL, atol=1e-6,
                                       err_msg=f"step {state.step}: {k}")
        if first_grads is None:  # the grads of the step's last update of each net
            first_grads = {net: {k: p.grad.detach().clone() for k, p in mod.named_parameters()
                                 if p.grad is not None}
                           for net, mod in (("G", g), ("D", d))}

    compared = 0
    for net, mod, jparams, conv in (
        ("G", g, jstate.params_G, convert.generator_state_dict),
        ("D", d, jstate.params_D, convert.discriminator_state_dict),
    ):
        stats = vg["batch_stats"] if net == "G" else vd["batch_stats"]
        want = conv({"params": jax.tree_util.tree_map(np.asarray, jparams), "batch_stats": stats})
        grads = first_grads[net]
        gmax = max(float(v.abs().max()) for v in grads.values())
        for k, p in mod.named_parameters():
            if k not in grads:
                continue
            mag = grads[k].abs()
            sure = mag >= GRAD_FLOOR * gmax
            bound = 2 * STEPS * LR * GRAD_FLOOR * gmax / mag.clamp(min=1e-30)
            err = (p.detach() - want[k]).abs()
            assert bool((err[sure] <= bound[sure]).all()), (net, k, float(err[sure].max()))
            compared += int(sure.sum())
    assert compared > 0
