"""The GAN train step's options against the JAX package, on the CPU: the
two-H hat reconstruction (``two_h_hat``, ``asm.hat_target_random_distances``)
and the ``separate`` and ``full`` critic batchings.

Inputs, weights and draws as in tests/test_torch_train.py: seeded numpy,
variables carried into the port with ``convert``, SGD in place of Adam (the
update reads back the gradient), JAX's distance permutation and GP alphas
recomputed from its key and handed to the port.  The port's 32 x 32 grid
takes the fused branch (K1's and K2's plain versions, field input, a
distance per plane, the product mask); the JAX step runs on its ``xla``
FFT backend.

Tolerances, with their reasons:
  * ``hat_target_random_distances``: propagation, <= 1e-3 at p99.9 and
    4e-3 at worst on the amplitudes (tests/test_torch_ops.py's bound), the
    phases as phasors where the amplitude is above 1e-3 of its maximum,
    2e-2 (a phase is ill-defined where the field vanishes);
  * one train step with each option: the bounds of
    ``test_train_step_matches_jax`` (propagation upstream of every loss):
    losses 2e-3 relative, gradients 1e-2 of the net's largest |g|, running
    statistics rtol 1e-4 + atol 1e-5 (``assert_stats_close``);
  * one bfloat16 two-H step, on the inputs of tests/test_torch_bf16.py,
    u = 2^-8.  The critic's gradients against the float32 two-H step's:
    that file's n * u bound, 68 u of the net's largest |g| over its
    parameters.  The generator's, as there: against JAX's bfloat16
    generator backward with XLA's excess precision off, at the cotangent
    the port's step gave its POH, 48 u of the largest |g| over the
    parameters, the conv biases in front of a train-mode BatchNorm held to
    their exact gradient, 0.  Not against the float32 step's: the model's
    own forward conditioning moves the bfloat16 generator gradients by
    more than half of max |g| on both sides (tests/bf16_grad_survey.py).
    Losses 2e-2 relative (one side rounds to bfloat16, the JAX package's
    UNet gate), SSIM (near 0) 2e-2 absolute, the critic's term
    0.1 * 25 u of the largest |score| absolute and D_loss 2e-2 times the
    penalty's gain 2 n / (n - 1), as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import OpticsConfig as JaxOptics
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, LossConfig, OpticsConfig
from learned_hologram_gan_tpu_torch.models import Generator, make_generator_plan
from learned_hologram_gan_tpu_torch.models.discriminator import WGANGPDiscriminator192
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.ops.cuda import spectral
from learned_hologram_gan_tpu_torch.train import steps
from learned_hologram_gan_tpu_torch.train.state import TrainState
from test_torch_bf16 import LR_D as BF16_LR_D
from test_torch_bf16 import LR_G as BF16_LR_G
from test_torch_bf16 import (
    _jax_step,
    _updates,
    assert_generator_grads_close,
    jax_generator_vjp,
    poh_cotangent_hook,
)
from test_torch_models import jax_variables
from test_torch_ops import _on_backend, assert_close
from test_torch_train import (  # noqa: F401
    DISTANCES,
    HW,
    LOSS_CFG,
    RATIO,
    SMALL,
    carried_state,
    step_against_jax,
    vgg_carried,
)

U = 2.0**-8

# (rows, pad): 24 + 2 * 4 = 32, a power of two, which the port runs fused;
# 24 + 2 * 5 = 34, which it runs composable
GRIDS = {"fused": (24, 4), "composable": (24, 5)}


def _plan_pair(grid):
    """The generator's fixed-distance plan and the focal stack's plan, on
    one grid with different aperture radii, so that the hat's product mask
    is neither plan's mask."""
    rows, pad = GRIDS[grid]
    out = []
    for optics_cls, make in ((JaxOptics, jasm.make_plan),
                             (OpticsConfig, lambda o, distances: asm.make_plan(o, distances, device="cpu"))):
        gen = make(optics_cls(rows=rows, cols=rows, pad_size=pad, filter_radius_coefficient=0.35),
                   distances=[1e-3])
        multi = make(optics_cls(rows=rows, cols=rows, pad_size=pad, filter_radius_coefficient=0.45),
                     distances=DISTANCES)
        out.append((gen, multi))
    assert asm._fused_ok(out[1][1]) == (grid == "fused")
    return out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_hat_target_random_distances_matches_jax(grid, backend):
    (jgen, jmulti), (gen, multi) = _plan_pair(grid)
    rows = GRIDS[grid][0]
    rng = np.random.default_rng(80)
    poh = (2 * np.pi * rng.random((2, 3, rows, rows))).astype(np.float32)
    amp = rng.random((2, 3, rows, rows)).astype(np.float32)
    phs = rng.random((2, 3, rows, rows)).astype(np.float32)  # the dataset's [0, 1] phase
    key = jax.random.key(81)
    want = _on_backend(backend, jasm.hat_target_random_distances, jgen, jmulti,
                       jnp.asarray(poh), jnp.asarray(amp), jnp.asarray(phs), key)
    idx = torch.from_numpy(np.asarray(jax.random.permutation(key, len(DISTANCES))[:2]))
    got = asm.hat_target_random_distances(gen, multi, *map(torch.from_numpy, (poh, amp, phs)), idx)
    for a, ja in zip(got[:2], want[:2]):
        assert tuple(a.shape) == (2, 3, rows, rows)
        assert_close(a.numpy(), np.asarray(ja))
    for p, jp, ja in zip(got[2:], want[2:], want[:2]):
        ja = np.asarray(ja)
        d = np.abs(np.exp(1j * p.numpy()) - np.exp(1j * np.asarray(jp)))
        assert np.max(d[ja > 1e-3 * ja.max()]) <= 2e-2


def test_hat_target_random_distances_launches_the_field_per_plane_mode():
    """On the fused grid each branch is one propagate_planes call, field
    input with one distance per plane and its product mask, and the two
    masks are the hat's gen * multi and the target's multi ** 2."""
    _, (gen, multi) = _plan_pair("fused")
    seen = []
    real = spectral.propagate_planes

    def probe(fr, fi, wl2, dists, mask, cfg):
        seen.append((spectral._mode(cfg), dists.reshape(-1).clone(), mask))
        return real(fr, fi, wl2, dists, mask, cfg)

    x = torch.rand(2, 3, 24, 24, generator=torch.Generator().manual_seed(82))
    spectral.propagate_planes = probe
    try:
        asm.hat_target_random_distances(gen, multi, x, x, x, torch.tensor([3, 1]))
    finally:
        spectral.propagate_planes = real
    assert [s[0] for s in seen] == ["field+per_plane"] * 2
    z = multi.distances[torch.tensor([3, 1])].repeat_interleave(3)
    torch.testing.assert_close(seen[0][1], gen.distances[0] + z, rtol=0, atol=0)
    torch.testing.assert_close(seen[1][1], z, rtol=0, atol=0)
    torch.testing.assert_close(seen[0][2], gen.mask * multi.mask, rtol=0, atol=0)
    torch.testing.assert_close(seen[1][2], multi.mask**2, rtol=0, atol=0)
    assert not torch.equal(seen[0][2], multi.mask)


def test_hat_target_random_distances_refusals():
    """The JAX function's ValueErrors: plans on other grids, a batch larger
    than the distance stack, a generator plan without its distance."""
    _, (gen, multi) = _plan_pair("fused")
    _, (gen34, _) = _plan_pair("composable")
    x = torch.zeros(2, 3, 24, 24)
    idx = torch.tensor([0, 1])
    with pytest.raises(ValueError, match="same padded grid"):
        asm.hat_target_random_distances(gen34, multi, x, x, x, idx)
    big = torch.zeros(len(DISTANCES) + 1, 3, 24, 24)
    with pytest.raises(ValueError, match="batch <= num_distances"):
        asm.hat_target_random_distances(gen, multi, big, big, big, torch.arange(len(DISTANCES) + 1))
    no_z = asm.make_plan(OpticsConfig(rows=24, cols=24, pad_size=4), device="cpu")
    with pytest.raises(ValueError, match="fixed distance"):
        asm.hat_target_random_distances(no_z, multi, x, x, x, idx)


OPTIONS = [dict(two_h_hat=True), dict(critic_batching="separate"), dict(critic_batching="full")]


@pytest.mark.parametrize("option", OPTIONS, ids=["two_h_hat", "separate", "full"])
def test_train_step_option_matches_jax(carried_state, option):  # noqa: F811
    """One float32 GAN step with each option against JAX's: metrics,
    gradients of both nets and both nets' running statistics."""
    step_against_jax(carried_state, **option)


def test_build_train_step_refuses_unknown_batching():
    with pytest.raises(ValueError, match="critic_batching"):
        steps.build_train_step(LossConfig(), True, 2, 10.0, critic_batching="joint")


@pytest.fixture(scope="module")
def bf16_inputs(vgg_carried):  # noqa: F811
    """tests/test_torch_bf16.py's step inputs (seeded batch and variables,
    SGD at LR_G = 1 so that the update reads back the gradient, LR_D = 1e-6
    so that the critic's first update leaves the second's batch statistics
    where they were), and the JAX float32 two-H step's gradients."""
    jparams_vgg, vgg = vgg_carried
    rng = np.random.default_rng(66)
    batch = tuple(rng.random((2, c, HW, HW)).astype(np.float32) for c in (4, 3, 3))
    jcfg = JaxGenConfig(**SMALL, dtype="bfloat16")
    vg = jax_variables(JaxGenerator(jcfg), jax_gen_plan(jcfg), jnp.asarray(batch[0][:1]),
                       train=False, seed=67)
    vd = jax_variables(JaxCritic(feature_d=2), jnp.asarray(batch[1][:1]), train=False, seed=68)
    loss_cfg = dict(LOSS_CFG, perceptual="random")
    jnew, _, idx, alphas = _jax_step("float32", vg, vd, jparams_vgg, batch, loss_cfg, two_h_hat=True)
    jax_grads = dict(G=_updates(vg, jnew.params_G, BF16_LR_G, convert.generator_state_dict),
                     D=_updates(vd, jnew.params_D, BF16_LR_D, convert.discriminator_state_dict))
    return dict(vg=vg, vd=vd, vgg=vgg, batch=batch, idx=idx, alphas=alphas, loss_cfg=loss_cfg,
                jax_grads=jax_grads)


def _two_h_step(c, dtype):
    """The port's two-H step in ``dtype`` on ``c``'s inputs and draws;
    returns the metrics, the gradients read back from SGD, the largest
    |score| of the critic's last call, the cotangent its POH received and
    the generator."""
    cfg = GeneratorConfig(**SMALL, dtype=dtype)
    g = Generator(cfg)
    g.load_state_dict(convert.generator_state_dict(c["vg"]))
    d = WGANGPDiscriminator192(2, dtype=dtype)
    d.load_state_dict(convert.discriminator_state_dict(c["vd"]))
    state = TrainState(step=0, generator=g.train(), discriminator=d.train(),
                       opt_G=torch.optim.SGD(g.parameters(), lr=BF16_LR_G),
                       opt_D=torch.optim.SGD(d.parameters(), lr=BF16_LR_D),
                       rng=torch.Generator().manual_seed(0), vgg=c["vgg"])
    old = {name: {k: v.detach().clone() for k, v in net.named_parameters()}
           for name, net in (("G", g), ("D", d))}
    plan = make_generator_plan(cfg, device="cpu")
    multi = asm.make_plan(cfg.optics(), distances=DISTANCES, device="cpu")
    step = steps.build_train_step(LossConfig(**c["loss_cfg"]), True, RATIO, 10.0, two_h_hat=True)
    scores, cotangent = [], []
    handles = [d.register_forward_hook(lambda m, a, out: scores.append(float(out.detach().abs().max()))),
               poh_cotangent_hook(g, cotangent)]
    try:
        _, m = step(state, tuple(map(torch.from_numpy, c["batch"])), plan, multi,
                    idx=torch.from_numpy(np.asarray(c["idx"])), alphas=torch.from_numpy(c["alphas"]))
    finally:
        for handle in handles:
            handle.remove()
    grads = {name: {k: (old[name][k] - p.detach()) / lr for k, p in net.named_parameters()}
             for name, net, lr in (("G", g, BF16_LR_G), ("D", d, BF16_LR_D))}
    (cotangent,) = cotangent
    return {k: float(v) for k, v in m.items()}, grads, scores[-1], cotangent, g


def _departure(got, want):
    """max |got - want| over a net's parameters (``got``'s keys: the
    running statistics that ``_updates`` carries along are no gradients
    and stay out, of the scale too), relative to the largest |want|."""
    scale = max(float(want[k].abs().max()) for k in got)
    return max(float((got[k] - want[k]).abs().max()) for k in got) / scale


def test_two_h_step_bf16_matches_float32(bf16_inputs):
    """One bfloat16 two-H step against the float32 two-H step (metrics, the
    critic's gradients) and against JAX's bfloat16 generator backward (the
    generator's gradients), from the same weights and draws, at the bounds
    stated above; the float32 step also against JAX's."""
    c = bf16_inputs
    m32, g32, _, _, _ = _two_h_step(c, "float32")
    m16, g16, last_score, cotangent, generator = _two_h_step(c, "bfloat16")
    for net in ("G", "D"):
        assert _departure(g32[net], c["jax_grads"][net]) <= 1e-2
    assert set(m16) == set(m32)
    n = 1.0 + np.sqrt(m32["D_loss"] / 10.0)  # lambda 10; the penalty dominates D_loss
    for k in m32:
        rtol, atol = 2e-2, 1e-6
        if k in ("gan_loss", "G_loss"):
            atol = LOSS_CFG["discriminator_loss_weight"] * 25 * U * last_score
        elif k == "SSIM":
            rtol, atol = 0.0, 2e-2
        elif k == "D_loss":
            rtol = 2e-2 * 2 * n / (n - 1)
        np.testing.assert_allclose(m16[k], m32[k], rtol=rtol, atol=atol, err_msg=k)
    assert _departure(g16["D"], g32["D"]) <= 68 * U
    assert_generator_grads_close(generator, g16["G"], jax_generator_vjp(c["vg"], c["batch"][0], cotangent),
                                 48 * U)
