"""``remat`` in the port's train step and UNet, on the CPU.

The remat step recomputes activations in the backward (the UNet's blocks,
steps 1-4, every critic apply, the penalty's critic inside its double
backward, VGG19) and must equal the plain step bit for bit in float32:
losses, parameters, Adam's state and the BatchNorm running statistics
(which a recompute must not move a second time).  Against the JAX
package's remat step (its UNet's per-block ``nn.remat`` and its step's
``jax.checkpoint`` sites) the step gates of tests/test_torch_train.py hold:
losses 2e-3 relative, gradients 1e-2 of the largest |g| of their network,
statistics rtol 1e-4.  The kernels' launches are counted through their
plain versions' calls, one call for one launch, and held to what
``highres_smoke`` expects on the card.
"""

import collections

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu_torch import highres_smoke
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, LossConfig
from learned_hologram_gan_tpu_torch.losses import load_vgg19_params, make_vgg19
from learned_hologram_gan_tpu_torch.models import Generator, make_generator_plan
from learned_hologram_gan_tpu_torch.models.discriminator import WGANGPDiscriminator192, init_discriminator
from learned_hologram_gan_tpu_torch.nn.blocks import UNet, init_weights
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.ops.cuda import fft, spectral
from learned_hologram_gan_tpu_torch.train import steps
from learned_hologram_gan_tpu_torch.train.state import TrainState
import test_torch_train
from test_torch_train import SMALL, carried_state, step_against_jax, vgg_carried  # noqa: F401
from test_torch_tools import one_torch_thread  # noqa: F401

DISTANCES = np.linspace(-4e-4, 0.0, 5)[:-1]
# 32 x 32 (K1's fused branch) and, through pad_cols_override, 24 x 36
# (the composable torch.fft branch that the 1080p and 4K grids take)
GRIDS = {"fused": dict(pad_size=8), "override": dict(pad_size=4, pad_cols_override=10)}


def _config(grid, remat):
    return GeneratorConfig(rows=16, cols=16, filter_radius_coefficient=0.45, unet_base_features=2,
                           remat=remat, **GRIDS[grid])


def _state(grid, remat, vgg):
    g = Generator(_config(grid, remat))
    init_weights(g, torch.Generator().manual_seed(1))
    d = WGANGPDiscriminator192(2)
    init_discriminator(d, torch.Generator().manual_seed(2))
    return TrainState(0, g.train(), d.train(), torch.optim.Adam(g.parameters(), 1e-3),
                      torch.optim.Adam(d.parameters(), 1e-3), torch.Generator().manual_seed(3), vgg)


def _tensors(state):
    out = {f"G.{k}": v for k, v in state.generator.state_dict().items()}
    out |= {f"D.{k}": v for k, v in state.discriminator.state_dict().items()}
    for name, opt in (("opt_G", state.opt_G), ("opt_D", state.opt_D)):
        for i, s in opt.state_dict()["state"].items():
            out |= {f"{name}.{i}.{k}": v for k, v in s.items()}
    return out


@pytest.fixture(scope="module")
def vgg():
    state, _ = load_vgg19_params(mode="random")
    return make_vgg19(state, "cpu")


OPTIONS = {"pair": {}, "separate": dict(critic_batching="separate"), "full": dict(critic_batching="full"),
           "two_h_hat": dict(two_h_hat=True), "no_gan": dict(use_gan=False)}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("option", list(OPTIONS))
def test_remat_step_equals_plain_step_bit_for_bit(option, grid, vgg):
    """Two float32 steps (VGG19 on, H on the fly) with and without remat:
    metrics, parameters, BatchNorm statistics and their counters, Adam's
    state, bit for bit."""
    opts = dict(OPTIONS[option])
    use_gan = opts.pop("use_gan", True)
    rng = np.random.default_rng(4)
    batch = tuple(torch.from_numpy(rng.random((2, c, 16, 16)).astype(np.float32)) for c in (4, 3, 3))
    loss_cfg = LossConfig(perceptual="random", perceptual_loss_weight=0.1, discriminator_loss_weight=0.1)
    runs = []
    for remat in (False, True):
        state = _state(grid, remat, vgg)
        cfg = _config(grid, remat)
        plan = make_generator_plan(cfg, device="cpu", cache_h=False)
        multi = asm.make_plan(cfg.optics(), distances=DISTANCES, device="cpu", cache_h=False)
        assert asm._fused_ok(plan) == (grid == "fused")
        step = steps.build_train_step(loss_cfg, use_gan, 2, 10.0, remat=remat, **opts)
        for _ in range(2):
            state, metrics = step(state, batch, plan, multi)
        runs.append((metrics, _tensors(state)))
    (m0, t0), (m1, t1) = runs
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert set(t0) == set(t1)
    for k in t0:
        assert torch.equal(t0[k], t1[k]), k
    assert int(t1["G.part1.unet.enc_0.BatchNorm_0.num_batches_tracked"]) == 2


def test_unet_remat_keeps_the_parameters_and_updates_statistics_once():
    """The remat UNet has the plain UNet's parameter tree; its output, its
    input and parameter gradients and its running statistics equal the plain
    UNet's bit for bit after a forward and a backward."""
    nets = []
    for remat in (False, True):
        net = UNet(base_features=2, remat=remat)
        init_weights(net, torch.Generator().manual_seed(5))
        nets.append(net.train())
    assert list(nets[0].state_dict()) == list(nets[1].state_dict())
    x = torch.from_numpy(np.random.default_rng(6).random((2, 4, 16, 16)).astype(np.float32))
    outs = []
    for net in nets:
        xi = x.clone().requires_grad_(True)
        y = net(xi)
        (y * y).sum().backward()
        outs.append((y.detach(), xi.grad, {k: p.grad for k, p in net.named_parameters()}, net.state_dict()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for k in outs[0][2]:
        assert torch.equal(outs[0][2][k], outs[1][2][k]), k
    for k in outs[0][3]:
        assert torch.equal(outs[0][3][k], outs[1][3][k]), k
    assert int(outs[1][3]["enc_0.BatchNorm_0.num_batches_tracked"]) == 1


def test_gradient_penalty_double_backward_through_remat():
    """The penalty's create_graph double backward through a checkpointed
    critic: the penalty and its gradients equal the plain ones bit for bit,
    and the running statistics do not move."""
    critic = WGANGPDiscriminator192(2)
    init_discriminator(critic, torch.Generator().manual_seed(7))
    critic.train()
    rng = np.random.default_rng(8)
    real, fake = (torch.from_numpy(rng.random((2, 3, 16, 16)).astype(np.float32)) for _ in range(2))
    alpha = torch.from_numpy(rng.random((2, 1, 1, 1)).astype(np.float32))
    stats = {k: v.clone() for k, v in critic.state_dict().items()}
    out = []
    for remat in (False, True):
        critic.zero_grad(set_to_none=True)
        gp = steps.gradient_penalty(critic, real, fake, alpha, remat=remat)
        gp.backward()
        out.append((gp.detach(), {k: p.grad for k, p in critic.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert (g is None and out[1][1][k] is None) or torch.equal(g, out[1][1][k]), k
    for k, v in critic.state_dict().items():
        assert torch.equal(v, stats[k]), k


class _LaunchCounter:
    """Counts the kernels' plain-version calls, one call for one launch on
    the card: K1 and K2 by mode, K3's one-axis passes."""

    def __init__(self, monkeypatch):
        self.k1, self.k2, self.k3 = collections.Counter(), collections.Counter(), 0
        fwd, adj, axis = (spectral.propagate_planes_reference, spectral.propagate_planes_adjoint_reference,
                          fft.fft_axis_reference)

        def count_fwd(*a):
            self.k1[spectral._mode(a[-1])] += 1
            return fwd(*a)

        def count_adj(*a):
            self.k2[spectral._mode(a[-1])] += 1
            return adj(*a)

        def count_axis(*a):
            self.k3 += 1
            return axis(*a)

        monkeypatch.setattr(spectral, "propagate_planes_reference", count_fwd)
        monkeypatch.setattr(spectral, "propagate_planes_adjoint_reference", count_adj)
        monkeypatch.setattr(fft, "fft_axis_reference", count_axis)

    def read(self):
        out = dict(k1=dict(self.k1), k2=dict(self.k2), k3=self.k3)
        self.k1, self.k2, self.k3 = collections.Counter(), collections.Counter(), 0
        return out


def test_remat_step_launches_what_the_code_makes(monkeypatch, vgg):
    """The recompute runs AP2POH, both fft2 and the random-distance stack a
    second time; the backward runs once (highres_smoke's expectation, which
    the card's counters are held to)."""
    counter = _LaunchCounter(monkeypatch)
    rng = np.random.default_rng(9)
    batch = tuple(torch.from_numpy(rng.random((2, c, 16, 16)).astype(np.float32)) for c in (4, 3, 3))
    for remat in (False, True):
        state = _state("fused", remat, vgg)
        cfg = _config("fused", remat)
        plan = make_generator_plan(cfg, device="cpu")
        multi = asm.make_plan(cfg.optics(), distances=DISTANCES, device="cpu")
        step = steps.build_train_step(LossConfig(perceptual="none"), True, 2, 10.0, remat=remat)
        counter.read()
        step(state, batch, plan, multi)
        assert counter.read() == highres_smoke.expected_step_launches(remat)


@pytest.mark.parametrize("sequential", [False, True], ids=["fused", "sequential"])
def test_eval_quality_launches_what_the_code_makes(monkeypatch, tmp_path, sequential):
    """eval_quality at a power-of-two grid: per reconstruction AP2POH (K1
    conj_h), two fft2 (K3), then K1 from_spectrum once over every distance,
    or, sequential, one ifft2 per distance."""
    from learned_hologram_gan_tpu_torch.models import make_generator
    from learned_hologram_gan_tpu_torch.tools import eval_quality
    from learned_hologram_gan_tpu_torch.train import checkpoint as ckpt_lib

    counter = _LaunchCounter(monkeypatch)
    highres_smoke._write_split(str(tmp_path), "val", 6, 16, 16, 10)
    ckpt_lib.save_weights(str(tmp_path / "G.msgpack"),
                          make_generator(GeneratorConfig(unet_base_features=2), device="cpu"))
    eval_quality.main(["--data", str(tmp_path), "--run_dir", str(tmp_path), "--rows", "16", "--cols", "16",
                       "--pad_size", "8", "--val_num", "6", "--num_planes", "5", "--unet_base_features", "2",
                       "--samples", "0", "--dtype", "float32", "--device", "cpu"]
                      + (["--sequential"] if sequential else []))
    # two batches (4 + 2 samples), then the grid's sample
    assert counter.read() == highres_smoke.expected_eval_launches(3, 5, sequential)


def test_remat_step_matches_jax_remat_step(carried_state, monkeypatch):  # noqa: F811
    """One GAN step with remat in both packages (per-block UNet remat and
    the step's sites), from the carried weights and JAX's draws, within the
    step gates."""
    plain_state = test_torch_train._port_state

    def remat_state(c):
        state = plain_state(c)
        state.generator.part1.unet.remat = True
        return state

    monkeypatch.setattr(test_torch_train, "_port_state", remat_state)
    c = dict(carried_state, jgen=JaxGenerator(JaxGenConfig(**SMALL, remat=True)))
    step_against_jax(c, remat=True)
