"""The port's other network classes against the JAX package's, through
carried weights: ``FourierBlock``, the fourier ``UNet``, ``MiniResNet``,
``ResNet``, ``ResNetPOH``, ``MiniUNet`` and ``RGBDUNet`` (``nn/blocks.py``),
and a Generator whose stage 1 is the fourier UNet.

JAX variables are seeded numpy arrays in the tree flax's ``init`` gives
(``test_torch_models.jax_variables``: the constant leaves randomized too),
carried by ``convert.generator_state_dict``; inputs are seeded numpy
arrays.  Each network runs in eval mode (outputs) and in train mode
(outputs, and the running statistics flax's mutable apply leaves).

Tolerances are the port's model tolerances (tests/test_torch_models.py):
1e-5 for outputs in eval mode and for a block in train mode; 1e-4 for a
deep network in train mode, whose batch statistics sum ~1e3 terms a layer
(the critic's bound); phases (ResNetPOH's 2*pi scale) 5e-5 absolute; the
POH as phasors and the focal stack within the propagation bound (<= 1e-3
at p99.9, 4e-3 worst).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import generator as jgen
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.nn import blocks as jblocks
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig
from learned_hologram_gan_tpu_torch.models import (
    Generator,
    generator_apply_fused,
    generator_apply_quant,
    make_generator_plan,
)
from learned_hologram_gan_tpu_torch.nn import blocks
from learned_hologram_gan_tpu_torch.ops import asm
from test_torch_models import (
    SMALL,
    assert_poh_close,
    assert_stats_close,
    jax_apply,
    jax_variables,
    nchw,
    to_jax,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name: (JAX module, port module, input (N, H, W, C), output scale)
NETS = {
    "fourier_block": (lambda: jblocks.FourierBlock(4), lambda: blocks.FourierBlock(3, 4),
                      (2, 8, 10, 3), 1.0),
    "fourier_unet": (lambda: jblocks.UNet(output_channels=6, base_features=2, levels=2, fourier=True),
                     lambda: blocks.UNet(4, 6, base_features=2, levels=2, fourier=True),
                     (2, 16, 16, 4), 1.0),
    "mini_resnet": (lambda: jblocks.MiniResNet(3), lambda: blocks.MiniResNet(3, 3), (2, 8, 8, 3), 1.0),
    "resnet": (lambda: jblocks.ResNet(3), lambda: blocks.ResNet(3, 3), (2, 6, 6, 3), 1.0),
    "resnet_poh": (lambda: jblocks.ResNetPOH(3), lambda: blocks.ResNetPOH(3, 3), (2, 6, 6, 3),
                   2 * np.pi),
    "mini_unet": (lambda: jblocks.MiniUNet(1), lambda: blocks.MiniUNet(3, 1), (2, 8, 8, 3), 1.0),
    "rgbd_unet": (lambda: jblocks.RGBDUNet(base_features=2), lambda: blocks.RGBDUNet(2),
                  (2, 16, 16, 4), 1.0),
}


def _pair(name, train):
    jmake, pmake, shape, scale = NETS[name]
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(np.float32)
    jm = jmake()
    variables = jax_variables(jm, jnp.asarray(x), train=train)
    m = pmake()
    m.load_state_dict(convert.generator_state_dict(variables))
    return jm, variables, m.train(train), x, scale


def _out(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", list(NETS))
def test_network_matches_jax_eval(name):
    jm, variables, m, x, scale = _pair(name, train=False)
    want = np.asarray(jax_apply(jm, variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _out(m(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("name", list(NETS))
def test_network_matches_jax_train(name):
    """Train mode: batch-statistics outputs and the running statistics
    flax's mutable apply leaves, from randomized batch_stats."""
    jm, variables, m, x, scale = _pair(name, train=True)
    want, mut = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        to_jax(variables), jnp.asarray(x))
    got = _out(m(nchw(x)))
    tol = 1e-5 if name == "fourier_block" else 1e-4
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol * scale)
    assert_stats_close(m, mut["batch_stats"], rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("name", list(NETS))
def test_weight_carry_round_trip(name):
    """convert.py both ways: flax variables -> state_dict (strict load, every
    leaf) -> flax variables, the same tree and the same values."""
    _, variables, m, _, _ = _pair(name, train=False)
    back = convert.flax_variables(m)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           {k: variables[k] for k in ("params", "batch_stats")})
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(variables))
    n_port = sum(t.numel() for k, t in m.state_dict().items() if not k.endswith("num_batches_tracked"))
    assert n_jax == n_port


def test_fourier_unet_takes_no_polyphase_and_remats():
    """polyphase_level0 is switched off for a fourier UNet (the JAX
    package's rule); remat wraps FourierBlocks and gives the plain
    forward's output and gradients."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 4, 16, 16)).astype(np.float32))
    plain = blocks.UNet(4, 6, base_features=2, levels=2, fourier=True, polyphase_level0=True)
    blocks.init_weights(plain, torch.Generator().manual_seed(1))
    assert not plain.uses_polyphase(x)
    rem = blocks.UNet(4, 6, base_features=2, levels=2, fourier=True, remat=True)
    rem.load_state_dict(plain.state_dict())
    outs = []
    for net in (plain, rem):
        y = net(x)
        grads = torch.autograd.grad(y.square().sum(), list(net.parameters()))
        outs.append((y.detach(), grads))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


class _JaxFourierGenerator(fnn.Module):
    """The JAX package's two stages with ``RGBD2AP.fourier``: its Generator
    takes no fourier option, so the stages are composed as Generator
    composes them, under the same names."""

    config: JaxGenConfig

    def setup(self):
        self.part1 = jgen.RGBD2AP(amplitude_scaler=self.config.amplitude_scaler,
                                  base_features=self.config.unet_base_features, fourier=True)
        self.part2 = jgen.AP2POH(kernel_size=self.config.kernel_size,
                                 use_modulation=self.config.use_modulation)

    def __call__(self, plan, rgbd, train=True):
        amp, phs = self.part1(rgbd, train)
        return self.part2(plan, amp, phs)


@pytest.fixture(scope="module")
def fourier_pair():
    jcfg = JaxGenConfig(**SMALL)
    jplan = jax_gen_plan(jcfg)
    rgbd = np.random.default_rng(13).random((2, 4, 32, 32)).astype(np.float32)
    jm = _JaxFourierGenerator(jcfg)
    variables = jax_variables(jm, jplan, jnp.asarray(rgbd[:1]), train=False)
    model = Generator(GeneratorConfig(**SMALL), fourier=True).eval()
    model.load_state_dict(convert.generator_state_dict(variables))
    return jm, jplan, variables, model, rgbd


def test_fourier_generator_poh_and_focal_stack_match_jax(fourier_pair):
    """RGBD -> POH -> 3-plane focal stack through the fourier generator."""
    jm, jplan, variables, model, rgbd = fourier_pair
    distances = np.linspace(4e-4, 1e-3, 3)
    jpoh = jax_apply(jm, variables, jplan, jnp.asarray(rgbd), train=False)
    jrecon = jasm.make_plan(JaxGenConfig(**SMALL).optics(), distances=distances)
    jstack = np.asarray(jax.jit(
        lambda plan, p: jasm.propagate_batch_multi(plan, jnp.ones_like(p), p))(jrecon, jpoh))
    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    recon = asm.make_plan(GeneratorConfig(**SMALL).optics(), distances=distances, device="cpu")
    with torch.inference_mode():
        poh = model(plan, torch.from_numpy(rgbd))
        stack = asm.propagate_batch_multi(recon, torch.ones_like(poh), poh)
    assert tuple(poh.shape) == (2, 3, 32, 32) and tuple(stack.shape) == jstack.shape
    assert_poh_close(poh.numpy(), np.asarray(jpoh))
    d = np.abs(stack.numpy() - jstack)
    assert np.quantile(d, 0.999) <= 1e-3 and np.max(d) <= 4e-3


def test_fused_apply_falls_back_for_a_fourier_tree(fourier_pair):
    """generator_apply_fused on a fourier generator is the module's own
    eval-mode forward, bit for bit, and leaves the module's mode alone."""
    _, _, _, model, rgbd = fourier_pair
    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    x = torch.from_numpy(rgbd)
    model.train()
    try:
        fused = generator_apply_fused(model, plan, x)
        assert model.training
        model.eval()
        with torch.no_grad():
            plain = model(plan, x)
    finally:
        model.eval()
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)


def test_int8_apply_refuses_a_fourier_tree(fourier_pair):
    """Both packages refuse a fourier tree in the int8 apply."""
    jm, jplan, variables, model, rgbd = fourier_pair
    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="fourier"):
        generator_apply_quant(model, {}, plan, torch.from_numpy(rgbd))
    with pytest.raises(ValueError, match="fourier"):
        jgen.generator_apply_quant(jm, to_jax(variables), {}, jplan, jnp.asarray(rgbd))
