"""How far bfloat16 moves the GAN step's gradients, in the port and in the
JAX package, on the CPU: the readings behind the gradient bounds of
tests/test_torch_bf16.py and tests/test_torch_train_options.py.

    python tests/bf16_grad_survey.py

Prints, on those tests' step inputs (16 x 16, batch 2, the same seeds and
JAX draws), for the default and the two-H step:

  * each side's bfloat16 gradients against its own float32 gradients, the
    largest difference over a net's parameters relative to the net's
    largest |g| (``max``) and the relative L2 norm of the difference
    (``l2``), in u = 2^-8; JAX twice, as compiled by default (XLA keeps
    excess precision in its fusions) and with ``xla_allow_excess_precision``
    off, which rounds where flax's dtype rule says, as the port does;
  * the port's bfloat16 generator gradients against JAX's bfloat16
    generator backward at the port step's POH cotangent (the tests' check);
  * the factor by which the old scale of tests/test_torch_bf16.py (the
    largest value over gradients and running statistics) exceeded the
    largest gradient;

then the port's bfloat16-against-float32 departures over four more seeds,
and one stride-1 convolution's double backward in bfloat16 on the CPU at
16 x 16 and 64 x 64.  Takes about three minutes on one CPU core.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import test_torch_bf16 as tb  # noqa: E402
import test_torch_train as tt  # noqa: E402
import test_torch_train_options as to  # noqa: E402
from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig  # noqa: E402
from learned_hologram_gan_tpu.models import Generator as JaxGenerator  # noqa: E402
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic  # noqa: E402
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan  # noqa: E402
from learned_hologram_gan_tpu.train import steps as jsteps  # noqa: E402
from learned_hologram_gan_tpu_torch import convert  # noqa: E402
from learned_hologram_gan_tpu_torch.train import steps  # noqa: E402
from test_torch_models import jax_variables  # noqa: E402

U = 2.0**-8
_build = jsteps.build_train_step


def _nominal_build(*args, **kwargs):
    """``build_train_step`` compiled with XLA's excess precision off."""
    step = _build(*args, **kwargs)
    return lambda *a: step.lower(*a).compile(compiler_options={"xla_allow_excess_precision": False})(*a)


def departure(got, want, zero=()):
    """(max, l2) of ``got - want`` over ``got``'s keys, in u; the keys in
    ``zero`` against 0."""
    ref = {k: torch.zeros_like(got[k]) if k in zero else want[k] for k in got}
    scale = max(float(ref[k].abs().max()) for k in got)
    a = torch.cat([got[k].flatten() for k in got])
    b = torch.cat([ref[k].flatten() for k in got])
    worst = max(float((got[k] - ref[k]).abs().max()) for k in got)
    return worst / scale / U, float((a - b).norm() / b.norm()) / U


def fmt(pair):
    return f"max {pair[0]:7.1f} u, l2 {pair[1]:7.1f} u"


def port_step(c, dtype, two_h):
    """The port's step on ``c`` (as ``_two_h_step``, with or without two-H)."""
    build = steps.build_train_step
    if not two_h:
        steps.build_train_step = lambda *a, two_h_hat=False, **k: build(*a, **k)
    try:
        return to._two_h_step(c, dtype)
    finally:
        steps.build_train_step = build


def step_inputs(seed, vgg, hw=tt.HW):
    rng = np.random.default_rng(seed)
    batch = tuple(rng.random((2, ch, hw, hw)).astype(np.float32) for ch in (4, 3, 3))
    jcfg = JaxGenConfig(**tt.SMALL, dtype="bfloat16")
    vg = jax_variables(JaxGenerator(jcfg), jax_gen_plan(jcfg), jnp.asarray(batch[0][:1]),
                       train=False, seed=seed + 1)
    vd = jax_variables(JaxCritic(feature_d=2), jnp.asarray(batch[1][:1]), train=False, seed=seed + 2)
    return dict(vg=vg, vd=vd, vgg=vgg, batch=batch, loss_cfg=dict(tt.LOSS_CFG, perceptual="random"))


def survey_tests(jparams_vgg, vgg):
    c = step_inputs(66, vgg)
    for two_h in (False, True):
        options = dict(two_h_hat=True) if two_h else {}
        jax_g = {}
        for tag, dtype, build in (("float32", "float32", _build), ("bfloat16", "bfloat16", _build),
                                  ("nominal", "bfloat16", _nominal_build)):
            jsteps.build_train_step = build
            try:
                jnew, _, idx, alphas = tb._jax_step(dtype, c["vg"], c["vd"], jparams_vgg, c["batch"],
                                                    c["loss_cfg"], **options)
            finally:
                jsteps.build_train_step = _build
            jax_g[tag] = dict(G=tb._updates(c["vg"], jnew.params_G, tb.LR_G, convert.generator_state_dict),
                              D=tb._updates(c["vd"], jnew.params_D, tb.LR_D,
                                            convert.discriminator_state_dict))
        c.update(idx=idx, alphas=alphas)
        _, g32, _, _, _ = port_step(c, "float32", two_h)
        _, g16, _, cotangent, generator = port_step(c, "bfloat16", two_h)
        print(f"{'two-H' if two_h else 'default'} step, bfloat16 against float32:")
        for net in ("G", "D"):
            keys = g32[net]
            print(f"  {net} port            {fmt(departure(g16[net], g32[net]))}")
            for tag in ("bfloat16", "nominal"):
                got = {k: jax_g[tag][net][k] for k in keys}
                print(f"  {net} JAX {tag:12s}{fmt(departure(got, jax_g['float32'][net]))}")
        want = tb.jax_generator_vjp(c["vg"], c["batch"][0], cotangent)
        print("  G port against JAX's nominal generator backward at the port's cotangent: "
              + fmt(departure(g16["G"], want, tb.pre_norm_biases(generator))))
        full = max(float(v.abs().max()) for v in jax_g["float32"]["G"].values())
        params = max(float(jax_g["float32"]["G"][k].abs().max()) for k in g32["G"])
        print(f"  G old scale (running statistics included) / largest |g|: {full / params:.2f}")


def survey_seeds(vgg):
    print("port, two-H step, bfloat16 against float32, four more seeds (draws from the seed):")
    for seed in (100, 110, 120, 130):
        c = step_inputs(seed, vgg)
        rng = np.random.default_rng(seed)
        c.update(idx=rng.permutation(len(tt.DISTANCES))[:2],
                 alphas=rng.random((tt.RATIO, 2, 1, 1, 1)).astype(np.float32))
        _, g32, _, _, _ = port_step(c, "float32", True)
        _, g16, _, _, _ = port_step(c, "bfloat16", True)
        print(f"  seed {seed}: G {fmt(departure(g16['G'], g32['G']))}; D {fmt(departure(g16['D'], g32['D']))}")


def survey_double_backward():
    print("one 3x3 stride-1 conv (3 -> 8 channels, batch 2), d<grad_x, v>/dw in bfloat16 "
          "against float32 on the same bfloat16 values, CPU:")
    gen = torch.Generator().manual_seed(0)
    for hw in (16, 64):
        x, v = (torch.randn(2, 3, hw, hw, generator=gen).bfloat16() for _ in range(2))
        w = (torch.randn(8, 3, 3, 3, generator=gen) * 0.3).bfloat16()
        g = torch.randn(2, 8, hw, hw, generator=gen).bfloat16()
        out = {}
        for dt in (torch.bfloat16, torch.float32):
            xx, ww = x.to(dt).requires_grad_(), w.to(dt).requires_grad_()
            (gx,) = torch.autograd.grad(F.conv2d(xx, ww, padding=1), xx, g.to(dt), create_graph=True)
            (out[dt],) = torch.autograd.grad((gx * v.to(dt)).sum(), ww)
        a, b = out[torch.bfloat16].float(), out[torch.float32]
        print(f"  {hw} x {hw}: max {float((a - b).abs().max() / b.abs().max()) / U:.1f} u")


def main():
    torch.set_num_threads(1)
    jparams_vgg, vgg = tt.vgg_carried.__wrapped__()
    survey_tests(jparams_vgg, vgg)
    survey_seeds(vgg)
    survey_double_backward()


if __name__ == "__main__":
    main()
