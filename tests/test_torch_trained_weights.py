"""The quality run's trained generator through both packages.

``output/quality_run/generator.msgpack`` (base 64, written by the JAX
package's GAN fine-tune) is read by the port's flax reader
(``train/flax_msgpack.py``, ``train/checkpoint.py``) and by flax, and one
seeded 384 x 384 RGBD sample goes through each package's generator in
float32 on the CPU at the quality run's configuration (pad 320: a 1024 x
1024 grid, filter 0.45), then through generatePOH's 3-plane focal stack
(0.4 to 1.0 mm, filter 0.35).  The port runs its fused branch (K1's plain
version on the CPU).

Gates, those of the seeded-weight slice test
(``tests/test_torch_models.py``): the POH as phasors, mean <= 2e-3, p99 <=
1e-2, max <= 5e-2; the focal stack <= 1e-3 at p99.9, 4e-3 worst.  The test
skips only where the file is absent (a checkout without ``output/``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import OpticsConfig as JaxOpticsConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, OpticsConfig
from learned_hologram_gan_tpu_torch.models import Generator, make_generator_plan
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.train import checkpoint as ckpt_lib
from test_torch_models import assert_poh_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATOR = os.path.join(REPO, "output", "quality_run", "generator.msgpack")
QUALITY = dict(rows=384, cols=384, pad_size=320, filter_radius_coefficient=0.45)
RECON = dict(QUALITY, filter_radius_coefficient=0.35)  # generatePOH's propagation filter
DISTANCES = np.linspace(4e-4, 1e-3, 3)  # generatePOH's --min/max_distance, 3 intervals


def test_quality_run_generator_matches_jax():
    if not os.path.exists(GENERATOR):
        pytest.skip(f"{GENERATOR} is not in this checkout")
    rgbd = np.random.default_rng(20260817).random((1, 4, 384, 384), dtype=np.float32)

    with open(GENERATOR, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    jcfg = JaxGenConfig(**QUALITY)
    jplan = jax_gen_plan(jcfg)
    jrecon = jasm.make_plan(JaxOpticsConfig(**RECON), distances=DISTANCES)

    @jax.jit
    def jax_forward(v, plan, recon, x):
        poh = JaxGenerator(jcfg).apply(v, plan, x, train=False)
        return poh, jasm.propagate_batch_multi(recon, jnp.ones_like(poh), poh)

    jpoh, jstack = (np.asarray(a) for a in jax_forward(
        jax.tree_util.tree_map(jnp.asarray, variables), jplan, jrecon, jnp.asarray(rgbd)))
    del variables

    cfg = GeneratorConfig(**QUALITY)
    model = Generator(cfg)
    ckpt_lib.load_weights(GENERATOR, model)
    model.eval()
    plan = make_generator_plan(cfg, device="cpu")
    recon = asm.make_plan(OpticsConfig(**RECON), distances=DISTANCES, device="cpu")
    assert asm._fused_ok(plan) and asm._fused_ok(recon)
    with torch.inference_mode():
        poh = model(plan, torch.from_numpy(rgbd))
        stack = asm.propagate_batch_multi(recon, torch.ones_like(poh), poh)

    assert tuple(poh.shape) == jpoh.shape == (1, 3, 384, 384)
    assert tuple(stack.shape) == jstack.shape == (3, 3, 384, 384)
    assert np.isfinite(jpoh).all() and torch.isfinite(poh).all()
    assert_poh_close(poh.numpy(), jpoh)
    d = np.abs(stack.numpy() - jstack)
    assert np.quantile(d, 0.999) <= 1e-3 and np.max(d) <= 4e-3, (np.quantile(d, 0.999), np.max(d))
