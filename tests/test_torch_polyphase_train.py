"""The port's polyphase level-0 UNet (training form) against the JAX
package's, on the CPU (the JAX package's own equivalence tests are
tests/test_polyphase.py).

``UNet(polyphase_level0=True)`` computes enc_0, the last up-conv, dec_0 and
the head in the space-to-depth phase domain from the plain modules'
parameters.  Bounds, with their reasons: the JAX tests' (3e-5 float32,
2e-2 bfloat16 for outputs; 1e-5 / 5e-3 for the running statistics); the
gradients to 1e-2 of the largest |g| of the net, the port's step bound,
since float32 rounding flips relu and max-pool ties between any two
programs (the JAX test measures ~1 % and proves its own gradients in
float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.nn import blocks as jblocks
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig
from learned_hologram_gan_tpu_torch.models import Generator
from learned_hologram_gan_tpu_torch.nn import blocks
from test_torch_models import assert_stats_close, jax_variables, nchw, to_jax

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 5e-3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(dtype="float32", size=16, levels=2, seed=31, remat=False):
    jdt, tdt, _, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).random((2, size, size, 4)).astype(np.float32)
    jm = jblocks.UNet(output_channels=6, base_features=4, levels=levels, dtype=jdt,
                      polyphase_level0=True)
    variables = jax_variables(jm, jnp.asarray(x, jdt), seed=seed, train=True)
    m = blocks.UNet(in_channels=4, output_channels=6, base_features=4, levels=levels, dtype=tdt,
                    polyphase_level0=True, remat=remat)
    m.load_state_dict(convert.generator_state_dict(variables))
    return jm, variables, m, x


def test_polyphase_state_dict_is_the_plain_one():
    """The same keys and shapes as the plain UNet and generator: a
    checkpoint loads into either."""
    plain = blocks.UNet(4, 6, base_features=4, levels=2)
    poly = blocks.UNet(4, 6, base_features=4, levels=2, polyphase_level0=True)
    assert {k: v.shape for k, v in plain.state_dict().items()} == \
        {k: v.shape for k, v in poly.state_dict().items()}
    poly.load_state_dict(plain.state_dict())
    cfg = dict(rows=16, cols=16, pad_size=4, unet_base_features=2)
    g_plain, g_poly = Generator(GeneratorConfig(**cfg)), Generator(GeneratorConfig(**cfg, polyphase_level0=True))
    assert list(g_plain.state_dict()) == list(g_poly.state_dict())
    assert g_poly.part1.unet.polyphase_level0 and not g_plain.part1.unet.polyphase_level0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_polyphase_forward_eval_matches_jax(dtype):
    jm, variables, m, x = _pair(dtype)
    jdt, _, tol, _ = DTYPES[dtype]
    want = jax.jit(lambda v, a: jm.apply(v, a, False))(to_jax(variables), jnp.asarray(x, jdt))
    with torch.no_grad():
        got = m.eval()(nchw(x)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_polyphase_forward_train_and_stats_match_jax(dtype):
    """Train mode: batch statistics over the phase axis too, the running
    statistics moved as flax moves them (biased variance, momentum 0.99)."""
    jm, variables, m, x = _pair(dtype)
    jdt, _, tol, stol = DTYPES[dtype]
    want, mut = jax.jit(lambda v, a: jm.apply(v, a, True, mutable=["batch_stats"]))(
        to_jax(variables), jnp.asarray(x, jdt))
    with torch.no_grad():
        got = m.train()(nchw(x)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)
    assert_stats_close(m, mut["batch_stats"], rtol=stol, atol=stol)


def test_polyphase_gradients_match_jax():
    """d sum(y * w) / d params in train mode (batch statistics), float32,
    within 1e-2 of the net's largest |g| (module docstring); the running
    statistics of the backward's forward as flax's."""
    jm, variables, m, x = _pair("float32")
    w = np.random.default_rng(33).standard_normal((2, 16, 16, 6)).astype(np.float32)

    def loss(params):
        y, mut = jm.apply({"params": params, "batch_stats": to_jax(variables["batch_stats"])},
                          jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w)), mut

    jgrads, mut = jax.jit(jax.grad(loss, has_aux=True))(to_jax(variables["params"]))
    want = convert.generator_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                         "batch_stats": variables["batch_stats"]})
    y = m.train()(nchw(x))
    (y * nchw(w)).sum().backward()
    scale = max(float(want[k].abs().max()) for k, _ in m.named_parameters())
    for k, p in m.named_parameters():
        assert float((p.grad - want[k]).abs().max()) <= 1e-2 * scale, k
    assert_stats_close(m, mut["batch_stats"])


def test_polyphase_remat_matches_plain_polyphase():
    """--remat with --polyphase_level0: the phase-domain blocks recomputed
    in the backward, bit for bit the polyphase forward's values and
    gradients, and the running statistics moved once."""
    _, variables, m, x = _pair("float32")
    _, _, mr, _ = _pair("float32", remat=True)
    outs = []
    for net in (m.train(), mr.train()):
        y = net(nchw(x))
        (y * y).sum().backward()
        outs.append((y.detach(), {k: p.grad.clone() for k, p in net.named_parameters()},
                     {k: v.clone() for k, v in net.state_dict().items()}))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for k in outs[0][1]:
        torch.testing.assert_close(outs[0][1][k], outs[1][1][k], rtol=0, atol=0, msg=k)
    for k in outs[0][2]:
        torch.testing.assert_close(outs[0][2][k], outs[1][2][k], rtol=0, atol=0, msg=k)


def test_polyphase_fallback_and_the_jax_tests_20px_case():
    """The JAX conditions: with one level the flag does nothing (the plain
    forward, bit for bit); at 20 x 20 (even, phase domain active) the
    polyphase UNet equals the plain one at 3e-5, as tests/test_polyphase.py
    pins."""
    rng = np.random.default_rng(35)
    plain1 = blocks.UNet(4, 2, base_features=4, levels=1).eval()
    poly1 = blocks.UNet(4, 2, base_features=4, levels=1, polyphase_level0=True).eval()
    poly1.load_state_dict(plain1.state_dict())
    x = torch.from_numpy(rng.random((1, 4, 20, 20)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(poly1(x), plain1(x), rtol=0, atol=0)
    plain = blocks.UNet(4, 2, base_features=4, levels=2).eval()
    poly = blocks.UNet(4, 2, base_features=4, levels=2, polyphase_level0=True).eval()
    blocks.init_weights(plain, torch.Generator().manual_seed(36))
    poly.load_state_dict(plain.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(poly(x).numpy(), plain(x).numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_parallel_smoke_polyphase_and_batch_norm_gates_on_cpu(dtype):
    """chip_smoke's polyphase gate (the UNet's level 0, polyphase against
    plain, at its bounds) and, in float32, its BatchNorm gate
    (``_BatchNormF32`` against ``F.batch_norm`` to second derivatives, the
    phase-domain layout included) at 16 x 16, base 2 on the CPU."""
    from learned_hologram_gan_tpu_torch import parallel_smoke as ps

    inputs = ps.seeded_inputs(rows=16, pad=8, batch=4, ratio=2, distances=6, base=2, feature_d=2)
    got = ps.unet_poly_leg("cpu", dtype, inputs, torch.device("cpu"))
    e = got["zero-mean"]
    assert e["outputs"] <= ps.POLY_OUT[dtype] and e["stats"] <= ps.POLY_STATS[dtype]
    assert e["grads"] <= ps.POLY_GRADS[dtype]
    if dtype == "float32":
        bn = ps.batch_norm_leg("cpu", {(4, 8, 8, 8), (8, 16, 4, 4), (4, 32, 1, 1)}, torch.device("cpu"))
        assert bn["cases"] == 4 and bn["worst"] <= ps.BN_TOL
