"""The port's high-resolution levers against the JAX package, on the CPU:
``utils/fftlen``, ``pad_cols_override``, plans without a cached transfer
function (``cache_h=False``) and the ``sequential`` distance mode.

Inputs come from seeded numpy.  The JAX side runs compiled on its ``xla``
FFT backend, as tests/test_torch_ops.py runs it.  Two grids: a power of
two (the port's fused branch, K1's plain version) and a grid that is not
(24 x 36 through ``pad_cols_override``: the composable ``torch.fft``
branch, which the 1080p and 4K grids take).

Tolerances, with their reasons:
  * the port against itself, cached H against H on the fly: bit for bit
    (the same float32 operations on the same w-grid);
  * the port against JAX: the propagation gate of tests/test_torch_ops.py,
    1e-3 at p99.9 and 4e-3 worst (FFT rounding, cos/sin of phases ~1e4 rad);
  * sequential against the fused or batched path of the port: 1e-6 of the
    largest value (the same spectrum products; only the FFT's batching and,
    on the fused grid, K1's plain version against torch.fft differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import OpticsConfig as JaxOptics
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.utils import fftlen as jfftlen
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, OpticsConfig
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.utils import fftlen
from test_torch_ops import _on_backend, assert_close
from test_torch_tools import one_torch_thread  # noqa: F401

# (rows, cols, minimum row pad): the 1080p and 4K training / evaluation
# geometries, the portrait grid (640 x 384 at pad 320), the quality run's
# 384^2 and the reference's 192^2
GEOMETRIES = [(1088, 1920, 320), (2176, 3840, 320), (640, 384, 320), (384, 384, 320),
              (192, 192, 160), (544, 960, 320), (1080, 1920, 300)]


@pytest.mark.parametrize("rows,cols,pad", GEOMETRIES, ids=lambda v: str(v))
def test_good_fft_pads_match_jax(rows, cols, pad):
    got = fftlen.good_fft_pads(rows, cols, pad)
    assert got == jfftlen.good_fft_pads(rows, cols, pad)
    assert fftlen.is_smooth(rows + 2 * got[0]) and fftlen.is_smooth(cols + 2 * got[1])


def test_fftlen_named_geometries_and_sweep():
    assert fftlen.good_fft_pads(2176, 3840, 320) == (352, 580)
    assert fftlen.good_fft_pads(1088, 1920, 320) == (320, 576)
    for n in range(1, 2000):
        assert fftlen.is_smooth(n) == jfftlen.is_smooth(n), n
        assert fftlen.next_fast_len(n) == jfftlen.next_fast_len(n), n
    assert fftlen.is_smooth(21, primes=(3, 7)) and not fftlen.is_smooth(4968)


@pytest.mark.parametrize("override", [None, 580, 7])
def test_pad_cols_override_geometry_matches_jax(override):
    o = dict(rows=2176, cols=3840, pad_size=352, pad_cols_override=override)
    got, want = OpticsConfig(**o), JaxOptics(**o)
    assert (got.pad_rows, got.pad_cols, got.padded_rows, got.padded_cols) == (
        want.pad_rows, want.pad_cols, want.padded_rows, want.padded_cols)
    g = dict(rows=16, cols=24, pad_size=4, pad_cols_override=override, remat=True)
    assert GeneratorConfig(**g).optics() == OpticsConfig(rows=16, cols=24, pad_size=4,
                                                         pad_cols_override=override)
    assert GeneratorConfig(**g).optics().pad_cols == JaxGenConfig(**g).optics().pad_cols


# rows, cols, pad, pad_cols_override: 32 x 32 (K1's fused branch) and 24 x 36
GRIDS = {"fused": (16, 16, 8, None), "override": (16, 24, 4, 6)}
DISTANCES = np.linspace(-4e-4, 0.0, 5)[:-1]


def _optics(grid):
    rows, cols, pad, pc = GRIDS[grid]
    o = dict(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45, pad_cols_override=pc)
    return JaxOptics(**o), OpticsConfig(**o)


def _plans(grid, distances, cache_h):
    jo, o = _optics(grid)
    jplan = jasm.make_plan(jo, distances=distances, cache_h=cache_h)
    plan = asm.make_plan(o, distances=distances, device="cpu", cache_h=cache_h)
    assert asm._fused_ok(plan) == (grid == "fused")
    assert (plan.H is None) == (not cache_h)
    return jplan, plan


def _inputs(grid, seed, batch=2):
    rows, cols, _, _ = GRIDS[grid]
    rng = np.random.default_rng(seed)
    amp = rng.random((batch, 3, rows, cols)).astype(np.float32)
    phs = rng.random((batch, 3, rows, cols)).astype(np.float32)
    poh = (rng.random((batch, 3, rows, cols)) * 2 * np.pi).astype(np.float32)
    return amp, phs, poh


def _prim_batch_multi(m, gen, multi, amp, phs, poh, key):
    return (m.propagate_batch_multi(multi, amp, phs * 2 * np.pi),)


def _prim_poh2freq(m, gen, multi, amp, phs, poh, key):
    return (m.propagate_poh2freq_forward(gen, poh),)


def _prim_freq2ap_all(m, gen, multi, amp, phs, poh, key):
    return m.freq2ap_all_distances(multi, m.filter_ap2filtered_freq(multi, amp, phs))


def _prim_freq2ap_random(m, gen, multi, amp, phs, poh, key):
    cat = jnp.concatenate if m is jasm else torch.cat
    both = cat([m.propagate_poh2freq_forward(gen, poh), m.filter_ap2filtered_freq(multi, amp, phs)])
    return m.freq2ap_random_distances(multi, both, key)


def _prim_hat_target(m, gen, multi, amp, phs, poh, key):
    return m.hat_target_random_distances(gen, multi, poh, amp, phs, key)


PRIMITIVES = {"propagate_batch_multi": _prim_batch_multi,
              "propagate_poh2freq_forward": _prim_poh2freq,
              "freq2ap_all_distances": _prim_freq2ap_all,
              "freq2ap_random_distances": _prim_freq2ap_random,
              "hat_target_random_distances": _prim_hat_target}


def _run_port(prim, grid, cache_h, amp, phs, poh, idx):
    _, gen = _plans(grid, [1e-3], cache_h)
    _, multi = _plans(grid, DISTANCES, cache_h)
    return [o.numpy() for o in PRIMITIVES[prim](asm, gen, multi, *(torch.from_numpy(a) for a in (amp, phs, poh)),
                                                torch.from_numpy(idx))]


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("prim", list(PRIMITIVES))
def test_uncached_h_equals_cached_and_matches_jax(prim, grid):
    """``cache_h=False``: the port's outputs equal its cached-H outputs bit
    for bit, and JAX's ``cache_h=False`` outputs within the propagation
    gate (amplitudes; phases as phasors where the amplitude is not tiny)."""
    amp, phs, poh = _inputs(grid, 31)
    key = jax.random.key(32)
    idx = np.array(jax.random.permutation(key, len(DISTANCES))[:2])
    got = _run_port(prim, grid, False, amp, phs, poh, idx)
    cached = _run_port(prim, grid, True, amp, phs, poh, idx)
    for a, b in zip(got, cached):
        np.testing.assert_array_equal(a, b)

    jgen, _ = _plans(grid, [1e-3], False)
    jmulti, _ = _plans(grid, DISTANCES, False)
    want = _on_backend("xla", lambda *a: PRIMITIVES[prim](jasm, jgen, jmulti, *a),
                       *(jnp.asarray(x) for x in (amp, phs, poh)), key)
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    if prim == "propagate_poh2freq_forward":  # a spectrum, compared relative to its largest value
        assert np.abs(got[0] - want[0]).max() <= 1e-5 * np.abs(want[0]).max()
        return
    n_amp = len(got) // 2 if len(got) > 1 else 1  # amplitudes first, then phases
    for g, w in zip(got[:n_amp], want[:n_amp]):
        assert g.shape == w.shape
        assert_close(g, w)
    for g, w, a in zip(got[n_amp:], want[n_amp:], want[:n_amp]):
        d = np.abs(np.exp(1j * g.astype(np.float64)) - np.exp(1j * w.astype(np.float64)))
        assert np.max(d[a > 1e-3 * a.max()]) <= 2e-2


@pytest.mark.parametrize("grid", list(GRIDS))
def test_transfer_function_is_the_plans_stack(grid):
    jplan, plan = _plans(grid, DISTANCES, True)
    _, lean = _plans(grid, DISTANCES, False)
    h = asm.transfer_function(lean, DISTANCES)
    assert torch.equal(h, plan.H) and torch.equal(asm._h_stack(lean), plan.H)
    assert torch.equal(asm._fixed_h(lean), plan.H[0])
    assert np.abs(h.numpy() - np.asarray(jasm.transfer_function(jplan, jnp.asarray(DISTANCES)))).max() <= 2e-6
    with pytest.raises(ValueError, match="distance stack"):
        asm._h_stack(asm.make_plan(_optics(grid)[1], device="cpu", cache_h=False))


@pytest.mark.parametrize("cache_h", [True, False], ids=["cached", "on_the_fly"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_sequential_matches_jax_and_the_batched_path(grid, cache_h):
    """``sequential=True`` in propagate_batch_multi (plan stack and explicit
    distances) and freq2ap_all_distances: against JAX's sequential mode
    (the gate) and against the port's own non-sequential path (1e-6)."""
    jplan, plan = _plans(grid, DISTANCES, cache_h)
    amp, phs, _ = _inputs(grid, 33)
    jamp, jphs = jnp.asarray(amp), jnp.asarray(phs * 2 * np.pi)
    tamp, tphs = torch.from_numpy(amp), torch.from_numpy(phs * 2 * np.pi)
    zs = np.asarray([3e-4, -1e-4, 5e-5], np.float32)

    def jax_side(p, a, f, z):
        g0 = jasm.filter_ap2filtered_freq(p, a, f / (2 * np.pi))
        return (jasm.propagate_batch_multi(p, a, f, sequential=True),
                jasm.propagate_batch_multi(p, a, f, z, sequential=True),
                *jasm.freq2ap_all_distances(p, g0, sequential=True))

    want = [np.asarray(w) for w in _on_backend("xla", jax_side, jplan, jamp, jphs, jnp.asarray(zs))]
    g0 = asm.filter_ap2filtered_freq(plan, tamp, tphs / (2 * np.pi))
    got = [asm.propagate_batch_multi(plan, tamp, tphs, sequential=True),
           asm.propagate_batch_multi(plan, tamp, tphs, torch.from_numpy(zs), sequential=True),
           *asm.freq2ap_all_distances(plan, g0, sequential=True)]
    batched = [asm.propagate_batch_multi(plan, tamp, tphs),
               asm.propagate_batch_multi(plan, tamp, tphs, torch.from_numpy(zs)),
               *asm.freq2ap_all_distances(plan, g0)]
    for i, (g, w, b) in enumerate(zip(got, want, batched)):
        assert g.shape == w.shape == b.shape
        if i < 3:  # amplitudes
            assert_close(g.numpy(), w)
            assert float((g - b).abs().max()) <= 1e-6 * float(b.abs().max())
        else:  # phases, as phasors where the amplitude is not tiny
            a = got[2].numpy()
            keep = a > 1e-3 * a.max()
            for other in (w, b.numpy()):
                d = np.abs(np.exp(1j * g.numpy().astype(np.float64)) - np.exp(1j * other.astype(np.float64)))
                assert np.max(d[keep]) <= (2e-2 if other is w else 1e-4)


def test_sequential_carries_gradients():
    """The sequential stack is differentiable, and its gradient is the
    batched stack's."""
    _, plan = _plans("override", DISTANCES, False)
    amp, phs, _ = (torch.from_numpy(a) for a in _inputs("override", 34))
    grads = []
    for sequential in (False, True):
        a = amp.clone().requires_grad_(True)
        asm.propagate_batch_multi(plan, a, phs, sequential=sequential).square().sum().backward()
        grads.append(a.grad)
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * float(grads[0].abs().max())


def test_batch_norm_of_one_value_per_channel_matches_flax():
    """A batch-1 fine-tune at a small size puts one value per channel
    through the UNet's 1 x 1 bottleneck in train mode: flax normalizes it
    to the bias (zero batch variance), where ``F.batch_norm`` refuses it.
    The output, its gradient and the running-stat update match flax."""
    import flax.linen as fnn

    from learned_hologram_gan_tpu_torch.nn.blocks import BatchNorm

    rng = np.random.default_rng(35)
    x = rng.standard_normal((1, 1, 1, 5)).astype(np.float32)
    scale, bias = (rng.standard_normal(5).astype(np.float32) for _ in range(2))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.full(5, 0.3), "var": jnp.full(5, 2.0)}}

    def jax_loss(params, xx):
        y, mut = jbn.apply({**variables, "params": params}, xx, mutable=["batch_stats"])
        return jnp.sum(y * jnp.arange(1.0, 6.0)), (y, mut["batch_stats"])

    (_, (want, stats)), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(variables["params"], jnp.asarray(x))
    bn = BatchNorm(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(2.0)
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    (got * torch.arange(1.0, 6.0)[None, :, None, None]).sum().backward()
    np.testing.assert_allclose(got.detach().reshape(5).numpy(), np.asarray(want).reshape(5), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jgrad["bias"]), rtol=1e-6)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jgrad["scale"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
