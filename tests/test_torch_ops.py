"""The port's propagation operators against the JAX package, on the CPU.

Inputs come from seeded numpy and go through both packages.  The JAX side
runs as its own tests run it, compiled with ``jax.jit``:
``asm.set_fft_backend("xla")`` for the composable path and ``"pallas"`` for
the fused path, whose ``spectral.propagate_planes`` runs in interpret mode
here.  On a CPU tensor
the port's ``propagate_planes`` takes its plain version (kernel K1 itself
needs the card: tests/test_torch_cuda.py).

Tolerance (tests/test_parity_torch.py:9-16): <= 1e-3 at the 99.9th
percentile plus a small absolute worst case.  The JAX fused path runs its
DFTs as split-bf16 GEMMs (~1e-6 relative), so the values below sit far
inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import OpticsConfig as JaxOptics
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.ops import masks as jmasks
from learned_hologram_gan_tpu.ops.pallas import spectral as jspectral
from learned_hologram_gan_tpu_torch.config import OpticsConfig
from learned_hologram_gan_tpu_torch.ops import asm, masks
from learned_hologram_gan_tpu_torch.ops.cuda import spectral

WL = (638e-9, 520e-9, 450e-9)
PITCH = 3.74e-6


def assert_close(got, want, p999=1e-3, worst=4e-3):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert np.quantile(d, 0.999) <= p999, np.quantile(d, 0.999)
    assert np.max(d) <= worst, np.max(d)


def _on_backend(backend, fn, *args):
    """``fn(*args)`` compiled under the JAX FFT backend ``backend`` (a fresh
    function each time, so no trace is reused across backends)."""
    prev = jasm.get_fft_backend()
    try:
        jasm.set_fft_backend(backend)
        return jax.jit(lambda *a: fn(*a))(*args)
    finally:
        jasm.set_fft_backend(prev)


@pytest.mark.parametrize("rows,cols", [(32, 32), (24, 40)])
def test_masks_match_jax(rows, cols):
    np.testing.assert_array_equal(
        masks.radial_frequency_grid(rows, cols).numpy(),
        np.asarray(jmasks.radial_frequency_grid(rows, cols)),
    )
    np.testing.assert_array_equal(
        masks.circular_frequency_mask(rows, cols, 0.45 * min(rows, cols)).numpy(),
        np.asarray(jmasks.circular_frequency_mask(rows, cols, 0.45 * min(rows, cols))),
    )
    for invert in (False, True):
        np.testing.assert_array_equal(
            masks.checkerboard_mask(rows, cols, cell_size=1, invert=invert).numpy(),
            np.asarray(jmasks.checkerboard_mask(rows, cols, cell_size=1, invert=invert)),
        )
    with pytest.raises(ValueError):
        masks.circular_frequency_mask(rows, cols, min(rows, cols))


@pytest.mark.parametrize("rows,cols,pad", [(24, 32, 4), (384, 384, 320)])
def test_w_grid_and_transfer_function_match_jax(rows, cols, pad):
    """The w-grid is bit-identical (same numpy f32 op order); H agrees to
    float32 cos/sin rounding at phases up to ~1.4e4 rad."""
    o = dict(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45)
    jplan = jasm.make_plan(JaxOptics(**o), distances=[1e-3])
    plan = asm.make_plan(OpticsConfig(**o), distances=[1e-3], device="cpu")
    np.testing.assert_array_equal(plan.w_grid.numpy(), np.asarray(jplan.w_grid))
    np.testing.assert_array_equal(plan.mask.numpy(), np.asarray(jplan.mask))
    h = plan.H.numpy()
    jh = np.asarray(jplan.H)
    assert h.shape == jh.shape
    assert np.max(np.abs(h - jh)) <= 2e-6


def _planes_inputs(seed, p, rows, cols, num_d):
    rng = np.random.default_rng(seed)
    fr = rng.standard_normal((p, rows, cols)).astype(np.float32)
    fi = rng.standard_normal((p, rows, cols)).astype(np.float32)
    wl2 = np.tile((1.0 / np.asarray(WL, np.float32) ** 2).astype(np.float32), p // 3)[:, None]
    dists = np.linspace(4e-4, 1e-3, num_d).astype(np.float32)[:, None]
    return fr, fi, wl2, dists


@pytest.mark.parametrize(
    "conj_h,num_d,use_mask",
    [(True, 1, False), (False, 3, True)],
    ids=["backward_d1_nomask", "forward_d3_mask"],
)
def test_propagate_planes_plain_matches_jax_interpret(conj_h, num_d, use_mask):
    """K1's plain version against JAX ``spectral.propagate_planes`` (Pallas
    interpret mode) in both main-path modes."""
    rows, cols, pad = 24, 32, 4
    optics = JaxOptics(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45)
    rp, cp = optics.padded_rows, optics.padded_cols
    fr, fi, wl2, dists = _planes_inputs(3, 6, rows, cols, num_d)
    mask = np.asarray(jasm.make_plan(optics).mask) if use_mask else None
    cfg = (PITCH, conj_h, False, False, num_d, rp, cp, (pad, rows, optics.pad_cols, cols))
    jr, ji = jax.jit(lambda *a: jspectral.propagate_planes(*a, cfg))(
        jnp.asarray(fr), jnp.asarray(fi), jnp.asarray(wl2), jnp.asarray(dists),
        None if mask is None else jnp.asarray(mask),
    )
    tr, ti = spectral.propagate_planes(
        torch.from_numpy(fr), torch.from_numpy(fi), torch.from_numpy(wl2),
        torch.from_numpy(dists), None if mask is None else torch.from_numpy(mask), cfg,
    )
    assert tr.shape == (6, num_d, rows, cols)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    got = tr.numpy() + 1j * ti.numpy()
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) / scale <= 5e-5
    assert_close(got.real, want.real)
    assert_close(got.imag, want.imag)


def test_propagate_planes_refuses_training_modes():
    fr, fi, wl2, dists = _planes_inputs(0, 3, 8, 8, 1)
    args = [torch.from_numpy(a) for a in (fr, fi, wl2, dists)]
    for from_spectrum, per_plane in ((True, False), (False, True)):
        cfg = (PITCH, False, from_spectrum, per_plane, 1, 16, 16, (4, 8, 4, 8))
        with pytest.raises(NotImplementedError):
            spectral.propagate_planes(*args, None, cfg)


def test_k1_support_predicate():
    assert spectral.supported(1024, 1024)
    assert spectral.supported(32, 42)
    assert not spectral.supported(34, 34)  # not a power of two: composable path
    assert not spectral.supported(65536, 1024)  # shared memory would overflow


# Grids: (24, 32, pad 4) pads to 32 x 42, which the port runs fused (K1's
# plain version on the CPU); (24, 24, pad 5) pads to 34 x 34, which it runs
# composable.  The JAX side runs each on both of its backends.
GRIDS = {"fused": (24, 32, 4), "composable": (24, 24, 5)}


def _plans(grid, distances):
    rows, cols, pad = GRIDS[grid]
    o = dict(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45)
    jplan = jasm.make_plan(JaxOptics(**o), distances=distances)
    plan = asm.make_plan(OpticsConfig(**o), distances=distances, device="cpu")
    assert asm._fused_ok(plan) == (grid == "fused")
    return jplan, plan


def _fields(grid, seed, batch=2):
    rows, cols, _ = GRIDS[grid]
    rng = np.random.default_rng(seed)
    amp = rng.random((batch, 3, rows, cols)).astype(np.float32)
    phs = (rng.random((batch, 3, rows, cols)) * 2 * np.pi).astype(np.float32)
    return amp, phs


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("grid", ["fused", "composable"])
def test_ap2c_backward_matches_jax(grid, backend):
    jplan, plan = _plans(grid, [1e-3])
    amp, phs = _fields(grid, 11)
    want = np.asarray(_on_backend(
        backend, jasm.propagate_ap2c_backward, jplan, jnp.asarray(amp), jnp.asarray(phs)
    ))
    got = asm.propagate_ap2c_backward(plan, torch.from_numpy(amp), torch.from_numpy(phs))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert_close(got.numpy().real, want.real)
    assert_close(got.numpy().imag, want.imag)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("grid", ["fused", "composable"])
def test_batch_multi_matches_jax(grid, backend):
    distances = np.linspace(4e-4, 1e-3, 3)
    jplan, plan = _plans(grid, distances)
    amp, phs = _fields(grid, 12)
    want = np.asarray(_on_backend(
        backend, jasm.propagate_batch_multi, jplan, jnp.asarray(amp), jnp.asarray(phs)
    ))
    got = asm.propagate_batch_multi(plan, torch.from_numpy(amp), torch.from_numpy(phs))
    assert tuple(got.shape) == want.shape == (6, 3) + amp.shape[-2:]
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("grid", ["fused", "composable"])
def test_poh2ap_forward_matches_jax(grid, backend):
    jplan, plan = _plans(grid, [1e-3])
    _, poh = _fields(grid, 13)
    ja, jp = _on_backend(backend, jasm.propagate_poh2ap_forward, jplan, jnp.asarray(poh))
    a, p = asm.propagate_poh2ap_forward(plan, torch.from_numpy(poh))
    assert_close(a.numpy(), np.asarray(ja))
    # phases compared as phasors where the amplitude is not tiny
    d = np.abs(np.exp(1j * p.numpy()) - np.exp(1j * np.asarray(jp)))
    assert np.max(d[np.asarray(ja) > 1e-3]) <= 2e-2


def test_batch_multi_explicit_distances_match_plan_stack():
    """Passing the distance stack explicitly computes H on the fly and must
    give the cached-stack result."""
    distances = np.linspace(4e-4, 1e-3, 3)
    for grid in GRIDS:
        _, plan = _plans(grid, distances)
        amp, phs = (torch.from_numpy(a) for a in _fields(grid, 14))
        a = asm.propagate_batch_multi(plan, amp, phs)
        b = asm.propagate_batch_multi(plan, amp, phs, torch.tensor(distances, dtype=torch.float32))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
