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
from learned_hologram_gan_tpu_torch.ops.cuda import fft, spectral

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


# (conj_h, from_spectrum, per_plane, num_d, mask): the two inference
# modes, the eval step's from_spectrum stack, the train step's random
# distances (from_spectrum + per_plane) and the two-H hat path's (field
# input + per_plane, with a caller's mask in place of the plan's).  mask:
# None, "plan", or "override": the plan's mask times a seeded field in
# [0.5, 1], a product mask as the hat path's is, not symmetric, so that a
# mask read at the wrong (row, column) shows
PLANE_MODES = {
    "backward_d1_nomask": (True, False, False, 1, None),
    "forward_d3_mask": (False, False, False, 3, "plan"),
    "from_spectrum_d3_mask": (False, True, False, 3, "plan"),
    "from_spectrum_per_plane_mask": (False, True, True, 1, "plan"),
    "field_per_plane_mask_override": (False, False, True, 1, "override"),
}


def _mode_inputs(mode, seed=3):
    conj_h, from_spectrum, per_plane, num_d, mask_kind = PLANE_MODES[mode]
    rows, cols, pad = 24, 32, 4
    optics = JaxOptics(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45)
    rp, cp = optics.padded_rows, optics.padded_cols
    shape = (rp, cp) if from_spectrum else (rows, cols)
    fr, fi, wl2, _ = _planes_inputs(seed, 6, *shape, 1)
    n_dists = 6 if per_plane else num_d
    dists = np.linspace(4e-4, 1e-3, n_dists).astype(np.float32)[:, None]
    mask = None if mask_kind is None else np.asarray(jasm.make_plan(optics).mask)
    if mask_kind == "override":
        mask = (mask * np.random.default_rng(seed + 10).uniform(0.5, 1.0, (rp, cp))).astype(np.float32)
    cfg = (PITCH, conj_h, from_spectrum, per_plane, num_d, rp, cp, (pad, rows, optics.pad_cols, cols))
    return fr, fi, wl2, dists, mask, cfg


def _jax_planes(args):
    *arrays, cfg = args
    return jax.jit(lambda *a: jspectral.propagate_planes(*a, cfg))(
        *(None if a is None else jnp.asarray(a) for a in arrays))


def _torch(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


@pytest.mark.parametrize("mode", list(PLANE_MODES))
def test_propagate_planes_plain_matches_jax_interpret(mode):
    """K1's plain version against JAX ``spectral.propagate_planes`` (Pallas
    interpret mode) in every mode the slices run."""
    args = _mode_inputs(mode)
    num_d = args[-1][4]
    jr, ji = _jax_planes(args)
    tr, ti = spectral.propagate_planes(*(_torch(a) for a in args[:-1]), args[-1])
    assert tr.shape == (6, num_d, 24, 32)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    got = tr.numpy() + 1j * ti.numpy()
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) / scale <= 5e-5
    assert_close(got.real, want.real)
    assert_close(got.imag, want.imag)


@pytest.mark.parametrize("mode", list(PLANE_MODES))
def test_propagate_planes_backward_matches_jax_vjp(mode):
    """K2's plain version (the backward of the port's autograd Function)
    against ``jax.vjp`` of JAX ``propagate_planes`` (interpret mode) and
    against torch.autograd through K1's plain forward, on one cotangent.
    Relative to max |grad|: the JAX side's split-bf16 GEMMs, ~1e-5."""
    fr, fi, wl2, dists, mask, cfg = _mode_inputs(mode, seed=4)
    rng = np.random.default_rng(5)
    out_shape = (6, cfg[4], 24, 32)
    gr = rng.standard_normal(out_shape).astype(np.float32)
    gi = rng.standard_normal(out_shape).astype(np.float32)
    consts = [None if a is None else jnp.asarray(a) for a in (wl2, dists, mask)]
    _, vjp = jax.vjp(lambda a, b: jspectral.propagate_planes(a, b, *consts, cfg),
                     jnp.asarray(fr), jnp.asarray(fi))
    jdr, jdi = jax.jit(vjp)((jnp.asarray(gr), jnp.asarray(gi)))
    want = np.asarray(jdr) + 1j * np.asarray(jdi)

    tfr, tfi = _torch(fr, True), _torch(fi, True)
    rest = [_torch(a) for a in (wl2, dists, mask)]
    outr, outi = spectral.propagate_planes(tfr, tfi, *rest, cfg)
    tgr, tgi = torch.from_numpy(gr), torch.from_numpy(gi)
    dr, di = torch.autograd.grad((outr * tgr + outi * tgi).sum(), (tfr, tfi))
    got = dr.numpy() + 1j * di.numpy()
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) / scale <= 5e-5

    pr, pi = spectral.propagate_planes_reference(tfr, tfi, *rest, cfg)
    ar, ai = torch.autograd.grad((pr * tgr + pi * tgi).sum(), (tfr, tfi))
    assert np.max(np.abs(ar.numpy() + 1j * ai.numpy() - got)) / scale <= 1e-6


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


# ---------------------------------------------------------------------------
# K3: fft2 / ifft2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True], ids=["fft2", "ifft2"])
def test_fft2_function_matches_numpy_and_torch_autograd(inverse):
    """K3's Function on the CPU (its plain version): the forward against
    numpy.fft, the backward against torch.fft's own autograd (torch's
    complex convention: fft2's backward is N * ifft2)."""
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((2, 3, 16, 8)) + 1j * rng.standard_normal((2, 3, 16, 8))).astype(np.complex64)
    g = (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    ours, ref, npf = ((fft.ifft2, torch.fft.ifft2, np.fft.ifft2) if inverse
                      else (fft.fft2, torch.fft.fft2, np.fft.fft2))
    assert fft.supported(16, 8)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ours(xt)
    np.testing.assert_allclose(y.detach().numpy(), npf(x.astype(np.complex128)), rtol=0,
                               atol=1e-5 * np.abs(npf(x)).max())
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    (gx_ref,) = torch.autograd.grad(ref(xt), xt, torch.from_numpy(g))
    torch.testing.assert_close(gx, gx_ref, rtol=1e-5, atol=1e-5 * float(gx_ref.abs().max()))


def test_fft2_gradcheck_float64():
    x = torch.randn(2, 8, 4, dtype=torch.complex128, generator=torch.Generator().manual_seed(41),
                    requires_grad=True)
    assert torch.autograd.gradcheck(fft.fft2, (x,))
    assert torch.autograd.gradcheck(fft.ifft2, (x,))


def test_k3_support_predicate():
    assert fft.supported(1024, 1024) and fft.supported(64, 2)
    assert not fft.supported(34, 32)  # not a power of two: torch.fft, by predicate
    assert not fft.supported(65536, 64)  # one line would overflow shared memory
    x = torch.ones((1, 34, 32), dtype=torch.complex64)
    torch.testing.assert_close(fft.fft2(x), torch.fft.fft2(x))


# ---------------------------------------------------------------------------
# The training slice's spectrum primitives, drawn indices injected
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("grid", ["fused", "composable"])
def test_spectrum_primitives_match_jax(grid, backend):
    """propagate_poh2freq_forward, filter_ap2filtered_freq,
    freq2ap_all_distances and freq2ap_random_distances, with JAX's drawn
    distance indices handed to the port."""
    distances = np.linspace(-4e-4, 0.0, 5)[:-1]
    jplan, plan = _plans(grid, distances)
    jgen, gen = _plans(grid, [1e-3])
    amp, phs = _fields(grid, 15)
    _, poh = _fields(grid, 16)
    key = jax.random.key(17)

    def jax_side(jgen, jplan, poh, amp, phs, key):
        hat = jasm.propagate_poh2freq_forward(jgen, poh)
        tgt = jasm.filter_ap2filtered_freq(jplan, amp, phs / (2 * np.pi))
        both = jnp.concatenate([hat, tgt])
        return hat, tgt, jasm.freq2ap_all_distances(jplan, both), jasm.freq2ap_random_distances(jplan, both, key)

    jhat, jtgt, (jall_a, jall_p), (jr_a, jr_p) = _on_backend(
        backend, jax_side, jgen, jplan, jnp.asarray(poh), jnp.asarray(amp), jnp.asarray(phs), key)
    idx = torch.from_numpy(np.asarray(jax.random.permutation(key, len(distances))[:2]))

    hat = asm.propagate_poh2freq_forward(gen, torch.from_numpy(poh))
    tgt = asm.filter_ap2filtered_freq(plan, torch.from_numpy(amp), torch.from_numpy(phs) / (2 * np.pi))
    scale = np.abs(np.asarray(jhat)).max()
    assert np.abs(hat.numpy() - np.asarray(jhat)).max() <= 1e-5 * scale
    assert np.abs(tgt.numpy() - np.asarray(jtgt)).max() <= 1e-5 * np.abs(np.asarray(jtgt)).max()
    both = torch.cat([hat, tgt])
    for (a, p), (ja, jp) in (
        (asm.freq2ap_all_distances(plan, both), (jall_a, jall_p)),
        (asm.freq2ap_random_distances(plan, both, idx), (jr_a, jr_p)),
    ):
        ja, jp = np.asarray(ja), np.asarray(jp)
        assert a.shape == ja.shape
        assert_close(a.numpy(), ja)
        d = np.abs(np.exp(1j * p.numpy()) - np.exp(1j * jp))
        assert np.max(d[ja > 1e-3 * ja.max()]) <= 2e-2


def test_random_distance_draw():
    _, plan = _plans("fused", np.linspace(-4e-4, 0.0, 5)[:-1])
    idx = asm.draw_distance_indices(plan, 3, torch.Generator().manual_seed(0))
    assert idx.shape == (3,) and len(set(idx.tolist())) == 3 and int(idx.max()) < 4
    with pytest.raises(ValueError, match="batch <= num_distances"):
        asm.draw_distance_indices(plan, 5)
