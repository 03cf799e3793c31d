"""The port's serving and base propagation primitives against the JAX
package, on the CPU: ``freq2amp_at`` (the focal stack at request-chosen
distances), ``propagate`` (with and without one distance per sample),
``propagate_p2i`` and ``propagate_ap2ap``.

Seeded numpy inputs go through both packages; the JAX side runs compiled,
under its ``xla`` FFT backend (the composable chain) and its ``pallas`` one
(``spectral.propagate_planes`` in interpret mode on the grid it fuses),
as tests/test_torch_ops.py runs it.  On a CPU tensor the port's K1 wrapper
takes its plain version.

Tolerance: the propagation bound of tests/test_parity_torch.py, <= 1e-3 at
the 99.9th percentile and 4e-3 worst, on amplitudes; phases as phasors
where the amplitude is above 1e-3, within 2e-2 (tests/test_torch_ops.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu_torch.ops import asm
from test_torch_ops import GRIDS, _fields, _on_backend, _plans, assert_close

BACKENDS = ["xla", "pallas"]
PLAN_DISTANCES = np.linspace(4e-4, 1e-3, 3)
# three depths that are not the plan's, one of them negative
OTHER_DISTANCES = np.array([-5e-4, 2.3e-4, 1.3e-3], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_phase_close(got, want, amp):
    d = np.abs(np.exp(1j * np.asarray(got, np.float64)) - np.exp(1j * np.asarray(want, np.float64)))
    assert np.max(d[np.asarray(amp) > 1e-3]) <= 2e-2


@pytest.mark.parametrize("distances", ["plan", "other", "one"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_freq2amp_at_matches_jax(grid, backend, distances):
    """The same padded spectrum (a POH's, from the JAX package) to the
    plan's depths, to three others, and to one, through both packages."""
    jplan, plan = _plans(grid, [1e-3])
    _, poh = _fields(grid, 21)
    spectrum = np.asarray(jasm.propagate_poh2freq_forward(jplan, jnp.asarray(poh)))
    d = {"plan": PLAN_DISTANCES.astype(np.float32), "other": OTHER_DISTANCES,
         "one": OTHER_DISTANCES[1:2]}[distances]
    want = np.asarray(_on_backend(backend, jasm.freq2amp_at, jplan, jnp.asarray(spectrum), jnp.asarray(d)))
    got = asm.freq2amp_at(plan, t(spectrum), t(d)).numpy()
    assert got.shape == want.shape == (2, len(d), 3) + poh.shape[-2:]
    assert_close(got, want)


def test_freq2amp_at_takes_a_list_and_matches_its_composable_branch():
    """Distances as a Python list reach the same result; the fused branch
    (K1's plain version) against the torch.fft chain on one grid."""
    _, plan = _plans("fused", [1e-3])
    _, poh = _fields("fused", 22)
    spectrum = asm.propagate_poh2freq_forward(plan, t(poh))
    fused = asm.freq2amp_at(plan, spectrum, OTHER_DISTANCES.tolist())
    gz = spectrum[:, None] * (asm.transfer_function(plan, t(OTHER_DISTANCES)) * plan.mask)[None]
    chain = asm.crop(plan, torch.fft.ifft2(gz)).abs()
    assert_close(fused.numpy(), chain.numpy(), p999=1e-5, worst=1e-5)


# (batch, distances): one field to the plan's stack; two fields, one
# distance each (per_plane); two fields against one distance
PROPAGATE_CASES = {
    "b1_plan_stack": (1, None),
    "b2_per_plane": (2, np.array([3e-4, 8e-4], np.float32)),
    "b2_one_distance": (2, np.array([6e-4], np.float32)),
}


@pytest.mark.parametrize("case", list(PROPAGATE_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_propagate_and_p2i_match_jax(grid, backend, case):
    batch, d = PROPAGATE_CASES[case]
    jplan, plan = _plans(grid, [4e-4, 7e-4] if case == "b1_plan_stack" else [1e-3])
    amp, phs = _fields(grid, 23, batch=batch)
    jd = None if d is None else jnp.asarray(d)
    want = np.asarray(_on_backend(backend, lambda p, a, b: jasm.propagate(p, a, b, jd), jplan,
                                  jnp.asarray(amp), jnp.asarray(phs)))
    got = asm.propagate(plan, t(amp), t(phs), None if d is None else t(d)).numpy()
    assert got.shape == want.shape
    assert_close(got, want)
    want_i = np.asarray(_on_backend(backend, lambda p, b: jasm.propagate_p2i(p, b, jd), jplan,
                                    jnp.asarray(phs)))
    got_i = asm.propagate_p2i(plan, t(phs), None if d is None else t(d)).numpy()
    assert_close(got_i, want_i)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("distances", ["plan", "explicit"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_propagate_ap2ap_matches_jax(grid, distances, backward):
    """Unpadded (B, 6, rows, cols) interleaved amp/phase in, [amps,
    phases] out, as the JAX package pads it (its noted departure from the
    reference); with the plan's one distance or an explicit one."""
    jplan, plan = _plans(grid, [1e-3])
    amp, phs = _fields(grid, 24)
    ap = np.stack([amp, phs], axis=2).reshape(amp.shape[0], 6, *amp.shape[-2:])
    d = None if distances == "plan" else np.array([6e-4], np.float32)
    want = np.asarray(jasm.propagate_ap2ap(jplan, jnp.asarray(ap), None if d is None else jnp.asarray(d),
                                           backward=backward))
    got = asm.propagate_ap2ap(plan, t(ap), None if d is None else t(d), backward=backward).numpy()
    assert got.shape == want.shape == ap.shape
    assert_close(got[:, :3], want[:, :3])
    assert_phase_close(got[:, 3:], want[:, 3:], want[:, :3])
