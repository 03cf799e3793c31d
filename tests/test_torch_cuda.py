"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where no CUDA device is present (decided
inside the fixture, never at import).  The module imports neither jax nor
the JAX package, so on the GPU machine it runs without the repo's
conftest::

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerance for K1 against its plain version: relative to max |plain|, 1e-4
at worst and 1e-5 at the 99.9th percentile (float32 FFT rounding over three
transforms is ~1e-6; H is computed in the same f32 operation order).
"""

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import card_check
from learned_hologram_gan_tpu_torch.config import OpticsConfig
from learned_hologram_gan_tpu_torch.ops import asm
from learned_hologram_gan_tpu_torch.ops.cuda import spectral

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k1_case(device, rows, cols, pad, batch, conj_h, num_d, seed=0):
    optics = OpticsConfig(rows=rows, cols=cols, pad_size=pad, filter_radius_coefficient=0.45)
    plan = asm.make_plan(optics, distances=np.linspace(4e-4, 1e-3, num_d), device=device)
    rng = np.random.default_rng(seed)
    amp = torch.from_numpy(rng.random((batch, 3, rows, cols)).astype(np.float32)).to(device)
    phs = torch.from_numpy((2 * np.pi * rng.random((batch, 3, rows, cols))).astype(np.float32)).to(device)
    return asm.fused_args(plan, asm.field(amp, phs), plan.distances,
                          conj_h=conj_h, use_mask=not conj_h)


@pytest.mark.parametrize("rows,cols,pad,batch", [
    (24, 32, 4, 2),      # 32 x 42 grid: tile width 2
    (48, 48, 8, 2),      # 64 x 64
    (384, 384, 320, 1),  # the main path's 1024 x 1024 grid
])
@pytest.mark.parametrize("conj_h,num_d", [(True, 1), (False, 3)], ids=["backward", "stack"])
def test_k1_matches_plain_version(device, rows, cols, pad, batch, conj_h, num_d):
    args = _k1_case(device, rows, cols, pad, batch, conj_h, num_d)
    before = spectral.propagate_planes.launches
    kr, ki = spectral.propagate_planes(*args)
    torch.cuda.synchronize()
    assert spectral.propagate_planes.launches == before + 1
    rr, ri = spectral.propagate_planes_reference(*args)
    err = torch.sqrt((kr - rr) ** 2 + (ki - ri) ** 2).flatten()
    rel = err / torch.sqrt(rr**2 + ri**2).max()
    assert float(rel.max()) <= 1e-4
    assert float(rel.sort().values[int(0.999 * (rel.numel() - 1))]) <= 1e-5


def test_k1_raises_instead_of_falling_back(device):
    """A CUDA tensor on a grid K1 does not support raises; it never takes
    the plain version."""
    args = _k1_case(device, 24, 24, 5, 1, False, 1)  # 34 x 34: not a power of two
    with pytest.raises(ValueError):
        spectral.propagate_planes(*args)


def test_small_slice_on_card_matches_cpu(device):
    """generate_poh on the card (kernels) against the CPU (plain versions),
    with TF32 left at torch's default: the port itself must keep every
    float32 convolution out of TF32."""
    assert torch.backends.cudnn.allow_tf32  # torch's default, untouched
    stats = card_check.card_vs_cpu(device)
    assert stats["convs"] > 0 and stats["convs_tf32"] == 0
    card_check.check(stats)
