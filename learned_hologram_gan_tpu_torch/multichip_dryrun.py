"""One full GAN train step in each multi-device mode, on CPU ranks (the
port's counterpart of ``__graft_entry__.py:dryrun_multichip``)::

    python -m learned_hologram_gan_tpu_torch.multichip_dryrun [N]

starts N gloo ranks on this host (default 8) and prints, from rank 0, the
three lines the JAX function prints:

* the data mesh: the batch split over the N ranks (batch max(2, N), N + 2
  distances), BatchNorm statistics and gradients over the global batch;
* the spatial mesh: the same step at pad 8 (a 32 x 32 grid, which N must
  divide) with every propagation FFT row-sharded over the ranks;
* the distance-plane-sharded step: 2N distances, each rank holding the
  transfer functions of its own, batch and state replicated.

Tiny shapes throughout: 16 x 16 input, UNet base 2, critic feature_d 2,
no perceptual term, ratio 5.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np


def _trainer(pad_size, distances, batch, **meshes):
    from .train import Watermelon

    return Watermelon(filter_radius_coefficient=0.45, pad_size=pad_size,
                      distance_stack=np.linspace(-4e-4, 0.0, distances + 1)[:-1],
                      input_shape=(batch, 4, 16, 16), use_gan=True, perceptual="none",
                      unet_base_features=2, feature_d=2, device="cpu", **meshes)


def _step(trainer, **meshes):
    from .config import LossConfig
    from .train import build_train_step

    # ratio 5 as the reference's training configuration (trainingModel.py:74-97)
    return build_train_step(LossConfig(perceptual="none"), True, 5, 10.0, **meshes)


def dryrun_rank(rank: int, n: int) -> List[str]:
    """This rank's part of the three legs; rank 0 returns their lines."""
    import torch

    from .parallel import make_mesh, shard_batch, shard_distance_stack

    mesh = make_mesh(n)
    rng = np.random.default_rng(0)
    lines = []

    batch_size = max(2, n)
    trainer = _trainer(4, batch_size + 2, batch_size, data_mesh=mesh)
    trainer._init_state(seed=0, lr_G=1e-3, lr_D=1e-3)
    batch = shard_batch(tuple(torch.from_numpy(rng.random((batch_size, c, 16, 16), dtype=np.float32))
                              for c in (4, 3, 3)), mesh)
    _, m = _step(trainer, mesh=mesh)(trainer.state, batch, trainer.gen_plan, trainer.multi_plan)
    if not np.isfinite(float(m["G_loss"])):
        raise AssertionError("non-finite loss in dry run")
    lines.append(f"dryrun_multichip({n}) OK: G_loss={float(m['G_loss']):.4f} "
                 f"D_loss={float(m['D_loss']):.4f} PSNR={float(m['PSNR']):.2f}")

    sp = _trainer(8, 4, 2, spatial_mesh=mesh)
    sp._init_state(seed=0, lr_G=1e-3, lr_D=1e-3)
    sp_batch = tuple(torch.from_numpy(rng.random((2, c, 16, 16), dtype=np.float32)) for c in (4, 3, 3))
    _, m = _step(sp, spatial_mesh=mesh)(sp.state, sp_batch, sp.gen_plan, sp.multi_plan)
    if not np.isfinite(float(m["G_loss"])):
        raise AssertionError("non-finite spatial loss")
    lines.append(f"dryrun_multichip({n}) spatial-mesh OK: G_loss={float(m['G_loss']):.4f}")

    dp = _trainer(4, 2 * n, 2)
    dp._init_state(seed=0, lr_G=1e-3, lr_D=1e-3)
    dp_batch = tuple(torch.from_numpy(rng.random((2, c, 16, 16), dtype=np.float32)) for c in (4, 3, 3))
    _, m = _step(dp)(dp.state, dp_batch, dp.gen_plan, shard_distance_stack(dp.multi_plan, mesh))
    if not np.isfinite(float(m["G_loss"])):
        raise AssertionError("non-finite plane-sharded loss")
    lines.append(f"dryrun_multichip({n}) distance-plane-sharded OK: G_loss={float(m['G_loss']):.4f} "
                 f"D_loss={float(m['D_loss']):.4f}")
    return lines if rank == 0 else []


def dryrun_multichip(n_devices: int = 8, join_timeout_s: float = 600.0) -> List[str]:
    """Start ``n_devices`` gloo CPU ranks, run :func:`dryrun_rank` on each
    and return rank 0's three lines."""
    from .parallel import launch

    return launch.spawn(dryrun_rank, n_devices, join_timeout_s=join_timeout_s)[0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for line in dryrun_multichip(int(argv[0]) if argv else 8):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
