"""The slice at a small size on a CUDA device, held against the CPU.

:func:`card_vs_cpu` runs ``generate_poh.main`` on one sample with the same
seeded weights twice: on the card, through the port's kernels, and on the
CPU, through their plain versions.  It records the TF32 setting each
convolution ran under.  :func:`check` raises unless the two agree:

* POHs as phasors, ``|exp(i a) - exp(i b)|`` (a 2*pi wrap is the same SLM
  state, and acos amplifies rounding near the normalized maximum): mean
  <= 2e-3, p99 <= 1e-2, max <= 5e-2;
* focal stacks: p99.9 <= 1e-3, max <= 4e-3 (the propagation bound of the
  CPU tests);
* every convolution on the card ran with TF32 off, and K1 launched twice.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both call it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import List

import numpy as np
import torch
from torch import nn

ROWS = COLS = 48
PAD = 8  # a 64 x 64 padded grid: the fused path, K1 on the card
UNET_BASE = 4

POH_MEAN_TOL, POH_P99_TOL, POH_MAX_TOL = 2e-3, 1e-2, 5e-2
STACK_P999_TOL, STACK_MAX_TOL = 1e-3, 4e-3


@contextlib.contextmanager
def record_conv_tf32(seen: List[bool]):
    """Append ``torch.backends.cudnn.allow_tf32`` to ``seen`` as each
    convolution module of the process starts its forward."""
    from .nn.blocks import ChannelWiseSymmetricConv

    convs = (nn.Conv2d, nn.ConvTranspose2d, ChannelWiseSymmetricConv)

    def hook(module, args):
        if isinstance(module, convs):
            seen.append(bool(torch.backends.cudnn.allow_tf32))

    handle = nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def card_vs_cpu(device: str | torch.device = "cuda", seed: int = 3) -> dict:
    """Drive the CLI path on ``device`` and on the CPU; returns the
    differences, the card run's K1 launches and its convolutions' TF32
    settings."""
    from . import generate_poh
    from .ops.cuda import spectral

    outs, tf32, launches = {}, [], 0
    with tempfile.TemporaryDirectory(prefix="card_check_") as tmp:
        rng = np.random.default_rng(seed)
        for name in ("img", "depth"):
            rng.random((2, 3, ROWS, COLS)).astype(np.float32).tofile(os.path.join(tmp, f"{name}.bin"))
        for run, dev in enumerate(("cpu", str(device))):
            argv = [
                "--img_path", os.path.join(tmp, "img.bin"),
                "--depth_path", os.path.join(tmp, "depth.bin"), "--index", "1",
                "--model_path", os.path.join(tmp, "random_init.pt"),
                "--poh_output_path", os.path.join(tmp, "poh.npy"), "--samplesNum", "2",
                "--sample_row_num", str(ROWS), "--sample_col_num", str(COLS),
                "--pad_size", str(PAD), "--unet_base_features", str(UNET_BASE),
                "--propagate", "--num_intervals", "3",
                "--output_image_dir", os.path.join(tmp, f"recon_{run}"), "--device", dev,
            ]
            seen: List[bool] = []
            before = spectral.propagate_planes.launches
            with record_conv_tf32(seen):
                result = generate_poh.main(argv)
            # kept from the last run, the card's
            tf32, launches = seen, spectral.propagate_planes.launches - before
            outs[run] = (result["poh"].cpu().double().numpy(), result["focal_stack"].cpu().numpy())
    (cpu_poh, cpu_stack), (card_poh, card_stack) = outs[0], outs[1]
    d = np.abs(np.exp(1j * card_poh) - np.exp(1j * cpu_poh))
    s = np.abs(card_stack - cpu_stack)
    return dict(
        poh_mean=float(d.mean()), poh_p99=float(np.quantile(d, 0.99)), poh_max=float(d.max()),
        stack_p999=float(np.quantile(s, 0.999)), stack_max=float(s.max()),
        convs=len(tf32), convs_tf32=int(sum(tf32)), k1_launches=launches,
    )


def check(stats: dict) -> None:
    """Raise ``AssertionError`` naming every bound that ``stats`` (from
    :func:`card_vs_cpu`) breaks."""
    bounds = [
        ("poh_mean", POH_MEAN_TOL), ("poh_p99", POH_P99_TOL), ("poh_max", POH_MAX_TOL),
        ("stack_p999", STACK_P999_TOL), ("stack_max", STACK_MAX_TOL),
    ]
    problems = [f"{k} {stats[k]:.3e} > {tol:g}" for k, tol in bounds if stats[k] > tol]
    if stats["convs"] == 0 or stats["convs_tf32"] != 0:
        problems.append(f"{stats['convs_tf32']} of {stats['convs']} convolutions ran with TF32 on")
    if stats["k1_launches"] != 2:
        problems.append(f"K1 launched {stats['k1_launches']} times, want 2")
    if problems:
        raise AssertionError("card and CPU disagree: " + "; ".join(problems))
