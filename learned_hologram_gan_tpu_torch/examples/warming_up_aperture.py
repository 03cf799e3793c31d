#!/usr/bin/env python
"""Warming-up study: aperture diffraction in the Fourier plane (the port's
counterpart of ``examples/warming_up_aperture.py``).

An executable version of the reference's ``warmingUp/aboutAperture.ipynb``:
truncating a field with a finite circular aperture convolves its spectrum
with the aperture's Airy-like transform, so energy leaks out of the
original discrete tones into a broadened sinc skirt.  This is why the
propagator's circular frequency mask (``ops/masks.circular_frequency_mask``)
models the imaging system's aperture as a *low-pass filter*.

Assertions:
1. The unapertured 2-D sine field concentrates its spectral energy in 4
   delta tones (plus conjugates).
2. After the aperture, those tones hold strictly less of the total energy
   (spread into the sinc skirt), and the skirt energy is significant.

The spectra are float32 FFTs, as the JAX example's::

    python -m learned_hologram_gan_tpu_torch.examples.warming_up_aperture [--plot] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the study; returns the energy fractions in the 4 tones without
    (``plain``) and with (``aperture``) the aperture."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device to run on (cuda unless asked otherwise)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")

    n = 256
    length = 1e-3                     # field side length [m]
    radius = 0.1 * length             # aperture radius
    cycles = 20                       # sine tone index

    x = np.linspace(-length / 2, length / 2, n, endpoint=False)  # exact grid periodicity -> delta tones
    xx, yy = np.meshgrid(x, x, indexing="ij")
    rr = np.sqrt(xx**2 + yy**2)
    field = np.sin(cycles * 2 * np.pi * xx / length) * np.sin(cycles * 2 * np.pi * yy / length)
    aperture = (rr <= radius).astype(np.float32)

    def spectrum(a):
        t = torch.from_numpy(np.asarray(a, np.float32)).to(device)
        return torch.fft.fftshift(torch.fft.fft2(t)).abs().cpu().numpy()

    mag, mag_ap = spectrum(field), spectrum(field * aperture)

    # the 4 tones live at (+-cycles, +-cycles) around the center
    c = n // 2
    tone_mask = np.zeros((n, n), bool)
    for sx in (-cycles, cycles):
        for sy in (-cycles, cycles):
            tone_mask[c + sx - 1: c + sx + 2, c + sy - 1: c + sy + 2] = True

    def tone_fraction(m):
        e = m**2
        return float(e[tone_mask].sum() / e.sum())

    f_plain, f_ap = tone_fraction(mag), tone_fraction(mag_ap)
    print(f"energy in the 4 tones: no aperture {f_plain:.4f}, aperture {f_ap:.4f}")
    assert f_plain > 0.99, "unapertured tones should be near-delta"
    assert f_ap < 0.5, "aperture must spread energy into the sinc skirt"

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs("examples/out", exist_ok=True)
        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        for axis, m, title in zip(axes, (mag, mag_ap), ("no aperture", "0.1L aperture")):
            axis.imshow(np.log1p(m), cmap="gray")
            axis.set_title(title)
            axis.axis("off")
        fig.tight_layout()
        fig.savefig("examples/out/warming_up_aperture.png", dpi=120)
        print("wrote examples/out/warming_up_aperture.png")

    print("warming-up aperture study: all assertions passed")
    return dict(plain=f_plain, aperture=f_ap)


if __name__ == "__main__":
    main()
