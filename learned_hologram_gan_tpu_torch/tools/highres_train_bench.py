#!/usr/bin/env python
"""High-resolution training bench (the port's counterpart of
``tools/highres_train_bench.py``).

Full WGAN-GP train steps at 1080p-class resolution (1088 x 1920, pad 320:
a 1728 x 3048 padded grid) on one card: per-block UNet recomputation and
the step's remat sites, no transfer-function stack (``cache_h=False``) and
bfloat16 convolutions, batch 1, critic ratio 1, 8 distances, seeded random
weights and data.  One warm-up step, then ``--steps`` steps timed by CUDA
events (the host clock on the CPU); prints ms/step and the peak device
memory of the timed steps, and on the card one more step split by CUDA
events into its three phases (G forward + reconstruction, the critic
loop, the G loss, backward and Adam)::

    python -m learned_hologram_gan_tpu_torch.tools.highres_train_bench
    python -m learned_hologram_gan_tpu_torch.tools.highres_train_bench --rows 544 --cols 960

The JAX tool's flags, plus the port's: ``--no_remat`` and ``--cache_h``
switch the two memory levers off (to measure what each saves),
``--unet_base_features`` and ``--device`` (``cuda`` unless asked otherwise).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1088)
    ap.add_argument("--cols", type=int, default=1920)
    ap.add_argument("--pad_size", type=int, default=320)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--ratio", type=int, default=1)
    ap.add_argument("--distances", type=int, default=8)
    ap.add_argument("--no_remat", action="store_true", help="keep every activation")
    ap.add_argument("--cache_h", action="store_true", help="keep the transfer-function stacks")
    ap.add_argument("--unet_base_features", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless asked otherwise)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the bench on ``argv``; returns ms/step (the best timed step and
    their mean), the peak memory of the timed steps in GiB and the split of
    one more step in ms (None on the CPU), and the last step's metrics."""
    import torch

    from ..config import LossConfig
    from ..train import Watermelon, build_train_step

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")
    remat = not args.no_remat
    trainer = Watermelon(
        filter_radius_coefficient=0.45,
        pad_size=args.pad_size,
        distance_stack=np.linspace(-4e-4, 0.0, args.distances + 1)[:-1],
        input_shape=(args.batch, 4, args.rows, args.cols),
        use_gan=True,
        perceptual="none",
        dtype="bfloat16",
        unet_base_features=args.unet_base_features,
        remat=remat,
        cache_h=args.cache_h,
        device=device,
    )
    trainer._init_state(seed=0, lr_G=1e-3, lr_D=1e-3)
    step = build_train_step(LossConfig(perceptual="none"), True, args.ratio, 10.0, remat=remat)
    rng = np.random.default_rng(0)
    batch = tuple(
        torch.from_numpy(rng.random((args.batch, c, args.rows, args.cols)).astype(np.float32)).to(device)
        for c in (4, 3, 3)
    )
    state, plans = trainer.state, (trainer.gen_plan, trainer.multi_plan)

    t0 = time.perf_counter()
    state, metrics = step(state, batch, *plans)
    g0 = float(metrics["G_loss"])
    print(f"step 1 (warm-up): {time.perf_counter() - t0:.1f} s, G_loss={g0:.4f}", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for i in range(args.steps):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, metrics = step(state, batch, *plans)
            ev[1].record()
            torch.cuda.synchronize(device)
            times.append(ev[0].elapsed_time(ev[1]))
        else:
            t0 = time.perf_counter()
            state, metrics = step(state, batch, *plans)
            times.append((time.perf_counter() - t0) * 1e3)
        g = float(metrics["G_loss"])
        print(f"step {i + 2}: {times[-1]:.0f} ms, G_loss={g:.4f}", flush=True)
        if not np.isfinite(g):
            raise AssertionError("non-finite loss at high resolution")
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    levers = f"remat {'on' if remat else 'off'}, H {'cached' if args.cache_h else 'on the fly'}"
    print(f"{args.rows}x{args.cols} batch {args.batch} ratio {args.ratio} ({levers}): "
          f"{min(times):.0f} ms/step (best of {args.steps})"
          + (f", peak {peak:.2f} GiB" if peak is not None else ""), flush=True)
    split = _split(state, batch, plans, args.ratio, remat) if cuda else None
    return dict(ms_per_step=min(times), mean_ms=float(np.mean(times)), peak_gib=peak, split=split,
                metrics={k: float(v) for k, v in metrics.items()})


def _split(state, batch, plans, ratio: int, remat: bool) -> dict:
    """One more step, its three phases timed by CUDA events (ms)."""
    import torch

    from ..config import LossConfig
    from ..train import steps as steps_lib

    split = {}

    def timed(label, fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        split[label] = ev[0].elapsed_time(ev[1])
        return out

    idx, alphas = steps_lib.draw_step_randoms(state, plans[1], batch[0].shape[0], ratio)
    recon = timed("G forward + reconstruction",
                  lambda: steps_lib.reconstruct(state.generator, *plans, batch, idx, remat=remat))
    timed("critic loop", lambda: steps_lib.critic_updates(state, recon[1], recon[0].detach(),
                                                           alphas.to(recon[1].device), 10.0, "pair", remat))
    timed("G loss + backward + Adam",
          lambda: steps_lib.generator_update(state, LossConfig(perceptual="none"), recon, remat))
    print("split of one step by CUDA events: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()),
          flush=True)
    return split


if __name__ == "__main__":
    main()
