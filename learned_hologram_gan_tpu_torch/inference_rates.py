"""POH/s of the module path and the fused eval path, to compare two
checkouts of the port on one card.

    python3 learned_hologram_gan_tpu_torch/inference_rates.py [--root DIR] [--trials N] [--reps N]
        [--dtype bfloat16|float32]

Imports ``learned_hologram_gan_tpu_torch`` from ``DIR`` (default: the
checkout that holds this script) and times, on the card, in ``--dtype``
(bfloat16 by default; float32 with TF32 off, as the port runs it) with
seeded random weights (384^2, pad 320, batch 16, base 64):

* bench.py's pipeline as ``bf16_smoke.inference`` times it (filter 0.45,
  the module path, then a 3-plane focal stack over linspace(4e-4, 1e-3, 3)
  with the same optics, on ``default_rng(0)`` RGBD): two warm-ups, then
  ``--trials`` trials of ten batches, each ended by a host fetch of a
  strided sum of the focal stack;
* the fused eval path as ``fused_smoke.fused_path`` times it
  (``generator_apply_fused`` with the BatchNorm statistics randomized from
  ``default_rng(12)``, its focal stack at filter 0.35): two warm-ups, then
  ``--reps`` calls of the module path and of the fused path in turns, each
  call ended by a device synchronize.

It prints each path's median, min and max POH/s and then one JSON line.
It uses only what the package has offered since the fused path's port, so
it times an earlier checkout too: run it on two checkouts in turns (A, B,
B, A) within one call to compare them on the same card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROWS = COLS = 384
PAD = 320
BATCH = 16
DISTANCES = (4e-4, 7e-4, 1e-3)
WARMUP, BATCHES_PER_TRIAL = 2, 10


def _rates(seconds, per):
    rates = sorted(per / s for s in seconds)
    return dict(median=statistics.median(rates), min=rates[0], max=rates[-1], n=len(rates))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="checkout whose learned_hologram_gan_tpu_torch is timed")
    parser.add_argument("--trials", type=int, default=11, help="bench.py-style trials of ten batches")
    parser.add_argument("--reps", type=int, default=21, help="calls of each path, in turns")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = parser.parse_args(argv)
    tag = {"bfloat16": "bf16", "float32": "f32"}[args.dtype]
    # the package from --root, and nothing from this script's own directory
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.abspath(args.root)] + [
        p for p in sys.path if os.path.abspath(p or os.curdir) != here]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("inference_rates: no CUDA device", file=sys.stderr)
        return 1
    import learned_hologram_gan_tpu_torch as pkg
    from learned_hologram_gan_tpu_torch.card_check import randomize_batch_norms
    from learned_hologram_gan_tpu_torch.config import GeneratorConfig, OpticsConfig
    from learned_hologram_gan_tpu_torch.models import (generator_apply_fused, make_generator,
                                                        make_generator_plan)
    from learned_hologram_gan_tpu_torch.ops import asm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"package {os.path.dirname(pkg.__file__)} [{card}]", flush=True)
    dev = torch.device("cuda")
    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45,
                          dtype=args.dtype)
    gen_plan = make_generator_plan(cfg, device=dev)

    # bench.py's pipeline, as bf16_smoke.inference times it
    model = make_generator(cfg, seed=0, device="cuda")
    recon = asm.make_plan(cfg.optics(), distances=np.linspace(4e-4, 10e-4, 3), device=dev)
    rgbd = torch.from_numpy(np.random.default_rng(0).random((BATCH, 4, ROWS, COLS)).astype(np.float32)).to(dev)

    def pipeline():
        with torch.inference_mode():
            p = model(gen_plan, rgbd)
            return asm.propagate_batch_multi(recon, torch.ones_like(p), p)

    for _ in range(WARMUP):
        float(pipeline()[:, :, ::64, ::64].sum())
    seconds = []
    for _ in range(args.trials):
        start = time.perf_counter()
        for _ in range(BATCHES_PER_TRIAL):
            out = pipeline()
        float(out[:, :, ::64, ::64].sum())
        seconds.append(time.perf_counter() - start)
    bench = _rates(seconds, BATCHES_PER_TRIAL * BATCH)
    del model, out

    # the fused eval path, as fused_smoke.fused_path times it
    rng = np.random.default_rng(12)
    model = randomize_batch_norms(make_generator(cfg, seed=0, device="cpu"), rng).to(dev)
    recon = asm.make_plan(OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                       filter_radius_coefficient=0.35), distances=DISTANCES, device=dev)
    rgbd = torch.from_numpy(rng.random((BATCH, 4, ROWS, COLS)).astype(np.float32)).to(dev)

    def fused():
        with torch.inference_mode():
            p = generator_apply_fused(model, gen_plan, rgbd)
            return asm.propagate_batch_multi(recon, torch.ones_like(p), p)

    def module():
        with torch.inference_mode():
            p = model(gen_plan, rgbd)
            return asm.propagate_batch_multi(recon, torch.ones_like(p), p)

    paths = {"module": module, "fused": fused}
    times = {k: [] for k in paths}
    for fn in paths.values():
        for _ in range(WARMUP):
            fn()
    torch.cuda.synchronize()
    for _ in range(args.reps):
        for k, fn in paths.items():
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - start)
    result = {f"bench_{tag}": bench, **{f"{k}_{tag}": _rates(v, BATCH) for k, v in times.items()}}
    for k, r in result.items():
        print(f"{k}: median {r['median']:.2f} POH/s of {r['n']} (min {r['min']:.2f}, max {r['max']:.2f}) "
              f"[{card}]", flush=True)
    print(json.dumps(dict(root=os.path.abspath(args.root), card=card, **result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
