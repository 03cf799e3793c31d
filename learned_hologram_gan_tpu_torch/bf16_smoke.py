"""bfloat16 inference at ``bench.py``'s configuration on the card, which
``chip_smoke.py`` runs.

:func:`inference` first drives ``generate_poh.main --dtype bfloat16`` on one
synthetic 384^2 sample (pad 320, a 3-plane focal stack), with the launch
counters reset before and read after and the convolutions' compute dtypes
recorded; then it times the batch-16 pipeline of ``bench.py:34-101`` in the
port: the bfloat16 generator (384^2, pad 320, filter radius 0.45, seeded
random weights) in eval mode, then ``propagate_batch_multi`` over
``linspace(4e-4, 1e-3, 3)`` with the same optics, on
``default_rng(0).random((16, 4, 384, 384))``; two warm-ups, then five
trials of ten batches, each trial ended by a host fetch of a strided sum of
the focal stack, as ``bench.py`` ends its; the median POH/s and the spread
(max - min), the peak memory and the forward's three stages.  It raises on
any failure.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

ROWS = COLS = 384
PAD = 320
BATCH = 16
DISTANCES = np.linspace(4e-4, 10e-4, 3)
WARMUP, TRIALS, REPS = 2, 5, 10


def inference(card):
    """Returns the POH/s median and spread and the K1 launches of the
    ``generate_poh`` run."""
    from . import card_check, generate_poh
    from .config import GeneratorConfig
    from .models import make_generator, make_generator_plan
    from .ops import asm
    from .ops.cuda import spectral
    from .utils.cuda_measure import cuda_ms

    with tempfile.TemporaryDirectory(prefix="bf16_smoke_") as tmp:
        rng = np.random.default_rng(1)
        for name in ("img", "depth"):
            rng.random((1, 3, ROWS, COLS)).astype(np.float32).tofile(os.path.join(tmp, f"{name}.bin"))
        recon_dir = os.path.join(tmp, "recon")
        argv = [
            "--img_path", os.path.join(tmp, "img.bin"), "--depth_path", os.path.join(tmp, "depth.bin"),
            "--index", "0", "--model_path", os.path.join(tmp, "random_init.pt"),
            "--poh_output_path", os.path.join(tmp, "poh.npy"), "--samplesNum", "1",
            "--propagate", "--num_intervals", "3", "--output_image_dir", recon_dir,
            "--dtype", "bfloat16", "--device", "cuda",
        ]
        # the main path's run: counters to 0 just before, read just after
        spectral.reset_launch_counts()
        dtypes = set()
        start = time.perf_counter()
        with card_check.record_conv_tf32([], dtypes=dtypes):
            result = generate_poh.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = spectral.row_pass.launches
        print(f"generate_poh.main --dtype bfloat16 (first call, weights init included): "
              f"{wall:.2f} s; K1 launches {launches}; convolutions computed in "
              f"{sorted(str(d) for d in dtypes)}", flush=True)
        if launches != 2:
            raise AssertionError(f"K1 launched {launches} times, want 2")
        if dtypes != {torch.bfloat16}:
            raise AssertionError(f"convolutions computed in {dtypes}, want bfloat16 only")
        poh, stack = result["poh"], result["focal_stack"]
        if tuple(poh.shape) != (1, 3, ROWS, COLS) or tuple(stack.shape) != (3, 3, ROWS, COLS):
            raise AssertionError(f"shapes: poh {tuple(poh.shape)}, stack {tuple(stack.shape)}")
        if poh.dtype != torch.float32 or not (torch.isfinite(poh).all() and torch.isfinite(stack).all()):
            raise AssertionError("the POH is not finite float32, or the focal stack is not finite")
        if sorted(os.listdir(recon_dir)) != ["0.png", "1.png", "2.png"]:
            raise AssertionError(f"PNGs written: {sorted(os.listdir(recon_dir))}")

    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45,
                          dtype="bfloat16")
    model = make_generator(cfg, seed=0, device="cuda")
    gen_plan = make_generator_plan(cfg, device="cuda")
    recon_plan = asm.make_plan(cfg.optics(), distances=DISTANCES, device="cuda")
    rgbd = torch.from_numpy(
        np.random.default_rng(0).random((BATCH, 4, ROWS, COLS)).astype(np.float32)).cuda()

    def pipeline():
        with torch.inference_mode():
            p = model(gen_plan, rgbd)
            return p, asm.propagate_batch_multi(recon_plan, torch.ones_like(p), p)

    def fetch(out):  # a device-to-host round trip ends the trial, as in bench.py
        return float(out[1][:, :, ::64, ::64].sum())

    for _ in range(WARMUP):
        fetch(pipeline())
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(TRIALS):
        start = time.perf_counter()
        for _ in range(REPS):
            out = pipeline()
        total = fetch(out)
        rates.append(REPS * BATCH / (time.perf_counter() - start))
    if not np.isfinite(total):
        raise AssertionError("non-finite focal stack")
    rates.sort()
    median, spread = rates[len(rates) // 2], rates[-1] - rates[0]
    print(f"bench.py's configuration in bfloat16 (batch {BATCH}, 384^2, pad 320, 3 planes): "
          f"median {median:.2f} POH/s of {TRIALS} trials of {REPS} batches, spread {spread:.2f} "
          f"(min {rates[0]:.2f}, max {rates[-1]:.2f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)

    with torch.inference_mode():
        amp, phs = model.part1(rgbd)
        poh = model.part2(gen_plan, amp, phs)
        split = dict(
            unet=cuda_ms(lambda: model.part1(rgbd), iters=3, warmup=1),
            ap2poh=cuda_ms(lambda: model.part2(gen_plan, amp, phs), iters=3, warmup=1),
            focal_stack=cuda_ms(
                lambda: asm.propagate_batch_multi(recon_plan, torch.ones_like(poh), poh),
                iters=3, warmup=1),
        )
    print("batch-16 stages (bfloat16): RGBD2AP (UNet) {unet:.1f} ms, AP2POH (K1 D=1 + modulation "
          "+ encode) {ap2poh:.1f} ms, focal stack (K1 D=3) {focal_stack:.1f} ms".format(**split)
          + f" [{card}]", flush=True)
    del model, rgbd, out, amp, phs, poh
    torch.cuda.empty_cache()
    return dict(poh_per_s=median, spread=spread, k1_launches=launches)
