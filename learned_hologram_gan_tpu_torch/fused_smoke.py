"""The fused eval path's checks on the card, which ``chip_smoke.py`` runs.

* :func:`k5_kernel`: K5 at two full-width block shapes at batch 16 (enc_0,
  4 -> 64 at 384^2; dec_1, 256 -> 128 at 192^2) against its plain version,
  with the kernel's time (the C entry alone), the wrapper's, the plain
  version's, a library yardstick and the card's bound.  The library call is
  the cuDNN chain with TF32 off, which is also the plain version here: no
  single PyTorch call computes a residual block.
* :func:`fused_path`: ``generator_apply_fused`` and the 3-plane focal
  stack at the bench config (384^2, pad 320, batch 16, base 64, float32),
  seeded weights with non-trivial BatchNorm statistics; K5's launches
  counted (9 per forward, one per residual block, 7 with
  ``polyphase_level0``) and K4's (none: it lies on no path); the POH
  against the module path (``Generator.forward``) within the same-card
  bounds below; POH/s and peak memory beside the module path; the cost of
  folding the BatchNorms; then each block alone, K5 against the cuDNN chain
  (:func:`block_split`), checked against it and timed.
* :func:`k4_kernel`: K4 at the training focal stack's shape (B 4, C 3,
  1024^2, D 20) against its plain version, with its time, a cached-H
  library yardstick and the bound.  K4 lies on no path of the port, as the
  JAX function lies on none of the JAX package.

All raise on any failure.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .card_check import poh_phasor_errors, randomize_batch_norms
from .nn.blocks import ResidualBlock
from .train_smoke import _Entry, _random_complex
from .utils.cuda_measure import check_rel, cuda_ms

BATCH = 16
ROWS = COLS = 384
PAD = 320
DISTANCES = (4e-4, 7e-4, 1e-3)  # np.linspace(4e-4, 1e-3, 3), generatePOH defaults
# (name, H = W, Cin, Cout) of two of the full-width UNet's nine blocks
K5_CASES = (("enc_0", 384, 4, 64), ("dec_1", 192, 256, 128))
# the training focal stack: trainingModel.py's 20 distances, batch 4
K4_BATCH, K4_DISTANCES = 4, np.linspace(-4e-4, 0.0, 21)[:-1]
WARMUP, REPS = 2, 5
DEVICE = "cuda"
# The fused POH against the module path's on the same card, as phasors.
# Both are float32 with TF32 off and differ only in summation order and in
# the folded BatchNorm's rounding; the readings at the bench config were
# mean 4.7e-7, p99 1.7e-6, max 8.9e-6 (NVIDIA H100 80GB HBM3, 700 W).  The
# bounds keep about 20x of headroom for other seeds, and stay 100-250x
# tighter than the cross-framework bounds of PERF.md section 2.
SAME_CARD_MEAN_TOL, SAME_CARD_P99_TOL, SAME_CARD_MAX_TOL = 1e-5, 5e-5, 2e-4


def k5_flops(b, h, w, cin, c):
    """conv1 3x3, conv2 3x3 and the 1x1 shortcut, 2 operations per MAC."""
    return 2.0 * b * h * w * (9 * cin * c + 9 * c * c + cin * c)


def k5_bytes(b, h, w, cin, c):
    """x read once, the output written once, the weights and biases read once."""
    return 4.0 * (b * h * w * (cin + c) + 9 * cin * c + 9 * c * c + cin * c + 3 * c)


def k5_kernel(card):
    from .ops.cuda import conv_block

    entry = _Entry("k5_residual_block",
                   "learned_hologram_gan_tpu_torch/csrc/k5_residual_block.cu",
                   "learned_hologram_gan_tpu/ops/pallas/conv_block.py:223",
                   "batch 16: enc_0 (384^2, 4 -> 64) + dec_1 (192^2, 256 -> 128)")
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(11)

    def draw(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    for name, hw, cin, c in K5_CASES:
        # Xavier-scaled weights keep the activations of order one
        args = (draw(BATCH, hw, hw, cin).abs(), draw(3, 3, cin, c, scale=(9 * cin) ** -0.5),
                draw(c, scale=0.1), draw(3, 3, c, c, scale=(9 * c) ** -0.5), draw(c, scale=0.1),
                draw(cin, c, scale=cin ** -0.5), draw(c, scale=0.1))
        got = conv_block.fused_residual_block(*args)
        want = conv_block.residual_block_reference(*args)
        torch.cuda.synchronize()
        zeros = torch.zeros_like(want)
        err = check_rel(f"K5 {name} ({BATCH}, {hw}, {hw}, {cin}) -> {c}", got, zeros, want, zeros)
        del got, want, zeros
        prepped = conv_block.prepare(*args)
        y1 = torch.empty((BATCH, hw, hw, c), device=dev)
        out = torch.empty_like(y1)
        entry.add(
            f"K5 {name}", card, err,
            wrapper=lambda: conv_block.fused_residual_block(*args),
            plain=lambda: conv_block.residual_block_reference(*args),
            library=lambda: conv_block.residual_block_reference(*args),
            kernel=lambda: conv_block.launch(*prepped, y1, out),
            nbytes=k5_bytes(BATCH, hw, hw, cin, c), flops=k5_flops(BATCH, hw, hw, cin, c),
        )
        del args, prepped, y1, out
    torch.cuda.empty_cache()
    return entry


def _unet_flops(batch, hw, base=64, levels=4):
    """K5's work over the nine residual blocks of one UNet forward: enc_0
    to enc_3, the bottleneck, dec_3 to dec_0."""
    blocks = [(hw, 4, base)]
    blocks += [(hw >> i, base << (i - 1), base << i) for i in range(1, levels)]
    blocks.append((hw >> levels, base << (levels - 1), base << levels))
    blocks += [(hw >> i, base << (i + 1), base << i) for i in reversed(range(levels))]
    return sum(k5_flops(batch, s, s, cin, c) for s, cin, c in blocks)


def fused_path(card):
    """The fused eval path at the bench config; returns K5's and K4's
    launches on the main path's run (one forward)."""
    from .config import GeneratorConfig, OpticsConfig
    from .models import generator_apply_fused, make_generator, make_generator_plan
    from .nn import fused_unet
    from .ops import asm
    from .ops.cuda import conv_block, spectral, transfer

    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45)
    rng = np.random.default_rng(12)
    model = randomize_batch_norms(make_generator(cfg, seed=0, device="cpu"), rng).to(DEVICE)
    gen_plan = make_generator_plan(cfg, device=DEVICE)
    recon = asm.make_plan(OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                       filter_radius_coefficient=0.35),
                          distances=DISTANCES, device=DEVICE)
    rgbd = torch.from_numpy(rng.random((BATCH, 4, ROWS, COLS)).astype(np.float32)).to(DEVICE)

    def fused(poly):
        with torch.inference_mode():
            p = generator_apply_fused(model, gen_plan, rgbd, polyphase_level0=poly)
            return p, asm.propagate_batch_multi(recon, torch.ones_like(p), p)

    def module():
        with torch.inference_mode():
            p = model(gen_plan, rgbd)
            return p, asm.propagate_batch_multi(recon, torch.ones_like(p), p)

    # the main path's run: counters to 0 just before, read just after
    conv_block.reset_launch_counts()
    spectral.reset_launch_counts()
    transfer.reset_launch_counts()
    poh, stack = fused(False)
    torch.cuda.synchronize()
    k5, k1 = conv_block.fused_residual_block.launches, spectral.row_pass.launches
    k4 = transfer.apply_transfer_stack.launches
    conv_block.reset_launch_counts()
    poh_poly, _ = fused(True)
    torch.cuda.synchronize()
    k5_poly = conv_block.fused_residual_block.launches
    print(f"fused path, one batch-{BATCH} forward + focal stack: K5 launches {k5} (polyphase "
          f"level 0: {k5_poly}), K1 launches {k1}, K4 launches {k4}", flush=True)
    if (k5, k5_poly, k1, k4) != (9, 7, 2, 0):
        raise AssertionError("want 9 K5 launches (7 with polyphase level 0), 2 K1, no K4")
    if tuple(poh.shape) != (BATCH, 3, ROWS, COLS) or tuple(stack.shape) != (3 * BATCH, 3, ROWS, COLS):
        raise AssertionError(f"shapes: poh {tuple(poh.shape)}, stack {tuple(stack.shape)}")
    if not (torch.isfinite(poh).all() and torch.isfinite(stack).all()
            and torch.isfinite(poh_poly).all()):
        raise AssertionError("non-finite fused POH or focal stack")

    ref_poh, _ = module()
    ref = ref_poh.cpu().numpy()
    for label, p in (("fused", poh), ("fused, polyphase level 0", poh_poly)):
        mean, p99, worst = poh_phasor_errors(p.cpu().numpy(), ref)
        print(f"{label} POH vs module path on the card: phasor mean {mean:.2e} (tol "
              f"{SAME_CARD_MEAN_TOL:g}), p99 {p99:.2e} (tol {SAME_CARD_P99_TOL:g}), max "
              f"{worst:.2e} (tol {SAME_CARD_MAX_TOL:g})", flush=True)
        if not (mean <= SAME_CARD_MEAN_TOL and p99 <= SAME_CARD_P99_TOL
                and worst <= SAME_CARD_MAX_TOL):
            raise AssertionError(f"{label} POH disagrees with the module path")
    del poh, stack, poh_poly, ref_poh

    # POH/s: two warm-ups each, then REPS calls of each path in turns
    paths = {"module": module, "fused (K5)": lambda: fused(False),
             "fused (K5), polyphase level 0": lambda: fused(True)}
    times = {k: [] for k in paths}
    peak = {}
    for k, fn in paths.items():
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[k] = torch.cuda.max_memory_allocated() / 2**30
    for _ in range(REPS):
        for k, fn in paths.items():
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - start)
    for k in paths:
        med = statistics.median(times[k])
        print(f"batch-{BATCH} forward + 3-plane focal stack, {k}: median {med * 1e3:.1f} ms of "
              f"{REPS} (min {min(times[k]) * 1e3:.1f}, max {max(times[k]) * 1e3:.1f}), "
              f"{BATCH / med:.2f} POH/s, peak memory {peak[k]:.2f} GiB [{card}]", flush=True)

    # the UNet stage alone: the fused UNet (K5 on all nine blocks) against
    # the module's cuDNN forward
    x = rgbd.permute(0, 2, 3, 1)
    with torch.inference_mode():
        unet_fused = cuda_ms(lambda: fused_unet.unet_apply_fused(model.part1.unet, x),
                             iters=3, warmup=1)
        unet_module = cuda_ms(lambda: model.part1(rgbd), iters=3, warmup=1)
        blocks = [m for m in model.part1.unet.modules() if isinstance(m, ResidualBlock)]
        fold = cuda_ms(lambda: [fused_unet._folded(b) for b in blocks], iters=3, warmup=1)
    tflop = _unet_flops(BATCH, ROWS) / 1e12
    print(f"batch-{BATCH} UNet stage: fused (K5) {unet_fused:.1f} ms, module (cuDNN, TF32 off) "
          f"{unet_module:.1f} ms; the nine blocks' {tflop:.2f} TFLOP at "
          f"{tflop / unet_fused * 1e3:.1f} TFLOP/s through the fused UNet; folding the "
          f"{len(blocks)} blocks' BatchNorms {fold:.3f} ms of it [{card}]", flush=True)
    block_split(card, model.part1.unet)
    return k5, k4


def block_split(card, unet):
    """Each of the nine blocks at batch 16 on a seeded input of its shape:
    K5 checked against the cuDNN chain (the plain version), then both
    timed."""
    from .nn.fused_unet import _folded
    from .ops.cuda import conv_block

    levels = unet.levels
    names = [(f"enc_{i}", i) for i in range(levels)] + [("bottleneck", levels)]
    names += [(f"dec_{i}", i) for i in reversed(range(levels))]
    rng = np.random.default_rng(14)
    total = [0.0, 0.0]
    for name, level in names:
        block = getattr(unet, name)
        cin, c, hw = block.Conv_0.in_channels, block.Conv_0.out_channels, ROWS >> level
        x = torch.from_numpy(rng.random((BATCH, hw, hw, cin), dtype=np.float32)).to(DEVICE)
        args = _folded(block)
        prepped = conv_block.prepare(x, *args)
        y1 = torch.empty((BATCH, hw, hw, c), device=DEVICE)
        out = torch.empty_like(y1)
        got = conv_block.launch(*prepped, y1, out)
        want = conv_block.residual_block_reference(x, *args)
        torch.cuda.synchronize()
        zeros = torch.zeros_like(want)
        check_rel(f"  K5 {name} ({BATCH}, {hw}, {hw}, {cin}) -> {c}", got, zeros, want, zeros)
        del got, want, zeros
        k = cuda_ms(lambda: conv_block.launch(*prepped, y1, out), iters=3, warmup=1)
        r = cuda_ms(lambda: conv_block.residual_block_reference(x, *args), iters=3, warmup=1)
        tf = k5_flops(BATCH, hw, hw, cin, c) / 1e9
        total[0] += k
        total[1] += r
        print(f"  {name:10s} {hw:3d}^2 {cin:4d} -> {c:4d}: {tf:7.1f} GFLOP; K5 {k:7.2f} ms "
              f"({tf / k:5.1f} TFLOP/s), cuDNN chain {r:7.2f} ms ({tf / r:5.1f} TFLOP/s)", flush=True)
        del x, args, prepped, y1, out
    print(f"  nine blocks: K5 {total[0]:.1f} ms, cuDNN chain {total[1]:.1f} ms [{card}]", flush=True)


def k4_kernel(card):
    from .config import OpticsConfig
    from .ops import asm
    from .ops.cuda import transfer

    entry = _Entry("k4_transfer_stack",
                   "learned_hologram_gan_tpu_torch/csrc/k4_transfer_stack.cu",
                   "learned_hologram_gan_tpu/ops/pallas/transfer.py:104",
                   f"({K4_BATCH}, 3, 1024, 1024) x {len(K4_DISTANCES)} distances")
    plan = asm.make_plan(OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                      filter_radius_coefficient=0.45),
                         distances=K4_DISTANCES, device=DEVICE)
    rp, cp = plan.padded_rows, plan.padded_cols
    g0 = _random_complex(np.random.default_rng(13), (K4_BATCH, 3, rp, cp), DEVICE)
    args = (g0, plan.w_grid, plan.mask, plan.distances)
    got = transfer.apply_transfer_stack(*args)
    want = transfer.apply_transfer_stack_reference(*args)
    torch.cuda.synchronize()
    err = check_rel(f"K4 ({K4_BATCH}, 3, {rp}, {cp}) x {len(K4_DISTANCES)}",
                    got.real, got.imag, want.real, want.imag)
    del got, want
    hm = plan.H * plan.mask  # the cached H stack the library yardstick reads
    d, s = len(K4_DISTANCES), rp * cp
    nbytes = 8 * K4_BATCH * 3 * s + 4 * 3 * s + 4 * s + 4 * d + 8 * K4_BATCH * d * 3 * s
    # theta 2, sin + cos counted as 2, complex multiply 6, mask 2
    flops = 12.0 * K4_BATCH * d * 3 * s
    entry.add("K4", card, err,
              wrapper=lambda: transfer.apply_transfer_stack(*args),
              plain=lambda: transfer.apply_transfer_stack_reference(*args),
              library=lambda: g0[:, None] * hm[None], kernel=None, nbytes=nbytes, flops=flops)
    del hm, g0, args
    torch.cuda.empty_cache()
    return entry
