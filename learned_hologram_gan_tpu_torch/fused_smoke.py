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

from .card_check import randomize_batch_norms
from .nn.blocks import ResidualBlock
from .train_smoke import _Entry, _random_complex
from .utils.cuda_measure import (
    MAX_REL_TOL,
    P999_REL_TOL,
    PEAK_BF16_FLOP_PER_S,
    PEAK_F32_FLOP_PER_S,
    check_rel,
    cuda_ms,
)

BATCH = 16
ROWS = COLS = 384
PAD = 320
DISTANCES = (4e-4, 7e-4, 1e-3)  # np.linspace(4e-4, 1e-3, 3), generatePOH defaults
# (name, H = W, Cin, Cout) of two of the full-width UNet's nine blocks
K5_CASES = (("enc_0", 384, 4, 64), ("dec_1", 192, 256, 128))
# the training focal stack: trainingModel.py's 20 distances, batch 4
K4_BATCH, K4_DISTANCES = 4, np.linspace(-4e-4, 0.0, 21)[:-1]
WARMUP, REPS = 2, 3
DEVICE = "cuda"
# The fused POH against the module path's on the same card, as phasors.
# Both are float32 with TF32 off and differ only in summation order and in
# the folded BatchNorm's rounding; the readings at the bench config were
# mean 4.7e-7, p99 1.7e-6, max 8.9e-6 (NVIDIA H100 80GB HBM3, 700 W).  The
# bounds keep about 20x of headroom for other seeds, and stay 100-250x
# tighter than the cross-framework bounds of PERF.md section 2.
SAME_CARD_MEAN_TOL, SAME_CARD_P99_TOL, SAME_CARD_MAX_TOL = 1e-5, 5e-5, 2e-4
# In bfloat16 the fused path rounds in other places than the module path
# (K5 rounds y1 and its output once each, the module every conv output and
# bias add; BatchNorm folds in float32 before the weights round), so the two
# are held to the JAX package's own bfloat16 gates between its fused and
# module paths (tests/test_fused_unet.py): the UNet output within 2e-2
# (:49, :122), the POH within 5e-2 (1 + |POH|) (:83).  That POH gate is a
# max over the 6,144 phases of its test (2 x 3 x 32 x 32); acos amplifies
# rounding without bound as the amplitude nears 1, so a max over the 7.1
# million phases of a batch of 16 at 384^2 reads further into the same
# tail.  The gate is applied at the quantile its max stands for, one phase
# in 6,144: 1 - 1/6144.
BF16_UNET_TOL, BF16_POH_TOL = 2e-2, 5e-2
BF16_POH_QUANTILE = 1.0 - 1.0 / 6144
# K5 in bfloat16 against its plain version, relative to max |plain|.  The
# plain version rounds to bfloat16 seven times on the way to an output
# (conv1's output, + b1, conv2's output, + b2, the shortcut's output, + b3,
# the sum; the ReLUs are exact), K5 twice (y1, the output).  Each rounding
# moves a value by at most u = 2^-8 of itself, and with Xavier-scaled,
# folded weights the values on the way are of the order of max |out|: 9 u
# at worst.  At the 99.9th percentile the roundings that reach an output
# through conv2's 9 C products have either sign and average: 2 u.
K5_BF16_MAX_REL_TOL, K5_BF16_P999_REL_TOL = 9 * 2.0**-8, 2 * 2.0**-8


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


def _quantile(x, q):
    return float(x.flatten().kthvalue(max(1, round(q * x.numel()))).values)


def _poh_errors(got, want):
    """|exp(i got) - exp(i want)| = 2 |sin((got - want) / 2)| on the card,
    in float64: its mean, p99 and max, and the JAX gate's form (divided by
    1 + |want|) at BF16_POH_QUANTILE and at its max."""
    got, want = got.double(), want.double()
    d = 2.0 * torch.sin(0.5 * (got - want)).abs()
    gate = d / (1.0 + want.abs())
    return (float(d.mean()), _quantile(d, 0.99), float(d.max()),
            _quantile(gate, BF16_POH_QUANTILE), float(gate.max()))


def _unet_flops(batch, hw, base=64, levels=4):
    """K5's work over the nine residual blocks of one UNet forward: enc_0
    to enc_3, the bottleneck, dec_3 to dec_0."""
    blocks = [(hw, 4, base)]
    blocks += [(hw >> i, base << (i - 1), base << i) for i in range(1, levels)]
    blocks.append((hw >> levels, base << (levels - 1), base << levels))
    blocks += [(hw >> i, base << (i + 1), base << i) for i in reversed(range(levels))]
    return sum(k5_flops(batch, s, s, cin, c) for s, cin, c in blocks)


def fused_path(card, dtype="float32"):
    """The fused eval path at the bench config in ``dtype``; returns K5's
    and K4's launches on the main path's run (one forward) and
    :func:`block_split`'s entry."""
    from .config import GeneratorConfig, OpticsConfig
    from .models import generator_apply_fused, make_generator, make_generator_plan
    from .nn import fused_unet
    from .ops import asm
    from .ops.cuda import conv_block, spectral, transfer

    bf16 = dtype == "bfloat16"
    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45,
                          dtype=dtype)
    rng = np.random.default_rng(12)
    model = randomize_batch_norms(make_generator(cfg, seed=0, device="cpu"), rng).to(DEVICE)
    gen_plan = make_generator_plan(cfg, device=DEVICE)
    recon = asm.make_plan(OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                       filter_radius_coefficient=0.35),
                          distances=DISTANCES, device=DEVICE)
    rgbd = torch.from_numpy(rng.random((BATCH, 4, ROWS, COLS)).astype(np.float32)).to(DEVICE)
    unet = model.part1.unet

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
    print(f"fused path ({dtype}), one batch-{BATCH} forward + focal stack: K5 launches {k5} "
          f"(polyphase level 0: {k5_poly}), K1 launches {k1}, K4 launches {k4}", flush=True)
    if (k5, k5_poly, k1, k4) != (9, 7, 2, 0):
        raise AssertionError("want 9 K5 launches (7 with polyphase level 0), 2 K1, no K4")
    if tuple(poh.shape) != (BATCH, 3, ROWS, COLS) or tuple(stack.shape) != (3 * BATCH, 3, ROWS, COLS):
        raise AssertionError(f"shapes: poh {tuple(poh.shape)}, stack {tuple(stack.shape)}")
    if not (torch.isfinite(poh).all() and torch.isfinite(stack).all()
            and torch.isfinite(poh_poly).all()):
        raise AssertionError("non-finite fused POH or focal stack")

    ref, _ = module()
    for label, p in (("fused", poh), ("fused, polyphase level 0", poh_poly)):
        mean, p99, worst, gate, gate_max = _poh_errors(p, ref)
        if bf16:
            print(f"{label} POH vs module path on the card ({dtype}): phasor mean {mean:.2e}, p99 "
                  f"{p99:.2e}, max {worst:.2e}; JAX gate form at p{100 * BF16_POH_QUANTILE:.3f} "
                  f"{gate:.2e} (tol {BF16_POH_TOL:g}), at max {gate_max:.2e}", flush=True)
            ok = gate <= BF16_POH_TOL
        else:
            print(f"{label} POH vs module path on the card: phasor mean {mean:.2e} (tol "
                  f"{SAME_CARD_MEAN_TOL:g}), p99 {p99:.2e} (tol {SAME_CARD_P99_TOL:g}), max "
                  f"{worst:.2e} (tol {SAME_CARD_MAX_TOL:g})", flush=True)
            ok = (mean <= SAME_CARD_MEAN_TOL and p99 <= SAME_CARD_P99_TOL
                  and worst <= SAME_CARD_MAX_TOL)
        if not ok:
            raise AssertionError(f"{label} POH disagrees with the module path")
    del poh, stack, poh_poly, ref
    x = rgbd.permute(0, 2, 3, 1).to(unet.dtype)
    if bf16:
        # the UNet's own output, before acos: the JAX gate of the fused UNet
        with torch.inference_mode():
            for poly in (False, True):
                d = (fused_unet.unet_apply_fused(unet, x, polyphase_level0=poly).float()
                     - unet(rgbd).float().permute(0, 2, 3, 1)).abs().max()
                print(f"fused UNet vs module UNet on the card (bfloat16, polyphase {poly}): max "
                      f"{float(d):.3e} (tol {BF16_UNET_TOL:g})", flush=True)
                if not float(d) <= BF16_UNET_TOL:
                    raise AssertionError("the bfloat16 fused UNet disagrees with the module")

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
        print(f"batch-{BATCH} forward + 3-plane focal stack ({dtype}), {k}: median "
              f"{med * 1e3:.1f} ms of {REPS} (min {min(times[k]) * 1e3:.1f}, max "
              f"{max(times[k]) * 1e3:.1f}), {BATCH / med:.2f} POH/s, peak memory "
              f"{peak[k]:.2f} GiB [{card}]", flush=True)

    # the UNet stage alone: the fused UNet (K5 on all nine blocks) against
    # the module's cuDNN forward
    with torch.inference_mode():
        unet_fused = cuda_ms(lambda: fused_unet.unet_apply_fused(unet, x), iters=3, warmup=1)
        unet_module = cuda_ms(lambda: model.part1(rgbd), iters=3, warmup=1)
        blocks = [m for m in unet.modules() if isinstance(m, ResidualBlock)]
        fold = cuda_ms(lambda: [fused_unet._folded(b) for b in blocks], iters=3, warmup=1)
    tflop = _unet_flops(BATCH, ROWS) / 1e12
    print(f"batch-{BATCH} UNet stage ({dtype}): fused (K5) {unet_fused:.1f} ms, module (cuDNN) "
          f"{unet_module:.1f} ms; the nine blocks' {tflop:.2f} TFLOP at "
          f"{tflop / unet_fused * 1e3:.1f} TFLOP/s through the fused UNet; folding the "
          f"{len(blocks)} blocks' BatchNorms {fold:.3f} ms of it [{card}]", flush=True)
    return k5, k4, block_split(card, unet)


def block_split(card, unet):
    """Each of the nine blocks at batch 16 in the UNet's dtype, on a seeded
    input of its shape with the model's folded weights: K5 checked against
    the cuDNN chain (the plain version, which is also the library
    yardstick: no single PyTorch call computes a block), then both timed.
    Returns the nine blocks' JSON entry, ``launches`` still to be filled
    in."""
    from .nn.fused_unet import _folded
    from .ops.cuda import conv_block

    dtype = unet.dtype
    bf16 = dtype == torch.bfloat16
    itemsize = 2 if bf16 else 4
    entry = _Entry("k5_residual_block_bf16" if bf16 else "k5_residual_block",
                   "learned_hologram_gan_tpu_torch/csrc/k5_residual_block.cu",
                   "learned_hologram_gan_tpu/ops/pallas/conv_block.py:223",
                   f"batch {BATCH}, {str(dtype)[6:]}: the nine blocks of one UNet forward")
    tols = (K5_BF16_MAX_REL_TOL, K5_BF16_P999_REL_TOL) if bf16 else (MAX_REL_TOL, P999_REL_TOL)
    peak_rate = PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S
    levels = unet.levels
    names = [(f"enc_{i}", i) for i in range(levels)] + [("bottleneck", levels)]
    names += [(f"dec_{i}", i) for i in reversed(range(levels))]
    rng = np.random.default_rng(14)
    total = [0.0, 0.0]
    for name, level in names:
        block = getattr(unet, name)
        cin, c, hw = block.Conv_0.in_channels, block.Conv_0.out_channels, ROWS >> level
        x = torch.from_numpy(rng.random((BATCH, hw, hw, cin), dtype=np.float32)).to(DEVICE, dtype)
        args = _folded(block)
        w1, b1, w2, b2, w3, b3 = args
        prepped = conv_block.prepare(x, w1.to(dtype), b1, w2.to(dtype), b2, w3.to(dtype), b3)
        y1 = torch.empty((BATCH, hw, hw, c), device=DEVICE, dtype=dtype)
        out = torch.empty_like(y1)
        got = conv_block.launch(*prepped, y1, out).float()
        want = conv_block.residual_block_reference(x, *args).float()
        torch.cuda.synchronize()
        zeros = torch.zeros_like(want)
        err = check_rel(f"  K5 {name} ({BATCH}, {hw}, {hw}, {cin}) -> {c}, {str(dtype)[6:]}",
                        got, zeros, want, zeros, *tols)
        del got, want, zeros
        n = BATCH * hw * hw
        nbytes = itemsize * (n * (cin + c) + 9 * cin * c + 9 * c * c + cin * c) + 4 * 3 * c
        flops = k5_flops(BATCH, hw, hw, cin, c)
        before = entry.kernel_ms, entry.t["plain_ms"]
        entry.add(f"  {name}", card, err,
                  wrapper=lambda: conv_block.fused_residual_block(x, *args),
                  plain=lambda: conv_block.residual_block_reference(x, *args),
                  library=lambda: conv_block.residual_block_reference(x, *args),
                  kernel=lambda: conv_block.launch(*prepped, y1, out),
                  nbytes=nbytes, flops=flops, peak_flop_per_s=peak_rate, iters=2)
        k, r = entry.kernel_ms - before[0], entry.t["plain_ms"] - before[1]
        tf = flops / 1e9
        total[0] += k
        total[1] += r
        print(f"  {name:10s} {hw:3d}^2 {cin:4d} -> {c:4d}: {tf:7.1f} GFLOP; K5 {k:7.2f} ms "
              f"({tf / k:5.1f} TFLOP/s), cuDNN chain {r:7.2f} ms ({tf / r:5.1f} TFLOP/s)", flush=True)
        del x, args, prepped, y1, out
    print(f"  nine blocks ({str(dtype)[6:]}): K5 {total[0]:.1f} ms, cuDNN chain {total[1]:.1f} ms "
          f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    return entry


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
