#!/usr/bin/env python
"""Start-up check of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Drives the port's paths on the card at full width, 384 x 384 input, pad
320 (1024 x 1024 padded grid), UNet base 64, weights from a fixed seed, in
float32 and then in bfloat16 (``--dtype bfloat16``, bench.py's
configuration): inference (RGBD -> POH -> 3-plane focal stack, the path of
``generatePOH.py --propagate``), the fused eval path, and GAN training
(``trainingModel.py --use_gan``: critic feature_d 32, 20 distances, batch
4, ratio 5).  Phases:

  1. environment: Python, torch, CUDA, nvcc, the card's name and power limit;
  2. build every kernel from ``csrc/`` with nvcc, one process per source,
     all started together (timed), and print ptxas' registers and spills
     of the redesigned kernels (K1's row pass, K2, K5 in both types at
     each tile width);
  3. each kernel (K1 in its inference and training modes, the two-H hat
     path's included, K2, K3) against its plain PyTorch version at the
     paths' shapes, with its time, the plain version's, a library yardstick
     and the card's lower bound for the same work; K1's row pass and K2's
     row adjoint alone against the bound of their own work
     (``kernel_bound_ms``; their registers and spills from ptxas in phase
     2), and each of K3's one-axis passes in TB/s beside cuFFT's;
  4. inference through ``generate_poh.main`` on synthetic RGBD files, with
     the launch counters reset before and read after, then the batch-16
     POH rate;
  5. training through ``training_model.main --use_gan --perceptual random``:
     one epoch of 2 steps on 8 seeded random samples, then one validation
     batch through the trainer's eval step, counters reset before and read
     after and each kernel's launches, by mode, held to what the code
     makes; then steps/s over 2 steps after a warm-up, their peak memory
     and a split of one step by CUDA events; then the same with
     ``--two_h_hat``, ``--critic_batching separate`` and ``--critic_batching
     full`` (phases 3 and 5 of the training slice live in
     ``learned_hologram_gan_tpu_torch/train_smoke.py``);
  6. the fused eval path (``generator_apply_fused``, K5 on every block:
     float32 as three TF32 products a product on wgmma) against the module
     path, K5 and K4 against their plain versions, then K5 on all nine
     blocks against its plain version (the cuDNN chain, TF32 off), block by
     block with TFLOP/s and its bound
     (``learned_hologram_gan_tpu_torch/fused_smoke.py``);
  7. bfloat16 inference at bench.py's configuration: ``generate_poh.main
     --dtype bfloat16``, then the batch-16 pipeline timed as bench.py times
     it, median and spread of 5 trials of 10
     (``learned_hologram_gan_tpu_torch/bf16_smoke.py``);
  8. the bfloat16 fused eval path, K5's bfloat16 variant (wgmma) on all
     nine blocks against its plain version and the cuDNN bfloat16 chain,
     block by block with TFLOP/s;
  9. bfloat16 training through ``training_model.main --use_gan --dtype
     bfloat16 --perceptual random``, with the same four step options, the
     default step's split also under ``torch.profiler``;
  10. the two-stage pretrain -> fine-tune workflow at the quality run's
     configuration (``learned_hologram_gan_tpu_torch/pretrain_smoke.py``):
     ``train_rgbd2ap`` and ``train_ap2poh`` (K1 conj_h and K3, forward and
     adjoint), each 2 epochs of 2 steps written as ``.msgpack``, then
     ``training_model --pretrained_part1/2 --freeze_part1 --resume_dir``
     for 1 epoch and again to 2, which resumes, beside an uninterrupted
     2-epoch run: launches held to what the code makes, part 1 and the
     restored state bit for bit, each stage's steps/s and peak memory;
  11. the high-resolution path (``learned_hologram_gan_tpu_torch/highres_smoke.py``):
     the 384 x 384 remat GAN step against the plain step; ``eval_quality``
     at its defaults (K1 and K3) and with ``--sequential`` (K3 per
     distance), the summaries held to each other; ``highres_train_bench``
     at 1088 x 1920 with remat and H on the fly, then without each lever,
     ms/step and peak memory; ``finetune_highres`` (device-resident
     bfloat16 data, 1 epoch) and its 1080p evaluation; the 4K zero-shot
     evaluation (2176 x 3840, pads 352 / 580, ``--sequential
     --no_cache_h``); each run's K1/K2/K3 launches held to what the code
     makes (at 1080p K1 and K2 on the mixed-radix rp 1728, no K3: the
     3048 columns have no plan; at 4K K1 on rp 2880 and K3 on 2880 x 5000);
  12. the three paths at a small size on the card (kernels) against the CPU
     (plain versions), same weights and draws (``card_check``), the train
     step with each of the four options, in float32 and in bfloat16, a
     stage-2 pretraining step, and the serving path in float32 and int8;
  13. serving (``learned_hologram_gan_tpu_torch/serve_smoke.py``):
     ``tools/serve_poh``'s ``PohService`` at its full-width defaults over
     HTTP in float32, bfloat16 and int8 (micro-batched /poh traffic, focal
     stacks at 3 and 21 depths, the u8 / u16 wire formats), each reply its
     served batch's row and each batch held to the path recomputed on the
     card, each focal stack to the plain versions of K1 and K3, and the
     launches of K1 (``conj_h``, ``from_spectrum``) and K3 to what the
     server makes; the int8 executor (im2col + ``torch._int_mm``)
     at every conv shape of the base-64 UNet bit for bit against exact CPU
     products; the int8 pipeline at bench.py's configuration beside phase
     7's bfloat16 rate, its split and peak memory; ``tools/bench_serve``;
  14. multi-device and polyphase training at full width
     (``learned_hologram_gan_tpu_torch/parallel_smoke.py``), in float32 and
     bfloat16: the data-parallel step at world size 1 under NCCL against
     the step with no mesh, the spatial mesh of 1 (row-sharded padded
     planes, every FFT through the all-to-all pencil path, no K1, K2 or
     K3) against the plain step with both steps' peak memory, the
     polyphase UNet's level 0 against the plain one (outputs, running
     statistics, gradients) and the polyphase step beside the plain one
     with both steps/s and peak memory, the float32 BatchNorm of a mesh
     and of the phase domain against ``F.batch_norm`` in float64 at every
     BatchNorm shape of the step, twice differentiated; ``generate_poh
     --mesh_devices 1`` and bench.py's focal stack through a
     distance-sharded plan; a 2-rank NCCL data-parallel step where the
     host has two cards;
  15. the mixed-radix FFT plans and the last modules
     (``learned_hologram_gan_tpu_torch/mixed_radix_smoke.py``): K3 at 768,
     1280, 1728, 2880 and 5000 along both axes and K1/K2 at those rp
     against their plain versions; the portrait path at 640 x 384 (pads 320
     / 192, a 1280 x 768 grid): ``make_synthetic_dataset`` (K3),
     ``generate_poh --propagate`` in float32 and bfloat16 (K1), the float32
     POH and stack against the CPU's, ``eval_quality`` (K1 and K3), the
     batch-4 forward; ``set_fft_backend("mxu")`` and ``"xla"`` against K3;
     the fourier generator at full width and against the CPU; an EXR round
     trip through ``exr2bin`` on the native decoder;
     ``make_synthetic_dataset`` at 384^2; a ``profile_op`` trace naming K3;
     JSON lines for K1, K2 and K3 at the grids of the portrait, 1080p and
     4K paths.

It raises on any failure.  It prints the kernels' JSON line and then, as
its last line, ``{"ok": true, "device": {...}}``.  It exits non-zero at once
when CUDA is absent.  It changes no global torch setting: the port keeps its
float32 convolutions out of TF32 itself, forward and backward, and phases
4-6 and 9 check that; phases 7-10 check that the bfloat16 paths ran their
generator and critic convolutions in bfloat16.
"""

import importlib.metadata
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time


BATCH = 16
ROWS = COLS = 384
PAD = 320
DISTANCES = (4e-4, 7e-4, 1e-3)  # np.linspace(4e-4, 1e-3, 3), generatePOH defaults
SUBPROCESS_TIMEOUT_S = 120
# the train step's options each training phase runs: the default (pair
# batching, the composed reconstruction) first, then the two-H hat path
# and the other two critic batchings
TRAIN_OPTIONS = [{}, dict(two_h_hat=True), dict(critic_batching="separate"),
                 dict(critic_batching="full")]


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== phase: {self.name}", flush=True)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== phase {self.name}: {time.perf_counter() - self.start:.1f} s wall",
                  flush=True)
        return False


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
                          check=True).stdout.strip()


def phase_kernels(card):
    import numpy as np
    import torch

    from learned_hologram_gan_tpu_torch.utils.cuda_measure import (
        MAX_REL_TOL, P999_REL_TOL, bound_ms, cuda_ms, k1_bound_ms, k1_row_pass_work,
        relative_errors)

    from learned_hologram_gan_tpu_torch.config import GeneratorConfig, OpticsConfig
    from learned_hologram_gan_tpu_torch.models import make_generator_plan
    from learned_hologram_gan_tpu_torch.ops import asm
    from learned_hologram_gan_tpu_torch.ops.cuda import spectral

    dev = torch.device("cuda")
    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45)
    gen_plan = make_generator_plan(cfg, device=dev)
    recon_optics = OpticsConfig(
        rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.35
    )
    recon_plan = asm.make_plan(recon_optics, distances=DISTANCES, device=dev)
    rng = np.random.default_rng(0)
    shape = (BATCH, 3, ROWS, COLS)
    amp = torch.from_numpy((1.1 * rng.random(shape)).astype(np.float32)).to(dev)
    phs = torch.from_numpy((2 * np.pi * rng.random(shape)).astype(np.float32)).to(dev)
    poh = torch.from_numpy((2 * np.pi * rng.random(shape)).astype(np.float32)).to(dev)

    # the two calls one forward makes: AP2POH's backward step, then the stack
    calls = [
        ("backward D=1 conj(H) no mask", gen_plan, asm.field(amp, phs),
         gen_plan.distances[:1], True, False),
        ("forward D=3 masked", recon_plan, asm.field(torch.ones_like(poh), poh),
         recon_plan.distances, False, True),
    ]
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, kernel_ms=0.0,
                  kernel_bound_ms=0.0)
    max_abs = 0.0
    bound_kinds = []
    for name, plan, g, dists, conj_h, use_mask in calls:
        args = asm.fused_args(plan, g, dists, conj_h=conj_h, use_mask=use_mask)
        fr, fi, wl2, dvec, mask, kcfg = args
        kr, ki = spectral.propagate_planes(*args)
        rr, ri = spectral.propagate_planes_reference(*args)
        torch.cuda.synchronize()
        abs_err, max_rel, p999_rel, scale = relative_errors(kr, ki, rr, ri)
        del kr, ki, rr, ri
        ok = max_rel <= MAX_REL_TOL and p999_rel <= P999_REL_TOL
        print(f"K1 {name}: planes {fr.shape[0]}, out {tuple(fr.shape[:1]) + (int(dvec.shape[0]), ROWS, COLS)}; "
              f"max|err| {abs_err:.3e} (max|plain| {scale:.3e}); rel max {max_rel:.3e} "
              f"(tol {MAX_REL_TOL:g}), rel p99.9 {p999_rel:.3e} (tol {P999_REL_TOL:g})",
              flush=True)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version ({name})")
        max_abs = max(max_abs, abs_err)

        # library yardstick: the composable torch.fft chain with H * mask cached
        h = asm._h_stack(plan)
        hm = (h * plan.mask if use_mask else h)[: dvec.shape[0]]
        if conj_h:
            hm = torch.conj(hm)

        def library():
            spec = torch.fft.fft2(asm.pad(plan, g))
            out = torch.fft.ifft2(spec[:, None] * hm[None])
            return asm.crop(plan, out)

        x = torch.fft.fft(torch.nn.functional.pad(torch.complex(fr, fi), (PAD, PAD)), dim=-1)
        t = dict(
            ms=cuda_ms(lambda: spectral.propagate_planes(*args)),
            plain_ms=cuda_ms(lambda: spectral.propagate_planes_reference(*args)),
            library_ms=cuda_ms(library),
            kernel_ms=cuda_ms(lambda: spectral.row_pass(x, wl2, dvec, mask, kcfg)),
        )
        bound, kind = k1_bound_ms(fr.shape[0], ROWS, COLS, kcfg[5], kcfg[6],
                                  int(dvec.shape[0]), mask)
        t["bound_ms"] = bound
        bound_kinds.append(kind)
        t["kernel_bound_ms"], kernel_kind = bound_ms(*k1_row_pass_work(
            fr.shape[0], ROWS, kcfg[5], kcfg[6], int(dvec.shape[0]), mask, False))
        print(f"K1 {name}: wrapper {t['ms']:.3f} ms (row-pass kernel alone "
              f"{t['kernel_ms']:.3f} ms), plain {t['plain_ms']:.3f} ms, torch.fft chain "
              f"{t['library_ms']:.3f} ms, bound {bound:.3f} ms ({kind}) [{card}]", flush=True)
        print(f"K1 {name}: row pass alone {t['kernel_ms']:.3f} ms against its own bound "
              f"{t['kernel_bound_ms']:.3f} ms ({kernel_kind}), "
              f"{100 * t['kernel_bound_ms'] / t['kernel_ms']:.1f} % of the bound [{card}]", flush=True)
        for k in totals:
            totals[k] += t[k]
        del x, h, hm
    torch.cuda.empty_cache()
    return dict(
        name="k1_asm_propagate_fwd",
        route="cuda",
        source="learned_hologram_gan_tpu_torch/csrc/k1_asm_propagate.cu",
        replaces="learned_hologram_gan_tpu/ops/pallas/spectral.py:686",
        max_abs_err=max_abs,
        ms=totals["ms"],
        plain_ms=totals["plain_ms"],
        bound_ms=totals["bound_ms"],
        bound_by="operations" if "operations" in bound_kinds else "bytes",
        library_ms=totals["library_ms"],
        kernel_only_ms=totals["kernel_ms"],
        kernel_bound_ms=totals["kernel_bound_ms"],
        shapes="one forward: (48 planes, D=1) + (48 planes, D=3), 384x384 in 1024x1024",
    )


def phase_slice(card):
    import numpy as np
    import torch

    from learned_hologram_gan_tpu_torch.utils.cuda_measure import MAX_REL_TOL, cuda_ms

    from learned_hologram_gan_tpu_torch import card_check, generate_poh
    from learned_hologram_gan_tpu_torch.config import GeneratorConfig, OpticsConfig
    from learned_hologram_gan_tpu_torch.models import make_generator, make_generator_plan
    from learned_hologram_gan_tpu_torch.ops import asm
    from learned_hologram_gan_tpu_torch.ops.cuda import spectral

    # removed on return, or at exit by its finalizer after a failure
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmp_dir.name
    rng = np.random.default_rng(1)
    for name in ("img", "depth"):
        rng.random((3, 3, ROWS, COLS)).astype(np.float32).tofile(os.path.join(tmp, f"{name}.bin"))
    recon_dir = os.path.join(tmp, "recon")
    argv = [
        "--img_path", os.path.join(tmp, "img.bin"),
        "--depth_path", os.path.join(tmp, "depth.bin"),
        "--index", "1", "--model_path", os.path.join(tmp, "random_init.pt"),
        "--poh_output_path", os.path.join(tmp, "poh.npy"), "--samplesNum", "3",
        "--propagate", "--num_intervals", "3", "--output_image_dir", recon_dir,
        "--device", "cuda",
    ]
    # the main path's run: counters to 0 just before, read just after
    spectral.reset_launch_counts()
    start = time.perf_counter()
    with card_check.record_conv_tf32([]) as tf32:
        result = generate_poh.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = spectral.row_pass.launches
    print(f"generate_poh.main (first call, weights init included): {wall:.2f} s; "
          f"K1 launches {launches}; TF32 on in {sum(tf32)} of {len(tf32)} convolutions",
          flush=True)
    if launches != 2:
        raise AssertionError(f"K1 launched {launches} times on the main path, want 2")
    if not tf32 or any(tf32):
        raise AssertionError("the main path ran float32 convolutions with TF32 on")

    poh, stack = result["poh"], result["focal_stack"]
    if tuple(poh.shape) != (1, 3, ROWS, COLS) or tuple(stack.shape) != (3, 3, ROWS, COLS):
        raise AssertionError(f"shapes: poh {tuple(poh.shape)}, stack {tuple(stack.shape)}")
    if not (torch.isfinite(poh).all() and torch.isfinite(stack).all()):
        raise AssertionError("non-finite POH or focal stack")
    if np.load(os.path.join(tmp, "poh.npy")).shape != (3, ROWS, COLS):
        raise AssertionError("POH file has the wrong shape")
    pngs = sorted(os.listdir(recon_dir))
    if pngs != ["0.png", "1.png", "2.png"]:
        raise AssertionError(f"PNGs written: {pngs}")
    for p in pngs:
        with open(os.path.join(recon_dir, p), "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{p} is not a PNG")

    tmp_dir.cleanup()

    # the focal stack against the plain version on the same POH
    recon = asm.make_plan(
        OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.35),
        distances=DISTANCES, device="cuda",
    )
    args = asm.fused_args(recon, asm.field(torch.ones_like(poh), poh), recon.distances)
    rr, ri = spectral.propagate_planes_reference(*args)
    ref = torch.sqrt(rr**2 + ri**2).reshape(1, 3, 3, ROWS, COLS).transpose(1, 2).reshape(3, 3, ROWS, COLS)
    stack_err = float((stack - ref).abs().max() / ref.max())
    print(f"focal stack vs plain version on the main path's POH: max rel {stack_err:.3e} "
          f"(tol {MAX_REL_TOL:g})", flush=True)
    if stack_err > MAX_REL_TOL:
        raise AssertionError("focal stack disagrees with the plain version")

    # batch-16 throughput: generator forward + 3-plane focal stack
    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45)
    model = make_generator(cfg, seed=0, device="cuda")
    gen_plan = make_generator_plan(cfg, device="cuda")
    rgbd = torch.from_numpy(np.random.default_rng(2).random((BATCH, 4, ROWS, COLS)).astype(np.float32)).cuda()

    def forward():
        with torch.inference_mode():
            p = model(gen_plan, rgbd)
            return p, asm.propagate_batch_multi(recon, torch.ones_like(p), p)

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    spectral.reset_launch_counts()
    start = time.perf_counter()
    for _ in range(iters):
        out = forward()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    if spectral.row_pass.launches != 2 * iters:
        raise AssertionError("K1 did not launch twice per forward")
    if not torch.isfinite(out[1]).all():
        raise AssertionError("non-finite batch-16 focal stack")
    rate = BATCH * iters / elapsed
    print(f"batch-{BATCH} forward (generator + 3-plane focal stack): "
          f"{elapsed / iters * 1e3:.1f} ms, {rate:.2f} POH/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches "
          f"{spectral.row_pass.launches} in {iters} forwards [{card}]", flush=True)

    # where the time goes: the forward's three stages, each timed alone
    with torch.inference_mode():
        amp, phs = model.part1(rgbd)
        split = dict(
            unet=cuda_ms(lambda: model.part1(rgbd), iters=3, warmup=1),
            ap2poh=cuda_ms(lambda: model.part2(gen_plan, amp, phs), iters=3, warmup=1),
            focal_stack=cuda_ms(
                lambda: asm.propagate_batch_multi(recon, torch.ones_like(out[0]), out[0]),
                iters=3, warmup=1,
            ),
        )
    print("batch-16 stages: RGBD2AP (UNet) {unet:.1f} ms, AP2POH (K1 D=1 + modulation + "
          "encode) {ap2poh:.1f} ms, focal stack (K1 D=3) {focal_stack:.1f} ms".format(**split)
          + f" [{card}]", flush=True)
    return launches


def phase_small_vs_cpu(dtype):
    from learned_hologram_gan_tpu_torch import card_check

    stats = card_check.card_vs_cpu("cuda", dtype=dtype)
    print("small slice through generate_poh ({dtype}), card (kernels) vs CPU (plain): POH "
          "phasor mean {poh_mean:.2e} p99 {poh_p99:.2e} max {poh_max:.2e}, JAX gate form "
          "{poh_gate:.2e}; focal stack p99.9 {stack_p999:.2e} max {stack_max:.2e}; TF32 on in "
          "{convs_tf32} of {convs} convolutions, computed in {conv_dtypes}; K1 launches "
          "{k1_launches}".format(**stats), flush=True)
    card_check.check(stats)
    for option in TRAIN_OPTIONS:
        stats = card_check.train_step_card_vs_cpu("cuda", dtype=dtype, **option)
        what = f"small train step ({dtype}{', ' if option else ''}{option or ''})"
        metrics = "; ".join(f"{k} {a:.6g} / {b:.6g}" for k, (a, b) in stats["metrics"].items())
        print(f"{what}, CPU / card: {metrics}", flush=True)
        print("{what}, card vs CPU: gradients G {grad_G_rel:.2e} D {grad_D_rel:.2e} of max|g|; "
              "running stats excess G {stats_G_excess:.2e} D {stats_D_excess:.2e}; TF32 on in "
              "{convs_forward_tf32} of {convs_forward} forwards, {convs_backward_tf32} of "
              "{convs_backward} backwards; computed in {conv_dtypes}; launches K1 {k1_modes}, "
              "K2 {k2_modes}, K3 {k3_launches}".format(what=what, **stats), flush=True)
        over = ", ".join(f"{bn}[{c}] {e:.2e} (bias apart {d:.2f} lr)"
                         for bn, c, e, d in stats["stats_D_mean_over_1e5"])
        print(f"{what}: critic running means over 1e-5 of excess: {over or 'none'}; largest excess "
              f"where the conv bias in front moved apart by < lr/2: "
              f"{stats['stats_D_mean_unexplained']:.2e}", flush=True)
        card_check.check_train_step(stats)
    stats = card_check.fused_card_vs_cpu("cuda", dtype=dtype)
    print("small fused generator ({dtype}), card (K5) vs CPU (plain): POH phasor mean "
          "{poh_mean:.2e} p99 {poh_p99:.2e} max {poh_max:.2e}, JAX gate form {poh_gate:.2e}; "
          "K5 launches {k5_launches} (polyphase {k5_launches_polyphase})".format(**stats),
          flush=True)
    card_check.check_fused(stats)
    if dtype == "float32":
        stats = card_check.stage2_step_card_vs_cpu("cuda")
        print("small stage-2 pretraining step, card vs CPU: loss {loss[0]:.6g} / {loss[1]:.6g}; "
              "gradients {grad_rel:.2e} of max|g|; launches K1 {k1_modes}, K2 {k2_launches}, "
              "K3 {k3_launches}".format(**stats), flush=True)
        card_check.check_stage2_step(stats)
        stats = card_check.serving_card_vs_cpu("cuda")
        for mode, st in stats.items():
            print("small serving path ({mode}), card vs CPU: POH phasor mean {poh_mean:.2e} p99 "
                  "{poh_p99:.2e} max {poh_max:.2e}; focal stack p99.9 {stack_p999:.2e} max "
                  "{stack_max:.2e}; launches {launches}".format(mode=mode, **st), flush=True)
        card_check.check_serving(stats)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr, flush=True)
        return 1
    from learned_hologram_gan_tpu_torch import (bf16_smoke, fft_ablation, fused_smoke, highres_smoke,
                                                mixed_radix_smoke, parallel_smoke, pretrain_smoke, serve_smoke,
                                                train_smoke)
    from learned_hologram_gan_tpu_torch.ops.cuda import build, conv_block, fft, spectral, transfer

    t0 = time.perf_counter()

    with Phase("environment"):
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
              f"capability {torch.cuda.get_device_capability(0)}", flush=True)
        print(run([build.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
        triton = importlib.util.find_spec("triton")
        print(f"triton: {importlib.metadata.version('triton') if triton else 'absent'} "
              "(not used: the port's kernels are CUDA C++)", flush=True)
        card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        card = card.splitlines()[0]
        print(card, flush=True)

    with Phase("build"):
        start = time.perf_counter()
        names = [spectral.KERNEL_NAME, fft.KERNEL_NAME, transfer.KERNEL_NAME, conv_block.KERNEL_NAME]
        # K1's and K3's mixed-radix plans: one library per plan, those the paths use
        mixed = [(name, d) for name in (spectral.KERNEL_NAME, fft.KERNEL_NAME)
                 for d in mixed_radix_smoke.build_defines_of_the_paths() if d]
        built = build.build_jobs([(name, ()) for name in names] + mixed)
        results = {name: built[(name, ())] for name in names}
        print(f"nvcc ({' '.join(build.NVCC_FLAGS)}), one process per source and macro set, "
              f"{len(built)} at up to {os.cpu_count()} at once: {time.perf_counter() - start:.1f} s wall",
              flush=True)
        for (name, defines), res in built.items():
            print(f"{res.path.name} {' '.join(defines)}: {'cached' if res.cached else 'built'} in "
                  f"{res.seconds:.1f} s", flush=True)
            for line in res.log.splitlines():
                if "ptxas" in line or "spill" in line:
                    print(line.strip(), flush=True)
        # the redesigned kernels' registers and spills, by name
        registers = {}
        k5 = [(f"K5 {label}, {bn} channels a tile", conv_block.KERNEL_NAME,
               f"conv_wgmma_kernelI{mangled}Li{bn}E")
              for label, mangled, widths in (("bf16 wgmma", "13__nv_bfloat16", (256, 128, 64)),
                                             ("f32 3xTF32 wgmma", "f", (128, 64)))
              for bn in widths]
        for label, lib, entry in [
                ("K1 row pass (E = 32)", spectral.KERNEL_NAME, "asm_row_pass_kernelILi32E"),
                ("K2 row adjoint (E = 32)", spectral.KERNEL_NAME, "asm_row_adjoint_kernelILi32E")] + k5:
            report = fft_ablation._ptxas(results[lib].log, entry)
            if report is None:
                raise AssertionError(f"ptxas reported nothing for {entry}")
            registers[label] = dict(registers=report[0], spill_bytes=report[1])
            print(f"{label}: {report[0]} registers, {report[1]} bytes spilled", flush=True)
        for mod in (fft, transfer, conv_block):
            mod._kernel_fn()
        spectral._kernel_fns()
        for name, defines in mixed:
            (spectral._kernel_fns if name == spectral.KERNEL_NAME else fft._kernel_fn)(defines)

    with Phase("kernels vs plain versions: inference (batch 16)"):
        k1 = phase_kernels(card)

    with Phase("kernels vs plain versions: training (batch 4, 20 distances), and the two-H mode"):
        train_kernels = train_smoke.training_kernels(card)
        train_kernels.update(train_smoke.two_h_kernels(card))

    # K4 lies on no path: its count over the three main paths' runs must stay 0
    with Phase("main path: generate_poh at full width, then batch-16 rate"):
        transfer.reset_launch_counts()
        k1["launches"] = phase_slice(card)
        k4_launches = transfer.apply_transfer_stack.launches

    runs = []
    for option in TRAIN_OPTIONS:
        with Phase(f"main path: training_model --use_gan at full width {option or ''}"):
            transfer.reset_launch_counts()
            runs.append(train_smoke.training_path(card, **option))
            k4_launches += transfer.apply_transfer_stack.launches
    launches = runs[0]["launches"]
    train_kernels["k1_train"]["launches"] = (launches["k1"]["from_spectrum+per_plane"]
                                             + launches["k1"]["from_spectrum"])
    train_kernels["k2"]["launches"] = sum(launches["k2"].values())
    train_kernels["k3"]["launches"] = launches["k3"]
    two_h = runs[TRAIN_OPTIONS.index(dict(two_h_hat=True))]["launches"]
    train_kernels["k1_two_h"]["launches"] = two_h["k1"]["field+per_plane"]
    train_kernels["k2_two_h"]["launches"] = two_h["k2"]["field+per_plane"]

    with Phase("fused eval path: K5 and K4 vs plain versions, then the path at batch 16"):
        k5 = fused_smoke.k5_kernel(card)
        k4 = fused_smoke.k4_kernel(card)
        k5_launches, k4_fused, k5_unet = fused_smoke.fused_path(card)
    k4_launches += k4_fused

    with Phase("bf16 main path: generate_poh --dtype bfloat16, then bench.py's configuration"):
        transfer.reset_launch_counts()
        bf16_rate = bf16_smoke.inference(card)["poh_per_s"]
        k4_launches += transfer.apply_transfer_stack.launches

    with Phase("bf16 fused eval path: K5 bf16 on every block, then vs plain on the nine blocks"):
        k5_bf16_launches, k4_fused, k5_bf16 = fused_smoke.fused_path(card, "bfloat16")
    k4_launches += k4_fused

    for option in TRAIN_OPTIONS:
        with Phase(f"bf16 main path: training_model --use_gan --dtype bfloat16 at full width {option or ''}"):
            transfer.reset_launch_counts()
            runs.append(train_smoke.training_path(card, "bfloat16", **option, profile=not option))
            k4_launches += transfer.apply_transfer_stack.launches
    with Phase("main path: pretrain -> fine-tune at full width (stage 1, stage 2, "
               "--freeze_part1 --resume_dir twice)"):
        transfer.reset_launch_counts()
        pretrain = pretrain_smoke.workflow(card)
        k4_launches += transfer.apply_transfer_stack.launches
    k1["stage2_launches"] = pretrain["stage2"]["launches"]["k1"]["conj_h"]
    train_kernels["k3"]["stage2_launches"] = pretrain["stage2"]["launches"]["k3"]
    with Phase("high-resolution path: the 384^2 remat step and evaluation, 1080p training and "
               "fine-tune, 4K zero-shot evaluation"):
        transfer.reset_launch_counts()
        highres = highres_smoke.run(card)
        k4_launches += transfer.apply_transfer_stack.launches
    eval384 = highres["eval_384"]
    k1["eval384_launches"] = eval384["fused"]["launches"]["k1"]["conj_h"]
    train_kernels["k1_train"]["eval384_launches"] = eval384["fused"]["launches"]["k1"]["from_spectrum"]
    train_kernels["k3"]["eval384_launches"] = {k: eval384[k]["launches"]["k3"] for k in ("fused", "sequential")}
    train_kernels["k1_train"]["remat_step_launches"] = highres["remat_step"]["launches_remat"]["k1"]

    for dtype in ("float32", "bfloat16"):
        with Phase(f"small slices: card vs CPU, {dtype}"):
            phase_small_vs_cpu(dtype)

    with Phase("serving: serve_poh at full width in float32, bfloat16 and int8, the int8 executor, "
               "the int8 pipeline, bench_serve"):
        transfer.reset_launch_counts()
        serving = serve_smoke.run(card, bf16_rate)
        k4_launches += transfer.apply_transfer_stack.launches
    if k4_launches:
        raise AssertionError(f"K4 launched {k4_launches} times on the main paths, want 0")
    served = serving["float32"]["counts"]
    k1["serve_launches"] = served["k1"]["conj_h"]
    train_kernels["k1_train"]["serve_launches"] = served["k1"]["from_spectrum"]
    train_kernels["k3"]["serve_launches"] = served["k3"]

    with Phase("multi-device and polyphase training at full width: data-parallel (NCCL), spatial mesh, "
               "polyphase level 0, generate_poh --mesh_devices"):
        transfer.reset_launch_counts()
        par = parallel_smoke.run(card)
        if transfer.apply_transfer_stack.launches:
            raise AssertionError("K4 launched on the parallel legs, want 0")
    k1["mesh_launches"] = par["generate_poh"]["cli_launches"]["k1"]
    for key, name in (("k1_train", "k1"), ("k2", "k2"), ("k3", "k3")):
        train_kernels[key]["parallel_launches"] = {
            f"{dtype} {leg}": launches[leg][name] for dtype, legs in par["legs"].items()
            for launches in (legs["launches"],) for leg in ("dp", "spatial", "poly")}

    with Phase("mixed-radix FFT plans: K1/K2/K3 at 768-5000, the portrait path, the FFT backends, "
               "the fourier generator, exr2bin, make_synthetic_dataset, the profiler"):
        transfer.reset_launch_counts()
        mixed_entries, _ = mixed_radix_smoke.kernels(card)
        portrait = mixed_radix_smoke.portrait(card)
        mixed_radix_smoke.backends(card)
        mixed_radix_smoke.fourier(card)
        mixed_radix_smoke.exr_round_trip(card)
        synth384 = mixed_radix_smoke.synthetic_384(card)
        mixed_radix_smoke.trace_k3_both(card, time.perf_counter() - t0)
        if transfer.apply_transfer_stack.launches:
            raise AssertionError("K4 launched in the mixed-radix phase, want 0")
    hd = highres["train_1080p"]["remat, H on the fly"]["launches"]
    uhd = highres["eval_4k"]["launches"]
    mixed_kernels = [
        dict(mixed_entries["k1_portrait"].json(), launches=sum(portrait["generate_poh_launches"]["k1"].values()),
             eval_launches=portrait["eval_launches"]["k1"]),
        dict(mixed_entries["k3_portrait"].json(),
             launches=portrait["synth_launches"]["k3"] + portrait["eval_launches"]["k3"],
             synth_launches=portrait["synth_launches"]["k3"], eval_launches=portrait["eval_launches"]["k3"]),
        dict(mixed_entries["k1_1080p"].json(), launches=sum(hd["k1"].values()), by_mode=hd["k1"],
             finetune_launches=highres["finetune_1080p"]["launches"]["k1"]),
        dict(mixed_entries["k2_1080p"].json(), launches=sum(hd["k2"].values()), by_mode=hd["k2"],
             finetune_launches=highres["finetune_1080p"]["launches"]["k2"]),
        dict(mixed_entries["k1_4k"].json(), launches=sum(uhd["k1"].values())),
        dict(mixed_entries["k3_4k"].json(), launches=uhd["k3"]),
    ]
    train_kernels["k3"]["synthetic_384_launches"] = synth384["launches"]["k3"]

    print("train steps at full width, batch 4, ratio 5 (host clock):", flush=True)
    for r in runs:
        print(f"  {r['label']:45s} {r['steps_per_s']:.3f} steps/s, peak {r['peak_gib']:.2f} GiB; "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in r["split"].items()) + f" [{card}]", flush=True)
    for stage in ("stage1", "stage2"):
        r = pretrain[stage]
        print(f"  pretraining {stage}, batch 4: {r['steps_per_s']:.3f} steps/s, peak "
              f"{r['peak_gib']:.2f} GiB [{card}]", flush=True)
    for dtype, legs in par["legs"].items():
        print(f"  {dtype} polyphase level 0 {legs['steps_per_s']['poly']:.3f} steps/s, peak "
              f"{legs['peak_gib']['poly']:.2f} GiB; plain {legs['steps_per_s']['plain']:.3f} steps/s, peak "
              f"{legs['peak_gib']['plain']:.2f} GiB; one step's peak on the spatial mesh of 1 "
              f"{legs['step_peak_gib']['spatial']:.2f} GiB, plain {legs['step_peak_gib']['plain']:.2f} GiB "
              f"[{card}]", flush=True)
    p = serving["pipeline"]
    print(f"inference at bench.py's configuration, batch 16: int8 stage 1 {p['poh_per_s']:.2f} POH/s "
          f"(spread {p['spread']:.2f}, peak {p['peak_gib']:.2f} GiB), bfloat16 module path "
          f"{p['bf16_poh_per_s']:.2f} POH/s [{card}]", flush=True)
    print(f"total wall {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    for key in ("k2", "k2_two_h"):
        train_kernels[key].update(registers["K2 row adjoint (E = 32)"])
    kernels = [k1, train_kernels["k1_train"], train_kernels["k2"], train_kernels["k3"],
               train_kernels["k1_two_h"], train_kernels["k2_two_h"],
               dict(k4.json(), launches=k4_launches), dict(k5.json(), launches=k5_launches),
               dict(k5_unet.json(), launches=k5_launches,
                    registers={k: v for k, v in registers.items() if k.startswith("K5 f32")}),
               dict(k5_bf16.json(), launches=k5_bf16_launches,
                    registers={k: v for k, v in registers.items() if k.startswith("K5 bf16")})] + mixed_kernels
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
