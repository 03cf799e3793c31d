#!/usr/bin/env python
"""Start-up check of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Drives the port's main path (RGBD -> POH -> 3-plane focal stack, the path
of ``generatePOH.py --propagate``) on the card at full width: 384 x 384
input, pad 320 (1024 x 1024 padded grid), UNet base 64, float32, weights
from a fixed seed.  Phases:

  1. environment: Python, torch, CUDA, nvcc, the card's name and power limit;
  2. build every kernel of the path from ``csrc/`` with nvcc (timed);
  3. each kernel against its plain PyTorch version at the main-path shapes
     (batch 16), with its time, the plain version's, a library yardstick
     and the card's lower bound for the same work;
  4. the slice through ``generate_poh.main`` on synthetic RGBD files, with
     the launch counters reset before and read after, then the batch-16
     POH rate;
  5. the slice at a small size through ``generate_poh.main`` on the card
     (kernels) against the CPU (plain versions), same weights
     (``card_check``).

It raises on any failure.  It prints the kernels' JSON line and then, as
its last line, ``{"ok": true, "device": {...}}``.  It exits non-zero at once
when CUDA is absent.  It changes no global torch setting: the port keeps its
float32 convolutions out of TF32 itself, and phases 4 and 5 check that.
"""

import importlib.metadata
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth, f32 non-tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

BATCH = 16
ROWS = COLS = 384
PAD = 320
DISTANCES = (4e-4, 7e-4, 1e-3)  # np.linspace(4e-4, 1e-3, 3), generatePOH defaults
# K1 against its plain version, relative to max |plain|: FFT rounding in f32
# over three 1024-point transforms is ~1e-6; H is computed in the same f32
# operation order on both sides.
K1_MAX_REL_TOL = 1e-4
K1_P999_REL_TOL = 1e-5


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
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120, check=True).stdout.strip()


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fft_flops(n, count):
    """5 n log2 n real operations per complex n-point FFT."""
    import math

    return 5.0 * n * math.log2(n) * count


def k1_bound_ms(p, rows, cols, rp, cp, num_d, masked):
    """Least time for propagate_planes' work on these shapes: the larger of
    its bytes (fr, fi, wl2, dists, mask read once; the cropped result written
    once) over HBM bandwidth and its FFT + H arithmetic over the f32 rate."""
    in_bytes = 2 * p * rows * cols * 4 + p * 4 + num_d * 4 + (rp * cp * 4 if masked else 0)
    out_bytes = 2 * p * num_d * rows * cols * 4
    flops = (
        fft_flops(cp, p * rows)  # column transform of the nonzero rows
        + fft_flops(rp, p * cp)  # row transform, once per plane
        + fft_flops(rp, p * num_d * cp)  # inverse row transform per distance
        + fft_flops(cp, p * num_d * rows)  # inverse column transform, cropped rows
        # H: 2 mul + add for fx^2+fy^2, sub, sqrt, 2 mul for theta, sin+cos
        # counted as 2, complex multiply 6, mask 2
        + p * num_d * rp * cp * (8 + 6 + (2 if masked else 0))
    )
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def relative_errors(kr, ki, rr, ri):
    import torch

    err = torch.sqrt((kr - rr) ** 2 + (ki - ri) ** 2).flatten()
    scale = torch.sqrt(rr**2 + ri**2).max()
    rel = err / scale
    p999 = rel.sort().values[int(0.999 * (rel.numel() - 1))]
    return float(err.max()), float(rel.max()), float(p999), float(scale)


def phase_kernels(card):
    import numpy as np
    import torch

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
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, kernel_ms=0.0)
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
        ok = max_rel <= K1_MAX_REL_TOL and p999_rel <= K1_P999_REL_TOL
        print(f"K1 {name}: planes {fr.shape[0]}, out {tuple(fr.shape[:1]) + (int(dvec.shape[0]), ROWS, COLS)}; "
              f"max|err| {abs_err:.3e} (max|plain| {scale:.3e}); rel max {max_rel:.3e} "
              f"(tol {K1_MAX_REL_TOL:g}), rel p99.9 {p999_rel:.3e} (tol {K1_P999_REL_TOL:g})",
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
                                  int(dvec.shape[0]), mask is not None)
        t["bound_ms"] = bound
        bound_kinds.append(kind)
        print(f"K1 {name}: wrapper {t['ms']:.3f} ms (row-pass kernel alone "
              f"{t['kernel_ms']:.3f} ms), plain {t['plain_ms']:.3f} ms, torch.fft chain "
              f"{t['library_ms']:.3f} ms, bound {bound:.3f} ms ({kind}) [{card}]", flush=True)
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
        shapes="one forward: (48 planes, D=1) + (48 planes, D=3), 384x384 in 1024x1024",
    )


def phase_slice(card):
    import numpy as np
    import torch

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
    spectral.propagate_planes.launches = 0
    start = time.perf_counter()
    with card_check.record_conv_tf32([]) as tf32:
        result = generate_poh.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = spectral.propagate_planes.launches
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
          f"(tol {K1_MAX_REL_TOL:g})", flush=True)
    if stack_err > K1_MAX_REL_TOL:
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
    spectral.propagate_planes.launches = 0
    start = time.perf_counter()
    for _ in range(iters):
        out = forward()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    if spectral.propagate_planes.launches != 2 * iters:
        raise AssertionError("K1 did not launch twice per forward")
    if not torch.isfinite(out[1]).all():
        raise AssertionError("non-finite batch-16 focal stack")
    rate = BATCH * iters / elapsed
    print(f"batch-{BATCH} forward (generator + 3-plane focal stack): "
          f"{elapsed / iters * 1e3:.1f} ms, {rate:.2f} POH/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches "
          f"{spectral.propagate_planes.launches} in {iters} forwards [{card}]", flush=True)

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


def phase_small_vs_cpu():
    from learned_hologram_gan_tpu_torch import card_check

    stats = card_check.card_vs_cpu("cuda")
    print("small slice through generate_poh, card (kernels) vs CPU (plain): POH phasor "
          "mean {poh_mean:.2e} p99 {poh_p99:.2e} max {poh_max:.2e}; focal stack p99.9 "
          "{stack_p999:.2e} max {stack_max:.2e}; TF32 on in {convs_tf32} of {convs} "
          "convolutions; K1 launches {k1_launches}".format(**stats), flush=True)
    card_check.check(stats)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr, flush=True)
        return 1
    from learned_hologram_gan_tpu_torch.ops.cuda import build, spectral

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
        res = build.build_library(spectral.KERNEL_NAME)
        print(f"{res.path.name}: {'cached' if res.cached else 'built'} in {res.seconds:.1f} s "
              f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
        for line in res.log.splitlines():
            if "ptxas" in line:
                print(line.strip(), flush=True)
        spectral._kernel_fn()

    with Phase("kernels vs plain versions (batch 16)"):
        k1 = phase_kernels(card)

    with Phase("main path: generate_poh at full width, then batch-16 rate"):
        k1["launches"] = phase_slice(card)

    with Phase("small slice: card vs CPU"):
        phase_small_vs_cpu()

    print(f"total wall {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
