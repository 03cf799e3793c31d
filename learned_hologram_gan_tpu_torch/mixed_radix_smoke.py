"""The last slice's checks on the card, which ``chip_smoke.py`` runs: the
mixed-radix FFT plans of K1, K2 and K3, the portrait path, the FFT
backends, the fourier generator, the EXR tools, the synthetic dataset and
the profiler.  Seeded random weights and data, full width:

  1. :func:`kernels`: K3 forward and inverse along both axes at 768, 1280,
     1728, 2880 and 5000 against ``fft_axis_reference``; K1 (``conj_h``
     D = 1, masked D = 3, ``from_spectrum`` + ``per_plane``) and K2
     (``conj_h``, ``from_spectrum`` + ``per_plane``) at rp = 768, 1280,
     1728, 2880 and 5000 against their plain versions; each within 1e-4 of
     max |plain| (1e-5 at p99.9).  Then the JSON lines of the grids on a
     path, timed beside their plain versions, ``torch.fft`` and their
     bounds: K3 at 1280 x 768 (the portrait) and 2880 x 5000 (4K), K1 at
     rp 1280 (the portrait forward), 1728 (the 1080p step) and 2880 (4K's
     AP2POH), K2 at 1728;
  2. :func:`portrait`: ``tools/make_synthetic_dataset`` at 640 x 384
     (pads 320 / 192, a 1280 x 768 grid: K3), ``generate_poh --propagate``
     there in float32 and bfloat16 (K1), the float32 POH and focal stack
     against the CPU run's, ``eval_quality`` on that set (K1 and K3), and
     the batch-4 forward's ms, POH/s and peak memory in both dtypes;
  3. :func:`backends`: ``asm.set_fft_backend("mxu")`` (the GEMM FFT) and
     ``"xla"`` against ``"pallas"`` (K3) on the card, with their times;
  4. :func:`fourier`: the fourier generator (base 64, 384^2, batch 4): the
     forward's ms and peak memory, its kernels by ``torch.profiler`` beside
     the plain generator's, then card against CPU at a small size;
  5. :func:`exr_round_trip`: EXRs through the port's ``exr2bin``, the
     native decoder built on this host;
  6. :func:`synthetic_384`: ``make_synthetic_dataset`` at 384^2 (K3);
  7. :func:`trace_k3`: ``utils.profiling.profile_op`` over a K3 ``fft2``,
     whose Chrome trace must name the kernel; ``chip_smoke.py`` runs it in
     its own process, where the trace must name K3 or be refused, and in a
     new one, where it must name K3 (:func:`trace_k3_both`).

Each raises on any failure.  ``python -m
learned_hologram_gan_tpu_torch.mixed_radix_smoke`` runs them alone,
``--trace_k3`` the last one alone.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import time

import numpy as np
import torch

from .highres_smoke import _check_launches, _counts, _reset
from .train_smoke import _Entry, _random_complex
from .utils.cuda_measure import (
    check_rel,
    cuda_ms,
    fft_flops,
    k1_row_pass_work,
    k1_work,
    k2_row_adjoint_work,
    profile_kernels,
    spectral_support,
)

# (rows, cols, pad, pad_cols, batch) of each grid: rp = rows + 2 pad
GRIDS = {
    768: (384, 640, 192, 320, 1),     # a 768 x 1280 grid
    1280: (640, 384, 320, 192, 4),    # the portrait: 1280 x 768
    1728: (1088, 1920, 320, 564, 1),  # 1080p: 1728 x 3048
    2880: (2176, 3840, 352, 580, 1),  # 4K: 2880 x 5000
    5000: (3840, 2176, 580, 352, 1),  # 4K turned: 5000 x 2880
}
K3_LENGTHS = (768, 1280, 1728, 2880, 5000)
PORTRAIT = dict(rows=640, cols=384, pad=320)  # BASELINE.md's portrait zero-shot: 1280 x 768
PORTRAIT_VAL, PORTRAIT_PLANES = 4, 8
RECON_DISTANCES = (4e-4, 7e-4, 1e-3)  # generatePOH's 3 planes
K1_SRC = "learned_hologram_gan_tpu_torch/csrc/k1_asm_propagate.cu"
K1_AT = "learned_hologram_gan_tpu/ops/pallas/spectral.py:686"
K3_SRC = "learned_hologram_gan_tpu_torch/csrc/k3_fft.cu"
K3_AT = "learned_hologram_gan_tpu/ops/pallas/spectral.py:320"
# the fourier generator at full width, and its card-against-CPU check
FOURIER = dict(hw=384, pad=320, base=64, batch=4)
FOURIER_SMALL = dict(hw=32, pad=16, base=4, batch=2)


def _case(rp, mode, dev, rng):
    """propagate_planes' arguments at the grid of ``rp`` in ``mode``."""
    from .config import OpticsConfig
    from .ops import asm

    rows, cols, pad, pad_cols, batch = GRIDS[rp]
    optics = OpticsConfig(rows=rows, cols=cols, pad_size=pad, pad_cols_override=pad_cols,
                          filter_radius_coefficient=0.45)
    dists = np.linspace(4e-4, 1e-3, 3)
    plan = asm.make_plan(optics, distances=dists, device=dev, cache_h=False)
    if mode == "from_spectrum+per_plane":
        spec = _random_complex(rng, (2 * batch, 3, optics.padded_rows, optics.padded_cols), dev)
        idx = torch.arange(2 * batch, device=dev) % 3
        return asm.fused_args(plan, spec, plan.distances[idx], from_spectrum=True, per_plane=True)
    field = _random_complex(rng, (batch, 3, rows, cols), dev)
    if mode == "conj_h":
        return asm.fused_args(plan, field, plan.distances[:1], conj_h=True, use_mask=False)
    return asm.fused_args(plan, field, plan.distances)  # masked, D = 3


def _check_k1_k2(rp, dev, rng):
    from .ops.cuda import spectral

    err = 0.0
    for mode in ("conj_h", "field D=3", "from_spectrum+per_plane"):
        args = _case(rp, mode, dev, rng)
        err = max(err, check_rel(f"K1 {mode} at rp {rp} ({args[-1][5]} x {args[-1][6]})",
                                 *spectral.propagate_planes(*args),
                                 *spectral.propagate_planes_reference(*args)))
        if mode != "field D=3":
            fr, fi, wl2, dvec, mask, cfg = args
            rows, cols = GRIDS[rp][:2]
            g = _random_complex(rng, (fr.shape[0], cfg[4], rows, cols), dev)
            gr, gi = g.real.contiguous(), g.imag.contiguous()
            check_rel(f"K2 {mode} at rp {rp}", *spectral._adjoint_cuda(gr, gi, wl2, dvec, mask, cfg),
                      *spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, mask, cfg))
        del args
        torch.cuda.empty_cache()
    return err


def _k3_axis(n, dev, rng, card):
    """K3 along each axis at length ``n`` against its plain version, then
    one pass timed on (8, 2048, n) or (8, n, 2048) planes (100 to 655 MB,
    past the L2) in TB/s of its own bytes, beside ``torch.fft``."""
    from .ops.cuda import fft

    out = {}
    for axis in (-1, -2):
        shape = (8, 2048, n) if axis == -1 else (8, n, 2048)
        x = _random_complex(rng, shape, dev)
        for inverse in (False, True):
            scale = 1.0 / n if inverse else 1.0
            y = fft.fft_axis(x, axis, inverse, scale)
            ref = fft.fft_axis_reference(x, axis, inverse, scale)
            check_rel(f"K3 {'inverse' if inverse else 'forward'} n {n} axis {axis} {shape}",
                      y.real, y.imag, ref.real, ref.imag)
        nbytes = 2 * x.numel() * 8
        ms = cuda_ms(lambda: fft.fft_axis(x, axis, False, 1.0), iters=10)
        lib = cuda_ms(lambda: torch.fft.fft(x, dim=axis), iters=10)
        out[f"axis {axis}"] = dict(ms=ms, tb_s=nbytes / ms / 1e9, torch_fft_ms=lib, torch_fft_tb_s=nbytes / lib / 1e9)
        print(f"K3 pass n {n} axis {axis} of {shape}: {ms:.4f} ms, {nbytes / ms / 1e9:.2f} TB/s; "
              f"torch.fft {lib:.4f} ms, {nbytes / lib / 1e9:.2f} TB/s [{card}]", flush=True)
        del x, y, ref
        torch.cuda.empty_cache()
    return out


def _k3_entry(name, shape, what, dev, rng, card):
    """A K3 JSON line: fft2 of ``shape`` (two passes) beside its plain
    version (two ``fft_axis_reference`` passes) and ``torch.fft.fft2``."""
    from .ops.cuda import fft

    entry = _Entry(name, K3_SRC, K3_AT, what)
    x = _random_complex(rng, shape, dev)
    y, ref = fft.fft2(x), torch.fft.fft2(x)
    err = check_rel(f"K3 fft2 {shape}", y.real, y.imag, ref.real, ref.imag)
    yi, refi = fft.ifft2(x), torch.fft.ifft2(x)
    err = max(err, check_rel(f"K3 ifft2 {shape}", yi.real, yi.imag, refi.real, refi.imag))
    del y, ref, yi, refi
    rows, cols = shape[-2:]
    planes = x.numel() // (rows * cols)
    entry.add(f"K3 fft2 {shape}", card, err, lambda: fft.fft2(x),
              lambda: fft.fft_axis_reference(fft.fft_axis_reference(x, -1, False, 1.0), -2, False, 1.0),
              lambda: torch.fft.fft2(x), None, 2 * x.numel() * 8,
              fft_flops(cols, planes * rows) + fft_flops(rows, planes * cols), iters=5)
    del x
    torch.cuda.empty_cache()
    return entry


def _k1_entry(name, rp, modes, dev, rng, card, what):
    """A K1 JSON line over ``modes`` at the grid of ``rp``."""
    from .ops.cuda import spectral

    entry = _Entry(name, K1_SRC, K1_AT, what)
    rows, cols, pad, pad_cols, _ = GRIDS[rp]
    for mode in modes:
        args = _case(rp, mode, dev, rng)
        fr, fi, wl2, dvec, mask, kcfg = args
        p, num_d, from_spectrum, cp = fr.shape[0], kcfg[4], kcfg[2], kcfg[6]
        err = check_rel(f"{name} {mode}", *spectral.propagate_planes(*args),
                        *spectral.propagate_planes_reference(*args))
        x = torch.complex(fr, fi)
        if not from_spectrum:
            x_cols = torch.fft.fft(torch.nn.functional.pad(x, (pad_cols, pad_cols)), dim=-1)
        else:
            x_cols = x
        hm = spectral._transfer(wl2, dvec, mask, kcfg)

        def library(x=x, hm=hm, from_spectrum=from_spectrum):
            spec = x if from_spectrum else torch.fft.fft2(
                torch.nn.functional.pad(x, (pad_cols, pad_cols, pad, pad)))
            return torch.fft.ifft2(spec[:, None] * hm)[..., pad:pad + rows, pad_cols:pad_cols + cols]

        if from_spectrum:  # as train_smoke counts it: the spectrum on the mask's support
            support = spectral_support(mask, rp, cp)
            nbytes = 2 * p * support * 4 + rp * cp * 4 + 2 * p * num_d * rows * cols * 4
            flops = fft_flops(rp, p * num_d * cp) + fft_flops(cp, p * num_d * rows) + p * num_d * support * 16
        else:
            nbytes, flops = k1_work(p, rows, cols, rp, cp, num_d, mask)
        entry.add(f"{name} {mode}", card, err, lambda: spectral.propagate_planes(*args),
                  lambda: spectral.propagate_planes_reference(*args), library,
                  lambda: spectral.row_pass(x_cols, wl2, dvec, mask, kcfg), nbytes, flops, iters=3,
                  kernel_work=k1_row_pass_work(p, rows, rp, cp, num_d, mask, from_spectrum))
        del args, x, x_cols, hm
        torch.cuda.empty_cache()
    return entry


def _k2_entry(name, rp, modes, dev, rng, card, what):
    """A K2 JSON line over ``modes`` at the grid of ``rp``."""
    from .ops.cuda import spectral

    entry = _Entry(name, K1_SRC, K1_AT, what)
    rows, cols, pad, pad_cols, _ = GRIDS[rp]
    for mode in modes:
        fr, fi, wl2, dvec, mask, kcfg = _case(rp, mode, dev, rng)
        p, num_d, from_spectrum, cp = fr.shape[0], kcfg[4], kcfg[2], kcfg[6]
        g = _random_complex(rng, (p, num_d, rows, cols), dev)
        gr, gi = g.real.contiguous(), g.imag.contiguous()
        err = check_rel(f"{name} {mode}", *spectral._adjoint_cuda(gr, gi, wl2, dvec, mask, kcfg),
                        *spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, mask, kcfg))
        hm = torch.conj(spectral._transfer(wl2, dvec, mask, kcfg))
        x_cols = torch.fft.fft(torch.nn.functional.pad(g, (pad_cols, pad_cols)), dim=-1)

        def library(g=g, hm=hm, from_spectrum=from_spectrum):
            acc = (torch.fft.fft2(torch.nn.functional.pad(g, (pad_cols, pad_cols, pad, pad))) * hm).sum(1)
            if from_spectrum:
                return acc / (rp * cp)
            return torch.fft.ifft2(acc)[..., pad:pad + rows, pad_cols:pad_cols + cols]

        # as train_smoke counts the wrapper's work: the column transforms too
        out_rows, out_cols = (rp, cp) if from_spectrum else (rows, cols)
        flops = (fft_flops(cp, p * num_d * rows) + fft_flops(rp, p * num_d * cp)
                 + p * num_d * spectral_support(mask, rp, cp) * (16 if mask is not None else 14))
        if not from_spectrum:
            flops += fft_flops(rp, p * cp) + fft_flops(cp, p * rows)
        nbytes = (2 * p * num_d * rows * cols * 4 + 2 * p * out_rows * out_cols * 4
                  + (rp * cp * 4 if mask is not None else 0))
        entry.add(f"{name} {mode}", card, err,
                  lambda: spectral._adjoint_cuda(gr, gi, wl2, dvec, mask, kcfg),
                  lambda: spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, mask, kcfg),
                  library, lambda: spectral.row_adjoint(x_cols, wl2, dvec, mask, kcfg), nbytes, flops,
                  iters=3, kernel_work=k2_row_adjoint_work(p, rows, rp, cp, num_d, mask, from_spectrum))
        del g, gr, gi, hm, x_cols
        torch.cuda.empty_cache()
    return entry


def kernels(card):
    """Phase 1; returns the JSON entries (``launches`` to be filled in) and
    the one-axis passes' times."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    passes = {n: _k3_axis(n, dev, rng, card) for n in K3_LENGTHS}
    for rp in GRIDS:
        _check_k1_k2(rp, dev, rng)
    entries = dict(
        k3_portrait=_k3_entry("k3_fft_1280x768", (12, 1280, 768),
                              "fft2 of (12, 1280, 768): the portrait grid, batch 4", dev, rng, card),
        k3_4k=_k3_entry("k3_fft_2880x5000", (3, 2880, 5000),
                        "fft2 of (3, 2880, 5000): the 4K grid, batch 1", dev, rng, card),
        k1_portrait=_k1_entry("k1_asm_propagate_fwd_1280", 1280, ("conj_h", "field D=3"), dev, rng, card,
                              "portrait forward, batch 4: (12 planes conj_h D=1) + (12 planes, D=3), "
                              "640x384 in 1280x768"),
        k1_1080p=_k1_entry("k1_asm_propagate_fwd_1728", 1728, ("conj_h", "from_spectrum+per_plane"), dev,
                           rng, card, "1080p step, batch 1: (3 planes conj_h D=1) + (6 planes "
                                      "from_spectrum+per_plane), 1088x1920 in 1728x3048"),
        k2_1080p=_k2_entry("k2_asm_propagate_bwd_1728", 1728, ("conj_h", "from_spectrum+per_plane"), dev,
                           rng, card, "1080p step's backward, batch 1: (3 planes conj_h) + (6 planes "
                                      "from_spectrum+per_plane), 1728x3048"),
        k1_4k=_k1_entry("k1_asm_propagate_fwd_2880", 2880, ("conj_h",), dev, rng, card,
                        "4K AP2POH, batch 1: 3 planes conj_h D=1, 2176x3840 in 2880x5000"),
    )
    return entries, passes


def _portrait_poh(tmp, data, dtype, device):
    from . import generate_poh

    p = PORTRAIT
    argv = ["--img_path", os.path.join(data, "val", "img.bin"),
            "--depth_path", os.path.join(data, "val", "depth.bin"), "--index", "1",
            "--model_path", os.path.join(tmp, "random_init.pt"),
            "--poh_output_path", os.path.join(tmp, f"poh_{dtype}_{device}.npy"),
            "--samplesNum", str(PORTRAIT_VAL), "--sample_row_num", str(p["rows"]),
            "--sample_col_num", str(p["cols"]), "--pad_size", str(p["pad"]), "--propagate",
            "--num_intervals", "3", "--dtype", dtype,
            "--output_image_dir", os.path.join(tmp, f"recon_{dtype}_{device}"), "--device", device]
    return generate_poh.main(argv)


def portrait(card):
    """Phase 2; returns the runs' launches, ms and peak memory."""
    from . import card_check
    from .config import GeneratorConfig, OpticsConfig
    from .highres_smoke import _random_generator_file, expected_eval_launches
    from .models import make_generator, make_generator_plan
    from .ops import asm
    from .ops.cuda import spectral
    from .tools import eval_quality, make_synthetic_dataset

    p = PORTRAIT
    out = {}
    with tempfile.TemporaryDirectory(prefix="portrait_smoke_") as tmp:
        data = os.path.join(tmp, "synth_portrait")
        _reset()
        start = time.perf_counter()
        make_synthetic_dataset.main(["--out", data, "--train_num", "1", "--val_num", str(PORTRAIT_VAL),
                                     "--rows", str(p["rows"]), "--cols", str(p["cols"]),
                                     "--pad_size", str(p["pad"]), "--device", "cuda"])
        synth = _counts()
        # one batch a split, each an fft2 and an ifft2 of the layers: 4 passes
        _check_launches("make_synthetic_dataset at 640 x 384 (1280 x 768)", synth, dict(k1={}, k2={}, k3=8))
        print(f"make_synthetic_dataset at 640 x 384, 1 + {PORTRAIT_VAL} samples: "
              f"{time.perf_counter() - start:.2f} s [{card}]", flush=True)
        out["synth_launches"] = synth

        runs = {}
        for dtype in ("float32", "bfloat16"):
            _reset()
            start = time.perf_counter()
            r = _portrait_poh(tmp, data, dtype, "cuda")
            torch.cuda.synchronize()
            launches = _counts()
            _check_launches(f"generate_poh --propagate at 640 x 384 ({dtype})", launches,
                            dict(k1={"conj_h": 1, "field": 1}, k2={}, k3=0))
            poh, stack = r["poh"], r["focal_stack"]
            if tuple(poh.shape) != (1, 3, p["rows"], p["cols"]) or tuple(stack.shape) != (3, 3, p["rows"], p["cols"]):
                raise AssertionError(f"portrait shapes: poh {tuple(poh.shape)}, stack {tuple(stack.shape)}")
            if not (torch.isfinite(poh).all() and torch.isfinite(stack).all()):
                raise AssertionError(f"portrait ({dtype}): non-finite POH or focal stack")
            print(f"generate_poh at 640 x 384 ({dtype}, first call): {time.perf_counter() - start:.2f} s "
                  f"[{card}]", flush=True)
            runs[dtype] = (poh.cpu().double().numpy(), stack.cpu().numpy(), launches)
        out["generate_poh_launches"] = runs["float32"][2]

        # the float32 card run against the CPU's, same weights and input
        r = _portrait_poh(tmp, data, "float32", "cpu")
        cpu_poh, cpu_stack = r["poh"].double().numpy(), r["focal_stack"].numpy()
        card_poh, card_stack = runs["float32"][:2]
        mean, p99, mx = card_check.poh_phasor_errors(card_poh, cpu_poh)
        d = np.abs(card_stack - cpu_stack)
        stack_p999, stack_max = float(np.quantile(d, 0.999)), float(d.max())
        print(f"portrait POH, card (K1) vs CPU (plain), float32: phasor mean {mean:.2e} p99 {p99:.2e} "
              f"max {mx:.2e} (bounds {card_check.POH_MEAN_TOL:g}, {card_check.POH_P99_TOL:g}, "
              f"{card_check.POH_MAX_TOL:g}); focal stack p99.9 {stack_p999:.2e} max {stack_max:.2e} "
              f"(bounds {card_check.STACK_P999_TOL:g}, {card_check.STACK_MAX_TOL:g})", flush=True)
        if not (mean <= card_check.POH_MEAN_TOL and p99 <= card_check.POH_P99_TOL
                and mx <= card_check.POH_MAX_TOL and stack_p999 <= card_check.STACK_P999_TOL
                and stack_max <= card_check.STACK_MAX_TOL):
            raise AssertionError("the portrait POH on the card disagrees with the CPU's")
        bmean, bp99, bmax = card_check.poh_phasor_errors(runs["bfloat16"][0], card_poh)
        print(f"portrait POH, bfloat16 against float32 on the card: phasor mean {bmean:.2e} p99 "
              f"{bp99:.2e} max {bmax:.2e} (printed)", flush=True)
        out["card_vs_cpu"] = dict(poh_mean=mean, poh_p99=p99, poh_max=mx, stack_p999=stack_p999,
                                  stack_max=stack_max)

        run_dir = os.path.join(tmp, "random_init")
        _random_generator_file(run_dir)
        _reset()
        r = eval_quality.main(["--data", data, "--run_dir", run_dir, "--out", os.path.join(tmp, "eval"),
                               "--rows", str(p["rows"]), "--cols", str(p["cols"]), "--pad_size", str(p["pad"]),
                               "--val_num", str(PORTRAIT_VAL), "--batch", "4",
                               "--num_planes", str(PORTRAIT_PLANES), "--samples", "--device", "cuda"])
        launches = _counts()
        _check_launches("eval_quality at 640 x 384", launches,
                        expected_eval_launches(PORTRAIT_VAL // 4, PORTRAIT_PLANES, False))
        s = r["summary"]
        if not np.isfinite([s["val_PSNR"], s["val_SSIM"]]).all():
            raise AssertionError(f"portrait evaluation: non-finite summary {s}")
        print(f"eval_quality at 640 x 384 (bf16, batch 4, {PORTRAIT_PLANES} planes): "
              f"{1e3 * r['sweep_s'] / PORTRAIT_VAL:.1f} ms/sample, first call included; val PSNR "
              f"{s['val_PSNR']:.4f}, SSIM {s['val_SSIM']:.4f} [{card}]", flush=True)
        out["eval_launches"] = launches

        # batch 4: generator forward + 3-plane focal stack, both dtypes
        rgbd = np.concatenate([np.fromfile(os.path.join(data, "val", f"{k}.bin"), np.float32)
                               .reshape(PORTRAIT_VAL, 3, p["rows"], p["cols"])[:, :c]
                               for k, c in (("img", 3), ("depth", 1))], axis=1)
        rgbd = torch.from_numpy(rgbd).cuda()
        recon = asm.make_plan(OpticsConfig(rows=p["rows"], cols=p["cols"], pad_size=p["pad"],
                                           filter_radius_coefficient=0.35),
                              distances=RECON_DISTANCES, device="cuda")
        out["batch4"] = {}
        for dtype in ("float32", "bfloat16"):
            cfg = GeneratorConfig(rows=p["rows"], cols=p["cols"], pad_size=p["pad"],
                                  filter_radius_coefficient=0.45, dtype=dtype)
            model = make_generator(cfg, seed=0, device="cuda")
            plan = make_generator_plan(cfg, device="cuda")

            def forward():
                with torch.inference_mode():
                    poh = model(plan, rgbd)
                    return asm.propagate_batch_multi(recon, torch.ones_like(poh), poh)

            forward()
            _reset()
            ms = cuda_ms(forward, iters=5, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            k1 = spectral.row_pass.launches
            if k1 != 2 * 6:
                raise AssertionError(f"portrait batch-4 forward ({dtype}): K1 launched {k1} times in 6 "
                                     "forwards, want 2 each")
            if not torch.isfinite(forward()).all():
                raise AssertionError(f"portrait batch-4 forward ({dtype}): non-finite stack")
            print(f"portrait batch-4 forward ({dtype}; generator + 3-plane focal stack): {ms:.1f} ms, "
                  f"{4e3 / ms:.2f} POH/s, peak {peak:.2f} GiB; K1 2 a forward [{card}]", flush=True)
            out["batch4"][dtype] = dict(ms=ms, poh_per_s=4e3 / ms, peak_gib=peak)
            del model, plan
            torch.cuda.empty_cache()
    return out


def backends(card):
    """Phase 3: the FFT backends on the card."""
    from .ops import asm
    from .ops.cuda import fft

    rng = np.random.default_rng(17)
    out = {}
    try:
        for shape in ((12, 1280, 768), (12, 1024, 1024)):
            x = _random_complex(rng, shape, torch.device("cuda"))
            res, times = {}, {}
            for name in ("pallas", "mxu", "xla"):
                asm.set_fft_backend(name)
                before = fft.fft_axis.launches
                res[name] = (asm._fft2(x), asm._ifft2(x))
                torch.cuda.synchronize()
                k3 = fft.fft_axis.launches - before
                if (k3 != 4) if name == "pallas" else k3:
                    raise AssertionError(f"backend {name}: {k3} K3 launches for an fft2 and an ifft2")
                times[name] = cuda_ms(lambda: asm._fft2(x), iters=5)
            for name in ("mxu", "xla"):
                for i, what in enumerate(("fft2", "ifft2")):
                    a, b = res[name][i], res["pallas"][i]
                    check_rel(f"set_fft_backend('{name}') {what} {shape} against 'pallas' (K3)",
                              a.real, a.imag, b.real, b.imag)
            print(f"_fft2 of {shape}: pallas (K3) {times['pallas']:.3f} ms, mxu (GEMMs) {times['mxu']:.3f} ms, "
                  f"xla (torch.fft) {times['xla']:.3f} ms [{card}]", flush=True)
            out[str(shape)] = times
            del x, res
    finally:
        asm.set_fft_backend("auto")
    torch.cuda.empty_cache()
    return out


def fourier(card):
    """Phase 4: the fourier generator at full width, then card against CPU."""
    from . import card_check
    from .config import GeneratorConfig
    from .models import make_generator, make_generator_plan
    from .ops.cuda import spectral

    f = FOURIER
    cfg = GeneratorConfig(rows=f["hw"], cols=f["hw"], pad_size=f["pad"], filter_radius_coefficient=0.45,
                          unet_base_features=f["base"])
    model = make_generator(cfg, seed=0, device="cuda", fourier=True)
    plan = make_generator_plan(cfg, device="cuda")
    rgbd = torch.from_numpy(np.random.default_rng(18).random((f["batch"], 4, f["hw"], f["hw"]),
                                                              dtype=np.float32)).cuda()

    def forward():
        with torch.inference_mode():
            return model(plan, rgbd)

    forward()
    _reset()
    ms = cuda_ms(forward, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if spectral.row_pass.launches != 4:
        raise AssertionError(f"fourier generator: K1 launched {spectral.row_pass.launches} times in 4 "
                             "forwards, want 1 each (AP2POH)")
    poh = forward()
    if tuple(poh.shape) != (f["batch"], 3, f["hw"], f["hw"]) or not torch.isfinite(poh).all():
        raise AssertionError("fourier generator: bad POH")
    print(f"fourier generator (base {f['base']}, {f['hw']}^2, batch {f['batch']}, float32): forward "
          f"{ms:.1f} ms, peak {peak:.2f} GiB [{card}]", flush=True)
    # where its time goes, beside the plain generator's at the same shapes
    profile_kernels("fourier generator forward", forward, card, top=4)
    plain = make_generator(cfg, seed=0, device="cuda")
    with torch.inference_mode():
        profile_kernels("plain generator forward, same shapes", lambda: plain(plan, rgbd), card, top=4)
    del model, plain, plan, rgbd
    torch.cuda.empty_cache()

    s = FOURIER_SMALL
    cfg = GeneratorConfig(rows=s["hw"], cols=s["hw"], pad_size=s["pad"], filter_radius_coefficient=0.45,
                          unet_base_features=s["base"])
    cpu = make_generator(cfg, seed=1, device="cpu", fourier=True)
    card_model = make_generator(cfg, seed=1, device="cuda", fourier=True)
    x = np.random.default_rng(19).random((s["batch"], 4, s["hw"], s["hw"]), dtype=np.float32)
    with torch.inference_mode():
        want = cpu(make_generator_plan(cfg, device="cpu"), torch.from_numpy(x)).double().numpy()
        got = card_model(make_generator_plan(cfg, device="cuda"), torch.from_numpy(x).cuda()).cpu().double().numpy()
    mean, p99, mx = card_check.poh_phasor_errors(got, want)
    print(f"small fourier generator, card vs CPU: POH phasor mean {mean:.2e} p99 {p99:.2e} max {mx:.2e} "
          f"(bounds {card_check.POH_MEAN_TOL:g}, {card_check.POH_P99_TOL:g}, {card_check.POH_MAX_TOL:g})",
          flush=True)
    if not (mean <= card_check.POH_MEAN_TOL and p99 <= card_check.POH_P99_TOL and mx <= card_check.POH_MAX_TOL):
        raise AssertionError("the fourier generator on the card disagrees with the CPU's")
    return dict(ms=ms, peak_gib=peak, poh_mean=mean, poh_p99=p99, poh_max=mx)


def _write_exr(path, rgb, compression=0, half=False):
    """A single-part scanline EXR, channels B, G, R (float or half), NONE
    (0), ZIPS (2) or ZIP (3) compressed; a ZIP block stored raw where
    deflate does not shrink it, as EXR writers do."""
    import zlib

    def attr(name, type_, payload):
        return name.encode() + b"\0" + type_.encode() + b"\0" + struct.pack("<i", len(payload)) + payload

    _, h, w = rgb.shape
    dtype, ptype = (np.float16, 1) if half else (np.float32, 2)
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<i", ptype) + b"\0" * 4 + struct.pack("<ii", 1, 1)
                      for c in "BGR") + b"\0"
    header = (attr("channels", "chlist", chlist) + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
              + attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
              + attr("lineOrder", "lineOrder", b"\0") + attr("pixelAspectRatio", "float", struct.pack("<f", 1))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1)) + b"\0")
    lines = {0: 1, 2: 1, 3: 16}[compression]
    blocks = []
    for y0 in range(0, h, lines):
        raw = b"".join(rgb[{"R": 0, "G": 1, "B": 2}[c], y].astype(dtype).tobytes()
                       for y in range(y0, min(h, y0 + lines)) for c in "BGR")
        if compression:
            t = np.frombuffer(raw, np.uint8)
            t = np.concatenate([t[0::2], t[1::2]])
            enc = t.astype(np.int32)
            enc[1:] = (enc[1:] - t[:-1].astype(np.int32) + 384) % 256
            comp = zlib.compress(enc.astype(np.uint8).tobytes())
            raw = comp if len(comp) < len(raw) else raw
        blocks.append((y0, raw))
    offsets, off = [], 8 + len(header) + 8 * len(blocks)
    for _, payload in blocks:
        offsets.append(off)
        off += 8 + len(payload)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<ii", 20000630, 2) + header + struct.pack(f"<{len(blocks)}Q", *offsets))
        for y0, payload in blocks:
            fh.write(struct.pack("<ii", y0, len(payload)) + payload)


def exr_round_trip(card):
    """Phase 5: EXRs of every compression and type through the port's
    exr2bin, the bins bit for bit the images, the native decoder built."""
    from . import exr2bin
    from .data import exr

    exr._NATIVE_TRIED, exr._NATIVE_LIB = False, None
    if exr._native_lib() is None:
        raise AssertionError("the native EXR decoder did not build on this host (g++ and zlib)")
    h, w = 48, 40
    with tempfile.TemporaryDirectory(prefix="exr_smoke_") as tmp:
        root = os.path.join(tmp, "set")
        want = {}
        cases = [(c, half) for c in (0, 2, 3) for half in (False, True)]
        for name, seed in (("img", 0), ("depth", 1)):
            os.makedirs(os.path.join(root, name))
            rng = np.random.default_rng(seed)
            ramp = np.linspace(0, 1, h * w, dtype=np.float32).reshape(h, w)
            imgs = []
            for i, (comp, half) in enumerate(cases):
                rgb = (ramp[None] + 0.05 * rng.random((3, h, w))).astype(np.float32)
                _write_exr(os.path.join(root, name, f"{i:03d}.exr"), rgb, comp, half)
                imgs.append(rgb.astype(np.float16).astype(np.float32) if half else rgb)
            want[name] = np.stack(imgs)
        start = time.perf_counter()
        if exr2bin.main([root, "--channelsNum", "3", "--height", str(h), "--width", str(w)]) != 0:
            raise AssertionError("exr2bin failed")
        for name, arr in want.items():
            got = np.fromfile(os.path.join(root, f"{name}.bin"), np.float32).reshape(arr.shape)
            if not np.array_equal(got, arr):
                raise AssertionError(f"exr2bin's {name}.bin is not the images bit for bit")
    print(f"exr2bin: 2 folders of {len(cases)} EXRs (compressions 0/2/3, float and half), {h} x {w}, "
          f"native decoder {exr.native_library_path().name}: bins bit for bit in "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    return dict(native=True)


def synthetic_384(card):
    """Phase 6: make_synthetic_dataset at 384^2 (1024 x 1024, K3)."""
    from .tools import make_synthetic_dataset

    with tempfile.TemporaryDirectory(prefix="synth_smoke_") as tmp:
        _reset()
        start = time.perf_counter()
        make_synthetic_dataset.main(["--out", tmp, "--train_num", "4", "--val_num", "2", "--device", "cuda"])
        wall = time.perf_counter() - start
        launches = _counts()
        _check_launches("make_synthetic_dataset at 384^2", launches, dict(k1={}, k2={}, k3=8))
        for split, n in (("train", 4), ("val", 2)):
            for name in ("amp", "phs"):
                a = np.fromfile(os.path.join(tmp, split, f"{name}.bin"), np.float32)
                if a.size != n * 3 * 384 * 384 or not (np.isfinite(a).all() and a.min() >= 0 and a.max() < 1):
                    raise AssertionError(f"make_synthetic_dataset: bad {split}/{name}.bin")
    print(f"make_synthetic_dataset at 384^2, 4 + 2 samples: {wall:.2f} s [{card}]", flush=True)
    return dict(launches=launches, s=wall)


def trace_k3(card):
    """Phase 7, one process: profile_op over a K3 fft2; its Chrome trace
    names K3 in both steps."""
    from .ops.cuda import fft
    from .utils.profiling import TRACE_FILE, profile_op

    x = _random_complex(np.random.default_rng(20), (12, 1280, 768), torch.device("cuda"))
    with tempfile.TemporaryDirectory(prefix="trace_smoke_") as tmp:
        profile_op(lambda: fft.fft2(x), tmp, steps=2)
        with open(os.path.join(tmp, TRACE_FILE)) as fh:
            events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    k3 = [e for e in events if "fft_axis_kernel" in e.get("name", "") and e.get("cat") == "kernel"]
    steps = [n for n in names if n.startswith("step_")]
    print(f"profile_op over K3's fft2 of (12, 1280, 768): {len(k3)} kernel events named fft_axis_kernel, "
          f"annotations {sorted(set(steps))}; event categories {sorted({e.get('cat', '') for e in events})}",
          flush=True)
    if len(k3) < 4 or sorted(set(steps)) != ["step_0", "step_1"]:
        raise AssertionError("the profiler trace does not name K3 in both steps")
    return dict(k3_events=len(k3))


def trace_k3_both(card, age_s):
    """Phase 7 in this process, then in a new one.  On the H100 host it was
    measured on, the profiler drops device events once a process is older
    than ~30 s (the device timestamps drift from the host clock; PERF.md
    §7): here
    ``profile_op`` must then refuse its trace (``check_kernels``), never
    hand back one without kernels; a new process, which traces from its
    start, must name K3.  ``age_s``: how long this process has run."""
    import subprocess
    import sys

    try:
        here = trace_k3(card)
    except RuntimeError as e:
        if "lost the device side" not in str(e):
            raise
        print(f"profile_op in this process ({age_s:.0f} s old): refused its trace: {e}", flush=True)
        here = None
    r = subprocess.run([sys.executable, "-m", "learned_hologram_gan_tpu_torch.mixed_radix_smoke", "--trace_k3"],
                       capture_output=True, text=True, timeout=300)
    print(r.stdout.strip(), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"trace_k3 in a new process failed (exit {r.returncode}):\n{r.stderr[-3000:]}")
    return dict(here=here, age_s=age_s)


def main(argv=None) -> int:
    import argparse
    import subprocess

    from .ops.cuda import build, fft, spectral

    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description="the mixed-radix phase of chip_smoke.py alone")
    ap.add_argument("--trace_k3", action="store_true", help="only the profiler trace of K3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mixed_radix_smoke: no CUDA device", flush=True)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    if args.trace_k3:
        trace_k3(card)
        return 0
    print(card, flush=True)
    start = time.perf_counter()
    build.build_jobs([(name, d) for name in (spectral.KERNEL_NAME, fft.KERNEL_NAME)
                      for d in build_defines_of_the_paths()])
    print(f"K1/K3 libraries: {time.perf_counter() - start:.1f} s", flush=True)
    entries, _ = kernels(card)
    portrait(card)
    backends(card)
    fourier(card)
    exr_round_trip(card)
    synthetic_384(card)
    trace_k3_both(card, time.perf_counter() - t0)
    print(json.dumps({k: v.json() for k, v in entries.items()}), flush=True)
    return 0


def build_defines_of_the_paths():
    """The K1 / K3 libraries the paths of this slice load: the powers of
    two, and the plan of each mixed-radix length they run."""
    from .ops.cuda import fft_plan

    defines = {()} | {fft_plan.build_defines(fft_plan.make_plan(n)) for n in (768, 1280, 1728, 2880, 5000)}
    return sorted(defines)


if __name__ == "__main__":
    raise SystemExit(main())
