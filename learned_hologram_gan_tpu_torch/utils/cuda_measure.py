"""Measurements on the card for ``chip_smoke.py``: kernel times by CUDA
events, the card's lower bound for a piece of work, errors against a plain
version, and a ``torch.profiler`` summary of the kernels a call launches.
Every number these give is a device measurement; they need a CUDA device.
"""

from __future__ import annotations

import math
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth, f32 non-tensor
# rate, dense TF32 and bf16 tensor-core rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12
# against their plain versions, relative to max |plain|: f32 FFT rounding
# over a few 1024-point transforms is ~1e-6; H is computed in the same f32
# operation order on both sides
MAX_REL_TOL, P999_REL_TOL = 1e-4, 1e-5


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls."""
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
    return 5.0 * n * math.log2(n) * count


def bound_ms(nbytes, flops, peak_flop_per_s=PEAK_F32_FLOP_PER_S):
    """The larger of bytes over HBM bandwidth and operations over the peak
    rate of their type (f32 unless given), and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spectral_support(mask, rp, cp):
    """Spectral elements whose H a call needs: the entries of this run's
    mask that are not 0 (all rp * cp without a mask).  Elsewhere the masked
    spectrum is 0, and so is its product with H."""
    return rp * cp if mask is None else int((mask != 0).sum())


def k1_work(p, rows, cols, rp, cp, num_d, mask):
    """Bytes and operations of propagate_planes (K1) on field input, and of
    its adjoint (K2), which mirrors it: fr, fi, wl2, dists and the mask read
    once, the cropped result written once; the column transform of the
    nonzero rows, the row transform once per plane, the inverse row
    transform per distance, the inverse column transform of the cropped
    rows, and, per distance, on the mask's support only
    (:func:`spectral_support`): H (2 mul + add for fx^2 + fy^2, sub, sqrt,
    2 mul for theta, sin + cos counted as 2), the complex multiply (6) and
    the mask (2).  ``mask`` is the call's (rp, cp) mask or None."""
    masked = mask is not None
    in_bytes = 2 * p * rows * cols * 4 + p * 4 + num_d * 4 + (rp * cp * 4 if masked else 0)
    out_bytes = 2 * p * num_d * rows * cols * 4
    flops = (
        fft_flops(cp, p * rows)
        + fft_flops(rp, p * cp)
        + fft_flops(rp, p * num_d * cp)
        + fft_flops(cp, p * num_d * rows)
        + p * num_d * spectral_support(mask, rp, cp) * (8 + 6 + (2 if masked else 0))
    )
    return in_bytes + out_bytes, flops


def k1_row_pass_work(p, rows, rp, cp, num_d, mask, from_spectrum):
    """Bytes and operations of K1's row pass alone (``spectral.row_pass``):
    its column-transformed input ((P, rows, cp); from a spectrum, the
    (P, rp, cp) spectrum's entries on the mask's support, the only ones
    the result depends on), wl2, dists and the mask read once,
    (P, D, rows, cp) written once; the row FFT per plane and column (none
    from a spectrum), the inverse row FFT per distance, and H, the complex
    multiply and the mask per distance on the mask's support, counted as
    in :func:`k1_work`."""
    masked = mask is not None
    support = spectral_support(mask, rp, cp)
    in_bytes = (2 * p * (support if from_spectrum else rows * cp) * 4 + p * 4
                + (p if num_d == 1 else num_d) * 4 + (rp * cp * 4 if masked else 0))
    out_bytes = 2 * p * num_d * rows * cp * 4
    flops = (fft_flops(rp, p * cp * (num_d + (0 if from_spectrum else 1)))
             + p * num_d * support * (8 + 6 + (2 if masked else 0)))
    return in_bytes + out_bytes, flops


def k2_row_adjoint_work(p, rows, rp, cp, num_d, mask, from_spectrum):
    """Bytes and operations of K2's row adjoint alone (``spectral.row_adjoint``):
    its column-transformed (P, D, rows, cp) cotangent, wl2, dists and the
    mask read once; its result written once, (P, rows, cp), or the full
    (P, rp, cp) spectrum from a spectrum (0 outside the mask, but written);
    the forward row FFT per plane, distance and column, the inverse row FFT
    per plane and column (none from a spectrum), and per distance on the
    mask's support H, the complex multiply and the mask, counted as in
    :func:`k1_work`, and the sum's complex add past the first distance."""
    masked = mask is not None
    support = spectral_support(mask, rp, cp)
    in_bytes = (2 * p * num_d * rows * cp * 4 + p * 4 + (p if num_d == 1 else num_d) * 4
                + (rp * cp * 4 if masked else 0))
    out_bytes = 2 * p * (rp if from_spectrum else rows) * cp * 4
    flops = (fft_flops(rp, p * cp * (num_d + (0 if from_spectrum else 1)))
             + p * num_d * support * (8 + 6 + (2 if masked else 0)) + p * (num_d - 1) * support * 2)
    return in_bytes + out_bytes, flops


def k1_bound_ms(p, rows, cols, rp, cp, num_d, mask):
    """Least time for :func:`k1_work`'s work on the card, and its kind."""
    return bound_ms(*k1_work(p, rows, cols, rp, cp, num_d, mask))


def relative_errors(kr, ki, rr, ri):
    """max |err|, max and p99.9 of |err| / max |plain|, and max |plain|."""
    err = torch.sqrt((kr - rr) ** 2 + (ki - ri) ** 2).flatten()
    scale = torch.sqrt(rr**2 + ri**2).max()
    rel = err / scale
    p999 = rel.sort().values[int(0.999 * (rel.numel() - 1))]
    return float(err.max()), float(rel.max()), float(p999), float(scale)


def check_rel(name, kr, ki, rr, ri, max_tol=MAX_REL_TOL, p999_tol=P999_REL_TOL):
    """Print and check a kernel result against its plain version; returns
    the max abs error."""
    abs_err, max_rel, p999_rel, scale = relative_errors(kr, ki, rr, ri)
    print(f"{name}: max|err| {abs_err:.3e} (max|plain| {scale:.3e}); rel max {max_rel:.3e} "
          f"(tol {max_tol:g}), rel p99.9 {p999_rel:.3e} (tol {p999_tol:g})", flush=True)
    if not (max_rel <= max_tol and p999_rel <= p999_tol):
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs_err


def profile_kernels(label, fn, card, top=6):
    """torch.profiler over one call of ``fn``: its wall time, the device
    time of its kernels (CUPTI's own overhead records left out) beside the
    kernel launches traced (fewer kernel events than launches: the profiler
    lost device events), the device's busy share of the wall, and the most
    expensive kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    overhead = ("Buffer Flush", "Activity Buffer Request")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0 and e.key not in overhead]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)
    print(f"profiled {label}: wall {wall_ms:.1f} ms, kernels {total_ms:.1f} ms in "
          f"{sum(e.count for e in kernels)} kernel events ({launches} launches traced), device busy "
          f"{100 * total_ms / wall_ms:.1f} % of the wall [{card}]", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        print(f"  {dev_us(e) / 1e3:9.2f} ms {100 * dev_us(e) / 1e3 / total_ms:5.1f} % x{e.count:<6d} "
              f"{e.key[:100]}", flush=True)
    names = ("asm_row_pass_kernel", "asm_row_adjoint_kernel", "fft_axis_kernel")
    ours = [e for e in kernels if any(n in e.key for n in names)]
    if ours:
        us = sum(dev_us(e) for e in ours)
        print(f"  K1/K2/K3 kernels: {us / 1e3:.2f} ms ({100 * us / 1e3 / total_ms:.2f} %) in "
              f"{sum(e.count for e in ours)} launches", flush=True)
    return out
