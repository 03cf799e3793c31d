"""The training slice's checks on the card, which ``chip_smoke.py`` runs.

* :func:`training_kernels`: K1 in its training modes, K2 and K3 at the
  train step's full-width shapes, each against its plain version (and K2
  against ``torch.autograd`` through K1's plain version), with its time,
  the plain version's, a one-call library yardstick and the card's bound
  (K1's row pass and K2's row adjoint also alone, against the bound of
  their own work);
* :func:`two_h_kernels`: K1 and K2 in the two-H hat path's mode (field
  input, a distance per plane, a caller's product mask) at the same shapes,
  measured the same way;
* :func:`training_path`: ``training_model.main --use_gan --perceptual
  random --dtype <dtype>``, with ``--two_h_hat`` or ``--critic_batching``
  where asked, at full width on seeded random data, then one validation
  batch through the trainer's eval step, with the launch counters reset
  before and read after (each kernel's launches, by mode, held to what the
  code makes), and the convolutions' compute dtypes recorded (in bfloat16:
  the generator's and the critic's bfloat16, VGG19's float32); then
  steps/s, the steps' peak memory and a split of one step by CUDA events
  (and, where asked, by ``torch.profiler``).

Each raises on any failure.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import numpy as np
import torch

from .utils.cuda_measure import (
    PEAK_F32_FLOP_PER_S,
    bound_ms,
    check_rel,
    cuda_ms,
    fft_flops,
    k1_row_pass_work,
    k1_work,
    k2_row_adjoint_work,
    profile_kernels,
    spectral_support,
)

ROWS = COLS = 384
PAD = 320
# trainingModel.py:103-160: 20 distances, batch 4 (validation 2), ratio 5, lambda 10
DISTANCES = np.linspace(-4e-4, 0.0, 21)[:-1]
BATCH, VAL_BATCH, RATIO, LAMBDA = 4, 2, 5, 10.0
SAMPLES, STEPS = 8, 2  # one epoch of 2 steps


class _Entry:
    """One kernel's line of the JSON: times summed over its calls."""

    def __init__(self, name, source, replaces, shapes):
        self.fields = dict(name=name, route="cuda", source=source, replaces=replaces, shapes=shapes)
        self.t = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        self.kernel_ms, self.kernel_bound_ms, self.err, self.kinds = 0.0, 0.0, 0.0, []

    def add(self, name, card, err, wrapper, plain, library, kernel, nbytes, flops,
            peak_flop_per_s=PEAK_F32_FLOP_PER_S, iters=5, kernel_work=None):
        t = dict(ms=cuda_ms(wrapper, iters=iters), plain_ms=cuda_ms(plain, iters=3, warmup=1),
                 library_ms=cuda_ms(library, iters=iters))
        kernel_ms = cuda_ms(kernel, iters=iters) if kernel is not None else None
        t["bound_ms"], kind = bound_ms(nbytes, flops, peak_flop_per_s)
        alone = "" if kernel_ms is None else f" (kernel alone {kernel_ms:.3f} ms)"
        print(f"{name}: wrapper {t['ms']:.3f} ms{alone}, plain {t['plain_ms']:.3f} ms, library "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({kind}) [{card}]", flush=True)
        if kernel_work is not None:
            kernel_bound, kernel_kind = bound_ms(*kernel_work, peak_flop_per_s)
            print(f"{name}: kernel alone {kernel_ms:.3f} ms against its own bound "
                  f"{kernel_bound:.3f} ms ({kernel_kind}), {100 * kernel_bound / kernel_ms:.1f} % "
                  f"of the bound [{card}]", flush=True)
            self.kernel_bound_ms += kernel_bound
        for k in t:
            self.t[k] += t[k]
        self.kernel_ms += kernel_ms or 0.0
        self.err = max(self.err, err)
        self.kinds.append((t["bound_ms"], kind))

    def json(self):
        out = dict(self.fields, max_abs_err=self.err, bound_by=max(self.kinds)[1], **self.t)
        if self.kernel_ms:
            out["kernel_only_ms"] = self.kernel_ms
        if self.kernel_bound_ms:
            out["kernel_bound_ms"] = self.kernel_bound_ms
        return out


def _random_complex(rng, shape, dev):
    re = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return torch.complex(re, im)


def _add_k2(entry, card, rng, name, args, library, nbytes, flops):
    """K2 on the planes of ``args`` (``propagate_planes``' arguments) and a
    seeded random cotangent, against its plain version and against
    ``torch.autograd`` through K1's plain version, then timed into
    ``entry`` beside ``library``, which takes the cotangent as
    (B, 3, rows, cols)."""
    from .ops.cuda import spectral

    fr, fi, wl2, dvec, mask, kcfg = args
    g = _random_complex(rng, (fr.shape[0], kcfg[4], ROWS, COLS), fr.device)
    gr, gi = g.real.contiguous(), g.imag.contiguous()
    kr, ki = spectral._adjoint_cuda(gr, gi, wl2, dvec, mask, kcfg)
    err = check_rel(name, kr, ki, *spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, mask, kcfg))
    fr_, fi_ = fr.clone().requires_grad_(True), fi.clone().requires_grad_(True)
    pr, pi = spectral.propagate_planes_reference(fr_, fi_, wl2, dvec, mask, kcfg)
    check_rel(name + " vs autograd", kr, ki, *torch.autograd.grad((pr * gr + pi * gi).sum(), (fr_, fi_)))
    del kr, ki, pr, pi
    x = torch.fft.fft(torch.nn.functional.pad(g, (PAD, PAD)), dim=-1)
    lib_in = g.reshape(-1, 3, ROWS, COLS)
    entry.add(name, card, err, lambda: spectral._adjoint_cuda(gr, gi, wl2, dvec, mask, kcfg),
              lambda: spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, mask, kcfg),
              lambda: library(lib_in), lambda: spectral.row_adjoint(x, wl2, dvec, mask, kcfg),
              nbytes, flops,
              kernel_work=k2_row_adjoint_work(fr.shape[0], ROWS, kcfg[5], kcfg[6], kcfg[4], mask,
                                              kcfg[2]))


def training_kernels(card):
    """K1's training modes, K2 and K3 at the train step's full-width shapes;
    returns their JSON entries, ``launches`` still to be filled in."""
    from .config import OpticsConfig
    from .ops import asm
    from .ops.cuda import fft, spectral

    dev = torch.device("cuda")
    optics = OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45)
    plan = asm.make_plan(optics, distances=DISTANCES, device=dev)
    gen_plan = asm.make_plan(optics, distances=[1e-3], device=dev)
    rp, cp = plan.padded_rows, plan.padded_cols
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.permutation(len(DISTANCES))[:BATCH]).to(dev)
    idx2 = torch.cat([idx, idx])  # hat[i] and target[i] share the draw
    hm = plan.H * plan.mask  # (D, C, rp, cp): the library chain's cached H * mask
    k1_src = "learned_hologram_gan_tpu_torch/csrc/k1_asm_propagate.cu"
    k1_at = "learned_hologram_gan_tpu/ops/pallas/spectral.py:686"

    # K1: one step's random-distance reconstruction (hat and target, 24
    # planes, a distance per sample) + one eval step's 20-distance stack
    # (a validation batch of 2: 12 planes)
    k1 = _Entry("k1_asm_propagate_fwd_from_spectrum", k1_src, k1_at,
                "train step (24 planes from_spectrum+per_plane) + eval step (12 planes, D=20), "
                "1024x1024 -> 384x384")
    spec = _random_complex(rng, (2 * BATCH, 3, rp, cp), dev)
    per_plane = asm.fused_args(plan, spec, plan.distances[idx2], from_spectrum=True, per_plane=True)
    calls = [
        ("K1 from_spectrum+per_plane (train step)", per_plane,
         lambda: asm.crop(plan, torch.fft.ifft2(spec * hm[idx2]))),
        ("K1 from_spectrum D=20 (eval step)",
         asm.fused_args(plan, spec[:2 * VAL_BATCH], plan.distances, from_spectrum=True),
         lambda: asm.crop(plan, torch.fft.ifft2(spec[:2 * VAL_BATCH, None] * hm[None]))),
    ]
    for name, args, library in calls:
        fr, fi, wl2, dvec, mask, kcfg = args
        p, num_d = fr.shape[0], kcfg[4]
        err = check_rel(name, *spectral.propagate_planes(*args),
                        *spectral.propagate_planes_reference(*args))
        x = torch.complex(fr, fi)
        # the spectrum is read, and H applied, on the mask's support only
        support = spectral_support(mask, rp, cp)
        k1.add(name, card, err, lambda: spectral.propagate_planes(*args),
               lambda: spectral.propagate_planes_reference(*args), library,
               lambda: spectral.row_pass(x, wl2, dvec, mask, kcfg),
               2 * p * support * 4 + rp * cp * 4 + 2 * p * num_d * ROWS * COLS * 4,
               fft_flops(rp, p * num_d * cp) + fft_flops(cp, p * num_d * ROWS) + p * num_d * support * 16,
               kernel_work=k1_row_pass_work(p, ROWS, rp, cp, num_d, mask, True))
        del x

    # K2: one step's two backward calls, through the random-distance
    # reconstruction (24 planes) and AP2POH's conj(H) step (12 planes)
    k2 = _Entry("k2_asm_propagate_bwd", k1_src, k1_at,
                "one train step's backward: (24 planes from_spectrum+per_plane) + (12 planes conj_h D=1)")
    field = torch.ones(BATCH, 3, ROWS, COLS, dtype=torch.complex64, device=dev)
    calls = [
        ("K2 from_spectrum+per_plane (train step)", per_plane,
         lambda g: torch.fft.fft2(asm.pad(plan, g)) * torch.conj(hm[idx2]) / (rp * cp)),
        ("K2 conj_h D=1 (AP2POH)",
         asm.fused_args(gen_plan, field, gen_plan.distances[:1], conj_h=True, use_mask=False),
         lambda g: asm.crop(gen_plan, torch.fft.ifft2(torch.fft.fft2(asm.pad(gen_plan, g)) * gen_plan.H[0]))),
    ]
    for name, args, library in calls:
        p, num_d, from_spectrum = args[0].shape[0], args[-1][4], args[-1][2]
        out_rows, out_cols = (rp, cp) if from_spectrum else (ROWS, COLS)
        mask = args[4]
        flops = (fft_flops(cp, p * num_d * ROWS) + fft_flops(rp, p * num_d * cp)
                 + p * num_d * spectral_support(mask, rp, cp) * (16 if mask is not None else 14))
        if not from_spectrum:
            flops += fft_flops(rp, p * cp) + fft_flops(cp, p * ROWS)
        _add_k2(k2, card, rng, name, args, library,
                2 * p * num_d * ROWS * COLS * 4 + 2 * p * out_rows * out_cols * 4
                + (rp * cp * 4 if mask is not None else 0), flops)
    del spec, hm, per_plane

    # K3: one step's 2-D transforms of (12, 1024, 1024): the hat and target
    # fft2 and the hat's adjoint (the unnormalised inverse)
    k3 = _Entry("k3_fft", "learned_hologram_gan_tpu_torch/csrc/k3_fft.cu",
                "learned_hologram_gan_tpu/ops/pallas/spectral.py:320",
                "one train step: 2 fft2 + 1 adjoint of (12, 1024, 1024) complex64, 4 + 2 passes")
    x = _random_complex(rng, (BATCH * 3, rp, cp), dev)
    y, ref_y = fft.fft2(x), torch.fft.fft2(x)
    err = check_rel("K3 fft2", y.real, y.imag, ref_y.real, ref_y.imag)
    adj, ref_adj = fft._transform2(x, True, 1.0), torch.fft.ifft2(x, norm="forward")
    err = max(err, check_rel("K3 adjoint (N * ifft2)", adj.real, adj.imag, ref_adj.real, ref_adj.imag))
    xs = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(fft.fft2(xs), xs, x)
    check_rel("K3 fft2 backward", gx.real, gx.imag, ref_adj.real, ref_adj.imag)
    del y, ref_y, adj, ref_adj, xs, gx

    def plain():
        for inverse in (False, False, True):
            fft.fft_axis_reference(fft.fft_axis_reference(x, -1, inverse, 1.0), -2, inverse, 1.0)

    k3.add("K3 (2 fft2 + 1 adjoint of (12, 1024, 1024))", card, err,
           lambda: (fft.fft2(x), fft.fft2(x), fft._transform2(x, True, 1.0)), plain,
           lambda: (torch.fft.fft2(x), torch.fft.fft2(x), torch.fft.ifft2(x, norm="forward")), None,
           3 * 2 * x.numel() * 8, 3 * (fft_flops(cp, x.shape[0] * rp) + fft_flops(rp, x.shape[0] * cp)))
    # each one-axis pass alone, in TB/s of its own bytes (read + write),
    # beside cuFFT's same pass and a device copy of the same bytes
    nbytes = 2 * x.numel() * 8
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), iters=10)
    print(f"K3: a device copy of (12, 1024, 1024) complex64 {copy_ms:.4f} ms, "
          f"{nbytes / copy_ms / 1e9:.2f} TB/s [{card}]", flush=True)
    k3.fields["passes"] = dict(copy=dict(ms=copy_ms, tb_s=nbytes / copy_ms / 1e9))
    del y
    for axis in (-1, -2):
        for inverse in (False, True):
            label = f"axis {axis} {'inverse' if inverse else 'forward'}"
            lib = torch.fft.ifft if inverse else torch.fft.fft
            ms = cuda_ms(lambda: fft.fft_axis(x, axis, inverse, 1.0), iters=10)
            lib_ms = cuda_ms(lambda: lib(x, dim=axis, norm="forward" if inverse else "backward"), iters=10)
            k3.fields["passes"][label] = dict(ms=ms, tb_s=nbytes / ms / 1e9, cufft_ms=lib_ms,
                                              cufft_tb_s=nbytes / lib_ms / 1e9)
            print(f"K3 pass {label} of (12, 1024, 1024): {ms:.4f} ms, {nbytes / ms / 1e9:.2f} TB/s; "
                  f"cuFFT {lib_ms:.4f} ms, {nbytes / lib_ms / 1e9:.2f} TB/s [{card}]", flush=True)
    del x
    torch.cuda.empty_cache()
    return dict(k1_train=k1.json(), k2=k2.json(), k3=k3.json())


def two_h_kernels(card):
    """K1 and K2 on the two-H path's calls at full width: the hat (the POH
    field at z_hat = 1 mm + z, mask gen * multi) and the target (at z, mask
    multi ** 2), 12 field planes of 384 x 384 each, a distance per plane,
    the masks computed on the card; K2 on the hat's adjoint.  The library
    yardstick is the cached-H ``torch.fft`` chain, fft2(pad(g)) * H * mask
    -> ifft2 -> crop, and its adjoint.  Returns their JSON entries,
    ``launches`` still to be filled in."""
    from .config import OpticsConfig
    from .ops import asm
    from .ops.cuda import spectral

    dev = torch.device("cuda")
    optics = OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45)
    plan = asm.make_plan(optics, distances=DISTANCES, device=dev)
    gen_plan = asm.make_plan(optics, distances=[1e-3], device=dev)
    rp, cp = plan.padded_rows, plan.padded_cols
    rng = np.random.default_rng(5)
    z = plan.distances[torch.from_numpy(rng.permutation(len(DISTANCES))[:BATCH]).to(dev)]
    shape = (BATCH, 3, ROWS, COLS)
    poh, amp, phs = (torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev) for _ in range(3))
    calls = [("hat", asm.field(torch.ones_like(poh), 2 * np.pi * poh), gen_plan.distances[0] + z,
              gen_plan.mask * plan.mask),
             ("target", asm.field(amp, 2 * np.pi * phs), z, plan.mask * plan.mask)]
    k1_src = "learned_hologram_gan_tpu_torch/csrc/k1_asm_propagate.cu"
    k1_at = "learned_hologram_gan_tpu/ops/pallas/spectral.py:686"
    k1 = _Entry("k1_two_h", k1_src, k1_at, "one two-H train step: hat + target, 12 field planes each, "
                "per_plane, product masks, 384x384 in 1024x1024")
    k2 = _Entry("k2_two_h", k1_src, k1_at, "one two-H train step's backward: the hat's adjoint, "
                "12 planes, per_plane, product mask, 384x384 in 1024x1024")
    for name, g, dists, mask in calls:
        args = asm.fused_args(plan, g, dists, per_plane=True, mask_override=mask)
        fr, fi, wl2, dvec, m, kcfg = args
        err = check_rel(f"K1 field+per_plane, {name} mask", *spectral.propagate_planes(*args),
                        *spectral.propagate_planes_reference(*args))
        hm = asm._transfer_function(plan.w_grid, dists) * mask  # (B, C, rp, cp), cached
        x = torch.fft.fft(torch.nn.functional.pad(torch.complex(fr, fi), (PAD, PAD)), dim=-1)
        work = k1_work(fr.shape[0], ROWS, COLS, rp, cp, 1, m)
        k1.add(f"K1 field+per_plane ({name})", card, err, lambda: spectral.propagate_planes(*args),
               lambda: spectral.propagate_planes_reference(*args),
               lambda: asm.crop(plan, torch.fft.ifft2(torch.fft.fft2(asm.pad(plan, g)) * hm)),
               lambda: spectral.row_pass(x, wl2, dvec, m, kcfg), *work,
               kernel_work=k1_row_pass_work(fr.shape[0], ROWS, rp, cp, 1, m, False))
        if name == "hat":
            _add_k2(k2, card, rng, "K2 field+per_plane (hat)", args,
                    lambda cot: asm.crop(plan, torch.fft.ifft2(torch.fft.fft2(asm.pad(plan, cot)) * torch.conj(hm))),
                    *work)
    del calls, poh, amp, phs, x, hm
    torch.cuda.empty_cache()
    return dict(k1_two_h=k1.json(), k2_two_h=k2.json())


def _write_bins(tmp):
    """SAMPLES seeded random training samples; 100 validation samples as
    sparse all-zero files (the CLI hard-codes 100 and reads what it uses).
    Returns the CLI's path flags and the training files."""
    rng = np.random.default_rng(4)
    argv, train = [], []
    for name in ("img", "depth", "amp", "phs"):
        path = os.path.join(tmp, f"train_{name}.bin")
        rng.random((SAMPLES, 3, ROWS, COLS), dtype=np.float32).tofile(path)
        argv += [f"--train_{name}_path", path]
        train.append(path)
        path = os.path.join(tmp, f"validate_{name}.bin")
        with open(path, "wb") as f:
            f.truncate(100 * 3 * ROWS * COLS * 4)
        argv += [f"--validate_{name}_path", path]
    return argv, train


def _counts():
    from .ops.cuda import fft, spectral

    return dict(k1=dict(spectral.row_pass.launches_by_mode), k2=dict(spectral.row_adjoint.launches_by_mode),
                k3=fft.fft_axis.launches)


def expected_launches(two_h_hat, freeze_part1=False, steps=STEPS, visualizations=1):
    """K1 and K2 launches by mode and K3's (one launch per pass, two per 2-D
    transform) that the code makes in ``training_model.main``'s ``steps``
    steps and its end-of-epoch ``visualizations`` (AP2POH, then the POH at
    1 mm), and in one eval step.  A step runs AP2POH (K1 conj_h; K2 in the
    backward, unless ``freeze_part1`` leaves AP2POH's input without
    gradient) and then either the two-H reconstruction, K1 twice in
    field+per_plane mode and K2 once, no K3; or the composed one: two fft2
    (K3), K1 once in from_spectrum+per_plane mode, K2 once and fft2's
    adjoint (K3).  The eval step: AP2POH, two fft2, the 20-distance
    stack."""
    vis = visualizations
    if two_h_hat:
        main = dict(k1={"conj_h": steps + vis, "field+per_plane": 2 * steps, "field": vis},
                    k2={"conj_h": steps, "field+per_plane": steps}, k3=0)
    else:
        main = dict(k1={"conj_h": steps + vis, "from_spectrum+per_plane": steps, "field": vis},
                    k2={"conj_h": steps, "from_spectrum+per_plane": steps}, k3=6 * steps)
    if freeze_part1:
        del main["k2"]["conj_h"]
    return main, dict(k1={"conj_h": 1, "from_spectrum": 1}, k2={}, k3=4)


def training_path(card, dtype="float32", two_h_hat=False, critic_batching="pair", profile=False):
    """The training path through ``training_model.main`` at full width in
    ``dtype`` with the step options, then one validation batch through the
    trainer's eval step (the CLI validates every 50 steps; this epoch has
    2).  Then, on the trainer's state, one warm-up step (the first after the
    eval step's allocations), 2 steps timed by the host clock, with the
    peak memory from the warm-up on, one step split by CUDA events and,
    with ``profile``, the same split under ``torch.profiler``.  Returns the
    kernels' launches on the main path's run (:func:`_counts`; ``in_main``
    without the eval step) and the step's numbers."""
    from . import card_check, training_model
    from .data import ImgDepthAmpPhsDataset, epoch_loader
    from .ops.cuda import fft, spectral
    from .train import steps

    label = f"--dtype {dtype}" + (" --two_h_hat" if two_h_hat else "") + (
        "" if critic_batching == "pair" else f" --critic_batching {critic_batching}")
    with tempfile.TemporaryDirectory(prefix="train_smoke_") as tmp:
        out = os.path.join(tmp, "out")
        argv, train_paths = _write_bins(tmp)
        argv += [
            "--samplesNum", str(SAMPLES), "--channlesNum", "3", "--height", str(ROWS),
            "--width", str(COLS), "--batch_size", str(BATCH), "--epoch_num", "1",
            "--save_path_G", os.path.join(out, "G.pt"), "--save_path_D", os.path.join(out, "D.pt"),
            "--loss_metrics_file", os.path.join(out, "history.json"),
            "--save_path_img", os.path.join(out, "imgs"),
            "--use_gan", "--perceptual", "random", "--device", "cuda", "--dtype", dtype,
            "--critic_batching", critic_batching,
        ] + (["--two_h_hat"] if two_h_hat else [])
        dataset = ImgDepthAmpPhsDataset(*train_paths, SAMPLES, 3, ROWS, COLS)
        # the main path's run: counters to 0 just before, read just after
        torch.cuda.reset_peak_memory_stats()
        spectral.reset_launch_counts()
        fft.fft_axis.launches = 0
        fwd, bwd, dtypes = [], [], set()
        start = time.perf_counter()
        with card_check.record_conv_tf32(fwd, bwd, dtypes):
            trainer, _ = training_model.main(argv)
            torch.cuda.synchronize()
            in_main = _counts()
            val_batch = next(epoch_loader(dataset, VAL_BATCH, shuffle=False, drop_last=True))
            val = trainer.eval_step(trainer.state, val_batch, trainer.gen_plan, trainer.multi_plan)
            val = {k: float(v) for k, v in val.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = _counts()
        in_eval = {k: launches[k] - in_main[k] if k == "k3" else
                   dict(collections.Counter(launches[k]) - collections.Counter(in_main[k])) for k in launches}
        print(f"training_model.main {label} ({STEPS} steps, weights init and first-call setup "
              f"included) + one eval step: {wall:.2f} s; convolutions computed in "
              f"{sorted(str(d) for d in dtypes)}; launches in main {in_main}, in the eval step "
              f"{in_eval}; TF32 on in {sum(fwd)} of {len(fwd)} convolution forwards and {sum(bwd)} of "
              f"{len(bwd)} backwards; peak memory of the run {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]", flush=True)
        print("eval step metrics: " + ", ".join(f"{k} {v:.6g}" for k, v in val.items()), flush=True)
        want_main, want_eval = expected_launches(two_h_hat)
        if (in_main, in_eval) != (want_main, want_eval):
            raise AssertionError(f"launches on the training path: main {in_main}, eval {in_eval}; "
                                 f"want {want_main}, {want_eval}")
        if not fwd or not bwd or any(fwd) or any(bwd):
            raise AssertionError("the training path ran float32 convolutions with TF32 on")
        if dtypes != {torch.float32, getattr(torch, dtype)}:  # VGG19 stays float32
            raise AssertionError(f"convolutions computed in {dtypes}, want {dtype} and VGG19's float32")
        if not all(np.isfinite(v) for v in val.values()):
            raise AssertionError(f"non-finite eval metrics: {val}")
        for net in (trainer.state.generator, trainer.state.discriminator):
            if not all(bool(torch.isfinite(p).all()) for p in net.parameters()):
                raise AssertionError("non-finite parameters after training: a loss was not finite")
        names = set(os.listdir(out))
        for want in ("G.pt", "D.pt", "G_epoch0.pt", "D_epoch0.pt", "history.json"):
            if want not in names:
                raise AssertionError(f"{want} not written ({sorted(names)})")
        for want in ("G.pt", "G_epoch0.pt"):
            if set(torch.load(os.path.join(out, want), weights_only=True)) != set(trainer.state.generator.state_dict()):
                raise AssertionError(f"{want} does not hold the generator's state_dict")
        with open(os.path.join(out, "history.json")) as f:
            hist = json.load(f)
        if set(hist) != {"epoch", "n_batch_in_epoch", "n_train", "n_batch", "train_losses_tensor",
                         "train_metrics_tensor", "validate_losses_tensor", "validate_metrics_tensor"}:
            raise AssertionError(f"history keys {sorted(hist)}")
        pngs = sorted(os.listdir(os.path.join(out, "imgs")))
        if pngs != ["amp_hat in epoch 0.png", "phs_hat in epoch 0.png"]:
            raise AssertionError(f"PNGs written: {pngs}")
        loader = list(epoch_loader(dataset, BATCH, shuffle=True, drop_last=True, seed=7))

    # steps/s and where one step's time goes, on the trainer's own state
    state, plans = trainer.state, (trainer.gen_plan, trainer.multi_plan)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, loader[0], *plans)
    timed_steps = [loader[1 % len(loader)], loader[0]]
    torch.cuda.synchronize()
    start = time.perf_counter()
    for batch in timed_steps:
        _, metrics = trainer.train_step(state, batch, *plans)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - start) / len(timed_steps)
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
        raise AssertionError(f"non-finite train metrics: {metrics}")
    print("train step metrics: " + ", ".join(f"{k} {float(v):.6g}" for k, v in metrics.items()), flush=True)

    def phases(batch, timed):
        idx, alphas = steps.draw_step_randoms(state, trainer.multi_plan, BATCH, RATIO)
        recon = timed("G forward + reconstruction",
                      lambda: steps.reconstruct(state.generator, *plans, batch, idx, two_h=two_h_hat))
        timed("critic loop", lambda: steps.critic_updates(
            state, recon[1], recon[0].detach(), alphas.cuda(), LAMBDA, critic_batching))
        timed("G loss + backward + Adam", lambda: steps.generator_update(state, trainer.loss_cfg, recon))

    split = {}

    def timed(label, fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        result = fn()
        ev[1].record()
        torch.cuda.synchronize()
        split[label] = ev[0].elapsed_time(ev[1])
        return result

    for batch in loader[:1]:
        phases(batch, timed)
    total = sum(split.values())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train step at full width ({label}, batch {BATCH}, ratio {RATIO}): {1 / step_s:.3f} steps/s "
          f"({step_s * 1e3:.1f} ms, {len(timed_steps)} steps, host clock); split by CUDA events: "
          + ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f} %)" for k, v in split.items())
          + f"; peak memory of the steps {peak_gib:.2f} GiB [{card}]", flush=True)
    if profile:
        # the same split under the profiler: kernels and the device's busy share
        phases(loader[0], lambda label, fn: profile_kernels(label, fn, card))
    del trainer, state
    torch.cuda.empty_cache()
    return dict(launches=launches, in_main=in_main, label=label, steps_per_s=1 / step_s,
                peak_gib=peak_gib, split=split)
