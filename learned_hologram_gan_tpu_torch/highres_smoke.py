"""The high-resolution path at full width on the card, which
``chip_smoke.py`` runs.

Seeded random weights (UNet base 64, critic feature_d 32) and seeded random
data; no depth cut:

  1. 1080p training: ``tools/highres_train_bench`` (a full WGAN-GP step at
     1088 x 1920, pad 320, batch 1, ratio 1, 8 distances, bfloat16), one
     warm-up and 2 steps timed by CUDA events, with both levers (remat and
     H on the fly), then each lever off and both off: ms/step, peak
     memory and one more step split into its three phases;
  2. 1080p fine-tune: ``tools/finetune_highres`` on 4 device-resident
     bfloat16 samples, 1 epoch at batch 1 (the non-GAN objective, remat,
     H on the fly), then its evaluation at 1088 x 1920 (``--no_cache_h``,
     8 planes, batch 1) on 2 samples: steps/s, eval ms/sample, peak memory;
  3. 4K zero-shot evaluation: ``tools/eval_quality`` at 2176 x 3840, pad
     352 / 580 (``utils/fftlen.good_fft_pads``), ``--sequential
     --no_cache_h``, bfloat16, 8 planes, batch 1, 2 samples: ms/sample and
     peak memory, then ms/sample of a second run;
  4. the quality run's evaluation: ``tools/eval_quality`` at its defaults
     (384 x 384, pad 320, filter 0.45, bfloat16, batch 4, 20 planes) on 8
     samples, then the same with ``--sequential``: samples/s of each (and
     of a second run) and the K1 / K3 launches, the two summaries held to
     each other;
  5. the 384 x 384 remat GAN step (a small UNet, float32, Adam) against
     the plain step from the same weights and draws: losses, gradients,
     updated parameters and BatchNorm statistics within :data:`REMAT_RTOL`
     under cuDNN's deterministic algorithms, metrics and gradients within
     :data:`DEFAULT_BOUNDS` (or :data:`REMAT_FLOOR` times two plain steps'
     distance) under its default ones; every value finite;
     the recompute's extra K1 / K3 launches.

``python -m learned_hologram_gan_tpu_torch.highres_smoke --remat_step``
runs phase 5 alone, ``--repeats N --sgd --anomaly`` instead prints N
plain and N remat steps under the default algorithms one by one (``--sgd``:
SGD at lr 1 and 1e-4; ``--anomaly``: under autograd's anomaly detection).

Each run's K1, K2 and K3 launches are held to what the code makes.  At
1080p (1728 x 3048) K1 and K2 run on the mixed-radix plan of rp = 1728
(24 * 24 * 3) and K3 declines the grid (3048 = 8 * 3 * 127 has no plan),
so its 2-D transforms run ``torch.fft``; the 4K grid (2880 x 5000) runs
K1 (rp 2880 = 12 * 20 * 12 on E = 60) and K3 (5000 = 40 * 25 * 5) on both axes.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import numpy as np
import torch

# the geometries (tools/highres_train_bench.py, tools/finetune_highres.py,
# the 4K zero-shot evaluation of BASELINE.md)
HD = dict(rows=1088, cols=1920, pad=320)  # padded 1728 x 3048
UHD = dict(rows=2176, cols=3840, pad=352, pad_cols=580)  # padded 2880 x 5000
Q384 = dict(rows=384, cols=384)  # eval_quality's defaults: pad 320, a 1024 x 1024 grid
FT_TRAIN, FT_VAL, UHD_VAL, Q384_VAL = 4, 2, 2, 8
HD_WHY = "K1/K2 on rp 1728; K3 declines the 3048 columns, torch.fft runs its transforms"
# highres_train_bench runs a warm-up step, --steps 2 timed steps and one more
# split step: four steps a run
BENCH_STEPS = 4
# the sequential and fused 384^2 evaluations: the float32 propagation gate
# (1e-3 at p99.9 on the stack) moves PSNR by < 1e-3 dB and SSIM by < 1e-5
SEQ_PSNR_DB, SEQ_SSIM = 1e-3, 1e-5
# the remat step against the plain step on the card: the same float32 math,
# bit for bit under cuDNN's deterministic algorithms (REMAT_RTOL on every
# value).  Under its default ones two plain steps already differ: Adam moves
# a parameter by +-lr wherever noise flips a near-zero gradient's sign, which
# moves the critic, its running statistics and through it the generator's
# gradients (1.5e-6 to 2.4e-4 of max|g| apart, by the run).  The metrics and
# gradients are bounded by DEFAULT_BOUNDS or REMAT_FLOOR times the two plain
# steps' own distance, whichever is larger; parameters and statistics are
# printed.
REMAT_RTOL = 1e-6
DEFAULT_BOUNDS = {"metrics": 1e-5, "G": 1e-3, "D": 1e-3}
REMAT_FLOOR = 10.0
REMAT = dict(base=4, feature_d=2, batch=2, ratio=2, distances=4, pad=320)
REMAT_LR = 1e-4  # Adam, both networks, as training runs it


def _counts():
    from .ops.cuda import fft, spectral

    return dict(k1=dict(spectral.row_pass.launches_by_mode),
                k2=dict(spectral.row_adjoint.launches_by_mode), k3=fft.fft_axis.launches)


def _reset():
    from .ops.cuda import fft, spectral

    torch.cuda.synchronize()
    spectral.reset_launch_counts()
    fft.fft_axis.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gib():
    return torch.cuda.max_memory_allocated() / 2**30


def _check_launches(label, got, want, why=""):
    print(f"{label}: launches K1 {got['k1']}, K2 {got['k2']}, K3 {got['k3']}"
          + (f" ({why})" if why else ""), flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def _write_split(root, split, n, rows, cols, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    for name in ("img", "depth", "amp", "phs"):
        rng.random((n, 3, rows, cols), dtype=np.float32).tofile(os.path.join(root, split, f"{name}.bin"))


def _random_generator_file(run_dir):
    """A seeded random full-width generator as ``run_dir/G.msgpack``."""
    from .config import GeneratorConfig
    from .models import make_generator
    from .train import checkpoint as ckpt_lib

    os.makedirs(run_dir, exist_ok=True)
    ckpt_lib.save_weights(os.path.join(run_dir, "G.msgpack"),
                          make_generator(GeneratorConfig(), seed=0, device="cpu"))


def train_1080p(card):
    """Phase 1: the 1080p GAN step with the levers on, then each off, then
    both off; returns each run's ms/step and peak GiB."""
    from .tools import highres_train_bench

    runs = {}
    for label, extra in (("remat, H on the fly", []), ("no remat, H on the fly", ["--no_remat"]),
                         ("remat, H cached", ["--cache_h"]), ("no remat, H cached", ["--no_remat", "--cache_h"])):
        _reset()
        r = highres_train_bench.main(["--steps", "2", "--device", "cuda"] + extra)
        want = expected_step_launches("--no_remat" not in extra, k3_grid=False)
        want = dict(k1={k: BENCH_STEPS * v for k, v in want["k1"].items()},
                    k2={k: BENCH_STEPS * v for k, v in want["k2"].items()}, k3=0)
        launches = _counts()
        _check_launches(f"1080p GAN step ({label})", launches, want, HD_WHY)
        if not all(np.isfinite(v) for v in r["metrics"].values()):
            raise AssertionError(f"1080p GAN step ({label}): non-finite metrics {r['metrics']}")
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in r["split"].items())
        print(f"1080p GAN step ({label}): {r['ms_per_step']:.1f} ms/step (best of 2, CUDA events; "
              f"mean {r['mean_ms']:.1f}), peak {r['peak_gib']:.2f} GiB; one more step split: {split} "
              f"[{card}]", flush=True)
        runs[label] = dict(r, launches=launches)
    return runs


def finetune_1080p(card, tmp):
    """Phase 2: the fine-tune tool, 1 epoch of FT_TRAIN steps, then its
    evaluation on FT_VAL samples."""
    from .tools import finetune_highres

    data = os.path.join(tmp, "synth1080")
    _write_split(data, "train", FT_TRAIN, HD["rows"], HD["cols"], 10)
    _write_split(data, "val", FT_VAL, HD["rows"], HD["cols"], 11)
    _reset()
    r = finetune_highres.main([
        "--data", data, "--out", os.path.join(tmp, "finetune_1080p"), "--init", "",
        "--train_num", str(FT_TRAIN), "--val_num", str(FT_VAL), "--epochs", "1",
        "--device", "cuda",
    ])
    peak = _peak_gib()
    launches = _counts()
    _check_launches("1080p fine-tune + evaluation", launches, expected_finetune_launches(FT_TRAIN, FT_VAL),
                    HD_WHY)
    summary = r["evaluation"]["summary"]
    if not np.isfinite([summary["val_PSNR"], summary["val_SSIM"]]).all():
        raise AssertionError(f"1080p fine-tune evaluation: non-finite summary {summary}")
    steps = r["step_s"][1:]  # the first step carries the first call's set-up
    out = dict(steps_per_s=len(steps) / sum(steps), first_step_s=r["step_s"][0], finetune_s=r["finetune_s"],
               eval_ms_per_sample=1e3 * r["evaluation"]["sweep_s"] / FT_VAL, eval_s=r["eval_s"],
               peak_gib=peak, summary=summary, launches=launches)
    print(f"1080p fine-tune (batch 1): {out['steps_per_s']:.3f} steps/s over steps 2-{FT_TRAIN} (train steps "
          f"alone, device synchronized at each end), first step {out['first_step_s']:.2f} s; the epoch with "
          f"its validation and saves {r['finetune_s']:.2f} s; evaluation (8 planes, H on the fly) "
          f"{out['eval_ms_per_sample']:.1f} ms/sample over {FT_VAL} samples ({r['eval_s']:.2f} s with "
          f"set-up and one grid); val PSNR {summary['val_PSNR']:.4f}, SSIM {summary['val_SSIM']:.4f}; "
          f"peak {peak:.2f} GiB [{card}]", flush=True)
    return out


def eval_4k(card, tmp, run_dir):
    """Phase 3: the 4K zero-shot evaluation."""
    from .tools import eval_quality
    from .utils.fftlen import good_fft_pads

    if good_fft_pads(UHD["rows"], UHD["cols"], 320) != (UHD["pad"], UHD["pad_cols"]):
        raise AssertionError("good_fft_pads(2176, 3840, 320) is not (352, 580)")
    data = os.path.join(tmp, "synth4k")
    _write_split(data, "val", UHD_VAL, UHD["rows"], UHD["cols"], 12)
    argv = ["--data", data, "--run_dir", run_dir, "--out", os.path.join(tmp, "eval_4k"),
            "--rows", str(UHD["rows"]), "--cols", str(UHD["cols"]), "--pad_size", str(UHD["pad"]),
            "--pad_cols", str(UHD["pad_cols"]), "--sequential", "--no_cache_h", "--num_planes", "8",
            "--batch", "1", "--val_num", str(UHD_VAL), "--samples", "--device", "cuda"]
    _reset()
    r = eval_quality.main(argv)
    peak = _peak_gib()
    launches = _counts()
    _check_launches("4K zero-shot evaluation", launches, expected_eval_launches(UHD_VAL, 8, True),
                    "K1 on rp 2880, K3 on 2880 x 5000, one ifft2 a distance")
    s = r["summary"]
    if not np.isfinite([s["val_PSNR"], s["val_SSIM"]] + s["per_plane_PSNR"]).all():
        raise AssertionError(f"4K evaluation: non-finite summary {s}")
    warm = eval_quality.main(argv)  # the same samples again, first-call set-up done
    if warm["summary"] != s:
        raise AssertionError("the 4K evaluation's second run gives another summary")
    out = dict(ms_per_sample=1e3 * r["sweep_s"] / UHD_VAL, warm_ms_per_sample=1e3 * warm["sweep_s"] / UHD_VAL,
               peak_gib=peak, summary=s, launches=launches)
    print(f"4K zero-shot evaluation (2880 x 5000 grid, sequential, H on the fly, bf16, 8 planes): "
          f"{out['ms_per_sample']:.1f} ms/sample over {UHD_VAL} samples, first call included; "
          f"{out['warm_ms_per_sample']:.1f} ms/sample on a second run; val PSNR {s['val_PSNR']:.4f}, "
          f"SSIM {s['val_SSIM']:.4f}; peak {peak:.2f} GiB [{card}]", flush=True)
    return out


def expected_finetune_launches(train: int, val: int) -> dict:
    """finetune_highres's launches at 1080p (K1 and K2, no K3): ``train``
    non-GAN steps under remat (no validation: its interval is 24 steps),
    then the evaluation's ``val`` batches of 1 and sample 0's grid, each
    AP2POH (conj_h) and one from_spectrum stack."""
    step = expected_step_launches(True, k3_grid=False)
    recons = val + 1
    return dict(k1={"conj_h": train * step["k1"]["conj_h"] + recons,
                    "from_spectrum+per_plane": train * step["k1"]["from_spectrum+per_plane"],
                    "from_spectrum": recons},
                k2={k: train * v for k, v in step["k2"].items()}, k3=0)


def expected_eval_launches(recons: int, distances: int, sequential: bool) -> dict:
    """The kernel launches of ``recons`` eval_quality reconstructions at a
    grid K1 and K3 both take (384^2's 1024 x 1024, the portrait 1280 x 768,
    4K's 2880 x 5000): AP2POH (K1 conj_h), two fft2 (K3, two passes each),
    then the focal stack: one K1 from_spectrum call over every distance,
    or with ``sequential`` one ifft2 per distance (K3 again)."""
    if sequential:
        return dict(k1={"conj_h": recons}, k2={}, k3=recons * (4 + 2 * distances))
    return dict(k1={"conj_h": recons, "from_spectrum": recons}, k2={}, k3=4 * recons)


def eval_384(card, tmp, run_dir):
    """Phase 4: eval_quality at its defaults on Q384_VAL samples, then with
    ``--sequential``; the summaries agree."""
    from .tools import eval_quality

    data = os.path.join(tmp, "synth384")
    _write_split(data, "val", Q384_VAL, Q384["rows"], Q384["cols"], 13)
    out = {}
    for label, extra in (("fused", []), ("sequential", ["--sequential"])):
        argv = ["--data", data, "--run_dir", run_dir, "--val_num", str(Q384_VAL),
                "--out", os.path.join(tmp, f"eval_384_{label}"), "--device", "cuda"] + extra
        _reset()
        r = eval_quality.main(argv)
        peak = _peak_gib()
        recons = Q384_VAL // 4 + 3  # two batches of 4, then the three grids' samples
        launches = _counts()
        _check_launches(f"384^2 evaluation ({label})", launches,
                        expected_eval_launches(recons, 20, label == "sequential"))
        warm = eval_quality.main(argv + ["--samples"])  # again, set-up done, no grids
        rate, warm_rate = Q384_VAL / r["sweep_s"], Q384_VAL / warm["sweep_s"]
        print(f"384^2 evaluation ({label}; bf16, batch 4, 20 planes): {rate:.2f} samples/s "
              f"({Q384_VAL} samples, host clock, first call included), {warm_rate:.2f} samples/s on a "
              f"second run; val PSNR {r['summary']['val_PSNR']:.6f}, SSIM {r['summary']['val_SSIM']:.6f}; "
              f"peak {peak:.2f} GiB [{card}]", flush=True)
        out[label] = dict(samples_per_s=rate, warm_samples_per_s=warm_rate, peak_gib=peak,
                          summary=r["summary"], launches=launches)
    a, b = out["fused"]["summary"], out["sequential"]["summary"]
    d_psnr = max(abs(a["val_PSNR"] - b["val_PSNR"]),
                 *(abs(x - y) for x, y in zip(a["per_plane_PSNR"], b["per_plane_PSNR"])))
    d_ssim = abs(a["val_SSIM"] - b["val_SSIM"])
    print(f"384^2 evaluation, sequential against fused: PSNR {d_psnr:.2e} dB (val and per plane), "
          f"SSIM {d_ssim:.2e} (bounds {SEQ_PSNR_DB:g} dB, {SEQ_SSIM:g})", flush=True)
    # per-plane PSNRs are rounded to 3 decimals: a rounding step is 1e-3
    if not (abs(a["val_PSNR"] - b["val_PSNR"]) <= SEQ_PSNR_DB and d_psnr <= SEQ_PSNR_DB + 1e-3
            and d_ssim <= SEQ_SSIM):
        raise AssertionError("the sequential evaluation's summary disagrees with the fused one's")
    out["d_psnr"], out["d_ssim"] = d_psnr, d_ssim
    return out


def expected_step_launches(remat: bool, k3_grid: bool = True) -> dict:
    """The launches of one default train step (pair batching, the composed
    reconstruction) at a grid K1 takes: AP2POH (K1 conj_h), the hat's and
    the target's fft2 (K3, two passes each, where K3 takes the grid), the
    random-distance stack (K1 from_spectrum+per_plane); the backward runs
    K2 in both modes and the hat fft2's adjoint (K3).  With ``remat`` the
    backward first runs steps 1-4 again: K1 twice as often, and 4 more K3
    passes; K2 as before.  The non-GAN step of the fine-tune makes the
    same launches (its critic runs no transform)."""
    k = 2 if remat else 1
    return dict(k1={"conj_h": k, "from_spectrum+per_plane": k},
                k2={"conj_h": 1, "from_spectrum+per_plane": 1}, k3=(6 + 4 * (k - 1)) if k3_grid else 0)


def _remat_inputs(dev):
    """Phase 5's seeded batch, distance indices, GP alphas and random VGG19."""
    from .losses import load_vgg19_params, make_vgg19

    t, rows = REMAT, Q384["rows"]
    vgg_state, _ = load_vgg19_params(mode="random")
    rng = np.random.default_rng(21)
    batch = tuple(torch.from_numpy(rng.random((t["batch"], c, rows, rows), dtype=np.float32)).to(dev)
                  for c in (4, 3, 3))
    idx = torch.from_numpy(rng.permutation(t["distances"])[: t["batch"]])
    alphas = torch.from_numpy(rng.random((t["ratio"], t["batch"], 1, 1, 1), dtype=np.float32))
    return make_vgg19(vgg_state, dev), batch, idx, alphas


def _nonfinite(named: dict) -> list:
    return [k for k, v in named.items() if not bool(torch.isfinite(v).all())]


def remat_step_run(inputs, remat: bool, deterministic: bool, dev="cuda", sgd: bool = False,
                   anomaly: bool = False) -> dict:
    """One phase-5 step from the seeded state (Adam, lr 1e-4, as training
    runs it; ``sgd``: SGD at lr 1 for the generator and 1e-4 for the
    critic, the generator and critic initialized from seeds 22 and 23),
    under cuDNN's deterministic algorithms or its default ones,
    and under autograd's anomaly detection when ``anomaly``.  Returns the
    metrics, the gradients (the generator's, and the critic's of its last
    iteration), the parameters after the update, the BatchNorm running
    statistics, the launches, the peak memory, and the names of every
    non-finite value among them (or, under ``anomaly``, the error)."""
    from .config import DiscriminatorConfig, GeneratorConfig, LossConfig
    from .models import make_generator_plan
    from .models.discriminator import init_discriminator
    from .nn.blocks import init_weights
    from .ops import asm
    from .train import steps
    from .train.state import build_modules, create_train_state

    t, rows, dev = REMAT, Q384["rows"], torch.device(dev)
    vgg, batch, idx, alphas = inputs
    cfg = GeneratorConfig(rows=rows, cols=rows, pad_size=t["pad"], filter_radius_coefficient=0.45,
                          unet_base_features=t["base"], remat=remat)
    g, d = build_modules(cfg, DiscriminatorConfig(feature_d=t["feature_d"]), use_gan=True)
    state = create_train_state(22, g, d, REMAT_LR, REMAT_LR, dev, vgg)
    if sgd:  # each network from a seed of its own
        init_weights(g, torch.Generator().manual_seed(22))
        init_discriminator(d, torch.Generator().manual_seed(23))
        state.opt_G = torch.optim.SGD(g.parameters(), lr=1.0)
        state.opt_D = torch.optim.SGD(d.parameters(), lr=1e-4)
    gen_plan = make_generator_plan(cfg, device=dev)
    multi = asm.make_plan(cfg.optics(), distances=np.linspace(-4e-4, 0.0, t["distances"] + 1)[:-1], device=dev)
    step = steps.build_train_step(LossConfig(perceptual_loss_weight=0.1, discriminator_loss_weight=0.1,
                                             perceptual="random"), True, t["ratio"], 10.0, remat=remat)
    if dev.type == "cuda":
        _reset()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    error = None
    try:
        with torch.autograd.detect_anomaly(check_nan=True) if anomaly else contextlib.nullcontext():
            _, metrics = step(state, batch, gen_plan, multi, idx=idx, alphas=alphas)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    except RuntimeError as e:
        if not anomaly:
            raise
        error, metrics = str(e).splitlines()[0], {}
    finally:
        torch.backends.cudnn.deterministic = saved
    named = [(n, net) for n, net in (("G", g), ("D", d))]
    out = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={f"{n}.{k}": v.grad.double().cpu() for n, net in named for k, v in net.named_parameters()
               if v.grad is not None},
        params={f"{n}.{k}": v.detach().double().cpu() for n, net in named for k, v in net.named_parameters()},
        stats={f"{n}.{k}": v.detach().double().cpu() for n, net in named
               for k, v in net.state_dict().items() if k.endswith(("running_mean", "running_var"))},
        launches=_counts() if dev.type == "cuda" else None,
        peak_gib=_peak_gib() if dev.type == "cuda" else None,
        error=error,
    )
    out["nonfinite"] = ([k for k, v in out["metrics"].items() if not np.isfinite(v)]
                        + _nonfinite(out["grads"]) + _nonfinite(out["params"]) + _nonfinite(out["stats"]))
    return out


def step_difference(a: dict, b: dict) -> dict:
    """How far two phase-5 runs lie apart: the metrics relative to their
    size, each network's gradients (and its parameters after the update)
    relative to their largest, the running statistics relative to each
    tensor's largest, and whether all of these are equal bit for bit."""
    out = dict(metrics=max(abs(a["metrics"][k] - b["metrics"][k]) / max(abs(a["metrics"][k]), 1e-7)
                           for k in a["metrics"]))

    def rel(x, y, keys):
        return max(float((x[k] - y[k]).abs().max()) for k in keys) / max(float(x[k].abs().max()) for k in keys)

    for net in ("G", "D"):
        out[net] = rel(a["grads"], b["grads"], [k for k in a["grads"] if k.startswith(net + ".")])
        out[f"{net} params"] = rel(a["params"], b["params"], [k for k in a["params"] if k.startswith(net + ".")])
    out["stats"] = max(float((a["stats"][k] - b["stats"][k]).abs().max() / a["stats"][k].abs().max())
                       for k in a["stats"])
    out["bitwise"] = a["metrics"] == b["metrics"] and all(
        torch.equal(a[part][k], b[part][k]) for part in ("grads", "params", "stats") for k in a[part])
    return out


GATED = ("metrics", "G", "D", "G params", "D params", "stats")


def _fmt(diff: dict) -> str:
    return (f"metrics {diff['metrics']:.2e}, gradients G {diff['G']:.2e} D {diff['D']:.2e} of max|g|, "
            f"parameters G {diff['G params']:.2e} D {diff['D params']:.2e} of max|p|, running statistics "
            f"{diff['stats']:.2e} of their max; bit for bit: {diff['bitwise']}")


def remat_step_card(card):
    """Phase 5: the remat GAN step against the plain step on the card, under
    cuDNN's deterministic algorithms (every value within REMAT_RTOL), then
    under its default ones, the algorithms users train with: a plain step,
    a remat step and a plain step again, the remat step's metrics and
    gradients within DEFAULT_BOUNDS of the first plain step's, or
    REMAT_FLOOR times the two plain steps' distance.  Every value of every
    run must be finite."""
    t = REMAT
    inputs = _remat_inputs(torch.device("cuda"))
    det = {r: remat_step_run(inputs, r, deterministic=True) for r in (False, True)}
    default = dict(plain=remat_step_run(inputs, False, False), remat=remat_step_run(inputs, True, False),
                   plain_again=remat_step_run(inputs, False, False))
    problems = [f"{label} step ({algos}): non-finite {', '.join(r['nonfinite'][:8])}"
                for algos, runs in (("deterministic", {"plain": det[False], "remat": det[True]}),
                                    ("default algorithms", default))
                for label, r in runs.items() if r["nonfinite"]]
    d_det = step_difference(det[False], det[True])
    floor = step_difference(default["plain"], default["plain_again"])
    d_default = step_difference(default["plain"], default["remat"])
    print(f"384^2 GAN step, remat against plain (float32, base {t['base']}, batch {t['batch']}, ratio "
          f"{t['ratio']}, {t['distances']} distances, Adam), cuDNN deterministic: {_fmt(d_det)} "
          f"(bound {REMAT_RTOL:g}); peak {det[False]['peak_gib']:.2f} / {det[True]['peak_gib']:.2f} GiB "
          f"[{card}]", flush=True)
    bounds = {k: max(b, REMAT_FLOOR * floor[k]) for k, b in DEFAULT_BOUNDS.items()}
    print(f"  cuDNN default algorithms: remat against plain {_fmt(d_default)}; plain against plain again "
          f"{_fmt(floor)}; bounds " + ", ".join(f"{k} {b:.2e}" for k, b in bounds.items()) + f" [{card}]",
          flush=True)
    for key in GATED:
        if not d_det[key] <= REMAT_RTOL:
            problems.append(f"deterministic: {key} {d_det[key]:.3e}")
    for key, bound in bounds.items():
        if not d_default[key] <= bound:
            problems.append(f"default algorithms: {key} {d_default[key]:.3e}")
    for r in (det[False], default["plain"], default["plain_again"]):
        _check_launches("384^2 GAN step, plain", r["launches"], expected_step_launches(False))
    for r in (det[True], default["remat"]):
        _check_launches("384^2 GAN step, remat (the recompute launches K1 and K3 again)", r["launches"],
                        expected_step_launches(True))
    if problems:
        raise AssertionError("remat step disagrees with the plain step: " + "; ".join(problems))
    return dict(deterministic=d_det, default=d_default, default_floor=floor,
                launches_plain=det[False]["launches"], launches_remat=det[True]["launches"])


def run(card):
    """Every phase above; returns their numbers."""
    with tempfile.TemporaryDirectory(prefix="highres_smoke_") as tmp:
        run_dir = os.path.join(tmp, "random_init")
        _random_generator_file(run_dir)
        out = dict(remat_step=remat_step_card(card))
        out["eval_384"] = eval_384(card, tmp, run_dir)
        out["train_1080p"] = train_1080p(card)
        out["finetune_1080p"] = finetune_1080p(card, tmp)
        out["eval_4k"] = eval_4k(card, tmp, run_dir)
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="phase 5 of the high-resolution smoke alone")
    ap.add_argument("--remat_step", action="store_true", required=True)
    ap.add_argument("--repeats", type=int, default=0,
                    help="print this many plain and remat steps under cuDNN's default algorithms")
    ap.add_argument("--sgd", action="store_true", help="SGD at lr 1 (generator) and 1e-4 (critic)")
    ap.add_argument("--anomaly", action="store_true", help="under autograd's anomaly detection")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("highres_smoke needs a CUDA device")
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    if not args.repeats:
        remat_step_card(card)
        return 0
    inputs = _remat_inputs(torch.device("cuda"))
    first = None
    for i in range(args.repeats):
        for remat in (False, True):
            r = remat_step_run(inputs, remat, False, sgd=args.sgd, anomaly=args.anomaly)
            grads = {net: max(float(v.abs().max()) for k, v in r["grads"].items() if k[0] == net)
                     for net in "GD"}
            line = (f"{'remat' if remat else 'plain'} {i}: max|g| G {grads['G']:.4g} D {grads['D']:.4g}, "
                    f"D_loss {r['metrics'].get('D_loss', float('nan')):.6g}, gan_loss "
                    f"{r['metrics'].get('gan_loss', float('nan')):.6g}, non-finite {r['nonfinite'][:6]}")
            if r["error"]:
                line += f", anomaly: {r['error']}"
            elif first is None:
                first = r
            else:
                line += f"; against plain 0: {_fmt(step_difference(first, r))}"
            print(line + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
