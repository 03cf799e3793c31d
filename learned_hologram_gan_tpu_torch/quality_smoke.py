"""The config-of-record workflow tools on the card, which ``chip_smoke.py``
runs as its phase 16.

At the config of record (``tools/quality_run.py``'s defaults: 384 x 384, pad
320, a 1024 x 1024 grid, UNet base 64, batch 4, 20 planes over [-0.4, 0)
mm, ratio 5, lambda 10, bfloat16, perceptual ``random``) on a synthetic set
of 8 train and 4 validation samples from ``make_synthetic_dataset`` (2
steps an epoch):

  1. ``quality_run``: stage 1, stage 2 and the GAN stage for 1 epoch each
     (``--skip_eval``); then ``--skip_stage1 --skip_stage2 --gan_epochs 2
     --start_epoch 1`` into the same ``--out``, which resumes and evaluates;
     then one GAN epoch under ``--streaming --data_dtype bfloat16`` and one
     workflow under ``--resident_shards 2`` (1-epoch stages), each in a
     fresh ``--out`` and evaluated.  Each run's K1 (by mode), K2 and K3
     launches are held to what the code makes, its wall time and each
     stage's peak memory printed; the rotating run's allocated memory shows
     the shard and stage 2's copy never resident together;
  2. ``ablation_run``: the seven variants, 1 epoch each from step 1's
     parts, one call a variant into one ``--out`` (so ``ordering.json`` is
     aggregated from the summaries on disk), launches held, wall times;
  3. ``quality_run`` at 32 x 32 (pad 16, a 64 x 64 grid), base 4, float32,
     1 epoch a stage, on the card and on the CPU from the same seeded
     initial weights and data: the stage histories and the first GAN
     step's losses (from the same part files) within the step gate (2e-3
     relative), one generator's evaluation PSNR within 1e-3 dB;
  4. ``convert_reference_weights`` on a synthesized reference generator
     ``state_dict``, then ``generate_poh --model_path`` from the file on the
     card and on the CPU (the POH within card_check's phasor bounds);
     ``warming_up_asm --quick``, ``warming_up_aperture`` and
     ``warming_up_resnet`` on the card.

Every evaluation summary must be finite with 20 per-plane PSNRs.  Nothing
here catches a failure.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROWS = COLS = 384
TRAIN, VAL, BATCH, PLANES = 8, 4, 4, 20
STEPS = TRAIN // BATCH
VAL_BATCHES = VAL // 2  # the tool's validation batch at batch 4 is 2
EVAL_RECONS = VAL // 4 + 3  # eval_quality: one batch of 4, then the grids of samples 0, 1, 2
ABLATION_EVAL_RECONS = VAL // 4 + 1  # --samples 0
SHARD_BYTES = TRAIN // 2 * 10 * ROWS * COLS * 4  # (rgbd, amp, phs01) of 4 samples, float32
VIEW_BYTES = TRAIN * 6 * ROWS * COLS * 4  # (amp, phs01) of every sample
MEMORY_ATOL = 2**20
SMALL = dict(rows=32, pad=16, base=4)
LOSS_RTOL, PSNR_ATOL = 2e-3, 1e-3  # PERF.md §2: a step's losses; the summary PSNR


def _sync():
    torch.cuda.synchronize()


def _add(*launches: dict) -> dict:
    """The sum of launch records {k1: {mode: n}, k2: {mode: n}, k3: n},
    modes with no launch left out (as the counters leave them)."""
    out = dict(k1={}, k2={}, k3=0)
    for r in launches:
        for k in ("k1", "k2"):
            for mode, n in r[k].items():
                if n:
                    out[k][mode] = out[k].get(mode, 0) + n
        out["k3"] += r["k3"]
    return out


def expected_stage2(steps: int, evals: int) -> dict:
    """Stage 2's launches (pretrain_smoke's count): K1 conj_h once a train
    or eval step, K3 twelve times a train step and eight times an eval step."""
    from .card_check import STAGE2_K3_PER_STEP

    return dict(k1={"conj_h": steps + evals}, k2={},
                k3=steps * STAGE2_K3_PER_STEP + evals * (STAGE2_K3_PER_STEP - 4))


def expected_gan(steps: int, visualizations: int) -> dict:
    """The GAN stage's launches: the default train step's (train_smoke) and
    the end-of-epoch visualizations (AP2POH, then the POH at 1 mm); no
    in-train validation (its interval is 50 steps)."""
    from .train_smoke import expected_launches

    return expected_launches(False, steps=steps, visualizations=visualizations)[0]


def expected_eval(recons: int) -> dict:
    from .highres_smoke import expected_eval_launches

    return expected_eval_launches(recons, PLANES, sequential=False)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _check_summary(label: str, evaluation: dict) -> dict:
    s = evaluation["summary"]
    values = [s["val_PSNR"], s["val_SSIM"], *s["per_plane_PSNR"]]
    if len(s["per_plane_PSNR"]) != PLANES or not np.isfinite(values).all():
        raise AssertionError(f"{label}: evaluation summary not finite with {PLANES} planes: {s}")
    return s


def _run_tool(card, label, main, argv, expected):
    """One in-process tool run with the launch counters reset just before
    and read just after; the launches held to ``expected``.  Returns the
    tool's result, its stdout, wall time and launches."""
    from .pretrain_smoke import _counts, _reset_counts

    _sync()
    _reset_counts()
    tee = _Tee(sys.stdout)
    start = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = main(argv + ["--device", "cuda"])
    _sync()
    wall = time.perf_counter() - start
    launches = _counts()
    print(f"{label}: {wall:.2f} s wall; launches {launches} [{card}]", flush=True)
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches}, want {expected}")
    return dict(result=result, stdout=tee.buf.getvalue(), wall_s=wall, launches=launches)


def quality_runs(card, data, tmp) -> dict:
    """Step 1: the four quality_run calls; returns each run's record."""
    from .tools import quality_run

    common = ["--data", data, "--train_num", str(TRAIN), "--val_num", str(VAL)]
    q = os.path.join(tmp, "quality_run")
    runs = {}

    r = _run_tool(card, "quality_run: stage 1, stage 2, GAN, 1 epoch each", quality_run.main,
                  common + ["--out", q, "--stage1_epochs", "1", "--stage2_epochs", "1", "--gan_epochs", "1",
                            "--skip_eval"],
                  _add(expected_stage2(STEPS, VAL_BATCHES), expected_gan(STEPS, 1)))
    hist = r["result"]["histories"]
    for stage in ("stage1", "stage2"):
        if not np.isfinite(hist[stage]["train"] + hist[stage]["val"]).all():
            raise AssertionError(f"quality_run {stage}: non-finite history {hist[stage]}")
    for name in ("rgbd2ap.msgpack", "ap2poh.msgpack", "generator.msgpack", "resume"):
        if not os.path.exists(os.path.join(q, name)):
            raise AssertionError(f"quality_run wrote no {name}")
    runs["stages"] = r

    r = _run_tool(card, "quality_run: --start_epoch 1 --gan_epochs 2 (resumes), then eval_quality",
                  quality_run.main,
                  common + ["--out", q, "--skip_stage1", "--skip_stage2", "--gan_epochs", "2", "--start_epoch", "1"],
                  _add(expected_gan(STEPS, 0), expected_eval(EVAL_RECONS)))
    if "Resumed training" not in r["stdout"]:
        raise AssertionError("the chunked GAN run did not resume")
    r["summary"] = _check_summary("resumed run", r["result"]["evaluation"])
    runs["resumed"] = r

    r = _run_tool(card, "quality_run --streaming --data_dtype bfloat16: GAN 1 epoch, eval_quality",
                  quality_run.main,
                  common + ["--out", os.path.join(tmp, "q_streaming"), "--skip_stage1", "--skip_stage2",
                            "--streaming", "--data_dtype", "bfloat16", "--gan_epochs", "1"],
                  _add(expected_gan(STEPS, 1), expected_eval(EVAL_RECONS)))
    r["summary"] = _check_summary("streaming run", r["result"]["evaluation"])
    runs["streaming"] = r

    # two shards of 4: stage 1 and the GAN stage take 1 step an epoch, stage
    # 2 (every sample's amp/phs resident) 2
    r = _run_tool(card, "quality_run --resident_shards 2: 1-epoch stages, eval_quality", quality_run.main,
                  common + ["--out", os.path.join(tmp, "q_shards"), "--resident_shards", "2",
                            "--stage1_epochs", "1", "--stage2_epochs", "1", "--gan_epochs", "1"],
                  _add(expected_stage2(STEPS, VAL_BATCHES), expected_gan(1, 1), expected_eval(EVAL_RECONS)))
    r["summary"] = _check_summary("rotating-shard run", r["result"]["evaluation"])
    marks = dict(r["result"]["memory"]["allocated_gib"])
    moves = {
        "evicting the shard": (marks["stage2 shard evicted"] - marks["stage2 before evicting the shard"],
                               -SHARD_BYTES),
        "stage 2's amp/phs upload": (marks["stage2 start"] - marks["stage2 shard evicted"], VIEW_BYTES),
        "freeing stage 2's copy": (marks["gan start"] - marks["gan before freeing stage 2's copy"], -VIEW_BYTES),
    }
    print("rotating shards, allocated memory: " + "; ".join(
        f"{k} {v * 2**30 / 1e6:+.2f} MB (the data's {want / 1e6:+.2f})" for k, (v, want) in moves.items())
        + f" [{card}]", flush=True)
    for k, (v, want) in moves.items():
        if abs(v * 2**30 - want) > MEMORY_ATOL:
            raise AssertionError(f"rotating shards: {k} moved {v * 2**30:.0f} bytes, want {want}")
    runs["shards"] = r

    for label, r in runs.items():
        mem = r["result"]["memory"]
        print(f"quality_run {label}: {r['wall_s']:.2f} s wall; timings "
              + ", ".join(f"{k} {v:.2f} s" for k, v in r["result"]["timings"].items())
              + "; peak memory " + ", ".join(f"{k} {v:.2f} GiB" for k, v in mem["peak_gib"].items())
              + f" [{card}]", flush=True)
    return runs


def ablations(card, data, parts, tmp) -> dict:
    """Step 2: every variant in its own call into one ``--out``."""
    from .tools import ablation_run

    out = os.path.join(tmp, "ablations")
    # no visualization (no image directory) and no in-train validation
    per_variant = _add(expected_gan(STEPS, 0), expected_eval(ABLATION_EVAL_RECONS))
    runs = {}
    for name in ablation_run.VARIANTS:
        runs[name] = _run_tool(card, f"ablation_run {name}, 1 epoch", ablation_run.main,
                               ["--data", data, "--parts", parts, "--out", out, "--epochs", "1",
                                "--train_num", str(TRAIN), "--val_num", str(VAL), "--variants", name],
                               per_variant)
        s = runs[name]["result"]["ordering"][name]
        if not np.isfinite([s["val_PSNR"], s["val_SSIM"]]).all():
            raise AssertionError(f"ablation {name}: non-finite summary {s}")
        _check_summary(f"ablation {name}", dict(summary=_read_json(os.path.join(out, name, "eval",
                                                                               "summary.json"))))
        print(f"ablation {name}: train {runs[name]['result']['runs'][name]['train_s']:.2f} s, eval "
              f"{runs[name]['result']['runs'][name]['eval_s']:.2f} s, PSNR {s['val_PSNR']:.3f} dB, "
              f"SSIM {s['val_SSIM']:.4f} [{card}]", flush=True)
    ordering = _read_json(os.path.join(out, "ordering.json"))
    if sorted(ordering) != sorted(ablation_run.VARIANTS):
        raise AssertionError(f"ordering.json lists {sorted(ordering)}, want all seven variants")
    return runs


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def small_card_vs_cpu(card, tmp) -> dict:
    """Step 3: quality_run at 32^2 on the card and on the CPU.  Stages 1 and
    2 from the same seeded initial weights and data: their histories within
    the step gate.  The GAN stage then starts on both from the same part
    files (the CPU's): its first step's losses (``--info_interval 1``)
    within the step gate; the first step moves every Adam parameter by
    +-lr, with the sign of gradients that are rounding noise (a conv bias
    in front of a train-mode BatchNorm) drawn differently on each side, so
    the later entries are printed and not gated.  Last, the CPU run's
    generator evaluated on both: the summary PSNR within 1e-3 dB."""
    import shutil

    from .tools import eval_quality, make_synthetic_dataset, quality_run

    rows, pad, base = SMALL["rows"], SMALL["pad"], SMALL["base"]
    data = os.path.join(tmp, "synth_small")
    make_synthetic_dataset.main(["--out", data, "--rows", str(rows), "--cols", str(rows), "--pad_size", str(pad),
                                 "--train_num", str(TRAIN), "--val_num", str(VAL), "--device", "cpu"])
    size = ["--data", data, "--rows", str(rows), "--cols", str(rows), "--pad_size", str(pad),
            "--unet_base_features", str(base), "--dtype", "float32", "--val_num", str(VAL)]
    stages = size + ["--train_num", str(TRAIN), "--stage1_epochs", "1", "--stage2_epochs", "1", "--skip_gan",
                     "--skip_eval"]
    gan = size + ["--train_num", str(TRAIN), "--skip_stage1", "--skip_stage2", "--gan_epochs", "1",
                  "--info_interval", "1", "--skip_eval"]
    got, worst = {}, {}
    for device in ("cpu", "cuda"):
        start = time.perf_counter()
        stages_out, gan_out = os.path.join(tmp, f"small_stages_{device}"), os.path.join(tmp, f"small_gan_{device}")
        got[device] = quality_run.main(stages + ["--out", stages_out, "--device", device])["histories"]
        os.makedirs(gan_out)
        for name in ("rgbd2ap.msgpack", "ap2poh.msgpack"):
            shutil.copy(os.path.join(tmp, "small_stages_cpu", name), gan_out)
        got[device]["gan"] = quality_run.main(gan + ["--out", gan_out, "--device", device])["histories"]["gan"]
        print(f"quality_run at {rows}^2, base {base}, float32 on {device}: {time.perf_counter() - start:.2f} s",
              flush=True)
    for stage in ("stage1", "stage2"):
        for split in ("train", "val"):
            a, b = np.asarray(got["cuda"][stage][split]), np.asarray(got["cpu"][stage][split])
            worst[f"{stage} {split}"] = float(np.max(np.abs(a - b) / np.abs(b)))
    later = {}
    # gan_loss, minus the critic's mean score of the fakes, is a mean of
    # scores of both signs near 0: its relative difference measures that
    # cancellation; it is held through G_loss, which it enters weighted 0.1
    for k, b in got["cpu"]["gan"]["train_losses_tensor"].items():
        a, b = np.asarray(got["cuda"]["gan"]["train_losses_tensor"][k]), np.asarray(b)
        if len(a) != STEPS or len(b) != STEPS:
            raise AssertionError(f"GAN history {k}: {len(a)} and {len(b)} entries, want {STEPS}")
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
        (later if k == "gan_loss" else worst)[f"gan step 1 {k}"] = float(rel[0])
        later[f"gan step 2 {k}"] = float(rel[1])
    evals = {}
    for device in ("cpu", "cuda"):
        evals[device] = _check_summary(f"small evaluation on {device}", eval_quality.main(
            size + ["--run_dir", os.path.join(tmp, "small_gan_cpu"), "--out", os.path.join(tmp, f"small_eval_{device}"),
                    "--batch", "2", "--samples", "0", "--device", device]))
    d_psnr = abs(evals["cuda"]["val_PSNR"] - evals["cpu"]["val_PSNR"])
    print(f"quality_run at {rows}^2, card against CPU (relative): "
          + ", ".join(f"{k} {v:.2e}" for k, v in {**worst, **later}.items())
          + f"; the CPU run's generator evaluated: val PSNR {evals['cuda']['val_PSNR']:.5f} / "
          f"{evals['cpu']['val_PSNR']:.5f} dB, difference {d_psnr:.2e} (gates {LOSS_RTOL:g} on the stages and "
          f"the first GAN step, {PSNR_ATOL:g} dB) [{card}]", flush=True)
    bad = {k: v for k, v in worst.items() if not v <= LOSS_RTOL}
    if bad or not d_psnr <= PSNR_ATOL:
        raise AssertionError(f"small quality_run, card against CPU: histories {bad}, PSNR {d_psnr}")
    return dict(worst=worst, later=later, d_psnr=d_psnr)


def reference_generator_state_dict(seed: int = 0, base: int = 64) -> dict:
    """A reference Generator ``state_dict`` (the reference's key names and
    shapes, tests/test_weight_converter.py's layout) with seeded values
    scaled so that a forward pass stays well conditioned: conv weights
    N(0, 1/fan_in), BatchNorm scales near 1 and variances near 1."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    sd = {}

    def conv(prefix, cout, cin, k):
        sd[prefix + ".weight"] = randn(cout, cin, k, k, scale=(cin * k * k) ** -0.5)
        sd[prefix + ".bias"] = randn(cout, scale=0.1)

    def block(prefix, cin, cout):
        conv(prefix + ".convolution_layer_1", cout, cin, 3)
        conv(prefix + ".convolution_layer_2", cout, cout, 3)
        conv(prefix + ".convolution_layer_3", cout, cin, 1)
        for bn in (".batch_norm_layer_1", ".batch_norm_layer_2"):
            sd[prefix + bn + ".weight"] = 1.0 + randn(cout, scale=0.1)
            sd[prefix + bn + ".bias"] = randn(cout, scale=0.1)
            sd[prefix + bn + ".running_mean"] = randn(cout, scale=0.1)
            sd[prefix + bn + ".running_var"] = 1.0 + randn(cout, scale=0.1).abs()

    u = "part1.part1."
    widths = [base, 2 * base, 4 * base, 8 * base, 16 * base]
    cin = 4
    for i, cout in enumerate(widths[:4]):
        block(f"{u}encoder{i + 1}.{0 if i == 0 else 1}.0", cin, cout)
        cin = cout
    block(u + "bottleneck.1.0", widths[3], widths[4])
    sd[u + "bottleneck.2.weight"] = randn(widths[4], widths[3], 2, 2, scale=widths[4] ** -0.5)
    sd[u + "bottleneck.2.bias"] = randn(widths[3], scale=0.1)
    for j in range(1, 4):
        cin, cout = widths[5 - j], widths[4 - j]
        block(f"{u}decoder{j}.0.0", cin, cout)
        sd[f"{u}decoder{j}.1.weight"] = randn(cout, widths[3 - j], 2, 2, scale=cout ** -0.5)
        sd[f"{u}decoder{j}.1.bias"] = randn(widths[3 - j], scale=0.1)
    block(u + "decoder4.0", widths[1], widths[0])
    sd[u + "final_layer.0.weight"] = randn(6, widths[0], 1, 1, scale=widths[0] ** -0.5)
    sd[u + "final_layer.0.bias"] = randn(6, scale=0.1)
    for c in "rgb":
        sd[f"part2.part1.conv_{c}.params"] = randn(3).abs()
        sd[f"part2.part1.conv_{c}.bias"] = randn(1, scale=0.1)
    return sd


def converter_and_examples(card, tmp) -> dict:
    """Step 4: the converter's file through generate_poh on the card and the
    CPU, then the three warming-up examples on the card."""
    from . import generate_poh
    from .card_check import POH_MAX_TOL, POH_MEAN_TOL, POH_P99_TOL, poh_phasor_errors
    from .examples import warming_up_aperture, warming_up_asm, warming_up_resnet
    from .pretrain_smoke import _counts, _reset_counts
    from .tools import convert_reference_weights

    pth, model = os.path.join(tmp, "reference_G.pth"), os.path.join(tmp, "G.msgpack")
    torch.save(reference_generator_state_dict(), pth)
    convert_reference_weights.main(["--kind", "generator", "--in", pth, "--out", model])
    rows, pad = 64, 32  # a 128 x 128 grid: K1 on the card
    rng = np.random.default_rng(30)
    for name in ("img", "depth"):  # the reference's bins: 3 channels each, depth's first read
        rng.random((2, 3, rows, rows)).astype(np.float32).tofile(os.path.join(tmp, f"{name}.bin"))
    poh = {}
    for device in ("cuda", "cpu"):
        _reset_counts()
        r = generate_poh.main(["--img_path", os.path.join(tmp, "img.bin"), "--depth_path",
                               os.path.join(tmp, "depth.bin"), "--index", "1", "--model_path", model,
                               "--poh_output_path", os.path.join(tmp, f"poh_{device}.npy"), "--samplesNum", "2",
                               "--sample_row_num", str(rows), "--sample_col_num", str(rows),
                               "--pad_size", str(pad), "--device", device])
        poh[device] = r["poh"].float().cpu().numpy()
        if device == "cuda":
            launches = _counts()
    errs = poh_phasor_errors(poh["cuda"], poh["cpu"])
    print(f"convert_reference_weights -> generate_poh at {rows}^2 (pad {pad}): card launches {launches}; POH "
          f"card against CPU as phasors mean {errs[0]:.2e}, p99 {errs[1]:.2e}, max {errs[2]:.2e} (bounds "
          f"{POH_MEAN_TOL:g}, {POH_P99_TOL:g}, {POH_MAX_TOL:g}) [{card}]", flush=True)
    if not (np.isfinite(poh["cuda"]).all() and errs[0] <= POH_MEAN_TOL and errs[1] <= POH_P99_TOL
            and errs[2] <= POH_MAX_TOL):
        raise AssertionError(f"generate_poh from the converted file: card against CPU {errs}")
    if launches["k1"].get("conj_h", 0) != 1:
        raise AssertionError(f"generate_poh from the converted file: K1 launches {launches}, want conj_h 1")

    examples = {}
    for label, mod, argv, expected in (
            ("warming_up_asm --quick", warming_up_asm, ["--quick"], dict(k1={"field": 2}, k2={}, k3=0)),
            ("warming_up_aperture", warming_up_aperture, [], dict(k1={}, k2={}, k3=0)),
            ("warming_up_resnet", warming_up_resnet, [], dict(k1={}, k2={}, k3=0))):
        r = _run_tool(card, label, mod.main, argv, expected)
        if "all assertions passed" not in r["stdout"]:
            raise AssertionError(f"{label}: no 'all assertions passed' line")
        examples[label] = r
    return dict(poh_errors=errs, examples=examples)


def run(card) -> dict:
    """The phase; returns each step's records and the launches of the
    quality runs and of the ablation variants, summed."""
    from .tools import make_synthetic_dataset

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="quality_smoke_") as tmp:
        data = os.path.join(tmp, "synth384")
        t = time.perf_counter()
        make_synthetic_dataset.main(["--out", data, "--train_num", str(TRAIN), "--val_num", str(VAL),
                                     "--device", "cuda"])
        print(f"make_synthetic_dataset at 384^2, {TRAIN} + {VAL} samples: {time.perf_counter() - t:.2f} s [{card}]",
              flush=True)
        runs = quality_runs(card, data, tmp)
        abl = ablations(card, data, os.path.join(tmp, "quality_run"), tmp)
        small = small_card_vs_cpu(card, tmp)
        conv = converter_and_examples(card, tmp)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - start
    print(f"config-of-record workflow phase: {wall:.1f} s wall [{card}]", flush=True)
    return dict(quality_runs=runs, ablations=abl, small=small, converter=conv, wall_s=wall,
                quality_run_launches=_add(*(r["launches"] for r in runs.values())),
                ablation_launches=_add(*(r["launches"] for r in abl.values())))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("quality_smoke: no CUDA device")
    import subprocess

    run(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
