"""The two-stage pretrain -> fine-tune workflow at full width on the card,
which ``chip_smoke.py`` runs.

The configuration of the JAX package's quality run
(``tools/quality_run.py:280-290, 345-350, 386-387``): 384 x 384, pad 320
(a 1024 x 1024 grid), filter 0.45, batch 4, UNet base 64, lr 1e-3, alpha
1e-3, beta 1e-5, checkpoint intervals 5 (stage 1) and 10 (stage 2), on 8
seeded random samples (validation: the first 4 of all-zero bins):

  1. ``train_rgbd2ap``: 2 epochs of 2 steps, each with a validation batch,
     written as ``rgbd2ap.msgpack``; no ASM kernel launches;
  2. ``train_ap2poh``: the same, written as ``ap2poh.msgpack``; K1
     ``conj_h`` once a step (AP2POH's backward ASM), K3 twelve times a
     train step (the low-pass's and the spectrum loss's ``fft2`` and
     ``ifft2``, the latter two's adjoints in the backward) and eight times
     an eval step; no K2 (K1's input is data);
  3. ``training_model --use_gan --perceptual random --pretrained_part1
     rgbd2ap.msgpack --pretrained_part2 ap2poh.msgpack --freeze_part1
     --resume_dir R`` for 1 epoch, then the same command to 2 epochs,
     which resumes from R; then an uninterrupted 2-epoch run beside it.

It holds each run's kernel launches, by mode, to what the code makes;
part 1's parameters bit for bit to the stage-1 file's after both runs; the
full state restored from R bit for bit to the state the first run saved;
and the resumed run's parameters to the uninterrupted run's within
:data:`RESUME_PARAM_ATOL` (cuDNN's backward is not bitwise deterministic
on the card; the CPU tests hold resume bit for bit).  It prints each
stage's steps/s (host clock, 2 epochs of 2 steps after the run, no
validation) and peak memory beside the card's name.
"""

from __future__ import annotations

import collections
import os
import tempfile
import time

import numpy as np
import torch

ROWS = COLS = 384
PAD = 320
FRC = 0.45
BATCH, BASE, LR, ALPHA, BETA = 4, 64, 1e-3, 1e-3, 1e-5
STAGE1_INTERVAL, STAGE2_INTERVAL = 5, 10  # tools/quality_run.py:289, :349
EPOCHS, STEPS, VAL_SAMPLES = 2, 2, 4  # a stage: 2 epochs of 2 steps, one validation batch each
RATIO = 5  # the fine-tune CLI's critic updates a step (trainingModel.py's 5)
# Adam moves a parameter by about lr an update, and by +-lr with the sign
# of rounding noise where its gradient is 0 but for rounding (a conv bias
# in front of a train-mode BatchNorm); cuDNN's backward rounds differently
# from run to run, so two 2-epoch runs (4 steps: 4 generator updates, 4 x 5
# critic updates) stay within 2 lr an update of each other
RESUME_PARAM_ATOL = dict(generator=2 * LR * 2 * STEPS, discriminator=2 * LR * RATIO * 2 * STEPS)


def _counts():
    from .ops.cuda import fft, spectral

    return dict(k1=dict(spectral.row_pass.launches_by_mode),
                k2=dict(spectral.row_adjoint.launches_by_mode), k3=fft.fft_axis.launches)


def _reset_counts():
    from .ops.cuda import fft, spectral

    spectral.reset_launch_counts()
    fft.fft_axis.launches = 0


def expected_stage_launches(stage: int) -> dict:
    """The launches a stage's run makes: EPOCHS epochs of STEPS train steps
    and one eval step each (see the module docstring)."""
    if stage == 1:
        return dict(k1={}, k2={}, k3=0)
    from .card_check import STAGE2_K3_PER_STEP

    evals = EPOCHS  # one validation batch an epoch
    return dict(k1={"conj_h": EPOCHS * STEPS + evals}, k2={},
                k3=EPOCHS * STEPS * STAGE2_K3_PER_STEP + evals * (STAGE2_K3_PER_STEP - 4))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _loaders(dataset, val_dataset, device):
    from .data import epoch_loader

    epoch = [0]

    def train():
        epoch[0] += 1
        return epoch_loader(dataset, BATCH, shuffle=True, drop_last=True, seed=epoch[0], device=device)

    def val():
        return epoch_loader(val_dataset, BATCH, shuffle=False, drop_last=False, device=device)

    return train, val


def _stage(card, device, label, run, expected):
    """Run a stage with the counters reset just before and read just after,
    hold its launches to ``expected``, then time 2 more epochs of its
    steps (no validation) on the trained model: steps/s and peak memory."""
    _sync(device)
    _reset_counts()
    start = time.perf_counter()
    hist = run(EPOCHS, True)
    _sync(device)
    wall = time.perf_counter() - start
    launches = _counts()
    print(f"{label}: {EPOCHS} epochs of {STEPS} steps + validation in {wall:.2f} s (first call "
          f"included); train loss {hist[0]}, validation loss {hist[1]}; launches {launches} [{card}]",
          flush=True)
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches}, want {expected}")
    if not np.isfinite(hist[0] + hist[1]).all():
        raise AssertionError(f"{label}: non-finite loss {hist}")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    run(EPOCHS, False)
    _sync(device)
    steps_s = EPOCHS * STEPS / (time.perf_counter() - start)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    print(f"{label}: {steps_s:.3f} steps/s (host clock, {EPOCHS * STEPS} steps, batch {BATCH}), peak "
          f"memory {peak:.2f} GiB [{card}]", flush=True)
    return dict(launches=launches, steps_per_s=steps_s, peak_gib=peak)


def _fine_tune_argv(tmp, data_argv, stage_paths, resume_dir, epochs, device):
    out = os.path.join(tmp, f"out_{os.path.basename(resume_dir)}_{epochs}")
    return data_argv + [
        "--samplesNum", "8", "--channlesNum", "3", "--height", str(ROWS), "--width", str(COLS),
        "--batch_size", str(BATCH), "--epoch_num", str(epochs), "--lr_G", str(LR), "--lr_D", str(LR),
        "--unet_base_features", str(BASE),
        "--save_path_G", os.path.join(out, "G.msgpack"), "--save_path_D", os.path.join(out, "D.msgpack"),
        "--loss_metrics_file", os.path.join(out, "history.json"),
        "--save_path_img", os.path.join(out, "imgs"), "--use_gan", "--perceptual", "random",
        "--pretrained_part1", stage_paths[0], "--pretrained_part2", stage_paths[1], "--freeze_part1",
        "--device", str(device),
    ] + (["--resume_dir", resume_dir] if resume_dir else [])


def _fine_tune(card, device, label, argv, steps, epochs):
    """One ``training_model.main`` run, its launches held to what the code
    makes for ``steps`` steps and ``epochs`` end-of-epoch visualizations."""
    from . import training_model
    from .train_smoke import expected_launches

    _sync(device)
    _reset_counts()
    start = time.perf_counter()
    trainer, _ = training_model.main(argv)
    _sync(device)
    wall = time.perf_counter() - start
    launches = _counts()
    want, _ = expected_launches(False, freeze_part1=True, steps=steps, visualizations=epochs)
    print(f"{label}: {wall:.2f} s, step {trainer.state.step}; launches {launches} [{card}]", flush=True)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    return trainer


def _state_tensors(state) -> dict:
    out = {f"G.{k}": v for k, v in state.generator.state_dict().items()}
    out |= {f"D.{k}": v for k, v in state.discriminator.state_dict().items()}
    for name, opt in (("opt_G", state.opt_G), ("opt_D", state.opt_D)):
        for i, s in opt.state_dict()["state"].items():
            out |= {f"{name}.{i}.{k}": v for k, v in s.items()}
    out["rng"] = state.rng.get_state()
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def workflow(card, device="cuda"):
    """The three stages on ``device``; returns their steps/s, peak memory
    and launches and the resume check's numbers."""
    from .config import GeneratorConfig
    from .data import AmpPhsDataset, ImgDepthAmpPhsDataset
    from .models import AP2POH, RGBD2AP, make_generator_plan
    from .nn.blocks import init_weights
    from .train import checkpoint as ckpt_lib
    from .train.pretrain import train_ap2poh, train_rgbd2ap
    from .train_smoke import _write_bins

    with tempfile.TemporaryDirectory(prefix="pretrain_smoke_") as tmp:
        data_argv, train_paths = _write_bins(tmp)
        val_paths = [data_argv[i + 1] for i in range(2, 16, 4)]  # the validation bins
        ds1 = ImgDepthAmpPhsDataset(*train_paths, 8, 3, ROWS, COLS)
        val1 = ImgDepthAmpPhsDataset(*val_paths, VAL_SAMPLES, 3, ROWS, COLS)
        ds2 = AmpPhsDataset(*train_paths[2:], 8, 3, ROWS, COLS)
        val2 = AmpPhsDataset(*val_paths[2:], VAL_SAMPLES, 3, ROWS, COLS)
        stage_paths = [os.path.join(tmp, "rgbd2ap.msgpack"), os.path.join(tmp, "ap2poh.msgpack")]

        model1 = RGBD2AP(base_features=BASE)
        init_weights(model1, torch.Generator().manual_seed(1))
        model1.to(device)
        train1, v1 = _loaders(ds1, val1, device)

        def stage1(epochs, main):
            _, th, vh = train_rgbd2ap(model1, train1, v1 if main else lambda: iter(()), epochs=epochs,
                                      lr=LR, alpha=ALPHA, save_path=stage_paths[0] if main else None,
                                      checkpoint_iterval=STAGE1_INTERVAL)
            return th, vh

        out = dict(stage1=_stage(card, device, "stage 1 (train_rgbd2ap)", stage1, expected_stage_launches(1)))
        # the fine-tune starts from the file; the timing epochs moved the model
        part1 = RGBD2AP(base_features=BASE)
        ckpt_lib.load_weights(stage_paths[0], part1)
        part1 = {k: v.clone() for k, v in part1.state_dict().items()}
        del model1

        cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=FRC)
        plan = make_generator_plan(cfg, device=device)
        model2 = AP2POH()
        init_weights(model2, torch.Generator().manual_seed(2))
        model2.to(device)
        train2, v2 = _loaders(ds2, val2, device)

        def stage2(epochs, main):
            _, th, vh = train_ap2poh(model2, plan, train2, v2 if main else lambda: iter(()),
                                     filter_radius_coefficient=FRC, epochs=epochs, lr=LR, alpha=ALPHA,
                                     beta=BETA, save_path=stage_paths[1] if main else None,
                                     checkpoint_iterval=STAGE2_INTERVAL)
            return th, vh

        out["stage2"] = _stage(card, device, "stage 2 (train_ap2poh)", stage2, expected_stage_launches(2))
        del model2

        resume_dir = os.path.join(tmp, "resume")
        first = _fine_tune(card, device, "fine-tune, 1 epoch into --resume_dir",
                           _fine_tune_argv(tmp, data_argv, stage_paths, resume_dir, 1, device), STEPS, 1)
        saved = _state_tensors(first.state)
        # the state restored from the checkpoint, into the trainer's own state
        ckpt_lib.restore_latest(resume_dir, first.state)
        restored = _state_tensors(first.state)
        bad = [k for k in saved if not torch.equal(saved[k], restored[k])]
        if bad or set(saved) != set(restored) or first.state.step != STEPS:
            raise AssertionError(f"restored state differs from the saved one in {bad}")
        del first, saved, restored

        resumed = _fine_tune(card, device, "fine-tune, resumed to 2 epochs",
                             _fine_tune_argv(tmp, data_argv, stage_paths, resume_dir, 2, device), STEPS, 1)
        whole = _fine_tune(card, device, "fine-tune, 2 epochs uninterrupted",
                           _fine_tune_argv(tmp, data_argv, stage_paths, "", 2, device), 2 * STEPS, 2)

        diffs = collections.OrderedDict()
        for trainer in (resumed, whole):
            got = {k: v.detach().cpu() for k, v in trainer.state.generator.part1.state_dict().items()}
            moved = [k for k, _ in trainer.state.generator.part1.named_parameters()
                     if not torch.equal(got[k], part1[k])]
            if moved:
                raise AssertionError(f"--freeze_part1 moved part 1's {moved}")
        for net in ("generator", "discriminator"):
            a = dict(getattr(resumed.state, net).named_parameters())
            b = dict(getattr(whole.state, net).named_parameters())
            diffs[net] = max(float((a[k] - b[k]).detach().abs().max()) for k in a)
        same_rng = torch.equal(resumed.state.rng.get_state(), whole.state.rng.get_state())
        print(f"fine-tune: resumed against uninterrupted, step {resumed.state.step} / "
              f"{whole.state.step}; draws' generator state equal {same_rng}; max |param diff| "
              + ", ".join(f"{k} {v:.3e} (bound {RESUME_PARAM_ATOL[k]:g})" for k, v in diffs.items())
              + f"; part 1 bit-identical to the stage-1 file in both [{card}]", flush=True)
        if resumed.state.step != whole.state.step or not same_rng:
            raise AssertionError("the resumed run did not take the uninterrupted run's steps and draws")
        if not all(v <= RESUME_PARAM_ATOL[k] for k, v in diffs.items()):
            raise AssertionError(f"resumed run's parameters off the uninterrupted run's: {diffs}")
        out["resume_param_diff"] = dict(diffs)
        del resumed, whole
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out
