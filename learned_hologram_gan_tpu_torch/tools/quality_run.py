#!/usr/bin/env python
"""Config-of-record training run to hologram quality (the port's counterpart
of ``tools/quality_run.py``).

The reference's documented workflow end to end on the synthetic
physically-consistent dataset (``tools/make_synthetic_dataset.py``):

  1. stage-1 pretrain RGBD2AP   (reference RGBD2AP.train_model :52-137)
  2. stage-2 pretrain AP2POH    (reference AP2POH.train_model :118-218)
  3. full WGAN-GP fine-tune at the config of record: 384 x 384, batch 4,
     500 samples, 50 epochs, lr 1e-3/1e-3, ratio 5, lambda 10, 20-plane
     stack linspace(-4e-4, 0, 21)[:-1], loss weights (1, 0.1, 1, 1e-3, 0.1)
     (reference README.md:47-67 + trainingModel.py:59-97)
  4. evaluation: the port's ``tools/eval_quality`` in this process
     (full-val 20-plane PSNR/SSIM, per-plane curves, focal-stack grids)

The deviations from the reference objective are the JAX tool's: one 2*pi
phase scaling (``losses.amp_phs_loss``), the perceptual term from the
explicit ``random``-VGG opt-in (docs/perceptual_fallback.md), BatchNorm's
inference statistics inside the gradient penalty's inner gradient.

A stage killed part way restarts from its newest ``<stage>_epoch{k}``
file (:func:`stage_resume`); a GAN run split over processes shares
``--out`` and passes ``--start_epoch`` (``<out>/resume`` holds the full
train state).  The data stay on the device (``--resident_shards N``
rotates N shards through it), or stream from the host (``--streaming``,
stage 3 only; ``--data_dtype bfloat16`` halves the bytes copied).

The flags and defaults are the JAX tool's, plus ``--device`` (``cuda``
unless asked otherwise), except ``--out``: it defaults to
``output/quality_run_torch``, so that a run of the port never overwrites
the JAX-written weights in ``output/quality_run``::

    python -m learned_hologram_gan_tpu_torch.tools.quality_run --data data/synth384
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import GeneratorConfig
from ..data import (ImgDepthAmpPhsDataset, RotatingDeviceDataset, dataset_to_device, device_epoch_loader,
                    epoch_loader)
from ..models import AP2POH, RGBD2AP, make_generator_plan
from ..nn.blocks import compute_dtype, init_weights
from ..train import Watermelon, train_ap2poh, train_rgbd2ap
from ..train import checkpoint as ckpt_lib
from ..utils import set_seed
from . import eval_quality

SEED = 122731  # reference trainingModel.py:18
DEFAULT_OUT = "output/quality_run_torch"


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default="data/synth384")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="run directory (not the JAX tool's output/quality_run, whose files "
                         "the port's tests read)")
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--train_num", type=int, default=500)
    ap.add_argument("--val_num", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=4)   # README.md:47-67
    ap.add_argument("--val_batch", type=int, default=None,
                    help="validation batch (default min(batch_size//2, 2)): the eval step "
                         "reconstructs the full 20-plane stack per sample")
    ap.add_argument("--stage1_epochs", type=int, default=30)
    ap.add_argument("--stage2_epochs", type=int, default=20)
    ap.add_argument("--gan_epochs", type=int, default=50)  # README.md:47-67
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--data_dtype", default="float32",
                    help="device-resident dataset storage dtype (or the streamed batches' "
                         "dtype); 'bfloat16' halves the footprint")
    ap.add_argument("--perceptual", default="random")
    ap.add_argument("--remat", action="store_true",
                    help="UNet activation checkpointing (device-memory fallback)")
    ap.add_argument("--skip_stage1", action="store_true")
    ap.add_argument("--skip_stage2", action="store_true")
    ap.add_argument("--skip_gan", action="store_true")
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--pad_size", type=int, default=320,
                    help="config of record: 320 (trainingModel.py:61); shrink for CPU smoke runs")
    ap.add_argument("--num_planes", type=int, default=20,
                    help="distance-stack planes over [-4e-4, 0) (trainingModel.py:62-66)")
    ap.add_argument("--unet_base_features", type=int, default=64,
                    help="reference UNet width (shrink for CPU smoke)")
    ap.add_argument("--streaming", action="store_true",
                    help="stream batches from the host memmap instead of the device-resident "
                         "path (stage 3 only); long runs may be chunked over processes with "
                         "--start_epoch/--gan_epochs and a shared --out")
    ap.add_argument("--resident_shards", type=int, default=1,
                    help=">1: rotate the train set through device memory in N contiguous "
                         "shards (block-shuffled epochs) when it cannot sit resident next "
                         "to the train step")
    ap.add_argument("--gan_checkpoint_interval", type=int, default=10,
                    help="epochs between GAN checkpoints/resume saves")
    ap.add_argument("--info_interval", type=int, default=50,
                    help="batches between metric prints / validation passes")
    ap.add_argument("--start_epoch", type=int, default=0,
                    help="first GAN epoch of this process (chunked runs); loaders are "
                         "seed-offset and resume skips its data fast-forward")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda unless asked otherwise)")
    return ap


def make_rgbd2ap(args, device: torch.device) -> RGBD2AP:
    """Stage 1's model, seeded (the JAX tool initializes from key 0)."""
    model = RGBD2AP(base_features=args.unet_base_features, dtype=compute_dtype(args.dtype),
                    remat=args.remat)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device)


def make_ap2poh(args, device: torch.device) -> AP2POH:
    """Stage 2's model, seeded."""
    model = AP2POH(kernel_size=3, dtype=compute_dtype(args.dtype))
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device)


def stage_resume(path: str, total_epochs: int, model: torch.nn.Module, epoch_seed: List[int]) -> int:
    """Wedge-recovery resume for a pretrain stage; returns the epochs that
    remain.

    A killed stage restarts as a fresh process; the newest (by mtime)
    ``<path>_epoch{k}`` checkpoint lets it continue from the last saved
    epoch (loaded into ``model``).  Cumulative progress lives in a
    ``<path>.done`` sidecar because each restarted run numbers its epoch
    files from 0 again; this run's epoch files are deleted so the next
    resume counts afresh, and ``epoch_seed`` moves past the epochs done.
    A stage already complete is skipped, and its final file is not
    overwritten.  Optimizer and scheduler state restart, as the reference's
    pretrained_model_path reload does.
    """
    root, ext = os.path.splitext(path)
    done_path = root + ".done"
    done = 0
    if os.path.exists(done_path):
        with open(done_path) as f:
            done = json.load(f)["done"]
    newest = None
    for k in range(total_epochs):
        p = f"{root}_epoch{k}{ext}"
        if os.path.exists(p):
            if newest is None or os.path.getmtime(p) > newest[2]:
                newest = (k, p, os.path.getmtime(p))
    if done >= total_epochs:
        log(f"{path}: already complete ({done} epochs), skipping")
        return 0
    if newest is None:
        return total_epochs
    k, p, _ = newest
    done += k + 1
    with open(done_path, "w") as f:
        json.dump({"done": done}, f)
    ckpt_lib.load_weights(p, model)
    for j in range(total_epochs):
        q = f"{root}_epoch{j}{ext}"
        if os.path.exists(q):
            os.remove(q)
    epoch_seed[0] += k + 1
    log(f"resuming {path} after {done} done epochs ({max(total_epochs - done, 0)} remain)")
    return max(total_epochs - done, 0)


class _AmpPhsView:
    """(amp, phs01) of each sample of an ImgDepthAmpPhsDataset: what stage 2
    keeps resident when the whole set cannot be."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self) -> int:
        return len(self._dataset)

    def get(self, i: int):
        _, amp, phs01 = self._dataset.get(i)
        return (amp, phs01)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the workflow on ``argv``; returns the wall times (``timings``,
    also written to ``timings.json``), the device memory (``memory``; None
    on the CPU): each stage's peak (``peak_gib``) and the memory allocated
    at each stage's start and around the rotating route's swaps
    (``allocated_gib``, (label, GiB) in order), the stage histories and the
    evaluation's result (:func:`eval_quality.main`; None with
    ``--skip_eval``)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but no CUDA device is available")
    if args.streaming and not (args.skip_stage1 and args.skip_stage2):
        raise SystemExit("--streaming supports stage 3 only: run/skip the pretrain stages with the "
                         "device-resident path (they fit device memory at any supported batch).")
    if args.val_batch is None:
        args.val_batch = min(max(args.batch_size // 2, 1), 2)
    on_card = device.type == "cuda"

    os.makedirs(args.out, exist_ok=True)
    stage1_path = os.path.join(args.out, "rgbd2ap.msgpack")
    stage2_path = os.path.join(args.out, "ap2poh.msgpack")
    t_all = time.time()
    timings, histories = {}, {}
    memory = dict(allocated_gib=[], peak_gib={})

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def allocated(label: str) -> None:
        """Record the device memory allocated now under ``label``."""
        if on_card:
            sync()
            memory["allocated_gib"].append((label, torch.cuda.memory_allocated(device) / 2**30))

    def memory_mark(stage: str) -> None:
        """Start a stage's memory record: what is allocated now, and the
        peak from here on."""
        if on_card:
            allocated(f"{stage} start")
            torch.cuda.reset_peak_memory_stats(device)

    def memory_peak(stage: str) -> None:
        if on_card:
            sync()
            memory["peak_gib"][stage] = torch.cuda.max_memory_allocated(device) / 2**30
            start = dict(memory["allocated_gib"])[f"{stage} start"]
            log(f"{stage}: {start:.3f} GiB allocated at its start, peak {memory['peak_gib'][stage]:.3f} GiB")

    set_seed(SEED)
    data_dtype = torch.bfloat16 if args.data_dtype == "bfloat16" else None

    def paths(split):
        return dict(img_path=f"{args.data}/{split}/img.bin", depth_path=f"{args.data}/{split}/depth.bin",
                    amp_path=f"{args.data}/{split}/amp.bin", phs_path=f"{args.data}/{split}/phs.bin")

    common = dict(channels_num=3, height=args.rows, width=args.cols)
    ds_train = ImgDepthAmpPhsDataset(samples_num=args.train_num, **paths("train"), **common)
    ds_val = ImgDepthAmpPhsDataset(samples_num=args.val_num, **paths("val"), **common)

    epoch_seed = [SEED + args.start_epoch]
    if args.streaming:
        dev_train, dev_val = ds_train, ds_val  # loader sources

        def train_batches(ds, batch, start_epoch=0) -> Callable:  # streaming epochs are seed-offset
            def fn():
                epoch_seed[0] += 1
                return epoch_loader(ds, batch, shuffle=True, drop_last=True, seed=epoch_seed[0],
                                    dtype=data_dtype, device=device)
            return fn

        def val_batches(ds, batch) -> Callable:
            return lambda: epoch_loader(ds, batch, shuffle=False, drop_last=False, dtype=data_dtype,
                                        device=device)

        viz_sample = tuple(np.asarray(a) for a in ds_val.get(0))
    else:
        if args.resident_shards > 1:
            dev_train = RotatingDeviceDataset(ds_train, shards=args.resident_shards, dtype=data_dtype,
                                              device=device)
        else:
            dev_train = dataset_to_device(ds_train, dtype=data_dtype, device=device)  # (rgbd, amp, phs01)
        dev_val = dataset_to_device(ds_val, dtype=data_dtype, device=device)

        def train_batches(source, batch, start_epoch=0) -> Callable:
            counter = [start_epoch]

            def fn():
                epoch_seed[0] += 1
                e = counter[0]
                counter[0] += 1
                if isinstance(source, RotatingDeviceDataset):
                    return source.epoch_loader(batch, e, shuffle=True, drop_last=True, seed=epoch_seed[0])
                return device_epoch_loader(source, batch, shuffle=True, drop_last=True, seed=epoch_seed[0])
            return fn

        def val_batches(arrays, batch) -> Callable:
            return lambda: device_epoch_loader(arrays, batch, shuffle=False, drop_last=False)

        # a host copy: the trainer's visualization reads it as an array
        viz_sample = tuple(a[0].float().cpu().numpy() for a in dev_val)

    # ------------------------------------------------------------------
    # stage 1: RGBD2AP pretrain
    # ------------------------------------------------------------------
    if not args.skip_stage1:
        log(f"stage 1: RGBD2AP pretrain, {args.stage1_epochs} epochs")
        memory_mark("stage1")
        t0 = time.time()
        model1 = make_rgbd2ap(args, device)
        s1_epochs = stage_resume(stage1_path, args.stage1_epochs, model1, epoch_seed)
        if s1_epochs > 0:
            _, tr_hist, val_hist = train_rgbd2ap(
                model1, train_batches(dev_train, args.batch_size), val_batches(dev_val, args.val_batch),
                epochs=s1_epochs, lr=1e-3, alpha=1e-3, save_path=stage1_path, checkpoint_iterval=5,
            )
            with open(os.path.splitext(stage1_path)[0] + ".done", "w") as f:
                json.dump({"done": args.stage1_epochs}, f)
            sync()
            timings["stage1_s"] = time.time() - t0
            histories["stage1"] = {"train": tr_hist, "val": val_hist}
            with open(os.path.join(args.out, "stage1_history.json"), "w") as f:
                json.dump(histories["stage1"], f)
            if val_hist:
                log(f"stage 1 done in {timings['stage1_s']:.0f}s: val {val_hist[0]:.5f} -> {val_hist[-1]:.5f}")
        memory_peak("stage1")
        del model1

    # ------------------------------------------------------------------
    # stage 2: AP2POH pretrain
    # ------------------------------------------------------------------
    dev2_train = None
    if not args.skip_stage2:
        log(f"stage 2: AP2POH pretrain, {args.stage2_epochs} epochs")
        t0 = time.time()
        cfg = GeneratorConfig(rows=args.rows, cols=args.cols, pad_size=args.pad_size,
                              filter_radius_coefficient=0.45, dtype=args.dtype)
        plan = make_generator_plan(cfg, device=device)
        # AmpPhsDataset semantics from the resident stage-1 tensors: (amp,
        # 2*pi*phs01), scaled per batch (reference data_loader.py:83), never
        # as a scaled copy of the whole resident phase field
        if args.resident_shards <= 1:
            dev2_train = (dev_train[1], dev_train[2])
        else:
            # rotating residency: stage 2 needs only (amp, phs01), which fit
            # resident in full; the rotating shard goes first, so the two
            # never coexist on the device
            allocated("stage2 before evicting the shard")
            dev_train.evict()
            allocated("stage2 shard evicted")
            if on_card:
                torch.cuda.empty_cache()
            dev2_train = dataset_to_device(_AmpPhsView(ds_train), dtype=data_dtype, device=device)
        memory_mark("stage2")
        model2 = make_ap2poh(args, device)
        dev2_val = (dev_val[1], dev_val[2])

        def scaled(loader_fn):
            def fn():
                return ((amp, (2.0 * np.pi) * phs01) for amp, phs01 in loader_fn())
            return fn

        s2_epochs = stage_resume(stage2_path, args.stage2_epochs, model2, epoch_seed)
        if s2_epochs > 0:
            _, tr_hist, val_hist = train_ap2poh(
                model2, plan,
                scaled(train_batches(dev2_train, args.batch_size)),
                scaled(val_batches(dev2_val, args.val_batch)),
                filter_radius_coefficient=0.45,
                epochs=s2_epochs, lr=1e-3, alpha=1e-3, beta=1e-5,
                save_path=stage2_path, checkpoint_iterval=10,
            )
            with open(os.path.splitext(stage2_path)[0] + ".done", "w") as f:
                json.dump({"done": args.stage2_epochs}, f)
            sync()
            timings["stage2_s"] = time.time() - t0
            histories["stage2"] = {"train": tr_hist, "val": val_hist}
            with open(os.path.join(args.out, "stage2_history.json"), "w") as f:
                json.dump(histories["stage2"], f)
            if val_hist:
                log(f"stage 2 done in {timings['stage2_s']:.0f}s: val {val_hist[0]:.5f} -> {val_hist[-1]:.5f}")
        memory_peak("stage2")
        del model2, plan, dev2_val

    # ------------------------------------------------------------------
    # stage 3: full WGAN-GP fine-tune, config of record
    # ------------------------------------------------------------------
    if not args.skip_gan:
        log(f"stage 3: WGAN-GP config of record, {args.gan_epochs} epochs")
        if not args.streaming and args.resident_shards > 1 and dev2_train is not None:
            # free stage 2's full amp/phs residency before the GAN step
            # uploads its rotating shard
            allocated("gan before freeing stage 2's copy")
            dev2_train = None
            if on_card:
                torch.cuda.empty_cache()
        memory_mark("gan")
        t0 = time.time()
        trainer = Watermelon(
            filter_radius_coefficient=0.45,                   # trainingModel.py:60
            pad_size=args.pad_size,                           # :61
            distance_stack=np.linspace(-4e-4, 0.0, args.num_planes + 1)[:-1],  # :62-66
            input_shape=(args.batch_size, 4, args.rows, args.cols),
            use_gan=True,
            perceptual=args.perceptual,
            dtype=args.dtype,
            remat=args.remat,
            unet_base_features=args.unet_base_features,
            pretrained_part1_path=stage1_path if os.path.exists(stage1_path) else None,
            pretrained_part2_path=stage2_path if os.path.exists(stage2_path) else None,
            device=device,
        )
        img_dir = os.path.join(args.out, "imgs")
        os.makedirs(img_dir, exist_ok=True)
        histories["gan"] = trainer.train(
            data_loader_train=train_batches(dev_train, args.batch_size, start_epoch=args.start_epoch),
            data_loader_val=val_batches(dev_val, args.val_batch),
            phs_gradient_loss_weight=1,                       # :76-97 weights
            perceptual_loss_weight=1e-1,
            pixel_loss_weight=1,
            TV_loss_weight=1e-3,
            discriminator_loss_weight=1e-1,
            epoch_num=args.gan_epochs,
            lr_G=1e-3,
            lr_D=1e-3,
            save_path_G=os.path.join(args.out, "generator.msgpack"),
            save_path_D=os.path.join(args.out, "discriminator.msgpack"),
            info_print_interval=args.info_interval,
            info_plot_interval=250,
            loss_metrics_file=os.path.join(args.out, "history.json"),
            save_path_img=img_dir,
            checkpoint_iterval=args.gan_checkpoint_interval,
            discriminator_train_ratio=5,
            discriminator_lambda=10,
            visualization_RGBD_AP=viz_sample,
            seed=SEED,
            resume_dir=os.path.join(args.out, "resume"),
            start_epoch=args.start_epoch,
            resume_data_fast_forward=args.start_epoch == 0,
        )
        sync()
        timings["gan_s"] = time.time() - t0
        memory_peak("gan")
        log(f"stage 3 done in {timings['gan_s']:.0f}s")
        del trainer

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    evaluation = None
    if not args.skip_eval:
        log("eval: tools/eval_quality")
        del dev_train, dev_val, dev2_train
        if on_card:
            torch.cuda.empty_cache()
        memory_mark("eval")
        t0 = time.time()
        evaluation = eval_quality.main([
            "--data", args.data, "--run_dir", args.out,
            "--rows", str(args.rows), "--cols", str(args.cols),
            "--val_num", str(args.val_num), "--dtype", args.dtype,
            "--pad_size", str(args.pad_size),
            "--num_planes", str(args.num_planes),
            "--unet_base_features", str(args.unet_base_features),
            "--device", args.device,
        ])
        sync()
        timings["eval_s"] = time.time() - t0
        memory_peak("eval")

    timings["total_s"] = time.time() - t_all
    with open(os.path.join(args.out, "timings.json"), "w") as f:
        json.dump(timings, f, indent=1)
    log(f"quality run complete in {timings['total_s']:.0f}s")
    return dict(timings=timings, memory=memory if on_card else None, histories=histories,
                evaluation=evaluation)


if __name__ == "__main__":
    main()
