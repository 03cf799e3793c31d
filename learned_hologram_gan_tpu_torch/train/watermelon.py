"""The "watermelon" GAN trainer (counterpart of
``learned_hologram_gan_tpu/train/watermelon.py``): the epoch loop,
checkpoints, the loss/metric history and the visualizations.

Constructor and ``train`` keep the JAX package's arguments.  The
single-card high-resolution levers run as in the JAX package: ``remat``
(per-block UNet recomputation and the step's remat sites), ``cache_h=False``
(no transfer-function stack kept; H computed where it is used) and
``pad_cols_override`` (a 5-smooth column padding from
``utils/fftlen.good_fft_pads``); so does ``polyphase_level0`` (UNet level 0
in the phase domain).  The multi-device modes (``parallel/``):
``spatial_mesh`` binds the row-sharded pencil FFT into both plans, as the
JAX package does, and ``data_mesh`` (where the JAX package shards the
loader's batches and lets GSPMD do the rest) builds data-parallel steps;
every rank runs the loop, and only rank 0 prints and writes files.  The
two-stage pretrain -> fine-tune workflow
runs as in the JAX package: per-part pretrained weights
(``pretrained_part1/2_path``, flax ``.msgpack`` or torch files),
``freeze_part1``, and full-state checkpoints in ``resume_dir`` with
resume-from-latest.  The history JSON keeps the reference's key layout
(watermelon.py:169-194).
The ablation subclasses of the reference are factory functions, as in the
JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DiscriminatorConfig, GeneratorConfig, LossConfig
from ..losses import load_vgg19_params, make_vgg19
from ..models import make_generator_plan
from ..ops import asm
from ..parallel import replicate_state
from ..utils.normalize import tensor_normalizor_2d
from . import checkpoint as ckpt_lib
from .state import TrainState, build_modules, create_train_state
from .steps import build_eval_step, build_infer_fn, build_train_step

LOSS_KEYS = (
    "focal_phase_gradient_loss",
    "perceptual_loss",
    "pixel_loss",
    "TV_loss",
    "gan_loss",
    "G_loss",
    "D_loss",
)
METRIC_KEYS = ("PSNR", "SSIM")


def default_distance_stack() -> np.ndarray:
    """linspace(-1.5e-4, 0, 8)[:-1] (reference watermelon.py:39)."""
    return np.linspace(-1.5e-4, 0.0, 8)[:-1]


class Watermelon:
    """Trainer with constructor parity to reference ``watermelon`` (:34-90),
    on ``device`` (``cuda`` unless asked otherwise)."""

    def __init__(
        self,
        filter_radius_coefficient: float = 0.5,
        pad_size: int = 416,
        kernel_size: int = 3,
        distance_stack: Optional[Sequence[float]] = None,
        pretrained_model_path_G: Optional[str] = None,
        pretrained_model_path_D: Optional[str] = None,
        pretrained_part1_path: Optional[str] = None,
        pretrained_part2_path: Optional[str] = None,
        freeze_part1: bool = False,
        input_shape: Tuple[int, int, int, int] = (1, 4, 192, 192),
        use_gan: bool = True,
        use_modulation: bool = True,
        phase_loss: str = "focal_sincos_gradient",
        perceptual: str = "vgg19",
        perceptual_weights_path: Optional[str] = None,
        dtype: str = "float32",
        unet_base_features: int = 64,
        feature_d: int = 32,
        remat: bool = False,
        cache_h: bool = True,
        spatial_mesh=None,
        critic_batching: str = "pair",
        two_h_hat: bool = False,
        polyphase_level0: bool = False,
        pad_cols_override: Optional[int] = None,
        device: str | torch.device = "cuda",
        data_mesh=None,
    ):
        if spatial_mesh is not None and data_mesh is not None:
            raise ValueError("spatial_mesh and data_mesh are two layouts of the same ranks; pass one")
        self.spatial_mesh = spatial_mesh
        self.data_mesh = data_mesh
        self.critic_batching = critic_batching
        self.two_h_hat = two_h_hat
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda asked for, but no CUDA device is available")

        rows, cols = input_shape[-2], input_shape[-1]
        if distance_stack is None:
            distance_stack = default_distance_stack()
        self.distance_stack = np.asarray(distance_stack, dtype=np.float32)
        self.distance_num = len(self.distance_stack)
        self.input_shape = input_shape

        self.gen_config = GeneratorConfig(
            rows=rows,
            cols=cols,
            pad_size=pad_size,
            filter_radius_coefficient=filter_radius_coefficient,
            kernel_size=kernel_size,
            distance=1e-3,  # reference watermelon.py:58
            use_modulation=use_modulation,
            unet_base_features=unet_base_features,
            dtype=dtype,
            remat=remat,
            polyphase_level0=polyphase_level0,
            pad_cols_override=pad_cols_override,
        )
        self.disc_config = DiscriminatorConfig(feature_d=feature_d, dtype=dtype)
        self.use_gan = use_gan
        self._loss_defaults = dict(
            phase_loss=phase_loss,
            perceptual=perceptual,
            perceptual_weights_path=perceptual_weights_path,
        )

        # plans: fixed 1 mm for the generator, the distance stack for the
        # reconstruction losses
        self.gen_plan = make_generator_plan(self.gen_config, device=self.device, cache_h=cache_h)
        self.multi_plan = asm.make_plan(
            self.gen_config.optics(), distances=self.distance_stack, device=self.device,
            cache_h=cache_h,
        )
        if spatial_mesh is not None:
            self.gen_plan = self.gen_plan.with_spatial(spatial_mesh)
            self.multi_plan = self.multi_plan.with_spatial(spatial_mesh)
        self.generator, self.discriminator = build_modules(self.gen_config, self.disc_config, use_gan)
        self.vgg = None
        if perceptual != "none":
            # "vgg19" raises without a weights file; "random" is the loud,
            # explicit opt-in (losses/perceptual.py)
            vgg_state, self.vgg_pretrained = load_vgg19_params(perceptual_weights_path, mode=perceptual)
            self.vgg = make_vgg19(vgg_state, self.device)

        self.pretrained_model_path_G = pretrained_model_path_G
        self.pretrained_model_path_D = pretrained_model_path_D
        # per-part pretrained weights for the two-stage pretrain -> fine-tune
        # workflow (reference generator.py:26-28 / RGBD2AP.py:37-41)
        self.pretrained_part1_path = pretrained_part1_path
        self.pretrained_part2_path = pretrained_part2_path
        self.freeze_part1 = freeze_part1
        self.state: Optional[TrainState] = None
        self.infer_fn = build_infer_fn(self.generator)
        self.loss_cfg: Optional[LossConfig] = None
        self.train_step = self.eval_step = None

    # ------------------------------------------------------------------
    @property
    def is_main(self) -> bool:
        """True on the rank that prints and writes files: rank 0 under a
        mesh, else the one process."""
        if self.data_mesh is None and self.spatial_mesh is None:
            return True
        return torch.distributed.get_rank() == 0

    def _print(self, *args) -> None:
        if self.is_main:
            print(*args)

    def _init_state(self, seed: int, lr_G: float, lr_D: float) -> None:
        self.state = create_train_state(
            seed, self.generator, self.discriminator, lr_G, lr_D, self.device, self.vgg,
            freeze_part1=self.freeze_part1,
        )
        if self.pretrained_model_path_G:
            ckpt_lib.load_generator(self.state, self.pretrained_model_path_G)
            self._print(f"Generator loaded from {self.pretrained_model_path_G}")
        if self.pretrained_model_path_D:
            ckpt_lib.load_discriminator(self.state, self.pretrained_model_path_D)
            self._print(f"Discriminator loaded from {self.pretrained_model_path_D}")
        if self.pretrained_part1_path:
            ckpt_lib.load_generator_part(self.state, self.pretrained_part1_path, "part1")
        if self.pretrained_part2_path:
            ckpt_lib.load_generator_part(self.state, self.pretrained_part2_path, "part2")
        mesh = self.data_mesh or self.spatial_mesh
        if mesh is not None:  # every rank starts from rank 0's state
            replicate_state(self.state, mesh)

    # ------------------------------------------------------------------
    def train(
        self,
        data_loader_train: Iterable,
        data_loader_val: Iterable,
        phs_gradient_loss_weight: float = 1.0,
        perceptual_loss_weight: float = 1.0,
        pixel_loss_weight: float = 1.0,
        TV_loss_weight: float = 1e-3,
        discriminator_loss_weight: float = 1.0,
        epoch_num: int = 2,
        lr_G: float = 1e-3,
        lr_D: float = 1e-3,
        save_path_G: Optional[str] = None,
        save_path_D: Optional[str] = None,
        info_print_interval: int = 100,
        info_plot_interval: int = 600,
        loss_metrics_file: Optional[str] = None,
        save_path_img: Optional[str] = None,
        checkpoint_iterval: int = 5,
        discriminator_train_ratio: int = 2,
        discriminator_lambda: float = 10.0,
        step_scheduler_G_gamma: float = 0.1,
        step_scheduler_D_gamma: float = 0.9999,
        visualization_RGBD_AP=None,
        seed: int = 122731,
        resume_dir: Optional[str] = None,
        start_epoch: int = 0,
        resume_data_fast_forward: bool = True,
    ) -> Dict[str, Any]:
        """Full GAN training loop (reference watermelon.train, :92-416).

        ``data_loader_{train,val}`` are callables returning a fresh epoch
        iterator of (RGBD, amp, phs) tensor batches on the trainer's device,
        or reusable iterables.  The two ``step_scheduler_*_gamma`` arguments
        are accepted for flag parity and, like the reference's commented-out
        schedulers, unused.

        ``resume_dir`` holds full-state checkpoints (both nets, both Adam
        states, the random draws' generator, the step) and the history,
        written at every epoch checkpoint and at the end (the newest 3
        kept); a restart with the same ``resume_dir`` restores the latest
        and fast-forwards the (deterministic) loaders past the batches
        already trained, bit for bit the uninterrupted run.  With
        ``start_epoch`` and ``resume_data_fast_forward=False`` the caller
        positions the loaders for ``start_epoch`` instead (chunked runs).
        """
        main = self.is_main
        if save_path_G is None:
            self._print("!!!!!!The save path of the generator is not specified, "
                        "the model will not be saved!!!!!!")
        if save_path_D is None:
            self._print("!!!!!!The save path of the discriminator is not specified, "
                        "the model will not be saved!!!!!!")

        if not self.use_gan:
            # reference watermelon_without_GAN.train (:667-715)
            discriminator_loss_weight = 0.0
            discriminator_train_ratio = 0
            discriminator_lambda = 0.0

        self.loss_cfg = LossConfig(
            phs_gradient_loss_weight=phs_gradient_loss_weight,
            perceptual_loss_weight=perceptual_loss_weight,
            pixel_loss_weight=pixel_loss_weight,
            tv_loss_weight=TV_loss_weight,
            discriminator_loss_weight=discriminator_loss_weight,
            **self._loss_defaults,
        )

        self._init_state(seed, lr_G, lr_D)
        # kept on the trainer, with its state and plans, for callers that
        # step or validate it further
        self.train_step = train_step = build_train_step(
            self.loss_cfg, self.use_gan, discriminator_train_ratio, discriminator_lambda,
            critic_batching=self.critic_batching, two_h_hat=self.two_h_hat,
            remat=self.gen_config.remat, mesh=self.data_mesh,
        )
        self.eval_step = build_eval_step(self.loss_cfg, mesh=self.data_mesh)

        history = {
            "epoch": [], "n_batch_in_epoch": [], "n_train": [], "n_batch": [],
            "train_losses_tensor": {k: [] for k in LOSS_KEYS},
            "train_metrics_tensor": {k: [] for k in METRIC_KEYS},
            "validate_losses_tensor": {k: [] for k in LOSS_KEYS},
            "validate_metrics_tensor": {k: [] for k in METRIC_KEYS},
        }
        train_acc = {k: 0.0 for k in LOSS_KEYS + METRIC_KEYS}
        acc_last = dict(train_acc)
        n_train = n_batch = n_batch_last = 0
        # one step behind: reading the previous step's scalars does not wait
        # for the step just queued on the device
        pending_metrics = None

        start_step = 0
        if resume_dir is not None:
            history, start_step = self._resume(resume_dir, history)
            n_batch_last = start_step
            if start_step and not resume_data_fast_forward:
                # loaders are caller-positioned for start_epoch
                n_batch = start_step
                if history["n_train"]:
                    n_train = int(history["n_train"][-1])

        for epoch in range(start_epoch, epoch_num):
            for n_batch_in_epoch, batch in enumerate(self._epoch(data_loader_train)):
                n_batch += 1
                n_train += int(batch[0].shape[0])
                if n_batch <= start_step:
                    continue  # trained before the restart
                self.state, metrics = train_step(self.state, batch, self.gen_plan, self.multi_plan)
                if pending_metrics is not None:
                    for k in train_acc:
                        train_acc[k] += float(pending_metrics[k])
                pending_metrics = metrics

                if n_batch % info_print_interval == 0:
                    for k in train_acc:  # flush so the interval is exact
                        train_acc[k] += float(pending_metrics[k])
                    pending_metrics = None
                    val = self._validate(self.eval_step, data_loader_val)
                    denom = n_batch - n_batch_last
                    train_iter = {k: (train_acc[k] - acc_last[k]) / denom for k in train_acc}
                    if main:
                        self._print_info(epoch, n_batch_in_epoch, n_train, n_batch, train_iter, val)
                    self._record(history, epoch, n_batch_in_epoch, n_train, n_batch, train_iter, val)
                    acc_last = dict(train_acc)
                    n_batch_last = n_batch

                if n_batch % info_plot_interval == 0 and visualization_RGBD_AP is not None:
                    self._visualize(visualization_RGBD_AP, save_path_img,
                                    f"epoch {epoch}, batch {n_batch_in_epoch + 1}")

            if epoch % checkpoint_iterval == 0 and n_batch > start_step and main:
                if save_path_G is not None:
                    p = ckpt_lib.epoch_path(save_path_G, epoch)
                    ckpt_lib.save_generator(self.state, p)
                    print(f"Generator saved to {p}")
                if save_path_D is not None:
                    p = ckpt_lib.epoch_path(save_path_D, epoch)
                    ckpt_lib.save_discriminator(self.state, p)
                    print(f"Discriminator saved to {p}")
                if loss_metrics_file is not None:
                    self._save_history(history, loss_metrics_file)
                    print(f"losses and metrics saved to {loss_metrics_file}")
                if resume_dir is not None:
                    # the write overlaps the next epoch; it is renamed into
                    # place when complete, so a restore never sees it partial
                    p = ckpt_lib.save_train_state(self.state, resume_dir, wait=False)
                    self._save_history(history, os.path.join(resume_dir, "history.json"))
                    ckpt_lib.prune_checkpoints(resume_dir, keep=3)
                    print(f"Full train state saving (async) to {p}")
            if (epoch % checkpoint_iterval == 0 and n_batch > start_step
                    and visualization_RGBD_AP is not None):
                self._visualize(visualization_RGBD_AP, save_path_img, f"epoch {epoch}")

        if save_path_G is not None and main:
            ckpt_lib.save_generator(self.state, save_path_G)
            print(f"Generator saved to {save_path_G}")
        if save_path_D is not None and main:
            ckpt_lib.save_discriminator(self.state, save_path_D)
            print(f"Discriminator saved to {save_path_D}")
        if loss_metrics_file is not None and main:
            self._save_history(history, loss_metrics_file)
            print(f"losses and metrics saved to {loss_metrics_file}")
        if resume_dir is not None and n_batch > start_step and main:
            ckpt_lib.save_train_state(self.state, resume_dir)
            self._save_history(history, os.path.join(resume_dir, "history.json"))
            ckpt_lib.prune_checkpoints(resume_dir, keep=3)
        ckpt_lib.wait_for_saves()
        return history

    def _resume(self, resume_dir: str, history: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
        """Stamp or check ``resume_dir``'s ``meta.json``, then restore the
        latest checkpoint, if any, and its history.  Returns the history and
        the restored step (0 for a fresh start)."""
        # freeze_part1 changes what opt_G holds (no part-1 state), so a
        # checkpoint of the other setting cannot load; name the flag rather
        # than fail inside the optimizer's load_state_dict
        meta_path = os.path.join(resume_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("freeze_part1") != self.freeze_part1:
                raise ValueError(
                    f"resume_dir {resume_dir!r} holds checkpoints written with "
                    f"freeze_part1={meta.get('freeze_part1')}, but this trainer was built "
                    f"with freeze_part1={self.freeze_part1}. The generator optimizer's state "
                    "differs between the two settings, so the checkpoint cannot be restored; "
                    "re-run with the matching --freeze_part1 setting or point resume_dir at "
                    "a fresh directory."
                )
        elif self.is_main:
            os.makedirs(resume_dir, exist_ok=True)
            with open(meta_path, "w") as f:
                json.dump({"freeze_part1": self.freeze_part1}, f)
        if ckpt_lib.restore_latest(resume_dir, self.state) is None:
            return history, 0
        hist_path = os.path.join(resume_dir, "history.json")
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                history = json.load(f)
        self._print(f"Resumed training from {resume_dir} at step {self.state.step}")
        return history, self.state.step

    # ------------------------------------------------------------------
    @staticmethod
    def _epoch(loader) -> Iterable:
        return loader() if callable(loader) else loader

    def _validate(self, eval_step, data_loader_val) -> Dict[str, float]:
        """Full validation pass (reference _validate_generator, :479-552):
        each batch's metrics get equal weight, a ragged last batch included."""
        acc = {k: 0.0 for k in LOSS_KEYS + METRIC_KEYS}
        n = 0
        for batch in self._epoch(data_loader_val):
            metrics = eval_step(self.state, batch, self.gen_plan, self.multi_plan)
            for k in acc:
                acc[k] += float(metrics[k])
            n += 1
        return {k: v / max(n, 1) for k, v in acc.items()}

    @staticmethod
    def _print_info(epoch, n_batch_in_epoch, n_train, n_batch, train, val) -> None:
        def fmt(d):
            return ", ".join(f"{k} {d[k]:.6g}" for k in LOSS_KEYS)

        print(
            f"epoch {epoch}, batch {n_batch_in_epoch + 1} ({n_train} samples and "
            f"{n_batch} batches have been trained):\n"
            f"      train: {fmt(train)};\n"
            f"      train: PSNR {train['PSNR']:.6g}, SSIM {train['SSIM']:.6g};\n"
            f"      validate: {fmt(val)};\n"
            f"      validate: PSNR {val['PSNR']:.6g}, SSIM {val['SSIM']:.6g};\n"
        )

    @staticmethod
    def _record(history, epoch, n_batch_in_epoch, n_train, n_batch, train, val):
        history["epoch"].append(epoch)
        history["n_batch_in_epoch"].append(n_batch_in_epoch)
        history["n_train"].append(n_train)
        history["n_batch"].append(n_batch)
        for k in LOSS_KEYS:
            history["train_losses_tensor"][k].append(train[k])
            history["validate_losses_tensor"][k].append(val[k])
        for k in METRIC_KEYS:
            history["train_metrics_tensor"][k].append(train[k])
            history["validate_metrics_tensor"][k].append(val[k])

    @staticmethod
    def _save_history(history, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(history, f)

    def _visualize(self, visualization_RGBD_AP, save_path_img, tag: str) -> None:
        """Save the amp/phs reconstruction of one sample (reference :325-355)."""
        if save_path_img is None:
            return
        from ..utils.plotting import save_rgb_image

        rgbd = torch.as_tensor(np.asarray(visualization_RGBD_AP[0]), device=self.device)[None]
        poh = self.infer_fn(self.gen_plan, rgbd)
        with torch.inference_mode():
            amp_hat, phs_hat = asm.propagate_poh2ap_forward(self.gen_plan, poh)
            both = tensor_normalizor_2d(torch.cat([amp_hat, phs_hat], dim=0)).cpu().numpy()
        if not self.is_main:  # the other ranks took part in a spatial mesh's FFTs
            return
        save_rgb_image(both[0], save_path_img, f"amp_hat in {tag}")
        save_rgb_image(both[1], save_path_img, f"phs_hat in {tag}")
        print(f"visualization saved at {tag}")

    # ------------------------------------------------------------------
    def generate(self, rgbd: torch.Tensor) -> torch.Tensor:
        """Inference: RGBD (B, 4, H, W) -> POH (B, 3, H, W) (reference
        generatePOH)."""
        if self.state is None:
            self._init_state(0, 1e-3, 1e-3)
        return self.infer_fn(self.gen_plan, torch.as_tensor(rgbd, device=self.device))


# ---------------------------------------------------------------------------
# Ablation factories (reference watermelon.py:640-938): config, not subclasses
# ---------------------------------------------------------------------------


def watermelon(**kw) -> Watermelon:
    return Watermelon(**kw)


def watermelon_without_GAN(**kw) -> Watermelon:
    kw.setdefault("use_gan", False)
    return Watermelon(**kw)


def watermelon_without_GAN_without_modulation(**kw) -> Watermelon:
    kw.setdefault("use_gan", False)
    kw.setdefault("use_modulation", False)
    return Watermelon(**kw)


def watermelon_without_GAN_without_perceptual_loss(**kw) -> Watermelon:
    kw.setdefault("use_gan", False)
    kw.setdefault("perceptual", "none")
    return Watermelon(**kw)


def watermelon_without_GAN_and_plain_phase_loss(**kw) -> Watermelon:
    kw.setdefault("use_gan", False)
    kw.setdefault("phase_loss", "plain")
    return Watermelon(**kw)


def watermelon_without_GAN_and_focal_sincos_phase_loss(**kw) -> Watermelon:
    kw.setdefault("use_gan", False)
    kw.setdefault("phase_loss", "focal_sincos")
    return Watermelon(**kw)


def watermelon_without_GAN_and_phase_sincos_gradient_loss(**kw) -> Watermelon:
    kw.setdefault("use_gan", False)
    kw.setdefault("phase_loss", "sincos_gradient")
    return Watermelon(**kw)
