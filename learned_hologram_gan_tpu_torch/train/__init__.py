"""Training: state, steps, checkpoints, per-stage pretraining and the
Watermelon trainer."""

from . import checkpoint, flax_msgpack, pretrain
from .pretrain import ReduceLROnPlateau, train_ap2poh, train_rgbd2ap
from .state import TrainState, build_modules, create_train_state
from .steps import build_eval_step, build_infer_fn, build_train_step, gradient_penalty
from .watermelon import (
    Watermelon,
    watermelon,
    watermelon_without_GAN,
    watermelon_without_GAN_and_focal_sincos_phase_loss,
    watermelon_without_GAN_and_phase_sincos_gradient_loss,
    watermelon_without_GAN_and_plain_phase_loss,
    watermelon_without_GAN_without_modulation,
    watermelon_without_GAN_without_perceptual_loss,
)

__all__ = [
    "ReduceLROnPlateau",
    "TrainState",
    "Watermelon",
    "build_eval_step",
    "build_infer_fn",
    "build_modules",
    "build_train_step",
    "checkpoint",
    "create_train_state",
    "flax_msgpack",
    "gradient_penalty",
    "pretrain",
    "train_ap2poh",
    "train_rgbd2ap",
    "watermelon",
    "watermelon_without_GAN",
    "watermelon_without_GAN_and_focal_sincos_phase_loss",
    "watermelon_without_GAN_and_phase_sincos_gradient_loss",
    "watermelon_without_GAN_and_plain_phase_loss",
    "watermelon_without_GAN_without_modulation",
    "watermelon_without_GAN_without_perceptual_loss",
]
