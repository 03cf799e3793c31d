"""Per-network checkpoints (counterpart of the per-part saves in
``learned_hologram_gan_tpu/train/checkpoint.py:29-67``).

Each file is a torch ``state_dict`` of one network (parameters and
BatchNorm statistics), at the paths the JAX package uses, with the
reference's ``_epoch{n}`` naming (watermelon.py:361-374).  Full-state
save and resume are not ported yet.
"""

from __future__ import annotations

import os

import torch

from .state import TrainState


def epoch_path(path: str, epoch: int) -> str:
    """``foo.pth`` -> ``foo_epoch{n}.pth`` (reference watermelon.py:363)."""
    root, ext = os.path.splitext(path)
    return f"{root}_epoch{epoch}{ext}"


def _write(path: str, module: torch.nn.Module) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    torch.save(state, path)


def _read(path: str, module: torch.nn.Module) -> None:
    device = next(module.parameters()).device
    module.load_state_dict(torch.load(path, map_location=device, weights_only=True))


def save_generator(state: TrainState, path: str) -> None:
    _write(path, state.generator)


def save_discriminator(state: TrainState, path: str) -> None:
    _write(path, state.discriminator)


def load_generator(state: TrainState, path: str) -> TrainState:
    _read(path, state.generator)
    return state


def load_discriminator(state: TrainState, path: str) -> TrainState:
    _read(path, state.discriminator)
    return state
