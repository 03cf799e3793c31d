"""Per-stage pretraining (counterpart of
``learned_hologram_gan_tpu/train/pretrain.py``; reference
RGBD2AP.train_model :52-137 and AP2POH.train_model :118-218).

The first half of the two-stage workflow: :func:`train_rgbd2ap` fits stage
1 and :func:`train_ap2poh` stage 2, each writing its weights
(``rgbd2ap.msgpack`` / ``ap2poh.msgpack`` in flax's format, or torch
``state_dict`` files), which the GAN fine-tune loads with
``--pretrained_part1/2``.  Both stages share one skeleton: Adam, an
epoch-level plateau scheduler fed the validation loss, a full validation
pass each epoch, ``_epoch{n}`` checkpoints and a final save.

:class:`ReduceLROnPlateau` is the JAX package's (the reference's constants:
factor gamma, patience 4, threshold 1e-3 relative, min_lr 1e-6), not
``torch.optim.lr_scheduler``'s, whose counting differs: the rate drops when
more than ``patience`` epochs in a row fail to improve on the best by the
relative threshold.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..losses import amp_loss, amp_phs_loss
from ..models import AP2POH, RGBD2AP
from ..ops import asm
from . import checkpoint as ckpt_lib


class ReduceLROnPlateau:
    """Epoch-level plateau learning-rate schedule (reference RGBD2AP.py:79-90
    constants: factor=gamma, patience=4, threshold=1e-3 relative,
    min_lr=1e-6)."""

    def __init__(
        self,
        lr: float,
        factor: float = 0.1,
        patience: int = 4,
        threshold: float = 1e-3,
        min_lr: float = 1e-6,
    ):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, value: float) -> float:
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


Batch = Tuple[torch.Tensor, ...]


def _to_device(batch, device: torch.device) -> Batch:
    return tuple(torch.as_tensor(x, device=device) for x in batch)


def _run_epochs(
    *,
    epochs: int,
    model: torch.nn.Module,
    optimizer: torch.optim.Adam,
    scheduler: Optional[ReduceLROnPlateau],
    train_batches: Callable[[], Iterable],
    val_batches: Callable[[], Iterable],
    train_step: Callable[[Batch], torch.Tensor],
    eval_step: Callable[[Batch], torch.Tensor],
    save_path: Optional[str],
    checkpoint_interval: int,
) -> Tuple[List[float], List[float]]:
    """The epoch loop: ``train_step`` / ``eval_step`` return a batch's loss
    times its size; the epoch's averages go to the histories, the
    validation average to the scheduler, which sets Adam's rate."""
    device = next(model.parameters()).device
    train_hist: List[float] = []
    val_hist: List[float] = []
    for epoch in range(epochs):
        train_loss, n_train = 0.0, 0
        # one step behind: reading the previous step's loss does not wait
        # for the step just queued on the device
        pending = None
        for batch in train_batches():
            batch = _to_device(batch, device)
            loss = train_step(batch)
            if pending is not None:
                train_loss += float(pending)
            pending = loss
            n_train += int(batch[0].shape[0])
        if pending is not None:
            train_loss += float(pending)

        val_loss, n_val = 0.0, 0
        for batch in val_batches():
            batch = _to_device(batch, device)
            val_loss += float(eval_step(batch))
            n_val += int(batch[0].shape[0])

        avg_train = train_loss / max(n_train, 1)
        avg_val = val_loss / max(n_val, 1)
        train_hist.append(avg_train)
        val_hist.append(avg_val)
        print(f"epoch {epoch + 1}, train loss {avg_train:.7f}, test loss {avg_val:.7f}")

        if scheduler is not None:
            lr = scheduler.step(avg_val)
            for group in optimizer.param_groups:
                group["lr"] = lr

        if epoch % checkpoint_interval == 0 and epoch != 0 and save_path is not None:
            ckpt_lib.save_weights(ckpt_lib.epoch_path(save_path, epoch), model)
    if save_path is not None:
        ckpt_lib.save_weights(save_path, model)
    return train_hist, val_hist


def train_rgbd2ap(
    model: RGBD2AP,
    train_batches: Callable[[], Iterable],
    val_batches: Callable[[], Iterable],
    epochs: int = 30,
    lr: float = 1e-3,
    alpha: float = 1e-3,
    hyperparameter_gamma: float = 0.1,
    save_path: Optional[str] = None,
    checkpoint_iterval: int = 10,
) -> Tuple[RGBD2AP, List[float], List[float]]:
    """Stage-1 pretraining (reference RGBD2AP.train_model :52-137), in place
    on ``model`` and on its device.

    Batches are (RGBD, amp, phs01), the phase normalized to [0, 1]; the loss
    is ``amp_phs_loss`` on (amp, 2*pi*phs01), the phase scaled once (the
    reference scales it twice by accident, RGBD2AP.py:99+149, as the JAX
    package documents).  Returns the model and the per-epoch train and
    validation losses."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    scheduler = ReduceLROnPlateau(lr, factor=hyperparameter_gamma)

    def loss_of(batch):
        rgbd, amp, phs01 = batch
        amp_hat, phs_hat = model(rgbd)
        return amp_phs_loss(amp_hat, phs_hat, amp, (2.0 * np.pi) * phs01, alpha)

    def train_step(batch):
        model.train()
        loss = loss_of(batch)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach() * batch[0].shape[0]

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        return loss_of(batch) * batch[0].shape[0]

    train_hist, val_hist = _run_epochs(
        epochs=epochs, model=model, optimizer=optimizer, scheduler=scheduler,
        train_batches=train_batches, val_batches=val_batches,
        train_step=train_step, eval_step=eval_step,
        save_path=save_path, checkpoint_interval=checkpoint_iterval,
    )
    return model, train_hist, val_hist


def ap2poh_loss(
    model: AP2POH,
    plan: asm.PropagatorPlan,
    batch: Batch,
    filter_radius_coefficient: float,
    alpha: float,
    beta: float,
) -> torch.Tensor:
    """Stage 2's loss on an (amp, phs) batch, the phase in radians: the
    inputs low-passed (no gradient: they are data), AP2POH (K1 ``conj_h``
    on a CUDA tensor), the POH propagated forward through the sigmoid-edged
    low-pass, then ``amp_loss + beta * spectrum_loss`` (K3 forward, and its
    adjoint in the backward)."""
    amp_raw, phs_raw = batch
    with torch.no_grad():
        amp, phs = asm.differentiable_lowpass_filter(plan, amp_raw, phs_raw, filter_radius_coefficient)
    poh = model(plan, amp, phs)
    amp_hat, _, spectrum_loss = asm.propagate_poh2ap_forward_with_spectrum_loss(
        plan, poh, filter_radius_coefficient
    )
    return amp_loss(amp_hat, amp, alpha) + beta * spectrum_loss


def train_ap2poh(
    model: AP2POH,
    plan: asm.PropagatorPlan,
    train_batches: Callable[[], Iterable],
    val_batches: Callable[[], Iterable],
    filter_radius_coefficient: float = 0.45,
    epochs: int = 30,
    lr: float = 1e-3,
    alpha: float = 1e-3,
    beta: float = 1e-5,
    hyperparameter_gamma: float = 0.1,
    save_path: Optional[str] = None,
    checkpoint_iterval: int = 10,
) -> Tuple[AP2POH, List[float], List[float]]:
    """Stage-2 pretraining (reference AP2POH.train_model :118-218), in place
    on ``model``, through ``plan`` (the generator's fixed-distance plan).

    Batches are (amp, phs) with the phase already in radians
    (:class:`~..data.AmpPhsDataset` scales it, reference data_loader.py:83);
    the loss is :func:`ap2poh_loss`.  AP2POH has no BatchNorm, so its
    ``.msgpack`` holds ``"batch_stats": {}``.  Returns the model and the
    per-epoch train and validation losses."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    scheduler = ReduceLROnPlateau(lr, factor=hyperparameter_gamma)
    frc = filter_radius_coefficient

    def train_step(batch):
        model.train()
        loss = ap2poh_loss(model, plan, batch, frc, alpha, beta)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach() * batch[0].shape[0]

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        return ap2poh_loss(model, plan, batch, frc, alpha, beta) * batch[0].shape[0]

    train_hist, val_hist = _run_epochs(
        epochs=epochs, model=model, optimizer=optimizer, scheduler=scheduler,
        train_batches=train_batches, val_batches=val_batches,
        train_step=train_step, eval_step=eval_step,
        save_path=save_path, checkpoint_interval=checkpoint_iterval,
    )
    return model, train_hist, val_hist
