"""GAN train, eval and inference steps (counterpart of
``learned_hologram_gan_tpu/train/steps.py``).

One train step (reference watermelon.py:207-284), in this order:

  1. POH = G(RGBD), G in train mode: its BatchNorm running stats update once;
  2. hat spectrum: POH -> filtered spectrum (fixed-distance plan; K3 fft2);
  3. target spectrum: (amp, phs) -> filtered spectrum (no gradient);
  4. random-distance reconstruction of concat(hat, target) (K1 in
     ``from_spectrum`` + ``per_plane`` mode): hat[i] and target[i] share
     the drawn distance;
  5. the critic, ``discriminator_train_ratio`` times, on detached
     reconstructions with the WGAN-GP penalty (a ``create_graph`` double
     backward through the critic on batch statistics), then Adam on D; how
     the applies are batched is ``critic_batching`` (:func:`critic_updates`);
  6. the 5-term generator loss against the *updated* critic, then its
     backward through the graph of step 1 (K2 twice, K3's adjoint) and
     Adam on G.

With ``two_h_hat`` steps 2-4 are :func:`asm.hat_target_random_distances`:
each branch is one field-input, ``per_plane`` propagation (K1, and K2 in
the backward) with a product mask, and no spectrum is built.

The generator runs forward once: the critic sees detached views of its
output, and step 6 backpropagates through the graph kept from step 1.
Every convolution of a step, forward and backward, runs in full float32
(``full_f32_convs``), whatever the caller's TF32 setting.  The random
draws (distance indices, GP alphas) come from ``state.rng`` unless passed
in, as the parity tests pass JAX's; they are drawn before the step, so no
recomputed region draws.

``remat`` recomputes activations in the backward instead of keeping them
(``nn.blocks.remat``) at the JAX step's sites: steps 1-4 (the generator
and the reconstruction), every critic apply, the penalty's critic inside
its double backward, and VGG19.  Recomputes leave BatchNorm running
statistics alone, so the step's values are the plain step's: on the CPU,
bit for bit.  A recompute runs K1 and K3 (and, in the penalty's double
backward, the critic) a second time.

Two multi-device modes (``parallel/``), each rank a process:

* ``mesh`` (data-parallel, the JAX step under a batch-sharded mesh): each
  rank takes its rows of the global batch.  The draws are made for the
  global batch from the same generator on every rank, and each rank takes
  its share (distances are drawn without replacement over the batch).
  BatchNorm statistics, the focal weights' maximum and the TV term's
  means are global (``collectives.data_parallel``), gradients are
  averaged over the ranks before each Adam step (G's, and D's at every
  critic iteration), and the metrics are global means (PSNR and SSIM over
  the gathered batch).  No DDP wrapper: the penalty's ``create_graph``
  double backward does not mix with its reducer.
* ``spatial_mesh``: the step binds it to both plans
  (``PropagatorPlan.with_spatial``), so the padded planes are row-sharded
  from each pad to each crop and their FFTs are the pencil FFT;
  parameters, the critic with its double backward and the losses run
  replicated on every rank, on the whole batch.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import LossConfig
from ..losses import PHASE_LOSSES, mse, perceptual_loss, psnr, ssim, total_variation_loss
from ..models.generator import Generator
from ..nn.blocks import frozen_batch_stats, full_f32_convs, remat as remat_region
from ..ops import asm
from ..ops.asm import PropagatorPlan
from ..parallel import collectives
from .state import TrainState

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (RGBD, amp, phs)
Recon = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _critic_apply(critic: torch.nn.Module, remat: bool) -> Callable:
    """The critic's forward, under :func:`remat_region` when ``remat``."""
    if remat:
        return lambda x: remat_region(critic, x, module=critic)
    return critic


@full_f32_convs()
def reconstruct(
    generator: Generator,
    gen_plan: PropagatorPlan,
    multi_plan: PropagatorPlan,
    batch: Batch,
    idx: torch.Tensor,
    two_h: bool = False,
    remat: bool = False,
) -> Recon:
    """Steps 1-4: (hat_amps, target_amps, hat_phs, target_phs), each
    (B, C, rows, cols), hat[i] and target[i] at distance ``idx[i]``.  The
    hat side keeps its graph back to the generator; the target side has
    none.  ``two_h`` reconstructs through
    :func:`asm.hat_target_random_distances` (one transfer function per
    branch, no spectrum built).  ``remat`` keeps none of the region's
    activations: the backward runs it again (generator in train mode, its
    running statistics left as the forward left them)."""
    if remat:
        return remat_region(_reconstruct, generator, gen_plan, multi_plan, batch, idx, two_h,
                            module=generator)
    return _reconstruct(generator, gen_plan, multi_plan, batch, idx, two_h)


def _reconstruct(generator, gen_plan, multi_plan, batch, idx, two_h) -> Recon:
    rgbd, target_amp, target_phs = batch
    poh = generator(gen_plan, rgbd)
    if two_h:
        hat_amps, target_amps, hat_phs, target_phs = asm.hat_target_random_distances(
            gen_plan, multi_plan, poh, target_amp, target_phs, idx
        )
        # the target's inputs carry no graph, so autograd recorded nothing there
        return hat_amps, target_amps.detach(), hat_phs, target_phs.detach()
    hat_freq = asm.propagate_poh2freq_forward(gen_plan, poh)
    with torch.no_grad():
        target_freq = asm.filter_ap2filtered_freq(multi_plan, target_amp, target_phs)
    amps, phss = asm.freq2ap_random_distances(
        multi_plan, torch.cat([hat_freq, target_freq], dim=0), idx
    )
    b = rgbd.shape[0]
    return amps[:b], amps[b:].detach(), phss[:b], phss[b:].detach()


def gradient_penalty(
    discriminator: torch.nn.Module,
    real: torch.Tensor,
    fake: torch.Tensor,
    alpha: torch.Tensor,
    remat: bool = False,
) -> torch.Tensor:
    """WGAN-GP penalty ((||grad_x D(x_interp)||_2 - 1)^2).mean() (reference
    compute_gradient_penalty, watermelon.py:458-477), differentiable in the
    critic's parameters.  The critic runs in train mode on batch statistics
    and leaves its running statistics unchanged, as the JAX package discards
    that update.  ``remat`` recomputes the critic's forward inside the
    double backward instead of keeping its activations."""
    interp = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
    with frozen_batch_stats(discriminator):
        out = _critic_apply(discriminator, remat)(interp)
    (grads,) = torch.autograd.grad(out.sum(), interp, create_graph=True)
    norms = torch.sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(dim=1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


CRITIC_BATCHINGS = ("separate", "pair", "full")


def _critic_loss(
    critic: torch.nn.Module,
    real: torch.Tensor,
    fake: torch.Tensor,
    alpha: torch.Tensor,
    discriminator_lambda: float,
    critic_batching: str,
    remat: bool = False,
) -> torch.Tensor:
    """One critic iteration's WGAN-GP loss, -D(real) + D(fake) + lambda GP,
    with the applies batched as the JAX step batches them
    (``train/steps.py:319-397``), each under :func:`remat_region` when
    ``remat``:

      * "separate": D(real), then D(fake), each updating the running
        statistics, then the penalty's apply on frozen statistics;
      * "pair": one apply on concat([real, fake]) (statistics over 2B,
        updated once), then the penalty's apply;
      * "full": one apply on concat([real, fake, interp]): statistics over
        3B, updated once, so the penalty's gradient carries the BatchNorm
        coupling of the joint batch.
    """
    b = real.shape[0]
    apply = _critic_apply(critic, remat)
    if critic_batching == "separate":
        real_v, fake_v = apply(real), apply(fake)
        gp = gradient_penalty(critic, real, fake, alpha, remat)
    elif critic_batching == "pair":
        both_v = apply(torch.cat([real, fake], dim=0))
        real_v, fake_v = both_v[:b], both_v[b:]
        gp = gradient_penalty(critic, real, fake, alpha, remat)
    else:
        interp = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
        out = apply(torch.cat([real, fake, interp], dim=0))
        out = out.reshape(out.shape[0], -1)  # scores per sample, as JAX slices them
        (grads,) = torch.autograd.grad(out[2 * b:].sum(), interp, create_graph=True)
        norms = torch.sqrt((grads.reshape(b, -1) ** 2).sum(dim=1) + 1e-12)
        gp = ((norms - 1.0) ** 2).mean()
        real_v, fake_v = out[:b], out[b:2 * b]
    return -real_v.mean() + fake_v.mean() + discriminator_lambda * gp


@full_f32_convs()
def critic_updates(
    state: TrainState,
    target_amps: torch.Tensor,
    hat_amps: torch.Tensor,
    alphas: torch.Tensor,
    discriminator_lambda: float,
    critic_batching: str = "pair",
    remat: bool = False,
    group=None,
) -> torch.Tensor:
    """Step 5: ``len(alphas)`` critic updates on detached reconstructions,
    each batched as ``critic_batching`` says (:func:`_critic_loss`), the
    gradients averaged over ``group``'s ranks when given; returns the mean
    critic loss (0 when there are none)."""
    critic = state.discriminator
    params = [p for p in critic.parameters() if p.requires_grad]
    losses = []
    for alpha in alphas:
        loss = _critic_loss(critic, target_amps, hat_amps, alpha, discriminator_lambda,
                            critic_batching, remat)
        state.opt_D.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        mean_gradients(params, group)
        state.opt_D.step()
        losses.append(loss.detach())
    if not losses:
        return torch.zeros((), device=target_amps.device)
    return torch.stack(losses).mean()


def _g_loss_terms(
    loss_cfg: LossConfig,
    vgg,
    hat_amps: torch.Tensor,
    target_amps: torch.Tensor,
    hat_phs: torch.Tensor,
    target_phs: torch.Tensor,
    loss_from_discriminator: torch.Tensor,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 5-term weighted generator loss (reference G_loss,
    watermelon.py:418-445); ``remat`` recomputes VGG19's activations (hat
    and target sides) in the backward."""
    phs_loss = PHASE_LOSSES[loss_cfg.phase_loss](hat_phs, target_phs) * loss_cfg.phs_gradient_loss_weight
    if loss_cfg.perceptual == "none":
        p_loss = torch.zeros((), device=hat_amps.device)
    elif remat:
        p_loss = remat_region(perceptual_loss, vgg, hat_amps, target_amps) * loss_cfg.perceptual_loss_weight
    else:
        p_loss = perceptual_loss(vgg, hat_amps, target_amps) * loss_cfg.perceptual_loss_weight
    pixel_loss = mse(hat_amps, target_amps) * loss_cfg.pixel_loss_weight
    tv_loss = total_variation_loss(hat_amps, target_amps) * loss_cfg.tv_loss_weight
    gan_loss = loss_from_discriminator * loss_cfg.discriminator_loss_weight
    loss = phs_loss + p_loss + pixel_loss + tv_loss + gan_loss
    terms = {
        "focal_phase_gradient_loss": phs_loss,
        "perceptual_loss": p_loss,
        "pixel_loss": pixel_loss,
        "TV_loss": tv_loss,
        "gan_loss": gan_loss,
        "G_loss": loss,
    }
    return loss, terms


@torch.no_grad()
def mean_gradients(params, group) -> None:
    """Average the ``.grad`` of ``params`` over ``group``'s ranks, in one
    all-reduce (nothing when ``group`` is None)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@full_f32_convs()
def generator_update(
    state: TrainState, loss_cfg: LossConfig, recon: Recon, remat: bool = False, group=None
) -> Dict[str, torch.Tensor]:
    """Step 6: the generator loss against the current critic (train mode,
    batch statistics, no running-stat update), its backward through the
    reconstruction's graph (recomputing the remat regions), the gradients
    averaged over ``group``'s ranks when given, Adam on G.  Returns the
    loss terms, detached."""
    hat_amps, target_amps, hat_phs, target_phs = recon
    with frozen_batch_stats(state.discriminator):
        loss_from_d = -_critic_apply(state.discriminator, remat)(hat_amps).mean()
    loss, terms = _g_loss_terms(
        loss_cfg, state.vgg, hat_amps, target_amps, hat_phs, target_phs, loss_from_d, remat
    )
    params = [p for p in state.generator.parameters() if p.requires_grad]
    state.opt_G.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    mean_gradients(params, group)
    state.opt_G.step()
    return {k: v.detach() for k, v in terms.items()}


def draw_step_randoms(
    state: TrainState, multi_plan: PropagatorPlan, batch_size: int, ratio: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's distance indices (B,) and GP alphas (ratio, B, 1, 1, 1),
    drawn on the CPU from ``state.rng`` (under a data mesh, for the global
    batch)."""
    idx = asm.draw_distance_indices(multi_plan, batch_size, state.rng)
    alphas = torch.rand((ratio, batch_size, 1, 1, 1), generator=state.rng)
    return idx, alphas


class _DataMesh:
    """The data-parallel side of a step: the group, this rank's share of the
    global batch's draws, and the global metrics."""

    def __init__(self, mesh, axis_name: str = "data"):
        if mesh.axis_names != (axis_name,):
            raise ValueError(f"a data-parallel step takes a 1-D {axis_name!r} mesh (parallel.make_mesh), "
                             f"got axes {mesh.axis_names}")
        self.group, self.size, self.index = mesh.axis(axis_name)

    def rows(self, b: int) -> slice:
        return slice(self.index * b, (self.index + 1) * b)

    def region(self):
        return collectives.data_parallel(self.group)

    @torch.no_grad()
    def metrics(self, terms: Dict[str, torch.Tensor], hat: torch.Tensor, target: torch.Tensor):
        """The terms' means over the ranks, and PSNR and SSIM of the
        gathered global batch."""
        keys = sorted(terms)
        vals = torch.stack([terms[k].float().reshape(()) for k in keys])
        dist.all_reduce(vals, group=self.group)
        out = dict(zip(keys, (vals / self.size).unbind()))
        hat = collectives.gather_batch(hat, self.group)
        target = collectives.gather_batch(target, self.group)
        out["PSNR"], out["SSIM"] = psnr(hat, target), ssim(hat, target)
        return out


def _region(dm: Optional[_DataMesh]):
    """The data-parallel region a step runs in (none outside a mesh)."""
    return dm.region() if dm is not None else contextlib.nullcontext()


def _bind(spatial_mesh, *plans):
    """``plans`` bound to ``spatial_mesh`` (unchanged without one)."""
    if spatial_mesh is None:
        return plans
    return tuple(p.with_spatial(spatial_mesh) for p in plans)


def _metrics(dm: Optional[_DataMesh], terms, hat, target):
    if dm is not None:
        return dm.metrics(terms, hat, target)
    out = dict(terms)
    out["PSNR"], out["SSIM"] = psnr(hat, target), ssim(hat, target)
    return out


def build_train_step(
    loss_cfg: LossConfig,
    use_gan: bool,
    discriminator_train_ratio: int,
    discriminator_lambda: float,
    critic_batching: str = "pair",
    two_h_hat: bool = False,
    remat: bool = False,
    mesh=None,
    spatial_mesh=None,
) -> Callable:
    """Build ``train_step(state, batch, gen_plan, multi_plan, idx=None,
    alphas=None) -> (state, metrics)``, which updates ``state`` in place.

    ``critic_batching`` ("separate", "pair" or "full") structures each
    critic iteration (:func:`_critic_loss`); ``two_h_hat`` reconstructs
    through :func:`asm.hat_target_random_distances`; ``remat`` recomputes
    activations in the backward at the JAX step's sites (module
    docstring).  ``idx`` (B,) and
    ``alphas`` (ratio, B, 1, 1, 1) override the draws from ``state.rng``.
    ``metrics`` holds 0-dim tensors on the batch's device.

    ``mesh`` (a ``parallel.Mesh`` with a ``data`` axis) makes the step
    data-parallel: ``batch`` is this rank's rows, ``idx`` and ``alphas``
    (drawn or passed) are the global batch's, and the metrics are global.
    ``spatial_mesh`` binds the row-sharded planes and pencil FFT to both
    plans for the step (module docstring).
    """
    if critic_batching not in CRITIC_BATCHINGS:
        raise ValueError(f"unknown critic_batching {critic_batching!r}")
    ratio = discriminator_train_ratio if use_gan else 0
    dm = _DataMesh(mesh) if mesh is not None else None
    group = dm.group if dm is not None else None

    def train_step(state: TrainState, batch: Batch, gen_plan, multi_plan, idx=None, alphas=None):
        b = batch[0].shape[0]
        drawn_idx, drawn_alphas = draw_step_randoms(state, multi_plan, b * (dm.size if dm else 1),
                                                    ratio)
        idx = drawn_idx if idx is None else idx
        alphas = drawn_alphas if alphas is None else alphas
        if dm is not None:
            idx, alphas = idx[dm.rows(b)], alphas[:, dm.rows(b)]
        state.generator.train()
        state.discriminator.train()
        gen_plan, multi_plan = _bind(spatial_mesh, gen_plan, multi_plan)
        with _region(dm):
            recon = reconstruct(state.generator, gen_plan, multi_plan, batch, idx, two_h=two_h_hat,
                                remat=remat)
            hat_d, target_d = recon[0].detach(), recon[1]
            d_loss = critic_updates(
                state, target_d, hat_d, alphas.to(hat_d.device), discriminator_lambda, critic_batching,
                remat, group,
            )
            terms = generator_update(state, loss_cfg, recon, remat, group)
            terms["D_loss"] = d_loss
            metrics = _metrics(dm, terms, hat_d, target_d)
        state.step += 1
        return state, metrics

    return train_step


def build_eval_step(loss_cfg: LossConfig, mesh=None, spatial_mesh=None) -> Callable:
    """Validation step over ALL cached distances (reference
    _validate_generator, watermelon.py:479-552): eval mode (the train step
    sets train mode again), no autograd, the critic loss fixed at 0.
    ``mesh`` and ``spatial_mesh`` as for :func:`build_train_step`."""
    dm = _DataMesh(mesh) if mesh is not None else None

    @torch.no_grad()
    @full_f32_convs()
    def eval_step(state: TrainState, batch: Batch, gen_plan, multi_plan) -> Dict[str, torch.Tensor]:
        rgbd, target_amp, target_phs = batch
        state.generator.eval()
        state.discriminator.eval()
        gen_plan, multi_plan = _bind(spatial_mesh, gen_plan, multi_plan)
        with _region(dm):
            poh = state.generator(gen_plan, rgbd)
            hat_freq = asm.propagate_poh2freq_forward(gen_plan, poh)
            target_freq = asm.filter_ap2filtered_freq(multi_plan, target_amp, target_phs)
            amps, phss = asm.freq2ap_all_distances(multi_plan, torch.cat([hat_freq, target_freq]))
            half = amps.shape[0] // 2
            hat_amps, target_amps = amps[:half], amps[half:]
            loss_from_d = -state.discriminator(hat_amps).mean()
            _, terms = _g_loss_terms(
                loss_cfg, state.vgg, hat_amps, target_amps, phss[:half], phss[half:], loss_from_d
            )
            terms["D_loss"] = torch.zeros((), device=hat_amps.device)
            return _metrics(dm, terms, hat_amps, target_amps)

    return eval_step


def build_infer_fn(generator: Generator) -> Callable:
    """POH inference forward (reference generatePOH.py:41-43): eval mode,
    no autograd."""

    def infer(gen_plan: PropagatorPlan, rgbd: torch.Tensor) -> torch.Tensor:
        generator.eval()
        with torch.inference_mode():
            return generator(gen_plan, rgbd)

    return infer
