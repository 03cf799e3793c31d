"""The multi-device checks' per-rank work, at tiny sizes on gloo CPU ranks.

``tests/test_torch_parallel.py`` starts the ranks with
:func:`~.launch.spawn` (``run``), which imports this module and torch
only, and holds each rank's numpy results against the JAX package's mesh
and against the port's one-device functions, which it computes itself
with the same functions (``tiny_trainer``, ``dp_steps``, ``spatial_step``,
``distance_sharded_step``, ``collectives_formulas``).  One spawn serves
every check of a world size.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import collectives as C
from .mesh import make_mesh, shard_batch, shard_distance_stack

RATIO = 2
LR = 1e-3  # SGD: the trajectories differ by rounding only, as the JAX test's


def tiny_trainer(pad_size=4, distances=10, batch=8, data_mesh=None, spatial_mesh=None):
    """The JAX multi-device tests' trainer: 16 x 16, base 2, feature_d 2,
    no perceptual term, on the CPU."""
    from ..train import Watermelon

    return Watermelon(filter_radius_coefficient=0.45, pad_size=pad_size,
                      distance_stack=np.linspace(-4e-4, 0.0, distances + 1)[:-1],
                      input_shape=(batch, 4, 16, 16), use_gan=True, perceptual="none",
                      unet_base_features=2, feature_d=2, device="cpu",
                      data_mesh=data_mesh, spatial_mesh=spatial_mesh)


def _sgd_state(trainer, seed=0):
    from ..train.state import create_train_state

    state = create_train_state(seed, trainer.generator, trainer.discriminator, LR, LR, "cpu")
    state.opt_G = torch.optim.SGD(trainer.generator.parameters(), lr=LR)
    state.opt_D = torch.optim.SGD(trainer.discriminator.parameters(), lr=LR)
    return state


def _params(module) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _step(trainer, mesh=None, spatial_mesh=None, ratio=RATIO, **options):
    from ..config import LossConfig
    from ..train.steps import build_train_step

    return build_train_step(LossConfig(perceptual="none"), True, ratio, 10.0, mesh=mesh,
                            spatial_mesh=spatial_mesh, **options)


def dp_steps(batches, critic_batching="separate", mesh=None):
    """``len(batches)`` GAN steps (SGD, ratio 2) of the tiny trainer from
    seed 0, data-parallel over ``mesh`` (each rank on its rows of every
    global batch) or on one device; returns each step's G, D and pixel
    losses and the generator's final ``state_dict``."""
    trainer = tiny_trainer()
    state = _sgd_state(trainer)
    step = _step(trainer, mesh, critic_batching=critic_batching)
    losses = []
    for batch in batches:
        batch = tuple(torch.from_numpy(a) for a in batch)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        state, m = step(state, batch, trainer.gen_plan, trainer.multi_plan)
        losses.append({k: float(m[k]) for k in ("G_loss", "D_loss", "pixel_loss")})
    return losses, _params(state.generator)


def carried_step(gen_sd, disc_sd, batch, idx, alphas, mesh=None, lr_g=1.0, lr_d=1e-4):
    """One GAN step (SGD at ``lr_g`` / ``lr_d``, ratio 2) of the tiny
    trainer at batch 2 and 4 distances (pad 8) from the given
    ``state_dict``s, with the global batch's draws: the metrics and each
    network's update divided by its rate (the gradient)."""
    trainer = tiny_trainer(pad_size=8, distances=4, batch=2)
    state = _sgd_state(trainer)
    state.generator.load_state_dict({k: torch.from_numpy(v) for k, v in gen_sd.items()})
    state.discriminator.load_state_dict({k: torch.from_numpy(v) for k, v in disc_sd.items()})
    state.opt_G = torch.optim.SGD(trainer.generator.parameters(), lr=lr_g)
    state.opt_D = torch.optim.SGD(trainer.discriminator.parameters(), lr=lr_d)
    old = {n: _params(m) for n, m in (("G", state.generator), ("D", state.discriminator))}
    batch = tuple(torch.from_numpy(a) for a in batch)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    state, m = _step(trainer, mesh)(state, batch, trainer.gen_plan, trainer.multi_plan,
                                    idx=torch.from_numpy(idx), alphas=torch.from_numpy(alphas))
    grads = {}
    for n, net, lr in (("G", state.generator, lr_g), ("D", state.discriminator, lr_d)):
        for k, v in net.named_parameters():
            grads[f"{n}.{k}"] = (old[n][k] - v.detach().numpy()) / lr
    return {k: float(v) for k, v in m.items()}, grads, _params(state.generator), _params(state.discriminator)


def spatial_step(batch, spatial_mesh=None):
    """One GAN step (SGD, ratio 1) of the tiny trainer at batch 2, pad 8
    (a 32 x 32 grid), 4 distances, every FFT row-sharded over
    ``spatial_mesh`` or on one device: metrics and the generator's
    ``state_dict``."""
    trainer = tiny_trainer(pad_size=8, distances=4, batch=2, spatial_mesh=spatial_mesh)
    state = _sgd_state(trainer)
    batch = tuple(torch.from_numpy(a) for a in batch)
    state, m = _step(trainer, spatial_mesh=spatial_mesh, ratio=1)(
        state, batch, trainer.gen_plan, trainer.multi_plan)
    return {k: float(v) for k, v in m.items()}, _params(state.generator)


def distance_sharded_step(batch, mesh=None):
    """One GAN step (SGD, ratio 2) of the tiny trainer at batch 2 with 8
    distances, the multi-distance plan's stack split over ``mesh`` or
    whole, then the eval step: both steps' metrics and the generator's
    ``state_dict``."""
    from ..config import LossConfig
    from ..train.steps import build_eval_step

    trainer = tiny_trainer(distances=8, batch=2)
    state = _sgd_state(trainer)
    multi = trainer.multi_plan if mesh is None else shard_distance_stack(trainer.multi_plan, mesh)
    batch = tuple(torch.from_numpy(a) for a in batch)
    state, m = _step(trainer)(state, batch, trainer.gen_plan, multi)
    ev = build_eval_step(LossConfig(perceptual="none"))(state, batch, trainer.gen_plan, multi)
    return ({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in ev.items()},
            _params(state.generator))


def collectives_formulas(x: np.ndarray, w: np.ndarray, mesh=None) -> Dict[str, np.ndarray]:
    """Second derivatives through every collective, against their
    one-process equivalents (``mesh`` None):

    * data-parallel: ``y = x / sqrt(sum over the global batch of x^2)``,
      ``L = sum(y * w[0])``, ``g = dL/dx`` with ``create_graph``, then
      ``d(sum g^2)/dw`` summed over the ranks (``all_reduce``);
    * replicated: ``Y = X^2`` through scatter, all-to-all and gather, and
      ``Z = X * p(p+1)/2`` through copy and reduce (rank r scales by
      r + 1), ``L = sum((Y + Z) * w)``, the same two derivatives.
    Returns g (this rank's rows, data-parallel), the data-parallel dw, the
    replicated g and dw."""
    group = None if mesh is None else mesh.group
    p, r = (1, 0) if mesh is None else C.world(group)
    out = {}
    wt = torch.from_numpy(w).requires_grad_(True)
    xt = torch.from_numpy(x)
    local = xt if mesh is None else shard_batch(xt, mesh)
    local = local.clone().requires_grad_(True)
    s = (local * local).sum(0)
    s = s if group is None else C.all_reduce(s, group)
    loss = (local / torch.sqrt(s) * wt[0]).sum()
    (g,) = torch.autograd.grad(loss, local, create_graph=True)
    (dw,) = torch.autograd.grad((g * g).sum(), wt)
    if group is not None:
        torch.distributed.all_reduce(dw, group=group)
    out["dp_g"], out["dp_dw"] = g.detach().numpy(), dw.numpy()

    xr = torch.from_numpy(x).requires_grad_(True)
    if group is None:
        y = xr * xr
        z = xr * (p * (p + 1) / 2)
    else:
        y = C.gather(C.all_to_all(C.scatter(xr, 0, group) ** 2, 1, 0, group), 1, group)
        z = C.reduce_from_ranks(C.copy_to_ranks(xr, group) * float(r + 1), group)
    loss = ((y + z) * wt).sum()
    (g,) = torch.autograd.grad(loss, xr, create_graph=True)
    (dw,) = torch.autograd.grad((g * g).sum(), wt)
    out["rep_g"], out["rep_dw"] = g.detach().numpy(), dw.numpy()
    return out


def propagation(spec: dict, mesh=None) -> Dict[str, np.ndarray]:
    """The spatial and distance-sharded propagation checks on ``spec``'s
    inputs (one device when ``mesh`` is None): the pencil FFT and its round
    trip, ``sharded_propagate_batch_multi``, the train step's spectral
    triple, a focal stack's gradient and the spectrum-loss and low-pass
    primitives with their gradients through a plan bound to ``mesh``, and
    the distance-sharded focal stack, all-distance and random-distance
    reconstructions with a gradient through each."""
    from ..config import OpticsConfig
    from ..ops import asm
    from . import fft as pfft

    t = {k: torch.from_numpy(np.array(v)) for k, v in spec.items()}
    out = {}
    if mesh is None:
        out["fft2"] = torch.fft.fft2(t["x"]).numpy()
        out["roundtrip"] = t["x_rt"].numpy()
    else:
        out["fft2"] = pfft.sharded_fft2(t["x"], mesh).numpy()
        out["roundtrip"] = pfft.sharded_fft2(pfft.sharded_fft2(t["x_rt"], mesh), mesh, inverse=True).numpy()

    optics = OpticsConfig(rows=16, cols=16, pad_size=8, filter_radius_coefficient=0.45)
    plan = asm.make_plan(optics, distances=np.linspace(4e-4, 1e-3, 3), device="cpu", cache_h=False)
    if mesh is None:
        out["spatial_stack"] = asm.propagate_batch_multi(plan, t["amp"], t["phs"]).numpy()
    else:
        out["spatial_stack"] = pfft.sharded_propagate_batch_multi(plan, t["amp"], t["phs"], mesh).numpy()

    bound = asm.make_plan(optics, distances=np.linspace(-4e-4, 0.0, 5)[:-1], device="cpu").with_spatial(mesh)
    hat = asm.propagate_poh2freq_forward(bound, t["poh"])
    tgt = asm.filter_ap2filtered_freq(bound, t["amp"], t["phs"])
    out["spectrum_rows"] = np.array([hat.shape[-2], tgt.shape[-2]])  # this rank's share of the padded rows
    a, p = asm.freq2ap_random_distances(bound, torch.cat([hat, tgt]), t["idx"])
    out["triple_amp"], out["triple_phs"] = a.numpy(), p.numpy()
    amp1 = t["amp"][:1].clone().requires_grad_(True)
    asm.propagate_batch_multi(bound, amp1, t["phs"][:1]).sum().backward()
    out["spatial_grad"] = amp1.grad.numpy()
    amp2, poh2 = (t[k][:1].clone().requires_grad_(True) for k in ("amp", "poh"))
    a2, p2, loss = asm.propagate_poh2ap_forward_with_spectrum_loss(bound, poh2, 0.4)
    low_a, low_p = asm.differentiable_lowpass_filter(bound, amp2, t["phs"][:1], 0.4)
    (a2.sum() + p2.sum() + 100.0 * loss + low_a.sum() + low_p.sum()).backward()
    out.update(spectrum_loss=loss.detach().numpy(), spectrum_amp=a2.detach().numpy(),
               lowpass_amp=low_a.detach().numpy(), spectrum_grads=np.stack([poh2.grad.numpy(), amp2.grad.numpy()]))

    optics4 = OpticsConfig(rows=16, cols=16, pad_size=4, filter_radius_coefficient=0.45)
    dplan = asm.make_plan(optics4, distances=np.linspace(4e-4, 1e-3, 8), device="cpu")
    if mesh is not None:
        dplan = shard_distance_stack(dplan, mesh)
    amp = t["amp"][:1].clone().requires_grad_(True)
    stack = asm.propagate_batch_multi(dplan, amp, t["phs"][:1])
    (stack * t["stack_w"]).sum().backward()
    out["dist_stack"], out["dist_stack_grad"] = stack.detach().numpy(), amp.grad.numpy()
    g0 = torch.complex(t["g_re"], t["g_im"]).requires_grad_(True)
    a_all, p_all = asm.freq2ap_all_distances(dplan, g0)
    a_rnd, p_rnd = asm.freq2ap_random_distances(dplan, g0, t["idx8"])
    (a_all.sum() + p_all.sum() + a_rnd.sum() + 2 * p_rnd.sum()).backward()
    out.update(dist_all_amp=a_all.detach().numpy(), dist_all_phs=p_all.detach().numpy(),
               dist_rnd_amp=a_rnd.detach().numpy(), dist_rnd_phs=p_rnd.detach().numpy(),
               dist_g0_grad=torch.view_as_real(g0.grad).numpy())
    return out


def fail_on_rank(rank: int, world_size: int, bad: int) -> int:
    """Raise on rank ``bad`` (the launcher's failure report)."""
    if rank == bad:
        raise RuntimeError(f"rank {rank} asked to fail")
    return rank


def mesh_helpers(rank: int, mesh) -> dict:
    """The hybrid mesh's layout from this rank, and a state initialized
    from this rank's own seed after ``replicate_state``: every rank's
    must be rank 0's (seed 0)."""
    from .mesh import make_hybrid_mesh, replicate_state

    slices = 2 if mesh.shape[0] % 2 == 0 else 1
    hybrid = make_hybrid_mesh(slices)
    trainer = tiny_trainer(batch=2)
    state = replicate_state(_sgd_state(trainer, seed=rank), mesh)
    return dict(hybrid=(hybrid.axis_names, hybrid.shape, hybrid.coords,
                        [hybrid.axis(n)[1:] for n in hybrid.axis_names]),
                params=_params(state.generator), rng=state.rng.get_state().numpy())


def run(rank: int, world_size: int, spec: dict) -> Optional[dict]:
    """Every check of one world size on one spawn: each part of ``spec``
    that is present runs.  Rank 0 returns the results; every rank returns
    the replicated results, which the caller holds to rank 0's."""
    mesh = make_mesh(world_size)
    out = {"mesh": mesh_helpers(rank, mesh)}
    if "propagation" in spec:
        out["propagation"] = propagation(spec["propagation"], mesh)
    if "collectives" in spec:
        out["collectives"] = collectives_formulas(*spec["collectives"], mesh=mesh)
    if "dp" in spec:
        out["dp"] = {cb: dp_steps(spec["dp"], cb, mesh) for cb in spec.get("dp_batchings", ("separate",))}
    if "carried" in spec:
        out["carried"] = carried_step(*spec["carried"], mesh=mesh)
    if "spatial" in spec:
        out["spatial"] = spatial_step(spec["spatial"], mesh)
    if "distance" in spec:
        out["distance"] = distance_sharded_step(spec["distance"], mesh)
    if "dryrun" in spec:
        from ..multichip_dryrun import dryrun_rank

        out["dryrun"] = dryrun_rank(rank, world_size)
    out["rank"] = rank
    return out
