"""Process groups as meshes, and the sharding helpers (counterpart of
``learned_hologram_gan_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets GSPMD insert
the collectives.  The port runs one process per device (``cuda:{local
rank}`` under NCCL, or CPU ranks under gloo), and a :class:`Mesh` records
the process group(s) of its axes.  A rank holds its own rows of a
batch-sharded tensor (:func:`shard_batch`) and a full copy of a
replicated one (:func:`replicate_state`); the train step's collectives
(``train/steps.py``, ``parallel/collectives.py``) give the global
semantics GSPMD gives: gradients averaged over ranks, BatchNorm
statistics over the global batch.

One departure: ``make_mesh(n)`` needs exactly one process per device of
the mesh (NCCL refuses two ranks on one GPU), where the JAX function takes
the first ``n`` devices of however many there are.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ranks: ``axis_names`` with sizes ``shape``, this rank's
    ``coords`` on them, the process group of each axis that holds this
    rank (``axis_groups``) and the group of all the mesh's ranks
    (``group``)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    axis_groups: Tuple[object, ...]
    group: object

    def axis(self, name: str) -> Tuple[object, int, int]:
        """(group, size, this rank's index) of axis ``name``."""
        i = self.axis_names.index(name)
        return self.axis_groups[i], self.shape[i], self.coords[i]


def backend_for(device: str | torch.device) -> str:
    """NCCL for ``cuda``, gloo for ``cpu``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device = "cuda",
    timeout_s: float = 1800.0,
) -> bool:
    """Start the default process group when one is configured.

    * **Launcher**: under ``torchrun`` (``WORLD_SIZE`` and ``MASTER_ADDR``
      in the environment), call with no arguments.
    * **Explicit**: pass all three of ``coordinator_address`` (an init
      method such as ``tcp://localhost:29500`` or ``file:///tmp/store``),
      ``num_processes`` and ``process_id``.

    The backend is NCCL for ``cuda`` (each rank on ``cuda:{LOCAL_RANK}``,
    or on ``cuda:{process_id}`` when explicit) and gloo for ``cpu``.
    Returns True when a group was started, False when nothing is
    configured (the single-process fallback).
    """
    explicit = coordinator_address is not None
    if explicit and (num_processes is None or process_id is None):
        raise ValueError(
            "explicit multi-process init needs all of coordinator_address, "
            "num_processes and process_id"
        )
    env_configured = bool(os.environ.get("WORLD_SIZE")) and bool(os.environ.get("MASTER_ADDR"))
    if not explicit and not env_configured:
        return False
    backend = backend_for(device)
    if backend == "nccl":
        local = process_id if explicit else int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
    timeout = datetime.timedelta(seconds=timeout_s)
    if explicit:
        dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                                rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return True


def local_device(device: str | torch.device) -> torch.device:
    """This rank's device: ``cuda:{local rank}`` for ``cuda``, else
    ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def check_device_count(n: int, device: str | torch.device) -> None:
    """Refuse more ranks than cards: NCCL takes one rank per GPU."""
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(
            f"a mesh of {n} ranks on cuda needs {n} GPUs, this host has "
            f"{torch.cuda.device_count()} (NCCL runs one rank per GPU)"
        )


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """1-D mesh over every rank of the default process group, which must
    hold exactly ``num_devices`` ranks when that is given."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    n = dist.get_world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(
            f"make_mesh({num_devices}) in a process group of {n} ranks: the port runs one "
            "process per device, so start exactly as many ranks as the mesh has devices"
        )
    group = dist.group.WORLD
    return Mesh((axis_name,), (n,), (dist.get_rank(),), (group,), group)


def make_hybrid_mesh(num_slices: int = 1, ici_axis: str = "data", dcn_axis: str = "replica") -> Mesh:
    """2-D (replica x data) mesh: ``num_slices`` groups of consecutive
    ranks (a host's cards, joined by NVLink) along ``ici_axis``, and across
    them the ranks of equal index along ``dcn_axis``.  Shard a batch over
    the data axis with ``shard_batch(batch, mesh, "data")``.  Every rank
    builds every subgroup (``new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs a process group: call initialize_distributed first")
    n, rank = dist.get_world_size(), dist.get_rank()
    if n % num_slices != 0:
        raise ValueError(f"{n} ranks not divisible into {num_slices} slices")
    per = n // num_slices
    slice_groups = [dist.new_group(list(range(s * per, (s + 1) * per))) for s in range(num_slices)]
    replica_groups = [dist.new_group(list(range(i, n, per))) for i in range(per)]
    s, i = divmod(rank, per)
    return Mesh((dcn_axis, ici_axis), (num_slices, per), (s, i),
                (replica_groups[i], slice_groups[s]), dist.group.WORLD)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading axis split over a mesh axis: this rank's rows."""

    mesh: Mesh
    axis_name: str = "data"

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        _, size, index = self.mesh.axis(self.axis_name)
        if n % size:
            raise ValueError(f"a batch of {n} rows does not split into {size} ranks "
                             "(see pad_batch_to_devices)")
        per = n // size
        return slice(index * per, (index + 1) * per)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> BatchSharding:
    """Shard the leading (batch) axis of every array in a batch."""
    return BatchSharding(mesh, axis_name)


def shard_batch(batch, mesh: Mesh, axis_name: str = "data"):
    """This rank's rows of a global batch (a tensor, an array or a tuple
    of them)."""
    sharding = batch_sharding(mesh, axis_name)
    if isinstance(batch, (tuple, list)):
        return type(batch)(x[sharding.rows(x.shape[0])] for x in batch)
    return batch[sharding.rows(batch.shape[0])]


def _broadcast_(t: torch.Tensor, mesh: Mesh, device: torch.device) -> None:
    """Overwrite ``t`` with rank 0's, through ``device`` when ``t`` lives
    elsewhere (NCCL moves device tensors only)."""
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not dist.group.WORLD else 0
    if t.device == device:
        dist.broadcast(t.data, src, group=mesh.group)
        return
    buf = t.detach().to(device)
    dist.broadcast(buf, src, group=mesh.group)
    t.data.copy_(buf.to(t.device))


@torch.no_grad()
def replicate_state(state, mesh: Mesh):
    """Make every rank's :class:`~..train.state.TrainState` rank 0's: both
    networks' parameters and buffers, both optimizers' state, the random
    draws' generator and the step.  Returns ``state`` (updated in place)."""
    device = next(state.generator.parameters()).device
    for module in (state.generator, state.discriminator):
        for t in module.state_dict().values():
            _broadcast_(t, mesh, device)
    for opt in (state.opt_G, state.opt_D):
        for per_param in opt.state.values():
            for t in per_param.values():
                if torch.is_tensor(t):
                    _broadcast_(t, mesh, device)
    rng = state.rng.get_state()
    _broadcast_(rng, mesh, device)
    state.rng.set_state(rng)
    step = torch.tensor([state.step], dtype=torch.int64)
    _broadcast_(step, mesh, device)
    state.step = int(step)
    return state


def shard_distance_stack(plan, mesh: Mesh, axis_name: str = "data"):
    """Split a plan's distance stack over a mesh axis: each rank keeps the
    transfer functions of its own ``D / p`` distances (the cached H stack
    shrinks to that slice) and computes only those planes in
    ``asm.propagate_batch_multi``, ``freq2ap_all_distances`` and
    ``freq2ap_random_distances``; the results join on every rank, equal to
    the unsharded ones.  Grids, masks and the distance values stay whole."""
    _, size, index = mesh.axis(axis_name)
    if plan.distances is None:
        raise ValueError("shard_distance_stack needs a plan with a distance stack")
    d = plan.num_distances
    if d % size:
        raise ValueError(f"{d} distances do not split into {size} ranks")
    per = d // size
    h = None if plan.H is None else plan.H[index * per:(index + 1) * per].contiguous()
    return plan.replace(H=h, distance_shard=(mesh, axis_name))


def pad_batch_to_devices(batch, num_devices: int):
    """Pad the leading axis up to a multiple of the mesh size (edge
    repeat); returns the padded batch and the original size, to slice the
    outputs back down."""

    def pad(x):
        rem = (-x.shape[0]) % num_devices
        if rem == 0:
            return x
        if torch.is_tensor(x):
            return torch.cat([x, x[-1:].expand(rem, *x.shape[1:])], dim=0)
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)

    leaves: Sequence = batch if isinstance(batch, (tuple, list)) else (batch,)
    orig = leaves[0].shape[0]
    if isinstance(batch, (tuple, list)):
        return type(batch)(pad(x) for x in batch), orig
    return pad(batch), orig
