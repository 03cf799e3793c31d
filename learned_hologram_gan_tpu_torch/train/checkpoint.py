"""Checkpoints (counterpart of ``learned_hologram_gan_tpu/train/checkpoint.py``).

Two layers, as in the JAX package:

* **Per-network files** (:func:`save_generator`, :func:`save_discriminator`,
  :func:`load_generator`, :func:`load_discriminator`,
  :func:`load_generator_part`), with the reference's ``_epoch{n}`` naming
  (watermelon.py:361-374).  A path ending in ``.msgpack`` is flax's format,
  ``{"params", "batch_stats"}`` as the JAX package's ``_write`` /
  ``_read`` hold it (read and written by :mod:`.flax_msgpack`, the layouts
  mapped by ``convert.py``), so the two packages read each other's files;
  any other path is the module's torch ``state_dict``.  These feed
  ``pretrained_model_path_G/D``, ``pretrained_part1/2_path`` and the
  two-stage pretrain -> fine-tune workflow.
* **Full-state checkpoints** (:func:`save_train_state`,
  :func:`restore_train_state`, :func:`restore_latest`,
  :func:`prune_checkpoints`): ``directory/step_{n}/train_state.pt`` holds
  both networks (BatchNorm statistics and counters included), both Adam
  ``state_dict``s, the ``torch.Generator`` state and the step, the layout
  of the JAX package's Orbax directories.  A save snapshots the state to
  the CPU, writes it into a temporary directory and renames it into place
  (``os.replace``), as Orbax finalizes, so a restore never sees a partial
  checkpoint; ``wait=False`` leaves the write to a background thread
  (:func:`wait_for_saves` drains it).  The JAX package's Orbax
  directories are not read: Orbax needs JAX.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
from typing import Dict, List, Optional

import torch

from .. import convert
from . import flax_msgpack
from .state import TrainState

STATE_FILE = "train_state.pt"


def epoch_path(path: str, epoch: int) -> str:
    """``foo.pth`` -> ``foo_epoch{n}.pth`` (reference watermelon.py:363)."""
    root, ext = os.path.splitext(path)
    return f"{root}_epoch{epoch}{ext}"


def _is_flax(path: str) -> bool:
    return path.endswith(".msgpack")


def save_weights(path: str, module: torch.nn.Module) -> None:
    """One network's weights: flax variables for ``.msgpack``, else its
    ``state_dict``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if _is_flax(path):
        flax_msgpack.write_file(path, convert.flax_variables(module))
        return
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)


def load_weights(path: str, module: torch.nn.Module) -> None:
    """Load :func:`save_weights`'s file into ``module`` (strict: every leaf must
    have its counterpart, of the same shape)."""
    if _is_flax(path):
        variables = flax_msgpack.read_file(path)
        if not isinstance(variables, dict) or not isinstance(variables.get("params"), dict):
            raise ValueError(f"{path} holds no flax variables (a map with 'params')")
        # the critic's converter also takes FakeDiscriminator's single leaf
        state = convert.discriminator_state_dict(variables)
    else:
        device = next(module.parameters()).device
        state = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(state)


def save_generator(state: TrainState, path: str) -> None:
    save_weights(path, state.generator)


def save_discriminator(state: TrainState, path: str) -> None:
    save_weights(path, state.discriminator)


def load_generator(state: TrainState, path: str) -> TrainState:
    load_weights(path, state.generator)
    return state


def load_discriminator(state: TrainState, path: str) -> TrainState:
    load_weights(path, state.discriminator)
    return state


def load_generator_part(state: TrainState, path: str, part: str) -> TrainState:
    """Load only ``part1`` (RGBD2AP) or ``part2`` (AP2POH) pretrained weights
    (reference generator.py:26-28, RGBD2AP.py:37-41), as written by
    ``train/pretrain.py``: ``{"params": {"unet": ...}, "batch_stats":
    {"unet": ...}}`` for part 1, ``{"params": {"modulation": ...},
    "batch_stats": {}}`` for part 2.

    An ablation can leave a part without parameters (``use_modulation=False``
    swaps AP2POH's symmetric conv for the parameter-less stub); loading into
    it is skipped with a warning, as the JAX package skips it."""
    module = getattr(state.generator, part)
    if not list(module.parameters()):
        print(
            f"WARNING: generator has no parameters under {part!r} (ablation "
            f"stub); skipping pretrained load from {path}"
        )
        return state
    load_weights(path, module)
    print(f"Generator {part} loaded from {path}")
    return state


# ---------------------------------------------------------------------------
# Full-state checkpoints
# ---------------------------------------------------------------------------

# One writer thread for the process, as the JAX package keeps one Orbax
# checkpointer: saves finalize in the order they were made.
_WRITER: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: List[concurrent.futures.Future] = []


def _cpu_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_copy(v) for v in tree]
    return tree


def _snapshot(state: TrainState) -> Dict:
    """Everything a resumed run needs, copied to the CPU (the steps that
    follow change the live tensors in place)."""
    return _cpu_copy(dict(
        step=int(state.step),
        generator=state.generator.state_dict(),
        discriminator=state.discriminator.state_dict(),
        opt_G=state.opt_G.state_dict(),
        opt_D=state.opt_D.state_dict(),
        rng=state.rng.get_state(),
    ))


def _write_state(snapshot: Dict, path: str) -> None:
    parent = os.path.dirname(path)
    tmp = os.path.join(parent, f".tmp_{os.path.basename(path)}_{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(snapshot, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):  # a re-save of the same step replaces it
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_train_state(
    state: TrainState,
    directory: str,
    step: Optional[int] = None,
    wait: bool = True,
) -> str:
    """Write the full train state under ``directory/step_{n}``.

    The state is copied to the CPU before this returns; ``wait=False``
    leaves the write and the rename to the writer thread, so the next epoch
    overlaps it.  Call :func:`wait_for_saves` before shutdown."""
    global _WRITER
    step = int(state.step) if step is None else step
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if _WRITER is None:
        _WRITER = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    _PENDING.append(_WRITER.submit(_write_state, _snapshot(state), path))
    if wait:
        wait_for_saves()
    return path


def wait_for_saves() -> None:
    """Block until every :func:`save_train_state` has been finalized; raise
    the first write's error, if any."""
    while _PENDING:
        _PENDING.pop(0).result()


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load ``path`` (a ``step_{n}`` directory) into ``state`` in place:
    both networks, both optimizers, the generator of random draws and the
    step, bit for bit."""
    snap = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    state.generator.load_state_dict(snap["generator"])
    state.discriminator.load_state_dict(snap["discriminator"])
    state.opt_G.load_state_dict(snap["opt_G"])
    state.opt_D.load_state_dict(snap["opt_D"])
    state.rng.set_state(snap["rng"])
    state.step = int(snap["step"])
    return state


def _step_dirs(directory: str) -> List[tuple]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    return sorted(steps)


def latest_step_dir(directory: str) -> Optional[str]:
    steps = _step_dirs(directory)
    return os.path.join(directory, steps[-1][1]) if steps else None


def restore_latest(directory: str, state: TrainState) -> Optional[TrainState]:
    """Resume-from-latest on restart; None if no checkpoint exists."""
    path = latest_step_dir(directory)
    if path is None:
        return None
    return restore_train_state(path, state)


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    """Delete all but the ``keep`` newest ``step_*`` checkpoints; ``keep=0``
    deletes every one."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    steps = _step_dirs(directory)
    doomed = steps[:-keep] if keep > 0 else steps
    for _, name in doomed:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
