"""Carry weights from the JAX package's flax trees into the port's modules.

Input: the generator's ``{"params": ..., "batch_stats": ...}`` variables as
nested dicts of numpy arrays (how they come out of flax, or out of a
msgpack file read by any msgpack reader).  Output: a ``state_dict`` for
:class:`~.models.generator.Generator`, whose submodules carry the flax
names, so each leaf maps by its path:

  conv ``kernel`` (H, W, I, O)            -> ``weight`` (O, I, H, W)
  transposed-conv ``kernel`` (2, 2, I, O) -> ``weight`` (I, O, 2, 2) with the
                                             taps flipped: lax.conv_transpose
                                             flips them, torch does not
  BatchNorm ``scale``/``bias`` + batch_stats ``mean``/``var``
                                          -> ``weight``/``bias``/``running_mean``
                                             /``running_var``
  ``radial_weights``, ``bias``            -> as they are
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def conv_kernel(kernel: np.ndarray) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW weight."""
    return _tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def conv_transpose_kernel(kernel: np.ndarray) -> torch.Tensor:
    """flax (kh, kw, I, O) kernel applied by ``lax.conv_transpose`` -> torch
    ``ConvTranspose2d`` weight (I, O, kh, kw)."""
    return _tensor(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1))


def _walk(params: Mapping, stats: Mapping, prefix: str, out: Dict[str, torch.Tensor]):
    if "kernel" in params:
        name = prefix.rstrip(".").rsplit(".", 1)[-1]
        if name.startswith("ConvTranspose"):
            out[prefix + "weight"] = conv_transpose_kernel(params["kernel"])
        else:
            out[prefix + "weight"] = conv_kernel(params["kernel"])
        out[prefix + "bias"] = _tensor(params["bias"])
        return
    if "scale" in params:
        out[prefix + "weight"] = _tensor(params["scale"])
        out[prefix + "bias"] = _tensor(params["bias"])
        out[prefix + "running_mean"] = _tensor(stats["mean"])
        out[prefix + "running_var"] = _tensor(stats["var"])
        out[prefix + "num_batches_tracked"] = torch.tensor(0)
        return
    if "radial_weights" in params:
        out[prefix + "radial_weights"] = _tensor(params["radial_weights"])
        out[prefix + "bias"] = _tensor(params["bias"])
        return
    for key, sub in params.items():
        _walk(sub, stats.get(key, {}), f"{prefix}{key}.", out)


def generator_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The generator's flax variables -> the port Generator's ``state_dict``.

    Load it with ``model.load_state_dict(sd)`` (strict), which rejects any
    leaf that has no counterpart.
    """
    out: Dict[str, torch.Tensor] = {}
    _walk(variables["params"], variables.get("batch_stats", {}), "", out)
    return out
