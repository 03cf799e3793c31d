"""Carry weights between the JAX package's flax trees and the port's modules.

Input: a network's ``{"params": ..., "batch_stats": ...}`` variables as
nested dicts of numpy arrays (how they come out of flax, or out of a
msgpack file read by ``train/flax_msgpack.py``).  Output: a ``state_dict``
for the port's module (the Generator, with the plain or the fourier UNet,
the critic, VGG19, ``nn.blocks``' ResNets, ``MiniUNet`` and ``RGBDUNet``),
whose submodules carry the flax names (a FourierBlock's
``ResidualBlock_0..2``, ``ResNetPOH``'s ``_ResNetBase_0``, ``unet_r/g/b``),
so each leaf maps by its path, however deep:

  conv ``kernel`` (H, W, I, O)            -> ``weight`` (O, I, H, W)
  transposed-conv ``kernel`` (2, 2, I, O) -> ``weight`` (I, O, 2, 2) with the
                                             taps flipped: lax.conv_transpose
                                             flips them, torch does not
  BatchNorm ``scale``/``bias`` + batch_stats ``mean``/``var``
                                          -> ``weight``/``bias``/``running_mean``
                                             /``running_var``
  ``radial_weights``, ``bias``            -> as they are

Every leaf is float32 on both sides whatever the compute dtype: flax keeps
its parameters in float32 under ``dtype="bfloat16"`` and casts them at each
call, and so does the port (nn/blocks.py), so a bfloat16 model carries its
weights exactly as a float32 one does.

:func:`flax_variables` is the inverse, for any of these modules: its
``state_dict`` back to the flax ``{"params", "batch_stats"}`` tree, keys
sorted as the JAX package writes them, BatchNorm's ``num_batches_tracked``
dropped (flax keeps no such counter).
``tools/convert_reference_weights.py`` pins the same mapping.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    # a copy: arrays decoded from a file are read-only views of its bytes
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


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


def discriminator_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The critic's flax variables -> the port critic's ``state_dict``
    (:class:`~.models.discriminator.WGANGPDiscriminator192`, or
    ``FakeDiscriminator``'s single ``a``)."""
    params = variables["params"]
    if set(params) == {"a"}:
        return {"a": _tensor(params["a"])}
    out: Dict[str, torch.Tensor] = {}
    _walk(params, variables.get("batch_stats", {}), "", out)
    return out


def vgg19_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """VGG19's ``{"conv_i": {"kernel", "bias"}}`` flax params (or the
    ``.npz`` layout read into that tree) -> the port
    :class:`~.losses.perceptual.VGG19Features` ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, {}, "", out)
    return out


# ---------------------------------------------------------------------------
# port -> flax
# ---------------------------------------------------------------------------


def _array(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())


def flax_conv_kernel(weight: torch.Tensor) -> np.ndarray:
    """torch OIHW conv weight -> flax HWIO kernel (inverse of :func:`conv_kernel`)."""
    return np.ascontiguousarray(_array(weight).transpose(2, 3, 1, 0))


def flax_conv_transpose_kernel(weight: torch.Tensor) -> np.ndarray:
    """torch ``ConvTranspose2d`` weight (I, O, kh, kw) -> the flax kernel
    (kh, kw, I, O) that ``lax.conv_transpose`` flips (inverse of
    :func:`conv_transpose_kernel`)."""
    return np.ascontiguousarray(_array(weight).transpose(2, 3, 0, 1)[::-1, ::-1])


def _sorted(tree: Dict) -> Dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def _node(tree: Dict, path) -> Dict:
    for key in path:
        tree = tree.setdefault(key, {})
    return tree


def flax_variables(module: torch.nn.Module) -> Dict[str, Dict]:
    """A port module (the Generator or a part of it, the critic) -> its flax
    variables ``{"params", "batch_stats"}``, nested dicts of float32 numpy
    arrays with sorted keys (inverse of :func:`generator_state_dict` and
    :func:`discriminator_state_dict`)."""
    leaves: Dict[Tuple[str, ...], Dict[str, torch.Tensor]] = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        leaves.setdefault(tuple(path), {})[leaf] = value
    params: Dict = {}
    stats: Dict = {}
    for path, leaf in leaves.items():
        p = _node(params, path)
        if "running_mean" in leaf:
            p.update(scale=_array(leaf["weight"]), bias=_array(leaf["bias"]))
            _node(stats, path).update(mean=_array(leaf["running_mean"]), var=_array(leaf["running_var"]))
        elif "weight" in leaf:
            to_kernel = (flax_conv_transpose_kernel if path and path[-1].startswith("ConvTranspose")
                         else flax_conv_kernel)
            p.update(kernel=to_kernel(leaf["weight"]), bias=_array(leaf["bias"]))
        else:  # radial_weights + bias, or FakeDiscriminator's a
            p.update({name: _array(t) for name, t in leaf.items()})
    return {"params": _sorted(params), "batch_stats": _sorted(stats)}
