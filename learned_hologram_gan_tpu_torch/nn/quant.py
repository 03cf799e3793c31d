"""Post-training int8 quantization of the eval-mode UNet (counterpart of
``learned_hologram_gan_tpu/nn/quant.py``), NHWC.

Scheme, as in the JAX package: BatchNorm folded into the preceding conv
(``ops/cuda/conv_block.fold_conv_bn``, exact); weights per output channel,
symmetric int8 (``scale = max|w| / 127``); activations per tensor, symmetric
int8, their scales the max-abs that one float32 calibration forward sees at
each conv input.  Two modes:

* dynamic (:func:`quantize_unet` / :func:`unet_apply_quant`): each conv
  quantizes its input, multiplies int8 codes, dequantizes the int32 sums;
  inter-op tensors stay in the compute dtype; the stem (raw RGBD input)
  and the sigmoid head stay float (:data:`_FLOAT_PATHS`);
* full-integer, "q8" (:func:`quantize_unet_q8` / :func:`unet_apply_q8`,
  what the server and the benchmark pipeline run): every conv, stem and
  head included, takes int8 codes and gives int8 codes; each input edge's
  scale is folded into the consuming conv's weights, so the int32 sum
  dequantizes by the weight scale alone.

The int8 products are ``ops/int8.py``'s: im2col + ``torch._int_mm``, exact
int32 sums on both devices.  The packed tree keeps the JAX package's
layouts (``w`` HWIO int8 or the up-conv's ``(cin, 4*cout)`` matrix, ``ws`` and
``b`` ``(cout,)`` float32, ``xs`` and each edge a float32 scalar), so
:func:`save_qtree` / :func:`load_qtree` read and write the same ``.npz`` as
the JAX package's.  A tree's ``w``/``ws``/``b``/``xs`` live on the UNet's
device; its ``edges`` are 0-d float32 tensors on the CPU, scalars the apply
reads without waiting for the device.

One walker (:func:`_walk_unet`) routes every conv and up-conv GEMM of the
module through a callback, for the calibration pass and the dynamic
apply alike, as the JAX walker does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import int8
from ..ops.cuda import conv_block as cb
from .blocks import UNet, full_f32_convs
from .fused_unet import _flax_up_kernel, _max_pool

_INT8_MAX = 127.0

Conv = Callable[[str, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _hwio(conv: torch.nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().float().permute(2, 3, 1, 0)


def _walk_unet(unet: UNet, x: torch.Tensor, conv: Conv, gemm: Conv) -> torch.Tensor:
    """Eval-mode ``UNet.forward`` with ``conv(path, x, w_folded, b_folded)``
    for every 3x3 / 1x1 conv (HWIO kernels, BatchNorm folded) and
    ``gemm(path, x, wmat, bias)`` for every pixel-shuffle up-conv (``wmat``
    the JAX package's ``(cin, 4 * cout)`` matrix, columns (2, 2, cout) with
    cout fastest).  NHWC in and out."""

    def block(name: str, xin: torch.Tensor) -> torch.Tensor:
        m = getattr(unet, name)
        w1, b1 = cb.fold_conv_bn(m.Conv_0, m.BatchNorm_0)
        w2, b2 = cb.fold_conv_bn(m.Conv_1, m.BatchNorm_1)
        y = F.relu(conv(f"{name}.c0", xin, w1, b1))
        y = conv(f"{name}.c1", y, w2, b2)
        sc = conv(f"{name}.sc", xin, _hwio(m.Conv_2), m.Conv_2.bias.detach().float())
        return F.relu(y + sc)

    def up(name: str, xin: torch.Tensor) -> torch.Tensor:
        mod = getattr(unet, name)
        kernel = _flax_up_kernel(mod)  # (2, 2, cin, cout), as flax holds it
        n, h, w, cin = xin.shape
        cout = kernel.shape[-1]
        wmat = kernel.flip(0, 1).permute(2, 0, 1, 3).reshape(cin, 4 * cout)
        y = gemm(name, xin, wmat, mod.bias.detach().float())
        y = y.reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, 2 * h, 2 * w, cout)

    levels = unet.levels
    skips = []
    y = x
    for i in range(levels):
        y = block(f"enc_{i}", y)
        skips.append(y)
        y = _max_pool(y)
    y = block("bottleneck", y)
    if levels > 1:
        y = up("ConvTranspose_0", y)
    for i in reversed(range(1, levels)):
        y = torch.cat([skips[i], y], dim=-1)
        y = block(f"dec_{i}", y)
        if i > 1:
            y = up(f"ConvTranspose_{levels - i}", y)
    y = up(f"ConvTranspose_{levels - 1}", y)
    y = torch.cat([skips[0], y], dim=-1)
    y = block("dec_0", y)
    head = unet.Conv_0
    y = conv("head", y, _hwio(head), head.bias.detach().float())
    return torch.sigmoid(y)


def _float_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """"SAME" conv of NHWC ``x`` by an HWIO kernel plus bias, in x's dtype
    (below float32 the output rounds before the bias adds)."""
    y = cb._conv(x.permute(0, 3, 1, 2), w, b, w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def _float_gemm(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ wmat`` in x's dtype, then the bias tiled over the four shuffle
    phases."""
    return x @ wmat.to(x.dtype) + bias.repeat(4).to(x.dtype)


def _calibrate(unet: UNet, calib_x: torch.Tensor, gemm_out: Optional[Dict[str, float]] = None):
    """One float32 walk over ``calib_x``: per path the max |input| and the
    folded (w, b) as float32 numpy arrays; with ``gemm_out``, each up-conv
    output's max |value| too."""
    absmax: Dict[str, float] = {}
    folded: Dict[str, tuple] = {}

    def record(path, xin, w, b):
        absmax[path] = max(absmax.get(path, 0.0), float(xin.abs().max()))
        folded[path] = (np.ascontiguousarray(w.cpu().numpy()), b.cpu().numpy())

    def conv(path, xin, w, b):
        record(path, xin, w, b)
        return _float_conv(xin, w, b)

    def gemm(path, xin, wmat, bias):
        record(path, xin, wmat, bias)
        y = _float_gemm(xin, wmat, bias)
        if gemm_out is not None:
            gemm_out[path] = max(gemm_out.get(path, 0.0), float(y.abs().max()))
        return y

    with torch.no_grad(), full_f32_convs():
        _walk_unet(unet, calib_x.float(), conv, gemm)
    return absmax, folded


def _weight_scales(w: np.ndarray, floor: float) -> tuple:
    """Per-output-channel (last axis) scale and int8 codes of ``w``."""
    ws = np.maximum(np.max(np.abs(w), axis=tuple(range(w.ndim - 1))), floor) / _INT8_MAX
    wq = np.clip(np.round(w / ws), -_INT8_MAX, _INT8_MAX).astype(np.int8)
    return ws, wq


# ---------------------------------------------------------------------------
# The dynamic mode
# ---------------------------------------------------------------------------

#: conv paths kept in float (the standard PTQ carve-outs): the raw-input
#: stem conv and its shortcut, and the sigmoid head
_FLOAT_PATHS = ("enc_0.c0", "enc_0.sc", "head")


def quantize_unet(unet: UNet, calib_x: torch.Tensor, *, float_paths: tuple = _FLOAT_PATHS) -> Dict:
    """Calibrate and pack an int8 UNet from an eval-mode :class:`UNet`.

    ``calib_x`` is a representative NHWC batch.  Per conv path ``{"w": int8,
    "ws": (cout,), "b": (cout,), "xs": ()}`` or, for ``float_paths``, the
    folded float32 ``{"w", "b"}``; up-conv GEMMs pack their ``(cin,
    4 * cout)`` matrix the same way.  Tensors on the UNet's device."""
    absmax, folded = _calibrate(unet, calib_x)
    dev = calib_x.device
    qtree: Dict[str, Dict] = {}
    for path, (w, b) in folded.items():
        if path in float_paths:
            qtree[path] = {"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)}
            continue
        ws, wq = _weight_scales(w, 1e-12)
        xs = np.float32(max(absmax[path], 1e-12) / _INT8_MAX)
        qtree[path] = {k: torch.from_numpy(np.asarray(v)).to(dev)
                       for k, v in (("w", wq), ("ws", ws), ("b", b), ("xs", xs))}
    return qtree


def _quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -_INT8_MAX, _INT8_MAX).to(torch.int8)


@torch.no_grad()
def unet_apply_quant(qtree: Dict, unet: UNet, x: torch.Tensor, *,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Eval-mode UNet forward with int8 convs, NHWC in, float32 NHWC out.

    ``unet`` gives the structure (level count); every conv and GEMM uses
    the packed ``qtree``.  Inter-op tensors stay in ``dtype``."""

    def conv(path, xin, w_unused, b_unused):
        q = qtree[path]
        if "ws" not in q:  # a float carve-out
            return _float_conv(xin.to(dtype), q["w"].to(dtype), q["b"])
        y = int8.conv2d(_quantize_act(xin, q["xs"]), q["w"])
        return (y.float() * (q["xs"] * q["ws"]) + q["b"]).to(dtype)

    def gemm(path, xin, wmat_unused, bias_unused):
        q = qtree[path]
        if "ws" not in q:
            return _float_gemm(xin.to(dtype), q["w"], q["b"])
        xq = _quantize_act(xin, q["xs"])
        y = int8.matmul(xq.reshape(-1, xq.shape[-1]), q["w"]).reshape(*xq.shape[:-1], -1)
        return (y.float() * (q["xs"] * q["ws"]) + q["b"].repeat(4)).to(dtype)

    with full_f32_convs():
        return _walk_unet(unet, x.to(dtype), conv, gemm).float()


# ---------------------------------------------------------------------------
# The full-integer ("q8") mode: int8 codes between ops, per-edge scales
# folded into the consuming conv's weights.  A conv is linear in its input,
# so each input edge's scale folds in per input channel before the weights
# quantize; a concatenation of two branches with their own scales costs
# nothing.  Requantization targets each edge's calibrated scale, ReLU folds
# into the requant clip, and a max pool of non-negative codes keeps its
# producer's scale.
# ---------------------------------------------------------------------------


def _edge_scales(levels: int, in_absmax: Dict, gemm_out_absmax: Dict) -> Dict[str, float]:
    """Per-tensor int8 scale of every inter-op edge, from calibration: each
    tensor's consuming conv recorded its max |input| (pooling keeps the max
    of non-negative block outputs); up-conv outputs, seen only
    concatenated, record their own."""

    def s(v):
        return max(float(v), 1e-12) / _INT8_MAX

    edges = {"in": s(in_absmax["enc_0.c0"])}
    names = [f"enc_{i}" for i in range(levels)] + ["bottleneck"] + [
        f"dec_{i}" for i in range(levels - 1, -1, -1)]
    for name in names:
        edges[f"{name}.mid"] = s(in_absmax[f"{name}.c1"])  # post-ReLU conv1 out
    for i in range(levels - 1):
        edges[f"enc_{i}.out"] = s(in_absmax[f"enc_{i + 1}.c0"])
    edges[f"enc_{levels - 1}.out"] = s(in_absmax["bottleneck.c0"])
    edges["bottleneck.out"] = s(in_absmax["ConvTranspose_0"])
    for i in range(levels - 1, 0, -1):
        edges[f"dec_{i}.out"] = s(in_absmax[f"ConvTranspose_{levels - i}"])
    edges["dec_0.out"] = s(in_absmax["head"])
    for name, v in gemm_out_absmax.items():
        edges[f"{name}.out"] = s(v)
    return edges


def _in_edge_scale_vec(path: str, cin: int, edges: Dict[str, float], levels: int) -> np.ndarray:
    """Per-input-channel float32 scale of a conv / GEMM input edge."""
    block, _, leaf = path.partition(".")

    def full(key):
        return np.full(cin, edges[key], np.float32)

    if path in ("enc_0.c0", "enc_0.sc"):
        return full("in")
    if leaf == "c1":
        return full(f"{block}.mid")
    if block.startswith("enc_") and leaf in ("c0", "sc"):
        return full(f"enc_{int(block[4:]) - 1}.out")
    if block == "bottleneck":
        return full(f"enc_{levels - 1}.out")
    if block.startswith("dec_") and leaf in ("c0", "sc"):
        i = int(block[4:])
        up = "ConvTranspose_0" if i == levels - 1 else f"ConvTranspose_{levels - 1 - i}"
        c_up = cin // 2  # a decoder's input is half skip, half up
        return np.concatenate([np.full(cin - c_up, edges[f"enc_{i}.out"], np.float32),
                               np.full(c_up, edges[f"{up}.out"], np.float32)])
    if path == "head":
        return full("dec_0.out")
    if path.startswith("ConvTranspose_"):
        k = int(path.split("_")[1])
        src = "bottleneck" if k == 0 else f"dec_{levels - k}" if k < levels - 1 else "dec_1"
        return full(f"{src}.out")
    raise KeyError(path)


def quantize_unet_q8(unet: UNet, calib_x: torch.Tensor) -> Dict:
    """Calibrate and pack the full-integer int8 UNet.

    Per conv path ``{"w": int8, "ws": (cout,), "b": (cout,)}`` with every
    input edge's scale folded into ``w`` / ``ws``, plus ``"edges"``, the
    per-tensor requantization scales."""
    gemm_out: Dict[str, float] = {}
    in_absmax, folded = _calibrate(unet, calib_x, gemm_out)
    levels = unet.levels
    edges = _edge_scales(levels, in_absmax, gemm_out)
    dev = calib_x.device
    qtree: Dict[str, Any] = {"edges": {k: torch.tensor(np.float32(v)) for k, v in edges.items()}}
    for path, (w, b) in folded.items():
        cin_axis = w.ndim - 2  # HWIO convs: axis 2; (cin, 4 cout) GEMMs: axis 0
        cin = w.shape[cin_axis]
        svec = _in_edge_scale_vec(path, cin, edges, levels)
        w_t = w * svec.reshape(tuple(cin if a == cin_axis else 1 for a in range(w.ndim)))
        ws, wq = _weight_scales(w_t, 1e-30)
        qtree[path] = {k: torch.from_numpy(np.asarray(v)).to(dev)
                       for k, v in (("w", wq), ("ws", ws.astype(np.float32)), ("b", b))}
    return qtree


def _levels(qtree: Dict) -> int:
    return sum(1 for k in qtree if k.startswith("enc_") and k.endswith(".c0"))


@torch.no_grad()
def unet_apply_q8(qtree: Dict, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode UNet forward through the full-integer pipeline, NHWC in,
    float32 (post-sigmoid) NHWC out.  Structure and scales all come from
    ``qtree`` (:func:`quantize_unet_q8` or :func:`load_qtree`)."""
    # v * (1 / scale), the reciprocal rounded to float32 as the JAX
    # package rounds it
    inv = {k: float(np.float32(1.0) / np.float32(v)) for k, v in qtree["edges"].items()}
    levels = _levels(qtree)

    def requant(v: torch.Tensor, edge: str) -> torch.Tensor:
        return torch.clamp(torch.round(v * inv[edge]), -_INT8_MAX, _INT8_MAX).to(torch.int8)

    def qconv(path: str, xq: torch.Tensor) -> torch.Tensor:
        q = qtree[path]
        return int8.conv2d(xq, q["w"]).float() * q["ws"] + q["b"]

    def block(name: str, xq: torch.Tensor) -> torch.Tensor:
        y1 = requant(F.relu(qconv(f"{name}.c0", xq)), f"{name}.mid")
        y = F.relu(qconv(f"{name}.c1", y1) + qconv(f"{name}.sc", xq))
        return requant(y, f"{name}.out")

    def up(name: str, xq: torch.Tensor) -> torch.Tensor:
        q = qtree[name]
        n, h, w, cin = xq.shape
        cout = q["w"].shape[-1] // 4
        y = int8.matmul(xq.reshape(-1, cin), q["w"]).float() * q["ws"] + q["b"].repeat(4)
        y = requant(y, f"{name}.out").reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, 2 * h, 2 * w, cout)

    y = requant(x.float(), "in")
    skips = []
    for i in range(levels):
        y = block(f"enc_{i}", y)
        skips.append(y)
        y = int8.max_pool2x2(y)
    y = block("bottleneck", y)
    if levels > 1:
        y = up("ConvTranspose_0", y)
    for i in reversed(range(1, levels)):
        y = block(f"dec_{i}", torch.cat([skips[i], y], dim=-1))
        if i > 1:
            y = up(f"ConvTranspose_{levels - i}", y)
    y = up(f"ConvTranspose_{levels - 1}", y)
    y = block("dec_0", torch.cat([skips[0], y], dim=-1))
    return torch.sigmoid(qconv("head", y))


# ---------------------------------------------------------------------------
# Size and the .npz artifact
# ---------------------------------------------------------------------------


def quantized_bytes(qtree: Dict) -> int:
    """Total bytes of the packed tree's leaves."""
    return sum(v.numel() * v.element_size() for q in qtree.values() for v in q.values())


def save_qtree(qtree: Dict, path: str) -> None:
    """Write a :func:`quantize_unet_q8` tree as a flat ``.npz``: keys
    ``edges/<name>`` (float32 scalars) and ``<conv path>/{w,ws,b}``, the
    JAX package's ``save_qtree`` file."""
    flat = {f"edges/{k}": v.cpu().numpy() for k, v in qtree["edges"].items()}
    for group, q in qtree.items():
        if group != "edges":
            flat.update({f"{group}/{leaf}": v.cpu().numpy() for leaf, v in q.items()})
    np.savez(path, **flat)


def _conv_paths(levels: int) -> list:
    """Every conv and up-conv path of a ``levels``-level UNet's q8 tree."""
    blocks = [f"enc_{i}" for i in range(levels)] + ["bottleneck"] + [f"dec_{i}" for i in range(levels)]
    paths = [f"{b}.{leaf}" for b in blocks for leaf in ("c0", "c1", "sc")]
    return paths + [f"ConvTranspose_{k}" for k in range(levels)] + ["head"]


def load_qtree(path: str, device: str | torch.device = "cpu") -> Dict:
    """Read :func:`save_qtree`'s ``.npz`` (or the JAX package's) into a q8
    tree on ``device``, every leaf bit for bit.  Raises ``ValueError``
    naming what is missing when the file lacks ``edges/in`` or any conv
    path's ``w``, ``ws`` or ``b``."""
    qtree: Dict[str, Any] = {"edges": {}}
    with np.load(path) as z:
        for key in z.files:
            group, _, leaf = key.partition("/")
            if group == "edges":
                qtree["edges"][leaf] = torch.from_numpy(np.array(z[key], np.float32))
            else:
                qtree.setdefault(group, {})[leaf] = torch.from_numpy(np.array(z[key])).to(device)
    levels = _levels(qtree)
    missing = [] if "in" in qtree["edges"] else ["edges/in"]
    if levels == 0:
        missing.append("enc_0.c0/w")
    for p in _conv_paths(levels):
        missing += [f"{p}/{leaf}" for leaf in ("w", "ws", "b") if leaf not in qtree.get(p, {})]
    if missing:
        raise ValueError(f"{path} is not a full int8 qtree: missing {', '.join(missing)}")
    return qtree
