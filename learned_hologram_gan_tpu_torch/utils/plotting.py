"""PNG dumps of focal stacks and training curves (counterpart of
``learned_hologram_gan_tpu/utils/plotting.py``: ``multi_sample_plotter``,
``training_process_visualizer``).

PNGs of images are written by a small encoder on ``zlib`` and ``struct``
(8-bit RGB, no filtering), so the port needs no imaging package.  Pixel
values follow ``matplotlib.pyplot.imsave``: clip to [0, 1], then
``uint8(x * 255)``.  The curves need matplotlib, imported at the call.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png wants (H, W, 3), got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def save_rgb_image(chw: np.ndarray, save_dir: str, title: str) -> str:
    """Save a (3, H, W) float array in [0, 1] as ``save_dir/title.png``."""
    os.makedirs(save_dir, exist_ok=True)
    img = np.clip(np.transpose(np.asarray(chw, dtype=np.float32), (1, 2, 0)), 0.0, 1.0)
    path = os.path.join(save_dir, f"{title}.png")
    write_png(path, (img * 255).astype(np.uint8))
    return path


def multi_sample_plotter(
    tensor: np.ndarray,
    titles: Optional[Sequence[str]] = None,
    save_dir: Optional[str] = None,
) -> List[str]:
    """Save every (3, H, W) sample of an (N, 3, H, W) stack as
    ``{title}.png``, default titles 0..N-1 (reference utilities.py:179-203)."""
    tensor = np.asarray(tensor)
    if titles is None:
        titles = [str(i) for i in range(tensor.shape[0])]
    return [
        save_rgb_image(tensor[i], save_dir or ".", str(titles[i]))
        for i in range(tensor.shape[0])
    ]


def training_process_visualizer(
    json_files: Sequence[str],
    metrics: Sequence[str],
    output_file: str = "plot.png",
    labels: Optional[Sequence[str]] = None,
) -> str:
    """Plot metric curves of history JSONs against ``n_train`` (reference
    utilities.py:506-565); ``metrics`` are '/'-separated key paths such as
    ``train_losses_tensor/G_loss``.  Raises ``ImportError`` where
    matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    for i, json_file in enumerate(json_files):
        with open(json_file) as f:
            data = json.load(f)
        label = labels[i] if labels is not None else os.path.splitext(os.path.basename(json_file))[0]
        for metric in metrics:
            series = data
            for key in metric.split("/"):
                series = series[key]
            plt.plot(data["n_train"], series, label=f"{label} - {metric.split('/')[-1]}")
    plt.xlabel("Number of Training Samples")
    plt.ylabel("Value")
    plt.title(metrics[-1].split("/")[-1])
    plt.legend(loc="best")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(output_file)
    plt.close()
    return output_file
