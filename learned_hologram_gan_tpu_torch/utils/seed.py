"""Reproducibility helper (reference utilities.set_seed, utilities.py:385-400;
counterpart of the JAX package's ``utils/seed.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy's and Python's global RNGs and torch's default generators
    (CPU and every CUDA device), and return a CPU ``torch.Generator`` seeded
    with ``seed`` for explicit draws, as the JAX package returns its root
    key."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
