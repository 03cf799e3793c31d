"""Training and inference steps (inference only so far)."""

from .steps import build_infer_fn

__all__ = ["build_infer_fn"]
