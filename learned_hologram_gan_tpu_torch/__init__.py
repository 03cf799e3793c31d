"""PyTorch and CUDA port of ``learned_hologram_gan_tpu`` for NVIDIA Hopper.

RGBD -> phase-only hologram -> focal stack, with the fused ASM propagation
(kernel K1) written in CUDA (``csrc/``).  Imports torch, numpy and the
standard library only; entry points run on ``cuda`` unless asked for the
CPU.  See ``generate_poh.py`` for the command-line entry point.
"""

__version__ = "0.1.0"
