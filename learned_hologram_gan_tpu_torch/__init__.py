"""PyTorch and CUDA port of ``learned_hologram_gan_tpu`` for NVIDIA Hopper.

RGBD -> phase-only hologram -> focal stack, the WGAN-GP training of the
generator and the fused eval forward (``models.generator_apply_fused``),
with the fused ASM propagation (kernel K1), its backward (K2), the
one-axis FFT (K3), the transfer-stack apply (K4) and the BN-folded
residual block (K5, float32 and bfloat16) written in CUDA (``csrc/``),
in float32 or in bfloat16 (flax's dtype rules).  Imports torch,
numpy and the standard library only; entry points run on ``cuda`` unless
asked for the CPU.  The command-line entry points are ``generate_poh.py``,
``training_model.py``, for the high-resolution path the tools
``tools/eval_quality.py``, ``tools/finetune_highres.py`` and
``tools/highres_train_bench.py``, and for serving ``tools/serve_poh.py``
(float32, bfloat16 or the int8 stage 1 of ``nn/quant.py``),
``tools/bench_serve.py`` and ``tools/eval_quant.py``.
"""

__version__ = "0.1.0"
