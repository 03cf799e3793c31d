"""What holds K5's bfloat16 kernel back, read by ablation on one Hopper GPU.

    python3 -m learned_hologram_gan_tpu_torch.k5_ablation

Builds ``csrc/k5_residual_block.cu`` as it ships, and again with parts of
the bfloat16 kernel's work compiled out: ``LHG_ABLATE_MMA`` drops the wgmma
products (the ring, the copies and the epilogue stay), ``LHG_ABLATE_A`` the
A tiles' copies (the producer's im2col gather), ``LHG_ABLATE_STORE`` the
epilogue's stores.  It then times each build's C entry (both launches) by
CUDA events on the full-width UNet's nine blocks at batch 16, with the
cuDNN bfloat16 chain beside them, and prints ptxas' registers and spills of
each tile width's kernel.  The differences say what each part of the work
costs.  An ablated build computes a wrong result; nothing but this script
loads one.  It needs the card and nvcc; it exits non-zero without them.
"""

from __future__ import annotations

import concurrent.futures
import subprocess
import sys

import numpy as np
import torch

from .fft_ablation import _kernels_built_with, _label, _ptxas

BATCH = 16
BUILDS = ((), ("LHG_ABLATE_MMA",), ("LHG_ABLATE_A",), ("LHG_ABLATE_STORE",),
          ("LHG_ABLATE_MMA", "LHG_ABLATE_A"))


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_ablation: no CUDA device", file=sys.stderr)
        return 1
    from .fused_smoke import UNET_BLOCKS, k5_flops
    from .ops.cuda import build, conv_block
    from .utils.cuda_measure import cuda_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as pool:
        logs = list(pool.map(lambda d: build.build_library(conv_block.KERNEL_NAME, d).log, BUILDS))
    for defines, log in zip(BUILDS, logs):
        regs = ", ".join(f"BN {bn}: {r[0]} registers, {r[1]} B spilled" for bn in (64, 128, 256)
                         for r in [_ptxas(log, f"conv_wgmma_kernelILi{bn}E")] if r is not None)
        print(f"  {_label(defines)}: {regs}", flush=True)

    print(f"K5 bf16 by block, batch {BATCH}, ms by CUDA events (mean of 5; TFLOP/s)", flush=True)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    totals = [0.0] * (len(BUILDS) + 1)
    for name, hw, cin, c in UNET_BLOCKS:
        def draw(*s, scale=1.0):
            return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(dev)

        x = draw(BATCH, hw, hw, cin).abs().bfloat16()
        args = (draw(3, 3, cin, c, scale=(9 * cin) ** -0.5).bfloat16(), draw(c, scale=0.1),
                draw(3, 3, c, c, scale=(9 * c) ** -0.5).bfloat16(), draw(c, scale=0.1),
                draw(cin, c, scale=cin ** -0.5).bfloat16(), draw(c, scale=0.1))
        prepped = conv_block.prepare(x, *args)
        y1 = torch.empty((BATCH, hw, hw, c), device=dev, dtype=torch.bfloat16)
        out = torch.empty_like(y1)
        tf = k5_flops(BATCH, hw, hw, cin, c) / 1e9
        cells = []
        for k, defines in enumerate(BUILDS):
            with _kernels_built_with(conv_block, "_kernel_fn", defines):
                ms = cuda_ms(lambda: conv_block.launch(*prepped, y1, out), iters=5)
            totals[k] += ms
            cells.append(f"{_label(defines)} {ms:.3f} ({tf / ms:.0f})")
        ms = cuda_ms(lambda: conv_block.residual_block_reference(x, *args), iters=5)
        totals[-1] += ms
        cells.append(f"cuDNN chain {ms:.3f} ({tf / ms:.0f})")
        print(f"  {name:10s} {hw:3d}^2 {cin:4d} -> {c:4d}: " + " | ".join(cells) + f" [{card}]",
              flush=True)
        del x, args, prepped, y1, out
    print("  nine blocks: " + " | ".join(f"{_label(d)} {t:.3f}" for d, t in zip(BUILDS, totals))
          + f" | cuDNN chain {totals[-1]:.3f} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
