"""What holds K5 (both element types) and K4 back, read by ablation on one
Hopper GPU.

    python3 -m learned_hologram_gan_tpu_torch.k5_ablation [k5] [k4]

Builds ``csrc/k5_residual_block.cu`` as it ships, and again with parts of
the kernel's work compiled out: ``LHG_ABLATE_MMA`` drops the wgmma
products (the ring, the copies, the float32 fragment loads and split, and
the epilogue stay), ``LHG_ABLATE_A`` the A tiles' copies (the producer's
im2col gather), ``LHG_ABLATE_B`` the B tiles' bulk copies (the weights,
and in float32 their hi and lo, read from L2 for every tile),
``LHG_ABLATE_STORE`` the epilogue's stores (skipped at run time, so that
nothing before them is dropped).  It then times
each build's C entry (both launches) by CUDA events on the full-width
UNet's nine blocks at batch 16, in bfloat16 and in float32, with the cuDNN
chain of the same type beside them (TF32 off in float32), and prints
ptxas' registers and spills of each tile width's kernel.  Then K4 at the
training focal stack's shape (B 4, C 3, 1024^2, 20 distances), as it
ships and with ``LHG_ABLATE_SINCOS`` (H's sincos replaced by two moves),
beside its byte bound.  The differences say what each part of the work
costs.  An ablated build computes a wrong result; nothing but this script
loads one.  ``k5`` or ``k4`` runs that part alone (both by default).  It
needs the card and nvcc; it exits non-zero without them.
"""

from __future__ import annotations

import concurrent.futures
import subprocess
import sys

import numpy as np
import torch

from .fft_ablation import _kernels_built_with, _label, _ptxas

BATCH = 16
BUILDS = ((), ("LHG_ABLATE_MMA",), ("LHG_ABLATE_A",), ("LHG_ABLATE_B",), ("LHG_ABLATE_STORE",),
          ("LHG_ABLATE_MMA", "LHG_ABLATE_A"), ("LHG_ABLATE_MMA", "LHG_ABLATE_A", "LHG_ABLATE_B"))
K4_BUILDS = ((), ("LHG_ABLATE_SINCOS",))
MANGLED = {torch.bfloat16: "13__nv_bfloat16", torch.float32: "f"}


def k5_blocks(card, dtype):
    """Each build's C entry on the nine blocks in ``dtype``, beside the
    cuDNN chain."""
    from .fused_smoke import UNET_BLOCKS, k5_flops, k5_work
    from .ops.cuda import conv_block
    from .utils.cuda_measure import bound_ms, cuda_ms

    name = str(dtype)[6:]
    print(f"K5 {name} by block, batch {BATCH}, ms by CUDA events (mean of 5; TFLOP/s)", flush=True)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    totals = [0.0] * (len(BUILDS) + 2)
    for block, hw, cin, c in UNET_BLOCKS:
        def draw(*s, scale=1.0):
            return torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(dev)

        x = draw(BATCH, hw, hw, cin).abs().to(dtype)
        args = (draw(3, 3, cin, c, scale=(9 * cin) ** -0.5).to(dtype), draw(c, scale=0.1),
                draw(3, 3, c, c, scale=(9 * c) ** -0.5).to(dtype), draw(c, scale=0.1),
                draw(cin, c, scale=cin ** -0.5).to(dtype), draw(c, scale=0.1))
        prepped = conv_block.prepare(x, *args)
        y1 = torch.empty((BATCH, hw, hw, c), device=dev, dtype=dtype)
        out = torch.empty_like(y1)
        tf = k5_flops(BATCH, hw, hw, cin, c) / 1e9
        cells = []
        for k, defines in enumerate(BUILDS):
            with _kernels_built_with(conv_block, "_kernel_fn", defines):
                ms = cuda_ms(lambda: conv_block.launch(*prepped, y1, out), iters=5)
            totals[k] += ms
            cells.append(f"{_label(defines)} {ms:.3f} ({tf / ms:.0f})")
        ms = cuda_ms(lambda: conv_block.residual_block_reference(x, *args), iters=5)
        totals[-2] += ms
        totals[-1] += bound_ms(*k5_work(BATCH, hw, hw, cin, c, dtype.itemsize))[0]
        cells.append(f"cuDNN chain {ms:.3f} ({tf / ms:.0f})")
        print(f"  {block:10s} {hw:3d}^2 {cin:4d} -> {c:4d}: " + " | ".join(cells) + f" [{card}]",
              flush=True)
        del x, args, prepped, y1, out
    print(f"  nine blocks, {name}: " + " | ".join(f"{_label(d)} {t:.3f}" for d, t in
                                                  zip(BUILDS, totals))
          + f" | cuDNN chain {totals[-2]:.3f} | bound {totals[-1]:.3f} [{card}]", flush=True)
    torch.cuda.empty_cache()


def k4_stack(card):
    """K4 as shipped and without its sincos, at the training focal stack's
    shape, beside its byte bound."""
    from .fused_smoke import K4_BATCH, K4_DISTANCES, PAD, ROWS, k4_work
    from .config import OpticsConfig
    from .ops import asm
    from .ops.cuda import transfer
    from .train_smoke import _random_complex
    from .utils.cuda_measure import bound_ms, cuda_ms

    plan = asm.make_plan(OpticsConfig(rows=ROWS, cols=ROWS, pad_size=PAD,
                                      filter_radius_coefficient=0.45),
                         distances=K4_DISTANCES, device="cuda")
    g0 = _random_complex(np.random.default_rng(13), (K4_BATCH, 3, plan.padded_rows,
                                                     plan.padded_cols), "cuda")
    args = (g0, plan.w_grid, plan.mask, plan.distances)
    cells = []
    for defines in K4_BUILDS:
        with _kernels_built_with(transfer, "_kernel_fn", defines):
            cells.append(f"{_label(defines)} {cuda_ms(lambda: transfer.apply_transfer_stack(*args)):.3f}")
    bound, kind = bound_ms(*k4_work(K4_BATCH, len(K4_DISTANCES), plan.padded_rows * plan.padded_cols))
    print(f"K4 ({K4_BATCH}, 3, {plan.padded_rows}, {plan.padded_cols}) x {len(K4_DISTANCES)} "
          f"distances, ms by CUDA events (mean of 10): " + " | ".join(cells)
          + f" | bound {bound:.3f} ({kind}) [{card}]", flush=True)


def main(argv=None) -> int:
    parts = set(sys.argv[1:] if argv is None else argv) or {"k5", "k4"}
    if not parts <= {"k5", "k4"}:
        print(f"k5_ablation: parts are k5 and k4, got {sorted(parts)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k5_ablation: no CUDA device", file=sys.stderr)
        return 1
    from .ops.cuda import build, conv_block, transfer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = ([(conv_block.KERNEL_NAME, d) for d in BUILDS] * ("k5" in parts)
              + [(transfer.KERNEL_NAME, d) for d in K4_BUILDS] * ("k4" in parts))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        logs = list(pool.map(lambda b: build.build_library(*b).log, builds))
    for (name, defines), log in zip(builds, logs):
        if name != conv_block.KERNEL_NAME:
            continue
        for dtype, mangled in MANGLED.items():
            regs = ", ".join(f"BN {bn}: {r[0]} registers, {r[1]} B spilled" for bn in (64, 128, 256)
                             for r in [_ptxas(log, f"conv_wgmma_kernelI{mangled}Li{bn}E")]
                             if r is not None)
            print(f"  {_label(defines)}, {str(dtype)[6:]}: {regs}", flush=True)
    if "k5" in parts:
        for dtype in MANGLED:
            k5_blocks(card, dtype)
    if "k4" in parts:
        k4_stack(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
