"""What holds K1's row pass, K2's row adjoint and K3 back, read by ablation on one Hopper GPU.

    python3 -m learned_hologram_gan_tpu_torch.fft_ablation

Builds K1 and K2 (``csrc/k1_asm_propagate.cu``) and K3 (``csrc/k3_fft.cu``)
as they ship, and again with parts of their work compiled out:
``LHG_ABLATE_H`` makes K1's and K2's H 1 (no sincosf, no w-grid
arithmetic); ``LHG_ABLATE_FFT`` skips the FFT core's passes
(``csrc/fft_hopper.cuh``), so that the loads, the stores and the
per-element work stay.  It then times each build's kernel alone by CUDA
events at the main path's full-width shapes: K1's inference calls (48
planes, D = 1 ``conj_h`` and D = 3 masked), its training call (24 planes
``from_spectrum`` + ``per_plane``) and the eval step's (12 planes, D = 20);
K2's three calls of a train step (24 planes ``from_spectrum`` +
``per_plane``, AP2POH's 12 planes ``conj_h``, the two-H hat's 12 planes
field + ``per_plane`` with a product mask); and one K3 pass of
(12, 1024, 1024) along each axis, beside cuFFT's and a device copy of the
same bytes; then, as shipped, K3's passes in turn (one axis twice, the
two axes chained and independent, ``fft2``, and a train step's 2 ``fft2``
+ 1 adjoint).  The differences say what each part of the work costs.  An
ablated build computes a wrong result; nothing but this script loads one.

It uses only what the package has offered since K2's redesign, so a copy
of it times an earlier checkout too: two checkouts run in turns (A, B, B,
A) in one call compare on one card.

For each build it also prints ptxas' registers and spills, and the blocks
an SM holds as the launch asks for them, derived from those registers, the
block's threads and its shared memory (not measured).  It needs the card
and nvcc; it exits non-zero without them.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import re
import subprocess
import sys

import numpy as np
import torch

ROWS = COLS = 384
PAD = 320
BATCH = 16
DISTANCES = (4e-4, 7e-4, 1e-3)  # generatePOH's focal stack
TRAIN_DISTANCES = np.linspace(-4e-4, 0.0, 21)[:-1]  # trainingModel.py's 20
K1_BUILDS = ((), ("LHG_ABLATE_H",), ("LHG_ABLATE_FFT",), ("LHG_ABLATE_H", "LHG_ABLATE_FFT"))
K3_BUILDS = ((), ("LHG_ABLATE_FFT",))
# Hopper SM: registers, shared memory (1 KB of it reserved per block),
# threads, blocks; registers are allocated per warp in units of 256
SM_REGS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 233472, 2048, 32


def _label(defines):
    return "+".join(d.replace("LHG_ABLATE_", "no ") for d in defines) or "as shipped"


def _ptxas(log, entry):
    """(registers, spill-store bytes) ptxas reports for the first entry
    function whose mangled name contains ``entry``; None without a report."""
    blocks = re.split(r"Compiling entry function '", log)
    for block in blocks[1:]:
        if entry in block.split("'", 1)[0]:
            regs = int(re.search(r"Used (\d+) registers", block).group(1))
            spill = int(re.search(r"(\d+) bytes spill stores", block).group(1))
            return regs, spill
    return None


def _blocks_per_sm(regs, threads, smem):
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return min(SM_REGS // (per_warp * warps), SM_SMEM // (smem + 1024),
               SM_THREADS // threads, SM_BLOCKS)


@contextlib.contextmanager
def _kernels_built_with(module, attr, defines):
    """``module.attr`` (a wrapper's kernel loader) loads the build with
    ``defines`` added to the plan's own inside the block."""
    loader = getattr(module, attr)
    setattr(module, attr, lambda plan_defines=(): loader(tuple(plan_defines) + tuple(defines)))
    try:
        yield
    finally:
        setattr(module, attr, loader)


def _k1_calls(dev):
    """(name, row_pass arguments) of the four K1 calls, the column
    transform already applied, as ``chip_smoke.py`` makes them."""
    from .config import GeneratorConfig, OpticsConfig
    from .models import make_generator_plan
    from .ops import asm

    rng = np.random.default_rng(0)
    gen_plan = make_generator_plan(GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                                   filter_radius_coefficient=0.45), device=dev)
    recon = asm.make_plan(OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                       filter_radius_coefficient=0.35), distances=DISTANCES, device=dev)
    train = asm.make_plan(OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                       filter_radius_coefficient=0.45),
                          distances=TRAIN_DISTANCES, device=dev)

    def draw(shape, scale):
        return torch.from_numpy((scale * rng.random(shape)).astype(np.float32)).to(dev)

    shape = (BATCH, 3, ROWS, COLS)
    spec = torch.complex(*(torch.from_numpy(rng.standard_normal((8, 3, 1024, 1024)).astype(np.float32)).to(dev)
                           for _ in range(2)))
    idx = torch.from_numpy(rng.permutation(len(TRAIN_DISTANCES))[:4]).to(dev)
    sets = [
        ("inference D=1 conj_h", asm.fused_args(gen_plan, asm.field(draw(shape, 1.1), draw(shape, 2 * np.pi)),
                                                gen_plan.distances[:1], conj_h=True, use_mask=False)),
        ("inference D=3 masked", asm.fused_args(recon, asm.field(torch.ones(shape, device=dev),
                                                                 draw(shape, 2 * np.pi)), recon.distances)),
        ("train from_spectrum+per_plane, 24 planes",
         asm.fused_args(train, spec, train.distances[torch.cat([idx, idx])], from_spectrum=True,
                        per_plane=True)),
        ("eval from_spectrum D=20, 12 planes",
         asm.fused_args(train, spec[:4], train.distances, from_spectrum=True)),
    ]
    calls = []
    for name, (fr, fi, wl2, dvec, mask, kcfg) in sets:
        x = torch.complex(fr, fi)
        if not kcfg[2]:  # field input: the wrapper's column transform
            x = torch.fft.fft(torch.nn.functional.pad(x, (PAD, PAD)), dim=-1)
        calls.append((name, (x, wl2, dvec, mask, kcfg)))
    return calls


def _k2_calls(dev):
    """(name, row_adjoint arguments) of a train step's three K2 calls, on a
    seeded cotangent already transformed along its columns, as
    ``train_smoke.py`` makes them."""
    from .config import OpticsConfig
    from .ops import asm

    rng = np.random.default_rng(2)
    optics = OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45)
    train = asm.make_plan(optics, distances=TRAIN_DISTANCES, device=dev)
    gen = asm.make_plan(optics, distances=[1e-3], device=dev)
    idx = torch.from_numpy(rng.permutation(len(TRAIN_DISTANCES))[:4]).to(dev)
    field = torch.ones(4, 3, ROWS, COLS, dtype=torch.complex64, device=dev)
    spec = torch.ones(8, 3, 1024, 1024, dtype=torch.complex64, device=dev)
    sets = [
        ("train from_spectrum+per_plane, 24 planes",
         asm.fused_args(train, spec, train.distances[torch.cat([idx, idx])], from_spectrum=True,
                        per_plane=True)),
        ("AP2POH conj_h D=1, 12 planes",
         asm.fused_args(gen, field, gen.distances[:1], conj_h=True, use_mask=False)),
        ("two-H hat field+per_plane, 12 planes",
         asm.fused_args(train, field, gen.distances[0] + train.distances[idx], per_plane=True,
                        mask_override=gen.mask * train.mask)),
    ]
    calls = []
    for name, (fr, _, wl2, dvec, mask, kcfg) in sets:
        shape = (fr.shape[0], kcfg[4], ROWS, COLS)
        g = torch.complex(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                            for _ in range(2)))
        x = torch.fft.fft(torch.nn.functional.pad(g, (PAD, PAD)), dim=-1)
        calls.append((name, (x, wl2, dvec, mask, kcfg)))
    return calls


def main() -> int:
    if not torch.cuda.is_available():
        print("fft_ablation: no CUDA device", file=sys.stderr)
        return 1
    from .ops.cuda import build, fft, fft_plan, spectral
    from .utils.cuda_measure import bound_ms, cuda_ms, k1_row_pass_work, k2_row_adjoint_work

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    # every build at once, one nvcc each
    jobs = [(name, defines) for name, builds in ((spectral.KERNEL_NAME, K1_BUILDS),
                                                 (fft.KERNEL_NAME, K3_BUILDS)) for defines in builds]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        logs = pool.map(lambda job: build.build_library(*job).log, jobs)
    reports = dict(zip(jobs, logs))

    plan = fft_plan.make_plan(1024)
    print("K1 row pass alone, ms by CUDA events (mean of 20); each call's own bound beside it", flush=True)
    calls = _k1_calls(dev)
    for defines in K1_BUILDS:
        report = _ptxas(reports[spectral.KERNEL_NAME, defines], "asm_row_pass_kernelILi32E")
        cells = []
        with _kernels_built_with(spectral, "_kernel_fns", defines):
            for cname, (x, wl2, dvec, mask, kcfg) in calls:
                ms = cuda_ms(lambda: spectral.row_pass(x, wl2, dvec, mask, kcfg), iters=20, warmup=3)
                cells.append(f"{cname} {ms:.4f}")
        occupancy = ""
        if report is not None:
            regs, spill = report
            per_sm = [_blocks_per_sm(regs, cpb * plan.threads,
                                     cpb * (max(plan.buffer, plan.n) + (plan.n if keep else 0)) * 8)
                      for keep in (False, True) for cpb in [spectral._pick_cpb(plan, keep)]]
            occupancy = (f"; {regs} registers, {spill} B spilled; blocks an SM holds: D = 1 {per_sm[0]} "
                         f"of {spectral._pick_cpb(plan, False) * plan.threads} threads, D > 1 "
                         f"{per_sm[1]} of {spectral._pick_cpb(plan, True) * plan.threads}")
        print(f"  K1 {_label(defines)}: " + ", ".join(cells) + occupancy + f" [{card}]", flush=True)
    for cname, (x, wl2, dvec, mask, kcfg) in calls:
        p, num_d, from_spectrum = x.shape[0], kcfg[4], kcfg[2]
        nbytes, flops = k1_row_pass_work(p, ROWS, kcfg[5], kcfg[6], num_d, mask, from_spectrum)
        b, kind = bound_ms(nbytes, flops)
        print(f"  bound {cname}: {b:.4f} ms ({kind}; {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)",
              flush=True)
    del calls
    torch.cuda.empty_cache()

    print("K2 row adjoint alone, ms by CUDA events (mean of 20); each call's own bound beside it",
          flush=True)
    calls = _k2_calls(dev)
    for defines in K1_BUILDS:
        report = _ptxas(reports[spectral.KERNEL_NAME, defines], "asm_row_adjoint_kernelILi32E")
        cells = []
        with _kernels_built_with(spectral, "_kernel_fns", defines):
            for cname, (x, wl2, dvec, mask, kcfg) in calls:
                ms = cuda_ms(lambda: spectral.row_adjoint(x, wl2, dvec, mask, kcfg), iters=20, warmup=3)
                cells.append(f"{cname} {ms:.4f}")
        occupancy = ""
        if report is not None:
            regs, spill = report
            cpb = spectral._pick_cpb(plan, False)
            per_sm = _blocks_per_sm(regs, cpb * plan.threads, cpb * max(plan.buffer, plan.n) * 8)
            occupancy = (f"; {regs} registers, {spill} B spilled; blocks an SM holds (D = 1): "
                         f"{per_sm} of {cpb * plan.threads} threads")
        print(f"  K2 {_label(defines)}: " + ", ".join(cells) + occupancy + f" [{card}]", flush=True)
    for cname, (x, wl2, dvec, mask, kcfg) in calls:
        nbytes, flops = k2_row_adjoint_work(x.shape[0], ROWS, kcfg[5], kcfg[6], kcfg[4], mask, kcfg[2])
        b, kind = bound_ms(nbytes, flops)
        print(f"  bound {cname}: {b:.4f} ms ({kind}; {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)",
              flush=True)
    del calls
    torch.cuda.empty_cache()

    print("K3 one pass of (12, 1024, 1024) complex64, ms by CUDA events (mean of 20)", flush=True)
    rng = np.random.default_rng(1)
    x = torch.complex(*(torch.from_numpy(rng.standard_normal((12, 1024, 1024)).astype(np.float32)).to(dev)
                        for _ in range(2)))
    nbytes = 2 * x.numel() * 8
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), iters=20, warmup=3)
    print(f"  device copy of the same bytes: {copy_ms:.4f} ms, {nbytes / copy_ms / 1e9:.2f} TB/s [{card}]",
          flush=True)
    for axis in (-1, -2):
        lib_ms = cuda_ms(lambda: torch.fft.fft(x, dim=axis), iters=20, warmup=3)
        print(f"  cuFFT axis {axis}: {lib_ms:.4f} ms, {nbytes / lib_ms / 1e9:.2f} TB/s [{card}]", flush=True)
    for defines in K3_BUILDS:
        cells = []
        with _kernels_built_with(fft, "_kernel_fn", defines):
            for axis in (-1, -2):
                ms = cuda_ms(lambda: fft.fft_axis(x, axis, False, 1.0), iters=20, warmup=3)
                cells.append(f"axis {axis} {ms:.4f} ({nbytes / ms / 1e9:.2f} TB/s)")
        occupancy = []
        for columns in (False, True):
            report = _ptxas(reports[fft.KERNEL_NAME, defines],
                            f"fft_axis_kernelILi32ELb{int(columns)}E")
            if report is not None:
                lpb = fft._pick_lpb(plan, columns)
                regs, spill = report
                occupancy.append(f"axis {-2 if columns else -1}: {regs} registers, {spill} B spilled, "
                                 f"{_blocks_per_sm(regs, lpb * plan.threads, lpb * plan.buffer * 8)} "
                                 f"blocks of {lpb * plan.threads} threads an SM")
        print(f"  K3 {_label(defines)}: " + ", ".join(cells) + "; " + "; ".join(occupancy)
              + f" [{card}]", flush=True)

    print("K3 as shipped, passes in turn on the same planes, ms by CUDA events (mean of 50)", flush=True)

    def axis(a, src=None):
        return fft.fft_axis(x if src is None else src, a, False, 1.0)

    cells = {
        "-1 then -1": lambda: axis(-1, axis(-1)),
        "-2 then -2": lambda: axis(-2, axis(-2)),
        "-1 then -2": lambda: axis(-2, axis(-1)),
        "-1, -2 independent": lambda: (axis(-1), axis(-2)),
        "fft2": lambda: fft.fft2(x),
        # PERF.md's K3 row: a train step's hat and target fft2 and the hat's adjoint
        "2 fft2 + adjoint": lambda: (fft.fft2(x), fft.fft2(x), fft._transform2(x, True, 1.0)),
    }
    print("  K3 " + "; ".join(f"{name} {cuda_ms(fn, iters=50, warmup=5):.4f}" for name, fn in cells.items())
          + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
