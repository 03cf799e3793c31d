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

Then the mixed-radix plans, as shipped: K3's one-axis pass at 768, 1280,
1728, 2880 and 5000 along each axis on (8, 2048, n) / (8, n, 2048) planes
(TB/s of its own bytes, beside ``torch.fft``), K3's two ``fft2``s of the
paths, (12, 1280, 768) and (3, 2880, 5000), and K1's row pass and K2's row
adjoint at rp 1280, 1728 and 2880 in the modes ``mixed_radix_smoke.py``'s
JSON entries time.  Last, where the package has them (``fft_plan.CHOSEN``),
every candidate plan of :data:`MIXED_CANDIDATES` in turn, each a library
of its own: the same passes, each against ``torch.fft`` or K1's plain
version, the fastest being the plan ``fft_plan.CHOSEN`` ships.

It uses only what the package has offered since K2's redesign (the
mixed-radix section: since the mixed-radix plans), so a copy of it times an
earlier checkout too: two checkouts run in turns (A, B, B, A) in one call
compare on one card.  ``--mixed`` runs the mixed-radix sections alone,
``--lengths`` at the lengths given, ``--shipped`` without the candidates.

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
# the mixed-radix lengths of the paths, and each one's candidate plans
# (E, radices): first the fewest-passes plan the compiled plans replaced (E
# a multiple of every radix, up to 60 values a thread), then plans of fewer
# values a thread (one more exchange, or guarded middle passes) and, at
# 2880, of E = 60 in smaller radices
MIXED_LENGTHS = (768, 1280, 1728, 2880, 5000)
MIXED_CANDIDATES = {
    768: ((48, (48, 16)), (16, (16, 3, 16)), (16, (16, 6, 8))),
    1280: ((40, (40, 8, 4)), (20, (20, 16, 4)), (16, (16, 5, 16)), (16, (8, 10, 16))),
    1728: ((24, (24, 24, 3)), (24, (24, 3, 24)), (12, (12, 12, 12)), (27, (9, 8, 8, 3))),
    2880: ((60, (60, 12, 4)), (60, (12, 20, 12)), (60, (20, 12, 12)), (60, (12, 5, 4, 12)),
           (60, (15, 4, 4, 12)), (60, (10, 6, 4, 12)), (60, (6, 10, 4, 12)), (30, (30, 16, 6)),
           (24, (24, 5, 24))),
    5000: ((50, (50, 50, 2)), (25, (25, 8, 25)), (20, (20, 25, 10)), (40, (40, 25, 5))),
}
# the modes of K1's row pass and K2's row adjoint timed at each mixed rp
# (mixed_radix_smoke.py's JSON entries: the portrait forward, the 1080p step,
# 4K's AP2POH)
ROW_PASS_MODES = {1280: ("conj_h", "field D=3"), 1728: ("conj_h", "from_spectrum+per_plane"),
                  2880: ("conj_h",)}
ROW_ADJOINT_MODES = {1280: ("conj_h",), 1728: ("conj_h", "from_spectrum+per_plane"), 2880: ("conj_h",)}
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


@contextlib.contextmanager
def _plan_chosen(n, elems, radices):
    """Inside the block the wrappers take the plan (elems, radices) for
    length ``n`` (and so load its library)."""
    from .ops.cuda import fft, fft_plan, spectral

    caches = (fft_plan.make_plan, fft_plan.device_plan, fft.supported_length, spectral.supported)
    saved = fft_plan.CHOSEN.get(n)
    fft_plan.CHOSEN[n] = (elems, tuple(radices))
    for cache in caches:
        cache.cache_clear()
    try:
        yield fft_plan.make_plan(n)
    finally:
        if saved is None:
            del fft_plan.CHOSEN[n]
        else:
            fft_plan.CHOSEN[n] = saved
        for cache in caches:
            cache.cache_clear()


def _mixed_report(log, plan):
    """Registers, spills and blocks an SM of a plan's K3 kernels (axis -1,
    -2) or K1's and K2's (D = 1), from the library's ptxas report."""
    from .ops.cuda import fft, spectral

    cells = []
    for label, entry, lines, smem_line in (
            ("K3 -1", f"fft_axis_kernelILi{plan.elems}ELb0E", fft._pick_lpb(plan, False), plan.buffer),
            ("K3 -2", f"fft_axis_kernelILi{plan.elems}ELb1E", fft._pick_lpb(plan, True), plan.buffer),
            ("K1", f"asm_row_pass_kernelILi{plan.elems}E", spectral._pick_cpb(plan, False),
             max(plan.buffer, plan.n)),
            ("K2", f"asm_row_adjoint_kernelILi{plan.elems}E", spectral._pick_cpb(plan, False),
             max(plan.buffer, plan.n))):
        if lines is None:
            continue
        # a mixed-radix K1 / K2 instantiation per column count (ILi<E>ELi<cpb>EE)
        report = _ptxas(log, f"{entry}Li{lines}EE") or _ptxas(log, entry)
        if report is None:
            continue
        regs, spill = report
        cells.append(f"{label} {regs} reg {spill} B spill, {lines} x {plan.threads} threads, "
                     f"{_blocks_per_sm(regs, lines * plan.threads, lines * smem_line * 8)} blocks/SM")
    return "; ".join(cells)


def _mixed_timings(dev, card, candidates, lengths=MIXED_LENGTHS):
    """The mixed-radix passes of the paths at ``lengths``, timed by CUDA
    events (mean of 20), once for the plans as shipped (``candidates``
    False) or once per candidate plan of :data:`MIXED_CANDIDATES`."""
    from . import mixed_radix_smoke
    from .ops.cuda import build, fft, fft_plan, spectral
    from .train_smoke import _random_complex
    from .utils.cuda_measure import check_rel, cuda_ms

    rng = np.random.default_rng(3)

    def plans(n):
        if not candidates:
            return [None]
        return list(MIXED_CANDIDATES[n])

    def chosen(n, plan):
        return contextlib.nullcontext(fft_plan.make_plan(n)) if plan is None else _plan_chosen(n, *plan)

    def label(plan):
        return f"{plan.elems}: {'*'.join(map(str, plan.radices))}, {plan.threads} threads"

    jobs = []
    for n in lengths:
        for p in plans(n):
            with chosen(n, p) as plan:
                for name in (fft.KERNEL_NAME,) + ((spectral.KERNEL_NAME,) if n in ROW_PASS_MODES else ()):
                    jobs.append((name, fft_plan.build_defines(plan)))
    logs = {key: res.log for key, res in build.build_jobs(jobs).items()}

    def log_of(plan):
        defines = fft_plan.build_defines(plan)
        return "\n".join(logs.get((name, defines), "") for name in (fft.KERNEL_NAME, spectral.KERNEL_NAME))

    for n in lengths:
        for axis in (-1, -2):
            shape = (8, 2048, n) if axis == -1 else (8, n, 2048)
            x = _random_complex(rng, shape, dev)
            nbytes = 2 * x.numel() * 8
            lib = cuda_ms(lambda: torch.fft.fft(x, dim=axis), iters=20, warmup=3)
            print(f"  K3 n {n} axis {axis} {shape}: torch.fft {lib:.4f} ms, {nbytes / lib / 1e9:.2f} TB/s "
                  f"[{card}]", flush=True)
            for p in plans(n):
                with chosen(n, p) as plan:
                    y, want = fft.fft_axis(x, axis, False, 1.0), torch.fft.fft(x, dim=axis)
                    err = check_rel(f"K3 n {n} axis {axis}", y.real, y.imag, want.real, want.imag)
                    del y, want
                    ms = cuda_ms(lambda: fft.fft_axis(x, axis, False, 1.0), iters=20, warmup=3)
                    print(f"    K3 n {n} axis {axis} plan {label(plan)}: {ms:.4f} ms, "
                          f"{nbytes / ms / 1e9:.2f} TB/s, max abs err {err:.1e}; {_mixed_report(log_of(plan), plan)} "
                          f"[{card}]", flush=True)
            del x
            torch.cuda.empty_cache()
    if not candidates:
        for shape in [s for s in ((12, 1280, 768), (3, 2880, 5000)) if set(s[1:]) <= set(lengths)]:
            x = _random_complex(rng, shape, dev)
            ms = cuda_ms(lambda: fft.fft2(x), iters=20, warmup=3)
            lib = cuda_ms(lambda: torch.fft.fft2(x), iters=20, warmup=3)
            print(f"  K3 fft2 {shape}: {ms:.4f} ms; torch.fft.fft2 {lib:.4f} ms [{card}]", flush=True)
            del x
            torch.cuda.empty_cache()
    for rp, modes in ROW_PASS_MODES.items():
        if rp not in lengths:
            continue
        rows, cols, pad, pad_cols, _ = mixed_radix_smoke.GRIDS[rp]
        for kind, mode_list in (("K1", modes), ("K2", ROW_ADJOINT_MODES[rp])):
            for mode in mode_list:
                fr, fi, wl2, dvec, mask, kcfg = args = mixed_radix_smoke._case(rp, mode, dev, rng)
                if kind == "K1":
                    x = torch.complex(fr, fi)
                    if not kcfg[2]:
                        x = torch.fft.fft(torch.nn.functional.pad(x, (pad_cols, pad_cols)), dim=-1)
                    want = spectral.propagate_planes_reference(*args)
                else:
                    g = _random_complex(rng, (fr.shape[0], kcfg[4], rows, cols), dev)
                    gr, gi = g.real.contiguous(), g.imag.contiguous()
                    x = torch.fft.fft(torch.nn.functional.pad(g, (pad_cols, pad_cols)), dim=-1)
                    want = spectral.propagate_planes_adjoint_reference(gr, gi, wl2, dvec, mask, kcfg)
                for p in plans(rp):
                    with chosen(rp, p) as plan:
                        if kind == "K1":
                            err = check_rel(f"K1 {mode} rp {rp}", *spectral.propagate_planes(*args), *want)
                            ms = cuda_ms(lambda: spectral.row_pass(x, wl2, dvec, mask, kcfg), iters=20, warmup=3)
                        else:
                            err = check_rel(f"K2 {mode} rp {rp}", *spectral._adjoint_cuda(gr, gi, wl2, dvec, mask, kcfg),
                                            *want)
                            ms = cuda_ms(lambda: spectral.row_adjoint(x, wl2, dvec, mask, kcfg), iters=20, warmup=3)
                        keep = kcfg[4] > 1
                        print(f"    {kind} rp {rp} {mode} ({fr.shape[0]} planes) plan {label(plan)}: {ms:.4f} ms "
                              f"alone, {spectral._pick_cpb(plan, keep)} columns a block, max abs err {err:.1e}; "
                              f"{_mixed_report(log_of(plan), plan)} [{card}]", flush=True)
                del args, x, want
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="what holds K1, K2 and K3 back, by ablation")
    ap.add_argument("--mixed", action="store_true", help="only the mixed-radix sections")
    ap.add_argument("--lengths", type=int, nargs="*", default=MIXED_LENGTHS,
                    help="the mixed-radix lengths to time (default: the paths')")
    ap.add_argument("--shipped", action="store_true", help="the plans as shipped only, no candidates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fft_ablation: no CUDA device", file=sys.stderr)
        return 1
    from .ops.cuda import build, fft, fft_plan, spectral
    from .utils.cuda_measure import bound_ms, cuda_ms, k1_row_pass_work, k2_row_adjoint_work

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    if args.mixed:
        return _mixed(dev, card, args.lengths, args.shipped)
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
    del x, y
    torch.cuda.empty_cache()
    return _mixed(dev, card, args.lengths, args.shipped)


def _mixed(dev, card, lengths, shipped) -> int:
    from .ops.cuda import fft_plan

    print("Mixed-radix plans as shipped, ms by CUDA events (mean of 20)", flush=True)
    _mixed_timings(dev, card, False, lengths)
    if hasattr(fft_plan, "CHOSEN") and not shipped:
        print("Mixed-radix candidate plans (fft_ablation.MIXED_CANDIDATES), each its own library", flush=True)
        _mixed_timings(dev, card, True, lengths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
