"""The card-side measurement helpers that run on the CPU too: the work
counts behind the bounds ``chip_smoke.py`` reports, and the ablation
script's reading of ptxas and of the blocks an SM holds."""

import inspect

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import fft_ablation
from learned_hologram_gan_tpu_torch.ops.cuda import fft, fft_plan, spectral
from learned_hologram_gan_tpu_torch.utils import cuda_measure as cm


def _mask(rp, cp, radius):
    ky = np.fft.fftfreq(rp)[:, None]
    kx = np.fft.fftfreq(cp)[None, :]
    return torch.from_numpy((np.hypot(ky, kx) <= radius).astype(np.float32))


def test_spectral_support_counts_the_masks_nonzero_entries():
    mask = _mask(64, 32, 0.3)
    assert cm.spectral_support(None, 64, 32) == 64 * 32
    assert cm.spectral_support(mask, 64, 32) == int(mask.sum()) < 64 * 32
    assert cm.spectral_support(0.5 * mask, 64, 32) == int(mask.sum())


@pytest.mark.parametrize("from_spectrum", [False, True])
def test_row_pass_work_counts_h_only_where_the_mask_passes(from_spectrum):
    """H, its multiply and the mask's are counted on the mask's support only,
    and from a spectrum only its entries there are read; a mask of ones
    costs its read and its multiply, nothing else."""
    p, rows, rp, cp, num_d = 3, 24, 64, 32, 2
    mask = _mask(rp, cp, 0.3)
    support = int(mask.sum())
    ones = torch.ones(rp, cp)
    nb_none, fl_none = cm.k1_row_pass_work(p, rows, rp, cp, num_d, None, from_spectrum)
    nb_ones, fl_ones = cm.k1_row_pass_work(p, rows, rp, cp, num_d, ones, from_spectrum)
    nb_mask, fl_mask = cm.k1_row_pass_work(p, rows, rp, cp, num_d, mask, from_spectrum)
    assert nb_ones == nb_none + rp * cp * 4
    assert fl_ones == fl_none + p * num_d * rp * cp * 2
    assert fl_ones - fl_mask == p * num_d * (rp * cp - support) * 16
    read_saved = 2 * p * (rp * cp - support) * 4 if from_spectrum else 0
    assert nb_ones - nb_mask == read_saved


def test_wrapper_work_counts_h_only_where_the_mask_passes():
    p, rows, cols, rp, cp, num_d = 3, 24, 16, 64, 32, 3
    mask = _mask(rp, cp, 0.25)
    nb, fl = cm.k1_work(p, rows, cols, rp, cp, num_d, mask)
    nb1, fl1 = cm.k1_work(p, rows, cols, rp, cp, num_d, torch.ones(rp, cp))
    assert nb == nb1
    assert fl1 - fl == p * num_d * (rp * cp - int(mask.sum())) * 16
    assert cm.k1_bound_ms(p, rows, cols, rp, cp, num_d, mask) == cm.bound_ms(nb, fl)


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122asm_row_adjoint_kernelILi4EEEvPK6float2' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122asm_row_adjoint_kernelILi4EEEvPK6float2
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119asm_row_pass_kernelILi32EEEvPK6float2' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119asm_row_pass_kernelILi32EEEvPK6float2
    144 bytes stack frame, 72 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 144 bytes cumulative stack size
"""


def test_ablation_reads_ptxas_per_entry_function():
    assert fft_ablation._ptxas(PTXAS_LOG, "asm_row_pass_kernelILi32E") == (128, 72)
    assert fft_ablation._ptxas(PTXAS_LOG, "asm_row_adjoint_kernelILi4E") == (40, 0)
    assert fft_ablation._ptxas("", "asm_row_pass_kernelILi32E") is None


@pytest.mark.parametrize("regs,threads,smem,want", [
    (128, 256, 8 * 1056 * 8, 2),   # K1, D = 1: registers hold it to 2
    (128, 128, 4 * 2080 * 8, 3),   # K1, D > 1: shared memory holds it to 3
    (114, 128, 4 * 1056 * 8, 4),   # K3 along axis -1: registers
    (32, 1024, 0, 2),              # threads
])
def test_ablation_blocks_per_sm(regs, threads, smem, want):
    assert fft_ablation._blocks_per_sm(regs, threads, smem) == want


MIXED_LOG = """
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119asm_row_pass_kernelILi60ELi4EEEvPK6float2' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119asm_row_pass_kernelILi60ELi4EEEvPK6float2
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119asm_row_pass_kernelILi60ELi8EEEvPK6float2' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119asm_row_pass_kernelILi60ELi8EEEvPK6float2
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 165 registers, used 1 barriers
"""


def test_ablation_reports_the_mixed_instantiation_the_wrapper_launches():
    """A mixed-radix K1 library holds an instantiation per column count;
    the ablation reports the one of D = 1 (8 columns at 2880), not the
    first in the log."""
    plan = fft_plan.make_plan(2880)
    assert spectral._pick_cpb(plan, False) == 8 and spectral._pick_cpb(plan, True) == 4
    report = fft_ablation._mixed_report(MIXED_LOG, plan)
    assert report.startswith("K1 165 reg 0 B spill, 8 x 48 threads, 1 blocks/SM")


def test_ablation_candidates_are_plans_and_hold_the_chosen_one():
    """Every candidate the ablation times is a plan of its length, the
    first is the fewest-passes plan the plans replaced, and the plan each
    length ships with is one of them; choosing one in the ablation's block
    leaves the shipped plan and the wrappers' caches as they were."""
    for n, plans in fft_ablation.MIXED_CANDIDATES.items():
        assert all((e, tuple(r)) in fft_plan.candidates(n) for e, r in plans), n
        assert fft_plan.CHOSEN[n] in plans, n
    assert fft_ablation.MIXED_CANDIDATES[1280][0] == (40, (40, 8, 4))
    shipped = fft_plan.make_plan(1280)
    with fft_ablation._plan_chosen(1280, 40, (40, 8, 4)) as plan:
        assert (plan.elems, plan.radices) == (40, (40, 8, 4)) and fft_plan.make_plan(1280) is plan
        assert fft.supported_length(1280) and spectral.supported(1280, 7)
    again = fft_plan.make_plan(1280)
    assert (again.elems, again.radices, again.columns) == (shipped.elems, shipped.radices, shipped.columns)
    assert fft_plan.CHOSEN[1280] == (shipped.elems, shipped.radices)


def test_ablation_builds_name_macros_the_sources_define():
    """Each macro the ablation builds set is read by the sources it builds,
    so that no ablated build silently times the kernel as shipped."""
    csrc = spectral.__file__.rsplit("/ops/", 1)[0] + "/csrc/"
    k1 = open(csrc + "k1_asm_propagate.cu").read() + open(csrc + "fft_hopper.cuh").read()
    k3 = open(csrc + "k3_fft.cu").read() + open(csrc + "fft_hopper.cuh").read()
    for builds, src in ((fft_ablation.K1_BUILDS, k1), (fft_ablation.K3_BUILDS, k3)):
        for defines in builds:
            for d in defines:
                assert f"#ifdef {d}" in src


def test_k5_ablation_builds_name_macros_the_source_reads():
    """The same for K5's ablation builds, whose macros switch a part of
    the kernel off (#ifdef) or drop it (#ifndef) in both element types (the
    products and the stores in each type's consumer), and for K4's; the
    loaders take the defines."""
    from learned_hologram_gan_tpu_torch import k5_ablation

    csrc = spectral.__file__.rsplit("/ops/", 1)[0] + "/csrc/"
    src = open(csrc + "k5_residual_block.cu").read()
    macros = {d for defines in k5_ablation.BUILDS for d in defines}
    assert macros == {"LHG_ABLATE_MMA", "LHG_ABLATE_A", "LHG_ABLATE_B", "LHG_ABLATE_STORE"}
    for d in macros:
        assert f"#ifdef {d}" in src or f"#ifndef {d}" in src
    assert src.count("#ifndef LHG_ABLATE_MMA") == src.count("#ifdef LHG_ABLATE_STORE") == 2
    k4 = open(csrc + "k4_transfer_stack.cu").read()
    assert {d for defines in k5_ablation.K4_BUILDS for d in defines} == {"LHG_ABLATE_SINCOS"}
    assert "#ifdef LHG_ABLATE_SINCOS" in k4
    from learned_hologram_gan_tpu_torch.ops.cuda import conv_block, transfer

    for mod in (conv_block, transfer):
        assert "defines" in inspect.signature(mod._kernel_fn.__wrapped__).parameters


def test_k5_and_k4_bounds():
    """K5 float32's bound counts three TF32 products a product at 495
    TFLOP/s (4.52 ms for enc_0 + dec_1 at batch 16, 21.3 ms for the nine
    blocks), beside the 67 TFLOP/s SIMT figure (11.14 and 52.4 ms); K5
    bf16's stays its operations at 989 TFLOP/s; K4's training stack is
    bound by its 2.01 GB of stores."""
    from learned_hologram_gan_tpu_torch import fused_smoke as fs

    def ms(blocks, itemsize, simt=False):
        total = 0.0
        for _, hw, cin, c in blocks:
            nbytes, flops, peak = fs.k5_work(16, hw, hw, cin, c, itemsize)
            if simt:
                flops, peak = fs.k5_flops(16, hw, hw, cin, c), cm.PEAK_F32_FLOP_PER_S
            t, kind = cm.bound_ms(nbytes, flops, peak)
            assert kind == "operations"
            total += t
        return total

    pair = (fs.UNET_BLOCKS[0], fs.UNET_BLOCKS[7])
    assert ms(pair, 4) == pytest.approx(4.52, abs=0.01)
    assert ms(fs.UNET_BLOCKS, 4) == pytest.approx(21.3, abs=0.05)
    assert ms(pair, 4, simt=True) == pytest.approx(11.142, abs=0.001)
    assert ms(fs.UNET_BLOCKS, 4, simt=True) == pytest.approx(52.4, abs=0.05)
    assert ms(fs.UNET_BLOCKS, 2) == pytest.approx(3.549, abs=0.001)
    nbytes, flops = fs.k4_work(4, 20, 1024 * 1024)
    assert cm.bound_ms(nbytes, flops) == (pytest.approx(0.636, abs=0.001), "bytes")


def test_build_keeps_the_log_of_a_cached_library(tmp_path, monkeypatch):
    """A second build of the same source, headers and flags loads nothing
    new and still returns ptxas' report; defines give another library and
    reach nvcc."""
    from learned_hologram_gan_tpu_torch.ops.cuda import build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "ptxas info    : Used 114 registers; nvcc $*"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    first = build.build_library("k3_fft")
    second = build.build_library("k3_fft")
    assert not first.cached and second.cached and second.path == first.path
    assert "Used 114 registers" in first.log and second.log == first.log
    ablated = build.build_library("k3_fft", ("LHG_ABLATE_FFT",))
    assert not ablated.cached and ablated.path != first.path
    assert "-DLHG_ABLATE_FFT" in ablated.log and "-DLHG_ABLATE_FFT" not in first.log
