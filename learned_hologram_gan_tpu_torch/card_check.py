"""The slices at a small size on a CUDA device, held against the CPU.

:func:`card_vs_cpu` runs ``generate_poh.main`` on one sample with the same
seeded weights twice: on the card, through the port's kernels, and on the
CPU, through their plain versions.  It records the TF32 setting each
convolution ran under.  :func:`check` raises unless the two agree:

* POHs as phasors, ``|exp(i a) - exp(i b)|`` (a 2*pi wrap is the same SLM
  state, and acos amplifies rounding near the normalized maximum): mean
  <= 2e-3, p99 <= 1e-2, max <= 5e-2;
* focal stacks: p99.9 <= 1e-3, max <= 4e-3 (the propagation bound of the
  CPU tests);
* every convolution on the card ran with TF32 off, and K1 launched twice.

:func:`train_step_card_vs_cpu` does the same for one GAN train step
(:data:`TRAIN` sizes), with any of ``build_train_step``'s ``two_h_hat`` and
``critic_batching``, from the same carried weights, distance indices and
GP alphas, and :func:`check_train_step` raises unless the metrics, both
nets' gradients and BatchNorm statistics agree within the bounds below
(in float32, the critic's running means beyond 1e-5 only where the
recorded cause lies), every convolution, forward and backward, ran with
TF32 off, and the kernels launched as the step's reconstruction makes them.

:func:`fused_card_vs_cpu` runs ``generator_apply_fused`` (K5 on the card), plain and with ``polyphase_level0``, from the same seeded
weights and non-trivial BatchNorm statistics on the card and on the CPU;
:func:`check_fused` holds the POHs to the phasor bounds above and counts
K5's launches.

:func:`serving_card_vs_cpu` runs the serving path (``PohService``, float32
and the int8 stage 1) on the card and on the CPU from the same weights and
int8 tree; :func:`check_serving` holds the POHs and focal stacks to the
bounds above and the card's K1 and K3 launches to what the server makes.

:func:`stage2_step_card_vs_cpu` takes one stage-2 pretraining loss and its
gradients (``train/pretrain.ap2poh_loss``: the sigmoid low-pass, AP2POH,
the spectrum loss) on the card and on the CPU from the same weights and
batch; :func:`check_stage2_step` holds the loss to the metric bound, the
gradients to the gradient bound below, and the launches to what the code
makes (K1 ``conj_h`` once, K3 twelve times, K2 never).

Each takes ``dtype``.  In ``"bfloat16"`` both sides run the bfloat16
generator (and critic) and differ where a float32 accumulation order flips
a bfloat16 rounding, so they are held to bfloat16 bounds, derived below
from u = 2^-8 as in tests/test_torch_bf16.py, and :func:`record_conv_tf32`
also checks that the UNet and critic convs computed in bfloat16 on the
card.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` call them all.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch
from torch import nn

ROWS = COLS = 48
PAD = 8  # a 64 x 64 padded grid: the fused path, K1 on the card
UNET_BASE = 4

POH_MEAN_TOL, POH_P99_TOL, POH_MAX_TOL = 2e-3, 1e-2, 5e-2
STACK_P999_TOL, STACK_MAX_TOL = 1e-3, 4e-3

# one train step: 32 x 32 in a 64 x 64 grid (K1, K2 and K3 on the card),
# UNet base 4, critic feature_d 2, ratio 2, four distances, random VGG19
TRAIN = dict(hw=32, pad=16, unet_base=4, feature_d=2, batch=2, ratio=2, distances=4)
TRAIN_LAMBDA = 10.0
# Bounds, card against CPU.  Metrics: float32 rounding of FFTs and convs
# through two critic updates, relative.  Gradients: relative to the largest
# |g| of the net (a conv bias feeding a train-mode BatchNorm has a gradient
# of exactly 0, rounding noise on both sides).  Running statistics: such a
# bias still moves by +-lr under Adam's first step, in the direction of its
# noise's sign, which the card and the CPU may draw differently; the
# critic's second stats update then sees batch means up to 2 * lr = 2e-3
# apart, and its running mean moves by momentum 0.01 times that, 2e-5
# (measured 1.97e-5 on the H100): atol 5e-5 on top of rtol 1e-3.  In
# float32 that cause must account for every critic running mean whose
# excess over rtol passes 1e-5, the bound before it: a channel whose bias
# moved apart by less than lr / 2 stays within ``STATS_UNEXPLAINED``.
METRIC_RTOL, GRAD_TOL, STATS_RTOL, STATS_ATOL = 1e-3, 1e-2, 1e-3, 5e-5
STATS_UNEXPLAINED = 1e-5
TRAIN_LR = 1e-3  # Adam's rate for both nets in the train-step check
# the fused eval path: 48 x 48 in a 64 x 64 grid, UNet base 4 (four levels,
# 48 down to 3), two images; K5 runs all nine residual blocks (four
# encoder levels, the bottleneck, four decoder levels), seven with polyphase
FUSED = dict(hw=48, pad=8, unet_base=4, batch=2)
# one stage-2 pretraining step: 32 x 32 in a 64 x 64 grid (K1 and K3 on the
# card), batch 2, the quality run's filter 0.45, alpha and beta
STAGE2 = dict(hw=32, pad=16, batch=2, frc=0.45, alpha=1e-3, beta=1e-5)
# K3 launches of one stage-2 train step, two passes a 2-D transform: the
# low-pass's fft2 and ifft2, the spectrum loss's fft2 and ifft2, and their
# two adjoints in the backward (the low-pass runs without gradient)
STAGE2_K3_PER_STEP = 12
# the serving path (tools/serve_poh.PohService): 48 x 48 in a 64 x 64 grid
# (K1 and K3 on the card), UNet base 4, buckets (1, 2), a batch-2 /poh and
# a 3-depth focal stack; the card's launches over start-up and that
# traffic: the warm-up's one conj_h K1 a bucket and one from_spectrum K1
# and two K3 a depth bucket (4), then one conj_h for the batch, one
# from_spectrum and two K3 for the stack
SERVE = dict(hw=48, pad=8, unet_base=4, buckets=(1, 2), batch=2, depths=(4.5e-4, 8e-4, 1.3e-3))
SERVE_LAUNCHES = dict(k1={"conj_h": 3, "from_spectrum": 5}, k3=10)

U_BF16 = 2.0**-8
# bfloat16, card against CPU.  POHs: the JAX package's bfloat16 POH gate,
# |a - b| <= 5e-2 (1 + |b|) on phases (tests/test_fused_unet.py:83), as
# phasors.  The focal stack is propagated from the card's POH on both
# devices and held to the float32 bounds above: a propagation check, not
# one of bfloat16.  The train step's metrics: each side departs from
# float32 by a loss's 2e-2 (tests/test_torch_bf16.py), so 2 * 2e-2
# relative; D_loss, the penalty lambda (n - 1)^2, amplifies the norm n's
# error by 2 n / (n - 1); the critic term alone, a mean of scores that
# nearly cancel, is read through G_loss.  Gradients: each side departs
# from float32 by 48 u (generator) and 68 u (critic) of max |g|, so twice
# that.  Running statistics: each side's 25 u of max |x| (~4) times
# momentum 0.01, twice, plus the critic's second update on weights that
# Adam's first moved by +-lr where the two sides' gradient signs differ
# (bfloat16 gradients part by up to 0.5 of max |g|): a batch mean over a
# fan-in of 9 * 32 inputs of up to ~4 moves by 2 lr * 288 * 4, times 0.01.
BF16_POH_TOL = 5e-2
BF16_METRIC_RTOL = 2 * 2e-2
BF16_GRAD_TOL = dict(grad_G_rel=2 * 48 * U_BF16, grad_D_rel=2 * 68 * U_BF16)
BF16_STATS_ATOL = 2 * 25 * U_BF16 * 4 * 0.01 + 2 * 1e-3 * 288 * 4 * 0.01


@contextlib.contextmanager
def record_conv_tf32(seen: List[bool], seen_backward: Optional[List[bool]] = None,
                     dtypes: Optional[set] = None):
    """Append ``torch.backends.cudnn.allow_tf32`` to ``seen`` as each
    convolution module of the process starts its forward and, when
    ``seen_backward`` is given, to it as each such convolution's backward
    node starts (a double backward runs inside the same backward call).
    When ``dtypes`` is given, add each such forward's output dtype to it."""
    from .nn.blocks import ChannelWiseSymmetricConv

    convs = (nn.Conv2d, nn.ConvTranspose2d, ChannelWiseSymmetricConv)

    def pre_hook(module, args):
        if isinstance(module, convs):
            seen.append(bool(torch.backends.cudnn.allow_tf32))

    def post_hook(module, args, output):
        if not isinstance(module, convs):
            return
        if dtypes is not None:
            dtypes.add(output.dtype)
        if seen_backward is not None and output.grad_fn is not None:
            output.grad_fn.register_prehook(
                lambda grads: seen_backward.append(bool(torch.backends.cudnn.allow_tf32))
            )

    handles = [nn.modules.module.register_module_forward_pre_hook(pre_hook)]
    if seen_backward is not None or dtypes is not None:
        handles.append(nn.modules.module.register_module_forward_hook(post_hook))
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def _phasor_diff(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(np.exp(1j * np.asarray(got, np.float64)) - np.exp(1j * np.asarray(want, np.float64)))


def poh_phasor_errors(got: np.ndarray, want: np.ndarray) -> tuple:
    """Mean, p99 and max of |exp(i got) - exp(i want)|."""
    d = _phasor_diff(got, want)
    return float(d.mean()), float(np.quantile(d, 0.99)), float(d.max())


def poh_gate_error(got: np.ndarray, want: np.ndarray) -> float:
    """max |exp(i got) - exp(i want)| / (1 + |want|): the JAX package's
    bfloat16 POH gate |got - want| <= tol (1 + |want|), wrap-free."""
    return float((_phasor_diff(got, want) / (1.0 + np.abs(np.asarray(want, np.float64)))).max())


def card_vs_cpu(device: str | torch.device = "cuda", seed: int = 3, dtype: str = "float32") -> dict:
    """Drive the CLI path on ``device`` and on the CPU in ``dtype``; returns
    the differences, the card run's K1 launches, its convolutions' TF32
    settings and output dtypes."""
    from . import generate_poh
    from .config import OpticsConfig
    from .ops import asm
    from .ops.cuda import spectral

    outs, tf32, launches, dtypes = {}, [], 0, set()
    with tempfile.TemporaryDirectory(prefix="card_check_") as tmp:
        rng = np.random.default_rng(seed)
        for name in ("img", "depth"):
            rng.random((2, 3, ROWS, COLS)).astype(np.float32).tofile(os.path.join(tmp, f"{name}.bin"))
        for run, dev in enumerate(("cpu", str(device))):
            argv = [
                "--img_path", os.path.join(tmp, "img.bin"),
                "--depth_path", os.path.join(tmp, "depth.bin"), "--index", "1",
                "--model_path", os.path.join(tmp, "random_init.pt"),
                "--poh_output_path", os.path.join(tmp, "poh.npy"), "--samplesNum", "2",
                "--sample_row_num", str(ROWS), "--sample_col_num", str(COLS),
                "--pad_size", str(PAD), "--unet_base_features", str(UNET_BASE),
                "--propagate", "--num_intervals", "3", "--dtype", dtype,
                "--output_image_dir", os.path.join(tmp, f"recon_{run}"), "--device", dev,
            ]
            seen: List[bool] = []
            dtypes = set()
            before = spectral.row_pass.launches
            with record_conv_tf32(seen, dtypes=dtypes):
                result = generate_poh.main(argv)
            # kept from the last run, the card's
            tf32, launches = seen, spectral.row_pass.launches - before
            outs[run] = (result["poh"].cpu().double().numpy(), result["focal_stack"].cpu().numpy())
    (cpu_poh, cpu_stack), (card_poh, card_stack) = outs[0], outs[1]
    if dtype == "bfloat16":
        # the CPU's focal stack from the card's POH (generate_poh's recon plan)
        plan = asm.make_plan(OpticsConfig(rows=ROWS, cols=COLS, pad_size=PAD,
                                          filter_radius_coefficient=0.35),
                             distances=np.linspace(4e-4, 10e-4, 3), device="cpu")
        poh = torch.from_numpy(card_poh.astype(np.float32))
        cpu_stack = asm.propagate_batch_multi(plan, torch.ones_like(poh), poh).numpy()
    poh_mean, poh_p99, poh_max = poh_phasor_errors(card_poh, cpu_poh)
    s = np.abs(card_stack - cpu_stack)
    return dict(
        dtype=dtype, poh_mean=poh_mean, poh_p99=poh_p99, poh_max=poh_max,
        poh_gate=poh_gate_error(card_poh, cpu_poh),
        stack_p999=float(np.quantile(s, 0.999)), stack_max=float(s.max()),
        convs=len(tf32), convs_tf32=int(sum(tf32)), k1_launches=launches,
        conv_dtypes=sorted(str(d) for d in dtypes),
    )


def check(stats: dict) -> None:
    """Raise ``AssertionError`` naming every bound that ``stats`` (from
    :func:`card_vs_cpu`) breaks."""
    bounds = [("stack_p999", STACK_P999_TOL), ("stack_max", STACK_MAX_TOL)]
    if stats["dtype"] == "bfloat16":
        bounds.append(("poh_gate", BF16_POH_TOL))
    else:
        bounds += [("poh_mean", POH_MEAN_TOL), ("poh_p99", POH_P99_TOL), ("poh_max", POH_MAX_TOL)]
    problems = [f"{k} {stats[k]:.3e} > {tol:g}" for k, tol in bounds if not stats[k] <= tol]
    problems += _dtype_problems(stats)
    if stats["convs"] == 0 or stats["convs_tf32"] != 0:
        problems.append(f"{stats['convs_tf32']} of {stats['convs']} convolutions ran with TF32 on")
    if stats["k1_launches"] != 2:
        problems.append(f"K1 launched {stats['k1_launches']} times, want 2")
    if problems:
        raise AssertionError("card and CPU disagree: " + "; ".join(problems))


def _dtype_problems(stats: dict, also=()) -> List[str]:
    """The conv output dtypes a run should have shown: its compute dtype,
    plus ``also`` (VGG19 stays float32 in a bfloat16 train step)."""
    want = {"torch." + stats["dtype"], *also}
    if set(stats["conv_dtypes"]) != want:
        return [f"convolutions computed in {stats['conv_dtypes']}, want {sorted(want)}"]
    return []


def _train_inputs(seed: int, dtype: str = "float32"):
    """Seeded (generator config, train state on the CPU, numpy batch,
    distance indices, GP alphas)."""
    from .config import DiscriminatorConfig, GeneratorConfig
    from .losses import load_vgg19_params, make_vgg19
    from .train.state import build_modules, create_train_state

    t = TRAIN
    cfg = GeneratorConfig(rows=t["hw"], cols=t["hw"], pad_size=t["pad"],
                          filter_radius_coefficient=0.45, unet_base_features=t["unet_base"],
                          dtype=dtype)
    g, d = build_modules(cfg, DiscriminatorConfig(feature_d=t["feature_d"], dtype=dtype),
                         use_gan=True)
    vgg_state, _ = load_vgg19_params(mode="random")
    state = create_train_state(seed, g, d, TRAIN_LR, TRAIN_LR, "cpu", make_vgg19(vgg_state, "cpu"))
    rng = np.random.default_rng(seed)
    b, hw = t["batch"], t["hw"]
    batch = tuple(rng.random((b, c, hw, hw)).astype(np.float32) for c in (4, 3, 3))
    idx = torch.from_numpy(rng.permutation(t["distances"])[:b])
    alphas = torch.from_numpy(rng.random((t["ratio"], b, 1, 1, 1)).astype(np.float32))
    return cfg, state, batch, idx, alphas


def _run_train_step(cfg, state, batch, idx, alphas, device, **options):
    from .config import LossConfig
    from .models import make_generator_plan
    from .ops import asm
    from .train import steps

    gen_plan = make_generator_plan(cfg, device=device)
    multi = asm.make_plan(cfg.optics(), distances=np.linspace(-4e-4, 0.0, TRAIN["distances"] + 1)[:-1],
                          device=device)
    step = steps.build_train_step(
        LossConfig(perceptual_loss_weight=0.1, discriminator_loss_weight=0.1, perceptual="random"),
        True, TRAIN["ratio"], TRAIN_LAMBDA, **options)
    batch = tuple(torch.from_numpy(a).to(device) for a in batch)
    _, metrics = step(state, batch, gen_plan, multi, idx=idx, alphas=alphas)
    return {k: float(v) for k, v in metrics.items()}


def _snapshot(state):
    def grads(m):
        return {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().double()
                for k, p in m.named_parameters()}

    def stats(m):
        return {k: v.detach().cpu().double() for k, v in m.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    return dict(grad_G=grads(state.generator), grad_D=grads(state.discriminator),
                stats_G=stats(state.generator), stats_D=stats(state.discriminator))


def _keep_first_update_biases(state) -> dict:
    """The critic's conv biases (float64, on the CPU) as its first Adam
    step leaves them, kept by a hook on ``state.opt_D``."""
    kept = {}

    def hook(opt, args, kwargs):
        if not kept:
            kept.update({name: m.bias.detach().cpu().double().clone()
                         for name, m in state.discriminator.named_children() if name.startswith("Conv_")})

    state.opt_D.register_step_post_hook(hook)
    return kept


def _critic_mean_excess(a: dict, b: dict, bias_a: dict, bias_b: dict) -> dict:
    """Where the critic's running-mean excess over 1e-5 lies.

    The recorded cause (``STATS_ATOL`` above): the bias of Conv_{i+1}, in
    front of BatchNorm_i, has a noise gradient that Adam's first step turns
    into +-lr, with a sign the card and the CPU may draw differently; the
    later batch means, and so the running means, then differ by up to
    2 lr times the momentum's complement.  Returns the channels whose
    excess passes 1e-5 with their bias difference after the first update
    in units of lr, and the largest excess among channels whose biases
    moved apart by less than lr / 2, which the cause leaves unexplained.
    """
    over, unexplained = [], 0.0
    for i in range(5):  # Conv_1..Conv_5 feed BatchNorm_0..BatchNorm_4
        key = f"BatchNorm_{i}.running_mean"
        excess = (a[key] - b[key]).abs() - STATS_RTOL * a[key].abs()
        dbias = (bias_a[f"Conv_{i + 1}"] - bias_b[f"Conv_{i + 1}"]).abs() / TRAIN_LR
        for c in torch.nonzero(excess > 1e-5).flatten().tolist():
            over.append((f"BatchNorm_{i}", c, float(excess[c]), float(dbias[c])))
        still = excess[dbias < 0.5]
        if still.numel():
            unexplained = max(unexplained, float(still.max()))
    return dict(stats_D_mean_over_1e5=over, stats_D_mean_unexplained=unexplained)


def train_step_card_vs_cpu(device: str | torch.device = "cuda", seed: int = 5,
                           dtype: str = "float32", two_h_hat: bool = False,
                           critic_batching: str = "pair") -> dict:
    """One train step in ``dtype`` with ``build_train_step``'s
    ``two_h_hat`` and ``critic_batching`` on the CPU (plain versions) and on
    ``device`` (the kernels) from the same weights and draws; returns the
    worst differences, the card run's kernel launches (by mode), TF32
    settings and conv output dtypes, and where the critic's running-mean
    differences lie (:func:`_critic_mean_excess`)."""
    import copy

    from .ops.cuda import fft, spectral

    options = dict(two_h_hat=two_h_hat, critic_batching=critic_batching)
    cfg, state, batch, idx, alphas = _train_inputs(seed, dtype)
    card_state = copy.deepcopy(state)
    card_state.generator.to(device)
    card_state.discriminator.to(device)
    card_state.vgg.to(device)
    # optimizers built on the card's parameters, with the CPU's (empty) state
    card_state.opt_G = torch.optim.Adam(card_state.generator.parameters(), lr=TRAIN_LR)
    card_state.opt_D = torch.optim.Adam(card_state.discriminator.parameters(), lr=TRAIN_LR)
    biases = [_keep_first_update_biases(s) for s in (state, card_state)]

    cpu_metrics = _run_train_step(cfg, state, batch, idx, alphas, "cpu", **options)
    spectral.reset_launch_counts()
    fft.fft_axis.launches = 0
    fwd, bwd, dtypes = [], [], set()
    with record_conv_tf32(fwd, bwd, dtypes):
        card_metrics = _run_train_step(cfg, card_state, batch, idx, alphas, device, **options)
    a, b = _snapshot(state), _snapshot(card_state)
    out = dict(
        dtype=dtype, **options, conv_dtypes=sorted(str(d) for d in dtypes),
        metrics={k: (cpu_metrics[k], card_metrics[k]) for k in cpu_metrics},
        convs_forward=len(fwd), convs_forward_tf32=int(sum(fwd)),
        convs_backward=len(bwd), convs_backward_tf32=int(sum(bwd)),
        k1_launches=spectral.row_pass.launches, k2_launches=spectral.row_adjoint.launches,
        k1_modes=dict(spectral.row_pass.launches_by_mode),
        k2_modes=dict(spectral.row_adjoint.launches_by_mode),
        k3_launches=fft.fft_axis.launches,
        **_critic_mean_excess(a["stats_D"], b["stats_D"], *biases),
    )
    for key in ("grad_G", "grad_D"):
        scale = max(float(t.abs().max()) for t in a[key].values())
        out[key + "_rel"] = max(float((a[key][k] - b[key][k]).abs().max()) for k in a[key]) / scale
    for key in ("stats_G", "stats_D"):
        out[key + "_excess"] = max(
            float(((a[key][k] - b[key][k]).abs() - STATS_RTOL * a[key][k].abs()).max())
            for k in a[key])
    return out


def check_train_step(stats: dict) -> None:
    """Raise ``AssertionError`` naming every bound that ``stats`` (from
    :func:`train_step_card_vs_cpu`) breaks."""
    bf16 = stats["dtype"] == "bfloat16"
    problems = []
    for k, (cpu, card) in stats["metrics"].items():
        rtol = BF16_METRIC_RTOL if bf16 else METRIC_RTOL
        if bf16 and k == "gan_loss":
            rtol = np.inf  # read through G_loss (above)
        elif bf16 and k == "D_loss":
            n = 1.0 + np.sqrt(abs(cpu) / TRAIN_LAMBDA)
            rtol *= 2 * n / (n - 1)
        if not (np.isfinite(cpu) and np.isfinite(card)) or abs(card - cpu) > rtol * abs(cpu) + 1e-6:
            problems.append(f"metric {k}: CPU {cpu:.6g}, card {card:.6g}")
    for key in ("grad_G_rel", "grad_D_rel"):
        tol = BF16_GRAD_TOL[key] if bf16 else GRAD_TOL
        if not stats[key] <= tol:
            problems.append(f"{key} {stats[key]:.3e} > {tol:g}")
    for key in ("stats_G_excess", "stats_D_excess"):
        tol = BF16_STATS_ATOL if bf16 else STATS_ATOL
        if not stats[key] <= tol:
            problems.append(f"{key} {stats[key]:.3e} > {tol:g}")
    if not bf16 and not stats["stats_D_mean_unexplained"] <= STATS_UNEXPLAINED:
        problems.append(f"critic running-mean excess {stats['stats_D_mean_unexplained']:.3e} where the "
                        f"conv bias in front moved apart by < lr/2 > {STATS_UNEXPLAINED:g}")
    problems += _dtype_problems(stats, ("torch.float32",))
    for part in ("forward", "backward"):
        n, on = stats[f"convs_{part}"], stats[f"convs_{part}_tf32"]
        if n == 0 or on != 0:
            problems.append(f"{on} of {n} convolutions ran their {part} with TF32 on")
    if stats["two_h_hat"]:
        # hat and target: one field-input per_plane call each; the backward
        # runs the hat's adjoint and AP2POH's; no spectrum, so no K3
        for name, want in (("k1", 2), ("k2", 1)):
            got = stats[f"{name}_modes"].get("field+per_plane", 0)
            if got != want:
                problems.append(f"{name.upper()} launched {got} times in mode field+per_plane, want {want}")
        if stats["k3_launches"] != 0:
            problems.append(f"K3 launched {stats['k3_launches']} times on the two-H path, want 0")
    for name in ("k1", "k2") if stats["two_h_hat"] else ("k1", "k2", "k3"):
        if stats[f"{name}_launches"] == 0:
            problems.append(f"{name.upper()} did not launch")
    if problems:
        raise AssertionError("train step: card and CPU disagree: " + "; ".join(problems))


def randomize_batch_norms(module: nn.Module, rng: np.random.Generator) -> nn.Module:
    """Give every BatchNorm of ``module`` seeded scale, bias and running
    statistics away from (1, 0, 0, 1), so that folding them is exercised."""
    from .nn.blocks import BatchNorm

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                n = m.num_features
                for t, draw in ((m.weight, rng.uniform(0.5, 1.5, n)), (m.bias, rng.normal(0, 0.1, n)),
                                (m.running_mean, rng.normal(0, 0.1, n)),
                                (m.running_var, rng.uniform(0.5, 1.5, n))):
                    t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return module


def fused_card_vs_cpu(device: str | torch.device = "cuda", seed: int = 7,
                      dtype: str = "float32") -> dict:
    """The fused eval path in ``dtype``, plain and polyphase level 0, on
    the CPU (K5's plain version) and on ``device`` (K5) from the same
    weights; returns the worst phasor differences and the card run's K5
    launches."""
    import copy

    from .config import GeneratorConfig
    from .models import generator_apply_fused, make_generator, make_generator_plan
    from .ops.cuda import conv_block

    f = FUSED
    cfg = GeneratorConfig(rows=f["hw"], cols=f["hw"], pad_size=f["pad"],
                          unet_base_features=f["unet_base"], dtype=dtype)
    rng = np.random.default_rng(seed)
    model = randomize_batch_norms(make_generator(cfg, seed=seed, device="cpu"), rng)
    rgbd = rng.random((f["batch"], 4, f["hw"], f["hw"])).astype(np.float32)
    pohs = []
    for dev in ("cpu", str(device)):
        m = copy.deepcopy(model).to(dev)
        plan = make_generator_plan(cfg, device=dev)
        x = torch.from_numpy(rgbd).to(dev)
        conv_block.reset_launch_counts()
        launches = []
        pohs.append([])
        for poly in (False, True):
            before = conv_block.fused_residual_block.launches
            poh = generator_apply_fused(m, plan, x, polyphase_level0=poly)
            launches.append(conv_block.fused_residual_block.launches - before)
            pohs[-1].append(poh.cpu().numpy())
    errs = [poh_phasor_errors(card, cpu) for cpu, card in zip(*pohs)]
    return dict(
        dtype=dtype, poh_gate=max(poh_gate_error(card, cpu) for cpu, card in zip(*pohs)),
        poh_mean=max(e[0] for e in errs), poh_p99=max(e[1] for e in errs),
        poh_max=max(e[2] for e in errs), finite=bool(all(np.isfinite(p).all() for p in pohs[1])),
        k5_launches=launches[0], k5_launches_polyphase=launches[1],
    )


def check_fused(stats: dict) -> None:
    """Raise ``AssertionError`` naming every bound that ``stats`` (from
    :func:`fused_card_vs_cpu`) breaks: the POH phasor bounds, finite output,
    K5 on all nine blocks (seven with polyphase level 0)."""
    if stats["dtype"] == "bfloat16":
        bounds = [("poh_gate", BF16_POH_TOL)]
    else:
        bounds = [("poh_mean", POH_MEAN_TOL), ("poh_p99", POH_P99_TOL), ("poh_max", POH_MAX_TOL)]
    problems = [f"{k} {stats[k]:.3e} > {tol:g}" for k, tol in bounds if not stats[k] <= tol]
    if not stats["finite"]:
        problems.append("non-finite POH")
    if stats["k5_launches"] != 9 or stats["k5_launches_polyphase"] != 7:
        problems.append(f"K5 launched {stats['k5_launches']} times (polyphase "
                        f"{stats['k5_launches_polyphase']}), want 9 (7)")
    if problems:
        raise AssertionError("fused path: card and CPU disagree: " + "; ".join(problems))


def stage2_step_card_vs_cpu(device: str | torch.device = "cuda", seed: int = 9) -> dict:
    """One stage-2 pretraining loss and its parameter gradients on the CPU
    (plain versions) and on ``device`` (K1, K3) from the same seeded AP2POH
    weights and (amp, phase) batch; returns both losses, the worst
    gradient difference relative to the largest |g|, and the card run's
    launches."""
    import copy

    from .config import OpticsConfig
    from .models import AP2POH
    from .nn.blocks import init_weights
    from .ops import asm
    from .ops.cuda import fft, spectral
    from .train.pretrain import ap2poh_loss

    s2 = STAGE2
    rng = np.random.default_rng(seed)
    shape = (s2["batch"], 3, s2["hw"], s2["hw"])
    amp = rng.random(shape, dtype=np.float32)
    phs = (2 * np.pi * rng.random(shape)).astype(np.float32)
    model = AP2POH()
    init_weights(model, torch.Generator().manual_seed(seed))
    optics = OpticsConfig(rows=s2["hw"], cols=s2["hw"], pad_size=s2["pad"],
                          filter_radius_coefficient=s2["frc"])
    losses, grads = [], []
    for dev in ("cpu", str(device)):
        m = copy.deepcopy(model).to(dev)
        plan = asm.make_plan(optics, distances=[1e-3], device=dev)
        batch = (torch.from_numpy(amp).to(dev), torch.from_numpy(phs).to(dev))
        spectral.reset_launch_counts()
        fft.fft_axis.launches = 0
        loss = ap2poh_loss(m, plan, batch, s2["frc"], s2["alpha"], s2["beta"])
        g = torch.autograd.grad(loss, list(m.parameters()))
        losses.append(float(loss.detach()))
        grads.append([t.cpu() for t in g])
    scale = max(float(t.abs().max()) for t in grads[0])
    return dict(
        loss=tuple(losses),
        grad_rel=max(float((a - b).abs().max()) for a, b in zip(*grads)) / scale,
        k1_modes=dict(spectral.row_pass.launches_by_mode),
        k2_launches=spectral.row_adjoint.launches, k3_launches=fft.fft_axis.launches,
    )


def serving_card_vs_cpu(device: str | torch.device = "cuda", seed: int = 11) -> dict:
    """The serving path (``tools/serve_poh.PohService``, float32 and the
    int8 stage 1) on the CPU (plain versions) and on ``device`` (K1, K3)
    from the same weights, the same int8 tree (calibrated once on the CPU
    and read by both servers from its ``.npz``) and the same RGBD; both
    focal stacks from the CPU's POH.  Returns the worst POH phasor and
    focal-stack differences of each mode and the card's launches."""
    from .config import GeneratorConfig
    from .models import make_generator
    from .nn.quant import quantize_unet_q8, save_qtree
    from .ops.cuda import fft, spectral
    from .tools import serve_poh
    from .train import checkpoint as ckpt_lib

    sv = SERVE
    hw, pad, base = sv["hw"], sv["pad"], sv["unet_base"]
    rng = np.random.default_rng(seed)
    cfg = GeneratorConfig(rows=hw, cols=hw, pad_size=pad, unet_base_features=base)
    model = randomize_batch_norms(make_generator(cfg, seed=seed, device="cpu"), rng)
    rgbd = rng.random((sv["batch"], 4, hw, hw)).astype(np.float32)
    stats = {}
    with tempfile.TemporaryDirectory(prefix="card_check_serve_") as tmp:
        weights, qtree = os.path.join(tmp, "G.msgpack"), os.path.join(tmp, "qtree.npz")
        ckpt_lib.save_weights(weights, model)
        save_qtree(quantize_unet_q8(model.part1.unet, torch.from_numpy(rgbd).permute(0, 2, 3, 1)), qtree)
        for quantize in ("none", "int8"):
            outs = []
            for dev in ("cpu", str(device)):
                spectral.reset_launch_counts()
                fft.fft_axis.launches = 0
                service = serve_poh.PohService(weights, hw, hw, pad, 0.45, base, "float32", sv["buckets"],
                                               cpu=dev == "cpu", quantize=quantize, qtree_path=qtree)
                try:
                    poh = service.submit(rgbd)
                    stack = service.focal_stack(outs[0][0] if outs else poh, list(sv["depths"]))
                finally:
                    service.close()
                launches = dict(k1=dict(spectral.row_pass.launches_by_mode), k3=fft.fft_axis.launches)
                outs.append((poh, stack))
            (cpu_poh, cpu_stack), (card_poh, card_stack) = outs
            mean, p99, worst = poh_phasor_errors(card_poh, cpu_poh)
            s = np.abs(card_stack - cpu_stack)
            stats[quantize] = dict(poh_mean=mean, poh_p99=p99, poh_max=worst,
                                   stack_p999=float(np.quantile(s, 0.999)), stack_max=float(s.max()),
                                   finite=bool(np.isfinite(card_poh).all() and np.isfinite(card_stack).all()),
                                   launches=launches)
    return stats


def check_serving(stats: dict) -> None:
    """Raise ``AssertionError`` naming every bound that ``stats`` (from
    :func:`serving_card_vs_cpu`) breaks: the POH phasor bounds and the
    propagation bounds in both modes, finite output, and the card's K1 and
    K3 launches (:data:`SERVE_LAUNCHES`)."""
    bounds = [("poh_mean", POH_MEAN_TOL), ("poh_p99", POH_P99_TOL), ("poh_max", POH_MAX_TOL),
              ("stack_p999", STACK_P999_TOL), ("stack_max", STACK_MAX_TOL)]
    problems = []
    for mode, st in stats.items():
        problems += [f"{mode}: {k} {st[k]:.3e} > {tol:g}" for k, tol in bounds if not st[k] <= tol]
        if not st["finite"]:
            problems.append(f"{mode}: non-finite output")
        if st["launches"] != SERVE_LAUNCHES:
            problems.append(f"{mode}: launches {st['launches']}, want {SERVE_LAUNCHES}")
    if problems:
        raise AssertionError("serving path: card and CPU disagree: " + "; ".join(problems))


def check_stage2_step(stats: dict) -> None:
    """Raise ``AssertionError`` naming every bound that ``stats`` (from
    :func:`stage2_step_card_vs_cpu`) breaks."""
    cpu, card = stats["loss"]
    problems = []
    if not (np.isfinite(cpu) and np.isfinite(card)) or abs(card - cpu) > METRIC_RTOL * abs(cpu):
        problems.append(f"loss: CPU {cpu:.6g}, card {card:.6g}")
    if not stats["grad_rel"] <= GRAD_TOL:
        problems.append(f"grad_rel {stats['grad_rel']:.3e} > {GRAD_TOL:g}")
    if stats["k1_modes"] != {"conj_h": 1}:
        problems.append(f"K1 launched {stats['k1_modes']}, want {{'conj_h': 1}}")
    if stats["k2_launches"] != 0:
        problems.append(f"K2 launched {stats['k2_launches']} times, want 0")
    if stats["k3_launches"] != STAGE2_K3_PER_STEP:
        problems.append(f"K3 launched {stats['k3_launches']} times, want {STAGE2_K3_PER_STEP}")
    if problems:
        raise AssertionError("stage-2 step: card and CPU disagree: " + "; ".join(problems))
