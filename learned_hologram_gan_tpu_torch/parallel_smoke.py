"""The multi-device and polyphase training legs on the card, at full width
(``chip_smoke.py``'s parallel phase).

The training configuration of PERF.md §4 (384², pad 320, batch 4, ratio
5, 20 distances, UNet base 64, critic feature_d 32, random VGG19), one
step from the same seeded weights, batch and draws in each leg, in
float32 and in bfloat16.  In the compared steps the critic's updates run
(gradients, their all-reduce, the optimizer) at a learning rate of 0, the
generator's at 1e-4 with SGD: Adam's first update is ~lr * sign(g), which
turns rounding noise into whole-lr steps of the critic before the
generator's loss reads it (the JAX package's multi-device tests use SGD
for the same reason), and SGD at any rate that moves this critic (feature_d
32 at 384², the penalty's gradients large) sends its scores to ~1e18 in
five updates.  So the generator's and the critic's gradients (the last
iteration's) are compared on one critic.  The timed steps run Adam at
1e-4 on both networks, as training does.

* **data-parallel at world size 1** under NCCL (a ``FileStore`` process
  group in this process): the cross-rank BatchNorm statistics, the
  focal and TV terms' global reductions, the gradient all-reduce and the
  gathered metrics all run, against the same step with no mesh, both
  under cuDNN's deterministic algorithms: metrics within :data:`DP_RTOL`
  relative (1e-6 absolute for those near 0) and the generator's and the
  critic's gradients within :data:`DP_RTOL` of max |g|.  A mesh's float32
  BatchNorm is ``nn.blocks._BatchNormF32``, not cuDNN's, so the step with
  no mesh it is held to runs its BatchNorms the same way
  (:func:`batch_norm_by_formula`); the distance between that step and the
  cuDNN one (the arithmetic alone) is printed beside it;
* **spatial mesh of 1**: every FFT of the step through the all-to-all
  pencil path (``torch.fft``; no K1, K2 or K3 launched), against the
  plain step at the JAX package's bound (``tests/test_sharded_fft.py:
  152``: rtol 2e-4, atol 2e-4 on the metrics);
* **polyphase level 0**: the stage-1 UNet at full width (384², batch 4,
  base 64) in train mode, polyphase against plain from the same
  parameters, forward and the backward of ``sum(y * w)`` (seeded normal
  ``w``), as ``tests/test_torch_polyphase_train.py`` holds the port to the
  JAX package: outputs within :data:`POLY_OUT` (rtol and atol), running
  statistics within :data:`POLY_STATS`, every parameter's gradient within
  :data:`POLY_GRADS` of the net's max |g|.  Then the whole GAN step,
  polyphase against plain: float32 metrics within 2e-3 (the port's step
  bound); its gradients, bfloat16's metrics and the floor (the plain step
  against itself with the batch reversed) are printed, not gated (a step's
  gradients move by 1e-2 of max |g| in float32 and by more than max |g|
  in bfloat16 when only the order of its batch changes).  Steps/s of both
  by the host clock over 2 steps after a warm-up, and their peak memory;
* **BatchNorm**: ``nn.blocks._BatchNormF32`` (every float32 BatchNorm of a
  data-parallel region and of the phase domain) against ``F.batch_norm``
  in float64 at every BatchNorm shape of the step: outputs, the input,
  weight and bias gradients, and their gradients again through a
  ``create_graph`` backward (the penalty's), each within :data:`BN_TOL` of
  its largest magnitude, on inputs and cotangents with a mean far from 0,
  so that a dropped mean term moves a result by O(1); ``F.batch_norm`` in
  float32 (cuDNN's) printed beside it;
* **generate_poh --mesh_devices 1** (the CLI on one 384² sample), then the
  focal stack at bench.py's configuration (batch 16, 3 planes) through a
  distance-sharded plan against the unsharded one: within 1e-6.

With two cards or more, also a 2-rank NCCL data-parallel step (each rank
on its half of the batch) against the one-device step, and the focal
stack with its backward through the spatial path on 1 card and across up
to 4, each card's peak memory beside the one card's; otherwise these legs
are reported as not run.  Every leg raises on failure.  Run alone:
``python -m learned_hologram_gan_tpu_torch.parallel_smoke``; with
``--multi_card``, only the legs that need two cards or more.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

ROWS = 384
PAD = 320
BATCH, RATIO, DISTANCES, BASE, FEATURE_D = 4, 5, 20, 64, 32
LR = 1e-4  # the generator's SGD in the compared steps; both networks' Adam in the timed ones
DP_RTOL = 1e-5
SPATIAL_TOL = 2e-4
POLY_METRICS = 2e-3
STACK_TOL = 1e-6
# the polyphase UNet's level 0 against the plain one: tests/test_torch_polyphase_train.py's
# bounds (the JAX package's tests/test_polyphase.py for outputs and running
# statistics; gradients 1e-2 of max |g| in float32).  bfloat16's gradients
# 5e-2: between two bfloat16 programs ~2^-9 of the pre-activations change
# side of a ReLU, which moves level 0's gradients by ~sqrt(0.4 * 2^-9) ~
# 3e-2 of max |g| whatever the size (1.9e-2 at 192^2, base 32 on the CPU);
# a zero, a sign flip or a missing term of 5 % or more fails it
POLY_OUT = {"float32": 3e-5, "bfloat16": 2e-2}
POLY_STATS = {"float32": 1e-5, "bfloat16": 5e-3}
POLY_GRADS = {"float32": 1e-2, "bfloat16": 5e-2}
BN_TOL = 1e-4
# the 2-rank step against one device: its metrics within 1e-4; its
# gradients within 5e-2 of max |g|, a fixed bound above the step's own
# floor at full width (1.35e-2: the same step with its batch in another
# order, every batch reduction summed otherwise) that an unaveraged, a
# one-rank or a local-statistics gradient (off by O(max |g|)) fails
TWO_RANK_METRICS, TWO_RANK_GRADS = 1e-4, 5e-2


def _counts():
    from .ops.cuda import fft, spectral

    return dict(k1=dict(spectral.row_pass.launches_by_mode),
                k2=dict(spectral.row_adjoint.launches_by_mode), k3=fft.fft_axis.launches)


def _reset(dev):
    from .ops.cuda import fft, spectral

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    spectral.reset_launch_counts()
    fft.fft_axis.launches = 0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def batch_norm_by_formula():
    """Inside the block every float32 train-mode :class:`~.nn.blocks.BatchNorm`
    runs ``nn.blocks._BatchNormF32`` (the arithmetic of a data-parallel
    region and of the phase domain) in place of cuDNN's: a step then
    differs from a mesh's step by the mesh alone.  Measurement only."""
    from .nn import blocks
    from .parallel import collectives

    plain = blocks.BatchNorm.forward

    def forward(self, x):
        if self.training and x.dtype == torch.float32:
            y, mean, fast = blocks._BatchNormF32.apply(x, self.weight, self.bias, self.eps, (0, 2, 3),
                                                       collectives.data_group())
            self.fold_batch_stats(mean, fast)
            return y
        return plain(self, x)

    blocks.BatchNorm.forward = forward
    try:
        yield
    finally:
        blocks.BatchNorm.forward = plain


def seeded_inputs(rows=ROWS, pad=PAD, batch=BATCH, ratio=RATIO, distances=DISTANCES, base=BASE,
                  feature_d=FEATURE_D, seed=41):
    """The seeded generator and critic ``state_dict``s (CPU), batch, draws
    and random VGG19 weights of every leg, and their shape."""
    from .config import DiscriminatorConfig, GeneratorConfig
    from .losses import load_vgg19_params
    from .models.discriminator import init_discriminator
    from .nn.blocks import init_weights
    from .train.state import build_modules

    g, d = build_modules(GeneratorConfig(rows=rows, cols=rows, unet_base_features=base),
                         DiscriminatorConfig(feature_d=feature_d), use_gan=True)
    gen = torch.Generator().manual_seed(seed)
    init_weights(g, gen)
    init_discriminator(d, gen)
    rng = np.random.default_rng(seed)
    batch_np = tuple(rng.random((batch, c, rows, rows), dtype=np.float32) for c in (4, 3, 3))
    return dict(gen=g.state_dict(), disc=d.state_dict(), vgg=load_vgg19_params(mode="random")[0],
                batch=batch_np, idx=rng.permutation(distances)[:batch],
                alphas=rng.random((ratio, batch, 1, 1, 1), dtype=np.float32),
                shape=dict(rows=rows, pad=pad, ratio=ratio, distances=distances, base=base,
                           feature_d=feature_d))


def step_run(inputs, dev, dtype="float32", *, mesh=None, spatial_mesh=None, poly=False,
             timed=0, formula_bn=False, reverse_batch=False, bn_shapes=None) -> dict:
    """One GAN step (SGD) from ``inputs`` on ``dev``: data-parallel over
    ``mesh`` (this rank's rows of the batch), row-sharded FFTs over
    ``spatial_mesh``, or the polyphase UNet; then, with Adam, one warm-up
    and ``timed`` more steps on the same batch; ``formula_bn`` runs the
    first step's float32 BatchNorms by :func:`batch_norm_by_formula`;
    ``reverse_batch`` takes the batch and its draws in reverse order (the
    same step, every batch reduction in another order); ``bn_shapes``, a
    set, gathers the input shape of every BatchNorm the first step runs.
    Returns the metrics, both networks' gradients, the launches and peak
    memory of the first step, steps/s of the timed ones and their peak
    memory."""
    from .nn.blocks import BatchNorm
    from .config import DiscriminatorConfig, GeneratorConfig, LossConfig
    from .losses import make_vgg19
    from .models import make_generator_plan
    from .ops import asm
    from .parallel import shard_batch
    from .train import build_train_step
    from .train.state import TrainState, build_modules

    s = inputs["shape"]
    cfg = GeneratorConfig(rows=s["rows"], cols=s["rows"], pad_size=s["pad"], filter_radius_coefficient=0.45,
                          unet_base_features=s["base"], dtype=dtype, polyphase_level0=poly)
    g, d = build_modules(cfg, DiscriminatorConfig(feature_d=s["feature_d"], dtype=dtype), use_gan=True)
    g.load_state_dict(inputs["gen"])
    d.load_state_dict(inputs["disc"])
    g.to(dev).train()
    d.to(dev).train()
    state = TrainState(step=0, generator=g, discriminator=d, opt_G=torch.optim.SGD(g.parameters(), lr=LR),
                       opt_D=torch.optim.SGD(d.parameters(), lr=0.0),
                       rng=torch.Generator().manual_seed(0), vgg=make_vgg19(inputs["vgg"], dev))
    gen_plan = make_generator_plan(cfg, device=dev)
    multi = asm.make_plan(cfg.optics(), distances=np.linspace(-4e-4, 0.0, s["distances"] + 1)[:-1],
                          device=dev)
    if spatial_mesh is not None:
        gen_plan, multi = gen_plan.with_spatial(spatial_mesh), multi.with_spatial(spatial_mesh)
    step = build_train_step(LossConfig(perceptual_loss_weight=0.1, discriminator_loss_weight=0.1,
                                       perceptual="random"), True, s["ratio"], 10.0, mesh=mesh,
                            spatial_mesh=spatial_mesh)
    order = slice(None, None, -1 if reverse_batch else 1)
    batch = tuple(torch.from_numpy(a[order].copy()).to(dev) for a in inputs["batch"])
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    draws = dict(idx=torch.from_numpy(inputs["idx"][order].copy()),
                 alphas=torch.from_numpy(inputs["alphas"][:, order].copy()))
    hooks = [] if bn_shapes is None else [
        m.register_forward_pre_hook(lambda _, args: bn_shapes.add(tuple(args[0].shape)))
        for net in (g, d) for m in net.modules() if isinstance(m, BatchNorm)]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the compared step
    try:
        _reset(dev)
        with batch_norm_by_formula() if formula_bn else contextlib.nullcontext():
            _, m = step(state, batch, gen_plan, multi, **draws)
        _sync(dev)
        for h in hooks:
            h.remove()
        out = dict(metrics={k: float(v) for k, v in m.items()}, launches=_counts(),
                   step_peak_gib=torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0,
                   grads={k: p.grad.double().cpu() for k, p in g.named_parameters() if p.grad is not None},
                   grads_D={k: p.grad.double().cpu() for k, p in d.named_parameters() if p.grad is not None})
        if timed:  # Adam and cuDNN's default algorithms, as training runs
            torch.backends.cudnn.deterministic = saved
            state.opt_G = torch.optim.Adam(g.parameters(), lr=LR)
            state.opt_D = torch.optim.Adam(d.parameters(), lr=LR)
            step(state, batch, gen_plan, multi, **draws)
            _reset(dev)
            start = time.perf_counter()
            for _ in range(timed):
                step(state, batch, gen_plan, multi, **draws)
            _sync(dev)
            out["steps_per_s"] = timed / (time.perf_counter() - start)
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    finally:
        torch.backends.cudnn.deterministic = saved
    del state, g, d, batch
    return out


def metric_rel(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-7) for k in b)


def metric_table(a: dict, b: dict) -> str:
    """Each metric of ``a`` beside ``b``'s, for a failure's message."""
    return ", ".join(f"{k} {a[k]:.7g} / {b[k]:.7g}" for k in b)


def metric_close(a: dict, b: dict, rtol: float, atol: float) -> bool:
    return all(abs(a[k] - b[k]) <= atol + rtol * abs(b[k]) for k in b)


# conv biases that feed a train-mode BatchNorm: the normalization removes
# them, so their gradient is 0 up to rounding (tests/test_torch_train.py's
# note) and is left out of the comparisons
BN_FED_BIAS = re.compile(r"(^|\.)(enc_\d|dec_\d|bottleneck)\.Conv_[01]\.bias$|^Conv_[1-5]\.bias$")


def grad_rel(a: dict, b: dict) -> float:
    """max |a - b| over a network's gradients, over max |b|, the biases
    that feed a BatchNorm left out."""
    keys = [k for k in b if not BN_FED_BIAS.search(k)]
    return max(float((a[k] - b[k]).abs().max()) for k in keys) / max(float(b[k].abs().max()) for k in keys)


def worst_grads(a: dict, b: dict, n: int = 3) -> str:
    """The ``n`` gradients farthest apart, relative to max |b|, for a
    failure's message."""
    scale = max(float(v.abs().max()) for v in b.values())
    d = sorted(((float((a[k] - b[k]).abs().max()) / scale, k) for k in b), reverse=True)[:n]
    return ", ".join(f"{k} {v:.2e}" for v, k in d)


def two_rank_step(rank, world_size, inputs, dtype, dev_type="cuda"):
    """One rank of a data-parallel step over all ranks (each on its rows):
    rank 0's metrics and generator gradients as numpy."""
    from .parallel import make_mesh

    dev = torch.device(dev_type, rank) if dev_type == "cuda" else torch.device(dev_type)
    out = step_run(inputs, dev, dtype, mesh=make_mesh(world_size))
    if rank:
        return None
    return dict(metrics=out["metrics"], grads={k: v.numpy() for k, v in out["grads"].items()})


def _launch_line(label, launches):
    return f"{label}: K1 {launches['k1']}, K2 {launches['k2']}, K3 {launches['k3']}"


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max()) / max(float(b.double().abs().max()), 1e-30)


def _level0(net, x, y_in, poly, ws, wo) -> dict:
    """``net``'s level 0 (``enc_0``; the last up-conv, ``dec_0`` and the
    head from its skip and ``y_in``) in train mode, plain or in the phase
    domain, and the backward of ``sum(skip * ws) + sum(out * wo)``: the
    skip and the output (NCHW, float32), the level-0 parameters' gradients
    and their BatchNorms' running statistics."""
    from .nn.polyphase import depth_to_space

    skip, _ = net.encode_level0(x, poly)
    out = net.decode_level0(skip, y_in, poly)
    if poly:
        skip = depth_to_space(skip).permute(0, 3, 1, 2)
    ((skip.float() * ws).sum() + (out.float() * wo).sum()).backward()
    return dict(skip=skip.detach().float(), out=out.detach().float(),
                grads={k: p.grad.detach().double() for k, p in net.named_parameters() if p.grad is not None},
                stats={k: v.detach().double() for k, v in net.state_dict().items()
                       if k.startswith(("enc_0.", "dec_0.")) and k.endswith(("running_mean", "running_var"))})


def unet_poly_leg(card, dtype, inputs, dev) -> dict:
    """The stage-1 UNet's level 0, the part that runs in the phase domain,
    polyphase against plain from the same parameters in train mode at
    full width: the skip and the output within :data:`POLY_OUT` (of
    1 + |y|), the running statistics within :data:`POLY_STATS`, and the
    gradients of ``sum(skip * ws) + sum(out * wo)`` within
    :data:`POLY_GRADS` of max |g| (in bfloat16 the conv biases that feed a
    BatchNorm left out: their gradient is 0 but for rounding).  The gated
    input is a seeded zero-mean normal RGBD batch, where the comparison is
    well conditioned; the dataset-like batch (uniform in [0, 1), mean 0.5)
    is printed beside it: its mean multiplies the rounding left in the
    first conv's gradient, a sum whose mean part cancels.  The inner
    levels run the same modules on both paths: their input to the last
    up-conv is computed once, by the plain path."""
    from .config import GeneratorConfig
    from .models import Generator
    from .nn.blocks import frozen_batch_stats, full_f32_convs

    s = inputs["shape"]
    n, r = inputs["batch"][0].shape[0], s["rows"]
    rng = np.random.default_rng(43)
    normal = torch.from_numpy(rng.standard_normal((n, 4, r, r), dtype=np.float32)).to(dev)
    ws = torch.from_numpy(rng.standard_normal((n, s["base"], r, r), dtype=np.float32)).to(dev)
    wo = torch.from_numpy(rng.standard_normal((n, 6, r, r), dtype=np.float32)).to(dev)
    readings = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_f32_convs():
            for label, x in (("zero-mean", normal), ("data-like", torch.from_numpy(inputs["batch"][0]).to(dev))):
                runs = {}
                for poly in (False, True):
                    g = Generator(GeneratorConfig(rows=r, cols=r, pad_size=s["pad"], unet_base_features=s["base"],
                                                  dtype=dtype, polyphase_level0=poly))
                    g.load_state_dict(inputs["gen"])
                    net = g.part1.unet.to(dev).train()
                    if not poly:
                        with torch.no_grad(), frozen_batch_stats(net):
                            y_in = net.inner(net.encode_level0(x, False)[1])
                    runs[poly] = _level0(net, x, y_in, poly, ws, wo)
                    del g, net
                _sync(dev)
                plain, poly = runs[False], runs[True]
                for k, v in plain["grads"].items():  # a gradient that never arrived is 0
                    poly["grads"].setdefault(k, torch.zeros_like(v))
                keep = [k for k in plain["grads"] if dtype == "float32" or not BN_FED_BIAS.search(k)]
                scale = max(float(plain["grads"][k].abs().max()) for k in keep)
                readings[label] = dict(
                    outputs=max(float(((poly[k] - plain[k]).abs() / (1.0 + plain[k].abs())).max())
                                for k in ("skip", "out")),
                    stats=max(float(((poly["stats"][k] - v).abs() / (1.0 + v.abs())).max())
                              for k, v in plain["stats"].items()),
                    grads=max(float((poly["grads"][k] - plain["grads"][k]).abs().max()) for k in keep) / scale,
                    worst=worst_grads({k: poly["grads"][k] for k in keep}, {k: plain["grads"][k] for k in keep}))
    finally:
        torch.backends.cudnn.deterministic = saved
    tol, stol, gtol = POLY_OUT[dtype], POLY_STATS[dtype], POLY_GRADS[dtype]
    for label, e in readings.items():
        print(f"[{dtype}] polyphase UNet level 0 against plain ({r}^2, batch {n}, base {s['base']}, train mode, "
              f"{label} input"
              f"{'' if label == 'zero-mean' else ', not gated'}): skip and output {e['outputs']:.2e} of 1 + |y| "
              f"(bound {tol:g}), running statistics {e['stats']:.2e} (bound {stol:g}), gradients "
              f"{e['grads']:.2e} of max|g| (bound {gtol:g}; farthest {e['worst']}) [{card}]", flush=True)
    e = readings["zero-mean"]
    if not (e["outputs"] <= tol and e["stats"] <= stol and e["grads"] <= gtol):
        raise AssertionError(f"[{dtype}] polyphase UNet level 0: outputs {e['outputs']:.3e}, statistics "
                             f"{e['stats']:.3e}, gradients {e['grads']:.3e} (bounds {tol:g}, {stol:g}, {gtol:g})")
    return {k: {m: v for m, v in e.items() if m != "worst"} for k, e in readings.items()}


def _bn_derivatives(fn, x, weight, bias, c, v) -> dict:
    """``y = fn(x, weight, bias)``, the gradients of ``sum(y * c)`` with
    respect to ``x``, ``weight`` and ``bias`` (built with ``create_graph``),
    and the gradients of ``sum(dx * v)`` with respect to the three again
    (the penalty's double backward)."""
    x, weight, bias = (t.detach().requires_grad_(True) for t in (x, weight, bias))
    y = fn(x, weight, bias)
    gx, gw, gb = torch.autograd.grad((y * c).sum(), (x, weight, bias), create_graph=True)
    hs = torch.autograd.grad((gx * v).sum(), (x, weight, bias), allow_unused=True)
    hx, hw, hb = (torch.zeros_like(t) if h is None else h for h, t in zip(hs, (x, weight, bias)))
    return dict(y=y.detach(), dx=gx.detach(), dweight=gw.detach(), dbias=gb.detach(),
                ddx=hx, ddweight=hw, ddbias=hb)


def batch_norm_leg(card, shapes, dev) -> dict:
    """``nn.blocks._BatchNormF32`` in float32 against ``F.batch_norm`` in
    float64 on the same inputs, at each of ``shapes`` (NCHW, statistics
    over N, H and W), and in the phase domain's layout ((N, H/2, W/2, 4,
    C), statistics over all but C) at the largest even one: every result
    of :func:`_bn_derivatives` within :data:`BN_TOL` of its largest
    magnitude.  ``F.batch_norm`` in float32 (cuDNN's on the card) is
    printed beside it, against the same float64 results and against the
    formula: at ~6e5 values a channel both float32 versions' second
    derivatives lie a few 1e-5 from float64, in different places."""
    import torch.nn.functional as F

    from .nn.blocks import BN_EPS, _BatchNormF32

    def ref(x, w, b):
        return F.batch_norm(x, None, None, w, b, training=True, momentum=0.0, eps=BN_EPS)

    def formula(x, w, b):
        return _BatchNormF32.apply(x, w, b, BN_EPS, (0, 2, 3), None)[0]

    def phase(x, w, b):
        n, c, h, wd = x.shape
        x5 = x.reshape(n, c, h // 2, 2, wd // 2, 2).permute(0, 2, 4, 3, 5, 1).reshape(n, h // 2, wd // 2, 4, c)
        y5 = _BatchNormF32.apply(x5, w, b, BN_EPS, (0, 1, 2, 3), None)[0]
        return y5.reshape(n, h // 2, wd // 2, 2, 2, c).permute(0, 5, 1, 3, 2, 4).reshape(x.shape)

    gen = torch.Generator(device=dev).manual_seed(47)

    def normal(shape, mean):
        return torch.randn(shape, generator=gen, device=dev) + mean

    def errs(got, want):
        out = {k: _rel(got[k], want[k]) for k in want if k != "ddbias"}
        out["ddbias"] = float(got["ddbias"].abs().max())  # 0 in exact arithmetic: dx does not depend on the bias
        return out

    shapes = sorted(shapes, key=lambda t: -math.prod(t))
    even = [t for t in shapes if t[2] % 2 == 0 and t[3] % 2 == 0 and t[2] > 1]
    cases = [(t, "NCHW", formula) for t in shapes] + ([(even[0], "phase", phase)] if even else [])
    worst, rows = 0.0, []
    for shape, layout, fn in cases:
        c = shape[1]
        x, cot, v = 2.0 * normal(shape, 0.5), normal(shape, 1.0), normal(shape, 1.0)
        weight, bias = 1.0 + 0.1 * normal((c,), 0.0), 0.1 * normal((c,), 0.0)
        exact = _bn_derivatives(ref, *(t.double() for t in (x, weight, bias, cot, v)))
        got = _bn_derivatives(fn, x, weight, bias, cot, v)
        lib = _bn_derivatives(ref, x, weight, bias, cot, v)
        e = errs(got, exact)
        worst = max(worst, max(e.values()))
        rows.append((shape, layout, e, max(errs(lib, exact).values()), max(errs(got, lib).values())))
        del x, cot, v, exact, got, lib
    _sync(dev)
    for shape, layout, e, lib_err, between in rows:
        print(f"BatchNorm formula (float32, {layout} {'x'.join(map(str, shape))}) against F.batch_norm in "
              f"float64: " + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) + f" (bound {BN_TOL:g}); "
              f"F.batch_norm in float32 against float64 {lib_err:.2e}, the formula against it {between:.2e} "
              f"[{card}]", flush=True)
    if not worst <= BN_TOL:
        raise AssertionError(f"_BatchNormF32 against F.batch_norm in float64: {worst:.3e} > {BN_TOL:g}")
    return dict(worst=worst, cases=len(rows), library=max(r[3] for r in rows), between=max(r[4] for r in rows))


def training_legs(card, dtype, mesh, inputs, dev) -> dict:
    """The data-parallel, spatial and polyphase legs in ``dtype``, and in
    float32 the BatchNorm leg at the step's BatchNorm shapes."""
    from .highres_smoke import expected_step_launches

    f32 = dtype == "float32"  # bfloat16's BatchNorm is the formula in both already
    shapes = set()
    plain = step_run(inputs, dev, dtype, timed=2, bn_shapes=shapes)
    reverse = step_run(inputs, dev, dtype, reverse_batch=True)
    floor = max(grad_rel(reverse["grads"], plain["grads"]), grad_rel(reverse["grads_D"], plain["grads_D"]))
    metric_floor = metric_rel(reverse["metrics"], plain["metrics"])
    formula = step_run(inputs, dev, dtype, formula_bn=True) if f32 else plain
    dp = step_run(inputs, dev, dtype, mesh=mesh)
    sp = step_run(inputs, dev, dtype, spatial_mesh=mesh)
    poly = step_run(inputs, dev, dtype, poly=True, timed=2)
    out = dict(plain=plain, dp=dp, spatial=sp, poly=poly)

    def rel3(r, base):
        return (metric_rel(r["metrics"], base["metrics"]), grad_rel(r["grads"], base["grads"]),
                grad_rel(r["grads_D"], base["grads_D"]))

    rel = dict(dp=rel3(dp, formula), spatial=rel3(sp, plain), poly=rel3(poly, plain),
               arithmetic=rel3(formula, plain))
    print(f"[{dtype}] the floor: the plain step with its batch reversed against it, metrics "
          f"{metric_floor:.2e}, gradients {floor:.2e} of max|g| [{card}]", flush=True)
    if f32:
        print(f"[{dtype}] plain step with its BatchNorms by the formula against cuDNN's: metrics "
              f"{rel['arithmetic'][0]:.2e}, G gradients {rel['arithmetic'][1]:.2e}, D gradients "
              f"{rel['arithmetic'][2]:.2e} of max|g| (the arithmetic alone) [{card}]", flush=True)
    print(f"[{dtype}] data-parallel (NCCL, world size 1) against no mesh, the same BatchNorm arithmetic: "
          f"metrics {rel['dp'][0]:.2e}, G gradients {rel['dp'][1]:.2e}, D gradients {rel['dp'][2]:.2e} of "
          f"max|g| (bound {DP_RTOL:g}); "
          + _launch_line("launches", dp["launches"]) + f" [{card}]", flush=True)
    print(f"[{dtype}] spatial mesh of 1 (row-sharded planes, pencil FFT) against the plain step: metrics "
          f"{rel['spatial'][0]:.2e} (bound rtol {SPATIAL_TOL:g}, atol {SPATIAL_TOL:g}), G gradients "
          f"{rel['spatial'][1]:.2e}, D gradients {rel['spatial'][2]:.2e} of max|g|; step peak "
          f"{sp['step_peak_gib']:.2f} GiB (plain step {plain['step_peak_gib']:.2f}); "
          + _launch_line("launches", sp["launches"]) + f" [{card}]", flush=True)
    print(f"[{dtype}] polyphase level 0, the whole step against the plain step: metrics "
          f"{rel['poly'][0]:.2e}" + (f" (bound {POLY_METRICS:g})" if f32 else " (not gated)")
          + f", G gradients {rel['poly'][1]:.2e}, D gradients {rel['poly'][2]:.2e} of max|g| (not gated); "
          f"plain {plain['steps_per_s']:.3f} steps/s, peak {plain['peak_gib']:.2f} GiB; polyphase "
          f"{poly['steps_per_s']:.3f} steps/s, peak {poly['peak_gib']:.2f} GiB (host clock, 2 steps "
          f"after a warm-up) [{card}]", flush=True)
    unet = unet_poly_leg(card, dtype, inputs, dev)
    bn = batch_norm_leg(card, shapes, dev) if f32 else None
    problems = []
    if not (metric_close(dp["metrics"], formula["metrics"], DP_RTOL, 1e-6) and max(rel["dp"][1:]) <= DP_RTOL):
        problems.append(f"data-parallel {rel['dp']}")
    if not metric_close(sp["metrics"], plain["metrics"], SPATIAL_TOL, SPATIAL_TOL):
        problems.append(f"spatial metrics {rel['spatial'][0]:.3e}")
    if f32 and not metric_close(poly["metrics"], plain["metrics"], POLY_METRICS, 1e-6):
        problems.append(f"polyphase step metrics {rel['poly'][0]:.3e}")
    # on the CPU nothing is launched: the counters stay 0 on every leg
    want = expected_step_launches(False) if dev.type == "cuda" else dict(k1={}, k2={}, k3=0)
    for label, r in (("plain", plain), ("data-parallel", dp), ("polyphase", poly)):
        if r["launches"] != want:
            problems.append(f"{label} launches {r['launches']}, want {want}")
    if sp["launches"] != dict(k1={}, k2={}, k3=0):
        problems.append(f"spatial launches {sp['launches']}, want none")
    for label, r in out.items():
        bad = [k for k, v in r["metrics"].items() if not np.isfinite(v)]
        if bad:
            problems.append(f"{label}: non-finite {bad}")
    if problems:
        for label, r, base in (("dp", dp, formula), ("spatial", sp, plain), ("poly", poly, plain)):
            print(f"[{dtype}] {label}: farthest G gradients {worst_grads(r['grads'], base['grads'])}; "
                  f"D {worst_grads(r['grads_D'], base['grads_D'])}", flush=True)
        for label in ("dp", "spatial", "poly"):
            print(f"[{dtype}] {label} against plain: {metric_table(out[label]['metrics'], plain['metrics'])}",
                  flush=True)
        raise AssertionError(f"[{dtype}] parallel legs: " + "; ".join(problems))
    return dict(rel=rel, floor=(metric_floor, floor), unet=unet, batch_norm=bn,
                launches={k: r["launches"] for k, r in out.items()},
                steps_per_s={k: out[k]["steps_per_s"] for k in ("plain", "poly")},
                peak_gib={k: out[k]["peak_gib"] for k in ("plain", "poly")},
                step_peak_gib={k: out[k]["step_peak_gib"] for k in ("plain", "spatial")})


def generate_poh_leg(card, mesh, dev) -> dict:
    """``generate_poh --mesh_devices 1`` on one sample, then bench.py's
    batch-16 focal stack through a distance-sharded plan against the
    unsharded one."""
    from . import generate_poh
    from .config import GeneratorConfig
    from .models import make_generator, make_generator_plan
    from .ops import asm
    from .ops.cuda import spectral
    from .parallel import shard_distance_stack

    with tempfile.TemporaryDirectory(prefix="parallel_smoke_") as tmp:
        rng = np.random.default_rng(1)
        for name in ("img", "depth"):
            rng.random((1, 3, ROWS, ROWS)).astype(np.float32).tofile(os.path.join(tmp, f"{name}.bin"))
        argv = ["--img_path", os.path.join(tmp, "img.bin"), "--depth_path", os.path.join(tmp, "depth.bin"),
                "--index", "0", "--model_path", os.path.join(tmp, "random_init.pt"),
                "--poh_output_path", os.path.join(tmp, "poh.npy"), "--samplesNum", "1", "--propagate",
                "--num_intervals", "3", "--output_image_dir", os.path.join(tmp, "recon"),
                "--dtype", "bfloat16", "--mesh_devices", "1", "--device", "cuda"]
        _reset(dev)
        result = generate_poh.main(argv)
        _sync(dev)
        cli = _counts()
        if sorted(os.listdir(os.path.join(tmp, "recon"))) != ["0.png", "1.png", "2.png"]:
            raise AssertionError("generate_poh --mesh_devices 1 wrote no focal stack")
    if not torch.isfinite(result["focal_stack"]).all() or tuple(result["focal_stack"].shape) != (3, 3, ROWS, ROWS):
        raise AssertionError("generate_poh --mesh_devices 1: focal stack not finite or of the wrong shape")

    cfg = GeneratorConfig(rows=ROWS, cols=ROWS, pad_size=PAD, filter_radius_coefficient=0.45, dtype="bfloat16")
    model = make_generator(cfg, seed=0, device=dev)
    gen_plan = make_generator_plan(cfg, device=dev)
    plan = asm.make_plan(cfg.optics(), distances=np.linspace(4e-4, 10e-4, 3), device=dev)
    rgbd = torch.from_numpy(np.random.default_rng(0).random((16, 4, ROWS, ROWS)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        poh = model(gen_plan, rgbd)
        whole = asm.propagate_batch_multi(plan, torch.ones_like(poh), poh)
        spectral.reset_launch_counts()
        sharded = asm.propagate_batch_multi(shard_distance_stack(plan, mesh), torch.ones_like(poh), poh)
        _sync(dev)
    k1 = spectral.row_pass.launches
    err = float((sharded - whole).abs().max())
    print(f"generate_poh --mesh_devices 1 (bf16, one 384^2 sample, 3 planes): " + _launch_line("launches", cli)
          + f"; bench.py's configuration (batch 16, 3 planes) through the distance-sharded plan against "
          f"the unsharded one: max abs {err:.2e} (bound {STACK_TOL:g}), K1 launches {k1} [{card}]", flush=True)
    if not err <= STACK_TOL or k1 != 1:
        raise AssertionError(f"distance-sharded focal stack: max abs {err:.3e}, K1 launches {k1} (want 1)")
    if cli["k1"] != {"conj_h": 1, "field": 1}:
        raise AssertionError(f"generate_poh --mesh_devices 1: K1 launches {cli['k1']}, want conj_h 1, field 1")
    del model, rgbd, poh, whole, sharded
    return dict(cli_launches=cli, stack_err=err, k1_launches=k1)


def two_rank_leg(card, inputs, plain) -> dict:
    """A 2-rank NCCL data-parallel step against the one-device step (its
    float32 BatchNorms by the formula, as a mesh's), on two cards, or a
    note that it did not run."""
    from .parallel import launch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"2-rank NCCL data-parallel leg: not run, {n} device(s) [{card}]", flush=True)
        return dict(ran=False, devices=n)
    got = launch.spawn(two_rank_step, 2, (inputs, "float32"), device="cuda", timeout_s=300.0,
                       join_timeout_s=600.0, threads=None)[0]
    grads = {k: torch.from_numpy(v) for k, v in got["grads"].items()}
    m_rel, g_rel = metric_rel(got["metrics"], plain["metrics"]), grad_rel(grads, plain["grads"])
    print(f"2-rank NCCL data-parallel step (float32) against one device: metrics {m_rel:.2e} (bound "
          f"{TWO_RANK_METRICS:g}), G gradients {g_rel:.2e} of max|g| (bound {TWO_RANK_GRADS:g}) [{card}]",
          flush=True)
    if not (metric_close(got["metrics"], plain["metrics"], TWO_RANK_METRICS, 1e-5) and g_rel <= TWO_RANK_GRADS):
        raise AssertionError(f"2-rank data-parallel step: metrics {m_rel:.3e}, gradients {g_rel:.3e}")
    return dict(ran=True, devices=n, metrics=m_rel, grads=g_rel)


def spatial_memory_rank(rank, world_size, dev_type="cuda", rows=ROWS, pad=PAD, batch=BATCH,
                        distances=DISTANCES):
    """One rank of the focal stack (``batch`` samples at ``distances``
    planes, H from the w-grid) and its backward through a plan bound to a
    mesh of all ranks: each rank's peak memory above what it held before,
    and rank 0's stack (every 7th plane) and input gradient."""
    from .config import OpticsConfig
    from .ops import asm
    from .parallel import make_mesh

    dev = torch.device(dev_type, rank) if dev_type == "cuda" else torch.device(dev_type)
    optics = OpticsConfig(rows=rows, cols=rows, pad_size=pad, filter_radius_coefficient=0.45)
    plan = asm.make_plan(optics, distances=np.linspace(-4e-4, 0.0, distances + 1)[:-1], device=dev,
                         cache_h=False).with_spatial(make_mesh(world_size))
    rng = np.random.default_rng(5)
    amp = torch.from_numpy(rng.random((batch, 3, rows, rows), dtype=np.float32)).to(dev).requires_grad_(True)
    phs = torch.from_numpy(rng.random((batch, 3, rows, rows), dtype=np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    stack = asm.propagate_batch_multi(plan, amp, phs)
    stack.sum().backward()
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**30 if dev.type == "cuda" else 0.0
    out = dict(peak_gib=peak)
    if rank == 0:
        out.update(stack=stack.detach()[::7].cpu().numpy(), grad=amp.grad.cpu().numpy())
    return out


def spatial_memory_leg(card) -> dict:
    """The focal stack and its backward through the row-sharded spatial
    path at the training configuration (batch 4, 20 planes, 384², pad
    320) on 1 card and on every card up to 4 (NCCL): each rank's peak
    memory, and the N-card results against the one-card ones at the JAX
    package's bounds (stack 2e-4, gradient atol 2e-3, rtol 1e-4); a note
    that it did not run with one card."""
    from .parallel import launch

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print(f"spatial mesh across cards: not run, {torch.cuda.device_count()} device(s) [{card}]", flush=True)
        return dict(ran=False)
    runs = {p: launch.spawn(spatial_memory_rank, p, (), device="cuda", timeout_s=300.0, join_timeout_s=600.0,
                            threads=None) for p in (1, n)}
    one, many = runs[1][0], runs[n][0]
    stack_err = float(np.abs(many["stack"] - one["stack"]).max())
    grad_ok = np.allclose(many["grad"], one["grad"], atol=2e-3, rtol=1e-4)
    grad_err = float(np.abs(many["grad"] - one["grad"]).max())
    peaks = [r["peak_gib"] for r in runs[n]]
    print(f"spatial mesh, focal stack + backward (batch {BATCH}, {DISTANCES} planes, {ROWS}^2, pad {PAD}): peak "
          f"per card {one['peak_gib']:.2f} GiB on 1 card, {max(peaks):.2f} GiB on {n} cards; {n} cards against 1: "
          f"stack max abs {stack_err:.2e} (bound 2e-4), gradient max abs {grad_err:.2e} (atol 2e-3, rtol 1e-4) "
          f"[{card}]", flush=True)
    if not (stack_err <= 2e-4 and grad_ok):
        raise AssertionError(f"spatial mesh of {n} cards: stack {stack_err:.3e}, gradient {grad_err:.3e}")
    return dict(ran=True, cards=n, peak_one=one["peak_gib"], peak_many=max(peaks), stack=stack_err, grad=grad_err)


def multi_card_legs(card, inputs) -> dict:
    """The legs that need two cards or more: the 2-rank NCCL data-parallel
    step against the one-device step, and the spatial mesh across cards."""
    plain = step_run(inputs, torch.device("cuda"), "float32", formula_bn=True) \
        if torch.cuda.device_count() >= 2 else None
    torch.cuda.empty_cache()  # the ranks on this card start from its whole memory
    return dict(two_rank=two_rank_leg(card, inputs, plain), spatial=spatial_memory_leg(card))


def run(card) -> dict:
    """Every leg; returns what chip_smoke.py prints and adds to the JSON
    line."""
    import torch.distributed as dist

    from .parallel import make_mesh

    dev = torch.device("cuda")
    start = time.perf_counter()
    inputs = seeded_inputs()
    tmp = tempfile.mkdtemp(prefix="parallel_smoke_store_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1)
        legs = {dtype: training_legs(card, dtype, mesh, inputs, dev) for dtype in ("float32", "bfloat16")}
        poh = generate_poh_leg(card, mesh, dev)
    finally:
        dist.destroy_process_group()
    multi = multi_card_legs(card, inputs)
    ran = ["data-parallel (world size 1, NCCL)", "spatial mesh of 1", "polyphase level 0",
           "generate_poh --mesh_devices 1"] + (["2-rank NCCL data-parallel"] if multi["two_rank"]["ran"] else []) \
        + ([f"spatial mesh of {multi['spatial']['cards']} cards"] if multi["spatial"]["ran"] else [])
    print(f"parallel legs run on {torch.cuda.device_count()} device(s): {', '.join(ran)}; "
          f"{time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return dict(legs=legs, generate_poh=poh, **multi)


def main() -> int:
    if not torch.cuda.is_available():
        print("parallel_smoke: no CUDA device; nothing run", file=sys.stderr, flush=True)
        return 1
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.splitlines()[0]
    if "--multi_card" in sys.argv[1:]:  # only the legs that need two cards or more
        if torch.cuda.device_count() < 2:
            print("parallel_smoke --multi_card: needs two cards or more", file=sys.stderr, flush=True)
            return 1
        multi_card_legs(card, seeded_inputs())
        return 0
    run(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
