"""The port's pretraining stages against the JAX package, on the CPU.

* ``ReduceLROnPlateau`` on fixed loss sequences: JAX's rates, exactly.
* The masks (``differentiable_circular_mask``, ``square_frequency_mask``,
  ``band_limit_mask``) and stage 2's asm primitives
  (``propagate_poh2ap_forward_with_spectrum_loss``,
  ``differentiable_lowpass_filter``): values, and the differentiable ones'
  vector-Jacobian products against ``jax.vjp`` at a seeded cotangent.
* One stage-1 and one stage-2 epoch (2 steps of 2 samples, one validation
  batch; UNet base 4, 32 x 32 in a 64 x 64 grid) from the same seeded
  variables, carried with ``convert``, against ``train_rgbd2ap`` /
  ``train_ap2poh``; the files the port writes, read by JAX.
* ``AmpPhsDataset`` against the JAX package's.

Tolerances, with their reasons:
  * masks: float32 rounding of the same expressions, 1e-6 (sigmoid), exact
    for the 0/1 masks;
  * the asm primitives: FFT propagation, the bound of tests/test_torch_ops.py
    (1e-3 at p99.9 of the largest value, 4e-3 worst), the spectrum loss (a
    mean over the grid) 1e-5 relative;
  * an epoch's losses: 2 Adam steps through float32 convs or FFTs, 1e-4
    relative;
  * parameters after an epoch with the shipped Adam: within 4 lr of JAX's.
    A conv bias feeding a train-mode BatchNorm has a gradient of exactly
    0, rounding noise on both sides, and Adam's first steps move such an
    element by +-lr with whichever sign each side drew (tests/test_torch_adam.py);
    BatchNorm running statistics 1e-5, plus the second step's batch means
    seen through such biases 2 lr apart, times momentum 0.01;
  * with SGD swapped in on both sides (the update reads back the summed
    gradient, as in tests/test_torch_train.py): 1e-3 of the largest
    movement of the network.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from learned_hologram_gan_tpu.config import OpticsConfig as JaxOpticsConfig
from learned_hologram_gan_tpu.data import memmap as jmemmap
from learned_hologram_gan_tpu.models import AP2POH as JaxAP2POH
from learned_hologram_gan_tpu.models import RGBD2AP as JaxRGBD2AP
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.ops import masks as jmasks
from learned_hologram_gan_tpu.train import pretrain as jpretrain
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import OpticsConfig
from learned_hologram_gan_tpu_torch.data import AmpPhsDataset
from learned_hologram_gan_tpu_torch.models import AP2POH, RGBD2AP
from learned_hologram_gan_tpu_torch.ops import asm, masks
from learned_hologram_gan_tpu_torch.train import pretrain
from test_torch_models import assert_stats_close, jax_variables

HW, PAD, FRC = 32, 16, 0.45
OPTICS = dict(rows=HW, cols=HW, pad_size=PAD, filter_radius_coefficient=FRC)


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

SEQUENCES = {
    "plateau": [1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
    # gains under the 1e-3 relative threshold count as bad epochs
    "threshold": [1.0, 0.9995, 0.9994, 0.9993, 0.9992, 0.9991, 0.9991, 0.998, 0.5, 0.4999, 0.4998,
                  0.4997, 0.4996, 0.4995, 0.4994],
    "noisy": list(np.random.default_rng(3).random(40) + np.linspace(1, 0.2, 40)),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("kw", [dict(), dict(factor=0.5, patience=1), dict(patience=0, min_lr=2e-4)],
                         ids=["reference", "factor_patience", "min_lr"])
def test_reduce_lr_on_plateau_matches_jax(name, kw):
    """The learning rates after each epoch's validation loss, and the
    scheduler's own counters, are JAX's."""
    ours, theirs = pretrain.ReduceLROnPlateau(1e-3, **kw), jpretrain.ReduceLROnPlateau(1e-3, **kw)
    got = [ours.step(float(v)) for v in SEQUENCES[name]]
    want = [theirs.step(float(v)) for v in SEQUENCES[name]]
    assert got == want
    assert (ours.best, ours.num_bad) == (theirs.best, theirs.num_bad)
    assert len(set(got)) > 1


# ---------------------------------------------------------------------------
# Masks and the stage-2 primitives
# ---------------------------------------------------------------------------


def test_differentiable_circular_mask_matches_jax():
    """sigmoid(radius - D) and its gradient in the radius."""
    grid = masks.radial_frequency_grid(64, 48)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jmasks.radial_frequency_grid(64, 48)))
    cot = np.random.default_rng(5).standard_normal((64, 48)).astype(np.float32)
    want, vjp = jax.vjp(lambda r: jmasks.differentiable_circular_mask(jnp.asarray(grid.numpy()), r),
                        jnp.float32(18.7))
    radius = torch.tensor(18.7, requires_grad=True)
    got = masks.differentiable_circular_mask(grid, radius)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(got, radius, torch.from_numpy(cot))
    np.testing.assert_allclose(float(g), float(vjp(jnp.asarray(cot))[0]), rtol=1e-5)


@pytest.mark.parametrize("rows,cols,x,y", [(16, 16, 0, 0), (16, 12, 3, 2), (9, 10, 4, 5)])
def test_square_frequency_mask_matches_jax(rows, cols, x, y):
    np.testing.assert_array_equal(masks.square_frequency_mask(rows, cols, x, y).numpy(),
                                  np.asarray(jmasks.square_frequency_mask(rows, cols, x, y)))
    with pytest.raises(ValueError, match="too large"):
        masks.square_frequency_mask(rows, cols, rows, 0)


def test_band_limit_mask_matches_jax():
    """Per (distance, wavelength) band limit on a 64 x 48 grid at 8 um
    pitch, distances from 0 to 0.1 m (the limit bites from ~1 mm)."""
    args = (64, 48, 8e-6, (638e-9, 520e-9, 450e-9), np.array([0.0, 2e-3, 3e-2, 0.1]))
    got = masks.band_limit_mask(*args)
    want = np.asarray(jmasks.band_limit_mask(*args))
    assert got.shape == want.shape == (4, 3, 64, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


@pytest.fixture(scope="module")
def plans():
    jplan = jasm.make_plan(JaxOpticsConfig(**OPTICS), distances=[1e-3])
    plan = asm.make_plan(OpticsConfig(**OPTICS), distances=[1e-3], device="cpu")
    np.testing.assert_array_equal(plan.radial_grid.numpy(), np.asarray(jplan.radial_grid))
    return jplan, plan


def assert_propagation_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want) / np.abs(want).max()
    assert np.quantile(d, 0.999) <= 1e-3 and d.max() <= 4e-3, (np.quantile(d, 0.999), d.max())


def _angle_close(got, want, weight):
    """Phases as phasors, weighted by the amplitude (a phase under zero
    amplitude is rounding noise)."""
    d = np.abs(np.exp(1j * np.asarray(got, np.float64)) - np.exp(1j * np.asarray(want, np.float64)))
    assert np.quantile(d * np.asarray(weight) / np.max(weight), 0.999) <= 1e-3


def test_spectrum_loss_primitive_matches_jax(plans):
    """POH -> (amp, phase, spectrum loss) through the sigmoid low-pass, and
    the POH's gradient of <amp, c> + spectrum loss at a seeded cotangent c."""
    jplan, plan = plans
    rng = np.random.default_rng(6)
    poh = (2 * np.pi * rng.random((2, 3, HW, HW))).astype(np.float32)
    cot = rng.standard_normal((2, 3, HW, HW)).astype(np.float32)

    def jloss(p):
        amp, phs, spec = jasm.propagate_poh2ap_forward_with_spectrum_loss(jplan, p, FRC)
        return jnp.sum(amp * cot) + spec, (amp, phs, spec)

    (jl, (jamp, jphs, jspec)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(poh))
    p = torch.from_numpy(poh).requires_grad_(True)
    amp, phs, spec = asm.propagate_poh2ap_forward_with_spectrum_loss(plan, p, FRC)
    (grad,) = torch.autograd.grad((amp * torch.from_numpy(cot)).sum() + spec, p)
    assert_propagation_close(amp.detach(), jamp)
    _angle_close(phs.detach(), jphs, jamp)
    np.testing.assert_allclose(float(spec.detach()), float(jspec), rtol=1e-5)
    assert float(spec.detach()) > 0  # the POH's spectrum spills outside the pass band
    assert_propagation_close(grad, jgrad)


def test_lowpass_filter_primitive_matches_jax(plans):
    """(amp, phs) -> low-passed (amp, phs), and both inputs' gradients of
    <amp_out, c1> + <sin(phs_out), c2>."""
    jplan, plan = plans
    rng = np.random.default_rng(7)
    amp = rng.random((2, 3, HW, HW)).astype(np.float32)
    phs = (2 * np.pi * rng.random((2, 3, HW, HW))).astype(np.float32)
    c1, c2 = (rng.standard_normal((2, 3, HW, HW)).astype(np.float32) for _ in range(2))

    def jfn(a, p):
        oa, op = jasm.differentiable_lowpass_filter(jplan, a, p, FRC)
        return jnp.sum(oa * c1) + jnp.sum(jnp.sin(op) * c2), (oa, op)

    (_, (joa, jop)), (jga, jgp) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(amp), jnp.asarray(phs))
    a, p = (torch.from_numpy(x).requires_grad_(True) for x in (amp, phs))
    oa, op = asm.differentiable_lowpass_filter(plan, a, p, FRC)
    ga, gp = torch.autograd.grad((oa * torch.from_numpy(c1)).sum()
                                 + (torch.sin(op) * torch.from_numpy(c2)).sum(), (a, p))
    assert_propagation_close(oa.detach(), joa)
    _angle_close(op.detach(), jop, joa)
    assert_propagation_close(ga, jga)
    assert_propagation_close(gp.numpy() * amp, np.asarray(jgp) * amp)  # phase gradients scale with |field|


# ---------------------------------------------------------------------------
# An epoch of each stage
# ---------------------------------------------------------------------------


def _stage1_data():
    rng = np.random.default_rng(8)
    return [(rng.random((2, 4, HW, HW), dtype=np.float32), rng.random((2, 3, HW, HW), dtype=np.float32),
             rng.random((2, 3, HW, HW), dtype=np.float32)) for _ in range(3)]


def _stage2_data():
    """(amp, 2 pi phs) as AmpPhsDataset gives them."""
    return [(a, (2 * np.pi * p).astype(np.float32)) for _, a, p in _stage1_data()]


def _run_stage1(lr, save_path=None):
    data = _stage1_data()
    jmodel = JaxRGBD2AP(base_features=4)
    v = jax_variables(jmodel, jnp.asarray(data[0][0]), seed=11)
    jp, jbs, jth, jvh = jpretrain.train_rgbd2ap(
        jmodel, v["params"], v["batch_stats"], lambda: iter(data[:2]), lambda: iter(data[2:]),
        epochs=1, lr=lr)
    model = RGBD2AP(base_features=4)
    model.load_state_dict(convert.generator_state_dict(v))
    before = {k: t.detach().clone() for k, t in model.state_dict().items()}
    model, th, vh = pretrain.train_rgbd2ap(model, lambda: iter(data[:2]), lambda: iter(data[2:]),
                                           epochs=1, lr=lr, save_path=save_path)
    return dict(v=v, jp=jp, jbs=jbs, jhist=(jth, jvh), model=model, hist=(th, vh), before=before)


def _run_stage2(lr, save_path=None, epochs=1, checkpoint_iterval=10):
    data = _stage2_data()
    jplan = jasm.make_plan(JaxOpticsConfig(**OPTICS), distances=[1e-3])
    plan = asm.make_plan(OpticsConfig(**OPTICS), distances=[1e-3], device="cpu")
    jmodel = JaxAP2POH(kernel_size=3)
    v = jax_variables(jmodel, jplan, jnp.asarray(data[0][0]), jnp.asarray(data[0][1]), seed=12)
    jp, jbs, jth, jvh = jpretrain.train_ap2poh(
        jmodel, jplan, v["params"], lambda: iter(data[:2]), lambda: iter(data[2:]),
        filter_radius_coefficient=FRC, epochs=epochs, lr=lr)
    model = AP2POH(kernel_size=3)
    model.load_state_dict(convert.generator_state_dict(v))
    before = {k: t.detach().clone() for k, t in model.state_dict().items()}
    model, th, vh = pretrain.train_ap2poh(model, plan, lambda: iter(data[:2]), lambda: iter(data[2:]),
                                          filter_radius_coefficient=FRC, epochs=epochs, lr=lr,
                                          save_path=save_path, checkpoint_iterval=checkpoint_iterval)
    return dict(v=v, jp=jp, jbs=jbs, jhist=(jth, jvh), model=model, hist=(th, vh), before=before)


def _carried_params(r):
    """JAX's trained params as the port's state_dict."""
    return convert.generator_state_dict({"params": jax.tree_util.tree_map(np.asarray, r["jp"]),
                                         "batch_stats": jax.tree_util.tree_map(np.asarray, r["jbs"])})


def _assert_epoch_close(r, lr, stats):
    for got, want in zip(r["hist"], r["jhist"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    want = _carried_params(r)
    for k, p in r["model"].named_parameters():
        moved = float((p.detach() - r["before"][k]).abs().max())
        assert 0 < moved <= 2 * lr * 1.01, (k, moved)
        assert float((p.detach() - want[k]).abs().max()) <= 4 * lr, k
    if stats:
        assert_stats_close(r["model"], r["jbs"], rtol=1e-5, atol=1e-5 + 0.01 * 2 * lr)


def test_stage1_epoch_matches_jax(tmp_path):
    """``train_rgbd2ap``, one epoch with the shipped Adam (lr 1e-3): the
    train and validation losses, the parameters and the running statistics
    against JAX's; the written ``.msgpack`` is JAX's variables tree and
    reads in flax to the port's values."""
    lr = 1e-3
    path = str(tmp_path / "rgbd2ap.msgpack")
    r = _run_stage1(lr, save_path=path)
    _assert_epoch_close(r, lr, stats=True)
    with open(path, "rb") as f:
        loaded = serialization.from_bytes({"params": r["jp"], "batch_stats": r["jbs"]}, f.read())
    got = convert.flax_variables(r["model"])
    for tree, want in got.items():
        for a, b in zip(jax.tree_util.tree_leaves(loaded[tree]), jax.tree_util.tree_leaves(want)):
            assert np.array_equal(np.asarray(a), b)
    assert set(loaded["params"]) == {"unet"}


def test_stage2_epoch_matches_jax(tmp_path):
    """``train_ap2poh``, one epoch with the shipped Adam: losses and
    parameters against JAX's; the written file holds ``"batch_stats": {}``
    and reads in flax."""
    lr = 1e-3
    path = str(tmp_path / "ap2poh.msgpack")
    r = _run_stage2(lr, save_path=path)
    _assert_epoch_close(r, lr, stats=False)
    with open(path, "rb") as f:
        data = f.read()
    raw = serialization.msgpack_restore(data)
    assert raw["batch_stats"] == {} and set(raw["params"]) == {"modulation"}
    loaded = serialization.from_bytes({"params": r["jp"], "batch_stats": {}}, data)
    want = convert.flax_variables(r["model"])["params"]
    for a, b in zip(jax.tree_util.tree_leaves(loaded["params"]), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("stage", [1, 2])
def test_stage_epoch_gradients_match_jax(monkeypatch, stage):
    """Both stages with SGD in place of Adam on both sides: the summed
    gradient of the epoch's two steps, read back from the parameters,
    against JAX's."""
    lr = 1e-2
    monkeypatch.setattr(jpretrain, "_plateau_tx",
                        lambda rate: optax.inject_hyperparams(optax.sgd)(learning_rate=rate))
    monkeypatch.setattr(torch.optim, "Adam", torch.optim.SGD)
    r = (_run_stage1 if stage == 1 else _run_stage2)(lr)
    for got, want in zip(r["hist"], r["jhist"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    want = _carried_params(r)
    params = dict(r["model"].named_parameters())
    scale = max(float((want[k] - r["before"][k]).abs().max()) for k in params)
    assert scale > 0
    for k, p in params.items():
        assert float((p.detach() - want[k]).abs().max()) <= 1e-3 * scale, k


def test_stage2_writes_epoch_checkpoints(tmp_path):
    """``_epoch{n}`` files where ``epoch % interval == 0 and epoch != 0``,
    then the final file; the loss stays finite."""
    path = str(tmp_path / "ap2poh.pt")
    r = _run_stage2(1e-3, save_path=path, epochs=3, checkpoint_iterval=2)
    assert sorted(os.listdir(tmp_path)) == ["ap2poh.pt", "ap2poh_epoch2.pt"]
    assert np.isfinite(r["hist"][0]).all() and len(r["hist"][0]) == 3
    for a, b in zip(r["hist"], r["jhist"]):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    sd = torch.load(path, weights_only=True)
    assert set(sd) == set(r["model"].state_dict())


def test_amp_phs_dataset_matches_jax(tmp_path):
    """(amp, 2 pi phs), the phase scaled once, as the JAX package's."""
    rng = np.random.default_rng(13)
    paths = []
    for name in ("amp", "phs"):
        paths.append(str(tmp_path / f"{name}.bin"))
        rng.random((3, 3, 8, 8)).astype(np.float32).tofile(paths[-1])
    ours = AmpPhsDataset(*paths, samples_num=3, height=8, width=8)
    theirs = jmemmap.AmpPhsDataset(*paths, samples_num=3, height=8, width=8)
    assert len(ours) == 3
    for i in range(3):
        for a, b in zip(ours[i], theirs[i]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError, match="Index out of range"):
        ours[3]
