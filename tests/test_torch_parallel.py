"""The port's multi-device layer on gloo CPU ranks, against the JAX
package's mesh (its 8 virtual CPU devices, tests/conftest.py) and against
the port's one-device functions.

The ranks run ``learned_hologram_gan_tpu_torch/parallel/rank_checks.run``
in processes started by ``parallel/launch.spawn`` (they import torch and
the port only), one spawn per world size for every check, rendezvous
through a ``FileStore`` in a temporary directory, one thread each, each
collective's wait bounded by 60 s and the whole run by ``JOIN_S``.

Bounds, with their reasons: the JAX package's own for the pencil FFT
(atol 1e-4, round trip 1e-5), spatial propagation and primitives (2e-4,
phase 2e-3), gradients through a spatially bound plan (atol 2e-3, rtol 1e-4),
the distance-sharded focal stack (1e-6) and the data-parallel steps
against one device (step 0: rtol 1e-4, atol 1e-5; ``separate`` over 3
steps: losses 2e-4, params rtol 5e-4 / atol 5e-6; ``full``: 5e-3, 5e-3,
2e-5; tests/test_parallel.py); the port's step bounds for the 2-rank step
against JAX's mesh step (metrics 2e-3, gradients 1e-2 of the net's largest
|g|, tests/test_torch_train.py).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.config import LossConfig as JaxLossConfig
from learned_hologram_gan_tpu.config import OpticsConfig as JaxOpticsConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.parallel import make_mesh as jmake_mesh
from learned_hologram_gan_tpu.parallel import replicate_state as jreplicate_state
from learned_hologram_gan_tpu.parallel import shard_batch as jshard_batch
from learned_hologram_gan_tpu.parallel.fft import sharded_fft2 as jsharded_fft2
from learned_hologram_gan_tpu.parallel.fft import sharded_propagate_batch_multi as jsharded_propagate
from learned_hologram_gan_tpu.train import steps as jsteps
from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.parallel import collectives, launch, mesh as mesh_lib, rank_checks
from test_torch_models import jax_variables, to_jax

JOIN_S = 240.0
RNG = np.random.default_rng(51)
KEY = 9  # the JAX spatial test's key for the random-distance draw


def _cplx(shape):
    return (RNG.random(shape) + 1j * RNG.random(shape)).astype(np.complex64)


def _f32(shape):
    return RNG.random(shape, dtype=np.float32)


PROP = dict(
    x=_cplx((2, 3, 32, 16)), x_rt=_cplx((1, 3, 64, 32)), amp=_f32((2, 3, 16, 16)),
    phs=_f32((2, 3, 16, 16)), poh=_f32((2, 3, 16, 16)),
    idx=np.asarray(jax.random.permutation(jax.random.key(KEY), 4)[:2]),
    stack_w=_f32((8, 3, 16, 16)), g_re=_f32((4, 3, 24, 24)), g_im=_f32((4, 3, 24, 24)),
    idx8=np.array([6, 2]),
)
COLLECTIVES = (RNG.random((8, 8)) + 0.5, RNG.random((8, 8)))
DP_BATCHES = [tuple(_f32((8, c, 16, 16)) for c in (4, 3, 3)) for _ in range(3)]
SMALL = tuple(_f32((2, c, 16, 16)) for c in (4, 3, 3))


@pytest.fixture(scope="module")
def jax_carried():
    """A 2-device JAX mesh step (SGD: G at lr 1, D at 1e-4, so the update
    reads back the gradient) from seeded variables, its draws recomputed
    from its key, and the port's state_dicts of the same variables."""
    jcfg = JaxGenConfig(rows=16, cols=16, pad_size=8, filter_radius_coefficient=0.45,
                        unet_base_features=2, distance=1e-3)
    jplan = jax_gen_plan(jcfg)
    jmulti = jasm.make_plan(jcfg.optics(), distances=np.linspace(-4e-4, 0.0, 5)[:-1])
    jgen, jcritic = JaxGenerator(jcfg), JaxCritic(feature_d=2)
    vg = jax_variables(jgen, jplan, jnp.asarray(SMALL[0][:1]), train=False, seed=61)
    vd = jax_variables(jcritic, jnp.asarray(SMALL[1][:1]), train=False, seed=62)
    tx_G, tx_D = optax.sgd(1.0), optax.sgd(1e-4)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), key=jax.random.key(63),
        params_G=to_jax(vg["params"]), batch_stats_G=to_jax(vg["batch_stats"]),
        params_D=to_jax(vd["params"]), batch_stats_D=to_jax(vd["batch_stats"]),
        opt_state_G=tx_G.init(to_jax(vg["params"])), opt_state_D=tx_D.init(to_jax(vd["params"])),
        vgg_params=None)
    _, dist_key, gp_base = jax.random.split(jstate.key, 3)
    idx = np.asarray(jax.random.permutation(dist_key, 4)[:2])
    alphas = np.stack([np.asarray(jax.random.uniform(k, (2, 1, 1, 1)))
                       for k in jax.random.split(gp_base, rank_checks.RATIO)])
    step = jsteps.build_train_step(jgen, jcritic, tx_G, tx_D, JaxLossConfig(perceptual="none"),
                                   use_gan=True, discriminator_train_ratio=rank_checks.RATIO,
                                   discriminator_lambda=10.0)
    mesh = jmake_mesh(2)
    jnew, jm = step(jreplicate_state(jstate, mesh), jshard_batch(SMALL, mesh), jplan, jmulti)
    grads = {}
    for net, old, new, lr, conv in (("G", vg, jnew.params_G, 1.0, convert.generator_state_dict),
                                    ("D", vd, jnew.params_D, 1e-4, convert.discriminator_state_dict)):
        delta = jax.tree_util.tree_map(lambda a, b: (np.asarray(a) - np.asarray(b)) / lr,
                                       old["params"], new)
        for k, v in conv({"params": delta, "batch_stats": old["batch_stats"]}).items():
            grads[f"{net}.{k}"] = v.numpy()
    sds = (convert.generator_state_dict(vg), convert.discriminator_state_dict(vd))
    return dict(metrics={k: float(v) for k, v in jm.items()}, grads=grads, idx=idx, alphas=alphas,
                state_dicts=tuple({k: v.numpy() for k, v in sd.items()} for sd in sds))


_SPAWNS = {}  # world size -> every rank's results, one spawn each


def _spawn(p, carried):
    if p not in _SPAWNS:
        spec = dict(propagation=PROP, collectives=COLLECTIVES, dp=DP_BATCHES,
                    dp_batchings=("separate", "full"), spatial=SMALL, distance=SMALL, dryrun=True)
        if p == 2:
            spec["carried"] = (*carried["state_dicts"], SMALL, carried["idx"], carried["alphas"])
        _SPAWNS[p] = launch.spawn(rank_checks.run, p, (spec,), join_timeout_s=JOIN_S)
    return _SPAWNS[p]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"{p}ranks")
def ranks(request, jax_carried):
    """Every rank's results of one spawn at this world size."""
    return request.param, _spawn(request.param, jax_carried)


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device results of the same checks."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dict(propagation=rank_checks.propagation(PROP),
                    collectives=rank_checks.collectives_formulas(*COLLECTIVES),
                    dp={cb: rank_checks.dp_steps(DP_BATCHES, cb) for cb in ("separate", "full")},
                    spatial=rank_checks.spatial_step(SMALL),
                    distance=rank_checks.distance_sharded_step(SMALL))
    finally:
        torch.set_num_threads(prev)


def test_pencil_fft_matches_jax(ranks):
    p, res = ranks
    mesh = jmake_mesh(p)
    got = res[0]["propagation"]
    np.testing.assert_allclose(got["fft2"], np.asarray(jsharded_fft2(jnp.asarray(PROP["x"]), mesh)),
                               atol=1e-4)
    np.testing.assert_allclose(got["roundtrip"], PROP["x_rt"], atol=1e-5)
    for r in res[1:]:  # a replicated result: the same on every rank
        np.testing.assert_array_equal(r["propagation"]["fft2"], got["fft2"])


def test_spatial_propagation_and_primitives_match_jax(ranks, one_device):
    """sharded_propagate_batch_multi, and the train step's spectral triple
    through a plan bound to the mesh, against the JAX package's on its
    p-device mesh (under its spatial_mesh) and against the port's
    unsharded path."""
    p, res = ranks
    got, ref = res[0]["propagation"], one_device["propagation"]
    mesh = jmake_mesh(p)
    optics = JaxOpticsConfig(rows=16, cols=16, pad_size=8, filter_radius_coefficient=0.45)
    plan = jasm.make_plan(optics, distances=np.linspace(4e-4, 1e-3, 3), cache_h=False)
    want = np.asarray(jsharded_propagate(plan, jnp.asarray(PROP["amp"]), jnp.asarray(PROP["phs"]), mesh))
    assert got["spatial_stack"].shape == want.shape == (6, 3, 16, 16)
    np.testing.assert_allclose(got["spatial_stack"], want, atol=2e-4)
    np.testing.assert_allclose(got["spatial_stack"], ref["spatial_stack"], atol=2e-4)

    cplan = jasm.make_plan(optics, distances=np.linspace(-4e-4, 0.0, 5)[:-1])
    with jasm.spatial_mesh(mesh):
        hat = jasm.propagate_poh2freq_forward(cplan, jnp.asarray(PROP["poh"]))
        tgt = jasm.filter_ap2filtered_freq(cplan, jnp.asarray(PROP["amp"]), jnp.asarray(PROP["phs"]))
        ja, jp = jasm.freq2ap_random_distances(cplan, jnp.concatenate([hat, tgt]), jax.random.key(KEY))
    for key, want, tol in (("triple_amp", ja, 2e-4), ("triple_phs", jp, 2e-3)):
        np.testing.assert_allclose(got[key], np.asarray(want), atol=tol, err_msg=key)
        np.testing.assert_allclose(got[key], ref[key], atol=tol, err_msg=key)


def test_spatial_gradient_matches_jax(ranks, one_device):
    """d sum(focal stack) / d amp through the pencil FFT's backward."""
    p, res = ranks
    optics = JaxOpticsConfig(rows=16, cols=16, pad_size=8, filter_radius_coefficient=0.45)
    plan = jasm.make_plan(optics, distances=np.linspace(-4e-4, 0.0, 5)[:-1])
    phs = jnp.asarray(PROP["phs"][:1])
    with jasm.spatial_mesh(jmake_mesh(p)):
        want = jax.grad(lambda a: jnp.sum(jasm.propagate_batch_multi(plan, a, phs)))(
            jnp.asarray(PROP["amp"][:1]))
    got = res[0]["propagation"]["spatial_grad"]
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(got, one_device["propagation"]["spatial_grad"], atol=2e-3, rtol=1e-4)


def test_spatial_spectra_stay_row_sharded(ranks, one_device):
    """Under a spatial binding a padded spectrum is this rank's rows only
    (pad to crop), and the spectrum loss, which reduces over all of them,
    and the low-pass filter still match the JAX package's spatial mesh and
    the port's one device, gradients included."""
    p, res = ranks
    got, ref = res[0]["propagation"], one_device["propagation"]
    for r in res:
        np.testing.assert_array_equal(r["propagation"]["spectrum_rows"], [32 // p, 32 // p])
    np.testing.assert_array_equal(ref["spectrum_rows"], [32, 32])
    optics = JaxOpticsConfig(rows=16, cols=16, pad_size=8, filter_radius_coefficient=0.45)
    plan = jasm.make_plan(optics, distances=np.linspace(-4e-4, 0.0, 5)[:-1])
    with jasm.spatial_mesh(jmake_mesh(p)):
        ja, _, jloss = jasm.propagate_poh2ap_forward_with_spectrum_loss(plan, jnp.asarray(PROP["poh"][:1]), 0.4)
        jlow, _ = jasm.differentiable_lowpass_filter(plan, jnp.asarray(PROP["amp"][:1]),
                                                     jnp.asarray(PROP["phs"][:1]), 0.4)
    for key, want in (("spectrum_loss", jloss), ("spectrum_amp", ja), ("lowpass_amp", jlow)):
        np.testing.assert_allclose(got[key], np.asarray(want), atol=2e-4, err_msg=key)
        np.testing.assert_allclose(got[key], ref[key], atol=2e-4, err_msg=key)
    np.testing.assert_allclose(got["spectrum_grads"], ref["spectrum_grads"], atol=2e-3, rtol=1e-4)


def test_distance_sharded_focal_stack_matches_unsharded(ranks, one_device):
    """Each rank's planes joined: the focal stack, the all-distance and the
    random-distance reconstructions, and the gradient of the replicated
    input through each, equal to one device's."""
    _, res = ranks
    ref = one_device["propagation"]
    for r in res:
        got = r["propagation"]
        for key in ("dist_stack", "dist_all_amp", "dist_all_phs", "dist_rnd_amp", "dist_rnd_phs"):
            np.testing.assert_allclose(got[key], ref[key], atol=1e-6, err_msg=key)
        for key in ("dist_stack_grad", "dist_g0_grad"):
            np.testing.assert_allclose(got[key], ref[key], atol=1e-5, rtol=1e-5, err_msg=key)


def test_collectives_double_backward(ranks, one_device):
    """A create_graph double backward through all_reduce (data-parallel)
    and through scatter, all-to-all, gather, copy and reduce (replicated)
    equals the one-process formula's."""
    p, res = ranks
    ref = one_device["collectives"]
    dp_g = np.concatenate([r["collectives"]["dp_g"] for r in res])
    np.testing.assert_allclose(dp_g, ref["dp_g"], rtol=1e-12, atol=1e-12)
    x, w = (torch.from_numpy(a) for a in COLLECTIVES)
    x.requires_grad_(True)
    w.requires_grad_(True)
    loss = ((x * x + x * (p * (p + 1) / 2)) * w).sum()
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (dw,) = torch.autograd.grad((g * g).sum(), w)
    for r in res:
        np.testing.assert_allclose(r["collectives"]["dp_dw"], ref["dp_dw"], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r["collectives"]["rep_g"], g.detach().numpy(), rtol=1e-12)
        np.testing.assert_allclose(r["collectives"]["rep_dw"], dw.numpy(), rtol=1e-12)


@pytest.mark.parametrize("critic_batching,loss_rtol,param_rtol,param_atol",
                         [("separate", 2e-4, 5e-4, 5e-6), ("full", 5e-3, 5e-3, 2e-5)])
def test_data_parallel_steps_match_one_device(ranks, one_device, critic_batching, loss_rtol,
                                              param_rtol, param_atol):
    """Three SGD steps with the batch split over the ranks against the same
    steps on one device (the JAX package's test_multidevice_training_
    equivalence, with its bounds)."""
    _, res = ranks
    losses_1, params_1 = one_device["dp"][critic_batching]
    losses_p, params_p = res[0]["dp"][critic_batching]
    for k in losses_1[0]:
        np.testing.assert_allclose(losses_p[0][k], losses_1[0][k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"step-0 {k}")
    for l1, lp in zip(losses_1, losses_p):
        for k in l1:
            np.testing.assert_allclose(lp[k], l1[k], rtol=loss_rtol, atol=2e-5, err_msg=k)
    for k in params_1:
        np.testing.assert_allclose(params_p[k], params_1[k], rtol=param_rtol, atol=param_atol,
                                   err_msg=k)
    for r in res[1:]:  # the replicas stay identical
        for k in params_p:
            np.testing.assert_array_equal(r["dp"][critic_batching][1][k], params_p[k])


def test_data_parallel_step_matches_jax_mesh_step(jax_carried):
    """One GAN step at 2 ranks (one sample each) from carried weights with
    JAX's draws, against the JAX package's step on its 2-device mesh."""
    metrics, grads, _, _ = _spawn(2, jax_carried)[0]["carried"]
    want = jax_carried
    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=2e-3, atol=1e-6, err_msg=k)
    for net in ("G", "D"):
        keys = [k for k in grads if k.startswith(net + ".")]
        scale = max(np.abs(want["grads"][k]).max() for k in keys)
        for k in keys:
            assert np.abs(grads[k] - want["grads"][k]).max() <= 1e-2 * scale, k


def test_spatial_and_distance_sharded_steps_match_one_device(ranks, one_device):
    """A GAN step with every FFT row-sharded (the JAX test's bounds: metrics
    rtol 2e-4 / atol 2e-4), and one with the distance stack split over the
    ranks plus its eval step (the same planes as one device: 1e-5)."""
    _, res = ranks
    m1, p1 = one_device["spatial"]
    m2, p2 = res[0]["spatial"]
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=2e-4, atol=2e-4, err_msg=k)
    diff = max(np.abs(p1[k] - p2[k]).max() for k in p1)
    assert diff < 5e-3, diff
    t1, e1, q1 = one_device["distance"]
    t2, e2, q2 = res[0]["distance"]
    for a, b in ((t2, t1), (e2, e1)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in q1:
        np.testing.assert_allclose(q2[k], q1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for r in res[1:]:
        for part in ("spatial", "distance"):
            for k, v in r[part][-1].items():
                np.testing.assert_array_equal(v, res[0][part][-1][k])


def test_multichip_dryrun_prints_the_three_lines(ranks):
    p, res = ranks
    lines = res[0]["dryrun"]
    assert [line.split(" OK")[0] for line in lines] == [
        f"dryrun_multichip({p})", f"dryrun_multichip({p}) spatial-mesh",
        f"dryrun_multichip({p}) distance-plane-sharded"]
    assert all(r["dryrun"] == [] for r in res[1:])


def test_hybrid_mesh_and_replicate_state(ranks):
    """make_hybrid_mesh's (replica, data) layout of consecutive ranks, and
    replicate_state making every rank's state (each initialized from its
    own seed) rank 0's."""
    p, res = ranks
    slices = 2 if p % 2 == 0 else 1
    per = p // slices
    for r in res:
        names, shape, coords, axes = r["mesh"]["hybrid"]
        assert names == ("replica", "data") and shape == (slices, per)
        assert coords == divmod(r["rank"], per) and axes == [(slices, coords[0]), (per, coords[1])]
        for k, v in res[0]["mesh"]["params"].items():
            np.testing.assert_array_equal(r["mesh"]["params"][k], v)
        np.testing.assert_array_equal(r["mesh"]["rng"], res[0]["mesh"]["rng"])
    fresh = rank_checks._params(rank_checks._sgd_state(rank_checks.tiny_trainer(batch=2), seed=0).generator)
    for k, v in fresh.items():
        np.testing.assert_array_equal(res[-1]["mesh"]["params"][k], v)


def test_mesh_helpers_without_ranks():
    """pad_batch_to_devices (edge repeat), the refusals that need no
    process group, and the collectives' identity outside a data mesh."""
    batch = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    padded, orig = mesh_lib.pad_batch_to_devices(batch, 4)
    assert padded.shape == (8, 2) and orig == 6
    np.testing.assert_array_equal(padded[6], padded[5])
    padded_t, _ = mesh_lib.pad_batch_to_devices((torch.from_numpy(batch),), 4)
    np.testing.assert_array_equal(padded_t[0].numpy(), padded)
    assert mesh_lib.initialize_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="all of"):
        mesh_lib.initialize_distributed(coordinator_address="tcp://localhost:1", num_processes=None)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mesh_lib.make_mesh(2)
    with pytest.raises(ValueError, match="one rank per GPU"):
        mesh_lib.check_device_count(torch.cuda.device_count() + 1, "cuda")
    x = torch.ones(3)
    assert collectives.data_group() is None
    assert collectives.data_mean(x) is x and collectives.data_max(x) is x
    assert mesh_lib.backend_for("cpu") == "gloo" and mesh_lib.backend_for("cuda") == "nccl"


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch.spawn(rank_checks.fail_on_rank, 2, (1,), join_timeout_s=JOIN_S)


def test_parallel_smoke_two_rank_leg_on_cpu_ranks():
    """chip_smoke's 2-rank leg (NCCL, where a host has two cards) on 2 gloo
    CPU ranks at 16 x 16, base 2: the data-parallel step against the
    one-device step (its float32 BatchNorms by the mesh's formula) from the
    same seeded inputs, through the helpers that gate it on the cards; the
    metrics at the cards' bound, the gradients at 1e-3 of max |g| (the
    cards' is looser: a full-width step's own floor is 1.35e-2)."""
    from learned_hologram_gan_tpu_torch import parallel_smoke as ps

    inputs = ps.seeded_inputs(rows=16, pad=8, batch=4, ratio=2, distances=6, base=2, feature_d=2)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = ps.step_run(inputs, torch.device("cpu"), formula_bn=True)
    finally:
        torch.set_num_threads(prev)
    got = launch.spawn(ps.two_rank_step, 2, (inputs, "float32", "cpu"), join_timeout_s=JOIN_S)[0]
    grads = {k: torch.from_numpy(v) for k, v in got["grads"].items()}
    assert ps.metric_close(got["metrics"], plain["metrics"], ps.TWO_RANK_METRICS, 1e-5), \
        ps.metric_table(got["metrics"], plain["metrics"])
    assert ps.grad_rel(grads, plain["grads"]) <= 1e-3


def test_parallel_smoke_spatial_memory_leg_on_cpu_ranks():
    """chip_smoke's spatial leg across cards (NCCL, where a host has two)
    on 1 and 2 gloo CPU ranks at 16 x 16, pad 8: the focal stack and its
    gradient through the row-sharded path agree at the bounds that gate
    it on the cards."""
    from learned_hologram_gan_tpu_torch import parallel_smoke as ps

    args = ("cpu", 16, 8, 2, 4)
    one, two = (launch.spawn(ps.spatial_memory_rank, p, args, join_timeout_s=JOIN_S)[0] for p in (1, 2))
    assert one["stack"].shape == (2, 3, 16, 16)
    np.testing.assert_allclose(two["stack"], one["stack"], atol=2e-4)
    np.testing.assert_allclose(two["grad"], one["grad"], atol=2e-3, rtol=1e-4)


def test_batchnorm_f32_function_is_f_batch_norm_twice_differentiable():
    """The float32 train-mode BatchNorm of the data-parallel region and the
    phase domain (``nn.blocks._BatchNormF32``): F.batch_norm's values and
    gradients, and its first and second derivatives by finite differences
    (float64) through the fused backward written in differentiable ops."""
    import torch.nn.functional as F

    from learned_hologram_gan_tpu_torch.nn.blocks import _BatchNormF32

    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(3, 4, 5, 6, generator=gen, dtype=torch.float64) * 3 + 7).requires_grad_(True)
    w = torch.rand(4, generator=gen, dtype=torch.float64).requires_grad_(True)
    b = torch.randn(4, generator=gen, dtype=torch.float64).requires_grad_(True)

    def bn(x, w, b):
        return _BatchNormF32.apply(x, w, b, 1e-5, (0, 2, 3), None)[0]

    assert torch.autograd.gradcheck(bn, (x, w, b))
    assert torch.autograd.gradgradcheck(bn, (x, w, b))
    xf, wf, bf = (t.detach().float().requires_grad_(True) for t in (x, w, b))
    dy = torch.randn(x.shape, generator=gen)
    y, mean, fast = _BatchNormF32.apply(xf, wf, bf, 1e-5, (0, 2, 3), None)
    got = torch.autograd.grad((y * dy).sum(), (xf, wf, bf))
    ref = F.batch_norm(xf, None, None, wf, bf, True, 0.0, 1e-5)
    want = torch.autograd.grad((ref * dy).sum(), (xf, wf, bf))
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mean, xf.detach().mean(dim=(0, 2, 3)))
    torch.testing.assert_close(fast, xf.detach().var(dim=(0, 2, 3), unbiased=False), rtol=1e-4, atol=1e-5)
