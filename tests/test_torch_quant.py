"""The port's int8 quantization (``nn/quant.py``, ``ops/int8.py``,
``generator_apply_quant``) against the JAX package's, on the CPU.

A tiny UNet (base 8, levels 2 and 3, 16 x 16, as tests/test_quant.py) gets
seeded variables (tests/test_torch_models.jax_variables: BatchNorm
statistics randomized, so folding is exercised), carried into the port by
``convert``.  The JAX side runs as its own tests run it, on XLA.

Bounds, with their reasons:
  * the int8 executor (im2col + ``torch._int_mm``): bit for bit against
    ``F.conv2d`` / ``matmul`` on int32 tensors (exact sums);
  * packed trees from the same weights and calibration batch: int8 codes
    identical except on at most 1e-4 of them, each at most 1 code apart
    (BatchNorm's fold may round 1 ulp apart, tests/test_parity_torch.py);
    the float leaves (``ws``, ``b``, ``xs``, the edges) within 1e-5 of the
    leaf's largest magnitude (the fold's ``(b - mean) * s + beta`` cancels
    to near zero on some channels, where a relative bound is meaningless);
  * ``unet_apply_q8`` / ``unet_apply_quant`` on one (JAX-made) tree in both
    packages: mean |d| <= 1e-4, max <= 2e-2 after the sigmoid (a requant
    code flips where the float dequant lands on a rounding tie; measured
    below 1e-8 mean and 6e-8 max at these sizes);
  * int8 against the port's own float path: the JAX tests' noise bands
    (dynamic mean < 0.01, max < 0.12; full-integer mean < 0.02, max < 0.2);
  * ``generator_apply_quant``: the POH as phasors, mean <= 2e-3, p99 <=
    1e-2, max <= 5e-2 (PERF.md section 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import generator_apply_quant as jax_generator_apply_quant
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.nn import blocks as jblocks
from learned_hologram_gan_tpu.nn import quant as jq
from learned_hologram_gan_tpu_torch import card_check, convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig
from learned_hologram_gan_tpu_torch.models import Generator, generator_apply_quant, make_generator_plan
from learned_hologram_gan_tpu_torch.nn import blocks, fused_unet, quant
from learned_hologram_gan_tpu_torch.ops import int8
from test_torch_models import jax_variables, to_jax

TREE_ATOL_REL, TREE_FLIP_FRACTION = 1e-5, 1e-4
SAME_TREE_MEAN, SAME_TREE_MAX = 1e-4, 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unet_pair(levels, batch=2, seed=7):
    """Seeded JAX UNet variables, the port UNet carrying them, an NHWC batch."""
    x = np.random.default_rng(seed).random((batch, 16, 16, 4)).astype(np.float32)
    jm = jblocks.UNet(output_channels=6, base_features=8, levels=levels)
    variables = jax_variables(jm, jnp.asarray(x), train=False, seed=seed + levels)
    m = blocks.UNet(in_channels=4, output_channels=6, base_features=8, levels=levels).eval()
    m.load_state_dict(convert.generator_state_dict(variables))
    return variables, m, x


@pytest.fixture(scope="module", params=[2, 3], ids=["levels2", "levels3"])
def pair(request):
    variables, m, x = _unet_pair(request.param)
    p, s = variables["params"], variables["batch_stats"]
    jtrees = {"dynamic": jq.quantize_unet(p, s, jnp.asarray(x)), "q8": jq.quantize_unet_q8(p, s, jnp.asarray(x))}
    return dict(variables=variables, unet=m, x=x, jtrees=jtrees, levels=request.param)


def to_port_tree(jtree):
    """A JAX qtree's leaves as torch tensors on the CPU, bit for bit."""
    return {group: {k: torch.from_numpy(np.array(v)) for k, v in q.items()} for group, q in jtree.items()}


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the arithmetic: activation quantization and the int8 executor
# ---------------------------------------------------------------------------


def test_quantize_act_exact_on_grid():
    """Values on the int8 grid come back as their codes, bit for bit, as in
    the JAX package; off-grid values round half to even as jnp.round."""
    scale = torch.tensor(np.float32(0.037))
    grid = torch.arange(-127, 128, dtype=torch.float32)
    np.testing.assert_array_equal(quant._quantize_act(grid * scale, scale).numpy(), np.arange(-127, 128))
    x = np.random.default_rng(0).normal(0, 3, 4096).astype(np.float32)
    want = np.asarray(jq._quantize_act(jnp.asarray(x), jnp.float32(0.037)))
    np.testing.assert_array_equal(quant._quantize_act(t(x), scale).numpy(), want)


# (batch, h, w, cin, cout, ksize): the stem (K = 36) and head-like (N = 6)
# shapes, K and N off multiples of 8, M <= 16, a 1x1 conv
CONV_CASES = {
    "stem_k36": (2, 5, 7, 4, 8, 3),
    "head_n6": (2, 6, 6, 16, 6, 1),
    "k27_n5_m9": (1, 3, 3, 3, 5, 3),
    "m4": (1, 2, 2, 8, 16, 3),
    "aligned": (3, 4, 4, 16, 8, 3),
}


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


def _oracle_conv(x, w):
    """int32 ``F.conv2d`` of NHWC codes by an HWIO kernel (exact)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).int(), w.permute(3, 2, 0, 1).int(), padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_matches_int32_oracle(case):
    n, h, w, cin, cout, k = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x, wk = _codes(rng, (n, h, w, cin)), _codes(rng, (k, k, cin, cout))
    before = int8.matmul.launches
    got = int8.conv2d(x, wk)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, h, w, cout)
    torch.testing.assert_close(got, _oracle_conv(x, wk), rtol=0, atol=0)
    assert int8.matmul.launches == before + 1


def test_int8_conv_sums_past_float32_exactly(monkeypatch):
    """64 channels of code 127 through a 3x3 kernel of 127s: 9 * 64 * 127^2
    = 9,290,304 at an interior pixel (an int8 F.conv2d wraps it to 64 on
    the CPU), with the im2col chunked one sample at a time."""
    monkeypatch.setattr(int8, "IM2COL_BYTES", 1)
    x = torch.full((2, 5, 5, 64), 127, dtype=torch.int8)
    w = torch.full((3, 3, 64, 4), 127, dtype=torch.int8)
    before = int8.matmul.launches
    y = int8.conv2d(x, w)
    assert int8.matmul.launches == before + 2
    assert int(y[1, 2, 2, 0]) == 9 * 64 * 127 ** 2
    torch.testing.assert_close(y, _oracle_conv(x, w), rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n", [(5, 12, 10), (40, 64, 24), (17, 3, 1)])
def test_int8_matmul_matches_int32_oracle(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = _codes(rng, (m, k)), _codes(rng, (k, n))
    got = int8.matmul(a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got, a.int() @ b.int(), rtol=0, atol=0)


def test_int8_weight_layout_is_padded_column_major():
    """The second operand goes to torch._int_mm padded to K, N multiples of
    8 and column-major (the pairing cuBLASLt's int8 GEMM supports)."""
    w = _codes(np.random.default_rng(1), (36, 6))
    wp = int8.pad_weight(w)
    assert tuple(wp.shape) == (40, 8) and wp.stride() == (1, 40)
    torch.testing.assert_close(wp[:36, :6], w, rtol=0, atol=0)
    assert not wp[36:].any() and not wp[:, 6:].any()


def test_int8_matmul_refuses_float_operands():
    with pytest.raises(TypeError, match="int8 operands"):
        int8.matmul(torch.zeros(20, 8), torch.zeros(8, 8, dtype=torch.int8))


@pytest.mark.parametrize("h,w", [(6, 8), (5, 7)])
def test_int8_max_pool_matches_float_pool(h, w):
    """The pooled int8 codes equal a float max pool of the codes (floor
    for odd sizes, as reduce_window VALID)."""
    x = _codes(np.random.default_rng(h * w), (2, h, w, 3))
    want = F.max_pool2d(x.float().permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    got = int8.max_pool2x2(x)
    assert got.dtype == torch.int8
    torch.testing.assert_close(got.float(), want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the packed trees, and carrying them across as .npz
# ---------------------------------------------------------------------------


def _assert_trees_close(got, want):
    assert set(got) == set(want)
    flips = total = 0
    for group, q in want.items():
        assert set(got[group]) == set(q), group
        for leaf, v in q.items():
            a, b = np.asarray(v), got[group][leaf].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (group, leaf)
            if a.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1, (group, leaf)
                flips, total = flips + int((d > 0).sum()), total + d.size
            else:
                np.testing.assert_allclose(b, a, rtol=TREE_ATOL_REL,
                                           atol=TREE_ATOL_REL * float(np.abs(a).max()), err_msg=f"{group}/{leaf}")
    assert flips <= TREE_FLIP_FRACTION * total, (flips, total)


def test_quantize_unet_matches_jax(pair):
    got = quant.quantize_unet(pair["unet"], t(pair["x"]))
    _assert_trees_close(got, pair["jtrees"]["dynamic"])
    assert quant.quantized_bytes(got) == jq.quantized_bytes(pair["jtrees"]["dynamic"])


def test_quantize_unet_q8_matches_jax(pair):
    got = quant.quantize_unet_q8(pair["unet"], t(pair["x"]))
    want = pair["jtrees"]["q8"]
    _assert_trees_close({k: v for k, v in got.items() if k != "edges"},
                        {k: v for k, v in want.items() if k != "edges"})
    for name, v in want["edges"].items():
        np.testing.assert_allclose(float(got["edges"][name]), float(v), rtol=TREE_ATOL_REL, err_msg=name)
    assert set(got["edges"]) == set(want["edges"])
    assert all(e.device.type == "cpu" and e.dtype == torch.float32 and e.dim() == 0
               for e in got["edges"].values())
    assert quant.quantized_bytes(got) == jq.quantized_bytes(want)


def _assert_same_leaves(a, b):
    assert set(a) == set(b)
    for group in a:
        assert set(a[group]) == set(b[group]), group
        for leaf in a[group]:
            x, y = np.asarray(a[group][leaf]), np.asarray(b[group][leaf])
            assert x.dtype == y.dtype and x.shape == y.shape, (group, leaf)
            np.testing.assert_array_equal(x, y)


def test_qtree_npz_crosses_both_ways_bit_for_bit(pair, tmp_path):
    """The JAX package's save_qtree .npz -> the port's load_qtree, and the
    port's save_qtree -> the JAX package's load_qtree: every leaf bit for
    bit; the loaded tree drives the port's apply as the original does."""
    jtree = pair["jtrees"]["q8"]
    jq.save_qtree(jtree, str(tmp_path / "jax.npz"))
    loaded = quant.load_qtree(str(tmp_path / "jax.npz"))
    _assert_same_leaves({g: {k: v.numpy() for k, v in q.items()} for g, q in loaded.items()},
                        {g: {k: np.asarray(v) for k, v in q.items()} for g, q in jtree.items()})
    ptree = quant.quantize_unet_q8(pair["unet"], t(pair["x"]))
    quant.save_qtree(ptree, str(tmp_path / "port.npz"))
    back = jq.load_qtree(str(tmp_path / "port.npz"))
    _assert_same_leaves({g: {k: np.asarray(v) for k, v in q.items()} for g, q in back.items()},
                        {g: {k: v.numpy() for k, v in q.items()} for g, q in ptree.items()})
    x = t(pair["x"])
    torch.testing.assert_close(quant.unet_apply_q8(loaded, x), quant.unet_apply_q8(to_port_tree(jtree), x),
                               rtol=0, atol=0)


def test_load_qtree_refuses_a_partial_tree(pair, tmp_path):
    """A file without ``edges/in`` or a conv path's ``ws`` is refused with
    the missing keys named (the JAX loader hands such a tree to the apply,
    which fails deep in its walk with a bare KeyError)."""
    jq.save_qtree(pair["jtrees"]["q8"], str(tmp_path / "full.npz"))
    with np.load(tmp_path / "full.npz") as z:
        flat = {k: z[k] for k in z.files}
    for drop in (["edges/in"], ["dec_0.c1/ws", "head/b"], ["ConvTranspose_0/w"]):
        np.savez(tmp_path / "partial.npz", **{k: v for k, v in flat.items() if k not in drop})
        with pytest.raises(ValueError, match="missing " + ", ".join(drop)):
            quant.load_qtree(str(tmp_path / "partial.npz"))


# ---------------------------------------------------------------------------
# the applies
# ---------------------------------------------------------------------------


def _diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.mean()), float(d.max())


def test_unet_apply_q8_same_tree_matches_jax(pair):
    jtree = pair["jtrees"]["q8"]
    want = np.asarray(jax.jit(jq.unet_apply_q8)(jtree, jnp.asarray(pair["x"])))
    got = quant.unet_apply_q8(to_port_tree(jtree), t(pair["x"])).numpy()
    assert got.shape == want.shape == pair["x"].shape[:3] + (6,)
    mean, worst = _diff(got, want)
    assert mean <= SAME_TREE_MEAN and worst <= SAME_TREE_MAX, (mean, worst)


def test_unet_apply_quant_same_tree_matches_jax(pair):
    v = pair["variables"]
    jtree = pair["jtrees"]["dynamic"]
    want = np.asarray(jax.jit(
        lambda q, p, s, a: jq.unet_apply_quant(q, p, s, a, dtype=jnp.float32)
    )(jtree, to_jax(v["params"]), to_jax(v["batch_stats"]), jnp.asarray(pair["x"])))
    got = quant.unet_apply_quant(to_port_tree(jtree), pair["unet"], t(pair["x"]), dtype=torch.float32).numpy()
    mean, worst = _diff(got, want)
    assert mean <= SAME_TREE_MEAN and worst <= SAME_TREE_MAX, (mean, worst)


def test_float_carveout_matches_fused_path(pair):
    """Every conv carved out as float: the walker is the fused eval UNet
    (tests/test_quant.py's structure check, 2e-5)."""
    levels = pair["levels"]
    paths = tuple(quant._conv_paths(levels))
    qtree = quant.quantize_unet(pair["unet"], t(pair["x"]), float_paths=paths)
    assert all("ws" not in q for q in qtree.values())
    got = quant.unet_apply_quant(qtree, pair["unet"], t(pair["x"]), dtype=torch.float32).numpy()
    want = fused_unet.unet_apply_fused(pair["unet"], t(pair["x"])).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_int8_paths_within_quantization_noise(pair):
    """The port's own int8 trees against its float path, at the JAX
    tests' noise bands."""
    x = t(pair["x"])
    want = fused_unet.unet_apply_fused(pair["unet"], x).numpy()
    dyn = quant.unet_apply_quant(quant.quantize_unet(pair["unet"], x), pair["unet"], x, dtype=torch.float32)
    mean, worst = _diff(dyn.numpy(), want)
    assert mean < 0.01 and worst < 0.12, (mean, worst)
    q8 = quant.unet_apply_q8(quant.quantize_unet_q8(pair["unet"], x), x)
    mean, worst = _diff(q8.numpy(), want)
    assert mean < 0.02 and worst < 0.2, (mean, worst)


def test_q8_tree_is_int8_end_to_end(pair):
    qtree = quant.quantize_unet_q8(pair["unet"], t(pair["x"]))
    convs = [k for k in qtree if k != "edges"]
    assert sorted(convs) == sorted(quant._conv_paths(pair["levels"]))
    assert all(qtree[k]["w"].dtype == torch.int8 for k in convs)


# ---------------------------------------------------------------------------
# generator_apply_quant
# ---------------------------------------------------------------------------

SMALL = dict(rows=32, cols=32, pad_size=16, filter_radius_coefficient=0.45,
             unet_base_features=4, distance=1e-3)


@pytest.fixture(scope="module")
def generators():
    jcfg = JaxGenConfig(**SMALL)
    jplan = jax_gen_plan(jcfg)
    rgbd = np.random.default_rng(70).random((2, 4, 32, 32)).astype(np.float32)
    jgen = JaxGenerator(jcfg)
    variables = jax_variables(jgen, jplan, jnp.asarray(rgbd[:1]), train=False, seed=71)
    model = Generator(GeneratorConfig(**SMALL)).eval()
    model.load_state_dict(convert.generator_state_dict(variables))
    return jgen, jplan, variables, model, rgbd


@pytest.mark.parametrize("mode", ["q8", "dynamic"])
def test_generator_apply_quant_matches_jax(generators, mode):
    """One JAX-made tree through both packages' generator_apply_quant."""
    jgen, jplan, variables, model, rgbd = generators
    p, s = variables["params"]["part1"]["unet"], variables["batch_stats"]["part1"]["unet"]
    calib = jnp.asarray(rgbd.transpose(0, 2, 3, 1))
    jtree = (jq.quantize_unet_q8 if mode == "q8" else jq.quantize_unet)(p, s, calib)
    want = np.asarray(jax.jit(
        lambda v, q, plan, a: jax_generator_apply_quant(jgen, v, q, plan, a)
    )(to_jax(variables), jtree, jplan, jnp.asarray(rgbd)))
    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    got = generator_apply_quant(model, to_port_tree(jtree), plan, t(rgbd)).numpy()
    assert got.shape == want.shape == (2, 3, 32, 32)
    mean, p99, worst = card_check.poh_phasor_errors(got, want)
    assert mean <= 2e-3 and p99 <= 1e-2 and worst <= 5e-2, (mean, p99, worst)


def test_generator_apply_quant_rejects_an_unknown_unet(generators):
    """A UNet the walker does not know (a block without its 1x1 shortcut)
    is refused before anything runs."""
    import copy

    model = copy.deepcopy(generators[3])
    model.part1.unet.enc_1.Conv_2 = None
    plan = make_generator_plan(GeneratorConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="standard UNet parameter layout"):
        generator_apply_quant(model, {"edges": {}}, plan, torch.zeros(1, 4, 32, 32))


# ---------------------------------------------------------------------------
# the serving smoke's executor check, on the CPU
# ---------------------------------------------------------------------------


def test_executor_shapes_cover_the_unet():
    """Every conv and up-conv product of a base-64, 4-level UNet: 9 blocks
    of three convs, 4 up-convs and the head, the stem's K = 36 and the
    head's N = 6 among them (from a walk on the meta device)."""
    from learned_hologram_gan_tpu_torch import serve_smoke

    shapes = serve_smoke.executor_shapes(batch=2, rows=384, cols=384, base=64)
    paths = [p for p, _, _ in shapes]
    assert sorted(paths) == sorted(quant._conv_paths(4)) and len(paths) == 32
    by_path = {p: (xs, ws) for p, xs, ws in shapes}
    assert by_path["enc_0.c0"] == ((2, 384, 384, 4), (3, 3, 4, 64))
    assert by_path["head"] == ((2, 384, 384, 64), (1, 1, 64, 6))
    assert by_path["dec_3.c0"][1] == (3, 3, 1024, 512)
    assert by_path["ConvTranspose_0"] == ((2, 24, 24, 1024), (1024, 2048))


@pytest.mark.parametrize("case", ["stem_k36", "head_n6"])
def test_serve_smoke_exact_cpu_products(case):
    """The smoke's CPU reference (F.unfold + float64 products) equals the
    int32 oracle, and so does the recorded executor's replay."""
    from learned_hologram_gan_tpu_torch import serve_smoke

    n, h, w, cin, cout, k = CONV_CASES[case]
    rng = np.random.default_rng(5)
    x, wk = _codes(rng, (n, h, w, cin)), _codes(rng, (k, k, cin, cout))
    torch.testing.assert_close(serve_smoke._exact_cpu(x, wk), _oracle_conv(x, wk), rtol=0, atol=0)
    a, b = _codes(rng, (2, 3, 4, 12)), _codes(rng, (12, 20))
    torch.testing.assert_close(serve_smoke._exact_cpu(a, b), (a.reshape(-1, 12).int() @ b.int()).reshape(2, 3, 4, 20),
                               rtol=0, atol=0)


def test_recording_executor_records_and_restores(pair, monkeypatch):
    """The smoke's split records each conv and up-conv product of one q8
    forward once, with events around it and around each product inside
    a conv, and puts the executor back, its launch count carried (CUDA
    events stubbed: this host has no device)."""
    from learned_hologram_gan_tpu_torch import serve_smoke

    class Event:
        def __init__(self, enable_timing=False):
            self.recorded = 0

        def record(self):
            self.recorded += 1

    monkeypatch.setattr(torch.cuda, "Event", Event)
    qtree = to_port_tree(pair["jtrees"]["q8"])
    conv2d, matmul = int8.conv2d, int8.matmul
    before = int8.matmul.launches
    calls = []
    with serve_smoke._recording_executor(calls):
        quant.unet_apply_q8(qtree, t(pair["x"]))
    assert int8.conv2d is conv2d and int8.matmul is matmul
    assert len(calls) == len(qtree) - 1
    assert sum(c[0] == "gemm" for c in calls) == pair["levels"]
    assert all(len(c[4]) == 1 and all(e.recorded == 1 for e in (*c[3], *c[4][0])) for c in calls)
    assert int8.matmul.launches - before == len(calls)
