"""The port's POH server (``learned_hologram_gan_tpu_torch/tools/serve_poh.py``)
in-process on the CPU: ``PohService`` behind ``make_handler`` on an
ephemeral port, driven over HTTP (the cases of tests/test_serve.py).

The generator's weights are seeded flax variables written as the JAX
package writes ``G.msgpack`` (tests/test_torch_tools._jax_generator_file);
the server loads them through the port's msgpack reader.  Replies are held
against the JAX package's functions on the same weights, never its
server: ``Generator.apply`` (the POH as phasors: mean <= 2e-3, p99 <= 1e-2,
max <= 5e-2, PERF.md section 2), ``freq2amp_at`` after
``propagate_poh2freq_forward`` (the propagation bound, <= 1e-3 at p99.9 and
4e-3 worst) and ``generator_apply_quant`` on the int8 server's own tree.
"""

import http.client
import json
import os
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import generator_apply_quant as jax_generator_apply_quant
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.nn import quant as jq
from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.train import checkpoint as jckpt
from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
from learned_hologram_gan_tpu_torch import card_check
from learned_hologram_gan_tpu_torch.tools import serve_poh
from test_torch_models import to_jax
from test_torch_ops import assert_close
from test_torch_tools import _jax_generator_file

ROWS = COLS = 16
PAD, BASE = 8, 2  # a 32 x 32 padded grid: K1's fused branch (its plain version here)
BUCKETS = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg():
    return JaxGenConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45,
                        unet_base_features=BASE)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A seeded G.msgpack and the JAX variables it holds."""
    path = str(tmp_path_factory.mktemp("serve") / "G.msgpack")
    _jax_generator_file(path, BASE, ROWS, COLS, seed=31)
    cfg = _jax_cfg()
    gen = JaxGenerator(cfg)
    plan = jax_gen_plan(cfg)
    state = JaxTrainState(step=0, key=None, params_G=None, batch_stats_G=None, params_D=None,
                          batch_stats_D=None, opt_state_G=None, opt_state_D=None, vgg_params=None)
    shapes = jax.eval_shape(lambda k: gen.init(k, plan, jnp.zeros((1, 4, ROWS, COLS)), train=False),
                            jax.random.key(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = state.replace(params_G=template["params"], batch_stats_G=template["batch_stats"])
    state = jckpt.load_generator(state, path)
    variables = {"params": state.params_G, "batch_stats": state.batch_stats_G}
    return path, gen, plan, variables


def _serve(service):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve_poh.make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _stop(srv, thread, service):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    service.close()
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server(weights):
    service = serve_poh.PohService(weights[0], ROWS, COLS, PAD, unet_base_features=BASE,
                                   buckets=BUCKETS, batch_timeout_ms=200.0, cpu=True)
    srv, thread = _serve(service)
    yield service, srv.server_address[1]
    _stop(srv, thread, service)


def _post(port, path, arr, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    body = np.ascontiguousarray(arr, np.float32).tobytes()
    conn.request("POST", path, body=body,
                 headers={"X-Batch": str(arr.shape[0]), "Content-Length": str(len(body)), **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def _poh(port, rgbd, headers=None):
    resp, data = _post(port, "/poh", rgbd, headers)
    assert resp.status == 200, data.decode()
    shape = tuple(int(v) for v in resp.getheader("X-Shape").split(","))
    return np.frombuffer(data, np.float32).reshape(shape)


def _health(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    conn.close()
    return health


def _jax_poh(weights, rgbd):
    _, gen, plan, variables = weights
    return np.asarray(jax.jit(lambda v, p, a: gen.apply(v, p, a, train=False))(
        to_jax(variables), plan, jnp.asarray(rgbd)))


def _assert_poh_close(got, want):
    mean, p99, worst = card_check.poh_phasor_errors(got, want)
    assert mean <= 2e-3 and p99 <= 1e-2 and worst <= 5e-2, (mean, p99, worst)


def _rgbd(seed, batch=1):
    return np.random.default_rng(seed).random((batch, 4, ROWS, COLS)).astype(np.float32)


def test_healthz_and_single_request(server, weights):
    service, port = server
    health = _health(port)
    assert health["buckets"] == list(BUCKETS) and health["quantize"] == "none"
    # the sum of the batch times beside their mean: a client reads its change
    assert health["mean_batch_ms"] == round(health["batch_ms_total"] / max(health["batches"], 1), 2)
    assert health["dtype"] == "float32" and (health["rows"], health["cols"]) == (ROWS, COLS)
    rgbd = _rgbd(0)
    poh = _poh(port, rgbd)
    assert poh.shape == (1, 3, ROWS, COLS) and np.isfinite(poh).all()
    assert poh.min() >= -2 * np.pi - 1e-3 and poh.max() <= 4 * np.pi + 1e-3
    _assert_poh_close(poh, _jax_poh(weights, rgbd))


def test_concurrent_requests_are_batched_and_deterministic(server, weights):
    """Four concurrent singles ride fewer batches than requests; the same
    input gives the same POH whichever batch carried it; a batch-2
    request equals two singles; a batch of 6 runs in chunks of the largest
    bucket (4, then 2 padded to its bucket)."""
    service, port = server
    reqs = [_rgbd(10 + i) for i in range(4)]
    outs = [None] * 4
    before = dict(service.stats)

    def call(i):
        outs[i] = _poh(port, reqs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    requests = service.stats["requests"] - before["requests"]
    batches = service.stats["batches"] - before["batches"]
    assert requests == 4 and batches < requests, (requests, batches)
    np.testing.assert_allclose(_poh(port, reqs[2]), outs[2], atol=1e-5)
    both = _poh(port, np.concatenate(reqs[:2]))
    np.testing.assert_allclose(both[0], outs[0][0], atol=1e-5)
    np.testing.assert_allclose(both[1], outs[1][0], atol=1e-5)
    six = _rgbd(20, batch=6)
    before = service.stats["batches"]
    got = _poh(port, six)
    assert got.shape == (6, 3, ROWS, COLS) and service.stats["batches"] - before == 2
    _assert_poh_close(got, _jax_poh(weights, six))


def test_bad_requests_are_400s(server):
    _, port = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/poh", body=b"short", headers={"X-Batch": "1", "Content-Length": "5"})
    resp = conn.getresponse()
    assert resp.status == 400 and b"expected" in resp.read()
    resp, data = _post(port, "/poh", _rgbd(1), {"X-Quantize": "u4"})
    assert resp.status == 400 and b"X-Quantize" in data
    poh = np.zeros((1, 3, ROWS, COLS), np.float32)
    resp, data = _post(port, "/focal_stack", poh)
    assert resp.status == 400 and b"X-Distances" in data
    resp, data = _post(port, "/focal_stack", poh, {"X-Distances": ",".join(["1e-4"] * 22)})
    assert resp.status == 400 and b"at most 21 distances" in data


def test_a_failure_reaches_every_waiter(server):
    """A batch that fails delivers the error to each request it carried."""
    service, _ = server
    bad = [np.zeros((1, 4, ROWS // 2, COLS // 2), np.float32) for _ in range(2)]
    errors = []

    def call(x):
        try:
            service.submit(x)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=call, args=(x,)) for x in bad]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert len(errors) == 2


def test_focal_stack_endpoint(server, weights):
    """POST /focal_stack at three depths that are not the plan's (a
    request of two pads to bucket 3), against the JAX package's
    freq2amp_at on the same POH."""
    _, port = server
    _, _, plan, _ = weights
    poh = _poh(port, _rgbd(5))
    for dists in ([-5e-4, 2.5e-4, 1.3e-3], [4e-4, 8e-4]):
        resp, data = _post(port, "/focal_stack", poh, {"X-Distances": ",".join(map(str, dists))})
        assert resp.status == 200, data.decode()
        shape = tuple(int(v) for v in resp.getheader("X-Shape").split(","))
        amp = np.frombuffer(data, np.float32).reshape(shape)
        assert amp.shape == (1, len(dists), 3, ROWS, COLS) and np.isfinite(amp).all() and amp.max() > 0
        want = jax.jit(lambda p, x, d: jasm.freq2amp_at(p, jasm.propagate_poh2freq_forward(p, x), d))(
            plan, jnp.asarray(poh), jnp.asarray(dists, jnp.float32))
        assert_close(amp, np.asarray(want))


@pytest.mark.parametrize("quant,levels", [("u16", 65536), ("u8", 256)])
def test_quantized_wire_formats(server, quant, levels):
    """X-Quantize u16 / u8: the phase mod 2*pi in 2^bits levels, within one
    quantization step of the f32 reply (circular distance)."""
    _, port = server
    rgbd = _rgbd(3)
    f32 = _poh(port, rgbd)
    resp, data = _post(port, "/poh", rgbd, {"X-Quantize": quant})
    assert resp.status == 200 and resp.getheader("X-Quantize") == quant
    scale = float(resp.getheader("X-Scale"))
    shape = tuple(int(v) for v in resp.getheader("X-Shape").split(","))
    q = np.frombuffer(data, np.uint16 if quant == "u16" else np.uint8).reshape(shape)
    assert len(data) == f32.nbytes * (2 if quant == "u16" else 1) // 4
    recon = q.astype(np.float64) / levels * scale
    d = np.abs(recon - np.mod(f32, 2 * np.pi))
    d = np.minimum(d, 2 * np.pi - d)
    assert d.max() <= 2 * np.pi / levels


def test_int8_server_serves_and_persists_qtree(weights, tmp_path):
    """--quantize int8: calibration from an RGBD .npy at start-up, the tree
    written to --qtree_path (and read by the JAX package's load_qtree),
    replies against the JAX package's generator_apply_quant on that tree;
    a second server loads the tree instead of calibrating."""
    calib, qtree_path = str(tmp_path / "calib.npy"), str(tmp_path / "qtree.npz")
    np.save(calib, np.random.default_rng(11).random((4, 4, ROWS, COLS)).astype(np.float32))
    service = serve_poh.PohService(weights[0], ROWS, COLS, PAD, unet_base_features=BASE, buckets=(1, 2),
                                   batch_timeout_ms=30.0, cpu=True, quantize="int8",
                                   qtree_path=qtree_path, calib_path=calib)
    srv, thread = _serve(service)
    try:
        port = srv.server_address[1]
        assert _health(port)["quantize"] == "int8" and os.path.exists(qtree_path)
        rgbd = _rgbd(2, batch=2)
        poh = _poh(port, rgbd)
        assert poh.shape == (2, 3, ROWS, COLS) and np.isfinite(poh).all()
        np.testing.assert_allclose(_poh(port, rgbd), poh, atol=1e-5)
        _, gen, plan, variables = weights
        want = np.asarray(jax.jit(lambda v, q, p, a: jax_generator_apply_quant(gen, v, q, p, a))(
            to_jax(variables), jq.load_qtree(qtree_path), plan, jnp.asarray(rgbd)))
        _assert_poh_close(poh, want)
    finally:
        _stop(srv, thread, service)
    again = serve_poh.PohService(weights[0], ROWS, COLS, PAD, unet_base_features=BASE, buckets=(2,),
                                 cpu=True, quantize="int8", qtree_path=qtree_path)
    try:
        np.testing.assert_array_equal(again.submit(rgbd), poh)
    finally:
        again.close()


def test_int8_server_needs_a_tree_or_a_calibration_batch(weights):
    with pytest.raises(SystemExit, match="--qtree_path"):
        serve_poh.PohService(weights[0], ROWS, COLS, PAD, unet_base_features=BASE, buckets=(1,),
                             cpu=True, quantize="int8")


def test_server_without_cpu_raises_on_a_host_without_a_card(weights):
    """No fallback: without --cpu the server wants the CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--cpu"):
        serve_poh.PohService(weights[0], ROWS, COLS, PAD, unet_base_features=BASE, buckets=(1,))
    with pytest.raises(RuntimeError, match="--cpu"):
        serve_poh.main(["--rows", str(ROWS), "--cols", str(COLS), "--pad_size", str(PAD),
                        "--unet_base_features", str(BASE), "--port", "0"])


def test_serving_card_check_on_cpu():
    """The serving card-vs-CPU check with the CPU in both places: identical
    POHs and stacks in float32 and int8, no launch (the CPU takes the
    plain versions), and check_serving() names the launches it misses."""
    stats = card_check.serving_card_vs_cpu("cpu")
    assert set(stats) == {"none", "int8"}
    for st in stats.values():
        assert st["poh_max"] == 0 and st["stack_max"] == 0 and st["finite"]
        assert st["launches"] == {"k1": {}, "k3": 0}
    with pytest.raises(AssertionError, match="launches"):
        card_check.check_serving(stats)
    card_check.check_serving({k: dict(v, launches=card_check.SERVE_LAUNCHES) for k, v in stats.items()})
    with pytest.raises(AssertionError, match="int8: poh_max"):
        card_check.check_serving({k: dict(v, launches=card_check.SERVE_LAUNCHES, poh_max=0.1 if k == "int8" else 0)
                                  for k, v in stats.items()})


def test_bench_serve_drives_server_processes(tmp_path):
    """tools/bench_serve starts the server's command line as a process for
    each mode (here --cpu, 16 x 16, base 2, batch 2, one request) and
    writes its summary; without a dataset it serves seeded random RGBD."""
    import socket

    from learned_hologram_gan_tpu_torch.tools import bench_serve

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "serving" / "summary.json"
    summary = bench_serve.main(["--cpu", "--rows", str(ROWS), "--cols", str(COLS), "--pad_size", str(PAD),
                                "--unet_base_features", str(BASE), "--batch", "2", "--reqs", "1",
                                "--model_path", str(tmp_path / "absent.msgpack"),
                                "--calib_data", str(tmp_path / "absent"), "--port", str(port),
                                "--startup_timeout", "120", "--out", str(out)])
    assert json.loads(out.read_text()) == summary
    for label, quantize in (("bf16", "none"), ("int8", "int8")):
        r = summary[label]
        assert r["quantize"] == quantize and r["wire_poh_per_s"] > 0 and r["wire_poh_per_s_u8"] > 0
        assert r["device_poh_per_s"] == round(1e3 * 2 / r["mean_batch_ms"], 1)
    assert (tmp_path / "serving" / "qtree_int8.npz").exists()


def test_bench_serve_device_rate_leaves_out_the_warm_up_batch(monkeypatch):
    """bench_serve's mean batch time is the change of /healthz's
    batch_ms_total over the change of its batches across the timed
    requests: a slow first (warm-up) batch does not enter it."""
    from learned_hologram_gan_tpu_torch.tools import bench_serve

    stats = {"batches": 0, "batch_ms_total": 0.0}

    def post(port, body, batch, wire_quant=None):
        stats["batch_ms_total"] += 900.0 if stats["batches"] == 0 else 10.0
        stats["batches"] += 1
        return b""

    monkeypatch.setattr(bench_serve, "_post", post)
    monkeypatch.setattr(bench_serve, "_healthz", lambda port: dict(
        stats, mean_batch_ms=stats["batch_ms_total"] / max(stats["batches"], 1)))
    rate, health, mean_ms = bench_serve.drive(0, np.zeros((2, 4, 3, 3), np.float32), reqs=8)
    assert mean_ms == pytest.approx(10.0)
    assert health["batches"] == 9 and health["mean_batch_ms"] == pytest.approx(980.0 / 9)
    assert rate > 0
