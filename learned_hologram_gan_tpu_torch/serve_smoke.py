"""The serving path at full width on the card, which ``chip_smoke.py`` runs
as its phase 13.

``tools/serve_poh.py``'s own defaults: 384 x 384, pad 320 (a 1024 x 1024
grid), UNet base 64 and levels 4, three wavelengths, filter 0.45, batch
buckets (1, 2, 4, 8), focal-stack buckets (1, 3, 8, 21); seeded random
weights and BatchNorm statistics, written as a flax ``.msgpack`` that the
server loads.  Each server is ``PohService`` behind ``make_handler`` on an
ephemeral port of a ``ThreadingHTTPServer`` in this process.

  1. the int8 executor (``ops/int8.py``: im2col + ``torch._int_mm``) at
     every conv and up-conv GEMM shape of that UNet at batch 2 of 384^2,
     seeded int8 codes, held bit for bit against exact integer products
     on the CPU (``F.unfold`` + a float64 matrix product: every partial sum
     of int8 x int8 products over K <= 9216 lies below 2^31 < 2^53, so
     float64 computes them exactly), the stem (K = 36) and head (N = 6)
     included; and ``torch._int_mm`` itself refusing an unpadded shape;
  2. the float32 and bfloat16 servers: 16 concurrent single-sample /poh
     requests (``batches < requests``), a batch-16 request (two chunks of
     bucket 8), a /focal_stack request at 0.45, 0.8 and 1.3 mm and one at
     21 depths; each /poh reply the row of a served batch that held its
     sample, bit for bit, and each served batch against ``Generator.forward``
     on that batch recomputed on the card (within 1e-5 as
     phasors), each focal stack against the plain versions
     of its kernels (``torch.fft.fft2`` for K3, the ``torch.fft`` chain for
     K1's ``from_spectrum``: 1e-4 of max |plain|), the u8 / u16 wire
     formats within one quantization step of the f32 reply, and the K1
     (``conj_h`` once a /poh batch, ``from_spectrum`` once a /focal_stack
     request) and K3 (twice a /focal_stack request) launches of the
     warm-up and of the traffic held to what the code makes;
  3. the int8 server (``--quantize int8``, calibrated from 8 seeded
     samples): its tree through ``save_qtree`` / ``load_qtree`` bit for
     bit, micro-batched traffic, the UNet output and the POH against the
     float32 path (the UNet within the CPU tests' full-integer noise band,
     mean < 0.02, max < 0.2), and ``torch.profiler`` showing stage 1 ran
     ``aten::_int_mm`` (cuBLASLt's int8 kernels, named) and no convolution;
  4. rates: the int8 pipeline at ``bench.py``'s configuration (batch 16,
     bfloat16 generator, ``generator_apply_quant`` + ``propagate_batch_multi``
     over 3 planes, 2 warm-ups, 5 trials of 10, median and spread) beside
     phase 7's bfloat16 rate, its stage-1 split by CUDA events (im2col /
     ``_int_mm`` in one forward, the dequantize-requantize epilogue
     replayed alone on the forward's shapes, the rest), its peak memory, and
     ``tools/bench_serve``'s summary for bfloat16 and int8 at batch 16.

It raises on any failure.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import socket
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F

ROWS = COLS = 384
PAD = 320
BASE = 64
BUCKETS = (1, 2, 4, 8)
SINGLES = 16
STACK_DEPTHS = (4.5e-4, 8e-4, 1.3e-3)
EXECUTOR_BATCH = 2
BENCH_BATCH, BENCH_DISTANCES = 16, np.linspace(4e-4, 10e-4, 3)
WARMUP, TRIALS, REPS = 2, 5, 10
POH_SAME_CARD_TOL = 1e-5
STACK_REL_TOL = 1e-4  # the kernels' gate against their plain versions
Q8_MEAN_TOL, Q8_MAX_TOL = 0.02, 0.2


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _reset_counts():
    from .ops.cuda import fft, spectral

    torch.cuda.synchronize()
    spectral.reset_launch_counts()
    fft.fft_axis.launches = 0


def _counts():
    from .ops.cuda import fft, spectral

    torch.cuda.synchronize()
    return dict(k1=dict(spectral.row_pass.launches_by_mode), k3=fft.fft_axis.launches)


def _expect(label, got, want):
    print(f"{label}: launches {got} (want {want})", flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def _model_file(path, dtype, seed=0):
    """A seeded random full-width generator with seeded BatchNorm
    statistics, written as flax variables; returns the model too."""
    from .card_check import randomize_batch_norms
    from .config import GeneratorConfig
    from .models import make_generator
    from .train import checkpoint as ckpt_lib

    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45,
                          unet_base_features=BASE, dtype=dtype)
    model = randomize_batch_norms(make_generator(cfg, seed=seed, device="cpu"), np.random.default_rng(seed))
    ckpt_lib.save_weights(path, model)
    return cfg, model.cuda()


@contextlib.contextmanager
def _http(service):
    from .tools import serve_poh

    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve_poh.make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
        service.close()


def _post(port, path, arr, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    body = np.ascontiguousarray(arr, np.float32).tobytes()
    conn.request("POST", path, body=body,
                 headers={"X-Batch": str(arr.shape[0]), "Content-Length": str(len(body)), **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path}: HTTP {resp.status}: {data[:200]!r}")
    shape = tuple(int(v) for v in resp.getheader("X-Shape").split(","))
    return resp, data, shape


def _poh(port, rgbd):
    _, data, shape = _post(port, "/poh", rgbd)
    return np.frombuffer(data, np.float32).reshape(shape)


def _concurrent_singles(port, rgbd):
    """One /poh request a sample, all at once; the replies in order."""
    outs = [None] * rgbd.shape[0]

    def call(i):
        outs[i] = _poh(port, rgbd[i:i + 1])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(rgbd.shape[0])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads) or any(o is None for o in outs):
        raise AssertionError("a concurrent /poh request did not complete")
    return np.concatenate(outs)


def _phasor_max(got, want):
    from .card_check import poh_phasor_errors

    return poh_phasor_errors(got, want)[2]


# ---------------------------------------------------------------------------
# 1. the int8 executor against exact CPU products
# ---------------------------------------------------------------------------


def executor_shapes(batch=EXECUTOR_BATCH, rows=ROWS, cols=COLS, base=BASE):
    """(path, NHWC input shape, kernel shape) of every conv (HWIO kernel)
    and up-conv GEMM ((cin, 4 cout) matrix) of the base-``base`` UNet at
    ``batch`` x ``rows`` x ``cols``, from a walk on the meta device."""
    from .nn.blocks import UNet
    from .nn.quant import _walk_unet

    unet = UNet(in_channels=4, output_channels=6, base_features=base).eval()
    shapes = []

    def conv(path, x, w, b):
        shapes.append((path, tuple(x.shape), tuple(w.shape)))
        return x.new_zeros(*x.shape[:3], w.shape[-1])

    def gemm(path, x, wmat, bias):
        shapes.append((path, tuple(x.shape), tuple(wmat.shape)))
        return x.new_zeros(*x.shape[:3], wmat.shape[-1])

    with torch.no_grad():
        _walk_unet(unet, torch.empty(batch, rows, cols, 4, device="meta"), conv, gemm)
    return shapes


def _exact_cpu(x, w):
    """int8 x int8 sums on the CPU in float64 (exact), as int32."""
    if w.dim() == 2:
        return (x.reshape(-1, x.shape[-1]).double() @ w.double()).to(torch.int32).reshape(*x.shape[:3], -1)
    k = w.shape[0]
    cols = F.unfold(x.permute(0, 3, 1, 2).double(), k, padding=k // 2)  # (N, k*k*cin in (cin, kh, kw))
    wm = w.permute(3, 2, 0, 1).reshape(w.shape[-1], -1).double()  # (cout, cin*kh*kw)
    y = (wm @ cols).to(torch.int32)  # (N, cout, H*W)
    return y.reshape(x.shape[0], w.shape[-1], x.shape[1], x.shape[2]).permute(0, 2, 3, 1)


def int8_executor(card):
    from .ops import int8

    shapes = executor_shapes()
    rng = np.random.default_rng(13)
    start = time.perf_counter()
    worst_k = []
    for path, xs, ws in shapes:
        x = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, ws, dtype=np.int8))
        xc, wc = x.cuda(), w.cuda()
        if len(ws) == 2:
            got = int8.matmul(xc.reshape(-1, xs[-1]), wc).reshape(*xs[:3], -1)
        else:
            got = int8.conv2d(xc, wc)
        want = _exact_cpu(x, w)
        if not torch.equal(got.cpu(), want):
            bad = int((got.cpu() != want).sum())
            raise AssertionError(f"int8 executor {path} {xs} x {ws}: {bad} int32 sums differ from the CPU")
        worst_k.append(int(np.prod(ws[:-1])))
        del xc, wc, got
    torch.cuda.synchronize()
    print(f"int8 executor on the card: {len(shapes)} conv / up-conv shapes of the base-{BASE} UNet at "
          f"batch {EXECUTOR_BATCH} of {ROWS}^2 (K from {min(worst_k)} to {max(worst_k)}, the stem's "
          f"K = 36 and the head's N = 6 padded) bit for bit against the CPU's exact products; "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    # the card's own shape rules: an unpadded stem product is refused, and raises
    a = torch.zeros(8, 36, dtype=torch.int8, device="cuda")
    b = torch.zeros(36, 6, dtype=torch.int8, device="cuda")
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        print(f"torch._int_mm refuses (8, 36) x (36, 6) on the card: {str(e).splitlines()[0][:120]}",
              flush=True)
    else:
        raise AssertionError("torch._int_mm took an (8, 36) x (36, 6) product on the card")
    if not torch.equal(int8.matmul(a, b), torch.zeros(8, 6, dtype=torch.int32, device="cuda")):
        raise AssertionError("the padded product is wrong")
    return dict(shapes=len(shapes))


# ---------------------------------------------------------------------------
# 2. the float32 and bfloat16 servers
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recording_batches(service, batches):
    """Record each device call of ``service``'s /poh path: the batch the
    micro-batcher padded to its bucket, and the POHs it gave."""
    infer = service._infer

    def recording(x):
        out = infer(x)
        batches.append((x.clone(), out.clone()))
        return out

    service._infer = recording
    try:
        yield
    finally:
        service._infer = infer


def _hold_pohs(label, samples, replies, batches, fn):
    """Each reply is, bit for bit, the row of a recorded batch whose input
    is its sample (the micro-batcher delivered the right rows), and each
    recorded batch's POHs are ``fn`` on that batch recomputed on the card,
    within POH_SAME_CARD_TOL as phasors: the same function on the same
    batch (in bfloat16 a sample's POH also depends on its batch size and
    position, which cuDNN's algorithms follow, so only the batch itself
    is a reference)."""
    for i in range(samples.shape[0]):
        x = torch.from_numpy(samples[i]).cuda()
        row = next(((out, j) for inp, out in batches for j in range(inp.shape[0]) if torch.equal(inp[j], x)), None)
        if row is None or not np.array_equal(row[0][row[1]].cpu().numpy(), replies[i]):
            raise AssertionError(f"{label}: reply {i} is not its sample's row of a served batch")
    worst = 0.0
    with torch.inference_mode():
        for inp, out in batches:
            worst = max(worst, _phasor_max(out.cpu().numpy(), fn(inp).cpu().numpy()))
    sizes = sorted(int(inp.shape[0]) for inp, _ in batches)
    print(f"{label}: {samples.shape[0]} replies are their rows of {len(batches)} served batches (sizes "
          f"{sizes}); each batch against the path's function recomputed on the card: worst phasor "
          f"distance {worst:.2e} (tol {POH_SAME_CARD_TOL:g})", flush=True)
    if worst > POH_SAME_CARD_TOL:
        raise AssertionError(f"{label}: a served batch is {worst:.2e} from the path's function")


def _plain_stack(plan, poh, dists):
    """The focal stack through the plain versions of K3 and K1
    (``torch.fft`` and the composable chain)."""
    from .ops import asm

    with torch.inference_mode():
        p = torch.from_numpy(np.ascontiguousarray(poh)).cuda()
        g0 = torch.fft.fft2(asm.pad(plan, asm.field(torch.ones_like(p), p))) * (asm._fixed_h(plan) * plan.mask)
        h = asm.transfer_function(plan, torch.tensor(dists, dtype=torch.float32)) * plan.mask
        out = asm.crop(plan, torch.fft.ifft2(g0[:, None] * h[None])).abs()
    return out.cpu().numpy()


def _wire_formats(port, rgbd):
    """The u16 and u8 replies against the f32 reply to the same single
    request (each a batch of its own, so all three compute alike)."""
    f32 = _poh(port, rgbd)
    for quant, levels in (("u16", 65536), ("u8", 256)):
        resp, data, shape = _post(port, "/poh", rgbd, {"X-Quantize": quant})
        q = np.frombuffer(data, np.uint16 if quant == "u16" else np.uint8).reshape(shape)
        recon = q.astype(np.float64) / levels * float(resp.getheader("X-Scale"))
        d = np.abs(recon - np.mod(f32.astype(np.float64), 2 * np.pi))
        d = np.minimum(d, 2 * np.pi - d).max()
        print(f"wire format {quant}: {len(data)} bytes, max circular distance from the f32 reply "
              f"{d:.3e} (one step {2 * np.pi / levels:.3e})", flush=True)
        if d > 2 * np.pi / levels:
            raise AssertionError(f"{quant} reply is {d:.3e} from the f32 reply")


def float_server(card, tmp, dtype):
    """Serve ``dtype`` at full width over HTTP; returns the traffic's K1
    and K3 launches."""
    from .models import make_generator_plan
    from .tools import serve_poh

    path = os.path.join(tmp, f"G_{dtype}.msgpack")
    cfg, model = _model_file(path, dtype)
    plan = make_generator_plan(cfg, device="cuda")
    _reset_counts()
    start = time.perf_counter()
    service = serve_poh.PohService(path, ROWS, COLS, PAD, 0.45, BASE, dtype, BUCKETS,
                                   batch_timeout_ms=50.0)
    print(f"{dtype} server start-up (load + warm-up of every bucket): "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    _expect(f"{dtype} warm-up", _counts(), dict(k1={"conj_h": len(BUCKETS), "from_spectrum": 4}, k3=8))
    rng = np.random.default_rng(21)
    singles = rng.random((SINGLES, 4, ROWS, COLS)).astype(np.float32)
    batch16 = rng.random((16, 4, ROWS, COLS)).astype(np.float32)
    batches = []
    with _http(service) as port:
        _reset_counts()
        with _recording_batches(service, batches):
            start = time.perf_counter()
            replies = _concurrent_singles(port, singles)
            wall = time.perf_counter() - start
            s = dict(service.stats)
            print(f"{dtype}: {SINGLES} concurrent single /poh requests in {wall * 1e3:.1f} ms: "
                  f"{s['requests']} requests, {s['batches']} batches, mean batch "
                  f"{s['batch_ms_total'] / s['batches']:.1f} ms [{card}]", flush=True)
            if not s["batches"] < s["requests"]:
                raise AssertionError(f"{dtype}: no micro-batching ({s['batches']} batches for "
                                     f"{s['requests']} requests)")
            before = dict(service.stats)
            start = time.perf_counter()
            big = _poh(port, batch16)
            wall = time.perf_counter() - start
            n = service.stats["batches"] - before["batches"]
            ms = (service.stats["batch_ms_total"] - before["batch_ms_total"]) / n
            print(f"{dtype}: one batch-16 /poh request in {wall * 1e3:.1f} ms: {n} batches of bucket 8, "
                  f"mean batch {ms:.1f} ms [{card}]", flush=True)
        _wire_formats(port, singles[:1])
        stacks = []
        for dists in (STACK_DEPTHS, tuple(np.linspace(-1e-3, 1e-3, 21))):
            _, data, shape = _post(port, "/focal_stack", replies[:1],
                                   {"X-Distances": ",".join(repr(float(d)) for d in dists)})
            stacks.append((dists, np.frombuffer(data, np.float32).reshape(shape)))
        counts = _counts()
        poh_batches = service.stats["batches"] - 2  # the two /focal_stack requests count one each
    _expect(f"{dtype} traffic", counts, dict(k1={"conj_h": poh_batches, "from_spectrum": 2}, k3=4))
    if big.shape != (16, 3, ROWS, COLS):
        raise AssertionError(f"batch-16 reply shape {big.shape}")
    _hold_pohs(f"{dtype} /poh", np.concatenate([singles, batch16]), np.concatenate([replies, big]),
               batches, lambda x: model(plan, x))
    del batches
    for dists, amp in stacks:
        if amp.shape != (1, len(dists), 3, ROWS, COLS) or not np.isfinite(amp).all():
            raise AssertionError(f"focal stack shape {amp.shape} or non-finite")
        want = _plain_stack(plan, replies[:1], dists)
        err = float(np.abs(amp - want).max() / np.abs(want).max())
        print(f"{dtype} /focal_stack at {len(dists)} depths against the plain versions of K3 and K1: "
              f"max rel {err:.2e} (tol {STACK_REL_TOL:g})", flush=True)
        if err > STACK_REL_TOL:
            raise AssertionError(f"{dtype} focal stack disagrees with the plain versions")
    del model
    torch.cuda.empty_cache()
    return dict(counts=counts)


# ---------------------------------------------------------------------------
# 3. the int8 server
# ---------------------------------------------------------------------------


def _same_tree(a, b):
    for group in a:
        for leaf, v in a[group].items():
            w = b[group][leaf]
            if v.dtype != w.dtype or not torch.equal(v.cpu(), w.cpu()):
                raise AssertionError(f"qtree {group}/{leaf} changed through save_qtree / load_qtree")
    if set(a) != set(b) or any(set(a[g]) != set(b[g]) for g in a):
        raise AssertionError("qtree keys changed through save_qtree / load_qtree")


def _int8_ops(fn):
    """torch.profiler over ``fn()``: the count of each CPU op, and the
    device kernels launched under ``aten::_int_mm``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()}
    return ops, prof


def int8_server(card, tmp):
    from .models import generator_apply_quant, make_generator_plan
    from .nn.quant import load_qtree, quantized_bytes, unet_apply_q8
    from .ops import int8
    from .tools import serve_poh

    path = os.path.join(tmp, "G_float32.msgpack")
    cfg, model = _model_file(path, "float32")
    plan = make_generator_plan(cfg, device="cuda")
    calib_path, qtree_path = os.path.join(tmp, "calib.npy"), os.path.join(tmp, "qtree_int8.npz")
    rng = np.random.default_rng(31)
    np.save(calib_path, rng.random((8, 4, ROWS, COLS)).astype(np.float32))
    start = time.perf_counter()
    service = serve_poh.PohService(path, ROWS, COLS, PAD, 0.45, BASE, "float32", BUCKETS,
                                   batch_timeout_ms=50.0, quantize="int8", qtree_path=qtree_path,
                                   calib_path=calib_path)
    print(f"int8 server start-up (load, calibration on 8 samples, save, warm-up): "
          f"{time.perf_counter() - start:.2f} s; packed tree {quantized_bytes(service.qtree) / 1e6:.2f} MB "
          f"against {sum(p.numel() * 4 for p in model.part1.unet.parameters()) / 1e6:.2f} MB of float32 "
          f"UNet parameters", flush=True)
    _same_tree(service.qtree, load_qtree(qtree_path, "cuda"))
    singles = rng.random((SINGLES, 4, ROWS, COLS)).astype(np.float32)
    batches = []
    with _http(service) as port:
        with _recording_batches(service, batches):
            replies = _concurrent_singles(port, singles)
        s = dict(service.stats)
        health = json.loads(_get(port, "/healthz"))
    print(f"int8: {s['requests']} requests, {s['batches']} batches, mean batch "
          f"{s['batch_ms_total'] / s['batches']:.1f} ms; healthz quantize {health['quantize']} [{card}]",
          flush=True)
    if not s["batches"] < s["requests"] or health["quantize"] != "int8":
        raise AssertionError("int8 server: no micro-batching, or not int8")
    qtree = service.qtree
    x = torch.from_numpy(singles[:8]).cuda()
    with torch.inference_mode():
        y8 = unet_apply_q8(qtree, x.permute(0, 2, 3, 1))
        y32 = model.part1.unet(x).permute(0, 2, 3, 1)
        poh8 = generator_apply_quant(model, qtree, plan, x).cpu().numpy()
        poh32 = model(plan, x).cpu().numpy()
    d = (y8 - y32).abs()
    mean, worst = float(d.mean()), float(d.max())
    from .card_check import poh_phasor_errors

    pm, p99, pmax = poh_phasor_errors(poh8, poh32)
    print(f"int8 against float32 on 8 samples: UNet output mean |d| {mean:.3e} max {worst:.3e} "
          f"(band {Q8_MEAN_TOL:g} / {Q8_MAX_TOL:g}); POH as phasors mean {pm:.3e} p99 {p99:.3e} "
          f"max {pmax:.3e}", flush=True)
    if not (mean < Q8_MEAN_TOL and worst < Q8_MAX_TOL):
        raise AssertionError("the int8 UNet is outside the quantization-noise band")
    _hold_pohs("int8 /poh", singles, replies, batches, lambda xb: generator_apply_quant(model, qtree, plan, xb))
    del batches
    # stage 1 ran int8 products and no convolution
    before = int8.matmul.launches
    ops, prof = _int8_ops(lambda: unet_apply_q8(qtree, x.permute(0, 2, 3, 1)))
    calls = int8.matmul.launches - before
    convs = {k: v for k, v in ops.items() if "conv" in k.lower()}
    mm_kernels = _int_mm_kernels(prof)
    print(f"int8 stage 1 under torch.profiler: aten::_int_mm x{ops.get('aten::_int_mm', 0)} "
          f"({calls} executor calls, {len([k for k in qtree if k != 'edges'])} conv paths), "
          f"convolution ops {convs or 'none'}; int8 GEMM kernels {mm_kernels}", flush=True)
    if ops.get("aten::_int_mm", 0) != calls or calls < len(qtree) - 1 or convs or not mm_kernels:
        raise AssertionError("stage 1 did not run on int8 products alone")
    del model, x
    torch.cuda.empty_cache()
    return dict(unet_mean=mean, unet_max=worst, poh_mean=pm, poh_max=pmax, int_mm_kernels=mm_kernels)


def _int_mm_kernels(prof):
    """Names of the device kernels that ``aten::_int_mm`` launched."""
    names = set()
    for e in prof.events():
        if e.name == "aten::_int_mm":
            for k in e.kernels:
                names.add(k.name)
    if names:
        return sorted(names)
    # event trees without kernel links: the kernels whose names say int8
    return sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"
                   and any(s in e.name.lower() for s in ("i8", "s8", "int8", "imma"))})


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    body = conn.getresponse().read()
    conn.close()
    return body


# ---------------------------------------------------------------------------
# 4. rates
# ---------------------------------------------------------------------------


def int8_pipeline(card, bf16_poh_per_s):
    """bench.py's int8 series in the port: median and spread of 5 trials of
    10 batch-16 pipelines, its split, its peak memory."""
    from .config import GeneratorConfig
    from .models import generator_apply_quant, make_generator, make_generator_plan
    from .nn.quant import quantize_unet_q8, unet_apply_q8
    from .ops import asm

    cfg = GeneratorConfig(rows=ROWS, cols=COLS, pad_size=PAD, filter_radius_coefficient=0.45,
                          dtype="bfloat16")
    model = make_generator(cfg, seed=0, device="cuda")
    gen_plan = make_generator_plan(cfg, device="cuda")
    recon_plan = asm.make_plan(cfg.optics(), distances=BENCH_DISTANCES, device="cuda")
    rgbd = torch.from_numpy(np.random.default_rng(0).random((BENCH_BATCH, 4, ROWS, COLS)).astype(np.float32)).cuda()
    qtree = quantize_unet_q8(model.part1.unet, rgbd[:8].permute(0, 2, 3, 1))

    def pipeline():
        with torch.inference_mode():
            p = generator_apply_quant(model, qtree, gen_plan, rgbd)
            return p, asm.propagate_batch_multi(recon_plan, torch.ones_like(p), p)

    def fetch(out):  # a device-to-host round trip ends the trial, as in bench.py
        return float(out[1][:, :, ::64, ::64].sum())

    for _ in range(WARMUP):
        fetch(pipeline())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rates = []
    for _ in range(TRIALS):
        start = time.perf_counter()
        for _ in range(REPS):
            out = pipeline()
        total = fetch(out)
        rates.append(REPS * BENCH_BATCH / (time.perf_counter() - start))
    peak = torch.cuda.max_memory_allocated() / 2**30
    peak_own = peak - base / 2**30
    if not np.isfinite(total):
        raise AssertionError("non-finite int8 focal stack")
    rates.sort()
    median, spread = rates[len(rates) // 2], rates[-1] - rates[0]
    print(f"bench.py's configuration, int8 full-integer stage 1 (batch {BENCH_BATCH}, 384^2, pad 320, "
          f"3 planes): median {median:.2f} POH/s of {TRIALS} trials of {REPS}, spread {spread:.2f} "
          f"(min {rates[0]:.2f}, max {rates[-1]:.2f}); bfloat16 module path (phase 7) "
          f"{bf16_poh_per_s:.2f} POH/s; peak memory {peak:.2f} GiB ({peak_own:.2f} above the model, plans and "
          f"inputs) [{card}]", flush=True)
    split = int8_split(card, qtree, rgbd.permute(0, 2, 3, 1))
    del model, rgbd, out
    torch.cuda.empty_cache()
    return dict(poh_per_s=median, spread=spread, trials=rates, peak_gib=peak, split=split,
                bf16_poh_per_s=bf16_poh_per_s)


@contextlib.contextmanager
def _recording_executor(calls):
    """Record each conv / up-conv product of ``nn/quant.py`` in order: its
    kind, its int8 inputs, and CUDA events around it and around each
    ``matmul`` inside it, (kind, a, w, (start, end), [(start, end), ...])."""
    from .ops import int8

    conv2d, matmul = int8.conv2d, int8.matmul
    inner = []

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def conv_rec(x, w):
        ev, mms = events(), []
        inner.append(mms)
        ev[0].record()
        try:
            return conv2d(x, w)
        finally:
            ev[1].record()
            inner.pop()
            calls.append(("conv", x, w, ev, mms))

    def matmul_rec(a, b):
        ev = events()
        ev[0].record()
        out = matmul(a, b)
        ev[1].record()
        if inner:
            inner[-1].append(ev)
        else:
            calls.append(("gemm", a, b, ev, [ev]))
        return out

    matmul_rec.launches = matmul.launches
    int8.conv2d, int8.matmul = conv_rec, matmul_rec
    try:
        yield
    finally:
        matmul.launches = matmul_rec.launches
        int8.conv2d, int8.matmul = conv2d, matmul


def _epilogue_ms(calls):
    """The dequantize / ReLU / requantize chains of one ``unet_apply_q8``
    forward, each replayed alone (CUDA events) on the shapes ``calls``
    recorded, as ``nn/quant.py`` runs them: a block's three convs (c0,
    c1, shortcut) give ``requant(relu(c0))`` and ``requant(relu(c1 +
    sc))``, an up-conv ``requant(y)``, the head (the last conv)
    ``sigmoid(y)``; sums of the right shapes, any scales."""
    from .utils.cuda_measure import cuda_ms

    def acc(call):
        kind, a, w = call[:3]
        shape = (*a.shape[:3], w.shape[-1]) if kind == "conv" else (a.shape[0], w.shape[1])
        return (torch.randint(-2**20, 2**20, shape, dtype=torch.int32, device="cuda"),
                torch.rand(shape[-1], device="cuda"), torch.rand(shape[-1], device="cuda"))

    def requant(v):
        return torch.clamp(torch.round(v * 20.0), -127, 127).to(torch.int8)

    total, i = 0.0, 0
    while i < len(calls):
        if calls[i][0] == "gemm":
            (y, ws, b), step = acc(calls[i]), 1
            fns = [lambda: requant(y.float() * ws + b)]
        elif i == len(calls) - 1:
            (y, ws, b), step = acc(calls[i]), 1
            fns = [lambda: torch.sigmoid(y.float() * ws + b)]
        else:
            (y0, w0, b0), (y1, w1, b1), (y2, w2, b2) = (acc(c) for c in calls[i:i + 3])
            step = 3
            fns = [lambda: requant(F.relu(y0.float() * w0 + b0)),
                   lambda: requant(F.relu((y1.float() * w1 + b1) + (y2.float() * w2 + b2)))]
        total += sum(cuda_ms(fn, iters=3, warmup=1) for fn in fns)
        i += step
    return total


def int8_split(card, qtree, x):
    """Stage 1's time by CUDA events, in one forward: CUDA events around
    each conv's im2col + products and around each product (``matmul``:
    ``torch._int_mm`` with its operand padding) give the im2col (the
    first less the second) and the products; the dequantize / ReLU /
    requantize chains are replayed alone on the forward's shapes
    (:func:`_epilogue_ms`); the rest (pools, concatenations, the up-conv
    shuffles, the input requant) is what remains of the forward."""
    from .nn.quant import unet_apply_q8
    from .utils.cuda_measure import cuda_ms

    def ms(ev):
        return ev[0].elapsed_time(ev[1])

    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        unet_apply_q8(qtree, x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30  # the forward's own
        bare = cuda_ms(lambda: unet_apply_q8(qtree, x), iters=3, warmup=1)
        for _ in range(2):  # the second forward is the one kept
            calls = []
            whole = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with _recording_executor(calls):
                whole[0].record()
                unet_apply_q8(qtree, x)
                whole[1].record()
            torch.cuda.synchronize()
        total = ms(whole)
        products = sum(ms(ev) for c in calls for ev in c[4])
        im2col = sum(ms(c[3]) - sum(ms(ev) for ev in c[4]) for c in calls if c[0] == "conv")
        epilogue = _epilogue_ms(calls)
        del calls
    split = dict(total=total, bare=bare, im2col=im2col, int_mm=products, dequant_requant=epilogue,
                 rest=total - im2col - products - epilogue, peak_gib=peak)
    print("int8 stage 1 (batch {b}), CUDA events: forward {bare:.1f} ms ({total:.1f} with the split's "
          "events) = im2col {im2col:.1f} + _int_mm {int_mm:.1f} + dequantize/requantize {dequant_requant:.1f} "
          "(replayed alone) + the rest {rest:.1f}; peak memory of the forward above what was allocated "
          "before it {peak_gib:.2f} GiB".format(
              b=x.shape[0], **split) + f" [{card}]", flush=True)
    return split


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bench_serve_summary(card, tmp):
    from .tools import bench_serve

    out = os.path.join(tmp, "serving", "summary.json")
    start = time.perf_counter()
    summary = bench_serve.main(["--model_path", os.path.join(tmp, "absent.msgpack"),
                                "--calib_data", os.path.join(tmp, "absent_data"), "--batch", "16",
                                "--reqs", "3", "--port", str(_free_port()), "--startup_timeout", "300",
                                "--out", out])
    for label in ("bf16", "int8"):
        r = summary[label]
        if not (r["wire_poh_per_s"] > 0 and r["mean_batch_ms"] > 0):
            raise AssertionError(f"bench_serve {label}: {r}")
        print(f"bench_serve {label}: wire {r['wire_poh_per_s']} POH/s (u8 {r['wire_poh_per_s_u8']}), "
              f"mean batch {r['mean_batch_ms']} ms, device {r['device_poh_per_s']} POH/s [{card}]", flush=True)
    print(f"bench_serve: {time.perf_counter() - start:.1f} s", flush=True)
    return summary


def run(card, bf16_poh_per_s):
    """Every part above; returns their numbers, with the K1 and K3
    launches of the float32 server's traffic."""
    with tempfile.TemporaryDirectory(prefix="serve_smoke_") as tmp:
        out = dict(executor=int8_executor(card))
        out["float32"] = float_server(card, tmp, "float32")
        out["bfloat16"] = float_server(card, tmp, "bfloat16")
        out["int8"] = int8_server(card, tmp)
        out["pipeline"] = int8_pipeline(card, bf16_poh_per_s)
        out["bench_serve"] = bench_serve_summary(card, tmp)
    torch.cuda.empty_cache()
    return out
