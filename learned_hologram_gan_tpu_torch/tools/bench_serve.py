#!/usr/bin/env python
"""Served POH throughput through the port's ``tools/serve_poh.py``, bfloat16
against int8 (the port's counterpart of ``tools/bench_serve.py``).

For each mode it starts the server as a process (``--dtype bfloat16``, one
bucket of ``--batch``, ``--quantize`` ``none`` or ``int8`` calibrated from 8
RGBD samples), drives ``--reqs`` sequential batch requests over HTTP from
localhost after one warm-up request, and records:

* wire POH/s: what the client sees end to end, f32 replies, then u8 ones
  (a quarter of the egress) on the same server;
* ``mean_batch_ms``: the wall time of one fused batch inside the server,
  host<->device copies included, over the timed f32 requests alone: the
  change of ``/healthz``'s ``batch_ms_total`` over the change of its
  ``batches``, read after the warm-up request and after the last one (the
  warm-up batch, which may carry first-call set-up, left out), and the
  device POH/s it implies.

The RGBD batch is the dataset's train samples under ``--calib_data`` where
its ``.bin`` files exist, else seeded random RGBD.  Writes one
summary JSON and prints it::

    python -m learned_hologram_gan_tpu_torch.tools.bench_serve \\
        --model_path output/quality_run/generator.msgpack --calib_data data/synth384 \\
        --out output/serving/summary.json
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the RGBD where --calib_data holds no dataset
RANDOM_RGBD_SEED = 0


def start_server(args, port, quantize, calib_path, qtree_path, log_path):
    cmd = [
        sys.executable, "-m", "learned_hologram_gan_tpu_torch.tools.serve_poh",
        "--model_path", args.model_path,
        "--rows", str(args.rows), "--cols", str(args.cols),
        "--pad_size", str(args.pad_size),
        "--unet_base_features", str(args.unet_base_features),
        "--dtype", "bfloat16",
        "--port", str(port),
        "--buckets", str(args.batch),
        "--batch_timeout_ms", "1",
    ]
    if args.cpu:
        cmd.append("--cpu")
    if quantize == "int8":
        cmd += ["--quantize", "int8", "--calib_path", calib_path, "--qtree_path", qtree_path]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    # wait for the serving line (warm-up included)
    deadline = time.time() + args.startup_timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server ({quantize}) exited; see {log_path}")
        with open(log_path) as f:
            if "serving POH" in f.read():
                return proc
        time.sleep(0.5)
    proc.terminate()
    proc.wait(timeout=60)
    raise RuntimeError(f"server ({quantize}) failed to start; see {log_path}")


def _post(port, body, batch, wire_quant=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"X-Batch": str(batch), "Content-Length": str(len(body))}
    if wire_quant:
        headers["X-Quantize"] = wire_quant
    conn.request("POST", "/poh", body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(data.decode())
    return data


def _healthz(port) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    conn.close()
    return health


def drive(port, rgbd, reqs, wire_quant=None):
    """One warm-up request, then ``reqs`` sequential batch requests;
    returns (wire POH/s, the /healthz dict after them, the mean batch ms
    of the timed requests' batches alone)."""
    body = np.ascontiguousarray(rgbd, np.float32).tobytes()
    _post(port, body, rgbd.shape[0], wire_quant)
    before = _healthz(port)
    t0 = time.perf_counter()
    for _ in range(reqs):
        _post(port, body, rgbd.shape[0], wire_quant)
    dt = time.perf_counter() - t0
    after = _healthz(port)
    batches = after["batches"] - before["batches"]
    if batches < 1:
        raise RuntimeError(f"the server counted {batches} batches over {reqs} requests")
    mean_ms = (after["batch_ms_total"] - before["batch_ms_total"]) / batches
    return reqs * rgbd.shape[0] / dt, after, mean_ms


def _samples(args, n):
    """``n`` RGBD samples: the dataset's train split where it exists, else
    seeded random RGBD."""
    from ..data import ImgDepthAmpPhsDataset

    split = os.path.join(args.calib_data, "train")
    names = ("img", "depth", "amp", "phs")
    if all(os.path.exists(os.path.join(split, f"{k}.bin")) for k in names):
        ds = ImgDepthAmpPhsDataset(
            *(os.path.join(split, f"{k}.bin") for k in names),
            samples_num=8, height=args.rows, width=args.cols,
        )
        return np.stack([ds.get(i % 8)[0] for i in range(n)]).astype(np.float32)
    print(f"{split} holds no dataset; seeded random RGBD (seed {RANDOM_RGBD_SEED})", flush=True)
    return np.random.default_rng(RANDOM_RGBD_SEED).random((n, 4, args.rows, args.cols)).astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default="output/quality_run/generator.msgpack")
    ap.add_argument("--calib_data", default="data/synth384",
                    help="dataset dir; 8 train RGBD samples calibrate int8 (seeded random "
                         "RGBD where its .bin files are absent)")
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--pad_size", type=int, default=320)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reqs", type=int, default=8)
    ap.add_argument("--port", type=int, default=8811)
    ap.add_argument("--startup_timeout", type=float, default=1800)
    ap.add_argument("--out", default="output/serving/summary.json")
    ap.add_argument("--modes", nargs="*", default=["none", "int8"])
    ap.add_argument("--unet_base_features", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="serve from the CPU (use tiny --rows/--cols/--pad_size)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    work = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(work, exist_ok=True)

    calib_path = os.path.join(work, "calib.npy")
    np.save(calib_path, _samples(args, 8))
    qtree_path = os.path.join(work, "qtree_int8.npz")
    rgbd = _samples(args, args.batch)

    summary = {"batch": args.batch, "reqs": args.reqs, "rows": args.rows, "cols": args.cols}
    for mode in args.modes:
        label = "bf16" if mode == "none" else mode
        log_path = os.path.join(work, f"server_{label}.log")
        proc = start_server(args, args.port, mode, calib_path, qtree_path, log_path)
        try:
            wire_rate, health, mean_ms = drive(args.port, rgbd, args.reqs)  # f32-wire drive
            mean_ms = round(mean_ms, 3)
            # u8 phase replies on the same server: a quarter of the egress
            wire_rate_u8, _, _ = drive(args.port, rgbd, args.reqs, wire_quant="u8")
            summary[label] = {
                "wire_poh_per_s": round(wire_rate, 2),
                "wire_poh_per_s_u8": round(wire_rate_u8, 2),
                "mean_batch_ms": mean_ms,
                "device_poh_per_s": round(1e3 * args.batch / mean_ms, 1),
                "quantize": health["quantize"],
            }
            print(json.dumps({label: summary[label]}), flush=True)
        finally:
            proc.terminate()
            proc.wait(timeout=60)

    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
