#!/usr/bin/env python
"""POH inference server: micro-batched RGBD -> phase-only hologram serving
(the port's counterpart of ``tools/serve_poh.py``; the same flags, API and
wire format, so one client talks to either server).

* **Shape buckets**: requests run at a batch of (1, 2, 4, 8) by default,
  each bucket warmed up at start-up (cuDNN's algorithm choices settle and
  the kernels load before traffic arrives).
* **Micro-batching**: concurrent requests are queued and fused into one
  device call (up to the largest bucket, waiting at most
  ``--batch_timeout_ms``); a short batch is padded up to its bucket (the
  last sample repeated) and sliced on the way out; a longer one runs in
  chunks of the largest bucket.  A failure reaches every waiter of the
  batch.
* **Zero dependencies**: stdlib ``http.server`` (threaded); tensors travel
  as raw little-endian float32 bytes with shape headers.

API:
  POST /poh     body = raw f32 bytes of shape (B, 4, rows, cols);
                headers: X-Batch: B, optional X-Quantize: f32|u16|u8.
                Response: the POH (B, 3, rows, cols) as f32, or its phase
                mod 2*pi quantized to 16 or 8 bits (k / 2^bits * X-Scale);
                X-Shape header.
  POST /focal_stack  body = raw f32 POH bytes (B, 3, rows, cols);
                headers: X-Batch: B, X-Distances: comma-separated depths in
                meters (applied to the image-plane spectrum, reference
                watermelon.py:216-234).  Response: f32 amplitudes (B, D, 3,
                rows, cols), X-Shape header.  The depth count is padded to
                a bucket of (1, 3, 8, 21) by repeating the last depth.
  GET  /healthz JSON: uptime, request/batch counters, mean batch ms,
                buckets, the model's quantization and dtype.

On a CUDA tensor the path runs K1 (stage 2's backward ASM, ``conj_h``, once
a /poh batch; ``freq2amp_at``'s ``from_spectrum`` once a /focal_stack
request) and K3 (``propagate_poh2freq_forward``'s ``fft2``: two launches a
/focal_stack request).  ``--quantize int8`` runs the full-integer int8
stage 1 (``nn/quant.py``), its tree read from ``--qtree_path`` or
calibrated from ``--calib_path`` and written to ``--qtree_path``.

Run:  python -m learned_hologram_gan_tpu_torch.tools.serve_poh --model_path G.msgpack
It serves from the CUDA device and raises without one, unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

#: focal-stack depth-count buckets
STACK_BUCKETS = (1, 3, 8, 21)


class PohService:
    """The bucketed, micro-batching generator service."""

    def __init__(self, model_path, rows, cols, pad_size,
                 filter_radius_coefficient=0.45, unet_base_features=64,
                 dtype="float32", buckets=(1, 2, 4, 8), batch_timeout_ms=5.0,
                 cpu=False, quantize="none", qtree_path=None, calib_path=None,
                 calib_num=8):
        from ..config import GeneratorConfig
        from ..models import generator_apply_quant, make_generator, make_generator_plan
        from ..ops import asm
        from ..train import checkpoint as ckpt_lib

        self.device = torch.device("cpu" if cpu else "cuda")
        if not cpu and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --cpu to serve from the CPU")
        self.rows, self.cols = rows, cols
        self.dtype = dtype
        self.buckets = tuple(sorted(buckets))
        self.max_batch = self.buckets[-1]
        self.batch_timeout = batch_timeout_ms / 1e3
        self.stack_buckets = STACK_BUCKETS

        cfg = GeneratorConfig(
            rows=rows, cols=cols, pad_size=pad_size,
            filter_radius_coefficient=filter_radius_coefficient,
            unet_base_features=unet_base_features, dtype=dtype,
        )
        self.model = make_generator(cfg, seed=0, device=self.device)
        self.plan = make_generator_plan(cfg, device=self.device)
        if model_path and os.path.exists(model_path):
            ckpt_lib.load_weights(model_path, self.model)
            print(f"loaded generator weights from {model_path}")
        else:
            print(f"WARNING: model path {model_path!r} not found; random init")

        # the full-integer int8 stage 1 (nn/quant.py q8 chain); stage 2
        # (spectral, parameter-light) stays float
        self.quantize = quantize
        self.qtree = None
        if quantize == "int8":
            from ..nn.quant import load_qtree, quantize_unet_q8, quantized_bytes, save_qtree

            if qtree_path and os.path.exists(qtree_path):
                self.qtree = load_qtree(qtree_path, self.device)
                print(f"loaded int8 qtree from {qtree_path} "
                      f"({quantized_bytes(self.qtree) / 1e6:.1f} MB packed)")
            elif calib_path and os.path.exists(calib_path):
                calib = np.load(calib_path)[:calib_num]
                if calib.ndim != 4 or calib.shape[1] != 4:
                    raise SystemExit(f"--calib_path must hold an (N,4,R,C) f32 RGBD array, "
                                     f"got {calib.shape}")
                x = torch.from_numpy(np.ascontiguousarray(calib, np.float32)).to(self.device)
                self.qtree = quantize_unet_q8(self.model.part1.unet, x.permute(0, 2, 3, 1))
                print(f"calibrated int8 qtree from {calib.shape[0]} samples "
                      f"({quantized_bytes(self.qtree) / 1e6:.1f} MB packed)")
                if qtree_path:
                    save_qtree(self.qtree, qtree_path)
                    print(f"saved int8 qtree to {qtree_path}")
            else:
                raise SystemExit("--quantize int8 needs --qtree_path (a saved quantized model) "
                                 "or --calib_path (an (N,4,R,C) f32 RGBD .npy calibration batch)")
        elif quantize != "none":
            raise SystemExit(f"unknown --quantize mode {quantize!r}")

        if self.qtree is not None:
            self._infer = lambda x: generator_apply_quant(self.model, self.qtree, self.plan, x)
        else:
            self._infer = lambda x: self.model(self.plan, x)

        def stack(poh, dists):
            freq = asm.propagate_poh2freq_forward(self.plan, poh)
            return asm.freq2amp_at(self.plan, freq, dists)

        self._stack = stack

        # warm-up: every batch bucket, and every depth bucket at batch 1
        for b in self.buckets:
            self._device_call(self._infer, np.zeros((b, 4, rows, cols), np.float32))
        for d in self.stack_buckets:
            self._device_call(self._stack, np.zeros((1, 3, rows, cols), np.float32),
                              np.zeros(d, np.float32))
        print(f"warmed up buckets {self.buckets} at {rows}x{cols} "
              f"(+focal-stack D buckets {self.stack_buckets}) on {self.device}")

        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batch_ms_total": 0.0, "started": time.time()}
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _device_call(self, fn, *arrays: np.ndarray) -> np.ndarray:
        """``fn`` on ``arrays`` moved to the device; the result back on the
        host (the copy waits for the device).  A read-only array (a request
        body) is copied first."""
        with torch.inference_mode():
            out = fn(*(torch.from_numpy(np.require(a, requirements="CW")).to(self.device) for a in arrays))
            return out.cpu().numpy()

    def _count(self, t0: float, requests: int = 0) -> None:
        with self._lock:
            self.stats["batches"] += 1
            self.stats["batch_ms_total"] += (time.perf_counter() - t0) * 1e3
            self.stats["requests"] += requests

    def close(self) -> None:
        """Stop the batching worker (requests queued before it are served)."""
        self._q.put(None)
        self._worker.join()

    # -- request side ------------------------------------------------------
    def submit(self, rgbd: np.ndarray) -> np.ndarray:
        """Blocking: enqueue one request array (B,4,R,C), await its POH."""
        done = threading.Event()
        slot = {}
        self._q.put((rgbd, slot, done))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["poh"]

    # -- batching worker ---------------------------------------------------
    def _bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            items = [first]
            total = first[0].shape[0]
            deadline = time.time() + self.batch_timeout
            stop = False
            while total < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                items.append(nxt)
                total += nxt[0].shape[0]
            try:
                concat = np.concatenate([it[0] for it in items], axis=0)
                n = concat.shape[0]
                outs = [self._run(concat[lo:lo + self.max_batch]) for lo in range(0, n, self.max_batch)]
                self._deliver(items, np.concatenate(outs, axis=0))
            except Exception as e:  # deliver the failure to every waiter
                for _, slot, done in items:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    done.set()
            if stop:
                return

    def _run(self, x: np.ndarray) -> np.ndarray:
        b = x.shape[0]
        bucket = self._bucket_for(b)
        if b < bucket:
            x = np.concatenate([x, np.repeat(x[-1:], bucket - b, axis=0)], 0)
        t0 = time.perf_counter()
        out = self._device_call(self._infer, x)[:b]
        self._count(t0)
        return out

    # -- focal-stack reconstruction ---------------------------------------
    def focal_stack(self, poh: np.ndarray, distances) -> np.ndarray:
        """POH (B,3,R,C) + depths (D,) -> amplitude focal stack (B,D,3,R,C).

        Requests are not cross-fused (each carries its own depth list);
        batch and depth count are padded to their buckets."""
        b, d = poh.shape[0], len(distances)
        bb = self._bucket_for(b)
        db = next((s for s in self.stack_buckets if d <= s), self.stack_buckets[-1])
        if d > db:
            raise ValueError(f"at most {db} distances per request (got {d})")
        dv = np.asarray(list(distances) + [distances[-1]] * (db - d), np.float32)
        if b < bb:
            poh = np.concatenate([poh, np.repeat(poh[-1:], bb - b, axis=0)], 0)
        t0 = time.perf_counter()
        amp = self._device_call(self._stack, poh, dv)[:b, :d]
        self._count(t0, requests=1)
        return amp

    def _deliver(self, items, poh: np.ndarray):
        lo = 0
        for arr, slot, done in items:
            b = arr.shape[0]
            slot["poh"] = poh[lo:lo + b]
            lo += b
            with self._lock:
                self.stats["requests"] += 1
            done.set()


def quantize_phase(poh: np.ndarray, quant: str) -> bytes:
    """The /poh reply body: the f32 POH, or its phase mod 2*pi quantized to
    ``u16`` / ``u8`` levels (k / 2^bits * 2*pi reconstructs it)."""
    if quant in ("u8", "u16"):
        dt = np.uint8 if quant == "u8" else np.uint16
        levels = 256 if quant == "u8" else 65536
        wrapped = np.mod(poh, 2 * np.pi) / (2 * np.pi)
        return np.ascontiguousarray(np.minimum(np.round(wrapped * levels), levels - 1).astype(dt)).tobytes()
    if quant == "f32":
        return np.ascontiguousarray(poh, np.float32).tobytes()
    raise ValueError(f"unknown X-Quantize {quant!r}")


def make_handler(service: PohService):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, status: int, body: bytes, headers=()) -> None:
            self.send_response(status)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bad_request(self, e: Exception) -> None:
            self._reply(400, f"{type(e).__name__}: {e}".encode())

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            s = service.stats
            batches = max(s["batches"], 1)
            body = json.dumps({
                "uptime_s": round(time.time() - s["started"], 1),
                "requests": s["requests"],
                "batches": s["batches"],
                # wall time of one fused batch incl. host<->device transfer,
                # and their sum (a client's difference of two readings
                # times the batches between them)
                "mean_batch_ms": round(s["batch_ms_total"] / batches, 2),
                "batch_ms_total": round(s["batch_ms_total"], 3),
                "rows": service.rows, "cols": service.cols,
                "buckets": list(service.buckets),
                "quantize": service.quantize,
                "dtype": service.dtype,
            }).encode()
            self._reply(200, body, [("Content-Type", "application/json")])

        def _read_body(self, channels: int, what: str) -> np.ndarray:
            n = int(self.headers.get("Content-Length", "0"))
            b = int(self.headers.get("X-Batch", "1"))
            raw = self.rfile.read(n)
            expect = b * channels * service.rows * service.cols * 4
            if n != expect:
                raise ValueError(f"body is {n} bytes, expected {expect} for "
                                 f"({b},{channels},{service.rows},{service.cols}) f32{what}")
            return np.frombuffer(raw, np.float32).reshape(b, channels, service.rows, service.cols)

        def do_POST(self):
            if self.path == "/focal_stack":
                self._do_focal_stack()
                return
            if self.path != "/poh":
                self.send_error(404)
                return
            try:
                rgbd = self._read_body(4, "")
                poh = service.submit(rgbd)
                # wire format: f32 (default) or phase-quantized u16/u8
                quant = (self.headers.get("X-Quantize") or "f32").lower()
                body = quantize_phase(poh, quant)
                headers = [("Content-Type", "application/octet-stream"),
                           ("X-Shape", ",".join(map(str, poh.shape))), ("X-Quantize", quant)]
                if quant != "f32":
                    headers.append(("X-Scale", "6.283185307179586"))
                self._reply(200, body, headers)
            except Exception as e:
                self._bad_request(e)

        def _do_focal_stack(self):
            try:
                dists_hdr = self.headers.get("X-Distances", "")
                if not dists_hdr:
                    raise ValueError("X-Distances header required: comma-separated "
                                     "depths in meters, e.g. '-0.005,0,0.005'")
                dists = [float(t) for t in dists_hdr.split(",") if t.strip()]
                poh = self._read_body(3, " POH")
                amp = service.focal_stack(poh, dists)
                self._reply(200, np.ascontiguousarray(amp, np.float32).tobytes(),
                            [("Content-Type", "application/octet-stream"),
                             ("X-Shape", ",".join(map(str, amp.shape)))])
            except Exception as e:
                self._bad_request(e)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", type=str, default="")
    ap.add_argument("--rows", type=int, default=384)
    ap.add_argument("--cols", type=int, default=384)
    ap.add_argument("--pad_size", type=int, default=320)
    ap.add_argument("--filter_radius_coefficient", type=float, default=0.45)
    ap.add_argument("--unet_base_features", type=int, default=64)
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--port", type=int, default=8470)
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--batch_timeout_ms", type=float, default=5.0)
    ap.add_argument("--cpu", action="store_true", help="serve from the CPU")
    ap.add_argument("--quantize", choices=("none", "int8"), default="none",
                    help="int8: serve the full-integer stage-1 UNet (nn/quant.py q8 chain)")
    ap.add_argument("--qtree_path", type=str, default="",
                    help="saved quantized model (.npz from nn.quant.save_qtree, either "
                         "package's); also written here after --calib_path calibration")
    ap.add_argument("--calib_path", type=str, default="",
                    help="(N,4,R,C) f32 RGBD .npy batch for startup activation-scale calibration")
    ap.add_argument("--calib_num", type=int, default=8)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    service = PohService(
        args.model_path, args.rows, args.cols, args.pad_size,
        args.filter_radius_coefficient, args.unet_base_features,
        args.dtype, tuple(args.buckets), args.batch_timeout_ms, args.cpu,
        quantize=args.quantize, qtree_path=args.qtree_path,
        calib_path=args.calib_path, calib_num=args.calib_num,
    )
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(service))
    print(f"serving POH on http://127.0.0.1:{srv.server_address[1]} "
          f"(POST /poh, POST /focal_stack, GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        service.close()


if __name__ == "__main__":
    main()
