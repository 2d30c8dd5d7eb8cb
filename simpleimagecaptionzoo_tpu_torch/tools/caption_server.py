"""Standing caption server: dynamic batching over one decode function (the
JAX package's ``tools/caption_server.py``).

    python -m simpleimagecaptionzoo_tpu_torch.tools.caption_server \
        --dataset COCO14 --model_type BUTDSpatial [--beam 3] [--port 8000] \
        [--max_batch 64] [--max_wait_ms 20] [--gpu_id 0]

A small HTTP daemon that takes raw image uploads, coalesces concurrent
requests into batches of one shape, decodes them on the card (batched beam
search through the port's kernels) and answers each request with its
caption.

Design (one decode worker, many HTTP threads):

* HTTP threads (``ThreadingHTTPServer``) decode and resize the upload on
  the host (the native JPEG decoder when built, else PIL: the contract of
  ``data.datasets.load_image_uint8``) and enqueue ``(pixels, Future)``;
* the batcher thread takes the first waiting request, then drains the
  queue up to ``--max_batch`` or ``--max_wait_ms`` (whichever first), pads
  the tail by repeating the last image, runs the decode and resolves every
  request's future.  Padding to ``--max_batch`` keeps the TMA maps,
  cuBLAS's and cuDNN's choice of algorithm the same from batch to batch,
  so a row's ids do not depend on its batch-mates;
* the decode runs on the batcher's thread alone: it binds the card
  (``torch.cuda.set_device``: the kernels launch on the thread's current
  device) and runs the warm-up decode itself before the server accepts
  traffic, since the kernels' TMA map caches are per host thread and the
  first use builds the kernels.

Endpoints:
    POST /caption   body = image bytes (jpeg/png/...) -> {"caption": ...}
    GET  /healthz   liveness + model identity
    GET  /stats     request/batch counters (mean fill, p50/p99 latency)

A decode that raises answers 500 to its batch's requests; a request that
waits longer than ``--request_timeout`` for a decode slot gets 503, and its
row is skipped.
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from simpleimagecaptionzoo_tpu_torch.data import _native_image
from simpleimagecaptionzoo_tpu_torch.engine.engine import to_device


def decode_upload(data: bytes, size: int) -> np.ndarray:
    """Uploaded image bytes -> (size, size, 3) uint8, the convert and
    bilinear-resize contract of ``datasets.load_image_uint8``: the native
    C++ decoder (GIL released, so concurrent handler threads scale across
    cores) when built and the bytes are a JPEG it can take, PIL
    otherwise."""
    native = _native_image.decode_jpeg_resize_bytes(data, size)
    if native is not None:
        return native
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def _resolve(fut: Future, action) -> None:
    """Apply set_result/set_exception, tolerating a client that cancelled
    (request timeout) or a future already resolved: racing the client's
    cancel is inherent, so InvalidStateError here is benign."""
    try:
        if not fut.cancelled() and not fut.done():
            action(fut)
    except InvalidStateError:
        pass


class Batcher:
    """Coalesces requests into decode batches of one shape.  ``device``
    (no default: the CPU only where the caller names it): where the decode
    runs (its thread binds a card; the pixels go there pinned and without
    blocking, ``engine/engine.to_device``); ``warm``: a
    full batch of pixels decoded on the batcher's thread by :meth:`start`
    before it returns (the build and first-use costs), left out of the
    stats."""

    def __init__(self, decode_fn, tree, vocab, batch: int, img_size: int,
                 max_wait_ms: float, *, device,
                 warm: np.ndarray | None = None) -> None:
        self._decode = decode_fn
        self._tree = tree
        self._vocab = vocab
        self._batch = batch
        self._img_size = img_size
        self._max_wait = max_wait_ms / 1e3
        self._device = torch.device(device)
        self._warm = warm
        self.warm_s = None
        self._ready = threading.Event()
        self._failed: BaseException | None = None
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "rows_decoded": 0}
        self._lat_ms: list = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="caption-batcher")

    def start(self) -> "Batcher":
        """Starts the worker and returns once it has bound its device and
        run the warm decode (raising what the warm decode raised)."""
        self._thread.start()
        self._ready.wait()
        if self._failed is not None:
            self._thread.join(timeout=30)
            raise self._failed
        return self

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)                      # wake the worker
        self._thread.join(timeout=30)
        # fail anything still queued (submitted behind the wake sentinel or
        # while the worker was exiting) fast, instead of leaving its client
        # blocked until the request timeout
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _resolve(item[1], lambda f: f.set_exception(
                    RuntimeError("server shutting down")))

    def submit(self, pixels: np.ndarray) -> Future:
        fut: Future = Future()
        if self._stop.is_set():
            fut.set_exception(RuntimeError("server shutting down"))
            return fut
        self._q.put((pixels, fut, time.perf_counter()))
        return fut

    # -- worker ------------------------------------------------------------
    def _collect(self):
        """Block for the first request, then drain up to batch/max_wait."""
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.perf_counter() + self._max_wait
        while len(items) < self._batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _ids(self, imgs: np.ndarray) -> np.ndarray:
        return self._decode(self._tree["params"], self._tree["model_state"],
                            {"img_tensors": to_device(imgs, self._device)}
                            ).cpu().numpy()

    def _setup(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        if self._warm is not None:
            t0 = time.perf_counter()
            self._ids(self._warm)
            self.warm_s = time.perf_counter() - t0

    def _run(self) -> None:
        try:
            self._setup()
        except BaseException as e:             # start() raises it
            self._failed = e
            self._ready.set()
            return
        self._ready.set()
        while not self._stop.is_set():
            items = self._collect()
            # a client that timed out cancelled its future: don't spend a
            # batch row decoding work nobody is waiting for
            items = [it for it in items if not it[1].cancelled()]
            if not items:
                continue
            real = len(items)
            imgs = np.stack([it[0] for it in items]
                            + [items[-1][0]] * (self._batch - real))
            try:
                ids = self._ids(imgs)
                now = time.perf_counter()
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["requests"] += real
                    self.stats["rows_decoded"] += self._batch
                    self._lat_ms.extend(
                        (now - it[2]) * 1e3 for it in items)
                    del self._lat_ms[:-4096]   # bounded window
                for it, row in zip(items, ids[:real]):
                    cap = " ".join(self._vocab.decode_ids(row))
                    _resolve(it[1], lambda f, c=cap: f.set_result(c))
            except Exception as e:               # resolve, don't wedge clients
                for it in items:
                    _resolve(it[1], lambda f: f.set_exception(e))

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._lat_ms, np.float64)
            out = dict(self.stats)
        if out["batches"]:
            out["mean_batch_fill"] = round(
                out["requests"] / out["batches"], 2)
        if lat.size:
            out["latency_ms_p50"] = round(float(np.percentile(lat, 50)), 1)
            out["latency_ms_p99"] = round(float(np.percentile(lat, 99)), 1)
        return out


def make_handler(batcher: Batcher, img_size: int, identity: dict,
                 max_body: int, request_timeout: float):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _drain(self, n: int) -> None:
            """Consume (and discard) n body bytes before an error reply.
            Replying while the client is still writing makes the kernel
            reset the socket, and the client sees a connection reset
            instead of the error JSON.  Bounded: past 256 MiB the
            connection is dropped."""
            left = min(n, 256 << 20)
            while left > 0:
                chunk = self.rfile.read(min(left, 1 << 20))
                if not chunk:
                    break
                left -= len(chunk)

        def log_message(self, fmt, *a):        # quiet: stats has the counts
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, dict(identity, ok=True))
            elif self.path == "/stats":
                self._reply(200, batcher.snapshot())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/caption":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = 0
            if n <= 0 or n > max_body:
                self._drain(max(n, 0))
                self._reply(413 if n > max_body else 400,
                            {"error": f"body must be 1..{max_body} bytes"})
                return
            data = self.rfile.read(n)
            try:
                pixels = decode_upload(data, img_size)
            except Exception as e:
                self._reply(400, {"error": f"undecodable image: {e}"})
                return
            fut = batcher.submit(pixels)
            try:
                caption = fut.result(timeout=request_timeout)
            except FutureTimeout:
                # overload, not failure: free the batch row (the batcher
                # skips cancelled futures) and tell the client to back off
                fut.cancel()
                self._reply(503, {"error": "server overloaded: no decode "
                                  f"slot within {request_timeout:.0f}s"})
                return
            except Exception as e:
                self._reply(500, {"error": f"decode failed: {e}"})
                return
            self._reply(200, {"caption": caption})

    return Handler


class CaptionHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog that holds a burst of
    clients (socketserver's default is 5: a burst of a few hundred
    connects would have most of them retry their SYN a second later)."""

    request_queue_size = 1024
    daemon_threads = True


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="COCO14")
    ap.add_argument("--model_type", default="BUTDSpatial")
    ap.add_argument("--dataset_config_root", default="./Configs/Datasets/")
    ap.add_argument("--model_config_root", default="./Configs/Models/")
    ap.add_argument("--checkpoint_root", default="./CheckPoints")
    ap.add_argument("--use_scst_model", action="store_true")
    ap.add_argument("--beam", type=int, default=3, help="-1 for greedy")
    ap.add_argument("--max_batch", type=int, default=64,
                    help="the decode batch (the tail padded to it)")
    ap.add_argument("--max_wait_ms", type=float, default=20.0,
                    help="batching window after the first request arrives")
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_body_mb", type=int, default=32)
    ap.add_argument("--request_timeout", type=float, default=120.0,
                    help="seconds a request waits for a decode slot before "
                         "the server answers 503 (overload backpressure)")
    ap.add_argument("--gpu_id", type=str, default="0",
                    help="the CUDA card's index (cuda:<gpu_id>), or 'cpu'")
    return ap


def build_server(args):
    """Load the checkpoint, build the kernels and warm the decode on the
    batcher's thread, and return the ready-to-serve
    ``(ThreadingHTTPServer, Batcher)`` pair (the whole of ``main`` but
    ``serve_forever``; tests drive this directly)."""
    from simpleimagecaptionzoo_tpu_torch.inference import \
        load_inference_bundle
    from simpleimagecaptionzoo_tpu_torch.main import device_of
    bundle = load_inference_bundle(
        dataset=args.dataset, model_type=args.model_type,
        dataset_config_root=args.dataset_config_root,
        model_config_root=args.model_config_root,
        checkpoint_root=args.checkpoint_root,
        use_scst_model=args.use_scst_model, beam=args.beam,
        dtype=args.dtype, device=device_of(args.gpu_id))

    # build and warm BEFORE accepting traffic: the first request must not
    # pay the kernels' build and first use
    warm = np.zeros((args.max_batch, args.img_size, args.img_size, 3),
                    np.uint8)
    batcher = Batcher(bundle.decode, bundle.tree, bundle.vocab,
                      args.max_batch, args.img_size, args.max_wait_ms,
                      device=bundle.device, warm=warm).start()
    print(f"decode built+warm in {batcher.warm_s:.1f}s "
          f"(batch {args.max_batch}, beam {args.beam}, {args.dtype}, "
          f"{bundle.device})")
    identity = {"model_type": args.model_type, "dataset": args.dataset,
                "beam": args.beam, "dtype": args.dtype,
                "max_batch": args.max_batch}
    httpd = CaptionHTTPServer(
        (args.host, args.port),
        make_handler(batcher, args.img_size, identity,
                     args.max_body_mb << 20, args.request_timeout))
    return httpd, batcher


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    httpd, batcher = build_server(args)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          "(POST /caption, GET /healthz, GET /stats)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        batcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
