"""HTTP tagging server with dynamic micro-batching (the port's counterpart
of ``vae_tagger_tpu/serve/server.py``).

The tagger as a long-lived process around :class:`TaggerEngine`: requests
are queued and coalesced into device batches (up to ``max_batch`` images or
``batch_timeout_ms``, whichever comes first), so concurrent clients share
the card at batch throughput instead of paying one launch sequence each.

- binds 127.0.0.1 by default: there is no auth, and ``host="0.0.0.0"`` is
  an explicit opt-in;
- a body larger than ``max_body_bytes`` gets 413 before it is read, then is
  drained in bounded chunks so the error reaches the client;
- the queue is bounded: with ``max_queue`` requests waiting, a new one gets
  503 + Retry-After (backpressure);
- a request that times out withdraws itself from the queue; ``stop()``
  fails every queued request at once.

Threads and the card: the handler threads decode only (the native decode
releases the GIL); one worker thread makes every launch.  It keeps one
batch in flight: it dispatches batch N+1 (``classify_async``, which does
not synchronize) before it fetches batch N, so the host's decode, stack
and dispatch overlap the card's compute.  The fetch (``.cpu()`` in
:meth:`BatchingWorker._resolve`) is the only synchronization.  The host to
device copy of a batch queues on the current stream behind the batch
before it: 25 MB of uint8 at 1024px and batch 8, about 1 ms over PCIe.

Pure stdlib (http.server + threads).

Endpoints:
  POST /classify[?resolution=N]
                   body = raw image bytes -> one image's JSON in the
                   ``classification_results.json`` entry schema
                   (infer/classify.py::_format_results); ``resolution``
                   must be one of the served resolutions
  GET  /healthz    liveness + model info
  GET  /tags       the tag vocabulary
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from collections import Counter, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.bucketing import decode_bytes_square, decode_bytes_square_yuv
from ..infer.classify import _format_results


class QueueFullError(Exception):
    """Raised by submit() when the bounded request queue is full."""


class _Pending:
    __slots__ = ("pixels", "event", "probs", "error", "ts", "t_dispatch",
                 "t_done")

    def __init__(self, pixels):
        self.pixels = pixels
        self.event = threading.Event()
        self.probs = None
        self.error: Optional[Exception] = None
        self.ts = time.monotonic()  # enqueue time: cross-shape FIFO order
        # stamped by the worker, so a response can split its latency into
        # queue wait and device pipeline time
        self.t_dispatch: Optional[float] = None
        self.t_done: Optional[float] = None


def _to_host(probs) -> np.ndarray:
    """A dispatched batch's probabilities on the host: ``.cpu()`` of a
    device tensor waits for the batch; anything else goes through numpy."""
    if isinstance(probs, torch.Tensor):
        return probs.cpu().numpy()
    return np.asarray(probs)


class BatchingWorker:
    """Coalesces concurrent classify requests into one device batch.

    Requests are grouped by pixel shape (a batch holds one shape); a
    bounded total queue applies backpressure across all shapes.  A batch
    of every size up to ``max_batch`` can occur."""

    def __init__(self, engine, max_batch: int = 8,
                 batch_timeout_ms: float = 10.0,
                 request_timeout_s: float = 600.0,
                 max_queue: int = 64,
                 transfer_format: str = "rgb"):
        self.engine = engine
        self.transfer_format = transfer_format
        self.max_batch = max(1, max_batch)
        self.timeout_s = max(0.0, batch_timeout_ms) / 1000.0
        self.request_timeout_s = request_timeout_s
        self.max_queue = max(1, max_queue)
        # per-shape FIFO queues under one condition
        self._queues: Dict[Tuple[int, ...], deque] = {}
        self._size = 0
        self._cond = threading.Condition()
        self._stop = False
        self._join_timeout = 10.0
        # batch size -> batches dispatched at that size
        self.batch_sizes: Counter = Counter()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="tagger-batcher")
        self.thread.start()

    def submit(self, pixels, timeout: Optional[float] = None,
               want_timing: bool = False):
        """One decoded image -> (num_tags,) probabilities.  Blocking.

        ``pixels`` is (H, W, 3) uint8 in RGB mode, or the planar (Y, CbCr)
        pair in YUV mode.  Raises QueueFullError at once when max_queue
        requests are pending (the handler's 503).  With ``want_timing``
        returns ``(probs, {"queue_wait_ms", "device_pipeline_ms"})``."""
        item = _Pending(pixels)
        shape = (tuple(pixels[0].shape) if isinstance(pixels, tuple)
                 else tuple(pixels.shape))
        with self._cond:
            if self._stop:
                raise RuntimeError("server is shutting down")
            if self._size >= self.max_queue:
                raise QueueFullError(
                    f"request queue full ({self.max_queue} pending)")
            self._queues.setdefault(shape, deque()).append(item)
            self._size += 1
            self._cond.notify()
        wait_s = self.request_timeout_s if timeout is None else timeout
        if not item.event.wait(wait_s):
            # withdraw, so an abandoned request neither holds queue
            # capacity nor costs a device batch nobody reads
            with self._cond:
                q = self._queues.get(shape)
                if q is not None:
                    try:
                        q.remove(item)
                        self._size -= 1
                        if not q:
                            del self._queues[shape]
                    except ValueError:
                        pass  # the worker already took it
            raise TimeoutError("classify request timed out")
        if item.error is not None:
            raise item.error
        if want_timing:
            timing = {}
            if item.t_dispatch is not None:
                timing["queue_wait_ms"] = round(
                    (item.t_dispatch - item.ts) * 1000, 1)
                if item.t_done is not None:
                    timing["device_pipeline_ms"] = round(
                        (item.t_done - item.t_dispatch) * 1000, 1)
            return item.probs, timing
        return item.probs

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self.thread.join(timeout=self._join_timeout)
        # fail what is still queued, so handler threads blocked in submit()
        # return now instead of waiting out their timeout
        with self._cond:
            leftovers = [it for q in self._queues.values() for it in q]
            self._queues.clear()
            self._size = 0
        err = RuntimeError("server shut down before the request ran")
        for item in leftovers:
            item.error = err
            item.event.set()

    def _take_batch(self, block: bool = True):
        """Up to max_batch items of ONE shape.

        ``block=True`` waits for work (None on stop); ``block=False``
        returns [] at once when nothing is queued (while a batch is in
        flight).  The coalescing window waits only while the batch is not
        full."""
        with self._cond:
            while self._size == 0:
                if self._stop:
                    return None
                if not block:
                    return []
                self._cond.wait(timeout=0.5)
            # oldest head first across shapes: a minority resolution is not
            # starved by a flood of the dominant one
            shape = min(self._queues, key=lambda s: self._queues[s][0].ts)
            batch = self._pop_shape(shape, self.max_batch)
        deadline = time.monotonic() + self.timeout_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            with self._cond:
                if not self._queues.get(shape):
                    if self._stop:
                        break
                    self._cond.wait(timeout=remaining)
                batch.extend(self._pop_shape(
                    shape, self.max_batch - len(batch)))
        return batch

    def _pop_shape(self, shape, k):
        """Under self._cond: pop up to k items of one shape."""
        q = self._queues.get(shape)
        out = []
        while q and len(out) < k:
            out.append(q.popleft())
            self._size -= 1
        if q is not None and not q:
            del self._queues[shape]
        return out

    def _dispatch(self, batch):
        """Queue one batch on the card without synchronizing:
        (device probabilities, real count)."""
        if self.transfer_format == "yuv420":
            return self.engine.classify_yuv_async(
                np.stack([b.pixels[0] for b in batch]),
                np.stack([b.pixels[1] for b in batch]))
        return self.engine.classify_async(np.stack([b.pixels for b in batch]))

    def _run(self):
        # one batch stays in flight while the next is assembled and
        # dispatched; with an empty queue the in-flight batch resolves at
        # once, so a lone request waits for nothing
        inflight = None  # (items, device_probs, real_count)
        while True:
            batch = self._take_batch(block=inflight is None)
            if batch is None:  # stopping: resolve what the card still owes
                if inflight is not None:
                    self._resolve(*inflight)
                return
            dispatched = None
            if batch:
                t_dispatch = time.monotonic()
                for item in batch:
                    item.t_dispatch = t_dispatch
                try:
                    probs, n = self._dispatch(batch)
                    dispatched = (batch, probs, n)
                    self.batch_sizes[len(batch)] += 1
                except Exception as e:  # dispatch failed: fail this batch
                    for item in batch:
                        item.error = e
                        item.event.set()
            if inflight is not None:
                self._resolve(*inflight)
            inflight = dispatched

    @staticmethod
    def _resolve(items, device_probs, real_count):
        """Fetch a dispatched batch's probabilities and wake its waiters."""
        try:
            probs = _to_host(device_probs)[:real_count]
            for item, p in zip(items, probs):
                item.probs = p
        except Exception as e:  # a device error surfaces at the fetch
            for item in items:
                item.error = e
        finally:
            t_done = time.monotonic()
            for item in items:
                item.t_done = t_done
                item.event.set()


def _make_handler(worker: BatchingWorker, engine,
                  resolutions: Sequence[int], threshold: float,
                  max_body_bytes: int, transfer_format: str = "rgb"):
    default_resolution = resolutions[0]
    allowed = set(resolutions)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _discard_body(self, length: int, cap: int = 256 * 1024 * 1024):
            """Read and drop up to ``cap`` bytes of an unread body in 1 MB
            chunks; a larger body closes the connection instead.  Closing
            with unread bytes would reset the connection and lose the
            error response in flight."""
            remaining = min(length, cap)
            try:
                while remaining > 0:
                    chunk = self.rfile.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    remaining -= len(chunk)
            except Exception:
                pass
            if length > cap:
                self.close_connection = True

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "num_tags": len(engine.tag_names),
                                 "resolution": default_resolution,
                                 "resolutions": sorted(allowed)})
            elif self.path == "/tags":
                self._json(200, {"tags": engine.tag_names})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path != "/classify":
                self._json(404, {"error": "unknown path"})
                try:
                    self._discard_body(
                        int(self.headers.get("Content-Length", "0")))
                except ValueError:
                    pass
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body"})
                return
            resolution = default_resolution
            qs = urllib.parse.parse_qs(parsed.query)
            if "resolution" in qs:
                try:
                    resolution = int(qs["resolution"][0])
                except ValueError:
                    self._json(400, {"error": "bad resolution"})
                    self._discard_body(length)
                    return
                if resolution not in allowed:
                    self._json(400, {
                        "error": f"resolution {resolution} not served",
                        "resolutions": sorted(allowed)})
                    self._discard_body(length)
                    return
            if length > max_body_bytes:
                self._json(413, {"error": f"body exceeds "
                                          f"{max_body_bytes} bytes"})
                self._discard_body(length)
                return
            try:
                data = self.rfile.read(length)
                # the square distorting BILINEAR transform, the square file
                # loader's bytes-level policy (native decode where built);
                # normalization happens on the card
                if transfer_format == "yuv420":
                    pixels = decode_bytes_square_yuv(data, resolution)
                else:
                    pixels = decode_bytes_square(data, resolution)
            except Exception as e:
                self._json(400, {"error": f"bad image: {e}"})
                return
            try:
                probs, timing = worker.submit(pixels, want_timing=True)
            except QueueFullError as e:
                self._json(503, {"error": str(e)},
                           headers=[("Retry-After", "1")])
                return
            except Exception as e:
                self._json(500, {"error": f"inference failed: {e}"})
                return
            payload = _format_results(engine.tag_names, probs, threshold)
            # queue wait vs device pipeline, opt-in with the X-Timing
            # header: the default body stays exactly the entry schema
            if self.headers.get("X-Timing"):
                payload["timing_ms"] = timing
            self._json(200, payload)

    return Handler


class TaggerServer:
    """Owns the HTTP server and the batching worker; ``with`` or
    :meth:`serve_forever`.

    ``resolution`` is an int or a sequence of ints; the first is the
    default, the others are chosen per request with
    ``POST /classify?resolution=N``.  With ``warmup`` the constructor runs
    one batch of every size from 1 to ``max_batch`` at every resolution, on
    the calling thread, before the port binds: the kernels' first build
    and cuDNN's first choice for each shape happen there, not in a
    request."""

    def __init__(self, engine, resolution=1024, threshold: float = 0.5,
                 host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 8, batch_timeout_ms: float = 10.0,
                 request_timeout_s: float = 600.0, warmup: bool = True,
                 max_body_bytes: int = 32 * 1024 * 1024,
                 max_queue: int = 64, transfer_format: str = "rgb"):
        resolutions = ((resolution,) if isinstance(resolution, int)
                       else tuple(resolution))
        if not resolutions:
            raise ValueError("need at least one resolution")
        if transfer_format not in ("rgb", "yuv420"):
            raise ValueError(f"unknown transfer_format {transfer_format!r}")
        if transfer_format == "yuv420" and any(r % 2 for r in resolutions):
            raise ValueError("yuv420 transfer needs even resolutions")
        if warmup:
            for r in resolutions:
                print(f"warming up {r}px batches of 1 to {max(1, max_batch)}"
                      f" ...", flush=True)
                for b in range(1, max(1, max_batch) + 1):
                    if transfer_format == "yuv420":
                        probs, _ = engine.classify_yuv_async(
                            np.zeros((b, r, r), np.uint8),
                            np.zeros((b, 2, r // 2, r // 2), np.uint8))
                        _to_host(probs)
                    else:
                        engine.classify(np.zeros((b, r, r, 3), np.uint8))
        self.worker = BatchingWorker(engine, max_batch, batch_timeout_ms,
                                     request_timeout_s, max_queue=max_queue,
                                     transfer_format=transfer_format)
        handler = _make_handler(self.worker, engine, resolutions, threshold,
                                max_body_bytes, transfer_format)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        print(f"tagger server listening on :{self.port} "
              f"(POST /classify, GET /healthz, GET /tags)", flush=True)
        try:
            self.httpd.serve_forever()
        finally:
            self.shutdown()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="tagger-http")
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.worker.stop()

    def __enter__(self):
        self.start_background()
        return self

    def __exit__(self, *exc):
        self.shutdown()
