"""Online serving host: dynamic micro-batching and an HTTP front end over
a serving bundle (counterpart of peekvit_tpu/serving_host.py, with its
names and semantics).

Concurrent single-image (or small-batch) requests coalesce into
engine-sized batches, so the card sees the batch geometry the bundle was
saved for instead of one forward per request.

Two layers, both usable on their own:

- :class:`MicroBatcher`: in-process request aggregation.
  ``submit(images[, budget]) -> Future``; a dispatcher thread drains
  same-budget runs of the queue, concatenates them up to the largest
  bucket, zero-pads to the smallest bucket that fits (see
  ``serving.BucketedServingEngine``: pad rows are inert because the
  engines' inference math is per image), runs ONE engine call, and slices
  the results back per request. Requests with different budgets never
  share a batch (the budget is a whole-batch operand).
- :func:`build_server` / the CLI: a threaded HTTP server on top.
  ``POST /predict`` with an ``.npy`` body (one item or a batch; optional
  ``X-Budget`` header) answers with ``.npy`` logits (``.npz`` with
  ``out_0..`` keys for tuple-output bundles); ``GET /healthz`` and
  ``GET /stats`` report liveness and the batching counters. Standard
  library only, beside torch and numpy.

Results on the card: the dispatcher enqueues the forward and, right after
it, the device-to-host copy of its outputs into pinned memory
(``non_blocking``), and records a CUDA event; a completer thread waits on
that event alone. A plain ``.cpu()`` in the completer would wait for
every batch dispatched after its own as well (all threads share the
default stream) and undo ``pipeline_fetches``. The inputs go up the same
way: the requests' rows are copied once, into a pinned buffer of the
bucket's size. ``t_dispatch_ms`` is host enqueue time, as in JAX.

Batch-coupled bundles (residual ViTs whose budget token is not
``'learnable'``: the gate thresholds take a whole-batch budget-token
mean): zero PADDING would inject fake rows into that mean, so the batcher
dispatches such requests exactly as submitted, and only at bucket sizes
(save with bucket 1 to serve request at a time).

CLI::

    python -m peekvit_torch.serving_host BUNDLE [--port 8390]
        [--max-delay-ms 5] [--timeout-s 60] [--pipeline-fetches 4]
        [--device cuda|cpu]
"""

from __future__ import annotations

import io
import json
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from peekvit_torch.serving import load_serving_bundle


class MicroBatcher:
    """Aggregate concurrent requests into engine-sized batches.

    ``engine`` is a loaded bundle (``ServingEngine`` or
    ``BucketedServingEngine``) or anything with the same surface
    (``__call__(images, budget=)``, ``.meta``, ``.batch_sizes``, and
    ``.device`` where it runs on the card). ``max_delay_ms`` bounds how
    long a request waits for batchmates once it is at the head of the
    queue; a full batch dispatches immediately. ``max_queue_items`` is the
    overload bound: submits beyond it raise RuntimeError (the HTTP layer
    answers 503) instead of growing a backlog the engine can never drain.
    Requests whose Future was cancelled (e.g. an HTTP caller timing out)
    are shed before dispatch, so abandoned work never reaches the device.
    """

    def __init__(self, engine, max_delay_ms: float = 5.0,
                 max_queue_items: Optional[int] = None,
                 pipeline_fetches: int = 4):
        self.engine = engine
        self._buckets = tuple(sorted(engine.batch_sizes))
        self._item_shape = tuple(engine.meta["image_shape"][1:])
        self._coupled = bool(engine.meta.get("batch_coupled"))
        device = getattr(engine, "device", None)
        self._cuda = device is not None and torch.device(device).type == "cuda"
        if self._cuda:  # "cuda" without an index: the device current here
            device = torch.device(device)
            self._device = (device if device.index is not None
                            else torch.device("cuda", torch.cuda.current_device()))
        self._max_delay = max_delay_ms / 1000.0
        self._max_items = (8 * self._buckets[-1] if max_queue_items is None
                           else int(max_queue_items))
        self._cv = threading.Condition()
        self._queue = []  # [(rows ndarray, budget, Future)]
        self._queued_items = 0
        self._closed = False
        # Per-dispatch cost breakdown: host batch assembly, the engine's
        # dispatch (host enqueue), the wait for the device-to-host result
        # copy, and future delivery, so that a plateau can be attributed
        self.stats = {"requests": 0, "items": 0, "batches": 0,
                      "padded_rows": 0, "errors": 0, "shed": 0,
                      "rejected": 0, "t_concat_ms": 0.0,
                      "t_dispatch_ms": 0.0, "t_fetch_ms": 0.0,
                      "t_deliver_ms": 0.0}
        self._stats_lock = threading.Lock()
        # Fetch/dispatch OVERLAP: result fetches run on a small completer
        # pool so that the dispatcher keeps feeding the device while
        # earlier batches' results are still on their way.
        # pipeline_fetches=0 is the serial path. The semaphore bounds the
        # completions in flight, so that dispatch cannot run unboundedly
        # ahead.
        self._completers = None
        self._inflight = None
        if pipeline_fetches > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._completers = ThreadPoolExecutor(
                max_workers=pipeline_fetches, thread_name_prefix="mb-fetch")
            self._inflight = threading.Semaphore(2 * pipeline_fetches)
        self._thread = threading.Thread(
            target=self._loop, name="microbatcher", daemon=True)
        self._thread.start()

    def _bump(self, key: str, ms: float) -> None:
        with self._stats_lock:
            self.stats[key] += ms

    # -- client surface ---------------------------------------------------

    def submit(self, images, budget: Optional[float] = None) -> Future:
        """Queue one item (item-shaped) or one batch (batch-shaped);
        returns a Future resolving to the engine outputs (numpy) for
        exactly the submitted rows (leading axis preserved)."""
        x = np.asarray(images)
        if x.shape == self._item_shape:
            x = x[None]
        if x.shape[1:] != self._item_shape or x.ndim != \
                len(self._item_shape) + 1:
            raise ValueError(
                f"expected items of shape {self._item_shape} (or batches "
                f"of them), got {x.shape}")
        if not 1 <= x.shape[0] <= self._buckets[-1]:
            raise ValueError(
                f"request batch {x.shape[0]} must be 1..{self._buckets[-1]}"
                " (the largest exported bucket); split larger requests")
        if self._coupled and x.shape[0] not in self._buckets:
            raise ValueError(
                f"this bundle is batch-coupled (whole-batch budget-token "
                f"mean): requests must exactly match a bucket "
                f"{self._buckets}; no padding, no aggregation")
        fut = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self._queued_items + x.shape[0] > self._max_items:
                self.stats["rejected"] += 1
                raise RuntimeError(
                    f"overloaded: {self._queued_items} items queued "
                    f"(max_queue_items={self._max_items}); retry later")
            self._queue.append((x, budget, fut))
            self._queued_items += x.shape[0]
            self.stats["requests"] += 1
            self.stats["items"] += x.shape[0]
            self._cv.notify_all()
        return fut

    def predict(self, images, budget: Optional[float] = None,
                timeout: Optional[float] = None):
        return self.submit(images, budget=budget).result(timeout)

    def close(self) -> None:
        """Stop accepting work, flush the queue, join the dispatcher and
        any in-flight result fetches."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()
        if self._completers is not None:
            self._completers.shutdown(wait=True)

    # -- dispatcher --------------------------------------------------------

    def _head_run(self):
        """(rows, budget) aggregable at the queue head right now: the
        longest same-budget prefix that fits the largest bucket."""
        budget, n = self._queue[0][1], 0
        for x, b, _ in self._queue:
            if b != budget or n + x.shape[0] > self._buckets[-1]:
                break
            n += x.shape[0]
        return n, budget

    def _shed_cancelled(self):
        """Drop queue entries whose caller gave up (Future cancelled) so
        that abandoned work never reaches the device. Lock held by the
        caller."""
        keep = []
        for entry in self._queue:
            if entry[2].cancelled():
                self.stats["shed"] += 1
                self._queued_items -= entry[0].shape[0]
            else:
                keep.append(entry)
        self._queue = keep

    def _loop(self):
        if self._cuda:  # the kernels launch on this thread's current device
            torch.cuda.set_device(self._device)
        while True:
            with self._cv:
                self._shed_cancelled()
                while not self._queue and not self._closed:
                    self._cv.wait()
                    self._shed_cancelled()
                if not self._queue:
                    return  # closed and drained
                # wait (bounded) for batchmates unless already full;
                # batch-coupled bundles dispatch requests as submitted
                deadline = time.monotonic() + self._max_delay
                while not self._coupled and not self._closed:
                    n, _ = self._head_run()
                    rem = deadline - time.monotonic()
                    if n >= self._buckets[-1] or rem <= 0:
                        break
                    self._cv.wait(rem)
                    self._shed_cancelled()
                    if not self._queue:
                        break
                if not self._queue:
                    continue
                if self._coupled:
                    batch = [self._queue.pop(0)]
                    n = batch[0][0].shape[0]
                    budget = batch[0][1]
                else:
                    n, budget = self._head_run()
                    batch, got = [], 0
                    while got < n:
                        item = self._queue.pop(0)
                        batch.append(item)
                        got += item[0].shape[0]
                self._queued_items -= n
            self._dispatch(batch, n, budget)

    def _dispatch(self, batch, n, budget):
        t0 = time.monotonic()
        try:
            # the rows go straight into one (pinned, on the card) buffer of
            # the bucket's size; zero rows pad it here, so that plain
            # single-geometry bundles batch too (the coupled case never
            # pads: exact bucket enforced)
            bucket = min(b for b in self._buckets if b >= n)
            x = torch.empty((bucket,) + self._item_shape, dtype=torch.float32,
                            pin_memory=self._cuda)
            rows, off = x.numpy(), 0
            for r, _, _ in batch:
                rows[off:off + r.shape[0]] = r
                off += r.shape[0]
            rows[n:] = 0
            t1 = time.monotonic()
            with torch.inference_mode():
                if self._cuda:
                    x = x.to(self._device, non_blocking=True)
                out = self._start_fetch(self.engine(x, budget=budget))
            t2 = time.monotonic()
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["padded_rows"] += bucket - n
                self.stats["t_concat_ms"] += (t1 - t0) * 1e3
                self.stats["t_dispatch_ms"] += (t2 - t1) * 1e3
        except Exception as e:  # deliver, don't kill the dispatcher
            with self._stats_lock:
                self.stats["errors"] += 1
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            return
        if self._completers is None:
            self._complete(out, batch)
            return
        self._inflight.acquire()

        def task():
            try:
                self._complete(out, batch)
            finally:
                self._inflight.release()

        self._completers.submit(task)

    def _start_fetch(self, out):
        """(host leaves, tuple output?, event): on the card, the outputs'
        copies into pinned host memory, enqueued behind the forward, and
        the event recorded after them; on the CPU the outputs themselves."""
        tup = isinstance(out, (tuple, list))
        leaves = list(out) if tup else [out]
        if not self._cuda:
            return leaves, tup, None
        host = []
        for v in leaves:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record()
        return host, tup, event

    def _complete(self, out, batch):
        """Wait for the results and resolve the futures (completer stage)."""
        t0 = time.monotonic()
        try:
            leaves, tup, event = out
            if event is not None:
                event.synchronize()
            leaves = [v.numpy() for v in leaves]
            t1 = time.monotonic()
            off = 0
            for x, _, fut in batch:
                k = x.shape[0]
                if not fut.cancelled():  # the caller may have timed out
                    rows = [v[off:off + k] for v in leaves]
                    fut.set_result(tuple(rows) if tup else rows[0])
                off += k
            t2 = time.monotonic()
            self._bump("t_fetch_ms", (t1 - t0) * 1e3)
            self._bump("t_deliver_ms", (t2 - t1) * 1e3)
        except Exception as e:
            with self._stats_lock:
                self.stats["errors"] += 1
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def build_server(batcher: MicroBatcher, port: int = 0,
                 timeout_s: float = 60.0, backlog: int = 128):
    """A ``ThreadingHTTPServer`` (bound to 127.0.0.1: front it with a
    real proxy to expose it) serving ``POST /predict`` / ``GET /healthz``
    / ``GET /stats`` over ``batcher``. The caller runs ``serve_forever()``
    (or ``handle_request()``) and ``server_close()``.

    ``backlog`` raises socketserver's default listen queue of 5, which
    resets connections under concurrent load. A request that times out
    (no result in ``timeout_s``) answers 503 and CANCELS its queue entry
    so that the batcher sheds it; an overloaded batcher (queue cap)
    answers 503 at once."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        request_queue_size = backlog

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: the counters are GET /stats
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True,
                                 "buckets": list(batcher._buckets)})
            elif self.path == "/stats":
                self._json(200, dict(batcher.stats,
                                     buckets=list(batcher._buckets)))
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            fut = None
            try:
                size = int(self.headers.get("Content-Length", "0"))
                arr = np.load(io.BytesIO(self.rfile.read(size)),
                              allow_pickle=False)
                budget = self.headers.get("X-Budget")
                fut = batcher.submit(
                    arr, budget=None if budget is None else float(budget))
                out = fut.result(timeout_s)
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            except RuntimeError as e:  # queue cap / closed -> back off
                self._json(503, {"error": str(e)})
                return
            except TimeoutError:
                if fut is not None:
                    fut.cancel()  # shed: never run work nobody awaits
                self._json(503, {"error": f"no result in {timeout_s}s"})
                return
            except Exception as e:  # engine failure surfaced via Future
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            leaves = list(out) if isinstance(out, tuple) else [out]
            buf = io.BytesIO()
            if len(leaves) == 1:
                np.save(buf, leaves[0])
                ctype = "application/x-npy"
            else:
                np.savez(buf, **{f"out_{i}": v for i, v in enumerate(leaves)})
                ctype = "application/x-npz"
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Server(("127.0.0.1", port), Handler)


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Serve a saved bundle over HTTP with dynamic "
                    "micro-batching")
    p.add_argument("bundle")
    p.add_argument("--port", type=int, default=8390)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--timeout-s", type=float, default=60.0)
    p.add_argument("--pipeline-fetches", type=int, default=4,
                   help="completer threads overlapping device->host result "
                        "fetches with dispatch (0 = serial)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu; nothing moves to the CPU unasked")
    args = p.parse_args(argv)

    batcher = MicroBatcher(load_serving_bundle(args.bundle, device=args.device),
                           max_delay_ms=args.max_delay_ms,
                           pipeline_fetches=args.pipeline_fetches)
    httpd = build_server(batcher, port=args.port, timeout_s=args.timeout_s)
    print(json.dumps({"serving": f"http://127.0.0.1:{httpd.server_port}",
                      "buckets": list(batcher._buckets),
                      "budget_mode": batcher.engine.meta["budget_mode"]}),
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()


if __name__ == "__main__":
    _main()
