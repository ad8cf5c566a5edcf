"""Continuous-batching serving engine, single host (port of
qtpu/serve/engine.py).

A scheduler thread drains a bounded request queue, packs requests into the
smallest covering batch bucket (zero-padding the tail), runs the forward on
the device and resolves one future per request.  With ``pipeline=True``
rounds are double-buffered: batch k+1 is collected, packed, uploaded and its
forward enqueued while the card still computes batch k; only the resolve
step (copy back, complete futures) runs one round behind, and an empty
queue resolves the pending round at once.  Requests are validated at
``submit`` (dtype by numpy "same_kind", shape against the first request or
``warmup``), so one malformed request fails its own caller only.  A crash in
the scheduler fails every in-flight and queued future and marks the engine
unhealthy.  The mesh, multi-host lockstep and watchdog parts are still to
port (ROADMAP.md).
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from qtpu_torch.utils.device import resolve_device


def pack_batch(images, pad_to: int, dtype, shape) -> np.ndarray:
    """One copy of ``images`` into a zero-padded (pad_to, *shape) buffer."""
    out = np.zeros((pad_to, *shape), dtype)
    for i, im in enumerate(images):
        out[i] = im
    return out


class ServingEngine:
    """Continuous-batching inference engine on one device."""

    def __init__(self, model, serve_vars: Dict[str, Any], *,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_wait_ms: float = 2.0, forward_fn=None,
                 forward_factory=None, max_queue: int = 4096,
                 preprocess_fn=None, raw_dtype=np.float32,
                 pipeline: bool = True, device=None):
        """``forward_fn(variables, batch) -> logits`` or
        ``forward_factory(variables) -> fn(batch)`` (e.g.
        ``lambda sv: ResNetInt8Engine(sv, arch).forward``); with neither,
        the engine serves ``model(batch)`` — the module SERVE path's model
        (``qtpu_torch.nn.serve_layers.serve_model``), as qtpu serves
        ``model.apply``.  ``device``: ``None`` means the card; ``"cpu"``
        for the plain path.
        """
        if forward_fn is not None and forward_factory is not None:
            raise ValueError("pass forward_fn OR forward_factory")
        self.model = model
        self.vars = serve_vars
        self.device = resolve_device(device)
        if forward_factory is not None:
            inner = forward_factory(serve_vars)
            forward_fn = lambda _v, x: inner(x)   # noqa: E731
        elif forward_fn is None:
            if not callable(model):
                raise ValueError("pass forward_fn, forward_factory or a "
                                 f"callable model (got {type(model).__name__})")
            forward_fn = lambda _v, x: model(x)   # noqa: E731
        self._fwd = forward_fn
        self._preprocess = preprocess_fn
        self._raw_dtype = np.dtype(raw_dtype)
        self._pipeline = bool(pipeline)
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue.Queue[Optional[Tuple[np.ndarray, Future, float]]]" \
            = queue.Queue(maxsize=max_queue)
        self._stats_lock = threading.Lock()
        self._latencies: "collections.deque" = collections.deque(maxlen=10_000)
        self._images = 0
        self._batches = 0
        self._occupancy = 0.0
        self._busy_s = 0.0
        self._busy_mark = 0.0
        self._rounds_per_bucket: Dict[int, int] = collections.Counter()
        self._img_shape: Optional[Tuple[int, ...]] = None
        self._inflight: list = []
        self._started = time.monotonic()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop_guarded,
                                        daemon=True, name="qtpu-torch-serve")
        self._thread.start()

    # ---- client API -----------------------------------------------------

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one image (H, W, C); resolves to its logits (numpy)."""
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is stopped") from self._error
        image = np.asarray(image)
        if image.dtype != self._raw_dtype:
            if not np.can_cast(image.dtype, self._raw_dtype,
                               casting="same_kind"):
                raise ValueError(
                    f"request dtype {image.dtype} does not match the "
                    f"engine's ingest dtype {self._raw_dtype} (refusing "
                    "unsafe cast; for uint8 ingest send 0-255 pixels)")
            image = image.astype(self._raw_dtype)
        with self._stats_lock:
            if self._img_shape is None:
                self._img_shape = tuple(image.shape)
            elif tuple(image.shape) != self._img_shape:
                raise ValueError(
                    f"request shape {tuple(image.shape)} does not match the "
                    f"engine's image shape {self._img_shape}")
        fut: Future = Future()
        self._queue.put((image, fut, time.monotonic()))
        if self._stop.is_set():
            self._drain_queue()
        return fut

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Synchronous convenience: submit a batch, wait for all results."""
        futs = [self.submit(im) for im in images]
        return np.stack([f.result() for f in futs])

    def warmup(self, image_shape: Tuple[int, ...]) -> None:
        """Run every bucket once and pin the image shape."""
        self._img_shape = tuple(image_shape)
        for b in self.buckets:
            out = self._fwd(self.vars, self._upload(
                np.zeros((b, *image_shape), self._raw_dtype)))
            np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)

    def _upload(self, imgs: np.ndarray) -> torch.Tensor:
        if self._preprocess is not None:
            imgs = self._preprocess(imgs)
        return torch.from_numpy(np.ascontiguousarray(imgs)).to(
            self.device, non_blocking=True)

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            lat = sorted(self._latencies)
            n = len(lat)
            elapsed = time.monotonic() - self._started
            return {
                "images": self._images,
                "batches": self._batches,
                "images_per_sec": self._images / elapsed if elapsed else 0.0,
                "images_per_sec_busy": (self._images / self._busy_s
                                        if self._busy_s else 0.0),
                "p50_ms": lat[n // 2] * 1e3 if n else 0.0,
                "p99_ms": lat[min(n - 1, int(n * 0.99))] * 1e3 if n else 0.0,
                "mean_occupancy": self._occupancy / max(self._batches, 1),
                "rounds_per_bucket": dict(self._rounds_per_bucket),
            }

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=10)
        self._drain_queue()

    def _drain_queue(self) -> None:
        err = RuntimeError("ServingEngine stopped")
        if self._error is not None:
            err.__cause__ = self._error
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(err)

    # ---- scheduler ------------------------------------------------------

    def _loop_guarded(self) -> None:
        """A crash anywhere in the scheduler fails every in-flight and
        queued future and marks the engine unhealthy."""
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 — anything kills serving
            self._error = e
            self._stop.set()
            for _, fut, _ in list(self._inflight):
                if not fut.done():
                    fut.set_exception(e)
            self._inflight = []
            self._drain_queue()

    @property
    def healthy(self) -> bool:
        return self._error is None and not self._stop.is_set()

    @staticmethod
    def _round_in_flight(pending) -> bool:
        """True while a dispatched round still computes on the card (a
        non-blocking CUDA event query; False on the CPU)."""
        if pending is None or pending[4] is None:
            return False
        return not pending[4].query()

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        max_b = self.buckets[-1]
        pending = None        # (batch, bucket, out_device, t_run, event)
        while not self._stop.is_set():
            try:
                first = (self._queue.get_nowait() if pending is not None
                         else self._queue.get(timeout=0.1))
            except queue.Empty:
                if pending is not None:
                    self._resolve_round(*pending)
                    pending = None
                    self._inflight = []
                continue
            if first is None:
                break
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < max_b:
                # past the deadline dispatch — unless a round still computes,
                # then keep topping up (an early partial bucket gains nothing)
                past = time.monotonic() >= deadline
                if past and not self._round_in_flight(pending):
                    break
                timeout = (5e-4 if past
                           else max(deadline - time.monotonic(), 5e-4))
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    continue
                if item is None:
                    self._stop.set()
                    break
                batch.append(item)
            self._inflight = list(batch) + (list(pending[0])
                                            if pending else [])
            try:
                dispatched = self._dispatch_round(batch)
            except BaseException:
                # round k's results are computed: deliver them before the
                # guarded wrapper fails the engine with k+1's error
                if pending is not None:
                    self._resolve_round(*pending)
                    self._inflight = []
                raise
            if pending is not None:
                self._resolve_round(*pending)
            pending = dispatched
            self._inflight = list(pending[0])
            if not self._pipeline:
                self._resolve_round(*pending)
                pending = None
                self._inflight = []
        if pending is not None:
            self._resolve_round(*pending)
            self._inflight = []

    def _dispatch_round(self, batch):
        """Pack, upload and enqueue one forward (no wait on the device)."""
        n = len(batch)
        b = self._bucket_for(n)
        try:
            imgs = pack_batch([item[0] for item in batch[:b]], pad_to=b,
                              dtype=self._raw_dtype, shape=self._img_shape)
            t_run = time.monotonic()
            out = self._fwd(self.vars, self._upload(imgs))
            event = None
            if isinstance(out, torch.Tensor) and out.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(out.device))
        except BaseException as e:
            for _, fut, _ in batch:
                fut.set_exception(e)
            raise
        for item in batch[b:]:
            self._queue.put(item)
        return batch[:b], b, out, t_run, event

    def _resolve_round(self, batch, b, out_dev, t_run, _event) -> None:
        """Copy one round's results back and complete its futures."""
        try:
            out = (out_dev.cpu().numpy() if isinstance(out_dev, torch.Tensor)
                   else np.asarray(out_dev))
        except BaseException as e:
            for _, fut, _ in batch:
                fut.set_exception(e)
            raise
        now = time.monotonic()
        with self._stats_lock:
            self._images += len(batch)
            self._batches += 1
            self._rounds_per_bucket[b] += 1
            self._occupancy += len(batch) / b
            self._busy_s += now - max(t_run, self._busy_mark)
            self._busy_mark = now
            for _, _, t0 in batch:
                self._latencies.append(now - t0)
        for i, (_, fut, _) in enumerate(batch):
            fut.set_result(out[i])
