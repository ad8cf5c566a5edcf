"""Continuous-batching serving engine (port of qtpu/serve/engine.py).

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
unhealthy.  A round is packed into its bucket by ``data.native.pack_batch``
(one copy, only the padding tail zeroed).

Several ranks (``mesh=``, a ``parallel.mesh.Mesh`` over the world's ranks,
one device each): the variables are sliced for tensor parallelism over
``model`` (``parallel.mesh.shard_variables``), every rank takes requests
into its own queue, and the scheduler rounds run in lockstep.  Each round
the ranks all-gather their ``(pending, stop)`` counts — one small
collective on a CPU gloo group, which is also the round barrier — and agree
on the smallest covering bucket (buckets are multiples of the ranks'
count, dp · tp); each rank packs its own rows into its share of it (an
idle rank a zero share), the ranks of a model group concatenate their
shares into the batch the group runs (``local_batch_to_global``), and each
rank resolves only its own rows (:meth:`_local_rows`): no row twice, none
to another rank's client.  ``round_timeout_s`` arms a watchdog that turns a
round stuck on a wedged or dead peer into failed futures and ``healthy ==
False``.  ``warmup`` is then a collective, and the rounds start after it
(never beside it: the two would issue collectives on one group from two
threads).
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
import torch.distributed as dist

from qtpu_torch.data.native import pack_batch
from qtpu_torch.parallel.distributed import local_batch_to_global
from qtpu_torch.parallel.mesh import MODEL_AXIS, shard_variables
from qtpu_torch.utils.device import resolve_device


class ServingEngine:
    """Continuous-batching inference engine on one device, or in lockstep
    over the ranks of a mesh."""

    def __init__(self, model, serve_vars: Dict[str, Any], *, mesh=None,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_wait_ms: float = 2.0, forward_fn=None,
                 forward_factory=None, max_queue: int = 4096,
                 preprocess_fn=None, raw_dtype=np.float32,
                 round_timeout_s: Optional[float] = None,
                 pipeline: bool = True, device=None):
        """``forward_fn(variables, batch) -> logits`` or
        ``forward_factory(variables) -> fn(batch)`` (e.g.
        ``lambda sv: ResNetInt8Engine(sv, arch).forward``); with neither,
        the engine serves ``model(batch)`` — the module SERVE path's model
        (``qtpu_torch.nn.serve_layers.serve_model``), as qtpu serves
        ``model.apply``.  ``device``: ``None`` means the card; ``"cpu"``
        for the plain path.

        ``mesh``: the ranks' mesh (module docstring); the forward factory
        gets the sliced variables, and a ``model`` must have been built from
        ``shard_variables(serve_vars, mesh)``.  ``round_timeout_s``
        (several ranks only): the deadline of one lockstep round; a
        watchdog fails the round's futures and the queue and turns
        ``healthy`` false when it passes (the stuck collective itself
        cannot be cancelled: restart the process).
        """
        if forward_fn is not None and forward_factory is not None:
            raise ValueError("pass forward_fn OR forward_factory")
        self.model = model
        self.mesh = mesh
        self._procs = 1 if mesh is None else mesh.size
        self.vars = (serve_vars if mesh is None
                     else shard_variables(serve_vars, mesh))
        self.device = resolve_device(device)
        self._round_timeout_s = round_timeout_s
        self._round_start: Optional[float] = None
        self.round_age_at_timeout: Optional[float] = None
        self._ctl = None
        if self._procs > 1:
            if not dist.is_initialized() or \
                    dist.get_world_size() != self._procs:
                raise ValueError(
                    f"a mesh of {self._procs} ranks needs a world of as "
                    "many processes (parallel.initialize_from_env)")
            # the round barrier: a CPU group whatever the forward's backend
            self._ctl = dist.new_group(backend="gloo")
        if forward_factory is not None:
            inner = forward_factory(self.vars)
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
        # each rank packs an equal share of a round's bucket: every bucket
        # is rounded up to a multiple of the ranks (qtpu: of dp, its
        # processes each holding whole model groups)
        self.buckets = tuple(sorted({-(-int(b) // self._procs) * self._procs
                                     for b in batch_buckets}))
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
        self._idle_rounds = 0
        self._img_shape: Optional[Tuple[int, ...]] = None
        self._inflight: list = []
        self._started = time.monotonic()
        self._stop = threading.Event()
        # lockstep rounds start once warmup's collectives are done: two
        # threads must never issue collectives on one group in turn
        self._warm = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop_guarded,
                                        daemon=True, name="qtpu-torch-serve")
        self._thread.start()
        self.watchdog_armed = bool(self._procs > 1 and round_timeout_s)
        if self.watchdog_armed:
            threading.Thread(target=self._watchdog, daemon=True,
                             name="qtpu-torch-round-watchdog").start()

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
        """Run every bucket once and pin the image shape (with several
        ranks a collective: every rank calls it)."""
        self._img_shape = tuple(image_shape)
        for b in self.buckets:
            x = self._upload(np.zeros((b // self._procs, *image_shape),
                                      self._raw_dtype))
            if self.mesh is not None:
                x = local_batch_to_global(x, self.mesh)
            out = self._fwd(self.vars, x)
            np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)
        self._warm.set()

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
                **({"idle_rounds": self._idle_rounds}
                   if self._procs > 1 else {}),
            }

    def stop(self) -> None:
        """Stop serving; with several ranks every rank's scheduler stops
        after the round that carries this rank's stop flag."""
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=30 if self._procs > 1 else 10)
        self._drain_queue()

    def _drain_queue(self, err: Optional[BaseException] = None) -> None:
        if err is None:
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
        if self._procs > 1:
            self._loop_multihost()
            return
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

    # ---- lockstep scheduler over the ranks ------------------------------

    def _loop_multihost(self) -> None:
        """One round per iteration: collect up to this rank's share of the
        largest bucket, all-gather ``(pending, stop)`` over the world (the
        round barrier), run the round if any rank has rows, and stop
        together once any rank asked to."""
        max_local = self.buckets[-1] // self._procs
        while not self._warm.wait(0.1):
            if self._stop.is_set():
                return
        while True:
            batch = []
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < max_local:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._stop.set()
                    break
                batch.append(item)
            self._inflight = batch
            self._round_start = time.monotonic()
            mine = torch.tensor([len(batch), int(self._stop.is_set())],
                                dtype=torch.int32)
            parts = [torch.empty_like(mine) for _ in range(self._procs)]
            dist.all_gather(parts, mine, group=self._ctl)
            if self._error is not None:      # the watchdog fired meanwhile
                return
            state = torch.stack(parts)
            n_max = int(state[:, 0].max())
            if n_max > 0:
                self._run_batch_multihost(batch, n_max)
            self._round_start = None
            self._inflight = []
            if bool(state[:, 1].any()):
                self._stop.set()
                self._drain_queue()
                return

    def _watchdog(self) -> None:
        """Fail a lockstep round that outlives ``round_timeout_s``: record a
        TimeoutError, fail the round's futures and the queue with it, and
        turn ``healthy`` false.  The scheduler thread stays blocked in the
        collective; no caller does.  It reads the local clock only, every
        ``period`` seconds (a quarter of the timeout, within [0.05, 1])."""
        period = max(0.05, min(1.0, self._round_timeout_s / 4))
        while not self._stop.is_set():
            time.sleep(period)
            start = self._round_start
            if start is None:
                continue
            age = time.monotonic() - start
            if age <= self._round_timeout_s:
                continue
            err = TimeoutError(
                f"lockstep round exceeded round_timeout_s="
                f"{self._round_timeout_s}s (a peer rank is wedged or dead; "
                "restart the ranks)")
            self.round_age_at_timeout = age
            self._error = err
            self._stop.set()
            for _, fut, _ in list(self._inflight):
                if not fut.done():
                    fut.set_exception(err)
            self._drain_queue(err)
            return

    def _local_rows(self, out: torch.Tensor, b_local: int) -> np.ndarray:
        """This rank's rows of its model group's output: the group's batch
        is its ranks' shares in rank order, so rank i of the group owns
        rows ``[i·b_local, (i+1)·b_local)`` — no row twice, none of another
        rank's clients."""
        i = self.mesh.coord(MODEL_AXIS)
        return out[i * b_local:(i + 1) * b_local].cpu().numpy()

    def _run_batch_multihost(self, batch, n_max: int) -> None:
        n = len(batch)
        b = self._bucket_for(n_max * self._procs)        # the round's bucket
        b_local = b // self._procs
        if self._img_shape is None:
            raise RuntimeError(
                "lockstep serving requires warmup() before the first round "
                "(it fixes the image shape on idle ranks)")
        if batch:
            imgs = pack_batch([item[0] for item in batch[:b_local]],
                              pad_to=b_local, dtype=self._raw_dtype,
                              shape=self._img_shape)
        else:   # an idle rank contributes an all-padding share
            imgs = np.zeros((b_local, *self._img_shape), self._raw_dtype)
            self._idle_rounds += 1
        t_run = time.monotonic()
        try:
            x = local_batch_to_global(self._upload(imgs), self.mesh)
            out = self._local_rows(self._fwd(self.vars, x), b_local)
        except BaseException as e:
            for _, fut, _ in batch:
                fut.set_exception(e)
            raise
        now = time.monotonic()
        with self._stats_lock:
            self._images += min(n, b_local)
            self._batches += 1
            self._rounds_per_bucket[b] += 1
            self._occupancy += min(n, b_local) / b_local
            self._busy_s += now - t_run
            for _, _, t0 in batch[:b_local]:
                self._latencies.append(now - t0)
        for i, (_, fut, _) in enumerate(batch[:b_local]):
            fut.set_result(out[i])
        for item in batch[b_local:]:
            self._queue.put(item)
