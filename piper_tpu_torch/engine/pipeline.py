"""Asynchronous serving pipeline (counterpart of piper_tpu.engine.pipeline).

`submit()` dispatches one fused synthesis at once (the runtime queues the
work and the audio's copy to pinned host memory and returns) and gives back
a Future; a pool of fetcher threads waits for the copies, so the host work
of one request overlaps the device work of the next. `submit_batch()` hands
whole batches to one worker that dispatches batch i+1, then fetches batch
i: batch i's copy and slicing overlap batch i+1's work on the card. Split
mode's frame-count read waits for the work queued before it, so dispatching
batch i+1 waits for batch i's decode; the overlap is host work against
device work.

Every device call goes through the runtime under its lock (the precision
tiers are process-wide flags), and the dispatches of one pipeline also
under `_dispatch_lock`. A fetcher only waits for a copy, except when a
fused request overflowed its frame budget: then it redoes the utterance
with the runtime's blocking synthesize, which takes the runtime's lock.

Every thread is named piper-torch-pipeline-*; close() (or leaving the
context) joins them.

Spans (utils/profiling.py, each also a row of the runtime's profiler):
`pipeline.wait` while the batch worker waits on its queue,
`pipeline.dispatch` around a dispatch (batch i+1's; a fused submit's, on
the caller's thread) and `pipeline.fetch` around a fetch (batch i's, on
the worker; a fused submit's, on a fetcher), the fetch under the batch id
its dispatch took.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from piper_tpu_torch.engine.runtime import PiperRuntime


def _claim(fut: Future) -> bool:
    """Atomically move a pipeline future to RUNNING; False when the caller
    already cancelled it. After a successful claim set_result/set_exception
    cannot race a cancel (a cancelled future raises InvalidStateError on
    set_result, which would kill the thread)."""
    return fut.set_running_or_notify_cancel()


class ServingPipeline:
    _SHUTDOWN = object()

    def __init__(self, runtime: PiperRuntime, max_inflight: int = 8,
                 num_fetchers: int = 4):
        self.rt = runtime
        self._inflight = threading.Semaphore(max_inflight)
        self._queue: "queue.Queue" = queue.Queue()
        self._dispatch_lock = threading.Lock()
        # Guards the closed flag vs enqueue ordering: an item must never
        # land AFTER close()'s shutdown sentinels (its future would strand).
        self._close_lock = threading.Lock()
        self._closed = False
        # Batched submissions run on one worker (started lazily) that
        # dispatches and fetches in turn; see submit_batch.
        self._batch_queue: "queue.Queue" = queue.Queue()
        self._batch_thread: Optional[threading.Thread] = None
        self._batch_lock = threading.Lock()
        self._fetchers = [
            threading.Thread(target=self._fetch_loop, daemon=True,
                             name=f"piper-torch-pipeline-fetch-{i}")
            for i in range(max(1, num_fetchers))
        ]
        for t in self._fetchers:
            t.start()

    def submit(
        self,
        phoneme_ids: Sequence[int],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> "Future[np.ndarray]":
        """Queue one utterance; the Future resolves to PCM in the runtime's
        output_dtype, equal to a fused-mode synthesize with the same seed."""
        if self._closed:
            raise RuntimeError("pipeline is closed")
        fut: "Future[np.ndarray]" = Future()
        self._inflight.acquire()
        try:
            with self._dispatch_lock, self.rt.profiler.span("pipeline.dispatch"):
                outs, meta = self.rt.dispatch_fused(
                    phoneme_ids,
                    noise_scale=noise_scale,
                    length_scale=length_scale,
                    noise_w=noise_w,
                    speaker_id=speaker_id,
                    seed=seed,
                )
        except Exception as e:  # noqa: BLE001 — surface through the future
            self._inflight.release()
            fut.set_exception(e)
            return fut
        with self._close_lock:
            if self._closed:
                # close() already sent the fetcher sentinels; an enqueue
                # now would strand the future behind them.
                self._inflight.release()
                fut.set_exception(RuntimeError("pipeline is closed"))
                return fut
            self._queue.put((fut, outs, meta))
        return fut

    def submit_batch(
        self,
        phoneme_ids_batch: Sequence[Sequence[int]],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_ids: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
    ) -> "Future[list]":
        """Queue a whole batch; the Future resolves to a list of PCM arrays
        (one per utterance, exact lengths, the audio of synthesize_batch).

        Batches run on one worker, depth 2: dispatch batch i+1, then fetch
        batch i."""
        fut: "Future[list]" = Future()
        kwargs = dict(
            noise_scale=noise_scale, length_scale=length_scale,
            noise_w=noise_w, speaker_ids=speaker_ids, seed=seed,
        )
        # Closed-check, worker start and enqueue share one lock with
        # close()'s sentinel put, so a submit can neither land after the
        # sentinel nor start a worker close() already joined.
        with self._batch_lock:
            if self._closed:
                raise RuntimeError("pipeline is closed")
            if self._batch_thread is None:
                self._batch_thread = threading.Thread(
                    target=self._batch_loop, daemon=True, name="piper-torch-pipeline-batch")
                self._batch_thread.start()
            self._batch_queue.put((fut, [list(x) for x in phoneme_ids_batch], kwargs))
        return fut

    def _batch_loop(self) -> None:
        pending = None  # (future, device_outs, meta) awaiting its fetch
        span = self.rt.profiler.span
        while True:
            try:
                with span("pipeline.wait"):
                    item = self._batch_queue.get(block=pending is None)
            except queue.Empty:
                item = None  # nothing new: just complete the pending fetch
            if item is None and pending is None:
                continue
            nxt = None
            if item is self._SHUTDOWN:
                if pending is not None:
                    self._finish_batch(pending)
                return
            if item is not None:
                fut, ids_batch, kwargs = item
                try:
                    with self._dispatch_lock, span("pipeline.dispatch"):
                        outs, meta = self.rt.dispatch_batch(ids_batch, **kwargs)
                    nxt = (fut, outs, meta)
                except Exception as e:  # noqa: BLE001
                    if _claim(fut):
                        fut.set_exception(e)
            if pending is not None:
                self._finish_batch(pending)
            pending = nxt

    def _finish_batch(self, pending) -> None:
        fut, outs, meta = pending
        if not _claim(fut):
            return  # caller cancelled: skip the fetch, keep the worker alive
        try:
            with self.rt.profiler.span("pipeline.fetch", batch=meta.get("batch")):
                fut.set_result(self.rt.fetch_batch(outs, meta))
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)

    def _fetch_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, outs, meta = item
            try:
                if not _claim(fut):
                    continue  # caller cancelled; the fetcher must survive
                try:
                    with self.rt.profiler.span("pipeline.fetch", batch=meta.get("batch")):
                        fut.set_result(self.rt.fetch_fused(outs, meta))
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)
            finally:
                self._inflight.release()

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            for _ in self._fetchers:
                self._queue.put(None)
        for t in self._fetchers:
            t.join(timeout=60)
        with self._batch_lock:
            worker = self._batch_thread
            if worker is not None:
                self._batch_queue.put(self._SHUTDOWN)
        if worker is not None:
            worker.join(timeout=120)

    def __enter__(self) -> "ServingPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
