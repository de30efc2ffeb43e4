"""One process, ONE device worker, every serving surface (the port of
piper_tpu.engine.unified: the same class, names, signatures and defaults,
over the port's MultiVoiceBatchingServer and StreamingServer).

Batch synthesis (MultiVoiceBatchingServer) and low-latency streaming
(StreamingServer) each own a worker thread when they run alone. This
module runs both schedulers on a SINGLE worker thread, so one server
exposes batched synthesis, durations, duration forcing AND chunked
streaming for N voices, with every device call of either kind ordered on
one thread (on the card: one host thread enqueueing on the default stream,
so a stream's window never waits behind another thread's launches for the
runtime's lock).

Scheduling policy — latency first, batching preserved:

* Every loop iteration ticks pending STREAMS first (their windows bound
  audible underrun; a tick is one batched window decode + the previous
  tick's copies, see StreamingServer.tick). A newly submitted stream's head
  (its TTFB) therefore waits at most one batch group + one stream tick.
* Batch groups dispatch between stream ticks via
  MultiVoiceBatchingServer.serve_step(ripe_only=True): a group whose
  batching window (max_wait_ms) hasn't elapsed and whose size is below
  limit is NOT popped early — stream ticks fill the wait, so unifying
  costs batch traffic no aggregation.
* add_voice warm steps and control ops ride the same step scheduler the
  multi-voice batcher already paces (warm_every), so a cold voice load
  never pauses resident voices OR live streams.

Both sub-servers are created with start_worker=False and only the unified
worker ever calls their dispatch/fetch paths.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from piper_tpu_torch.engine.batcher import MultiVoiceBatchingServer
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.engine.stream_server import StreamingServer


class _WakeCondition(threading.Condition):
    """A Condition whose notifies bump a generation counter. The unified
    worker is NOT waiting while it runs its tick/serve pass, so a notify
    sent during the pass (a submit, control op, or close) would be lost;
    instead of re-checking every producer's queue state before sleeping
    (which cannot distinguish NEW work from known-waiting work and turns
    the timed waits into a busy spin), the worker snapshots `gen` before
    the pass and skips the sleep only when it changed. Producers hold the
    lock when notifying (threading.Condition enforces this), so the bump
    is race-free."""

    def __init__(self):
        super().__init__()
        self.gen = 0

    def notify(self, n: int = 1) -> None:
        self.gen += 1
        super().notify(n)

    def notify_all(self) -> None:
        self.gen += 1
        super().notify_all()


class UnifiedServer:
    """Batched + streaming serving for N voices on one worker thread.

    Usage::

        server = UnifiedServer({"alba": rt_a, "ryan": rt_b})
        server.prewarm()                       # before traffic
        fut = server.submit("alba", ids)       # batched synthesis future
        handle = server.submit_stream("ryan", ids)  # chunked stream
        for chunk in handle: play(chunk)

    `stream_kwargs` pass to every voice's StreamingServer (emit_frames,
    row_rungs, max_sessions, ...); batcher kwargs (max_batch, max_wait_ms,
    max_pending, deadline_ms, cache_mb, warm_every, ...) pass to the
    MultiVoiceBatchingServer. The `batch` attribute exposes the full
    batch-side API (submit/submit_durations/submit_forced/metrics/...);
    the submit* methods here are conveniences over it.
    """

    def __init__(self, runtimes: Dict[str, PiperRuntime], *,
                 stream_kwargs: Optional[dict] = None,
                 stream_group_frac: float = 0.25,
                 **batcher_kwargs):
        """`stream_group_frac` (0 < f <= 1): while ANY stream is open,
        batch groups pop at this fraction of their normal size. A waiting
        stream's next window (and a new stream's head, its TTFB) sits
        behind the in-flight batch group's remaining work, so smaller
        groups trade batch-group granularity for stream latency. The
        default 0.25 snaps to the prewarmed mid rung (no new shapes); 1.0
        keeps full-size groups while streams are open."""
        if not 0.0 < stream_group_frac <= 1.0:
            raise ValueError("stream_group_frac must be in (0, 1]")
        self._stream_group_frac = float(stream_group_frac)
        self._cond = _WakeCondition()
        self._stream_kwargs = dict(stream_kwargs or {})
        self._stream_kwargs.setdefault("tick_wait_s", 0.002)
        self._tick_wait = float(self._stream_kwargs["tick_wait_s"])
        self.batch = MultiVoiceBatchingServer(
            runtimes, cond=self._cond, start_worker=False, **batcher_kwargs)
        self._streams: Dict[str, StreamingServer] = {
            key: self._make_stream(rt) for key, rt in runtimes.items()}
        # Streams of removed voices: kept ticking until their open sessions
        # drain (graceful removal), then dropped. _close_on_drain maps
        # id(stream server) -> runtime to close() at that point
        # (remove_voice(close_runtime=True)).
        self._draining: List[StreamingServer] = []
        self._close_on_drain: Dict[int, PiperRuntime] = {}
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="piper-unified-server", daemon=True)
        self._worker.start()

    def _make_stream(self, rt: PiperRuntime) -> StreamingServer:
        return StreamingServer(rt, start_worker=False, on_submit=self._wake,
                               **self._stream_kwargs)

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    # -- client surface ------------------------------------------------------

    @property
    def voices(self) -> List[str]:
        return self.batch.voices

    def submit(self, voice: str, phoneme_ids, **kwargs):
        return self.batch.submit(voice, phoneme_ids, **kwargs)

    def submit_durations(self, voice: str, phoneme_ids, **kwargs):
        return self.batch.submit_durations(voice, phoneme_ids, **kwargs)

    def submit_forced(self, voice: str, phoneme_ids, durations, **kwargs):
        return self.batch.submit_forced(voice, phoneme_ids, durations, **kwargs)

    def submit_stream(self, voice: str, phoneme_ids, **kwargs):
        """Open a low-latency stream on `voice`; returns the iterable
        chunk handle (see StreamingServer.submit). Streams of different
        voices tick independently (distinct weights can't share a batched
        window); streams of the SAME voice batch their windows."""
        if self._closed:
            raise RuntimeError("server is closed")
        with self._cond:
            ss = self._streams.get(voice)
        if ss is None:
            raise KeyError(f"unknown voice {voice!r}")
        return ss.submit(phoneme_ids, **kwargs)

    def add_voice(self, key: str, runtime: PiperRuntime, *,
                  prewarm: bool = True, stream_prewarm: bool = True,
                  stream_prewarm_kwargs: Optional[dict] = None,
                  **prewarm_kwargs):
        """Register a new voice WITHOUT pausing resident voices or live
        streams: batch-grid warm steps (and, with stream_prewarm, the
        streaming grid's) interleave with traffic at one-shape
        granularity (MultiVoiceBatchingServer.add_voice). The voice accepts
        batch submits immediately and stream submits as soon as this method
        returns; pre-warm traffic may pay its shape's first-run costs
        inline. Returns the prewarm-stats Future."""
        ss = self._make_stream(runtime)
        with self._cond:
            # Duplicate keys must fail HERE, before the stream registry is
            # touched: registering first and letting the batch worker
            # reject the duplicate would clobber the resident voice's
            # StreamingServer (its open sessions would never tick again).
            if self._closed:
                raise RuntimeError("server is closed")
            if key in self._streams:
                raise ValueError(f"voice {key!r} already loaded")
            self._streams[key] = ss
        if prewarm and stream_prewarm:
            prewarm_kwargs = dict(prewarm_kwargs)
            prewarm_kwargs["extra_warm_steps"] = ss.prewarm_steps(
                **(stream_prewarm_kwargs or {}))
        try:
            return self.batch.add_voice(key, runtime, prewarm=prewarm, **prewarm_kwargs)
        except BaseException:
            with self._cond:
                if self._streams.get(key) is ss:
                    del self._streams[key]
            raise

    def remove_voice(self, key: str, *, close_runtime: bool = False):
        """Unload a voice: queued batch requests fail (see
        MultiVoiceBatchingServer.remove_voice), new batch/stream submits
        raise, and OPEN streams finish gracefully (their sessions keep
        ticking until drained). Returns the batch-side Future.

        `close_runtime=True` additionally calls PiperRuntime.close() —
        releasing the voice's weights from the device — once its last open
        stream drains (on the worker thread; the batch side's removal
        control op has run by then). Leave False when the caller still
        owns the runtime for other use (the default matches
        MultiVoiceBatchingServer, which never closes caller runtimes)."""
        with self._cond:
            ss = self._streams.pop(key, None)
            if ss is not None:
                ss.stop_accepting()  # rejects new submits; open sessions drain
                self._draining.append(ss)
                if close_runtime:
                    self._close_on_drain[id(ss)] = ss.rt
        # Every registered voice has a stream server (made at __init__ or
        # add_voice), so ss is None only for unknown keys — the batch-side
        # future then carries the KeyError.
        return self.batch.remove_voice(key)

    @staticmethod
    def _counted_steps(steps, counter: dict):
        """Wrap warm steps so completed stream shapes are tallied
        separately from the batch grid's (prewarm's return splits them)."""
        for kind, fn in steps:
            def step(fn=fn, kind=kind):
                t0 = time.perf_counter()
                fn()
                counter["seconds"] += time.perf_counter() - t0
                if kind == "program":
                    counter["programs"] += 1
            yield (kind, step)

    def prewarm(self, stream: bool = True, stream_kwargs: Optional[dict] = None,
                **kwargs) -> dict:
        """Run every voice's batch grid (+ streaming grid when `stream`)
        ahead of traffic. Runs ON the worker thread as paced warm steps
        (the scheduler add_voice uses), so the one-thread device rule is
        code, not calling convention: submits landing mid-prewarm are
        served between steps. Blocks until every voice is warm; returns
        {"batch": {voice: stats}, "stream": {voice: stats}}."""
        futs, counters = {}, {}
        for key, ss in self._snapshot_streams().items():
            counter = {"programs": 0, "seconds": 0.0}
            extra = (self._counted_steps(ss.prewarm_steps(**(stream_kwargs or {})), counter)
                     if stream else None)
            counters[key] = counter
            futs[key] = self.batch.warm_voice(key, extra_warm_steps=extra, **kwargs)
        out = {"batch": {}, "stream": {}}
        for key, fut in futs.items():
            stats = dict(fut.result())
            sc = counters[key]
            if stream:
                stats["programs"] -= sc["programs"]
                stats["seconds"] = max(0.0, stats["seconds"] - sc["seconds"])
                out["stream"][key] = dict(sc)
            out["batch"][key] = stats
        if not stream:
            out.pop("stream")
        return out

    def metrics(self) -> dict:
        """{"batch": per-voice batcher metrics, "stream": per-voice
        streaming metrics, "warming": add_voice progress}."""
        return {"batch": self.batch.metrics(),
                "stream": {k: ss.metrics() for k, ss in self._snapshot_streams().items()},
                "warming": self.batch.warming()}

    def warming(self) -> dict:
        return self.batch.warming()

    def ready(self) -> bool:
        """Readiness (vs liveness): False while any voice's grid is still
        warming or a voice load/unload is queued — the server SERVES in
        that state, but requests landing on unwarmed shapes pay their
        first-run costs."""
        return self.batch.ready()

    def reset_metrics(self) -> None:
        self.batch.reset_metrics()

    # -- worker ----------------------------------------------------------

    def _snapshot_streams(self) -> Dict[str, StreamingServer]:
        with self._cond:
            return dict(self._streams)

    def _tick_streams(self) -> tuple:
        """One tick for every stream server with pending work. Returns
        (did_work, still_pending): did_work False means every tick was a
        no-op (sessions exist but are e.g. blocked on consumers)."""
        with self._cond:
            servers = list(self._streams.values()) + self._draining
            # Drop drained removed-voice servers (no sessions left).
            done = [ss for ss in self._draining if not ss.pending()]
            self._draining = [ss for ss in self._draining if ss.pending()]
            to_close = [rt for ss in done
                        if (rt := self._close_on_drain.pop(id(ss), None)) is not None]
        for rt in to_close:
            # remove_voice(close_runtime=True): release the voice's weights
            # now that its last stream drained. On the worker thread — the
            # device-driving thread — so the release comes after every call
            # this thread queued for the voice.
            rt.close()
        did = pend = False
        for ss in servers:
            if ss.pending():
                did = ss.tick() or did
                pend = pend or ss.pending()
        return did, pend

    def _run(self) -> None:
        self.batch.begin_drive()
        try:
            self._run_impl()
        except BaseException as e:  # noqa: BLE001 — fail open, never hang
            self.batch.fail_worker(e)
            for ss in list(self._snapshot_streams().values()) + self._draining:
                ss.fail_all(e)
            raise

    def _apply_group_scale(self) -> None:
        """Shrink batch groups while streams are open (stream_group_frac);
        restore full batching when the last stream closes. Worker thread
        only; scale changes affect future pops, in-flight groups finish."""
        if self._stream_group_frac >= 1.0:
            return
        with self._cond:
            streams = list(self._streams.values()) + self._draining
            active = any(ss.open_sessions for ss in streams)
        self.batch.set_group_scale(self._stream_group_frac if active else 1.0)

    def _run_impl(self) -> None:
        pending = None
        while True:
            with self._cond:
                gen0 = self._cond.gen
            self._apply_group_scale()
            s_did, s_pend = self._tick_streams()
            pending, status = self.batch.serve_step(pending, block=False, ripe_only=True)
            if status == "shutdown":
                self._drain_streams()
                return
            if status == "served" or s_did:
                continue
            # Nothing did device work this round: sleep until a submit
            # (either kind) or the oldest batch group's window elapses.
            timeout = self.batch.wait_hint if status == "wait" else None
            if s_pend:
                # Sessions exist but are blocked on consumers: poll at the
                # stream cadence so a drained chunk queue resumes quickly.
                timeout = min(timeout or self._tick_wait, self._tick_wait)
            with self._cond:
                # A producer that notified while we were mid-pass bumped
                # the generation: rerun the pass instead of sleeping
                # through it. Unripe batch queues and consumer-blocked
                # streams do NOT bump it, so the timed waits above actually
                # sleep.
                if self._closed or self._cond.gen != gen0:
                    continue
                self._cond.wait(timeout=timeout if timeout is not None else 1.0)

    def _drain_streams(self, grace_s: float = 30.0) -> None:
        """The batch side shut down (close() was called and its queues
        drained): finish every open stream's remaining windows. Bounded:
        sessions whose consumers never drain are FAILED after `grace_s`
        rather than keeping this worker ticking forever."""
        deadline = time.monotonic() + grace_s
        servers: list = []
        while time.monotonic() < deadline:
            with self._cond:
                servers = list(self._streams.values()) + self._draining
            if not any(ss.pending() for ss in servers):
                break
            if not any(ss.tick() for ss in servers if ss.pending()):
                time.sleep(self._tick_wait)
        for ss in servers:
            ss.drain()
            if ss.pending():
                ss.fail_all(RuntimeError("UnifiedServer shut down with undrained sessions"))

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            # _cond is re-entrant (threading.Condition's default RLock),
            # so the nested notify inside stop_accepting is safe here.
            self.batch.stop_accepting()
            for ss in list(self._streams.values()) + self._draining:
                ss.stop_accepting()
            self._cond.notify_all()
        self._worker.join(timeout=600)
        # Defense for a worker that died or timed out: abandon leftover
        # warms and strand no stream consumer (idempotent either way).
        self.batch.cancel_all_warming("server closed")
        err = RuntimeError("UnifiedServer is shut down")
        for ss in list(self._snapshot_streams().values()) + self._draining:
            ss.fail_all(err)
        # Pending close_runtime removals whose streams never drained:
        # their consumers just failed, so release the weights now.
        with self._cond:
            leftovers, self._close_on_drain = list(self._close_on_drain.values()), {}
        for rt in leftovers:
            rt.close()
        if self._worker.is_alive():
            # A leaked device-driving thread must never be silent.
            raise RuntimeError("UnifiedServer worker did not exit within 600s; thread leaked")

    def __enter__(self) -> "UnifiedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
