"""Continuous batching: group concurrent requests into batched device calls
(the port of piper_tpu.engine.batcher: the same classes, names, signatures
and defaults, over the port's PiperRuntime).

The classic TTS serving shape: requests queue per (scales, phoneme-bucket)
key, and the single worker serves the queue holding the OLDEST waiting
request as ONE batched synthesis — so mixed-length traffic forms large
same-bucket batches instead of padding every short prompt to the longest
paragraph in its arrival window, and oldest-first across queues keeps it
fair and starvation-free. On a fused-mode runtime each group runs the
whole-group fused dispatch (PiperRuntime.dispatch_batch(fused=True)): no
host read between encode and decode, one copy of the audio and frame
counts, rows and frame budget pinned to a grid of at most three row rungs
per phoneme bucket.

Serving is depth-2 pipelined on the one worker: group i's audio copy
overlaps group i+1's collect + dispatch, and a pending fetch completes
immediately when no further work is queued, so idle-traffic latency is
unchanged. Complements ServingPipeline (which overlaps single-utterance
fused calls): batching wins on throughput, the pipeline on tail latency for
sparse traffic.

Every device call goes through the runtime's own methods, each of which
runs under the runtime's lock, torch.inference_mode (per thread: the worker
is not the thread that built the runtime) and its precision tiers; the
worker never moves work to the CPU, and a group whose dispatch or fetch
fails fails its requests' futures.

Spans (utils/profiling.py, each also a row of the runtime's profiler, or
of the process-wide one for a stub runtime): `batcher.group` around a
group's whole dispatch (its rows, padded rows and oldest row's wait),
`batcher.dispatch` around the runtime's call, `batcher.fetch` around the
fetch, under the group's batch id. `metrics()` counts `overflow_rows`, the
rows a fused group redid at fetch because their durations overflowed its
frame budget, and `overflow_split_rows`, those a blocking split call redid.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
from piper_tpu_torch.engine.bucketing import BucketOverflowError, bucket_for
from piper_tpu_torch.engine.runtime import PiperRuntime, validate_scales, validate_speaker_mix
from piper_tpu_torch.utils import profiling


def _deliver(fut: "Future", result=None,
             exc: "BaseException | None" = None) -> None:
    """Resolve a future, tolerating a caller cancel() racing the worker:
    a pre-check (`if not fut.done()`) is a TOCTOU — cancel() landing
    between check and set_result raises InvalidStateError inside the
    worker's resolution loop, and the enclosing except would then fail
    every OTHER request co-batched in the same group."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass  # cancelled/raced — the value is discarded by agreement


class ServerOverloaded(RuntimeError):
    """Raised by submit() when the pending-request cap is reached: the
    caller should back off / retry elsewhere (the 503 of this API).
    Admitted requests keep bounded latency instead of everyone queueing
    into double-digit seconds."""


class DeadlineExceeded(RuntimeError):
    """Set on a request's future when it waited longer than the server's
    deadline before dispatch — shed so fresher requests stay useful."""


@dataclass
class _Request:
    ids: List[int]
    scales: Tuple[Optional[float], Optional[float], Optional[float]]
    speaker_id: Optional[int]
    future: "Future[np.ndarray]"
    t_submit: float = field(default_factory=time.perf_counter)
    # "synth" -> future resolves to audio; "dur" -> to the per-phoneme frame
    # durations (the alignment plan; encoder-only, no vocoder FLOPs);
    # "forced" -> audio from a caller-supplied duration plan.
    kind: str = "synth"
    durations: Optional[List[int]] = None
    # set by submit when the response cache is on: where to store the result
    cache_key: Optional[tuple] = None
    # Speaker blending weights {id: w} (PiperRuntime speaker_mix). Mix
    # requests queue SEPARATELY from integer-sid requests (the queue key
    # carries a mix flag): a (B, n_speakers) conditioning array is a
    # distinct run key (another shape of the speaker input), and mixing the
    # two in one group would route plain-id traffic through the unprewarmed
    # mix variant.
    speaker_mix: Optional[dict] = None

    def __post_init__(self):
        # Defensive copy (ids/durations are copied at submit): the request
        # sits queued past submit(), and a caller mutating its dict would
        # corrupt conditioning — or fail the WHOLE co-batched group at
        # dispatch-time validation.
        if self.speaker_mix is not None:
            self.speaker_mix = dict(self.speaker_mix)


class BatchingServer:
    """Length-bucketed continuous batcher on a single worker thread.

    Requests wait at most `max_wait_ms` for same-bucket company (the window
    only delays a request while its batch is not yet full AND the device is
    idle; under load the previous group's service time is the window)."""

    def __init__(self, runtime: PiperRuntime, max_batch: int = 16,
                 max_wait_ms: float = 5.0, max_rows: int = 128,
                 fused: Optional[bool] = None,
                 max_pending: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 cond: Optional[threading.Condition] = None,
                 start_worker: bool = True,
                 cache_mb: float = 0.0):
        """`max_batch` is the group row count at the 128-phoneme bucket; via
        the phoneme budget below, shorter buckets form proportionally WIDER
        groups, up to `max_rows` rows. Callers sizing for device memory or
        per-group latency should set `max_rows` (the hard row cap),
        not `max_batch`.

        `fused` selects the fused group dispatch
        (dispatch_batch(fused=True)): the per-row frame counts ride the same
        copy as the audio, so no host read waits for the device between
        encode and decode and the worker can queue the next group while the
        card works. Default: on when the runtime's mode is "fused". Overflow
        rows (durations beyond the budget bucket) are redone at fetch.

        Admission control: `max_pending` bounds the total queued (not yet
        dispatched) requests — submit() raises ServerOverloaded beyond it,
        so overload degrades by shedding at the door instead of unbounded
        queue latency for everyone. `deadline_ms` additionally sheds queued
        requests that waited longer than this before dispatch (their future
        gets DeadlineExceeded). Both default off (None).

        Grid discipline (fused mode): each fused group pads its rows to
        one of at most THREE rungs per phoneme bucket — a small rung
        (sparse traffic), a mid rung, and the bucket's full group limit —
        with the frame budget pinned to the phoneme bucket. On the card a
        (rows, frames) shape seen for the first time pays cuDNN's
        algorithm choice and the caching allocator's growth (PERF.md
        records the cost), and CUDA graphs would need one capture per
        shape, so the shapes stay a bounded grid. Call `prewarm()` after
        construction to run the whole grid up front.

        `cache_mb` (> 0 to enable) bounds an in-memory response cache:
        synthesis here is DETERMINISTIC (seeded noise derived per row from
        the runtime seed and shapes), so identical requests — the
        canned-phrase traffic real TTS deployments see constantly — can be
        served from memory in microseconds instead of device time. Entries
        are read-only arrays evicted LRU by byte size; hits/bytes appear
        in metrics(). Audio ("synth"/"forced") and durations results are
        cached; keys carry ids, scales, conditioning, and plan.

        `cond` / `start_worker` exist for MultiVoiceBatchingServer, which
        multiplexes several per-voice servers onto ONE worker thread (all
        device work stays serial on one thread: the precision tiers are
        process-wide flags, and one stream orders every group's work): the
        per-voice servers share one Condition and skip their own worker."""
        self.rt = runtime
        self.max_batch = max_batch
        self.max_rows = max_rows
        # Dynamic group-size scale in (0, 1]: UnifiedServer lowers it while
        # streams are open so batch groups occupy the device in shorter
        # slices (a waiting stream head's TTFB floor is the in-flight
        # group's remaining device time). 0.25 aligns with the prewarmed
        # mid rung (_rungs includes limit//4), so no new shapes run.
        self.group_scale = 1.0
        self.fused = (runtime.options.mode == "fused") if fused is None else fused
        self.max_pending = max_pending
        self.deadline_s = deadline_ms / 1e3 if deadline_ms is not None else None
        self._fpp: Optional[float] = None  # calibrated frames/phoneme
        self._pending = 0
        self._metrics = {
            "submitted": 0, "completed": 0, "failed": 0,
            "shed_overload": 0, "shed_deadline": 0,
            "groups": 0, "rows": 0, "padded_rows": 0,
            "wait_ms_sum": 0.0, "wait_ms_max": 0.0,
            "cache_hits": 0, "cache_bytes": 0,
            "overflow_rows": 0, "overflow_split_rows": 0,
        }
        # The runtime's profiler takes the batcher's spans (rows
        # batcher.group/dispatch/fetch); a stub runtime's go to the
        # process-wide one.
        self._prof = getattr(runtime, "profiler", None) or profiling.PROCESS
        # Response cache: key -> read-only np.ndarray, LRU by insertion
        # order (dict move_to_end semantics via re-insert), byte-bounded.
        self.cache_bytes_max = int(cache_mb * (1 << 20))
        self._cache: "dict[tuple, np.ndarray]" = {}
        self._cache_bytes = 0
        # Group size scales INVERSELY with utterance length via a phoneme
        # budget: `max_batch` rows of a 128-phoneme request and up to
        # `max_rows` rows of short prompts cost similar compute, while
        # per-group overhead (host work + kernel launches) is fixed —
        # short-prompt traffic at a flat row cap is overhead-bound.
        self.phoneme_budget = max_batch * 128
        self.max_wait_s = max_wait_ms / 1e3
        # (scales, p_bucket) -> FIFO of requests. p_bucket is the phoneme
        # bucket (requests beyond the ladder get key "overflow" and fail on
        # their own future at dispatch).
        self._queues: Dict[tuple, deque] = {}
        self._cond = cond if cond is not None else threading.Condition()
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        if start_worker:
            self._worker = threading.Thread(target=self._serve_loop,
                                            name="piper-batch-server",
                                            daemon=True)
            self._worker.start()

    def submit(
        self,
        phoneme_ids: Sequence[int],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ) -> "Future[np.ndarray]":
        if self._closed:
            raise RuntimeError("server is closed")
        ids, p_bucket = self._validate_request(
            phoneme_ids, speaker_id, speaker_mix,
            scales=(noise_scale, length_scale, noise_w))
        fut: "Future[np.ndarray]" = Future()
        req = _Request(ids, (noise_scale, length_scale, noise_w),
                       speaker_id, fut, speaker_mix=speaker_mix)
        return self._cached_or_enqueue(req, p_bucket)

    def _validate_request(self, phoneme_ids: Sequence[int],
                          speaker_id: Optional[int],
                          speaker_mix: Optional[dict] = None,
                          scales: Optional[tuple] = None):
        """Validate up front so one bad request can't fail a whole group
        (shared by submit and submit_durations). Returns (ids, p_bucket);
        beyond-ladder lengths get the 'overflow' bucket and fail on their
        own future at dispatch."""
        if scales is not None and any(v is not None for v in scales):
            # Synchronous door check (HTTP 400, not an async 500): groups
            # key on scales, so a bad value would fail at dispatch. Config
            # defaults are presumed valid (getattr: stub-runtime tests).
            inf = getattr(getattr(self.rt, "config", None), "inference",
                          None)
            ns, ls, nw = ((inf.noise_scale, inf.length_scale, inf.noise_w)
                          if inf is not None else (0.667, 1.0, 0.8))
            validate_scales(
                ns if scales[0] is None else float(scales[0]),
                ls if scales[1] is None else float(scales[1]),
                nw if scales[2] is None else float(scales[2]))
        ids = list(phoneme_ids)
        if not ids:
            raise ValueError("empty phoneme sequence")
        bad = [i for i in ids if not (0 <= i < self.rt.hparams.n_vocab)]
        if bad:
            raise ValueError(
                f"phoneme id(s) {bad[:5]} out of range [0, {self.rt.hparams.n_vocab})"
            )
        n_spk = getattr(self.rt.hparams, "n_speakers", None)
        if speaker_id is not None and n_spk is not None and not (
                0 <= speaker_id < max(1, n_spk)):
            # An out-of-range index on the card is a device-side assert
            # that ends the process's CUDA context; refuse it here.
            raise ValueError(
                f"speaker_id {speaker_id} out of range [0, {max(1, n_spk)})")
        if speaker_mix is not None:
            # Validate at the door so one bad mix can't fail its whole
            # group at dispatch (the runtime re-validates, but then the
            # error lands on every co-batched future).
            validate_speaker_mix(speaker_mix, n_spk or 1,
                                 speaker_id=speaker_id)
        return ids, self._p_bucket(len(ids))

    def _p_bucket(self, n: int):
        """The phoneme bucket of n ids: the queue key's, 'overflow' past
        the ladder."""
        try:
            return bucket_for(n, self.rt.options.phoneme_buckets, "phoneme")
        except BucketOverflowError:
            return "overflow"

    def submit_durations(
        self,
        phoneme_ids: Sequence[int],
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ) -> "Future[np.ndarray]":
        """Queue a phoneme-durations (alignment) request; the future resolves
        to the per-phoneme frame durations (int64, one per input id).

        Served on the SAME worker thread as synthesis (device discipline),
        batched with other duration requests of the same bucket. The plan is
        the one a synthesis of the same (ids, scales, speaker) through this
        server realizes — the runtime's seeded noise is per-row derived, so
        grouping does not change it (PiperRuntime.phoneme_durations)."""
        if self._closed:
            raise RuntimeError("server is closed")
        ids, p_bucket = self._validate_request(
            phoneme_ids, speaker_id, speaker_mix,
            scales=(None, length_scale, noise_w))
        fut: "Future[np.ndarray]" = Future()
        req = _Request(ids, (None, length_scale, noise_w), speaker_id, fut,
                       kind="dur", speaker_mix=speaker_mix)
        return self._cached_or_enqueue(req, p_bucket)

    def submit_forced(
        self,
        phoneme_ids: Sequence[int],
        durations: Sequence[int],
        noise_scale: Optional[float] = None,
        speaker_id: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ) -> "Future[np.ndarray]":
        """Queue a duration-forced synthesis (see
        PiperRuntime.synthesize_forced): the caller's per-phoneme frame plan
        replaces the duration predictor. Served on the SAME worker thread,
        batched with other forced requests of the same (scales, bucket).

        Forced groups dispatch synchronously (the forced path has no host
        read before its copy — there is no dispatch/fetch split to
        pipeline). Rows pin
        to the fused grid's <=3 rungs per phoneme bucket; the frame axis
        varies with the plans' totals, bounded by the frame-bucket ladder."""
        if self._closed:
            raise RuntimeError("server is closed")
        ids, p_bucket = self._validate_request(
            phoneme_ids, speaker_id, speaker_mix,
            scales=(noise_scale, None, None))
        durs = [int(d) for d in durations]
        if len(durs) != len(ids):
            raise ValueError(
                f"durations length {len(durs)} != phoneme count {len(ids)}")
        if any(d < 0 for d in durs):
            raise ValueError("durations must be non-negative frame counts")
        if sum(durs) < 1:
            raise ValueError("at least one phoneme needs a non-zero duration")
        fut: "Future[np.ndarray]" = Future()
        req = _Request(ids, (noise_scale, None, None), speaker_id, fut,
                       kind="forced", durations=durs, speaker_mix=speaker_mix)
        return self._cached_or_enqueue(req, p_bucket)

    def _enqueue(self, req: _Request, p_bucket) -> "Future[np.ndarray]":
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            if (self.max_pending is not None
                    and self._pending >= self.max_pending):
                self._metrics["shed_overload"] += 1
                raise ServerOverloaded(
                    f"{self._pending} requests pending (cap {self.max_pending})"
                )
            self._metrics["submitted"] += 1
            self._pending += 1
            key = (req.scales, p_bucket, req.kind,
                   req.speaker_mix is not None)
            self._queues.setdefault(key, deque()).append(req)
            self._cond.notify()
        return req.future

    # -- response cache ---------------------------------------------------

    def _cache_key(self, req: _Request) -> tuple:
        mix = (tuple(sorted((int(k), float(v))
                            for k, v in req.speaker_mix.items()))
               if req.speaker_mix is not None else None)
        durs = tuple(req.durations) if req.durations is not None else None
        return (req.kind, tuple(req.ids), req.scales, req.speaker_id, mix,
                durs)

    def _cache_get(self, key: tuple):
        with self._cond:
            val = self._cache.pop(key, None)
            if val is None:
                return None
            self._cache[key] = val  # re-insert = LRU bump (dicts are ordered)
            self._metrics["cache_hits"] += 1
            return val

    def _cache_put(self, key: tuple, value: np.ndarray) -> None:
        value = np.asarray(value).copy()
        value.setflags(write=False)  # shared across future hits
        if value.nbytes > self.cache_bytes_max:
            return
        with self._cond:
            old = self._cache.pop(key, None)
            if old is not None:
                self._cache_bytes -= old.nbytes
            self._cache[key] = value
            self._cache_bytes += value.nbytes
            while self._cache_bytes > self.cache_bytes_max and self._cache:
                oldest = next(iter(self._cache))
                self._cache_bytes -= self._cache.pop(oldest).nbytes

    def _cached_or_enqueue(self, req: _Request, p_bucket):
        """Serve from the response cache when enabled and hit; otherwise
        tag the request for store-on-completion and enqueue it."""
        if self.cache_bytes_max and isinstance(p_bucket, int):
            key = self._cache_key(req)
            hit = self._cache_get(key)
            if hit is not None:
                req.future.set_result(hit)
                with self._cond:
                    self._metrics["submitted"] += 1
                    self._metrics["completed"] += 1
                return req.future
            req.cache_key = key
        return self._enqueue(req, p_bucket)

    def _finish_value(self, r: _Request, value) -> None:
        """Deliver a successful result, storing it in the response cache
        when the request was tagged at submit."""
        if r.cache_key is not None:
            self._cache_put(r.cache_key, value)
        _deliver(r.future, value)

    def metrics(self) -> dict:
        """Snapshot of serving counters: queue depth, shed counts, dispatch
        wait stats, achieved grouping (rows per group, batch-ladder padding),
        overflow redos (rows, and those redone in split mode), response-cache
        hits and resident bytes."""
        with self._cond:
            m = dict(self._metrics)
            m["queue_depth"] = self._pending
            m["cache_bytes"] = self._cache_bytes
        # Resident weight bytes (0 once the runtime is closed) — lets
        # operators budget loaded voices against the card's memory. getattr:
        # tests drive this scheduler with stub runtimes.
        hbm = getattr(self.rt, "hbm_bytes", None)
        m["hbm_bytes"] = int(hbm()) if callable(hbm) else 0
        m["wait_ms_mean"] = (m.pop("wait_ms_sum") / m["rows"]) if m["rows"] else 0.0
        m["rows_per_group"] = (m["rows"] / m["groups"]) if m["groups"] else 0.0
        return m

    def reset_metrics(self) -> None:
        """Zero the serving counters (queue depth is live state and is not
        touched). Measurement passes that share one server — e.g. a rate
        sweep after a warmup — call this so each pass reports only itself."""
        with self._cond:
            self._metrics = {k: type(v)() for k, v in self._metrics.items()}

    # -- scheduling ----------------------------------------------------------

    def _oldest_key(self):
        """Key of the queue whose head request has waited longest."""
        best, best_t = None, None
        for k, q in self._queues.items():
            if q and (best_t is None or q[0].t_submit < best_t):
                best, best_t = k, q[0].t_submit
        return best

    def _group_limit(self, key) -> int:
        bucket = key[1]
        if not isinstance(bucket, int):
            return 1  # overflow requests fail individually
        if len(key) > 2 and key[2] == "dur":
            # Durations groups are capped at (and padded to) ONE pinned rung
            # so each phoneme bucket serves alignment from a single encode
            # shape — a traffic-dependent row count would meet new shapes
            # mid-serve.
            return self._dur_rows(bucket)
        # Scale the CLAMPED limit, not the budget: when max_rows is the
        # binding constraint (short buckets), scaling the budget alone
        # yields e.g. 64 from a 128-row limit whose rung ladder is
        # {8, 32, 128} — a 33..64-row pop would pad to the FULL rung,
        # halving batch throughput without helping stream latency. And
        # snap the scaled limit DOWN to the rung ladder:
        # pops pad UP to a rung, so any scaled limit strictly between
        # rungs (e.g. 0.5 -> 64 on a {8, 32, 128} ladder) re-pads to the
        # FULL rung — the exact inefficiency group_scale exists to avoid.
        # Below the smallest rung, the smallest rung: capping rows under
        # the padded size wastes rows without shrinking device time.
        limit = self._group_limit_unscaled(key)
        if self.group_scale < 1.0:
            scaled = max(1, int(limit * self.group_scale))
            rungs = self._rungs(bucket)
            limit = max([r for r in rungs if r <= scaled] or [rungs[0]])
        return limit

    def _group_limit_unscaled(self, key) -> int:
        """The bucket's FULL group limit, ignoring group_scale — the rung
        ladder and frame budgets derive from this so the shape grid is
        identical whatever scale the scheduler is running at."""
        bucket = key[1]
        if not isinstance(bucket, int):
            return 1
        if len(key) > 2 and key[2] == "dur":
            return self._dur_rows(bucket)
        return max(1, min(self.max_rows, self.phoneme_budget // bucket))

    def _dur_rows(self, p_bucket: int) -> int:
        """The one padded row count durations groups of this bucket use.
        Encoder rows are cheap (no vocoder FLOPs), so a small fixed rung
        wastes little; mesh runtimes snap it up to a dp multiple."""
        rows = max(1, min(16, self.max_rows,
                          self.phoneme_budget // p_bucket))
        if getattr(self.rt, "mesh", None) is not None:
            ladder = getattr(self.rt, "batch_ladder", None) or ()
            dp = ladder[0] if ladder else 1
            rows = -(-rows // dp) * dp
        return rows

    def _rungs(self, p_bucket: int):
        """The padded-row counts groups of this bucket may use: a small
        rung (sparse traffic), a mid rung, and the bucket's full group
        limit — the whole shape grid is n_buckets x <=3."""
        limit = self._group_limit_unscaled(((), p_bucket))
        cand = sorted({min(8, limit), max(1, limit // 4), limit})
        # Only mesh runtimes need ladder-snapped rungs (dp divisibility);
        # single-device fused groups take exact row counts, and snapping a
        # e.g. 24-row limit up to 32 would pay permanent dummy-row compute
        # on every full group.
        if getattr(self.rt, "mesh", None) is not None:
            ladder = getattr(self.rt, "batch_ladder", None) or ()
            dp = ladder[0] if ladder else 1  # ladder[0] == dp size
            # Snap each candidate UP: to the first ladder rung >= it, or —
            # when it exceeds the ladder — to the next dp-multiple. Falling
            # back to ladder[-1] (DOWN) would make pad_rows_to smaller than
            # a full group and fail every large dispatch.
            cand = sorted({next((x for x in ladder if x >= c),
                                -(-c // dp) * dp)
                           for c in cand})
        return tuple(cand)

    def _pad_rows_for(self, p_bucket: int, group_size: int) -> int:
        rungs = self._rungs(p_bucket)
        return next((r for r in rungs if r >= group_size), rungs[-1])

    def _budget_frames(self, p_bucket: int) -> int:
        """Frame budget for this bucket's grid programs: calibrated
        frames-per-phoneme x bucket, or the runtime's heuristic (+25% tail
        margin: a full-length row at the typical ratio would otherwise sit
        right at the budget and overflow on every longer-than-average
        utterance)."""
        fpp = self._fpp or self.rt.options.fused_frames_per_phoneme
        return max(32, int(p_bucket * fpp * 1.25))

    def calibrate(self, sample_phonemes: int = 64) -> float:
        """Measure this voice's frames-per-phoneme from one synthesis and
        pin the grid's frame budgets to it. Real voices run ~6 frames per
        phoneme, synthetic ones ~1.4 — a fixed heuristic either overflows
        (redo storms) or wastes multiples of decode compute."""
        base = list(FIXTURE_PHONEME_IDS)
        base = [i % self.rt.hparams.n_vocab for i in base]
        ids = (base * (-(-sample_phonemes // len(base))))[:sample_phonemes]
        audio = self.rt.synthesize(ids)
        frames = len(audio) / self.rt.hparams.hop_length
        self._fpp = max(0.5, frames / len(ids))
        return self._fpp

    def prewarm(self, p_buckets: Optional[Sequence[int]] = None,
                scales: Sequence[tuple] = ((None, None, None),),
                calibrate: bool = True,
                speaker_mix_programs: bool = False) -> dict:
        """Run the server's whole fused shape grid ahead of traffic:
        calibrate the voice's frames-per-phoneme, then run one dummy group
        through the exact dispatch path for each (phoneme bucket, row rung).
        Returns {"programs": n, "seconds": wall, "frames_per_phoneme": fpp}.
        Only meaningful in fused mode (split mode's decode bucket tracks
        real durations).

        `speaker_mix_programs` additionally warms the speaker-BLENDING
        variant at every grid point (mix requests queue and run separately
        from integer-sid ones). Off by default: it grows the
        grid ~50% on multi-speaker voices, so opt in only on deployments
        that actually take speaker_mix traffic."""
        t0 = time.perf_counter()
        n = 0
        for kind, step in self.prewarm_steps(
                p_buckets=p_buckets, scales=scales, calibrate=calibrate,
                speaker_mix_programs=speaker_mix_programs):
            step()
            if kind == "program":
                n += 1
        return {"programs": n, "seconds": time.perf_counter() - t0,
                "frames_per_phoneme": self._fpp}

    def prewarm_steps(self, p_buckets: Optional[Sequence[int]] = None,
                      scales: Sequence[tuple] = ((None, None, None),),
                      calibrate: bool = True,
                      speaker_mix_programs: bool = False):
        """The grid warm as a lazy sequence of ("calibrate"|"program",
        zero-arg callable) steps; running every step in order equals
        prewarm(). Callers MUST invoke each yielded step before advancing
        the generator (later steps' frame budgets read the calibrated
        frames-per-phoneme).

        This granularity is what makes add_voice non-pausing on a live
        MultiVoiceBatchingServer: the worker interleaves ONE warm step
        (one group's work at one grid shape) between traffic groups instead of freezing every resident
        voice for the whole grid."""
        if calibrate and self._fpp is None:
            yield ("calibrate", self.calibrate)
        if p_buckets is None:
            p_buckets = [b for b in self.rt.options.phoneme_buckets
                         if b <= 256]
        base = list(FIXTURE_PHONEME_IDS)
        base = [i % self.rt.hparams.n_vocab for i in base]
        # Multi-speaker voices run DISTINCT keys for sid-absent,
        # sid-present, and (opt-in) mix-present groups (the run key carries
        # the conditioning kind), and real traffic produces each — prewarm
        # every variant in use or the first such group pays its first-run
        # costs in traffic. Variants are (speaker_ids, speaker_mixes) argument
        # pairs for one prewarm row.
        if self.rt.hparams.n_speakers > 1:
            variants = [(None, None), ([0], None)]
            if speaker_mix_programs:
                variants.append((None, [{0: 1.0}]))
        else:
            variants = [(None, None)]

        def warm_fused(ids, rung, budget, ns, ls, nw, sids, mixes):
            def step():
                outs, meta = self.rt.dispatch_batch(
                    [ids], noise_scale=ns, length_scale=ls,
                    noise_w=nw, speaker_ids=sids,
                    speaker_mixes=mixes, fused=True,
                    pad_rows_to=rung, budget_frames=budget)
                self.rt.fetch_batch(outs, meta)
            return step

        def warm_split(ids, rung, ns, ls, nw, sids, mixes):
            def step():
                self.rt.synthesize_batch(
                    [ids] * rung, noise_scale=ns, length_scale=ls,
                    noise_w=nw,
                    speaker_ids=(sids * rung) if sids else None,
                    speaker_mixes=(mixes * rung) if mixes else None)
            return step

        def warm_durations(ids, p_bucket, sids, mixes):
            def step():
                self.rt.phoneme_durations(
                    [ids], speaker_ids=sids, speaker_mixes=mixes,
                    pad_rows_to=self._dur_rows(p_bucket))
            return step

        for p_bucket in p_buckets:
            ids = (base * (-(-p_bucket // len(base))))[:p_bucket]
            # Budgets read self._fpp — computed lazily here, AFTER the
            # calibrate step above has run under the call-as-you-go
            # contract.
            budgets = [(self._rungs(p_bucket), self._budget_frames(p_bucket)),
                       # the overflow-redo program (tail rows, 2x budget)
                       ((self._rungs(p_bucket)[0],),
                        2 * self._budget_frames(p_bucket))]
            for rungs, budget in budgets if self.fused else budgets[:1]:
                for rung in rungs:
                    for ns, ls, nw in scales:
                        for sids, mixes in variants:
                            if self.fused:
                                yield ("program", warm_fused(
                                    ids, rung, budget, ns, ls, nw, sids,
                                    mixes))
                            else:
                                yield ("program", warm_split(
                                    ids, rung, ns, ls, nw, sids, mixes))
            # The durations (alignment) program: one pinned encode per
            # bucket (and per conditioning variant), so a first
            # submit_durations meets no new shape mid-traffic.
            for sids, mixes in variants:
                yield ("program", warm_durations(ids, p_bucket, sids, mixes))

    def _pop_group_locked(self, key) -> List[_Request]:
        """Pop up to the key's group limit from its queue with all metric
        bookkeeping — called with self._cond held."""
        q = self._queues[key]
        limit = self._group_limit(key)
        group = [q.popleft() for _ in range(min(len(q), limit))]
        if not q:
            del self._queues[key]
        self._pending -= len(group)
        now = time.perf_counter()
        m = self._metrics
        m["groups"] += 1
        m["rows"] += len(group)
        m["padded_rows"] += self._padded_rows(key[1], group)
        for r in group:
            w = (now - r.t_submit) * 1e3
            m["wait_ms_sum"] += w
            m["wait_ms_max"] = max(m["wait_ms_max"], w)
        return group

    def _padded_rows(self, p_bucket, group: List[_Request]) -> int:
        """The dummy rows a group of the phoneme bucket `p_bucket` is
        padded with at dispatch."""
        if group[0].kind == "dur" and isinstance(p_bucket, int):
            return self._dur_rows(p_bucket) - len(group)
        if isinstance(p_bucket, int) and (group[0].kind == "forced"
                                          or self.fused):
            # Forced groups pin rows to the same <=3-rung grid as fused
            # groups (see _dispatch_group) — count their padding the same.
            return self._pad_rows_for(p_bucket, len(group)) - len(group)
        if len(group) > 1:
            ladder = getattr(self.rt, "batch_ladder",
                             self.rt.options.batch_buckets)
            return next((x for x in ladder if x >= len(group)),
                        len(group)) - len(group)
        return 0

    def _take_group(self, block: bool) -> Optional[List[_Request]]:
        """Pop up to the key's group limit of same-key requests, oldest key
        first.

        Returns None on shutdown-with-empty-queues; [] when not blocking and
        nothing is ready. When the device is idle (block=True) a not-yet-full
        batch waits up to max_wait_s from its oldest arrival for company."""
        with self._cond:
            while True:
                self._shed_expired_locked()
                key = self._oldest_key()
                if key is None:
                    if self._closed:
                        return None
                    if not block:
                        return []
                    self._cond.wait()
                    continue
                q = self._queues[key]
                limit = self._group_limit(key)
                if (len(q) < limit and not self._closed and block):
                    # batching window: only while the device would sit idle
                    age = time.perf_counter() - q[0].t_submit
                    remaining = self.max_wait_s - age
                    if remaining > 0:
                        self._cond.wait(timeout=remaining)
                        continue
                return self._pop_group_locked(key)

    def _shed_expired_locked(self) -> None:
        """Fail (and drop) queued requests older than the deadline — called
        with the lock held, before each group selection."""
        if self.deadline_s is None:
            return
        cutoff = time.perf_counter() - self.deadline_s
        for key in list(self._queues):
            q = self._queues[key]
            while q and q[0].t_submit < cutoff:
                req = q.popleft()
                self._pending -= 1
                self._metrics["shed_deadline"] += 1
                _deliver(req.future, exc=DeadlineExceeded(
                    f"queued longer than {self.deadline_s * 1e3:.0f} ms"))
            if not q:
                del self._queues[key]

    # -- serving -------------------------------------------------------------

    def _dispatch_group(self, group: List[_Request]):
        """Dispatch one batched synthesis; returns (group, outs, meta) for a
        later fetch, or None if the dispatch itself failed.

        Durations groups (kind "dur") are encoder-only — cheap enough to run
        synchronously here (one dispatch + one small fetch); their futures
        resolve immediately and nothing is returned for a later fetch.

        The batcher.group span (the group's rows, padded rows and its
        oldest row's wait) holds the whole of it; batcher.dispatch the
        runtime's call."""
        p_bucket = self._p_bucket(max(len(r.ids) for r in group))
        with self._prof.span("batcher.group", rows=len(group),
                             padded_rows=self._padded_rows(p_bucket, group),
                             wait_ms=(time.perf_counter() - group[0].t_submit) * 1e3):
            return self._dispatch_group_spanned(group)

    def _dispatch_group_spanned(self, group: List[_Request]):
        # All rows of a group share the mix flag (it is part of the queue
        # key), so a group is either all-mix or all-id/none.
        mixes = ([r.speaker_mix for r in group]
                 if group[0].speaker_mix is not None else None)
        if group[0].kind == "dur":
            try:
                _, ls, nw = group[0].scales
                speaker_ids = None
                if any(r.speaker_id is not None for r in group):
                    speaker_ids = [r.speaker_id or 0 for r in group]
                p_bucket = bucket_for(max(len(r.ids) for r in group),
                                      self.rt.options.phoneme_buckets,
                                      "phoneme")
                with self._prof.span("batcher.dispatch"):
                    durs = self.rt.phoneme_durations(
                        [r.ids for r in group], length_scale=ls, noise_w=nw,
                        speaker_ids=speaker_ids, speaker_mixes=mixes,
                        pad_rows_to=self._dur_rows(p_bucket))
                with self._cond:
                    self._metrics["completed"] += len(group)
                for r, d in zip(group, durs):
                    self._finish_value(r, d)
            except Exception as e:  # noqa: BLE001 — per-request surfacing
                with self._cond:
                    self._metrics["failed"] += len(group)
                for r in group:
                    _deliver(r.future, exc=e)
            return None
        if group[0].kind == "forced":
            # No host read (the frame bucket is known from the plan
            # totals up front): run synchronously, nothing to fetch later.
            # Rows pin to the fused grid's <=3 rungs per phoneme bucket so
            # traffic-dependent group sizes meet no new shape; the
            # frame axis still varies with plan totals, bounded by the
            # frame-bucket ladder.
            try:
                ns = group[0].scales[0]
                speaker_ids = None
                if any(r.speaker_id is not None for r in group):
                    speaker_ids = [r.speaker_id or 0 for r in group]
                p_bucket = bucket_for(max(len(r.ids) for r in group),
                                      self.rt.options.phoneme_buckets,
                                      "phoneme")
                with self._prof.span("batcher.dispatch"):
                    audios = self.rt.synthesize_batch_forced(
                        [r.ids for r in group], [r.durations for r in group],
                        noise_scale=ns, speaker_ids=speaker_ids,
                        speaker_mixes=mixes,
                        pad_rows_to=self._pad_rows_for(p_bucket, len(group)))
                with self._cond:
                    self._metrics["completed"] += len(group)
                for r, a in zip(group, audios):
                    self._finish_value(r, a)
            except Exception as e:  # noqa: BLE001 — per-request surfacing
                with self._cond:
                    self._metrics["failed"] += len(group)
                for r in group:
                    _deliver(r.future, exc=e)
            return None
        try:
            ns, ls, nw = group[0].scales
            speaker_ids = None
            if any(r.speaker_id is not None for r in group):
                speaker_ids = [r.speaker_id or 0 for r in group]
            kwargs = {}
            if self.fused:
                # Pin the program grid: rows pad to one of <=3 rungs, frame
                # budget derives from the phoneme bucket (see class doc).
                p_bucket = bucket_for(max(len(r.ids) for r in group),
                                      self.rt.options.phoneme_buckets,
                                      "phoneme")
                kwargs = {
                    "pad_rows_to": self._pad_rows_for(p_bucket, len(group)),
                    "budget_frames": self._budget_frames(p_bucket),
                    "overflow_budget_frames": 2 * self._budget_frames(p_bucket),
                    "overflow_pad_rows": self._rungs(p_bucket)[0],
                }
            with self._prof.span("batcher.dispatch"):
                outs, meta = self.rt.dispatch_batch(
                    [r.ids for r in group],
                    noise_scale=ns, length_scale=ls, noise_w=nw,
                    speaker_ids=speaker_ids, speaker_mixes=mixes,
                    fused=self.fused, **kwargs,
                )
            return group, outs, meta
        except Exception as e:  # noqa: BLE001 — per-request surfacing
            with self._cond:
                self._metrics["failed"] += len(group)
            for r in group:
                _deliver(r.future, exc=e)
            return None

    def _finish_group(self, group: List[_Request], outs, meta) -> None:
        try:
            with self._prof.span("batcher.fetch", batch=meta.get("batch")):
                audios = self.rt.fetch_batch(outs, meta)
            with self._cond:
                self._metrics["completed"] += len(group)
                # The runtime's fetch counts the rows it redid (fused
                # groups whose durations overflowed the frame budget).
                self._metrics["overflow_rows"] += meta.get("overflow_rows", 0)
                self._metrics["overflow_split_rows"] += meta.get("overflow_split_rows", 0)
            for r, a in zip(group, audios):
                self._finish_value(r, a)
        except Exception as e:  # noqa: BLE001
            with self._cond:
                self._metrics["failed"] += len(group)
            for r in group:
                _deliver(r.future, exc=e)

    def _serve_loop(self) -> None:
        # Depth-2 pipeline on ONE thread (all device work serial): group
        # i's audio copy and slicing overlap group i+1's collect +
        # dispatch.
        # self._inflight tracks EVERY dispatched-not-yet-finished group
        # (briefly two during the depth-2 overlap) so the crash handler can
        # fail all of them — fail open, never hang.
        self._inflight: List[tuple] = []
        try:
            pending = None
            while True:
                group = self._take_group(block=pending is None)
                if group is None:  # shutdown, queues drained
                    if pending is not None:
                        self._finish_group(*pending)
                    return
                if group:
                    dispatched = self._dispatch_group(group)
                    old = pending
                    pending = dispatched
                    self._inflight = [x for x in (dispatched, old) if x]
                    if old is not None:
                        self._finish_group(*old)
                    self._inflight = [dispatched] if dispatched else []
                elif pending is not None:
                    self._finish_group(*pending)
                    pending = None
                    self._inflight = []
        except BaseException as e:  # noqa: BLE001 — fail open, never hang
            # A scheduler bug must not strand every future forever: close
            # the server and fail everything queued or in flight.
            for entry in self._inflight:
                for req in entry[0]:
                    _deliver(req.future,
                             exc=RuntimeError(f"serving worker died: {e!r}"))
            self._fail_all(e)
            raise

    def _fail_all(self, e: BaseException) -> None:
        with self._cond:
            self._closed = True
            for q in self._queues.values():
                for req in q:
                    _deliver(req.future,
                             exc=RuntimeError(f"serving worker died: {e!r}"))
            self._queues.clear()
            self._pending = 0
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=600)
            if self._worker.is_alive():
                raise RuntimeError(
                    "BatchingServer worker did not exit within 600s; "
                    "thread leaked")

    def __enter__(self) -> "BatchingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MultiVoiceBatchingServer:
    """Continuous batching across SEVERAL resident voices on one card.

    N independent BatchingServers would run N worker threads, each setting
    the process-wide precision tiers and queueing on the card at once — so
    this server keeps one per-voice BatchingServer for its
    queues/admission/grid logic but multiplexes them onto ONE worker: each
    tick serves the (voice, scales, phoneme-bucket) queue holding the
    globally oldest request, depth-2 pipelined across voices (group i's
    audio copy overlaps group i+1's dispatch, even when they belong to
    different voices). Each dispatch runs inside its own runtime's tiers,
    so voices at different tiers share the worker.
    """

    def __init__(self, runtimes: Dict[str, PiperRuntime], *,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 max_rows: int = 128, fused: Optional[bool] = None,
                 max_pending: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 cache_mb: float = 0.0,
                 warm_every: int = 2,
                 cond: Optional[threading.Condition] = None,
                 start_worker: bool = True):
        """`runtimes` maps voice key -> loaded PiperRuntime (e.g. from
        VoiceServer.runtime()). Admission control (`max_pending`,
        `deadline_ms`) and the response cache (`cache_mb`) apply PER
        VOICE.

        `warm_every`: under live traffic, one prewarm step of a voice added
        via add_voice runs after every `warm_every` traffic groups (all idle
        time also goes to warming) — resident voices keep serving while a
        new voice warms instead of pausing for its whole grid.

        `cond` / `start_worker` exist for UnifiedServer, which drives this
        scheduler AND the streaming tick loop from its own single worker."""
        if not runtimes:
            raise ValueError("at least one voice runtime required")
        self._cond = cond if cond is not None else threading.Condition()
        self._batcher_kwargs = dict(
            max_batch=max_batch, max_wait_ms=max_wait_ms, max_rows=max_rows,
            fused=fused, max_pending=max_pending, deadline_ms=deadline_ms,
            cache_mb=cache_mb)
        self._servers: Dict[str, BatchingServer] = {
            key: BatchingServer(rt, cond=self._cond, start_worker=False,
                                **self._batcher_kwargs)
            for key, rt in runtimes.items()
        }
        self.max_wait_s = max_wait_ms / 1e3
        self.warm_every = max(1, int(warm_every))
        self._closed = False
        self._control: deque = deque()
        # add_voice warms-in-progress: voice key -> state dict (worker-only
        # mutation; readers snapshot under the lock). _groups_since_warm
        # paces warm steps against traffic groups.
        self._warming: Dict[str, dict] = {}
        self._groups_since_warm = 0
        # When serve_step returns "wait", seconds left in the oldest
        # group's batching window (UnifiedServer's idle-wait hint).
        self._wait_hint: Optional[float] = None
        self._worker: Optional[threading.Thread] = None
        if start_worker:
            self._worker = threading.Thread(target=self._serve_loop,
                                            name="piper-mv-server",
                                            daemon=True)
            self._worker.start()

    @property
    def voices(self) -> List[str]:
        with self._cond:
            return list(self._servers)

    # -- dynamic voice management ------------------------------------------

    def add_voice(self, key: str, runtime: PiperRuntime, *,
                  prewarm: bool = True, **prewarm_kwargs) -> "Future[dict]":
        """Register a NEW voice on a live server WITHOUT pausing resident
        voices: the voice accepts submits immediately, and its grid prewarm
        runs as individual warm steps on the worker thread — one group's
        work at one grid shape, interleaved after every `warm_every`
        traffic groups (idle time all goes to warming) — so other voices
        keep serving throughout instead of freezing for the whole grid.
        Device work stays single-threaded. A step costs one group's device
        time, more at a shape's first run (cuDNN's algorithm choice, the
        allocator's growth; a kernel's first launch in the process builds
        it), and traffic drains between steps either way. Warm progress
        appears in warming()/metrics(); prewarm=False skips warming entirely
        (the voice's first traffic then pays those costs on demand).

        Traffic for the NEW voice submitted before its grid finishes
        warming is served as soon as its queue is oldest — it may land on a
        not-yet-warm shape and pay its first-run costs inline.

        Returns a Future resolving to the prewarm stats dict ({} when
        prewarm=False); it fails if the key already exists.

        `extra_warm_steps`: an optional iterable of ("program"|"calibrate",
        zero-arg callable) warm steps chained AFTER the batch grid — how
        UnifiedServer interleaves the new voice's STREAMING program grid
        through the same non-pausing scheduler."""
        extra = prewarm_kwargs.pop("extra_warm_steps", None)
        fut: "Future[dict]" = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            self._control.append(("add", key, runtime, prewarm,
                                  prewarm_kwargs, extra, fut))
            self._cond.notify_all()
        return fut

    def remove_voice(self, key: str) -> "Future[int]":
        """Unload a voice: its queued (undispatched) requests fail with
        ServerOverloaded and new submits raise KeyError. Resolves to the
        number of requests failed."""
        fut: "Future[int]" = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            self._control.append(("remove", key, fut))
            self._cond.notify_all()
        return fut

    def warm_voice(self, key: str, *, extra_warm_steps=None,
                   **prewarm_kwargs) -> "Future[dict]":
        """Warm an ALREADY-registered voice's program grid ON the worker
        thread — the same paced warm-step scheduler add_voice uses (one
        step per warm_every traffic groups; all idle time goes to
        warming). This is how prewarm() enforces the one-thread device
        rule in code instead of convention: the caller blocks on the
        returned Future while the worker drives the device, and submits
        landing mid-warm are served between steps. `extra_warm_steps`
        chains additional ("program"|"calibrate", callable) steps after
        the batch grid (UnifiedServer's streaming grid)."""
        fut: "Future[dict]" = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            self._control.append(("warm", key, prewarm_kwargs,
                                  extra_warm_steps, fut))
            self._cond.notify_all()
        return fut

    def _handle_control(self) -> None:
        """Executed on the worker thread between groups."""
        with self._cond:
            if not self._control:
                return
            item = self._control.popleft()
        if item[0] == "add":
            _, key, runtime, prewarm, prewarm_kwargs, extra, fut = item
            try:
                with self._cond:
                    if key in self._servers:
                        raise ValueError(f"voice {key!r} already loaded")
                srv = BatchingServer(runtime, cond=self._cond,
                                     start_worker=False,
                                     **self._batcher_kwargs)
                with self._cond:
                    self._servers[key] = srv
                    if prewarm or extra is not None:
                        # Warm incrementally between traffic groups (see
                        # add_voice); the future resolves when the grid
                        # finishes.
                        steps = (srv.prewarm_steps(**prewarm_kwargs)
                                 if prewarm else iter(()))
                        if extra is not None:
                            steps = itertools.chain(steps, extra)
                        self._warming[key] = {
                            "iter": steps,
                            "srv": srv, "programs": 0,
                            "t0": time.perf_counter(), "fut": fut,
                        }
                if not prewarm and extra is None:
                    _deliver(fut, {})
            except Exception as e:  # noqa: BLE001 — surface on the future
                _deliver(fut, exc=e)
            return
        if item[0] == "warm":
            _, key, prewarm_kwargs, extra, fut = item
            try:
                with self._cond:
                    srv = self._servers.get(key)
                    if srv is None:
                        raise KeyError(f"unknown voice {key!r}")
                    if key in self._warming:
                        raise RuntimeError(
                            f"voice {key!r} is already warming")
                    steps = srv.prewarm_steps(**prewarm_kwargs)
                    if extra is not None:
                        steps = itertools.chain(steps, extra)
                    self._warming[key] = {
                        "iter": steps, "srv": srv, "programs": 0,
                        "t0": time.perf_counter(), "fut": fut,
                    }
            except Exception as e:  # noqa: BLE001 — surface on the future
                _deliver(fut, exc=e)
            return
        _, key, fut = item
        try:
            with self._cond:
                srv = self._servers.pop(key, None)
                st = self._warming.pop(key, None)
                if st is not None:
                    _deliver(st["fut"], {
                        "programs": st["programs"],
                        "seconds": time.perf_counter() - st["t0"],
                        "frames_per_phoneme": st["srv"]._fpp,
                        "cancelled": True,
                    })
                if srv is None:
                    raise KeyError(f"unknown voice {key!r}")
                srv._closed = True
                failed = 0
                for q in srv._queues.values():
                    for req in q:
                        _deliver(req.future, exc=ServerOverloaded(
                            f"voice {key!r} unloaded"))
                        failed += 1
                    srv._pending -= len(q)
                srv._queues.clear()
            _deliver(fut, failed)
        except Exception as e:  # noqa: BLE001
            _deliver(fut, exc=e)

    def _advance_warm(self) -> None:
        """Run ONE prewarm step of the oldest warming voice (worker thread
        only); resolves the add_voice future when its grid completes."""
        with self._cond:
            if not self._warming:
                return
            key, st = next(iter(self._warming.items()))
            self._groups_since_warm = 0
        try:
            kind, step = next(st["iter"], (None, None))
        except Exception as e:  # noqa: BLE001 — the generator BODY raised
            # (e.g. bad prewarm kwargs only surface at first resume): fail
            # ONLY this add_voice future, exactly like a failed step() —
            # letting it propagate would _fail_worker the whole server.
            with self._cond:
                self._warming.pop(key, None)
            _deliver(st["fut"], exc=e)
            return
        if step is None:  # grid complete
            with self._cond:
                self._warming.pop(key, None)
            _deliver(st["fut"], {
                "programs": st["programs"],
                "seconds": time.perf_counter() - st["t0"],
                "frames_per_phoneme": st["srv"]._fpp,
            })
            return
        try:
            step()  # device work — outside the lock
            if kind == "program":
                with self._cond:
                    st["programs"] += 1
        except Exception as e:  # noqa: BLE001 — surface on the add future
            with self._cond:
                self._warming.pop(key, None)
            # The voice STAYS registered (already-warm programs serve);
            # the failure surfaces on the add_voice future.
            _deliver(st["fut"], exc=e)

    def cancel_all_warming(self, reason: str) -> None:
        with self._cond:
            warming, self._warming = self._warming, {}
        for key, st in warming.items():
            _deliver(st["fut"], exc=RuntimeError(
                f"voice {key!r} prewarm abandoned: {reason}"))

    def warming(self) -> Dict[str, dict]:
        """Prewarm progress of voices added on the live server:
        {voice: {"programs": done-so-far, "seconds": elapsed}}. Empty when
        every resident voice is fully warm."""
        now = time.perf_counter()
        with self._cond:
            return {k: {"programs": st["programs"],
                        "seconds": now - st["t0"]}
                    for k, st in self._warming.items()}

    def ready(self) -> bool:
        """True when no voice is mid-prewarm and no control op is queued —
        the readiness signal /healthz surfaces (a warming server still
        SERVES, but first requests on unwarmed shapes pay first-run
        costs)."""
        with self._cond:
            return not self._warming and not self._control

    def _snapshot(self) -> Dict[str, BatchingServer]:
        # Voice add/remove mutates self._servers on the worker thread, so
        # every reader iterates a snapshot taken under the lock.
        with self._cond:
            return dict(self._servers)

    def submit(self, voice: str, phoneme_ids: Sequence[int],
               **kwargs) -> "Future[np.ndarray]":
        """Queue one request for `voice`; same contract as
        BatchingServer.submit (ServerOverloaded past the per-voice cap)."""
        if self._closed:
            raise RuntimeError("server is closed")
        return self._snapshot()[voice].submit(phoneme_ids, **kwargs)

    def submit_durations(self, voice: str, phoneme_ids: Sequence[int],
                         **kwargs) -> "Future[np.ndarray]":
        """Queue a phoneme-durations (alignment) request for `voice`; same
        contract as BatchingServer.submit_durations."""
        if self._closed:
            raise RuntimeError("server is closed")
        return self._snapshot()[voice].submit_durations(phoneme_ids, **kwargs)

    def submit_forced(self, voice: str, phoneme_ids: Sequence[int],
                      durations: Sequence[int],
                      **kwargs) -> "Future[np.ndarray]":
        """Queue a duration-forced synthesis for `voice`; same contract as
        BatchingServer.submit_forced."""
        if self._closed:
            raise RuntimeError("server is closed")
        return self._snapshot()[voice].submit_forced(
            phoneme_ids, durations, **kwargs)

    def metrics(self) -> Dict[str, dict]:
        return {key: s.metrics() for key, s in self._snapshot().items()}

    def reset_metrics(self) -> None:
        for s in self._snapshot().values():
            s.reset_metrics()

    def prewarm(self, **kwargs) -> Dict[str, dict]:
        """Run every voice's fused shape grid ahead of traffic, ON the
        worker thread (warm_voice steps) — the one-thread device rule is
        enforced by code, not calling convention, so a submit racing
        prewarm is safe: it serves between warm steps (and may pay its own
        shape's first-run costs inline when it lands first). Blocks until every
        voice's grid is warm; returns {voice: prewarm stats}."""
        futs = {key: self.warm_voice(key, **kwargs) for key in self.voices}
        return {key: f.result() for key, f in futs.items()}

    # -- external-driver interface (UnifiedServer) -----------------------
    # The unified worker drives this scheduler from ITS one thread. These
    # methods are the declared contract (plus serve_step / warm_voice /
    # cancel_all_warming above) — no caller may reach into private state.

    def begin_drive(self) -> None:
        """The external driver owns the depth-2 in-flight slot from here
        (call once, from the driving thread, before its first
        serve_step)."""
        self._inflight = []

    @property
    def wait_hint(self) -> Optional[float]:
        """After serve_step returned "wait": seconds left in the oldest
        group's batching window (the driver's idle-wait bound)."""
        return self._wait_hint

    def fail_worker(self, e: BaseException) -> None:
        """Driver crashed: fail every queued and in-flight future, abandon
        warms, and reject future submits (fail open, never hang)."""
        self._fail_worker(e)

    def stop_accepting(self) -> None:
        """Reject new submits on every voice WITHOUT joining any thread —
        the external driver is shutting down and drains via serve_step
        (which reports "shutdown" once the queues empty)."""
        with self._cond:
            self._closed = True
            for s in self._servers.values():
                s._closed = True
            self._cond.notify_all()

    def set_group_scale(self, scale: float) -> None:
        """Scale every voice's group-pop size (UnifiedServer shrinks batch
        groups while streams are open). Affects future pops only;
        in-flight groups finish at their popped size."""
        with self._cond:
            for s in self._servers.values():
                s.group_scale = scale

    # -- scheduling ------------------------------------------------------

    def _take_group(self, block: bool, ripe_only: bool = False):
        """(server, group) for the globally oldest head request; None on
        shutdown with drained queues; (None, []) when not blocking and
        nothing is ready. Mirrors BatchingServer._take_group's batching
        window across all voices.

        `ripe_only` (only meaningful with block=False — UnifiedServer's
        loop): when the oldest group is still inside its batching window
        and below its size limit, return ("wait", seconds-remaining)
        instead of popping it early, so stream ticks can fill the window
        without costing batch aggregation."""
        with self._cond:
            while True:
                if self._control:
                    return ("control",)
                best_srv, best_key, best_t = None, None, None
                for s in self._servers.values():
                    s._shed_expired_locked()
                    key = s._oldest_key()
                    if key is None:
                        continue
                    t = s._queues[key][0].t_submit
                    if best_t is None or t < best_t:
                        best_srv, best_key, best_t = s, key, t
                if best_srv is None:
                    if self._warming and not self._closed:
                        return ("warm",)  # idle time all goes to warming
                    if self._closed:
                        return None
                    if not block:
                        return (None, [])
                    self._cond.wait()
                    continue
                if (self._warming
                        and self._groups_since_warm >= self.warm_every):
                    # Pace warming against live traffic: one warm step per
                    # warm_every groups, so a cold add_voice converges even
                    # under saturation without pausing resident voices.
                    return ("warm",)
                q = best_srv._queues[best_key]
                limit = best_srv._group_limit(best_key)
                if len(q) < limit and not self._closed:
                    remaining = self.max_wait_s - (time.perf_counter() - best_t)
                    if remaining > 0:
                        if block:
                            self._cond.wait(timeout=remaining)
                            continue
                        if ripe_only:
                            return ("wait", remaining)
                self._groups_since_warm += 1
                return best_srv, best_srv._pop_group_locked(best_key)

    def _serve_loop(self) -> None:
        # Depth-2 pipeline on ONE thread across all voices: the pending
        # (server, group, outs, meta) fetch overlaps the next dispatch.
        # self._inflight mirrors the pending entry so a worker crash can
        # fail its futures (fail open, never hang — see _serve_loop_impl's
        # except-all counterpart on BatchingServer._serve_loop).
        self._inflight = []
        try:
            self._serve_loop_impl()
        except BaseException as e:  # noqa: BLE001 — fail open, never hang
            self._fail_worker(e)
            raise

    def _fail_worker(self, e: BaseException) -> None:
        """The worker (internal or UnifiedServer's) died: fail every
        in-flight and queued future, close, abandon warms — fail open,
        never hang."""
        for entry in self._inflight:
            for req in entry[1]:
                _deliver(req.future,
                         exc=RuntimeError(f"serving worker died: {e!r}"))
        with self._cond:  # Condition uses an RLock: nested entry is fine
            self._closed = True
            for s in self._servers.values():
                s._fail_all(e)
            for item in self._control:
                fut = item[-1]
                _deliver(fut,
                         exc=RuntimeError(f"serving worker died: {e!r}"))
            self._control.clear()
            self._cond.notify_all()
        self.cancel_all_warming(f"serving worker died: {e!r}")

    def serve_step(self, pending, *, block: bool, ripe_only: bool = False):
        """ONE scheduler step — the body of _serve_loop_impl, factored so
        UnifiedServer can interleave it with streaming ticks on its own
        worker. `pending` is the depth-2 in-flight entry from the previous
        step (or None). Returns (new_pending, status):

          "shutdown" — closed with queues drained (pending landed);
          "served"   — did device/control/warm work;
          "idle"     — block=False and nothing queued anywhere;
          "wait"     — ripe_only and the oldest group needs more batching
                       time (new_pending carries (None, seconds)-style info
                       via self._wait_hint).

        Both idle and wait are only returned with pending is None — when a
        fetch is outstanding this step lands it instead ("served")."""
        self._inflight = [pending] if pending else []
        took = self._take_group(block=block, ripe_only=ripe_only)
        if took is None:  # shutdown, all queues drained
            if pending is not None:
                srv, group, outs, meta = pending
                srv._finish_group(group, outs, meta)
            self.cancel_all_warming("server closed")
            return None, "shutdown"
        if took[0] in ("control", "warm"):
            # Land the in-flight fetch before a voice load/unload or a
            # warm step (both own the device for their duration).
            if pending is not None:
                psrv, pgroup, pouts, pmeta = pending
                psrv._finish_group(pgroup, pouts, pmeta)
                self._inflight = []
            if took[0] == "control":
                self._handle_control()
            else:
                self._advance_warm()
            return None, "served"
        if took[0] in (None, "wait"):
            if pending is not None:
                psrv, pgroup, pouts, pmeta = pending
                psrv._finish_group(pgroup, pouts, pmeta)
                self._inflight = []
                return None, "served"
            self._wait_hint = took[1] if took[0] == "wait" else None
            return None, "wait" if took[0] == "wait" else "idle"
        srv, group = took
        if not group:
            # _pop_group_locked can come back empty (all expired): treat
            # like idle-with-pending.
            if pending is not None:
                psrv, pgroup, pouts, pmeta = pending
                psrv._finish_group(pgroup, pouts, pmeta)
                self._inflight = []
                return None, "served"
            return None, "idle"
        dispatched = srv._dispatch_group(group)
        new_pending = None
        if dispatched is not None:
            pgroup, pouts, pmeta = dispatched
            new_pending = (srv, pgroup, pouts, pmeta)
        # mirror BOTH the just-dispatched group and the old fetch:
        # a crash while finishing the old one must fail both sets
        self._inflight = [x for x in (new_pending, pending) if x]
        if pending is not None:
            psrv, pgroup, pouts, pmeta = pending
            psrv._finish_group(pgroup, pouts, pmeta)
        self._inflight = [new_pending] if new_pending else []
        return new_pending, "served"

    def _serve_loop_impl(self) -> None:
        pending = None
        while True:
            pending, status = self.serve_step(pending,
                                               block=pending is None)
            if status == "shutdown":
                return
            # "idle"/"wait" are unreachable here: block=True waits inside
            # _take_group, and with pending set a no-group step lands the
            # fetch and reports "served".

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            for s in self._servers.values():
                s._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=600)
            if self._worker.is_alive():
                raise RuntimeError(
                    "MultiVoiceBatchingServer worker did not exit within "
                    "600s; thread leaked")
        else:
            # Externally driven (UnifiedServer): the driver has stopped by
            # the time close() runs, so abandon warms here.
            self.cancel_all_warming("server closed")

    def __enter__(self) -> "MultiVoiceBatchingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
