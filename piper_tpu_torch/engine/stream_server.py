"""Batched multi-stream serving: N concurrent low-latency streams, one
device (the port of piper_tpu.engine.stream_server: the same classes,
names, signatures and defaults, over the port's PiperRuntime).

The single-stream incremental decoder (PiperRuntime.synthesize_stream_
incremental) runs B=1 windows — fine for one client, but N concurrent
streaming clients would serialize N single-row decodes, each a launch-bound
call on the card. This server gives every stream the same time to first
audio as a lone stream (its OWN fused encode + window-0 head, no host read
inside) and then decodes all streams' steady-state windows in ONE batched
call per tick: per-row window positions, per-row seeds, per-row lengths —
decode_window (models/vits/model.py) masks each row at its own sequence
edges and K1-K3 take each row's [lo, hi) bounds, so a stream batched with
15 others produces the audio it would produce alone (up to the order of
fp32 sums, which the batch's shape picks).

Scheduling: one worker thread drives every device call of the server (the
runtime's lock, inference mode and precision tiers are taken per call, so
the worker need not be the thread that built the runtime); every dispatch
queues its copy to pinned host memory right behind its work (_HostCopy),
and tick k+1's dispatches are queued before tick k's copies are waited on
(depth 2: the copy and the host's processing overlap the card's work).
Apart from those waits a tick reads nothing back from the device: the
frame counts arrive in the head's copy, the seeds and noise scales are
host values known at submit, and the window's per-row arguments are copied
to the device without a wait. Rows pad to a small rung ladder, so the set
of shapes is bounded and prewarmable (on the card a first-seen shape pays
cuDNN's algorithm choice and the caching allocator's growth).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from piper_tpu_torch.core.audio import AudioChunk
from piper_tpu_torch.engine.batcher import ServerOverloaded
from piper_tpu_torch.engine.bucketing import bucket_for
from piper_tpu_torch.engine.runtime import (_HostCopy, _seed_u32, validate_scales,
                                            validate_speaker_mix)
from piper_tpu_torch.models.vits.hparams import receptive_field_frames
from piper_tpu_torch.models.vits.model import EncodeResult

_FAR = 1 << 28  # padding-row offset: beyond any real sequence (int64 on the device)


@dataclass(eq=False)  # identity semantics: fields hold device tensors
class _Session:
    sid: int
    ids: List[int]
    seed: Optional[int]
    noise_scale: Optional[float]
    length_scale: Optional[float]
    noise_w: Optional[float]
    speaker_id: Optional[int]
    out: "queue.Queue[object]"
    speaker_mix: Optional[dict] = None
    # filled at the head's dispatch (host values) and its fetch:
    enc: object = None
    seed_u: int = 0        # the stream's seed, as the runtime resolves it
    ns: float = 0.0        # its noise_scale
    y_len: int = 0
    pos: int = 0
    emitted: int = 0
    failed: bool = False
    cancelled: bool = False

    def __post_init__(self):
        # Defensive copy: the session outlives submit() and a caller
        # mutating its mix dict would corrupt the head's conditioning.
        if self.speaker_mix is not None:
            self.speaker_mix = dict(self.speaker_mix)


class _StreamHandle:
    """Iterator over one stream's chunks (drains the session queue).

    `cancel()` abandons the stream: the worker closes the session on its
    next tick (freeing its max_sessions slot) instead of decoding windows
    nobody will read. Consumers that may stop early — a network handler
    whose client disconnected — MUST call it (or use the handle as a
    context manager); an abandoned iterator otherwise parks the session
    forever once its chunk queue fills."""

    def __init__(self, session: _Session):
        self._s = session

    def cancel(self) -> None:
        self._s.cancelled = True

    def __enter__(self) -> "_StreamHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.cancel()  # no-op if the stream already finished

    def __iter__(self) -> Iterator[AudioChunk]:
        while True:
            item = self._s.out.get()
            if isinstance(item, Exception):
                raise item
            yield item
            if item.is_final:
                return


def _cat_enc(encs: Sequence[EncodeResult]) -> EncodeResult:
    """EncodeResults of one phoneme width stacked along the row axis."""
    return EncodeResult(*(None if v[0] is None else torch.cat(v, dim=0) for v in zip(*(
        (e.m_p, e.logs_p, e.x_mask, e.w, e.w_ceil, e.y_total, e.g) for e in encs))))


def _row_enc(enc: EncodeResult, r: int) -> EncodeResult:
    """Row r of a batched EncodeResult (views on the device)."""
    return EncodeResult(*(None if v is None else v[r: r + 1] for v in (
        enc.m_p, enc.logs_p, enc.x_mask, enc.w, enc.w_ceil, enc.y_total, enc.g)))


class StreamingServer:
    """Continuous batched window decoding for concurrent audio streams.

    Usage::

        server = StreamingServer(runtime)
        for chunk in server.submit(phoneme_ids, seed=1):
            play(chunk)   # N submits from N threads share batched decodes

    emit_frames: frames of audio emitted per steady-state window (every
    window additionally computes a receptive-field halo on each side, so
    small values overcompute; default 512). TTFB is set by c0, not
    emit_frames; per-chunk cadence is emit_frames*hop samples, so
    latency-sensitive consumers can lower it. c0: the head window's emitted
    frames (TTFB).
    row_rungs: batch sizes the window call runs at (rows pad up).
    head_rungs: batch sizes of the BATCHED head — a burst of simultaneous
    arrivals (same phoneme bucket) runs its fused heads in one call instead
    of serializing b=1 heads, so burst TTFB stays near solo TTFB. Defaults
    to row_rungs capped at 16. Larger bursts than the largest rung split.
    """

    def __init__(
        self,
        runtime,
        *,
        emit_frames: int = 512,
        c0: Optional[int] = None,
        row_rungs: Sequence[int] = (1, 2, 4, 8, 16, 32),
        head_rungs: Optional[Sequence[int]] = None,
        max_sessions: int = 64,
        queue_chunks: int = 8,
        tick_wait_s: float = 0.002,
        start_worker: bool = True,
        on_submit=None,
    ) -> None:
        """`start_worker=False` + `on_submit` exist for UnifiedServer: it
        drives tick() from ITS one worker thread (interleaved with batched
        groups) and needs submit() to wake that worker — on_submit is
        called after each session lands in the incoming queue."""
        self.rt = runtime
        self._on_submit = on_submit
        hp = runtime.hparams
        self.halo = receptive_field_frames(hp)
        self.hop = hp.hop_length
        self.emit_frames = int(emit_frames)
        self.c0 = int(c0) if c0 is not None else max(32, 2048 // hp.hop_length)
        self.row_rungs = tuple(sorted(int(r) for r in row_rungs))
        self.head_rungs = (tuple(sorted(int(r) for r in head_rungs))
                           if head_rungs is not None
                           else tuple(r for r in self.row_rungs if r <= 16)
                           or (self.row_rungs[0],))
        self.max_sessions = int(max_sessions)
        self.queue_chunks = int(queue_chunks)
        self.tick_wait_s = float(tick_wait_s)
        self._ids = itertools.count()
        self._incoming: "queue.Queue[_Session]" = queue.Queue()
        self._active: List[_Session] = []  # head fetched, windows pending
        self._n_open = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # Set (before _stop) by shutdown(): the worker stops waiting on
        # stuck consumers past this monotonic instant and fails their
        # sessions instead of leaking itself.
        self._stop_deadline = float("inf")
        self._metrics = {
            "ticks": 0, "head_dispatches": 0, "window_dispatches": 0,
            "window_rows": 0, "padded_rows": 0, "sessions": 0,
            "head_rows": 0, "padded_head_rows": 0,
        }
        # Depth-2 state: last tick's dispatched-but-unfetched work, each
        # (kind, target, _HostCopy). Owned by whichever single thread
        # drives tick() (the internal worker, or UnifiedServer's).
        self._inflight: list = []
        self._worker: Optional[threading.Thread] = None
        if start_worker:
            self._worker = threading.Thread(
                target=self._run, name="piper-stream-server", daemon=True)
            self._worker.start()

    # -- client surface ------------------------------------------------------

    def submit(
        self,
        phoneme_ids: Sequence[int],
        *,
        seed: Optional[int] = None,
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ) -> _StreamHandle:
        """Register a stream; returns an iterable handle of AudioChunks.

        Chunk 0 carries the head window (c0 frames); steady-state chunks
        carry emit_frames each; the last chunk is trimmed and is_final.
        Raises ServerOverloaded beyond max_sessions concurrent streams.
        Consumers that may stop early must call handle.cancel() (or use it
        as a context manager) to release the session slot.

        `speaker_mix` ({id: weight}) blends speaker embeddings (see
        PiperRuntime.synthesize); the conditioning bakes into the head's
        encode, so mix streams share steady-state window batches with id
        streams freely — only simultaneous-arrival HEAD bursts group by
        conditioning kind."""
        if self._stop.is_set():
            raise RuntimeError("StreamingServer is shut down")
        if (noise_scale, length_scale, noise_w) != (None, None, None):
            # Door-step scale validation (the batch submits' rule): a bad
            # value must raise HERE, not fail the head burst later.
            inf = getattr(getattr(self.rt, "config", None), "inference", None)
            d_ns, d_ls, d_nw = ((inf.noise_scale, inf.length_scale, inf.noise_w)
                                if inf is not None else (0.667, 1.0, 0.8))
            validate_scales(
                d_ns if noise_scale is None else float(noise_scale),
                d_ls if length_scale is None else float(length_scale),
                d_nw if noise_w is None else float(noise_w))
        if speaker_mix is not None:
            validate_speaker_mix(speaker_mix, getattr(self.rt.hparams, "n_speakers", 1),
                                 speaker_id=speaker_id)
        if speaker_id is not None:
            # Same door-step rule for plain ids: an out-of-range id would
            # otherwise fail a whole co-arriving head burst.
            n_spk = max(1, getattr(self.rt.hparams, "n_speakers", 1))
            if not 0 <= int(speaker_id) < n_spk:
                raise ValueError(f"speaker_id {speaker_id} out of range [0, {n_spk})")
        with self._lock:
            if self._n_open >= self.max_sessions:
                raise ServerOverloaded(
                    f"{self._n_open} streams open (max_sessions={self.max_sessions})")
            self._n_open += 1
            self._metrics["sessions"] += 1
        s = _Session(
            sid=next(self._ids), ids=list(phoneme_ids), seed=seed,
            noise_scale=noise_scale, length_scale=length_scale,
            noise_w=noise_w, speaker_id=speaker_id, speaker_mix=speaker_mix,
            out=queue.Queue(maxsize=self.queue_chunks),
        )
        self._incoming.put(s)
        if self._on_submit is not None:
            self._on_submit()
        return _StreamHandle(s)

    def metrics(self) -> dict:
        with self._lock:
            m = dict(self._metrics)
        m["open_sessions"] = self._n_open
        return m

    def prewarm(
        self,
        phoneme_lengths: Sequence[int] = (14, 56, 224),
        row_rungs: Optional[Sequence[int]] = None,
        head_rungs: Optional[Sequence[int]] = None,
        speaker_mix: bool = False,
    ) -> dict:
        """Run the shape grid — solo + batched heads per phoneme bucket
        plus the (bucket x rung) window ladder — ahead of traffic (on the
        card a first-seen shape pays cuDNN's algorithm choice and the
        caching allocator's growth; the runtime marks each shape's first
        run).

        Must run BEFORE serving traffic: it drives the device from the
        calling thread while the worker is idle. `row_rungs` trims the
        warmed ladder.

        `speaker_mix=True` additionally warms the speaker-BLENDING head
        variant on multi-speaker voices ((B, n_speakers) weights are
        another head shape than integer ids; windows take the conditioning
        through enc, so only heads fork)."""
        if self._n_open:
            raise RuntimeError("prewarm must run before traffic "
                               f"({self._n_open} streams open)")
        t0 = time.perf_counter()
        programs = 0
        for kind, step in self.prewarm_steps(
                phoneme_lengths=phoneme_lengths, row_rungs=row_rungs,
                head_rungs=head_rungs, speaker_mix=speaker_mix):
            step()
            if kind == "program":
                programs += 1
        return {"seconds": time.perf_counter() - t0, "programs": programs}

    def prewarm_steps(
        self,
        phoneme_lengths: Sequence[int] = (14, 56, 224),
        row_rungs: Optional[Sequence[int]] = None,
        head_rungs: Optional[Sequence[int]] = None,
        speaker_mix: bool = False,
    ):
        """The streaming shape grid as a lazy sequence of ("program",
        zero-arg callable) steps; running every step in order equals
        prewarm(). Callers MUST invoke each yielded step before advancing
        (later window steps reuse the head step's encode output). This is
        what lets UnifiedServer.add_voice warm a new voice's STREAM grid
        between live traffic groups instead of pausing resident voices."""
        from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS

        rungs = tuple(row_rungs) if row_rungs is not None else self.row_rungs
        h_rungs = tuple(head_rungs) if head_rungs is not None else self.head_rungs
        base = [i % self.rt.hparams.n_vocab for i in FIXTURE_PHONEME_IDS]
        # (speaker_id, speaker_mix) head-conditioning variants to warm.
        # Multi-speaker voices condition on ids even when no speaker is
        # requested (sid defaults to 0), so (None, None) already covers id
        # traffic; only the mix variant is another head shape.
        variants = [(None, None)]
        if speaker_mix and getattr(self.rt.hparams, "n_speakers", 1) > 1:
            variants.append((None, {0: 1.0}))
        for length in phoneme_lengths:
            ids = (base * (-(-length // len(base))))[:length]
            # state shared between steps: the last solo head's encode feeds
            # the window-rung warms (call-in-order contract).
            state: dict = {}

            def warm_head(ids, v_sid, v_mix, state=state):
                def step():
                    with self.rt._device_work():
                        enc, audio0, total, _, _ = self.rt.dispatch_stream_head(
                            ids, c0=self.c0, halo=self.halo, seed=0,
                            speaker_id=v_sid, speaker_mix=v_mix)
                        copy = _HostCopy((audio0, total))
                    copy.wait()
                    state["enc"] = enc
                return step

            def warm_head_batch(ids, rung, v_sid, v_mix):
                def step():
                    with self.rt._device_work():
                        _, a0, tot, _, _ = self.rt.dispatch_stream_head_batch(
                            [ids] * rung, c0=self.c0, halo=self.halo, seeds=[0] * rung,
                            speaker_ids=None if v_sid is None else [v_sid] * rung,
                            speaker_mixes=None if v_mix is None else [v_mix] * rung)
                        copy = _HostCopy((a0, tot))
                    copy.wait()
                return step

            def warm_window(rung, state=state):
                def step():
                    with self.rt._device_work():
                        audio = self.rt.dispatch_window_batch(
                            _cat_enc([state["enc"]] * rung), [0] * rung,
                            np.full((rung,), -self.halo, np.int64),
                            np.full((rung,), self.c0, np.int64),
                            np.full((rung,), 0.667, np.float32),
                            emit_frames=self.emit_frames, halo=self.halo)
                        copy = _HostCopy((audio,))
                    copy.wait()
                return step

            for v_sid, v_mix in variants:
                yield ("program", warm_head(ids, v_sid, v_mix))
            for rung in (r for r in h_rungs if r > 1):
                for v_sid, v_mix in variants:
                    yield ("program", warm_head_batch(ids, rung, v_sid, v_mix))
            for rung in rungs:
                yield ("program", warm_window(rung))

    def stop_accepting(self) -> None:
        """Reject new submits; open sessions keep ticking until drained
        (the driving thread keeps calling tick()). Part of the declared
        external-driver interface (UnifiedServer) together with
        tick/pending/drain/fail_all/prewarm_steps/open_sessions."""
        self._stop.set()

    @property
    def open_sessions(self) -> int:
        """Currently open (admitted, not yet closed/failed) sessions."""
        return self._n_open

    def shutdown(self, *, grace_s: float = 30.0) -> None:
        """Stop the worker. In-flight and consumable work finishes; sessions
        whose consumers never drain their chunk queues are FAILED once
        `grace_s` elapses instead of keeping the worker alive forever.
        Raises RuntimeError if the worker thread outlives the join — a
        leaked device-driving thread must never be silent."""
        # Deadline before the stop flag: the worker must never observe
        # _stop without a finite deadline.
        self._stop_deadline = time.monotonic() + grace_s
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=grace_s + 30)
        # A submit() that passed the stop check concurrently with this
        # shutdown can land in _incoming after the worker's final empty()
        # check — fail those sessions instead of stranding their consumers.
        while True:
            try:
                s = self._incoming.get_nowait()
            except queue.Empty:
                break
            self._fail(s, RuntimeError("StreamingServer is shut down"))
        if self._worker is not None and self._worker.is_alive():
            # Wedged inside a device call: unblock every consumer, then
            # surface the leak loudly.
            self.fail_all(RuntimeError("StreamingServer worker leaked"))
            raise RuntimeError(
                "StreamingServer worker did not exit within "
                f"{grace_s + 30:.0f}s; thread leaked")

    # -- worker --------------------------------------------------------------

    def _rung(self, rows: int) -> int:
        for r in self.row_rungs:
            if rows <= r:
                return r
        return self.row_rungs[-1]

    def _fail(self, s: _Session, err: Exception) -> None:
        if not s.failed:
            s.failed = True
            self._close(s, err)

    def _cancel_session(self, s: _Session) -> None:
        """Release a cancelled stream's slot (worker thread only). The
        consumer is gone by definition, so the close item is best-effort —
        a full chunk queue must not block the worker."""
        if s.failed:
            return
        s.failed = True
        try:
            s.out.put_nowait(RuntimeError("stream cancelled"))
        except queue.Full:
            pass
        with self._lock:
            self._n_open -= 1

    def _close(self, s: _Session, item: object) -> None:
        # Terminal: guards double-close (the crash handler may revisit a
        # session whose final chunk was already delivered this tick).
        s.failed = True
        try:
            s.out.put_nowait(item)
        except queue.Full:
            # Only reachable on failure paths (the scheduler never emits
            # past queue_chunks): drop one chunk so the error/final item
            # lands instead of blocking the WORKER on a stalled consumer.
            try:
                s.out.get_nowait()
            except queue.Empty:
                pass
            try:
                s.out.put_nowait(item)
            except queue.Full:
                pass
        with self._lock:
            self._n_open -= 1

    def _seed_of(self, s: _Session) -> int:
        return _seed_u32(self.rt.options.seed if s.seed is None else s.seed)

    def _dispatch_heads(self, sessions: List[_Session]) -> list:
        """Dispatch new streams' fused heads — simultaneous arrivals in the
        same phoneme bucket batch into one call (head_rungs ladder), a
        lone arrival keeps the b=1 head."""
        groups: dict = {}
        work = []
        for s in sessions:
            if s.cancelled:
                self._cancel_session(s)
                continue
            try:
                bucket = bucket_for(len(s.ids), self.rt.options.phoneme_buckets,
                                    "phoneme") if s.ids else 0
            except Exception as e:  # noqa: BLE001 — deliver to the caller
                self._fail(s, e)
                continue
            # Mix sessions burst-batch only with other mix sessions: the
            # head's conditioning differs by kind, and a mixed burst would
            # route id streams through the mix weights.
            groups.setdefault((bucket, s.speaker_mix is not None), []).append(s)
        for key in sorted(groups):
            group = groups[key]
            cap = self.head_rungs[-1]
            for i in range(0, len(group), cap):
                chunk = group[i: i + cap]
                if len(chunk) == 1:
                    work += self._dispatch_head_solo(chunk[0])
                else:
                    work += self._dispatch_head_group(chunk)
        return work

    def _dispatch_head_solo(self, s: _Session) -> list:
        """One stream's fused head, and the copy of its emitted region and
        frame count queued behind it."""
        hop, lo = self.hop, self.halo * self.hop
        try:
            with self.rt._device_work():
                enc, audio0, total, _, ns = self.rt.dispatch_stream_head(
                    s.ids, c0=self.c0, halo=self.halo, seed=s.seed,
                    noise_scale=s.noise_scale, length_scale=s.length_scale,
                    noise_w=s.noise_w, speaker_id=s.speaker_id,
                    speaker_mix=s.speaker_mix)
                copy = _HostCopy((audio0[:, lo: lo + self.c0 * hop], total))
        except Exception as e:  # noqa: BLE001 — deliver to the caller
            self._fail(s, e)
            return []
        s.enc, s.seed_u, s.ns = enc, self._seed_of(s), ns
        self._metrics["head_dispatches"] += 1
        self._metrics["head_rows"] += 1
        return [("head", s, copy)]

    def _dispatch_head_group(self, chunk: List[_Session]) -> list:
        """One batched head over a same-bucket burst. Rows pad to the head
        rung by repeating row 0 (exact: padding rows are never read back).
        A host-side validation error fails the WHOLE batch call before any
        device work, so fall back to solo heads — only the offending
        stream(s) fail."""
        rows = len(chunk)
        rung = next((r for r in self.head_rungs if r >= rows), self.head_rungs[-1])
        padded = chunk + [chunk[0]] * (rung - rows)
        is_mix = chunk[0].speaker_mix is not None  # group key: all-or-none
        try:
            with self.rt._device_work():
                enc, audio0, totals, seed_vals, ns_vals = self.rt.dispatch_stream_head_batch(
                    [s.ids for s in padded], c0=self.c0, halo=self.halo,
                    seeds=[s.seed for s in padded],
                    noise_scales=[s.noise_scale for s in padded],
                    length_scales=[s.length_scale for s in padded],
                    noise_ws=[s.noise_w for s in padded],
                    speaker_ids=None if is_mix else [s.speaker_id for s in padded],
                    speaker_mixes=[s.speaker_mix for s in padded] if is_mix else None)
                copy = _HostCopy((audio0, totals))
                encs = [_row_enc(enc, r) for r in range(rows)]
        except Exception:  # noqa: BLE001 — isolate the bad row(s)
            work = []
            for s in chunk:
                work += self._dispatch_head_solo(s)
            return work
        for r, s in enumerate(chunk):
            s.enc, s.seed_u, s.ns = encs[r], seed_vals[r], ns_vals[r]
        self._metrics["head_dispatches"] += 1
        self._metrics["head_rows"] += rows
        self._metrics["padded_head_rows"] += rung - rows
        return [("headb", tuple(chunk), copy)]

    @staticmethod
    def _pad_enc(enc: EncodeResult, p: int) -> EncodeResult:
        """Pad an EncodeResult along the phoneme axis — EXACT: padded
        phonemes have w = w_ceil = 0 and x_mask = 0, so the alignment path
        never selects them. Lets streams from different phoneme buckets
        share one batched window decode. `g` (None for a single-speaker
        voice) and `y_total` are per row and stay as they are."""
        d = p - enc.m_p.shape[-1]
        if d == 0:
            return enc
        return EncodeResult(
            m_p=F.pad(enc.m_p, (0, d)), logs_p=F.pad(enc.logs_p, (0, d)),
            x_mask=F.pad(enc.x_mask, (0, d)), w=F.pad(enc.w, (0, d)),
            w_ceil=F.pad(enc.w_ceil, (0, d)), y_total=enc.y_total, g=enc.g)

    def _dispatch_windows(self, sessions: List[_Session]) -> list:
        """One batched window decode over `sessions` (any mix of phoneme
        buckets — rows pad to the group's largest), its copy queued behind
        it. Padding rows decode row 0's encode from frame _FAR with a
        length of 1 frame: all zero, never read back."""
        rows = len(sessions)
        rung = self._rung(rows)
        pad = rung - rows
        p_group = max(s.enc.m_p.shape[-1] for s in sessions)
        first = sessions[0]
        with self.rt._device_work():
            encs = [self._pad_enc(s.enc, p_group) for s in sessions]
            audio = self.rt.dispatch_window_batch(
                _cat_enc(encs + [encs[0]] * pad),
                [s.seed_u for s in sessions] + [first.seed_u] * pad,
                [s.pos - self.halo for s in sessions] + [_FAR] * pad,
                [s.y_len for s in sessions] + [1] * pad,
                [s.ns for s in sessions] + [first.ns] * pad,
                emit_frames=self.emit_frames, halo=self.halo)
            copy = _HostCopy((audio,))
        self._metrics["window_dispatches"] += 1
        self._metrics["window_rows"] += rows
        self._metrics["padded_rows"] += pad
        return [("window", tuple(sessions), copy)]

    def _emit(self, s: _Session, samples: np.ndarray, final: bool) -> None:
        chunk = AudioChunk(format=self.rt.audio_format, start_sample_index=s.emitted,
                           samples=samples.copy(), is_final=final)
        s.emitted += len(samples)
        if final:
            self._close(s, chunk)
        else:
            s.out.put(chunk)  # bounded: the scheduler never outruns queue_chunks

    def _drop_if_cancelled(self, s: _Session) -> bool:
        """True when this in-flight session should be dropped: cancelled
        (close its slot now) or already failed/closed (do nothing — guards
        double-close when a cancel landed while its work was in flight)."""
        if s.failed:
            return True
        if s.cancelled:
            self._cancel_session(s)
            return True
        return False

    def _process(self, kind: str, target, fetched) -> None:
        """Emit what one dispatch's copy (`fetched`, its host arrays) holds.
        The audio is already in the runtime's output dtype and cut to the
        emitted frames on the device."""
        if kind in ("head", "headb"):
            audio0, totals = fetched
            sessions = (target,) if kind == "head" else target
            totals = np.reshape(totals, -1)
            for r, s in enumerate(sessions):
                if self._drop_if_cancelled(s):
                    continue
                s.y_len = int(totals[r])
                final = s.y_len <= self.c0
                self._emit(s, audio0[r, : s.y_len * self.hop] if final else audio0[r], final)
                if not final:
                    s.pos = self.c0
                    self._active.append(s)
            return
        (audio,) = fetched
        for r, s in enumerate(target):
            if self._drop_if_cancelled(s):
                continue
            take = min(self.emit_frames, s.y_len - s.pos)
            s.pos += take
            final = s.pos >= s.y_len
            self._emit(s, audio[r, : take * self.hop], final)
            if not final:
                self._active.append(s)

    def pending(self) -> bool:
        """True while undelivered work remains: dispatched-but-unfetched
        device results, active sessions, or unprocessed submits. Drives both
        the internal worker's exit condition and UnifiedServer's scheduling
        (a pending stream outranks an unripe batch group)."""
        return bool(self._inflight or self._active or not self._incoming.empty())

    def tick(self) -> bool:
        """One scheduler tick — driver thread only (the internal worker or
        UnifiedServer's). Dispatches new streams' heads and ready sessions'
        batched windows, then waits for the PREVIOUS tick's copies and
        processes them (depth 2: the copy and this processing overlap this
        tick's device work). Never raises: a failure fails every touched
        session (fail open). Returns False when the tick was a no-op
        (nothing to dispatch and nothing in flight) — the driver may
        idle-wait."""
        # Hoisted so the crash handler can always reference this tick's
        # partially-built collections.
        new_work: list = []
        drained: List[_Session] = []
        ready: List[_Session] = []
        try:
            # New streams: dispatch their heads (the TTFB path).
            try:
                while True:
                    drained.append(self._incoming.get_nowait())
            except queue.Empty:
                pass
            if drained:
                new_work += self._dispatch_heads(drained)
            # Active streams with queue room: batched windows. Mixed
            # phoneme buckets batch together (rows pad to the group max);
            # sorting by bucket keeps padding minimal when a group splits
            # across the row cap.
            ready, waiting = [], []
            for s in self._active:
                if s.cancelled:
                    self._cancel_session(s)  # abandoned consumer: decode nothing
                elif s.out.qsize() < self.queue_chunks:
                    ready.append(s)
                else:
                    waiting.append(s)
            self._active = waiting
            ready.sort(key=lambda s: s.enc.m_p.shape[-1], reverse=True)
            max_rows = self.row_rungs[-1]
            for i in range(0, len(ready), max_rows):
                new_work += self._dispatch_windows(ready[i: i + max_rows])
            if not new_work and not self._inflight:
                return False
            # LAST tick's copies, while this tick's work runs (depth 2).
            for kind, target, copy in self._inflight:
                self._process(kind, target, copy.wait())
            self._inflight = new_work
            self._metrics["ticks"] += 1
            return True
        except Exception as e:  # noqa: BLE001 — fail open sessions
            # Fail EVERY session this tick touched: last tick's in-flight
            # work, THIS tick's freshly dispatched work and its
            # drained/ready sources, and everything still waiting.
            # _fail/_close are idempotent via the failed flag.
            for kind, target, _ in list(self._inflight) + list(new_work):
                for s in (target,) if kind == "head" else target:
                    self._fail(s, e)
            self._inflight = []
            for s in list(self._active) + list(ready) + list(drained):
                self._fail(s, e)
            self._active = []
            return True

    def drain(self) -> None:
        """Wait for and process whatever is still in flight WITHOUT
        dispatching new work — the final step of a driver that is
        stopping."""
        inflight, self._inflight = self._inflight, []
        try:
            for kind, target, copy in inflight:
                self._process(kind, target, copy.wait())
        except Exception as e:  # noqa: BLE001
            for kind, target, _ in inflight:
                for s in (target,) if kind == "head" else target:
                    self._fail(s, e)

    def fail_all(self, err: Exception) -> None:
        """Fail every open session (driver crashed — fail open, never hang).
        Idempotent via each session's failed flag."""
        for kind, target, _ in self._inflight:
            for s in (target,) if kind == "head" else target:
                self._fail(s, err)
        self._inflight = []
        for s in self._active:
            self._fail(s, err)
        self._active = []
        while True:
            try:
                s = self._incoming.get_nowait()
            except queue.Empty:
                return
            self._fail(s, err)

    def _run(self) -> None:
        while not (self._stop.is_set() and not self.pending()):
            if self._stop.is_set() and time.monotonic() >= self._stop_deadline:
                # Consumers never drained their queues within the shutdown
                # grace: fail them rather than leak this thread.
                break
            if not self.tick():
                # idle: wait for arrivals without spinning
                try:
                    s0 = self._incoming.get(timeout=self.tick_wait_s)
                    self._incoming.put(s0)
                except queue.Empty:
                    pass
        self.drain()
        if self.pending():
            self.fail_all(RuntimeError("StreamingServer shut down with undrained sessions"))
