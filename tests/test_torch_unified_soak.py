"""Randomized multi-surface soak of the port's UnifiedServer.

Counterpart of tests/test_unified_soak.py: mixed submit kinds (synth,
durations, forced), speaker ids and mixes, chunked streams consumed fully
or cancelled mid-flight, add_voice/remove_voice churn, and admission and
deadline shedding, all against ONE UnifiedServer; it asserts no deadlock
(every future resolves), no thread growth and consistent metrics.

~60 s of churn by default (PIPER_TPU_SOAK_S sets it) on the CPU
(PIPER_TPU_SOAK_DEVICE=cuda runs it on the card). Marked slow, as the
original is, so Tier-1 does not run it. `run_soak` is the body:
chip_smoke.py runs it for 15 s on the card's medium voices at the mixed
tiers; the whole test by hand on the card:

    PIPER_TPU_SOAK_DEVICE=cuda python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_unified_soak.py -q -m slow
"""

import json
import os
import random
import threading
import time

import numpy as np
import pytest

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIX
from piper_tpu_torch.engine.batcher import DeadlineExceeded, ServerOverloaded
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.engine.unified import UnifiedServer

SOAK_S = float(os.environ.get("PIPER_TPU_SOAK_S", "60"))


def _expected(err: BaseException, removed_ok: bool) -> bool:
    if isinstance(err, (ServerOverloaded, DeadlineExceeded)):
        return True  # admission control doing its job
    if isinstance(err, KeyError):
        return removed_ok  # raced a remove_voice
    if isinstance(err, RuntimeError):
        msg = str(err)
        return ("unloaded" in msg or "cancelled" in msg
                or "closed" in msg or "shut down" in msg)
    return False


def run_soak(mono, multi, seconds: float, *, device="cpu", options=None,
             n_speakers: int = 3, seed: int = 20260820, max_batch: int = 4) -> dict:
    """`seconds` of randomized churn on one UnifiedServer over the voices
    `mono` and `multi` ((model, config) paths; multi has `n_speakers`).
    Raises AssertionError on a hang, an unexpected error, a leaked thread
    or inconsistent metrics; returns the counts of what it did."""
    rng = random.Random(seed)

    def runtime(paths):
        return PiperRuntime(*paths, options, device=device)

    srv = UnifiedServer(
        {"mono": runtime(mono), "multi": runtime(multi)},
        max_batch=max_batch, max_wait_ms=5, max_pending=64, deadline_ms=30_000,
        stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2, 4), max_sessions=8))
    t_before = {t.name for t in threading.enumerate()}
    futures, streams, resident_extra = [], [], []
    extra_idx = 0
    stats = {"submits": 0, "streams": 0, "cancels": 0, "adds": 0, "removes": 0, "shed": 0,
             "seconds": seconds}
    deadline = time.monotonic() + seconds

    def consume(handle, errors, cancel_after=None):
        try:
            n = 0
            for _ in handle:
                n += 1
                if cancel_after is not None and n >= cancel_after:
                    handle.cancel()
                    return
            if n == 0:
                errors.append("empty stream")
        except Exception as e:  # noqa: BLE001 — judged at the end
            if not _expected(e, removed_ok=True):
                errors.append(repr(e))

    try:
        while time.monotonic() < deadline:
            voice = rng.choice(["mono", "multi"] + resident_extra)
            ids = list(FIX)[: rng.choice((6, 10, 14))]
            kwargs = {}
            if voice == "multi":
                if rng.random() < 0.5:
                    kwargs["speaker_id"] = rng.randrange(n_speakers)
                elif rng.random() < 0.3:
                    kwargs["speaker_mix"] = {0: 0.5, n_speakers - 1: 0.5}
            op = rng.random()
            try:
                if op < 0.45:
                    futures.append(("synth", voice, srv.submit(voice, ids, **kwargs)))
                    stats["submits"] += 1
                elif op < 0.60:
                    futures.append(("dur", voice,
                                    srv.submit_durations(voice, ids, **kwargs)))
                    stats["submits"] += 1
                elif op < 0.70:
                    futures.append(("forced", voice, srv.submit_forced(
                        voice, ids, [2] * len(ids), **kwargs)))
                    stats["submits"] += 1
                elif op < 0.90:
                    h = srv.submit_stream(voice, ids, **kwargs)
                    errors: list = []
                    cancel = rng.choice((None, None, None, 1, 2))
                    t = threading.Thread(target=consume, args=(h, errors, cancel), daemon=True)
                    t.start()
                    streams.append((voice, t, errors))
                    stats["streams"] += 1
                    stats["cancels"] += cancel is not None
                elif op < 0.95 and len(resident_extra) < 2:
                    key = f"extra{extra_idx}"
                    extra_idx += 1
                    futures.append(("add", key, srv.add_voice(
                        key, runtime(mono), prewarm=False, stream_prewarm=False)))
                    resident_extra.append(key)
                    stats["adds"] += 1
                elif resident_extra:
                    key = resident_extra.pop(rng.randrange(len(resident_extra)))
                    futures.append(("remove", key,
                                    srv.remove_voice(key, close_runtime=True)))
                    stats["removes"] += 1
            except (ServerOverloaded, KeyError):
                stats["shed"] += 1
            except RuntimeError as e:
                if not _expected(e, removed_ok=True):
                    raise
            time.sleep(rng.random() * 0.02)

        # Drain: every future must resolve (a result or an expected error);
        # a hang here is the deadlock this soak exists to catch.
        unexpected = []
        for kind, voice, fut in futures:
            try:
                r = fut.result(timeout=600)
                if kind in ("synth", "forced"):
                    assert np.asarray(r).size > 0
            except Exception as e:  # noqa: BLE001
                if not _expected(e, True):
                    unexpected.append((kind, voice, repr(e)))
        assert not unexpected, unexpected[:5]
        for voice, t, errors in streams:
            t.join(timeout=600)
            assert not t.is_alive(), "stream consumer wedged"
            assert not errors, (voice, errors[:3])
        m = srv.metrics()
        stats["served_rows"] = sum(v["rows"] for v in m["batch"].values())
        assert stats["served_rows"] > 0
        assert all(v["queue_depth"] == 0 for v in m["batch"].values())
    finally:
        srv.close()

    # No thread growth: every piper-* worker is gone.
    leaked = []
    end = time.monotonic() + 10
    while time.monotonic() < end:
        leaked = [t.name for t in threading.enumerate() if t.name.startswith("piper-")]
        if not leaked:
            break
        time.sleep(0.1)
    assert not leaked, leaked
    t_after = {t.name for t in threading.enumerate()} - t_before
    assert not any(n.startswith("piper-") for n in t_after)
    return stats


@pytest.mark.slow
def test_unified_randomized_soak(tmp_path_factory):
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    d = tmp_path_factory.mktemp("soak_voices")
    mono = make_synthetic_voice(d / "mono", quality="test", seed=1)
    multi = make_synthetic_voice(d / "multi", quality="test", seed=2, n_speakers=3)
    device = os.environ.get("PIPER_TPU_SOAK_DEVICE", "cpu")
    stats = run_soak(mono, multi, SOAK_S, device=device)
    print(json.dumps({"soak": stats, "device": device}))  # shown under pytest -s
    assert stats["submits"] > 20 and stats["streams"] > 5, stats
