"""The port's HTTP door (piper_tpu_torch.engine.http_server and the serving
CLI), on the CPU.

- Every case of tests/test_http_server.py under its own name, on the port's
  PiperHTTPServer and PiperStreamingHTTPServer over runtimes at
  device="cpu"; the two CLI cases run `python -m piper_tpu_torch.cli
  --serve --device cpu` (the JAX suite marks two of them slow; here they
  run, at the same size).
- Every case of tests/test_http_fuzz.py (malformed input against every
  endpoint of a stream=True server), and the HTTP and SSML cases of
  tests/test_speaker_names.py with the resolver cases that
  tests/test_torch_speakers.py does not hold.
- The port's server against the JAX package's on the same voice at zero
  noise (seeds cannot match across the two packages' generators): PCM
  within 1e-4 + 1/32767, equal /v1/durations JSON and /v1/voices, and
  equal status codes over a table of malformed bodies.
- The thread rule: no handler thread ever runs the runtime's device work.
- The CLI's serve mode wins over the other modes' flags, as in the JAX
  CLI, and it defaults to the card; without --serve it runs the mode it
  was called for (tests/test_torch_cli.py holds those modes).

Torch runs one intra-op thread in this module (see
tests/test_torch_stream_server.py).
"""

import contextlib
import http.client
import json
import os
import socket
import stat
import struct
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.http_server import PiperHTTPServer, _wav_bytes
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli_env():
    """The CLI subprocess's environment: the checkout importable, one torch
    thread, and no PIPER_TPU_* option flags from the caller's shell."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIPER_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [os.environ.get(
        "PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


# -- tests/test_http_server.py on the port -------------------------------------




@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("http_voices")
    m1, _ = make_synthetic_voice(d / "a", quality="test", seed=1,
                                 voice_name="alpha")
    m2, _ = make_synthetic_voice(d / "b", quality="test", seed=2,
                                 voice_name="beta")
    srv = PiperHTTPServer(
        {"alpha": PiperRuntime(m1, device="cpu"), "beta": PiperRuntime(m2, device="cpu")},
        port=0, max_batch=4, max_wait_ms=10)
    srv.start()
    yield srv
    srv.close()


def _request(server, method, path, body=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=600)
    try:
        conn.request(method, path,
                     body=json.dumps(body).encode() if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, resp.getheader("Content-Type"), data
    finally:
        conn.close()


def test_healthz_and_voices(server):
    st, _, data = _request(server, "GET", "/healthz")
    assert st == 200 and json.loads(data)["ok"]
    st, _, data = _request(server, "GET", "/v1/voices")
    voices = json.loads(data)
    assert set(voices) == {"alpha", "beta"}
    assert voices["alpha"]["sample_rate"] > 0


def test_synthesize_wav(server):
    st, ctype, data = _request(server, "POST", "/v1/synthesize",
                               {"phoneme_ids": list(FIXTURE_IDS)})
    assert st == 200 and ctype == "audio/wav"
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    n = struct.unpack("<I", data[40:44])[0]
    assert n > 0 and len(data) == 44 + n


def test_synthesize_pcm_and_voice_routing(server):
    st, ctype, data = _request(
        server, "POST", "/v1/synthesize",
        {"voice": "beta", "phoneme_ids": list(FIXTURE_IDS), "format": "pcm"})
    assert st == 200 and ctype == "audio/x-raw-int16"
    pcm = np.frombuffer(data, "<i2")
    assert len(pcm) > 0 and np.isfinite(pcm.astype(np.float32)).all()


def test_synthesize_ipa(server):
    st, ctype, data = _request(server, "POST", "/v1/synthesize",
                               {"ipa": "ab"})
    assert st == 200 and ctype == "audio/wav"


def test_synthesize_text_multi_sentence(server, tmp_path, monkeypatch):
    script = tmp_path / "espeak-ng"
    script.write_text("#!/bin/sh\necho 'ab'\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: str(script))
    st, _, one = _request(server, "POST", "/v1/synthesize",
                          {"text": "Hi there.", "format": "pcm"})
    assert st == 200
    st, _, two = _request(
        server, "POST", "/v1/synthesize",
        {"text": "Hi there. Hi there.", "format": "pcm",
         "sentence_silence": 0.5})
    assert st == 200
    rt = server.runtimes["alpha"]
    # two sentences + a 0.5 s gap: strictly longer than twice one sentence
    assert len(two) >= 2 * len(one) + int(0.5 * rt.sample_rate) * 2 - 4


def test_errors(server):
    st, _, data = _request(server, "POST", "/v1/synthesize",
                           {"voice": "nope", "phoneme_ids": [1, 2]})
    assert st == 404
    st, _, data = _request(server, "POST", "/v1/synthesize", {})
    assert st == 400
    st, _, data = _request(server, "POST", "/v1/synthesize",
                           {"phoneme_ids": "not-a-list"})
    assert st == 400
    st, _, data = _request(server, "GET", "/v1/nope")
    assert st == 404
    st, _, data = _request(server, "POST", "/v1/synthesize",
                           {"phoneme_ids": [999999]})
    assert st in (400, 500)  # out-of-vocab rejected


def test_metrics_counts(server):
    st, _, data = _request(server, "GET", "/v1/metrics")
    assert st == 200
    m = json.loads(data)
    assert set(m) == {"alpha", "beta"}
    assert m["alpha"]["completed"] >= 1


def test_wav_bytes_roundtrip(tmp_path):
    audio = np.sin(np.linspace(0, 20, 500)).astype(np.float32) * 0.5
    blob = _wav_bytes(audio, 22050)
    p = tmp_path / "t.wav"
    p.write_bytes(blob)
    from piper_tpu_torch.utils.wav import read_wav

    back, sr = read_wav(str(p))
    assert sr == 22050
    np.testing.assert_allclose(back, audio, atol=1e-4)


def test_admission_shed_maps_to_429(tmp_path_factory):
    d = tmp_path_factory.mktemp("http_shed")
    m, _ = make_synthetic_voice(d, quality="test", seed=3)
    # max_pending=0: every request sheds at the door -> HTTP 429
    with PiperHTTPServer({"v": PiperRuntime(m, device="cpu")}, port=0,
                         max_pending=0) as srv:
        srv.start()
        st, _, data = _request(srv, "POST", "/v1/synthesize",
                               {"phoneme_ids": list(FIXTURE_IDS)})
        assert st == 429
        assert "pending" in json.loads(data)["error"]


def test_close_without_start_does_not_hang(tmp_path_factory):
    """httpd.shutdown() deadlocks when serve_forever never
    ran; close() must return promptly for a constructed-but-never-started
    server (e.g. a `with` body failing before start())."""
    import threading

    d = tmp_path_factory.mktemp("http_nostart")
    m, _ = make_synthetic_voice(d, quality="test", seed=5)
    srv = PiperHTTPServer({"v": PiperRuntime(m, device="cpu")}, port=0)
    done = threading.Event()

    def closer():
        srv.close()
        done.set()

    t = threading.Thread(target=closer, daemon=True)
    t.start()
    assert done.wait(timeout=30), "close() hung without serve_forever"


def test_bad_content_length_and_negative_silence(server, tmp_path,
                                                 monkeypatch):
    # negative Content-Length -> 400 (never read-to-EOF)
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    try:
        conn.putrequest("POST", "/v1/synthesize")
        conn.putheader("Content-Length", "-1")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
    finally:
        conn.close()
    # negative sentence_silence -> 400 with a clear message
    script = tmp_path / "espeak-ng"
    script.write_text("#!/bin/sh\necho 'ab'\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: str(script))
    st, _, data = _request(server, "POST", "/v1/synthesize",
                           {"text": "One two. Three four.",
                            "sentence_silence": -1})
    assert st == 400
    assert "sentence_silence" in json.loads(data)["error"]


def test_http_concurrent_clients_soak(server):
    """20 client threads x 5 requests against the shared server: every
    response is a valid WAV, no handler thread wedges, metrics reconcile."""
    import threading

    errors = []
    lock = threading.Lock()

    def client(seed):
        for i in range(5):
            st, ctype, data = _request(
                server, "POST", "/v1/synthesize",
                {"voice": "alpha" if (seed + i) % 2 else "beta",
                 "phoneme_ids": list(FIXTURE_IDS)[: 6 + (seed + i) % 8]})
            if st != 200 or data[:4] != b"RIFF":
                with lock:
                    errors.append((st, ctype, data[:80]))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(20)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]


def test_cli_serve_multiple_models(tmp_path_factory):
    """`piper --serve --model a.onnx,b.onnx` hosts both voices in one
    process (subprocess test: parse the bound port from stderr, hit
    /v1/voices, shut down)."""
    import os
    import re
    import subprocess
    import sys
    import time as _time

    d = tmp_path_factory.mktemp("serve_cli")
    m1, _ = make_synthetic_voice(d / "a", quality="test", seed=1,
                                 voice_name="serve-a")
    m2, _ = make_synthetic_voice(d / "b", quality="test", seed=2,
                                 voice_name="serve-b")
    proc = subprocess.Popen(
        [sys.executable, "-m", "piper_tpu_torch.cli", "--serve", "--port", "0",
         "--model", f"{m1},{m2}", "--device", "cpu"],
        stderr=subprocess.PIPE, text=True, env=_cli_env(), cwd=ROOT)
    try:
        port = None
        deadline = _time.time() + 120
        while _time.time() < deadline:
            line = proc.stderr.readline()
            m = re.search(r"http://[\d.]+:(\d+)", line or "")
            if m:
                port = int(m.group(1))
                break
            if proc.poll() is not None:
                raise AssertionError("serve process exited early")
        assert port, "no serving banner seen"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/v1/voices")
        resp = conn.getresponse()
        voices = json.loads(resp.read())
        conn.close()
        assert set(voices) == {m1.stem, m2.stem}
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_serve_sigterm_drains(tmp_path_factory):
    """SIGTERM (orchestrator stop) drains like Ctrl-C: the serve process
    announces the drain and exits 0 instead of dying mid-flight."""
    import os
    import re
    import signal as _signal
    import subprocess
    import sys
    import time as _time

    d = tmp_path_factory.mktemp("serve_term")
    m, _ = make_synthetic_voice(d, quality="test", seed=1,
                                voice_name="serve-term")
    proc = subprocess.Popen(
        [sys.executable, "-m", "piper_tpu_torch.cli", "--serve", "--port", "0",
         "--model", str(m), "--device", "cpu"],
        stderr=subprocess.PIPE, text=True, env=_cli_env(), cwd=ROOT)
    try:
        port = None
        deadline = _time.time() + 120
        lines = []
        while _time.time() < deadline:
            line = proc.stderr.readline()
            lines.append(line)
            mm = re.search(r"http://[\d.]+:(\d+)", line or "")
            if mm:
                port = int(mm.group(1))
                break
            if proc.poll() is not None:
                raise AssertionError(f"serve exited early: {lines}")
        assert port, "no serving banner seen"
        # one request through, so the server demonstrably served traffic
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/v1/synthesize",
                     body=json.dumps({"phoneme_ids": list(FIXTURE_IDS)}),
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 200
        conn.close()
        proc.send_signal(_signal.SIGTERM)
        out = proc.stderr.read()
        assert proc.wait(timeout=60) == 0
        assert "draining" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# -- chunked streaming server --------------------------------------------


def test_streaming_http_server(tmp_path_factory):
    """POST /v1/stream returns chunked int16 PCM; same seed twice is
    deterministic, and the chunk cadence delivers the full waveform."""
    from piper_tpu_torch.engine.http_server import PiperStreamingHTTPServer

    d = tmp_path_factory.mktemp("http_stream")
    m, _ = make_synthetic_voice(d, quality="test", seed=6)
    with PiperStreamingHTTPServer(PiperRuntime(m, device="cpu"), port=0) as srv:
        srv.start()

        def stream(body):
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
            try:
                conn.request("POST", "/v1/stream", body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()  # http.client decodes chunked transfer
                return resp, data
            finally:
                conn.close()

        resp, a = stream({"phoneme_ids": list(FIXTURE_IDS), "seed": 7})
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "audio/x-raw-int16"
        assert int(resp.getheader("X-Sample-Rate")) > 0
        pcm = np.frombuffer(a, "<i2")
        assert len(pcm) > 0
        _, b = stream({"phoneme_ids": list(FIXTURE_IDS), "seed": 7})
        assert a == b  # deterministic per seed
        # a document with nothing to speak is a clean 400 (the handler's
        # no-utterance branch is additionally hardened so a future input
        # path yielding zero utterances streams its gaps instead of
        # raising bare StopIteration and dropping the connection)
        resp, err = stream({"ssml": "<speak><break time='120ms'/></speak>"})
        assert resp.status == 400
        assert "nothing to speak" in json.loads(err)["error"]
        # validation errors come back as JSON before any audio
        resp, err = stream({"phoneme_ids": []})
        assert resp.status == 400
        resp, err = stream({"phoneme_ids": list(FIXTURE_IDS),
                            "sentence_silence": -1, "text": "x"})
        assert resp.status == 400
        # health + metrics routes
        st, _, data = _request(srv, "GET", "/healthz")
        assert st == 200
        st, _, data = _request(srv, "GET", "/v1/metrics")
        assert st == 200 and json.loads(data)["sessions"] >= 2


def test_openai_alias_and_prometheus(server, tmp_path, monkeypatch):
    script = tmp_path / "espeak-ng"
    script.write_text("#!/bin/sh\necho 'ab'\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: str(script))
    st, ctype, data = _request(
        server, "POST", "/v1/audio/speech",
        {"model": "tts-1", "voice": "beta", "input": "Hello there.",
         "speed": 1.25})
    assert st == 200 and ctype == "audio/wav" and data[:4] == b"RIFF"
    st, ctype, data = _request(
        server, "POST", "/v1/audio/speech",
        {"input": "Hi.", "response_format": "pcm"})
    assert st == 200 and ctype == "audio/x-raw-int16"
    st, ctype, data = _request(server, "GET", "/metrics")
    assert st == 200 and ctype.startswith("text/plain")
    text = data.decode()
    assert 'piper_tpu_completed{voice="alpha"}' in text
    assert "# TYPE piper_tpu_completed gauge" in text


def test_streaming_http_disconnect_frees_session(tmp_path_factory):
    """A client that drops the connection mid-stream must not leak its
    session slot (abandoned streams would park forever and
    eventually make every new stream ServerOverloaded)."""
    import socket
    import time as _t

    from piper_tpu_torch.engine.http_server import PiperStreamingHTTPServer

    d = tmp_path_factory.mktemp("http_drop")
    m, _ = make_synthetic_voice(d, quality="test", seed=7)
    with PiperStreamingHTTPServer(PiperRuntime(m, device="cpu"), port=0,
                                  max_sessions=2, emit_frames=16,
                                  c0=8) as srv:
        srv.start()
        for _ in range(4):  # more drops than max_sessions
            body = json.dumps({"phoneme_ids": list(FIXTURE_IDS) * 4}).encode()
            sock = socket.create_connection((srv.host, srv.port), timeout=60)
            sock.sendall(
                b"POST /v1/stream HTTP/1.1\r\nHost: x\r\n"
                b"Content-Type: application/json\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            sock.recv(256)  # headers + maybe the first chunk
            sock.close()  # walk away mid-stream
        deadline = _t.time() + 60
        while _t.time() < deadline:
            if srv.server.metrics()["open_sessions"] == 0:
                break
            _t.sleep(0.05)
        assert srv.server.metrics()["open_sessions"] == 0
        # server still serves a full stream afterwards
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
        conn.request("POST", "/v1/stream",
                     body=json.dumps({"phoneme_ids": list(FIXTURE_IDS)}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        assert resp.status == 200 and len(data) > 0


def test_int16_runtime_audio_not_saturated(tmp_path_factory):
    """An output_dtype='int16' runtime (the bench/serving
    default) fed int16-scale values into the float WAV/PCM encoders, which
    clipped EVERY sample to +/-32767 — the response was a square wave. The
    HTTP path must normalize; the PCM response must equal the runtime's own
    int16 output."""
    from piper_tpu_torch.engine.runtime import RuntimeOptions

    d = tmp_path_factory.mktemp("http_i16")
    m, _ = make_synthetic_voice(d, quality="test", seed=8)
    rt = PiperRuntime(m, None, RuntimeOptions(output_dtype="int16"), device="cpu")
    with PiperHTTPServer({"v": rt}, port=0, max_wait_ms=5) as srv:
        srv.start()
        st, ctype, data = _request(
            srv, "POST", "/v1/synthesize",
            {"phoneme_ids": list(FIXTURE_IDS), "format": "pcm"})
        assert st == 200
        pcm = np.frombuffer(data, "<i2").astype(np.int32)
        assert len(pcm) > 0
        # a healthy tiny voice's PCM is NOT all rail-to-rail values
        assert np.abs(pcm).max() < 32767 or np.abs(pcm).mean() < 20000
        assert len(np.unique(pcm)) > 16


def test_durations_endpoint(server):
    st, ctype, data = _request(server, "POST", "/v1/durations",
                               {"phoneme_ids": list(FIXTURE_IDS)})
    assert st == 200 and ctype == "application/json"
    doc = json.loads(data)
    assert doc["voice"] == "alpha" and doc["sample_rate"] > 0
    (utt,) = doc["utterances"]
    phs = utt["phonemes"]
    assert [p["id"] for p in phs] == list(FIXTURE_IDS)
    assert phs[0]["start_sample"] == 0
    assert all(a["end_sample"] == b["start_sample"]
               for a, b in zip(phs, phs[1:]))
    # spans describe the audio /v1/synthesize returns for the same request
    st, _, wav = _request(server, "POST", "/v1/synthesize",
                          {"phoneme_ids": list(FIXTURE_IDS)})
    assert st == 200
    n = struct.unpack("<I", wav[40:44])[0] // 2  # int16 samples
    assert phs[-1]["end_sample"] == n == doc["total_samples"]


def test_durations_endpoint_errors(server):
    st, _, data = _request(server, "POST", "/v1/durations",
                           {"voice": "nope", "phoneme_ids": [1]})
    assert st == 404
    st, _, data = _request(server, "POST", "/v1/durations", {})
    assert st == 400
    st, _, data = _request(server, "POST", "/v1/durations",
                           {"phoneme_ids": [1], "sentence_silence": -1})
    assert st == 400


def test_durations_endpoint_reports_truncation(tmp_path_factory):
    """When the plan exceeds the largest frame bucket, the alignment doc
    must clip spans to the audio the runtime actually produces and say
    truncated=True (the raw plan would silently desync
    subtitle offsets)."""
    from piper_tpu_torch.engine.runtime import RuntimeOptions

    d = tmp_path_factory.mktemp("http_trunc")
    m, _ = make_synthetic_voice(d, quality="test", seed=5)
    rt = PiperRuntime(m, options=RuntimeOptions(frame_buckets=(8,)), device="cpu")
    with PiperHTTPServer({"t": rt}, port=0, max_batch=2,
                         max_wait_ms=10) as srv:
        srv.start()
        st, _, data = _request(srv, "POST", "/v1/durations",
                               {"phoneme_ids": list(FIXTURE_IDS)})
        assert st == 200
        doc = json.loads(data)
        (utt,) = doc["utterances"]
        cap = 8 * rt.hparams.hop_length
        assert utt["truncated"] is True
        assert utt["total_samples"] == cap
        assert max(p["end_sample"] for p in utt["phonemes"]) == cap
        # ... and that's exactly the audio length the server synthesizes
        st, _, wav = _request(srv, "POST", "/v1/synthesize",
                              {"phoneme_ids": list(FIXTURE_IDS)})
        assert st == 200
        n = struct.unpack("<I", wav[40:44])[0] // 2
        assert n == cap == doc["total_samples"]


def test_unified_http_all_surfaces_one_process(tmp_path_factory):
    """PiperHTTPServer(stream=True): ONE process serves /v1/synthesize,
    /v1/durations AND chunked /v1/stream for MULTIPLE voices on a single
    device worker. Streamed audio equals the dedicated
    streaming server's for the same seed (same decode path)."""
    d = tmp_path_factory.mktemp("http_unified")
    m1, _ = make_synthetic_voice(d / "a", quality="test", seed=1,
                                 voice_name="alpha")
    m2, _ = make_synthetic_voice(d / "b", quality="test", seed=2,
                                 voice_name="beta")
    rt1, rt2 = PiperRuntime(m1, device="cpu"), PiperRuntime(m2, device="cpu")
    with PiperHTTPServer({"alpha": rt1, "beta": rt2}, port=0,
                         max_batch=4, max_wait_ms=5, stream=True,
                         stream_kwargs=dict(emit_frames=16, c0=8,
                                            row_rungs=(1, 2, 4))) as srv:
        srv.start()

        def stream(body):
            conn = http.client.HTTPConnection(srv.host, srv.port,
                                              timeout=600)
            try:
                conn.request("POST", "/v1/stream", body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, resp.getheader("Content-Type"), \
                    resp.read()
            finally:
                conn.close()

        # healthz carries readiness
        st, _, data = _request(srv, "GET", "/healthz")
        h = json.loads(data)
        assert st == 200 and h["ok"] and "ready" in h and "warming" in h
        # batch + durations endpoints work as before
        st, ctype, wav = _request(srv, "POST", "/v1/synthesize",
                                  {"phoneme_ids": list(FIXTURE_IDS),
                                   "voice": "beta"})
        assert st == 200 and ctype == "audio/wav"
        st, _, doc = _request(srv, "POST", "/v1/durations",
                              {"phoneme_ids": list(FIXTURE_IDS)})
        assert st == 200 and json.loads(doc)["utterances"]
        # chunked streaming per voice, deterministic per seed, and the
        # audio matches the library-level stream for that voice exactly
        st, ctype, a = stream({"phoneme_ids": list(FIXTURE_IDS),
                               "voice": "alpha", "seed": 7})
        assert st == 200 and ctype == "audio/x-raw-int16"
        st, _, a2 = stream({"phoneme_ids": list(FIXTURE_IDS),
                            "voice": "alpha", "seed": 7})
        assert a == a2 and len(a) > 0
        st, _, b = stream({"phoneme_ids": list(FIXTURE_IDS),
                           "voice": "beta", "seed": 7})
        assert st == 200 and b != a  # routed to the other voice's weights
        st, _, err = stream({"phoneme_ids": list(FIXTURE_IDS),
                             "voice": "nope"})
        assert st == 404
        # concurrent mixed load: a stream mid-flight while batch requests
        # run on the same worker — both complete
        import threading as _t

        out = {}

        def bg():
            out["s"] = stream({"phoneme_ids": list(FIXTURE_IDS) * 3,
                               "voice": "alpha", "seed": 9})

        th = _t.Thread(target=bg)
        th.start()
        st, _, _ = _request(srv, "POST", "/v1/synthesize",
                            {"phoneme_ids": list(FIXTURE_IDS)})
        assert st == 200
        th.join(timeout=600)
        assert out["s"][0] == 200 and len(out["s"][2]) > 0
        # nested metrics shape + Prometheus flattening
        st, _, mdata = _request(srv, "GET", "/v1/metrics")
        m = json.loads(mdata)
        assert set(m) == {"batch", "stream", "warming"}
        assert m["stream"]["alpha"]["sessions"] >= 3
        st, _, prom = _request(srv, "GET", "/metrics")
        text = prom.decode()
        assert 'piper_tpu_completed{voice="alpha"}' in text
        assert 'piper_tpu_stream_sessions{voice="alpha"}' in text


def test_non_stream_server_404s_stream_route(server):
    st, _, data = _request(server, "POST", "/v1/stream",
                           {"phoneme_ids": list(FIXTURE_IDS)})
    assert st == 404 and "not enabled" in json.loads(data)["error"]


# -- tests/test_http_fuzz.py on the port ------------------------------------------
#
# Adversarial clients — truncated bodies, lying Content-Length, huge JSON,
# invalid UTF-8, non-object JSON, unknown routes/methods, raw garbage — must
# each get a clean 4xx (or connection close) and must never wedge a handler
# thread or take the worker down: after the whole barrage, a good request
# still returns 200 audio.

FIX = FIXTURE_IDS


@pytest.fixture(scope="module")
def fuzz_server(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz_voices")
    m, _ = make_synthetic_voice(d, quality="test", seed=7, voice_name="v")
    srv = PiperHTTPServer({"v": PiperRuntime(m, device="cpu")}, port=0, stream=True,
                          max_batch=4, max_wait_ms=5)
    srv.start()
    yield srv
    srv.close()


POST_ENDPOINTS = ("/v1/synthesize", "/v1/durations", "/v1/audio/speech",
                  "/v1/stream")
GET_ENDPOINTS = ("/healthz", "/v1/voices", "/v1/metrics", "/metrics")


def _post(fuzz_server, path, body: bytes, headers=None, timeout=60):
    conn = http.client.HTTPConnection(fuzz_server.host, fuzz_server.port,
                                      timeout=timeout)
    try:
        conn.putrequest("POST", path)
        for k, v in (headers or {"Content-Length": str(len(body)),
                                 "Content-Type": "application/json"}).items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data
    finally:
        conn.close()


def _good_request_still_serves(fuzz_server):
    st, data = _post(fuzz_server, "/v1/synthesize",
                     json.dumps({"voice": "v",
                                 "phoneme_ids": list(FIX)}).encode())
    assert st == 200 and data[:4] == b"RIFF", (st, data[:60])


def test_invalid_utf8_body(fuzz_server):
    for path in POST_ENDPOINTS:
        st, data = _post(fuzz_server, path, b"\xff\xfe{\x80garbage\xff")
        assert st == 400, (path, st, data[:120])
    _good_request_still_serves(fuzz_server)


def test_non_object_json(fuzz_server):
    for path in POST_ENDPOINTS:
        for body in (b"[1, 2, 3]", b'"a string"', b"42", b"null"):
            st, _ = _post(fuzz_server, path, body)
            assert st == 400, (path, body)
    _good_request_still_serves(fuzz_server)


def test_huge_json_rejected_413(fuzz_server):
    # Declared > 16 MiB: rejected up front without reading the body.
    st, data = _post(fuzz_server, "/v1/synthesize", b"",
                     headers={"Content-Length": str(64 << 20),
                              "Content-Type": "application/json"})
    assert st == 413, (st, data[:120])
    _good_request_still_serves(fuzz_server)


def test_wrong_content_length_too_small(fuzz_server):
    # Content-Length shorter than the real body: the handler reads N bytes
    # (a JSON prefix) -> 400; the tail is discarded with the connection.
    body = json.dumps({"voice": "v", "phoneme_ids": list(FIX)}).encode()
    st, _ = _post(fuzz_server, "/v1/synthesize", body,
                  headers={"Content-Length": "5",
                           "Content-Type": "application/json"})
    assert st == 400
    _good_request_still_serves(fuzz_server)


def test_truncated_body_client_hangup(fuzz_server):
    """Content-Length promises more than the client sends before closing:
    the handler's bounded read sees EOF, fails JSON parse, and the thread
    exits — no wedge, no worker impact."""
    for path in POST_ENDPOINTS:
        s = socket.create_connection((fuzz_server.host, fuzz_server.port), timeout=60)
        try:
            head = (f"POST {path} HTTP/1.1\r\n"
                    f"Host: x\r\nContent-Type: application/json\r\n"
                    f"Content-Length: 5000\r\n\r\n").encode()
            s.sendall(head + b'{"voice": "v", "phoneme')
        finally:
            s.close()  # hang up mid-body
    _good_request_still_serves(fuzz_server)


def test_header_only_hangup(fuzz_server):
    # Close immediately after the request line — stdlib fuzz_server must just
    # drop the connection.
    s = socket.create_connection((fuzz_server.host, fuzz_server.port), timeout=60)
    s.sendall(b"POST /v1/synthesize HTTP/1.1\r\n")
    s.close()
    _good_request_still_serves(fuzz_server)


def test_raw_garbage_connection(fuzz_server):
    s = socket.create_connection((fuzz_server.host, fuzz_server.port), timeout=60)
    try:
        s.sendall(b"\x00\x01\x02 NOT HTTP AT ALL \xff\xff\r\n\r\n")
        s.settimeout(60)
        try:
            s.recv(256)  # 400 or close — either is fine
        except OSError:
            pass
    finally:
        s.close()
    _good_request_still_serves(fuzz_server)


def test_unknown_routes_and_methods(fuzz_server):
    st, _ = _post(fuzz_server, "/v1/nope", b"{}")
    assert st == 404
    conn = http.client.HTTPConnection(fuzz_server.host, fuzz_server.port, timeout=60)
    try:
        conn.request("DELETE", "/v1/synthesize")
        assert conn.getresponse().status in (404, 501)
    finally:
        conn.close()
    for path in GET_ENDPOINTS:
        conn = http.client.HTTPConnection(fuzz_server.host, fuzz_server.port,
                                          timeout=60)
        try:
            conn.request("GET", path)
            assert conn.getresponse().status == 200, path
        finally:
            conn.close()
    _good_request_still_serves(fuzz_server)


def test_adversarial_field_values(fuzz_server):
    """Schema-shaped but hostile payloads: every one a 4xx, never a 500."""
    cases = [
        {"voice": "v", "phoneme_ids": []},
        {"voice": "v", "phoneme_ids": ["a", "b"]},
        {"voice": "v", "phoneme_ids": [0.5]},
        {"voice": "v", "phoneme_ids": list(FIX), "speaker_id": 99},
        {"voice": "v", "phoneme_ids": list(FIX), "speaker_mix": {"0": "x"}},
        {"voice": "v", "phoneme_ids": list(FIX), "speaker_mix": {}},
        {"voice": "v", "phoneme_ids": list(FIX), "length_scale": "loud"},
        {"voice": "v", "phoneme_ids": list(FIX), "length_scale": -1},
        {"voice": "v", "phoneme_ids": list(FIX), "length_scale": 0},
        {"voice": "v", "phoneme_ids": list(FIX), "noise_w": float("nan")},
        {"voice": "nope", "phoneme_ids": list(FIX)},
        {"voice": "v", "ssml": "<speak><voice name='ghost'>"
                               "<phoneme ph='a'>x</phoneme></voice></speak>"},
        {"voice": "v", "ssml": "<speak><unclosed></speak"},
        {"voice": "v", "text": ""},
        {"voice": "v"},
        # NOTE: {"phoneme_ids": [...]} without "voice" is NOT here — with
        # exactly one voice loaded the fuzz_server intentionally defaults to it.
    ]
    # synthesize-only hostile values: fields /v1/durations ignores by
    # design (noise_scale does not affect the duration plan).
    synth_only = [
        {"voice": "v", "phoneme_ids": list(FIX), "noise_scale": "loud"},
        {"voice": "v", "phoneme_ids": list(FIX), "noise_scale": -2},
        # duration forcing (the "durations" field) only exists on
        # /v1/synthesize; /v1/durations ignores it and returns the plan.
        {"voice": "v", "phoneme_ids": list(FIX),
         "durations": [1] * (len(FIX) + 3)},
        {"voice": "v", "phoneme_ids": list(FIX), "durations": [-1] * len(FIX)},
    ]
    for path in ("/v1/synthesize", "/v1/durations"):
        for body in cases:
            st, data = _post(fuzz_server, path, json.dumps(body).encode())
            assert 400 <= st < 500, (path, body, st, data[:200])
    for body in synth_only:
        st, data = _post(fuzz_server, "/v1/synthesize", json.dumps(body).encode())
        assert 400 <= st < 500, (body, st, data[:200])
    _good_request_still_serves(fuzz_server)


def test_text_without_phonemizer_is_501(fuzz_server, monkeypatch):
    """No espeak-ng: a text/SSML-text request is a capability
    gap (501 with an actionable message), never a 500 internal error."""
    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: None)
    for body in ({"voice": "v", "text": "Hello there."},
                 {"voice": "v", "ssml": "<speak>Hello there.</speak>"}):
        st, data = _post(fuzz_server, "/v1/synthesize",
                         json.dumps(body).encode())
        assert st == 501, (body, st, data[:200])
        assert b"phoneme ids" in data.lower() or b"espeak" in data.lower()


# -- tests/test_speaker_names.py's HTTP and SSML cases on the port ---------------


@pytest.fixture(scope="module")
def ms_voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("names_voice")
    return make_synthetic_voice(d, quality="test", seed=6, n_speakers=4, gin_channels=32)


@pytest.fixture(scope="module")
def ms_runtime(ms_voice):
    return PiperRuntime(*ms_voice, device="cpu")


def test_speaker_index_resolution(ms_runtime):
    runtime = ms_runtime
    assert runtime.speaker_index("spk2") == 2
    assert runtime.speaker_index(3) == 3
    assert runtime.speaker_index("1") == 1  # digit strings parse as ids
    with pytest.raises(ValueError):
        runtime.speaker_index("nobody")
    with pytest.raises(ValueError):
        runtime.speaker_index(9)
    with pytest.raises(ValueError):
        runtime.speaker_index(True)


def test_resolve_speaker_mix(ms_runtime):
    assert ms_runtime.resolve_speaker_mix({"spk0": 0.5, "spk3": 0.5}) == {0: 0.5, 3: 0.5}
    with pytest.raises(ValueError):
        # name and its id collide after resolution — a silent last-write-
        # wins would drop a weight
        ms_runtime.resolve_speaker_mix({"spk2": 0.5, 2: 0.5})


def test_http_speaker_by_name(ms_voice):
    srv = PiperHTTPServer({"v": PiperRuntime(*ms_voice, device="cpu")}, port=0,
                          max_batch=4, max_wait_ms=10)
    srv.start()

    def post(path, body):
        st, _, data = _request(srv, "POST", path, body)
        return st, data

    try:
        st, _, data = _request(srv, "GET", "/v1/voices")
        voices = json.loads(data)
        assert voices["v"]["speakers"] == {f"spk{i}": i for i in range(4)}
        st, by_name = post("/v1/synthesize",
                           {"phoneme_ids": list(FIXTURE_IDS), "speaker": "spk2"})
        assert st == 200
        st, by_id = post("/v1/synthesize", {"phoneme_ids": list(FIXTURE_IDS), "speaker_id": 2})
        assert st == 200 and by_name == by_id
        st, by_mix = post("/v1/synthesize",
                          {"phoneme_ids": list(FIXTURE_IDS), "speaker_mix": {"spk2": 1.0}})
        assert st == 200 and by_mix == by_id
        # durations accept names the same way
        st, d_name = post("/v1/durations", {"phoneme_ids": list(FIXTURE_IDS), "speaker": "spk1"})
        st2, d_id = post("/v1/durations", {"phoneme_ids": list(FIXTURE_IDS), "speaker_id": 1})
        assert st == 200 and st2 == 200 and d_name == d_id
        # errors are 400s
        for bad in ({"speaker": "nobody"},
                    {"speaker": "spk1", "speaker_id": 1},
                    {"speaker_mix": {"nobody": 1.0}}):
            st, _ = post("/v1/synthesize", {"phoneme_ids": list(FIXTURE_IDS), **bad})
            assert st == 400, bad
    finally:
        srv.close()


def test_ssml_voice_by_name(ms_runtime):
    from piper_tpu_torch.core.ssml import SsmlError, render_ssml, ssml_alignment

    runtime = ms_runtime
    a_name = render_ssml(runtime, '<speak><voice name="spk2"><phoneme ph="AB"/></voice></speak>')
    a_id = render_ssml(runtime, '<speak><voice name="2"><phoneme ph="AB"/></voice></speak>')
    np.testing.assert_array_equal(a_name, a_id)
    # named mixes resolve too; one-hot name mix == the id
    a_mix = render_ssml(runtime,
                        '<speak><voice name="spk2:1.0"><phoneme ph="AB"/></voice></speak>')
    np.testing.assert_array_equal(a_mix, a_id)
    with pytest.raises(SsmlError):
        render_ssml(runtime, '<speak><voice name="nobody"><phoneme ph="AB"/></voice></speak>')
    with pytest.raises(SsmlError):
        # name + its id in one mix collide after resolution
        render_ssml(runtime,
                    '<speak><voice name="spk2:0.5,2:0.5"><phoneme ph="AB"/></voice></speak>')
    doc = ssml_alignment(runtime,
                         '<speak><voice name="spk3"><phoneme ph="AB"/></voice></speak>')
    assert doc["total_samples"] > 0


def test_http_speaker_and_mix_conflict(ms_voice):
    srv = PiperHTTPServer({"v": PiperRuntime(*ms_voice, device="cpu")}, port=0,
                          max_batch=4, max_wait_ms=10)
    srv.start()
    try:
        st, _, body = _request(srv, "POST", "/v1/synthesize",
                               {"phoneme_ids": list(FIXTURE_IDS), "speaker": "spk2",
                                "speaker_mix": {"0": 1.0}})
        assert st == 400
        assert b"ONE of" in body  # the three-way message, not a misleading
        # "speaker_id" the client never sent
    finally:
        srv.close()


def test_single_speaker_voice_has_no_names(tmp_path_factory):
    d = tmp_path_factory.mktemp("mono_voice")
    rt = PiperRuntime(*make_synthetic_voice(d, quality="test", seed=3), device="cpu")
    with pytest.raises(ValueError):
        rt.speaker_index("anyone")


# -- the port's server against the JAX package's ------------------------------------

ZERO = {"noise_scale": 0, "noise_w": 0}
PCM_ATOL = 1e-4 + 1 / 32767  # the fp32 bar, plus one int16 step
XPKG_SSML = ('<speak><phoneme ph="ab"/><break time="150ms"/>'
             '<prosody rate="80%"><phoneme ph="ba"/></prosody></speak>')
# Bodies every server must refuse before any device work, each with the
# status both packages give it.
MALFORMED = [
    b"\xff\xfe{\x80garbage\xff", b"[1, 2, 3]", b'"a string"', b"42", b"null", b"{not json",
    json.dumps({"voice": "nope", "phoneme_ids": [1, 2]}).encode(),
    json.dumps({}).encode(),
    json.dumps({"phoneme_ids": "not-a-list"}).encode(),
    json.dumps({"phoneme_ids": []}).encode(),
    json.dumps({"phoneme_ids": ["a", "b"]}).encode(),
    json.dumps({"phoneme_ids": [0.5]}).encode(),
    json.dumps({"phoneme_ids": [999999]}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "speaker_id": 99}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "speaker_mix": {"0": "x"}}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "speaker_mix": {}}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "speaker": "nobody"}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "length_scale": "loud"}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "length_scale": 0}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "noise_w": float("nan")}).encode(),
    json.dumps({"ipa": "a€b"}).encode(),
    json.dumps({"text": ""}).encode(),
    json.dumps({"text": "Hello there."}).encode(),
    json.dumps({"ssml": "<speak><unclosed></speak"}).encode(),
    json.dumps({"ssml": "<speak>Hello there.</speak>"}).encode(),
    json.dumps({"ssml": '<speak><phoneme ph="ab"/></speak>', "speaker_id": 1}).encode(),
    json.dumps({"ssml": '<speak><voice name="ghost"><phoneme ph="a"/></voice></speak>'}).encode(),
    json.dumps({"ssml": '<speak><break time="1s"/></speak>'}).encode(),
]
# Fields only /v1/synthesize reads (/v1/durations ignores them by design).
SYNTH_ONLY = [
    json.dumps({"phoneme_ids": [1, 20, 2], "noise_scale": -2}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "durations": [1, 2]}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "durations": [-1, 1, 1]}).encode(),
    json.dumps({"phoneme_ids": [1, 20, 2], "durations": [1, 1, 1], "noise_w": 0.5}).encode(),
]


@pytest.fixture(scope="module")
def both_servers(tmp_path_factory, monkeypatch_module):
    """One JAX PiperHTTPServer and one of the port serving the same voice
    file (the 'test' preset), made once for the module; neither box has
    espeak-ng (find_espeak is pinned to None in both packages)."""
    from piper_tpu.engine.http_server import PiperHTTPServer as JPiperHTTPServer
    from piper_tpu.engine.runtime import PiperRuntime as JPiperRuntime

    monkeypatch_module.setattr("piper_tpu.phonemize.find_espeak", lambda: None)
    monkeypatch_module.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: None)
    model, config = make_synthetic_voice(tmp_path_factory.mktemp("xpkg"), quality="test",
                                         seed=4, voice_name="xv")
    port = PiperHTTPServer({"xv": PiperRuntime(model, config, device="cpu")}, port=0,
                           max_batch=4, max_wait_ms=5)
    jax_srv = JPiperHTTPServer({"xv": JPiperRuntime(model, config)}, port=0,
                               max_batch=4, max_wait_ms=5)
    port.start()
    jax_srv.start()
    yield port, jax_srv
    port.close()
    jax_srv.close()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _raw_post(srv, path, body: bytes):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(len(body)))
        conn.endheaders()
        conn.send(body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("body", [
    {"phoneme_ids": list(FIXTURE_IDS)},
    {"phoneme_ids": list(FIXTURE_IDS) * 4},
    {"ssml": XPKG_SSML},
], ids=["x1", "x4", "ssml"])
def test_pcm_matches_the_reference_server(both_servers, body):
    """/v1/synthesize with "format": "pcm" at zero noise: the port's body
    against the JAX server's, the same length, within 1e-4 + one int16
    step; the WAV of the same request is the same audio."""
    port, jax_srv = both_servers
    req = {**body, **ZERO, "format": "pcm"}
    st, ctype, got = _request(port, "POST", "/v1/synthesize", req)
    jst, jctype, want = _request(jax_srv, "POST", "/v1/synthesize", req)
    assert (st, ctype) == (jst, jctype) == (200, "audio/x-raw-int16")
    got, want = np.frombuffer(got, "<i2"), np.frombuffer(want, "<i2")
    assert got.shape == want.shape and len(got) > 0
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).max() / 32767.0
    assert err <= PCM_ATOL, err
    st, ctype, wav = _request(port, "POST", "/v1/synthesize", {**body, **ZERO})
    assert (st, ctype) == (200, "audio/wav")
    from piper_tpu_torch.utils.wav import parse_wav_bytes

    np.testing.assert_array_equal(parse_wav_bytes(wav)[0], got.astype(np.float32) / 32767.0)


@pytest.mark.parametrize("body", [
    {"phoneme_ids": list(FIXTURE_IDS)},
    {"phoneme_ids": list(FIXTURE_IDS) * 4, "length_scale": 1.3},
    {"ssml": XPKG_SSML},
], ids=["x1", "x4", "ssml"])
def test_durations_match_the_reference_server(both_servers, body):
    """/v1/durations at noise_w=0: the port's JSON equals the JAX
    server's (w_ceil exact, so every span and offset is equal)."""
    port, jax_srv = both_servers
    st, _, got = _request(port, "POST", "/v1/durations", {**body, "noise_w": 0})
    jst, _, want = _request(jax_srv, "POST", "/v1/durations", {**body, "noise_w": 0})
    assert st == jst == 200
    assert json.loads(got) == json.loads(want)


def test_voices_and_health_match_the_reference_server(both_servers):
    port, jax_srv = both_servers
    for path in ("/v1/voices", "/healthz"):
        st, ctype, got = _request(port, "GET", path)
        jst, jctype, want = _request(jax_srv, "GET", path)
        assert (st, ctype) == (jst, jctype)
        assert json.loads(got) == json.loads(want), path
    st, _, _ = _request(port, "GET", "/v1/nope")
    jst, _, _ = _request(jax_srv, "GET", "/v1/nope")
    assert st == jst == 404


@pytest.mark.parametrize("path", ["/v1/synthesize", "/v1/durations", "/v1/audio/speech",
                                  "/v1/stream"])
def test_malformed_bodies_get_the_reference_status(both_servers, path):
    """Every body of the table, on every POST route (and the
    synthesize-only fields on /v1/synthesize): the port answers the JAX
    server's status code (the stream route is a 404 on both: neither server
    streams)."""
    port, jax_srv = both_servers
    bodies = MALFORMED + (SYNTH_ONLY if path == "/v1/synthesize" else [])
    got = [_raw_post(port, path, body)[0] for body in bodies]
    want = [_raw_post(jax_srv, path, body)[0] for body in bodies]
    assert got == want
    assert all(400 <= s < 600 for s in got)


# -- the thread rule -------------------------------------------------------------


def test_handler_threads_never_run_device_work(tmp_path_factory):
    """Every PiperRuntime._device_work block (each encode, decode, head,
    window and durations run) and every fetch, during concurrent
    /v1/synthesize, /v1/durations and /v1/stream requests on a stream=True
    server of a split-mode and a fused-mode voice, runs on the backend's one
    worker thread; none on an HTTP handler thread."""
    from piper_tpu_torch.engine.runtime import RuntimeOptions

    d = tmp_path_factory.mktemp("thread_rule")
    model, config = make_synthetic_voice(d, quality="test", seed=9)
    rts = {"split": PiperRuntime(model, config, device="cpu"),
           "fused": PiperRuntime(model, config, RuntimeOptions(mode="fused"), device="cpu")}
    seen = []

    def spy(rt):
        inner = rt._device_work

        @contextlib.contextmanager
        def device_work():
            seen.append(threading.current_thread())
            with inner():
                yield

        rt._device_work = device_work
        for name in ("fetch_batch", "fetch_fused"):
            fn = getattr(rt, name)

            def wrapped(*a, _fn=fn, **k):
                seen.append(threading.current_thread())
                return _fn(*a, **k)

            setattr(rt, name, wrapped)

    for rt in rts.values():
        spy(rt)
    with PiperHTTPServer(rts, port=0, stream=True, max_batch=4, max_wait_ms=5,
                         stream_kwargs=dict(emit_frames=16, c0=8, row_rungs=(1, 2, 4))) as srv:
        srv.start()
        results, errors = [], []

        def client(i):
            voice = ("split", "fused")[i % 2]
            try:
                for path, body in (
                        ("/v1/synthesize", {"phoneme_ids": list(FIXTURE_IDS) * (1 + i % 3)}),
                        ("/v1/durations", {"phoneme_ids": list(FIXTURE_IDS)}),
                        ("/v1/stream", {"phoneme_ids": list(FIXTURE_IDS) * 2, "seed": i}),
                        ("/v1/synthesize", {"ssml": XPKG_SSML, "format": "pcm"})):
                    st, _, data = _request(srv, "POST", path, {**body, "voice": voice})
                    results.append((path, st, len(data)))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        worker = srv.server._worker
    assert not errors, errors
    assert len(results) == 24 and all(st == 200 and n > 0 for _, st, n in results), results
    assert seen, "the spies saw no device work"
    off_worker = sorted({t.name for t in seen if t is not worker})
    assert not off_worker, f"device work ran on {off_worker}"


# -- the CLI ---------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--model", "m.onnx", "--phoneme-ids", "1,2"], ["--list-voices"], [],
    ["--model", "m.onnx", "--text", "Hi."],
])
def test_cli_without_serve_names_the_roadmap_item(argv, tiny_voice, tmp_path, monkeypatch,
                                                  capsys):
    """Without --serve the CLI runs the mode it was called for, as the JAX
    CLI does: one-shot --phoneme-ids writes its WAV, --list-voices prints the index,
    no mode at all is the REPL (which needs a voice), and --text without
    espeak-ng raises the phonemizer's error."""
    from piper_tpu_torch import cli
    from piper_tpu_torch.phonemize import PhonemizerError

    model = str(tiny_voice[0])
    argv = [model if a == "m.onnx" else a for a in argv]
    out = tmp_path / "o.wav"
    if "--list-voices" in argv:
        cli.main(argv)
        assert "149 voices" in capsys.readouterr().out
    elif not argv:
        with pytest.raises(SystemExit, match="pass --voice <id> or --model"):
            cli.main(argv)
    elif "--text" in argv:
        monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: None)
        with pytest.raises(PhonemizerError, match="espeak-ng not found"):
            cli.main([*argv, "--device", "cpu", "-o", str(out)])
    else:
        cli.main([*argv, "--device", "cpu", "-o", str(out)])
        assert "wrote" in capsys.readouterr().out and out.stat().st_size > 44


def test_cli_serve_rejects_flags_of_other_modes(monkeypatch):
    """--serve wins over the one-shot flags, as in the JAX CLI's dispatch:
    `--serve --text` serves, and an unknown flag is a usage error (exit 2)."""
    from piper_tpu_torch import cli

    served = []
    monkeypatch.setattr(cli, "run_serve", lambda args: served.append(args.text))
    cli.main(["--serve", "--model", "m.onnx", "--text", "Hi."])
    assert served == ["Hi."]
    with pytest.raises(SystemExit) as e:
        cli.main(["--serve", "--no-such-flag"])
    assert e.value.code == 2


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks what happens where there is no card")
def test_cli_serve_defaults_to_the_card(tiny_voice, monkeypatch):
    """`--serve` without --device asks for the card, and raises where there
    is none (nothing falls back to the CPU). The SIGTERM drain handler is
    not installed in the test process."""
    from piper_tpu_torch import cli

    monkeypatch.setattr(cli, "_install_sigterm_drain", lambda holder: None)
    model, _ = tiny_voice
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--serve", "--port", "0", "--model", str(model)])


def test_cli_options_match_the_reference(monkeypatch):
    """The serve flags build the JAX CLI's RuntimeOptions fields: env flags
    as the base, explicit flags winning."""
    from types import SimpleNamespace

    from piper_tpu import cli as j_cli
    from piper_tpu_torch import cli

    monkeypatch.setenv("PIPER_TPU_MODE", "fused")
    monkeypatch.setenv("PIPER_TPU_VOCODER_PRECISION", "default")
    for argv in ([], ["--precision", "high", "--output-dtype", "int16"],
                 ["--vocoder-precision", "high", "--flow-precision", "high", "--seed", "7"],
                 ["--vocoder-precision", "high,none,default"]):
        args = cli.build_parser().parse_args(["--serve", *argv])
        jargs = j_cli.build_parser().parse_args(["--serve", *argv])
        got, want = cli._cli_options(args), j_cli._cli_options(jargs)
        for field in ("seed", "precision", "mode", "vocoder_precision", "flow_precision",
                      "output_dtype", "fused_frames_per_phoneme", "phoneme_buckets",
                      "frame_buckets"):
            assert getattr(got, field) == getattr(want, field), (argv, field)
    bf16 = ["--serve", "--precision", "bfloat16"]
    assert (cli._cli_options(cli.build_parser().parse_args(bf16)).precision
            == j_cli._cli_options(j_cli.build_parser().parse_args(bf16)).precision)
    with pytest.raises(ValueError, match="under precision 'bfloat16'"):
        cli._cli_options(cli.build_parser().parse_args(bf16 + ["--flow-precision", "high"]))
    assert SimpleNamespace  # the namespace import documents the args' shape
