"""The port's HTTP client (piper_tpu_torch.client) on the CPU.

- The cases of tests/test_client.py under their own names, against the
  port's PiperHTTPServer and PiperStreamingHTTPServer over runtimes at
  device="cpu".
- Across the packages at zero noise (their seeds draw different noise): the
  port's client against the JAX package's server and the JAX package's
  client against the port's server give the same voices, the same
  /v1/durations documents, audio within 1e-4 + 1/32767 (one int16 step)
  and the same error statuses; both streaming clients read both streaming
  servers alike.

Torch runs one intra-op thread in this module.
"""

import numpy as np
import pytest
import torch

from piper_tpu_torch.client import PiperClient, PiperClientError, PiperStreamingClient
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.http_server import PiperHTTPServer, PiperStreamingHTTPServer
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

INT16_STEP = 1.0 / 32767
ZERO = {"noise_scale": 0.0, "noise_w": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("client_voice")
    m, _ = make_synthetic_voice(d, quality="test", seed=3, voice_name="v")
    srv = PiperHTTPServer({"v": PiperRuntime(m, device="cpu")}, port=0,
                          max_batch=4, max_wait_ms=10)
    srv.start()
    yield srv
    srv.close()


def test_client_health_voices_metrics(server):
    c = PiperClient(server.host, server.port)
    assert c.health()
    v = c.voices()
    assert "v" in v and v["v"]["sample_rate"] > 0
    assert "v" in c.metrics()
    assert not PiperClient(server.host, 1, timeout=2).health()


def test_client_synthesize_and_durations_agree(server):
    c = PiperClient(server.host, server.port)
    audio, sr = c.synthesize(phoneme_ids=FIXTURE_IDS)
    assert sr > 0 and len(audio) > 0
    assert audio.dtype == np.float32 and np.abs(audio).max() <= 1.0
    doc = c.durations(phoneme_ids=FIXTURE_IDS)
    assert doc["total_samples"] == len(audio)
    (utt,) = doc["utterances"]
    assert [p["id"] for p in utt["phonemes"]] == list(FIXTURE_IDS)


def test_client_errors(server):
    c = PiperClient(server.host, server.port)
    with pytest.raises(ValueError):
        c.synthesize()
    with pytest.raises(ValueError):
        c.synthesize(text="x", phoneme_ids=[1])
    with pytest.raises(PiperClientError) as e:
        c.synthesize(phoneme_ids=[1], voice="nope")
    assert e.value.status == 404
    with pytest.raises(PiperClientError) as e:
        c.synthesize(phoneme_ids=[10 ** 9])
    assert e.value.status == 400


def test_streaming_client(tmp_path_factory):
    d = tmp_path_factory.mktemp("client_stream")
    m, _ = make_synthetic_voice(d, quality="test", seed=6)
    rt = PiperRuntime(m, device="cpu")
    with PiperStreamingHTTPServer(rt, port=0) as srv:
        srv.start()
        c = PiperStreamingClient(srv.host, srv.port)
        chunks = list(c.stream(phoneme_ids=FIXTURE_IDS, seed=7))
        assert c.sample_rate == rt.sample_rate
        assert all(ch.dtype == np.int16 for ch in chunks)
        pcm = np.concatenate(chunks)
        assert len(pcm) > 0
        pcm2 = np.concatenate(list(c.stream(phoneme_ids=FIXTURE_IDS, seed=7)))
        np.testing.assert_array_equal(pcm, pcm2)
        with pytest.raises(PiperClientError) as e:
            list(c.stream(phoneme_ids=[]))
        assert e.value.status == 400
        gen = c.stream(phoneme_ids=list(FIXTURE_IDS) * 4, seed=1)
        next(gen)
        gen.close()
        pcm3 = np.concatenate(list(c.stream(phoneme_ids=FIXTURE_IDS, seed=7)))
        np.testing.assert_array_equal(pcm3, pcm)


def test_client_tolerates_non_json_bodies():
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Splash(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = b"<html>hi</html>"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            body = b'["boom"]'
            self.send_response(500)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Splash)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        c = PiperClient(*httpd.server_address)
        assert c.health() is False
        with pytest.raises(PiperClientError) as e:
            c.synthesize(phoneme_ids=[1])
        assert e.value.status == 500 and "boom" in str(e.value)
    finally:
        httpd.shutdown()
        httpd.server_close()


# -- across the packages -------------------------------------------------------------


@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """The port's and the JAX package's PiperHTTPServer over one voice file."""
    from piper_tpu.engine.http_server import PiperHTTPServer as JServer
    from piper_tpu.engine.runtime import PiperRuntime as JRuntime

    d = tmp_path_factory.mktemp("cross_voice")
    m, _ = make_synthetic_voice(d, quality="test", seed=3, voice_name="v")
    ours = PiperHTTPServer({"v": PiperRuntime(m, device="cpu")}, port=0, max_batch=4,
                           max_wait_ms=10)
    theirs = JServer({"v": JRuntime(m)}, port=0, max_batch=4, max_wait_ms=10)
    ours.start()
    theirs.start()
    yield {"port": ours, "jax": theirs}
    ours.close()
    theirs.close()


def test_clients_across_the_packages_agree(both_servers):
    from piper_tpu.client import PiperClient as JClient
    from piper_tpu.client import PiperClientError as JClientError

    clients = {"port": PiperClient, "jax": JClient}
    audio, docs, voices = {}, {}, {}
    ids = list(FIXTURE_IDS) * 2
    for sname, srv in both_servers.items():
        for cname, cls in clients.items():
            c = cls(srv.host, srv.port)
            audio[cname, sname], sr = c.synthesize(phoneme_ids=ids, **ZERO)
            assert sr == 16000
            docs[cname, sname] = c.durations(phoneme_ids=ids, noise_w=0.0)
            voices[cname, sname] = c.voices()
            err = PiperClientError if cname == "port" else JClientError
            with pytest.raises(err) as e:
                c.synthesize(phoneme_ids=[1], voice="nope")
            assert e.value.status == 404
    for sname in both_servers:  # one server through either client: the same bytes
        np.testing.assert_array_equal(audio["port", sname], audio["jax", sname])
    a, b = audio["port", "jax"], audio["jax", "port"]
    assert len(a) == len(b) > 0 and float(np.abs(a - b).max()) <= 1e-4 + INT16_STEP
    assert len({str(d) for d in docs.values()}) == 1
    assert len({str(v) for v in voices.values()}) == 1


def test_streaming_clients_across_the_packages_agree(tmp_path_factory):
    from piper_tpu.client import PiperStreamingClient as JStreamingClient
    from piper_tpu.engine.http_server import PiperStreamingHTTPServer as JStreamingServer
    from piper_tpu.engine.runtime import PiperRuntime as JRuntime

    d = tmp_path_factory.mktemp("cross_stream")
    m, _ = make_synthetic_voice(d, quality="test", seed=6)
    pcm = {}
    with PiperStreamingHTTPServer(PiperRuntime(m, device="cpu"), port=0) as ours, \
            JStreamingServer(JRuntime(m), port=0) as theirs:
        ours.start()
        theirs.start()
        for sname, srv in (("port", ours), ("jax", theirs)):
            for cname, cls in (("port", PiperStreamingClient), ("jax", JStreamingClient)):
                c = cls(srv.host, srv.port)
                pcm[cname, sname] = np.concatenate(
                    list(c.stream(phoneme_ids=FIXTURE_IDS, seed=1, **ZERO)))
                assert c.sample_rate == 16000
    for sname in ("port", "jax"):
        np.testing.assert_array_equal(pcm["port", sname], pcm["jax", sname])
    a, b = pcm["port", "jax"].astype(np.int32), pcm["jax", "port"].astype(np.int32)
    assert len(a) == len(b) > 0
    assert int(np.abs(a - b).max()) <= 1 + int(1e-4 * 32767)
