"""tests/test_review_fixes.py's and tests/test_multispeaker_paths.py's cases
that no other port test holds, on the port (CPU), plus a serving_sim
--http pass whose failed connections are counted at the door."""

import http.client
import json

import numpy as np
import pytest
import torch

from piper_tpu_torch import cli
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.batcher import BatchingServer
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.engine.server import VoiceServer
from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.model import decode, encode
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice, synthetic_params
from piper_tpu_torch.utils.wav import read_wav

SMALL = VitsHParams(
    n_vocab=40, inter_channels=32, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=1, dp_filter_channels=32, dp_n_flows=2,
    flow_n_flows=1, flow_hidden_channels=32, flow_n_layers=2,
    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
    upsample_rates=[4, 4], upsample_initial_channel=64,
    upsample_kernel_sizes=[8, 8],
)


@pytest.fixture(scope="module")
def runtime(tiny_voice):
    return PiperRuntime(*tiny_voice, device="cpu")


def test_padded_decode_equals_exact_length_decode():
    """Bucket padding must not reach the valid audio: decoding at a padded
    bucket and at exactly y_len frames agree on the valid region."""
    weights = synthetic_params(SMALL, seed=31)
    params = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in weights.items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL.n_vocab, size=(1, 12))
    dp_noise = rng.standard_normal((1, 2, 12)).astype(np.float32)
    with torch.inference_mode():
        enc = encode(params, SMALL, torch.from_numpy(ids), torch.tensor([12]),
                     torch.from_numpy(dp_noise))
        y_len = int(enc.y_total[0])
        assert y_len >= 4, "need a few frames for the comparison"
        big = y_len + 40
        noise = rng.standard_normal((1, SMALL.inter_channels, big)).astype(np.float32)
        a_pad, _ = decode(params, SMALL, enc, torch.from_numpy(noise), max_frames=big)
        a_exact, _ = decode(params, SMALL, enc, torch.from_numpy(noise[:, :, :y_len]),
                            max_frames=y_len)
    n = y_len * SMALL.hop_length
    np.testing.assert_allclose(a_pad[0, :n].numpy(), a_exact[0, :n].numpy(), atol=1e-5)


def test_streaming_matches_full_without_total_frames(runtime):
    """With shared injected noise, streaming equals the full decode with
    the default total_frames."""
    hp = runtime.hparams
    rng = np.random.default_rng(11)
    ids = FIXTURE_IDS * 2
    dp_noise = rng.standard_normal((1, 2, len(ids))).astype(np.float32)
    runtime.synthesize(ids, dp_noise=dp_noise)
    fb = runtime.last_run_timings.frame_bucket
    main_noise = rng.standard_normal((1, hp.inter_channels, fb)).astype(np.float32)
    full = runtime.synthesize(ids, dp_noise=dp_noise, main_noise=main_noise)
    streamed = np.concatenate([
        c.samples for c in runtime.synthesize_stream_incremental(
            ids, chunk_frames=16, dp_noise=dp_noise, main_noise=main_noise)])
    assert len(streamed) == len(full)
    np.testing.assert_allclose(streamed, full, atol=1e-5)


def test_dispatch_batch_fused_false_takes_split_path(tiny_voice):
    """fused=False on a 1-row batch of a fused-mode runtime takes the split
    path; the default still delegates to dispatch_fused."""
    rt = PiperRuntime(*tiny_voice, RuntimeOptions(mode="fused"), device="cpu")
    outs, meta = rt.dispatch_batch([FIXTURE_IDS], fused=False)
    assert not meta.get("fused1") and not meta.get("fused")
    outs2, meta2 = rt.dispatch_batch([FIXTURE_IDS])
    assert meta2.get("fused1")
    assert len(rt.fetch_batch(outs, meta)[0]) == len(rt.fetch_batch(outs2, meta2)[0])


def test_single_chip_rungs_keep_exact_group_limit(runtime):
    """The top rung is the bucket's exact group limit (24), not snapped up
    the power-of-two ladder to 32."""
    server = BatchingServer.__new__(BatchingServer)
    server.rt = runtime
    server.max_rows = 24
    server.phoneme_budget = 24 * 128
    assert server._rungs(128)[-1] == 24


def test_reset_metrics_zeroes_counters(runtime):
    with BatchingServer(runtime, max_batch=4, max_wait_ms=1.0) as server:
        server.submit(FIXTURE_IDS).result(timeout=300)
        assert server.metrics()["submitted"] == 1
        server.reset_metrics()
        m = server.metrics()
        assert m["submitted"] == 0 and m["groups"] == 0
        assert m["wait_ms_mean"] == 0.0


# -- tests/test_multispeaker_paths.py ---------------------------------------------

@pytest.fixture(scope="module")
def ms_voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("ms_paths")
    return make_synthetic_voice(d, quality="test", seed=6, n_speakers=4, gin_channels=32)


@pytest.fixture(scope="module")
def ms_runtime(ms_voice):
    return PiperRuntime(*ms_voice, device="cpu")


def test_multispeaker_incremental_streaming(ms_runtime):
    chunks = list(ms_runtime.synthesize_stream(FIXTURE_IDS, incremental=True, speaker_id=2))
    audio = np.concatenate([c.samples for c in chunks])
    assert len(audio) > 0 and np.isfinite(audio).all()
    other = np.concatenate([
        c.samples for c in ms_runtime.synthesize_stream(FIXTURE_IDS, incremental=True,
                                                        speaker_id=3)])
    if audio.shape == other.shape:
        assert not np.allclose(audio, other)


def test_multispeaker_streaming_matches_full(ms_runtime):
    """Injected noise: multi-speaker streaming equals the full decode."""
    hp = ms_runtime.hparams
    rng = np.random.default_rng(3)
    dp_noise = rng.standard_normal((1, 2, len(FIXTURE_IDS))).astype(np.float32)
    ms_runtime.synthesize(FIXTURE_IDS, speaker_id=1, dp_noise=dp_noise)
    fb = ms_runtime.last_run_timings.frame_bucket
    main_noise = rng.standard_normal((1, hp.inter_channels, fb)).astype(np.float32)
    full = ms_runtime.synthesize(FIXTURE_IDS, speaker_id=1, dp_noise=dp_noise,
                                 main_noise=main_noise)
    streamed = np.concatenate([
        c.samples for c in ms_runtime.synthesize_stream_incremental(
            FIXTURE_IDS, chunk_frames=16, speaker_id=1, dp_noise=dp_noise,
            main_noise=main_noise, total_frames=fb)])
    assert len(streamed) == len(full)
    np.testing.assert_allclose(streamed, full, atol=1e-5)


def test_cli_speaker_id(ms_voice, tmp_path):
    model, _ = ms_voice
    out0, out2 = tmp_path / "s0.wav", tmp_path / "s2.wav"
    ids = ",".join(map(str, FIXTURE_IDS))
    cli.main(["--device", "cpu", "--model", str(model), "--phoneme-ids", ids,
              "--speaker-id", "0", "-o", str(out0)])
    cli.main(["--device", "cpu", "--model", str(model), "--phoneme-ids", ids,
              "--speaker-id", "2", "-o", str(out2)])
    a0, _ = read_wav(out0)
    a2, _ = read_wav(out2)
    assert len(a0) > 0 and len(a2) > 0
    if a0.shape == a2.shape:
        assert not np.allclose(a0, a2)


def test_server_streaming_passthrough(ms_voice):
    model, config = ms_voice
    with VoiceServer(device="cpu") as server:
        key = server.load(model, config)
        chunks = list(server.synthesize_stream(key, FIXTURE_IDS, speaker_id=1))
        assert chunks[-1].is_final
        assert sum(len(c.samples) for c in chunks) > 0


def test_serving_sim_http_counts_failed_connections(capsys, tmp_path, monkeypatch):
    """`--http` with every third client connection failing before its
    request is sent: each failure is counted in door.transport_errors (the
    measured pass's only), its request leaves the served count, and the
    pass completes."""
    from piper_tpu_torch.tools import serving_sim

    monkeypatch.setenv("PIPER_TPU_CACHE", str(tmp_path))
    sent = {"n": 0}
    real = http.client.HTTPConnection.request

    def flaky(self, *args, **kwargs):
        sent["n"] += 1
        if sent["n"] % 3 == 0:
            raise ConnectionResetError("connection reset by the test")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(http.client.HTTPConnection, "request", flaky)
    serving_sim.main(["--device", "cpu", "--quality", "test", "--rate", "10",
                      "--duration", "2", "--max-batch", "2", "--http"])
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    got = json.loads(lines[-1])
    assert got["door"]["transport_errors"] >= 1
    assert got["requests"] == got["server"]["per_voice_rows"]["v0"] > 0
