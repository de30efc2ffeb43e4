"""The port's streaming playback (piper_tpu_torch.utils.playback, a copy of
the JAX package's module held byte-equal) on the CPU: the cases of
tests/test_playback.py under their own names, the last through the port's
CLI (`--stream --play --device cpu`): PCM chunks reach the player process
incrementally, raw s16le into its stdin."""

import sys
import time

import numpy as np
import pytest

from piper_tpu_torch.core.audio import AudioChunk, AudioFormat
from piper_tpu_torch.utils.playback import (StreamingPlayer, play_stream,
                                      to_int16_pcm)


def recorder_cmd(out_path):
    """A stand-in player: copies stdin to a file, flushing per read, so the
    test can observe bytes arriving while the stream is still open."""
    script = (
        "import sys\n"
        f"f = open({str(out_path)!r}, 'wb')\n"
        "while True:\n"
        "    b = sys.stdin.buffer.read1(1 << 16)\n"
        "    if not b: break\n"
        "    f.write(b); f.flush()\n"
        "f.close()\n"
    )
    return [sys.executable, "-u", "-c", script]


def test_int16_conversion_semantics():
    x = np.asarray([0.0, 0.5, 1.0, -1.0, 2.0, -2.0], np.float32)
    out = to_int16_pcm(x)
    assert out.dtype == np.int16
    np.testing.assert_array_equal(
        out, np.asarray([0, 16383, 32767, -32767, 32767, -32767], np.int16)
    )
    # int16 passes through untouched (an int16-output runtime's chunks).
    same = np.asarray([1, -5, 32767], np.int16)
    assert to_int16_pcm(same) is same


def test_chunks_arrive_before_close(tmp_path):
    """Playback is incremental: the first chunk's bytes are visible at the
    player BEFORE the stream finishes (the whole point vs file playback)."""
    rec = tmp_path / "pcm.raw"
    sp = StreamingPlayer(16000, player_cmd=recorder_cmd(rec))
    first = np.full(1000, 0.25, np.float32)
    sp.play(first)
    # Wait (bounded) for the recorder to surface the first chunk's bytes.
    deadline = time.time() + 10
    while time.time() < deadline:
        if rec.exists() and rec.stat().st_size >= first.nbytes // 2:
            break
        time.sleep(0.01)
    assert rec.exists() and rec.stat().st_size == 2 * len(first)
    sp.play(np.full(500, -0.5, np.float32))
    sp.close()
    data = np.frombuffer(rec.read_bytes(), np.int16)
    assert len(data) == 1500
    np.testing.assert_array_equal(data[:1000], to_int16_pcm(first))
    assert sp.samples_played == 1500


def test_play_stream_helper(tmp_path):
    rec = tmp_path / "pcm.raw"
    fmt = AudioFormat(sample_rate=16000)
    chunks = [
        AudioChunk(format=fmt, start_sample_index=0,
                   samples=np.zeros(256, np.float32), is_final=False),
        AudioChunk(format=fmt, start_sample_index=256,
                   samples=np.ones(128, np.float32), is_final=True),
    ]
    seen = {}
    n = play_stream(iter(chunks), 16000, player_cmd=recorder_cmd(rec),
                    on_first=lambda: seen.setdefault("t", time.time()))
    assert n == 384
    assert "t" in seen
    assert len(np.frombuffer(rec.read_bytes(), np.int16)) == 384


def test_player_death_does_not_kill_synthesis(tmp_path):
    """A dying player (no audio device, closed pipe) must not raise into
    the synthesis loop."""
    sp = StreamingPlayer(16000, player_cmd=[sys.executable, "-c", "pass"])
    time.sleep(0.3)  # let it exit
    for _ in range(3):
        sp.play(np.zeros(4096, np.float32))  # must not raise
    sp.close()


def test_no_player_raises():
    import unittest.mock as mock

    with mock.patch("piper_tpu_torch.utils.playback.shutil.which",
                    return_value=None):
        with pytest.raises(RuntimeError):
            StreamingPlayer(16000)


def test_cli_stream_play_pipes_incrementally(tmp_path, monkeypatch, capsys):
    """`--stream --play` sends chunks to the player process (mocked) while
    writing the WAV — process-level playback starts with the first chunk."""
    from piper_tpu_torch import cli
    from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice

    model, config = make_synthetic_voice(tmp_path / "v", quality="test", seed=0)
    rec = tmp_path / "pcm.raw"
    monkeypatch.setattr(
        "piper_tpu_torch.utils.playback._default_player_cmd",
        lambda rate: recorder_cmd(rec),
    )
    out = tmp_path / "o.wav"
    cli.main(["--device", "cpu", "--model", str(model), "--phoneme-ids",
              "1,20,0,120,0,61,0,24,0,59,0,100,0,2",
              "--stream", "--play", "-o", str(out)])
    assert "streamed" in capsys.readouterr().out
    # The player's stdin received exactly the WAV's PCM payload (both go
    # through the same float->int16 conversion), chunk by chunk.
    wav_pcm = np.frombuffer(out.read_bytes()[44:], dtype="<i2")
    piped = np.frombuffer(rec.read_bytes(), np.int16)
    assert len(piped) > 0
    np.testing.assert_array_equal(piped, wav_pcm)


def test_playback_module_is_a_copy():
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    assert (root / "piper_tpu_torch/utils/playback.py").read_bytes() == (
        root / "piper_tpu/utils/playback.py").read_bytes()
