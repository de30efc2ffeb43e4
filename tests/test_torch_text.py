"""The port's text front end: core/phonemes.py, core/text.py, phonemize.py,
utils/wav.py and core/voices.py with its bundled VOICES.md.

The cases of tests/test_text.py, tests/test_phonemize.py and the phoneme,
voice-index and audio cases of tests/test_core.py, on the port's copies
(the CLI's --text, --stream and REPL cases are in tests/test_torch_cli.py).
Each copy is also held to its original in the JAX
package: the same sentences, the same framed ids or the same error, the
same WAV bytes, a byte-equal VOICES.md and equal index entries.
"""

import dataclasses
import io
import stat
from pathlib import Path

import numpy as np
import pytest

from piper_tpu.core import phonemes as j_phonemes
from piper_tpu.core import text as j_text
from piper_tpu.core import voices as j_voices
from piper_tpu.utils import wav as j_wav
from piper_tpu_torch.core import phonemes as t_phonemes
from piper_tpu_torch.core.audio import AudioChunk, AudioFormat, float_to_int16
from piper_tpu_torch.core.phonemes import UnknownSymbolError, ipa_to_ids
from piper_tpu_torch.core.text import split_sentences
from piper_tpu_torch.core.voices import VoiceIndex
from piper_tpu_torch.phonemize import ESpeakPhonemizer, PhonemizerError, phonemizer_for
from piper_tpu_torch.utils import wav

ROOT = Path(__file__).resolve().parent.parent
ID_MAP = {"^": [1], "$": [2], "_": [0], "a": [20], "b": [21]}

SENTENCE_CASES = [
    ("Hello there. How are you?", ["Hello there.", "How are you?"]),
    ("One! Two? Three.", ["One!", "Two?", "Three."]),
    ("Just one sentence", ["Just one sentence"]),
    ("", []),
    ("   ", []),
    # abbreviations and initials do not split
    ("Dr. Smith went to Washington. He arrived late.",
     ["Dr. Smith went to Washington.", "He arrived late."]),
    ("Meet J. R. Hartley. He wrote a book.",
     ["Meet J. R. Hartley.", "He wrote a book."]),
    ("It costs 3.14 dollars. Cheap!", ["It costs 3.14 dollars.", "Cheap!"]),
    ("See fig. 4 for details. Then continue.",
     ["See fig. 4 for details.", "Then continue."]),
    # quotes after terminators stay attached
    ('He said "stop." Then he left.', ['He said "stop."', "Then he left."]),
    # ellipsis
    ("Wait… What was that?", ["Wait…", "What was that?"]),
    # lowercase continuation after '.' does not split
    ("the file is main. py is great. Next sentence.",
     ["the file is main. py is great.", "Next sentence."]),
    # whitespace collapses
    ("A  first   one.   A\nsecond one.", ["A first one.", "A second one."]),
]


@pytest.mark.parametrize("text,want", SENTENCE_CASES)
def test_split_sentences(text, want):
    assert split_sentences(text) == want
    assert split_sentences(text) == j_text.split_sentences(text)


@pytest.mark.parametrize("text,want", [
    # terminator-led / dots-only prefixes must not crash
    (". Hello there. Bye.", [".", "Hello there.", "Bye."]),
    ("... so it begins. Done.", ["... so it begins.", "Done."]),
    ("...", ["..."]),
])
def test_split_sentences_degenerate_prefixes(text, want):
    assert split_sentences(text) == want
    assert split_sentences(text) == j_text.split_sentences(text)


def test_join_with_silence_rejects_negative():
    from piper_tpu_torch.core.audio import join_with_silence

    with pytest.raises(ValueError):
        join_with_silence([np.zeros(4, np.float32)] * 2, -10)
    out = join_with_silence([np.ones(2, np.float32), np.ones(3, np.float32)], 5)
    assert len(out) == 10 and (out[2:7] == 0).all()


@pytest.fixture()
def fake_espeak(tmp_path):
    """A stand-in espeak-ng that prints a fixed IPA string for any input."""
    script = tmp_path / "espeak-ng"
    script.write_text("#!/bin/sh\necho 'ab'\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_phonemizer_pipeline(fake_espeak):
    ph = ESpeakPhonemizer("en", ID_MAP, espeak_path=fake_espeak)
    assert ph.to_ipa("whatever text") == "ab"
    assert ph.phoneme_ids("whatever text") == [1, 20, 0, 21, 0, 2]


def test_phonemizer_failure(tmp_path):
    bad = tmp_path / "espeak-ng"
    bad.write_text("#!/bin/sh\necho boom >&2\nexit 3\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    ph = ESpeakPhonemizer("en", {"^": [1], "$": [2], "_": [0]}, espeak_path=str(bad))
    with pytest.raises(PhonemizerError, match="exit code 3"):
        ph.to_ipa("x")


def test_phonemizer_for_reads_the_voice_config_and_memoizes(fake_espeak, monkeypatch):
    """phonemizer_for takes the espeak voice and the id map from the
    runtime's config ("en" without an espeak section) and keeps one
    phonemizer per runtime in the server's cache; without espeak-ng it
    raises PhonemizerError (what the HTTP server maps to 501)."""
    from types import SimpleNamespace

    rt = SimpleNamespace(config=SimpleNamespace(espeak=SimpleNamespace(voice="en-gb"),
                                                phoneme_id_map=ID_MAP))
    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: fake_espeak)
    cache = {}
    ph = phonemizer_for(rt, cache)
    assert ph.voice == "en-gb" and phonemizer_for(rt, cache) is ph
    bare = SimpleNamespace(config=SimpleNamespace(espeak=None, phoneme_id_map=ID_MAP))
    assert phonemizer_for(bare).voice == "en"
    monkeypatch.setattr("piper_tpu_torch.phonemize.find_espeak", lambda: None)
    with pytest.raises(PhonemizerError, match="espeak-ng not found"):
        phonemizer_for(bare)


def test_phoneme_framing():
    # bos, then (id, blank) per phoneme, then eos — matches the reference's
    # fixture layout [1, 20, 0, ..., 2] (ESpeakPhonemizer.swift:76-103).
    assert ipa_to_ids("ab", ID_MAP) == [1, 20, 0, 21, 0, 2]
    assert ipa_to_ids("", ID_MAP) == [1, 2]
    # Zero-width joiner and newlines are skipped.
    assert ipa_to_ids("a‍b\n", ID_MAP) == [1, 20, 0, 21, 0, 2]
    with pytest.raises(UnknownSymbolError):
        ipa_to_ids("z", ID_MAP)


def _ids_outcome(mod, ipa, id_map):
    try:
        return "ok", mod.ipa_to_ids(ipa, id_map)
    except KeyError as e:  # UnknownSymbolError is a KeyError
        return type(e).__name__, str(e), e.symbol


@pytest.mark.parametrize("ipa,id_map", [
    ("ab", ID_MAP), ("", ID_MAP), ("a‍b\n\r", ID_MAP), ("a️b​", ID_MAP),
    ("a⁠b", ID_MAP), ("z", ID_MAP), ("ab", {"^": [1], "$": [2]}),
    ("ab", {"^": [], "$": [2], "_": [0], "a": [20], "b": [21]}),
    ("ab", {**ID_MAP, "b": []}), ("ba" * 40, ID_MAP),
])
def test_ipa_to_ids_matches_the_reference(ipa, id_map):
    """The port's ipa_to_ids against the JAX package's: the same ids, or
    the same UnknownSymbolError with the same message and symbol."""
    assert _ids_outcome(j_phonemes, ipa, id_map) == _ids_outcome(t_phonemes, ipa, id_map)


def test_voice_index_bundled():
    idx = VoiceIndex.load_bundled()
    assert len(idx.entries) >= 100
    e = idx.get("en_GB-northern_english_male-medium")
    assert e is not None
    assert e.language == "en_GB"
    assert e.quality == "medium"
    assert e.model_url.endswith("en_GB-northern_english_male-medium.onnx")
    assert e.config_url == e.model_url + ".json"


def test_voice_index_pattern_fallback():
    e = VoiceIndex.entry_for_id("xx_YY-some-name-high")
    assert e.language == "xx_YY"
    assert e.quality == "high"
    assert "/xx/xx_YY/some-name/high/" in e.model_url


def test_voices_md_and_index_equal_the_reference():
    """The bundled table is the JAX package's byte for byte, and both
    packages' indexes hold equal entries (and resolve an unlisted id to the
    same URL pattern)."""
    assert VoiceIndex.bundled_path() == ROOT / "piper_tpu_torch/core/resources/VOICES.md"
    assert VoiceIndex.bundled_path().read_bytes() == j_voices.VoiceIndex.bundled_path().read_bytes()
    got = [dataclasses.asdict(e) for e in VoiceIndex.load_bundled().entries]
    want = [dataclasses.asdict(e) for e in j_voices.VoiceIndex.load_bundled().entries]
    assert got == want
    for vid in ("xx_YY-some-name-high", "de_DE-thorsten-medium"):
        assert dataclasses.asdict(VoiceIndex.load_bundled().resolve(vid)) == dataclasses.asdict(
            j_voices.VoiceIndex.load_bundled().resolve(vid))


def test_audio_types():
    chunk = AudioChunk(
        format=AudioFormat(sample_rate=22050),
        start_sample_index=0,
        samples=np.zeros(2205, dtype=np.float32),
        is_final=True,
    )
    assert chunk.duration_seconds == pytest.approx(0.1)
    i16 = float_to_int16(np.array([-2.0, -1.0, 0.0, 1.0, 2.0], dtype=np.float32))
    assert i16.dtype == np.int16
    assert i16.tolist() == [-32767, -32767, 0, 32767, 32767]


def test_wav_writer_bytes_equal_the_reference(tmp_path):
    """WavWriter over a file and over BytesIO, float and int16 appends:
    the JAX package's bytes; parse_wav_bytes and read_wav read them back as
    the original does."""
    audio = (np.sin(np.linspace(0, 20, 777)) * 0.7).astype(np.float32)
    pcm = float_to_int16(audio)
    blobs = []
    for mod in (wav, j_wav):
        buf = io.BytesIO()
        with mod.WavWriter(buf, 22050) as w:
            w.append_float32(audio[:300])
            w.append_int16(pcm[300:])
        blobs.append(buf.getvalue())
    assert blobs[0] == blobs[1]
    wav.write_wav(tmp_path / "f.wav", audio, 16000)
    j_wav.write_wav(tmp_path / "j.wav", audio, 16000)
    wav.write_wav(tmp_path / "i.wav", pcm, 16000)
    assert (tmp_path / "f.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert (tmp_path / "i.wav").read_bytes() == (tmp_path / "f.wav").read_bytes()
    back, sr = wav.read_wav(tmp_path / "f.wav")
    j_back, j_sr = j_wav.parse_wav_bytes((tmp_path / "f.wav").read_bytes())
    assert sr == j_sr == 16000
    np.testing.assert_array_equal(back, j_back)
    np.testing.assert_allclose(back, audio, atol=1e-4)
    with pytest.raises(ValueError, match="not a WAV"):
        wav.parse_wav_bytes(b"RIFX" + blobs[0][4:])
