"""The port's SSML-lite (piper_tpu_torch.core.ssml): parsing, planning and
rendering, on the CPU.

Every case of tests/test_ssml.py under its own name, on the port's module
and runtime (device="cpu"); the HTTP cases serve through the port's
PiperHTTPServer and PiperStreamingHTTPServer and read the responses with
http.client; test_cli_ssml renders its documents through render_ssml and
through the port's CLI's one-shot --ssml mode (tests/test_torch_client.py
holds the client SDK).
Then the copy held to its original: the same documents through both
packages' parse_ssml and plan_ssml give equal segments, ignored reports,
utterances, assembly scripts and groups, or the same SsmlError.
"""

import http.client
import json

import numpy as np
import pytest
import torch

from piper_tpu_torch.core.ssml import (SsmlError, assemble, group_utterances,
                                       parse_ssml, plan_ssml, render_ssml)
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS as FIXTURE_IDS
from piper_tpu_torch.engine.runtime import PiperRuntime
from piper_tpu_torch.models.vits.synthetic import make_synthetic_voice


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ms_voice(tmp_path_factory):
    d = tmp_path_factory.mktemp("ssml_voice")
    return make_synthetic_voice(d, quality="test", seed=6, n_speakers=4, gin_channels=32)


@pytest.fixture(scope="module")
def runtime(ms_voice):
    return PiperRuntime(*ms_voice, device="cpu")


def _post(srv, path, body):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _wav_samples(blob):
    from piper_tpu_torch.utils.wav import parse_wav_bytes

    return parse_wav_bytes(blob)


# -- parsing (pure) -------------------------------------------------------


def test_bare_text_wraps():
    doc = parse_ssml("Hello there.")
    assert [s.kind for s in doc.segments] == ["text"]
    assert doc.segments[0].content == "Hello there."
    assert doc.ignored == []


def test_breaks_and_collapsing():
    doc = parse_ssml('<speak>a <break time="500ms"/> b '
                     '<break time="0.25s"/><break strength="strong"/> c'
                     '<break time="2s"/></speak>')
    kinds = [(s.kind, s.break_s) for s in doc.segments]
    # trailing break dropped; adjacent breaks collapse to the longest
    assert kinds == [("text", None), ("break", 0.5), ("text", None),
                     ("break", 0.6), ("text", None)]


def test_break_strength_table_and_errors():
    doc = parse_ssml('<speak>a<break strength="x-weak"/>b</speak>')
    assert doc.segments[1].break_s == 0.05
    with pytest.raises(SsmlError):
        parse_ssml('<speak>a<break strength="huge"/>b</speak>')
    with pytest.raises(SsmlError):
        parse_ssml('<speak>a<break time="5 parsecs"/>b</speak>')
    with pytest.raises(SsmlError):
        parse_ssml('<speak>a<break time="61s"/>b</speak>')


def test_prosody_rate_volume_pitch():
    doc = parse_ssml('<speak><prosody rate="80%">slowish</prosody>'
                     '<prosody rate="fast" volume="-6dB">fast quiet'
                     '</prosody><prosody pitch="+2st">pitchy</prosody>'
                     '</speak>')
    segs = doc.segments
    assert segs[0].ctx.length_scale == pytest.approx(1 / 0.8)
    assert segs[1].ctx.length_scale == pytest.approx(1 / 1.25)
    assert segs[1].ctx.volume == pytest.approx(10 ** (-6 / 20))
    assert segs[2].ctx.length_scale is None  # pitch ignored, rate untouched
    assert any("pitch" in msg for msg in doc.ignored)
    with pytest.raises(SsmlError):
        parse_ssml('<speak><prosody rate="0.01">x</prosody></speak>')


def test_phoneme_element_and_tail():
    doc = parse_ssml('<speak><phoneme ph="ab">Fallback</phoneme> tail.'
                     '</speak>')
    assert [(s.kind, s.content) for s in doc.segments] == [
        ("ipa", "ab"), ("text", "tail.")]
    with pytest.raises(SsmlError):
        parse_ssml('<speak><phoneme>x</phoneme></speak>')
    with pytest.raises(SsmlError):
        parse_ssml('<speak><phoneme ph="a" alphabet="x-sampa">x</phoneme>'
                   '</speak>')


def test_voice_ids_and_mixes():
    doc = parse_ssml('<speak><voice name="2">two</voice>'
                     '<voice name="0:0.6,3:0.4">blend</voice> outside'
                     '</speak>')
    segs = doc.segments
    assert segs[0].ctx.speaker_id == 2 and segs[0].ctx.speaker_mix is None
    assert segs[1].ctx.speaker_mix == ((0, 0.6), (3, 0.4))
    assert segs[2].ctx.speaker_id is None  # tail restores the parent ctx
    # a NAME parses fine (resolved against the voice's speaker_id_map at
    # plan time); without a resolver, planning rejects it
    doc2 = parse_ssml('<speak><voice name="alice">x</voice></speak>')
    assert doc2.segments[0].ctx.speaker_name == "alice"
    with pytest.raises(SsmlError):
        plan_ssml(doc2, {"^": [1], "$": [2], "_": [0]}, _fake_phonemize)
    with pytest.raises(SsmlError):
        parse_ssml('<speak><voice name="0:0.5,0:0.5">x</voice></speak>')


def test_sub_say_as_unknown():
    doc = parse_ssml('<speak><sub alias="World Wide Web">WWW</sub> and '
                     '<say-as interpret-as="digits">123</say-as>'
                     '<wizard>magic</wizard></speak>')
    text = " ".join(s.content for s in doc.segments if s.kind == "text")
    assert "World Wide Web" in text and "WWW" not in text
    assert "123" in text and "magic" in text
    assert any("say-as" in m for m in doc.ignored)
    assert any("wizard" in m for m in doc.ignored)


def test_paragraph_sentence_boundaries():
    doc = parse_ssml("<speak><p><s>One.</s><s>Two.</s></p><p>Three.</p>"
                     "</speak>")
    kinds = [(s.kind, s.break_scale if s.kind == "break" else s.content)
             for s in doc.segments]
    # s-boundary gap (1x) between One/Two; p-boundary gap (2x) between the
    # paragraphs; text merging keeps each sentence separate here because
    # breaks intervene
    assert kinds == [("text", "One."), ("break", 1.0), ("text", "Two."),
                     ("break", 2.0), ("text", "Three.")]


def test_text_merges_across_noop_markup():
    doc = parse_ssml('<speak>Hello <mark name="m"/> world.</speak>')
    assert [s.content for s in doc.segments if s.kind == "text"] == [
        "Hello world."]


def test_non_numeric_and_nonfinite_prosody_values():
    for bad in ('rate="abc"', 'rate="abc%"', 'rate="nan"',
                'volume="abc"', 'volume="abcdb"', 'volume="nan"',
                'volume="inf"', 'volume="8000dB"'):
        with pytest.raises(SsmlError):
            parse_ssml(f'<speak><prosody {bad}>x</prosody></speak>')


def test_midword_markup_does_not_split_words():
    doc = parse_ssml('<speak>Hel<mark name="m"/>lo there</speak>')
    assert [s.content for s in doc.segments if s.kind == "text"] == [
        "Hello there"]
    doc2 = parse_ssml('<speak>re<sub alias="new">old</sub>ing</speak>')
    assert [s.content for s in doc2.segments if s.kind == "text"] == [
        "renewing"]


def test_unknown_ipa_symbol_is_ssml_error():
    idmap = {"^": [1], "$": [2], "_": [0], "a": [20]}
    with pytest.raises(SsmlError):
        plan_ssml('<speak><phoneme ph="aθ"/></speak>', idmap)


def test_parse_errors():
    with pytest.raises(SsmlError):
        parse_ssml("")
    with pytest.raises(SsmlError):
        parse_ssml("<speak><unclosed></speak>")
    with pytest.raises(SsmlError):
        parse_ssml('<speak><break time="1s"/></speak>')  # nothing to speak


# -- planning -------------------------------------------------------------


def _fake_phonemize(text):
    # deterministic ids from the text so tests don't need espeak
    return [1] + [20 + (ord(c) % 5) * 2 for c in text if c.isalpha()][:8] + [2]


def test_plan_gaps_and_defaults():
    plan = plan_ssml('<speak><phoneme ph="ab"/><break time="1s"/>'
                     '<phoneme ph="cd"/><phoneme ph="ef"/></speak>',
                     {"^": [1], "$": [2], "_": [0], "a": [20], "b": [21],
                      "c": [22], "d": [23], "e": [24], "f": [25]},
                     sentence_silence=0.2)
    assert plan.assembly == [("utt", 0), ("gap", 1.0), ("utt", 1),
                             ("gap", 0.2), ("utt", 2)]


def test_plan_requires_phonemizer_for_text_only():
    idmap = {"^": [1], "$": [2], "_": [0], "a": [20], "b": [21]}
    with pytest.raises(SsmlError):
        plan_ssml("just text", idmap)
    plan = plan_ssml("just text", idmap, _fake_phonemize)
    assert len(plan.utterances) == 1
    # phoneme-only documents need no phonemizer
    plan2 = plan_ssml('<speak><phoneme ph="ab"/></speak>', idmap)
    assert len(plan2.utterances) == 1


def test_grouping_by_scale_and_conditioning():
    idmap = {"^": [1], "$": [2], "_": [0], "a": [20], "b": [21]}
    plan = plan_ssml(
        '<speak><phoneme ph="ab"/>'
        '<prosody rate="80%"><phoneme ph="ab"/></prosody>'
        '<voice name="1"><phoneme ph="ab"/></voice>'
        '<voice name="0:0.5,1:0.5"><phoneme ph="ab"/></voice>'
        '<phoneme ph="ba"/></speak>', idmap)
    groups = group_utterances(plan)
    # default-ls id rows batch together (incl. the <voice name=1> row);
    # the rate span and the mix span each get their own group
    assert sorted(map(sorted, groups)) == [[0, 2, 4], [1], [3]]


def test_assemble_volume_and_clip():
    plan = plan_ssml('<speak><prosody volume="2.0"><phoneme ph="ab"/>'
                     '</prosody></speak>',
                     {"^": [1], "$": [2], "_": [0], "a": [20], "b": [21]})
    loud = assemble([np.full(10, 0.6, np.float32)], plan, 100)
    assert loud.max() == pytest.approx(1.0)  # 0.6 * 2.0 clipped


# -- rendering on the runtime --------------------------------------------


def test_render_ipa_only(runtime):
    # Same document with two break lengths: identical batching (one 2-row
    # group both times), so the waveforms differ ONLY by the gap length
    # and the audio around it is bit-identical.
    short = render_ssml(runtime, '<speak><phoneme ph="ab"/>'
                                 '<break time="0.5s"/>'
                                 '<phoneme ph="ba"/></speak>')
    long = render_ssml(runtime, '<speak><phoneme ph="ab"/>'
                                '<break time="1.0s"/>'
                                '<phoneme ph="ba"/></speak>')
    extra = int(round(0.5 * runtime.sample_rate))
    assert len(long) == len(short) + extra
    # identical before the gap...
    np.testing.assert_array_equal(short[:1000], long[:1000])
    # ...identical after it (shifted by the extra silence)...
    np.testing.assert_array_equal(short[-1000:], long[-1000:])
    # ...and the difference is exactly silence
    assert (long == 0).sum() == (short == 0).sum() + extra


def test_render_voice_mix_one_hot(runtime):
    a_id = render_ssml(
        runtime, '<speak><voice name="2"><phoneme ph="ab"/></voice></speak>')
    a_mix = render_ssml(
        runtime,
        '<speak><voice name="2:1.0"><phoneme ph="ab"/></voice></speak>')
    np.testing.assert_array_equal(a_id, a_mix)


def test_render_rate_changes_duration(runtime):
    fast = render_ssml(runtime, '<speak><prosody rate="x-fast">'
                                '<phoneme ph="abab"/></prosody></speak>')
    slow = render_ssml(runtime, '<speak><prosody rate="x-slow">'
                                '<phoneme ph="abab"/></prosody></speak>')
    assert len(slow) > len(fast)


def test_render_volume(runtime):
    plain = render_ssml(runtime, '<speak><phoneme ph="ab"/></speak>')
    quiet = render_ssml(runtime, '<speak><prosody volume="-6dB">'
                                 '<phoneme ph="ab"/></prosody></speak>')
    ratio = np.abs(quiet).max() / np.abs(plain).max()
    assert ratio == pytest.approx(10 ** (-6 / 20), rel=1e-3)


def test_cli_ssml(runtime, tmp_path):
    """The JAX CLI's --ssml cases on the library path the CLI renders
    through (render_ssml), then through the port's CLI's one-shot --ssml
    mode on the CPU: the same document written as a WAV of the same audio."""
    from piper_tpu_torch import cli
    from piper_tpu_torch.utils.wav import read_wav, write_wav

    doc = ('<speak><voice name="1"><phoneme ph="AB"/></voice>'
           '<break time="250ms"/><phoneme ph="BA"/></speak>')
    audio = render_ssml(runtime, doc)
    out = tmp_path / "ssml.wav"
    write_wav(out, audio, runtime.sample_rate)
    back, sr = read_wav(out)
    assert len(back) > int(0.25 * sr)
    assert render_ssml(runtime, '<speak><phoneme ph="AB"/></speak>').size > 0
    with pytest.raises(SsmlError):
        render_ssml(runtime, "<speak><broken")
    # an out-of-range <voice> id is an error, not a silent clamp to the
    # wrong speaker
    with pytest.raises(ValueError):
        render_ssml(runtime, '<speak><voice name="99"><phoneme ph="AB"/></voice></speak>')
    out_cli = tmp_path / "cli.wav"
    cli.main(["--model", str(runtime.model_path), "--device", "cpu", "--seed",
              str(runtime.options.seed), "--ssml", doc, "-o", str(out_cli)])
    np.testing.assert_array_equal(read_wav(out_cli)[0], back)
    with pytest.raises(SystemExit):
        cli.main(["--model", str(runtime.model_path), "--device", "cpu", "--ssml",
                  "<speak><broken", "-o", str(tmp_path / "x.wav")])


def test_render_out_of_range_voice_raises(runtime):
    with pytest.raises(ValueError):
        render_ssml(runtime, '<speak><voice name="99">'
                             '<phoneme ph="AB"/></voice></speak>')
    with pytest.raises(ValueError):
        render_ssml(runtime, '<speak><voice name="-1">'
                             '<phoneme ph="AB"/></voice></speak>')


def test_http_ssml(ms_voice):
    from piper_tpu_torch.engine.http_server import PiperHTTPServer

    srv = PiperHTTPServer({"v": PiperRuntime(*ms_voice, device="cpu")},
                          port=0, max_batch=4, max_wait_ms=10)
    srv.start()
    try:
        st, ctype, _, wav = _post(srv, "/v1/synthesize", {
            "ssml": '<speak><voice name="0:0.5,2:0.5">'
                    '<phoneme ph="AB"/></voice>'
                    '<break time="200ms"/>'
                    '<prosody rate="80%"><phoneme ph="BA"/>'
                    '</prosody></speak>'})
        assert st == 200 and ctype == "audio/wav" and wav[:4] == b"RIFF"
        # malformed / conflicting -> 400
        st, *_ = _post(srv, "/v1/synthesize", {"ssml": "<speak><broken"})
        assert st == 400
        st, *_ = _post(srv, "/v1/synthesize", {"ssml": "<speak><phoneme ph='AB'/></speak>",
                                               "speaker_id": 1})
        assert st == 400
        st, *_ = _post(srv, "/v1/synthesize", {
            "ssml": '<speak><voice name="9"><phoneme ph="AB"/></voice></speak>'})
        assert st == 400  # out-of-range speaker from door-step validation
        # end to end over the wire: a WAV at the voice's rate (the JAX
        # test reads it through client.py's PiperClient)
        st, _, _, wav = _post(srv, "/v1/synthesize",
                              {"ssml": '<speak><phoneme ph="AB"/></speak>'})
        audio, sr = _wav_samples(wav)
        assert st == 200 and len(audio) > 0 and sr == 16000
        # text and ssml together is a 400 (the SDK raises ValueError first)
        st, *_ = _post(srv, "/v1/synthesize", {"text": "x", "ssml": "<speak>y</speak>"})
        assert st == 400
    finally:
        srv.close()


def test_ssml_alignment_matches_render(runtime):
    from piper_tpu_torch.core.ssml import ssml_alignment

    doc = ('<speak><voice name="1"><phoneme ph="AB"/></voice>'
           '<break time="0.4s"/>'
           '<prosody rate="80%"><phoneme ph="BABA"/></prosody></speak>')
    audio = render_ssml(runtime, doc)
    align = ssml_alignment(runtime, doc)
    # the alignment doc describes EXACTLY the rendered waveform
    assert align["total_samples"] == len(audio)
    utts = align["utterances"]
    assert len(utts) == 2
    # the second utterance starts after utterance 1 + the explicit break
    # (spans come back already shifted by the utterance offsets)
    gap = int(round(0.4 * runtime.sample_rate))
    u0_end = utts[0]["phonemes"][-1]["end_sample"]
    assert utts[1]["phonemes"][0]["start_sample"] >= u0_end + gap - 1
    # spans fall inside the waveform
    assert utts[1]["phonemes"][-1]["end_sample"] <= len(audio)


def test_http_ssml_durations(ms_voice):
    from piper_tpu_torch.engine.http_server import PiperHTTPServer

    srv = PiperHTTPServer({"v": PiperRuntime(*ms_voice, device="cpu")},
                          port=0, max_batch=4, max_wait_ms=10)
    srv.start()
    try:
        doc = ('<speak><phoneme ph="AB"/><break time="0.3s"/>'
               '<voice name="0:0.5,2:0.5"><phoneme ph="BA"/></voice>'
               '</speak>')
        st, _, _, body = _post(srv, "/v1/durations", {"ssml": doc})
        align = json.loads(body)
        assert st == 200
        assert len(align["utterances"]) == 2
        assert align["total_samples"] > 0
        st, _, _, wav = _post(srv, "/v1/synthesize", {"ssml": doc})
        audio, _ = _wav_samples(wav)
        assert align["total_samples"] == len(audio)
        # conflicting knobs -> 400
        st, *_ = _post(srv, "/v1/durations", {"ssml": doc, "speaker_id": 1})
        assert st == 400
    finally:
        srv.close()


def test_http_ssml_ignored_surfaced(ms_voice):
    """Unsupported SSML features are REPORTED over HTTP (header on audio
    responses, 'ignored' in the durations JSON) — never silently dropped."""
    from piper_tpu_torch.engine.http_server import PiperHTTPServer

    srv = PiperHTTPServer({"v": PiperRuntime(*ms_voice, device="cpu")},
                          port=0, max_batch=4, max_wait_ms=10)
    srv.start()
    try:
        doc = ('<speak><prosody pitch="+2st"><phoneme ph="AB"/></prosody>'
               '</speak>')
        st, _, headers, _ = _post(srv, "/v1/synthesize", {"ssml": doc})
        assert st == 200
        assert "pitch" in (headers.get("X-Piper-Ignored") or "")
        st, _, _, body = _post(srv, "/v1/durations", {"ssml": doc})
        assert st == 200
        assert any("pitch" in m for m in json.loads(body).get("ignored", []))
    finally:
        srv.close()


def test_stream_bad_speaker_is_400(ms_voice):
    """Out-of-range speakers on the streaming surface fail BEFORE headers
    (clean 400) — not as a truncated 200 chunked body."""
    from piper_tpu_torch.engine.http_server import PiperStreamingHTTPServer

    srv = PiperStreamingHTTPServer(PiperRuntime(*ms_voice, device="cpu"), port=0,
                                   max_sessions=4)
    srv.start()
    try:
        for body in ({"phoneme_ids": list(FIXTURE_IDS), "speaker_id": 99},
                     {"ssml": '<speak><voice name="99">'
                              '<phoneme ph="AB"/></voice></speak>'}):
            st, *_ = _post(srv, "/v1/stream", body)
            assert st == 400, body
    finally:
        srv.close()


def test_streaming_http_ssml(ms_voice):
    from piper_tpu_torch.engine.http_server import PiperStreamingHTTPServer

    rt = PiperRuntime(*ms_voice, device="cpu")
    srv = PiperStreamingHTTPServer(rt, port=0, max_sessions=4)
    srv.start()
    try:
        doc = ('<speak><voice name="2"><phoneme ph="AB"/></voice>'
               '<break time="0.3s"/>'
               '<prosody volume="50%"><phoneme ph="BA"/></prosody></speak>')
        # the JAX test reads the chunks through client.py's
        # PiperStreamingClient; http.client decodes the chunked body
        st, ctype, headers, body = _post(srv, "/v1/stream", {"ssml": doc})
        assert st == 200 and ctype == "audio/x-raw-int16"
        audio = np.frombuffer(body, "<i2").astype(np.float32) / 32767.0
        assert int(headers["X-Sample-Rate"]) == rt.sample_rate
        # the break arrives as >= 0.3s of exact silence
        gap = int(round(0.3 * rt.sample_rate))
        assert (audio == 0).sum() >= gap
        assert np.abs(audio).max() > 0
        # conflicting knobs are 400s before any bytes
        st, *_ = _post(srv, "/v1/stream", {"ssml": doc, "speaker_id": 1})
        assert st == 400
    finally:
        srv.close()


def test_render_text_with_injected_phonemizer(runtime):
    audio = render_ssml(runtime, "<speak>Hello world. Second sentence."
                                 "</speak>", _fake_phonemize)
    assert len(audio) > 0 and np.isfinite(audio).all()
    # two sentences -> a default sentence gap of exact silence in between
    assert (audio == 0).sum() >= int(0.2 * runtime.sample_rate)


# -- the copy against its original ------------------------------------------

# The documents of the cases above (and of the JAX package's), good and bad.
DOCUMENTS = [
    "Hello there.",
    '<speak>a <break time="500ms"/> b <break time="0.25s"/><break strength="strong"/> c'
    '<break time="2s"/></speak>',
    '<speak>a<break strength="x-weak"/>b</speak>',
    '<speak>a<break strength="huge"/>b</speak>',
    '<speak>a<break time="5 parsecs"/>b</speak>',
    '<speak>a<break time="61s"/>b</speak>',
    '<speak><prosody rate="80%">slowish</prosody><prosody rate="fast" volume="-6dB">fast quiet'
    '</prosody><prosody pitch="+2st">pitchy</prosody></speak>',
    '<speak><prosody rate="0.01">x</prosody></speak>',
    '<speak><phoneme ph="ab">Fallback</phoneme> tail.</speak>',
    '<speak><phoneme>x</phoneme></speak>',
    '<speak><phoneme ph="a" alphabet="x-sampa">x</phoneme></speak>',
    '<speak><voice name="2">two</voice><voice name="0:0.6,3:0.4">blend</voice> outside</speak>',
    '<speak><voice name="alice">x</voice></speak>',
    '<speak><voice name="0:0.5,0:0.5">x</voice></speak>',
    '<speak><sub alias="World Wide Web">WWW</sub> and <say-as interpret-as="digits">123'
    '</say-as><wizard>magic</wizard></speak>',
    "<speak><p><s>One.</s><s>Two.</s></p><p>Three.</p></speak>",
    '<speak>Hello <mark name="m"/> world.</speak>',
    '<speak>Hel<mark name="m"/>lo there</speak>',
    '<speak>re<sub alias="new">old</sub>ing</speak>',
    '<speak><phoneme ph="aθ"/></speak>',
    "", "<speak><unclosed></speak>", '<speak><break time="1s"/></speak>',
    '<speak><phoneme ph="ab"/><break time="1s"/><phoneme ph="ab"/><phoneme ph="ba"/></speak>',
    '<speak><phoneme ph="ab"/><prosody rate="80%"><phoneme ph="ab"/></prosody>'
    '<voice name="1"><phoneme ph="ab"/></voice><voice name="0:0.5,1:0.5"><phoneme ph="ab"/>'
    '</voice><phoneme ph="ba"/></speak>',
    '<speak><prosody volume="2.0"><phoneme ph="ab"/></prosody></speak>',
    '<speak><voice name="spk2:1.0"><phoneme ph="ab"/></voice>'
    '<voice name="spk2:0.5,2:0.5"><phoneme ph="ab"/></voice></speak>',
    '<speak><voice name="99"><phoneme ph="ab"/></voice></speak>',
    "<speak>Hello world. Second sentence.</speak>",
] + [f'<speak><prosody {bad}>x</prosody></speak>'
     for bad in ('rate="abc"', 'rate="abc%"', 'rate="nan"', 'volume="abc"', 'volume="abcdb"',
                 'volume="nan"', 'volume="inf"', 'volume="8000dB"')]
PLAN_MAP = {"^": [1], "$": [2], "_": [0], "a": [20], "b": [21]}


def _resolver(spec):
    names = {f"spk{i}": i for i in range(4)}
    if isinstance(spec, str) and spec in names:
        return names[spec]
    sid = int(spec)
    if not 0 <= sid < 4:
        raise ValueError(f"speaker_id {sid} out of range [0, 4)")
    return sid


def _ssml_outcome(mod, doc, plan):
    import dataclasses

    try:
        if not plan:
            d = mod.parse_ssml(doc)
            return "ok", [dataclasses.asdict(s) for s in d.segments], d.ignored
        p = mod.plan_ssml(doc, PLAN_MAP, _fake_phonemize, sentence_silence=0.3,
                          speaker_resolver=_resolver)
        return ("ok", [(u.ids, dataclasses.asdict(u.ctx)) for u in p.utterances],
                p.assembly, p.ignored, mod.group_utterances(p),
                mod.assemble([np.full(4 * (i + 1), 0.7, np.float32)
                              for i in range(len(p.utterances))], p, 100).tolist())
    except Exception as e:  # noqa: BLE001 — the type and message are compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("plan", [False, True], ids=["parse", "plan"])
def test_ssml_copy_matches_the_reference(plan):
    """Every document through both packages' parse_ssml (segments with
    their contexts, ignored reports) or plan_ssml with the same
    phonemizer and speaker resolver (utterances, assembly, ignored,
    groups, assembled audio): equal, or the same error and message."""
    from piper_tpu.core import ssml as j_ssml
    from piper_tpu_torch.core import ssml as t_ssml

    for doc in DOCUMENTS:
        assert _ssml_outcome(t_ssml, doc, plan) == _ssml_outcome(j_ssml, doc, plan), doc


def test_submit_kwargs_and_offsets_match_the_reference():
    """The ctx -> submit kwargs map and the alignment offsets every HTTP
    handler uses, over one plan: equal in both packages."""
    from piper_tpu.core import ssml as j_ssml
    from piper_tpu_torch.core import ssml as t_ssml

    doc = DOCUMENTS[24]
    got = t_ssml.plan_ssml(doc, PLAN_MAP, speaker_resolver=_resolver)
    want = j_ssml.plan_ssml(doc, PLAN_MAP, speaker_resolver=_resolver)
    common = {"noise_w": 0.0, "seed": 3}
    assert ([t_ssml.submit_kwargs(u.ctx, common) for u in got.utterances]
            == [j_ssml.submit_kwargs(u.ctx, common) for u in want.utterances])
    durs = [np.array([3, 0, 5, 2, 1, 1]) * (i + 1) for i in range(len(got.utterances))]
    kw = dict(hop_length=32, sample_rate=16000, frame_cap=40)
    assert t_ssml.alignment_offsets(got, durs, **kw) == j_ssml.alignment_offsets(want, durs, **kw)
