"""SSML-lite input: expressive markup rendered through batched synthesis
(the port's copy of piper_tpu.core.ssml: the same subset, parser and
planner, over the port's runtime).

The reference accepts plain text / IPA / phoneme ids only
(PiperCLI.swift:31-234); production TTS
callers usually hold SSML. This module implements the useful, honest subset
of SSML 1.1 that VITS can actually realize, mapped onto piper-tpu's
existing primitives:

  <speak>            optional root (bare text is accepted)
  <p> / <s>          paragraph / sentence boundaries (gaps: 2x / 1x the
                     sentence silence)
  <break time="500ms"|"0.5s" strength="none|x-weak|weak|medium|strong|
                     x-strong"/>   explicit pause, replacing the automatic
                     gap at that position
  <prosody rate=.. volume=..>      rate -> length_scale (the duration
                     predictor's time axis), volume -> PCM gain. `pitch`
                     is IGNORED (VITS has no pitch input) and reported.
  <phoneme ph="..">  exact IPA for a span (alphabet="ipa"; bypasses espeak)
  <voice name="2" or name="0:0.6,3:0.4">   speaker id or speaker-mix blend
                     for a span (multi-speaker voices)
  <sub alias="..">   speak the alias instead of the content
  <say-as>, <emphasis>, <lang>, <w>, <token>, <mark>, <audio>   contents
                     are rendered, the unsupported semantics are reported
                     in `ignored` (never silently dropped NOR fatal).

Parsing is pure (stdlib ElementTree, testable without a phonemizer);
planning turns segments into utterances + an assembly script; rendering
groups utterances so same-(length_scale, conditioning-kind) spans form ONE
batched decode — the batched path, same as the sentence batcher. The
HTTP layer reuses the plan against BatchingServer futures instead (device
discipline: handlers never touch the device).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class SsmlError(ValueError):
    """Malformed SSML or a value the subset cannot realize."""


@dataclass(frozen=True)
class SsmlContext:
    """Prosody/voice state inherited down the element tree."""

    length_scale: Optional[float] = None  # 1/rate
    volume: float = 1.0                   # linear PCM gain
    speaker_id: Optional[int] = None
    # immutable form of a {id: weight} blend so contexts stay hashable;
    # keys may be NAMES until plan time resolves them (speaker_id_map)
    speaker_mix: Optional[Tuple[Tuple[object, float], ...]] = None
    # a <voice name="alba"> by NAME — resolved to speaker_id at plan time
    speaker_name: Optional[str] = None

    def mix_dict(self) -> Optional[dict]:
        return dict(self.speaker_mix) if self.speaker_mix is not None else None


@dataclass
class SsmlSegment:
    kind: str                    # "text" | "ipa" | "break"
    content: str = ""
    # break_s None on a break = "default gap" (sentence/paragraph boundary)
    break_s: Optional[float] = None
    break_scale: float = 1.0     # 2.0 for paragraph boundaries
    ctx: SsmlContext = field(default_factory=SsmlContext)


@dataclass
class SsmlDocument:
    segments: List[SsmlSegment]
    ignored: List[str]           # unsupported features encountered


_BREAK_STRENGTH_S = {
    "none": 0.0, "x-weak": 0.05, "weak": 0.1,
    "medium": 0.3, "strong": 0.6, "x-strong": 1.0,
}
_RATE_WORDS = {"x-slow": 0.5, "slow": 0.75, "medium": 1.0,
               "fast": 1.25, "x-fast": 1.5, "default": 1.0}
_VOLUME_WORDS = {"silent": 0.0, "x-soft": 0.25, "soft": 0.5,
                 "medium": 1.0, "loud": 1.25, "x-loud": 1.6,
                 "default": 1.0}

# SSML tags whose semantics we cannot realize: contents are spoken, the
# dropped behavior is reported.
_PASSTHROUGH_TAGS = {"say-as", "emphasis", "lang", "w", "token", "mark",
                     "audio", "desc", "lexicon", "lookup", "meta",
                     "metadata"}


def _parse_time_s(value: str) -> float:
    m = re.fullmatch(r"\s*([0-9]*\.?[0-9]+)\s*(ms|s)?\s*", value)
    if not m:
        raise SsmlError(f"bad break time {value!r} (use e.g. '500ms', '0.5s')")
    t = float(m.group(1))
    if m.group(2) == "ms":
        t /= 1e3
    if t > 60.0:
        raise SsmlError(f"break time {value!r} exceeds the 60 s cap")
    return t


def _parse_rate(value: str) -> float:
    import math

    v = value.strip().lower()
    try:
        if v in _RATE_WORDS:
            rate = _RATE_WORDS[v]
        elif v.endswith("%"):
            rate = float(v[:-1]) / 100.0
        else:
            rate = float(v)  # bare multiplier, e.g. "0.8"
    except ValueError:
        raise SsmlError(f"bad prosody rate {value!r} (use a keyword, "
                        f"'80%', or a multiplier like '0.8')") from None
    if not math.isfinite(rate) or not 0.1 <= rate <= 10.0:
        raise SsmlError(f"prosody rate {value!r} out of range [0.1, 10]")
    return rate


def _parse_volume(value: str) -> float:
    import math

    v = value.strip().lower()
    try:
        if v in _VOLUME_WORDS:
            gain = _VOLUME_WORDS[v]
        elif v.endswith("db"):
            gain = 10.0 ** (float(v[:-2]) / 20.0)
        elif v.endswith("%"):
            gain = float(v[:-1]) / 100.0
        else:
            gain = float(v)
    except (ValueError, OverflowError):
        raise SsmlError(f"bad prosody volume {value!r} (use a keyword, "
                        f"'+3dB', '50%', or a gain like '0.5')") from None
    # NaN passes `gain < 0`; inf turns zero samples into NaN at apply time.
    if not math.isfinite(gain) or not 0.0 <= gain <= 100.0:
        raise SsmlError(f"prosody volume {value!r} out of range [0, 100]")
    return gain


def _parse_voice_name(value: str):
    """'2' -> (id, None, None); 'alba' -> (None, None, name);
    '0:0.6,alba:0.4' -> (None, frozen mix tuple with int-or-name keys,
    None). Names resolve against the voice's speaker_id_map at plan time
    (switching CHECKPOINTS mid-document is not supported — names select
    speakers within the one loaded voice)."""
    v = value.strip()
    if not v:
        raise SsmlError("<voice> name must not be empty")
    if ":" in v:
        from piper_tpu_torch.engine.runtime import parse_mix_spec

        try:
            raw = parse_mix_spec(v)
        except ValueError as e:
            raise SsmlError(f"bad voice name {value!r}: {e}") from None
        return None, tuple(raw.items()), None
    try:
        return int(v), None, None
    except ValueError:
        return None, None, v


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1].lower()


def parse_ssml(doc: str) -> SsmlDocument:
    """Parse an SSML(-lite) string into ordered segments. Pure — no
    phonemizer, no runtime. Raises SsmlError on malformed XML or values
    outside the subset; unsupported-but-harmless features land in
    `ignored` instead."""
    text = doc.strip()
    if not text:
        raise SsmlError("empty SSML document")
    if not text.startswith("<"):
        text = f"<speak>{text}</speak>"
    try:
        root = ET.fromstring(text)
    except ET.ParseError as e:
        raise SsmlError(f"malformed SSML: {e}") from e
    if _strip_ns(root.tag) != "speak":
        root_wrap = ET.Element("speak")
        root_wrap.append(root)
        root = root_wrap

    segments: List[SsmlSegment] = []
    ignored: List[str] = []

    def emit_text(chunk: Optional[str], ctx: SsmlContext) -> None:
        if not chunk:
            return
        # Merge RAW text into the previous text segment when the context
        # matches — keeps espeak calls and sentence splitting natural
        # across markup that didn't change anything audible. Raw (not
        # normalized) concatenation preserves word boundaries exactly:
        # 'Hel<mark/>lo' stays one word, 'Hello <mark/> world' stays two.
        # Whitespace normalization happens once, after the walk.
        merge = (segments and segments[-1].kind == "text"
                 and segments[-1].ctx == ctx)
        if not chunk.strip():
            if merge:  # pure whitespace still carries the word boundary
                segments[-1].content += chunk
            return
        if merge:
            segments[-1].content += chunk
        else:
            segments.append(SsmlSegment("text", chunk, ctx=ctx))

    def emit_break(seconds: Optional[float], scale: float = 1.0) -> None:
        # collapse adjacent breaks: explicit wins over default, longer
        # explicit wins over shorter
        if segments and segments[-1].kind == "break":
            prev = segments[-1]
            if seconds is None:
                prev.break_scale = max(prev.break_scale, scale)
                return
            if prev.break_s is None or prev.break_s < seconds:
                prev.break_s, prev.break_scale = seconds, 1.0
            return
        if segments:  # leading breaks are silence nobody hears
            segments.append(SsmlSegment("break", break_s=seconds,
                                        break_scale=scale))

    def walk(el, ctx: SsmlContext) -> None:
        tag = _strip_ns(el.tag)
        child_ctx = ctx
        boundary = None  # gap scale emitted before AND after this element
        if tag == "speak":
            pass
        elif tag == "p":
            boundary = 2.0
        elif tag == "s":
            boundary = 1.0
        elif tag == "break":
            t = el.get("time")
            strength = el.get("strength")
            if t is not None:
                emit_break(_parse_time_s(t))
            elif strength is not None:
                if strength not in _BREAK_STRENGTH_S:
                    raise SsmlError(f"bad break strength {strength!r}")
                emit_break(_BREAK_STRENGTH_S[strength])
            else:
                emit_break(None)
        elif tag == "prosody":
            if el.get("pitch") is not None or el.get("range") is not None:
                ignored.append("prosody pitch/range (VITS has no pitch "
                               "input; use rate/volume)")
            if el.get("rate") is not None:
                child_ctx = replace(child_ctx,
                                    length_scale=1.0 / _parse_rate(el.get("rate")))
            if el.get("volume") is not None:
                child_ctx = replace(
                    child_ctx,
                    volume=ctx.volume * _parse_volume(el.get("volume")))
        elif tag == "phoneme":
            ph = el.get("ph")
            if ph is None:
                raise SsmlError("<phoneme> requires a ph attribute")
            alphabet = (el.get("alphabet") or "ipa").lower()
            if alphabet != "ipa":
                raise SsmlError(
                    f"<phoneme alphabet={alphabet!r}> unsupported (ipa only)")
            segments.append(SsmlSegment("ipa", ph, ctx=ctx))
            # the written fallback content is NOT spoken (ph replaces it);
            # tail text is the parent loop's job
            return
        elif tag == "voice":
            name = el.get("name")
            if name is None:
                raise SsmlError("<voice> requires a name attribute")
            sid, mix, spk_name = _parse_voice_name(name)
            child_ctx = replace(child_ctx, speaker_id=sid, speaker_mix=mix,
                                speaker_name=spk_name)
        elif tag == "sub":
            emit_text(el.get("alias", ""), ctx)
            return  # tail text is the parent loop's job
        elif tag in _PASSTHROUGH_TAGS:
            ignored.append(f"<{tag}> semantics (contents rendered as text)")
        else:
            ignored.append(f"unknown element <{tag}> (contents rendered)")

        if boundary is not None:
            emit_break(None, boundary)
        if el.text:
            emit_text(el.text, child_ctx)
        for child in el:
            walk(child, child_ctx)
            if child.tail and child.tail.strip():
                # tail text belongs to THIS element's context, not the
                # child's (the classic ElementTree footgun)
                emit_text(child.tail, child_ctx)
        if boundary is not None:
            emit_break(None, boundary)

    walk(root, SsmlContext())
    for s in segments:
        if s.kind == "text":
            s.content = re.sub(r"\s+", " ", s.content).strip()
    segments = [s for s in segments if s.kind != "text" or s.content]
    while segments and segments[-1].kind == "break":
        segments.pop()  # trailing silence nobody hears
    if not any(s.kind in ("text", "ipa") for s in segments):
        raise SsmlError("SSML document contains nothing to speak")
    return SsmlDocument(segments, ignored)


@dataclass
class SsmlUtterance:
    ids: List[int]
    ctx: SsmlContext


@dataclass
class SsmlPlan:
    """Utterances plus the assembly script: items are ("utt", index) or
    ("gap", seconds) — gaps carry their final duration (defaults already
    resolved against sentence_silence)."""

    utterances: List[SsmlUtterance]
    assembly: List[tuple]
    ignored: List[str]


def plan_ssml(
    doc: "SsmlDocument | str",
    phoneme_id_map: Dict[str, List[int]],
    phonemize: Optional[Callable[[str], List[int]]] = None,
    *,
    sentence_silence: float = 0.2,
    speaker_resolver: Optional[Callable[[str], int]] = None,
) -> SsmlPlan:
    """Turn parsed SSML into utterances + an assembly script.

    `phonemize(text) -> ids` is required only when the document has plain
    text (an <phoneme>-only document needs none). Sentence boundaries
    inside a text segment get the default gap; explicit <break>s REPLACE
    the automatic gap at their position (SSML semantics).

    `speaker_resolver(name) -> id` (e.g. PiperRuntime.speaker_index)
    resolves <voice> NAMES against the voice's speaker_id_map; a document
    that names speakers without one is an SsmlError."""
    from piper_tpu_torch.core.phonemes import UnknownSymbolError, ipa_to_ids
    from piper_tpu_torch.core.text import split_sentences

    if isinstance(doc, str):
        doc = parse_ssml(doc)
    if sentence_silence < 0:
        raise SsmlError("sentence_silence must be >= 0")

    def resolved(ctx: SsmlContext) -> SsmlContext:
        """<voice> names AND integer ids -> validated speaker ids at plan
        time (parsing is pure and has no voice to check against). With a
        resolver, out-of-range ids fail HERE as SsmlError (HTTP 400 / tidy
        CLI exit) instead of asynchronously at dispatch — on the streaming
        surface that difference is a clean 400 vs a truncated 200 body."""
        if (ctx.speaker_name is None and ctx.speaker_id is None
                and ctx.speaker_mix is None):
            return ctx
        named = (ctx.speaker_name is not None
                 or (ctx.speaker_mix is not None
                     and any(isinstance(k, str) for k, _ in ctx.speaker_mix)))
        if speaker_resolver is None:
            if named:
                raise SsmlError(
                    "document selects speakers by NAME but no speaker "
                    "resolver is available (the loaded voice has no "
                    "speaker_id_map?)")
            return ctx  # integer ids validate downstream
        try:
            if ctx.speaker_name is not None:
                return replace(ctx, speaker_name=None,
                               speaker_id=int(speaker_resolver(ctx.speaker_name)))
            if ctx.speaker_id is not None:
                return replace(ctx,
                               speaker_id=int(speaker_resolver(ctx.speaker_id)))
            out, seen = [], set()
            for k, w in ctx.speaker_mix:
                kid = int(speaker_resolver(k))
                if kid in seen:
                    raise SsmlError(f"voice mix names speaker {kid} twice")
                seen.add(kid)
                out.append((kid, w))
            return replace(ctx, speaker_mix=tuple(out))
        except SsmlError:
            raise
        except ValueError as e:
            raise SsmlError(f"<voice>: {e}") from e

    utterances: List[SsmlUtterance] = []
    assembly: List[tuple] = []
    pending_gap: Optional[float] = None  # None = no explicit break seen

    def push_utt(ids: List[int], ctx: SsmlContext) -> None:
        nonlocal pending_gap
        if assembly and assembly[-1][0] == "utt":
            gap = sentence_silence if pending_gap is None else pending_gap
            if gap > 0:
                assembly.append(("gap", gap))
        elif pending_gap:  # break before the first utterance of a run
            assembly.append(("gap", pending_gap))
        pending_gap = None
        assembly.append(("utt", len(utterances)))
        utterances.append(SsmlUtterance(ids, resolved(ctx)))

    for seg in doc.segments:
        if seg.kind == "break":
            gap = (sentence_silence * seg.break_scale
                   if seg.break_s is None else seg.break_s)
            pending_gap = gap if pending_gap is None else max(pending_gap, gap)
        elif seg.kind == "ipa":
            try:
                push_utt(ipa_to_ids(seg.content, phoneme_id_map), seg.ctx)
            except UnknownSymbolError as e:
                # UnknownSymbolError is a KeyError; left bare it maps to
                # "unknown voice" (404) on the HTTP surface and a traceback
                # in the CLI — a document typo is a document error.
                raise SsmlError(
                    f"<phoneme ph={seg.content!r}> contains a symbol this "
                    f"voice's phoneme_id_map lacks: {e}") from e
        else:  # text
            if phonemize is None:
                raise SsmlError(
                    "document contains plain text but no phonemizer is "
                    "available (install espeak-ng, or mark up exact "
                    "pronunciations with <phoneme ph=...>)")
            for sent in split_sentences(seg.content):
                try:
                    push_utt(phonemize(sent), seg.ctx)
                except UnknownSymbolError as e:
                    raise SsmlError(
                        f"phonemizing {sent!r} produced a symbol this "
                        f"voice's phoneme_id_map lacks: {e}") from e
    return SsmlPlan(utterances, assembly, doc.ignored)


def assemble(
    audios: Sequence[np.ndarray],
    plan: SsmlPlan,
    sample_rate: int,
) -> np.ndarray:
    """Stitch per-utterance float32 PCM into the final waveform: gaps from
    the assembly script, per-utterance volume applied (clipped to [-1, 1]
    — SSML volume is a gain, and the WAV writer would wrap otherwise)."""
    parts: List[np.ndarray] = []
    for item in plan.assembly:
        if item[0] == "gap":
            parts.append(np.zeros(int(round(item[1] * sample_rate)),
                                  np.float32))
            continue
        i = item[1]
        a = np.asarray(audios[i], np.float32)
        vol = plan.utterances[i].ctx.volume
        if vol != 1.0:
            a = np.clip(a * vol, -1.0, 1.0)
        parts.append(a)
    if not parts:
        return np.zeros(0, np.float32)
    return np.concatenate(parts)


def group_utterances(plan: SsmlPlan) -> List[List[int]]:
    """Indices grouped by (length_scale, conditioning-kind): each group is
    ONE batched decode (speaker ids/mixes vary per row; length_scale is a
    per-call scalar, and id vs mix conditioning compile distinct
    programs)."""
    groups: Dict[tuple, List[int]] = {}
    for i, u in enumerate(plan.utterances):
        key = (u.ctx.length_scale, u.ctx.speaker_mix is not None)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def submit_kwargs(ctx: SsmlContext, common: Optional[dict] = None) -> dict:
    """An utterance context as per-request synthesis kwargs — the ONE
    ctx->kwargs mapping for every surface (render, alignment, the three
    HTTP handlers). `common` carries request-level knobs (noise scales,
    seed)."""
    kw = dict(common or {})
    if ctx.length_scale is not None:
        kw["length_scale"] = ctx.length_scale
    if ctx.speaker_mix is not None:
        kw["speaker_mix"] = ctx.mix_dict()
    elif ctx.speaker_id is not None:
        kw["speaker_id"] = ctx.speaker_id
    return kw


def alignment_offsets(
    plan: SsmlPlan,
    durations: Sequence[np.ndarray],
    *,
    hop_length: int,
    sample_rate: int,
    frame_cap: int,
) -> Tuple[List[int], List[int], int]:
    """Where each utterance lands in the assembled waveform.

    Returns (offsets_samples, lengths_samples, total_samples) — lengths are
    the decode plan's (sum of frames, >=1, capped at the runtime's largest
    frame bucket like the synthesized audio is), offsets walk the assembly
    script, so they match a render of the same document exactly (volume is
    a gain, it does not move time)."""
    lengths = [
        min(max(int(np.asarray(d).sum()), 1), frame_cap) * hop_length
        for d in durations
    ]
    offsets = [0] * len(plan.utterances)
    pos = 0
    for item in plan.assembly:
        if item[0] == "gap":
            pos += int(round(item[1] * sample_rate))
        else:
            offsets[item[1]] = pos
            pos += lengths[item[1]]
    return offsets, lengths, pos


def ssml_alignment(
    runtime,
    doc: "SsmlDocument | str",
    phonemize: Optional[Callable[[str], List[int]]] = None,
    *,
    sentence_silence: float = 0.2,
    noise_w: Optional[float] = None,
    seed: Optional[int] = None,
) -> dict:
    """Phoneme-level timing of an SSML document WITHOUT synthesizing audio
    (encoder-only): the alignment JSON document a render of the same
    markup realizes — per-utterance spans, offsets including breaks and
    sentence gaps. The library analog of HTTP POST /v1/durations with
    \"ssml\"."""
    from piper_tpu_torch.core.alignment import alignments_to_json, make_alignment

    plan = plan_ssml(doc, runtime.config.phoneme_id_map, phonemize,
                     sentence_silence=sentence_silence,
                     speaker_resolver=runtime.speaker_index)
    durations: List[Optional[np.ndarray]] = [None] * len(plan.utterances)
    for idx_group in group_utterances(plan):
        rows = [plan.utterances[i] for i in idx_group]
        has_mix = rows[0].ctx.speaker_mix is not None
        sids = None
        if not has_mix and any(r.ctx.speaker_id is not None for r in rows):
            sids = [r.ctx.speaker_id or 0 for r in rows]
        durs = runtime.phoneme_durations(
            [r.ids for r in rows],
            length_scale=rows[0].ctx.length_scale,
            noise_w=noise_w,
            speaker_ids=sids,
            speaker_mixes=([r.ctx.mix_dict() for r in rows]
                           if has_mix else None),
            seed=seed,
        )
        for i, d in zip(idx_group, durs):
            durations[i] = d
    hop, sr = runtime.hparams.hop_length, runtime.sample_rate
    offsets, lengths, total = alignment_offsets(
        plan, durations, hop_length=hop, sample_rate=sr,
        frame_cap=runtime.options.frame_buckets[-1])
    aligns = [
        make_alignment(u.ids, d, hop_length=hop, sample_rate=sr,
                       total_samples=n)
        for u, d, n in zip(plan.utterances, durations, lengths)
    ]
    out = alignments_to_json(aligns, offsets)
    out["sample_rate"] = sr
    out["total_samples"] = total
    return out


def render_ssml(
    runtime,
    doc: "SsmlDocument | str",
    phonemize: Optional[Callable[[str], List[int]]] = None,
    *,
    sentence_silence: float = 0.2,
    noise_scale: Optional[float] = None,
    noise_w: Optional[float] = None,
    seed: Optional[int] = None,
) -> np.ndarray:
    """Synthesize an SSML document on a PiperRuntime directly (the CLI /
    library path; HTTP plans against BatchingServer futures instead).
    Returns float32 PCM at runtime.sample_rate."""
    from piper_tpu_torch.core.audio import pcm_to_float32

    plan = plan_ssml(doc, runtime.config.phoneme_id_map, phonemize,
                     sentence_silence=sentence_silence,
                     speaker_resolver=runtime.speaker_index)
    audios: List[Optional[np.ndarray]] = [None] * len(plan.utterances)
    for idx_group in group_utterances(plan):
        rows = [plan.utterances[i] for i in idx_group]
        has_mix = rows[0].ctx.speaker_mix is not None
        sids = None
        if not has_mix and any(r.ctx.speaker_id is not None for r in rows):
            sids = [r.ctx.speaker_id or 0 for r in rows]
        out = runtime.synthesize_batch(
            [r.ids for r in rows],
            noise_scale=noise_scale,
            length_scale=rows[0].ctx.length_scale,
            noise_w=noise_w,
            speaker_ids=sids,
            speaker_mixes=([r.ctx.mix_dict() for r in rows]
                           if has_mix else None),
            seed=seed,  # None -> the runtime's seeded default, same as
            # ssml_alignment, so timing and audio agree
        )
        for i, a in zip(idx_group, out):
            audios[i] = pcm_to_float32(a)
    return assemble(audios, plan, runtime.sample_rate)
