"""piper-tpu command line on the port (PyTorch and CUDA).

Every mode of piper_tpu.cli, with its flags, messages and JSON schemas:
one-shot synthesis from --text / --ipa / --phoneme-ids / --ssml (speakers by
id, name or mix, forced durations, alignment JSON, --stream with --play,
sentence gaps), the interactive REPL, --list-voices, the bench modes
(--bench-summary, --scale-bench, --microbench), the test-vector modes
(--record-vectors, --verify-summary) and the HTTP server (--serve
[--stream]). The runtimes go to `--device`: "cuda" by default, which raises
where there is no card; "cpu" only when asked.

    python -m piper_tpu_torch.cli --model m.onnx --phoneme-ids 1,20,0,2 -o out.wav
    python -m piper_tpu_torch.cli --serve [--stream] --model a.onnx[,b.onnx] [--prewarm]

--microbench times a chain of 16 adds launched eagerly against the same
chain replayed from one CUDA graph, the port's counterpart of one jit
program; on the CPU there is no graph, and its time is null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from piper_tpu_torch.core.phonemes import ipa_to_ids
from piper_tpu_torch.core.test_vector import TestSummary
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions
from piper_tpu_torch.utils.wav import write_wav


def _percentile(xs: List[float], p: float) -> float:
    s = sorted(xs)
    k = (len(s) - 1) * (p / 100.0)
    f, c = int(np.floor(k)), int(np.ceil(k))
    if f == c:
        return s[f]
    return s[f] + (s[c] - s[f]) * (k - f)


def _cli_options(args) -> RuntimeOptions:
    """Env flags (PIPER_TPU_PRECISION/MODE) as base; explicit CLI args win.
    Raises ValueError for an option value the port does not carry."""
    from dataclasses import replace

    options = replace(RuntimeOptions.from_env(), seed=args.seed)
    if args.precision is not None:
        options = replace(options, precision=args.precision)
    if getattr(args, "output_dtype", None) is not None:
        options = replace(options, output_dtype=args.output_dtype)
    from piper_tpu_torch.engine.runtime import parse_precision_spec

    if getattr(args, "flow_precision", None) is not None:
        options = replace(
            options, flow_precision=parse_precision_spec(args.flow_precision))
    if getattr(args, "vocoder_precision", None) is not None:
        options = replace(
            options,
            vocoder_precision=parse_precision_spec(args.vocoder_precision))
    options.validate()
    return options


def _options_or_exit(args) -> RuntimeOptions:
    try:
        return _cli_options(args)
    except ValueError as e:  # an option value the port does not carry
        raise SystemExit(f"piper-tpu: {e}") from None


def _load_runtime(args) -> PiperRuntime:
    options = _options_or_exit(args)
    if args.voice:
        return PiperRuntime.load_voice(args.voice, options, device=args.device)
    if args.model:
        return PiperRuntime(args.model, args.config, options, device=args.device)
    raise SystemExit("pass --voice <id> or --model <path> [--config <path>]")


def _resolve_runtime_for_summary(args, summary: TestSummary) -> PiperRuntime:
    if args.voice or args.model:
        return _load_runtime(args)
    if summary.model_path:
        model = Path(summary.model_path)
        if not model.is_absolute():
            model = summary.base_dir / model
        config = Path(summary.config_path) if summary.config_path else None
        if config is not None and not config.is_absolute():
            config = summary.base_dir / config
        return PiperRuntime(model, config, _options_or_exit(args), device=args.device)
    raise SystemExit(
        "bench summary has empty model_path/config_path; pass --voice or --model/--config"
    )


def _phoneme_ids_for(args, rt: PiperRuntime) -> List[int]:
    if args.phoneme_ids:
        return [int(x) for x in args.phoneme_ids.replace(",", " ").split()]
    if args.ipa:
        return ipa_to_ids(args.ipa, rt.config.phoneme_id_map)
    if args.text:
        from piper_tpu_torch.phonemize import ESpeakPhonemizer

        voice = rt.config.espeak.voice if rt.config.espeak else "en"
        return ESpeakPhonemizer(voice, rt.config.phoneme_id_map).phoneme_ids(args.text)
    raise SystemExit("pass --text, --ipa, or --phoneme-ids (or use the REPL)")


def _sentence_ids_for(args, rt: PiperRuntime) -> List[List[int]]:
    """Phoneme ids per sentence: --text splits into sentences (a paragraph
    becomes one batched decode with --sentence-silence gaps); --ipa /
    --phoneme-ids and --no-sentence-split stay single-utterance."""
    if args.text and not getattr(args, "no_sentence_split", False):
        from piper_tpu_torch.core.text import split_sentences

        sents = split_sentences(args.text)
        if len(sents) > 1:
            from piper_tpu_torch.phonemize import ESpeakPhonemizer

            voice = rt.config.espeak.voice if rt.config.espeak else "en"
            ph = ESpeakPhonemizer(voice, rt.config.phoneme_id_map)
            return [ph.phoneme_ids(s) for s in sents]
    return [_phoneme_ids_for(args, rt)]


def _parse_speaker_mix(spec: str, rt: Optional[PiperRuntime] = None) -> dict:
    """'0:0.6,3:0.4' (or 'alba:0.6,cori:0.4' with a loaded runtime whose
    config has a speaker_id_map) -> {0: 0.6, 3: 0.4} with tidy errors.
    Grammar and key resolution live in engine/runtime (parse_mix_spec +
    resolve_speaker_mix — one copy for CLI and SSML)."""
    from piper_tpu_torch.engine.runtime import parse_mix_spec

    try:
        raw = parse_mix_spec(spec)
    except ValueError as e:
        raise SystemExit(f"--speaker-mix: {e}")
    if rt is None:
        if any(isinstance(k, str) for k in raw):
            raise SystemExit("--speaker-mix: speaker names need a loaded "
                             "voice to resolve")
        return raw
    try:
        return rt.resolve_speaker_mix(raw)
    except ValueError as e:
        raise SystemExit(f"--speaker-mix: {e}")


def _synth_args(args, rt: Optional[PiperRuntime] = None) -> dict:
    out = {}
    if args.noise_scale is not None:
        out["noise_scale"] = args.noise_scale
    if args.length_scale is not None:
        out["length_scale"] = args.length_scale
    if args.noise_w is not None:
        out["noise_w"] = args.noise_w
    n_speaker_flags = sum(1 for v in (args.speaker_id,
                                      getattr(args, "speaker", None),
                                      getattr(args, "speaker_mix", None))
                          if v is not None)
    if n_speaker_flags > 1:
        raise SystemExit(
            "pass ONE of --speaker / --speaker-id / --speaker-mix")
    if args.speaker_id is not None:
        out["speaker_id"] = args.speaker_id
    if getattr(args, "speaker", None) is not None:
        if rt is None:
            raise SystemExit("--speaker needs a loaded voice to resolve")
        try:
            out["speaker_id"] = rt.speaker_index(args.speaker)
        except ValueError as e:
            raise SystemExit(f"--speaker: {e}")
    if getattr(args, "speaker_mix", None) is not None:
        # `is not None`, matching the exclusivity count above: an empty
        # string should be a parse error, not a silently ignored flag.
        out["speaker_mix"] = _parse_speaker_mix(args.speaker_mix, rt)
    return out


def _batch_synth_args(args, n_rows: int, rt: Optional[PiperRuntime] = None) -> dict:
    """_synth_args translated for synthesize_batch, which takes
    speaker_ids / speaker_mixes (one per row) instead of scalars."""
    out = _synth_args(args, rt)
    sid = out.pop("speaker_id", None)
    if sid is not None:
        out["speaker_ids"] = [sid] * n_rows
    mix = out.pop("speaker_mix", None)
    if mix is not None:
        out["speaker_mixes"] = [mix] * n_rows
    return out


def _write_alignment(path, rt: PiperRuntime, ids_list, audios,
                     gap_samples: int, args, forced_durs=None) -> None:
    """Write the phoneme-level alignment JSON for the utterances just
    synthesized: per-utterance spans from PiperRuntime.phoneme_durations
    (exact — same seeded plan the decode realized), offsets from the ACTUAL
    audio lengths plus the sentence gaps. A --force-durations run's plan IS
    the alignment — no encoder pass needed."""
    import json

    from piper_tpu_torch.core.alignment import alignments_to_json, make_alignment

    if forced_durs is not None:
        durs = [np.asarray(forced_durs, np.int64)]
    else:
        dur_args = _synth_args(args, rt)
        dur_args.pop("noise_scale", None)  # durations don't depend on it
        sid = dur_args.pop("speaker_id", None)
        if sid is not None:
            dur_args["speaker_ids"] = [sid] * len(ids_list)
        mix = dur_args.pop("speaker_mix", None)
        if mix is not None:
            dur_args["speaker_mixes"] = [mix] * len(ids_list)
        durs = rt.phoneme_durations(ids_list, **dur_args)
    hop, sr = rt.hparams.hop_length, rt.sample_rate
    aligns, offsets, pos = [], [], 0
    for ids, d, a in zip(ids_list, durs, audios):
        aligns.append(make_alignment(ids, d, hop_length=hop, sample_rate=sr,
                                     total_samples=len(a)))
        offsets.append(pos)
        pos += len(a) + gap_samples
    doc = alignments_to_json(aligns, offsets)
    doc["sample_rate"] = sr
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote alignment {path}: "
          f"{sum(len(x) for x in ids_list)} phonemes across "
          f"{len(ids_list)} utterance(s)", file=sys.stderr)


def run_oneshot(args) -> None:
    import time

    from piper_tpu_torch.utils.wav import WavWriter

    rt = _load_runtime(args)
    if args.prewarm:
        stats = rt.prewarm()
        print(f"prewarmed {stats['programs']} programs in {stats['seconds']:.1f}s",
              file=sys.stderr)
    if args.sentence_silence < 0:
        raise SystemExit("--sentence-silence must be >= 0")
    if args.alignment and args.stream:
        raise SystemExit("--alignment is not supported with --stream "
                         "(streamed windows decode incrementally; run "
                         "without --stream for timing JSON)")
    forced_durs = None
    if args.force_durations:
        if args.stream:
            raise SystemExit("--force-durations is not supported with "
                             "--stream (a forced plan decodes in one pass)")
        if args.length_scale is not None or args.noise_w is not None:
            raise SystemExit("--length-scale/--noise-w have no effect with "
                             "--force-durations (they shape the predictor "
                             "the plan replaces); scale the plan instead")
        try:
            forced_durs = [int(x) for x in args.force_durations.split(",")]
        except ValueError:
            raise SystemExit("--force-durations must be comma-separated "
                             "integer frame counts")
    ids_list = _sentence_ids_for(args, rt)
    if forced_durs is not None:
        if len(ids_list) > 1:
            raise SystemExit("--force-durations needs a single utterance "
                             "(the plan maps 1:1 onto its phonemes); use "
                             "--no-sentence-split or pass --phoneme-ids")
        # Surface plan mistakes as tidy messages, not tracebacks.
        if len(forced_durs) != len(ids_list[0]):
            raise SystemExit(
                f"--force-durations has {len(forced_durs)} frame counts "
                f"but the utterance has {len(ids_list[0])} phonemes")
        if any(d < 0 for d in forced_durs):
            raise SystemExit("--force-durations frame counts must be >= 0")
        if sum(forced_durs) < 1:
            raise SystemExit("--force-durations needs at least one non-zero "
                             "frame count")
    ids = ids_list[0]
    gap_samples = int(round(args.sentence_silence * rt.sample_rate))
    out = args.output or "out.wav"
    if len(ids_list) > 1 and not args.stream:
        # A paragraph's sentences form ONE batched decode, joined with
        # sentence-silence gaps.
        from piper_tpu_torch.core.audio import join_with_silence

        t0 = time.perf_counter()
        audios = rt.synthesize_batch(ids_list, **_batch_synth_args(
            args, len(ids_list), rt))
        wall_ms = (time.perf_counter() - t0) * 1e3
        audio = join_with_silence(audios, gap_samples)
        write_wav(out, audio, rt.sample_rate)
        if args.alignment:
            _write_alignment(args.alignment, rt, ids_list, audios,
                             gap_samples, args)
        secs = len(audio) / rt.sample_rate
        print(
            f"wrote {out}: {len(ids_list)} sentences, {len(audio)} samples "
            f"({secs:.2f}s) in {wall_ms:.1f} ms "
            f"(RTF {secs * 1e3 / max(wall_ms, 1e-9):.1f}x, batched)"
        )
        if args.play:
            _play(str(out))
        return
    if args.stream and len(ids_list) > 1:
        run_stream_sentences(args, rt, ids_list,
                             np.zeros(gap_samples, np.float32), out)
        return
    if args.stream:
        # Incremental decode: audio reaches the file (and, with --play, the
        # player's stdin — playback starts after the FIRST chunk, the analog
        # of the reference's live buffer scheduling, AudioPlayer.swift:4-43)
        # chunk by chunk.
        player = None
        if args.play:
            from piper_tpu_torch.utils.playback import StreamingPlayer

            try:
                player = StreamingPlayer(rt.sample_rate)
            except RuntimeError as e:
                print(f"{e}; will play the finished file instead",
                      file=sys.stderr)
        t0 = time.perf_counter()
        first_ms = None
        n = 0
        try:
            with WavWriter(out, rt.sample_rate) as w:
                for chunk in rt.synthesize_stream(ids, incremental=True,
                                                  **_synth_args(args, rt)):
                    if first_ms is None:
                        first_ms = (time.perf_counter() - t0) * 1e3
                    w.append_float32(chunk.samples)
                    if player is not None:
                        player.play(chunk.samples)
                    n += len(chunk.samples)
                # Stop the synthesis clock before draining the player —
                # close() blocks until playback finishes, which would fold
                # the audio's own duration into the reported streaming time.
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if player is not None:
                player.close()
        print(
            f"wrote {out}: {n} samples ({n / rt.sample_rate:.2f}s) streamed in "
            f"{wall_ms:.1f} ms (first audio after {first_ms:.1f} ms)"
        )
        if args.play and player is None:
            _play(str(out))
    else:
        if forced_durs is not None:
            # _synth_args can't contain length_scale/noise_w here — setting
            # them with --force-durations already raised above.
            audio = rt.synthesize_forced(ids, forced_durs, **_synth_args(args, rt))
        else:
            audio = rt.synthesize(ids, **_synth_args(args, rt))
        write_wav(out, audio, rt.sample_rate)
        if args.alignment:
            _write_alignment(args.alignment, rt, [ids], [audio], 0, args,
                             forced_durs=forced_durs)
        t = rt.last_run_timings
        print(
            f"wrote {out}: {len(audio)} samples ({len(audio) / rt.sample_rate:.2f}s) "
            f"in {t.wall_ms:.1f} ms (RTF {t.rtf:.1f}x)"
        )
        if args.play:
            _play(str(out))


def run_stream_sentences(args, rt: PiperRuntime, ids_list, gap, out) -> None:
    """--stream over multi-sentence --text: stream each sentence's
    incremental decode in order, writing sentence-silence gaps between
    (playback — when available — starts after sentence 1's first chunk)."""
    from piper_tpu_torch.utils.wav import WavWriter

    player = None
    if args.play:
        from piper_tpu_torch.utils.playback import StreamingPlayer

        try:
            player = StreamingPlayer(rt.sample_rate)
        except RuntimeError as e:
            print(f"{e}; will play the finished file instead", file=sys.stderr)
    t0 = time.perf_counter()
    first_ms = None
    n = 0
    try:
        with WavWriter(out, rt.sample_rate) as w:
            for i, ids in enumerate(ids_list):
                if i and len(gap):
                    w.append_float32(gap)
                    if player is not None:
                        player.play(gap)
                    n += len(gap)
                for chunk in rt.synthesize_stream(ids, incremental=True,
                                                  **_synth_args(args, rt)):
                    if first_ms is None:
                        first_ms = (time.perf_counter() - t0) * 1e3
                    w.append_float32(chunk.samples)
                    if player is not None:
                        player.play(chunk.samples)
                    n += len(chunk.samples)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if player is not None:
            player.close()
    print(
        f"wrote {out}: {len(ids_list)} sentences, {n} samples "
        f"({n / rt.sample_rate:.2f}s) streamed in {wall_ms:.1f} ms "
        f"(first audio after {first_ms:.1f} ms)"
    )
    if args.play and player is None:
        _play(str(out))


def _install_sigterm_drain(holder: list) -> None:
    """SIGTERM (the `kill`/container-stop signal) drains like Ctrl-C:
    stop accepting, serve everything already admitted, exit 0. Without
    this an orchestrator stop kills admitted requests mid-flight.

    `holder` is filled with the server object once it exists; the handler
    stops its accept loop from a helper thread (BaseServer.shutdown blocks
    until the loop exits, and the loop runs on THIS thread — calling it
    inline would deadlock). Raising out of the handler instead would race:
    a signal landing outside the serve try/except kills the process with
    a traceback."""
    import signal
    import threading

    def _term(signum, frame):
        print("piper-tpu: SIGTERM — draining admitted requests",
              file=sys.stderr)
        if holder:
            threading.Thread(target=holder[0].httpd.shutdown,
                             daemon=True).start()
        else:
            raise SystemExit(0)  # nothing built yet — nothing to drain

    signal.signal(signal.SIGTERM, _term)


def _drain_and_close(srv) -> None:
    """close() stops the listener and joins the backend worker — every
    admitted request's future resolves before it returns. The short grace
    sleep then lets handler threads (daemonic) finish writing their
    already-resolved responses before the process exits."""
    srv.close()
    time.sleep(0.5)


def run_ssml(args) -> None:
    """--ssml: render expressive markup (breaks, prosody rate/volume,
    <phoneme ph>, <voice> speaker ids/mixes) through batched synthesis —
    see piper_tpu/core/ssml.py for the supported subset."""
    from piper_tpu_torch.core.ssml import SsmlError, parse_ssml, render_ssml
    from piper_tpu_torch.utils.wav import write_wav

    for flag, name in ((args.stream, "--stream"),
                       (args.force_durations, "--force-durations"),
                       (args.alignment, "--alignment")):
        if flag:
            raise SystemExit(f"--ssml is not combinable with {name}")
    if (args.speaker_id is not None or getattr(args, "speaker", None)
            or getattr(args, "speaker_mix", None)):
        raise SystemExit("--ssml selects speakers inside the document "
                         "(<voice name=\"2\"> or <voice name=\"0:0.6,3:0.4\">)"
                         "; drop --speaker/--speaker-id/--speaker-mix")
    if args.length_scale is not None:
        raise SystemExit("--ssml controls pace inside the document "
                         "(<prosody rate=...>); drop --length-scale")
    text = args.ssml
    if not text.lstrip().startswith("<"):
        # the help text promises file-path semantics here — a typo'd path
        # must not be read ALOUD as literal text
        if not Path(text).is_file():
            raise SystemExit(f"--ssml: no such file {text!r} (inline "
                             f"documents must start with '<')")
        text = Path(text).read_text()
    try:
        # Parse BEFORE loading the runtime: a malformed document should
        # fail in microseconds, not after the voice loads.
        doc = parse_ssml(text)
    except SsmlError as e:
        raise SystemExit(f"ssml: {e}")
    for msg in doc.ignored:
        print(f"[ssml] ignored: {msg}", file=sys.stderr)
    rt = _load_runtime(args)
    t0 = time.perf_counter()
    try:
        phonemize = None
        if any(s.kind == "text" for s in doc.segments):
            from piper_tpu_torch.phonemize import phonemizer_for

            phonemize = phonemizer_for(rt).phoneme_ids
        audio = render_ssml(
            rt, doc, phonemize,
            sentence_silence=max(args.sentence_silence, 0.0),
            noise_scale=args.noise_scale, noise_w=args.noise_w)
    except ValueError as e:  # SsmlError and runtime validation alike
        raise SystemExit(f"ssml: {e}")
    except Exception as e:
        from piper_tpu_torch.phonemize import PhonemizerError

        if isinstance(e, PhonemizerError):
            raise SystemExit(f"ssml: {e}")
        raise
    wall_ms = (time.perf_counter() - t0) * 1e3
    out = args.output or "out.wav"
    write_wav(out, audio, rt.sample_rate)
    secs = len(audio) / rt.sample_rate
    print(f"wrote {out}: {len(audio)} samples ({secs:.2f}s) in "
          f"{wall_ms:.1f} ms (RTF {secs * 1e3 / max(wall_ms, 1e-9):.1f}x, "
          f"ssml)")
    if args.play:
        _play(str(out))


def run_repl(args) -> None:
    rt = _load_runtime(args)
    voice = rt.config.espeak.voice if rt.config.espeak else "en"
    phonemizer = None
    print("piper-tpu REPL. Type text to synthesize; :q to quit.")
    n = 0
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line or line in (":q", ":quit", "exit"):
            break
        try:
            if phonemizer is None:
                from piper_tpu_torch.phonemize import ESpeakPhonemizer

                phonemizer = ESpeakPhonemizer(voice, rt.config.phoneme_id_map)
            from piper_tpu_torch.core.text import split_sentences

            sents = ([line] if getattr(args, "no_sentence_split", False)
                     else split_sentences(line) or [line])
            out = args.output or f"repl_{n:03d}.wav"
            if len(sents) > 1:
                from piper_tpu_torch.core.audio import join_with_silence

                audios = rt.synthesize_batch(
                    [phonemizer.phoneme_ids(s) for s in sents],
                    **_batch_synth_args(args, len(sents), rt))
                audio = join_with_silence(
                    audios,
                    int(round(max(args.sentence_silence, 0.0)
                              * rt.sample_rate)))
                write_wav(out, audio, rt.sample_rate)
                print(f"wrote {out} ({len(audio) / rt.sample_rate:.2f}s, "
                      f"{len(sents)} sentences, batched)")
            else:
                ids = phonemizer.phoneme_ids(line)
                audio = rt.synthesize(ids, **_synth_args(args, rt))
                write_wav(out, audio, rt.sample_rate)
                t = rt.last_run_timings
                print(f"wrote {out} ({len(audio) / rt.sample_rate:.2f}s, "
                      f"RTF {t.rtf:.1f}x)")
            n += 1
        except Exception as e:  # noqa: BLE001 — REPL keeps going
            print(f"error: {e}", file=sys.stderr)


def run_bench(args) -> None:
    """Fixed-fixture bench; JSON schema mirrors runBench (PiperCLI.swift:249-370)."""
    summary = TestSummary.load(args.bench_summary)
    rt = _resolve_runtime_for_summary(args, summary)
    tests = summary.results[: args.max_tests]

    def run_one(tv) -> float:
        t0 = time.perf_counter()
        rt.synthesize(
            tv.phoneme_ids,
            noise_scale=tv.metadata.noise_scale,
            length_scale=tv.metadata.length_scale,
            noise_w=tv.metadata.noise_w,
            speaker_id=tv.metadata.speaker_id,
        )
        return time.perf_counter() - t0

    for _ in range(args.warmup):
        for tv in tests:
            run_one(tv)
    times = []
    encode_ms, decode_ms, rtfs = [], [], []
    for _ in range(args.iters):
        for tv in tests:
            times.append(run_one(tv))
            t = rt.last_run_timings
            encode_ms.append(t.encode_ms)
            decode_ms.append(t.decode_ms)
            rtfs.append(t.rtf)

    ms = [t * 1000 for t in times]
    out = {
        "backend": "piper-tpu",
        "mode": f"torch-{rt.device.type}-runtime",
        "model_path": str(rt.model_path),
        "num_tests": len(tests),
        "warmup": args.warmup,
        "iters": args.iters,
        "num_runs": len(times),
        "ms_mean": float(np.mean(ms)),
        "ms_p50": _percentile(ms, 50),
        "ms_p95": _percentile(ms, 95),
        "ms_max": max(ms),
        "sample_rate": rt.sample_rate,
        "encode_ms_mean": float(np.mean(encode_ms)),
        "decode_ms_mean": float(np.mean(decode_ms)),
        "rtf_mean": float(np.mean(rtfs)),
        "compile_count": rt.last_run_timings.compile_count,
    }
    print(json.dumps(out, indent=2, sort_keys=True))


def run_scale_bench(args) -> None:
    """Phoneme-count scaling sweep; mirrors runScaleBench (PiperCLI.swift:381-551)."""
    summary = TestSummary.load(args.bench_summary)
    rt = _resolve_runtime_for_summary(args, summary)
    base = summary.results[0]
    factors = [int(x) for x in args.scale_factors.split(",")]

    results = []
    for f in factors:
        ids: List[int] = []
        target = min(args.max_phonemes, len(base.phoneme_ids) * max(1, f))
        while len(ids) < target:
            ids.extend(base.phoneme_ids)
        ids = ids[: args.max_phonemes]

        def run_one() -> float:
            t0 = time.perf_counter()
            rt.synthesize(
                ids,
                noise_scale=base.metadata.noise_scale,
                length_scale=base.metadata.length_scale,
                noise_w=base.metadata.noise_w,
            )
            return time.perf_counter() - t0

        for _ in range(args.warmup):
            run_one()
        wall, rtfs, enc, dec = [], [], [], []
        cpu_user, cpu_sys, max_rss = [], [], []
        import resource

        for _ in range(args.iters):
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            wall.append(run_one() * 1000)
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu_user.append((ru1.ru_utime - ru0.ru_utime) * 1000)
            cpu_sys.append((ru1.ru_stime - ru0.ru_stime) * 1000)
            max_rss.append(float(ru1.ru_maxrss))
            t = rt.last_run_timings
            rtfs.append(t.rtf)
            enc.append(t.encode_ms)
            dec.append(t.decode_ms)
        results.append(
            {
                "factor": f,
                "phoneme_count": len(ids),
                "ms_mean": float(np.mean(wall)),
                "ms_p50": _percentile(wall, 50),
                "ms_p95": _percentile(wall, 95),
                "ms_max": max(wall),
                "rtf_mean": float(np.mean(rtfs)),
                "encode_ms_mean": float(np.mean(enc)),
                "decode_ms_mean": float(np.mean(dec)),
                "phoneme_bucket": rt.last_run_timings.phoneme_bucket,
                "frame_bucket": rt.last_run_timings.frame_bucket,
                # resource columns matching the reference's scale-bench rows
                # (PiperCLI.swift:512-534)
                "cpu_user_ms_mean": float(np.mean(cpu_user)),
                "cpu_sys_ms_mean": float(np.mean(cpu_sys)),
                "max_rss_max": max(max_rss),
            }
        )

    out = {
        "backend": "piper-tpu",
        "mode": "scale-bench",
        "model_path": str(rt.model_path),
        "sample_rate": rt.sample_rate,
        "warmup": args.warmup,
        "iters": args.iters,
        "max_phonemes": args.max_phonemes,
        "scale_factors": factors,
        "base_test_phonemes": len(base.phoneme_ids),
        "compile_count": rt.last_run_timings.compile_count,
        "results": results,
    }
    print(json.dumps(out, indent=2, sort_keys=True))


def run_microbench(args) -> None:
    """Dispatch-overhead microbench (reference: PiperMetalMicrobench.swift:19-77).

    On the card the analog of per-op dispatch vs batched command buffers is
    16 adds launched one by one vs the same 16 replayed from one CUDA graph
    (the counterpart of one jit program). The CPU has no graph:
    jit_chain_ms is null there and `jit_chain_note` says why."""
    import torch

    n, iters = 4096, 200
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--microbench: no CUDA device (pass --device cpu for the CPU)")
    x = torch.zeros((n,), dtype=torch.float32, device=dev)

    def add_chain(x):
        for _ in range(16):
            x = x + 1.0
        return x

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Eager per-op dispatch
    add_chain(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        x1 = add_chain(x)
    sync()
    eager_ms = (time.perf_counter() - t0) / iters * 1000
    assert float(x1[0]) == 16.0

    # One captured program, replayed
    fused_ms, note = None, None
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            add_chain(x)  # warm up on a side stream, as capture requires
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x2 = add_chain(x)
        graph.replay()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            graph.replay()
        sync()
        fused_ms = (time.perf_counter() - t0) / iters * 1000
        assert float(x2[0]) == 16.0
    else:
        note = "the CPU has no CUDA graph to replay; run on the card (--device cuda)"

    out = {
        "mode": "microbench",
        "elements": n,
        "iters": iters,
        "ops_per_chain": 16,
        "eager_chain_ms": eager_ms,
        "jit_chain_ms": fused_ms,
        "dispatch_overhead_ratio": (eager_ms / fused_ms if fused_ms else None),
        "device": args.device,
    }
    if note:
        out["jit_chain_note"] = note
    print(json.dumps(out, indent=2, sort_keys=True))


def run_list_voices(args) -> None:
    from piper_tpu_torch.core.voices import VoiceIndex, VoiceManager

    idx = VoiceIndex.load_bundled()
    vm = VoiceManager()
    for e in idx.entries:
        model, _ = vm.cached_paths(e.id)
        mark = "*" if model.exists() else " "
        print(f"{mark} {e.id:<42} {e.language:<7} {e.quality}")
    print(f"\n{len(idx.entries)} voices (* = cached locally)")


def run_record_vectors(args) -> None:
    """Record test vectors with injected-RNG artifacts (--record-vectors DIR)."""
    from piper_tpu_torch.testing import record_test_vector, write_test_summary

    if getattr(args, "speaker_mix", None):
        raise SystemExit("--record-vectors does not support --speaker-mix "
                         "(test vectors pin integer speaker ids; record "
                         "each endpoint speaker instead)")
    rt = _load_runtime(args)
    ids = _phoneme_ids_for(args, rt)
    out_dir = Path(args.record_vectors)
    vec = record_test_vector(
        rt, ids, out_dir, args.test_id,
        seed=args.seed, description="recorded by piper-tpu CLI",
        **_synth_args(args, rt),
    )
    path = write_test_summary(rt, [vec], out_dir / "test_summary.json")
    print(f"recorded {vec['test_id']}: {vec['metadata']['num_samples']} samples -> {path}")


def run_verify_summary(args) -> None:
    """Replay recorded vectors with injected RNG and report max-abs error."""
    from piper_tpu_torch.core.test_vector import TestSummary
    from piper_tpu_torch.testing import replay_test_vector

    summary = TestSummary.load(args.verify_summary)
    rt = _resolve_runtime_for_summary(args, summary)
    results = []
    worst = 0.0
    for i, tv in enumerate(summary.results[: args.max_tests or len(summary.results)]):
        if tv.random_files is None or not tv.random_files.dp_randomnormalike:
            results.append({"test_id": tv.test_id, "skipped": "no recorded RNG"})
            continue
        r = replay_test_vector(rt, args.verify_summary, i)
        worst = max(worst, r["max_abs_err"])
        results.append(r)
    out = {
        "mode": "verify-summary",
        "tolerance": args.tolerance,
        "max_abs_err_worst": worst,
        "passed": worst <= args.tolerance,
        "results": results,
    }
    print(json.dumps(out, indent=2, sort_keys=True))
    if not out["passed"]:
        raise SystemExit(1)


def _play(path: str) -> None:
    import shutil
    import subprocess

    player = shutil.which("aplay") or shutil.which("paplay") or shutil.which("afplay")
    if player is None:
        print("no audio player found (aplay/paplay/afplay); skipping playback",
              file=sys.stderr)
        return
    subprocess.run([player, path], check=False)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="piper-tpu", description=__doc__.split("\n\n")[0])
    p.add_argument("--voice", help="voice id to download/load (e.g. en_GB-northern_english_male-medium)")
    p.add_argument("--model", help="path to a .onnx checkpoint")
    p.add_argument("--config", help="path to the .onnx.json config (default: <model>.json)")
    p.add_argument("--text", help="text to synthesize (requires espeak-ng)")
    p.add_argument("--ipa", help="IPA string to synthesize")
    p.add_argument("--ssml", metavar="SSML_OR_FILE",
                   help="SSML(-lite) document to render: breaks, prosody "
                        "rate/volume, <phoneme ph>, <voice> speaker "
                        "ids/mixes, <p>/<s>, <sub> (see core/ssml.py); an "
                        "argument not starting with '<' is read as a file "
                        "path; plain text inside needs espeak-ng")
    p.add_argument("--phoneme-ids", help="comma/space-separated phoneme ids")
    p.add_argument("--output", "-o", help="output WAV path")
    p.add_argument("--noise-scale", type=float, default=None)
    p.add_argument("--length-scale", type=float, default=None)
    p.add_argument("--noise-w", type=float, default=None)
    p.add_argument("--speaker-id", type=int, default=None)
    p.add_argument("--speaker", metavar="NAME_OR_ID",
                   help="speaker by NAME (via the voice config's "
                        "speaker_id_map) or integer id; mutually exclusive "
                        "with --speaker-id/--speaker-mix")
    p.add_argument("--speaker-mix", metavar="ID:W,ID:W",
                   help="blend speaker embeddings by weight (multi-speaker "
                        "voices): e.g. '0:0.6,3:0.4'; weights needn't sum "
                        "to 1 (extrapolation is allowed); mutually "
                        "exclusive with --speaker-id")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--precision", default=None,
                   choices=["highest", "high", "default", "bfloat16"],
                   help="matmul precision tier (default: PIPER_TPU_PRECISION or 'highest')")
    p.add_argument("--output-dtype", default=None, choices=["float32", "int16"],
                   help="PCM format the runtime emits (int16 = WAV wire "
                        "format, converted on device; halves the host copy)")
    p.add_argument("--vocoder-precision", default=None,
                   help="vocoder-only tier ('high' is the bench's mixed "
                        "configuration; tools/calibrate_precision.py), "
                        "'none', or comma-separated per-upsample-level tiers")
    p.add_argument("--flow-precision", default=None,
                   help="decode-flow-only matmul tier ('none' = inherit "
                        "--precision); the encoder/duration path always "
                        "stays at --precision")
    p.add_argument("--bench-summary", "--summary", dest="bench_summary",
                   help="path to test_summary.json (enables bench mode)")
    p.add_argument("--scale-bench", action="store_true")
    p.add_argument("--microbench", action="store_true")
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--max-tests", type=int, default=None)
    p.add_argument("--scale-factors", default="1,2,4,8,16")
    p.add_argument("--max-phonemes", type=int, default=4096)
    p.add_argument("--list-voices", action="store_true",
                   help="print the bundled voice index (* = cached)")
    p.add_argument("--record-vectors", metavar="DIR",
                   help="record a test vector (audio + RNG tensors) to DIR")
    p.add_argument("--test-id", default="vector_0")
    p.add_argument("--verify-summary", metavar="PATH",
                   help="replay recorded vectors with injected RNG; exit 1 over tolerance")
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--alignment", metavar="PATH",
                   help="also write phoneme-level timing JSON (per-phoneme "
                        "sample/second spans of the synthesized audio; "
                        "not supported with --stream)")
    p.add_argument("--force-durations", metavar="FRAMES",
                   help="comma-separated per-phoneme frame counts: skip the "
                        "duration predictor and force this timing plan "
                        "(pairs with --alignment's frames; single utterance "
                        "only; length/noise_w scales do not apply)")
    p.add_argument("--play", action="store_true", help="play the output WAV")
    p.add_argument("--stream", action="store_true",
                   help="incremental windowed decode (first audio before completion)")
    p.add_argument("--sentence-silence", type=float, default=0.2,
                   metavar="SEC",
                   help="seconds of silence between sentences when --text "
                        "splits into several (default 0.2, like upstream "
                        "piper)")
    p.add_argument("--no-sentence-split", action="store_true",
                   help="synthesize --text as one utterance instead of "
                        "splitting sentences into a batched decode")
    p.add_argument("--profile-trace", metavar="DIR",
                   help="capture a torch.profiler trace of the run into DIR "
                        "(trace.json; open in Perfetto or chrome://tracing)")
    p.add_argument("--prewarm", action="store_true",
                   help="run the standard phoneme-bucket ladder (with "
                        "--serve: the serving shape grid) before serving; "
                        "each shape's first run pays the card's per-shape "
                        "costs")
    p.add_argument("--prewarm-speaker-mix", action="store_true",
                   help="with --prewarm on a multi-speaker voice, also "
                        "warm the speaker-BLENDING variants (requests "
                        "carrying speaker_mix run distinct shapes)")
    p.add_argument("--serve", action="store_true",
                   help="serve the loaded voice(s) over HTTP "
                        "(POST /v1/synthesize; see engine/http_server.py)")
    p.add_argument("--cache-mb", type=float, default=0.0,
                   help="with --serve: response cache budget in MB "
                        "(synthesis is deterministic, so identical "
                        "requests — canned phrases — serve from memory; "
                        "0 disables)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the runtimes run (default: the card; raises "
                        "without one)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.profile_trace:
        import contextlib

        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if args.device == "cuda" and torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with contextlib.suppress(SystemExit):
                _dispatch(args)
        Path(args.profile_trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.profile_trace) / "trace.json"))
        print(f"trace written to {args.profile_trace}", file=sys.stderr)
        return
    _dispatch(args)


def run_serve(args) -> None:
    """HTTP serving front-end: one or more voices behind the multi-voice
    continuous batcher (engine/http_server.py). `--model` takes a comma
    list in serve mode (each .onnx pairs with its sibling .onnx.json), so
    one process serves several voices. With --stream, the SAME process
    additionally serves chunked low-latency `POST /v1/stream` for every
    voice — the backend unifies the batcher and the streaming scheduler on
    one device worker (engine/unified.py)."""
    stop_holder: list = []
    _install_sigterm_drain(stop_holder)
    from piper_tpu_torch.engine.http_server import PiperHTTPServer

    if args.model and "," in str(args.model) and args.config:
        raise SystemExit("--config is ambiguous with several --model paths; "
                         "place each voice's config as <model>.onnx.json "
                         "next to its checkpoint")
    runtimes = {}
    if args.model and "," in str(args.model):
        for path in str(args.model).split(","):
            path = path.strip()
            key = Path(path).stem
            if key in runtimes:
                raise SystemExit(
                    f"two --model paths share the voice key {key!r} (the "
                    "file stem); rename one so requests route unambiguously")
            runtimes[key] = PiperRuntime(path, None, _options_or_exit(args),
                                         device=args.device)
    else:
        rt = _load_runtime(args)
        key = (Path(args.model).stem if args.model
               else (args.voice or "default"))
        runtimes[key] = rt
    srv = PiperHTTPServer(runtimes, host=args.host, port=args.port,
                          stream=args.stream,
                          cache_mb=max(0.0, args.cache_mb))
    stop_holder.append(srv)
    if args.prewarm:
        if args.stream:
            stats = srv.prewarm(
                speaker_mix_programs=args.prewarm_speaker_mix,
                stream_kwargs={"speaker_mix": args.prewarm_speaker_mix})
            n = (sum(v["programs"] for v in stats["batch"].values())
                 + sum(v["programs"] for v in stats["stream"].values()))
        else:
            per_voice = srv.prewarm(
                speaker_mix_programs=args.prewarm_speaker_mix)
            n = sum(v["programs"] for v in per_voice.values())
        print(f"prewarmed {n} serving programs", file=sys.stderr)
    surfaces = "POST /v1/synthesize, /v1/durations" + (
        ", /v1/stream (chunked)" if args.stream else "")
    print(f"serving voice(s) {sorted(runtimes)} on "
          f"http://{srv.host}:{srv.port} ({surfaces})",
          file=sys.stderr, flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _drain_and_close(srv)


def _dispatch(args) -> None:
    if args.list_voices:
        run_list_voices(args)
    elif args.record_vectors:
        run_record_vectors(args)
    elif args.verify_summary:
        run_verify_summary(args)
    elif args.microbench:
        args.warmup = args.warmup if args.warmup is not None else 1
        args.iters = args.iters if args.iters is not None else 3
        run_microbench(args)
    elif args.scale_bench:
        args.warmup = args.warmup if args.warmup is not None else 1
        args.iters = args.iters if args.iters is not None else 3
        args.max_tests = args.max_tests if args.max_tests is not None else 1
        if not args.bench_summary:
            raise SystemExit("--scale-bench requires --bench-summary/--summary")
        run_scale_bench(args)
    elif args.bench_summary:
        args.warmup = args.warmup if args.warmup is not None else 2
        args.iters = args.iters if args.iters is not None else 10
        args.max_tests = args.max_tests if args.max_tests is not None else 8
        run_bench(args)
    elif args.serve:
        run_serve(args)
    elif args.ssml:
        if args.text or args.ipa or args.phoneme_ids:
            raise SystemExit("pass --ssml OR --text/--ipa/--phoneme-ids, "
                             "not both")
        run_ssml(args)
    elif args.text or args.ipa or args.phoneme_ids:
        run_oneshot(args)
    elif args.prewarm:
        # Standalone prewarm: run the bucket ladder once (each shape's first
        # run pays the card's per-shape costs; nothing persists past the
        # process).
        rt = _load_runtime(args)
        stats = rt.prewarm()
        print(f"prewarmed {stats['programs']} programs in {stats['seconds']:.1f}s")
    else:
        run_repl(args)


if __name__ == "__main__":
    main()
