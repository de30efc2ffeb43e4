"""HTTP serving API over the multi-voice continuous batcher (stdlib only):
the port's copy of piper_tpu.engine.http_server, with the same routes,
bodies, status codes and headers, over the port's servers.

The reference is a CLI/library; a production TTS deployment needs a network
surface. This module exposes the batched serving stack over plain HTTP with
no third-party dependencies (http.server), keeping the device discipline
intact: handler threads only enqueue requests and block on futures — ALL
device work (every PiperRuntime._device_work block) stays on the backend's
single worker thread. Handler threads parse JSON and encode WAV/PCM under
the same interpreter lock as that worker.

Endpoints (JSON in, WAV or JSON out):

  POST /v1/synthesize   {"voice": "...", "phoneme_ids": [...]} or
                        {"ipa": "..."} or {"text": "..."} (text needs
                        espeak-ng; sentences batch with "sentence_silence"
                        seconds of gap, default 0.2) or {"ssml": "..."}
                        (expressive markup — breaks, prosody rate/volume,
                        <phoneme ph>, <voice> ids/mixes; same-prosody
                        spans batch through the scheduler). Optional
                        noise_scale / length_scale / noise_w / speaker_id,
                        or "speaker_mix": {"0": 0.6, "3": 0.4} to blend
                        speaker embeddings (multi-speaker voices; mutually
                        exclusive with speaker_id).
                        Optional "durations": per-phoneme frame counts
                        (duration forcing — replaces the predictor; single
                        utterance only; e.g. an edited /v1/durations plan).
                        Returns audio/wav (or audio/x-raw-int16 with
                        "format": "pcm").
  GET  /v1/voices       voice keys + sample rate / speaker count.
  GET  /v1/metrics      per-voice serving metrics snapshot (JSON).
  GET  /metrics         the same counters in Prometheus exposition format.
  GET  /healthz         liveness.
  POST /v1/audio/speech OpenAI-compatible alias: {"input": text,
                        "voice": key} -> audio/wav (speed maps to
                        1/length_scale; model/response_format ignored
                        except response_format "pcm").

Errors: 400 malformed request, 404 unknown voice/route, 429 admission
shed (ServerOverloaded / DeadlineExceeded), 500 synthesis failure.

Streaming: construct PiperHTTPServer with `stream=True` (CLI `--serve
--stream`) and the SAME process additionally serves chunked
`POST /v1/stream` for every voice — the backend swaps to UnifiedServer
(engine/unified.py), which runs the batcher and the streaming scheduler
on ONE device worker thread (one thread orders every launch and host copy
of the card's work — the constraint is on threads, not on surfaces).
PiperStreamingHTTPServer (below) remains as the minimal single-voice
streaming-only deployment.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from piper_tpu_torch.engine.batcher import (DeadlineExceeded,
                                      MultiVoiceBatchingServer,
                                      ServerOverloaded)
from piper_tpu_torch.engine.runtime import PiperRuntime


def _error_status(e: Exception) -> int:
    """5xx classification for handler catch-alls: a missing phonemizer is
    a deployment capability gap (501 — the voice serves phoneme_ids/ipa,
    text needs espeak-ng installed), not an internal failure."""
    from piper_tpu_torch.phonemize import PhonemizerError

    return 501 if isinstance(e, PhonemizerError) else 500


def _ids_for_request(req: dict, rt: PiperRuntime, phonemizers: dict):
    """One id-list (single utterance) or a list of them (sentences)."""
    if "phoneme_ids" in req:
        ids = req["phoneme_ids"]
        if (not isinstance(ids, list) or not ids
                or not all(isinstance(i, int) for i in ids)):
            raise ValueError("phoneme_ids must be a non-empty int list")
        return [ids]
    if "ipa" in req:
        from piper_tpu_torch.core.phonemes import ipa_to_ids

        return [ipa_to_ids(str(req["ipa"]), rt.config.phoneme_id_map)]
    if "text" in req:
        from piper_tpu_torch.core.text import split_sentences
        from piper_tpu_torch.phonemize import phonemizer_for

        # Validate the text BEFORE consulting the phonemizer: empty text
        # is the client's error (400) even on a box without espeak-ng.
        sents = split_sentences(str(req["text"]))
        if not sents:
            raise ValueError("empty text")
        ph = phonemizer_for(rt, phonemizers)
        return [ph.phoneme_ids(s) for s in sents]
    raise ValueError("pass phoneme_ids, ipa, or text")


def _speaker_mix_from(req: dict, rt: PiperRuntime) -> Optional[dict]:
    """Parse an optional "speaker_mix" body field: a JSON object mapping
    speaker id OR NAME (via the voice's speaker_id_map) -> blend weight.
    Range/finiteness checks live in BatchingServer._validate_request; here
    we coerce/resolve keys so a malformed body is a 400, not a 500."""
    mix = req.get("speaker_mix")
    if mix is None:
        return None
    if not isinstance(mix, dict) or not mix:
        raise ValueError(
            'speaker_mix must be a non-empty object of {"id_or_name": '
            'weight}, e.g. {"0": 0.6, "3": 0.4}')
    for k, v in mix.items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"speaker_mix weight for {k!r} must be a number")
    # Key resolution/validation (names, digit strings, "0"/"00" collisions)
    # is the runtime's ONE resolver — unknown names/bad keys -> ValueError
    # -> 400.
    return rt.resolve_speaker_mix({k: float(v) for k, v in mix.items()})


def _speaker_kwargs(req: dict, rt: PiperRuntime, kwargs: dict) -> None:
    """Apply the optional "speaker" (name or id) and "speaker_mix" body
    fields onto submit kwargs — shared by the synthesize/durations/stream
    handlers so name resolution cannot drift."""
    if req.get("speaker") is not None:
        if (req.get("speaker_id") is not None
                or req.get("speaker_mix") is not None):
            raise ValueError(
                "pass ONE of speaker / speaker_id / speaker_mix")
        kwargs["speaker_id"] = rt.speaker_index(req["speaker"])
    mix = _speaker_mix_from(req, rt)
    if mix is not None:
        kwargs["speaker_mix"] = mix


def _ssml_plan_for(req: dict, rt: PiperRuntime, phonemizers: dict):
    """Shared "ssml" request preamble for the synthesize/durations/stream
    handlers (one copy, so forbidden-key lists and resolver wiring cannot
    drift): conflicting per-request knobs rejected, gap parsed, document
    parsed + planned with the voice's phonemizer and speaker resolver.
    Returns (plan, gap_s); plan.ignored carries unsupported-feature
    reports the handler must surface."""
    from piper_tpu_torch.core.ssml import parse_ssml, plan_ssml

    for k in ("text", "ipa", "phoneme_ids", "durations", "length_scale",
              "speaker", "speaker_id", "speaker_mix"):
        if req.get(k) is not None:
            raise ValueError(
                f"{k} cannot be combined with ssml — prosody and speaker "
                f"selection live in the document (<prosody>, <voice>)")
    gap_s = float(req.get("sentence_silence", 0.2))
    if gap_s < 0:
        raise ValueError("sentence_silence must be >= 0")
    doc = parse_ssml(str(req["ssml"]))
    phonemize = None
    if any(s.kind == "text" for s in doc.segments):
        from piper_tpu_torch.phonemize import phonemizer_for

        phonemize = phonemizer_for(rt, phonemizers).phoneme_ids
    return plan_ssml(doc, rt.config.phoneme_id_map, phonemize,
                     sentence_silence=gap_s,
                     speaker_resolver=rt.speaker_index), gap_s


def _prometheus_metrics(per_voice: Dict[str, dict]) -> str:
    """Serving counters in Prometheus exposition format (one gauge/counter
    per metric, labelled by voice)."""
    lines = []
    keys = sorted({k for m in per_voice.values() for k in m
                   if isinstance(m[k], (int, float))})
    for key in keys:
        name = f"piper_tpu_{key}"
        lines.append(f"# TYPE {name} gauge")
        for voice, m in sorted(per_voice.items()):
            if key in m:
                lines.append(f'{name}{{voice="{voice}"}} {m[key]}')
    return "\n".join(lines) + "\n"


def _stream_items(req: dict, rt: PiperRuntime, phonemizers: dict):
    """The stream program for one request: (items, ignored) where items
    are ordered ("gap", pcm_bytes) and ("utt", ids, submit_kwargs,
    volume) entries — plain requests interleave sentences with one gap,
    SSML requests walk the document's assembly script. Raises ValueError
    (-> 400) on malformed input. Shared by the unified and the dedicated
    streaming servers so request semantics cannot drift."""
    from piper_tpu_torch.core.audio import float_to_int16

    sr = rt.sample_rate

    def gap_bytes(seconds: float) -> bytes:
        return float_to_int16(
            np.zeros(int(round(seconds * sr)), np.float32)).tobytes()

    if req.get("ssml") is not None:
        from piper_tpu_torch.core.ssml import submit_kwargs

        plan, _ = _ssml_plan_for(req, rt, phonemizers)
        common = {k: req[k] for k in ("seed", "noise_scale", "noise_w")
                  if req.get(k) is not None}
        items = []
        for item in plan.assembly:
            if item[0] == "gap":
                items.append(("gap", gap_bytes(item[1])))
                continue
            u = plan.utterances[item[1]]
            items.append(("utt", u.ids, submit_kwargs(u.ctx, common),
                          u.ctx.volume))
        return items, plan.ignored
    gap_s = float(req.get("sentence_silence", 0.2))
    if gap_s < 0:
        raise ValueError("sentence_silence must be >= 0")
    ids_list = _ids_for_request(req, rt, phonemizers)
    kwargs = {k: req[k] for k in
              ("seed", "noise_scale", "length_scale",
               "noise_w", "speaker_id")
              if req.get(k) is not None}
    _speaker_kwargs(req, rt, kwargs)
    gp = gap_bytes(gap_s)
    items = []
    for i, ids in enumerate(ids_list):
        if i:
            items.append(("gap", gp))
        items.append(("utt", ids, kwargs, 1.0))
    return items, []


def _handle_stream_post(handler: "_JsonHandler", req: dict,
                        rt: PiperRuntime, submit, phonemizers: dict) -> None:
    """POST /v1/stream body for ONE resolved voice: plan the stream
    program, admit the first utterance synchronously (errors before
    headers are real status codes), then write one HTTP chunk per decoded
    window. `submit` is a callable(ids, **kwargs) -> stream handle.
    Requires the handler's protocol_version to be HTTP/1.1 (chunked)."""
    from piper_tpu_torch.core.audio import float_to_int16
    from piper_tpu_torch.engine.batcher import ServerOverloaded as _Overloaded

    try:
        items, ignored = _stream_items(req, rt, phonemizers)
    except ValueError as e:
        handler._send_json(400, {"error": str(e)})
        return
    except Exception as e:  # noqa: BLE001
        handler._send_json(_error_status(e), {"error": f"{type(e).__name__}: {e}"})
        return
    # Admit the FIRST utterance's stream before sending headers:
    # synchronous admission errors (max_sessions) come back as
    # a real 429, not a truncated 200. Later utterances can
    # still shed mid-stream, which truncates — unavoidable
    # once bytes are on the wire.
    first = next((i for i in items if i[0] == "utt"), None)
    handle = None
    if first is not None:
        try:
            handle = submit(first[1], **first[2])
        except _Overloaded as e:
            handler._send_json(429, {"error": str(e)})
            return
        except (ValueError, KeyError) as e:  # door-step validation (e.g. mix)
            handler._send_json(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001
            handler._send_json(_error_status(e), {"error": f"{type(e).__name__}: {e}"})
            return
    handler.send_response(200)
    handler.send_header("Content-Type", "audio/x-raw-int16")
    handler.send_header("Transfer-Encoding", "chunked")
    handler.send_header("X-Sample-Rate", str(rt.sample_rate))
    if ignored:  # SSML features the subset cannot realize
        handler.send_header("X-Piper-Ignored", "; ".join(ignored))
    handler.end_headers()

    def wchunk(b: bytes) -> None:
        if b:
            handler.wfile.write(f"{len(b):X}\r\n".encode())
            handler.wfile.write(b)
            handler.wfile.write(b"\r\n")

    if handle is None:
        # No utterances at all (SSML of only <break/>s, or empty text):
        # nothing to admit — stream the silence and finish. A bare
        # next() here used to raise StopIteration out of the handler,
        # dropping the connection with no response.
        for item in items:
            wchunk(item[1])
        handler.wfile.write(b"0\r\n\r\n")
        return

    try:
        for item in items:
            if item[0] == "gap":
                wchunk(item[1])
                continue
            if item is not first:
                handle = submit(item[1], **item[2])
            vol = item[3]
            for chunk in handle:
                samples = chunk.samples
                if vol != 1.0:
                    from piper_tpu_torch.core.audio import pcm_to_float32

                    samples = np.clip(
                        pcm_to_float32(samples) * vol, -1.0, 1.0)
                wchunk(float_to_int16(samples).tobytes())
        handler.wfile.write(b"0\r\n\r\n")
    finally:
        # Client gone mid-stream (BrokenPipe/timeout): release
        # the session slot instead of leaking it — the server
        # would otherwise hit max_sessions permanently.
        handle.cancel()


def _wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """Mono 16-bit PCM WAV in memory (the one WavWriter serializer, over a
    BytesIO, so the on-disk and over-the-wire formats cannot drift)."""
    from piper_tpu_torch.utils.wav import WavWriter

    buf = io.BytesIO()
    with WavWriter(buf, sample_rate) as w:
        w.append_float32(np.asarray(audio, np.float32))
    return buf.getvalue()


class _JsonHandler(BaseHTTPRequestHandler):
    """Shared handler plumbing for both server classes: quiet logging, a
    socket timeout so stalled clients can't pin a thread, bounded JSON body
    parsing, and connection-drop on error responses (an error sent before
    the body was read would otherwise desync a keep-alive connection)."""

    timeout = 60

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json",
              headers: "dict | None" = None) -> None:
        if code >= 400:
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode())

    def _read_json_body(self) -> Optional[dict]:
        """Parse a bounded JSON object body; sends the error response and
        returns None on failure (the Content-Length is never trusted:
        negative reads to EOF, oversized blocks until timeout)."""
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n < 0:
                raise ValueError("negative Content-Length")
            if n > 16 << 20:
                self._send_json(413, {"error": "body too large"})
                return None
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            return req
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
            return None


class _HttpLifecycle:
    """start/serve_forever/close over a ThreadingHTTPServer + a backend
    with its own worker. Subclasses set self.httpd and implement
    _close_backend()."""

    def _init_http(self, host: str, port: int, handler_cls) -> None:
        self.httpd = ThreadingHTTPServer((host, port), handler_cls)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    def start(self) -> None:
        """Serve in a background thread (handlers never touch the device)."""
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="piper-http", daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._serving = True
        self.httpd.serve_forever()

    def close(self) -> None:
        # shutdown() waits on an event only serve_forever() sets — calling
        # it when serve_forever never ran deadlocks forever (e.g. `with`
        # body raising before start()), so only signal a running loop.
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        leaked = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            leaked = self._thread.is_alive()
        # Close the backend even when the accept thread leaked — raising
        # first would leak the device worker too.
        self._close_backend()
        if leaked:
            raise RuntimeError(
                "HTTP accept thread did not exit within 30s; thread leaked")

    def _close_backend(self) -> None:  # pragma: no cover — overridden
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PiperHTTPServer(_HttpLifecycle):
    """Serve one or more loaded voices over HTTP.

    `runtimes` maps voice key -> PiperRuntime; the first key is the default
    voice. Batcher kwargs (max_batch, max_pending, deadline_ms, ...) pass
    through to MultiVoiceBatchingServer.

    `stream=True` swaps the backend to UnifiedServer: the same process —
    still ONE device worker thread — additionally serves chunked
    `POST /v1/stream` for every voice (body: same fields as /v1/synthesize
    plus optional "seed"; response: chunked audio/x-raw-int16, one HTTP
    chunk per decoded window). `stream_kwargs` pass to each voice's
    StreamingServer (emit_frames, max_sessions, ...)."""

    def __init__(self, runtimes: Dict[str, PiperRuntime], *,
                 host: str = "127.0.0.1", port: int = 0,
                 stream: bool = False,
                 stream_kwargs: Optional[dict] = None,
                 **batcher_kwargs):
        if not runtimes:
            raise ValueError("at least one voice required")
        self.runtimes = dict(runtimes)
        self.default_voice = next(iter(self.runtimes))
        self.stream = bool(stream)
        if self.stream:
            from piper_tpu_torch.engine.unified import UnifiedServer

            self.server = UnifiedServer(self.runtimes,
                                        stream_kwargs=stream_kwargs,
                                        **batcher_kwargs)
        else:
            self.server = MultiVoiceBatchingServer(self.runtimes,
                                                   **batcher_kwargs)
        self._phonemizers: Dict[int, object] = {}
        outer = self

        class Handler(_JsonHandler):
            if self.stream:
                protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

            def do_GET(self):
                if self.path == "/healthz":
                    # Liveness is the 200 itself; `ready` distinguishes
                    # "serving but still warming its shapes" (a voice
                    # added on a live server mid-prewarm) from fully warm
                    # — orchestrator readiness probes should gate on it.
                    self._send_json(200, {
                        "ok": True,
                        "ready": outer.server.ready(),
                        "warming": outer.server.warming()})
                elif self.path == "/v1/voices":
                    # speakers: name -> id when the config has a map (lets
                    # clients discover what "speaker"/"speaker_mix" accept)
                    self._send_json(200, {
                        k: {"sample_rate": rt.sample_rate,
                            "num_speakers": rt.hparams.n_speakers,
                            "phonemes": rt.hparams.n_vocab,
                            **({"speakers": rt.config.speaker_id_map}
                               if rt.config and rt.config.speaker_id_map
                               else {})}
                        for k, rt in outer.runtimes.items()})
                elif self.path == "/v1/metrics":
                    self._send_json(200, outer.server.metrics())
                elif self.path == "/metrics":
                    self._send(200, _prometheus_metrics(
                        outer._flat_metrics()).encode(),
                        "text/plain; version=0.0.4")
                else:
                    self._send_json(404, {"error": "unknown route"})

            def do_POST(self):
                if self.path == "/v1/stream":
                    if not outer.stream:
                        self._send_json(404, {
                            "error": "streaming is not enabled on this "
                                     "server (start with stream=True / "
                                     "--serve --stream)"})
                        return
                    req = self._read_json_body()
                    if req is None:
                        return
                    voice = req.get("voice", outer.default_voice)
                    rt = outer.runtimes.get(voice)
                    if rt is None:
                        self._send_json(404,
                                        {"error": f"unknown voice {voice!r}"})
                        return
                    _handle_stream_post(
                        self, req, rt,
                        lambda ids, **kw: outer.server.submit_stream(
                            voice, ids, **kw),
                        outer._phonemizers)
                    return
                if self.path not in ("/v1/synthesize", "/v1/audio/speech",
                                     "/v1/durations"):
                    self._send_json(404, {"error": "unknown route"})
                    return
                req = self._read_json_body()
                if req is None:
                    return
                if self.path == "/v1/durations":
                    try:
                        doc = outer._durations(req)
                    except KeyError as e:
                        self._send_json(404, {"error": str(e.args[0])})
                    except (ServerOverloaded, DeadlineExceeded) as e:
                        self._send_json(429, {"error": str(e)})
                    except ValueError as e:
                        self._send_json(400, {"error": str(e)})
                    except Exception as e:  # noqa: BLE001 — surface as 5xx
                        self._send_json(_error_status(e),
                                        {"error": f"{type(e).__name__}: {e}"})
                    else:
                        self._send_json(200, doc)
                    return
                if self.path == "/v1/audio/speech":
                    # OpenAI-compatible alias: input -> text, speed ->
                    # 1/length_scale; unknown fields ignored.
                    alias = {"text": req.get("input", "")}
                    if "voice" in req:
                        alias["voice"] = req["voice"]
                    if req.get("speed") is not None:
                        try:
                            speed = float(req["speed"])
                        except (TypeError, ValueError):
                            speed = -1.0
                        if speed <= 0:
                            self._send_json(400, {
                                "error": "speed must be a number > 0"})
                            return
                        alias["length_scale"] = 1.0 / speed
                    if req.get("response_format") == "pcm":
                        alias["format"] = "pcm"
                    req = alias
                try:
                    audio, rt, ignored = outer._synthesize(req)
                except KeyError as e:
                    self._send_json(404, {"error": str(e.args[0])})
                    return
                except (ServerOverloaded, DeadlineExceeded) as e:
                    self._send_json(429, {"error": str(e)})
                    return
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — surface as 500
                    self._send_json(_error_status(e), {"error": f"{type(e).__name__}: {e}"})
                    return
                # unsupported-SSML-feature reports ride a header (the
                # body is audio); the ssml module's contract is "reported,
                # never silently dropped" and that must hold over HTTP
                hdrs = ({"X-Piper-Ignored": "; ".join(ignored)}
                        if ignored else None)
                if req.get("format") == "pcm":
                    from piper_tpu_torch.core.audio import float_to_int16

                    self._send(200, float_to_int16(audio).astype("<i2")
                               .tobytes(), "audio/x-raw-int16",
                               headers=hdrs)
                else:
                    self._send(200, _wav_bytes(audio, rt.sample_rate),
                               "audio/wav", headers=hdrs)

        self._init_http(host, port, Handler)

    # -- request handling ------------------------------------------------

    def _ids_for(self, req: dict, rt: PiperRuntime):
        return _ids_for_request(req, rt, self._phonemizers)

    def _synthesize(self, req: dict):
        voice = req.get("voice", self.default_voice)
        if voice not in self.runtimes:
            raise KeyError(f"unknown voice {voice!r}")
        rt = self.runtimes[voice]
        if req.get("ssml") is not None:
            return self._synthesize_ssml(req, voice, rt)
        kwargs = {k: req[k] for k in
                  ("noise_scale", "length_scale", "noise_w", "speaker_id")
                  if req.get(k) is not None}
        _speaker_kwargs(req, rt, kwargs)
        ids_list = self._ids_for(req, rt)
        if req.get("durations") is not None:
            # Duration forcing: one frame count per phoneme replaces the
            # duration predictor (see PiperRuntime.synthesize_forced) —
            # e.g. replaying an edited /v1/durations plan.
            durs = req["durations"]
            # Type-check here so a malformed body is a 400, not a 500 from
            # submit_forced's int() cast (bool is an int subclass; floats
            # would silently truncate).
            if (not isinstance(durs, list) or not durs
                    or not all(isinstance(d, int) and not isinstance(d, bool)
                               for d in durs)):
                raise ValueError(
                    "durations must be a non-empty list of integer frame "
                    "counts, one per phoneme")
            if len(ids_list) != 1:
                raise ValueError(
                    "durations require a single utterance (phoneme_ids or "
                    "one sentence) — the plan maps 1:1 onto its phonemes")
            for k in ("length_scale", "noise_w"):
                if req.get(k) is not None:
                    raise ValueError(
                        f"{k} has no effect with durations (they replace "
                        f"the duration predictor it shapes) — scale the "
                        f"durations instead")
            fut = self.server.submit_forced(
                voice, ids_list[0], durs, **kwargs)
            from piper_tpu_torch.core.audio import pcm_to_float32

            return pcm_to_float32(fut.result(timeout=600)), rt, []
        futs = [self.server.submit(voice, ids, **kwargs) for ids in ids_list]
        from piper_tpu_torch.core.audio import join_with_silence, pcm_to_float32

        # An output_dtype='int16' runtime resolves futures to int16 PCM;
        # normalize BEFORE the float paths (a plain float32 upcast would
        # turn every sample into +/-32767-scale values and the WAV/pcm
        # encoders would saturate the whole waveform).
        audios = [pcm_to_float32(f.result(timeout=600)) for f in futs]
        if len(audios) == 1:
            return audios[0], rt, []
        gap_s = float(req.get("sentence_silence", 0.2))
        # join_with_silence raises ValueError on negative -> HTTP 400.
        return join_with_silence(
            audios, int(round(gap_s * rt.sample_rate))), rt, []

    def _synthesize_ssml(self, req: dict, voice: str, rt: PiperRuntime):
        """"ssml" body field: expressive markup rendered through the SAME
        batched serving path — each SSML utterance becomes one submit()
        (the batcher's (scales, bucket, mix) queues group same-prosody
        spans into batched decodes), the handler assembles gaps/volume.
        Prosody/voice live in the document, so the per-request knobs that
        would fight it are rejected (_ssml_plan_for)."""
        from piper_tpu_torch.core.audio import pcm_to_float32
        from piper_tpu_torch.core.ssml import assemble, submit_kwargs

        plan, _ = _ssml_plan_for(req, rt, self._phonemizers)
        common = {k: req[k] for k in ("noise_scale", "noise_w")
                  if req.get(k) is not None}
        futs = []
        try:
            for u in plan.utterances:
                futs.append(self.server.submit(
                    voice, u.ids, **submit_kwargs(u.ctx, common)))
        except Exception:
            # A mid-document rejection (bad <voice> id, admission shed)
            # must not leave earlier utterances synthesizing audio nobody
            # will read — best-effort cancel before surfacing the error.
            for f in futs:
                f.cancel()
            raise
        audios = [pcm_to_float32(f.result(timeout=600)) for f in futs]
        return assemble(audios, plan, rt.sample_rate), rt, plan.ignored

    def _durations(self, req: dict) -> dict:
        """Phoneme-level alignment for a request WITHOUT synthesizing audio:
        encoder-only on the worker thread. The spans are exactly those a
        /v1/synthesize of the same request realizes (per-row seeded noise —
        see PiperRuntime.phoneme_durations); multi-sentence text reports one
        utterance per sentence with offsets including the sentence gaps.
        Durations are the decoder's PLAN — in the rare case a plan exceeds
        the runtime's largest frame bucket the synthesized audio truncates
        and later offsets shift."""
        voice = req.get("voice", self.default_voice)
        if voice not in self.runtimes:
            raise KeyError(f"unknown voice {voice!r}")
        rt = self.runtimes[voice]
        if req.get("ssml") is not None:
            return self._durations_ssml(req, voice, rt)
        kwargs = {k: req[k] for k in
                  ("length_scale", "noise_w", "speaker_id")
                  if req.get(k) is not None}
        _speaker_kwargs(req, rt, kwargs)
        hop, sr = rt.hparams.hop_length, rt.sample_rate
        # Validate BEFORE enqueueing: an invalid gap must not spend device
        # worker time on encodes whose result will be thrown away as a 400.
        gap_s = float(req.get("sentence_silence", 0.2))
        if gap_s < 0:
            raise ValueError("sentence_silence must be >= 0")
        ids_list = self._ids_for(req, rt)
        futs = [self.server.submit_durations(voice, ids, **kwargs)
                for ids in ids_list]
        durs = [f.result(timeout=600) for f in futs]
        from piper_tpu_torch.core.alignment import alignments_to_json, make_alignment

        gap = int(round(gap_s * sr)) if len(ids_list) > 1 else 0
        # The synthesized audio is capped at the largest frame bucket (the
        # runtime truncates and warns) — cap total_samples the same way so
        # the alignment doc reports truncated=True with clipped spans and
        # later utterances' offsets match the joined waveform.
        cap = rt.options.frame_buckets[-1] * hop
        aligns, offsets, pos = [], [], 0
        for ids, d in zip(ids_list, durs):
            n = min(max(int(d.sum()), 1) * hop, cap)
            aligns.append(make_alignment(ids, d, hop_length=hop,
                                         sample_rate=sr, total_samples=n))
            offsets.append(pos)
            pos += n + gap
        doc = alignments_to_json(aligns, offsets)
        doc["voice"] = voice
        doc["sample_rate"] = sr
        doc["total_samples"] = max(0, pos - gap) if aligns else 0
        return doc

    def _durations_ssml(self, req: dict, voice: str, rt: PiperRuntime) -> dict:
        """"ssml" on /v1/durations: the timing a /v1/synthesize of the SAME
        document realizes — per-utterance alignment with offsets that walk
        the assembly (breaks, sentence gaps). Encoder-only on the worker."""
        from piper_tpu_torch.core.alignment import alignments_to_json, make_alignment
        from piper_tpu_torch.core.ssml import alignment_offsets, submit_kwargs

        plan, _ = _ssml_plan_for(req, rt, self._phonemizers)
        common = {k: req[k] for k in ("noise_w",) if req.get(k) is not None}
        futs = []
        try:
            for u in plan.utterances:
                futs.append(self.server.submit_durations(
                    voice, u.ids, **submit_kwargs(u.ctx, common)))
        except Exception:
            for f in futs:
                f.cancel()
            raise
        durs = [f.result(timeout=600) for f in futs]
        hop, sr = rt.hparams.hop_length, rt.sample_rate
        offsets, lengths, total = alignment_offsets(
            plan, durs, hop_length=hop, sample_rate=sr,
            frame_cap=rt.options.frame_buckets[-1])
        aligns = [
            make_alignment(u.ids, d, hop_length=hop, sample_rate=sr,
                           total_samples=n)
            for u, d, n in zip(plan.utterances, durs, lengths)
        ]
        out = alignments_to_json(aligns, offsets)
        out["voice"] = voice
        out["sample_rate"] = sr
        out["total_samples"] = total
        if plan.ignored:
            out["ignored"] = plan.ignored
        return out

    # -- lifecycle ---------------------------------------------------------

    def _flat_metrics(self) -> Dict[str, dict]:
        """Per-voice flat numeric metrics for the Prometheus exporter: the
        unified backend's nested {"batch","stream"} shape flattens to the
        batch counters plus stream_* prefixed streaming counters."""
        m = self.server.metrics()
        if not self.stream:
            return m
        flat = {k: dict(v) for k, v in m["batch"].items()}
        for k, sm in m["stream"].items():
            flat.setdefault(k, {}).update(
                {f"stream_{kk}": vv for kk, vv in sm.items()})
        return flat

    def prewarm(self, **kwargs):
        return self.server.prewarm(**kwargs)

    def _close_backend(self) -> None:
        self.server.close()


class PiperStreamingHTTPServer(_HttpLifecycle):
    """Low-latency chunked streaming over HTTP for ONE voice — the minimal
    streaming-only deployment (the StreamingServer's own worker, nothing
    else on the device). Most deployments should prefer
    PiperHTTPServer(stream=True), which serves this same /v1/stream
    contract PLUS the batched endpoints for N voices from one process on
    one unified device worker (engine/unified.py).

    POST /v1/stream  {phoneme_ids|ipa|text|ssml, seed?, noise_scale?,
                      length_scale?, noise_w?, speaker_id?, speaker_mix?,
                      sentence_silence?}  (ssml streams the document
                      utterance by utterance — breaks arrive as silence
                      chunks, per-span prosody/voice applied)
      -> HTTP/1.1 Transfer-Encoding: chunked, audio/x-raw-int16 — one HTTP
         chunk per decoded window, the first after the stream head's
         time to first audio; concurrent requests batch their steady-state
         windows on the device. X-Sample-Rate carries the rate.
    GET /healthz, /v1/metrics.

    Admission errors for the first sentence surface as a real 429 before
    headers; mid-stream failures truncate the chunked body. A client that
    disconnects mid-stream has its session cancelled (the slot frees) —
    the handler's finally block and StreamingServer's cancel path exist
    for exactly that.
    """

    def __init__(self, runtime: PiperRuntime, *, host: str = "127.0.0.1",
                 port: int = 0, **stream_kwargs):
        from piper_tpu_torch.engine.stream_server import StreamingServer

        self.rt = runtime
        self.server = StreamingServer(runtime, **stream_kwargs)
        self._phonemizers: Dict[int, object] = {}
        outer = self

        class Handler(_JsonHandler):
            protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(200, {"ok": True})
                elif self.path == "/v1/metrics":
                    self._send_json(200, outer.server.metrics())
                else:
                    self._send_json(404, {"error": "unknown route"})

            def do_POST(self):
                if self.path != "/v1/stream":
                    self._send_json(404, {"error": "unknown route"})
                    return
                req = self._read_json_body()
                if req is None:
                    return
                _handle_stream_post(self, req, outer.rt,
                                    outer.server.submit, outer._phonemizers)

        self._init_http(host, port, Handler)

    def prewarm(self, **kwargs):
        return self.server.prewarm(**kwargs)

    def _close_backend(self) -> None:
        self.server.shutdown()
