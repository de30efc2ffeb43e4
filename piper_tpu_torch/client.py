"""Python client for the piper-tpu HTTP serving API (stdlib only).

The server side is `engine/http_server.py` (CLI `--serve` for the batched
API, `--serve --stream` for chunked streaming). These clients wrap the wire
protocol so applications get numpy audio in one call:

    from piper_tpu_torch.client import PiperClient
    c = PiperClient(port=5000)
    audio, sr = c.synthesize(text="Hello there. How are you?")
    doc = c.durations(text="Hello there.")        # phoneme timing JSON

    from piper_tpu_torch.client import PiperStreamingClient
    s = PiperStreamingClient(port=5001)
    for pcm16 in s.stream(text="Hello"):          # np.int16 chunks as decoded
        play(pcm16)

Errors surface as PiperClientError with the HTTP status and the server's
error message (429 = admission shed — retry with backoff).

The reference has no network surface; this is part of the serving stack the
TPU rebuild adds (SURVEY.md §2.9's serving obligation).
"""

from __future__ import annotations

import http.client
import json
from typing import Iterator, Optional, Sequence

import numpy as np


class PiperClientError(RuntimeError):
    """HTTP-level failure; `.status` carries the code (429 = shed)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def _request_body(
    *,
    text: Optional[str],
    ipa: Optional[str],
    phoneme_ids: Optional[Sequence[int]],
    voice: Optional[str] = None,
    ssml: Optional[str] = None,
    **scalars,
) -> dict:
    given = [k for k, v in
             (("text", text), ("ipa", ipa), ("phoneme_ids", phoneme_ids),
              ("ssml", ssml))
             if v is not None]
    if len(given) != 1:
        raise ValueError(f"pass exactly one of text/ipa/phoneme_ids/ssml "
                         f"(got {given or 'none'})")
    body: dict = {}
    if text is not None:
        body["text"] = text
    if ipa is not None:
        body["ipa"] = ipa
    if ssml is not None:
        body["ssml"] = ssml
    if phoneme_ids is not None:
        body["phoneme_ids"] = [int(i) for i in phoneme_ids]
    if voice is not None:
        body["voice"] = voice
    body.update({k: v for k, v in scalars.items() if v is not None})
    return body


class _BaseClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5000,
                 timeout: float = 600.0):
        self.host, self.port, self.timeout = host, int(port), timeout

    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    @staticmethod
    def _raise_for_status(status: int, data: bytes) -> None:
        """Decode the server's JSON error body (tolerating non-JSON and
        non-object bodies from intermediaries) and raise PiperClientError."""
        msg = data.decode(errors="replace")
        try:
            parsed = json.loads(data)
            if isinstance(parsed, dict):
                msg = str(parsed.get("error", msg))
        except ValueError:
            pass
        raise PiperClientError(status, msg)

    def _call(self, method: str, path: str, body: Optional[dict] = None):
        """One request/response; returns (content_type, bytes). Raises
        PiperClientError on a non-2xx status (JSON error bodies decoded)."""
        conn = self._connect()
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                self._raise_for_status(resp.status, data)
            return resp.getheader("Content-Type", ""), data
        finally:
            conn.close()

    def _get_json(self, path: str):
        _, data = self._call("GET", path)
        return json.loads(data)

    def health(self) -> bool:
        try:
            return bool(self._get_json("/healthz").get("ok"))
        except (OSError, ValueError, AttributeError, PiperClientError):
            # ValueError/AttributeError: a 200 with a non-JSON or non-object
            # body (wrong service / proxy splash page) is "not healthy",
            # not a crash of the liveness probe.
            return False

    def metrics(self) -> dict:
        return self._get_json("/v1/metrics")


class PiperClient(_BaseClient):
    """Client for the batched serving API (PiperHTTPServer / CLI --serve)."""

    def voices(self) -> dict:
        """Voice key -> {sample_rate, num_speakers, phonemes}."""
        return self._get_json("/v1/voices")

    def synthesize(
        self,
        text: Optional[str] = None,
        ipa: Optional[str] = None,
        phoneme_ids: Optional[Sequence[int]] = None,
        *,
        voice: Optional[str] = None,
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        sentence_silence: Optional[float] = None,
        durations: Optional[Sequence[int]] = None,
        speaker_mix: Optional[dict] = None,
        ssml: Optional[str] = None,
        speaker: Optional[str] = None,
    ) -> tuple[np.ndarray, int]:
        """Synthesize one of text / ipa / phoneme_ids / ssml.

        `ssml` renders expressive markup server-side (breaks, prosody
        rate/volume, <phoneme ph>, <voice> speaker ids/mixes); it carries
        its own prosody, so length_scale / speaker_id / speaker_mix /
        durations cannot be combined with it.

        Returns (float32 PCM in [-1, 1], sample_rate). Multi-sentence text is
        one batched decode on the server, joined with sentence_silence gaps.

        `durations` forces per-phoneme frame counts (replacing the duration
        predictor — e.g. an edited durations() plan); single utterance only,
        incompatible with length_scale/noise_w.

        `speaker_mix` ({speaker_id: weight}) blends speaker embeddings on
        multi-speaker voices; mutually exclusive with speaker_id.
        """
        from piper_tpu_torch.utils.wav import parse_wav_bytes

        body = _request_body(
            text=text, ipa=ipa, phoneme_ids=phoneme_ids, voice=voice,
            ssml=ssml, noise_scale=noise_scale, length_scale=length_scale,
            noise_w=noise_w, speaker_id=speaker_id, speaker=speaker,
            sentence_silence=sentence_silence, speaker_mix=speaker_mix,
        )
        if durations is not None:
            durs = [int(d) for d in durations]
            if any(i != d for i, d in zip(durs, durations)):
                raise ValueError(
                    "durations must be integer frame counts (a float plan "
                    "would silently truncate)")
            body["durations"] = durs
        ctype, data = self._call("POST", "/v1/synthesize", body)
        if "wav" not in ctype:
            raise PiperClientError(500, f"unexpected content type {ctype!r}")
        return parse_wav_bytes(data)

    def durations(
        self,
        text: Optional[str] = None,
        ipa: Optional[str] = None,
        phoneme_ids: Optional[Sequence[int]] = None,
        *,
        voice: Optional[str] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        sentence_silence: Optional[float] = None,
        speaker_mix: Optional[dict] = None,
        ssml: Optional[str] = None,
        speaker: Optional[str] = None,
    ) -> dict:
        """Phoneme-level timing WITHOUT synthesizing audio (encoder-only on
        the server). Returns the alignment document: one entry per utterance
        with per-phoneme start/end samples and seconds — exactly the spans a
        synthesize() of the same request produces. `ssml` documents report
        offsets that include their breaks and sentence gaps."""
        body = _request_body(
            text=text, ipa=ipa, phoneme_ids=phoneme_ids, voice=voice,
            ssml=ssml, length_scale=length_scale, noise_w=noise_w,
            speaker_id=speaker_id, speaker=speaker,
            sentence_silence=sentence_silence, speaker_mix=speaker_mix,
        )
        _, data = self._call("POST", "/v1/durations", body)
        return json.loads(data)


class PiperStreamingClient(_BaseClient):
    """Client for the chunked streaming API (PiperStreamingHTTPServer /
    CLI --serve --stream). One voice per server process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5000,
                 timeout: float = 600.0):
        super().__init__(host, port, timeout)
        self.sample_rate: Optional[int] = None  # set by the first stream()

    def stream(
        self,
        text: Optional[str] = None,
        ipa: Optional[str] = None,
        phoneme_ids: Optional[Sequence[int]] = None,
        *,
        seed: Optional[int] = None,
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        sentence_silence: Optional[float] = None,
        speaker_mix: Optional[dict] = None,
        ssml: Optional[str] = None,
        speaker: Optional[str] = None,
    ) -> Iterator[np.ndarray]:
        """Yield int16 PCM chunks as the server decodes them (first chunk
        after ~TTFB, not after the whole utterance). `self.sample_rate` is
        populated from the response headers before the first yield. Closing
        the generator mid-stream drops the connection, which cancels the
        server-side session (its slot frees). `ssml` streams an expressive
        document utterance by utterance (breaks arrive as silence chunks);
        it carries its own prosody, so length_scale/speaker knobs cannot
        be combined with it."""
        body = _request_body(
            text=text, ipa=ipa, phoneme_ids=phoneme_ids, ssml=ssml,
            seed=seed, noise_scale=noise_scale, length_scale=length_scale,
            noise_w=noise_w, speaker_id=speaker_id, speaker=speaker,
            sentence_silence=sentence_silence, speaker_mix=speaker_mix,
        )
        conn = self._connect()
        try:
            conn.request("POST", "/v1/stream", body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status >= 400:
                self._raise_for_status(resp.status, resp.read())
            sr = resp.getheader("X-Sample-Rate")
            if sr:
                self.sample_rate = int(sr)
            # http.client strips the chunked framing; read1 returns what has
            # arrived so far, so audio flows out as the server decodes. A
            # network read may split an int16 mid-sample — carry the odd
            # byte into the next chunk.
            tail = b""
            while True:
                block = resp.read1(1 << 16)
                if not block:
                    break
                buf = tail + block
                cut = len(buf) - (len(buf) % 2)
                tail = buf[cut:]
                if cut:
                    yield np.frombuffer(buf[:cut], dtype="<i2")
            if tail:
                raise PiperClientError(500, "stream ended mid-sample")
        finally:
            conn.close()
