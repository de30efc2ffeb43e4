"""Text -> IPA -> phoneme IDs via the external espeak-ng binary (the port's
copy of piper_tpu.phonemize).

Mirrors the reference's ESpeakPhonemizer (ESpeakPhonemizer.swift:22-124):
shells out to `espeak-ng -q -v <voice> --ipa=3 <text>` and maps each IPA
scalar through the voice config's phoneme_id_map with BOS/EOS/blank framing.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, List, Optional

from piper_tpu_torch.core.phonemes import ipa_to_ids


class PhonemizerError(RuntimeError):
    pass


def find_espeak() -> Optional[str]:
    for candidate in ("/usr/bin/espeak-ng", "/usr/local/bin/espeak-ng"):
        if shutil.which(candidate):
            return candidate
    return shutil.which("espeak-ng")


def phonemizer_for(runtime, cache: Optional[dict] = None) -> "ESpeakPhonemizer":
    """The one way to build (and memoize) a phonemizer for a loaded
    runtime — the espeak voice comes from the voice config, falling back
    to 'en'. `cache` (keyed by runtime identity) lets servers reuse one
    phonemizer per resident voice; the CLI passes none."""
    if cache is not None and id(runtime) in cache:
        return cache[id(runtime)]
    voice = runtime.config.espeak.voice if runtime.config.espeak else "en"
    ph = ESpeakPhonemizer(voice, runtime.config.phoneme_id_map)
    if cache is not None:
        cache[id(runtime)] = ph
    return ph


class ESpeakPhonemizer:
    def __init__(self, voice: str, phoneme_id_map: Dict[str, List[int]],
                 espeak_path: Optional[str] = None):
        self.espeak_path = espeak_path or find_espeak()
        if self.espeak_path is None:
            raise PhonemizerError(
                "espeak-ng not found; install it or pass phoneme ids / IPA directly"
            )
        self.voice = voice
        self.phoneme_id_map = phoneme_id_map

    def to_ipa(self, text: str) -> str:
        proc = subprocess.run(
            [self.espeak_path, "-q", "-v", self.voice, "--ipa=3", text],
            capture_output=True,
            text=True,
            timeout=60,
        )
        if proc.returncode != 0:
            raise PhonemizerError(
                f"espeak-ng failed with exit code {proc.returncode}: {proc.stderr.strip()}"
            )
        return proc.stdout.strip()

    def phoneme_ids(self, text: str) -> List[int]:
        return ipa_to_ids(self.to_ipa(text), self.phoneme_id_map)
