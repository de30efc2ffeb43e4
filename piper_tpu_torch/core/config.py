"""Voice config (the `*.onnx.json` sidecar every Piper voice ships with).

Mirrors the schema the reference decodes (PiperConfig.swift:3-47): audio
sample rate, espeak voice, inference scale defaults, the phoneme->ID map,
symbol/speaker counts, and language metadata. Unknown keys are preserved in
`extras` so configs round-trip.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class AudioSection:
    sample_rate: int
    quality: Optional[str] = None


@dataclass(frozen=True)
class ESpeakSection:
    voice: str


@dataclass(frozen=True)
class InferenceSection:
    noise_scale: float = 0.667
    length_scale: float = 1.0
    noise_w: float = 0.8


@dataclass(frozen=True)
class LanguageSection:
    code: str
    family: Optional[str] = None
    region: Optional[str] = None
    name_native: Optional[str] = None
    name_english: Optional[str] = None
    country_english: Optional[str] = None


@dataclass(frozen=True)
class VoiceConfig:
    """Parsed Piper voice configuration.

    `phoneme_id_map` maps a single-character phoneme symbol to a list of IDs
    (Piper always uses lists of length 1). Special symbols: `^` BOS, `$` EOS,
    `_` interleaved blank/pad (see core.phonemes).
    """

    audio: AudioSection
    inference: InferenceSection
    phoneme_type: str
    phoneme_id_map: Dict[str, List[int]]
    num_symbols: int
    num_speakers: int
    espeak: Optional[ESpeakSection] = None
    phoneme_map: Optional[Dict[str, str]] = None
    speaker_id_map: Optional[Dict[str, int]] = None
    piper_version: Optional[str] = None
    language: Optional[LanguageSection] = None
    dataset: Optional[str] = None
    extras: Dict[str, Any] = field(default_factory=dict)

    KNOWN_KEYS = {
        "audio",
        "espeak",
        "inference",
        "phoneme_type",
        "phoneme_map",
        "phoneme_id_map",
        "num_symbols",
        "num_speakers",
        "speaker_id_map",
        "piper_version",
        "language",
        "dataset",
    }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VoiceConfig":
        audio_d = d.get("audio", {})
        audio = AudioSection(
            sample_rate=int(audio_d.get("sample_rate", 22050)),
            quality=audio_d.get("quality"),
        )
        espeak = None
        if isinstance(d.get("espeak"), dict) and "voice" in d["espeak"]:
            espeak = ESpeakSection(voice=d["espeak"]["voice"])
        inf_d = d.get("inference", {})
        inference = InferenceSection(
            noise_scale=float(inf_d.get("noise_scale", 0.667)),
            length_scale=float(inf_d.get("length_scale", 1.0)),
            noise_w=float(inf_d.get("noise_w", 0.8)),
        )
        language = None
        if isinstance(d.get("language"), dict) and "code" in d["language"]:
            lang_d = d["language"]
            language = LanguageSection(
                code=lang_d["code"],
                family=lang_d.get("family"),
                region=lang_d.get("region"),
                name_native=lang_d.get("name_native"),
                name_english=lang_d.get("name_english"),
                country_english=lang_d.get("country_english"),
            )
        phoneme_id_map = {
            str(k): [int(x) for x in v] for k, v in d.get("phoneme_id_map", {}).items()
        }
        extras = {k: v for k, v in d.items() if k not in VoiceConfig.KNOWN_KEYS}
        return VoiceConfig(
            audio=audio,
            espeak=espeak,
            inference=inference,
            phoneme_type=str(d.get("phoneme_type", "espeak")),
            phoneme_map=d.get("phoneme_map"),
            phoneme_id_map=phoneme_id_map,
            num_symbols=int(d.get("num_symbols", len(phoneme_id_map))),
            num_speakers=int(d.get("num_speakers", 1)),
            speaker_id_map=d.get("speaker_id_map"),
            piper_version=d.get("piper_version"),
            language=language,
            dataset=d.get("dataset"),
            extras=extras,
        )

    @staticmethod
    def load(path: str | Path) -> "VoiceConfig":
        with open(path, "r", encoding="utf-8") as f:
            return VoiceConfig.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "audio": {"sample_rate": self.audio.sample_rate},
            "inference": {
                "noise_scale": self.inference.noise_scale,
                "length_scale": self.inference.length_scale,
                "noise_w": self.inference.noise_w,
            },
            "phoneme_type": self.phoneme_type,
            "phoneme_id_map": self.phoneme_id_map,
            "num_symbols": self.num_symbols,
            "num_speakers": self.num_speakers,
        }
        if self.audio.quality is not None:
            d["audio"]["quality"] = self.audio.quality
        if self.espeak is not None:
            d["espeak"] = {"voice": self.espeak.voice}
        if self.phoneme_map is not None:
            d["phoneme_map"] = self.phoneme_map
        if self.speaker_id_map is not None:
            d["speaker_id_map"] = self.speaker_id_map
        if self.piper_version is not None:
            d["piper_version"] = self.piper_version
        if self.language is not None:
            d["language"] = {
                k: v
                for k, v in {
                    "code": self.language.code,
                    "family": self.language.family,
                    "region": self.language.region,
                    "name_native": self.language.name_native,
                    "name_english": self.language.name_english,
                    "country_english": self.language.country_english,
                }.items()
                if v is not None
            }
        if self.dataset is not None:
            d["dataset"] = self.dataset
        d.update(self.extras)
        return d

    def save(self, path: str | Path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, ensure_ascii=False)
