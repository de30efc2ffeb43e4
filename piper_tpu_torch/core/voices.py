"""Voice index + download/cache manager (the port's copy of
piper_tpu.core.voices, with the same bundled VOICES.md).

Mirrors the reference's PiperVoices.swift:54-289: a machine-parseable markdown
voice table (id | language | quality | model_url | config_url | model_sha256 |
config_sha256), an async-ish download-and-cache layer with atomic `.partial`
renames, detection of cached HTML error pages, and optional SHA256 verification.

Because upstream Piper voices live at a deterministic HuggingFace path,
entries for voices not present in the bundled table can be synthesized from
the voice id alone (`VoiceIndex.entry_for_id`).
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

_HF_BASE = "https://huggingface.co/rhasspy/piper-voices/resolve/main"


@dataclass(frozen=True)
class VoiceEntry:
    id: str
    language: str
    quality: str
    model_url: str
    config_url: str
    model_sha256: str = ""
    config_sha256: str = ""


class VoiceIndexError(ValueError):
    pass


class VoiceIndex:
    """Parses the bundled markdown voice table (same format as the reference's
    Resources/VOICES.md, PiperVoices.swift:80-138)."""

    def __init__(self, entries: List[VoiceEntry]):
        self.entries = entries
        self._by_id: Dict[str, VoiceEntry] = {e.id: e for e in entries}

    @staticmethod
    def bundled_path() -> Path:
        return Path(__file__).parent / "resources" / "VOICES.md"

    @staticmethod
    def load_bundled() -> "VoiceIndex":
        return VoiceIndex.parse(VoiceIndex.bundled_path().read_text(encoding="utf-8"))

    @staticmethod
    def parse(markdown: str) -> "VoiceIndex":
        entries: List[VoiceEntry] = []
        for line in markdown.splitlines():
            line = line.strip()
            if not line.startswith("|"):
                continue
            cells = [c.strip() for c in line.strip("|").split("|")]
            if len(cells) < 5:
                continue
            # Skip header and separator rows.
            if cells[0] in ("id", "") or set(cells[0]) <= {"-", ":"}:
                continue
            entries.append(
                VoiceEntry(
                    id=cells[0],
                    language=cells[1],
                    quality=cells[2],
                    model_url=cells[3],
                    config_url=cells[4],
                    model_sha256=cells[5] if len(cells) > 5 else "",
                    config_sha256=cells[6] if len(cells) > 6 else "",
                )
            )
        return VoiceIndex(entries)

    def get(self, voice_id: str) -> Optional[VoiceEntry]:
        return self._by_id.get(voice_id)

    def resolve(self, voice_id: str) -> VoiceEntry:
        """Look up a voice; fall back to the deterministic HF URL pattern."""
        e = self.get(voice_id)
        if e is not None:
            return e
        return VoiceIndex.entry_for_id(voice_id)

    @staticmethod
    def entry_for_id(voice_id: str) -> VoiceEntry:
        """Build a VoiceEntry from the `<locale>-<name>-<quality>` id format
        using the upstream repository's path convention."""
        parts = voice_id.split("-")
        if len(parts) < 3:
            raise VoiceIndexError(
                f"voice id {voice_id!r} is not of the form <locale>-<name>-<quality>"
            )
        locale, quality = parts[0], parts[-1]
        name = "-".join(parts[1:-1])
        family = locale.split("_")[0]
        base = f"{_HF_BASE}/{family}/{locale}/{name}/{quality}/{voice_id}.onnx"
        return VoiceEntry(
            id=voice_id,
            language=locale,
            quality=quality,
            model_url=base,
            config_url=base + ".json",
        )


class VoiceDownloadError(RuntimeError):
    pass


class VoiceManager:
    """Download-and-cache for voice assets (reference: PiperVoices.swift:167-289).

    Layout: `<cache_root>/voices/<id>/<id>.onnx{,.json}`. Downloads go to a
    `.partial` file renamed atomically on success; cached files that look like
    HTML error pages are discarded and re-fetched; non-empty sha256 fields in
    the index are verified.
    """

    def __init__(self, cache_root: Optional[str | Path] = None, index: Optional[VoiceIndex] = None):
        if cache_root is None:
            cache_root = os.environ.get(
                "PIPER_TPU_CACHE",
                Path.home() / ".cache" / "piper-tpu",
            )
        self.cache_root = Path(cache_root)
        self.index = index or VoiceIndex.load_bundled()

    def voice_dir(self, voice_id: str) -> Path:
        return self.cache_root / "voices" / voice_id

    def cached_paths(self, voice_id: str) -> tuple[Path, Path]:
        d = self.voice_dir(voice_id)
        return d / f"{voice_id}.onnx", d / f"{voice_id}.onnx.json"

    def ensure_voice(self, voice_id: str) -> tuple[Path, Path]:
        """Return (model_path, config_path), downloading if needed."""
        entry = self.index.resolve(voice_id)
        model_path, config_path = self.cached_paths(voice_id)
        self._ensure_file(entry.model_url, model_path, entry.model_sha256)
        self._ensure_file(entry.config_url, config_path, entry.config_sha256)
        return model_path, config_path

    def _ensure_file(self, url: str, dest: Path, sha256: str) -> None:
        if dest.exists() and self._is_sane(dest, sha256):
            return
        dest.parent.mkdir(parents=True, exist_ok=True)
        partial = dest.with_suffix(dest.suffix + ".partial")
        try:
            with urllib.request.urlopen(url, timeout=120) as resp, open(partial, "wb") as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
        except Exception as e:  # noqa: BLE001 — wrap any transport error
            partial.unlink(missing_ok=True)
            raise VoiceDownloadError(f"failed to download {url}: {e}") from e
        if not self._is_sane(partial, sha256):
            partial.unlink(missing_ok=True)
            raise VoiceDownloadError(f"downloaded file failed validation: {url}")
        os.replace(partial, dest)  # atomic within the cache dir

    @staticmethod
    def _is_sane(path: Path, sha256: str) -> bool:
        try:
            size = path.stat().st_size
        except OSError:
            return False
        if size == 0:
            return False
        # Detect a cached HTML/error page masquerading as a model or config
        # (the reference does the same sniff — PiperVoices.swift:261-275).
        with open(path, "rb") as f:
            head = f.read(512).lstrip()
        if head[:15].lower().startswith((b"<!doctype html", b"<html")):
            return False
        if sha256:
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            if h.hexdigest().lower() != sha256.lower():
                return False
        return True
