"""IPA -> phoneme-ID mapping (reference: ESpeakPhonemizer.swift:76-103); the
port's copy of piper_tpu.core.phonemes.

Piper uses a single-character phoneme_id_map with special symbols:
`^` BOS, `$` EOS, `_` interleaved blank. The ID sequence for phonemes
p1..pn is `[^, p1, _, p2, _, ..., pn, _, $]` — i.e. BOS, then each phoneme
followed by a blank, then EOS (no trailing blank after EOS). Invisible
formatting characters espeak sometimes emits are skipped.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List

BOS = "^"
EOS = "$"
BLANK = "_"

_IGNORABLE = {
    0x200B,  # ZERO WIDTH SPACE
    0x200C,  # ZERO WIDTH NON-JOINER
    0x200D,  # ZERO WIDTH JOINER
    0xFE0E,  # VARIATION SELECTOR-15
    0xFE0F,  # VARIATION SELECTOR-16
}


class UnknownSymbolError(KeyError):
    def __init__(self, symbol: str):
        super().__init__(symbol)
        self.symbol = symbol

    def __str__(self) -> str:
        return f"Unknown phoneme symbol not in phoneme_id_map: {self.symbol!r}"


def _is_ignorable(ch: str) -> bool:
    if ord(ch) in _IGNORABLE:
        return True
    return unicodedata.category(ch) == "Cf"


def ipa_to_ids(ipa: str, phoneme_id_map: Dict[str, List[int]]) -> List[int]:
    """Map an IPA string to framed phoneme IDs."""
    try:
        bos = phoneme_id_map[BOS][0]
        eos = phoneme_id_map[EOS][0]
        blank = phoneme_id_map[BLANK][0]
    except (KeyError, IndexError) as e:
        raise UnknownSymbolError("^/$/_ missing from phoneme_id_map") from e

    ids: List[int] = [bos]
    for ch in ipa:
        if ch in ("\n", "\r"):
            continue
        if _is_ignorable(ch):
            continue
        entry = phoneme_id_map.get(ch)
        if not entry:
            raise UnknownSymbolError(ch)
        ids.append(entry[0])
        ids.append(blank)
    ids.append(eos)
    return ids
