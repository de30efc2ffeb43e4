"""Sentence segmentation for long-text synthesis (the port's copy of
piper_tpu.core.text, its splitter unchanged).

The reference synthesizes whatever text it is handed as ONE utterance
(PiperCLI.swift:196-233); long paragraphs then hit the phoneme-bucket
ceiling and produce one monolithic decode. Splitting text into sentences is
both a quality feature (natural inter-sentence pauses via
`--sentence-silence`, like upstream piper's `--sentence_silence`) and a
throughput feature: a paragraph's sentences form a BATCH for one
batched decode instead of one long serial utterance.

The splitter is a documented heuristic (no language model): it breaks after
`.`, `!`, `?`, `…` (plus any closing quotes/brackets) when followed by
whitespace and an uppercase/digit/quote start, and avoids common English
abbreviations, single-initial patterns ("J. Smith"), decimal numbers, and
ellipsis-internal dots. For other languages it degrades to terminator
splitting, which is the same contract espeak-ng applies per clause.
"""

from __future__ import annotations

import re
from typing import List

# Common abbreviations that end with '.' but do not end a sentence.
_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "e.g",
    "i.e", "eg", "ie", "cf", "al", "inc", "ltd", "co", "corp", "dept",
    "fig", "no", "nos", "vol", "pp", "approx", "jan", "feb", "mar", "apr",
    "jun", "jul", "aug", "sep", "sept", "oct", "nov", "dec",
}

_TERMINATOR = re.compile(
    r"""([.!?…]+['"’”)\]]*)      # terminator(s) + closing quotes/brackets
        (\s+)                     # the whitespace that ends the sentence
    """,
    re.VERBOSE,
)


def _is_abbreviation(prefix: str) -> bool:
    """Does `prefix` (text up to and including a '.') end in an
    abbreviation or an initial?"""
    parts = prefix.rstrip(".").rsplit(None, 1)
    word = parts[-1] if parts else ""  # '.'/whitespace-only prefix -> no word
    word = word.lstrip("('\"“‘[")
    if not word:
        return False
    low = word.lower().rstrip(".")
    if low in _ABBREV:
        return True
    # single-letter initial: "J. Smith", "U.S. Navy" (any 1-letter token,
    # or dotted sequences like U.S)
    if len(word.rstrip(".")) == 1:
        return True
    if re.fullmatch(r"(?:[A-Za-z]\.)+[A-Za-z]?", word):
        return True
    return False


def split_sentences(text: str) -> List[str]:
    """Split `text` into sentences (terminators kept, whitespace collapsed).

    Returns at least one element for non-blank input; blank input returns
    an empty list."""
    text = text.strip()
    if not text:
        return []
    out: List[str] = []
    start = 0
    for m in _TERMINATOR.finditer(text):
        end = m.end(1)
        term = m.group(1)
        nxt = text[m.end():m.end() + 1]
        if term.startswith("."):
            prefix = text[start:m.start(1) + 1]
            # decimal numbers ("3. 14" never matches — the dot must be
            # followed by whitespace — but "No. 7" style does):
            if _is_abbreviation(prefix):
                continue
            if nxt and not (nxt.isupper() or nxt.isdigit()
                            or nxt in "'\"“‘(["):
                continue
        sent = text[start:end].strip()
        if sent:
            out.append(re.sub(r"\s+", " ", sent))
        start = m.end()
    tail = text[start:].strip()
    if tail:
        out.append(re.sub(r"\s+", " ", tail))
    return out
