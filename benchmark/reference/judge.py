"""The comparison that decides `correct`: what the timed path returned,
row by row, against the plain reference worked out again from the same
inputs.

Each row the window returned is judged in two numbers:

- `frames_off` (frames, exact, limit 0): how far the row's length, the
  sum of its phonemes' integer durations read from the PCM's length, lies
  outside what the reference's durations allow. A duration within
  TIE_FRAMES of a whole frame may round either way (the fp32 order of sums
  decides it), so such a phoneme allows both of its integers; every other
  phoneme allows one. Every row due in the window is held to it.
- `audio_gap` (full scale): the widest gap between the row's int16 PCM and
  the reference's waveform, quantized the same way, over a sample of rows
  drawn from the seed with the longest among them. The reference decodes
  the durations the row's length implies (the row's own frame plan, read
  only to judge it, as a served model's tokens are); a row whose length
  two or more tie phonemes could explain is left out of this number and
  counted.

The reference re-derives what the program derived from the inputs: the
noise from the seed (`noise.py`), the phoneme and frame buckets that set
the noise's width (the runtime's ladders, copied below), and a served
row's frame budget from its own calibration of the voice. It runs in fp32
with TF32 off, after the program's state is freed, in blocks of rows.
`stand_in` runs the same reference in the program's place at a given
precision: the control.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.core.traffic import PHRASE
from benchmark.reference import noise, vits

# The runtime's ladders (piper_tpu_torch/engine/bucketing.py at commit 1fc906d).
PHONEME_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
FRAME_BUCKETS = (32, 64, 96, 128, 192, 256, 320, 384, 512, 640, 768, 1024, 1536, 2048,
                 3072, 4096, 6144, 8192, 12288, 16384, 24576, 32768)
TIE_FRAMES = 1e-4
ENCODE_BLOCK = 64
DECODE_BLOCK = 16


def bucket(value: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if value <= b:
            return b
    return ladder[-1]


@dataclass
class Row:
    """One answer of the window and what the reference needs to redo it."""

    ids: List[int]
    seed: int
    pcm: Optional[np.ndarray]           # int16, None where it never came
    group: int = 0                       # offline: the batch (its longest row sets the frames)
    budget: Optional[Tuple[int, int]] = None  # served: the fused frame budget and its redo
    # filled by the judge
    frames_off: float = field(default=0.0)


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 with TF32 off (the reference), or TF32 on (the control)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class Reference:
    def __init__(self, hp: dict, inference: dict, weights: Dict[str, np.ndarray], device,
                 tf32: bool = False):
        self.hp, self.inf, self.device, self.tf32 = hp, inference, torch.device(device), tf32
        self.params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                       for k, v in weights.items()}
        self.hop = math.prod(hp["upsample_rates"])

    def durations(self, rows: Sequence[Tuple[List[int], int]]):
        """(ids, seed) rows -> their encodings and fp32 durations w, each
        row padded to its own phoneme bucket (the width of its noise)."""
        out = [None] * len(rows)
        keys: Dict[Tuple[int, int], List[int]] = {}
        for i, (ids, seed) in enumerate(rows):
            keys.setdefault((int(seed), bucket(len(ids), PHONEME_BUCKETS)), []).append(i)
        with precision(self.tf32):
            for (seed, p), idx in keys.items():
                dp = noise.normal(seed, 0, (2, p), self.device)
                for lo in range(0, len(idx), ENCODE_BLOCK):
                    blk = idx[lo:lo + ENCODE_BLOCK]
                    ids = torch.zeros((len(blk), p), dtype=torch.long)
                    for r, i in enumerate(blk):
                        ids[r, :len(rows[i][0])] = torch.tensor(rows[i][0])
                    lengths = torch.tensor([len(rows[i][0]) for i in blk])
                    m_p, logs_p, x_mask, w = vits.encode(
                        self.params, self.hp, ids.to(self.device), lengths.to(self.device),
                        dp.expand(len(blk), 2, p), length_scale=self.inf["length_scale"],
                        noise_w=self.inf["noise_w"])
                    for r, i in enumerate(blk):
                        out[i] = (m_p[r:r + 1], logs_p[r:r + 1], x_mask[r:r + 1], w[r:r + 1])
        return out

    def audio(self, encs, plans: Sequence[np.ndarray], seeds: Sequence[int],
              widths: Sequence[int]) -> List[np.ndarray]:
        """Float waveforms of rows from their encodings, integer frame
        plans, seeds and frame widths: the prior noise one draw of the
        width."""
        out = [None] * len(encs)
        keys: Dict[Tuple[int, int], List[int]] = {}
        for i, (s, f) in enumerate(zip(seeds, widths)):
            keys.setdefault((int(s), int(f)), []).append(i)
        c = self.hp["inter_channels"]
        with precision(self.tf32):
            for (seed, f), idx in keys.items():
                mn = noise.normal(seed, 1, (c, f), self.device)
                for lo in range(0, len(idx), DECODE_BLOCK):
                    blk = idx[lo:lo + DECODE_BLOCK]
                    p = max(encs[i][0].shape[-1] for i in blk)

                    def padded(t, i):
                        return torch.nn.functional.pad(t, (0, p - t.shape[-1]))

                    m_p = torch.cat([padded(encs[i][0], i) for i in blk])
                    logs_p = torch.cat([padded(encs[i][1], i) for i in blk])
                    x_mask = torch.cat([padded(encs[i][2], i) for i in blk])
                    w_ceil = torch.stack([
                        torch.nn.functional.pad(torch.as_tensor(plans[i], dtype=torch.float32),
                                                (0, p - len(plans[i]))) for i in blk]).to(self.device)
                    audio, y_len = vits.decode(self.params, self.hp, m_p, logs_p, x_mask, w_ceil,
                                               mn.expand(len(blk), c, f), max_frames=f,
                                               noise_scale=self.inf["noise_scale"])
                    audio = audio.float().cpu().numpy()
                    for r, i in enumerate(blk):
                        out[i] = audio[r, : int(y_len[r]) * self.hop]
        return out

    def calibrated_budgets(self, seed: int, p_buckets: Sequence[int]):
        """A served row's frame budgets, as the batcher derives them: the
        voice's frames per phoneme from one synthesis of the fixture phrase
        cut to 64 ids, x 1.25 a bucket, and twice that for the redo."""
        ids = (list(PHRASE) * 5)[:64]
        (enc,) = self.durations([(ids, seed)])
        fpp = max(0.5, max(1, int(torch.ceil(enc[3]).sum())) / 64)
        out = {}
        for p in p_buckets:
            budget = max(32, int(p * fpp * 1.25))
            out[p] = (bucket(max(32, budget), FRAME_BUCKETS),
                      bucket(max(32, 2 * budget), FRAME_BUCKETS))
        return out


def plan_for(w: torch.Tensor, total: int) -> Tuple[Optional[np.ndarray], float]:
    """The integer durations a row of length `total` frames implies, given
    the reference's fp32 durations w (1, P): (plan or None where ties
    leave it open, frames outside what the reference allows)."""
    w = w[0].double().cpu().numpy()
    base = np.ceil(w)
    lo_c = np.ceil(w - TIE_FRAMES)   # a tie that rounds down
    hi_c = np.ceil(w + TIE_FRAMES)   # a tie that rounds up
    diff = int(total) - int(base.sum())
    if diff == 0:
        return base, 0.0
    movable = np.flatnonzero(hi_c > base) if diff > 0 else np.flatnonzero(lo_c < base)
    off = max(0, abs(diff) - len(movable))
    if off:
        return None, float(off)
    if len(movable) != abs(diff):
        return None, 0.0
    plan = base.copy()
    plan[movable] += 1 if diff > 0 else -1
    return plan, 0.0


def quantized(audio: np.ndarray) -> np.ndarray:
    """The program's int16 conversion: clip to [-1, 1], x 32767, toward 0."""
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def _width(row: Row, total: int, group_max: Dict[int, int]) -> int:
    """The frame width the program decoded a row at: its batch's longest
    row's bucket (split mode), or its fused budget or the redo's (a served
    row)."""
    if row.budget is not None:
        f, f2 = row.budget
        return f if total <= f else f2 if total <= f2 else bucket(total, FRAME_BUCKETS)
    return bucket(group_max[row.group], FRAME_BUCKETS)


def judge(ref: Reference, rows: List[Row], sample: Sequence[int]) -> dict:
    """Hold every row to frames_off and the sampled rows to audio_gap."""
    hop = ref.hop
    encs = ref.durations([(r.ids, r.seed) for r in rows])
    plans: List[Optional[np.ndarray]] = [None] * len(rows)
    totals = [None if r.pcm is None else len(r.pcm) // hop for r in rows]
    ragged = sum(1 for r in rows if r.pcm is not None and len(r.pcm) % hop)
    for i, r in enumerate(rows):
        if totals[i] is None:
            continue
        plans[i], r.frames_off = plan_for(encs[i][3], totals[i])
    group_max: Dict[int, int] = {}
    for r, t in zip(rows, totals):
        if t is not None:
            group_max[r.group] = max(group_max.get(r.group, 1), t)
    picked = [i for i in sample if plans[i] is not None]
    audio = ref.audio([encs[i] for i in picked], [plans[i] for i in picked],
                      [rows[i].seed for i in picked],
                      [_width(rows[i], totals[i], group_max) for i in picked])
    gap = 0.0
    for i, a in zip(picked, audio):
        q = quantized(a).astype(np.int32)
        got = rows[i].pcm.astype(np.int32)
        if len(got) != len(q):
            gap = max(gap, 1.0)
            continue
        if len(q):
            gap = max(gap, float(np.abs(got - q).max()) / 32767.0)
    missing = sum(1 for t in totals if t is None)
    return {
        "numbers": {"frames_off": max([r.frames_off for r in rows] + [0.0]),
                    "audio_gap": gap},
        "rows": len(rows), "rows_missing": missing, "rows_ragged": ragged,
        "audio_rows": len(picked), "audio_rows_open": len(sample) - len(picked),
    }


def stand_in(ref: Reference, rows: List[Row], sample: Sequence[int]) -> None:
    """The reference in the program's place: every row's length from its
    own durations (ceil), the sampled rows' PCM from its own decode at
    frame widths derived as the program derives them, at the reference's
    precision (the judge reads no other row's samples)."""
    encs = ref.durations([(r.ids, r.seed) for r in rows])
    plans = [np.ceil(e[3][0].double().cpu().numpy()) for e in encs]
    totals = [int(max(1, p.sum())) for p in plans]
    group_max: Dict[int, int] = {}
    for r, t in zip(rows, totals):
        group_max[r.group] = max(group_max.get(r.group, 1), t)
    for r, t in zip(rows, totals):
        r.pcm = np.zeros(t * ref.hop, np.int16)
    audio = ref.audio([encs[i] for i in sample], [plans[i] for i in sample],
                      [rows[i].seed for i in sample],
                      [_width(rows[i], totals[i], group_max) for i in sample])
    for i, a in zip(sample, audio):
        rows[i].pcm = quantized(a)


def sample_rows(rows: List[Row], n: int, seed: int) -> List[int]:
    """n rows drawn from the seed, the longest among them."""
    alive = [i for i, r in enumerate(rows) if r.pcm is not None]
    if len(alive) <= n:
        return alive
    longest = max(len(rows[i].ids) for i in alive)
    top = [i for i in alive if len(rows[i].ids) == longest]
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 99])
    first = list(rng.choice(top, size=min(len(top), max(1, n // 4)), replace=False))
    rest = [i for i in alive if i not in set(first)]
    more = list(rng.choice(rest, size=n - len(first), replace=False))
    return sorted(int(i) for i in first + more)
