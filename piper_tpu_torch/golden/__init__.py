"""Full-width JAX goldens, and the check that holds the port to them.

Each `{quality}_f{factor}.npz` is one utterance of the fixture phrase
repeated `factor` times on the full-width synthetic voice
`make_synthetic_voice(quality, seed=0)`, computed by the JAX package on the
CPU at "highest" in split mode with injected noise drawn from
`np.random.default_rng(SEED)`: `ids` (n,), `dp_noise` (2, n), `main_noise`
(C, y_total), the durations `w_ceil` (n,) and the fp32 `audio`. They are
data: the port never imports the code that made them
(`tests/test_torch_golden.py::make_golden` regenerates them and holds the
committed files equal to what the JAX package computes).

`compare` runs a runtime on a golden's ids and noise: `w_ceil` must be
equal and the waveform within FP32_ATOL at fp32, or LOWERED_ATOL when any
tier of the runtime is lowered.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

SEED = 0
GOLDENS = (("medium", 1), ("medium", 8), ("x_low", 1), ("x_low", 8))
FP32_ATOL = 1e-4     # the fp32 waveform bar the JAX package is held to
LOWERED_ATOL = 1e-3  # the lowered-precision waveform gate (BASELINE.md)


def path(quality: str, factor: int) -> Path:
    return Path(__file__).resolve().parent / f"{quality}_f{factor}.npz"


def factors(quality: str):
    """The factors with a golden for `quality` (none for other voices)."""
    return tuple(f for q, f in GOLDENS if q == quality)


def load(quality: str, factor: int) -> Dict[str, np.ndarray]:
    with np.load(path(quality, factor)) as z:
        return {k: z[k] for k in z.files}


def atol_for(options) -> float:
    """FP32_ATOL when encode, flows and vocoder all run "highest", else
    LOWERED_ATOL."""
    vp = options.vocoder_precision
    tiers = [options.precision, options.flow_precision,
             *(vp if isinstance(vp, (tuple, list)) else (vp,))]
    return FP32_ATOL if all(t in (None, "highest") for t in tiers) else LOWERED_ATOL


def compare(rt, quality: str, factor: int) -> dict:
    """Run runtime `rt` (float32 output) on one golden's ids and injected
    noise. Returns its row: `w_ceil_equal`, `max_abs_err` beside `atol`,
    and `ok`. Where a duration differs, the row lists the phonemes and how
    far the port's pre-ceil durations there lie from an integer (a ceil
    that flips on an ulp lies within ~1e-6)."""
    if rt.options.output_dtype != "float32":
        raise ValueError("golden.compare needs a runtime with output_dtype='float32'")
    g = load(quality, factor)
    ids = g["ids"].tolist()
    atol = atol_for(rt.options)
    row = {"quality": quality, "factor": factor, "phonemes": len(ids), "atol": atol,
           "precision": rt.options.precision,
           "vocoder_precision": rt.options.vocoder_precision,
           "flow_precision": rt.options.flow_precision}
    w, w_ceil = rt._durations([ids], dp_noise=g["dp_noise"][None])
    w, w_ceil = w[0, : len(ids)], w_ceil[0, : len(ids)]
    if not np.array_equal(w_ceil, g["w_ceil"]):
        at = np.nonzero(w_ceil != g["w_ceil"])[0]
        return {**row, "w_ceil_equal": False, "max_abs_err": None, "ok": False,
                "w_ceil_differs_at": at.tolist(),
                "pre_ceil_distance_to_integer": np.abs(w[at] - np.round(w[at])).tolist()}
    audio = rt.synthesize(ids, dp_noise=g["dp_noise"], main_noise=g["main_noise"])
    want = g["audio"]
    err = float(np.abs(audio - want).max()) if audio.shape == want.shape else None
    return {**row, "w_ceil_equal": True, "frames": int(g["w_ceil"].sum()),
            "samples": int(want.shape[0]), "max_abs_err": err,
            "ok": err is not None and err <= atol}


def check(rt, quality: str, factor: int) -> dict:
    """compare(), raising AssertionError unless the row is ok."""
    row = compare(rt, quality, factor)
    if not row["ok"]:
        raise AssertionError(f"golden {quality} f={factor}: {row}")
    return row
