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

The speaker goldens (`SPEAKER_GOLDENS`, `{quality}_ms904_{speaker}_f1.npz`)
are the same on the bench's multi-speaker voice,
`make_synthetic_voice(quality, seed=0, n_speakers=904, gin_channels=512)`,
for one speaker id (`speaker_id`) and one mix (`mix_ids`, `mix_weights`).

`compare` runs a runtime on a golden's ids, noise and speaker: `w_ceil` must
be equal and the waveform within FP32_ATOL at fp32, or LOWERED_ATOL when any
tier of the runtime is lowered.

The seeded goldens (`SEEDED_GOLDENS`, `{quality}_seed{SEEDED_SEED}_f{factor}.npz`)
draw no injected noise: the JAX package's runtime on the CPU at "highest"
in split mode made them from `seed=SEEDED_SEED`, its threefry noise, so they
hold the port's own seeded draws (`ops/kernels/prng.py`) to JAX's: `ids`,
`seed`, `w_ceil` (phoneme_durations) and `audio` (synthesize). The stream
golden (`STREAM_GOLDEN`, `..._stream_f{factor}.npz`) is
synthesize_stream_incremental at the same seed and a fixed `chunk_frames`:
the chunks' `starts` and their concatenated `audio`. `compare_seeded` runs
a runtime on one.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

SEED = 0
GOLDENS = (("medium", 1), ("medium", 8), ("x_low", 1), ("x_low", 8))
# The bench's multi-speaker voice and the speakers of its goldens.
N_SPEAKERS, GIN_CHANNELS = 904, 512
SPEAKERS = {"id903": {"speaker_id": 903}, "mix0_903": {"speaker_mix": {0: 0.6, 903: 0.4}}}
SPEAKER_GOLDENS = (("medium", 1, "id903"), ("medium", 1, "mix0_903"))
# The seeded goldens: (quality, factor) at SEEDED_SEED, and the stream
# golden (quality, factor, chunk_frames) at the same seed.
SEEDED_SEED = 5
SEEDED_GOLDENS = (("medium", 1),)
STREAM_GOLDEN = ("medium", 2, 16)
FP32_ATOL = 1e-4     # the fp32 waveform bar the JAX package is held to
LOWERED_ATOL = 1e-3  # the lowered-precision waveform gate (BASELINE.md)


def path(quality: str, factor: int, speaker: Optional[str] = None) -> Path:
    ms = "" if speaker is None else f"_ms{N_SPEAKERS}_{speaker}"
    return Path(__file__).resolve().parent / f"{quality}{ms}_f{factor}.npz"


def seeded_path(quality: str, factor: int, stream: bool = False) -> Path:
    kind = "_stream" if stream else ""
    return Path(__file__).resolve().parent / f"{quality}_seed{SEEDED_SEED}{kind}_f{factor}.npz"


def factors(quality: str):
    """The factors with a golden for `quality` (none for other voices)."""
    return tuple(f for q, f in GOLDENS if q == quality)


def load(quality: str, factor: int, speaker: Optional[str] = None,
         file: Optional[Path] = None) -> Dict[str, np.ndarray]:
    with np.load(file or path(quality, factor, speaker)) as z:
        return {k: z[k] for k in z.files}


def speaker_arrays(speaker: str) -> Dict[str, np.ndarray]:
    """A speaker golden's speaker, as its file stores it."""
    spec = SPEAKERS[speaker]
    if "speaker_id" in spec:
        return {"speaker_id": np.int64(spec["speaker_id"])}
    mix = spec["speaker_mix"]
    return {"mix_ids": np.asarray(list(mix), np.int64),
            "mix_weights": np.asarray(list(mix.values()), np.float32)}


def speaker_kwargs(g: Dict[str, np.ndarray]) -> dict:
    """The synthesize() speaker arguments of a loaded golden ({} for a
    single-speaker one)."""
    if "speaker_id" in g:
        return {"speaker_id": int(g["speaker_id"])}
    if "mix_ids" in g:
        return {"speaker_mix": {int(s): float(w)
                                for s, w in zip(g["mix_ids"], g["mix_weights"])}}
    return {}


def atol_for(options) -> float:
    """FP32_ATOL when encode, flows and vocoder all run "highest", else
    LOWERED_ATOL."""
    vp = options.vocoder_precision
    tiers = [options.precision, options.flow_precision,
             *(vp if isinstance(vp, (tuple, list)) else (vp,))]
    return FP32_ATOL if all(t in (None, "highest") for t in tiers) else LOWERED_ATOL


def compare(rt, quality: str, factor: int, speaker: Optional[str] = None) -> dict:
    """Run runtime `rt` (float32 output) on one golden's ids, injected
    noise and speaker (`speaker`, a key of SPEAKERS, on the N_SPEAKERS
    voice). Returns its row: `w_ceil_equal`, `max_abs_err` beside `atol`,
    and `ok`. Where a duration differs, the row lists the phonemes and how
    far the port's pre-ceil durations there lie from an integer (a ceil
    that flips on an ulp lies within ~1e-6)."""
    if rt.options.output_dtype != "float32":
        raise ValueError("golden.compare needs a runtime with output_dtype='float32'")
    if speaker is not None and rt.hparams.n_speakers != N_SPEAKERS:
        raise ValueError(f"the speaker goldens need the {N_SPEAKERS}-speaker voice")
    g = load(quality, factor, speaker)
    ids = g["ids"].tolist()
    spk = speaker_kwargs(g)
    atol = atol_for(rt.options)
    row = {"quality": quality, "factor": factor, "speaker": speaker, "phonemes": len(ids),
           "atol": atol, "precision": rt.options.precision,
           "vocoder_precision": rt.options.vocoder_precision,
           "flow_precision": rt.options.flow_precision}
    w, w_ceil = rt._durations(
        [ids], dp_noise=g["dp_noise"][None],
        speaker_ids=[spk["speaker_id"]] if "speaker_id" in spk else None,
        speaker_mixes=[spk["speaker_mix"]] if "speaker_mix" in spk else None)
    w, w_ceil = w[0, : len(ids)], w_ceil[0, : len(ids)]
    if not np.array_equal(w_ceil, g["w_ceil"]):
        at = np.nonzero(w_ceil != g["w_ceil"])[0]
        return {**row, "w_ceil_equal": False, "max_abs_err": None, "ok": False,
                "w_ceil_differs_at": at.tolist(),
                "pre_ceil_distance_to_integer": np.abs(w[at] - np.round(w[at])).tolist()}
    audio = rt.synthesize(ids, dp_noise=g["dp_noise"], main_noise=g["main_noise"], **spk)
    want = g["audio"]
    err = float(np.abs(audio - want).max()) if audio.shape == want.shape else None
    return {**row, "w_ceil_equal": True, "frames": int(g["w_ceil"].sum()),
            "samples": int(want.shape[0]), "max_abs_err": err,
            "ok": err is not None and err <= atol}


def check(rt, quality: str, factor: int, speaker: Optional[str] = None) -> dict:
    """compare(), raising AssertionError unless the row is ok."""
    row = compare(rt, quality, factor, speaker)
    if not row["ok"]:
        raise AssertionError(f"golden {quality} f={factor} {speaker or ''}: {row}")
    return row


def compare_seeded(rt, quality: str, factor: int, stream: bool = False) -> dict:
    """Run runtime `rt` (float32 output) on one seeded golden at its seed,
    drawing its own noise. Returns its row: `w_ceil_equal` (the durations
    of phoneme_durations), `max_abs_err` of the waveform (with `stream`:
    of synthesize_stream_incremental's chunks, whose starts must equal the
    golden's) beside `atol`, and `ok`."""
    if rt.options.output_dtype != "float32":
        raise ValueError("golden.compare_seeded needs a runtime with output_dtype='float32'")
    g = load(quality, factor, file=seeded_path(quality, factor, stream))
    ids, seed = g["ids"].tolist(), int(g["seed"])
    atol = atol_for(rt.options)
    row = {"quality": quality, "factor": factor, "seed": seed, "stream": stream,
           "phonemes": len(ids), "atol": atol, "precision": rt.options.precision}
    w_ceil = np.asarray(rt.phoneme_durations([ids], seed=seed)[0])
    if not np.array_equal(w_ceil, g["w_ceil"]):
        return {**row, "w_ceil_equal": False, "max_abs_err": None, "ok": False,
                "w_ceil_differs_at": np.nonzero(w_ceil != g["w_ceil"])[0].tolist()}
    if stream:
        chunks = list(rt.synthesize_stream_incremental(
            ids, seed=seed, chunk_frames=int(g["chunk_frames"])))
        starts = [c.start_sample_index for c in chunks]
        row["chunks"] = len(chunks)
        if starts != g["starts"].tolist():
            return {**row, "w_ceil_equal": True, "max_abs_err": None, "ok": False,
                    "starts": starts}
        audio = np.concatenate([c.samples for c in chunks])
    else:
        audio = rt.synthesize(ids, seed=seed)
    want = g["audio"]
    err = float(np.abs(audio - want).max()) if audio.shape == want.shape else None
    return {**row, "w_ceil_equal": True, "frames": int(g["w_ceil"].sum()),
            "samples": int(want.shape[0]), "max_abs_err": err,
            "ok": err is not None and err <= atol}


def check_seeded(rt, quality: str, factor: int, stream: bool = False) -> dict:
    """compare_seeded(), raising AssertionError unless the row is ok."""
    row = compare_seeded(rt, quality, factor, stream)
    if not row["ok"]:
        raise AssertionError(f"seeded golden {quality} f={factor} stream={stream}: {row}")
    return row
