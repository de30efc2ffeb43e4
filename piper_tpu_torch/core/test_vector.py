"""Recorded test-vector schema (reference: PiperTestVector.swift:3-52).

A test summary JSON bundles phoneme-ID inputs, synthesis metadata, paths to
recorded audio, and — crucially for bit-exact comparison — paths to recorded
RNG tensors (`random_files`) that get injected in place of live sampling
(the analog of GraphExecutor.swift:101-104's `overrides`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

# The canonical 14-id smoke phrase (BOS, interleaved phonemes/blanks, EOS)
# used by every bench, prewarm, calibration, and test fixture in the repo.
# One definition: benches, the serving calibrator, and the prewarm paths
# must all measure the SAME phrase or calibration silently drifts from
# what the benches report. Mirrors the reference's recorded-vector phrase
# (bench/fixtures/test_summary.json).
FIXTURE_PHONEME_IDS = [1, 20, 0, 120, 0, 61, 0, 24, 0, 59, 0, 100, 0, 2]


@dataclass(frozen=True)
class TestVectorMetadata:
    inference_time_sec: float = 0.0
    audio_duration_sec: float = 0.0
    real_time_factor: float = 0.0
    num_samples: int = 0
    sample_rate: int = 22050
    input_length: int = 0
    noise_scale: float = 0.667
    length_scale: float = 1.0
    noise_w: float = 0.8
    speaker_id: Optional[int] = None
    raw_output_shape: List[int] = field(default_factory=list)


@dataclass(frozen=True)
class RandomFiles:
    """Paths to recorded RandomNormalLike tensors + their shapes.

    `dp` is the duration-predictor noise (shape [B, 2, P]); `main` is the
    prior noise added to m_p (shape [B, C, T_frames]).
    """

    dp_randomnormalike: str = ""
    main_randomnormalike: str = ""
    dp_shape: List[int] = field(default_factory=list)
    main_shape: List[int] = field(default_factory=list)

    def load_dp(self, base: Path) -> Optional[np.ndarray]:
        return _load_f32(base, self.dp_randomnormalike, self.dp_shape)

    def load_main(self, base: Path) -> Optional[np.ndarray]:
        return _load_f32(base, self.main_randomnormalike, self.main_shape)


def _load_f32(base: Path, rel: str, shape: List[int]) -> Optional[np.ndarray]:
    if not rel:
        return None
    p = (base / rel) if not Path(rel).is_absolute() else Path(rel)
    arr = np.fromfile(p, dtype="<f4")
    if shape:
        arr = arr.reshape(shape)
    return arr


@dataclass(frozen=True)
class TestVector:
    __test__ = False  # not a pytest class

    test_id: str
    phoneme_ids: List[int]
    metadata: TestVectorMetadata
    audio_files: Dict[str, str] = field(default_factory=dict)
    audio_stats: Dict[str, float] = field(default_factory=dict)
    random_files: Optional[RandomFiles] = None
    description: str = ""

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TestVector":
        md = d.get("metadata", {})
        metadata = TestVectorMetadata(
            inference_time_sec=float(md.get("inference_time_sec", 0) or 0),
            audio_duration_sec=float(md.get("audio_duration_sec", 0) or 0),
            real_time_factor=float(md.get("real_time_factor", 0) or 0),
            num_samples=int(md.get("num_samples", 0) or 0),
            sample_rate=int(md.get("sample_rate", 22050) or 22050),
            input_length=int(md.get("input_length", 0) or 0),
            noise_scale=float(md.get("noise_scale", 0.667)),
            length_scale=float(md.get("length_scale", 1.0)),
            noise_w=float(md.get("noise_w", 0.8)),
            speaker_id=md.get("speaker_id"),
            raw_output_shape=list(md.get("raw_output_shape", []) or []),
        )
        random_files = None
        rf = d.get("random_files")
        if isinstance(rf, dict):
            random_files = RandomFiles(
                dp_randomnormalike=rf.get("dp_randomnormalike", "") or "",
                main_randomnormalike=rf.get("main_randomnormalike", "") or "",
                dp_shape=list(rf.get("dp_shape", []) or []),
                main_shape=list(rf.get("main_shape", []) or []),
            )
        return TestVector(
            test_id=str(d.get("test_id", "")),
            phoneme_ids=[int(x) for x in d.get("phoneme_ids", [])],
            metadata=metadata,
            audio_files=dict(d.get("audio_files", {}) or {}),
            audio_stats=dict(d.get("audio_stats", {}) or {}),
            random_files=random_files,
            description=str(d.get("description", "")),
        )


@dataclass(frozen=True)
class TestSummary:
    __test__ = False  # not a pytest class

    model_path: str
    config_path: str
    num_tests: int
    results: List[TestVector]
    base_dir: Path = Path(".")

    @staticmethod
    def load(path: str | Path) -> "TestSummary":
        path = Path(path)
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        results = [TestVector.from_dict(r) for r in d.get("results", [])]
        return TestSummary(
            model_path=str(d.get("model_path", "")),
            config_path=str(d.get("config_path", "")),
            num_tests=int(d.get("num_tests", len(results))),
            results=results,
            base_dir=path.parent,
        )
