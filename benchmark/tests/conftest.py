"""Fixtures of the benchmark's own tests: a tiny voice and small mixes on
the CPU, found through the same by-name lookups the harness uses."""

from __future__ import annotations

import pytest

TINY_HP = {
    "n_vocab": 256, "inter_channels": 32, "hidden_channels": 32, "filter_channels": 64,
    "n_heads": 2, "n_layers": 2, "kernel_size": 3, "window_size": 4,
    "dp_filter_channels": 32, "dp_kernel_size": 3, "dp_n_flows": 4, "dp_num_bins": 10,
    "dp_tail_bound": 5.0, "flow_n_flows": 2, "flow_hidden_channels": 32, "flow_kernel_size": 5,
    "flow_dilation_rate": 1, "flow_n_layers": 2, "resblock": "1", "resblock_kernel_sizes": [3],
    "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [8, 4],
    "upsample_initial_channel": 64, "upsample_kernel_sizes": [16, 8], "n_speakers": 1,
    "gin_channels": 0, "sample_rate": 16000,
}
TINY = {"name": "tiny", "pace_seed": 1, "hparams": TINY_HP,
        "inference": {"noise_scale": 0.667, "length_scale": 1.0, "noise_w": 0.8},
        "runtime": {"precision": "highest", "vocoder_precision": "high",
                    "flow_precision": "high", "mode": "fused", "output_dtype": "int16"}}
MIXES = {
    "offline": {"loop": "offline", "rows": 16, "classes": [[1, 0.5], [2, 0.5]], "block": 4,
                "content_seed": 3, "ahead": 3, "pipeline": {"num_fetchers": 1}},
    "served": {"loop": "served", "rate": 20.0, "length_mix": [[1, 0.6], [2, 0.4]],
               "server": {"max_batch": 4, "max_wait_ms": 10}, "lead_in_s": 0.3,
               "judge_rows": 12, "noise_seed": 5},
}


@pytest.fixture
def tiny_cells(monkeypatch):
    """Cells tiny.offline and tiny.served on the tiny voice; returns (spec,
    cells)."""
    from benchmark.core import spec as specs

    monkeypatch.setattr(specs, "config", lambda name: TINY)
    monkeypatch.setattr(specs, "mix", lambda name: MIXES[name])
    monkeypatch.setattr(specs, "limits", lambda name: {"frames_off": 0, "audio_gap": 0.002})
    spec = specs.load()
    cells = {k: {"name": f"tiny.{k}", "config": "tiny", "traffic": k, "chips": 1} for k in MIXES}
    spec["workloads"] = spec["workloads"] + list(cells.values())
    return spec, cells
