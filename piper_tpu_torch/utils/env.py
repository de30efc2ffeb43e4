"""PIPER_TPU_* environment flags, read in one place (the port's copy of the
jax-free part of piper_tpu.utils.env: the same names and functions; the
JAX platform override has no counterpart here, `--device` takes its place).

| Flag                    | Effect                                              |
|-------------------------|-----------------------------------------------------|
| PIPER_TPU_CACHE         | cache root for voices/synthetic checkpoints         |
| PIPER_TPU_PROFILE       | =1 dumps a per-stage timing table to stderr at exit |
| PIPER_TPU_TRACE         | =1 logs each synthesis stage (bucket, ms) to stderr |
| PIPER_TPU_PRECISION     | override the default precision tier                 |
| PIPER_TPU_VOCODER_PRECISION | vocoder-only tier or comma-list per upsample level |
| PIPER_TPU_FLOW_PRECISION | decode-flow-only tier (encoder stays fp32)         |
| PIPER_TPU_MODE          | override execution mode: split | fused              |
| PIPER_TPU_NO_PALLAS     | =1 runs no kernel: PyTorch's convs, as use_pallas=False |
| PIPER_TPU_FUSE_MRF      | =1/=0 force whole-MRF fusion on/off (default: ch<=32 levels only) |

`RuntimeOptions.from_env()` reads the precision and mode flags; `PiperRuntime`
reads PIPER_TPU_NO_PALLAS when it is made, and the vocoder's `_level`
(models/vits/hifigan.py) PIPER_TPU_FUSE_MRF at every level.
"""

from __future__ import annotations

import os


def flag(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def flag_bool(name: str) -> bool:
    return os.environ.get(name) == "1"


def cache_root() -> str:
    from pathlib import Path

    return os.environ.get("PIPER_TPU_CACHE", str(Path.home() / ".cache" / "piper-tpu"))


def profile_enabled() -> bool:
    return flag_bool("PIPER_TPU_PROFILE")


def trace_enabled() -> bool:
    return flag_bool("PIPER_TPU_TRACE")
