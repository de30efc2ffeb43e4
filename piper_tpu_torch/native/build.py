"""Build helper for the native library (g++; no external dependencies).

Counterpart of piper_tpu.native.build. The shared object is compiled at
first use into `build/piper_tpu_torch/` beside the package (the directory
the CUDA kernels build into), under a name keyed by a hash of the sources,
so an edit rebuilds and an unchanged tree reuses the library; the checkout's
sources are never written beside. The compile goes to a temporary name and
is renamed into place, so concurrent first uses do not see a half-written
library. A build that fails raises with the compiler's output: there is no
silent fallback to another loader.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "piper_tpu_torch"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
COMPILER = "g++"


class NativeBuildError(RuntimeError):
    """The native library could not be built."""


def library_path(sources: Sequence[str], name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in sources:
        h.update((SRC_DIR / s).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_library(sources: Sequence[str], name: str) -> Path:
    """Compile `sources` (beside this module) into a cached .so unless it
    exists; returns its path. Raises NativeBuildError when the compiler is
    missing, times out or fails."""
    out = library_path(sources, name)
    if out.exists():
        return out
    compiler = shutil.which(COMPILER)
    if compiler is None:
        raise NativeBuildError(f"{COMPILER} not found: the native ONNX parser is built "
                               f"with a C++17 compiler on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *FLAGS, *[str(SRC_DIR / s) for s in sources], "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        raise NativeBuildError(f"{COMPILER} timed out building {name}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{COMPILER} failed building {name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out
