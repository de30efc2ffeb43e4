"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in `piper_tpu_torch/csrc/` are compiled at first use into
`build/piper_tpu_torch/` beside the package, under a name keyed by a hash of
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. The library has a plain C interface: pointers and the stream are
passed as integers, so no PyTorch header is compiled (seconds, not minutes).
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "piper_tpu_torch"
# -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libpiper_tpu_torch-{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the kernels unless a library for these sources exists.
    Returns (library path, compiler output; '' when it already existed).
    Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, log


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call and loaded once."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.piper_cuda_error_string.argtypes = [i]
    lib.piper_cuda_error_string.restype = ctypes.c_char_p
    lib.piper_resblock1_branch.argtypes = [
        p, p, p, p, p, i, i, p, p, p, i, i, i, i, f, i, p]
    lib.piper_resblock1_branch.restype = i
    lib.piper_resblock1_mrf.argtypes = [
        p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.piper_resblock1_mrf.restype = i
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = lib.piper_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
