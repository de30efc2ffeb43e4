"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in `piper_tpu_torch/csrc/` are compiled at first use into
`build/piper_tpu_torch/` beside the package, under a name keyed by a hash of
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. Each source compiles in its own nvcc process, all started at once,
and the objects are linked into one library. The library has a plain C
interface: pointers and the stream are passed as integers, so no PyTorch
header is compiled (seconds, not minutes). Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "piper_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    nvcc = _nvcc()
    tag = f"{out.name}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objs = [out.with_name(f"{tag}.{s.stem}.o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    log = "".join(proc.communicate()[0] for proc in procs)
    try:
        failed = [s.name for s, proc in zip(sources, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = out.with_name(f"{tag}.tmp")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
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
    # Each entry ends in (..., tier, [bf16_io,] device, stream); the
    # ResBlock1 entries take (tile, ring, group) before the slope, K1's
    # (warpgroups, ring, chunk) after the tier.
    lib.piper_resblock1_branch.argtypes = [
        p, p, p, p, p, i, i, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
    lib.piper_resblock1_mrf.argtypes = [
        p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
    lib.piper_resblock1_mrf_folded.argtypes = [
        p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, p]
    lib.piper_conv1d_same.argtypes = [p, p, p, p, i, p, i, i, i, i, i, i, f, i, i, i, i, i, i,
                                      p]
    # (y, out, B, r, c, q, device, stream): no tier, a permutation.
    lib.piper_interleave.argtypes = [p, p, i, i, i, i, i, p]
    # (out, rows, n, width, seeds, host seed, per_row, stream, frames, kind,
    # device, cuda stream): the seeded draw (ops/kernels/prng.py).
    u = ctypes.c_uint
    lib.piper_threefry_normal.argtypes = [p, i, i, i, p, u, i, u, p, i, i, p]
    for fn in (lib.piper_resblock1_branch, lib.piper_resblock1_mrf,
               lib.piper_resblock1_mrf_folded, lib.piper_conv1d_same, lib.piper_interleave,
               lib.piper_threefry_normal):
        fn.restype = i
    _lib = lib
    return lib


def _demangle(names):
    """The names demangled by cu++filt or c++filt where one is found, else
    as they are."""
    for tool in ("cu++filt", "c++filt"):
        path = shutil.which(tool) or (str(Path("/usr/local/cuda/bin") / tool)
                                      if (Path("/usr/local/cuda/bin") / tool).exists() else None)
        if path:
            done = subprocess.run([path], input="\n".join(names), capture_output=True, text=True)
            out = done.stdout.splitlines()
            if done.returncode == 0 and len(out) == len(names):
                return out
    return list(names)


def ptxas_report(log: str, symbol: str = "") -> list:
    """Per kernel whose (mangled or demangled) name holds `symbol`, what
    nvcc's -Xptxas -v said of it: registers, spill stores and loads, stack
    frame and static shared bytes, and any ptxas warning or performance
    note that names it (wgmma serialised, for one). One dict per entry
    function, in the log's order."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": None,
                   "spill_loads": None, "stack": None, "smem": 0, "warnings": []}
            rows.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = next((r for r in rows if r["kernel"] == m.group(1)), None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    for line in log.splitlines():  # e.g. ptxas's "wgmma ... serialized" notes
        if "warning" in line.lower() or "Performance Loss" in line:
            for row in rows:
                if row["kernel"] in line:
                    row["warnings"].append(line.strip())
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return [r for r in rows if symbol in r["kernel"]]


def sass_ops(library: Path, symbol: str = "", ops=("HGMMA", "HMMA")) -> dict:
    """{kernel: {op: count}}: per kernel of the built library whose
    demangled name holds `symbol`, how many instructions of each SASS
    opcode in `ops` its machine code holds (cuobjdump -sass; HGMMA is
    wgmma, HMMA mma.sync). Raises where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    names, counts, cur = [], [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            names.append(m.group(1))
            cur = dict.fromkeys(ops, 0)
            counts.append(cur)
        elif cur is not None:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    cur[op] += 1
    return {name: c for name, c in zip(_demangle(names), counts) if symbol in name}


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = lib.piper_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
