"""Device mesh for multi-slot serving (counterpart of piper_tpu.parallel.mesh).

One process and one controller, as in JAX: a Mesh is a grid of slots with
the axes (dp, sp, tp, pp), each slot a torch.device. A device may be named
more than once: those are virtual slots of one device, the counterpart of
the JAX tests' virtual CPU devices (the CPU in the tests, the one card of a
one-card machine). torch.distributed is not used: its DeviceMesh wants a
process per rank, which the JAX design does not have.

On the card each slot queues its work on a CUDA stream of its own, so the
slots of one card overlap as the devices of a slice do. `run_slots` runs a
piece of work per slot: every slot's stream first waits for the work
already queued on the current stream (its inputs), and the current stream
then waits for every slot's, so the caller sees the results in order. The
kernel wrappers' launches made inside a slot's work are added to
`Mesh.slot_launches`, one count per slot.

`replicated` and `batch_sharded` are the two placements: a copy of a tensor
on every slot (slots of one device share the copy) and its rows split over
dp (shard g on the device of dp group g's first slot).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "dp"
SEQ_AXIS = "sp"
TENSOR_AXIS = "tp"
PIPE_AXIS = "pp"
AXES = (DATA_AXIS, SEQ_AXIS, TENSOR_AXIS, PIPE_AXIS)


class Mesh:
    """A (dp, sp, tp, pp) grid of slots; `devices` is the object array of
    their torch.devices, `shape` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in devices.shape)))
        self._streams: dict = {}
        self.slot_launches = [collections.Counter() for _ in range(devices.size)]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def index(self, dp: int = 0, sp: int = 0, tp: int = 0, pp: int = 0) -> int:
        """The flat slot index of a position on the grid."""
        return int(np.ravel_multi_index((dp, sp, tp, pp), self.devices.shape))

    def coords(self, slot: int) -> tuple:
        """(dp, sp, tp, pp) of a flat slot index."""
        return tuple(int(i) for i in np.unravel_index(slot, self.devices.shape))

    def device(self, slot: int) -> torch.device:
        return self.devices.flat[slot]

    def stream(self, slot: int) -> Optional["torch.cuda.Stream"]:
        """The slot's CUDA stream, made at first use; None on the CPU."""
        dev = self.device(slot)
        if dev.type != "cuda":
            return None
        s = self._streams.get(slot)
        if s is None:
            s = self._streams[slot] = torch.cuda.Stream(device=dev)
        return s

    def reset_launches(self) -> None:
        for c in self.slot_launches:
            c.clear()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    seq_parallel: int = 1,
    tensor_parallel: int = 1,
    pipeline_parallel: int = 1,
) -> Mesh:
    """Build a (dp, sp, tp, pp) mesh. dp shards utterance batches; sp
    shards the frame axis of very long outputs; tp shards the vocoder and
    flow channel axes (parallel/tp.py); pp pipelines the decode stage by
    stage (parallel/pp.py). pp is the innermost axis, as in JAX.

    `devices` defaults to every CUDA device; entries may repeat (virtual
    slots), e.g. ["cpu"] * 8 or ["cuda:0"] * 2."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=, e.g. ['cpu'] * 8 for "
                               "eight virtual CPU slots")
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    inner = seq_parallel * tensor_parallel * pipeline_parallel
    if n_devices % inner != 0:
        raise ValueError(
            f"n_devices {n_devices} not divisible by seq_parallel "
            f"{seq_parallel} * tensor_parallel {tensor_parallel} * "
            f"pipeline_parallel {pipeline_parallel}"
        )
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_devices // inner, seq_parallel, tensor_parallel,
                             pipeline_parallel))


def replicated(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """A copy of `x` on every slot, in flat slot order; the slots of one
    device share one copy (x itself where it already lies there)."""
    copies: dict = {}
    out = []
    for dev in mesh.devices.flat:
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return out


def batch_sharded(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Axis 0 (batch) of `x` split over dp: shard g on dp group g's first
    slot's device."""
    dp = mesh.shape[DATA_AXIS]
    if x.shape[0] % dp != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp mesh size {dp}")
    rows = x.shape[0] // dp
    return [x[g * rows:(g + 1) * rows].to(mesh.device(mesh.index(dp=g))) for g in range(dp)]


def cat_rows(parts: Sequence, device):
    """Row-concatenate per-group results on `device`: tensors, and tuples
    and dataclasses of them (an EncodeResult; None fields stay None). One
    part is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: cat_rows([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(first)})
    return type(first)(cat_rows(list(col), device) for col in zip(*parts))


def slice_rows(x, lo: int, hi: int, device):
    """Rows [lo, hi) on `device` of a tensor, or of the tensors of a tuple
    or dataclass; the whole of a tensor already there comes back as it is,
    and anything else (a float, None, a 0-d tensor) unchanged."""
    if isinstance(x, torch.Tensor):
        if x.ndim == 0 or (lo == 0 and hi == x.shape[0] and x.device == device):
            return x
        return x[lo:hi].to(device)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: slice_rows(getattr(x, f.name), lo, hi, device)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(slice_rows(v, lo, hi, device) for v in x)
    return x


def _launch_counts() -> dict:
    from piper_tpu_torch.ops.kernels import conv, folded, interleave, resblock

    return {"conv1d_same": conv.conv1d_same.launches,
            "resblock1_branch": resblock.resblock1_branch.launches,
            "resblock1_mrf": resblock.resblock1_mrf.launches,
            "resblock1_mrf_folded": folded.resblock1_mrf_folded.launches,
            "interleave": interleave.interleave.launches}


def count_launches(mesh: Mesh, slot: int, before: dict) -> None:
    """Add the launches made since `before` (_launch_counts()) to the slot."""
    after = _launch_counts()
    for name, n in after.items():
        if n != before[name]:
            mesh.slot_launches[slot][name] += n - before[name]


def run_slots(mesh: Mesh, slots: Sequence[int], fn: Callable[[int], object]) -> list:
    """fn(k) for each slot k of `slots`, each on its slot's stream: every
    stream starts after the work queued so far on the current stream of
    the first slot's device, and that stream waits for every slot's work
    before anything queued after this call. Returns the results in order.
    On the CPU the calls simply run in turn."""
    cur = None
    dev0 = mesh.device(slots[0])
    if dev0.type == "cuda":
        cur = torch.cuda.current_stream(dev0)
        for i in slots:
            mesh.stream(i).wait_stream(cur)
    outs = []
    for k, i in enumerate(slots):
        before = _launch_counts()
        if cur is None:
            outs.append(fn(k))
        else:
            with torch.cuda.stream(mesh.stream(i)):
                outs.append(fn(k))
        count_launches(mesh, i, before)
    if cur is not None:
        for i in slots:
            cur.wait_stream(mesh.stream(i))
    return outs
