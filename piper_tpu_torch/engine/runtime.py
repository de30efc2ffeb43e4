"""PiperRuntime: load a Piper voice and synthesize utterances, one or a batch.

Counterpart of piper_tpu.engine.runtime for single- and multi-speaker
voices on one device: the CUDA card unless the caller asks for the CPU
(`device="cpu"`); weights go to it once.

- Split mode: pad the phoneme ids to a bucket (and a batch's rows to the
  `batch_buckets` ladder), encode, read the frame counts on the host once,
  pick the frame bucket, decode, and copy the PCM to the host.
- Fused mode (one utterance): encode and decode with no host read between
  them, at the heuristic frame budget max(32, len * fused_frames_per_phoneme)
  rounded up to a frame bucket, then one host copy of (audio, y_len,
  y_total). A run whose durations overflow the budget is redone exactly in
  split mode. Blocking batches take the split path, as in the JAX package.
- dispatch/fetch: `dispatch_fused` and `dispatch_batch` queue the work and
  the audio's copy to pinned host memory behind it and return at once (split
  mode reads only the frame counts); `fetch_fused` and `fetch_batch` wait for
  the copy's event and slice each row. `dispatch_batch(fused=True)` runs a
  whole group the fused way, its rows and frame budget pinned by the caller
  (`pad_rows_to`, `budget_frames`), with no host read at all; rows that
  overflow are redone at fetch. `engine/pipeline.py` builds the serving
  pipeline on them, `engine/batcher.py` the continuous batcher.
- Serving contracts: `hbm_bytes()` (the weights' bytes on the device),
  `close()`/`closed` (drop the weights; later synthesis raises), `prewarm()`
  (pay first-run costs ahead of traffic), `RuntimeOptions.from_env()` and
  `load_voice(voice_id)` (a voice of the bundled index, fetched and cached
  by `core/voices.py`), and `profiler` (utils/profiling.py: host wall ms per
  (stage, bucket) where the JAX runtime records them; PIPER_TPU_PROFILE=1
  prints the table at exit).
- Duration controls: `phoneme_durations` runs the encoder only and returns
  each phoneme's frames; `synthesize_with_alignment` adds their sample
  spans to the audio (`core/alignment.py`); `synthesize_forced` and
  `synthesize_batch_forced` decode the caller's frame plan with no host
  read (encode_forced, then decode at the plan's frame bucket).
- Speakers: a multi-speaker voice takes speaker ids (`speaker_index`
  resolves names through the voice's speaker_id_map) or mixes
  {id: weight} (`resolve_speaker_mix`) on every entry point. Ids and
  mixes are validated on the host before any device work: an
  out-of-range index on the card is a device-side assert that would end
  the process's CUDA context (JAX clamps instead).
- Streaming: `synthesize_stream` chunks a full synthesis, or with
  incremental=True decodes frame windows haloed by the decode stack's
  receptive field (`synthesize_stream_incremental`), so the first audio
  comes after one small window. Seeded streams run a fused head (encode and
  window 0 with no host read) and dispatch window 1 on the device-held
  frame count before window 0's audio is fetched; every window k+1 is
  queued before window k is fetched. `dispatch_stream_head`,
  `dispatch_stream_head_batch` and `dispatch_window_batch` are the same
  pieces without the generator, for a server that batches streams.

Meshes: `mesh=` (parallel/mesh.py, a grid of slots, virtual slots of one
device allowed) places the weights on every slot (channel shards under
`tp`, parallel/tp.py) and splits every batched call's rows over the `dp`
groups, each on its slot's CUDA stream (`_on_groups`); the batch ladder
keeps dp-divisible rungs, and streams and injected-noise calls run whole
on the first group. `use_pallas=False` runs PyTorch's convs in place of
the kernels (the tp forward over one slot), as JAX's option does, and so
does PIPER_TPU_NO_PALLAS=1 (read when the runtime is made).

Encode and decode run at the `precision` tier (by default "highest", fp32
with TF32 off for matmuls and cuDNN convs: a duration error can flip a
ceil() and shift the whole waveform); the reverse flows and the vocoder may
take lower tiers of their own, as in the JAX package (`precision.py` says
what each tier means in the kernels and around them). precision
"bfloat16" is the JAX package's capacity tier: the weights are uploaded in
bf16 and every activation is bf16 end to end; the vocoder's kernels run at
"default" on bf16 activations (K1-K3 take them as they are), the card's
flags are "default"'s, and the PCM comes back as float32 (or int16). Its
durations may round differently from fp32 and the waveform diverges
audibly: for capacity, never for fidelity. The tiers are
process-wide flags, so every piece of a runtime's device work runs under
its lock (`_lock`, reentrant); a fetch only waits for its copy.

Seeded noise is the JAX package's: JAX's threefry-2x32 draws
(`ops/kernels/prng.py`; on the card one kernel launch a draw), normal(
fold_in(PRNGKey(seed), 0), (2, P)) for the duration predictor and normal(
fold_in(PRNGKey(seed), 1), (C, F)) for the prior, so a seed gives JAX's
durations and audio. Each is one per-row draw broadcast over the rows, so
a row's noise does not depend on what is batched beside it. The prior's
draw has the frame bucket's width, so fused and split runs of one
utterance share a realization only where their buckets agree (the JAX
package's caveat too); a forced plan decodes at the bucket split mode
picks for the same total, so forcing the predicted plan reproduces split
mode's audio. A stream's prior noise is per_frame_noise's instead, a
function of (seed, absolute frame): a seeded stream is deterministic but
not synthesize()'s realization (as in the JAX package); a streaming head's
rows draw their duration noise each from its own seed.

Eager PyTorch compiles nothing. `RunTimings.compiled` marks the first run
of a (kind, rows, bucket, speaker kind) key, as the JAX package marks a
compile: on the card that run pays cuDNN's per-shape heuristics and the
caching allocator's growth (~100 ms), so warm-ups must use the shapes they
time.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from piper_tpu_torch.core.alignment import PhonemeAlignment, make_alignment
from piper_tpu_torch.core.audio import AudioChunk, AudioFormat
from piper_tpu_torch.core.config import VoiceConfig
from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
from piper_tpu_torch.engine.bucketing import (
    DEFAULT_FRAME_BUCKETS,
    DEFAULT_PHONEME_BUCKETS,
    BucketOverflowError,
    bucket_for,
    pad_to,
)
from piper_tpu_torch.models.vits import model as vits
from piper_tpu_torch.models.vits.hparams import (VitsHParams, derive_hparams,
                                                  receptive_field_frames)
from piper_tpu_torch.models.vits.params import host_arrays_from_graph, params_to_torch
from piper_tpu_torch.onnx.loader import load_model
from piper_tpu_torch.ops.kernels import prng
from piper_tpu_torch.ops.kernels.precision import TIERS, kernel_tier, tier_scope
from piper_tpu_torch.parallel.mesh import cat_rows, slice_rows
from piper_tpu_torch.utils.env import flag_bool, profile_enabled
from piper_tpu_torch.utils.profiling import Profiler

MODES = ("split", "fused")


def parse_precision_spec(spec):
    """Parse a precision-tier spec string, the grammar of the JAX package's
    parse_precision_spec: 'none'/'' -> None (inherit), a single tier name,
    or a comma list of per-level tiers with 'none'/'' items meaning 'inherit'
    for that level. Whitespace around items is ignored."""
    if spec is None:
        return None
    spec = spec.strip()
    if spec in ("", "none"):
        return None
    parts = [t.strip() for t in spec.split(",")]
    if len(parts) == 1:
        return parts[0]
    return tuple(None if t in ("", "none") else t for t in parts)


@dataclass(frozen=True)
class RuntimeOptions:
    """The knobs of piper_tpu's RuntimeOptions that the port carries.

    `precision` is the tier of encode and decode: "highest", "high" or
    "default", or "bfloat16" (bf16 weights and activations end to end; its
    vocoder and flow tiers may only be None or "default"/"bfloat16", the
    one tier of products bf16 activations carry). `vocoder_precision` is
    None (inherit), one tier, or one entry
    per upsample level (None entries run that level's kernels at "highest"
    and its PyTorch convs at the outer tier, as in JAX); `flow_precision` is
    None or one tier. `mode` is "split" or "fused" (the module docstring);
    `fused_frames_per_phoneme` sets fused mode's frame budget. Batched calls
    pad the row axis up to the next `batch_buckets` rung (dummy rows copy row
    0; their outputs are dropped). Values that are not ported yet raise,
    naming the later change that brings them."""

    seed: int = 1234
    precision: str = "highest"
    vocoder_precision: Union[str, Tuple[Optional[str], ...], None] = None
    flow_precision: Optional[str] = None
    mode: str = "split"
    fused_frames_per_phoneme: int = 6
    phoneme_buckets: Tuple[int, ...] = tuple(DEFAULT_PHONEME_BUCKETS)
    frame_buckets: Tuple[int, ...] = tuple(DEFAULT_FRAME_BUCKETS)
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128)
    output_dtype: str = "float32"  # or "int16": clip * 32767, cast on the device
    # None/True: the vocoder's kernels; False: PyTorch's convs throughout
    # (the tp forward's plain path). A tp mesh refuses True.
    use_pallas: Optional[bool] = None

    @staticmethod
    def from_env() -> "RuntimeOptions":
        """Default options with PIPER_TPU_PRECISION, PIPER_TPU_MODE,
        PIPER_TPU_VOCODER_PRECISION and PIPER_TPU_FLOW_PRECISION applied,
        read as the JAX package reads them; validated, so a value the port
        does not carry raises here."""
        from piper_tpu_torch.utils.env import flag

        kwargs = {}
        if flag("PIPER_TPU_PRECISION"):
            kwargs["precision"] = flag("PIPER_TPU_PRECISION")
        if flag("PIPER_TPU_MODE"):
            kwargs["mode"] = flag("PIPER_TPU_MODE")
        vp = flag("PIPER_TPU_VOCODER_PRECISION")
        if vp:
            kwargs["vocoder_precision"] = parse_precision_spec(vp)
        fp = flag("PIPER_TPU_FLOW_PRECISION")
        if fp:
            kwargs["flow_precision"] = parse_precision_spec(fp)
        options = RuntimeOptions(**kwargs)
        options.validate()
        return options

    def validate(self) -> None:
        if self.precision not in TIERS + ("bfloat16",):
            raise ValueError(f"precision {self.precision!r}: the tiers are {TIERS} and "
                             f"'bfloat16'")
        vp = self.vocoder_precision
        stages = [("vocoder_precision", t)
                  for t in (vp if isinstance(vp, (tuple, list)) else (vp,))]
        for what, tier in stages + [("flow_precision", self.flow_precision)]:
            name = kernel_tier(tier, what)
            if self.precision == "bfloat16" and tier is not None and name != "default":
                raise ValueError(f"{what} {tier!r} under precision 'bfloat16': bf16 "
                                 f"activations carry one bf16 product per pair, the "
                                 f"'default' tier; give None, 'default' or 'bfloat16'")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: the modes are {MODES}")
        if self.output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be 'float32' or 'int16', "
                             f"got {self.output_dtype!r}")


@dataclass
class RunTimings:
    """Per-run accounting (host clock; every run ends in a host copy)."""

    wall_ms: float = 0.0
    encode_ms: float = 0.0
    decode_ms: float = 0.0
    phoneme_bucket: int = 0
    frame_bucket: int = 0
    frames: int = 0  # summed over the rows
    samples: int = 0  # summed over the rows
    compiled: bool = False  # the first run of one of its (kind, rows, bucket) keys
    compile_count: int = 0  # keys seen so far
    rtf: float = 0.0  # real-time factor (audio seconds per wall second)


def seeded_noise(seed: int, stream: int, shape: Tuple[int, ...], rows: int,
                 device) -> torch.Tensor:
    """JAX's normal(fold_in(PRNGKey(seed), stream), shape) in fp32,
    broadcast to (rows, *shape): one draw (one kernel launch on the card)."""
    draw = prng.threefry_normal(_seed_u32(seed), stream, 1, math.prod(shape),
                                device=torch.device(device))
    return draw.view(shape).expand(rows, *shape)


def _seed_u32(seed) -> int:
    """Any Python int -> uint32 range; negative seeds wrap mod 2**32."""
    return int(seed) & 0xFFFFFFFF


def _padded(src: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Injected noise zero-padded (or cut) along its last axis to `shape`."""
    out = np.zeros(shape, np.float32)
    width = min(shape[-1], src.shape[-1])
    out[..., :width] = src[..., :width]
    return out


class _HostCopy:
    """Device tensors copied to the host behind the work that makes them.
    On a CUDA device each goes into pinned memory with non_blocking=True and
    an event is recorded after the copies; `wait()` blocks on the event
    (the thread sleeps, it does not spin) and returns numpy arrays. The
    device tensors stay referenced until then. On the CPU there is nothing
    to copy."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._src = tuple(tensors)
        self._event = None
        if self._src[0].device.type != "cuda":
            self._host = self._src
            return
        self._host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                           for t in self._src)
        for h, t in zip(self._host, self._src):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event(blocking=True)
        self._event.record()

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        self._src = ()
        return [h.numpy() for h in self._host]


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    return dev


def resolve_speaker(spec, n_speakers: int, speaker_id_map=None) -> int:
    """Speaker reference -> validated integer id. Integers (and digit
    strings) pass through; other strings look up the voice's
    speaker_id_map by name. The map wins over integer parsing: real voices
    (libritts exports) use numeric reader ids such as "3922" as names of
    small indices."""
    if isinstance(spec, bool):
        raise ValueError(f"speaker {spec!r} is not an id or name")
    if isinstance(spec, (int, np.integer)):
        sid = int(spec)
    elif isinstance(spec, str):
        s = spec.strip()
        m = speaker_id_map or {}
        if s in m:
            sid = int(m[s])
        else:
            try:
                sid = int(s)
            except ValueError:
                known = ", ".join(sorted(m)[:10]) if m else "none defined"
                raise ValueError(
                    f"unknown speaker {spec!r} (known names: {known})")
    else:
        raise ValueError(f"speaker {spec!r} is not an id or name")
    if not 0 <= sid < max(1, n_speakers):
        raise ValueError(
            f"speaker_id {sid} out of range [0, {max(1, n_speakers)})")
    return sid


def parse_mix_spec(spec: str) -> dict:
    """'k:w,k:w' -> {key: weight}, the grammar of textual mix specs. Keys
    become ints when they parse, otherwise stay names for
    resolve_speaker_mix. Raises ValueError with the offending part."""
    raw: dict = {}
    for part in spec.split(","):
        bits = part.split(":")
        if len(bits) != 2 or not bits[0].strip():
            raise ValueError(
                f"bad mix entry {part!r} (use ID:WEIGHT or NAME:WEIGHT "
                f"pairs, e.g. '0:0.6,3:0.4')")
        key = bits[0].strip()
        try:
            key = int(key)
        except ValueError:
            pass  # a speaker name
        try:
            w = float(bits[1])
        except ValueError:
            raise ValueError(
                f"bad mix weight {bits[1]!r} in {part!r}") from None
        if key in raw:
            raise ValueError(f"mix names speaker {key} twice")
        raw[key] = w
    if not raw:
        raise ValueError("mix must name at least one speaker")
    return raw


def validate_scales(noise_scale: float, length_scale: float, noise_w: float) -> None:
    """length_scale must be finite and > 0 (it multiplies the durations:
    <= 0 gives zero or negative frame counts); the noise scales finite and
    >= 0."""
    if not (math.isfinite(length_scale) and length_scale > 0):
        raise ValueError(f"length_scale must be > 0, got {length_scale}")
    for name, v in (("noise_scale", noise_scale), ("noise_w", noise_w)):
        if not (math.isfinite(v) and v >= 0):
            raise ValueError(f"{name} must be finite and >= 0, got {v}")


def validate_speaker_mix(mix: dict, n_speakers: int, speaker_id=None) -> None:
    """Validation of a speaker mix {id: weight}: integral ids in range
    (bool and 1.5 are not ids), each once, finite weights, one of them
    non-zero; a request's `speaker_id` beside a mix is an error."""
    if speaker_id is not None:
        raise ValueError("pass speaker_id OR speaker_mix, not both")
    if n_speakers <= 1:
        raise ValueError("speaker_mix requires a multi-speaker voice")
    if not mix:
        raise ValueError("speaker_mix must not be empty")
    any_nonzero = False
    seen = set()
    for s, w in mix.items():
        if isinstance(s, bool) or not (
                isinstance(s, (int, np.integer))
                or (isinstance(s, float) and s.is_integer())):
            raise ValueError(
                f"speaker_mix id {s!r} is not an integer speaker id")
        s, w = int(s), float(w)
        if s in seen:
            raise ValueError(f"speaker_mix names speaker {s} twice")
        seen.add(s)
        if not 0 <= s < n_speakers:
            raise ValueError(
                f"speaker_mix id {s} out of range [0, {n_speakers})")
        if not math.isfinite(w):
            raise ValueError("speaker_mix weights must be finite")
        any_nonzero |= w != 0.0
    if not any_nonzero:
        raise ValueError("speaker_mix needs at least one non-zero weight")


class _Group:
    """One dp group of a runtime: the slot it runs on (None off a mesh),
    its device, the weights the encoder reads and the decode's stages."""

    __slots__ = ("slot", "device", "params", "stages")

    def __init__(self, slot, device, params, stages):
        self.slot, self.device, self.params, self.stages = slot, device, params, stages


class PiperRuntime:
    """Loads a Piper voice checkpoint and synthesizes speech on one device:
    the CUDA card by default (raises where there is none), or the CPU when
    the caller passes device="cpu"; or on a mesh of slots
    (parallel/mesh.py) when the caller passes mesh=."""

    def __init__(
        self,
        model_path: Union[str, Path],
        config_path: Union[str, Path, None] = None,
        options: Optional[RuntimeOptions] = None,
        *,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        """`mesh` (parallel.mesh.Mesh, optional) turns this runtime into a
        multi-slot one, as the JAX runtime's mesh does: the weights go to
        every slot (channel-sharded instead under a `tp` axis,
        parallel/tp.py), every batched call splits its rows over the `dp`
        axis, each dp group running on its slot's stream, and the batch
        ladder keeps dp-divisible rungs only, so the same serving stack
        (BatchingServer, ServingPipeline, bucketing, prewarm) drives the
        slots as it drives one device. Streams and injected-noise calls run
        whole on the first dp group (JAX runs them replicated). The device
        is the mesh's first slot's; a pp axis raises (ShardedVits.
        synthesize_pipelined serves it)."""
        self.options = options or RuntimeOptions()
        self.options.validate()
        # PIPER_TPU_NO_PALLAS=1 is use_pallas=False, ahead of the tp rule,
        # as the JAX runtime's _resolve_pallas reads it.
        self._no_kernels = self.options.use_pallas is False or flag_bool("PIPER_TPU_NO_PALLAS")
        self.mesh = mesh
        if mesh is not None:
            from piper_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS

            if DATA_AXIS not in mesh.axis_names:
                raise ValueError(f"mesh must have a '{DATA_AXIS}' axis (got {mesh.axis_names})")
            if int(mesh.shape.get(PIPE_AXIS, 1)) > 1:
                raise NotImplementedError(
                    "PiperRuntime serves dp/tp meshes; for pipeline "
                    "parallelism use parallel.serving.ShardedVits."
                    "synthesize_pipelined on a pipeline_parallel mesh")
            device = mesh.device(0)
        self.device = _resolve_device(device)
        self.model_path = Path(model_path)
        if not self.model_path.exists():
            raise FileNotFoundError(f"model checkpoint not found: {self.model_path}")
        self.config_path = Path(config_path) if config_path else Path(str(model_path) + ".json")
        self.config = VoiceConfig.load(self.config_path)
        graph = load_model(self.model_path).graph
        self.hparams: VitsHParams = derive_hparams(
            graph, sample_rate=self.config.audio.sample_rate,
            n_speakers=self.config.num_speakers)
        vp = self.options.vocoder_precision
        if isinstance(vp, (tuple, list)) and len(vp) != self.hparams.num_upsamples:
            raise ValueError(
                f"vocoder_precision has {len(vp)} per-level entries but this voice has "
                f"{self.hparams.num_upsamples} upsample levels: give one tier per level "
                f"(or a single tier name for all levels)")
        self._hbm_bytes: Optional[int] = None
        dtype = torch.bfloat16 if self.options.precision == "bfloat16" else torch.float32
        self._dp_size = self._tp_size = 1
        self._groups: List[_Group] = []
        if mesh is None:
            self.params = params_to_torch(host_arrays_from_graph(graph), self.device, dtype)
            if self._no_kernels:
                self._place_groups([self.params])
        else:
            self._place_on_mesh(params_to_torch(host_arrays_from_graph(graph), "cpu", dtype))
        self._compiled_keys: set = set()
        # Serializes device work (the tier flags are process-wide) and the
        # bookkeeping (_compiled_keys, last_run_timings) for threaded callers.
        self._lock = threading.RLock()
        self.last_run_timings: Optional[RunTimings] = None
        # Host wall time per (stage, bucket), as the JAX runtime records it;
        # PIPER_TPU_PROFILE=1 dumps the table at exit.
        self.profiler = Profiler()
        if profile_enabled():
            import atexit

            atexit.register(self._dump_profile)

    def _place_on_mesh(self, host: dict) -> None:
        """The weights on every slot (shards under tp) and the dp groups."""
        from piper_tpu_torch.parallel import tp
        from piper_tpu_torch.parallel.mesh import DATA_AXIS, TENSOR_AXIS

        mesh = self.mesh
        self._tp_size = int(mesh.shape.get(TENSOR_AXIS, 1))
        self._dp_size = int(mesh.shape[DATA_AXIS])
        # False under tp; raises on an explicit use_pallas=True there.
        if not self._no_kernels:
            tp.resolve_pallas_under_tp(self._tp_size, self.options.use_pallas)
        self._logical_bytes = sum(t.numel() * t.element_size() for t in host.values())
        slot_params = tp.place_params(host, mesh)
        self._specs = tp.param_specs(host, mesh)
        self.params = slot_params[0]
        self._place_groups(slot_params)

    def _place_groups(self, slot_params: list) -> None:
        """One _Group per dp group: the kernels' decode on a slot's weights,
        or the tp forward (under tp, or with use_pallas=False)."""
        from piper_tpu_torch.parallel import tp

        if self.mesh is None:  # use_pallas=False on one device
            from piper_tpu_torch.parallel.mesh import make_mesh

            mesh, specs = make_mesh(1, devices=[self.device]), {k: () for k in slot_params[0]}
        else:
            mesh, specs = self.mesh, self._specs
        plain = self._tp_size > 1 or self._no_kernels
        self._groups = []
        for d in range(self._dp_size):
            slot = mesh.index(dp=d)
            if plain:
                group = tp.TPGroup.of(mesh, slot_params, specs, dp=d)
                stages = vits.DecodeStages(group, tp.flow_reverse, tp.hifigan_generator)
            else:
                stages = vits.DecodeStages(slot_params[slot])
            self._groups.append(_Group(slot if self.mesh is not None else None,
                                       mesh.device(slot), slot_params[slot], stages))

    def _group(self, d: int = 0) -> _Group:
        """dp group d (off a mesh, the one device with the runtime's weights)."""
        if not self._groups:
            return _Group(None, self.device, self.params, vits.DecodeStages(self.params))
        self.params  # raises once closed  # noqa: B018
        return self._groups[d]

    def _on_groups(self, fn, rows: int, shard: bool = True):
        """fn(group, lo, hi) for rows [lo, hi) of each dp group, each on its
        slot's stream (mesh.run_slots), the results concatenated on the
        runtime's device. Off a mesh, or unsharded (`shard` False, or rows
        not divisible by dp), it is one call of the first group on the
        current stream."""
        dp = self._dp_size
        if self.mesh is None or dp == 1 or not shard or rows % dp:
            return fn(self._group(0), 0, rows)
        from piper_tpu_torch.parallel.mesh import run_slots

        per = rows // dp
        groups = [self._group(d) for d in range(dp)]
        outs = run_slots(self.mesh, [g.slot for g in groups],
                         lambda d: fn(groups[d], d * per, (d + 1) * per))
        return cat_rows(outs, self.device)

    def _dump_profile(self) -> None:
        if self.profiler.stats:
            print(f"\n[piper-tpu profile] {self.model_path.name}:", file=sys.stderr)
            self.profiler.dump()

    @classmethod
    def load_voice(
        cls,
        voice_id: str,
        options: Optional[RuntimeOptions] = None,
        manager=None,
        *,
        device: Union[str, torch.device] = "cuda",
    ) -> "PiperRuntime":
        """Download (or reuse cached) voice assets through a VoiceManager
        (core/voices.py) and load them on `device`; a missing card raises
        before anything is fetched."""
        from piper_tpu_torch.core.voices import VoiceManager

        _resolve_device(device)
        manager = manager or VoiceManager()
        model_path, config_path = manager.ensure_voice(voice_id)
        return cls(model_path, config_path, options, device=device)

    # -- lifecycle -------------------------------------------------------------

    @property
    def params(self) -> dict:
        """The weight tensors on the runtime's device. Every synthesis path
        reads them here, so a closed runtime fails at once with a
        RuntimeError instead of deep inside a call."""
        p = self._params
        if p is None:
            raise RuntimeError("PiperRuntime is closed: its weights were released "
                               "(PiperRuntime.close())")
        return p

    @params.setter
    def params(self, value: dict) -> None:
        self._params = value
        self._hbm_bytes = None

    def hbm_bytes(self) -> int:
        """Bytes of this voice's weight tensors on the runtime's device (on
        the card, its HBM; the JAX package's name), 0 once closed. Serving
        metrics report it per voice, so resident voices can be budgeted
        against the card's memory."""
        if self._hbm_bytes is None:
            if self.mesh is not None:
                # The logical size, as JAX reports a mesh's: a slot holds
                # it (or its tp shards), each device one copy per tp shard.
                self.params  # raises once closed  # noqa: B018
                self._hbm_bytes = self._logical_bytes
            else:
                self._hbm_bytes = sum(t.numel() * t.element_size()
                                      for t in self.params.values())
        return self._hbm_bytes

    @property
    def closed(self) -> bool:
        return self._params is None

    def close(self) -> None:
        """Release this voice's weights: the runtime drops its references to
        them, so the caching allocator takes their memory back (no queued
        copy, stream state or kernel layout keeps a weight alive). Further
        synthesis raises RuntimeError. Idempotent."""
        with self._lock:
            # hbm_bytes() reads without the lock: zero it before `closed`
            # turns True, so no reader sees a closed runtime's old bytes.
            self._hbm_bytes = 0
            self._params = None
            self._groups = []

    @property
    def sample_rate(self) -> int:
        return self.config.audio.sample_rate

    @property
    def batch_ladder(self) -> Tuple[int, ...]:
        """The batch-bucket ladder: on a mesh, only dp-divisible rungs
        (each dp group gets whole rows)."""
        ladder = self.options.batch_buckets
        if self._dp_size <= 1:
            return ladder
        return tuple(x for x in ladder if x % self._dp_size == 0) or (self._dp_size,)

    @property
    def np_output_dtype(self):
        return np.int16 if self.options.output_dtype == "int16" else np.float32

    @property
    def audio_format(self) -> AudioFormat:
        return AudioFormat(sample_rate=self.sample_rate)

    def _as_output(self, audio: torch.Tensor) -> torch.Tensor:
        """The waveform in the runtime's output dtype, on the device: int16
        is clip * 32767 cast there, so the host copy moves half the bytes;
        float32 PCM from the "bfloat16" mode's bf16 waveform too (int16 from
        its fp32 values)."""
        audio = audio.float()
        if self.options.output_dtype == "int16":
            return (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)
        return audio

    def _scales(self, noise_scale, length_scale, noise_w):
        inf = self.config.inference
        ns = inf.noise_scale if noise_scale is None else float(noise_scale)
        ls = inf.length_scale if length_scale is None else float(length_scale)
        nw = inf.noise_w if noise_w is None else float(noise_w)
        validate_scales(ns, ls, nw)
        return ns, ls, nw

    # -- speakers ----------------------------------------------------------------

    def speaker_index(self, spec) -> int:
        """Speaker name or id -> validated integer id, through the voice
        config's speaker_id_map (e.g. 'spk3' -> 3). The synthesis entry
        points take integer ids; callers that accept names resolve here."""
        return resolve_speaker(spec, self.hparams.n_speakers, self.config.speaker_id_map)

    def resolve_speaker_mix(self, mix: dict) -> dict:
        """{name_or_id: weight} -> {int_id: weight}: string keys resolve
        through speaker_index (the map wins for numeric names); two keys
        that resolve to one speaker raise, and so do bool and non-integral
        keys."""
        if not mix:
            raise ValueError("speaker_mix must not be empty")
        out = {}
        for k, w in mix.items():
            if isinstance(k, str):
                key = self.speaker_index(k)
            elif isinstance(k, bool) or not isinstance(k, (int, np.integer)):
                raise ValueError(f"speaker_mix key {k!r} is not a speaker id or name")
            else:
                key = int(k)
            if key in out:
                raise ValueError(f"speaker_mix names speaker {key} twice")
            out[key] = w
        return out

    def _sid_array(self, speaker_ids: Optional[Sequence[int]], batch: int,
                   mixes=None) -> Optional[np.ndarray]:
        """The speaker argument of `batch` rows, validated on the host:
        (B,) int64 ids, or (B, n_speakers) float32 mixing weights when
        `mixes` ({id: weight} per row, dummy rows included) is given; None
        for a single-speaker voice, which ignores ids as the JAX package
        does. A multi-speaker voice without ids takes speaker 0."""
        n_spk = self.hparams.n_speakers
        if mixes is not None:
            if len(mixes) != batch:
                raise ValueError(f"speaker_mixes length {len(mixes)} != batch size {batch}")
            if speaker_ids is not None:
                raise ValueError("pass speaker_id OR speaker_mix, not both")
            w = np.zeros((batch, max(1, n_spk)), np.float32)
            for i, mix in enumerate(mixes):
                validate_speaker_mix(mix, n_spk)
                for s, wt in mix.items():
                    w[i, int(s)] = float(wt)
            return w
        if n_spk <= 1:
            return None
        if speaker_ids is None:
            speaker_ids = [0] * batch
        if len(speaker_ids) != batch:
            raise ValueError(f"speaker_ids length {len(speaker_ids)} != batch size {batch}")
        bad = [s for s in speaker_ids if not 0 <= int(s) < n_spk]
        if bad:
            raise ValueError(f"speaker_id {int(bad[0])} out of range [0, {n_spk})")
        return np.asarray([int(s) for s in speaker_ids], np.int64)

    def _row_sids(self, speaker_ids, speaker_mixes, b: int, bp: int) -> Optional[np.ndarray]:
        """_sid_array for b real rows padded to bp: the ladder's dummy rows
        copy row 0's speaker id or mix."""
        if speaker_ids is not None and bp > b:
            speaker_ids = list(speaker_ids) + [speaker_ids[0]] * (bp - b)
        return self._sid_array(speaker_ids, bp, mixes=self._pad_mixes(speaker_mixes, b, bp))

    @staticmethod
    def _pad_mixes(mixes, b: int, bp: int):
        """One copied mix per real row, then copies of row 0's for the
        ladder's dummy rows. The copies keep a caller's later change to a
        submitted dict out of a queued request; too few mixes raise rather
        than condition a real row on row 0's mix."""
        if mixes is None:
            return None
        mixes = [dict(m) if m is not None else None for m in mixes]
        if len(mixes) != b:
            raise ValueError(f"speaker_mixes length {len(mixes)} != batch size {b}")
        return mixes + [mixes[0]] * (bp - b)

    @staticmethod
    def _sid_kind(sid):
        """The speaker part of a run's key: None, "id" or "mix"."""
        if sid is None:
            return None
        return "mix" if sid.ndim == 2 else "id"

    def _mark(self, kind: str, key) -> bool:
        """True the first time (kind, key) runs on this runtime."""
        with self._lock:
            k = (kind, key)
            if k in self._compiled_keys:
                return False
            self._compiled_keys.add(k)
            return True

    @contextlib.contextmanager
    def _device_work(self):
        """The runtime's lock, inference mode (per thread) and the encode
        tier: every piece of this runtime's device work runs inside it."""
        with self._lock, torch.inference_mode(), tier_scope(self.options.precision,
                                                            self.device):
            yield

    def _validate_and_pad(self, ids_batch: List[List[int]], pad_batch: bool = True,
                          pad_rows_to: Optional[int] = None):
        """Request validation and the phoneme and batch-axis bucketing of
        every path. Returns (lengths, p_bucket, ids) where ids may carry
        dummy rows (copies of row 0) padding the batch up to the
        batch_buckets ladder, or to `pad_rows_to` rows when given; callers
        slice outputs to the real row count. Dummy rows copy row 0 so they
        cannot raise the frame bucket above what the real rows need."""
        hp = self.hparams
        for seq in ids_batch:
            if not seq:
                raise ValueError("empty phoneme sequence")
            bad = [i for i in seq if not 0 <= i < hp.n_vocab]
            if bad:
                raise ValueError(f"phoneme id(s) {bad[:5]} out of range [0, {hp.n_vocab}) — "
                                 f"check the voice's phoneme_id_map")
        b = len(ids_batch)
        ladder = self.batch_ladder
        if pad_rows_to is not None:
            if pad_rows_to < b:
                raise ValueError(f"pad_rows_to {pad_rows_to} < batch size {b}")
            # A mesh splits rows over dp: a pinned count snaps up to a dp
            # multiple here, not in every caller.
            pad_rows_to = -(-int(pad_rows_to) // self._dp_size) * self._dp_size
            ids_batch = ids_batch + [ids_batch[0]] * (int(pad_rows_to) - b)
        elif pad_batch and (b > 1 or self._dp_size > 1) and b <= ladder[-1]:
            # On a mesh every batch (even one row) pads to a dp-divisible rung.
            b_bucket = next(x for x in ladder if x >= b)
            ids_batch = ids_batch + [ids_batch[0]] * (b_bucket - b)
        lengths = np.asarray([len(x) for x in ids_batch], np.int64)
        p_bucket = bucket_for(int(lengths.max()), self.options.phoneme_buckets, "phoneme")
        ids = np.stack([pad_to(np.asarray(x, np.int64), p_bucket) for x in ids_batch])
        return lengths, p_bucket, ids

    def _frame_bucket(self, frames: int) -> int:
        """The frame bucket of `frames`, or the largest past it."""
        try:
            return bucket_for(max(1, frames), self.options.frame_buckets, "frame")
        except BucketOverflowError:
            return self.options.frame_buckets[-1]

    def _frame_bucket_or_clamp(self, max_needed: int) -> int:
        """The frame bucket of `max_needed` frames; past the largest bucket,
        the largest, with a warning (the audio is truncated)."""
        f_bucket = self._frame_bucket(max_needed)
        if f_bucket < max_needed:
            print(f"[piper-tpu-torch] warning: predicted {max_needed} frames exceeds the "
                  f"largest bucket {f_bucket}; audio will be truncated", file=sys.stderr)
        return f_bucket

    def _budget_bucket(self, max_len: int) -> int:
        """Fused mode's frame bucket: the heuristic budget's, clamped."""
        return self._frame_bucket(max(32, max_len * self.options.fused_frames_per_phoneme))

    # -- device work (callers hold _device_work) -------------------------------

    def _to_device(self, a: Optional[np.ndarray], device=None) -> Optional[torch.Tensor]:
        """A host array on the runtime's device (or `device`). On the card
        the copy is queued from pinned memory: the host does not wait for
        it, so no dispatch synchronizes with the device."""
        if a is None:
            return None
        dev = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type != "cuda":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def _encode(self, ids: np.ndarray, lengths: np.ndarray, ls, nw, seed,
                dp_noise: Optional[np.ndarray] = None,
                sid: Optional[np.ndarray] = None, shard: bool = True) -> vits.EncodeResult:
        """ids (B, P) through the text encoder and duration predictor, with
        the injected dp_noise (zero-padded to P) or the seeded draw, for the
        speakers of `sid` (_sid_array's). `seed` is one seed, whose draw
        every row shares, or a (B,) int64 tensor of one seed per row, each
        row drawing its own (a streaming head's rows, each equal to its
        solo draw);
        `ls` and `nw` are floats or (B, 1, 1) tensors. On a mesh the rows
        split over dp unless `shard` is False or the noise is injected."""
        b, p = ids.shape
        src = None
        if dp_noise is not None:
            src = _padded(np.asarray(dp_noise, np.float32).reshape(b, 2, -1), (b, 2, p))

        def run(grp, lo, hi):
            dev = grp.device
            if src is not None:
                dpn = self._to_device(src[lo:hi], dev)
            elif isinstance(seed, torch.Tensor):  # row r: normal(fold_in(PRNGKey(seed[r]), 0))
                dpn = prng.threefry_normal(seed[lo:hi].to(dev), 0, hi - lo, 2 * p).view(-1, 2, p)
            else:
                dpn = seeded_noise(seed, 0, (2, p), hi - lo, dev)
            return vits.encode(grp.params, self.hparams, self._to_device(ids[lo:hi], dev),
                               self._to_device(lengths[lo:hi], dev), dpn,
                               length_scale=slice_rows(ls, lo, hi, dev),
                               noise_w=slice_rows(nw, lo, hi, dev),
                               sid=self._to_device(None if sid is None else sid[lo:hi], dev))

        return self._on_groups(run, b, shard and src is None)

    def _decode(self, enc: vits.EncodeResult, f_bucket: int, ns: float, seed: int,
                main_noise: Optional[np.ndarray] = None):
        """(audio in the output dtype, y_len), both on the device; on a
        mesh the rows split over dp unless the noise is injected."""
        b, c = enc.m_p.shape[:2]
        src = None if main_noise is None else _padded(main_noise, (b, c, f_bucket))
        o = self.options

        def run(grp, lo, hi):
            dev = grp.device
            if src is not None:
                mn = self._to_device(src[lo:hi], dev)
            else:
                mn = seeded_noise(seed, 1, (c, f_bucket), hi - lo, dev)
            audio, y_len = vits.decode(
                grp.params, self.hparams, slice_rows(enc, lo, hi, dev), mn,
                max_frames=f_bucket, noise_scale=ns, vocoder_precision=o.vocoder_precision,
                flow_precision=o.flow_precision, stages=grp.stages)
            return self._as_output(audio), y_len

        return self._on_groups(run, b, src is None)

    def _run_fused(self, ids, lengths, scales, seed, sid, f_bucket: Optional[int] = None):
        """Encode and decode at `f_bucket` (by default the budget bucket of
        the longest row) with no host read; returns ((audio, y_len,
        y_total) on the device, f_bucket, compiled)."""
        ns, ls, nw = scales
        if f_bucket is None:
            f_bucket = self._budget_bucket(int(lengths.max()))
        compiled = self._mark("fused", (ids.shape[0], ids.shape[1], f_bucket,
                                        self._sid_kind(sid)))
        enc = self._encode(ids, lengths, ls, nw, seed, sid=sid)
        audio, y_len = self._decode(enc, f_bucket, ns, seed)
        return (audio, y_len, enc.y_total), f_bucket, compiled

    def _run_split(self, ids, lengths, b: int, scales, seed, sid, dp_noise=None,
                   main_noise=None):
        """Encode, the one host read (the frame counts pick the decode
        bucket), decode. Returns (audio on the device, y_len of the b real
        rows, f_bucket, compiled, the host clock after the read)."""
        ns, ls, nw = scales
        rows, p_bucket = ids.shape
        kind = self._sid_kind(sid)
        compiled = self._mark("enc_inj" if dp_noise is not None else "enc_key",
                              (rows, p_bucket, kind))
        enc = self._encode(ids, lengths, ls, nw, seed, dp_noise, sid)
        y_lengths = enc.y_total.cpu().numpy().astype(np.int64)
        t_encode = time.perf_counter()
        # Degenerate durations (extreme length_scale) clamp to the largest
        # bucket and truncate the tail rather than failing the request.
        f_bucket = self._frame_bucket_or_clamp(int(y_lengths[:b].max()))
        src = None
        if main_noise is not None:
            src = np.asarray(main_noise, np.float32).reshape(b, self.hparams.inter_channels, -1)
            f_bucket = self._frame_bucket(max(int(y_lengths.max()), src.shape[-1]))
        compiled |= self._mark("dec_inj" if src is not None else "dec_key",
                               (rows, f_bucket, kind))
        audio, _ = self._decode(enc, f_bucket, ns, seed, src)
        return audio, np.clip(y_lengths, 1, f_bucket)[:b], f_bucket, compiled, t_encode

    # -- blocking synthesis ----------------------------------------------------

    def synthesize(
        self,
        phoneme_ids: Sequence[int],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        seed: Optional[int] = None,
        dp_noise: Optional[np.ndarray] = None,
        main_noise: Optional[np.ndarray] = None,
        speaker_mix: Optional[dict] = None,
    ) -> np.ndarray:
        """Synthesize one utterance; PCM in the runtime's output_dtype.

        The parameters are the JAX package's, in its order. `speaker_id` is
        an integer id (names resolve through `speaker_index`), ignored by a
        single-speaker voice; `speaker_mix` {id: weight} blends speakers
        (a multi-speaker voice only; not beside `speaker_id`). `dp_noise`
        (2, P') and `main_noise` (C, F') inject the noise tensors
        (zero-padded to the buckets) in place of the seeded draws; they run
        in split mode."""
        audios, timings = self._synthesize_batch_impl(
            [list(phoneme_ids)],
            noise_scale=noise_scale,
            length_scale=length_scale,
            noise_w=noise_w,
            speaker_ids=[speaker_id] if speaker_id is not None else None,
            seed=seed,
            dp_noise=dp_noise,
            main_noise=main_noise,
            speaker_mixes=[speaker_mix] if speaker_mix is not None else None,
        )
        self.last_run_timings = timings
        return audios[0]

    def synthesize_batch(
        self,
        phoneme_ids_batch: Sequence[Sequence[int]],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_ids: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        speaker_mixes: Optional[Sequence[dict]] = None,
    ) -> List[np.ndarray]:
        """Batched multi-utterance synthesis (pads to a common bucket and the
        rows to the batch ladder); one PCM array per utterance, exact
        lengths. The parameters are the JAX package's, in its order; each
        row takes its own speaker id or mix."""
        audios, timings = self._synthesize_batch_impl(
            [list(x) for x in phoneme_ids_batch],
            noise_scale=noise_scale,
            length_scale=length_scale,
            noise_w=noise_w,
            speaker_ids=list(speaker_ids) if speaker_ids is not None else None,
            seed=seed,
            speaker_mixes=list(speaker_mixes) if speaker_mixes is not None else None,
        )
        self.last_run_timings = timings
        return audios

    def _synthesize_batch_impl(
        self,
        ids_batch: List[List[int]],
        *,
        noise_scale,
        length_scale,
        noise_w,
        speaker_ids,
        seed=None,
        dp_noise: Optional[np.ndarray] = None,
        main_noise: Optional[np.ndarray] = None,
        speaker_mixes=None,
    ) -> Tuple[List[np.ndarray], RunTimings]:
        with self._device_work():
            return self._synthesize_batch_locked(
                ids_batch, noise_scale=noise_scale, length_scale=length_scale,
                noise_w=noise_w, speaker_ids=speaker_ids, seed=seed, dp_noise=dp_noise,
                main_noise=main_noise, speaker_mixes=speaker_mixes)

    def _synthesize_batch_locked(
        self,
        ids_batch: List[List[int]],
        *,
        noise_scale,
        length_scale,
        noise_w,
        speaker_ids,
        seed=None,
        dp_noise: Optional[np.ndarray] = None,
        main_noise: Optional[np.ndarray] = None,
        speaker_mixes=None,
    ) -> Tuple[List[np.ndarray], RunTimings]:
        t_start = time.perf_counter()
        b = len(ids_batch)
        # Injected-noise calls provide exactly b rows of noise: no batch
        # padding there (they are test and bisection paths, not serving).
        injected = dp_noise is not None or main_noise is not None
        lengths, p_bucket, ids = self._validate_and_pad(ids_batch, pad_batch=not injected)
        scales = self._scales(noise_scale, length_scale, noise_w)
        sid = self._row_sids(speaker_ids, speaker_mixes, b, ids.shape[0])
        base_seed = self.options.seed if seed is None else seed

        # Fused mode serves single-utterance latency; batches want the exact
        # split-chosen frame bucket (the budget would waste decode work on
        # every row).
        use_fused = self.options.mode == "fused" and b == 1 and not injected
        compiled = False
        if use_fused:
            outs, f_bucket, compiled = self._run_fused(ids, lengths, scales, base_seed, sid)
            audio, y_len, y_total = _HostCopy(outs).wait()
            t_encode = t_end = time.perf_counter()
            use_fused = int(y_total.max()) <= f_bucket  # else redo exactly, split
        if not use_fused:
            audio_d, y_len, f_bucket, split_compiled, t_encode = self._run_split(
                ids, lengths, b, scales, base_seed, sid, dp_noise, main_noise)
            compiled |= split_compiled
            (audio,) = _HostCopy((audio_d,)).wait()
            t_end = time.perf_counter()

        hop = self.hparams.hop_length
        out = [audio[i, : int(y_len[i]) * hop].copy() for i in range(b)]
        if use_fused:
            self.profiler.record("fused", f_bucket, (t_end - t_start) * 1e3, compiled)
        else:
            self.profiler.record("encode", p_bucket, (t_encode - t_start) * 1e3, compiled)
            self.profiler.record("decode", f_bucket, (t_end - t_encode) * 1e3, compiled)
        return out, self._timings(t_start, t_encode, t_end, p_bucket, f_bucket,
                                  int(np.sum(y_len[:b])), out, compiled)

    def _timings(self, t_start, t_encode, t_end, p_bucket, f_bucket, frames, out,
                 compiled) -> RunTimings:
        total_samples = sum(len(a) for a in out)
        wall = t_end - t_start
        return RunTimings(
            wall_ms=wall * 1e3,
            encode_ms=(t_encode - t_start) * 1e3,
            decode_ms=(t_end - t_encode) * 1e3,
            phoneme_bucket=p_bucket,
            frame_bucket=f_bucket,
            frames=frames,
            samples=total_samples,
            compiled=compiled,
            compile_count=len(self._compiled_keys),
            rtf=(total_samples / self.sample_rate) / wall if wall > 0 else 0.0,
        )

    def _durations(self, ids_batch: Sequence[Sequence[int]], seed: Optional[int] = None,
                   dp_noise: Optional[np.ndarray] = None, speaker_ids=None,
                   speaker_mixes=None):
        """(w, w_ceil) of the real rows, (b, P) each: the frame durations
        before and after their ceil, as a synthesis with the same ids,
        speakers, seed or injected dp_noise (b, 2, P') computes them (rows
        padded to the ladder unless the noise is injected). For parity
        checks: how close a duration lies to an integer says whether a ceil
        could flip."""
        ids_batch = [list(x) for x in ids_batch]
        b = len(ids_batch)
        lengths, _, ids = self._validate_and_pad(ids_batch, pad_batch=dp_noise is None)
        _, ls, nw = self._scales(None, None, None)
        sid = self._row_sids(speaker_ids, speaker_mixes, b, ids.shape[0])
        with self._device_work():
            enc = self._encode(ids, lengths, ls, nw,
                               self.options.seed if seed is None else seed, dp_noise, sid)
            return enc.w[:b].cpu().numpy(), enc.w_ceil[:b].cpu().numpy()

    def synthesize_debug(
        self,
        phoneme_ids: Sequence[int],
        *,
        max_frames: int = 256,
        seed: Optional[int] = None,
        per_layer: bool = False,
        **scales,
    ) -> dict:
        """Run the full graph returning every module boundary tensor as numpy
        (float32), the JAX package's synthesize_debug: the same numpy noise
        from default_rng(seed) (dp (1, 2, P bucket), then the prior (1, C,
        max_frames)), the phoneme bucket, the scales and speaker_id.
        per_layer=True adds one tensor per conv/flow-step/attention layer
        keyed by its checkpoint parameter path, in the order they ran, for
        bisecting a divergence to one layer (`model.debug_infer`). It runs
        eagerly at the runtime's tiers under inference mode; PyTorch
        compiles nothing, so there is no per-settings program cache to keep
        (the JAX package caches its jitted debug programs)."""
        ids = np.asarray(list(phoneme_ids), np.int64)[None]
        p_bucket = bucket_for(ids.shape[1], self.options.phoneme_buckets, "phoneme")
        ids = np.pad(ids, ((0, 0), (0, p_bucket - ids.shape[1])))
        rng = np.random.default_rng(self.options.seed if seed is None else seed)
        dp_noise = rng.standard_normal((1, 2, p_bucket)).astype(np.float32)
        main_noise = rng.standard_normal(
            (1, self.hparams.inter_channels, max_frames)).astype(np.float32)
        ns, ls, nw = self._scales(scales.get("noise_scale"), scales.get("length_scale"),
                                  scales.get("noise_w"))
        sid = self._sid_array(
            [scales["speaker_id"]] if scales.get("speaker_id") is not None else None, 1)
        with self._device_work():
            out = vits.debug_infer(
                self._group(0).params, self.hparams, self._to_device(ids),
                self._to_device(np.asarray([len(phoneme_ids)], np.int64)),
                self._to_device(dp_noise), self._to_device(main_noise),
                max_frames=max_frames, noise_scale=ns, length_scale=ls, noise_w=nw,
                sid=self._to_device(sid), per_layer=per_layer, stages=self._group(0).stages)
            return {k: v.float().cpu().numpy() for k, v in out.items()}

    def prewarm(
        self,
        phoneme_lengths: Sequence[int] = (14, 28, 56, 112),
        batch_sizes: Sequence[int] = (1,),
    ) -> dict:
        """Pay the first-run costs of a serving sweep ahead of traffic: one
        dummy synthesis per (batch, phoneme length) through the runtime's
        configured mode. On the card that is every kernel's build, cuDNN's
        algorithm choice for each shape, the caching allocator's growth and
        the pinned host buffers. In split mode the decode bucket follows
        the predicted durations, so real inputs can still meet a
        neighbouring frame bucket first; fused mode's budget buckets are
        covered exactly. Returns {"programs": keys run for the first time,
        "seconds": wall}."""
        t0 = time.perf_counter()
        before = len(self._compiled_keys)
        base = [i % self.hparams.n_vocab for i in FIXTURE_PHONEME_IDS]
        for b in batch_sizes:
            for length in phoneme_lengths:
                ids = (base * (-(-length // len(base))))[:length]
                if b == 1:
                    self.synthesize(ids)
                else:
                    self.synthesize_batch([ids] * int(b))
        return {"programs": len(self._compiled_keys) - before,
                "seconds": time.perf_counter() - t0}

    # -- duration controls -----------------------------------------------------

    def phoneme_durations(
        self,
        phoneme_ids_batch: Sequence[Sequence[int]],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_ids: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        pad_rows_to: Optional[int] = None,
        speaker_mixes: Optional[Sequence[dict]] = None,
    ) -> List[np.ndarray]:
        """Per-phoneme frame durations of each utterance (int64), the plan
        the decoder expands: the encoder only (text encoder and duration
        predictor), one small host copy, no vocoder work. The seeded noise
        is one draw per row, so for the same (ids, length_scale, noise_w,
        speaker, seed) this is the plan every synthesis of the runtime
        realized, however it was batched. `pad_rows_to` pins the padded row
        count (row-0 copies) in place of the batch ladder. `noise_scale`
        does not change durations (it scales the prior's noise only)."""
        del noise_scale
        ids_batch = [list(x) for x in phoneme_ids_batch]
        b = len(ids_batch)
        lengths, p_bucket, ids = self._validate_and_pad(ids_batch, pad_rows_to=pad_rows_to)
        bp = ids.shape[0]
        _, ls, nw = self._scales(None, length_scale, noise_w)
        sid = self._row_sids(speaker_ids, speaker_mixes, b, bp)
        with self._device_work():
            t0 = time.perf_counter()
            compiled = self._mark("enc_key", (bp, p_bucket, self._sid_kind(sid)))
            enc = self._encode(ids, lengths, ls, nw,
                               self.options.seed if seed is None else seed, sid=sid)
            w = enc.w_ceil.cpu().numpy().astype(np.int64)
            self.profiler.record("durations", p_bucket, (time.perf_counter() - t0) * 1e3,
                                 compiled)
        return [w[i, : len(ids_batch[i])] for i in range(b)]

    def synthesize_with_alignment(
        self,
        phoneme_ids: Sequence[int],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        seed: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ) -> Tuple[np.ndarray, PhonemeAlignment]:
        """One utterance and its phoneme-level timing: (audio as synthesize
        gives it, the per-phoneme sample spans of that waveform). One more
        encoder pass and a small host copy than synthesize."""
        ids = list(phoneme_ids)
        audio = self.synthesize(ids, noise_scale=noise_scale, length_scale=length_scale,
                                noise_w=noise_w, speaker_id=speaker_id, seed=seed,
                                speaker_mix=speaker_mix)
        durations = self.phoneme_durations(
            [ids], length_scale=length_scale, noise_w=noise_w,
            speaker_ids=[speaker_id] if speaker_id is not None else None, seed=seed,
            speaker_mixes=[speaker_mix] if speaker_mix is not None else None)[0]
        return audio, make_alignment(ids, durations, hop_length=self.hparams.hop_length,
                                     sample_rate=self.sample_rate, total_samples=len(audio))

    def synthesize_forced(
        self,
        phoneme_ids: Sequence[int],
        durations: Sequence[int],
        noise_scale: Optional[float] = None,
        speaker_id: Optional[int] = None,
        seed: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ) -> np.ndarray:
        """Synthesize with the caller's per-phoneme frame plan:
        `durations[i]` frames go to `phoneme_ids[i]` and the duration
        predictor is skipped (dubbing and karaoke timing, an edited
        `phoneme_durations()` plan). Forcing the unedited plan at the same
        seed reproduces split mode's `synthesize()`. There is no host read:
        the frame bucket follows from sum(durations)."""
        audios, timings = self._synthesize_forced_impl(
            [list(phoneme_ids)], [list(durations)],
            noise_scale=noise_scale,
            speaker_ids=[speaker_id] if speaker_id is not None else None,
            seed=seed,
            speaker_mixes=[speaker_mix] if speaker_mix is not None else None,
        )
        self.last_run_timings = timings
        return audios[0]

    def synthesize_batch_forced(
        self,
        phoneme_ids_batch: Sequence[Sequence[int]],
        durations_batch: Sequence[Sequence[int]],
        noise_scale: Optional[float] = None,
        speaker_ids: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        pad_rows_to: Optional[int] = None,
        speaker_mixes: Optional[Sequence[dict]] = None,
    ) -> List[np.ndarray]:
        """Batched duration forcing (see synthesize_forced); `pad_rows_to`
        as in phoneme_durations."""
        audios, timings = self._synthesize_forced_impl(
            [list(x) for x in phoneme_ids_batch],
            [list(d) for d in durations_batch],
            noise_scale=noise_scale,
            speaker_ids=list(speaker_ids) if speaker_ids is not None else None,
            seed=seed,
            pad_rows_to=pad_rows_to,
            speaker_mixes=list(speaker_mixes) if speaker_mixes is not None else None,
        )
        self.last_run_timings = timings
        return audios

    def _synthesize_forced_impl(
        self,
        ids_batch: List[List[int]],
        durations_batch: List[List[int]],
        *,
        noise_scale,
        speaker_ids,
        seed=None,
        pad_rows_to=None,
        speaker_mixes=None,
    ) -> Tuple[List[np.ndarray], RunTimings]:
        if len(durations_batch) != len(ids_batch):
            raise ValueError(
                f"{len(ids_batch)} utterances but {len(durations_batch)} duration rows")
        totals = []
        for ids, durs in zip(ids_batch, durations_batch):
            if len(durs) != len(ids):
                raise ValueError(
                    f"durations length {len(durs)} != phoneme count {len(ids)} — one "
                    f"frame count per phoneme")
            if any(d < 0 for d in durs):
                raise ValueError("durations must be non-negative frame counts")
            # Per row: an all-zero plan would clip to one frame of noise.
            if sum(durs) < 1:
                raise ValueError("at least one phoneme needs a non-zero duration")
            totals.append(int(sum(durs)))
        t_start = time.perf_counter()
        b = len(ids_batch)
        lengths, p_bucket, ids = self._validate_and_pad(ids_batch, pad_rows_to=pad_rows_to)
        bp = ids.shape[0]
        # Dummy rows copy row 0's plan, so they cannot raise the frame bucket.
        durs = np.zeros((bp, p_bucket), np.int64)
        for i in range(bp):
            row = durations_batch[i] if i < b else durations_batch[0]
            durs[i, : len(row)] = row
        sid = self._row_sids(speaker_ids, speaker_mixes, b, bp)
        ns, _, _ = self._scales(noise_scale, None, None)
        base_seed = self.options.seed if seed is None else seed
        with self._device_work():
            f_bucket = self._frame_bucket_or_clamp(max(totals))
            compiled = self._mark("forced", (bp, p_bucket, f_bucket, self._sid_kind(sid)))
            enc = self._on_groups(lambda grp, lo, hi: vits.encode_forced(
                grp.params, self.hparams, self._to_device(ids[lo:hi], grp.device),
                self._to_device(lengths[lo:hi], grp.device),
                self._to_device(durs[lo:hi], grp.device),
                sid=self._to_device(None if sid is None else sid[lo:hi], grp.device)), bp)
            audio_d, _ = self._decode(enc, f_bucket, ns, base_seed)
            (audio,) = _HostCopy((audio_d,)).wait()
        t_end = time.perf_counter()
        y_len = np.clip(np.asarray(totals, np.int64), 1, f_bucket)
        hop = self.hparams.hop_length
        out = [audio[i, : int(y_len[i]) * hop].copy() for i in range(b)]
        self.profiler.record("forced", f_bucket, (t_end - t_start) * 1e3, compiled)
        return out, self._timings(t_start, t_start, t_end, p_bucket, f_bucket,
                                  int(y_len.sum()), out, compiled)

    # -- dispatch / fetch ------------------------------------------------------

    def dispatch_fused(
        self,
        phoneme_ids: Sequence[int],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        seed: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ):
        """Queue one fused synthesis and its copy to the host without a
        host read; returns ((audio, y_len, y_total) on the device, meta) for
        `fetch_fused`. The building block of the serving pipeline. On a mesh
        the utterance rides the batched fused path (its rows pad to a
        dp-divisible rung), which fetch_fused completes too."""
        if self.mesh is not None:
            return self._dispatch_batch_fused(
                [list(phoneme_ids)], noise_scale=noise_scale, length_scale=length_scale,
                noise_w=noise_w, speaker_ids=[speaker_id] if speaker_id is not None else None,
                seed=seed, speaker_mixes=[speaker_mix] if speaker_mix is not None else None)
        ids = list(phoneme_ids)
        lengths, _, ids_np = self._validate_and_pad([ids])
        scales = self._scales(noise_scale, length_scale, noise_w)
        sid = self._sid_array([speaker_id] if speaker_id is not None else None, 1,
                              mixes=[speaker_mix] if speaker_mix is not None else None)
        base_seed = self.options.seed if seed is None else seed
        with self._device_work():
            outs, f_bucket, _ = self._run_fused(ids_np, lengths, scales, base_seed, sid)
            copy = _HostCopy(outs)
        # The mix is copied: meta outlives this call (fetch_fused's overflow
        # redo) and the caller may change the dict meanwhile.
        meta = {"ids": ids, "f_bucket": f_bucket, "scales": scales, "speaker_id": speaker_id,
                "speaker_mix": dict(speaker_mix) if speaker_mix is not None else None,
                "seed": seed, "copy": copy}
        return outs, meta

    def fetch_fused(self, outs, meta) -> np.ndarray:
        """Complete a dispatch_fused: wait for its one copy of (audio, y_len,
        y_total) (meta's copy holds `outs` until then); when the durations
        overflowed the frame budget, redo the utterance, in the same voice,
        with a blocking split-mode synthesis."""
        if meta.get("fused_batch"):  # a mesh runtime's batched fused path
            return self._fetch_batch_fused(meta)[0]
        audio, y_len, y_total = meta["copy"].wait()
        if int(y_total.max()) > meta["f_bucket"]:
            ns, ls, nw = meta["scales"]
            return self.synthesize(meta["ids"], noise_scale=ns, length_scale=ls, noise_w=nw,
                                   speaker_id=meta["speaker_id"], seed=meta["seed"],
                                   speaker_mix=meta["speaker_mix"])
        return audio[0, : int(y_len[0]) * self.hparams.hop_length].copy()

    def dispatch_batch(
        self,
        phoneme_ids_batch: Sequence[Sequence[int]],
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_ids: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        fused: Optional[bool] = None,
        pad_rows_to: Optional[int] = None,
        budget_frames: Optional[int] = None,
        overflow_budget_frames: Optional[int] = None,
        overflow_pad_rows: Optional[int] = None,
        speaker_mixes: Optional[Sequence[dict]] = None,
    ):
        """Queue a batched synthesis without waiting for the audio.

        The split path: encode, read only the frame counts (they pick the
        decode bucket; the read waits for the work queued before it), queue
        the decode and the audio's copy to pinned host memory, and return
        (device audio, meta) for `fetch_batch`. The copy is queued here,
        right behind its decode: on one stream a copy queued at fetch time
        would wait for the next batch's decode too.

        `fused=True` runs the whole group the fused way instead: encode and
        decode at a frame budget with no host read, and one copy of (audio,
        y_len, y_total) queued behind them. The budget is `budget_frames`,
        or the longest real row's length * fused_frames_per_phoneme, rounded
        up to a frame bucket; rows pad to `pad_rows_to` (row-0 copies) in
        place of the batch ladder. A serving layer pins both, so its groups
        run a bounded grid of (rows, frames) shapes. Rows whose durations
        overflow the budget are redone at fetch: on the fused grid at
        `overflow_budget_frames` x `overflow_pad_rows` rows when both are
        given and the rows fit, else with a blocking split synthesize_batch
        (the same seed, scales, speakers and mixes; its noise realization
        differs, as the one-row fused redo's does). The continuous batcher
        (engine/batcher.py) serves through this path.

        A 1-row batch on a fused-mode runtime with `fused=None` delegates to
        dispatch_fused, so its audio equals synthesize_batch's (which takes
        the fused path for one row). Without `fused=True` the grid
        arguments are ignored, as in the JAX package."""
        ids_batch = [list(x) for x in phoneme_ids_batch]
        b = len(ids_batch)
        if b == 1 and self.options.mode == "fused" and fused is None:
            outs, meta = self.dispatch_fused(
                ids_batch[0], noise_scale=noise_scale, length_scale=length_scale,
                noise_w=noise_w, speaker_id=speaker_ids[0] if speaker_ids else None, seed=seed,
                speaker_mix=speaker_mixes[0] if speaker_mixes else None)
            meta["fused1"] = True
            return outs, meta
        if fused:
            return self._dispatch_batch_fused(
                ids_batch, noise_scale=noise_scale, length_scale=length_scale, noise_w=noise_w,
                speaker_ids=speaker_ids, seed=seed, pad_rows_to=pad_rows_to,
                budget_frames=budget_frames, overflow_budget_frames=overflow_budget_frames,
                overflow_pad_rows=overflow_pad_rows, speaker_mixes=speaker_mixes)
        lengths, _, ids = self._validate_and_pad(ids_batch)
        scales = self._scales(noise_scale, length_scale, noise_w)
        sid = self._row_sids(speaker_ids, speaker_mixes, b, ids.shape[0])
        base_seed = self.options.seed if seed is None else seed
        with self._device_work():
            t_start = time.perf_counter()
            audio, y_len, f_bucket, compiled, t_dispatch = self._run_split(
                ids, lengths, b, scales, base_seed, sid)
            copy = _HostCopy((audio,))
        self.profiler.record("encode", ids.shape[1], (t_dispatch - t_start) * 1e3, compiled)
        return audio, {"y_len": y_len, "f_bucket": f_bucket, "b": b, "copy": copy,
                       "t_dispatch": t_dispatch, "compiled": compiled}

    def _dispatch_batch_fused(self, ids_batch: List[List[int]], *, noise_scale, length_scale,
                              noise_w, speaker_ids, seed, pad_rows_to: Optional[int] = None,
                              budget_frames: Optional[int] = None,
                              overflow_budget_frames: Optional[int] = None,
                              overflow_pad_rows: Optional[int] = None,
                              speaker_mixes: Optional[Sequence[dict]] = None):
        """The whole-group fused dispatch of dispatch_batch(fused=True):
        queue the work and its one copy, read nothing back."""
        b = len(ids_batch)
        lengths, _, ids = self._validate_and_pad(ids_batch, pad_rows_to=pad_rows_to)
        scales = self._scales(noise_scale, length_scale, noise_w)
        sid = self._row_sids(speaker_ids, speaker_mixes, b, ids.shape[0])
        base_seed = self.options.seed if seed is None else seed
        # The caller's pinned budget, or _run_fused's of the longest row
        # (dummy rows copy row 0, so they need no more than the real rows).
        pinned = None if budget_frames is None else self._frame_bucket(max(32, int(budget_frames)))
        t_dispatch = time.perf_counter()
        with self._device_work():
            outs, f_bucket, compiled = self._run_fused(ids, lengths, scales, base_seed, sid,
                                                       f_bucket=pinned)
            copy = _HostCopy(outs)
        meta = {"fused_batch": True, "b": b, "f_bucket": f_bucket, "compiled": compiled,
                "copy": copy, "t_dispatch": t_dispatch,
                # For the overflow redo; the mixes are copied, as dispatch_fused's.
                "ids_batch": ids_batch, "scales": scales,
                "speaker_ids": list(speaker_ids) if speaker_ids is not None else None,
                "speaker_mixes": ([dict(m) for m in speaker_mixes]
                                  if speaker_mixes is not None else None),
                "seed": seed, "overflow_budget_frames": overflow_budget_frames,
                "overflow_pad_rows": overflow_pad_rows}
        return outs, meta

    def _fetch_batch_fused(self, meta) -> List[np.ndarray]:
        """Complete a fused group: one wait for its copy, then the rows that
        overflowed the budget redone (dispatch_batch(fused=True))."""
        audio, y_len, y_total = meta["copy"].wait()
        self.profiler.record("fused", meta["f_bucket"],
                             (time.perf_counter() - meta["t_dispatch"]) * 1e3, meta["compiled"])
        b, hop = meta["b"], self.hparams.hop_length
        out = [audio[i, : int(y_len[i]) * hop].copy() for i in range(b)]
        overflow = [i for i in range(b) if int(y_total[i]) > meta["f_bucket"]]
        if not overflow:
            return out
        ns, ls, nw = meta["scales"]
        sids, mixes = meta["speaker_ids"], meta["speaker_mixes"]
        kw = dict(noise_scale=ns, length_scale=ls, noise_w=nw, seed=meta["seed"],
                  speaker_ids=[sids[i] for i in overflow] if sids is not None else None,
                  speaker_mixes=[mixes[i] for i in overflow] if mixes is not None else None)
        o_ids = [meta["ids_batch"][i] for i in overflow]
        budget, rows = meta["overflow_budget_frames"], meta["overflow_pad_rows"]
        if budget and rows and len(overflow) <= rows:
            # The taller grid shape; a row that overflows even this budget
            # is redone in split mode by the inner fetch (no redo keys).
            _, meta2 = self._dispatch_batch_fused(o_ids, pad_rows_to=rows, budget_frames=budget,
                                                  **kw)
            redone = self._fetch_batch_fused(meta2)
        else:
            redone = self.synthesize_batch(o_ids, **kw)
        for k, i in enumerate(overflow):
            out[i] = redone[k]
        return out

    def fetch_batch(self, outs, meta) -> List[np.ndarray]:
        """Complete a dispatch_batch: wait for the audio's copy (meta's copy
        holds `outs` until then) and slice each row to its exact length;
        a fused group also redoes the rows that overflowed its budget."""
        if meta.get("fused1"):
            return [self.fetch_fused(outs, meta)]
        if meta.get("fused_batch"):
            return self._fetch_batch_fused(meta)
        (audio,) = meta["copy"].wait()
        self.profiler.record("decode", meta["f_bucket"],
                             (time.perf_counter() - meta["t_dispatch"]) * 1e3, meta["compiled"])
        y_len, hop = meta["y_len"], self.hparams.hop_length
        return [audio[i, : int(y_len[i]) * hop].copy() for i in range(meta["b"])]

    # -- streaming -------------------------------------------------------------

    def _device_rows(self, v, dtype, b: int) -> torch.Tensor:
        """(B,) per-row values on the device: a tensor as it is (reshaped),
        host values through a queued pinned copy."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device).reshape(-1).expand(b)
        return self._to_device(np.asarray(v, dtype).reshape(-1))

    def _filled(self, value: int) -> torch.Tensor:
        """A host int as a (1,) int64 tensor filled on the device (no copy)."""
        return torch.full((1,), int(value), dtype=torch.int64, device=self.device)

    def _window(self, enc, noise, t_off, total, ns, window: int) -> torch.Tensor:
        """decode_window at the runtime's tiers, in its output dtype: (B,
        window * hop) on the device."""
        o = self.options
        grp = self._group(0)
        return self._as_output(vits.decode_window(
            grp.params, self.hparams, enc, noise, t_off, window=window, total_frames=total,
            noise_scale=ns, vocoder_precision=o.vocoder_precision,
            flow_precision=o.flow_precision, stages=grp.stages))

    def _window_keyed(self, enc, seeds: torch.Tensor, t_off: torch.Tensor, total, ns,
                      window: int) -> torch.Tensor:
        """A seeded window: each row's prior noise from its seed at its
        absolute frames (per_row_frame_noise), as it is decoding alone."""
        t_idx = t_off[:, None] + torch.arange(window, device=self.device)[None, :]
        noise = vits.per_row_frame_noise(seeds, t_idx, self.hparams.inter_channels)
        return self._window(enc, noise, t_off, total, ns, window)

    def _head(self, ids: np.ndarray, lengths: np.ndarray, seeds: Sequence[int], scales, sid,
              window: int, halo: int):
        """Encode the rows and decode their first windows, frames [-halo,
        window - halo), with no host read. `scales` is (ns, ls, nw): floats,
        or (B, 1, 1) tensors. Row r draws its duration noise from seeds[r]
        as a solo run does. Returns (enc, audio (B, window * hop) in the
        output dtype, each row's frame count clamped to >= 1, the seeds),
        all on the device."""
        ns, ls, nw = scales
        seeds_d = self._to_device(np.asarray([_seed_u32(s) for s in seeds], np.int64))
        enc = self._encode(ids, lengths, ls, nw, seeds_d, sid=sid, shard=False)
        totals = torch.clamp(enc.y_total, min=1).to(torch.int64)
        t_off = torch.full((ids.shape[0],), -halo, dtype=torch.int64, device=self.device)
        return enc, self._window_keyed(enc, seeds_d, t_off, totals, ns, window), totals, seeds_d

    def synthesize_stream(
        self,
        phoneme_ids: Sequence[int],
        chunk_size: int = 2048,
        incremental: bool = False,
        **kwargs,
    ) -> Iterator[AudioChunk]:
        """Chunked streaming over the synthesized waveform.

        With incremental=False: synthesize fully, then chunk. With
        incremental=True the decode itself runs in haloed frame windows, so
        the first audio arrives after one window instead of the whole
        utterance (synthesize_stream_incremental, which takes the other
        keyword arguments). With injected noise the streamed audio equals
        the full decode; seeded, it is deterministic but another prior-noise
        realization than synthesize()'s (per_frame_noise)."""
        if incremental:
            yield from self.synthesize_stream_incremental(phoneme_ids, chunk_size=chunk_size,
                                                          **kwargs)
            return
        audio = self.synthesize(phoneme_ids, **kwargs)
        fmt, n = self.audio_format, len(audio)
        if n == 0:
            yield AudioChunk(format=fmt, start_sample_index=0,
                             samples=np.zeros(0, self.np_output_dtype), is_final=True)
            return
        for start in range(0, n, chunk_size):
            end = min(start + chunk_size, n)
            yield AudioChunk(format=fmt, start_sample_index=start, samples=audio[start:end],
                             is_final=end >= n)

    def synthesize_stream_incremental(
        self,
        phoneme_ids: Sequence[int],
        chunk_size: int = 2048,
        chunk_frames: Optional[int] = None,
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        seed: Optional[int] = None,
        dp_noise: Optional[np.ndarray] = None,
        main_noise: Optional[np.ndarray] = None,
        total_frames: Optional[int] = None,
        halo_frames: Optional[int] = None,
        chunk_schedule: Optional[Sequence[int]] = None,
        fused_head: Optional[bool] = None,
        speaker_mix: Optional[dict] = None,
    ) -> Iterator[AudioChunk]:
        """Windowed incremental decode; the JAX package's parameters, in its
        order.

        Each window emits its frames plus a halo of `receptive_field_frames`
        (or `halo_frames`) on each side, so the emitted region equals a full
        decode's up to the order of fp32 sums. The windows grow: emitted
        frames [c0, 2c0, 4c0, 8c0] (the last repeating), c0 = max(32,
        chunk_size // hop); `chunk_frames` pins one size and
        `chunk_schedule` gives the sizes. `dp_noise` (2, P'), `main_noise`
        (C, F') and `total_frames` (the virtual array length) inject what
        the seeded path draws; each window then takes its slice of
        main_noise, zero past it.

        `fused_head` (default: on when seeded) encodes and decodes window 0
        with no host read, queues window 0's copy to the host, then queues
        window 1 on the device-held frame count, so the first audio waits
        for the head alone and window 1 runs while it is fetched. The split
        path (injected noise, explicit total_frames, fused_head=False) reads
        the frame count after encode. In both, window k+1 is queued before
        window k is fetched. The runtime's lock is held around each dispatch
        only, never across a yield: an abandoned stream blocks nobody."""
        hp = self.hparams
        lengths, p_bucket, ids = self._validate_and_pad([list(phoneme_ids)], pad_batch=False)
        scales = self._scales(noise_scale, length_scale, noise_w)
        ns = scales[0]
        sid = self._sid_array([speaker_id] if speaker_id is not None else None, 1,
                              mixes=[speaker_mix] if speaker_mix is not None else None)
        kind = self._sid_kind(sid)
        base_seed = _seed_u32(self.options.seed if seed is None else seed)
        halo = receptive_field_frames(hp) if halo_frames is None else int(halo_frames)
        c0 = chunk_frames or max(32, chunk_size // hp.hop_length)
        if chunk_schedule is not None:
            sched = [max(1, int(v)) for v in chunk_schedule]
        elif chunk_frames is not None:
            sched = [c0]
        else:
            sched = [c0, 2 * c0, 4 * c0, 8 * c0]
        hop = hp.hop_length
        seeded = dp_noise is None and main_noise is None and total_frames is None
        use_head = seeded if fused_head is None else bool(fused_head)
        if use_head and not seeded:
            raise ValueError("fused_head streaming is seeded-only: injected noise and "
                             "explicit total_frames need the split encode/window path")

        seeds_d = spec1 = None
        with self._device_work():
            if use_head:
                self._mark("stream_head", (p_bucket, sched[0], halo, kind))
                enc, audio0, total_d, seeds_d = self._head(
                    ids, lengths, [base_seed], scales, sid, sched[0] + 2 * halo, halo)
                copy0 = _HostCopy((audio0, total_d))
                w1 = sched[min(1, len(sched) - 1)] + 2 * halo
                self._mark("stream_window", (1, p_bucket, w1, halo))
                spec1 = _HostCopy((self._window_keyed(
                    enc, seeds_d, self._filled(sched[0] - halo), total_d, ns, w1),))
            else:
                self._mark("enc_inj" if dp_noise is not None else "enc_key", (1, p_bucket, kind))
                enc = self._encode(ids, lengths, scales[1], scales[2], base_seed,
                                   dp_noise=dp_noise, sid=sid)
                if seeded:
                    seeds_d = self._filled(base_seed)
                y_len = max(1, int(enc.y_total[0]))
        if use_head:
            audio0, total_np = copy0.wait()
            y_len = int(total_np[0])  # already clamped >= 1 on the device
        total = int(total_frames) if total_frames is not None else y_len
        plan = []  # (start frame, emitted frames) per window
        pos = 0
        while pos < y_len:
            c_k = sched[min(len(plan), len(sched) - 1)]
            plan.append((pos, c_k))
            pos += c_k
        n_chunks = len(plan)
        full = (None if main_noise is None else
                np.asarray(main_noise, np.float32).reshape(1, hp.inter_channels, -1))

        def dispatch(k):
            """Queue window k's decode and its copy to the host."""
            start_k, c_k = plan[k]
            window = c_k + 2 * halo
            t_offset = start_k - halo
            with self._device_work():
                self._mark("stream_window", (1, p_bucket, window, halo))
                if full is None:
                    audio = self._window_keyed(enc, seeds_d, self._filled(t_offset),
                                               self._filled(total), ns, window)
                else:
                    win = np.zeros((1, hp.inter_channels, window), np.float32)
                    lo, hi = max(0, t_offset), min(full.shape[-1], t_offset + window)
                    if hi > lo:
                        win[:, :, lo - t_offset: hi - t_offset] = full[:, :, lo:hi]
                    audio = self._window(enc, self._to_device(win), self._filled(t_offset),
                                         self._filled(total), ns, window)
                return _HostCopy((audio,))

        emitted = 0
        fmt = self.audio_format

        def emit(k, audio_win):
            nonlocal emitted
            samples = audio_win[halo * hop: (halo + plan[k][1]) * hop]
            samples = samples[: y_len * hop - emitted].copy()
            chunk = AudioChunk(format=fmt, start_sample_index=emitted, samples=samples,
                               is_final=k == n_chunks - 1)
            emitted += len(samples)
            return chunk

        if use_head:
            yield emit(0, audio0[0])
            if n_chunks == 1:
                return
            pending, first = spec1, 1
        else:
            pending, first = dispatch(0), 0
        for k in range(first, n_chunks):
            nxt = dispatch(k + 1) if k + 1 < n_chunks else None
            (audio_win,) = pending.wait()
            pending = nxt
            yield emit(k, audio_win[0])

    def dispatch_stream_head(
        self,
        phoneme_ids: Sequence[int],
        *,
        c0: int,
        halo: int,
        noise_scale: Optional[float] = None,
        length_scale: Optional[float] = None,
        noise_w: Optional[float] = None,
        speaker_id: Optional[int] = None,
        seed: Optional[int] = None,
        speaker_mix: Optional[dict] = None,
    ):
        """Queue one stream's fused head (encode and the first `c0` emitted
        frames) and return at once, with no host read: (enc, audio0 (1,
        (c0 + 2 halo) * hop), the frame count clamped to >= 1 (0-d int64),
        the seed (0-d int64), noise_scale), the tensors on the device.
        Speaker conditioning bakes into `enc`, so the windows after it
        take none."""
        lengths, p_bucket, ids = self._validate_and_pad([list(phoneme_ids)], pad_batch=False)
        scales = self._scales(noise_scale, length_scale, noise_w)
        sid = self._sid_array([speaker_id] if speaker_id is not None else None, 1,
                              mixes=[speaker_mix] if speaker_mix is not None else None)
        seed_u = _seed_u32(self.options.seed if seed is None else seed)
        self._mark("stream_head", (p_bucket, c0, halo, self._sid_kind(sid)))
        with self._device_work():
            enc, audio0, total, seeds_d = self._head(ids, lengths, [seed_u], scales, sid,
                                                     c0 + 2 * halo, halo)
        return enc, audio0, total[0], seeds_d[0], scales[0]

    def dispatch_stream_head_batch(
        self,
        ids_batch: Sequence[Sequence[int]],
        *,
        c0: int,
        halo: int,
        seeds: Optional[Sequence[Optional[int]]] = None,
        noise_scales: Optional[Sequence[Optional[float]]] = None,
        length_scales: Optional[Sequence[Optional[float]]] = None,
        noise_ws: Optional[Sequence[Optional[float]]] = None,
        speaker_ids: Optional[Sequence[Optional[int]]] = None,
        speaker_mixes: Optional[Sequence[dict]] = None,
    ):
        """Queue B streams' fused heads as one batch and return at once.

        Rows bucket at the largest row's phoneme bucket (no batch-ladder
        rows are added: callers pad the row count). Row r equals
        dispatch_stream_head at seeds[r] when the row's own bucket is the
        same (the seeded duration noise spans the bucket). Returns (enc,
        audio0 (B, c0 * hop) cut to the emitted region on the device,
        totals (B,) int64 on the device, seed_vals, ns_vals), the last two
        the resolved per-row host values the windows reuse."""
        b = len(ids_batch)
        if b == 0:
            raise ValueError("empty batch")
        lengths, p_bucket, ids = self._validate_and_pad([list(r) for r in ids_batch],
                                                        pad_batch=False)
        scl = [self._scales(None if noise_scales is None else noise_scales[i],
                            None if length_scales is None else length_scales[i],
                            None if noise_ws is None else noise_ws[i]) for i in range(b)]
        ns_vals = [s[0] for s in scl]
        if speaker_ids is not None:
            speaker_ids = [0 if v is None else int(v) for v in speaker_ids]
        sid = self._sid_array(speaker_ids, b, mixes=self._pad_mixes(speaker_mixes, b, b))
        seed_vals = [_seed_u32(self.options.seed if seeds is None or seeds[i] is None
                               else seeds[i]) for i in range(b)]
        self._mark("stream_head_batch", (b, p_bucket, c0, halo, self._sid_kind(sid)))
        window, hop = c0 + 2 * halo, self.hparams.hop_length
        with self._device_work():
            scales = tuple(self._to_device(np.asarray([s[j] for s in scl], np.float32))
                           .view(b, 1, 1) for j in range(3))
            enc, audio0, totals, _ = self._head(ids, lengths, seed_vals, scales, sid, window,
                                                halo)
        return enc, audio0[:, halo * hop: (window - halo) * hop], totals, seed_vals, ns_vals

    def dispatch_window_batch(
        self,
        enc: vits.EncodeResult,
        seeds,         # (B,) seeds: a tensor on the device, or host ints
        t_offsets,     # (B,) window starts minus halo
        totals,        # (B,) each row's frame count (its virtual length)
        noise_scales,  # (B,)
        *,
        emit_frames: int,
        halo: int,
    ) -> torch.Tensor:
        """Queue one batched multi-stream window decode and return at once.

        `enc` holds rows of different utterances at one phoneme bucket. Row
        r decodes frames [t_offsets[r] + halo, t_offsets[r] + halo +
        emit_frames) of its own sequence, with the prior noise its stream
        sees alone; a row past its end comes back zero. Each per-row
        argument is a tensor on the device (used as it is) or host values
        (copied without a wait). Returns (B, emit_frames * hop) on the
        device: the halo is cut there."""
        window = emit_frames + 2 * halo
        b, hop = enc.m_p.shape[0], self.hparams.hop_length
        self._mark("stream_window", (b, enc.m_p.shape[-1], window, halo))
        with self._device_work():
            args = [self._device_rows(v, dt, b) for v, dt in (
                (seeds, np.int64), (t_offsets, np.int64), (totals, np.int64),
                (noise_scales, np.float32))]
            audio = self._window_keyed(enc, args[0], args[1].long(), args[2],
                                       args[3].view(b, 1, 1), window)
        return audio[:, halo * hop: (window - halo) * hop]
