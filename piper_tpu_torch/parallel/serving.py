"""Sharded batched synthesis across a mesh (counterpart of
piper_tpu.parallel.serving).

Weights are placed once: a copy per slot on dp/sp meshes (slots of one
device share it), channel shards under a tp axis (parallel/tp.py).
Utterance batches split their rows over the `dp` axis; each dp group runs
the whole graph on its slot's stream, so the groups overlap, and the rows
come back together on the first slot's device. On dp and sp slots the
vocoder runs the port's kernels on each slot's device; under tp (or with
use_pallas=False) it runs the tp forward's PyTorch convs.

The port compiles nothing, so the per-key caches of JAX's compiled
programs hold the built per-shape callables instead, and `builds` counts
how many were built (a repeated serving call builds none).

`synthesize_batch` and `synthesize_pipelined` draw their noise with
np.random.default_rng(seed) exactly as the JAX package does, and
`synthesize_long` its keyed noise from JAX's threefry (the runtime's
seeded_noise for the durations, per_frame_noise for the prior), so the
audio of each can be held against the JAX package's directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from piper_tpu_torch.models.vits import model as vits
from piper_tpu_torch.models.vits.hparams import VitsHParams, receptive_field_frames
from piper_tpu_torch.models.vits.params import Params
from piper_tpu_torch.ops.kernels.precision import tier_scope
from piper_tpu_torch.parallel import tp as tp_mod
from piper_tpu_torch.parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS, Mesh,
                                           cat_rows, run_slots, slice_rows)


@dataclass
class ShardedVits:
    """A VITS model placed on a mesh for data-parallel batched serving.

    `params` holds one weight dict per slot (flat slot order; `create`
    places them). Precision mirrors PiperRuntime: `precision` is the tier
    of the whole graph, `vocoder_precision` / `flow_precision` scope lower
    tiers to their stages. `use_pallas` None means the kernels on dp/sp
    meshes and never under tp (resolve_pallas_under_tp)."""

    mesh: Mesh
    params: List[Params]
    hp: VitsHParams
    precision: str = "highest"
    vocoder_precision: Optional[object] = None
    flow_precision: Optional[str] = None
    use_pallas: Optional[bool] = None
    specs: Optional[Dict[str, tuple]] = None

    def __post_init__(self) -> None:
        self._infer_fns: dict = {}
        self._sp_decode_fns: dict = {}
        self._pp_decode_fns: dict = {}
        self._enc_fns: dict = {}
        self.builds = 0
        self._tp_size = int(self.mesh.shape.get(TENSOR_AXIS, 1))
        self._pp_size = int(self.mesh.shape.get(PIPE_AXIS, 1))
        self.use_pallas = tp_mod.resolve_pallas_under_tp(self._tp_size, self.use_pallas)
        if self.use_pallas is None:
            self.use_pallas = True
        if self.specs is None:
            self.specs = {k: () for k in self.params[0]}

    @classmethod
    def create(cls, mesh: Mesh, params: Params, hp: VitsHParams, **options) -> "ShardedVits":
        """Place `params` (one weight dict, on any device) on the mesh."""
        return cls(mesh=mesh, params=tp_mod.place_params(params, mesh), hp=hp,
                   specs=tp_mod.param_specs(params, mesh), **options)

    # -- placement helpers ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.mesh.device(0)

    def _stages(self, dp: int = 0, sp: int = 0, use_pallas: Optional[bool] = None):
        """The decode stages of the slot group at (dp, sp): the model's own
        (the kernels) on the slot's weights, or the tp forward."""
        use = self.use_pallas if use_pallas is None else use_pallas
        if use and self._tp_size == 1:
            return vits.DecodeStages(self.params[self.mesh.index(dp=dp, sp=sp)])
        group = tp_mod.TPGroup.of(self.mesh, self.params, self.specs, dp=dp, sp=sp)
        return vits.DecodeStages(group, tp_mod.flow_reverse, tp_mod.hifigan_generator)

    def _dp_groups(self, b: int):
        dp = self.mesh.shape[DATA_AXIS]
        if b % dp != 0:
            raise ValueError(f"batch {b} not divisible by dp mesh size {dp}")
        rows = b // dp
        return [(d, d * rows, (d + 1) * rows) for d in range(dp)]

    def _built(self, cache: dict, key, fn):
        cache[key] = fn
        self.builds += 1
        return fn

    # -- fused whole-graph synthesis -----------------------------------------

    def infer_fn(self, max_frames: int, with_sid: bool = False):
        """The batch-sharded fused synthesis step for (max_frames, with_sid),
        cached: fn(ids, lengths, dp_noise, main_noise, scales[, sid]) ->
        (audio, y_len) on the first slot's device, rows split over dp."""
        if self._pp_size > 1:
            raise NotImplementedError(
                "fused whole-graph inference on a pipeline_parallel mesh "
                "would idle the pp devices; use synthesize_pipelined, or "
                "build the mesh with pipeline_parallel=1"
            )
        key = (int(max_frames), bool(with_sid))
        cached = self._infer_fns.get(key)
        if cached is not None:
            return cached
        hp = self.hp

        def step(ids, lengths, dp_noise, main_noise, scales, sid=None):
            ns, ls, nw = (float(v) for v in scales)
            groups = self._dp_groups(ids.shape[0])

            def run(k):
                d, lo, hi = groups[k]
                dev = self.mesh.device(self.mesh.index(dp=d))
                st = self._stages(dp=d)
                enc_params = self.params[self.mesh.index(dp=d)]
                return vits.infer(
                    enc_params, hp, slice_rows(ids, lo, hi, dev), slice_rows(lengths, lo, hi, dev),
                    slice_rows(dp_noise, lo, hi, dev), slice_rows(main_noise, lo, hi, dev),
                    max_frames=max_frames, noise_scale=ns, length_scale=ls, noise_w=nw,
                    sid=slice_rows(sid, lo, hi, dev) if with_sid else None,
                    vocoder_precision=self.vocoder_precision,
                    flow_precision=self.flow_precision, stages=st)

            with torch.inference_mode(), tier_scope(self.precision, self.device):
                outs = run_slots(self.mesh, [self.mesh.index(dp=d) for d, _, _ in groups], run)
                return cat_rows(outs, self.device)

        return self._built(self._infer_fns, key, step)

    def _noise(self, b: int, p: int, max_frames: int, seed: int):
        rng = np.random.default_rng(seed)
        dp_noise = rng.standard_normal((b, 2, p)).astype(np.float32)
        main_noise = rng.standard_normal((b, self.hp.inter_channels, max_frames)).astype(
            np.float32)
        return torch.from_numpy(dp_noise), torch.from_numpy(main_noise)

    def _host_in(self, a, dtype=torch.int64):
        return None if a is None else torch.as_tensor(np.asarray(a)).to(dtype)

    def synthesize_batch(
        self,
        ids: np.ndarray,
        lengths: np.ndarray,
        *,
        max_frames: int,
        scales: Tuple[float, float, float] = (0.667, 1.0, 0.8),
        sid: Optional[np.ndarray] = None,
        seed: int = 1234,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """numpy in, numpy out; the batch must be divisible by the dp mesh
        size. The noise is JAX's: default_rng(seed), dp noise then prior."""
        b, p = ids.shape
        dp_size = self.mesh.shape[DATA_AXIS]
        if b % dp_size != 0:
            raise ValueError(f"batch {b} not divisible by dp mesh size {dp_size}")
        dp_noise, main_noise = self._noise(b, p, max_frames, seed)
        fn = self.infer_fn(max_frames, with_sid=sid is not None)
        dev = self.device
        args = [self._host_in(ids).to(dev), self._host_in(lengths).to(dev), dp_noise.to(dev),
                main_noise.to(dev), tuple(float(s) for s in scales)]
        if sid is not None:
            args.append(self._host_in(sid).to(dev))
        audio, y_len = fn(*args)
        return audio.float().cpu().numpy(), y_len.cpu().numpy()

    # -- cached encoder ------------------------------------------------------

    def encode_fn(self, length_scale: float, noise_w: float, *, keyed: bool = False):
        """The encoder for these scales, cached.

        keyed=False: fn(ids, lengths, dp_noise, sid) with the caller's dp
        noise, rows split over dp. keyed=True: fn(ids, lengths, sid, seed)
        drawing one row-invariant dp noise from `seed` (the runtime's
        seeded draw), on the first slot."""
        key = (float(length_scale), float(noise_w), bool(keyed))
        cached = self._enc_fns.get(key)
        if cached is not None:
            return cached
        hp = self.hp
        ls, nw = float(length_scale), float(noise_w)

        def encode_rows(groups, ids, lengths, dp_noise, sid):
            def run(k):
                d, lo, hi = groups[k]
                dev = self.mesh.device(self.mesh.index(dp=d))
                return vits.encode(self.params[self.mesh.index(dp=d)], hp,
                                   slice_rows(ids, lo, hi, dev), slice_rows(lengths, lo, hi, dev),
                                   slice_rows(dp_noise, lo, hi, dev), length_scale=ls,
                                   noise_w=nw, sid=slice_rows(sid, lo, hi, dev))

            with torch.inference_mode(), tier_scope(self.precision, self.device):
                slots = [self.mesh.index(dp=d) for d, _, _ in groups]
                return cat_rows(run_slots(self.mesh, slots, run), self.device)

        if keyed:
            def enc_fn(ids, lengths, sid, seed):
                from piper_tpu_torch.engine.runtime import seeded_noise

                b, p = ids.shape
                dpn = seeded_noise(seed, 0, (2, p), b, self.device)
                return encode_rows([(0, 0, b)], ids, lengths, dpn, sid)
        else:
            def enc_fn(ids, lengths, dp_noise, sid):
                return encode_rows(self._dp_groups(ids.shape[0]), ids, lengths, dp_noise, sid)

        return self._built(self._enc_fns, key, enc_fn)

    # -- sequence-parallel decode (long outputs) -----------------------------

    def sp_decode_fn(self, span: int, halo: Optional[int] = None,
                     use_pallas: Optional[bool] = None):
        """The sequence-parallel decode over the `sp` axis for (span, halo),
        cached. Shard k of dp group 0 decodes frames [k * span, (k + 1) *
        span) with a halo of receptive_field_frames on each side through
        model.decode_window, its prior noise per_frame_noise(seed, frame),
        so shard boundaries are exact; the shards' audio concatenates along
        time. Returns fn(enc, seed, total_frames, noise_scale) -> audio
        (B, n_sp * span * hop)."""
        if self._tp_size > 1:
            raise NotImplementedError(
                "sequence-parallel decode needs replicated params; build the "
                "mesh with tensor_parallel=1 (tp composes with dp, not sp)"
            )
        if self._pp_size > 1:
            raise NotImplementedError(
                "sequence-parallel decode on a pipeline_parallel mesh would "
                "idle the pp devices; use synthesize_pipelined, or build the "
                "mesh with pipeline_parallel=1"
            )
        hp = self.hp
        h = receptive_field_frames(hp) if halo is None else int(halo)
        if use_pallas is None:
            use_pallas = self.use_pallas
        key = (int(span), h, bool(use_pallas))
        cached = self._sp_decode_fns.get(key)
        if cached is not None:
            return cached
        window = span + 2 * h
        hop = hp.hop_length
        n_sp = self.mesh.shape[SEQ_AXIS]

        def fn(enc, seed, total_frames, noise_scale):
            b, c = enc.m_p.shape[:2]

            def run(k):
                dev = self.mesh.device(self.mesh.index(sp=k))
                e = slice_rows(enc, 0, b, dev)
                t_offset = k * span - h
                t_idx = t_offset + torch.arange(window, device=dev)
                noise = vits.per_frame_noise(int(seed), t_idx, b, c)
                audio = vits.decode_window(
                    self.params[self.mesh.index(sp=k)], hp, e, noise, t_offset,
                    window=window, total_frames=int(total_frames),
                    noise_scale=float(noise_scale),
                    vocoder_precision=self.vocoder_precision,
                    flow_precision=self.flow_precision,
                    stages=self._stages(sp=k, use_pallas=use_pallas))
                return audio[:, h * hop:(h + span) * hop]

            with torch.inference_mode(), tier_scope(self.precision, self.device):
                slots = [self.mesh.index(sp=k) for k in range(n_sp)]
                parts = run_slots(self.mesh, slots, run)
                return torch.cat([a.to(self.device) for a in parts], dim=1)

        return self._built(self._sp_decode_fns, key, fn)

    # -- pipeline-parallel decode --------------------------------------------

    def pp_decode_fn(self, max_frames: int, rows_per_dp: int, with_g: bool = False,
                     microbatches: Optional[int] = None, noise_scale: float = 0.667):
        """The GPipe-style pipelined decode over the `pp` axis
        (parallel/pp.py) for this shape, cached.

        fn(params, m_p, logs_p, x_mask, w_ceil, main_noise[, g]) ->
        (audio, y_lengths), rows split over dp."""
        from piper_tpu_torch.parallel.pp import build_pp_decode, default_microbatches

        if self._tp_size > 1:
            raise NotImplementedError(
                "pipeline-parallel decode needs replicated params; build the "
                "mesh with tensor_parallel=1 (pp composes with dp, not tp)")
        if int(self.mesh.shape.get(PIPE_AXIS, 1)) < 2:
            raise ValueError("mesh has no pp axis; build it with "
                             "pipeline_parallel >= 2")
        # Resolve the default BEFORE keying, so microbatches=None and an
        # explicit value equal to the default share one callable.
        if microbatches is None:
            microbatches = default_microbatches(int(rows_per_dp),
                                                int(self.mesh.shape[PIPE_AXIS]))
        key = (int(max_frames), int(rows_per_dp), bool(with_g), int(microbatches),
               float(noise_scale))
        cached = self._pp_decode_fns.get(key)
        if cached is not None:
            return cached
        call = build_pp_decode(
            self.mesh, self.hp, max_frames=max_frames, rows_per_dp=rows_per_dp,
            microbatches=microbatches, with_g=with_g, noise_scale=noise_scale,
            vocoder_precision=self.vocoder_precision, flow_precision=self.flow_precision,
            precision=self.precision)

        def fn(*args):
            with torch.inference_mode():
                return call(*args)

        return self._built(self._pp_decode_fns, key, fn)

    def synthesize_pipelined(
        self,
        ids: np.ndarray,
        lengths: np.ndarray,
        *,
        max_frames: int,
        scales: Tuple[float, float, float] = (0.667, 1.0, 0.8),
        sid: Optional[np.ndarray] = None,
        seed: int = 1234,
        microbatches: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode (rows split over dp), then decode through the stage
        pipeline. The noise is synthesize_batch's, so at equal (ids, seed,
        max_frames) the pipelined audio equals the fused audio to float
        associativity."""
        b, p = ids.shape
        dp_size = self.mesh.shape[DATA_AXIS]
        if b % dp_size != 0:
            raise ValueError(f"batch {b} not divisible by dp mesh size {dp_size}")
        ns, ls, nw = scales
        dp_noise, main_noise = self._noise(b, p, max_frames, seed)
        dev = self.device
        enc = self.encode_fn(ls, nw)(
            self._host_in(ids).to(dev), self._host_in(lengths).to(dev), dp_noise.to(dev),
            None if sid is None else self._host_in(sid).to(dev))
        fn = self.pp_decode_fn(max_frames, b // dp_size, with_g=enc.g is not None,
                               microbatches=microbatches, noise_scale=ns)
        audio, y_len = fn(self.params, enc.m_p, enc.logs_p, enc.x_mask, enc.w_ceil,
                          main_noise.to(dev), enc.g)
        return audio.float().cpu().numpy(), y_len.cpu().numpy()

    def synthesize_long(
        self,
        ids: np.ndarray,
        lengths: np.ndarray,
        *,
        span: int,
        scales: Tuple[float, float, float] = (0.667, 1.0, 0.8),
        seed: int = 1234,
        sid: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode once (on the first slot), then decode with the frame axis
        sharded over `sp`. Covers total_frames = n_sp * span."""
        if self._tp_size > 1:
            # Fail before the encoder runs.
            raise NotImplementedError(
                "sequence-parallel decode needs replicated params; build the "
                "mesh with tensor_parallel=1 (tp composes with dp, not sp)"
            )
        ns, ls, nw = scales
        dev = self.device
        enc = self.encode_fn(ls, nw, keyed=True)(
            self._host_in(ids).to(dev), self._host_in(lengths).to(dev),
            None if sid is None else self._host_in(sid).to(dev), seed)
        total = self.mesh.shape[SEQ_AXIS] * span
        audio = self.sp_decode_fn(span)(enc, seed, total, ns)
        y_len = np.clip(enc.y_total.cpu().numpy().astype(np.int64), 1, total)
        return audio.float().cpu().numpy(), y_len
