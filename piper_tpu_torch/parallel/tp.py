"""Tensor parallelism: channel-sharded vocoder and flow weights over the `tp`
mesh axis (counterpart of piper_tpu.parallel.tp).

The rule table is JAX's: Megatron-style column/row splits of the named
weights, each checked for divisibility (a channel axis the tp size does not
divide stays replicated):

- `dec.conv_pre` / `dec.cond`: column-parallel (output channels sharded);
- `dec.ups.{i}` (conv-transpose weight (C_in, C_out, K)): column on C_out;
- ResBlock1 pairs: `convs1` column, `convs2` row (C_in sharded, the bias
  added once after the sum); ResBlock2's single conv (`convs`) column;
- `dec.conv_post`: row-parallel (it reduces C -> 1);
- flow WaveNet layers: `in_layers` column, `res_skip_layers` row.

The text encoder and the duration predictor stay replicated.

In JAX GSPMD wrote the collectives; here `hifigan_generator` and
`flow_reverse` are the tp forward, built from the blocks of
models/vits/{hifigan,flows}.py in the same op order. A column-parallel conv
runs on each slot's channel shard; a row-parallel conv gives each slot a
partial sum, and the partial sums are added in slot order on the group's
first slot, the bias once after the sum; activations are gathered there
where the next conv needs every channel. Work that is not sharded (masks,
the gate, the residual adds, unsharded convs) runs on the first slot. The
per-slot convs run on the slots' streams (`mesh.run_slots`). The kernels are
single-device programs that the split does not reach, so under tp the
vocoder runs PyTorch's convs (`resolve_pallas_under_tp`), as JAX's does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.ops.conv import conv1d, conv1d_same, conv_transpose1d
from piper_tpu_torch.ops.kernels.precision import tier_scope
from piper_tpu_torch.ops.nn import fused_add_tanh_sigmoid_multiply, leaky_relu
from piper_tpu_torch.parallel.mesh import TENSOR_AXIS, Mesh, run_slots

LRELU_SLOPE = 0.1

Spec = tuple  # one entry per weight axis: TENSOR_AXIS or None; () = replicated


def _spec_for(name: str, shape, tp: int) -> Spec:
    """Megatron column/row spec for one named weight, or replicated ()."""

    def col(axis: int) -> Spec:
        if shape[axis] % tp != 0:
            return ()
        spec = [None] * len(shape)
        spec[axis] = TENSOR_AXIS
        return tuple(spec)

    parts = name.split(".")
    leaf = parts[-1]  # "weight" | "bias"
    if name.startswith("dec."):
        kind = parts[1]
        if kind in ("conv_pre", "cond"):
            return col(0)
        if kind == "ups":
            return col(1) if leaf == "weight" else col(0)
        if kind == "resblocks":
            conv = parts[3]
            if conv in ("convs1", "convs"):
                return col(0)
            if conv == "convs2":
                return col(1) if leaf == "weight" else ()
        if kind == "conv_post":
            return col(1) if leaf == "weight" else ()
        return ()
    if ".enc.in_layers." in name:
        return col(0)
    if ".enc.res_skip_layers." in name:
        return col(1) if leaf == "weight" else ()
    return ()


def resolve_pallas_under_tp(tp_size: int, requested):
    """The one place the "tp disables the kernels" rule lives: the kernels
    are single-device programs that the channel split does not reach, so
    under tp the convs stay PyTorch's. An EXPLICIT use_pallas=True request
    is a contradiction and raises rather than being silently ignored;
    None/False pass through (None resolves to False)."""
    if tp_size <= 1:
        return requested
    if requested:
        raise ValueError(
            "use_pallas=True is impossible on a tensor-parallel mesh: the "
            "kernels are single-device programs that the channel split does not "
            "reach; drop use_pallas or build the mesh with tensor_parallel=1"
        )
    return False


class Sharding:
    """One weight's placement on a mesh: its spec, and `place` giving each
    slot its shard (the slot's tp index picks the piece)."""

    def __init__(self, mesh: Mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def is_fully_replicated(self) -> bool:
        return all(ax is None for ax in self.spec)

    def place(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x's shard on every slot, in flat slot order."""
        tp = self.mesh.shape[TENSOR_AXIS]
        axis = next((i for i, ax in enumerate(self.spec) if ax == TENSOR_AXIS), None)
        pieces = [x] * tp if axis is None else list(torch.chunk(x, tp, dim=axis))
        copies: dict = {}
        out = []
        for slot in range(self.mesh.size):
            t = self.mesh.coords(slot)[2] if axis is not None else 0
            dev = self.mesh.device(slot)
            key = (dev, t)  # one copy of a piece per device
            if key not in copies:
                copies[key] = pieces[t].contiguous().to(dev)
            out.append(copies[key])
        return out

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"


def tp_param_shardings(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, Sharding]:
    """Per-weight Shardings: tp-sharded vocoder/flow channels, everything
    else replicated over every slot."""
    tp = int(mesh.shape.get(TENSOR_AXIS, 1))
    return {name: Sharding(mesh, _spec_for(name, arr.shape, tp) if tp > 1 else ())
            for name, arr in params.items()}


def param_specs(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, Spec]:
    """{name: spec} of tp_param_shardings."""
    return {name: sh.spec for name, sh in tp_param_shardings(params, mesh).items()}


def place_params(params: Dict[str, torch.Tensor], mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """One weight dict per slot (flat order): each slot's shards under tp,
    copies otherwise (shared by the slots of one device)."""
    slots: List[Dict[str, torch.Tensor]] = [{} for _ in range(mesh.size)]
    for name, sh in tp_param_shardings(params, mesh).items():
        for slot, t in enumerate(sh.place(params[name])):
            slots[slot][name] = t
    return slots


class TPGroup:
    """The slots of one tp group and their weight dicts: the `params` the
    tp `flow_reverse` and `hifigan_generator` read (model.DecodeStages).
    Indexing reads the first slot's tensor."""

    def __init__(self, mesh: Mesh, slots: Sequence[int], slot_params: Sequence[dict],
                 specs: Dict[str, Spec]):
        self.mesh = mesh
        self.slots = list(slots)
        self.params = list(slot_params)
        self.specs = specs
        self.device = mesh.device(self.slots[0])

    @classmethod
    def of(cls, mesh: Mesh, slot_params: Sequence[dict], specs: Dict[str, Spec],
           dp: int = 0, sp: int = 0, pp: int = 0) -> "TPGroup":
        """The tp group at (dp, sp, pp) of a mesh whose slot weights are
        `slot_params` (place_params' list) under `specs` (param_specs')."""
        slots = [mesh.index(dp=dp, sp=sp, tp=t, pp=pp) for t in range(mesh.shape[TENSOR_AXIS])]
        return cls(mesh, slots, [slot_params[s] for s in slots], specs)

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.params[0][key]

    def __contains__(self, key: str) -> bool:
        return key in self.params[0]

    # -- the collectives and the per-slot convs ----------------------------

    def sharded(self, name: str) -> bool:
        return any(ax == TENSOR_AXIS for ax in self.specs.get(name, ()))

    def each(self, fn) -> list:
        """fn(t) on every slot t of the group, on its stream."""
        return run_slots(self.mesh, self.slots, fn)

    def to_slot(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return x.to(self.mesh.device(self.slots[t]))

    def gather(self, x) -> torch.Tensor:
        """A channel-sharded activation (one piece per slot) gathered on
        the first slot; a full one as it is."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.cat([p.to(self.device) for p in x], dim=1)

    def col(self, x: torch.Tensor, prefix: str, conv, **kw):
        """A column-parallel conv of the full activation `x`: one output
        channel shard per slot, or one full output where not sharded."""
        w, b = f"{prefix}.weight", f"{prefix}.bias"
        if not self.sharded(w):
            return conv(x, self[w], self[b], **kw)
        return self.each(lambda t: conv(self.to_slot(x, t), self.params[t][w],
                                        self.params[t][b], **kw))

    def row(self, x, prefix: str, conv, **kw) -> torch.Tensor:
        """A row-parallel conv: each slot convolves its input-channel shard
        (its piece of a sharded `x`, or its slice of a full one) into a
        partial sum; the sums are added in slot order and the bias once."""
        w, b = f"{prefix}.weight", f"{prefix}.bias"
        if not self.sharded(w):
            return conv(self.gather(x), self[w], self[b], **kw)
        if isinstance(x, torch.Tensor):
            c = self.params[0][w].shape[1]
            pieces = [x[:, t * c:(t + 1) * c] for t in range(len(self.slots))]
        else:
            pieces = x
        partial = self.each(lambda t: conv(self.to_slot(pieces[t], t), self.params[t][w],
                                           None, **kw))
        acc = partial[0].to(self.device)
        for p in partial[1:]:
            acc = acc + p.to(self.device)
        return acc + self[b][None, :, None]


# --------------------------------------------------------------------------
# The tp forward (the flows' WaveNet and the HiFi-GAN generator)
# --------------------------------------------------------------------------


def _wavenet(x, x_mask, T: TPGroup, prefix: str, *, hidden_channels: int, n_layers: int,
             dilation_rate: int, g=None):
    """models/vits/flows.wavenet with in_layers column- and res_skip_layers
    row-parallel: the gate needs both halves of in_layers' output, so the
    pieces are gathered before it."""
    output = torch.zeros_like(x)
    g_all = None
    if g is not None:
        g_all = conv1d(g, T[f"{prefix}.cond_layer.weight"], T[f"{prefix}.cond_layer.bias"])
    for i in range(n_layers):
        x_in = T.gather(T.col(x, f"{prefix}.in_layers.{i}", conv1d_same,
                              dilation=dilation_rate**i))
        if g_all is not None:
            g_l = g_all[:, i * 2 * hidden_channels: (i + 1) * 2 * hidden_channels]
        else:
            g_l = torch.zeros_like(x_in)
        acts = fused_add_tanh_sigmoid_multiply(x_in, g_l, hidden_channels)
        res_skip = T.row(acts, f"{prefix}.res_skip_layers.{i}", conv1d)
        if i < n_layers - 1:
            x = (x + res_skip[:, :hidden_channels]) * x_mask
            output = output + res_skip[:, hidden_channels:]
        else:
            output = output + res_skip
    return output * x_mask


def flow_reverse(z_p: torch.Tensor, y_mask: torch.Tensor, params: TPGroup, hp: VitsHParams,
                 g: Optional[torch.Tensor] = None, prefix: str = "flow") -> torch.Tensor:
    """models/vits/flows.flow_reverse over a tp group."""
    T = params
    z = z_p
    for i in reversed(range(hp.flow_n_flows)):
        z = torch.flip(z, dims=[1])
        p = f"{prefix}.flows.{2 * i}"
        half = z.shape[1] // 2
        x0, x1 = z[:, :half], z[:, half:]
        h = conv1d(x0, T[f"{p}.pre.weight"], T[f"{p}.pre.bias"]) * y_mask
        h = _wavenet(h, y_mask, T, f"{p}.enc", hidden_channels=hp.flow_hidden_channels,
                     n_layers=hp.flow_n_layers, dilation_rate=hp.flow_dilation_rate, g=g)
        m = conv1d(h, T[f"{p}.post.weight"], T[f"{p}.post.bias"]) * y_mask
        z = torch.cat([x0, (x1 - m) * y_mask], dim=1)
    return z


def _lrelu_masked(x, m):
    xt = leaky_relu(x, LRELU_SLOPE)
    return xt if m is None else xt * m


def hifigan_generator(
    z: torch.Tensor,
    params: TPGroup,
    hp: VitsHParams,
    g: Optional[torch.Tensor] = None,
    prefix: str = "dec",
    level_precisions: Optional[Union[str, Sequence[Optional[str]]]] = None,
    t_mask: Optional[torch.Tensor] = None,
    t_bounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """models/vits/hifigan.hifigan_generator over a tp group, on the
    unfused path of PyTorch convs: `t_mask` masks every conv's input, and
    `t_bounds` (the kernels' form of the same mask) is not needed."""
    del t_bounds
    T = params
    if level_precisions is None or isinstance(level_precisions, str):
        lp = [level_precisions] * hp.num_upsamples
    else:
        lp = list(level_precisions)
    if len(lp) != hp.num_upsamples:
        raise ValueError(f"level_precisions has {len(lp)} entries for "
                         f"{hp.num_upsamples} upsample levels")
    if z.dtype == torch.bfloat16:
        lp = ["bfloat16" if t is None else t for t in lp]
    dev = z.device
    m = t_mask
    p = prefix

    def masked(x):
        return x if m is None else x * m

    with tier_scope(lp[0], dev):
        x = T.col(masked(z), f"{p}.conv_pre", conv1d, padding=3)
        if g is not None:
            c = T.col(g, f"{p}.cond", conv1d)
            if isinstance(x, torch.Tensor) and isinstance(c, torch.Tensor):
                x = x + c
            else:
                x = T.gather(x) + T.gather(c)
        x = T.gather(x)

    nk = hp.num_resblock_kernels
    use_resblock2 = f"{p}.resblocks.0.convs.0.weight" in T
    for i in range(hp.num_upsamples):
        with tier_scope(lp[i], dev):
            x = leaky_relu(masked(x), LRELU_SLOPE)
            k, u = hp.upsample_kernel_sizes[i], hp.upsample_rates[i]
            x = T.gather(T.col(masked(x), f"{p}.ups.{i}", conv_transpose1d, stride=u,
                               padding=(k - u) // 2))
            if m is not None:
                m = torch.repeat_interleave(m, u, dim=2)
                x = x * m
            acc = None
            for j in range(nk):
                rb = f"{p}.resblocks.{i * nk + j}"
                y = x
                for mi, d in enumerate(hp.resblock_dilation_sizes[j]):
                    if use_resblock2:
                        yt = T.col(_lrelu_masked(y, m), f"{rb}.convs.{mi}", conv1d_same,
                                   dilation=d)
                        y = y + T.gather(yt)
                        continue
                    yt = T.col(_lrelu_masked(y, m), f"{rb}.convs1.{mi}", conv1d_same,
                               dilation=d)
                    if isinstance(yt, torch.Tensor):
                        yt = _lrelu_masked(yt, m)
                    else:
                        ms = [None if m is None else T.to_slot(m, t) for t in range(len(yt))]
                        yt = T.each(lambda t: _lrelu_masked(yt[t], ms[t]))
                    y = y + T.row(yt, f"{rb}.convs2.{mi}", conv1d_same)
                acc = y if acc is None else acc + y
            x = acc / nk

    with tier_scope(lp[-1], dev):
        x = leaky_relu(masked(x))  # final activation: torch default slope 0.01
        x = T.row(masked(x), f"{p}.conv_post", conv1d, padding=3)
    out = torch.tanh(x)
    return out if m is None else out * m
