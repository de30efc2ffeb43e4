"""A voice's weights, drawn from the run's seed, and the checkpoint the
program loads them from.

`leaves(hp)` is the weight layout of a Piper VITS inference graph: a frozen
copy of `piper_tpu_torch/models/vits/synthetic.py::synthetic_params` at
commit 1fc906d (names, shapes, order and fan-in scales), with its draws
replaced: `draw` makes the random leaves from two normal draws of a
`torch.Generator` on the run's device (the text side from the
configuration's pace seed, the rest from the run's seed), scaled per leaf
in one product, and copies them to the host once. `write_voice` writes the
checkpoint with a minimal protobuf encoder: a frozen copy of the fields
`piper_tpu_torch/onnx/{writer,wire}.py` emit at commit 1fc906d (model,
graph, initializers as raw data, the Conv/ConvTranspose attribute nodes
of `synthetic._stub_nodes`, the I/O signature), and the voice's JSON
config. The program loads the pair through its own loader; the reference
takes the same numpy arrays.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

# (name, shape, kind, scale): kind "normal" (times scale), "ones" or "zeros".
Leaf = Tuple[str, Tuple[int, ...], str, float]


def leaves(hp: dict) -> List[Leaf]:
    out: List[Leaf] = []

    def add(name, *shape, s=None):
        if s is None:
            s = 1.0 / math.sqrt(math.prod(shape[1:])) if len(shape) >= 2 else 0.02
        out.append((name, tuple(shape), "normal", float(s)))

    def norm(prefix, ch):
        out.append((f"{prefix}.gamma", (ch,), "ones", 1.0))
        out.append((f"{prefix}.beta", (ch,), "zeros", 0.0))

    H, Fc, inter = hp["hidden_channels"], hp["filter_channels"], hp["inter_channels"]
    kch = H // hp["n_heads"]
    add("enc_p.emb.weight", hp["n_vocab"], H, s=float(H) ** -0.5)
    for i in range(hp["n_layers"]):
        a = f"enc_p.encoder.attn_layers.{i}"
        add(f"{a}.emb_rel_k", 1, 2 * hp["window_size"] + 1, kch)
        add(f"{a}.emb_rel_v", 1, 2 * hp["window_size"] + 1, kch)
        for c in ("conv_q", "conv_k", "conv_v", "conv_o"):
            add(f"{a}.{c}.weight", H, H, 1)
            add(f"{a}.{c}.bias", H)
        for n_ in ("norm_layers_1", "norm_layers_2"):
            norm(f"enc_p.encoder.{n_}.{i}", H)
        f = f"enc_p.encoder.ffn_layers.{i}"
        add(f"{f}.conv_1.weight", Fc, H, hp["kernel_size"])
        add(f"{f}.conv_1.bias", Fc)
        add(f"{f}.conv_2.weight", H, Fc, hp["kernel_size"])
        add(f"{f}.conv_2.bias", H)
    add("enc_p.proj.weight", 2 * inter, H, 1)
    add("enc_p.proj.bias", 2 * inter)

    dF, dk = hp["dp_filter_channels"], hp["dp_kernel_size"]

    def add_dds(prefix, ch):
        for i in range(3):
            add(f"{prefix}.convs_sep.{i}.weight", ch, 1, dk)
            add(f"{prefix}.convs_sep.{i}.bias", ch)
            add(f"{prefix}.convs_1x1.{i}.weight", ch, ch, 1)
            add(f"{prefix}.convs_1x1.{i}.bias", ch)
            for n_ in ("norms_1", "norms_2"):
                norm(f"{prefix}.{n_}.{i}", ch)

    add("dp.pre.weight", dF, H, 1)
    add("dp.pre.bias", dF)
    add_dds("dp.convs", dF)
    add("dp.proj.weight", dF, dF, 1)
    add("dp.proj.bias", dF)
    add("dp.flows.0.m", 2, 1, s=0.05)
    add("dp.flows.0.logs", 2, 1, s=0.05)
    nb = hp["dp_num_bins"]
    for i in range(hp["dp_n_flows"]):
        cf = f"dp.flows.{2 * i + 1}"
        add(f"{cf}.pre.weight", dF, 1, 1)
        add(f"{cf}.pre.bias", dF)
        add_dds(f"{cf}.convs", dF)
        add(f"{cf}.proj.weight", 3 * nb - 1, dF, 1)
        add(f"{cf}.proj.bias", 3 * nb - 1)

    fH, half = hp["flow_hidden_channels"], inter // 2
    for i in range(hp["flow_n_flows"]):
        rc = f"flow.flows.{2 * i}"
        add(f"{rc}.pre.weight", fH, half, 1)
        add(f"{rc}.pre.bias", fH)
        for j in range(hp["flow_n_layers"]):
            add(f"{rc}.enc.in_layers.{j}.weight", 2 * fH, fH, hp["flow_kernel_size"])
            add(f"{rc}.enc.in_layers.{j}.bias", 2 * fH)
            out_ch = 2 * fH if j < hp["flow_n_layers"] - 1 else fH
            add(f"{rc}.enc.res_skip_layers.{j}.weight", out_ch, fH, 1)
            add(f"{rc}.enc.res_skip_layers.{j}.bias", out_ch)
        add(f"{rc}.post.weight", half, fH, 1)
        add(f"{rc}.post.bias", half)

    U0 = hp["upsample_initial_channel"]
    add("dec.conv_pre.weight", U0, inter, 7)
    add("dec.conv_pre.bias", U0)
    ch, nk = U0, len(hp["resblock_kernel_sizes"])
    for i, k in enumerate(hp["upsample_kernel_sizes"]):
        ch_out = U0 // (2 ** (i + 1))
        add(f"dec.ups.{i}.weight", ch, ch_out, k)
        add(f"dec.ups.{i}.bias", ch_out)
        for j, kj in enumerate(hp["resblock_kernel_sizes"]):
            rb = f"dec.resblocks.{i * nk + j}"
            for m in range(len(hp["resblock_dilation_sizes"][j])):
                convs = ("convs",) if hp["resblock"] == "2" else ("convs1", "convs2")
                for conv in convs:
                    add(f"{rb}.{conv}.{m}.weight", ch_out, ch_out, kj)
                    add(f"{rb}.{conv}.{m}.bias", ch_out)
        ch = ch_out
    add("dec.conv_post.weight", 1, ch, 7)
    add("dec.conv_post.bias", 1)
    return out


# The text side: its weights set each phoneme's duration, and so how much
# audio, and work, a request makes.
PACE = ("enc_p.", "dp.")


def draw(hp: dict, seed: int, device, pace_seed: int) -> Dict[str, np.ndarray]:
    """Every leaf: the text side's (PACE) from the configuration's
    `pace_seed`, so that every run's voice speaks at the same pace and
    does the same work, the rest (flows, vocoder) from the run's `seed`.
    Each part is one normal draw on `device`, scaled per leaf in one
    product; one copy to the host."""
    specs = leaves(hp)
    rand = [(n, s, sc) for n, s, kind, sc in specs if kind == "normal"]
    parts = ([r for r in rand if r[0].startswith(PACE)],
             [r for r in rand if not r[0].startswith(PACE)])
    bufs = []
    for part, sd in zip(parts, (pace_seed, seed)):
        sizes = [math.prod(s) for _, s, _ in part]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(sd) % (1 << 63))
        buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
        scales = torch.tensor([sc for _, _, sc in part], dtype=torch.float32, device=device)
        bufs.append(buf * torch.repeat_interleave(scales, torch.tensor(sizes, device=device)))
    host = torch.cat(bufs).cpu().numpy()
    order = parts[0] + parts[1]
    starts = np.cumsum([0] + [math.prod(s) for _, s, _ in order])
    at = {n: (starts[i], starts[i + 1]) for i, (n, _, _) in enumerate(order)}
    out: Dict[str, np.ndarray] = {}
    for name, shape, kind, _ in specs:
        if kind == "normal":
            lo, hi = at[name]
            out[name] = host[lo:hi].reshape(shape)
        else:
            out[name] = (np.ones if kind == "ones" else np.zeros)(shape, np.float32)
    return out


# -- the checkpoint: protobuf wire format ---------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload) -> List[bytes]:
    return [_key(field, 2), _varint(len(payload)), payload]


def _int_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _packed(field: int, values) -> List[bytes]:
    return _len_field(field, b"".join(_varint(int(v)) for v in values))


_FLOAT, _INT64 = 1, 7  # TensorProto data types
_ATTR_INT, _ATTR_INTS = 2, 7


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    parts = []
    if arr.ndim:
        parts += _packed(1, arr.shape)
    parts.append(_int_field(2, _FLOAT))
    parts += _len_field(8, name.encode())
    parts += _len_field(9, arr.tobytes())
    return b"".join(parts)


def _attribute(name: str, value) -> bytes:
    parts = _len_field(1, name.encode())
    if isinstance(value, int):
        parts += [_int_field(3, value), _int_field(20, _ATTR_INT)]
    else:
        parts += _packed(8, value) + [_int_field(20, _ATTR_INTS)]
    return b"".join(parts)


def _node(op: str, inputs, outputs, **attrs) -> bytes:
    parts = []
    for i in inputs:
        parts += _len_field(1, i.encode())
    for o in outputs:
        parts += _len_field(2, o.encode())
    parts += _len_field(4, op.encode())
    for k, v in attrs.items():
        parts += _len_field(5, _attribute(k, v))
    return b"".join(parts)


def _value_info(name: str, elem: int, shape) -> bytes:
    dims = b""
    for d in shape:
        dim = _int_field(1, d) if isinstance(d, int) else b"".join(_len_field(2, d.encode()))
        dims += b"".join(_len_field(1, dim))
    tensor_type = _int_field(1, elem) + b"".join(_len_field(2, dims))
    type_proto = b"".join(_len_field(1, tensor_type))
    return b"".join(_len_field(1, name.encode()) + _len_field(2, type_proto))


def _nodes(hp: dict) -> List[bytes]:
    """The nodes whose attributes the program's loader derives the
    architecture from (strides, pads and dilations), as _stub_nodes."""
    nodes = [_node("Gather", ["enc_p.emb.weight", "input"], ["emb_out"], axis=0)]
    nk = len(hp["resblock_kernel_sizes"])
    key = "convs" if hp["resblock"] == "2" else "convs1"
    for i, (k, u) in enumerate(zip(hp["upsample_kernel_sizes"], hp["upsample_rates"])):
        pad = (k - u) // 2
        nodes.append(_node("ConvTranspose", [f"up_in_{i}", f"dec.ups.{i}.weight",
                                             f"dec.ups.{i}.bias"], [f"up_out_{i}"],
                           strides=[u], pads=[pad, pad], kernel_shape=[k], group=1,
                           dilations=[1]))
        for j, kj in enumerate(hp["resblock_kernel_sizes"]):
            rb = f"dec.resblocks.{i * nk + j}"
            for m, d in enumerate(hp["resblock_dilation_sizes"][j]):
                nodes.append(_node("Conv", [f"rb_in_{i}_{j}_{m}", f"{rb}.{key}.{m}.weight",
                                            f"{rb}.{key}.{m}.bias"], [f"rb_out_{i}_{j}_{m}"],
                                   dilations=[d], pads=[(kj - 1) // 2 * d] * 2,
                                   kernel_shape=[kj], strides=[1], group=1))
    for i in range(hp["flow_n_flows"]):
        rc = f"flow.flows.{2 * i}"
        for j in range(hp["flow_n_layers"]):
            d = hp["flow_dilation_rate"] ** j
            k = hp["flow_kernel_size"]
            nodes.append(_node("Conv", [f"wn_in_{i}_{j}", f"{rc}.enc.in_layers.{j}.weight",
                                        f"{rc}.enc.in_layers.{j}.bias"], [f"wn_out_{i}_{j}"],
                               dilations=[d], pads=[(k - 1) // 2 * d] * 2, kernel_shape=[k],
                               strides=[1], group=1))
    return nodes


def write_voice(directory: Path, name: str, hp: dict, inference: dict,
                weights: Dict[str, np.ndarray]) -> Tuple[Path, Path]:
    """`<name>.onnx` and `<name>.onnx.json` in `directory`."""
    directory.mkdir(parents=True, exist_ok=True)
    model_path, config_path = directory / f"{name}.onnx", directory / f"{name}.onnx.json"
    graph: List[bytes] = []
    for n in _nodes(hp):
        graph += _len_field(1, n)
    graph += _len_field(2, name.encode())
    for k, arr in weights.items():
        graph += _len_field(5, _tensor(k, arr))
    for vi in (_value_info("input", _INT64, [1, "P"]), _value_info("input_lengths", _INT64, [1]),
               _value_info("scales", _FLOAT, [3])):
        graph += _len_field(11, vi)
    graph += _len_field(12, _value_info("output", _FLOAT, [1, 1, 1, "T"]))
    graph_bytes = b"".join(graph)
    opset = b"".join(_len_field(1, b"") + [_int_field(2, 15)])
    model = [_int_field(1, 8)] + _len_field(2, b"piper-tpu") + _len_field(7, graph_bytes) + \
        _len_field(8, opset)
    tmp = model_path.with_suffix(".onnx.tmp")
    with open(tmp, "wb") as f:
        for part in model:
            f.write(part)
    tmp.replace(model_path)
    id_map = {"_": [0], "^": [1], "$": [2]}
    for i, ch in enumerate("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"):
        if 3 + i < hp["n_vocab"]:
            id_map[ch] = [3 + i]
    config = {
        "audio": {"sample_rate": hp["sample_rate"], "quality": name},
        "espeak": {"voice": "en-gb-x-rp"},
        "inference": dict(inference),
        "phoneme_type": "espeak",
        "phoneme_id_map": id_map,
        "num_symbols": hp["n_vocab"],
        "num_speakers": hp["n_speakers"],
        "language": {"code": "en_GB"},
        "dataset": "synthetic",
        "piper_version": "synthetic",
    }
    config_path.write_text(json.dumps(config, indent=1), encoding="utf-8")
    return model_path, config_path
