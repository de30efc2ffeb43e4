"""Parameter store: the checkpoint's named weights as one flat dict of tensors.

Keys are the exported PyTorch parameter paths (`enc_p.*`, `dp.*`, `flow.*`,
`dec.*`, `emb_g.*`), the same names piper_tpu's modules cite, so every port
module reads the weights its JAX counterpart reads. This module is jax-free
(piper_tpu.models.vits.params imports jax.numpy at its top).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from piper_tpu.onnx.ir import OnnxGraph, TensorDataType

Params = Dict[str, torch.Tensor]

_FLOAT_TYPES = (TensorDataType.FLOAT, TensorDataType.DOUBLE, TensorDataType.FLOAT16)


def _constant_weights(graph: OnnxGraph):
    """Float weights that a real torch export emitted as Constant NODES
    instead of initializers (constant folding moves some module parameters
    — layer-norm gammas/betas in particular — out of the initializer list).
    Yields (param_path, OnnxTensor) for Constant outputs named like
    exported module parameters."""
    for n in graph.nodes:
        if n.op_type != "Constant" or not n.outputs:
            continue
        attr = n.attributes.get("value")
        if attr is None or not hasattr(attr.value, "data_type"):
            continue
        t = attr.value
        name = n.outputs[0]
        looks_like_param = "." in name and name.split(".", 1)[0] in (
            "enc_p", "dp", "flow", "dec", "emb_g")
        if looks_like_param and t.data_type in _FLOAT_TYPES:
            yield name, t


def host_arrays_from_graph(graph: OnnxGraph) -> Dict[str, np.ndarray]:
    """Float weights (initializers + parameter-named Constant nodes) as host
    numpy arrays. Non-float initializers (shape constants, the baked `sid`)
    are skipped: the native forward pass does not use them."""
    out: Dict[str, np.ndarray] = {}
    for name, t in graph.initializers.items():
        if t.data_type in _FLOAT_TYPES:
            out[name] = np.asarray(t.array)
    for name, t in _constant_weights(graph):
        out.setdefault(name, np.asarray(t.array))
    return out


def params_to_torch(
    arrays: Dict[str, np.ndarray], device, dtype: torch.dtype = torch.float32
) -> Params:
    """Host arrays -> one flat dict of `device` tensors, uploaded once.

    All arrays are packed into one host buffer and copied in ONE transfer;
    each parameter is then a contiguous view of that device buffer (a real
    checkpoint has ~500 arrays: one copy each would pay ~500 transfers)."""
    names = sorted(arrays)
    host = [np.ascontiguousarray(arrays[n], dtype=np.float32).ravel() for n in names]
    flat = torch.from_numpy(np.concatenate(host) if host else np.zeros(0, np.float32))
    buf = flat.to(device=device, dtype=dtype)
    out: Params = {}
    offset = 0
    for name, h in zip(names, host):
        out[name] = buf[offset : offset + h.size].view(arrays[name].shape)
        offset += h.size
    return out


class Prefix:
    """Convenience accessor: p = Prefix(params, 'enc_p.encoder'); p['ffn_layers.0.conv_1.weight']."""

    __slots__ = ("params", "prefix")

    def __init__(self, params: Params, prefix: str = ""):
        self.params = params
        self.prefix = prefix

    def __getitem__(self, key: str) -> torch.Tensor:
        full = f"{self.prefix}.{key}" if self.prefix else key
        return self.params[full]

    def __contains__(self, key: str) -> bool:
        full = f"{self.prefix}.{key}" if self.prefix else key
        return full in self.params

    def sub(self, key: str) -> "Prefix":
        full = f"{self.prefix}.{key}" if self.prefix else key
        return Prefix(self.params, full)
