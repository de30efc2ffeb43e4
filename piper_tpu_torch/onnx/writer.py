"""ONNX checkpoint encoder.

The port's copy of piper_tpu.onnx.writer. Used to emit synthetic
Piper-shaped checkpoints for tests and offline benchmarks. Round-trips
through `loader.load_model`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from piper_tpu_torch.onnx.ir import (
    AttrType,
    OnnxGraph,
    OnnxModel,
    OnnxNode,
    OnnxTensor,
    OnnxValueInfo,
    TensorDataType,
    np_dtype_for,
)
from piper_tpu_torch.onnx.wire import Writer

_DTYPE_TO_ONNX = {
    np.dtype("float32"): TensorDataType.FLOAT,
    np.dtype("int64"): TensorDataType.INT64,
    np.dtype("int32"): TensorDataType.INT32,
    np.dtype("bool"): TensorDataType.BOOL,
    np.dtype("float64"): TensorDataType.DOUBLE,
    np.dtype("float16"): TensorDataType.FLOAT16,
    np.dtype("uint8"): TensorDataType.UINT8,
}


def tensor_from_array(name: str, arr: np.ndarray) -> OnnxTensor:
    arr = np.ascontiguousarray(arr)
    dt = _DTYPE_TO_ONNX[arr.dtype]
    return OnnxTensor(name=name, dims=list(arr.shape), data_type=dt, array=arr)


def _encode_tensor(t: OnnxTensor) -> Writer:
    w = Writer()
    if t.dims:
        w.packed_varints_field(1, t.dims)  # dims
    w.varint_field(2, int(t.data_type))  # data_type
    w.string_field(8, t.name)  # name
    arr = np.ascontiguousarray(t.array.astype(np_dtype_for(t.data_type), copy=False))
    w.bytes_field(9, arr.tobytes())  # raw_data
    return w


def _encode_attribute(name: str, value: Any) -> Writer:
    w = Writer()
    w.string_field(1, name)
    if isinstance(value, bool):
        w.varint_field(3, int(value))
        w.varint_field(20, int(AttrType.INT))
    elif isinstance(value, int):
        w.varint_field(3, value)
        w.varint_field(20, int(AttrType.INT))
    elif isinstance(value, float):
        w.float_field(2, value)
        w.varint_field(20, int(AttrType.FLOAT))
    elif isinstance(value, str):
        w.bytes_field(4, value.encode("utf-8"))
        w.varint_field(20, int(AttrType.STRING))
    elif isinstance(value, bytes):
        w.bytes_field(4, value)
        w.varint_field(20, int(AttrType.STRING))
    elif isinstance(value, OnnxTensor):
        w.message_field(5, _encode_tensor(value))
        w.varint_field(20, int(AttrType.TENSOR))
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            w.float_field(7, float(v))
        w.varint_field(20, int(AttrType.FLOATS))
    elif isinstance(value, (list, tuple)):
        w.packed_varints_field(8, [int(v) for v in value])
        w.varint_field(20, int(AttrType.INTS))
    else:
        raise TypeError(f"unsupported attribute value for {name!r}: {type(value)}")
    return w


def _encode_node(n: OnnxNode) -> Writer:
    w = Writer()
    for i in n.inputs:
        w.string_field(1, i)
    for o in n.outputs:
        w.string_field(2, o)
    if n.name:
        w.string_field(3, n.name)
    w.string_field(4, n.op_type)
    for a in n.attributes.values():
        w.message_field(5, _encode_attribute(a.name, a.value))
    return w


def _encode_value_info(vi: OnnxValueInfo) -> Writer:
    w = Writer()
    w.string_field(1, vi.name)
    ty = Writer()
    tt = Writer()
    if vi.elem_type:
        tt.varint_field(1, int(vi.elem_type))
    if vi.shape is not None:
        ts = Writer()
        for d in vi.shape:
            dim = Writer()
            if isinstance(d, int):
                dim.varint_field(1, d)
            elif isinstance(d, str):
                dim.string_field(2, d)
            ts.message_field(1, dim)
        tt.message_field(2, ts)
    ty.message_field(1, tt)
    w.message_field(2, ty)
    return w


def node(
    op_type: str,
    inputs: Iterable[str],
    outputs: Iterable[str],
    name: str = "",
    **attrs: Any,
) -> OnnxNode:
    from piper_tpu_torch.onnx.ir import OnnxAttribute

    attributes = {
        k: OnnxAttribute(name=k, type=AttrType.UNDEFINED, value=v) for k, v in attrs.items()
    }
    return OnnxNode(
        op_type=op_type,
        inputs=list(inputs),
        outputs=list(outputs),
        name=name,
        attributes=attributes,
    )


def save_model(
    path: str,
    nodes: List[OnnxNode],
    initializers: Dict[str, np.ndarray],
    inputs: Optional[List[OnnxValueInfo]] = None,
    outputs: Optional[List[OnnxValueInfo]] = None,
    graph_name: str = "piper_tpu_synthetic",
    opset: int = 15,
    ir_version: int = 8,
    producer: str = "piper-tpu",
) -> None:
    g = Writer()
    for n in nodes:
        g.message_field(1, _encode_node(n))
    g.string_field(2, graph_name)
    for name, arr in initializers.items():
        g.message_field(5, _encode_tensor(tensor_from_array(name, arr)))
    for vi in inputs or []:
        g.message_field(11, _encode_value_info(vi))
    for vi in outputs or []:
        g.message_field(12, _encode_value_info(vi))

    m = Writer()
    m.varint_field(1, ir_version)
    m.string_field(2, producer)
    m.message_field(7, g)
    osi = Writer()
    osi.string_field(1, "")
    osi.varint_field(2, opset)
    m.message_field(8, osi)
    with open(path, "wb") as f:
        f.write(m.to_bytes())


def save_model_ir(path: str, model: OnnxModel) -> None:
    save_model(
        path,
        nodes=model.graph.nodes,
        initializers={k: v.array for k, v in model.graph.initializers.items()},
        inputs=model.graph.inputs,
        outputs=model.graph.outputs,
        graph_name=model.graph.name,
        opset=model.opset_version,
        ir_version=model.ir_version,
        producer=model.producer_name,
    )
