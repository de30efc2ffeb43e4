"""ONNX checkpoint decoder for the subset Piper exports.

The port's copy of piper_tpu.onnx.loader's pure-Python decoder
(`_load_model_python`, `_decode_model` and its field decoders), held equal
to it by tests/test_torch_standalone.py. `load_model` takes the native C++
parser first (onnx/native.py), as the JAX package's does.

Mirrors the field coverage of the reference's hand-written loader
(ONNXLoader.swift:23-385): ModelProto{ir_version, graph, opset_import},
GraphProto{node, name, initializer, input, output}, NodeProto, AttributeProto
(FLOAT/INT/STRING/TENSOR/FLOATS/INTS/STRINGS), TensorProto{dims, data_type,
float_data, int32_data, int64_data, name, raw_data}.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Optional

import numpy as np

from piper_tpu_torch.onnx.ir import (
    AttrType,
    OnnxAttribute,
    OnnxGraph,
    OnnxModel,
    OnnxNode,
    OnnxTensor,
    OnnxValueInfo,
    TensorDataType,
    decode_int32_packed,
    np_dtype_for,
)
from piper_tpu_torch.onnx.wire import (
    WIRE_FIXED32,
    WIRE_FIXED64,
    WIRE_LEN,
    WIRE_VARINT,
    Reader,
    decode_signed_varint,
)

# ModelProto fields
_M_IR_VERSION = 1
_M_PRODUCER_NAME = 2
_M_GRAPH = 7
_M_OPSET_IMPORT = 8
# OperatorSetIdProto
_OSI_DOMAIN = 1
_OSI_VERSION = 2
# GraphProto
_G_NODE = 1
_G_NAME = 2
_G_INITIALIZER = 5
_G_INPUT = 11
_G_OUTPUT = 12
# NodeProto
_N_INPUT = 1
_N_OUTPUT = 2
_N_NAME = 3
_N_OP_TYPE = 4
_N_ATTRIBUTE = 5
# AttributeProto
_A_NAME = 1
_A_F = 2
_A_I = 3
_A_S = 4
_A_T = 5
_A_FLOATS = 7
_A_INTS = 8
_A_STRINGS = 9
_A_TYPE = 20
# TensorProto
_T_DIMS = 1
_T_DATA_TYPE = 2
_T_FLOAT_DATA = 4
_T_INT32_DATA = 5
_T_INT64_DATA = 7
_T_NAME = 8
_T_RAW_DATA = 9
_T_DOUBLE_DATA = 10
# ValueInfoProto / TypeProto
_VI_NAME = 1
_VI_TYPE = 2
_TY_TENSOR_TYPE = 1
_TT_ELEM_TYPE = 1
_TT_SHAPE = 2
_TS_DIM = 1
_DIM_VALUE = 1
_DIM_PARAM = 2


class OnnxLoadError(ValueError):
    def __init__(self, msg: str, offset: Optional[int] = None, snippet: bytes = b""):
        detail = msg
        if offset is not None:
            detail += f" (offset {offset})"
        if snippet:
            detail += f" bytes={snippet.hex()}"
        super().__init__(detail)


def load_model(path: str | Path | bytes, prefer_native: bool = True) -> OnnxModel:
    """Parse an ONNX checkpoint.

    Tries the native C++ parser (piper_tpu_torch/native/onnx_parser.cpp,
    zero-copy weight mapping, built at first use) first; a file whose
    payloads it does not carry goes to the pure-Python decoder. A failure of
    the native parser or of its build raises: nothing falls back silently.
    PIPER_TPU_NO_NATIVE=1 (or prefer_native=False) takes the Python decoder
    alone."""
    import os

    if prefer_native and os.environ.get("PIPER_TPU_NO_NATIVE") != "1":
        from piper_tpu_torch.onnx.native import load_model_native

        m = load_model_native(path)
        if m is not None:
            return m
    return _load_model_python(path)


def _load_model_python(path: str | Path | bytes) -> OnnxModel:
    if isinstance(path, (str, Path)):
        data = Path(path).read_bytes()
    else:
        data = path
    try:
        return _decode_model(data)
    except Exception as e:  # noqa: BLE001 — re-raise with positional context
        if isinstance(e, OnnxLoadError):
            raise
        # Rich error context with a hex snippet around the failure offset
        # (the reference does the same on a bad tag — ONNXLoader.swift:280-288).
        offset = getattr(e, "offset", None)
        if offset is None:
            import re

            m = re.search(r"offset (\d+)", str(e))
            offset = int(m.group(1)) if m else None
        snippet = b""
        if offset is not None:
            snippet = bytes(data[max(0, offset - 8) : offset + 8])
        raise OnnxLoadError(str(e), offset=offset, snippet=snippet) from e


def _decode_model(data: bytes) -> OnnxModel:
    r = Reader(data)
    ir_version = 0
    opset_version = 0
    producer = ""
    graph: Optional[OnnxGraph] = None
    for field, wt in r.fields():
        if field == _M_IR_VERSION and wt == WIRE_VARINT:
            ir_version = r.read_varint()
        elif field == _M_PRODUCER_NAME and wt == WIRE_LEN:
            producer = r.read_string()
        elif field == _M_GRAPH and wt == WIRE_LEN:
            graph = _decode_graph(r.sub_reader())
        elif field == _M_OPSET_IMPORT and wt == WIRE_LEN:
            sub = r.sub_reader()
            domain, version = "", 0
            for f2, w2 in sub.fields():
                if f2 == _OSI_DOMAIN and w2 == WIRE_LEN:
                    domain = sub.read_string()
                elif f2 == _OSI_VERSION and w2 == WIRE_VARINT:
                    version = sub.read_varint()
                else:
                    sub.skip(w2)
            if domain in ("", "ai.onnx"):
                opset_version = version
        else:
            r.skip(wt)
    if graph is None:
        raise OnnxLoadError("model has no graph")
    return OnnxModel(
        ir_version=ir_version,
        opset_version=opset_version,
        graph=graph,
        producer_name=producer,
    )


def _decode_graph(r: Reader) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    initializers = {}
    inputs: List[OnnxValueInfo] = []
    outputs: List[OnnxValueInfo] = []
    name = ""
    for field, wt in r.fields():
        if field == _G_NODE and wt == WIRE_LEN:
            nodes.append(_decode_node(r.sub_reader()))
        elif field == _G_NAME and wt == WIRE_LEN:
            name = r.read_string()
        elif field == _G_INITIALIZER and wt == WIRE_LEN:
            t = _decode_tensor(r.sub_reader())
            initializers[t.name] = t
        elif field == _G_INPUT and wt == WIRE_LEN:
            inputs.append(_decode_value_info(r.sub_reader()))
        elif field == _G_OUTPUT and wt == WIRE_LEN:
            outputs.append(_decode_value_info(r.sub_reader()))
        else:
            r.skip(wt)
    return OnnxGraph(
        name=name, nodes=nodes, initializers=initializers, inputs=inputs, outputs=outputs
    )


def _decode_node(r: Reader) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    op_type = ""
    name = ""
    attributes = {}
    for field, wt in r.fields():
        if field == _N_INPUT and wt == WIRE_LEN:
            inputs.append(r.read_string())
        elif field == _N_OUTPUT and wt == WIRE_LEN:
            outputs.append(r.read_string())
        elif field == _N_NAME and wt == WIRE_LEN:
            name = r.read_string()
        elif field == _N_OP_TYPE and wt == WIRE_LEN:
            op_type = r.read_string()
        elif field == _N_ATTRIBUTE and wt == WIRE_LEN:
            a = _decode_attribute(r.sub_reader())
            attributes[a.name] = a
        else:
            r.skip(wt)
    return OnnxNode(
        op_type=op_type, inputs=inputs, outputs=outputs, name=name, attributes=attributes
    )


def _decode_attribute(r: Reader) -> OnnxAttribute:
    name = ""
    atype = AttrType.UNDEFINED
    value: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wt in r.fields():
        if field == _A_NAME and wt == WIRE_LEN:
            name = r.read_string()
        elif field == _A_F and wt == WIRE_FIXED32:
            value = np.frombuffer(r.read_fixed32().to_bytes(4, "little"), "<f4")[0]
            value = float(value)
            if atype == AttrType.UNDEFINED:
                atype = AttrType.FLOAT
        elif field == _A_I and wt == WIRE_VARINT:
            value = decode_signed_varint(r.read_varint())
            if atype == AttrType.UNDEFINED:
                atype = AttrType.INT
        elif field == _A_S and wt == WIRE_LEN:
            value = bytes(r.read_bytes())
            if atype == AttrType.UNDEFINED:
                atype = AttrType.STRING
        elif field == _A_T and wt == WIRE_LEN:
            value = _decode_tensor(r.sub_reader())
            if atype == AttrType.UNDEFINED:
                atype = AttrType.TENSOR
        elif field == _A_FLOATS:
            if wt == WIRE_LEN:
                raw = r.read_packed_fixed32()
                floats.extend(np.frombuffer(raw, "<f4").tolist())
            elif wt == WIRE_FIXED32:
                floats.append(
                    float(np.frombuffer(r.read_fixed32().to_bytes(4, "little"), "<f4")[0])
                )
            else:
                r.skip(wt)
            atype = AttrType.FLOATS
        elif field == _A_INTS:
            if wt == WIRE_LEN:
                ints.extend(decode_signed_varint(v) for v in r.read_packed_varints())
            elif wt == WIRE_VARINT:
                ints.append(decode_signed_varint(r.read_varint()))
            else:
                r.skip(wt)
            atype = AttrType.INTS
        elif field == _A_STRINGS and wt == WIRE_LEN:
            strings.append(bytes(r.read_bytes()))
            atype = AttrType.STRINGS
        elif field == _A_TYPE and wt == WIRE_VARINT:
            declared = r.read_varint()
            try:
                atype = AttrType(declared)
            except ValueError:
                pass
        else:
            r.skip(wt)
    if atype == AttrType.FLOATS:
        value = floats
    elif atype == AttrType.INTS:
        value = ints
    elif atype == AttrType.STRINGS:
        value = strings
    return OnnxAttribute(name=name, type=atype, value=value)


def _decode_tensor(r: Reader) -> OnnxTensor:
    dims: List[int] = []
    data_type = TensorDataType.UNDEFINED
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wt in r.fields():
        if field == _T_DIMS:
            if wt == WIRE_LEN:
                dims.extend(r.read_packed_varints())
            elif wt == WIRE_VARINT:
                dims.append(r.read_varint())
            else:
                r.skip(wt)
        elif field == _T_DATA_TYPE and wt == WIRE_VARINT:
            data_type = TensorDataType(r.read_varint())
        elif field == _T_NAME and wt == WIRE_LEN:
            name = r.read_string()
        elif field == _T_RAW_DATA and wt == WIRE_LEN:
            raw = bytes(r.read_bytes())
        elif field == _T_FLOAT_DATA:
            if wt == WIRE_LEN:
                float_data.extend(np.frombuffer(r.read_packed_fixed32(), "<f4").tolist())
            elif wt == WIRE_FIXED32:
                float_data.append(
                    float(np.frombuffer(r.read_fixed32().to_bytes(4, "little"), "<f4")[0])
                )
            else:
                r.skip(wt)
        elif field == _T_INT32_DATA:
            if wt == WIRE_LEN:
                int32_data.extend(decode_signed_varint(v) for v in r.read_packed_varints())
            elif wt == WIRE_VARINT:
                int32_data.append(decode_signed_varint(r.read_varint()))
            else:
                r.skip(wt)
        elif field == _T_INT64_DATA:
            if wt == WIRE_LEN:
                int64_data.extend(decode_signed_varint(v) for v in r.read_packed_varints())
            elif wt == WIRE_VARINT:
                int64_data.append(decode_signed_varint(r.read_varint()))
            else:
                r.skip(wt)
        elif field == _T_DOUBLE_DATA:
            if wt == WIRE_LEN:
                raw_bytes = bytes(r.read_bytes())
                double_data.extend(np.frombuffer(raw_bytes, "<f8").tolist())
            elif wt == WIRE_FIXED64:
                double_data.append(
                    float(np.frombuffer(r.read_fixed64().to_bytes(8, "little"), "<f8")[0])
                )
            else:
                r.skip(wt)
        else:
            r.skip(wt)

    shape = tuple(dims)
    if raw is not None:
        dt = np_dtype_for(data_type)
        arr = np.frombuffer(raw, dtype=dt)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np.int64)
    elif int32_data:
        # Spec packs narrow int/bool values (and float16 bit patterns)
        # into int32_data — decode per the declared type, never return
        # raw int32 for a non-int32 tensor.
        arr = decode_int32_packed(int32_data, data_type)
        if arr is None:
            raise OnnxLoadError(
                f"tensor {name!r}: int32_data payload for data type "
                f"{data_type!r}, which the field cannot carry"
            )
    elif double_data:
        arr = np.asarray(double_data, dtype=np.float64)
    elif shape and int(np.prod(shape)) > 0:
        # Non-empty dims but no payload we understand: external data or an
        # unsupported encoding. Fabricating zeros here would load a model
        # with silently wrong weights — fail loudly instead.
        raise OnnxLoadError(
            f"tensor {name!r}: dims {dims} but no inline payload "
            f"(external data is not supported)"
        )
    else:
        arr = np.zeros(shape, dtype=np_dtype_for(data_type) if data_type else np.float32)
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size != n:
        raise OnnxLoadError(
            f"tensor {name!r}: payload has {arr.size} elements but dims {dims} imply {n}"
        )
    arr = arr.reshape(shape)
    return OnnxTensor(name=name, dims=list(dims), data_type=data_type, array=arr)


def _decode_value_info(r: Reader) -> OnnxValueInfo:
    name = ""
    elem_type = TensorDataType.UNDEFINED
    shape = None
    for field, wt in r.fields():
        if field == _VI_NAME and wt == WIRE_LEN:
            name = r.read_string()
        elif field == _VI_TYPE and wt == WIRE_LEN:
            sub = r.sub_reader()
            for f2, w2 in sub.fields():
                if f2 == _TY_TENSOR_TYPE and w2 == WIRE_LEN:
                    tt = sub.sub_reader()
                    for f3, w3 in tt.fields():
                        if f3 == _TT_ELEM_TYPE and w3 == WIRE_VARINT:
                            elem_type = TensorDataType(tt.read_varint())
                        elif f3 == _TT_SHAPE and w3 == WIRE_LEN:
                            ts = tt.sub_reader()
                            shape = []
                            for f4, w4 in ts.fields():
                                if f4 == _TS_DIM and w4 == WIRE_LEN:
                                    dim = ts.sub_reader()
                                    dv: Any = None
                                    for f5, w5 in dim.fields():
                                        if f5 == _DIM_VALUE and w5 == WIRE_VARINT:
                                            dv = decode_signed_varint(dim.read_varint())
                                        elif f5 == _DIM_PARAM and w5 == WIRE_LEN:
                                            dv = dim.read_string()
                                        else:
                                            dim.skip(w5)
                                    shape.append(dv)
                                else:
                                    ts.skip(w4)
                        else:
                            tt.skip(w3)
                else:
                    sub.skip(w2)
    return OnnxValueInfo(name=name, elem_type=elem_type, shape=shape)
