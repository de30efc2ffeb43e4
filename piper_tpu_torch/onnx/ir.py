"""In-memory ONNX model IR (reference: ONNXIR.swift:1-95); the port's copy
of piper_tpu.onnx.ir.

Only the subset Piper checkpoints use. Initializer payloads decode straight
to numpy arrays (the reference keeps raw bytes and decodes lazily; numpy's
frombuffer makes eager decoding free)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


class TensorDataType(enum.IntEnum):
    UNDEFINED = 0
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    UINT32 = 12
    UINT64 = 13


_NP_DTYPES = {
    TensorDataType.FLOAT: np.dtype("<f4"),
    TensorDataType.UINT8: np.dtype("u1"),
    TensorDataType.INT8: np.dtype("i1"),
    TensorDataType.UINT16: np.dtype("<u2"),
    TensorDataType.INT16: np.dtype("<i2"),
    TensorDataType.INT32: np.dtype("<i4"),
    TensorDataType.INT64: np.dtype("<i8"),
    TensorDataType.BOOL: np.dtype("?"),
    TensorDataType.FLOAT16: np.dtype("<f2"),
    TensorDataType.DOUBLE: np.dtype("<f8"),
    TensorDataType.UINT32: np.dtype("<u4"),
    TensorDataType.UINT64: np.dtype("<u8"),
}


def np_dtype_for(dt: TensorDataType) -> np.dtype:
    try:
        return _NP_DTYPES[dt]
    except KeyError:
        raise ValueError(f"no numpy dtype for ONNX data type {dt!r}") from None


# Narrow types whose VALUES the TensorProto spec packs into int32_data
# (onnx.proto: "int32, int16, int8, uint16, uint8, bool" — float16 is
# stored there too, but as raw bit patterns, handled separately).
_INT32_PACKED = {
    TensorDataType.INT32,
    TensorDataType.INT16,
    TensorDataType.INT8,
    TensorDataType.UINT16,
    TensorDataType.UINT8,
    TensorDataType.BOOL,
}


def decode_int32_packed(values, dt: TensorDataType) -> Optional[np.ndarray]:
    """Decode a TensorProto int32_data payload per spec for data type `dt`:
    narrow int/bool values are widened in the field (cast back), float16 is
    stored as raw bit patterns. Returns None for types the field cannot
    legally carry (caller should reject the tensor, not guess)."""
    a = np.asarray(values, np.int32)
    if dt == TensorDataType.FLOAT16:
        return a.astype(np.uint16).view("<f2")
    if dt in _INT32_PACKED:
        return a.astype(np_dtype_for(dt))
    return None


@dataclass
class OnnxTensor:
    name: str
    dims: List[int]
    data_type: TensorDataType
    array: np.ndarray  # decoded payload, shape == dims

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


class AttrType(enum.IntEnum):
    UNDEFINED = 0
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    GRAPH = 5
    FLOATS = 6
    INTS = 7
    STRINGS = 8


@dataclass
class OnnxAttribute:
    name: str
    type: AttrType
    value: Any  # float | int | bytes | OnnxTensor | list thereof


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attributes: Dict[str, OnnxAttribute] = field(default_factory=dict)

    def attr_i(self, name: str, default: Optional[int] = None) -> Optional[int]:
        a = self.attributes.get(name)
        if a is None:
            return default
        return int(a.value)

    def attr_f(self, name: str, default: Optional[float] = None) -> Optional[float]:
        a = self.attributes.get(name)
        if a is None:
            return default
        return float(a.value)

    def attr_ints(self, name: str, default=None):
        a = self.attributes.get(name)
        if a is None:
            return default
        return [int(v) for v in a.value]

    def attr_s(self, name: str, default: Optional[str] = None) -> Optional[str]:
        a = self.attributes.get(name)
        if a is None:
            return default
        v = a.value
        return v.decode("utf-8") if isinstance(v, (bytes, bytearray)) else str(v)


@dataclass
class OnnxValueInfo:
    name: str
    elem_type: TensorDataType = TensorDataType.UNDEFINED
    # Each dim is an int (static), a str (symbolic dim_param), or None.
    shape: Optional[List[Any]] = None


@dataclass
class OnnxGraph:
    name: str
    nodes: List[OnnxNode]
    initializers: Dict[str, OnnxTensor]
    inputs: List[OnnxValueInfo]
    outputs: List[OnnxValueInfo]


@dataclass
class OnnxModel:
    ir_version: int
    opset_version: int
    graph: OnnxGraph
    producer_name: str = ""
