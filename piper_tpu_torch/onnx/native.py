"""ctypes bindings for the native ONNX parser, with zero-copy weight mapping
(counterpart of piper_tpu.onnx.native).

The C++ side (native/onnx_parser.cpp) walks the protobuf once and returns a
JSON index with byte offsets for each initializer's raw payload; numpy then
views the original buffer in place (no per-tensor copies; the arrays are
read-only). The library is built at first use (native/build.py); a build
that fails raises. `load_model_native` returns None for a file whose
payloads the index does not carry (external data, an encoding it does not
decode), which `onnx.loader.load_model` then decodes in Python.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path
from typing import Optional

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

_lib = None


def _load_lib():
    """The parser's library, built at first use and loaded once; raises
    (native.build.NativeBuildError) when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    from piper_tpu_torch.native.build import build_library

    path = build_library(["onnx_parser.cpp"], "libpiper_onnx")
    lib = ctypes.CDLL(str(path))
    lib.piper_onnx_parse_index.restype = ctypes.c_void_p
    lib.piper_onnx_parse_index.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.piper_onnx_free.restype = None
    lib.piper_onnx_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    """True when the library is built or builds now; False when it cannot
    be built (the reason is the NativeBuildError load_model raises)."""
    from piper_tpu_torch.native.build import NativeBuildError

    try:
        _load_lib()
    except NativeBuildError:
        return False
    return True


def load_model_native(path: str | Path | bytes) -> Optional[OnnxModel]:
    """Parse via the C++ library; None for a payload it does not carry.
    Raises when the library cannot be built."""
    lib = _load_lib()
    data = Path(path).read_bytes() if isinstance(path, (str, Path)) else bytes(path)
    ptr = lib.piper_onnx_parse_index(data, len(data))
    if not ptr:
        return None
    try:
        index = json.loads(ctypes.string_at(ptr).decode("utf-8"))
    finally:
        lib.piper_onnx_free(ptr)
    if "error" in index:
        return None

    g = index["graph"]
    buf = np.frombuffer(data, dtype=np.uint8)

    def tensor_from_index(t) -> Optional[OnnxTensor]:
        """OnnxTensor from one index entry. raw_data / float_data /
        double_data payloads view the original buffer zero-copy (packed
        repeated floats are contiguous little-endian scalars, same layout
        as raw); varint-packed int payloads were decoded in C++."""
        dt = TensorDataType(t["data_type"])
        dims = t["dims"]
        n = int(np.prod(dims)) if dims else 1
        if t.get("offset", -1) >= 0:
            arr = buf[t["offset"] : t["offset"] + t["nbytes"]].view(np_dtype_for(dt))
        elif t.get("float_off", -1) >= 0:
            arr = buf[t["float_off"] : t["float_off"] + t["float_nbytes"]].view("<f4")
        elif t.get("double_off", -1) >= 0:
            arr = buf[t["double_off"] : t["double_off"] + t["double_nbytes"]].view("<f8")
        elif "int64_data" in t:
            arr = np.asarray(t["int64_data"], np.int64)
        elif "int32_data" in t:
            # Spec packs narrow int/bool values (and float16 bit patterns)
            # into int32_data — decode per the declared type; for types the
            # field cannot carry, punt to the full-Python loader, which
            # raises a descriptive OnnxLoadError.
            arr = decode_int32_packed(t["int32_data"], dt)
            if arr is None:
                return None
        elif "float_data" in t:
            arr = np.asarray(t["float_data"], np.float32)
        elif n > 0:
            # Non-empty dims but no payload the C++ index carries (external
            # data / unsupported encoding): fabricating zeros would load
            # silently wrong weights. Fall back to the full-Python loader,
            # which fails loudly with the tensor name.
            return None
        else:
            arr = np.zeros(dims, dtype=np_dtype_for(dt) if dt else np.float32)
        if arr.size != max(n, 0):
            return None
        return OnnxTensor(name=t["name"], dims=list(dims), data_type=dt,
                          array=arr.reshape(dims))

    initializers = {}
    for t in g["initializers"]:
        tensor = tensor_from_index(t)
        if tensor is None:
            return None  # inconsistent payload: full-Python fallback
        initializers[t["name"]] = tensor

    nodes = []
    for nd in g["nodes"]:
        attrs = {}
        for aname, a in nd["attributes"].items():
            atype = AttrType(a.get("type", 0)) if a.get("type", 0) in set(
                int(x) for x in AttrType
            ) else AttrType.UNDEFINED
            if "t" in a:
                value = tensor_from_index(a["t"])
                atype = AttrType.TENSOR
                if value is None:
                    return None  # malformed tensor attr: Python fallback
            elif "ints" in a:
                value = a["ints"]
                atype = AttrType.INTS
            elif "floats" in a:
                value = a["floats"]
                atype = AttrType.FLOATS
            elif atype == AttrType.INTS:
                value = []  # declared repeated-int attribute with no values
            elif atype == AttrType.FLOATS:
                value = []
            elif atype == AttrType.INT or ("i" in a and atype == AttrType.UNDEFINED):
                value = a.get("i", 0)
            elif atype == AttrType.FLOAT or ("f" in a and atype == AttrType.UNDEFINED):
                value = a.get("f", 0.0)
            elif atype == AttrType.STRING or ("s" in a and atype == AttrType.UNDEFINED):
                value = a.get("s", "").encode("utf-8")
            elif "i" in a:
                value = a["i"]
            elif "f" in a:
                value = a["f"]
            elif "s" in a:
                value = a["s"].encode("utf-8")
            else:
                value = None
            attrs[aname] = OnnxAttribute(name=aname, type=atype, value=value)
        nodes.append(
            OnnxNode(
                op_type=nd["op_type"],
                inputs=nd["inputs"],
                outputs=nd["outputs"],
                name=nd["name"],
                attributes=attrs,
            )
        )

    def vinfo(d):
        return OnnxValueInfo(
            name=d["name"],
            elem_type=TensorDataType(d["elem_type"]),
            shape=d["shape"],
        )

    graph = OnnxGraph(
        name=g["name"],
        nodes=nodes,
        initializers=initializers,
        inputs=[vinfo(x) for x in g["inputs"]],
        outputs=[vinfo(x) for x in g["outputs"]],
    )
    return OnnxModel(
        ir_version=index["ir_version"],
        opset_version=index["opset_version"],
        graph=graph,
        producer_name=index.get("producer_name", ""),
    )
