from piper_tpu_torch.onnx.ir import (
    OnnxAttribute,
    OnnxGraph,
    OnnxModel,
    OnnxNode,
    OnnxTensor,
    TensorDataType,
)
from piper_tpu_torch.onnx.loader import OnnxLoadError, load_model

__all__ = [
    "OnnxAttribute",
    "OnnxGraph",
    "OnnxModel",
    "OnnxNode",
    "OnnxTensor",
    "TensorDataType",
    "OnnxLoadError",
    "load_model",
]
