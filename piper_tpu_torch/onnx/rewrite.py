"""ONNX graph rewriting: make the exported graph's RNG injectable
(counterpart of piper_tpu.onnx.rewrite).

Piper checkpoints sample noise with RandomNormalLike nodes, which makes
bit-exact cross-runtime comparison impossible (every runtime's RNG differs —
the reference hit the same wall and injected recorded tensors into its own
executor instead, GraphExecutor.swift:101-104). `externalize_random` removes
those nodes and promotes their outputs to graph *inputs*, so a reference
runtime (onnxruntime) can be fed the exact noise tensors piper-tpu recorded —
enabling the <=1e-3 max-abs waveform comparison from BASELINE.md end to end.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from piper_tpu_torch.onnx.ir import OnnxModel, OnnxValueInfo, TensorDataType


def externalize_random(model: OnnxModel) -> Tuple[OnnxModel, List[str]]:
    """Strip RandomNormalLike/RandomNormal nodes, exposing outputs as inputs.

    Returns (rewritten model, names of the new noise inputs, in graph order).
    The original model object is not modified."""
    g = model.graph
    noise_names: List[str] = []
    kept_nodes = []
    for n in g.nodes:
        if n.op_type in ("RandomNormalLike", "RandomNormal"):
            noise_names.extend(n.outputs)
        else:
            kept_nodes.append(n)

    new_inputs = list(g.inputs)
    for name in noise_names:
        new_inputs.append(
            OnnxValueInfo(name=name, elem_type=TensorDataType.FLOAT, shape=None)
        )

    from dataclasses import replace

    new_graph = replace(g, nodes=kept_nodes, inputs=new_inputs)
    return replace(model, graph=new_graph), noise_names
