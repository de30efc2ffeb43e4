"""Emit a structural fingerprint of an ONNX checkpoint (the port of the
JAX package's tools/fingerprint_onnx.py, over the port's own loader).

For validating a real Piper voice against, and regenerating,
tests/fixtures/real_voice_fingerprint.json:

    python -m piper_tpu_torch.tools.fingerprint_onnx path/to/voice.onnx [--compact]

Prints node/initializer counts, opset, I/O signature, first node, the
node-type histogram, payload-encoding mix, and presence of the
reference-pinned initializers: the same dict as the JAX package's tool.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter


def fingerprint(path) -> dict:
    from piper_tpu_torch.onnx.loader import load_model

    model = load_model(path)
    g = model.graph
    histogram = Counter(n.op_type for n in g.nodes)
    has_output_padding = any(
        n.op_type == "ConvTranspose" and "output_padding" in n.attributes for n in g.nodes)
    constant_weights = sum(
        1 for n in g.nodes
        if n.op_type == "Constant" and n.outputs
        and n.outputs[0].split(".", 1)[0] in ("enc_p", "dp", "flow", "dec", "emb_g"))
    return {
        "file": str(path),
        "facts": {
            "opset_version": model.opset_version,
            "ir_version": model.ir_version,
            "producer_name": model.producer_name,
            "node_count": len(g.nodes),
            "initializer_count": len(g.initializers),
            "graph_inputs": [vi.name for vi in g.inputs],
            "graph_outputs": [vi.name for vi in g.outputs],
            "first_node_op": g.nodes[0].op_type if g.nodes else None,
            "initializers_present": [
                name for name in ("sid", "enc_p.encoder.attn_layers.0.conv_q.weight")
                if name in g.initializers],
        },
        "node_histogram": dict(histogram.most_common()),
        "features": {
            "conv_transpose_output_padding": has_output_padding,
            "parameter_constant_nodes": constant_weights,
            "initializer_dtypes": dict(Counter(
                t.data_type.name for t in g.initializers.values())),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", help="path to a .onnx checkpoint")
    ap.add_argument("--compact", action="store_true")
    args = ap.parse_args(argv)
    fp = fingerprint(args.model)
    print(json.dumps(fp) if args.compact else json.dumps(fp, indent=2))
    return fp


if __name__ == "__main__":
    main()
