"""VITS architecture hyperparameters (the port's copy of
piper_tpu.models.vits.hparams).

Piper's voice config JSON carries no architecture fields, and the reference
never needed them (it interprets the exported graph). We run the model
natively, so hyperparameters are *derived from the checkpoint itself*:
channel sizes and layer counts from initializer shapes, upsample strides/pads
from the ConvTranspose node attributes. Quality presets exist for generating
synthetic checkpoints offline.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Dict, List

from piper_tpu_torch.onnx.ir import OnnxGraph


@dataclass(frozen=True)
class VitsHParams:
    n_vocab: int = 256
    inter_channels: int = 192          # z / flow channels
    hidden_channels: int = 192         # text-encoder width
    filter_channels: int = 768         # encoder FFN width
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3               # encoder FFN kernel
    window_size: int = 4               # relative-attention window
    # Stochastic duration predictor
    dp_filter_channels: int = 192
    dp_kernel_size: int = 3
    dp_n_flows: int = 4
    dp_num_bins: int = 10
    dp_tail_bound: float = 5.0
    # Flow decoder
    flow_n_flows: int = 4
    flow_hidden_channels: int = 192
    flow_kernel_size: int = 5
    flow_dilation_rate: int = 1
    flow_n_layers: int = 4
    # HiFi-GAN vocoder
    resblock: str = "1"  # "1" = ResBlock1 (convs1/convs2); "2" = ResBlock2 (convs)
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    upsample_rates: List[int] = field(default_factory=lambda: [8, 8, 2, 2])
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [16, 16, 4, 4])
    # Speakers
    n_speakers: int = 1
    gin_channels: int = 0
    sample_rate: int = 22050

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h

    @property
    def num_upsamples(self) -> int:
        return len(self.upsample_rates)

    @property
    def num_resblock_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)


# Presets for synthetic checkpoint generation (representative of the Piper
# quality tiers; real checkpoints override everything via derive_hparams).
PRESETS: Dict[str, VitsHParams] = {
    "x_low": VitsHParams(
        hidden_channels=96,
        inter_channels=96,
        filter_channels=384,
        flow_hidden_channels=96,
        dp_filter_channels=96,
        upsample_initial_channel=256,
        upsample_rates=[8, 8, 4],
        upsample_kernel_sizes=[16, 16, 8],
        sample_rate=16000,
        resblock="2",
        resblock_kernel_sizes=[3, 5, 7],
        resblock_dilation_sizes=[[1, 2], [2, 6], [3, 12]],
    ),
    "low": VitsHParams(sample_rate=16000),
    "medium": VitsHParams(),
    # High-quality tier (the en_US-ryan-high class, BASELINE.json config #4):
    # same 22.05 kHz output and hop 256 as medium, but a DEEPER HiFi-GAN
    # upsample stack — five levels instead of four (8*4*2*2*2 = 256), with an
    # extra resblock set at the final 16-channel rate. Real checkpoints
    # override every field via derive_hparams (rates/kernels from the
    # ConvTranspose node attrs), so this preset only shapes synthetic
    # checkpoints and benchmarks; the derivation path is what loads an
    # actual ryan-high export.
    "high": VitsHParams(
        upsample_rates=[8, 4, 2, 2, 2],
        upsample_kernel_sizes=[16, 8, 4, 4, 4],
    ),
    # Synthetic-only tiny tier for fast tests and smoke runs (NOT a real
    # Piper quality). Structurally complete — attention text encoder, SDP,
    # residual-coupling flows, multi-level HiFi-GAN — but compiles in
    # seconds on one CPU core where x_low takes tens of seconds.
    "test": VitsHParams(
        inter_channels=32,
        hidden_channels=32,
        filter_channels=64,
        n_heads=2,
        n_layers=2,
        dp_filter_channels=32,
        flow_n_flows=2,
        flow_hidden_channels=32,
        flow_n_layers=2,
        resblock_kernel_sizes=[3],
        resblock_dilation_sizes=[[1, 3]],
        upsample_rates=[8, 4],
        upsample_initial_channel=64,
        upsample_kernel_sizes=[16, 8],
        sample_rate=16000,
    ),
}


def derive_hparams(
    graph: OnnxGraph, sample_rate: int = 22050, n_speakers: int = 1
) -> VitsHParams:
    """Infer the architecture from a parsed Piper checkpoint.

    Initializer names follow the exported PyTorch module paths (the reference
    pins `enc_p.encoder.attn_layers.0.conv_q.weight` and `sid` in its loader
    golden test — Tests/PiperONNXTests/ONNXParsingTests.swift:29-37).
    """
    init = graph.initializers

    def shape(name: str) -> List[int]:
        return list(init[name].dims)

    def count(pattern: str) -> int:
        rx = re.compile(pattern)
        idx = set()
        for name in init:
            m = rx.match(name)
            if m:
                idx.add(int(m.group(1)))
        return len(idx)

    emb = shape("enc_p.emb.weight")  # (n_vocab, hidden)
    n_vocab, hidden = emb
    n_layers = count(r"enc_p\.encoder\.attn_layers\.(\d+)\.conv_q\.weight")
    filter_channels = shape("enc_p.encoder.ffn_layers.0.conv_1.weight")[0]
    kernel_size = shape("enc_p.encoder.ffn_layers.0.conv_1.weight")[2]
    # emb_rel_k: (heads_or_1, 2*window+1, k_channels)
    rel = shape("enc_p.encoder.attn_layers.0.emb_rel_k")
    window_size = (rel[1] - 1) // 2
    k_channels = rel[2]
    n_heads = hidden // k_channels
    inter_channels = shape("enc_p.proj.weight")[0] // 2

    dp_filter = shape("dp.pre.weight")[0]
    dp_kernel = shape("dp.convs.convs_sep.0.weight")[2]
    dp_n_flows = count(r"dp\.flows\.(\d+)\.pre\.weight")
    # proj emits half*(3*num_bins - 1) channels with half == 1
    dp_num_bins = (shape("dp.flows.1.proj.weight")[0] + 1) // 3

    flow_n_flows = count(r"flow\.flows\.(\d+)\.pre\.weight")
    flow_hidden = shape("flow.flows.0.enc.in_layers.0.weight")[0] // 2
    flow_kernel = shape("flow.flows.0.enc.in_layers.0.weight")[2]
    flow_n_layers = count(r"flow\.flows\.0\.enc\.in_layers\.(\d+)\.weight")
    flow_dilation = 1
    if flow_n_layers >= 2:
        # dilation_rate**i is baked into each layer's Conv node attrs; shapes
        # don't carry it, so read it from the graph nodes if present.
        flow_dilation = _conv_dilation_for(graph, "flow.flows.0.enc.in_layers.1.weight", 1)

    upsample_initial = shape("dec.conv_pre.weight")[0]
    n_ups = count(r"dec\.ups\.(\d+)\.weight")
    upsample_kernel_sizes = [shape(f"dec.ups.{i}.weight")[2] for i in range(n_ups)]
    upsample_rates = [
        _conv_transpose_stride_for(graph, f"dec.ups.{i}.weight", upsample_kernel_sizes[i])
        for i in range(n_ups)
    ]
    # ResBlock flavor: "1" has convs1/convs2 pairs; "2" (used by low/x_low
    # quality voices) has a single convs list per branch.
    resblock = "2" if "dec.resblocks.0.convs.0.weight" in init else "1"
    convs_key = "convs" if resblock == "2" else "convs1"
    n_res_total = count(rf"dec\.resblocks\.(\d+)\.{convs_key}\.0\.weight")
    num_kernels = n_res_total // n_ups if n_ups else 3
    resblock_kernel_sizes = [
        shape(f"dec.resblocks.{j}.{convs_key}.0.weight")[2] for j in range(num_kernels)
    ]
    resblock_dilation_sizes = []
    for j in range(num_kernels):
        n_d = count(rf"dec\.resblocks\.{j}\.{convs_key}\.(\d+)\.weight")
        dils = [
            _conv_dilation_for(graph, f"dec.resblocks.{j}.{convs_key}.{m}.weight", 1)
            for m in range(n_d)
        ]
        resblock_dilation_sizes.append(dils)

    gin_channels = 0
    n_spk = n_speakers
    if "emb_g.weight" in init:
        n_spk, gin_channels = shape("emb_g.weight")

    return VitsHParams(
        n_vocab=n_vocab,
        resblock=resblock,
        inter_channels=inter_channels,
        hidden_channels=hidden,
        filter_channels=filter_channels,
        n_heads=n_heads,
        n_layers=n_layers,
        kernel_size=kernel_size,
        window_size=window_size,
        dp_filter_channels=dp_filter,
        dp_kernel_size=dp_kernel,
        dp_n_flows=dp_n_flows,
        dp_num_bins=dp_num_bins,
        flow_n_flows=flow_n_flows,
        flow_hidden_channels=flow_hidden,
        flow_kernel_size=flow_kernel,
        flow_dilation_rate=flow_dilation,
        flow_n_layers=flow_n_layers,
        resblock_kernel_sizes=resblock_kernel_sizes,
        resblock_dilation_sizes=resblock_dilation_sizes,
        upsample_rates=upsample_rates,
        upsample_initial_channel=upsample_initial,
        upsample_kernel_sizes=upsample_kernel_sizes,
        n_speakers=n_spk,
        gin_channels=gin_channels,
        sample_rate=sample_rate,
    )


def _nodes_by_weight(graph: OnnxGraph, weight_name: str):
    for n in graph.nodes:
        if weight_name in n.inputs:
            yield n


def _conv_dilation_for(graph: OnnxGraph, weight_name: str, default: int) -> int:
    for n in _nodes_by_weight(graph, weight_name):
        if n.op_type == "Conv":
            d = n.attr_ints("dilations")
            if d:
                return int(d[0])
    return default


def _conv_transpose_stride_for(graph: OnnxGraph, weight_name: str, kernel: int) -> int:
    for n in _nodes_by_weight(graph, weight_name):
        if n.op_type == "ConvTranspose":
            s = n.attr_ints("strides")
            if s:
                return int(s[0])
    # HiFi-GAN convention: stride = kernel // 2.
    return kernel // 2


def with_speakers(hp: VitsHParams, n_speakers: int, gin_channels: int) -> VitsHParams:
    return replace(hp, n_speakers=n_speakers, gin_channels=gin_channels)


def receptive_field_frames(hp: VitsHParams) -> int:
    """One-sided receptive field of the decode stage (flow + vocoder) in
    frames — the halo needed for exact windowed/streaming decoding."""
    # Flow: n_flows sequential coupling layers, each a WaveNet stack.
    wn_half = sum(
        (hp.flow_kernel_size - 1) // 2 * hp.flow_dilation_rate**i
        for i in range(hp.flow_n_layers)
    )
    flow_rf = hp.flow_n_flows * wn_half

    # Vocoder, converted to frames at each level's sample rate.
    voc_rf = 3.0  # conv_pre kernel 7
    upsample = 1
    for i in range(hp.num_upsamples):
        k, u = hp.upsample_kernel_sizes[i], hp.upsample_rates[i]
        # conv_transpose: one output draws on ceil(k/u) inputs around it.
        voc_rf += -(-k // u) / upsample
        upsample *= u
        # resblock branches run in parallel: take the widest branch.
        branch_rf = 0
        for j, kj in enumerate(hp.resblock_kernel_sizes):
            rf = sum(
                (kj - 1) // 2 * d + (kj - 1) // 2
                for d in hp.resblock_dilation_sizes[j]
            )
            branch_rf = max(branch_rf, rf)
        voc_rf += branch_rf / upsample
    voc_rf += 3.0 / upsample  # conv_post kernel 7
    import math

    return flow_rf + math.ceil(voc_rf)
