"""Synthetic Piper-shaped checkpoint generation.

The port's copy of piper_tpu.models.vits.synthetic: it writes the same
bytes (tests/test_torch_standalone.py holds them equal), so a voice made by
either package loads into both. For when no real voice is at hand,
these helpers emit a random-weight checkpoint with the exact initializer
naming scheme, node attributes, and I/O signature of a real Piper export, so
the full load path (protobuf decode -> hparam derivation -> param extraction)
and the benchmarks run the same code they would on a real voice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from piper_tpu_torch.models.vits.hparams import PRESETS, VitsHParams
from piper_tpu_torch.onnx.ir import OnnxValueInfo, TensorDataType
from piper_tpu_torch.onnx.writer import node, save_model


def synthetic_params(
    hp: VitsHParams, seed: int = 0, scale: Optional[float] = None
) -> Dict[str, np.ndarray]:
    """Random weights for every parameter the VITS inference graph uses.

    Conv/linear weights default to fan-in (Kaiming-style) scaling so layer
    gains are ~1, matching the activation statistics of trained checkpoints —
    a flat scale makes activations grow exponentially through the vocoder
    stack, which saturates the tanh output and wildly exaggerates
    low-precision error in fidelity measurements."""
    rng = np.random.default_rng(seed)
    w: Dict[str, np.ndarray] = {}

    def add(name: str, *shape: int, s: Optional[float] = scale) -> None:
        if s is None:
            if len(shape) >= 2:
                fan_in = int(np.prod(shape[1:]))
                s = 1.0 / np.sqrt(fan_in)
            else:
                s = 0.02  # biases / 1-D params
        w[name] = (rng.standard_normal(shape) * s).astype(np.float32)

    H = hp.hidden_channels
    F = hp.filter_channels
    inter = hp.inter_channels
    kch = H // hp.n_heads

    # --- enc_p ---
    # VITS initializes the embedding ~ N(0, H^-0.5); the forward pass
    # multiplies by sqrt(H), giving unit-variance activations.
    add("enc_p.emb.weight", hp.n_vocab, H, s=float(H) ** -0.5)
    for i in range(hp.n_layers):
        a = f"enc_p.encoder.attn_layers.{i}"
        add(f"{a}.emb_rel_k", 1, 2 * hp.window_size + 1, kch)
        add(f"{a}.emb_rel_v", 1, 2 * hp.window_size + 1, kch)
        for c in ("conv_q", "conv_k", "conv_v", "conv_o"):
            add(f"{a}.{c}.weight", H, H, 1)
            add(f"{a}.{c}.bias", H)
        for n_ in ("norm_layers_1", "norm_layers_2"):
            w[f"enc_p.encoder.{n_}.{i}.gamma"] = np.ones(H, np.float32)
            w[f"enc_p.encoder.{n_}.{i}.beta"] = np.zeros(H, np.float32)
        f = f"enc_p.encoder.ffn_layers.{i}"
        add(f"{f}.conv_1.weight", F, H, hp.kernel_size)
        add(f"{f}.conv_1.bias", F)
        add(f"{f}.conv_2.weight", H, F, hp.kernel_size)
        add(f"{f}.conv_2.bias", H)
    add("enc_p.proj.weight", 2 * inter, H, 1)
    add("enc_p.proj.bias", 2 * inter)

    # --- dp (stochastic duration predictor) ---
    dF = hp.dp_filter_channels
    dk = hp.dp_kernel_size

    def add_dds(prefix: str, ch: int) -> None:
        for i in range(3):
            add(f"{prefix}.convs_sep.{i}.weight", ch, 1, dk)
            add(f"{prefix}.convs_sep.{i}.bias", ch)
            add(f"{prefix}.convs_1x1.{i}.weight", ch, ch, 1)
            add(f"{prefix}.convs_1x1.{i}.bias", ch)
            for n_ in ("norms_1", "norms_2"):
                w[f"{prefix}.{n_}.{i}.gamma"] = np.ones(ch, np.float32)
                w[f"{prefix}.{n_}.{i}.beta"] = np.zeros(ch, np.float32)

    add("dp.pre.weight", dF, H, 1)
    add("dp.pre.bias", dF)
    add_dds("dp.convs", dF)
    add("dp.proj.weight", dF, dF, 1)
    add("dp.proj.bias", dF)
    if hp.gin_channels:
        add("dp.cond.weight", dF, hp.gin_channels, 1)
        add("dp.cond.bias", dF)
    ea_scale = 0.05 if scale is None else scale
    w["dp.flows.0.m"] = (rng.standard_normal((2, 1)) * ea_scale).astype(np.float32)
    w["dp.flows.0.logs"] = (rng.standard_normal((2, 1)) * ea_scale).astype(np.float32)
    nb = hp.dp_num_bins
    for i in range(hp.dp_n_flows):
        cf = f"dp.flows.{2 * i + 1}"
        add(f"{cf}.pre.weight", dF, 1, 1)
        add(f"{cf}.pre.bias", dF)
        add_dds(f"{cf}.convs", dF)
        add(f"{cf}.proj.weight", 3 * nb - 1, dF, 1)
        add(f"{cf}.proj.bias", 3 * nb - 1)

    # --- flow (residual coupling block) ---
    fH = hp.flow_hidden_channels
    half = inter // 2
    for i in range(hp.flow_n_flows):
        rc = f"flow.flows.{2 * i}"
        add(f"{rc}.pre.weight", fH, half, 1)
        add(f"{rc}.pre.bias", fH)
        for j in range(hp.flow_n_layers):
            add(f"{rc}.enc.in_layers.{j}.weight", 2 * fH, fH, hp.flow_kernel_size)
            add(f"{rc}.enc.in_layers.{j}.bias", 2 * fH)
            out_ch = 2 * fH if j < hp.flow_n_layers - 1 else fH
            add(f"{rc}.enc.res_skip_layers.{j}.weight", out_ch, fH, 1)
            add(f"{rc}.enc.res_skip_layers.{j}.bias", out_ch)
        if hp.gin_channels:
            add(f"{rc}.enc.cond_layer.weight", 2 * fH * hp.flow_n_layers, hp.gin_channels, 1)
            add(f"{rc}.enc.cond_layer.bias", 2 * fH * hp.flow_n_layers)
        add(f"{rc}.post.weight", half, fH, 1)
        add(f"{rc}.post.bias", half)

    # --- dec (HiFi-GAN) ---
    U0 = hp.upsample_initial_channel
    add("dec.conv_pre.weight", U0, inter, 7)
    add("dec.conv_pre.bias", U0)
    if hp.gin_channels:
        add("dec.cond.weight", U0, hp.gin_channels, 1)
        add("dec.cond.bias", U0)
    ch = U0
    nk = hp.num_resblock_kernels
    for i in range(hp.num_upsamples):
        ch_out = U0 // (2 ** (i + 1))
        add(f"dec.ups.{i}.weight", ch, ch_out, hp.upsample_kernel_sizes[i])
        add(f"dec.ups.{i}.bias", ch_out)
        for j in range(nk):
            rb = f"dec.resblocks.{i * nk + j}"
            kj = hp.resblock_kernel_sizes[j]
            for m, _d in enumerate(hp.resblock_dilation_sizes[j]):
                if hp.resblock == "2":
                    add(f"{rb}.convs.{m}.weight", ch_out, ch_out, kj)
                    add(f"{rb}.convs.{m}.bias", ch_out)
                else:
                    add(f"{rb}.convs1.{m}.weight", ch_out, ch_out, kj)
                    add(f"{rb}.convs1.{m}.bias", ch_out)
                    add(f"{rb}.convs2.{m}.weight", ch_out, ch_out, kj)
                    add(f"{rb}.convs2.{m}.bias", ch_out)
        ch = ch_out
    add("dec.conv_post.weight", 1, ch, 7)
    add("dec.conv_post.bias", 1)

    # --- speakers ---
    if hp.n_speakers > 1:
        add("emb_g.weight", hp.n_speakers, hp.gin_channels, s=0.1)
    return w


def _stub_nodes(hp: VitsHParams):
    """Minimal node list carrying the attributes hparam derivation reads.

    A real export has ~2755 nodes; hparam inference only consumes the Conv /
    ConvTranspose attributes (strides, dilations) attached to named weights,
    so the synthetic graph carries exactly those.
    """
    nodes = [node("Gather", ["enc_p.emb.weight", "input"], ["emb_out"], axis=0)]
    nk = hp.num_resblock_kernels
    for i in range(hp.num_upsamples):
        k, u = hp.upsample_kernel_sizes[i], hp.upsample_rates[i]
        pad = (k - u) // 2
        nodes.append(
            node(
                "ConvTranspose",
                [f"up_in_{i}", f"dec.ups.{i}.weight", f"dec.ups.{i}.bias"],
                [f"up_out_{i}"],
                strides=[u],
                pads=[pad, pad],
                kernel_shape=[k],
                group=1,
                dilations=[1],
            )
        )
        convs_key = "convs" if hp.resblock == "2" else "convs1"
        for j in range(nk):
            rb = f"dec.resblocks.{i * nk + j}"
            kj = hp.resblock_kernel_sizes[j]
            for m, d in enumerate(hp.resblock_dilation_sizes[j]):
                nodes.append(
                    node(
                        "Conv",
                        [f"rb_in_{i}_{j}_{m}",
                         f"{rb}.{convs_key}.{m}.weight",
                         f"{rb}.{convs_key}.{m}.bias"],
                        [f"rb_out_{i}_{j}_{m}"],
                        dilations=[d],
                        pads=[(kj - 1) // 2 * d] * 2,
                        kernel_shape=[kj],
                        strides=[1],
                        group=1,
                    )
                )
    for i in range(hp.flow_n_flows):
        rc = f"flow.flows.{2 * i}"
        for j in range(hp.flow_n_layers):
            d = hp.flow_dilation_rate**j
            nodes.append(
                node(
                    "Conv",
                    [f"wn_in_{i}_{j}", f"{rc}.enc.in_layers.{j}.weight", f"{rc}.enc.in_layers.{j}.bias"],
                    [f"wn_out_{i}_{j}"],
                    dilations=[d],
                    pads=[(hp.flow_kernel_size - 1) // 2 * d] * 2,
                    kernel_shape=[hp.flow_kernel_size],
                    strides=[1],
                    group=1,
                )
            )
    return nodes


def default_phoneme_id_map(num_symbols: int) -> Dict[str, list]:
    """A usable single-char map: pad/bos/eos plus printable + IPA symbols."""
    id_map = {"_": [0], "^": [1], "$": [2]}
    # Common espeak IPA inventory + ascii letters; ids 3..num_symbols-1.
    symbols = (
        "abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "0123456789!'(),-.:;? "
        "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
    )
    next_id = 3
    for ch in symbols:
        if ch in id_map or next_id >= num_symbols:
            continue
        id_map[ch] = [next_id]
        next_id += 1
    return id_map


def make_synthetic_voice(
    out_dir: str | Path,
    quality: str = "medium",
    seed: int = 0,
    n_speakers: int = 1,
    gin_channels: int = 0,
    voice_name: Optional[str] = None,
) -> Tuple[Path, Path]:
    """Write `<voice>.onnx` + `<voice>.onnx.json`; returns (model, config) paths."""
    from dataclasses import replace

    hp = PRESETS[quality]
    if n_speakers > 1:
        hp = replace(hp, n_speakers=n_speakers, gin_channels=gin_channels or 256)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = voice_name or f"synthetic-{quality}"
    model_path = out_dir / f"{name}.onnx"
    config_path = out_dir / f"{name}.onnx.json"

    weights = synthetic_params(hp, seed=seed)
    inputs = [
        OnnxValueInfo("input", TensorDataType.INT64, [1, "P"]),
        OnnxValueInfo("input_lengths", TensorDataType.INT64, [1]),
        OnnxValueInfo("scales", TensorDataType.FLOAT, [3]),
    ]
    if hp.n_speakers > 1:
        inputs.append(OnnxValueInfo("sid", TensorDataType.INT64, [1]))
    outputs = [OnnxValueInfo("output", TensorDataType.FLOAT, [1, 1, 1, "T"])]
    save_model(
        str(model_path),
        _stub_nodes(hp),
        weights,
        inputs,
        outputs,
        graph_name=name,
        opset=15,
    )

    config = {
        "audio": {"sample_rate": hp.sample_rate, "quality": quality},
        "espeak": {"voice": "en-gb-x-rp"},
        "inference": {"noise_scale": 0.667, "length_scale": 1.0, "noise_w": 0.8},
        "phoneme_type": "espeak",
        "phoneme_id_map": default_phoneme_id_map(hp.n_vocab),
        "num_symbols": hp.n_vocab,
        "num_speakers": hp.n_speakers,
        "language": {"code": "en_GB"},
        "dataset": "synthetic",
        "piper_version": "synthetic",
    }
    if hp.n_speakers > 1:
        config["speaker_id_map"] = {f"spk{i}": i for i in range(hp.n_speakers)}
    with open(config_path, "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False, indent=1)
    return model_path, config_path
