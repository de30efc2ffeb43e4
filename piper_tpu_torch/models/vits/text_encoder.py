"""VITS text encoder: phoneme embedding + relative-position transformer.

Counterpart of piper_tpu.models.vits.text_encoder, over the flat param dict,
with its per-layer trace points (`utils/debug_trace.py`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from piper_tpu_torch.models.vits.hparams import VitsHParams
from piper_tpu_torch.models.vits.params import Params, Prefix
from piper_tpu_torch.ops.attention import multi_head_attention
from piper_tpu_torch.ops.conv import conv1d, conv1d_same
from piper_tpu_torch.ops.masking import sequence_mask
from piper_tpu_torch.ops.nn import layer_norm_channels
from piper_tpu_torch.utils.debug_trace import trace_put


def _ffn(x: torch.Tensor, x_mask: torch.Tensor, p: Prefix) -> torch.Tensor:
    """Encoder feed-forward: conv(k) -> relu -> conv(k), same-padded, masked."""
    h = conv1d_same(x * x_mask, p["conv_1.weight"], p["conv_1.bias"])
    h = torch.relu(h)
    h = conv1d_same(h * x_mask, p["conv_2.weight"], p["conv_2.bias"])
    return h * x_mask


def _attn_layer(
    x: torch.Tensor, attn_mask: torch.Tensor, p: Prefix, hp: VitsHParams
) -> torch.Tensor:
    q = conv1d(x, p["conv_q.weight"], p["conv_q.bias"])
    k = conv1d(x, p["conv_k.weight"], p["conv_k.bias"])
    v = conv1d(x, p["conv_v.weight"], p["conv_v.bias"])
    out = multi_head_attention(
        q, k, v,
        n_heads=hp.n_heads,
        attn_mask=attn_mask,
        emb_rel_k=p["emb_rel_k"] if "emb_rel_k" in p else None,
        emb_rel_v=p["emb_rel_v"] if "emb_rel_v" in p else None,
        window_size=hp.window_size,
    )
    return conv1d(out, p["conv_o.weight"], p["conv_o.bias"])


def encoder(
    x: torch.Tensor, x_mask: torch.Tensor, params: Params, hp: VitsHParams, prefix: str
) -> torch.Tensor:
    """Transformer encoder stack on (B, H, T)."""
    p = Prefix(params, prefix)
    attn_mask = x_mask[:, :, None, :] * x_mask[:, :, :, None]  # (B,1,T,T)
    x = x * x_mask
    for i in range(hp.n_layers):
        y = _attn_layer(x, attn_mask, p.sub(f"attn_layers.{i}"), hp)
        trace_put(f"{prefix}.attn_layers.{i}", y)
        n1 = p.sub(f"norm_layers_1.{i}")
        x = layer_norm_channels(x + y, n1["gamma"], n1["beta"])
        trace_put(f"{prefix}.norm_layers_1.{i}", x)
        y = _ffn(x, x_mask, p.sub(f"ffn_layers.{i}"))
        trace_put(f"{prefix}.ffn_layers.{i}", y)
        n2 = p.sub(f"norm_layers_2.{i}")
        x = layer_norm_channels(x + y, n2["gamma"], n2["beta"])
        trace_put(f"{prefix}.norm_layers_2.{i}", x)
    return x * x_mask


def text_encoder(
    phoneme_ids: torch.Tensor,
    lengths: torch.Tensor,
    params: Params,
    hp: VitsHParams,
    prefix: str = "enc_p",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, P) int ids -> (x, m_p, logs_p, x_mask) with x of shape (B, H, P)."""
    p = Prefix(params, prefix)
    emb = p["emb.weight"]  # (n_vocab, H)
    x = emb[phoneme_ids] * math.sqrt(hp.hidden_channels)
    x = x.transpose(1, 2)  # (B, H, P)
    x_mask = sequence_mask(lengths, phoneme_ids.shape[1]).to(x.dtype)
    x = encoder(x, x_mask, params, hp, f"{prefix}.encoder")
    stats = conv1d(x, p["proj.weight"], p["proj.bias"]) * x_mask
    m, logs = torch.chunk(stats, 2, dim=1)
    return x, m, logs, x_mask
