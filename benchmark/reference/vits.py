"""Plain PyTorch VITS inference: the reference every cell's output is judged by.

Frozen copy of `tests/oracle/vits_torch.py` at commit 1fc906d (an
independent forward pass written as the JAX package's oracle, following the
published VITS), changed only so that it runs on any device from a dict of
weight tensors, and split at the durations: `encode` gives each phoneme's
frame duration before its ceil, and `decode` takes the durations to expand,
so the judge can hand it the durations it has checked. Only
torch.nn.functional primitives; imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


class P:
    """Flat-dict weight accessor with a key prefix."""

    def __init__(self, params: Dict[str, torch.Tensor], prefix: str = ""):
        self.params = params
        self.prefix = prefix

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.params[f"{self.prefix}.{key}" if self.prefix else key]

    def sub(self, key: str) -> "P":
        return P(self.params, f"{self.prefix}.{key}" if self.prefix else key)


def layer_norm(x: torch.Tensor, p: P, eps: float = 1e-5) -> torch.Tensor:
    y = x.transpose(1, -1)
    y = F.layer_norm(y, (y.shape[-1],), p["gamma"], p["beta"], eps)
    return y.transpose(1, -1)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    pos = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return (pos.unsqueeze(0) < lengths.unsqueeze(1)).unsqueeze(1).float()


# --- relative attention ---


def _get_rel_emb(emb: torch.Tensor, length: int, window: int) -> torch.Tensor:
    pad_l = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad_l > 0:
        emb = F.pad(emb, (0, 0, pad_l, pad_l))
    return emb[:, start: start + 2 * length - 1]


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x = x.view(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1))
    x = x.view(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x = x.view(b, h, l * (2 * l - 1))
    x = F.pad(x, (l, 0))
    x = x.view(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def attention(x, attn_mask, p: P, n_heads: int, window: int):
    b, c, t = x.shape
    q = F.conv1d(x, p["conv_q.weight"], p["conv_q.bias"])
    k = F.conv1d(x, p["conv_k.weight"], p["conv_k.bias"])
    v = F.conv1d(x, p["conv_v.weight"], p["conv_v.bias"])
    kc = c // n_heads

    def split(y):
        return y.view(b, n_heads, kc, t).transpose(2, 3)

    qh, kh, vh = split(q), split(k), split(v)
    scores = torch.matmul(qh / math.sqrt(kc), kh.transpose(-2, -1))
    rel_k = _get_rel_emb(p["emb_rel_k"], t, window)
    rel_logits = torch.matmul(qh / math.sqrt(kc), rel_k.unsqueeze(0).transpose(-2, -1))
    scores = scores + _rel_to_abs(rel_logits)
    scores = scores.masked_fill(attn_mask == 0, -1e4)
    w = F.softmax(scores, dim=-1)
    out = torch.matmul(w, vh)
    rel_v = _get_rel_emb(p["emb_rel_v"], t, window)
    out = out + torch.matmul(_abs_to_rel(w), rel_v.unsqueeze(0))
    out = out.transpose(2, 3).contiguous().view(b, c, t)
    return F.conv1d(out, p["conv_o.weight"], p["conv_o.bias"])


def ffn(x, x_mask, p: P, kernel: int):
    pad = (kernel - 1) // 2
    h = F.conv1d(x * x_mask, p["conv_1.weight"], p["conv_1.bias"], padding=pad)
    h = torch.relu(h)
    h = F.conv1d(h * x_mask, p["conv_2.weight"], p["conv_2.bias"], padding=pad)
    return h * x_mask


def encoder(x, x_mask, p: P, hp):
    attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    x = x * x_mask
    for i in range(hp["n_layers"]):
        y = attention(x, attn_mask, p.sub(f"attn_layers.{i}"), hp["n_heads"], hp["window_size"])
        x = layer_norm(x + y, p.sub(f"norm_layers_1.{i}"))
        y = ffn(x, x_mask, p.sub(f"ffn_layers.{i}"), hp["kernel_size"])
        x = layer_norm(x + y, p.sub(f"norm_layers_2.{i}"))
    return x * x_mask


def text_encoder(ids, lengths, params, hp):
    p = P(params, "enc_p")
    x = p["emb.weight"][ids] * math.sqrt(hp["hidden_channels"])
    x = x.transpose(1, 2)
    x_mask = sequence_mask(lengths, ids.shape[1])
    x = encoder(x, x_mask, p.sub("encoder"), hp)
    stats = F.conv1d(x, p["proj.weight"], p["proj.bias"]) * x_mask
    m, logs = stats.split(hp["inter_channels"], dim=1)
    return x, m, logs, x_mask


# --- stochastic duration predictor ---


def dds_conv(x, x_mask, p: P, kernel: int, g=None):
    if g is not None:
        x = x + g
    ch = x.shape[1]
    for i in range(3):
        d = kernel ** i
        pad = (kernel - 1) // 2 * d
        y = F.conv1d(x * x_mask, p[f"convs_sep.{i}.weight"], p[f"convs_sep.{i}.bias"],
                     padding=pad, dilation=d, groups=ch)
        y = layer_norm(y, p.sub(f"norms_1.{i}"))
        y = F.gelu(y)
        y = F.conv1d(y, p[f"convs_1x1.{i}.weight"], p[f"convs_1x1.{i}.bias"])
        y = layer_norm(y, p.sub(f"norms_2.{i}"))
        y = F.gelu(y)
        x = x + y
    return x * x_mask


def rq_spline_inverse(x, uw, uh, ud, tail_bound=5.0):
    """Inverse rational-quadratic spline with linear tails (elementwise)."""
    min_bw = min_bh = min_d = 1e-3
    nb = uw.shape[-1]
    inside = (x >= -tail_bound) & (x <= tail_bound)
    const = math.log(math.expm1(1 - min_d))
    ud = F.pad(ud, (1, 1), value=const)

    widths = F.softmax(uw, dim=-1)
    widths = min_bw + (1 - min_bw * nb) * widths
    cw = torch.cumsum(widths, -1)
    cw = F.pad(cw, (1, 0))
    cw = 2 * tail_bound * cw - tail_bound
    cw[..., 0] = -tail_bound
    cw[..., -1] = tail_bound
    widths = cw[..., 1:] - cw[..., :-1]

    derivs = min_d + F.softplus(ud)

    heights = F.softmax(uh, dim=-1)
    heights = min_bh + (1 - min_bh * nb) * heights
    ch_ = torch.cumsum(heights, -1)
    ch_ = F.pad(ch_, (1, 0))
    ch_ = 2 * tail_bound * ch_ - tail_bound
    ch_[..., 0] = -tail_bound
    ch_[..., -1] = tail_bound
    heights = ch_[..., 1:] - ch_[..., :-1]

    xc = x.clamp(-tail_bound, tail_bound)
    idx = (xc.unsqueeze(-1) >= ch_[..., :-1]).sum(-1) - 1
    idx = idx.clamp(0, nb - 1).unsqueeze(-1)

    def g(a):
        return a.gather(-1, idx).squeeze(-1)

    in_cw, in_w = g(cw), g(widths)
    in_ch, in_h = g(ch_), g(heights)
    in_d = g(derivs[..., :-1])
    in_d1 = derivs.gather(-1, idx + 1).squeeze(-1)
    delta = in_h / in_w

    term = (xc - in_ch) * (in_d + in_d1 - 2 * delta)
    a = term + in_h * (delta - in_d)
    b = in_h * in_d - term
    c = -delta * (xc - in_ch)
    disc = (b * b - 4 * a * c).clamp_min(0)
    root = 2 * c / (-b - torch.sqrt(disc))
    out = root * in_w + in_cw
    return torch.where(inside, out, x)


def conv_flow_reverse(x, x_mask, p: P, hp, g):
    half = x.shape[1] // 2
    x0, x1 = x[:, :half], x[:, half:]
    h = F.conv1d(x0, p["pre.weight"], p["pre.bias"])
    h = dds_conv(h, x_mask, p.sub("convs"), hp["dp_kernel_size"], g=g)
    h = F.conv1d(h, p["proj.weight"], p["proj.bias"]) * x_mask
    b, _, t = x0.shape
    nb = hp["dp_num_bins"]
    h = h.reshape(b, half, 3 * nb - 1, t).permute(0, 1, 3, 2)
    denom = math.sqrt(hp["dp_filter_channels"])
    x1 = rq_spline_inverse(x1, h[..., :nb] / denom, h[..., nb: 2 * nb] / denom,
                           h[..., 2 * nb:], tail_bound=hp["dp_tail_bound"])
    return torch.cat([x0, x1], 1) * x_mask


def sdp_reverse(x, x_mask, noise, params, hp, noise_scale):
    p = P(params, "dp")
    h = F.conv1d(x, p["pre.weight"], p["pre.bias"])
    h = dds_conv(h, x_mask, p.sub("convs"), hp["dp_kernel_size"])
    h = F.conv1d(h, p["proj.weight"], p["proj.bias"]) * x_mask

    z = noise * noise_scale
    idxs = [2 * i + 1 for i in range(hp["dp_n_flows"])]
    for idx in reversed(idxs[1:]):
        z = torch.flip(z, [1])
        z = conv_flow_reverse(z, x_mask, p.sub(f"flows.{idx}"), hp, g=h)
    z = torch.flip(z, [1])
    ea = p.sub("flows.0")
    z = (z - ea["m"].unsqueeze(0)) * torch.exp(-ea["logs"].unsqueeze(0)) * x_mask
    return z[:, :1]


# --- flow decoder ---


def wavenet(x, x_mask, p: P, hidden, n_layers, dilation_rate):
    out = torch.zeros_like(x)
    for i in range(n_layers):
        d = dilation_rate ** i
        k = p[f"in_layers.{i}.weight"].shape[-1]
        pad = (k - 1) // 2 * d
        x_in = F.conv1d(x, p[f"in_layers.{i}.weight"], p[f"in_layers.{i}.bias"],
                        padding=pad, dilation=d)
        acts = torch.tanh(x_in[:, :hidden]) * torch.sigmoid(x_in[:, hidden:])
        rs = F.conv1d(acts, p[f"res_skip_layers.{i}.weight"], p[f"res_skip_layers.{i}.bias"])
        if i < n_layers - 1:
            x = (x + rs[:, :hidden]) * x_mask
            out = out + rs[:, hidden:]
        else:
            out = out + rs
    return out * x_mask


def flow_reverse(z, y_mask, params, hp):
    p = P(params, "flow")
    for i in reversed(range(hp["flow_n_flows"])):
        z = torch.flip(z, [1])
        rc = p.sub(f"flows.{2 * i}")
        half = z.shape[1] // 2
        z0, z1 = z[:, :half], z[:, half:]
        h = F.conv1d(z0, rc["pre.weight"], rc["pre.bias"]) * y_mask
        h = wavenet(h, y_mask, rc.sub("enc"), hp["flow_hidden_channels"],
                    hp["flow_n_layers"], hp["flow_dilation_rate"])
        m = F.conv1d(h, rc["post.weight"], rc["post.bias"]) * y_mask
        z1 = (z1 - m) * y_mask
        z = torch.cat([z0, z1], 1)
    return z


# --- HiFi-GAN ---


def hifigan(z, params, hp, y_mask):
    """HiFi-GAN generator; activations are zeroed beyond each row's y_len
    before every conv, so the bucket padding behaves like the array's end."""
    p = P(params, "dec")
    use_rb2 = hp["resblock"] == "2"
    m = y_mask
    x = F.conv1d(z * m, p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
    nk = len(hp["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(hp["upsample_rates"], hp["upsample_kernel_sizes"])):
        x = F.leaky_relu(x * m, 0.1)
        x = F.conv_transpose1d(x * m, p[f"ups.{i}.weight"], p[f"ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        m = torch.repeat_interleave(m, u, dim=2)
        x = x * m
        acc = None
        for j in range(nk):
            rb = p.sub(f"resblocks.{i * nk + j}")
            kj = hp["resblock_kernel_sizes"][j]
            y = x
            for mi, d in enumerate(hp["resblock_dilation_sizes"][j]):
                yt = F.leaky_relu(y, 0.1)
                if use_rb2:
                    yt = F.conv1d(yt * m, rb[f"convs.{mi}.weight"], rb[f"convs.{mi}.bias"],
                                  padding=(kj - 1) // 2 * d, dilation=d)
                else:
                    yt = F.conv1d(yt * m, rb[f"convs1.{mi}.weight"], rb[f"convs1.{mi}.bias"],
                                  padding=(kj - 1) // 2 * d, dilation=d)
                    yt = F.leaky_relu(yt, 0.1)
                    yt = F.conv1d(yt * m, rb[f"convs2.{mi}.weight"], rb[f"convs2.{mi}.bias"],
                                  padding=(kj - 1) // 2)
                y = y + yt
            acc = y if acc is None else acc + y
        x = acc / nk
    x = F.leaky_relu(x * m)
    x = F.conv1d(x * m, p["conv_post.weight"], p["conv_post.bias"], padding=3)
    return torch.tanh(x) * m


# --- the two halves of inference ---


def generate_path(w_ceil, x_mask, y_mask):
    """(B, P) durations -> (B, T, P) alignment path."""
    t_y = y_mask.shape[-1]
    cum = torch.cumsum(w_ceil, -1)
    pos = torch.arange(t_y, device=w_ceil.device).view(1, t_y, 1)
    path = (pos < cum.unsqueeze(1)).float()
    path_prev = F.pad(path, (1, 0))[:, :, :-1]
    path = path - path_prev
    return path * y_mask.transpose(1, 2) * x_mask


def encode(params, hp, ids, lengths, dp_noise, *, length_scale, noise_w):
    """ids (B, P), lengths (B,), dp_noise (B, 2, P) -> (m_p, logs_p, x_mask,
    w): w (B, P) is each phoneme's frame duration before its ceil."""
    x, m_p, logs_p, x_mask = text_encoder(ids, lengths, params, hp)
    logw = sdp_reverse(x, x_mask, dp_noise, params, hp, noise_scale=noise_w)
    w = torch.exp(logw) * x_mask * length_scale
    return m_p, logs_p, x_mask, w[:, 0]


def decode(params, hp, m_p, logs_p, x_mask, w_ceil, main_noise, *, max_frames, noise_scale):
    """Expand the prior by the integer durations w_ceil (B, P), add the
    noise (B, C, max_frames), run the flows and the vocoder -> (audio
    (B, max_frames * hop), y_lengths (B,))."""
    y_lengths = torch.clamp(w_ceil.sum(-1), min=1, max=max_frames)
    y_mask = sequence_mask(y_lengths, max_frames)
    path = generate_path(w_ceil, x_mask, y_mask)
    m = torch.einsum("btp,bcp->bct", path, m_p)
    logs = torch.einsum("btp,bcp->bct", path, logs_p)
    z_p = m + main_noise * torch.exp(logs) * noise_scale
    z = flow_reverse(z_p, y_mask, params, hp)
    audio = hifigan(z * y_mask, params, hp, y_mask)
    return audio[:, 0, :], y_lengths
