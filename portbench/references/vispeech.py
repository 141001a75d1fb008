"""Plain PyTorch reference of vispeech's inference path, for the benchmark's
check of what the program served.

The model is innnky/vispeech's ``SynthesizerTrn`` at inference (VITS with a
FastSpeech2-style prosody side): a relative-position transformer text
encoder; a duration head (log(d + 1)); a 6-layer transformer pitch head and
a convolutional energy head, each fed back through a k3 prenet; a length
regulator; a transformer frame prior over the frames; the mean-only flow
(4 WaveNet couplings) in reverse; the HiFi-GAN generator (ResBlock1 MRF);
int16 PCM.  Parameter names follow the published state dict, so one set of
weights serves the program and this file.

It imports nothing but torch and math.  Everything runs in float32 with
TF32 off: the configuration's precision for the text side and the flow.
The configuration serves the vocoder in bf16; this file keeps it in f32,
so the gap between the two is the vocoder's rounding.  ``lowp=True`` is
the control: the same arithmetic one step below the configuration's
precision, TF32 for every float32 product and convolution, and float8
(e4m3, per-tensor scale) for the vocoder's convolution operands.

Layout: the text side and the flow work on [B, T, C]; the vocoder on
[B, C, T].
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NEG_FILL = -1e4          # masked attention scores, as the published modules
WINDOW = 4               # relative-position window of every attention layer
ENERGY_FILTER = 768      # the energy head's width, fixed in the published code
WN_KERNEL = 5            # WaveNet couplings: kernel 5, dilation 1
FLOW_LAYERS = 4
N_FLOWS = 4
POSTERIOR_LAYERS = 16    # the posterior encoder (voice conversion, training)
PITCH_LAYERS = 6
DUR_FILTER = 256


# --------------------------------------------------------------- parameters

def param_spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter of the published model, in a
    fixed order.  ``kind`` says how the benchmark draws it (weights.py)."""
    d, m = cfg["data"], cfg["model"]
    h, f, gin, inter = (m["hidden_channels"], m["filter_channels"], m["gin_channels"],
                        m["inter_channels"])
    L, k, heads = m["n_layers"], m["kernel_size"], m["n_heads"]
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def conv(name, cout, cin, kk, bias=True, kind="w"):
        spec.append((f"{name}.weight", (cout, cin, kk), kind))
        if bias:
            spec.append((f"{name}.bias", (cout,), "b"))

    def wn_conv(name, cout, cin, kk, stride=0):
        spec.append((f"{name}.weight_g", (cin if stride else cout, 1, 1),
                     f"g_t{stride}" if stride else "g"))
        spec.append((f"{name}.weight_v", (cin, cout, kk) if stride else (cout, cin, kk), "v"))
        spec.append((f"{name}.bias", (cout,), "b"))

    def layer_norm(name, c):
        spec.append((f"{name}.gamma", (c,), "one"))
        spec.append((f"{name}.beta", (c,), "zero"))

    def encoder(name, n_layers):
        for i in range(n_layers):
            a = f"{name}.attn_layers.{i}"
            spec.append((f"{a}.emb_rel_k", (1, 2 * WINDOW + 1, h // heads), "rel"))
            spec.append((f"{a}.emb_rel_v", (1, 2 * WINDOW + 1, h // heads), "rel"))
            for p in ("q", "k", "v", "o"):
                conv(f"{a}.conv_{p}", h, h, 1)
            layer_norm(f"{name}.norm_layers_1.{i}", h)
            conv(f"{name}.ffn_layers.{i}.conv_1", f, h, k)
            conv(f"{name}.ffn_layers.{i}.conv_2", h, f, k)
            layer_norm(f"{name}.norm_layers_2.{i}", h)

    def wavenet(name, n_layers):
        wn_conv(f"{name}.cond_layer", 2 * h * n_layers, gin, 1)
        for i in range(n_layers):
            wn_conv(f"{name}.in_layers.{i}", 2 * h, h, WN_KERNEL)
        for i in range(n_layers):
            wn_conv(f"{name}.res_skip_layers.{i}", 2 * h if i < n_layers - 1 else h, h, 1)

    spec.append(("enc_p.symbol_emb.weight", (len(cfg["symbols"]), h), "emb_sym"))
    encoder("enc_p.encoder", L)

    u0 = m["upsample_initial_channel"]
    conv("dec.conv_pre", u0, inter, 7)
    conv("dec.cond", u0, gin, 1)
    ch = u0
    for i, (u, kk) in enumerate(zip(m["upsample_rates"], m["upsample_kernel_sizes"])):
        wn_conv(f"dec.ups.{i}", ch // 2, ch, kk, stride=u)
        ch //= 2
    ch = u0
    n_rb = len(m["resblock_kernel_sizes"])
    for i in range(len(m["upsample_rates"])):
        ch //= 2
        for j, (rk, rd) in enumerate(zip(m["resblock_kernel_sizes"],
                                         m["resblock_dilation_sizes"])):
            for c in ("convs1", "convs2"):
                for u in range(len(rd)):
                    wn_conv(f"dec.resblocks.{i * n_rb + j}.{c}.{u}", ch, ch, rk)
    conv("dec.conv_post", 1, ch, 7, bias=False, kind="w_post")

    conv("enc_q.pre", h, d["filter_length"] // 2 + 1, 1)
    wavenet("enc_q.enc", POSTERIOR_LAYERS)
    conv("enc_q.proj", 2 * inter, h, 1)

    for i in range(N_FLOWS):
        conv(f"flow.flows.{2 * i}.pre", h, inter // 2, 1)
        wavenet(f"flow.flows.{2 * i}.enc", FLOW_LAYERS)
        conv(f"flow.flows.{2 * i}.post", inter // 2, h, 1)

    conv("duration_predictor.cond", h, gin, 1)
    conv("duration_predictor.conv_1", DUR_FILTER, h, k)
    layer_norm("duration_predictor.norm_1", DUR_FILTER)
    conv("duration_predictor.conv_2", DUR_FILTER, DUR_FILTER, k)
    layer_norm("duration_predictor.norm_2", DUR_FILTER)
    conv("duration_predictor.proj", 1, DUR_FILTER, 1, kind="w_dur")
    spec[-1] = ("duration_predictor.proj.bias", (1,), "dur_bias")

    encoder("frame_prior_net.fft_block", L)

    conv("pitch_predictor.cond", h, gin, 1)
    encoder("pitch_predictor.pitch_net", PITCH_LAYERS)
    conv("pitch_predictor.proj_f0", 1, h, 1)

    conv("energy_predictor.cond", h, gin, 1)
    e = "energy_predictor.predictor"
    conv(f"{e}.conv_layer.conv_1.conv", ENERGY_FILTER, h, 3)
    spec.append((f"{e}.conv_layer.layer_norm_1.weight", (ENERGY_FILTER,), "one"))
    spec.append((f"{e}.conv_layer.layer_norm_1.bias", (ENERGY_FILTER,), "zero"))
    conv(f"{e}.conv_layer.conv_2.conv", ENERGY_FILTER, ENERGY_FILTER, 3)
    spec.append((f"{e}.conv_layer.layer_norm_2.weight", (ENERGY_FILTER,), "one"))
    spec.append((f"{e}.conv_layer.layer_norm_2.bias", (ENERGY_FILTER,), "zero"))
    spec.append((f"{e}.linear_layer.weight", (1, ENERGY_FILTER), "w"))
    spec.append((f"{e}.linear_layer.bias", (1,), "b"))

    conv("project.proj", 2 * inter, h, 1, kind="w_proj")
    conv("pitch_prenet", h, 1, 3)
    conv("energy_prenet", h, 1, 3)
    spec.append(("emb_g.weight", (d["n_speakers"], gin), "emb"))
    return spec


# ---------------------------------------------------------------- precision

@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for float32 products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale, back in f32."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


# ------------------------------------------------------------------ layers

def linear(x, P, name):
    """A 1×1 convolution over the last axis of [B, T, C]."""
    w = P[f"{name}.weight"]
    b = P.get(f"{name}.bias")
    return F.linear(x, w.reshape(w.shape[0], -1), b)


def conv_tc(x, w, b, dilation=1):
    """Symmetric 'same' convolution of [B, T, C] with w [cout, cin, k]."""
    pad = (w.shape[-1] * dilation - dilation) // 2
    return F.conv1d(x.transpose(1, 2), w, b, padding=pad, dilation=dilation).transpose(1, 2)


def weight_norm(P, name, dim_out=0):
    """w = g·v/‖v‖, ‖·‖ over every dim but ``dim_out`` (ε 1e-12 inside the root)."""
    v, g = P[f"{name}.weight_v"], P[f"{name}.weight_g"]
    dims = tuple(i for i in range(v.dim()) if i != dim_out)
    return v * (g / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12))


def layer_norm(x, gamma, beta):
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, 1e-5)


def attention(x, key_mask, P, name, heads):
    """Self-attention with shared relative key and value tables over a
    window of ±4 positions; masked keys score −1e4."""
    B, T, C = x.shape
    d = C // heads

    def split(t):
        return t.reshape(B, T, heads, d).transpose(1, 2)

    q = split(linear(x, P, f"{name}.conv_q")) * (1.0 / math.sqrt(d))
    k, v = split(linear(x, P, f"{name}.conv_k")), split(linear(x, P, f"{name}.conv_v"))
    rel_k, rel_v = P[f"{name}.emb_rel_k"][0], P[f"{name}.emb_rel_v"][0]   # [2w+1, d]
    offset = torch.arange(T, device=x.device)[None, :] - torch.arange(T, device=x.device)[:, None]
    band = offset.abs() <= WINDOW
    idx = offset.clamp(-WINDOW, WINDOW) + WINDOW                             # [T, T]
    scores = q @ k.transpose(-1, -2)
    rel_scores = q @ rel_k.t()                                               # [B, H, T, 2w+1]
    scores = scores + torch.where(band, torch.gather(
        rel_scores, 3, idx.expand(B, heads, T, T)), torch.zeros((), device=x.device))
    scores = scores.masked_fill(key_mask[:, None, None, :] == 0, NEG_FILL)
    p = torch.softmax(scores, dim=-1)
    out = p @ v
    p_band = torch.zeros(B, heads, T, 2 * WINDOW + 1, device=x.device)
    p_band.scatter_add_(3, idx.expand(B, heads, T, T), torch.where(band, p, 0.0))
    out = out + p_band @ rel_v
    return linear(out.transpose(1, 2).reshape(B, T, C), P, f"{name}.conv_o")


def encoder(x, mask, P, name, n_layers, heads):
    """Post-norm transformer: LN(x + attn), LN(x + conv FFN), masked."""
    key_mask = mask[..., 0]
    x = x * mask
    for i in range(n_layers):
        a = attention(x, key_mask, P, f"{name}.attn_layers.{i}", heads)
        x = layer_norm(x + a, P[f"{name}.norm_layers_1.{i}.gamma"],
                       P[f"{name}.norm_layers_1.{i}.beta"])
        fn = f"{name}.ffn_layers.{i}"
        y = F.relu(conv_tc(x * mask, P[f"{fn}.conv_1.weight"], P[f"{fn}.conv_1.bias"]))
        y = conv_tc(y * mask, P[f"{fn}.conv_2.weight"], P[f"{fn}.conv_2.bias"]) * mask
        x = layer_norm(x + y, P[f"{name}.norm_layers_2.{i}.gamma"],
                       P[f"{name}.norm_layers_2.{i}.beta"])
    return x * mask


def wavenet(x, mask, g, P, name, n_layers):
    """Non-causal WaveNet: gated k5 convs conditioned on the speaker, 1×1
    residual and skip outputs; masked after every residual update."""
    C = x.shape[-1]
    cond = linear(g, P.with_norm(f"{name}.cond_layer"), f"{name}.cond_layer")   # [B, 1, 2CL]
    skip = torch.zeros_like(x)
    for i in range(n_layers):
        a = conv_tc(x, weight_norm(P, f"{name}.in_layers.{i}"), P[f"{name}.in_layers.{i}.bias"])
        a = a + cond[..., 2 * C * i:2 * C * (i + 1)]
        z = torch.tanh(a[..., :C]) * torch.sigmoid(a[..., C:])
        rs = F.linear(z, weight_norm(P, f"{name}.res_skip_layers.{i}")[..., 0],
                      P[f"{name}.res_skip_layers.{i}.bias"])
        if i < n_layers - 1:
            x = (x + rs[..., :C]) * mask
            skip = skip + rs[..., C:]
        else:
            skip = skip + rs
    return skip * mask


class Params(dict):
    """name → tensor, with ``with_norm(name)``: a view whose ``name.weight``
    is the weight-normed weight (for 1×1 weight-normed convs)."""

    def with_norm(self, name):
        return {f"{name}.weight": weight_norm(self, name), f"{name}.bias": self[f"{name}.bias"]}


# ------------------------------------------------------------------- model

class Reference:
    """The published inference path over the weights ``state`` (name →
    tensor), the configuration ``cfg`` (the benchmark's file) and, for the
    control, ``lowp``."""

    def __init__(self, state: Dict[str, torch.Tensor], cfg: Dict, lowp: bool = False):
        self.P = Params((k, v.float()) for k, v in state.items())
        self.cfg = cfg
        self.m = cfg["model"]
        self.lowp = lowp

    def speaker(self, sid: torch.Tensor) -> torch.Tensor:
        return self.P["emb_g.weight"][sid][:, None, :]

    @torch.no_grad()
    def text_side(self, ph: torch.Tensor, lengths: torch.Tensor, sid: torch.Tensor):
        """ph [B, N] ids, lengths [B], sid [B] → (w [B, N] = e^logw − 1 on
        valid phonemes, f0 [B, N] Hz, energy [B, N], x [B, N, h]: the states
        that the length regulator expands)."""
        P, m = self.P, self.m
        with precision(self.lowp):
            B, N = ph.shape
            h = m["hidden_channels"]
            mask = (torch.arange(N, device=ph.device)[None, :] < lengths[:, None])[..., None].float()
            g = self.speaker(sid)
            x = P["enc_p.symbol_emb.weight"][ph] * math.sqrt(h)
            x = encoder(x, mask, P, "enc_p.encoder", m["n_layers"], m["n_heads"])

            dp = "duration_predictor"
            y = x + linear(g, P, f"{dp}.cond")
            y = layer_norm(F.relu(conv_tc(y * mask, P[f"{dp}.conv_1.weight"],
                                          P[f"{dp}.conv_1.bias"])),
                           P[f"{dp}.norm_1.gamma"], P[f"{dp}.norm_1.beta"])
            y = layer_norm(F.relu(conv_tc(y * mask, P[f"{dp}.conv_2.weight"],
                                          P[f"{dp}.conv_2.bias"])),
                           P[f"{dp}.norm_2.gamma"], P[f"{dp}.norm_2.beta"])
            logw = linear(y * mask, P, f"{dp}.proj") * mask
            w = (torch.exp(logw) * mask - 1.0)[..., 0]

            pp = "pitch_predictor"
            y = x + linear(g, P, f"{pp}.cond")
            y = encoder(y * mask, mask, P, f"{pp}.pitch_net", PITCH_LAYERS, m["n_heads"]) * mask
            lf0 = linear(y, P, f"{pp}.proj_f0")[..., 0]
            x = x + conv_tc(lf0[..., None], P["pitch_prenet.weight"], P["pitch_prenet.bias"])
            f0 = (torch.pow(10.0, lf0 * 500.0 / 2590.0) - 1.0) * 700.0

            e = "energy_predictor.predictor.conv_layer"
            y = x + linear(g, P, "energy_predictor.cond")
            for i in (1, 2):
                y = F.relu(conv_tc(y, P[f"{e}.conv_{i}.conv.weight"], P[f"{e}.conv_{i}.conv.bias"]))
                y = layer_norm(y, P[f"{e}.layer_norm_{i}.weight"], P[f"{e}.layer_norm_{i}.bias"])
            pred = F.linear(y, P["energy_predictor.predictor.linear_layer.weight"],
                            P["energy_predictor.predictor.linear_layer.bias"])[..., 0]
            norm_energy = ((pred * 36.0 + 60.0) * 1.0 - 60.0) / 36.0
            x = x + conv_tc(norm_energy[..., None], P["energy_prenet.weight"],
                            P["energy_prenet.bias"])
            energy = norm_energy * 36.0 + 60.0
        return w, f0, energy, x

    @torch.no_grad()
    def frames(self, x: torch.Tensor, duration: torch.Tensor, t_frames: int, sid: torch.Tensor,
               eps: torch.Tensor, noise_scale: float) -> torch.Tensor:
        """x [1, N_pad, h] (``text_side``'s), integer durations [n ≤ N_pad], the frame
        budget, the prior noise eps [1, t_frames, inter] → z [1, t_frames,
        inter]: the prior sample through the flow in reverse, zero past the
        utterance."""
        P, m = self.P, self.m
        inter = m["inter_channels"]
        with precision(self.lowp):
            idx = torch.repeat_interleave(torch.arange(len(duration), device=x.device),
                                          duration.long())
            n = min(int(idx.numel()), t_frames)
            frames = torch.zeros(1, t_frames, x.shape[-1], device=x.device)
            frames[0, :n] = x[0, idx[:n]]
            mask = torch.zeros(1, t_frames, 1, device=x.device)
            mask[0, :n] = 1.0
            y = encoder(frames * mask, mask, P, "frame_prior_net.fft_block", m["n_layers"],
                        m["n_heads"])
            stats = linear(y, P, "project.proj") * mask
            m_p, logs_p = stats[..., :inter], stats[..., inter:]
            z = m_p + eps * torch.exp(logs_p) * noise_scale

            g = self.speaker(sid)
            half = inter // 2
            for i in reversed(range(N_FLOWS)):
                z = torch.flip(z, dims=[-1])
                c = f"flow.flows.{2 * i}"
                x0, x1 = z[..., :half], z[..., half:]
                hdn = wavenet(linear(x0, P, f"{c}.pre") * mask, mask, g, P, f"{c}.enc",
                              FLOW_LAYERS)
                mean = linear(hdn, P, f"{c}.post") * mask
                z = torch.cat([x0, (x1 - mean) * mask], dim=-1)
            return z * mask

    @torch.no_grad()
    def vocode(self, z: torch.Tensor, sid: torch.Tensor) -> torch.Tensor:
        """z [1, T, inter] → audio [T·hop] in [−1, 1] (tanh)."""
        P, m = self.P, self.m
        q, conv = self._q, self._conv
        with precision(self.lowp):
            x = conv(z.transpose(1, 2), P["dec.conv_pre.weight"], P["dec.conv_pre.bias"])
            g = self.speaker(sid).transpose(1, 2)
            x = x + F.conv1d(q(g), q(P["dec.cond.weight"]), P["dec.cond.bias"])
            for i, (u, kk) in enumerate(zip(m["upsample_rates"], m["upsample_kernel_sizes"])):
                w = weight_norm(P, f"dec.ups.{i}", dim_out=0)
                x = F.conv_transpose1d(q(F.leaky_relu(x, 0.1)), q(w), P[f"dec.ups.{i}.bias"],
                                       stride=u, padding=(kk - u) // 2)
                x = self.mrf(x, i)
            x = conv(F.leaky_relu(x, 0.01), P["dec.conv_post.weight"], None)
            return torch.tanh(x)[0, 0]

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8(t) if self.lowp else t

    def _conv(self, x, w, b, dilation=1):
        """The vocoder's 'same' convolution of [B, C, T], on float8-rounded
        operands in the control."""
        return F.conv1d(self._q(x), self._q(w), b, padding=(w.shape[-1] * dilation - dilation) // 2,
                        dilation=dilation)

    def mrf(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """The mean of the stage's ResBlock1 stacks over x [1, C, T]."""
        P, m, conv = self.P, self.m, self._conv
        n_rb = len(m["resblock_kernel_sizes"])
        acc = None
        for j, rd in enumerate(m["resblock_dilation_sizes"]):
            rb = f"dec.resblocks.{stage * n_rb + j}"
            y = x
            for unit, dil in enumerate(rd):
                t = conv(F.leaky_relu(y, 0.1), weight_norm(P, f"{rb}.convs1.{unit}"),
                         P[f"{rb}.convs1.{unit}.bias"], dilation=dil)
                t = conv(F.leaky_relu(t, 0.1), weight_norm(P, f"{rb}.convs2.{unit}"),
                         P[f"{rb}.convs2.{unit}.bias"])
                y = t + y
            acc = y if acc is None else acc + y
        return acc / n_rb

    @staticmethod
    def pcm(audio: torch.Tensor) -> torch.Tensor:
        """Audio in [−1, 1] → int16 PCM, rounded to nearest."""
        return torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)
