"""Operations and bytes from shapes, and the H100's peaks: the yardstick of
the benchmark's roofline shares and MFU.

Counts are of what the inputs need: products over the valid phonemes,
frames and samples of each row, never over the padding, and each input
byte read once and each output byte written once.  Element-wise work
(activations, norms, softmax) is not counted, as a FLOP counter of the
plain reference counts none of it: ``model_flops`` equals what
``torch.utils.flop_counter.FlopCounterMode`` counts over the reference's
inference (the tests hold it to that).  So a share computed from these
counts is a lower bound of the true one and cannot pass 100 %.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence

# NVIDIA H100 SXM (80GB HBM3), published dense peaks at the 700 W limit
PEAKS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "hbm_bytes": 3.35e12}
WINDOW = 4          # relative-attention window
PITCH_LAYERS = 6
DUR_FILTER = 256
ENERGY_FILTER = 768
WN_KERNEL, FLOW_LAYERS, N_FLOWS = 5, 4, 4


def attention_core(n: int, h: int) -> float:
    """Kernel A's products for one row of n valid positions: scores, the
    weighted values and both relative-table terms, all heads together."""
    return 4.0 * n * n * h + 4.0 * n * (2 * WINDOW + 1) * h


def encoder_layer(n: int, h: int, f: int, k: int) -> float:
    """One post-norm transformer layer: q, k, v, o projections, the
    attention core, the k-tap conv FFN."""
    return 8.0 * n * h * h + attention_core(n, h) + 4.0 * n * h * f * k


def wn_stack(t: int, h: int) -> float:
    """Kernel B (one WaveNet of FLOW_LAYERS layers) over t valid frames."""
    per_layer = 2.0 * t * h * 2 * h * WN_KERNEL
    res_skip = 2.0 * t * h * 2 * h * (FLOW_LAYERS - 1) + 2.0 * t * h * h
    return per_layer * FLOW_LAYERS + res_skip


def mrf_stage(samples: int, c: int, kernel_sizes: Sequence[int],
              dilations: Sequence[Sequence[int]]) -> float:
    """One MRF stage (kernels C and D) over ``samples`` valid samples."""
    return sum(2 * len(d) * 2.0 * samples * c * c * k for k, d in zip(kernel_sizes, dilations))


def text_flops(n: int, m: Dict) -> float:
    """The text side of one request of n phonemes: encoder, duration,
    pitch and energy heads with their conditioning and prenets."""
    h, f, k, gin, L = (m["hidden_channels"], m["filter_channels"], m["kernel_size"],
                       m["gin_channels"], m["n_layers"])
    total = L * encoder_layer(n, h, f, k)
    total += 2.0 * gin * h + 2.0 * n * h * DUR_FILTER * k + 2.0 * n * DUR_FILTER * DUR_FILTER * k \
        + 2.0 * n * DUR_FILTER
    total += 2.0 * gin * h + PITCH_LAYERS * encoder_layer(n, h, f, k) + 2.0 * n * h
    total += 2.0 * n * h * 3
    total += 2.0 * gin * h + 2.0 * n * h * ENERGY_FILTER * 3 \
        + 2.0 * n * ENERGY_FILTER * ENERGY_FILTER * 3 + 2.0 * n * ENERGY_FILTER
    total += 2.0 * n * h * 3
    return total


def frame_flops(t: int, m: Dict) -> float:
    """Frame prior, projection and the flow in reverse over t frames."""
    h, f, k, gin, L, inter = (m["hidden_channels"], m["filter_channels"], m["kernel_size"],
                              m["gin_channels"], m["n_layers"], m["inter_channels"])
    total = L * encoder_layer(t, h, f, k) + 2.0 * t * h * 2 * inter
    per_flow = 2.0 * t * (inter // 2) * h + wn_stack(t, h) + 2.0 * gin * 2 * h * FLOW_LAYERS \
        + 2.0 * t * h * (inter // 2)
    return total + N_FLOWS * per_flow


def stage_lengths(t: int, m: Dict) -> Iterable[tuple]:
    """(stage, input samples, output samples, cin, cout, rate, kernel)."""
    ch, n = m["upsample_initial_channel"], t
    for i, (u, kk) in enumerate(zip(m["upsample_rates"], m["upsample_kernel_sizes"])):
        yield i, n, n * u, ch, ch // 2, u, kk
        ch, n = ch // 2, n * u


def vocoder_flops(t: int, m: Dict) -> float:
    """The generator over t frames: conv_pre, the speaker term, each
    transposed convolution and MRF stage, conv_post."""
    u0, inter, gin = m["upsample_initial_channel"], m["inter_channels"], m["gin_channels"]
    total = 2.0 * t * inter * u0 * 7 + 2.0 * gin * u0
    c, n = u0, t
    for _, n_in, n_out, cin, cout, _, kk in stage_lengths(t, m):
        total += 2.0 * n_in * cin * cout * kk
        total += mrf_stage(n_out, cout, m["resblock_kernel_sizes"], m["resblock_dilation_sizes"])
        c, n = cout, n_out
    return total + 2.0 * n * c * 7


def model_flops(n: int, t: int, m: Dict) -> float:
    """One request of n phonemes and t frames through the model once."""
    return text_flops(n, m) + frame_flops(t, m) + vocoder_flops(t, m)


# --------------------------------------------------------- kernel bounds

def bound_s(flops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAKS[peak], nbytes / PEAKS["hbm_bytes"])


def attention_bytes(rows: Sequence[int], h: int, heads: int) -> float:
    """Kernel A's f32 q, k, v, output and key mask of each row, and the two
    relative tables."""
    return sum(4.0 * (4 * n * h + n) for n in rows) + 4.0 * 2 * (2 * WINDOW + 1) * (h // heads)


def attention_bound(rows: Sequence[int], h: int, heads: int) -> float:
    """Kernel A, one launch over rows of these valid lengths (f32 operands
    on TF32 tensor cores)."""
    return bound_s(sum(attention_core(n, h) for n in rows), attention_bytes(rows, h, heads),
                   "tf32")


def wn_bytes(rows: Sequence[int], h: int) -> float:
    """Kernel B's f32 x, mask and output per frame, the conditioning per row
    and layer, the weights and biases once."""
    weights = FLOW_LAYERS * (WN_KERNEL * h * 2 * h + h * 2 * h + 2 * 2 * h)
    return 4.0 * (sum(2 * t * h + t + FLOW_LAYERS * 2 * h for t in rows) + weights)


def wn_bound(rows: Sequence[int], h: int) -> float:
    """Kernel B, one launch (one coupling's WaveNet) over rows of these
    valid frame counts."""
    return bound_s(sum(wn_stack(t, h) for t in rows), wn_bytes(rows, h), "tf32")


def mrf_bytes(samples: Sequence[int], c: int, kernel_sizes, dilations) -> float:
    """Kernel C's or D's bf16 input and output per sample, bf16 weights and
    f32 biases once."""
    weights = sum(2 * len(d) * c * c * k for k, d in zip(kernel_sizes, dilations))
    biases = sum(2 * len(d) * c for d in dilations)
    return 2.0 * sum(2 * s * c for s in samples) + 2.0 * weights + 4.0 * biases


def mrf_bound(samples: Sequence[int], c: int, kernel_sizes, dilations) -> float:
    """Kernel C or D, one launch over rows of these valid sample counts."""
    flops = sum(mrf_stage(s, c, kernel_sizes, dilations) for s in samples)
    return bound_s(flops, mrf_bytes(samples, c, kernel_sizes, dilations), "bf16")


def plan_bounds(rows_n: Sequence[int], rows_t: Sequence[int], m: Dict) -> Dict[str, float]:
    """The kernels' least times for one ``Synthesizer.infer`` plan whose
    rows have these phoneme and frame counts: kernel A over the text
    encoder, the pitch head and the frame prior; B over the four
    couplings; C and D over the MRF stages of 64 channels and fewer."""
    h, heads, L = m["hidden_channels"], m["n_heads"], m["n_layers"]
    out = {"attn": (L + PITCH_LAYERS) * attention_bound(rows_n, h, heads)
           + L * attention_bound(rows_t, h, heads),
           "wn": N_FLOWS * wn_bound(rows_t, h),
           "mrf": 0.0}
    for i, _, _, _, cout, _, _ in stage_lengths(1, m):
        if cout <= 64:
            scale = math.prod(m["upsample_rates"][:i + 1])
            out["mrf"] += mrf_bound([t * scale for t in rows_t], cout,
                                    m["resblock_kernel_sizes"], m["resblock_dilation_sizes"])
    return out


def duration_pass_bound(rows_n: Sequence[int], m: Dict) -> float:
    """Kernel A over ``TTSEngine``'s duration-only pass (the text encoder)."""
    return m["n_layers"] * attention_bound(rows_n, m["hidden_channels"], m["n_heads"])
