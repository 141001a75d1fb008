"""The FLOP and byte counts of costs.py against what
``torch.utils.flop_counter.FlopCounterMode`` counts over the plain
reference at a small width, and against the tensors' own sizes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import costs
from references import vispeech
from weights import make_state


def _flops(fn, *args, **kw):
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kw)
    return counter.get_total_flops(), out


@pytest.fixture
def model(tiny):
    state = make_state(vispeech.param_spec(tiny), tiny["weights"], 3, torch.device("cpu"))
    return vispeech.Reference(state, tiny), tiny


@pytest.mark.parametrize("n,durations", [(5, [3, 1, 4, 2, 6]), (9, [2] * 9)])
def test_model_flops_match_the_reference(model, n, durations):
    ref, cfg = model
    m = cfg["model"]
    ph = torch.arange(1, n + 1)[None]
    sid = torch.tensor([2])
    text, (w, f0, energy, x) = _flops(ref.text_side, ph, torch.tensor([n]), sid)
    t = sum(durations)
    eps = torch.zeros(1, t, m["inter_channels"])
    frames, z = _flops(ref.frames, x, torch.tensor(durations), t, sid, eps, 0.667)
    voc, _ = _flops(ref.vocode, z, sid)
    assert text == costs.text_flops(n, m)
    assert frames == costs.frame_flops(t, m)
    assert voc == costs.vocoder_flops(t, m)
    assert text + frames + voc == costs.model_flops(n, t, m)


@pytest.mark.parametrize("n", [1, 7, 30])
def test_kernel_a_counts_match_the_attention_core(model, n):
    ref, cfg = model
    h = cfg["model"]["hidden_channels"]
    x = torch.randn(1, n, h)
    total, _ = _flops(vispeech.attention, x, torch.ones(1, n), ref.P, "enc_p.encoder.attn_layers.0",
                      cfg["model"]["n_heads"])
    projections = 4 * 2 * n * h * h
    assert total - projections == costs.attention_core(n, h)


@pytest.mark.parametrize("t", [4, 33])
def test_kernel_b_counts_match_the_wavenet(model, t):
    ref, cfg = model
    h = cfg["model"]["hidden_channels"]
    g = torch.randn(1, 1, cfg["model"]["gin_channels"])
    total, _ = _flops(vispeech.wavenet, torch.randn(1, t, h), torch.ones(1, t, 1), g, ref.P,
                      "flow.flows.0.enc", costs.FLOW_LAYERS)
    cond = 2 * cfg["model"]["gin_channels"] * 2 * h * costs.FLOW_LAYERS
    assert total - cond == costs.wn_stack(t, h)


@pytest.mark.parametrize("stage", [0, 1])
def test_kernels_c_and_d_count_one_mrf_stage(model, stage):
    ref, cfg = model
    m = cfg["model"]
    c, samples = m["upsample_initial_channel"] // 2 ** (stage + 1), 37
    total, _ = _flops(ref.mrf, torch.randn(1, c, samples), stage)
    assert total == costs.mrf_stage(samples, c, m["resblock_kernel_sizes"],
                                    m["resblock_dilation_sizes"])


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def test_bytes_count_each_operand_once():
    h, heads, n = 192, 2, 100
    d = h // heads
    qkvo = [torch.empty(1, heads, n, d) for _ in range(4)]
    assert costs.attention_bytes([n], h, heads) == _nbytes(
        *qkvo, torch.empty(1, n), torch.empty(2, 2 * costs.WINDOW + 1, d))
    L = costs.FLOW_LAYERS
    assert costs.wn_bytes([n], h) == _nbytes(
        torch.empty(n, h), torch.empty(n, 1), torch.empty(n, h), torch.empty(L, 2 * h),
        torch.empty(L, costs.WN_KERNEL, h, 2 * h), torch.empty(L, 2 * h),
        torch.empty(L, h, 2 * h), torch.empty(L, 2 * h))
    ks, ds, c = (3, 7, 11), ((1, 3, 5),) * 3, 64
    weights = [torch.empty(c, c, k, dtype=torch.bfloat16) for k in ks for _ in range(6)]
    biases = [torch.empty(c) for _ in range(18)]
    assert costs.mrf_bytes([n], c, ks, ds) == _nbytes(
        torch.empty(n, c, dtype=torch.bfloat16), torch.empty(n, c, dtype=torch.bfloat16),
        *weights, *biases)


def test_bound_is_the_larger_of_the_two():
    flops, nbytes = 1e12, 1e9
    assert costs.bound_s(flops, nbytes, "bf16") == flops / costs.PEAKS["bf16"]
    assert costs.bound_s(1.0, nbytes, "bf16") == nbytes / costs.PEAKS["hbm_bytes"]


def test_shares_never_count_the_padding():
    assert costs.attention_bound([10, 50], 192, 2) < costs.attention_bound([50, 50], 192, 2)
    assert costs.wn_bound([10, 50], 192) < costs.wn_bound([50, 50], 192)
