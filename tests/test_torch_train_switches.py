"""The three training dispatch switches of the JAX config in the port:
``train.fused_wn`` (kernel E or its plain version), ``train.fused_attn``
(kernel F or its plain version), read by ``Synthesizer.from_config`` as
the JAX model reads them, and ``train.folded_mrf``, which the port reads
only to say, once, that its training decoder never folds (on the H100 the
fold was the slower route: ``chip_smoke.py --fold``).

- Each switch routes the training forward on CPU tensors (spies on E's,
  F's and the fold's entry points), and none changes its outputs: every
  combination within 1e-5 of the all-on one (on the CPU E and F run their
  plain versions either way).
- On the card E and F are the only training routes: a switch off raises
  there, naming the switch (the card is stood in for by the modules'
  ``_on_card``).
- ``folded_mrf`` true logs the note once a process and calls no fold.
- Serving dispatch is the same under either ``folded_mrf`` (same calls,
  the same bits).
- The folded stage of ``ops/folded_mrf.py`` (kept: the ``--fold`` A/B
  runs it) equals the plain ResBlock1 stage in value and gradient at
  C = 64 fold 2 and C = 32 fold 4, in f32, at
  ``tests/test_models.py::TestFoldedMRFTraining``'s tolerances (output
  1e-5, each gradient 2e-4 relative + 2e-5 of its peak).
- The port's fold gradient equals JAX's ``ops/folded_mrf.py::
  mrf_stage_folded`` gradient on the same numpy inputs, each gradient
  within 1e-5 of its peak (f32 summation order).
"""

import copy
import itertools

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vispeech_tpu.ops import folded_mrf as jax_folded_mrf
from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.models import synthesizer
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.ops import attention, folded_mrf, wavenet
from vispeech_tpu_torch.ops.kernels import (
    mrf_stage,
    mrf_stage_folded,
    rel_attention,
    rel_attention_train,
    wn_stack,
    wn_stack_train,
)
from vispeech_tpu_torch.ops.resblock import ResBlock1

N_VOCAB = 40
TINY = {
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": 8, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 8, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 16,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6},
}
ENTRY_POINTS = {"wn": (wn_stack_train, "wn_stack_train"),
                "attn": (rel_attention_train, "relative_self_attention_train"),
                "fold": (folded_mrf, "mrf_stage_folded")}
SERVING_ENTRY_POINTS = {"A": (rel_attention, "relative_self_attention"),
                        "B": (wn_stack, "wn_stack"), "C": (mrf_stage, "mrf_stack"),
                        "D": (mrf_stage_folded, "mrf_stack_folded"),
                        "fold": (folded_mrf, "mrf_stage_folded")}


@pytest.fixture
def spies(monkeypatch):
    """Count the calls of each entry point of ``points`` → {name: count}."""
    def install(points):
        counts = dict.fromkeys(points, 0)
        for name, (mod, attr) in points.items():
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _name=name, **k):
                counts[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, attr, wrapped)
        return counts
    return install


def _synth(**switches):
    cfg = copy.deepcopy(TINY)
    cfg["train"].update(switches)
    return random_init_(Synthesizer.from_config(config_from_dict(cfg), N_VOCAB), 0).eval()


def _train_forward(model):
    r = np.random.RandomState(0)
    dur = torch.tensor([[2, 3, 2, 1, 2, 2], [3, 2, 2, 2, 0, 0]])
    T = 16
    spec = torch.from_numpy(r.randn(2, T, 9).astype(np.float32))
    out = model(torch.from_numpy(r.randint(1, N_VOCAB, (2, 6))), torch.tensor([6, 4]),
                torch.from_numpy(r.uniform(80, 400, (2, 6)).astype(np.float32)),
                torch.from_numpy(r.uniform(30, 90, (2, 6)).astype(np.float32)), dur, spec,
                dur.sum(1), torch.tensor([0, 3]),
                eps_q=torch.from_numpy(r.randn(2, T, 8).astype(np.float32)),
                ids_slice=torch.tensor([1, 3]))
    return out[0], out[1:4], out[7]


SWITCHES = list(itertools.product((True, False), repeat=3))


@pytest.mark.parametrize("fused_wn,fused_attn,folded_mrf", SWITCHES)
def test_switches_route_the_training_forward(spies, fused_wn, fused_attn, folded_mrf):
    want = _train_forward(_synth(folded_mrf=True))
    model = _synth(fused_wn=fused_wn, fused_attn=fused_attn, folded_mrf=folded_mrf)
    counts = spies(ENTRY_POINTS)
    got = _train_forward(model)
    n_attn = sum(isinstance(m, attention.MultiHeadAttention) for m in model.modules())
    # E: the posterior encoder and 4 couplings; F: every attention layer;
    # the fold: never, whatever folded_mrf says
    assert counts == {"wn": 5 * fused_wn, "attn": n_attn * fused_attn, "fold": 0}
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("switch,module", [("fused_wn", wavenet), ("fused_attn", attention)],
                         ids=["wn", "attn"])
def test_a_switch_off_refuses_the_card(monkeypatch, switch, module):
    model = _synth(**{switch: False})
    _train_forward(model)   # CPU tensors: the plain version
    monkeypatch.setattr(module, "_on_card", lambda x: True)
    with pytest.raises(RuntimeError, match=f"train.{switch} is false"):
        _train_forward(model)
    _train_forward(_synth())   # switched on, the wrapper takes the tensor


def test_folded_mrf_is_noted_once_and_not_followed(spies, caplog):
    synthesizer._note_unfolded_decoder.cache_clear()
    counts = spies(ENTRY_POINTS)
    with caplog.at_level(logging.WARNING, logger="vispeech_tpu_torch"):
        _synth(folded_mrf=False)
        assert not caplog.records
        _train_forward(_synth(folded_mrf=True))
        _synth(folded_mrf=True)
    notes = [r for r in caplog.records if "train.folded_mrf is true" in r.getMessage()]
    assert len(notes) == 1 and counts["fold"] == 0


def test_serving_dispatch_ignores_folded_mrf(spies):
    outs, calls = [], []
    for folded in (True, False):
        model = _synth(folded_mrf=folded)
        counts = spies(SERVING_ENTRY_POINTS)
        outs.append(model.infer(torch.tensor([[3, 5, 7, 9]]), torch.tensor([4]), 12,
                                sid=torch.tensor([1]), noise_scale=0.0)[0])
        calls.append(dict(counts))
    assert calls[0] == calls[1] and calls[0]["fold"] == 0 and calls[0]["D"] == 2
    assert torch.equal(outs[0], outs[1])


def _stage(C, seed=0):
    torch.manual_seed(seed)
    blocks = torch.nn.ModuleList(ResBlock1(C, k, d) for k, d in zip((3, 7, 11),
                                                                    ((1, 3, 5),) * 3))
    for name, p in blocks.named_parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape) * (0.05 if name.endswith("weight_v") else 0.1)
                    + (0.5 if name.endswith("weight_g") else 0.0))
    return blocks


STAGES = [(64, 2, 64), (32, 4, 128)]   # C, fold, T


@pytest.mark.parametrize("C,fold,T", STAGES)
def test_folded_stage_equals_resblock1_in_value_and_gradient(C, fold, T):
    blocks = _stage(C)
    r = np.random.RandomState(1)
    x0 = torch.from_numpy(r.randn(2, C, T).astype(np.float32))
    dy = torch.from_numpy(r.randn(2, C, T).astype(np.float32))

    def run(folded):
        x = x0.clone().requires_grad_(True)
        if folded:
            y = folded_mrf.mrf_stage_folded(x.transpose(1, 2), [b.packed() for b in blocks],
                                            (3, 7, 11), ((1, 3, 5),) * 3, fold).transpose(1, 2)
        else:
            y = sum(b.forward_cf(x) for b in blocks) / 3
        return y.detach(), torch.autograd.grad(y, [x, *blocks.parameters()], dy)

    y1, g1 = run(True)
    y0, g0 = run(False)
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    for a, b in zip(g1, g0):
        scale = max(float(b.abs().max()), 1e-6)
        torch.testing.assert_close(a / scale, b / scale, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("C,fold,T", STAGES)
def test_fold_gradient_matches_jax(C, fold, T):
    r = np.random.RandomState(2)
    x = r.randn(2, T, C).astype(np.float32)
    dy = r.randn(2, T, C).astype(np.float32)
    packed = [tuple(a.astype(np.float32) for a in (
        r.randn(3, k, C, C) * 0.05, r.randn(3, 1, C) * 0.1,
        r.randn(3, k, C, C) * 0.05, r.randn(3, 1, C) * 0.1)) for k in (3, 7, 11)]
    ks, dils = (3, 7, 11), ((1, 3, 5),) * 3

    @jax.jit
    def jax_grads(x, p, dy):
        _, vjp = jax.vjp(lambda x, p: jax_folded_mrf.mrf_stage_folded(x, p, ks, dils, fold),
                         x, p)
        return vjp(dy)

    want = jax.tree_util.tree_leaves(jax_grads(
        jnp.asarray(x), [tuple(map(jnp.asarray, b)) for b in packed], jnp.asarray(dy)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = [tuple(torch.from_numpy(a).requires_grad_(True) for a in b) for b in packed]
    y = folded_mrf.mrf_stage_folded(tx, tp, ks, dils, fold)
    got = torch.autograd.grad(y, [tx, *[a for b in tp for a in b]], torch.from_numpy(dy))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * max(float(np.abs(b).max()), 1e-6)
