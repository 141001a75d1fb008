"""The pieces of kernel C's Hopper design that run in Python.

Kernel C (``ops/kernels/mrf_stage.py``, ``csrc/mrf_stage.cu``) reads its
weights prepared once (``prepare_weights``): every tap of every conv in the
order the block uses them, bf16 taps as [cout/8][cin/8][8][8] core matrices.
The serving generator keeps them while its frozen weight norms stay the
same.  The kernel itself is held against its plain version on the card
(``tests/test_torch_cuda.py``).

Tolerances: the prepared weights are the packed ones rounded to the
prepared dtype, exactly, and the biases the packed f32 ones; the plain
stage on them equals the plain stage on the packed weights exactly (it
rounds each operand to the I/O dtype the same way); against the Pallas
kernel in interpret mode at C = 64, f32, 1e-5 (summation order).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vispeech_tpu.ops.pallas.mrf_stage import mrf_stack as jax_mrf_stack
from vispeech_tpu_torch.infer.batching import DEFAULT_TIERS, SERVING_BUCKETS
from vispeech_tpu_torch.models import generator as generator_mod
from vispeech_tpu_torch.models.generator import Generator
from vispeech_tpu_torch.ops.kernels import _build, mrf_stage
from vispeech_tpu_torch.ops.layers import freeze_weight_norm
from vispeech_tpu_torch.ops.resblock import ResBlock1

KS, DILS = (3, 7, 11), ((1, 3, 5),) * 3
C = 64
SAMPLES_PER_FRAME = 256   # the C = 64 stage of configs/config.json: hop 512 / 2


def _packed(seed=0, scale=0.03, ks=KS, n_unit=3):
    r = np.random.RandomState(seed)
    return [tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        r.randn(n_unit, k, C, C) * scale, r.randn(n_unit, 1, C) * 0.1,
        r.randn(n_unit, k, C, C) * scale, r.randn(n_unit, 1, C) * 0.1)) for k in ks]


def _unpack(prep):
    """(w1, b1, w2, b2) per branch from prepared weights: the values the
    kernel reads, in f32, taken back out of its layout."""
    w, off, conv, branches = prep.w.float(), 0, 0, []
    n_unit = len(prep.dilations[0])
    for k in prep.kernel_sizes:
        convs = []
        for _ in range(2 * n_unit):
            taps = w[off:off + k * C * C]
            if prep.dtype == torch.bfloat16:
                taps = taps.reshape(k, C // 8, C // 8, 8, 8).permute(0, 2, 4, 1, 3)
            convs.append((taps.reshape(k, C, C), prep.b[conv].reshape(1, C)))
            off, conv = off + k * C * C, conv + 1
        branches.append(tuple(torch.stack([convs[2 * u + j][i] for u in range(n_unit)])
                              for j in (0, 1) for i in (0, 1)))
    assert off == w.numel() and conv == prep.b.shape[0]
    return branches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepared_weights_round_trip(dtype):
    packed = _packed()
    prep = mrf_stage.prepare_weights(packed, KS, DILS, dtype)
    assert prep.w.dtype == dtype and prep.b.dtype == torch.float32
    n_taps = 2 * 3 * sum(KS)
    assert prep.w.shape == (n_taps * C * C,) and prep.b.shape == (18, C)
    back = _unpack(prep)
    for got, want in zip(back, packed):
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape
            # weights rounded to the I/O dtype, biases kept in f32
            assert torch.equal(g, w.to(dtype).float() if i % 2 == 0 else w)


def test_prepared_bf16_taps_are_core_matrices():
    """Conv n (branch by branch, unit by unit, the dilated conv first), tap
    t: element [j][c][i][e] is w[t][cin = 8c + e][cout = 8j + i]."""
    packed = _packed(seed=1)
    prep = mrf_stage.prepare_weights(packed, KS, DILS, torch.bfloat16)
    taps = prep.w.reshape(-1, 8, 8, 8, 8)
    convs = [(k, w[u]) for (w1, _, w2, _), k in zip(packed, KS) for u in range(3)
             for w in (w1, w2)]
    starts = np.cumsum([0] + [k for k, _ in convs])
    i, e = torch.arange(8)[:, None], torch.arange(8)[None, :]
    for n, tap, j, c in ((0, 0, 0, 0), (1, 2, 7, 3), (9, 4, 2, 5), (17, 10, 5, 7),
                         (12, 6, 3, 0)):
        k, w = convs[n]
        assert tap < k
        want = w[tap][8 * c + e, 8 * j + i].to(torch.bfloat16)
        assert torch.equal(taps[starts[n] + tap, j, c], want)
    # the biases in the same conv order
    assert torch.equal(prep.b[3], packed[0][3][1, 0])
    assert torch.equal(prep.b[8], packed[1][1][1, 0])


def test_prepared_f32_taps_keep_cin_cout():
    packed = _packed(seed=2)
    prep = mrf_stage.prepare_weights(packed, KS, DILS, torch.float32)
    w1 = packed[2][0]
    off = 2 * 3 * (3 + 7) * C * C   # branches k = 3 and 7 come first
    assert torch.equal(prep.w[off:off + 11 * C * C].reshape(11, C, C), w1[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_stage_on_prepared_weights_matches(dtype):
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randn(2, 150, C).astype(np.float32)).to(dtype)
    packed = _packed(seed=4)
    prep = mrf_stage.prepare_weights(packed, KS, DILS, dtype)
    want = mrf_stage.mrf_stack_plain(x, packed, KS, DILS)
    assert torch.equal(mrf_stage.mrf_stack(x, packed, KS, DILS), want)
    assert torch.equal(mrf_stage.mrf_stack(x, packed, KS, DILS, prep), want)
    assert torch.equal(mrf_stage.mrf_stack_plain(x, _unpack(prep), KS, DILS), want)


def test_stage_without_weights_is_refused():
    x = torch.zeros(1, 20, C)
    with pytest.raises(ValueError, match="packed weights or prepared ones"):
        mrf_stage.mrf_stack(x, None, KS, DILS)
    # the plain version on the CPU reads packed weights, not the kernel's layout
    prep = mrf_stage.prepare_weights(_packed(), KS, DILS, torch.float32)
    with pytest.raises(ValueError, match="packed weights on a CPU tensor"):
        mrf_stage.mrf_stack(x, None, KS, DILS, prep)


def test_plain_stage_at_c64_matches_pallas():
    r = np.random.RandomState(5)
    x = r.randn(1, 200, C).astype(np.float32)
    packed = _packed(seed=6)
    ref = np.asarray(jax_mrf_stack(jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, [tuple(a.numpy() for a in p)
                                                              for p in packed]),
                                   KS, DILS, tile=128, interpret=True))
    got = mrf_stage.mrf_stack(torch.from_numpy(x), packed, KS, DILS).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_prepare_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="C = 64"):
        mrf_stage.prepare_weights([tuple(
            torch.zeros(3, k, 32, 32) if i % 2 == 0 else torch.zeros(3, 1, 32)
            for i in range(4)) for k in KS], KS, DILS, torch.bfloat16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        mrf_stage.prepare_weights(_packed(), KS, DILS, torch.float16)
    with pytest.raises(ValueError, match="receptive radius"):
        mrf_stage.prepare_weights(_packed(ks=(13,)), (13,), ((1, 3, 5),), torch.bfloat16)
    with pytest.raises(ValueError, match="equal units"):
        mrf_stage.prepare_weights(_packed(), KS, ((1, 3, 5), (1, 3), (1, 3, 5)),
                                  torch.bfloat16)


def test_launch_grid_is_the_kernels_grid():
    """``launch_grid`` restates the grid ``csrc/mrf_stage.cu`` launches: one
    block per ``TILE`` samples of each batch item, with its constants."""
    src = (_build.CSRC / "mrf_stage.cu").read_text()
    for name, value in (("TT", mrf_stage.TILE), ("HALO", mrf_stage.HALO),
                        ("C", mrf_stage.CHANNELS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
    assert "dim3 grid((T + TT - 1) / TT, B);" in src
    for B in DEFAULT_TIERS:
        for T in (1, 127, 128, 129) + tuple(b * SAMPLES_PER_FRAME for b in SERVING_BUCKETS):
            grid = mrf_stage.launch_grid(B, T)
            per_item = grid["blocks"] // B
            assert grid["tile"] == mrf_stage.TILE and grid["blocks"] == B * per_item
            assert (per_item - 1) * grid["tile"] < T <= per_item * grid["tile"]


def _generator(seed=0):
    torch.manual_seed(seed)
    gen = Generator(16, "1", KS, DILS, (2,), 128, (4,))   # one upsample: C = 64
    for p in gen.parameters():
        p.data.normal_(0.0, 0.05)
    return freeze_weight_norm(gen.eval())


def test_generator_keeps_prepared_weights_while_frozen(monkeypatch):
    """The cache logic of the serving generator, driven on the CPU by
    taking the CPU for the card and the kernel for a stand-in that records
    what each request hands it: C's weights are prepared once per frozen
    weight set and dtype, no request packs them, and an in-place update or
    a re-freeze prepares them again from the tensors as they are then."""
    calls, packs, seen = [], [], []
    real, real_packed = mrf_stage.prepare_weights, ResBlock1.packed
    monkeypatch.setattr(mrf_stage, "prepare_weights", lambda *a: calls.append(a[3]) or real(*a))
    monkeypatch.setattr(ResBlock1, "packed", lambda self: packs.append(1) or real_packed(self))
    monkeypatch.setattr(generator_mod, "_on_card", lambda x: True)
    monkeypatch.setattr(mrf_stage, "mrf_stack",
                        lambda x, packed, ks, dils, prepared: seen.append((packed, prepared)) or x)
    gen = _generator()
    stage = gen.resblocks[:3]   # the C = 64 stage

    def want(dtype):
        return real([real_packed(b) for b in stage], KS, DILS, dtype)

    x = torch.randn(2, 40, 16)
    with torch.no_grad():
        gen(x)
        first = seen[-1][1]
        assert seen[-1][0] is None and calls == [torch.float32] and len(packs) == 3
        assert torch.equal(first.w, want(torch.float32).w)
        gen(x)
        assert seen[-1][0] is None and seen[-1][1] is first and len(calls) == 1 and len(packs) == 3
        gen(x.bfloat16())   # another dtype: its own operands
        assert calls == [torch.float32, torch.bfloat16] and seen[-1][1].dtype == torch.bfloat16
        gen(x)
        assert len(calls) == 3   # one stage, one cache entry: the dtype changed back
        stage[2].convs1[1].folded.mul_(2.0)
        gen(x)
        edited = seen[-1][1]
        assert len(calls) == 4 and torch.equal(edited.w, want(torch.float32).w)
        assert not torch.equal(edited.w, first.w)
        gen(x)
        assert seen[-1][1] is edited and len(calls) == 4
        freeze_weight_norm(gen)   # new tensors from weight_g and weight_v: the edit is gone
        gen(x)
        assert len(calls) == 5 and torch.equal(seen[-1][1].w, first.w)
        assert all(packed is None for packed, _ in seen)
    monkeypatch.setattr(generator_mod, "_on_card", lambda x: False)
    n_packs = len(packs)
    with torch.no_grad():
        gen(x)
    assert seen[-1][1] is None and seen[-1][0] is not None
    assert len(calls) == 5 and len(packs) == n_packs + 3


def test_generator_caches_nothing_on_the_cpu_or_unfrozen(monkeypatch):
    calls = []
    real = mrf_stage.prepare_weights
    monkeypatch.setattr(mrf_stage, "prepare_weights", lambda *a: calls.append(1) or real(*a))
    gen = _generator()
    with torch.no_grad():
        gen(torch.randn(1, 30, 16))
    assert not calls and not gen._kernel_cache
    monkeypatch.setattr(generator_mod, "_on_card", lambda x: True)
    for block in gen.resblocks:
        for conv in (*block.convs1, *block.convs2):
            conv.folded = None
    with torch.no_grad():
        gen(torch.randn(1, 30, 16))
    assert not calls and not gen._kernel_cache
