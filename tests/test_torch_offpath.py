"""The model parts off the serving and training paths, against the JAX
package at small widths (C = 16, T ≤ 24): the attention variants
(cross-attention at T_s ≠ T_t, no relative tables, ``proximal_bias``,
``block_length``, 4-D ``attn_mask``), the causal and GELU FFNs, the causal
``Decoder`` and ``FFT``, the Conformer encoder in eval and in train mode
(its BatchNorms' running statistics against flax's mutated
``batch_stats``), ``intersperse``, ``subsequent_mask``,
``length_regulate_gather``, and the port's console scripts.

Every flax leaf is drawn from numpy (norm scales 1 + N(0, 0.1²), running
variances U(0.5, 1.5), the rest N(0, 0.3²)).  Tolerance 1e-5 absolute:
f32 summation order on outputs of order 1 (the Conformer's LayerNorms and
BatchNorms take E[x²] − E[x]² in flax and two passes in torch: 2e-5).
"""

import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vispeech_tpu.models import conformer as jax_conformer
from vispeech_tpu.ops import attention as jax_attention
from vispeech_tpu.ops import length_regulator as jax_lr
from vispeech_tpu.ops import masking as jax_masking
from vispeech_tpu_torch.models.conformer import ConformerEncoder, RelativeMultiHeadAttention
from vispeech_tpu_torch.models.conformer import sinusoidal_positions
from vispeech_tpu_torch.ops import attention
from vispeech_tpu_torch.ops.kernels import rel_attention
from vispeech_tpu_torch.ops.length_regulator import length_regulate, length_regulate_gather
from vispeech_tpu_torch.ops.masking import intersperse, subsequent_mask
from vispeech_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_conformer

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
NORM_ATOL = 2e-5
C, H = 16, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def draw(tree, seed):
    """Every leaf of a flax shape tree drawn from numpy → flat tree."""
    r = np.random.RandomState(seed)
    flat = {}
    for name, s in flatten_dict(tree, sep="/").items():
        a = r.randn(*s.shape)
        if name.endswith(("gamma", "scale")):
            a = 1.0 + 0.1 * a
        elif name.endswith("var"):
            a = r.uniform(0.5, 1.5, s.shape)
        else:
            a = 0.3 * a
        flat[name] = a.astype(np.float32)
    return flat


def tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def lengths_mask(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def jax_run(module, flat, *args, **kw):
    """``module`` on numpy ``args`` with ``flat`` as its parameters, jitted."""
    return np.asarray(jax.jit(lambda v: module.apply(v, *map(jnp.asarray, args), **kw))(
        {"params": tree(flat)}))


def port_load(module, flat, prefix=""):
    """``flat`` through the bridge's key map onto ``module``."""
    sd = flax_to_state_dict({prefix + k: a for k, a in flat.items()})
    module.load_state_dict({k[len(prefix.replace("/", ".")):]: v for k, v in sd.items()})
    return module.eval()


# ------------------------------------------------------------------ attention

def _inputs(seed=0, T_t=12, T_s=20):
    r = np.random.RandomState(seed)
    x = r.randn(2, T_t, C).astype(np.float32)
    c = r.randn(2, T_s, C).astype(np.float32)
    return x, c, lengths_mask([T_t, 7], T_t), lengths_mask([T_s, 11], T_s)


MHA_CASES = {
    # (window_size, proximal_bias, block_length, cross, mask)
    "cross": (None, False, None, True, "cross"),
    "cross_unmasked": (None, False, None, True, None),
    "proximal_causal": (None, True, None, False, "causal"),
    "block": (None, False, 3, False, "outer"),
    "block_unmasked": (None, False, 3, False, None),
    "window_masked": (4, False, None, False, "outer"),
    "window_proximal": (2, True, None, False, "causal"),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_attention_variants_match_jax(case, monkeypatch):
    window, proximal, block, cross, mask_kind = MHA_CASES[case]
    x, c, x_mask, c_mask = _inputs()
    src = c if cross else x
    s_mask = c_mask if cross else x_mask
    T_t, T_s = x.shape[1], src.shape[1]
    mask = None
    if mask_kind is not None:
        mask = x_mask[:, None, :, 0, None] * s_mask[:, None, None, :, 0]
        if mask_kind == "causal":
            mask = mask * np.tril(np.ones((T_t, T_s), np.float32))
    jm = jax_attention.MultiHeadAttention(C, C, H, window_size=window, proximal_bias=proximal,
                                          block_length=block)
    args = (x, src) + (() if mask is None else (mask,))
    flat = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *map(jnp.asarray, args))
                ["params"], seed=1)
    ref = jax_run(jm, flat, *args)
    ours = port_load(attention.MultiHeadAttention(C, C, H, window, proximal_bias=proximal,
                                                  block_length=block), flat)
    assert (ours.emb_rel_k is None) == (window is None)
    calls = []
    monkeypatch.setattr(rel_attention, "relative_self_attention",
                        lambda *a, **k: calls.append(1))
    with torch.no_grad():
        out = ours(t(x), c=t(src) if cross else None,
                   attn_mask=None if mask is None else t(mask)).numpy()
    assert out.shape == (2, T_t, C) and not calls   # plain PyTorch, never kernel A
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_encoder_route_still_takes_kernel_a(monkeypatch):
    """Self-attention with relative tables masked by keys alone stays on
    kernel A's wrapper (F's under autograd), whatever the new options."""
    calls = []
    fn = rel_attention.relative_self_attention
    monkeypatch.setattr(rel_attention, "relative_self_attention",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    mha = attention.MultiHeadAttention(C, C, H, 4)
    for p in mha.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x, _, x_mask, _ = _inputs()
    with torch.no_grad():
        a = mha(t(x), t(x_mask[..., 0]))
        outer = x_mask[:, None, :, 0, None] * x_mask[:, None, None, :, 0]
        b = mha(t(x), attn_mask=t(outer))
    assert calls == [1]
    valid = x_mask[..., 0] > 0
    np.testing.assert_allclose(a.numpy()[valid], b.numpy()[valid], rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal,activation", [(True, None), (False, "gelu"),
                                               (True, "gelu"), (False, None)])
def test_ffn_matches_jax(causal, activation):
    x, _, x_mask, _ = _inputs(seed=2)
    jm = jax_attention.FFN(C, 24, 3, activation=activation, causal=causal)
    flat = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(x_mask))["params"], seed=3)
    ref = jax_run(jm, flat, x, x_mask)
    ours = port_load(attention.FFN(C, C, 24, 3, activation=activation, causal=causal), flat)
    with torch.no_grad():
        out = ours(t(x), t(x_mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    if causal:   # a change at frame 5 reaches no earlier frame
        x2 = x.copy()
        x2[:, 5:] += 1.0
        with torch.no_grad():
            out2 = ours(t(x2), t(x_mask)).numpy()
        np.testing.assert_array_equal(out2[:, :5], out[:, :5])


def test_decoder_matches_jax():
    x, h, x_mask, h_mask = _inputs(seed=4, T_t=12, T_s=20)
    jm = jax_attention.Decoder(C, 24, H, n_layers=2, kernel_size=3)
    args = (x, x_mask, h, h_mask)
    flat = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *map(jnp.asarray, args))
                ["params"], seed=5)
    ref = jax_run(jm, flat, *args)
    ours = port_load(attention.Decoder(C, 24, H, n_layers=2, kernel_size=3), flat)
    with torch.no_grad():
        out = ours(*map(t, args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(out[1, 7:], 0.0)
    assert ours.self_attn_layers[0].proximal_bias
    assert not ours.encdec_attn_layers[0].proximal_bias


@pytest.mark.parametrize("proximal", [False, True])
def test_fft_matches_jax(proximal):
    x, _, x_mask, _ = _inputs(seed=6, T_t=24)
    jm = jax_attention.FFT(C, 24, H, n_layers=2, kernel_size=3, proximal_bias=proximal)
    flat = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(x_mask))["params"], seed=7)
    ref = jax_run(jm, flat, x, x_mask)
    ours = port_load(attention.FFT(C, 24, H, n_layers=2, kernel_size=3,
                                   proximal_bias=proximal), flat)
    with torch.no_grad():
        out = ours(t(x), t(x_mask)).numpy()
        x2 = x.copy()
        x2[:, 10:] += 1.0
        out2 = ours(t(x2), t(x_mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out2[:, :10], out[:, :10], rtol=0, atol=1e-6)   # causal
    assert np.abs(out2[0, 10:] - out[0, 10:]).max() > 0.01


# ------------------------------------------------------------------ Conformer

@pytest.fixture(scope="module")
def conformer():
    """A flax ConformerEncoder (D = 16, 2 blocks, 2 heads, kernel 7) with
    every parameter and running statistic drawn from numpy, and its port."""
    B, T, D = 2, 24, 16
    r = np.random.RandomState(8)
    x = r.randn(B, T, D).astype(np.float32)
    mask = lengths_mask([T, 15], T)
    jm = jax_conformer.ConformerEncoder(encoder_dim=D, n_layers=2, n_heads=2,
                                        conv_kernel_size=7, p_dropout=0.0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))
    params = draw(shapes["params"], seed=9)
    stats = draw(shapes["batch_stats"], seed=10)
    ours = ConformerEncoder(D, n_layers=2, n_heads=2, conv_kernel_size=7, p_dropout=0.0)
    load_flax_conformer(ours, params, stats)
    return {"jm": jm, "params": params, "stats": stats, "ours": ours, "x": x, "mask": mask}


def test_conformer_eval_matches_jax(conformer):
    jm, x, mask = conformer["jm"], conformer["x"], conformer["mask"]
    v = {"params": tree(conformer["params"]), "batch_stats": tree(conformer["stats"])}
    ref = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(mask)))(v))
    ours = conformer["ours"].eval()
    with torch.no_grad():
        out = ours(t(x), t(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=NORM_ATOL)
    np.testing.assert_array_equal(out[1, 15:], 0.0)
    assert ours.blocks[0].norm.eps == 1e-6


def test_conformer_train_mode_matches_flax_batch_stats(conformer):
    """In training the BatchNorms normalise with the batch's statistics and
    move their running statistics as flax does (momentum 0.9, biased
    variance), so one step's ``batch_stats`` agree."""
    jm, x, mask = conformer["jm"], conformer["x"], conformer["mask"]
    v = {"params": tree(conformer["params"]), "batch_stats": tree(conformer["stats"])}
    ref, updates = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), jnp.asarray(mask), deterministic=False, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(v)
    ours = ConformerEncoder(16, n_layers=2, n_heads=2, conv_kernel_size=7, p_dropout=0.0)
    load_flax_conformer(ours, conformer["params"], conformer["stats"]).train()
    out = ours(t(x), t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=NORM_ATOL)
    moved = 0.0
    for name, a in flatten_dict(updates["batch_stats"], sep="/").items():
        block, _, _, leaf = name.split("/")
        bn = ours.blocks[int(block[len("block_"):])].conv.bn
        got = (bn.running_mean if leaf == "mean" else bn.running_var).numpy()
        np.testing.assert_allclose(got, np.asarray(a), rtol=0, atol=NORM_ATOL)
        moved = max(moved, float(np.abs(np.asarray(a) - conformer["stats"][name]).max()))
    assert moved > 0.01
    out.sum().backward()   # trains: every parameter gets a gradient
    assert all(p.grad is not None for p in ours.parameters())


def test_conformer_pieces():
    x = np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5)
    np.testing.assert_array_equal(
        RelativeMultiHeadAttention._relative_shift(t(x)).numpy(),
        np.asarray(jax_conformer.RelativeMultiHeadAttention._relative_shift(jnp.asarray(x))))
    np.testing.assert_allclose(sinusoidal_positions(10, 8).numpy(),
                               np.asarray(jax_conformer.sinusoidal_positions(10, 8)),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------------------ helpers

def test_intersperse_and_subsequent_mask():
    for seq in ([], [3], [5, 1, 4]):
        assert intersperse(seq, 0) == jax_masking.intersperse(seq, 0)
    assert intersperse([5, 1], 9) == [9, 5, 9, 1, 9]
    np.testing.assert_array_equal(subsequent_mask(6).numpy(),
                                  np.asarray(jax_masking.subsequent_mask(6)))
    assert subsequent_mask(6).shape == (1, 1, 6, 6)


def test_length_regulate_gather_matches_jax():
    r = np.random.RandomState(11)
    x = r.randn(2, 9, 4).astype(np.float32)
    dur = r.randint(-1, 5, (2, 9))
    dur[1, 6:] = 0
    for T in (40, 12):   # past the total, and cutting it short
        f_ref, l_ref = jax.jit(jax_lr.length_regulate_gather, static_argnums=2)(
            jnp.asarray(x), jnp.asarray(dur), T)
        frames, lengths = length_regulate_gather(t(x), t(dur), T)
        np.testing.assert_array_equal(frames.numpy(), np.asarray(f_ref))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(l_ref))
        f_mm, l_mm = length_regulate(t(x), t(dur), T)
        np.testing.assert_allclose(frames.numpy(), f_mm.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(lengths.numpy(), l_mm.numpy())


# ------------------------------------------------------------------ console scripts

def test_console_scripts_resolve_without_jax():
    """Each ``vispeech-torch-*`` script of pyproject.toml names a callable
    ``main`` of the port, importable in a process that never loads JAX; the
    JAX package's scripts stay."""
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    ours = {k: v for k, v in scripts.items() if k.startswith("vispeech-torch-")}
    assert set(ours) == {"vispeech-torch-tts", "vispeech-torch-serve", "vispeech-torch-train"}
    assert {"vispeech-tts", "vispeech-serve", "vispeech-train"} <= set(scripts)
    code = (
        "import importlib, sys\n"
        f"for target in {sorted(ours.values())!r}:\n"
        "    mod, _, attr = target.partition(':')\n"
        "    assert mod.startswith('vispeech_tpu_torch.'), target\n"
        "    assert callable(getattr(importlib.import_module(mod), attr)), target\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'vispeech_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
