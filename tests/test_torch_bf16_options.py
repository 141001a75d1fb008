"""The port's bf16 training options against the JAX step's cast rules, at
``tests/test_torch_train.py``'s tiny configuration on the CPU.

For ``fp16_run`` with the ``tail_f32`` scope, ``bf16_disc``, ``bf16_only``
lists holding ``dec`` or ``dec_body``, a raw module name, and the legacy
whole-graph scopes ``stable`` and ``full``:

* the port's ``g_param_cast`` casts to bf16 exactly the parameters that
  JAX's ``g_param_cast`` casts, matched leaf by leaf through
  ``utils/jax_weights.py``'s key map;
* the discriminators run in the dtype JAX's step gives them (read by
  tracing JAX's step with ``jax.eval_shape`` around a probe that records
  what ``model_d.apply`` receives), parameters and both inputs;
* the errors of an unknown scope and of a whole-graph scope without
  ``bf16_allow_divergent`` are JAX's, word for word;
* the decoder computes in the dtype flax's promotion gives it: f32 under
  ``stable``, whose decoder parameters stay f32 while its inputs arrive in
  bf16, and bf16 under ``full``;
* each option takes a finite step, master weights staying f32.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.models import MultiPeriodDiscriminator as JaxMPD
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.train.step import Batch, TrainState, make_optimizer, make_train_step
from vispeech_tpu.train.step import g_param_cast as jax_g_param_cast
from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.dsp import spectrogram
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.train.step import TrainStep
from vispeech_tpu_torch.utils.jax_weights import port_key

N_VOCAB = 40
TINY = {   # tests/test_torch_train.py's
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False,
              "learning_rate": 2e-4, "c_mel": 45, "c_kl": 1.0},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": 8, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 8, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 16,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6},
}
B, N, T, HOP = 2, 6, 16, 8
DIVERGENT = {"fp16_run": True, "bf16_allow_divergent": True}
OPTIONS = {
    "tail_f32": {"fp16_run": True},
    "bf16_disc": {"fp16_run": True, "bf16_disc": True},
    "bf16_only_dec": {"fp16_run": True, "bf16_only": ["dec", "flow"]},
    "bf16_only_dec_body": {"fp16_run": True, "bf16_only": ["dec_body", "enc_q"]},
    "bf16_only_module": {"fp16_run": True, "bf16_only": ["emb_g", "heads"]},
    "stable": dict(DIVERGENT, bf16_scope="stable"),
    "full": dict(DIVERGENT, bf16_scope="full"),
    "full_bf16_only": dict(DIVERGENT, bf16_scope="full", bf16_only=["fpn"]),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread in this worker: xdist runs several workers on the
    machine's cores, and oversubscribed, the native CPU convs of a bf16
    discriminator step (oneDNN off) wait at a barrier per group."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(option):
    raw = json.loads(json.dumps(TINY))
    raw["train"].update(OPTIONS[option])
    return jax_config_from_dict(raw), config_from_dict(raw)


def jax_batch():
    r = np.random.RandomState(0)
    dur = r.randint(1, 4, size=(B, N))
    return Batch(
        phonemes=jnp.asarray(r.randint(1, N_VOCAB, size=(B, N)), jnp.int32),
        phoneme_lengths=jnp.asarray([N, N - 2], jnp.int32),
        f0=jnp.asarray(r.uniform(80, 400, (B, N)), jnp.float32),
        energy=jnp.asarray(r.uniform(30, 90, (B, N)), jnp.float32),
        duration=jnp.asarray(dur, jnp.int32), spec=None,
        spec_lengths=jnp.asarray(dur.sum(1), jnp.int32),
        wav=jnp.asarray(np.clip(r.randn(B, T * HOP, 1) * 0.2, -1, 1) * 32767, jnp.int16),
        wav_lengths=jnp.asarray(dur.sum(1) * HOP, jnp.int32),
        sid=jnp.asarray([0, 2], jnp.int32))


def port_batch():
    out = {}
    for k, v in jax_batch()._asdict().items():
        a = None if v is None else np.asarray(v)
        out[k] = None if a is None else torch.from_numpy(
            a.astype(np.int64) if a.dtype == np.int32 else a)
    return out


def port_models(pcfg):
    # the scale discriminator and one period keep the CPU steps short
    return (random_init_(Synthesizer.from_config(pcfg, N_VOCAB), 0),
            random_init_(MultiPeriodDiscriminator(periods=(2,)), 1))


@pytest.fixture(scope="module")
def jax_params_g():
    """The shapes of JAX's generator parameters."""
    jcfg, _ = configs("tail_f32")
    b = jax_batch()
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: JaxSynthesizer.from_config(jcfg, N_VOCAB).init(
        {"params": key, "sample": key, "dropout": key}, b.phonemes, b.phoneme_lengths,
        b.f0, b.energy, b.duration, jnp.zeros((B, T, jcfg.data.spec_channels)),
        b.spec_lengths, b.sid, deterministic=True))["params"]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_generator_casts_match_jax(option, jax_params_g):
    jcfg, pcfg = configs(option)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jax_params_g)
    cast = flatten_dict(jax_g_param_cast(jcfg)(params), sep="/")
    want = {port_key(tuple(k.split("/")), 1) for k, v in cast.items()
            if v.dtype == jnp.bfloat16}
    model, disc = port_models(pcfg)
    step = TrainStep(pcfg, model, disc, steps_per_epoch=10)
    names = dict(model.named_parameters())
    assert {port_key(tuple(k.split("/")), 1) for k in cast} == set(names)
    got = {n for n, p in names.items() if step.cast(n, p).dtype == torch.bfloat16}
    assert got == want
    assert want, "the option casts nothing"
    assert model.bf16_stages == jcfg.train.effective_bf16_stages()


class _Probe:
    """A stand-in for JAX's discriminator that records the dtypes of what
    ``apply`` receives: (y, y_hat, parameter dtypes)."""

    def __init__(self, inner):
        self.inner, self.seen = inner, []

    def apply(self, variables, y, y_hat):
        self.seen.append((y.dtype, y_hat.dtype,
                          {a.dtype for a in jax.tree_util.tree_leaves(variables)}))
        return self.inner.apply(variables, y, y_hat)


class _Generator:
    """A stand-in for JAX's generator with the training forward's outputs
    (zeros that depend on its one parameter), so tracing the step reaches
    the discriminators without tracing the Synthesizer."""

    PARAMS = {"enc_p": {"w": jax.ShapeDtypeStruct((1,), jnp.float32)},
              "dec": {"conv_post": {"w": jax.ShapeDtypeStruct((1,), jnp.float32)}}}

    def apply(self, variables, phonemes, phoneme_lengths, f0, energy, duration, spec,
              spec_lengths, sid, deterministic=False, rngs=None):
        w = sum(a.astype(jnp.float32).sum() for a in jax.tree_util.tree_leaves(variables)) * 0
        b, t = spec.shape[:2]
        z = jnp.zeros((b, t, 8)) + w
        mask = jnp.ones((b, t, 1))
        return (jnp.zeros((b, 64, 1)) + w, w, w, w, jnp.zeros((b,), jnp.int32),
                jnp.ones((b, phonemes.shape[1], 1)), mask, (z,) * 6, f0, energy, energy)


def jax_state(jcfg):
    """An abstract TrainState for ``_Generator`` and JAX's scale
    discriminator with period 2 (as ``port_models``)."""
    key = jax.random.PRNGKey(0)
    wav = jnp.zeros((B, 64, 1))
    params_d = jax.eval_shape(lambda: JaxMPD(periods=(2,)).init(key, wav, wav))
    tx = make_optimizer(jcfg, 10)
    return TrainState(step=jnp.zeros((), jnp.int32), params_g={"params": _Generator.PARAMS},
                      params_d=params_d, opt_state_g=jax.eval_shape(tx.init, _Generator.PARAMS),
                      opt_state_d=jax.eval_shape(tx.init, params_d["params"]), rng=key)


@pytest.mark.parametrize("option", ["tail_f32", "bf16_disc", "stable", "full",
                                    "full_bf16_only"])
def test_discriminator_dtype_matches_jax(option):
    """JAX's ``d_dtype`` is local to ``make_train_step``: read it from what
    the step hands the discriminators while ``jax.eval_shape`` traces it."""
    jcfg, pcfg = configs(option)
    probe = _Probe(JaxMPD(periods=(2,)))
    step = make_train_step(jcfg, _Generator(), probe, 10)
    jax.eval_shape(step, jax_state(jcfg), jax_batch())
    assert len(probe.seen) == 2   # the D update and the generator's loss
    (y, y_hat, params), = set((a, b, frozenset(c)) for a, b, c in probe.seen)
    assert y == y_hat and params == {y}
    ours = TrainStep(pcfg, *port_models(pcfg), steps_per_epoch=10)
    assert ours.d_dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                            jnp.dtype(jnp.float32): torch.float32}[y]


@pytest.mark.parametrize("scope,allow,words", [
    ("everythin", False, "unknown bf16_scope"),
    ("stable", False, "KNOWN to collapse"),
    ("full", False, "KNOWN to collapse"),
])
def test_refusals_use_jax_words(scope, allow, words):
    raw = json.loads(json.dumps(TINY))
    raw["train"].update(fp16_run=True, bf16_scope=scope, bf16_allow_divergent=allow)
    with pytest.raises(ValueError, match=words) as jax_err:
        jax_config_from_dict(raw).train.effective_bf16_stages()
    pcfg = config_from_dict(raw)
    with pytest.raises(ValueError) as ours:
        TrainStep(pcfg, *port_models(pcfg), steps_per_epoch=10)
    assert str(ours.value) == str(jax_err.value)


@pytest.mark.parametrize("option,dtype", [("stable", torch.float32),
                                          ("full", torch.bfloat16),
                                          ("tail_f32", torch.bfloat16)])
def test_decoder_computes_in_the_promoted_dtype(option, dtype):
    """flax computes an op in the promotion of its input's and parameters'
    dtypes; the port's layers cast their weights to the input's dtype, so
    the decoder's boundary must promote its inputs."""
    _, pcfg = configs(option)
    model, disc = port_models(pcfg)
    step = TrainStep(pcfg, model, disc, steps_per_epoch=10)
    seen = []
    original = model.dec.conv_pre.forward_cf
    model.dec.conv_pre.forward_cf = lambda x: seen.append(x.dtype) or original(x)
    batch = port_batch()
    d = pcfg.data
    spec = spectrogram(batch["wav"][..., 0].float() / d.max_wav_value, d.filter_length,
                       d.hop_length, d.win_length)
    y_hat = step.generator_forward(batch, spec)[0]   # with autograd, as in training
    assert seen == [dtype] and y_hat.dtype == torch.float32


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_each_option_takes_a_finite_step(option):
    """One step: finite losses and norms, the generator moved, master
    weights f32, and the discriminators fed parameters and both inputs in
    ``d_dtype`` (read inside the step)."""
    _, pcfg = configs(option)
    model, disc = port_models(pcfg)
    step = TrainStep(pcfg, model, disc, steps_per_epoch=10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []
    handle = disc.discriminators[1].convs[0].register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].dtype, mod.weight_v.dtype)))
    try:
        metrics = step(port_batch())
    finally:
        handle.remove()
    bad = {k: float(v) for k, v in metrics.items() if not torch.isfinite(v)}
    assert not bad, bad
    assert seen == [(step.d_dtype, step.d_dtype)] * 2
    for net in (model, disc):
        assert all(p.dtype == torch.float32 for p in net.parameters())
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_tail_f32_is_the_default_scope():
    jcfg, pcfg = configs("tail_f32")
    assert pcfg.train.bf16_scope == "tail_f32"
    assert pcfg.train.effective_bf16_stages() == jcfg.train.effective_bf16_stages()
    f32 = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, fp16_run=False))
    step = TrainStep(f32, *port_models(f32), steps_per_epoch=10)
    assert step.cast is None and step.d_dtype == torch.float32
