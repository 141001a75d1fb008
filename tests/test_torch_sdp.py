"""The stochastic duration predictor and what it is built of, against the
JAX package at small widths (C ≤ 16, T ≤ 32): the rational-quadratic
spline, ``DDSConv``, ``Log``, ``ElementwiseAffine``, ``ConvFlow``, the SDP
in both directions, its wiring into ``Synthesizer.infer_prior`` / ``infer``,
the weight bridge's three accepted ``sdp`` subtrees, and what stays off the
SDP (the engine, the pipeline, the training step).

Every flax leaf is drawn from numpy, nonzero (the JAX package starts
``ConvFlow.proj`` and ``ElementwiseAffine`` at zero, which would make each
spline the identity), and the tests check that the splines move their
inputs.  The JAX and torch random streams differ, so the SDP's noise is
given to JAX by wrapping ``jax.random.normal`` during ``apply`` and to the
port by injection; ``noise_scale=0`` is a second check.

Tolerances: the spline's outputs to 1e-5 and its log-dets to 1e-5 absolute
plus 1e-5 relative (f32 summation and transcendental order on values of
order 1-5; the log of a slope of 1e-3 carries its relative rounding), at
the knots to 5e-4 (neighbouring bins may be picked, and the log-det's
error there is the output's rounding over a bin as narrow as 0.01); the flows and DDSConv to
1e-5; the SDP's logw to 1e-4 and its NLL to 1e-4 relative (three inverse
splines and nine DDSConv layers; the NLL sums ~100 terms of order 1-10);
the synthesizer at ``tests/test_torch_synthesizer.py``'s tolerances.
Durations come from a ``ceil``: they are compared only after checking that
every w lies more than 1e-3 from an integer.
"""

import json
from functools import partial

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch import nn

from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.models.predictors import StochasticDurationPredictor as JaxSDP
from vispeech_tpu.ops import spline as jax_spline
from vispeech_tpu.ops.ddsconv import DDSConv as JaxDDSConv
from vispeech_tpu.ops.flows import ConvFlow as JaxConvFlow
from vispeech_tpu.ops.flows import ElementwiseAffine as JaxAffine
from vispeech_tpu.ops.flows import Log as JaxLog
from vispeech_tpu.ops.policy import FLOAT32_XLA
from vispeech_tpu.text.symbols import N_SYMBOLS as JAX_N_SYMBOLS
from vispeech_tpu_torch.config import config_from_dict
from vispeech_tpu_torch.infer.pipeline import TTSEngine
from vispeech_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from vispeech_tpu_torch.models.predictors import StochasticDurationPredictor
from vispeech_tpu_torch.models.synthesizer import Synthesizer, random_init_
from vispeech_tpu_torch.ops import spline
from vispeech_tpu_torch.ops.ddsconv import DDSConv
from vispeech_tpu_torch.ops.flows import ConvFlow, ElementwiseAffine, Log
from vispeech_tpu_torch.parallel.pipeline import make_synthesizer_pipeline
from vispeech_tpu_torch.text import N_SYMBOLS
from vispeech_tpu_torch.train.step import TrainStep
from vispeech_tpu_torch.utils.jax_weights import flax_to_state_dict, load_flax_params

ATOL = 1e-5
KNOT_LD_ATOL = 5e-4
SDP_ATOL = 1e-4
F0_RTOL, F0_ATOL, ENERGY_ATOL, AUDIO_ATOL = 1e-4, 5e-3, 4e-4, 1e-4
TAIL = 5.0
HOP = 4
CFG = {   # tests/test_torch_synthesizer.py's with the SDP and a narrower decoder
    "train": {"segment_size": 4 * HOP, "fp16_run": False, "batch_size": 2},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": HOP,
             "win_length": 16, "n_speakers": 4, "spk2id": {"alice": 1, "bob": 2}},
    "model": {"inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
              "n_heads": 2, "n_layers": 1, "upsample_rates": [2, 2],
              "upsample_initial_channel": 32, "upsample_kernel_sizes": [4, 4],
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "gin_channels": 8, "use_sdp": True},
}
# the JAX SDP's subtree after an init through infer_prior (sampling only)
REVERSE_ONLY = {"cond", "convs", "flows_conv_1", "flows_conv_2", "flows_conv_3", "pre",
                "pre_affine", "proj"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def draw(shapes, seed, scale=0.3):
    """Every leaf of a flax shape tree drawn from numpy: norm gains
    1 + N(0, 0.1²), the rest N(0, scale²) → (flat tree, variables)."""
    r = np.random.RandomState(seed)
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape)
        a = 1.0 + 0.1 * a if name.endswith("gamma") else a * scale
        flat[name] = a.astype(np.float32)
    return flat, variables(flat)


def variables(flat):
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


def masked(B=2, T=24, C=2, lengths=(24, 17), seed=1, scale=1.0):
    r = np.random.RandomState(seed)
    x = (r.randn(B, T, C) * scale).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    return x, mask


def holder(module):
    """A module whose ``sdp`` is ``module``: the bridge's SDP paths start
    at ``sdp/``."""
    h = nn.Module()
    h.sdp = module
    return h


@pytest.fixture
def jax_noise(monkeypatch):
    """Make ``jax.random.normal`` return the given numpy arrays, in order,
    for draws of the next array's shape (flax's parameter shape checks
    draw too: those pass through) → the list of shapes served."""
    seen = []
    original = jax.random.normal

    def install(*arrays):
        queue = list(arrays)

        def normal(key, shape=(), dtype=jnp.float32):
            if not queue or tuple(shape) != queue[0].shape:
                return original(key, shape, dtype)
            seen.append(tuple(shape))
            return jnp.asarray(queue.pop(0), dtype)

        monkeypatch.setattr(jax.random, "normal", normal)
        return seen
    return install


# ------------------------------------------------------------------ spline

def spline_params(shape=(2, 20), K=10, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(*shape, K).astype(np.float32) * 1.5,
            r.randn(*shape, K).astype(np.float32) * 1.5,
            r.randn(*shape, K - 1).astype(np.float32))


def spline_inputs(uw, uh, inverse):
    """Random points, every knot of the first row (from the knots the JAX
    function builds), exactly ±tail_bound, and points outside the tails."""
    r = np.random.RandomState(3)
    x = r.uniform(-TAIL, TAIL, uw.shape[:-1]).astype(np.float32)
    cum = np.cumsum(jax.nn.softmax(uh if inverse else uw, axis=-1) * (1 - 1e-3 * 10) + 1e-3,
                    axis=-1)
    knots = (2 * TAIL * cum - TAIL)[0, :, :-1]
    x[0, :9] = knots[np.arange(9), np.arange(9)]
    x[1, :6] = [-TAIL, TAIL, -TAIL - 0.5, TAIL + 2.0, -40.0, 7.0]
    return x


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_matches_jax(inverse):
    uw, uh, ud = spline_params()
    x = spline_inputs(uw, uh, inverse)
    y_ref, ld_ref = jax.jit(partial(jax_spline.unconstrained_rational_quadratic_spline,
                                    inverse=inverse, tail_bound=TAIL))(
        jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud))
    y, ld = spline.piecewise_rational_quadratic_transform(
        t(x), t(uw), t(uh), t(ud), inverse=inverse, tails="linear", tail_bound=TAIL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=ATOL)
    # at a knot the two may pick neighbouring bins: the log-det is continuous
    # there, but its f32 error is the output's rounding over the bin's width
    knot = np.zeros(x.shape, bool)
    knot[0, :9] = True
    np.testing.assert_allclose(ld.numpy()[~knot], np.asarray(ld_ref)[~knot], rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(ld.numpy()[knot], np.asarray(ld_ref)[knot], rtol=0,
                               atol=KNOT_LD_ATOL)
    # outside the tails: the identity with log-det 0; at ±tail_bound: inside
    out = np.abs(x) > TAIL
    np.testing.assert_array_equal(y.numpy()[out], x[out])
    assert np.all(ld.numpy()[out] == 0.0)
    np.testing.assert_allclose(y.numpy()[1, :2], [-TAIL, TAIL], atol=1e-5)
    assert np.all(ld.numpy()[1, :2] != 0.0)
    inside = ~out
    assert np.abs(y.numpy()[inside] - x[inside]).max() > 0.5   # the spline moves x


def test_spline_round_trip_and_unit_interval():
    uw, uh, ud = spline_params(seed=4)
    x = spline_inputs(uw, uh, False)
    kw = dict(tails="linear", tail_bound=TAIL)
    y, ld = spline.piecewise_rational_quadratic_transform(t(x), t(uw), t(uh), t(ud), **kw)
    x2, ld_inv = spline.piecewise_rational_quadratic_transform(y, t(uw), t(uh), t(ud),
                                                               inverse=True, **kw)
    # the round trip carries each direction's rounding over a bin's width
    np.testing.assert_allclose(x2.numpy(), x, rtol=0, atol=1e-4)
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=KNOT_LD_ATOL)
    # no tails: the spline on [0, 1] with all K + 1 derivatives given
    u = np.random.RandomState(5).uniform(0, 1, x.shape).astype(np.float32)
    ud1 = np.random.RandomState(6).randn(*uw.shape[:-1], 11).astype(np.float32)
    ref = jax.jit(jax_spline.piecewise_rational_quadratic_transform)(
        jnp.asarray(u), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud1))
    ours = spline.piecewise_rational_quadratic_transform(t(u), t(uw), t(uh), t(ud1))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=ATOL, atol=ATOL)
    with pytest.raises(ValueError, match="unsupported tails"):
        spline.piecewise_rational_quadratic_transform(t(u), t(uw), t(uh), t(ud1),
                                                      tails="quadratic")


# ------------------------------------------------------------------ flows

def test_ddsconv_matches_jax():
    x, mask = masked(C=16)
    g = np.random.RandomState(2).randn(2, 24, 16).astype(np.float32)
    jm = JaxDDSConv(16, 3, 3)
    flat, v = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, mask, g)["params"], 0)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    ours = DDSConv(16, 3, 3)
    sd = flax_to_state_dict({"sdp/convs/" + k: a for k, a in flat.items()})
    ours.load_state_dict({k[len("sdp.convs."):]: v for k, v in sd.items()})
    y = ours.eval()(t(x), t(mask), t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert ours.convs_sep[2].dilation == 9 and ours.convs_sep[2].groups == 16


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["log", "affine", "convflow"])
def test_flows_match_jax(kind, reverse):
    x, mask = masked(C=2, scale=2.0)
    g = np.random.RandomState(2).randn(2, 24, 16).astype(np.float32)
    if kind == "log":
        x = np.abs(x) + (0.0 if reverse else 1e-6)
        jm, ours, flat = JaxLog(), Log(), {}
    elif kind == "affine":
        jm, ours = JaxAffine(2), ElementwiseAffine(2)
        flat = {"m": np.asarray([0.3, -0.4], np.float32),
                "logs": np.asarray([0.2, -0.1], np.float32)}
    else:
        jm, ours = JaxConvFlow(2, 16, 3, n_layers=3), ConvFlow(2, 16, 3, n_layers=3)
        flat, _ = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, mask,
                                      g=g)["params"], 1)
    ref = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g),
                                     reverse=reverse))(variables(flat))
    prefix = {"log": "", "affine": "sdp/pre_affine/", "convflow": "sdp/flows_conv_0/"}[kind]
    if flat:
        sd = flax_to_state_dict({prefix + k: a for k, a in flat.items()})
        ours.load_state_dict({k.split(".", 3)[3]: v for k, v in sd.items()})
    with torch.no_grad():
        out = ours(t(x), t(mask), g=t(g), reverse=reverse)
    if reverse:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
        y = out.numpy()
    else:
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=ATOL)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=ATOL)
        y = out[0].numpy()
    if kind == "convflow":   # the spline moves the second half where valid
        moved = np.abs(y[..., 1] - x[..., 1] * mask[..., 0])
        assert moved.max() > 0.1
        np.testing.assert_array_equal(y[..., 0], x[..., 0] * mask[..., 0])



# ------------------------------------------------------------------ the SDP

N_PH = 12


def sdp_shapes(hidden=16, gin=8):
    """The complete ``sdp`` subtree of a Synthesizer at ``hidden`` (an init
    through the NLL creates every parameter)."""
    x = jnp.zeros((1, N_PH, hidden))
    mask = jnp.ones((1, N_PH, 1))
    k = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: JaxSDP(hidden, 192, 3, 0.5, 4, gin_channels=gin).init(
        {"params": k, "sample": k}, x, mask, w=mask, g=jnp.zeros((1, 1, gin))))["params"]


def sdp_params(seed=0):
    """The SDP's flat tree, prefixed ``sdp/``: drawn as ``draw`` does, its
    affine set so that logw = 1.6 + z/e^1.2 (a phoneme lasts a few frames)."""
    flat, _ = draw(sdp_shapes(), seed, scale=0.3)
    flat = {"sdp/" + k: a for k, a in flat.items()}
    flat["sdp/pre_affine/m"] = np.asarray([-1.6 * np.exp(1.2), 0.2], np.float32)
    flat["sdp/pre_affine/logs"] = np.asarray([1.2, -0.1], np.float32)
    return flat


def sdp_inputs(seed=7):
    r = np.random.RandomState(seed)
    x, mask = masked(C=16, T=N_PH, lengths=(N_PH, 9), seed=seed)
    g = r.randn(2, 1, 8).astype(np.float32)
    w = (r.randint(1, 6, (2, N_PH, 1)) * mask).astype(np.float32)
    return x, mask, g, w


def jax_sdp(flat, *args, **kw):
    """The JAX SDP on numpy ``args``, jitted: → fn(noise_scale) (traced, so
    one program serves every scale; the noise is fixed when it is traced)."""
    sub = variables({k[len("sdp/"):]: a for k, a in flat.items() if k.startswith("sdp/")})
    rngs = {"sample": jax.random.PRNGKey(0)}
    run = jax.jit(lambda v, s: JaxSDP(16, 192, 3, 0.5, 4, gin_channels=8).apply(
        v, *map(jnp.asarray, args), rngs=rngs, noise_scale=s, **kw))
    return lambda noise_scale=1.0: np.asarray(run(sub, noise_scale))


def port_sdp(flat):
    model = StochasticDurationPredictor(16, 192, 3, 0.5, 4, gin_channels=8)
    return load_flax_params(holder(model), flat).sdp.eval()


def test_sdp_reverse_matches_jax(jax_noise):
    """Sampling at noise 0.8 and at 0, the noise given to both; the
    splines move logw (against the same predictor with identity ConvFlows)."""
    flat = sdp_params()
    x, mask, g, _ = sdp_inputs()
    noise = np.random.RandomState(9).randn(2, N_PH, 2).astype(np.float32)
    seen = jax_noise(noise)
    ref = jax_sdp(flat, x, mask, g=g, reverse=True)
    ours = port_sdp(flat)
    for noise_scale in (0.8, 0.0):
        with torch.no_grad():
            logw = ours(t(x), t(mask), g=t(g), reverse=True, noise_scale=noise_scale,
                        noise=t(noise)).numpy()
        assert logw.shape == (2, N_PH, 1)
        np.testing.assert_allclose(logw, ref(noise_scale), rtol=0, atol=SDP_ATOL)
    assert seen == [(2, N_PH, 2)]
    with torch.no_grad():
        moved = ours(t(x), t(mask), g=t(g), reverse=True, noise=t(noise))
        for i in (3, 5, 7):
            ours.flows[i].proj.weight.zero_()
            ours.flows[i].proj.bias.zero_()
        still = ours(t(x), t(mask), g=t(g), reverse=True, noise=t(noise))
    assert (moved - still).abs().max() > 0.05


def test_sdp_nll_matches_jax(jax_noise):
    flat = sdp_params(seed=1)
    x, mask, g, w = sdp_inputs(seed=3)
    e_q = np.random.RandomState(4).randn(2, N_PH, 2).astype(np.float32)
    jax_noise(e_q)
    ref = jax_sdp(flat, x, mask, w=w, g=g)()
    ours = port_sdp(flat)
    with torch.no_grad():
        nll = ours(t(x), t(mask), w=t(w), g=t(g), noise=t(e_q)).numpy()
    assert nll.shape == (2,) and np.all(np.isfinite(nll))
    np.testing.assert_allclose(nll, ref, rtol=SDP_ATOL, atol=SDP_ATOL)
    # noise from the caller's generator, never the global stream
    torch.manual_seed(0)
    state = torch.get_rng_state()
    with torch.no_grad():
        a = ours(t(x), t(mask), w=t(w), g=t(g), generator=torch.Generator().manual_seed(5))
        b = ours(t(x), t(mask), w=t(w), g=t(g), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(torch.get_rng_state(), state)


def test_sdp_detaches_its_inputs():
    ours = port_sdp(sdp_params())
    x, mask, g, w = sdp_inputs()
    xt, gt = t(x).requires_grad_(), t(g).requires_grad_()
    nll = ours.train()(xt, t(mask), w=t(w), g=gt, noise=torch.zeros(2, N_PH, 2))
    nll.sum().backward()
    assert xt.grad is None and gt.grad is None
    assert ours.flows[1].proj.weight.grad is not None


# ------------------------------------------------------------------ the synthesizer

def synth_cfgs(use_sdp=True):
    raw = json.loads(json.dumps(CFG))
    raw["model"]["use_sdp"] = use_sdp
    return jax_config_from_dict(raw), config_from_dict(raw)


@pytest.fixture(scope="module")
def models():
    """The JAX Synthesizer with ``use_sdp`` and its port, every leaf drawn
    from numpy (tests/test_torch_synthesizer.py's recipe), the SDP complete."""
    jcfg, pcfg = synth_cfgs()
    jm = JaxSynthesizer.from_config(jcfg, JAX_N_SYMBOLS, policy=FLOAT32_XLA)
    B, N, T = 1, 8, 16
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.ones((B, N), jnp.int32), jnp.asarray([N]), jnp.full((B, N), 150.0),
        jnp.full((B, N), 60.0), jnp.full((B, N), 2, jnp.int32),
        jnp.zeros((B, T, jcfg.data.spec_channels)), jnp.asarray([T]),
        jnp.zeros((B,), jnp.int32), deterministic=True))["params"]
    assert "sdp" not in shapes   # the training forward never calls the SDP
    r = np.random.RandomState(0)
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape)
        if name.endswith("/g"):
            a = np.abs(a) + 0.5
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * a
        elif name.startswith("dec/"):
            a = a * 0.05
        else:
            a = a * 0.2
        flat[name] = a.astype(np.float32)
    flat["duration_predictor/proj/kernel"] *= 0.2
    flat["duration_predictor/proj/bias"][:] = 1.6
    base = dict(flat)
    flat.update(sdp_params(seed=2))
    pm = load_flax_params(Synthesizer.from_config(pcfg, N_SYMBOLS), flat, 1).eval()
    assert pm.sdp.unloaded == ()
    return {"jcfg": jcfg, "jm": jm, "flat": flat, "base": base, "pcfg": pcfg, "pm": pm}


def _batch(seed=0):
    r = np.random.RandomState(seed)
    ph = r.randint(1, N_SYMBOLS, (2, N_PH))
    lens = np.array([N_PH, 9])
    ph[1, 9:] = 0
    return ph, lens, np.array([1, 3])


def _away_from_integers(values, margin=1e-3):
    v = np.asarray(values, np.float64)
    return np.all(np.abs(v - np.round(v)) > margin)


def test_infer_with_sdp_matches_jax(models, jax_noise):
    """``infer`` and ``infer_prior`` with a scalar duration control sample
    the durations from the SDP, its noise drawn before the prior's; at
    noise 0.667 and at 0 (one JAX program for both: the noise scale is
    traced, and the SDP's noise is fixed when it is traced)."""
    ph, lens, sid = _batch()
    T = 64
    eps_w = np.random.RandomState(1).randn(2, N_PH, 2).astype(np.float32)
    eps = np.random.RandomState(2).randn(2, T, 16).astype(np.float32)
    seen = jax_noise(eps_w, eps_w)

    def jax_run(v, noise_scale):
        def logw_fn(m):
            x, x_mask = m.enc_p(jnp.asarray(ph), jnp.asarray(lens))
            return m.sdp(x, x_mask, g=m._speaker(jnp.asarray(sid)), reverse=True,
                         noise_scale=noise_scale)
        rngs = {"sample": jax.random.PRNGKey(0)}
        logw = models["jm"].apply(v, method=logw_fn, rngs=rngs)
        out = models["jm"].apply(v, jnp.asarray(ph), jnp.asarray(lens), T,
                                 sid=jnp.asarray(sid), noise_scale=noise_scale,
                                 duration_control=1.2, eps=jnp.asarray(eps),
                                 method=JaxSynthesizer.infer, rngs=rngs)
        return logw, out

    jax_run = jax.jit(jax_run)
    pm = models["pm"]
    for noise_scale in (0.667, 0.0):
        logw, ref = jax_run(variables(models["flat"]), noise_scale)
        logw = np.asarray(logw)
        with torch.no_grad():
            x, x_mask = pm.enc_p(t(ph), t(lens))
            ours_logw = pm.sdp(x, x_mask, g=pm._speaker(t(sid)), reverse=True,
                               noise_scale=noise_scale, noise=t(eps_w)).numpy()
        np.testing.assert_allclose(ours_logw, logw, rtol=0, atol=SDP_ATOL)
        w = (np.exp(logw[..., 0]) - 1.0) * 1.2
        valid = lens[:, None] > np.arange(N_PH)
        assert _away_from_integers(w[valid])
        assert 1 <= np.ceil(w[valid]).min() and np.ceil(w[valid]).max() < 16

        kw = dict(sid=t(sid), noise_scale=noise_scale, duration_control=1.2, eps=t(eps),
                  eps_w=t(eps_w))
        audio, mask, (z, z_p, m_p, logs_p), dur, f0, energy = pm.infer(t(ph), t(lens), T,
                                                                        **kw)
        prior = pm.infer_prior(t(ph), t(lens), T, **kw)
        np.testing.assert_array_equal(dur.numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(prior[2].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[1]))
        for ours in (z_p, prior[0]):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref[2][1]), rtol=ATOL,
                                       atol=ATOL)
        np.testing.assert_allclose(f0.numpy(), np.asarray(ref[4]), rtol=F0_RTOL, atol=F0_ATOL)
        np.testing.assert_allclose(energy.numpy(), np.asarray(ref[5]), rtol=0,
                                   atol=ENERGY_ATOL)
        assert np.abs(np.asarray(ref[0])).max() > 0.05
        np.testing.assert_allclose(audio.numpy(), np.asarray(ref[0]), rtol=0, atol=AUDIO_ATOL)
    assert seen == [(2, N_PH, 2)] * 2
    # the SDP's noise comes first from the generator: the same seed, the same bits
    gen = dict(sid=t(sid), noise_scale=0.667, duration_control=1.2)
    a = pm.infer_prior(t(ph), t(lens), T, generator=torch.Generator().manual_seed(3), **gen)
    b = pm.infer_prior(t(ph), t(lens), T, generator=torch.Generator().manual_seed(3), **gen)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


# ------------------------------------------------------------------ the bridge

def test_bridge_absent_sdp(models):
    """A JAX-trained tree holds no SDP: it loads, the SDP stays unloaded,
    and a scalar duration control raises where JAX raises flax's error."""
    ph, lens, sid = _batch()
    pm = load_flax_params(Synthesizer.from_config(models["pcfg"], N_SYMBOLS), models["base"], 1)
    assert set(pm.sdp.unloaded) == {n for n, _ in pm.sdp.named_parameters()}
    assert all(torch.count_nonzero(p) == 0 for p in pm.sdp.parameters())
    with pytest.raises(ValueError,
                       match=r"sampling needs parameters that were not loaded: \['sdp\.cond\."):
        pm.infer_prior(t(ph), t(lens), 64, sid=t(sid), duration_control=1.0)
    with pytest.raises(flax.errors.ScopeParamNotFoundError, match="sdp/"):
        jax.eval_shape(lambda v: models["jm"].apply(
            v, jnp.asarray(ph), jnp.asarray(lens), 64, sid=jnp.asarray(sid),
            method=JaxSynthesizer.infer_prior, rngs={"sample": jax.random.PRNGKey(0)}),
            variables(models["base"]))
    dur = np.full((2, N_PH), 3.0, np.float32)
    out = pm.infer(t(ph), t(lens), 64, sid=t(sid), duration_control=t(dur), noise_scale=0.0)
    assert torch.isfinite(out[0]).all()


def test_bridge_reverse_only_sdp(models):
    """An init through ``infer_prior`` leaves only what sampling reads: it
    loads and samples as the complete tree does; the NLL raises."""
    jm = models["jm"]
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": k, "sample": k}, jnp.ones((1, 8), jnp.int32), jnp.asarray([8]), 16,
        sid=jnp.zeros((1,), jnp.int32), method=JaxSynthesizer.infer_prior))["params"]
    assert set(shapes["sdp"]) == REVERSE_ONLY
    keep = {"sdp/" + k for k in flatten_dict(shapes["sdp"], sep="/")}
    flat = {k: v for k, v in models["flat"].items() if not k.startswith("sdp/") or k in keep}
    pm = load_flax_params(Synthesizer.from_config(models["pcfg"], N_SYMBOLS), flat, 1).eval()
    assert pm.sdp.unloaded and all(n.startswith(("post_", "flows.1.")) for n in pm.sdp.unloaded)
    ph, lens, sid = _batch(seed=1)
    kw = dict(sid=t(sid), duration_control=1.0, noise_scale=0.5,
              eps_w=t(np.random.RandomState(0).randn(2, N_PH, 2).astype(np.float32)),
              eps=torch.zeros(2, 64, 16))
    for a, b in zip(pm.infer_prior(t(ph), t(lens), 64, **kw),
                    models["pm"].infer_prior(t(ph), t(lens), 64, **kw)):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    x, mask, g, w = sdp_inputs()
    with pytest.raises(ValueError, match=r"NLL needs parameters that were not loaded"):
        pm.sdp(t(x), t(mask), w=t(w), g=t(g))


def test_bridge_refuses_any_other_gap(models):
    pm = Synthesizer.from_config(models["pcfg"], N_SYMBOLS)
    for drop in ("sdp/proj/bias", "sdp/post_flows_conv_2/proj/kernel",
                 "sdp/flows_conv_0/convs/norm1_1/gamma"):
        flat = {k: v for k, v in models["flat"].items() if k != drop}
        with pytest.raises(ValueError, match="unfilled port keys"):
            load_flax_params(pm, flat, 1)
    # no SDP in the model: an sdp subtree is left over
    with pytest.raises(ValueError, match="unmapped flax leaves"):
        load_flax_params(Synthesizer.from_config(synth_cfgs(False)[1], N_SYMBOLS),
                         models["flat"], 1)


# ------------------------------------------------------------------ off the SDP

def test_engine_audio_is_the_same_with_and_without_sdp(models, tmp_path):
    """The engine takes durations from the deterministic head and hands
    them over as an array, as the JAX engine does: ``use_sdp`` changes
    nothing it returns, also from a JAX trainer's npz with no SDP."""
    no_sdp = {k: v for k, v in models["pm"].state_dict().items() if not k.startswith("sdp.")}
    with_sdp = TTSEngine(models["pcfg"], models["pm"].state_dict(), device="cpu")
    without = TTSEngine(synth_cfgs(False)[1], no_sdp, device="cpu")
    np.savez(tmp_path / "ckpt_1.npz", step=np.asarray(1),
             **{f"params_g/params/{k}": v for k, v in models["base"].items()})
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    from_npz = TTSEngine.from_checkpoint(str(tmp_path / "config.json"), str(tmp_path),
                                         device="cpu")
    for kw in (dict(text="[P]ni2 hao3 shi4 jie4[P]", speaker="alice", seed=3),
               dict(text="[P]zai4 jian4[P]", noise_scale=0.5, duration_control=1.3, seed=1)):
        a, b, c = (e.synthesize(**kw) for e in (with_sdp, without, from_npz))
        np.testing.assert_array_equal(a["audio"], b["audio"])
        np.testing.assert_array_equal(a["duration"], b["duration"])
        np.testing.assert_array_equal(c["audio"], b["audio"])
    # the npz's tree has no SDP: its engine's model refuses to sample one
    sdp = from_npz.model.sdp
    assert set(sdp.unloaded) == {n for n, _ in sdp.named_parameters()}
    ph, lens, sid = _batch()
    with pytest.raises(ValueError, match="not loaded"):
        from_npz.model.infer(t(ph), t(lens), 64, sid=t(sid), duration_control=1.0)
    batch = [r["audio"] for r in with_sdp.synthesize_batch(["[P]ni2 hao3[P]", "[P]zai4[P]"])]
    for x, y in zip(batch, without.synthesize_batch(["[P]ni2 hao3[P]", "[P]zai4[P]"])):
        np.testing.assert_array_equal(x, y["audio"])


def test_pipeline_refuses_a_model_with_sdp(models):
    with pytest.raises(ValueError, match="stochastic duration predictor"):
        make_synthesizer_pipeline(models["pm"], None, 64, 1)


TRAIN = {   # tests/test_torch_bf16_options.py's, with the SDP
    "train": {"segment_size": 64, "batch_size": 2, "fp16_run": False},
    "data": {"sampling_rate": 8000, "filter_length": 16, "hop_length": 8, "win_length": 16,
             "n_mel_channels": 8, "n_speakers": 4},
    "model": {"inter_channels": 8, "hidden_channels": 8, "filter_channels": 16, "n_heads": 2,
              "n_layers": 1, "kernel_size": 3, "p_dropout": 0.1, "resblock": "1",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [4, 2], "upsample_initial_channel": 16,
              "upsample_kernel_sizes": [8, 4], "gin_channels": 6, "use_sdp": True},
}


def test_train_step_leaves_the_sdp_unchanged():
    """The training step never calls the SDP (the JAX step's tree has
    none): its parameters get no gradient and stay bit-equal, while the
    rest of the generator moves."""
    cfg = config_from_dict(TRAIN)
    model = random_init_(Synthesizer.from_config(cfg, 40), 0)
    step = TrainStep(cfg, model, random_init_(MultiPeriodDiscriminator(periods=(2,)), 1),
                     steps_per_epoch=10)
    r = np.random.RandomState(0)
    B, N, T, hop = 2, 6, 16, 8
    dur = r.randint(1, 4, size=(B, N))
    batch = {"phonemes": t(r.randint(1, 40, (B, N))), "phoneme_lengths": t(np.array([N, N - 2])),
             "f0": t(r.uniform(80, 400, (B, N)).astype(np.float32)),
             "energy": t(r.uniform(30, 90, (B, N)).astype(np.float32)),
             "duration": t(dur), "spec": None, "spec_lengths": t(dur.sum(1)),
             "wav": t((np.clip(r.randn(B, T * hop, 1) * 0.2, -1, 1) * 32767).astype(np.int16)),
             "wav_lengths": t(dur.sum(1) * hop), "sid": t(np.array([0, 2]))}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step(batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    for name, p in model.named_parameters():
        if name.startswith("sdp."):
            assert p.grad is None and torch.equal(p, before[name]), name
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters()
               if not n.startswith("sdp."))
