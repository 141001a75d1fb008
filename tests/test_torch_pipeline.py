"""The two-stage pipeline (``vispeech_tpu_torch/parallel/pipeline.py``) on
the CPU against the JAX package's (``vispeech_tpu/parallel/pipeline.py``)
on the virtual 8-device CPU mesh.

``tests/test_pipeline.py``'s ``TINY`` model, its flax parameters drawn with
numpy (the whole tree: the port's Synthesizer holds the posterior encoder
too) and carried into the port.  One spawned job of 4 gloo ranks
(``torch_cp_jobs.job_pipeline``, one thread each): the stage pairs {0, 1}
at M = 2 microbatches and {2, 3} at M = 4, each rank's audio against JAX's
``make_synthesizer_pipeline`` at the same M and JAX's ``Synthesizer.infer``
with the same injected ``eps`` at atol 2e-5 (the JAX test's bound), and
against the port's one-process ``infer`` microbatch by microbatch, bit for
bit; a group of 4 and a group of one refused (``ValueError`` naming the
'stage' group), B % M ≠ 0 and a missing ``eps`` refused.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.sharding import Mesh

from test_torch_ddp import Job
from torch_cp_jobs import PIPE, TINY, job_pipeline, pipeline_inputs, synthesizer
from vispeech_tpu.config import config_from_dict as jax_config_from_dict
from vispeech_tpu.models import Synthesizer as JaxSynthesizer
from vispeech_tpu.parallel import pipeline as jax_pipeline
from vispeech_tpu_torch.parallel.pipeline import make_synthesizer_pipeline

ATOL = 2e-5   # tests/test_pipeline.py
T = PIPE["T"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(jm, jcfg):
    """The whole generator tree drawn with numpy: weights N(0, 0.2²) (the
    decoder's 0.05²), weight-norm gains |N| + 0.5, norm scales 1 + N(0,
    0.1²), the duration head's bias 1 so that a phoneme lasts ~2 frames."""
    B, N = 1, PIPE["N"]
    i32 = jnp.int32
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.ones((B, N), i32), jnp.asarray([N]), jnp.full((B, N), 150.0),
        jnp.full((B, N), 60.0), jnp.full((B, N), 2, i32),
        jnp.zeros((B, T, jcfg.data.spec_channels)), jnp.asarray([T]), jnp.zeros((B,), i32),
        deterministic=True))["params"]
    r = np.random.RandomState(0)
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape)
        if name.endswith("/g"):
            a = np.abs(a) + 0.5
        elif name.endswith("gamma"):
            a = 1.0 + 0.1 * a
        else:
            a = a * (0.05 if name.startswith("dec/") else 0.2)
        flat[name] = a.astype(np.float32)
    flat["duration_predictor/proj/kernel"] *= 0.2
    flat["duration_predictor/proj/bias"][:] = 1.0
    return flat


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The spawned job, started first so that the JAX references run beside
    it."""
    jcfg = jax_config_from_dict(TINY)
    jm = JaxSynthesizer.from_config(jcfg, PIPE["n_vocab"])
    flat = _params(jm, jcfg)
    tmp = tmp_path_factory.mktemp("pipe")
    params = tmp / "synthesizer.npz"
    np.savez(params, **flat)
    out = tmp / "out"
    out.mkdir()
    job = Job(tmp, 4, job_pipeline, str(out), str(params))
    try:
        yield {"out": out, "flat": flat, "jm": jm, "job": job}
    finally:
        job.kill()
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def refs(setup):
    """JAX's pipeline at M = 2 and 4 and JAX's ``infer``, same ``eps``."""
    jm = setup["jm"]
    variables = {"params": unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in setup["flat"].items()})}
    ph, lens, sid, eps = (jnp.asarray(a) for a in pipeline_inputs())
    ph, lens, sid = ph.astype(jnp.int32), lens.astype(jnp.int32), sid.astype(jnp.int32)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("stage",))
    out = {}
    for M in (2, 4):
        pipe = jax.jit(jax_pipeline.make_synthesizer_pipeline(
            jm, mesh, t_frames=T, microbatches=M, noise_scale=0.667))
        out[M] = np.asarray(pipe(variables, ph, lens, sid, eps))
    audio, *_ = jax.jit(lambda v: jm.apply(v, ph, lens, T, sid=sid, noise_scale=0.667,
                                           eps=eps, method=JaxSynthesizer.infer))(variables)
    out["infer"] = np.asarray(audio)
    return out


@pytest.fixture(scope="module")
def ranks(setup, refs):
    setup["job"].join()
    return [torch.load(setup["out"] / f"pipeline_rank{r}.pt", weights_only=False)
            for r in range(4)]


def test_jax_pipeline_is_jax_infer(refs):
    """The references agree with each other, and the audio is not silence."""
    for M in (2, 4):
        np.testing.assert_allclose(refs[M], refs["infer"], atol=ATOL)
    assert np.abs(refs["infer"]).max() > 1e-2


@pytest.mark.parametrize("rank", range(4))
def test_matches_jax(ranks, refs, rank):
    """Each rank's whole batch: the pair {0, 1} at M = 2, {2, 3} at M = 4."""
    got = ranks[rank]
    audio = got["audio"].numpy()
    assert audio.shape == refs["infer"].shape == (PIPE["B"], T * 64, 1)
    np.testing.assert_allclose(audio, refs[got["M"]], atol=ATOL)
    np.testing.assert_allclose(audio, refs["infer"], atol=ATOL)


def test_stages_return_the_same_bits(ranks):
    """The last stage broadcasts: both ranks of a pair hold the same audio."""
    for a, b in ((0, 1), (2, 3)):
        assert torch.equal(ranks[a]["audio"], ranks[b]["audio"])


@pytest.mark.parametrize("M", [2, 4])
def test_equals_one_process_per_microbatch(setup, ranks, M):
    """The pipeline is ``Synthesizer.infer`` on each microbatch with its
    slice of ``eps``: the same bits (one thread on both sides)."""
    model = synthesizer(setup["flat"])
    ph, lens, sid, eps = (torch.from_numpy(a) for a in pipeline_inputs())
    n = PIPE["B"] // M
    want = torch.cat([model.infer(ph[i:i + n], lens[i:i + n], T, sid=sid[i:i + n],
                                  noise_scale=0.667, eps=eps[i:i + n])[0]
                      for i in range(0, PIPE["B"], n)])
    got = ranks[0 if M == 2 else 2]["audio"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("rank", range(4))
def test_refusals_on_every_rank(ranks, rank):
    got = ranks[rank]
    assert got["world"] is not None and "'stage' group, got 4" in got["world"]
    assert got["B % M"] is not None and "microbatches=3" in got["B % M"]
    assert got["no eps"] is not None and "eps" in got["no eps"]


def test_refuses_a_group_of_one(setup):
    model = synthesizer(setup["flat"])
    with pytest.raises(ValueError, match="stage"):
        make_synthesizer_pipeline(model, None, T, 2)
