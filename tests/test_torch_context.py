"""Context parallelism (``vispeech_tpu_torch/parallel/context.py``) on the
CPU against the JAX package's (``vispeech_tpu/parallel/context.py``) on the
virtual 8-device CPU mesh.

One spawned job of 4 gloo ranks (``torch_cp_jobs.job_context``, one
thread each) runs every configuration; every rank returns the whole array,
and each rank's is checked:

- ring attention at ``tests/test_context_parallel.py``'s sizes (B 2, H 2,
  T 256, d 32, w 4, lengths [T, T − 50]) over the world (P = 4), over the
  two context groups {0, 1} and {2, 3} (P = 2) and at data 2 × context 2
  (``batch_group``), against JAX's ``make_ring_attention`` on a mesh of the
  same shape and against the dense ``xla_reference``, on valid rows at
  rtol 2e-4 / atol 2e-5 (the JAX test's bounds); P = 1 without a launcher
  against kernel A's plain version;
- the overlap-save vocoder on the JAX test's generator (hop 64, upsample
  4·4·2·2, 64 channels, gin 16), its flax parameters carried into the
  port's ``Generator``: the JAX test's (``init`` at key 0) and a set drawn
  with numpy whose audio depends on z (with the JAX test's a wrong halo
  moves the audio by less than the bound).  P = 4 and data 2 × context 2
  against JAX's ``make_generator_context_parallel`` at 1e-4 everywhere,
  edges included (both zero the wrapped halos), and against the port's
  whole generator on ``[edge:-edge]``, the JAX test's edge and count for
  its parameters, half the halo for the drawn ones;
- ``p2p.shift`` (offsets 1, −1, 2, P; a batch of tensors) and every guard
  (T % P, T/P < halo, B % the data group, a tensor that requires grad);
- a second job of 2 ranks whose generator raises on rank 1: both ranks
  exit 1 by themselves (rank 0 does not hang until the join kills it).
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
from tests.test_pallas_kernels import xla_reference
from torch_cp_jobs import (
    GEN,
    GENERATOR_PARAMS,
    HALO,
    HOP,
    RING,
    generator,
    job_context,
    job_rank_raises,
    ring_inputs,
    vocoder_inputs,
)
from vispeech_tpu.models.generator import Generator as JaxGenerator
from vispeech_tpu.parallel import context as jax_context
from vispeech_tpu_torch.ops.kernels.rel_attention import relative_self_attention_plain
from vispeech_tpu_torch.parallel.context import (
    make_generator_context_parallel,
    make_ring_attention,
)

RTOL, ATOL = 2e-4, 2e-5       # tests/test_context_parallel.py:50-53
VOC_TOL = 1e-4
EDGE = 16                     # tests/test_context_parallel.py:101-109


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_generator():
    return JaxGenerator(
        resblock=GEN["resblock"], resblock_kernel_sizes=GEN["resblock_kernel_sizes"],
        resblock_dilation_sizes=GEN["resblock_dilation_sizes"],
        upsample_rates=GEN["upsample_rates"],
        upsample_initial_channel=GEN["upsample_initial_channel"],
        upsample_kernel_sizes=GEN["upsample_kernel_sizes"], gin_channels=GEN["gin_channels"])


def _generator_params(which):
    """The generator's parameters as a flat numpy tree: "init", the JAX
    test's (``gen.init`` at key 0); "drawn", N(0, 0.1²) kernels and biases
    and weight-norm gains 0.7·(|N| + 0.5)."""
    z, g = vocoder_inputs()
    init = jax.jit(_jax_generator().init)
    if which == "init":
        params = init(jax.random.PRNGKey(0), z[:1], g[:1])["params"]
        return {k: np.array(v) for k, v in flatten_dict(params, sep="/").items()}
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), z[:1], g[:1])["params"]
    r = np.random.RandomState(2)
    flat = {}
    for name, s in flatten_dict(shapes, sep="/").items():
        a = r.randn(*s.shape)
        a = (np.abs(a) + 0.5) * 0.7 if name.endswith("/g") else a * 0.1
        flat[name] = a.astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The spawned jobs, started first so that the JAX references run beside
    them."""
    tmp = tmp_path_factory.mktemp("cp")
    flat, params = {}, {}
    for which in GENERATOR_PARAMS:
        flat[which] = _generator_params(which)
        params[which] = str(tmp / f"generator_{which}.npz")
        np.savez(params[which], **flat[which])
    out = tmp / "out"
    out.mkdir()
    started = {}
    try:
        started["context"] = Job(tmp, 4, job_context, str(out), params)
        started["raises"] = Job(tmp, 2, job_rank_raises, str(out), params)
        yield {"out": out, "flat": flat, **started}
    finally:
        for job in started.values():
            job.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh(n, data=1):
    devices = np.array(jax.devices()[:n * data])
    if data == 1:
        return Mesh(devices, axis_names=("context",))
    return Mesh(devices.reshape(data, n), axis_names=("data", "context"))


@pytest.fixture(scope="module")
def refs(jobs):
    """JAX's ring (P = 2, 4, data 2 × context 2), the dense reference, JAX's
    vocoder (whole, P = 4, data 2 × context 2) and the port's whole
    generator."""
    q, k, v, rel_k, rel_v, mask = (jnp.asarray(a) for a in ring_inputs())
    ring = {}
    for name, mesh, batch in (("ring4", _mesh(4), None), ("ring2", _mesh(2), None),
                              ("ring2x2", _mesh(2, 2), "data")):
        fn = jax_context.make_ring_attention(mesh, window=RING["w"], batch_axis=batch)
        ring[name] = np.asarray(jax.jit(fn)(q, k, v, rel_k, rel_v, mask))
    dense = np.asarray(jax.jit(xla_reference, static_argnums=6)(
        q, k, v, rel_k[None], rel_v[None], mask, RING["w"]))

    jm = _jax_generator()
    z, g = vocoder_inputs()

    def cp(mesh, batch=None):
        # the parameters an argument, not a constant: one compile for both sets
        return jax.jit(lambda v, zz, gg: jax_context.make_generator_context_parallel(
            lambda zl, gl: jm.apply(v, zl, gl), mesh, hop_length=HOP, halo=HALO,
            batch_axis=batch)(zz, gg))

    cp4, cp2x2, whole = cp(_mesh(4)), cp(_mesh(2, 2), "data"), jax.jit(jm.apply)
    voc = {}
    for which in GENERATOR_PARAMS:
        variables = {"params": unflatten_dict(
            {tuple(n.split("/")): jnp.asarray(a) for n, a in jobs["flat"][which].items()})}
        voc[f"vocoder4_{which}"] = np.asarray(cp4(variables, z[:1], g[:1]))
        voc[f"vocoder2x2_{which}"] = np.asarray(cp2x2(variables, z, g))
        voc[f"jax_whole_{which}"] = np.asarray(whole(variables, z, g))
        with torch.no_grad():
            voc[f"whole_{which}"] = generator(jobs["flat"][which])(
                torch.from_numpy(z), torch.from_numpy(g)).numpy()
    return {**ring, **voc, "dense": dense}


@pytest.fixture(scope="module")
def ranks(jobs, refs):
    jobs["context"].join()
    return [torch.load(jobs["out"] / f"context_rank{r}.pt", weights_only=False)
            for r in range(4)]


def _valid_rows(got, want):
    T = RING["T"]
    for b, L in enumerate([T, T - 50]):
        np.testing.assert_allclose(got[b, :, :L], want[b, :, :L], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", GENERATOR_PARAMS)
def test_whole_generator_matches_jax(refs, which):
    a = np.abs(refs[f"jax_whole_{which}"])
    assert 0.05 < a.max() < 0.99 and (a > 0.01).mean() > 0.9   # off tanh's rails
    np.testing.assert_allclose(refs[f"whole_{which}"], refs[f"jax_whole_{which}"],
                               rtol=VOC_TOL, atol=VOC_TOL)


def test_drawn_generator_sees_a_wrong_frame(jobs):
    """With "drawn" parameters one latent frame's sign moves the audio far
    beyond the tests' bound, so a halo taken from the wrong rank fails them
    (with "init" it moves it by ~1e-5, within the bound)."""
    z, g = (torch.from_numpy(a[:1]) for a in vocoder_inputs())
    flipped = z.clone()
    flipped[:, 63] *= -1     # the last frame of shard 0 at P = 4: rank 1's left halo
    gen = generator(jobs["flat"]["drawn"])
    with torch.no_grad():
        moved = float((gen(z, g) - gen(flipped, g)).abs().max())
    assert moved > 100 * VOC_TOL


def test_ring_one_rank_without_a_launcher():
    """P = 1, no process group: the ring is kernel A's plain version (and
    the dense reference) on valid rows."""
    q, k, v, rel_k, rel_v, mask = (torch.from_numpy(a) for a in ring_inputs())
    with torch.no_grad():
        out = make_ring_attention(None, RING["w"])(q, k, v, rel_k, rel_v, mask).numpy()
        plain = relative_self_attention_plain(q, k, v, rel_k[None], rel_v[None], mask,
                                              RING["w"]).numpy()
    _valid_rows(out, plain)
    dense = np.asarray(xla_reference(*(jnp.asarray(a) for a in ring_inputs()[:3]),
                                     jnp.asarray(rel_k[None].numpy()),
                                     jnp.asarray(rel_v[None].numpy()), jnp.asarray(mask),
                                     RING["w"]))
    _valid_rows(out, dense)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("name", ["ring4", "ring2", "ring2x2"])
def test_ring_matches_jax(ranks, refs, name, rank):
    """Each rank's whole output against JAX's ring on a mesh of the same
    shape and against the dense reference, on valid rows."""
    got = ranks[rank][name].numpy()
    assert got.shape == refs[name].shape == (RING["B"], RING["H"], RING["T"], RING["d"])
    _valid_rows(got, refs[name])
    _valid_rows(got, refs["dense"])


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("name", ["vocoder4", "vocoder2x2"])
@pytest.mark.parametrize("which", GENERATOR_PARAMS)
def test_vocoder_matches_jax(ranks, refs, which, name, rank):
    """Each rank's audio against JAX's overlap-save vocoder everywhere, and
    against the port's whole generator on the interior: with "init" at the
    JAX test's edge of 16 samples, at most 2·edge samples apart; with
    "drawn", whose halo-against-padding difference reaches ~560 samples from
    each end, at half the halo (16 frames, 1024 samples)."""
    got = ranks[rank][f"{name}_{which}"].numpy()
    B = got.shape[0]
    assert got.shape == refs[f"{name}_{which}"].shape == (B, 256 * HOP, 1)
    np.testing.assert_allclose(got, refs[f"{name}_{which}"], rtol=VOC_TOL, atol=VOC_TOL)
    edge = EDGE if which == "init" else HALO // 2 * HOP
    whole = refs[f"whole_{which}"][:B]
    np.testing.assert_allclose(got[:, edge:-edge], whole[:, edge:-edge], rtol=VOC_TOL,
                               atol=VOC_TOL)
    for b in range(B):
        bad = np.flatnonzero(~np.isclose(got[b, :, 0], whole[b, :, 0], rtol=VOC_TOL,
                                         atol=VOC_TOL))
        assert bad.size <= 2 * edge


@pytest.mark.parametrize("which", GENERATOR_PARAMS)
def test_vocoder_one_rank_without_a_launcher(jobs, refs, which):
    """P = 1: zero halos at both ends, the interior the whole generator's."""
    z, g = (torch.from_numpy(a) for a in vocoder_inputs())
    with torch.no_grad():
        out = make_generator_context_parallel(generator(jobs["flat"][which]), None, HOP,
                                              HALO)(z, g)
    whole = refs[f"whole_{which}"]
    edge = EDGE if which == "init" else HALO // 2 * HOP
    assert out.shape == whole.shape
    np.testing.assert_allclose(out.numpy()[:, edge:-edge], whole[:, edge:-edge],
                               rtol=VOC_TOL, atol=VOC_TOL)


def test_shift_is_ppermute(ranks):
    """``shift(x, group, o)`` on rank i returns rank (i − o) % P's x; a
    batch keeps its order and dtypes; the pairs {0, 1}, {2, 3} swap."""
    x = [torch.arange(6, dtype=torch.float32) + 10 * r for r in range(4)]
    for r, got in enumerate(ranks):
        for off, t in got["shift"].items():
            assert torch.equal(t, x[(r - off) % 4]), (r, off)
        a, b, c = got["shift_many"]
        src = x[(r - 1) % 4]
        assert torch.equal(a, src) and torch.equal(b, src.long() * 3) and torch.equal(c, src[:2])
        assert torch.equal(got["shift_pair"], x[r ^ 1])


@pytest.mark.parametrize("guard, match", [
    ("vocoder T % P", "254 does not divide into 4"),
    ("vocoder T/P < halo", "30 frames a shard"),
    ("vocoder B % data", "batch size 1 does not divide into 2"),
    ("ring T % P", "254 does not divide into 4"),
    ("ring B % data", "batch size 1 does not divide into 2"),
    ("ring requires grad", "forward only"),
])
def test_guards_raise_on_every_rank(ranks, guard, match):
    for r, got in enumerate(ranks):
        msg = got["guards"][guard]
        assert msg is not None and match in msg, (r, msg)


def test_guards_without_a_launcher(jobs):
    gen = generator(jobs["flat"]["init"])
    z, g = (torch.from_numpy(a[:1]) for a in vocoder_inputs())
    with pytest.raises(ValueError, match="less than the halo"):
        make_generator_context_parallel(gen, None, HOP, HALO)(z[:, :HALO - 1], g)
    with pytest.raises(ValueError, match="at least one frame"):
        make_generator_context_parallel(gen, None, HOP, 0)
    q, k, v, rel_k, rel_v, mask = (torch.from_numpy(a) for a in ring_inputs())
    with pytest.raises(RuntimeError, match="forward only"):
        make_ring_attention(None)(q, k, v.requires_grad_(), rel_k, rel_v, mask)


def test_a_raising_rank_fails_its_job(jobs, ranks):
    """Rank 1's generator raises after the rendezvous; rank 0, waiting for
    its chunk, fails too (gloo reports the closed peer) and is not left
    hanging: both exit 1 by themselves (a rank the join kills exits −9)."""
    job = jobs["raises"]
    with pytest.raises(AssertionError, match="exit codes"):
        job.join()
    assert [p.exitcode for p in job.procs] == [1, 1]
    assert all((jobs["out"] / f"raises_ready_{r}").exists() for r in range(2))
