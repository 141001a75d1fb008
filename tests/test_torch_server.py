"""The port's HTTP server (``vispeech_tpu_torch/infer/server.py``), its
output resampler and serving from any checkpoint, on the CPU at the small
widths of ``test_torch_synthesizer.py`` (whose seeded weights and
tolerances these tests share).

* Every server case of ``tests/test_infer.py``, in the serial-mutex mode
  and with the coalescer, plus the 503 and 404 answers.
* Against the JAX server: the same weights behind
  ``vispeech_tpu.infer.server.make_handler`` on a JAX ``TTSEngine`` and
  behind the port's server on ``TTSEngine.from_flax_params``, the same
  ``GET /tts.json`` and ``POST /tts`` (noise 0, array controls).  Phones
  and durations are equal; f0 and energy are held to ``F0_RTOL`` /
  ``F0_ATOL`` / ``ENERGY_ATOL`` of ``test_torch_synthesizer.py``; WAV
  headers are equal and the PCM agrees within ceil(AUDIO_ATOL·32767) + 1
  LSB (the audio tolerance, plus one LSB for a rounding that the audio's
  difference moves across a half).
* ``resample`` bit for bit against the JAX package's, on scipy's path and
  on the numpy path.
* ``TTSEngine.from_checkpoint``, the synthesis CLI and the server's
  ``main`` on a port ``ckpt_*.pt``, a JAX ``ckpt_*.npz`` and a reference
  ``G_*.pth``, all saved from one seeded port model.
* Plain text against the JAX server: English through a loaded lexicon, in
  an ``[EN]`` block and unfenced, on ``/tts.json`` and ``/tts``; hanzi with
  no zh lexicon loaded is a 400 in both; the CLI's ``-t`` and the server's
  ``main`` with ``--en-lexicon``.
"""

import io
import json
import math
import struct
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from urllib.parse import quote

import numpy as np
import pytest
import torch
from scipy.io import wavfile
from test_torch_synthesizer import (  # noqa: F401 - `models` is a fixture
    AUDIO_ATOL,
    CFG,
    ENERGY_ATOL,
    F0_ATOL,
    F0_RTOL,
    HOP,
    TEXTS,
    models,
)
from test_torch_text import EN_LEX, PACKAGES, PORT, _saved_state

from vispeech_tpu.dsp.resample import resample as jax_resample
from vispeech_tpu.infer.pipeline import TTSEngine as JaxEngine
from vispeech_tpu.infer.server import make_handler as jax_make_handler
from vispeech_tpu.ops.policy import FLOAT32_XLA
from vispeech_tpu_torch.dsp.resample import resample
from vispeech_tpu_torch.infer import cli, server
from vispeech_tpu_torch.infer.coalescer import ServerBusy
from vispeech_tpu_torch.infer.pipeline import TTSEngine, find_checkpoint
from vispeech_tpu_torch.utils.checkpoint import AsyncCheckpointer

PCM_LSB = math.ceil(AUDIO_ATOL * 32767) + 1
TEXT = TEXTS[0]


def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, coalescer=None):
    httpd.shutdown()
    httpd.server_close()
    if coalescer is not None:
        coalescer.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post(url, body: bytes, ctype="application/json"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _error(fn, *args):
    """(status, JSON body) of a request that must fail."""
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn(*args)
    return ei.value.code, json.loads(ei.value.read())


def _pcm(wav: bytes):
    return np.frombuffer(wav[44:], "<i2")


def _wav_body(samples: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, samples)
    return buf.getvalue()


@pytest.fixture(scope="module")
def engine(models):
    return TTSEngine.from_flax_params(models["pcfg"], models["flat"], device="cpu",
                                      transfer_int16=False)


@pytest.fixture(scope="module", params=["mutex", "coalesced"])
def url(engine, request):
    httpd, coalescer = server.make_server(
        engine, "127.0.0.1", 0, batch_window_ms=0.0 if request.param == "mutex" else 20.0)
    threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    _stop(httpd, coalescer)


class TestEndpoints:
    def test_health(self, url):
        assert json.loads(_get(f"{url}/health")[2]) == {"ok": True}

    def test_tts_wav(self, url):
        status, ctype, body = _get(f"{url}/tts?text={quote(TEXT)}")
        assert status == 200 and ctype == "audio/wav"
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        assert struct.unpack("<I", body[24:28])[0] == 8000
        assert len(body) > 100 and (len(body) - 44) % (2 * HOP) == 0

    def test_tts_output_rate_conversion(self, url):
        n = len(_get(f"{url}/tts?text={quote(TEXT)}")[2]) - 44
        body = _get(f"{url}/tts?text={quote(TEXT)}&sr=4000")[2]
        assert body[:4] == b"RIFF" and struct.unpack("<I", body[24:28])[0] == 4000
        assert abs(len(body) - 44 - n // 2) <= 2

    @pytest.mark.parametrize("path,fragment", [
        ("/tts?text={t}&sr=0", "bad parameter"),
        ("/tts?text={t}&noise=loud", "bad parameter"),
        ("/tts?text=abcxyz", "text frontend"),
        ("/tts", "missing text"),
        ("/tts.json?text=", "missing text"),
    ])
    def test_bad_get_is_400(self, url, path, fragment):
        code, body = _error(_get, url + path.format(t=quote(TEXT)))
        assert code == 400 and fragment in body["error"]

    def test_unknown_path_is_404(self, url):
        assert _error(_get, f"{url}/nope")[0] == 404
        assert _error(_post, f"{url}/nope", b"{}")[0] == 404

    def test_tts_json_prosody(self, url):
        obj = json.loads(_get(f"{url}/tts.json?text={quote(TEXT)}&speaker=1")[2])
        n = len(obj["phones"])
        assert n and len(obj["f0"]) == len(obj["energy"]) == len(obj["duration"]) == n
        assert obj["n_samples"] == int(sum(obj["duration"])) * HOP
        assert obj["sampling_rate"] == 8000

    def test_gui_page(self, url):
        _, ctype, body = _get(f"{url}/")
        assert "prosody editor" in body.decode() and ctype.startswith("text/html")

    def test_post_tts_array_controls(self, url):
        """The GUI's edit loop: get prosody, POST edited arrays back; the
        duration array sets the length (Σdur × hop samples)."""
        prosody = json.loads(_get(f"{url}/tts.json?text={quote(TEXT)}")[2])
        body = json.dumps({"phones": prosody["phones"], "speaker": 0,
                           "pitch": [f * 1.2 for f in prosody["f0"]],
                           "duration": prosody["duration"],
                           "energy": prosody["energy"]}).encode()
        wav = _post(f"{url}/tts", body)[2]
        assert wav[:4] == b"RIFF"
        assert len(wav) == 44 + 2 * int(sum(prosody["duration"])) * HOP

    def test_post_vc(self, url):
        wav = (np.random.RandomState(0).randn(HOP * 40) * 0.1 * 32767).astype(np.int16)
        out = _post(f"{url}/vc?src=1&tgt=2", _wav_body(wav, 8000), "audio/wav")[2]
        assert out[:4] == b"RIFF"
        assert struct.unpack("<I", out[40:44])[0] // 2 == 40 * HOP

    @pytest.mark.parametrize("path,body,fragment", [
        ("/vc", _wav_body(np.zeros(1600, np.int16), 16000), "sample rate"),
        ("/vc", b"not a wav", "bad WAV"),
        ("/tts", b"{not json", "bad JSON"),
        ("/tts", b'{"speaker": 0}', "missing text"),
        ("/tts", b'{"text": "[P]ni2[P]", "noise": "loud"}', "bad parameter"),
    ])
    def test_bad_post_is_400(self, url, path, body, fragment):
        code, err = _error(_post, url + path, body)
        assert code == 400 and fragment in err["error"]


@pytest.mark.parametrize("path", ["/tts", "/vc"])
def test_held_mutex_is_503(engine, path):
    """With the mutex held (another request or a conversion running), TTS
    in the serial mode and VC in every mode answer 503."""
    lock = threading.Lock()
    httpd, url = _start(server.make_handler(engine, lock))
    try:
        with lock:
            if path == "/tts":
                code, body = _error(_get, f"{url}/tts?text={quote(TEXT)}")
            else:
                code, body = _error(_post, f"{url}/vc",
                                    _wav_body(np.zeros(HOP * 8, np.int16), 8000))
        assert code == 503 and body["error"] == "server busy"
    finally:
        _stop(httpd)


def test_engine_calls_run_on_one_thread(engine, monkeypatch):
    """The handlers' engine calls (TTS in the mutex mode, VC) run on one
    long-lived worker thread, not on each request's own thread, so the
    thread-local state they build (cuDNN's execution plans on the card)
    is kept from one request to the next."""
    threads = []
    for name in ("synthesize", "voice_conversion"):
        real = getattr(engine, name)
        monkeypatch.setattr(engine, name, lambda *a, _real=real, **k:
                            threads.append(threading.current_thread()) or _real(*a, **k))
    httpd, url = _start(server.make_handler(engine, threading.Lock()))
    try:
        for _ in range(2):
            assert _get(f"{url}/tts?text={quote(TEXT)}")[0] == 200
            assert _post(f"{url}/vc", _wav_body(np.zeros(HOP * 8, np.int16), 8000),
                         "audio/wav")[0] == 200
    finally:
        _stop(httpd)
    assert len(threads) == 4 and len(set(threads)) == 1
    assert threads[0] is not threading.main_thread() and threads[0].is_alive()


@pytest.mark.parametrize("error,code", [(ServerBusy("request queue full (2 pending)"), 503),
                                        (TimeoutError("synthesis timed out"), 503),
                                        (RuntimeError("device on fire"), 500)])
def test_coalescer_errors_map_to_status(engine, error, code):
    class Refusing:
        def submit(self, phones, **kwargs):
            raise error

    httpd, url = _start(server.make_handler(engine, threading.Lock(), Refusing()))
    try:
        status, body = _error(_get, f"{url}/tts?text={quote(TEXT)}")
        assert status == code and body["error"] == str(error)
    finally:
        _stop(httpd)


def test_wav_bytes_int16_passthrough_and_float_rounding():
    pcm = np.asarray([0, 100, -32768, 32767], np.int16)
    assert np.array_equal(_pcm(server.wav_bytes(pcm, 8000)), pcm)
    audio = np.asarray([0.5, -2.0, 1e-5, 0.99999], np.float32)
    expect = np.round(np.clip(audio, -1, 1) * 32767).astype(np.int16)
    body = server.wav_bytes(audio, 8000)
    assert np.array_equal(_pcm(body), expect)
    assert body[:44] == server.wav_bytes(expect, 8000)[:44]


def test_same_answers_as_the_jax_server(models, engine):
    jax_engine = JaxEngine(models["jcfg"], models["variables"], policy=FLOAT32_XLA,
                           transfer_int16=False)
    jax_httpd, jax_url = _start(jax_make_handler(jax_engine, threading.Lock()))
    httpd, url = _start(server.make_handler(engine, threading.Lock()))
    try:
        query = (f"/tts.json?text={quote(TEXTS[2])}&speaker=2&noise=0&duration=1.5"
                 f"&pitch=0.9&energy=1.2")
        ref, out = (json.loads(_get(u + query)[2]) for u in (jax_url, url))
        assert out["phones"] == ref["phones"] and out["duration"] == ref["duration"]
        assert out["n_samples"] == ref["n_samples"] == int(sum(ref["duration"])) * HOP
        np.testing.assert_allclose(out["f0"], ref["f0"], rtol=F0_RTOL, atol=F0_ATOL)
        np.testing.assert_allclose(out["energy"], ref["energy"], rtol=0, atol=ENERGY_ATOL)

        r = np.random.RandomState(7)
        n = len(ref["phones"])
        body = json.dumps({"phones": ref["phones"], "speaker": "alice", "noise": 0,
                           "duration": r.randint(2, 7, n).tolist(),
                           "pitch": r.uniform(120, 260, n).tolist(),
                           "energy": r.uniform(40, 80, n).tolist()}).encode()
        ref_wav, wav = (_post(u + "/tts", body)[2] for u in (jax_url, url))
        assert wav[:44] == ref_wav[:44]
        assert np.abs(_pcm(ref_wav)).max() > 100
        diff = np.abs(_pcm(wav).astype(np.int32) - _pcm(ref_wav))
        assert diff.max() <= PCM_LSB, diff.max()
    finally:
        _stop(jax_httpd)
        _stop(httpd)


@pytest.mark.parametrize("sr_out", [22050, 16000, 44100])
@pytest.mark.parametrize("scipy_path", [True, False])
def test_resample_matches_jax(monkeypatch, sr_out, scipy_path):
    wav = np.random.RandomState(3).randn(4410).astype(np.float32)
    if not scipy_path:
        monkeypatch.setitem(sys.modules, "scipy.signal", None)   # its import fails
    out, ref = resample(wav, 44100, sr_out), jax_resample(wav, 44100, sr_out)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)
    if sr_out == 44100:
        assert out is wav
    elif not scipy_path:
        assert np.array_equal(out, np.interp(
            np.linspace(0, 1, len(out), endpoint=False),
            np.linspace(0, 1, len(wav), endpoint=False), wav).astype(np.float32))


# ------------------------------------------------------ serving any checkpoint

DEAD = {"enc_p.proj.weight": torch.zeros(32, 16, 1), "enc_p.proj.bias": torch.zeros(32),
        "frame_prior_net.emb.weight": torch.zeros(121, 16),
        "energy_predictor.predictor.proj.weight": torch.zeros(16, 1)}


def _write_checkpoint(kind: str, run, models, step=1, extra=None, drop=None):
    """A run directory's checkpoint of the seeded port model, as the port
    trainer, the JAX trainer or the reference writes it."""
    sd = {k: v.clone() for k, v in models["pm"].state_dict().items()}
    sd.update(extra or {})
    sd.pop(drop, None)
    if kind == "pt":
        opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(3))])
        opt.param_groups[0]["params"][0].grad = torch.ones(3)
        opt.step()
        ckpt = AsyncCheckpointer()
        ckpt.save(str(run), {"step": step, "model_g": sd, "model_d": {},
                             "optim_g": opt.state_dict(), "optim_d": opt.state_dict(),
                             "generator": torch.Generator().get_state(),
                             "seed_generator": torch.Generator().get_state(),
                             "torch_rng": torch.get_rng_state(), "cuda_rng": None}, step)
        ckpt.wait()
    elif kind == "npz":
        arrays = {f"params_g/params/{k}": v for k, v in models["flat"].items()}
        arrays["step"] = np.asarray(step)
        np.savez(run / f"ckpt_{step}.npz", **arrays)
    else:
        sd = {"module." + k: v for k, v in {**sd, **DEAD}.items()}
        torch.save({"model": sd, "iteration": step, "learning_rate": 2e-4},
                   run / f"G_{step}.pth")


def _assert_same_weights(a, b):
    sd_a, sd_b = a.model.state_dict(), b.model.state_dict()
    assert sd_a.keys() == sd_b.keys()
    for k, v in sd_b.items():
        assert torch.equal(sd_a[k], v), k


@pytest.fixture
def run(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    return tmp_path


@pytest.mark.parametrize("kind", ["pt", "npz", "pth"])
def test_serving_from_each_checkpoint_format(models, engine, run, kind, monkeypatch):
    """``from_checkpoint``, the synthesis CLI and the server's ``main``
    read the format; the engine equals the state-dict engine."""
    _write_checkpoint(kind, run, models)
    config = str(run / "config.json")
    loaded = TTSEngine.from_checkpoint(config, str(run), device="cpu", transfer_int16=False)
    _assert_same_weights(loaded, engine)
    kw = dict(text=TEXTS[1], noise_scale=0.5, seed=3)
    np.testing.assert_array_equal(loaded.synthesize(**kw)["audio"],
                                  engine.synthesize(**kw)["audio"])

    wav = run / "out.wav"
    cli.main(["-c", config, "-k", str(run), "-t", TEXTS[1], "-o", str(wav), "--device", "cpu"])
    sr, data = wavfile.read(wav)
    assert sr == 8000 and data.dtype == np.int16 and len(data) % HOP == 0 and len(data)

    served = {}
    monkeypatch.setattr(server, "serve", lambda e, *a, **k: served.update(engine=e, args=a, kw=k))
    server.main(["-c", config, "-k", str(run), "--device", "cpu", "--port", "0",
                 "--batch-window-ms", "0", "--max-batch", "4"])
    assert served["engine"].device.type == "cpu"
    assert served["args"] == ("0.0.0.0", 0)
    assert served["kw"] == {"batch_window_ms": 0.0, "max_batch": 4}
    _assert_same_weights(served["engine"], engine)


def test_checkpoint_preference_and_step(models, run):
    """The port's ckpt_*.pt before the JAX ckpt_*.npz before the reference's
    G_*.pth, whatever their steps; ``step`` picks the format that has it."""
    with pytest.raises(FileNotFoundError):
        find_checkpoint(str(run))
    _write_checkpoint("pth", run, models, step=9)
    assert find_checkpoint(str(run)) == ("pth", str(run / "G_9.pth"))
    _write_checkpoint("npz", run, models, step=5)
    _write_checkpoint("npz", run, models, step=7)
    assert find_checkpoint(str(run)) == ("npz", str(run / "ckpt_7.npz"))
    _write_checkpoint("pt", run, models, step=2)
    assert find_checkpoint(str(run)) == ("pt", str(run / "ckpt_2.pt"))
    assert find_checkpoint(str(run), step=5) == ("npz", str(run / "ckpt_5.npz"))
    assert find_checkpoint(str(run), step=9) == ("pth", str(run / "G_9.pth"))
    with pytest.raises(FileNotFoundError, match="step 3"):
        find_checkpoint(str(run), step=3)


@pytest.mark.parametrize("kind", ["pt", "pth"])
@pytest.mark.parametrize("fault", ["leftover", "empty"])
def test_checkpoint_that_does_not_fit_raises(models, run, kind, fault):
    """A key the port does not have (past the dead reference weights), or a
    port key left empty, raises."""
    if fault == "leftover":
        _write_checkpoint(kind, run, models, extra={"dec.extra.weight": torch.zeros(2)})
        match = "dec.extra.weight"
    else:
        _write_checkpoint(kind, run, models, drop="dec.conv_post.weight")
        match = "dec.conv_post.weight"
    with pytest.raises(RuntimeError, match=match):
        TTSEngine.from_checkpoint(str(run / "config.json"), str(run), device="cpu")


def test_main_without_device_needs_a_gpu(run, monkeypatch):
    """No ``--device``: CUDA, which raises without a GPU before anything is
    loaded or served."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(server, "serve", lambda *a, **k: pytest.fail("served"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["-c", str(run / "config.json"), "-k", str(run)])


# ------------------------------------------------------------------ plain text

# an [EN] block drops its trailing punctuation; unfenced, "!" is a zh segment
PLAIN_TEXTS = {"[EN]ab c, d![EN]": ["AE1", "B", "S", "IY1", ",", "D", "IY1"],
               "ab c, d!": ["AE1", "B", "S", "IY1", ",", "D", "IY1", "!"]}


@pytest.fixture
def en_lexicon(tmp_path):
    """The golden corpus's en lexicon loaded into both packages, and their
    lexicons and zh backend restored after the test."""
    path = tmp_path / "en.lex"
    path.write_text(EN_LEX, encoding="utf-8")
    with _saved_state():
        for P in PACKAGES:
            P.frontends.load_en_lexicon(str(path))
        yield str(path)


@pytest.fixture(scope="module")
def both_servers(models, engine):
    """(JAX server URL, port server URL) on the same weights."""
    jax_engine = JaxEngine(models["jcfg"], models["variables"], policy=FLOAT32_XLA,
                           transfer_int16=False)
    jax_httpd, jax_url = _start(jax_make_handler(jax_engine, threading.Lock()))
    httpd, url = _start(server.make_handler(engine, threading.Lock()))
    yield jax_url, url
    _stop(jax_httpd)
    _stop(httpd)


@pytest.mark.parametrize("text,phones", PLAIN_TEXTS.items())
def test_plain_text_same_answers_as_the_jax_server(both_servers, en_lexicon, text, phones):
    """English through a loaded lexicon, in a block and unfenced: both
    endpoints answer as the JAX server does."""
    query = f"?text={quote(text)}&speaker=2&noise=0&duration=1.5"
    (ref_status, _, ref_body), (status, _, body) = (
        _get(u + "/tts.json" + query) for u in both_servers)
    ref, out = json.loads(ref_body), json.loads(body)
    assert status == ref_status == 200
    assert out["phones"] == ref["phones"] == PORT.pkg.text_to_phones(text)
    assert out["phones"] == phones
    assert out["duration"] == ref["duration"]
    np.testing.assert_allclose(out["f0"], ref["f0"], rtol=F0_RTOL, atol=F0_ATOL)

    (ref_status, ref_ctype, ref_wav), (status, ctype, wav) = (
        _get(u + "/tts" + query) for u in both_servers)
    assert status == ref_status == 200 and ctype == ref_ctype == "audio/wav"
    assert wav[:44] == ref_wav[:44]
    assert np.abs(_pcm(ref_wav)).max() > 100
    diff = np.abs(_pcm(wav).astype(np.int32) - _pcm(ref_wav))
    assert diff.max() <= PCM_LSB, diff.max()


@pytest.mark.parametrize("path", ["/tts", "/tts.json"])
def test_hanzi_without_zh_lexicon_is_400_in_both(both_servers, path):
    with _saved_state():
        for P in PACKAGES:
            P.frontends._ZH_LEXICON.clear()
        (ref_code, ref), (code, out) = (_error(_get, f"{u}{path}?text={quote('你好世界')}")
                                        for u in both_servers)
    assert code == ref_code == 400
    assert out == ref and "text frontend" in out["error"], (out, ref)


def test_cli_and_server_take_plain_text(models, run, en_lexicon, monkeypatch, capsys):
    """``-t`` with plain English and ``--en-lexicon`` writes the WAV of its
    phones; the server's ``main`` loads the same flag."""
    _write_checkpoint("pt", run, models)
    config, lex = str(run / "config.json"), str(run / "en.lex")
    (run / "en.lex").write_text("zz Z IY1\n", encoding="utf-8")
    wav = run / "plain.wav"
    cli.main(["-c", config, "-k", str(run), "-t", "ab c, d! zz", "-o", str(wav),
              "--device", "cpu", "--en-lexicon", lex])
    sr, data = wavfile.read(wav)
    assert sr == 8000 and data.dtype == np.int16 and len(data) % HOP == 0 and len(data)
    assert "phones: AE1 B S IY1 , D IY1 ! Z IY1" in capsys.readouterr().out

    PORT.frontends._EN_LEXICON.pop("zz")
    monkeypatch.setattr(server, "serve", lambda *a, **k: None)
    server.main(["-c", config, "-k", str(run), "--device", "cpu", "--en-lexicon", lex])
    assert PORT.frontends._EN_LEXICON["zz"] == ["Z", "IY1"]
