"""HTTP TTS server of the PyTorch port (``vispeech_tpu/infer/server.py``).

    python -m vispeech_tpu_torch.infer.server -c configs/config.json -k logdir/run \
        [--device cpu] [--batch-window-ms 20] [--max-batch 16]

``-k`` names a run directory holding the port trainer's ``ckpt_*.pt``, the
JAX trainer's ``ckpt_*.npz`` or the reference's ``G_*.pth``
(``TTSEngine.from_checkpoint``).  The engine runs on the GPU unless
``--device cpu`` is given; without a GPU it raises.

Endpoints:
  GET /tts?text=...&speaker=0&noise=0.667&duration=1.0&pitch=1.0&energy=1.0
      [&seed=N][&sr=22050]  → audio/wav (16-bit PCM at the model rate, or
      resampled to ``sr``)
  GET /tts.json?text=...   → JSON with per-phoneme prosody (the GUI editing
      contract: phones, duration, f0, energy)
  POST /tts with a JSON body: per-phoneme ``pitch``, ``duration`` and
      ``energy`` arrays override the predictors
  POST /vc?src=<spk>&tgt=<spk> with a WAV body at the model rate → audio/wav
  GET /health              → {"ok": true}
  GET /                    → the prosody-editor page

Concurrent TTS requests are coalesced into device batches
(``infer/coalescer.py``); ``--batch-window-ms 0`` serves them one at a time
behind a mutex that answers 503 while it is held, as voice conversion
always does.  Errors are JSON: 400 for a bad parameter, JSON or WAV body
or a text-frontend failure, 404 for an unknown path, 500 for an engine
error, 503 for a held mutex or a full queue.  A request that names its
``seed`` is synthesized alone, so its audio does not depend on what
arrives beside it.
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from vispeech_tpu_torch.dsp.resample import resample
from vispeech_tpu_torch.infer.coalescer import RequestCoalescer, ServerBusy

GUI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>vispeech-tpu prosody editor</title>
<style>
body{font-family:sans-serif;max-width:920px;margin:24px auto;padding:0 12px}
textarea{width:100%;height:60px}
#phones{display:flex;gap:6px;overflow-x:auto;padding:12px 0}
.ph{display:flex;flex-direction:column;align-items:center;font-size:12px}
.ph input[type=range]{writing-mode:vertical-lr;direction:rtl;height:120px}
.ph .dur{width:42px}
button{padding:6px 16px;margin-right:8px}
#status{color:#666;margin-left:8px}
</style></head><body>
<h3>vispeech-tpu — per-phoneme prosody editor</h3>
<textarea id="text">[P]ni2 hao3 shi4 jie4[P]</textarea>
<div style="margin:8px 0">
 speaker <input id="spk" value="0" size="6">
 noise <input id="noise" value="0.667" size="5">
 <button onclick="synth()">Synthesize</button>
 <button onclick="resynth()" id="re" disabled>Re-synthesize with edits</button>
 <span id="status"></span>
</div>
<div id="phones"></div>
<audio id="player" controls style="width:100%"></audio>
<script>
let state = null;
const S=id=>document.getElementById(id);
function spk(){const v=S('spk').value;return /^\\d+$/.test(v)?parseInt(v):v}
async function synth(){
  S('status').textContent='predicting…';
  const u=`/tts.json?text=${encodeURIComponent(S('text').value)}`+
          `&speaker=${encodeURIComponent(S('spk').value)}&noise=${S('noise').value}`;
  const r=await fetch(u); const j=await r.json();
  if(j.error){S('status').textContent=j.error;return}
  state=j; render(); await resynth();
}
function render(){
  const div=S('phones'); div.innerHTML='';
  state.phones.forEach((p,i)=>{
    const f0=state.f0[i], d=state.duration[i];
    div.insertAdjacentHTML('beforeend',
     `<div class="ph"><b>${p}</b>
      <input type="range" min="50" max="600" step="1" value="${Math.min(600,Math.max(50,f0))}"
             oninput="state.f0[${i}]=+this.value;this.nextElementSibling.textContent=this.value+'Hz'">
      <span>${Math.round(f0)}Hz</span>
      <input class="dur" type="number" min="0" step="1" value="${Math.round(d)}"
             oninput="state.duration[${i}]=+this.value"></div>`);
  });
  S('re').disabled=false;
}
async function resynth(){
  S('status').textContent='synthesizing…';
  const body={phones:state.phones,speaker:spk(),noise:+S('noise').value,
              pitch:state.f0,duration:state.duration,energy:state.energy};
  const r=await fetch('/tts',{method:'POST',headers:{'Content-Type':'application/json'},
                              body:JSON.stringify(body)});
  if(!r.ok){S('status').textContent=(await r.json()).error;return}
  const blob=await r.blob();
  S('player').src=URL.createObjectURL(blob); S('player').play();
  S('status').textContent='done';
}
</script></body></html>
"""


def wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    """Encode a waveform as 16-bit PCM WAV in memory.  int16 input (the
    engine's on-device quantized ``audio_int16``) passes through untouched;
    float input is rounded here as the engine rounds on the device."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        pcm = audio.astype("<i2", copy=False)
    else:
        pcm = np.round(np.clip(audio.astype(np.float32), -1, 1) * 32767).astype("<i2")
    data = pcm.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    return hdr + data


def _speaker(value: str):
    return int(value) if value.isdigit() else value


def make_handler(engine, lock: threading.Lock, coalescer: Optional[RequestCoalescer] = None):
    """The request handler class.  ``lock`` is the server's non-blocking
    mutex (503 while held): it serializes TTS when ``coalescer`` is None,
    and voice conversion always.

    The server answers each request on a new thread, but the engine calls
    the handlers make run on one long-lived worker thread, as the
    coalescer's calls run on its dispatcher: PyTorch keeps cuDNN's
    execution plans per thread, so a call on a new thread would build
    every plan of its shapes again."""
    worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine")

    def on_worker(fn, *args, **kwargs):
        return worker.submit(fn, *args, **kwargs).result()

    class Handler(BaseHTTPRequestHandler):
        def _synthesize(self, phones, kwargs):
            """(out, error_response): coalesced when enabled, else mutex."""
            if coalescer is not None:
                try:
                    return coalescer.submit(phones, **kwargs), None
                except (ServerBusy, TimeoutError) as e:
                    return None, (503, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 - an engine error, to the client
                    return None, (500, {"error": str(e)})
            if not lock.acquire(blocking=False):
                return None, (503, {"error": "server busy"})
            try:
                return on_worker(engine.synthesize, phones=phones, **kwargs), None
            except Exception as e:  # noqa: BLE001
                return None, (500, {"error": str(e)})
            finally:
                lock.release()

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj, ensure_ascii=False).encode(), "application/json")

        def _phones(self, text: str):
            """(phones, None) or (None, 400 response): a frontend failure is
            the client's error."""
            try:
                phones = engine.phonemes(text)
                if not phones:
                    raise ValueError("text produced no phonemes")
                return phones, None
            except Exception as e:  # noqa: BLE001
                return None, (400, {"error": f"text frontend: {e}"})

        def _send_audio(self, out, sr_out: Optional[int]):
            audio, sr = out["audio"], out["sampling_rate"]
            if sr_out is not None and sr_out != sr:
                audio, sr = resample(audio, sr, sr_out), sr_out
            elif "audio_int16" in out:  # device-quantized PCM: no second rounding
                audio = out["audio_int16"]
            return self._send(200, wav_bytes(audio, sr), "audio/wav")

        def _do_vc(self, url):
            """POST /vc?src=<spk>&tgt=<spk> with a WAV body → converted WAV."""
            from scipy.io import wavfile

            q = {k: v[0] for k, v in urllib.parse.parse_qs(url.query).items()}
            try:
                length = int(self.headers.get("Content-Length", 0))
                sr, data = wavfile.read(io.BytesIO(self.rfile.read(length)))
            except Exception as e:  # noqa: BLE001
                return self._json(400, {"error": f"bad WAV body: {e}"})
            if sr != engine.cfg.data.sampling_rate:
                return self._json(400, {
                    "error": f"sample rate {sr} != {engine.cfg.data.sampling_rate}"})
            if data.dtype.kind == "i":
                wav = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
            else:
                wav = data.astype(np.float32)
            if wav.ndim > 1:
                wav = wav[:, 0]
            if not lock.acquire(blocking=False):
                return self._json(503, {"error": "server busy"})
            try:
                out = on_worker(engine.voice_conversion, wav,
                                speaker_src=_speaker(q.get("src", "0")),
                                speaker_tgt=_speaker(q.get("tgt", "0")))
            except Exception as e:  # noqa: BLE001
                return self._json(500, {"error": str(e)})
            finally:
                lock.release()
            return self._send(200, wav_bytes(out["audio"], out["sampling_rate"]), "audio/wav")

        def do_POST(self):  # noqa: N802
            url = urllib.parse.urlparse(self.path)
            if url.path == "/vc":
                return self._do_vc(url)
            if url.path != "/tts":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                return self._json(400, {"error": f"bad JSON: {e}"})
            text = body.get("text")
            phones = body.get("phones")
            if not text and not phones:
                return self._json(400, {"error": "missing text or phones"})

            def ctrl(name):
                v = body.get(name)
                if v is None:
                    return None
                if isinstance(v, (int, float)):
                    return float(v)
                return np.asarray(v, np.float32)

            try:
                kwargs = dict(speaker=body.get("speaker", 0),
                              noise_scale=float(body.get("noise", 0.667)),
                              duration_control=ctrl("duration"), pitch_control=ctrl("pitch"),
                              energy_control=ctrl("energy"))
                if "seed" in body:
                    kwargs["seed"] = int(body["seed"])
                sr_out = int(body["sr"]) if "sr" in body else None
                if sr_out is not None and sr_out <= 0:
                    raise ValueError(f"sr={sr_out}")
            except (TypeError, ValueError) as e:
                return self._json(400, {"error": f"bad parameter: {e}"})
            if not phones:
                phones, err = self._phones(text)
                if err is not None:
                    return self._json(*err)
            out, err = self._synthesize(phones, kwargs)
            if err is not None:
                return self._json(*err)
            return self._send_audio(out, sr_out)

        def do_GET(self):  # noqa: N802
            url = urllib.parse.urlparse(self.path)
            q = {k: v[0] for k, v in urllib.parse.parse_qs(url.query).items()}
            if url.path == "/health":
                return self._json(200, {"ok": True})
            if url.path in ("/", "/index.html"):
                return self._send(200, GUI_HTML.encode(), "text/html; charset=utf-8")
            if url.path not in ("/tts", "/tts.json"):
                return self._json(404, {"error": "not found"})
            text = q.get("text", "")
            if not text:
                return self._json(400, {"error": "missing text"})
            try:
                kwargs = dict(
                    speaker=_speaker(q.get("speaker", "0")),
                    noise_scale=float(q.get("noise", 0.667)),
                    duration_control=float(q["duration"]) if "duration" in q else None,
                    pitch_control=float(q["pitch"]) if "pitch" in q else None,
                    energy_control=float(q["energy"]) if "energy" in q else None)
                if "seed" in q:
                    kwargs["seed"] = int(q["seed"])
                sr_out = int(q["sr"]) if "sr" in q else None
                if sr_out is not None and sr_out <= 0:
                    raise ValueError(f"sr={sr_out}")
            except ValueError as e:
                return self._json(400, {"error": f"bad parameter: {e}"})
            phones, err = self._phones(text)
            if err is None:
                out, err = self._synthesize(phones, kwargs)
            if err is not None:
                return self._json(*err)
            if url.path == "/tts.json":
                return self._json(200, {
                    "sampling_rate": out["sampling_rate"],
                    "phones": out["phones"],
                    "duration": [float(x) for x in out["duration"]],
                    "f0": [float(x) for x in out["f0"]],
                    "energy": [float(x) for x in out["energy"]],
                    "n_samples": int(len(out["audio"])),
                })
            return self._send_audio(out, sr_out)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def make_server(engine, host: str = "0.0.0.0", port: int = 7860,
                batch_window_ms: float = 20.0,
                max_batch: int = 16) -> Tuple[ThreadingHTTPServer, Optional[RequestCoalescer]]:
    """The bound server, not yet serving, and its coalescer (None when
    ``batch_window_ms`` is 0: the serial mutex).  Stop it with
    ``httpd.shutdown()``, ``httpd.server_close()`` and ``coalescer.close()``."""
    coalescer = (RequestCoalescer(engine, window_ms=batch_window_ms, max_batch=max_batch)
                 if batch_window_ms > 0 else None)
    try:
        httpd = ThreadingHTTPServer((host, port),
                                    make_handler(engine, threading.Lock(), coalescer))
    except BaseException:
        if coalescer is not None:
            coalescer.close()
        raise
    return httpd, coalescer


def serve(engine, host: str = "0.0.0.0", port: int = 7860,
          batch_window_ms: float = 20.0, max_batch: int = 16) -> None:
    """Serve until interrupted.  ``batch_window_ms > 0`` coalesces
    concurrent TTS requests into device batches; 0 serves them one at a
    time and answers 503 to a request that arrives meanwhile."""
    httpd, coalescer = make_server(engine, host, port, batch_window_ms, max_batch)
    mode = (f"coalescing (window {batch_window_ms} ms, max_batch {max_batch})"
            if coalescer else "serial mutex")
    print(f"serving on http://{host}:{httpd.server_address[1]}/tts?text=... "
          f"[{mode}, {engine.device}]", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if coalescer is not None:
            coalescer.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-k", "--ckpt-dir", required=True,
                   help="run directory with ckpt_*.pt, ckpt_*.npz or G_*.pth")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--batch-window-ms", type=float, default=20.0,
                   help="request-coalescing window; 0 = serial mutex mode")
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from vispeech_tpu_torch.infer.pipeline import TTSEngine
    from vispeech_tpu_torch.ops.policy import resolve_device

    resolve_device(args.device)   # no GPU and no --device cpu: raise before loading
    engine = TTSEngine.from_checkpoint(args.config, args.ckpt_dir, device=args.device)
    serve(engine, args.host, args.port, batch_window_ms=args.batch_window_ms,
          max_batch=args.max_batch)


if __name__ == "__main__":
    main()
