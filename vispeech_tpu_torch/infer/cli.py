"""Command-line synthesis with the PyTorch port.

    python -m vispeech_tpu_torch.infer.cli -c configs/config.json -k logdir/run \
        -t "[P]ni2 hao3[P]" -s 0 -o out.wav [--device cpu]

``-k`` names a run directory holding the port trainer's ``ckpt_*.pt``, the
JAX trainer's ``ckpt_*.npz`` or the reference's ``G_*.pth``
(``TTSEngine.from_checkpoint``).  Without ``--device cpu`` it needs a GPU.
"""

from __future__ import annotations

import argparse
import time

from scipy.io import wavfile


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-k", "--ckpt-dir", required=True,
                   help="run directory with ckpt_*.pt, ckpt_*.npz or G_*.pth")
    p.add_argument("-t", "--text", required=True)
    p.add_argument("-s", "--speaker", default="0")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--noise-scale", type=float, default=0.667)
    p.add_argument("--duration-scale", type=float, default=None)
    p.add_argument("--pitch-scale", type=float, default=None)
    p.add_argument("--energy-scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from vispeech_tpu_torch.infer.pipeline import TTSEngine

    engine = TTSEngine.from_checkpoint(args.config, args.ckpt_dir, device=args.device,
                                       transfer_int16=True)
    speaker = int(args.speaker) if args.speaker.isdigit() else args.speaker
    t0 = time.time()
    out = engine.synthesize(
        text=args.text, speaker=speaker, noise_scale=args.noise_scale,
        duration_control=args.duration_scale, pitch_control=args.pitch_scale,
        energy_control=args.energy_scale, seed=args.seed)
    dt = time.time() - t0
    sr = out["sampling_rate"]
    n = len(out["audio_int16"])
    wavfile.write(args.output, sr, out["audio_int16"])
    print(f"wrote {args.output}: {n / sr:.2f}s audio in {dt:.2f}s "
          f"({n / sr / dt:.1f}x realtime)")
    print("phones:", " ".join(out["phones"]))


if __name__ == "__main__":
    main()
