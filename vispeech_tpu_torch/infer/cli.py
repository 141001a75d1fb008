"""Command-line synthesis with the PyTorch port.

    python -m vispeech_tpu_torch.infer.cli -c configs/config.json -k logdir/run \
        -t "你好世界" -s 0 -o out.wav [--device cpu] \
        [--zh-lexicon zh.lex] [--en-lexicon en.lex]

``-t`` takes what ``vispeech_tpu_torch.text.text_to_phones`` takes: plain
Chinese, English or mixed text, ``[ZH]``/``[EN]``/``[JA]`` blocks and
``[P]ni2 hao3[P]`` pinyin.  Hanzi need jieba and either pypinyin or a
``--zh-lexicon`` (lines ``word pin1 yin1 ...``); English words need g2p_en
or an ``--en-lexicon`` (CMUdict lines ``word PHONES...``).  ``-k`` names a
run directory holding the port trainer's ``ckpt_*.pt``, the JAX trainer's
``ckpt_*.npz`` or the reference's ``G_*.pth``
(``TTSEngine.from_checkpoint``).  Without ``--device cpu`` it needs a GPU.
"""

from __future__ import annotations

import argparse
import time

from scipy.io import wavfile


def add_lexicon_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--zh-lexicon", action="append", default=[],
                   help="hanzi lexicon (word pin1 yin1 ...) for Mandarin G2P "
                        "without pypinyin; repeatable")
    p.add_argument("--en-lexicon", action="append", default=[],
                   help="CMUdict-style lexicon (word PHONES...) looked up "
                        "before g2p_en; repeatable")


def load_lexicons(args: argparse.Namespace) -> None:
    from vispeech_tpu_torch.text.frontends import load_en_lexicon, load_zh_lexicon

    for path in args.zh_lexicon:
        load_zh_lexicon(path)
    for path in args.en_lexicon:
        load_en_lexicon(path)


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
    add_lexicon_args(p)
    args = p.parse_args(argv)
    load_lexicons(args)

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
