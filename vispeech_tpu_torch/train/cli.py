"""Training CLI:

    python -m vispeech_tpu_torch.train.cli -c configs/config.json \\
        --data-root DIR --max-steps N [--device cpu] [-m SAVE_DIR]

Trains on the GPU unless ``--device cpu``; resumes from the newest
checkpoint in the save directory (the port's ``ckpt_*.pt``, else a JAX
``ckpt_*.npz``).  ``--model-parallel`` > 1 and ``--profile`` are refused:
they wait in ``ROADMAP.md`` queue 1.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", default="configs/config.json")
    p.add_argument("-m", "--model-dir", default=None, help="override train.save_dir")
    p.add_argument("--data-root", default="dataset")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--profile", default=None, metavar="START:STOP")
    args = p.parse_args(argv)
    if args.model_parallel != 1:
        p.error("--model-parallel > 1 (the data × model mesh) is not ported yet: "
                "ROADMAP.md queue 1 item 7")
    if args.profile:
        p.error("--profile is not ported yet: ROADMAP.md queue 1 item 9")

    from vispeech_tpu_torch.config import load_config
    from vispeech_tpu_torch.train.loop import Trainer

    cfg = load_config(args.config)
    if args.model_dir:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 save_dir=args.model_dir))
    trainer = Trainer(cfg, data_root=args.data_root, device=args.device)
    trainer.resume()
    trainer.train(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
