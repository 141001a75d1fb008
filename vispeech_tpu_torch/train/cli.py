"""Training CLI:

    python -m vispeech_tpu_torch.train.cli -c configs/config.json \\
        --data-root DIR --max-steps N [--device cpu] [-m SAVE_DIR] \\
        [--profile START:STOP]

Trains on the GPU unless ``--device cpu``; resumes from the newest
checkpoint in the save directory (the port's ``ckpt_*.pt``, else a JAX
``ckpt_*.npz``).  ``--profile START:STOP`` writes a Chrome trace of the
steps [START, STOP) into ``SAVE_DIR/profile``.  Data parallelism: launched
by torchrun, one process a GPU,

    torchrun --standalone --nproc_per_node N -m vispeech_tpu_torch.train.cli \\
        -c configs/config.json --data-root DIR

each process joins the mesh (``parallel.make_mesh``: NCCL, or gloo with
``--device cpu``).  ``--model-parallel M`` (M divides N) makes N / M data
ranks of M model ranks each: the ranks of a model group hold slices of
the generator's sharded parameters (tensor parallelism) and train on the
same share of a global batch of ``batch_size × N / M``.
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
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model ranks per data rank (tensor parallelism); divides the world size")
    p.add_argument("--profile", default=None, metavar="START:STOP",
                   help="trace steps [START, STOP) into save_dir/profile (a Chrome trace "
                        "for Perfetto or chrome://tracing)")
    args = p.parse_args(argv)
    profile_steps = None
    if args.profile:
        lo, sep, hi = args.profile.partition(":")
        if not sep or not lo.isdigit() or not hi.isdigit():
            p.error("--profile expects START:STOP (two integers)")
        profile_steps = (int(lo), int(hi))

    from vispeech_tpu_torch.config import load_config
    from vispeech_tpu_torch.parallel import make_mesh
    from vispeech_tpu_torch.train.loop import Trainer

    cfg = load_config(args.config)
    if args.model_dir:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 save_dir=args.model_dir))
    try:   # a world of one without torchrun
        mesh = make_mesh(model=args.model_parallel, device=args.device)
    except ValueError as e:
        p.error(str(e))
    try:
        trainer = Trainer(cfg, data_root=args.data_root, mesh=mesh)
        trainer.resume()
        trainer.train(max_steps=args.max_steps, profile_steps=profile_steps)
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
