"""The CUDA kernels of the serving path, each with its plain PyTorch version
and a launch counter.  A CPU tensor runs the plain version; a CUDA tensor
launches the kernel (built on first use) or raises."""

from vispeech_tpu_torch.ops.kernels import mrf_stage, rel_attention, wn_stack

KERNELS = (rel_attention, wn_stack, mrf_stage)


def reset_launches() -> None:
    for mod in KERNELS:
        mod.launches = 0
