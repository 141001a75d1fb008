"""The CUDA kernels, each with its plain PyTorch version and a launch
counter.  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel (built on first use) or raises.

Serving: A ``rel_attention``, B ``wn_stack``, C ``mrf_stage``, which have no
backward.  Training: E ``wn_stack_train`` and F ``rel_attention_train``,
each an autograd Function whose forward and backward are kernels.
"""

import torch


def refuse_autograd(kernel: str, trainable: str, *tensors) -> None:
    """An inference kernel's output carries no graph, so launching it on
    tensors that autograd tracks would cut the gradients off silently:
    raise instead, naming the trainable kernel to use."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: call it under torch.no_grad(), "
            f"or use {trainable} where gradients are needed")


from vispeech_tpu_torch.ops.kernels import (  # noqa: E402
    mrf_stage,
    rel_attention,
    rel_attention_train,
    wn_stack,
    wn_stack_train,
)

# name → (module, counter attribute)
COUNTERS = {
    "rel_attention": (rel_attention, "launches"),
    "wn_stack": (wn_stack, "launches"),
    "mrf_stage": (mrf_stage, "launches"),
    "wn_stack_train_fwd": (wn_stack_train, "fwd_launches"),
    "wn_stack_train_bwd": (wn_stack_train, "bwd_launches"),
    "rel_attention_train_fwd": (rel_attention_train, "fwd_launches"),
    "rel_attention_train_bwd": (rel_attention_train, "bwd_launches"),
}


def reset_launches() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}
