"""Carry flax parameters (the JAX package's trees, and the ``params_g/...``
arrays of its ``ckpt_*.npz`` checkpoints) onto the port's state dict.

The flax modules were laid out torch-compatibly, so the map is a rename
plus a layout change per leaf:

  * conv ``kernel`` [k, cin, cout]      → ``weight`` [cout, cin, k]
  * dense ``kernel`` [in, out]          → ``weight`` [out, in]
  * weight-norm ``v`` [k, cin, cout]    → ``weight_v`` [cout, cin, k]
  * transposed-conv ``v`` (stored kernel-flipped) → ``weight_v`` [cin, cout, k]
  * weight-norm ``g`` [c]               → ``weight_g`` [c, 1, 1]
  * ``embedding``                       → ``weight``

Names: ``attn_3`` → ``attn_layers.3``, ``couplings_i`` → ``flows.{2i}``,
``res_i_j`` → ``resblocks.{i·n_kernels + j}``, ``conv1_u`` → ``convs1.u`` (and
ResBlock2's ``conv_u`` → ``convs.u``), and
the variance predictor's ``conv_1`` / ``ln_1`` / ``linear`` →
``conv_layer.conv_1.conv`` / ``conv_layer.layer_norm_1`` / ``linear_layer``.
Any flax leaf left over, port key left empty or shape that disagrees
raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LIST_PREFIXES = {
    "attn_": "attn_layers.",
    "norm1_": "norm_layers_1.",
    "norm2_": "norm_layers_2.",
    "ffn_": "ffn_layers.",
    "in_": "in_layers.",
    "res_skip_": "res_skip_layers.",
    "up_": "ups.",
    "conv1_": "convs1.",
    "conv2_": "convs2.",
}


def port_key(path: Tuple[str, ...], n_resblock_kernels: int) -> str:
    """Flax parameter path → the port's (the reference's) state-dict key."""
    in_variance = "predictor" in path
    segs = []
    for seg in path[:-1]:
        head, _, tail = seg.rpartition("_")
        if seg.startswith("couplings_") and tail.isdigit():
            segs.append(f"flows.{2 * int(tail)}")
        elif seg.startswith("res_") and head[4:].isdigit() and tail.isdigit():
            segs.append(f"resblocks.{int(head[4:]) * n_resblock_kernels + int(tail)}")
        elif (seg.startswith("conv_") and tail.isdigit() and segs
              and segs[-1].startswith("resblocks.")):
            segs.append(f"convs.{tail}")
        elif in_variance and seg in ("conv_1", "conv_2"):
            segs.append(f"conv_layer.{seg}.conv")
        elif in_variance and seg in ("ln_1", "ln_2"):
            segs.append(f"conv_layer.layer_norm_{seg[-1]}")
        elif in_variance and seg == "linear":
            segs.append("linear_layer")
        elif tail.isdigit() and head + "_" in _LIST_PREFIXES:
            segs.append(_LIST_PREFIXES[head + "_"] + tail)
        else:
            segs.append(seg)
    leaf = path[-1]
    if leaf in ("kernel", "embedding"):
        leaf = "weight"
    elif leaf in ("v", "g"):
        leaf = "weight_" + leaf
    elif in_variance and leaf in ("gamma", "beta"):
        leaf = "weight" if leaf == "gamma" else "bias"
    return ".".join(segs + [leaf])


def port_tensor(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    """Flax array → the port's layout for the same parameter."""
    leaf = path[-1]
    transposed = any(s.startswith("up_") and s[3:].isdigit() for s in path)
    if leaf == "kernel":
        return a.transpose(2, 1, 0) if a.ndim == 3 else a.T
    if leaf == "v":
        return a[::-1].transpose(1, 2, 0) if transposed else a.transpose(2, 1, 0)
    if leaf == "g":
        return a.reshape(-1, 1, 1)
    return a


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       n_resblock_kernels: int = 3) -> Dict[str, torch.Tensor]:
    """``{"enc_p/encoder/attn_0/conv_q/kernel": array, ...}`` → state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, a in flat.items():
        path = tuple(name.split("/"))
        key = port_key(path, n_resblock_kernels)
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(
            port_tensor(path, np.asarray(a, np.float32))))
    return out


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                     n_resblock_kernels: int = 3) -> nn.Module:
    """Copy a flat flax tree into ``model``; raises on any leaf left over,
    any port parameter left empty and any shape mismatch."""
    sd = flax_to_state_dict(flat, n_resblock_kernels)
    own = model.state_dict()
    extra = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    bad = [f"{k}: flax {tuple(sd[k].shape)} vs port {tuple(own[k].shape)}"
           for k in sorted(set(sd) & set(own)) if sd[k].shape != own[k].shape]
    if extra or missing or bad:
        raise ValueError(
            f"flax tree does not fit the model: unmapped flax leaves {extra[:8]}, "
            f"unfilled port keys {missing[:8]}, shape mismatches {bad[:8]}")
    model.load_state_dict(sd)
    return model
