"""Carry flax parameters (the JAX package's trees, and the arrays of its
``ckpt_*.npz`` checkpoints) onto the port's state dicts: the generator's
``params_g``, the discriminators' ``params_d`` and the AdamW moments
``mu`` / ``nu`` of both optimizers (``load_jax_checkpoint``).

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
Discriminators: ``disc_s`` → ``discriminators.0``, ``disc_p{p}`` →
``discriminators.{1 + index of p}``, ``conv_i`` → ``convs.i``; a Conv2d
``v`` [kh, kw, cin, cout] → ``weight_v`` [cout, cin, kh, kw].
Any flax leaf left over, port key left empty or shape that disagrees
raises.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Tuple

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


PERIODS = (2, 3, 5, 7, 11)


def port_d_key(path: Tuple[str, ...]) -> str:
    """Discriminator flax path (``disc_p2/conv_0/v``) → state-dict key."""
    disc, conv, leaf = path
    idx = 0 if disc == "disc_s" else 1 + PERIODS.index(int(disc[len("disc_p"):]))
    name = "conv_post" if conv == "conv_post" else "convs." + conv.rpartition("_")[2]
    return f"discriminators.{idx}.{name}." + {"v": "weight_v", "g": "weight_g"}.get(leaf, leaf)


def port_d_tensor(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    leaf, conv2d = path[-1], path[0] != "disc_s"
    if leaf == "v":
        return a.transpose(3, 2, 0, 1) if conv2d else a.transpose(2, 1, 0)
    if leaf == "g":
        return a.reshape((-1, 1, 1, 1) if conv2d else (-1, 1, 1))
    return a


def flax_to_state_dict(flat: Mapping[str, np.ndarray], n_resblock_kernels: int = 3,
                       discriminator: bool = False) -> Dict[str, torch.Tensor]:
    """``{"enc_p/encoder/attn_0/conv_q/kernel": array, ...}`` → state dict
    (of the generator, or with ``discriminator`` of the discriminators)."""
    out: Dict[str, torch.Tensor] = {}
    for name, a in flat.items():
        path = tuple(name.split("/"))
        if discriminator:
            key, arr = port_d_key(path), port_d_tensor(path, np.asarray(a, np.float32))
        else:
            key = port_key(path, n_resblock_kernels)
            arr = port_tensor(path, np.asarray(a, np.float32))
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _fitted(model: nn.Module, flat, n_resblock_kernels, discriminator, what="state_dict",
            plan=None):
    """The converted tree, after checking it fills ``model`` exactly (cut
    to this rank's slices by ``plan``, a ``parallel.sharding.ShardPlan``)."""
    sd = flax_to_state_dict(flat, n_resblock_kernels, discriminator)
    if plan is not None:
        sd = plan.own_state(sd)
    own = dict(model.named_parameters()) if what == "parameters" else model.state_dict()
    extra = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    bad = [f"{k}: flax {tuple(sd[k].shape)} vs port {tuple(own[k].shape)}"
           for k in sorted(set(sd) & set(own)) if sd[k].shape != own[k].shape]
    if extra or missing or bad:
        raise ValueError(
            f"flax tree does not fit the model: unmapped flax leaves {extra[:8]}, "
            f"unfilled port keys {missing[:8]}, shape mismatches {bad[:8]}")
    return sd


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                     n_resblock_kernels: int = 3, discriminator: bool = False,
                     plan=None) -> nn.Module:
    """Copy a flat flax tree into ``model`` (a sharded one's slices with its
    ``plan``); raises on any leaf left over, any port parameter left empty
    and any shape mismatch."""
    model.load_state_dict(_fitted(model, flat, n_resblock_kernels, discriminator,
                                  plan=plan))
    return model


_NPZ_RE = re.compile(r"^ckpt_(\d+)\.npz$")
_MOMENT_RE = re.compile(r"^opt_state_([gd])/((?:\d+/)*)(mu|nu)/(.+)$")


def load_jax_checkpoint(base_dir: str, model_g: nn.Module, model_d: nn.Module,
                        opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer,
                        n_resblock_kernels: int = 3, plan_g=None) -> Optional[int]:
    """Continue the JAX package's newest ``ckpt_*.npz`` in ``base_dir``:
    both networks' parameters and both AdamW optimizers' moments and step
    counts (the key paths ``vispeech_tpu/utils/checkpoint.py:61``
    ``flatten_state`` writes); a generator sharded on the model axis takes
    its slices (``plan_g``, its ``ShardPlan``).  → its step, or None when there is none.
    Raises on any array left over or any parameter or moment left empty."""
    steps = sorted(int(m.group(1)) for m in map(_NPZ_RE.match, os.listdir(base_dir)) if m) \
        if os.path.isdir(base_dir) else []
    if not steps:
        return None
    stored = np.load(os.path.join(base_dir, f"ckpt_{steps[-1]}.npz"))
    params = {"g": {}, "d": {}}
    moments = {(net, kind): {} for net in "gd" for kind in ("mu", "nu")}
    counts, used = {}, {"step", "rng"}
    for key in stored.files:
        for net in "gd":
            prefix = f"params_{net}/params/"
            if key.startswith(prefix):
                params[net][key[len(prefix):]] = stored[key]
                used.add(key)
        m = _MOMENT_RE.match(key)
        if m:
            net, chain, kind, path = m.groups()
            moments[(net, kind)][path] = stored[key]
            counts[net] = f"opt_state_{net}/{chain}count"
            used.add(key)
    used.update(counts.values())
    leftover = sorted(k for k in stored.files if k not in used
                      and not re.match(r"^opt_state_[gd]/(\d+/)*count$", k))
    if leftover:
        raise ValueError(f"JAX checkpoint arrays the port does not map: {leftover[:8]}")
    for net, model, opt, plan in (("g", model_g, opt_g, plan_g), ("d", model_d, opt_d, None)):
        disc = net == "d"
        load_flax_params(model, params[net], n_resblock_kernels, disc, plan)
        if net not in counts:
            raise ValueError(f"JAX checkpoint has no AdamW moments for params_{net}")
        mu = _fitted(model, moments[(net, "mu")], n_resblock_kernels, disc, "parameters", plan)
        nu = _fitted(model, moments[(net, "nu")], n_resblock_kernels, disc, "parameters", plan)
        count = float(stored[counts[net]])
        for name, p in model.named_parameters():
            opt.state[p] = {"step": torch.tensor(count),
                            "exp_avg": mu[name].to(p.device, p.dtype),
                            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    return int(stored["step"])
