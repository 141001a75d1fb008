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
The causal ``Decoder`` / ``FFT``: ``self_attn_i`` → ``self_attn_layers.i``,
``cross_attn_i`` → ``encdec_attn_layers.i``, ``norm0_i`` → ``norm_layers_0.i``.
The stochastic duration predictor (``sdp``): ``pre_affine`` / ``post_affine``
→ ``flows.0`` / ``post_flows.0`` (``m`` and ``logs`` [2] → [2, 1]),
``flows_conv_i`` / ``post_flows_conv_i`` → ``flows.{2i+1}`` /
``post_flows.{2i+1}``, and in its DDSConvs ``sep_i``, ``pw_i``, ``norm1_i``,
``norm2_i`` → ``convs_sep.i``, ``convs_1x1.i``, ``norms_1.i``, ``norms_2.i``.
Discriminators: ``disc_s`` → ``discriminators.0``, ``disc_p{p}`` →
``discriminators.{1 + index of p}``, ``conv_i`` → ``convs.i``; a Conv2d
``v`` [kh, kw, cin, cout] → ``weight_v`` [cout, cin, kh, kw].
Any flax leaf left over, port key left empty or shape that disagrees
raises, with one exception: a model with the stochastic duration predictor
takes a tree whose ``sdp`` subtree is absent (as the JAX trainer's trees
are: its step never calls it) or holds only what sampling reads (as an
init through ``infer_prior`` leaves it: no ``flows_conv_0``, no
``post_*``).  The parameters left out are zeroed and named in
``model.sdp.unloaded``, so a call that needs them raises.

``load_flax_conformer`` carries a ``models/conformer.py`` tree: its
``params`` and its ``batch_stats`` (the BatchNorms' running statistics).
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
    "self_attn_": "self_attn_layers.",
    "cross_attn_": "encdec_attn_layers.",
    "norm0_": "norm_layers_0.",
}
# the stochastic duration predictor's flows and the layers of its DDSConvs
_SDP_FLOWS = {"pre_affine": "flows.0", "post_affine": "post_flows.0"}
_SDP_FLOW_LISTS = {"flows_conv_": "flows.", "post_flows_conv_": "post_flows."}
_DDS_PREFIXES = {
    "sep_": "convs_sep.",
    "pw_": "convs_1x1.",
    "norm1_": "norms_1.",
    "norm2_": "norms_2.",
}


def port_key(path: Tuple[str, ...], n_resblock_kernels: int) -> str:
    """Flax parameter path → the port's (the reference's) state-dict key."""
    in_variance = "predictor" in path
    in_sdp = path[0] == "sdp"
    segs = []
    for seg in path[:-1]:
        head, _, tail = seg.rpartition("_")
        if in_sdp and seg in _SDP_FLOWS:
            segs.append(_SDP_FLOWS[seg])
        elif in_sdp and tail.isdigit() and head + "_" in _SDP_FLOW_LISTS:
            segs.append(f"{_SDP_FLOW_LISTS[head + '_']}{2 * int(tail) + 1}")
        elif (in_sdp and tail.isdigit() and head + "_" in _DDS_PREFIXES and segs
              and segs[-1] in ("convs", "post_convs")):
            segs.append(_DDS_PREFIXES[head + "_"] + tail)
        elif seg.startswith("couplings_") and tail.isdigit():
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
    if leaf in ("m", "logs"):   # ElementwiseAffine
        return a.reshape(-1, 1)
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


def _sdp_unloaded(model: nn.Module, keys) -> Tuple[str, ...]:
    """The stochastic duration predictor's parameters (names inside
    ``sdp``) that a tree of ``keys`` may leave out: all of them when it
    holds none, those sampling does not read when it holds exactly the
    others, else none."""
    sdp = getattr(model, "sdp", None)
    if sdp is None:
        return ()
    given = {k[len("sdp."):] for k in keys if k.startswith("sdp.")}
    every = [n for n, _ in sdp.named_parameters()]
    if not given:
        return tuple(every)
    if given == set(sdp.reverse_path()):
        return tuple(n for n in every if n not in given)
    return ()


def _fitted(model: nn.Module, flat, n_resblock_kernels, discriminator, what="state_dict",
            plan=None):
    """(The converted tree, the SDP's parameters it leaves out), after
    checking it fills ``model`` exactly but for those (cut to this rank's
    slices by ``plan``, a ``parallel.sharding.ShardPlan``)."""
    sd = flax_to_state_dict(flat, n_resblock_kernels, discriminator)
    if plan is not None:
        sd = plan.own_state(sd)
    own = dict(model.named_parameters()) if what == "parameters" else model.state_dict()
    unloaded = _sdp_unloaded(model, sd)
    _check_fit(sd, own, {"sdp." + n for n in unloaded})
    return sd, unloaded


def _check_fit(sd, own, may_miss=frozenset()) -> None:
    """Raise unless ``sd`` has exactly the keys and shapes of ``own`` (but
    for keys in ``may_miss``)."""
    extra = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd) - set(may_miss))
    bad = [f"{k}: flax {tuple(sd[k].shape)} vs port {tuple(own[k].shape)}"
           for k in sorted(set(sd) & set(own)) if sd[k].shape != own[k].shape]
    if extra or missing or bad:
        raise ValueError(
            f"flax tree does not fit the model: unmapped flax leaves {extra[:8]}, "
            f"unfilled port keys {missing[:8]}, shape mismatches {bad[:8]}")


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                     n_resblock_kernels: int = 3, discriminator: bool = False,
                     plan=None) -> nn.Module:
    """Copy a flat flax tree into ``model`` (a sharded one's slices with its
    ``plan``); raises on any leaf left over, any port parameter left empty
    (but for the SDP's, see the module's docstring) and any shape mismatch."""
    sd, unloaded = _fitted(model, flat, n_resblock_kernels, discriminator, plan=plan)
    own = model.state_dict()
    for name in unloaded:
        sd["sdp." + name] = torch.zeros_like(own["sdp." + name])
    model.load_state_dict(sd)
    if getattr(model, "sdp", None) is not None:
        model.sdp.unloaded = unloaded
    return model


def load_flax_conformer(model: nn.Module, params: Mapping[str, np.ndarray],
                        batch_stats: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a flat ``ConformerEncoder`` tree (``params`` and ``batch_stats``,
    ``{"block_0/ff1/Dense_0/kernel": array, ...}``) into the port's
    ``models/conformer.py`` encoder: ``block_i`` → ``blocks.i``,
    ``LayerNorm_0`` → ``norm``, ``Dense_0`` / ``Dense_1`` → ``linear1`` /
    ``linear2``, ``scale`` → ``weight``, dense kernels [in, out] → [out, in],
    conv kernels [k, cin/groups, cout] → [cout, cin/groups, k], ``mean`` /
    ``var`` → ``running_mean`` / ``running_var``.  Raises on any leaf left
    over, any key left empty and any shape mismatch."""
    names = {"LayerNorm_0": "norm", "Dense_0": "linear1", "Dense_1": "linear2"}
    leaves = {"scale": "weight", "kernel": "weight", "mean": "running_mean",
              "var": "running_var"}
    sd = {}
    for name, a in [*params.items(), *batch_stats.items()]:
        path = name.split("/")
        segs = [f"blocks.{p[len('block_'):]}" if p.startswith("block_") else names.get(p, p)
                for p in path[:-1]]
        a = np.asarray(a, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(2, 1, 0) if a.ndim == 3 else a.T
        sd[".".join(segs + [leaves.get(path[-1], path[-1])])] = torch.from_numpy(
            np.ascontiguousarray(a))
    _check_fit(sd, model.state_dict())
    model.load_state_dict(sd)
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
        mu, _ = _fitted(model, moments[(net, "mu")], n_resblock_kernels, disc, "parameters",
                        plan)
        nu, _ = _fitted(model, moments[(net, "nu")], n_resblock_kernels, disc, "parameters",
                        plan)
        count = float(stored[counts[net]])
        for name, p in model.named_parameters():
            if name not in mu:   # an SDP parameter the tree leaves out: no moments
                continue
            opt.state[p] = {"step": torch.tensor(count),
                            "exp_avg": mu[name].to(p.device, p.dtype),
                            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    return int(stored["step"])
