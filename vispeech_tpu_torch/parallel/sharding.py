"""Which parameters the model axis shards (``vispeech_tpu/parallel/mesh.py``'s
``param_shardings``), over the port's state-dict names, and sharding a
built model in place.

The JAX package shards the output-channel (last) dim of each flax leaf
whose path matches one of four patterns, when that dim divides by the model
size and is at least 64 (``_MIN_SHARD_SIZE``); everything else is
replicated.  The same leaves here, through ``utils/jax_weights.py``'s key
map: the decoder's ``conv_pre.weight`` (dim 0 of [cout, cin, k]), its
``ups.i.weight_v`` (dim 1 of [cin, cout, k]) and its ResBlocks'
``convs{1,2}.j.weight_v`` / ``convs.j.weight_v`` (dim 0), and the WaveNet
input convs of the posterior encoder and of the couplings,
``enc_q.enc.in_layers.l.weight_v`` and ``flow.flows.2i.enc.in_layers.l.
weight_v`` (dim 0).  The decoder's convs run column-parallel; the WaveNet
input convs gather their weight for kernels E and B.

``shard_model_`` runs after ``random_init_`` (every rank draws the whole
model from the same seed and keeps its slice) or after a whole state is
loaded.  Its ``ShardPlan`` slices whole states for loading and gathers a
rank's state whole for a checkpoint.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vispeech_tpu_torch.ops.layers import Conv1d, WNConv1d, WNConvTranspose1d
from vispeech_tpu_torch.parallel.tensor import ModelShard

MIN_SHARD_SIZE = 64

# (state-dict name, dim of the output channels, column-parallel); the first
# that matches decides
RULES = (
    (re.compile(r"dec\.conv_pre\.weight"), 0, True),
    (re.compile(r"dec\.ups\.\d+\.weight_v"), 1, True),
    (re.compile(r"dec\.resblocks\.\d+\.convs[12]?\.\d+\.weight_v"), 0, True),
    (re.compile(r"enc_q\.enc\.in_layers\.\d+\.weight_v"), 0, False),
    (re.compile(r"flow\.flows\.\d+\.enc\.in_layers\.\d+\.weight_v"), 0, False),
)


def shard_rule(name: str, shape, model_size: int) -> Optional[Tuple[int, bool]]:
    """(dim, column-parallel) of the parameter ``name`` of ``shape`` on a
    model axis of ``model_size``, or None: replicated."""
    if model_size <= 1:
        return None
    for pattern, dim, column in RULES:
        if pattern.fullmatch(name):
            size = shape[dim]
            if size % model_size == 0 and size >= MIN_SHARD_SIZE:
                return dim, column
            return None
    return None


@dataclasses.dataclass
class ShardPlan:
    """A model's sharded parameters: ``dims`` (name → the dim it is sliced
    on) and ``partial`` (whole parameters that a column-parallel conv reads
    through its slice: each rank's gradient is a part, summed over the
    group by ``TrainStep``)."""

    shard: ModelShard
    dims: Dict[str, int]
    partial: Tuple[str, ...]

    def own(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``t`` of parameter ``name``
        (``t`` itself when ``name`` is not sharded)."""
        if name not in self.dims:
            return t
        return self.shard.own(t, self.dims[name]).clone()

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ``t`` of parameter ``name``, gathered whole over the
        model group when ``name`` is sharded: a collective, which every
        rank of the group calls in the same order."""
        if name not in self.dims:
            return t
        with torch.no_grad():
            return self.shard.gather(t, self.dims[name])

    def own_state(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.own(k, v) for k, v in state.items()}

    def whole_state(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.whole(k, v) for k, v in state.items()}


_LAYERS = (Conv1d, WNConv1d, WNConvTranspose1d)


def shard_model_(model: nn.Module, shard: ModelShard, require_match: bool = False
                 ) -> Optional[ShardPlan]:
    """Keep ``shard``'s slice of each parameter the rules shard, in place,
    and set ``tp`` on its layer.  → the plan (``TrainStep``'s ``plan``),
    None at a model size of 1.  ``require_match`` (the generator): raise
    when nothing matched, as a renamed module must not fall back to
    replication silently."""
    if shard.size <= 1:
        return None
    dims, partial = {}, []
    for name, p in list(model.named_parameters()):
        rule = shard_rule(name, p.shape, shard.size)
        if rule is None:
            continue
        dim, column = rule
        owner, _, leaf = name.rpartition(".")
        layer = model.get_submodule(owner)
        if not isinstance(layer, _LAYERS):
            raise TypeError(f"{name}: a {type(layer).__name__} has no sharded form")
        with torch.no_grad():
            setattr(layer, leaf, nn.Parameter(shard.own(p, dim).clone(),
                                              requires_grad=p.requires_grad))
        layer.tp = dataclasses.replace(shard, column=column)
        dims[name] = dim
        if column:
            partial += [f"{owner}.{k}" for k in ("weight_g", "bias")
                        if getattr(layer, k, None) is not None]
    if require_match and not dims:
        raise ValueError(
            "a model axis was asked for, but no parameter matched the sharding rules: "
            f"were modules renamed? (rules: {[r[0].pattern for r in RULES]})")
    return ShardPlan(shard, dims, tuple(partial))
