"""The trainer's mesh (``vispeech_tpu/parallel/mesh.py``): the data axis
and the model axis.

The JAX package builds a ('data', 'model') mesh and GSPMD inserts the
collectives.  Here each process holds one device, launched by torchrun, and
a world of ``data × model`` ranks is laid out as JAX's
``devices.reshape(data, model)``: rank = data_rank · model + model_rank, so
a model group is ``model`` consecutive ranks (one node's NVLink).  The
ranks of a model group see the same batch and the same random streams and
each holds its slice of the parameters ``sharding.py`` shards (tensor
parallelism, ``tensor.py``'s collectives over ``model_group``); the
training step averages its gradients over ``data_group``, the ranks that
hold the same slice, after it averages the replicated ones over
``model_group``, so that a group's copies never drift apart: NCCL for a
CUDA device, gloo for the CPU.
``batch_size`` is per data rank, as in the JAX package, so the global
batch is ``batch_size × data``.  A gloo side group over the whole world
carries what the host decides (the stop flag, the random generators'
states for a checkpoint), so no device sync is added to a step for it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from vispeech_tpu_torch.ops.policy import resolve_device
from vispeech_tpu_torch.parallel.tensor import ModelShard

# rank r's random streams are seeded ``seed + RANK_SEED_STRIDE · r``: far
# apart, so that no rank's stream is another's ``seed + 1`` stream
RANK_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place on the mesh.  ``side_group`` None: a world of
    one without a launcher.  ``data_group`` joins the ranks of this rank's
    model rank, ``model_group`` (None at a model size of 1) those of its
    data rank.  A data axis of one runs no collective on the device,
    launcher or not: its mean and sum are the rank's own values."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    side_group: Optional[dist.ProcessGroup] = None
    model_size: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        """``data_group``, by the name the data axis's group had before the
        model axis."""
        return self.data_group

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def is_main(self) -> bool:
        """Whether this process logs, evaluates and writes (JAX's
        ``jax.process_index() == 0``)."""
        return self.rank == 0

    @property
    def model_shard(self) -> ModelShard:
        """This rank's place in its model group (``parallel/tensor.py``)."""
        return ModelShard(self.model_group, self.model_rank, self.model_size)

    def seed(self, seed: int) -> int:
        """This rank's seed for a stream seeded ``seed`` on rank 0: one per
        data rank, so a model group draws the same numbers."""
        return seed + RANK_SEED_STRIDE * self.data_rank

    def average_grads_(self, params: Sequence[torch.Tensor],
                       sliced: Sequence[torch.Tensor] = (),
                       partial: Sequence[torch.Tensor] = ()) -> None:
        """Each parameter's ``.grad`` ← its mean over the data axis
        (``all_reduce_mean_``); nothing on a world of one.  With a model
        axis, first one all-reduce over the model group averages the
        gradients of the replicated parameters (neither ``sliced``, a
        rank's slice of a sharded one, nor ``partial``) and sums those of
        ``partial`` (whole parameters that each rank reads through its
        slice, so holds a part of the gradient of).  The ranks of a group
        compute a replicated gradient alike only up to rounding (cuDNN's
        and the scatters' backward need not be deterministic); their mean
        hands every rank the same bits, so the group's copies of a
        replicated parameter stay equal, as ``check_replicas`` asserts."""
        if self.model_size > 1:
            own = {id(p) for p in sliced}
            all_reduce_mean_([p for p in params if id(p) not in own], self.model_group,
                             self.model_size, partial)
        if self.data_size > 1:
            all_reduce_mean_(params, self.data_group, self.data_size)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data axis (a new tensor, no grad)."""
        t = t.detach().clone()
        if self.data_size > 1:
            dist.all_reduce(t, group=self.data_group)
        return t

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each scalar's mean over the data axis, by one all-reduce."""
        if self.data_size == 1:
            return metrics
        keys = sorted(metrics)
        flat = self.sum(torch.stack([metrics[k].float() for k in keys])) / self.data_size
        return dict(zip(keys, flat))

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (over the gloo side group)."""
        if self.side_group is None or self.world_size == 1:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.side_group)
        return bool(t.item())

    def barrier(self) -> None:
        """Wait until every rank is here (over the gloo side group)."""
        if self.side_group is not None:
            dist.barrier(group=self.side_group)

    def gather(self, obj) -> List:
        """Every rank's ``obj`` (picklable, CPU tensors), in rank order."""
        if self.side_group is None:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.side_group)
        return out

    def check_replicas(self, params: Dict[str, torch.Tensor]) -> None:
        """Raise unless every model group's ranks hold the same bits in
        ``params`` (the replicated parameters): one fingerprint a tensor,
        gathered over the side group, every group checked on every rank, so
        that all of them raise together.  Nothing at a model size of 1."""
        if self.model_size == 1:
            return
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        prints = torch.stack([p.detach().reshape(-1).view(ints[p.element_size()])
                              .sum(dtype=torch.int64) for p in params.values()]).cpu()
        every = self.gather(prints)
        names = list(params)
        for d in range(self.data_size):
            group = every[d * self.model_size:(d + 1) * self.model_size]
            apart = [names[i] for i in range(len(names)) if any(g[i] != group[0][i]
                                                                for g in group)]
            if apart:
                raise RuntimeError(f"data rank {d}'s model group holds {len(apart)} replicated "
                                   f"parameters that differ between its ranks: {apart[:5]}")

    def close(self) -> None:
        """Tear down the process groups this mesh's ``make_mesh`` joined."""
        if self.side_group is not None and dist.is_initialized():
            dist.destroy_process_group()


def all_reduce_mean_(params: Sequence[torch.Tensor], group: dist.ProcessGroup,
                     world_size: int, partial: Sequence[torch.Tensor] = ()) -> None:
    """Each parameter's ``.grad`` ← its sum over ``group`` / ``world_size``
    (those in ``partial``: the sum alone), by one all-reduce of the
    gradients flattened in the given order, ``partial`` last (grads that
    are None are skipped: frozen and unused parameters have the same
    pattern on every rank).  The grads become views of that buffer."""
    last = {id(p) for p in partial}
    params = [p for p in params if p.grad is not None and id(p) not in last] + \
        [p for p in params if p.grad is not None and id(p) in last]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    n = sum(p.numel() for p in params if id(p) not in last)
    (flat if n == flat.numel() else flat[:n]).div_(world_size)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def make_mesh(data: Optional[int] = None, model: int = 1, device: Optional[str] = None,
              init_method: str = "env://", backend: Optional[str] = None) -> Mesh:
    """This process's ``Mesh``.  Under a launcher (torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``), or when a process group is already
    initialized, it joins a mesh of ``world / model`` data ranks ×
    ``model`` model ranks: NCCL for a CUDA device (``cuda:LOCAL_RANK``,
    made current), gloo for ``device="cpu"`` (``backend`` names another
    explicitly: gloo on CUDA tensors runs two ranks on one card), a gloo
    side group, and at ``model`` > 1 each data group and model group.  With
    neither it returns a world of one.  ``device`` None means CUDA.
    ``data``, when given, must equal ``world / model``.  Raises, never falls
    back: ``model`` not dividing the world, ``model`` > 1 without a
    launcher, CUDA with no GPU, NCCL unavailable for CUDA, a group already
    initialized with another backend."""
    if model < 1:
        raise ValueError(f"model={model}: the model axis needs at least one rank")
    launched = "WORLD_SIZE" in os.environ or dist.is_initialized()
    if not launched:
        if model != 1:
            raise ValueError(f"model={model} needs a launcher (torchrun): this is one process")
        if data not in (None, 1):
            raise ValueError(f"data={data} needs a launcher (torchrun): this is one process")
        return Mesh(device=resolve_device(device))
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = int(os.environ.get("RANK", 0)), int(os.environ["WORLD_SIZE"])
    if world % model:
        raise ValueError(f"model={model} does not divide the world size {world}")
    if data not in (None, world // model):
        raise ValueError(f"data={data} × model={model} != the world size {world}")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("the CUDA data axis needs NCCL, and this torch has none")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                device_id=dev if backend == "nccl" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, and {dev} needs "
                           f"{backend}")
    side = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    if model == 1:
        return Mesh(rank=rank, world_size=world, device=dev, side_group=side,
                    data_group=dist.group.WORLD)
    # every rank creates every group, in the same order
    data_groups = [dist.new_group(list(range(m, world, model))) for m in range(model)]
    model_groups = [dist.new_group(list(range(d * model, (d + 1) * model)))
                    for d in range(world // model)]
    return Mesh(rank=rank, world_size=world, device=dev, side_group=side, model_size=model,
                data_group=data_groups[rank % model],
                model_group=model_groups[rank // model])
