"""The trainer's data axis (``vispeech_tpu/parallel/mesh.py``'s 'data').

The JAX package builds a ('data', 'model') mesh and GSPMD inserts the
gradient all-reduce.  Here each process holds one replica on one device,
launched by torchrun, and the training step all-reduces its gradients over
a ``torch.distributed`` group: NCCL for a CUDA device, gloo for the CPU.
``batch_size`` is per device, as in the JAX package, so the global batch
is ``batch_size × world_size``.  A gloo side group carries what the host
decides (the stop flag, the random generators' states for a checkpoint),
so no device sync is added to a step for it.

The model axis (``param_shardings``, tensor parallelism) is ``ROADMAP.md``
queue 1 item 7b and is refused.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from vispeech_tpu_torch.ops.policy import resolve_device

# rank r's random streams are seeded ``seed + RANK_SEED_STRIDE · r``: far
# apart, so that no rank's stream is another's ``seed + 1`` stream
RANK_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place on the data axis.  ``group`` None: a world of
    one without a launcher.  A world of one runs no collective on the
    device, launcher or not: its mean and sum are the rank's own values."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[dist.ProcessGroup] = None
    side_group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        """Whether this process logs, evaluates and writes (JAX's
        ``jax.process_index() == 0``)."""
        return self.rank == 0

    def seed(self, seed: int) -> int:
        """This rank's seed for a stream seeded ``seed`` on rank 0."""
        return seed + RANK_SEED_STRIDE * self.rank

    def average_grads_(self, params: Sequence[torch.Tensor]) -> None:
        """Each parameter's ``.grad`` ← its mean over the ranks
        (``all_reduce_mean_``); nothing at a world of one."""
        if self.world_size > 1:
            all_reduce_mean_(params, self.group, self.world_size)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor, no grad)."""
        t = t.detach().clone()
        if self.world_size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each scalar's mean over the ranks, by one all-reduce."""
        if self.world_size == 1:
            return metrics
        keys = sorted(metrics)
        flat = self.sum(torch.stack([metrics[k].float() for k in keys])) / self.world_size
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

    def close(self) -> None:
        """Tear down the process group this mesh's ``make_mesh`` joined."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()


def all_reduce_mean_(params: Sequence[torch.Tensor], group: dist.ProcessGroup,
                     world_size: int) -> None:
    """Each parameter's ``.grad`` ← its sum over ``group`` / ``world_size``,
    by one all-reduce of the gradients flattened in the given order (grads
    that are None are skipped: frozen and unused parameters have the same
    pattern on every rank).  The grads become views of that buffer."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat.div_(world_size)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def make_mesh(data: Optional[int] = None, model: int = 1, device: Optional[str] = None,
              init_method: str = "env://") -> Mesh:
    """This process's ``Mesh``.  Under a launcher (torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``), or when a process group is already
    initialized, it joins the data axis: NCCL for a CUDA device
    (``cuda:LOCAL_RANK``, made current), gloo for ``device="cpu"``, and a
    gloo side group.  With neither it returns a world of one.  ``device``
    None means CUDA.  ``data``, when given, must equal the world size.
    Raises, never falls back: CUDA with no GPU, NCCL unavailable for CUDA,
    a group already initialized with another backend, ``model`` > 1."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: the model axis (tensor parallelism) is not ported yet: "
            "ROADMAP.md queue 1 item 7b")
    dev = resolve_device(device)
    launched = "WORLD_SIZE" in os.environ or dist.is_initialized()
    if not launched:
        if data not in (None, 1):
            raise ValueError(f"data={data} needs a launcher (torchrun): this is one process")
        return Mesh(device=dev)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = int(os.environ.get("RANK", 0)), int(os.environ["WORLD_SIZE"])
    if data not in (None, world):
        raise ValueError(f"data={data} != the world size {world}")
    backend = "gloo"
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("the CUDA data axis needs NCCL, and this torch has none")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                device_id=dev if dev.type == "cuda" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, and {dev} needs "
                           f"{backend}")
    side = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    return Mesh(rank=rank, world_size=world, device=dev, group=dist.group.WORLD,
                side_group=side)
