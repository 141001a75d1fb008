"""Point-to-point transport between ranks: the counterpart of
``jax.lax.ppermute``, which the JAX package's ring attention, overlap-save
vocoder and pipeline use for their neighbour hops (``vispeech_tpu/parallel/
context.py``, ``pipeline.py``).

A ``group`` is a ``torch.distributed`` process group; None is a group of
one (no launcher), which sends nothing.  Ranks are the group's own (0 … P−1).
The route is fixed by the group's backend and the tensor's device, never by
catching a failure:

- NCCL, CUDA tensor: sent device to device;
- gloo, CPU tensor: sent as it is;
- gloo, CUDA tensor: staged through the host (``.cpu()`` → send →
  ``.to(device)``).  gloo's ``send``/``recv`` hand the tensor's data
  pointer to its TCP transport whatever its device: on an H100 a device
  pointer failed the send (``writev``: Bad address) or aborted the process
  (``chip_smoke.py``'s ``--cp`` probe prints what they do), so this module
  stages explicitly.  Two ranks sharing one card (NCCL refuses that) run
  this route;
- anything else (a CPU tensor on NCCL, another backend) raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def staged(device: torch.device, group: dist.ProcessGroup) -> bool:
    """Whether a tensor on ``device`` goes through the host on ``group``
    (gloo and CUDA); raises for a pairing with no route."""
    backend = dist.get_backend(group)
    if device.type == "cuda" and backend in ("nccl", "gloo"):
        return backend == "gloo"
    if device.type == "cpu" and backend == "gloo":
        return False
    raise RuntimeError(f"no point-to-point route for a {device.type} tensor over "
                       f"{backend}: CUDA tensors need NCCL (or gloo, staged through the "
                       f"host), CPU tensors gloo")


class Pending:
    """Sends in flight: ``wait()`` blocks until they have left (their
    buffers, staged copies included, stay referenced until then)."""

    def __init__(self, works: List, keep: Sequence[torch.Tensor] = ()):
        self._works, self._keep = works, list(keep)

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._works, self._keep = [], []


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.cpu() if staged(t.device, group) else t


def isend(t: torch.Tensor, group: dist.ProcessGroup, dst: int, tag: int = 0) -> Pending:
    """Start sending ``t`` to the group's rank ``dst``."""
    buf = _wire(t, group)
    work = dist.isend(buf, dist.get_global_rank(group, dst), group=group, tag=tag)
    return Pending([work], [buf])


def recv(shape, dtype: torch.dtype, device: torch.device, group: dist.ProcessGroup,
         src: int, tag: int = 0) -> torch.Tensor:
    """What the group's rank ``src`` sends, as a new tensor on ``device``."""
    device = torch.device(device)
    buf = torch.empty(shape, dtype=dtype, device="cpu" if staged(device, group) else device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group, tag=tag)
    return buf.to(device)


def shift(t: Tensors, group: Optional[dist.ProcessGroup], offset: int = 1) -> Tensors:
    """Each rank i of ``group`` sends ``t`` (a tensor, or a sequence of them
    in one batch) to rank (i + offset) % P and returns what rank
    (i − offset) % P sent it: ``ppermute`` with the permutation i → i +
    offset.  A group of one, or an offset that is a multiple of P, returns
    ``t`` itself and sends nothing."""
    P = size(group)
    if P == 1 or offset % P == 0:
        return t
    i = rank(group)
    dst = dist.get_global_rank(group, (i + offset) % P)
    src = dist.get_global_rank(group, (i - offset) % P)
    many = not isinstance(t, torch.Tensor)
    ts: Tuple[torch.Tensor, ...] = tuple(t) if many else (t,)
    sends = [_wire(x, group) for x in ts]
    recvs = [torch.empty_like(x) for x in sends]
    # one tag a tensor: gloo matches messages by (peer, tag)
    ops = [dist.P2POp(dist.isend, x, dst, group, tag) for tag, x in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, x, src, group, tag) for tag, x in enumerate(recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = tuple(r.to(x.device) for r, x in zip(recvs, ts))
    return out if many else out[0]
