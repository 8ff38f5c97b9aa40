"""Collectives façade of the port: the process group and the two
collectives ring sequence parallelism needs.

Port of the subset of ``deepspeed_tpu/comm/comm.py`` that the ring path
reads: ``init_distributed`` (the caller names the backend, ``"nccl"`` or
``"gloo"``; nothing switches it), ``all_reduce`` and ``ring_rotate``, the
counterpart of ``sequence/ring.py`` ``_rotate_together`` (one
``lax.ppermute`` of every traveling buffer to the next shard).

Gloo moves CPU tensors through its point-to-point calls and has no CUDA
path of its own for them, so under gloo a CUDA tensor is staged through
pinned host memory, explicitly, for both collectives (one code path, the
same for ``all_reduce``); every computation stays on the card.  Under
NCCL the CUDA tensors go as they are, in stream order.  A failed
collective raises.

Each collective runs inside a ``torch.profiler.record_function`` range
(``comm.all_reduce``, ``comm.ring_rotate``), so a profiled step shows the
host time spent in it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, rank: int, world_size: int,
                     init_method: str, device=None) -> None:
    """Initialise the default process group.  ``backend``: ``"nccl"``
    (each rank on a card of its own) or ``"gloo"`` (CPU tensors, or ranks
    sharing one card); ``init_method``: the rendezvous
    (``file://<path>`` or ``tcp://localhost:<port>``); ``device``: this
    rank's CUDA device, made current, or None."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place; returns it."""
    with record_function("comm.all_reduce"):
        if tensor.device.type == "cuda" and _staged(group):
            host = torch.empty(tensor.shape, dtype=tensor.dtype,
                               pin_memory=True)
            host.copy_(tensor)
            dist.all_reduce(host, group=group)
            tensor.copy_(host)
        else:
            dist.all_reduce(tensor, group=group)
    return tensor


def ring_rotate(tensors: Sequence[torch.Tensor], group=None
                ) -> List[torch.Tensor]:
    """One hop of the ring: send each tensor to the next rank of ``group``
    and receive the previous rank's, all in one ``batch_isend_irecv``;
    returns the received tensors (new buffers, shapes and dtypes of the
    sent ones, on their devices)."""
    with record_function("comm.ring_rotate"):
        size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        nxt = dist.get_global_rank(group, (rank + 1) % size) \
            if group is not None else (rank + 1) % size
        prv = dist.get_global_rank(group, (rank - 1) % size) \
            if group is not None else (rank - 1) % size
        staged = _staged(group)
        sends, recvs = [], []
        for t in tensors:
            t = t.contiguous()
            if staged and t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t)
                sends.append(host)
                recvs.append(torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True))
            else:
                sends.append(t)
                recvs.append(torch.empty_like(t))
        ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends]
        ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(t.device, non_blocking=True) if r.device != t.device
                else r for r, t in zip(recvs, tensors)]
