"""Collectives façade of the port: the process group and the
collectives that ring sequence parallelism and ZeRO over a data axis need.

Port of the subset of ``deepspeed_tpu/comm/comm.py`` that those paths
read: ``init_distributed`` (the caller names the backend, ``"nccl"`` or
``"gloo"``; nothing switches it), ``all_reduce``, ``all_gather`` (tiled,
as ``lax.all_gather(..., tiled=True)``; also asynchronous, so a ZeRO-3
prefetch can be issued ahead of its use), ``reduce_scatter`` (the sum
``lax.psum_scatter(..., tiled=True)`` keeps one slice of) and
``ring_rotate``, the counterpart of ``sequence/ring.py``
``_rotate_together`` (one ``lax.ppermute`` of every traveling buffer to the
next shard).

Gloo moves CPU tensors and has no CUDA path of its own for them, so under
gloo a CUDA tensor is staged through pinned host memory, explicitly, for
every collective (one code path); every computation stays on the card.
Under NCCL the CUDA tensors go as they are, in stream order.  A failed
collective raises.

Each collective runs inside a ``torch.profiler.record_function`` range
(``comm.all_reduce``, ``comm.all_gather``, ``comm.reduce_scatter``,
``comm.ring_rotate``), so a profiled step shows the host time spent in it.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

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


def _stage_in(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """``t`` as the buffer a collective reads: a pinned host copy of a CUDA
    tensor under gloo (the copy waits for the kernels queued before it),
    else ``t`` itself."""
    if staged and t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _empty_like_staged(shape, like: torch.Tensor, staged: bool):
    pinned = staged and like.device.type == "cuda"
    return torch.empty(shape, dtype=like.dtype, pin_memory=pinned,
                       device="cpu" if pinned else like.device)


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place; returns it."""
    with record_function("comm.all_reduce"):
        buf = _stage_in(tensor, _staged(group))
        dist.all_reduce(buf, group=group)
        if buf is not tensor:
            tensor.copy_(buf)
    return tensor


class Pending:
    """An issued collective: ``wait()`` blocks until it is done and returns
    its result on the input's device.  Waits happen in the order the caller
    chooses; each collective keeps the order in which it was issued on
    every rank."""

    def __init__(self, work, finish: Callable[[], torch.Tensor]):
        self._work, self._finish, self._out = work, finish, None

    def wait(self) -> torch.Tensor:
        if self._out is None:
            with record_function("comm.all_gather"):
                self._complete()
        return self._out

    def _complete(self) -> None:
        if self._out is None:
            self._work.wait()
            self._out = self._finish()


def all_gather(shard: torch.Tensor, dim: int = 0, group=None,
               async_op: bool = False):
    """Concatenate every rank's ``shard`` along ``dim`` in rank order (the
    tiled all-gather); returns the full tensor on the shard's device, or a
    :class:`Pending` whose ``wait()`` returns it when ``async_op``.  A
    ``dim`` other than 0 is moved to the front and back: the shard is
    copied once to make that dim leading and contiguous, and the result
    once more to lay it out as the caller's tensor."""
    with record_function("comm.all_gather"):
        staged = _staged(group)
        world = dist.get_world_size(group)
        dev = shard.device
        lead = shard.movedim(dim, 0).contiguous()   # a copy when dim != 0
        src = _stage_in(lead, staged)
        out = _empty_like_staged((world * lead.shape[0],) + tuple(lead.shape[1:]),
                                 lead, staged)
        work = dist.all_gather_into_tensor(out, src, group=group,
                                           async_op=True)

        def finish():
            full = out.to(dev, non_blocking=True) if out.device != dev else out
            return full.movedim(0, dim).contiguous()   # a copy when dim != 0

        pending = Pending(work, finish)
        if async_op:
            return pending
        pending._complete()
        return pending._out


def reduce_scatter(full: torch.Tensor, dim: int = 0, group=None
                   ) -> torch.Tensor:
    """Sum ``full`` over ``group`` and keep this rank's slice along ``dim``
    (the rank-th of ``world`` equal slices); returns it on ``full``'s
    device.  ``full.shape[dim]`` must divide by the group's size.  A ``dim``
    other than 0 is moved to the front (one copy of ``full``) and the slice
    back (one copy of the slice)."""
    with record_function("comm.reduce_scatter"):
        world = dist.get_world_size(group)
        if full.shape[dim] % world:
            raise ValueError(f"reduce_scatter: dim {dim} of size "
                             f"{full.shape[dim]} does not divide by {world}")
        staged = _staged(group)
        dev = full.device
        lead = full.movedim(dim, 0).contiguous()   # a copy when dim != 0
        src = _stage_in(lead, staged)
        out = _empty_like_staged((lead.shape[0] // world,) + tuple(lead.shape[1:]),
                                 lead, staged)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
        if out.device != dev:
            out = out.to(dev, non_blocking=True)
        return out.movedim(0, dim).contiguous()    # a copy when dim != 0


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
        sends = [_stage_in(t.contiguous(), staged) for t in tensors]
        recvs = [_empty_like_staged(t.shape, t, staged) for t in tensors]
        ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends]
        ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(t.device, non_blocking=True) if r.device != t.device
                else r for r, t in zip(recvs, tensors)]
