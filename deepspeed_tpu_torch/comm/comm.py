"""Collectives façade of the port: the process group and the
collectives that ring sequence parallelism and ZeRO over a data axis need.

Port of the subset of ``deepspeed_tpu/comm/comm.py`` that those paths
read: ``init_distributed`` (the caller names the backend, ``"nccl"`` or
``"gloo"``; nothing switches it), ``all_reduce``, ``all_gather`` (tiled,
as ``lax.all_gather(..., tiled=True)``; also asynchronous, so a ZeRO-3
prefetch can be issued ahead of its use), ``reduce_scatter`` (the sum
``lax.psum_scatter(..., tiled=True)`` keeps one slice of), ``all_to_all``
(``lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)``, the
quantized gradient reduction's exchange) and ``ring_rotate``, the
counterpart of ``sequence/ring.py`` ``_rotate_together`` (one
``lax.ppermute`` of every traveling buffer to the next shard).

The gradient reduction goes through flat buckets (``zero_optimization.
reduce_bucket_size``): :func:`plan_buckets` groups tensors in order,
:func:`all_reduce_bucket` sums a bucket in one ``all_reduce`` and
:func:`reduce_scatter_bucket` in one rank-major ``reduce_scatter``
(asynchronous under NCCL on request).  The ZeRO-3 gathers of one layer
travel the same way: :func:`all_gather_bucket` moves several tensors of
any dtypes as the bytes of one rank-major buffer, in one ``all_gather``.
The JAX step is one jitted program in which XLA's combiner merges the
per-leaf collectives; the buckets are the port's merge.

Gloo moves CPU tensors and has no CUDA path of its own for them, so under
gloo a CUDA tensor is staged through pinned host memory, explicitly, for
every collective (one code path); every computation stays on the card.
Gloo's reduce-scatter runs as a ring of point-to-point exchanges
(:func:`_sum_scatter`).
Under NCCL the CUDA tensors go as they are, in stream order (NCCL
creates a group's communicator at its first collective, so a first step
is slower).  A failed collective raises; nothing falls back to gloo.

Each collective runs inside a ``torch.profiler.record_function`` range
(``comm.all_reduce``, ``comm.all_gather``, ``comm.reduce_scatter``,
``comm.all_to_all``, ``comm.ring_rotate``) and, inside it, one named for
its group (``comm.group.<name>``, where the kernels NCCL launches for it
are issued), so a profiled step shows the host time spent in it.  Each
adds one to its entry of :data:`group_calls` when it is issued and the
bytes this rank sends into it to its entry of :data:`group_nbytes`, both
under the group's name (``MeshTopology`` names its groups ``world``,
``inner``, ``outer``, ``batch`` and ``seq`` with :func:`name_group`);
:func:`calls` and :func:`nbytes` sum them over the groups.  A caller that
moves a wire of its own through them (the quantized collectives of
``comm/quantized.py``) records it under its own op name too
(:func:`record_bytes`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

BACKENDS = ("nccl", "gloo")
# the kinds of collective (a bucket counts once)
CALL_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
            "ring_rotate")
# collectives issued, and the bytes this rank sent into them, by group
# name, then op name; callers clear them (clear_counts)
group_calls: Dict[str, Dict[str, int]] = {}
group_nbytes: Dict[str, Dict[str, int]] = {}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the names of process groups (the first name a group is given wins)
_group_names: Dict[Any, str] = {}


def name_group(group, name: str) -> None:
    """Name ``group`` for :data:`group_calls` and :data:`group_nbytes`
    (a group that already has a name keeps it)."""
    if group is not None and group not in _group_names:
        _group_names[group] = name


def group_name(group) -> str:
    """``group``'s name (None: the default group's), or ``"other"``."""
    if group is None:
        group = dist.group.WORLD
    return _group_names.get(group, "other")


def clear_counts() -> None:
    """Zero every count (:data:`group_calls`, :data:`group_nbytes`)."""
    group_calls.clear()
    group_nbytes.clear()


def _summed(by_group: Dict[str, Dict[str, int]],
            ops: Sequence[str] = ()) -> Dict[str, int]:
    out = dict.fromkeys(ops, 0)
    for by_op in by_group.values():
        for op, n in by_op.items():
            out[op] = out.get(op, 0) + n
    return out


def calls() -> Dict[str, int]:
    """Collectives issued since the counts were cleared, by kind (every
    kind of :data:`CALL_OPS`, zero or not), over every group."""
    return _summed(group_calls, CALL_OPS)


def nbytes() -> Dict[str, int]:
    """Bytes this rank sent into collectives since the counts were
    cleared, by op name, over every group."""
    return _summed(group_nbytes)


def _range(op: str, group):
    """The profiler ranges of a collective: ``comm.<op>``, and inside it
    ``comm.group.<the group's name>``."""
    stack = contextlib.ExitStack()
    stack.enter_context(record_function(f"comm.{op}"))
    stack.enter_context(record_function(f"comm.group.{group_name(group)}"))
    return stack


def _count(op: str, group, *tensors: Optional[torch.Tensor]) -> None:
    """One collective of kind ``op`` issued over ``group``, sending
    ``tensors``."""
    by_op = group_calls.setdefault(group_name(group), {})
    by_op[op] = by_op.get(op, 0) + 1
    record_bytes(op, *tensors, group=group)


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
    """Tear the default group down; under NCCL, once the card has run
    every collective queued on it."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            torch.cuda.synchronize()
        _group_names.clear()
        dist.destroy_process_group()


def group_size(group=None, world: Optional[int] = None) -> int:
    """The size of ``group``; ``world``, when given, must equal it."""
    size = dist.get_world_size(group)
    if world is not None and world != size:
        raise ValueError(f"world {world} is not the group's size {size}")
    return size


def record_bytes(op: str, *tensors: Optional[torch.Tensor],
                 group=None) -> None:
    """Add the bytes of ``tensors`` (None skipped) to
    ``group_nbytes[<group's name>][op]``."""
    n = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    by_op = group_nbytes.setdefault(group_name(group), {})
    by_op[op] = by_op.get(op, 0) + n


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


def all_reduce(tensor: torch.Tensor, group=None, op: str = "sum"
               ) -> torch.Tensor:
    """Reduce ``tensor`` over ``group`` in place (``op``: ``"sum"`` or
    ``"max"``); returns it."""
    with _range("all_reduce", group):
        _count("all_reduce", group, tensor)
        buf = _stage_in(tensor, _staged(group))
        dist.all_reduce(buf, op=_OPS[op], group=group)
        if buf is not tensor:
            tensor.copy_(buf)
    return tensor


class Pending:
    """An issued collective: ``wait()`` blocks until it is done and returns
    its result on the input's device.  Waits happen in the order the caller
    chooses; each collective keeps the order in which it was issued on
    every rank.  ``keep`` holds the collective's input and output buffers
    until the wait: under NCCL the collective reads and writes them on
    NCCL's stream, so they must not return to the allocator before the
    caller's stream has waited for it."""

    def __init__(self, work, finish: Callable, name: str = "comm.all_gather",
                 keep=()):
        self._work, self._finish, self._out = work, finish, None
        self._name, self._keep = name, keep

    def wait(self):
        if self._out is None:
            with record_function(self._name):
                self._complete()
        return self._out

    def _complete(self) -> None:
        if self._out is None:
            if self._work is not None:
                self._work.wait()
            self._out = self._finish()
            self._work = self._finish = None
            self._keep = ()


def done(result) -> Pending:
    """A :class:`Pending` whose collective has already run."""
    pending = Pending(None, lambda: result)
    pending._complete()
    return pending


def all_gather(shard: torch.Tensor, dim: int = 0, group=None,
               async_op: bool = False):
    """Concatenate every rank's ``shard`` along ``dim`` in rank order (the
    tiled all-gather); returns the full tensor on the shard's device, or a
    :class:`Pending` whose ``wait()`` returns it when ``async_op``.  A
    ``dim`` other than 0 is moved to the front and back: the shard is
    copied once to make that dim leading and contiguous, and the result
    once more to lay it out as the caller's tensor."""
    with _range("all_gather", group):
        _count("all_gather", group, shard)
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

        pending = Pending(work, finish, keep=(src, out))
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
    with _range("reduce_scatter", group):
        _count("reduce_scatter", group, full)
        world = dist.get_world_size(group)
        if full.shape[dim] % world:
            raise ValueError(f"reduce_scatter: dim {dim} of size "
                             f"{full.shape[dim]} does not divide by {world}")
        lead = full.movedim(dim, 0).contiguous()   # a copy when dim != 0
        return _sum_scatter(lead, group).movedim(0, dim).contiguous()


def _sum_scatter(src: torch.Tensor, group, async_op: bool = False):
    """Sum ``src`` over ``group`` and return this rank's block of it, the
    rank-th of ``world`` equal blocks along dim 0, on ``src``'s device (or,
    with ``async_op``, a :class:`Pending` whose ``wait()`` returns it).
    Under NCCL one ``reduce_scatter_tensor``, asynchronous on request.
    Under gloo a ring of point-to-point exchanges, run before this
    returns: ``world - 1`` rounds in which each rank
    sends one partial block to the next rank and adds the one it receives
    to its own (on ``src``'s device; a CUDA block goes through pinned host
    memory): gloo's own reduce_scatter moved a ring step's gradients on
    one card's host at about a third of its all_reduce's rate (PERF.md),
    and this ring sends half of an all-reduce's bytes.  A block is
    summed in ring order from the rank after its owner, wherever it lies
    in the buffer."""
    world = dist.get_world_size(group)
    n = src.shape[0] // world
    if not _staged(group):
        out = torch.empty((n,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        work = dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                          group=group, async_op=async_op)
        if async_op:
            return Pending(work, lambda: out, "comm.reduce_scatter",
                           keep=(src, out))
        return out
    rank = dist.get_rank(group)
    nxt, prv = _ring_peers(group)
    blocks = src.view((world, n) + tuple(src.shape[1:]))
    cur = blocks[(rank - 1) % world]
    for step in range(world - 1):
        send = _stage_in(cur.contiguous(), True)
        recv = _empty_like_staged(cur.shape, cur, True)
        ops = [dist.P2POp(dist.isend, send, nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        # one new block on src's device: the received partial, summed in
        cur = recv.to(src.device, non_blocking=True) if recv.device != \
            src.device else recv
        cur += blocks[(rank - step - 2) % world]
    return done(cur) if async_op else cur


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Split ``x`` into ``world`` equal blocks along dim 0, send block i to
    rank i of ``group`` and return the blocks received, block j from rank
    j, concatenated along dim 0 (a new tensor of ``x``'s shape and dtype on
    its device): ``lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=True)``.  One ``all_to_all_single`` with equal splits; any dtype
    travels (int8 and uint8 payloads too).  Under gloo a CUDA tensor is
    staged through pinned host memory, both ways."""
    with _range("all_to_all", group):
        _count("all_to_all", group, x)
        world = dist.get_world_size(group)
        if x.shape[0] % world:
            raise ValueError(f"all_to_all: dim 0 of size {x.shape[0]} does "
                             f"not divide by {world}")
        staged = _staged(group)
        src = _stage_in(x.contiguous(), staged)
        out = _empty_like_staged(tuple(x.shape), x, staged)
        dist.all_to_all_single(out, src, group=group)
        return out.to(x.device, non_blocking=True) if out.device != x.device \
            else out


def _ring_peers(group) -> Tuple[int, int]:
    """The global ranks of the next and the previous rank of ``group``."""
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if group is None:
        return (rank + 1) % size, (rank - 1) % size
    return (dist.get_global_rank(group, (rank + 1) % size),
            dist.get_global_rank(group, (rank - 1) % size))


def ring_rotate(tensors: Sequence[torch.Tensor], group=None
                ) -> List[torch.Tensor]:
    """One hop of the ring: send each tensor to the next rank of ``group``
    and receive the previous rank's, all in one ``batch_isend_irecv``;
    returns the received tensors (new buffers, shapes and dtypes of the
    sent ones, on their devices).  Point-to-point moves bytes, so any dtype
    travels: the quantized wire's int8 and uint8 (fp8) payloads too."""
    with _range("ring_rotate", group):
        _count("ring_rotate", group, *tensors)
        nxt, prv = _ring_peers(group)
        staged = _staged(group)
        sends = [_stage_in(t.contiguous(), staged) for t in tensors]
        recvs = [_empty_like_staged(t.shape, t, staged) for t in tensors]
        ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends]
        ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(t.device, non_blocking=True) if r.device != t.device
                else r for r, t in zip(recvs, tensors)]


# ----------------------------------------------------------------------
# flat buckets
# ----------------------------------------------------------------------
def plan_buckets(numels: Sequence[int], limit: int) -> List[List[int]]:
    """The indices of ``numels`` grouped in order into buckets of at most
    ``limit`` elements; an item larger than ``limit`` is a bucket of its
    own."""
    buckets: List[List[int]] = []
    size = 0
    for i, n in enumerate(numels):
        if not buckets or size + n > limit:
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += n
    return buckets


def flat_views(flat: torch.Tensor, shapes: Sequence[Tuple[int, ...]]
               ) -> List[torch.Tensor]:
    """Consecutive views of the 1-D ``flat``, shaped as ``shapes``."""
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


def _views_of(tensors: Sequence[torch.Tensor], flat: torch.Tensor) -> bool:
    """Whether ``tensors`` lie in ``flat`` as :func:`flat_views` laid
    them out."""
    off = flat.storage_offset()
    for t in tensors:
        if (t.untyped_storage().data_ptr() != flat.untyped_storage().data_ptr()
                or t.storage_offset() != off or not t.is_contiguous()):
            return False
        off += t.numel()
    return off == flat.storage_offset() + flat.numel()


def all_reduce_bucket(tensors: Sequence[torch.Tensor], flat: torch.Tensor,
                      group=None) -> None:
    """Sum the bucket ``flat`` over ``group`` in place, in one
    :func:`all_reduce`; ``tensors`` must lie in it as its
    :func:`flat_views` (the gradients' own storage), so they are summed
    where they are and nothing is packed."""
    if not _views_of(tensors, flat):
        raise ValueError("all_reduce_bucket: the tensors are not the flat "
                         "views of the buffer given")
    all_reduce(flat, group)


def _slice_shape(t: torch.Tensor, dim: int, world: int) -> Tuple[int, ...]:
    if t.shape[dim] % world:
        raise ValueError(f"reduce_scatter_bucket: dim {dim} of size "
                         f"{t.shape[dim]} does not divide by {world}")
    shape = list(t.shape)
    shape[dim] //= world
    return tuple(shape)


def reduce_scatter_bucket(tensors: Sequence[torch.Tensor],
                          dims: Sequence[int], group=None,
                          async_op: bool = False):
    """Sum every tensor of ``tensors`` (one dtype, one device) over
    ``group`` and keep this rank's slice of each along its dim of ``dims``
    (the rank-th of ``world`` equal slices), in one ``reduce_scatter``.
    The bucket is laid out rank-major in a new buffer of the tensors'
    size: rank r's segment holds each tensor's r-th slice in order, packed
    with one copy a tensor.  Returns this rank's segment, flat, in which
    the slices lie as :func:`flat_views` of their shapes, or with
    ``async_op`` a :class:`Pending` of it (issued on NCCL's stream under
    NCCL; under gloo the ring has run when it returns).  The tensors may be
    dropped once this returns: the packed buffer is what travels."""
    with _range("reduce_scatter", group):
        _count("reduce_scatter", group, *tensors)
        world = dist.get_world_size(group)
        shapes = [_slice_shape(t, d, world) for t, d in zip(tensors, dims)]
        seg = sum(math.prod(s) for s in shapes)
        like = tensors[0]
        buf = torch.empty(world * seg, dtype=like.dtype, device=like.device)
        rows = buf.view(world, seg)
        off = 0
        for t, d, shape in zip(tensors, dims, shapes):
            n = math.prod(shape)
            # [world, *slice]: slice r of t along d, to rank r's segment
            rows[:, off:off + n].view((world,) + shape).copy_(
                t.unflatten(d, (world, shape[d])).movedim(d, 0))
            off += n
        return _sum_scatter(buf, group, async_op=async_op)


# byte alignment of each tensor in an all_gather_bucket segment: every
# dtype's view of the byte buffer starts on a multiple of its size
_ALIGN = 16


def all_gather_bucket(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                      group=None, dtypes: Optional[Sequence] = None,
                      async_op: bool = False):
    """Concatenate every rank's ``tensors`` (any dtypes, one device) along
    their ``dims`` in rank order, in one ``all_gather`` of bytes: this
    rank's segment holds each tensor, cast to its entry of ``dtypes``
    (None: its own dtype) as it is packed, at a 16-byte aligned offset;
    the gathered buffer is rank-major, one segment a rank.  Returns the
    full tensors in order on the tensors' device (one copy each out of the
    buffer), or with ``async_op`` a :class:`Pending` of that list.  Every
    rank passes tensors of the same shapes and dtypes."""
    dtypes = dtypes or [None] * len(tensors)
    dtypes = [dt or t.dtype for t, dt in zip(tensors, dtypes)]
    sizes = [t.numel() * dt.itemsize for t, dt in zip(tensors, dtypes)]
    offs, seg = [], 0
    for n in sizes:
        offs.append(seg)
        seg += -(-n // _ALIGN) * _ALIGN
    shapes = [tuple(t.shape) for t in tensors]
    buf = torch.empty(seg, dtype=torch.uint8, device=tensors[0].device)
    for t, dt, off, n in zip(tensors, dtypes, offs, sizes):
        buf[off:off + n].view(dt).view(t.shape).copy_(t)
    pending = all_gather(buf, 0, group, async_op=True)
    world = dist.get_world_size(group)

    def finish():        # inside the caller's wait range
        pending._complete()
        rows = pending._out.view(world, seg)
        out = []
        for shape, dt, off, n, d in zip(shapes, dtypes, offs, sizes, dims):
            parts = rows[:, off:off + n].view(dt).unflatten(1, shape)
            full = list(shape)
            full[d] *= world
            out.append(parts.movedim(0, d).reshape(full))
        return out

    gathered = Pending(None, finish, keep=(buf,))
    if async_op:
        return gathered
    return gathered.wait()
