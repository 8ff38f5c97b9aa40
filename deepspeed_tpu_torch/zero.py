"""ZeRO user-facing API and the stage-3 parameter gather.

Port of ``deepspeed_tpu/zero.py`` (the reference's ``deepspeed.zero``):

* :class:`Split` says where a rank's tensor lies in its full leaf: cut
  along one dim over one group (the ZeRO world, or hpZ's and MiCS's inner
  group), or twice (hpZ's optimizer state: over the inner group, then its
  chunk over the outer group).
* :class:`Init` partitions a full parameter tree by the
  :class:`~deepspeed_tpu_torch.resilience.oracle.PartitionOracle`, so each
  rank keeps only its shard of each leaf over the oracle's group (the JAX
  ``Init`` materialises straight into the ZeRO-3 shardings; the port
  builds the full tree once and keeps a copy of its slice).  Each shard
  carries ``ds_shard_dim``, ``ds_full_shape`` and ``ds_split``, as the
  reference tags its partitioned parameters.
* :class:`GatheredParameters` gathers full host copies of a partitioned
  tree, and its ``updated`` tree puts edits back as the params are held
  (:func:`gathered_update` is its functional form).  Every rank of the
  groups must enter it, as in the reference.
* The memory estimators of ZeRO-2 and ZeRO-3's model states.
* The stage-3 gather (:class:`ParamGather`) and its gradients
  (:class:`Stage3Reducer`).  A gathered leaf is an autograd ``Function``
  whose forward takes the full tensor from an issued all-gather (the
  fp32 shard cast to the compute dtype, or under qwZ its wire payload
  and scales, ``parallel/zeropp.py``) and whose backward hands the full
  gradient to the reducer, which reduce-scatters it through flat buckets
  in the compute dtype (fp32 under qwZ) and adds the slice into the
  shard's fp32 accumulator.  That is the transpose JAX's autodiff makes of
  ``all_gather`` on the ``p.astype(dt)`` shard
  (``deepspeed_tpu/ops/pallas/gather_matmul.py:225-226``), with XLA's
  combiner merging the reduce-scatters.  The leaves of one layer travel
  as one flat all-gather, and a :class:`Window` issues layers ahead of
  their use (``step_schedule.gather_prefetch_depth``): the schedule XLA
  makes of the JAX layer scan unrolled by that depth.  The gathered
  weight lives as long as autograd holds it: the products that read it
  save it for their backward, which uses the saved copy and does not
  gather again, as the JAX package does under remat ``none``; a
  checkpointed layer (remat ``full``) gathers again when its forward
  reruns.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import quantized as wire
from deepspeed_tpu_torch.parallel import zeropp
from deepspeed_tpu_torch.parallel.topology import (Level, MeshTopology,
                                                   get_topology)
from deepspeed_tpu_torch.resilience.oracle import PartitionOracle


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _tree_map2(fn, a, b, path=()):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k], path + (k,)) for k in a}
    return fn(path, a, b)


class Split(NamedTuple):
    """Where a rank's tensor lies in its full leaf: the leaf is cut along
    ``dim`` into ``levels[0].size`` equal chunks and this rank keeps chunk
    ``levels[0].index``; that chunk is cut by ``levels[1]``, and so on.
    ``replicas``: whether other ranks hold the same slice (MiCS's outer
    data axis); ``writer``: whether this rank writes the slice to a
    checkpoint (one replica of each)."""
    dim: int
    levels: Tuple[Level, ...]
    replicas: bool = False
    writer: bool = True

    @property
    def parts(self) -> int:
        """How many slices the leaf is cut into."""
        return math.prod(lv.size for lv in self.levels)

    @property
    def index(self) -> int:
        """This rank's slice among :attr:`parts`, in leaf order."""
        i = 0
        for lv in self.levels:
            i = i * lv.size + lv.index
        return i

    def slice(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full`` (a view)."""
        for lv in self.levels:
            full = full.chunk(lv.size, dim=self.dim)[lv.index]
        return full

    def bounds(self, n: int) -> Tuple[int, int]:
        """This rank's ``[start, stop)`` along a full dim of ``n``."""
        k = n // self.parts
        return self.index * k, (self.index + 1) * k

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's slice ``t``: one all-gather a
        level, the last level's first."""
        for lv in reversed(self.levels):
            t = comm.all_gather(t, self.dim, lv.group)
        return t

    def then(self, other: "Split") -> "Split":
        """This split's slice cut again by ``other``'s levels (on the same
        dim)."""
        return Split(self.dim, self.levels + other.levels, other.replicas,
                     other.writer)


def take(full: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """This rank's slice of ``full`` (a contiguous copy tagged with its dim,
    the full shape and ``split``); ``full`` itself when ``split`` is
    None."""
    if split is None:
        return full
    shard = split.slice(full.detach()).clone(
        memory_format=torch.contiguous_format)
    shard.ds_shard_dim = split.dim
    shard.ds_full_shape = tuple(full.shape)
    shard.ds_split = split
    return shard


class Init:
    """Sharded model construction (ref ``zero.Init``)::

        with deepspeed_tpu_torch.zero.Init(zero_stage=3) as zinit:
            shards = zinit.partition(full_params)

    Every rank passes the same full tree and keeps its slice of each leaf
    the oracle partitions (at ``zero_stage`` 3: its param split)."""

    def __init__(self, zero_stage: int = 3,
                 topology: Optional[MeshTopology] = None,
                 oracle: Optional[PartitionOracle] = None):
        self.zero_stage = zero_stage
        self.topology = topology
        self.oracle = oracle

    def __enter__(self) -> "Init":
        topo = self.topology or get_topology()
        if topo is None:
            raise RuntimeError("zero.Init needs a topology: build the "
                               "engine or pass topology=")
        self.topology = topo
        if self.oracle is None:
            self.oracle = PartitionOracle(topo, zero_stage=self.zero_stage)
        return self

    def __exit__(self, *exc) -> None:
        return None

    def partition(self, params):
        if self.oracle is None:
            raise RuntimeError("zero.Init used outside its context")
        dims = self.oracle.param_specs(params)
        split = param_split(self.topology, self.oracle)
        return _tree_map2(lambda _p, x, d: take(x, split(d)), params, dims)


def param_split(topo: MeshTopology, oracle: PartitionOracle) -> Callable:
    """``dim -> Split`` (None for None) of a stage-3 param over the
    oracle's param group: the world, or hpZ's and MiCS's inner group, whose
    outer replicas (MiCS and hpZ alike) write no checkpoint slice."""
    kind = oracle.group_of(param_style=True)
    level = topo.level(kind)
    replicas = kind == "inner" and topo.outer_size > 1
    writer = not replicas or topo.outer_rank == 0

    def split(dim):
        return None if dim is None else Split(dim, (level,), replicas, writer)

    return split


def _full_copies(params):
    def full(_path, x):
        split = getattr(x, "ds_split", None)
        x = x.detach()
        if split is not None:
            x = split.gather(x)
        return x.cpu().clone()

    return _tree_map(full, params)


def _scatter_back(orig, edited):
    """Each leaf of ``edited`` (full values: tensors or arrays) put back as
    its ``orig`` leaf is held: this rank's slice of a tagged shard (tagged
    alike), the whole value otherwise, in the original dtype and on the
    original device."""
    def put_back(_path, o, new):
        split = getattr(o, "ds_split", None)
        full = torch.as_tensor(new).to(device=o.device, dtype=o.dtype,
                                       copy=split is None)
        return take(full, split)

    return _tree_map2(put_back, orig, edited)


class GatheredParameters:
    """Full host copies of a partitioned tree (ref GatheredParameters)::

        with GatheredParameters(engine.params) as full:
            ...   # full: the same tree of full CPU tensors, editable
        new = ctx.updated   # the edits, put back as the params are held

    A leaf tagged ``ds_split`` is gathered through its split (its groups:
    the ZeRO world, or hpZ's and MiCS's inner group); any other leaf is
    copied as it is.  Every rank of the groups must enter the context.
    The tensors are
    functional, as in the JAX package: edits do not write into the
    params; after the block ``updated`` holds the edited tree re-scattered
    (each rank's slice of a split leaf, on its device and in its dtype).
    ``modifier_rank`` is accepted and, as in the JAX package, every rank's
    own edits are kept."""

    def __init__(self, params, modifier_rank: Optional[int] = 0):
        self._orig = params
        self.params = None
        self.updated = None

    def __enter__(self):
        self.params = _full_copies(self._orig)
        return self.params

    def __exit__(self, *exc):
        if exc[0] is None:
            self.updated = _scatter_back(self._orig, self.params)
        return None


def gathered_update(params, edit_fn: Callable):
    """The functional form of :class:`GatheredParameters`: gather, edit
    the full host copies with ``edit_fn`` (which returns the edited tree),
    re-scatter; returns the updated tree."""
    edited = edit_fn(_full_copies(params))
    return _scatter_back(params, edited)


# ----------------------------------------------------------------------
# memory estimators (the reference's stage3.py / stage_1_and_2.py)
# ----------------------------------------------------------------------
def estimate_zero3_model_states_mem_needs(
        total_params: int, num_gpus_per_node: int = 1, num_nodes: int = 1,
        cpu_offload: bool = True, cpu_offload_params: bool = False,
        additional_buffer_factor: float = 1.5):
    """``(device bytes, host bytes)`` of ZeRO-3's model states: a bf16
    shard a device, fp32 masters and Adam moments on the device or host."""
    world = num_gpus_per_node * num_nodes
    gpu = 2 * total_params / world
    if not cpu_offload:
        gpu += 16 * total_params / world
        host = additional_buffer_factor * 4 * total_params
    elif not cpu_offload_params:
        host = additional_buffer_factor * 16 * total_params
    else:
        gpu = 2 * total_params / world
        host = additional_buffer_factor * 18 * total_params
    return int(gpu), int(host)


def estimate_zero2_model_states_mem_needs(
        total_params: int, num_gpus_per_node: int = 1, num_nodes: int = 1,
        cpu_offload: bool = True, additional_buffer_factor: float = 1.5):
    """``(device bytes, host bytes)`` of ZeRO-2's model states: bf16
    params and grads on every device, the optimizer state split or on the
    host."""
    world = num_gpus_per_node * num_nodes
    gpu = 4 * total_params
    if cpu_offload:
        host = additional_buffer_factor * 12 * total_params
    else:
        gpu += 12 * total_params / world
        host = 0
    return int(gpu), int(host)


# ----------------------------------------------------------------------
# the stage-3 gather
# ----------------------------------------------------------------------
class _Piece(NamedTuple):
    """A gathered leaf as its gradient's reduction sees it: the stacked
    leaf's path, the layer whose view was gathered (None: the leaf
    itself), the dim it is split on, and the dtype its gradient is reduced
    in."""
    path: Tuple[str, ...]
    layer: Optional[int]
    dim: int
    grad_dtype: torch.dtype


class _Gathered(torch.autograd.Function):
    """The full tensor of a leaf whose gather was issued: ``source.take(
    key)`` in the forward; the backward hands the full gradient to the
    stage-3 reducer and gives the shard none through autograd (the reducer
    adds its slice into the shard's accumulator)."""

    @staticmethod
    def forward(ctx, shard, source, key, reducer, piece):
        ctx.reducer, ctx.piece = reducer, piece
        return source.take(key)

    @staticmethod
    def backward(ctx, grad):
        ctx.reducer.add(grad.to(ctx.piece.grad_dtype), ctx.piece)
        return None, None, None, None, None


class _One:
    """The source of one leaf's own gather (a :class:`comm.Pending`)."""

    def __init__(self, pending: comm.Pending):
        self._pending = pending

    def take(self, _key):
        if self._pending is None:
            raise RuntimeError("a stage-3 gather was consumed twice")
        pending, self._pending = self._pending, None
        return pending.wait()


def issue_gather(shard: torch.Tensor, dim: int, group,
                 dtype: torch.dtype) -> comm.Pending:
    """Start the all-gather of ``shard`` cast to ``dtype`` along ``dim``."""
    return comm.all_gather(shard.detach().to(dtype), dim, group,
                           async_op=True)


class Stage3Reducer:
    """The reduction of stage-3 gradients through flat buckets.

    The gather's backward hands each leaf's full gradient here (in the
    order the backward produces them, the same on every rank).  They are
    packed, by dtype, into rank-major buckets of at most ``limit``
    elements (``zero_optimization.reduce_bucket_size``; a larger gradient
    alone), the rule of :func:`comm.plan_buckets` over that order: a
    bucket is issued as one ``reduce_scatter_bucket`` as soon as it is
    full (asynchronously under NCCL; under gloo the point-to-point ring
    runs then), and :meth:`finish`, at the end of the micro-step's
    backward, issues the rest, waits for every bucket and adds each slice
    into its fp32 accumulator (``accs[path]``, or its view ``[layer]`` for
    a layer of a stacked leaf).  A limit of 1 reduces each gradient on its
    own."""

    def __init__(self, accs: Dict[Tuple[str, ...], torch.Tensor], group,
                 limit: int):
        self.accs, self.group, self.limit = accs, group, limit
        self._open: Dict[torch.dtype, list] = {}
        self._issued: list = []
        self.buckets = 0          # issued since the last finish

    def add(self, grad: torch.Tensor, piece: _Piece) -> None:
        acc = self.accs[piece.path]
        target = acc if piece.layer is None else acc[piece.layer]
        size = sum(g.numel() for g, _d, _t in self._open.get(grad.dtype, ()))
        if size and size + grad.numel() > self.limit:
            self._issue(grad.dtype)
            size = 0
        self._open.setdefault(grad.dtype, []).append(
            (grad, piece.dim, target))
        if size + grad.numel() >= self.limit:   # nothing more fits
            self._issue(grad.dtype)

    def _issue(self, dtype) -> None:
        items = self._open.pop(dtype)
        pending = comm.reduce_scatter_bucket(
            [g for g, _d, _t in items], [d for _g, d, _t in items],
            self.group, async_op=True)
        self._issued.append((pending, [t for _g, _d, t in items]))
        self.buckets += 1

    def finish(self) -> int:
        """Issue the open buckets, wait for every bucket, add the slices
        into their accumulators; returns the buckets of this backward."""
        for dtype in list(self._open):
            self._issue(dtype)
        for pending, targets in self._issued:
            seg = pending.wait()
            for t, v in zip(targets, comm.flat_views(
                    seg, [t.shape for t in targets])):
                t.add_(v)
        self._issued = []
        n, self.buckets = self.buckets, 0
        return n


class _Flat:
    """Several leaves' gathers issued as one flat all-gather
    (``comm.all_gather_bucket``), each leaf cast to its gather dtype, or
    under qwZ as its wire payload and block scales; :meth:`take` returns
    one leaf's full tensor, once."""

    def __init__(self, owner: "ParamGather", items):
        """``items``: ``(key, shard, dim, dtype, path)`` a leaf."""
        self._owner = owner
        qwz = owner.qwz
        tensors, dims, dtypes, self._plan = [], [], [], {}
        coded = [it for it in items if owner._coded(it[4])]
        straddling = [it for it in coded
                      if zeropp.straddles(tuple(it[1].shape), it[2],
                                          owner.world, qwz[1])]
        scales = {}
        if straddling:
            # the blocks' absolute maxima over the ranks, one all-reduce
            parts = [zeropp.partial_absmax(it[1].detach(), owner.rank,
                                           owner.world, qwz[1])
                     for it in straddling]
            flat = torch.cat([p.reshape(-1) for p in parts])
            comm.all_reduce(flat, owner.group, op="max")
            for it, absmax in zip(straddling, comm.flat_views(
                    flat, [p.shape for p in parts])):
                scales[it[0]] = wire.wire_scale(absmax, qwz[0])
        for key, shard, dim, dtype, path in items:
            x = shard.detach()
            if key in scales:      # the payload; every rank has the scales
                self._plan[key] = (len(tensors), scales[key], dtype)
                tensors.append(zeropp.quantize_columns(
                    x, scales[key], owner.rank, owner.world, qwz[1], qwz[0]))
                dims.append(dim)
                dtypes.append(None)
            elif owner._coded(path):   # the payload and its block scales
                payload, scale = zeropp.encode_shard(
                    x, owner.full_shape[path][-1], qwz[1], qwz[0])
                self._plan[key] = (len(tensors), len(tensors) + 1, dtype)
                tensors += [payload, scale]
                dims += [dim, dim]
                dtypes += [None, None]
            else:                      # cast to its dtype as it is packed
                self._plan[key] = (len(tensors), None, dtype)
                tensors.append(x)
                dims.append(dim)
                dtypes.append(dtype)
        self._pending = comm.all_gather_bucket(tensors, dims, owner.group,
                                               dtypes, async_op=True)
        self._out = None

    def take(self, key) -> torch.Tensor:
        plan = self._plan.pop(key, None)
        if plan is None:
            raise RuntimeError(f"the stage-3 gather of {key} was consumed "
                               "twice, or never issued")
        if self._out is None:
            self._out = self._pending.wait()
            self._pending = None
        i, scale, dtype = plan
        full, self._out[i] = self._out[i], None
        if scale is None:
            return full
        if isinstance(scale, int):      # block scales gathered with it
            j = scale
            scale, self._out[j] = self._out[j], None
        return zeropp.decode(full, scale, self._owner.qwz[0]).to(dtype)


class Deferred:
    """A stage-3 leaf that its user gathers itself (the fused MLP's
    ``wi``/``wo``/``wg``/``bi``): :meth:`issue` starts its all-gather (a
    no-op when the window already issued it), :meth:`gathered` returns the
    differentiable full tensor."""

    def __init__(self, owner: "ParamGather", shard: torch.Tensor,
                 piece: _Piece, dtype: torch.dtype,
                 pending: Optional[comm.Pending] = None):
        self._owner, self.shard, self.piece = owner, shard, piece
        self.dtype, self.pending = dtype, pending

    def issue(self) -> None:
        if self.pending is None:
            self.pending = issue_gather(self.shard, self.piece.dim,
                                        self._owner.group, self.dtype)

    def gathered(self) -> torch.Tensor:
        self.issue()
        source, self.pending = _One(self.pending), None
        return _Gathered.apply(self.shard, source, None,
                               self._owner.reducer, self.piece)


class ParamGather:
    """The stage-3 gathers of a forward: the param split dims (a tree like
    the params, int or None), the ZeRO group, the dtype each leaf is
    gathered in (``dtype_of(path)``: the compute dtype, or the master dtype
    for leaves the model casts itself at use), the gradient reducer, the
    window depth and the qwZ wire (``(wire dtype, group size)`` or None).

    Leaves gathered together travel as one flat all-gather: the top
    leaves (embedding, final norm, head), each layer's leaves (but the
    fused MLP's, :class:`Deferred`), or a duck-typed trainable's whole
    tree.  Under qwZ a leaf the JAX gather encodes
    (``zeropp.quantized``) travels as its payload and scales, and a leaf
    kept whole takes the round trip on its rank."""

    def __init__(self, params, dims, group, dtype_of: Callable,
                 reducer: Stage3Reducer, depth: int = 1,
                 qwz: Optional[Tuple[str, int]] = None):
        if not dist.is_initialized():
            raise RuntimeError("a stage-3 gather needs a process group")
        self.dims, self.group, self.dtype_of = dims, group, dtype_of
        self.reducer, self.depth, self.qwz = reducer, depth, qwz
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.full_shape = {}
        _tree_map(lambda p, x: self.full_shape.__setitem__(
            p, tuple(getattr(x, "ds_full_shape", x.shape))), params)

    def _coded(self, path) -> bool:
        return self.qwz is not None and zeropp.quantized(
            self.full_shape[path], self.qwz[1])

    def _issue(self, tree, dims, prefix, views=False, skip=()):
        """One flat gather of the split leaves of ``tree`` but the
        ``(block, leaf)`` paths in ``skip`` (``views``: its leaves are one
        layer's views of stacked leaves, one dim fewer than ``dims``
        count); returns it, or None when nothing is split."""
        items = []

        def one(p, x, d):
            if d is not None and p[-2:] not in skip:
                items.append((p, x, d - views, self.dtype_of(prefix + p),
                              prefix + p))

        _tree_map2(one, tree, dims)
        return _Flat(self, items) if items else None

    def _take(self, tree, dims, prefix, flat, layer=None, skip=(),
              prefetched=None):
        def one(p, x, d):
            path = prefix + p
            if d is None:
                if self._coded(path):
                    return zeropp.straight_through(x, zeropp.round_trip(
                        x.detach(), *self.qwz))
                return x
            dim = d if layer is None else d - 1
            grad_dtype = x.dtype if self._coded(path) else \
                self.dtype_of(path)
            piece = _Piece(path, layer, dim, grad_dtype)
            if p[-2:] in skip:
                return Deferred(self, x, piece, self.dtype_of(path),
                                (prefetched or {}).get(p[-2:]))
            return _Gathered.apply(x, flat, p, self.reducer, piece)

        return _tree_map2(one, tree, dims)

    def whole(self, params):
        """Every split leaf of ``params`` gathered (a duck-typed
        trainable's tree, whose loss takes whole leaves)."""
        flat = self._issue(params, self.dims, ())
        return self._take(params, self.dims, (), flat)

    def window(self, params, per_layer, num_layers: int, skip=()):
        """The gathers of one forward of the built-in model: the top
        leaves of ``params`` and the per-layer views ``per_layer`` (a tree
        of tuples), through a :class:`Window` of this gather's depth."""
        return Window(self, params, per_layer, num_layers, skip)


class Window:
    """The gather window of one forward (``step_schedule.
    gather_prefetch_depth`` d).  The top leaves are issued first, then the
    layers: while layer i runs, the gathers of layers i+1 … i+d-1 are
    already issued (at d = 1 each layer's gather is issued when the layer
    starts).  A checkpointed layer (remat ``full``) that reruns in the
    backward gathers again, through the window run backwards: the
    recompute of layer i has issued the gathers of layers i-1 … i-d+1.
    Each issued gather is consumed once; every rank issues the same
    collectives in the same order.  At d >= 2 the window also issues the
    fused MLP's ``wi`` (:class:`Deferred`) with its layer."""

    def __init__(self, owner: ParamGather, params, per_layer, n: int, skip):
        self._owner, self._n, self._skip = owner, n, tuple(skip)
        self._views = per_layer
        self._dims = owner.dims["layers"]
        self._issued: Dict[Tuple[str, int], tuple] = {}
        self._ran = set()        # layers whose forward has run
        self._rest = {k: v for k, v in params.items() if k != "layers"}
        self._rest_dims = {k: v for k, v in owner.dims.items()
                           if k != "layers"}
        self._top = owner._issue(self._rest, self._rest_dims, ())
        for j in range(min(owner.depth - 1, n)):
            self._issued[("fwd", j)] = self._issue_layer(j)

    def top(self):
        """The top leaves gathered (``layers`` passes through)."""
        out = self._owner._take(self._rest, self._rest_dims, (), self._top)
        self._top = None
        return out

    def _layer_views(self, i):
        return _tree_map(lambda _p, views: views[i], self._views)

    def _issue_layer(self, i):
        owner = self._owner
        lp = self._layer_views(i)
        flat = owner._issue(lp, self._dims, ("layers",), views=True,
                            skip=self._skip)
        pre = {}
        wi = ("mlp", "wi")
        if owner.depth > 1 and wi in self._skip:
            d = self._dims["mlp"].get("wi")
            if d is not None:
                pre[wi] = issue_gather(lp["mlp"]["wi"], d - 1, owner.group,
                                       owner.dtype_of(("layers",) + wi))
        return flat, pre

    def layer(self, i: int):
        """Layer i's leaves gathered (views of the stacked leaves; the
        fused MLP's as :class:`Deferred`), after issuing the window
        ahead of it."""
        fwd = i not in self._ran
        phase = "fwd" if fwd else "bwd"
        d = self._owner.depth
        ahead = range(i, min(i + d, self._n)) if fwd else \
            range(i, max(i - d, -1), -1)
        for j in ahead:
            if (phase, j) not in self._issued:
                self._issued[(phase, j)] = self._issue_layer(j)
        flat, pre = self._issued.pop((phase, i))
        self._ran.add(i)
        return self._owner._take(self._layer_views(i), self._dims,
                                 ("layers",), flat, layer=i,
                                 skip=self._skip, prefetched=pre)
