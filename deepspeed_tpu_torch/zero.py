"""ZeRO user-facing API and the stage-3 parameter gather.

Port of ``deepspeed_tpu/zero.py`` (the reference's ``deepspeed.zero``):

* :class:`Init` partitions a full parameter tree by the
  :class:`~deepspeed_tpu_torch.resilience.oracle.PartitionOracle`, so each
  rank keeps only its shard of each leaf over the ZeRO world (the data
  and seq axes: the whole world, ``MeshTopology.rank``/``world_size``;
  the JAX ``Init``
  materialises straight into the ZeRO-3 shardings over ``ZERO_AXES``; the
  port builds the full tree once and keeps a copy of its slice).  Each shard carries ``ds_shard_dim`` and
  ``ds_full_shape``, as the reference tags its partitioned parameters.
* :class:`GatheredParameters` gathers full host copies of a partitioned
  tree.  Every rank of the group must enter it, as in the reference.
* The stage-3 gather of one leaf as an autograd ``Function``
  (:func:`gather`, or :func:`issue_gather` then :func:`gathered` for a
  prefetch issued ahead of its use).  Its forward casts the fp32 shard to
  the compute dtype and all-gathers it along its dim; its backward
  reduce-scatters the gradient in the compute dtype and casts the slice to
  the shard's dtype.  That is the transpose JAX's autodiff makes of
  ``all_gather`` on the ``p.astype(dt)`` shard
  (``deepspeed_tpu/ops/pallas/gather_matmul.py:225-226``).  The gathered
  weight lives as long as autograd holds it: the products that read it
  save it for their backward, which uses the saved copy and does not
  gather again, as the JAX package does under remat ``none``; a
  checkpointed layer (remat ``full``) gathers again when its forward
  reruns.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.parallel.topology import MeshTopology, get_topology
from deepspeed_tpu_torch.resilience.oracle import PartitionOracle


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _tree_map2(fn, a, b, path=()):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k], path + (k,)) for k in a}
    return fn(path, a, b)


def shard_of(full: torch.Tensor, dim: Optional[int], rank: int,
             world: int) -> torch.Tensor:
    """This rank's slice of ``full`` along ``dim`` (a contiguous copy,
    tagged with its dim and the full shape); ``full`` itself when ``dim``
    is None."""
    if dim is None:
        return full
    shard = full.detach().chunk(world, dim=dim)[rank].clone(
        memory_format=torch.contiguous_format)
    shard.ds_shard_dim = dim
    shard.ds_full_shape = tuple(full.shape)
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
        topo = self.topology
        return _tree_map2(lambda _p, x, d: shard_of(x, d, topo.rank,
                                                    topo.world_size),
                          params, dims)


class GatheredParameters:
    """Full host copies of a partitioned tree (ref GatheredParameters)::

        with GatheredParameters(engine.params) as full:
            ...   # full: the same tree of full CPU tensors

    A leaf tagged ``ds_shard_dim`` is all-gathered over ``group`` (default:
    the ZeRO group of the live topology); any other leaf is
    copied as it is.  Every rank of the group must enter the context.  The
    copies are read-only views of the values: edits do not write back
    (the JAX ``updated`` tree comes with the checkpoint port, ROADMAP Queue
    A item 7)."""

    def __init__(self, params, group=None):
        self._orig = params
        self._group = group
        self.params = None

    def __enter__(self):
        group = self._group
        if group is None:
            topo = get_topology()
            group = topo.world_group if topo is not None else None

        def full(_path, x):
            dim = getattr(x, "ds_shard_dim", None)
            x = x.detach()
            if dim is not None:
                x = comm.all_gather(x, dim, group)
            return x.cpu().clone()

        self.params = _tree_map(full, self._orig)
        return self.params

    def __exit__(self, *exc):
        return None


# ----------------------------------------------------------------------
# the stage-3 gather
# ----------------------------------------------------------------------
def issue_gather(shard: torch.Tensor, dim: int, group,
                 dtype: torch.dtype) -> comm.Pending:
    """Start the all-gather of ``shard`` cast to ``dtype`` along ``dim``;
    :func:`gathered` turns the handle into the differentiable full
    tensor."""
    return comm.all_gather(shard.detach().to(dtype), dim, group,
                           async_op=True)


class _Gathered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, pending, dim, group):
        ctx.dim, ctx.group, ctx.shard_dtype = dim, group, shard.dtype
        return pending.wait()

    @staticmethod
    def backward(ctx, grad):
        part = comm.reduce_scatter(grad, ctx.dim, ctx.group)
        return part.to(ctx.shard_dtype), None, None, None


def gathered(shard: torch.Tensor, pending: comm.Pending, dim: int,
             group) -> torch.Tensor:
    """The full tensor of an issued gather (waits for it), differentiable
    in ``shard``."""
    return _Gathered.apply(shard, pending, dim, group)


def gather(shard: torch.Tensor, dim: int, group,
           dtype: torch.dtype) -> torch.Tensor:
    return gathered(shard, issue_gather(shard, dim, group, dtype), dim, group)


class ParamGather:
    """What a stage-3 forward needs to gather its leaves: the param split
    dims (a tree like the params, int or None), the ZeRO group and the
    dtype each leaf is gathered in (``dtype_of(path)``: the compute dtype,
    or the master dtype for leaves the model casts itself at use)."""

    def __init__(self, dims, group, dtype_of: Callable):
        if not dist.is_initialized():
            raise RuntimeError("a stage-3 gather needs a process group")
        self.dims = dims
        self.group = group
        self.dtype_of = dtype_of

    def _tree(self, tree, dims, path, offset, skip=()):
        """Issue every gather of ``tree`` first, then wait for each
        (``offset``: the stacked layer dim the views no longer have)."""
        pending = {}

        def issue(p, x, d):
            if d is not None and p[-2:] not in skip:
                pending[p] = issue_gather(x, d - offset, self.group,
                                          self.dtype_of(path + p))

        _tree_map2(issue, tree, dims)
        return _tree_map2(
            lambda p, x, d: gathered(x, pending[p], d - offset, self.group)
            if p in pending else x, tree, dims)

    def whole(self, params):
        """Every split leaf of ``params`` gathered (a duck-typed
        trainable's tree, whose loss takes whole leaves)."""
        return self._tree(params, self.dims, (), 0)

    def top(self, params):
        """Every leaf outside ``layers`` gathered (the embedding, final
        norm and head; ``layers`` passes through untouched)."""
        rest = {k: v for k, v in params.items() if k != "layers"}
        dims = {k: v for k, v in self.dims.items() if k != "layers"}
        out = self._tree(rest, dims, (), 0)
        if "layers" in params:
            out["layers"] = params["layers"]
        return out

    def layer(self, layer_params, skip=()):
        """One layer's leaves (per-layer views of the stacked shards)
        gathered, except the ``(block, leaf)`` paths in ``skip``."""
        return self._tree(layer_params, self.dims["layers"], ("layers",), 1,
                          skip=tuple(skip))
