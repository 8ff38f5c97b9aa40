"""Coalesced and quantized collectives over a gradient tree (ZeRO++ qgZ).

Port of ``deepspeed_tpu/comm/coalesced_collectives.py``:

* :func:`reduce_scatter_coalesced`: one reduce-scatter over a whole tree,
  its leaves flattened and concatenated into one padded fp32 buffer, and
  :func:`all_gather_coalesced`, its inverse;
* :func:`all_to_all_quant_reduce` (qgZ): int8 block-quantized gradient
  reduction, one level (quantize, ``all_to_all`` within a group,
  dequantize and average) or two (then the same across a second group);
* :func:`loco_quant_reduce`: qgZ with error feedback (LoCo), the residual
  of the first send carried to the next step.

A tree is a nested dict of tensors (or a tensor); its leaves are taken in
the JAX tree order (dict keys sorted at every level), so a buffer is laid
out as ``jax.tree.flatten`` lays out the JAX package's.  A level of qgZ is
``comm/quantized.py``'s int8 ``quantized_reduce_scatter``: the
``quantize``/``dequantize`` kernels on CUDA tensors, their plain versions
on CPU tensors.  Where the JAX package names mesh axes, these functions
take process groups (None: the default group).  The engine's qgZ step
calls ``_quant_chunked_reduce`` at one level and
:func:`all_to_all_quant_reduce` at two, over hpZ's or MiCS's factored
data axis (``runtime/onebit.py``).  As in the JAX package, no engine path
calls :func:`loco_quant_reduce` or the coalesced pair; only tests and
benchmarks do.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.quantized import quantized_reduce_scatter


def _leaves(tree) -> List[torch.Tensor]:
    """The leaves in the JAX tree order: dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves: List[torch.Tensor]):
    """A tree shaped like ``tree`` holding ``leaves`` (in JAX order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}     # the caller's key order
        return next(it)

    return build(tree)


def _flatten_concat(tree, world: int) -> Tuple[torch.Tensor, Any, list]:
    """All leaves, fp32, concatenated into one vector padded to a multiple
    of ``world``; returns ``(buffer, tree, sizes)``."""
    flat = [x.reshape(-1).float() for x in _leaves(tree)]
    sizes = [x.numel() for x in flat]
    pad = (-sum(sizes)) % world
    if pad:
        flat.append(torch.zeros(pad, dtype=torch.float32,
                                device=flat[0].device))
    return torch.cat(flat), tree, sizes


def _split_restore(buf: torch.Tensor, tree, sizes, shapes, dtypes):
    out, off = [], 0
    for size, shape, dt in zip(sizes, shapes, dtypes):
        out.append(buf[off:off + size].reshape(shape).to(dt))
        off += size
    return _unflatten(tree, out)


def reduce_scatter_coalesced(tree, group=None, world: int = None):
    """One reduce-scatter (the sum) of a whole tree: returns ``(shard,
    meta)``, this rank's 1/world of the flat reduced buffer and what
    :func:`all_gather_coalesced` needs to rebuild the tree."""
    world = comm.group_size(group, world)
    buf, tree, sizes = _flatten_concat(tree, world)
    return comm.reduce_scatter(buf, 0, group), (tree, sizes)


def all_gather_coalesced(shard: torch.Tensor, meta, shapes, dtypes,
                         group=None):
    """Inverse of :func:`reduce_scatter_coalesced`: gather every rank's
    shard and rebuild the tree."""
    tree, sizes = meta
    return _split_restore(comm.all_gather(shard, 0, group), tree, sizes,
                          shapes, dtypes)


# ----------------------------------------------------------------------
# qgZ: quantized all-to-all gradient reduction (ZeRO++)
# ----------------------------------------------------------------------
def _quant_chunked_reduce(x: torch.Tensor, group, world: int,
                          group_size: int) -> torch.Tensor:
    """One level of qgZ: this rank's [N / world] chunk of the mean of the
    local [N] buffers (N divisible by ``world``), int8 payload and fp32
    scales on the wire: :func:`comm.quantized.quantized_reduce_scatter`,
    whose wire is recorded under ``quant_reduce_scatter``."""
    return quantized_reduce_scatter(x, group, world, "int8", group_size)[0]


def all_to_all_quant_reduce(tree, inner_group, outer_group, inner_size: int,
                            outer_size: int, group_size: int = 256):
    """qgZ: the tree's mean over ``inner_size · outer_size`` ranks through
    int8 all-to-alls, first within ``inner_group``, then (when
    ``outer_size > 1``) across ``outer_group``.  Returns ``(shard, meta)``
    as :func:`reduce_scatter_coalesced`: this rank's 1/(inner·outer) of
    the flat mean.  (The JAX function's ``num_bits`` is left out: no
    caller sets it.)"""
    buf, tree, sizes = _flatten_concat(tree, inner_size * outer_size)
    lvl = _quant_chunked_reduce(buf, inner_group, inner_size, group_size)
    if outer_size > 1:
        lvl = _quant_chunked_reduce(lvl, outer_group, outer_size, group_size)
    return lvl, (tree, sizes)


def loco_quant_reduce(tree, err_tree, inner_group, outer_group,
                      inner_size: int, outer_size: int,
                      group_size: int = 256):
    """qgZ with error feedback (LoCo): ``err_tree`` (shaped as ``tree``) is
    added before the send, and the residual of the first (lossy) send is
    returned as the new error tree.  Returns ``(shard, meta,
    new_err_tree)``.  The sum is taken in fp32 (the JAX function adds
    leaf by leaf in the leaves' dtype: the same numbers for fp32
    leaves)."""
    leaves, errs = _leaves(tree), _leaves(err_tree)
    buf, _, sizes = _flatten_concat(tree, inner_size * outer_size)
    err, _, _ = _flatten_concat(err_tree, inner_size * outer_size)
    lvl, residual = quantized_reduce_scatter(buf, inner_group, inner_size,
                                             "int8", group_size,
                                             residual=err)
    new_err = _split_restore(residual, tree, sizes,
                             [tuple(x.shape) for x in leaves],
                             [e.dtype for e in errs])
    if outer_size > 1:
        lvl = _quant_chunked_reduce(lvl, outer_group, outer_size, group_size)
    return lvl, (tree, sizes), new_err


def tree_meta(tree):
    """The shapes and dtypes, in JAX order, needed to rebuild a tree."""
    leaves = _leaves(tree)
    return [tuple(x.shape) for x in leaves], [x.dtype for x in leaves]
