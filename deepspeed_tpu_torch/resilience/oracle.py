"""PartitionOracle: the single name-based source of ZeRO partitioning.

Port of ``deepspeed_tpu/resilience/oracle.py``.  Every parameter path maps,
by regex pattern and shape, to a tuple of logical dims, and logical dims
to mesh axes; the answer is a pure function of ``(path, shape, topology,
config)``, so the engine's params, optimizer state and gradient
accumulators and checkpoints partition the same way.
``parallel/sharding.py`` re-exports this class under its historical name.

Where the JAX oracle returns a ``PartitionSpec``, :meth:`spec_for` returns
the one dim a leaf is split on (or None: the leaf stays whole on every
rank), and :meth:`split_for` that dim with the group the split runs over:
``"world"`` (the JAX ``ZERO_AXES``) or ``"inner"`` (``ZERO_INNER_AXES``).
The secondary mode decides, as the JAX ``_fsdp_axes`` does: under hpZ
(``zero_hpz_partition_size > 1``) the params split over the inner axes and
the optimizer and gradient state over the whole world; under MiCS
(``mics_shard_size > 0``) both split over the inner axes, and the outer
data axis holds replicas.  The rules, the stacked-layer-aware persistence
threshold and the candidate order (embed/norm/pos first, then
mlp/heads/vocab, the first dim the shard count divides) are the JAX
oracle's, so under hpZ a param and its state may split on different dims.
The tensor, pipeline and expert axes are one in the port (ROADMAP Queue A
item 10), so their placements never apply.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.parallel.topology import (DATA_AXIS, EXPERT_AXIS,
                                                   MESH_AXES, PIPE_AXIS,
                                                   SEQ_AXIS, SUBDATA_AXIS,
                                                   TENSOR_AXIS,
                                                   ZERO_INNER_AXES,
                                                   MeshTopology)
from deepspeed_tpu_torch.utils.logging import logger

# path-pattern → logical dims, one entry per array dim (the JAX table).
#   layer  — stacked-layer axis (never sharded)
#   expert — stacked-expert axis
#   embed  — hidden/residual dim → fsdp candidate
#   mlp    — ffn intermediate dim
#   heads  — attention projection out dim
#   vocab  — vocabulary dim
#   norm   — layernorm vector → fsdp candidate
#   pos    — position-embedding rows
DEFAULT_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"embed/tokens$", ("vocab", "embed")),
    (r"embed/positions$", ("pos", "embed")),
    (r"embed/token_types$", ("pos", "embed")),
    (r"embed/norm/(scale|bias)$", ("norm",)),
    (r"mlm_head/w$", ("embed", None)),
    (r"mlm_head/b$", ("embed",)),
    (r"mlm_head/ln/(scale|bias)$", ("norm",)),
    (r"mlm_head/bias$", ("vocab",)),
    (r"attn/w[qkv]$", ("layer", "embed", "heads")),
    (r"attn/b[qkv]$", ("layer", "heads")),
    (r"attn/wo$", ("layer", "heads", "embed")),
    (r"attn/bo$", ("layer", "embed")),
    (r"mlp/w[ig]$", ("layer", "embed", "mlp")),
    (r"mlp/bi$", ("layer", "mlp")),
    (r"mlp/wo$", ("layer", "mlp", "embed")),
    (r"mlp/bo$", ("layer", "embed")),
    (r"moe/router$", ("layer", "embed", None)),
    (r"moe/w[ig]$", ("layer", "expert", "embed", "mlp")),
    (r"moe/wo$", ("layer", "expert", "mlp", "embed")),
    (r"moe/shared/w[ig]$", ("layer", "embed", "mlp")),
    (r"moe/shared/wo$", ("layer", "mlp", "embed")),
    (r"moe/shared_gate$", ("layer", "embed", None)),
    (r"moe/residual/w[ig]$", ("layer", "embed", "mlp")),
    (r"moe/residual/wo$", ("layer", "mlp", "embed")),
    (r"moe/coef_w$", ("layer", "embed", None)),
    (r"moe/coef_b$", ("layer", None)),
    (r"ln\d/(scale|bias)$", ("layer", "norm")),
    (r"final_norm/(scale|bias)$", ("norm",)),
    (r"lm_head$", ("embed", "vocab")),
]


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def plan_mesh(n_devices: int,
              template: Optional[Mapping[str, int]] = None) -> Dict[str, int]:
    """Re-plan mesh axis sizes for a (possibly shrunk) device count (the
    JAX ``plan_mesh``).

    The recovery supervisor calls this when a host is gone and the
    surviving world must re-mesh before the universal-checkpoint resume:
    model-parallel axes from the previous run (``template``) are KEPT
    while they still divide the new world, and the data axis absorbs
    whatever remains.  Axes that no longer fit are shed outermost-first
    (pipe, subdata, expert, seq, tensor)."""
    if n_devices < 1:
        raise ValueError(f"plan_mesh: n_devices={n_devices}")
    template = dict(template or {})
    sizes = {ax: max(1, int(template.get(ax, 1)))
             for ax in MESH_AXES if ax != DATA_AXIS}
    shed_order = (PIPE_AXIS, SUBDATA_AXIS, EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)
    prod = int(np.prod(list(sizes.values())))
    while prod > 1 and (n_devices % prod != 0 or prod > n_devices):
        for ax in shed_order:
            if sizes[ax] > 1:
                sizes[ax] = 1
                break
        prod = int(np.prod(list(sizes.values())))
    plan = dict(sizes)
    plan[DATA_AXIS] = n_devices // prod
    return {ax: int(plan.get(ax, 1)) for ax in MESH_AXES}


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def secondary_mode_from_config(zero_config: Any) -> str:
    """hpZ / MiCS hierarchical-partitioning mode of a zero config block
    (``"hpz"``, ``"mics"`` or ``"none"``): read by the engine, which
    factors the data axis before the topology exists, and by
    :meth:`PartitionOracle.from_config`."""
    if getattr(zero_config, "zero_hpz_partition_size", 1) > 1:
        return "hpz"
    if getattr(zero_config, "mics_shard_size", 0) > 0:
        return "mics"
    return "none"


class PartitionOracle:
    """Resolves param paths to the dim each leaf is partitioned on, and the
    group it is partitioned over, for a topology, a ZeRO stage and a
    secondary mode (``"none"``, ``"hpz"``, ``"mics"``)."""

    def __init__(self, topology: MeshTopology, zero_stage: int = 0,
                 persist_threshold: int = 0, secondary_mode: str = "none"):
        self.topo = topology
        self.zero_stage = zero_stage
        self.rules = [(re.compile(pat), dims) for pat, dims in DEFAULT_RULES]
        # params with fewer elements than this stay gathered under ZeRO-3
        # (ref param_persistence_threshold, runtime/zero/config.py)
        self.persist_threshold = int(persist_threshold)
        if secondary_mode not in ("none", "hpz", "mics"):
            raise ValueError(f"secondary_mode {secondary_mode!r}")
        self.secondary_mode = secondary_mode

    @classmethod
    def from_config(cls, topology: MeshTopology,
                    config: Any) -> "PartitionOracle":
        """The engine's construction recipe: the zero stage, the secondary
        mode and the persistence threshold, the ``step_schedule`` value
        winning over the ``zero_optimization`` one."""
        zc = config.zero_config
        persist = zc.param_persistence_threshold
        ss = getattr(config, "step_schedule", None)
        if ss is not None and ss.param_persistence_threshold is not None:
            persist = ss.param_persistence_threshold
        return cls(topology, zero_stage=zc.stage, persist_threshold=persist,
                   secondary_mode=secondary_mode_from_config(zc))

    # ------------------------------------------------------------------
    def group_of(self, param_style: bool = True) -> str:
        """The group a split runs over: ``"inner"`` for MiCS, and for hpZ's
        params; ``"world"`` otherwise (the JAX ``_fsdp_axes``)."""
        if self.secondary_mode == "mics" or (self.secondary_mode == "hpz"
                                             and param_style):
            return "inner"
        return "world"

    def fsdp_axes(self, param_style: bool = True) -> Tuple[str, ...]:
        """The ZeRO axes above one of :meth:`group_of`'s group, in the JAX
        order."""
        candidates = ZERO_INNER_AXES if self.group_of(param_style) == \
            "inner" else (DATA_AXIS, SUBDATA_AXIS, EXPERT_AXIS, SEQ_AXIS)
        return tuple(ax for ax in candidates if self.topo.axis_size(ax) > 1)

    def shard_world(self, param_style: bool = True) -> int:
        return int(np.prod([self.topo.axis_size(a)
                            for a in self.fsdp_axes(param_style)] or [1]))

    def _logical_dims(self, path: str, ndim: int
                      ) -> Optional[Tuple[Optional[str], ...]]:
        for pat, dims in self.rules:
            if pat.search(path):
                if len(dims) != ndim:
                    logger.warning(f"sharding rule for '{path}' has "
                                   f"{len(dims)} dims, array has {ndim}; "
                                   "replicating")
                    return None
                return dims
        return None

    def split_for(self, path: str, shape: Tuple[int, ...],
                  param_style: bool = True) -> Optional[Tuple[int, str]]:
        """``(dim, group)`` of a parameter array's split (``group``
        ``"world"`` or ``"inner"``, :meth:`group_of`), or None: whole on
        every rank."""
        dim = self.spec_for(path, shape, param_style)
        return None if dim is None else (dim, self.group_of(param_style))

    def spec_for(self, path: str, shape: Tuple[int, ...],
                 param_style: bool = True) -> Optional[int]:
        """The dim of a parameter array split over its ZeRO group, or None.

        ``param_style=True`` splits params only at zero_stage 3 (and not
        below the persistence threshold); False gives the always-split
        answer used for optimizer state (stage >= 1) and gradient
        accumulators (stage >= 2)."""
        ndim = len(shape)
        dims = self._logical_dims(path, ndim)
        if dims is None:
            return None
        axes = self.fsdp_axes(param_style)
        if not axes or (param_style and self.zero_stage < 3):
            return None
        if param_style and self.persist_threshold:
            # the threshold is PER PARAMETER: divide out the stacked layer
            # dim, or every norm crosses it through the layer count alone
            elems = int(np.prod(shape)) if shape else 1
            if dims[0] == "layer" and shape:
                elems //= max(1, shape[0])
            if elems < self.persist_threshold:
                return None
        n_shard = self.shard_world(param_style)
        candidates = [i for i, d in enumerate(dims)
                      if d in ("embed", "norm", "pos")]
        candidates += [i for i, d in enumerate(dims)
                       if d in ("mlp", "heads", "vocab")]
        for i in candidates:
            if shape[i] % n_shard == 0:
                return i
        return None

    # ------------------------------------------------------------------
    def audit_replicated(self, params, min_bytes: int = 1 << 20):
        """Large parameters left whole on every rank although the ZeRO-3
        world is above one (no dim divides by it): ``[(path, shape,
        nbytes)]``.  Empty below stage 3 or with a world of one."""
        if self.zero_stage < 3 or self.shard_world() <= 1:
            return []
        offenders = []

        def visit(path, leaf):
            shape = tuple(leaf.shape)
            nbytes = int(np.prod(shape)) * leaf.element_size() if shape else 0
            if nbytes < min_bytes:
                return
            if self.spec_for(path_str(path), shape, param_style=True) is None:
                offenders.append((path_str(path), shape, nbytes))

        _tree_map_with_path(visit, params)
        return offenders

    def tree_specs(self, params, param_style: bool = True):
        """Tree of split dims (int or None) matching ``params``."""
        return _tree_map_with_path(
            lambda path, leaf: self.spec_for(path_str(path), tuple(leaf.shape),
                                             param_style=param_style), params)

    def param_specs(self, params):
        return self.tree_specs(params, param_style=True)

    def optimizer_specs(self, params):
        """Optimizer-state split: partitioned when stage >= 1 (ZeRO-1).
        At stage >= 2 the gradient accumulators split the same way."""
        return self.tree_specs(params, param_style=self.zero_stage < 1)

    def flat_specs(self, manifest: Mapping[str, Any],
                   param_style: bool = True) -> Dict[str, Optional[int]]:
        """Split dims for a FLAT ``{path: shape-or-array}`` manifest (the
        universal checkpoint's: paths and shapes, no tree)."""
        out: Dict[str, Optional[int]] = {}
        for path, shp in manifest.items():
            shape = tuple(np.shape(shp)) if not isinstance(shp, (tuple, list)) \
                else tuple(int(s) for s in shp)
            out[path] = self.spec_for(path, shape, param_style=param_style)
        return out


# the historical name (parallel/sharding.py re-exports it)
ShardingRules = PartitionOracle
