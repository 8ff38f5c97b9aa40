"""Ulysses sequence parallelism: attention over head shards between
all-to-alls.

Port of ``deepspeed_tpu/sequence/layer.py``.  Activations are
sequence-sharded everywhere except inside attention, which is
head-sharded: each rank of the ``seq`` group holds ``[B, S/sp, H, D]``,
one all-to-all a tensor turns that into ``[B, S, H/sp, D]`` (the whole
sequence, ``H/sp`` of the heads), the local attention runs on it, and the
inverse all-to-all turns the output back.  The JAX package lets GSPMD
place those exchanges; here each rank calls the wrapper on its own shard
and the exchanges are :func:`~deepspeed_tpu_torch.comm.comm.seq_all_to_all`,
whose backward is the inverse exchange.

The blocks a rank receives are concatenated in rank order, so the local
attention sees the sequence in global order when the shards are
contiguous (rank r holds positions ``r·S/sp …``).
"""

from __future__ import annotations

from typing import Callable, Optional

from deepspeed_tpu_torch.comm.comm import seq_all_to_all
from deepspeed_tpu_torch.parallel.topology import MeshTopology, get_topology


def single_all_to_all(x, scatter_idx: int, gather_idx: int, group=None):
    """The layout switch of one tensor over ``group`` (the JAX
    ``single_all_to_all``): ``x`` split along ``scatter_idx``, block i to
    rank i, the received blocks concatenated along ``gather_idx`` in rank
    order; differentiable."""
    return seq_all_to_all(x, scatter_idx, gather_idx, group)


class DistributedAttention:
    """Ulysses attention wrapper (ref DistributedAttention, layer.py:331).

    ``local_attn(q, k, v) -> out`` runs on ``[B, S_full, H_local, D]``.
    ``__call__`` takes this rank's sequence shard of q/k/v
    ``[B, S_local, H, D]`` and returns its shard of the output; with no
    topology, or a seq axis of one, it is ``local_attn`` itself."""

    def __init__(self, local_attn: Callable,
                 topology: Optional[MeshTopology] = None,
                 scatter_idx: int = 2, gather_idx: int = 1):
        self.local_attn = local_attn
        self.topo = topology or get_topology()
        self.scatter_idx = scatter_idx  # heads dim
        self.gather_idx = gather_idx    # seq dim

    def __call__(self, q, k, v):
        topo = self.topo or get_topology()
        if topo is None or topo.sp_size == 1:
            return self.local_attn(q, k, v)
        sp, h = topo.sp_size, self.scatter_idx
        if q.shape[h] % sp != 0:
            raise ValueError(
                f"query heads ({q.shape[h]}) must be divisible by "
                f"sequence-parallel size {sp} (ref layer.py uneven-heads "
                "fallback)")
        if k.shape[h] % sp != 0:
            # GQA with fewer KV heads than sp ranks: expand KV to the
            # query head count so the head scatter divides evenly (the
            # reference's uneven-head handling, sequence/layer.py:111)
            rep = q.shape[h] // k.shape[h]
            k = k.repeat_interleave(rep, dim=h)
            v = v.repeat_interleave(rep, dim=h)
        group = topo.seq_group
        # [B, S/sp, H, D] -> all-to-all -> [B, S, H/sp, D]
        q_h, k_h, v_h = (single_all_to_all(x, h, self.gather_idx, group)
                         for x in (q, k, v))
        out = self.local_attn(q_h, k_h, v_h)
        # inverse: scatter the sequence, gather the heads
        return single_all_to_all(out, self.gather_idx, h, group)


class UlyssesAttentionHF(DistributedAttention):
    """Alias mirroring the ALST HF integration entry point
    (ref runtime/sequence_parallel/ulysses_sp.py:49)."""
