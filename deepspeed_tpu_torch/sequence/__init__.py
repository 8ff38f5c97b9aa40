"""Sequence parallelism and long context: Ulysses (``layer``), FPDT
(``fpdt``), ALST's tiled compute (``alst``) and ring attention
(``ring``)."""

from deepspeed_tpu_torch.sequence.layer import (DistributedAttention,
                                                UlyssesAttentionHF,
                                                single_all_to_all)
from deepspeed_tpu_torch.sequence.fpdt import (FPDTAttention,
                                               chunked_attention,
                                               chunked_ffn)
from deepspeed_tpu_torch.sequence.alst import (SPDataLoader, sp_shard_batch,
                                               tiled_logits_loss, tiled_mlp)

__all__ = [
    "DistributedAttention", "UlyssesAttentionHF", "single_all_to_all",
    "FPDTAttention", "chunked_attention", "chunked_ffn",
    "SPDataLoader", "sp_shard_batch", "tiled_logits_loss", "tiled_mlp",
]
