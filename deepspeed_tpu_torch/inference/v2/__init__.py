from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig,
                                                  build_engine)
from deepspeed_tpu_torch.inference.v2.ragged import (BlockedAllocator, DSStateManager,
                                               KVCacheExhausted, RaggedBatch,
                                               SequenceDescriptor,
                                               build_ragged_batch)
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler
