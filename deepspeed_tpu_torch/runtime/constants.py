"""Config key names and defaults the port's training path reads.

The subset of ``deepspeed_tpu/runtime/constants.py`` (itself the
reference's ``deepspeed/runtime/constants.py`` key surface) that
``runtime/config.py`` of the port parses, so a DeepSpeed JSON config is
read unchanged.
"""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
MUON_OPTIMIZER = "muon"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
# the names the engine's compressed data-parallel step takes ("0/1adam"
# the JAX engine's spelling of ZeroOneAdam)
ONEBIT_OPTIMIZERS = (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                     ZERO_ONE_ADAM_OPTIMIZER, "0/1adam")

FP16 = "fp16"
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"

ZERO_OPTIMIZATION = "zero_optimization"
ACTIVATION_CHECKPOINTING = "activation_checkpointing"

GRADIENT_CLIPPING = "gradient_clipping"
STEPS_PER_PRINT = "steps_per_print"
DATALOADER_DROP_LAST = "dataloader_drop_last"

MESH = "mesh"
TENSOR_PARALLEL = "tensor_parallel"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
PIPELINE = "pipeline"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"

STEPS_PER_PRINT_DEFAULT = 10
GRADIENT_ACCUMULATION_STEPS_DEFAULT = 1
GRADIENT_CLIPPING_DEFAULT = 0.0
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal_checkpoint"
