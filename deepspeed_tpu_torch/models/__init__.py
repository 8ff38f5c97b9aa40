from deepspeed_tpu_torch.models.registry import get_model_config, list_models, register
from deepspeed_tpu_torch.models.transformer import TransformerConfig, init_params
