from deepspeed_tpu_torch.elasticity.elasticity import (
    ElasticityConfig, ElasticityError, ElasticityConfigError,
    ElasticityIncompatibleWorldSize, compute_elastic_config,
    elasticity_enabled, ensure_immutable_elastic_config,
    get_compatible_gpus_v01, get_valid_gpus)
from deepspeed_tpu_torch.elasticity.elastic_agent import (DSElasticAgent,
                                                          WorkerSpec,
                                                          start_group,
                                                          stop_group)
