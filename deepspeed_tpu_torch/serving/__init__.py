"""deepspeed_tpu_torch.serving — MII-style async serving over InferenceEngineV2.

The server, admission, metrics and prefix cache of ``deepspeed_tpu.serving``;
the router, replica, disaggregation, fleet and supervisor tiers follow in a
later slice (ROADMAP Queue A item 6).
"""

from deepspeed_tpu_torch.serving.admission import (BROWNOUT_LEVELS,
                                                   AdmissionConfig,
                                                   AdmissionController,
                                                   BrownoutConfig,
                                                   BrownoutController,
                                                   brownout_index)
from deepspeed_tpu_torch.serving.metrics import (RouterMetrics, ServingMetrics,
                                                 spec_accept_rate)
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache, PrefixCacheConfig
from deepspeed_tpu_torch.serving.request import (DeadlineExceeded,
                                                 GenerationRequest, QueueFull,
                                                 RequestCancelled, RequestShed,
                                                 ResponseStream, SamplingParams,
                                                 ServingError)
from deepspeed_tpu_torch.serving.server import InferenceServer, ServerConfig

__all__ = [
    "AdmissionConfig", "AdmissionController", "BROWNOUT_LEVELS",
    "BrownoutConfig", "BrownoutController", "DeadlineExceeded",
    "GenerationRequest", "InferenceServer", "PrefixCache",
    "PrefixCacheConfig", "QueueFull", "RequestCancelled", "RequestShed",
    "ResponseStream", "RouterMetrics", "SamplingParams", "ServerConfig",
    "ServingError", "ServingMetrics", "brownout_index", "spec_accept_rate",
]
