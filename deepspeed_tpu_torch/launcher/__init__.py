from deepspeed_tpu_torch.launcher.spawn import launch

__all__ = ["launch"]
