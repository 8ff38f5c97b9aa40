"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA Hopper.

The JAX package ``deepspeed_tpu`` stays the reference; this package grows
beside it slice by slice (ROADMAP.md).  It imports ``torch``, never
``jax`` and nothing of ``deepspeed_tpu``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_config
    engine, optimizer, _, lr_scheduler = ds.initialize(
        model=get_model_config("gpt2-350m"), config="ds_config.json")
    loss = engine.train_batch(batch)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union


def initialize(args=None,
               model: Any = None,
               optimizer: Any = None,
               model_parameters: Any = None,
               training_data: Any = None,
               lr_scheduler: Any = None,
               mpu: Any = None,
               collate_fn: Any = None,
               config: Union[str, Dict[str, Any], None] = None,
               config_params: Union[str, Dict[str, Any], None] = None,
               mesh_param=None,
               seed: Optional[int] = None,
               device=None):
    """Initialize the training engine, as ``deepspeed_tpu.initialize``.

    Returns the reference's 4-tuple ``(engine, optimizer, dataloader,
    lr_scheduler)``.  The reference's ``distributed_port`` and
    ``dist_init_required`` are not taken: ``initialize`` starts no process
    group; a config whose mesh is above one rank (a ``data`` or ``seq``
    axis) needs one already initialised, as the ranks that
    ``deepspeed_tpu_torch.launcher.launch`` starts have.  ``model`` is a :class:`TransformerConfig` from the
    model registry, or a duck-typed trainable with ``init(generator) ->
    params`` and ``loss(params, batch) -> scalar`` (for example LoRA
    adapters over ``linear.OptimizedLinear`` layers with quantized frozen
    bases); ``model_parameters`` may carry a param tree (for example
    ``models.bridge.params_from_jax`` of a JAX engine's params), which
    overrides ``init``.
    ``device=None`` means the CUDA card, and raises without one; pass
    ``device="cpu"`` to train on the CPU through the kernels' plain
    versions."""
    from deepspeed_tpu_torch.runtime.config import not_ported
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    config = config if config is not None else config_params
    if args is not None and config is None:
        config = getattr(args, "deepspeed_config", None)
    if mpu is not None or mesh_param is not None:
        raise not_ported("a model-parallel unit or mesh",
                         "Queue A item 10")
    engine = DeepSpeedEngine(model=model, config=config,
                             model_params=model_parameters,
                             optimizer=optimizer, lr_scheduler=lr_scheduler,
                             seed=seed, device=device)
    dataloader = None
    if training_data is not None:
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

        dataloader = DeepSpeedDataLoader(
            training_data, batch_size=engine.train_batch_size_value,
            collate_fn=collate_fn,
            drop_last=engine.config.dataloader_drop_last)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler
