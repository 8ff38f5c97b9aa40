"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA Hopper.

The JAX package ``deepspeed_tpu`` stays the reference; this package grows
beside it slice by slice (ROADMAP.md).  It imports ``torch``, never
``jax`` and nothing of ``deepspeed_tpu``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
