"""Checkpoints of the port's engine: the pickle engine (``engine.py``), the
fast and decoupled writers (``fast_engine.py``) and the universal format
(``universal.py``), each readable by the JAX package's counterpart."""
