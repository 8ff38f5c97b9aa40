"""Fault injection for the serving layer (copy of deepspeed_tpu.resilience.chaos)."""
