"""Span tracing, metric registry and flight recorder used by the serving layer."""
