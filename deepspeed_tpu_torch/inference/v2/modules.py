"""Pluggable inference-module registry + heuristics.

Copy of ``deepspeed_tpu/inference/v2/modules.py``: analog of the
reference's v2 module system
(``inference/v2/modules/module_registry.py`` — ConfigBundle-keyed
implementation registry — and ``modules/heuristics.py`` — "pick the best
impl for this config/hardware").  The registry maps a module *kind*
("attention", "mlp", "embed", "sampler") to named implementations; the
serve engine resolves each kind once at engine build:

* explicit override: ``InferenceEngineV2(model, {"modules":
  {"attention": "paged_gather"}})`` pins an implementation by name
  (ref ConfigBundle(name=...)), or
* heuristic default (``name="auto"``): the registered ``default_for``
  predicates pick by hardware/shape — the CUDA block-table kernel for
  CUDA tensors when the geometry is servable, the gather path elsewhere
  (ref heuristics.instantiate_attn).

Implementations self-register via :func:`register_module` at import of
their defining module (model.py for the built-ins), so external code can
add implementations without touching the engine.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Dict[str, Dict[str, Any]]] = {}


def register_module(kind: str, name: str,
                    default_for: Optional[Callable[..., bool]] = None):
    """Decorator: register ``fn`` as implementation ``name`` of ``kind``.

    ``default_for(**ctx) -> bool``: heuristic predicate consulted (in
    registration order) when resolving ``"auto"`` — first True wins; a
    registration without a predicate is the fallback.
    """

    def deco(fn):
        _REGISTRY.setdefault(kind, {})[name] = {
            "impl": fn, "default_for": default_for}
        return fn

    return deco


def available(kind: str):
    """Registered implementation names for ``kind``."""
    return tuple(_REGISTRY.get(kind, {}))


def resolve(kind: str, name: str = "auto", **ctx):
    """Resolve ``kind`` to an implementation callable.

    ``name="auto"`` walks the heuristics; an explicit name must exist in
    the registry (ref module_registry raises on unknown ConfigBundle).
    """
    impls = _REGISTRY.get(kind)
    if not impls:
        raise KeyError(f"no implementations registered for '{kind}'")
    if name != "auto":
        if name not in impls:
            raise KeyError(
                f"unknown {kind} implementation '{name}' "
                f"(available: {', '.join(impls)})")
        return impls[name]["impl"]
    fallback = None
    for entry in impls.values():
        pred = entry["default_for"]
        if pred is None:
            fallback = entry["impl"] if fallback is None else fallback
        elif pred(**ctx):
            return entry["impl"]
    if fallback is None:
        raise KeyError(f"no default implementation for '{kind}'")
    return fallback


def module_overrides(config: Optional[Dict[str, Any]]) -> Dict[str, str]:
    """Normalize the engine config's ``"modules"`` block to kind→name."""
    out = {}
    for kind, name in ((config or {}).get("modules") or {}).items():
        out[str(kind)] = str(name)
    return out
