"""Rank bodies for ``test_torch_checkpoint.py``, run by
``deepspeed_tpu_torch.launcher`` in spawned CPU ranks over gloo.

Spawned ranks import this module afresh, so it imports no JAX (the tests
that drive it do) and starts nothing when imported.  Every body returns
plain Python values.
"""

import torch


def save_and_resume(rank, world, run):
    """``run``: ``model`` (registry name) and ``model_kw``, ``params`` (a full tree of CPU
    tensors), ``cfg``, ``batch``, ``steps`` and ``ckpt`` (a directory every
    rank sees).  Trains ``steps`` steps, saves through the pickle engine
    (then converts it to universal, every rank taking part) and the fast
    engine, trains ``steps`` more; then, for each saved form, builds a
    fresh engine of another seed, loads it and trains the same steps.
    Returns the losses after the save and each form's resumed losses."""
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.checkpoint.fast_engine import FastCheckpointEngine
    from deepspeed_tpu_torch.checkpoint.universal import (ds_to_universal,
                                                          load_universal)
    from deepspeed_tpu_torch.models import get_model_config

    model = get_model_config(run["model"], **run.get("model_kw", {}))
    ckpt = run["ckpt"]

    def engine(seed, params=None):
        eng, *_ = ds.initialize(model=model, config=run["cfg"], device="cpu",
                                model_parameters=params, seed=seed)
        return eng

    def steps(eng):
        return [float(eng.train_batch(run["batch"]))
                for _ in range(run["steps"])]

    eng = engine(5, run["params"])
    steps(eng)
    eng.save_checkpoint(ckpt, tag="pickle")
    ds_to_universal(ckpt, tag="pickle", engine=eng)
    FastCheckpointEngine().save(eng, ckpt, "fast")
    after = steps(eng)
    resumed = {}
    for form in ("pickle", "fast", "universal"):
        e2 = engine(99)
        if form == "pickle":
            e2.load_checkpoint(ckpt, tag="pickle")
        elif form == "fast":
            FastCheckpointEngine().load(e2, ckpt, "fast")
        else:
            load_universal(e2, f"{ckpt}/pickle/universal")
        assert e2.global_steps == run["steps"]
        resumed[form] = steps(e2)
    return {"after": after, "resumed": resumed}
