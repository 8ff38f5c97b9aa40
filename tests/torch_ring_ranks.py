"""Rank bodies for the ring tests (``test_torch_ring_attention.py``,
``test_torch_ring_engine.py``), run by ``deepspeed_tpu_torch.launcher``
in spawned CPU ranks over gloo.

Spawned ranks import this module afresh, so it imports no JAX (the tests
that drive it do) and starts nothing when imported.  Every body returns
numpy arrays and plain Python values.
"""

import numpy as np
import torch


def ring_attention_cases(rank, world, cases):
    """``cases``: dicts with the GLOBAL q, k, v and the cotangent w
    ([B, S, H, D] numpy, already in the placement's order) and the
    ``ring_attention`` keywords.  Returns per case this rank's output shard
    and the gradients of ``sum(o * w)`` in q, k and v."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.parallel.topology import MeshTopology
    from deepspeed_tpu_torch.sequence.ring import ring_attention

    topo = MeshTopology({"seq": world})
    out = []
    for case in cases:
        s_l = case["q"].shape[1] // world
        cut = slice(rank * s_l, (rank + 1) * s_l)
        q, k, v = (torch.tensor(case[n][:, cut]).requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = ring_attention(q, k, v, topo, **case["kw"])
        (o * torch.tensor(case["w"][:, cut])).sum().backward()
        out.append([x.detach().numpy() for x in (o, q.grad, k.grad, v.grad)])
    return out


def ring_engine_steps(rank, world, model_name, params, batch, cfg, steps,
                      placements):
    """The port's engine over a seq axis of ``world`` ranks, one engine per
    placement from the same params: its losses and grad norms over
    ``steps`` train_batch calls, its eval loss, and its params after
    them.  Also the model-level rejections of the ring branch."""
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.models import transformer as tf

    out = {}
    for placement in placements:
        model = get_model_config(model_name, seq_impl="ring",
                                 ring_placement=placement)
        eng, *_ = ds.initialize(model=model, config=cfg, device="cpu",
                                model_parameters=params)
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(eng.train_batch(batch)))
            norms.append(eng.get_global_grad_norm())
        evl = float(eng.eval_batch({k: v[:2] for k, v in batch.items()}))
        out[placement] = {"losses": losses, "grad_norms": norms, "eval": evl,
                          "params": tf.tree_map_with_path(
                              lambda _p, x: x.detach().numpy().copy(),
                              eng.params)}
    out["wire"] = eng.model_config.ring_wire_dtype
    # the ring branch's rejections, as the JAX model raises them
    eng_params = tf.tree_map_with_path(lambda _p, x: x.detach(), eng.params)
    ids = torch.tensor(np.asarray(batch["input_ids"])[:1, :8])
    errors = {}
    for name, replace, extra in (
            ("sparse", {"attn_impl": "sparse",
                        "sparse_attention": {"mode": "fixed", "block": 4}}, {}),
            ("alibi", {"use_alibi": True}, {}),
            ("mask", {}, {"attention_mask": torch.ones_like(ids)})):
        try:
            tf.forward(eng_params, ids, eng.model_config.replace(**replace),
                       topo=eng.topology, **extra)
        except NotImplementedError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def rotate_payloads(rank, world, arrays):
    """``comm.ring_rotate`` of this rank's copy of ``arrays`` (each array's
    values plus the rank, in its dtype): what arrives from the previous
    rank."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm.comm import ring_rotate

    sent = [torch.tensor(a) + rank for a in arrays]
    return [x.numpy() for x in ring_rotate(sent)]


def failing_rank(rank, world):
    """Rank 1 raises; rank 0 returns."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank
