"""Rank bodies for ``test_torch_ulysses.py``, run by
``deepspeed_tpu_torch.launcher`` in spawned CPU ranks over gloo.

Spawned ranks import this module afresh, so it imports no JAX (the test
that drives it does) and starts nothing when imported.  Every body returns
numpy arrays and plain Python values.
"""

import numpy as np
import torch


def _topo(world):
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    return MeshTopology({"seq": world})


def _shard(x, rank, world, axis=1):
    n = x.shape[axis] // world
    cut = (slice(None),) * axis + (slice(rank * n, (rank + 1) * n),)
    return x[cut]


def ulysses_engine_runs(rank, world, runs):
    """``torch_mesh_ranks.engine_runs`` over the runs, each run's
    ``all_to_all`` and ``all_gather`` bytes a step beside it."""
    import torch_mesh_ranks
    from deepspeed_tpu_torch.comm import comm

    out = {}
    for run in runs:
        comm.clear_counts()
        out.update(torch_mesh_ranks.engine_runs(rank, world, [run]))
        out[run["name"]]["nbytes"] = {
            k: v // run["steps"] for k, v in comm.nbytes().items()}
    return out


def ring_interleave_repeats(rank, world, cases, repeats):
    """Per case (global q, k, v, w [B, S, H, D] and ``ring_attention``
    keywords but ``interleave``): this rank's output and the gradients of
    ``sum(o * w)`` at interleave 1, then ``repeats`` times at interleave
    2; returns per case the interleave-1 arrays and whether every
    interleave-2 run gave their bits."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.sequence.ring import ring_attention

    topo = _topo(world)

    def run(case, interleave):
        q, k, v = (torch.tensor(_shard(case[n], rank, world)).requires_grad_()
                   for n in ("q", "k", "v"))
        o = ring_attention(q, k, v, topo, interleave=interleave, **case["kw"])
        (o * torch.tensor(_shard(case["w"], rank, world))).sum().backward()
        return [x.detach().numpy() for x in (o, q.grad, k.grad, v.grad)]

    out = []
    for case in cases:
        one = run(case, 1)
        same = all(all(np.array_equal(a, b) for a, b in zip(one, run(case, 2)))
                   for _ in range(repeats))
        out.append({"one": one, "same_bits": same})
    return out


class TinyUlyssesLM:
    """A duck-typed trainable: token and learned position embeddings, one
    pre-norm block whose attention is ``sequence.UlyssesAttentionHF``
    around plain causal attention, and a head; its loss is the mean token
    cross-entropy of the batch it is given.  Positions come from the
    batch's ``position_ids`` (the engine shards them with the tokens)."""

    def __init__(self, vocab=64, hidden=32, heads=4, kv_heads=2, seq=32):
        from deepspeed_tpu_torch.sequence import UlyssesAttentionHF

        self.shape = (vocab, hidden, heads, kv_heads, seq)
        self.attn = UlyssesAttentionHF(self._local_attn)

    @staticmethod
    def _local_attn(q, k, v):
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        s = q.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        return torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)

    def init(self, generator):
        vocab, h, nh, nkv, seq = self.shape
        d = h // nh

        def w(*shape):
            return torch.randn(shape, generator=generator) * 0.1

        return {"tok": w(vocab, h), "pos": w(seq, h), "wq": w(h, nh * d),
                "wk": w(h, nkv * d), "wv": w(h, nkv * d), "wo": w(nh * d, h),
                "w1": w(h, 2 * h), "w2": w(2 * h, h), "head": w(h, vocab)}

    def loss(self, params, batch):
        _vocab, h, nh, nkv, _seq = self.shape
        d = h // nh
        ids = batch["input_ids"].long()
        x = params["tok"][ids] + params["pos"][batch["position_ids"].long()]
        b, s, _ = x.shape
        n = torch.nn.functional.layer_norm(x, (h,))
        q = (n @ params["wq"]).view(b, s, nh, d)
        k = (n @ params["wk"]).view(b, s, nkv, d)
        v = (n @ params["wv"]).view(b, s, nkv, d)
        x = x + self.attn(q, k, v).reshape(b, s, nh * d) @ params["wo"]
        x = x + torch.nn.functional.gelu(x @ params["w1"]) @ params["w2"]
        logits = x @ params["head"]
        return torch.nn.functional.cross_entropy(
            logits.reshape(b * s, -1), batch["labels"].long().reshape(-1))


def duck_typed_steps(rank, world, cfg, batch, steps):
    """``TinyUlyssesLM`` in the port's engine over ``cfg``'s seq axis:
    its losses and grad norms over ``steps`` train_batch calls, and its
    params after them."""
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds

    eng, *_ = ds.initialize(model=TinyUlyssesLM(), config=cfg, device="cpu",
                            seed=3)
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(eng.train_batch(batch)))
        norms.append(eng.get_global_grad_norm())
    return {"losses": losses, "grad_norms": norms,
            "params": {k: v.detach().numpy().copy()
                       for k, v in eng.params.items()}}


def model_shard_loss(rank, world, model_name, model_kw, params, batch,
                     dropout_seed):
    """The built-in model's ``loss_fn(sum_count=True)`` on this rank's
    contiguous shard of ``batch`` over a seq axis of ``world`` (Ulysses),
    with ``dropout_seed``: ``(NLL sum, token count)`` and the gradient of
    the NLL sum in the token embedding."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.models import transformer as tf

    cfg = get_model_config(model_name, **model_kw)
    params = tf.tree_map_with_path(
        lambda _p, x: x.detach().clone().requires_grad_(), params)
    shard = {k: torch.tensor(_shard(v, rank, world)) for k, v in batch.items()}
    shard["dropout_seed"] = dropout_seed
    nll, count = tf.loss_fn(params, shard, cfg, topo=_topo(world),
                            sum_count=True)
    nll.backward()
    return (float(nll.detach()), int(count),
            params["embed"]["tokens"].grad.numpy().copy())


def all_to_all_cases(rank, world, shape, dims):
    """``comm.seq_all_to_all`` of rank-tagged arange tensors of ``shape``
    for each (scatter, gather) of ``dims``: the output, and the gradient
    of ``sum(out * out)`` in the input (the inverse exchange of 2·out)."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm.comm import seq_all_to_all

    out = []
    for scatter, gather in dims:
        x = (torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
             + 1000.0 * rank).requires_grad_()
        y = seq_all_to_all(x, scatter, gather)
        (y * y).sum().backward()
        out.append((y.detach().numpy(), x.grad.numpy()))
    return out


def fpdt_cases(rank, world, q, k, v, w, chunk, offload):
    """``FPDTAttention`` over a seq axis of ``world``: this rank's output
    shard and the gradients of ``sum(o * w)`` in its q/k/v shards."""
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.sequence import FPDTAttention

    qs, ks, vs = (torch.tensor(_shard(x, rank, world)).requires_grad_()
                  for x in (q, k, v))
    o = FPDTAttention(chunk, offload_kv=offload, topology=_topo(world))(
        qs, ks, vs)
    (o * torch.tensor(_shard(w, rank, world))).sum().backward()
    return [x.detach().numpy() for x in (o, qs.grad, ks.grad, vs.grad)]
