#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  — the card's name and power limit (nvidia-smi), capability 9.0;
  2. build   — every CUDA kernel built from the sources in this checkout;
  3. kernels — each kernel against its plain PyTorch version on the card
               at the serving path's shapes (llama3-8b attention geometry),
               with its time, the plain version's time and its bound;
  4. reference — llama3-8b at full width, cut to two layers, in fp32: the
               engine's logits on the card against the same engine on the
               CPU (plain attention), step by step;
  5. engine  — InferenceEngineV2 for llama3-8b at full width and depth in
               bf16 (random weights from a seed) generates through the
               kernels, with a bf16 and an int8 KV cache; the launch counts
               of that run show the path went through the kernels; then a
               profiled generate and the kernel path's logits against the
               gather path's;
  6. server  — InferenceServer answers 8 requests from 4 threads.
Then the ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero with no
result; so does a machine without CUDA or a directory without the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

MODEL = "llama3-8b"
ENGINE_CFG = {"memory_config": {"num_blocks": 1024, "block_size": 16},
              "max_context": 2048}
# kernel vs plain version, bf16 output: about two bf16 ulps, relative
KERNEL_RTOL = 2.0 ** -7
# logits through the kernel vs through paged_gather (both bf16 on the
# card): the gather path rounds q.k to bf16 before its softmax, the kernel
# keeps fp32 scores; 32 layers compound that rounding
LOGITS_RTOL = 0.1
# card vs CPU in fp32 (phase 4): the two differ in summation order only
# (cuBLAS vs CPU GEMMs over K up to 14336, kernel vs plain page walk)
REF_LAYERS = 2
REF_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------------
# phase 3: paged attention kernel against its plain version
# ----------------------------------------------------------------------
def quantize_rows(x):
    """int8 rows + fp32 per-row scales, as the engine quantizes on append."""
    import torch

    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q8.to(torch.int8).contiguous(), scale.contiguous()


def make_case(gen, t, nkv, nh, d, bs, num_blocks, nb, kind):
    """Inputs at the serving path's shapes.  ``kind``: decode (ragged
    contexts up to nb*bs, one token each), prefill (a 256-token chunk at
    the end of one 2048-token prompt), window (decode under a sliding
    window), garbage (tables past the context and padding tokens point at
    page 0, which holds huge values that must never leak)."""
    import torch

    dev = "cuda"
    p_rows = num_blocks * bs
    q = torch.randn((t, nh, d), generator=gen, device=dev).bfloat16()
    kp = torch.randn((nkv, p_rows, d), generator=gen, device=dev).bfloat16()
    vp = torch.randn((nkv, p_rows, d), generator=gen, device=dev).bfloat16()
    pages = torch.randint(1, num_blocks, (t, nb), generator=gen, device=dev,
                          dtype=torch.int32)
    if kind == "prefill":
        ctx = nb * bs
        pos = torch.arange(ctx - t, ctx, device=dev, dtype=torch.int32)
        clen = torch.full((t,), ctx, device=dev, dtype=torch.int32)
        pages = pages[:1].expand(t, nb).contiguous()
    else:
        clen = torch.randint(1, nb * bs + 1, (t,), generator=gen, device=dev,
                             dtype=torch.int32)
        pos = clen - 1
    if kind == "garbage":
        kp[:, :bs] = 1e3
        vp[:, :bs] = 1e3
        used = torch.arange(nb, device=dev)[None, :] * bs < clen[:, None]
        pages = torch.where(used, pages, torch.zeros_like(pages))
        pad = slice(t - 4, t)   # padding tokens: slot row of zeros
        pages[pad] = 0
        pos[pad] = 0
        clen[pad] = 0
    window = 512 if kind == "window" else None
    return q, kp, vp, pages.contiguous(), pos.contiguous(), clen.contiguous(), window


def kernel_bound(pages, pos, clen, nkv, nh, d, bs, window, kv_elem, quant,
                 q_bytes):
    """Least time for the call: unique live K/V page bytes (each read
    once) + q + out + tables over the HBM rate, against the data's flops
    (q.k and p.v over every visited key) over the bf16 tensor rate."""
    import torch

    nb = pages.shape[1]
    j = torch.arange(nb, device=pages.device)[None, :]
    j_hi = (pos.long() // bs + 1)[:, None]
    j_lo = torch.zeros_like(j_hi) if window is None else torch.clamp(
        torch.div(pos.long() - (window - 1), bs, rounding_mode="floor"),
        min=0)[:, None]
    live = (j >= j_lo) & (j < j_hi)
    n_pages = int(torch.unique(pages[live]).numel())
    row_bytes = d * kv_elem + (4 if quant else 0)
    kv_bytes = 2 * n_pages * nkv * bs * row_bytes
    io_bytes = 2 * q_bytes + pages.numel() * 4 + 2 * pos.numel() * 4
    keys = int(live.sum()) * bs
    flops = 4.0 * keys * nh * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            kv_bytes + io_bytes)


def phase_kernels(pa, mc, bs, num_blocks):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    nh, nkv, d = mc.num_heads, mc.kv_heads, mc.dim_per_head
    nb = ENGINE_CFG["max_context"] // bs
    scale = 1.0 / d ** 0.5
    summary = {}
    for kind, t in (("decode", 32), ("prefill", 256), ("window", 32),
                    ("garbage", 32)):
        q, kp, vp, pages, pos, clen, window = make_case(
            gen, t, nkv, nh, d, bs, num_blocks, nb, kind)
        kq, ks = quantize_rows(kp)
        vq, vs = quantize_rows(vp)
        for name, args, kw in (
                ("paged_attention", (q, kp, vp), {}),
                ("paged_attention_int8", (q, kq, vq),
                 {"k_scales": ks, "v_scales": vs})):
            call = (lambda fn, a=args, k=kw: fn(
                *a, pages, pos, clen, bs, scale, window, **k))
            out = call(pa.paged_decode_attention)
            torch.cuda.synchronize()
            ref = call(pa.paged_decode_attention_ref)
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            ok = bool(torch.all(diff <= KERNEL_RTOL * (1 + ref.float().abs())))
            finite = bool(torch.isfinite(out.float()).all())
            row = {"phase": "kernel", "kernel": name, "case": kind, "T": t,
                   "nh": nh, "nkv": nkv, "d": d, "bs": bs, "NB": nb,
                   "window": window, "max_abs_err": err,
                   "tolerance": "|k-r| <= 2^-7 * (1 + |r|)", "ok": ok,
                   "finite": finite}
            if kind in ("decode", "prefill"):
                bound, by, nbytes = kernel_bound(
                    pages, pos, clen, nkv, nh, d, bs, window,
                    args[1].element_size(), "k_scales" in kw,
                    q.numel() * q.element_size())
                row.update(
                    ms=cuda_time_ms(lambda: call(pa.paged_decode_attention)),
                    plain_ms=cuda_time_ms(
                        lambda: call(pa.paged_decode_attention_ref), iters=3,
                        warmup=1),
                    bound_ms=bound, bound_by=by, bound_bytes=nbytes,
                    library_ms=None,
                    library_note="no single PyTorch call computes attention "
                                 "over a block table")
                if kind == "decode":
                    summary[name] = row
            emit(row)
            if not (ok and finite):
                fail(f"{name} disagrees with its plain version ({kind})")
    return summary


# ----------------------------------------------------------------------
# phase 4: the card against the CPU on a small input, in fp32
# ----------------------------------------------------------------------
def phase_reference(v2, tf_model, tf, pa, prompts):
    """llama3-8b at full width cut to REF_LAYERS layers, fp32 weights and
    KV: the engine on the card (the kernel's fp32 body and cuBLAS) and the
    same weights on the CPU (the plain attention and CPU matmuls) take the
    same chunked prefill and decode steps; their logits must agree to
    REF_RTOL of the largest logit at every step."""
    import numpy as np
    import torch

    model = tf_model.get_model_config(MODEL, num_layers=REF_LAYERS)
    cfg = {**ENGINE_CFG, "dtype": "float32"}
    card = v2.InferenceEngineV2(model, cfg, seed=1)
    host = v2.InferenceEngineV2(
        model, cfg, device="cpu",
        model_params=tf.tree_map_with_path(lambda _p, a: a.cpu(),
                                           card.params))
    uids = list(range(4))
    batch = [p[:200] for p in prompts[:4]]   # chunked over several steps
    launches0 = pa.paged_decode_attention.launches["paged_attention"]
    worst, agree, steps, full_steps = 0.0, [], 0, 0
    pending = (uids, batch)
    # until two steps in which every sequence decoded; a sequence whose
    # prompt is done decodes beside the others' prefill chunks
    while full_steps < 2:
        if steps == 16:
            fail("reference steps did not reach decode")
        lc, lh = card.put(*pending), host.put(*pending)
        pending = ([], [])
        steps += 1
        if set(lc) != set(lh):
            fail(f"reference step {steps}: card returned {sorted(lc)}, "
                 f"CPU {sorted(lh)}")
        for u in lh:
            a, b = lc[u], lh[u]
            if not (np.isfinite(a).all() and a.shape == (model.vocab_size,)):
                fail("card logits are not finite [vocab]")
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
            agree.append(int(a.argmax()) == int(b.argmax()))
            nxt = int(b.argmax())   # both decode the CPU's token
            card.extend(u, nxt)
            host.extend(u, nxt)
        full_steps += set(lh) == set(uids)
    launched = pa.paged_decode_attention.launches["paged_attention"] - launches0
    emit({"phase": "reference", "model": MODEL, "layers": REF_LAYERS,
          "dtype": "float32", "steps": steps,
          "prompt_tokens": sum(map(len, batch)),
          "check": "card (kernel, cuBLAS) vs CPU (plain version) logits",
          "max_rel_err": worst, "tolerance": REF_RTOL,
          "argmax_agreement": sum(agree) / len(agree),
          "kernel_launches": launched})
    if worst > REF_RTOL:
        fail(f"card logits differ from the CPU's by {worst}")
    if launched != steps * REF_LAYERS:
        fail(f"the card's steps launched the kernel {launched} times")
    del card, host
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 5/6: engine and server on llama3-8b
# ----------------------------------------------------------------------
def phase_engine(pa, tf_model, v2, prompts):
    import torch

    model = tf_model.get_model_config(MODEL)
    counts = pa.paged_decode_attention.launches
    t0 = time.perf_counter()
    eng = v2.InferenceEngineV2(model, ENGINE_CFG, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    new = 64
    launches = {}
    outs = {}
    for kv, engine in (("bf16", eng), ("int8", None)):
        if engine is None:
            cfg = {**ENGINE_CFG, "memory_config": {
                **ENGINE_CFG["memory_config"], "kv_dtype": "int8"}}
            # shares eng's device weights (already bf16: no copy)
            engine = v2.InferenceEngineV2(model, cfg, model_params=eng.params)
        for k in counts:
            counts[k] = 0
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[kv] = dict(counts)
        outs[kv] = out
        ok = (all(len(o) == new for o in out)
              and all(0 <= x < model.vocab_size for o in out for x in o))
        emit({"phase": "engine", "model": MODEL, "layers": model.num_layers,
              "kv_dtype": kv, "prompts": len(prompts),
              "prompt_tokens": sum(map(len, prompts)), "new_tokens": new,
              "wall_s": wall, "launches": launches[kv], "ok": ok,
              "init_s": init_s if kv == "bf16" else None})
        if not ok:
            fail(f"{kv} engine produced malformed tokens")
        if engine is not eng:
            del engine
    if launches["bf16"]["paged_attention"] == 0:
        fail("bf16 engine never launched the paged_attention kernel")
    if launches["int8"]["paged_attention_int8"] == 0:
        fail("int8 engine never launched the paged_attention_int8 kernel")
    agree = sum(a == b for oa, ob in zip(outs["bf16"], outs["int8"])
                for a, b in zip(oa, ob)) / (len(prompts) * new)
    emit({"phase": "engine", "check": "bf16 vs int8 KV greedy agreement",
          "fraction": agree})
    torch.cuda.empty_cache()
    return eng, launches, outs["bf16"]


def phase_profile(eng, prompts, card):
    """Where the time goes in one generate() on the bf16 engine: device
    kernel time by name from torch.profiler, and the device's idle share
    of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    attn_ms = sum(v for k, v in by_name.items() if "paged_attention" in k)
    emit({"phase": "profile", "what": f"generate {len(prompts)} prompts, "
          "32 new tokens, bf16 KV", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "paged_attention_ms": attn_ms,
          "paged_attention_share_of_busy": attn_ms / max(busy_ms, 1e-9),
          "top_kernels_ms": [[k[:90], v] for k, v in top], "card": card})


def phase_logits(v2, tf_model, params, prompts):
    """One ragged prefill step (240 tokens) and one decode step through
    the kernel and through paged_gather on the card, with the same weights
    and inputs, for the bf16 and the int8 KV cache."""
    import numpy as np
    import torch

    model = tf_model.get_model_config(MODEL)
    uids = list(range(1000, 1004))
    batch = [p[:60] for p in prompts[:4]]   # 240 tokens: one prefill step
    for kv in ("bf16", "int8"):
        mem = {**ENGINE_CFG["memory_config"],
               **({"kv_dtype": "int8"} if kv == "int8" else {})}
        pair = [v2.InferenceEngineV2(
            model, {**ENGINE_CFG, "memory_config": mem,
                    "modules": {"attention": attn}}, model_params=params)
            for attn in ("paged_kernel", "paged_gather")]
        worst, agree = 0.0, []
        logits = [e.put(uids, batch) for e in pair]
        for step in ("prefill", "decode"):
            lk, lg = logits
            if set(lk) != set(uids) or set(lg) != set(uids):
                fail(f"logits {step} step returned {sorted(lk)}/{sorted(lg)}")
            for u in uids:
                a, b = lk[u], lg[u]
                if not (np.isfinite(a).all()
                        and a.shape == (model.vocab_size,)):
                    fail("kernel-path logits are not finite [vocab]")
                worst = max(worst, float(np.abs(a - b).max()
                                         / max(np.abs(b).max(), 1e-30)))
                agree.append(int(a.argmax()) == int(b.argmax()))
            if step == "prefill":
                for u in uids:
                    for e in pair:
                        e.extend(u, int(lk[u].argmax()))
                logits = [e.put([], []) for e in pair]
        emit({"phase": "logits", "kv_dtype": kv,
              "check": "kernel vs paged_gather, bf16 compute",
              "max_rel_err": worst, "tolerance": LOGITS_RTOL,
              "argmax_agreement": sum(agree) / len(agree)})
        if worst > LOGITS_RTOL:
            fail(f"{kv} kernel-path logits differ from paged_gather by "
                 f"{worst}")
        del pair
        torch.cuda.empty_cache()


def phase_server(serving, pa, eng, prompts, ref, card):
    import torch

    new = 64
    counts = pa.paged_decode_attention.launches
    for k in counts:
        counts[k] = 0
    srv = serving.InferenceServer(eng).start()
    results = {}
    errors = []

    def worker(i):
        try:
            streams = [(r, srv.submit(prompts[r], serving.SamplingParams(
                max_new_tokens=new))) for r in (2 * i, 2 * i + 1)]
            for r, s in streams:
                results[r] = list(s)
        except Exception as e:  # reported below; the phase then fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    alive = any(th.is_alive() for th in threads)
    srv.stop(drain=not alive, timeout=120)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = srv.metrics.snapshot()
    launches = dict(counts)
    ok = (not alive and not errors and len(results) == 8
          and launches["paged_attention"] > 0
          and all(len(results[r]) == new for r in results)
          and snap["completed"] == 8)
    same = sum(results.get(r) == ref[r] for r in range(8))
    emit({"phase": "server", "requests": 8, "threads": 4,
          "completed": snap["completed"], "errors": errors,
          "ttft_p50_s": snap["ttft"].get("p50"),
          "tpot_p50_s": snap["tpot"].get("p50"),
          "decode_tokens_per_s": snap["tokens_out"] / wall,
          "wall_s": wall, "match_engine_generate": same,
          "launches": launches, "card": card,
          "ok": ok})
    if not ok:
        fail("server did not finish its 8 requests")


def main() -> int:
    if not (ROOT / "deepspeed_tpu_torch").is_dir():
        print("chip_smoke: the deepspeed_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from deepspeed_tpu_torch import serving
    from deepspeed_tpu_torch.inference import v2
    from deepspeed_tpu_torch.models import registry as tf_model
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import paged_attention as pa

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if cap != (9, 0):
        fail(f"capability {cap}, the kernels are built for sm_90a")

    # 2. build
    t0 = time.perf_counter()
    op_builder.build_all()
    emit({"phase": "build", "kernels": list(op_builder.KERNEL_SOURCES),
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for name in op_builder.KERNEL_SOURCES
                    for ln in op_builder.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernels against their plain versions
    mc = tf_model.get_model_config(MODEL)
    bs = ENGINE_CFG["memory_config"]["block_size"]
    summary = phase_kernels(pa, mc, bs,
                            ENGINE_CFG["memory_config"]["num_blocks"])

    # 4. reference, 5. engine, 6. server
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mc.vocab_size,
                            size=int(rng.integers(64, 513))).tolist()
               for _ in range(16)]
    phase_reference(v2, tf_model, tf, pa, prompts)
    eng, launches, ref = phase_engine(pa, tf_model, v2, prompts)
    phase_profile(eng, prompts, smi)
    phase_logits(v2, tf_model, eng.params, prompts)
    phase_server(serving, pa, eng, prompts, ref, smi)

    # 7. kernels line
    replaces = {"paged_attention":
                "deepspeed_tpu/ops/pallas/paged_attention.py:52",
                "paged_attention_int8":
                "deepspeed_tpu/ops/pallas/paged_attention.py:129"}
    launch_run = {"paged_attention": launches["bf16"]["paged_attention"],
                  "paged_attention_int8":
                  launches["int8"]["paged_attention_int8"]}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
         "replaces": replaces[name], "launches": launch_run[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for name, row in summary.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
