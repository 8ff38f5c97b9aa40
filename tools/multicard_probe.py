#!/usr/bin/env python3
"""The port's training steps over NCCL, one H100 a rank.

    python3 tools/multicard_probe.py [--steps 2] [--out build/multicard_probe.jsonl] [--only commquant|zeropp]

Needs four CUDA cards.  Runs, each in ranks started by
``deepspeed_tpu_torch.launcher.launch(..., backend="nccl")``:

* ``chip_smoke.py``'s ring-train step (llama3-8b width, 2 layers, seq 8192
  striped, bf16, ZeRO-2 over the seq axis) at ``{"seq": 2}`` on two cards
  (only the backend differs from the script's one-card gloo run), with
  the flat buckets and with per-leaf calls (``reduce_bucket_size`` 1);
* the same step at ``{"data": 2, "seq": 2}`` on four cards;
* ``chip_smoke.py``'s ZeRO-3 fused gpt2-350m step (``ZERO_CFG``, gas 2) at
  data 2 and at data 4, for each ``gather_prefetch_depth`` of 1 and 2 and
  each ``reduce_bucket_size`` of 1 (the per-leaf reduce-scatter), one
  layer's elements and the default 500,000,000 (one bucket a backward);
* ``chip_smoke.py``'s dp-quant-train step (bench.py's
  row_gpt2_350m_commquant: gpt2-350m, ZeRO-1, gas 2) at data 4 with
  ``grad_reduce`` int8 (error feedback) and with the explicit fp32 wire,
  its control (``--only commquant`` runs these alone), with the bytes a
  step of each op name (``comm.nbytes()``);
* ``chip_smoke.py``'s ZeRO-3 gpt2-350m step (``ZERO_CFG`` without the
  fused gather-matmul, which hpZ and MiCS refuse; gather depth 2) at data
  4: plain, hpZ 2 and MiCS 2 (``--only zeropp`` runs these alone), with
  the collectives and bytes a step by group (inner, outer, world).

For each: the first step's seconds on a line of its own (NCCL makes a
group's communicator at its first collective), the seconds of the timed
steps (the slower rank's), tokens/s, peak memory a rank, the collectives
issued a step (``comm.calls()``: reduce-scatters, all-gathers,
all-reduces), and from one profiled step on rank 0: device busy (the union
of every stream's kernels) and idle share, the device ms of the NCCL
kernels (``nccl*``, read from the raw kineto events) and of each ported
kernel, the compute kernels' ms that overlap NCCL kernels, and the host
ms in the comm layer's ranges, and the NCCL kernels' device ms by the
group of the collective that launched them (``comm.group.<name>``).
Prints one JSON line a run, the cards' ``nvidia-smi`` lines first; writes
the same lines to ``--out``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

COLLECTIVES = ("comm.ring_rotate", "comm.reduce_scatter", "comm.all_gather",
               "comm.all_reduce")
KERNELS = ("ring_carry", "ring_bwd_dq", "ring_bwd_dkv", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "fused_adamw", "gather_matmul")


def _union_ms(spans):
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def _overlap_ms(spans, others):
    """ms of ``spans`` (merged) that lie inside ``others`` (merged)."""
    def merged(xs):
        out = []
        for a, b in sorted(xs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    a_list, b_list = merged(spans), merged(others)
    i = j = ns = 0
    while i < len(a_list) and j < len(b_list):
        lo = max(a_list[i][0], b_list[j][0])
        hi = min(a_list[i][1], b_list[j][1])
        ns += max(0, hi - lo)
        if a_list[i][1] < b_list[j][1]:
            i += 1
        else:
            j += 1
    return ns / 1e6


def _nccl_ms_by_group(prof):
    """Device ms of the NCCL kernels by the group of the collective that
    issued them: a kernel's launch (the host event of its correlation id)
    lies inside that collective's ``comm.group.<name>`` range."""
    from torch.autograd import DeviceType

    ranges, launched, kernels = [], {}, []
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("comm.group."):
                ranges.append((e.start_ns(), e.end_ns(),
                               e.name()[len("comm.group."):]))
            elif corr and e.name().startswith("cu"):   # the launch API
                launched[corr] = e.start_ns()
        elif e.name().startswith("nccl") and not e.is_user_annotation():
            # (a range's device-side copy, nccl:<op>, is no kernel)
            kernels.append((corr, e.end_ns() - e.start_ns()))
    out = {}
    for corr, ns in kernels:
        t = launched.get(corr)
        name = next((g for a, b, g in ranges if t is not None and a <= t <= b),
                    "unattributed")
        out[name] = out.get(name, 0.0) + ns / 1e6
    return out


def profile_step(step):
    """One ``step()`` under torch.profiler, read from its raw kineto
    events: wall ms, device busy ms over every stream, NCCL ms, compute
    ms overlapping NCCL, the ported kernels' ms, host ms in the comm
    ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = cs.trace_events(prof)
    dev = [(n, a, b) for n, a, b, on_dev, ann in events
           if on_dev and not ann and b > a]
    nccl = [(a, b) for n, a, b in dev if n.startswith("nccl")]
    compute = [(a, b) for n, a, b in dev
               if not n.startswith(("nccl", "Memcpy", "Memset"))]
    by_name = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    busy = _union_ms([(a, b) for _n, a, b in dev])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "compute_busy_ms": _union_ms(compute),
            "nccl_ms": sum((b - a) for a, b in nccl) / 1e6,
            "nccl_busy_ms": _union_ms(nccl),
            "compute_under_nccl_ms": _overlap_ms(compute, nccl),
            "nccl_kernels_ms": {n[:80]: v for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1]) if n.startswith("nccl")},
            "memcpy_ms": sum(v for n, v in by_name.items()
                             if n.startswith("Memcpy")),
            "kernel_ms": {k: sum(v for n, v in by_name.items()
                                 if all(x in n for x in cs.PROFILE_NAMES[k]))
                          for k in KERNELS},
            "gemm_ms": sum(v for n, v in by_name.items()
                           if any(x in n for x in ("gemm", "nvjet", "cutlass",
                                                   "xmma"))),
            "nccl_ms_by_group": _nccl_ms_by_group(prof),
            "collectives": cs.comm_ms(events, names=COLLECTIVES)}


def probe_rank(rank, world, cases, steps):
    """One rank: per case (``name``, ``model_kw``, ``model``, ``cfg``,
    ``seq``), the engine on this rank's card, a first step, ``steps``
    timed steps, one profiled on rank 0 (the others step beside it)."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.ops import flash_mha as fm
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    from deepspeed_tpu_torch.ops import gather_matmul as tgm
    from deepspeed_tpu_torch.ops import quantize as qk

    counters = (fm.flash_mha.launches, fm.ring_launches,
                fo.fused_adamw.launches, tgm.gemm.launches, qk.launches)
    out = []
    for case in cases:
        model = registry.get_model_config(case["model"], **case["model_kw"])
        cfg = case["cfg"]
        eng, *_ = ds.initialize(model=model, config=cfg, seed=0)
        dp = eng.topology.dp_size
        rows = (cfg["train_micro_batch_size_per_gpu"]
                * cfg["gradient_accumulation_steps"] * dp)
        batch = cs.train_batch_of(model.vocab_size, rows, seed=0,
                                  seq=case["seq"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(eng.train_batch(batch))]
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        cs.zero_counts(*counters)
        comm.clear_counts()
        step_s = []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch(batch)))
            step_s.append(time.perf_counter() - t0)
        res = {"name": case["name"], "rank": rank, "backend": dist.get_backend(),
               "device": str(eng.device), "first_step_s": first_s,
               "step_s": step_s, "losses": losses, "tokens_per_step":
               rows * case["seq"], "grad_buckets": eng.grad_bucket_count,
               "zero": [eng.topology.rank, eng.topology.world_size],
               "launches_per_step": {k: v / steps for c in counters
                                     for k, v in c.items() if v},
               "collective_calls_per_step": {k: v / steps for k, v in
                                             comm.calls().items()},
               "bytes_per_step": {k: v / steps for k, v in
                                  comm.nbytes().items()},
               "calls_per_step_by_group": {
                   g: {k: v / steps for k, v in ops.items()}
                   for g, ops in comm.group_calls.items()},
               "bytes_per_step_by_group": {
                   g: {k: v / steps for k, v in ops.items()}
                   for g, ops in comm.group_nbytes.items()},
               "secondary": eng._secondary_mode,
               "stage3_buckets_per_micro_step": eng.stage3_buckets,
               "gather_prefetch_depth": eng._prefetch_depth,
               "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30}
        if rank == 0:
            res["profile"] = profile_step(lambda: eng.train_batch(batch))
        else:
            eng.train_batch(batch)
        out.append(res)
        del eng
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def layer_elements() -> int:
    """One gpt2-350m layer's elements: the gradients a layer's backward
    hands the stage-3 reducer."""
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.models import transformer as tf

    one = registry.get_model_config(cs.TRAIN_MODEL).replace(num_layers=1)
    params = tf.init_params(one, device="cpu")
    return sum(x.numel() for x in tf.tree_leaves(params["layers"]))


def commquant_cases(world):
    """dp-quant-train's int8 run and its fp32-wire control at ``world``."""
    return [{"name": f"commquant-data{world}-{wire}", "model": cs.TRAIN_MODEL,
             "model_kw": {}, "seq": cs.TRAIN_SEQ,
             "cfg": {**cs.DPQ_CFG, **cs.DPQ_RUNS[wire],
                     "mesh": {"data": world}}} for wire in ("int8", "fp32")]


def zeropp_cases():
    """ZeRO-3 on gpt2-350m at data 4, unfused (hpZ and MiCS refuse the
    fused gather-matmul): plain, hpZ 2, MiCS 2."""
    base = {**cs.ZERO_CFG, "mesh": {"data": 4},
            "step_schedule": {"gather_prefetch_depth": 2}}
    return [{"name": f"zeropp-data4-{name}", "model": cs.TRAIN_MODEL,
             "model_kw": {}, "seq": cs.TRAIN_SEQ,
             "cfg": {**base, "zero_optimization": {
                 **base["zero_optimization"], **extra}}}
            for name, extra in (("plain", {}),
                                ("hpz2", {"zero_hpz_partition_size": 2}),
                                ("mics2", {"mics_shard_size": 2}))]


def cases_for(world, layer):
    """The runs of ``world`` ranks; ``layer``: one layer's elements."""
    ring_kw = cs.RING_MODEL_KW

    def bucket(cfg, size):
        return {**cfg, "zero_optimization": {**cfg["zero_optimization"],
                                             "reduce_bucket_size": size}}

    def depth(cfg, d):
        return {**cfg, "step_schedule": {**cfg["step_schedule"],
                                         "gather_prefetch_depth": d}}

    zero = {**cs.ZERO_CFG, "mesh": {"data": world}}
    zeros = [{"name": f"zero3-data{world}-depth{d}-{name}",
              "model": cs.TRAIN_MODEL, "model_kw": {},
              "cfg": bucket(depth(zero, d), size), "seq": cs.TRAIN_SEQ}
             for d in (1, 2)
             for name, size in (("per-leaf", 1), ("one-layer", layer),
                                ("default", 500_000_000))]
    if world == 2:
        ring = {**cs.RING_CFG, "mesh": {"seq": 2}}
        return [{"name": "ring-seq2", "model": cs.RING_MODEL,
                 "model_kw": ring_kw, "cfg": ring, "seq": cs.RING_SEQ},
                {"name": "ring-seq2-per-leaf", "model": cs.RING_MODEL,
                 "model_kw": ring_kw, "cfg": bucket(ring, 1),
                 "seq": cs.RING_SEQ}] + zeros
    ring = {**cs.RING_CFG, "mesh": {"data": 2, "seq": 2}}
    return [{"name": "ring-data2xseq2", "model": cs.RING_MODEL,
             "model_kw": ring_kw, "cfg": ring, "seq": cs.RING_SEQ}] + zeros


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "multicard_probe.jsonl"))
    ap.add_argument("--only", choices=("all", "commquant", "zeropp"),
                    default="all")
    args = ap.parse_args()
    import torch

    if torch.cuda.device_count() < 4:
        print("multicard_probe: needs four CUDA devices", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.ops import op_builder

    lines = []

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        lines.append(line)

    emit({"cards": subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines(),
        "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    op_builder.build_all()     # in the parent, before the ranks
    emit({"build_s": time.perf_counter() - t0})
    layer = layer_elements() if args.only == "all" else None
    for world in (2, 4):
        cases = cases_for(world, layer) if args.only == "all" else []
        if world == 4 and args.only in ("all", "commquant"):
            cases += commquant_cases(world)
        if world == 4 and args.only in ("all", "zeropp"):
            cases += zeropp_cases()
        if not cases:
            continue
        t0 = time.perf_counter()
        ranks = launch(probe_rank, world, args=(cases, args.steps),
                       backend="nccl", device="cuda")
        emit({"world": world, "launch_s": time.perf_counter() - t0})
        for i, case in enumerate(cases):
            per = [r[i] for r in ranks]
            step_s = [max(r["step_s"][j] for r in per)
                      for j in range(args.steps)]
            tokens = per[0]["tokens_per_step"]
            emit({"run": case["name"], "ranks": world,
                  "backends": [r["backend"] for r in per],
                  "mesh": case["cfg"]["mesh"],
                  "zero_stage": case["cfg"]["zero_optimization"]["stage"],
                  "reduce_bucket_size": case["cfg"]["zero_optimization"].get(
                      "reduce_bucket_size", 500_000_000),
                  "gather_prefetch_depth": per[0]["gather_prefetch_depth"],
                  "grad_buckets": per[0]["grad_buckets"],
                  "stage3_buckets_per_micro_step":
                      per[0]["stage3_buckets_per_micro_step"],
                  "first_step_s": [r["first_step_s"] for r in per]})
            emit({"run": case["name"], "step_s": step_s,
                  "tokens_per_step": tokens,
                  "tokens_per_s": tokens * args.steps / sum(step_s),
                  "losses": per[0]["losses"],
                  "losses_equal_on_ranks": all(r["losses"] == per[0]["losses"]
                                               for r in per),
                  "max_memory_allocated_gib": [r["max_memory_allocated_gib"]
                                               for r in per],
                  "launches_per_step_rank0": per[0]["launches_per_step"],
                  "collective_calls_per_step_rank0":
                      per[0]["collective_calls_per_step"],
                  "bytes_per_step_rank0": per[0]["bytes_per_step"],
                  "secondary": per[0]["secondary"],
                  "calls_per_step_by_group_rank0":
                      per[0]["calls_per_step_by_group"],
                  "bytes_per_step_by_group_rank0":
                      per[0]["bytes_per_step_by_group"],
                  "profile_rank0": per[0]["profile"]})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
