#!/usr/bin/env python3
"""Planted faults against chip_smoke.py's dp-quant-reference bounds.

    python3 tools/dp_quant_faults.py [--device cuda|cpu] [--out build/dp_quant_faults.jsonl]

Runs the dp-quant-reference phase's model, batch, steps and configs
(``chip_smoke.dpq_reference_setup``: gpt2-350m width, 2 layers, fp32,
seq 32, two steps over two gloo ranks) for the 1-bit optimizers and qgZ:
two ranks on the CPU with nothing changed (the phase's reference), and
two ranks on ``--device`` once sound and once a planted fault, each read
as the phase reads its card (``chip_smoke.dpq_reference_readings``: the
loss's relative error and the params' distance over the update's L2
norm, on the held leaves and on the whole tree) beside the phase's bound.

The faults, each planted in the ranks under test only:

* ``drop_peer``: the scales received from the other rank zeroed in the
  all-to-all (its momentum, or for qgZ its gradient chunk, left out of
  the mean);
* ``scales_swapped``: the received scales applied to the other source's
  signs (1-bit optimizers);
* ``server_error_zeroed``: the new server error dropped (1-bit
  optimizers; the phase's one compressed step never reads it, so this
  reading shows what the phase cannot see);
* ``int4_wire``: qgZ's int8 wire at the int4 range (qmax 7), a
  lower-precision control.

Prints one JSON line a (config, fault), the card's ``nvidia-smi`` line
first on the card, and writes the same lines to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ONEBIT = ("OnebitAdam", "OnebitLamb", "ZeroOneAdam")
FAULTS = {**{name: ("sound", "drop_peer", "scales_swapped",
                    "server_error_zeroed") for name in ONEBIT},
          "qgz": ("sound", "drop_peer", "int4_wire")}


class _FaultyComm:
    """``comm`` with the received fp32 rows of ``all_to_all`` (the
    scales, a row a source rank) zeroed but this rank's, or reversed."""

    def __init__(self, real, fault):
        self._real, self._fault = real, fault

    def __getattr__(self, name):
        return getattr(self._real, name)

    def all_to_all(self, x, scatter_dim=0, gather_dim=0, group=None):
        import torch
        import torch.distributed as dist

        out = self._real.all_to_all(x, scatter_dim, gather_dim, group)
        if out.dtype != torch.float32:
            return out
        rows = out.reshape(out.shape[0], -1)
        if self._fault == "drop_peer":
            keep = torch.zeros_like(rows)
            keep[dist.get_rank(group)] = 1.0
            rows = rows * keep
        else:
            rows = rows.flip(0)
        return rows.reshape(out.shape)


def _plant(fault):
    """Plant ``fault``; returns the function that takes it out."""
    from deepspeed_tpu_torch.comm import compressed as cp
    from deepspeed_tpu_torch.comm import quantized as tq
    from deepspeed_tpu_torch.ops import quantize as qk
    from deepspeed_tpu_torch.runtime import onebit

    undo = []

    def patch(mod, name, value):
        undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    if fault in ("drop_peer", "scales_swapped"):
        patch(cp, "comm", _FaultyComm(cp.comm, fault))
        patch(tq, "comm", _FaultyComm(tq.comm, fault))
    elif fault == "server_error_zeroed":
        real = onebit.compressed_allreduce

        def dropped(*args, **kw):
            out, werr, serr = real(*args, **kw)
            return out, werr, serr * 0.0

        patch(onebit, "compressed_allreduce", dropped)
    elif fault == "int4_wire":
        real_qmax = qk.qmax_of
        patch(qk, "qmax_of", lambda bits: 7.0 if bits == 8 else
              real_qmax(bits))

    def restore():
        for mod, name, value in reversed(undo):
            setattr(mod, name, value)

    return restore


def fault_rank(rank, world, model_kw, params, configs, batch, steps, device,
               threads):
    """One rank under test: every (config, fault) of FAULTS in turn, each
    through ``chip_smoke.dpq_rank_reference``."""
    out = {}
    for name, faults in FAULTS.items():
        for fault in faults:
            restore = _plant(fault)
            try:
                res = cs.dpq_rank_reference(
                    rank, world, model_kw, params, {name: configs[name]},
                    batch, steps, device, threads)
            finally:
                restore()
            out[(name, fault)] = res[name]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "dp_quant_faults.jsonl"))
    args = ap.parse_args()
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.models import registry
    from deepspeed_tpu_torch.models import transformer as tf

    lines = []
    if args.device == "cuda":
        lines.append({"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()})
    model_kw, configs, params, batch = cs.dpq_reference_setup(registry, tf)
    configs = {name: configs[name] for name in FAULTS}
    threads = max(1, (os.cpu_count() or 2) // (2 * cs.DPQ_RANKS))
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(launch, cs.dpq_rank_reference, cs.DPQ_RANKS,
                              args=(model_kw, params, configs, batch,
                                    cs.DPQ_REF_STEPS, "cpu", threads),
                              backend=cs.DPQ_BACKEND, device="cpu")
        tested = launch(fault_rank, cs.DPQ_RANKS,
                        args=(model_kw, params, configs, batch,
                              cs.DPQ_REF_STEPS, args.device,
                              threads if args.device == "cpu" else None),
                        backend=cs.DPQ_BACKEND, device=args.device)
        ref = ref_run.result()
    for name, faults in FAULTS.items():
        want = [r[name] for r in ref]
        for fault in faults:
            got = [r[(name, fault)] for r in tested]
            worst, held, whole, bound, onebit = cs.dpq_reference_readings(
                tf, params, name, got, want)
            whole_bound = cs.DPQ_REF_ONEBIT_WHOLE_RTOL if onebit else bound
            lines.append({
                "config": name, "fault": fault, "device": args.device,
                "steps": cs.DPQ_REF_STEPS, "seq": cs.DPQ_REF_SEQ,
                "max_rel_err_loss": worst,
                "params_distance_over_update_l2": held,
                "params_held": "the layers but the key bias" if onebit
                else "every leaf",
                "whole_tree_distance_over_update_l2": whole,
                "bound": {"loss": cs.DPQ_REF_RTOL, "params": bound,
                          "whole_tree": whole_bound},
                "caught": (worst > cs.DPQ_REF_RTOL or held > bound
                           or whole > whole_bound)})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
