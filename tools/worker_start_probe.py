#!/usr/bin/env python3
"""Where a fresh worker process's time goes before its steps run at speed.

    python3 tools/worker_start_probe.py [--seq 1024] [--cprofile N]

Needs a CUDA card.  The process does what a restarted recovery worker
(``deepspeed_tpu_torch/resilience/worker.py``) does before its first
heartbeat, without the group or the resume: ``import torch``, the first
CUDA tensor, the worker's engine (``worker.train_config`` at data 1,
gpt2-350m, fp32, seed 7) and its first ``train_batch``, then two more
steps.  Each is timed on the host clock from the process's start.
``--cprofile N`` runs the first step under ``cProfile`` and adds its N
functions with the largest own time and the N with the largest
cumulative time.  Prints one JSON object.
"""

import argparse
import json
import subprocess
import sys
import time

T0 = time.perf_counter()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--cprofile", type=int, default=0)
    args = ap.parse_args()
    import torch

    t_import = time.perf_counter() - T0
    if not torch.cuda.is_available():
        print("worker_start_probe: no CUDA device", file=sys.stderr)
        return 1
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.resilience import worker

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - T0
    model = get_model_config("gpt2-350m", max_seq_len=max(args.seq, 16))
    eng, *_ = ds.initialize(model=model, seed=7,
                            config=worker.train_config({"data": 1}, 8, 2))
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - T0
    batches = [worker.batch_for(i, model.vocab_size, 8, args.seq)
               for i in range(3)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"card": card, "seq": args.seq, "import_torch_s": t_import,
           "cuda_ready_s": t_cuda, "engine_ready_s": t_engine}
    t = time.perf_counter()
    if args.cprofile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        float(eng.train_batch(batches[0]))
        prof.disable()
        stats = pstats.Stats(prof)
        rows = [(f"{fn[0].rsplit('/', 2)[-1]}:{fn[1]}:{fn[2]}", tt, ct)
                for fn, (_cc, _nc, tt, ct, _callers) in stats.stats.items()]
        out["first_step_own_s"] = [[n, tt] for n, tt, _ in sorted(
            rows, key=lambda r: -r[1])[:args.cprofile]]
        out["first_step_cumulative_s"] = [[n, ct] for n, _, ct in sorted(
            rows, key=lambda r: -r[2])[:args.cprofile]]
    else:
        float(eng.train_batch(batches[0]))
    out["first_step_s"] = time.perf_counter() - t
    steps = []
    for b in batches[1:]:
        t = time.perf_counter()
        float(eng.train_batch(b))
        steps.append(time.perf_counter() - t)
    out["next_steps_s"] = steps
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
