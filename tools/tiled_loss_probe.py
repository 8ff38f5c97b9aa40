#!/usr/bin/env python3
"""ALST's tiled loss (``sequence/alst.py`` ``tiled_nll``) on one card at a
rank's shape of ``chip_smoke.py``'s ring-train and ulysses-train.

    python3 tools/tiled_loss_probe.py [--tokens 4096] [--tile 256] [--groups 1,2,4,8,16] [--alst other/alst.py] [--out build/tiled_loss_probe.jsonl]

Needs a CUDA card.  llama3-8b's head (vocabulary 128256, width 4096),
bf16 hidden states and head weight from a seed, ``--tokens`` tokens of one
row in tiles of ``--tile``.  For each group of ``--groups`` (the tiles
whose logit gradients the backward adds into the fp32 head gradient in
one product: ``alst.DW_GROUP_BYTES`` set to that many tiles), for the
default, and for the untiled loss (bf16 logits, cast to fp32,
cross-entropy): the forward + backward's device ms (CUDA events,
the median of ``--reps``), the host ms until ``backward()`` returns (a
host sync in the backward holds it to the device's time), the peak
memory above the inputs, and the loss and gradients' largest difference
from the first run's.  ``--alst``: another copy of ``alst.py`` (a parent
tree's) measured the same way at its default grouping.  Prints one JSON
line a run, the card's ``nvidia-smi`` line first; writes the same lines
to ``--out``.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _load(path):
    spec = importlib.util.spec_from_file_location("alst_other", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(torch, loss, h, w, labels, reps):
    """``loss(h, w, labels) -> (nll, count)``: forward + backward ``reps``
    times after a warm-up; device and host ms, peak bytes above the
    inputs, the last run's loss and gradients."""
    dev_ms, host_ms = [], []
    base = torch.cuda.memory_allocated()
    peak = 0
    for i in range(reps + 1):
        hs, ws = (x.detach().requires_grad_() for x in (h, w))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        nll, count = loss(hs, ws, labels)
        (nll / count).backward()
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        if i:
            dev_ms.append(start.elapsed_time(end))
            host_ms.append(host)
    return {"ms": statistics.median(dev_ms), "ms_all": dev_ms,
            "host_ms_to_return": statistics.median(host_ms),
            "peak_bytes_above_inputs": peak}, (
        float((nll / count).detach()), hs.grad, ws.grad)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--groups", default="1,2,4,8,16")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--alst", default=None)
    ap.add_argument("--out", default="build/tiled_loss_probe.jsonl")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("tiled_loss_probe: needs a CUDA card")
    from deepspeed_tpu_torch.sequence import alst

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = [{"nvidia_smi": smi}]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    vocab, width = 128256, 4096
    h = torch.randn((1, args.tokens, width), generator=gen, device=dev)
    h = h.to(torch.bfloat16)
    w = (torch.randn((vocab, width), generator=gen, device=dev)
         * width ** -0.5).to(torch.bfloat16)
    labels = torch.randint(0, vocab, (1, args.tokens), generator=gen,
                           device=dev)
    labels[0, :5] = -100
    default = alst.DW_GROUP_BYTES
    per_tile = args.tile * vocab * h.element_size()

    def grouped(g):
        """``tiled_nll`` with a buffer of ``g`` tiles (None: the default)."""
        def loss(hs, ws, y):
            alst.DW_GROUP_BYTES = default if g is None else g * per_tile
            try:
                return alst.tiled_nll(hs, ws, y, args.tile)
            finally:
                alst.DW_GROUP_BYTES = default
        return loss

    runs = [(f"tiled dw_group={g}", grouped(int(g)))
            for g in args.groups.split(",")]
    runs.append(("tiled default", grouped(None)))
    if args.alst:
        other = _load(args.alst)
        runs.append((f"tiled {args.alst}", lambda hs, ws, y: other.tiled_nll(
            hs, ws, y, args.tile)))

    def untiled(hs, ws, y):
        z = (hs[0] @ ws.t()).float()
        nll = torch.nn.functional.cross_entropy(z, y[0], ignore_index=-100,
                                                reduction="sum")
        return nll, (y != -100).sum()

    runs.append(("untiled", untiled))
    first = None
    for name, loss in runs:
        rec, (val, gh, gw) = _run(torch, loss, h, w, labels, args.reps)
        if first is None:
            first = (val, gh, gw)
        rec = {"run": name, "tokens": args.tokens, "tile": args.tile,
               "vocab": vocab, "width": width, **rec,
               "loss": val, "loss_diff_first": abs(val - first[0]),
               "dh_max_abs_diff_first": float((gh.float() - first[1].float())
                                              .abs().max()),
               "dw_max_abs_diff_first": float((gw.float() - first[2].float())
                                              .abs().max()),
               "nvidia_smi": smi}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del gh, gw
        torch.cuda.empty_cache()
    with out.open("w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps(lines[0]))


if __name__ == "__main__":
    main()
