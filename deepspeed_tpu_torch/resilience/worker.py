"""Resumable training worker: the process the recovery supervisor runs.

Port of ``deepspeed_tpu/resilience/worker.py``.  One incarnation of one
rank: join the group, build an engine on the mesh the supervisor planned
(``DSTPU_MESH``), optionally resume from the latest COMMITTED universal
checkpoint, train, heartbeat every step, and persist a crash-atomic
universal checkpoint so the next incarnation (possibly on a smaller mesh)
can pick up where this one died.  Any training script that honours the
same env contract plugs into the supervisor alike.

    python -m deepspeed_tpu_torch.resilience.worker

Where the JAX package runs every rank of a mesh in one process, each
worker here is one rank (``DSTPU_PROC_ID`` of ``DSTPU_NUM_PROCS``, from
``elasticity.start_group``): above one rank it joins the process group
over a ``FileStore`` under the checkpoint dir (one file an incarnation)
on the backend ``DSTPU_BACKEND`` names, and saves and converts with every
rank taking part (rank 0 writes).

Env contract (all optional unless marked):
    DSTPU_MESH           json mesh sizes, e.g. '{"data": 2}'  [required]
    DSTPU_CKPT_DIR       checkpoint root                       [required]
    DSTPU_PROGRESS       rank-0 heartbeat/progress JSONL path  [required]
    DSTPU_TOTAL_STEPS    train until global_steps reaches this (default 8)
    DSTPU_RESUME         "1": resume from the latest committed universal
    DSTPU_MODEL          model-zoo name (default gpt2-tiny)
    DSTPU_SEQ            sequence length (default 16)
    DSTPU_BATCH          GLOBAL batch size (default 8), held fixed across
                         resizes so the loss curve stays comparable
    DSTPU_ZERO_STAGE     zero_optimization.stage (default 2)
    DSTPU_SAVE_EVERY     checkpoint cadence in steps (default 1)
    DSTPU_FORCE_CPU      "1": train on the CPU; otherwise on the card
                         cuda:RANK % device_count
    DSTPU_BACKEND        "gloo" (default; ranks may share a card) or
                         "nccl" (a card a rank)
    DSTPU_CHAOS          json fault injection (``resilience/chaos.py``
                         ``TrainChaos``), honoured ONCE per ckpt dir:
                         {"die_at": N}          exit(13) after step N,
                                                BEFORE saving it
                         {"hang_at": N}         stop heartbeating after
                                                step N (a simulated wedge)
                         {"ignore_term": true}  also swallow SIGTERM
                         {"rank": r}            which rank acts (default 0)

Per-step progress lines ``{"step", "loss", "rank", "incarnation",
"time_unix"}`` are the supervisor's heartbeat AND the loss-continuity
evidence: batches are a pure function of the step index, so a resumed
curve must land on the unkilled run's curve.  Each line also carries
``start_step``, the step its incarnation began after (the resumed tag's,
or 0 when it started over), so that a resume that found nothing shows.
"""

from __future__ import annotations

import json
import os
import sys
import time


def train_config(mesh, batch_size: int, zero_stage: int):
    """The worker's engine config: a fixed GLOBAL batch over the data
    axis, AdamW lr 1e-3 (the JAX worker's)."""
    dp = (mesh.get("data", 1) * mesh.get("subdata", 1)
          * mesh.get("expert", 1))
    return {
        "train_batch_size": batch_size,
        "train_micro_batch_size_per_gpu": max(1, batch_size // dp),
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": zero_stage},
        "steps_per_print": 100000,
        "mesh": mesh,
    }


def batch_for(step: int, vocab_size: int, batch_size: int, seq: int):
    """The global batch of step ``step``: a pure function of the step
    index, so every incarnation (any mesh) consumes the identical batch
    and the curves are comparable."""
    import numpy as np

    rng = np.random.default_rng(1000 + step)
    ids = rng.integers(0, vocab_size, size=(batch_size, seq + 1),
                       dtype=np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def main() -> int:
    import torch

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.checkpoint.universal import (
        ds_to_universal, load_universal, resolve_universal_dir)
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import get_model_config
    from deepspeed_tpu_torch.resilience.chaos import TrainChaos

    mesh = {k: int(v) for k, v in
            json.loads(os.environ.get("DSTPU_MESH") or "{}").items()}
    rank = int(os.environ.get("DSTPU_PROC_ID", "0"))
    world = int(os.environ.get("DSTPU_NUM_PROCS", "1"))
    ckpt_dir = os.environ["DSTPU_CKPT_DIR"]
    progress = os.environ["DSTPU_PROGRESS"]
    if rank != 0:
        progress = f"{progress}.r{rank}"
    total_steps = int(os.environ.get("DSTPU_TOTAL_STEPS", "8"))
    seq = int(os.environ.get("DSTPU_SEQ", "16"))
    batch_size = int(os.environ.get("DSTPU_BATCH", "8"))
    save_every = int(os.environ.get("DSTPU_SAVE_EVERY", "1"))
    resume = os.environ.get("DSTPU_RESUME", "0") == "1"
    incarnation = int(os.environ.get("DSTPU_INCARNATION", "0"))
    device = (torch.device("cpu")
              if os.environ.get("DSTPU_FORCE_CPU", "0") == "1"
              else torch.device("cuda", rank % max(1, torch.cuda.device_count())))

    chaos = TrainChaos.from_env(rank, ckpt_dir)
    if chaos is not None:
        chaos.install_signals()
    if world > 1:
        comm.init_distributed(
            os.environ.get("DSTPU_BACKEND", "gloo"), rank, world,
            "file://" + os.path.join(ckpt_dir, f".store-{incarnation}"),
            device=device)

    model = get_model_config(os.environ.get("DSTPU_MODEL", "gpt2-tiny"),
                             max_seq_len=max(seq, 16))
    cfg = train_config(mesh, batch_size,
                       int(os.environ.get("DSTPU_ZERO_STAGE", "2")))
    engine, _, _, _ = ds.initialize(model=model, config=cfg, seed=7,
                                    device=device)
    if resume:
        try:
            load_universal(engine, resolve_universal_dir(ckpt_dir))
        except FileNotFoundError:
            # crashed before the FIRST committed save: nothing to resume,
            # start over (a missing checkpoint must not wedge recovery)
            print("worker: no committed universal checkpoint yet; "
                  "starting from step 0", flush=True)
    start_step = engine.global_steps

    while engine.global_steps < total_steps:
        step = engine.global_steps  # 0-based index of the step we run
        loss = float(engine.train_batch(
            batch_for(step, model.vocab_size, batch_size, seq)))
        with open(progress, "a") as f:
            f.write(json.dumps({"step": engine.global_steps, "loss": loss,
                                "rank": rank, "incarnation": incarnation,
                                "start_step": start_step,
                                "time_unix": time.time()}) + "\n")
            f.flush()
            os.fsync(f.fileno())

        done = engine.global_steps
        if chaos is not None:
            # BEFORE the save: a die loses the step just run, and the
            # resumed incarnation must recompute it from the previous
            # committed checkpoint (the real mid-train crash shape)
            chaos.fire(done)

        if done % save_every == 0:
            tag = f"step{done}"
            engine.save_checkpoint(ckpt_dir, tag=tag)
            ds_to_universal(ckpt_dir, tag=tag, engine=engine)
    if world > 1:
        torch.distributed.barrier()
        comm.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
