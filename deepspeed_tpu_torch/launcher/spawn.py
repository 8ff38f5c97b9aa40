"""Start N ranks of one program on this host, each with its device, its
process group and its rendezvous.

The JAX package runs every rank of a mesh in one process; the port runs
one ``torch.distributed`` process a rank.  ``launch`` spawns them with the
``spawn`` start method (a fork after CUDA is initialised breaks the
child), initialises each one's default process group on the backend the
caller names (``comm.init_distributed``) over a ``FileStore`` in a fresh
directory (no port to collide on), gives rank r the device
``cuda:r % device_count`` (ranks beyond the card count share cards, which
gloo allows and NCCL refuses) or the CPU, runs ``fn(rank, world_size,
*args)``, and returns each rank's result.  A rank that raises fails the
launch: the others are stopped and the error is raised in the caller.

``fn`` must be importable by name from a fresh interpreter (a module-level
function of a module that does not start work when imported).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, args: Sequence[Any],
               backend: str, device: str, rdzv: str, out_dir: str) -> None:
    from deepspeed_tpu_torch.comm import comm

    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if device == "cuda" else torch.device("cpu"))
    comm.init_distributed(backend, rank, world_size, f"file://{rdzv}",
                          device=dev)
    try:
        result = fn(rank, world_size, *args)
    finally:
        comm.destroy()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def launch(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
           backend: str, device: str = "cuda") -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned ranks
    and return their results in rank order.  ``backend`` (required, no
    default): ``"gloo"`` or ``"nccl"``; ``device``: ``"cuda"`` or
    ``"cpu"``."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch(device='cuda') without a CUDA device")
    work = tempfile.mkdtemp(prefix="dstt_launch_")
    try:
        mp.start_processes(
            _rank_main, args=(fn, world_size, tuple(args), backend, device,
                              os.path.join(work, "rdzv"), work),
            nprocs=world_size, join=True, start_method="spawn")
        results = []
        for r in range(world_size):
            with open(Path(work) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)
