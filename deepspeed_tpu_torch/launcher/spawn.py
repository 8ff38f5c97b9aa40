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
*args)``, and returns each rank's result.  A rank tears its group down
only once every rank has finished ``fn`` (a count in a store of its own).
A rank that raises (or dies) fails the launch: the others are stopped and
the error is raised in the caller.

``fn`` must be importable by name from a fresh interpreter (a module-level
function of a module that does not start work when imported).
"""

from __future__ import annotations

import faulthandler
import gc
import os
import pickle
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, args: Sequence[Any],
               backend: str, device: str, rdzv: str, out_dir: str) -> None:
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.parallel.topology import set_topology

    # an abort (SIGABRT from a native thread, say) prints every thread's
    # Python stack to this rank's stderr before the process dies
    faulthandler.enable(file=sys.stderr, all_threads=True)
    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if device == "cuda" else torch.device("cpu"))
    comm.init_distributed(backend, rank, world_size, f"file://{rdzv}",
                          device=dev)
    try:
        result = fn(rank, world_size, *args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        _wait_for_every_rank(rdzv + ".finished", world_size)
    finally:
        # drop what still holds the groups (the topology the engine set,
        # engines left in reference cycles) so that they are destroyed
        # here, with the process whole, and not at interpreter exit: an
        # abort with no Python frame ("terminate called without an active
        # exception") was seen there
        set_topology(None)
        gc.collect()
        comm.destroy()


def _wait_for_every_rank(path: str, world_size: int) -> None:
    """Return once every rank has finished its function.  A rank that
    tears its process group down while a peer is still inside a
    collective, or still connecting the group, closes the sockets that
    peer reads: the peer fails with "Connection closed by peer" (seen in
    ``init_process_group``'s connectFullMesh under load).  The count lives
    in a store of its own, not in a collective, so a rank waiting here
    never fails because a peer died: the launcher stops it when it sees
    the peer's error."""
    store = dist.FileStore(path, world_size)
    store.add("finished", 1)
    while store.add("finished", 0) < world_size:
        time.sleep(0.005)


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
