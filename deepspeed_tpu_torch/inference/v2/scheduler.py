"""Dynamic SplitFuse scheduler.

Analog of the reference's FastGen scheduling
(ref inference/v2/scheduling_utils.py + the Dynamic SplitFuse policy,
blogs/deepspeed-fastgen): every engine step runs a FIXED token budget;
running (decode) sequences contribute one token each, and waiting prompts
fill the remaining budget — long prompts are *split* across steps, short
prompts *fuse* into one step. This keeps every forward the same shape
(compiled once) and latency flat.

Serving extensions: sequences carry a priority (higher runs earlier when
the budget is short), ``add(front=True)`` requeues a preempted sequence
ahead of every waiting prompt (preempted work already paid its queue
wait once), and ``demote()`` rolls a sequence back from the decode set to
the head of the prefill queue when a scheduled step could not run (KV
exhaustion caught before any state advanced).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager, SequenceDescriptor


class SplitFuseScheduler:
    def __init__(self, mgr: DSStateManager, token_budget: int = 256):
        self.mgr = mgr
        self.token_budget = token_budget
        self._decode: List[int] = []          # uids generating tokens
        self._prefill: List[int] = []         # uids with uncached prompt tokens
        # (-priority, arrival) sort key per uid: higher priority first,
        # FIFO within a priority class; front-requeues get arrival numbers
        # below every live entry so they re-enter at the head.
        self._key: Dict[int, Tuple[int, int]] = {}
        self._arrival = 0
        self._front_arrival = 0

    def add(self, uid: int, priority: int = 0, front: bool = False) -> None:
        if front:
            self._front_arrival -= 1
            arrival = self._front_arrival
        else:
            self._arrival += 1
            arrival = self._arrival
        self._key[uid] = (-int(priority), arrival)
        self._prefill.append(uid)
        self._prefill.sort(key=self._key.__getitem__)

    def retire(self, uid: int) -> None:
        if uid in self._decode:
            self._decode.remove(uid)
        if uid in self._prefill:
            self._prefill.remove(uid)
        self._key.pop(uid, None)

    def demote(self, uid: int) -> None:
        """Move a decode-set sequence back to the head of the prefill queue
        (its scheduled chunk never ran — see engine step() rollback)."""
        if uid in self._decode:
            self._decode.remove(uid)
        if uid not in self._prefill:
            self._front_arrival -= 1
            prio = self._key.get(uid, (0, 0))[0]
            self._key[uid] = (prio, self._front_arrival)
            self._prefill.append(uid)
            self._prefill.sort(key=self._key.__getitem__)

    @property
    def has_work(self) -> bool:
        return bool(self._decode or self._prefill)

    def next_schedule(self) -> List[Tuple[SequenceDescriptor, int]]:
        """(sequence, n_tokens) items for one step, ≤ token_budget total.

        Decode sequences first (1 token each — they bound latency), then
        prompt chunks; both sets walk in priority order. A prompt whose
        remaining tokens exceed the leftover budget is split; its
        unsampled chunk stays queued.
        """
        budget = self.token_budget
        schedule: List[Tuple[SequenceDescriptor, int]] = []
        for uid in sorted(self._decode, key=self._key.__getitem__):
            if budget == 0:
                break
            seq = self.mgr.get(uid)
            if seq.uncached <= 0:
                continue
            schedule.append((seq, 1))
            budget -= 1

        finished_prefill = []
        for uid in list(self._prefill):
            if budget == 0:
                break
            seq = self.mgr.get(uid)
            n = min(seq.uncached, budget)
            if n <= 0:
                finished_prefill.append(uid)
                continue
            schedule.append((seq, n))
            budget -= n
            if n == seq.uncached:
                finished_prefill.append(uid)
        for uid in finished_prefill:
            self._prefill.remove(uid)
            if uid not in self._decode:
                self._decode.append(uid)
        return schedule
