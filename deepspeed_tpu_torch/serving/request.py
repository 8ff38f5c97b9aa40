"""Request/response handles for the serving layer.

Analog of DeepSpeed-MII's request pipeline (mii/batching/data_classes.py
``Request``/``RequestBatch`` + the streaming reply path): a
``GenerationRequest`` pairs a token prompt with ``SamplingParams`` and a
``ResponseStream`` — the caller-facing handle that yields tokens as the
serve loop produces them, supports cancellation and deadlines, and
offers a blocking ``result()``.

Thread model: the serve loop is the only *producer* (``_put_token`` /
``_finish``); any number of consumer threads may iterate, poll, or block
on the stream.  All shared state sits behind one ``Condition``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional


class ServingError(RuntimeError):
    """Base class for request-terminating serving failures."""


class RequestCancelled(ServingError):
    """The request was cancelled (by the caller or server shutdown)."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it finished."""


class QueueFull(ServingError):
    """Admission queue at capacity under the 'reject' policy."""


class RequestShed(ServingError):
    """The request was shed by the graceful-degradation ladder (brownout
    levels ``shed_low_priority`` / ``reject_new``) — a typed, load-caused
    terminal state distinct from a failure: the request was well-formed
    and the server healthy, but capacity was deliberately withheld."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (mirrors ``engine.generate()``'s
    signature, so one-shot and served generation stay comparable)."""
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    # opt this request into speculative decoding (greedy only — the
    # acceptance rule is the bit-identical-to-greedy argmax test; a
    # server without a draft model ignores the flag)
    speculative: bool = False

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclass
class GenerationRequest:
    """One in-flight generation job (serve-loop-internal bookkeeping)."""
    uid: int
    prompt: List[int]
    params: SamplingParams
    stream: "ResponseStream"
    priority: int = 0
    deadline: Optional[float] = None      # absolute time.monotonic()
    submitted_at: float = field(default_factory=time.monotonic)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    preemptions: int = 0
    # prompt + generated-so-far; rebuilt as the re-prefill prompt after a
    # preemption (recompute-style: KV is rebuilt, not migrated)
    tokens: List[int] = field(default_factory=list)
    # tokens prefilled by the CURRENT admission, pending prefix-cache
    # insertion at the first sampled token (0 = nothing pending; only
    # set when the server runs a prefix cache)
    pending_insert: int = 0
    # -- disaggregated serving (serving/disagg.py) --
    # handoff=True: at completion, export this sequence's full KV blocks
    # onto the stream (prefill-tier leg of a prefill→decode handoff)
    handoff: bool = False
    # a handoff payload from a prefill replica: admission imports these
    # pages instead of re-prefilling the covered prefix
    kv_payload: Any = None
    # distributed-tracing identity: every span this request emits shares
    # this id ("" = tracing disabled; see telemetry/tracing.py).  The
    # span handles are serve-loop-internal (only it starts/ends them).
    trace_id: str = ""
    span_request: Any = None       # root span: enqueue -> terminal
    span_phase: Any = None         # current phase: queue_wait|prefill|decode

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.tokens:
            self.tokens = list(self.prompt)

    @property
    def n_generated(self) -> int:
        return len(self.tokens) - len(self.prompt)

    @property
    def remaining(self) -> int:
        return self.params.max_new_tokens - self.n_generated

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)


class ResponseStream:
    """Caller-facing handle: iterate for tokens as they are produced, or
    block on ``result()`` for the full output.

    Terminal states are exclusive: exactly one of *completed* (all tokens
    delivered), *failed* (``error`` holds a ``ServingError`` — cancelled /
    deadline / rejected / engine failure).  Tokens delivered before a
    failure remain readable via ``tokens``.
    """

    def __init__(self, uid: int):
        self.uid = uid
        # set by the server at submit when tracing is enabled, so callers
        # can cross-link their stream to the exported Perfetto trace
        self.trace_id = ""
        # prefill-tier handoff: the exported KV payload, set by the serve
        # loop BEFORE _finish so a consumer observing the terminal state
        # always sees it (None = no handoff was requested/possible)
        self.handoff_payload = None
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._done = False
        self._error: Optional[ServingError] = None
        self._cancel_requested = False

    # -- producer side (serve loop only) --------------------------------
    def _put_token(self, token: int) -> None:
        with self._cond:
            self._tokens.append(int(token))
            self._cond.notify_all()

    def _finish(self, error: Optional[ServingError] = None) -> None:
        with self._cond:
            if self._done:
                return
            self._done = True
            self._error = error
            self._cond.notify_all()

    # -- consumer side ---------------------------------------------------
    def cancel(self) -> None:
        """Request cancellation.  Asynchronous: the serve loop observes the
        flag at its next iteration and fails the stream with
        ``RequestCancelled``; already-produced tokens stay readable."""
        with self._cond:
            self._cancel_requested = True
            self._cond.notify_all()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_requested

    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    @property
    def error(self) -> Optional[ServingError]:
        with self._cond:
            return self._error

    @property
    def tokens(self) -> List[int]:
        """Snapshot of tokens produced so far (safe from any thread)."""
        with self._cond:
            return list(self._tokens)

    def __iter__(self) -> Iterator[int]:
        """Yield tokens as they arrive; raises the terminal error (if any)
        after the last delivered token."""
        i = 0
        while True:
            with self._cond:
                while i >= len(self._tokens) and not self._done:
                    self._cond.wait()
                if i < len(self._tokens):
                    tok = self._tokens[i]
                else:  # done, no more tokens
                    if self._error is not None:
                        raise self._error
                    return
            i += 1
            yield tok

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; returns the full generated
        token list or raises the terminal ``ServingError``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._done:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise TimeoutError(
                        f"request {self.uid} unfinished after {timeout}s")
                self._cond.wait(rem)
            if self._error is not None:
                raise self._error
            return list(self._tokens)
