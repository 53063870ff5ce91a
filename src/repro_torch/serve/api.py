"""Public request/response types for the serve engine (host-side only).

* :class:`Request` — what a caller wants generated (prompt, budget, optional
  per-token stream callback).  ``Engine.submit(Request)`` returns a
  :class:`RequestHandle`.
* :class:`StreamEvent` — one token (or the terminal event) delivered to a
  request's ``stream`` callback when its tokens reach the host: at each
  decode-chunk boundary (continuous scheduler) or at the wave's single
  transfer (wave scheduler).
* :class:`GenerationResult` — the finished request: tokens, finish reason,
  TTFT and throughput, and how much of the prompt the prefix cache served.
* :class:`RequestHandle` — a future for one request; ``result()`` blocks
  until the engine drains it (a :class:`repro_torch.serve.server.Server`
  resolves handles from its worker thread).

The JAX package's deprecated positional ``submit(prompt, n)`` surface is
not part of the port.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence

#: finish reasons carried by GenerationResult / terminal StreamEvent
FINISH_STOP = "stop"        # the EOS token was emitted
FINISH_LENGTH = "length"    # the max_new_tokens budget was exhausted

#: prefix-cache provenance values (``None`` on GenerationResult = cold)
PREFIX_HIT_FULL = "full"        # whole prompt served from cache, no prefill
PREFIX_HIT_PARTIAL = "partial"  # page-aligned prefix shared, prefill re-run


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One streamed token (or the terminal event) for a request.

    Token events arrive in order with ``finished=False``; the terminal
    event carries ``token=None``, ``finished=True`` and the finish reason.
    ``index`` is the token's position in the generated sequence (the count
    of tokens delivered so far, for the terminal event).
    """
    request_id: int
    token: Optional[int]
    index: int
    finished: bool = False
    finish_reason: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request for :meth:`Engine.submit`.

    Args:
      prompt: non-empty token-id sequence.
      max_new_tokens: decode budget (>= 1).
      row: index of this request in per-request input arrays (the JAX
        package's ``extra_inputs``; the dense family has none, so the port
        only carries it — ``generate`` fills it, a Server rejects it).
      stream: optional callback invoked with a :class:`StreamEvent` per
        generated token plus one terminal event, from the thread driving
        the engine (the server's worker thread in server mode).
      temperature: optional assertion of the engine's sampling temperature;
        a Request naming another one is rejected at submit.
    """
    prompt: Sequence[int]
    max_new_tokens: int
    row: Optional[int] = None
    stream: Optional[Callable[[StreamEvent], None]] = None
    temperature: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    """One finished request, as returned by ``Engine.run()``.

    ``ttft_s`` is submit-to-first-token-host-visible; ``tok_per_s`` is
    ``len(tokens) / total_s``.  ``prefix_hit`` is ``"full"`` /
    ``"partial"`` / ``None`` with ``cached_prefix_tokens`` counting the
    prompt tokens served from the prefix cache.
    """
    request_id: int
    tokens: List[int]
    finish_reason: str
    prompt_len: int
    ttft_s: Optional[float]
    total_s: float
    tok_per_s: float
    prefix_hit: Optional[str] = None
    cached_prefix_tokens: int = 0


class RequestHandle:
    """Future for one submitted :class:`Request`, resolved the moment the
    request finishes; ``result()`` re-raises the engine's exception when the
    drain died under the request."""

    def __init__(self, request_id: int = -1):
        self.request_id = request_id
        self._done = threading.Event()
        self._result: Optional[GenerationResult] = None
        self._error: Optional[BaseException] = None

    def _set_result(self, result: GenerationResult) -> None:
        self._result = result
        self._done.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished after {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result
