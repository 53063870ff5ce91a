"""Public request/response types for the serve engine (host-side only).

* :class:`Request` — what a caller wants generated (prompt, budget).
  ``Engine.submit(Request)`` returns a :class:`RequestHandle`.
* :class:`GenerationResult` — the finished request: tokens, finish reason,
  TTFT and throughput.
* :class:`RequestHandle` — a future for one request; ``result()`` returns
  it once the engine has drained it.

Streaming callbacks and the prefix-cache provenance of the JAX package's
API come with the server and prefix-cache slices.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

#: finish reasons carried by GenerationResult
FINISH_STOP = "stop"        # the EOS token was emitted
FINISH_LENGTH = "length"    # the max_new_tokens budget was exhausted


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request for :meth:`Engine.submit`.

    Args:
      prompt: non-empty token-id sequence.
      max_new_tokens: decode budget (>= 1).
      temperature: optional assertion of the engine's sampling temperature;
        a Request naming another one is rejected at submit.
    """
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    """One finished request, as returned by ``Engine.run()``.

    ``ttft_s`` is submit-to-first-token-host-visible; ``tok_per_s`` is
    ``len(tokens) / total_s``.
    """
    request_id: int
    tokens: List[int]
    finish_reason: str
    prompt_len: int
    ttft_s: Optional[float]
    total_s: float
    tok_per_s: float


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
