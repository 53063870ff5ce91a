"""Deterministic token data pipeline (numpy; the batches are torch tensors).

Every batch is a pure function of (seed, step): restart at step k replays
the exact token stream, with no loader state to checkpoint, and the same
(seed, step) gives the reference's batch token for token.  Two sources:
synthetic (a structured stream, ``t' = t + b + noise mod V`` with one of 8
offsets a row, which a model can learn) and file-backed (a memory-mapped
int32 token binary, rows read at seeded offsets).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"        # synthetic | file
    path: Optional[str] = None


class TokenPipeline:
    """batch(step) -> {"tokens": (B, S) int32, "labels": (B, S) int32}, on
    ``device`` (default: the card)."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.source == "file":
            if not cfg.path:
                raise ValueError("file source needs a path")
            self._data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        else:
            self._data = None
        rng = np.random.default_rng(cfg.seed)
        self._a = np.ones(8, np.int64)                      # t' = t + b + noise
        self._b = rng.integers(1, 9, size=8).astype(np.int64)

    def _out(self, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """(B, S + 1) token rows -> inputs and next-token labels."""
        rows = torch.from_numpy(rows.astype(np.int32)).to(self.device)
        return {"tokens": rows[:, :-1].contiguous(),
                "labels": rows[:, 1:].contiguous()}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if self._data is not None:
            return self._file_batch(step)
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        mode = rng.integers(0, 8, size=(b, 1))
        start = rng.integers(0, v, size=(b, 1)).astype(np.int64)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, :1] = start
        a = self._a[mode]
        bb = self._b[mode]
        noise = rng.integers(0, 3, size=(b, s))
        for i in range(s):
            toks[:, i + 1] = (a[:, 0] * toks[:, i] + bb[:, 0] + noise[:, i]) % v
        return self._out(toks)

    def _file_batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        need = b * (s + 1)
        total = len(self._data) - need - 1
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        offs = rng.integers(0, max(total, 1), size=b)
        rows = np.stack([np.asarray(self._data[o:o + s + 1]) for o in offs])
        return self._out(rows % cfg.vocab_size)

    def __call__(self, step: int):
        return self.batch(step)

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
