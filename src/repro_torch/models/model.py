"""Model factory: one functional bundle per architecture family."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, param_count


@dataclasses.dataclass(frozen=True)
class Model:
    """Functional model bundle (params are passed explicitly everywhere)."""
    cfg: ModelConfig
    template: Any                          # ParamSpec tree

    def init(self, seed: int = 0, device: DeviceLike = None):
        """Seeded random params on ``device`` (default: the card)."""
        return init_params(self.template, seed, default_dtype=self.cfg.dtype,
                           device=device)

    def param_count(self) -> int:
        return param_count(self.template)

    def forward(self, params, batch: Dict[str, torch.Tensor]):
        """-> (logits (B, S, V) f32, aux_loss)."""
        return T.forward(self.cfg, params, batch)

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device: DeviceLike = None):
        return T.init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, params, batch, cache):
        """``batch`` may carry ``kv_start`` (B,) left-pad offsets for ragged
        batches; see transformer.prefill."""
        return T.prefill(self.cfg, params, batch, cache)

    def decode_step(self, params, tokens, cache, offset: int, kv_start=None):
        return T.decode_step(self.cfg, params, tokens, cache, offset, kv_start)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the dense family is "
            f"(ROADMAP.md queue 1, item 6: the other families)")
    if cfg.kv_quant:
        raise NotImplementedError(
            "int8 KV cache: not ported yet (ROADMAP.md queue 1, item 5)")
    return Model(cfg=cfg, template=T.template(cfg))
