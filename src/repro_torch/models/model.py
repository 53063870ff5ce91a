"""Model factory: one functional bundle per architecture family."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike
from repro_torch.distributed.ctx import current_mesh, current_rules
from repro_torch.models import hybrid as H
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, param_count, tree_paths


class TensorSpec(NamedTuple):
    """Shape and dtype of one extra model input."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Model:
    """Functional model bundle (params are passed explicitly everywhere)."""
    cfg: ModelConfig
    template: Any                          # ParamSpec tree

    def init(self, seed: int = 0, device: DeviceLike = None, mesh=None,
             rules=None):
        """Seeded random params on ``device`` (default: the card).  With
        ``mesh`` (else the ambient ``distributed.use_mesh`` one) every leaf
        is placed by the sharding rules (``rules``, else the ambient ones,
        else ``rules_for_mesh(mesh)``) as it is drawn: the same values,
        a sharded layout."""
        place = None
        if mesh is None:
            mesh, rules = current_mesh(), rules or current_rules()
        if mesh is not None:
            from repro_torch.distributed import sharding as sh
            rules = rules or sh.rules_for_mesh(mesh)
            layouts = tree_paths(sh.param_placements(mesh, rules,
                                                     self.template))

            def place(path, leaf):
                return sh.distribute(leaf, mesh, layouts[path].placements)
        return init_params(self.template, seed, default_dtype=self.cfg.dtype,
                           device=device, place=place)

    def param_count(self) -> int:
        return param_count(self.template)

    # family dispatch ---------------------------------------------------
    def _mod(self):
        return H if self.cfg.family in SSM_FAMILIES else T

    def forward(self, params, batch: Dict[str, torch.Tensor]):
        """-> (logits (B, S, V) f32, aux_loss)."""
        return self._mod().forward(self.cfg, params, batch)

    def forward_hidden(self, params, batch: Dict[str, torch.Tensor]):
        """-> (final hidden pre-norm (B, S, D), aux_loss), for the loss's
        chunked unembed."""
        return self._mod().forward_hidden(self.cfg, params, batch)

    def unembed_weight(self, params) -> torch.Tensor:
        """(d_model, vocab); the tied head is ``embedding.t()``, a view."""
        return T.unembed_weight(self.cfg, params)

    def final_norm(self, params, x: torch.Tensor) -> torch.Tensor:
        return L.apply_norm(params["ln_f"], x, eps=self.cfg.norm_eps)

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device: DeviceLike = None):
        return self._mod().init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, params, batch, cache):
        """``batch`` may carry ``kv_start`` (B,) left-pad offsets for ragged
        batches; see transformer.prefill and hybrid.prefill."""
        return self._mod().prefill(self.cfg, params, batch, cache)

    def decode_step(self, params, tokens, cache, offset: int, kv_start=None):
        return self._mod().decode_step(self.cfg, params, tokens, cache,
                                       offset, kv_start)

    def extra_inputs(self, batch_size: int) -> Dict[str, TensorSpec]:
        """Model inputs beyond the tokens (the modality frontends' stub
        outputs), by name: the vlm family's ``image_embeds`` (B, N_img, D),
        the audio family's ``encoder_embeds`` (B, enc_len, D)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        if cfg.family == "vlm":
            return {"image_embeds": TensorSpec(
                (batch_size, cfg.num_image_tokens, cfg.d_model), dt)}
        if cfg.family == "audio":
            return {"encoder_embeds": TensorSpec(
                (batch_size, cfg.encoder_len, cfg.d_model), dt)}
        return {}


#: families built by ``models.hybrid``; the rest by ``models.transformer``
SSM_FAMILIES = ("ssm", "hybrid")


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in SSM_FAMILIES:
        tpl = H.template(cfg)
    elif cfg.family in ("dense", "moe", "vlm", "audio"):
        tpl = T.template(cfg)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(cfg=cfg, template=tpl)


def active_param_count(model: Model) -> int:
    """Per-token active parameters (a MoE counts its top-k experts only):
    the N of MODEL_FLOPS = 6 N D (train) or 2 N D (inference) in the
    roofline."""
    cfg = model.cfg
    total = model.param_count()
    if not cfg.num_experts:
        return total
    # expert weights: 3 * d_model * d_ff per expert per layer
    per_layer_exp = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.num_layers * per_layer_exp * (cfg.num_experts
                                                 - cfg.experts_per_token)
    return total - inactive
