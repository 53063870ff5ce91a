"""Meta-tensor stand-ins for every (arch x shape) dry-run cell.

``input_specs(cfg, shape)`` returns the inputs of the step that cell traces
(the train step, the prefill step or the decode step) as ``meta`` tensors:
shapes and dtypes, no storage.  The dry run makes each one anew under
``FakeTensorMode`` on the cell's mesh (``launch.dryrun``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.model import Model, build_model

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _extras(model: Model, batch: int) -> Dict[str, torch.Tensor]:
    return {k: _meta(spec.shape, spec.dtype)
            for k, spec in model.extra_inputs(batch).items()}


def train_batch_specs(model: Model, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    batch.update(_extras(model, b))
    return batch


def prefill_batch_specs(model: Model, shape: ShapeSpec) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32)}
    batch.update(_extras(model, b))
    return batch


def cache_specs(model: Model, shape: ShapeSpec):
    """The KV / recurrent cache sized for the cell's sequence length."""
    return model.init_cache(shape.global_batch, shape.seq_len, device=META)


def decode_token_specs(shape: ShapeSpec) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Tuple[str, Dict[str, Any]]:
    """-> (step kind, the step's keyword inputs as meta tensors).  The
    decode ``offset`` is a 0-d int32 tensor, as the reference's; the port's
    decode step takes it as an int (the dry run passes the cache's last
    position)."""
    model = build_model(cfg)
    if shape.kind == "train":
        return "train", {"batch": train_batch_specs(model, shape)}
    if shape.kind == "prefill":
        return "prefill", {"batch": prefill_batch_specs(model, shape),
                           "cache": cache_specs(model, shape)}
    if shape.kind == "decode":
        return "decode", {"tokens": decode_token_specs(shape),
                          "cache": cache_specs(model, shape),
                          "offset": _meta((), torch.int32)}
    raise ValueError(shape.kind)
