"""The IR checker's configuration matrix.

The unit of verification is an :class:`IRCase`: one (model family x
scheduler x mesh spec x dtype) cell of the product the reference ships.
Every cell names the serve/train entry points its scheduler actually runs
(``prefill`` + ``decode_loop`` + ``train_step`` for the wave engine;
``admit`` + ``decode_chunk`` for continuous batching), and the tracer
(:mod:`~repro_torch.analysis.ir.trace`) runs exactly those, once each.

This module is pure bookkeeping: importing it touches no device and no
process group, so the CLI can enumerate and filter the matrix
(``ir --families ...``) before it pays for a trace.  Case ids, entry names
and ``SERVE_KW`` are the reference's, letter for letter.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

#: the five model families of the serve acceptance matrix: dense, MoE,
#: vision-language, audio encoder-decoder, hybrid attention+SSM
FAMILIES = ("llama3.2-1b", "olmoe-1b-7b", "llama-3.2-vision-11b",
            "whisper-large-v3", "zamba2-2.7b")

SCHEDULERS = ("wave", "continuous")
DTYPES = ("float32", "bfloat16")

#: entry points per scheduler.  ``train_step`` rides with the wave cases
#: only: training has no scheduler axis, and duplicating it under
#: "continuous" would double the matrix for identical programs.
WAVE_ENTRIES = ("prefill", "decode_loop", "train_step")
CONTINUOUS_ENTRIES = ("admit", "decode_chunk")

#: ServeConfig knobs every case is traced with: small enough to run in
#: seconds on a CPU host, big enough that plen/width bucketing is exercised
SERVE_KW = dict(max_batch=4, max_len=64)


def mesh_label(mesh_spec: Optional[str]) -> str:
    """Mesh coordinate of a case id: ``"single"`` or ``"data4xmodel2"``
    (the label :func:`repro_torch.launch.mesh.mesh_axis_label` derives
    from the built mesh, computed here without building one)."""
    if not mesh_spec:
        return "single"
    from repro_torch.launch.mesh import parse_mesh_spec
    return "x".join(f"{k}{v}" for k, v in parse_mesh_spec(mesh_spec).items())


@dataclasses.dataclass(frozen=True, order=True)
class IRCase:
    """One cell of the config matrix the IR checker traces."""
    family: str
    scheduler: str                 # "wave" | "continuous"
    mesh_spec: Optional[str]       # None: one device; "data=4,model=2"
    dtype: str                     # "float32" | "bfloat16"

    @property
    def mesh_name(self) -> str:
        return mesh_label(self.mesh_spec)

    @property
    def case_id(self) -> str:
        """Stable identity: finding paths, fingerprint keys, cache keys."""
        return f"{self.family}/{self.scheduler}/{self.mesh_name}/{self.dtype}"

    @property
    def entries(self) -> Tuple[str, ...]:
        return WAVE_ENTRIES if self.scheduler == "wave" else CONTINUOUS_ENTRIES


def default_matrix(mesh_specs: Sequence[Optional[str]] = (None,),
                   families: Sequence[str] = FAMILIES,
                   schedulers: Sequence[str] = SCHEDULERS,
                   dtypes: Sequence[str] = DTYPES) -> List[IRCase]:
    """The full cross product, sorted for deterministic report order.
    Sorts on case_id: mesh_spec itself mixes None and str."""
    return sorted((IRCase(f, s, m, d)
                   for f in families for s in schedulers
                   for m in mesh_specs for d in dtypes),
                  key=lambda c: c.case_id)


def smoke_matrix() -> List[IRCase]:
    """Cheap subset for ``report --ir smoke``: one family, both schedulers,
    single device, bf16: enough to catch wiring rot in seconds."""
    return default_matrix(mesh_specs=(None,), families=("llama3.2-1b",),
                          dtypes=("bfloat16",))
