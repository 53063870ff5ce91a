"""Hardware profiles: one record per target the port's kernels run on.

The port's counterpart of the reference's ``core/hardware.py``.  A
:class:`HardwareProfile` holds the numbers the cost model ranks candidates
with (peak operations a second by input type, the memory rate), the card's
limits (shared memory a block may use, SMs, device memory), and its default
tier: the schedule the tuning registry serves when no tuned entry matches.

Two profiles are registered:

* ``h100`` (platform ``gpu``): the NVIDIA H100 SXM data sheet (989 TFLOP/s
  dense bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM, 80
  GiB, 227 KiB of shared memory a block, 132 SMs, NVLink 4 at 50 GB/s a
  link).  Its default tier is
  the hand-set tables of ``core.tile_config`` (``gemm_tiles``,
  ``flash_tiles``), so with no tuned entry a launch takes exactly the
  schedule those tables give.
* ``cpu`` (platform ``cpu``): the plain PyTorch versions of the kernels,
  which have no tiles; it has no default tier.

Which profile a process serves for:

1. an explicit argument (``execution_context(hardware=...)``,
   ``ServeConfig.hardware``, ``--hardware``);
2. the ``REPRO_TORCH_HARDWARE`` environment variable (the port's own: the
   parity tests import both packages in one process);
3. the device: a CUDA device whose name contains ``H100`` is ``h100``; a
   CPU device (or no card) is ``cpu``.  Another card resolves to a name
   with no profile, which the registry serves from its fallback tier.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import tile_config as tc

PLATFORM_GPU = "gpu"
PLATFORM_CPU = "cpu"
PLATFORMS = (PLATFORM_GPU, PLATFORM_CPU)

#: env var pinning the hardware profile for a whole process
HARDWARE_ENV = "REPRO_TORCH_HARDWARE"


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """One target: cost-model numbers, the card's limits, its default tier.

    ``mxu_dim`` / ``sublane`` are the alignment granules the reference's
    cost model reads (``cost_model.mxu_utilization``): on Hopper, the
    64-element (128-byte) swizzled K and N blocks of a ``wgmma`` tile and
    the 8-row MMA fragment.  ``defaults(op, dtype, shape)`` returns the
    default tier's config, or None where the profile has none.
    """
    name: str
    #: peak operations a second, keyed by input dtype name
    peak_flops: Dict[str, float]
    hbm_bandwidth: float          # bytes/s
    hbm_bytes: int                # device memory
    smem_bytes: int               # shared memory one block may use
    sm_count: int
    platform: str
    #: bytes/s of one inter-device link, the reference's
    #: ``ici_link_bandwidth``: the roofline's collective term divides each
    #: device's ring link bytes by it
    link_bandwidth: float = 0.0
    mxu_dim: int = 64
    sublane: int = 8
    #: substring of ``torch.cuda.get_device_name()`` that detects this card
    device_match: Optional[str] = None
    defaults: Optional[Callable] = dataclasses.field(default=None,
                                                     compare=False)

    def __post_init__(self):
        if self.platform not in PLATFORMS:
            raise ValueError(
                f"unknown platform {self.platform!r}; known: {PLATFORMS}")

    def peak_for(self, dtype) -> float:
        return self.peak_flops[tc._dtype_name(dtype)]

    def default_config(self, op: str, dtype,
                       shape: Optional[Tuple[int, ...]] = None):
        """The default tier's config for ``op`` at ``shape``, or None."""
        if self.defaults is None:
            return None
        return self.defaults(op, dtype, shape)


H100 = HardwareProfile(
    name="h100",
    platform=PLATFORM_GPU,
    # NVIDIA H100 SXM data sheet: dense tensor-core bf16, f32 outside them
    peak_flops={"bfloat16": 989e12, "float32": 67e12},
    hbm_bandwidth=3.35e12,
    hbm_bytes=80 * 1024 ** 3,
    smem_bytes=227 * 1024,
    sm_count=132,
    # NVLink 4 (H100 SXM data sheet): 900 GB/s over 18 links, 50 GB/s a
    # link (both directions), as the reference's gpu profile counts NVLink
    link_bandwidth=900e9 / 18,
    device_match="H100",
    defaults=tc.hand_config,
)

# The plain versions on the host: no tiles, so no default tier.  The rates
# are placeholders for the cost model's arithmetic, not a measurement.
CPU = HardwareProfile(
    name="cpu",
    platform=PLATFORM_CPU,
    peak_flops={"bfloat16": 1e11, "float32": 2e11},
    hbm_bandwidth=50e9,
    hbm_bytes=8 * 1024 ** 3,
    smem_bytes=32 * 1024 ** 2,
    sm_count=1,
    link_bandwidth=10e9,
    mxu_dim=16,
    sublane=1,
)

HARDWARE: Dict[str, HardwareProfile] = {}

#: other names -> canonical profile names
ALIASES: Dict[str, str] = {"nvidia-h100": H100.name, "host-cpu": CPU.name}


def register_profile(profile: HardwareProfile) -> HardwareProfile:
    """Register (or replace) a profile; returns it."""
    HARDWARE[profile.name] = profile
    return profile


for _p in (H100, CPU):
    register_profile(_p)


def canonical_name(name: str) -> str:
    return ALIASES.get(name, name)


def find_profile(name: str) -> Optional[HardwareProfile]:
    """The profile for ``name`` (alias-aware), or None."""
    return HARDWARE.get(canonical_name(name))


def get_profile(name: str) -> HardwareProfile:
    prof = find_profile(name)
    if prof is None:
        raise KeyError(f"unknown hardware {name!r}; known: {sorted(HARDWARE)}"
                       f" (aliases: {sorted(ALIASES)})")
    return prof


@functools.lru_cache(maxsize=None)
def _card_profile(index: int) -> str:
    """Profile name of CUDA device ``index``: the registered profile whose
    ``device_match`` its name contains, else the name in lower case with
    runs of other characters as ``-``."""
    card = torch.cuda.get_device_name(index)
    for prof in HARDWARE.values():
        if prof.device_match and prof.device_match in card:
            return prof.name
    return re.sub(r"[^a-z0-9]+", "-", card.lower()).strip("-")


def detect_hardware(device=None) -> str:
    """Profile name for this process: ``$REPRO_TORCH_HARDWARE`` if set,
    else from ``device`` (a ``torch.device`` or its string; None means the
    current CUDA device when there is a card, else the CPU)."""
    env = os.environ.get(HARDWARE_ENV)
    if env:
        return canonical_name(env)
    if device is None:
        if not torch.cuda.is_available():
            return CPU.name
        return _card_profile(torch.cuda.current_device())
    if isinstance(device, str):
        device = torch.device(device)
    if device.type != "cuda":
        return CPU.name
    return _card_profile(device.index or 0)


@functools.lru_cache(maxsize=None)
def launch_hardware(index: int) -> str:
    """:func:`detect_hardware` for CUDA device ``index``, read once a
    process: the launch path of ``core.matmul`` and
    ``core.flash_attention`` asks on every call, and reading the
    environment costs more host time than the registry lookup itself.
    ``$REPRO_TORCH_HARDWARE`` set after a process's first launch is not
    seen there (an explicit ``execution_context(hardware=...)`` is)."""
    return detect_hardware(torch.device("cuda", index))


def resolve_hardware(name: Optional[str] = None, device=None) -> str:
    """Canonical name for an optional explicit ``name``, else the detected
    one.  Unregistered names pass through: the registry serves them from
    its fallback tier with a warning."""
    if name:
        return canonical_name(name)
    return detect_hardware(device)


def resolve_profile(hardware=None) -> HardwareProfile:
    """Like :func:`resolve_hardware`, returning the profile; takes a
    profile, a name or None (detected)."""
    if isinstance(hardware, HardwareProfile):
        return hardware
    return get_profile(resolve_hardware(hardware))
