"""Where the port's entry points run: the card, unless the caller asks for
the CPU.  With no card and no explicit CPU request they raise; they never
carry on quietly on the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``); a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def card_label(device: DeviceLike = None) -> str:
    """What a measurement ran on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them (``NVIDIA
    H100 80GB HBM3, 700.00 W``), its name alone where ``nvidia-smi`` cannot
    be read, or ``cpu``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    import subprocess
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"
