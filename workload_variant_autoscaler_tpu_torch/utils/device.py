"""Device and dtype resolution, and the one readback per sizing group.

Entry points run on the card unless the caller asks for the CPU: a
request for `cuda` on a host without CUDA raises, it never drops to the
CPU on its own. float32 is the default dtype (the TPU's working type);
float64 is used when asked, as the parity tests do.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from ..obs.profile import DEVICE_AUDIT

DEFAULT_DTYPE = torch.float32

# The reference package's platform knob, read by the port's process entry
# points (the controller, the planner): unset, empty or one of
# CARD_PLATFORMS runs on the card, `cpu` on the host; any other value
# (e.g. `tpu`) is refused.
PLATFORM_ENV = "WVA_PLATFORM"
CARD_PLATFORMS = ("", "cuda", "gpu", "ambient")


def resolve_device(device=None) -> torch.device:
    """`cuda` unless told otherwise; raises when CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def platform_device(process: str) -> tuple[str, torch.device | None]:
    """(platform, device) of `WVA_PLATFORM` for `process`: the card or
    the host, or device None for a value the port does not know (the
    caller exits 1). Raises, naming the knob, when the card is asked for
    and CUDA is absent."""
    raw = os.environ.get(PLATFORM_ENV, "").strip().lower()
    if raw not in CARD_PLATFORMS + ("cpu",):
        return raw, None
    try:
        return raw or "cuda", resolve_device("cpu" if raw == "cpu"
                                             else "cuda")
    except RuntimeError as e:
        raise RuntimeError(f"{e} ({process}: set {PLATFORM_ENV}=cpu)") from e


def resolve_dtype(dtype=None) -> torch.dtype:
    """float32 by default; float64 when asked."""
    if dtype is None:
        return DEFAULT_DTYPE
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    return dtype


def device_name(device) -> str:
    """"cpu", or the card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (the
    label every number measured on the card carries). Raises when
    nvidia-smi cannot read the card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    # torch's index need not be nvidia-smi's (CUDA_VISIBLE_DEVICES, the
    # fastest-first order), so the card is named by its UUID
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "GPU-" + uuid.removeprefix("GPU-")],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def readback(t: torch.Tensor, shards: int = 1,
             direction: str = "d2h") -> np.ndarray:
    """The single device-to-host copy of a packed result (counted as one
    transfer by the device audit under `direction`: "d2h" for a sizing
    group's result, "d2h-drift" for the drift watchdog's one a pass;
    `shards` > 1 marks the gathered result of a lane mesh)."""
    DEVICE_AUDIT.note_transfer(direction, shards=shards)
    return t.detach().cpu().numpy()
