"""The "cloud" of the port: one torch.device (h2o3_tpu/parallel/mesh.py).

The JAX package forms a device mesh over every visible chip and row-shards
frames over it. This slice runs on ONE device and has no mesh: `init()`
selects `cuda:0`, `init(device="cpu")` selects the CPU (the tests' way in),
and every Frame, Vec and estimator reads its device from here. Without a
CUDA card `init()` raises; it never carries on quietly on the CPU.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from h2o3_tpu_torch.core.kvstore import DKV

_lock = threading.Lock()
_CLOUD: "Cloud | None" = None


@dataclass
class Cloud:
    device: torch.device
    name: str = "h2o3-tpu-torch"


def init(device: str | torch.device | None = None,
         name: str | None = None) -> Cloud:
    """Form the cloud (h2o.init analog). `device=None` means the first CUDA
    card and raises when there is none; pass `device="cpu"` to run on the
    CPU. Calling it again replaces the cloud."""
    global _CLOUD
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "h2o3_tpu_torch.init(): no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    with _lock:
        _CLOUD = Cloud(device=dev, name=name or "h2o3-tpu-torch")
        return _CLOUD


def cloud() -> Cloud:
    """The formed cloud; forms the default (CUDA) one on first use."""
    c = _CLOUD
    return c if c is not None else init()


def shutdown():
    global _CLOUD
    with _lock:
        DKV.clear()
        _CLOUD = None
