"""Device resolution shared by the port's entry points.

The port runs on the CUDA device unless the caller asks for the CPU
explicitly; a missing GPU is an error, never a silent fallback."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the current CUDA device; raises when there is none.
    Any explicit device (`"cpu"`, `"cuda:1"`) is taken as given; a bare
    `"cuda"` gets the current device's index, so the net's device equals
    its tensors' `.device`."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available; "
                f"pass device='cpu' to run the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
