"""The device an entry point runs on (the train step's and the
simulator's)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU
    (where every kernel wrapper runs its plain version)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run it on the CPU through the kernels' plain versions"
        )
    return dev
