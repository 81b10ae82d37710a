"""SwiGLU MLP block (port of ``repro/models/mlp.py`` at tp = 1)."""
from __future__ import annotations

import torch

from repro_torch.models.common import swiglu


def swiglu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """p: {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}; x: (B, T, d)."""
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return swiglu(g, u) @ p["w_down"].to(x.dtype)
