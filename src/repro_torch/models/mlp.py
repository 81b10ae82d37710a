"""SwiGLU and GELU MLP blocks (port of ``repro/models/mlp.py``; both
column-parallel in and row-parallel out over the model axis)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import SINGLE, Axes, swiglu


def swiglu_mlp(p, x: torch.Tensor, axes: Axes = SINGLE) -> torch.Tensor:
    """p: {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}, f the
    rank's d_ff/tp columns; x: (B, T, d). The out projection's partial
    sums are summed over ``axes``' model group."""
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return axes.psum_tp(swiglu(g, u) @ p["w_down"].to(x.dtype))


def gelu_mlp(p, x: torch.Tensor, axes: Axes = SINGLE) -> torch.Tensor:
    """p: {"w_in": (d, f), "b_in": (f,), "w_out": (f, d), "b_out": (d,)}, f
    the rank's d_ff/tp columns (``b_out`` replicated); x: (B, T, d).
    ``b_in`` is added in the activation type before the GELU; ``w_out``'s
    partial sums are summed over ``axes``' model group and then ``b_out``
    is added, once. The GELU is the tanh approximation, the default of
    ``jax.nn.gelu`` (the exact erf form differs by ~1e-3)."""
    h = x @ p["w_in"].to(x.dtype)
    h = F.gelu(h + p["b_in"].to(h.dtype), approximate="tanh")
    out = axes.psum_tp(h @ p["w_out"].to(x.dtype))
    return out + p["b_out"].to(out.dtype)
