"""Port of ``repro/serving`` (see the package docstring)."""
from repro_torch.serving.engine import Request, ServeEngine
