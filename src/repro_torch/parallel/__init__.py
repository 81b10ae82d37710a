"""Port of ``repro/parallel`` (see the package docstring)."""
from repro_torch.parallel import collectives
from repro_torch.parallel.pp import pipeline_forward

__all__ = ["collectives", "pipeline_forward"]
