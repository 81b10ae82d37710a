"""Port of ``repro/checkpoint`` (see :mod:`repro_torch.checkpoint.store`)."""
from repro_torch.checkpoint.store import CheckpointStore, flatten_state, unflatten_like

__all__ = ["CheckpointStore", "flatten_state", "unflatten_like"]
