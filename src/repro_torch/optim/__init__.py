"""Port of ``repro/optim`` (see the package docstring)."""
