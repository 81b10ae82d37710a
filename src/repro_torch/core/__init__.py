"""Port of ``repro/core`` (see the package docstring)."""
