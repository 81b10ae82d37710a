"""Port of ``repro/data`` (see the package docstring)."""
