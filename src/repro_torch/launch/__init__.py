"""Port of ``repro/launch`` (see the package docstring)."""
