"""Port of ``repro/configs`` (see the package docstring)."""
