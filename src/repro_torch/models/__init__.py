"""Port of ``repro/models`` (see the package docstring)."""
