"""Port of ``repro/utils`` (see the package docstring)."""
