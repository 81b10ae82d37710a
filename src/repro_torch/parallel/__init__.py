"""Port of ``repro/parallel`` (see the package docstring)."""
