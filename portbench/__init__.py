"""The port's benchmark: one H100, the program ``repro_torch`` (see
README.md)."""
