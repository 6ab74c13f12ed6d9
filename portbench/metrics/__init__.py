"""Metric readers, one module per metric (its name up to the first dot):
``read(ctx: harness.RunContext)`` returns the value, or None where the
run gives it nothing to read."""
