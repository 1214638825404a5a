"""Per-layer metrics, one reader a metric, found by the metric's name:
``read(outcome)`` returns the value, or None where the run gave it
nothing to read (the harness then leaves the metric out of the line)."""
