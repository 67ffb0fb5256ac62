"""Metric readers: ``metrics/<name>.py`` holds ``read(rec)``, which returns the
metric's value from a run's records, or None where it finds nothing to read."""
