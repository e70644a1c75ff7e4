"""Per-layer metric readers: `<metric name>.py` holds `read(layer)`,
which takes the metric from the traced run's spans, counters and trace
(`layer`, what the cell's driver returned) and returns None where it
finds nothing to read."""
