"""Per-layer readers: metrics/<metric name>.py, each with `read(ctx)`,
loaded by file (harness.read_metric); `_common.py` holds what they share."""
