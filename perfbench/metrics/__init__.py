"""Per-layer metrics: one reader a file, `<metric name>.py` or, serving every
metric of that stem, `<the name's part before its first dot>.py`, each with
`read(readings) -> float | None`; the shared arithmetic in `_flops.py`."""
