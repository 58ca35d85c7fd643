"""The program's own table of spans and counters
(`genconvit_tpu_torch.utils.timing.spans()`: per name its count, total and
self seconds). The program fills it only while the profiler records, so
in a `--trace 1` run it covers the traced slice alone. A checkout whose
program has no such table, an untraced run, or a span the slice never
entered reads nothing."""


def table() -> dict:
    try:
        from genconvit_tpu_torch.utils import timing
    except ImportError:
        return {}
    read = getattr(timing, "spans", None)
    return read() if callable(read) else {}


def mean_ms(name: str, field: str = "total_s"):
    """`field` of the span `name` over its own count, in ms."""
    row = table().get(name)
    return 1e3 * row[field] / row["count"] if row and row["count"] else None
