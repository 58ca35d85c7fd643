"""The harness's general parts: lookup by name, traffic, tracing, the
comparisons that decide `correct`, and the result line."""
