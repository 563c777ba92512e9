"""One reader per per-layer metric, ``<metric>.py`` with ``read(trace)``:
it takes the metric from a :class:`h100bench.tracing.TraceData` and
returns None where it finds nothing to read."""
