"""Device: share of the profiled window of rounds with no kernel
running, in %."""
from h100bench.tracing import idle_pct


def read(t):
    return idle_pct(t)
