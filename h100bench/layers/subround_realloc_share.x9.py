"""Round loop: share of the partitions' reallocations that the loop took
in a sub-round, a round after the first of its ``dt_s`` step: the steps
of a realloc cascade that one round a step would have cut short.  The
program's ``obs`` counters ``soa_subround_reallocs`` over
``soa_reallocs`` (None where the program counts no sub-round
reallocations: one round a step)."""


def read(t):
    sub = t.counters.get("soa_subround_reallocs")
    total = t.counters.get("soa_reallocs")
    if sub is None or not total:
        return None
    return sub / total
