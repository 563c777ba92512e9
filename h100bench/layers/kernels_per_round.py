"""Round loop: device operations a round in the profiled window, its
kernels over its rounds.  The window spans the benchmark's allocator
launches ``extras["alloc_launches"]``; the program's counters give the
allocator's calls a round, ``soa_alloc_calls`` over ``soa_rounds``."""


def read(t):
    calls = t.counters.get("soa_alloc_calls", 0)
    rounds = t.counters.get("soa_rounds", 0)
    launches = t.extras.get("alloc_launches", 0)
    if not t.kernels or not calls or not rounds or not launches:
        return None
    return len(t.kernels) * calls / (launches * rounds)
