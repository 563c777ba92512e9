"""Round loop: share of the rounds' job-window columns that held a
released, unresolved job (lane-columns summed over rounds), the
program's ``obs`` counters ``soa_window_live`` over ``soa_window_cols``.
The rest of each round's (R, W) work is spent on columns that are not
yet released or already resolved."""


def read(t):
    live = t.counters.get("soa_window_live")
    cols = t.counters.get("soa_window_cols")
    if live is None or not cols:
        return None
    return live / cols
