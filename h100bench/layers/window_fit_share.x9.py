"""SoA entry: share of the window's fans whose first round loop ran at
the job window fitted to what the cell's earlier loops needed and did
not overflow it, the program's ``obs`` counter ``soa_window_fit_hits``
over the fans.  A fan that overflows its fit retries wider
(``soa_window_retries``); a fan at the default window is no hit."""


def read(t):
    fans = t.extras.get("fans", 0)
    hits = t.counters.get("soa_window_fit_hits")
    if hits is None or not fans:
        return None
    return hits / fans
