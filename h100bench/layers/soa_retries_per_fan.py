"""SoA entry: window retries a fan (``obs`` counter
``soa_window_retries``; each retry runs the whole round loop again)."""


def read(t):
    fans = t.extras.get("fans", 0)
    if not fans:
        return None
    return t.counters.get("soa_window_retries", 0) / fans
