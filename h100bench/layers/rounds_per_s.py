"""Round loop: rounds a second, counter ``soa_rounds`` over phase
``soa_loop`` (which ends once the loop's results are on the host, so it
holds the device's time too)."""


def read(t):
    loop = t.phases.get("soa_loop")
    if not loop or loop["total_s"] <= 0:
        return None
    return t.counters.get("soa_rounds", 0) / loop["total_s"]
