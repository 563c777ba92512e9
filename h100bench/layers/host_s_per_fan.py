"""Host set-up, sampler and reports: seconds a fan in the program's own
``obs`` phases ``portfolio_compile``, ``soa_build``, ``trace_sample`` and
``soa_reports``."""

PHASES = ("portfolio_compile", "soa_build", "trace_sample", "soa_reports")


def read(t):
    fans = t.extras.get("fans", 0)
    if not fans or not any(p in t.phases for p in PHASES):
        return None
    return sum(t.phases[p]["total_s"] for p in PHASES if p in t.phases) / fans
