"""Round loop: host microseconds to issue one round, the program's
``obs`` phase ``soa_issue`` (the call of ``_run_rounds``: the state
planes' set-up and every round, waiting on the card nowhere) over the
counter ``soa_rounds``."""


def read(t):
    issue = t.phases.get("soa_issue")
    rounds = t.counters.get("soa_rounds", 0)
    if not issue or not rounds:
        return None
    return 1e6 * issue["total_s"] / rounds
