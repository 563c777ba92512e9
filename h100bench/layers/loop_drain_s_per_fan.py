"""Round loop: seconds a fan in the program's ``obs`` phase
``soa_drain``, the copies of the final state to the host, which wait
for the card to finish the rounds issued: near zero while the host sets
the pace, growing once the card does."""


def read(t):
    drain = t.phases.get("soa_drain")
    fans = t.extras.get("fans", 0)
    if not drain or not fans:
        return None
    return drain["total_s"] / fans
