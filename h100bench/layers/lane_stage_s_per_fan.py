"""Lane staging: seconds a fan in the program's ``obs`` phase
``soa_stage`` (the lanes' arrays assembled from the sampler's draws,
then uploaded with the problem's statics before round 0)."""


def read(t):
    stage = t.phases.get("soa_stage")
    fans = t.extras.get("fans", 0)
    if not stage or not fans:
        return None
    return stage["total_s"] / fans
