"""ADS-Tile runtime scheduler (paper §IV).

The spatio-temporal isolation-sharing space is spanned by two
mechanisms: *configurable isolation* (partition-local tile pools bound
**where** reallocation propagates — the partitions come from GHA Phase
II) and *elastic reservation* (ERT admission + minimum-quota control
bound **when** tasks enter colocation).  Within that space the
DAG-aware scheduler (Algorithm 2) shares tiles across co-active paths
and slack along DAG edges.
"""
from .reservation import fit_quota, most_urgent_plan, plan_slack
from .scheduler import AdsTilePolicy
from .l2p import L2PMap
from .forecast import ModeForecast, ModeForecaster
from .autotune import (
    FrontierPoint,
    ModeFrontier,
    autotune_mode,
    predict_miss,
)
from .replan import (
    OnlineReplanner,
    PredictiveReplanner,
    SchedulePortfolio,
    blend_schedules,
)

__all__ = [
    "AdsTilePolicy", "fit_quota", "plan_slack", "most_urgent_plan", "L2PMap",
    "ModeForecast", "ModeForecaster",
    "FrontierPoint", "ModeFrontier", "autotune_mode", "predict_miss",
    "OnlineReplanner", "PredictiveReplanner", "SchedulePortfolio",
    "blend_schedules",
]
