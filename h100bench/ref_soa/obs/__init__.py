"""The frozen reference's share of ``obs``: the metrics registry alone,
which stays disabled."""
from . import metrics

__all__ = ["metrics"]
