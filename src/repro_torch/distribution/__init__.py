"""Distribution layer: sharding rules as DTensor placements, elastic
re-meshing and straggler monitoring."""
from .elastic import ElasticMesh, StragglerMonitor
from .sharding import batch_specs, cache_specs, param_specs, to_placements

__all__ = ["param_specs", "batch_specs", "cache_specs", "to_placements",
           "ElasticMesh", "StragglerMonitor"]
