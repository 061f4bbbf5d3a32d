"""Expert, data, tensor and pipeline parallelism over ``torch.distributed``:
the process group and its differentiable collectives (``ep``), the dp x pp
x ep x tp process grid (``grid``), the parameter layout (``sharding``), the
declarative plan a run is launched with (``plan``), the pipeline schedules
and their executor (``pipeline``), expert placement and live EP
rebalancing (``placement``), the vocab-parallel embedding and
cross-entropy (``vocab``) and a process launcher for one host
(``launch``)."""
from .ep import (EPGroup, all_gather_tokens, all_reduce_sum, all_to_all_rows, init_ep_group,
                 reduce_scatter_tokens, tp_copy, tp_reduce)
from .grid import ProcessGrid, as_grid, init_grid
from .launch import spawn
from .placement import ExpertPlacement, RebalanceController, apply_placement
from .plan import ParallelPlan, ResolvedPlan
from .sharding import ep_shard, replicated_leaves

__all__ = ["EPGroup", "ExpertPlacement", "ParallelPlan", "ProcessGrid", "RebalanceController",
           "ResolvedPlan", "all_gather_tokens", "all_reduce_sum", "all_to_all_rows",
           "apply_placement", "as_grid", "ep_shard", "init_ep_group", "init_grid",
           "reduce_scatter_tokens", "replicated_leaves", "spawn", "tp_copy", "tp_reduce"]
