"""Expert and data parallelism over ``torch.distributed``: the process
group and its differentiable collectives (``ep``), the dp x ep process grid
(``grid``), the parameter layout (``sharding``), the declarative plan a
run is launched with (``plan``) and a process launcher for one host
(``launch``)."""
from .ep import (EPGroup, all_gather_tokens, all_reduce_sum, init_ep_group,
                 reduce_scatter_tokens)
from .grid import ProcessGrid, as_grid, init_grid
from .launch import spawn
from .plan import ParallelPlan, ResolvedPlan
from .sharding import expert_shard, replicated_leaves

__all__ = ["EPGroup", "ParallelPlan", "ProcessGrid", "ResolvedPlan", "all_gather_tokens",
           "all_reduce_sum", "as_grid", "expert_shard", "init_ep_group", "init_grid",
           "reduce_scatter_tokens", "replicated_leaves", "spawn"]
