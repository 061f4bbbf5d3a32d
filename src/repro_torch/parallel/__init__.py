"""Expert parallelism over ``torch.distributed``: the process group and its
differentiable collectives (``ep``), the expert-stack layout (``sharding``)
and a process launcher for one host (``launch``)."""
from .ep import (EPGroup, all_gather_tokens, all_reduce_sum, init_ep_group,
                 reduce_scatter_tokens)
from .launch import spawn
from .sharding import expert_shard, replicated_leaves

__all__ = ["EPGroup", "all_gather_tokens", "all_reduce_sum", "expert_shard", "init_ep_group",
           "reduce_scatter_tokens", "replicated_leaves", "spawn"]
