"""AdamW and the learning-rate schedule of the paper's recipe (§2.1)."""
from .adamw import (AdamWState, adamw_init, adamw_leaf, adamw_update, clip_scale,
                    expert_leaf_mask, expert_slice_sumsq, global_norm)
from .schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_leaf", "adamw_update", "clip_scale",
           "expert_leaf_mask", "expert_slice_sumsq", "global_norm", "warmup_cosine"]
