"""The vocab-parallel embedding lookup, LM head and cross-entropy: the
port's counterpart of the JAX package's vocab-split ``embed/table`` and
``head/table`` (``parallel/sharding.py``'s ``mdl = tp or ep``), whose
lookup and loss its compiler partitions. Neither has a kernel: the JAX
embedding and cross-entropy are plain ``jnp``, and these are plain PyTorch.

Rank k of the split's group holds vocab rows ``[k * n, (k + 1) * n)`` of a
(V_pad, d) table, ``n = V_pad / world`` (``sharding.vocab_axis``); the
padded columns (ids >= ``vocab_size``) lie in the last rank's rows and are
masked by their global index, as ``models.model.masked_nll`` masks them.
A ``VocabShard`` says which of two forms a call takes:

* **the same rows** on every rank of the group (``same_rows``: the 'tp'
  axis, whose ranks share their batch rows; the 'ep' axis while serving,
  where every rank holds the whole batch; a pipeline stage's tp group).
  The lookup zeroes the ids outside the rank's range and sums the rows
  over the group (``tp_reduce``: its backward is the identity, so the
  table's gradient stays the rank's own). The head computes the rank's
  logit columns from ``tp_copy`` of the hidden states (its backward sums
  their gradient over the group). The cross-entropy takes the row max
  (an all-reduce of the max), the sum of exponentials and the target
  logit (one all-reduce of both) over the group; every rank then holds
  the same per-row NLL, and its backward is local;
* **rows that differ** across the group (the 'ep' axis in training, whose
  ranks split the batch over ('data', 'ep')). The token ids, or for the
  head the hidden states, are gathered over the group first, as the
  allgather Stage 1 gathers them (``all_gather_tokens``); the same-rows
  work then runs on the gathered rows, and each rank gets its own rows
  back: the lookup's partial rows are reduce-scattered
  (``reduce_scatter_tokens``), the head's hidden-state gradient is
  reduce-scattered by the gather's backward, and the cross-entropy's
  per-row NLL is cut to the rank's block. Each rank's loss is its share,
  so the backward of the cross-entropy first sums the per-row NLL
  gradient over the group: a rank's logit columns of every gathered row
  take the whole loss's gradient, and its table gradient covers every
  rank's tokens (``train.trainer`` then sums it over 'data' and 'pp'
  alone).

The sums that make a lookup add one nonzero row to zeros, so the looked-up
rows are the whole table's bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .ep import (EPGroup, _all_reduce, all_gather_dim, all_gather_tokens, all_to_all_rows,
                 reduce_scatter_tokens, tp_copy, tp_reduce)
from .sharding import vocab_axis

NEG = -1e9          # the padded columns' logit (``models.model.masked_nll``)


@dataclass(frozen=True)
class VocabShard:
    """A table tile's split."""
    group: EPGroup           # the ranks that split the vocab rows
    rows: int                # the padded vocab V_pad
    same_rows: bool          # whether the group's ranks hold the same batch rows

    @property
    def lo(self) -> int:
        """The first vocab id of the rank's rows."""
        return self.group.rank * (self.rows // self.group.world)


def vocab_shard(table: torch.Tensor, vocab_rows: int, *, ep: Optional[EPGroup] = None,
                tp: Optional[EPGroup] = None, replicated: bool = False) -> Optional[VocabShard]:
    """The split of ``table`` (a rank's tile of a (``vocab_rows``, d)
    table), or None when it is whole. ``ep`` / ``tp``: the rank's 'ep' and
    'tp' groups; the split is over ``sharding.vocab_axis`` of their sizes,
    the rule ``param_placements`` cut the tile by. ``replicated``: every
    rank holds the whole batch (serving), so the ranks of 'ep' hold the
    same rows too."""
    if table.shape[0] == vocab_rows:
        return None
    sizes = {"ep": ep.world if ep is not None else 1, "tp": tp.world if tp is not None else 1}
    axis = vocab_axis(sizes, vocab_rows)
    group = {"tp": tp, "ep": ep}.get(axis)
    if group is None or table.shape[0] * group.world != vocab_rows:
        raise ValueError(f"a table tile of {table.shape[0]} rows of {vocab_rows} on a grid of "
                         f"{sizes}: the vocab split is over {axis!r}")
    return VocabShard(group, vocab_rows, axis == "tp" or replicated)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype,
          vs: VocabShard) -> torch.Tensor:
    """The rows of ``tokens`` (B, S) from the rank's tile, in ``dtype``:
    the whole table's lookup, bit for bit."""
    g, n = vs.group, table.shape[0]
    ids = tokens if vs.same_rows else all_gather_dim(tokens, g)
    local = ids.long() - vs.lo
    hit = (local >= 0) & (local < n)
    rows = torch.where(hit[..., None], table[local.clamp(0, n - 1)], 0).to(dtype)
    return tp_reduce(rows, g) if vs.same_rows else reduce_scatter_tokens(rows, g)


def logits(table: torch.Tensor, h: torch.Tensor, vs: VocabShard) -> torch.Tensor:
    """The whole (..., V_pad) logits of the rank's rows of ``h`` (..., d):
    its columns from its tile, put together over the group (an all-gather
    of the columns; with rows that differ, the gathered rows' columns
    exchanged back to their ranks). Differentiable."""
    g = vs.group
    if vs.same_rows:
        return _GatherColumns.apply(tp_copy(h, g) @ table.T.to(h.dtype), g)
    part = all_gather_tokens(h, g) @ table.T.to(h.dtype)          # (world * B, ..., n)
    mine = all_to_all_rows(part, g)                               # rank r's column blocks
    blocks = mine.reshape((g.world, -1) + tuple(mine.shape[1:]))
    return torch.cat(blocks.unbind(0), dim=-1)


def nll(table: torch.Tensor, h: torch.Tensor, labels: torch.Tensor, vocab_size: int,
        vs: VocabShard):
    """The summed next-token NLL of the rank's rows of ``h`` (B, S, d)
    against ``labels`` (B, S) (< 0 masked) and the count of unmasked
    labels: ``models.model.masked_nll`` of the whole logits, computed on
    the rank's columns."""
    g = vs.group
    ids = labels
    if vs.same_rows:
        x = tp_copy(h, g)
    else:
        x, ids = all_gather_tokens(h, g), all_gather_dim(labels, g)
    per_row = _VocabNLL.apply(x @ table.T.to(h.dtype), ids, vs.lo, vocab_size, g,
                              not vs.same_rows)
    if not vs.same_rows:
        per_row = per_row.chunk(g.world)[g.rank]
    return per_row.sum(), (labels >= 0).sum()


# ----------------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------------

def _all_reduce_max(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    out = x.contiguous().clone()
    if g.world > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g.group)
    return out


class _GatherColumns(torch.autograd.Function):
    """The ranks' column blocks concatenated on the last dim; backward: the
    rank's own block of the gradient (every rank's loss is the same
    function of the whole logits)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.n = g, x.shape[-1]
        return all_gather_dim(x, g, -1)

    @staticmethod
    def backward(ctx, dy):
        r = ctx.g.rank
        return dy[..., r * ctx.n:(r + 1) * ctx.n], None


class _VocabNLL(torch.autograd.Function):
    """Per-row NLL (labels < 0: 0) of logits whose columns ``[lo, lo + n)``
    the rank holds, the same on every rank of ``g``. ``sum_grad``: every
    rank's loss is its share of the rows, so the backward sums the
    per-row gradient over ``g`` before it takes the rank's columns'."""

    @staticmethod
    def forward(ctx, part, labels, lo, vocab_size, g, sum_grad):
        x = part.float()
        n = x.shape[-1]
        if lo + n > vocab_size:       # the padded columns, by their global index
            pad = torch.arange(lo, lo + n, device=x.device) >= vocab_size
            x = x.masked_fill(pad, NEG)
        m = _all_reduce_max(x.amax(dim=-1), g)
        e = torch.exp(x - m[..., None])
        local = labels.long() - lo
        hit = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        tgt = torch.where(hit, torch.gather(x, -1, idx[..., None])[..., 0], 0.0)
        del x
        sums = _all_reduce(torch.stack([e.sum(dim=-1), tgt]), g)
        mask = labels >= 0
        out = torch.where(mask, (torch.log(sums[0]) + m) - sums[1], 0.0)
        ctx.save_for_backward(e, sums[0], idx, hit, mask)
        ctx.g, ctx.sum_grad, ctx.dtype = g, sum_grad, part.dtype
        return out

    @staticmethod
    def backward(ctx, d_out):
        e, s, idx, hit, mask = ctx.saved_tensors
        if ctx.sum_grad:
            d_out = _all_reduce(d_out, ctx.g)
        d = torch.where(mask, d_out.float(), 0.0)
        grad = e * (d / s)[..., None]
        grad.scatter_add_(-1, idx[..., None], -torch.where(hit, d, 0.0)[..., None])
        return grad.to(ctx.dtype), None, None, None, None, None
