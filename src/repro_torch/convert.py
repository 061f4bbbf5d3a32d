"""Parameter and optimizer-state conversion from the JAX package.

``params_from_jax`` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray, p)`` on
the JAX side — this package never imports JAX) and returns the port's
parameter dict: the same nested layout, leaves as tensors.
``opt_state_from_jax`` does the same for an ``AdamWState``. Tests use them
to start both packages from the same weights and optimizer state, since
JAX's PRNG is not reproduced. Under expert parallelism each rank takes its
share: ``parallel.ep_shard(params, rank, world)`` of the params and
``opt_state_shard(opt, rank, world)`` of the AdamW state. On a dp x pp x
ep x tp grid, ``params_for_rank`` cuts a rank's tiles of the params,
``opt_state_for_rank`` its shards of the full optimizer state (any mode)
and ``opt_state_from_ranks`` puts the ranks' shards back together into
full numpy arrays; each cuts by ``parallel.sharding.tile_slices``.
``params_for_rank`` also takes the JAX package's tree itself and cuts each
leaf before its tile goes to the rank's device: a serving grid's ranks
(dp = pp = 1, ``serve.ServeEngine(plan=)``) take their tiles so.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import init_params, padded_vocab
from repro_torch.optim import AdamWState
from repro_torch.optim.epso import optimizer_state_specs
from repro_torch.parallel.grid import rank_coords
from repro_torch.parallel.sharding import ep_shard, tile_slices
from repro_torch.train.trainer import placements
from repro_torch.tree import leaves, leaves_with_path, tree_map


def _tensors(node, dev, dtype):
    if isinstance(node, dict):
        return {k: _tensors(v, dev, dtype) for k, v in node.items()}
    return torch.from_numpy(np.array(node, dtype=np.float32)).to(device=dev, dtype=dtype)


def params_from_jax(tree, cfg: ModelConfig, *, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Nested dict of array-likes -> nested dict of tensors on ``device`` in
    ``dtype``. Checks the embedding against ``cfg``'s padded vocab."""
    out = _tensors(tree, resolve_device(device), dtype)
    rows = out["embed"]["table"].shape[0]
    if rows != padded_vocab(cfg):
        raise ValueError(f"embedding has {rows} rows; {cfg.name} pads its vocab "
                         f"to {padded_vocab(cfg)}")
    return out


def opt_state_from_jax(opt, *, device: DeviceLike = None) -> AdamWState:
    """The JAX package's ``AdamWState`` (step, master, m, v), leaves as
    numpy arrays -> the port's, float32 on ``device``, step int32."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32, device=dev)
    return AdamWState(step, *(_tensors(t, dev, torch.float32) for t in (opt.master, opt.m, opt.v)))


def opt_state_shard(opt: AdamWState, rank: int, world: int) -> AdamWState:
    """Rank ``rank``'s share of an AdamW state over ``world`` EP ranks:
    its tiles (``ep_shard``: the expert slices, the tables' vocab rows) of
    the master weights and both moments, the rest and the step as they
    are."""
    return AdamWState(opt.step, *(ep_shard(t, rank, world) for t in (opt.master, opt.m, opt.v)))


def _grid_specs(cfg: ModelConfig, dp: int, ep: int, mode: str, tp: int = 1, pp: int = 1,
                fsdp: bool = False):
    sizes = {a: n for a, n in (("data", dp), ("pp", pp), ("ep", ep), ("tp", tp)) if n > 1}
    shapes = init_params(cfg, device="meta")
    place = placements(cfg, shapes, sizes, fsdp=fsdp)
    return shapes, optimizer_state_specs(shapes, place, sizes, mode), \
        {"data": dp, "pp": pp, "ep": ep, "tp": tp}, place


def params_for_rank(params: dict, cfg: ModelConfig, *, dp: int, ep: int, rank: int,
                    tp: int = 1, pp: int = 1, device: DeviceLike = None,
                    dtype: torch.dtype = None, fsdp: bool = False) -> dict:
    """Copies of rank ``rank``'s tiles of a whole parameter tree on a dp x
    pp x ep x tp grid (rank = ((d * pp + p) * ep + e) * tp + t): what
    ``train.init_state`` cuts there from the same whole params. The leaves
    are tensors or numpy arrays (the JAX package's, ``jax.tree.map(
    np.asarray, p)``, whose tiles become float32 tensors); each leaf is cut
    before its tile is copied, to ``device`` as ``dtype`` where given.
    ``fsdp``: the layout with the 'data' tiles (``init_state(fsdp=True)``)."""
    _, _, sizes, place = _grid_specs(cfg, dp, ep, "none", tp, pp, fsdp)
    coords = rank_coords(rank, sizes)
    dev = None if device is None else resolve_device(device)

    def cut(leaf, pl):
        tile = leaf[tile_slices(pl, tuple(leaf.shape), coords, sizes)]
        if not torch.is_tensor(tile):
            tile = torch.from_numpy(np.array(tile, dtype=np.float32))
        return tile.to(device=dev, dtype=dtype, copy=True)

    return tree_map(cut, params, place)


def opt_state_for_rank(opt: AdamWState, cfg: ModelConfig, *, dp: int, ep: int, rank: int,
                       mode: str, device: DeviceLike = None, tp: int = 1,
                       pp: int = 1, fsdp: bool = False) -> AdamWState:
    """Rank ``rank``'s state on a dp x pp x ep x tp grid (rank = ((d * pp +
    p) * ep + e) * tp + t) under ``opt_sharding_mode`` ``mode``, from a full AdamW state: the JAX
    package's with numpy leaves (converted by ``opt_state_from_jax`` onto
    ``device``) or the port's. Each of master, m and v is cut by its state
    placement (``optim.epso.optimizer_state_specs`` of the port's param
    placements), as copies; the step is kept. The shards equal what
    ``train.init_state`` cuts on that rank from the same full state (with
    ``fsdp``, ``init_state(fsdp=True)``)."""
    if not torch.is_tensor(leaves(opt.master)[0]):
        opt = opt_state_from_jax(opt, device=device)
    _, specs, sizes, _ = _grid_specs(cfg, dp, ep, mode, tp, pp, fsdp)
    coords = rank_coords(rank, sizes)

    def cut(tree):
        return tree_map(lambda t, spec: t[tile_slices(spec, t.shape, coords, sizes)].clone(),
                        tree, specs)
    return AdamWState(opt.step, *(cut(t) for t in (opt.master, opt.m, opt.v)))


def opt_state_from_ranks(states: list, cfg: ModelConfig, *, dp: int, ep: int,
                         mode: str, tp: int = 1, pp: int = 1, fsdp: bool = False) -> dict:
    """The inverse of ``opt_state_for_rank``: the ranks' states (in rank
    order) put back together into full float32 numpy arrays, ``{"master",
    "m", "v"}`` each a dict of leaves by path ('layers/moe/gate'), and
    ``"step"``. Ranks that hold the same tile must agree on it exactly."""
    shapes, specs, sizes, _ = _grid_specs(cfg, dp, ep, mode, tp, pp, fsdp)
    out = {"step": int(states[0].step)}
    for what in ("master", "m", "v"):
        full = {path: np.full(tuple(leaf.shape), np.nan, dtype=np.float32)
                for path, leaf in leaves_with_path(shapes)}
        for rank, st in enumerate(states):
            coords = rank_coords(rank, sizes)
            for (path, shard), spec in zip(leaves_with_path(getattr(st, what)), leaves(specs)):
                sl = tile_slices(spec, full[path].shape, coords, sizes)
                tile = shard.detach().cpu().float().numpy()
                seen = full[path][sl]
                if not np.isnan(seen).all() and not np.array_equal(seen, tile):
                    raise ValueError(f"{what} {path}: rank {rank}'s tile differs from "
                                     f"another rank's copy")
                full[path][sl] = tile
        out[what] = full
    return out
