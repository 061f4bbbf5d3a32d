"""The rank functions of the expert-parallel tests (tests/test_torch_ep.py
and tests/test_torch_cuda.py), run by ``repro_torch.parallel.spawn`` in
processes of their own. This module imports torch and the port only: each
rank imports it, and a rank needs no JAX."""
import torch

from repro_torch.configs import ParallelConfig
from repro_torch.convert import opt_state_shard
from repro_torch.core import moe as tmoe
from repro_torch.models import loss_fn
from repro_torch.parallel import ep_shard
from repro_torch.parallel.sharding import param_placements
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import leaves_with_path

AUX, Z = 0.5, 0.1            # loss weights of the block test's aux and z terms
KEYS = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_counts", "moe_drops")


def block_rank(group, tc, tp, x, ct, placement=None):
    """One rank, on its device: its share of the block's params (whole
    stacks in the order ``placement``, the (E,) id -> position row, stores
    them, or global order) and of x (B, S, d); the block's outputs and the
    gradients of its share of the loss sum(out * ct) + AUX * aux + Z * z."""
    rank, world, dev = group.rank, group.world, group.device
    x, ct = x.to(dev), ct.to(dev)
    p = {k: v.to(dev).clone().requires_grad_()
         for k, v in ep_shard({"moe": tp}, rank, world)["moe"].items()}
    rows = slice(rank * x.shape[0] // world, (rank + 1) * x.shape[0] // world)
    xl = x[rows].clone().requires_grad_()
    out, aux, z, st = tmoe.sparse_moe_block(p, xl, tc, ep_group=group, placement=placement)
    loss = (out * ct[rows]).sum() + (AUX * aux + Z * z) / world
    grads = torch.autograd.grad(loss, [xl] + [p[k] for k in ("router", "gate", "up", "down")])
    return {"out": out, "aux": aux, "z": z, "counts": st.counts, "drops": st.drops,
            "grads": dict(zip(("x", "router", "gate", "up", "down"), grads))}


def train_rank(group, tc, train, nmb, params, opt, batches):
    """One rank: its share of the params and AdamW state, ``nmb``
    microbatches per step, one step per batch on its rows; the metrics and
    the state after the steps."""
    rank, world = group.rank, group.world
    state = TrainState(ep_shard(params, rank, world), opt_state_shard(opt, rank, world))
    step = make_train_step(tc, ParallelConfig(microbatches=nmb), train, ep_group=group)
    metrics = []
    for b in batches:
        n = b["tokens"].shape[0] // world
        state, m = step(state, {k: v[rank * n:(rank + 1) * n] for k, v in b.items()})
        metrics.append({k: m[k] for k in KEYS})
    return {"metrics": metrics, "params": dict(leaves_with_path(state.params)),
            "m": dict(leaves_with_path(state.opt.m)), "v": dict(leaves_with_path(state.opt.v)),
            "step": int(state.opt.step)}


def loss_rank(group, tc, params, batch):
    """One rank: ``loss_fn`` on its rows; its share and the metrics."""
    n = batch["tokens"].shape[0] // group.world
    rows = slice(group.rank * n, (group.rank + 1) * n)
    share, m = loss_fn(ep_shard(params, group.rank, group.world),
                       {k: v[rows] for k, v in batch.items()}, tc, compute_dtype=torch.float32,
                       ep_group=group)
    return {"share": share, **m}


def fail_on_rank_1(group):
    """Rank 1 raises; rank 0 waits for it in a barrier."""
    if group.rank == 1:
        raise ValueError("rank 1 stops")
    torch.distributed.barrier()


def broadcast_rank(group, params):
    """Rank r's share of ``params`` with r added to every leaf, then
    ``checkpoint.broadcast_params`` over the group, on the share's
    placement."""
    from repro_torch.checkpoint import broadcast_params
    from repro_torch.tree import tree_map
    mine = tree_map(lambda t: t.clone() + group.rank,
                    ep_shard(params, group.rank, group.world))
    return broadcast_params(mine, group, param_placements(params, {"ep": group.world}))


def grid_rows(grid, b: dict) -> dict:
    """The rows of batch ``b`` that the grid rank takes: block d * ep + e of
    dp * ep (the tp ranks of one (data, ep) coordinate take the same)."""
    c, s = grid.coords, grid.sizes
    n = b["tokens"].shape[0] // (s["data"] * s["ep"])
    i = c["data"] * s["ep"] + c["ep"]
    return {k: v[i * n:(i + 1) * n] for k, v in b.items()}


def grid_train_rank(grid, tc, train, params, opt, batches, runs):
    """One rank of a dp x ep (x tp) grid: for each (mode, overlap) of
    ``runs``, from the same full params and AdamW state, the rank's share
    (its expert slices and tp shards; its optimizer shards under
    'so'/'epso'), one step per batch on its rows; per run the metrics,
    params, state and the state's bytes measured against
    ``state_bytes_per_device``."""
    from repro_torch.convert import opt_state_for_rank, params_for_rank
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves

    rank = grid.world.rank
    dp, ep, tp = grid.sizes["data"], grid.sizes["ep"], grid.sizes["tp"]
    shapes = init_params(tc, device="meta")
    out = {}
    for mode, overlap in runs:
        mine = params_for_rank(params, tc, dp=dp, ep=ep, tp=tp, rank=rank)
        st = opt_state_for_rank(opt, tc, dp=dp, ep=ep, tp=tp, rank=rank, mode=mode)
        state = TrainState(mine, st)
        step = make_train_step(tc, ParallelConfig(opt_overlap=overlap), train,
                               opt_sharding_mode=mode, grid=grid)
        metrics = []
        for b in batches:
            state, m = step(state, grid_rows(grid, b))
            metrics.append({k: m[k] for k in KEYS if k in m})
        held = sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m, state.opt.v)
                   for t in leaves(tree))
        sizes = grid.axis_sizes
        out[(mode, overlap)] = {
            "metrics": metrics, "params": dict(leaves_with_path(state.params)),
            "opt": state.opt, "state_bytes": held,
            "state_bytes_expected": state_bytes_per_device(
                shapes, placements(tc, shapes, sizes), sizes, mode)}
    return out


def _exact_grad(p, rank):
    """A gradient whose sum over four ranks is exact in bf16 and f32, in any
    order: multiples of 1/16 of at most 12/16, times rank + 1."""
    k = torch.arange(p.numel(), device=p.device) % 7 - 3
    return (k.float() / 16 * (rank + 1)).view(p.shape)


def sharded_update_rank(grid, tc, train, runs, batch):
    """One rank of a grid: for each (mode, overlap) of ``runs``, from
    init_state(seed 0), one optimizer update (``train_step.update``) of
    exactly summable gradients (``_exact_grad``), then two train steps on
    the rank's row of ``batch``; the params after each."""
    from repro_torch.tree import tree_map
    from repro_torch.train import init_state
    rank = grid.world.rank
    dev = grid.world.device
    rows = {k: v[rank:rank + 1].to(dev) for k, v in batch.items()}
    out = {}
    for mode, overlap in runs:
        state = init_state(tc, train, seed=0, grid=grid, opt_sharding_mode=mode)
        step = make_train_step(tc, ParallelConfig(opt_overlap=overlap), train,
                               opt_sharding_mode=mode, grid=grid)
        state, om = step.update(state, tree_map(lambda p: _exact_grad(p, rank), state.params))
        once = {k: v.clone() for k, v in leaves_with_path(state.params)}
        for _ in range(2):
            state, m = step(state, rows)
        out[(mode, overlap)] = {"update": once, "grad_norm": om["grad_norm"],
                                "steps": dict(leaves_with_path(state.params)),
                                "loss": m["loss"], "impl": step.opt_overlap_impl}
    return out


def run_result_rank(group):
    """A launcher ``RunResult`` (a list with attributes) from each rank."""
    from repro_torch.launch.train import RunResult
    out = RunResult([{"step": group.rank}])
    out.relaunches = 2 + group.rank
    out.replaced = [(0, 4)]
    return out


def grid_checkpoint_rank(grid, tc, spec, root, action):
    """One rank of a grid checkpoint test, on the plan ``spec`` (resolved
    for ``tc``). ``action`` 'save': ``init_state`` (seed 0) on the plan's
    optimizer layout, m and v and the step set to values that are a
    function of the master weights, saved at step 5 through a grid
    ``Checkpointer`` with its params as a model-only checkpoint; returns the
    state. 'restore': ``init_state`` (seed 1), then a restore under the
    default ``on_plan_mismatch`` (its error, if any, is returned) and one
    with 'reshard', and the model-only checkpoint into fresh params (seed
    2); returns the error, the restored state and params."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import TrainConfig
    from repro_torch.parallel import ParallelPlan
    from repro_torch.train import init_state, state_layout
    from repro_torch.tree import tree_map

    plan = ParallelPlan.parse(spec).resolve(tc)
    fsdp = plan.plan.fsdp
    layout = state_layout(tc, grid.axis_sizes, plan.opt_shard, fsdp=fsdp)
    train = TrainConfig(param_dtype="float32")
    if action == "save":
        st = init_state(tc, train, seed=0, grid=grid, opt_sharding_mode=plan.opt_shard,
                        fsdp=fsdp)
        opt = st.opt._replace(step=torch.full_like(st.opt.step, 7),
                              m=tree_map(lambda t: t * 0.5 + 1.0, st.opt.master),
                              v=tree_map(lambda t: t * t + 1e-3, st.opt.master))
        st = TrainState(st.params, opt)
        ck = Checkpointer(root, plan=plan, grid=grid, layout=layout)
        ck.save(st, 5)
        ck.save_model_only(st.params, 5)
        return st
    st = init_state(tc, train, seed=1, grid=grid, opt_sharding_mode=plan.opt_shard, fsdp=fsdp)
    error = None
    try:
        Checkpointer(root, plan=plan, grid=grid, layout=layout).restore(st)
    except ValueError as e:
        error = str(e)
    ck = Checkpointer(root, plan=plan, grid=grid, layout=layout,
                      on_plan_mismatch="reshard")
    restored, step = ck.restore(st)
    params = ck.restore_model_only(
        init_state(tc, train, seed=2, grid=grid, opt_sharding_mode=plan.opt_shard,
                   fsdp=fsdp).params, 5)
    return {"error": error, "step": step, "state": restored, "model_only": params}


def placement_rank(grid, tc, train, runs, batches, rows):
    """One rank of a grid: for each (mode, overlap) of ``runs``, from
    init_state(seed 0), one step per batch on the rank's rows unplaced;
    then the same from a fresh state moved (``apply_placement``) to the
    placement of ``rows``, with the step built for it. Per run: both runs'
    metrics, the keys of the moved params' tiles that differ from the same
    tiles of the whole init params permuted on one process, the bytes the
    move sent, and the keys of the leaves (params, master, m, v) where the
    placed run's state differs from the unplaced run's moved to the same
    placement."""
    from repro_torch.models import init_params
    from repro_torch.parallel.placement import (ExpertPlacement, apply_placement,
                                                permute_expert_tree)
    from repro_torch.parallel.sharding import tile_slices
    from repro_torch.train import init_state, state_layout
    from repro_torch.tree import keyed_leaves

    rank, world = grid.world.rank, grid.world.world
    L, E = tc.num_layers, tc.moe.num_experts
    ident, placed = ExpertPlacement.identity(L, E), ExpertPlacement(L, E, rows)
    whole = dict(keyed_leaves(permute_expert_tree(init_params(tc, seed=0, device="cpu"),
                                                  ident.relative_to(placed), L, E), ".params"))
    out = {}
    for mode, overlap in runs:
        layout = state_layout(tc, grid.axis_sizes, mode)

        def run(placement, state):
            step = make_train_step(tc, ParallelConfig(opt_overlap=overlap), train,
                                   opt_sharding_mode=mode, grid=grid, placement=placement)
            metrics = []
            for b in batches:
                n = b["tokens"].shape[0] // world
                state, m = step(state, {k: v[rank * n:(rank + 1) * n] for k, v in b.items()})
                metrics.append({k: m[k].clone() for k in KEYS if k in m})
            return state, metrics

        unplaced, m_unplaced = run(None, init_state(tc, train, seed=0, grid=grid,
                                                    opt_sharding_mode=mode))
        moved, sent = apply_placement(init_state(tc, train, seed=0, grid=grid,
                                                 opt_sharding_mode=mode),
                                      ident, placed, grid=grid, layout=layout)
        tiles_differ = [key for key, t in keyed_leaves(moved.params, ".params")
                        if not torch.equal(t, whole[key][tile_slices(
                            layout[key][1], layout[key][0], grid.coords, grid.axis_sizes)])]
        placed_state, m_placed = run(placed, moved)
        apply_placement(unplaced, ident, placed, grid=grid, layout=layout)
        state_differ = [k for (k, a), (_, b) in zip(keyed_leaves(placed_state),
                                                    keyed_leaves(unplaced))
                        if not torch.equal(a, b)]
        out[(mode, overlap)] = {"unplaced": m_unplaced, "placed": m_placed,
                                "tiles_differ": tiles_differ, "sent": sent,
                                "state_differ": state_differ}
    return out


def tp_loss_cases_rank(grid, cases):
    """``tp_loss_rank`` for each (tc, params, batch) of ``cases``."""
    return [tp_loss_rank(grid, *c) for c in cases]


def tp_loss_rank(grid, tc, params, batch, compute_dtype=torch.float32):
    """One rank of a dp x ep x tp grid: ``loss_fn`` on its rows with its
    tiles of ``params`` (``convert.params_for_rank``); its share,
    the metrics and the gradient of its share for each of its tiles, by
    path."""
    from repro_torch.convert import params_for_rank
    from repro_torch.tree import leaves, tree_map
    s, dev = grid.sizes, grid.world.device
    mine = tree_map(lambda t: t.to(dev).requires_grad_(),
                    params_for_rank(params, tc, dp=s["data"], ep=s["ep"], tp=s["tp"],
                                    rank=grid.world.rank))
    rows = {k: v.to(dev) for k, v in grid_rows(grid, batch).items()}
    share, m = loss_fn(mine, rows, tc, compute_dtype=compute_dtype, ep_group=grid)
    grads = torch.autograd.grad(share, leaves(mine), allow_unused=True, materialize_grads=True)
    paths = [p for p, _ in leaves_with_path(mine)]
    return {"share": share.detach(), "coords": grid.coords,
            "metrics": {k: v.detach() for k, v in m.items()}, "grads": dict(zip(paths, grads))}



def pp_grid_cases_rank(world, tc_by_name, params_by_name, opt_by_name, train, batches, cases):
    """One rank of the pipeline-parallel grid tests: for each case
    ``(name, (dp, pp, ep, tp), mode, schedule, n_mb)`` a grid re-cut from
    the spawn's processes (``init_grid`` over the world), the rank's tiles
    of the config ``name``'s whole params and AdamW state, one PP step per
    batch on the rank's rows; per case the metrics of each step, the
    rank's params, its state bytes (and what ``state_bytes_per_device``
    gives it), its saved-input peaks and the bytes it handed to its
    neighbour stages. The metrics of a step hold its router terms too
    (``step.router_terms``)."""
    from repro_torch.convert import opt_state_for_rank, params_for_rank
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.parallel import init_grid
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves

    out = []
    for name, (dp, pp, ep, tp), mode, schedule, n_mb in cases:
        tc = tc_by_name[name]
        grid = init_grid(world, dp, ep, tp, pp)
        rank = grid.world.rank
        mine = params_for_rank(params_by_name[name], tc, dp=dp, ep=ep, tp=tp, pp=pp, rank=rank)
        st = opt_state_for_rank(opt_by_name[name], tc, dp=dp, ep=ep, tp=tp, pp=pp, rank=rank,
                                mode=mode)
        state = TrainState(mine, st)
        par = ParallelConfig(microbatches=n_mb, pp_stages=pp, pp_schedule=schedule)
        step = make_train_step(tc, par, train, opt_sharding_mode=mode, grid=grid)
        metrics = []
        for b in batches:
            state, m = step(state, grid_rows(grid, b))
            metrics.append({**{k: m[k] for k in KEYS if k in m}, **step.router_terms})
        sizes = grid.axis_sizes
        shapes = init_params(tc, device="meta")
        out.append({
            "coords": grid.coords, "metrics": metrics,
            "params": dict(leaves_with_path(state.params)),
            "state_bytes": sum(t.numel() * 4 for tree in (st.master, st.m, st.v)
                               for t in leaves(tree)),
            "state_bytes_expected": state_bytes_per_device(
                shapes, placements(tc, shapes, sizes), sizes, mode),
            "saved_peak": dict(step.saved_peak), "sent_bytes": step.sent_bytes})
    return out


def whole_pool_block_rank(world, tc_by_name, p_by_name, x, ct, cases):
    """One rank of the whole-pool block tests: for each case ``(name, dp,
    ep)`` a dp x ep grid re-cut from the spawn's processes, the rank's rows
    of x (B, S, d) (block d * ep + e, ``grid_rows``) and its share of the
    block's params (its expert slice where the block runs
    ``moe_fsmoe_ep``); the block of a pipeline stage (``whole_pool`` over
    the ('data', 'ep') group): its outputs, stats and the gradients of the
    rank's share of sum(out * ct) + AUX * aux + Z * z, the router terms
    taken 1 / (dp * ep) a rank as the PP step takes them."""
    from repro_torch.parallel import init_grid
    from repro_torch.parallel.grid import BATCH_AXES
    out = []
    for name, dp, ep in cases:
        tc = tc_by_name[name]
        grid = init_grid(world, dp, ep)
        rows = grid.group(BATCH_AXES)
        p = p_by_name[name]
        if tmoe.uses_ep(tc.moe, ep):
            p = ep_shard({"moe": p}, grid.ep.rank, ep)["moe"]
        p = {k: v.clone().requires_grad_() for k, v in p.items()}
        r = {"tokens": x, "ct": ct}
        mine = grid_rows(grid, r)
        xl = mine["tokens"].clone().requires_grad_()
        o, aux, z, st = tmoe.sparse_moe_block(p, xl, tc, ep_group=grid.ep, whole_pool=True,
                                              batch_group=rows)
        loss = (o * mine["ct"]).sum() + (AUX * aux + Z * z) / rows.world
        keys = ("router", "gate", "up", "down")
        grads = torch.autograd.grad(loss, [xl] + [p[k] for k in keys])
        out.append({"out": o.detach(), "aux": aux.detach(), "z": z.detach(),
                    "counts": st.counts, "drops": st.drops, "coords": grid.coords,
                    "grads": dict(zip(("x",) + keys, grads))})
    return out


def serve_grid_cases_rank(world, tc, params, prompts, max_new, batch, cases):
    """One rank of the serving-on-a-plan tests: for each (ep, tp) of
    ``cases`` a grid re-cut from the spawn's processes (``init_grid`` over
    the world, dp = 1), the plan resolved for serving, the rank's tiles of
    the whole ``params`` (``convert.params_for_rank``); then an engine
    over ``prompts`` (greedy, ``max_new`` tokens each) and the lowerings
    on ``batch``: the prefill into cache slots (its last logits), one
    decode step after it (its logits) and the forward's last logits."""
    from repro_torch.convert import params_for_rank
    from repro_torch.models import init_cache
    from repro_torch.parallel import init_grid
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.serve import ServeEngine
    from repro_torch.train import make_prefill_step, make_serve_step

    out = []
    for ep, tp in cases:
        grid = init_grid(world, 1, ep, tp)
        plan = ParallelPlan(ep=ep, tp=tp).resolve(tc, serving=True)
        mine = params_for_rank(params, tc, dp=1, ep=ep, tp=tp, rank=grid.world.rank,
                               device=world.device)
        eng = ServeEngine(mine, tc, num_slots=3, max_len=32, plan=plan, grid=grid)
        for p, n in zip(prompts, max_new):
            eng.submit(p, n)
        res = eng.run()
        B, P = batch.shape
        cache = init_cache(tc, B, 32, device=world.device, dtype=torch.float32, tp=tp)
        prefill = make_prefill_step(tc, compute_dtype=torch.float32, into_cache=True, plan=plan,
                                    grid=grid)
        last, cache = prefill(mine, batch, cache, list(range(B)), [P] * B)
        decode = make_serve_step(tc, compute_dtype=torch.float32, plan=plan, grid=grid)
        step, _ = decode(mine, last.argmax(-1)[:, None], cache, P)
        forward = make_prefill_step(tc, compute_dtype=torch.float32, plan=plan, grid=grid)
        out.append({"coords": grid.coords, "tokens": {rid: r.tokens for rid, r in res.items()},
                    "prefill": last, "decode": step[:, 0], "forward": forward(
                        mine, {"tokens": batch})})
    return out


def remat_collectives_rank(grid, tc, train, params, opt, batch, policies):
    """One rank of a dp x ep x tp grid: for each remat policy of
    ``policies``, from the same whole params and AdamW state ('none'),
    one ``make_train_step`` step on the rank's rows under the profiler;
    per policy the metrics, the rank's params after the step, the count
    of each ``gloo:*`` event of the step and the replay depths that the
    process's ``CollectiveTape``s learned so far."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import opt_state_for_rank, params_for_rank
    from repro_torch.parallel.ep import CollectiveTape
    s, rank = grid.sizes, grid.world.rank
    out = {}
    for sac in policies:
        state = TrainState(params_for_rank(params, tc, dp=s["data"], ep=s["ep"], tp=s["tp"],
                                           rank=rank),
                           opt_state_for_rank(opt, tc, dp=s["data"], ep=s["ep"], tp=s["tp"],
                                              rank=rank, mode="none"))
        step = make_train_step(tc, ParallelConfig(remat_policy=sac), train, grid=grid)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, m = step(state, grid_rows(grid, batch))
        events = {}
        for e in prof.events():
            if e.name.startswith("gloo:"):
                events[e.name] = events.get(e.name, 0) + 1
        out[sac] = {"metrics": {k: m[k] for k in KEYS}, "events": events,
                    "params": dict(leaves_with_path(state.params)),
                    "replayed": sorted(set(CollectiveTape._replayed.values()))}
    return out


class _CountCollectives:
    """Within the block, the calls of each ``torch.distributed`` collective
    in ``NAMES``, by name (the port calls them through the module), and
    by name and process group (``on``)."""
    NAMES = ("all_gather", "reduce_scatter", "all_reduce")

    def __enter__(self):
        import torch.distributed as dist
        self.counts, self.saved = {}, {n: getattr(dist, n) for n in self.NAMES}
        self.by_group = {}

        def counting(name, fn):
            def call(*a, **kw):
                self.counts[name] = self.counts.get(name, 0) + 1
                key = (name, id(kw.get("group")))
                self.by_group[key] = self.by_group.get(key, 0) + 1
                return fn(*a, **kw)
            return call
        for n, fn in self.saved.items():
            setattr(dist, n, counting(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for n, fn in self.saved.items():
            setattr(dist, n, fn)

    def on(self, group) -> dict:
        """The calls of each collective over the process group ``group``."""
        return {n: self.by_group.get((n, id(group)), 0) for n in self.NAMES}


def fsdp_cases_rank(grid, tc_by_arch, params_by_arch, opt_by_arch, trains, batches, cases):
    """One rank of a dp = 2 'data' grid: for each (arch, microbatches,
    remat policy, fsdp, train) of ``cases``, from the whole params and
    AdamW state of ``arch`` ('none'), the rank's tiles (``fsdp``: its 'data'
    tiles too), one step per batch on its rows under ``trains[train]``;
    per case the metrics, the params, the
    state, its bytes against ``state_bytes_per_device``, the calls of each
    collective and the gather's ``stats``. Then, per arch and
    remat policy of the fsdp cases, one forward of ``loss_fn`` and its
    backward (``_fsdp_memory``), and per arch one optimizer update of
    gradients of rank + 1 (``_fsdp_update_sums``)."""
    from repro_torch.convert import opt_state_for_rank, params_for_rank
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves

    dp, rank = grid.sizes["data"], grid.world.rank
    sizes = grid.axis_sizes
    out = {}
    for arch, nmb, sac, fsdp, tname in cases:
        tc, train = tc_by_arch[arch], trains[tname]
        state = TrainState(params_for_rank(params_by_arch[arch], tc, dp=dp, ep=1, rank=rank,
                                           fsdp=fsdp),
                           opt_state_for_rank(opt_by_arch[arch], tc, dp=dp, ep=1, rank=rank,
                                              mode="none", fsdp=fsdp))
        step = make_train_step(tc, ParallelConfig(microbatches=nmb, remat_policy=sac,
                                                  fsdp_params=fsdp), train, grid=grid)
        metrics = []
        with _CountCollectives() as calls:
            for b in batches:
                state, m = step(state, grid_rows(grid, b))
                metrics.append({k: m[k] for k in KEYS if k in m})
        shapes = init_params(tc, device="meta")
        out[(arch, nmb, sac, fsdp, tname)] = {
            "metrics": metrics, "params": dict(leaves_with_path(state.params)),
            "opt": state.opt, "calls": calls.counts,
            "stats": dict(step.fsdp_gather.stats) if step.fsdp_gather is not None else None,
            "state_bytes": sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m,
                                                          state.opt.v) for t in leaves(tree)),
            "state_bytes_expected": state_bytes_per_device(
                shapes, placements(tc, shapes, sizes, fsdp=fsdp), sizes, "none"),
            "shares_master": all(p is ma for p, ma in zip(leaves(state.params),
                                                          leaves(state.opt.master)))}
    train = trains["f32"]
    for arch, sac in dict.fromkeys((a, s) for a, _, s, f, _ in cases if f):
        tc = tc_by_arch[arch]
        mine = params_for_rank(params_by_arch[arch], tc, dp=dp, ep=1, rank=rank, fsdp=True)
        out[("memory", arch, sac)] = _fsdp_memory(grid, tc, train, mine, batches[0], sac)
        if ("update", arch) not in out:
            out[("update", arch)] = _fsdp_update_sums(grid, tc, train, mine)
    return out


def _fsdp_memory(grid, tc, train, params, batch, sac):
    """One forward of ``loss_fn`` on the rank's rows with its fsdp tiles
    under ``sac``, then its backward: the shapes autograd packed outside
    the checkpoints (``saved_tensors_hooks``), how many of the storages the
    gathers made (their flat buffers and whole leaves) were still alive
    between forward and backward, and the gathers and reduce-scatters of
    each pass."""
    import gc

    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.models import loss_fn
    from repro_torch.parallel import fsdp as fsdp_mod
    from repro_torch.tree import leaves, tree_map

    step = make_train_step(tc, ParallelConfig(remat_policy=sac, fsdp_params=True), train,
                           grid=grid)
    gather = step.fsdp_gather
    made, packed = [], []
    unpack = fsdp_mod._unpack

    def recording(full, shapes, dims):
        whole = unpack(full, shapes, dims)
        made.extend(StorageWeakRef(t.untyped_storage()) for t in [full] + whole)
        return whole

    def pack(t):
        packed.append(tuple(t.shape))
        return t

    leaf = tree_map(lambda p: p.detach().requires_grad_(), params)
    fsdp_mod._unpack = recording
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(leaf, grid_rows(grid, batch), tc, sac=sac,
                              compute_dtype=torch.float32, ep_group=grid, fsdp=gather)
        forward = dict(gather.stats)
        gc.collect()
        alive, gathered = sum(not ref.expired() for ref in made), len(made)
        torch.autograd.grad(loss, leaves(leaf))
    finally:
        fsdp_mod._unpack = unpack
    return {"packed": packed, "alive": alive, "gathered": gathered, "forward": forward,
            "after_backward": dict(gather.stats)}


def _fsdp_update_sums(grid, tc, train, params):
    """``train_step.update`` on gradients of rank + 1 everywhere: the
    gradients it leaves behind (summed in place over the axes that do not
    split their leaf) and the grad norm."""
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    step = make_train_step(tc, ParallelConfig(fsdp_params=True), train, grid=grid)
    grads = tree_map(lambda p: torch.full_like(p, grid.world.rank + 1.0), params)
    state = TrainState(params, adamw_init(params))
    _, om = step.update(state, grads)
    return {"grads": {k: torch.unique(v) for k, v in leaves_with_path(grads)},
            "grad_norm": om["grad_norm"]}


def fsdp_ep_cases_rank(grid, tc_by_arch, params_by_arch, opt_by_arch, train, batches, cases,
                       ckpt_root):
    """One rank of a dp = 2 x ep = 2 grid: for each (arch, mode, overlap,
    remat policy, fsdp) of ``cases``, from the whole params and AdamW state
    of ``arch``, the rank's tiles and its state in ``mode``
    (``convert.params_for_rank`` / ``opt_state_for_rank``, ``fsdp``: with
    the 'data' tiles), one step per batch on its rows; per case the
    metrics, the params, the state, its bytes against
    ``state_bytes_per_device``, the collectives over the 'data' group, the
    gather's ``stats`` and the update plan's buckets gathered over 'data'
    alone. Then per arch and (mode, overlap) of the fsdp cases one update
    of gradients that tell the ranks apart (``_fsdp_ep_update``); and the
    grid checkpoint of ``dp=2,ep=2,fsdp,opt=epso`` saved under
    ``ckpt_root`` and restored (``grid_checkpoint_rank``)."""
    from repro_torch.convert import opt_state_for_rank, params_for_rank
    from repro_torch.models import init_params
    from repro_torch.optim.epso import DEFAULT_BUCKET_BYTES, state_bytes_per_device
    from repro_torch.train.trainer import opt_layout, placements
    from repro_torch.tree import leaves

    dp, ep, rank = grid.sizes["data"], grid.sizes["ep"], grid.world.rank
    sizes = grid.axis_sizes
    out = {}
    for arch, mode, overlap, sac, fsdp in cases:
        tc = tc_by_arch[arch]
        state = TrainState(params_for_rank(params_by_arch[arch], tc, dp=dp, ep=ep, rank=rank,
                                           fsdp=fsdp),
                           opt_state_for_rank(opt_by_arch[arch], tc, dp=dp, ep=ep, rank=rank,
                                              mode=mode, fsdp=fsdp))
        par = ParallelConfig(remat_policy=sac, opt_overlap=overlap, fsdp_params=fsdp)
        step = make_train_step(tc, par, train, opt_sharding_mode=mode, grid=grid)
        metrics = []
        with _CountCollectives() as calls:
            for b in batches:
                state, m = step(state, grid_rows(grid, b))
                metrics.append({k: m[k] for k in KEYS if k in m})
        shapes = init_params(tc, device="meta")
        data_buckets = 0
        if mode != "none":
            plan, _ = opt_layout(tc, grid, mode, fsdp=fsdp,
                                 max_bucket_bytes=0 if step.opt_overlap_impl == "off"
                                 else DEFAULT_BUCKET_BYTES)
            data_buckets = sum(bk.axes == ("data",) for bk in plan.buckets)
        out[(arch, mode, overlap, sac, fsdp)] = {
            "metrics": metrics, "params": dict(leaves_with_path(state.params)),
            "opt": state.opt, "data_calls": calls.on(grid.data.group),
            "stats": dict(step.fsdp_gather.stats) if step.fsdp_gather is not None else None,
            "impl": step.opt_overlap_impl, "data_buckets": data_buckets,
            "state_bytes": sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m,
                                                          state.opt.v) for t in leaves(tree)),
            "state_bytes_expected": state_bytes_per_device(
                shapes, placements(tc, shapes, sizes, fsdp=fsdp), sizes, mode),
            "param_elems": sum(t.numel() for t in leaves(state.params))}
    for arch, mode, overlap in dict.fromkeys((c[0], c[1], c[2]) for c in cases if c[4]):
        out[("update", arch, mode, overlap)] = _fsdp_ep_update(
            grid, tc_by_arch[arch], train, params_by_arch[arch], mode, overlap)
    tc = tc_by_arch["mula-7b-a1b"]
    spec = f"dp={dp},ep={ep},opt=epso,fsdp"
    out["ckpt"] = {"saved": grid_checkpoint_rank(grid, tc, spec, ckpt_root, "save"),
                   "restored": grid_checkpoint_rank(grid, tc, spec, ckpt_root, "restore")}
    return out


def fsdp_ep_grad(p, coords):
    """A gradient that says which rank it came from: (d + 1) + 10 e on the
    rank at 'data' d and 'ep' e. Sums of it over any ranks are exact."""
    return torch.full_like(p, coords["data"] + 1.0 + 10.0 * coords["ep"])


def _fsdp_ep_update(grid, tc, train, params, mode, overlap):
    """``train_step.update`` of the fsdp step in ``mode``/``overlap`` on
    ``fsdp_ep_grad`` gradients: the grad norm, and under 'none' the
    gradients it leaves behind (summed in place over the axes that do not
    split their leaf), one value a leaf."""
    from repro_torch.convert import opt_state_for_rank, params_for_rank
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    s, rank = grid.sizes, grid.world.rank
    mine = params_for_rank(params, tc, dp=s["data"], ep=s["ep"], rank=rank, fsdp=True)
    opt = opt_state_for_rank(adamw_init(params), tc, dp=s["data"], ep=s["ep"], rank=rank, mode=mode, fsdp=True)
    step = make_train_step(tc, ParallelConfig(opt_overlap=overlap, fsdp_params=True), train,
                           opt_sharding_mode=mode, grid=grid)
    grads = tree_map(lambda p: fsdp_ep_grad(p, grid.coords), mine)
    _, om = step.update(TrainState(mine, opt), grads)
    return {"grads": {k: torch.unique(v) for k, v in leaves_with_path(grads)},
            "grad_norm": om["grad_norm"]}


def fsdp_grid_grad(p, coords):
    """A gradient that says which 'data', 'pp' and 'ep' coordinate it came
    from: (d + 1) + 10 p + 100 e. The same on the tp ranks of one
    coordinate, as every gradient is (they hold the same rows); sums of it
    over any ranks are exact."""
    return torch.full_like(p, coords["data"] + 1.0 + 10.0 * coords["pp"] + 100.0 * coords["ep"])


def fsdp_grid_cases_rank(world, tc_by_name, params_by_name, opt_by_name, train, batches, cases,
                         updates=(), ckpts=()):
    """One rank of the fsdp grid tests: for each case ``(name, (dp, pp, ep,
    tp), mode, overlap, schedule, microbatches, remat policy, fsdp)`` a grid
    re-cut from the spawn's processes (``init_grid`` over the world, once a
    shape), the rank's tiles of config ``name``'s whole params and AdamW
    state (``fsdp``: with the 'data' tiles) in ``mode``, one step per batch
    on the rank's rows (with pp > 1 the pipelined step under ``schedule``);
    per case the metrics (with the router terms of a pp step), the params,
    the state, its bytes against ``state_bytes_per_device``, the param
    elements, the all-gathers and reduce-scatters over the 'data' group,
    the gather's ``stats``, the overlap impl, and with pp > 1 the
    saved-input peak and the bytes handed to the neighbour stages. Then
    for each ``(name, grid, mode, overlap)`` of ``updates`` one
    ``train_step.update`` of ``fsdp_grid_grad`` gradients (its grad norm,
    and under 'none' the summed gradients, one value a leaf); and for each
    ``(name, spec, root)`` of ``ckpts`` the grid checkpoint of ``spec``
    saved under ``root`` and restored (``grid_checkpoint_rank``)."""
    from repro_torch.convert import opt_state_for_rank, params_for_rank
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.parallel import ParallelPlan, init_grid
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves, tree_map

    grids = {}

    def grid_of(shape):
        if shape not in grids:
            dp, pp, ep, tp = shape
            grids[shape] = init_grid(world, dp, ep, tp, pp)
        return grids[shape]

    def cut(name, shape, mode, fsdp, opt=None):
        dp, pp, ep, tp = shape
        rank, tc = world.rank, tc_by_name[name]
        kw = dict(dp=dp, ep=ep, tp=tp, pp=pp, rank=rank, fsdp=fsdp)
        opt = opt_by_name[name] if opt is None else opt
        return TrainState(params_for_rank(params_by_name[name], tc, **kw),
                          opt_state_for_rank(opt, tc, mode=mode, **kw))

    out = {}
    for case in cases:
        name, shape, mode, overlap, schedule, nmb, sac, fsdp = case
        tc, grid = tc_by_name[name], grid_of(shape)
        state = cut(name, shape, mode, fsdp)
        par = ParallelConfig(microbatches=nmb, remat_policy=sac, opt_overlap=overlap,
                             pp_stages=shape[1], pp_schedule=schedule or "1f1b",
                             fsdp_params=fsdp)
        step = make_train_step(tc, par, train, opt_sharding_mode=mode, grid=grid)
        metrics = []
        with _CountCollectives() as calls:
            for b in batches:
                state, m = step(state, grid_rows(grid, b))
                extra = step.router_terms if shape[1] > 1 else {}
                metrics.append({**{k: m[k] for k in KEYS if k in m}, **extra})
        shapes = init_params(tc, device="meta")
        sizes = grid.axis_sizes
        out[case] = {
            "coords": grid.coords, "metrics": metrics,
            "params": dict(leaves_with_path(state.params)), "opt": state.opt,
            "data_calls": calls.on(grid.data.group),
            "stats": dict(step.fsdp_gather.stats) if step.fsdp_gather is not None else None,
            "impl": step.opt_overlap_impl,
            "state_bytes": sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m,
                                                          state.opt.v) for t in leaves(tree)),
            "state_bytes_expected": state_bytes_per_device(
                shapes, placements(tc, shapes, sizes, fsdp=fsdp), sizes, mode),
            "param_elems": sum(t.numel() for t in leaves(state.params)),
            "saved_peak": dict(getattr(step, "saved_peak", {})),
            "sent_bytes": getattr(step, "sent_bytes", 0)}
    for name, shape, mode, overlap in updates:
        tc, grid = tc_by_name[name], grid_of(shape)
        state = cut(name, shape, mode, True, adamw_init(params_by_name[name]))
        par = ParallelConfig(microbatches=shape[1], opt_overlap=overlap, pp_stages=shape[1],
                             fsdp_params=True)
        step = make_train_step(tc, par, train, opt_sharding_mode=mode, grid=grid)
        grads = tree_map(lambda p: fsdp_grid_grad(p, grid.coords), state.params)
        _, om = step.update(state, grads)
        out[("update", name, shape, mode, overlap)] = {
            "grads": {k: torch.unique(v) for k, v in leaves_with_path(grads)},
            "grad_norm": om["grad_norm"]}
    for name, spec, root in ckpts:
        plan = ParallelPlan.parse(spec)
        grid = grid_of((plan.dp, plan.pp, plan.ep, plan.tp))
        out[("ckpt", spec)] = {
            "saved": grid_checkpoint_rank(grid, tc_by_name[name], spec, root, "save"),
            "restored": grid_checkpoint_rank(grid, tc_by_name[name], spec, root, "restore")}
    return out


def _expert_tiles(state, layout, tc):
    """Host copies of the rank's expert-stack tiles of a ``TrainState``
    (params, master, m, v), by checkpoint key."""
    import re

    from repro_torch.parallel.placement import is_expert_stack
    from repro_torch.tree import keyed_leaves
    L, E = tc.num_layers, tc.moe.num_experts
    return {k: t.detach().clone() for k, t in keyed_leaves(state)
            if is_expert_stack("/".join(re.findall(r"\['([^']*)'\]", k)), layout[k][0], L, E)}


def fsdp_placed_cases_rank(world, tc_by_name, train, batches, rows_by_name, cases, ckpt=None):
    """One rank of the fsdp placement tests: for each case ``(name, (dp,
    pp, ep, tp), mode, overlap, remat policy)`` a grid re-cut from the
    spawn's processes, config ``name`` from ``init_state`` (seed 0) and the
    placement of ``rows_by_name[name]``, four runs of one step per batch:
    'unplaced' (fsdp, no placement), 'moved' (fsdp, unplaced for the first
    batch, then ``apply_placement`` and the rest placed), 'placed' (fsdp,
    from the initial state moved to the placement) and 'twin' (the same
    without fsdp). Per case: each run's metrics; the moved run's expert
    tiles before and after its move and the bytes it sent; the keys of the
    placed run's initial params whose tiles differ from the whole init
    params permuted on one process; the keys (and the largest difference)
    where the moved run's final state differs from the unplaced run's
    moved to the placement; the gather's stats and the collectives over
    'data' of the unplaced run. ``ckpt`` ``(case, spec, root)``: the moved
    run's final state of that case saved under the placement by a grid
    ``Checkpointer`` of ``spec`` at step 5 and restored into a fresh state
    (seed 1). On 4 ranks also ``norm_positions``: the grad norm's total
    of an (L, E) slice-sum tensor over the world taken as a 'tp' group,
    with the rank's value at two positions."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import init_params
    from repro_torch.parallel import ParallelPlan, init_grid
    from repro_torch.parallel.placement import (ExpertPlacement, apply_placement,
                                                permute_expert_tree)
    from repro_torch.parallel.sharding import tile_slices
    from repro_torch.train import init_state, state_layout
    from repro_torch.tree import keyed_leaves

    grids, out = {}, {}
    for case in cases:
        name, shape, mode, overlap, sac = case
        dp, pp, ep, tp = shape
        if shape not in grids:
            grids[shape] = init_grid(world, dp, ep, tp, pp)
        grid, tc = grids[shape], tc_by_name[name]
        L, E = tc.num_layers, tc.moe.num_experts
        ident, placed = ExpertPlacement.identity(L, E), ExpertPlacement(L, E, rows_by_name[name])
        layouts = {f: state_layout(tc, grid.axis_sizes, mode, fsdp=f) for f in (True, False)}

        def fresh(fsdp, seed=0):
            return init_state(tc, train, seed=seed, grid=grid, opt_sharding_mode=mode, fsdp=fsdp)

        def step_for(placement, fsdp):
            return make_train_step(tc, ParallelConfig(remat_policy=sac, opt_overlap=overlap,
                                                      fsdp_params=fsdp), train,
                                   opt_sharding_mode=mode, grid=grid, placement=placement)

        def run(state, steps, bs):
            metrics = []
            for b in bs:
                state, m = steps(state, grid_rows(grid, b))
                metrics.append({k: m[k].clone() for k in KEYS if k in m})
            return state, metrics

        res = {}
        step = step_for(None, True)
        with _CountCollectives() as calls:
            unplaced, res["unplaced"] = run(fresh(True), step, batches)
        res["stats"], res["data_calls"] = dict(step.fsdp_gather.stats), calls.on(grid.data.group)
        # the live move: one unplaced step, then the placement
        moved, first = run(fresh(True), step_for(None, True), batches[:1])
        res["before"] = _expert_tiles(moved, layouts[True], tc)
        moved, res["sent"] = apply_placement(moved, ident, placed, grid=grid,
                                             layout=layouts[True])
        res["after"] = _expert_tiles(moved, layouts[True], tc)
        moved, rest = run(moved, step_for(placed, True), batches[1:])
        res["moved"] = first + rest
        whole = dict(keyed_leaves(permute_expert_tree(init_params(tc, seed=0, device="cpu"),
                                                      ident.relative_to(placed), L, E),
                                  ".params"))
        lay = layouts[True]
        start, _ = apply_placement(fresh(True), ident, placed, grid=grid, layout=lay)
        res["tiles_differ"] = [k for k, t in keyed_leaves(start.params, ".params")
                               if not torch.equal(t, whole[k][tile_slices(
                                   lay[k][1], lay[k][0], grid.coords, grid.axis_sizes)])]
        _, res["placed"] = run(start, step_for(placed, True), batches)
        twin, _ = apply_placement(fresh(False), ident, placed, grid=grid, layout=layouts[False])
        _, res["twin"] = run(twin, step_for(placed, False), batches)
        apply_placement(unplaced, ident, placed, grid=grid, layout=lay)
        differ = [(k, float((a.float() - b.float()).abs().max()))
                  for (k, a), (_, b) in zip(keyed_leaves(moved), keyed_leaves(unplaced))
                  if not torch.equal(a, b)]
        res["state_differ"] = differ
        res["coords"] = grid.coords
        if ckpt is not None and ckpt[0] == case:
            _, spec, root = ckpt
            plan = ParallelPlan.parse(spec).resolve(tc)
            ck = Checkpointer(root, plan=plan, grid=grid, layout=lay)
            ck.placement = placed
            ck.save(moved, 5)
            back = Checkpointer(root, plan=plan, grid=grid, layout=lay)
            restored, at = back.restore(fresh(True, seed=1))
            res["ckpt"] = {"saved": dict(keyed_leaves(moved)), "step": at,
                           "restored": dict(keyed_leaves(restored)),
                           "placement": back.restored_placement == placed}
        out[case] = res
    if world.world == 4:
        # the grad norm's slice sums over a 4-rank 'tp' group: values that
        # an all-reduce associates by their offset, at two positions
        from repro_torch.optim.adamw import reduce_slice_sums
        sums = []
        for pos in ((0, 1), (3, 50)):
            s = torch.zeros(4, 64)
            s[pos] = (1.0, 1e8, -1e8, 3.0)[world.rank]
            sums.append(reduce_slice_sums(s, tp=world))
        out["norm_positions"] = sums
    return out


def fsdp_ssm_cases_rank(world, *args, **kw):
    """``fsdp_grid_cases_rank`` with Mamba-1's scan streams kept in float32
    (``models.ssm.STREAM_DTYPE``), as the JAX oracle's are patched to: the
    bf16 rounding of the streams would part the two at single elements."""
    from repro_torch.models import ssm
    ssm.STREAM_DTYPE = torch.float32
    return fsdp_grid_cases_rank(world, *args, **kw)


def vocab_cases_rank(world, table, batch, vocab_size, cases, params):
    """One rank of ``test_torch_vocab``: for each case ``(form, n)`` the
    rank's group of ``n`` ranks (the world cut into consecutive blocks;
    the tiles of ``table`` (V_pad, d) on it, rank k holding rows k * V_pad
    / n on), and the vocab-parallel ops of ``parallel.vocab`` on its rows
    of ``batch`` ("same": every rank the whole batch; "differ": the group
    splits the rows, rank k block k): the lookup and its table gradient
    against the cotangent ``ct``, the NLL with its table and hidden-state
    gradients, the whole logits with the gradients of their sum against
    ``ctl``. Then ``params`` cut by ``ep_shard`` on the world as the 'ep'
    group, rank r added to every leaf, through ``broadcast_params``."""
    import torch.distributed as dist

    from repro_torch.checkpoint import broadcast_params
    from repro_torch.parallel import vocab as V
    from repro_torch.parallel.ep import EPGroup
    from repro_torch.tree import tree_map

    groups = {}
    for n in sorted({n for _, n in cases}):
        if n == world.world:
            groups[n] = world
            continue
        for start in range(0, world.world, n):
            members = list(range(start, start + n))
            pg = dist.new_group(members)
            if world.rank in members:
                groups[n] = EPGroup(pg, members.index(world.rank), n, world.device,
                                    world.backend)
    vp, out = table.shape[0], {}
    for form, n in cases:
        g, same = groups[n], form == "same"
        vs = V.VocabShard(g, vp, same)
        k = vp // n
        tile = table[g.rank * k:(g.rank + 1) * k].clone().requires_grad_()
        b = batch["tokens"].shape[0]
        mine = slice(None) if same else slice(g.rank * b // n, (g.rank + 1) * b // n)
        h = batch["h"][mine].clone().requires_grad_()
        emb = V.embed(tile, batch["tokens"][mine], torch.float32, vs)
        (g_embed,) = torch.autograd.grad((emb * batch["ct"][mine]).sum(), tile)
        nll, count = V.nll(tile, h, batch["labels"][mine], vocab_size, vs)
        g_table, g_h = torch.autograd.grad(nll, (tile, h))
        logits = V.logits(tile, h, vs)
        g_ltable, g_lh = torch.autograd.grad((logits * batch["ctl"][mine]).sum(), (tile, h))
        out[(form, n)] = {"rows": mine, "cols": slice(g.rank * k, (g.rank + 1) * k),
                          "embed": emb.detach(), "g_embed": g_embed, "nll": nll.detach(),
                          "count": count, "g_table": g_table, "g_h": g_h,
                          "logits": logits.detach(), "g_ltable": g_ltable, "g_lh": g_lh}
    mine = tree_map(lambda t: t.clone() + world.rank, ep_shard(params, world.rank, world.world))
    out["broadcast"] = broadcast_params(mine, world,
                                        param_placements(params, {"ep": world.world}))
    return out
