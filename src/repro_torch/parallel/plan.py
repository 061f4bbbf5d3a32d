"""ParallelPlan, the declarative named-axis parallelism spec: port of the JAX
package's ``parallel/plan.py``.

``ParallelPlan.parse("dp=2,ep=2,opt=epso")`` / ``str(plan)`` round-trip
with the JAX package's canonical spec, field for field: axes pod, dp, pp,
ep, tp and the options ``opt=``, ``overlap=``, ``schedule=``, ``impl=``,
``moe=``, ``rebalance=``, ``tiles=``, ``mb=`` and ``fsdp``, with the same
validation and errors. The port has no ``KernelPlan``: the ``tiles=`` token
is kept as a string (``None`` for the default 128x512x512, which ``str``
leaves out as the JAX spec does).

``plan.resolve(cfg, global_batch=)`` checks the plan against the model and
returns a ``ResolvedPlan``: the process grid's sizes (``grid``: dp, ep and,
with tp > 1 or pp > 1, tp and pp; ``parallel.grid.grid_spec``) for
``parallel.spawn(..., grid=)``, the ``ParallelConfig`` it implies
(``parallel_config``: microbatches, the pp stages, ``pp_schedule`` and
``pp_impl`` as the JAX plan resolves them) and the checkpoint metadata
(``layout_signature()``, ``spec()``) exactly as the JAX ``ResolvedPlan``
computes them, and the live expert placement (``placement``,
``with_placement``) a ``rebalance=`` policy moves. What the port cannot
run raises ``NotImplementedError`` naming its ``ROADMAP.md`` item: a pod
axis (§1 item 5), tp for the ssm and hybrid archs (§1 item 5.10), an
explicit ``tiles=`` (§1 item 7), and in serving (``resolve(...,
serving=True)``) a dp or pp axis (§1 item 5.7b). A pp axis needs a uniform
layer stack (``models.model.PP_ARCH_TYPES``; the JAX step's ValueError)
and refuses a ``rebalance=`` policy, as the JAX plan does; its stages run
any ``stage1`` (a stage dispatches the whole microbatch as one device
does, as the JAX stage does). The tp axis splits attention by whole heads,
so it needs tp to divide both head counts (a JAX split inside a head has no
local-head form here); outside pp the all-to-all Stage 1 refuses dropless
dispatch and a tp axis, as the JAX MoE block does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from .grid import grid_spec

# canonical axis order == mesh-major order (pod outermost, tp innermost) and
# the mesh axis name each plan axis maps to.
AXES: Tuple[Tuple[str, str], ...] = (
    ("pod", "pod"), ("dp", "data"), ("pp", "pp"), ("ep", "ep"), ("tp", "tp"))
_AXIS_KEYS = tuple(k for k, _ in AXES)
_OPT_MODES = ("none", "so", "epso")
_OPT_OVERLAPS = ("auto", "off", "ring", "xla")
_PP_SCHEDULES = ("gpipe", "1f1b")
_PP_IMPLS = ("shardmap", "masked")
_MOE_DISPATCH = ("capacity", "dropless")
DEFAULT_TILES = (128, 512, 512)


def _tiles_token(value: str, spec: str = "") -> Optional[str]:
    """A ``tiles=`` token ('auto' or 'TMxTKxTN') in canonical form; None for
    the default triple."""
    v = str(value).strip()
    if v == "auto":
        return v
    try:
        tiles = tuple(int(x) for x in v.split("x"))
        if len(tiles) != 3:
            raise ValueError
    except ValueError:
        where = f" in parallel spec {spec!r}" if spec else ""
        raise ValueError(f"tiles={value!r}{where}: want 'auto' or an "
                         f"explicit 'TMxTKxTN' triple, e.g. "
                         f"tiles=128x512x512") from None
    for name, t in zip(("tile_m", "tile_k", "tile_n"), tiles):
        if t < 1:
            raise ValueError(f"KernelPlan.{name} must be >= 1, got {t}")
    return None if tiles == DEFAULT_TILES else "x".join(map(str, tiles))


def parse_mesh_spec(spec):
    """``'8'`` -> (data,), ``'4,2'`` -> (data, model), ``'2,2,2'`` ->
    (data, pp, model) and ``'2,2,2,2'`` -> (pod, data, pp, model): the
    legacy ``--mesh`` spec (the JAX package's ``launch/mesh.py``).
    Returns (shape, axis_names)."""
    dims = tuple(int(x) for x in str(spec).split(",") if x.strip())
    if not 1 <= len(dims) <= 4 or any(d < 1 for d in dims):
        raise ValueError(f"bad mesh spec {spec!r} (want e.g. '8', '4,2', "
                         f"'2,2,2', '2,2,2,2')")
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("data", "pp", "model"),
            4: ("pod", "data", "pp", "model")}[len(dims)]
    return dims, axes


def refuse(what: str, item: str) -> None:
    """Raise the port's NotImplementedError for ``what``, naming its
    ``ROADMAP.md`` §1 ``item``."""
    raise NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP.md §1 {item})")


# the ROADMAP.md item of serving with data replicas or pipeline stages
SERVE_DP_PP_ITEM = "item 5.7b, dp and pp in serving"
# the ROADMAP.md item of fsdp under a remat policy without 'block' or
# 'block_sc' (``train.make_train_step`` refuses it)
FSDP_ITEM = "item 5.1e, fsdp without block remat"
# the archs whose layers the fsdp step gathers (``parallel.fsdp``): every
# arch the port trains, on any grid it trains on: its tiles over 'data',
# beside the stages over 'pp', the expert slices over 'ep' (in any expert
# placement) and the tp shards over 'tp'
FSDP_ARCH_TYPES = ("dense", "moe", "ssm", "hybrid")


def check_fsdp(arch_type: str) -> None:
    """Refuse fsdp for an arch outside ``FSDP_ARCH_TYPES``, the archs the
    port does not build at all (§1 item 6). Every grid, every optimizer
    mode and every expert placement the arch takes runs with it."""
    if arch_type not in FSDP_ARCH_TYPES:
        refuse(f"fsdp for arch_type {arch_type!r}", "item 6, the rest of the zoo")


@dataclass(frozen=True)
class ParallelPlan:
    """Declarative parallel-execution plan. See the module docstring."""
    dp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    pod: int = 1
    opt_shard: str = "none"              # none | so | epso  (paper §3.2)
    opt_overlap: Optional[str] = None    # None | auto | off | ring | xla
    pp_schedule: str = "1f1b"            # gpipe | 1f1b
    pp_impl: str = "shardmap"            # shardmap | masked
    microbatches: int = 1
    fsdp: bool = False
    moe_dispatch: Optional[str] = None   # None | capacity | dropless
    rebalance: Optional[str] = None      # None | off | '<int>:<float>'
    tiles: Optional[str] = None          # None (128x512x512) | auto | 'TMxTKxTN'

    def __post_init__(self):
        for k in _AXIS_KEYS + ("microbatches",):
            v = getattr(self, k)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"ParallelPlan.{k} must be a positive int, "
                                 f"got {v!r}")
        if self.opt_shard not in _OPT_MODES:
            raise ValueError(f"opt_shard must be one of {_OPT_MODES}, "
                             f"got {self.opt_shard!r}")
        if self.opt_overlap not in (None,) + _OPT_OVERLAPS:
            raise ValueError(f"opt_overlap must be None or one of "
                             f"{_OPT_OVERLAPS}, got {self.opt_overlap!r}")
        if self.pp_schedule not in _PP_SCHEDULES:
            raise ValueError(f"pp_schedule must be one of {_PP_SCHEDULES}, "
                             f"got {self.pp_schedule!r}")
        if self.pp_impl not in _PP_IMPLS:
            raise ValueError(f"pp_impl must be one of {_PP_IMPLS}, "
                             f"got {self.pp_impl!r}")
        if self.moe_dispatch is not None and \
                self.moe_dispatch not in _MOE_DISPATCH:
            raise ValueError(f"moe_dispatch must be None or one of "
                             f"{_MOE_DISPATCH}, got {self.moe_dispatch!r}")
        if self.tiles is not None:
            object.__setattr__(self, "tiles", _tiles_token(self.tiles))
        self.rebalance_params()          # validates the token's shape

    def rebalance_params(self) -> Optional[Tuple[int, float]]:
        """The parsed ``rebalance=`` policy: ``(interval_steps, threshold)``,
        or None when rebalancing is off (token absent or 'off')."""
        r = self.rebalance
        if r is None or r == "off":
            return None
        try:
            n_s, t_s = str(r).split(":", 1)
            n, t = int(n_s), float(t_s)
        except ValueError:
            raise ValueError(
                f"rebalance={r!r}: want 'off' or '<interval>:<threshold>' "
                f"(e.g. rebalance=50:1.25 — every 50 steps, re-place when "
                f"max/mean rank load exceeds 1.25)") from None
        if n < 1 or t < 1.0:
            raise ValueError(f"rebalance={r!r}: interval must be >= 1 and "
                             f"threshold >= 1.0 (a max/mean ratio)")
        return n, t

    # ---- spec string <-> plan ------------------------------------------------
    @classmethod
    def parse(cls, spec: str, **overrides) -> "ParallelPlan":
        """``'dp=2,pp=2,ep=2'`` -> ParallelPlan. Options ride along in the
        same spec: ``opt=epso``, ``schedule=gpipe``, ``mb=4``, ``fsdp``.
        Raises a descriptive ValueError on unknown roles or bad sizes."""
        if not str(spec).strip():
            raise ValueError("empty parallel spec (want e.g. 'dp=2,pp=2,ep=2')")
        kw: dict = {}

        def put(key, val):
            if key in kw:
                raise ValueError(f"duplicate {key!r} in parallel spec "
                                 f"{spec!r} (each axis/option once)")
            kw[key] = val

        for tok in str(spec).split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok == "fsdp":
                put("fsdp", True)
                continue
            if "=" not in tok:
                raise ValueError(
                    f"bad token {tok!r} in parallel spec {spec!r}: want "
                    f"axis=size (axes: {', '.join(_AXIS_KEYS)}) or an option "
                    f"(opt=, schedule=, mb=, fsdp)")
            k, v = (s.strip() for s in tok.split("=", 1))
            if k in _AXIS_KEYS or k in ("mb", "microbatches"):
                try:
                    n = int(v)
                except ValueError:
                    raise ValueError(f"{k}={v!r} in parallel spec {spec!r}: "
                                     f"size must be an integer") from None
                if n < 1:
                    raise ValueError(f"{k}={n} in parallel spec {spec!r}: "
                                     f"axis sizes must be >= 1")
                put("microbatches" if k in ("mb", "microbatches") else k, n)
            elif k in ("opt", "opt_shard"):
                put("opt_shard", v)
            elif k in ("overlap", "opt_overlap"):
                put("opt_overlap", v)
            elif k in ("schedule", "pp_schedule", "sched"):
                put("pp_schedule", v)
            elif k in ("impl", "pp_impl"):
                put("pp_impl", v)
            elif k in ("moe", "moe_dispatch"):
                put("moe_dispatch", v)
            elif k == "rebalance":
                put("rebalance", v)
            elif k == "tiles":
                put("tiles", v)
            elif k == "fsdp":
                put("fsdp", v not in ("0", "false", "False"))
            else:
                raise ValueError(
                    f"unknown role {k!r} in parallel spec {spec!r}; valid "
                    f"axes: {', '.join(_AXIS_KEYS)}; options: opt={{none|so|"
                    f"epso}}, overlap={{auto|off|ring|xla}}, "
                    f"schedule={{gpipe|1f1b}}, "
                    f"impl={{shardmap|masked}}, moe={{capacity|dropless}}, "
                    f"rebalance={{off|N:threshold}}, "
                    f"tiles={{auto|TMxTKxTN}}, mb=<int>, fsdp")
        kw.update(overrides)
        if kw.get("tiles") is not None:
            kw["tiles"] = _tiles_token(kw["tiles"], spec)
        return cls(**kw)

    def __str__(self) -> str:
        """Canonical spec, the JAX package's; ``ParallelPlan.parse(str(p))
        == p``."""
        parts = [f"{k}={getattr(self, k)}" for k in ("dp", "pp", "ep", "tp",
                                                     "pod")
                 if getattr(self, k) != 1]
        if not parts:
            parts = ["dp=1"]
        if self.opt_shard != "none":
            parts.append(f"opt={self.opt_shard}")
        if self.opt_overlap is not None:
            parts.append(f"overlap={self.opt_overlap}")
        if self.pp_schedule != "1f1b":
            parts.append(f"schedule={self.pp_schedule}")
        if self.pp_impl != "shardmap":
            parts.append(f"impl={self.pp_impl}")
        if self.moe_dispatch is not None:
            parts.append(f"moe={self.moe_dispatch}")
        if self.rebalance is not None:
            parts.append(f"rebalance={self.rebalance}")
        if self.tiles is not None:
            parts.append(f"tiles={self.tiles}")
        if self.microbatches != 1:
            parts.append(f"mb={self.microbatches}")
        if self.fsdp:
            parts.append("fsdp")
        return ",".join(parts)

    # ---- legacy translation --------------------------------------------------
    @classmethod
    def from_legacy(cls, mesh_spec: str, *, cfg=None, opt_shard: str = "none",
                    pp_schedule: str = "1f1b", microbatches: int = 1,
                    fsdp: bool = False) -> "ParallelPlan":
        """Translate the positional ``--mesh dp[,pp][,model]`` spec into an
        explicit plan: MoE configs whose expert count divides the model-axis
        size get ``ep=<model>``; everything else gets ``tp=<model>``."""
        dims, axes = parse_mesh_spec(mesh_spec)
        sizes = dict(zip(axes, dims))
        model = sizes.get("model", 1)
        ep, tp = 1, 1
        if model > 1:
            if (cfg is not None and getattr(cfg, "is_moe", False)
                    and cfg.moe.num_experts % model == 0):
                ep = model
            else:
                tp = model
        return cls(dp=sizes.get("data", 1), pp=sizes.get("pp", 1),
                   ep=ep, tp=tp, pod=sizes.get("pod", 1),
                   opt_shard=opt_shard, pp_schedule=pp_schedule,
                   microbatches=microbatches, fsdp=fsdp)

    # ---- derived -------------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return self.pod * self.dp * self.pp * self.ep * self.tp

    def mesh_axes(self) -> Tuple[Tuple[str, int], ...]:
        """(mesh_axis_name, size) pairs, mesh-major order, size-1 axes
        dropped (a plan that is all ones has no mesh)."""
        return tuple((name, getattr(self, key)) for key, name in AXES
                     if getattr(self, key) > 1)

    def apply_to_model(self, cfg):
        """Fold the plan-pinned MoE dispatch (``moe=``) into ``cfg``;
        ``cfg`` unchanged when nothing is pinned or the model has no MoE
        block."""
        if (self.moe_dispatch is None or getattr(cfg, "moe", None) is None
                or cfg.moe.dispatch == self.moe_dispatch):
            return cfg
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=self.moe_dispatch))

    # ---- resolution ----------------------------------------------------------
    def validate_model(self, cfg) -> None:
        """Plan-vs-model divisibility checks, with errors that say what to
        change (the JAX package's)."""
        if self.pp > 1:
            if cfg.num_layers % self.pp != 0:
                raise ValueError(
                    f"plan pp={self.pp} does not divide {cfg.name}'s "
                    f"{cfg.num_layers} layers: each pipeline stage needs "
                    f"L/pp whole layers")
        if self.rebalance_params() is not None:
            if not getattr(cfg, "is_moe", False):
                raise ValueError(
                    f"plan rebalance={self.rebalance!r} but {cfg.name} has "
                    f"no experts: rebalancing permutes MoE expert stacks")
            if self.pp > 1:
                raise NotImplementedError(
                    f"rebalance={self.rebalance!r} with pp={self.pp}: live "
                    f"placement is not threaded through the pipeline "
                    f"executors yet (stage-sharded layer stacks would need "
                    f"per-stage placement rows)")
        if self.ep > 1:
            if not getattr(cfg, "is_moe", False):
                raise ValueError(
                    f"plan ep={self.ep} but {cfg.name} has no experts: "
                    f"expert parallelism needs a MoE config (use tp/dp)")
            if cfg.moe.num_experts % self.ep != 0:
                raise ValueError(
                    f"plan ep={self.ep} does not divide {cfg.name}'s "
                    f"{cfg.moe.num_experts} experts (ep x tp = "
                    f"{self.ep}x{self.tp}): pick ep | num_experts, or move "
                    f"the ways onto tp (expert-TP shards d_ff instead)")
        if self.tp > 1:
            if getattr(cfg, "is_moe", False):
                f = cfg.moe.d_ff_expert
                if f and f % self.tp != 0:
                    raise ValueError(
                        f"plan tp={self.tp} does not divide {cfg.name}'s "
                        f"expert d_ff={f} (ep x tp = {self.ep}x{self.tp}): "
                        f"expert-TP shards each expert's d_ff {self.tp}-way")
            elif cfg.d_ff and cfg.d_ff % self.tp != 0:
                raise ValueError(
                    f"plan tp={self.tp} does not divide {cfg.name}'s "
                    f"d_ff={cfg.d_ff}")

    def resolve(self, cfg, train=None, *, global_batch=None,
                serving: bool = False) -> "ResolvedPlan":
        """Check the plan against ``cfg`` and what the port runs, once, and
        return the ``ResolvedPlan``. The port's grid is ('data', 'pp',
        'ep', 'tp'): rank (d, p, e, t) takes rows ``d * ep + e`` of the
        batch, so the batch must divide over the dp * ep ranks that split
        it. ``serving``: the plan of a ``serve.ServeEngine`` (or of the
        serving lowerings), whose ranks all hold the whole batch: an 'ep' x
        'tp' grid of an attention-KV arch; the training checks of the
        MoE Stage 1 and of the batch do not apply."""
        self.validate_model(cfg)
        if serving:
            self._check_serving(cfg)
        if self.pod > 1:
            refuse("a pod axis in a plan", "item 5, the rest of multi-GPU")
        if self.pp > 1:
            self._check_pp(cfg)
        if self.fsdp:
            check_fsdp(cfg.arch_type)
        if self.tiles is not None:
            refuse(f"kernel tile selection (tiles={self.tiles})", "item 7, autotuning")
        if self.ep > 1 and cfg.moe.moe_impl != "fsmoe":
            refuse(f"expert parallelism with moe_impl={cfg.moe.moe_impl!r} (the port splits "
                    f"the expert stacks over 'ep' on the fsmoe path only)",
                    "item 5, the rest of multi-GPU")
        if self.tp > 1:
            self._check_tp(cfg)
        moe = getattr(cfg, "moe", None)
        if moe is not None and moe.stage1 == "a2a" and self.ep > 1 and self.pp == 1 \
                and not serving:
            if moe.dispatch == "dropless":
                raise ValueError(
                    "dispatch='dropless' does not compose with stage1='a2a': the all-to-all "
                    "send buffers are capacity-bounded by construction. Use the allgather "
                    "Stage 1 (stage1='allgather') for dropless.")
            if self.tp > 1:
                raise NotImplementedError(
                    "stage1='a2a' does not compose with expert-TP yet; use the allgather "
                    "Stage 1 for ep x tp plans")
        if global_batch is None and train is not None:
            global_batch = getattr(train, "global_batch", None)
        rows = self.dp * self.ep
        if global_batch is not None and global_batch % rows and not serving:
            raise ValueError(f"plan '{self}' splits the batch over {rows} ranks (dp x ep), "
                             f"which do not divide the global batch of {global_batch} rows")
        return ResolvedPlan(plan=self)

    def _check_pp(self, cfg) -> None:
        """What the port's pp axis needs of the model (``resolve``): the JAX
        step's refusal of a non-uniform stack."""
        from repro_torch.models.model import PP_ARCH_TYPES
        if cfg.arch_type not in PP_ARCH_TYPES:
            raise ValueError(f"pp_stages={self.pp} needs arch_type in {PP_ARCH_TYPES}, "
                             f"not {cfg.arch_type!r}")

    def _check_serving(self, cfg) -> None:
        """What serving on the plan needs (``resolve(serving=True)``): the
        attention-KV archs, as ``serve.ServeEngine`` drives, on 'ep' and
        'tp' axes alone."""
        from repro_torch.models.model import KV_ARCHS
        if cfg.arch_type not in KV_ARCHS:
            raise NotImplementedError(f"serving drives the attention-KV archs {KV_ARCHS}, "
                                      f"not {cfg.arch_type!r}")
        if self.dp > 1 or self.pp > 1:
            refuse(f"serving on a plan with dp={self.dp}, pp={self.pp} (data replicas or "
                   f"pipeline stages of a served model)", SERVE_DP_PP_ITEM)

    def _check_tp(self, cfg) -> None:
        """What the port's tp axis needs of the model (``resolve``)."""
        if cfg.arch_type in ("ssm", "hybrid"):
            refuse(f"tensor parallelism (tp) for arch_type {cfg.arch_type!r} (the SSM mixers' "
                   f"tp split)", "item 5.10, tp for the state-space archs")
        if cfg.num_heads % self.tp or cfg.num_kv_heads % self.tp:
            raise NotImplementedError(
                f"plan tp={self.tp} does not divide {cfg.name}'s {cfg.num_heads} heads and "
                f"{cfg.num_kv_heads} kv heads: the port splits attention by whole heads (a "
                f"JAX split inside a head has no local-head form)")
        if getattr(cfg, "moe", None) is not None and cfg.moe.moe_impl == "naive":
            refuse("tensor parallelism with moe_impl='naive' (the single-device oracle)",
                   "item 5, the rest of multi-GPU")


@dataclass(frozen=True)
class ResolvedPlan:
    """A ParallelPlan checked against a model: the process grid it runs on
    (``data`` x ``pp`` x ``ep`` x ``tp`` ranks, ``parallel.spawn(...,
    grid=self.grid)``) and
    the metadata its checkpoints carry. ``placement``: the live
    ``parallel.placement.ExpertPlacement`` (None: identity), which the
    launcher keeps here and builds its step, its MANIFEST placement and its
    controller's from; a placement changes no layout, only which expert
    lives at which position."""
    plan: ParallelPlan
    placement: object = None

    def with_placement(self, placement) -> "ResolvedPlan":
        """This plan with another live placement."""
        return dataclasses.replace(self, placement=placement)

    @property
    def world(self) -> int:
        return self.plan.dp * self.plan.pp * self.plan.ep * self.plan.tp

    @property
    def batch_ranks(self) -> int:
        """The ranks that split the batch's rows, dp x ep (the tp ranks of
        one (data, ep) coordinate hold the same rows)."""
        return self.plan.dp * self.plan.ep

    @property
    def grid(self) -> tuple:
        """(dp, ep), (dp, ep, tp) with tp > 1, or (dp, ep, tp, pp) with pp >
        1: the ``grid=`` of ``parallel.spawn``."""
        p = self.plan
        return grid_spec(p.dp, p.ep, p.tp, p.pp)

    def parallel_config(self, *, remat_policy: str = "block"):
        """The ParallelConfig this plan implies for ``make_train_step`` (the
        JAX ``ResolvedPlan.parallel_config``)."""
        from repro_torch.configs.base import ParallelConfig
        p = self.plan
        return ParallelConfig(microbatches=p.microbatches, remat_policy=remat_policy,
                              optimizer_sharding=p.opt_shard, opt_overlap=p.opt_overlap,
                              pp_stages=p.pp, pp_schedule=p.pp_schedule, pp_impl=p.pp_impl,
                              moe_dispatch=p.moe_dispatch, fsdp_params=p.fsdp)

    @property
    def axis_sizes(self) -> dict:
        """The grid's axes of size > 1 in mesh order
        (``ProcessGrid.axis_sizes``)."""
        return {name: n for name, n in self.plan.mesh_axes()}

    @property
    def opt_shard(self) -> str:
        return self.plan.opt_shard

    # ---- checkpoint metadata -------------------------------------------------
    def layout_signature(self) -> dict:
        """The axis layout a checkpoint records: what must agree between the
        saving and restoring plan for shardings to be interchangeable."""
        return {"axes": [[n, s] for n, s in self.plan.mesh_axes()],
                "opt_shard": self.plan.opt_shard,
                "fsdp": bool(self.plan.fsdp)}

    def spec(self) -> str:
        return str(self.plan)
