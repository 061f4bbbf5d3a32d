"""Model configuration for the PyTorch port: a copy of the JAX package's
``configs/base.py`` dataclasses (``MoEConfig``, ``SSMConfig``,
``ModelConfig``) and ``reduced``, kept field-for-field identical so that a
config built here and one built there compare equal under
``dataclasses.asdict`` (tests/test_torch_configs.py). ``ParallelConfig``
and ``TrainConfig`` are copied whole; the port's trainer runs on one device
and rejects the mesh-only settings (pipeline stages, optimizer overlap).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0          # top-k
    d_ff_expert: int = 0                # per-expert intermediate size
    num_shared_experts: int = 0         # always-on experts (moonlight-style)
    capacity_factor: float = 1.25       # static-capacity adaptation (DESIGN §3)
    router_aux_coef: float = 0.01       # load-balance aux loss (OLMoE recipe)
    router_z_coef: float = 0.001        # router z-loss
    forced_uniform_routing: bool = False  # FUR (paper §2.3)
    # 'naive' | 'dense_capacity' | 'fsmoe'  (DESIGN §4)
    moe_impl: str = "dense_capacity"
    # 'xla' | 'pallas' — backend for fsmoe stages 2/4/5
    kernel_backend: str = "xla"
    # beyond-paper (EXPERIMENTS §Perf): explicit shard_map ETP path when the
    # model axis plays expert-tensor-parallel (E < axis size)
    etp_shard_map: bool = False
    # Stage 1 variant: 'allgather' (paper) | 'a2a' (beyond-paper, capacity-
    # bounded all-to-all dispatch)
    stage1: str = "allgather"
    # dispatch mode: 'capacity' sizes the slot pool by capacity_factor and
    # drops over-capacity tokens; 'dropless' sizes it for the worst-case
    # routing so every (token, expert) pair is computed (no drops, exact
    # naive-equal math independent of pool geometry / c_align).
    dispatch: str = "capacity"

    def __post_init__(self):
        if self.dispatch not in ("capacity", "dropless"):
            raise ValueError(f"MoEConfig.dispatch must be 'capacity' or "
                             f"'dropless', got {self.dispatch!r}")


@dataclass(frozen=True)
class SSMConfig:
    variant: str = "mamba1"             # 'mamba1' | 'mamba2'
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                     # d_inner = expand * d_model
    headdim: int = 64                   # mamba2 head dim
    chunk: int = 64                     # mamba2 SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                           # dense-MLP intermediate (0 = no MLP)
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # attention
    rope_theta: float = 10000.0
    sliding_window: int = 0             # 0 = full attention
    # hybrid (zamba2-style): a *shared-weight* attention(+MLP) block applied
    # every `shared_attn_every` layers.
    shared_attn_every: int = 0
    # enc-dec
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # modality frontend stub: inputs include precomputed prefix embeddings
    # (ViT patches / audio frames) of shape (B, num_prefix_embeds, d_model).
    num_prefix_embeds: int = 0
    mlp_activation: str = "swiglu"      # swiglu | gelu
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    tie_embeddings: bool = False
    citation: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """sub-quadratic decode: SSM/hybrid state or sliding-window KV."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic total parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        n += self._block_params()
        n += d                                        # final norm
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _mlp_params(self, d_ff: int) -> int:
        d = self.d_model
        if self.mlp_activation == "swiglu":
            return 3 * d * d_ff
        return 2 * d * d_ff

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        di = self.ssm.expand * d
        ds = self.ssm.d_state
        if self.ssm.variant == "mamba1":
            dt_rank = max(1, d // 16)
            n = d * 2 * di                           # in_proj
            n += di * self.ssm.d_conv                # conv1d (depthwise)
            n += di * (dt_rank + 2 * ds)             # x_proj
            n += dt_rank * di + di                   # dt_proj
            n += di * ds + di                        # A_log, D
            n += di * d                              # out_proj
            return n
        else:  # mamba2
            nheads = di // self.ssm.headdim
            conv_dim = di + 2 * ds
            n = d * (2 * di + 2 * ds + nheads)       # in_proj (z,x,B,C,dt)
            n += conv_dim * self.ssm.d_conv          # conv1d
            n += nheads * 3                          # A_log, D, dt_bias
            n += di                                  # pre-out norm
            n += di * d                              # out_proj
            return n

    def _block_params(self) -> int:
        d = self.d_model
        per_norm = d
        total = 0
        if self.arch_type == "ssm":
            total += self.num_layers * (self._ssm_params() + per_norm)
        elif self.arch_type == "hybrid":
            total += self.num_layers * (self._ssm_params() + per_norm)
            # one shared attention+MLP block (weights shared across uses)
            total += self._attn_params() + self._mlp_params(self.d_ff) + 2 * per_norm
        else:
            per_block = self._attn_params() + 2 * per_norm
            if self.is_moe:
                m = self.moe
                per_block += d * m.num_experts       # router
                per_block += m.num_experts * 3 * d * m.d_ff_expert
                per_block += m.num_shared_experts * 3 * d * m.d_ff_expert
            else:
                per_block += self._mlp_params(self.d_ff)
            total += self.num_layers * per_block
            if self.is_encoder_decoder:
                enc_block = self._attn_params() + self._mlp_params(self.d_ff) + 2 * per_norm
                total += self.num_encoder_layers * enc_block
                # decoder cross-attention
                total += self.num_layers * (self._attn_params() + per_norm)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        m = self.moe
        inactive = self.num_layers * 3 * self.d_model * m.d_ff_expert * (
            m.num_experts - m.experts_per_token)
        return self.param_count() - inactive


@dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the ('data','model') / ('pod','data','model') mesh."""
    # role of the 'model' axis for this arch: 'tp' | 'ep' | 'etp' (expert-TP)
    model_axis_role: str = "tp"
    # shard params over the data axis too (ZeRO-3/FSDP style) — for 405B-class
    fsdp_params: bool = False
    # optimizer state sharding: 'none' | 'so' (DP only) | 'epso' (DP x MP)
    optimizer_sharding: str = "epso"
    # overlapped optimizer collectives (optim/overlap.py): None/'auto' turns
    # the bucketed ring update on for epso on a real mesh; 'ring'/'xla' force
    # an impl; 'off' keeps the eager GSPMD-derived tail.
    opt_overlap: Optional[str] = None   # None|'auto'|'off'|'ring'|'xla'
    # selective activation checkpointing modules (paper §1 SAC)
    remat_policy: str = "block"     # none|norm|attn|moe|block(=full block inputs)
    # gradient accumulation microbatches inside train_step
    microbatches: int = 1
    # pipeline parallelism (paper-faithful Mula-100B/220B path): stages map
    # onto the 'pp' mesh axis; microbatches become pipeline microbatches
    pp_stages: int = 1
    pp_schedule: str = "1f1b"       # gpipe | 1f1b
    # executor: 'shardmap' = per-stage programs over the 'pp' axis (only
    # stage 0 embeds, only the last stage runs head+CE); 'masked' = legacy
    # single-program SPMD where every stage pays the masked embed/head cost.
    # 'shardmap' needs a meshed 'pp' axis; off-mesh runs fall back to
    # 'masked' (the single-device PP simulation).
    pp_impl: str = "shardmap"       # shardmap | masked
    # MoE dispatch override: None defers to MoEConfig.dispatch; 'capacity' /
    # 'dropless' force that path in the step builder so every executor the
    # step composes (plain, microbatched, both PP executors) runs one MoE
    # dispatch mode.
    moe_dispatch: Optional[str] = None

    def __post_init__(self):
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pp_schedule must be 'gpipe' or '1f1b', "
                             f"got {self.pp_schedule!r}")
        if self.pp_impl not in ("shardmap", "masked"):
            raise ValueError(f"pp_impl must be 'shardmap' or 'masked', "
                             f"got {self.pp_impl!r}")
        if self.moe_dispatch not in (None, "capacity", "dropless"):
            raise ValueError(f"moe_dispatch must be None, 'capacity' or "
                             f"'dropless', got {self.moe_dispatch!r}")
        if self.opt_overlap not in (None, "auto", "off", "ring", "xla"):
            raise ValueError(f"opt_overlap must be None, 'auto', 'off', "
                             f"'ring' or 'xla', got {self.opt_overlap!r}")
        if self.pp_stages < 1:
            raise ValueError(f"pp_stages must be >= 1, got {self.pp_stages}")
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1, got {self.microbatches}")


@dataclass(frozen=True)
class TrainConfig:
    """Paper §2.1 recipe."""
    seq_len: int = 2048
    global_batch: int = 3072
    lr_peak: float = 4e-4
    lr_min: float = 4e-5
    warmup_steps: int = 2500
    total_steps: int = 630_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    grad_clip: float = 1.0
    clip_after_warmup_only: bool = True   # paper: clip only after warmup
    grad_reduce_dtype: str = "bfloat16"   # paper: bf16 gradient reduction
    param_dtype: str = "float32"          # fp32 master weights
    compute_dtype: str = "bfloat16"       # bf16 fwd/bwd
    seed: int = 0


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            max_experts: int = 4, vocab: int = 512) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests."""
    num_heads = max(2, min(4, cfg.num_heads))
    ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    num_kv = max(1, num_heads // min(ratio, num_heads))
    moe = None
    if cfg.moe is not None:
        ne = min(max_experts, cfg.moe.num_experts)
        moe = dataclasses.replace(
            cfg.moe, num_experts=ne,
            experts_per_token=min(cfg.moe.experts_per_token, max(1, ne // 2)),
            d_ff_expert=min(cfg.moe.d_ff_expert, d_model // 2) if cfg.moe.d_ff_expert else 0,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=min(cfg.ssm.d_state, 16),
                                  headdim=32, chunk=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        num_encoder_layers=min(cfg.num_encoder_layers, layers),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=d_model // num_heads,
        d_ff=min(cfg.d_ff, d_model * 2) if cfg.d_ff else 0,
        vocab_size=vocab,
        moe=moe,
        ssm=ssm,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        num_prefix_embeds=min(cfg.num_prefix_embeds, 8),
    )
