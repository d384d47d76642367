"""Configuration dataclasses for models, input shapes, meshes and FL runs.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input shapes as :class:`ShapeConfig`. Configs are plain frozen
dataclasses — hashable so they can be closed over by jitted functions.

This file is a copy of the JAX package's ``configs/base.py``; only the import
lines differ, and ``FedConfig`` is byte-for-byte the reference's so that one
config object drives both packages. In particular ``backend="pallas"`` keeps
its name: in this package it selects the flat-state server whose two sweeps
are the hand-written CUDA kernels of ``repro_torch.kernels.fedagg`` (their
plain PyTorch versions on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.utils.registry import Registry

ARCHS: Registry = Registry("architecture config")
SHAPES: Registry = Registry("input shape")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    # "dense"  : all-experts einsum + masked combine (tiny models / CPU smoke)
    # "gshard" : capacity-based one-hot dispatch (GSPMD expert parallelism)
    impl: str = "gshard"
    # mesh axis to pin expert-parallel intermediates to ("" = let GSPMD
    # propagate). Set by the dry-run's --expert-axis lever (§Perf).
    expert_axis: str = ""


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block hyperparameters (arXiv:2405.21060)."""
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    num_heads: int = 0            # computed: expand*d_model // head_dim if 0
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str                   # citation from the assignment table
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # --- attention flavour ---
    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 = full attention
    long_context_window: int = 4096   # SWA variant used only for long_500k
    mrope: bool = False           # Qwen2-VL multimodal RoPE
    attn_logit_softcap: float = 0.0
    qkv_bias: bool = False
    # --- ffn / norm ---
    activation: str = "swiglu"    # swiglu | gelu | geglu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- hybrid (recurrentgemma): repeating block pattern ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    rglru_width: int = 0          # lru dim (= d_model for RG)
    conv1d_width: int = 4
    # --- moe / ssm sub-configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- modality frontend stubs ---
    num_codebooks: int = 1        # musicgen: EnCodec codebooks (summed embeds)
    vision_embed_dim: int = 0     # qwen2-vl: stub patch-embedding input dim
    max_patches: int = 0          # patches per sequence in vlm input spec
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length num_layers."""
        if self.family == "ssm":
            return ("ssd",) * self.num_layers
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and reporting)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.head_dim
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d
        if self.family == "audio":
            n += (self.num_codebooks - 1) * V * d      # extra codebook embeds
            n += (self.num_codebooks - 1) * V * d      # extra output heads
        if self.family == "vlm" and self.vision_embed_dim:
            n += self.vision_embed_dim * d             # projector stub
        for kind in self.layer_kinds:
            n += 2 * d  # two norms per block
            if kind == "attn":
                n += d * (self.num_heads * hd)              # q
                n += 2 * d * (self.num_kv_heads * hd)       # k, v
                n += (self.num_heads * hd) * d              # o
                n += self._ffn_params()
            elif kind == "rglru":
                w = self.rglru_width or d
                # in_x/in_gate/out linears + conv1d(+bias) + gates a,x + Lambda
                n += 3 * d * w + (self.conv1d_width + 1) * w
                n += 2 * (w * w + w) + w
                n += self._ffn_params()
            elif kind == "ssd":
                s = self.ssm
                dinner = s.expand * d
                nheads = s.num_heads or dinner // s.head_dim
                zxbcdt = d * (2 * dinner + 2 * s.ngroups * s.state_dim + nheads)
                n += zxbcdt
                n += s.conv_width * (dinner + 2 * s.ngroups * s.state_dim)
                n += 2 * nheads                      # A, D
                n += nheads                          # dt_bias
                n += dinner * d                      # out proj
            else:
                raise ValueError(kind)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        full_ffn = 3 * d * m.expert_d_ff * m.num_experts
        act_ffn = 3 * d * m.expert_d_ff * m.num_experts_per_tok
        per_layer_delta = full_ffn - act_ffn
        return self.param_count() - per_layer_delta * self._num_moe_layers()

    def _num_moe_layers(self) -> int:
        return sum(1 for k in self.layer_kinds if k == "attn") if self.moe else 0

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            n = d * m.num_experts                                   # router
            n += 3 * d * m.expert_d_ff * m.num_experts              # experts
            if m.num_shared_experts:
                n += 3 * d * (m.shared_d_ff or m.expert_d_ff * m.num_shared_experts)
                n += d                                              # shared gate
            return n
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


#: Valid values of ``FedConfig.client_engine`` (DESIGN.md §7-8). Lives here
#: rather than in ``repro.core.cohort`` so the config layer can fail fast
#: without importing the engine implementations (``cohort.ENGINES`` aliases
#: this tuple).
CLIENT_ENGINES: Tuple[str, ...] = ("loop", "cohort", "cohort_sharded")

#: Valid values of ``FedConfig.client_behavior`` (DESIGN.md §9) — mirrors
#: ``repro.core.behavior.BEHAVIORS`` for the same fail-fast reason.
CLIENT_BEHAVIORS: Tuple[str, ...] = ("paper", "trace", "poisson-burst",
                                     "diurnal", "flash-crowd",
                                     "straggler-tail")

#: Valid values of ``FedConfig.attack`` (DESIGN.md §11) — mirrors
#: ``repro.core.adversary.ATTACK_FNS`` plus the benign default.
ATTACKS: Tuple[str, ...] = ("none", "sign-flip", "gaussian-noise", "scale",
                            "zero")

#: Valid values of ``FedConfig.screen`` (DESIGN.md §11, §14) — what the
#: server does with an arriving delta. "clip"/"reject" act on the norm
#: (k×EWMA threshold); "cosine" rejects on direction (per-client cosine
#: EWMA against a server reference direction), which catches
#: strength-1 sign-flips that preserve the norm exactly.
SCREEN_POLICIES: Tuple[str, ...] = ("off", "clip", "reject", "cosine")

#: Valid values of ``FedConfig.population`` (DESIGN.md §12). "off" keeps
#: the roster semantics (every client materialized and seeded at t=0);
#: "table" runs the population engine — clients check in from a sampled
#: arrival process and state is allocated lazily in the compact active-set
#: table; "materialized" runs the identical arrival process with every
#: client eagerly materialized (the small-N equivalence reference).
POPULATION_MODES: Tuple[str, ...] = ("off", "table", "materialized")

#: Valid values of ``FedConfig.delta_compression`` (DESIGN.md §13) —
#: mirrors ``repro.core.compression.MODES`` for the same fail-fast reason.
#: "off" ships full f32 deltas; "int8" ships per-block-scaled int8 with
#: client-side error-feedback residuals; "bf16" ships a bf16 recast.
DELTA_COMPRESSION_MODES: Tuple[str, ...] = ("off", "int8", "bf16")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """AsyncFedED + baseline hyperparameters (paper §4, Appendix B.4)."""
    aggregator: str = "asyncfeded"
    num_clients: int = 10
    # Eq.(7): eta_g = lam / (gamma + eps)
    lam: float = 1.0
    eps: float = 1.0
    # Eq.(8): K_{n+1} = K_n + floor((gamma_bar - gamma) * kappa)
    gamma_bar: float = 3.0
    kappa: float = 1.0
    k_initial: int = 10
    k_min: int = 1
    k_max: int = 64
    # Assumption 4 / GMIS depth: updates staler than this are clipped
    gmis_depth: int = 64
    staleness_cap: float = 0.0       # 0 = uncapped (Gamma in Assumption 4)
    # baselines
    fedasync_alpha: float = 0.5
    hinge_a: float = 5.0
    hinge_b: float = 5.0
    # FedAsync "poly" staleness decay: s(lag) = (lag + 1) ** -poly_a
    poly_a: float = 0.5
    fedprox_mu: float = 0.1
    fedbuff_size: int = 4
    # local training
    local_lr: float = 0.01
    local_momentum: float = 0.5
    local_lr_decay: float = 0.995
    local_batch_size: int = 32
    # simulator (Appendix B.2)
    suspension_prob: float = 0.1
    transmission_mbps: float = 100.0
    seed: int = 0
    # server runtime (beyond paper, DESIGN.md §4)
    # "pytree": reference jnp passes | "pallas": flat-state fedagg kernels
    backend: str = "pytree"
    # client execution engine for fan-out sites — sync rounds, async
    # initial seeding, burst re-dispatch (DESIGN.md §7-8):
    # "loop":           one jit dispatch per client (exact reference)
    # "cohort":         one vmap-over-clients/scan-over-K dispatch with
    #                   ragged-K step masking (repro.core.cohort);
    #                   equivalent to the loop to float tolerance
    # "cohort_sharded": the cohort cores shard_mapped over the `pod` mesh
    #                   axis — each pod trains its own client shard, only
    #                   deltas cross pods at aggregation; same event trace
    #                   and data streams as the other two engines
    client_engine: str = "loop"
    # client-behavior model driving arrival dynamics (DESIGN.md §9):
    # "paper" (exact §B.2 lognormal/TCP/suspension semantics, default),
    # "trace" (replayable round-duration traces), "poisson-burst"
    # (clustered arrivals), "diurnal" (time-varying rates).
    client_behavior: str = "paper"
    # shared behavior knobs: per-round probability of a temporary offline
    # gap (churn) / of permanent departure (dropout). 0 = paper semantics
    # with zero extra RNG draws.
    churn_prob: float = 0.0
    dropout_prob: float = 0.0
    # model-specific behavior knobs as a hashable (name, value) tuple —
    # e.g. (("burst_gap", 0.5), ("jitter", 0.01)) — merged into the
    # behavior model's constructor kwargs by the simulator.
    behavior_params: Tuple[Tuple[str, float], ...] = ()
    # >0: arrivals landing within this window of the first one are drained
    # through the server's batched path in one multi-delta kernel sweep;
    # 0 preserves the paper's one-aggregation-per-arrival semantics;
    # "auto" picks the window online from observed inter-arrival density
    # (repro.core.events.AutoWindow, DESIGN.md §9).
    batch_window: Union[float, str] = 0.0
    # >0 with batch_window="auto": the gamma-aware control term — the
    # controller EWMAs observed staleness gamma and shrinks any opened
    # window by threshold/ewma once the EWMA drifts above this threshold
    # (events.AutoWindow gamma_threshold). 0 disables the term.
    window_gamma_threshold: float = 0.0
    # adversarial scenario layer (DESIGN.md §11). ``attack`` corrupts the
    # deltas of round(attack_frac * num_clients) clients at emission time
    # (repro.core.adversary); "none" builds no adversary and leaves every
    # RNG stream untouched. attack_params is a hashable (name, value)
    # tuple of attack-specific knobs (e.g. (("strength", 10.0),)).
    attack: str = "none"
    attack_frac: float = 0.0
    attack_params: Tuple[Tuple[str, float], ...] = ()
    # server-side norm screening (repro.core.screening): "off" (default,
    # byte-identical traces), "clip" (scale oversized deltas down to
    # k×EWMA), "reject" (drop them; the iteration counter does not move).
    screen: str = "off"
    screen_k: float = 3.0           # threshold multiple of the norm EWMA
    screen_alpha: float = 0.2       # EWMA step on accepted norms
    screen_warmup: int = 8          # arrivals before the median-seeded EWMA
    # population engine (DESIGN.md §12): "off" = roster semantics (all
    # num_clients materialized and fanned out at t=0); "table" = the
    # population is a distribution — clients check in at arrival_rate
    # (modulated by the behavior model), per-client state lives in the
    # compact active-set table and is allocated on first contact, so
    # num_clients can be 10**6 while per-drain cost tracks the arrival
    # rate; "materialized" = same arrival process with every client
    # eagerly materialized (the N<=256 equivalence reference).
    population: str = "off"
    # mean client check-ins per unit virtual time across the whole
    # population (population != "off" only). The behavior model modulates
    # it (diurnal phase, burst epochs) and samples the arriving indices.
    arrival_rate: float = 0.0
    # probability a drained client immediately starts another local round
    # (a multi-round session) instead of returning to the population pool.
    session_stay_prob: float = 0.0
    # compressed delta transport (DESIGN.md §13). "off" ships full f32
    # deltas; "int8" quantizes each client delta to per-block-scaled int8
    # (one f32 scale per 1024 elements) with an error-feedback residual
    # held client-side, and the pallas backend dequantizes inside the
    # fedagg grid sweeps; "bf16" recasts the delta to bf16 (exact f32
    # accumulation through the existing kernels). Async servers only —
    # sync rounds aggregate in-process and never serialize deltas.
    delta_compression: str = "off"
    # device-memory budget for one cohort fan-out dispatch, in MiB
    # (DESIGN.md §10). 0 = unlimited. When the shapes-based footprint
    # estimate exceeds it, the planner (repro.core.budget) clamps the
    # vmap width, microbatches the K-scan, and finally falls back
    # cohort -> loop; the chosen plan lands in SimResult.summary().
    memory_budget_mb: float = 0.0
    # model-axis shard count for the flat server state (DESIGN.md §14).
    # 1 = replicated (default). >1 shards the padded flat global vector,
    # every GMIS snapshot, and the fedagg grid sweeps over the `model`
    # axis of the (pod, model) mesh, with one cross-shard psum of the
    # squared-norm partials per Eq. 6 distance. Pallas backend only (the
    # pytree reference path has no flat state to shard); must be a power
    # of two so the padded vector splits into whole kernel blocks, and
    # needs >= model_shards devices at runtime.
    model_shards: int = 1

    def __post_init__(self):
        # Fail fast at config-construction time: an unknown engine name
        # otherwise only surfaces deep inside the simulator's fan-out
        # dispatch, after datasets and model state are already built.
        if self.client_engine not in CLIENT_ENGINES:
            raise ValueError(
                f"unknown client_engine {self.client_engine!r}: expected "
                f"one of {CLIENT_ENGINES} (see DESIGN.md §7-8)")
        if self.client_behavior not in CLIENT_BEHAVIORS:
            raise ValueError(
                f"unknown client_behavior {self.client_behavior!r}: "
                f"expected one of {CLIENT_BEHAVIORS} (see DESIGN.md §9)")
        if isinstance(self.batch_window, str):
            if self.batch_window != "auto":
                raise ValueError(
                    f"batch_window must be a number >= 0 or 'auto', got "
                    f"{self.batch_window!r}")
        elif self.batch_window < 0:
            raise ValueError(
                f"batch_window must be >= 0, got {self.batch_window!r}")
        if self.memory_budget_mb < 0:
            raise ValueError(
                f"memory_budget_mb must be >= 0 (0 = unlimited), got "
                f"{self.memory_budget_mb!r}")
        if self.attack not in ATTACKS:
            raise ValueError(
                f"unknown attack {self.attack!r}: expected one of "
                f"{ATTACKS} (see DESIGN.md §11)")
        if not 0.0 <= self.attack_frac <= 1.0:
            raise ValueError(
                f"attack_frac must be in [0, 1], got {self.attack_frac!r}")
        if self.screen not in SCREEN_POLICIES:
            raise ValueError(
                f"unknown screen policy {self.screen!r}: expected one of "
                f"{SCREEN_POLICIES} (see DESIGN.md §11)")
        if self.screen_k <= 0:
            raise ValueError(
                f"screen_k must be > 0, got {self.screen_k!r}")
        if not 0.0 < self.screen_alpha <= 1.0:
            raise ValueError(
                f"screen_alpha must be in (0, 1], got "
                f"{self.screen_alpha!r}")
        if self.screen_warmup < 1:
            raise ValueError(
                f"screen_warmup must be >= 1, got {self.screen_warmup!r}")
        if self.delta_compression not in DELTA_COMPRESSION_MODES:
            raise ValueError(
                f"unknown delta_compression {self.delta_compression!r}: "
                f"expected one of {DELTA_COMPRESSION_MODES} "
                f"(see DESIGN.md §13)")
        if self.model_shards < 1 or (self.model_shards
                                     & (self.model_shards - 1)):
            raise ValueError(
                f"model_shards must be a power of two >= 1, got "
                f"{self.model_shards!r} (see DESIGN.md §14)")
        if self.model_shards > 1 and self.backend != "pallas":
            raise ValueError(
                f"model_shards={self.model_shards} requires "
                f"backend='pallas' — the pytree reference path has no "
                f"flat state to shard (see DESIGN.md §14)")
        if self.population not in POPULATION_MODES:
            raise ValueError(
                f"unknown population mode {self.population!r}: expected "
                f"one of {POPULATION_MODES} (see DESIGN.md §12)")
        if self.population != "off" and self.arrival_rate <= 0:
            raise ValueError(
                f"population={self.population!r} needs arrival_rate > 0 "
                f"(check-ins per unit virtual time), got "
                f"{self.arrival_rate!r}")
        if not 0.0 <= self.session_stay_prob < 1.0:
            raise ValueError(
                f"session_stay_prob must be in [0, 1), got "
                f"{self.session_stay_prob!r}")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def reduced(cfg: ModelConfig, num_layers: int = 2, d_model: int = 256,
            max_experts: int = 4) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers, d_model<=512, <=4 experts."""
    d_model = min(d_model, 512)
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    head_dim = max(8, d_model // heads)
    changes = dict(
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=d_model * 2,
        vocab_size=min(cfg.vocab_size, 512),
        rglru_width=min(cfg.rglru_width, d_model) if cfg.rglru_width else 0,
        vision_embed_dim=64 if cfg.vision_embed_dim else 0,
        max_patches=16 if cfg.max_patches else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        long_context_window=64,
    )
    if cfg.moe is not None:
        e = min(cfg.moe.num_experts, max_experts)
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=e,
            num_experts_per_tok=min(cfg.moe.num_experts_per_tok, 2),
            expert_d_ff=d_model,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            shared_d_ff=d_model if cfg.moe.num_shared_experts else 0,
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, num_heads=0, chunk_size=32)
    if cfg.block_pattern:
        changes["num_layers"] = max(num_layers, len(cfg.block_pattern))
    return dataclasses.replace(cfg, **changes)
