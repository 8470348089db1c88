"""Config dataclasses of the PyTorch port.

A copy of the fields of ``repro.configs.base`` that the model families,
the serving paths and the serving cluster read; the port keeps its own configs
so that it never imports the JAX package. The names, defaults and meanings
are the reference's, so a test can compare the two field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    local_window: int = 0  # 0 = global attention
    alternate_local_global: bool = False  # gemma2: layer pairs (local, global)
    logit_softcap: float = 0.0
    qk_norm: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    moe_every: int = 1  # every Nth layer is MoE (the port runs 1 only)
    capacity_factor: float = 1.25  # gshard: per-expert slots over the mean load
    router_aux_weight: float = 0.01  # weight of the load-balance loss in training
    # grouped = sort-based unified kernel (the paper's orchestration; the
    #           engines' ``serving_config`` switches every config to it);
    # gshard  = capacity dispatch/combine einsums, which drop the slots past
    #           an expert's capacity (the reference's training default)
    impl: str = "grouped"
    # single          = the whole expert stack on one device;
    # expert_parallel = the grouped path over the slots of an EP mesh
    #                   (``distributed/expert_parallel.py``; the mesh is set
    #                   with ``use_ep_mesh``), serving only
    moe_exec: str = "single"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int
    version: int = 1  # 1 = Mamba-1 (falcon-mamba), 2 = Mamba-2 (zamba2)
    expand: int = 2
    conv_width: int = 4
    head_dim: int = 64  # mamba2 only
    dt_rank: int = 0  # mamba1; 0 = ceil(d_model / 16)
    scan_chunk: int = 128  # Mamba-2's SSD chunk length (Mamba-1 scans in the kernel)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class QuantConfig:
    """The paper's dual-stage quantization scheme (CoQMoE section 3)."""

    enable: bool = False
    w_bits: int = 8
    a_bits: int = 8
    attn_bits: int = 4  # post-softmax log-sqrt2 quantizer bits
    kv_cache_int8: bool = True  # serving: int8 K/V cache
    # per-site mixed-scheme map of ``ptq_model(materialize="int4")``:
    # (dotted-path-suffix pattern, scheme) pairs, longest suffix wins,
    # unmatched sites stay int8; empty = ``ptq.DEFAULT_INT4_SCHEME``
    scheme_map: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class ContinuousBatchingConfig:
    """Continuous-batching knobs of ``serving.engine.ServeEngine``: packed
    prefill of up to ``batch_slots`` prompts in one ``[1, bucket]`` buffer
    (segment-masked attention), power-of-two bucket ladder from
    ``min_bucket`` to ``max_prefill``, and token retirement on a thread."""

    packed_prefill: bool = True
    # token budget of one packed prefill; 0 = the engine max_len
    max_prefill: int = 0
    min_bucket: int = 32
    async_retire: bool = True
    # build every serving program at warmup(): on the card each is a
    # captured CUDA graph (False: every step runs eagerly, programs are
    # built on first use)
    aot_warmup: bool = True


@dataclass(frozen=True)
class AutotuneConfig:
    """Per-device kernel autotuning (``kernels/autotune.py``), the port's
    counterpart of the reference's Pallas tile search and of the paper's
    per-deployment re-synthesis of the accelerator (CoQMoE section 4).

    The port tunes no tiles: its kernels have no TPU sublane x lane grid.
    It tunes the choices its kernels make by rule: the grouped kernel's
    variant (``mma``, ``stream``, ``dp4a`` / ``fma``) and ``lm_attention``'s
    schedule (``decode``, ``tile``). When enabled, engine ``warmup()`` runs
    every program the replica will capture once eagerly, collects the
    kernel shape-bucket keys they hit, times each legal candidate of each
    missing key on the card and keeps the fastest in a versioned JSON table
    per device kind; a later warmup on the same kind sweeps nothing. On
    the CPU nothing is timed: keys get the rule's pick."""

    enable: bool = False
    # candidates timed per (kernel, shape-bucket) key at most; the rule's
    # pick is always the first
    budget: int = 12
    # timed repetitions per candidate (the median is kept)
    reps: int = 5
    # directory holding one table file per device kind; None falls back to
    # $REPRO_AUTOTUNE_CACHE, then ".repro_autotune"
    cache_dir: Optional[str] = None
    # pinned entries applied over the loaded table, as (entry key, choice)
    # pairs: the key string ``kernels/autotune.py`` builds and a variant or
    # schedule name ("mma", "stream", "dp4a", "fma", "decode", "tile")
    overrides: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class AutoscaleConfig:
    """Target-range admission autoscaling of ``ServingCluster``
    (``serving/autoscaler.py``).

    The controller reacts to two pressure signals: front-end queue depth
    per active replica and the *windowed* pooled p95 request latency vs the
    SLO. Hysteresis comes from patience (consecutive breached evaluations
    before acting) plus a post-action cooldown, so a bursty arrival process
    does not flap the replica set."""

    min_replicas: int = 1
    max_replicas: int = 8
    # pre-warmed standby pool size ServingCluster should hold (replicas
    # beyond it are spawned + warmed on demand, which is much slower)
    standby: int = 1
    # scale-up triggers: front-end depth per active replica, or pooled
    # windowed p95 over the SLO
    depth_high: float = 4.0
    slo_p95_ms: float = 250.0
    up_patience: int = 2
    # scale-down triggers: total load at/below depth_low AND p95 under
    # down_margin * SLO, sustained for down_patience evaluations
    depth_low: float = 0.0
    down_margin: float = 0.5
    down_patience: int = 16
    # evaluations to wait after any scale action before the next one
    cooldown: int = 8
    # samples needed before the windowed p95 advances (below it the window
    # keeps accumulating and the previous estimate holds)
    min_window_samples: int = 8
    # evaluations without a window close before the p95 estimate expires to
    # NaN: a breach measured during a surge must not keep scaling (or pin
    # the replica count) once traffic has stopped
    p95_ttl: int = 32


@dataclass(frozen=True)
class TraceConfig:
    """Serving tracing knobs (``serving/trace.py``).

    With ``enable`` off (the default) engines hold the no-op ``NULL_TRACER``
    and every instrumentation site reduces to one attribute read. With it
    on, every request gets a typed span timeline (queue/pack/prefill/decode/
    retire; vision: queue/infer/retire) in a bounded flight recorder, and the
    engines record per-program step times keyed by the program key into
    ``EngineMetrics`` histograms."""

    enable: bool = False
    # flight-recorder ring capacity in spans; the oldest spans evict first
    # (recorder.dropped counts them)
    capacity: int = 65536
    # per-program step-time histograms (decode tick, packed-prefill
    # dispatch, classify bucket), keyed serve/<prog>|B=..|S=..|...
    step_times: bool = True
    # wrap the kernel wrappers of kernels/ops.py in
    # torch.profiler.record_function ranges named by their shapes, so
    # device profiles carry kernel-level names (eager steps only: a range is
    # host-side and absent when a captured graph replays)
    annotate_kernels: bool = False


@dataclass(frozen=True)
class IntrospectConfig:
    """Live performance-introspection knobs (``serving/introspect.py``).

    With ``enable`` on (the default), ``warmup()`` attaches a per-program
    cost row (the analytic model: a CUDA graph has no cost analysis) for
    every serving program, the device's roofline peaks and a
    memory-watermark probe, the engines time every step (device time on a
    card) for the MFU join, and MoE configs run the windowed expert-routing
    health monitor that emits ``expert_drift`` events into the engine's
    ``EventLog``."""

    enable: bool = True
    # routed tokens per drift-monitor window; a window closes (and drift is
    # evaluated) once this many (token, expert) routings accumulate
    drift_window_tokens: int = 4096
    # total-variation distance (L1/2) between a closed window's occupancy
    # and the reference occupancy above which an expert_drift event fires
    drift_threshold: float = 0.25
    # EMA weight folding each non-drifting window into the reference
    # occupancy (slow tracking, so gradual shift is not repeatedly flagged)
    baseline_alpha: float = 0.1


@dataclass(frozen=True)
class FaultConfig:
    """Serving fault model: chaos injection + watchdog/recovery knobs
    (``serving/faults.py``).

    **Injection** (``inject``, default off): the deterministic chaos
    harness. With it on, every replica the cluster builds is wrapped in a
    ``FaultyReplica`` whose seeded ``FaultInjector`` raises step exceptions
    and OOM-shaped allocation failures, stalls steps (fake-clock
    compatible), rejects submits and poisons ``on_done`` callbacks at the
    configured rates and schedule. With it off nothing is wrapped.

    **Watchdog / recovery** (``watchdog``, default on): the per-replica
    health monitor and the quarantine/re-dispatch machinery of
    ``ServingCluster``. The budgets decide when a replica is evicted and how
    often one request may be re-dispatched before it fails terminally.
    """

    # -- chaos injection (every rate is a per-boundary Bernoulli draw from a
    #    generator seeded by (seed, replica ordinal); 0.0 everywhere = no
    #    faults even when inject=True) -----------------------------------
    inject: bool = False
    seed: int = 0
    step_error_rate: float = 0.0  # step() raises InjectedFault
    oom_rate: float = 0.0  # step() raises InjectedOOM (RESOURCE_EXHAUSTED)
    step_stall_rate: float = 0.0  # step() stalls stall_s before running
    stall_s: float = 0.25  # injected stall duration (clock seconds)
    submit_reject_rate: float = 0.0  # replica submit() raises Backpressure
    callback_poison_rate: float = 0.0  # wrap on_done to raise after running
    # deterministic schedule: (replica_ordinal, local_step, kind) triples,
    # kind in {"error", "oom", "stall", "dead"}. "dead" kills the replica
    # for good: every later step raises too (a crashed process, not a
    # transient fault). Scheduled entries override the random draws.
    kill_schedule: Tuple[Tuple[int, int, str], ...] = ()

    # -- watchdog / recovery ----------------------------------------------
    watchdog: bool = True
    # absolute step wall-time ceiling; one step slower than this counts as
    # a stall regardless of history
    step_timeout_s: float = 30.0
    # relative stall detector: a step slower than stall_threshold x the EMA
    # of healthy steps (StragglerMonitor), armed after warmup_steps. Steps
    # under stall_floor_s never count as relative stalls: a serving pump
    # spins through idle no-op ticks whose microsecond durations would
    # otherwise make any real dispatch look like an 8x stall
    stall_threshold: float = 8.0
    warmup_steps: int = 5
    stall_floor_s: float = 0.05
    # consecutive-fault budgets before quarantine (an OOM-classified error
    # evicts at once: retrying into a full allocator wedges the pump)
    error_budget: int = 3
    stall_budget: int = 2
    # re-dispatches one request may consume across evictions before it
    # fails terminally (its on_done fires once, with status "failed")
    retry_budget: int = 2


@dataclass(frozen=True)
class ModelConfig:
    name: str
    # dense | moe | ssm | hybrid | encdec | vlm | vit | vit_moe (M3ViT:
    # every other block is MoE)
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int = 0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu | relu2
    glu: bool = True
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every N ssm layers
    shared_attn_every: int = 0
    # encoder-decoder (seamless)
    encoder_layers: int = 0
    decoder_layers: int = 0
    # modality frontend stub: 'patch' (vlm) | 'frame' (audio) | None
    frontend: Optional[str] = None
    frontend_tokens: int = 0  # tokens contributed by the frontend embeds
    frontend_dim: int = 0  # raw embedding dim provided by the stub
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeds by sqrt(d_model)
    post_block_norm: bool = False  # gemma2 sandwich norms
    final_logit_softcap: float = 0.0
    num_classes: int = 0
    image_tokens: int = 0  # 197 for a 224/16 ViT (196 patches + cls)
    quant: QuantConfig = field(default_factory=QuantConfig)
    # per-device kernel autotuning at serving warmup (kernels/autotune.py)
    autotune: AutotuneConfig = field(default_factory=AutotuneConfig)
    # continuous-batching serving path (serving/engine.py)
    serve: ContinuousBatchingConfig = field(
        default_factory=ContinuousBatchingConfig)
    # serving tracing (serving/trace.py)
    trace: TraceConfig = field(default_factory=TraceConfig)
    # live performance introspection (serving/introspect.py)
    introspect: IntrospectConfig = field(default_factory=IntrospectConfig)
    # serving fault model: chaos injection + watchdog (serving/faults.py)
    faults: FaultConfig = field(default_factory=FaultConfig)
    # training knobs (train/): recompute each block or layer pair in the
    # backward pass, the optimizer's name, and the microbatch size of
    # gradient accumulation (0 = none)
    remat: bool = True
    optimizer: str = "adamw"  # adamw | adafactor
    microbatch_size: int = 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived sizes (the reference's formulas) ----
    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings and self.family not in ("vit", "vit_moe"):
            n += self.vocab_size * d  # lm head
        layers = self.num_layers
        if self.family == "encdec":
            layers = self.encoder_layers + self.decoder_layers
        per_layer = 0
        # hybrid: attention and MLP live only in the one shared block
        shared_only = bool(self.shared_attn_every)
        if self.attn is not None and not shared_only:
            a = self.attn
            per_layer += d * (a.q_dim + 2 * a.kv_dim)  # qkv
            per_layer += a.q_dim * d  # out proj
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            per_layer += d * 2 * di  # in_proj (x, z)
            per_layer += di * s.conv_width  # conv
            if s.version == 1:
                dtr = s.dt_rank or -(-d // 16)
                per_layer += di * (dtr + 2 * s.state_dim)  # x_proj
                per_layer += dtr * di  # dt_proj
                per_layer += di * s.state_dim  # A
            else:
                nh = s.num_ssm_heads(d)
                per_layer += d * (2 * s.state_dim + nh)  # B, C, dt proj
                per_layer += nh  # A
            per_layer += di * d  # out_proj
        mlp_mult = 3 if self.glu else 2
        if self.moe is not None:
            moe_layers = layers // self.moe.moe_every
            n += moe_layers * (self.moe.num_experts * mlp_mult * d * self.moe.d_ff
                               + d * self.moe.num_experts)
            if self.d_ff and not shared_only:
                n += (layers - moe_layers) * mlp_mult * d * self.d_ff
            n += layers * per_layer
        else:
            if self.d_ff and not shared_only:
                per_layer += mlp_mult * d * self.d_ff
            n += layers * per_layer
        if self.family == "encdec":  # the decoder's cross-attention
            a = self.attn
            n += self.decoder_layers * (d * (a.q_dim + 2 * a.kv_dim) + a.q_dim * d)
        if self.shared_attn_every and self.attn is not None:
            a = self.attn
            n += d * (a.q_dim + 2 * a.kv_dim) + a.q_dim * d  # the one shared block
            n += mlp_mult * d * self.d_ff
        if self.num_classes:
            n += d * self.num_classes
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        moe_layers = self.num_layers // self.moe.moe_every
        per_expert = (3 if self.glu else 2) * self.d_model * self.moe.d_ff
        return (self.param_count() - moe_layers * self.moe.num_experts * per_expert
                + moe_layers * self.moe.top_k * per_expert)


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape cell: its kind (train, prefill or decode), sequence
    length and global batch."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
