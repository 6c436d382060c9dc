"""Configuration system of the PyTorch port — a copy of ``repro/config.py``
with its imports pointed at ``repro_torch`` (the host-side layer must stay
bitwise equal to the reference; ``tests/test_torch_schedule.py`` audits the
dataclass fields).

Two levels of config:

* :class:`ModelConfig` — architecture hyperparameters, covering all six
  assigned families (dense / moe / ssm / hybrid / vlm / audio).  A model is
  described as a *repeating unit* of blocks (``block_pattern``) stacked
  ``n_units`` times.  Only ``param_count`` is used by the port so far (it
  sizes the what-if problem to an architecture).

* :class:`RunConfig` — everything about a run that is not the model:
  synchronization protocol (the paper's contribution), learning-rate policy,
  mesh/sharding choices, micro-batching, data shape.

Configs are plain frozen dataclasses; ``src/repro_torch/configs/<arch>.py`` each
export a ``CONFIG`` built from these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.membership import MembershipTimeline
from repro_torch.optim.spec import KERNEL_OPTIMIZERS
from repro_torch.serve.fleet import FleetConfig

# replay weight-ring knobs (core/engine.py compiled replay, DESIGN.md §12)
RING_DTYPES = ("fp32", "bf16")
RING_IMPLS = ("auto", "pallas", "fused", "stock")

# replay placement (DESIGN.md §13): "single" replays the whole trace on one
# device; "spmd" shard_maps the scan over a (ps, learner) emulated device
# mesh with real cross-shard collectives.
PLACEMENTS = ("single", "spmd")

# ---------------------------------------------------------------------------
# Block types that can appear inside a repeating unit.
# ---------------------------------------------------------------------------
BLOCK_ATTN = "attn"                      # attention + dense MLP
BLOCK_MOE = "moe"                        # attention + mixture-of-experts MLP
BLOCK_MOE_DENSE_RESIDUAL = "moe_dense"   # attention + (dense MLP ∥ MoE)  [arctic]
BLOCK_MAMBA = "mamba"                    # Mamba2 SSD block
BLOCK_RWKV = "rwkv"                      # RWKV6 (Finch) block
BLOCK_SHARED_ATTN = "shared_attn"        # weight-shared attention block [zamba2]

VALID_BLOCKS = {
    BLOCK_ATTN,
    BLOCK_MOE,
    BLOCK_MOE_DENSE_RESIDUAL,
    BLOCK_MAMBA,
    BLOCK_RWKV,
    BLOCK_SHARED_ATTN,
}

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

# per-minibatch compute-duration models for the simulator's schedule pass
# (core/trace.make_duration_sampler dispatches on these)
DURATION_MODELS = ("homogeneous", "two_speed", "pareto")

# The calibrated-duration grammar: "calibrated:<arch>[:<int>mb]" plugs the
# calibrated per-minibatch cost model of core/tradeoff.py into the schedule
# pass for arch ∈ CALIBRATED_ARCHS, optionally overriding the workload's
# model size (e.g. "calibrated:base:300mb" — the paper's Table-1 adversarial
# scenario).  ONE parser serves both layers that accept these strings:
# RunConfig.duration_model and ExperimentSpec.duration.
CALIBRATED_PREFIX = "calibrated:"
CALIBRATED_ARCHS = ("base", "adv", "adv*")


def parse_calibrated(duration: str):
    """``'calibrated:<arch>[:<int>mb]'`` → ``(arch, model_bytes | None)``;
    raises ValueError (with the shared grammar message) on anything else."""
    parts = duration[len(CALIBRATED_PREFIX):].split(":")
    err = ValueError(
        f"bad calibrated duration {duration!r}: expected "
        f"'calibrated:<arch>[:<int>mb]' with arch in {CALIBRATED_ARCHS}")
    if not duration.startswith(CALIBRATED_PREFIX) or len(parts) not in (1, 2):
        raise err
    arch = parts[0]
    if arch not in CALIBRATED_ARCHS:
        raise err
    if len(parts) == 1:
        return arch, None
    size = parts[1]
    if not (size.endswith("mb") and size[:-2].isdigit()):
        raise err
    return arch, float(size[:-2]) * 1e6


def validate_duration_model(value: str) -> None:
    """The ONE validator for ``RunConfig.duration_model``: a sampler name
    from DURATION_MODELS, or a calibrated-grammar string (accept-and-defer:
    ``core/trace.make_duration_sampler`` resolves it against the cost model
    of ``core/tradeoff.py``)."""
    if value.startswith(CALIBRATED_PREFIX):
        parse_calibrated(value)
        return
    if value not in DURATION_MODELS:
        raise ValueError(
            f"unknown duration_model {value!r}: expected one of "
            f"{DURATION_MODELS} or 'calibrated:<arch>[:<int>mb]' with arch "
            f"in {CALIBRATED_ARCHS}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  See src/repro_torch/configs/ for instances."""

    name: str
    family: str                           # one of FAMILIES
    # --- transformer spine -------------------------------------------------
    n_layers: int                         # total layer count (for bookkeeping)
    d_model: int
    n_heads: int                          # query heads (0 for attn-free)
    n_kv_heads: int                       # GQA KV heads
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = (BLOCK_ATTN,)
    n_units: int = 0                      # stacked repeats of block_pattern
    d_head: int = 0                       # 0 -> d_model // n_heads
    # --- attention flavour --------------------------------------------------
    causal: bool = True                   # False for encoder-only (audio)
    qk_norm: bool = False                 # qwen3
    qkv_bias: bool = False                # qwen2
    rope_theta: float = 1e4
    sliding_window: int = 0               # 0 = full attention; >0 = window size
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                     # 0 -> d_ff
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    # --- SSM (Mamba2) -------------------------------------------------------
    ssm_state: int = 0                    # N, state dim per head
    ssm_expand: int = 2                   # d_inner = expand * d_model
    ssm_head_dim: int = 64                # P
    ssm_chunk: int = 256                  # chunk length for SSD scan
    ssm_conv: int = 4                     # depthwise conv width
    # --- RWKV6 --------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 256
    # --- modality frontend (stub per spec) ----------------------------------
    frontend: str = "none"                # "none" | "audio" | "vision"
    n_prefix_embeds: int = 0              # vision patches / audio frames prepended
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"               # compute/param dtype
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- provenance ----------------------------------------------------------
    source: str = ""                      # paper / model-card citation

    # -- derived -------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        for b in self.block_pattern:
            if b not in VALID_BLOCKS:
                raise ValueError(f"unknown block type {b!r}")
        if self.n_units == 0:
            object.__setattr__(
                self, "n_units",
                max(1, self.n_layers // max(1, len(self.block_pattern))))
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def effective_layers(self) -> int:
        return self.n_units * len(self.block_pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/head shard over
        the model axis (standard practice; padded ids are never emitted by
        the data pipeline)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def has_attention(self) -> bool:
        return any(b in (BLOCK_ATTN, BLOCK_MOE, BLOCK_MOE_DENSE_RESIDUAL,
                         BLOCK_SHARED_ATTN) for b in self.block_pattern)

    @property
    def attention_free(self) -> bool:
        return not self.has_attention

    @property
    def subquadratic(self) -> bool:
        """Can this model run very long contexts (long_500k)?"""
        if not self.has_attention:
            return True
        return self.sliding_window > 0

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    # -- analytic parameter count (used by roofline & runtime model) --------
    def param_count(self) -> int:
        M, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.d_head
        total = V * M                                    # embedding
        if not self.tie_embeddings:
            total += V * M                               # lm head
        per_unit = 0
        for b in self.block_pattern:
            if b in (BLOCK_ATTN, BLOCK_MOE, BLOCK_MOE_DENSE_RESIDUAL,
                     BLOCK_SHARED_ATTN):
                attn = M * (H * Dh) + 2 * M * (KV * Dh) + (H * Dh) * M
                if self.qkv_bias:
                    attn += (H + 2 * KV) * Dh
                per_unit_attn = attn + 2 * M             # 2 norms
                if b == BLOCK_ATTN:
                    per_unit += per_unit_attn + 3 * M * F
                elif b == BLOCK_MOE:
                    mf = self.moe_d_ff or F
                    per_unit += per_unit_attn + self.n_experts * 3 * M * mf \
                        + M * self.n_experts
                elif b == BLOCK_MOE_DENSE_RESIDUAL:
                    mf = self.moe_d_ff or F
                    per_unit += per_unit_attn + 3 * M * F \
                        + self.n_experts * 3 * M * mf + M * self.n_experts
                elif b == BLOCK_SHARED_ATTN:
                    # zamba2 shared block: parameters shared across units;
                    # counted once outside the loop.
                    per_unit += 2 * M
            elif b == BLOCK_MAMBA:
                Din = self.ssm_d_inner
                Hs, N = self.ssm_n_heads, self.ssm_state
                G = 1  # n_groups
                conv_dim = Din + 2 * G * N
                per_unit += (
                    M * (2 * Din + 2 * G * N + Hs)       # in_proj
                    + conv_dim * self.ssm_conv           # conv1d
                    + 2 * Hs                             # A_log, D
                    + Hs                                 # dt_bias
                    + Din                                # gated norm
                    + Din * M                            # out_proj
                    + 2 * M)                             # norms
            elif b == BLOCK_RWKV:
                P = self.rwkv_head_dim
                Hr = self.rwkv_n_heads
                lora = 64            # decay LoRA rank (models.rwkv)
                per_unit += (
                    5 * M * M        # r, k, v, gate, output
                    + 2 * M * lora   # data-dependent decay LoRA (A, B)
                    + Hr * P         # bonus u
                    + 7 * M          # token-shift mixes + ln_x + decay_w0
                    + 2 * M * F      # channel-mix squared-relu FFN
                    + 2 * M)
        total += per_unit * self.n_units
        if BLOCK_SHARED_ATTN in self.block_pattern:
            attn = M * (H * Dh) + 2 * M * (KV * Dh) + (H * Dh) * M
            total += attn + 3 * M * F                    # shared attn + its MLP
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        mf = self.moe_d_ff or self.d_ff
        dead = 0
        for b in self.block_pattern:
            if b in (BLOCK_MOE, BLOCK_MOE_DENSE_RESIDUAL):
                dead += (self.n_experts - self.top_k) * 3 * self.d_model * mf
        return int(self.param_count() - dead * self.n_units)


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """A published Zamba2 hybrid (``configs/zamba2_7b_instruct.py``),
    beside the reference's fields rather than among them: ``n_layers``
    Mamba2 layers, of which those in ``hybrid_layer_ids`` first run one of
    ``num_mem_blocks`` weight-shared transformer blocks (in turn) on
    concat(x, token embedding) and feed its output, through a per-layer
    linear map, into the Mamba2 layer's input (``models/hybrid.py``).
    ``block_pattern`` is ``("mamba",)``: the reference's unit grammar
    cannot say this, and only ``models/hybrid.py`` reads the layer list.
    ``d_head`` is the shared attention's head (2·d_model / n_heads);
    ``ssm_groups`` the B / C groups; ``adapter_rank`` the rank of each
    hybrid layer's adapter on the shared MLP's gate/up projection."""

    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 128
    ssm_groups: int = 1

    @property
    def has_attention(self) -> bool:
        return bool(self.hybrid_layer_ids)

    @property
    def attn_scale(self) -> float:
        """Zamba2's shared attention scales q·k by (d_head / 2)^-1/2: its
        input is concat(x, e), twice the model width."""
        return (self.d_head / 2) ** -0.5

    def shared_block_of(self, layer: int) -> int:
        """The shared block a hybrid layer runs: the blocks in turn."""
        return self.hybrid_layer_ids.index(layer) % self.num_mem_blocks

    def param_count(self) -> int:
        M, F, V, r = self.d_model, self.d_ff, self.vocab_size, \
            self.adapter_rank
        Din, H, N, G = self.ssm_d_inner, self.ssm_n_heads, self.ssm_state, \
            self.ssm_groups
        conv = Din + 2 * G * N
        mamba = (M + M * (Din + conv + H) + self.ssm_conv * conv + conv
                 + 3 * H + Din + Din * M)
        A = 2 * M
        shared = (A + 3 * A * self.n_heads * self.d_head
                  + self.n_heads * self.d_head * M + M + M * 2 * F + F * M)
        hybrid = M * M + M * r + r * 2 * F
        total = V * M + self.n_layers * mamba + M
        total += self.num_mem_blocks * shared
        total += len(self.hybrid_layer_ids) * hybrid
        if not self.tie_embeddings:
            total += M * V
        return int(total)

    def active_param_count(self) -> int:
        return self.param_count()


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Run configuration — the paper's knobs live here.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything about a run besides the architecture.

    The paper's (σ, μ, λ) knobs:
      * ``protocol``     — "hardsync" | "softsync" | "async"
      * ``n_softsync``   — the splitting parameter n (protocol="softsync");
                           n = λ degenerates to async (Eq. 5).
      * ``n_learners``   — λ.  In the distributed runtime this is the size of
                           the learner (data) mesh axis; in the simulator it
                           is the number of simulated learner processes.
      * ``minibatch``    — μ, per-learner mini-batch size.
      * ``lr_policy``    — "const" | "staleness_inverse" (Eq. 6)
                           | "sqrt_scale" (hardsync α₀√(λμ/B))
                           | "per_gradient" (footnote-3 fine-grained variant).
    """

    protocol: str = "hardsync"
    n_softsync: int = 1
    n_learners: int = 1
    minibatch: int = 128
    base_lr: float = 0.001
    ref_batch: int = 128                  # B in α₀√(λμ/B)
    lr_policy: str = "const"
    momentum: float = 0.9
    optimizer: str = "momentum"           # "momentum" | "adagrad" | "adamw"
    weight_decay: float = 0.0
    warmstart_epochs: int = 0             # paper §5.5 hardsync warm start
    seed: int = 0
    # --- simulated cluster heterogeneity (trace schedule pass) --------------
    # Per-minibatch compute-duration model used by the event-queue schedule
    # (core/trace.py).  "homogeneous" is the paper's cluster (lognormal
    # jitter); "two_speed" splits learners into a slow and a fast tier;
    # "pareto" adds a heavy straggler tail (Dutta et al., "Slow and Stale
    # Gradients Can Win the Race").
    duration_model: str = "homogeneous"   # | "two_speed" | "pareto"
    slow_fraction: float = 0.25           # two_speed: fraction of slow learners
    slow_factor: float = 4.0              # two_speed: slowdown multiplier
    pareto_alpha: float = 2.5             # pareto: tail index (smaller=heavier)
    pareto_scale: float = 0.5             # pareto: straggler magnitude
    # --- PS topology (Rudra-base / adv / adv*; core/topology.py) ------------
    # shards: S parameter-server shards over the flat weight buffer (1 = the
    # flat Rudra-base server).  groups: G learner groups with group-level
    # gradient aggregation (0 = ungrouped — each learner pushes directly;
    # must divide λ otherwise).  shard_pull_jitter: per-(pull, shard)
    # completion skew in simulated seconds — updates landing between the
    # logical pull and a shard's completion are visible in that shard's
    # slice (shard-local staleness; 0 = consistent snapshot reads).
    shards: int = 1
    groups: int = 0
    shard_pull_jitter: float = 0.0
    # --- replay weight ring (compiled simulator hot loop; DESIGN.md §12) ----
    # ring_dtype: storage dtype of the (K, D) snapshot ring.  "bf16" halves
    # ring bytes and carries an fp32 error-feedback residue so the master
    # weight chain stays exactly the fp32 trajectory — the only
    # approximation is gradients being evaluated at quantized snapshots.
    # ring_impl: which scan body executes an update event — "auto" (Pallas
    # replay megakernel on TPU, its fused jnp twin elsewhere) or a forced
    # "pallas" / "fused" / "stock" ("stock" is the pre-megakernel
    # gather→update→set chain, the bitwise baseline; fp32 only).
    ring_dtype: str = "fp32"
    ring_impl: str = "auto"
    # --- replay placement (DESIGN.md §13) -----------------------------------
    # placement: "single" (default) compiles the replay scan for one device;
    # "spmd" shard_maps it over a make_sim_mesh(S, L) device mesh — each PS
    # shard's (K, Dp) ring lives on its own "ps"-axis device and the c
    # gradient slots of an update split across L "learner"-axis devices, with
    # cross-shard pulls / combine pushes as real all_gather/psum/ppermute
    # collectives.  spmd_learners: L (0 = auto — the largest divisor of c
    # that fits the visible device count).
    placement: str = "single"
    spmd_learners: int = 0
    # --- elastic membership (repro_torch.membership; core/trace schedule pass) ----
    # membership: join/leave/crash-restart events per learner.  Resolves
    # entirely at schedule time: joins/leaves move the effective λ(t) that
    # n-softsync's splitting threshold c(t) = max(1, ⌊P(t)/n⌋) follows, a
    # crashed learner's in-flight push is dropped (a validity mask on the
    # trace), and a restarted learner re-pulls with fresh timestamps.  An
    # empty timeline reproduces the pre-elastic schedule bit-for-bit.
    # backup: Chen et al. backup learners (protocol="hardsync" only): each
    # round commits the first P − backup arrivals and cancels the rest —
    # hardsync's accuracy at near-async runtime, a first-class point on the
    # staleness axis.
    membership: MembershipTimeline = MembershipTimeline()
    backup: int = 0
    # --- distributed runtime ------------------------------------------------
    num_microbatches: int = 1
    remat: bool = True
    fsdp: bool = False                    # shard params over data axis too
    use_pallas: bool = False              # TPU fast-path kernels
    attn_impl: str = "chunked"            # "naive" | "chunked" | "pallas"
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    # unroll: trace structural loops as python loops instead of lax.scan.
    # Used by the roofline cost probes — XLA's cost_analysis counts a while
    # body ONCE regardless of trip count, so probes unroll (launch/roofline).
    unroll: bool = False
    # sequence-parallel residual (Korthikanti et al.) for head-parallel
    # archs: constrain the residual stream to this PartitionSpec between
    # blocks so Megatron's fp32 partial-sum all-reduces become bf16
    # reduce-scatter/all-gather pairs and norms/residuals shard over `model`
    # (§Perf iteration B1).  None = no constraint (CPU tests, seq-par mode).
    residual_spec: Optional[tuple] = None
    # --- train-while-serve (repro_torch.serve; DESIGN.md §14) ---------------------
    # serving: a FleetConfig attaches a serving fleet to the run — N serving
    # replicas publishing weight versions from the PS ring under a
    # PublicationPolicy while inference traffic arrives.  The schedule pass
    # resolves publications/requests host-side (rng stream independent of
    # the arrival schedule) and the replay engine captures exactly the
    # published ring rows; None reproduces the pre-serving engine bit for
    # bit.
    serving: Optional[FleetConfig] = None

    def __post_init__(self):
        if self.protocol not in ("hardsync", "softsync", "async"):
            raise ValueError(f"unknown protocol {self.protocol!r}")
        if self.lr_policy not in ("const", "staleness_inverse", "sqrt_scale",
                                  "per_gradient"):
            raise ValueError(f"unknown lr_policy {self.lr_policy!r}")
        validate_duration_model(self.duration_model)
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.groups < 0:
            raise ValueError(f"groups must be >= 0, got {self.groups}")
        if self.groups and self.n_learners % self.groups != 0:
            raise ValueError(f"groups={self.groups} must divide "
                             f"n_learners={self.n_learners}")
        if self.shard_pull_jitter < 0:
            raise ValueError(f"shard_pull_jitter must be >= 0, "
                             f"got {self.shard_pull_jitter}")
        if not isinstance(self.membership, MembershipTimeline):
            # accept raw event sequences (or None) for convenience
            object.__setattr__(
                self, "membership",
                MembershipTimeline(tuple(self.membership or ())))
        self.membership.validate_for(self.n_learners)
        if self.backup < 0:
            raise ValueError(f"backup must be >= 0, got {self.backup}")
        if self.backup and self.protocol != "hardsync":
            raise ValueError(
                f"backup={self.backup} is the Chen et al. backup-learner "
                f"variant of hardsync; protocol {self.protocol!r} already "
                f"tolerates stragglers via staleness")
        if self.backup >= self.n_pushers:
            raise ValueError(
                f"backup={self.backup} must leave at least one committed "
                f"arrival per round (P = {self.n_pushers} pushers)")
        if self.ring_dtype not in RING_DTYPES:
            raise ValueError(f"unknown ring_dtype {self.ring_dtype!r}: "
                             f"expected one of {RING_DTYPES}")
        if self.ring_impl not in RING_IMPLS:
            raise ValueError(f"unknown ring_impl {self.ring_impl!r}: "
                             f"expected one of {RING_IMPLS}")
        if self.ring_dtype == "bf16":
            if self.ring_impl == "stock":
                raise ValueError(
                    "ring_dtype='bf16' needs the fused megakernel scan body "
                    "to carry the error-feedback residue; ring_impl='stock' "
                    "keeps the fp32 ring (use 'auto', 'fused' or 'pallas')")
            if self.optimizer not in KERNEL_OPTIMIZERS:
                raise ValueError(
                    f"ring_dtype='bf16' requires a kernel-supported "
                    f"optimizer {KERNEL_OPTIMIZERS}; {self.optimizer!r} "
                    f"replays on the pytree path with an fp32 ring")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r}: "
                             f"expected one of {PLACEMENTS}")
        if self.spmd_learners < 0:
            raise ValueError(f"spmd_learners must be >= 0, "
                             f"got {self.spmd_learners}")
        if self.spmd_learners and self.placement != "spmd":
            raise ValueError(
                f"spmd_learners={self.spmd_learners} only applies to "
                f"placement='spmd' (got placement={self.placement!r})")
        if self.placement == "spmd":
            if self.optimizer not in KERNEL_OPTIMIZERS:
                raise ValueError(
                    f"placement='spmd' needs a kernel-supported optimizer "
                    f"{KERNEL_OPTIMIZERS} (flat per-shard ring carries); "
                    f"{self.optimizer!r} replays on the pytree path")
            if (self.spmd_learners
                    and self.gradients_per_update % self.spmd_learners):
                raise ValueError(
                    f"spmd_learners={self.spmd_learners} must divide the "
                    f"update width c={self.gradients_per_update} so every "
                    f"learner device owns an equal slot block")
        if self.serving is not None:
            if not isinstance(self.serving, FleetConfig):
                raise ValueError(
                    f"serving must be a repro_torch.serve.fleet.FleetConfig, "
                    f"got {type(self.serving).__name__}")
            if self.placement == "spmd":
                raise ValueError(
                    "serving is not supported with placement='spmd': the "
                    "serving lane captures published ring rows inside the "
                    "single-device replay scan, which shard_map splits into "
                    "per-shard (K, Dp) rings; replay the serving trace with "
                    "placement='single' (the default)")
            if self.shards > 1 and self.ring_impl == "stock":
                raise ValueError(
                    "serving with shards>1 needs the fused ring "
                    "(ring_impl='auto'/'fused'/'pallas'): the stock sharded "
                    "scan keeps a (S, K, Dp) ring with no flat row for a "
                    "publication to read")
        if self.elastic and self.lr_policy == "per_gradient":
            raise ValueError(
                "per_gradient LRs imply sequential optimizer events, which "
                "cannot mask an elastic timeline's cancelled pushes; use a "
                "scalar lr_policy with elastic membership")

    def replace(self, **kw) -> "RunConfig":
        """A copy with ``kw`` fields changed — ``dataclasses.replace`` with
        ``__post_init__`` validation re-run (the frozen-dataclass contract),
        so sweep builders don't import ``dataclasses`` everywhere."""
        return dataclasses.replace(self, **kw)

    @property
    def n_pushers(self) -> int:
        """Entities pushing gradients at the PS: with learner groups the
        group is the pusher (one aggregated gradient per group round),
        otherwise every learner pushes directly."""
        return self.groups if self.groups else self.n_learners

    @property
    def group_size(self) -> int:
        """Learners aggregated per push (1 ⇔ no effective grouping)."""
        return self.n_learners // self.n_pushers

    @property
    def elastic(self) -> bool:
        """True when the membership timeline actually changes the cluster."""
        return not self.membership.static

    @property
    def gradients_per_update(self) -> int:
        """c = ⌊P/n⌋ (Eq. 5 over the P pushing entities; P = λ ungrouped).
        hardsync: P − backup (each round commits the first P − backup
        arrivals; Chen et al.).  With an elastic timeline this is the
        *width bound* of a trace row — rows fired while λ(t) < λ commit
        fewer slots, masked on the trace."""
        if self.protocol == "hardsync":
            return max(1, self.n_pushers - self.backup)
        if self.protocol == "async":
            return 1
        return max(1, self.n_pushers // self.n_softsync)

    @property
    def expected_staleness(self) -> float:
        """⟨σ⟩ for LR modulation.  Paper: ⟨σ⟩ = n for pipelined n-softsync."""
        if self.protocol == "hardsync":
            return 0.0
        if self.protocol == "async":
            return float(self.n_pushers)
        return float(self.n_softsync)

    def learning_rate(self, measured_staleness: Optional[float] = None) -> float:
        """Resolve the paper's LR policies (Eq. 6 / hardsync scaling)."""
        if self.lr_policy == "const":
            return self.base_lr
        if self.lr_policy == "sqrt_scale":
            return self.base_lr * math.sqrt(
                self.n_learners * self.minibatch / self.ref_batch)
        sigma = (measured_staleness if measured_staleness is not None
                 else self.expected_staleness)
        return self.base_lr / max(1.0, sigma)


def validate_pairing(model: ModelConfig, shape: InputShape) -> Optional[str]:
    """Return a skip-reason string if (model, shape) must be skipped, else None.

    Skips mirror DESIGN.md §8: encoder-only models have no decode step;
    full-attention models need a sliding-window variant for long_500k (all of
    ours implement it, so only encoder-only skips remain).
    """
    if model.encoder_only and shape.kind == "decode":
        return "encoder-only architecture has no autoregressive decode step"
    if shape.name == "long_500k" and not model.subquadratic:
        return "full quadratic attention cannot serve 524k context"
    return None
