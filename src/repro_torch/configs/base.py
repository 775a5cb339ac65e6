"""Config dataclasses, copied from the JAX package's ``configs/base.py``.

The port carries its own copy so that it imports nothing of ``repro``.  The
ALBERT configurations (``albert_base``, ``albert_edgebert``), the dense
decoder ``deepseek_7b`` and the MoE decoders ``qwen2_moe_a2p7b`` and
``qwen3_moe_235b`` exist here so far; each exposes ``CONFIG`` (the
published size) and ``smoke_config()`` (a reduced same-family config for CPU
tests).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

# ---------------------------------------------------------------------------
# EdgeBERT feature configs (the paper's knobs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantConfig:
    """AdaptivFloat quantization (paper §III-E, Table II)."""

    enabled: bool = False
    n_bits: int = 8
    n_exp: int = 3          # paper: 3-bit exponent optimal for ALBERT
    quantize_weights: bool = True
    quantize_activations: bool = True


@dataclass(frozen=True)
class SpanConfig:
    """Adaptive attention span (paper §III-B, Table I)."""

    enabled: bool = False
    max_span: int = 128      # GLUE max sentence length in the paper
    ramp: int = 32           # soft mask ramp R (Sukhbaatar et al.)
    loss_coef: float = 2e-3  # span regularizer weight
    init_span: float = 64.0


@dataclass(frozen=True)
class EarlyExitConfig:
    """Entropy-based early exit (paper §III-A, Eq. 1/4, Fig. 4)."""

    enabled: bool = False
    entropy_threshold: float = 0.3   # T_E, programmable register in the ASIC
    # classifier off-ramps after each of the first (n_layers - 1) blocks
    num_classes: int = 3
    token_level: bool = False        # beyond-paper CALM-style adaptation for LMs


@dataclass(frozen=True)
class PruneConfig:
    """Movement + magnitude pruning (paper §III-C, Fig. 5, Table IV)."""

    enabled: bool = False
    method: str = "magnitude"        # "magnitude" | "movement"
    encoder_sparsity: float = 0.5    # final encoder weight sparsity
    embedding_sparsity: float = 0.6  # paper: uniform 60% across tasks
    begin_step: int = 0
    end_step: int = 1000             # cubic schedule endpoint
    update_every: int = 10
    block_size: int = 1              # 1 = unstructured (paper); >1 = block-sparse
                                     # (beyond-paper, enables TPU tile skipping)


@dataclass(frozen=True)
class EdgeBertConfig:
    quant: QuantConfig = field(default_factory=QuantConfig)
    span: SpanConfig = field(default_factory=SpanConfig)
    early_exit: EarlyExitConfig = field(default_factory=EarlyExitConfig)
    prune: PruneConfig = field(default_factory=PruneConfig)
    distill_alpha: float = 0.0       # phase-1 KD loss mixing weight
    envm_embeddings: bool = False    # model embeddings as MLC2 ReRAM resident


# ---------------------------------------------------------------------------
# Model config — unified across the 6 assigned families
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "encdec", "hybrid", "moe", "vlm", "ssm", "albert")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "swiglu"              # swiglu | gelu | relu2
    norm: str = "rms"                # rms | layernorm
    pos: str = "rope"                # rope | learned | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"          # activation/param dtype for dry-run
    max_seq_len: int = 524288
    # --- factorized embedding (ALBERT) ---
    embed_dim: int = 0               # 0 -> d_model (no factorization)
    # --- cross-layer parameter sharing (ALBERT / zamba shared block) ---
    shared_layers: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    router_aux_coef: float = 0.001
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0              # hybrid: shared attn block every N ssm blocks
    # --- enc-dec ---
    n_enc_layers: int = 0
    enc_seq_len: int = 1500          # whisper: 30s -> 1500 frames (frontend stub)
    # --- VLM cross-attention ---
    cross_attn_every: int = 0        # cross-attn layer inserted every N layers
    n_image_tokens: int = 1601       # stubbed patch-embedding count
    # --- classification head (EdgeBERT GLUE-style tasks) ---
    num_classes: int = 0             # 0 -> LM head only
    # --- EdgeBERT features ---
    edgebert: EdgeBertConfig = field(default_factory=EdgeBertConfig)
    # --- scan/remat ---
    scan_layers: bool = True
    remat_policy: str = "full"       # none | dots | full — "full" saves only
                                     # layer inputs (the right trade at 100B
                                     # scale; see EXPERIMENTS.md §Perf)
    # --- beyond-paper performance features (EXPERIMENTS.md §Perf) ---
    # attention body tagged as a fused Pallas kernel region: on TPU the
    # span/flash kernel keeps score tiles in VMEM; the roofline analyzer
    # excludes in-scope HBM materializations (kernels/span_attention.py is
    # the real kernel, validated in interpret mode)
    fused_attention: bool = False
    # sequence-parallel activations: h is sharded over the model axis on the
    # sequence dim between blocks (Megatron-SP) — halves TP collective volume
    sequence_parallel: bool = False
    sp_batch_axes: tuple = ("data",)
    # KV cache stored as AdaptivFloat-8 codes (uint8 + static exponent bias):
    # halves decode cache HBM traffic (paper §III-E applied to the cache)
    kv_cache_dtype: str = ""         # "" -> cfg.dtype; "af8" -> uint8 codes
    kv_af8_e_min: int = -5           # static bias: binades [2^-5, ~2^3)
    # MoE: group the top-k sort/dispatch per batch row so sorts stay local to
    # the data shard (kills the global-argsort all-gathers)
    moe_grouped_dispatch: bool = False
    # hybrid/ssm: replicate the fused in/out projections instead of sharding
    # them over model — slicing a model-sharded fused projection (z|x|B|C|dt)
    # forces XLA into replicated recompute (§Perf zamba2 iteration)
    ssm_replicated: bool = False
    # pin the MoE dispatch buffer to expert-sharding (requires mesh context)
    moe_buffer_sharded: bool = False
    # explicit-collective EP dispatch via shard_map: zero-comm dispatch under
    # model-replicated activations + ONE psum combine per layer (§Perf)
    moe_shardmap_dispatch: bool = False
    # hybrid: scan over (attn_every mamba blocks + shared attn) GROUPS instead
    # of a per-layer lax.cond — removes the both-branches-in-graph cond from
    # the scan body (§Perf zamba2 iteration 2)
    hybrid_grouped: bool = False

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.embed_dim == 0:
            object.__setattr__(self, "embed_dim", self.d_model)
        if self.n_heads and self.n_kv_heads:
            assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def num_params(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and reporting)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * self.embed_dim
        if self.embed_dim != d:
            emb += self.embed_dim * d   # ALBERT factorization projection
        per_layer = 0
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.family == "ssm":      # rwkv6: time-mix + channel-mix
            per_layer = 4 * d * d + 2 * d * ff + d * ff  # r,k,v,o + decay lora approx
        elif self.family in ("dense", "albert", "vlm"):
            mlp = (3 if self.act == "swiglu" else 2) * d * ff
            per_layer = attn + mlp
        elif self.family == "moe":
            mlp = self.n_experts * 3 * d * self.moe_d_ff
            if self.shared_expert_d_ff:
                mlp += 3 * d * self.shared_expert_d_ff
            per_layer = attn + mlp + d * self.n_experts
        elif self.family == "hybrid":
            # mamba2 block approx: in_proj (2*d_inner + 2*n_groups*state + heads), out_proj
            d_inner = 2 * d
            per_layer = d * (2 * d_inner + 2 * self.ssm_state + d_inner // self.ssm_head_dim) + d_inner * d
        elif self.family == "encdec":
            mlp = (3 if self.act == "swiglu" else 2) * d * ff
            per_layer = attn + mlp
        n_unique = 1 if self.shared_layers else self.n_layers
        total = emb + n_unique * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * per_layer
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * attn
        if self.family == "hybrid" and self.attn_every:
            # one shared attention block on concat(h, x0): works on 2*d
            d2 = 2 * d
            total += d2 * d2 * 4 + 2 * d2 * self.d_ff
        if not self.tie_embeddings and self.vocab_size:
            total += d * v
        return int(total)

    def active_params(self) -> int:
        """Active parameters per token (= num_params for dense)."""
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        dense_moe = self.n_experts * 3 * d * self.moe_d_ff
        active_moe = (self.top_k) * 3 * d * self.moe_d_ff
        if self.shared_expert_d_ff:
            active_moe += 3 * d * self.shared_expert_d_ff
            dense_moe += 3 * d * self.shared_expert_d_ff
        return self.num_params() - self.n_layers * dense_moe + self.n_layers * active_moe

    def with_edgebert(self, **kw) -> "ModelConfig":
        return replace(self, edgebert=replace(self.edgebert, **kw))


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

PORTED_ARCHS = ("albert_base", "albert_edgebert", "deepseek_7b", "qwen2_moe_a2p7b", "qwen3_moe_235b")


def _config_module(arch: str):
    import importlib

    arch = arch.replace("-", "_").replace(".", "p")
    if arch not in PORTED_ARCHS:
        raise KeyError(f"{arch!r} is not ported yet; ported: {PORTED_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    """The full published config for an architecture id."""
    return _config_module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """The reduced same-family config used by the CPU tests."""
    return _config_module(arch).smoke_config()
