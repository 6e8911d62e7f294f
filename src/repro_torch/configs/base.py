"""Model and run configuration dataclasses (copy of ``repro/configs/base.py``).

The port keeps its own copy so that it never imports the JAX package.
Carried: ``ModelConfig`` (all fields, so a reference config reads the same
here), ``DecodeCaps``, ``InputShape`` and ``TrainConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

MIXERS = ("attn", "attn_local", "attn_global", "attn_bidir", "mamba", "rwkv")
MLPS = ("dense", "moe", "rwkv_cm")


@dataclasses.dataclass(frozen=True)
class DecodeCaps:
    """Serving capabilities derived from the architecture.

    - ``pageable``: every self-attention layer is plain full attention, so
      its KV can live in the global page pool.
    - ``prefix_shareable``: the cache is a pure function of token ids.
    - ``needs_exact_prefill``: a recurrent layer must not be stepped by
      right-padding.
    - ``constant_state``: no self-attention; O(1) decode state per slot.
    - ``windowed``: some layer keeps a sliding-window ring.
    - ``cross_cache``: encoder-decoder with a per-slot cross cache.
    """
    pageable: bool
    prefix_shareable: bool
    needs_exact_prefill: bool
    constant_state: bool
    windowed: bool
    cross_cache: bool


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    block_pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)

    mlp_kind: str = "swiglu"         # swiglu | gelu | geglu

    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    pos_kind: str = "rope"           # rope | mrope | learned | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0

    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    post_block_norm: bool = False
    norm_eps: float = 1e-6

    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0

    rwkv_head_size: int = 64

    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0
    enc_block_pattern: Tuple[Tuple[str, str], ...] = (("attn_bidir", "dense"),)

    is_encoder_only: bool = False

    n_vision_tokens: int = 0

    tie_embeddings: bool = False
    scale_embeddings: bool = False
    max_position: int = 0

    source: str = ""

    def __post_init__(self):
        object.__setattr__(self, "head_dim",
                           self.head_dim or self.d_model // self.n_heads)
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.arch_id}: n_layers {self.n_layers} does "
                             f"not tile block_pattern {self.block_pattern}")
        for mixer, mlp in self.block_pattern:
            if mixer not in MIXERS or mlp not in MLPS:
                raise ValueError(f"unknown block kind {(mixer, mlp)}")

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def decode_caps(self) -> DecodeCaps:
        """Serving capability flags, derived from ``block_pattern``."""
        mixers = {m for m, _ in self.block_pattern}
        mlps = {mlp for _, mlp in self.block_pattern}
        attn = {m for m in mixers if m.startswith("attn")}
        recurrent = bool(mixers & {"mamba", "rwkv"}) or "rwkv_cm" in mlps
        pageable = bool(attn) and attn == {"attn"}
        return DecodeCaps(
            pageable=pageable,
            prefix_shareable=(pageable and not recurrent
                              and not self.is_encoder_decoder
                              and self.n_vision_tokens == 0),
            needs_exact_prefill=recurrent,
            constant_state=not attn,
            windowed="attn_local" in mixers,
            cross_cache=self.is_encoder_decoder,
        )

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Full per-layer (mixer, mlp) list of length n_layers."""
        return tuple(self.block_pattern) * self.n_blocks

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, self.d_model // 16)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def has_moe(self) -> bool:
        return any(mlp == "moe" for _, mlp in self.block_pattern)

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count, counted as the reference counts it:
        token embedding, learned positions, an untied LM head for decoders
        (not for encoder-only models), the final norm's scale, and per layer
        2 d for the two norms plus the mixer and the MLP.  A dense layer
        counts attention and its MLP; an MoE layer attention, the router
        and every expert's three matrices (``active_only``: the ``top_k``
        a token runs); a mamba mixer counts in_proj, the depthwise conv's
        weights and bias, x_proj, dt_proj, 2 d_inner for dt_bias and
        d_skip, and out_proj (like the reference's ``mamba_params``, it
        leaves out a_log's d_inner x N); an RWKV-6 layer counts the time mix (r, k, v, g
        and output projections, the mix and decay LoRAs, the bias and mix
        vectors) and the channel mix together, as the reference's
        ``rwkv_params`` does.  An encoder-decoder adds, as the reference's
        does, each encoder layer (2 d for its norms, attention and the MLP)
        and each decoder layer's cross-attention projections; like the
        reference's, it leaves out the encoder's positions and final norm
        and the cross sublayer's norm.  The MLP biases (the GELU MLP's) and
        the query/key norms' 2 Dh a layer are left out too, as there."""
        d, v = self.d_model, self.vocab_size
        total = v * d + d
        if self.max_position:
            total += self.max_position * d
        if not self.tie_embeddings and not self.is_encoder_only:
            total += d * v
        attn = (d * self.n_heads * self.head_dim
                + 2 * d * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * d)
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        mlp = (3 if self.mlp_kind in ("swiglu", "geglu") else 2) * d * self.d_ff
        rwkv = (5 * d * d + d * (5 * 32) + 5 * 32 * d + d * 64 + 64 * d
                + 2 * d * self.d_ff + d * d + 10 * d)
        din, n, r = self.mamba_d_inner, self.mamba_d_state, self.dt_rank
        mamba = (d * 2 * din + self.mamba_d_conv * din + din
                 + din * (r + 2 * n) + r * din + 2 * din + din * d)
        for mixer, mlp_kind in self.layer_kinds():
            total += 2 * d
            if mixer == "rwkv":
                total += rwkv
            elif mixer == "mamba":
                total += mamba
            else:
                total += attn
            if mlp_kind == "dense":
                total += mlp
            elif mlp_kind == "moe":
                e = self.top_k if active_only else self.n_experts
                total += (e * 3 * d * self.moe_d_ff
                          + d * self.n_experts)
        if self.is_encoder_decoder:
            total += self.n_enc_layers * (2 * d + attn + mlp)
            total += self.n_layers * attn
        return total


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training knobs (copy of the reference's ``TrainConfig``, same field
    names and defaults).

    The port trains on one card, or data-parallel over ranks of
    ``torch.distributed`` (``train/train_step.py`` ``make_train_step_dp``)
    with any of the four strategies and ``bucket_bytes``, the fp16/int8
    compressed exchange (``grad_compression``), the overlapped drain
    (``overlap_exchange``) and the calibration-only strategy ``"local"``
    (no exchange at all; it takes neither compression nor overlap).
    ``optimizer`` is ``"lamb"`` or ``"adamw"``.  The sharding fields
    (``fsdp``, ``shard_grads``, ``pure_dp``) change nothing in pure data
    parallelism, as in the reference on a one-device mesh.
    """
    precision: str = "bf16"            # f32 | bf16 | f16
    accum_steps: int = 4
    collective_strategy: str = "psum"
    bucket_bytes: int = 25 * 2 ** 20
    grad_compression: str = "none"
    overlap_exchange: bool = False
    optimizer: str = "lamb"
    learning_rate: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    remat: bool = True
    fsdp: bool = True
    shard_grads: bool = False
    pure_dp: bool = False
    moe_impl: str = "a2a"
    seed: int = 0

    def check_supported(self) -> None:
        """Raise ``ValueError`` for an optimizer other than LAMB and
        AdamW, an unknown strategy or compression and for ``"local"`` with
        compression or overlap."""
        from repro_torch.core.collectives import GRAD_COMPRESSIONS, STRATEGIES
        # the reference runs AdamW for any name but "lamb"
        # (train/train_step.py _optimizer_update); the port refuses a typo
        if self.optimizer not in ("lamb", "adamw"):
            raise ValueError(f"unknown optimizer {self.optimizer!r} (one of "
                             "'lamb', 'adamw')")
        if self.collective_strategy not in STRATEGIES + ("local",):
            raise ValueError(f"unknown collective strategy "
                             f"{self.collective_strategy!r}")
        if self.grad_compression not in GRAD_COMPRESSIONS:
            raise ValueError(f"unknown gradient compression "
                             f"{self.grad_compression!r} (one of "
                             f"{GRAD_COMPRESSIONS})")
        if self.collective_strategy == "local" and (
                self.grad_compression != "none" or self.overlap_exchange):
            raise ValueError("collective_strategy 'local' (the calibration "
                             "twin) exchanges nothing: it takes no "
                             "grad_compression and no overlap_exchange")
        if self.bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes {self.bucket_bytes} must be "
                             "positive")
