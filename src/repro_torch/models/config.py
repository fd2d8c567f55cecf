"""Unified model configuration covering all ten assigned architectures
(copied unchanged from ``repro/models/config.py``; the port imports nothing
of ``repro``).

A model is a stack of repeated *super-blocks*; each super-block is a list of
sub-layer descriptors (attention / mamba2 / mlp / moe).  Uniform models have a
one-layer super-block repeated L times; Jamba has an 8-sublayer super-block
(1 attention : 7 mamba, MoE on alternate sublayers) repeated 4 times.  This
keeps every architecture expressible as a loop over repeated blocks.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal, Sequence

__all__ = ["SubLayer", "ModelConfig"]

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
Mixer = Literal["attention", "mamba2"]
Ffn = Literal["mlp", "moe", "none"]


@dataclass(frozen=True)
class SubLayer:
    """One (mixer, ffn) pair inside a super-block."""

    mixer: Mixer = "attention"
    ffn: Ffn = "mlp"
    cross_attention: bool = False   # whisper decoder: cross-attn after self


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    citation: str

    # dimensions
    d_model: int
    vocab_size: int
    num_heads: int = 0            # query heads (0 for attention-free)
    num_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 0                 # dense MLP hidden (per expert for MoE)

    # block structure
    super_block: tuple[SubLayer, ...] = (SubLayer(),)
    num_repeats: int = 1          # super-block repeats; layers = repeats*len(sb)

    # attention details
    qkv_bias: bool = False
    rope_theta: float | None = 10_000.0   # None -> sinusoidal absolute pos
    sliding_window: int | None = None     # native SWA (starcoder2)
    attn_logit_softcap: float | None = None

    # norm / activation
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["swiglu", "gelu"] = "swiglu"

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # encoder (whisper) / multimodal prefix (paligemma)
    encoder_layers: int = 0
    encoder_seq: int = 0          # e.g. 1500 audio frames
    prefix_tokens: int = 0        # e.g. 256 image patches (prefix-LM mask)

    # training details
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True            # activation checkpointing over super-blocks
    max_position: int = 1 << 20
    # measurement mode: fully unroll every scan so XLA cost_analysis counts
    # true FLOPs (while bodies are otherwise counted once, not × trip count);
    # used by the dry-run's R=1/R=2 extrapolation compiles, never for runtime
    scan_unroll: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def num_layers(self) -> int:
        return self.num_repeats * len(self.super_block)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True if some sub-quadratic path exists natively (SSM/hybrid/SWA)."""
        if any(sl.mixer == "mamba2" for sl in self.super_block):
            return True
        return self.sliding_window is not None

    def reduced(self, *, d_model: int = 256, repeats: int | None = None,
                experts: int = 4, d_ff: int | None = None,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant: <=2 effective layers, small dims, <=4 experts."""
        scale = d_model / self.d_model
        nh = max(1, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh)) if self.num_kv_heads else 0
        if nkv:
            nh = (nh // nkv) * nkv or nkv
        return replace(
            self,
            d_model=d_model,
            vocab_size=vocab,
            num_heads=nh if self.num_heads else 0,
            num_kv_heads=nkv,
            head_dim=(d_model // nh) if self.num_heads else 0,
            d_ff=d_ff if d_ff is not None else max(64, int(self.d_ff * scale)) if self.d_ff else 0,
            num_repeats=repeats if repeats is not None else (2 if len(self.super_block) == 1 else 1),
            num_experts=min(self.num_experts, experts) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            prefix_tokens=min(self.prefix_tokens, 16) if self.prefix_tokens else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            remat=False,
            dtype="float32",
        )
