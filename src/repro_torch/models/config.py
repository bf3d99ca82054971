"""Model configuration schema for the architecture zoo.

One frozen dataclass describes every architecture of the registry: dense,
GQA and MQA attention, MLA, Mamba2 SSD blocks, MoE FFNs (with the paper's
SCD router as an option), encoder-decoder and modality-frontend stubs.
Layer stacking is a repeating *pattern* of (mixer, ffn) slots. The fields,
their defaults and ``smoke()`` are the reference's
(``src/repro/models/config.py``); ``dtype`` and ``param_dtype`` are torch
dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 0          # routed experts
    n_shared: int = 0           # always-on shared experts
    topk: int = 2
    d_ff: int = 0               # per-expert hidden
    router: str = "topk"        # "topk" | "scd" (the paper's solver)
    capacity_factor: float = 1.25
    scd_iters: int = 4


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    q_lora: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str = "lm"            # "lm" | "encdec"
    modality: str = "text"      # "text" | "audio" | "vision" (frontend stub)
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"           # "silu" (SwiGLU) | "gelu" (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # Layer pattern (repeated): mixers and ffns per slot.
    # mixer in {"attn", "mamba"}; ffn in {"dense", "moe", "none"}.
    pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("dense",)
    # Layer 0 override: dense FFN of this width instead of slot ffn
    # (DeepSeek-V2's first dense layer). 0 = no override.
    first_dense_ff: int = 0

    use_mla: bool = False
    mla: MLACfg = MLACfg()
    moe: MoECfg = MoECfg()
    mamba: MambaCfg = MambaCfg()

    # Encoder (kind == "encdec"): encoder layer count.
    n_enc_layers: int = 0

    # Vision stub: number of patch embeddings prepended to the text tokens.
    n_patches: int = 0

    # Sliding-window attention (0 = full causal).
    window: int = 0

    # Parameter-sharding strategy of the reference's mesh ("full", "zero1",
    # "none"); carried for parity, read by no module of this package yet.
    fsdp_mode: str = "full"

    # Numerics.
    dtype: torch.dtype = torch.bfloat16          # activations / compute
    param_dtype: torch.dtype = torch.bfloat16    # stored parameters
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024                       # q/kv chunking for long seq
    loss_chunk: int = 1024                       # vocab-proj chunking in the loss

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not a "
                             f"multiple of the pattern {self.pattern}")
        return self.n_layers // len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests (the reference's
        sizes exactly)."""
        period = len(self.pattern)
        moe = dataclasses.replace(
            self.moe,
            n_experts=min(self.moe.n_experts, 8),
            topk=min(self.moe.topk, 2),
            d_ff=min(self.moe.d_ff, 128) if self.moe.d_ff else 0,
        )
        mla = dataclasses.replace(
            self.mla, kv_lora=64, q_lora=64, rope_head_dim=16,
            nope_head_dim=32, v_head_dim=32,
        )
        mamba = dataclasses.replace(self.mamba, d_state=16, head_dim=16, chunk=32)
        return dataclasses.replace(
            self,
            n_layers=period * 2 if period > 1 else 2,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=32 if self.head_dim else 0,
            d_ff=256,
            first_dense_ff=192 if self.first_dense_ff else 0,
            vocab=512,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_patches=16 if self.n_patches else 0,
            moe=moe,
            mla=mla,
            mamba=mamba,
            dtype=torch.float32,
            param_dtype=torch.float32,
            attn_chunk=64,
            loss_chunk=128,
            window=min(self.window, 64) if self.window else 0,
            scan_layers=True,
        )
