"""Model / run configuration dataclasses.

One ``ModelConfig`` describes any of the assigned architectures; the per-arch
files in this package instantiate it with the exact published numbers and a
reduced ``smoke`` variant for CPU tests.  Layer stacking is expressed as a
repeating ``pattern`` of block kinds (run as super-blocks, one per repetition)
plus optional leading ``prefix_kinds`` (e.g. deepseek's first-3 dense layers).
The fields are the reference's, one for one, execution knobs included: a
config means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Block kinds of the model zoo (models/transformer.py runs the attention kinds so far)
#   attn        -- full causal self-attention + MLP
#   attn_local  -- sliding-window self-attention + MLP
#   attn_chunk  -- chunked local attention + MLP (llama4 iRoPE local layers)
#   attn_global -- full attention without RoPE (llama4 iRoPE global layers)
#   mla         -- DeepSeek multi-head latent attention + (dense|moe) MLP
#   rec         -- RG-LRU recurrence block + MLP (recurrentgemma)
#   mlstm       -- xLSTM matrix-memory block
#   slstm       -- xLSTM scalar-memory block
#   enc / dec   -- encoder / decoder (cross-attention) blocks for enc-dec models


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    num_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25
    router: str = "softmax"      # "softmax" | "sigmoid" (deepseek-v3)
    impl: str = "masked"         # "masked" (EP via sharded einsum) | "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    pattern: Tuple[str, ...] = ("attn",)
    prefix_kinds: Tuple[str, ...] = ()   # unscanned leading layers
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0              # sliding window for attn_local
    chunk: int = 0               # chunk size for attn_chunk
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    mlp: str = "swiglu"          # swiglu | geglu | gelu | relu2 | none
    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: Optional[MoEConfig] = None
    dense_d_ff: int = 0          # d_ff of dense prefix layers (deepseek)
    # recurrent (RG-LRU)
    conv_width: int = 4
    lru_width: int = 0           # 0 -> d_model
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    enc_ratio: int = 4           # encoder frames = seq_len // enc_ratio
    # multimodal stub frontend: number of precomputed embedding positions that
    # input_specs() provides (vlm patches / audio frames); 0 = text-only.
    frontend: str = "none"       # none | patch | frame
    # extras
    mtp_heads: int = 0           # deepseek multi-token prediction depth
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long-context policy: can this arch serve 500k-token decode?
    subquadratic: bool = False
    # execution knobs (threaded through by launchers; not architecture identity)
    q_chunk: int = 512           # query-chunked attention block (score memory)
    mlstm_chunk: int = 256       # mLSTM chunkwise-parallel block
    unroll_layers: bool = False  # python-loop layers instead of lax.scan
                                 # (dry-run flops/collective calibration only)
    seq_shard: bool = True       # SP: shard the residual stream's seq dim over
                                 # `model` at scan boundaries (activation memory)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> float:
        """Approximate total parameter count (embeddings + blocks), for 6ND."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def mlp_params(ff: int, kind: str) -> int:
            if ff == 0 or kind == "none":
                return 0
            return d * ff * (3 if kind in ("swiglu", "geglu") else 2)

        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def mla_params() -> int:
            ql, kvl = self.q_lora_rank, self.kv_lora_rank
            qdim = self.qk_nope_dim + self.qk_rope_dim
            return (
                d * ql
                + ql * self.num_heads * qdim
                + d * (kvl + self.qk_rope_dim)
                + kvl * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.num_heads * self.v_head_dim * d
            )

        def block_params(kind: str) -> int:
            if kind in ("attn", "attn_local", "attn_chunk", "attn_global", "enc"):
                base = attn_params() + mlp_params(self.d_ff, self.mlp)
            elif kind == "dec":
                base = 2 * attn_params() + mlp_params(self.d_ff, self.mlp)
            elif kind == "mla":
                base = mla_params()
            elif kind == "rec":
                w = self.lru_width or d
                base = 2 * d * w + 2 * w * w // 1 + self.conv_width * w + mlp_params(self.d_ff, self.mlp)
            elif kind == "mlstm":
                base = 2 * d * 2 * d + 3 * d * (2 * d) // 1  # qkv+gates on 2d inner
            elif kind == "slstm":
                base = 4 * d * d + mlp_params(int(d * 8 // 3), "swiglu")
            else:
                base = 0
            if kind in ("attn", "mla") and self.moe is not None:
                e = self.moe
                base += d * e.num_experts * e.d_ff_expert * 3 // 1 * 0  # counted below
                base += (e.num_experts + e.num_shared) * mlp_params(e.d_ff_expert, self.mlp)
                base += d * e.num_experts  # router
            return base

        if self.family == "audio":
            total = emb
            total += self.enc_layers * block_params("enc")
            total += self.dec_layers * block_params("dec")
            return float(total)
        total = emb
        n_pattern = self.num_layers - len(self.prefix_kinds)
        reps = n_pattern // len(self.pattern)
        for k in self.prefix_kinds:
            if k == "attn_dense_prefix":  # deepseek dense prefix
                total += mla_params() + mlp_params(self.dense_d_ff, self.mlp)
            else:
                total += block_params(k)
        for k in self.pattern:
            total += reps * block_params(k)
        return float(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
