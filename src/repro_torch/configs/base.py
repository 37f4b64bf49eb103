"""Model configuration of the port: the architecture fields its LM serving
path reads, and the input shapes.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
``repro``). Field names, defaults, the derived properties and ``reduced()``
are those of the JAX package, so a test can compare the two configs field
by field. Fields of families the port does not serve yet (MoE, recurrent,
xLSTM, encoder-decoder, VLM patches) and the federation block arrive with
those paths; there is no ``use_pallas``: the port's kernel route is the
tensors' device.

Layer stacking: ``layer_pattern`` is a short tuple of block kinds that
repeats to ``n_layers`` (gemma3's 5 local : 1 global); the remainder
``n_layers % len(layer_pattern)`` is a tail of the pattern's first kinds.

Block kinds served so far:
  'global'  full causal self-attention
  'local'   sliding-window causal self-attention (cfg.window)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 0  # sliding-window size for 'local' blocks
    # --- attention / logits flavor ---
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0  # gemma3 uses a different local theta
    embed_scale: bool = True  # multiply embeddings by sqrt(d_model) (gemma)
    mlp_act: str = "silu"  # silu (llama) | gelu (gemma geglu, whisper)
    tie_embeddings: bool = True
    # --- numerics ---
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    # --- source citation ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_repeats(self) -> int:
        """Full repeats of the pattern; remainder layers (the 'tail', e.g.
        gemma3-4b's 34 = 5x6 + 4) follow them."""
        return self.n_layers // len(self.layer_pattern)

    @property
    def tail_len(self) -> int:
        return self.n_layers % len(self.layer_pattern)

    def reduced(self, n_layers: int = 2, d_model: int = 256) -> "ModelConfig":
        """Smoke-test variant: same family, laptop-sized (<=2 layers,
        d_model<=512). Takes ``layer_pattern[:n_layers]``, so gemma3's
        reduced form has no global layer."""
        pat = self.layer_pattern[: max(1, n_layers)]
        n_layers = len(pat) * max(1, n_layers // len(pat)) if n_layers >= len(pat) else len(pat)
        heads = max(2, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            layer_pattern=pat,
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=2 * d_model if self.d_ff else 0,
            vocab_size=512,
            window=min(self.window, 16) if self.window else 0,
            attn_q_chunk=32,
            attn_kv_chunk=32,
            param_dtype="float32",
            activation_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
