"""gemma3-4b [dense]: 34L d2560 8H (GQA kv=4) ff10240 vocab 262144.
5:1 local(1024):global, 128k context. [hf:google/gemma-3-1b-pt family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    layer_pattern=("local",) * 5 + ("global",),  # 34 = 5*6 + 4-layer tail
    window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    mlp_act="gelu",
    source="hf:google/gemma-3-1b-pt (scaled per assignment)",
)
