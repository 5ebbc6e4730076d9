"""qwen3-4b — dense LM with qk_norm and GQA [hf:Qwen/Qwen3-8B; hf].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
