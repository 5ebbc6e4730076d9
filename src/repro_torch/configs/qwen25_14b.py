"""qwen2.5-14b — dense LM with GQA and QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
)
