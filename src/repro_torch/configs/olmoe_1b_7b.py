"""olmoe-1b-7b — 64-expert top-8 MoE LM [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert_ff=1024),
    qk_norm=True,  # OLMoE uses QK-norm
    rope_theta=10000.0,
)
