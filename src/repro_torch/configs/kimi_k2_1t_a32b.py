"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384e top-8
plus 1 shared expert.
"""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,
    vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert_ff=2048, n_shared=1),
    rope_theta=50000.0,
)
