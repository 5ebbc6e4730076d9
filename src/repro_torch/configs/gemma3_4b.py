"""gemma3-4b — dense LM, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.  Local layers use a
1024-token sliding window; every 6th layer is global.  The hybrid
local:global stack gives it the sub-quadratic path required to run the
``long_500k`` cell.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma3-4b",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab=262144,
    sliding_window=1024,
    global_every=6,           # 5 local : 1 global
    qk_norm=True,
    rope_theta=1_000_000.0,
    supports_long_context=True,
)
