"""equiformer-v2 — equivariant graph attention via eSCN convolutions
[arXiv:2306.12059; unverified].

n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8, SO(2)-eSCN equivariance.
"""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="equiformer-v2",
    kind="equiformer_v2",
    n_layers=12,
    d_hidden=128,
    l_max=6,
    m_max=2,
    n_heads=8,
    n_rbf=8,
    cutoff=5.0,
    n_classes=1,   # energy regression
)
