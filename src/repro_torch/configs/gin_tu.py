"""gin-tu — Graph Isomorphism Network [arXiv:1810.00826; paper].

n_layers=5 d_hidden=64 aggregator=sum eps=learnable (TU graph classification).
"""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu",
    kind="gin",
    n_layers=5,
    d_hidden=64,
    aggregator="sum",
    eps_learnable=True,
    n_classes=2,
)
