"""gcn-cora — 2-layer GCN [arXiv:1609.02907; paper].

n_layers=2 d_hidden=16 aggregator=mean norm=sym (Cora: 2708 nodes, 7 classes).
"""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora",
    kind="gcn",
    n_layers=2,
    d_hidden=16,
    aggregator="mean",
    norm="sym",
    n_classes=7,
)
