"""nequip — O(3)-equivariant interatomic potential [arXiv:2101.03164; paper].

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3) tensor-product messages.
"""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="nequip",
    kind="nequip",
    n_layers=5,
    d_hidden=32,
    l_max=2,
    n_rbf=8,
    cutoff=5.0,
    n_classes=1,   # energy regression
)
