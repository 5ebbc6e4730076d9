"""dlrm-rm2 — deep learning recommendation model [arXiv:1906.00091; paper].

n_dense=13 n_sparse=26 embed_dim=64 bot 13-512-256-64 top 512-512-256-1
dot interaction.  Table sizes follow the Criteo-Kaggle cardinalities
(33,762,577 rows in all).
"""
from repro_torch.configs.base import DLRMConfig

# Criteo Kaggle per-field cardinalities (C1..C26)
CRITEO_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

CONFIG = DLRMConfig(
    name="dlrm-rm2",
    n_dense=13,
    n_sparse=26,
    embed_dim=64,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    interaction="dot",
    vocab_sizes=CRITEO_VOCABS,
)
