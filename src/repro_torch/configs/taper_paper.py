"""taper_paper — the paper's own technique as a workload: one
extroversion-field refine step over a MusicBrainz-scale graph (10M
vertices, 12 labels) partitioned 512 ways.
"""
from repro_torch.configs.base import TaperSystemConfig

CONFIG = TaperSystemConfig(
    name="taper_paper",
    n_vertices=10_000_000,
    avg_degree=6.0,
    n_labels=12,
    n_trie_nodes=24,
    trie_depth=4,
    k_partitions=512,
)
