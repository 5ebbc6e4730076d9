"""GNN model family of the port: the SpMM regime (GCN, GIN), the CG
tensor product (NequIP) and SO(2)/eSCN (EquiformerV2), and the
partition-aware distributed GCN."""
