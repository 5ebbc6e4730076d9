"""GNN model family of the port: the SpMM regime (GCN so far)."""
