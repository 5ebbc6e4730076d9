"""Model substrate of the port: DLRM and the GNN family (GCN so far)."""
