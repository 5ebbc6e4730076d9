"""Model substrate of the port: DLRM, the GNN family (GCN so far) and the
dense LM transformer (``layers``, ``transformer``)."""
