"""GNN layers and models (torch.nn)."""
