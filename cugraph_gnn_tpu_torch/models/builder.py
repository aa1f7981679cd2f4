"""Options-driven GNN model factory.

Counterpart of ``cugraph_gnn_tpu/models/builder.py``: ``create_gnn_model``
builds a zoo model from the reference's option vocabulary (sage / gcn / gat /
gin / rgcn; the last layer emits ``class_count`` logits; hidden layers at
``hidden_feat_dim``, GAT splitting it over ``num_heads``, RGCN over
``num_relations``).  A torch module needs its input width when it is built,
so both functions take ``in_feat_dim`` (flax infers it at init).
"""

from __future__ import annotations

from typing import Optional

import torch

from cugraph_gnn_tpu_torch.models.zoo import GAT, GCN, GIN, RGCN, GraphSAGE

MODEL_TYPES = ("sage", "gcn", "gat", "gin", "rgcn")


def create_gnn_model(model_type: str, *, in_feat_dim: int, class_count: int,
                     hidden_feat_dim: int = 256, num_layers: int = 2, num_heads: int = 4,
                     num_relations: int = 2, dropout: float = 0.0,
                     dtype: Optional[torch.dtype] = None, device=None):
    """A zoo model on ``device`` (default: the card).  GAT and RGCN compute in
    the promotion of their input's and parameters' dtypes, as the JAX
    builder's do, and ignore ``dtype`` (RGCN also ``dropout``, as JAX's)."""
    kind = model_type.lower()
    if kind not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}; expected one of {MODEL_TYPES}")
    if kind == "rgcn":
        return RGCN(in_feat_dim, num_relations=num_relations,
                    hidden_features=hidden_feat_dim, out_features=class_count,
                    num_layers=num_layers, device=device)
    kw = dict(hidden_features=hidden_feat_dim, out_features=class_count,
              num_layers=num_layers, dropout=dropout, device=device)
    if kind == "gat":
        return GAT(in_feat_dim, heads=num_heads, **kw)
    cls = {"sage": GraphSAGE, "gcn": GCN, "gin": GIN}[kind]
    return cls(in_feat_dim, dtype=dtype, **kw)


def model_from_args(args, class_count: int, in_feat_dim: int, device=None):
    """``create_gnn_model`` from the shared flag groups (``args.model``,
    ``hidden_dim``, ``num_layers``, ``heads``)."""
    return create_gnn_model(args.model, in_feat_dim=in_feat_dim, class_count=class_count,
                            hidden_feat_dim=args.hidden_dim, num_layers=args.num_layers,
                            num_heads=args.heads, device=device)
