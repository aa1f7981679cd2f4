"""Load flax parameter trees of the JAX package's models into the port's.

A flax ``Dense`` kernel has shape (in, out); a torch ``Linear.weight`` has
shape (out, in), so kernels are transposed on the way in.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch.models.zoo import GAT, GCN, GraphSAGE


def graphsage_from_flax(params, model: Optional[GraphSAGE] = None, *,
                        dtype: Optional[torch.dtype] = None,
                        device=None) -> GraphSAGE:
    """A GraphSAGE holding the weights of the flax tree ``params``
    (``{'params': {'conv_<i>': {'lin_self': {'kernel', 'bias'},
    'lin_neigh': {'kernel'}}}}``, leaves as numpy or array-likes).

    With ``model``, the weights are copied into it and it is returned;
    otherwise a new model is built with ``dtype`` on ``device`` (default:
    the card).
    """
    convs = _convs(params)
    if model is None:
        kernels = [np.asarray(c["lin_self"]["kernel"]) for c in convs]
        model = GraphSAGE(kernels[0].shape[0], kernels[0].shape[1],
                          kernels[-1].shape[1], num_layers=len(convs),
                          dtype=dtype, device=device)
    _check_depth(model, convs)
    with torch.no_grad():
        for conv, p in zip(model.convs, convs):
            _copy(conv.lin_self.weight, np.asarray(p["lin_self"]["kernel"]).T)
            _copy(conv.lin_self.bias, np.asarray(p["lin_self"]["bias"]))
            _copy(conv.lin_neigh.weight, np.asarray(p["lin_neigh"]["kernel"]).T)
    return model


def gcn_from_flax(params, model: Optional[GCN] = None, *,
                  dtype: Optional[torch.dtype] = None, device=None) -> GCN:
    """A GCN holding the weights of the flax tree ``params``
    (``{'params': {'conv_<i>': {'lin': {'kernel', 'bias'}}}}``), copied into
    ``model`` when given, else into a new one built with ``dtype`` on
    ``device`` (default: the card)."""
    convs = _convs(params)
    if model is None:
        kernels = [np.asarray(c["lin"]["kernel"]) for c in convs]
        model = GCN(kernels[0].shape[0], kernels[0].shape[1],
                    kernels[-1].shape[1], num_layers=len(convs),
                    dtype=dtype, device=device)
    _check_depth(model, convs)
    with torch.no_grad():
        for conv, p in zip(model.convs, convs):
            _copy(conv.lin.weight, np.asarray(p["lin"]["kernel"]).T)
            _copy(conv.lin.bias, np.asarray(p["lin"]["bias"]))
    return model


def gat_from_flax(params, model: Optional[GAT] = None, *, device=None) -> GAT:
    """A GAT holding the weights of the flax tree ``params``
    (``{'params': {'conv_<i>': {'lin': {'kernel'}, 'att_src', 'att_dst',
    'bias'}}}``), copied into ``model`` when given, else into a new one on
    ``device`` (default: the card) whose widths and heads are read from the
    tree."""
    convs = _convs(params)
    if model is None:
        first, last = convs[0], convs[-1]
        in_features = np.asarray(first["lin"]["kernel"]).shape[0]
        _, heads, f = np.asarray(first["att_src"]).shape
        kw = dict(hidden_features=heads * f, heads=heads) if len(convs) > 1 else {}
        model = GAT(in_features, out_features=np.asarray(last["att_src"]).shape[2],
                    num_layers=len(convs), device=device, **kw)
    _check_depth(model, convs)
    with torch.no_grad():
        for conv, p in zip(model.convs, convs):
            _copy(conv.lin.weight, np.asarray(p["lin"]["kernel"]).T)
            _copy(conv.att_src, np.asarray(p["att_src"]))
            _copy(conv.att_dst, np.asarray(p["att_dst"]))
            _copy(conv.bias, np.asarray(p["bias"]))
    return model


def _convs(params):
    tree = params["params"]
    return [tree[f"conv_{i}"] for i in range(len(tree))]


def _check_depth(model, convs) -> None:
    if len(model.convs) != len(convs):
        raise ValueError(f"flax tree has {len(convs)} convs, model has "
                         f"{len(model.convs)}")


def _copy(dst: torch.Tensor, src: np.ndarray) -> None:
    if tuple(dst.shape) != src.shape:
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src)))
