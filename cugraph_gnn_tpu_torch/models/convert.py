"""Load flax parameter trees of the JAX package's models into the port's.

A flax ``Dense`` kernel has shape (in, out); a torch ``Linear.weight`` has
shape (out, in), so kernels are transposed on the way in.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cugraph_gnn_tpu_torch.models.zoo import GAT, GCN, GIN, RGCN, GraphSAGE


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


def gin_from_flax(params, model: Optional[GIN] = None, *,
                  dtype: Optional[torch.dtype] = None, device=None) -> GIN:
    """A GIN holding the weights of the flax tree ``params``
    (``{'params': {'conv_<i>': {'mlp_1': {'kernel', 'bias'}, 'mlp_2':
    {'kernel', 'bias'}, ['eps']}}}``), copied into ``model`` when given (any
    model of ``GINConv``s; a tree with ``eps`` needs convs built with
    ``train_eps``), else into a new one built with ``dtype`` on ``device``
    (default: the card)."""
    convs = _convs(params)
    if model is None:
        k1 = [np.asarray(c["mlp_1"]["kernel"]) for c in convs]
        k2 = np.asarray(convs[-1]["mlp_2"]["kernel"])
        model = GIN(k1[0].shape[0], k1[0].shape[1], k2.shape[1], num_layers=len(convs),
                    dtype=dtype, device=device)
    _check_depth(model, convs)
    with torch.no_grad():
        for conv, p in zip(model.convs, convs):
            for name in ("mlp_1", "mlp_2"):
                lin = getattr(conv, name)
                _copy(lin.weight, np.asarray(p[name]["kernel"]).T)
                _copy(lin.bias, np.asarray(p[name]["bias"]))
            if ("eps" in p) != (conv.eps is not None):
                raise ValueError("the flax tree and the model disagree on a trainable eps")
            if conv.eps is not None:
                _copy(conv.eps, np.asarray(p["eps"]))
    return model


def _rel_index(name: str) -> int:
    return int(name[len("lin_rel_"):])


def rgcn_from_flax(params, model: Optional[RGCN] = None, *, device=None) -> RGCN:
    """An RGCN holding the weights of the flax tree ``params``
    (``{'params': {'conv_<i>': {'lin_root': {'kernel', 'bias'},
    'lin_rel_<r>': {'kernel'}}}}``), copied into ``model`` when given (any
    model of ``RGCNConv``s), else into a new one on ``device`` (default: the
    card) whose widths and relation count are read from the tree.

    Flax creates a relation's parameters only if its block was present when
    the model was initialised (the last layer of a typed batch sees only
    the seed type's relations); such a relation's port weights are zeroed,
    so that it adds nothing, as it adds nothing in JAX.
    """
    convs = _convs(params)
    if model is None:
        kernels = [np.asarray(c["lin_root"]["kernel"]) for c in convs]
        rels = 1 + max(_rel_index(n) for c in convs for n in c if n.startswith("lin_rel_"))
        model = RGCN(kernels[0].shape[0], num_relations=rels,
                     hidden_features=kernels[0].shape[1],
                     out_features=kernels[-1].shape[1], num_layers=len(convs),
                     device=device)
    _check_depth(model, convs)
    with torch.no_grad():
        for conv, p in zip(model.convs, convs):
            _copy_rgcn_conv(conv, p)
    return model


def _copy_rgcn_conv(conv, p) -> None:
    """One flax RGCNConv's tree into ``conv`` (under ``torch.no_grad``);
    relations the tree lacks are zeroed."""
    rels = {_rel_index(n): n for n in p if n.startswith("lin_rel_")}
    if max(rels, default=-1) >= len(conv.lin_rel):
        raise ValueError(f"flax tree has relation {max(rels)}, model has "
                         f"{len(conv.lin_rel)} relations")
    _copy(conv.lin_root.weight, np.asarray(p["lin_root"]["kernel"]).T)
    if ("bias" in p["lin_root"]) != (conv.lin_root.bias is not None):
        raise ValueError("the flax tree and the model disagree on lin_root's bias")
    if conv.lin_root.bias is not None:
        _copy(conv.lin_root.bias, np.asarray(p["lin_root"]["bias"]))
    for r, lin in enumerate(conv.lin_rel):
        if r in rels:
            _copy(lin.weight, np.asarray(p[rels[r]]["kernel"]).T)
        else:
            lin.weight.zero_()


_FROM_FLAX = {"sage": graphsage_from_flax, "gcn": gcn_from_flax, "gat": gat_from_flax,
              "gin": gin_from_flax, "rgcn": rgcn_from_flax}


def typed_sage_from_flax(params, ranges, model=None, *, device=None):
    """A ``train_hetero_dist.TypedSAGE`` holding the weights of the example's
    flax tree (``{'params': {'in_<type>': {'kernel', 'bias'}, 'out':
    {'kernel', 'bias'}}}``); ``ranges``: node type -> (offset, count).
    Copied into ``model`` when given, else into a new one on ``device``
    (default: the card)."""
    from cugraph_gnn_tpu_torch.train_hetero_dist import TypedSAGE

    p = params["params"] if "params" in params else params
    ins = {k[3:]: v for k, v in p.items() if k.startswith("in_")}
    out_k = np.asarray(p["out"]["kernel"])
    if model is None:
        model = TypedSAGE({nt: np.asarray(v["kernel"]).shape[0] for nt, v in ins.items()},
                          ranges, hidden=out_k.shape[0], classes=out_k.shape[1],
                          device=device)
    if set(ins) != set(model.inputs):
        raise ValueError(f"the tree projects {sorted(ins)}, the model {sorted(model.inputs)}")
    with torch.no_grad():
        for nt, v in ins.items():
            _copy(model.inputs[nt].weight, np.asarray(v["kernel"]).T)
            _copy(model.inputs[nt].bias, np.asarray(v["bias"]))
        _copy(model.out.weight, out_k.T)
        _copy(model.out.bias, np.asarray(p["out"]["bias"]))
    return model


def fraud_encoder_from_flax(params, model_type: str, model=None, *, device=None):
    """An ``examples/fraud_detection.py`` ``Encoder`` holding the weights of
    the script's flax tree (``{'params': {'enc': <the builder's model_type
    tree>, 'lin': {'kernel', 'bias'}}}``): ``enc`` through
    :func:`model_from_flax`, ``lin`` the 2-logit head.  Copied into
    ``model`` when given, else into a new one on ``device`` (default: the
    card) whose widths are read from the tree."""
    from cugraph_gnn_tpu_torch.examples.fraud_detection import Encoder

    p = params["params"] if "params" in params else params
    enc = {"params": p["enc"]}
    lin = np.asarray(p["lin"]["kernel"])
    if model is None:
        model = Encoder(model_from_flax(model_type, enc, device=device), lin.shape[0],
                        device=device)
    else:
        model_from_flax(model_type, enc, model.enc)
    with torch.no_grad():
        _copy(model.lin.weight, lin.T)
        _copy(model.lin.bias, np.asarray(p["lin"]["bias"]))
    return model


def kg_encoder_from_flax(params, model=None, *, device=None):
    """An ``examples/kg_link_class.py`` ``KGEncoder`` holding the weights of
    the script's flax tree (``{'params': {'node_emb': (N, hidden),
    'conv_<i>': <an RGCNConv tree>}}``), copied into ``model`` when given,
    else into a new one on ``device`` (default: the card) whose sizes are
    read from the tree."""
    from cugraph_gnn_tpu_torch.examples.kg_link_class import KGEncoder

    p = params["params"] if "params" in params else params
    emb = np.asarray(p["node_emb"])
    convs = [p[f"conv_{i}"] for i in range(len(p) - 1)]
    if model is None:
        rels = 1 + max(_rel_index(n) for c in convs for n in c if n.startswith("lin_rel_"))
        model = KGEncoder(emb.shape[0], emb.shape[1], rels, len(convs), device=device)
    _check_depth(model, convs)
    with torch.no_grad():
        _copy(model.node_emb, emb)
        for conv, c in zip(model.convs, convs):
            _copy_rgcn_conv(conv, c)
    return model


def model_from_flax(model_type: str, params, model=None, *, dtype=None, device=None):
    """The weights of a flax tree of the JAX builder's ``model_type``
    (sage / gcn / gat / gin / rgcn) in a port model (``model``, or a new one
    on ``device``, default the card; GAT and RGCN take no ``dtype``)."""
    kind = model_type.lower()
    if kind not in _FROM_FLAX:
        raise ValueError(f"no flax conversion for model_type {model_type!r}; "
                         f"expected one of {tuple(_FROM_FLAX)}")
    kw = {} if kind in ("gat", "rgcn") else {"dtype": dtype}
    return _FROM_FLAX[kind](params, model, device=device, **kw)


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
