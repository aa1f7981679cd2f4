"""Static and device-rule checks of the PyTorch port.

- No module of ``cugraph_gnn_tpu_torch/``, nor ``chip_smoke.py``, imports
  JAX, flax, optax or the JAX package.
- CPU tensors take the plain versions: the kernels' launch counters stay 0,
  on the sampled and the full-batch training paths.
- Entry points given no device run on the card, and raise without one.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import cugraph_gnn_tpu_torch
from cugraph_gnn_tpu_torch import train as T
from cugraph_gnn_tpu_torch import train_full as TF
from cugraph_gnn_tpu_torch.models.convert import (
    gat_from_flax,
    gcn_from_flax,
    graphsage_from_flax,
)
from cugraph_gnn_tpu_torch.models.zoo import GAT, GCN, GraphSAGE
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as attn_grad
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows
from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import fused_uniform_sample
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import slab_attention_spmm_mh
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    build_slab_graph,
    slab_spmm_band,
)
from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import (
    build_padded_blocks,
    csr_spmm,
)
from cugraph_gnn_tpu_torch.ops.spmm import EllBuckets
from cugraph_gnn_tpu_torch.ops.sample import uniform_sample
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import (
    multihop_uniform,
    multihop_uniform_batched,
)

PKG = pathlib.Path(cugraph_gnn_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cugraph_gnn_tpu"}
SOURCES = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PKG.parent)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_cpu_tensors_leave_launch_counters_at_zero():
    gather_rows.launches = 0
    fused_uniform_sample.launches = 0
    g = T.make_synthetic_products(0, "cpu", num_nodes=60, feat_dim=8, classes=3)
    model = GraphSAGE(8, 16, 3, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses, edges = T.train_block(model, opt, g, torch.Generator().manual_seed(0),
                                  reps=2, batch_size=8, fanouts=(3, 2))
    assert len(losses) == 2 and all(torch.isfinite(l) for l in losses)
    assert int(edges) > 0
    assert gather_rows.launches == 0
    assert fused_uniform_sample.launches == 0


ATTN_COUNTERS = (slab_attention_spmm_mh, attn_grad.onepass_bwd,
                 attn_grad.slab_attention_bwd, attn_grad.slab_attention_bwd_mh)


@pytest.mark.parametrize("model_cls,block_rows", [(GraphSAGE, 128), (GCN, 128),
                                                  (GAT, 128), (GAT, 512)])
def test_cpu_full_batch_leaves_launch_counters_at_zero(model_cls, block_rows):
    counters = (slab_spmm_band, csr_spmm) + ATTN_COUNTERS
    for fn in counters:
        fn.launches = 0
    g = TF.make_synthetic_banded(0, "cpu", num_nodes=300, deg=4, band=20,
                                 feat_dim=8, classes=3)
    fbg = FullBatchGraph.from_coo(g.src, g.dst, g.num_nodes, reorder="none",
                                  block_rows=block_rows, device="cpu")
    assert fbg.slab.fb_src.shape[0] > 0 and fbg.use_slab
    model = model_cls(8, 16, 3, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
    loss = TF.full_batch_step(model, opt, g.feats, fbg, g.labels)
    assert torch.isfinite(loss)
    assert all(fn.launches == 0 for fn in counters)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    table = torch.empty((4, 8), device="meta")
    ids = torch.empty((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gather_rows(table, ids)
    ip = torch.empty((5,), dtype=torch.int32, device="meta")
    u = torch.empty((3, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_uniform_sample(ip, ip, ids, u, 2)
    indptr = np.array([0, 1, 2, 2], np.int64)
    indices = np.array([1, 2], np.int32)
    slab = build_slab_graph(indptr, indices, block_rows=128, device="cpu").to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        slab_spmm_band(slab, torch.empty((3, 8), device="meta"))
    padded = build_padded_blocks(indptr, indices, device="cpu")
    padded = padded._replace(**{k: v.to("meta") for k, v in padded._asdict().items()
                                if isinstance(v, torch.Tensor)})
    with pytest.raises(ValueError, match="no kernel"):
        csr_spmm(padded, torch.empty((3, 8), device="meta"))
    for r_blk in (128, 512):
        pair = attn_grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk,
                                                   device="cpu").to("meta")
        x3, s2 = torch.empty((3, 2, 4), device="meta"), torch.empty((3, 2), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            slab_attention_spmm_mh(pair.fwd, x3, s2, s2)
        with pytest.raises(ValueError, match="no kernel"):
            attn_grad.slab_attention_bwd_mh(pair, x3, s2, s2, s2, s2, s2, x3)
        x1, s1 = torch.empty((3, 4), device="meta"), torch.empty((3,), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            attn_grad.slab_attention_bwd(pair, x1, s1, s1, s1, s1, s1, x1)


_TREE = {"params": {"conv_0": {
    "lin_self": {"kernel": np.zeros((4, 3), np.float32),
                 "bias": np.zeros(3, np.float32)},
    "lin_neigh": {"kernel": np.zeros((4, 3), np.float32)}}}}
_GCN_TREE = {"params": {"conv_0": {"lin": {"kernel": np.zeros((4, 3), np.float32),
                                            "bias": np.zeros(3, np.float32)}}}}
_GAT_TREE = {"params": {"conv_0": {"lin": {"kernel": np.zeros((4, 3), np.float32)},
                                   "att_src": np.zeros((1, 1, 3), np.float32),
                                   "att_dst": np.zeros((1, 1, 3), np.float32),
                                   "bias": np.zeros(3, np.float32)}}}
_INDPTR = np.array([0, 1, 2], np.int32)
_INDICES = np.array([1, 0], np.int32)
ENTRY_POINTS = {
    "uniform_sample": lambda: uniform_sample(_INDPTR, _INDICES, [0, 1], 2),
    "multihop_uniform_batched": lambda: multihop_uniform_batched(
        _INDPTR, _INDICES, [[0, 1]], (2,)),
    "multihop_uniform": lambda: multihop_uniform(
        _INDPTR, _INDICES, [0, 1], (2,), dedup=False),
    "make_synthetic_products": lambda: T.make_synthetic_products(0, num_nodes=10),
    "GraphSAGE": lambda: GraphSAGE(4),
    "graphsage_from_flax": lambda: graphsage_from_flax(_TREE),
    "GCN": lambda: GCN(4),
    "gcn_from_flax": lambda: gcn_from_flax(_GCN_TREE),
    "GAT": lambda: GAT(4),
    "gat_from_flax": lambda: gat_from_flax(_GAT_TREE),
    "build_attention_slab_pair": lambda: attn_grad.build_attention_slab_pair(
        _INDPTR, _INDICES),
    "FullBatchGraph.from_coo": lambda: FullBatchGraph.from_coo(
        _INDICES, [0, 1], 2, reorder="none"),
    "make_synthetic_banded": lambda: TF.make_synthetic_banded(0, num_nodes=10),
    "build_slab_graph": lambda: build_slab_graph(_INDPTR, _INDICES),
    "build_padded_blocks": lambda: build_padded_blocks(_INDPTR, _INDICES),
    "EllBuckets": lambda: EllBuckets(_INDPTR, _INDICES),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
