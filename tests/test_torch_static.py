"""Static and device-rule checks of the PyTorch port.

- No module of ``cugraph_gnn_tpu_torch/``, nor ``chip_smoke.py``, imports
  JAX, flax, optax or the JAX package.
- CPU tensors take the plain versions: the kernels' launch counters stay 0,
  on the sampled and the full-batch training paths and the embeddings.
- Entry points given no device run on the card, and raise without one.
- The link path and the weighted, temporal and disjoint loaders on the CPU
  launch no kernel; nor do the hetero paths (the typed R-GCN block, the hetero
  loaders, the typed link batch, full-batch R-GCN).
- A gloo mesh refuses the card and the row-sharded step, at one rank on the
  CPU, launches no kernel.  The distributed graph, sampler and loaders take
  the card's mesh when given none, and raise without a card; so do the
  hetero ones, the hierarchical mesh and the hetero dist trainer's pieces.
- The hetero dist path (the typed loader, R-GCN's step, the typed link
  batch) and the hierarchical gather, at one gloo rank on the CPU, launch no
  kernel.
- Every name that a subpackage exports is the port's own object; the doctor,
  the meter, the example scripts and the checkpoint restores raise without
  a card.  The example modules import scikit-learn only inside the
  functions that fit a downstream model (fraud detection, xgb).
"""

import ast
import importlib
import os
import pathlib
import types

import numpy as np
import pytest
import torch

import cugraph_gnn_tpu_torch
from cugraph_gnn_tpu_torch import train as T
from cugraph_gnn_tpu_torch import train_full as TF
from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as attn_fwd
from cugraph_gnn_tpu_torch.parallel.mesh import create_store_mesh
from cugraph_gnn_tpu_torch.utils import distributed as D
from cugraph_gnn_tpu_torch.models.convert import (
    gat_from_flax,
    gcn_from_flax,
    graphsage_from_flax,
)
from cugraph_gnn_tpu_torch.data import FeatureStore
from cugraph_gnn_tpu_torch.embedding import CachedHostEmbedding, HostManagedCache
from cugraph_gnn_tpu_torch.embedding.cache import DeviceLFUCache
from cugraph_gnn_tpu_torch.embedding.convert import embedding_from_jax_arrays
from cugraph_gnn_tpu_torch.models.zoo import GAT, GCN, GIN, GraphSAGE
from cugraph_gnn_tpu_torch.data import GraphStore
from cugraph_gnn_tpu_torch.graph_structure import GraphStructure
from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader
from cugraph_gnn_tpu_torch.models.builder import create_gnn_model
from cugraph_gnn_tpu_torch.models.convert import gin_from_flax
from cugraph_gnn_tpu_torch.sampler import negative as NEG
from cugraph_gnn_tpu_torch.train_link import link_step
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as attn_grad
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows
from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import fused_uniform_sample
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import slab_attention_spmm_mh
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    build_slab_graph,
    slab_spmm,
    slab_spmm_band,
    slab_spmm_band_shard,
)
from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import (
    build_padded_blocks,
    csr_spmm,
)
from cugraph_gnn_tpu_torch.ops.spmm import EllBuckets
from cugraph_gnn_tpu_torch.ops.sample import (
    masked_uniform_sample,
    uniform_sample,
    weighted_sample,
)
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.sampler.heuristics import device_memory_bytes
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import (
    NeighborSampler,
    multihop_uniform,
    multihop_uniform_batched,
)
from cugraph_gnn_tpu_torch import train_hetero as TH
from cugraph_gnn_tpu_torch.models.convert import rgcn_from_flax
from cugraph_gnn_tpu_torch.models.zoo import RGCN
from cugraph_gnn_tpu_torch.ops.full_batch import RelationalFullBatch
from cugraph_gnn_tpu_torch.sampler.hetero import hetero_multihop, hetero_multihop_batched
from cugraph_gnn_tpu_torch.loader import DistLinkNeighborLoader, DistNeighborLoader, auto_mesh
from cugraph_gnn_tpu_torch.sampler.dist_sampler import DistGraph, DistNeighborSampler
from cugraph_gnn_tpu_torch import train_hetero_dist as THD
from cugraph_gnn_tpu_torch import train_dist as TD
from cugraph_gnn_tpu_torch.models.convert import typed_sage_from_flax
from cugraph_gnn_tpu_torch.parallel.mesh import create_hierarchical_mesh
from cugraph_gnn_tpu_torch.sampler.hetero_dist import HeteroDistGraph
from cugraph_gnn_tpu_torch.store.hierarchical import HierarchicalDistArray
from cugraph_gnn_tpu_torch import doctor
from cugraph_gnn_tpu_torch.examples import node_classification, ogbn_train
from cugraph_gnn_tpu_torch.examples import (
    cached_embedding_training,
    dist_full_batch_training,
    fraud_detection,
    full_batch_training,
    hetero_dist_training,
    hetero_link_pred,
    kg_link_class,
    link_prediction,
    movielens_rec,
    multichip_training,
    rgcn_hetero,
    xgb_downstream,
)
from cugraph_gnn_tpu_torch.utils import orbax_ckpt, profiling

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


def test_cpu_embeddings_leave_launch_counters_at_zero():
    """A CachedHostEmbedding step and a host-located store's gather on the
    CPU take the plain versions of the row gather and the dedup sum."""
    gather_rows.launches = 0
    csr_spmm.launches = 0
    rng = np.random.default_rng(0)
    emb = CachedHostEmbedding(rng.standard_normal((50, 4)).astype(np.float32),
                              optimizer="adagrad", capacity=16, device="cpu")
    ids = torch.as_tensor(rng.integers(-1, 50, 30))
    rows = emb.gather(ids)
    emb.add_gradients(ids, torch.ones_like(rows))
    emb.apply_gradients(0.1)
    emb.flush()
    fs = FeatureStore(device="cpu")
    fs.put_tensor(rng.standard_normal((50, 4)).astype(np.float32), "", "x", location="host")
    assert fs.get_tensor("", "x", ids=ids).shape == (30, 4)
    assert gather_rows.launches == 0 and csr_spmm.launches == 0


def test_cpu_link_path_leaves_launch_counters_at_zero():
    """The link loader (binary, with rejection) and a GIN ``link_step`` on the
    CPU take the plain versions of the sampler and the row gather."""
    gather_rows.launches = 0
    fused_uniform_sample.launches = 0
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    gs = GraphStore(device="cpu")
    gs.put_edge_index((src, dst), ("n", "to", "n"), num_nodes=(40, 40))
    fs = FeatureStore(device="cpu")
    fs["x"] = rng.standard_normal((40, 8)).astype(np.float32)
    loader = LinkNeighborLoader((fs, gs), [3, 2], np.stack([src[:30], dst[:30]]),
                                neg_sampling="binary", batch_size=8, reject_true_edges=True)
    model = GIN(8, 16, 8, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = [link_step(model, opt, b) for b in loader]
    assert len(losses) == 4 and all(torch.isfinite(l) for l in losses)
    assert gather_rows.launches == 0 and fused_uniform_sample.launches == 0


@pytest.mark.parametrize("kw", [dict(weight_attr="w"), dict(time_attr="t"),
                                dict(disjoint=True), dict(weight_attr="w", disjoint=True)],
                         ids=["weighted", "temporal", "disjoint", "weighted_disjoint"])
def test_cpu_sampling_variants_leave_launch_counters_at_zero(kw):
    """Weighted, temporal and disjoint loader batches and a model step over
    them on the CPU take the plain versions of the sampler and the row
    gather."""
    gather_rows.launches = 0
    fused_uniform_sample.launches = 0
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    gs = GraphStore(device="cpu")
    gs.put_edge_index((src, dst), ("n", "to", "n"), num_nodes=(40, 40))
    fs = FeatureStore(device="cpu")
    fs["x"] = rng.standard_normal((40, 8)).astype(np.float32)
    fs["y"] = rng.integers(0, 3, 40)
    fs["w"] = rng.uniform(0, 1, 300).astype(np.float32)
    fs["t"] = rng.integers(0, 9, 300)
    if "time_attr" in kw:
        kw = dict(kw, input_time=rng.integers(0, 9, 40))
    loader = NeighborLoader((fs, gs), [3, 2], batch_size=8, **kw)
    model = GraphSAGE(8, 16, 3, device="cpu")
    for batch in loader:
        sample, x = batch.sample, batch.x
        if kw.get("disjoint"):
            sample, x = sample.flat(), x.reshape(-1, 8)
        logits = model(x, sample)
        assert logits.shape == (8, 3) and bool(torch.isfinite(logits).all())
    assert gather_rows.launches == 0 and fused_uniform_sample.launches == 0


SMALL_MAG = {"paper": 60, "author": 40, "field": 10}


@pytest.mark.parametrize("path", ["block", "loader_typed", "loader_dedup", "link", "full"])
def test_cpu_hetero_paths_leave_launch_counters_at_zero(path):
    """The typed R-GCN block, the hetero loaders, the typed link batch and
    full-batch R-GCN on the CPU take the plain versions of the sampler, the
    row gather and the slab SpMM."""
    counters = (gather_rows, fused_uniform_sample, slab_spmm, slab_spmm_band, csr_spmm)
    for fn in counters:
        fn.launches = 0
    g = TH.make_synthetic_mag(0, "cpu", num_nodes=SMALL_MAG, feat_dim=8, classes=3, deg_cap=20)
    names = list(TH.ETYPES)
    model = RGCN(8, num_relations=3, hidden_features=16, out_features=3, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=TH.LR)
    if path == "block":
        losses, edges = TH.train_block(model, opt, g, torch.Generator().manual_seed(0),
                                       reps=2, batch_size=8)
        assert len(losses) == 2 and all(torch.isfinite(l) for l in losses)
        assert int(edges) > 0
    elif path.startswith("loader"):
        fs, gs = TH.mag_stores(g, "cpu")
        names = [n for n in map("__".join, gs.finalize().etypes)]
        loader = NeighborLoader((fs, gs), TH.FANOUTS, input_nodes=("paper", np.arange(20)),
                                batch_size=8, shuffle=True, dedup=path == "loader_dedup")
        for batch in loader:
            assert sorted(batch.x) == ["author", "field", "paper"]
            assert torch.isfinite(TH.loader_step(model, opt, batch, names))
    elif path == "link":
        fs, gs = TH.mag_stores(g, "cpu")
        names = [n for n in map("__".join, gs.finalize().etypes)]
        src, dst = gs.get_edge_index(("author", "writes", "paper"))
        loader = LinkNeighborLoader((fs, gs), [3, 2], (("author", "writes", "paper"),
                                                       np.stack([src[:20], dst[:20]])),
                                    neg_sampling="binary", batch_size=8)
        enc = TH.RGCNEncoder(model, names)
        assert all(torch.isfinite(link_step(enc, opt, b)) for b in loader)
    else:
        fb = TF.make_synthetic_banded(0, "cpu", num_nodes=300, deg=4, band=20, feat_dim=8,
                                      classes=3)
        rfb = RelationalFullBatch(fb.src, fb.dst, (fb.src + fb.dst) % 2, 2, fb.num_nodes,
                                  reorder="none", block_rows=128, device="cpu")
        model = RGCN(8, num_relations=2, hidden_features=16, out_features=3, device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
        assert torch.isfinite(TF.full_batch_step(model, opt, fb.feats, rfb, fb.labels))
    assert all(fn.launches == 0 for fn in counters)


ATTN_COUNTERS = (slab_attention_spmm_mh, attn_grad.onepass_bwd,
                 attn_grad.slab_attention_bwd, attn_grad.slab_attention_bwd_mh)


@pytest.mark.parametrize("model_cls,block_rows", [(GraphSAGE, 128), (GCN, 128),
                                                  (GAT, 128), (GAT, 512), (GIN, 128)])
def test_cpu_full_batch_leaves_launch_counters_at_zero(model_cls, block_rows):
    counters = (slab_spmm, slab_spmm_band, csr_spmm) + ATTN_COUNTERS
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
    with pytest.raises(ValueError, match="no kernel"):
        slab_spmm(slab, torch.empty((3, 8), device="meta"), "mean")
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
_GIN_TREE = {"params": {"conv_0": {name: {"kernel": np.zeros((4, 3), np.float32)
                                           if name == "mlp_1" else np.zeros((3, 3), np.float32),
                                           "bias": np.zeros(3, np.float32)}
                                    for name in ("mlp_1", "mlp_2")}}}
_RGCN_TREE = {"params": {"conv_0": {"lin_root": {"kernel": np.zeros((4, 3), np.float32),
                                                  "bias": np.zeros(3, np.float32)},
                                     "lin_rel_0": {"kernel": np.zeros((4, 3), np.float32)}}}}
@pytest.mark.parametrize("sub", ["", ".ops", ".sampler", ".models", ".utils"],
                         ids=lambda s: s or "root")
def test_exports_are_port_objects(sub):
    """Every name a subpackage exports is the port's own object (its module
    is under the package, whose sources the test above holds free of JAX)."""
    pkg = importlib.import_module(f"cugraph_gnn_tpu_torch{sub}")
    for name in pkg.__all__:
        obj = getattr(pkg, name)
        home = obj.__name__ if isinstance(obj, types.ModuleType) else getattr(
            obj, "__module__", pkg.__name__)
        assert home.split(".")[0] == "cugraph_gnn_tpu_torch", (name, home)


EXAMPLES = sorted((PKG / "examples").glob("*.py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_examples_import_sklearn_only_in_functions(path):
    """scikit-learn, which the card's machine lacks, is imported only where a
    downstream model is fitted, never when an example module is imported."""
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names if m.split(".")[0] == "sklearn"]
    inside = [m for m in _imported(path) if m.split(".")[0] == "sklearn"]
    assert bool(inside) == (path.stem in ("fraud_detection", "xgb_downstream"))


_INDPTR = np.array([0, 1, 2], np.int32)
_INDICES = np.array([1, 0], np.int32)
_CPU_CSR = (torch.as_tensor(_INDPTR), torch.as_tensor(_INDICES))
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
    "distributed.init": lambda: D.init(init_method="tcp://localhost:1", world_size=1),
    "create_store_mesh": create_store_mesh,
    "HostManagedCache": lambda: HostManagedCache(np.zeros((4, 2), np.float32), 8),
    "CachedHostEmbedding": lambda: CachedHostEmbedding(np.zeros((4, 2), np.float32)),
    "DeviceLFUCache": lambda: DeviceLFUCache(np.zeros((4, 2), np.float32), 8),
    "embedding_from_jax_arrays": lambda: embedding_from_jax_arrays(
        np.zeros((4, 2), np.float32), {}, "sgd"),
    "FeatureStore": lambda: FeatureStore(),
    "GIN": lambda: GIN(4),
    "gin_from_flax": lambda: gin_from_flax(_GIN_TREE),
    "create_gnn_model": lambda: create_gnn_model("gin", in_feat_dim=4, class_count=3),
    "GraphStructure": lambda: GraphStructure(),
    "LinkNeighborLoader": lambda: LinkNeighborLoader(
        (FeatureStore(), GraphStore()), [2], np.zeros((2, 3), np.int64)),
    "make_edge_key_sorted": lambda: NEG.make_edge_key_sorted([0], [1]),
    "sample_negative_edges": lambda: NEG.sample_negative_edges(4, 4, 2, NEG.NegativeSampling()),
    "weighted_sample": lambda: weighted_sample(_INDPTR, _INDICES, [1.0, 1.0], [0, 1], 1,
                                               max_degree=1),
    "masked_uniform_sample": lambda: masked_uniform_sample(
        _INDPTR, _INDICES, [0, 1], 1, max_degree=1, edge_times=[0, 0], seed_time=[1, 1]),
    "NeighborSampler": lambda: NeighborSampler(_INDPTR, _INDICES, (1,), weights=[1.0, 1.0]),
    "device_memory_bytes": device_memory_bytes,
    "make_synthetic_mag": lambda: TH.make_synthetic_mag(0, num_nodes=SMALL_MAG),
    "hetero_multihop_batched": lambda: hetero_multihop_batched(
        np.zeros((1, 2), np.int32), csrs={"a": (_INDPTR, _INDICES)}, etype_names=["a"],
        fanouts={"a": [1]}, edge_bases={"a": 0}),
    # CPU tensors do not choose the device: only device="cpu" does
    "hetero_multihop_batched_cpu_seeds": lambda: hetero_multihop_batched(
        torch.zeros((1, 2), dtype=torch.int32), csrs={"a": _CPU_CSR}, etype_names=["a"],
        fanouts={"a": [1]}, edge_bases={"a": 0}),
    "hetero_multihop_cpu_seeds": lambda: hetero_multihop(
        torch.zeros(2, dtype=torch.int32), csrs={"a": _CPU_CSR}, etype_names=["a"],
        fanouts={"a": [1]}, edge_bases={"a": 0}, max_degrees={"a": 1}, caps=[2, 4]),
    "RGCN": lambda: RGCN(4),
    "rgcn_from_flax": lambda: rgcn_from_flax(_RGCN_TREE),
    "create_gnn_model_rgcn": lambda: create_gnn_model("rgcn", in_feat_dim=4, class_count=3),
    "RelationalFullBatch": lambda: RelationalFullBatch(_INDICES, [0, 1], [0, 1], 2, 2,
                                                       reorder="none"),
    # the distributed path: no mesh given means the card's
    "DistGraph.from_global_csr": lambda: DistGraph.from_global_csr(_INDPTR, _INDICES),
    "DistGraph.from_local_coo": lambda: DistGraph.from_local_coo([0], [1], 2),
    "DistNeighborSampler.sample": lambda: DistNeighborSampler(
        DistGraph.from_global_csr(_INDPTR, _INDICES), (1,)).sample([0]),
    "DistNeighborLoader": lambda: DistNeighborLoader(_cpu_stores(), [1]),
    "DistLinkNeighborLoader": lambda: DistLinkNeighborLoader(
        _cpu_stores(), [1], edge_label_index=np.zeros((2, 3), np.int64)),
    "auto_mesh": auto_mesh,
    "HeteroDistGraph.from_sampling_graph": lambda: HeteroDistGraph.from_sampling_graph(
        _cpu_hetero_stores()[1].finalize()),
    "HeteroDistGraph.from_local_coo": lambda: HeteroDistGraph.from_local_coo(
        {("n", "e", "n"): ([0], [1])}, 2),
    "DistNeighborLoader_hetero": lambda: DistNeighborLoader(_cpu_hetero_stores(), [1]),
    "DistLinkNeighborLoader_hetero": lambda: DistLinkNeighborLoader(
        _cpu_hetero_stores(), [1], edge_label_index=(("a", "e", "b"), np.zeros((2, 1)))),
    "create_hierarchical_mesh": lambda: create_hierarchical_mesh(1),
    "get_global_mesh": D.get_global_mesh,
    "get_hierarchical_mesh": D.get_hierarchical_mesh,
    "TypedSAGE": lambda: THD.TypedSAGE({"a": 4}, {"a": (0, 2)}),
    "typed_sage_from_flax": lambda: typed_sage_from_flax(_TYPED_TREE, {"a": (0, 2)}),
    "click_stores": THD.click_stores,
    # the doctor, the meter, the examples and the checkpoint restores
    "smoke_check": doctor.smoke_check,
    "PerformanceMeter": profiling.PerformanceMeter,
    "ogbn_train.main": lambda: ogbn_train.main(["--dir", "no-such-dir"]),
    "node_classification.main": lambda: node_classification.main(["--dataset", "synthetic"]),
    **{f"{m.__name__.rsplit('.', 1)[1]}.main": (lambda m=m: m.main([])) for m in (
        fraud_detection, cached_embedding_training, rgcn_hetero, hetero_link_pred,
        kg_link_class, movielens_rec, multichip_training, hetero_dist_training,
        dist_full_batch_training, xgb_downstream, full_batch_training, link_prediction)},
    "restore_dist_array": lambda: orbax_ckpt.restore_dist_array("no-such-dir"),
    "restore_embedding": lambda: orbax_ckpt.restore_embedding("no-such-dir"),
}
_TYPED_TREE = {"params": {"in_a": {"kernel": np.zeros((4, 3), np.float32),
                                   "bias": np.zeros(3, np.float32)},
                          "out": {"kernel": np.zeros((3, 2), np.float32),
                                  "bias": np.zeros(2, np.float32)}}}


def _cpu_hetero_stores():
    """Hetero stores on the CPU (asked for)."""
    gs = GraphStore(device="cpu")
    gs.put_edge_index(([0, 1], [1, 0]), ("a", "e", "b"))
    gs.put_edge_index(([0, 1], [1, 1]), ("b", "r", "a"))
    return FeatureStore(device="cpu"), gs


def _cpu_stores():
    """Stores on the CPU (asked for), so that only the loader's own device
    rule is left to raise."""
    gs = GraphStore(device="cpu")
    gs.put_edge_index(([0, 1], [1, 0]), ("n", "e", "n"))
    return FeatureStore(device="cpu"), gs


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


SHARD_COUNTERS = (slab_spmm_band_shard, attn_fwd.slab_attention_spmm_shard,
                  attn_fwd.slab_attention_spmm_mh_shard, attn_grad.onepass_bwd_shard,
                  attn_grad.slab_attention_bwd_shard, attn_grad.slab_attention_bwd_mh_shard)


def test_shard_wrappers_refuse_other_devices():
    """The shard wrappers refuse a tensor on neither the CPU nor a card."""
    indptr = np.array([0, 1, 2, 2], np.int64)
    indices = np.array([1, 2], np.int32)
    slab = build_slab_graph(indptr, indices, block_rows=128, device="cpu")
    shard = DF.shard_slab(DF._padded(slab.ell.numpy(), 128, -1), None, 0, 128, 128, "meta")
    with pytest.raises(ValueError, match="no kernel"):
        slab_spmm_band_shard(shard, torch.empty((384, 8), device="meta"))

    def table(r_blk, heads, head_values):
        """A ShardTable of (R, heads, 4) parts on the meta device, no tail."""
        tail = attn_fwd.pack_rows(torch.empty((0, head_values), device="meta"),
                                  torch.empty((0, heads, 4), device="meta"))
        return attn_fwd.ShardTable(*(torch.empty((r_blk, heads, 4), device="meta")
                                     for _ in range(3)), tail)

    for r_blk in (128, 512):
        pair = attn_grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk,
                                                   device="cpu")
        sp = DF.shard_attention_pair(pair, 0, r_blk, r_blk, "meta")
        ext = 3 * r_blk
        s2, st = torch.empty((ext, 2), device="meta"), torch.empty((ext, 2, 4), device="meta")
        ad = torch.empty((r_blk, 2), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            attn_fwd.slab_attention_spmm_mh_shard(sp.fwd, table(r_blk, 2, 2), ad, s2)
        with pytest.raises(ValueError, match="no kernel"):
            attn_fwd.slab_attention_spmm_shard(sp.fwd, table(r_blk, 1, 1).squeeze_heads(),
                                               ad[:, 0], s2[:, 0])
        with pytest.raises(ValueError, match="no kernel"):
            attn_grad.slab_attention_bwd_mh_shard(sp, table(r_blk, 2, 2), s2,
                                                  table(r_blk, 2, 8), st)
        with pytest.raises(ValueError, match="no kernel"):
            attn_grad.slab_attention_bwd_shard(sp, table(r_blk, 1, 1).squeeze_heads(),
                                               s2[:, 0], table(r_blk, 1, 4).squeeze_heads(),
                                               st[:, 0])


@pytest.mark.parametrize("model_cls,block_rows", [(GCN, 128), (GAT, 128), (GAT, 512)])
def test_cpu_dist_step_leaves_launch_counters_at_zero(model_cls, block_rows, tmp_path):
    """One rank of gloo on the CPU: a gloo mesh refuses the card, and a
    row-sharded step takes the plain versions (finite loss, no launch)."""
    mesh = D.init(init_method=f"file://{os.path.join(tmp_path, 'store')}", rank=0,
                  world_size=1, device="cpu")
    try:
        assert mesh.backend == "gloo" and D.world_info() == (0, 1, 0, 1)
        with pytest.raises(ValueError, match="nccl"):
            create_store_mesh("cuda:0")
        for fn in SHARD_COUNTERS + (csr_spmm,):
            fn.launches = 0
        g = TF.make_synthetic_banded(0, "cpu", num_nodes=300, deg=4, band=20,
                                     feat_dim=8, classes=3)
        fbg = DF.DistFullBatchGraph.from_coo(g.src, g.dst, g.num_nodes, mesh,
                                             reorder="none", block_rows=block_rows)
        model = model_cls(8, 16, 3, device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
        loss = TF.dist_full_batch_step(model, opt, fbg.shard(g.feats), fbg,
                                       fbg.shard(g.labels), fbg.shard(torch.ones(300)))
        assert torch.isfinite(loss)
        assert all(fn.launches == 0 for fn in SHARD_COUNTERS + (csr_spmm,))
    finally:
        D.finalize()


def test_bwd_probe_is_card_only():
    """The phase probe (a timing tool, no path's kernel) has no CPU mode:
    CPU tensors, a mask outside [0, 15] and a pair with t_ell are refused,
    and nothing is counted."""
    attn_grad.onepass_bwd_probe.launches = 0
    rng = np.random.default_rng(0)
    dst = np.repeat(np.arange(200), 4)
    src = np.clip(dst + rng.integers(-30, 31, 800), 0, 199)
    indptr = np.searchsorted(dst, np.arange(201)).astype(np.int64)
    for r_blk in (128, 512):
        pair = attn_grad.build_attention_slab_pair(indptr, src.astype(np.int32),
                                                   block_rows=r_blk, device="cpu")
        x, g = torch.zeros((200, 2, 4)), torch.zeros((200, 2, 4))
        stats = [torch.ones((200, 2)) for _ in range(5)]
        with pytest.raises(ValueError):
            attn_grad.onepass_bwd_probe(pair, x, *stats, g)
        with pytest.raises(ValueError, match="mask"):
            attn_grad.onepass_bwd_probe(pair, x, *stats, g, phases=16)
    assert attn_grad.onepass_bwd_probe.launches == 0
    assert attn_grad.PROBE_ALL == 15


@pytest.mark.parametrize("path", ["loader", "link"])
def test_cpu_hetero_dist_path_leaves_launch_counters_at_zero(path, tmp_path):
    """One gloo rank on the CPU: the typed DistNeighborLoader with R-GCN's
    ``dist_train_step`` (or the typed DistLinkNeighborLoader), and the
    hierarchical gather on a 1 x 1 mesh, take the plain versions (finite
    losses, no launch)."""
    mesh = D.init(init_method=f"file://{os.path.join(tmp_path, 'store')}", rank=0,
                  world_size=1, device="cpu")
    try:
        counters = (gather_rows, fused_uniform_sample)
        for fn in counters:
            fn.launches = 0
        g = TH.make_synthetic_mag(0, "cpu", num_nodes=SMALL_MAG, feat_dim=8, classes=3,
                                  deg_cap=20)
        fs, gs = TH.mag_stores(g, "cpu")
        names = [n for n in map("__".join, gs.finalize().etypes)]
        model = RGCN(8, num_relations=3, hidden_features=16,
                     out_features=3 if path == "loader" else 16, device="cpu")
        opt = torch.optim.Adam(model.parameters(), lr=TH.LR)
        if path == "loader":
            loader = DistNeighborLoader((fs, gs), TH.FANOUTS, mesh, batch_size=8,
                                        input_nodes=("paper", np.arange(20)), shuffle=True)
            for batch in loader:
                assert sorted(batch.x) == ["author", "field", "paper"]
                assert torch.isfinite(TD.dist_train_step(TH.RGCNEncoder(model, names), opt,
                                                         batch, mesh))
        else:
            writes = ("author", "writes", "paper")
            src, dst = gs.get_edge_index(writes)
            loader = DistLinkNeighborLoader((fs, gs), [3, 2], mesh,
                                            edge_label_index=(writes, np.stack([src[:20],
                                                                                dst[:20]])),
                                            neg_sampling="binary", batch_size=8)
            enc = TH.RGCNEncoder(model, names)
            assert all(torch.isfinite(link_step(enc, opt, b)) for b in loader)
        arr = HierarchicalDistArray.from_array(g.feats, create_hierarchical_mesh(1, "cpu"))
        ids = torch.tensor([3, -1, 3, 7])
        rows, cross = arr.gather_with_stats(ids)
        assert torch.equal(rows[[0, 2, 3]], g.feats[[3, 3, 7]]) and int(cross[0]) == 0
        assert all(fn.launches == 0 for fn in counters)
    finally:
        D.finalize()
