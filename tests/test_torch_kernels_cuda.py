"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the row gather, the fused sampler (and, around them, ``append_unique``, one
``NeighborLoader`` batch and two ``LinkNeighborLoader`` batches against the
CPU on the same draws; the embeddings' dedup sums, cache slot reads, a cache
round against the CPU and ``DeviceLFUCache`` with an overfilled set), the
slab SpMM (the whole function and its band-only mode; GIN's full-batch
forward and backward against the CPU), the CSR SpMM kernel, and the fused slab attention's
forward and backward kernels, each of the last three also on the row shards
of a 4-rank split (the shard wrappers of ``ops/dist_full_batch.py``,
halo-extended inputs; the slab SpMM's whole function on each shard's table
of halo and remote rows, and at world 1 over NCCL).  Kernels without
atomics are launched twice on the same inputs and held bit for bit equal.
The weighted and time-masked samplers (plain PyTorch, no kernel of their
own) and weighted, temporal and disjoint loader batches are held against the
CPU on the same key words and uniforms, and two runs bit for bit.  The hetero
paths: the typed R-GCN block (samples and gathered rows bit-equal, three f32
steps' losses within 1e-4), typed and deduplicated hetero loader batches, and
``RelationalFullBatch``'s per-relation SpMMs under full-batch R-GCN, each
against the CPU.  The distributed loaders at world 1 over NCCL: batches
bit-equal to the one-device loaders' on the same draws (and three steps'
losses equal), the rank-local mode to the global one, and the card to the
CPU (a gloo group of the one rank) for uniform, weighted and temporal
sampling; the same for the hetero dist loaders (typed, on a small mag-shaped
graph, against the typed ``NeighborLoader`` and ``LinkNeighborLoader``), and
the hierarchical gather on a 1 x 1 (node, device) mesh against the flat one.
The doctor on the card (its ring sample one sampler launch), a profiler
trace of a loader batch naming both kernels, and DCP checkpoints at world 1
over NCCL restored bit for bit.  Each example script's ``main`` at its small
CPU-test argv (``torch_example_runs.TINY_ARGV``) on the card.

Marked ``cuda``: each test asks the ``card`` fixture for a device and skips
without one.  The file imports no JAX, so on the machine with the card it
runs without the repo's conftest (which configures JAX):

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -o addopts= -q
"""

import numpy as np
import pytest
import torch
from torch_example_runs import TINY_ARGV, karate_file

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
from cugraph_gnn_tpu_torch.loader import NeighborLoader
from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows, gather_rows_ref
from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
    fused_uniform_sample,
    fused_uniform_sample_ref,
)
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as attn_grad
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as attn_fwd
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import (
    slab_attention_spmm_mh,
    slab_attention_spmm_mh_ref,
)
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    build_slab_graph,
    slab_spmm,
    slab_spmm_band,
    slab_spmm_band_ref,
    slab_spmm_band_shard,
    slab_spmm_band_shard_ref,
    slab_spmm_ref,
    slab_spmm_shard,
    slab_spmm_shard_ref,
)
from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import (
    build_padded_blocks,
    csr_spmm,
    csr_spmm_ref,
)
from cugraph_gnn_tpu_torch.ops.unique import append_unique

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    """Integer view of a float tensor, so that equality is bit equality."""
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("f", [128, 100, 3])
def test_gather_rows_bit_equal(card, table_dtype, out_dtype, ids_dtype, f):
    rng = np.random.default_rng(f)
    n, b = 5000, 3001
    table = torch.as_tensor(rng.standard_normal((n, f)), dtype=torch.float32,
                            device=card).to(table_dtype)
    ids_np = rng.integers(0, n, b)
    ids_np[::7] = -1
    ids_np[5] = n + 3          # past the end: reads the last row
    ids = torch.as_tensor(ids_np, dtype=ids_dtype, device=card)
    before = gather_rows.launches
    out = gather_rows(table, ids, out_dtype)
    want = gather_rows_ref(table, ids, out_dtype)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (b, f)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(_bits(out).cpu(),
                       _bits(gather_rows_ref(table.cpu(), ids.cpu(), out_dtype)))


def _graph(rng, n=600):
    """Degrees 0, at most 10, up to 29, hubs of 129-2999 and one of 17,000
    (the synthetic products graph's cap)."""
    deg = rng.integers(0, 30, n)
    deg[::50] = 0
    deg[1::97] = rng.integers(129, 3000, deg[1::97].shape[0])
    deg[7] = 17_000
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


# k = 1..32 take the kernel's lane groups (32 // k seeds a warp), 33 and 40
# one thread a seed; batches of one seed, of 33 (not a multiple of 32) and
# hop 0's 10,240
@pytest.mark.parametrize("s", [1, 33, 10_240])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 25, 32, 33, 40])
def test_uniform_sample_bit_equal(card, k, s):
    rng = np.random.default_rng(k * 7 + s)
    indptr, indices = _graph(rng)
    n = indptr.shape[0] - 1
    seeds = rng.integers(0, n, s).astype(np.int32)
    seeds[2::11] = -1
    seeds[1::5] = 7            # the 17,000-slot hub
    if s > 3:
        seeds[3] = n + 5       # past the end: degree 0
    u = rng.random((s, k), dtype=np.float32)
    args = [torch.as_tensor(a, device=card) for a in (indptr, indices, seeds, u)]
    before = fused_uniform_sample.launches
    out = fused_uniform_sample(*args, k)
    again = fused_uniform_sample(*args, k)
    want = fused_uniform_sample_ref(*args, k)
    host = fused_uniform_sample_ref(
        *[torch.as_tensor(a) for a in (indptr, indices, seeds, u)], k)
    torch.cuda.synchronize()
    assert fused_uniform_sample.launches == before + 2
    for got, got2, ref, ref_host in zip(out, again, want, host):
        assert got.dtype == torch.int32
        assert torch.equal(got, ref)
        assert torch.equal(got, got2)
        assert torch.equal(got.cpu(), ref_host)


def test_uniform_sample_empty_graph(card):
    indptr = torch.zeros(5, dtype=torch.int32, device=card)
    indices = torch.zeros(0, dtype=torch.int32, device=card)
    seeds = torch.tensor([0, 3, -1], dtype=torch.int32, device=card)
    u = torch.rand((3, 4), device=card)
    out = fused_uniform_sample(indptr, indices, seeds, u, 4)
    assert torch.equal(out.neighbors.cpu(), torch.full((3, 4), -1, dtype=torch.int32))
    assert torch.equal(out.edge_ids.cpu(), torch.full((3, 4), -1, dtype=torch.int32))
    assert torch.equal(out.num_sampled.cpu(), torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("budget", ["full", "clamped"])
def test_append_unique_card_matches_cpu(card, budget):
    rng = np.random.default_rng(len(budget))
    targets = rng.choice(200_000, 5000, replace=False).astype(np.int32)
    neighbors = rng.integers(0, 200_000, 50_000).astype(np.int32)
    neighbors[::7] = -1
    neighbors[1::9] = targets[rng.integers(0, 5000, neighbors[1::9].shape[0])]
    max_unique = 55_000 if budget == "full" else 20_000
    got = append_unique(torch.as_tensor(targets, device=card),
                        torch.as_tensor(neighbors, device=card), max_unique=max_unique)
    want = append_unique(torch.as_tensor(targets), torch.as_tensor(neighbors),
                         max_unique=max_unique)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


class _FixedDraws:
    """A loader's sampler whose draws are given: batch after batch, the
    same CPU uniforms on either device."""

    def __init__(self, inner):
        self.inner = inner

    def sample(self, seeds, generator=None):
        g = torch.Generator().manual_seed(11)
        caps = self.inner.level_caps(seeds.shape[0])
        u = [torch.rand((caps[h], k), generator=g) for h, k in enumerate(self.inner.fanouts)]
        return self.inner.sample(seeds, u=u)


def test_neighbor_loader_batch_card_matches_cpu(card):
    rng = np.random.default_rng(5)
    indptr, indices = _graph(rng, n=3000)
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    x = rng.standard_normal((n, 40)).astype(np.float32)
    y = rng.integers(0, 7, n)
    batches = []
    for dev in (card, torch.device("cpu")):
        gs, fs = GraphStore(device=dev), FeatureStore(device=dev)
        gs.put_edge_index((indices, rows), ("n", "to", "n"), num_nodes=(n, n))
        fs["x"] = x
        fs["y"] = y
        loader = NeighborLoader((fs, gs), (10, 5), batch_size=512, shuffle=True)
        loader.sampler = _FixedDraws(loader.sampler)
        before = (gather_rows.launches, fused_uniform_sample.launches)
        batches.append(next(iter(loader)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (gather_rows.launches, fused_uniform_sample.launches) == (
                before[0] + 1, before[1] + 2)
    got, want = batches
    assert not got.sample.static_layout
    for a, b in zip([got.seeds, got.input_id, got.x, got.y] + got.sample.levels
                    + got.sample.level_counts,
                    [want.seeds, want.input_id, want.x, want.y] + want.sample.levels
                    + want.sample.level_counts):
        assert torch.equal(a.cpu(), b)
    for ha, hb in zip(got.sample.hops, want.sample.hops):
        assert ha.edge_hi is None and hb.edge_hi is None
        for a, b in zip(ha[:3], hb[:3]):
            assert torch.equal(a.cpu(), b)


def _csr(rng, n, deg, band, far=0.0, weighted=False, shift=None):
    """CSR of ``deg`` sources per row within +-band (a share ``far``
    uniform instead; with ``shift``, every source is (row + shift) % n),
    and optional float32 weights."""
    dst = np.repeat(np.arange(n), deg)
    src = np.clip(dst + rng.integers(-band, band + 1, n * deg), 0, max(n - 1, 0))
    src = np.where(rng.random(n * deg) < far, rng.integers(0, max(n, 1), n * deg), src)
    if shift is not None:
        src = (dst + shift) % n
    indptr, indices, _ = _native.build_csr(dst, src, n)
    w = rng.uniform(0.5, 2.0, len(indices)).astype(np.float32) if weighted else None
    return indptr, indices, w


def _x(rng, n, f, dtype, card):
    return torch.as_tensor(rng.standard_normal((n, f)), dtype=torch.float32,
                           device=card).to(dtype)


def _assert_sum_close(got, f32_sum, magnitude):
    """``got`` against the plain version's float32 sum: within 1e-5, absolute
    and relative to ``magnitude`` (the same sum over the terms' absolute
    values, the scale of sum-order rounding: a ~750-term hub row of a
    transposed banded graph rounds far more than its result's size suggests);
    a bfloat16 ``got`` also within one bfloat16 ulp of the sum (round to
    nearest takes half an ulp)."""
    tol = 1e-5 * (1 + magnitude)
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(f32_sum)
        tol = tol + torch.ldexp(torch.ones_like(f32_sum), e - 8)
    else:
        assert got.dtype == torch.float32
    assert bool(((got.float() - f32_sum).abs() <= tol).all())


SPMM_WIDTHS = [64, 128, 256, 100, 47]


def _holes_csr(rng, n, weighted=False):
    """A banded CSR whose ELL has holes (parallel edges, dropped from the
    band after their first instance) and is 64 wide (row n // 3 has 70
    in-band sources), with far sources (fallback edges)."""
    dst = np.repeat(np.arange(n), 8)
    src = np.clip(dst + rng.integers(-100, 101, n * 8), 0, n - 1)
    src[1::8] = src[::8]                        # parallel edges
    src = np.where(rng.random(n * 8) < 0.1, rng.integers(0, n, n * 8), src)
    hub = n // 3
    dst = np.concatenate([dst, np.full(70, hub)])
    src = np.concatenate([src, np.clip(hub + rng.integers(-120, 121, 70), 0, n - 1)])
    indptr, indices, _ = _native.build_csr(dst, src, n)
    w = rng.uniform(0.5, 2.0, len(indices)).astype(np.float32) if weighted else None
    return indptr, indices, w


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", SPMM_WIDTHS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("graph", ["k8", "holes_k64"])
def test_slab_spmm_band_matches_plain(card, x_dtype, f, weighted, graph):
    """The band-only mode against its plain version, float32 sums: 1e-5.
    n = 1000 is not a multiple of R = 128; both compute dtypes; an ELL capped
    at 8 and one 64 wide with holes (its rows read to their length); two
    launches bit for bit equal."""
    rng = np.random.default_rng(f + weighted)
    if graph == "k8":
        indptr, indices, w = _csr(rng, 1000, 9, 100, far=0.2, weighted=weighted)
        g = build_slab_graph(indptr, indices, w, block_rows=128, max_k=8, device=card)
    else:
        indptr, indices, w = _holes_csr(rng, 1000, weighted)
        g = build_slab_graph(indptr, indices, w, block_rows=128, device=card)
        valid = (g.ell >= 0).sum(1)
        assert g.ell.shape[1] == 64 and bool((g.ell_len >= valid).all())
        assert bool((g.ell_len > valid).any())   # holes before a row's last entry
    x = _x(rng, 1000, f, x_dtype, card)
    for compute in (torch.float32, torch.bfloat16):
        before = slab_spmm_band.launches
        got = slab_spmm_band(g, x, compute)
        want = slab_spmm_band_ref(g, x, compute)
        torch.cuda.synchronize()
        assert slab_spmm_band.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (1000, f)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(_bits(got), _bits(slab_spmm_band(g, x, compute)))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [64, 128, 256, 100])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_spmm_matches_plain(card, x_dtype, f, weighted):
    """New output in x's dtype, and accumulation into float32 and bfloat16
    ``out``, against the float32 sum (``_assert_sum_close``)."""
    rng = np.random.default_rng(100 + f + weighted)
    indptr, indices, w = _csr(rng, 900, 3, 900, far=1.0, weighted=weighted)
    indices[::11] = 900 + 7              # past the end: skipped
    padded = build_padded_blocks(indptr, indices, edge_tile=128, weights=w,
                                 device=card)
    x = _x(rng, 900, f, x_dtype, card)
    before = csr_spmm.launches
    got = csr_spmm(padded, x)
    f32_sum = csr_spmm_ref(padded, x.float())
    magnitude = csr_spmm_ref(padded, x.float().abs())   # weights are positive
    assert got.dtype == x_dtype
    _assert_sum_close(got, f32_sum, magnitude)
    for out_dtype in (torch.float32, torch.bfloat16):
        base = _x(rng, 900, f, out_dtype, card)
        out = csr_spmm(padded, x, out=base.clone())
        assert out.dtype == out_dtype
        _assert_sum_close(out, base.float() + f32_sum, base.float().abs() + magnitude)
    torch.cuda.synchronize()
    assert csr_spmm.launches == before + 3


# name -> (n, deg, band, far, shift): fallback and band, band only (simple
# graph), all fallback (every source n/2 rows away), no edges, no nodes
SLAB_CASES = {
    "mixed": (1000, 9, 100, 0.2, None),
    "band_only": (1000, 1, 60, 0.0, None),
    "all_fallback": (1000, 4, 0, 0.0, 500),
    "no_edges": (333, 0, 0, 0.0, None),
    "no_nodes": (0, 0, 0, 0.0, None),
}


@pytest.mark.parametrize("name", sorted(SLAB_CASES))
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("f", [128, 47])
def test_slab_spmm_matches_plain(card, name, x_dtype, reduce, f):
    """The whole function in one launch (band, fallback, mean divide, one
    rounding to x's dtype) against the plain version's float32 sum
    (``_assert_sum_close``); one launch where there are rows, no launch of
    the band-only mode or the CSR kernel; two launches bit for bit equal."""
    n, deg, band, far, shift = SLAB_CASES[name]
    rng = np.random.default_rng(7)
    indptr, indices, _ = _csr(rng, n, deg, band, far=far, shift=shift)
    g = build_slab_graph(indptr, indices, block_rows=128, device=card)
    if name == "band_only":
        assert g.fb_src.shape[0] == 0
    if name == "all_fallback":
        assert g.band_fraction == 0.0
    x = _x(rng, n, f, x_dtype, card)
    before, band0, csr0 = slab_spmm.launches, slab_spmm_band.launches, csr_spmm.launches
    got = slab_spmm(g, x, reduce, torch.float32)
    torch.cuda.synchronize()
    assert slab_spmm.launches == before + (n > 0)
    assert (slab_spmm_band.launches, csr_spmm.launches) == (band0, csr0)
    assert got.dtype == x_dtype and got.shape == (n, f)
    _assert_sum_close(got, slab_spmm_ref(g, x.float(), reduce, torch.float32),
                      slab_spmm_ref(g, x.float().abs(), reduce, torch.float32))
    assert torch.equal(_bits(got), _bits(slab_spmm(g, x, reduce, torch.float32)))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", SPMM_WIDTHS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_slab_spmm_holes_weights_and_widths(card, x_dtype, f, weighted, reduce):
    """The whole function over an ELL 64 wide with holes, with fallback
    edges, weighted or not, at every width, both compute dtypes: within the
    float32 sum's tolerance (``_assert_sum_close``), the band's operands
    rounded to bfloat16 where the compute dtype says so; two launches bit for
    bit equal."""
    rng = np.random.default_rng(40 + f + weighted)
    indptr, indices, w = _holes_csr(rng, 1000, weighted)
    g = build_slab_graph(indptr, indices, w, block_rows=128, device=card)
    assert g.fb_src.shape[0] > 0 and g.ell.shape[1] == 64
    x = _x(rng, 1000, f, x_dtype, card)
    for compute in (torch.float32, torch.bfloat16):
        got = slab_spmm(g, x, reduce, compute)
        _assert_sum_close(got, slab_spmm_ref(g, x.float(), reduce, compute),
                          slab_spmm_ref(g, x.float().abs(), reduce, torch.float32))
        assert torch.equal(_bits(got), _bits(slab_spmm(g, x, reduce, compute)))


def _attention_pair(r_blk, card, n=1300):
    """An attention pair over ``n`` nodes: 6 sources per row within +-150
    (a fifth uniform), 60 extra sources into column n // 2, parallel edges,
    rows 10-11 without edges and rows 20-21 with only far sources; max_k 8,
    so that both caps spill.  R = 128 has bit planes, R = 512 t_ell."""
    rng = np.random.default_rng(r_blk)
    dst = np.repeat(np.arange(n), 6)
    src = np.clip(dst + rng.integers(-150, 151, n * 6), 0, n - 1)
    src = np.where(rng.random(n * 6) < 0.2, rng.integers(0, n, n * 6), src)
    src = np.where(np.isin(dst, [20, 21]), (dst + n // 2) % n, src)
    hub = np.clip(n // 2 + rng.integers(-150, 151, 60), 0, n - 1)
    src = np.concatenate([src, np.full(60, n // 2), src[:9]])
    dst = np.concatenate([dst, hub, dst[:9]])
    keep = ~np.isin(dst, [10, 11])
    indptr, indices, _ = _native.build_csr(dst[keep], src[keep], n)
    pair = attn_grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk,
                                               max_k=8, device=card)
    assert (pair.t_ell is None) == (r_blk == 128)
    assert 0.0 < pair.fwd.band_fraction < 1.0
    return pair


def _attn_inputs(n, heads, f, x_dtype, card, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda shape: torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                      device=card)
    return t((n, heads, f)).to(x_dtype), t((n, heads)), t((n, heads)), t((n, heads, f))


def _assert_close_to(got, want, magnitude, rel=1e-5):
    """Within 1e-5 absolute plus ``rel`` of ``magnitude``, the same sums
    over the terms' absolute values: the kernels add in another order (and,
    in the backward, factor the dot product out of the sums)."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 + rel * magnitude
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


ATTN_SHAPES = [(4, 64), (1, 47), (3, 5), (2, 128)]


@pytest.mark.parametrize("r_blk", [128, 512])
@pytest.mark.parametrize("heads,f", ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_slab_attention_fwd_matches_plain(card, r_blk, heads, f, x_dtype):
    """Forward kernel against its plain version: out within 1e-5 plus 1e-5
    of the same aggregate over |x|; m equal and s within 1e-5 (the same
    maxima, sums in the same order, expf against torch.exp); rows without
    edges give zeros.  Both compute dtypes; two launches bit for bit
    equal."""
    pair = _attention_pair(r_blk, card)
    n = pair.fwd.num_rows
    x, ad, as_, _ = _attn_inputs(n, heads, f, x_dtype, card)
    for compute in (torch.float32, torch.bfloat16):
        before = slab_attention_spmm_mh.launches
        out, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, compute_dtype=compute,
                                           return_stats=True)
        want, m_want, s_want = slab_attention_spmm_mh_ref(
            pair.fwd, x, ad, as_, compute_dtype=compute, return_stats=True)
        mag = slab_attention_spmm_mh_ref(pair.fwd, x.float().abs(), ad, as_,
                                         compute_dtype=compute)
        torch.cuda.synchronize()
        assert slab_attention_spmm_mh.launches == before + 1
        _assert_close_to(out, want, mag)
        assert torch.equal(m, m_want)
        torch.testing.assert_close(s, s_want, rtol=1e-5, atol=0)
        assert not out[10:12].any() and not s[10:12].any() and s[20:22].all()
        again = slab_attention_spmm_mh(pair.fwd, x, ad, as_, compute_dtype=compute,
                                       return_stats=True)
        for a, b in zip((out, m, s), again):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("r_blk", [128, 512])
@pytest.mark.parametrize("heads,f", ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_slab_attention_bwd_matches_plain(card, r_blk, heads, f, x_dtype):
    """Backward kernel (R = 128: the band CSR, ``onepass_bwd``; R = 512:
    t_ell, ``slab_attention_bwd`` at H = 1, ``slab_attention_bwd_mh``
    above) against its plain version: within 1e-5 plus 1e-5 of the same
    sums with |x|, |g| and -|t| (every term's magnitude)."""
    pair = _attention_pair(r_blk, card)
    n = pair.fwd.num_rows
    x, ad, as_, g = _attn_inputs(n, heads, f, x_dtype, card, seed=1)
    _, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, heads), generator=torch.Generator(card).manual_seed(2),
                    device=card)
    counter = (attn_grad.onepass_bwd if r_blk == 128 else attn_grad.slab_attention_bwd
               if heads == 1 else attn_grad.slab_attention_bwd_mh)
    before = counter.launches
    got = attn_grad.slab_attention_bwd_mh(pair, x, ad, as_, m, s, t, g)
    want = attn_grad.slab_attention_bwd_ref(pair, x, ad, as_, m, s, t, g)
    mag = attn_grad.slab_attention_bwd_ref(pair, x.float().abs(), ad, as_, m, s,
                                           -t.abs(), g.abs())
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b, c in zip(got, want, mag):
        _assert_close_to(a, b, c)


@pytest.mark.parametrize("r_blk", [128, 512])
def test_slab_attention_autograd_card_matches_cpu(card, r_blk):
    """The differentiable attention on the card (both kernels) against the
    CPU (plain versions) from the same inputs: output and the three
    gradients of sum(out * g) within 1e-4."""
    pair = _attention_pair(r_blk, card)
    pair_cpu = pair.to("cpu")
    n = pair.fwd.num_rows
    x, ad, as_, g = _attn_inputs(n, 4, 16, torch.float32, card, seed=3)
    res = []
    for p, dev in ((pair, card), (pair_cpu, "cpu")):
        leaves = [a.detach().to(dev).requires_grad_() for a in (x, ad, as_)]
        out = attn_grad.differentiable_slab_attention_mh(p)(*leaves)
        (out * g.to(dev)).sum().backward()
        res.append([out.detach().cpu()] + [a.grad.cpu() for a in leaves])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- row shards (rows 9-14 of the TPU-kernel table) ---------------------------

WORLD = 4


def _split(n_rows, r_blk):
    """(rows per rank, padded rows) of a WORLD-rank split, as
    DistFullBatchGraph pads it."""
    nb = -(-max(-(-n_rows // r_blk), 1) // WORLD) * WORLD
    return nb // WORLD * r_blk, nb * r_blk


def _pad(t, rows):
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[:t.shape[0]] = t
    return out


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("f", SPMM_WIDTHS)
def test_slab_spmm_band_shard_matches_plain(card, x_dtype, weighted, f):
    """Each shard of a 4-rank split: the band kernel over the shard's
    halo-extended x within 1e-5 of its plain version and of the whole
    graph's band kernel on the shard's rows (the same entries, in the same
    order); both compute dtypes; two launches bit for bit equal."""
    rng = np.random.default_rng(30 + weighted + f)
    indptr, indices, w = _csr(rng, 1000, 9, 100, far=0.2, weighted=weighted)
    g = build_slab_graph(indptr, indices, w, block_rows=128, max_k=8, device="cpu")
    rs, n_pad = _split(1000, 128)
    ell = DF._padded(g.ell.numpy(), n_pad, -1)
    ell_w = None if g.ell_w is None else DF._padded(g.ell_w.numpy(), n_pad, 0)
    x = _pad(_x(rng, 1000, f, x_dtype, card), n_pad)
    for compute in (torch.float32, torch.bfloat16):
        whole = _pad(slab_spmm_band(g.to(card), x[:1000], compute), n_pad)
        for rank in range(WORLD):
            shard = DF.shard_slab(ell, ell_w, rank, rs, 128, card)
            x_ext = DF.halo_rows(x, rank, rs, 128)
            before = slab_spmm_band_shard.launches
            got = slab_spmm_band_shard(shard, x_ext, compute)
            want = slab_spmm_band_shard_ref(shard, x_ext, compute)
            torch.cuda.synchronize()
            assert slab_spmm_band_shard.launches == before + 1
            assert got.shape == (rs, f)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(_bits(got), _bits(slab_spmm_band_shard(shard, x_ext, compute)))
            torch.testing.assert_close(got, whole[rank * rs:(rank + 1) * rs], rtol=1e-5,
                                       atol=1e-5)


def _shard_case(weighted):
    """A 4-rank geometry at R = 128 with fallback edges: the hub graph of
    ``_hub_csr`` at 1100 nodes (a row and a column of 80 fallback edges; 12
    blocks a world, so the last shard is padding rows only) and its
    transpose, as (indptr, indices, weights or None) each."""
    indptr, indices = _hub_csr(n=1100)
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    t_indptr, t_indices, perm = _native.build_csr(indices, rows, n)
    w = np.random.default_rng(5).uniform(0.5, 2.0, len(indices)).astype(np.float32)
    return {"graph": (indptr, indices, w if weighted else None),
            "transpose": (t_indptr, t_indices, w[perm] if weighted else None)}


@pytest.mark.parametrize("orient", ["graph", "transpose"])
@pytest.mark.parametrize("x_dtype,f", [(torch.bfloat16, 128), (torch.float32, 256)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_slab_spmm_shard_matches_plain(card, orient, x_dtype, f, weighted, reduce):
    """Each shard of a 4-rank split: ``slab_spmm_shard`` over its table (the
    halos and the remote rows its fallback edges read, built from the whole
    x, both nonzero) against its plain version and against the one-card
    ``slab_spmm`` on the shard's rows, within the float32 sum's tolerance
    (``_assert_sum_close``), both compute dtypes; a shard with a row of
    more than 64 fallback slots and a shard of padding rows only (no band
    edges, nothing to read); one launch each, no other kernel; two launches
    bit for bit equal."""
    indptr, indices, w = _shard_case(weighted)[orient]
    n = len(indptr) - 1
    slab = build_slab_graph(indptr, indices, w, block_rows=128, device="cpu")
    rs, n_pad = _split(n, 128)
    x = _pad(_x(np.random.default_rng(f + weighted), n, f, x_dtype, card), n_pad)
    long_rows = tails = 0
    for compute in (torch.float32, torch.bfloat16):
        whole = slab_spmm(slab.to(card), x[:n], reduce, compute)
        for rank in range(WORLD):
            graph, tail = DF.shard_table_graph(slab, rank, rs, n_pad, WORLD, card)
            ext = DF.halo_rows(x, rank, rs, 128)
            parts = (x[rank * rs:(rank + 1) * rs], ext[:128], ext[-128:],
                     x[torch.as_tensor(tail, device=card)])
            slots = graph.fb_rowptr[1:] - graph.fb_rowptr[:-1]
            long_rows += int((slots > 64).sum())
            tails += len(tail)
            if rank == WORLD - 1:
                assert not bool((graph.ell >= 0).any()) and graph.fb_src.numel() == 0
            counts = (slab_spmm_shard.launches, slab_spmm.launches, csr_spmm.launches,
                      slab_spmm_band_shard.launches)
            got = slab_spmm_shard(graph, *parts, reduce, compute)
            torch.cuda.synchronize()
            assert (slab_spmm_shard.launches, slab_spmm.launches, csr_spmm.launches,
                    slab_spmm_band_shard.launches) == (counts[0] + 1,) + counts[1:]
            assert got.dtype == x_dtype and got.shape == (rs, f)
            f32 = [p.float() for p in parts]
            mag = slab_spmm_shard_ref(graph, *[p.abs() for p in f32], reduce, torch.float32)
            _assert_sum_close(got, slab_spmm_shard_ref(graph, *f32, reduce, compute), mag)
            hi = max(min(n - rank * rs, rs), 0)
            _assert_sum_close(got[:hi], whole[rank * rs:rank * rs + hi].float(), mag[:hi])
            assert not bool((got[hi:] != 0).any())
            assert torch.equal(_bits(got), _bits(slab_spmm_shard(graph, *parts, reduce, compute)))
    assert long_rows > 0 and tails > 0


def test_slab_spmm_shard_world1(world1):
    """At world 1 over NCCL: ``DistFullBatchGraph``'s sharded SpMM (the
    graph, 'mean', and the transpose, 'sum', bf16 x) launches the shard
    kernel once a call and no other kernel, and agrees with
    ``slab_spmm_shard_ref`` on the table the path builds (the halos zero, no
    remote rows) within the sum tolerance; two calls bit for bit equal."""
    card = world1.device
    rng = np.random.default_rng(12)
    indptr, indices, _ = _csr(rng, 3000, 9, 200, far=0.1)
    g = DF.DistFullBatchGraph(indptr, indices, world1, reorder="none", block_rows=128)
    rs = g.rows_per_rank
    x = g.shard(rng.standard_normal((3000, 96)).astype(np.float32), torch.bfloat16)
    for transpose, reduce in ((False, "mean"), (True, "sum")):
        st = g._spmm[transpose]
        assert not st.balanced and st.route is None and st.band.fb_src.numel() > 0
        counts = (slab_spmm_shard.launches, csr_spmm.launches, slab_spmm_band_shard.launches)
        got = g._spmm_sharded(x, transpose=transpose, reduce=reduce,
                              compute_dtype=torch.float32)
        torch.cuda.synchronize()
        assert (slab_spmm_shard.launches, csr_spmm.launches,
                slab_spmm_band_shard.launches) == (counts[0] + 1,) + counts[1:]
        zeros = x.new_zeros((128, 96))
        parts = [x.float(), zeros.float(), zeros.float(), x.new_zeros((0, 96)).float()]
        want = slab_spmm_shard_ref(st.band, *parts, reduce, torch.float32)
        mag = slab_spmm_shard_ref(st.band, *[p.abs() for p in parts], reduce, torch.float32)
        assert got.dtype == torch.bfloat16 and got.shape == (rs, 96)
        _assert_sum_close(got, want, mag)
        again = g._spmm_sharded(x, transpose=transpose, reduce=reduce,
                                compute_dtype=torch.float32)
        assert torch.equal(_bits(got), _bits(again))


SHARD_ATTN_SHAPES = [(4, 64), (1, 47)]


def _shard_bwd_args(pair, rank, rs, n_pad, per_node):
    """Rank ``rank``'s inputs of the shard backward from whole padded
    (x, alpha_dst, alpha_src, m, s, t, g) (n_pad rows): (the shard's pair
    with its tables, table A, alpha_src_ext, table B, stats_ext), and the
    same with |x|, |g| and -|t| for the sums over the terms' magnitudes."""
    r_blk = pair.fwd.block_rows
    shard, tail_a, tail_b = DF.shard_attention_tables(pair, rank, rs, n_pad, WORLD,
                                                      pair.fwd.ell.device)
    x, ad, as_, m, s, t, g = per_node

    def args(x, t, g):
        stats = attn_grad.attention_stats(ad, m, s, t)
        st_ext = DF.halo_rows(stats, rank, rs, r_blk)
        st_ext[..., 2].clamp_(min=1e-16)   # zero halo rows past the graph's ends
        return (DF.halo_table(x, as_, rank, rs, r_blk, tail_a),
                DF.halo_rows(as_, rank, rs, r_blk),
                DF.halo_table(g, stats, rank, rs, r_blk, tail_b), st_ext)

    return shard, args(x, t, g), args(x.float().abs(), -t.abs(), g.abs())


@pytest.mark.parametrize("r_blk", [128, 512])
@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_slab_attention_fwd_shard_matches_plain(card, r_blk, heads, f, x_dtype):
    """Each shard of a 4-rank split: the whole forward over the shard's
    table A (band and fallback edges in one softmax, remote rows from the
    packed tail; ``slab_attention_spmm_shard`` at H = 1, ``_mh_shard``
    above) within 1e-5 plus 1e-5 of the aggregate over |x| of its plain
    version (m equal, s within 1e-5) and of the whole graph's forward on the
    shard's rows; one launch a call, two launches bit for bit equal; some
    shard reads remote rows."""
    pair = _attention_pair(r_blk, card)
    n = pair.fwd.num_rows
    rs, n_pad = _split(n, r_blk)
    x, ad, as_, _ = (_pad(a, n_pad) for a in _attn_inputs(n, heads, f, x_dtype, card))
    whole = slab_attention_spmm_mh(pair.fwd, x[:n], ad[:n], as_[:n], return_stats=True)
    whole = [_pad(a, n_pad) for a in whole]
    remote = 0
    for rank in range(WORLD):
        shard, tail_a, _ = DF.shard_attention_tables(pair, rank, rs, n_pad, WORLD, card)
        remote += len(tail_a)
        rows = slice(rank * rs, (rank + 1) * rs)
        tables = [DF.halo_table(a, as_, rank, rs, r_blk, tail_a) for a in (x, x.float().abs())]
        as_ext = DF.halo_rows(as_, rank, rs, r_blk)
        args, mag_args = [[t, ad[rows], as_ext] for t in tables]
        if heads == 1:
            fn, ref = attn_fwd.slab_attention_spmm_shard, attn_fwd.slab_attention_spmm_shard_ref
            args, mag_args = [[t.squeeze_heads(), a[:, 0], e[:, 0]] for t, a, e in (args, mag_args)]
        else:
            fn, ref = (attn_fwd.slab_attention_spmm_mh_shard,
                       attn_fwd.slab_attention_spmm_mh_shard_ref)
        before = fn.launches
        out, m, s = fn(shard.fwd, *args, return_stats=True)
        want, m_want, s_want = ref(shard.fwd, *args, return_stats=True)
        mag = ref(shard.fwd, *mag_args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        if heads == 1:
            out, m, s, want, m_want, s_want, mag = (
                a[:, None] for a in (out, m, s, want, m_want, s_want, mag))
        _assert_close_to(out, want, mag)
        assert torch.equal(m, m_want)
        torch.testing.assert_close(s, s_want, rtol=1e-5, atol=0)
        _assert_close_to(out, whole[0][rows], mag)
        assert torch.equal(m, whole[1][rows])
        torch.testing.assert_close(s, whole[2][rows], rtol=1e-5, atol=0)
        again = fn(shard.fwd, *args, return_stats=True)
        if heads == 1:
            again = [a[:, None] for a in again]
        for a, b in zip((out, m, s), again):
            assert torch.equal(_bits(a), _bits(b))
    assert remote > 0


@pytest.mark.parametrize("r_blk", [128, 512])
@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_slab_attention_bwd_shard_matches_plain(card, r_blk, heads, f, x_dtype):
    """Each shard of a 4-rank split: the whole backward over the shard's
    tables (band and fallback edges by destination over table A, by source
    over table B, remote rows from the packed tails; R = 128: the band CSR,
    ``onepass_bwd_shard``; R = 512: t_ell, ``slab_attention_bwd_shard`` at
    H = 1, ``_mh_shard`` above) within 1e-5 plus 1e-5 of the sums with |x|,
    |g|, -|t| of its plain version and of the whole graph's backward on the
    shard's rows; one launch a call, two launches bit for bit equal."""
    pair = _attention_pair(r_blk, card)
    n = pair.fwd.num_rows
    rs, n_pad = _split(n, r_blk)
    x, ad, as_, g = _attn_inputs(n, heads, f, x_dtype, card, seed=1)
    _, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, heads), generator=torch.Generator(card).manual_seed(2), device=card)
    whole = [_pad(a, n_pad) for a in attn_grad.slab_attention_bwd_mh(
        pair, x, ad, as_, m, s, t, g)]
    per_node = [_pad(a, n_pad) for a in (x, ad, as_, m, s, t, g)]
    counter = (attn_grad.onepass_bwd_shard if r_blk == 128 else
               attn_grad.slab_attention_bwd_shard if heads == 1 else
               attn_grad.slab_attention_bwd_mh_shard)
    for rank in range(WORLD):
        shard, args, mag_args = _shard_bwd_args(pair, rank, rs, n_pad, per_node)
        before = counter.launches
        got = attn_grad.slab_attention_bwd_mh_shard(shard, *args)
        want = attn_grad.slab_attention_bwd_shard_ref(shard, *args)
        mag = attn_grad.slab_attention_bwd_shard_ref(shard, *mag_args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        rows = slice(rank * rs, (rank + 1) * rs)
        for a, b, c, w in zip(got, want, mag, whole):
            _assert_close_to(a, b, c)
            _assert_close_to(a, w[rows], c)
        for a, b in zip(got, attn_grad.slab_attention_bwd_mh_shard(shard, *args)):
            assert torch.equal(_bits(a), _bits(b))


# -- the CSR SpMM's sized groups and split long rows, the one-pass backward's
# shared-memory windows (fallback edges in the same passes), the probe -------


def _csr_with_long_row(rng, n, f_rows_long=300):
    """~1.1 uniform slots per row, every fifth row empty, row 7 with
    ``f_rows_long`` slots (past the kernel's 64-slot split threshold) and
    -1 / past-the-end slots."""
    deg = np.where(np.arange(n) % 5 == 0, 0, rng.integers(1, 3, n))
    deg[7] = f_rows_long
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, len(dst))
    indptr, indices, _ = _native.build_csr(dst, src, n)
    indices[::13] = -1
    indices[5::17] = n + 3
    return indptr, indices


@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_spmm_long_rows_and_repeat(card, f, x_dtype, weighted):
    """The kernel at the main path's widths with empty rows, a row split over
    a block and -1 slots: a new output and accumulation into float32 and
    bfloat16 against the float32 sum (``_assert_sum_close``); two launches
    bit for bit equal."""
    rng = np.random.default_rng(500 + f + weighted)
    indptr, indices = _csr_with_long_row(rng, 1500)
    w = rng.uniform(0.5, 2.0, len(indices)).astype(np.float32) if weighted else None
    padded = build_padded_blocks(indptr, indices, edge_tile=128, weights=w, device=card)
    x = _x(rng, 1500, f, x_dtype, card)
    f32_sum = csr_spmm_ref(padded, x.float())
    magnitude = csr_spmm_ref(padded, x.float().abs())
    got = csr_spmm(padded, x)
    _assert_sum_close(got, f32_sum, magnitude)
    assert torch.equal(_bits(got), _bits(csr_spmm(padded, x)))
    for out_dtype in (torch.float32, torch.bfloat16):
        base = _x(rng, 1500, f, out_dtype, card)
        out = csr_spmm(padded, x, out=base.clone())
        _assert_sum_close(out, base.float() + f32_sum, base.float().abs() + magnitude)
        assert torch.equal(_bits(out), _bits(csr_spmm(padded, x, out=base.clone())))


def _ends_pair(card, r_blk=256, n=1100):
    """A pair (bit planes where 3R <= 1024, such as R = 256 and 320; else
    t_ell, such as R = 512 and 1024; always the band CSR by source) whose
    first and last blocks have clipped windows (n is not a multiple of R),
    with edges at rows 0 and n - 1, fallback edges and a spilled row."""
    rng = np.random.default_rng(77)
    dst = np.repeat(np.arange(n), 7)
    src = np.clip(dst + rng.integers(-250, 251, n * 7), 0, n - 1)
    src = np.where(rng.random(n * 7) < 0.15, rng.integers(0, n, n * 7), src)
    extra_dst = np.concatenate([np.zeros(40, np.int64), np.full(40, n - 1)])
    extra_src = np.concatenate([rng.integers(0, 200, 40), rng.integers(n - 200, n, 40)])
    indptr, indices, _ = _native.build_csr(np.concatenate([dst, extra_dst]),
                                           np.concatenate([src, extra_src]), n)
    pair = attn_grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk,
                                               max_k=24, device=card)
    assert (pair.t_ell is None) == (3 * r_blk <= 1024) and pair.t_rows is not None
    assert 0.0 < pair.fwd.band_fraction < 1.0
    return pair


@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_onepass_bwd_windows_repeat_and_probe(card, heads, f, x_dtype):
    """``onepass_bwd`` at R = 256 with clipped windows at both graph ends
    against its plain version (within 1e-5 plus 1e-5 of the sums over every
    term's magnitude); two launches bit for bit equal; the probe with every
    phase on equal to the kernel bit for bit (float32 x: each other variant
    also launches)."""
    pair = _ends_pair(card)
    n = pair.fwd.num_rows
    x, ad, as_, g = _attn_inputs(n, heads, f, x_dtype, card, seed=5)
    _, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, heads), generator=torch.Generator(card).manual_seed(6), device=card)
    args = (pair, x, ad, as_, m, s, t, g)
    got = attn_grad.onepass_bwd(*args)
    want = attn_grad.slab_attention_bwd_ref(*args)
    mag = attn_grad.slab_attention_bwd_ref(pair, x.float().abs(), ad, as_, m, s, -t.abs(),
                                           g.abs())
    for a, b, c in zip(got, want, mag):
        _assert_close_to(a, b, c)
    for a, b, c in zip(got, attn_grad.onepass_bwd(*args), attn_grad.onepass_bwd_probe(*args)):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a), _bits(c))
    if x_dtype == torch.float32:
        for phases in range(1, attn_grad.PROBE_ALL):
            attn_grad.onepass_bwd_probe(*args, phases=phases)
        torch.cuda.synchronize()


def test_onepass_bwd_shard_repeat(card):
    """The shard backward (its tables: real halos and remote rows) twice on
    the same inputs: bit for bit equal."""
    pair = _attention_pair(128, card)
    n = pair.fwd.num_rows
    rs, n_pad = _split(n, 128)
    x, ad, as_, g = _attn_inputs(n, 4, 64, torch.float32, card, seed=8)
    _, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, 4), generator=torch.Generator(card).manual_seed(9), device=card)
    per_node = [_pad(a, n_pad) for a in (x, ad, as_, m, s, t, g)]
    shard, args, _ = _shard_bwd_args(pair, 1, rs, n_pad, per_node)
    for a, b in zip(attn_grad.onepass_bwd_shard(shard, *args),
                    attn_grad.onepass_bwd_shard(shard, *args)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_t_ell_bwd_windows_repeat(card, heads, f, x_dtype):
    """A t_ell pair at R = 512 takes the window kernels (256-row tiles, band
    edges that reach past a tile's window read from global memory):
    ``slab_attention_bwd`` (H = 1) or ``slab_attention_bwd_mh`` with clipped
    windows at both graph ends against its plain version (within 1e-5 plus
    1e-5 of the sums over every term's magnitude); two launches bit for bit
    equal."""
    pair = _ends_pair(card, r_blk=512)
    assert attn_grad.backward_design(pair, f) == ("windows", 64, 256)
    # band edges longer than a tile (the far path)
    ptr, rows = pair.t_rowptr.cpu().numpy(), pair.t_rows.cpu().numpy()
    assert (np.abs(rows - np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))) > 256).any()
    n = pair.fwd.num_rows
    x, ad, as_, g = _attn_inputs(n, heads, f, x_dtype, card, seed=16)
    _, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, heads), generator=torch.Generator(card).manual_seed(17), device=card)
    args = (pair, x, ad, as_, m, s, t, g)
    counter = attn_grad.slab_attention_bwd if heads == 1 else attn_grad.slab_attention_bwd_mh
    before = counter.launches
    got = attn_grad.slab_attention_bwd_mh(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = attn_grad.slab_attention_bwd_ref(*args)
    mag = attn_grad.slab_attention_bwd_ref(pair, x.float().abs(), ad, as_, m, s, -t.abs(),
                                           g.abs())
    for a, b, c in zip(got, want, mag):
        _assert_close_to(a, b, c)
    for a, b in zip(got, attn_grad.slab_attention_bwd_mh(*args)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_onepass_bwd_tiles_across_blocks(card, heads, f, x_dtype):
    """A bit-plane pair at R = 320, whose window of 64-element chunks does
    not fit: 256-row tiles that span two of the pair's blocks, band edges
    past a tile's window read from global memory.  ``onepass_bwd`` with
    clipped windows at both graph ends, and ``onepass_bwd_shard`` on each
    shard of a 4-rank split (three blocks a shard; the last one padding
    rows only, with no band edges), against their plain versions (within
    1e-5 plus 1e-5 of the sums over every term's magnitude); each launched
    twice, bit for bit equal."""
    r_blk = 320
    pair = _ends_pair(card, r_blk=r_blk, n=2600)
    assert attn_grad.backward_design(pair, f) == ("windows", 64, 256)
    ptr, rows = pair.t_rowptr.cpu().numpy(), pair.t_rows.cpu().numpy()
    assert (np.abs(rows - np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))) > 256).any()
    n = pair.fwd.num_rows
    x, ad, as_, g = _attn_inputs(n, heads, f, x_dtype, card, seed=20)
    _, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, heads), generator=torch.Generator(card).manual_seed(21), device=card)
    args = (pair, x, ad, as_, m, s, t, g)
    before = attn_grad.onepass_bwd.launches
    got = attn_grad.onepass_bwd(*args)
    torch.cuda.synchronize()
    assert attn_grad.onepass_bwd.launches == before + 1
    want = attn_grad.slab_attention_bwd_ref(*args)
    mag = attn_grad.slab_attention_bwd_ref(pair, x.float().abs(), ad, as_, m, s, -t.abs(),
                                           g.abs())
    for a, b, c in zip(got, want, mag):
        _assert_close_to(a, b, c)
    for a, b in zip(got, attn_grad.onepass_bwd(*args)):
        assert torch.equal(_bits(a), _bits(b))
    rs, n_pad = _split(n, r_blk)
    assert rs == 3 * r_blk
    per_node = [_pad(a, n_pad) for a in (x, ad, as_, m, s, t, g)]
    for rank in range(WORLD):
        shard, args, mag_args = _shard_bwd_args(pair, rank, rs, n_pad, per_node)
        assert (shard.t_rows.numel() == 0) == (rank == WORLD - 1)
        before = attn_grad.onepass_bwd_shard.launches
        got = attn_grad.onepass_bwd_shard(shard, *args)
        torch.cuda.synchronize()
        assert attn_grad.onepass_bwd_shard.launches == before + 1
        want = attn_grad.slab_attention_bwd_shard_ref(shard, *args)
        mag = attn_grad.slab_attention_bwd_shard_ref(shard, *mag_args)
        for a, b, c in zip(got, want, mag):
            _assert_close_to(a, b, c)
        for a, b in zip(got, attn_grad.onepass_bwd_shard(shard, *args)):
            assert torch.equal(_bits(a), _bits(b))


def _bwd_modes_match_plain(pair, heads, f, x_dtype, card, seed):
    """The backward kernel on ``pair`` in both compute modes against its
    plain version with the same ``compute_dtype`` (stats from the plain
    forward): within 1e-5 plus 1e-5 of the sums over every term's magnitude;
    the wrapper's counter moves by one a call; two launches bit for bit
    equal; the float32 mode (the default) equals an explicit float32 bit for
    bit, and the bfloat16 mode differs from it."""
    n = pair.fwd.num_rows
    x, ad, as_, g = _attn_inputs(n, heads, f, x_dtype, card, seed=seed)
    _, m, s = slab_attention_spmm_mh_ref(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, heads), generator=torch.Generator(card).manual_seed(seed + 1),
                    device=card)
    args = (pair, x, ad, as_, m, s, t, g)
    counter = (attn_grad.onepass_bwd if pair.t_ell is None else attn_grad.slab_attention_bwd
               if heads == 1 else attn_grad.slab_attention_bwd_mh)
    mag = attn_grad.slab_attention_bwd_ref(pair, x.float().abs(), ad, as_, m, s, -t.abs(),
                                           g.abs())
    res = {}
    for compute in (torch.float32, torch.bfloat16):
        before = counter.launches
        got = attn_grad.slab_attention_bwd_mh(*args, compute_dtype=compute)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        want = attn_grad.slab_attention_bwd_ref(*args, compute_dtype=compute)
        for a, b, c in zip(got, want, mag):
            _assert_close_to(a, b, c)
        for a, b in zip(got, attn_grad.slab_attention_bwd_mh(*args, compute_dtype=compute)):
            assert torch.equal(_bits(a), _bits(b))
        res[compute] = got
    for a, b in zip(res[torch.float32], attn_grad.slab_attention_bwd_mh(*args)):
        assert torch.equal(_bits(a), _bits(b))
    assert not all(torch.equal(a, b) for a, b in zip(*res.values()))


@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
def test_t_ell_bwd_warp_per_node_past_the_window(card, heads, f):
    """At R = 1024 the window of 32-element chunks does not fit, so the t_ell
    pair takes the warp-per-node kernels; against the plain version (stats
    from the plain forward, whose kernel's window does not fit either), on
    float32 and bfloat16 x, in both compute modes."""
    pair = _ends_pair(card, r_blk=1024, n=2500)
    assert attn_grad.backward_design(pair, f) == ("warp_per_node", 0, 0)
    for seed, x_dtype in ((18, torch.float32), (20, torch.bfloat16)):
        _bwd_modes_match_plain(pair, heads, f, x_dtype, card, seed)


@pytest.mark.parametrize("r_blk", [128, 256, 320, 512])
@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_bwd_windows_bf16_compute_matches_plain(card, r_blk, heads, f, x_dtype):
    """The window kernels' bfloat16 compute mode (rows 6-8: the band edges'
    products on g, x and a rounded to bfloat16): tiles of the pair's rows
    at R = 128 and 256 (bit planes), 256-row tiles with band edges past the
    window at R = 320 (bit planes) and 512 (t_ell), with clipped windows at
    both graph ends; both compute modes as in the warp-per-node test."""
    pair = _ends_pair(card, r_blk=r_blk, n=2600 if r_blk == 320 else 1100)
    design, _, tile = attn_grad.backward_design(pair, f)
    assert design == "windows" and tile == min(r_blk, 256)
    _bwd_modes_match_plain(pair, heads, f, x_dtype, card, seed=30 + r_blk)


@pytest.mark.parametrize("r_blk", [128, 512, 1024])
def test_bwd_all_fallback_edges_unrounded(card, r_blk):
    """A graph whose every edge is a fallback edge (all sources beyond
    +-1024): the bfloat16 compute mode rounds nothing, so both modes give
    the same result bit for bit, in both designs."""
    n = 5000
    rng = np.random.default_rng(r_blk)
    dst = np.repeat(np.arange(n), 3)
    src = (dst + rng.integers(1500, 2000, dst.shape[0])) % n
    indptr, indices, _ = _native.build_csr(dst, src, n)
    pair = attn_grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk,
                                               device=card)
    assert not bool((pair.fwd.ell >= 0).any()) and pair.t_rows.numel() == 0
    assert attn_grad.backward_design(pair, 64)[0] == (
        "warp_per_node" if r_blk == 1024 else "windows")
    x, ad, as_, g = _attn_inputs(n, 4, 64, torch.float32, card, seed=40)
    _, m, s = slab_attention_spmm_mh_ref(pair.fwd, x, ad, as_, return_stats=True)
    t = torch.randn((n, 4), generator=torch.Generator(card).manual_seed(41), device=card)
    args = (pair, x, ad, as_, m, s, t, g)
    for a, b in zip(attn_grad.slab_attention_bwd_mh(*args),
                    attn_grad.slab_attention_bwd_mh(*args, compute_dtype=torch.bfloat16)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_slab_attention_fwd_windows_and_repeat(card, heads, f, x_dtype):
    """The forward at R = 256 with clipped windows at both graph ends (rows
    0 and n - 1 with 40 extra sources) against its plain version (out within
    1e-5 plus 1e-5 of the aggregate over |x|, m equal, s within 1e-5), both
    compute dtypes; two launches bit for bit equal."""
    pair = _ends_pair(card)
    n = pair.fwd.num_rows
    x, ad, as_, _ = _attn_inputs(n, heads, f, x_dtype, card, seed=12)
    for compute in (torch.float32, torch.bfloat16):
        out, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, compute_dtype=compute,
                                           return_stats=True)
        want, m_want, s_want = slab_attention_spmm_mh_ref(
            pair.fwd, x, ad, as_, compute_dtype=compute, return_stats=True)
        mag = slab_attention_spmm_mh_ref(pair.fwd, x.float().abs(), ad, as_,
                                         compute_dtype=compute)
        _assert_close_to(out, want, mag)
        assert torch.equal(m, m_want)
        torch.testing.assert_close(s, s_want, rtol=1e-5, atol=0)
        again = slab_attention_spmm_mh(pair.fwd, x, ad, as_, compute_dtype=compute,
                                       return_stats=True)
        for a, b in zip((out, m, s), again):
            assert torch.equal(_bits(a), _bits(b))


# -- hub rows and columns: more than 64 fallback edges ------------------------


def _hub_csr(n=1500, hub_row=700, hub_col=300, extra=80):
    """A banded CSR (6 sources per row within +-100, a tenth uniform) plus
    ``extra`` far sources into row ``hub_row`` and ``extra`` far destinations
    of column ``hub_col``: both more than 64 fallback edges at R = 128."""
    rng = np.random.default_rng(90)
    dst = np.repeat(np.arange(n), 6)
    src = np.clip(dst + rng.integers(-100, 101, n * 6), 0, n - 1)
    src = np.where(rng.random(n * 6) < 0.1, rng.integers(0, n, n * 6), src)
    dst = np.concatenate([dst, np.full(extra, hub_row), rng.integers(1000, n, extra)])
    src = np.concatenate([src, rng.integers(0, 400, extra), np.full(extra, hub_col)])
    return _native.build_csr(dst, src, n)[:2]


@pytest.mark.parametrize("f", [128, 256, 47])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_slab_spmm_hub_rows(card, f, x_dtype, reduce):
    """The whole function over the hub graph and its transpose (a row of
    more than 64 fallback slots, taken by the whole CTA) against the plain
    version's float32 sum (``_assert_sum_close``); two launches bit for bit
    equal."""
    indptr, indices = _hub_csr()
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    t_indptr, t_indices, _ = _native.build_csr(indices, rows, n)
    x = _x(np.random.default_rng(f), n, f, x_dtype, card)
    for ip, ix in ((indptr, indices), (t_indptr, t_indices)):
        g = build_slab_graph(ip, ix, block_rows=128, device=card)
        assert int((g.fb_rowptr[1:] - g.fb_rowptr[:-1]).max()) > 64
        got = slab_spmm(g, x, reduce, torch.float32)
        _assert_sum_close(got, slab_spmm_ref(g, x.float(), reduce, torch.float32),
                          slab_spmm_ref(g, x.float().abs(), reduce, torch.float32))
        assert torch.equal(_bits(got), _bits(slab_spmm(g, x, reduce, torch.float32)))


@pytest.mark.parametrize("r_blk", [128, 512])
@pytest.mark.parametrize("heads,f", SHARD_ATTN_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_attention_hub_row_and_column(card, r_blk, heads, f, x_dtype):
    """The hub graph at R = 128 (bit planes: ``onepass_bwd``) and R = 512
    (t_ell: ``slab_attention_bwd(_mh)``, also over the window kernels): the
    forward (at R = 128 a row of more than 64 fallback edges) against its
    plain version, and the backward (a column of more than 64 fallback
    in-edges, taken by the whole CTA) against ``slab_attention_bwd_ref``,
    each within 1e-5 plus 1e-5 of the sums over every term's magnitude;
    each launched twice, bit for bit equal."""
    indptr, indices = _hub_csr()
    pair = attn_grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk,
                                               device=card)
    if r_blk == 128:
        assert pair.t_ell is None
        assert int((pair.fwd.fb_rowptr[701] - pair.fwd.fb_rowptr[700]).cpu()) > 64
        counter = attn_grad.onepass_bwd
    else:
        assert pair.t_ell is not None
        assert attn_grad.backward_design(pair, f) == ("windows", 64, 256)
        counter = attn_grad.slab_attention_bwd if heads == 1 else attn_grad.slab_attention_bwd_mh
    assert int((pair.fb_t_rowptr[301] - pair.fb_t_rowptr[300]).cpu()) > 64
    n = pair.fwd.num_rows
    x, ad, as_, g = _attn_inputs(n, heads, f, x_dtype, card, seed=14)
    out, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    want, m_want, s_want = slab_attention_spmm_mh_ref(pair.fwd, x, ad, as_,
                                                      return_stats=True)
    _assert_close_to(out, want, slab_attention_spmm_mh_ref(pair.fwd, x.float().abs(), ad, as_))
    assert torch.equal(m, m_want)
    torch.testing.assert_close(s, s_want, rtol=1e-5, atol=0)
    for a, b in zip((out, m, s), slab_attention_spmm_mh(pair.fwd, x, ad, as_,
                                                        return_stats=True)):
        assert torch.equal(_bits(a), _bits(b))
    t = torch.randn((n, heads), generator=torch.Generator(card).manual_seed(15), device=card)
    args = (pair, x, ad, as_, m, s, t, g)
    before = counter.launches
    got = attn_grad.slab_attention_bwd_mh(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = attn_grad.slab_attention_bwd_ref(*args)
    mag = attn_grad.slab_attention_bwd_ref(pair, x.float().abs(), ad, as_, m, s, -t.abs(),
                                           g.abs())
    for a, b, c in zip(got, ref, mag):
        _assert_close_to(a, b, c)
    for a, b in zip(got, attn_grad.slab_attention_bwd_mh(*args)):
        assert torch.equal(_bits(a), _bits(b))


def _segment_case(rng, n, e, width, dtype, weighted, card):
    """Ids with -1 and out-of-range entries and one row of 200 slots, their
    values and an accumulator; returns (ids, weights, values, base)."""
    ids = rng.integers(-1, n + 50, e)
    ids[rng.permutation(e)[:200]] = 7                   # more than 64 slots
    w = torch.as_tensor(rng.standard_normal(e), dtype=torch.float32,
                        device=card) if weighted else None
    vals = _x(rng, e, width, dtype, card)
    base = torch.as_tensor(rng.standard_normal((n, width)), dtype=torch.float32, device=card)
    return torch.as_tensor(ids, device=card), w, vals, base


@pytest.mark.parametrize("width", [1, 4, 48, 260])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_add_matches_plain(card, width, dtype, out_dtype, weighted):
    """The sharded path's fixed-order sum (``segment_plan`` + the CSR kernel
    in accumulate mode) against index_add_ in float32: ids of -1 and past
    the rows are dropped, a 200-slot row takes the long-row launch, bf16
    values sum into a float32 (or bfloat16) output; launched twice, bit for
    bit equal."""
    from cugraph_gnn_tpu_torch.store.dist_array import segment_add, segment_plan

    n, e = 3000, 20000
    ids, w, vals, base = _segment_case(np.random.default_rng(width), n, e, width, dtype,
                                       weighted, card)
    base = base.to(out_dtype)
    plan = segment_plan(ids, n, w)
    before = csr_spmm.launches
    got = segment_add(base.clone(), plan, vals)
    assert csr_spmm.launches == before + 1
    ok = (ids >= 0) & (ids < n)
    terms = vals[ok].float() * (1 if w is None else w[ok][:, None])
    want = base.to(torch.float32, copy=True).index_add_(0, ids[ok], terms)
    mag = base.float().abs().index_add_(0, ids[ok], terms.abs())
    _assert_sum_close(got, want, mag)
    assert torch.equal(_bits(got), _bits(segment_add(base.clone(), plan, vals)))


@pytest.fixture
def world1(card):
    """A world-1 NCCL mesh on the card (``tcp://localhost``, a free port)."""
    import socket

    from cugraph_gnn_tpu_torch.utils import distributed as D

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh = D.init(init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield mesh
    finally:
        D.finalize()


@pytest.mark.parametrize("width", [1, 4, 48, 260])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_dist_scatter_add_matches_plain(world1, width, table_dtype):
    """``_dist_scatter_shard`` "add" at world 1 (float32 values into a
    float32 or bfloat16 table, ids of -1 and past the table dropped), and
    the same sum through a plan built once (``scatter_add_plan`` +
    ``_dist_scatter_add``): equal to each other bit for bit, over two runs,
    and to index_add_ in float32 within the sum tolerance."""
    from cugraph_gnn_tpu_torch.store.dist_array import (
        _dist_scatter_add,
        _dist_scatter_shard,
        scatter_add_plan,
    )
    from cugraph_gnn_tpu_torch.store.partition import PartitionBook

    n, e = 3000, 20000
    card = world1.device
    ids, _, vals, table = _segment_case(np.random.default_rng(width + 1), n, e, width,
                                        torch.float32, False, card)
    table = table.to(table_dtype)
    book = PartitionBook.even(n, 1)
    got = _dist_scatter_shard(table, ids, vals, book=book, mesh=world1, mode="add")
    assert got.dtype == table_dtype and got.data_ptr() != table.data_ptr()
    plan = scatter_add_plan(ids, n, book=book, mesh=world1)
    for _ in range(2):
        again = _dist_scatter_add(table.clone(), vals, plan, mesh=world1)
        assert torch.equal(_bits(got), _bits(again))
    ok = (ids >= 0) & (ids < n)
    terms = vals[ok].to(table_dtype).float()      # the values take the table's type first
    want = table.to(torch.float32, copy=True).index_add_(0, ids[ok], terms)
    mag = table.float().abs().index_add_(0, ids[ok], terms.abs())
    _assert_sum_close(got, want, mag)


# -- the embeddings: dedup sums (row 3) and cache slot reads (row 1) ----------------

@pytest.mark.parametrize("f", [128, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dedup_ids_grads_matches_plain(card, f, dtype):
    """``dedup_ids_grads`` on the card (the CSR kernel through
    ``segment_add``) against its plain version on the CPU: ids equal, -1
    ignored, one hot id repeated 10,000 times; sums within the sum
    tolerance; two launches bit for bit equal."""
    from cugraph_gnn_tpu_torch.embedding import dedup_ids_grads

    rng = np.random.default_rng(f)
    ids = rng.integers(0, 50_000, 30_000)
    ids[:10_000] = 7
    ids[10_000:12_000] = -1
    ids = torch.as_tensor(rng.permutation(ids))
    grads = torch.as_tensor(rng.standard_normal((30_000, f)), dtype=torch.float32).to(dtype)
    want_ids, want = dedup_ids_grads(ids, grads.float())
    _, mag = dedup_ids_grads(ids, grads.float().abs())
    csr_spmm.launches = 0
    got_ids, got = dedup_ids_grads(ids.to(card), grads.to(card))
    _, again = dedup_ids_grads(ids.to(card), grads.to(card))
    assert csr_spmm.launches == 2
    assert torch.equal(got_ids.cpu(), want_ids) and int((got_ids >= 0).sum()) < 30_000
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(again))
    _assert_sum_close(got.cpu(), want, mag)


def test_cache_slot_read_bit_equal(card):
    """A ``HostManagedCache``'s slot read: the row-gather kernel over the
    rows viewed as (sets * ways, F), -1 a zero row, bit-equal to indexing;
    an int64 column is read by indexing (no launch)."""
    from cugraph_gnn_tpu_torch.embedding import HostManagedCache
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows

    rng = np.random.default_rng(1)
    host = rng.standard_normal((5000, 128)).astype(np.float32)
    cache = HostManagedCache(host, 1024, ways=8, device=card)
    cache.gather(rng.integers(0, 5000, 3000))
    slots = torch.as_tensor(rng.integers(-1, cache.sets * cache.ways, 4001), device=card)
    gather_rows.launches = 0
    got = read_rows(cache._flat, slots)
    assert gather_rows.launches == 1
    want = torch.where((slots >= 0)[:, None], cache._flat[slots.clamp(min=0)], 0)
    assert torch.equal(_bits(got), _bits(want))
    labels = HostManagedCache(rng.integers(0, 2**40, (5000, 1)), 256, device=card)
    ids = rng.integers(-1, 5000, 700)
    np.testing.assert_array_equal(labels.gather(ids).cpu().numpy()[:, 0],
                                  np.where(ids >= 0, labels.host_rows[ids, 0], 0))
    assert gather_rows.launches == 1


def test_host_managed_cache_card_matches_cpu(card):
    """A cache round on the card and on the CPU: batches that evict, an
    update that dirties cached rows and writes others through, a prefetched
    gather, a flush: equal rows, metadata and host rows."""
    from cugraph_gnn_tpu_torch.embedding import HostManagedCache

    rng = np.random.default_rng(2)
    host = rng.standard_normal((4000, 64)).astype(np.float32)
    caches = [HostManagedCache(host.copy(), 512, ways=8, device=d) for d in ("cpu", card)]
    for step in range(6):
        ids = rng.integers(-1, 2000, 900)
        new = rng.standard_normal((300, 64)).astype(np.float32)
        upd = rng.choice(2000, 300, replace=False)
        rows = []
        for c in caches:
            if step % 2:
                c.prefetch(torch.as_tensor(ids, device=c.device))
            rows.append(c.gather(torch.as_tensor(ids, device=c.device)).cpu())
            c.update(upd, torch.as_tensor(new, device=c.device))
        assert torch.equal(_bits(rows[0]), _bits(rows[1]))
        for name in ("tags", "freq", "modified"):
            np.testing.assert_array_equal(getattr(caches[0], name), getattr(caches[1], name))
        assert caches[0].hits == caches[1].hits and caches[0].misses == caches[1].misses
    assert caches[1].written_back > 0
    for c in caches:
        c.flush()
    np.testing.assert_array_equal(caches[0].host_rows, caches[1].host_rows)


def test_device_lfu_cache_overfilled_set_on_card(card):
    """``DeviceLFUCache`` with more than ``ways`` misses in one set and -1
    pads, on the card: every gathered row and a later hit equal the host
    rows, the metadata equals a CPU run's, and two card runs are bit for bit
    equal (each insert of a batch has its own slot)."""
    from cugraph_gnn_tpu_torch.embedding.cache import DeviceLFUCache

    host = np.random.default_rng(3).standard_normal((3000, 64)).astype(np.float32)
    runs = []
    for dev in (card, card, torch.device("cpu")):
        cache = DeviceLFUCache(host, capacity=64, ways=8, device=dev)
        sets = cache._set_of(torch.arange(3000)).numpy()
        crowded = np.nonzero(sets == 0)[0]
        rng = np.random.default_rng(4)
        rows = []
        for _ in range(4):
            ids = np.concatenate([rng.choice(crowded, 3 * cache.ways, replace=False),
                                  rng.integers(0, 3000, 100), [-1] * 9])
            ids[::7] = -1
            ids = torch.as_tensor(rng.permutation(ids), device=dev)
            got = cache.gather(ids)
            want = np.where((ids >= 0).cpu().numpy()[:, None],
                            host[ids.clamp(min=0).cpu().numpy()], 0)
            assert torch.equal(got.cpu(), torch.as_tensor(want))
            tags = cache.tags.cpu().numpy()
            cached = torch.as_tensor(tags[tags >= 0], device=dev)
            hits = cache.hits
            again = cache.gather(cached)
            assert cache.hits == hits + cached.numel()
            assert torch.equal(again.cpu(), torch.as_tensor(host[cached.cpu().numpy()]))
            rows.append(got.cpu())
        runs.append((rows, cache.rows.cpu(), cache.tags.cpu(), cache.freq.cpu()))
    (r1, rows1, tags1, freq1), (r2, rows2, tags2, freq2), (_, _, tags_c, freq_c) = runs
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(r1, r2))
    assert torch.equal(_bits(rows1), _bits(rows2)) and torch.equal(tags1, tags2)
    assert torch.equal(tags1, tags_c) and torch.equal(freq1, freq_c) and torch.equal(freq1, freq2)


def _fixed_negatives(loader):
    """Make ``loader`` draw its negatives' candidates from a fresh CPU
    generator every batch, moved to its device."""
    from cugraph_gnn_tpu_torch.loader.link_loader import draw_negatives
    from cugraph_gnn_tpu_torch.sampler.negative import NegativeDraws, draw_candidates

    def negatives(ps, n_neg):
        draws = draw_candidates(loader.num_src, loader.num_dst, n_neg, loader.neg,
                                pinned_src=loader.neg.mode == "triplet",
                                rejection=loader._edge_key_sorted is not None,
                                generator=torch.Generator().manual_seed(12), device="cpu")
        draws = NegativeDraws(*(None if d is None else d.to(loader.device) for d in draws))
        return draw_negatives(ps, n_neg, loader.num_src, loader.num_dst, loader.neg,
                              loader._edge_key_sorted, draws=draws, device=loader.device)

    loader._negatives = negatives


@pytest.mark.parametrize("mode", ["binary", "triplet"])
def test_link_loader_batch_card_matches_cpu(card, mode):
    """Two batches of ``LinkNeighborLoader`` (rejecting true edges) on the
    card and on the CPU with the same negatives' candidates and uniforms:
    seeds, labels, levels, maps and gathered rows equal; 2 sampler launches
    and 1 row-gather launch a batch on the card."""
    from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader

    rng = np.random.default_rng(6)
    indptr, indices = _graph(rng, n=3000)
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    x = rng.standard_normal((n, 40)).astype(np.float32)
    pick = rng.choice(len(rows), 700, replace=False)
    eli = np.stack([rows[pick], indices[pick]])
    out = []
    for dev in (card, torch.device("cpu")):
        gs, fs = GraphStore(device=dev), FeatureStore(device=dev)
        gs.put_edge_index((indices, rows), ("n", "to", "n"), num_nodes=(n, n))
        fs["x"] = x
        loader = LinkNeighborLoader((fs, gs), (10, 5), eli, neg_sampling=mode,
                                    batch_size=256, shuffle=True, reject_true_edges=True)
        loader.sampler = _FixedDraws(loader.sampler)
        _fixed_negatives(loader)
        before = (gather_rows.launches, fused_uniform_sample.launches)
        batches = [b for _, b in zip(range(2), loader)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (gather_rows.launches, fused_uniform_sample.launches) == (
                before[0] + 2, before[1] + 4)
        out.append(batches)
    for got, want in zip(*out):
        s, w = got.sample, want.sample
        for a, b in zip([got.seeds, got.edge_label_index, got.edge_label, got.input_id, got.x]
                        + s.levels + s.level_counts,
                        [want.seeds, want.edge_label_index, want.edge_label, want.input_id,
                         want.x] + w.levels + w.level_counts):
            assert torch.equal(a.cpu(), b)
        for ha, hb in zip(s.hops, w.hops):
            for a, b in zip(ha[:3], hb[:3]):
                assert torch.equal(a.cpu(), b)


def test_gin_full_graph_card_matches_plain(card):
    """GIN's ``full_graph`` on the card (row 4 with 'sum' over the graph,
    forward, and over its transpose, backward, down to x) against the same model on the
    CPU (the plain versions): the 'sum' aggregate within 1e-5 + 1e-5 x the
    terms' magnitude sum, the outputs and input gradients within 1e-4."""
    from cugraph_gnn_tpu_torch.models.zoo import GIN
    from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph

    rng = np.random.default_rng(8)
    n = 3000
    dst = np.repeat(np.arange(n), 8)
    src = np.clip(dst + rng.integers(-100, 101, n * 8), 0, n - 1)
    src[::9] = rng.integers(0, n, src[::9].shape[0])      # fallback edges
    x = torch.as_tensor(rng.standard_normal((n, 32)).astype(np.float32))
    torch.manual_seed(0)
    cpu_model = GIN(32, 64, 7, device="cpu")
    res = {}
    for dev in (card, torch.device("cpu")):
        fbg = FullBatchGraph.from_coo(src, dst, n, reorder="none", block_rows=128, device=dev)
        model = GIN(32, 64, 7, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        xd = x.to(dev).requires_grad_(True)
        slab_spmm.launches = 0
        agg = fbg.spmm(xd.detach(), reduce="sum")
        mag = fbg.spmm(xd.detach().abs(), reduce="sum")
        out = model.full_graph(xd, fbg)
        out.square().sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            # the two checks, 2 forward, 2 backward (x requires a gradient)
            assert slab_spmm.launches == 2 + 2 + 2
        res[dev.type] = (agg.cpu(), mag.cpu(), out.detach().cpu(), xd.grad.cpu())
    (agg, _, out, gx), (agg_c, mag_c, out_c, gx_c) = res["cuda"], res["cpu"]
    assert bool(((agg - agg_c).abs() <= 1e-5 + 1e-5 * mag_c).all())
    torch.testing.assert_close(out, out_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gx, gx_c, rtol=1e-4, atol=1e-4)


def _keyed_case(rng, n=3000):
    indptr, indices = _graph(rng, n=n)
    e = int(indptr[-1])
    w = rng.uniform(0.05, 2.0, e).astype(np.float32)
    w[rng.random(e) < 0.2] = 0
    times = rng.integers(0, 100, e).astype(np.int32)
    seeds = rng.integers(0, n, 4000).astype(np.int32)
    seeds[::37] = -1
    seeds[:3] = 7                                     # the 17,000-edge hub
    return indptr, indices, w, times, seeds, rng.integers(0, 100, 4000).astype(np.int32)


def _score_gaps(indptr, w, seeds, key, k, times=None, seed_time=None):
    """Per seed, the smallest gap between the k + 1 best Gumbel scores (the
    CPU's), so that rows where a last-ulp log difference could swap two
    scores are compared as sets."""
    from cugraph_gnn_tpu_torch.ops.sample import edge_uniform, gumbel_from_uniform

    gaps = np.full(len(seeds), np.inf)
    for i, s in enumerate(seeds):
        if s < 0:
            continue
        e = torch.arange(int(indptr[s]), int(indptr[s + 1]))
        g = gumbel_from_uniform(edge_uniform(e, torch.tensor(int(key[0])),
                                             torch.tensor(int(key[1])))).numpy()
        sc = np.where(w[e] > 0, np.log(np.maximum(w[e], 1e-38)) + g, -np.inf)
        if times is not None:
            sc = np.where(times[e] <= seed_time[i], sc, -np.inf)
        top = np.sort(sc[np.isfinite(sc)])[::-1][:k + 1]
        if len(top) > 1:
            gaps[i] = (-np.diff(top)).min()
    return gaps


@pytest.mark.parametrize("case", ["weighted", "weighted_timed", "masked", "per_seed_keys"])
def test_keyed_samplers_card_match_cpu(card, case):
    """``weighted_sample`` / ``masked_uniform_sample`` on the card and on the
    CPU with the same key words, at 4,000 seeds with -1 pads and the
    17,000-edge hub, max_degree below it: neighbors, edge ids and counts
    equal (Gumbel rows whose best scores lie within 1e-5 as sets), and two
    runs on the card bit for bit."""
    from cugraph_gnn_tpu_torch.ops.sample import masked_uniform_sample, weighted_sample

    rng = np.random.default_rng(21)
    indptr, indices, w, times, seeds, seed_time = _keyed_case(rng)
    key = np.array([0x9E3779B9, 0x7F4A7C15], np.int64)
    if case == "per_seed_keys":
        key = rng.integers(0, 2**32, (len(seeds), 2))
    kw = dict(max_degree=12_000, chunk=256)
    if case in ("weighted_timed", "masked"):
        kw.update(edge_times=times, seed_time=seed_time)
    out = []
    for dev in (card, card, torch.device("cpu")):
        if case == "masked":
            o = masked_uniform_sample(indptr, indices, seeds, 10, hash_key=key, device=dev, **kw)
        else:
            o = weighted_sample(indptr, indices, w, seeds, 10, hash_key=key, device=dev, **kw)
        out.append([t.cpu() for t in o])
    a, b, cpu = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[2], cpu[2])
    if case in ("masked", "per_seed_keys"):
        assert all(torch.equal(x, y) for x, y in zip(a, cpu))
    else:
        gaps = _score_gaps(indptr, w, seeds, key, 10, kw.get("edge_times"), seed_time)
        exact = gaps > 1e-5
        assert exact.mean() > 0.99
        for x, y in zip(a[:2], cpu[:2]):
            assert torch.equal(x[exact], y[exact])
            assert torch.equal(x.sort(dim=1).values, y.sort(dim=1).values)
    hub = a[1][0].numpy()      # seed 7: ten edges, all inside JAX's scanned positions
    assert (hub >= 0).all() and (hub - indptr[7] < 12_032).all()


class _KeyedDraws:
    """A loader's sampler whose draws are given, batch after batch: the same
    CPU uniforms and key words (one per seed when disjoint) on either
    device."""

    def __init__(self, inner):
        self.inner = inner
        self.fanouts = inner.fanouts

    def sample(self, seeds, node_times=None, generator=None):
        g = torch.Generator().manual_seed(17)
        caps = self.inner.level_caps(seeds.shape[0])
        rows = seeds.shape[0] if hasattr(self.inner, "base") else 1
        u = [torch.rand((caps[h] * rows, k), generator=g) for h, k in enumerate(self.fanouts)]
        keys = [torch.randint(0, 2**32, (rows, 2) if rows > 1 else (2,), generator=g)
                for _ in self.fanouts]
        return self.inner.sample(seeds, node_times, u=u, hash_keys=keys)


@pytest.mark.parametrize("kw", [dict(weight_attr="w"), dict(time_attr="t"),
                                dict(weight_attr="w", time_attr="t"), dict(disjoint=True),
                                dict(disjoint=True, weight_attr="w", time_attr="t")],
                         ids=["weighted", "temporal", "weighted_temporal", "disjoint",
                              "disjoint_weighted_temporal"])
def test_sampling_variants_loader_card_matches_cpu(card, kw):
    """Two ``NeighborLoader`` batches with weights, times and disjoint
    subgraphs on the card and on the CPU with the same draws: seeds, levels,
    maps, edge ids and gathered rows equal; one row-gather launch a batch on
    the card, and two sampler launches a batch where the hops are uniform."""
    rng = np.random.default_rng(9)
    indptr, indices = _graph(rng, n=3000)
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    e = len(indices)
    x = rng.standard_normal((n, 40)).astype(np.float32)
    w = rng.uniform(0, 2, e).astype(np.float32)
    t = rng.integers(0, 50, e)
    input_time = rng.integers(0, 50, n)
    out = []
    for dev in (card, torch.device("cpu")):
        gs, fs = GraphStore(device=dev), FeatureStore(device=dev)
        gs.put_edge_index((indices, rows), ("n", "to", "n"), num_nodes=(n, n))
        fs["x"], fs["w"], fs["t"] = x, w, t
        extra = dict(input_time=input_time) if "time_attr" in kw else {}
        loader = NeighborLoader((fs, gs), (10, 5), batch_size=128 if kw.get("disjoint") else 512,
                                shuffle=True, **kw, **extra)
        loader.sampler = _KeyedDraws(loader.sampler)
        before = (gather_rows.launches, fused_uniform_sample.launches)
        batches = [b for _, b in zip(range(2), loader)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            uniform_hops = 0 if ("weight_attr" in kw or "time_attr" in kw) else 4
            assert (gather_rows.launches, fused_uniform_sample.launches) == (
                before[0] + 2, before[1] + uniform_hops)
        out.append(batches)
    for got, want in zip(*out):
        s, ws = got.sample, want.sample
        for a, b in zip([got.seeds, got.input_id, got.x] + s.levels + s.level_counts,
                        [want.seeds, want.input_id, want.x] + ws.levels + ws.level_counts):
            assert torch.equal(a.cpu(), b)
        for ha, hb in zip(s.hops, ws.hops):
            for a, b in zip(ha[:3], hb[:3]):
                assert torch.equal(a.cpu(), b)


# -- the hetero paths ------------------------------------------------------------

_SMALL_MAG = {"paper": 3000, "author": 4000, "field": 300}


def _mag_on(graph, dev):
    """A ``train_hetero.SyntheticMag`` with its tensors moved to ``dev``."""
    from cugraph_gnn_tpu_torch.train_hetero import SyntheticMag

    return SyntheticMag({n: (a.to(dev), b.to(dev)) for n, (a, b) in graph.csrs.items()},
                        graph.edge_bases, graph.max_degrees, graph.num_edges,
                        graph.num_nodes, graph.feats.to(dev), graph.labels.to(dev))


def _draws_like(sample, seed):
    """CPU uniforms shaped as every (hop, edge type) block of ``sample``."""
    g = torch.Generator().manual_seed(seed)
    return [{n: torch.rand((b.neigh_local.shape[:-1].numel(), b.neigh_local.shape[-1]),
                           generator=g) for n, b in hop.items()} for hop in sample.hops]


def test_hetero_block_card_matches_cpu(card):
    """The typed R-GCN block (``train_hetero``) at a small mag shape on the
    card and on the CPU with the same seeds and uniforms: every level,
    block and gathered row bit-equal, 6 sampler launches for the block and
    1 row-gather launch a step, three f32 steps' losses within 1e-4."""
    from cugraph_gnn_tpu_torch import train_hetero as TH
    from cugraph_gnn_tpu_torch.models.zoo import RGCN
    from cugraph_gnn_tpu_torch.sampler.hetero import hetero_multihop_batched

    cpu = TH.make_synthetic_mag(3, "cpu", num_nodes=_SMALL_MAG, feat_dim=32, classes=7)
    seeds = torch.randint(0, _SMALL_MAG["paper"], (3, 64), generator=torch.Generator()
                          .manual_seed(4), dtype=torch.int32)
    seeds[:, ::9] = -1
    u = _draws_like(hetero_multihop_batched(seeds, generator=torch.Generator().manual_seed(0),
                                            device="cpu", **cpu.sampler_args()), 5)
    torch.manual_seed(0)
    ref = RGCN(32, num_relations=3, hidden_features=64, out_features=7, device="cpu")
    res = []
    for dev in (card, torch.device("cpu")):
        g = _mag_on(cpu, dev)
        before = (gather_rows.launches, fused_uniform_sample.launches)
        sample = hetero_multihop_batched(seeds.to(dev), u=[{n: a.to(dev) for n, a in h.items()}
                                                           for h in u],
                                         device=dev, **g.sampler_args())
        model = RGCN(32, num_relations=3, hidden_features=64, out_features=7, device=dev)
        model.load_state_dict(ref.state_dict())
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        xs, losses = [], []
        for i in range(3):
            st = sample.step(i)
            xs.append(TH.gather_features(st, g.feats, torch.float32))
            losses.append(float(TH.rgcn_step(model, opt, xs[-1], st, g.labels)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (gather_rows.launches, fused_uniform_sample.launches) == (
                before[0] + 3, before[1] + 6)
        res.append((sample, xs, losses))
    (s, xs, losses), (sc, xc, lc) = res
    assert s.layouts == sc.layouts
    assert [lv.shape[1] for lv in s.levels] == [64, 64 * 21, 64 * 21 + 64 * 9 * 20]
    for a, b in zip(s.levels + s.level_counts, sc.levels + sc.level_counts):
        assert torch.equal(a.cpu(), b)
    for ha, hb in zip(s.hops, sc.hops):
        for n in hb:
            for a, b in zip(ha[n][:3], hb[n][:3]):
                assert torch.equal(a.cpu(), b)
    for a, b in zip(xs, xc):
        assert torch.equal(_bits(a.cpu()), _bits(b))
    assert max(abs(a - b) for a, b in zip(losses, lc)) <= 1e-4


class _ListDraws:
    """A loader's sampler fed a given list of per-(hop, edge type) CPU
    uniforms, one entry a batch, moved to its device."""

    def __init__(self, inner, draws):
        self.inner, self.draws, self.calls = inner, draws, 0

    def sample(self, seeds, node_times=None, generator=None):
        u = [{n: a.to(seeds.device) for n, a in h.items()} for h in self.draws[self.calls]]
        self.calls += 1
        return self.inner.sample(seeds, node_times, u=u)


@pytest.mark.parametrize("dedup", [False, True], ids=["typed", "dedup"])
def test_hetero_loader_batch_card_matches_cpu(card, dedup):
    """Two hetero ``NeighborLoader`` batches (typed input ``("paper",
    ids)``) on the card and on the CPU with the same uniforms: seeds,
    labels, every type's feature rows, levels and blocks equal; 6 sampler
    launches and 3 row-gather launches (one per node type with ``x``) a
    batch on the card."""
    from cugraph_gnn_tpu_torch import train_hetero as TH

    cpu = TH.make_synthetic_mag(5, "cpu", num_nodes=_SMALL_MAG, feat_dim=32, classes=7)
    kw = dict(input_nodes=("paper", np.arange(1500)), batch_size=256, shuffle=True,
              dedup=dedup)
    first = NeighborLoader(TH.mag_stores(cpu, "cpu"), TH.FANOUTS, **kw)
    draws = [_draws_like(b.sample, 20 + i) for i, b in zip(range(2), first)]
    out = []
    for dev in (card, torch.device("cpu")):
        loader = NeighborLoader(TH.mag_stores(_mag_on(cpu, dev), dev), TH.FANOUTS, **kw)
        loader.sampler = _ListDraws(loader.sampler, draws)
        before = (gather_rows.launches, fused_uniform_sample.launches)
        batches = [b for _, b in zip(range(2), loader)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (gather_rows.launches, fused_uniform_sample.launches) == (
                before[0] + 6, before[1] + 12)
        out.append(batches)
    for got, want in zip(*out):
        s, w = got.sample, want.sample
        assert s.layouts == w.layouts and sorted(got.x) == sorted(want.x)
        for a, b in zip([got.seeds, got.y] + [got.x[k] for k in sorted(got.x)]
                        + s.levels + s.level_counts,
                        [want.seeds, want.y] + [want.x[k] for k in sorted(want.x)]
                        + w.levels + w.level_counts):
            assert torch.equal(a.cpu(), b)
        for ha, hb in zip(s.hops, w.hops):
            for n in hb:
                for a, b in zip(ha[n][:3], hb[n][:3]):
                    assert torch.equal(a.cpu(), b)


def test_relational_full_batch_card_matches_cpu(card):
    """Full-batch R-GCN (2 relations by endpoint parity) on the card (row 4
    per relation: 'mean' over its graph forward, 'sum' over its transpose
    backward) against the CPU: each relation's aggregate within 1e-5 + 1e-5
    x the terms' magnitude sum, the outputs and input gradients within 1e-4;
    2 checks + 4 forward + 4 backward launches (x requires a gradient)."""
    from cugraph_gnn_tpu_torch.models.zoo import RGCN
    from cugraph_gnn_tpu_torch.ops.full_batch import RelationalFullBatch

    rng = np.random.default_rng(10)
    n = 3000
    dst = np.repeat(np.arange(n), 8)
    src = np.clip(dst + rng.integers(-100, 101, n * 8), 0, n - 1)
    src[::9] = rng.integers(0, n, src[::9].shape[0])      # fallback edges
    et = (src + dst) % 2
    x = torch.as_tensor(rng.standard_normal((n, 32)).astype(np.float32))
    torch.manual_seed(0)
    ref = RGCN(32, num_relations=2, hidden_features=64, out_features=7, device="cpu")
    res = []
    for dev in (card, torch.device("cpu")):
        rfb = RelationalFullBatch(src, dst, et, 2, n, reorder="none", block_rows=128,
                                  device=dev)
        assert all(g.use_slab for g in rfb.graphs)
        model = RGCN(32, num_relations=2, hidden_features=64, out_features=7, device=dev)
        model.load_state_dict(ref.state_dict())
        xd = x.to(dev).requires_grad_(True)
        slab_spmm.launches = 0
        aggs = [g.spmm(xd.detach(), "mean") for g in rfb.graphs]
        mags = [g.spmm(xd.detach().abs(), "mean") for g in rfb.graphs]
        out = model.full_graph(xd, rfb)
        out.square().sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert slab_spmm.launches == 4 + 4 + 4
        res.append(([a.cpu() for a in aggs], mags, out.detach().cpu(), xd.grad.cpu()))
    (aggs, _, out, gx), (aggs_c, mags_c, out_c, gx_c) = res
    for a, b, m in zip(aggs, aggs_c, mags_c):
        assert bool(((a - b).abs() <= 1e-5 + 1e-5 * m).all())
    torch.testing.assert_close(out, out_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gx, gx_c, rtol=1e-4, atol=1e-4)


# -- the distributed loaders at world 1 over NCCL ------------------------------------

class _RecordDraws:
    """A one-device loader's sampler on CPU uniforms, kept with its levels."""

    def __init__(self, inner, seed):
        self.inner, self.fanouts = inner, inner.fanouts
        self.gen, self.last = torch.Generator().manual_seed(seed), None

    def sample(self, seeds, node_times=None, generator=None):
        caps = self.inner.level_caps(seeds.shape[0])
        u = [torch.rand((caps[h], k), generator=self.gen).to(seeds.device)
             for h, k in enumerate(self.fanouts)]
        batch = self.inner.sample(seeds, node_times, u=u)
        self.last = (u, batch.levels)
        return batch


class _FrameDraws:
    """A world-1 dist sampler on the recorded batch's draws at its valid
    targets (the owner's rows at world 1)."""

    def __init__(self, inner, record):
        self.inner, self.record, self.fanouts = inner, record, inner.fanouts

    def sample(self, seeds, node_times=None, generator=None):
        u, levels = self.record.last
        return self.inner.sample(seeds, node_times, u=[a[lv >= 0] for a, lv in zip(u, levels)])


def _dist_stores(dev, rng_seed=9, n=3000, local=False):
    rng = np.random.default_rng(rng_seed)
    indptr, indices = _graph(rng, n=n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    gs, fs = GraphStore(device=dev), FeatureStore(device=dev)
    put = gs.put_local_edge_index if local else gs.put_edge_index
    put((indices, rows), ("n", "to", "n"), num_nodes=(n, n))
    fs["x"] = rng.standard_normal((n, 24)).astype(np.float32)
    fs["y"] = rng.integers(0, 5, n)
    fs["w"] = rng.uniform(0.05, 1.0, len(rows)).astype(np.float32)
    fs["t"] = rng.integers(0, 100, len(rows)).astype(np.int32)
    return (fs, gs), np.stack([indices[::97], rows[::97]])


def _samples_equal(a, b):
    pairs = list(zip(a.levels + a.level_counts, b.levels + b.level_counts))
    pairs += [(x, y) for ha, hb in zip(a.hops, b.hops) for x, y in zip(ha[:3], hb[:3])]
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in pairs)


@pytest.mark.parametrize("dedup", [True, False])
def test_dist_loader_world1_matches_one_device(world1, dedup):
    """``DistNeighborLoader`` at world 1 over NCCL against ``NeighborLoader``
    on the same draws: samples, features and the valid seeds' labels bit for
    bit (pads -1), 1 row-gather and 2 sampler launches a batch, and three
    ``dist_train_step`` losses equal to the one-device step's."""
    from torch.nn import functional as F

    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader
    from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
    from cugraph_gnn_tpu_torch.train_dist import dist_train_step

    data, _ = _dist_stores(world1.device)
    single = NeighborLoader(data, (10, 5), batch_size=256, shuffle=True, dedup=dedup)
    dl = DistNeighborLoader(data, (10, 5), world1, batch_size=256, shuffle=True, dedup=dedup)
    single.sampler = _RecordDraws(single.sampler, 3)
    dl.sampler = _FrameDraws(dl.sampler, single.sampler)
    models = []
    for _ in range(2):
        torch.manual_seed(0)
        m = GraphSAGE(24, 32, 5, device=world1.device)
        models.append((m, torch.optim.Adam(m.parameters(), lr=1e-3)))
    (m1, o1), (m2, o2) = models
    for _, bs, bd in zip(range(3), single, dl):
        before = (gather_rows.launches, fused_uniform_sample.launches)
        torch.cuda.synchronize()
        valid = bs.seeds >= 0
        assert _samples_equal(bs.sample, bd.sample)
        assert torch.equal(_bits(bs.x), _bits(bd.x))
        assert torch.equal(bs.y[valid], bd.y[valid]) and bool((bd.y[~valid] == -1).all())
        o1.zero_grad(set_to_none=True)
        ls = F.cross_entropy(m1(bs.x, bs.sample).float(), bs.y, reduction="none")
        l1 = torch.where(valid, ls, 0).sum() / valid.sum().clamp(min=1)
        l1.backward()
        o1.step()
        assert float(l1.detach()) == float(dist_train_step(m2, o2, bd, world1))
        assert (gather_rows.launches, fused_uniform_sample.launches) == before
    before = (gather_rows.launches, fused_uniform_sample.launches)
    next(iter(DistNeighborLoader(data, (10, 5), world1, batch_size=256, dedup=dedup)))
    torch.cuda.synchronize()
    assert (gather_rows.launches, fused_uniform_sample.launches) == (before[0] + 1,
                                                                       before[1] + 2)


def test_dist_link_loader_world1_matches_one_device(world1):
    """``DistLinkNeighborLoader`` at world 1 against ``LinkNeighborLoader``
    on the same negatives and draws: seed layout, labels, samples and
    features bit for bit."""
    from cugraph_gnn_tpu_torch.loader import DistLinkNeighborLoader, LinkNeighborLoader

    data, eli = _dist_stores(world1.device)
    kw = dict(edge_label_index=eli, neg_sampling="binary", batch_size=64, shuffle=True)
    single = LinkNeighborLoader(data, (10, 5), **kw)
    dl = DistLinkNeighborLoader(data, (10, 5), world1, dedup=True, **kw)

    def fixed_negatives():
        calls = [0]

        def negatives(ps, n):          # batch i's from a CPU generator seeded i
            g = torch.Generator().manual_seed(calls[0])
            calls[0] += 1
            return tuple(torch.randint(0, 3000, (n,), generator=g, dtype=torch.int32)
                         .to(ps.device) for _ in range(2))
        return negatives

    single._negatives, dl._negatives = fixed_negatives(), fixed_negatives()
    single.sampler = _RecordDraws(single.sampler, 4)
    dl.sampler = _FrameDraws(dl.sampler, single.sampler)
    for _, bs, bd in zip(range(3), single, dl):
        assert _samples_equal(bs.sample, bd.sample)
        for name in ("seeds", "edge_label_index", "edge_label", "input_id"):
            assert torch.equal(getattr(bs, name), getattr(bd, name)), name
        assert torch.equal(_bits(bs.x), _bits(bd.x))


def test_dist_rank_local_matches_global_world1(world1):
    """The rank-local mode (the whole COO as rank 0's slice, routed over
    NCCL) builds the global mode's shard, and its first batch is the global
    mode's bit for bit (the same seed: the same draws)."""
    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader

    kw = dict(batch_size=256, shuffle=True, dedup=True, weight_attr="w")
    glob = DistNeighborLoader(_dist_stores(world1.device)[0], (10, 5), world1, **kw)
    local = DistNeighborLoader(_dist_stores(world1.device, local=True)[0], (10, 5), world1,
                               **kw)
    for name in ("indptr", "indices", "weights"):
        assert torch.equal(getattr(glob.graph, name), getattr(local.graph, name)), name
    a, b = next(iter(glob)), next(iter(local))
    assert _samples_equal(a.sample, b.sample)
    assert torch.equal(_bits(a.x), _bits(b.x)) and torch.equal(a.y, b.y)


@pytest.mark.parametrize("variant", ["uniform", "weighted", "temporal"])
def test_dist_loader_card_matches_cpu(world1, variant):
    """The same world-1 ``DistNeighborLoader`` on the card (NCCL) and on the
    CPU (a gloo group of the one rank), on the same CPU draws: three
    batches bit for bit."""
    import torch.distributed as dist

    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader
    from cugraph_gnn_tpu_torch.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu_torch.sampler import dist_sampler as DS

    cpu_mesh = create_store_mesh("cpu", group=dist.new_group([0], backend="gloo"))
    vkw = {"uniform": {}, "weighted": dict(weight_attr="w"),
           "temporal": dict(time_attr="t",
                            input_time=np.random.default_rng(1).integers(0, 100, 3000))}[variant]
    out = []
    inner = DS.sample_owned
    for mesh in (world1, cpu_mesh):
        gen = torch.Generator().manual_seed(5)

        def owned(g, local, k, *, req_time=None, gen=gen, **kw):
            if g.weights is not None or (g.times is not None and req_time is not None):
                kw["hash_key"] = torch.randint(0, 1 << 32, (2,), generator=gen)
            else:
                kw["u"] = torch.rand((local.shape[0], k), generator=gen).to(local.device)
            return inner(g, local, k, req_time=req_time, **kw)

        DS.sample_owned = owned
        try:
            ld = DistNeighborLoader(_dist_stores(mesh.device)[0], (10, 5), mesh, batch_size=128,
                                    shuffle=True, dedup=True, **vkw)
            out.append([b for _, b in zip(range(3), ld)])
        finally:
            DS.sample_owned = inner
    for a, b in zip(*out):
        assert _samples_equal(a.sample, b.sample)
        assert torch.equal(_bits(a.x.cpu()), _bits(b.x)) and torch.equal(a.y.cpu(), b.y)


# -- the hetero dist loaders and the hierarchical gather at world 1 -----------------

_MAG = {"paper": 2000, "author": 2500, "field": 200}


def _mag_stores(dev, attrs=False):
    """A small mag-shaped hetero graph's stores on ``dev`` (with an f32
    weight and an int32 time on every edge type when ``attrs``)."""
    from cugraph_gnn_tpu_torch import train_hetero as TH

    g = TH.make_synthetic_mag(3, "cpu", num_nodes=_MAG, feat_dim=16, classes=5, deg_cap=50)
    fs_c, gs_c = TH.mag_stores(g, "cpu")
    gs, fs = GraphStore(device=dev), FeatureStore(device=dev)
    rng = np.random.default_rng(6)
    for et in gs_c.edge_types:
        src, dst = gs_c.get_edge_index(et)
        gs.put_edge_index((src, dst), et, num_nodes=(gs_c.num_nodes(et[0]),
                                                     gs_c.num_nodes(et[2])))
        if attrs:
            fs[("__".join(et), "w")] = rng.uniform(0.05, 1.0, len(src)).astype(np.float32)
            fs[("__".join(et), "t")] = rng.integers(0, 100, len(src)).astype(np.int32)
    for nt in gs_c.node_types:
        fs[(nt, "x")] = fs_c.get_tensor(nt, "x")
    fs[("paper", "y")] = fs_c.get_tensor("paper", "y")
    return fs, gs


class _HeteroRecordDraws:
    """A one-device hetero loader's sampler on CPU uniforms, kept with its
    levels."""

    def __init__(self, inner, seed):
        self.inner, self.gen, self.last = inner, torch.Generator().manual_seed(seed), None

    def sample(self, seeds, node_times=None, generator=None):
        caps = self.inner.level_caps(seeds.shape[0])
        u = [{n: torch.rand((caps[h], f[h]), generator=self.gen).to(seeds.device)
              for n, f in self.inner.fanouts.items() if f is not None and f[h] > 0}
             for h in range(self.inner.num_hops)]
        batch = self.inner.sample(seeds, node_times, u=u)
        self.last = (u, batch.levels)
        return batch


class _HeteroFrameDraws:
    """A world-1 hetero dist sampler on the recorded draws at the valid
    targets."""

    def __init__(self, inner, record):
        self.inner, self.record = inner, record

    def sample(self, seeds, node_times=None, generator=None):
        u, levels = self.record.last
        return self.inner.sample(seeds, node_times, u=[
            {n: a[lv >= 0] for n, a in uh.items()} for uh, lv in zip(u, levels)])


def _hetero_equal(a, b):
    """Hetero batches' samples (blocks by edge type) and feature dicts bit
    for bit."""
    if [sorted(h) for h in a.sample.hops] != [sorted(h) for h in b.sample.hops]:
        return False
    pairs = list(zip(a.sample.levels + list(a.sample.level_counts),
                     b.sample.levels + list(b.sample.level_counts)))
    pairs += [(x, y) for ha, hb in zip(a.sample.hops, b.sample.hops) for n in ha
              for x, y in zip(ha[n][:3], hb[n][:3])]
    pairs += [(_bits(a.x[k]), _bits(b.x[k])) for k in a.x] + [(a.seeds, b.seeds)]
    return sorted(a.x) == sorted(b.x) and all(torch.equal(x.cpu(), y.cpu())
                                              for x, y in pairs)


def test_hetero_dist_loader_world1_matches_one_device(world1):
    """The typed ``DistNeighborLoader`` at world 1 against the typed
    ``NeighborLoader`` (dedup) on the same draws: samples, each type's
    features and the valid seeds' labels bit for bit (pads -1), 3 row-gather
    and 6 sampler launches a batch, and three R-GCN steps' losses equal."""
    from cugraph_gnn_tpu_torch import train_hetero as TH
    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader
    from cugraph_gnn_tpu_torch.models.zoo import RGCN
    from cugraph_gnn_tpu_torch.train_dist import dist_train_step

    fs, gs = _mag_stores(world1.device)
    names = ["__".join(et) for et in gs.edge_types]
    kw = dict(input_nodes=("paper", np.arange(_MAG["paper"])), batch_size=96, shuffle=True)
    single = NeighborLoader((fs, gs), [4, 3], dedup=True, **kw)
    dl = DistNeighborLoader((fs, gs), [4, 3], world1, **kw)
    single.sampler = _HeteroRecordDraws(single.sampler, 7)
    dl.sampler = _HeteroFrameDraws(dl.sampler, single.sampler)
    models = []
    for _ in range(2):
        torch.manual_seed(0)
        m = RGCN(16, num_relations=3, hidden_features=32, out_features=5, device=world1.device)
        models.append((m, torch.optim.Adam(m.parameters(), lr=1e-3)))
    (m1, o1), (m2, o2) = models
    for _, bs, bd in zip(range(3), single, dl):
        valid = bs.seeds >= 0
        assert _hetero_equal(bs, bd)
        assert torch.equal(bs.y[valid], bd.y[valid]) and bool((bd.y[~valid] == -1).all())
        l1 = TH.loader_step(m1, o1, bs, names, dtype=torch.float32)
        l2 = dist_train_step(TH.RGCNEncoder(m2, names, torch.float32), o2, bd, world1)
        assert float(l1) == float(l2)
    before = (gather_rows.launches, fused_uniform_sample.launches)
    next(iter(DistNeighborLoader((fs, gs), [4, 3], world1, **kw)))
    torch.cuda.synchronize()
    assert (gather_rows.launches, fused_uniform_sample.launches) == (before[0] + 3,
                                                                       before[1] + 6)


def test_hetero_dist_link_loader_world1_matches_one_device(world1):
    """``DistLinkNeighborLoader`` with a typed ``edge_label_index`` at world
    1 against ``LinkNeighborLoader`` on the same negatives and draws: seed
    layout, labels, samples and feature dicts bit for bit."""
    from cugraph_gnn_tpu_torch.loader import DistLinkNeighborLoader, LinkNeighborLoader

    fs, gs = _mag_stores(world1.device)
    writes = ("author", "writes", "paper")
    src, dst = gs.get_edge_index(writes)
    eli = (writes, np.stack([src[::7], dst[::7]]))
    kw = dict(neg_sampling="binary", batch_size=64, shuffle=True)
    single = LinkNeighborLoader((fs, gs), [4, 3], eli, **kw)
    dl = DistLinkNeighborLoader((fs, gs), [4, 3], world1, edge_label_index=eli, **kw)

    def fixed_negatives(loader):
        calls = [0]

        def negatives(ps, n):          # batch i's from a CPU generator seeded i
            g = torch.Generator().manual_seed(calls[0])
            calls[0] += 1
            return (torch.randint(0, loader.num_src, (n,), generator=g, dtype=torch.int32)
                    .to(ps.device),
                    torch.randint(0, loader.num_dst, (n,), generator=g, dtype=torch.int32)
                    .to(ps.device))
        return negatives

    single._negatives, dl._negatives = fixed_negatives(single), fixed_negatives(dl)
    single.sampler = _HeteroRecordDraws(single.sampler, 8)
    dl.sampler = _HeteroFrameDraws(dl.sampler, single.sampler)
    for _, bs, bd in zip(range(3), single, dl):
        assert _hetero_equal(bs, bd)
        for name in ("edge_label_index", "edge_label", "input_id"):
            assert torch.equal(getattr(bs, name), getattr(bd, name)), name


@pytest.mark.parametrize("variant", ["uniform", "weighted", "temporal"])
def test_hetero_dist_loader_card_matches_cpu(world1, variant):
    """The typed ``DistNeighborLoader`` on the card (NCCL) and on the CPU (a
    gloo group of the one rank), on the same CPU draws: three batches bit
    for bit."""
    import torch.distributed as dist

    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader
    from cugraph_gnn_tpu_torch.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu_torch.sampler import hetero_dist as HD

    cpu_mesh = create_store_mesh("cpu", group=dist.new_group([0], backend="gloo"))
    vkw = {"uniform": {}, "weighted": dict(weight_attr="w"),
           "temporal": dict(time_attr="t", input_time=np.random.default_rng(1).integers(
               0, 100, _MAG["paper"]))}[variant]
    out = []
    inner = HD.sample_owned
    for mesh in (world1, cpu_mesh):
        gen = torch.Generator().manual_seed(5)

        def owned(g, local, k, *, req_time=None, gen=gen, **kw):
            if g.weights is not None or (g.times is not None and req_time is not None):
                kw["hash_key"] = torch.randint(0, 1 << 32, (2,), generator=gen)
            else:
                kw["u"] = torch.rand((local.shape[0], k), generator=gen).to(local.device)
            return inner(g, local, k, req_time=req_time, **kw)

        HD.sample_owned = owned
        try:
            ld = DistNeighborLoader(_mag_stores(mesh.device, attrs=True), [4, 3], mesh,
                                    input_nodes=("paper", np.arange(_MAG["paper"])),
                                    batch_size=64, shuffle=True, **vkw)
            out.append([b for _, b in zip(range(3), ld)])
        finally:
            HD.sample_owned = inner
    for a, b in zip(*out):
        assert _hetero_equal(a, b) and torch.equal(a.y.cpu(), b.y)


def test_hier_gather_world1_matches_flat(world1):
    """The two-level gather (``HierarchicalDistArray.gather_with_stats``)
    on a 1 x 1 (node, device) mesh over NCCL: duplicates and -1 ids, through
    ``read_rows``, bit-equal to the flat gather and to indexing; one
    row-gather launch each, nothing crosses a node."""
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows
    from cugraph_gnn_tpu_torch.parallel.mesh import create_hierarchical_mesh
    from cugraph_gnn_tpu_torch.store.dist_array import _dist_gather_shard
    from cugraph_gnn_tpu_torch.store.hierarchical import HierarchicalDistArray
    from cugraph_gnn_tpu_torch.store.partition import PartitionBook

    hmesh = create_hierarchical_mesh(1)
    assert hmesh.backend == "nccl" and hmesh.shape == {"node": 1, "device": 1}
    g = torch.Generator().manual_seed(2)
    table = torch.randn((5000, 40), generator=g).to(world1.device)
    ids = torch.randint(-1, 5000, (20_000,), generator=g).to(world1.device)
    book = PartitionBook.even(5000, 1)
    before = gather_rows.launches
    hier, cross = HierarchicalDistArray.from_array(table, hmesh).gather_with_stats(
        ids, read=read_rows)
    flat = _dist_gather_shard(table, ids, book=book, mesh=world1, read=read_rows)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 2 and int(cross[0]) == 0
    want = torch.where((ids >= 0)[:, None], table[ids.clamp(min=0)], 0)
    assert torch.equal(_bits(hier), _bits(flat)) and torch.equal(_bits(hier), _bits(want))


# -- the doctor, the trace and the DCP checkpoints ------------------------------------------


def test_doctor_on_card(card):
    """``smoke_check()`` with no device: the card, the ring sample through
    the fused sampler's kernel (one launch)."""
    from cugraph_gnn_tpu_torch import doctor

    before = fused_uniform_sample.launches
    report = doctor.smoke_check()
    assert report["platform"] == "cuda" and report["sample_op"] == "ok"
    assert report["device_name"] == torch.cuda.get_device_name(0)
    assert report["sample_kernel_launches"] == 1 == fused_uniform_sample.launches - before


def test_trace_names_both_kernels(card, tmp_path):
    """``profiling.trace`` around one loader batch records the row gather
    and the sampler's kernels by name, and the ``annotate`` region."""
    import json

    from cugraph_gnn_tpu_torch.utils import profiling

    g = torch.Generator().manual_seed(0)
    n = 3000
    gs = GraphStore(device=card)
    gs.put_edge_index((torch.randint(0, n, (30_000,), generator=g).numpy(),
                       torch.randint(0, n, (30_000,), generator=g).numpy()),
                      ("n", "to", "n"), num_nodes=(n, n))
    fs = FeatureStore(device=card)
    fs["x"] = torch.randn((n, 64), generator=g)
    loader = NeighborLoader((fs, gs), num_neighbors=[5, 5], batch_size=256, dedup=False)
    next(iter(loader))                 # the kernels' first launch builds them
    with profiling.trace(str(tmp_path)) as t:
        with profiling.annotate("one-loader-batch"):
            batch = next(iter(loader))
            torch.cuda.synchronize()
    assert batch.x.shape[1] == 64
    names = " ".join(e.get("name", "") for e in json.load(open(t.path))["traceEvents"])
    assert "gather_rows_kernel" in names and "one-loader-batch" in names
    assert "uniform_sample_groups" in names or "uniform_sample_rows" in names


def test_checkpoint_round_trip_world1(world1, tmp_path):
    """DCP save and restore at world 1 over NCCL: a bf16 ``DistArray`` and
    a trained lazy-Adam ``DistEmbedding``, bit for bit, on the card."""
    from cugraph_gnn_tpu_torch.embedding import DistEmbedding
    from cugraph_gnn_tpu_torch.store.dist_array import DistArray
    from cugraph_gnn_tpu_torch.utils import orbax_ckpt

    g = torch.Generator().manual_seed(1)
    arr = DistArray.from_array(torch.randn((1001, 96), generator=g), world1,
                               dtype=torch.bfloat16)
    orbax_ckpt.save_dist_array(str(tmp_path / "arr"), arr)
    back = orbax_ckpt.restore_dist_array(str(tmp_path / "arr"))
    assert back.data.device == arr.data.device and torch.equal(_bits(back.data), _bits(arr.data))
    emb = DistEmbedding.create(500, 32, world1, optimizer="lazy_adam")
    emb.add_gradients(torch.arange(64) * 7 % 500, torch.full((64, 32), 0.1))
    emb.apply_gradients(lr=0.01)
    orbax_ckpt.save_embedding(str(tmp_path / "emb"), emb)
    got = orbax_ckpt.restore_embedding(str(tmp_path / "emb"))
    assert torch.equal(got.table.data, emb.table.data)
    assert all(torch.equal(got._state[k], emb._state[k]) for k in emb._state)


# -- the example scripts ---------------------------------------------------------------------

EXAMPLE_RUNS = sorted(TINY_ARGV) + ["hetero_link_pred_disjoint"]


@pytest.mark.parametrize("name", EXAMPLE_RUNS)
def test_example_main_on_card(card, name):
    """Each example script's ``main`` at its small CPU test argv, given no
    device: it runs on the card.  Without scikit-learn the fraud script's
    logistic probe takes the forest's place and the xgb script raises
    ``ImportError``; the scripts' own gates hold (the full-batch and
    distributed accuracies, the hetero script's falling loss), the link
    AUC is at least 0.75 and elsewhere the last loss is below the first."""
    import importlib
    import importlib.util

    script = name.replace("_disjoint", "")
    mod = importlib.import_module(f"cugraph_gnn_tpu_torch.examples.{script}")
    argv = TINY_ARGV[script] + (["--disjoint"] if name != script else [])
    have_sklearn = importlib.util.find_spec("sklearn") is not None
    if script == "xgb_downstream" and not have_sklearn:
        with pytest.raises(ImportError):
            mod.main(argv)
        return
    with karate_file():
        out = mod.main(argv)
    if script == "fraud_detection":
        assert out["downstream"] == ("random_forest" if have_sklearn else "logistic_probe")
    if script == "link_prediction":
        assert out["auc"] >= 0.75
    if script in ("full_batch_training", "dist_full_batch_training"):
        assert out["accuracy"] > (0.9 if script == "full_batch_training" else 0.8)
    losses = out["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
