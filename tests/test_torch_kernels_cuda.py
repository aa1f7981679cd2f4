"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the row gather, the fused sampler, the slab SpMM's band kernel and the CSR
SpMM kernel.

Marked ``cuda``: each test asks the ``card`` fixture for a device and skips
without one.  The file imports no JAX, so on the machine with the card it
runs without the repo's conftest (which configures JAX):

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -o addopts= -q
"""

import numpy as np
import pytest
import torch

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows, gather_rows_ref
from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
    fused_uniform_sample,
    fused_uniform_sample_ref,
)
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
    build_slab_graph,
    slab_spmm,
    slab_spmm_band,
    slab_spmm_band_ref,
    slab_spmm_ref,
)
from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import (
    build_padded_blocks,
    csr_spmm,
    csr_spmm_ref,
)

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
    deg = rng.integers(0, 30, n)
    deg[::50] = 0
    deg[1::97] = rng.integers(129, 3000, deg[1::97].shape[0])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


@pytest.mark.parametrize("k", [1, 10, 16, 17, 40])
def test_uniform_sample_bit_equal(card, k):
    rng = np.random.default_rng(k)
    indptr, indices = _graph(rng)
    n = indptr.shape[0] - 1
    seeds = rng.integers(0, n, 4000).astype(np.int32)
    seeds[::11] = -1
    seeds[3] = n + 5           # past the end: degree 0
    u = rng.random((seeds.shape[0], k), dtype=np.float32)
    args = [torch.as_tensor(a, device=card) for a in (indptr, indices, seeds, u)]
    before = fused_uniform_sample.launches
    out = fused_uniform_sample(*args, k)
    want = fused_uniform_sample_ref(*args, k)
    host = fused_uniform_sample_ref(
        *[torch.as_tensor(a) for a in (indptr, indices, seeds, u)], k)
    torch.cuda.synchronize()
    assert fused_uniform_sample.launches == before + 1
    for got, ref, ref_host in zip(out, want, host):
        assert got.dtype == torch.int32
        assert torch.equal(got, ref)
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


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [64, 128, 256, 100])
@pytest.mark.parametrize("weighted", [False, True])
def test_slab_spmm_band_matches_plain(card, x_dtype, f, weighted):
    """The band kernel against its plain version, float32 sums in another
    order: 1e-5.  n = 1000 is not a multiple of R = 128; both compute
    dtypes."""
    rng = np.random.default_rng(f + weighted)
    indptr, indices, w = _csr(rng, 1000, 9, 100, far=0.2, weighted=weighted)
    g = build_slab_graph(indptr, indices, w, block_rows=128, max_k=8, device=card)
    x = _x(rng, 1000, f, x_dtype, card)
    for compute in (torch.float32, torch.bfloat16):
        before = slab_spmm_band.launches
        got = slab_spmm_band(g, x, compute)
        want = slab_spmm_band_ref(g, x, compute)
        torch.cuda.synchronize()
        assert slab_spmm_band.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (1000, f)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
def test_slab_spmm_matches_plain(card, name, x_dtype, reduce):
    """Band kernel + fallback kernel + mean divide against the plain
    version's float32 sum (``_assert_sum_close``); each kernel launches only
    where it has work."""
    n, deg, band, far, shift = SLAB_CASES[name]
    rng = np.random.default_rng(7)
    indptr, indices, _ = _csr(rng, n, deg, band, far=far, shift=shift)
    g = build_slab_graph(indptr, indices, block_rows=128, device=card)
    if name == "band_only":
        assert g.fb_src.shape[0] == 0
    if name == "all_fallback":
        assert g.band_fraction == 0.0
    x = _x(rng, n, 128, x_dtype, card)
    band0, csr0 = slab_spmm_band.launches, csr_spmm.launches
    got = slab_spmm(g, x, reduce, torch.float32)
    torch.cuda.synchronize()
    assert slab_spmm_band.launches == band0 + (n > 0)
    assert csr_spmm.launches == csr0 + (g.fb_src.shape[0] > 0 and n > 0)
    assert got.dtype == x_dtype and got.shape == (n, 128)
    _assert_sum_close(got, slab_spmm_ref(g, x.float(), reduce, torch.float32),
                      slab_spmm_ref(g, x.float().abs(), reduce, torch.float32))
