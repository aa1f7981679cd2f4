"""Port parity: the slab split, the CSR tiles, the slab and CSR SpMMs' plain
versions, and the plain-PyTorch segment / ELL / CSR SpMMs, against the JAX
package on the CPU (its Pallas kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cugraph_gnn_tpu.ops import spmm as jax_spmm
from cugraph_gnn_tpu.ops.pallas import slab_kernel as jax_slab
from cugraph_gnn_tpu.ops.pallas import spmm_kernel as jax_csr
from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.ops import spmm as port_spmm
from cugraph_gnn_tpu_torch.ops.kernels import slab_kernel as port_slab
from cugraph_gnn_tpu_torch.ops.kernels import spmm_kernel as port_csr


def make_graph(n, deg, band, rng, frac_far=0.0, simple=False, hub=0):
    """CSR of ``deg`` sources per row within +-band (a share ``frac_far``
    uniform instead), plus ``hub`` in-band sources into row n // 2; with
    ``simple``, parallel edges dropped.  Returns (indptr, indices, perm)."""
    dst = np.repeat(np.arange(n), deg)
    near = np.clip(dst + rng.integers(-band, band + 1, n * deg), 0, n - 1)
    src = np.where(rng.random(n * deg) < frac_far, rng.integers(0, n, n * deg), near)
    if hub:
        c = n // 2
        src = np.concatenate([src, np.clip(c + rng.integers(-band, band + 1, hub),
                                           0, n - 1)])
        dst = np.concatenate([dst, np.full(hub, c)])
    if simple:
        _, first = np.unique(src * n + dst, return_index=True)
        keep = np.sort(first)
        src, dst = src[keep], dst[keep]
    return _native.build_csr(dst, src, n)


# name -> (n, deg, band, frac_far, simple, hub, weighted, block_rows, max_k)
CASES = {
    "band_only": (300, 6, 60, 0.0, True, 0, False, 128, 64),
    "far": (300, 6, 60, 0.3, False, 0, False, 128, 64),
    "weighted_overflow": (300, 5, 40, 0.0, False, 30, True, 128, 8),
    "k_cap": (260, 12, 100, 0.1, False, 0, False, 128, 8),
    "wide_blocks": (700, 4, 300, 0.2, False, 0, False, 512, 64),
    "no_edges": (50, 0, 10, 0.0, False, 0, False, 128, 64),
}


def _case(name, seed=0):
    n, deg, band, far, simple, hub, weighted, r_blk, max_k = CASES[name]
    rng = np.random.default_rng(seed)
    indptr, indices, _ = make_graph(n, deg, band, rng, far, simple, hub)
    w = rng.uniform(0.5, 2.0, len(indices)).astype(np.float32) if weighted else None
    kw = dict(block_rows=r_blk, max_k=max_k)
    return (indptr, indices, w, kw,
            port_slab.build_slab_graph(indptr, indices, w, device="cpu", **kw),
            jax_slab.build_slab_graph(indptr, indices, w, **kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_slab_graph_matches_jax(name):
    indptr, _, _, kw, got, want = _case(name)
    for field in ("ell", "ell_w", "fb_src", "fb_dst", "fb_w", "degrees"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert g.numpy().dtype == np.asarray(w).dtype, field
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
    assert (got.ell_bits is None) == (want.ell_bits is None)
    if got.ell_bits is not None:
        np.testing.assert_array_equal(got.ell_bits, np.asarray(want.ell_bits))
    assert (got.num_rows, got.block_rows, got.n_blocks) == (
        want.num_rows, want.block_rows, want.n_blocks)
    assert got.band_fraction == want.band_fraction
    # the kernel's row pointer indexes fb_dst's valid prefix
    fb_dst = got.fb_dst.numpy()
    rowptr = got.fb_rowptr.numpy()
    assert rowptr[-1] == (fb_dst >= 0).sum()
    for r in range(got.num_rows):
        assert (fb_dst[rowptr[r]:rowptr[r + 1]] == r).all()
    if name == "band_only":
        assert got.band_fraction == 1.0 and got.fb_src.shape[0] == 0
    if name in ("weighted_overflow", "k_cap"):
        assert got.ell.shape[1] == kw["max_k"] and got.band_fraction < 1.0


# one Pallas call per (graph, reduce, compute dtype)
@pytest.mark.parametrize("name,reduce,compute", [
    ("far", "sum", "float32"), ("far", "mean", "float32"),
    ("far", "sum", "bfloat16"),
    ("weighted_overflow", "sum", "float32"),
    ("weighted_overflow", "mean", "float32"),
    ("weighted_overflow", "sum", "bfloat16"),
])
def test_slab_spmm_matches_jax(name, reduce, compute):
    """The band, the fallback and the mean divide; with a bfloat16 compute
    dtype x and the weights are rounded where the MXU rounds them.  Float32
    sums in another order: 1e-5."""
    _, _, _, _, got_g, want_g = _case(name)
    n = got_g.num_rows
    x = np.random.default_rng(1).standard_normal((n, 64)).astype(np.float32)
    want = jax.jit(lambda z: jax_slab.slab_spmm(
        want_g, z, reduce, compute_dtype=getattr(jnp, compute)))(jnp.asarray(x))
    xt = torch.as_tensor(x)
    cdt = getattr(torch, compute)
    got = port_slab.slab_spmm(got_g, xt, reduce, cdt)
    assert got.dtype == torch.float32 and got.shape == (n, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, port_slab.slab_spmm_ref(got_g, xt, reduce, cdt))


def test_slab_spmm_band_skips_out_of_range_ids():
    """An ELL id whose column falls outside [0, N) adds nothing (the kernel
    guards the window; the builder never writes such an id)."""
    g = port_slab.build_slab_graph(np.zeros(301, np.int64), np.zeros(0, np.int32),
                                   block_rows=128, device="cpu")
    ell = g.ell.clone()
    ell[0, 0] = 5          # row 0, block 0: column -123
    ell[299, 0] = 300      # row 299, block 2: column 428 >= 300
    ell[200, 0] = 100      # row 200, block 1: column 100, valid
    g = g.with_ell(ell)
    x = torch.randn(300, 8)
    out = port_slab.slab_spmm_band(g, x, torch.float32)
    want = torch.zeros(300, 8)
    want[200] = x[100]
    assert torch.equal(out, want)


def test_build_padded_blocks_matches_jax():
    rng = np.random.default_rng(3)
    indptr, indices, _ = make_graph(40, 5, 40, rng, frac_far=0.5)
    got = port_csr.build_padded_blocks(indptr, indices, edge_tile=64, device="cpu")
    want = jax_csr.build_padded_blocks(indptr, indices, edge_tile=64)
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    assert (got.n_blocks, got.num_rows) == (want.n_blocks, want.num_rows)
    np.testing.assert_array_equal(got.rowptr.numpy(), indptr)


def test_csr_spmm_matches_pallas():
    rng = np.random.default_rng(4)
    n, f = 32, 128
    indptr, indices, _ = make_graph(n, 6, n, rng, frac_far=1.0)
    x = rng.standard_normal((n, f)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda z: jax_csr.csr_spmm_pallas(
            jax_csr.build_padded_blocks(indptr, indices, edge_tile=64), z))(jnp.asarray(x))
    padded = port_csr.build_padded_blocks(indptr, indices, edge_tile=64, device="cpu")
    got = port_csr.csr_spmm(padded, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, port_csr.csr_spmm_ref(padded, torch.as_tensor(x)))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_csr_spmm_weighted_accumulate(out_dtype):
    """Weights, accumulation into ``out`` (rounded once), and columns
    outside [0, N) skipped."""
    rng = np.random.default_rng(5)
    n, f = 50, 12
    indptr, indices, _ = make_graph(n, 3, 10, rng, frac_far=0.5)
    indices[::7] = n + 4                      # past the end: skipped
    w = rng.uniform(-1, 1, len(indices)).astype(np.float32)
    padded = port_csr.build_padded_blocks(indptr, indices, edge_tile=32,
                                          weights=w, device="cpu")
    x = rng.standard_normal((n, f)).astype(np.float32)
    out = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32)).to(out_dtype)
    want = out.double().numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    ok = indices < n
    np.add.at(want, rows[ok], w[ok, None] * x[indices[ok]].astype(np.float64))
    got = port_csr.csr_spmm(padded, torch.as_tensor(x), out=out)
    assert got is out
    tol = 1e-5 if out_dtype == torch.float32 else 2 ** -8   # one bf16 rounding
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="storage"):
        port_csr.csr_spmm(padded, out, out=out)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_plain_spmms_match_jax(reduce):
    """segment_spmm (with -1 padding, and weights for sum), EllBuckets /
    ell_spmm (with heavy rows past max_k) and csr_spmm against XLA."""
    rng = np.random.default_rng(6)
    n, f = 60, 8
    indptr, indices, _ = make_graph(n, 4, 10, rng, frac_far=0.3, hub=40)
    x = rng.standard_normal((n, f)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    rows = np.repeat(np.arange(n), np.diff(indptr)).astype(np.int32)
    src, dst = indices.copy(), rows.copy()
    src[::9] = -1
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32) if reduce == "sum" else None
    want = jax.jit(lambda z: jax_spmm.segment_spmm(
        z, jnp.asarray(src), jnp.asarray(dst), n, reduce,
        edge_weight=None if w is None else jnp.asarray(w)))(xj)
    got = port_spmm.segment_spmm(xt, torch.as_tensor(src), torch.as_tensor(dst), n,
                                 reduce, None if w is None else torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    buckets = jax_spmm.EllBuckets(indptr, indices, max_k=8)
    want = jax.jit(lambda z: jax_spmm.ell_spmm(buckets, z, reduce))(xj)
    got = port_spmm.ell_spmm(port_spmm.EllBuckets(indptr, indices, max_k=8,
                                                  device="cpu"), xt, reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    want = jax.jit(lambda z: jax_spmm.csr_spmm(
        jnp.asarray(indptr.astype(np.int32)), jnp.asarray(indices), z, reduce))(xj)
    got = port_spmm.csr_spmm(torch.as_tensor(indptr), torch.as_tensor(indices), xt,
                             reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
