"""Port parity: the attention pair, the fused slab attention's forward and
backward plain versions, the differentiable attention and the SDDMM ops,
against the JAX package on the CPU (its Pallas kernels in interpret mode,
jitted).  Tolerances: forward outputs and m + log(s) within 1e-5, gradients
within 1e-4 (the JAX package holds its kernels to autodiff within 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.ops import FullBatchGraph as JaxFullBatchGraph
from cugraph_gnn_tpu.ops import sddmm as jax_sddmm
from cugraph_gnn_tpu.ops.pallas import slab_attn_grad as jax_grad
from cugraph_gnn_tpu.ops.pallas import slab_kernel as jax_slab
from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
from cugraph_gnn_tpu_torch.ops import sddmm
from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as grad
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as fwd
from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import build_slab_graph
from cugraph_gnn_tpu_torch.ops.spmm import segment_spmm


def attention_graph(n, deg, band, rng, far=0.2, hub=40):
    """COO of ``deg`` sources per row within +-band (a share ``far``
    uniform), ``hub`` extra sources into column n // 2, a few parallel
    edges, rows 10-11 without edges and rows 20-21 with only far sources.
    Returns (src, dst, indptr, indices)."""
    dst = np.repeat(np.arange(n), deg)
    src = np.clip(dst + rng.integers(-band, band + 1, n * deg), 0, n - 1)
    src = np.where(rng.random(n * deg) < far, rng.integers(0, n, n * deg), src)
    src = np.where(np.isin(dst, [20, 21]), (dst + n // 2) % n, src)
    hub_dst = np.clip(n // 2 + rng.integers(-band, band + 1, hub), 0, n - 1)
    src = np.concatenate([src, np.full(hub, n // 2), src[:6]])
    dst = np.concatenate([dst, hub_dst, dst[:6]])
    keep = ~np.isin(dst, [10, 11])
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    indptr, indices, _ = _native.build_csr(dst, src, n)
    return src, dst, indptr, indices


def inputs(n, heads, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, heads, f)).astype(np.float32)
    ad, as_ = (rng.standard_normal((n, heads)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((n, heads, f)).astype(np.float32)
    return x, ad, as_, g


def band_edges(ell, r_blk):
    """Sorted (row, global column) pairs of an ELL's entries."""
    rr, kk = np.nonzero(ell >= 0)
    return sorted(zip(rr.tolist(), (ell[rr, kk] + (rr // r_blk) * r_blk - r_blk).tolist()))


@pytest.mark.parametrize("r_blk", [128, 512])
def test_pair_matches_jax(r_blk):
    """Host arrays equal the JAX package's in both branches (bit planes at
    R = 128, t_ell at R = 512); the port's transpose indexes hold exactly
    the band and the fallback edges; band + fallback cover every edge."""
    n = 1100 if r_blk == 512 else 300
    rng = np.random.default_rng(r_blk)
    _, _, indptr, indices = attention_graph(n, 5, r_blk // 2, rng)
    kw = dict(block_rows=r_blk, max_k=8)
    got = grad.build_attention_slab_pair(indptr, indices, device="cpu", **kw)
    want = jax_grad.build_attention_slab_pair(indptr, indices, to_device=False, **kw)
    for field in ("ell", "fb_src", "fb_dst", "degrees"):
        np.testing.assert_array_equal(getattr(got.fwd, field).numpy(),
                                      getattr(want.fwd, field))
    assert (got.fwd.ell_bits is None) == (want.fwd.ell_bits is None) == (r_blk == 512)
    assert (got.t_ell is None) == (want.t_ell is None)
    if r_blk == 512:
        np.testing.assert_array_equal(got.t_ell.numpy(), want.t_ell)
        # the band CSR by source holds exactly t_ell's edges, each column's
        # in t_ell's slot order (global destination rows)
        ptr, rows, t_ell = got.t_rowptr.numpy(), got.t_rows.numpy(), got.t_ell.numpy()
        assert ptr.shape == (n + 1,) and ptr[0] == 0 and ptr[-1] == len(rows)
        assert not (t_ell[n:] >= 0).any()
        for c in range(n):
            slots = t_ell[c][t_ell[c] >= 0]
            assert (t_ell[c][len(slots):] < 0).all()     # no holes between slots
            np.testing.assert_array_equal(rows[ptr[c]:ptr[c + 1]],
                                          slots + (c // r_blk) * r_blk - r_blk)
    else:
        np.testing.assert_array_equal(got.fwd.ell_bits, want.fwd.ell_bits)
        # at R <= 341 the forward split is the plain slab split
        slab = build_slab_graph(indptr, indices, device="cpu", **kw)
        for field in ("ell", "fb_src", "fb_dst", "fb_rowptr"):
            assert torch.equal(getattr(got.fwd, field), getattr(slab, field))
        np.testing.assert_array_equal(got.fwd.ell_bits, slab.ell_bits)

    ell = got.fwd.ell.numpy()
    f_edges = band_edges(ell, r_blk)
    if got.t_ell is not None:
        t_edges = sorted((r, c) for c, r in band_edges(got.t_ell.numpy(), r_blk))
    else:
        ptr, rows = got.t_rowptr.numpy(), got.t_rows.numpy()
        cols = np.repeat(np.arange(n), np.diff(ptr))
        t_edges = sorted(zip(rows.tolist(), cols.tolist()))
    assert f_edges == t_edges
    ok = got.fwd.fb_src.numpy() >= 0
    fb = sorted(zip(got.fwd.fb_dst.numpy()[ok].tolist(), got.fwd.fb_src.numpy()[ok].tolist()))
    ptr = got.fb_t_rowptr.numpy()
    fb_t = sorted(zip(got.fb_t_dst.numpy().tolist(),
                      np.repeat(np.arange(n), np.diff(ptr)).tolist()))
    assert fb == fb_t
    assert len(f_edges) + len(fb) == len(indices)
    rptr = got.fwd.fb_rowptr.numpy()
    np.testing.assert_array_equal(
        np.repeat(np.arange(n), np.diff(rptr)), got.fwd.fb_dst.numpy()[ok])


@pytest.mark.parametrize("r_blk", [128, 512])
def test_shard_pair_carries_band_csr(r_blk):
    """Each rank's shard of a pair (``shard_attention_pair``, 4 ranks, the
    last ones past the graph's end) carries the band CSR by source of its
    own columns with destination rows shifted into the halo-extended
    numbering (global row - (w rs - R)); at R = 512 also its rows of
    ``t_ell``, whose window-local entries name the same rows in the same
    order."""
    n = 2100 if r_blk == 512 else 600
    rng = np.random.default_rng(r_blk + 1)
    _, _, indptr, indices = attention_graph(n, 5, r_blk // 2, rng)
    pair = grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk, max_k=8,
                                          device="cpu")
    world = 4
    nb = -(-(-(-n // r_blk)) // world) * world
    rs, n_pad = nb // world * r_blk, nb * r_blk
    ptr, rows = pair.t_rowptr.numpy(), pair.t_rows.numpy()
    t_ell = None if pair.t_ell is None else DF._padded(pair.t_ell.numpy(), n_pad, -1)
    for w in range(world):
        sp = DF.shard_attention_pair(pair, w, rs, n_pad, "cpu")
        sptr, srows = sp.t_rowptr.numpy(), sp.t_rows.numpy()
        assert sptr.shape == (rs + 1,) and sptr[0] == 0 and sptr[-1] == len(srows)
        assert sp.fb_t_dst.numel() == 0 and not sp.fb_t_rowptr.any()
        for c in range(rs):
            gc = w * rs + c
            want = rows[ptr[gc]:ptr[gc + 1]] - (w * rs - r_blk) if gc < n else []
            np.testing.assert_array_equal(srows[sptr[c]:sptr[c + 1]], want)
        assert (sp.t_ell is None) == (r_blk == 128)
        if r_blk == 512:
            own = sp.t_ell.numpy()
            np.testing.assert_array_equal(own, t_ell[w * rs:(w + 1) * rs])
            for c in range(rs):
                np.testing.assert_array_equal(own[c][own[c] >= 0] + (c // r_blk) * r_blk,
                                              srows[sptr[c]:sptr[c + 1]])


def _stats_close(m, s, m_want, s_want):
    """m + log(s) within 1e-5 where s > 0; s = 0 on the same rows (the
    stats themselves are not unique: the JAX merge returns max(max, 0))."""
    m, s = np.asarray(m), np.asarray(s)
    m_want, s_want = np.asarray(m_want), np.asarray(s_want)
    np.testing.assert_array_equal(s > 0, s_want > 0)
    pos = s > 0
    np.testing.assert_allclose(m[pos] + np.log(s[pos]),
                               m_want[pos] + np.log(s_want[pos]), rtol=1e-5, atol=1e-5)


def _check_against_jax(pair, jpair, heads, f, seed, h1=False):
    """The port's forward (out, m + log s) and backward (dx, dalpha_dst,
    dalpha_src) plain versions against the JAX kernels on the same inputs;
    the backward of both gets the JAX forward's (m, s) and
    t = sum(g * out).  With ``h1``, also the single-head backward on head 0
    (its own JAX kernel without bit planes)."""
    n = pair.fwd.num_rows
    x, ad, as_, g = inputs(n, heads, f, seed)

    @jax.jit
    def run(x, ad, as_, g):
        out, m, s = jax_slab.slab_attention_spmm_mh(jpair.fwd, x, ad, as_,
                                                    return_stats=True)
        t = jnp.sum(g * out, axis=-1)
        res = {"fwd": (out, m, s), "t": t,
               "bwd": jax_grad.slab_attention_bwd_mh(jpair, x, ad, as_, m, s, t, g)}
        if h1:
            res["bwd1"] = jax_grad.slab_attention_bwd(
                jpair, x[:, 0], ad[:, 0], as_[:, 0], m[:, 0], s[:, 0], t[:, 0], g[:, 0])
        return res

    want = jax.tree_util.tree_map(np.asarray, run(x, ad, as_, g))
    tx, tad, tas, tg = (torch.as_tensor(a) for a in (x, ad, as_, g))
    out, m, s = fwd.slab_attention_spmm_mh(pair.fwd, tx, tad, tas, return_stats=True)
    np.testing.assert_allclose(out.numpy(), want["fwd"][0], rtol=1e-5, atol=1e-5)
    _stats_close(m, s, want["fwd"][1], want["fwd"][2])
    assert not out[s == 0].any()
    # the same stats into both backwards
    jm, js, jt = (torch.tensor(a) for a in (want["fwd"][1], want["fwd"][2], want["t"]))
    got = grad.slab_attention_bwd_mh(pair, tx, tad, tas, jm, js, jt, tg)
    for a, b, name in zip(got, want["bwd"], ("dx", "dalpha_dst", "dalpha_src")):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)
    if h1:
        got1 = grad.slab_attention_bwd(pair, tx[:, 0], tad[:, 0], tas[:, 0], jm[:, 0],
                                       js[:, 0], jt[:, 0], tg[:, 0])
        for a, b, name in zip(got1, want["bwd1"], ("dx", "dalpha_dst", "dalpha_src")):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"H=1 {name}")
    return out, s


def test_attention_matches_jax_bit_planes():
    """R = 128: the forward kernel and the one-pass backward (row 6); odd F,
    four heads, empty rows and rows with only fallback edges."""
    rng = np.random.default_rng(1)
    _, _, indptr, indices = attention_graph(300, 5, 60, rng)
    kw = dict(block_rows=128, max_k=8)
    pair = grad.build_attention_slab_pair(indptr, indices, device="cpu", **kw)
    jpair = jax_grad.build_attention_slab_pair(indptr, indices, **kw)
    assert 0.0 < pair.fwd.band_fraction < 1.0
    out, s = _check_against_jax(pair, jpair, heads=4, f=5, seed=2)
    assert not s[10:12].any() and s[20:22].all()
    assert int((pair.fwd.ell[20:22] >= 0).sum()) == 0


def test_attention_matches_jax_t_ell():
    """R = 512 (no bit planes): the forward and the two-orientation backward
    kernels over t_ell, multi-head (row 8) and single-head (row 7)."""
    rng = np.random.default_rng(3)
    _, _, indptr, indices = attention_graph(1100, 4, 200, rng)
    kw = dict(block_rows=512, max_k=8)
    pair = grad.build_attention_slab_pair(indptr, indices, device="cpu", **kw)
    jpair = jax_grad.build_attention_slab_pair(indptr, indices, **kw)
    assert pair.t_ell is not None and 0.0 < pair.fwd.band_fraction < 1.0
    _check_against_jax(pair, jpair, heads=2, f=3, seed=4, h1=True)


def _plain_chain(indptr, indices, x, ad, as_, slope=0.2):
    """The attention aggregate as torch's own autograd sees it: edge
    scores, coo_edge_softmax, segment_spmm, one head at a time."""
    n = len(indptr) - 1
    rows = torch.as_tensor(np.repeat(np.arange(n), np.diff(indptr)), dtype=torch.int32)
    cols = torch.as_tensor(indices)
    outs = []
    for h in range(x.shape[1]):
        e = fwd.lrelu(ad[rows.long(), h] + as_[cols.long(), h], slope)
        p = sddmm.coo_edge_softmax(e, rows, n)
        outs.append(segment_spmm(x[:, h], cols, rows, n, reduce="sum", edge_weight=p))
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("r_blk", [128, 512])
def test_autograd_matches_torch_autograd(r_blk):
    """The differentiable attention (forward and backward plain versions)
    against torch's autograd through the plain COO chain: within 1e-5 and
    1e-4.  Three heads, both pair branches."""
    n = 600
    rng = np.random.default_rng(5)
    _, _, indptr, indices = attention_graph(n, 5, 100, rng)
    pair = grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk,
                                          max_k=8, device="cpu")
    x, ad, as_, g = inputs(n, 3, 4, 6)
    x, ad, as_ = (torch.tensor(a, requires_grad=True) for a in (x, ad, as_))
    g = torch.as_tensor(g)
    f = grad.differentiable_slab_attention_mh(pair)
    out = f(x, ad, as_)
    got = torch.autograd.grad((out * g).sum(), (x, ad, as_))
    ref = _plain_chain(indptr, indices, x, ad, as_)
    want = torch.autograd.grad((ref * g).sum(), (x, ad, as_))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_autograd_dtypes_and_single_head():
    """dx comes back in x's dtype and the alpha gradients in theirs; the
    single-head form is the H = 1 case of the multi-head one."""
    n = 300
    rng = np.random.default_rng(7)
    _, _, indptr, indices = attention_graph(n, 4, 60, rng)
    pair = grad.build_attention_slab_pair(indptr, indices, block_rows=128, device="cpu")
    x, ad, as_, _ = inputs(n, 1, 6, 8)
    xb = torch.tensor(x[:, 0]).to(torch.bfloat16).requires_grad_()
    a_d = torch.tensor(ad[:, 0], requires_grad=True)
    a_s = torch.tensor(as_[:, 0], requires_grad=True)
    out = grad.differentiable_slab_attention(pair)(xb, a_d, a_s)
    assert out.dtype == torch.float32 and out.shape == (n, 6)
    out.sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and a_d.grad.dtype == torch.float32
    want = fwd.slab_attention_spmm(pair.fwd, xb.detach(), a_d.detach(), a_s.detach())
    assert torch.equal(out.detach(), want)


def test_head_limits():
    n = 300
    rng = np.random.default_rng(9)
    _, _, indptr, indices = attention_graph(n, 3, 40, rng)
    pair = grad.build_attention_slab_pair(indptr, indices, block_rows=128, device="cpu")
    z = torch.zeros
    with pytest.raises(ValueError, match="heads"):
        grad.slab_attention_bwd_mh(pair, z((n, 26, 2)), z((n, 26)), z((n, 26)),
                                   z((n, 26)), torch.ones((n, 26)), z((n, 26)),
                                   z((n, 26, 2)))
    with pytest.raises(ValueError, match="heads"):
        fwd.slab_attention_spmm_mh(pair.fwd, z((n, 65, 1)), z((n, 65)), z((n, 65)))


def test_full_batch_graph_attention():
    """FullBatchGraph.attention_spmm_mh: on the slab path, 27 heads (a group
    of 25 and one of 2) equal the per-head single-head calls; off it
    (min_band_fraction above 1), the plain COO chain matches the JAX
    package's within 1e-5, forward and gradient."""
    n = 400
    rng = np.random.default_rng(10)
    src, dst, _, _ = attention_graph(n, 4, 60, rng)
    fbg = FullBatchGraph.from_coo(src, dst, n, reorder="none", block_rows=128,
                                  device="cpu")
    assert fbg.use_slab
    x, ad, as_, _ = (torch.as_tensor(a) for a in inputs(n, 27, 2, 11))
    got = fbg.attention_spmm_mh(x, ad, as_)
    for h in (0, 24, 25, 26):
        torch.testing.assert_close(got[:, h], fbg.attention_spmm(x[:, h], ad[:, h], as_[:, h]),
                                   rtol=0, atol=0)
    assert "attention_pair" in fbg.build_seconds

    kw = dict(reorder="none", block_rows=128, min_band_fraction=1.01)
    plain = FullBatchGraph.from_coo(src, dst, n, device="cpu", **kw)
    jplain = JaxFullBatchGraph.from_coo(src, dst, n, **kw)
    assert not plain.use_slab and not jplain.use_slab
    x, ad, as_, g = inputs(n, 2, 3, 12)

    def loss(x, ad, as_):
        out = jplain.attention_spmm_mh(x, ad, as_)
        return jnp.sum(out * g), out

    (jg, jout) = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(x, ad, as_)
    tx, tad, tas = (torch.tensor(a, requires_grad=True) for a in (x, ad, as_))
    out = plain.attention_spmm_mh(tx, tad, tas)
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for a, b in zip((tx, tad, tas), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_sddmm_ops_match_jax():
    """fanout_sddmm, fanout_attention_softmax, coo_sddmm and
    coo_edge_softmax against the JAX package's, within 1e-6."""
    rng = np.random.default_rng(13)
    s, k, f, n, e = 12, 5, 4, 30, 90
    xd = rng.standard_normal((s, f)).astype(np.float32)
    xn = rng.standard_normal((s, k, f)).astype(np.float32)
    mask = rng.random((s, k)) < 0.7
    mask[3] = False
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[::7] = -1
    dst[::11] = -1
    xs = rng.standard_normal((n, f)).astype(np.float32)
    scores = rng.standard_normal(e).astype(np.float32)

    @jax.jit
    def run(xd, xn, mask, xs, src, dst, scores):
        sc = jax_sddmm.fanout_sddmm(xd, xn, mask)
        return (sc, jax_sddmm.fanout_attention_softmax(sc, mask),
                jax_sddmm.coo_sddmm(xs, xs, src, dst),
                jax_sddmm.coo_edge_softmax(scores, dst, n))

    want = run(xd, xn, mask, xs, src, dst, scores)
    t = torch.as_tensor
    sc = sddmm.fanout_sddmm(t(xd), t(xn), t(mask))
    got = (sc, sddmm.fanout_attention_softmax(sc, t(mask)),
           sddmm.coo_sddmm(t(xs), t(xs), t(src), t(dst)),
           sddmm.coo_edge_softmax(t(scores), t(dst), n))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
