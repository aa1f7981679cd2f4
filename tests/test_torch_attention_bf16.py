"""Port parity: the attention backward's bfloat16 compute mode (the JAX
package's ``compute_dtype`` / ``bwd_compute_dtype``; rows 6-8 of the
TPU-kernel table) against the JAX package on the CPU, its Pallas kernels in
interpret mode, one jitted call per pair.  The band edges' products take g,
x and the attention weight rounded to bfloat16, sums and fallback edges stay
float32.  Tolerance: 1e-4 absolute and relative, the float32 gradients'
(``test_torch_attention.py``); the mode is real: on the same inputs the
bfloat16 gradients differ from the float32 ones by more than that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cugraph_gnn_tpu.ops.pallas import slab_attn_grad as jax_grad
from cugraph_gnn_tpu.ops.pallas import slab_kernel as jax_slab
from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as grad
from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import slab_attention_spmm_mh
from test_torch_attention import attention_graph, inputs

TOL = 1e-4
NAMES = ("dx", "dalpha_dst", "dalpha_src")


def _case(r_blk, n, deg, band, heads, f, seed):
    """A pair (port and JAX, the same host split), numpy-seeded inputs and,
    from one jitted JAX call: the forward's stats, t = sum(g * out), the
    bfloat16 backward (multi-head; at H = 2 also the single-head kernel on
    head 0) and the gradients of sum(f(x, ad, as) * g) through the
    differentiable attention with ``bwd_compute_dtype`` bfloat16."""
    rng = np.random.default_rng(seed)
    _, _, indptr, indices = attention_graph(n, deg, band, rng)
    kw = dict(block_rows=r_blk, max_k=8)
    pair = grad.build_attention_slab_pair(indptr, indices, device="cpu", **kw)
    jpair = jax_grad.build_attention_slab_pair(indptr, indices, **kw)
    assert (pair.t_ell is None) == (r_blk == 128)
    assert 0.0 < pair.fwd.band_fraction < 1.0       # fallback edges too
    x, ad, as_, g = inputs(n, heads, f, seed + 1)
    bf16 = jnp.bfloat16

    @jax.jit
    def run(x, ad, as_, g):
        out, m, s = jax_slab.slab_attention_spmm_mh(jpair.fwd, x, ad, as_,
                                                    return_stats=True)
        t = jnp.sum(g * out, axis=-1)
        res = {"m": m, "s": s, "t": t,
               "bwd": jax_grad.slab_attention_bwd_mh(jpair, x, ad, as_, m, s, t, g,
                                                     compute_dtype=bf16)}
        if heads > 1:
            res["bwd1"] = jax_grad.slab_attention_bwd(
                jpair, x[:, 0], ad[:, 0], as_[:, 0], m[:, 0], s[:, 0], t[:, 0], g[:, 0],
                compute_dtype=bf16)
            fn = jax_grad.differentiable_slab_attention_mh(jpair, bwd_compute_dtype=bf16)
            res["autograd"] = jax.grad(lambda *a: jnp.sum(fn(*a) * g),
                                       argnums=(0, 1, 2))(x, ad, as_)
        else:
            fn = jax_grad.differentiable_slab_attention(jpair, bwd_compute_dtype=bf16)
            res["autograd"] = jax.grad(lambda *a: jnp.sum(fn(*a) * g[:, 0]),
                                       argnums=(0, 1, 2))(x[:, 0], ad[:, 0], as_[:, 0])
        return res

    want = jax.tree_util.tree_map(np.array, run(x, ad, as_, g))
    t = {k: torch.as_tensor(v) for k, v in
         dict(x=x, ad=ad, as_=as_, g=g, m=want["m"], s=want["s"], t=want["t"]).items()}
    return pair, t, want


@pytest.fixture(scope="module")
def bit_planes():
    """R = 128 (bit planes: row 6), four heads of odd width 5."""
    return _case(128, 300, 5, 60, heads=4, f=5, seed=21)


@pytest.fixture(scope="module")
def t_ell_pair():
    """R = 512 (t_ell: rows 7 and 8), two heads of width 3."""
    return _case(512, 1100, 4, 200, heads=2, f=3, seed=23)


@pytest.fixture(scope="module")
def t_ell_single():
    """R = 512, one head of width 3 (row 7, and its single-head autograd)."""
    return _case(512, 1100, 4, 200, heads=1, f=3, seed=25)


def _close(got, want, what):
    for a, b, name in zip(got, want, NAMES):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=f"{what} {name}")


def _differs(got, f32, what):
    """The bfloat16 gradients move away from the float32 ones by more than
    the tolerance (the band products' rounding)."""
    for a, b, name in zip(got, f32, NAMES):
        diff = float((a - b).abs().max())
        assert diff > TOL, f"{what} {name}: bf16 within {diff} of f32"


@pytest.mark.parametrize("case", ["bit_planes", "t_ell_pair", "t_ell_single"])
def test_bwd_bf16_matches_jax(case, request):
    """``slab_attention_bwd_mh(..., compute_dtype=bfloat16)`` (row 6 with
    bit planes, row 8 at H = 2, row 7 at H = 1) against the JAX kernels'
    ``compute_dtype=jnp.bfloat16`` on the same stats; at H = 2 also the
    single-head ``slab_attention_bwd`` on head 0 (row 7's own kernel)."""
    pair, t, want = request.getfixturevalue(case)
    args = (pair, t["x"], t["ad"], t["as_"], t["m"], t["s"], t["t"], t["g"])
    got = grad.slab_attention_bwd_mh(*args, compute_dtype=torch.bfloat16)
    _close(got, want["bwd"], case)
    _differs(got, grad.slab_attention_bwd_mh(*args), case)
    if "bwd1" in want:
        head0 = [a[:, 0] for a in args[1:]]
        got1 = grad.slab_attention_bwd(pair, *head0, compute_dtype=torch.bfloat16)
        _close(got1, want["bwd1"], f"{case} H=1")
        _differs(got1, grad.slab_attention_bwd(pair, *head0), f"{case} H=1")


@pytest.mark.parametrize("case", ["bit_planes", "t_ell_pair", "t_ell_single"])
def test_differentiable_bf16_matches_jax(case, request):
    """``differentiable_slab_attention_mh`` (H > 1) and
    ``differentiable_slab_attention`` (H = 1) with ``bwd_compute_dtype``
    bfloat16 through autograd against JAX's custom VJP with
    ``bwd_compute_dtype=jnp.bfloat16``."""
    pair, t, want = request.getfixturevalue(case)
    heads = t["x"].shape[1]
    leaves = [a.clone().requires_grad_() for a in (t["x"], t["ad"], t["as_"])]
    g = t["g"]
    if heads == 1:
        leaves = [a[:, 0].detach().requires_grad_() for a in leaves]
        g = g[:, 0]
        fn = grad.differentiable_slab_attention(pair, bwd_compute_dtype=torch.bfloat16)
    else:
        fn = grad.differentiable_slab_attention_mh(pair, bwd_compute_dtype=torch.bfloat16)
    (fn(*leaves) * g).sum().backward()
    _close([a.grad for a in leaves], want["autograd"], case)


def test_compute_dtype_default_and_refusals(bit_planes):
    """The default (float32) equals an explicit float32 bit for bit; any
    other dtype raises TypeError in every entry that takes one."""
    pair, t, _ = bit_planes
    args = (pair, t["x"], t["ad"], t["as_"], t["m"], t["s"], t["t"], t["g"])
    for a, b in zip(grad.onepass_bwd(*args),
                    grad.onepass_bwd(*args, compute_dtype=torch.float32)):
        assert torch.equal(a, b)
    head0 = [a[:, 0] for a in args[1:]]
    for call in (lambda dt: grad.onepass_bwd(*args, compute_dtype=dt),
                 lambda dt: grad.slab_attention_bwd_mh(*args, compute_dtype=dt),
                 lambda dt: grad.slab_attention_bwd(pair, *head0, compute_dtype=dt),
                 lambda dt: grad.slab_attention_bwd_ref(*args, compute_dtype=dt),
                 lambda dt: grad.differentiable_slab_attention_mh(pair, bwd_compute_dtype=dt),
                 lambda dt: grad.differentiable_slab_attention(pair, bwd_compute_dtype=dt)):
        with pytest.raises(TypeError, match="compute_dtype"):
            call(torch.float16)


@pytest.mark.parametrize("r_blk", [128, 512])
def test_all_fallback_graph_is_unrounded(r_blk):
    """A graph whose every edge is a fallback edge (no band; at R = 512 a
    t_ell pair without entries): the bfloat16 mode changes nothing, bit for
    bit."""
    n = 1600
    rng = np.random.default_rng(27)
    dst = np.repeat(np.arange(n), 3)
    src = (dst + rng.integers(600, 1000, dst.shape[0])) % n   # all beyond +-512
    indptr, indices, _ = _native.build_csr(dst.astype(np.int32), src.astype(np.int32), n)
    pair = grad.build_attention_slab_pair(indptr, indices, block_rows=r_blk, device="cpu")
    assert not bool((pair.fwd.ell >= 0).any()) and pair.t_rows.numel() == 0
    assert (pair.t_ell is None) == (r_blk == 128)
    x, ad, as_, g = (torch.as_tensor(a) for a in inputs(n, 2, 5, 28))
    t = torch.as_tensor(np.random.default_rng(29).standard_normal((n, 2)), dtype=torch.float32)
    _, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
    args = (pair, x, ad, as_, m, s, t, g)
    for a, b in zip(grad.onepass_bwd(*args),
                    grad.onepass_bwd(*args, compute_dtype=torch.bfloat16)):
        assert torch.equal(a, b)
