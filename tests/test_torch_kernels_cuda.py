"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``card`` fixture for a device and skips
without one.  The file imports no JAX, so on the machine with the card it
runs without the repo's conftest (which configures JAX):

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -o addopts= -q
"""

import numpy as np
import pytest
import torch

from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows, gather_rows_ref
from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
    fused_uniform_sample,
    fused_uniform_sample_ref,
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
