"""Port parity: row gather and scatter, PyTorch port against the JAX package.
Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cugraph_gnn_tpu.ops import gather as jax_gather
from cugraph_gnn_tpu.ops.pallas.gather_kernel import gather_rows_tpu
from cugraph_gnn_tpu_torch.ops import gather as port_gather
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _table_ids(seed, n=64, f=24, b=40):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, f)).astype(np.float32)
    ids = rng.integers(0, n, b).astype(np.int32)
    ids[::5] = -1
    ids[3] = n + 2          # past the end: both sides clamp to the last row
    return table, ids


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("fill", [0, 2.5])
def test_local_gather_matches_jax(out, fill):
    table, ids = _table_ids(0)
    jdt, tdt = _DTYPES[out]
    want = jax_gather.local_gather(jnp.asarray(table), jnp.asarray(ids),
                                   out_dtype=jdt, fill=fill)
    got = port_gather.local_gather(torch.as_tensor(table), torch.as_tensor(ids),
                                   out_dtype=tdt, fill=fill)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_local_scatter_matches_jax():
    table, _ = _table_ids(1)
    rng = np.random.default_rng(2)
    ids = rng.permutation(table.shape[0])[:20].astype(np.int32)
    ids[::4] = -1
    rows = rng.standard_normal((20, table.shape[1])).astype(np.float32)
    want = jax_gather.local_scatter(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(rows))
    got = port_gather.local_scatter(torch.as_tensor(table), torch.as_tensor(ids),
                                    torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_local_scatter_add_matches_jax():
    table, _ = _table_ids(3)
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, table.shape[0], 50).astype(np.int32)
    # small integers: every summation order gives the same float
    rows = rng.integers(-8, 8, (50, table.shape[1])).astype(np.float32)
    table = np.round(table * 4)
    want = jax_gather.local_scatter_add(jnp.asarray(table), jnp.asarray(ids),
                                        jnp.asarray(rows))
    got = port_gather.local_scatter_add(torch.as_tensor(table),
                                        torch.as_tensor(ids),
                                        torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def pallas_gather():
    """Inputs and the Pallas row-gather kernel's output in interpret mode
    (one run: interpret mode takes seconds)."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((64, 128)).astype(np.float32)
    ids = np.array([3, 0, 63, -1, 17, 5, 5, -1], np.int32)
    with pltpu.force_tpu_interpret_mode():
        out = gather_rows_tpu(jnp.asarray(table), jnp.asarray(ids))
    return table, ids, out


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_gather_rows_plain_matches_pallas_kernel(pallas_gather, out):
    """The kernel's plain version (the CPU path of ``gather_rows``) against
    the Pallas row-gather kernel; the Pallas kernel keeps the table's dtype,
    so the bf16 case casts its rows afterwards, as bench.py does."""
    table, ids, pallas_out = pallas_gather
    jdt, tdt = _DTYPES[out]
    got = gather_rows(torch.as_tensor(table), torch.as_tensor(ids), tdt)
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(pallas_out.astype(jdt), np.float32))
