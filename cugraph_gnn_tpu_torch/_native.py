"""ctypes binding for the repository's host C++ graph builders (``cpp/``).

Counterpart of ``cugraph_gnn_tpu/native.py``: the parallel counting-sort
CSR build and degree histogram (``cpp/csr_builder.cpp``), reverse
Cuthill-McKee reordering (``cpp/reorder.cpp``) and the multithreaded read of
a byte range of a file list (``cpp/file_loader.cpp``).  The sources are
compiled with g++ (the flags of ``cpp/Makefile``) into
``cugraph_gnn_tpu_torch/_build/`` at first use, named by a digest of the
sources and flags; ``cpp/``'s own tracked library is never rebuilt or loaded.
Being the same C++, it gives the JAX package's CSR layouts, degrees, RCM
orders and bytes.

Without a host compiler the NumPy versions below run instead, as they do in
the JAX package; they also serve empty graphs.  A native file read that
fails raises ``OSError`` (the JAX package retries it with plain reads).
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from cugraph_gnn_tpu_torch import _build

CPP_DIR = Path(__file__).resolve().parent.parent / "cpp"
SOURCES = (CPP_DIR / "csr_builder.cpp", CPP_DIR / "reorder.cpp",
           CPP_DIR / "file_loader.cpp")
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)


def _load() -> Optional[ctypes.CDLL]:
    """The host library, built at first use; None when there is no g++."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _build.host_library("host_graph", SOURCES, FLAGS)
        except FileNotFoundError:
            return None
        lib = ctypes.CDLL(str(path))
        lib.build_csr_i32.argtypes = [_I32, _I32, ctypes.c_int64, ctypes.c_int64,
                                      _I64, _I32, _I64]
        lib.build_csr_i32.restype = None
        lib.degrees_i32.argtypes = [_I32, ctypes.c_int64, ctypes.c_int64, _I64]
        lib.degrees_i32.restype = None
        lib.load_filelist_range.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _I64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
        lib.load_filelist_range.restype = ctypes.c_int
        lib.rcm_order_i32.argtypes = [_I64, _I32, ctypes.c_int64, _I32]
        lib.rcm_order_i32.restype = None
        lib.apply_order_csr_i32.argtypes = [_I64, _I32, _I32, ctypes.c_int64,
                                            _I64, _I32, _I64]
        lib.apply_order_csr_i32.restype = None
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


def _i32ptr(a):
    return a.ctypes.data_as(_I32)


def _i64ptr(a):
    return a.ctypes.data_as(_I64)


def build_csr(key, val, num_nodes: int):
    """CSR build: rows = key, cols = val.  Returns (indptr int64, indices
    int32, perm int64), perm mapping CSR position -> input edge; stable
    within rows."""
    key = np.ascontiguousarray(key, np.int32)
    val = np.ascontiguousarray(val, np.int32)
    e = len(key)
    lib = _load()
    if lib is not None and e > 0:
        indptr = np.zeros(num_nodes + 1, np.int64)
        indices = np.zeros(e, np.int32)
        perm = np.zeros(e, np.int64)
        lib.build_csr_i32(_i32ptr(key), _i32ptr(val), e, num_nodes,
                          _i64ptr(indptr), _i32ptr(indices), _i64ptr(perm))
        return indptr, indices, perm
    return build_csr_np(key, val, num_nodes)


def build_csr_np(key, val, num_nodes: int):
    """NumPy version of :func:`build_csr` (stable argsort)."""
    key = np.asarray(key, np.int32)
    val = np.asarray(val, np.int32)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=num_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, val[order], order.astype(np.int64)


def degrees(key, num_nodes: int) -> np.ndarray:
    """The int64 count of each node id in ``key`` (num_nodes,)."""
    key = np.ascontiguousarray(key, np.int32)
    lib = _load()
    if lib is not None and len(key) > 0:
        out = np.zeros(num_nodes, np.int64)
        lib.degrees_i32(_i32ptr(key), len(key), num_nodes, _i64ptr(out))
        return out
    return degrees_np(key, num_nodes)


def degrees_np(key, num_nodes: int) -> np.ndarray:
    """NumPy version of :func:`degrees`."""
    return np.bincount(np.asarray(key, np.int32), minlength=num_nodes).astype(np.int64)


def load_filelist_bytes(paths: Sequence[str], range_off: int, range_len: int,
                        num_threads: int = 8, use_direct: bool = False) -> np.ndarray:
    """Bytes [range_off, range_off + range_len) of the files in ``paths``
    read as one concatenation, as uint8: ``num_threads`` reader threads over
    64 MiB spans, with ``O_DIRECT`` through an aligned staging buffer when
    ``use_direct`` (plain reads where the file system refuses it)."""
    lib = _load()
    if lib is None:
        return load_filelist_bytes_np(paths, range_off, range_len)
    out = np.zeros(range_len, np.uint8)
    sizes = np.array([os.path.getsize(p) for p in paths], np.int64)
    names = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    rc = lib.load_filelist_range(names, _i64ptr(sizes), len(paths), range_off, range_len,
                                 out.ctypes.data, num_threads, int(use_direct))
    if rc != 0:
        raise OSError(f"reading bytes [{range_off}, {range_off + range_len}) of {list(paths)} "
                      "failed")
    return out


def load_filelist_bytes_np(paths: Sequence[str], range_off: int,
                           range_len: int) -> np.ndarray:
    """NumPy version of :func:`load_filelist_bytes`: one plain read a file."""
    out = np.zeros(range_len, np.uint8)
    file_start = 0
    for p in paths:
        size = os.path.getsize(p)
        a = max(range_off, file_start)
        b = min(range_off + range_len, file_start + size)
        if a < b:
            with open(p, "rb") as f:
                f.seek(a - file_start)
                out[a - range_off:b - range_off] = np.frombuffer(f.read(b - a), np.uint8)
        file_start += size
    return out


def rcm_order(indptr, indices) -> np.ndarray:
    """Reverse Cuthill-McKee node order over a CSR graph: ``order`` (int32)
    with ``order[new_id] = old_id``."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    n = len(indptr) - 1
    lib = _load()
    if lib is not None and n > 0:
        out = np.zeros(n, np.int32)
        lib.rcm_order_i32(_i64ptr(indptr), _i32ptr(indices), n, _i32ptr(out))
        return out
    return rcm_order_np(indptr, indices)


def rcm_order_np(indptr, indices) -> np.ndarray:
    """NumPy version of :func:`rcm_order`: min-degree seeds, frontier
    visited in ascending degree (stable where the C++ sort is not, so ties
    may order differently), reversed."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int32)
    n = len(indptr) - 1
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    by_deg = np.argsort(deg, kind="stable")
    visited = np.zeros(n, bool)
    order = []
    cursor = 0
    while len(order) < n:
        while visited[by_deg[cursor]]:
            cursor += 1
        seed = int(by_deg[cursor])
        visited[seed] = True
        order.append(seed)
        head = len(order) - 1
        while head < len(order):
            u = order[head]
            head += 1
            nb = indices[indptr[u]:indptr[u + 1]]
            nb = nb[(nb >= 0) & (nb < n)]
            nb = np.unique(nb[~visited[nb]])
            nb = nb[np.argsort(deg[nb], kind="stable")]
            visited[nb] = True
            order.extend(int(v) for v in nb)
    return np.asarray(order[::-1], np.int32)


def apply_order_csr(indptr, indices, order):
    """Relabel a CSR by a node order (new node i = order[i]); neighbor ids
    map through the inverse permutation and sort within rows.  Returns
    (new_indptr int64, new_indices int32, edge_perm int64), edge_perm
    mapping new edge position -> old edge position."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    order = np.ascontiguousarray(order, np.int32)
    n = len(indptr) - 1
    e = len(indices)
    lib = _load()
    if lib is not None and n > 0:
        new_indptr = np.zeros(n + 1, np.int64)
        new_indices = np.zeros(e, np.int32)
        edge_perm = np.zeros(e, np.int64)
        lib.apply_order_csr_i32(
            _i64ptr(indptr), _i32ptr(indices), _i32ptr(order), n,
            _i64ptr(new_indptr), _i32ptr(new_indices), _i64ptr(edge_perm))
        return new_indptr, new_indices, edge_perm
    return apply_order_csr_np(indptr, indices, order)


def apply_order_csr_np(indptr, indices, order):
    """NumPy version of :func:`apply_order_csr`."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int32)
    order = np.asarray(order, np.int32)
    n = len(indptr) - 1
    e = len(indices)
    inv = np.zeros(n, np.int32)
    inv[order] = np.arange(n, dtype=np.int32)
    deg = indptr[1:] - indptr[:-1]
    lens = deg[order]
    new_indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    if not e:
        return new_indptr, np.zeros(0, np.int32), np.zeros(0, np.int64)
    # ragged gather of the permuted rows' edge ranges
    starts = indptr[order]
    offs = np.repeat(starts - new_indptr[:-1], lens)
    old_pos = offs + np.arange(int(lens.sum()), dtype=np.int64)
    vals = indices[old_pos]
    mapped = np.where((vals >= 0) & (vals < n), inv[np.clip(vals, 0, n - 1)], vals)
    # in-row sort: stable argsort on (row, value) keys
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    key = rows * (np.int64(n) + 1) + np.clip(mapped, -1, n).astype(np.int64) + 1
    sorter = np.argsort(key, kind="stable")
    return new_indptr, mapped[sorter].astype(np.int32), old_pos[sorter]
