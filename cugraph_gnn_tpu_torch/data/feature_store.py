"""FeatureStore: a PyG-style keyed store of node (and edge) tensors.

Counterpart of ``cugraph_gnn_tpu/data/feature_store.py`` for tensors held on
the device: keyed by (group_name, attr_name), each a tensor on the store's
device, or, when a mesh is given, a row-sharded ``store.DistArray`` whose
id gathers exchange rows between the ranks.  A local gather of a 2-D
float32 or bfloat16 table runs the row-gather kernel
(``ops/kernels/gather_kernel.py::gather_rows``) in the table's dtype; other
tables (labels, integer columns) are indexed plainly.  Ids of -1 give zero
rows; ids past the end read the last row, as the JAX gather clamps them.

``location="host"`` keeps a tensor in host memory (a numpy array) behind a
``embedding.cached.HostManagedCache`` on the store's device, sized by a
``embedding.cache.CachePolicy`` (kinds ``host``, and ``host1d`` for a 1-D
tensor held as one column): the reference's host-memory features with a
device cache, for tables larger than the card.  Its id gathers go through
the cache (ids past the end give zero rows there, as in JAX); ``prefetch``
plans the next gather in a worker thread.  A policy of kind ``"none"``
gives no cache: gathers index the host array.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.embedding.cache import CachePolicy
from cugraph_gnn_tpu_torch.embedding.cached import HostManagedCache
from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import read_rows
from cugraph_gnn_tpu_torch.parallel.mesh import Mesh
from cugraph_gnn_tpu_torch.store.dist_array import DistArray
from cugraph_gnn_tpu_torch.store.partition import PartitionBook

_HOST_KINDS = ("host", "host1d")


class FeatureStore:
    """Keyed feature store.  ``mesh=None`` keeps each tensor whole on
    ``device`` (default: the card); with a mesh (whose axis must be
    ``axis``) each is row-sharded over its ranks on ``mesh.device``.

    pad_features_to: pad 2-D tensors' feature width up to a multiple of
    this; full reads slice back to the logical width, id gathers return the
    padded rows.
    """

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "store",
                 pad_features_to: Optional[int] = None, *, device=None):
        if mesh is not None and mesh.axis != axis:
            raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
        self.mesh = mesh
        self.axis = axis
        self.pad_features_to = pad_features_to
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._store: Dict[Tuple[str, str], Tuple[str, object]] = {}
        self._logical_width: Dict[Tuple[str, str], int] = {}

    @staticmethod
    def _key(group_name: Optional[str], attr_name: str):
        return (group_name or "", attr_name)

    # -- PyG FeatureStore surface -------------------------------------------

    def put_tensor(self, tensor, group_name: Optional[str], attr_name: str,
                   book: Optional[PartitionBook] = None, location: str = "device",
                   cache_policy: Optional[CachePolicy] = None):
        """Store ``tensor`` (numpy or torch) under (group_name, attr_name):
        on the device (``location="device"``; row-sharded with a mesh), or
        in host memory behind a device cache (``location="host"``, sized by
        ``cache_policy``, default ``CachePolicy()``)."""
        if location not in ("device", "host"):
            raise ValueError(f"location must be 'device' or 'host', got {location!r}")
        key = self._key(group_name, attr_name)
        t = tensor if isinstance(tensor, torch.Tensor) else torch.as_tensor(np.asarray(tensor))
        if self.pad_features_to and t.dim() == 2 and t.shape[1] % self.pad_features_to:
            self._logical_width[key] = t.shape[1]
            t = torch.nn.functional.pad(t, (0, -t.shape[1] % self.pad_features_to))
        if location == "host":
            host = t.cpu().numpy()
            kind = "host1d" if host.ndim == 1 else "host"
            host = host[:, None] if kind == "host1d" else host
            policy = cache_policy or CachePolicy()
            cap = policy.capacity_for(host.shape[0])
            cache = (HostManagedCache(host, cap, ways=policy.ways, device=self.device)
                     if cap else None)
            self._store[key] = (kind, (host, cache))
        elif self.mesh is None:
            self._store[key] = ("local", t.to(self.device).contiguous())
        elif t.dim() == 1:
            self._store[key] = ("1d", DistArray.from_array(t[:, None], self.mesh, book=book))
        else:
            self._store[key] = ("2d", DistArray.from_array(t, self.mesh, book=book))

    def get_tensor(self, group_name: Optional[str], attr_name: str, ids=None):
        """The whole logical tensor (ids None), or its rows at ``ids``
        (padded rows when ``pad_features_to`` is set); either way on the
        store's device."""
        key = self._key(group_name, attr_name)
        kind, val = self._store[key]
        if ids is None:
            if kind == "local":
                out = val
            elif kind in _HOST_KINDS:
                out = torch.from_numpy(val[0]).to(self.device)
            else:
                out = val.to_global().to(self.device)
            if kind in ("1d", "host1d"):
                out = out[:, 0]
            elif key in self._logical_width:
                out = out[:, :self._logical_width[key]]
            return out
        if kind in _HOST_KINDS:
            host, cache = val
            if cache is not None:
                rows = cache.gather(ids)
            else:
                ids = torch.as_tensor(ids).cpu()
                rows = read_rows(torch.from_numpy(host), ids).to(self.device)
            return rows[:, 0] if kind == "host1d" else rows
        ids = torch.as_tensor(ids, device=self.device)
        if kind == "local":
            return read_rows(val, ids)
        rows = val.gather(ids)
        return rows[:, 0] if kind == "1d" else rows

    def prefetch(self, group_name: Optional[str], attr_name: str, ids) -> None:
        """Start the host side (plan and row fetch) of the next
        ``get_tensor(ids=ids)`` of a host-located tensor in a worker thread;
        nothing for device tensors."""
        kind, val = self._store[self._key(group_name, attr_name)]
        if kind in _HOST_KINDS and val[1] is not None:
            val[1].prefetch(ids)

    def remove_tensor(self, group_name: Optional[str], attr_name: str):
        self._store.pop(self._key(group_name, attr_name), None)

    def get_tensor_size(self, group_name: Optional[str], attr_name: str):
        kind, val = self._store[self._key(group_name, attr_name)]
        shape = tuple(val[0].shape if kind in _HOST_KINDS else val.shape)
        return shape[:1] if kind in ("1d", "host1d") else shape

    def get_all_tensor_attrs(self):
        return list(self._store.keys())

    def __contains__(self, key):
        group, name = key if isinstance(key, tuple) else ("", key)
        return self._key(group, name) in self._store

    def __setitem__(self, key, tensor):
        group, name = key if isinstance(key, tuple) else ("", key)
        self.put_tensor(tensor, group, name)

    def __getitem__(self, key):
        group, name = key if isinstance(key, tuple) else ("", key)
        return self.get_tensor(group, name)

    def multi_get_tensor(self, keys, ids=None):
        return [self.get_tensor(g, n, ids) for g, n in keys]
