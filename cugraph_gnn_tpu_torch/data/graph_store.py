"""GraphStore: a PyG-style store of typed COO edge indices, finalized into
the reversed CSR that the samplers read.

Counterpart of ``cugraph_gnn_tpu/data/graph_store.py``.  ``put_edge_index``
takes COO edges keyed by (src_type, rel_type, dst_type); ``finalize`` builds,
once, a CSR per edge type over the *reversed* edges (rows = destinations,
since sampling expands from seeds along incoming edges, as PyG does), in one
global id space with per-node-type offsets in lexicographic order.  The CSR
is built on the host by the repository's counting-sort builder
(``_native.build_csr``) and put on the store's device.  The port's sampler
reads neighbor ids directly, so ``indices`` carries no line padding.

``put_local_edge_index`` takes this rank's slice of an edge type's edges
instead (the logical global COO is the ranks' slices in rank order).  Such a
store feeds ``loader.DistNeighborLoader``, which routes the slices to their
owners (``store/edge_exchange.py``); ``finalize`` refuses it, since no rank
holds the global COO.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cugraph_gnn_tpu_torch import _native
from cugraph_gnn_tpu_torch._device import resolve_device

EdgeType = Tuple[str, str, str]


def edge_type_str(et: EdgeType) -> str:
    return "__".join(et)


def _host(a) -> np.ndarray:
    """A numpy view of an array or tensor (copied to the host if needed)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class GraphStore:
    """Stores typed COO edge indices; ``finalize()`` builds the sampling CSR
    on ``device`` (default: the card)."""

    def __init__(self, *, device=None):
        self._edges: Dict[EdgeType, Tuple[np.ndarray, np.ndarray]] = {}
        self._local: set = set()      # edge types put as this rank's slice
        self._num_nodes: Dict[str, int] = {}
        self._graph: Optional[SamplingGraph] = None
        self.device = resolve_device(device)

    # -- PyG GraphStore surface ---------------------------------------------

    def put_edge_index(self, edge_index, edge_type: EdgeType, layout: str = "coo",
                       num_nodes: Optional[Tuple[int, int]] = None):
        """Edges ``edge_index = (src, dst)`` of ``edge_type``, COO only."""
        if layout != "coo":
            raise ValueError("only layout='coo' is supported")
        src, dst = _host(edge_index[0]), _host(edge_index[1])
        st, _, dt = edge_type
        if num_nodes is None:
            num_nodes = (int(src.max(initial=-1)) + 1, int(dst.max(initial=-1)) + 1)
        self._num_nodes[st] = max(self._num_nodes.get(st, 0), int(num_nodes[0]))
        self._num_nodes[dt] = max(self._num_nodes.get(dt, 0), int(num_nodes[1]))
        self._edges[edge_type] = (src, dst)
        self._local.discard(edge_type)
        self._graph = None

    def put_local_edge_index(self, edge_index, edge_type: EdgeType, layout: str = "coo",
                             num_nodes: Optional[Tuple[int, int]] = None):
        """This rank's slice ``edge_index = (src, dst)`` of ``edge_type``'s
        edges (every rank of the default process group passes its own).
        ``num_nodes`` must be the global (source, destination) node counts;
        when omitted they are agreed as the largest id + 1 over the ranks
        (one all-reduce, max, over the default process group on the store's
        device: every rank calls it together)."""
        if layout != "coo":
            raise ValueError("only layout='coo' is supported")
        src, dst = _host(edge_index[0]), _host(edge_index[1])
        st, _, dt = edge_type
        if num_nodes is None:
            from cugraph_gnn_tpu_torch.parallel.mesh import create_store_mesh
            from cugraph_gnn_tpu_torch.store.dist_array import all_reduce_np

            num_nodes = tuple(int(v) for v in all_reduce_np(
                [int(src.max(initial=-1)) + 1, int(dst.max(initial=-1)) + 1],
                create_store_mesh(self.device), "max"))
        self._num_nodes[st] = max(self._num_nodes.get(st, 0), int(num_nodes[0]))
        self._num_nodes[dt] = max(self._num_nodes.get(dt, 0), int(num_nodes[1]))
        self._edges[edge_type] = (src, dst)
        self._local.add(edge_type)
        self._graph = None

    @property
    def has_local_edges(self) -> bool:
        """Whether any edge type holds this rank's slice only."""
        return bool(self._local)

    def get_edge_index(self, edge_type: EdgeType, layout: str = "coo"):
        return self._edges[edge_type]

    def remove_edge_index(self, edge_type: EdgeType):
        self._edges.pop(edge_type, None)
        self._local.discard(edge_type)
        self._graph = None

    def get_all_edge_attrs(self):
        return list(self._edges.keys())

    # -- introspection -------------------------------------------------------

    @property
    def node_types(self) -> List[str]:
        return sorted(self._num_nodes.keys())

    @property
    def edge_types(self) -> List[EdgeType]:
        return sorted(self._edges.keys())

    def num_nodes(self, node_type: Optional[str] = None) -> int:
        if node_type is not None:
            return self._num_nodes[node_type]
        return sum(self._num_nodes.values())

    @property
    def is_homogeneous(self) -> bool:
        return len(self.node_types) <= 1 and len(self._edges) <= 1

    def node_offset(self, node_type: str) -> int:
        """Global-id offset of a node type (types packed in lexicographic
        order)."""
        off = 0
        for nt in self.node_types:
            if nt == node_type:
                return off
            off += self._num_nodes[nt]
        raise KeyError(node_type)

    def finalize(self) -> "SamplingGraph":
        """The reversed-CSR sampling graph, built at the first call.  Raises
        for a store of rank-local slices, which no one rank can build."""
        if self.has_local_edges:
            raise ValueError("this store holds rank-local edge slices "
                             "(put_local_edge_index); a one-device sampling graph needs "
                             "the global COO: use loader.DistNeighborLoader, which "
                             "routes the slices to their owners")
        if self._graph is None:
            self._graph = SamplingGraph.build(self)
        return self._graph


@dataclasses.dataclass
class SamplingGraph:
    """CSRs over the global id space, reversed edges, on one device.

    csr_by_etype: edge type -> (indptr (N_total+1,) int32, indices int32,
      edge_base): row v lists v's in-neighbors under that type, and a
      sampled edge id is its CSR position + ``edge_base``.
    edge_perm_by_etype: edge type -> CSR position -> input COO position
      (host), which :meth:`edge_attr_to_csr_order` applies.
    """

    num_nodes_total: int
    node_offsets: Dict[str, int]
    etypes: List[EdgeType]
    csr_by_etype: Dict[EdgeType, Tuple[torch.Tensor, torch.Tensor, int]]
    max_degree_by_etype: Dict[EdgeType, int]
    edge_perm_by_etype: Dict[EdgeType, np.ndarray]
    device: torch.device

    @staticmethod
    def build(store: GraphStore) -> "SamplingGraph":
        offsets = {nt: store.node_offset(nt) for nt in store.node_types}
        total = store.num_nodes()
        total_edges = sum(len(src) for src, _ in store._edges.values())
        if total_edges >= 2**31 - 1 or total >= 2**31 - 1:
            raise ValueError(f"{total} nodes and {total_edges} edges exceed the "
                             "int32 ids of the single-device sampler")
        csrs, maxdeg, perms = {}, {}, {}
        edge_base = 0
        for et in store.edge_types:
            st, _, dt = et
            src, dst = store._edges[et]
            indptr, indices, perm = _native.build_csr(
                dst.astype(np.int64) + offsets[dt], src.astype(np.int64) + offsets[st],
                total)
            csrs[et] = (torch.as_tensor(indptr.astype(np.int32), device=store.device),
                        torch.as_tensor(indices, device=store.device), edge_base)
            perms[et] = np.asarray(perm)
            maxdeg[et] = int(np.diff(indptr).max(initial=0))
            edge_base += len(src)
        return SamplingGraph(num_nodes_total=total, node_offsets=offsets,
                             etypes=store.edge_types, csr_by_etype=csrs,
                             max_degree_by_etype=maxdeg, edge_perm_by_etype=perms,
                             device=store.device)

    def edge_attr_to_csr_order(self, et: EdgeType, attr) -> torch.Tensor:
        """An edge attribute given in COO input order, reordered so that
        sampled edge ids index it, on the graph's device."""
        return torch.as_tensor(_host(attr)[self.edge_perm_by_etype[et]], device=self.device)

    @property
    def is_homogeneous(self) -> bool:
        return len(self.etypes) <= 1

    def homogeneous_csr(self):
        if not self.is_homogeneous:
            raise ValueError("the graph has several edge types")
        indptr, indices, _ = self.csr_by_etype[self.etypes[0]]
        return indptr, indices
