"""GraphStructure: a CSR graph with attribute tensors and its samplers.

Counterpart of ``cugraph_gnn_tpu/graph_structure.py`` (the WholeGraph-style
container): ``set_csr_graph``, node and edge attributes, the unweighted and
weighted one-hop samplers and ``multilayer_sample_without_replacement``
(weighted with ``weight_name``) over the port's ``NeighborSampler``, on one
device.  Every sampler takes optional draws, uniforms ``u`` or the weighted
hops' key words ``hash_key(s)`` (as ``ops/sample.py`` and
``NeighborSampler.sample`` do), or draws from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.sample import SampleOutput, uniform_sample, weighted_sample
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler
from cugraph_gnn_tpu_torch.sampler.output import MultihopBatch


class GraphStructure:
    """CSR graph with attribute tensors on ``device`` (default: the card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.indptr: Optional[torch.Tensor] = None
        self.indices: Optional[torch.Tensor] = None
        self.node_attrs: Dict[str, torch.Tensor] = {}
        self.edge_attrs: Dict[str, torch.Tensor] = {}
        self.num_nodes = 0
        self.num_edges = 0

    def set_csr_graph(self, indptr, indices):
        self.indptr = torch.as_tensor(indptr, device=self.device).to(torch.int32)
        self.indices = torch.as_tensor(indices, device=self.device).to(torch.int32)
        self.num_nodes = int(self.indptr.shape[0]) - 1
        self.num_edges = int(self.indices.shape[0])

    def set_node_attribute(self, name: str, tensor):
        self.node_attrs[name] = torch.as_tensor(tensor, device=self.device)

    def set_edge_attribute(self, name: str, tensor):
        self.edge_attrs[name] = torch.as_tensor(tensor, device=self.device)

    # -- one-hop samplers --------------------------------------------------------

    def unweighted_sample_without_replacement_one_hop(
            self, seeds, fanout: int, *, u=None,
            generator: Optional[torch.Generator] = None) -> SampleOutput:
        return uniform_sample(self.indptr, self.indices, seeds, fanout, u=u,
                              generator=generator, device=self.device)

    def _max_degree(self) -> int:
        return int((self.indptr[1:] - self.indptr[:-1]).max()) if self.num_nodes else 1

    def weighted_sample_without_replacement_one_hop(
            self, seeds, fanout: int, weight_name: str = "weight", *, hash_key=None,
            generator: Optional[torch.Generator] = None,
            max_degree: Optional[int] = None) -> SampleOutput:
        """Weighted one-hop sample by the edge attribute ``weight_name``;
        ``max_degree`` defaults to the graph's largest degree."""
        return weighted_sample(self.indptr, self.indices, self.edge_attrs[weight_name], seeds,
                               fanout, max_degree=max_degree or self._max_degree(),
                               hash_key=hash_key, generator=generator, device=self.device)

    # -- multilayer ---------------------------------------------------------------

    def multilayer_sample_without_replacement(
            self, seeds, fanouts: Sequence[int], weight_name: Optional[str] = None, *,
            u=None, hash_keys=None, generator: Optional[torch.Generator] = None,
            dedup: bool = True) -> MultihopBatch:
        weights = self.edge_attrs.get(weight_name) if weight_name else None
        sampler = NeighborSampler(self.indptr, self.indices, fanouts, weights=weights,
                                  dedup=dedup, device=self.device)
        return sampler.sample(seeds, u=u, hash_keys=hash_keys, generator=generator)
