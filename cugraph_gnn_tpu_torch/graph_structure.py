"""GraphStructure: a CSR graph with attribute tensors and its samplers.

Counterpart of ``cugraph_gnn_tpu/graph_structure.py`` (the WholeGraph-style
container): ``set_csr_graph``, node and edge attributes, the unweighted
one-hop sampler and ``multilayer_sample_without_replacement`` over the
port's ``NeighborSampler``, on one device.  Every sampler takes optional
uniforms ``u`` (as ``ops/sample.py`` and ``NeighborSampler.sample`` do) or
draws from ``generator``.

Weighted sampling (the weighted one-hop sampler, ``weight_name=`` in the
multilayer sampler) comes with ROADMAP Queue 1 item 4 (``weighted_sample``):
asking for it raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from cugraph_gnn_tpu_torch._device import resolve_device
from cugraph_gnn_tpu_torch.ops.sample import SampleOutput, uniform_sample
from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler
from cugraph_gnn_tpu_torch.sampler.output import MultihopBatch


def _weighted_not_ported():
    return NotImplementedError("weighted sampling is not ported yet (ROADMAP Queue 1 "
                               "item 4, weighted_sample)")


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

    def weighted_sample_without_replacement_one_hop(self, seeds, fanout: int,
                                                    weight_name: str = "weight", **kwargs):
        raise _weighted_not_ported()

    # -- multilayer ---------------------------------------------------------------

    def multilayer_sample_without_replacement(
            self, seeds, fanouts: Sequence[int], weight_name: Optional[str] = None, *,
            u=None, generator: Optional[torch.Generator] = None,
            dedup: bool = True) -> MultihopBatch:
        if weight_name is not None:
            raise _weighted_not_ported()
        sampler = NeighborSampler(self.indptr, self.indices, fanouts, dedup=dedup,
                                  device=self.device)
        return sampler.sample(seeds, u=u, generator=generator)
