"""Synthetic data: graph generators and token pipelines (numpy copies of
``repro.data.graphs`` and ``repro.data.tokens``)."""
from .graphs import (dag_graph, gnp_graph, graph_to_adj, graph_to_weighted,
                     grid_graph, powerlaw_graph, table6_scaled, tree_graph)
from .tokens import TokenPipeline, masked_frame_batch, vlm_batch

__all__ = ["tree_graph", "grid_graph", "gnp_graph", "dag_graph",
           "powerlaw_graph", "graph_to_adj", "graph_to_weighted",
           "table6_scaled", "TokenPipeline", "masked_frame_batch",
           "vlm_batch"]
