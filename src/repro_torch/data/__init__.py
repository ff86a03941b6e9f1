"""Synthetic graph generators (a numpy copy of ``repro.data.graphs``)."""
from .graphs import (dag_graph, gnp_graph, graph_to_adj, graph_to_weighted,
                     grid_graph, powerlaw_graph, table6_scaled, tree_graph)

__all__ = ["tree_graph", "grid_graph", "gnp_graph", "dag_graph",
           "powerlaw_graph", "graph_to_adj", "graph_to_weighted",
           "table6_scaled"]
