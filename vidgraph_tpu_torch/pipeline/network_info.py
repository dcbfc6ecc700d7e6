"""Graph-context string for prompts (reference:
src/components/network_info.py:6-31)."""
from __future__ import annotations


class NetworkInfoProvider:
    def __init__(self, graph_store) -> None:
        self.store = graph_store

    def get_info(self) -> str:
        nodes = self.store.get_node_count()
        rels = self.store.get_relationship_count()
        return (f"Current graph (uuid={self.store.graph_uuid}): "
                f"{nodes} nodes, {rels} relationships.")
