"""Graph export/import — format v1.0 file round-trip.

Parity with reference src/components/graph_exporter.py:36-244: export writes
``{graph_uuid, export_timestamp, nodes, relationships,
export_format_version: "1.0"}``; import MERGEs nodes and relationships,
optionally under a fresh UUID for collaboration.
"""
from __future__ import annotations

import json
import uuid as _uuid
from pathlib import Path
from typing import Any, Dict, Optional

from ..core.logger import get_logger
from .base import GraphStore

logger = get_logger("graph_exporter")


class GraphExporter:
    def __init__(self, store: GraphStore) -> None:
        self.store = store

    def export_graph(self, output_path: str) -> str:
        if not self.store.verify_connection():
            raise ConnectionError("Cannot connect to graph store")
        data = self.store.export_data()
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, ensure_ascii=False)
        logger.info("Exported %d nodes / %d relationships to %s",
                    len(data["nodes"]), len(data["relationships"]), out)
        return str(out)


class GraphImporter:
    def __init__(self, store_factory) -> None:
        """``store_factory(graph_uuid) -> GraphStore``"""
        self._factory = store_factory

    def import_graph(self, input_path: str,
                     new_uuid: Optional[str] = None,
                     use_new_uuid: bool = False) -> str:
        with open(input_path, encoding="utf-8") as f:
            data: Dict[str, Any] = json.load(f)
        version = data.get("export_format_version")
        if version != "1.0":
            logger.warning("Unexpected export format version: %s", version)
        graph_uuid = data.get("graph_uuid")
        if use_new_uuid or new_uuid:
            graph_uuid = new_uuid or str(_uuid.uuid4())
        if not graph_uuid:
            raise ValueError("export file has no graph_uuid")
        store = self._factory(graph_uuid)
        store.import_data(data)
        store.close()
        logger.info("Imported graph as %s (%d nodes, %d relationships)",
                    graph_uuid, len(data.get("nodes", [])),
                    len(data.get("relationships", [])))
        return graph_uuid
