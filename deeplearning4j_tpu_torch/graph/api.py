"""Graph API: vertices, edges, walk sequences, no-edge handling (the
port's own copy of ``deeplearning4j_tpu/graph/api.py``).

Re-designed from the reference graph API (reference
``deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/api/``:
``Vertex.java``, ``Edge.java``, ``NoEdgeHandling.java``,
``IVertexSequence.java``).  The same surface, with vectorised numpy walk
machinery underneath feeding batched torch updates, not per-edge object
iteration.  Plain Python; nothing here touches a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Iterator, Optional, Sequence


class NoEdgeHandling(Enum):
    """What a walk does at a vertex with no (outgoing) edges (reference
    ``api/NoEdgeHandling.java``)."""
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class NoEdgesException(RuntimeError):
    """Raised when a walk hits a vertex with no outgoing edges under
    ``EXCEPTION_ON_DISCONNECTED`` (reference ``exception/NoEdgesException``)."""


@dataclass(frozen=True)
class Vertex:
    """A graph vertex: integer id plus an arbitrary value (reference
    ``api/Vertex.java``)."""
    idx: int
    value: Any = None

    def vertex_id(self) -> int:
        return self.idx


@dataclass(frozen=True)
class Edge:
    """An edge, optionally directed, with an arbitrary value — a number for
    weighted graphs (reference ``api/Edge.java``)."""
    frm: int
    to: int
    value: Any = None
    directed: bool = False


class VertexSequence:
    """A sequence of vertices from a walk (reference
    ``graph/VertexSequence.java`` implementing ``IVertexSequence``)."""

    def __init__(self, graph: "Graph", indices: Sequence[int]):
        self._graph = graph
        self._indices = list(indices)

    @property
    def indices(self) -> Sequence[int]:
        return list(self._indices)

    def sequence_length(self) -> int:
        return len(self._indices)

    def __len__(self) -> int:
        return len(self._indices)

    def __iter__(self) -> Iterator[Vertex]:
        for i in self._indices:
            yield self._graph.get_vertex(i)
