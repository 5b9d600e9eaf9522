"""Graph embeddings tier: graphs, random walks, DeepWalk (port of
``deeplearning4j_tpu/graph``).

Reference module: ``deeplearning4j-graph/`` (``graph/Graph.java``,
``iterator/RandomWalkIterator.java``, ``models/deepwalk/DeepWalk.java``,
``models/embeddings/GraphVectorsImpl.java``).  Graphs, CSR, alias tables
and host walks are numpy, bitwise the JAX package's for a seed; DeepWalk
trains on the model's device (the card unless the caller asks for the
CPU) through the word2vec tier's hierarchical-softmax update, with its
walks generated there too.
"""

from .api import (Edge, NoEdgeHandling, NoEdgesException, Vertex,
                  VertexSequence)
from .deepwalk import (DeepWalk, GraphHuffman, GraphVectors,
                       load_txt_vectors, write_graph_vectors)
from .graph import Graph, GraphLoader
from .iterators import (RandomWalkGraphIteratorProvider, RandomWalkIterator,
                        WeightedRandomWalkIterator, generate_walks)

__all__ = [
    "Edge", "NoEdgeHandling", "NoEdgesException", "Vertex",
    "VertexSequence", "Graph", "GraphLoader", "RandomWalkIterator",
    "WeightedRandomWalkIterator", "RandomWalkGraphIteratorProvider",
    "generate_walks", "DeepWalk", "GraphHuffman", "GraphVectors",
    "write_graph_vectors", "load_txt_vectors",
]
