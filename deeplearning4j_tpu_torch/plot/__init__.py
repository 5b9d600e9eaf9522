"""Plot/visualisation tier: t-SNE (port of ``deeplearning4j_tpu/plot/``).

Reference module: ``deeplearning4j-core/.../plot/`` (``BarnesHutTsne.java``
and its quadtree/sptree support structures).
"""

from .tsne import Tsne

__all__ = ["Tsne"]
