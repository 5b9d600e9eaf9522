"""Clustering tier: k-means, vantage-point tree, k-d tree (port of
``deeplearning4j_tpu/clustering/``).

Reference module: ``deeplearning4j-core/.../clustering/`` (kmeans/
KMeansClustering.java, vptree/VPTree.java, kdtree/KDTree.java; the
quadtree/sptree pair exists only to serve Barnes-Hut t-SNE, replaced by
the exact and tiled t-SNE gradients of ``plot/tsne.py``).  The trees are
host numpy structures; the Lloyd loop runs on the device.
"""

from .kdtree import KDNode, KDTree
from .kmeans import Cluster, ClusterSet, KMeansClustering
from .vptree import VPTree

__all__ = ["KMeansClustering", "Cluster", "ClusterSet", "VPTree",
           "KDTree", "KDNode"]
