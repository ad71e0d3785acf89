"""Core SNN library on PyTorch: the index, exact radius, count and kNN
queries, the engine, joins, the streaming index, the neighbour graph (one
device or a mesh's shards), DBSCAN and the baselines.  The package-level
names are ``repro.core``'s: ``query_counts`` is the host Algorithm 2 count
and ``query_counts_device`` the engine's."""
from .snn import (  # noqa: F401
    CSRNeighbors,
    SNNIndex,
    build_index,
    index_from_arrays,
    query_radius,
    query_radius_batch,
    query_radius_csr,
    query_counts,
    query_radius_fixed,
)
from .engine import (Segment, SegmentPack, make_segment,  # noqa: F401
                     pack_from_index, segment_from_index, segments_from_index)
from .join import (join, join_counts, reverse_neighbors,  # noqa: F401
                   degree_histogram)
from .join import query_counts as query_counts_device  # noqa: F401
from .knn import query_knn  # noqa: F401
from .graph import (build_neighbor_graph, build_neighbor_graph_sharded,  # noqa: F401
                    min_label_components)
from .streaming import StreamingSNNIndex, merge_sorted_indexes  # noqa: F401
from .baselines import BruteForce1, BruteForce2, KDTree, GridIndex  # noqa: F401
from .dbscan import (dbscan, labels_from_graph, neighbor_graph,  # noqa: F401
                     normalized_mutual_information)
from . import metrics  # noqa: F401
