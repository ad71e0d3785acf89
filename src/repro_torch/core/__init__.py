"""Core SNN library on PyTorch: index, exact CSR query, engine, join,
neighbour graph and DBSCAN."""
from .snn import (  # noqa: F401
    CSRNeighbors,
    SNNIndex,
    build_index,
    index_from_arrays,
    query_radius_csr,
)
from .engine import (Segment, SegmentPack, make_segment,  # noqa: F401
                     pack_from_index, segment_from_index, segments_from_index)
from .join import join, query_counts  # noqa: F401
from .graph import build_neighbor_graph, min_label_components  # noqa: F401
from .dbscan import (dbscan, labels_from_graph,  # noqa: F401
                     neighbor_graph, normalized_mutual_information)
from . import metrics  # noqa: F401
