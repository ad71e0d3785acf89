"""Core SNN library on PyTorch: index, exact CSR query, engine, join."""
from .snn import (  # noqa: F401
    CSRNeighbors,
    SNNIndex,
    build_index,
    index_from_arrays,
    query_radius_csr,
)
from .engine import (Segment, SegmentPack, make_segment,  # noqa: F401
                     pack_from_index, segment_from_index)
from .join import query_counts  # noqa: F401
from . import metrics  # noqa: F401
