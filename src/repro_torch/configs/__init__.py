"""Config registry of the port: the archs it serves and trains and their
shapes, and the SNN index and serving defaults (`snn_default`)."""
from .registry import (  # noqa: F401
    ArchSpec, FAMILY_SHAPES, GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, all_cells,
    get_arch, list_archs, register,
)
from .snn_default import DEFAULT as SNN_DEFAULT, SNNConfig  # noqa: F401
