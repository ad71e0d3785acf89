"""Config registry of the port: the archs it trains and serves and their
shapes, and the SNN index and serving defaults (`snn_default`)."""
from .registry import (  # noqa: F401
    ArchSpec, RECSYS_SHAPES, get_arch, list_archs, register,
)
from .snn_default import DEFAULT as SNN_DEFAULT, SNNConfig  # noqa: F401
