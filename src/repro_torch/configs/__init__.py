"""Config registry of the port: the archs it serves and their shapes."""
from .registry import (  # noqa: F401
    ArchSpec, RECSYS_SHAPES, get_arch, list_archs, register,
)
