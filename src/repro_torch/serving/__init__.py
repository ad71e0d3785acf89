from .registry import IndexRegistry  # noqa: F401
from .runtime import (Request, Response, ServiceClock,  # noqa: F401
                      TenantRuntime, collect_batch)
from .server import SNNServer  # noqa: F401
