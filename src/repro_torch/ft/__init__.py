from .checkpoint import CheckpointManager  # noqa: F401
from .watchdog import StragglerWatchdog  # noqa: F401
from .elastic import ElasticRunner, FailureInjector  # noqa: F401
