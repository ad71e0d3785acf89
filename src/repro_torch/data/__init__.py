from .pipeline import (  # noqa: F401
    LMSyntheticDataset, RecsysSyntheticDataset, make_blobs, make_uniform,
    ShardedLoader,
)
