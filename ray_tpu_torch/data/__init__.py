"""ray_tpu_torch.data: streaming, block-based distributed datasets.

Reference: ``python/ray/data/`` (SURVEY.md §2.3, §3.6): lazy logical
plans, operator fusion, a backpressured streaming executor over object-
store blocks, and train-worker stream splits. Blocks are numpy column
dicts; ``DataIterator.to_device_batches`` copies batches to the card
from pinned memory with one batch of lookahead. File datasources and
writers, and the pandas and Arrow formats, are not ported yet and raise
``NotImplementedError``.
"""

from .block import BlockAccessor
from .dataset import (
    ActorPoolStrategy,
    Dataset,
    GroupedData,
    MaterializedDataset,
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A004
    read_avro,
    read_binary_files,
    read_images,
    read_tfrecords,
    read_webdataset,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)
from .iterator import DataIterator

__all__ = [
    "ActorPoolStrategy",
    "BlockAccessor",
    "DataIterator",
    "Dataset",
    "GroupedData",
    "MaterializedDataset",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_avro",
    "read_binary_files",
    "read_images",
    "read_tfrecords",
    "read_webdataset",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
]
