"""Lakehouse substrate: object store, columnar file format, table IO paths."""

from repro_torch.lakehouse.objectstore import ObjectStore  # noqa: F401
from repro_torch.lakehouse.vparquet import (  # noqa: F401
    VParquetReader,
    VParquetWriter,
    read_vector_column,
    write_vector_file,
)
from repro_torch.lakehouse.table import LakehouseTable  # noqa: F401
