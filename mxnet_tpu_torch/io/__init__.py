"""Data iterators of the port."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter,
                 SyntheticDataIter)

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter",
           "SyntheticDataIter"]
