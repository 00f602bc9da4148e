"""Data iterators of the port."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter,
                 SyntheticDataIter)
from .stager import DeviceStager, staging_enabled

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter",
           "SyntheticDataIter", "DeviceStager", "staging_enabled"]
