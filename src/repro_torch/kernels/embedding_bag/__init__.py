from .ops import (
    LAUNCHES,
    MAX_FIELDS,
    embedding_bag,
    embedding_bag_cuda,
    embedding_bag_fields,
    embedding_bag_fields_cuda,
    embedding_bag_fields_torch,
    embedding_bag_torch,
)
from .ref import embedding_bag_np

__all__ = ["LAUNCHES", "MAX_FIELDS", "embedding_bag", "embedding_bag_cuda",
           "embedding_bag_fields", "embedding_bag_fields_cuda",
           "embedding_bag_fields_torch", "embedding_bag_np", "embedding_bag_torch"]
