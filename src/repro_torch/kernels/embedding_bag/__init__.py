from .ops import LAUNCHES, embedding_bag, embedding_bag_cuda, embedding_bag_torch
from .ref import embedding_bag_np

__all__ = ["LAUNCHES", "embedding_bag", "embedding_bag_cuda",
           "embedding_bag_np", "embedding_bag_torch"]
