"""Disk-backed datasets (counterpart of ``gpflow_slim_tpu.io``)."""

from .dataset import BinaryDataset, write_gfsb

__all__ = ["BinaryDataset", "write_gfsb"]
