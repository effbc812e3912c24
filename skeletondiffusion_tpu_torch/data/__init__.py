"""Data pipeline: the AMASS dataset and loader, batching with the on-device
preprocess, the offline statistics (mm-GT, CMD mean motions) and the
synthetic AMASS generator."""
from .batch import DataLoader, collate, prefetch_iterator, preprocess_batch
from .dataset import BaseDataset, MotionDataset
from .loaders import AMASSDataset
from .mmgt import (
    compute_mean_motions,
    compute_multimodal_gt_for_dataset,
    finalize_dataset,
    get_multimodal_gt,
    save_mmgt,
)
from .synthetic import make_synthetic_amass, make_synthetic_amass_motion

__all__ = [
    "AMASSDataset", "BaseDataset", "DataLoader", "MotionDataset", "collate",
    "compute_mean_motions", "compute_multimodal_gt_for_dataset", "finalize_dataset",
    "get_multimodal_gt", "make_synthetic_amass", "make_synthetic_amass_motion",
    "prefetch_iterator", "preprocess_batch", "save_mmgt",
]
