"""Data pipeline: the AMASS, Human3.6M, FreeMan and zero-shot 3DPW datasets
and the loader, batching with the on-device preprocess, the offline
statistics (mm-GT, CMD mean motions) and the synthetic AMASS generator."""
from .batch import DataLoader, collate, prefetch_iterator, preprocess_batch
from .dataset import BaseDataset, MotionDataset
from .loaders import (
    DATASET_CLASSES,
    AMASSDataset,
    D3PWZeroShotDataset,
    FreeManDataset,
    H36MDataset,
    ZeroShotAMASSDataset,
)
from .mmgt import (
    compute_mean_motions,
    compute_multimodal_gt_for_dataset,
    finalize_dataset,
    get_multimodal_gt,
    save_mmgt,
)
from .synthetic import make_synthetic_amass, make_synthetic_amass_motion

__all__ = [
    "AMASSDataset", "BaseDataset", "D3PWZeroShotDataset", "DATASET_CLASSES", "DataLoader",
    "FreeManDataset", "H36MDataset", "MotionDataset", "ZeroShotAMASSDataset", "collate",
    "compute_mean_motions", "compute_multimodal_gt_for_dataset", "finalize_dataset",
    "get_multimodal_gt", "make_synthetic_amass", "make_synthetic_amass_motion",
    "prefetch_iterator", "preprocess_batch", "save_mmgt",
]
