"""Evaluation metrics: probabilistic sample-set metrics and limb realism in
torch, CMD/APDE/FID, host accumulators and the per-batch suite."""
from .accumulators import APDEAccumulator, CMDAccumulator, FIDAccumulator, MetricStorer
from .body_realism import (
    limb_jitter_normed_mean,
    limb_jitter_normed_rmse,
    limb_length_error,
    limb_length_jitter,
    limb_length_variance,
    limb_length_variation_difference_wrtGT,
    limb_stretching_normed_mean,
    limb_stretching_normed_rmse,
)
from .fid import ClassifierForFID, fid_from_activations, port_classifier
from .multimodal import (
    ade,
    apd,
    best_sample_index,
    choose_best_sample,
    cmd_from_curve,
    fde,
    lat_apd,
    mae,
    mmade,
    mmfde,
    motion_for_cmd,
    mpjpe,
    resolve_cmd,
)
from .ranking import get_closest_and_nfurthest_maxapd
from .suite import MetricSuite, draw_table, get_stats_funcs
from .tables import (
    FinalDisplacementErrorMeter,
    MeanPerJointPositionErrorTable,
    format_metric_time_table,
)

__all__ = [
    "APDEAccumulator", "CMDAccumulator", "ClassifierForFID", "FIDAccumulator",
    "FinalDisplacementErrorMeter", "MeanPerJointPositionErrorTable",
    "format_metric_time_table",
    "MetricStorer", "MetricSuite", "ade", "apd", "best_sample_index",
    "choose_best_sample",
    "cmd_from_curve", "draw_table", "fde", "fid_from_activations",
    "get_closest_and_nfurthest_maxapd", "get_stats_funcs", "lat_apd",
    "limb_jitter_normed_mean", "limb_jitter_normed_rmse", "limb_length_error",
    "limb_length_jitter", "limb_length_variance",
    "limb_length_variation_difference_wrtGT", "limb_stretching_normed_mean",
    "limb_stretching_normed_rmse", "mae", "mmade", "mmfde", "motion_for_cmd",
    "mpjpe", "port_classifier", "resolve_cmd",
]
