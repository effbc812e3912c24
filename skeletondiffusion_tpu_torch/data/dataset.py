"""Dataset core: clip annotations → segment index → raw metric-space
segments (host-side numpy).

A copy of ``skeletondiffusion_tpu/data/dataset.py`` (`:28-402`; reference
`src/data/loaders/base/{base_dataset,motion_dataset}.py`): the port imports
nothing of the JAX package.  ``__getitem__`` returns RAW metric-space
segments; the input-space transform (and the noisy observation) runs
batched on the device (``skeletondiffusion_tpu_torch.data.batch``), so the
host only slices numpy views.
"""
from __future__ import annotations

import ast
import json
import os
from typing import List, Optional, Tuple

import numpy as np

# statistics file names (reference `base_dataset.py:8-11`)
MEAN_NAME = "mean_landmarks.npy"
VAR_NAME = "var_landmarks.npy"
MIN_NAME = "min_landmarks.npy"
MAX_NAME = "max_landmarks.npy"
NORMALIZATION_TYPES = ("standardize", "normalize")


class BaseDataset:
    """Segment bookkeeping over a list of clips; reference
    `base_dataset.py:15-218`."""

    def __init__(
        self,
        precomputed_folder: str,
        obs_length: int,
        pred_length: int,
        augmentation: int = 0,
        stride: int = 1,
        dtype: str = "float32",
        if_consider_hip: bool = False,
        silent: bool = False,
        rng_seed: int = 0,
        normalize_data: bool = False,
        normalize_type: str = "standardize",
        **kwargs,
    ):
        self.silent = silent
        self.obs_length = obs_length
        self.pred_length = pred_length
        self.seg_length = obs_length + pred_length
        self.annotations: Optional[List[np.ndarray]] = None
        self.segments: List[Tuple[int, int, int]] = []
        self.clip_idx_to_metadata = None
        self.segment_idx_to_metadata = None
        self.augmentation = augmentation
        self.stride = stride
        assert self.augmentation >= 0
        self.precomputed_folder = precomputed_folder
        assert dtype.lower() in ("float64", "float32")
        self.dtype = np.float64 if dtype.lower() == "float64" else np.float32
        self.drop_root = not if_consider_hip
        self.if_consider_hip = if_consider_hip
        self.mm_indces = None
        self._rng = np.random.default_rng(rng_seed)
        self.normalize_data = normalize_data
        assert normalize_type in NORMALIZATION_TYPES, normalize_type
        self.normalize_type = normalize_type
        self._prepare_data()
        if self.normalize_data:
            # the reference declares this path but blocks it with an assert
            # (`base_dataset.py:56`); here it actually works
            self._load_or_generate_statistics()

    def state_dict(self):
        """Checkpointable augmentation-jitter RNG (bit-faithful resume;
        reference `src/utils/reproducibility.py:47-79`)."""
        return {"rng": self._rng.bit_generator.state}

    def load_state_dict(self, state):
        self._rng.bit_generator.state = state["rng"]

    def _prepare_data(self):
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.segments) // self.stride

    def __getitem__(self, sample_idx: int):
        """(obs, pred, extra); augmentation jitters the segment index
        (reference `base_dataset.py:109-133`)."""
        segment_idx = int(self.stride * sample_idx + self.augmentation)
        if self.augmentation != 0:
            offset = int(self._rng.integers(-self.augmentation, self.augmentation + 1))
            segment_idx = max(0, min(segment_idx + offset, len(self.segments) - 1))
        i, init, end = self.segments[segment_idx]
        obs, pred = self._get_segment(i, init, end)
        if self.normalize_data:
            obs, pred = self.normalize(obs), self.normalize(pred)
        return obs, pred, {
            "sample_idx": sample_idx,
            "clip_idx": i,
            "init": init,
            "end": end,
            "metadata": self.segment_idx_to_metadata[segment_idx],
            "segment_idx": segment_idx,
        }

    def find_segment(self, clip_idx: int, init: int, end: Optional[int] = None):
        """Segment index from (clip, init[, end]); reference
        `base_dataset.py:150-155`."""
        for i, (i_, init_, end_) in enumerate(self.segments):
            if i_ == clip_idx and init_ == init and (end is None or end_ == end):
                return i
        return None

    def find_sample(self, clip_idx: int, init: int, end: Optional[int] = None) -> int:
        """Reference `base_dataset.py:157-161`."""
        assert self.augmentation == 0, "Cannot find sample if augmentation is not 0"
        return int(self.find_segment(clip_idx, init, end) / self.stride)

    def unique_sample_string(self, extra) -> str:
        """Reference `base_dataset.py:135-141`."""
        m = extra["metadata"]
        return (
            f"{m[0]}-{m[1]}_clip{extra['clip_idx']}_{extra['init']}:{extra['end']}"
            f"-segment{extra['segment_idx']}"
        )

    def _get_segment(self, i: int, init: int, end: int):
        assert init >= 0
        data = self.annotations[i][init : end + 1]
        obs, pred = data[: self.obs_length], data[self.obs_length :]
        assert len(obs) == self.obs_length and len(pred) == self.pred_length, (
            len(obs), len(pred), (i, init, end),
        )
        return obs, pred

    def _get_mmgt_for_segment(self, segment_idx: int) -> np.ndarray:
        """Stack the future segments of all mm-GT neighbors; reference
        `base_dataset.py:179-186`."""
        mm_gt_idces = self.mm_indces[segment_idx]
        return np.stack(
            [self._get_segment(*self.segments[idx])[1] for idx in mm_gt_idces], axis=0
        )

    def future_of_segment(self, segment_idx: int) -> np.ndarray:
        """The future window of ONE segment, normalized like mm-GT rows.

        Used by ``collate(dedup_mm=True, mm_fetch=...)`` to materialize each
        UNIQUE mm-GT row exactly once: the dense per-item stack above does
        O(sum over items of |neighbors|) window copies, nearly all of which
        the cross-batch dedup then discards — on real data that stacking
        dominated host collate time (profiled ~1.8 s of a ~2.1 s producer
        step at batch 256)."""
        fut = self._get_segment(*self.segments[segment_idx])[1]
        # normalize is elementwise, so per-row == normalizing the full stack
        return self.normalize(fut) if self.normalize_data else fut

    def _generate_segments(self):
        """Dense sliding-window segments; reference
        `base_dataset.py:189-198`."""
        assert self.clip_idx_to_metadata is not None
        both = [
            ((idx, init, init + self.seg_length - 1), self.clip_idx_to_metadata[idx])
            for idx in range(len(self.annotations))
            for init in range(0, self.annotations[idx].shape[0] - self.seg_length)
        ]
        segments, seg2meta = list(zip(*both))
        return list(segments), list(seg2meta)

    def load_mmgt_file(self, path: str):
        """Reference `base_dataset.py:143-148`."""
        with open(path, "r") as fh:
            self.mm_indces = ast.literal_eval(json.load(fh))
        self.mm_indces = {k: sorted(self.mm_indces[k]) for k in sorted(self.mm_indces)}

    def validate_segments_extended_predlength(self):
        """Drop segments that overrun their clip after horizon extension;
        reference `base_dataset.py:200-208`."""
        keep = [i for i, (idx, init, end) in enumerate(self.segments)
                if end < self.annotations[idx].shape[0]]
        remap = {old: new for new, old in enumerate(keep)}
        if self.mm_indces is not None:
            self.mm_indces = {
                new: [remap[o] for o in self.mm_indces[old] if o in remap]
                for new, old in enumerate(keep)
            }
        self.segments = [self.segments[i] for i in keep]
        self.segment_idx_to_metadata = [self.segment_idx_to_metadata[i] for i in keep]

    def validate_segments_extended_obslength(self, extended_obslength: int):
        """Shift segments back by ``extended_obslength`` frames and drop any
        that would start before their clip; reference
        `base_dataset.py:210-218`."""
        keep = [i for i, (idx, init, end) in enumerate(self.segments)
                if init - extended_obslength >= 0]
        remap = {old: new for new, old in enumerate(keep)}
        if self.mm_indces is not None:
            self.mm_indces = {
                new: [remap[o] for o in self.mm_indces[old] if o in remap]
                for new, old in enumerate(keep)
            }
        self.segments = [
            (idx, init - extended_obslength, end)
            for i, (idx, init, end) in enumerate(self.segments) if i in remap
        ]
        self.segment_idx_to_metadata = [self.segment_idx_to_metadata[i] for i in keep]

    # ---- per-landmark statistics + normalization ---------------------------
    def _load_or_generate_statistics(self):
        """Per-landmark mean/var/min/max over every annotation frame, cached
        under ``<precomputed>/statistics/``; reference
        `base_dataset.py:221-243` (``_generate_statistics_full``)."""
        stats_dir = os.path.join(self.precomputed_folder, "statistics")
        paths = {name: os.path.join(stats_dir, fname) for name, fname in
                 (("mean", MEAN_NAME), ("var", VAR_NAME),
                  ("min", MIN_NAME), ("max", MAX_NAME))}
        if not all(os.path.exists(p) for p in paths.values()):
            os.makedirs(stats_dir, exist_ok=True)
            ps = np.concatenate(self.annotations, axis=0)  # [frames, J, 3]
            np.save(paths["mean"], ps.mean(axis=0))
            np.save(paths["var"], ps.var(axis=0))
            np.save(paths["min"], ps.min(axis=0))
            np.save(paths["max"], ps.max(axis=0))
        elif not self.silent:
            print("Skipping statistics generation...")
        self.mean = np.load(paths["mean"], allow_pickle=True).astype(self.dtype)
        self.var = np.load(paths["var"], allow_pickle=True).astype(self.dtype)
        self.min = np.load(paths["min"], allow_pickle=True).astype(self.dtype)
        self.max = np.load(paths["max"], allow_pickle=True).astype(self.dtype)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        """Reference `base_dataset.py:246-252`."""
        if self.normalize_type == "standardize":
            return (x - self.mean) / np.sqrt(self.var)
        return 2 * (x - self.min) / (self.max - self.min) - 1

    def denormalize(self, x: np.ndarray, idces=None) -> np.ndarray:
        """Inverse transform; ``idces`` selects a landmark subset (e.g. when
        the root was re-inserted downstream); reference
        `base_dataset.py:254-272`."""
        if idces is None:
            idces = list(range(x.shape[-2]))
        if self.normalize_type == "standardize":
            return np.sqrt(self.var[idces]) * x + self.mean[idces]
        return (x + 1) * (self.max[idces] - self.min[idces]) / 2 + self.min[idces]

    def _load_mean_motion(self, task: str = "hmp"):
        """CMD reference statistics; reference `base_dataset.py:82-107`."""
        motion_avg_path = os.path.join(self.precomputed_folder, "mean_motion_test.txt")
        clas2meanfreq = {}
        if not os.path.isfile(motion_avg_path):
            from .mmgt import compute_mean_motions

            class_average, motions, freqs = compute_mean_motions(self)
            with open(motion_avg_path, "w") as fh:
                fh.write("\n".join(
                    f"{c},{m},{f}" for c, m, f in zip(class_average.keys(), motions, freqs)
                ))
        with open(motion_avg_path) as f:
            for line in f:
                c, meanmot, freq = line.strip().split(",")
                clas2meanfreq[c] = (float(meanmot), float(freq))
        self.mean_motion_per_class = [clas2meanfreq[c][0] for c in self.idx_to_class]


class MotionDataset(BaseDataset):
    """Skeleton-aware dataset; reference `motion_dataset.py:31-193`.

    Augmentation probabilities (``da_mirroring``/``da_rotations``) and the
    noisy-obs option are STORED here; the noise is applied on the device by
    ``preprocess_batch`` (the augmentations wait for the training slice) —
    the returned samples are raw metric space.
    """

    def __init__(
        self,
        split: str,
        precomputed_folder: str,
        skeleton,
        obs_length: int,
        pred_length: int,
        segments_path: Optional[str] = None,
        stride: int = 1,
        augmentation: int = 0,
        da_mirroring: float = 0.0,
        da_rotations: float = 0.0,
        dtype: str = "float32",
        if_consider_hip: bool = False,
        if_load_mmgt: bool = False,
        extended_pred_length: Optional[int] = None,
        extended_obs_length: Optional[int] = None,
        if_noisy_obs: bool = False,
        noise_level: float = 0.30,
        noise_std: float = 0.03,
        silent: bool = False,
        **kwargs,
    ):
        self.segments_path = segments_path
        self.split = split
        self.skeleton = skeleton
        self.if_load_mmgt = if_load_mmgt
        self.if_noisy_obs = if_noisy_obs
        self.noise_level = noise_level
        self.noise_std = noise_std
        assert split in ("valid", "train", "test")
        if split == "test":
            assert segments_path is not None and split in segments_path
        assert 0.0 <= da_mirroring <= 1.0 and 0.0 <= da_rotations <= 1.0
        self.da_mirroring = da_mirroring
        self.da_rotations = da_rotations
        if extended_pred_length is not None:
            assert extended_pred_length > pred_length
            assert split in ("test", "valid")
            pred_length = extended_pred_length
        # segments are built with the BASE obs_length; the extension shifts
        # their starts back afterwards (reference `base_dataset.py:210-218`)
        if extended_obs_length is not None:
            assert extended_obs_length > obs_length, (
                f"extended_obs_length ({extended_obs_length}) must exceed "
                f"obs_length ({obs_length})"
            )
            self._extend_obs_by = extended_obs_length - obs_length
        else:
            self._extend_obs_by = 0
        self.in_eval = split in ("test", "valid")

        super().__init__(
            precomputed_folder, obs_length, pred_length, augmentation=augmentation,
            stride=stride, dtype=dtype, if_consider_hip=if_consider_hip, silent=silent,
            **kwargs,
        )
        self.load_mmgt()
        if split == "test" and kwargs.get("if_compute_cmd"):
            self._load_mean_motion()
        if extended_pred_length is not None:
            self.validate_segments_extended_predlength()
        if self._extend_obs_by:
            self.validate_segments_extended_obslength(self._extend_obs_by)
            self.obs_length += self._extend_obs_by
        if not silent:
            print(f"Constructed {type(self).__name__} split={split}: {len(self.segments)} segments")

    # ---- mm-GT ------------------------------------------------------------
    def load_mmgt(self, path: Optional[str] = None):
        """Reference `motion_dataset.py:91-103`."""
        if not self.if_load_mmgt:
            return
        suffix = "_hmp" if self.if_consider_hip else ""
        if path is None:
            path = os.path.join(self.precomputed_folder, f"mmgt_{self.split}{suffix}.txt")
        else:
            path = path.replace(".txt", f"{suffix}.txt")
        assert os.path.exists(path), f"Multimodal GT file missing: {path}"
        self.load_mmgt_file(path)
        assert len(self.mm_indces) == len(self.segments)

    @property
    def max_mmgt_count(self) -> int:
        if self.mm_indces is None:
            return 0
        return max((len(v) for v in self.mm_indces.values()), default=0)

    def extract_action_label(self, extra) -> str:
        return extra["metadata"][self.metadata_class_idx]

    # NOTE: the augmentation/noise attributes stored above (da_mirroring,
    # da_rotations, if_noisy_obs, noise_level, noise_std) and the
    # eval()/train() toggles mirror the reference dataset's API
    # (`base_dataset.py`), where augmentation runs inside __getitem__.  Here
    # the noise runs on the device in preprocess_batch (data/batch.py, from
    # compute_metrics' arguments) — these fields record the configuration on
    # the dataset for inspection; setting them does not change the
    # preprocessing.
    def eval(self):
        self.in_eval = True

    def train(self):
        self.in_eval = False

    # when True, __getitem__ ships only the neighbor ids and the dedup
    # collate pulls each unique future once via future_of_segment — set by
    # consumers that own the dataset AND read it through a dedup_mm loader
    # (eval_pipeline); the dense per-item mm_gt stack is skipped entirely
    mm_lazy: bool = False

    def __getitem__(self, idx: int):
        obs, pred, extra = super().__getitem__(idx)
        if self.if_load_mmgt and self.mm_indces is not None:
            # neighbor SEGMENT ids, row-aligned with mm_gt — lets the collate
            # dedup shared neighbors across the batch (see collate(dedup_mm=))
            extra["mm_gt_idces"] = self.mm_indces[extra["segment_idx"]]
            if not self.mm_lazy:
                mm_gt = self._get_mmgt_for_segment(extra["segment_idx"])
                if self.normalize_data:
                    mm_gt = self.normalize(mm_gt)  # reference `motion_dataset.py:122-123`
                extra["mm_gt"] = mm_gt
        return obs, pred, extra

    def iter_thourgh_seqs(self):
        for seq in self.annotations:
            yield seq
