"""Debug and profiling switches of the entry points.

Port of ``skeletondiffusion_tpu/utils/debug.py`` (`:21-41`; the reference's
``torch.autograd.set_detect_anomaly`` flag, `train_diffusion.py:33-37`):

* ``configure_debug`` sets autograd's anomaly mode from the training
  configs' ``if_debug_nans`` (NaN checks in the backward, which JAX's
  ``jax_debug_nans`` does) and ``if_enable_checks`` (the mode's backward
  traces, JAX's ``jax_enable_checks``), and returns the training loops' check
  of each loss: with ``if_debug_nans`` a loss that is not finite raises.
* ``profile_trace`` records a ``torch.profiler`` trace (the device's kernels
  too, on the card) of the enclosed work into a directory.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch


def configure_debug(if_debug_nans: bool = False,
                    if_enable_checks: bool = False) -> Callable[[torch.Tensor], None]:
    torch.autograd.set_detect_anomaly(bool(if_debug_nans or if_enable_checks),
                                      check_nan=bool(if_debug_nans))

    def check_loss(loss: torch.Tensor) -> None:
        if if_debug_nans and not bool(torch.isfinite(loss).all()):
            raise FloatingPointError(f"the loss is not finite: {loss}")

    return check_loss


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``with profile_trace(dir):`` writes a trace of the enclosed work
    (``*.pt.trace.json``, for Perfetto or TensorBoard) into ``dir``; a no-op
    when ``log_dir`` is empty.  The trace stops when the block ends, also
    when it raises."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
