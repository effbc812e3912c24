"""Stage-1 trainer: the graph-recurrent AutoEncoder with its
prediction-horizon curriculum.

Port of ``skeletondiffusion_tpu/train/trainer_autoencoder.py`` (reference
`src/core/trainer.py:17-104`): AdamW with AMSGrad and decoupled weight decay,
the gradients clipped to a global norm of 1.0, and a cosine-annealed
curriculum that grows the decoded horizon ``ph`` from 1 to the full one
with a randomized lower bound.

Where the JAX trainer decodes the full horizon and masks the loss to the
first ``ph`` frames (one compiled program for every ``ph``), this one runs
what the reference runs: the future encoder up to frame ``ph − 1`` and a
``ph``-step decode, the differentiable step loop
(``AutoEncoder.decode_plain``; the rollout kernel has no backward), and
the loss on ``y[:, :ph]``.  The values and the gradients are the same (the
GRU is causal; `tests/test_train_objective_parity.py`).  Validation decodes
a GRU decoder on the rollout kernel.

Two details where torch's own optimizer already matches the reference's:
``torch.optim.AdamW(amsgrad=True)`` keeps the max of the raw second moment
and corrects its bias afterwards (the JAX package rebuilt that as
``scale_by_amsgrad_torch``), and ``clip_grad_norm_`` scales by
max_norm / (norm + 1e-6) where optax's ``clip_by_global_norm`` scales by
max_norm / norm (a relative 1e-6/norm apart, and only when clipping).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.autoencoder import AutoEncoder, autoencoder_loss
from .schedulers import CurriculumPH, make_lr_scheduler


class AutoEncoderTrainer:
    def __init__(
        self,
        model: AutoEncoder,
        lr: float,
        iter_per_epoch: int,
        prediction_horizon_train: int,
        prediction_horizon_eval: int,
        curriculum_it: int = 0,
        clip_grad_norm: Optional[float] = 1.0,
        use_lr_scheduler: bool = False,
        lr_scheduler_kwargs: Optional[dict] = None,
        weight_decay: float = 1e-2,  # torch AdamW default, implied by `trainer.py:33`
        prediction_horizon_train_min: int = 10,
        prediction_horizon_train_min_from_epoch: int = 200,
        random_prediction_horizon: bool = True,
        loss_pose_type: str = "l1",
        seed: int = 0,
        **config,
    ):
        self.model = model
        self.lr = lr
        self.ph_train = prediction_horizon_train
        self.ph_eval = prediction_horizon_eval
        self.loss_pose_type = loss_pose_type
        self.clip_grad_norm = clip_grad_norm
        self.curriculum = CurriculumPH(
            prediction_horizon_train=prediction_horizon_train,
            prediction_horizon_train_min=prediction_horizon_train_min,
            prediction_horizon_train_min_from_epoch=prediction_horizon_train_min_from_epoch,
            curriculum_it=curriculum_it,
            random_prediction_horizon=random_prediction_horizon,
            iter_per_epoch=iter_per_epoch,
            seed=seed,
        )
        self.lr_scheduler = (
            make_lr_scheduler(lr=lr, **(lr_scheduler_kwargs or {})) if use_lr_scheduler else None
        )
        self.optimizer = torch.optim.AdamW(model.parameters(), lr=lr, amsgrad=True,
                                           weight_decay=weight_decay)
        self.step = 0
        self.last_grad_norm: Optional[torch.Tensor] = None

    # ---- steps ---------------------------------------------------------------
    def current_lr(self) -> float:
        return self.lr if self.lr_scheduler is None else self.lr_scheduler._current

    def loss(self, x: torch.Tensor, y: torch.Tensor, ph: int) -> torch.Tensor:
        """The reference's curriculum loss (`trainer.py:79-96`): encode
        ``y[:, :ph]``, decode ``ph`` frames from that latent, L1 (or MSE) on
        ``y[:, :ph]``.  Differentiable."""
        z = self.model.encode(y, last_index=ph - 1)
        pred = self.model.decode_plain(x, z, ph)
        return autoencoder_loss(pred, y[:, :ph], loss_type=self.loss_pose_type)

    def optimizer_step(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward, clip, AdamW step at the scheduler's lr; returns the
        global gradient norm before clipping."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in self.model.parameters() if p.grad is not None]
        gnorm = torch.nn.utils.clip_grad_norm_(
            params, self.clip_grad_norm if self.clip_grad_norm else float("inf"))
        for group in self.optimizer.param_groups:
            group["lr"] = self.current_lr()
        self.optimizer.step()
        self.step += 1
        return gnorm

    def train_step(self, batch, epoch: int, iteration: int) -> Tuple[torch.Tensor, int]:
        """One step on ``batch`` = (x [B,To,N,3], y [B,Tp,N,3]) in input
        space: the curriculum's ``ph`` for (epoch, iteration), the loss, the
        update.  Returns (the loss, detached; ph); the gradient norm is kept
        in ``last_grad_norm``."""
        x, y = batch
        ph = self.curriculum(epoch, iteration)
        loss = self.loss(x, y, ph)
        self.last_grad_norm = self.optimizer_step(loss).detach()
        return loss.detach(), ph

    def epoch_started(self, epoch: int):
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(epoch)

    @torch.no_grad()
    def validation_step(self, batch):
        """Autoencode at the eval horizon (the rollout kernel for a GRU
        decoder, the plain step loop for an LSTM one) → (pred, y, x, z)."""
        x, y = batch
        pred, _, z = self.model.autoencode(y, x, ph=self.ph_eval)
        return pred, y, x, z

    # ---- checkpoint ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "curriculum": self.curriculum.state_dict(),
            "lr_scheduler": None if self.lr_scheduler is None else self.lr_scheduler.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.curriculum.load_state_dict(state["curriculum"])
        if self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
