"""Stage-2 trainer: the latent diffusion (either process, any objective) with
the k-best relaxed objective.

Port of ``skeletondiffusion_tpu/train/trainer_diffusion.py`` (reference
`src/core/trainer.py:106-313`): the frozen AutoEncoder embeds the past and
the future, the diffusion loss fans every item out to k samples, each
sample's raw model output is decoded as if it were x̂₀, whatever the
objective (`trainer_diffusion.py:134-147` there, reference `trainer.py:228-231`),
and compared with the ground truth in the configured space, and only the loss
of the closest sample is kept.  The comparison runs under
``torch.no_grad()``; in input and metric space it decodes all k samples of
every item on the rollout kernel (64 × 50 rows at the flagship's batch).
Adam with coupled weight decay (``torch.optim.Adam(weight_decay=·)``, the
reference's optimizer), betas (0.9, 0.99), the gradients clipped to a global
norm of 1.0, and the EMA after each step.

A bf16 denoiser (``compute_dtype=torch.bfloat16``) trains in bf16 with its
parameters and the optimizer state in float32: the module casts the weights
at use, and autograd returns float32 gradients.  Validation samples with the
EMA weights through the prediction path (``SkeletonDiffusionPredictor``,
which for a bf16 denoiser prepares the fused kernel chain's operands from
the EMA module at each call: the weights have moved since the last one).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..diffusion.engine import GaussianDiffusion
from ..eval_pipeline import SkeletonDiffusionPredictor
from ..models.autoencoder import AutoEncoder, autoencoder_loss
from ..parallel.mesh import all_reduce_mean, clip_grad_norm_
from .ema import ema_init, ema_update
from .schedulers import make_lr_scheduler


class TrainerDiffusion:
    def __init__(
        self,
        diffusion: GaussianDiffusion,
        autoencoder: AutoEncoder,
        *,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        train_pick_best_sample_among_k: int = 1,
        similarity_space: str = "latent_space",
        if_use_ema: bool = True,
        ema_update_every: int = 10,
        ema_decay: float = 0.995,
        ema_power: float = 2.0 / 3.0,
        ema_min_value: float = 0.0,
        step_start_ema: int = 100,
        adam_betas: Tuple[float, float] = (0.9, 0.99),
        use_lr_scheduler: bool = False,
        lr_scheduler_kwargs: Optional[dict] = None,
        max_grad_norm: float = 1.0,
        prediction_horizon_eval: int = 100,
        num_prob_samples: int = 50,
        skeleton=None,
        **config,
    ):
        if similarity_space not in ("input_space", "metric_space", "latent_space"):
            raise ValueError(f"similarity_space {similarity_space!r}")
        if similarity_space == "metric_space" and skeleton is None:
            raise ValueError("metric_space similarity needs the skeleton")
        if not diffusion.condition:  # the JAX trainer asserts it (`trainer_diffusion.py:65`)
            raise ValueError("stage-2 training requires conditioning")
        self.diffusion = diffusion
        self.denoiser = diffusion.denoiser
        self.autoencoder = autoencoder.requires_grad_(False)  # frozen
        self.k = train_pick_best_sample_among_k
        self.similarity_space = similarity_space
        self.skeleton = skeleton
        self.lr = lr
        self.max_grad_norm = max_grad_norm
        self.ph_eval = prediction_horizon_eval
        self.num_prob_samples = num_prob_samples
        self.ema_kwargs = dict(beta=ema_decay, update_every=ema_update_every,
                               update_after_step=step_start_ema, power=ema_power,
                               min_value=ema_min_value)
        self.lr_scheduler = (
            make_lr_scheduler(lr=lr, **(lr_scheduler_kwargs or {})) if use_lr_scheduler else None
        )
        self.optimizer = torch.optim.Adam(self.denoiser.parameters(), lr=lr, betas=adam_betas,
                                          weight_decay=weight_decay)
        self.ema = ema_init(self.denoiser) if if_use_ema else None
        self.step = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self.mesh = None  # a mesh (parallel.DataMesh): this rank's rows of each batch
        # the last step's k-best choice: per-sample losses and similarities
        # [b, k] and the chosen index [b] (for inspection; latent_space: the
        # losses are the similarities)
        self.last_choice: Optional[dict] = None

    # ---- loss ---------------------------------------------------------------
    @torch.no_grad()
    def embed(self, x: torch.Tensor, y: torch.Tensor):
        """Frozen-AE embeddings (z_past, z), both detached (the reference
        computes them under no_grad, `trainer.py:243-249`)."""
        return self.autoencoder.get_train_embeddings(y, x)

    @torch.no_grad()
    def decode(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """Decode latents [R,N,D] seeded by x [R,≥2,N,3] over the eval
        horizon: on the rollout kernel for a GRU decoder, as the plain step
        loop for an LSTM one (``AutoEncoder.decode``)."""
        return self.autoencoder.decode(x, latents, self.ph_eval)

    @torch.no_grad()
    def similarity(self, samples: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per (item, sample) distance to the ground truth [b, k] in input or
        metric space (reference `trainer.py:182-205`).  ``samples`` is the
        raw denoiser output, decoded as an x̂₀ latent as the reference does
        (`trainer.py:228-231`)."""
        b, k = y.shape[0], self.k
        out = self.decode(x.repeat_interleave(k, dim=0), samples)  # [b·k, T, N, 3]
        out = out.reshape(b, k, *out.shape[1:])
        if self.similarity_space == "input_space":
            # the AE's configured loss type (`autoencoder.py:80-81`)
            return autoencoder_loss(out, y[:, None], loss_type=self.autoencoder.loss_pose_type,
                                    reduction="none")
        out_m = self.skeleton.transform_to_metric_space(out).reshape(b, k, out.shape[2], -1)
        fut_m = self.skeleton.transform_to_metric_space(y).reshape(b, 1, y.shape[1], -1)
        return torch.linalg.vector_norm(out_m - fut_m, dim=-1).mean(dim=-1)

    def loss(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, z_past: torch.Tensor,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The k-best relaxed loss (reference `trainer.py:207-234`): the
        diffusion loss of k samples per item, the closest sample's kept, the
        mean weighted by the timesteps' loss weights.  ``t`` [b] and ``noise``
        [b·k,N,D] are injected, or drawn from ``generator``."""
        b = z.shape[0]
        loss, weights, samples = self.diffusion.loss(z, x_cond=z_past, n_train_samples=self.k,
                                                     t=t, noise=noise, generator=generator)
        if self.k > 1:
            losses = loss.reshape(b, self.k)
            if self.similarity_space == "latent_space":
                sim = losses.detach()
            else:
                sim = self.similarity(samples.detach(), x, y)
            idx = torch.argmin(sim, dim=-1)
            self.last_choice = {"losses": losses.detach(), "similarity": sim, "index": idx}
            loss = losses.gather(1, idx[:, None])[:, 0]
        return (loss * weights).mean()

    # ---- steps ------------------------------------------------------------
    def current_lr(self) -> float:
        return self.lr if self.lr_scheduler is None else self.lr_scheduler._current

    def optimizer_step(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward, clip, Adam step at the scheduler's lr, EMA update;
        returns the global gradient norm before clipping."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in self.denoiser.parameters() if p.grad is not None]
        if self.mesh is not None:  # the whole batch's gradient, before clipping
            all_reduce_mean(self.mesh, [p.grad for p in params])
        gnorm = clip_grad_norm_(self.mesh, params, self.max_grad_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.current_lr()
        self.optimizer.step()
        if self.ema is not None:
            ema_update(self.ema, self.denoiser, **self.ema_kwargs)
        self.step += 1
        return gnorm

    def train_step(self, batch, generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on ``batch`` = (x [b,To,N,3], y [b,Tp,N,3]) in input
        space; the timesteps and the noise are drawn from ``generator`` (or
        injected).  Returns the loss, detached; the gradient norm is kept in
        ``last_grad_norm``."""
        x, y = batch
        z_past, z = self.embed(x, y)
        if self.mesh is not None and t is None:
            t, noise = self.rank_draws(generator, z)
        loss = self.loss(x, y, z, z_past, t=t, noise=noise, generator=generator)
        self.last_grad_norm = self.optimizer_step(loss).detach()
        loss = loss.detach()
        if self.mesh is not None:  # the whole batch's loss: the mean of the ranks' means
            all_reduce_mean(self.mesh, [loss])
        return loss

    def rank_draws(self, generator: Optional[torch.Generator], z: torch.Tensor):
        """(t, noise) of this rank's rows: the whole batch's timesteps and
        noise drawn in ``loss``'s order (t [B], then noise [B·k,N,D]), then
        cut to the rank's items and their k samples."""
        b = z.shape[0]
        B = b * self.mesh.size
        t = torch.randint(0, self.diffusion.num_timesteps, (B,), generator=generator,
                          device=z.device)
        noise = torch.randn((B * self.k, *z.shape[1:]), generator=generator, device=z.device,
                            dtype=z.dtype)
        lo, hi = self.mesh.rows(B)
        return t[lo:hi], noise[lo * self.k:hi * self.k]

    def epoch_started(self, epoch: int):
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(epoch)

    # ---- validation ------------------------------------------------------------
    def predictor(self) -> SkeletonDiffusionPredictor:
        """The prediction path on the EMA weights (the live ones without
        EMA), prepared now."""
        den = self.denoiser if self.ema is None else self.ema.module
        return SkeletonDiffusionPredictor(self.skeleton, self.autoencoder,
                                          self.diffusion.with_denoiser(den),
                                          num_samples=self.num_prob_samples,
                                          pred_length=self.ph_eval, device=self.diffusion.device)

    @torch.no_grad()
    def validation_step(self, batch, generator: Optional[torch.Generator] = None, **noise):
        """``num_prob_samples`` predictions per observation with the EMA
        weights (reference `trainer.py:289-312`) → (out [b,S,T,N,3], y,
        latents [b,S,N,D], x).  ``noise`` passes ``start_noise`` and
        ``step_noise`` to the predictor."""
        x, y = batch
        out, samples = self.predictor()(generator, x, **noise)
        return out, y, samples, x

    # ---- checkpoint ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "denoiser": self.denoiser.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema": None if self.ema is None else self.ema.state_dict(),
            "step": self.step,
            "lr_scheduler": None if self.lr_scheduler is None else self.lr_scheduler.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.denoiser.load_state_dict(state["denoiser"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.step = int(state["step"])
        if self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
