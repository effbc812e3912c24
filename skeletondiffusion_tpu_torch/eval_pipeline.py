"""The prediction path: observation → 50 sampled futures.

Port of ``SkeletonDiffusionPredictor`` from
``skeletondiffusion_tpu/eval_pipeline.py`` (`:29-180`; reference
`src/eval_prepare_model.py:89-121`): past embedding (graph-GRU encoder) →
S-fold fan-out → nonisotropic ancestral sampling (posterior-step kernel) →
graph-GRU decode rollout (rollout kernel).  With a bf16 denoiser the sampler
takes the fused branch: the denoiser runs as its chain of kernels
(``ops/kernels/denoiser_fused.py``) on operands prepared once here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .device import DeviceLike, resolve_device
from .diffusion.engine import GaussianDiffusion
from .models.autoencoder import AutoEncoder
from .ops.kernels.denoiser_fused import prep_fused_denoiser


class SkeletonDiffusionPredictor:
    """The trained model pair (AE + diffusion) as a prediction function.

    With a denoiser whose ``compute_dtype`` is bfloat16 the sampler runs the
    fused kernel chain, under the JAX predictor's conditions
    (`eval_pipeline.py:72-87`: attention, no self-conditioning, the
    nonisotropic pred_x0 process with clipping — all the port builds) minus
    the TPU's shape limits; its weight operands are prepared once, at
    construction (re-preparing per call cost the JAX package 42 ms).  The
    decode stays the float32 rollout kernel.

    Otherwise this is the float32 path.  On the GPU its products must run in
    full fp32: set ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's defaults for
    matmuls, not for cuDNN) — TF32 keeps about three decimal digits.

    ``device`` (default ``"cuda"``) is where the modules are moved and the
    prediction runs; asking for CUDA without a GPU raises.  On the CPU the
    two kernels run their plain PyTorch versions.
    """

    def __init__(
        self,
        skeleton,
        autoencoder: AutoEncoder,
        diffusion: GaussianDiffusion,
        num_samples: int = 50,
        pred_length: int = 100,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.skeleton = skeleton
        self.autoencoder = autoencoder.to(self.device).eval()
        self.diffusion = diffusion.to(self.device)
        if diffusion.denoiser.compute_dtype == torch.bfloat16:
            self.diffusion.fused = prep_fused_denoiser(diffusion.denoiser)
        self.num_samples = num_samples
        self.pred_length = pred_length

    @torch.no_grad()
    def __call__(
        self,
        generator: Optional[torch.Generator],
        obs: torch.Tensor,
        num_samples: Optional[int] = None,
        pred_length: Optional[int] = None,
        start_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [B,T,N,3] (input space) → (pred [B,S,T',N,3] input space,
        latents [B,S,N,D]).

        ``generator`` draws the sampler noise (a ``torch.Generator`` on the
        predictor's device); ``start_noise`` [B·S,N,D] and ``step_noise``
        [B·S,T-1,N,D] inject it instead, as the JAX predictor's ``_predict``
        takes them.
        """
        S = num_samples or self.num_samples
        ph = pred_length or self.pred_length
        obs = obs.to(self.device)
        B = obs.shape[0]
        x_cond = self.autoencoder.get_past_embedding(obs).repeat_interleave(S, dim=0)
        latents, _ = self.diffusion.sample(x_cond, generator, start_noise, step_noise)
        pred = self.autoencoder.decode(obs[:, -2:].repeat_interleave(S, dim=0), latents, ph)
        pred = pred.reshape(B, S, ph, *pred.shape[2:])
        return pred, latents.reshape(B, S, *latents.shape[1:])
