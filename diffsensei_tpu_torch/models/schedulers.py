"""Euler discrete sampling and the training-time DDPM forward process (port
of ``diffsensei_tpu/models/schedulers.py``).

The tables are built in numpy exactly as the JAX package builds them and
held as fp32 tensors; ``scale_model_input`` and ``step`` are indexed by the
loop counter. ``DDPMSchedule`` noises latents for the train steps. The DDIM
and DPM-Solver++ samplers wait for a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000
BETA_START = 0.00085
BETA_END = 0.012


def _alphas_cumprod(num_train_timesteps: int = NUM_TRAIN_TIMESTEPS) -> np.ndarray:
    # "scaled_linear" beta schedule (Stable Diffusion family)
    betas = np.linspace(BETA_START**0.5, BETA_END**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


class DDPMSchedule:
    """Forward-process tables (``schedulers.py:36``); the train steps noise
    latents with it."""

    def __init__(self, num_train_timesteps: int = NUM_TRAIN_TIMESTEPS):
        self.num_train_timesteps = num_train_timesteps
        acp = _alphas_cumprod(num_train_timesteps)
        self._sqrt_acp = torch.tensor(np.sqrt(acp), dtype=torch.float32)
        self._sqrt_1macp = torch.tensor(np.sqrt(1.0 - acp), dtype=torch.float32)

    def _coefs(self, sample: torch.Tensor, timesteps: torch.Tensor):
        shape = (-1,) + (1,) * (sample.dim() - 1)
        t = timesteps.long().to(sample.device)
        a = self._sqrt_acp.to(sample.device)[t].reshape(shape).to(sample.dtype)
        b = self._sqrt_1macp.to(sample.device)[t].reshape(shape).to(sample.dtype)
        return a, b

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps (per-batch timesteps)."""
        a, b = self._coefs(sample, timesteps)
        return a * sample + b * noise

    def velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target: v = sqrt(acp) eps - sqrt(1 - acp) x_0."""
        a, b = self._coefs(sample, timesteps)
        return a * noise - b * sample


@dataclasses.dataclass(frozen=True)
class SamplerState:
    kind: str                        # "euler_discrete"
    timesteps: torch.Tensor          # [num_steps] fp32, the UNet's t input
    sigmas: torch.Tensor             # [num_steps + 1] fp32
    init_noise_sigma: torch.Tensor   # scalar fp32: initial latent scale

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def to(self, device) -> "SamplerState":
        return dataclasses.replace(
            self, timesteps=self.timesteps.to(device), sigmas=self.sigmas.to(device),
            init_noise_sigma=self.init_noise_sigma.to(device))


def make_euler_discrete(num_steps: int,
                        num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
                        steps_offset: int = 1) -> SamplerState:
    """EulerDiscreteScheduler of the released SDXL config: "leading" spacing
    with ``steps_offset=1`` (951..1 at 20 steps) and
    ``init_noise_sigma = sqrt(sigma_max^2 + 1)``."""
    acp = _alphas_cumprod(num_train_timesteps)
    sigmas_full = np.sqrt((1.0 - acp) / acp)
    step_ratio = num_train_timesteps // num_steps
    timesteps = (np.arange(num_steps, dtype=np.float64) * step_ratio).round()
    timesteps = (timesteps + steps_offset)[::-1].copy()
    sigmas = np.interp(timesteps, np.arange(num_train_timesteps), sigmas_full)
    sigmas = np.concatenate([sigmas, [0.0]])
    init_noise_sigma = np.sqrt(sigmas.max() ** 2 + 1.0)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return SamplerState(kind="euler_discrete", timesteps=f32(timesteps),
                        sigmas=f32(sigmas), init_noise_sigma=f32(init_noise_sigma))


def make_sampler(kind: str, num_steps: int) -> SamplerState:
    if kind == "euler_discrete":
        return make_euler_discrete(num_steps)
    raise ValueError(f"sampler {kind!r} is not ported yet (only euler_discrete)")


def scale_model_input(state: SamplerState, sample: torch.Tensor, i: int) -> torch.Tensor:
    """Pre-UNet latent scaling at loop step i."""
    sigma = state.sigmas[i]
    return (sample / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)


def step(state: SamplerState, model_output: torch.Tensor, i: int,
         sample: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t-1} at loop step i (epsilon prediction), in fp32."""
    out = model_output.float()
    x = sample.float()
    sigma = state.sigmas[i]
    sigma_next = state.sigmas[i + 1]
    pred_x0 = x - sigma * out
    derivative = (x - pred_x0) / sigma
    prev = x + derivative * (sigma_next - sigma)
    return prev.to(sample.dtype)
