"""The samplers (Euler discrete, DDIM, DPM-Solver++ 2M) and the
training-time DDPM forward process (port of
``diffsensei_tpu/models/schedulers.py``).

The tables are built in numpy exactly as the JAX package builds them and
held as fp32 tensors; ``scale_model_input``, ``step`` and ``multistep_step``
are indexed by the loop counter. ``DDPMSchedule`` noises latents for the
train steps.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
    kind: str                          # "euler_discrete" | "ddim" | "dpmsolver++"
    timesteps: torch.Tensor            # [num_steps] fp32, the UNet's t input
    sigmas: torch.Tensor               # [num_steps + 1] fp32 (zeros for ddim)
    alphas_cumprod_t: torch.Tensor     # [num_steps] acp at t (ddim; zeros else)
    alphas_cumprod_prev: torch.Tensor  # [num_steps] acp at the previous t (ddim)
    init_noise_sigma: torch.Tensor     # scalar fp32: initial latent scale
    # [5, num_steps] (dpmsolver++; [5, 0] else): inv_alpha, sigma_karras (x0
    # conversion), c_x, c_d0, c_d1 (update), as ``make_dpmpp_2m`` derives them
    dpm_tables: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((5, 0), dtype=torch.float32))

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    @property
    def is_multistep(self) -> bool:
        return self.kind == "dpmsolver++"

    def to(self, device) -> "SamplerState":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "kind"})


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _leading_timesteps(num_steps: int, num_train_timesteps: int,
                       steps_offset: int) -> np.ndarray:
    """"leading" spacing, descending: ``k * ratio + offset`` (951..1 at 20)."""
    step_ratio = num_train_timesteps // num_steps
    timesteps = (np.arange(num_steps, dtype=np.float64) * step_ratio).round()
    return (timesteps + steps_offset)[::-1].copy()


def make_euler_discrete(num_steps: int,
                        num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
                        steps_offset: int = 1) -> SamplerState:
    """EulerDiscreteScheduler of the released SDXL config: "leading" spacing
    with ``steps_offset=1`` (951..1 at 20 steps) and
    ``init_noise_sigma = sqrt(sigma_max^2 + 1)``."""
    acp = _alphas_cumprod(num_train_timesteps)
    sigmas_full = np.sqrt((1.0 - acp) / acp)
    timesteps = _leading_timesteps(num_steps, num_train_timesteps, steps_offset)
    sigmas = np.interp(timesteps, np.arange(num_train_timesteps), sigmas_full)
    sigmas = np.concatenate([sigmas, [0.0]])
    init_noise_sigma = np.sqrt(sigmas.max() ** 2 + 1.0)
    zeros = np.zeros(num_steps)
    return SamplerState(kind="euler_discrete", timesteps=_f32(timesteps),
                        sigmas=_f32(sigmas), alphas_cumprod_t=_f32(zeros),
                        alphas_cumprod_prev=_f32(zeros),
                        init_noise_sigma=_f32(init_noise_sigma))


def make_ddim(num_steps: int, num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
              steps_offset: int = 1) -> SamplerState:
    """DDIMScheduler (eta 0) with the SD defaults: "leading" spacing, offset
    1, and ``acp[0]`` where the previous timestep falls below 0."""
    acp = _alphas_cumprod(num_train_timesteps)
    step_ratio = num_train_timesteps // num_steps
    timesteps = (np.arange(num_steps) * step_ratio).round()[::-1].astype(np.int64)
    timesteps = timesteps + steps_offset
    prev_timesteps = timesteps - step_ratio
    acp_t = acp[np.clip(timesteps, 0, num_train_timesteps - 1)]
    acp_prev = np.where(prev_timesteps >= 0,
                        acp[np.clip(prev_timesteps, 0, num_train_timesteps - 1)], acp[0])
    return SamplerState(kind="ddim", timesteps=_f32(timesteps),
                        sigmas=torch.zeros(num_steps + 1, dtype=torch.float32),
                        alphas_cumprod_t=_f32(acp_t), alphas_cumprod_prev=_f32(acp_prev),
                        init_noise_sigma=_f32(1.0))


def make_dpmpp_2m(num_steps: int, num_train_timesteps: int = NUM_TRAIN_TIMESTEPS,
                  steps_offset: int = 1) -> SamplerState:
    """DPM-Solver++ (2M), epsilon prediction, VP-scaled latents (diffusers'
    ``DPMSolverMultistepScheduler(algorithm_type="dpmsolver++",
    solver_order=2, lower_order_final=True, final_sigmas_type="zero")``) at
    the Euler sampler's "leading" timesteps. ``init_noise_sigma`` is 1 and
    ``scale_model_input`` the identity. With lam = -log(sigma_karras),
    h = lam[i+1] - lam[i], h0 = lam[i] - lam[i-1]:

      x0_i   = inv_alpha_i * x - sig_k_i * eps
      x_next = c_x * x + c_d0 * x0_i + c_d1 * (x0_i - x0_{i-1})
      c_x = s_{i+1} / s_i,  c_d0 = a_{i+1} (1 - exp(-h)),  c_d1 = 0.5 c_d0 h / h0

    ``c_d1`` is 0 at the first and the final step; the final step goes to
    sigma 0 (``c_x`` 0, ``c_d0`` 1), so it returns the predicted x0."""
    acp = _alphas_cumprod(num_train_timesteps)
    sigmas_full = np.sqrt((1.0 - acp) / acp)
    timesteps = _leading_timesteps(num_steps, num_train_timesteps, steps_offset)
    sig_k = np.interp(timesteps, np.arange(num_train_timesteps), sigmas_full)
    sig_k = np.concatenate([sig_k, [0.0]])          # boundary: sigma -> 0
    alpha = 1.0 / np.sqrt(1.0 + sig_k[:-1] ** 2)    # VP alpha at the N points
    sigma_vp = sig_k[:-1] * alpha
    lam = -np.log(sig_k[:-1])

    c_x, c_d0, c_d1 = np.zeros(num_steps), np.zeros(num_steps), np.zeros(num_steps)
    for i in range(num_steps):
        if i == num_steps - 1:                      # final: to sigma = 0
            c_x[i], c_d0[i], c_d1[i] = 0.0, 1.0, 0.0
            continue
        h = lam[i + 1] - lam[i]
        c_x[i] = sigma_vp[i + 1] / sigma_vp[i]
        c_d0[i] = (1.0 / np.sqrt(1.0 + sig_k[i + 1] ** 2)) * (1 - np.exp(-h))
        if i > 0:                                   # first step: first order
            c_d1[i] = 0.5 * c_d0[i] * h / (lam[i] - lam[i - 1])
    zeros = np.zeros(num_steps)
    return SamplerState(kind="dpmsolver++", timesteps=_f32(timesteps), sigmas=_f32(sig_k),
                        alphas_cumprod_t=_f32(zeros), alphas_cumprod_prev=_f32(zeros),
                        init_noise_sigma=_f32(1.0),
                        dpm_tables=_f32(np.stack([1.0 / alpha, sig_k[:-1], c_x, c_d0, c_d1])))


def make_sampler(kind: str, num_steps: int) -> SamplerState:
    if kind == "euler_discrete":
        return make_euler_discrete(num_steps)
    if kind == "ddim":
        return make_ddim(num_steps)
    if kind == "dpmsolver++":
        return make_dpmpp_2m(num_steps)
    raise ValueError(f"unknown sampler kind: {kind}")


def scale_model_input(state: SamplerState, sample: torch.Tensor, i: int) -> torch.Tensor:
    """Pre-UNet latent scaling at loop step i (the identity for DDIM and
    DPM-Solver++, whose latents are VP-scaled)."""
    if state.kind == "euler_discrete":
        sigma = state.sigmas[i]
        return (sample / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)
    return sample


def multistep_step(state: SamplerState, model_output: torch.Tensor, i: int,
                   sample: torch.Tensor, prev_x0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPM-Solver++ (2M) update at loop step i, in fp32. ``prev_x0`` is the
    previous step's x0 prediction (zeros at i = 0, where its coefficient is
    0). Returns ``(prev_sample, x0)``; x0 is the next step's ``prev_x0``."""
    if not state.is_multistep:
        raise ValueError(f"multistep_step needs dpmsolver++, got {state.kind}")
    out = model_output.float()
    x = sample.float()
    inv_alpha, sig_k, c_x, c_d0, c_d1 = state.dpm_tables[:, i]
    x0 = inv_alpha * x - sig_k * out
    prev = c_x * x + c_d0 * x0 + c_d1 * (x0 - prev_x0.float())
    return prev.to(sample.dtype), x0.to(sample.dtype)


def step(state: SamplerState, model_output: torch.Tensor, i: int,
         sample: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t-1} at loop step i (epsilon prediction), in fp32."""
    out = model_output.float()
    x = sample.float()
    if state.kind == "euler_discrete":
        sigma = state.sigmas[i]
        sigma_next = state.sigmas[i + 1]
        pred_x0 = x - sigma * out
        derivative = (x - pred_x0) / sigma
        prev = x + derivative * (sigma_next - sigma)
    elif state.kind == "ddim":
        a_t = state.alphas_cumprod_t[i]
        a_prev = state.alphas_cumprod_prev[i]
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * out) / torch.sqrt(a_t)
        prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * out
    else:
        raise ValueError(f"step does not take {state.kind}; use multistep_step")
    return prev.to(sample.dtype)
