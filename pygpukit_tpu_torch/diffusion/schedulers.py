"""Diffusion schedulers: Euler, DDIM and flow matching (counterpart of
``pygpukit_tpu/diffusion/schedulers.py``).

The schedules are host-side numpy, computed as the reference computes
them, so sigmas and timesteps are its bits. ``step`` and ``scale_noise``
take numpy arrays or tensors (on any device): on arrays every expression
is the reference's (its numpy scalars included); on tensors the
coefficients enter as Python floats, so the update runs on the tensor's
device in its dtype and no step reads the device back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SchedulerOutput:
    prev_sample: object


def _coef(c, sample):
    """A numpy scalar coefficient as the reference uses it on arrays, a
    Python float on tensors."""
    return float(c) if isinstance(sample, torch.Tensor) else c


class FlowMatchingScheduler:
    """Rectified-flow Euler scheduler (FLUX/SD3 family).

    x_t = (1-sigma)·x0 + sigma·noise; the model predicts the velocity
    v = noise - x0; stepping is Euler on dx/dsigma = v. Supports the
    resolution-dependent timestep shifting FLUX uses.
    """

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0,
                 use_dynamic_shifting: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.sigmas: np.ndarray = np.array([])
        self.timesteps: np.ndarray = np.array([])
        self._step = 0

    def set_timesteps(self, num_steps: int, mu: float | None = None) -> None:
        sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float32)
        if self.use_dynamic_shifting and mu is not None:
            sigmas = np.exp(mu) / (np.exp(mu) + (1 / sigmas - 1))
        elif self.shift != 1.0:
            sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        self.sigmas = np.append(sigmas, 0.0).astype(np.float32)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.float32)
        self._step = 0

    def scale_noise(self, sample, noise, step: int):
        s = float(self.sigmas[step])
        return (1 - s) * sample + s * noise

    def step(self, model_output, step_index: int, sample) -> SchedulerOutput:
        s, s_next = float(self.sigmas[step_index]), float(self.sigmas[step_index + 1])
        return SchedulerOutput(prev_sample=sample + (s_next - s) * model_output)


class EulerDiscreteScheduler:
    """Karras-style Euler over a beta schedule (SD-class models)."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012):
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        alphas_bar = np.cumprod(1.0 - betas)
        self.all_sigmas = np.sqrt((1 - alphas_bar) / alphas_bar)
        self.num_train_timesteps = num_train_timesteps
        self.sigmas = np.array([])
        self.timesteps = np.array([])

    def set_timesteps(self, num_steps: int) -> None:
        idx = np.linspace(self.num_train_timesteps - 1, 0, num_steps)
        sig = np.interp(idx, np.arange(self.num_train_timesteps), self.all_sigmas)
        self.sigmas = np.append(sig, 0.0).astype(np.float32)
        self.timesteps = idx.astype(np.float32)

    @property
    def init_noise_sigma(self) -> float:
        return float(np.sqrt(self.sigmas[0] ** 2 + 1))

    def scale_model_input(self, sample, step_index: int):
        s = float(self.sigmas[step_index])
        return sample / _coef(np.sqrt(s ** 2 + 1), sample)

    def step(self, model_output, step_index: int, sample) -> SchedulerOutput:
        """model_output = predicted noise (epsilon)."""
        s, s_next = float(self.sigmas[step_index]), float(self.sigmas[step_index + 1])
        pred_x0 = sample - s * model_output
        d = (sample - pred_x0) / s
        return SchedulerOutput(prev_sample=sample + d * (s_next - s))


class DDIMScheduler:
    """Deterministic DDIM (eta=0)."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012):
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        self.alphas_bar = np.cumprod(1.0 - betas).astype(np.float32)
        self.num_train_timesteps = num_train_timesteps
        self.timesteps = np.array([])

    def set_timesteps(self, num_steps: int) -> None:
        step = self.num_train_timesteps // num_steps
        self.timesteps = np.arange(self.num_train_timesteps - 1, -1,
                                   -step)[:num_steps].astype(np.int64)

    def step(self, model_output, step_index: int, sample) -> SchedulerOutput:
        t = int(self.timesteps[step_index])
        t_prev = (int(self.timesteps[step_index + 1])
                  if step_index + 1 < len(self.timesteps) else -1)
        a_t = float(self.alphas_bar[t])
        a_prev = float(self.alphas_bar[t_prev]) if t_prev >= 0 else 1.0
        pred_x0 = ((sample - _coef(np.sqrt(1 - a_t), sample) * model_output)
                   / _coef(np.sqrt(a_t), sample))
        direction = _coef(np.sqrt(1 - a_prev), sample) * model_output
        return SchedulerOutput(
            prev_sample=_coef(np.sqrt(a_prev), sample) * pred_x0 + direction)


SCHEDULERS = {
    "flow_matching": FlowMatchingScheduler,
    "euler": EulerDiscreteScheduler,
    "ddim": DDIMScheduler,
}
