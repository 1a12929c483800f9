"""Diffusion noise schedules as pure numpy functions.

The port's own copy of ``eo_diffusion_tpu/core/schedules.py`` (numpy only, so
the two packages build bit-identical tables). Schedule math of the
reference EO_Diffusion repo:

* cosine beta schedule         -> reference ``diffusion/model.py:87-92``
* linear / sqrt / sqrt_linear  -> reference ``diffusion/util.py:38-60``
* DDIM timestep subsequences   -> reference ``diffusion/util.py:63-77``
* DDIM sampling parameters     -> reference ``diffusion/util.py:80-91``
* betas_for_alpha_bar          -> reference ``diffusion/util.py:94-110``

Everything here is a pure numpy function returning static tables (tiny --
O(timesteps) floats); the samplers move them onto the device once.

Schedules are computed in float64 for accuracy and cast to float32, matching
the reference's mixed float32-torch / float64-numpy behaviour to within a few
ULPs (validated by golden tests in ``tests/test_schedules.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np

__all__ = [
    "cosine_betas",
    "make_beta_schedule",
    "betas_for_alpha_bar",
    "DiffusionSchedule",
    "make_schedule",
    "make_ddim_timesteps",
    "make_ddim_sampling_parameters",
    "DDIMSchedule",
    "make_ddim_schedule",
]


def cosine_betas(timesteps: int, epsilon: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine variance schedule.

    Matches ``EODiffusion._cosine_variance_schedule`` (reference
    ``diffusion/model.py:87-92``): f(t) = cos^2(((t/T + eps)/(1+eps)) * pi/2),
    beta_t = clip(1 - f(t+1)/f(t), 0, 0.999).

    Computed in float32 like the reference (torch float32 linspace/cos) so
    that models trained against the reference's tables behave identically.
    """
    steps = np.linspace(0.0, timesteps, timesteps + 1, dtype=np.float32)
    f_t = np.cos(
        ((steps / np.float32(timesteps) + np.float32(epsilon)) / np.float32(1.0 + epsilon))
        * np.float32(math.pi * 0.5)
    ).astype(np.float32) ** 2
    betas = np.clip(np.float32(1.0) - f_t[1:] / f_t[:timesteps], 0.0, 0.999)
    return betas.astype(np.float32)


def make_beta_schedule(
    schedule: Literal["linear", "cosine", "sqrt_linear", "sqrt"],
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedules from the CompVis lineage (reference ``diffusion/util.py:38-60``)."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = timesteps / (1 + cosine_s) * np.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, a_min=0, a_max=0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas.astype(np.float64)


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function (reference ``diffusion/util.py:94-110``)."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed DDPM tables (float32 numpy; become jit constants).

    Mirrors the registered buffers of the reference ``EODiffusion``
    (``diffusion/model.py:23-32``) plus the derived posterior terms used by
    the reverse process.
    """

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray  # acp shifted right, acp_prev[0] == 1
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray

    @property
    def timesteps(self) -> int:
        return int(self.betas.shape[0])


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale a beta schedule so the terminal SNR is exactly zero.

    Lin et al. 2023, "Common Diffusion Noise Schedules and Sample Steps are
    Flawed" (arXiv:2305.08891 Alg. 1; beyond-reference — every schedule the
    reference trains with leaves SNR(T) > 0, so x_T still leaks mean/low-
    frequency information the sampler then bakes into every generation).
    The sqrt-alphas-cumprod curve is shifted to end at 0 and rescaled to
    keep its t=0 value; betas are recovered from the adjusted cumprod.
    Requires the "v" objective downstream: with acp[T-1] = 0 the eps
    parameterization can no longer recover x0 at the terminal step.
    """
    abar_sqrt = np.sqrt(np.cumprod(1.0 - np.asarray(betas, np.float64)))
    a0, aT = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - aT) * a0 / (a0 - aT)
    abar = abar_sqrt**2
    alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


def make_schedule(
    timesteps: int,
    schedule: str = "cosine_eo",
    zero_terminal_snr: bool = False,
    **kwargs,
) -> DiffusionSchedule:
    """Build the full DDPM table set.

    ``cosine_eo`` is the active-path schedule of the reference
    (``diffusion/model.py:23``); the CompVis variants are exposed for parity
    with the vendored DDPM (``diffusion/ddpm.py``). ``zero_terminal_snr``
    applies the Lin et al. 2023 rescale (v-objective models only).
    """
    if schedule == "cosine_eo":
        betas = cosine_betas(timesteps, **kwargs).astype(np.float64)
    else:
        betas = make_beta_schedule(schedule, timesteps, **kwargs)
    if zero_terminal_snr:
        betas = rescale_zero_terminal_snr(betas)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=-1)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    # the reciprocal tables blow up at acp = 0 (the zero-terminal-SNR last
    # row). They only serve the eps/x0 conversions -- the v path reads the
    # direct sqrt tables -- but keep them finite so an accidental use
    # produces a large number, not inf/nan silently poisoning the scan.
    acp_safe = np.maximum(alphas_cumprod, 1e-12)

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp_safe)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp_safe - 1.0)),
    )


def make_ddim_timesteps(
    ddim_discr_method: Literal["uniform", "quad", "trailing"],
    num_ddim_timesteps: int,
    num_ddpm_timesteps: int,
) -> np.ndarray:
    """DDIM timestep subsequence (reference ``diffusion/util.py:63-77``).

    "uniform"/"quad" return the +1-shifted steps exactly like the reference
    ("add one to get the final alpha values right"). "trailing" is the
    Lin et al. 2023 spacing (arXiv:2305.08891 Table 2, beyond-reference):
    anchored at the LAST training step T-1 and walking down, so sampling
    actually starts from the noise level the model saw at t=T-1 — the
    reference's uniform spacing starts at step T - T/S + 1 and silently
    skips the highest noise levels.
    """
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    elif ddim_discr_method == "trailing":
        # linspace, not arange-by-float-stride: arange(T, 0, -T/S) yields
        # S+1 entries whenever T - S*(T/S) rounds above 0 in FP (e.g.
        # T=1000, S=61), and the extra entry becomes timestep -1 after the
        # shift — wrapping to the terminal table row (NaN sigmas under
        # zero-terminal-SNR). linspace(T, T/S, S) is exactly S values.
        steps = np.linspace(num_ddpm_timesteps,
                            num_ddpm_timesteps / num_ddim_timesteps,
                            num_ddim_timesteps)
        return np.round(steps).astype(int)[::-1] - 1  # ascending, ends T-1
    else:
        raise NotImplementedError(
            f'There is no ddim discretization method called "{ddim_discr_method}"'
        )
    # NOTE: returned +1-shifted and UNCLAMPED, exactly like the reference
    # (util.py:75) — make_ddim_schedule owns the in-range correction,
    # because clamping here would double-apply with its T/S < 2 down-shift
    # (producing a duplicated step and never sampling t = T-1)
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
):
    """Per-subsequence-step (sigma, alpha, alpha_prev) tables.

    Reference ``diffusion/util.py:80-91`` / Song et al. (2010.02502) eq. 16.
    """
    alphacums = np.asarray(alphacums, dtype=np.float64)
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Precomputed DDIM tables, indexed by subsequence position (ascending t)."""

    timesteps: np.ndarray  # int32, shape [S] -- DDPM step index of each DDIM step
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_ddim_schedule(
    schedule: DiffusionSchedule,
    num_steps: int,
    eta: float = 0.0,
    method: Literal["uniform", "quad", "trailing"] = "uniform",
) -> DDIMSchedule:
    """Build the DDIM table set from a trained model's DDPM schedule.

    Reproduces ``DDIMSampler.make_schedule`` (reference
    ``diffusion/ddim.py:24-55``) including the off-by-one guard at
    ``ddim.py:27``: when T/S < 2 the +1-shifted steps would index past the
    table, so the reference shifts them back down by one. ("trailing" steps
    are in-range by construction and take neither shift.)
    """
    T = schedule.timesteps
    assert 1 <= num_steps <= T, (
        f"ddim num_steps must be in [1, timesteps={T}], got {num_steps}"
    )
    steps = make_ddim_timesteps(method, num_steps, T)
    if method != "trailing":
        if T / num_steps < 2:
            # reference off-by-one guard (ddim.py:27): undo the +1 shift
            # when the stride is 1 — this alone brings steps in range
            steps = steps - 1
        else:
            # deliberate divergence from the reference: when (T-1) % stride
            # == 0 (e.g. T=1000, S=3 -> +1-shifted step 1000) the reference
            # crashes on the table gather (util.py:75); clamp to the last
            # valid row instead (SURVEY §2.4 policy: fix, don't reproduce)
            steps = np.minimum(steps, T - 1)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        schedule.alphas_cumprod, steps, eta
    )
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DDIMSchedule(
        timesteps=np.asarray(steps, dtype=np.int32),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sigmas=f32(sigmas),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
    )
