"""Schedule/image visualization helpers (the port's own copy of
``eo_diffusion_tpu/utils/viz.py``).

Parity with the reference's interactive helpers, redesigned headless:

* ``plot_schedule_params`` — the reference's ``plot_params``
  (``script_utils/utils.py:39-52``) plots the beta curve, the DDIM-subsampled
  alphas (NaN-masked off the subsequence), the full alphas-cumprod curve, and
  their difference at the DDIM steps. The reference calls ``plt.show()`` (and
  hits a stray ``breakpoint()``); here every panel goes to one PNG on disk so
  it works in CI and on headless machines.
* ``show`` — the reference's ``show`` (``script_utils/utils.py:6-15``): a row
  of images side by side; saves to a path instead of popping a window.

Matplotlib imports are deferred so the package does not require it unless
these helpers are called.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from eo_diffusion_torch.core.schedules import DiffusionSchedule, make_ddim_schedule

__all__ = ["plot_schedule_params", "show"]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_schedule_params(schedule: DiffusionSchedule, num_steps: int,
                         out_path: str, eta: float = 0.0,
                         method: str = "uniform") -> str:
    """Plot betas / DDIM alphas / alphas-cumprod / their diff to ``out_path``.

    Mirrors ``plot_params(sampler, steps)`` (utils.py:39-52): the DDIM alphas
    are scattered onto the full T-length axis with NaN everywhere off the
    subsequence, so the strided subsampling is visible against the continuous
    alphas-cumprod curve. Returns ``out_path``.
    """
    plt = _plt()
    ddim = make_ddim_schedule(schedule, num_steps, eta=eta, method=method)
    T = schedule.timesteps
    ddim_alphas = np.full(T, np.nan, np.float64)
    ddim_alphas[ddim.timesteps] = ddim.alphas
    diff = schedule.alphas_cumprod[ddim.timesteps] - ddim.alphas

    fig, axs = plt.subplots(ncols=3, figsize=(12, 3.2))
    axs[0].plot(schedule.betas)
    axs[0].set_title(f"betas (T={T})")
    axs[1].plot(schedule.alphas_cumprod, label="alphas_cumprod")
    axs[1].plot(ddim_alphas, marker=".", linestyle="none",
                label=f"ddim alphas (S={num_steps})")
    axs[1].set_title("cumprod + DDIM subsequence")
    axs[1].legend(fontsize=7)
    axs[2].plot(ddim.timesteps, diff)
    axs[2].set_title("acp[ddim_t] - ddim_alpha")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def show(imgs: Union[np.ndarray, Sequence[np.ndarray]], out_path: str,
         data_range: Optional[tuple] = None) -> str:
    """Save a row of images side by side (reference ``show``, utils.py:6-15).

    ``imgs``: one ``[H, W, C]``/``[H, W]`` array or a list of them (NHWC
    convention; a ``[N, H, W, C]`` batch is treated as a list). Values are
    rescaled from ``data_range`` (default: per-image min/max) to [0, 1].
    Returns ``out_path``.
    """
    plt = _plt()
    if isinstance(imgs, np.ndarray) and imgs.ndim == 4:
        imgs = list(imgs)
    if not isinstance(imgs, (list, tuple)):
        imgs = [imgs]
    fig, axs = plt.subplots(ncols=len(imgs), squeeze=False,
                            figsize=(3 * len(imgs), 3))
    for i, img in enumerate(imgs):
        img = np.asarray(img, np.float32)
        lo, hi = (data_range if data_range is not None
                  else (float(img.min()), float(img.max())))
        img = (img - lo) / max(hi - lo, 1e-12)
        axs[0, i].imshow(np.clip(img.squeeze(), 0, 1),
                         cmap="gray" if img.ndim == 2 or img.shape[-1] == 1
                         else None)
        axs[0, i].set(xticks=[], yticks=[])
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
