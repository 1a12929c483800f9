"""The serving engine's random draws, defined once (imports only ``torch``).

The JAX package keys its draws with ``jax.random`` (``PRNGKey(seed)``,
``fold_in``); torch has no such keys, so the port defines its own seeds.
These draws reproduce within the port, on one device: the same seed gives
the same bytes from the live engine and from an exported artifact. They are
not the JAX package's ``jax.random`` bytes.

* A seeded request draws from ``torch.Generator(device).manual_seed(seed)``.
* Chunk ``i > 0`` of a streamed seeded request draws from
  :func:`chunk_seed` ``(seed, i)``; chunk 0 uses the plain seed, so its bytes
  equal those of a solo request of at most one batch with that seed.
* An unseeded device batch draws from :func:`chunk_seed` ``(base_seed,
  batch_index)`` (the JAX batcher's ``fold_in(base_key, batches)``).

From a batch's generator the engine draws the start noise first, then each
noise the sampler asks for (``noise_fn``), in the sampler's order, each one
``torch.randn`` of the grid's shape. The exported program takes those draws
as inputs, and its loader makes them with :func:`draws`, so both get the
same values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["chunk_seed", "generator", "normal", "draws"]

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def chunk_seed(seed: int, index: int) -> int:
    """The seed of part ``index`` of ``seed`` (a streamed chunk, or an
    unseeded batch of the engine's base seed): a 63-bit value."""
    return _splitmix64((_splitmix64(int(seed) & _MASK64) ^ int(index)) & _MASK64) >> 1


def generator(seed: int, device) -> torch.Generator:
    """The generator a batch draws from: ``torch.Generator(device)`` seeded
    with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """One standard-normal float32 draw of ``shape`` on ``gen``'s device."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)


def draws(seed: int, shape: Sequence[int], count: int, device
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A batch's start noise and its ``count`` sampler noises (stacked to
    ``[count, *shape]``, None when zero), drawn as the live engine draws
    them."""
    gen = generator(seed, device)
    x_t = normal(gen, shape)
    noise = torch.stack([normal(gen, shape) for _ in range(count)]) if count else None
    return x_t, noise
