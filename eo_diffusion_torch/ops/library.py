"""The sampling path's forward kernels as ``torch.library`` custom ops.

A kernel launched through ``ctypes`` on ``data_ptr()`` cannot be traced by
``torch.export``: under fake tensors there is no pointer to hand it. So the
forward entries that sampling launches are registered here as ops of the
``eo`` namespace, each with a fake implementation that gives its output's
shape, so an exported program (``serving/export.py``) holds them as
``eo::`` nodes and launches the same kernels when it runs:

* ``eo::qkv_attention(qkv, heads, new_order)``: the fused-qkv entry
  (K1): :func:`~eo_diffusion_torch.ops.attention.qkv_attention_cuda`, which
  hands float32 to ``qkv_attention_f32_cuda``;
* ``eo::flash_attention(q, k, v)``: the separate-tensor entry (K2/K3):
  :func:`~eo_diffusion_torch.ops.attention.flash_attention_cuda`, which
  hands float32 to ``flash_attention_f32_cuda`` and head dims above its
  bodies' to ``wide_attention_cuda``;
* ``eo::group_norm(x, gamma, beta, groups, eps, act)``: K5's forward,
  :func:`~eo_diffusion_torch.ops.group_norm.group_norm_fwd_cuda`.

The CUDA implementation of each op is that launcher, with its launch
counter inside, so an exported program's run counts its launches. The CPU
implementation is the plain version, which the port runs on a CPU tensor
anyway. ``attention_from_qkv`` and ``fused_group_norm`` reach these ops on
their ``impl="auto"`` path when no gradient is taken (:func:`sampling_call`);
with autograd on, or under a forward-mode transform, they keep their
``autograd.Function`` (the training path and its launch counts are
unchanged), and ``impl="plain"`` still bypasses both.

This module imports only ``torch`` and the kernel wrappers.
"""

from __future__ import annotations

import torch

from eo_diffusion_torch.ops import attention as A
from eo_diffusion_torch.ops import group_norm as G

__all__ = ["sampling_call", "OPS"]

OPS = ("qkv_attention", "flash_attention", "group_norm")


def sampling_call(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` takes the custom op: no gradient is recorded,
    and ``x`` carries no forward-mode tangent (a ``torch.func`` transform or
    a ``forward_ad`` dual tensor), which the ops have no rule for."""
    return not (torch.is_grad_enabled()
                or torch._C._functorch.is_functorch_wrapped_tensor(x)
                or torch.autograd.forward_ad.unpack_dual(x).tangent is not None)


def _qkv_cuda(qkv, heads, new_order):
    return A.qkv_attention_cuda(qkv, heads, new_order)


def _qkv_cpu(qkv, heads, new_order):
    b, t, c3 = qkv.shape
    return A.reference_attention(*A.split_qkv(qkv, heads, new_order)).reshape(b, t, c3 // 3)


def _qkv_fake(qkv, heads, new_order):
    b, t, c3 = qkv.shape
    return qkv.new_empty((b, t, c3 // 3))


def _flash_cuda(q, k, v):
    return A.flash_attention_cuda(q, k, v)


def _flash_cpu(q, k, v):
    return A.reference_attention(q, k, v).contiguous()


def _flash_fake(q, k, v):
    return q.new_empty(q.shape)


def _gn_cuda(x, gamma, beta, groups, eps, act):
    return G.group_norm_fwd_cuda(x, gamma, beta, groups, eps, act)[0]


def _gn_cpu(x, gamma, beta, groups, eps, act):
    return G.group_norm_reference(x, gamma, beta, groups, eps, act)


def _gn_fake(x, gamma, beta, groups, eps, act):
    return x.new_empty(x.shape)


_LIB = torch.library.Library("eo", "DEF")
for _name, _schema, _cuda, _cpu, _fake in (
        ("qkv_attention", "(Tensor qkv, int heads, bool new_order) -> Tensor",
         _qkv_cuda, _qkv_cpu, _qkv_fake),
        ("flash_attention", "(Tensor q, Tensor k, Tensor v) -> Tensor",
         _flash_cuda, _flash_cpu, _flash_fake),
        ("group_norm",
         "(Tensor x, Tensor gamma, Tensor beta, int groups, float eps, str act) -> Tensor",
         _gn_cuda, _gn_cpu, _gn_fake)):
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake("eo::" + _name, _fake, lib=_LIB)
