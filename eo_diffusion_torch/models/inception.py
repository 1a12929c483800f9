"""InceptionV3 feature extractor for standard (published-comparable) FID/IS.

The port's copy of ``eo_diffusion_tpu/models/inception.py``: torchvision's
``inception_v3`` architecture (the standard FID backbone) giving the 2048-d
pool3 features and the 1000-way logits. Module and parameter names are
torchvision's (``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_var``,
``fc.weight``, and the ``AuxLogits`` head, which inference does not run), so
a torchvision ``inception_v3_google-*.pth`` state dict loads with
``load_state_dict`` as it is (:func:`load_torch_inception`). No weights are
bundled: mount them and pass ``--inception_weights`` / set
``EO_INCEPTION_WEIGHTS``. :func:`state_dict_from_flax` is the inverse of the
JAX package's ``convert_torch_state_dict``: its flax tree -> this module's
state dict.

Activations are NHWC at the boundary (``[N, H, W, 3]`` preprocessed by
:func:`preprocess`), NCHW inside; BatchNorm is inference-only, eps 1e-3.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eo_diffusion_torch.utils.metrics import resize_bilinear

__all__ = ["InceptionV3", "load_torch_inception", "preprocess", "inception_feature_extractor",
           "state_dict_from_flax"]

_BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """Conv (no bias) + inference BatchNorm(eps=1e-3) + ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    # stride-1 3x3 average with zero padding, dividing by 9 everywhere
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionAux(nn.Module):
    """torchvision's auxiliary head: its parameters are part of the
    ``inception_v3_google`` state dict; inference never runs it."""

    def __init__(self, c_in: int, num_classes: int):
        super().__init__()
        self.conv0 = BasicConv2d(c_in, 128, 1)
        self.conv1 = BasicConv2d(128, 768, 5)
        self.fc = nn.Linear(768, num_classes)


class InceptionV3(nn.Module):
    """Torchvision-layout InceptionV3, inference only.

    ``forward(x)`` with x ``[N, H, W, 3]`` preprocessed (:func:`preprocess`),
    H = W = 299 canonically (any size >= 75 works; the head pools globally).
    Returns ``{"pool3": [N, 2048], "logits": [N, 1000]}``. ``aux_logits``
    keeps torchvision's auxiliary head's parameters (unused), so its state
    dict loads strictly; the JAX package's tree has none.
    """

    def __init__(self, num_classes: int = 1000, aux_logits: bool = True):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        if aux_logits:
            self.AuxLogits = InceptionAux(768, num_classes)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool_3x3_s2(x)))
        x = _max_pool_3x3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = x.mean(dim=(2, 3))  # adaptive avg pool to 1x1
        return {"pool3": pool3, "logits": self.fc(pool3)}


def preprocess(images01, size: int = 299) -> torch.Tensor:
    """[0,1] NHWC RGB (numpy or tensor) -> ``size`` x ``size``, scaled as
    torchvision's inception_v3 pipeline sees it with ``transform_input=True``
    (which the google weights force): ``(x - 0.5) / 0.5``. Grey is repeated
    to RGB; the resize is ``jax.image.resize``'s bilinear."""
    x = images01 if torch.is_tensor(images01) else torch.from_numpy(
        np.ascontiguousarray(images01, np.float32))
    x = x.float()
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    if x.shape[1] != size or x.shape[2] != size:
        x = resize_bilinear(x, size, size)
    return (x - 0.5) / 0.5


_BN_MAP = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
           "bn_var": "running_var"}


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3 tree (``{"params": ...}``, numpy leaves;
    the output of its ``convert_torch_state_dict``) -> this module's state
    dict without the auxiliary head (load into ``InceptionV3(aux_logits=
    False)``): conv kernels HWIO -> OIHW, ``fc`` [2048, 1000] -> [1000,
    2048], BatchNorm's four leaves to torchvision's names, and
    ``num_batches_tracked`` 0."""
    sd: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if path == ("fc",):
                sd[f"fc.{'weight' if k == 'kernel' else 'bias'}"] = v.T if k == "kernel" else v
            elif path[-1] == "conv" and k == "kernel":
                sd[".".join(path) + ".weight"] = v.transpose(3, 2, 0, 1)
            elif k in _BN_MAP:
                scope = ".".join(path)
                sd[f"{scope}.bn.{_BN_MAP[k]}"] = v
                sd.setdefault(f"{scope}.bn.num_batches_tracked", np.zeros((), np.int64))
            else:
                raise ValueError(f"unrecognized flax inception leaf: {'/'.join(path + (k,))}")

    walk(params["params"] if "params" in params else params, ())
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # writable copies


def load_torch_inception(path: str, device=None) -> InceptionV3:
    """A torchvision ``inception_v3_google-*.pth`` as the port's model, in
    eval mode on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = InceptionV3(aux_logits=any(k.startswith("AuxLogits.") for k in sd))
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def inception_feature_extractor(model: InceptionV3, batch_size: int = 64,
                                with_logits: bool = False):
    """Build an extractor ``f(images01) -> pool3 feats`` (or ``(feats,
    probs)``), float32 numpy, compatible with ``utils.metrics.FrechetDistance``;
    it runs on the model's device in chunks of ``batch_size``."""
    device = next(model.parameters()).device
    model.eval()

    @torch.no_grad()
    def extract(images01):
        feats, probs = [], []
        for s in range(0, len(images01), batch_size):
            chunk = images01[s:s + batch_size]
            x = chunk.to(device) if torch.is_tensor(chunk) else torch.as_tensor(
                np.asarray(chunk, np.float32), device=device)
            out = model(preprocess(x))
            feats.append(out["pool3"].cpu().numpy())
            probs.append(torch.softmax(out["logits"], -1).cpu().numpy())
        if with_logits:
            return np.concatenate(feats), np.concatenate(probs)
        return np.concatenate(feats)

    return extract
