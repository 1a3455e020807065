"""Normalization library of the NCSNv1/v2 lineage (port of
diffse_tpu/models/normalization.py), as plain torch modules over NCHW maps.

No backbone of the repo uses these (the live NCSN++ runs GroupNorm); they
complete the model layer. Parameter names are the JAX package's (``alpha``,
``gamma``, ``beta``; the conditional variants' class embedding ``embed``),
stored as flax stores them: ``alpha`` and ``gamma`` drawn around 0 and
offset by 1 where they are used. Each module takes its channel count, which
flax infers from the input. "Conditional" variants take integer class
labels ``y``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn


def get_normalization(norm: str, conditional: bool = False, num_classes: int = 10):
    """The normalization class by name (a partial with ``num_classes`` for the
    conditional InstanceNorm++)."""
    if conditional:
        if norm == "InstanceNorm++":
            return functools.partial(ConditionalInstanceNorm2dPlus, num_classes=num_classes)
        raise NotImplementedError(f"{norm} not implemented yet.")
    if norm == "InstanceNorm":
        return InstanceNorm2d
    if norm == "InstanceNorm++":
        return InstanceNorm2dPlus
    if norm == "VarianceNorm":
        return VarianceNorm2d
    if norm == "GroupNorm":
        return nn.GroupNorm
    raise ValueError(f"Unknown normalization: {norm}")


def _spatial_var(x: torch.Tensor) -> torch.Tensor:
    return x.var(dim=(2, 3), unbiased=False, keepdim=True)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(_spatial_var(x) + eps)


def _standardized_means(x: torch.Tensor) -> torch.Tensor:
    """Each channel's spatial mean, standardised across the channels:
    ``[B, C]``."""
    means = x.mean(dim=(2, 3))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, unbiased=False, keepdim=True)
    return (means - m) / torch.sqrt(v + 1e-5)


def _c(v: torch.Tensor) -> torch.Tensor:
    """``[C]`` or ``[B, C]`` broadcast over an NCHW map."""
    return v[..., :, None, None] if v.ndim == 2 else v[None, :, None, None]


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel spatial normalization, no affine."""

    def __init__(self, num_features: int = 0, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _instance_norm(x, self.epsilon)


class VarianceNorm2d(nn.Module):
    """Scale-only normalization by the spatial variance: ``(1 + alpha) x /
    sqrt(var + 1e-5)``."""

    def __init__(self, num_features: int, bias: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.randn(num_features) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _c(self.alpha + 1.0) * (x / torch.sqrt(_spatial_var(x) + 1e-5))


class NoneNorm2d(nn.Module):
    """Identity."""

    def __init__(self, num_features: int = 0):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++: instance norm plus the channels' standardised means
    re-injected (``alpha``), then ``gamma`` [and ``beta``]."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(torch.randn(num_features) * 0.02)
        self.gamma = nn.Parameter(torch.randn(num_features) * 0.02)
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        means = _standardized_means(x)
        h = _instance_norm(x) + _c(means) * _c(self.alpha + 1.0)
        out = _c(self.gamma + 1.0) * h
        if self.beta is not None:
            out = out + _c(self.beta)
        return out


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Class-conditional InstanceNorm++: gamma, alpha (and beta) per class
    from the embedding ``embed`` ``[num_classes, 3C]`` (2C without bias)."""

    def __init__(self, num_features: int, num_classes: int = 10, bias: bool = True):
        super().__init__()
        c = num_features
        self.bias = bias
        self.embed = nn.Embedding(num_classes, 3 * c if bias else 2 * c)
        with torch.no_grad():
            self.embed.weight.normal_(1.0, 0.02)
            if bias:
                self.embed.weight[:, 2 * c:] = 0.0

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        embed = self.embed(y)
        means = _standardized_means(x)
        h = _instance_norm(x)
        gamma, alpha = embed[:, :c], embed[:, c:2 * c]
        h = h + _c(means) * _c(alpha)
        if self.bias:
            return _c(gamma) * h + _c(embed[:, 2 * c:])
        return _c(gamma) * h


class ConditionalVarianceNorm2d(nn.Module):
    """Class-conditional variance norm: the class's scale ``embed`` times
    ``x / sqrt(var + 1e-5)``."""

    def __init__(self, num_features: int, num_classes: int = 10):
        super().__init__()
        self.embed = nn.Embedding(num_classes, num_features)
        with torch.no_grad():
            self.embed.weight.normal_(1.0, 0.02)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _c(self.embed(y)) * (x / torch.sqrt(_spatial_var(x) + 1e-5))


class ConditionalNoneNorm2d(nn.Module):
    """Class-conditional affine without normalization."""

    def __init__(self, num_features: int, num_classes: int = 10, bias: bool = True):
        super().__init__()
        c = num_features
        self.bias = bias
        self.embed = nn.Embedding(num_classes, 2 * c if bias else c)
        with torch.no_grad():
            self.embed.weight.uniform_(0.0, 1.0)
            if bias:
                self.embed.weight[:, c:] = 0.0

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        embed = self.embed(y)
        if self.bias:
            return _c(embed[:, :c]) * x + _c(embed[:, c:])
        return _c(embed) * x
