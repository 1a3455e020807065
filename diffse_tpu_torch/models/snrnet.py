"""SNRNet: the SNR-estimator CNN (port of diffse_tpu/models/snrnet.py).

Input is a noisy complex spectrogram as two real channels ``[B, 2, F=256, T]``
(T a multiple of 16, see ``pad_spec_16``). The time axis is split into
16-frame clusters, each embedded by a small conv stack with four parallel
time-kernel widths (1/2/4/8); a bidirectional LSTM runs over the clusters,
then statistics pooling (mean/std/min/max) and one dense layer give a
sigmoid ``g_hat`` in (0, 1), from which the SNR estimate is
``g_hat / (1 - g_hat)``.

Module names are the reference torch SNRNet's (``conv5x5_1, conv3x3_1,
convt_1..4, blstm, fc``; ``convt_k`` has time width ``2**(k-1)``), so
``convert.snrnet_state_dict_from_jax`` and the published
``snr_estimator.ckpt`` layout load with ``strict=True``. The convolutions and
the LSTM are cuDNN's on the card (the JAX package leaves them to XLA), run in
float32 whatever the process-wide TF32 setting.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import float32_precision
from .shared import BackboneRegistry

TIME_WIDTHS = (1, 2, 4, 8)
# max-pool width over the remaining 8 - width + 1 time steps (to one)
TIME_POOLS = (8, 7, 5, 1)


@BackboneRegistry.register("snrnet")
class SNRNet(nn.Module):
    """~1.26M-parameter SNR estimator: ``[B, 2, 256, T] -> [B, 1]``."""

    def __init__(self, convt_out: int = 32, lstm_hidden: int = 128):
        super().__init__()
        self.conv5x5_1 = nn.Conv2d(2, 32, 5, padding=2)
        self.conv3x3_1 = nn.Conv2d(32, 32, 3, padding=1)
        for idx, width in enumerate(TIME_WIDTHS, start=1):
            setattr(self, f"convt_{idx}", nn.Conv2d(32, convt_out, (64, width)))
        self.blstm = nn.LSTM(convt_out * 4, lstm_hidden, bidirectional=True,
                             batch_first=True)
        self.fc = nn.Linear(lstm_hidden * 2 * 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Args:
            x: ``[B, 2, F=256, T]`` real/imag channels of the noisy STFT.

        Returns:
            ``[B, 1]`` sigmoid outputs g_hat.
        """
        b, c, f, t = x.shape
        if c != 2 or f != 256:
            raise ValueError(f"SNRNet expects [B, 2, 256, T], got {tuple(x.shape)}")
        if t % 16:
            raise ValueError("SNRNet: the time axis must be padded to a multiple of 16 "
                             "(pad_spec_16)")
        with float32_precision(x.device):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, f, t = x.shape
        clusters = t // 16
        # [B,2,F,T] -> [B,T,2,F] -> [N,16,2,F] -> [N,2,F,16] (NCHW of the JAX
        # package's NHWC [N,F,16,2])
        h = x.permute(0, 3, 1, 2).reshape(b * clusters, 16, 2, f).permute(0, 2, 3, 1)
        h = F.max_pool2d(self.conv5x5_1(h), (2, 2))  # [N,32,128,8]
        h = F.max_pool2d(self.conv3x3_1(h), (2, 1))  # [N,32,64,8]
        feats = []
        for idx, pool in enumerate(TIME_POOLS, start=1):
            fi = getattr(self, f"convt_{idx}")(h)  # [N,32,1,8-width+1]
            feats.append(F.max_pool2d(fi, (1, pool))[:, :, 0, 0])
        h = torch.cat(feats, dim=-1).reshape(b, clusters, -1)  # [B, T/16, 128]
        h, _ = self.blstm(h)  # [B, T/16, 256]: forward, then backward outputs
        # statistics pooling; std unbiased (ddof=1), as the reference's torch.std
        h = torch.cat([h.mean(dim=1), h.std(dim=1, unbiased=True),
                       h.amin(dim=1), h.amax(dim=1)], dim=-1)  # [B, 1024]
        return torch.sigmoid(self.fc(h))
