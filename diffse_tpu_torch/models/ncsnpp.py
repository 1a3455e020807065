"""NCSN++ score network (port of diffse_tpu/models/ncsnpp.py, ``NCSNpp`` and
``NCSNppSNR``).

Built as the reference torch NCSN++ builds it: one ``all_modules``
``nn.ModuleList`` plus ``output_layer``, with the indices that
``convert.ncsnpp_correspondence`` emits, so that converted flax parameters
and the reference's published checkpoints load with ``strict=True``.

This is the repo's NCSN++ configuration: BigGAN residual blocks, FIR
[1,3,3,1] resampling, Gaussian-Fourier time embedding, input_skip input
pyramid with ``sum`` combine, output_skip output pyramid, SiLU. The trunk's
GroupNorm chains run through the CUDA kernels (models/layers.py); the 7
output-pyramid heads run GroupNorm -> SiLU -> conv3x3(->4 channels) as one
``groupnorm_silu_conv3x3`` each. Maps are NCHW in channels_last memory.

``dtype="bf16"`` is the JAX package's bf16 trunk (its ``use_pallas_groupnorm``
and ``fuse_pyramid`` path): the parameters and the state_dict stay float32;
the stem conv takes the float32 spectrogram and gives bfloat16; every block,
attention and Combine runs in bfloat16 (models/layers.py says where float32
stays); each pyramid head runs the fused kernel on the bf16 map with a bf16
output, cast to float32; the pyramid's sum and FIR upsample, the division by
the noise level and ``output_layer`` are float32.

The SNR-conditioned variant (``NCSNppSNR``) is the same network with a second
Gaussian-Fourier embedding, of the noise level, fed through its own two dense
layers into every residual block (``Dense_1``), and the output divided by the
noise level instead of the time.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.cuda_kernels import groupnorm_silu_conv3x3_op
from ..ops.fir import downsample_2d, upsample_2d
from ..utils import float32_precision, trunk_dtype
from . import layers
from .shared import BackboneRegistry


class NCSNppBase(nn.Module):
    """NCSN++ with the time embedding alone, or with a second (noise)
    embedding when ``snr_conditioning``."""

    snr_conditioning = False

    def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 image_size: int = 256, dtype: Optional[str] = None,
                 fuse_pyramid: bool = True, dropout: float = 0.0, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        """``dtype``: the trunk's compute dtype, None (float32) or "bf16".
        ``fuse_pyramid`` names the JAX package's flag; the port always runs
        the pyramid heads fused (one kernel each) and takes no other value.
        ``dropout``: the JAX package's default 0.0; the port's residual blocks
        have no dropout, so a training forward (``train()`` mode) raises on
        any other value. ``remat``: recompute each residual block's
        activations in the backward pass (``torch.utils.checkpoint``, the
        JAX package's ``nn.remat``) instead of keeping them."""
        super().__init__()
        if not fuse_pyramid:
            raise ValueError("the port runs the output pyramid's heads fused only "
                             "(fuse_pyramid=True)")
        self.dropout = dropout
        self.remat = remat
        self.compute_dtype = trunk_dtype(dtype)
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        num_resolutions = len(self.ch_mult)
        self.all_resolutions = [image_size // (2 ** i) for i in range(num_resolutions)]
        num_channels = 4
        temb_dim = nf * 4
        semb_dim = temb_dim if self.snr_conditioning else None
        g = generator

        def resblock(in_ch, out_ch=None, up=False, down=False):
            return layers.ResnetBlockBigGANpp(in_ch, out_ch, temb_dim, up=up, down=down,
                                              semb_dim=semb_dim, generator=g,
                                              dtype=self.compute_dtype)

        def attn(ch):
            return layers.AttnBlockpp(ch, generator=g)

        def embedding():
            return [layers.GaussianFourierProjection(nf, scale=16.0, generator=g)]

        def embedding_denses():
            return [layers.ddpm_dense(2 * nf, temb_dim, g),
                    layers.ddpm_dense(temb_dim, temb_dim, g)]

        # time_embed[, noise_embed], temb_dense_0/1[, semb_dense_0/1], stem conv
        snr = self.snr_conditioning
        modules = embedding() + (embedding() if snr else [])
        modules += embedding_denses() + (embedding_denses() if snr else [])
        modules.append(layers.ddpm_conv(num_channels, nf, 3, generator=g))
        in_ch = nf
        hs_c = [nf]
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resblock(in_ch, out_ch))
                in_ch = out_ch
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    modules.append(attn(in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                modules.append(resblock(in_ch, down=True))
                modules.append(layers.Combine(num_channels, in_ch, generator=g))
                hs_c.append(in_ch)

        modules += [resblock(in_ch), attn(in_ch), resblock(in_ch)]

        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resblock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(attn(in_ch))
            modules.append(layers.GroupNorm(in_ch))
            modules.append(layers.hwio_memory_(layers.ddpm_conv(
                in_ch, num_channels, 3, init_scale=0.0, generator=g)))
            if i_level != 0:
                modules.append(resblock(in_ch, up=True))

        self.all_modules = nn.ModuleList(modules)
        self.output_layer = layers.ddpm_conv(num_channels, 2, 1, generator=g)

    # flags of the JAX package's command line that choose between its Pallas
    # kernels and XLA on the TPU: the port takes them and always runs its
    # CUDA kernels, so they are no keywords of the port's backbone
    TPU_KERNEL_FLAGS = ("use_pallas_groupnorm", "pallas_max_hw", "fuse_pyramid")

    @staticmethod
    def add_argparse_args(parser):
        """The JAX package's NCSN++ flags, with its names and defaults
        (``TPU_KERNEL_FLAGS`` among them)."""
        parser.add_argument("--nf", type=int, default=None)
        parser.add_argument("--ch_mult", type=int, nargs="+", default=None)
        parser.add_argument("--num_res_blocks", type=int, default=None)
        parser.add_argument("--attn_resolutions", type=int, nargs="+", default=None)
        parser.add_argument("--image_size", type=int, default=None)
        parser.add_argument("--backbone_dtype", dest="dtype", type=str, default=None,
                            choices=("float32", "bf16"))
        kernels = "accepted as the JAX package takes it; the port always runs its CUDA kernels"
        parser.add_argument("--pallas_groupnorm", dest="use_pallas_groupnorm",
                            action="store_true", default=False, help=kernels)
        parser.add_argument("--pallas_max_hw", type=int, default=0, help=kernels)
        parser.add_argument("--fuse_pyramid", dest="fuse_pyramid", action="store_true",
                            default=False, help=kernels)
        parser.add_argument("--remat", dest="remat", action="store_true", default=False,
                            help="recompute every residual block's activations in the "
                                 "backward pass (torch.utils.checkpoint)")
        return parser

    @staticmethod
    def _pyramid_head(h: torch.Tensor, gn: layers.GroupNorm, conv: nn.Conv2d) -> torch.Tensor:
        """GroupNorm -> SiLU -> conv3x3 to 4 channels, one fused kernel in h's
        dtype; the head's output as float32."""
        bias = conv.bias[None, :].expand(h.shape[0], conv.out_channels)
        out = groupnorm_silu_conv3x3_op(layers.to_nhwc(h), gn.weight, gn.bias,
                                        layers.conv_hwio(conv), bias, gn.num_groups, gn.eps)
        return layers.from_nhwc(out).float()

    def _forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                 noise_cond: Optional[torch.Tensor]) -> torch.Tensor:
        """``noise_cond`` is read when ``snr_conditioning``. What the network
        computes in float32 runs on the card without TF32 in its cuDNN
        convolutions and matmuls, whatever the process-wide setting."""
        if self.training and self.dropout:
            raise NotImplementedError(f"dropout={self.dropout} in training: the port's "
                                      "residual blocks have no dropout yet (0.0 only)")
        with float32_precision(x.device):
            return self._forward_trunk(x, time_cond, noise_cond)

    def _block(self, module: nn.Module, *args) -> torch.Tensor:
        """A residual block's call; with ``remat`` where autograd records, one
        that keeps only its inputs and recomputes the rest in the backward."""
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def _forward_trunk(self, x: torch.Tensor, time_cond: torch.Tensor,
                       noise_cond: Optional[torch.Tensor]) -> torch.Tensor:
        modules = iter(self.all_modules)
        num_resolutions = len(self.ch_mult)
        snr = self.snr_conditioning

        h = torch.stack([x[:, 0].real, x[:, 0].imag, x[:, 1].real, x[:, 1].imag], dim=1)
        h = h.contiguous(memory_format=torch.channels_last)

        temb = next(modules)(torch.log(time_cond))
        semb = next(modules)(torch.log(noise_cond)) if snr else None
        temb = next(modules)(temb)
        temb = next(modules)(F.silu(temb))
        if snr:
            semb = next(modules)(semb)
            semb = next(modules)(F.silu(semb))

        input_pyramid = h
        hs = [layers.conv(next(modules), h, self.compute_dtype)]
        for i_level in range(num_resolutions):
            for _ in range(self.num_res_blocks):
                h = self._block(next(modules), hs[-1], temb, semb)
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    h = next(modules)(h)
                hs.append(h)
            if i_level != num_resolutions - 1:
                h = self._block(next(modules), hs[-1], temb, semb)
                input_pyramid = downsample_2d(input_pyramid, layers.FIR_KERNEL, factor=2)
                h = next(modules)(input_pyramid, h)
                hs.append(h)

        h = hs[-1]
        h = self._block(next(modules), h, temb, semb)
        h = next(modules)(h)
        h = self._block(next(modules), h, temb, semb)

        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = self._block(next(modules), torch.cat([h, hs.pop()], dim=1), temb, semb)
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = next(modules)(h)
            head = self._pyramid_head(h, next(modules), next(modules))
            if pyramid is None:
                pyramid = head
            else:
                pyramid = upsample_2d(pyramid, layers.FIR_KERNEL, factor=2) + head
            if i_level != 0:
                h = self._block(next(modules), h, temb, semb)

        used_sigmas = noise_cond if snr else time_cond
        h = pyramid / used_sigmas[:, None, None, None]
        h = self.output_layer(h)
        return torch.complex(h[:, 0], h[:, 1])[:, None]


@BackboneRegistry.register("ncsnpp")
class NCSNpp(NCSNppBase):
    """NCSN++: ``(x complex [B, 2, F, T], t [B]) -> complex score [B, 1, F, T]``."""

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor) -> torch.Tensor:
        """Args:
            x: complex ``[B, 2, F, T]``: channel 0 the diffusion state, channel 1
               the conditioning spectrogram.
            time_cond: ``[B]`` diffusion time.
        """
        return self._forward(x, time_cond, None)


@BackboneRegistry.register("ncsnpp_snr")
class NCSNppSNR(NCSNppBase):
    """SNR-conditioned NCSN++: ``(x, t, s) -> complex score``, the output
    divided by the noise conditioning ``s``."""

    snr_conditioning = True

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                noise_cond: torch.Tensor) -> torch.Tensor:
        """Args:
            x: complex ``[B, 2, F, T]``, as for ``NCSNpp``.
            time_cond: ``[B]`` diffusion time.
            noise_cond: ``[B]`` noise level (SNR conditioning).
        """
        return self._forward(x, time_cond, noise_cond)
