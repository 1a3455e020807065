"""NCSN++ score network (port of diffse_tpu/models/ncsnpp.py, ``NCSNpp`` and
``NCSNppSNR``).

Built as the reference torch NCSN++ builds it: one ``all_modules``
``nn.ModuleList`` plus ``output_layer``, with the indices that
``convert.ncsnpp_correspondence`` emits, so that converted flax parameters
and the reference's published checkpoints load with ``strict=True``.

Every configuration of the JAX package's ``NCSNppBase`` builds (its fields,
``NCSNppBase.__doc__``); the default is the repo's NCSN++: BigGAN residual
blocks, FIR [1,3,3,1] resampling, Gaussian-Fourier time embedding,
input_skip input pyramid with ``sum`` combine, output_skip output pyramid,
SiLU. With SiLU the trunk's GroupNorm chains run through the CUDA kernels
(models/layers.py), and every GroupNorm -> SiLU -> conv3x3 head (the output
pyramid's, the residual pyramid's first, the output's) as one
``groupnorm_silu_conv3x3``; other nonlinearities run plain PyTorch there,
as the JAX package runs flax. Maps are NCHW in channels_last memory.

``dtype="bf16"`` is the JAX package's bf16 trunk (its ``use_pallas_groupnorm``
and ``fuse_pyramid`` path), in every configuration: the parameters and the
state_dict stay float32; the stem conv takes the float32 spectrogram and
gives bfloat16; BigGAN blocks, attention and Combine run in bfloat16, and
DDPM-style blocks in float32 (they have no dtype in the JAX package, so a
DDPM trunk is float32 after its first block's GroupNorm; models/layers.py
tabulates where each layer rounds); each output_skip head runs the fused
kernel on the bf16 map with a bf16 output (swish) or the plain chain in
bf16, cast to float32; the residual pyramids are float32 (their resampling
convs have no dtype), the first head of the residual output pyramid the
plain chain in bf16, and the final head of a configuration without
output_skip float32; the pyramid's sum and upsample, the division by the
noise level and ``output_layer`` are float32.

The SNR-conditioned variant (``NCSNppSNR``) is the same network with a second
Gaussian-Fourier embedding, of the noise level, fed through its own two dense
layers into every residual block (``Dense_1``), and the output divided by the
noise level instead of the time.

Inside a frames shard (``parallel.sequence.constrain_frames``) every
configuration computes this rank's frames of the whole map's output: the
layers exchange and reduce over the shard (models/layers.py), and a level
whose frames do not divide over the ranks runs whole on every rank, with
the levels below it and the input pyramid there (``FrameLevels``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..ops.fir import downsample_2d, naive_downsample_2d, naive_upsample_2d, upsample_2d
from ..parallel.sequence import FrameLevels, current_frames
from ..utils import float32_precision, trunk_dtype
from . import layers
from .shared import BackboneRegistry


class NCSNppBase(nn.Module):
    """NCSN++ with the time embedding alone, or with a second (noise)
    embedding when ``snr_conditioning``.

    The configuration fields are the JAX package's ``NCSNppBase`` fields,
    with its names and defaults (``diffse_tpu/models/ncsnpp.py``):
    ``nonlinearity`` (swish, elu, relu, lrelu), ``resblock_type`` (biggan,
    ddpm), ``fir``/``fir_kernel`` (FIR or naive resampling),
    ``resamp_with_conv`` (the DDPM-style up/down layers' conv),
    ``conditional`` (the time embedding's dense layers and every block's
    ``Dense_0``), ``skip_rescale``, ``progressive`` (none, output_skip,
    residual), ``progressive_input`` (none, input_skip, residual),
    ``progressive_combine`` (sum, cat), ``init_scale``, ``fourier_scale``,
    ``embedding_type`` (fourier, positional: the JAX package's repair of the
    reference's dead positional path, dividing the output by the
    conditioning value itself) and ``dropout`` (in training, with keep masks
    from the caller: ``ScoreModel.loss_fn`` draws them from its generator).
    ``scale_by_sigma`` is taken and, as in the JAX package, the output is
    divided by the noise level whatever it says.
    """

    snr_conditioning = False

    def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 image_size: int = 256, dtype: Optional[str] = None,
                 fuse_pyramid: bool = True, dropout: float = 0.0, remat: bool = False,
                 scale_by_sigma: bool = True, nonlinearity: str = "swish",
                 resamp_with_conv: bool = True, conditional: bool = True, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), skip_rescale: bool = True,
                 resblock_type: str = "biggan", progressive: str = "output_skip",
                 progressive_input: str = "input_skip", progressive_combine: str = "sum",
                 init_scale: float = 0.0, fourier_scale: float = 16.0,
                 embedding_type: str = "fourier",
                 generator: Optional[torch.Generator] = None):
        """``dtype``: the trunk's compute dtype, None (float32) or "bf16".
        ``fuse_pyramid`` names the JAX package's
        flag; the port always runs the output pyramid's heads fused (one
        kernel each, with swish) and takes no other value. ``remat``:
        recompute each residual block's activations in the backward pass
        (``torch.utils.checkpoint``, the JAX package's ``nn.remat``) instead
        of keeping them."""
        super().__init__()
        if not fuse_pyramid:
            raise ValueError("the port runs the output pyramid's heads fused only "
                             "(fuse_pyramid=True)")
        if progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"progressive {progressive!r}: none, output_skip or residual")
        if progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"progressive_input {progressive_input!r}: none, input_skip or "
                             "residual")
        if resblock_type not in ("ddpm", "biggan"):
            raise ValueError(f"resblock type {resblock_type} unrecognized.")
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"embedding type {embedding_type} unknown.")
        self.compute_dtype = trunk_dtype(dtype)
        self.dropout = dropout
        self.remat = remat
        self.nf = nf
        self.act = layers.get_act(nonlinearity)
        self.fused = nonlinearity == "swish"
        self.conditional = conditional
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.resblock_type = resblock_type
        self.progressive, self.progressive_input = progressive, progressive_input
        self.combine_method = progressive_combine.lower()
        self.embedding_type = embedding_type
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        num_resolutions = len(self.ch_mult)
        self.all_resolutions = [image_size // (2 ** i) for i in range(num_resolutions)]
        channels = 4
        temb_dim = nf * 4 if conditional else None
        semb_dim = temb_dim if self.snr_conditioning else None
        g = generator

        def resblock(in_ch, out_ch=None, up=False, down=False):
            if resblock_type == "ddpm":
                return layers.ResnetBlockDDPMpp(
                    in_ch, out_ch, temb_dim=temb_dim, semb_dim=semb_dim, act=nonlinearity,
                    dropout=dropout, skip_rescale=skip_rescale, init_scale=init_scale,
                    generator=g)
            return layers.ResnetBlockBigGANpp(
                in_ch, out_ch, temb_dim, up=up, down=down, semb_dim=semb_dim, generator=g,
                dtype=self.compute_dtype, act=nonlinearity, dropout=dropout, fir=fir,
                fir_kernel=fir_kernel, skip_rescale=skip_rescale, init_scale=init_scale)

        def attn(ch):
            return layers.AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=init_scale,
                                      generator=g)

        def head(in_ch, out_ch, scale=init_scale):
            """GroupNorm + conv3x3, the pyramid's and the output's heads."""
            return [layers.GroupNorm(in_ch), layers.hwio_memory_(layers.ddpm_conv(
                in_ch, out_ch, 3, init_scale=scale, generator=g))]

        resample = dict(fir=fir, fir_kernel=fir_kernel, generator=g)
        embed_dim = 2 * nf if embedding_type == "fourier" else nf

        def embedding():
            if embedding_type == "fourier":
                return [layers.GaussianFourierProjection(nf, scale=fourier_scale, generator=g)]
            return []

        def embedding_denses():
            if not conditional:
                return []
            return [layers.ddpm_dense(embed_dim, nf * 4, g), layers.ddpm_dense(nf * 4, nf * 4, g)]

        # time_embed[, noise_embed], temb_dense_0/1[, semb_dense_0/1], stem conv
        snr = self.snr_conditioning
        modules = embedding() + (embedding() if snr else [])
        modules += embedding_denses() + (embedding_denses() if snr else [])
        modules.append(layers.ddpm_conv(channels, nf, 3, generator=g))
        in_ch = nf
        input_pyramid_ch = channels
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
                if resblock_type == "ddpm":
                    modules.append(layers.Downsample(in_ch, with_conv=resamp_with_conv,
                                                     **resample))
                else:
                    modules.append(resblock(in_ch, down=True))
                if progressive_input == "input_skip":
                    modules.append(layers.Combine(channels, in_ch, method=self.combine_method,
                                                  generator=g, dtype=self.compute_dtype))
                    if self.combine_method == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    modules.append(layers.Downsample(input_pyramid_ch, in_ch, with_conv=True,
                                                     **resample))
                    input_pyramid_ch = in_ch
                hs_c.append(in_ch)

        in_ch = hs_c[-1]
        modules += [resblock(in_ch), attn(in_ch), resblock(in_ch)]

        pyramid_ch = 0
        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resblock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(attn(in_ch))
            if progressive == "output_skip":
                modules += head(in_ch, channels)
            elif progressive == "residual":
                if i_level == num_resolutions - 1:
                    modules += head(in_ch, in_ch, scale=1.0)
                else:
                    modules.append(layers.Upsample(pyramid_ch, in_ch, with_conv=True,
                                                   **resample))
                pyramid_ch = in_ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    modules.append(layers.Upsample(in_ch, with_conv=resamp_with_conv,
                                                   **resample))
                else:
                    modules.append(resblock(in_ch, up=True))
        if progressive != "output_skip":
            modules += head(in_ch, channels)

        self.all_modules = nn.ModuleList(modules)
        self.output_layer = layers.ddpm_conv(channels, 2, 1, generator=g)

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

    # every configuration runs frames-parallel (``ScoreModel.enhance``'s
    # ``seq_mesh``)
    frames_parallel = True

    def _head(self, h: torch.Tensor, gn: layers.GroupNorm, conv: nn.Conv2d,
              dtype: torch.dtype, fuse: bool = True) -> torch.Tensor:
        """GroupNorm -> act -> conv3x3 computed in ``dtype``, the head's
        output as float32. With swish one fused kernel (K1) where it rounds
        as the JAX package's head does: an output_skip head (``fuse``, the
        JAX package's fused pyramid head, ``groupnorm_silu_conv3x3_pallas``
        with ``compute_dtype=dtype``: on a bf16 map in bf16; on a float32
        map in a bf16 trunk, after DDPM-style blocks, K1's float32-x mode,
        which rounds only the activation and the weights to bf16 and keeps
        the sums, bias and output float32) or a float32 one (on h cast to
        float32); otherwise the plain chain, rounding after the GroupNorm,
        the activation and the conv (flax's ``GroupNorm`` and ``Conv`` with
        ``dtype``). The bias is broadcast over the batch, as the JAX
        package's ``pyramid_head`` broadcasts it."""
        if not self.fused or not (fuse or dtype == torch.float32):
            return layers.conv(conv, layers.gn_act(gn, h, self.act, dtype), dtype).float()
        bias = conv.bias[None, :].expand(h.shape[0], conv.out_channels)
        if h.dtype == torch.float32 and dtype != torch.float32:
            out = layers.gn_silu_conv(layers.to_nhwc(h), gn, conv, bias, compute_dtype=dtype)
        else:
            out = layers.gn_silu_conv(layers.to_nhwc(h.to(dtype)), gn, conv, bias)
        return layers.from_nhwc(out).float()

    def _forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                 noise_cond: Optional[torch.Tensor],
                 keep_mask: Optional[layers.KeepMask] = None) -> torch.Tensor:
        """``noise_cond`` is read when ``snr_conditioning``; ``keep_mask``
        gives dropout's masks in training (``layers.dropout``). What the
        network computes in float32 runs on the card without TF32 in its
        cuDNN convolutions and matmuls, whatever the process-wide setting."""
        with float32_precision(x.device):
            return self._forward_trunk(x, time_cond, noise_cond, keep_mask)

    def _block(self, module: nn.Module, keep_mask, *args) -> torch.Tensor:
        """A residual block's call; with ``remat`` where autograd records, one
        that keeps only its inputs and recomputes the rest in the backward
        (with the same dropout masks)."""
        if self.remat and torch.is_grad_enabled():
            replay = _ReplayMasks(keep_mask) if keep_mask is not None else None

            def run(*inputs):
                if replay is not None:
                    replay.rewind()
                return module(*inputs, keep_mask=replay)

            return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
        return module(*args, keep_mask=keep_mask)

    def _resample_pyramid(self, x: torch.Tensor, up: bool) -> torch.Tensor:
        """The parameter-free pyramid resampling: FIR, or nearest neighbour
        / 2x2 mean."""
        if self.fir:
            return (upsample_2d if up else downsample_2d)(x, self.fir_kernel, factor=2,
                                                          frames=current_frames())
        if up:
            return naive_upsample_2d(x, factor=2)
        return naive_downsample_2d(x, factor=2, frames=current_frames())

    def _forward_trunk(self, x: torch.Tensor, time_cond: torch.Tensor,
                       noise_cond: Optional[torch.Tensor], keep_mask) -> torch.Tensor:
        modules = iter(self.all_modules)
        num_resolutions = len(self.ch_mult)
        snr = self.snr_conditioning
        act = self.act

        h = torch.stack([x[:, 0].real, x[:, 0].imag, x[:, 1].real, x[:, 1].imag], dim=1)
        h = h.contiguous(memory_format=torch.channels_last)

        if self.embedding_type == "fourier":
            temb = next(modules)(torch.log(time_cond))
            semb = next(modules)(torch.log(noise_cond)) if snr else None
        else:
            temb = layers.get_timestep_embedding(time_cond, self.nf)
            semb = layers.get_timestep_embedding(noise_cond, self.nf) if snr else None
        if self.conditional:
            temb = next(modules)(temb)
            temb = next(modules)(act(temb))
            if snr:
                semb = next(modules)(semb)
                semb = next(modules)(act(semb))
        else:
            temb = semb = None

        def block(h_in, skip=None):
            return self._block(next(modules), keep_mask, h_in, temb, semb, skip)

        # on a frames shard, which levels run split (without one, no change)
        frames = FrameLevels(h.shape[-1], num_resolutions)
        cdt = self.compute_dtype
        input_pyramid = h
        with frames.level(0):
            hs = [layers.conv(next(modules), h, cdt)]
        for i_level in range(num_resolutions):
            with frames.level(i_level):
                for _ in range(self.num_res_blocks):
                    h = block(hs[-1])
                    if self.all_resolutions[i_level] in self.attn_resolutions:
                        h = next(modules)(h)
                    hs.append(h)
            if i_level != num_resolutions - 1:
                with frames.level(i_level + 1):
                    h = frames.down(hs[-1], i_level)
                    h = next(modules)(h) if self.resblock_type == "ddpm" else block(h)
                    if self.progressive_input == "input_skip":
                        input_pyramid = self._resample_pyramid(
                            frames.down(input_pyramid, i_level), up=False)
                        h = next(modules)(input_pyramid, h)
                    elif self.progressive_input == "residual":
                        input_pyramid = layers.residual(
                            next(modules)(frames.down(input_pyramid, i_level)), h,
                            self.skip_rescale)
                        h = input_pyramid
                hs.append(h)

        with frames.level(num_resolutions - 1):
            h = hs[-1]
            h = block(h)
            h = next(modules)(h)
            h = block(h)

        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            with frames.level(i_level):
                for _ in range(self.num_res_blocks + 1):
                    h = block(h, hs.pop())
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    h = next(modules)(h)
                if self.progressive == "output_skip":
                    head = self._head(h, next(modules), next(modules), cdt)
                    if pyramid is None:
                        pyramid = head
                    else:
                        pyramid = frames.up(lambda p: self._resample_pyramid(p, up=True),
                                            pyramid, i_level + 1) + head
                elif self.progressive == "residual":
                    if pyramid is None:
                        pyramid = self._head(h, next(modules), next(modules), cdt, fuse=False)
                    else:
                        pyramid = layers.residual(
                            frames.up(next(modules), pyramid, i_level + 1), h,
                            self.skip_rescale)
                        h = pyramid
            if i_level != 0:
                h = frames.up(next(modules) if self.resblock_type == "ddpm" else block, h,
                              i_level)

        if self.progressive == "output_skip":
            h = pyramid
        else:  # the JAX package's final head has no dtype: float32
            h = self._head(h, next(modules), next(modules), torch.float32)

        used_sigmas = noise_cond if snr else time_cond
        h = h / used_sigmas[:, None, None, None]
        h = self.output_layer(h)
        return torch.complex(h[:, 0], h[:, 1])[:, None]


class _ReplayMasks:
    """Keep masks drawn once and given again: a checkpointed block's
    recompute in the backward replays the masks its forward drew."""

    def __init__(self, keep_mask):
        self.keep_mask, self.masks, self.i = keep_mask, [], 0

    def rewind(self) -> None:
        self.i = 0

    def __call__(self, shape, keep, device):
        if self.i == len(self.masks):
            self.masks.append(self.keep_mask(shape, keep, device))
        mask = self.masks[self.i]
        self.i += 1
        return mask


@BackboneRegistry.register("ncsnpp")
class NCSNpp(NCSNppBase):
    """NCSN++: ``(x complex [B, 2, F, T], t [B]) -> complex score [B, 1, F, T]``."""

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                keep_mask: Optional[layers.KeepMask] = None) -> torch.Tensor:
        """Args:
            x: complex ``[B, 2, F, T]``: channel 0 the diffusion state, channel 1
               the conditioning spectrogram.
            time_cond: ``[B]`` diffusion time.
            keep_mask: dropout's masks in training (``layers.dropout``).
        """
        return self._forward(x, time_cond, None, keep_mask)


@BackboneRegistry.register("ncsnpp_snr")
class NCSNppSNR(NCSNppBase):
    """SNR-conditioned NCSN++: ``(x, t, s) -> complex score``, the output
    divided by the noise conditioning ``s``."""

    snr_conditioning = True

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                noise_cond: torch.Tensor,
                keep_mask: Optional[layers.KeepMask] = None) -> torch.Tensor:
        """Args:
            x: complex ``[B, 2, F, T]``, as for ``NCSNpp``.
            time_cond: ``[B]`` diffusion time.
            noise_cond: ``[B]`` noise level (SNR conditioning).
            keep_mask: dropout's masks in training (``layers.dropout``).
        """
        return self._forward(x, time_cond, noise_cond, keep_mask)
