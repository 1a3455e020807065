"""Weight bridge from the JAX package's flax parameters to the port.

``state_dict_from_jax`` walks the NCSN++ construction (``ncsnpp_correspondence``)
and returns a state_dict that ``NCSNpp.load_state_dict(..., strict=True)`` (or
``NCSNppSNR``'s) takes; ``snrnet_state_dict_from_jax`` does the same for
``SNRNet``. The walk is the port's own copy of the one in the JAX side's
converter (``tools/convert_torch_checkpoint.py``), numpy only, so that the
port loads nothing outside its package.

For ``ncsnpp`` the ``all_modules`` indices are those of the reference's
torch NCSN++, so its published checkpoints load as they are
(``cli.convert_torch_checkpoint`` imports them, and reads the GFP ``W``
keys, which the reference's EMA skips, from this walk). The SNR-conditioned
backbone (``snr_conditioning=True``) adds, in the flax call order,
``noise_embed`` right after ``time_embed``, ``semb_dense_0``/``semb_dense_1``
right after the time embedding's two dense layers, and a ``Dense_1`` in every
BigGAN block. These positions are the port's own choice: no torch layout of
``ncsnpp_snr`` is in the repo, so published ``ncsnpp_snr`` torch checkpoints
are not covered.
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Construction walk: (torch prefix, flax path, kind) correspondences, where
# kind in {conv, linear, groupnorm, nin, gfp} decides the tensor moves.
# --------------------------------------------------------------------------


def _resblock_entries(torch_prefix: str, flax_path: Tuple[str, ...], in_ch: int,
                      out_ch: int, up_down: bool,
                      snr_conditioning: bool = False, conditional: bool = True,
                      resblock_type: str = "biggan") -> List[tuple]:
    """A residual block's params: ResnetBlockBigGANpp (reference
    layerspp.py:214-243) or ResnetBlockDDPMpp (layerspp.py:168-211, its
    channel change through ``NIN_0``)."""
    e = [
        (f"{torch_prefix}.GroupNorm_0", flax_path + ("GroupNorm_0",), "groupnorm"),
        (f"{torch_prefix}.Conv_0", flax_path + ("Conv_0",), "conv"),
    ]
    if conditional:
        e.append((f"{torch_prefix}.Dense_0", flax_path + ("Dense_0",), "linear"))
        if snr_conditioning:
            e.append((f"{torch_prefix}.Dense_1", flax_path + ("Dense_1",), "linear"))
    e += [
        (f"{torch_prefix}.GroupNorm_1", flax_path + ("GroupNorm_1",), "groupnorm"),
        (f"{torch_prefix}.Conv_1", flax_path + ("Conv_1",), "conv"),
    ]
    if resblock_type == "ddpm":
        if in_ch != out_ch:
            e.append((f"{torch_prefix}.NIN_0", flax_path + ("NIN_0",), "nin"))
    elif in_ch != out_ch or up_down:
        e.append((f"{torch_prefix}.Conv_2", flax_path + ("Conv_2",), "conv"))
    return e


def _attn_entries(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[tuple]:
    return [
        (f"{torch_prefix}.GroupNorm_0", flax_path + ("GroupNorm_0",), "groupnorm"),
        (f"{torch_prefix}.NIN_0", flax_path + ("NIN_0",), "nin"),
        (f"{torch_prefix}.NIN_1", flax_path + ("NIN_1",), "nin"),
        (f"{torch_prefix}.NIN_2", flax_path + ("NIN_2",), "nin"),
        (f"{torch_prefix}.NIN_3", flax_path + ("NIN_3",), "nin"),
    ]


def _resample_entries(torch_prefix: str, flax_path: Tuple[str, ...], with_conv: bool,
                      fir: bool) -> List[tuple]:
    """An Upsample/Downsample layer's conv: ``Conv_0`` (naive resampling) or
    the FIR-fused ``Conv2d_0``; none without ``with_conv``."""
    if not with_conv:
        return []
    if fir:
        return [(f"{torch_prefix}.Conv2d_0", flax_path + ("Conv2d_0",), "firconv")]
    return [(f"{torch_prefix}.Conv_0", flax_path + ("Conv_0",), "conv")]


# NCSN++ fields that change no parameter's name or shape
NCSNPP_VALUE_FIELDS = ("dtype", "dropout", "remat", "scale_by_sigma", "nonlinearity",
                       "fir_kernel", "skip_rescale", "init_scale", "fourier_scale",
                       "fuse_pyramid", "use_pallas_groupnorm", "pallas_max_hw",
                       "matmul_conv_max_hw")


def ncsnpp_correspondence(
    nf: int = 128,
    ch_mult=(1, 1, 2, 2, 2, 2, 2),
    num_res_blocks: int = 2,
    attn_resolutions=(16,),
    image_size: int = 256,
    conditional: bool = True,
    snr_conditioning: bool = False,
    resblock_type: str = "biggan",
    progressive: str = "output_skip",
    progressive_input: str = "input_skip",
    progressive_combine: str = "sum",
    embedding_type: str = "fourier",
    resamp_with_conv: bool = True,
    fir: bool = True,
) -> List[tuple]:
    """Walk the NCSN++ construction (reference ncsnpp.py:99-245) and emit the
    mapping. flax paths are relative to the params root, torch prefixes to
    the backbone module. The flax names follow the JAX package's call order
    (``diffse_tpu/models/ncsnpp.py``): one auto-name counter per module
    class, which the parameter-free resampling layers (the pyramids' FIR or
    naive resampling, a DDPM-style layer without its conv) advance too."""
    num_resolutions = len(ch_mult)
    all_res = [image_size // (2**i) for i in range(num_resolutions)]
    combine_method = progressive_combine.lower()
    entries: List[tuple] = []
    m = 0  # torch all_modules index
    counters: Dict[str, int] = {}  # flax auto-name cursor per module class

    def t(idx):
        return f"all_modules.{idx}"

    def flax_name(cls: str) -> Tuple[str]:
        k = counters.get(cls, 0)
        counters[cls] = k + 1
        return (f"{cls}_{k}",)

    block_cls = "ResnetBlockDDPMpp" if resblock_type == "ddpm" else "ResnetBlockBigGANpp"

    def resblock(in_ch, out_ch, up_down):
        nonlocal m
        entries.extend(_resblock_entries(t(m), flax_name(block_cls), in_ch, out_ch, up_down,
                                         snr_conditioning, conditional, resblock_type))
        m += 1

    def attn():
        nonlocal m
        entries.extend(_attn_entries(t(m), flax_name("AttnBlockpp")))
        m += 1

    def resample(cls, with_conv, in_all_modules=True):
        """A Downsample/Upsample call: an all_modules entry where the
        reference keeps one (the trunk's DDPM-style layers, the residual
        pyramids), the flax counter in any case."""
        nonlocal m
        path = flax_name(cls)
        if in_all_modules:
            entries.extend(_resample_entries(t(m), path, with_conv, fir))
            m += 1

    def head():
        """GroupNorm + conv3x3 (pyramid or output head)."""
        nonlocal m
        entries.append((t(m), flax_name("GroupNorm"), "groupnorm")); m += 1
        entries.append((t(m), flax_name("Conv"), "conv")); m += 1

    # time (and noise) embeddings
    if embedding_type == "fourier":
        entries.append((t(m), ("time_embed",), "gfp")); m += 1
        if snr_conditioning:
            entries.append((t(m), ("noise_embed",), "gfp")); m += 1
    if conditional:
        entries.append((t(m), ("temb_dense_0",), "linear")); m += 1
        entries.append((t(m), ("temb_dense_1",), "linear")); m += 1
        if snr_conditioning:
            entries.append((t(m), ("semb_dense_0",), "linear")); m += 1
            entries.append((t(m), ("semb_dense_1",), "linear")); m += 1

    # input conv 4 -> nf
    entries.append((t(m), flax_name("Conv"), "conv")); m += 1

    in_ch = nf
    hs_c = [nf]
    for i_level in range(num_resolutions):
        for _ in range(num_res_blocks):
            out_ch = nf * ch_mult[i_level]
            resblock(in_ch, out_ch, False)
            in_ch = out_ch
            if all_res[i_level] in attn_resolutions:
                attn()
            hs_c.append(in_ch)
        if i_level != num_resolutions - 1:
            if resblock_type == "ddpm":
                resample("Downsample", resamp_with_conv)
            else:
                resblock(in_ch, in_ch, True)
            if progressive_input == "input_skip":
                resample("Downsample", False, in_all_modules=False)
                entries.append((f"{t(m)}.Conv_0", flax_name("Combine") + ("Conv_0",), "conv"))
                m += 1
                if combine_method == "cat":
                    in_ch *= 2
            elif progressive_input == "residual":
                resample("Downsample", True)
            hs_c.append(in_ch)

    # bottleneck
    resblock(in_ch, in_ch, False)
    attn()
    resblock(in_ch, in_ch, False)

    for i_level in reversed(range(num_resolutions)):
        for _ in range(num_res_blocks + 1):
            out_ch = nf * ch_mult[i_level]
            resblock(in_ch + hs_c.pop(), out_ch, False)
            in_ch = out_ch
        if all_res[i_level] in attn_resolutions:
            attn()
        if progressive == "output_skip":
            if i_level != num_resolutions - 1:
                resample("Upsample", False, in_all_modules=False)
            head()
        elif progressive == "residual":
            if i_level == num_resolutions - 1:
                head()
            else:
                resample("Upsample", True)
        if i_level != 0:
            if resblock_type == "ddpm":
                resample("Upsample", resamp_with_conv)
            else:
                resblock(in_ch, in_ch, True)

    if progressive != "output_skip":
        head()
    entries.append(("output_layer", ("output_layer",), "conv"))
    return entries


# ------------------------------------------------------------- tensor moves


def _flax_to_torch_tensors(kind: str, flax_params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """flax HWIO conv (``kernel``, or a FirConv2d's ``weight``) / [in, out]
    dense / scale-bias norm -> torch OIHW / [out, in] / weight-bias; NIN and
    GFP arrays are identical."""
    if kind in ("conv", "linear"):
        axes = (3, 2, 0, 1) if kind == "conv" else (1, 0)
        out = {"weight": np.transpose(flax_params["kernel"], axes)}
        if "bias" in flax_params:
            out["bias"] = flax_params["bias"]
        return out
    if kind == "firconv":
        return {"weight": np.transpose(flax_params["weight"], (3, 2, 0, 1)),
                "bias": flax_params["bias"]}
    if kind == "groupnorm":
        return {"weight": flax_params["scale"], "bias": flax_params["bias"]}
    if kind in ("nin", "gfp"):
        return dict(flax_params)
    raise ValueError(kind)


def _get_path(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def convert_flax_to_state_dict(params: dict, correspondence: List[tuple],
                               torch_root: str = "dnn.") -> Dict[str, np.ndarray]:
    """Map a flax params tree onto the reference's state_dict keys."""
    state_dict: Dict[str, np.ndarray] = {}
    for torch_prefix, flax_path, kind in correspondence:
        flax_params = {
            k: np.asarray(v) for k, v in _get_path(params, flax_path).items()
            if not isinstance(v, dict)
        }
        for name, value in _flax_to_torch_tensors(kind, flax_params).items():
            state_dict[f"{torch_root}{torch_prefix}.{name}"] = value
    return state_dict


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def state_dict_from_jax(params: dict, **arch) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's NCSN++ state_dict.

    Args:
        params: the ``variables["params"]`` tree of ``diffse_tpu``'s NCSNpp
            (or NCSNppSNR, with ``snr_conditioning=True``).
        arch: the backbone's keywords: those of ``ncsnpp_correspondence``
            (nf, ch_mult, ..., snr_conditioning); the fields that change no
            parameter (``NCSNPP_VALUE_FIELDS``) are taken and ignored.
    """
    unknown = (set(arch) - set(NCSNPP_VALUE_FIELDS)
               - set(inspect.signature(ncsnpp_correspondence).parameters))
    if unknown:
        raise TypeError(f"state_dict_from_jax: unknown NCSN++ keywords {sorted(unknown)}")
    corr = ncsnpp_correspondence(**{k: v for k, v in arch.items()
                                    if k not in NCSNPP_VALUE_FIELDS})
    return _to_torch(convert_flax_to_state_dict(params, corr, torch_root=""))


# ----------------------------------------------------------------- SNRNet


def snrnet_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Flax SNRNet params -> the port's ``SNRNet`` state_dict, in the
    reference's torch names (``conv5x5_1, conv3x3_1, convt_1..4, blstm, fc``),
    so the published ``snr_estimator.ckpt`` layout loads as well.

    The flax convs ``convt_{1,2,4,8}`` (named by time-kernel width) become
    ``convt_1..4``. Each flax ``OptimizedLSTMCell`` (``_0`` forward, ``_1``
    backward) has input denses ``ii, if, ig, io`` without bias and hidden
    denses ``hi, hf, hg, ho`` with one; torch packs the gates ``i, f, g, o``
    and has two biases, so the flax bias goes to ``bias_ih`` and ``bias_hh``
    is zero."""
    sd: Dict[str, np.ndarray] = {}

    def conv(name_f, name_t):
        sd[f"{name_t}.weight"] = np.transpose(np.asarray(params[name_f]["kernel"]), (3, 2, 0, 1))
        sd[f"{name_t}.bias"] = np.asarray(params[name_f]["bias"])

    conv("conv5x5_1", "conv5x5_1")
    conv("conv3x3_1", "conv3x3_1")
    for idx, width in zip(range(1, 5), (1, 2, 4, 8)):
        conv(f"convt_{width}", f"convt_{idx}")

    def lstm(flax_name, direction_suffix):
        cell = params[flax_name]
        w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in "ifgo"], axis=0)
        w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in "ifgo"], axis=0)
        b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"])
        sd[f"blstm.weight_ih_l0{direction_suffix}"] = w_ih
        sd[f"blstm.weight_hh_l0{direction_suffix}"] = w_hh
        sd[f"blstm.bias_ih_l0{direction_suffix}"] = b
        sd[f"blstm.bias_hh_l0{direction_suffix}"] = np.zeros_like(b)

    lstm("OptimizedLSTMCell_0", "")
    lstm("OptimizedLSTMCell_1", "_reverse")

    sd["fc.weight"] = np.asarray(params["fc"]["kernel"]).T
    sd["fc.bias"] = np.asarray(params["fc"]["bias"])
    return _to_torch(sd)


# ------------------------------------------------- modules named as in flax


def _flax_leaf_to_torch(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flax leaf by name -> the port's name and layout: a conv ``kernel``
    (HWIO) -> ``weight`` OIHW, a dense ``kernel`` [in, out] -> ``weight``
    [out, in], a norm's ``scale`` and an embedding table -> ``weight``, a
    transposed conv's
    ``w_re``/``w_im`` (HWIO) -> ``[Cin, Cout, kh, kw]``, the running
    statistics ``mean``/``var`` -> ``running_mean``/``running_var``; other
    leaves as they are."""
    if name == "kernel":
        return "weight", np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value.T
    if name in ("scale", "embedding"):
        return "weight", value
    if name in ("w_re", "w_im"):
        return name, np.transpose(value, (2, 3, 0, 1))
    if name in ("mean", "var"):
        return f"running_{name}", value
    return name, value


def flax_tree_state_dict(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """A flax variable tree whose module paths are the port's module names
    (DCUNet, the normalization and legacy layers: their correspondence for
    the tests) -> its state_dict entries, by ``_flax_leaf_to_torch``."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flax_tree_state_dict(value, prefix + (key,)))
        else:
            name, array = _flax_leaf_to_torch(key, np.asarray(value))
            out[".".join(prefix + (name,))] = array
    return out


def dcunet_state_dict_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's DCUNet variables (``params`` and, with "bN",
    ``batch_stats``; numpy leaves) -> the port's ``DCUNet`` state_dict: the
    module paths are the same, the layouts torch's."""
    sd = flax_tree_state_dict(variables["params"])
    sd.update(flax_tree_state_dict(variables.get("batch_stats", {})))
    return _to_torch(sd)
