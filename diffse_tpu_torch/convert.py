"""Weight bridge from the JAX package's flax parameters to the port.

``state_dict_from_jax`` walks the NCSN++ construction (``ncsnpp_correspondence``)
and returns a state_dict that ``NCSNpp.load_state_dict(..., strict=True)`` (or
``NCSNppSNR``'s) takes; ``snrnet_state_dict_from_jax`` does the same for
``SNRNet``. The walk is the port's own copy of the one in the JAX side's
converter (``tools/convert_torch_checkpoint.py``), numpy only, so that the
port loads nothing outside its package.

For ``ncsnpp`` the ``all_modules`` indices are those of the reference's
torch NCSN++, so its published checkpoints load too. The SNR-conditioned
backbone (``snr_conditioning=True``) adds, in the flax call order,
``noise_embed`` right after ``time_embed``, ``semb_dense_0``/``semb_dense_1``
right after the time embedding's two dense layers, and a ``Dense_1`` in every
BigGAN block. These positions are the port's own choice: no torch layout of
``ncsnpp_snr`` is in the repo, so published ``ncsnpp_snr`` torch checkpoints
are not covered.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Construction walk: (torch prefix, flax path, kind) correspondences, where
# kind in {conv, linear, groupnorm, nin, gfp} decides the tensor moves.
# --------------------------------------------------------------------------


def _resblock_entries(torch_prefix: str, flax_path: Tuple[str, ...], in_ch: int,
                      out_ch: int, up_down: bool,
                      snr_conditioning: bool = False) -> List[tuple]:
    """ResnetBlockBigGANpp params (reference layerspp.py:214-243)."""
    e = [
        (f"{torch_prefix}.GroupNorm_0", flax_path + ("GroupNorm_0",), "groupnorm"),
        (f"{torch_prefix}.Conv_0", flax_path + ("Conv_0",), "conv"),
        (f"{torch_prefix}.Dense_0", flax_path + ("Dense_0",), "linear"),
    ]
    if snr_conditioning:
        e.append((f"{torch_prefix}.Dense_1", flax_path + ("Dense_1",), "linear"))
    e += [
        (f"{torch_prefix}.GroupNorm_1", flax_path + ("GroupNorm_1",), "groupnorm"),
        (f"{torch_prefix}.Conv_1", flax_path + ("Conv_1",), "conv"),
    ]
    if in_ch != out_ch or up_down:
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


def ncsnpp_correspondence(
    nf: int = 128,
    ch_mult=(1, 1, 2, 2, 2, 2, 2),
    num_res_blocks: int = 2,
    attn_resolutions=(16,),
    image_size: int = 256,
    conditional: bool = True,
    snr_conditioning: bool = False,
) -> List[tuple]:
    """Walk the NCSN++ construction (reference ncsnpp.py:99-245) and emit the
    mapping. flax paths are relative to the params root, torch prefixes to
    the backbone module."""
    num_resolutions = len(ch_mult)
    all_res = [image_size // (2**i) for i in range(num_resolutions)]
    entries: List[tuple] = []
    m = 0  # torch all_modules index

    def t(idx):
        return f"all_modules.{idx}"

    counters = {"res": 0, "attn": 0, "combine": 0, "conv": 0}  # flax auto-names

    def flax_res():
        p = (f"ResnetBlockBigGANpp_{counters['res']}",)
        counters["res"] += 1
        return p

    def flax_attn():
        p = (f"AttnBlockpp_{counters['attn']}",)
        counters["attn"] += 1
        return p

    def flax_conv():
        p = (f"Conv_{counters['conv']}",)
        counters["conv"] += 1
        return p

    def resblock(in_ch, out_ch, up_down):
        nonlocal m
        entries.extend(_resblock_entries(t(m), flax_res(), in_ch, out_ch, up_down,
                                         snr_conditioning))
        m += 1

    # time (and noise) embeddings
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
    entries.append((t(m), flax_conv(), "conv")); m += 1

    in_ch = nf
    hs_c = [nf]
    for i_level in range(num_resolutions):
        for _ in range(num_res_blocks):
            out_ch = nf * ch_mult[i_level]
            resblock(in_ch, out_ch, False)
            in_ch = out_ch
            if all_res[i_level] in attn_resolutions:
                entries.extend(_attn_entries(t(m), flax_attn())); m += 1
            hs_c.append(in_ch)
        if i_level != num_resolutions - 1:
            resblock(in_ch, in_ch, True)
            # Combine (input_skip): 1x1 conv, sum method keeps channels
            entries.append((f"{t(m)}.Conv_0",
                            (f"Combine_{counters['combine']}", "Conv_0"), "conv"))
            counters["combine"] += 1
            m += 1
            hs_c.append(in_ch)

    # bottleneck
    resblock(in_ch, in_ch, False)
    entries.extend(_attn_entries(t(m), flax_attn())); m += 1
    resblock(in_ch, in_ch, False)

    # up path (progressive == output_skip)
    gn_counter = 0
    for i_level in reversed(range(num_resolutions)):
        for _ in range(num_res_blocks + 1):
            out_ch = nf * ch_mult[i_level]
            resblock(in_ch + hs_c.pop(), out_ch, False)
            in_ch = out_ch
        if all_res[i_level] in attn_resolutions:
            entries.extend(_attn_entries(t(m), flax_attn())); m += 1
        # output_skip pyramid: GroupNorm + conv3x3(channels)
        entries.append((t(m), (f"GroupNorm_{gn_counter}",), "groupnorm"))
        gn_counter += 1
        m += 1
        entries.append((t(m), flax_conv(), "conv")); m += 1
        if i_level != 0:
            resblock(in_ch, in_ch, True)

    entries.append(("output_layer", ("output_layer",), "conv"))
    return entries


# ------------------------------------------------------------- tensor moves


def _flax_to_torch_tensors(kind: str, flax_params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """flax HWIO conv / [in, out] dense / scale-bias norm -> torch OIHW /
    [out, in] / weight-bias; NIN and GFP arrays are identical."""
    if kind in ("conv", "linear"):
        axes = (3, 2, 0, 1) if kind == "conv" else (1, 0)
        out = {"weight": np.transpose(flax_params["kernel"], axes)}
        if "bias" in flax_params:
            out["bias"] = flax_params["bias"]
        return out
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
        arch: keywords of ``ncsnpp_correspondence`` (nf, ch_mult,
            num_res_blocks, attn_resolutions, image_size, snr_conditioning).
    """
    corr = ncsnpp_correspondence(**arch)
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
