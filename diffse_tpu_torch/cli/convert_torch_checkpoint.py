"""Import a reference PyTorch Lightning checkpoint as a port checkpoint (the
port's counterpart of tools/convert_torch_checkpoint.py, with its flags).

The published reference checkpoints (the paper's M4-M6 and
``snr_estimator.ckpt``) keep the network as ``dnn.<name>`` entries of a flat
state_dict. The port's ``NCSNpp`` is built with the reference's module names
(``all_modules.<idx>``, ``output_layer``) and its ``SNRNet`` with the
reference SNRNet's (``conv5x5_1``, ``conv3x3_1``, ``convt_1..4``, ``blstm``,
``fc``), so each state_dict loads as it is, its torch layouts unchanged, with
the ``dnn.`` prefix stripped; a key the model lacks, or one of the model's
that the checkpoint lacks, is an error that names it. The LSTM keeps both of
torch's biases.

With ``--ema`` the checkpoint's ``ema.shadow_params`` become the EMA: for
the score model they are ordered like the trainable parameters, the
state_dict's order without the Gaussian-Fourier ``W``s (requires_grad=False
in the reference, which its EMA skips; they are found from
``ncsnpp_correspondence``'s ``gfp`` entries and keep their live value), for
the SNR estimator like the whole state_dict. The hyperparameters come from
the checkpoint's ``hyper_parameters`` as the JAX tool reads them: the
``ncsnpp`` backbone with ``--arch`` (the JAX tool's walk: the plain NCSN++
layout, the production 65M configuration by default), and the SDE's keywords
from ``hyper_parameters`` over ``SDE_DEFAULTS``. Adam's state starts fresh.
The result is a ``CheckpointManager`` directory (``step_0/state.pt`` and
``hparams.json``) that ``load_score_model`` / ``load_snr_model`` restore on
any device. The conversion itself is host I/O: it builds the model on the
CPU and reads and writes files only.

Usage:
    python -m diffse_tpu_torch.cli.convert_torch_checkpoint --torch_ckpt M6.ckpt \\
        --out_dir converted_m6 --ema [--arch nf=128 ...] [--kind score|snrnet]
"""

from __future__ import annotations

import argparse
import ast
from typing import Dict, List

import torch

# Per-SDE keywords: these defaults, then the entries of the checkpoint's
# hyper_parameters of the same names (the reference saves its SDE's
# arguments there, sgmse/model.py:93). The port's copy of the JAX tool's
# _SDE_DEFAULTS.
SDE_DEFAULTS = {
    "bbed": dict(k=2.6, theta=0.52, T_sampling=0.999),
    "bbve": dict(sigma_min=0.05, sigma_max=2.6, theta=0.52, T_sampling=0.999),
    "ouve": dict(theta=1.5, sigma_min=0.05, sigma_max=0.5),
    "proposed_1": dict(T_sampling=0.99, sigma_min=1.0, sigma_max=1.0, theta=0.53),
}
# the --arch keywords the JAX tool's walk takes (the plain ncsnpp layout)
ARCH_KEYS = ("nf", "ch_mult", "num_res_blocks", "attn_resolutions", "image_size",
             "conditional")
TORCH_ROOT = "dnn."


def parse_arch(pairs: List[str]) -> dict:
    """``KEY=VALUE`` pairs -> backbone keywords, each value literal-eval'd
    (a string where it is not a literal). Keys outside ``ARCH_KEYS``, and
    ``conditional`` other than True, are refused: the JAX tool walks the
    plain conditional ``ncsnpp`` layout only."""
    arch = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            arch[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            arch[k] = v
    unknown = sorted(set(arch) - set(ARCH_KEYS))
    if unknown:
        raise ValueError(f"--arch {unknown}: the reference checkpoint layout covers the plain "
                         f"ncsnpp backbone's {list(ARCH_KEYS)} only")
    if arch.get("conditional", True) is not True:
        raise ValueError("--arch conditional=False: the reference checkpoint layout covers the "
                         "conditional ncsnpp (its blocks' Dense_0) only")
    return arch


def strip_root(state_dict: Dict[str, torch.Tensor], expected) -> Dict[str, torch.Tensor]:
    """The checkpoint's ``dnn.``-prefixed entries as the model's state_dict,
    after checking that its keys are exactly ``expected`` (the model's): a
    missing or an unexpected key raises ``KeyError`` naming it."""
    sd = {k[len(TORCH_ROOT):]: v for k, v in state_dict.items() if k.startswith(TORCH_ROOT)}
    expected = list(expected)
    known = set(expected)
    missing = [k for k in expected if k not in sd]
    unexpected = [k for k in state_dict
                  if not k.startswith(TORCH_ROOT) or k[len(TORCH_ROOT):] not in known]
    if missing or unexpected:
        def names(keys):
            return ", ".join(keys[:20]) + (f" and {len(keys) - 20} more" if len(keys) > 20 else "")
        raise KeyError(f"the checkpoint does not match the model (wrong --arch or --kind?): "
                       f"missing {len(missing)} key(s) [{names(missing)}], unexpected "
                       f"{len(unexpected)} [{names(unexpected)}]")
    return sd


def set_ema(state, ema: Dict[str, torch.Tensor]) -> None:
    """Copy ``ema`` (by parameter name) into ``state``'s EMA."""
    with torch.no_grad():
        for name, e in zip(state.names, state.ema):
            e.copy_(ema[name])


def import_score(ckpt: dict, arch: dict, use_ema: bool):
    """A reference score checkpoint -> ``(ScoreModel, TrainState)`` on the CPU."""
    from ..convert import ncsnpp_correspondence
    from ..models.score_model import ScoreModel, ScoreModelConfig
    from ..train.state import TrainState

    hp = ckpt.get("hyper_parameters", {})
    cfg = ScoreModelConfig(
        backbone="ncsnpp",
        sde=hp.get("sde", "bbed"),
        model_type=hp.get("model_type", "sebridge_v3"),
        snr_conditioned=hp.get("snr_conditioned", "true"),
        fixed_snr=float(hp.get("fixed_snr", 1.0)),
        sigma_max=float(hp.get("sigma_max", 1.0)),
    )
    sde_kwargs = {k: float(hp[k]) if k in hp else v
                  for k, v in SDE_DEFAULTS.get(cfg.sde, {}).items()}
    model = ScoreModel(cfg, backbone_kwargs=arch, sde_kwargs=sde_kwargs, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    state_dict = ckpt["state_dict"]
    model.backbone.load_state_dict(strip_root(state_dict, model.backbone.state_dict()))
    state = TrainState(model.backbone, lr=cfg.lr, ema_decay=cfg.ema_decay)
    if use_ema and "ema" in ckpt:
        # the reference EMA's shadow list follows [p for p in parameters() if
        # p.requires_grad]: the state_dict's order without the GFP Ws, which
        # a loaded state_dict no longer marks, so the walk names them
        shadow = list(ckpt["ema"]["shadow_params"])
        gfp_w = {f"{TORCH_ROOT}{tp}.W" for tp, _, kind in ncsnpp_correspondence(**arch)
                 if kind == "gfp"}
        param_keys = [k for k in state_dict if k not in gfp_w]
        if len(param_keys) != len(shadow):
            raise ValueError(
                f"EMA shadow count {len(shadow)} != trainable param count "
                f"{len(param_keys)} — wrong --arch for this checkpoint?")
        set_ema(state, {k[len(TORCH_ROOT):]: v for k, v in zip(param_keys, shadow)})
    return model, state


def import_snrnet(ckpt: dict, use_ema: bool):
    """A reference SNR-estimator checkpoint -> ``(SNRModel, TrainState)`` on
    the CPU."""
    from ..models.snr_model import SNRModel, SNRModelConfig
    from ..models.snrnet import SNRNet
    from ..train.state import TrainState

    hp = ckpt.get("hyper_parameters", {})
    with torch.random.fork_rng(devices=[]):  # SNRNet's own init draws from the global RNG
        net = SNRNet()
    state_dict = ckpt["state_dict"]
    net.load_state_dict(strip_root(state_dict, net.state_dict()))
    model = SNRModel(SNRModelConfig(transform_type=str(hp.get("transform_type", "none"))),
                     device="cpu", dnn=net)
    state = TrainState(model.dnn, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
    if use_ema and "ema" in ckpt:
        # SNRNet has no frozen parameter: the shadow list is the whole
        # state_dict in order
        shadow = list(ckpt["ema"]["shadow_params"])
        if len(shadow) != len(state_dict):
            raise ValueError(f"EMA shadow count {len(shadow)} != param count "
                             f"{len(state_dict)}")
        set_ema(state, {k[len(TORCH_ROOT):]: v for k, v in zip(state_dict, shadow)})
    return model, state


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--torch_ckpt", type=str, required=True,
                        help="Reference .ckpt (Lightning) file")
    parser.add_argument("--out_dir", type=str, required=True,
                        help="Output CheckpointManager directory")
    parser.add_argument("--ema", action="store_true", help="Also import the EMA shadow params")
    parser.add_argument("--arch", action="append", default=[], metavar="KEY=VALUE",
                        help="Backbone architecture overrides, e.g. --arch nf=8 "
                             "--arch 'ch_mult=(1, 2)' (default: the production 65M NCSN++)")
    parser.add_argument("--kind", choices=["score", "snrnet"], default="score",
                        help="Checkpoint family: the score ScoreModel (default) or the "
                             "SNR-estimator SNRModel (the reference's snr_estimator.ckpt)")
    args = parser.parse_args(argv)
    try:
        arch = parse_arch(args.arch)
    except ValueError as e:
        parser.error(str(e))

    from ..train.checkpoints import CheckpointManager

    ckpt = torch.load(args.torch_ckpt, map_location="cpu")
    if args.kind == "snrnet":
        model, state = import_snrnet(ckpt, args.ema)
        what = "SNR-estimator checkpoint"
    else:
        model, state = import_score(ckpt, arch, args.ema)
        what = "checkpoint"
    CheckpointManager(args.out_dir, hparams=model.hparams).save(0, state, {})
    print(f"converted {what} written to {args.out_dir}")
    return args.out_dir


if __name__ == "__main__":
    main()
