"""Score-model training CLI (port of diffse_tpu/cli/train.py).

The same three-tier argparse: a base parser reads --backbone/--sde/
--modeltype/--snr_conditioned/--fixed_snr first; the chosen backbone and SDE
then add their own flags; the grouped arguments go to the constructors. Flag
names, defaults and the experiment's name are the JAX package's. The port
adds ``--device`` (the card unless "cpu" is given).

Each validation scores ``--num_eval_files`` validation files (PESQ,
SI-SDR, ESTOI on the EMA weights; 0 turns it off) in batches of
``--eval_batch_size``; ``--snr_ckpt`` gives an SNR-conditioned model the
SNR estimator they need.

Several ranks: under ``torchrun`` (or any launcher that sets ``MASTER_ADDR``,
``RANK`` and ``WORLD_SIZE``) every rank joins the process group (NCCL on the
cards, gloo with ``--device cpu``) and takes a card of its own (``LOCAL_RANK``
modulo the cards present), and training is data-parallel over the ranks;
``--tp_size K`` makes it a ``(ranks / K, K)`` data x model mesh with the
state sharded over the model axis; ``--no_mesh`` trains on one rank and is a
parser error under several. ``--chain_steps`` runs that many updates per
call of the step.

Usage (the paper's configuration):
    python -m diffse_tpu_torch.cli.train --modeltype sebridge_v3 \
        --snr_conditioned true --fixed_snr 0.17783 --transform_type exponent \
        --sigma-max 1.0 --base_dir /data/VBD_SNR-5 --snr_ckpt runs/snr_est
    torchrun --nproc_per_node 4 -m diffse_tpu_torch.cli.train ... --tp_size 2
"""

from __future__ import annotations

import argparse
import os
from argparse import ArgumentParser

import torch


def get_argparse_groups(parser, args):
    groups = {}
    for group in parser._action_groups:
        group_dict = {a.dest: getattr(args, a.dest, None) for a in group._group_actions}
        groups[group.title] = argparse.Namespace(**group_dict)
    return groups


def build_parsers():
    from ..models.shared import BackboneRegistry
    from ..sde import SDERegistry

    base_parser = ArgumentParser(add_help=False)
    parser = ArgumentParser(description=__doc__)
    for parser_ in (base_parser, parser):
        parser_.add_argument("--backbone", type=str,
                             choices=BackboneRegistry.get_all_names(), default="ncsnpp")
        parser_.add_argument("--sde", type=str,
                             choices=SDERegistry.get_all_names(), default="ouve")
        parser_.add_argument("--nolog", action="store_true",
                             help="Turn off logging (for development purposes)")
        parser_.add_argument("--modeltype", type=str,
                             choices=["bbed", "sebridge", "sebridge_v2", "sebridge_v3"],
                             default="bbed")
        parser_.add_argument("--snr_conditioned", type=str,
                             choices=["false", "true", "fixed"], default="false")
        parser_.add_argument("--fixed_snr", type=float, default=1.0)
    return base_parser, parser


def add_score_model_args(group):
    group.add_argument("--lr", type=float, default=1e-4)
    group.add_argument("--ema_decay", type=float, default=0.999)
    group.add_argument("--t_eps", type=float, default=0.03)
    group.add_argument("--num_eval_files", type=int, default=10)
    group.add_argument("--loss_type", type=str, default="mse")
    group.add_argument("--loss_abs_exponent", type=float, default=0.5)
    return group


def add_data_module_args(group):
    group.add_argument("--base_dir", type=str, required=True)
    group.add_argument("--format", type=str, choices=("default",), default="default")
    group.add_argument("--batch_size", type=int, default=4)
    group.add_argument("--n_fft", type=int, default=510)
    group.add_argument("--hop_length", type=int, default=128)
    group.add_argument("--num_frames", type=int, default=256)
    group.add_argument("--window", type=str, choices=("sqrthann", "hann"), default="hann")
    group.add_argument("--num_workers", type=int, default=4)
    group.add_argument("--dummy", action="store_true")
    group.add_argument("--spec_factor", type=float, default=0.15)
    group.add_argument("--spec_abs_exponent", type=float, default=0.5)
    group.add_argument("--normalize", type=str, choices=("clean", "noisy", "not"),
                       default="noisy")
    group.add_argument("--transform_type", type=str, choices=("exponent", "log", "none"),
                       default="exponent")
    return group


def add_trainer_args(group):
    group.add_argument("--max_epochs", type=int, default=1000)
    group.add_argument("--max_steps_per_epoch", type=int, default=None)
    group.add_argument("--ckpt_dir", type=str, default=None,
                       help="Checkpoint directory (default ./savedir/<experiment>)")
    group.add_argument("--resume", action="store_true",
                       help="Resume from the latest checkpoint in ckpt_dir")
    group.add_argument("--seed", type=int, default=0)
    group.add_argument("--device", type=str, default="cuda",
                       help="Where to train: the card (default) or cpu")
    group.add_argument("--no_mesh", action="store_true",
                       help="Disable the data-parallel mesh (one rank only)")
    group.add_argument("--tp_size", type=int, default=1,
                       help="Tensor-parallel degree: >1 trains over a 2-D (data, model) mesh "
                            "with the state sharded on out-features (parallel/model_sharding.py)")
    group.add_argument("--wandb", action="store_true")
    group.add_argument("--snr_ckpt", type=str, default=None,
                       help="SNR-estimator checkpoint dir (for snr_conditioned=true validation)")
    group.add_argument("--eval_batch_size", type=int, default=1,
                       help="Per-epoch validation enhances files in bucketed batches of this "
                            "size (1 = one at a time; the same semantics, throughput only)")
    group.add_argument("--accum_steps", type=int, default=1,
                       help="Gradient accumulation: average grads over this many consecutive "
                            "loader batches per optimizer step")
    group.add_argument("--chain_steps", type=int, default=1,
                       help="Run this many consecutive optimizer updates per call of the "
                            "train step (training semantics unchanged)")
    group.add_argument("--eval_every_n_epochs", type=int, default=1,
                       help="Validate/checkpoint every k-th epoch (always the last)")
    return group


def join_ranks(parser, args):
    """Join the launcher's process group (none configured: one process) and
    return this rank's device; ``--no_mesh`` under several ranks is a parser
    error."""
    from ..parallel.mesh import initialize_distributed, rank_device, world_size

    device = rank_device(args.device)  # before NCCL joins: its rank's card
    initialize_distributed(device=device)
    if args.no_mesh and world_size() > 1:
        parser.error(f"--no_mesh under a world size of {world_size()}: every rank would train "
                     "the whole batch alone; launch one process, or drop --no_mesh")
    return device


def main(argv=None):
    from ..data.dataset import DataModuleConfig, SpecsDataModule
    from ..models.score_model import ScoreModel, ScoreModelConfig
    from ..models.shared import BackboneRegistry
    from ..sde import SDERegistry
    from ..train.logging import MetricsLogger
    from ..train.loop import train_score_model

    base_parser, parser = build_parsers()
    temp_args, _ = base_parser.parse_known_args(argv)
    backbone_cls = BackboneRegistry.get_by_name(temp_args.backbone)
    sde_class = SDERegistry.get_by_name(temp_args.sde)

    add_score_model_args(parser.add_argument_group("ScoreModel"))
    sde_class.add_argparse_args(parser.add_argument_group("SDE"))
    backbone_cls.add_argparse_args(parser.add_argument_group("Backbone"))
    add_data_module_args(parser.add_argument_group("DataModule"))
    add_trainer_args(parser.add_argument_group("Trainer"))

    args = parser.parse_args(argv)
    device = join_ranks(parser, args)
    groups = get_argparse_groups(parser, args)

    sigma_max = getattr(args, "sigma_max", 0.5)
    transform_type = args.transform_type
    cfg = ScoreModelConfig(
        backbone=args.backbone, sde=args.sde, model_type=args.modeltype,
        snr_conditioned=args.snr_conditioned, fixed_snr=args.fixed_snr, lr=args.lr,
        ema_decay=args.ema_decay, t_eps=args.t_eps, loss_type=args.loss_type,
        loss_abs_exponent=args.loss_abs_exponent, num_eval_files=args.num_eval_files,
        sigma_max=sigma_max if sigma_max is not None else 0.5, n_fft=args.n_fft,
        hop_length=args.hop_length, num_frames=args.num_frames, window=args.window,
        spec_factor=args.spec_factor, spec_abs_exponent=args.spec_abs_exponent,
        transform_type=transform_type, normalize=args.normalize,
    )
    sde_kwargs = {k: v for k, v in vars(groups["SDE"]).items() if v is not None}
    backbone_kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in vars(groups["Backbone"]).items()
                       if v is not None
                       and k not in getattr(backbone_cls, "TPU_KERNEL_FLAGS", ())}

    snr_net = None
    if args.snr_conditioned == "true" and args.snr_ckpt:
        from ..train.restore import load_snr_model
        from ..train.state import load_ema

        snr_model, snr_state = load_snr_model(args.snr_ckpt, device=device)
        load_ema(snr_state)
        snr_net = snr_model.dnn
    model = ScoreModel(cfg, backbone_kwargs=backbone_kwargs, sde_kwargs=sde_kwargs,
                       device=device, generator=torch.Generator().manual_seed(args.seed),
                       snr_model=snr_net)
    dm = SpecsDataModule(DataModuleConfig(
        base_dir=args.base_dir, format=args.format, batch_size=args.batch_size,
        n_fft=args.n_fft, hop_length=args.hop_length, num_frames=args.num_frames,
        window=args.window, num_workers=args.num_workers, dummy=args.dummy,
        spec_factor=args.spec_factor, spec_abs_exponent=args.spec_abs_exponent,
        normalize=args.normalize, transform_type=transform_type, fixed_snr=args.fixed_snr,
    ))

    if args.snr_conditioned in ("fixed", "true"):
        experiment_name = f"{args.modeltype}_{args.snr_conditioned}{args.fixed_snr}_{sigma_max}"
    else:
        experiment_name = f"{args.modeltype}_{args.snr_conditioned}_{sigma_max}_{transform_type}"
    ckpt_dir = args.ckpt_dir or os.path.join("savedir", experiment_name)

    logger = MetricsLogger(log_dir=None if args.nolog else ckpt_dir,
                           use_wandb=args.wandb and not args.nolog, run_name=experiment_name,
                           config=model.hparams)
    return train_score_model(
        model, dm, max_epochs=args.max_epochs, ckpt_dir=None if args.nolog else ckpt_dir,
        logger=logger, seed=args.seed, resume=args.resume,
        max_steps_per_epoch=args.max_steps_per_epoch, accum_steps=args.accum_steps,
        eval_every_n_epochs=args.eval_every_n_epochs, eval_batch_size=args.eval_batch_size,
        use_mesh=not args.no_mesh, tp_size=args.tp_size, chain_steps=args.chain_steps,
    )


if __name__ == "__main__":
    main()
