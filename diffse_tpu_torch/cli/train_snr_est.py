"""SNR-estimator training CLI (port of diffse_tpu/cli/train_snr_est.py;
reference: train_snr_est.py).

The JAX CLI's flags (the data module's and the trainer's, as
``cli/train.py`` takes them), plus ``--device`` (the card unless "cpu" is
given). SNRNet's initial weights are drawn from ``--seed``. Under a
launcher of several ranks training is data-parallel (``cli.train``'s
``join_ranks``); ``--no_mesh`` trains on one rank. The SNR estimator's
training, as the JAX package's, takes no tensor parallelism and one update
a step: ``--tp_size`` and ``--chain_steps`` other than 1 are parser errors.
Checkpoints go to ``--ckpt_dir``
(default ``savedir/snr_estimator``), ranked by ``snr_error``, where
``load_snr_model``, ``cli.eval_snr_est`` and ``--snr_ckpt`` read them.
``main`` returns the final ``TrainState``.

Usage (README.md:23 analog):
    python -m diffse_tpu_torch.cli.train_snr_est --transform_type none \\
        --base_dir /data/VBD_SNR-5
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from .train import add_data_module_args, add_trainer_args, join_ranks


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--backbone", type=str, default="snrnet")
    parser.add_argument("--nolog", action="store_true")
    g = parser.add_argument_group("SNRModel")
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--ema_decay", type=float, default=0.999)
    g.add_argument("--num_eval_files", type=int, default=10)
    g.add_argument("--loss_type", type=str, default="mse")
    add_data_module_args(parser.add_argument_group("DataModule"))
    add_trainer_args(parser.add_argument_group("Trainer"))
    args = parser.parse_args(argv)
    for flag, value in (("--tp_size", args.tp_size), ("--chain_steps", args.chain_steps)):
        if value != 1:
            parser.error(f"{flag} {value}: the SNR estimator trains data-parallel only, one "
                         "update a step (as the JAX package's train_snr_model)")
    device = join_ranks(parser, args)

    import torch

    from ..data.dataset import DataModuleConfig, SpecsDataModule
    from ..models.snr_model import SNRModel, SNRModelConfig
    from ..models.snrnet import SNRNet
    from ..train.logging import MetricsLogger
    from ..train.loop import train_snr_model

    cfg = SNRModelConfig(
        lr=args.lr, ema_decay=args.ema_decay, num_eval_files=args.num_eval_files,
        loss_type=args.loss_type, n_fft=args.n_fft, hop_length=args.hop_length,
        num_frames=args.num_frames, window=args.window,
        transform_type=args.transform_type,
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        dnn = SNRNet()
    model = SNRModel(cfg, device=device, dnn=dnn)
    dm = SpecsDataModule(DataModuleConfig(
        base_dir=args.base_dir, format=args.format, batch_size=args.batch_size,
        n_fft=args.n_fft, hop_length=args.hop_length, num_frames=args.num_frames,
        window=args.window, num_workers=args.num_workers, dummy=args.dummy,
        normalize=args.normalize, transform_type=args.transform_type,
    ))

    ckpt_dir = args.ckpt_dir or os.path.join("savedir", "snr_estimator")
    logger = MetricsLogger(log_dir=None if args.nolog else ckpt_dir,
                           use_wandb=args.wandb and not args.nolog, run_name="snr_estimator",
                           config=model.hparams)
    return train_snr_model(
        model, dm, max_epochs=args.max_epochs,
        ckpt_dir=None if args.nolog else ckpt_dir, logger=logger,
        seed=args.seed, resume=args.resume,
        max_steps_per_epoch=args.max_steps_per_epoch, use_mesh=not args.no_mesh,
    )


if __name__ == "__main__":
    main()
