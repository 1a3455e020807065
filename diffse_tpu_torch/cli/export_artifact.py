"""Export a trained checkpoint's enhance program as an artifact (the port's
counterpart of tools/export_artifact.py, with its flags).

Writes the exported normalise -> STFT -> sampler -> iSTFT program of each
width bucket, the weights (the checkpoint's EMA unless ``--no_ema``) and
``meta.json`` into ``--out`` (``serving/export.py``), for
``python -m diffse_tpu_torch.cli.serve --artifact``. A program is traced for
the device it runs on: ``--device`` (the card unless "cpu" is given) in
place of the JAX tool's ``--platforms``, which this CLI refuses. ``main``
returns the artifact's meta.

Usage:
    python -m diffse_tpu_torch.cli.export_artifact --ckpt savedir/<exp> \\
        --out artifact/ --utt_seconds 8 [--branch bbed_pc] [--N 30]
"""

from __future__ import annotations

import argparse
import os


def default_branch(cfg) -> str:
    """The enhance branch of a model's config: ``<model_type>_snr`` for an
    SNR-conditioned model, the PC sampler for bbed, else the model type."""
    if cfg.snr_conditioned == "true":
        return f"{cfg.model_type}_snr"
    if cfg.model_type == "bbed":
        return "bbed_pc"
    return cfg.model_type


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--branch", type=str, default=None,
                        help="enhance branch (default: from the checkpoint's "
                             "model_type/snr_conditioned, PC sampler for bbed)")
    parser.add_argument("--utt_seconds", type=float, nargs="+", default=[8.0],
                        help="utterance length(s) the artifact serves: one exported program "
                             "per distinct width bucket; the loader picks the smallest that fits")
    parser.add_argument("--N", type=int, default=30)
    parser.add_argument("--predictor", type=str, default="reverse_diffusion")
    parser.add_argument("--corrector", type=str, default="ald")
    parser.add_argument("--corrector_steps", type=int, default=1)
    parser.add_argument("--platforms", type=str, nargs="+", default=None,
                        help="not ported: a program is exported for --device")
    parser.add_argument("--no_ema", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the program is exported for and runs on: the card "
                             "(default) or cpu")
    args = parser.parse_args(argv)
    if args.platforms is not None:
        parser.error("--platforms: not ported; the program is exported for --device")

    from ..serving.export import save_artifact
    from ..train.restore import load_score_model
    from ..train.state import eval_variables

    model, state = load_score_model(args.ckpt, device=args.device)
    variables = eval_variables(state, no_ema=args.no_ema)
    branch = args.branch or default_branch(model.cfg)
    utt_samples = [int(s * 16000) for s in args.utt_seconds]
    meta = save_artifact(args.out, model, variables, branch, utt_samples, n_steps=args.N,
                         predictor=args.predictor, corrector=args.corrector,
                         corrector_steps=args.corrector_steps)
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    buckets = [b["pad_samples"] for b in meta["buckets"]]
    print(f"exported {branch} (buckets {buckets} samples, device {meta['device']}) -> "
          f"{args.out} ({size / 1e6:.1f} MB)")
    return meta


if __name__ == "__main__":
    main()
