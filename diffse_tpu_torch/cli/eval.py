"""Full test-set evaluation CLI (port of diffse_tpu/cli/eval.py; reference:
eval.py).

Loads a checkpoint's EMA weights, optionally reads the SNR oracle from
``active_rms.txt`` (eval.py:55-67), rescales the reverse starting point when
``--reverse_starting_point`` is given (sde.T = reverse_starting_point,
N = T / delta_t, eval.py:105-113), enhances
every wav under <test_dir>/noisy, and writes the enhanced wavs, a per-file
metric CSV (``_results.csv``) and a mean ± std summary (``_avg_results.txt``).
PESQ (the ``pesq`` wheel if installed, else the native P.862.2), SI-SDR and
ESTOI are scored on the host.

Paths: one file at a time through ``ScoreModel.enhance`` (the default:
``--sampler_type pc|ode``, ``--oracle``, ``--reverse_starting_point``,
``--force_N``); ``--eval_batch_size > 1`` through ``batch_eval.batch_enhance``
with the eval harness's branch semantics; with ``--streaming_chunk_frames``
as well, the packed fleet engine; ``--streaming_chunk_frames`` alone, spec
(or ``--streaming_mode wav``) streaming per utterance. File ``i`` (sorted
order) draws from a generator seeded with ``dispatch_seed(0, i)``; the
batched paths from seed 0 by their own rules. ``--seq_shards N`` enhances
each file frames-parallel over N ranks (``ScoreModel.enhance(seq_mesh=)``),
the single-utterance path only: under a launcher of N ranks (``torchrun
--nproc_per_node N``, gloo where the ranks share a card) or, for N = 1, in
one process; every rank reads the same files and rank 0 writes the wavs and
the results. The port adds ``--device`` (the card unless "cpu" is given).
Unlike the JAX package, whose
``--reverse_starting_point`` defaults to 1.0, the port keeps the SDE's own
T and ``--N`` unless the flag is given: BBED's marginal std at T = 1.0 is
NaN (0 x Ei(0)), so that default turns every ``bbed`` output into NaN, and
the logit and bridge_geom grids refuse T = 1. ``main`` returns a summary of
the run: files, seconds of audio, and the seconds spent enhancing and
scoring.
"""

from __future__ import annotations

import glob
import os
import time
from argparse import ArgumentParser
from os.path import join

import numpy as np


def _write_results(target_dir, data):
    """Per-file CSV + mean ± std summary (eval.py:159-170)."""
    from ..evaluation.metrics import print_mean_std
    from ..evaluation.results import write_csv

    write_csv(join(target_dir, "_results.csv"), data)
    with open(join(target_dir, "_avg_results.txt"), "w") as f:
        f.write("PESQ: {} \n".format(print_mean_std(data["pesq"])))
        f.write("SI-SDR: {} \n".format(print_mean_std(data["si_sdr"])))
        f.write("ESTOI: {} \n".format(print_mean_std(data["estoi"])))


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--destination_folder", type=str, required=True)
    parser.add_argument("--test_dir", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True,
                        help="Checkpoint directory (CheckpointManager layout)")
    parser.add_argument("--ckpt_step", type=int, default=None)
    parser.add_argument("--monitor", type=str, default=None,
                        help="Pick the best checkpoint by this metric (e.g. pesq)")
    parser.add_argument("--sampler_type", type=str, choices=("pc", "ode"), default="pc")
    parser.add_argument("--predictor", type=str, default="reverse_diffusion")
    parser.add_argument("--reverse_starting_point", type=float, default=None,
                        help="start the reverse process at this T, with N = T * --N steps "
                             "(default: the SDE's own T and --N steps)")
    parser.add_argument("--force_N", type=int, default=0)
    parser.add_argument("--corrector", type=str, choices=("ald", "langevin", "none"),
                        default="ald")
    parser.add_argument("--corrector_steps", type=int, default=1)
    parser.add_argument("--snr", type=float, default=0.5)
    parser.add_argument("--N", type=int, default=30)
    parser.add_argument("--atol", type=float, default=1e-5,
                        help="accepted and unused, as in the JAX package (RK45 at 1e-5)")
    parser.add_argument("--rtol", type=float, default=1e-5,
                        help="accepted and unused, as in the JAX package (RK45 at 1e-5)")
    parser.add_argument("--timestep_type", type=str, default="linear")
    parser.add_argument("--oracle", type=bool, default=False)
    parser.add_argument("--snr_ckpt", type=str, default=None,
                        help="SNR-estimator checkpoint dir (snr_conditioned=true, non-oracle)")
    parser.add_argument("--eval_batch_size", type=int, default=1,
                        help="Bucketed batch enhancement (>1 uses the in-training harness "
                             "branch semantics via batch_eval; per-utterance normalization "
                             "is preserved)")
    parser.add_argument("--streaming_chunk_frames", type=int, default=0,
                        help="If > 0 (multiple of 64), enhance via overlap-chunked streaming; "
                             "with --eval_batch_size > 1, chunks are pooled across utterances "
                             "into fixed-shape batches (packed fleet serving)")
    parser.add_argument("--streaming_overlap_frames", type=int, default=2,
                        help="Chunk overlap in frames")
    parser.add_argument("--streaming_trim_frames", type=int, default=0,
                        help="Discard this many frames per interior chunk edge before the "
                             "overlap-add (needs overlap > 2*trim; wav mode only)")
    parser.add_argument("--streaming_mode", type=str, default="spec", choices=("spec", "wav"),
                        help="'spec' (default): one STFT per utterance, overlapped frame "
                             "chunks, crossfade OLA + one iSTFT. 'wav': per-chunk waveforms")
    parser.add_argument("--seq_shards", type=int, default=0,
                        help="If > 0, shard each utterance's spectrogram frames over a 1-D "
                             "'seq' mesh of that many ranks (frames-parallel enhancement; "
                             "parallel/sequence.py). Single-utterance path only "
                             "(incompatible with --eval_batch_size > 1 and "
                             "--streaming_chunk_frames)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to enhance: the card (default) or cpu")
    return parser


def load_models(args):
    """The checkpoint's ScoreModel with its EMA weights loaded (and the SNR
    estimator's, from ``--snr_ckpt``)."""
    from ..train.restore import load_score_model, load_snr_model
    from ..train.state import load_ema

    snr_net = None
    if args.snr_ckpt:
        snr_model, snr_state = load_snr_model(args.snr_ckpt, device=args.device)
        load_ema(snr_state)
        snr_net = snr_model.dnn
    model, state = load_score_model(args.ckpt, step=args.ckpt_step, monitor=args.monitor,
                                    snr_model=snr_net, device=args.device)
    load_ema(state)  # the EMA weights (eval.py:98)
    return model


def reverse_start(model, reverse_starting_point: float) -> None:
    """Start the reverse process at ``reverse_starting_point`` (eval.py:105-113):
    the SDE replaced, so the captured programs key on the new one."""
    if model.sde.__class__.__name__ == "OUVESDE":
        model.sde = model.sde.replace(T_=reverse_starting_point)
    else:
        model.sde = model.sde.replace(T_sampling=reverse_starting_point)


def seq_mesh_for(args):
    """The frames mesh of ``--seq_shards`` ranks: the process group joined
    first where a launcher configured one (gloo where the ranks outnumber
    the cards), each rank on its card; ``args.device`` set to this rank's."""
    import torch

    from ..parallel.dryrun import launch_backend
    from ..parallel.mesh import initialize_distributed, rank_device
    from ..parallel.sequence import make_seq_mesh

    device = rank_device(args.device)
    initialize_distributed(device=device, backend=launch_backend(
        str(device), int(os.environ.get("WORLD_SIZE", 1))))
    args.device = str(device)
    return make_seq_mesh(args.seq_shards, torch.device(device).type)


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    seq_mesh = None
    if args.seq_shards:
        if args.eval_batch_size > 1 or args.streaming_chunk_frames:
            parser.error("--seq_shards requires the single-utterance path "
                         "(no --eval_batch_size > 1 / --streaming_chunk_frames)")
        seq_mesh = seq_mesh_for(args)

    from ..data.wavio import read_wav, write_wav
    from ..evaluation.inference import dispatch_generator, estimate_snrs
    from ..evaluation.metrics import estoi, pesq_wb, si_sdr
    from ..parallel.mesh import is_main_rank
    from ..train.loop import eval_model_type

    clean_dir = join(args.test_dir, "clean")
    noisy_dir = join(args.test_dir, "noisy")

    clean_rms, noise_rms = [], []
    if args.oracle:
        with open(join(args.test_dir, "active_rms.txt")) as f:
            for line in f:
                parts = line.split("\t")
                try:
                    clean_rms.append(float(parts[1]))
                    noise_rms.append(float(parts[2]))
                except (IndexError, ValueError):
                    break

    model = load_models(args)
    sr = 16000
    N = args.N
    if args.reverse_starting_point is not None:
        reverse_start(model, args.reverse_starting_point)
        delta_t = 1 / args.N
        N = int(args.reverse_starting_point / delta_t)
    if args.force_N:
        N = args.force_N

    noisy_files = sorted(glob.glob(f"{noisy_dir}/*.wav"))
    target_dir = args.destination_folder
    writes = is_main_rank()  # with --seq_shards, rank 0 writes and scores
    if writes:
        os.makedirs(join(target_dir, "all"), exist_ok=True)

    data = {"filename": [], "pesq": [], "si_sdr": [], "estoi": []}
    timing = {"files": 0, "audio_seconds": 0.0, "enhance_seconds": 0.0,
              "scoring_seconds": 0.0}

    def score(filename, x1, x_hat):
        start = time.perf_counter()
        write_wav(join(target_dir, "all", filename), x_hat, sr)
        data["filename"].append(filename)
        data["pesq"].append(pesq_wb(sr, x1, x_hat))
        data["si_sdr"].append(si_sdr(x1, x_hat))
        data["estoi"].append(estoi(x1, x_hat, sr))
        timing["scoring_seconds"] += time.perf_counter() - start
        timing["files"] += 1
        timing["audio_seconds"] += len(x_hat) / sr
        return data["pesq"][-1]

    # bbed sampler overrides for the batched and streaming paths; only
    # non-defaults are passed, so the default path keeps its program keys
    defaults = {"predictor": "reverse_diffusion", "corrector": "ald", "N": 30, "snr": 0.5,
                "corrector_steps": 1, "timestep_type": "linear"}
    sampler_sk = {k: v for k, v in (
        ("predictor", args.predictor), ("corrector", args.corrector), ("N", N),
        ("snr", args.snr), ("corrector_steps", args.corrector_steps),
        ("timestep_type", args.timestep_type)) if v != defaults[k]} or None
    mt = eval_model_type(model.cfg.snr_conditioned, model.cfg.model_type)

    if args.eval_batch_size > 1:
        # bucketed batches; with --streaming_chunk_frames, chunks pooled
        # across utterances into fixed-shape batches (the packed engine)
        import torch

        from ..evaluation.batch_eval import batch_enhance
        from ..evaluation.streaming import enhance_streamed_packed

        if args.streaming_chunk_frames and args.streaming_mode != "spec":
            parser.error("packed streaming (--eval_batch_size > 1 with "
                         "--streaming_chunk_frames) supports --streaming_mode spec only")
        names = [os.path.basename(f) for f in noisy_files]
        xs = [read_wav(join(clean_dir, name))[0][0] for name in names]
        ys = [read_wav(f)[0][0] for f in noisy_files]
        start = time.perf_counter()
        est_snrs = estimate_snrs(model, ys) if mt.endswith("_snr") else None
        if args.streaming_chunk_frames:
            outs = enhance_streamed_packed(
                model, ys, mt, torch.Generator(model.device).manual_seed(0),
                chunk_frames=args.streaming_chunk_frames,
                overlap_frames=args.streaming_overlap_frames, batch_size=args.eval_batch_size,
                x_wavs=xs, est_snrs=est_snrs, fixed_snr=model.cfg.fixed_snr,
                sampler_kwargs=sampler_sk)
        else:
            outs = batch_enhance(model, xs, ys, mt, seed=0, batch_size=args.eval_batch_size,
                                 est_snrs=est_snrs, fixed_snr=model.cfg.fixed_snr,
                                 sampler_kwargs=sampler_sk)
        timing["enhance_seconds"] += time.perf_counter() - start
        for name, x1, x_hat in zip(names, xs, outs):
            score(name, x1, x_hat)
        _write_results(target_dir, data)
        return timing

    if args.streaming_chunk_frames:
        # overlap-chunked streaming, one utterance at a time
        from ..evaluation.streaming import enhance_streamed, enhance_streamed_spec

        pesq_sum = 0.0
        for cnt, noisy_file in enumerate(noisy_files):
            filename = os.path.basename(noisy_file)
            x, _ = read_wav(join(clean_dir, filename))
            y, _ = read_wav(noisy_file)
            start = time.perf_counter()
            est_snr = estimate_snrs(model, [y[0]])[0] if mt.endswith("_snr") else 1.0
            kwargs = dict(chunk_frames=args.streaming_chunk_frames,
                          overlap_frames=args.streaming_overlap_frames, x_wav=x[0],
                          est_snr=est_snr, fixed_snr=model.cfg.fixed_snr,
                          sampler_kwargs=sampler_sk)
            generator = dispatch_generator(model.device, 0, cnt)
            if args.streaming_mode == "spec":
                x_hat = enhance_streamed_spec(model, y[0], mt, generator, **kwargs)
            else:
                x_hat = enhance_streamed(model, y[0], mt, generator,
                                         trim_frames=args.streaming_trim_frames, **kwargs)
            timing["enhance_seconds"] += time.perf_counter() - start
            p = score(filename, x[0][: len(x_hat)], x_hat)
            pesq_sum += 0.0 if np.isnan(p) else p
            print(f" avg PESQ: {pesq_sum / (cnt + 1):.3f}")
        _write_results(target_dir, data)
        return timing

    pesq_sum = 0.0
    for cnt, noisy_file in enumerate(noisy_files):
        filename = os.path.basename(noisy_file)
        x, _ = read_wav(join(clean_dir, filename))
        y, _ = read_wav(noisy_file)
        kwargs = dict(sampler_type=args.sampler_type, predictor=args.predictor,
                      corrector=args.corrector, corrector_steps=args.corrector_steps, N=N,
                      snr=args.snr, timestep_type=args.timestep_type, oracle=args.oracle)
        if args.oracle:
            kwargs.update(clean_rms=clean_rms[cnt], noise_rms=noise_rms[cnt])
        if seq_mesh is not None:
            kwargs.update(seq_mesh=seq_mesh)
        start = time.perf_counter()
        x_hat = model.enhance(x, y, generator=dispatch_generator(model.device, 0, cnt), **kwargs)
        timing["enhance_seconds"] += time.perf_counter() - start
        if not writes:
            continue
        p = score(filename, x[0], x_hat)
        pesq_sum += 0.0 if np.isnan(p) else p
        print(f" avg PESQ: {pesq_sum / (cnt + 1):.3f}  "
              f"(si_sdr {data['si_sdr'][-1]:.2f}, estoi {data['estoi'][-1]:.3f})")

    if writes:
        _write_results(target_dir, data)
    return timing


if __name__ == "__main__":
    main()
