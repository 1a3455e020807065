"""SNR-sweep evaluation CLI (port of diffse_tpu/cli/deep_eval.py; reference:
deep_eval.py).

For each test wav, synthesizes 9 SNR variants y = x + (y_def - x) * 10^(-SNR/20)
for SNR in {0..40 step 5} (effective input SNRs -5..35 dB, deep_eval.py:112-118),
enhances each with ``ScoreModel.enhance`` and the oracle rms pair
(clean_rms=1, noise_rms=10^((-SNR+5)/20), read with ``--oracle``), and
records per-SNR PESQ/SI-SDR/ESTOI columns in ``_results_deep.csv`` and their
mean ± std in ``_avg_results_deep.txt``. Variant ``j`` of file ``i`` (sorted
order) draws from a generator seeded with ``dispatch_seed(0, 9 i + j)``.
The port adds ``--device`` (the card unless "cpu" is given), and keeps the
SDE's own T and ``--N`` unless ``--reverse_starting_point`` is given (see
cli/eval.py: the JAX package's default 1.0 makes BBED's output NaN). ``main``
returns a summary of the run: files, enhanced seconds of audio, and the
seconds spent enhancing and scoring.
"""

from __future__ import annotations

import glob
import os
import time
from argparse import ArgumentParser
from os.path import join


def main(argv=None) -> dict:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--destination_folder", type=str, required=True)
    parser.add_argument("--test_dir", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--ckpt_step", type=int, default=None)
    parser.add_argument("--monitor", type=str, default=None)
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
    parser.add_argument("--atol", type=float, default=1e-5, help="accepted and unused")
    parser.add_argument("--rtol", type=float, default=1e-5, help="accepted and unused")
    parser.add_argument("--timestep_type", type=str, default="linear")
    parser.add_argument("--oracle", type=bool, default=False)
    parser.add_argument("--snr_ckpt", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to enhance: the card (default) or cpu")
    args = parser.parse_args(argv)

    from ..data.wavio import read_wav, write_wav
    from ..evaluation.deep_inference import SNR_GRID
    from ..evaluation.inference import dispatch_generator
    from ..evaluation.metrics import estoi, pesq_wb, print_mean_std, si_sdr
    from ..evaluation.results import write_csv
    from .eval import load_models, reverse_start

    clean_dir = join(args.test_dir, "clean")
    noisy_dir = join(args.test_dir, "noisy")

    model = load_models(args)
    sr = 16000
    N = args.N
    if args.reverse_starting_point is not None:
        reverse_start(model, args.reverse_starting_point)
        N = int(args.reverse_starting_point * args.N)
    if args.force_N:
        N = args.force_N

    noisy_files = sorted(glob.glob(f"{noisy_dir}/*.wav"))
    target_dir = args.destination_folder
    for s in SNR_GRID:
        os.makedirs(join(target_dir, f"{s - 5:02d}"), exist_ok=True)

    data = {"filename": []}
    for s in SNR_GRID:
        data[f"pesq_{s - 5}"] = []
        data[f"si_sdr_{s - 5}"] = []
        data[f"estoi_{s - 5}"] = []
    timing = {"files": 0, "audio_seconds": 0.0, "enhance_seconds": 0.0,
              "scoring_seconds": 0.0}

    for cnt, noisy_file in enumerate(noisy_files):
        filename = os.path.basename(noisy_file)
        data["filename"].append(filename)
        x_def, _ = read_wav(join(clean_dir, filename))
        y_def, _ = read_wav(noisy_file)
        y0_def = y_def - x_def

        for j, snr_db in enumerate(SNR_GRID):
            x = x_def
            y = x_def + y0_def * 10 ** (-snr_db / 20)
            start = time.perf_counter()
            x_hat = model.enhance(
                x, y, generator=dispatch_generator(model.device, 0, len(SNR_GRID) * cnt + j),
                sampler_type=args.sampler_type, predictor=args.predictor,
                corrector=args.corrector, corrector_steps=args.corrector_steps, N=N,
                snr=args.snr, timestep_type=args.timestep_type, oracle=args.oracle,
                clean_rms=1, noise_rms=10 ** ((-snr_db + 5) / 20))
            timing["enhance_seconds"] += time.perf_counter() - start
            start = time.perf_counter()
            x1 = x[0]
            write_wav(join(target_dir, f"{snr_db - 5:02d}", filename), x_hat, sr)
            p = pesq_wb(sr, x1, x_hat)
            data[f"pesq_{snr_db - 5}"].append(p)
            data[f"si_sdr_{snr_db - 5}"].append(si_sdr(x1, x_hat))
            data[f"estoi_{snr_db - 5}"].append(estoi(x1, x_hat, sr))
            timing["scoring_seconds"] += time.perf_counter() - start
            timing["audio_seconds"] += len(x_hat) / sr
            print(f"{snr_db - 5} | pesq {p:.3f} si_sdr {data[f'si_sdr_{snr_db - 5}'][-1]:.2f}")
        timing["files"] += 1

    write_csv(join(target_dir, "_results_deep.csv"), data)
    with open(join(target_dir, "_avg_results_deep.txt"), "w") as f:
        for snr_db in SNR_GRID:
            f.write("PESQ_{0}: {1} \n".format(
                snr_db - 5, print_mean_std(data[f"pesq_{snr_db - 5}"], decimal=3)))
            f.write("SI-SDR_{0}: {1} \n".format(
                snr_db - 5, print_mean_std(data[f"si_sdr_{snr_db - 5}"], decimal=1)))
            f.write("ESTOI_{0}: {1} \n".format(
                snr_db - 5, print_mean_std(data[f"estoi_{snr_db - 5}"], decimal=2)))
    return timing


if __name__ == "__main__":
    main()
