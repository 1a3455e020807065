"""SNR-estimator evaluation CLI (port of diffse_tpu/cli/eval_snr_est.py;
reference: eval_snr_est.py).

For each test wav: crop/pad to 256 frames, draw a random SNR in [-5, 35] dB,
remix, normalize, raw STFT (510/128), run SNRNet (its EMA weights), and print
real vs estimated SNR (est_SNR = 20 log10((1-g)/g)). Reports the mean
absolute error (the paper's headline 1.42 dB metric), and writes it to
``_snr_est_results.txt`` under ``--destination_folder`` when given. The SNR
draws are numpy's ``default_rng(seed)``, as in the JAX package, so both
draw the same SNRs. The port adds ``--device`` (the card unless "cpu" is
given). ``main`` returns the mean absolute error in dB.
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser
from os.path import join

import numpy as np


def main(argv=None) -> float:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--destination_folder", type=str, default=None)
    parser.add_argument("--test_dir", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to run SNRNet: the card (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from ..data.wavio import read_wav
    from ..models.snr_model import complex_to_2ch
    from ..train.restore import load_snr_model
    from ..train.state import load_ema
    from ..transforms import pad_spec_16, stft

    clean_dir = join(args.test_dir, "clean")
    noisy_dir = join(args.test_dir, "noisy")

    model, state = load_snr_model(args.ckpt, device=args.device)
    load_ema(state)

    num_frames = 256
    hop_length = model.cfg.hop_length
    rng = np.random.default_rng(args.seed)

    noisy_files = sorted(glob.glob(f"{noisy_dir}/*.wav"))
    real_snrs, est_snrs = [], []
    for noisy_file in noisy_files:
        filename = os.path.basename(noisy_file)
        x, _ = read_wav(join(clean_dir, filename))
        y, _ = read_wav(noisy_file)

        # center crop / pad to 256 frames (eval_snr_est.py:71-85)
        target_len = (num_frames - 1) * hop_length
        current_len = x.shape[-1]
        pad = max(target_len - current_len, 0)
        if pad == 0:
            start = int((current_len - target_len) / 2)
            x = x[..., start: start + target_len]
            y = y[..., start: start + target_len]
        else:
            width = ((0, 0), (pad // 2, pad // 2 + pad % 2))
            x = np.pad(x, width)
            y = np.pad(y, width)

        snr_db = rng.random() * 40  # U[0, 40] -> effective SNR - 5 dB
        real_snrs.append(snr_db - 5)
        y = x + (y - x) * 10 ** (-snr_db / 20)

        normfac = np.max(np.abs(y))
        y = y / normfac

        y_t = torch.from_numpy(np.asarray(y, dtype=np.float32)).to(model.device)
        spec = stft(y_t, model._window, model.stft_cfg.n_fft, hop_length)
        spec2 = pad_spec_16(complex_to_2ch(spec[:, None]))
        est_gt = float(model.forward(spec2)[0, 0])
        est_snr_db = 20 * np.log10((1 - est_gt) / est_gt)
        est_snrs.append(est_snr_db)
        print(f"real:{snr_db - 5:.1f}/est:{est_snr_db:.1f}")

    err = np.mean(np.abs(np.asarray(real_snrs) - np.asarray(est_snrs)))
    print(f"mean abs SNR error: {err:.2f} dB over {len(real_snrs)} files")
    if args.destination_folder:
        os.makedirs(args.destination_folder, exist_ok=True)
        with open(join(args.destination_folder, "_snr_est_results.txt"), "w") as f:
            f.write(f"mean_abs_snr_error_db: {err:.4f}\n")
    return float(err)


if __name__ == "__main__":
    main()
