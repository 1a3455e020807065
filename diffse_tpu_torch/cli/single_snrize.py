"""Re-mix a VoiceBank-DEMAND-style dataset to a single fixed active SNR (the
port's counterpart of tools/single_snrize.py, with its flags and files).

Script replacement for the reference's dataset/single_SNRize.ipynb (3 cells):
for each clean/noisy pair, measure the active-RMS SNR (100 ms windows, -50 dB
energy threshold), rescale the noise so the active SNR equals --target_snr
(default -5 dB), apply clip-protection rescaling, and write
clean/ noisy/ noise/ plus active_rms.txt per split — the directory contract of
dataset/readme.md:4-21 (VBD_SNR-5/{train,valid,valid2}/...). Host numpy only.

Usage:
    python -m diffse_tpu_torch.cli.single_snrize --in_dir VBD/train \\
        --out_dir VBD_SNR-5/train --target_snr -5
"""

from __future__ import annotations

import argparse
import glob
import os
from os.path import basename, join

import numpy as np

from ..data.wavio import read_wav, write_wav
from ..evaluation.metrics import active_rms


def snrize_pair(clean: np.ndarray, noisy: np.ndarray, target_snr_db: float):
    """Rescale the noise so the active SNR equals target_snr_db; returns
    (clean, noisy_new, noise_new) after clip protection."""
    noise = noisy - clean
    c_rms, n_rms = active_rms(clean, noise)
    cur_snr_db = 20 * np.log10(c_rms / n_rms)
    gain = 10 ** ((cur_snr_db - target_snr_db) / 20)
    noise_new = noise * gain
    noisy_new = clean + noise_new
    peak = np.max(np.abs(noisy_new))
    if peak > 0.99:  # clip protection (notebook cell 2)
        scale = 0.99 / peak
        clean = clean * scale
        noise_new = noise_new * scale
        noisy_new = noisy_new * scale
    return clean, noisy_new, noise_new


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--in_dir", type=str, required=True,
                        help="Split dir containing clean/ and noisy/")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--target_snr", type=float, default=-5.0)
    parser.add_argument("--sr", type=int, default=16000)
    args = parser.parse_args(argv)

    clean_files = sorted(glob.glob(join(args.in_dir, "clean", "*.wav")))
    for sub in ("clean", "noisy", "noise"):
        os.makedirs(join(args.out_dir, sub), exist_ok=True)

    rms_lines = []
    for cf in clean_files:
        name = basename(cf)
        nf = join(args.in_dir, "noisy", name)
        clean, sr = read_wav(cf)
        noisy, _ = read_wav(nf)
        clean, noisy = clean[0], noisy[0]

        clean2, noisy2, noise2 = snrize_pair(clean, noisy, args.target_snr)
        write_wav(join(args.out_dir, "clean", name), clean2, sr)
        write_wav(join(args.out_dir, "noisy", name), noisy2, sr)
        write_wav(join(args.out_dir, "noise", name), noise2, sr)

        c_rms, n_rms = active_rms(clean2, noise2)
        rms_lines.append(f"{name}\t{c_rms:.8f}\t{n_rms:.8f}")
        print(f"{name}: active SNR -> {20 * np.log10(c_rms / n_rms):+.2f} dB")

    with open(join(args.out_dir, "active_rms.txt"), "w") as f:
        f.write("\n".join(rms_lines) + "\n")


if __name__ == "__main__":
    main()
