"""Synthetic VBD-style fixture dataset: the port's own copy of
diffse_tpu/data/synthetic.py (the same files from the same seed).

Generates the directory contract the reference documents
(dataset/readme.md:4-21): ``{train,valid,valid2,test}/{clean,noisy}`` wav
pairs (16 kHz mono) plus ``valid/active_rms.txt`` with
``filename \t clean_rms \t noise_rms`` lines. Clean signals are speech-like
(envelope-modulated band-limited noise with a pitch harmonic stack) so that
silent-frame removal and active-RMS logic behave as on real speech. Used by
tests and smoke CLI runs (the analog of the reference's 14 in-repo wavs).
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np
import scipy.signal

from .wavio import write_wav
from ..evaluation.metrics import active_rms


def _speech_like(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 220)
    harm = sum(
        rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi))
        for k in range(1, 6)
    )
    sos = scipy.signal.butter(4, [120 / (sr / 2), 3800 / (sr / 2)], "bp", output="sos")
    noise = scipy.signal.sosfilt(sos, rng.standard_normal(n))
    # Burst envelope with true pauses: half-wave bursts over a ~-34 dB floor.
    # Real speech pauses are >= 25 dB down and utterances last >= 0.3 s —
    # P.862 marks a constant-envelope signal as all-noise and drops speech
    # spans shorter than MINUTTLENGTH (~0.2 s), exactly like the ITU tool,
    # so fixtures must pause AND sustain each burst.
    env = 0.02 + 0.98 * np.clip(np.sin(2 * np.pi * rng.uniform(0.8, 1.4) * t), 0, None)
    x = env * (0.6 * harm / 5 + 0.4 * noise)
    return (0.3 * x / np.max(np.abs(x))).astype(np.float32)


def _noise_like(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    sos = scipy.signal.butter(2, 3000 / (sr / 2), "lp", output="sos")
    x = scipy.signal.sosfilt(sos, rng.standard_normal(n))
    return (x / np.max(np.abs(x))).astype(np.float32)


def _white_noise(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    return rng.standard_normal(n).astype(np.float32)


def _amod_noise(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Amplitude-modulated white noise (cafeteria-like bursts)."""
    t = np.arange(n) / sr
    env = 0.1 + 0.9 * np.clip(
        np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t + rng.uniform(0, 2 * np.pi)),
        0, None,
    )
    return (env * rng.standard_normal(n)).astype(np.float32)


# PESQ-mildness is a property of the noise SHAPE: the legacy 3 kHz-lowpass
# noise ("lp3k") costs the mixture only ~2.2 MOS at -5 dB active SNR (native
# P.862.2), while white / amplitude-modulated noise lands the mixture at
# ~1.33 — the realistic operating point (real VBD -5 dB remixes score ~1.2,
# DEVNOTES round 2) and the headroom a denoiser needs to beat its input.
_NOISE_GENS = {
    "lp3k": _noise_like,
    "white": _white_noise,
    "amod": _amod_noise,
}


def _make_noise(rng: np.random.Generator, n: int, sr: int,
                noise_type: str) -> np.ndarray:
    if noise_type == "white_amod":  # per-file random draw between the two
        noise_type = "white" if rng.uniform() < 0.5 else "amod"
    return _NOISE_GENS[noise_type](rng, n, sr)


def make_synthetic_dataset(
    root: str,
    num_train: int = 6,
    num_valid: int = 4,
    num_valid2: int = 4,
    num_test: int = 4,
    duration_s: float = 1.4,
    sr: int = 16000,
    snr_db: float = -5.0,
    seed: int = 0,
    noise_type: str = "lp3k",
) -> str:
    """Create the dataset under `root`; returns `root`."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)

    splits = {
        "train": num_train,
        "valid": num_valid,
        "valid2": num_valid2,
        "test": num_test,
    }
    for subset, count in splits.items():
        clean_dir = join(root, subset, "clean")
        noisy_dir = join(root, subset, "noisy")
        os.makedirs(clean_dir, exist_ok=True)
        os.makedirs(noisy_dir, exist_ok=True)
        rms_lines = []
        for i in range(count):
            name = f"p{subset[:2]}_{i:03d}.wav"
            x = _speech_like(rng, n, sr)
            noise = _make_noise(rng, n, sr, noise_type)
            # mix at the requested active-SNR (the single_SNRize recipe)
            c_rms, n_rms = active_rms(x, noise, fs=sr)
            gain = (c_rms / n_rms) * 10 ** (-snr_db / 20)
            noise = noise * gain
            y = x + noise
            peak = np.max(np.abs(y))
            if peak > 0.99:  # clip protection rescale (single_SNRize cell 2)
                x, y, noise = (a * 0.99 / peak for a in (x, y, noise))
            write_wav(join(clean_dir, name), x, sr)
            write_wav(join(noisy_dir, name), y.astype(np.float32), sr)
            c_rms2, n_rms2 = active_rms(x, noise, fs=sr)
            rms_lines.append(f"{name}\t{c_rms2:.8f}\t{n_rms2:.8f}")
        if subset == "valid":
            with open(join(root, subset, "active_rms.txt"), "w") as f:
                f.write("\n".join(rms_lines) + "\n")
    return root
