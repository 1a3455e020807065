"""Speech-quality metrics: the port's own copy of
diffse_tpu/evaluation/metrics.py (numpy/scipy), so that the port imports
nothing of the JAX package.

Host-side scoring, mirroring the reference's metric surface:

  - SI-SDR / SI-SIR / SI-SAR energy ratios (utils.py:10-35, 67-75)
  - mean +- confidence interval / std formatting (utils.py:37-46, 112-123)
  - Butterworth high-pass (utils.py:61-65), snr_dB (util/other.py:77-81)
  - active-RMS clean/noise levels (util/inference.py:30-64)
  - STOI / ESTOI: implemented natively from Taal et al. 2011 / Jensen & Taal
    2016 (the reference depends on `pystoi`, which is not available here; the
    implementation follows the published algorithm: 10 kHz resample, silent
    frame removal at 40 dB dynamic range, 256/128 hann STFT with 512-point
    FFT, 15 one-third-octave bands from 150 Hz, and for ESTOI length-30
    row/column-normalized segment correlations).
  - PESQ (ITU-T P.862.2 wideband): delegated to the `pesq` C extension when
    available (the reference's dependency), otherwise scored by the native
    implementation in `pesq_native.py` (validated by identity/monotonicity/
    invariance anchors and real VBD mixtures — see its conformance statement).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.signal
import scipy.stats

# ----------------------------------------------------------------- SI-SDR etc.


def si_sdr_components(s_hat, s, n):
    """Decompose an estimate into target/noise/artifact parts (utils.py:10-28)."""
    alpha_s = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    s_target = alpha_s * s

    alpha_n = np.dot(s_hat, n) / np.linalg.norm(n) ** 2
    e_noise = alpha_n * n

    e_art = s_hat - s_target - e_noise
    return s_target, e_noise, e_art


def energy_ratios(s_hat, s, n):
    """SI-SDR / SI-SIR / SI-SAR (utils.py:30-39)."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    si_sdr_ = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise + e_art) ** 2)
    si_sir = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise) ** 2)
    si_sar = 10 * np.log10(np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_art) ** 2)
    return si_sdr_, si_sir, si_sar


def si_sdr(s, s_hat):
    """Scale-invariant SDR (utils.py:67-75)."""
    alpha = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    return 10 * np.log10(
        np.linalg.norm(alpha * s) ** 2 / np.linalg.norm(alpha * s - s_hat) ** 2
    )


def mean_conf_int(data, confidence=0.95):
    a = 1.0 * np.array(data)
    n = len(a)
    m, se = np.mean(a), scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, n - 1)
    return m, h


def mean_std(data):
    data = np.asarray(data)
    data = data[~np.isnan(data)]
    return np.mean(data), np.std(data)


def print_mean_std(data, decimal=2):
    mean, std = mean_std(np.array(data))
    if decimal == 2:
        return f"{mean:.2f} ± {std:.2f}"
    elif decimal == 1:
        return f"{mean:.1f} ± {std:.1f}"
    return f"{mean} ± {std}"


def hp_filter(signal, cut_off=80, order=10, sr=16000):
    """Butterworth high-pass (utils.py:61-65)."""
    factor = cut_off / sr * 2
    sos = scipy.signal.butter(order, factor, "hp", output="sos")
    return scipy.signal.sosfilt(sos, signal)


def snr_dB(s, n):
    s_power = np.sum(np.abs(s) ** 2) / len(s)
    n_power = np.sum(np.abs(n) ** 2) / len(n)
    return 10 * np.log10(s_power / n_power)


# --------------------------------------------------------------- active RMS


def active_rms(clean, noise, fs=16000, energy_thresh=-50):
    """Clean/noise RMS over active (energetic) 100 ms windows
    (util/inference.py:30-64)."""
    window_size = 100  # ms
    window_samples = int(fs * window_size / 1000)
    clean = np.asarray(clean).squeeze()
    noise = np.asarray(noise).squeeze()

    noise_active, clean_active = [], []
    sample_start = 0
    thresh = 10 ** (energy_thresh / 20) * (np.max(np.abs(noise)) + np.finfo(float).eps)
    while sample_start < len(noise):
        sample_end = min(sample_start + window_samples, len(noise))
        noise_win = noise[sample_start:sample_end]
        clean_win = clean[sample_start:sample_end]
        if np.sqrt(np.mean(noise_win**2)) > thresh:
            noise_active.append(noise_win)
            clean_active.append(clean_win)
        sample_start += window_samples

    noise_rms = (
        np.sqrt(np.mean(np.concatenate(noise_active) ** 2))
        if noise_active
        else np.finfo(float).eps
    )
    clean_rms = (
        np.sqrt(np.mean(np.concatenate(clean_active) ** 2))
        if clean_active
        else np.finfo(float).eps
    )
    return clean_rms, noise_rms


def calculate_snr(signal, noise):
    s, n = active_rms(signal, noise)
    return n / s


def calculate_normfac(signal, noise):
    s, n = active_rms(signal, noise)
    return (2**0.5) / ((1 + (n / s) ** 2) ** 0.5)


# -------------------------------------------------------------- STOI / ESTOI

_STOI_FS = 10000
_N_FRAME = 256
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150
_N_SEG = 30
_BETA = -15.0
_DYN_RANGE = 40
_EPS = np.finfo(np.float64).eps


def _thirdoct(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = np.argmin(np.square(f - freq_low[i]))
        fh_ii = np.argmin(np.square(f - freq_high[i]))
        obm[i, fl_ii:fh_ii] = 1
    return obm


def _frame(x, framelen, hop, window):
    n = 1 + (len(x) - framelen) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(framelen)[None, :]
    return x[idx] * window


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = np.hanning(framelen + 2)[1:-1]
    x_frames = _frame(x, framelen, hop, w)
    y_frames = _frame(y, framelen, hop, w)
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + _EPS)
    mask = (np.max(energies) - dyn_range - energies) < 0
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    n = len(x_frames)
    if n == 0:
        return x[:0], y[:0]
    out_len = (n - 1) * hop + framelen
    x_sil = np.zeros(out_len)
    y_sil = np.zeros(out_len)
    for i in range(n):
        x_sil[i * hop : i * hop + framelen] += x_frames[i]
        y_sil[i * hop : i * hop + framelen] += y_frames[i]
    return x_sil, y_sil


def _stft_mag(x, framelen, hop, nfft):
    w = np.hanning(framelen + 2)[1:-1]
    frames = _frame(x, framelen, hop, w)
    return np.abs(np.fft.rfft(frames, n=nfft, axis=1)).T  # [F, T]


def _resample(x, fs_in, fs_out):
    if fs_in == fs_out:
        return x
    g = np.gcd(int(fs_in), int(fs_out))
    return scipy.signal.resample_poly(x, int(fs_out) // g, int(fs_in) // g)


def _row_col_normalize(x):
    """Row then column zero-mean/unit-norm normalization of segment stacks
    [M, J, N] (the ESTOI normalization of Jensen & Taal 2016)."""
    x = x - np.mean(x, axis=-1, keepdims=True)
    x = x / (np.linalg.norm(x, axis=-1, keepdims=True) + _EPS)
    x = x - np.mean(x, axis=1, keepdims=True)
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + _EPS)
    return x


def stoi(x, y, fs_sig, extended=False):
    """(E)STOI intelligibility measure of degraded `y` against clean `x`.

    Native implementation of the algorithm the reference scores with
    (`pystoi.stoi`, util/inference.py:316).
    """
    x = np.asarray(x, dtype=np.float64).squeeze()
    y = np.asarray(y, dtype=np.float64).squeeze()
    if x.shape != y.shape:
        raise ValueError("x and y should have the same length")

    x = _resample(x, fs_sig, _STOI_FS)
    y = _resample(y, fs_sig, _STOI_FS)
    x, y = _remove_silent_frames(x, y, _DYN_RANGE, _N_FRAME, _N_FRAME // 2)
    if len(x) < _N_FRAME:
        warnings.warn("Not enough active frames for STOI")
        return np.nan

    x_spec = _stft_mag(x, _N_FRAME, _N_FRAME // 2, _NFFT)
    y_spec = _stft_mag(y, _N_FRAME, _N_FRAME // 2, _NFFT)
    obm = _thirdoct(_STOI_FS, _NFFT, _NUM_BANDS, _MIN_FREQ)
    x_tob = np.sqrt(obm @ (x_spec**2))  # [J, T]
    y_tob = np.sqrt(obm @ (y_spec**2))
    T = x_tob.shape[1]
    if T < _N_SEG:
        warnings.warn("Not enough frames for STOI segments")
        return np.nan

    if extended:
        x_seg = np.array([x_tob[:, m - _N_SEG : m] for m in range(_N_SEG, T + 1)])
        y_seg = np.array([y_tob[:, m - _N_SEG : m] for m in range(_N_SEG, T + 1)])
        x_n = _row_col_normalize(x_seg)
        y_n = _row_col_normalize(y_seg)
        return float(np.sum(x_n * y_n / _N_SEG) / x_n.shape[0])

    # classic STOI: band-wise clipped correlation per segment
    d_sum = 0.0
    count = 0
    c = 10 ** (-_BETA / 20)
    for m in range(_N_SEG, T + 1):
        xm = x_tob[:, m - _N_SEG : m]
        ym = y_tob[:, m - _N_SEG : m]
        alpha = np.sqrt(
            np.sum(xm**2, axis=1, keepdims=True) / (np.sum(ym**2, axis=1, keepdims=True) + _EPS)
        )
        ym_hat = np.minimum(alpha * ym, xm * (1 + c))
        xn = xm - np.mean(xm, axis=1, keepdims=True)
        yn = ym_hat - np.mean(ym_hat, axis=1, keepdims=True)
        corr = np.sum(xn * yn, axis=1) / (
            np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + _EPS
        )
        d_sum += np.sum(corr)
        count += corr.size
    return float(d_sum / count)


def estoi(x, y, fs_sig):
    return stoi(x, y, fs_sig, extended=True)


# ----------------------------------------------------------------------- PESQ

try:  # the reference's scoring dependency (C extension), preferred if present
    from pesq import pesq as _pesq  # type: ignore

    HAS_PESQ = True
except Exception:  # pragma: no cover
    _pesq = None
    HAS_PESQ = True  # native implementation below always available


def pesq_wb(sr, ref, deg):
    """Wideband PESQ MOS-LQO (ITU-T P.862.2) of degraded `deg` vs clean `ref`.

    Uses the ITU `pesq` C extension when installed (the reference's scoring
    dependency, util/inference.py:314); otherwise the native implementation in
    `pesq_native.py` (see its conformance statement). NaN on scoring failure
    (e.g. all-silent input), matching the wheel's error behavior."""
    if _pesq is not None:
        try:
            return float(_pesq(sr, np.asarray(ref), np.asarray(deg), "wb"))
        except Exception:
            return float("nan")
    from .pesq_native import pesq_wb_native

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pesq_wb_native(ref, deg, fs=sr)
    except ValueError:
        return float("nan")
