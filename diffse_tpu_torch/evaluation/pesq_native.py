"""Native wideband PESQ (ITU-T P.862.2), pure numpy, no external wheel: the
port's own copy of diffse_tpu/evaluation/pesq_native.py.

The reference framework scores every validation/eval pass with the `pesq`
C-extension (sgmse/util/inference.py:314, eval.py:149) and the project's
headline quality target is stated in PESQ (BASELINE.md). Where that wheel is
not installed (as on the H100 machines the port runs on), this module
implements the P.862 algorithm with the P.862.2 wideband extensions from the
published standard:

  stage 1  level alignment      both signals scaled to a target active power
                                measured through a 350-3250 Hz bandpass
  stage 2  input filtering      P.862.2 wideband IIR (high-pass + HF emphasis)
  stage 3  time alignment       envelope VAD -> crude whole-signal alignment
                                -> per-utterance fine alignment via windowed
                                cross-correlation histograms
  stage 4  perceptual model     32 ms / 50% overlap power spectra -> 49-band
                                Bark pitch densities -> frequency-response and
                                short-term gain compensation -> Zwicker
                                loudness -> asymmetric + symmetric disturbance
  stage 5  cognitive model      L6 norm over 20-frame syllables, L2 over time,
                                raw PESQ = 4.5 - 0.1 D - 0.0309 DA, mapped to
                                MOS-LQO by the P.862.2 logistic

Conformance statement: the structure, constants, and tables follow the
published standard and are enforced self-consistent by tests
(the JAX package's tests/test_pesq.py: identity anchor =~4.64 max MOS-LQO, noise monotonicity,
level and delay invariance, mid-utterance delay-jump splitting, table
partition invariants; tests/test_torch_metrics.py holds this copy to it).
Bit-exact ITU conformance is not certified (no conformance dataset or
reference binary was at hand).
Both time-varying-delay paths of the standard are implemented: utterances are
re-split when their internal delay jumps (_split_utterances/_split_align,
the standard's utterance_split), and bad-interval re-alignment recomputes
both the symmetric and asymmetric disturbances at the re-aligned delay. For
time-synchronized speech-enhancement scoring neither path is normally
exercised.
"""

from __future__ import annotations

import warnings

import numpy as np

from .pesq_tables import (
    ABS_THRESH_POWER,
    ALIGN_FILTER_DB,
    CENTRE_OF_BAND_BARK,
    NB,
    NR_OF_HZ_BANDS_PER_BARK_BAND,
    POW_DENS_CORRECTION_FACTOR,
    WB_INPUT_IIR_SOS_16K,
    WIDTH_OF_BAND_BARK,
)

# ----------------------------------------------------------------- constants
FS = 16000
DOWNSAMPLE = 64          # envelope decimation for VAD/alignment
NF = 512                 # perceptual-model frame (32 ms), 50% overlap
ALIGN_NFFT = 1024        # fine time-alignment frame
SEARCHBUFFER = 75        # alignment search buffer, in DOWNSAMPLE units
DATAPADDING = 320 * (FS // 1000)  # 320 ms zero padding appended
TARGET_AVG_POWER = 1e7
SP = 6.910853e-6         # power scaling of the pitch densities (16 kHz)
SL = 1.866055e-1         # loudness scaling (16 kHz)
MIN_SCALE, MAX_SCALE = 3e-4, 5.0
ZWICKER_POWER = 0.23
D_POW_F, A_POW_F = 2.0, 1.0
D_WEIGHT, A_WEIGHT = 0.1, 0.0309
THRESHOLD_BAD_FRAMES = 30.0
N_PSQM_FRAMES_PER_SYLLABLE = 20
MINUTTLENGTH = 50        # minimum utterance, in DOWNSAMPLE units (200 ms)
MINSPEECHLGTH = 4        # minimum speech burst kept by the VAD smoother
JOINSPEECHLGTH = 50      # join gap for weak segments at high SNR

_BUF = SEARCHBUFFER * DOWNSAMPLE  # search-buffer padding, in samples


# -------------------------------------------------------------- stage 1 + 2
def _apply_align_filter(data: np.ndarray) -> np.ndarray:
    """FFT-domain piecewise-linear dB bandpass used only to weight the level
    measurement (350..3250 Hz passband)."""
    n = len(data)
    n_fft = 1 << int(np.ceil(np.log2(n)))
    spec = np.fft.rfft(data, n_fft)
    freqs = np.arange(len(spec)) * (FS / n_fft)
    gain_db = np.interp(freqs, ALIGN_FILTER_DB[:, 0], ALIGN_FILTER_DB[:, 1])
    out = np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), n_fft)
    return out[:n]


def _fix_power_level(data: np.ndarray, n_samples: int, max_n_samples: int) -> np.ndarray:
    """Scale the signal so its bandpass-weighted power over the active region
    equals TARGET_AVG_POWER."""
    filtered = _apply_align_filter(data)
    lo = _BUF
    hi = max_n_samples - _BUF + DATAPADDING
    seg = filtered[lo:hi]
    power = float(np.sum(seg * seg)) / max(len(seg), 1)
    if power <= 0:
        return data
    return data * np.sqrt(TARGET_AVG_POWER / power)


def _wb_input_filter(data: np.ndarray) -> np.ndarray:
    """P.862.2 wideband input characteristic: one IIR biquad."""
    b0, b1, b2, a1, a2 = WB_INPUT_IIR_SOS_16K
    import scipy.signal

    return scipy.signal.lfilter([b0, b1, b2], [1.0, a1, a2], data)


# ------------------------------------------------------------------ stage 3
def _apply_vad(data: np.ndarray, n_samples: int):
    """Energy VAD on DOWNSAMPLE-sample windows with iterative noise-floor
    threshold. Returns (vad, log_vad); silence is marked by vad <= 0."""
    n_windows = n_samples // DOWNSAMPLE
    frames = data[: n_windows * DOWNSAMPLE].reshape(n_windows, DOWNSAMPLE)
    vad = np.mean(frames * frames, axis=1)

    level_min = float(np.max(vad)) * 1.0e-4
    if level_min < 1.0e-4:
        level_min = 1.0e-4
    vad = np.maximum(vad, level_min)
    level_thresh = float(np.mean(vad))

    for _ in range(12):
        noise = vad[vad <= level_thresh]
        if len(noise) > 0:
            level_noise = float(np.mean(noise))
            std_noise = float(np.sqrt(np.mean((noise - level_noise) ** 2)))
        else:
            level_noise, std_noise = 0.0, 0.0
        level_thresh = 1.001 * (level_noise + 2.0 * std_noise)

    sig = vad[vad > level_thresh]
    noi = vad[vad <= level_thresh]
    level_sig = float(np.mean(sig)) if len(sig) else 0.0
    level_noise = float(np.mean(noi)) if len(noi) else 1.0
    if len(sig) == 0:
        # no window ever exceeded the noise floor: the signal is silence
        vad = -np.abs(vad)
        return vad, np.zeros_like(vad)

    vad = np.where(vad <= level_thresh, -vad, vad)
    vad[0] = -level_min
    vad[-1] = -level_min

    # drop too-short speech bursts
    start = 0
    for count in range(1, n_windows):
        if vad[count] > 0.0 and vad[count - 1] <= 0.0:
            start = count
        if (vad[count] <= 0.0 or count == n_windows - 1) and vad[count - 1] > 0.0:
            finish = count
            if (finish - start) <= MINSPEECHLGTH:
                vad[start:finish] = -np.abs(vad[start:finish])

    # at high global SNR, demote weak speech segments to silence
    if level_sig >= level_noise * 1000.0:
        start = 0
        for count in range(1, n_windows):
            if vad[count] > 0.0 and vad[count - 1] <= 0.0:
                start = count
            if vad[count] <= 0.0 and vad[count - 1] > 0.0:
                finish = count
                g = float(np.sum(vad[start:finish]))
                if g < 3.0 * level_thresh * (finish - start):
                    vad[start:finish] = -np.abs(vad[start:finish])

    log_vad = np.where(vad > 0.0, np.log(np.maximum(vad, 1e-30) / max(level_thresh, 1e-30)), 0.0)
    return vad, log_vad


def _crude_align(ref_log_vad: np.ndarray, deg_log_vad: np.ndarray,
                 startr: int, endr: int, startd: int, endd: int) -> int:
    """Cross-correlate log-VAD envelopes; returns the delay of deg relative to
    ref in DOWNSAMPLE units (deg index ~= ref index + delay)."""
    x_r = ref_log_vad[startr:endr]
    x_d = deg_log_vad[startd:endd]
    if len(x_r) == 0 or len(x_d) == 0:
        return 0
    corr = np.correlate(x_d, x_r, mode="full")
    if float(np.max(corr)) <= 0.0:
        return 0
    return int(np.argmax(corr)) - (len(x_r) - 1) + (startd - startr)


def _id_utterances(vad: np.ndarray):
    """Speech spans from the VAD, in DOWNSAMPLE units, keeping spans of at
    least MINUTTLENGTH. Returns list of (start, end)."""
    n = len(vad)
    spans = []
    speech = False
    start = 0
    for count in range(n):
        if vad[count] > 0.0 and not speech:
            speech = True
            start = count
        if (vad[count] <= 0.0 or count == n - 1) and speech:
            speech = False
            if count - start >= MINUTTLENGTH:
                spans.append((start, count))
    return spans


def _frame_align_hists(ref: np.ndarray, deg: np.ndarray, startr: int,
                       endr: int, crude_delay: int):
    """Per-frame alignment histograms: Hann-windowed circular
    cross-correlation of ALIGN_NFFT frames, magnitudes compressed by ^0.125,
    each triangular-smeared into its own length-ALIGN_NFFT histogram.
    Returns (hists [n_frames, ALIGN_NFFT], ref-sample frame starts)."""
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(ALIGN_NFFT) / (ALIGN_NFFT - 1)))
    kernel = ALIGN_NFFT // 64

    pos_r = startr
    pos_d = startr + crude_delay
    if pos_d < 0:
        pos_r -= pos_d
        pos_d = 0
    hists, positions = [], []
    while pos_r + ALIGN_NFFT <= endr and pos_d + ALIGN_NFFT <= len(deg):
        x1 = ref[pos_r : pos_r + ALIGN_NFFT] * window
        x2 = deg[pos_d : pos_d + ALIGN_NFFT] * window
        X1 = np.fft.rfft(x1)
        X2 = np.fft.rfft(x2)
        corr = np.fft.irfft(np.conj(X1) * X2, ALIGN_NFFT)
        v = np.abs(corr) ** 0.125
        v_max = float(np.max(v)) * 0.99
        idxs = np.nonzero(v > v_max)[0]
        hist = np.zeros(ALIGN_NFFT)
        for i in idxs:
            for k in range(1 - kernel, kernel):
                hist[(i + k) % ALIGN_NFFT] += v[i] * (1.0 - abs(k) / kernel)
        hists.append(hist)
        positions.append(pos_r)
        pos_r += ALIGN_NFFT // 4
        pos_d += ALIGN_NFFT // 4
    if hists:
        return np.stack(hists), np.asarray(positions)
    return np.zeros((0, ALIGN_NFFT)), np.zeros(0, dtype=np.int64)


def _hist_peak(hist: np.ndarray):
    """(delay_shift, confidence) of one accumulated alignment histogram."""
    total = float(np.sum(hist))
    if total <= 0.0:
        return 0, 0.0
    best = int(np.argmax(hist))
    shift = best if best < ALIGN_NFFT // 2 else best - ALIGN_NFFT
    conf = float(np.max(hist)) / (total / ALIGN_NFFT)
    return shift, conf


def _time_align(ref: np.ndarray, deg: np.ndarray, startr: int, endr: int,
                crude_delay: int):
    """Fine per-utterance alignment: the summed per-frame histograms.
    Returns (delay_samples, confidence)."""
    hists, _ = _frame_align_hists(ref, deg, startr, endr, crude_delay)
    if len(hists) == 0:
        return crude_delay, 0.0
    shift, conf = _hist_peak(np.sum(hists, axis=0))
    if conf <= 0.0:
        return crude_delay, 0.0
    return crude_delay + shift, conf


MAX_UTTERANCES = 50


def _split_align(ref: np.ndarray, deg: np.ndarray, start_sample: int,
                 end_sample: int, delay: int):
    """Detect a mid-utterance delay jump (the standard's split_align): build
    the per-frame alignment histograms once, find the frame boundary that
    maximizes the combined peak confidence of the two halves, and accept the
    split only when both halves are individually better-peaked than the joint
    histogram (a genuine jump splits the joint peak's mass in two) and their
    delay estimates materially differ. Returns (split_sample, delay1, delay2)
    or None."""
    hists, positions = _frame_align_hists(ref, deg, start_sample, end_sample,
                                          delay)
    n = len(hists)
    # each half must be a viable utterance on its own (MINUTTLENGTH)
    min_frames = max(4, (MINUTTLENGTH * DOWNSAMPLE) // (ALIGN_NFFT // 4))
    if n < 2 * min_frames:
        return None
    _, conf_all = _hist_peak(np.sum(hists, axis=0))
    prefix = np.cumsum(hists, axis=0)
    total = prefix[-1]
    best = None
    for k in range(min_frames, n - min_frames + 1):
        left = prefix[k - 1]
        s1, c1 = _hist_peak(left)
        s2, c2 = _hist_peak(total - left)
        if best is None or c1 + c2 > best[0]:
            best = (c1 + c2, k, s1, c1, s2, c2)
    _, k, s1, c1, s2, c2 = best
    if c1 <= 1.1 * conf_all or c2 <= 1.1 * conf_all or min(c1, c2) <= 2.0:
        return None
    if abs(s1 - s2) < DOWNSAMPLE:  # < 4 ms: not a material jump
        return None
    return int(positions[k]), delay + s1, delay + s2


def _split_utterances(ref: np.ndarray, deg: np.ndarray, utterances, delays):
    """Iteratively re-split utterances whose internal delay jumps (the
    standard's utterance_split pass). Each accepted split strictly shrinks
    both halves, so this terminates; capped at MAX_UTTERANCES as in the
    standard."""
    i = 0
    while i < len(utterances) and len(utterances) < MAX_UTTERANCES:
        s, e = utterances[i]
        sp = _split_align(ref, deg, s, e, delays[i])
        if sp is None:
            i += 1
            continue
        split_sample, d1, d2 = sp
        utterances[i] = (s, split_sample)
        delays[i] = d1
        utterances.insert(i + 1, (split_sample, e))
        delays.insert(i + 1, d2)
        # stay on i: the first half may contain a further jump
    return utterances, delays


def _utterance_locate(ref: np.ndarray, deg: np.ndarray, n_samples: int):
    """VAD -> crude whole-signal alignment -> utterances -> per-utterance fine
    alignment -> re-split on mid-utterance delay jumps (utterance_split).
    Returns (utterances, delays) with utterances as sample spans."""
    ref_vad, ref_log_vad = _apply_vad(ref, n_samples)
    deg_vad, deg_log_vad = _apply_vad(deg, n_samples)

    whole_delay = _crude_align(ref_log_vad, deg_log_vad, 0, len(ref_log_vad),
                               0, len(deg_log_vad))
    spans = _id_utterances(ref_vad)
    if not spans:
        return [], []

    utterances, delays = [], []
    n_units = len(ref_vad)
    for (s, e) in spans:
        # crude per-utterance refinement within a search window around the
        # whole-signal estimate
        ws = max(s - SEARCHBUFFER, 0)
        we = min(e + SEARCHBUFFER, n_units)
        ds = max(ws + whole_delay, 0)
        de = min(we + whole_delay, n_units)
        utt_crude = _crude_align(ref_log_vad, deg_log_vad, ws, we, ds, de)
        crude_samples = utt_crude * DOWNSAMPLE

        start_sample = max(s * DOWNSAMPLE, _BUF)
        end_sample = min(e * DOWNSAMPLE, n_samples - _BUF)
        delay, conf = _time_align(ref, deg, start_sample, end_sample, crude_samples)
        if conf <= 1.0:  # uninformative histogram: keep the crude estimate
            delay = crude_samples
        utterances.append((start_sample, end_sample))
        delays.append(delay)
    return _split_utterances(ref, deg, utterances, delays)


# ------------------------------------------------------------------ stage 4
_MODEL_WINDOW = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(NF) / (NF - 1)))


def _hz_spectrum(data: np.ndarray, start: int) -> np.ndarray:
    """Power spectrum of one Hann-windowed 512-sample frame; DC is zeroed."""
    frame = data[start : start + NF] * _MODEL_WINDOW
    spec = np.fft.rfft(frame)
    power = (spec.real**2 + spec.imag**2)[: NF // 2]
    power[0] = 0.0
    return power


def _freq_warping(hz_power: np.ndarray) -> np.ndarray:
    """Group 31.25 Hz bins into the 49 Bark bands (pitch power densities)."""
    edges = np.concatenate([[0], np.cumsum(NR_OF_HZ_BANDS_PER_BARK_BAND)])
    sums = np.add.reduceat(hz_power, edges[:-1])
    return sums * POW_DENS_CORRECTION_FACTOR * SP


def _total_audible(pitch_pow_dens: np.ndarray, factor: float) -> float:
    """Sum of band powers above factor * absolute threshold (bands 1..Nb-1)."""
    h = pitch_pow_dens[1:]
    mask = h > factor * ABS_THRESH_POWER[1:]
    return float(np.sum(h[mask]))


def _time_avg_audible(pitch_pow_dens: np.ndarray, silent: np.ndarray,
                      total_number_of_frames: int) -> np.ndarray:
    """Per-band average of audible (>100x threshold) power over speech-active
    frames, normalized by the total frame count."""
    active = pitch_pow_dens[~silent]  # [frames, Nb]
    if len(active) == 0:
        return np.zeros(NB)
    audible = np.where(active > 100.0 * ABS_THRESH_POWER, active, 0.0)
    return np.sum(audible, axis=0) / total_number_of_frames


def _intensity_warping(pitch_pow_dens: np.ndarray) -> np.ndarray:
    """Bark power -> loudness density (Zwicker law with the low-band exponent
    modification). Vectorized over [frames, Nb]."""
    h = np.where(CENTRE_OF_BAND_BARK < 4.0, 6.0 / (CENTRE_OF_BAND_BARK + 2.0), 1.0)
    h = np.minimum(h, 2.0) ** 0.15
    zwicker = ZWICKER_POWER * h
    thresh = ABS_THRESH_POWER
    loud = ((thresh / 0.5) ** zwicker) * ((0.5 + 0.5 * pitch_pow_dens / thresh) ** zwicker - 1.0)
    loud = np.where(pitch_pow_dens > thresh, loud, 0.0)
    return loud * SL


def _pseudo_lp(d: np.ndarray, p: float) -> float:
    """Width-weighted Lp over bands 1..Nb-1."""
    h = np.abs(d[1:])
    w = WIDTH_OF_BAND_BARK[1:]
    total_weight = float(np.sum(w))
    result = float(np.sum((h * w) ** p))
    return (result / total_weight) ** (1.0 / p) * total_weight


def _asymmetry_factor(pitch_ref: np.ndarray, pitch_deg: np.ndarray) -> np.ndarray:
    ratio = (pitch_deg + 50.0) / (pitch_ref + 50.0)
    h = ratio**1.2
    h = np.minimum(h, 12.0)
    return np.where(h < 3.0, 0.0, h)


def _lpq_weight(frame_disturbance: np.ndarray, time_weight: np.ndarray,
                power_syllable: float = 6.0, power_time: float = 2.0) -> float:
    """L(power_syllable) over half-overlapped 20-frame syllables, then
    time-weighted L(power_time) over syllables."""
    n = len(frame_disturbance)
    result_time = 0.0
    total_weight = 0.0
    for start in range(0, n, N_PSQM_FRAMES_PER_SYLLABLE // 2):
        chunk = frame_disturbance[start : start + N_PSQM_FRAMES_PER_SYLLABLE]
        count = N_PSQM_FRAMES_PER_SYLLABLE
        syl = (float(np.sum(chunk**power_syllable)) / count) ** (1.0 / power_syllable)
        w = float(time_weight[start])
        result_time += (w * syl) ** power_time
        total_weight += w**power_time
    if total_weight <= 0:
        return 0.0
    return (result_time / total_weight) ** (1.0 / power_time)


def _frame_delay_map(n_frames: int, utterances, delays, max_n_samples: int):
    """Per-frame deg offset from the per-utterance delays (frames in the gaps
    inherit the previous utterance's delay)."""
    frame_delay = np.zeros(n_frames, dtype=np.int64)
    if not utterances:
        return frame_delay
    current = delays[0]
    starts = [u[0] for u in utterances]
    for frame in range(n_frames):
        start_sample = _BUF + frame * (NF // 2)
        for utt_idx, s in enumerate(starts):
            if start_sample >= s:
                current = delays[utt_idx]
        frame_delay[frame] = current
    return frame_delay


def _deg_spectrum(deg: np.ndarray, start_sample: int, buf_len: int) -> np.ndarray:
    if 0 <= start_sample and start_sample + NF <= buf_len:
        return _hz_spectrum(deg, start_sample)
    return np.zeros(NF // 2)


def _compute_disturbance(loud_ref: np.ndarray, loud_deg: np.ndarray):
    """Symmetric disturbance density with the 0.25*min deadzone."""
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    return np.where(d > m, d - m, np.where(d < -m, d + m, 0.0))


def _psychoacoustic_model(ref: np.ndarray, deg: np.ndarray, n_samples: int,
                          utterances, delays):
    n_frames = (n_samples - 2 * _BUF) // (NF // 2) - 1
    if n_frames < 1:
        raise ValueError("signal too short for PESQ (need > 0.65 s)")
    buf_len = len(deg)
    frame_delay = _frame_delay_map(n_frames, utterances, delays, n_samples)

    pitch_ref = np.zeros((n_frames, NB))
    pitch_deg = np.zeros((n_frames, NB))
    for frame in range(n_frames):
        start_ref = _BUF + frame * (NF // 2)
        pitch_ref[frame] = _freq_warping(_hz_spectrum(ref, start_ref))
        start_deg = start_ref + int(frame_delay[frame])
        pitch_deg[frame] = _freq_warping(_deg_spectrum(deg, start_deg, buf_len))

    total_ref_1e2 = np.array([_total_audible(pitch_ref[f], 1e2) for f in range(n_frames)])
    silent = total_ref_1e2 < 1e7

    avg_ref = _time_avg_audible(pitch_ref, silent, n_frames)
    avg_deg = _time_avg_audible(pitch_deg, silent, n_frames)

    # frequency-response compensation: scale the reference toward the
    # degraded signal's average response (clipped linear factor)
    comp = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    mod_pitch_ref = pitch_ref * comp[None, :]

    frame_disturbance = np.zeros(n_frames)
    frame_disturbance_asym = np.zeros(n_frames)
    total_audible_pow_ref = np.zeros(n_frames)
    old_scale = 1.0
    scales = np.zeros(n_frames)
    for frame in range(n_frames):
        t_ref = _total_audible(mod_pitch_ref[frame], 1.0)
        t_deg = _total_audible(pitch_deg[frame], 1.0)
        total_audible_pow_ref[frame] = t_ref

        scale = (t_ref + 5e3) / (t_deg + 5e3)
        if frame > 0:
            scale = 0.2 * old_scale + 0.8 * scale
        old_scale = scale
        scales[frame] = float(np.clip(scale, MIN_SCALE, MAX_SCALE))
        pitch_deg[frame] *= scales[frame]

    loud_ref = _intensity_warping(mod_pitch_ref)
    loud_deg = _intensity_warping(pitch_deg)

    for frame in range(n_frames):
        d = _compute_disturbance(loud_ref[frame], loud_deg[frame])
        frame_disturbance[frame] = _pseudo_lp(d, D_POW_F)
        da = d * _asymmetry_factor(pitch_ref[frame], pitch_deg[frame])
        frame_disturbance_asym[frame] = _pseudo_lp(da, A_POW_F)

    # weight by the reference frame power, clip at 45
    h = ((total_audible_pow_ref + 1e5) / 1e7) ** 0.04
    frame_disturbance = np.minimum(frame_disturbance / h, 45.0)
    frame_disturbance_asym = np.minimum(frame_disturbance_asym / h, 45.0)

    frame_disturbance, frame_disturbance_asym = _bad_interval_realignment(
        ref, deg, n_samples, frame_delay, mod_pitch_ref, comp, scales, h,
        frame_disturbance, loud_ref, pitch_ref, frame_disturbance_asym,
    )

    # long-file time weighting (uniform below ~16 s of frames)
    time_weight = np.ones(n_frames)
    if n_frames > 1000:
        factor = min((n_frames - 1000.0) / 5500.0, 0.5)
        time_weight = 1.0 - factor + factor * np.arange(n_frames) / n_frames

    d_indicator = _lpq_weight(frame_disturbance, time_weight)
    a_indicator = _lpq_weight(frame_disturbance_asym, time_weight)
    return 4.5 - D_WEIGHT * d_indicator - A_WEIGHT * a_indicator


def _bad_interval_realignment(ref, deg, n_samples, frame_delay, mod_pitch_ref,
                              comp, scales, h_weight, frame_disturbance,
                              loud_ref, pitch_ref, frame_disturbance_asym):
    """Re-align intervals of consecutive badly-disturbed frames and keep the
    minimum disturbance, so scoring is robust to residual time-alignment error
    (the standard's bad-frame reprocessing). Both the symmetric and the
    asymmetric per-frame disturbances are recomputed at the re-aligned delay
    (the delay search itself minimizes the symmetric disturbance, as in the
    standard)."""
    n_frames = len(frame_disturbance)
    bad = frame_disturbance > THRESHOLD_BAD_FRAMES
    if not np.any(bad):
        return frame_disturbance, frame_disturbance_asym

    # contiguous bad intervals of at least 5 frames
    intervals = []
    start = None
    for f in range(n_frames):
        if bad[f] and start is None:
            start = f
        if (not bad[f] or f == n_frames - 1) and start is not None:
            end = f + 1 if (bad[f] and f == n_frames - 1) else f
            if end - start >= 5:
                intervals.append((start, end))
            start = None

    buf_len = len(deg)
    for (fs_, fe_) in intervals:
        s_ref = _BUF + fs_ * (NF // 2)
        e_ref = min(_BUF + fe_ * (NF // 2) + NF, n_samples)
        base_delay = int(frame_delay[fs_])
        s_deg = s_ref + base_delay
        search = NF  # +- one frame of extra delay search
        lo = max(s_deg - search, 0)
        hi = min(e_ref + base_delay + search, buf_len)
        if hi - lo <= e_ref - s_ref:
            continue
        seg_ref = ref[s_ref:e_ref]
        seg_deg = deg[lo:hi]
        corr = np.correlate(seg_deg, seg_ref, mode="valid")
        if corr.size == 0 or float(np.max(np.abs(corr))) <= 0.0:
            continue
        new_delay = lo + int(np.argmax(corr)) - s_ref

        for f in range(fs_, fe_):
            start_ref = _BUF + f * (NF // 2)
            start_deg = start_ref + new_delay
            p_deg = _freq_warping(_deg_spectrum(deg, start_deg, buf_len)) * scales[f]
            l_deg = _intensity_warping(p_deg[None, :])[0]
            d = _compute_disturbance(loud_ref[f], l_deg)
            new_dist = min(_pseudo_lp(d, D_POW_F) / h_weight[f], 45.0)
            if new_dist < frame_disturbance[f]:
                frame_disturbance[f] = new_dist
                da = d * _asymmetry_factor(pitch_ref[f], p_deg)
                frame_disturbance_asym[f] = min(
                    _pseudo_lp(da, A_POW_F) / h_weight[f], 45.0)
    return frame_disturbance, frame_disturbance_asym


# ------------------------------------------------------------------ stage 5
def _mos_lqo_wb(raw_pesq: float) -> float:
    """P.862.2 wideband raw-score -> MOS-LQO logistic mapping."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw_pesq + 3.8224))


def pesq_wb_native(ref, deg, fs: int = 16000) -> float:
    """Wideband PESQ MOS-LQO of degraded `deg` against reference `ref`.

    Mirrors `pesq.pesq(fs, ref, deg, 'wb')` (the reference's scoring call,
    sgmse/util/inference.py:314). 16 kHz only.
    """
    if fs != FS:
        raise ValueError(f"wideband PESQ requires fs=16000, got {fs}")
    ref = np.asarray(ref, dtype=np.float64).squeeze()
    deg = np.asarray(deg, dtype=np.float64).squeeze()
    if ref.ndim != 1 or deg.ndim != 1:
        raise ValueError("ref/deg must be 1-D waveforms")

    n = max(len(ref), len(deg))
    n_samples = n + 2 * _BUF
    if n < NF * 2:
        raise ValueError("signal too short for PESQ (need > 64 ms)")

    def _buffer(x):
        buf = np.zeros(n_samples + DATAPADDING)
        buf[_BUF : _BUF + len(x)] = x
        return buf

    ref_b = _buffer(ref)
    deg_b = _buffer(deg)

    ref_b = _fix_power_level(ref_b, n_samples, n_samples)
    deg_b = _fix_power_level(deg_b, n_samples, n_samples)

    ref_b = _wb_input_filter(ref_b)
    deg_b = _wb_input_filter(deg_b)

    utterances, delays = _utterance_locate(ref_b, deg_b, n_samples)
    if not utterances:
        warnings.warn("PESQ: no speech detected in the reference signal")
        return float("nan")

    raw = _psychoacoustic_model(ref_b, deg_b, n_samples, utterances, delays)
    return float(_mos_lqo_wb(raw))
