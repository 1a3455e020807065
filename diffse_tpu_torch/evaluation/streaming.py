"""Overlap-chunked streaming enhancement (port of
diffse_tpu/evaluation/streaming.py).

- ``enhance_streamed`` chunks the waveform: every chunk of ``chunk_frames``
  is enhanced as one row of a batch by the eval harness's function
  (``inference._eval_fn``) and the chunk waveforms are overlap-added with
  linear cross-fades.
- ``enhance_streamed_packed`` is the fleet serving engine. Every utterance,
  whatever its length, is cut into overlapping ``chunk_frames``-wide windows
  of its whole-utterance compressed spectrogram, and the windows of all the
  utterances are pooled into batches of one fixed shape,
  ``[batch_size, 1, F, chunk_frames]``, so that on the card one captured
  program (per branch and sampler) serves every length. Three stages:
  ``pack_chunks`` (per utterance: normalisation, STFT, compression,
  slicing), ``run_chunks`` (the hot batches, each replayed and copied into
  the pooled result) and ``finish_chunks`` (per utterance: decompression,
  frame-domain cross-fade overlap-add, one iSTFT). Prep and finish run
  eagerly on the device, so that nothing kept grows with the number of
  distinct lengths; nothing in the three stages waits on the device but the
  one copy of the results to the host.
- ``enhance_streamed_spec`` is the same engine on one utterance, its
  chunks one batch, run eagerly: that batch follows the utterance's
  length, and a program captured per chunk count would keep card memory
  per distinct length.

Complex spectrograms go in and out of the captured program as they are (the
JAX package's float packing at its program boundaries got round a TPU
bridge's defect and is not ported).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..capture import Program
from ..models.score_model import ScoreModel, calculate_normfac_direct
from ..transforms import istft, spec_back, spec_fwd
from ..utils import generator_noise, to_device
from .inference import PROGRAMS_KEPT, NoiseFn, _eval_fn, captures, spec_sample


def _crossfade_weights(chunk_len: int, overlap: int, position: str) -> np.ndarray:
    """Linear cross-fade window for a chunk: ramp over the overlapped regions."""
    w = np.ones(chunk_len, dtype=np.float32)
    if overlap > 0:
        # half-sample-offset ramp: head ramp + the next chunk's tail ramp sum
        # to exactly 1 across the overlap
        ramp = ((np.arange(overlap) + 0.5) / overlap).astype(np.float32)
        if position not in ("first", "only"):
            w[:overlap] = ramp
        if position not in ("last", "only"):
            w[-overlap:] = ramp[::-1]
    return w


def enhance_streamed(model: ScoreModel, y_wav: np.ndarray, model_type: str,
                     generator: Optional[torch.Generator] = None, chunk_frames: int = 64,
                     overlap_frames: int = 16, x_wav: Optional[np.ndarray] = None,
                     est_snr: float = 1.0, fixed_snr: Optional[float] = None,
                     trim_frames: int = 0, sampler_kwargs: Optional[dict] = None,
                     noise: Optional[NoiseFn] = None) -> np.ndarray:
    """Enhance one utterance of any length via overlapped fixed-width
    waveform chunks, all enhanced as one batch.

    Args:
        y_wav: noisy waveform ``[T]``.
        model_type: an eval branch (``inference.BRANCHES``).
        generator, noise: the draws, as for ``inference._eval_fn``.
        chunk_frames / overlap_frames: chunk geometry in STFT frames
            (chunk_frames a multiple of 64).
        x_wav: optional clean reference (read by the branches that need X).
        trim_frames: frames discarded at each interior chunk edge before the
            overlap-add (least context, the iSTFT's taper); needs
            ``overlap_frames > 2 * trim_frames``. Utterance edges are never
            trimmed.

    Returns the enhanced waveform ``[T]`` (numpy).
    """
    if chunk_frames % 64 or not 0 <= overlap_frames < chunk_frames:
        raise ValueError("chunk_frames must be a multiple of 64 and 0 <= overlap < chunk")
    if trim_frames and not 2 * trim_frames < overlap_frames:
        raise ValueError("need overlap_frames > 2*trim_frames")
    hop = model.cfg.hop_length
    y_wav = np.asarray(y_wav).reshape(-1)
    x_wav = y_wav if x_wav is None else np.asarray(x_wav).reshape(-1)
    t_orig = y_wav.shape[-1]

    chunk_len = (chunk_frames - 1) * hop
    hop_len = (chunk_frames - overlap_frames - 1) * hop
    overlap_len = chunk_len - hop_len
    trim_len = trim_frames * hop
    starts = list(range(0, max(t_orig - overlap_len, 1), hop_len))

    xb = np.zeros((len(starts), chunk_len), dtype=np.float32)
    yb = np.zeros((len(starts), chunk_len), dtype=np.float32)
    for i, s in enumerate(starts):
        seg = y_wav[s: s + chunk_len]
        xseg = x_wav[s: s + chunk_len]
        yb[i, : len(seg)] = seg
        xb[i, : len(xseg)] = xseg

    fn = _eval_fn(model, model_type, chunk_frames, fixed_snr=fixed_snr,
                  sampler_kwargs=sampler_kwargs)
    out_chunks = fn(xb, yb, est_snr, generator=generator, noise=noise).cpu().numpy()

    # overlap-add with linear cross-fades over the kept (untrimmed) regions
    total = starts[-1] + chunk_len
    acc = np.zeros(total, dtype=np.float64)
    wsum = np.zeros(total, dtype=np.float64)
    for i, s in enumerate(starts):
        if len(starts) == 1:
            pos = "only"  # both first and last: nothing may be trimmed
        elif i == 0:
            pos = "first"
        elif i == len(starts) - 1:
            pos = "last"
        else:
            pos = "mid"
        lo = trim_len if pos in ("mid", "last") else 0
        hi = chunk_len - (trim_len if pos in ("first", "mid") else 0)
        ov = overlap_len - 2 * trim_len if trim_len else overlap_len
        w = _crossfade_weights(hi - lo, ov, pos)
        acc[s + lo: s + hi] += out_chunks[i][lo:hi] * w
        wsum[s + lo: s + hi] += w
    wsum = np.where(wsum > 1e-8, wsum, 1.0)
    return (acc / wsum).astype(np.float32)[:t_orig]


def _frame_crossfade_weights(n: int, chunk: int, overlap: int) -> np.ndarray:
    """[n, chunk] frame-domain cross-fade weights: half-sample-offset ramps
    over the overlap so adjacent chunks sum to exactly 1; utterance edges
    (first head / last tail) are never ramped."""
    w = np.ones((n, chunk), dtype=np.float32)
    if overlap > 0 and n > 1:
        ramp = ((np.arange(overlap) + 0.5) / overlap).astype(np.float32)
        w[1:, :overlap] = ramp
        w[:-1, -overlap:] = ramp[::-1]
    return w


def _packed_geometry(t_orig: int, hop: int, chunk: int, overlap: int):
    """``(step, n, total_frames, pad_samples)`` of an utterance of ``t_orig``
    samples: ``n`` chunks ``step`` frames apart tile ``total_frames``
    frames, the STFT of ``pad_samples`` samples."""
    step = chunk - overlap
    frames = 1 + t_orig // hop
    n = max(1, -(-(frames - overlap) // step))  # ceil
    total_frames = n * step + overlap
    pad_samples = (total_frames - 1) * hop
    return step, n, total_frames, pad_samples


def _spec_prep(model: ScoreModel, model_type: str, fs: float, x_in: torch.Tensor,
               y_in: torch.Tensor, est: torch.Tensor, step: int, chunk: int):
    """One utterance's prep: the eval harness's per-utterance normalisation,
    the whole-utterance STFT and compression, and the overlapped chunks.
    ``x_in``/``y_in``: ``[pad_samples]``, ``est``: a float32 0-d tensor, on
    the model's device. Returns ``(Xc, Yc, norm, noise_size)``: chunks
    ``[n, 1, F, chunk]``, the 0-d normaliser and, for ``sebridge_v2_fixed``,
    the utterance's |X - Y| max (else None)."""
    norm = torch.max(torch.abs(y_in))
    if model_type in ("sebridge_v2_snr", "sebridge_v3_snr"):
        norm = norm * calculate_normfac_direct(1.0, est, fs)
    y_n = y_in[None] / norm
    x_n = x_in[None] / norm
    if model_type == "sebridge_v3_fixed":
        y_n = x_n + (y_n - x_n) * fs
    Yf = spec_fwd(model._stft(y_n), model.spec_cfg)  # [1, F, total_frames]
    Xf = spec_fwd(model._stft(x_n), model.spec_cfg)
    noise_size = None
    if model_type == "sebridge_v2_fixed":
        # per UTTERANCE, never over a batch mixing several
        noise_size = torch.max(torch.abs(Xf - Yf))
    # [1, F, n, chunk] -> [n, 1, F, chunk]
    Yc = Yf.unfold(-1, chunk, step).permute(2, 0, 1, 3)
    Xc = Xf.unfold(-1, chunk, step).permute(2, 0, 1, 3)
    return Xc, Yc, norm, noise_size


def _spec_ola(model: ScoreModel, sample: torch.Tensor, weights: torch.Tensor,
              wsum: torch.Tensor, step: int, total_frames: int) -> torch.Tensor:
    """One utterance's finish: decompression, the frame-domain cross-fade
    overlap-add of its ``[n, 1, F, chunk]`` chunks (``weights`` ``[n,
    chunk]``, their per-frame sum ``wsum``), one iSTFT. Returns the
    normalised-domain waveform ``[pad_samples]``."""
    lin = spec_back(sample, model.spec_cfg)[:, 0] * weights[:, None, :]  # [n, F, chunk]
    chunk = lin.shape[-1]
    acc = torch.ops.aten.unfold_backward(lin.permute(1, 0, 2), [lin.shape[1], total_frames],
                                         1, chunk, step)  # [F, total_frames]
    acc = acc / wsum
    return istft(acc, model._window, model.stft_cfg.n_fft, model.stft_cfg.hop_length)


class ChunkPool(NamedTuple):
    """Stage 1's result: every utterance's chunks pooled and padded with
    zero chunks to whole batches of ``batch_size``.

    ``X``/``Y``: ``[rows, 1, F, chunk]`` complex, ``est``: ``[rows]``
    float32, ``noise_size``: ``[rows, 1, 1, 1]`` for ``sebridge_v2_fixed``
    (else None), all on the model's device; ``norms``: each utterance's 0-d
    normaliser; ``geoms``: each utterance's ``(t_orig, step, n,
    total_frames, pad_samples)``; ``chunks``: the real chunks (the rows
    after them are padding)."""

    X: torch.Tensor
    Y: torch.Tensor
    est: torch.Tensor
    noise_size: Optional[torch.Tensor]
    norms: List[torch.Tensor]
    geoms: List[tuple]
    chunks: int
    batch_size: int
    chunk: int
    overlap: int

    @property
    def batches(self) -> int:
        return self.X.shape[0] // self.batch_size

    def batch(self, index: int) -> dict:
        """The chunk program's inputs of batch ``index``."""
        rows = slice(index * self.batch_size, (index + 1) * self.batch_size)
        inputs = {"X": self.X[rows], "Y": self.Y[rows], "est": self.est[rows]}
        if self.noise_size is not None:
            inputs["noise_size"] = self.noise_size[rows]
        return inputs


def pack_chunks(model: ScoreModel, y_wavs: Sequence[np.ndarray], model_type: str,
                chunk_frames: int = 64, overlap_frames: int = 2, batch_size: int = 16,
                x_wavs: Optional[Sequence[np.ndarray]] = None,
                est_snrs: Optional[Sequence[float]] = None,
                fixed_snr: Optional[float] = None) -> ChunkPool:
    """Stage 1 of ``enhance_streamed_packed``: each utterance's prep on the
    device, and the pooled, padded chunk queue."""
    if chunk_frames % 64 or not 0 <= overlap_frames < chunk_frames or batch_size < 1:
        raise ValueError("chunk_frames must be a multiple of 64, 0 <= overlap < chunk and "
                         "batch_size >= 1")
    cfg, dev = model.cfg, model.device
    fs = cfg.fixed_snr if fixed_snr is None else fixed_snr
    y_wavs = [np.asarray(y, dtype=np.float32).reshape(-1) for y in y_wavs]
    x_wavs = (y_wavs if x_wavs is None
              else [np.asarray(x, dtype=np.float32).reshape(-1) for x in x_wavs])
    if est_snrs is None:
        est_snrs = [1.0] * len(y_wavs)
    geoms, Xcs, Ycs, norms, ests, noises = [], [], [], [], [], []
    for y, x, est in zip(y_wavs, x_wavs, est_snrs):
        t_orig = y.shape[-1]
        step, n, total_frames, pad_samples = _packed_geometry(t_orig, cfg.hop_length,
                                                              chunk_frames, overlap_frames)
        geoms.append((t_orig, step, n, total_frames, pad_samples))
        yp = np.zeros(pad_samples, dtype=np.float32)
        xp = np.zeros(pad_samples, dtype=np.float32)
        yp[: min(t_orig, pad_samples)] = y[:pad_samples]
        xp[: min(t_orig, pad_samples)] = x[:pad_samples]
        est_t = torch.full((), float(np.float32(est)), dtype=torch.float32, device=dev)
        Xc, Yc, norm, noise_size = _spec_prep(
            model, model_type, fs, to_device(torch.from_numpy(xp), dev),
            to_device(torch.from_numpy(yp), dev), est_t, step, chunk_frames)
        Xcs.append(Xc)
        Ycs.append(Yc)
        norms.append(norm)
        ests.append(np.full(n, est, dtype=np.float32))
        if noise_size is not None:
            noises.append(noise_size.expand(n, 1, 1, 1))
    chunks = sum(g[2] for g in geoms)
    pad = -chunks % batch_size
    # padding rows: zero chunks, est 1.0 and noise size 1.0 (finite through
    # every branch), discarded after stage 2
    zeros = torch.zeros((pad,) + tuple(Ycs[0].shape[1:]), dtype=Ycs[0].dtype, device=dev)
    est_all = np.concatenate(ests + [np.ones(pad, dtype=np.float32)])
    noise_all = None
    if noises:
        noise_all = torch.cat(noises + [torch.ones((pad, 1, 1, 1), device=dev)])
    return ChunkPool(X=torch.cat(Xcs + [zeros]), Y=torch.cat(Ycs + [zeros]),
                     est=to_device(torch.from_numpy(est_all), dev), noise_size=noise_all,
                     norms=norms, geoms=geoms, chunks=chunks, batch_size=batch_size,
                     chunk=chunk_frames, overlap=overlap_frames)


def _stream_cache(model: ScoreModel) -> dict:
    """The model's captured chunk programs, kept on the model (as
    ``ScoreModel._graphs``): a module-level cache would keep every served
    model and its programs for the life of the process."""
    return model.__dict__.setdefault("_stream_programs", {})


def _chunk_fn(model: ScoreModel, model_type: str, fs: float, sk: dict):
    """The hot function of one chunk batch: ``fn(noise, X, Y, est,
    noise_size=None)`` -> the enhanced compressed chunks."""
    def fn(noise, X, Y, est, noise_size=None):
        return spec_sample(model, model_type, X, Y, noise, est, fs, noise_size=noise_size, **sk)

    return fn


def chunk_program(model: ScoreModel, model_type: str, batch_size: int, chunk: int,
                  fixed_snr: Optional[float] = None, sampler_kwargs: Optional[dict] = None,
                  inputs: Optional[dict] = None) -> Program:
    """The captured chunk program of ``(model_type, batch_size, chunk,
    fixed_snr, sampler_kwargs)`` on the card: captured on first use from
    ``inputs`` (a ``ChunkPool.batch``) and kept on the model, made anew
    when the backbone's parameters change (the model keeps the
    ``PROGRAMS_KEPT`` most recently used)."""
    fs = model.cfg.fixed_snr if fixed_snr is None else fixed_snr
    sk = dict(sampler_kwargs or {})
    key = ("chunk", model_type, batch_size, chunk, fs,
           tuple(sorted(sk.items()))) + model._program_settings()
    fn = _chunk_fn(model, model_type, fs, sk)
    return model.cached_program(
        _stream_cache(model), key,
        lambda: Program(lambda gen, **t: fn(generator_noise(gen), **t), inputs, model.device),
        limit=PROGRAMS_KEPT)


@torch.no_grad()
def run_chunks(model: ScoreModel, pool: ChunkPool, model_type: str,
               generator: Optional[torch.Generator] = None, noise: Optional[NoiseFn] = None,
               fixed_snr: Optional[float] = None, sampler_kwargs: Optional[dict] = None,
               graphed: bool = True) -> torch.Tensor:
    """Stage 2: every batch of the pool through the hot chunk program
    (captured on the card unless ``graphed`` is False; eagerly on the CPU or
    with a caller's ``noise``),
    each result copied into the pooled ``[rows, 1, F, chunk]`` samples
    before the next batch runs (a replay's outputs are the program's own
    buffers). Draws: from ``noise``, else from ``generator`` (advanced batch
    after batch; seed 0 when None)."""
    if noise is None and generator is None:
        generator = torch.Generator(model.device).manual_seed(0)
    samples = torch.empty_like(pool.Y)
    if graphed and captures(model, noise):
        program = chunk_program(model, model_type, pool.batch_size, pool.chunk, fixed_snr,
                                sampler_kwargs, pool.batch(0))
        for b in range(pool.batches):
            out = program(generator, **pool.batch(b))
            samples[b * pool.batch_size: (b + 1) * pool.batch_size].copy_(out)
        return samples
    fs = model.cfg.fixed_snr if fixed_snr is None else fixed_snr
    fn = _chunk_fn(model, model_type, fs, dict(sampler_kwargs or {}))
    noise = noise or generator_noise(generator)
    for b in range(pool.batches):
        samples[b * pool.batch_size: (b + 1) * pool.batch_size] = fn(noise, **pool.batch(b))
    return samples


@torch.no_grad()
def finish_chunks(model: ScoreModel, pool: ChunkPool, samples: torch.Tensor) -> List[np.ndarray]:
    """Stage 3: each utterance's overlap-add and iSTFT, de-normalised; the
    waveforms copied to the host at once, each of its input's length (zero
    padded where the iSTFT gives up to hop-1 samples fewer)."""
    outs, off = [], 0
    for (t_orig, step, n, total_frames, _), norm in zip(pool.geoms, pool.norms):
        weights = _frame_crossfade_weights(n, pool.chunk, pool.overlap)
        wsum = np.zeros(total_frames, dtype=np.float32)
        for i in range(n):
            wsum[i * step: i * step + pool.chunk] += weights[i]
        dev = model.device
        x_hat = _spec_ola(model, samples[off: off + n],
                          to_device(torch.from_numpy(weights), dev),
                          to_device(torch.from_numpy(np.maximum(wsum, 1e-8)), dev),
                          step, total_frames) * norm
        off += n
        outs.append(x_hat[:t_orig])
    host = torch.cat(outs).cpu().numpy()
    results, off = [], 0
    for (t_orig, *_), out in zip(pool.geoms, outs):
        wave = host[off: off + out.shape[0]]
        off += out.shape[0]
        results.append(np.pad(wave, (0, t_orig - wave.shape[0])))
    return results


def enhance_streamed_packed(model: ScoreModel, y_wavs: Sequence[np.ndarray], model_type: str,
                            generator: Optional[torch.Generator] = None, chunk_frames: int = 64,
                            overlap_frames: int = 2, batch_size: int = 16,
                            x_wavs: Optional[Sequence[np.ndarray]] = None,
                            est_snrs: Optional[Sequence[float]] = None,
                            fixed_snr: Optional[float] = None,
                            sampler_kwargs: Optional[dict] = None,
                            noise: Optional[NoiseFn] = None) -> List[np.ndarray]:
    """Fleet serving: the spectral chunks of all of ``y_wavs`` pooled into
    batches of ``[batch_size, 1, F, chunk_frames]``, one captured program on
    the card for every length (module docstring). ``x_wavs`` (the clean
    references, for the branches that read X), ``est_snrs`` (one per
    utterance, for the ``_snr`` branches; 1.0 when None), ``fixed_snr`` (the
    model's when None) and ``sampler_kwargs`` (``bbed``: ``spec_sample``'s
    overrides) as in the JAX package; draws from ``noise`` (run eagerly) or
    ``generator``. Returns one numpy waveform per utterance, of its input's
    length. Each utterance's chunks are normalised and tiled as
    ``enhance_streamed_spec`` does, so a deterministic branch gives the
    same waveforms."""
    pool = pack_chunks(model, y_wavs, model_type, chunk_frames, overlap_frames, batch_size,
                       x_wavs, est_snrs, fixed_snr)
    samples = run_chunks(model, pool, model_type, generator, noise, fixed_snr, sampler_kwargs)
    return finish_chunks(model, pool, samples)


def enhance_streamed_spec(model: ScoreModel, y_wav: np.ndarray, model_type: str,
                          generator: Optional[torch.Generator] = None, chunk_frames: int = 64,
                          overlap_frames: int = 2, x_wav: Optional[np.ndarray] = None,
                          est_snr: float = 1.0, fixed_snr: Optional[float] = None,
                          sampler_kwargs: Optional[dict] = None,
                          noise: Optional[NoiseFn] = None) -> np.ndarray:
    """Spec-domain streaming of one utterance: one whole-utterance STFT,
    sliced into overlapped ``chunk_frames``-wide windows (every chunk edge
    sees real signal context), all enhanced as one batch, the decompressed
    chunks cross-faded and one iSTFT; per-utterance normalisation as the
    full-context eval path. Compute overhead over full context is the
    overlap ratio ``chunk / (chunk - overlap)`` (3.2% at the default 2
    frames). The packed engine with this utterance alone and a batch of its
    ``n`` chunks, run eagerly on the card too (module docstring)."""
    hop = model.cfg.hop_length
    t_orig = np.asarray(y_wav).reshape(-1).shape[-1]
    n = _packed_geometry(t_orig, hop, chunk_frames, overlap_frames)[1]
    pool = pack_chunks(model, [y_wav], model_type, chunk_frames, overlap_frames, batch_size=n,
                       x_wavs=None if x_wav is None else [x_wav], est_snrs=[est_snr],
                       fixed_snr=fixed_snr)
    samples = run_chunks(model, pool, model_type, generator, noise, fixed_snr, sampler_kwargs,
                         graphed=False)
    return finish_chunks(model, pool, samples)[0]
