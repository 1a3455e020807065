"""Bucketed batch enhancement for full test-set evaluation (port of
diffse_tpu/evaluation/batch_eval.py).

Utterances are grouped by padded spectrogram width (multiples of 64 frames,
the NCSN++ shape contract), each bucket's waveforms zero-padded to a common
length and enhanced as batches of the eval harness's function
(``inference._eval_fn``: per-row normalisation and SNR estimate, so the
batch changes only the throughput); each output is cut back to its file's
length.

On the card a full batch runs through ``_eval_fn``'s captured program of
its (bucket, batch) shape, which the model keeps (at most
``inference.PROGRAMS_KEPT``). A batch with fewer rows than ``batch_size``
(the last of a bucket) is a shape that the run meets once: it runs eagerly,
so that no program is captured for it. The host packs bucket k+1 while the
card enhances bucket k, and copies bucket k out only after bucket k+1 is
enqueued (the JAX package's software pipeline).

Draws: dispatch ``b`` (the b-th batch in bucket order) draws from a
generator on the model's device seeded with
``inference.dispatch_seed(seed, b)``, or from ``noise(b)`` when the caller
gives ``noise`` (a function of the dispatch index returning a noise source;
run eagerly). That is the JAX package's ``fold_in(key, b)``, so the CPU
tests replay its draws.

With ``mesh`` (a ``parallel`` mesh over several ranks) each bucket batch
whose rows divide over the mesh's ``"data"`` axis is split over it: each
rank enhances its rows eagerly, drawing at the whole batch's shape and
keeping its rows (``parallel.mesh.BatchShard``), so that every row sees the
draws it sees without the mesh; the outputs are all-gathered and every rank
returns the whole list, in the input's order. A batch that does not divide
runs whole on every rank.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.score_model import ScoreModel
from ..parallel.mesh import axis_size, batch_shard, shard_batch
from ..utils import generator_noise
from .inference import NoiseFor, _eval_fn, dispatch_generator


def width_bucket(num_samples: int, hop_length: int = 128, multiple: int = 64) -> int:
    """Padded frame count for an utterance of ``num_samples`` samples."""
    frames = 1 + num_samples // hop_length
    return frames + (multiple - frames % multiple) % multiple


def iter_buckets(wav_lengths: Sequence[int], batch_size: int,
                 hop_length: int = 128) -> Iterator[Tuple[int, List[int]]]:
    """Group utterance indices into (bucket_frames, [indices]) batches,
    buckets in increasing width, files in their order within a bucket."""
    buckets: Dict[int, List[int]] = defaultdict(list)
    for idx, n in enumerate(wav_lengths):
        buckets[width_bucket(n, hop_length)].append(idx)
    for t_pad in sorted(buckets):
        idxs = buckets[t_pad]
        for i in range(0, len(idxs), batch_size):
            yield t_pad, idxs[i: i + batch_size]


def _fit_length(w: np.ndarray, n: int) -> np.ndarray:
    """A row cut or zero-padded to exactly n samples (a bucket of frames % 64
    == 0 gives up to hop-1 samples fewer than the utterance)."""
    w = w[:n]
    return np.pad(w, (0, n - w.shape[-1])) if w.shape[-1] < n else w


class _HostCopy:
    """A device tensor's copy to the host, started without waiting: from the
    card into pinned memory (``non_blocking``), with an event recorded after
    it, so that ``numpy()`` waits for this copy and what came before it
    only."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def batch_enhance(model: ScoreModel, x_wavs: Sequence[np.ndarray], y_wavs: Sequence[np.ndarray],
                  model_type: str, seed: int = 0, batch_size: int = 8,
                  est_snrs: Optional[Sequence[float]] = None, fixed_snr: Optional[float] = None,
                  sampler_kwargs: Optional[dict] = None,
                  noise: Optional[NoiseFor] = None, mesh=None) -> List[np.ndarray]:
    """Enhance a list of utterances in bucketed batches; returns one numpy
    waveform per utterance, of its input's length.

    ``model_type``: an eval branch (``inference.BRANCHES``); ``est_snrs``:
    one estimate per utterance for the ``_snr`` branches (1.0 when None);
    ``fixed_snr``: the model's when None; ``sampler_kwargs`` (``bbed``):
    ``spec_sample``'s sampler overrides. Draws and ``mesh``: module
    docstring.

    Semantics are per utterance (``_eval_fn`` normalises each row by its
    own max-abs and takes its own estimate); shorter utterances of a bucket
    see extra zero samples before the STFT, which the normaliser ignores.
    """
    hop = model.cfg.hop_length
    lengths = [int(np.asarray(y).reshape(-1).shape[-1]) for y in y_wavs]
    out: List[Optional[np.ndarray]] = [None] * len(y_wavs)

    def prepare(t_pad, idxs):
        """Host side: one bucket batch padded into arrays."""
        pad_samples = (t_pad - 1) * hop
        xb = np.zeros((len(idxs), pad_samples), dtype=np.float32)
        yb = np.zeros((len(idxs), pad_samples), dtype=np.float32)
        for row, idx in enumerate(idxs):
            n = min(lengths[idx], pad_samples)
            xb[row, :n] = np.asarray(x_wavs[idx]).reshape(-1)[:n]
            yb[row, :n] = np.asarray(y_wavs[idx]).reshape(-1)[:n]
        est = (np.asarray([est_snrs[i] for i in idxs], dtype=np.float32)
               if est_snrs is not None else np.ones((len(idxs),), dtype=np.float32))
        return xb, yb, est

    n_data = axis_size(mesh, "data")

    def dispatch_rows(bi, fn, prepped) -> torch.Tensor:
        """This rank's rows of one batch, enhanced; every rank's gathered."""
        with batch_shard(mesh) as shard:
            source = noise(bi) if noise is not None else generator_noise(
                dispatch_generator(model.device, seed, bi))
            x_hat = fn(*shard_batch(mesh, prepped),
                       noise=lambda like: shard.rows(source(shard.global_like(like))))
            return shard.coll.all_gather(x_hat)

    def dispatch(bi, t_pad, idxs, prepped) -> _HostCopy:
        """Enqueue one batch on the device (nothing waits) and its copy out."""
        fn = _eval_fn(model, model_type, t_pad, fixed_snr=fixed_snr,
                      sampler_kwargs=sampler_kwargs)
        if n_data > 1 and len(idxs) % n_data == 0:
            return _HostCopy(dispatch_rows(bi, fn, prepped))
        if noise is not None:
            x_hat = fn(*prepped, noise=noise(bi))
        else:
            x_hat = fn(*prepped, generator=dispatch_generator(model.device, seed, bi),
                       graphed=len(idxs) == batch_size)
        return _HostCopy(x_hat)

    def collect(idxs, copy: _HostCopy):
        x_hat = copy.numpy()
        for row, idx in enumerate(idxs):
            out[idx] = _fit_length(x_hat[row], lengths[idx])

    pending = None
    for bi, (t_pad, idxs) in enumerate(iter_buckets(lengths, batch_size, hop)):
        inflight = dispatch(bi, t_pad, idxs, prepare(t_pad, idxs))
        if pending is not None:
            collect(*pending)  # waits on the previous batch only
        pending = (idxs, inflight)
    if pending is not None:
        collect(*pending)
    return out  # type: ignore[return-value]
