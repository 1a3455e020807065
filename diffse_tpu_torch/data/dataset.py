"""Dataset pipeline: host-side WAV loading and cropping (the port's own copy
of diffse_tpu/data/dataset.py, numpy only, without the JAX package's native
loader).

The datasets yield raw waveform crops; normalise -> STFT -> compression runs
on the device in the train step (``ScoreModel.prepare_batch``). The per-item
contract:

  Specs:     y = x + (y-x) * fixed_snr, random/center crop or center pad to
             (num_frames - 1) * hop samples.
  Specs_SNR: same, plus the active-RMS clean/noise levels parsed from
             `active_rms.txt` (filename \t clean_rms \t noise_rms).

Batches are prefetched by a small thread pool (the analog of num_workers).
"""

from __future__ import annotations

import dataclasses
import glob
import queue
import threading
from os.path import join
from typing import Iterator, Optional

import numpy as np

from .wavio import read_wav


def _load_wav(path: str) -> np.ndarray:
    x, _sr = read_wav(path)
    return x[0]


@dataclasses.dataclass
class DataModuleConfig:
    """SpecsDataModule's settings, as the JAX package's command line sets them."""

    base_dir: str = ""
    format: str = "default"
    batch_size: int = 8
    n_fft: int = 510
    hop_length: int = 128
    num_frames: int = 256
    window: str = "hann"
    num_workers: int = 4
    dummy: bool = False
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    normalize: str = "noisy"
    transform_type: str = "exponent"
    fixed_snr: float = 1.0


class Specs:
    """Clean/noisy waveform pair dataset."""

    def __init__(self, data_dir, subset, dummy, shuffle_spec, num_frames,
                 hop_length, format="default", fixed_snr=1.0, seed=None,
                 **ignored_kwargs):
        if format == "default":
            self.clean_files = sorted(glob.glob(join(data_dir, subset) + "/clean/*.wav"))
            self.noisy_files = sorted(glob.glob(join(data_dir, subset) + "/noisy/*.wav"))
        else:
            raise NotImplementedError(f"Directory format {format} unknown!")
        self.dummy = dummy
        self.num_frames = num_frames
        self.hop_length = hop_length
        self.shuffle_spec = shuffle_spec
        self.fixed_snr = fixed_snr
        self.rng = np.random.default_rng(seed)

    def _crop_pair(self, x: np.ndarray, y: np.ndarray, u: Optional[float] = None):
        """Random/center crop or center pad.

        ``u`` in [0,1) optionally supplies the crop draw (parallel loaders
        pre-draw it so thread scheduling cannot perturb determinism); ``None``
        draws from the dataset rng. ``int(u * span)`` is bit-identical to the
        previous ``int(rng.uniform(0, span))`` — numpy computes the latter as
        ``span * next_double()``."""
        target_len = (self.num_frames - 1) * self.hop_length
        current_len = x.shape[-1]
        pad = max(target_len - current_len, 0)
        if pad == 0:
            if self.shuffle_spec:
                if u is None:
                    u = self.rng.uniform(0.0, 1.0)
                start = int(u * (current_len - target_len))
            else:
                start = int((current_len - target_len) / 2)
            x = x[..., start : start + target_len]
            y = y[..., start : start + target_len]
        else:
            width = (pad // 2, pad // 2 + (pad % 2))
            x = np.pad(x, width, mode="constant")
            y = np.pad(y, width, mode="constant")
        return x, y

    def load_item(self, i: int, u: Optional[float] = None):
        """One (clean, noisy) crop. ``u`` pre-supplies the crop draw (see
        :meth:`_crop_pair`)."""
        x = _load_wav(self.clean_files[i])
        y = _load_wav(self.noisy_files[i])
        y = x + (y - x) * self.fixed_snr
        x, y = self._crop_pair(x, y, u)
        return x.astype(np.float32), y.astype(np.float32)

    def __getitem__(self, i: int):
        return self.load_item(i)

    def __len__(self):
        n = len(self.clean_files)
        return int(n / 200) if self.dummy else n


class Specs_SNR(Specs):
    """Specs + active-RMS clean/noise levels."""

    def __init__(self, data_dir, subset, dummy, shuffle_spec, num_frames,
                 hop_length, format="default", seed=None, **ignored_kwargs):
        super().__init__(data_dir, subset, dummy, shuffle_spec, num_frames,
                         hop_length, format=format, fixed_snr=1.0, seed=seed)
        self.clean_rms = []
        self.noise_rms = []
        rms_path = join(data_dir, subset) + "/active_rms.txt"
        with open(rms_path, "r") as f:
            for line in f:
                parts = line.split("\t")
                try:
                    self.clean_rms.append(float(parts[1]))
                    self.noise_rms.append(float(parts[2]))
                except (IndexError, ValueError):
                    break

    def load_item(self, i: int, u: Optional[float] = None):
        # fixed_snr == 1.0, so the base remix is the identity y' == y.
        x, y = super().load_item(i, u)
        return (x, y, np.float32(self.clean_rms[i]), np.float32(self.noise_rms[i]))

    def __getitem__(self, i: int):
        return self.load_item(i)


class DataLoader:
    """Threaded batch loader (the analog of torch DataLoader with num_workers
    prefetch). Yields tuples of stacked numpy arrays, in deterministic order.

    ``num_workers > 1`` loads batches concurrently: wav decode dominates item
    cost and runs with the GIL released (numpy ``frombuffer``, file IO), so
    plain threads scale.
    Crop randomness is then pre-drawn from the *loader's* rng in dispatch
    order — worker scheduling cannot perturb determinism, and the dataset's
    own (non-thread-safe) rng is never touched from workers. ``num_workers=1``
    keeps the dataset-rng sequential semantics exactly.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        return [order[b * self.batch_size : (b + 1) * self.batch_size]
                for b in range(len(self))]

    @staticmethod
    def _stack(items):
        return tuple(np.stack([it[c] for it in items]) for c in range(len(items[0])))

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        if self.num_workers == 1:
            yield from self._iter_sequential(batches)
            return

        # Parallel path: pre-draw per-item crop u's (consumed only by
        # datasets that crop randomly — Specs with shuffle_spec=True).
        draws_crops = bool(getattr(self.dataset, "shuffle_spec", False))
        us = (self.rng.uniform(0.0, 1.0, size=len(self.dataset))
              if draws_crops else None)
        load = getattr(self.dataset, "load_item", None)

        def load_batch(idxs):
            items = []
            for i in idxs:
                if load is not None:
                    u = None if us is None else float(us[int(i)])
                    items.append(load(int(i), u))
                else:
                    items.append(self.dataset[int(i)])
            return self._stack(items)

        from concurrent.futures import ThreadPoolExecutor
        from collections import deque

        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            inflight: deque = deque()
            depth = self.num_workers * 2
            b = 0
            while b < len(batches) or inflight:
                while b < len(batches) and len(inflight) < depth:
                    inflight.append(ex.submit(load_batch, batches[b]))
                    b += 1
                yield inflight.popleft().result()
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _iter_sequential(self, batches) -> Iterator:
        """Single producer thread; items drawn via the dataset's own rng."""
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def produce():
            for idxs in batches:
                if stop.is_set():
                    return
                q.put(self._stack([self.dataset[int(i)] for i in idxs]))
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


class SpecsDataModule:
    """Train/valid/valid2/test split wiring."""

    def __init__(self, config: DataModuleConfig):
        self.cfg = config
        self.train_set = None
        self.valid_set = None
        self.valid_set_2 = None
        self.test_set = None

    def setup(self, stage: Optional[str] = None):
        c = self.cfg
        common = dict(num_frames=c.num_frames, hop_length=c.hop_length,
                      format=c.format, dummy=c.dummy)
        if stage in ("fit", None):
            self.train_set = Specs(
                data_dir=c.base_dir, subset="train", shuffle_spec=True,
                fixed_snr=c.fixed_snr, **common,
            )
            self.valid_set = Specs_SNR(
                data_dir=c.base_dir, subset="valid", shuffle_spec=False, **common,
            )
            self.valid_set_2 = Specs(
                data_dir=c.base_dir, subset="valid2", shuffle_spec=False,
                fixed_snr=1.0, **common,
            )
        if stage in ("test", None):
            self.test_set = Specs(
                data_dir=c.base_dir, subset="test", shuffle_spec=False,
                fixed_snr=1.0, **common,
            )

    def train_dataloader(self):
        c = self.cfg
        return DataLoader(self.train_set, c.batch_size, shuffle=True,
                          drop_last=True, num_workers=c.num_workers)

    def val_dataloader(self):
        return DataLoader(self.valid_set, 1, shuffle=False, drop_last=True,
                          num_workers=self.cfg.num_workers)

    def val_dataloader_2(self):
        return DataLoader(self.valid_set_2, self.cfg.batch_size, shuffle=False,
                          drop_last=True, num_workers=self.cfg.num_workers)

    def test_dataloader(self):
        return DataLoader(self.test_set, self.cfg.batch_size, shuffle=False,
                          drop_last=True, num_workers=self.cfg.num_workers)
