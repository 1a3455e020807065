"""Dynamic-batching enhancement service (port of
diffse_tpu/serving/service.py): the port's serving runtime.

:class:`EnhanceService` accepts requests from any number of client threads
(``submit`` returns a future; ``enhance`` blocks). One dispatcher thread
collects them into *flights*, up to ``max_flight_utts`` utterances or
``max_wait_ms`` of linger, whichever comes first, and runs each flight
through the three stages of
:func:`~diffse_tpu_torch.evaluation.streaming.enhance_streamed_packed`,
which pool the flight's spectral chunks into fixed-shape batches of one
captured chunk program on the card (captured by the first flight).

Only the dispatcher touches the device: clients and the HTTP front hand it
numpy arrays. That is required on the card, where a CUDA graph is captured
in global mode and any CUDA call from another thread during the capture
fails it, and it is what the engine wants (the flight's batches queue on one
stream; a second dispatcher would only contend). The dispatcher runs the
engine under ``torch.no_grad()`` itself: grad mode is per thread.

The ``*_snr`` branches estimate each request's SNR with the model's
SNRNet (``ScoreModel.estimate_snr``, one host read per request) unless the
request carries an oracle value. Each flight draws from its own generator,
seeded from ``(seed, flight index)`` (``flight_seed``). :meth:`stats`
reports requests, flights, chunk batches and their occupancy, audio
seconds, wall time, the real-time factor and the p50/p95/p99 latency.

The HTTP front end is :mod:`diffse_tpu_torch.serving.http`; the CLI is
``python -m diffse_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from ..evaluation.streaming import finish_chunks, pack_chunks, run_chunks
from ..train.loop import eval_model_type

SR = 16000


class RequestTooLarge(ValueError):
    """Request audio exceeds ``ServiceConfig.max_audio_seconds`` (HTTP 413)."""


class ServiceOverloaded(RuntimeError):
    """Queue full or the request aged out before dispatch (HTTP 503)."""


class FlightTimeout(RuntimeError):
    """A flight exceeded ``ServiceConfig.flight_timeout_s`` (HTTP 504)."""


@dataclasses.dataclass
class ServiceConfig:
    """Serving knobs; the defaults are the JAX package's (chunk 64, overlap
    2, batch 16, flights of up to 16 utterances, 25 ms of linger).

    Failure-mode limits (each off with ``None``):

    - ``max_audio_seconds``: a request longer than this is rejected at
      submit (:class:`RequestTooLarge`).
    - ``max_queue_utts``: new requests are rejected once this many are
      queued (:class:`ServiceOverloaded`): load is shed rather than queued
      without bound behind a saturated card.
    - ``max_queue_seconds``: a request that waited longer than this in the
      queue is failed (:class:`ServiceOverloaded`) when the dispatcher
      reaches it; its client has usually given up.
    - ``flight_timeout_s``: a flight that runs longer fails its clients
      (:class:`FlightTimeout`). The work on the card cannot be cancelled:
      the dispatcher unblocks the clients, then waits for the flight to end
      before the next one; the queue-age limit protects the requests queued
      behind it.
    """

    chunk_frames: int = 64
    overlap_frames: int = 2
    batch_size: int = 16
    max_flight_utts: int = 16
    max_wait_ms: float = 25.0
    seed: int = 0
    max_audio_seconds: Optional[float] = 600.0
    max_queue_utts: Optional[int] = 256
    max_queue_seconds: Optional[float] = 30.0
    flight_timeout_s: Optional[float] = None
    # bbed sampler overrides for the chunk engine, e.g. the certified
    # {"timestep_type": "logit", "N": 20} (SAMPLER_QUALITY.json); None: the
    # reference eval sampler (reverse_diffusion + ald, N = 30)
    sampler_kwargs: Optional[dict] = None
    # how many recent end-to-end latencies (submit -> result) the
    # p50/p95/p99 window of stats() covers
    latency_window: int = 2048


def flight_seed(seed: int, flight_index: int) -> int:
    """The seed of flight ``flight_index``'s generator: the counterpart of
    the JAX package's ``fold_in(PRNGKey(seed), flight_index)``."""
    return int(np.random.SeedSequence([seed, flight_index]).generate_state(1, np.uint64)[0])


class _Request:
    __slots__ = ("y", "est_snr", "future", "t_submit")

    def __init__(self, y: np.ndarray, est_snr: Optional[float]):
        self.y = y
        self.est_snr = est_snr
        self.future: Future = Future()
        self.t_submit = time.monotonic()


_CLOSE = object()


class EnhanceService:
    """Thread-safe dynamic batcher over the packed fleet engine.

    Args:
        model: a ``ScoreModel`` (its backbone's own weights are served).
        model_type: the eval branch (``evaluation.BRANCHES``); by default
            the model's own (``train.loop.eval_model_type``).
        config: the serving knobs.
    """

    def __init__(self, model, model_type: Optional[str] = None,
                 config: Optional[ServiceConfig] = None):
        self.model = model
        self.cfg = config or ServiceConfig()
        self.model_type = model_type or eval_model_type(model.cfg.snr_conditioned,
                                                        model.cfg.model_type)
        self._needs_snr = self.model_type.endswith("_snr")
        self._q: queue.Queue = queue.Queue()
        self._flight_idx = 0
        self._closed = False
        self._dead = False
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "flights": 0,
            "chunks": 0,
            "chunk_batches": 0,
            "audio_seconds": 0.0,
            "wall_seconds": 0.0,
            "errors": 0,
            "rejected": 0,
            "expired": 0,
            "flight_timeouts": 0,
        }
        self._latencies = collections.deque(maxlen=self.cfg.latency_window)
        self._dispatcher = threading.Thread(target=self._run, daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------- client API
    def submit(self, y_wav: np.ndarray, est_snr: Optional[float] = None) -> Future:
        """Enqueue one utterance; resolves to the enhanced float32 waveform
        of the input's length. ``est_snr``: an oracle SNR for the ``*_snr``
        branches (else the service estimates it)."""
        if self._closed:
            raise RuntimeError("service is closed")
        if self._dead:
            raise RuntimeError("service dispatcher died; service is unusable")
        y = np.asarray(y_wav, dtype=np.float32).reshape(-1)
        if y.size == 0:
            raise ValueError("empty waveform")
        max_s = self.cfg.max_audio_seconds
        if max_s is not None and y.size > max_s * SR:
            with self._lock:
                self._stats["rejected"] += 1
            raise RequestTooLarge(
                f"request audio {y.size / SR:.1f}s exceeds max_audio_seconds={max_s:g}")
        cap = self.cfg.max_queue_utts
        if cap is not None and self._q.qsize() >= cap:
            with self._lock:
                self._stats["rejected"] += 1
            raise ServiceOverloaded(f"queue full ({cap} utterances waiting); retry later")
        req = _Request(y, est_snr)
        self._q.put(req)
        if self._dead and not req.future.done():
            # the dispatcher died while this was enqueued, and its final
            # drain may have run already: fail rather than hang the client
            req.future.set_exception(RuntimeError("service dispatcher died; service is unusable"))
        return req.future

    def enhance(self, y_wav: np.ndarray, est_snr: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous wrapper around :meth:`submit`."""
        return self.submit(y_wav, est_snr).result(timeout=timeout)

    def stats(self) -> dict:
        """The counters, and derived from them: utterances per flight
        (``occupancy``), chunks per padded row (``chunk_occupancy``), audio
        seconds per wall second (``rtf_x_realtime``), the queue's depth and
        the latency window's percentiles in ms."""
        with self._lock:
            s = dict(self._stats)
            lat = list(self._latencies)
        s["occupancy"] = s["requests"] / s["flights"] if s["flights"] else 0.0
        rows = s["chunk_batches"] * self.cfg.batch_size
        s["chunk_occupancy"] = s["chunks"] / rows if rows else 0.0
        s["rtf_x_realtime"] = s["audio_seconds"] / s["wall_seconds"] if s["wall_seconds"] else 0.0
        s["queue_depth"] = self._q.qsize()
        if lat:
            a = np.asarray(lat)
            s["latency_ms"] = {
                "count": int(a.size),
                "p50": round(float(np.percentile(a, 50)) * 1000.0, 1),
                "p95": round(float(np.percentile(a, 95)) * 1000.0, 1),
                "p99": round(float(np.percentile(a, 99)) * 1000.0, 1),
                "max": round(float(a.max()) * 1000.0, 1),
            }
        else:
            s["latency_ms"] = None
        return s

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain in-queue requests, join the dispatcher."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_CLOSE)
        self._dispatcher.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------------------------------------------------------------- dispatcher
    def _expire_if_stale(self, req) -> bool:
        """Fail a request that outwaited max_queue_seconds in the queue;
        returns True if it was expired."""
        lim = self.cfg.max_queue_seconds
        if lim is None or (time.monotonic() - req.t_submit) <= lim:
            return False
        with self._lock:
            self._stats["expired"] += 1
        if not req.future.done():
            req.future.set_exception(ServiceOverloaded(
                f"request waited > max_queue_seconds={lim:g}s in queue; service overloaded"))
        return True

    def _collect_flight(self):
        """Block for the first (still-live) request, then linger up to
        max_wait_ms for more, capped at max_flight_utts; requests that aged
        past max_queue_seconds are failed and skipped. Returns
        ``(requests, saw_close)``."""
        first = None
        while first is None:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                return [], False
            if item is _CLOSE:
                return [], True
            if not self._expire_if_stale(item):
                first = item
        flight = [first]
        deadline = time.monotonic() + self.cfg.max_wait_ms / 1000.0
        while len(flight) < self.cfg.max_flight_utts:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _CLOSE:
                return flight, True
            if not self._expire_if_stale(item):
                flight.append(item)
        return flight, False

    def _run_flight(self, flight) -> None:
        """Run one flight, honouring flight_timeout_s: on a timeout the
        flight's clients are failed at once, and the dispatcher still waits
        for the flight to end before the next one."""
        timeout = self.cfg.flight_timeout_s
        if timeout is None:
            self._execute_flight(flight)
            return
        worker = threading.Thread(target=self._execute_flight_guarded, args=(flight,),
                                  daemon=True)
        worker.start()
        worker.join(timeout)
        if worker.is_alive():
            with self._lock:
                self._stats["flight_timeouts"] += 1
            err = FlightTimeout(f"flight of {len(flight)} utterances exceeded "
                                f"flight_timeout_s={timeout:g}s")
            for r in flight:
                if not r.future.done():
                    r.future.set_exception(err)
            worker.join()  # the stuck flight ends before the next one starts

    def _execute_flight_guarded(self, flight) -> None:
        """``_execute_flight`` on a worker thread, whose exceptions would
        otherwise vanish: they resolve the flight's futures."""
        try:
            self._execute_flight(flight)
        except Exception as e:  # noqa: BLE001 -- resolve, never wedge clients
            with self._lock:
                self._stats["errors"] += 1
            for r in flight:
                if not r.future.done():
                    r.future.set_exception(e)

    @torch.no_grad()
    def _execute_flight(self, flight) -> None:
        t0 = time.monotonic()
        model, cfg = self.model, self.cfg
        est_snrs = None
        if self._needs_snr:
            est_snrs = [r.est_snr if r.est_snr is not None
                        else model.estimate_snr(r.y[None])[0].item() for r in flight]
        generator = torch.Generator(model.device).manual_seed(
            flight_seed(cfg.seed, self._flight_idx))
        self._flight_idx += 1
        # enhance_streamed_packed's three stages, the pool kept for the stats
        pool = pack_chunks(model, [r.y for r in flight], self.model_type, cfg.chunk_frames,
                           cfg.overlap_frames, cfg.batch_size, est_snrs=est_snrs,
                           fixed_snr=model.cfg.fixed_snr)
        samples = run_chunks(model, pool, self.model_type, generator,
                             fixed_snr=model.cfg.fixed_snr, sampler_kwargs=cfg.sampler_kwargs)
        outs = finish_chunks(model, pool, samples)
        t_done = time.monotonic()
        for r, out in zip(flight, outs):
            if not r.future.done():  # a flight timeout may have failed it
                r.future.set_result(out)
        with self._lock:
            self._stats["requests"] += len(flight)
            self._stats["flights"] += 1
            self._stats["chunks"] += pool.chunks
            self._stats["chunk_batches"] += pool.batches
            self._stats["audio_seconds"] += sum(r.y.shape[-1] for r in flight) / SR
            self._stats["wall_seconds"] += t_done - t0
            # end to end: queue wait, linger and the flight
            self._latencies.extend(t_done - r.t_submit for r in flight)

    def _run(self) -> None:
        try:
            self._run_loop()
        finally:
            if not self._closed:
                # the dispatcher died (a fault past the per-flight guard, or
                # a BaseException): mark the service dead, so that submit()
                # rejects, and fail everything still queued
                self._dead = True
                err = RuntimeError("service dispatcher died; service is unusable")
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if item is not _CLOSE and not item.future.done():
                        item.future.set_exception(err)

    def _run_loop(self) -> None:
        while True:
            flight, saw_close = self._collect_flight()
            if flight:
                try:
                    self._run_flight(flight)
                except Exception as e:  # noqa: BLE001 -- resolve, never wedge clients
                    with self._lock:
                        self._stats["errors"] += 1
                    for r in flight:
                        if not r.future.done():
                            r.future.set_exception(e)
            if saw_close:
                # drain anything that raced past close()
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if item is not _CLOSE and not item.future.done():
                        item.future.set_exception(RuntimeError("service closed"))
