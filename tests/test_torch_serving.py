"""The port's serving path on the CPU: the EnhanceService dynamic batcher
(the counterpart of each case of tests/test_serving.py), the HTTP front,
``load_snr_model`` and ``python -m diffse_tpu_torch.cli.serve``. The tiny
NCSN++ carries random weights from the JAX package (convert.py), and the
SNR branch's estimates are held to the JAX package's."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu_torch.cli import serve
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.data.wavio import parse_wav, wav_bytes
from diffse_tpu_torch.evaluation.streaming import enhance_streamed_packed, enhance_streamed_spec
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.models.snr_model import SNRModel, SNRModelConfig
from diffse_tpu_torch.serving import (EnhanceService, FlightTimeout, RequestTooLarge,
                                      ServiceConfig, ServiceOverloaded, flight_seed)
from diffse_tpu_torch.serving.http import make_server, serve_forever_in_thread
from diffse_tpu_torch.train import CheckpointManager, TrainState
from diffse_tpu_torch.train.restore import load_snr_model
from test_torch_enhance import ARCH, FIXED_SNR, SDE_KWARGS, _model_pair
from test_torch_ncsnpp import random_jax_params
from test_torch_snr import port_snrnet, random_snrnet_params

torch.set_num_threads(2)

SNR_MONITORS = ({"monitor": "snr_error", "mode": "min", "top_k": 3},)


@pytest.fixture(scope="module")
def weights():
    return state_dict_from_jax(random_jax_params(ARCH, seed=5), **ARCH)


def _model(weights, model_type="sebridge", snr_conditioned="false", **config):
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type=model_type,
                           snr_conditioned=snr_conditioned, sigma_max=1.0, fixed_snr=FIXED_SNR,
                           **config)
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=dict(SDE_KWARGS, N=30),
                       device="cpu")
    model.backbone.load_state_dict(weights)
    return model


def _wavs(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("branch", ["sebridge", "sebridge_v2"])
def test_service_returns_what_the_packed_engine_returns(weights, branch):
    """Requests queued together form one flight, and each gets exactly what
    the packed engine gives on that flight run directly with the flight's
    generator (``flight_seed(seed, 0)``), deterministic branch or not."""
    model = _model(weights, branch)
    wavs = _wavs(0, [3000, 9000, 17000, 6500])
    svc = EnhanceService(model, config=ServiceConfig(batch_size=8, max_flight_utts=8,
                                                     max_wait_ms=300.0, seed=3))
    try:
        outs = [f.result(timeout=120) for f in [svc.submit(w) for w in wavs]]
        stats = svc.stats()
    finally:
        svc.close()
    assert stats["requests"] == 4 and stats["flights"] == 1, "requests were not coalesced"
    ref = enhance_streamed_packed(model, wavs, branch,
                                  torch.Generator().manual_seed(flight_seed(3, 0)),
                                  batch_size=8, fixed_snr=model.cfg.fixed_snr)
    for o, r, w in zip(outs, ref, wavs):
        assert o.shape == w.shape and o.dtype == np.float32
        np.testing.assert_array_equal(o, r)


def test_service_serves_concurrent_clients(weights):
    """Client threads racing into flights: every request resolves once, with
    its own length, to what spec streaming gives that utterance alone
    (deterministic branch: packing changes nothing)."""
    model = _model(weights, "sebridge")
    lengths = [2000, 5000, 9000, 13000, 3000, 7000, 11000, 4000]
    wavs = _wavs(1, lengths)
    svc = EnhanceService(model, config=ServiceConfig(batch_size=8, max_flight_utts=4,
                                                     max_wait_ms=10.0))
    results, errors, lock = {}, [], threading.Lock()

    def client(i):
        try:
            out = svc.enhance(wavs[i], timeout=120)
            with lock:
                results[i] = out
            svc.stats()
        except Exception as e:  # noqa: BLE001 -- recorded and asserted below
            with lock:
                errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(wavs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        stats = svc.stats()
    finally:
        svc.close()
    assert not errors, errors
    assert stats["requests"] == len(wavs) and stats["errors"] == 0
    assert 2 <= stats["flights"] <= len(wavs)  # at most 4 utterances a flight
    for i, w in enumerate(wavs):
        np.testing.assert_allclose(results[i], enhance_streamed_spec(model, w, "sebridge"),
                                   rtol=2e-4, atol=2e-5)


def test_service_multiple_flights_and_stats(weights):
    model = _model(weights, "sebridge_v2")
    lengths = [4000, 4100, 4200, 4300, 4400]
    svc = EnhanceService(model, config=ServiceConfig(batch_size=8, max_flight_utts=2,
                                                     max_wait_ms=50.0))
    try:
        futs = [svc.submit(w) for w in _wavs(2, lengths)]
        for f in futs:
            assert np.isfinite(f.result(timeout=120)).all()
        stats = svc.stats()
    finally:
        svc.close()
    assert stats["requests"] == 5
    assert stats["flights"] >= 3  # at most 2 utterances a flight
    assert stats["audio_seconds"] == pytest.approx(sum(lengths) / 16000)
    assert stats["rtf_x_realtime"] > 0 and stats["errors"] == 0
    # each 0.25-0.28 s utterance is one chunk; one batch of 8 rows a flight
    assert stats["chunks"] == 5 and stats["chunk_batches"] == stats["flights"]
    assert stats["chunk_occupancy"] == pytest.approx(5 / (8 * stats["flights"]))


def test_service_snr_branch_estimates_like_jax(weights):
    """sebridge_v3_snr: with no oracle value the dispatcher estimates each
    request's SNR with the model's SNRNet, as the JAX package does (same
    SNRNet weights, same estimate); an oracle ``est_snr`` is used as given."""
    snr_params = random_snrnet_params(seed=11, fc_bias=-2.0)
    jax_params = random_jax_params(ARCH, seed=5)
    ref_model, _ = _model_pair(jax_params, "sebridge_v3", 1.0, snr_conditioned="true",
                               snr_params=snr_params)
    model = _model(weights, "sebridge_v3", "true")
    model.snr_model = port_snrnet(snr_params)
    y, y2 = _wavs(3, [5000, 6000])
    est_jax = float(ref_model.estimate_snr(jnp.asarray(y)[None])[0])
    svc = EnhanceService(model, config=ServiceConfig(batch_size=8, max_flight_utts=1,
                                                     max_wait_ms=5.0))
    try:
        assert svc.model_type == "sebridge_v3_snr"
        out = svc.enhance(y, timeout=120)
        out2 = svc.enhance(y2, est_snr=0.5, timeout=120)
    finally:
        svc.close()
    assert model.estimate_snr(y[None])[0].item() == pytest.approx(est_jax, rel=1e-5)
    ref = enhance_streamed_packed(model, [y], "sebridge_v3_snr",
                                  torch.Generator().manual_seed(flight_seed(0, 0)),
                                  batch_size=8, est_snrs=[est_jax], fixed_snr=FIXED_SNR)[0]
    ref2 = enhance_streamed_packed(model, [y2], "sebridge_v3_snr",
                                   torch.Generator().manual_seed(flight_seed(0, 1)),
                                   batch_size=8, est_snrs=[0.5], fixed_snr=FIXED_SNR)[0]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out2, ref2)


def test_service_rejects_after_close(weights):
    svc = EnhanceService(_model(weights))
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros(100, np.float32))


def test_flight_seeds_are_distinct_and_reproducible():
    seeds = [flight_seed(s, i) for s in (0, 1) for i in range(4)]
    assert len(set(seeds)) == len(seeds)
    assert flight_seed(1, 3) == flight_seed(1, 3)
    assert all(0 <= s < 2 ** 64 for s in seeds)


# ---------------------------------------------------------------- failure modes


def _blocked_service(model, release, started, **cfg_kwargs):
    """A service whose first flight blocks on ``release`` (a stuck card),
    setting ``started`` when the flight begins."""
    svc = EnhanceService(model, config=ServiceConfig(batch_size=8, max_flight_utts=1,
                                                     max_wait_ms=5.0, **cfg_kwargs))
    real_execute = svc._execute_flight

    def slow_execute(flight):
        started.set()
        release.wait(timeout=60)
        real_execute(flight)

    svc._execute_flight = slow_execute
    return svc


def test_submit_rejects_oversized_request(weights):
    svc = EnhanceService(_model(weights), config=ServiceConfig(max_audio_seconds=0.5))
    try:
        with pytest.raises(RequestTooLarge):
            svc.submit(np.ones(16000, np.float32))
        assert svc.stats()["rejected"] == 1
        assert svc.enhance(_wavs(4, [4000])[0], timeout=120).shape == (4000,)
        with pytest.raises(ValueError, match="empty"):
            svc.submit(np.zeros(0, np.float32))
    finally:
        svc.close()


def test_queue_depth_limit_sheds_load(weights):
    release, started = threading.Event(), threading.Event()
    svc = _blocked_service(_model(weights), release, started, max_queue_utts=2)
    try:
        w = _wavs(5, [3000])[0]
        f0 = svc.submit(w)  # taken into the stuck flight
        assert started.wait(timeout=30)
        f1, f2 = svc.submit(w), svc.submit(w)  # the queue at its cap
        with pytest.raises(ServiceOverloaded):
            svc.submit(w)
        assert svc.stats()["rejected"] == 1
        release.set()
        for f in (f0, f1, f2):
            assert f.result(timeout=120).shape == (3000,)
    finally:
        release.set()
        svc.close()


def test_queue_time_limit_fails_stale_requests(weights):
    release, started = threading.Event(), threading.Event()
    svc = _blocked_service(_model(weights), release, started, max_queue_seconds=0.2)
    try:
        w = _wavs(6, [3000])[0]
        f0 = svc.submit(w)
        assert started.wait(timeout=30)
        stale = svc.submit(w)  # ages past 0.2 s in the queue
        time.sleep(0.4)
        release.set()
        assert f0.result(timeout=120).shape == (3000,)
        with pytest.raises(ServiceOverloaded):
            stale.result(timeout=120)
        assert svc.stats()["expired"] == 1
        assert svc.enhance(w, timeout=120).shape == (3000,)
    finally:
        release.set()
        svc.close()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dispatcher_death_fails_queued_futures(weights):
    release, started = threading.Event(), threading.Event()
    svc = _blocked_service(_model(weights), release, started)
    try:
        w = _wavs(7, [3000])[0]
        f0 = svc.submit(w)
        assert started.wait(timeout=30)
        queued = svc.submit(w)

        def bomb():
            raise AssertionError("injected dispatcher fault")

        svc._collect_flight = bomb  # the next loop iteration kills the thread
        release.set()
        assert f0.result(timeout=120).shape == (3000,)
        with pytest.raises(RuntimeError, match="dispatcher died"):
            queued.result(timeout=60)
        svc._dispatcher.join(timeout=60)
        assert not svc._dispatcher.is_alive()
        with pytest.raises(RuntimeError, match="dispatcher died"):
            svc.submit(w)
    finally:
        release.set()


def test_flight_timeout_unblocks_clients(weights):
    """A flight past flight_timeout_s fails its clients with FlightTimeout;
    it runs on a worker thread, which enters no_grad itself (grad mode is
    per thread: the backbone's parameters require grad), and the service
    serves the next flight."""
    svc = EnhanceService(_model(weights, "sebridge_v2"), config=ServiceConfig(
        batch_size=8, max_flight_utts=1, max_wait_ms=5.0, flight_timeout_s=0.15,
        max_queue_seconds=600.0))
    real_execute = svc._execute_flight
    calls = []

    def sometimes_slow(flight):
        calls.append(None)
        if len(calls) == 1:
            threading.Event().wait(0.6)
        real_execute(flight)

    svc._execute_flight = sometimes_slow
    try:
        w = _wavs(8, [3000])[0]
        with pytest.raises(FlightTimeout):
            svc.enhance(w, timeout=120)
        assert svc.stats()["flight_timeouts"] == 1
        svc.cfg.flight_timeout_s = 300.0
        assert np.isfinite(svc.enhance(w, timeout=120)).all()
        assert svc.stats()["errors"] == 0
    finally:
        svc.close()


def test_service_latency_stats(weights):
    """stats() reports the end-to-end latency window (p50/p95/p99/max over
    the last latency_window requests)."""
    with EnhanceService(_model(weights), config=ServiceConfig(
            batch_size=8, max_flight_utts=4, max_wait_ms=50.0, latency_window=3)) as svc:
        assert svc.stats()["latency_ms"] is None
        for f in [svc.submit(w) for w in _wavs(9, [3000, 6000, 4000, 5000])]:
            f.result(timeout=120)
        s = svc.stats()
    lm = s["latency_ms"]
    assert lm["count"] == 3
    assert 0.0 < lm["p50"] <= lm["p95"] <= lm["p99"] <= lm["max"] < 300_000


# --------------------------------------------------------------------- HTTP


def _post(base, body, query=""):
    req = urllib.request.Request(base + "/enhance" + query, data=body, method="POST")
    return urllib.request.urlopen(req, timeout=120)


def _http_status(fn):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn()
    return ei.value


@pytest.fixture
def http_service(weights):
    """``start(**config) -> (base url, service)``; shut down after the test."""
    started = []

    def start(max_body_bytes=64 * 1024 * 1024, service=None, **cfg):
        svc = service or EnhanceService(_model(weights), config=ServiceConfig(
            batch_size=8, max_flight_utts=4, max_wait_ms=10.0, **cfg))
        server = make_server(svc, port=0, max_body_bytes=max_body_bytes)
        thread = serve_forever_in_thread(server)
        started.append((server, thread, svc))
        host, port = server.server_address[:2]
        return f"http://{host}:{port}", svc

    yield start
    for server, thread, svc in started:
        server.shutdown()
        thread.join(timeout=10)
        svc.close()


def test_http_server_roundtrip(http_service):
    """POST a WAV, get the enhanced WAV back; /healthz and /stats answer."""
    base, _ = http_service()
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    y = _wavs(10, [5000])[0]
    with _post(base, wav_bytes(y, 16000, subtype="float32")) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        out, sr = parse_wav(r.read())
    assert sr == 16000 and out.shape == (1, 5000) and np.isfinite(out).all()
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] == 1 and stats["chunks"] == 1
    assert _http_status(lambda: _post(base, b"not a wav")).code == 400
    assert _http_status(lambda: urllib.request.urlopen(base + "/nope", timeout=30)).code == 404


def test_http_request_limits(http_service):
    """The body cap and the service's audio limit are 413, a POST without a
    body 411, an unknown path 404, and an in-limit request still 200."""
    base, _ = http_service(max_body_bytes=200_000, max_audio_seconds=0.5)
    body = wav_bytes(_wavs(11, [16000])[0], 16000, subtype="float32")
    assert _http_status(lambda: _post(base, body)).code == 413
    big = wav_bytes(_wavs(12, [80000])[0], 16000, subtype="float32")
    assert _http_status(lambda: _post(base, big)).code == 413
    assert _http_status(lambda: _post(base, b"")).code == 411
    req = urllib.request.Request(base + "/other", data=body, method="POST")
    assert _http_status(lambda: urllib.request.urlopen(req, timeout=30)).code == 404
    with _post(base, wav_bytes(_wavs(13, [4000])[0], 16000, subtype="float32")) as r:
        assert r.status == 200


def test_http_overload_and_flight_timeout(weights, http_service):
    """ServiceOverloaded is 503 with Retry-After; FlightTimeout is 504."""
    release, started = threading.Event(), threading.Event()
    blocked = _blocked_service(_model(weights), release, started, max_queue_utts=0)
    base, _ = http_service(service=blocked)
    body = wav_bytes(_wavs(14, [3000])[0], 16000, subtype="float32")
    try:
        err = _http_status(lambda: _post(base, body))
        assert err.code == 503 and err.headers["Retry-After"] == "1"
    finally:
        release.set()
    slow = EnhanceService(_model(weights), config=ServiceConfig(
        batch_size=8, max_flight_utts=1, max_wait_ms=5.0, flight_timeout_s=0.05))
    real_execute = slow._execute_flight

    def stuck(flight):
        threading.Event().wait(0.4)
        real_execute(flight)

    slow._execute_flight = stuck
    base, _ = http_service(service=slow)
    assert _http_status(lambda: _post(base, body)).code == 504


# --------------------------------------------------- checkpoints and the CLI


def test_snr_model_hparams_round_trip():
    cfg = SNRModelConfig(lr=3e-4, num_frames=128)
    model = SNRModel(cfg, device="cpu")
    again = SNRModel.from_hparams(json.loads(json.dumps(model.hparams)), device="cpu",
                                  ema_decay=0.99)
    assert again.cfg == SNRModelConfig(lr=3e-4, num_frames=128, ema_decay=0.99)


def _snr_checkpoint(directory, metrics_by_step, snr_params=None):
    """An SNR-estimator checkpoint written by the port's CheckpointManager:
    one step per entry, its SNRNet's output bias (and its EMA's) -step."""
    dnn = port_snrnet(snr_params or random_snrnet_params(seed=11, fc_bias=-2.0))
    model = SNRModel(device="cpu", dnn=dnn)
    mgr = CheckpointManager(str(directory), monitors=SNR_MONITORS, hparams=model.hparams)
    for step, metrics in metrics_by_step.items():
        with torch.no_grad():
            model.dnn.fc.bias.fill_(-float(step))
        state = TrainState(model.dnn, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
        state.step = step
        mgr.save(step, state, metrics)
    return model


@pytest.mark.parametrize("metrics,expected", [
    ({1: {"snr_error": 3.0}, 2: {"snr_error": 1.0}, 3: {"snr_error": 2.0}}, 2),
    ({1: {}, 2: {}}, 2)], ids=["best_by_snr_error", "latest_without_metrics"])
def test_load_snr_model_picks_the_best_or_the_latest(tmp_path, metrics, expected):
    _snr_checkpoint(tmp_path, metrics)
    model, state = load_snr_model(str(tmp_path), device="cpu")
    assert state.step == expected
    assert model.dnn.fc.bias[0].item() == -float(expected)
    assert model.device == torch.device("cpu")


def test_cli_serve_answers_a_post(weights, tmp_path):
    """``cli.serve.main(block=False)`` on a checkpoint the port wrote, with
    ``--snr_ckpt`` for the SNR branch: the EMA weights are served, and a
    POST comes back enhanced."""
    model = _model(weights, "sebridge_v3", "true")
    state = TrainState(model.backbone, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
    with torch.no_grad():
        for e in state.ema:
            e.mul_(0.5)
    ema = [e.clone() for e in state.ema]
    CheckpointManager(str(tmp_path / "score"), hparams=model.hparams).save(4, state)
    _snr_checkpoint(tmp_path / "snr", {7: {"snr_error": 1.5}})
    server, service, thread = serve.main(
        ["--ckpt", str(tmp_path / "score"), "--snr_ckpt", str(tmp_path / "snr"), "--port", "0",
         "--batch_size", "4", "--device", "cpu"], block=False)
    try:
        assert service.model_type == "sebridge_v3_snr"
        assert service.model.snr_model.fc.bias[0].item() == -7.0
        served = [p for p in service.model.backbone.parameters() if p.requires_grad]
        assert all(torch.equal(p, e) for p, e in zip(served, ema))
        host, port = server.server_address[:2]
        y = _wavs(15, [6000])[0]
        with _post(f"http://{host}:{port}", wav_bytes(y, 16000, subtype="float32")) as r:
            out, sr = parse_wav(r.read())
        assert r.status == 200 and out.shape == (1, 6000) and np.isfinite(out).all()
    finally:
        server.shutdown()
        thread.join(timeout=10)
        service.close()
