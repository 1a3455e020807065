"""The port's copies of the JAX package's numpy/scipy evaluation modules
(``evaluation/metrics.py``, ``pesq_native.py``, ``pesq_tables.py``,
``results.py``, ``data/synthetic.py``) against the originals, on the same
seeded signals. They are the same numpy code, so the tolerance is none: every
value bit for bit. The reference dataset's real speech pairs are included
when that directory is present (as in tests/test_metric_goldens.py) and
skipped otherwise."""

import os

import numpy as np
import pytest

from diffse_tpu.data import synthetic as jax_synthetic
from diffse_tpu.data.wavio import read_wav
from diffse_tpu.evaluation import metrics as jax_metrics
from diffse_tpu.evaluation import pesq_tables as jax_tables
from diffse_tpu.evaluation import results as jax_results
from diffse_tpu_torch.data import synthetic
from diffse_tpu_torch.evaluation import metrics, pesq_tables, results
from test_metric_goldens import PAIR_GOLDENS
from test_metric_goldens import _ROOT as REFERENCE_ROOT

SR = 16000


def _signals(seed, seconds=1.2):
    """A speech-like clean signal, a noise, and their mixture (float32)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = synthetic._speech_like(rng, n, SR)
    noise = 0.1 * rng.standard_normal(n).astype(np.float32)
    return x, noise, (x + noise).astype(np.float32)


# name -> f(module, x, noise, y): the metric evaluated through `module`
METRIC_CASES = {
    "si_sdr": lambda m, x, n, y: m.si_sdr(x, y),
    "si_sdr_components": lambda m, x, n, y: m.si_sdr_components(y, x, n),
    "energy_ratios": lambda m, x, n, y: m.energy_ratios(y, x, n),
    "mean_conf_int": lambda m, x, n, y: m.mean_conf_int(y[:50]),
    "mean_std": lambda m, x, n, y: m.mean_std(np.where(y[:50] > 0.1, np.nan, y[:50])),
    "print_mean_std_1": lambda m, x, n, y: m.print_mean_std(y[:50], decimal=1),
    "print_mean_std_2": lambda m, x, n, y: m.print_mean_std(y[:50]),
    "print_mean_std_3": lambda m, x, n, y: m.print_mean_std(y[:50], decimal=3),
    "hp_filter": lambda m, x, n, y: m.hp_filter(y),
    "snr_dB": lambda m, x, n, y: m.snr_dB(x, n),
    "active_rms": lambda m, x, n, y: m.active_rms(x, n),
    "calculate_snr": lambda m, x, n, y: m.calculate_snr(x, n),
    "calculate_normfac": lambda m, x, n, y: m.calculate_normfac(x, n),
    "stoi": lambda m, x, n, y: m.stoi(x, y, SR),
    "estoi": lambda m, x, n, y: m.estoi(x, y, SR),
    "pesq_wb": lambda m, x, n, y: m.pesq_wb(SR, x, y),
    "pesq_wb_identity": lambda m, x, n, y: m.pesq_wb(SR, x, x),
    "pesq_wb_silent": lambda m, x, n, y: m.pesq_wb(SR, np.zeros_like(x), np.zeros_like(x)),
}


def _reference_pair(subset, name):
    x, _ = read_wav(os.path.join(REFERENCE_ROOT, subset, "clean", name))
    y, _ = read_wav(os.path.join(REFERENCE_ROOT, subset, "noisy", name))
    n = min(x.shape[-1], y.shape[-1])
    return x[0, :n], (y[0, :n] - x[0, :n]), y[0, :n]


_REFERENCE_CASES = [
    pytest.param(name, ("reference", subset, wav), id=f"{name}-{subset}/{wav}",
                 marks=pytest.mark.skipif(not os.path.isdir(REFERENCE_ROOT),
                                          reason="reference dataset not present"))
    for subset, wav, *_ in PAIR_GOLDENS for name in ("pesq_wb", "estoi", "si_sdr")]


@pytest.mark.parametrize("name,source", [
    *[(name, ("seeded", 3)) for name in METRIC_CASES],
    ("pesq_wb", ("seeded", 7)), ("estoi", ("seeded", 7)),
    *_REFERENCE_CASES])
def test_metric_matches_jax(name, source):
    """Each metric of ``metrics.py`` and PESQ through the native path (no
    ``pesq`` wheel here), port vs JAX package: bit for bit."""
    kind, *where = source
    x, noise, y = _signals(where[0]) if kind == "seeded" else _reference_pair(*where)
    ours = METRIC_CASES[name](metrics, x, noise, y)
    ref = METRIC_CASES[name](jax_metrics, x, noise, y)
    if isinstance(ref, str):
        assert ours == ref
    else:
        np.testing.assert_array_equal(np.asarray(ours, dtype=np.float64),
                                      np.asarray(ref, dtype=np.float64))
    assert metrics.HAS_PESQ == jax_metrics.HAS_PESQ


def test_pesq_tables_match_jax():
    names = [n for n in dir(jax_tables) if n.isupper()]
    assert names == [n for n in dir(pesq_tables) if n.isupper()]
    for n in names:
        np.testing.assert_array_equal(getattr(pesq_tables, n), getattr(jax_tables, n))


def test_method_and_print_metrics_match_jax(capsys):
    x, _, y = _signals(5, seconds=1.0)
    ours, ref = (m.Method("m", "/tmp", ["pesq", "si_sdr"]) for m in (results, jax_results))
    for m in (ours, ref):
        for v in (1.0, 2.5, 3.25):
            m.append("pesq", v)
    assert ours.get_mean_ci("pesq") == ref.get_mean_ci("pesq")
    results.print_metrics(x, y, [0.5 * y + 0.5 * x], ["half"])
    printed = capsys.readouterr().out
    jax_results.print_metrics(x, y, [0.5 * y + 0.5 * x], ["half"])
    assert printed == capsys.readouterr().out


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("seed,noise_type", [(0, "lp3k"), (4, "white_amod")])
def test_synthetic_dataset_matches_jax(tmp_path, seed, noise_type):
    """The same wav samples and ``active_rms.txt`` from the same seed."""
    kw = dict(num_train=2, num_valid=2, num_valid2=1, num_test=2, duration_s=0.7, seed=seed,
              noise_type=noise_type)
    ours = _tree_bytes(synthetic.make_synthetic_dataset(str(tmp_path / "port"), **kw))
    ref = _tree_bytes(jax_synthetic.make_synthetic_dataset(str(tmp_path / "jax"), **kw))
    assert sorted(ours) == sorted(ref)
    assert "valid/active_rms.txt" in ours
    for name in ref:
        assert ours[name] == ref[name], name
