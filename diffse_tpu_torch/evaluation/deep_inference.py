"""Per-SNR sweep validation harness (port of
diffse_tpu/evaluation/deep_inference.py): ``deep_evaluate_model``.

For each picked valid2 utterance, nine SNR variants

    y = x + (y_default - x) * 10^(-SNR/20),  SNR in {0, 5, ..., 40}

(effective input SNRs -5..35 dB given the -5 dB base mixture) are enhanced,
and 27 scalars come back: per-SNR SI-SDR, PESQ and ESTOI (the reference logs
them as pesq_-5 ... estoi_35, model.py:449-477).

The nine variants of one file share its length, so they run as one 9-row
batch of the eval harness's function (``batch_eval.batch_enhance``, per-row
normalisation and estimate). Files run in bucket order, so that a bucket's
captured 9-row program serves its files in a row. Draws: file ``i`` (its
index among the picked files) runs ``batch_enhance`` under seed
``dispatch_seed(seed, i)``, or with ``noise(i)`` as its one dispatch's
source: the JAX package's ``fold_in(key, i)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.score_model import ScoreModel
from .batch_eval import batch_enhance
from .inference import (
    SR,
    NoiseFor,
    bucket_order,
    dispatch_seed,
    pick_files,
    read_pairs,
)
from .metrics import estoi, pesq_wb, si_sdr

SNR_GRID = list(range(0, 41, 5))


def deep_evaluate_model(model: ScoreModel, data_module, num_eval_files: int,
                        model_type: str = "bbed", fixed_snr: float = 1.0, seed: int = 0,
                        noise: Optional[NoiseFor] = None) -> tuple:
    """(si_sdr_0..si_sdr_40, pesq_0..pesq_40, estoi_0..estoi_40): 27 scalars
    in the reference's order (deep_inference.py:291-297), each a mean over
    the picked files. Enhances with the backbone's own weights."""
    xs, ys = read_pairs(*pick_files(data_module.valid_set_2, num_eval_files))
    n = len(SNR_GRID)
    per_file = [None] * len(xs)
    for i in bucket_order(ys, model.cfg.hop_length):
        x_def, y_def = xs[i], ys[i]
        y0_def = y_def - x_def
        variants = [x_def + y0_def * 10 ** (-snr_db / 20) for snr_db in SNR_GRID]
        est_snrs = None
        if model_type.endswith("_snr"):
            est_snrs = model.estimate_snr(np.stack(variants)).cpu().tolist()
        x_hats = batch_enhance(
            model, [x_def] * n, variants, model_type, seed=dispatch_seed(seed, i),
            batch_size=n, est_snrs=est_snrs, fixed_snr=fixed_snr,
            noise=None if noise is None else (lambda b, i=i: noise(i)))
        per_file[i] = [(si_sdr(x_def, x_hat), pesq_wb(SR, x_def, x_hat), estoi(x_def, x_hat, SR))
                       for x_hat in x_hats]
    acc = np.zeros((3, n))
    for scores in per_file:  # summed in file order, as the reference does
        acc += np.asarray(scores).T
    acc /= len(xs)
    return tuple(acc[0]) + tuple(acc[1]) + tuple(acc[2])
