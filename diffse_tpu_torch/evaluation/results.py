"""Result-collection helpers (twins of the reference's top-level utils.py
Method/print_metrics/ensure_dir surface, utils.py:48-117): the port's own copy
of diffse_tpu/evaluation/results.py, plus ``write_csv``, which writes the
CLIs' result tables as pandas would."""

from __future__ import annotations

import csv
import numbers
import os
from typing import Dict, List, Sequence

import numpy as np

from .metrics import estoi, mean_conf_int, pesq_wb, si_sdr


class Method:
    """Named metric accumulator (utils.py:48-63)."""

    def __init__(self, name: str, base_dir: str, metrics: Sequence[str]):
        self.name = name
        self.base_dir = base_dir
        self.metrics: Dict[str, List[float]] = {m: [] for m in metrics}

    def append(self, metric: str, value: float) -> None:
        self.metrics[metric].append(value)

    def get_mean_ci(self, metric: str):
        return mean_conf_int(np.array(self.metrics[metric]))


def ensure_dir(file_path: str) -> None:
    """mkdir -p (utils.py:102-105 / other.py:102-105)."""
    if not os.path.exists(file_path):
        os.makedirs(file_path)


def print_metrics(x, y, x_hat_list, labels, sr: int = 16000) -> None:
    """Print mixture + per-method PESQ/ESTOI/SI-SDR (other.py:108-117)."""
    _si_sdr_mix = si_sdr(x, y)
    _pesq_mix = pesq_wb(sr, x, y)
    _estoi_mix = estoi(x, y, sr)
    print(f"Mixture:  PESQ: {_pesq_mix:.2f}, ESTOI: {_estoi_mix:.2f}, "
          f"SI-SDR: {_si_sdr_mix:.2f}")
    for i, x_hat in enumerate(x_hat_list):
        v_sdr = si_sdr(x, x_hat)
        v_pesq = pesq_wb(sr, x, x_hat)
        v_estoi = estoi(x, x_hat, sr)
        print(f"{labels[i]}: {v_pesq:.2f}, ESTOI: {v_estoi:.2f}, SI-SDR: {v_sdr:.2f}")


def _csv_column(values) -> List[str]:
    """One column's fields as pandas' ``to_csv`` writes them: a column of
    numpy float32 values in float32's shortest repr, any other numbers as
    Python floats' repr, NaN as an empty field, anything else as ``str``."""
    if all(isinstance(v, numbers.Number) for v in values):
        float32 = all(isinstance(v, np.float32) for v in values)
        return ["" if np.isnan(v) else (str(np.float32(v)) if float32 else repr(float(v)))
                for v in values]
    return [str(v) for v in values]


def write_csv(path: str, data: Dict[str, list]) -> None:
    """Write ``data`` (column name -> values, one per row) as the CSV that
    ``pandas.DataFrame(data).to_csv(path, index=False)`` writes, with the
    ``csv`` module (pandas is not a dependency of the port)."""
    columns = [_csv_column(list(values)) for values in data.values()]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(data))
        writer.writerows(zip(*columns))
