"""One-command reproduction of the paper's Tables 1/2/3 vs BASELINE.md (the
port's counterpart of tools/reproduce_tables.py, with its flags, lines and
exit codes, plus ``--device``).

The published checkpoints and VoiceBank-DEMAND are not in the repository;
this harness stages the comparison to a single command for the day they are
available:

    python -m diffse_tpu_torch.cli.reproduce_tables --vbd_dir /path/VBD_SNR-5 \\
        --ckpt M6.ckpt --snr_ckpt snr_estimator.ckpt --eta 10

What it does:

1. torch Lightning ``.ckpt`` inputs are imported with
   ``diffse_tpu_torch.cli.convert_torch_checkpoint`` (``--ema``, the weights
   the paper evaluates); a port checkpoint directory (one with
   ``hparams.json``) passes through unchanged.
2. Table 1: ``cli.eval`` over ``<vbd_dir>/valid`` (estimated SNR via the
   imported SNR estimator; ``--oracle`` switches to the M1–M3 oracle
   protocol using ``valid/active_rms.txt``), plus mixture scores — compared
   against the η-matched BASELINE.md Table-1 rows.
3. Tables 2/3: ``cli.deep_eval`` over ``<vbd_dir>/valid2`` (the 9-SNR sweep,
   deep_eval.py:112-118) — per-SNR PESQ/SI-SDR means compared against the
   η row of Tables 2/3.
4. PASS/FAIL per cell: PESQ/ESTOI within ``--tol_pesq``/``--tol_estoi``
   (default 0.02, the BASELINE.md parity target); SI-SDR within
   ``--tol_sisdr`` dB (default 0.2 — the paper prints 0.1 dB resolution).
   Exit code 0 iff every compared cell passes.

``--synthetic_dry_run`` builds a synthetic VBD stand-in plus freshly
initialized tiny checkpoints and drives the ENTIRE pipeline end to end
(conversion skipped, comparisons reported but not enforced) — proving the
harness mechanics without the real data. ``--device`` (the card unless
"cpu" is given) is passed to both evaluation CLIs.

Reference workflow: the reference README.md:44-53 (published ckpts for
M4/M5/M6 + SNR estimator), eval loop sgmse-bbed/eval.py:126-170, SNR sweep
deep_eval.py:101-163. η ∈ {0,5,10} ↔ fixed_snr ∈ {0.56234,0.31623,0.17783}
(README.md:37).
"""

from __future__ import annotations

import argparse
import json
import os

# ------------------------------------------------------- published baselines
# BASELINE.md Tables 1-3 (Paper.pdf, Interspeech 2025). Keyed by (eta, oracle).
TABLE1 = {
    "mixture": dict(pesq=1.97, estoi=0.79, si_sdr=8.4),
    (0, True): dict(pesq=3.02, estoi=0.85, si_sdr=18.79),   # M1
    (5, True): dict(pesq=3.07, estoi=0.86, si_sdr=19.22),   # M2
    (10, True): dict(pesq=3.09, estoi=0.87, si_sdr=19.02),  # M3
    (0, False): dict(pesq=3.02, estoi=0.85, si_sdr=18.83),  # M4
    (5, False): dict(pesq=3.07, estoi=0.86, si_sdr=19.23),  # M5
    (10, False): dict(pesq=3.09, estoi=0.87, si_sdr=19.01),  # M6
}
SNR_GRID = [-5, 0, 5, 10, 15, 20, 25, 30, 35]
TABLE2_PESQ = {  # per input SNR, augmented VBD (BASELINE.md Table 2)
    0: [2.11, 2.50, 2.83, 3.13, 3.42, 3.70, 3.94, 4.13, 4.27],   # M4
    5: [2.07, 2.51, 2.89, 3.20, 3.46, 3.72, 3.96, 4.14, 4.26],   # M5
    10: [2.01, 2.48, 2.90, 3.22, 3.51, 3.75, 3.96, 4.13, 4.24],  # M6
}
TABLE3_SISDR = {
    0: [13.7, 16.8, 18.3, 19.2, 20.2, 21.2, 22.5, 23.6, 24.4],   # M4
    5: [12.2, 16.4, 18.6, 19.9, 20.9, 22.0, 23.3, 24.4, 25.1],   # M5
    10: [8.5, 14.3, 18.0, 20.2, 21.7, 23.1, 24.6, 25.9, 26.6],   # M6
}
ETA_FIXED_SNR = {0: 0.56234, 5: 0.31623, 10: 0.17783}
M_NAME = {(0, True): "M1", (5, True): "M2", (10, True): "M3",
          (0, False): "M4", (5, False): "M5", (10, False): "M6"}


def ensure_checkpoint(path: str, kind: str, out_root: str) -> str:
    """Import a torch Lightning .ckpt as a port checkpoint directory (once);
    pass an existing port checkpoint directory through unchanged."""
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, "hparams.json")):
            raise FileNotFoundError(
                f"{path} is a directory but has no hparams.json — not a port "
                "checkpoint dir")
        return path
    out = os.path.join(out_root, f"converted_{kind}")
    if not os.path.exists(os.path.join(out, "hparams.json")):
        print(f"[tables] converting {path} -> {out} (kind={kind}, EMA)")
        from . import convert_torch_checkpoint

        convert_torch_checkpoint.main(["--torch_ckpt", path, "--out_dir", out,
                                       "--ema", "--kind", kind])
    return out


def _mean(xs):
    import numpy as np

    xs = [x for x in xs if np.isfinite(x)]
    return float(np.mean(xs)) if xs else float("nan")


def _check(label, got, want, tol, failures, enforce=True):
    ok = abs(got - want) <= tol
    mark = "PASS" if ok else "FAIL"
    print(f"  {label:<28} ours={got:7.3f}  published={want:7.3f}  "
          f"tol={tol:g}  {mark}")
    if enforce and not ok:
        failures.append(label)


def read_columns(path: str) -> dict:
    """A CLI's result CSV as columns: each metric column's fields as floats
    (an empty field, pandas' NaN, as NaN), the file names as strings."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    columns = {name: [row[i] for row in rows[1:]] for i, name in enumerate(rows[0])}
    return {name: values if name == "filename"
            else [float(v) if v else float("nan") for v in values]
            for name, values in columns.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--vbd_dir", type=str, default=None,
                        help="VBD_SNR-5 root: valid/{clean,noisy,active_rms"
                             ".txt} + valid2/{clean,noisy}")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="score checkpoint: torch .ckpt or port checkpoint dir")
    parser.add_argument("--snr_ckpt", type=str, default=None,
                        help="SNR-estimator checkpoint: torch .ckpt or "
                             "port checkpoint dir (needed unless --oracle)")
    parser.add_argument("--eta", type=int, choices=(0, 5, 10), default=10,
                        help="which published model row to compare against "
                             "(M4/M5/M6, or M1/M2/M3 with --oracle)")
    parser.add_argument("--oracle", action="store_true",
                        help="oracle-SNR protocol (M1-M3): uses "
                             "valid/active_rms.txt instead of the estimator")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--N", type=int, default=30)
    parser.add_argument("--eval_batch_size", type=int, default=1)
    parser.add_argument("--tol_pesq", type=float, default=0.02)
    parser.add_argument("--tol_estoi", type=float, default=0.02)
    parser.add_argument("--tol_sisdr", type=float, default=0.2)
    parser.add_argument("--skip_table1", action="store_true")
    parser.add_argument("--skip_tables23", action="store_true")
    parser.add_argument("--synthetic_dry_run", action="store_true",
                        help="build synthetic data + tiny fresh checkpoints "
                             "and run the full pipeline mechanically "
                             "(no pass/fail enforcement)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the evaluation CLIs enhance: the card (default) or cpu")
    args = parser.parse_args(argv)

    import tempfile

    out_root = args.out_dir or tempfile.mkdtemp(prefix="repro_tables_")
    os.makedirs(out_root, exist_ok=True)
    enforce = not args.synthetic_dry_run

    if args.synthetic_dry_run:
        vbd, score_dir, snr_dir = _make_dry_run_inputs(out_root)
    else:
        if not (args.vbd_dir and args.ckpt):
            parser.error("--vbd_dir and --ckpt are required "
                         "(or use --synthetic_dry_run)")
        vbd = args.vbd_dir
        score_dir = ensure_checkpoint(args.ckpt, "score", out_root)
        snr_dir = (ensure_checkpoint(args.snr_ckpt, "snrnet", out_root)
                   if args.snr_ckpt else None)
        if not args.oracle and snr_dir is None:
            parser.error("--snr_ckpt required for the estimated-SNR protocol "
                         "(M4-M6); pass --oracle for M1-M3")

    # sanity: the checkpoint's fixed_snr should match the requested eta row
    with open(os.path.join(score_dir, "hparams.json")) as f:
        hp = json.load(f)
    fixed_snr = hp.get("config", {}).get("fixed_snr")
    want_fs = ETA_FIXED_SNR[args.eta]
    if fixed_snr is not None and abs(fixed_snr - want_fs) > 1e-4 and enforce:
        print(f"[tables] WARNING: checkpoint fixed_snr={fixed_snr} does not "
              f"match eta={args.eta} (expected {want_fs}) — comparing against "
              f"the eta={args.eta} rows anyway")

    from . import deep_eval as deep_eval_cli
    from . import eval as eval_cli

    failures = []
    mname = M_NAME[(args.eta, bool(args.oracle))]

    # ------------------------------------------------------------- Table 1
    if not args.skip_table1:
        t1_dir = os.path.join(out_root, "table1")
        os.makedirs(t1_dir, exist_ok=True)
        eval_args = [
            "--destination_folder", t1_dir,
            "--test_dir", os.path.join(vbd, "valid"),
            "--ckpt", score_dir,
            "--N", str(args.N),
            "--eval_batch_size", str(args.eval_batch_size),
            "--device", args.device,
        ]
        if args.oracle:
            eval_args += ["--oracle", "True"]
        elif snr_dir:
            eval_args += ["--snr_ckpt", snr_dir]
        print(f"[tables] Table 1: eval over {vbd}/valid ({mname} protocol)")
        eval_cli.main(eval_args)

        df = read_columns(os.path.join(t1_dir, "_results.csv"))
        got = {m: _mean(df[m]) for m in ("pesq", "si_sdr", "estoi")}

        mix = _mixture_scores(os.path.join(vbd, "valid"))
        print(f"\n[tables] ==== Table 1 ({mname}) ====")
        pub = TABLE1[(args.eta, bool(args.oracle))]
        _check("mixture PESQ", mix["pesq"], TABLE1["mixture"]["pesq"],
               args.tol_pesq, failures, enforce)
        _check("mixture ESTOI", mix["estoi"], TABLE1["mixture"]["estoi"],
               args.tol_estoi, failures, enforce)
        _check("mixture SI-SDR", mix["si_sdr"], TABLE1["mixture"]["si_sdr"],
               args.tol_sisdr, failures, enforce)
        _check(f"{mname} PESQ", got["pesq"], pub["pesq"], args.tol_pesq,
               failures, enforce)
        _check(f"{mname} ESTOI", got["estoi"], pub["estoi"], args.tol_estoi,
               failures, enforce)
        _check(f"{mname} SI-SDR", got["si_sdr"], pub["si_sdr"],
               args.tol_sisdr, failures, enforce)

    # ---------------------------------------------------------- Tables 2/3
    if not args.skip_tables23:
        t23_dir = os.path.join(out_root, "tables23")
        os.makedirs(t23_dir, exist_ok=True)
        deep_args = [
            "--destination_folder", t23_dir,
            "--test_dir", os.path.join(vbd, "valid2"),
            "--ckpt", score_dir,
            "--N", str(args.N),
            "--device", args.device,
        ]
        # deep_eval's protocol is oracle-rms by construction for the sweep
        # (deep_eval.py:117-118) unless the estimator drives it (M4-M6)
        if args.oracle:
            deep_args += ["--oracle", "True"]
        elif snr_dir:
            deep_args += ["--snr_ckpt", snr_dir]
        print(f"[tables] Tables 2/3: deep_eval over {vbd}/valid2")
        deep_eval_cli.main(deep_args)

        df = read_columns(os.path.join(t23_dir, "_results_deep.csv"))
        print(f"\n[tables] ==== Table 2 (PESQ by input SNR, {mname}) ====")
        for i, s in enumerate(SNR_GRID):
            _check(f"PESQ @ {s:+d} dB", _mean(df[f"pesq_{s}"]),
                   TABLE2_PESQ[args.eta][i], args.tol_pesq, failures, enforce)
        print(f"\n[tables] ==== Table 3 (SI-SDR by input SNR, {mname}) ====")
        for i, s in enumerate(SNR_GRID):
            _check(f"SI-SDR @ {s:+d} dB", _mean(df[f"si_sdr_{s}"]),
                   TABLE3_SISDR[args.eta][i], args.tol_sisdr, failures,
                   enforce)

    verdict = ("DRY-RUN COMPLETE (comparisons not enforced)"
               if args.synthetic_dry_run
               else ("PARITY PASS" if not failures
                     else f"PARITY FAIL ({len(failures)} cells): {failures}"))
    print(f"\n[tables] RESULT {json.dumps(dict(verdict=verdict, out=out_root))}")
    return 0 if (args.synthetic_dry_run or not failures) else 1


def _mixture_scores(valid_dir: str) -> dict:
    """Mixture (noisy-vs-clean) PESQ/ESTOI/SI-SDR over the test set — the
    Table-1 'Mixture' row (Paper.pdf Table 1)."""
    import glob

    from ..data.wavio import read_wav
    from ..evaluation.metrics import estoi, pesq_wb, si_sdr

    p, e, s = [], [], []
    for nf in sorted(glob.glob(os.path.join(valid_dir, "noisy", "*.wav"))):
        cf = os.path.join(valid_dir, "clean", os.path.basename(nf))
        x, _ = read_wav(cf)
        y, _ = read_wav(nf)
        x1, y1 = x[0], y[0]
        p.append(pesq_wb(16000, x1, y1))
        e.append(float(estoi(x1, y1, 16000)))
        s.append(float(si_sdr(x1, y1)))
    return dict(pesq=_mean(p), estoi=_mean(e), si_sdr=_mean(s))


def _make_dry_run_inputs(out_root: str):
    """Synthetic VBD stand-in + freshly initialized tiny checkpoints
    (sebridge_v3/snr_conditioned=true so the estimator path is exercised),
    built on the CPU and saved by the port's ``CheckpointManager``."""
    import torch

    from ..data.synthetic import make_synthetic_dataset
    from ..models.score_model import ScoreModel, ScoreModelConfig
    from ..models.snr_model import SNRModel, SNRModelConfig
    from ..models.snrnet import SNRNet
    from ..train import CheckpointManager, TrainState

    vbd = os.path.join(out_root, "vbd_synth")
    make_synthetic_dataset(vbd, num_train=2, num_valid=3, num_valid2=2,
                           num_test=2, duration_s=1.2)

    cfg = ScoreModelConfig(
        backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
        snr_conditioned="true", fixed_snr=ETA_FIXED_SNR[10], sigma_max=1.0,
    )
    model = ScoreModel(
        cfg,
        backbone_kwargs=dict(nf=4, ch_mult=(1, 1), num_res_blocks=1,
                             attn_resolutions=(128,), image_size=256),
        sde_kwargs=dict(T_sampling=0.999, k=2.6, theta=0.52, N=30),
        device="cpu", generator=torch.Generator().manual_seed(0),
    )
    score_dir = os.path.join(out_root, "ckpt_score")
    CheckpointManager(score_dir, hparams=model.hparams).save(1, TrainState(model.backbone))

    with torch.random.fork_rng(devices=[]):  # SNRNet's init draws from the global RNG
        torch.manual_seed(1)
        snr_model = SNRModel(SNRModelConfig(), device="cpu", dnn=SNRNet())
    snr_dir = os.path.join(out_root, "ckpt_snr")
    CheckpointManager(snr_dir, hparams=snr_model.hparams).save(1, TrainState(snr_model.dnn))
    return vbd, score_dir, snr_dir


if __name__ == "__main__":
    raise SystemExit(main())
