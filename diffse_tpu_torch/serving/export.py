"""The enhance program as a file that runs with no model code (port of
diffse_tpu/serving/export.py, which serialises a ``jax.export`` program).

``save_artifact`` traces ``ScoreModel``'s bucket-static enhance program,
normalise -> STFT -> the sampler's steps (unrolled) or the one forward ->
iSTFT, with ``torch.export`` (one program per distinct width bucket) and
writes:

    artifact_dir/
      enhance_t<frames>.pt2   the exported program of one width bucket
      weights.pt              the backbone's parameters and buffers by name
      meta.json               branch, sampler, buckets, the host contract

The hand kernels stay in the program as the operators of
``ops.cuda_kernels`` (``torch.ops.diffse.*``): the loader imports that
kernel library, which registers them, and nothing of ``models``,
``sampling``, ``sde`` or ``transforms``. A program is traced for one
device, the one the model is on (``meta["device"]``), and loads there.

The program's inputs: the weights (one dict, so that every bucket's program
shares one copy), the clean and noisy waveforms ``[1, pad_samples]``, the
noise, and three float32 scalars: the corrector's ``snr`` (``bbed_pc``),
``t_hat`` and ``normfac`` (the ``_snr`` branches, from the client's
``est_snr`` snapped on the host as ``ScoreModel.enhance`` snaps it,
``karras.snap_to_karras_grid``). Its output is the waveform ``[1, pad']``.

Randomness: a ``torch.Generator`` cannot be an input of an exported graph,
so the program takes its draws as an input, ``[n_draws, *shape, 2]``
float32 (the complex draws' real views: the export carries complex
tensors inside the graph, but its inputs and output are real). The loader
draws them from ``torch.Generator(device).manual_seed(seed)`` one after the
other, with the shapes and in the order ``ScoreModel.enhance`` draws them
(recorded at export in ``meta["noise"]``), so that the artifact's output
is ``enhance``'s with ``generator=torch.Generator(device).manual_seed(seed)``.

On the card the loader runs each bucket's program as a captured CUDA graph
(``capture.Program``: one warm-up run, then the capture; the draws inside
the graph from the program's own generator), made when the artifact loads,
with cuDNN's convolutions and the matmuls pinned to float32 as the model
pins them (a process-wide switch, which the exported graph cannot hold).
``bbed_pc`` runs on the linear time grid, as the JAX artifact does;
``bbed_ode`` (a data-dependent loop), the other grids and the bf16 trunk
are not exported.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..capture import Program
from ..karras import snap_to_karras_grid
from ..ops import cuda_kernels  # noqa: F401  (registers torch.ops.diffse, which programs call)
from ..utils import float32_precision

WEIGHTS_FILE = "weights.pt"
META_FILE = "meta.json"
SAMPLE_RATE = 16000
EXPORTABLE_BRANCHES = ("bbed_pc", "sebridge", "sebridge_v2", "sebridge_v2_snr",
                       "sebridge_v3_snr")
_WEIGHT_PREFIX = "backbone."


def width_bucket(t_orig: int, hop_length: int):
    """``(t_pad_frames, pad_samples)`` of ``t_orig`` samples: this module's
    copy of ``transforms.width_bucket`` (frames padded up to a multiple of
    64), which the loader may not import."""
    frames = 1 + t_orig // hop_length
    t_pad = frames + (64 - frames % 64) % 64
    return t_pad, (t_pad - 1) * hop_length


class _Runner(torch.nn.Module):
    """``model._enhance_on_device`` for one branch and sampler, with the
    backbone as a submodule so that ``torch.func.functional_call`` can put
    the program's weights input in its place."""

    def __init__(self, model, branch: str, n_steps: int, predictor: str, corrector: str,
                 corrector_steps: int):
        super().__init__()
        self.backbone = model.backbone
        self._model = (model,)  # not a submodule: only the backbone's tensors are weights
        self.branch = branch
        self.sampler = dict(n_steps=n_steps, predictor=predictor, corrector=corrector,
                            corrector_steps=corrector_steps)

    def forward(self, x_wav, y_wav, noise, snr, t_hat, normfac):
        branch = self.branch
        draws = iter(torch.view_as_complex(noise).unbind(0) if noise.shape[0] else ())
        inputs = {"y": y_wav}
        if branch == "sebridge_v2_snr":
            inputs["x"] = x_wav
        if branch == "bbed_pc":
            inputs["snr"] = snr
        if branch.endswith("_snr"):
            inputs["normfac"] = normfac
        if branch == "sebridge_v3_snr":
            inputs["t_hat"] = t_hat
        out, _ = self._model[0]._enhance_on_device(branch, lambda like: next(draws),
                                                   **self.sampler, **inputs)
        return out


class _Program(torch.nn.Module):
    """The exported module: the runner with the weights as an input."""

    def __init__(self, runner: _Runner):
        super().__init__()
        self._runner = (runner,)

    def forward(self, weights, x_wav, y_wav, noise, snr, t_hat, normfac):
        return torch.func.functional_call(self._runner[0], weights,
                                          (x_wav, y_wav, noise, snr, t_hat, normfac))


def _weights(model, variables: Optional[dict]) -> dict:
    """The backbone's tensors by name, ``variables`` (e.g.
    ``train.state.eval_variables``) over its own, detached, as the program's
    weights input (keys under ``_Runner``'s ``backbone.``)."""
    tensors = dict(model.backbone.named_parameters())
    tensors.update(model.backbone.named_buffers())
    tensors.update(variables or {})
    return {_WEIGHT_PREFIX + k: v.detach() for k, v in tensors.items()}


def _scalar(value: float, device) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=device)


def export_enhance(model, variables: Optional[dict], branch: str, utt_samples: int,
                   n_steps: int = 30, predictor: str = "reverse_diffusion",
                   corrector: str = "ald", corrector_steps: int = 1):
    """Trace the bucket-static enhance program of ``model`` (a float32
    ``ScoreModel`` on its device) for ``utt_samples``' width bucket.

    The program is first run once eagerly on its example inputs (the
    sampler's draws are recorded, and what the model keeps between calls,
    such as the FIR filters, is made), then exported. Returns ``(exported,
    info)``: the ``torch.export.ExportedProgram`` of ``(weights, x_wav,
    y_wav, noise, snr, t_hat, normfac) -> waveform`` and a dict of
    ``t_pad``, ``pad_samples``, ``noise`` (the shape and count of the draws)
    and ``nfe``."""
    if branch not in EXPORTABLE_BRANCHES:
        raise ValueError(f"branch {branch!r} cannot be exported; one of {EXPORTABLE_BRANCHES}")
    if getattr(model.backbone, "compute_dtype", torch.float32) != torch.float32:
        raise NotImplementedError("only the float32 trunk is exported")
    t_pad, pad_samples = width_bucket(utt_samples, model.cfg.hop_length)
    device = model.device
    runner = _Runner(model, branch, n_steps, predictor, corrector, corrector_steps)
    weights = _weights(model, variables)
    rng = np.random.default_rng(0)
    wave = torch.from_numpy((0.1 * rng.standard_normal((1, pad_samples))).astype(np.float32))
    wave = wave.to(device)
    scalars = [_scalar(v, device) for v in (0.5, 0.5, 1.0)]

    shapes = []

    def recording(like):
        shapes.append(tuple(like.shape))
        return torch.zeros_like(like)

    with torch.no_grad():
        _, nfe = model._enhance_on_device(
            branch, recording, n_steps, predictor, corrector, corrector_steps, y=wave, x=wave,
            snr=scalars[0], t_hat=scalars[1], normfac=scalars[2])
    if len(set(shapes)) > 1:
        raise NotImplementedError(f"draws of several shapes: {sorted(set(shapes))}")
    draw_shape = shapes[0] if shapes else (1, 1, model.stft_cfg.num_freq_bins, t_pad)
    noise = torch.zeros((len(shapes), *draw_shape, 2), dtype=torch.float32, device=device)
    with torch.no_grad():
        exported = torch.export.export(_Program(runner),
                                       (weights, wave, wave, noise, *scalars))
    exported.example_inputs = None  # else each program's file would keep a copy of the weights
    return exported, {"t_pad": t_pad, "pad_samples": pad_samples, "nfe": int(nfe),
                      "noise": {"draws": len(shapes), "shape": list(draw_shape)}}


def save_artifact(path: str, model, variables: Optional[dict], branch: str, utt_samples,
                  n_steps: int = 30, predictor: str = "reverse_diffusion",
                  corrector: str = "ald", corrector_steps: int = 1,
                  oracle: bool = False) -> dict:
    """Export the program of each distinct width bucket of ``utt_samples``
    (an int or a sequence of ints) and write them with the weights
    (``variables`` over the backbone's own; pass the EMA's) and
    ``meta.json`` to ``path``; returns the meta. The loader serves each
    utterance with the smallest bucket that fits, the bucketing of
    ``ScoreModel.enhance``. ``meta["seconds"]`` has each program's export
    and save times."""
    lengths = ([utt_samples] if isinstance(utt_samples, (int, np.integer))
               else list(utt_samples))
    os.makedirs(path, exist_ok=True)
    buckets, seen, seconds, info = [], set(), [], None
    for us in sorted(int(v) for v in lengths):
        # dedupe before the trace: two lengths often fall in one bucket
        if width_bucket(us, model.cfg.hop_length)[0] in seen:
            continue
        t0 = time.perf_counter()
        exported, info = export_enhance(model, variables, branch, us, n_steps=n_steps,
                                        predictor=predictor, corrector=corrector,
                                        corrector_steps=corrector_steps)
        t1 = time.perf_counter()
        seen.add(info["t_pad"])
        fname = f"enhance_t{info['t_pad']}.pt2"
        torch.export.save(exported, os.path.join(path, fname))
        seconds.append({"export": t1 - t0, "save": time.perf_counter() - t1})
        buckets.append({"t_pad_frames": info["t_pad"], "pad_samples": info["pad_samples"],
                        "file": fname, "noise": info["noise"]})
    weights = {k[len(_WEIGHT_PREFIX):]: v.cpu() for k, v in _weights(model, variables).items()}
    torch.save(weights, os.path.join(path, WEIGHTS_FILE))
    meta = {
        "branch": branch,
        "n_steps": n_steps,
        "predictor": predictor,
        "corrector": corrector,
        "corrector_steps": corrector_steps,
        "oracle": oracle,
        "device": model.device.type,
        "buckets": buckets,
        # the JAX artifact's single-bucket mirrors
        "pad_samples": buckets[-1]["pad_samples"],
        "t_pad_frames": buckets[-1]["t_pad_frames"],
        "hop_length": model.cfg.hop_length,
        "sample_rate": SAMPLE_RATE,
        "model_type": model.cfg.model_type,
        "snr_conditioned": model.cfg.snr_conditioned,
        "fixed_snr": model.cfg.fixed_snr,
        "nfe": info["nfe"],
        "seconds": seconds,
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class _Bucket:
    """One bucket's loaded program: its input buffers' shapes, the draws,
    and on the card the captured graph (``capture.Program``)."""

    def __init__(self, module, weights: dict, info: dict, device: torch.device):
        self.module, self.weights, self.device = module, weights, device
        self.pad_samples = int(info["pad_samples"])
        self.draws = int(info["noise"]["draws"])
        self.draw_shape = tuple(info["noise"]["shape"])
        self.program = None
        if device.type == "cuda":
            self.program = Program(self._run, self._example(), device)

    def _example(self) -> dict:
        wave = torch.zeros((1, self.pad_samples), dtype=torch.float32)
        return {"x_wav": wave, "y_wav": wave, "snr": 0.5, "t_hat": 0.5, "normfac": 1.0}

    def _noise(self, generator: torch.Generator) -> torch.Tensor:
        """The draws, one by one from ``generator`` in the sampler's order, as
        ``ScoreModel.enhance`` draws them (``utils.randn_like``)."""
        draws = [torch.randn(self.draw_shape, dtype=torch.complex64, device=self.device,
                             generator=generator) for _ in range(self.draws)]
        if not draws:
            return torch.zeros((0, *self.draw_shape, 2), dtype=torch.float32, device=self.device)
        return torch.view_as_real(torch.stack(draws))

    def _run(self, generator, x_wav, y_wav, snr, t_hat, normfac, noise=None):
        """The program, with cuDNN's convolutions and the matmuls in float32 as
        the model pins them (``utils.float32_precision``): the exported graph
        holds the operations, not the process's TF32 switches, which
        otherwise let cuDNN take TF32 kernels (the default)."""
        if noise is None:
            noise = self._noise(generator)
        with float32_precision(self.device):
            return self.module(self.weights, x_wav, y_wav, noise, snr, t_hat, normfac)

    def __call__(self, generator, draws: Optional[np.ndarray] = None, **inputs) -> torch.Tensor:
        """The program on ``inputs`` with its draws from ``generator``, or
        the given ``draws`` (complex ``[n_draws, *shape]``), which runs it
        eagerly."""
        if self.program is not None and draws is None:
            return self.program(generator, **inputs)
        tensors = {k: v.to(self.device) if torch.is_tensor(v) else _scalar(v, self.device)
                   for k, v in inputs.items()}
        with torch.no_grad():
            if draws is None:
                return self._run(generator, **tensors)
            draws = np.asarray(draws, dtype=np.complex64)
            if draws.shape != (self.draws, *self.draw_shape):
                raise ValueError(f"draws of shape {draws.shape}; the program takes "
                                 f"{(self.draws, *self.draw_shape)}")
            noise = torch.view_as_real(torch.from_numpy(draws)).to(self.device)
            return self._run(generator, noise=noise, **tensors)


def load_artifact(path: str):
    """Load an artifact directory into an enhance callable that needs no
    model code.

    Returns ``(enhance, meta)`` where ``enhance(y_wav [T], seed=0,
    x_wav=None, est_snr=1.0, snr=0.5, draws=None) -> [T]`` (numpy float32)
    keeps the JAX loader's host contract: the smallest bucket that fits
    (``width_bucket``: when frames % 64 == 0 the bucket is up to hop-1
    samples shorter than the utterance, which is truncated, as
    ``ScoreModel.enhance`` does), zero-padding, and the output trimmed or
    zero-padded back to the input's length. The weights go to the device
    once; on the card each bucket's program is warmed up and captured here.
    ``draws`` (complex ``[n_draws, *shape]`` as ``meta``'s bucket records)
    replace the draws from ``seed`` and run the program eagerly, so that two
    devices can be given the same noise. ``enhance`` is thread-safe (one call
    runs at a time); ``enhance.buckets`` are the loaded programs. ``meta``
    gains ``load_seconds``."""
    t0 = time.perf_counter()
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this artifact was exported for the card and there is no CUDA "
                           "device; export one on the CPU to run it there")
    weights = torch.load(os.path.join(path, WEIGHTS_FILE), map_location=device,
                         weights_only=True)
    weights = {_WEIGHT_PREFIX + k: v for k, v in weights.items()}
    buckets = []
    for info in sorted(meta["buckets"], key=lambda b: b["pad_samples"]):
        module = torch.export.load(os.path.join(path, info["file"])).module()
        buckets.append(_Bucket(module, weights, info, device))
    hop = int(meta["hop_length"])
    branch, fixed_snr = meta["branch"], meta["fixed_snr"]
    lock = threading.Lock()

    def enhance(y_wav, seed: int = 0, x_wav=None, est_snr: float = 1.0, snr: float = 0.5,
                draws: Optional[np.ndarray] = None):
        y_wav = np.asarray(y_wav, dtype=np.float32).reshape(-1)
        t_orig = y_wav.shape[-1]
        if t_orig == 0:
            raise ValueError("empty waveform")
        needed = width_bucket(t_orig, hop)[1]
        bucket = next((b for b in buckets if needed <= b.pad_samples), None)
        if bucket is None:
            raise ValueError(f"utterance of {t_orig} samples exceeds this artifact's largest "
                             f"bucket ({buckets[-1].pad_samples}); export a wider bucket")
        ps = bucket.pad_samples
        x_in = y_wav if x_wav is None else np.asarray(x_wav, dtype=np.float32).reshape(-1)
        yb = np.zeros((1, ps), np.float32)
        xb = np.zeros((1, ps), np.float32)
        yb[0, :min(t_orig, ps)] = y_wav[:ps]
        xb[0, :min(x_in.shape[-1], ps)] = x_in[:ps]
        t_hat, normfac = np.float32(0.5), np.float32(1.0)
        if branch.endswith("_snr"):
            t_hat, normfac = snap_to_karras_grid(est_snr, fixed_snr)
        with lock:
            generator = torch.Generator(device).manual_seed(int(seed))
            out = bucket(generator, draws, x_wav=torch.from_numpy(xb), y_wav=torch.from_numpy(yb),
                         snr=float(np.float32(snr)), t_hat=float(t_hat), normfac=float(normfac))
            x_hat = out[0, :t_orig].cpu().numpy()
        if x_hat.shape[-1] < t_orig:  # the frames % 64 == 0 bucket's tail
            x_hat = np.pad(x_hat, (0, t_orig - x_hat.shape[-1]))
        return x_hat

    enhance.buckets = buckets
    meta["load_seconds"] = time.perf_counter() - t0
    return enhance, meta


class ArtifactService:
    """``EnhanceService``'s face over an artifact directory: one utterance a
    request through the loaded program, no model code and no dynamic
    batching. Each request takes the next seed. ``*_snr`` artifacts hold
    no estimator: clients give ``est_snr`` (``?est_snr=`` on the HTTP
    front end), else 1.0."""

    def __init__(self, path: str, seed: int = 0):
        self._enhance, self.meta = load_artifact(path)
        self._seed = seed
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "audio_seconds": 0.0, "wall_seconds": 0.0, "errors": 0}

    def enhance(self, y_wav, est_snr=None, timeout=None):
        t0 = time.monotonic()
        with self._lock:
            seed = self._seed
            self._seed += 1
        try:
            out = self._enhance(y_wav, seed=seed,
                                est_snr=1.0 if est_snr is None else float(est_snr))
        except Exception:
            with self._lock:
                self._stats["errors"] += 1
            raise
        wall = time.monotonic() - t0
        with self._lock:
            self._stats["requests"] += 1
            self._stats["audio_seconds"] += np.size(y_wav) / SAMPLE_RATE
            self._stats["wall_seconds"] += wall
        return out

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        s["rtf_x_realtime"] = s["audio_seconds"] / s["wall_seconds"] if s["wall_seconds"] else 0.0
        s["buckets"] = [b["pad_samples"] for b in self.meta.get("buckets", [])]
        s["branch"] = self.meta.get("branch")
        return s

    def close(self, timeout: float = 0.0) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
