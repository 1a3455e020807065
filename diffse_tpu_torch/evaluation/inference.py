"""The evaluation harness (port of diffse_tpu/evaluation/inference.py):
``spec_sample``, ``_eval_fn``, ``eval_enhance_file`` and ``evaluate_model``.

These are the eval harness's branch semantics, which differ from
``ScoreModel.enhance``'s: ``sebridge_v2`` starts at t = 1.0, the ``_snr``
branches take their time from ``calculate_snr_direct`` (``sebridge_v3_snr``
snapping each row to the Karras grid on the device), and the normalisation
factor reads the unsnapped estimate. ``spec_sample`` is the shared core of
this module and of the streaming engines (``evaluation/streaming.py``).

On the card ``_eval_fn``'s function (normalise -> STFT -> branch -> iSTFT)
runs as a captured program (``capture.Program``) per input shape, kept on
the model and made anew when the backbone's parameters change, as
``ScoreModel._enhance_graph`` keeps enhance's, but at most
``PROGRAMS_KEPT`` of them (the least recently used is dropped); on the CPU,
with a caller's ``noise`` callable, and when the caller asks (a one-off
shape), it runs eagerly.

``evaluate_model`` scores uniformly picked validation files with PESQ,
SI-SDR and ESTOI on the host. Draws: file ``i`` (its index among the picked
files) draws from a generator seeded with ``dispatch_seed(seed, i)``, or
from ``noise(i)``: the JAX package's ``fold_in(key, i)``. With
``batch_size`` > 1 the files go through ``batch_eval.batch_enhance`` under
``seed`` (the same rule over its dispatches).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..capture import Program
from ..data.wavio import read_wav
from ..models.score_model import (
    T_30_F32,
    ScoreModel,
    calculate_normfac_direct,
    calculate_snr_direct,
    noise_mag,
)
from ..sampling import get_pc_sampler
from ..transforms import pad_spec, spec_fwd, width_bucket
from ..utils import forbid_capture, generator_noise, to_device
from .metrics import estoi, pesq_wb, si_sdr

NoiseFn = Callable[[torch.Tensor], torch.Tensor]
# dispatch index (a file's, a batch's) -> the noise source of that dispatch
NoiseFor = Callable[[int], NoiseFn]

# Settings (inference.py:11-15)
SR = 16000
SNR_ALD = 0.5
N_STEPS = 30
CORRECTOR_STEPS = 1

# the captured programs that each of the engines' caches keeps on a model
# (``_eval_fn``'s per input shape, the packed engine's per chunk-program key)
PROGRAMS_KEPT = 4

# the branches of spec_sample: (snr_conditioned, model_type) -> branch is
# train.loop.eval_model_type
BRANCHES = ("bbed", "sebridge", "sebridge_v2", "sebridge_v2_fixed", "sebridge_v3_fixed",
            "sebridge_v2_snr", "sebridge_v3_snr")


def dispatch_seed(seed: int, index: int) -> int:
    """The seed of dispatch ``index`` under ``seed`` (both >= 0), the
    counterpart of ``jax.random.fold_in(key, index)``: a function of the two
    numbers only, so the order in which dispatches run changes no draw."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def dispatch_generator(device: torch.device, seed: int, index: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``dispatch_seed(seed, index)``."""
    return torch.Generator(device).manual_seed(dispatch_seed(seed, index))


def captures(model: ScoreModel, noise: Optional[NoiseFn]) -> bool:
    """Whether the engines run a program captured: on the card, with draws
    from a generator (a graph cannot call a caller's ``noise``)."""
    return noise is None and model.device.type == "cuda"


def _karras_grid(model: ScoreModel) -> torch.Tensor:
    """The float32 t_30 grid on the model's device, made once outside any
    capture (a host-to-device copy cannot be captured) and kept."""
    grid = model.__dict__.get("_t30_grid")
    if grid is None:
        forbid_capture(model.device, "the Karras grid")
        grid = to_device(torch.from_numpy(T_30_F32), model.device)
        model._t30_grid = grid
    return grid


def spec_sample(model: ScoreModel, branch: str, X: torch.Tensor, Y: torch.Tensor,
                noise: NoiseFn, est_snr: torch.Tensor, fixed_snr: float,
                noise_size: Optional[torch.Tensor] = None,
                predictor: str = "reverse_diffusion", corrector: str = "ald",
                N: Optional[int] = None, snr: Optional[float] = None,
                timestep_type: str = "linear",
                corrector_steps: Optional[int] = None) -> torch.Tensor:
    """The branch's enhanced sample of COMPRESSED spectrograms: ``X``/``Y``
    complex ``[B, 1, F, T]`` on the model's device, ``est_snr`` float32
    ``[B]`` there. Returns the enhanced compressed spec ``[B, 1, F, T]``.
    Draws come from ``noise(like)``; nothing waits on the device.

    ``noise_size`` (``sebridge_v2_fixed`` only): the |X - Y| magnitude of the
    fixed-SNR rescale, broadcastable against ``[B, 1, F, T]``; the reference
    evaluates one utterance per call, so batched callers pass each
    utterance's own (None: the max over the whole batch, right only when the
    batch is one utterance).

    ``predictor``, ``corrector``, ``N``, ``snr``, ``timestep_type`` and
    ``corrector_steps`` (``bbed`` only) override the reference sampler
    (reverse_diffusion + ald, N = 30, snr 0.5, one corrector step, linear
    grid), e.g. with the certified serving sampler (SAMPLER_QUALITY.json)."""
    cfg = model.cfg
    batch = Y.shape[0]

    def full(value):
        return torch.full((batch,), value, dtype=torch.float32, device=Y.device)

    if branch == "bbed":
        sampler = get_pc_sampler(
            predictor, corrector, model.sde.replace(N=N_STEPS if N is None else N),
            model.forward, Y, noise, denoise=True, eps=cfg.t_eps,
            snr=SNR_ALD if snr is None else snr,
            corrector_steps=CORRECTOR_STEPS if corrector_steps is None else corrector_steps,
            timestep_type=timestep_type)
        sample, _ = sampler()
    elif branch == "sebridge":
        sample = model.forward(Y, full(0.999), Y)
    elif branch == "sebridge_v2":
        Z = noise(Y) * cfg.sigma_max * 1.0
        sample = model.forward(Y + Z, full(1.0), Y)
    elif branch == "sebridge_v2_fixed":
        if noise_size is None:
            noise_size = noise_mag(X, Y, mode="max")
        Y = X + (Y - X) / noise_size * fixed_snr
        Z = noise(Y) * cfg.sigma_max * 0.999
        sample = model.forward(Y + Z, full(0.999), Y)
    elif branch == "sebridge_v3_fixed":
        Z = noise(Y) * cfg.sigma_max
        sample = model.forward(Y + Z, full(1.0), Y)
    elif branch in ("sebridge_v2_snr", "sebridge_v3_snr"):
        # the reference's sebridge_v2_snr calls calculate_snr_direct with two
        # arguments and crashes (SURVEY.md 3.6); the JAX package, and so the
        # port, gives it the intended fixed_snr
        t_val = calculate_snr_direct(1.0, est_snr, fixed_snr)
        if branch == "sebridge_v3_snr":  # each row snapped to the grid (first on a tie)
            grid = _karras_grid(model)
            t_val = grid[torch.argmin(torch.abs(grid[None, :] - t_val[:, None]), dim=1)]
        Z = noise(Y) * cfg.sigma_max * t_val[:, None, None, None]
        sample = model.forward(Y + Z, t_val, Y)
    else:
        raise ValueError(f"unknown eval branch {branch}")
    return sample


def _eval_fn(model: ScoreModel, branch: str, t_pad: int, fixed_snr: Optional[float] = None,
             sampler_kwargs: Optional[dict] = None):
    """Eval-time enhancement of one branch and width bucket (``t_pad``
    frames): ``fn(x_wav, y_wav, est_snr, generator=None, noise=None,
    graphed=True)`` -> the enhanced waveforms ``[B, samples']`` on the
    model's device.

    ``x_wav``/``y_wav``: ``[B, samples]`` (numpy or tensors), each row one
    utterance, normalised by its own max-abs; ``est_snr``: a number or one
    per row. Draws come from ``noise`` when given (run eagerly), else from
    ``generator`` (on the model's device; seed 0 when None), through the
    captured program on the card unless ``graphed`` is False (a shape met
    once, which a capture would not pay back). ``sampler_kwargs`` (``bbed``
    only): the sampler overrides of ``spec_sample``."""
    fs = model.cfg.fixed_snr if fixed_snr is None else fixed_snr
    sk = dict(sampler_kwargs or {})

    def enhance(noise, x_wav, y_wav, est_snr):
        norm_factor = torch.max(torch.abs(y_wav), dim=-1, keepdim=True).values
        if branch in ("sebridge_v2_snr", "sebridge_v3_snr"):
            # the reference's normalisation reads the unsnapped estimate
            norm_factor = norm_factor * calculate_normfac_direct(1.0, est_snr, fs)[:, None]
        y = y_wav / norm_factor
        x = x_wav / norm_factor
        if branch == "sebridge_v3_fixed":
            y = x + (y - x) * fs  # the noise rescaled to the training fixed_snr
        Y = pad_spec(spec_fwd(model._stft(y), model.spec_cfg)[:, None])
        X = pad_spec(spec_fwd(model._stft(x), model.spec_cfg)[:, None])
        noise_size = None
        if branch == "sebridge_v2_fixed":
            # per row: each row is one utterance
            noise_size = torch.amax(torch.abs(X - Y), dim=(1, 2, 3), keepdim=True)
        sample = spec_sample(model, branch, X, Y, noise, est_snr, fs, noise_size=noise_size,
                             **sk)
        return model.to_audio(sample[:, 0]) * norm_factor

    @torch.no_grad()
    def fn(x_wav, y_wav, est_snr, generator: Optional[torch.Generator] = None,
           noise: Optional[NoiseFn] = None, graphed: bool = True) -> torch.Tensor:
        inputs = {"x_wav": _wave(x_wav, model.device), "y_wav": _wave(y_wav, model.device)}
        batch = inputs["y_wav"].shape[0]
        est = np.array(np.broadcast_to(np.asarray(est_snr, dtype=np.float32).reshape(-1),
                                       (batch,)))
        inputs["est_snr"] = to_device(torch.from_numpy(est), model.device)
        if noise is None and generator is None:
            generator = torch.Generator(model.device).manual_seed(0)
        if not (graphed and captures(model, noise)):
            return enhance(noise or generator_noise(generator), **inputs)
        key = ("eval", branch, t_pad, fs, tuple(sorted(sk.items())),
               tuple(inputs["y_wav"].shape)) + model._program_settings()
        program = model.cached_program(
            model.__dict__.setdefault("_eval_programs", {}), key,
            lambda: Program(lambda gen, **t: enhance(generator_noise(gen), **t), inputs,
                            model.device), limit=PROGRAMS_KEPT)
        # the program's output buffer: the next replay overwrites it
        return program(generator, **inputs).clone()

    return fn


def _wave(a, device) -> torch.Tensor:
    """Waveforms as float32 on ``device`` (numpy arrays are converted)."""
    t = a.float() if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, dtype=np.float32))
    return to_device(t, device)


def eval_enhance_file(model: ScoreModel, x_wav: np.ndarray, y_wav: np.ndarray, model_type: str,
                      generator: Optional[torch.Generator] = None, est_snr: float = 1.0,
                      fixed_snr: Optional[float] = None,
                      noise: Optional[NoiseFn] = None) -> np.ndarray:
    """Enhance one utterance with the eval-time branch semantics; returns the
    enhanced waveform of the input's length."""
    hop = model.cfg.hop_length
    t_orig = np.asarray(y_wav).reshape(-1).shape[-1]
    frames = 1 + t_orig // hop
    t_pad = frames + (64 - frames % 64) % 64
    # zero-padded on the host to the bucket's sample count, so that the
    # program's input shape is the bucket's (the max-abs ignores the tail)
    pad_samples = (t_pad - 1) * hop
    xp = np.zeros(pad_samples, dtype=np.float32)
    yp = np.zeros(pad_samples, dtype=np.float32)
    xp[:t_orig] = np.asarray(x_wav).reshape(-1)[:pad_samples]
    yp[:t_orig] = np.asarray(y_wav).reshape(-1)[:pad_samples]
    fn = _eval_fn(model, model_type, t_pad, fixed_snr=fixed_snr)
    x_hat = fn(xp[None], yp[None], est_snr, generator=generator, noise=noise)
    x_hat = x_hat[0, :t_orig].cpu().numpy()
    if x_hat.shape[-1] < t_orig:
        # a bucket of frames % 64 == 0 loses up to hop-1 tail samples in the
        # iSTFT: zero-pad back to the input length
        x_hat = np.pad(x_hat, (0, t_orig - x_hat.shape[-1]))
    return x_hat


def pick_files(split, num_eval_files: int) -> Tuple[list, list]:
    """``num_eval_files`` (clean, noisy) paths spread uniformly over a data
    split (all of them for -1), as the reference picks its validation files."""
    total = len(split.clean_files)
    if num_eval_files == -1:
        num_eval_files = total
    indices = np.linspace(0, total - 1, num_eval_files).astype(int)
    return [split.clean_files[i] for i in indices], [split.noisy_files[i] for i in indices]


def read_pairs(clean_files, noisy_files) -> Tuple[list, list]:
    """The first channel of each (clean, noisy) wav pair."""
    xs, ys = [], []
    for cf, nf in zip(clean_files, noisy_files):
        xs.append(read_wav(cf)[0][0])
        ys.append(read_wav(nf)[0][0])
    return xs, ys


def bucket_order(wavs, hop_length: int) -> list:
    """The indices of ``wavs`` ordered by width bucket (by index within one),
    so that a bucket's captured program serves its files in a row."""
    return sorted(range(len(wavs)), key=lambda i: (
        width_bucket(np.asarray(wavs[i]).reshape(-1).shape[-1], hop_length)[0], i))


def score_files(xs, x_hats, sr: int = SR) -> Tuple[float, float, float]:
    """The sums of PESQ, SI-SDR and ESTOI over the files, in their order."""
    pesq_sum = si_sdr_sum = estoi_sum = 0.0
    for x, x_hat in zip(xs, x_hats):
        si_sdr_sum += si_sdr(x, x_hat)
        pesq_sum += pesq_wb(sr, x, x_hat)
        estoi_sum += estoi(x, x_hat, sr)
    return pesq_sum, si_sdr_sum, estoi_sum


def estimate_snrs(model: ScoreModel, ys) -> list:
    """SNRNet's estimate of each noisy waveform, one at a time."""
    return [model.estimate_snr(np.asarray(y)[None])[0].item() for y in ys]


def evaluate_model(model: ScoreModel, data_module, num_eval_files: int, model_type: str = "bbed",
                   fixed_snr: float = 1.0, seed: int = 0, batch_size: int = 1,
                   noise: Optional[NoiseFor] = None) -> Tuple[float, float, float]:
    """Mean (pesq, si_sdr, estoi) over ``num_eval_files`` validation files
    picked uniformly (valid2 for ``sebridge_v3_fixed``, else valid), each
    enhanced by the eval branch ``model_type`` with the backbone's own
    weights (load the EMA into it first: ``train.state.ema_weights``).

    ``batch_size`` > 1 enhances the files as bucketed batches
    (``batch_eval.batch_enhance``): per-row semantics are the same, so only
    throughput changes. At 1 the files go one at a time in bucket order,
    each drawing by its index (module docstring). The ``_snr`` branches
    estimate each file's SNR with SNRNet first."""
    split = (data_module.valid_set_2 if model_type == "sebridge_v3_fixed"
             else data_module.valid_set)
    xs, ys = read_pairs(*pick_files(split, num_eval_files))
    est = estimate_snrs(model, ys) if model_type.endswith("_snr") else [1.0] * len(ys)
    if batch_size > 1:
        from .batch_eval import batch_enhance

        x_hats = batch_enhance(model, xs, ys, model_type, seed=seed, batch_size=batch_size,
                               est_snrs=est if model_type.endswith("_snr") else None,
                               fixed_snr=fixed_snr, noise=noise)
    else:
        x_hats = [None] * len(ys)
        for i in bucket_order(ys, model.cfg.hop_length):
            draws = ({"noise": noise(i)} if noise is not None
                     else {"generator": dispatch_generator(model.device, seed, i)})
            x_hats[i] = eval_enhance_file(model, xs[i], ys[i], model_type, est_snr=est[i],
                                          fixed_snr=fixed_snr, **draws)
    sums = score_files(xs, x_hats)
    return tuple(v / len(xs) for v in sums)
