"""ScoreModel: score parameterisation and speech enhancement (port of
diffse_tpu/models/score_model.py).

Ported branches of ``enhance``:

  - ``bbed_pc`` (``model_type="bbed"``): the N-step predictor-corrector
    sampler (by default reverse_diffusion + ald on the linear grid, N = 30,
    60 network forwards; every predictor, corrector and time grid of
    ``sampling``);
  - ``bbed_ode`` (``model_type="bbed"``, ``sampler_type="ode"``): the
    probability-flow ODE, adaptive RK45 at rtol = atol = 1e-5, then one
    denoising step;
  - ``sebridge`` and ``sebridge_v2``: one network forward with the
    consistency c_skip/c_out, from ``Y`` or from ``Y + Z``;
  - ``sebridge_v3_snr`` (``snr_conditioned="true"``), the paper's single-NFE
    mode: SNRNet estimates the SNR from the noisy waveform (or the caller
    gives it, ``oracle``), the estimate is snapped to the Karras t_30 grid,
    the normalisation factor is corrected (paper Eq. 12), then one forward;
  - ``sebridge_v2_snr``: one forward of the SNR-conditioned NCSN++ with the
    noise level taken from the clean reference.

With ``seq_mesh`` (``parallel.sequence.make_seq_mesh``) ``enhance`` runs one
utterance frames-parallel over the mesh's ranks, eagerly (a gloo collective
cannot be captured): every rank takes the STFT of the whole waveform and
keeps its frames, draws at the whole shape and keeps its frames, reduces
the samplers' norms over the ranks, and gathers the frames before the
iSTFT, so that every rank returns the whole waveform of the one-device
program.

On the card each branch runs as one captured program per shape bucket
(``_enhance_graph``, the counterpart of the JAX package's ``_enhance_jit``):
normalise -> STFT -> sampler or forward -> iSTFT, captured once as a CUDA
graph (``capture.Program``) and replayed. The program never waits on the
device; SNRNet's estimate and the snap to the Karras grid stay on the host
before it, as in the JAX package. ``bbed_ode``'s number of RK45 steps
depends on the data, so it is three captured programs (``capture.LoopProgram``):
normalise -> STFT -> prior -> the solver's start; one step attempt, replayed
until the host reads that the solver is done; the denoising step -> iSTFT.

Training: ``prepare_batch`` (normalise -> STFT -> compression of waveform
crops, on the model's device) and ``loss_fn`` over every (snr_conditioned x
model_type) branch of the JAX package: BBED denoising score matching
(``mse``, ``mae``, ``sqrt_mse``), and the consistency losses of the
sebridge family on the linear bridge, the SNR-rescaled one (``fixed``) and
the SNR-aligned nonlinear bridge of sebridge_v3 (paper Eq. 6). Its draws
(``draw_loss_noise``: the time or the Karras index, and the noise) are apart
from its arithmetic (``loss_from_draws``), so that tests can feed the JAX
package's draws. The train step around it is ``train/steps.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..capture import LoopProgram, Program
from ..parallel.mesh import current_shard
from ..parallel.sequence import constrain_frames, current_frames
from ..karras import (T_30_F32, calculate_normfac_direct, calculate_snr_direct,  # noqa: F401
                      karras_t, snap_to_karras_grid, t_30)
from ..sampling import PredictorRegistry, get_ode_sampler, get_pc_sampler, pc_grid
from ..sampling.ode import RK45State
from ..sde import SDERegistry
from ..transforms import (
    SpecTransformConfig,
    StftConfig,
    get_window,
    istft,
    pad_spec,
    spec_back,
    spec_fwd,
    stft,
    width_bucket,
)
from ..utils import generator_noise, model_device, randn_like, to_device
from . import dcunet, ncsnpp  # noqa: F401  (register the backbones)
from .layers import KeepMask, generator_keep_mask
from .shared import BackboneRegistry
from .snr_model import snr_from_normalized_wav

NoiseFn = Callable[[torch.Tensor], torch.Tensor]


def _as_wave(a) -> torch.Tensor:
    """A waveform as a float32 tensor (numpy arrays are converted)."""
    if torch.is_tensor(a):
        return a.float()
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def noise_mag(s, s_hat, mode: str = "mean"):
    """Noise magnitude between two specs (over every rank's frames on a
    frames shard)."""
    seq = current_frames()
    if mode == "mean":
        r = torch.sqrt(torch.square(torch.abs(s - s_hat)))
        if seq is None:
            return torch.abs(torch.mean(r))
        return torch.abs(seq.sum(r.sum(dtype=torch.float64)) / (r.numel() * seq.count)).float()
    if mode == "max":
        m = torch.max(torch.abs(s - s_hat))
        return m if seq is None else seq.max(m)
    return torch.zeros((), device=s.device)


class EnhanceKey(NamedTuple):
    """What one captured enhance program is for: the fields of the JAX
    package's ``_enhance_jit`` cache key (``mesh_key``: None on one device,
    else ``parallel.sequence.mesh_key`` of the frames mesh: its axis name,
    size and ranks), then what a capture also fixes: the batch, the trunk's
    dtype, the device, and the model's settings (its config and SDE)."""

    branch: str
    t_pad: int
    n_steps: int
    predictor: str
    corrector: str
    corrector_steps: int
    oracle: bool
    mesh_key: Optional[tuple]
    timestep_type: str
    batch: int
    dtype: torch.dtype
    device: torch.device
    settings: tuple


@dataclasses.dataclass
class ScoreModelConfig:
    """diffse_tpu's ScoreModelConfig: the same fields, names, defaults and
    order (``hparams`` round-trips through it)."""

    backbone: str = "ncsnpp"
    sde: str = "ouve"
    model_type: str = "sebridge"  # bbed | sebridge | sebridge_v2 | sebridge_v3
    snr_conditioned: str = "false"  # false | fixed (training only) | true
    fixed_snr: float = 1.0
    lr: float = 1e-4
    ema_decay: float = 0.999
    t_eps: float = 3e-2
    loss_type: str = "mse"  # mse | mae | sqrt_mse
    loss_abs_exponent: float = 0.5
    num_eval_files: int = 10
    sigma_max: float = 0.5
    # the data contract (SpecsDataModule)
    n_fft: int = 510
    hop_length: int = 128
    num_frames: int = 256
    window: str = "hann"
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    transform_type: str = "exponent"
    normalize: str = "noisy"  # noisy | clean | not


# (snr_conditioned, model_type) pairs and their parameterisation: the score
# (bbed), or the consistency output with the EDM c_skip/c_out or, for the
# fixed-SNR sebridge_v2, the simple one
PARAMETERISATION = {("false", "bbed"): "score", ("false", "sebridge"): "consistency",
                    ("false", "sebridge_v2"): "consistency",
                    ("fixed", "sebridge_v2"): "consistency_simple",
                    ("fixed", "sebridge_v3"): "consistency",
                    ("true", "sebridge_v2"): "consistency", ("true", "sebridge_v3"): "consistency"}
# the Karras grid the consistency losses draw adjacent times from
KARRAS_N, KARRAS_RHO, KARRAS_EPS = 30, 7.0, 0.001


class ScoreModel:
    """Score / consistency model for speech enhancement.

    Args:
        config: hyperparameters.
        backbone_kwargs: keywords of the backbone (e.g. NCSNpp's nf, ch_mult).
        sde_kwargs: keywords of the SDE.
        device: where the backbone's (and SNRNet's) weights live and
            enhancement runs: the card unless given (``"cpu"`` for the CPU);
            raises when there is no CUDA device.
        generator: CPU generator for the backbone's initial weights.
        snr_model: the SNRNet (``models.snrnet``) that ``snr_conditioned="true"``
            estimates the SNR with, moved to ``device``; needed unless every
            call is ``oracle``.
    """

    def __init__(self, config: ScoreModelConfig, backbone_kwargs: Optional[dict] = None,
                 sde_kwargs: Optional[dict] = None, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 snr_model: Optional[torch.nn.Module] = None):
        self.cfg = config
        self.device = model_device(device)
        backbone_cls = BackboneRegistry.get_by_name(config.backbone)
        self.backbone = backbone_cls(**(backbone_kwargs or {}), generator=generator)
        self.backbone = self.backbone.to(self.device).eval()
        self.backbone_takes_noise_cond = getattr(self.backbone, "snr_conditioning", False)
        self.snr_model = None if snr_model is None else snr_model.to(self.device).eval()
        sde_name, sde_kwargs = config.sde, dict(sde_kwargs or {})
        if sde_name == "bbve":
            # the reference's legacy name of BBED (its model.py:70-77), whose
            # sigma_max is BBED's k; the keywords are kept remapped, as the
            # JAX package keeps them, so a restore finds k already there
            sde_name = "bbed"
            if "sigma_max" in sde_kwargs:
                sde_kwargs["k"] = sde_kwargs.pop("sigma_max")
            sde_kwargs.pop("sigma_min", None)
        self.sde = SDERegistry.get_by_name(sde_name)(**sde_kwargs)
        self.stft_cfg = StftConfig(n_fft=config.n_fft, hop_length=config.hop_length,
                                   window=config.window)
        self.spec_cfg = SpecTransformConfig(
            transform_type=config.transform_type, spec_factor=config.spec_factor,
            spec_abs_exponent=config.spec_abs_exponent)
        self._window = get_window(config.window, config.n_fft, device=self.device)
        self._backbone_kwargs = dict(backbone_kwargs or {})
        self._sde_kwargs = sde_kwargs
        # EnhanceKey -> (the parameters' key, capture.Program)
        self._graphs = {}

    # ----------------------------------------------------------- persistence
    @property
    def hparams(self) -> dict:
        """The hyperparameters as the JAX package stores them (its
        ``hparams.json``): the config, the backbone's and the SDE's keywords."""
        return {"config": dataclasses.asdict(self.cfg),
                "backbone_kwargs": self._backbone_kwargs, "sde_kwargs": self._sde_kwargs}

    @classmethod
    def from_hparams(cls, hparams: dict, snr_model: Optional[torch.nn.Module] = None,
                     device="cuda", generator: Optional[torch.Generator] = None,
                     **config_overrides) -> "ScoreModel":
        """A model from ``hparams``, with ``config_overrides`` over its config."""
        cfg = ScoreModelConfig(**{**hparams["config"], **config_overrides})
        return cls(cfg, backbone_kwargs=hparams.get("backbone_kwargs") or {},
                   sde_kwargs=hparams.get("sde_kwargs") or {}, device=device,
                   generator=generator, snr_model=snr_model)

    # ------------------------------------------------------------ transforms
    def _stft(self, sig: torch.Tensor) -> torch.Tensor:
        return stft(sig, self._window, self.stft_cfg.n_fft, self.stft_cfg.hop_length)

    def to_audio(self, spec: torch.Tensor) -> torch.Tensor:
        return istft(spec_back(spec, self.spec_cfg), self._window, self.stft_cfg.n_fft,
                     self.stft_cfg.hop_length)

    def prepare_batch(self, wav_batch):
        """Waveform crops -> the model's spectrograms, on the model's device:
        each row normalised (by the noisy or the clean row's max-abs, or not,
        ``cfg.normalize``), STFT, compression.

        Args:
            wav_batch: ``(x_wav [B, L], y_wav [B, L], *rest)``, tensors or numpy
                arrays; ``rest`` (e.g. the active-RMS levels of ``Specs_SNR``)
                is passed through as it is.
        Returns:
            ``(X [B, 1, F, T], Y [B, 1, F, T], *rest)``, complex.
        """
        x_wav, y_wav, *rest = wav_batch
        x_wav = to_device(_as_wave(x_wav), self.device)
        y_wav = to_device(_as_wave(y_wav), self.device)
        if self.cfg.normalize == "noisy":
            normfac = torch.max(torch.abs(y_wav), dim=-1, keepdim=True).values
        elif self.cfg.normalize == "clean":
            normfac = torch.max(torch.abs(x_wav), dim=-1, keepdim=True).values
        else:
            normfac = torch.ones((x_wav.shape[0], 1), dtype=x_wav.dtype, device=x_wav.device)
        X = spec_fwd(self._stft(x_wav / normfac), self.spec_cfg)[:, None]
        Y = spec_fwd(self._stft(y_wav / normfac), self.spec_cfg)[:, None]
        return (X, Y, *rest)

    # --------------------------------------------------------------- forward
    def _apply_backbone(self, dnn_input: torch.Tensor, t: torch.Tensor,
                        s: Optional[torch.Tensor], variables: Optional[dict],
                        keep_mask: Optional[KeepMask] = None) -> torch.Tensor:
        args = (dnn_input, t, s if s is not None else t) if self.backbone_takes_noise_cond \
            else (dnn_input, t)
        kwargs = {} if keep_mask is None else {"keep_mask": keep_mask}
        if variables is None:
            return self.backbone(*args, **kwargs)
        return torch.func.functional_call(self.backbone, variables, args, kwargs)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                s: Optional[torch.Tensor] = None, variables: Optional[dict] = None,
                keep_mask: Optional[KeepMask] = None) -> torch.Tensor:
        """Score (bbed) or consistency output (the sebridge family).

        Args:
            x: complex ``[B, 1, F, T]`` diffusion state.
            t: ``[B]`` float32 times.
            y: complex ``[B, 1, F, T]`` conditioner.
            s: ``[B]`` noise conditioning of ``ncsnpp_snr`` (``t`` when None).
            variables: the backbone's parameters and buffers by name (e.g. the
                EMA weights, ``train.state.eval_variables``) in place of its
                own, through ``torch.func.functional_call``.
            keep_mask: dropout's keep masks for a backbone in training mode
                (``models.layers.dropout``).
        """
        cfg = self.cfg
        kind = PARAMETERISATION.get((cfg.snr_conditioned, cfg.model_type))
        if kind is None:
            raise ValueError(f"Unsupported (snr_conditioned={cfg.snr_conditioned}, "
                             f"model_type={cfg.model_type})")
        raw = self._apply_backbone(torch.cat([x, y], dim=1), t, s, variables, keep_mask)
        if kind == "score":
            return -raw
        eps, sigma_data = 0.001, 0.5
        tb = t[:, None, None, None]
        if kind == "consistency_simple":
            c_skip = 1 / ((tb - eps) + 1)
            c_out = (tb - eps) / ((tb - eps) + 1)
        else:
            c_skip = sigma_data ** 2 / ((tb - eps) ** 2 + sigma_data ** 2)
            c_out = (sigma_data * (tb - eps)) / ((sigma_data ** 2 + tb ** 2) ** 0.5)
        return c_skip * x + c_out * raw

    # ------------------------------------------------------------------ loss
    def _reduce_loss(self, err: torch.Tensor) -> torch.Tensor:
        """0.5 * the sum of |err|^2 over each row, averaged over the batch."""
        losses = torch.square(torch.abs(err))
        return torch.mean(0.5 * torch.sum(losses.reshape(losses.shape[0], -1), dim=-1))

    @staticmethod
    def _sqrt_compress(z: torch.Tensor) -> torch.Tensor:
        """sqrt(|z|) with z's phase."""
        return torch.sqrt(torch.abs(z)) * torch.exp(1j * torch.angle(z))

    def _consistency_loss(self, f_theta: torch.Tensor, f_theta_minus: torch.Tensor):
        if self.cfg.loss_type == "mse":
            return self._reduce_loss(f_theta - f_theta_minus)
        if self.cfg.loss_type == "sqrt_mse":
            return self._reduce_loss(self._sqrt_compress(f_theta)
                                     - self._sqrt_compress(f_theta_minus))
        raise ValueError(f"loss_type {self.cfg.loss_type} not supported here")

    @staticmethod
    def _karras_pair(n: torch.Tensor, T: float):
        """Adjacent Karras times ``t_n, t_{n+1}`` of the float32 index ``n``,
        as ``[B, 1, 1, 1]``."""
        tn = karras_t(n, N=KARRAS_N, rho=KARRAS_RHO, eps=KARRAS_EPS, T=T)
        tn1 = karras_t(n + 1, N=KARRAS_N, rho=KARRAS_RHO, eps=KARRAS_EPS, T=T)
        return tn[:, None, None, None], tn1[:, None, None, None]

    def draw_loss_noise(self, x: torch.Tensor, generator: torch.Generator) -> dict:
        """The draws of one ``loss_fn`` call for a batch like ``x`` (complex
        ``[B, 1, F, T]``), from ``generator`` (on x's device): ``"z"``,
        CN(0, 1) noise shaped like x, and for ``bbed`` the time ``"t"``,
        uniform on [t_eps, T), else the Karras index ``"n"``, uniform on
        1..29, as float32 ``[B]``."""
        cfg, b = self.cfg, x.shape[0]
        if (cfg.snr_conditioned, cfg.model_type) == ("false", "bbed"):
            u = torch.rand(b, generator=generator, device=x.device)
            draws = {"t": torch.clamp(u * (self.sde.T - cfg.t_eps) + cfg.t_eps, max=self.sde.T)}
        else:
            draws = {"n": torch.randint(1, KARRAS_N, (b,), generator=generator,
                                        device=x.device).float()}
        draws["z"] = randn_like(x, generator)
        return draws

    def loss_fn(self, batch, generator: torch.Generator, train: bool = True,
                variables: Optional[dict] = None) -> torch.Tensor:
        """The training (or validation) loss of ``batch`` (``prepare_batch``'s
        output; entries after X and Y are ignored) with draws from
        ``generator``: ``loss_from_draws`` of ``draw_loss_noise``, and in
        training dropout's keep masks drawn from ``generator`` too, after
        those, as the network reaches each dropout.

        Inside ``parallel.mesh.batch_shard`` (a data-parallel step) ``batch``
        is this rank's rows of the global batch: every draw is taken at the
        global batch's shape, as the one-device step takes it, and this
        rank's rows kept."""
        shard = current_shard()
        x = batch[0]
        draws = self.draw_loss_noise(x if shard is None else shard.global_like(x), generator)
        keep_mask = (generator_keep_mask(generator)
                     if train and getattr(self.backbone, "dropout", 0) else None)
        if shard is not None:
            draws = {k: shard.rows(v) for k, v in draws.items()}
            if keep_mask is not None:
                keep_mask = shard.keep_mask(keep_mask)
        return self.loss_from_draws(batch, draws, train=train, variables=variables,
                                    keep_mask=keep_mask)

    def _running_stats(self) -> list:
        """The backbone's buffers (DCUNet's BatchNorm statistics) with a copy
        of each, to put back (``_restore_stats``)."""
        return [(b, b.detach().clone()) for b in self.backbone.buffers()]

    @staticmethod
    def _restore_stats(saved: list) -> None:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)

    def loss_from_draws(self, batch, draws: dict, train: bool = True,
                        variables: Optional[dict] = None,
                        keep_mask: Optional[KeepMask] = None) -> torch.Tensor:
        """The loss of ``batch = (X, Y, ...)`` given the draws (see
        ``draw_loss_noise``), per (snr_conditioned x model_type) as the JAX
        package's ``loss_fn``. ``train`` sets the backbone's mode (dropout,
        with ``keep_mask``'s masks, and DCUNet's BatchNorm, whose running
        statistics then update); ``variables`` as for ``forward``.

        The consistency losses run the network twice; the statistics that
        stay are those of the second run, each updated from where the step
        began, as the JAX package keeps the second run's updates."""
        cfg = self.cfg
        x, y = batch[0], batch[1]
        self.backbone.train(train)
        key = (cfg.snr_conditioned, cfg.model_type)
        if key not in PARAMETERISATION:
            raise ValueError(f"Unsupported (snr_conditioned={cfg.snr_conditioned}, "
                             f"model_type={cfg.model_type})")

        def forward(x_, t_, y_):
            return self.forward(x_, t_, y_, variables=variables, keep_mask=keep_mask)

        if key == ("false", "bbed"):
            t = draws["t"]
            mean, std = self.sde.marginal_prob(x, t, y)
            z = draws["z"]
            sigmas = std[:, None, None, None].to(x.dtype)
            perturbed = mean + sigmas * z
            score = forward(perturbed, t, y)
            if cfg.loss_type == "mse":
                return self._reduce_loss(sigmas * score + z)
            if cfg.loss_type == "mae":
                # the JAX package's absolute-error loss (the reference's mae
                # branch reads its error before assigning it)
                losses = torch.abs(sigmas * score + z)
                return torch.mean(0.5 * torch.sum(losses.reshape(x.shape[0], -1), dim=-1))
            if cfg.loss_type == "sqrt_mse":
                mean_hat = perturbed + (sigmas ** 2) * score
                return self._reduce_loss((self._sqrt_compress(mean_hat)
                                          - self._sqrt_compress(mean)) / sigmas)
            raise ValueError(f"unknown loss_type {cfg.loss_type}")

        # the consistency losses: adjacent Karras times, the network at both
        T = 0.999 if key in (("false", "sebridge"), ("fixed", "sebridge_v2")) else 1.0
        tn, tn1 = self._karras_pair(draws["n"], T)
        z = draws["z"] * cfg.sigma_max
        if key == ("false", "sebridge"):
            x_tn = y * tn + x * (1 - tn) + ((tn * (1 - tn)) ** 0.5) * z
            x_tn1 = y * tn1 + x * (1 - tn1) + ((tn1 * (1 - tn1)) ** 0.5) * z
            cond, cond1 = y, y
        elif key == ("fixed", "sebridge_v2"):
            y = x + (y - x) / noise_mag(x, y, mode="max") * cfg.fixed_snr
            x_tn = y * tn + x * (1 - tn) + tn * z
            x_tn1 = y * tn1 + x * (1 - tn1) + tn1 * z
            cond, cond1 = y, y
        else:
            if cfg.model_type == "sebridge_v2":  # the linear bridge
                mu_tn = y * tn + x * (1 - tn)
                mu_tn1 = y * tn1 + x * (1 - tn1)
            elif cfg.snr_conditioned == "fixed":
                # the SNR-aligned nonlinear bridge on uncompressed specs, the
                # noise rescaled to fixed_snr (paper Eq. 6)
                x_ori = spec_back(x, self.spec_cfg)
                y0_snr = (spec_back(y, self.spec_cfg) - x_ori) * cfg.fixed_snr
                mu_tn = spec_fwd(x_ori + y0_snr * tn, self.spec_cfg)
                mu_tn1 = spec_fwd(x_ori + y0_snr * tn1, self.spec_cfg)
            else:
                # the SNR-aligned nonlinear bridge: interpolate uncompressed,
                # compress again (paper Eq. 6)
                x_b, y_b = spec_back(x, self.spec_cfg), spec_back(y, self.spec_cfg)
                mu_tn = spec_fwd(x_b * (1 - tn) + y_b * tn, self.spec_cfg)
                mu_tn1 = spec_fwd(x_b * (1 - tn1) + y_b * tn1, self.spec_cfg)
            x_tn, x_tn1 = mu_tn + tn * z, mu_tn1 + tn1 * z
            cond, cond1 = mu_tn, mu_tn1
        stats = self._running_stats() if train else []
        f = forward(x_tn1, tn1[:, 0, 0, 0], cond1)
        self._restore_stats(stats)
        f_m = forward(x_tn, tn[:, 0, 0, 0], cond)
        return self._consistency_loss(f, f_m)

    # -------------------------------------------------------------- sampling
    def get_pc_sampler(self, predictor_name: str, corrector_name: str, y: torch.Tensor,
                       noise: NoiseFn, Y_prior: Optional[torch.Tensor] = None,
                       N: Optional[int] = None, minibatch: Optional[int] = None, **kwargs):
        """The PC sampler (``sampling.get_pc_sampler``) over this model's
        score, with the SDE's N replaced by ``N`` and eps the config's
        ``t_eps`` unless given. With ``minibatch``, a sampler that runs ``y``
        in chunks of that many rows, drawing from ``noise`` chunk after
        chunk, and returns the samples concatenated and each chunk's NFE.
        Run the sampler under ``torch.no_grad()``."""
        sde = self.sde if N is None else self.sde.replace(N=N)
        kwargs = {"eps": self.cfg.t_eps, **kwargs}
        if minibatch is None:
            return get_pc_sampler(predictor_name, corrector_name, sde, self.forward, y, noise,
                                  Y_prior=Y_prior, **kwargs)

        def batched_sampling_fn():
            samples, ns = [], []
            for i in range(0, y.shape[0], minibatch):
                rows = slice(i, i + minibatch)
                sampler = get_pc_sampler(
                    predictor_name, corrector_name, sde, self.forward, y[rows], noise,
                    Y_prior=None if Y_prior is None else Y_prior[rows], **kwargs)
                sample, n = sampler()
                samples.append(sample)
                ns.append(n)
            return torch.cat(samples), ns

        return batched_sampling_fn

    def get_ode_sampler(self, y: torch.Tensor, noise: NoiseFn,
                        Y_prior: Optional[torch.Tensor] = None, N: Optional[int] = None,
                        **kwargs):
        """The probability-flow ODE sampler (``sampling.get_ode_sampler``)
        over this model's score; eps the config's ``t_eps`` unless given.
        Run the sampler under ``torch.no_grad()``."""
        sde = self.sde if N is None else self.sde.replace(N=N)
        kwargs = {"eps": self.cfg.t_eps, **kwargs}
        return get_ode_sampler(sde, self.forward, y, noise, Y_prior=Y_prior, **kwargs)

    # --------------------------------------------------------------- enhance
    @torch.no_grad()
    def estimate_snr(self, y_wav) -> torch.Tensor:
        """SNR estimate ``[B]`` (amplitude ratio) of the noisy waveforms
        ``[B, samples]`` by SNRNet, each row normalised by its max-abs."""
        if self.snr_model is None:
            raise ValueError("snr_conditioned='true' requires an snr_model")
        y_wav = to_device(_as_wave(y_wav), self.device)
        y_n = y_wav / torch.max(torch.abs(y_wav), dim=-1, keepdim=True).values
        return snr_from_normalized_wav(self.snr_model, y_n, self._window,
                                       self.stft_cfg.n_fft, self.stft_cfg.hop_length)

    def _branch(self, sampler_type: str = "pc") -> str:
        cfg = self.cfg
        if cfg.snr_conditioned == "false":
            if cfg.model_type == "bbed":
                return "bbed_pc" if sampler_type == "pc" else "bbed_ode"
            if cfg.model_type in ("sebridge", "sebridge_v2"):
                return cfg.model_type
            raise ValueError(f"unsupported model_type {cfg.model_type}")
        if cfg.snr_conditioned == "fixed":
            raise NotImplementedError(
                "snr fixed is only for experiment purpose, not real inference.")
        if cfg.snr_conditioned == "true":
            branch = f"{cfg.model_type}_snr"
            if branch not in ("sebridge_v2_snr", "sebridge_v3_snr"):
                raise ValueError(f"unknown enhance branch {branch}")
            return branch
        raise ValueError(f"unknown snr_conditioned {cfg.snr_conditioned}")

    def _spectrogram(self, wav: torch.Tensor, norm_factor: torch.Tensor) -> torch.Tensor:
        """``wav / norm_factor`` -> STFT -> compression, ``[B, 1, F, T]``
        padded; on a frames shard this rank's frames of it."""
        spec = pad_spec(spec_fwd(self._stft(wav / norm_factor), self.spec_cfg)[:, None])
        seq = current_frames()
        return spec if seq is None else seq.frames(spec).contiguous()

    def _waveform(self, sample: torch.Tensor) -> torch.Tensor:
        """iSTFT of a sample ``[B, 1, F, T]``, its frames gathered first on a
        frames shard."""
        seq = current_frames()
        if seq is not None:
            sample = seq.gather(sample).contiguous()
        return self.to_audio(sample[:, 0])

    def _enhance_on_device(self, branch: str, noise: NoiseFn, n_steps: int, predictor: str,
                           corrector: str, corrector_steps: int, y: torch.Tensor,
                           x: Optional[torch.Tensor] = None, snr: Optional[torch.Tensor] = None,
                           t_hat: Optional[torch.Tensor] = None,
                           normfac: Optional[torch.Tensor] = None, timestep_type: str = "linear"):
        """Normalise -> STFT -> the branch's sampler or forward -> iSTFT, all
        on the device and with no wait on it, but for ``bbed_ode``'s reads of
        its done flag (``_ode_start``, ``_ode_attempt`` and ``_ode_finish`` are
        its parts without them); ``bbed_pc`` runs as its parts, ``_pc_start``,
        ``_pc_step`` at each entry of ``_pc_grid``, ``_pc_finish``. ``y`` (and
        ``x``, which ``sebridge_v2_snr`` reads): ``[B, samples]`` float32 on
        the model's device, padded to the width bucket; ``snr`` (``bbed_pc``'s
        corrector), ``t_hat`` (``sebridge_v3_snr``) and ``normfac`` (the
        ``_snr`` branches): float32 0-d tensors there. Returns the waveform
        ``[B, samples']`` on the device and the NFE."""
        if branch == "bbed_ode":
            carry = self._ode_start(noise, n_steps, y)
            while not carry["flags"][0]:
                carry = self._ode_attempt(n_steps, carry)
            return self._ode_finish(noise, n_steps, carry), int(carry["nfev"])
        if branch == "bbed_pc":
            pc = (n_steps, predictor, corrector, corrector_steps)
            carry = self._pc_start(noise, *pc, y, timestep_type)
            grid = self._pc_grid(n_steps, predictor, carry["Y"].device, timestep_type)
            for i in range(len(grid["t"])):
                carry = self._pc_step(noise, *pc, carry, snr, timestep_type=timestep_type,
                                      **{k: v[i] for k, v in grid.items()})
            nfe = self._pc_sampler(None, *pc, carry["Y"], timestep_type=timestep_type).nfe
            return self._pc_finish(carry), nfe
        cfg = self.cfg
        norm_factor = torch.max(torch.abs(y))
        if branch.endswith("_snr"):
            norm_factor = norm_factor * normfac
        Y = self._spectrogram(y, norm_factor)
        batch = Y.shape[0]

        def full(value):
            return torch.full((batch,), 1.0, dtype=torch.float32, device=Y.device) * value

        if branch == "sebridge":
            sample = self.forward(Y, full(0.999), Y)
        elif branch == "sebridge_v2":
            z = noise(Y) * cfg.sigma_max * 0.999
            sample = self.forward(Y + z, full(0.999), Y)
        elif branch == "sebridge_v2_snr":
            X = self._spectrogram(x, norm_factor)
            z_mag = noise_mag(X, Y, mode="max") * cfg.sigma_max
            z = noise(Y) * z_mag * 0.999
            sample = self.forward(Y + z, full(0.999), Y, s=full(z_mag) * 0.999)
        else:  # sebridge_v3_snr
            z = noise(Y) * cfg.sigma_max * t_hat
            sample = self.forward(Y + z, full(t_hat), Y)
        return self._waveform(sample) * norm_factor, 1

    # bbed_pc in three parts, as the JAX package's scan runs one step body:
    # the grid's values are a step's inputs. The carry: the spectrogram "Y",
    # "norm_factor", the sampler's "x" and, after a step, "x_mean".
    def _pc_sampler(self, noise: Optional[NoiseFn], n_steps: int, predictor: str,
                    corrector: str, corrector_steps: int, Y: torch.Tensor,
                    snr: Optional[torch.Tensor] = None, timestep_type: str = "linear"):
        return get_pc_sampler(predictor, corrector, sde=self.sde.replace(N=n_steps),
                              score_fn=self.forward, Y=Y, noise=noise, eps=self.cfg.t_eps,
                              snr=snr, corrector_steps=corrector_steps,
                              timestep_type=timestep_type)

    def _pc_start(self, noise: NoiseFn, n_steps: int, predictor: str, corrector: str,
                  corrector_steps: int, y: torch.Tensor, timestep_type: str = "linear") -> dict:
        """Normalise -> STFT -> the prior draw."""
        norm_factor = torch.max(torch.abs(y))
        Y = self._spectrogram(y, norm_factor)
        sampler = self._pc_sampler(noise, n_steps, predictor, corrector, corrector_steps, Y,
                                   timestep_type=timestep_type)
        x, _ = sampler.start()
        return {"Y": Y, "norm_factor": norm_factor, "x": x}

    def _pc_grid(self, n_steps: int, predictor: str, device,
                 timestep_type: str = "linear") -> dict:
        """The steps' grid values (``sampling.pc_grid``) on ``device``."""
        return pc_grid(self.sde.replace(N=n_steps), PredictorRegistry.get_by_name(predictor),
                       self.cfg.t_eps, timestep_type, device)

    def _pc_step(self, noise: NoiseFn, n_steps: int, predictor: str, corrector: str,
                 corrector_steps: int, carry: dict, snr: torch.Tensor, t: torch.Tensor,
                 step: torch.Tensor, std: torch.Tensor, end: Optional[torch.Tensor] = None,
                 timestep_type: str = "linear") -> dict:
        """One corrector and one predictor update at the grid values ``t``,
        ``step``, ``std`` (and ``end``), 0-d float32 tensors; the carry with
        the new ``x`` and ``x_mean``."""
        sampler = self._pc_sampler(noise, n_steps, predictor, corrector, corrector_steps,
                                   carry["Y"], snr, timestep_type)
        x, x_mean = sampler.step(carry["x"], t, step, std, end)
        return {**carry, "x": x, "x_mean": x_mean}

    def _pc_finish(self, carry: dict) -> torch.Tensor:
        """The last step's denoised mean -> iSTFT."""
        return self._waveform(carry["x_mean"]) * carry["norm_factor"]

    # bbed_ode in three parts, each free of waits on the device. The loop's
    # carry: the spectrogram "Y", "norm_factor", the RK45 state's fields and
    # "flags" = [done, nfev, attempts, status] (int32), what the host reads.
    def _ode_sampler(self, n_steps: int, Y: torch.Tensor, noise: Optional[NoiseFn]):
        return get_ode_sampler(self.sde.replace(N=n_steps), self.forward, Y, noise,
                               eps=self.cfg.t_eps)

    @staticmethod
    def _ode_carry(sampler, Y, norm_factor, state: RK45State) -> dict:
        flags = torch.stack([sampler.done(state).to(torch.int32), state.nfev, state.n,
                             state.status])
        return {"Y": Y, "norm_factor": norm_factor, **state._asdict(), "flags": flags}

    def _ode_start(self, noise: NoiseFn, n_steps: int, y: torch.Tensor) -> dict:
        """Normalise -> STFT -> the prior draw -> the solver's start (2 NFE)."""
        norm_factor = torch.max(torch.abs(y))
        Y = self._spectrogram(y, norm_factor)
        sampler = self._ode_sampler(n_steps, Y, noise)
        return self._ode_carry(sampler, Y, norm_factor, sampler.start())

    def _ode_attempt(self, n_steps: int, carry: dict) -> dict:
        """One RK45 step attempt (6 NFE, no draw); the carry unchanged once
        the solver is done."""
        sampler = self._ode_sampler(n_steps, carry["Y"], None)
        state = sampler.attempt(RK45State(*(carry[k] for k in RK45State._fields)))
        return self._ode_carry(sampler, carry["Y"], carry["norm_factor"], state)

    def _ode_finish(self, noise: NoiseFn, n_steps: int, carry: dict) -> torch.Tensor:
        """The denoising step (its draw discarded) -> iSTFT."""
        sampler = self._ode_sampler(n_steps, carry["Y"], noise)
        sample = sampler.finish(RK45State(*(carry[k] for k in RK45State._fields)))
        return self._waveform(sample) * carry["norm_factor"]

    def _graph_key(self, branch: str, t_pad: int, n_steps: int, predictor: str, corrector: str,
                   corrector_steps: int, oracle: bool, batch: int,
                   timestep_type: str = "linear", mesh: Optional[tuple] = None) -> EnhanceKey:
        return EnhanceKey(branch, t_pad, n_steps, predictor, corrector, corrector_steps, oracle,
                          mesh, timestep_type, batch, *self._program_settings())

    def _program_settings(self) -> tuple:
        """What every captured program of this model also depends on: the
        trunk's dtype, the device, and the model's settings (its config and
        SDE)."""
        return (getattr(self.backbone, "compute_dtype", torch.float32), self.device,
                (dataclasses.astuple(self.cfg), self.sde))

    def _params_key(self) -> tuple:
        """Every parameter's and buffer's device, ``data_ptr()`` and
        ``_version``: a captured program holds their addresses and the copies
        made from them (packed and cast weights), so a move or an in-place
        update (``load_state_dict``) must capture anew."""
        return tuple((t.device, t.data_ptr(), t._version)
                     for t in itertools.chain(self.backbone.parameters(), self.backbone.buffers()))

    @torch.no_grad()
    def _enhance_graph(self, branch: str, t_pad: int, n_steps: int, predictor: str,
                       corrector: str, corrector_steps: int, oracle: bool, inputs: dict,
                       timestep_type: str = "linear"):
        """The captured enhance program for this key (``EnhanceKey``): made
        on first use from ``inputs`` (those of ``_enhance_on_device``, by
        name), and again when the backbone's parameters moved or changed. A
        ``capture.Program``, or for ``bbed_ode`` a ``capture.LoopProgram``."""
        key = self._graph_key(branch, t_pad, n_steps, predictor, corrector, corrector_steps,
                              oracle, batch=inputs["y"].shape[0], timestep_type=timestep_type)

        def make():
            if branch == "bbed_ode":
                return LoopProgram(
                    lambda generator, **tensors: self._ode_start(generator_noise(generator),
                                                                 n_steps, **tensors),
                    lambda carry: self._ode_attempt(n_steps, carry),
                    lambda generator, carry: self._ode_finish(generator_noise(generator), n_steps,
                                                              carry),
                    inputs, self.device)

            def fn(generator, **tensors):
                return self._enhance_on_device(branch, generator_noise(generator), n_steps,
                                               predictor, corrector, corrector_steps,
                                               timestep_type=timestep_type, **tensors)

            return Program(fn, inputs, self.device)

        return self.cached_program(self._graphs, key, make)

    def cached_program(self, cache: dict, key, make: Callable[[], Program],
                       limit: Optional[int] = None):
        """The captured program of ``key`` in ``cache`` (a dict kept on this
        model): made by ``make()`` on first use, and again when the
        backbone's parameters moved or changed (``_params_key``). With
        ``limit``, the cache keeps at most that many programs, dropping the
        least recently used before it captures another: the programs of a
        device share one graph memory pool, whose blocks a dropped program's
        outputs hand to the next capture, so the card memory kept stops
        growing with the number of distinct keys."""
        params = self._params_key()
        entry = cache.pop(key, None)  # re-inserted last: the most recently used
        if entry is not None and entry[0] == params:
            cache[key] = entry
            return entry[1]
        del entry  # free a stale program's memory first
        while limit is not None and len(cache) >= limit:
            cache.pop(next(iter(cache)))
        program = make()
        cache[key] = (params, program)
        return program

    def drop_programs(self) -> None:
        """Drop every captured program kept on this model (enhance's, the eval
        harness's and the chunk programs) and, on the card, hand the memory
        their graph pool kept back to the device (a validation's programs
        must not stay on top of training's peak)."""
        self._graphs.clear()
        for name in ("_eval_programs", "_stream_programs"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def enhance(self, x, y, generator: Optional[torch.Generator] = None,
                noise: Optional[NoiseFn] = None, sampler_type: str = "pc",
                predictor: str = "reverse_diffusion", corrector: str = "ald", N: int = 30,
                corrector_steps: int = 1, snr: float = 0.5, timeit: bool = False,
                oracle: bool = False, clean_rms: float = 1.0, noise_rms: float = 1.0,
                timestep_type: str = "linear", seq_mesh=None):
        """Enhance the noisy waveform ``y`` ([1, samples]).

        ``x`` is the clean waveform; of the ported branches only
        ``sebridge_v2_snr`` reads it (pass ``y`` twice where there is none).
        With ``snr_conditioned="true"`` the SNR comes from SNRNet on the
        unpadded ``y``, or is ``noise_rms / clean_rms`` with ``oracle``.
        ``model_type="bbed"`` samples the reverse SDE (``sampler_type="pc"``:
        ``predictor``, ``corrector``, ``N`` steps on the ``timestep_type``
        grid) or the probability-flow ODE (any other ``sampler_type``).
        Noise comes from ``noise(like)`` when given (tests feed the JAX
        package's draws through it), otherwise from ``generator`` (a
        generator on ``self.device``; seed 0 when None).

        On the card, with noise from ``generator``, the branch runs as its
        captured program (``_enhance_graph``): captured on the first call for
        its width bucket (one eager warm-up run, then the capture), replayed
        after. The same steps run eagerly, op by op, in two cases only: on
        the CPU, and with a caller's ``noise`` callable, which a graph
        cannot call.

        With ``seq_mesh`` (a 1-D mesh, ``parallel.sequence.make_seq_mesh``,
        over which every rank of it calls ``enhance`` with the same
        arguments) the spectrogram's frames are split over the mesh's ranks
        (``constrain_frames``; a width that does not divide over them runs
        whole on each) and the steps run eagerly: every rank returns the
        whole waveform, the one-device program's to float tolerance. The
        SNR estimate and the snap to the Karras grid run on the whole
        waveform, as on one device. Configurations of the backbone other
        than the paper's family raise ``NotImplementedError``.

        Returns the enhanced waveform as a numpy array of ``samples``; with
        ``timeit=True`` a tuple ``(x_hat, nfe, rtf)``.
        """
        start = time.time()
        cfg = self.cfg
        branch = self._branch(sampler_type)
        if seq_mesh is not None:
            check = getattr(self.backbone, "check_frames_parallel", None)
            if check is None:
                raise NotImplementedError(
                    f"frames-parallel enhancement takes NCSN++ only, not {cfg.backbone} "
                    "(ROADMAP.md queue 1, frames-parallel enhancement of the other backbones)")
            check()
        x, y = _as_wave(x), _as_wave(y)
        t_orig = y.shape[-1]

        inputs = {}
        if branch.endswith("_snr"):
            est_snr = (np.float32(noise_rms / clean_rms) if oracle
                       else self.estimate_snr(y)[0].item())
            t_hat, normfac = snap_to_karras_grid(est_snr, cfg.fixed_snr)
            inputs["normfac"] = float(normfac)
            if branch == "sebridge_v3_snr":
                inputs["t_hat"] = float(t_hat)
        if branch == "bbed_pc":
            inputs["snr"] = float(np.float32(snr))

        # Frames padded to a multiple of 64 on the host, as the JAX package
        # does: the U-Net downsamples six times.
        t_pad, pad_samples = width_bucket(t_orig, cfg.hop_length)
        if t_orig < pad_samples:
            x = F.pad(x, (0, pad_samples - t_orig))
            y = F.pad(y, (0, pad_samples - t_orig))
        elif t_orig > pad_samples:
            x = x[..., :pad_samples]
            y = y[..., :pad_samples]
        inputs["y"] = y
        if branch == "sebridge_v2_snr":
            inputs["x"] = x

        if noise is None and generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if seq_mesh is None and noise is None and self.device.type == "cuda":
            program = self._enhance_graph(branch, t_pad, N, predictor, corrector,
                                          corrector_steps, oracle, inputs,
                                          timestep_type=timestep_type)
            if branch == "bbed_ode":
                x_hat, nfe = program(generator, **inputs), program.flags[1]
            else:
                x_hat, nfe = program(generator, **inputs)
        else:
            if noise is None:
                noise = generator_noise(generator)
            tensors = {name: to_device(v, self.device) if torch.is_tensor(v) else
                       torch.full((), v, dtype=torch.float32, device=self.device)
                       for name, v in inputs.items()}
            # frames-parallel: the frames split over the mesh's ranks where the
            # width divides over them, else each rank runs the whole width
            count = 1 if seq_mesh is None else seq_mesh.mesh.numel()
            with constrain_frames(seq_mesh if t_pad % count == 0 else None) as seq:
                x_hat, nfe = self._enhance_on_device(
                    branch, noise if seq is None else seq.draws(noise), N, predictor, corrector,
                    corrector_steps, timestep_type=timestep_type, **tensors)

        x_hat = x_hat[0, :t_orig].cpu().numpy()
        if x_hat.shape[-1] < t_orig:
            # frames % 64 == 0 bucket: the iSTFT yields up to hop-1 samples
            # fewer than the input; zero-pad back to its length.
            x_hat = np.pad(x_hat, (0, t_orig - x_hat.shape[-1]))
        if timeit:
            return x_hat, nfe, (time.time() - start) / (len(x_hat) / 16000)
        return x_hat
