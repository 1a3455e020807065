"""SNRModel: training, validation and inference around the SNR-estimator CNN
(port of diffse_tpu/models/snr_model.py).

Training draws a noise-level target gt ~ U[0, 0.999), remixes the noisy
spectrogram to the implied SNR, applies the normalisation-factor correction
and regresses SNRNet's sigmoid output onto gt with MSE; validation converts
both to dB and reports the mean absolute SNR error. The draw
(``draw_loss_noise``) is apart from the arithmetic (``loss_from_draws``), as
in ``ScoreModel``, so that tests can feed the JAX package's gt.

The data contract is transform_type='none': the specs fed to SNRNet are raw,
uncompressed STFTs. ``snr_from_normalized_wav`` is the one estimation path;
``ScoreModel.estimate_snr`` (per-row normalisation) and
``SNRModel.estimate_from_wav`` (batch normalisation) differ only in how they
normalise the waveform first, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..karras import calculate_normfac_direct
from ..parallel.mesh import current_shard
from ..transforms import StftConfig, get_window, pad_spec_16, stft
from ..utils import model_device, to_device
from .snrnet import SNRNet


@dataclasses.dataclass
class SNRModelConfig:
    """diffse_tpu's SNRModelConfig: the same fields, names, defaults and
    order (``hparams`` round-trips through it). Inference reads the STFT's;
    training ``lr`` and ``ema_decay`` (a checkpoint's ``TrainState``)."""

    lr: float = 1e-4
    ema_decay: float = 0.999
    num_eval_files: int = 10
    loss_type: str = "mse"
    n_fft: int = 510
    hop_length: int = 128
    num_frames: int = 256
    window: str = "hann"
    transform_type: str = "none"


def complex_to_2ch(y: torch.Tensor) -> torch.Tensor:
    """``[B, 1, F, T]`` complex -> ``[B, 2, F, T]`` real."""
    return torch.cat([y.real, y.imag], dim=1)


def snr_from_normalized_wav(net: torch.nn.Module, y_n: torch.Tensor, window: torch.Tensor,
                            n_fft: int, hop_length: int) -> torch.Tensor:
    """Normalised waveforms ``[B, samples]`` -> amplitude-ratio SNR ``[B]``:
    raw STFT, two real channels, time padded to 16, SNRNet, ``g / (1 - g)``."""
    spec = stft(y_n, window, n_fft, hop_length)
    est_gt = net(pad_spec_16(complex_to_2ch(spec[:, None])))[:, 0]
    return est_gt / (1 - est_gt)


class SNRModel:
    """SNR estimator wrapper.

    Args:
        config: hyperparameters.
        device: where SNRNet's weights live and estimation runs: the card
            unless given (``"cpu"`` for the CPU); raises without a CUDA device.
        dnn: an SNRNet to use (moved to ``device``); a fresh one when None.
    """

    _complex_to_2ch = staticmethod(complex_to_2ch)

    def __init__(self, config: SNRModelConfig = SNRModelConfig(), device="cuda",
                 dnn: Optional[SNRNet] = None):
        self.cfg = config
        self.device = model_device(device)
        self.dnn = (dnn if dnn is not None else SNRNet()).to(self.device).eval()
        self.stft_cfg = StftConfig(n_fft=config.n_fft, hop_length=config.hop_length,
                                   window=config.window)
        self._window = get_window(config.window, config.n_fft, device=self.device)

    @property
    def hparams(self) -> dict:
        """The hyperparameters as the JAX package stores them."""
        return {"config": dataclasses.asdict(self.cfg)}

    @classmethod
    def from_hparams(cls, hparams: dict, device="cuda", **config_overrides) -> "SNRModel":
        """A model (a fresh SNRNet) from ``hparams``, with ``config_overrides``
        over its config."""
        return cls(SNRModelConfig(**{**hparams["config"], **config_overrides}), device=device)

    @torch.no_grad()
    def forward(self, y_spec2ch: torch.Tensor) -> torch.Tensor:
        """y_spec2ch: ``[B, 2, F, T]`` real/imag channels -> ``[B, 1]`` g_hat."""
        return self.dnn(y_spec2ch)

    def _apply(self, y_spec2ch: torch.Tensor, variables: Optional[dict]) -> torch.Tensor:
        """SNRNet on ``y_spec2ch`` with gradients, with ``variables`` (its
        parameters by name, e.g. ``train.state.eval_variables``) in place of
        its own when given."""
        if variables is None:
            return self.dnn(y_spec2ch)
        return torch.func.functional_call(self.dnn, variables, (y_spec2ch,))

    # -------------------------------------------------------------- training
    def prepare_batch(self, wav_batch):
        """Waveform crops -> raw spectrograms on the model's device: each row
        normalised by the noisy row's max-abs, STFT (transform_type='none').

        Args:
            wav_batch: ``(x_wav [B, L], y_wav [B, L], *rest)``, tensors or
                numpy arrays; ``rest`` (``Specs_SNR``'s clean and noise
                active-RMS levels) is moved to the device as float32.
        Returns:
            ``(X [B, 1, F, T], Y [B, 1, F, T], *rest)``, X and Y complex.
        """
        x_wav, y_wav, *rest = (to_device(torch.as_tensor(a, dtype=torch.float32), self.device)
                               for a in wav_batch)
        normfac = torch.max(torch.abs(y_wav), dim=-1, keepdim=True).values
        n_fft, hop = self.stft_cfg.n_fft, self.stft_cfg.hop_length
        X = stft(x_wav / normfac, self._window, n_fft, hop)[:, None]
        Y = stft(y_wav / normfac, self._window, n_fft, hop)[:, None]
        return (X, Y, *rest)

    @staticmethod
    def draw_loss_noise(x: torch.Tensor, generator: torch.Generator) -> dict:
        """The draw of one ``loss_fn`` call for a batch like ``x``: the target
        ``"gt"``, uniform on [0, 0.999) as float32 ``[B]``, from ``generator``
        (on x's device)."""
        return {"gt": torch.rand(x.shape[0], generator=generator, device=x.device) * 0.999}

    def loss_fn(self, batch, generator: torch.Generator, train: bool = True,
                variables: Optional[dict] = None) -> torch.Tensor:
        """The training loss of ``batch`` (``prepare_batch``'s output; entries
        after X and Y are ignored) with its draw from ``generator``:
        ``loss_from_draws`` of ``draw_loss_noise``. The contract of
        ``ScoreModel.loss_fn``, so that ``train.steps`` applies unchanged;
        inside ``parallel.mesh.batch_shard`` the draw is taken at the global
        batch's shape and this rank's rows kept, as there."""
        shard = current_shard()
        x = batch[0]
        draws = self.draw_loss_noise(x if shard is None else shard.global_like(x), generator)
        if shard is not None:
            draws = {k: shard.rows(v) for k, v in draws.items()}
        return self.loss_from_draws(batch, draws, train=train, variables=variables)

    def loss_from_draws(self, batch, draws: dict, train: bool = True,
                        variables: Optional[dict] = None) -> torch.Tensor:
        """The loss of ``batch = (X, Y, ...)`` given the target ``draws["gt"]``:
        Y remixed to the SNR ``gt / (1 - gt)`` (``X + (Y - X) 0.56234 snr``),
        times the normalisation-factor correction, SNRNet's estimate of gt,
        MSE. The SNR is cast to the specs' complex dtype first, so that the
        correction is computed in complex arithmetic as the JAX package's
        is. ``train`` sets SNRNet's mode (it has no dropout);
        ``variables`` as for ``_apply``."""
        x, y = batch[0], batch[1]
        self.dnn.train(train)
        gt = draws["gt"]
        snr_b = (gt / (1 - gt))[:, None, None, None].to(x.dtype)
        y = (x + (y - x) * 0.56234 * snr_b) * calculate_normfac_direct(1.0, snr_b, 1.0)
        est_gt = self._apply(complex_to_2ch(y), variables)[:, 0]
        return torch.mean((gt - est_gt) ** 2)

    def valid_metrics(self, batch, variables: Optional[dict] = None) -> dict:
        """Validation of ``batch = (X, Y, s, n)`` (``prepare_batch`` of
        ``Specs_SNR``'s crops with their active-RMS clean and noise levels):
        ``valid_loss``, the MSE between gt = n / (s + n) and SNRNet's
        estimate, and ``snr_error``, the mean absolute error of the two in dB
        (``20 log10((1 - g) / g)``), as 0-d tensors on the device."""
        x, y, s, n = batch
        gt = n / (s + n)
        real_snr_db = 20 * torch.log10((1 - gt) / gt)
        with torch.no_grad():
            est_gt = self._apply(complex_to_2ch(y), variables)[:, 0]
        est_snr_db = 20 * torch.log10((1 - est_gt) / est_gt)
        return {"valid_loss": torch.mean((gt - est_gt) ** 2),
                "snr_error": torch.mean(torch.abs(real_snr_db - est_snr_db))}

    @torch.no_grad()
    def estimate_from_wav(self, y_wav: torch.Tensor) -> torch.Tensor:
        """Waveform ``[B, samples]`` -> estimated amplitude-ratio SNR ``[B]``,
        normalised by the max-abs of the whole batch as the JAX package does."""
        y_wav = torch.as_tensor(y_wav, dtype=torch.float32).to(self.device)
        return snr_from_normalized_wav(self.dnn, y_wav / torch.max(torch.abs(y_wav)),
                                       self._window, self.stft_cfg.n_fft,
                                       self.stft_cfg.hop_length)
