"""``enhance`` with the bf16 trunk of NCSN++ configurations other than the
paper's: ``sebridge_v2`` and ``bbed_pc`` (N = 3) of DDPM++ and of the
residual configuration (BigGAN FIR blocks with both residual pyramids),
the JAX package's draws fed to the port, against the JAX package's bf16
``enhance`` run op by op (``jax.disable_jit``: jitted, XLA would fuse bf16
operations and skip their roundings), within ``GAP_SHARE`` (a third) of its
own bf16-vs-float32 waveform gap, both printed. The weights are the JAX
package's initialisation with the heads and the output layer redrawn, the
inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from test_torch_backbones import DDPMPP
from test_torch_bf16 import GAP_SHARE, JAX_FLAGS, _heads_redrawn, _rel
from test_torch_enhance import noise_from, replay_pc_draws

torch.set_num_threads(2)

# two levels, attention at the second (128 x 32 positions): each level of the
# JAX bf16 program op by op costs seconds
ENHANCE_ARCH = dict(nf=4, ch_mult=(1, 1), num_res_blocks=1, attn_resolutions=(128,),
                    image_size=256)
RESIDUAL = dict(progressive="residual", progressive_input="residual")
ENHANCE_CONFIGS = {"ddpmpp": {k: v for k, v in DDPMPP.items() if k != "dropout"},
                   "residual": RESIDUAL}
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52)
FRAMES = 64
SAMPLES = (FRAMES - 1) * 128
N_STEPS = 3


_PARAMS = {}


def _initialised(jax_model, config):
    """The backbone's initialisation (jitted: op by op it costs more than its
    compilation), one for both branches of a configuration."""
    if config not in _PARAMS:
        _PARAMS[config] = jax.jit(lambda key: jax_model.init_variables(
            key, num_frames=FRAMES))(jax.random.PRNGKey(31))["params"]
    return _PARAMS[config]


def _enhance_pair(config, model_type, sigma_max):
    """The JAX ScoreModel in bf16 and float32 and the port's in bf16, on the
    JAX package's initialisation with the heads and the output layer
    redrawn (``_heads_redrawn``: at zero they would hide the network)."""
    arch = dict(ENHANCE_ARCH, **ENHANCE_CONFIGS[config])
    cfg = dict(backbone="ncsnpp", sde="bbed", model_type=model_type, snr_conditioned="false",
               sigma_max=sigma_max, t_eps=3e-2)
    sde = dict(SDE_KWARGS, N=N_STEPS)
    jax16, jax32 = (JaxScoreModel(JaxScoreModelConfig(**cfg),
                                  backbone_kwargs=dict(arch, **JAX_FLAGS, dtype=dtype),
                                  sde_kwargs=sde) for dtype in ("bf16", None))
    variables = {"params": _heads_redrawn(_initialised(jax32, config), seed=32)}
    port = ScoreModel(ScoreModelConfig(**cfg), backbone_kwargs=dict(arch, dtype="bf16"),
                      sde_kwargs=sde, device="cpu")
    port.backbone.load_state_dict(state_dict_from_jax(variables["params"], **arch),
                                  strict=True)
    return jax16, jax32, variables, port


@pytest.mark.parametrize("branch", ["sebridge_v2", "bbed_pc"])
@pytest.mark.parametrize("config", list(ENHANCE_CONFIGS))
def test_bf16_enhance_matches_jax(config, branch, capsys):
    model_type, sigma_max = ("bbed", 0.5) if branch == "bbed_pc" else ("sebridge_v2", 1.0)
    jax16, jax32, variables, port = _enhance_pair(config, model_type, sigma_max)
    rng = np.random.default_rng(33)
    x = (0.1 * rng.standard_normal((1, SAMPLES))).astype(np.float32)
    y = x + (0.05 * rng.standard_normal((1, SAMPLES))).astype(np.float32)
    key = jax.random.PRNGKey(34)
    spec = (1, 1, 256, FRAMES)
    if branch == "bbed_pc":
        draws = replay_pc_draws(key, N_STEPS, spec)
    else:
        draws = [np.asarray(jax_randn_like(key, jnp.zeros(spec, jnp.complex64)))]
    kw = dict(key=key, N=N_STEPS, clean_rms=1.0, noise_rms=1.0)
    with jax.disable_jit():
        ref16 = np.asarray(jax16.enhance(variables, x, y, **kw))
    ref32 = np.asarray(jax32.enhance(variables, x, y, **kw))
    out = port.enhance(x, y, noise=noise_from(draws), N=N_STEPS)
    gap, err = _rel(ref16, ref32), _rel(out, ref16)
    with capsys.disabled():
        print(f"\n{config} {branch} bf16 enhance: JAX bf16 vs JAX float32 waveform {gap:.3e}; "
              f"port bf16 vs JAX bf16 {err:.3e} (limit {GAP_SHARE * gap:.3e})")
    assert out.shape == ref16.shape == (SAMPLES,) and np.isfinite(out).all()
    assert err <= GAP_SHARE * gap
