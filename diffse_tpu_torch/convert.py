"""Weight bridge from the JAX package's flax parameters to the port.

``state_dict_from_jax`` walks the NCSN++ construction with the converter in
``tools/convert_torch_checkpoint.py`` (``ncsnpp_correspondence`` and
``convert_flax_to_state_dict``, numpy-only at module level) and returns a
state_dict that ``NCSNpp.load_state_dict(..., strict=True)`` takes. The same
walk maps the reference's published torch checkpoints, so those load too.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

_CONVERTER = Path(__file__).resolve().parents[1] / "tools" / "convert_torch_checkpoint.py"


def load_converter():
    """Import ``tools/convert_torch_checkpoint.py`` by path."""
    spec = importlib.util.spec_from_file_location("convert_torch_checkpoint", _CONVERTER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def state_dict_from_jax(params: dict, **arch) -> dict:
    """Flax param tree (numpy leaves) -> the port's NCSN++ state_dict.

    Args:
        params: the ``variables["params"]`` tree of ``diffse_tpu``'s NCSNpp.
        arch: architecture keywords of ``ncsnpp_correspondence`` (nf,
            ch_mult, num_res_blocks, attn_resolutions, image_size).
    """
    conv = load_converter()
    corr = conv.ncsnpp_correspondence(**arch)
    sd = conv.convert_flax_to_state_dict(params, corr, torch_root="")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
