"""SNR-conditioned NCSN++ backbone.

The implementation lives in ``diffse_tpu_torch/models/ncsnpp.py``
(``NCSNppBase`` with ``snr_conditioning``); this module mirrors the JAX
package's file layout and re-exports the registered class.
"""

from .ncsnpp import NCSNppSNR

__all__ = ["NCSNppSNR"]
