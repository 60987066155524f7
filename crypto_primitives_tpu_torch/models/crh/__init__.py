"""CRH layer: collision-resistant hash schemes.

Twin of ``crypto_primitives_tpu/models/crh`` for the Poseidon, SHA-256 and
Pedersen schemes; Bowe-Hopwood (``models/crh/bowe_hopwood.py``) and the
injective-map compressors (``models/crh/injective_map.py``) are imported from
their modules, as in the JAX package.
Each scheme has a host tier (``evaluate``, ``compress``: Python values,
exact) and a batched tier (``evaluate_batch``, ``compress_batch``: tensors
with leading batch axes, on ``device``, ``None`` meaning CUDA).
"""

from crypto_primitives_tpu_torch.models.crh.pedersen import (
    PedersenCRH,
    PedersenParameters,
    PedersenTwoToOneCRH,
    Window,
)
from crypto_primitives_tpu_torch.models.crh.poseidon import PoseidonCRH, PoseidonTwoToOneCRH
from crypto_primitives_tpu_torch.models.crh.sha256 import Sha256CRH, Sha256TwoToOneCRH
