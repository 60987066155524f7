"""CRH layer: collision-resistant hash schemes.

Twin of ``crypto_primitives_tpu/models/crh`` for the Poseidon, SHA-256 and
Pedersen schemes (Bowe-Hopwood and the injective maps are not ported yet).
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
