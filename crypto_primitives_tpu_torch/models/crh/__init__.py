"""CRH layer: collision-resistant hash schemes.

Twin of ``crypto_primitives_tpu/models/crh`` (the reference's
src/crh/mod.rs:18-51, ``CRHScheme{setup, evaluate}`` and
``TwoToOneCRHScheme{setup, evaluate, compress}``) for the Poseidon, SHA-256
and Pedersen schemes; Bowe-Hopwood (``models/crh/bowe_hopwood.py``) and the
injective-map compressors (``models/crh/injective_map.py``) are imported from
their modules, as in the JAX package.  Every scheme derives from
:class:`CRHScheme` or :class:`TwoToOneCRHScheme`, so a ``MerkleTreeConfig``
can take any of them by interface.
Each scheme has a host tier (``evaluate``, ``compress``: Python values,
exact) and a batched tier (``evaluate_batch``, ``compress_batch``: tensors
with leading batch axes, on ``device``, ``None`` meaning CUDA).
"""


class CRHScheme:
    """The interface of a one-input CRH (the JAX package's ``CRHScheme``)."""

    def setup(self, rng):
        raise NotImplementedError

    def evaluate(self, params, input_):
        raise NotImplementedError

    def evaluate_batch(self, params, inputs, device=None):
        raise NotImplementedError


class TwoToOneCRHScheme:
    """The interface of a two-to-one CRH (the JAX package's
    ``TwoToOneCRHScheme``): ``evaluate`` hashes two inputs, ``compress`` two
    earlier digests."""

    def setup(self, rng):
        raise NotImplementedError

    def evaluate(self, params, left, right):
        raise NotImplementedError

    def compress(self, params, left, right):
        raise NotImplementedError

    def evaluate_batch(self, params, left, right, device=None):
        raise NotImplementedError

    def compress_batch(self, params, left, right, device=None):
        raise NotImplementedError


# the schemes import the bases above from this package
from crypto_primitives_tpu_torch.models.crh.pedersen import (  # noqa: E402
    PedersenCRH,
    PedersenParameters,
    PedersenTwoToOneCRH,
    Window,
)
from crypto_primitives_tpu_torch.models.crh.poseidon import PoseidonCRH, PoseidonTwoToOneCRH  # noqa: E402
from crypto_primitives_tpu_torch.models.crh.sha256 import Sha256CRH, Sha256TwoToOneCRH  # noqa: E402
