"""Commitment layer.

Twin of ``crypto_primitives_tpu/models/commitment`` (the reference's
src/commitment/mod.rs:15-27): the Blake2s commitment, the Pedersen
commitment and its injective-map compressor, each a
:class:`CommitmentScheme`.
"""


class CommitmentScheme:
    """The interface of a commitment (the JAX package's ``CommitmentScheme``)."""

    def setup(self, rng):
        raise NotImplementedError

    def commit(self, params, input_, randomness):
        raise NotImplementedError

    def commit_batch(self, params, inputs, randomness, device=None):
        raise NotImplementedError


# the schemes import the base above from this package
from crypto_primitives_tpu_torch.models.commitment.blake2s import Blake2sCommitment  # noqa: E402
from crypto_primitives_tpu_torch.models.commitment.injective_map import PedersenCommitmentCompressor  # noqa: E402
from crypto_primitives_tpu_torch.models.commitment.pedersen import (  # noqa: E402
    PedersenCommitment,
    PedersenCommitmentParameters,
)
