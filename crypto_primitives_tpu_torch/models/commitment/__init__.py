"""Commitment layer.

Twin of ``crypto_primitives_tpu/models/commitment`` (the reference's
src/commitment/mod.rs:15-27): the Blake2s commitment, the Pedersen
commitment and its injective-map compressor.
"""

from crypto_primitives_tpu_torch.models.commitment.blake2s import Blake2sCommitment
from crypto_primitives_tpu_torch.models.commitment.injective_map import PedersenCommitmentCompressor
from crypto_primitives_tpu_torch.models.commitment.pedersen import (
    PedersenCommitment,
    PedersenCommitmentParameters,
)
