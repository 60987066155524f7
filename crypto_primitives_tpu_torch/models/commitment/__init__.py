"""Commitment layer.

Twin of ``crypto_primitives_tpu/models/commitment`` (the reference's
src/commitment/mod.rs:15-27) for the Pedersen commitment; the Blake2s and
injective-map commitments are not ported yet.
"""

from crypto_primitives_tpu_torch.models.commitment.pedersen import (
    PedersenCommitment,
    PedersenCommitmentParameters,
)
