"""Signature layer.

Twin of ``crypto_primitives_tpu/models/signature`` (the reference's
src/signature/mod.rs:12-50): ``SignatureScheme{setup, keygen, sign,
verify}`` plus the randomizable extension ``randomize_public_key`` /
``randomize_signature``.
"""

from crypto_primitives_tpu_torch.models.signature.schnorr import (
    Schnorr,
    SchnorrParameters,
    SchnorrSignature,
)


class SignatureScheme:
    def setup(self, rng):
        raise NotImplementedError

    def keygen(self, params, rng):
        raise NotImplementedError

    def sign(self, params, sk, message, rng):
        raise NotImplementedError

    def verify(self, params, pk, message, signature):
        raise NotImplementedError

    def randomize_public_key(self, params, public_key, randomness):
        raise NotImplementedError

    def randomize_signature(self, params, signature, randomness):
        raise NotImplementedError
