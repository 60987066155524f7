"""Encryption layer.

Twin of ``crypto_primitives_tpu/models/encryption`` (the reference's
src/encryption/mod.rs:10-37): ``AsymmetricEncryptionScheme{setup, keygen,
encrypt, decrypt}``.
"""

from crypto_primitives_tpu_torch.models.encryption.elgamal import ElGamal, ElGamalParameters


class AsymmetricEncryptionScheme:
    def setup(self, rng):
        raise NotImplementedError

    def keygen(self, params, rng):
        raise NotImplementedError

    def encrypt(self, params, pk, message, randomness):
        raise NotImplementedError

    def decrypt(self, params, sk, ciphertext):
        raise NotImplementedError
