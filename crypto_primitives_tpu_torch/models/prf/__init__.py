"""PRF layer.

Twin of ``crypto_primitives_tpu/models/prf`` (the reference's
src/prf/mod.rs:14-20: ``PRF{Input, Output, Seed; evaluate(seed, input)}``).
"""

from crypto_primitives_tpu_torch.models.prf.blake2s import Blake2sPRF, Blake2sWithParameterBlock


class PRF:
    def evaluate(self, seed, input_):
        raise NotImplementedError

    def evaluate_batch(self, seeds, inputs, device=None):
        raise NotImplementedError
