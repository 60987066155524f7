"""Protocols built from the primitive layer.

Twin of ``crypto_primitives_tpu/models/protocols``.  The reference stops at the
sponge, which it offers as the building block of downstream protocols (its
src/sponge/mod.rs:101-154); these modules compose the port's tiers into
transcript-driven protocols end to end: the multilinear sumcheck
(``sumcheck.py``) and the IPA-style folding argument on the curve tier
(``ipa_fold.py``), both over the Fiat-Shamir transcript of
``models/sponge/fiat_shamir.py``.
"""

from crypto_primitives_tpu_torch.models.protocols.sumcheck import (  # noqa: F401
    sumcheck_prove,
    sumcheck_prove_host,
    sumcheck_verify_host,
)
