"""Serialization and profiling utilities (ark-serialize behavioral twins).

Twin of ``crypto_primitives_tpu/utils``.
"""

from crypto_primitives_tpu_torch.utils.serialize import (
    to_uncompressed_bytes,
    uncompressed_bytes_of_field,
    uncompressed_bytes_of_te_point,
)
