"""Batched primitives on PyTorch tensors: the field tier, SHA-256, and the
CUDA kernels' wrappers."""

from crypto_primitives_tpu_torch.ops.field import FieldSpec
from crypto_primitives_tpu_torch.ops.fields_known import (
    ALL_FIELDS,
    BLS12_377_FR,
    BLS12_381_FQ,
    BLS12_381_FR,
    ED_ON_BLS12_377_FR,
    JUBJUB_FR,
)
