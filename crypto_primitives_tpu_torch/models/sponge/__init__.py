"""Sponge layer: duplex sponge API, Poseidon, absorb encodings.

Twin of ``crypto_primitives_tpu/models/sponge`` (the reference's src/sponge,
traits at src/sponge/mod.rs:101-206).  The host :class:`PoseidonSponge` is the
semantics oracle; :class:`PoseidonSpongeBatch` is the batched path.
"""

from crypto_primitives_tpu_torch.models.sponge.absorb import (
    Felt,
    I8,
    I16,
    I32,
    I64,
    I128,
    Isize,
    OptionAbsorb,
    SWPointAbsorb,
    TEPointAbsorb,
    U8,
    U16,
    U32,
    U64,
    U128,
    Usize,
    WithLength,
    absorbable,
    bytes_to_field_elements,
    to_sponge_bytes,
    to_sponge_field_elements,
)


class FieldElementSize:
    """`FieldElementSize` twin (src/sponge/mod.rs:29-54)."""

    FULL = "full"

    class Truncated:
        def __init__(self, num_bits: int):
            self.num_bits = num_bits

        def __eq__(self, other):
            return isinstance(other, FieldElementSize.Truncated) and self.num_bits == other.num_bits

        def __hash__(self):
            return hash(("truncated", self.num_bits))

    @staticmethod
    def num_bits(size, spec) -> int:
        if isinstance(size, FieldElementSize.Truncated):
            if size.num_bits > spec.nbits:
                raise ValueError("num_bits is greater than the capacity of the field.")
            return size.num_bits
        return spec.nbits - 1


from crypto_primitives_tpu_torch.models.sponge.poseidon import (  # noqa: E402
    PoseidonConfig,
    PoseidonSponge,
    PoseidonSpongeBatch,
    find_poseidon_ark_and_mds,
    get_default_poseidon_parameters,
    permute,
)
