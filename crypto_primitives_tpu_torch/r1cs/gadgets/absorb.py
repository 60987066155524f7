"""AbsorbGadget: canonical sponge-input encodings for circuit variables.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/absorb.py``, itself the twin of
the reference's src/sponge/constraints/absorb.rs:
gadget values encode to FpVar streams exactly like their native `Absorb`
twins; notably a UInt8 *batch* gets a length prefix allocated as a
CONSTANT (the circuit shape is static, absorb.rs:65-72) and bytes pack
into field elements in (MODULUS_BIT_SIZE-1)/8-byte chunks as free linear
combinations.
"""

from __future__ import annotations

from typing import List, Sequence

from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem, LinearCombination
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, FpVar, UInt8


def bytes_to_field_elements_gadget(cs: ConstraintSystem, bytes_: Sequence[UInt8]) -> List[FpVar]:
    """ark `UInt8::to_constraint_field` twin: chunks of (nbits-1)//8 bytes,
    LE-packed as linear combinations (no constraints)."""
    max_size = (cs.field.nbits - 1) // 8
    p = cs.field.p
    out: List[FpVar] = []
    for i in range(0, len(bytes_), max_size):
        chunk = bytes_[i : i + max_size]
        acc = LinearCombination()
        val = 0
        const = True
        for j, byte in enumerate(chunk):
            fp = byte.to_fp()
            acc = acc.add(fp.lc.scale(1 << (8 * j), p), p)
            val = (val + (fp.value << (8 * j))) % p
            const = const and fp.const
        out.append(FpVar(cs, acc, val, const))
    return out


def absorb_gadget_u8_batch(cs: ConstraintSystem, bytes_: Sequence[UInt8]) -> List[FpVar]:
    """u8 batch rule: u64 LE length prefix (CONSTANT bytes) || data, packed
    (absorb.rs:65-72 + the native rule at src/sponge/absorb.rs:137-141)."""
    prefix = [UInt8.constant(cs, b) for b in len(bytes_).to_bytes(8, "little")]
    return bytes_to_field_elements_gadget(cs, list(prefix) + list(bytes_))


def absorb_gadget(cs: ConstraintSystem, value) -> List[FpVar]:
    """Dispatch twin of `AbsorbGadget::to_sponge_field_elements`."""
    if isinstance(value, FpVar):
        return [value]
    if isinstance(value, Boolean):
        return [value.fp]
    if isinstance(value, UInt8):
        return [value.to_fp()]
    # point vars: TE [x, y]; SW [x, y, infinity] (constraints/absorb.rs:98-166)
    from crypto_primitives_tpu_torch.r1cs.gadgets.curve import (
        SWAffineVar,
        SWProjectiveVar,
        TEAffineVar,
    )

    if isinstance(value, TEAffineVar):
        return [value.x, value.y]
    if isinstance(value, SWAffineVar):
        return [value.x, value.y, value.infinity.fp]
    if isinstance(value, SWProjectiveVar):
        return absorb_gadget(cs, value.to_affine())
    if isinstance(value, (list, tuple)):
        if len(value) > 0 and isinstance(value[0], UInt8):
            return absorb_gadget_u8_batch(cs, value)
        out: List[FpVar] = []
        for v in value:
            out.extend(absorb_gadget(cs, v))
        return out
    raise TypeError(f"not absorbable in-circuit: {type(value)}")
