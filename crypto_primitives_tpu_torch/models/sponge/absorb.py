"""Canonical sponge-input encodings (`Absorb` twin).

Twin of crypto_primitives_tpu/models/sponge/absorb.py, a behavioural mirror of
arkworks crypto-primitives src/sponge/absorb.rs:
every encodable value has two encodings — a byte stream (`to_sponge_bytes`)
and a field-element stream (`to_sponge_field_elements`).  Since Python ints
are untyped, fixed-width integers use explicit wrapper types (the Rust type
drives the encoding in the reference).

Key reference behaviors preserved:
  * `u8` **batches** are length-prefixed (u64 LE) then bit-packed into field
    elements in chunks of (MODULUS_BIT_SIZE-1)/8 bytes (absorb.rs:133-141);
    single u8 values are not.
  * field elements cast via `field_cast` (same characteristic only,
    absorb.rs:108-122); batches are *not* length-prefixed.
  * signed ints encode as ±F(|v|) (absorb.rs:188-210).
  * strings: length-prefixed bytes; for field elements they reuse the
    u8-slice rule (absorb.rs:232-241).
  * TE points absorb as [x, y]; SW points additionally absorb the infinity
    flag (absorb.rs:243-282).
  * `Option`: is_some flag then payload (absorb.rs:316-330).
  * `WithLength` prepends the element count (absorb.rs:84-103).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from crypto_primitives_tpu_torch.ops.field import FieldSpec


def _le(v: int, nbytes: int) -> bytes:
    return int(v).to_bytes(nbytes, "little", signed=False)


class _UInt:
    WIDTH = 0

    def __init__(self, value: int):
        if not 0 <= value < (1 << self.WIDTH):
            raise ValueError(f"{value} does not fit in {type(self).__name__}")
        self.value = value

    def __repr__(self):
        return f"{type(self).__name__}({self.value})"


class U8(_UInt):
    WIDTH = 8


class U16(_UInt):
    WIDTH = 16


class U32(_UInt):
    WIDTH = 32


class U64(_UInt):
    WIDTH = 64


class U128(_UInt):
    WIDTH = 128


class Usize(U64):
    """usize absorbs as u64 (absorb.rs:212-220)."""


class _SInt:
    WIDTH = 0

    def __init__(self, value: int):
        if not -(1 << (self.WIDTH - 1)) <= value < (1 << (self.WIDTH - 1)):
            raise ValueError(f"{value} does not fit in {type(self).__name__}")
        self.value = value


class I8(_SInt):
    WIDTH = 8


class I16(_SInt):
    WIDTH = 16


class I32(_SInt):
    WIDTH = 32


class I64(_SInt):
    WIDTH = 64


class I128(_SInt):
    WIDTH = 128


class Isize(I64):
    pass


class Felt:
    """A native field element (canonical int), `Fp` Absorb twin."""

    def __init__(self, value: int):
        self.value = value

    def __repr__(self):
        return f"Felt({self.value})"


class TEPointAbsorb:
    """Twisted-Edwards affine point for absorption (absorb.rs:243-261)."""

    def __init__(self, x: int, y: int):
        self.x, self.y = x, y


class SWPointAbsorb:
    """Short-Weierstrass affine point (absorb.rs:263-282)."""

    def __init__(self, x: int, y: int, infinity: bool = False):
        self.x, self.y, self.infinity = x, y, infinity


class OptionAbsorb:
    def __init__(self, value):
        self.value = value


class WithLength:
    """AbsorbWithLength: prepend the length (absorb.rs:84-103)."""

    def __init__(self, items):
        self.items = items


def bytes_to_field_elements(data: bytes, spec: FieldSpec) -> list:
    """ark-ff `ToConstraintField<F> for [u8]`: chunks of (MODULUS_BIT_SIZE-1)/8
    bytes, each interpreted LE mod p."""
    max_size = (spec.nbits - 1) // 8
    return [
        spec.from_le_bytes_mod_order(data[i : i + max_size])
        for i in range(0, len(data), max_size)
    ] if data else []


def _u8_batch_to_field_elements(data: bytes, spec: FieldSpec) -> list:
    """u8 batch rule (absorb.rs:137-141): u64 LE length prefix || bytes,
    packed via the byte->field chunking."""
    return bytes_to_field_elements(_le(len(data), 8) + bytes(data), spec)


def _is_u8_item(x) -> bool:
    return isinstance(x, U8) and not isinstance(x, Usize)


def to_sponge_bytes(value: Any, spec: FieldSpec) -> bytes:
    """`Absorb::to_sponge_bytes` twin; returns the byte encoding."""
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)  # &[u8] batch = raw bytes (absorb.rs:133-135)
    if isinstance(value, bool):
        return bytes([int(value)])
    if isinstance(value, U8):
        if isinstance(value, Usize):
            return _le(value.value, 8)
        return bytes([value.value])
    if isinstance(value, _UInt):
        return _le(value.value, value.WIDTH // 8)
    if isinstance(value, _SInt):
        return int(value.value).to_bytes(value.WIDTH // 8, "little", signed=True)
    if isinstance(value, Felt):
        return spec.serialize_compressed(value.value)
    if isinstance(value, str):
        return _le(len(value.encode()), 8) + value.encode()
    if isinstance(value, TEPointAbsorb):
        return spec.to_bytes_le(value.x) + spec.to_bytes_le(value.y)
    if isinstance(value, SWPointAbsorb):
        return (
            spec.to_bytes_le(value.x)
            + spec.to_bytes_le(value.y)
            + bytes([int(value.infinity)])
        )
    if isinstance(value, OptionAbsorb):
        out = bytes([int(value.value is not None)])
        if value.value is not None:
            out += to_sponge_bytes(value.value, spec)
        return out
    if isinstance(value, WithLength):
        items = value.items
        n = len(items)
        return to_sponge_bytes(Usize(n), spec) + to_sponge_bytes(items, spec)
    if isinstance(value, (list, tuple)):
        if len(value) > 0 and _is_u8_item(value[0]):
            return bytes(v.value for v in value)
        return b"".join(to_sponge_bytes(v, spec) for v in value)
    if hasattr(value, "__absorb_fields__"):
        return b"".join(
            to_sponge_bytes(getattr(value, f), spec) for f in value.__absorb_fields__
        )
    raise TypeError(f"not absorbable: {type(value)}")


def to_sponge_field_elements(value: Any, spec: FieldSpec) -> list:
    """`Absorb::to_sponge_field_elements` twin; returns list of canonical ints."""
    if isinstance(value, (bytes, bytearray)):
        return _u8_batch_to_field_elements(bytes(value), spec)
    if isinstance(value, bool):
        return [int(value) % spec.p]
    if isinstance(value, _UInt):
        return [value.value % spec.p]
    if isinstance(value, _SInt):
        v = abs(value.value) % spec.p
        return [(-v) % spec.p if value.value < 0 else v]
    if isinstance(value, Felt):
        # field_cast: same characteristic required (absorb.rs:108-122)
        return [value.value % spec.p]
    if isinstance(value, str):
        return _u8_batch_to_field_elements(value.encode(), spec)
    if isinstance(value, TEPointAbsorb):
        return [value.x % spec.p, value.y % spec.p]
    if isinstance(value, SWPointAbsorb):
        return [value.x % spec.p, value.y % spec.p, int(value.infinity)]
    if isinstance(value, OptionAbsorb):
        out = [int(value.value is not None)]
        if value.value is not None:
            out += to_sponge_field_elements(value.value, spec)
        return out
    if isinstance(value, WithLength):
        items = value.items
        return to_sponge_field_elements(Usize(len(items)), spec) + to_sponge_field_elements(
            items, spec
        )
    if isinstance(value, (list, tuple)):
        if len(value) > 0 and _is_u8_item(value[0]):
            return _u8_batch_to_field_elements(bytes(v.value for v in value), spec)
        out = []
        for v in value:
            out += to_sponge_field_elements(v, spec)
        return out
    if hasattr(value, "__absorb_fields__"):
        out = []
        for f in value.__absorb_fields__:
            out += to_sponge_field_elements(getattr(value, f), spec)
        return out
    raise TypeError(f"not absorbable: {type(value)}")


def absorbable(cls):
    """Derive-macro twin of `#[derive(Absorb)]`
    (arkworks crypto-primitives macros/src/lib.rs:7-94): marks a dataclass so its fields
    absorb in declaration order, equivalent to per-field manual absorption."""
    fields = [f.name for f in dataclasses.fields(cls)]
    cls.__absorb_fields__ = fields
    return cls
