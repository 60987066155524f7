"""Canonical (un)serialization, ark-serialize behavioral twins.

Twin of ``crypto_primitives_tpu/utils/serialize.py``: the reference's
``to_uncompressed_bytes!`` macro (src/macros.rs:3-13) and the ark-serialize
layouts the framework depends on:

  * field element uncompressed = bigint LE bytes (full limb width);
  * TE affine point uncompressed = x || y (no flags);
  * `Vec<u8>` uncompressed = u64 LE length prefix + bytes (the layout the
    SHA-256 Merkle ByteDigestConverter hashes);
  * fixed byte arrays serialize raw.
"""

from __future__ import annotations

# the module, not its names: ops.curve imports utils (through its kernel
# wrapper), so this may run while ops.curve is still being imported
from crypto_primitives_tpu_torch.ops import curve as te
from crypto_primitives_tpu_torch.ops.field import FieldSpec


def uncompressed_bytes_of_field(spec: FieldSpec, value: int) -> bytes:
    return spec.to_bytes_le(int(value))


def uncompressed_bytes_of_te_point(curve: te.TECurveSpec, pt) -> bytes:
    return curve.to_uncompressed_bytes(pt)


def to_uncompressed_bytes(value, spec=None) -> bytes:
    """Generic dispatch twin of `to_uncompressed_bytes!`.

    ``spec`` is a FieldSpec (for ints) or TECurveSpec (for point tuples).
    """
    if isinstance(value, (bytes, bytearray)):
        return len(value).to_bytes(8, "little") + bytes(value)  # Vec<u8>
    if isinstance(value, int):
        if not isinstance(spec, FieldSpec):
            raise TypeError("an int serializes as a field element: pass its FieldSpec")
        return uncompressed_bytes_of_field(spec, value)
    if isinstance(value, tuple) and len(value) == 2:
        if not isinstance(spec, te.TECurveSpec):
            raise TypeError("a point serializes on a TE curve: pass its TECurveSpec")
        return uncompressed_bytes_of_te_point(spec, value)
    if isinstance(value, (list,)):
        body = b"".join(to_uncompressed_bytes(v, spec) for v in value)
        return len(value).to_bytes(8, "little") + body  # Vec<T>
    raise TypeError(f"not serializable: {type(value)}")
