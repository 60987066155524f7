"""CanonicalSerialize / CanonicalDeserialize twins (round-trip wire formats).

Twin of ``crypto_primitives_tpu/utils/canonical.py``; every codec writes the
same bytes as the JAX package's.  Every persistent reference object derives
both directions (the reference's src/merkle_tree/mod.rs:139,239,
src/sponge/poseidon/mod.rs:26); this module provides the same byte layouts
with full round-trip support, so proofs and parameters cross process
boundaries.

ark-serialize layout rules implemented here (ark-serialize 0.4):
  * prime field element: bigint LE bytes, full limb width (compressed ==
    uncompressed);
  * u8/u16/u32/u64: LE fixed width; usize: serialized as u64 LE;
  * bool / Option tag: single byte 0/1;
  * Vec<T>: u64 LE length prefix + elements;
  * fixed arrays [T; N]: elements raw, no prefix;
  * TE affine compressed: y bigint LE with MSB flag set iff x > -x
    (TEFlags::XIsNegative); uncompressed: x || y, no flags;
  * deserialization validates: field elements < p, points on curve and
    x-sign consistent.

Deserialization failures raise the port's SerializationError (errors.py),
the twin of ark_serialize::SerializationError.
"""

from __future__ import annotations

from typing import Callable, Sequence

from crypto_primitives_tpu_torch.errors import SerializationError
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.field import FieldSpec


class Reader:
    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SerializationError("unexpected end of input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def finish(self):
        if self.pos != len(self.data):
            raise SerializationError(
                f"{len(self.data) - self.pos} trailing bytes"
            )


# -- scalars -----------------------------------------------------------------


def write_u64(v: int) -> bytes:
    return int(v).to_bytes(8, "little")


def read_u64(r: Reader) -> int:
    return int.from_bytes(r.take(8), "little")


write_usize = write_u64
read_usize = read_u64


def write_field(spec: FieldSpec, v: int) -> bytes:
    return spec.to_bytes_le(int(v))


def read_field(spec: FieldSpec, r: Reader) -> int:
    v = int.from_bytes(r.take(spec.bigint_bytes), "little")
    if v >= spec.p:
        raise SerializationError("field element out of range")
    return v


# -- TE points ----------------------------------------------------------------


def write_te_compressed(curve: TECurveSpec, pt) -> bytes:
    return curve.serialize_compressed(pt)


def read_te_compressed(curve: TECurveSpec, r: Reader):
    base = curve.base
    data = bytearray(r.take(base.bigint_bytes))
    flag = data[-1] & 0x80
    data[-1] &= 0x7F
    y = int.from_bytes(bytes(data), "little")
    if y >= base.p:
        raise SerializationError("y out of range")
    if (pt := _te_from_y(curve, y, bool(flag))) is None:
        raise SerializationError("not a curve point")
    return pt


def _te_from_y(curve: TECurveSpec, y: int, x_is_negative: bool):
    """Recover x from y on a*x^2 + y^2 = 1 + d*x^2*y^2."""
    p = curve.base.p
    num = (y * y - 1) % p
    den = (curve.d * y * y - curve.a) % p
    if den == 0:
        return None
    x2 = num * pow(den, -1, p) % p
    x = curve.sqrt_host(x2)
    if x is None:
        return None
    if (x > p - x) != x_is_negative:
        x = (p - x) % p
    return (x, y)


def write_te_uncompressed(curve: TECurveSpec, pt) -> bytes:
    return curve.to_uncompressed_bytes(pt)


def read_te_uncompressed(curve: TECurveSpec, r: Reader):
    x = read_field(curve.base, r)
    y = read_field(curve.base, r)
    if not curve.is_on_curve((x, y)):
        raise SerializationError("not a curve point")
    return (x, y)


# -- SW points (ark-serialize SWFlags: infinity = 1<<6, y-negative = 1<<7
# -- in the top two bits of the last byte; buffer sized for MODULUS_BIT_SIZE
# -- + 2 flag bits, so a 255-bit field serializes into 33 bytes) -------------


def write_sw_compressed(curve, pt) -> bytes:
    return curve.serialize_compressed(pt)


def read_sw_compressed(curve, r: Reader):
    try:
        return curve.deserialize_compressed(r.take(curve.swflag_bytes))
    except ValueError as e:
        raise SerializationError(str(e))


def write_sw_uncompressed(curve, pt) -> bytes:
    return curve.to_uncompressed_bytes(pt)


def read_sw_uncompressed(curve, r: Reader):
    x = read_field(curve.base, r)
    buf = bytearray(r.take(curve.swflag_bytes))
    flags = buf[-1] & 0xC0
    buf[-1] &= 0x3F
    y = int.from_bytes(bytes(buf), "little")
    if flags == 0xC0:
        raise SerializationError("invalid SW flags")
    if flags & 0x40:
        if x != 0 or y != 0:
            raise SerializationError("bad infinity encoding")
        return None
    if y >= curve.base.p:
        raise SerializationError("y out of range")
    if (y > curve.base.p - y) != bool(flags & 0x80):
        raise SerializationError("y sign flag mismatch")
    if not curve.is_on_curve((x, y)):
        raise SerializationError("not a curve point")
    return (x, y)


# -- curve-model-generic point codecs (reference digests are generic over
# -- CurveGroup, src/merkle_tree/mod.rs:139) ---------------------------------


def _is_sw(curve) -> bool:
    from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec

    return isinstance(curve, SWCurveSpec)


def write_point_compressed(curve, pt) -> bytes:
    return (
        write_sw_compressed(curve, pt)
        if _is_sw(curve)
        else write_te_compressed(curve, pt)
    )


def read_point_compressed(curve, r: Reader):
    return (
        read_sw_compressed(curve, r)
        if _is_sw(curve)
        else read_te_compressed(curve, r)
    )


def write_point_uncompressed(curve, pt) -> bytes:
    return (
        write_sw_uncompressed(curve, pt)
        if _is_sw(curve)
        else write_te_uncompressed(curve, pt)
    )


def read_point_uncompressed(curve, r: Reader):
    return (
        read_sw_uncompressed(curve, r)
        if _is_sw(curve)
        else read_te_uncompressed(curve, r)
    )


# -- combinators ----------------------------------------------------------------


def write_vec(items: Sequence, write_item: Callable) -> bytes:
    return write_u64(len(items)) + b"".join(write_item(i) for i in items)


def read_vec(r: Reader, read_item: Callable) -> list:
    n = read_u64(r)
    if n > len(r.data):  # cheap sanity bound before allocating
        raise SerializationError("length prefix exceeds input")
    return [read_item(r) for _ in range(n)]


def write_bytes_vec(b: bytes) -> bytes:
    return write_u64(len(b)) + bytes(b)


def read_bytes_vec(r: Reader) -> bytes:
    n = read_u64(r)
    return r.take(n)


# -- PoseidonConfig (src/sponge/poseidon/mod.rs:26-45) -------------------------


def serialize_poseidon_config(cfg) -> bytes:
    spec = cfg.field
    fe = lambda v: write_field(spec, v)
    return b"".join(
        [
            write_usize(cfg.full_rounds),
            write_usize(cfg.partial_rounds),
            write_u64(cfg.alpha),
            write_vec(cfg.ark, lambda row: write_vec(row, fe)),
            write_vec(cfg.mds, lambda row: write_vec(row, fe)),
            write_usize(cfg.rate),
            write_usize(cfg.capacity),
        ]
    )


def deserialize_poseidon_config(spec: FieldSpec, data: bytes):
    from crypto_primitives_tpu_torch.models.sponge.poseidon import PoseidonConfig

    r = Reader(data)
    full_rounds = read_usize(r)
    partial_rounds = read_usize(r)
    alpha = read_u64(r)
    fe = lambda rr: read_field(spec, rr)
    ark = read_vec(r, lambda rr: read_vec(rr, fe))
    mds = read_vec(r, lambda rr: read_vec(rr, fe))
    rate = read_usize(r)
    capacity = read_usize(r)
    r.finish()
    return PoseidonConfig(
        field=spec,
        full_rounds=full_rounds,
        partial_rounds=partial_rounds,
        alpha=alpha,
        ark=ark,
        mds=mds,
        rate=rate,
        capacity=capacity,
    )


# -- Merkle Path / MultiPath (mod.rs:139-152, 239-258) --------------------------
# Digest codecs are injected: field digests use (write_field, read_field);
# byte digests (SHA-256 etc.) use Vec<u8> layout.


def field_digest_codec(spec: FieldSpec):
    return (lambda v: write_field(spec, v), lambda r: read_field(spec, r))


def byte_digest_codec():
    return (write_bytes_vec, read_bytes_vec)


def serialize_path(path, leaf_codec, inner_codec) -> bytes:
    wl, _ = leaf_codec
    wi, _ = inner_codec
    return b"".join(
        [
            wl(path.leaf_sibling_hash),
            write_vec(path.auth_path, wi),
            write_usize(path.leaf_index),
        ]
    )


def deserialize_path(data: bytes, leaf_codec, inner_codec):
    from crypto_primitives_tpu_torch.models.merkle_tree import Path

    _, rl = leaf_codec
    _, ri = inner_codec
    r = Reader(data)
    leaf_sibling_hash = rl(r)
    auth_path = read_vec(r, ri)
    leaf_index = read_usize(r)
    r.finish()
    return Path(
        leaf_sibling_hash=leaf_sibling_hash,
        auth_path=auth_path,
        leaf_index=leaf_index,
    )


def serialize_multipath(mp, leaf_codec, inner_codec) -> bytes:
    wl, _ = leaf_codec
    wi, _ = inner_codec
    return b"".join(
        [
            write_vec(mp.leaf_siblings_hashes, wl),
            write_vec(mp.auth_paths_prefix_lenghts, write_usize),
            write_vec(mp.auth_paths_suffixes, lambda sfx: write_vec(sfx, wi)),
            write_vec(mp.leaf_indexes, write_usize),
        ]
    )


def deserialize_multipath(data: bytes, leaf_codec, inner_codec):
    from crypto_primitives_tpu_torch.models.merkle_tree import MultiPath

    _, rl = leaf_codec
    _, ri = inner_codec
    r = Reader(data)
    leaf_siblings_hashes = read_vec(r, rl)
    prefix_lengths = read_vec(r, read_usize)
    suffixes = read_vec(r, lambda rr: read_vec(rr, ri))
    leaf_indexes = read_vec(r, read_usize)
    r.finish()
    return MultiPath(
        leaf_siblings_hashes=leaf_siblings_hashes,
        auth_paths_prefix_lenghts=prefix_lengths,
        auth_paths_suffixes=suffixes,
        leaf_indexes=leaf_indexes,
    )


# -- Pedersen parameters (crh/pedersen/mod.rs:29-31, commitment 18-21) ----------


def serialize_pedersen_crh_params(params, compressed: bool = True) -> bytes:
    curve = params.curve
    wp = (
        (lambda pt: write_point_compressed(curve, pt))
        if compressed
        else (lambda pt: write_point_uncompressed(curve, pt))
    )
    return write_vec(params.generators, lambda win: write_vec(win, wp))


def deserialize_pedersen_crh_params(curve: TECurveSpec, data: bytes, compressed: bool = True):
    from crypto_primitives_tpu_torch.models.crh.pedersen import PedersenParameters

    rp = (
        (lambda r: read_point_compressed(curve, r))
        if compressed
        else (lambda r: read_point_uncompressed(curve, r))
    )
    r = Reader(data)
    generators = read_vec(r, lambda rr: read_vec(rr, rp))
    r.finish()
    return PedersenParameters(curve, generators)


def serialize_pedersen_commitment_params(params, compressed: bool = True) -> bytes:
    curve = params.curve
    wp = (
        (lambda pt: write_point_compressed(curve, pt))
        if compressed
        else (lambda pt: write_point_uncompressed(curve, pt))
    )
    return write_vec(params.randomness_generator, wp) + write_vec(
        params.generators, lambda win: write_vec(win, wp)
    )


def deserialize_pedersen_commitment_params(curve: TECurveSpec, data: bytes, compressed: bool = True):
    from crypto_primitives_tpu_torch.models.commitment.pedersen import (
        PedersenCommitmentParameters,
    )

    rp = (
        (lambda r: read_point_compressed(curve, r))
        if compressed
        else (lambda r: read_point_uncompressed(curve, r))
    )
    r = Reader(data)
    randomness_generator = read_vec(r, rp)
    generators = read_vec(r, lambda rr: read_vec(rr, rp))
    r.finish()
    return PedersenCommitmentParameters(curve, randomness_generator, generators)


# -- Schnorr (signature/schnorr/mod.rs:23-40) -----------------------------------


def serialize_schnorr_params(curve: TECurveSpec, params) -> bytes:
    # struct order: generator (affine), salt ([u8; 32] -> raw, no prefix)
    return write_point_compressed(curve, params.generator) + bytes(params.salt)


def deserialize_schnorr_params(curve: TECurveSpec, data: bytes):
    from crypto_primitives_tpu_torch.models.signature.schnorr import SchnorrParameters

    r = Reader(data)
    generator = read_point_compressed(curve, r)
    salt = r.take(32)
    r.finish()
    return SchnorrParameters(generator=generator, salt=salt)


def serialize_schnorr_signature(curve: TECurveSpec, sig) -> bytes:
    scalar = curve.scalar
    return write_field(scalar, sig.prover_response) + write_field(
        scalar, sig.verifier_challenge
    )


def deserialize_schnorr_signature(curve: TECurveSpec, data: bytes):
    from crypto_primitives_tpu_torch.models.signature.schnorr import SchnorrSignature

    r = Reader(data)
    s = read_field(curve.scalar, r)
    e = read_field(curve.scalar, r)
    r.finish()
    return SchnorrSignature(prover_response=s, verifier_challenge=e)


def serialize_public_key(curve: TECurveSpec, pk) -> bytes:
    return write_point_compressed(curve, pk)


def deserialize_public_key(curve: TECurveSpec, data: bytes):
    r = Reader(data)
    pk = read_point_compressed(curve, r)
    r.finish()
    return pk


# -- ElGamal (encryption/elgamal/mod.rs) ----------------------------------------


def serialize_elgamal_ciphertext(curve: TECurveSpec, ct) -> bytes:
    c1, c2 = ct
    return write_point_compressed(curve, c1) + write_point_compressed(curve, c2)


def deserialize_elgamal_ciphertext(curve: TECurveSpec, data: bytes):
    r = Reader(data)
    c1 = read_point_compressed(curve, r)
    c2 = read_point_compressed(curve, r)
    r.finish()
    return (c1, c2)
