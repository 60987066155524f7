"""The port's Merlin transcript, canonical codecs, serialize helpers and
profiling against the JAX package's (bytes equal, round trips through both
packages), on the CPU."""

import glob
import hashlib
import json
import random

import pytest
import torch

from crypto_primitives_tpu.errors import SerializationError as JaxSerializationError
from crypto_primitives_tpu.models.commitment.pedersen import PedersenCommitment as JaxPedersenCommitment
from crypto_primitives_tpu.models.crh.pedersen import PedersenCRH as JaxPedersenCRH
from crypto_primitives_tpu.models.crh.pedersen import Window as JaxWindow
from crypto_primitives_tpu.models.merkle_tree import MultiPath as JaxMultiPath
from crypto_primitives_tpu.models.merkle_tree import Path as JaxPath
from crypto_primitives_tpu.models.signature.schnorr import SchnorrParameters as JaxSchnorrParameters
from crypto_primitives_tpu.models.signature.schnorr import SchnorrSignature as JaxSchnorrSignature
from crypto_primitives_tpu.models.sponge import Felt as JaxFelt
from crypto_primitives_tpu.models.sponge import get_default_poseidon_parameters as jax_poseidon_parameters
from crypto_primitives_tpu.models.sponge.merlin import MerlinSponge as JaxMerlinSponge
from crypto_primitives_tpu.models.sponge.merlin import Transcript as JaxTranscript
from crypto_primitives_tpu.ops import curves_known as jax_curves
from crypto_primitives_tpu.ops.fields_known import BLS12_381_FR as JAX_FR
from crypto_primitives_tpu.utils import canonical as jc
from crypto_primitives_tpu.utils import serialize as jser
from crypto_primitives_tpu_torch.errors import SerializationError
from crypto_primitives_tpu_torch.models.commitment.pedersen import PedersenCommitmentParameters
from crypto_primitives_tpu_torch.models.crh.pedersen import PedersenParameters
from crypto_primitives_tpu_torch.models.merkle_tree import MultiPath, Path
from crypto_primitives_tpu_torch.models.signature.schnorr import SchnorrParameters, SchnorrSignature
from crypto_primitives_tpu_torch.models.sponge import Felt, get_default_poseidon_parameters
from crypto_primitives_tpu_torch.models.sponge.merlin import MerlinSponge, Strobe128, Transcript, keccak_f1600
from crypto_primitives_tpu_torch.ops import curves_known as curves
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
from crypto_primitives_tpu_torch.r1cs import ConstraintSystem, FpVar
from crypto_primitives_tpu_torch.utils import canonical as c
from crypto_primitives_tpu_torch.utils import profiling, serialize

torch.set_num_threads(1)

TE_CURVES = ["JUBJUB", "ED_ON_BLS12_377"]
SW_CURVES = ["BLS12_381_G1", "PALLAS"]


# ---- Merlin ------------------------------------------------------------------


def _sha3_256(data: bytes) -> bytes:
    """SHA3-256 on the port's keccak_f1600."""
    rate, st = 136, bytearray(200)
    padded = bytearray(data) + b"\x06"
    padded += bytes(-len(padded) % rate)
    padded[-1] ^= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            st[i] ^= padded[off + i]
        lanes = keccak_f1600([int.from_bytes(st[8 * i: 8 * i + 8], "little") for i in range(25)])
        for i, lane in enumerate(lanes):
            st[8 * i: 8 * i + 8] = lane.to_bytes(8, "little")
    return bytes(st[:32])


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 300])
def test_keccak_matches_hashlib_sha3(n):
    data = bytes(random.Random(n).randrange(256) for _ in range(n))
    assert _sha3_256(data) == hashlib.sha3_256(data).digest()


def test_merlin_crate_pinned_vector():
    """The merlin crate's `equivalence_simple` transcript vector."""
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32) == bytes.fromhex(
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_merlin_transcript_matches_jax():
    rng = random.Random(3)
    ours, theirs = Transcript(b"proto"), JaxTranscript(b"proto")
    for step in range(12):
        label = bytes(rng.randrange(256) for _ in range(step % 5))
        msg = bytes(rng.randrange(256) for _ in range(rng.choice([0, 1, 100, 165, 166, 167, 400])))
        ours.append_message(label, msg)
        theirs.append_message(label, msg)
        n = rng.choice([1, 32, 64, 200])
        assert ours.challenge_bytes(label, n) == theirs.challenge_bytes(label, n)
    assert ours.strobe.state == theirs.strobe.state


def test_merlin_sponge_matches_jax():
    ours, theirs = MerlinSponge(b"sponge"), JaxMerlinSponge(b"sponge")
    ours.absorb(b"raw bytes")
    theirs.absorb(b"raw bytes")
    ours.absorb([Felt(5), Felt(FR.p - 1)], FR)
    theirs.absorb([JaxFelt(5), JaxFelt(JAX_FR.p - 1)], JAX_FR)
    assert ours.squeeze_bytes(13) == theirs.squeeze_bytes(13)
    assert ours.squeeze_bits(104) == theirs.squeeze_bits(104)
    assert ours.squeeze_bits(7) == theirs.squeeze_bits(7)


def test_strobe_rejects_changed_flags_on_a_continued_operation():
    s = Strobe128(b"x")
    s.ad(b"a", False)
    with pytest.raises(ValueError):
        s.meta_ad(b"b", True)


# ---- canonical codecs ----------------------------------------------------------


def _pair(name):
    return getattr(curves, name), getattr(jax_curves, name)


def _cross(write_ours, write_theirs, read_ours, read_theirs, value, jvalue=None):
    """Bytes equal; each package reads the other's bytes back to the value."""
    jvalue = value if jvalue is None else jvalue
    data = write_ours(value)
    assert data == write_theirs(jvalue)
    r = c.Reader(data)
    back = read_ours(r)
    r.finish()
    jr = jc.Reader(data)
    jback = read_theirs(jr)
    jr.finish()
    return back, jback


def test_scalars_fields_and_vectors():
    rng = random.Random(5)
    for v in (0, 1, 2 ** 64 - 1, rng.randrange(2 ** 64)):
        back, jback = _cross(c.write_u64, jc.write_u64, c.read_u64, jc.read_u64, v)
        assert back == jback == v
    for v in (0, 1, FR.p - 1, rng.randrange(FR.p)):
        back, jback = _cross(lambda x: c.write_field(FR, x), lambda x: jc.write_field(JAX_FR, x),
                             lambda r: c.read_field(FR, r), lambda r: jc.read_field(JAX_FR, r), v)
        assert back == jback == v
    items = [rng.randrange(FR.p) for _ in range(4)]
    back, jback = _cross(lambda x: c.write_vec(x, lambda v: c.write_field(FR, v)),
                         lambda x: jc.write_vec(x, lambda v: jc.write_field(JAX_FR, v)),
                         lambda r: c.read_vec(r, lambda rr: c.read_field(FR, rr)),
                         lambda r: jc.read_vec(r, lambda rr: jc.read_field(JAX_FR, rr)), items)
    assert back == jback == items
    back, jback = _cross(c.write_bytes_vec, jc.write_bytes_vec, c.read_bytes_vec, jc.read_bytes_vec, b"\x00ab")
    assert back == jback == b"\x00ab"
    assert c.write_u64(5) == b"\x05" + bytes(7) and c.write_vec([], c.write_u64) == bytes(8)
    with pytest.raises(SerializationError):
        c.read_field(FR, c.Reader(FR.p.to_bytes(FR.bigint_bytes, "little")))
    with pytest.raises(SerializationError):
        c.Reader(b"ab").take(3)
    with pytest.raises(SerializationError):
        r = c.Reader(b"ab")
        r.take(1)
        r.finish()


@pytest.mark.parametrize("name", TE_CURVES + SW_CURVES)
def test_point_codecs_match_jax(name):
    curve, jcurve = _pair(name)
    rng = random.Random(6)
    pts = [curve.rand_point(rng) for _ in range(4)] + [None if name in SW_CURVES else (0, 1)]
    for pt in pts:
        for w, jw, rd, jrd in (
            (c.write_point_compressed, jc.write_point_compressed, c.read_point_compressed, jc.read_point_compressed),
            (c.write_point_uncompressed, jc.write_point_uncompressed, c.read_point_uncompressed,
             jc.read_point_uncompressed),
        ):
            back, jback = _cross(lambda p: w(curve, p), lambda p: jw(jcurve, p), lambda r: rd(curve, r),
                                 lambda r: jrd(jcurve, r), pt)
            assert back == jback == pt
    # corrupted encodings: both packages reject the same ones, or read the same point
    rejected = 0
    for i in range(16):
        bad = bytearray(c.write_point_compressed(curve, pts[0]))
        bad[i] ^= 1 << (i % 8)
        try:
            got = c.read_point_compressed(curve, c.Reader(bytes(bad)))
        except SerializationError:
            rejected += 1
            with pytest.raises(JaxSerializationError):
                jc.read_point_compressed(jcurve, jc.Reader(bytes(bad)))
        else:
            assert got == jc.read_point_compressed(jcurve, jc.Reader(bytes(bad)))
    assert rejected


def test_serialize_helpers_match_jax():
    from crypto_primitives_tpu.ops.fields_known import BLS12_381_FR as jfr

    curve, jcurve = _pair("JUBJUB")
    pt = curve.rand_point(random.Random(7))
    v = random.Random(8).randrange(FR.p)
    assert serialize.uncompressed_bytes_of_field(FR, v) == jser.uncompressed_bytes_of_field(jfr, v)
    assert serialize.uncompressed_bytes_of_te_point(curve, pt) == jser.uncompressed_bytes_of_te_point(jcurve, pt)
    for value, spec, jspec in ((b"abc", None, None), (v, FR, jfr), (pt, curve, jcurve), ([v, 3], FR, jfr),
                               ([pt, pt], curve, jcurve)):
        assert serialize.to_uncompressed_bytes(value, spec) == jser.to_uncompressed_bytes(value, jspec)
    with pytest.raises(TypeError):
        serialize.to_uncompressed_bytes(3.5)
    with pytest.raises(TypeError):
        serialize.to_uncompressed_bytes(5, curve)


def test_poseidon_config_codec_matches_jax():
    cfg, jcfg = get_default_poseidon_parameters(FR, 2, False), jax_poseidon_parameters(JAX_FR, 2, False)
    data = c.serialize_poseidon_config(cfg)
    assert data == jc.serialize_poseidon_config(jcfg)
    back, jback = c.deserialize_poseidon_config(FR, data), jc.deserialize_poseidon_config(JAX_FR, data)
    for obj in (back, jback):
        assert (obj.full_rounds, obj.partial_rounds, obj.alpha, obj.rate, obj.capacity, obj.ark, obj.mds) == (
            cfg.full_rounds, cfg.partial_rounds, cfg.alpha, cfg.rate, cfg.capacity, cfg.ark, cfg.mds)
    with pytest.raises(SerializationError):
        c.deserialize_poseidon_config(FR, data + b"\x00")


@pytest.mark.parametrize("digests", ["field", "bytes"])
def test_path_and_multipath_codecs_match_jax(digests):
    rng = random.Random(9)
    if digests == "field":
        codec, jcodec = c.field_digest_codec(FR), jc.field_digest_codec(JAX_FR)
        digest = lambda: rng.randrange(FR.p)  # noqa: E731
    else:
        codec, jcodec = c.byte_digest_codec(), jc.byte_digest_codec()
        digest = lambda: bytes(rng.randrange(256) for _ in range(32))  # noqa: E731
    fields = dict(leaf_sibling_hash=digest(), auth_path=[digest() for _ in range(3)], leaf_index=5)
    data = c.serialize_path(Path(**fields), codec, codec)
    assert data == jc.serialize_path(JaxPath(**fields), jcodec, jcodec)
    for obj in (c.deserialize_path(data, codec, codec), jc.deserialize_path(data, jcodec, jcodec)):
        assert (obj.leaf_sibling_hash, obj.auth_path, obj.leaf_index) == tuple(fields.values())
    mfields = dict(leaf_siblings_hashes=[digest() for _ in range(3)], auth_paths_prefix_lenghts=[0, 2, 1],
                   auth_paths_suffixes=[[digest(), digest()], [], [digest()]], leaf_indexes=[1, 4, 6])
    data = c.serialize_multipath(MultiPath(**mfields), codec, codec)
    assert data == jc.serialize_multipath(JaxMultiPath(**mfields), jcodec, jcodec)
    for obj in (c.deserialize_multipath(data, codec, codec), jc.deserialize_multipath(data, jcodec, jcodec)):
        assert [obj.leaf_siblings_hashes, obj.auth_paths_prefix_lenghts, obj.auth_paths_suffixes,
                obj.leaf_indexes] == list(mfields.values())


@pytest.mark.parametrize("name", ["JUBJUB", "BLS12_381_G1"])
@pytest.mark.parametrize("compressed", [True, False])
def test_pedersen_parameter_codecs_match_jax(name, compressed):
    curve, jcurve = _pair(name)
    jparams = JaxPedersenCRH(jcurve, JaxWindow(window_size=3, num_windows=2)).setup(random.Random(10))
    params = PedersenParameters(curve, jparams.generators)
    data = c.serialize_pedersen_crh_params(params, compressed)
    assert data == jc.serialize_pedersen_crh_params(jparams, compressed)
    assert c.deserialize_pedersen_crh_params(curve, data, compressed).generators == jparams.generators
    assert jc.deserialize_pedersen_crh_params(jcurve, data, compressed).generators == params.generators
    jcp = JaxPedersenCommitment(jcurve, JaxWindow(window_size=3, num_windows=2)).setup(random.Random(11))
    cp = PedersenCommitmentParameters(curve, jcp.randomness_generator, jcp.generators)
    data = c.serialize_pedersen_commitment_params(cp, compressed)
    assert data == jc.serialize_pedersen_commitment_params(jcp, compressed)
    back = c.deserialize_pedersen_commitment_params(curve, data, compressed)
    assert (back.randomness_generator, back.generators) == (jcp.randomness_generator, jcp.generators)


@pytest.mark.parametrize("name", ["JUBJUB", "ED_ON_BLS12_377"])
def test_schnorr_and_elgamal_codecs_match_jax(name):
    curve, jcurve = _pair(name)
    rng = random.Random(12)
    gen, pk, c1, c2 = (curve.rand_point(rng) for _ in range(4))
    salt = bytes(rng.randrange(256) for _ in range(32))
    s, e = rng.randrange(curve.scalar.p), rng.randrange(curve.scalar.p)
    data = c.serialize_schnorr_params(curve, SchnorrParameters(gen, salt))
    assert data == jc.serialize_schnorr_params(jcurve, JaxSchnorrParameters(gen, salt))
    for obj in (c.deserialize_schnorr_params(curve, data), jc.deserialize_schnorr_params(jcurve, data)):
        assert (obj.generator, obj.salt) == (gen, salt)
    data = c.serialize_schnorr_signature(curve, SchnorrSignature(s, e))
    assert data == jc.serialize_schnorr_signature(jcurve, JaxSchnorrSignature(s, e))
    for obj in (c.deserialize_schnorr_signature(curve, data), jc.deserialize_schnorr_signature(jcurve, data)):
        assert (obj.prover_response, obj.verifier_challenge) == (s, e)
    data = c.serialize_public_key(curve, pk)
    assert data == jc.serialize_public_key(jcurve, pk)
    assert c.deserialize_public_key(curve, data) == jc.deserialize_public_key(jcurve, data) == pk
    data = c.serialize_elgamal_ciphertext(curve, (c1, c2))
    assert data == jc.serialize_elgamal_ciphertext(jcurve, (c1, c2))
    assert c.deserialize_elgamal_ciphertext(curve, data) == jc.deserialize_elgamal_ciphertext(jcurve, data) == (c1, c2)
    with pytest.raises(SerializationError):
        c.deserialize_public_key(curve, data)  # trailing bytes


# ---- profiling -------------------------------------------------------------------


def test_capture_writes_a_trace_with_the_span(tmp_path):
    d = str(tmp_path / "profiles")
    x = torch.arange(1024, dtype=torch.float32)
    with profiling.capture(d) as path:
        with profiling.annotate("square_sum"):
            (x * x).sum()
    assert glob.glob(f"{d}/*.json") == [path]
    names = [ev.get("name") for ev in json.load(open(path))["traceEvents"]]
    assert "square_sum" in names


def test_constraint_report():
    cs = ConstraintSystem(FR)
    _ = FpVar.new_witness(cs, 3) * FpVar.new_witness(cs, 5)
    FpVar.new_input(cs, 15)
    assert profiling.constraint_report(cs) == {
        "num_constraints": 1, "num_witness_variables": 3, "num_instance_variables": 1,
    }
