"""Known curve instances (twin of ``crypto_primitives_tpu/ops/curves_known.py``).

Twisted Edwards: JubJub (ed-on-bls12-381) and ed-on-bls12-377, the
reference's test and bench curves, and edwards25519 (RFC 8032).  All have
a = -1 (a square) and d a non-square, so the unified addition law is complete.
Short Weierstrass: BLS12-381 G1, Pallas and NIST P-256.

The generators of JubJub and ed-on-bls12-377 are the JAX package's
deterministic ones (smallest admissible x, even y, cofactor cleared), not the
reference's named constants; every scheme samples its own generators in
``setup`` anyway.

P-256's fields fill all 256 bits, so the port gives them a spare word
(W = 9, R = 2^288) where the JAX package gives them a spare digit (L = 17,
R = 2^272); ``interop`` converts between the two Montgomery forms.
"""

from __future__ import annotations

import functools

from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec
from crypto_primitives_tpu_torch.ops.field import FieldSpec
from crypto_primitives_tpu_torch.ops.fields_known import (
    BLS12_377_FR,
    BLS12_381_FQ,
    BLS12_381_FR,
    ED_ON_BLS12_377_FR,
    JUBJUB_FR,
)

_q381 = BLS12_381_FR.p

# JubJub: a = -1, d = -(10240/10241) mod q
JUBJUB = TECurveSpec(
    "jubjub",
    base=BLS12_381_FR,
    scalar=JUBJUB_FR,
    a=-1,
    d=(-10240 * pow(10241, -1, _q381)) % _q381,
    cofactor=8,
)

# ed-on-bls12-377: a = -1, d = 3021
ED_ON_BLS12_377 = TECurveSpec(
    "ed_on_bls12_377",
    base=BLS12_377_FR,
    scalar=ED_ON_BLS12_377_FR,
    a=-1,
    d=3021,
    cofactor=4,
)


@functools.cache
def deterministic_generator(curve: TECurveSpec):
    """Smallest-x admissible prime-order point (even y), cofactor cleared."""
    p = curve.base.p
    x = 1
    while True:
        denom = (1 - curve.d * x * x) % p
        if denom != 0:
            y2 = (1 - curve.a * x * x) * pow(denom, -1, p) % p
            y = curve.sqrt_host(y2)
            if y is not None:
                y = min(y, p - y)
                pt = curve.scalar_mul_host((x, y), curve.cofactor)
                if pt != (0, 1):
                    return pt
        x += 1


JUBJUB.generator = deterministic_generator(JUBJUB)
ED_ON_BLS12_377.generator = deterministic_generator(ED_ON_BLS12_377)

BLS12_381_G1 = SWCurveSpec(
    "bls12_381_g1",
    base=BLS12_381_FQ,
    scalar=BLS12_381_FR,
    a=0,
    b=4,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
    generator=(
        3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    ),
)

# Pallas (the "pasta" cycle half): y^2 = x^3 + 5, generator (-1, 2), prime order
PALLAS_FP = FieldSpec("pallas_fp", 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001)
PALLAS_FQ = FieldSpec("pallas_fq", 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001)

PALLAS = SWCurveSpec(
    "pallas",
    base=PALLAS_FP,
    scalar=PALLAS_FQ,
    a=0,
    b=5,
    cofactor=1,
    generator=(PALLAS_FP.p - 1, 2),
)

# edwards25519 (RFC 8032 section 5.1): -x^2 + y^2 = 1 + d x^2 y^2, d = -121665/121666
ED25519_FQ = FieldSpec("ed25519_fq", 2**255 - 19)
ED25519_FR = FieldSpec("ed25519_fr", 2**252 + 27742317777372353535851937790883648493)

ED25519 = TECurveSpec(
    "ed25519",
    base=ED25519_FQ,
    scalar=ED25519_FR,
    a=-1,
    d=(-121665 * pow(121666, -1, ED25519_FQ.p)) % ED25519_FQ.p,
    cofactor=8,
    generator=(
        15112221349535400772501151409588531511454012693041857206046113283949847762202,
        46316835694926478169428394003475163141307993866256225615783033603165251855960,
    ),
)

SECP256R1_FQ = FieldSpec("secp256r1_fq", 2**256 - 2**224 + 2**192 + 2**96 - 1)
SECP256R1_FR = FieldSpec("secp256r1_fr", 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551)

# NIST P-256 (SEC 2 section 2.4.2): y^2 = x^3 - 3x + b
SECP256R1 = SWCurveSpec(
    "secp256r1",
    base=SECP256R1_FQ,
    scalar=SECP256R1_FR,
    a=-3,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    cofactor=1,
    generator=(
        0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    ),
)

TE_CURVES = [JUBJUB, ED_ON_BLS12_377, ED25519]
SW_CURVES = [BLS12_381_G1, PALLAS, SECP256R1]

for _curve in TE_CURVES + SW_CURVES:
    if not _curve.is_on_curve(_curve.generator):
        raise AssertionError(f"{_curve.name}: generator is not on the curve")
