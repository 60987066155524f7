"""Well-known field instances (twin of ``crypto_primitives_tpu/ops/fields_known.py``).

The reference's test and bench fields: BLS12-381 Fr (the sponge test field),
JubJub's scalar field, BLS12-377 Fr (the base field of ed-on-bls12-377) and
its scalar field, plus the 381-bit BLS12-381 base field.
"""

from crypto_primitives_tpu_torch.ops.field import FieldSpec

BLS12_381_FR = FieldSpec(
    "bls12_381_fr",
    52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
)

JUBJUB_FR = FieldSpec(
    "jubjub_fr",
    6554484396890773809930967563523245729705921265872317281365359162392183254199,
    generator=6,
)

BLS12_377_FR = FieldSpec(
    "bls12_377_fr",
    8444461749428370424248824938781546531375899335154063827935233455917409239041,
    generator=22,
)

ED_ON_BLS12_377_FR = FieldSpec(
    "ed_on_bls12_377_fr",
    2111115437357092606062206234695386632838870926408408195193685246394721360383,
)

ALL_FIELDS = [BLS12_381_FR, JUBJUB_FR, BLS12_377_FR, ED_ON_BLS12_377_FR]

BLS12_381_FQ = FieldSpec(
    "bls12_381_fq",
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
)
