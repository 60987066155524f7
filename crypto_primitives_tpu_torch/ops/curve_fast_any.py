"""Curve-model dispatch for the fast curve tier.

Twin of ``crypto_primitives_tpu/ops/curve_rns_any.py``.  The primitives
(Pedersen CRH and commitment, Schnorr, ElGamal) are generic over the curve
model, as the reference is generic over ark-ec's ``CurveGroup``.
:func:`fast_mod` returns the module for the curve: ``curve_fast`` (twisted
Edwards, kernel ``msm_te``) or ``curve_sw_fast`` (short Weierstrass, kernel
``msm_sw``).  Both expose ``pack_combos``, ``pack_table_grouped``,
``conditional_sum_grouped_auto``, ``device_table``, ``msm_many``,
``fixed_base_grouped_table``, ``fixed_base_mul``,
``scalar_mul_bits_windowed``, ``scalars_to_bits``, ``pack_points``,
``pack_points_device``, ``unpack_affine``, ``add``, ``neg``, ``sum`` and
``to_affine``.  Every known curve has a module here (the JAX package's
``rns_mod`` is not None for any of them); another curve model raises.
"""

from crypto_primitives_tpu_torch.ops import curve_fast, curve_sw_fast
from crypto_primitives_tpu_torch.ops.curve import TECurveSpec
from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec


def fast_mod(curve):
    if isinstance(curve, TECurveSpec):
        return curve_fast
    if isinstance(curve, SWCurveSpec):
        return curve_sw_fast
    raise TypeError(f"no grouped MSM tier for {curve!r}")
