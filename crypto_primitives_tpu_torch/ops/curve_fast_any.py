"""Curve-model dispatch for the grouped MSM tier.

Twin of ``crypto_primitives_tpu/ops/curve_rns_any.py``.  The primitives
(Pedersen CRH and commitment) are generic over the curve model, as the
reference is generic over ark-ec's ``CurveGroup``.  :func:`fast_mod` returns
the module for the curve: ``curve_fast`` (twisted Edwards, kernel
``msm_te``) or ``curve_sw_fast`` (short Weierstrass, kernel ``msm_sw``).
Both expose ``pack_table_grouped``, ``conditional_sum_grouped_auto``,
``device_table``, ``add`` and ``to_affine``.
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
