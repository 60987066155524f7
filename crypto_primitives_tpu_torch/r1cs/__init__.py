"""R1CS constraint-synthesis layer.

Twin of ``crypto_primitives_tpu/r1cs``: a re-design of the reference's
`r1cs` feature (every primitive has a "constraint gadget twin" re-expressing
the computation over circuit variables).  The reference builds on external
`ark-relations`/`ark-r1cs-std`; we provide our own:

  * :mod:`cs` — the constraint system: variables are integer indices,
    linear combinations are sparse dicts, constraints are (A, B, C) rows;
    witness generation runs alongside synthesis (python ints, exact).
  * :mod:`vars` — `FpVar`, `Boolean`, `UInt8`, `UInt32` gadget variables
    (behavioral twins of ark-r1cs-std's types, with the same
    constraint-count-relevant decompositions: 1 constraint per nonlinear
    mul, booleanity per allocated bit, free linear ops and free
    constant-xor).
  * :mod:`device_check` — ``cs.is_satisfied()`` on the card: Az o Bz = Cz
    for the whole constraint matrix in Montgomery form, in torch;
  * :mod:`batch` — N instances synthesised as one trace, checked on the
    card (exactly in int64 for byte circuits, in Montgomery form for field
    circuits);
  * :mod:`snark` and :mod:`snark_gadget` — SNARK public-input packing
    across fields and the verify-a-SNARK-in-a-circuit protocol, with the
    ``MockLinSNARK`` test double;
  * :mod:`gadgets` — the gadget twin of every primitive.

Synthesis is host Python, the port's own copy of the JAX package's, so the
constraint and witness counts are the same.
"""

from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem, LinearCombination
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, FpVar, UInt8, UInt32
