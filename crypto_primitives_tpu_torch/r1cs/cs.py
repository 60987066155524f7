"""Rank-1 constraint system.

Twin of ``crypto_primitives_tpu/r1cs/cs.py``, itself the twin of the reference's external `ark-relations` `ConstraintSystemRef`
(used by every constraints.rs).  Variables are integer
indices into one assignment vector z = [1, instance..., witness...];
each constraint is <A_i, z> * <B_i, z> = <C_i, z>.

Witnesses are computed eagerly during synthesis with exact python ints —
synthesis is a one-time, host-side operation; satisfaction checking is
where the device helps (see device_check.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from crypto_primitives_tpu_torch.ops.field import FieldSpec

ONE = 0  # variable index of the constant 1


class LinearCombination:
    """Sparse LC: {var_index: coeff mod p}."""

    __slots__ = ("terms",)

    def __init__(self, terms: Optional[Dict[int, int]] = None):
        self.terms = terms or {}

    @classmethod
    def constant(cls, c: int, p: int) -> "LinearCombination":
        c %= p
        return cls({ONE: c} if c else {})

    @classmethod
    def single(cls, var: int) -> "LinearCombination":
        return cls({var: 1})

    def add(self, other: "LinearCombination", p: int) -> "LinearCombination":
        t = dict(self.terms)
        for v, c in other.terms.items():
            nc = (t.get(v, 0) + c) % p
            if nc:
                t[v] = nc
            elif v in t:
                del t[v]
        return LinearCombination(t)

    def scale(self, c: int, p: int) -> "LinearCombination":
        c %= p
        if c == 0:
            return LinearCombination()
        return LinearCombination({v: (k * c) % p for v, k in self.terms.items()})

    def is_constant(self) -> bool:
        return all(v == ONE for v in self.terms)

    def constant_value(self) -> int:
        return self.terms.get(ONE, 0)


class ConstraintSystem:
    def __init__(self, field: FieldSpec):
        self.field = field
        self.assignments: List[int] = [1]  # z[0] == 1
        self.num_instance = 0
        self.num_witness = 0
        self._instance_vars: List[int] = []
        self.a_rows: List[LinearCombination] = []
        self.b_rows: List[LinearCombination] = []
        self.c_rows: List[LinearCombination] = []

    # -- allocation --

    def new_input(self, value) -> int:
        idx = len(self.assignments)
        self.assignments.append(self.v_norm(value))
        self.num_instance += 1
        self._instance_vars.append(idx)
        return idx

    def new_witness(self, value) -> int:
        idx = len(self.assignments)
        self.assignments.append(self.v_norm(value))
        self.num_witness += 1
        return idx

    # -- value arithmetic hooks -------------------------------------------
    #
    # Every arithmetic step FpVar/Boolean perform on *assignment values*
    # routes through these, so the SAME gadget code synthesizes either a
    # scalar circuit (values = python ints, this class) or N instances at
    # once (values = batched Montgomery word tensors,
    # r1cs/batch.BatchConstraintSystem): synthesis as a vectorized trace.  Constants
    # remain python ints in BOTH modes (they are instance-independent), so
    # hooks must accept mixed int/array operands in batch mode.

    def v_norm(self, v):
        return v % self.field.p

    def v_add(self, a, b):
        return (a + b) % self.field.p

    def v_scale(self, a, c: int):
        return (a * c) % self.field.p

    def v_mul(self, a, b):
        return (a * b) % self.field.p

    def v_mul_many(self, a, b):
        """Element-wise products of two lists of values."""
        return [self.v_mul(x, y) for x, y in zip(a, b)]

    def v_affine(self, vals, rows, consts):
        """[sum_j rows[r][j] * vals[j] + consts[r] for every row r]: the
        values of a linear layer (a sponge's MDS matrix and round constants)
        in one step, where the gadget builds its linear combinations."""
        p = self.field.p
        return [(sum(c * v for c, v in zip(row, vals)) + k) % p for row, k in zip(rows, consts)]

    def v_inv0(self, a):
        """Inverse, or 0 for a == 0 (the is_eq witness convention)."""
        a %= self.field.p
        return pow(a, -1, self.field.p) if a else 0

    def v_is_zero(self, a):
        return a % self.field.p == 0

    def v_bits(self, a, nbits: int):
        if a >= (1 << nbits):
            raise ValueError("value does not fit requested bits")
        return [bool((a >> i) & 1) for i in range(nbits)]

    def v_bool(self, b):
        return bool(b)

    def v_from_bool(self, b):
        """Boolean value -> field assignment value (0/1)."""
        return int(bool(b))

    def v_not(self, b):
        return not b

    def v_and(self, a, b):
        return bool(a) and bool(b)

    def v_xor(self, a, b):
        return bool(a) ^ bool(b)

    # word-level hooks (UInt8/UInt32 byte circuits; BatchConstraintSystem
    # extends these to arrays so SHA-256/Blake2s synthesize as one
    # vectorized trace)

    def v_word_bits(self, value, n: int):
        """LE bit values of an n-bit word (UIntN allocation)."""
        return [bool((int(value) >> i) & 1) for i in range(n)]

    def v_pack_word(self, bit_vals):
        """Bit values -> standard-domain word value."""
        return sum(int(bool(b)) << i for i, b in enumerate(bit_vals))

    def v_word_to_field(self, word):
        """Standard-domain word value -> field assignment value."""
        return int(word) % self.field.p

    def v_select(self, c, a, b):
        """Value-level ``c ? a : b`` over boolean condition values."""
        return a if c else b

    # -- constraints --

    def enforce(self, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        self.a_rows.append(a)
        self.b_rows.append(b)
        self.c_rows.append(c)

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    # -- evaluation --

    def eval_lc(self, lc: LinearCombination) -> int:
        p = self.field.p
        return sum(c * self.assignments[v] for v, c in lc.terms.items()) % p

    def is_satisfied(self) -> bool:
        """Exact host check; see device_check.check_satisfied_device for the
        batched on-device version."""
        return self.which_unsatisfied() is None

    def which_unsatisfied(self) -> Optional[int]:
        p = self.field.p
        for i in range(self.num_constraints):
            a = self.eval_lc(self.a_rows[i])
            b = self.eval_lc(self.b_rows[i])
            c = self.eval_lc(self.c_rows[i])
            if (a * b - c) % p != 0:
                return i
        return None

    def to_coo(self):
        """Flatten (A, B, C) into COO triples for the device checker:
        returns dict with rows/cols/coeffs per matrix plus the assignment."""
        import itertools

        import numpy as np

        out = {}
        for name, rows in (("a", self.a_rows), ("b", self.b_rows), ("c", self.c_rows)):
            lens = np.fromiter((len(lc.terms) for lc in rows), np.int64, len(rows))
            nnz = int(lens.sum())
            out[name] = (
                np.repeat(np.arange(len(rows), dtype=np.int32), lens),
                np.fromiter(itertools.chain.from_iterable(lc.terms for lc in rows), np.int32, nnz),
                list(itertools.chain.from_iterable(lc.terms.values() for lc in rows)),
            )
        return out
