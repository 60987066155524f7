"""Poseidon sponge + CRH gadgets.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/poseidon.py``, itself the twin of the reference's src/sponge/poseidon/constraints.rs
(`PoseidonSpongeVar`: line-for-line R1CS mirror of the native duplex sponge,
S-box via pow_by_constant, MDS as free linear combinations) and
src/crh/poseidon/constraints.rs (CRH gadgets with the constant-folding path
at :44-52: when every input is constant, evaluate natively and emit a
constant var).
"""

from __future__ import annotations

from typing import List

from crypto_primitives_tpu_torch.models.sponge.poseidon import PoseidonConfig, PoseidonSponge
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem, LinearCombination
from crypto_primitives_tpu_torch.r1cs.vars import FpVar


class PoseidonSpongeVar:
    """Duplex sponge over FpVars; same mode bookkeeping as the native sponge
    (constraints.rs:19-31, 183-291)."""

    def __init__(self, cs: ConstraintSystem, config: PoseidonConfig):
        if config.field is not cs.field:
            raise ValueError("the sponge's field must be the constraint system's")
        self.cs = cs
        self.config = config
        self.state: List[FpVar] = [FpVar.constant(cs, 0) for _ in range(config.t)]
        self.mode = "absorbing"
        self.index = 0

    def _permute(self):
        cs, cfg = self.cs, self.config
        p = cs.field.p
        rf2 = cfg.full_rounds // 2
        n_rounds = cfg.full_rounds + cfg.partial_rounds
        # ark: constant addition (free)
        state = [s.add_constant(a) for s, a in zip(self.state, cfg.ark[0])]
        for i in range(n_rounds):
            if i < rf2 or i >= rf2 + cfg.partial_rounds:
                state = FpVar.pow_by_constant_many(state, cfg.alpha)
            else:
                state[0] = state[0].pow_by_constant(cfg.alpha)
            # MDS, then the next round's constants: linear combinations (free),
            # built as the scale / add / add_constant steps build them, their
            # values in one v_affine step
            last = i + 1 == n_rounds
            ark = [0] * cfg.t if last else cfg.ark[i + 1]
            vals = cs.v_affine([s.value for s in state], cfg.mds, ark)
            const = all(s.const for s in state)
            new = []
            for row, k, v in zip(cfg.mds, ark, vals):
                lc = state[0].lc.scale(row[0], p)
                for j in range(1, cfg.t):
                    lc = lc.add(state[j].lc.scale(row[j], p), p)
                if not last:
                    lc = lc.add(LinearCombination.constant(k, p), p)
                new.append(FpVar(cs, lc, v, const))
            state = new
        self.state = state

    def _absorb_internal(self, rate_start: int, elems: List[FpVar]):
        cfg = self.config
        pos = 0
        while True:
            remaining = len(elems) - pos
            if rate_start + remaining <= cfg.rate:
                for i in range(remaining):
                    k = cfg.capacity + rate_start + i
                    self.state[k] = self.state[k] + elems[pos + i]
                self.mode, self.index = "absorbing", rate_start + remaining
                return
            n = cfg.rate - rate_start
            for i in range(n):
                k = cfg.capacity + rate_start + i
                self.state[k] = self.state[k] + elems[pos + i]
            self._permute()
            pos += n
            rate_start = 0

    def absorb(self, elems: List[FpVar]):
        if not elems:
            return
        if self.mode == "absorbing":
            idx = self.index
            if idx == self.config.rate:
                self._permute()
                idx = 0
            self._absorb_internal(idx, elems)
        else:
            self._absorb_internal(0, elems)

    def _squeeze_internal(self, rate_start: int, n: int) -> List[FpVar]:
        cfg = self.config
        out: List[FpVar] = []
        remaining = n
        while True:
            if rate_start + remaining <= cfg.rate:
                out.extend(
                    self.state[cfg.capacity + rate_start : cfg.capacity + rate_start + remaining]
                )
                self.mode, self.index = "squeezing", rate_start + remaining
                return out
            k = cfg.rate - rate_start
            out.extend(self.state[cfg.capacity + rate_start : cfg.capacity + cfg.rate])
            remaining -= k
            if remaining > 0:
                self._permute()
            rate_start = 0

    def squeeze_field_elements(self, n: int) -> List[FpVar]:
        if self.mode == "absorbing":
            self._permute()
            return self._squeeze_internal(0, n)
        idx = self.index
        if idx == self.config.rate:
            self._permute()
            idx = 0
        return self._squeeze_internal(idx, n)

    def squeeze_bits(self, num_bits: int):
        """constraints/mod.rs squeeze_bits twin: usable bits per element =
        MODULUS_BIT_SIZE - 1, LE order."""
        spec = self.cs.field
        usable = spec.nbits - 1
        n = -(-num_bits // usable)
        elems = self.squeeze_field_elements(n)
        bits = []
        for e in elems:
            bits.extend(e.to_bits_le(spec.nbits)[:usable])
        return bits[:num_bits]

    def squeeze_bytes(self, num_bytes: int):
        """constraints/mod.rs squeeze_bytes twin: usable bytes per element =
        (MODULUS_BIT_SIZE - 1) / 8."""
        from crypto_primitives_tpu_torch.r1cs.vars import UInt8

        spec = self.cs.field
        usable = (spec.nbits - 1) // 8
        n = -(-num_bytes // usable)
        elems = self.squeeze_field_elements(n)
        out = []
        for e in elems:
            bits = e.to_bits_le(spec.nbits)[: usable * 8]
            for i in range(usable):
                out.append(UInt8(self.cs, bits[8 * i : 8 * i + 8]))
        return out[:num_bytes]

    def squeeze_emulated_field_elements(self, target_spec, n: int):
        """Emulated-field squeeze (constraints/mod.rs:27-97
        bits_le_to_emulated): squeeze bits, recompose into limb LCs with one
        linear constraint per limb.  Returns EmulatedFpVar list."""
        from crypto_primitives_tpu_torch.r1cs.cs import LinearCombination
        from crypto_primitives_tpu_torch.r1cs.snark import EmulatedFpVar

        cs = self.cs
        p = cs.field.p
        usable = target_spec.nbits - 1
        # one squeeze of all bits, then split per element — matching the
        # native cross-field default impl (src/sponge/mod.rs:57-96)
        all_bits = self.squeeze_bits(usable * n)
        out = []
        for k in range(n):
            bits = all_bits[k * usable : (k + 1) * usable]
            limbs = []
            lb = EmulatedFpVar.LIMB_BITS
            for i in range(0, usable, lb):
                chunk = bits[i : i + lb]
                acc = LinearCombination()
                val = 0
                for j, b in enumerate(chunk):
                    acc = acc.add(b.fp.lc.scale(1 << j, p), p)
                    val |= int(b.value) << j
                limb = FpVar.new_witness(cs, val)
                cs.enforce(acc, LinearCombination.constant(1, p), limb.lc)
                limbs.append(limb)
            out.append(EmulatedFpVar(cs, target_spec, limbs))
        return out


class PoseidonCRHGadget:
    """crh/poseidon/constraints.rs CRHGadget twin."""

    def __init__(self, config: PoseidonConfig):
        self.config = config

    def evaluate(self, cs: ConstraintSystem, input_: List[FpVar]) -> FpVar:
        if all(v.const for v in input_):
            # constant-folding path (constraints.rs:44-52)
            from crypto_primitives_tpu_torch.models.crh.poseidon import PoseidonCRH

            native = PoseidonCRH(self.config.field).evaluate(
                self.config, [v.value for v in input_]
            )
            return FpVar.constant(cs, native)
        sponge = PoseidonSpongeVar(cs, self.config)
        sponge.absorb(input_)
        return sponge.squeeze_field_elements(1)[0]


class PoseidonTwoToOneCRHGadget:
    """crh/poseidon/constraints.rs TwoToOneCRHGadget twin."""

    def __init__(self, config: PoseidonConfig):
        self.config = config

    def evaluate(self, cs: ConstraintSystem, left: FpVar, right: FpVar) -> FpVar:
        return self.compress(cs, left, right)

    def compress(self, cs: ConstraintSystem, left: FpVar, right: FpVar) -> FpVar:
        if left.const and right.const:
            from crypto_primitives_tpu_torch.models.crh.poseidon import PoseidonTwoToOneCRH

            native = PoseidonTwoToOneCRH(self.config.field).compress(
                self.config, left.value, right.value
            )
            return FpVar.constant(cs, native)
        sponge = PoseidonSpongeVar(cs, self.config)
        sponge.absorb([left])
        sponge.absorb([right])
        return sponge.squeeze_field_elements(1)[0]
