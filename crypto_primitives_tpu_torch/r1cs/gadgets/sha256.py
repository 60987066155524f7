"""In-circuit SHA-256 over UInt32 variables.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/sha256.py``, itself the twin of the reference's src/crh/sha256/constraints.rs
(message schedule + 64-round compression over UInt32 vars, incremental
`update`/`finalize` with a 64-byte pending buffer and bit-length padding,
`DigestVar` of 32 UInt8s, CRH gadget impls with a unit parameter).
"""

from __future__ import annotations

from typing import List

from crypto_primitives_tpu_torch.ops.sha256_kernel import H0 as _H0, K as _K
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, UInt8, UInt32


def _word_from_bytes_be(cs, b: List[UInt8]) -> UInt32:
    """Big-endian bytes -> UInt32 (free bit relabeling)."""
    bits = b[3].bits + b[2].bits + b[1].bits + b[0].bits
    return UInt32(cs, bits)


def _word_to_bytes_be(cs, w: UInt32) -> List[UInt8]:
    return [
        UInt8(cs, w.bits[24:32]),
        UInt8(cs, w.bits[16:24]),
        UInt8(cs, w.bits[8:16]),
        UInt8(cs, w.bits[0:8]),
    ]


class Sha256Gadget:
    """Incremental hasher (constraints.rs:143-205 shape)."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.state = [UInt32.constant(cs, int(h)) for h in _H0]
        self.pending: List[UInt8] = []
        self.length = 0  # bytes fed so far

    def _compress(self, block: List[UInt8]):
        cs = self.cs
        w = [_word_from_bytes_be(cs, block[4 * i : 4 * i + 4]) for i in range(16)]
        for i in range(16, 64):
            s0 = w[i - 15].rotr(7) ^ w[i - 15].rotr(18) ^ w[i - 15].shr(3)
            s1 = w[i - 2].rotr(17) ^ w[i - 2].rotr(19) ^ w[i - 2].shr(10)
            w.append(UInt32.addmany([w[i - 16], s0, w[i - 7], s1]))
        a, b, c, d, e, f, g, h = self.state
        for i in range(64):
            s1 = e.rotr(6) ^ e.rotr(11) ^ e.rotr(25)
            ch = (e & f) ^ (e.not_() & g)
            t1 = UInt32.addmany([h, s1, ch, UInt32.constant(cs, int(_K[i])), w[i]])
            s0 = a.rotr(2) ^ a.rotr(13) ^ a.rotr(22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = UInt32.addmany([s0, maj])
            h, g, f, e, d, c, b, a = g, f, e, UInt32.addmany([d, t1]), c, b, a, UInt32.addmany([t1, t2])
        self.state = [
            UInt32.addmany([x, y]) for x, y in zip(self.state, [a, b, c, d, e, f, g, h])
        ]

    def update(self, data: List[UInt8]):
        self.length += len(data)
        self.pending.extend(data)
        while len(self.pending) >= 64:
            block, self.pending = self.pending[:64], self.pending[64:]
            self._compress(block)

    def finalize(self) -> "DigestVar":
        cs = self.cs
        bitlen = 8 * self.length
        pad = [UInt8.constant(cs, 0x80)]
        plen = (56 - (self.length + 1)) % 64
        pad += [UInt8.constant(cs, 0)] * plen
        pad += [UInt8.constant(cs, b) for b in bitlen.to_bytes(8, "big")]
        self.update(pad)
        out: List[UInt8] = []
        for wrd in self.state:
            out.extend(_word_to_bytes_be(cs, wrd))
        return DigestVar(cs, out)


class DigestVar:
    """32-byte digest variable (constraints.rs:218-325)."""

    def __init__(self, cs: ConstraintSystem, bytes_: List[UInt8]):
        if len(bytes_) != 32:
            raise ValueError("a digest is 32 bytes")
        self.cs = cs
        self.bytes = bytes_

    @property
    def value(self):
        """bytes (scalar tier) or a (batch, 32) uint8 array (batched)."""
        vals = [b.value for b in self.bytes]
        if vals and not isinstance(vals[0], int):
            import numpy as np

            return np.stack([np.asarray(v, np.uint8) for v in vals], axis=1)
        return bytes(vals)

    def is_eq(self, other: "DigestVar") -> Boolean:
        acc = Boolean.constant(self.cs, True)
        for x, y in zip(self.bytes, other.bytes):
            for bx, by in zip(x.bits, y.bits):
                acc = acc & (bx ^ by).not_()
        return acc

    def enforce_equal(self, other: "DigestVar"):
        for x, y in zip(self.bytes, other.bytes):
            x.to_fp().enforce_equal(y.to_fp())

    @staticmethod
    def select(cond: Boolean, a: "DigestVar", b: "DigestVar") -> "DigestVar":
        return DigestVar(
            a.cs, [UInt8.select(cond, x, y) for x, y in zip(a.bytes, b.bytes)]
        )


class Sha256CRHGadget:
    """CRHScheme gadget (constraints.rs:327-352); unit parameter."""

    def evaluate(self, cs: ConstraintSystem, input_: List[UInt8]) -> DigestVar:
        h = Sha256Gadget(cs)
        h.update(input_)
        return h.finalize()


class Sha256TwoToOneCRHGadget:
    """TwoToOneCRHScheme gadget (constraints.rs:354-379)."""

    def evaluate(self, cs: ConstraintSystem, left: List[UInt8], right: List[UInt8]) -> DigestVar:
        h = Sha256Gadget(cs)
        h.update(left)
        h.update(right)
        return h.finalize()

    def compress(self, cs: ConstraintSystem, left: DigestVar, right: DigestVar) -> DigestVar:
        return self.evaluate(cs, left.bytes, right.bytes)
