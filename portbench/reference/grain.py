"""Poseidon's round constants and MDS matrix from the Grain LFSR.

The derivation of the Poseidon paper (ePrint 2019/458, appendix F) as
arkworks' crypto-primitives runs it (``src/sponge/poseidon/grain_lfsr.rs``
and ``traits.rs:105-146``): an 80-bit state seeded with the field type, the
S-box kind, the field's bit size, t, R_F and R_P; 160 warm-up clocks; bits
emitted in pairs, the second kept only where the first is 1.  Round
constants are drawn by rejection (values >= p are drawn again); the MDS is
the Cauchy matrix 1 / (x_i + y_j) over 2t further elements taken mod p.
"""

from __future__ import annotations


class GrainLFSR:
    def __init__(self, nbits: int, t: int, full_rounds: int, partial_rounds: int):
        bits = [0, 1, 0, 0, 0, 0]  # prime field; S-box x^alpha (not an inverse)
        for value, width in ((nbits, 12), (t, 12), (full_rounds, 10), (partial_rounds, 10)):
            bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
        self.state = bits + [1] * 30
        self.nbits = nbits
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.append(new)
        del s[0]
        return new

    def _bits(self, n: int) -> list:
        out = []
        while len(out) < n:
            first, second = self._clock(), self._clock()
            if first:
                out.append(second)
        return out

    def _value(self) -> int:
        # the first bit drawn is the most significant
        v = 0
        for b in self._bits(self.nbits):
            v = (v << 1) | b
        return v

    def rejection(self, p: int, count: int) -> list:
        out = []
        while len(out) < count:
            v = self._value()
            if v < p:
                out.append(v)
        return out

    def mod_p(self, p: int, count: int) -> list:
        return [self._value() % p for _ in range(count)]


def ark_and_mds(p: int, t: int, full_rounds: int, partial_rounds: int, skip_matrices: int):
    """(ark [rounds][t], mds [t][t]) as canonical ints."""
    lfsr = GrainLFSR(p.bit_length(), t, full_rounds, partial_rounds)
    ark = [lfsr.rejection(p, t) for _ in range(full_rounds + partial_rounds)]
    for _ in range(skip_matrices):
        lfsr.mod_p(p, 2 * t)
    xs, ys = lfsr.mod_p(p, t), lfsr.mod_p(p, t)
    mds = [[pow((x + y) % p, -1, p) for y in ys] for x in xs]
    return ark, mds
