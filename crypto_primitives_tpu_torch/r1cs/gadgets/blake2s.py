"""In-circuit BLAKE2s (RFC 7693) and the Blake2s PRF / commitment gadgets.

Twin of ``crypto_primitives_tpu/r1cs/gadgets/blake2s.py``, itself the twin of the reference's src/prf/blake2s/constraints.rs:
G mixing function with rotation constants (16,12,8,7) (:25-28, 79-98),
SIGMA schedule (:45-56), 10-round `blake2s_compression` (:147-202),
multi-block `evaluate_blake2s[_with_parameters]` (:230-289), `OutputVar`
(32 UInt8s) and the `PRFGadget` impl (:367-391).  The reference pins
21792 constraints for one 512-bit block (:416) — reproduced by this
decomposition.
"""

from __future__ import annotations

from typing import List

from crypto_primitives_tpu_torch.ops.blake2s import _IV, _SIGMA
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.vars import Boolean, UInt8, UInt32


def _g(cs, v: List[UInt32], a: int, b: int, c: int, d: int, x: UInt32, y: UInt32):
    """Mixing function (constraints.rs:79-98): rotations 16, 12, 8, 7."""
    v[a] = UInt32.addmany([v[a], v[b], x])
    v[d] = (v[d] ^ v[a]).rotr(16)
    v[c] = UInt32.addmany([v[c], v[d]])
    v[b] = (v[b] ^ v[c]).rotr(12)
    v[a] = UInt32.addmany([v[a], v[b], y])
    v[d] = (v[d] ^ v[a]).rotr(8)
    v[c] = UInt32.addmany([v[c], v[d]])
    v[b] = (v[b] ^ v[c]).rotr(7)


def blake2s_compression(cs: ConstraintSystem, h: List[UInt32], m: List[UInt32],
                        t: int, last: bool):
    """constraints.rs:147-202; t is the static byte counter."""
    v = list(h) + [UInt32.constant(cs, int(iv)) for iv in _IV]
    v[12] = v[12] ^ UInt32.constant(cs, t & 0xFFFFFFFF)
    v[13] = v[13] ^ UInt32.constant(cs, (t >> 32) & 0xFFFFFFFF)
    if last:
        v[14] = v[14] ^ UInt32.constant(cs, 0xFFFFFFFF)
    for r in range(10):
        s = _SIGMA[r]
        _g(cs, v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(cs, v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(cs, v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(cs, v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(cs, v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(cs, v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(cs, v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(cs, v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    for i in range(8):
        h[i] = h[i] ^ v[i] ^ v[i + 8]


def evaluate_blake2s(cs: ConstraintSystem, input_bits: List[Boolean]) -> List[UInt32]:
    """constraints.rs:230-245: unkeyed, digest 32, no salt/personalization."""
    if len(input_bits) % 8:
        raise ValueError("Blake2s takes whole bytes")
    # parameter word 0: digest_len=32 | fanout=1<<16 | depth=1<<24
    parameters = [32 | (1 << 16) | (1 << 24)] + [0] * 7
    return evaluate_blake2s_with_parameters(cs, input_bits, parameters)


def evaluate_blake2s_with_parameters(cs: ConstraintSystem, input_bits: List[Boolean],
                                     parameters: List[int]) -> List[UInt32]:
    """constraints.rs:247-289: multi-block with per-block byte counters."""
    h = [UInt32.constant(cs, int(_IV[i]) ^ parameters[i]) for i in range(8)]
    nbytes = len(input_bits) // 8
    # LE words from the bit stream
    words: List[UInt32] = []
    for i in range(0, len(input_bits), 32):
        chunk = input_bits[i : i + 32]
        chunk = chunk + [Boolean.constant(cs, False)] * (32 - len(chunk))
        words.append(UInt32(cs, chunk))
    nblocks = max(1, -(-nbytes // 64))
    for blk in range(nblocks):
        m = words[16 * blk : 16 * blk + 16]
        m = m + [UInt32.constant(cs, 0)] * (16 - len(m))
        last = blk == nblocks - 1
        t = min((blk + 1) * 64, nbytes)
        blake2s_compression(cs, h, m, t, last)
    return h


class OutputVar:
    """32 UInt8s (constraints.rs:301-365)."""

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

    @classmethod
    def from_words(cls, cs, words: List[UInt32]) -> "OutputVar":
        out: List[UInt8] = []
        for w in words:
            for k in range(4):
                out.append(UInt8(cs, w.bits[8 * k : 8 * k + 8]))
        return cls(cs, out)


class Blake2sPRFGadget:
    """PRFGadget twin (src/prf/constraints.rs:9-20 + blake2s impl :367-391)."""

    @staticmethod
    def new_seed(cs: ConstraintSystem, seed) -> List[UInt8]:
        """``seed``: bytes, or a (batch, 32) uint8 array (batched tier)."""
        from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

        return bytes_to_uint8s(cs, seed, "witness")

    @staticmethod
    def evaluate(cs: ConstraintSystem, seed: List[UInt8], input_: List[UInt8]) -> OutputVar:
        bits: List[Boolean] = []
        for b in seed + input_:
            bits.extend(b.bits)
        words = evaluate_blake2s(cs, bits)
        return OutputVar.from_words(cs, words)


class Blake2sCommitmentGadget:
    """commitment/blake2s/constraints.rs twin: Com(m;r) over input||randomness."""

    @staticmethod
    def commit(cs: ConstraintSystem, input_: List[UInt8], randomness: List[UInt8]) -> OutputVar:
        bits: List[Boolean] = []
        for b in list(input_) + list(randomness):
            bits.extend(b.bits)
        words = evaluate_blake2s(cs, bits)
        return OutputVar.from_words(cs, words)
