"""Plain Schnorr verification over a twisted-Edwards curve with a = -1
(arkworks crypto-primitives ``src/signature/schnorr/mod.rs:117-148``):
r' = s G + e pk, and the signature (s, e) is accepted iff
e == from_random_bytes(D(salt || ser(r') || ser(msg))).

It takes the generator, the 32-byte salt, the keys, the messages and the
signatures as Python ints and bytes, refuses a generator or a key that is off
the curve and a generator outside the subgroup of order r, and computes s G
and e pk by its own method: G's doubling powers 2^j G on the host; each key's
doublings 2^j pk on the device, batched over the rows; then, for each row,
the powers that s's and e's set bits select (the identity in place of a clear
bit) summed by one pairwise tree over all 2 x nbits positions, in extended
coordinates with :class:`pedersen_ref.PedersenRef`'s unified a = -1 addition
on :class:`poseidon_ref.Field64` digits.  One exact inversion a row on the
host makes r' affine.  ser(r') is y in 32 little-endian bytes with the top
bit of the last byte set iff x > p - x (``TEFlags::XIsNegative``); a
message is its u64 little-endian length and its bytes (ark-serialize of a
byte slice); the digest's bytes are read little-endian and masked to the
scalar field's MODULUS_BIT_SIZE bits, and a value >= r is no challenge
(``from_random_bytes``), which rejects the signature.

Departures from ``mod.rs:117-148``:
  * many signatures a call, computed in blocks of rows that fit the card;
  * s and e come as integers below r, where mod.rs holds them as scalar
    field elements (the same values);
  * the keys are checked to lie on the curve, which mod.rs leaves to the
    deserialization of a key;
  * the doubling powers and the one tree stand in for ark-ec's ``mul`` and
    the projective addition, and r' is made affine by an exact inversion;
  * ``projective=True`` (the benchmark's control) hashes r' with X and Y
    left undivided by Z, a deliberate fault.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.pedersen_ref import NDIG, ROWS_X_BITS, PedersenRef, _values
from portbench.reference.poseidon_ref import Field64


class SchnorrRef(PedersenRef):
    def __init__(self, p: int, d: int, r: int, nbits: int, num_words: int, digest, device, field=Field64):
        super().__init__(p, d, r, nbits, 1, num_words, device, field=field)
        self.nbits, self.digest = nbits, digest
        self.ybytes = -(-p.bit_length() // 8)

    # -- the host --

    def check_generator(self, g) -> None:
        g = (int(g[0]) % self.p, int(g[1]) % self.p)
        if not self.on_curve(g):
            raise ValueError("the generator is not on the curve")
        if self.mul(g, self.r) != (0, 1):
            raise ValueError("the generator is not in the subgroup of order r")

    def check_keys(self, pks) -> None:
        for i, pk in enumerate(pks):
            if not self.on_curve((int(pk[0]) % self.p, int(pk[1]) % self.p)):
                raise ValueError(f"key {i} is not on the curve")

    def serialize(self, pt) -> bytes:
        x, y = pt
        data = bytearray(int(y).to_bytes(self.ybytes, "little"))
        if x > self.p - x:
            data[-1] |= 0x80
        return bytes(data)

    def challenge(self, salt: bytes, pt, message: bytes):
        """The challenge that r' = pt and the message give, or None."""
        h = self.digest(bytes(salt) + self.serialize(pt) + len(message).to_bytes(8, "little") + bytes(message))
        v = int.from_bytes(h, "little") & ((1 << self.r.bit_length()) - 1)
        return v if v < self.r else None

    # -- the device --

    def _points(self, pts) -> torch.Tensor:
        """Affine host points -> (n, 4, 18) extended digits (x, y, x y, 1)."""
        vals = [v for x, y in pts for v in (x % self.p, y % self.p, x * y % self.p, 1)]
        raw = b"".join(v.to_bytes(32, "little") for v in vals)
        d = torch.from_numpy(np.frombuffer(raw, dtype="<u2").astype(np.float64)).reshape(len(vals), 16)
        d = torch.nn.functional.pad(d, (0, NDIG - 16)).to(self.device, self._ident.dtype)  # the field's digits
        return d.reshape(len(pts), 4, NDIG)

    def _bits(self, scalars) -> torch.Tensor:
        nbytes = -(-self.nbits // 8)
        raw = b"".join((int(v) % self.r).to_bytes(nbytes, "little") for v in scalars)
        by = np.frombuffer(raw, np.uint8).reshape(len(scalars), nbytes)
        return torch.from_numpy(np.unpackbits(by, axis=1, bitorder="little")[:, :self.nbits].copy())

    def doublings(self, pts: torch.Tensor) -> torch.Tensor:
        """(B, 4, 18) points -> (B, nbits, 4, 18): 2^j of each, j < nbits."""
        out = [pts]
        for _ in range(self.nbits - 1):
            out.append(self._add_points(out[-1], out[-1]))
        return torch.stack(out, dim=1)

    def projective(self, generator, pks, sigs) -> list:
        """Every row's r' = s G + e pk as (X, Y, Z) ints mod p; the
        generator and the keys checked first."""
        if len(pks) != len(sigs):
            raise ValueError(f"{len(pks)} keys for {len(sigs)} signatures")
        self.check_generator(generator)
        self.check_keys(pks)
        g = (int(generator[0]), int(generator[1]))
        powers = []
        for _ in range(self.nbits):
            powers.append(g)
            g = self.add(g, g)
        g_table = self._points(powers)  # (nbits, 4, 18)
        out = []
        step = max(ROWS_X_BITS // (2 * self.nbits), 1)
        for lo in range(0, len(sigs), step):
            rows = sigs[lo:lo + step]
            pk_table = self.doublings(self._points(pks[lo:lo + step]))  # (B, nbits, 4, 18)
            table = torch.cat([g_table.expand(len(rows), -1, -1, -1), pk_table], dim=1)
            bits = torch.cat([self._bits([s for s, _ in rows]), self._bits([e for _, e in rows])], dim=1)
            s = self.sums(table, bits.to(self.device))[:, [0, 1, 3]]
            v = _values(s.reshape(-1, NDIG))
            out += [tuple(x % self.p for x in v[i:i + 3]) for i in range(0, len(v), 3)]
        return out

    def verify(self, generator, salt: bytes, pks, messages, sigs, projective: bool = False) -> np.ndarray:
        """(B,) bool verdicts of the signatures (s, e) on (pk, message)."""
        if len(messages) != len(sigs):
            raise ValueError(f"{len(messages)} messages for {len(sigs)} signatures")
        out = np.zeros(len(sigs), dtype=bool)
        for i, (X, Y, Z) in enumerate(self.projective(generator, pks, sigs)):
            if projective:
                pt = (X, Y)
            else:
                zi = pow(Z, -1, self.p)
                pt = (X * zi % self.p, Y * zi % self.p)
            out[i] = self.challenge(salt, pt, messages[i]) == sigs[i][1]
        return out
