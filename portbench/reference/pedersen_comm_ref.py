"""Plain Pedersen commitment over a twisted-Edwards curve with a = -1:
Com(m; r) = sum over the message's set bits j of 2^(j mod window_size)
g_(j div window_size), plus sum over the opening's set bits j of 2^j h,
made affine (arkworks crypto-primitives ``src/commitment/pedersen/mod.rs:62-105``;
the message is zero-padded to the window, the opening's bits are
little-endian).

It takes the window bases g_w and the blinding base h alone, refuses one that
is off the curve or outside the subgroup of order r, and derives every
doubling power itself on the host.  Each row's selected message and opening
powers are summed by one pairwise tree over all their bit positions (message
first, then opening), with :class:`pedersen_ref.PedersenRef`'s unified
addition on float64 digits; one exact inversion a row on the host makes the
sum affine.  Commitments are canonical Montgomery words (x, y), as the
program returns them.
"""

from __future__ import annotations

import torch

from portbench.reference.pedersen_ref import NDIG, ROWS_X_BITS, PedersenRef, _values


class PedersenCommRef(PedersenRef):
    def check_blinding_base(self, h) -> None:
        """Raise ValueError unless h is on the curve and of an order
        dividing r."""
        h = (int(h[0]) % self.p, int(h[1]) % self.p)
        if not self.on_curve(h):
            raise ValueError("the blinding base is not on the curve")
        if self.mul(h, self.r) != (0, 1):
            raise ValueError("the blinding base is not in the subgroup of order r")

    def blinding_powers(self, h, nbits: int) -> list:
        """h, 2 h, 4 h, ..., 2^(nbits - 1) h."""
        out, pt = [], (int(h[0]), int(h[1]))
        for _ in range(nbits):
            out.append(pt)
            pt = self.add(pt, pt)
        return out

    def projective(self, bases, inputs) -> list:
        """bases (window bases, h); inputs (records (B, nbytes) uint8,
        opening bits (B, nbits) 0/1) -> every row's sum as (X, Y, Z) ints mod
        p, the bases checked first."""
        window_bases, h = bases
        records, opening = inputs
        nbits = 8 * records.shape[-1]
        if nbits > self.window_size * self.num_windows:
            raise ValueError(f"{records.shape[-1]} bytes do not fit the window")
        if records.shape[0] != opening.shape[0]:
            raise ValueError(f"{records.shape[0]} records for {opening.shape[0]} openings")
        self.check_bases(window_bases)
        self.check_blinding_base(h)
        pts = self.powers(window_bases, nbits) + self.blinding_powers(h, opening.shape[-1])
        table = self.f.from_ints([v for x, y in pts for v in (x, y, x * y, 1)]).reshape(len(pts), 4, NDIG)
        records = records.to(self.device, torch.uint8)
        opening = opening.to(self.device, torch.uint8)
        shifts = torch.arange(8, dtype=torch.uint8, device=self.device)
        out = []
        step = max(ROWS_X_BITS // len(pts), 1)
        for lo in range(0, records.shape[0], step):
            msg = ((records[lo:lo + step, :, None] >> shifts) & 1).flatten(1)  # little-endian within a byte
            bits = torch.cat([msg, opening[lo:lo + step]], dim=1)
            s = self.sums(table, bits)[:, [0, 1, 3]]
            v = _values(s.reshape(-1, NDIG))
            out += [tuple(x % self.p for x in v[i:i + 3]) for i in range(0, len(v), 3)]
        return out
