"""Plain Pedersen CRH over a twisted-Edwards curve with a = -1: the sum over
the input's set bits j of 2^(j mod window_size) g_(j div window_size),
made affine (arkworks crypto-primitives ``src/crh/pedersen/mod.rs:76-129``;
inputs shorter than the window are zero-padded, so their missing bits add
nothing).

It takes the window bases g_w alone, refuses one that is off the curve or
outside the subgroup of order r, and derives the doubling powers itself on
the host.  On the device every row's selected powers, the identity in place
of a clear bit, are summed by a pairwise tree over the bit positions, in
extended coordinates with the unified a = -1 addition (add-2008-hwcd-3,
k = 2d), on :class:`poseidon_ref.Field64` digits.  One exact inversion a row
on the host makes the sum affine.  Digests are canonical Montgomery words
(value times 2^(32 W) mod p), as the program returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.poseidon_ref import NDIG, Field64

PAD = 1 << 18  # above every digit a product leaves (below 2^17.1)
ROWS_X_BITS = 1 << 20  # rows times bit positions summed at once


class PedersenRef:
    def __init__(self, p: int, d: int, r: int, window_size: int, num_windows: int, num_words: int, device,
                 field=Field64):
        self.p, self.d, self.r = p, d % p, r
        self.window_size, self.num_windows, self.W = window_size, num_windows, num_words
        self.f = field(p, device)
        self.device = self.f.device
        # x - y as x + (PAD - y) + c, every digit of c and of PAD - y >= 0, c = -(PAD in every digit) mod p
        self._c = self.f.from_ints([-sum(PAD << (16 * j) for j in range(NDIG))])[0]
        self._pad = torch.full_like(self._c, PAD)
        self._k = self.f.from_ints([2 * self.d])[0]
        self._ident = self.f.from_ints([0, 1, 0, 1])  # (X : Y : T : Z)

    # -- the host: the bases and their powers, Python ints, affine --

    def on_curve(self, pt) -> bool:
        x, y = pt
        p = self.p
        return (-x * x + y * y - 1 - self.d * x * x % p * y * y) % p == 0

    def add(self, a, b):
        (x1, y1), (x2, y2) = a, b
        p = self.p
        t = self.d * x1 * x2 % p * y1 * y2 % p
        return ((x1 * y2 + y1 * x2) * pow(1 + t, -1, p) % p, (y1 * y2 + x1 * x2) * pow(1 - t, -1, p) % p)

    def mul(self, pt, k: int):
        acc = (0, 1)
        for bit in bin(k)[2:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, pt)
        return acc

    def check_bases(self, bases) -> None:
        """Raise ValueError unless there is one base a window, each on the
        curve and of an order dividing r."""
        if len(bases) != self.num_windows:
            raise ValueError(f"{len(bases)} bases for {self.num_windows} windows")
        for w, g in enumerate(bases):
            g = (int(g[0]) % self.p, int(g[1]) % self.p)
            if not self.on_curve(g):
                raise ValueError(f"base {w} is not on the curve")
            if self.mul(g, self.r) != (0, 1):
                raise ValueError(f"base {w} is not in the subgroup of order r")

    def powers(self, bases, nbits: int) -> list:
        """2^(j mod window_size) g_(j div window_size) for the first nbits
        bit positions."""
        out = []
        for g in bases:
            pt = (int(g[0]), int(g[1]))
            for _ in range(self.window_size):
                out.append(pt)
                pt = self.add(pt, pt)
        return out[:nbits]

    # -- the device: the sums --

    def _sub(self, x, y):
        return x + (self._pad - y) + self._c

    def _add_points(self, a, b):
        """add-2008-hwcd-3 over (..., 4, 18) digit points: A = (Y1-X1)(Y2-X2),
        B = (Y1+X1)(Y2+X2), C = 2d T1 T2, D = 2 Z1 Z2, E = B-A, F = D-C,
        G = D+C, H = B+A; (E F, G H, E H, F G)."""
        f = self.f
        X1, Y1, T1, Z1 = a.unbind(-2)
        X2, Y2, T2, Z2 = b.unbind(-2)
        A, B, TT, ZZ = f.mul(torch.stack([self._sub(Y1, X1), Y1 + X1, T1, Z1], dim=-2),
                             torch.stack([self._sub(Y2, X2), Y2 + X2, T2, Z2], dim=-2)).unbind(-2)
        C, D = f.mul(TT, self._k), ZZ + ZZ
        E, F, G, H = self._sub(B, A), self._sub(D, C), D + C, B + A
        return f.mul(torch.stack([E, G, E, F], dim=-2), torch.stack([F, H, H, G], dim=-2))

    def sums(self, table: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
        """bits (B, n) of 0/1, table (n, 4, 18) of the powers -> (B, 4, 18)
        extended sums."""
        pts = torch.where(bits.bool()[..., None, None], table, self._ident)
        while pts.shape[1] > 1:
            if pts.shape[1] % 2:
                pts = torch.cat([pts, self._ident.expand(pts.shape[0], 1, 4, NDIG)], dim=1)
            pts = self._add_points(pts[:, 0::2], pts[:, 1::2])
        return pts[:, 0]

    def projective(self, bases, inputs: torch.Tensor) -> list:
        """inputs (B, nbytes) uint8 -> every row's sum as (X, Y, Z) ints mod
        p, the bases checked first."""
        nbits = 8 * inputs.shape[-1]
        if nbits > self.window_size * self.num_windows:
            raise ValueError(f"{inputs.shape[-1]} bytes do not fit the window")
        self.check_bases(bases)
        table = self.f.from_ints([v for x, y in self.powers(bases, nbits) for v in (x, y, x * y, 1)])
        table = table.reshape(nbits, 4, NDIG)
        inputs = inputs.to(self.device, torch.uint8)
        shifts = torch.arange(8, dtype=torch.uint8, device=self.device)
        out = []
        step = max(ROWS_X_BITS // max(nbits, 1), 1)
        for lo in range(0, inputs.shape[0], step):
            bits = ((inputs[lo:lo + step, :, None] >> shifts) & 1).flatten(1)  # little-endian within a byte
            s = self.sums(table, bits)[:, [0, 1, 3]]
            v = _values(s.reshape(-1, NDIG))
            out += [tuple(x % self.p for x in v[i:i + 3]) for i in range(0, len(v), 3)]
        return out

    def words(self, values) -> np.ndarray:
        """Ints mod p -> their canonical Montgomery words, (len, W) int32."""
        R, p = 1 << (32 * self.W), self.p
        raw = b"".join((v * R % p).to_bytes(4 * self.W, "little") for v in values)
        return np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(np.int32).reshape(len(values), self.W)

    def digests(self, bases, inputs: torch.Tensor) -> np.ndarray:
        """inputs (B, nbytes) uint8 -> (B, 2, W) affine digests (x, y)."""
        flat = []
        for X, Y, Z in self.projective(bases, inputs):
            zi = pow(Z, -1, self.p)
            flat += [X * zi % self.p, Y * zi % self.p]
        return self.words(flat).reshape(-1, 2, self.W)


def _values(x: torch.Tensor) -> list:
    """(N, 18) digits (each below 2^21) -> the N values as ints, unreduced."""
    d = x.to(torch.int64).cpu()
    out = torch.empty(d.shape[0], NDIG + 2, dtype=torch.int64)
    carry = torch.zeros(d.shape[0], dtype=torch.int64)
    for j in range(NDIG):
        v = d[:, j] + carry
        out[:, j], carry = v & 0xFFFF, v >> 16
    out[:, NDIG], out[:, NDIG + 1] = carry & 0xFFFF, carry >> 16
    raw = out.numpy().astype("<u2").tobytes()
    n = 2 * (NDIG + 2)
    return [int.from_bytes(raw[i:i + n], "little") for i in range(0, len(raw), n)]
