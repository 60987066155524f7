"""Plain Poseidon: the permutation over Python ints, and the same permutation
batched in float64 PyTorch for whole trees.

The permutation is the reference's round function (arkworks
crypto-primitives ``src/sponge/poseidon/mod.rs:98-121``): add the round's
constants, apply x^alpha to every element in the first and last R_F / 2
rounds and to the first element in the R_P rounds between, multiply by the
MDS matrix.  Values are canonical field elements; nothing is in Montgomery
form.

The batched form holds a field element as 18 digits of 16 bits in float64,
the digits not necessarily below 2^16 and the value not necessarily below p:
a redundant form, congruent mod p, turned into a canonical int only on the
host (:meth:`Field64.to_ints`).  Every product of two digits and every sum
of such products stays below 2^53, so float64 holds them exactly, and a
matrix product of such integers is exact whatever order the sum takes:

* a product of two elements (digits below 2^20) is the outer product of
  their digits summed into 35 columns by one matrix product (each column
  below 18 * 2^40 < 2^45);
* a column sum C is split into three 16-bit pieces, C = a + b 2^16 + c 2^32,
  and one matrix product folds every piece at position k >= 16 back by
  2^(16 k) mod p (16 digits below 2^16), giving 16 columns below
  105 * 2^32 < 2^39;
* those are split again and shifted into 18 digits below 2^17.1.

Each step is a few whole-tensor operations, so a tree level of 2^20 states
costs the same number of launches as one of 4096.
"""

from __future__ import annotations

import torch

DIGIT = 65536.0  # 2^16
LOW = 16  # digits below 2^256
NDIG = 18  # digits of the redundant form


def permute_int(p: int, alpha: int, full_rounds: int, partial_rounds: int, ark, mds, state) -> list:
    """The permutation of one state (a list of t ints)."""
    state = [int(s) % p for s in state]
    half = full_rounds // 2
    for r in range(full_rounds + partial_rounds):
        state = [(s + a) % p for s, a in zip(state, ark[r])]
        if r < half or r >= half + partial_rounds:
            state = [pow(s, alpha, p) for s in state]
        else:
            state[0] = pow(state[0], alpha, p)
        state = [sum(m * s for m, s in zip(row, state)) % p for row in mds]
    return state


def _digits(x: int, n: int) -> list:
    return [(x >> (16 * j)) & 0xFFFF for j in range(n)]


class Field64:
    """Arithmetic mod p on ``(..., 18)`` float64 digit tensors on one device."""

    def __init__(self, p: int, device):
        if p.bit_length() > 256:
            raise ValueError("the modulus must be below 2^256")
        self.p = p
        self.device = torch.device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        # outer product (18 x 18) -> 35 columns
        anti = torch.zeros(NDIG * NDIG, 2 * NDIG - 1, **f64)
        for i in range(NDIG):
            for j in range(NDIG):
                anti[i * NDIG + j, i + j] = 1.0
        self.anti = anti
        self._fold = {}
        # 16 columns split in 3 pieces -> 18 digits: piece (s, k) lands on k + s
        shift = torch.zeros(3 * LOW, NDIG, **f64)
        for s in range(3):
            for k in range(LOW):
                shift[s * LOW + k, k + s] = 1.0
        self.shift = shift

    def fold(self, k_cols: int) -> torch.Tensor:
        """(3 K, 16): the pieces of K column sums, each at its position,
        folded below 2^256 by 2^(16 j) mod p."""
        m = self._fold.get(k_cols)
        if m is None:
            rows = []
            for s in range(3):
                for k in range(k_cols):
                    rows.append(_digits(pow(2, 16 * (k + s), self.p), LOW))
            m = torch.tensor(rows, dtype=torch.float64, device=self.device)
            self._fold[k_cols] = m
        return m

    @staticmethod
    def _pieces(c: torch.Tensor) -> torch.Tensor:
        q1 = torch.floor_divide(c, DIGIT)
        a = torch.add(c, q1, alpha=-DIGIT)
        q2 = torch.floor_divide(q1, DIGIT)
        b = torch.add(q1, q2, alpha=-DIGIT)
        return torch.cat([a, b, q2], dim=-1)

    def reduce_columns(self, c: torch.Tensor) -> torch.Tensor:
        """Column sums ``(..., K)`` (each below 2^48) -> ``(..., 18)`` digits."""
        folded = self._pieces(c) @ self.fold(c.shape[-1])
        return self._pieces(folded) @ self.shift

    def mul(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = torch.broadcast_tensors(x, y)
        outer = (x.unsqueeze(-1) * y.unsqueeze(-2)).flatten(-2)
        return self.reduce_columns(outer @ self.anti)

    def pow(self, x: torch.Tensor, e: int) -> torch.Tensor:
        acc = x
        for bit in bin(e)[3:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, x)
        return acc

    def from_ints(self, values) -> torch.Tensor:
        rows = [_digits(int(v) % self.p, LOW) + [0, 0] for v in values]
        return torch.tensor(rows, dtype=torch.float64, device=self.device).reshape(len(rows), NDIG)

    def from_words(self, words: torch.Tensor) -> torch.Tensor:
        """``(..., 8)`` int32 words (little-endian 32-bit limbs of a value
        below 2^256) -> digits of that value."""
        v = words.to(torch.int64) & 0xFFFFFFFF
        d = torch.stack([v & 0xFFFF, v >> 16], dim=-1).flatten(-2).to(torch.float64)
        return torch.nn.functional.pad(d, (0, NDIG - d.shape[-1]))

    def to_ints(self, x: torch.Tensor) -> list:
        """Canonical ints of ``(B, 18)`` digits."""
        out = []
        for row in x.to(torch.int64).cpu().tolist():
            v = 0
            for j in reversed(range(NDIG)):
                v = (v << 16) + row[j]
            out.append(v % self.p)
        return out


class Poseidon64:
    """The batched permutation on ``(B, t, 18)`` digit tensors."""

    def __init__(self, field: Field64, alpha: int, full_rounds: int, partial_rounds: int, ark, mds):
        self.f = field
        self.alpha, self.full, self.partial = alpha, full_rounds, partial_rounds
        t = len(mds)
        self.t = t
        self.ark = torch.stack([field.from_ints(row) for row in ark])  # (rounds, t, 18)
        # the MDS product as one matrix product: input j's digit k times
        # digit m of mds[i][j] lands in output i's column k + m
        ncol = NDIG + LOW - 1
        toep = torch.zeros(t * NDIG, t * ncol, dtype=torch.float64)
        for i in range(t):
            for j in range(t):
                md = _digits(mds[i][j], LOW)
                for k in range(NDIG):
                    for m in range(LOW):
                        toep[j * NDIG + k, i * ncol + k + m] = md[m]
        self.toep = toep.to(field.device)
        self.ncol = ncol

    def __call__(self, state: torch.Tensor) -> torch.Tensor:
        f, t = self.f, self.t
        half = self.full // 2
        lead = state.shape[:-2]
        for r in range(self.full + self.partial):
            state = state + self.ark[r]
            if r < half or r >= half + self.partial:
                state = f.pow(state, self.alpha)
            else:
                state = torch.cat([f.pow(state[..., :1, :], self.alpha), state[..., 1:, :]], dim=-2)
            cols = (state.reshape(lead + (t * NDIG,)) @ self.toep).reshape(lead + (t, self.ncol))
            state = f.reduce_columns(cols)
        return state
