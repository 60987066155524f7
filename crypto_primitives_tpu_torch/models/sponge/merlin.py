"""Merlin transcript sponge adapter (STROBE-128 over Keccak-f[1600]).

Twin of ``crypto_primitives_tpu/models/sponge/merlin.py``, host Python as
there (the reference's src/sponge/merlin/mod.rs:6-33,
which implements `CryptographicSponge` for the external `merlin::Transcript`
(absorb -> append_message with empty label, squeeze -> challenge_bytes;
squeeze_bits uses MSB-first bit order per byte)).  Since this framework is
dependency-free, the transcript itself (merlin's Strobe-128 construction
over Keccak-f[1600]) is implemented here; the Keccak permutation is
oracle-tested against hashlib's SHA3.
"""

from __future__ import annotations

from typing import List

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _M64


def keccak_f1600(lanes: List[int]) -> List[int]:
    """24-round Keccak-f[1600]; lanes[x + 5*y], 64-bit ints."""
    a = [[lanes[x + 5 * y] for y in range(5)] for x in range(5)]
    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64)
        # iota
        a[0][0] ^= _RC[rnd]
    return [a[x][y] for y in range(5) for x in range(5)]


def _keccak_bytes(state: bytearray):
    lanes = [
        int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)
    ]
    out = keccak_f1600(lanes)
    for i, lane in enumerate(out):
        state[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")


STROBE_R = 166
FLAG_I, FLAG_A, FLAG_C, FLAG_T, FLAG_M, FLAG_K = 1, 2, 4, 8, 16, 32


class Strobe128:
    """merlin's mini Strobe-128 (strobe.rs semantics)."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        _keccak_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        _keccak_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            if self.cur_flags != flags:
                raise ValueError("a continued STROBE operation must keep its flags")
            return
        if flags & FLAG_T:
            raise ValueError("the STROBE T flag is not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


class Transcript:
    """merlin::Transcript twin."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(bytes(label), False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(bytes(message), False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(bytes(label), False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n, False)


class MerlinSponge:
    """`CryptographicSponge for Transcript` twin (merlin/mod.rs:6-33)."""

    def __init__(self, protocol_label: bytes):
        self.transcript = Transcript(protocol_label)

    def absorb(self, value, spec=None):
        """absorb -> append_message(b"", to_sponge_bytes(value))."""
        from crypto_primitives_tpu_torch.models.sponge.absorb import to_sponge_bytes

        if isinstance(value, (bytes, bytearray)):
            data = bytes(value)
        else:
            data = to_sponge_bytes(value, spec)
        self.transcript.append_message(b"", data)

    def squeeze_bytes(self, num_bytes: int) -> bytes:
        return self.transcript.challenge_bytes(b"", num_bytes)

    def squeeze_bits(self, num_bits: int) -> List[bool]:
        """MSB-first per byte (merlin/mod.rs:23-32)."""
        num_bytes = (num_bits + 7) // 8
        tmp = self.squeeze_bytes(num_bytes)
        bits = [bool((byte >> i) & 1) for byte in tmp for i in range(7, -1, -1)]
        return bits[:num_bits]
