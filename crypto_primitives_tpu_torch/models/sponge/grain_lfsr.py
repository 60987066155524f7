"""Grain-LFSR parameter generator for Poseidon (host-side, runs once).

Twin of crypto_primitives_tpu/models/sponge/grain_lfsr.py, itself a
behavioural twin of the reference's 80-bit Grain stream
(arkworks crypto-primitives, src/sponge/poseidon/grain_lfsr.rs:16-181):
the seed packs field-type/sbox/n/t/R_F/R_P into bits b0..b79 MSB-first per
field, 160 warm-up clocks, and the output stream is "gated": a sample bit is
emitted only after a 1-bit is observed (discarding one bit per 0 seen).

Parameter generation is setup-time-only, so this stays pure Python — the
consumers receive the resulting constant tables.
"""

from __future__ import annotations


class PoseidonGrainLFSR:
    def __init__(
        self,
        is_sbox_an_inverse: bool,
        prime_num_bits: int,
        state_len: int,
        num_full_rounds: int,
        num_partial_rounds: int,
    ):
        self.prime_num_bits = prime_num_bits
        state = [False] * 80

        # b0, b1: field descriptor (prime field = 0b01)
        state[1] = True
        # b2..b5: s-box descriptor
        state[5] = bool(is_sbox_an_inverse)

        def fill(lo: int, hi: int, value: int):
            cur = value
            for i in range(hi, lo - 1, -1):
                state[i] = (cur & 1) == 1
                cur >>= 1

        fill(6, 17, prime_num_bits)  # n
        fill(18, 29, state_len)  # t
        fill(30, 39, num_full_rounds)  # R_F
        fill(40, 49, num_partial_rounds)  # R_P
        for i in range(50, 80):
            state[i] = True

        self.state = state
        self.head = 0
        for _ in range(160):  # warm-up
            self._update()

    def _update(self) -> bool:
        s, h = self.state, self.head
        new_bit = (
            s[(h + 62) % 80]
            ^ s[(h + 51) % 80]
            ^ s[(h + 38) % 80]
            ^ s[(h + 23) % 80]
            ^ s[(h + 13) % 80]
            ^ s[h]
        )
        s[h] = new_bit
        self.head = (h + 1) % 80
        return new_bit

    def get_bits(self, num_bits: int) -> list[bool]:
        """Gated sampling: emit the bit after the first 1-bit seen."""
        res = []
        for _ in range(num_bits):
            new_bit = self._update()
            while not new_bit:
                self._update()  # discard the second bit
                new_bit = self._update()
            res.append(self._update())
        return res

    def _draw_msb_first(self) -> list[bool]:
        bits = self.get_bits(self.prime_num_bits)
        bits.reverse()  # first-drawn bit becomes the MSB
        return bits

    def get_field_elements_rejection_sampling(self, p: int, num_elems: int) -> list[int]:
        assert p.bit_length() == self.prime_num_bits
        res = []
        for _ in range(num_elems):
            while True:
                bits = self._draw_msb_first()
                value = sum(1 << i for i, b in enumerate(bits) if b)
                if value < p:  # from_bigint fails (None) when >= p
                    res.append(value)
                    break
        return res

    def get_field_elements_mod_p(self, p: int, num_elems: int) -> list[int]:
        assert p.bit_length() == self.prime_num_bits
        res = []
        for _ in range(num_elems):
            bits = self._draw_msb_first()
            # pack bit-chunks of 8 into bytes (bit i of a chunk -> 1 << i),
            # then interpret the byte string little-endian mod p
            value = 0
            nbytes = (len(bits) + 7) // 8
            for j in range(nbytes):
                byte = 0
                for i, b in enumerate(bits[8 * j : 8 * j + 8]):
                    byte |= int(b) << i
                value |= byte << (8 * j)
            res.append(value % p)
        return res
