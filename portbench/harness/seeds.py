"""Seeds of the benchmark's inputs: one 63-bit seed for each (run seed,
stream, index), so a job's inputs can be made again after the window."""

from __future__ import annotations

import hashlib


def derive(seed: int, *parts) -> int:
    text = ":".join(str(x) for x in (seed, *parts)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1
