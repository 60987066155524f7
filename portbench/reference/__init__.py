"""The plain reference that decides ``correct``: SHA-256 from ``hashlib``,
Poseidon from its parameters (its own Grain LFSR, plain Python ints and plain
float64 PyTorch), and a Merkle tree over either.  Nothing here imports the
program under test."""
