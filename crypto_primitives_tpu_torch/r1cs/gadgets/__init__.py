"""Constraint-gadget twins of every primitive (the reference's
`constraints.rs` files).  Twin of ``crypto_primitives_tpu/r1cs/gadgets``:
the hashes (SHA-256, Blake2s, Poseidon), the Merkle paths (field, byte and
point digests), the curve variables, the absorb encodings, the Pedersen and
Bowe-Hopwood CRHs with their commitment and compressor gadgets, Schnorr
public-key randomisation and ElGamal encryption."""
