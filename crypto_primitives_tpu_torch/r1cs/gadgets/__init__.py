"""Constraint-gadget twins of every primitive (the reference's
`constraints.rs` files).  Twin of ``crypto_primitives_tpu/r1cs/gadgets``:
SHA-256, Blake2s and Poseidon so far."""
