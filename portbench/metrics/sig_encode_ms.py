"""``sig_encode_ms``: host milliseconds a Schnorr verify job spends on the
Python around the challenge's digest: the hash input a row (the salt, r'
compressed, the message with its length; ``sig.serialize``) and the digest
into a scalar and its comparison with the signature's e
(``from_random_bytes``; ``sig.to_scalar``), from the program's spans inside
the ``sig.verify`` roots of the traced stretch, over the jobs.  None where
the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    return loader.module("metrics", "sig_pack_ms").stage_ms(run, ("sig.serialize", "sig.to_scalar"))
