"""``sig_digest_ms``: host milliseconds a Schnorr verify job spends hashing
the challenges' inputs, one digest a row (Blake2s-256 in the cell), from the
program's ``sig.digest`` spans inside the ``sig.verify`` roots of the traced
stretch, over the jobs.  None where the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    return loader.module("metrics", "sig_pack_ms").stage_ms(run, ("sig.digest",))
