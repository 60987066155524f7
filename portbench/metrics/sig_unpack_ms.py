"""``sig_unpack_ms``: host milliseconds a Schnorr verify job spends turning
the affine r' words, read back, into Python ints and (x, y) tuples
(``ops.curve_fast.affine_host`` after the read), from the program's
``curve.host_ints`` spans inside the ``sig.verify`` roots of the traced
stretch, over the jobs.  None where the program keeps no such spans."""

from portbench.harness import loader


def read(run):
    return loader.module("metrics", "sig_pack_ms").stage_ms(run, ("curve.host_ints",))
