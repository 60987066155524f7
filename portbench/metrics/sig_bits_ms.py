"""``sig_bits_ms``: host milliseconds a Schnorr verify job spends turning s
and e into bits (``ops.curve_fast.scalars_to_bits``: one bytes join a batch,
then ``np.unpackbits``), from the program's two ``curve.bits`` spans a job
inside the ``sig.verify`` roots of the traced stretch, over the jobs.  The
bits' upload lies outside the spans, in ``sig.bits``.  None where the
program keeps no such spans."""

from portbench.harness import loader


def read(run):
    return loader.module("metrics", "sig_pack_ms").stage_ms(run, ("curve.bits",))
