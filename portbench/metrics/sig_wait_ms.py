"""``sig_wait_ms``: host milliseconds a Schnorr verify job waits on the card
to read the affine r' words back (``ops.curve_fast.affine_host``'s
``.cpu()``): the kernels still queued then (A3, K4, A2, A1 and the
conversion out of Montgomery form) and the copy, the device's time as the
host sees it.  From the program's ``curve.to_host`` spans inside the
``sig.verify`` roots of the traced stretch, over the jobs.  None where the
program keeps no such spans."""

from portbench.harness import loader


def read(run):
    return loader.module("metrics", "sig_pack_ms").stage_ms(run, ("curve.to_host",))
