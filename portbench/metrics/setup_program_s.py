"""``setup_program_s``: the program's own share of ``setup_s``, from its
set-up counters: seconds in ``nvcc`` builds and in loading the kernels'
libraries (``native/build.py``), and in deriving the Poseidon parameters and
making and uploading K1's schedule image (``models/sponge/poseidon.py``).
0.0 where nothing was built or derived; None where the program has no such
counters."""


def read(run):
    from crypto_primitives_tpu_torch.models.sponge import poseidon
    from crypto_primitives_tpu_torch.native import build

    parts = [getattr(build, "build_seconds", None), getattr(build, "load_seconds", None),
             getattr(poseidon, "derive_seconds", None), getattr(poseidon, "schedule_seconds", None)]
    return None if None in parts else sum(parts)
