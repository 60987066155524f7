"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface (no PyTorch
headers), and loaded with ctypes.  Libraries go into ``native/build/`` (listed
in ``.gitignore``) under a name that carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags,
so an edited source is rebuilt and an unchanged one is built once per
checkout.  Nothing builds at import time: the first :func:`load` builds.
A failed build raises with ``nvcc``'s output; there is no fallback.

Set-up counters of this process: ``build_seconds`` (wall seconds inside
:func:`build`, ``nvcc`` included) and ``load_seconds`` (seconds spent
loading and binding built libraries).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32

# C entry points of each library: every pointer and the stream are c_void_p,
# or ctypes would pass them as 32-bit ints.  Each returns a cudaError_t.
SIGNATURES = {
    "poseidon_permute": {
        # in, out, image, image_words, batch, nwords, t, alpha,
        # full_rounds, partial_rounds, n_sparse, group, device, stream
        "poseidon_permute": [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # nwords, t, device, blocks (int*)
        "poseidon_permute_blocks_per_sm": [_I, _I, _I, _P],
    },
    "sha256_compress": {
        # words, out, batch, nblocks, device, stream
        "sha256_compress": [_P, _P, _LL, _I, _I, _P],
        # msgs, out, batch, n, host_pad_kw, device, stream
        "sha256_digest": [_P, _P, _LL, _I, _P, _I, _P],
    },
    "msm_te": {
        # table, idx, out, host_consts, n0, batch, groups, ncombos, nwords,
        # device, stream
        "msm_te": [_P, _P, _P, _P, _U, _LL, _I, _I, _I, _I, _P],
    },
    "msm_sw": {
        # table, idx, out, host_consts, n0, a_is_zero, batch, groups, ncombos,
        # nwords, split, device, stream
        "msm_sw": [_P, _P, _P, _P, _U, _I, _LL, _I, _I, _I, _I, _I, _P],
    },
    "curve_affine": {
        # in, out, host_consts, n0, ebits, batch, coords, nwords, device, stream
        "curve_affine": [_P, _P, _P, _U, _I, _LL, _I, _I, _I, _P],
    },
    "curve_add": {
        # in1, in2, out, host_consts, n0, batch, nwords, device, stream
        "curve_add": [_P, _P, _P, _P, _U, _LL, _I, _I, _P],
    },
    "curve_windowed": {
        # base, bits, table, out, host_consts, n0, batch, nbits, nwords, w,
        # device, stream
        "curve_windowed": [_P, _P, _P, _P, _P, _U, _LL, _I, _I, _I, _I, _P],
    },
    "curve_pack": {
        # in, out, host_consts, n0, batch, nwords, device, stream
        "curve_pack": [_P, _P, _P, _U, _LL, _I, _I, _P],
    },
    "field_probe": {
        # op, a, b, out, host_p, n0, count, iters, nwords, device, stream
        "field_ops": [_I, _P, _P, _P, _P, _U, _LL, _I, _I, _I, _P],
    },
}

_loaded: dict = {}

build_seconds = 0.0
load_seconds = 0.0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's hash
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile the named sources (all of ``SIGNATURES`` by default) that are
    not built yet, one ``nvcc`` each, all at once.  Returns name -> library
    path.  ``nvcc``'s output (with ``-Xptxas -v`` register counts) is kept
    in ``build/<name>.log``."""
    global build_seconds
    t0 = time.perf_counter()
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, jobs = {}, {}
    for name in names:
        lib = library_path(name)
        paths[name] = lib
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    build_seconds += time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    global load_seconds
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.cpt_error_string.argtypes = [ctypes.c_int]
        lib.cpt_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
        load_seconds += time.perf_counter() - t0
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.cpt_error_string(err).decode()}")

