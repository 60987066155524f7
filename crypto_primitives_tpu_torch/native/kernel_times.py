"""Time the port's path kernels at the main paths' shapes, for one tree.

Run from anywhere, on a machine with a CUDA card:

    python3 crypto_primitives_tpu_torch/native/kernel_times.py [--root DIR]

``--root`` names the root of a checkout of this repository (default: the one
this file lies in); its ``crypto_primitives_tpu_torch`` package is imported,
builds its own kernels from its own ``csrc/`` into its own build directory,
and is timed through its public wrappers, whose contracts every version of
the port keeps.  So two checkouts (a parent commit unpacked beside the tree,
or a variant of a kernel) are compared on one card by running this in turns
in one call: A, B, B, A.  Inputs are made on the card from a fixed seed:

  poseidon_permute  2^19 BLS12-381 Fr states, t = 3 (one level of the
                    2^20-leaf Poseidon tree)
  sha256_compress   2^19 two-block messages of pre-padded words (the TPU
                    kernel's contract)
  sha256_64, _80    ops.sha256.sha256 on 2^19 messages of 64 and 80 bytes
                    (the SHA-256 tree's inner levels and its first inner
                    level, with the length prefix), whatever that entry
                    launches around the kernel
  msm_te            2^16 rows x 342 groups, w = 3, ed-on-bls12-377 (the
                    Pedersen CRH at window 250 x 8 on 128-byte inputs)
  msm_sw            2^14 rows x 342 groups, w = 3, BLS12-381 G1, as built
  curve_affine_w8, _w12   where the root has ops/affine_kernel.py: the affine
                    step on 2^16 random projective points, ed-on-bls12-377
                    (extended, W = 8) and BLS12-381 G1 (projective, W = 12),
                    and its plain version on the card (curve_affine_plain_*)
  curve_add_w8      where the root has ops/add_kernel.py: the complete
                    addition of 2^16 pairs of random extended points,
                    ed-on-bls12-377 (W = 8), and its plain version on the
                    card (curve_add_plain_w8)
  curve_windowed_w8  where the root has ops/windowed_kernel.py: the windowed
                    product of 2^16 random extended points, ed-on-bls12-377
                    (W = 8), by random 251-bit scalars at w = 4 (Schnorr's
                    e pk), and its plain version on the card on the first
                    4096 rows (curve_windowed_plain_w8); and the kernel built
                    from a copy of its source at each block size of
                    WINDOWED_THREADS (``curve_windowed_threads``: the time
                    and ptxas's registers of each), each output held equal
                    to the wrapper's
  curve_pack_w8     where the root has ops/pack_kernel.py: the extended
                    Montgomery words of 2^16 random canonical (x, y) pairs,
                    ed-on-bls12-377 (W = 8; Schnorr's keys), by the wrapper,
                    and through the C entry point in runs of 100 launches
                    (curve_pack_c_w8: the time a launch), each output held
                    equal to the plain version's on the first 4096 rows,
                    and that plain version on the card (curve_pack_plain_w8)
  msm_sw_<curve>_k<k>  where the root's msm_sw_kernel has a SPLIT table: the
                    same shape for every build (BLS12-381 G1, Pallas, a W = 8
                    curve with a != 0, P-256) with each row split over
                    k = 1, 2, 3, 4 and 8 threads, each held on 128 random
                    rows against the plain version at the same k

K1 also runs alone at 1, 1024, 4096, 8192, 12288, 2^14, 2^15, 2^16 and 2^19
states (t = 3, BLS12-381 Fr), and at 1024 to 12288 states over BLS12-381 Fq
(W = 12, alpha 5, 8 + 60 rounds, keys ``fq_<batch>``), through its wrapper
(``k1_sizes``: the time and, on a root whose wrapper chooses lanes a state,
the G it chose) and, on such a root, through the C entry point at every G it
is built for, each output held equal to the wrapper's: the crossover table
behind ``choose_group``.

Each time is the median of ten CUDA-event timings of single launches after a
warm-up.  poseidon_permute, sha256_compress, sha256_64, sha256_80, msm_te and
msm_sw each also have a ``<key>_plain`` time: the plain PyTorch version on
the card on the first 4096 rows of the same input, the median of three calls
after one whose output is held equal to the kernel's on those rows.  Where
the root has the field probe's chain ops, it also times the Montgomery
product alone: 132 x 8 blocks of 128 threads (eight per SM), each thread 1000
dependent products (``mul_chain``) or squares (``sqr_chain``) at W = 8
(BLS12-381 Fr) and W = 12 (BLS12-381 Fq), reported in G products/s: the
ceiling that the field arithmetic sets for every kernel built on it.

Prints one JSON line: the root, the card, its power limit, the times in ms,
the product rates, ptxas's registers and spills (:func:`parse_ptxas` on the
root's build logs) for every msm_sw build and for every kernel of every
library, and the SASS instruction counts (:func:`parse_sass` on
``cuobjdump -sass``) of one mont_mul<8> of the root's csrc/field.cuh and of
one SHA-256 block of its csrc/sha256_compress.cu (where that source has the
shared block function), compiled from the probes below.  No bound is
printed: the bounds are ``portbench/roofline/``'s and PERF.md's.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import random
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve()
SEED = 20261017
PLAIN_ROWS = 4096  # rows of each plain version's timing
WINDOWED_THREADS = (64, 128, 256)  # A3's block sizes tried

# One mont_mul<8> of a field.cuh (``%(header)s``), between the loads of its
# operands and the store of its result.
_SASS_PROBE = r"""
#include <cstdint>
#include "%(header)s"
extern "C" __global__ void one_mont_mul(const uint32_t* a, const uint32_t* b, const uint32_t* p,
                                        uint32_t n0, uint32_t* r) {
  uint32_t x[8], y[8], q[8], o[8];
  for (int j = 0; j < 8; ++j) { x[j] = a[j]; y[j] = b[j]; q[j] = p[j]; }
  mont_mul<8>(o, x, y, q, n0);
  for (int j = 0; j < 8; ++j) r[j] = o[j];
}
"""

# One message block and one fixed padding block of a sha256_compress.cu's
# ``compress_block`` (``%(source)s``), each between the loads and the store.
_SHA_PROBE = r"""
#include "%(source)s"
__global__ void one_block(const uint32_t* in, uint32_t* out) {
  uint32_t h[8], w[16];
  for (int j = 0; j < 8; ++j) h[j] = in[j];
  for (int j = 0; j < 16; ++j) w[j] = in[8 + j];
  compress_block<false>(h, w, nullptr);
  for (int j = 0; j < 8; ++j) out[j] = h[j];
}
__global__ void one_padding_block(const uint32_t* in, uint32_t* out,
                                  const __grid_constant__ PadBlock pad) {
  uint32_t h[8];
  for (int j = 0; j < 8; ++j) h[j] = in[j];
  compress_block<true>(h, nullptr, pad.kw);
  for (int j = 0; j < 8; ++j) out[j] = h[j];
}
"""


def parse_ptxas(text: str) -> list:
    """Registers, stack and spills of each kernel in ``nvcc -Xptxas -v``
    output: [{"kernel": mangled name, "registers": n, "stack": bytes,
    "spill_stores": bytes, "spill_loads": bytes}], in the log's order."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def parse_sass(text: str) -> dict:
    """Each function's instruction mix in ``cuobjdump -sass`` output:
    {function: {"IMAD": n, "IADD3": n, "other": n, "total": n}}, keyed by the
    name cuobjdump prints (mangled unless ``extern "C"``).  IMAD and IADD3
    count with their suffixes, a predicate does not change an op, and NOP
    and BRA are not counted."""
    out = {}
    for part in text.split("Function : ")[1:]:
        mix = {"IMAD": 0, "IADD3": 0, "other": 0}
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part):
            op = m.group(1).split(".")[0]
            if op in ("NOP", "BRA"):
                continue
            mix[op if op in ("IMAD", "IADD3") else "other"] += 1
        mix["total"] = sum(mix.values())
        out[part.split()[0]] = mix
    return out


def ptxas_report(build, name: str) -> list:
    """:func:`parse_ptxas` of ``build``'s log of ``csrc/<name>.cu``; [] where
    there is none."""
    path = Path(build.BUILD_DIR) / f"{name}.log"
    return parse_ptxas(path.read_text()) if path.exists() else []


def _sass_by_function(build, source: str, tag: str):
    """:func:`parse_sass` of ``source`` compiled to an sm_90a cubin with
    ``build``'s nvcc; None where ``cuobjdump`` is missing."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return None
    Path(build.BUILD_DIR).mkdir(parents=True, exist_ok=True)
    src = Path(build.BUILD_DIR) / f"sass_probe_{tag}.cu"
    src.write_text(source)
    cubin = src.with_suffix(".cubin")
    subprocess.run([build.nvcc_path(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-o", str(cubin), str(src)], check=True, capture_output=True)
    return parse_sass(subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True, capture_output=True,
                                     text=True).stdout)


def sass_mix(build, header: Path):
    """SASS mix of one ``mont_mul<8>`` of ``header`` (the loads, stores and
    the kernel's exit count as other); None where ``cuobjdump`` is missing."""
    tag = hashlib.sha256(Path(header).read_bytes()).hexdigest()[:12]
    mixes = _sass_by_function(build, _SASS_PROBE % {"header": Path(header).resolve()}, f"mont_{tag}")
    return None if mixes is None else mixes["one_mont_mul"]


def sha256_sass(build, source: Path):
    """SASS mix of one SHA-256 message block (schedule and rounds) and of
    the fixed padding block (rounds from K[r] + W[r]) of ``source``'s
    ``compress_block``; None where ``cuobjdump`` is missing."""
    tag = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:12]
    mixes = _sass_by_function(build, _SHA_PROBE % {"source": Path(source).resolve()}, f"sha_{tag}")
    if mixes is None:
        return None
    # the probe kernels' names are mangled (PadBlock has internal linkage)
    return {kind: next(mix for name, mix in mixes.items() if probe in name)
            for kind, probe in (("message_block", "one_block"), ("padding_block", "one_padding_block"))}


def windowed_block_sizes(build, ff, curve, base, bits, want) -> dict:
    """A3 built from a copy of the root's csrc/curve_windowed.cu at each
    block size of WINDOWED_THREADS and launched through its C entry point
    on ``base`` and ``bits``: {threads: {"ms": median, "ptxas": registers
    and spills}}, each output held equal to ``want``."""
    csrc = Path(build.CSRC)
    source = (csrc / "curve_windowed.cu").read_text()
    line = re.search(r"constexpr int kThreads = \d+;", source).group(0)
    q = curve.base
    W = q.num_words
    B, nbits = bits.shape
    consts = ff.host_words(q, [q.p, q.to_mont(curve.d), q.to_mont(curve.a), q.to_mont(1)])
    table = torch.empty(((1 << 4) * 4 * W * B,), dtype=torch.int32, device=base.device)
    out = {}
    for threads in WINDOWED_THREADS:
        src = Path(build.BUILD_DIR) / f"curve_windowed_t{threads}.cu"
        src.write_text(source.replace(line, f"constexpr int kThreads = {threads};"))
        lib_path = src.with_suffix(".so")
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib_path), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.curve_windowed.argtypes = build.SIGNATURES["curve_windowed"]["curve_windowed"]
        lib.curve_windowed.restype = ctypes.c_int
        res = torch.empty_like(want)

        def fn():
            err = lib.curve_windowed(base.data_ptr(), bits.data_ptr(), table.data_ptr(), res.data_ptr(),
                                     consts.ctypes.data, q.n0_word, B, nbits, W, 4, 0,
                                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"curve_windowed at {threads} threads a block: CUDA error {err}")

        fn()
        if not torch.equal(res, want):
            raise SystemExit(f"curve_windowed at {threads} threads a block differs from the wrapper's")
        out[threads] = {"ms": median_ms(fn, 10), "ptxas": parse_ptxas(proc.stdout)}
    return out


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import crypto_primitives_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent != root / "crypto_primitives_tpu_torch":
        raise SystemExit(f"imported {pkg.__file__}, not the package under {root}")
    from crypto_primitives_tpu_torch.models.sponge import (
        PoseidonConfig,
        find_poseidon_ark_and_mds,
        get_default_poseidon_parameters,
    )
    from crypto_primitives_tpu_torch.native import build
    from crypto_primitives_tpu_torch.ops import msm_kernel, msm_sw_kernel, poseidon_kernel, sha256_kernel
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
    from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, ED_ON_BLS12_377
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
    from crypto_primitives_tpu_torch.ops.sha256 import sha256

    build.build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = random.Random(SEED)

    def words(spec, shape):
        W = spec.num_words
        w = torch.randint(-(1 << 31), 1 << 31, tuple(shape) + (W,), dtype=torch.int64, device="cuda", generator=gen)
        top = (spec.p >> (32 * (W - 1))) & 0xFFFFFFFF
        w[..., W - 1] = torch.randint(0, top, tuple(shape), dtype=torch.int64, device="cuda", generator=gen)
        return w.to(torch.int32)

    def msm_operands(curve, rows, groups=342, w=3):
        pts = [curve.rand_point(rng)]
        while len(pts) < groups * w:
            pts.append(curve.double_host(pts[-1]))
        table = torch.from_numpy(fast_mod(curve).pack_table_grouped(curve, pts, w)).cuda()
        idx = torch.randint(0, 1 << w, (rows, groups), dtype=torch.int32, device="cuda", generator=gen)
        return table, idx

    cfg = get_default_poseidon_parameters(FR, 2, False)
    states = words(FR, (1 << 19, 3))
    sha = torch.randint(-(1 << 31), 1 << 31, (1 << 19, 2, 16), dtype=torch.int64, device="cuda",
                        generator=gen).to(torch.int32)
    sha_msgs = {n: torch.randint(0, 256, (1 << 19, n), dtype=torch.uint8, device="cuda", generator=gen)
                for n in (64, 80)}
    te_table, te_idx = msm_operands(ED_ON_BLS12_377, 1 << 16)
    sw_table, sw_idx = msm_operands(BLS12_381_G1, 1 << 14)
    calls = {
        "poseidon_permute": lambda: poseidon_kernel.permute(cfg, states),
        "sha256_compress": lambda: sha256_kernel.compress(sha),
        "sha256_64": lambda: sha256(sha_msgs[64], device="cuda"),
        "sha256_80": lambda: sha256(sha_msgs[80], device="cuda"),
        "msm_te": lambda: msm_kernel.grouped_msm(ED_ON_BLS12_377, te_table, te_idx),
        "msm_sw": lambda: msm_sw_kernel.grouped_msm(BLS12_381_G1, sw_table, sw_idx),
    }
    times = {name: median_ms(fn, 10) for name, fn in calls.items()}
    plains = {
        "poseidon_permute": (lambda x: poseidon_kernel.permute_plain(cfg, x), states),
        "sha256_compress": (sha256_kernel.compress_plain, sha),
        "sha256_64": (sha256_kernel.digest_plain, sha_msgs[64]),
        "sha256_80": (sha256_kernel.digest_plain, sha_msgs[80]),
        "msm_te": (lambda x: msm_kernel.grouped_msm_plain(ED_ON_BLS12_377, te_table, x), te_idx),
        "msm_sw": (lambda x: msm_sw_kernel.grouped_msm_plain(BLS12_381_G1, sw_table, x), sw_idx),
    }
    for name, (plain, x) in plains.items():
        rows = x[:PLAIN_ROWS].contiguous()
        if not torch.equal(calls[name]()[:PLAIN_ROWS], plain(rows)):
            raise SystemExit(f"{name}'s plain version differs from the kernel on the first {PLAIN_ROWS} rows")
        times[f"{name}_plain"] = median_ms(lambda: plain(rows), 3, warmup=0)
    if importlib.util.find_spec("crypto_primitives_tpu_torch.ops.affine_kernel") is not None:
        from crypto_primitives_tpu_torch.ops import affine_kernel

        for curve in (ED_ON_BLS12_377, BLS12_381_G1):
            pts = words(curve.base, (1 << 16, curve.coords))
            W = curve.base.num_words
            if not torch.equal(affine_kernel.to_affine(curve, pts), affine_kernel.to_affine_plain(curve, pts)):
                raise SystemExit(f"curve_affine on {curve.name} differs from its plain version")
            times[f"curve_affine_w{W}"] = median_ms(lambda: affine_kernel.to_affine(curve, pts), 10)
            times[f"curve_affine_plain_w{W}"] = median_ms(lambda: affine_kernel.to_affine_plain(curve, pts), 3)
    if importlib.util.find_spec("crypto_primitives_tpu_torch.ops.add_kernel") is not None:
        from crypto_primitives_tpu_torch.ops import add_kernel

        curve = ED_ON_BLS12_377
        p1, p2 = (words(curve.base, (1 << 16, 4)) for _ in range(2))
        if not torch.equal(add_kernel.te_add(curve, p1, p2), add_kernel.te_add_plain(curve, p1, p2)):
            raise SystemExit(f"curve_add on {curve.name} differs from its plain version")
        times["curve_add_w8"] = median_ms(lambda: add_kernel.te_add(curve, p1, p2), 10)
        times["curve_add_plain_w8"] = median_ms(lambda: add_kernel.te_add_plain(curve, p1, p2), 3)
    windowed_threads = None
    if importlib.util.find_spec("crypto_primitives_tpu_torch.ops.windowed_kernel") is not None:
        from crypto_primitives_tpu_torch.ops import field as ff
        from crypto_primitives_tpu_torch.ops import windowed_kernel

        curve = ED_ON_BLS12_377
        base = words(curve.base, (1 << 16, 4))
        bits = torch.randint(0, 2, (1 << 16, curve.scalar.nbits), dtype=torch.uint8, device="cuda", generator=gen)
        want = windowed_kernel.te_windowed(curve, base, bits)
        head = (base[:PLAIN_ROWS], bits[:PLAIN_ROWS])
        if not torch.equal(want[:PLAIN_ROWS], windowed_kernel.te_windowed_plain(curve, *head, 4)):
            raise SystemExit(f"curve_windowed on {curve.name} differs from its plain version")
        times["curve_windowed_w8"] = median_ms(lambda: windowed_kernel.te_windowed(curve, base, bits), 10)
        times["curve_windowed_plain_w8"] = median_ms(lambda: windowed_kernel.te_windowed_plain(curve, *head, 4), 3,
                                                     warmup=0)
        windowed_threads = windowed_block_sizes(build, ff, curve, base, bits, want)
    if importlib.util.find_spec("crypto_primitives_tpu_torch.ops.pack_kernel") is not None:
        from crypto_primitives_tpu_torch.ops import field as ff
        from crypto_primitives_tpu_torch.ops import pack_kernel

        curve = ED_ON_BLS12_377
        q = curve.base
        xy = words(q, (1 << 16, 2))
        want = pack_kernel.te_pack(curve, xy)
        head = xy[:PLAIN_ROWS]
        if not torch.equal(want[:PLAIN_ROWS], pack_kernel.te_pack_plain(curve, head)):
            raise SystemExit(f"curve_pack on {curve.name} differs from its plain version")
        times["curve_pack_w8"] = median_ms(lambda: pack_kernel.te_pack(curve, xy), 10)
        lib = build.load("curve_pack")
        out = torch.empty_like(want)
        consts = ff.host_words(q, [q.p, q.R2_mod_p, q.R_mod_p])

        def pack_c():
            err = lib.curve_pack(xy.data_ptr(), out.data_ptr(), consts.ctypes.data, q.n0_word, xy.shape[0],
                                 q.num_words, 0, torch.cuda.current_stream().cuda_stream)
            build.check(lib, err, "curve_pack")

        pack_c()
        if not torch.equal(out, want):
            raise SystemExit("curve_pack through its C entry differs from the wrapper's")
        times["curve_pack_c_w8"] = median_ms(lambda: [pack_c() for _ in range(100)], 10) / 100
        times["curve_pack_plain_w8"] = median_ms(lambda: pack_kernel.te_pack_plain(curve, head), 3)
    if hasattr(msm_sw_kernel, "SPLIT"):
        from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec
        from crypto_primitives_tpu_torch.ops.curves_known import PALLAS, SECP256R1

        a3 = SWCurveSpec("test_a3_bls12_381_fr", FR, FR, -3, 1, 1, (0, 1))
        rows = torch.randperm(1 << 14, device="cuda", generator=gen)[:128]
        for curve in (BLS12_381_G1, PALLAS, a3, SECP256R1):
            table, idx = (sw_table, sw_idx) if curve is BLS12_381_G1 else msm_operands(curve, 1 << 14)
            key = (curve.base.num_words, curve.a == 0)
            built = msm_sw_kernel.SPLIT[key]
            try:
                for k in (1, 2, 3, 4, 8):
                    msm_sw_kernel.SPLIT[key] = k

                    def fn():
                        return msm_sw_kernel.grouped_msm(curve, table, idx)

                    if not torch.equal(fn()[rows], msm_sw_kernel.grouped_msm_plain(curve, table, idx[rows])):
                        raise SystemExit(f"msm_sw on {curve.name} at k = {k} differs from its plain version")
                    times[f"msm_sw_{curve.name}_k{k}"] = median_ms(fn, 10)
            finally:
                msm_sw_kernel.SPLIT[key] = built
    k1_sizes, k1_card = {}, None
    grouped = hasattr(poseidon_kernel, "choose_group")
    if grouped:
        lib = build.load("poseidon_permute")
        blocks = ctypes.c_int(0)
        build.check(lib, lib.poseidon_permute_blocks_per_sm(8, 3, 0, ctypes.addressof(blocks)), "blocks_per_sm")
        k1_card = {"sms": torch.cuda.get_device_properties(0).multi_processor_count, "blocks_per_sm": blocks.value}
    fq_cfg = PoseidonConfig(BLS12_381_FQ, 8, 60, 5, *find_poseidon_ark_and_mds(BLS12_381_FQ, 2, 8, 60, 0), 2, 1)
    fq_states = words(BLS12_381_FQ, (1 << 14, 3))
    shapes = [("", cfg, states, b) for b in (1, 1024, 4096, 8192, 12288, 1 << 14, 1 << 15, 1 << 16, 1 << 19)]
    shapes += [("fq_", fq_cfg, fq_states, b) for b in (1024, 4096, 8192, 12288)]
    for tag, c, pool, batch in shapes:
        x = pool[:batch].contiguous()
        row = {"wrapper": median_ms(lambda: poseidon_kernel.permute(c, x), 10)}
        if grouped:
            W = c.field.num_words
            want = poseidon_kernel.permute(c, x)
            row["chosen"] = poseidon_kernel.choose_group(batch, k1_card["sms"], k1_card["blocks_per_sm"],
                                                          poseidon_kernel.CROSSOVER[W])
            n_sparse, image = c.schedule_tables(x.device)
            for group in poseidon_kernel.GROUPS:
                out = torch.empty_like(x)

                def fn():
                    err = lib.poseidon_permute(
                        x.data_ptr(), out.data_ptr(), image.data_ptr(), image.numel(), batch, W, 3, c.alpha,
                        c.full_rounds, c.partial_rounds, n_sparse, group, 0, torch.cuda.current_stream().cuda_stream)
                    build.check(lib, err, "poseidon_permute")

                fn()
                if not torch.equal(out, want):
                    raise SystemExit(f"poseidon_permute at G = {group} on {batch} states differs from the wrapper's")
                row[f"g{group}"] = median_ms(fn, 10)
        k1_sizes[f"{tag}{batch}"] = row
    rates = {}
    if importlib.util.find_spec("crypto_primitives_tpu_torch.ops.field_probe") is not None:
        from crypto_primitives_tpu_torch.ops import field_probe
        from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ

        if "mul_chain" in field_probe.OPS:
            count, iters = 132 * 8 * 128, 1000
            for spec in (FR, BLS12_381_FQ):
                a, b = words(spec, (count,)), words(spec, (count,))
                for op in ("mul_chain", "sqr_chain"):
                    ms = median_ms(lambda: field_probe.field_ops(spec, op, a, b, iters=iters), 3)
                    rates[f"{op}_w{spec.num_words}"] = count * iters / ms / 1e6
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    csrc = root / "crypto_primitives_tpu_torch" / "csrc"
    has_block = "compress_block" in (csrc / "sha256_compress.cu").read_text()
    print(json.dumps({
        "root": str(root), "device": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else None,
        "ms": times, "curve_windowed_threads": windowed_threads, "k1_card": k1_card, "k1_sizes": k1_sizes,
        "g_products_per_s": rates,
        "ptxas_msm_sw": ptxas_report(build, "msm_sw"),
        "ptxas": {name: ptxas_report(build, name) for name in build.SIGNATURES},
        "sass_mont_mul_8": sass_mix(build, csrc / "field.cuh"),
        "sass_sha256_block": sha256_sass(build, csrc / "sha256_compress.cu") if has_block else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
