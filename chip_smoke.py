#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels on one NVIDIA GPU and drive its main paths.

Run from the root of the repository:  python3 chip_smoke.py

Phases (each prints a flushed line before and after, with its seconds):
  0. device: the card's name and power limit;
  1. build: nvcc compiles every kernel source in crypto_primitives_tpu_torch/csrc
     (ptxas registers and spills of every instantiation, and the SASS
     instruction mix of one Montgomery product and of one SHA-256 block where
     cuobjdump exists);
  2. known answers on the card: the pinned Poseidon sponge vector and SHA-256
     against hashlib;
  3. each kernel against its plain PyTorch version on the card, exactly, for
     every instantiation (the MSM kernels on every curve they are built for,
     P-256 among them; SHA-256's byte entry at message lengths around the
     padding's edges, with 16-byte and byte loads), and the shared field
     arithmetic (csrc/field_probe.cu) against the plain field tier on edge
     values at W = 8 and W = 12; both MSM kernels at the fixed-base shapes,
     20 (msm_te) and 84, 85 and 86 groups of doubling powers; msm_te on
     Bowe-Hopwood's signed-digit table at 20, 341 and 342 groups; the
     affine step (csrc/curve_affine.cu) on every MSM kernel's sums;
  4. the hashing paths at full size: a SHA-256 and a Poseidon Merkle tree
     over 2^20 leaves each, built, proved and verified (the SHA-256 build
     launches its kernel once per hashed level);
  5. the curve paths at full width: the Pedersen CRH and commitment over
     ed-on-bls12-377 (window 250 x 8, 128-byte inputs, 2^16 rows) and over
     BLS12-381 G1 (2^14 rows), and a 2^16-leaf Pedersen Merkle tree over
     JubJub, each held on sampled rows against the host oracle;
  7. signatures and encryption (run after phase 5, before phase 6): Schnorr
     keygen_batch, sign_batch (4 candidates a message) and verify_batch
     (true signatures, then every 16th message altered) on 2^14 keys with
     128-byte messages, and ElGamal encrypt_batch (2^14 messages: r pk
     fixed-base; 16 messages: r pk windowed) and decrypt_batch round trips,
     on ed-on-bls12-377, and the same at 2^12 on BLS12-381 G1; 64
     sampled rows of every output held against the host tier; each call's
     wall time and its MSM, windowed and affine steps (the steps run again
     alone); msm_te at 2^16 rows x 84 groups and msm_sw at 2^16 x 85 (the
     fixed-base shape of 2^14 messages' signing pass) timed beside their
     bounds;
  8. transcripts, protocols and the rest of the Pedersen family (run after
     phase 7, before phase 6): the Bowe-Hopwood CRH on ed-on-bls12-377 at
     window 63 x 6 over 2^16 128-byte inputs, the injective-map CRH and
     commitment compressors at phase 5's window and inputs (their outputs
     equal the x-coordinates of phase 5's), the fold argument (B = 8192,
     R = 8), the sumcheck prover (B = 4096, m = 10) eagerly and through its
     CUDA graph (equal on every instance), and the IPA folding argument on
     JubJub (n = 4, B = 1024); sampled instances held against the host
     oracles and verifiers, a forged IPA scalar rejected; each call's wall
     time and its steps (MSM, windowed, affine; permutation and field) and
     launches;
  9. Blake2s and the R1CS tier (run after phase 8, before phase 6): the
     Blake2s PRF, the parameter-block PRF (salt and person) and the Blake2s
     commitment (128-byte inputs) on 2^16 rows each, every row held against
     hashlib, and ops.blake2s at lengths 0-129 (block edges), keyed and
     not, 32- and 16-byte digests; batched R1CS circuits synthesised as one
     trace and checked on the card: the Blake2s PRF (21792 constraints) and
     the SHA-256 CRH on 55-byte messages at N = 1024 (digests equal to
     evaluate_batch and to ops.sha256, K3; the int64 small-domain check; one
     digest bit's witness flipped in one instance fails that instance alone,
     and which_unsatisfied names the constraint the scalar tier names on the
     host), the Poseidon two-to-one CRH at N = 4096 (the Montgomery check;
     outputs equal to PoseidonTwoToOneCRH.evaluate_batch, K1), and
     check_satisfied_device on the scalar Blake2s PRF circuit (about 122,000
     nonzeros), true and then false after the same flip; a torch.profiler
     trace around one evaluate_batch (utils.profiling.capture) holding its
     annotate span; each call's host synthesis and device check times;
  10. the Merkle, curve and SNARK gadgets (run after phase 9, before phase 6),
     each gadget's output held against the native result computed on the
     card: 1024 Poseidon membership circuits (PathVar) over paths of phase
     4's 2^20-leaf tree (depth 20, 5728 constraints), synthesised as one
     trace and checked in Montgomery form: one instance given a wrong leaf
     is false (and equal to verify_rows_batch, K1, on every instance) while
     the system stays satisfied; with ok enforced it alone fails, at the
     constraint which_unsatisfied names on the card and the scalar tier names
     on the host; 256 SHA-256 byte-path circuits (BytePathVar) over an 8-leaf
     tree (K3), the int64 small-domain check, one wrong root byte; the
     Pedersen point path (PointPathVar, a 4-leaf JubJub tree with phase 5's
     parameters, K4) through check_satisfied_device, true, then false with
     the root input's y changed by one; on ed-on-bls12-377 (constraint field
     its base field) ElGamalEncGadget against encrypt_batch (K4) and the
     host encrypt, SchnorrRandomizePkGadget against randomize_public_key,
     PedersenCRHGadget and PedersenCRHCompressorGadget against their
     evaluate_batch rows (K4) and BoweHopwoodCRHGadget at phase 8's window
     against its evaluate_batch row (K4), each through
     check_satisfied_device; the MockLinSNARK verifier circuit, true and
     false with a tampered proof; each call's host synthesis and device check
     times.  It fails past its 60 s.  Cuts, for that limit: the byte paths
     are of an 8-leaf tree, not a 2^20-leaf one (a depth-20 byte path is
     about 1.5 M constraints); the Pedersen CRH and compressor gadgets run
     at JAX's test window 4 x 16 (phase 11 runs them at phase 5's);
  11. the Pedersen CRH and compressor gadgets at phase 5's window 250 x 8
     over a 128-byte input (run after phase 10, before phase 6), each equal
     to its evaluate_batch row (K4) and satisfied on the card; their host
     synthesis and check times, and phase 10's time had it run them in place
     of its 4 x 16 ones;
  12. the sharded paths (parallel/) over NCCL at world size 1 (run after
     phase 11, before phase 6), each through the kernels: the 2^20-leaf
     SHA-256 (K3) and Poseidon (K1) trees built and proved by
     sharded_merkle_build_prove_all, roots and all 2^20 auth paths equal to
     phase 4's; a ShardedMerkleTree over the SHA-256 leaves: update_batch of
     4096 leaves (the same root as a single-device tree updated alike),
     proof_rows and verify_rows_batch on every path, a wrong root rejected,
     and a 4096-leaf multipath verify, true and then false on a wrong root;
     sharded_permute_batch on K1's timed 2^19 states, equal to
     poseidon_kernel.permute; sharded_fixed_base_msm (K4, ed-on-bls12-377,
     2^16 rows) and sharded_fixed_base_msm_sw (K5, BLS12-381 G1, 2^14 rows)
     over the first 1024 generators of phase 5's window, affine-equal to
     conditional_sum_grouped_auto on every row; the host engine
     (native/cpmont.cpp, built with g++ meanwhile) against the kernels: its
     msm_bits on 64 rows of each MSM, and its Poseidon two-to-one on 1024
     pairs of the Poseidon tree's bottom inner level against K1's next level;
     each call's seconds and its collectives' seconds;
  6. times: each kernel at its path's shape (its output there held on 4096
     random rows against the plain version), the plain version's time, and
     the bound the card sets; SHA-256's byte entry at 2^19 messages of 64
     bytes (the tree's inner levels, the shape in the kernels line) and of
     80 bytes (its first inner level), and its word entry at 2^19 two-block
     messages; curve_affine on phase 5's ed-on-bls12-377 CRH sums (2^16 x 4
     x 8, the shape in the kernels line) and BLS12-381 G1 ones (2^14 x 3 x
     12); poseidon_permute at the transcripts' 8192, 4096 and 1024 states.
Every path runs with the kernel launch counts set to 0 just before it and
read just after; a path whose kernel did not launch fails (decrypt_batch
runs none, as in the JAX package: it is required to launch none).  It needs CUDA and
the repository: without either it exits non-zero before printing a result.
The last line is the JSON result.
"""

from __future__ import annotations

import hashlib
import json
import random
import statistics
import subprocess
import sys
import time

import torch

T0 = time.time()
SEED = 20261017
LEAVES = 1 << 20
CHECK_ROWS = 4096
TE_ROWS = 1 << 16  # Pedersen CRH and commitment rows on ed-on-bls12-377
# phase 5's Pedersen window and inputs (benches/crh.rs): 128-byte inputs fill
# 1024 of the window's 2000 bits
PEDERSEN_WINDOW, PEDERSEN_BYTES = (250, 8), 128
SW_ROWS = 1 << 14  # the same on BLS12-381 G1
PEDERSEN_LEAVES = 1 << 16
SAMPLE = 64  # rows of each curve path held against the host oracle
SIG_ROWS = 1 << 14  # phase 7: Schnorr keys and ElGamal messages on ed-on-bls12-377
# ... and on BLS12-381 G1, cut from 2^14 to keep the smoke's time: at 2^14
# its calls took 75 s, most of it the plain-torch windowed products
SIG_ROWS_G1 = 1 << 12
FIXED_BASE_ROWS = 1 << 16  # msm_te and msm_sw timed at the fixed-base shape
SIG_MSG_BYTES = 128
ELGAMAL_SMALL = 16  # below 32 messages, ElGamal's r pk takes the windowed route
HOST_TOP = 8  # the Pedersen tree's top 8 levels are recomputed on the host
# phase 8, the JAX package's bench shapes: benches/crh.py:40 (Bowe-Hopwood
# window 63 x 6), benches/fiat_shamir.py:33-34, benches/sumcheck.py:28-29,
# benches/ipa_fold.py:28-29
BH_WINDOW = (63, 6)
BH_ROWS = 1 << 16
FOLD_B, FOLD_R = 8192, 8
SUMCHECK_B, SUMCHECK_M = 4096, 10
# IPA cut from the bench's n = 8 to n = 4: at n = 8 phase 8 took 83-103 s on an H100,
# over the 90 s it may take
IPA_B, IPA_N = 1024, 4
SAMPLE_PROTOCOL = 16  # sumcheck and IPA instances held against the host oracles
# phase 9: the JAX package's PRF bench shape (benches/prf.py:19), and the
# batched R1CS circuits' instance counts
BLAKE_ROWS = 1 << 16
BLAKE_LENGTHS = (0, 1, 63, 64, 65, 128, 129)
BLAKE_LENGTH_ROWS = 1024
R1CS_BYTE_N = 1024  # the Blake2s PRF and SHA-256 CRH circuits
R1CS_FIELD_N = 4096  # the Poseidon two-to-one circuit
R1CS_TAMPERED = 517  # the instance whose digest bit is flipped
# phase 10: the Poseidon membership circuits take paths of phase 4's 2^20-leaf
# tree (depth 20, never cut); the SHA-256 byte paths are of an 8-leaf tree
# (tests/test_r1cs_byte_merkle.py:118-121), cut from depth 20 for time: one
# SHA-256 level is about 74,500 constraints, a depth-20 path about 1.5 M
GADGET_PATHS = 1024
BYTE_PATHS = 256
BYTE_TREE_LEAVES = 8
POINT_TREE_LEAVES = 4  # tests/test_merkle_pedersen.py:143-200: two 1024-bit compresses
ELGAMAL_ROWS = 32  # encrypt_batch's fixed-base route, as phase 7's 2^14 rows take
# the Pedersen CRH and compressor gadgets at JAX's test window
# (tests/test_r1cs_curve_gadgets.py:31) in phase 10, and at phase 5's in phase 11:
# over 1,024 input bits the select chain's linear combinations grow by one term a
# bit, about 10.2 M nonzeros a circuit, and phase 10 with them would run over
# its limit (PERF.md, section 4)
CURVE_WINDOW = (4, 16)
SNARK_INPUTS = 3
PHASE10_LIMIT_S = 60
# phase 12: the host engine's Poseidon pairs held against K1's tree level
ENGINE_PAIRS = 1024

# Pinned BLS12-381 Fr sponge output: absorb [0, 1, 2], squeeze 3
# (tests/test_poseidon.py:121-129, the reference's src/sponge/poseidon/mod.rs:381-404).
POSEIDON_PINNED = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]

# Published peak rates of one H100 SXM (NVIDIA's data sheet): HBM bandwidth,
# and float32 outside the tensor cores.  No integer rate is published beside
# them; 32-bit integer instructions are held to the float32 rate, which no
# integer pipe exceeds, so the bound is a true lower bound on time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Operations of one grouped-MSM step: one complete addition per group.
# msm_te: 8 Montgomery products; msm_sw: 12 variable products and 2 by 3b,
# plus 3 by a when a != 0.
def msm_products(curve) -> int:
    return 8 if curve.coords == 4 else (14 if curve.a == 0 else 17)


def msm_bound(curve, table, idx):
    """(bytes, operations) of one grouped MSM: indices and table read once,
    the sums written once; msm_products(curve) products per row and group."""
    W = curve.base.num_words
    nbytes = idx.numel() * 4 + idx.shape[0] * curve.coords * W * 4 + table.numel() * 4
    return nbytes, idx.numel() * msm_products(curve) * 2 * (4 * W * W + W)


def affine_bound(curve, pts):
    """(bytes, operations) of one affine step: the points read and (x, y)
    written once; per point the Fermat chain's squares and products (the
    bits of p - 2 below its top, and its set bits but the top one) and the
    two products by Z^-1, each 2 (4 W^2 + W) operations as msm_bound counts."""
    W, e = curve.base.num_words, curve.base.p - 2
    B = pts.numel() // (curve.coords * W)
    products = (e.bit_length() - 1) + (bin(e).count("1") - 1) + 2
    return B * (curve.coords + 2) * W * 4, B * products * 2 * (4 * W * W + W)


def bound_ms(nbytes, nops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def general_a_curve():
    """A curve with a != 0 for the general SW law, used only here and in the
    tests: y^2 = x^3 - 3x + 1 over BLS12-381 Fr, generator (0, 1).  x^3 - 3x + 1
    has no root in Fr, so the group has no point of order 2 and the complete
    formulas hold.  Its order is not computed: the scalar field given is a
    stand-in, and only the group law is used."""
    from crypto_primitives_tpu_torch.ops.curve_sw import SWCurveSpec
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR

    return SWCurveSpec("test_a3_bls12_381_fr", BLS12_381_FR, BLS12_381_FR, -3, 1, 1, (0, 1))


# Operations of one SHA-256 block: 48 schedule words at 13 operations, 64 rounds
# at 25, 8 final additions (a rotation is one funnel shift).  The fixed padding
# block that ends a message of a multiple of 64 bytes has no schedule to
# compute, and each round adds one precomputed K[r] + W[r]: 64 rounds at 24.
SHA_OPS_PER_BLOCK = 48 * 13 + 64 * 25 + 8
SHA_OPS_PADDING_BLOCK = 64 * 24 + 8
SHA_LENGTHS = (0, 32, 55, 56, 64, 80, 119, 128)


def sha_ops(n: int) -> int:
    """Operations of one n-byte message as the kernel computes it."""
    if n % 64 == 0:
        return n // 64 * SHA_OPS_PER_BLOCK + SHA_OPS_PADDING_BLOCK
    return (n + 9 + 63) // 64 * SHA_OPS_PER_BLOCK


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.time()
        log(f"[{self.name}] start at {self.t - T0:.1f} s")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self.t
        log(f"[{self.name}] {'FAILED' if exc_type else 'done'} in {dt:.2f} s")
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"CHECK FAILED: {what}")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over reps of one call's device time, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_elements(spec, shape, gen):
    """Uniform words with the top word below p's: values < p, in Montgomery form."""
    W = spec.num_words
    w = torch.randint(-(1 << 31), 1 << 31, tuple(shape) + (W,), dtype=torch.int64,
                      device="cuda", generator=gen)
    top = (spec.p >> (32 * (W - 1))) & 0xFFFFFFFF
    w[..., W - 1] = torch.randint(0, top, tuple(shape), dtype=torch.int64, device="cuda", generator=gen)
    return w.to(torch.int32)


def max_abs_err(a, b) -> float:
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return float((ua - ub).abs().max().item()) if ua.numel() else 0.0


def poseidon_ops(config) -> int:
    """32-bit integer operations of one permutation as the kernel computes it
    (the least work of the function at this schedule): a multiply, the
    2W-word product of two W-word elements, is 2W^2 word multiply-adds (lo
    and hi); a square W (W + 1); a Montgomery reduction 2W^2 + W; two
    operations each.  Every S-box product (its squarings and multiplies)
    takes one reduction.  A linear layer takes one multiply per matrix entry
    it applies and one reduction per output: t^2 and t in a dense round,
    2t - 1 and t in a sparse one (poseidon_sparse.port_schedule)."""
    W = config.field.num_words
    a, t = config.alpha, config.t
    n_sparse, _ = config.schedule_tables("cpu")
    sboxes = config.full_rounds * t + config.partial_rounds
    squares = sboxes * (a.bit_length() - 1)
    sbox_mults = sboxes * (bin(a).count("1") - 1)
    dense = config.full_rounds + config.partial_rounds - n_sparse
    mults = sbox_mults + dense * t * t + n_sparse * (2 * t - 1)
    reductions = squares + sbox_mults + (dense + n_sparse) * t
    return 2 * (squares * W * (W + 1) + mults * 2 * W * W + reductions * (2 * W * W + W))


def host_sha_root(leaves_np) -> bytes:
    level = [hashlib.sha256(row.tobytes()).digest() for row in leaves_np]
    prefix = (32).to_bytes(8, "little")
    level = [
        hashlib.sha256(prefix + level[2 * i] + prefix + level[2 * i + 1]).digest()
        for i in range(len(level) // 2)
    ]
    while len(level) > 1:
        level = [hashlib.sha256(level[2 * i] + level[2 * i + 1]).digest() for i in range(len(level) // 2)]
    return level[0]


KERNELS = ("poseidon_permute", "sha256_compress", "msm_te", "msm_sw", "curve_affine")
# built and checked beside them, launched by no path: csrc/field_probe.cu
PROBE_FIELDS = ("BLS12_381_FR", "BLS12_377_FR", "BLS12_381_FQ")


def kernel_modules():
    from crypto_primitives_tpu_torch.ops import affine_kernel, msm_kernel, msm_sw_kernel, poseidon_kernel, sha256_kernel

    return dict(zip(KERNELS, (poseidon_kernel, sha256_kernel, msm_kernel, msm_sw_kernel, affine_kernel)))


def drive(name: str, fn, needs):
    """Run one path with every launch count set to 0 just before it and read
    just after; fail unless each kernel in ``needs`` launched."""
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: m.launches for k, m in mods.items()}
    log(f"  {name}: {time.time() - t:.3f} s; launches {counts}")
    for k in needs:
        require(counts[k] > 0, f"{k} launched on the path '{name}'")
    return out, counts


def affine_host(curve, rows):
    """(n, 2, W) Montgomery affine words -> host (x, y) tuples."""
    return [(int(x), int(y)) for x, y in curve.base.unpack(rows.cpu())]


class Calls:
    """A phase's timed calls: (label, seconds) in ``summary``; a batch
    twin's launches added to ``launches``, the kernels line's totals."""

    def __init__(self, launches):
        self.summary, self.launches = [], launches

    def timed(self, label, fn):
        """Host clock around fn, ending in a synchronize."""
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        dt = time.time() - t
        self.summary.append((label, dt))
        return out, dt

    def native(self, path, fn, needs):
        """A batch twin, driven with the launch counts reset."""
        (out, counts), _ = self.timed(path, lambda: drive(path, fn, needs))
        for k in needs:
            self.launches[k] += counts[k]
        return out

    def checked(self, name, cs):
        """check_satisfied_device on the scalar circuit; its verdict."""
        from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device

        torch.cuda.reset_peak_memory_stats()
        ok, dt = self.timed(f"{name}: check_satisfied_device ({cs.num_constraints} constraints)",
                            lambda: check_satisfied_device(cs, device="cuda"))
        nnz = sum(len(lc.terms) for rows in (cs.a_rows, cs.b_rows, cs.c_rows) for lc in rows)
        log(f"  {name}: {cs.num_constraints} constraints, {nnz} nonzeros, {cs.num_witness} witnesses; "
            f"check_satisfied_device {ok} in {dt:.3f} s (peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")
        return ok

    def print_summary(self):
        for label, dt in self.summary:
            log(f"    {label}: {dt:.3f} s")


def pedersen_gadgets(calls, window, nbytes, gen):
    """PedersenCRHGadget and PedersenCRHCompressorGadget on ed-on-bls12-377
    at ``window`` over one ``nbytes``-byte input, each equal to its batch
    twin's row (K4) and satisfied on the card.  Returns their seconds."""
    from crypto_primitives_tpu_torch.models.crh import PedersenCRH
    from crypto_primitives_tpu_torch.models.crh.injective_map import PedersenCRHCompressor
    from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377 as ed
    from crypto_primitives_tpu_torch.r1cs import ConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.gadgets.pedersen import PedersenCRHCompressorGadget, PedersenCRHGadget
    from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

    t = time.time()
    shape = f"window {window.window_size} x {window.num_windows}, {nbytes}-byte inputs"
    crh, comp = PedersenCRH(ed, window), PedersenCRHCompressor(ed, window)
    params = crh.setup(random.Random(SEED + 12))
    inputs = torch.randint(0, 256, (SAMPLE, nbytes), dtype=torch.uint8, device="cuda", generator=gen)
    digests = calls.native(f"Pedersen CRH evaluate_batch, {shape}, {SAMPLE} rows",
                           lambda: crh.evaluate_batch(params, inputs, device="cuda"), ["msm_te"])
    xs = calls.native(f"PedersenCRHCompressor evaluate_batch, {shape}, {SAMPLE} rows",
                      lambda: comp.evaluate_batch(params, inputs, device="cuda"), ["msm_te"])
    row = inputs[0].cpu().numpy().tobytes()
    for gadget, want_row in ((PedersenCRHGadget, affine_host(ed, digests[:1])[0]),
                             (PedersenCRHCompressorGadget, int(ed.base.unpack(xs[0].cpu())))):
        name = f"{gadget.__name__}, {shape}"
        cs = ConstraintSystem(ed.base)
        out, _ = calls.timed(f"{name}: host synthesis",
                             lambda: gadget(ed, window).evaluate(cs, params, bytes_to_uint8s(cs, row)))
        require(out.value == want_row, f"{name} == its batch twin's row 0")
        require(calls.checked(name, cs) is True, f"{name}: satisfied on the card")
    return time.time() - t


def gadget_phase(cfg, pos_tree, pos_leaves, pedersen_tree, bh, bh_params, bh_inputs, calls, gen):
    """Phase 10: the Merkle, curve and SNARK gadgets on the card, each held
    against the native result computed there (the reference's
    ``native == gadget.value()``).  ``pedersen_tree`` is phase 5's (curve,
    leaf and two-to-one parameters, windows); ``bh`` and its parameters are
    phase 8's, with its inputs.  Returns the seconds of the Pedersen CRH and
    compressor gadgets at CURVE_WINDOW."""
    import numpy as np

    from crypto_primitives_tpu_torch.models.crh import PoseidonCRH, Window
    from crypto_primitives_tpu_torch.models.encryption import ElGamal
    from crypto_primitives_tpu_torch.models.merkle_tree import Path
    from crypto_primitives_tpu_torch.models.merkle_tree.device import pedersen_device_tree, sha256_device_tree
    from crypto_primitives_tpu_torch.models.signature import Schnorr
    from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377
    from crypto_primitives_tpu_torch.ops.field import FieldSpec
    from crypto_primitives_tpu_torch.ops.sha256 import sha256
    from crypto_primitives_tpu_torch.r1cs import ConstraintSystem, FpVar
    from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.gadgets.curve import TEAffineVar
    from crypto_primitives_tpu_torch.r1cs.gadgets.elgamal import ElGamalEncGadget
    from crypto_primitives_tpu_torch.r1cs.gadgets.merkle import BytePathVar, PathVar, PointPathVar
    from crypto_primitives_tpu_torch.r1cs.gadgets.pedersen import (
        BoweHopwoodCRHGadget,
        PedersenCRHGadget,
        PedersenTwoToOneCRHGadget,
    )
    from crypto_primitives_tpu_torch.r1cs.gadgets.poseidon import PoseidonCRHGadget, PoseidonTwoToOneCRHGadget
    from crypto_primitives_tpu_torch.r1cs.gadgets.sha256 import DigestVar, Sha256CRHGadget, Sha256TwoToOneCRHGadget
    from crypto_primitives_tpu_torch.r1cs.gadgets.signature import SchnorrRandomizePkGadget
    from crypto_primitives_tpu_torch.r1cs.snark import BooleanInputVar
    from crypto_primitives_tpu_torch.r1cs.snark_gadget import MockLinSNARK, MockLinSNARKGadget, MockProof, MockProofVar
    from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s

    FR = cfg.field
    timed, native, checked = calls.timed, calls.native, calls.checked

    # -- Poseidon membership: GADGET_PATHS paths of phase 4's tree, one tampered leaf
    n_leaves = int(pos_tree.leaf_digests.shape[0])
    bad = R1CS_TAMPERED % GADGET_PATHS
    idx = torch.randperm(n_leaves, generator=torch.Generator().manual_seed(SEED))[:GADGET_PATHS].to("cuda")

    def native_paths():
        leaf_sib, auth = pos_tree.proof_rows(idx)
        vals = FR.unpack(torch.cat([leaf_sib.unsqueeze(1), auth], dim=1).cpu())  # one copy to the host
        return leaf_sib, auth, [Path(int(v[0]), [int(x) for x in v[1:]], i) for v, i in zip(vals, idx.tolist())]

    (leaf_sib, auth, paths), t_paths = timed(
        f"Poseidon paths: proof_rows of {GADGET_PATHS} leaves, one copy to the host", native_paths)
    leaf_rows = pos_leaves[idx].clone()
    leaf_rows[bad] = pos_leaves[(idx[bad] + 1) % n_leaves]  # a wrong leaf in one instance
    want = [i != bad for i in range(GADGET_PATHS)]

    def synth_poseidon():
        bcs = BatchConstraintSystem(FR, GADGET_PATHS, device="cuda")
        pv = PathVar.new_witness_batch(bcs, paths)
        root = FpVar.new_input(bcs, pos_tree.root_row().expand(GADGET_PATHS, -1))
        ok = pv.verify_membership(PoseidonCRHGadget(cfg), PoseidonTwoToOneCRHGadget(cfg), root,
                                  [FpVar.new_witness(bcs, leaf_rows)])
        return bcs, ok

    (bcs, ok), t_synth = timed(
        f"Poseidon membership: synthesis of {GADGET_PATHS} instances (the field tier on the card)", synth_poseidon)
    native_ok = native(f"Poseidon membership: the native check of {GADGET_PATHS} paths (verify_rows_batch)",
                       lambda: pos_tree.verify_rows_batch(
                           pos_tree.root_row(),
                           PoseidonCRH(FR).evaluate_batch(cfg, leaf_rows.unsqueeze(-2), device="cuda"),
                           idx, leaf_sib, auth),
                       ["poseidon_permute"])
    require(ok.value.tolist() == native_ok.tolist() == want,
            f"Poseidon membership: ok == the native check on every instance; instance {bad} alone false")
    torch.cuda.reset_peak_memory_stats()
    sat, t_check = timed("Poseidon membership: satisfied_per_instance (the Montgomery check)",
                         lambda: bcs.satisfied_per_instance())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(bool(sat.all()), "Poseidon membership: every instance satisfied (Ok(false) for the wrong leaf)")
    ok.fp.enforce_equal(FpVar.constant(bcs, 1))
    first, _ = timed("Poseidon membership: which_unsatisfied with ok enforced (the Montgomery check)",
                     lambda: bcs.which_unsatisfied())
    require((first < 0).tolist() == want, f"Poseidon membership: with ok enforced, instance {bad} alone fails")

    def scalar_poseidon():
        scs = ConstraintSystem(FR)
        sok = PathVar.new_witness(scs, paths[bad]).verify_membership(
            PoseidonCRHGadget(cfg), PoseidonTwoToOneCRHGadget(cfg), FpVar.new_input(scs, pos_tree.root()),
            [FpVar.new_witness(scs, int(FR.unpack(leaf_rows[bad].cpu())))])
        sok.fp.enforce_equal(FpVar.constant(scs, 1))
        return scs, scs.which_unsatisfied()

    (scs, host_first), _ = timed(f"Poseidon membership: instance {bad} on the scalar tier and its which_unsatisfied",
                                 scalar_poseidon)
    require((scs.num_constraints, scs.num_witness) == (bcs.num_constraints, bcs.num_witness),
            "Poseidon membership: constraint and witness counts == the scalar tier's")
    require(first.tolist() == [-1 if i != bad else host_first for i in range(GADGET_PATHS)],
            f"Poseidon membership: which_unsatisfied names constraint {host_first} for instance {bad}, as the host does")
    log(f"  Poseidon membership, depth {len(paths[0].auth_path) + 1}: {bcs.num_constraints} constraints, "
        f"{bcs.num_witness} witnesses, {GADGET_PATHS} instances; paths {t_paths:.3f} s, synthesis {t_synth:.3f} s, "
        f"Montgomery check {t_check:.3f} s (peak {peak:.2f} GiB); instance {bad} (a wrong leaf) alone false, and "
        f"alone failing at constraint {host_first} once ok is enforced, on the card and the host")
    del bcs, ok, first

    # -- SHA-256 byte membership: BYTE_PATHS paths of an 8-leaf tree, one wrong root byte
    sleaves = torch.randint(0, 256, (BYTE_TREE_LEAVES, 32), dtype=torch.uint8, device="cuda", generator=gen)
    stree = native("SHA-256 tree of 8 leaves: build", lambda: sha256_device_tree(sleaves, device="cuda"),
                   ["sha256_compress"])
    sidx = torch.arange(BYTE_PATHS, device="cuda") % BYTE_TREE_LEAVES
    s_sib, s_auth = stree.proof_rows(sidx)
    sib_np, auth_np, sidx_np = s_sib.cpu().numpy(), s_auth.cpu().numpy(), sidx.tolist()
    spaths = [Path(sib_np[i].tobytes(), [a.tobytes() for a in auth_np[i]], sidx_np[i])
              for i in range(BYTE_PATHS)]
    sbad = bad % BYTE_PATHS
    roots = np.tile(np.frombuffer(stree.root(), dtype=np.uint8), (BYTE_PATHS, 1))
    roots[sbad, 0] ^= 1
    sleaves_np = sleaves.cpu().numpy()[sidx_np]

    def synth_sha():
        bcs = BatchConstraintSystem(FR, BYTE_PATHS, device="cuda")
        pv = BytePathVar.new_witness_batch(bcs, spaths)
        ok = pv.verify_membership(Sha256CRHGadget(), Sha256TwoToOneCRHGadget(),
                                  DigestVar(bcs, bytes_to_uint8s(bcs, roots, "input")),
                                  bytes_to_uint8s(bcs, sleaves_np, "witness"))
        return bcs, ok

    (bcs, ok), t_synth = timed(f"SHA-256 byte membership: host synthesis of {BYTE_PATHS} instances", synth_sha)
    native_ok = native(f"SHA-256 byte membership: the native check of {BYTE_PATHS} paths (verify_rows_batch)",
                       lambda: stree.verify_rows_batch(stree.root_row(), sha256(sleaves[sidx], device="cuda"), sidx,
                                                       s_sib, s_auth),
                       ["sha256_compress"])
    swant = [i != sbad for i in range(BYTE_PATHS)]
    require(bool(native_ok.all()) and np.asarray(ok.value).tolist() == swant,
            f"SHA-256 byte membership: every native path verifies; ok false for instance {sbad} (a wrong root byte) "
            f"alone")
    sat, t_first = timed("SHA-256 byte membership: satisfied_per_instance (int64 small-domain check; first)",
                         lambda: bcs.satisfied_per_instance())
    require(bool(sat.all()), "SHA-256 byte membership: every instance satisfied (Ok(false) for the wrong root)")
    ok.fp.enforce_equal(FpVar.constant(bcs, 1))
    per, t_check = timed("SHA-256 byte membership: satisfied_per_instance with ok enforced",
                         lambda: bcs.satisfied_per_instance())
    require(per.tolist() == swant, f"SHA-256 byte membership: with ok enforced, instance {sbad} alone fails")
    log(f"  SHA-256 byte membership, {BYTE_TREE_LEAVES}-leaf tree: {bcs.num_constraints} constraints, "
        f"{bcs.num_witness} witnesses, {BYTE_PATHS} instances; synthesis {t_synth:.3f} s, small-domain check "
        f"{t_first:.3f} s first and {t_check:.3f} s with ok enforced; instance {sbad} alone false and alone failing")
    del bcs, ok, per

    # -- the Pedersen point path (scalar): a 4-leaf JubJub tree with phase 5's parameters
    curve, leaf_params, two_params, leaf_window, two_window = pedersen_tree
    pleaves = torch.randint(0, 256, (POINT_TREE_LEAVES, 8), dtype=torch.uint8, device="cuda", generator=gen)
    ptree = native(f"Pedersen tree of {POINT_TREE_LEAVES} leaves over JubJub: build",
                   lambda: pedersen_device_tree(curve, leaf_params, two_params, leaf_window, two_window, pleaves,
                                                device="cuda"),
                   ["msm_te"])
    proot, pindex = ptree.root(), POINT_TREE_LEAVES - 1

    def synth_point():
        cs = ConstraintSystem(curve.base)
        pv = PointPathVar.new_witness(cs, curve, ptree.generate_proof(pindex))
        ok = pv.verify_membership(leaf_params, two_params, PedersenCRHGadget(curve, leaf_window),
                                  PedersenTwoToOneCRHGadget(curve, two_window), TEAffineVar.new_input(cs, curve, proot),
                                  bytes_to_uint8s(cs, pleaves[pindex].cpu().numpy().tobytes(), "witness"))
        ok.fp.enforce_equal(FpVar.constant(cs, 1))
        return cs, ok

    (cs, ok), _ = timed("Pedersen point path: host synthesis", synth_point)
    require(ok.value is True and checked("Pedersen point path", cs) is True,
            "Pedersen point path: membership true and the circuit satisfied on the card")
    y_input = cs._instance_vars[1]  # the root input: x, then y
    cs.assignments[y_input] = (cs.assignments[y_input] + 1) % curve.base.p
    require(checked("Pedersen point path, the root's y + 1", cs) is False,
            "Pedersen point path: the root input's y changed by one fails on the card")

    # -- the curve gadgets against their batch twins on ed-on-bls12-377
    ed = ED_ON_BLS12_377
    crng = random.Random(SEED + 10)
    eg = ElGamal(ed)
    eparams = eg.setup(crng)
    epk, _ = eg.keygen(eparams, crng)
    msgs = [ed.rand_point(crng) for _ in range(ELGAMAL_ROWS)]
    rs = [eg.rand_randomness(crng) for _ in range(ELGAMAL_ROWS)]
    cts = native(f"ElGamal encrypt_batch, {ELGAMAL_ROWS} messages", lambda: eg.encrypt_batch(eparams, epk, msgs, rs,
                                                                                             device="cuda"),
                 ["msm_te"])
    cs = ConstraintSystem(ed.base)
    g = ElGamalEncGadget(ed)
    out, _ = timed("ElGamalEncGadget: host synthesis", lambda: g.encrypt(
        cs, eparams, TEAffineVar.new_witness(cs, ed, msgs[0]), g.randomness_bits(cs, rs[0]),
        TEAffineVar.new_witness(cs, ed, epk)))
    require(out.value == tuple(cts[0]) == eg.encrypt(eparams, epk, msgs[0], rs[0]),
            "ElGamalEncGadget == encrypt_batch's row 0 == the host encrypt")
    require(checked("ElGamalEncGadget", cs) is True, "ElGamalEncGadget: satisfied on the card")

    scheme = Schnorr(ed)
    sparams = scheme.setup(crng)
    spk, _ = scheme.keygen(sparams, crng)
    randomness = bytes(crng.randrange(256) for _ in range(32))
    cs = ConstraintSystem(ed.base)
    out, _ = timed("SchnorrRandomizePkGadget: host synthesis", lambda: SchnorrRandomizePkGadget(ed).randomize(
        cs, sparams, TEAffineVar.new_witness(cs, ed, spk), bytes_to_uint8s(cs, randomness)))
    require(out.value == scheme.randomize_public_key(sparams, spk, randomness),
            "SchnorrRandomizePkGadget == the host randomize_public_key")
    require(checked("SchnorrRandomizePkGadget", cs) is True, "SchnorrRandomizePkGadget: satisfied on the card")

    window = Window(*CURVE_WINDOW)
    t_pedersen = pedersen_gadgets(calls, window, window.window_size * window.num_windows // 8, gen)
    bh_xs = native(f"Bowe-Hopwood CRH evaluate_batch, window {BH_WINDOW}, {SAMPLE} rows",
                   lambda: bh.evaluate_batch(bh_params, bh_inputs[:SAMPLE], device="cuda"), ["msm_te"])
    cs = ConstraintSystem(ed.base)
    out, _ = timed("BoweHopwoodCRHGadget: host synthesis", lambda: BoweHopwoodCRHGadget(
        ed, Window(*BH_WINDOW)).evaluate(cs, bh_params, bytes_to_uint8s(cs, bh_inputs[0].cpu().numpy().tobytes())))
    require(out.value == int(ed.base.unpack(bh_xs[0].cpu())), "BoweHopwoodCRHGadget == its batch twin's row 0")
    require(checked("BoweHopwoodCRHGadget", cs) is True, "BoweHopwoodCRHGadget: satisfied on the card")

    # -- the MockLinSNARK verifier circuit over BLS12-381 Fr
    f = FieldSpec("m61", 2 ** 61 - 1)
    snark = MockLinSNARK(f)
    srng = random.Random(SEED + 11)
    pk, vk = snark.circuit_specific_setup(SNARK_INPUTS, srng)
    x = [srng.randrange(f.p) for _ in range(SNARK_INPUTS)]
    proof = snark.prove(pk, x)
    for tampered in (False, True):
        p = MockProof((proof.s + 1) % f.p) if tampered else proof
        cs = ConstraintSystem(FR)
        verdict = MockLinSNARKGadget.verify(MockLinSNARKGadget.VerifyingKeyVar.new_variable(cs, vk),
                                            BooleanInputVar.new_input(cs, x, f), MockProofVar.new_variable(cs, p, f=f))
        name = f"MockLinSNARKGadget verify, {SNARK_INPUTS} inputs{', a tampered proof' if tampered else ''}"
        require(verdict.value is (not tampered) and snark.verify(vk, x, p) is (not tampered),
                f"{name}: the circuit's verdict == the native verify")
        require(checked(name, cs) is True, f"{name}: satisfied on the card")
    return t_pedersen


def sharded_phase(cfg, sha_leaves, sha_tree, pos_leaves, pos_tree, msm_inputs, launches, gen):
    """Phase 12: ``parallel/`` on the card over NCCL at world size 1 (one
    process, one card), each call driven through the kernels and held
    against phase 4's trees and phase 5's sums; the host engine's Poseidon
    and MSMs against the kernels' outputs.  The group is made here and
    destroyed at the end; a collective that fails, fails the phase."""
    import os
    import threading

    import torch.distributed as dist

    from crypto_primitives_tpu_torch.models.crh.pedersen import bytes_to_bits_batch
    from crypto_primitives_tpu_torch.models.merkle_tree.device import (
        poseidon_tree_fns,
        sha256_device_tree,
        sha256_tree_fns,
    )
    from crypto_primitives_tpu_torch.native import engine
    from crypto_primitives_tpu_torch.ops import poseidon_kernel
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
    from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, ED_ON_BLS12_377
    from crypto_primitives_tpu_torch.parallel import mesh as pmesh
    from crypto_primitives_tpu_torch.parallel import (
        make_mesh,
        sharded_fixed_base_msm,
        sharded_fixed_base_msm_sw,
        sharded_merkle_build_prove_all,
        sharded_merkle_tree,
        sharded_multipath_verify_rows,
        sharded_permute_batch,
    )

    builder = threading.Thread(target=engine.load)  # g++ on the host while the card works
    builder.start()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: NCCL's bootstrap on loopback
    dev = torch.device("cuda", torch.cuda.current_device())
    t = time.time()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    mesh = make_mesh(1)
    log(f"  process group: {dist.get_backend()}, world size {dist.get_world_size()}, mesh {mesh.shape} "
        f"({time.time() - t:.2f} s)")
    summary = []

    def call(name, fn, needs):
        """A sharded path through drive(); its collectives and their seconds."""
        pmesh.gathers, pmesh.gather_seconds = 0, 0.0
        t = time.time()
        out, counts = drive(name, fn, needs)
        summary.append((name, time.time() - t, pmesh.gathers, pmesh.gather_seconds))
        for k in needs:
            launches[k] += counts[k]
        return out

    # -- the 2^20-leaf trees: root and every leaf's path against phase 4's
    n = sha_leaves.shape[0]
    idx = torch.arange(n, device=dev)
    leaf_hash, compress, level, convert = sha256_tree_fns()
    p_leaf, p_compress, p_level = poseidon_tree_fns(cfg)
    for name, single, build, need in (
        ("SHA-256", sha_tree, lambda: sharded_merkle_build_prove_all(
            leaf_hash, compress, sha_leaves, mesh, leaf_convert=convert, compress_level_batch=level),
         "sha256_compress"),
        ("Poseidon", pos_tree, lambda: sharded_merkle_build_prove_all(
            p_leaf, p_compress, pos_leaves, mesh, compress_level_batch=p_level), "poseidon_permute"),
    ):
        root, sib, auth = call(f"sharded {name} tree: build and prove all, {n} leaves", build, [need])
        require(torch.equal(root, single.root_row()), f"the sharded {name} root == phase 4's")
        sib1, auth1 = single.proof_rows(idx)
        require(torch.equal(sib, sib1), f"the sharded {name} leaf siblings == phase 4's proof_rows, all {n}")
        del sib, sib1
        require(torch.equal(auth, auth1), f"the sharded {name} auth paths == phase 4's proof_rows, all {n}")
        del auth, auth1
        log(f"  sharded {name} tree: root and all {n} auth paths equal phase 4's")

    # -- ShardedMerkleTree: update, verify every path, multipath
    tree = call(f"ShardedMerkleTree (SHA-256): build, {n} leaves", lambda: sharded_merkle_tree(
        leaf_hash, compress, sha_leaves, mesh, leaf_convert=convert, compress_level_batch=level), ["sha256_compress"])
    upd = torch.randperm(n, device=dev, generator=gen)[:CHECK_ROWS].tolist()
    new_digests = leaf_hash(torch.randint(0, 256, (CHECK_ROWS, 32), dtype=torch.uint8, device=dev, generator=gen))
    call(f"ShardedMerkleTree: update_batch, {CHECK_ROWS} leaves", lambda: tree.update_batch(upd, new_digests),
         ["sha256_compress"])
    single = sha256_device_tree(sha_leaves, device=dev)
    single.update_batch(upd, new_digests)
    require(torch.equal(tree.root_row, single.root_row()), "the updated sharded root == the single-device tree's")
    del single

    def verify_all():
        s, a = tree.proof_rows(idx)
        ok = tree.verify_rows_batch(tree.root_row, tree.leaf_digests, idx, s, a)
        bad = tree.verify_rows_batch(torch.zeros_like(tree.root_row), tree.leaf_digests[:64], idx[:64], s[:64],
                                     a[:64])
        return bool(ok.all()), bool(bad.any())

    ok, bad = call(f"ShardedMerkleTree: proof_rows and verify_rows_batch, all {n} paths, and a wrong root",
                   verify_all, ["sha256_compress"])
    require(ok, f"every one of the {n} sharded auth paths verifies")
    require(not bad, "a wrong root is rejected by the sharded verify")
    sel = torch.randperm(n, device=dev, generator=gen)[:CHECK_ROWS].sort().values

    def multipath():
        ms, ma = tree.proof_rows(sel)
        lds = tree.leaf_digests[sel]
        wrong = tree.root_row.clone()
        wrong[0] ^= 1
        return [bool(sharded_multipath_verify_rows(compress, convert, root, lds, sel.tolist(), ms, ma, mesh))
                for root in (tree.root_row, wrong)]

    good, bad = call(f"sharded multipath verify, {CHECK_ROWS} leaves, right and wrong root", multipath,
                     ["sha256_compress"])
    require(good and not bad, f"the sharded multipath verify over {CHECK_ROWS} leaves: true, then false")

    # -- the data-parallel permutation at K1's timed shape (phase 6's states)
    half, W = n // 2, pos_tree.leaf_digests.shape[1]
    pstates = torch.cat([torch.zeros((half, 1, W), dtype=torch.int32, device=dev),
                         pos_tree.leaf_digests.reshape(half, 2, W)], dim=1).contiguous()
    got = call(f"sharded permute, {half} states", lambda: sharded_permute_batch(cfg, pstates, mesh),
               ["poseidon_permute"])
    require(torch.equal(got, poseidon_kernel.permute(cfg, pstates)), "sharded_permute_batch == poseidon_permute")
    del got, pstates

    # -- the sharded fixed-base MSMs at phase 5's width: the first 1024
    # generators of the 250 x 8 window, phase 5's 128-byte inputs
    builder.join()
    for curve, fn, kname in ((ED_ON_BLS12_377, sharded_fixed_base_msm, "msm_te"),
                             (BLS12_381_G1, sharded_fixed_base_msm_sw, "msm_sw")):
        params, inputs = msm_inputs[curve.name]
        mod = fast_mod(curve)
        bits = bytes_to_bits_batch(inputs)
        points = [g for win in params.generators for g in win][:bits.shape[-1]]
        shape = f"{bits.shape[0]} rows x {len(points)} points"
        out = call(f"sharded fixed-base MSM, {curve.name}, {shape}", lambda: fn(curve, points, bits, mesh), [kname])
        t = time.time()
        fn(curve, points, bits, mesh)
        torch.cuda.synchronize()
        log(f"  again, its grouped table cached: {time.time() - t:.3f} s")
        got = mod.to_affine(curve, out)
        want = mod.to_affine(curve, mod.conditional_sum_grouped_auto(curve, params, bits, 3))
        require(torch.equal(got, want), f"the sharded MSM on {curve.name} == conditional_sum_grouped_auto, affine")
        sample = torch.randperm(bits.shape[0], generator=torch.Generator().manual_seed(SEED))[:SAMPLE]
        eng = engine.curve_engine(curve)
        host = eng.msm_bits(eng.pack_table(points), bits[sample].cpu().numpy())
        require(affine_host(curve, got[sample]) == [(0, 0) if h is None else h for h in host],
                f"the engine's msm_bits == the sharded {kname} output on {SAMPLE} rows of {curve.name}")
        log(f"  {curve.name}: affine-equal to conditional_sum_grouped_auto on all {bits.shape[0]} rows; "
            f"{SAMPLE} rows equal to the host engine's msm_bits")

    # -- the host engine's Poseidon against K1's tree level
    built = "built before" if engine.build_seconds is None else f"g++ build {engine.build_seconds:.2f} s"
    log(f"  host engine (native/cpmont.cpp): {built}")
    lower, upper = pos_tree.inner_levels[-1], pos_tree.inner_levels[-2]
    j = torch.randperm(upper.shape[0], device=dev, generator=gen)[:ENGINE_PAIRS]
    words = engine.poseidon_engine(cfg).two_to_one_words(lower[2 * j], lower[2 * j + 1])
    require(torch.equal(torch.from_numpy(words), upper[j].cpu()),
            f"the engine's Poseidon two-to-one == K1's tree level on {ENGINE_PAIRS} pairs")
    log(f"  host engine: Poseidon two-to-one on {ENGINE_PAIRS} pairs of the Poseidon tree's bottom inner level "
        "equals K1's next level")

    dist.destroy_process_group()
    log("  phase 12 calls (host clock, ending in a synchronize; collectives and their seconds):")
    for name, dt, ngather, gsec in summary:
        log(f"    {name}: {dt:.3f} s; {ngather} collectives, {gsec:.4f} s")


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 1

    from crypto_primitives_tpu_torch.models.commitment import PedersenCommitment, PedersenCommitmentCompressor
    from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodCRH
    from crypto_primitives_tpu_torch.models.crh.injective_map import PedersenCRHCompressor
    from crypto_primitives_tpu_torch.models.crh.pedersen import bytes_to_bits_batch
    from crypto_primitives_tpu_torch.models.crh import (
        PedersenCRH,
        PedersenTwoToOneCRH,
        PoseidonCRH,
        PoseidonTwoToOneCRH,
        Window,
    )
    from crypto_primitives_tpu_torch.models.merkle_tree import (
        FieldDigestDomain,
        IdentityDigestConverter,
        MerkleTreeConfig,
        PointDigestDomain,
        PointToBytesDigestConverter,
    )
    from crypto_primitives_tpu_torch.models.merkle_tree.device import (
        pedersen_device_tree,
        poseidon_device_tree,
        sha256_device_tree,
    )
    from crypto_primitives_tpu_torch.models.sponge import (
        PoseidonConfig,
        PoseidonSpongeBatch,
        find_poseidon_ark_and_mds,
        get_default_poseidon_parameters,
    )
    from crypto_primitives_tpu_torch.native import build
    from crypto_primitives_tpu_torch.ops import affine_kernel, curve_fast, curve_sw_fast, msm_kernel, msm_sw_kernel
    from crypto_primitives_tpu_torch.ops import field_probe, fields_known, poseidon_kernel, sha256_kernel
    from crypto_primitives_tpu_torch.ops.curve_fast_any import fast_mod
    from crypto_primitives_tpu_torch.ops.curves_known import (
        BLS12_381_G1,
        ED25519,
        ED_ON_BLS12_377,
        JUBJUB,
        PALLAS,
        SECP256R1,
    )
    from crypto_primitives_tpu_torch.ops.fields_known import ALL_FIELDS, BLS12_381_FQ, BLS12_381_FR as FR
    from crypto_primitives_tpu_torch.ops.sha256 import sha256

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    pyrng = random.Random(SEED)

    with Phase("phase 0: device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        log(f"device: {kind}; count {torch.cuda.device_count()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        log(smi_line)

    with Phase("phase 1: build"):
        t = time.time()
        paths = build.build()
        build_s = time.time() - t
        for name in paths:
            log_lines = (build.BUILD_DIR / f"{name}.log").read_text().splitlines() \
                if (build.BUILD_DIR / f"{name}.log").exists() else []
            for line in log_lines:
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()[:140]}")
            build.load(name)
        log(f"build seconds: {build_s:.2f} (budget 90)")
        mix = build.sass_mix()
        log(f"  SASS of one mont_mul<8> (csrc/field.cuh, in a load-multiply-store kernel): "
            f"{mix if mix is not None else 'cuobjdump not found'}")
        mix = build.sha256_sass()
        log(f"  SASS of one SHA-256 block (csrc/sha256_compress.cu, in a load-compress-store kernel): "
            f"{mix if mix is not None else 'cuobjdump not found'}")

    with Phase("phase 2: known answers"):
        cfg = get_default_poseidon_parameters(FR, 2, False)
        sponge = PoseidonSpongeBatch(cfg, batch_shape=(4,), device="cuda")
        sponge.absorb(torch.from_numpy(FR.pack([[0, 1, 2]] * 4)).cuda())
        out = FR.unpack(sponge.squeeze_native_field_elements(3).cpu())
        for row in out:
            require([int(v) for v in row] == POSEIDON_PINNED, "pinned Poseidon sponge vector")
        for n in (0, 32, 55, 56, 64, 119, 120, 200):
            msg = bytes(range(32)) if n == 32 else bytes((7 * i + n) & 0xFF for i in range(n))
            got = sha256(torch.tensor(list(msg), dtype=torch.uint8).reshape(1, n), device="cuda")
            require(bytes(got[0].cpu().numpy()) == hashlib.sha256(msg).digest(), f"SHA-256 of {n} bytes")
        torch.cuda.synchronize()
        log("pinned Poseidon vector and SHA-256 known answers: ok")

    errs = dict.fromkeys(KERNELS, 0.0)
    with Phase("phase 3: kernels against plain versions"):
        configs = []
        for spec in ALL_FIELDS:
            if spec is FR:
                configs.append(cfg)
            else:  # the rate-2 shape of the BLS12-381 Fr table
                ark, mds = find_poseidon_ark_and_mds(spec, 2, 8, 31, 0)
                configs.append(PoseidonConfig(spec, 8, 31, 17, ark, mds, 2, 1))
        ark, mds = find_poseidon_ark_and_mds(BLS12_381_FQ, 2, 8, 60, 0)
        configs.append(PoseidonConfig(BLS12_381_FQ, 8, 60, 5, ark, mds, 2, 1))
        # t = 9 (the <8, 9, 1> build), and an MDS with a singular lower-right
        # block, which runs the trivial (all dense) schedule
        configs.append(get_default_poseidon_parameters(FR, 8, True))
        configs.append(PoseidonConfig(FR, 8, 31, 17, cfg.ark, [[2, 3, 5], [7, 1, 1], [11, 1, 1]], 2, 1))
        for c in configs:
            states = random_elements(c.field, (CHECK_ROWS, c.t), gen)
            states[0] = 0
            states[1] = torch.from_numpy(c.field.pack([c.field.p - 1] * c.t, mont=False)).cuda()
            got = poseidon_kernel.permute(c, states)
            want = poseidon_kernel.permute_plain(c, states)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            errs["poseidon_permute"] = max(errs["poseidon_permute"], err)
            require(torch.equal(got, want), f"poseidon_permute == plain on {c.field.name}")
            log(f"  poseidon_permute {c.field.name} t={c.t} alpha={c.alpha} "
                f"sparse rounds {c.schedule_tables('cpu')[0]}: {CHECK_ROWS} states equal")
        # field.cuh's carry chains on every pair of edge words and 4096 random
        # pairs, at W = 8 (two moduli) and W = 12
        for fname in PROBE_FIELDS:
            spec = getattr(fields_known, fname)
            edges = field_probe.edge_values(spec)
            pairs = [(x, y) for x in edges for y in edges]
            a = torch.cat([torch.from_numpy(spec.pack([x for x, _ in pairs], mont=False)).cuda(),
                           random_elements(spec, (CHECK_ROWS,), gen)])
            b = torch.cat([torch.from_numpy(spec.pack([y for _, y in pairs], mont=False)).cuda(),
                           random_elements(spec, (CHECK_ROWS,), gen)])
            for op in field_probe.OPS:
                got = field_probe.field_ops(spec, op, a, b)
                want = field_probe.field_ops_plain(spec, op, a, b)
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"field probe {op} == plain on {spec.name}")
            log(f"  field probe {spec.name} (W={spec.num_words}): {', '.join(field_probe.OPS)} equal "
                f"on {len(pairs)} edge pairs and {CHECK_ROWS} random pairs")
        for nblocks in (1, 2, 4):
            words = torch.randint(-(1 << 31), 1 << 31, (CHECK_ROWS, nblocks, 16), dtype=torch.int64,
                                  device="cuda", generator=gen).to(torch.int32)
            got = sha256_kernel.compress(words)
            want = sha256_kernel.compress_plain(words)
            torch.cuda.synchronize()
            errs["sha256_compress"] = max(errs["sha256_compress"], max_abs_err(got, want))
            require(torch.equal(got, want), f"sha256_compress == plain, {nblocks} blocks")
            log(f"  sha256_compress {nblocks} blocks: {CHECK_ROWS} messages equal")
        # the byte entry: every length, from a 16-byte boundary (16-byte
        # loads where n allows) and one byte past it (byte loads)
        for n in SHA_LENGTHS:
            flat = torch.randint(0, 256, (CHECK_ROWS * n + 1,), dtype=torch.uint8, device="cuda", generator=gen)
            for off in (0, 1):
                msgs = flat[off:off + CHECK_ROWS * n].view(CHECK_ROWS, n)
                got = sha256_kernel.digest(msgs)
                want = sha256_kernel.digest_plain(msgs)
                torch.cuda.synchronize()
                errs["sha256_compress"] = max(errs["sha256_compress"], max_abs_err(got, want))
                require(torch.equal(got, want), f"sha256 digest == plain, {n} bytes at offset {off}")
        log(f"  sha256 digest, n in {SHA_LENGTHS}, aligned and off by one byte: {CHECK_ROWS} messages equal")
        # every MSM instantiation: TE (W = 8) on three curves; SW W = 8 with
        # a = 0 and a != 0, W = 9 (P-256, a = -3), W = 12 with a = 0, each at
        # its row split.  64 doublings of a random point in groups of 3, the
        # first rows all-zero and all-ones windows.
        for curve, kern in ((JUBJUB, msm_kernel), (ED_ON_BLS12_377, msm_kernel), (ED25519, msm_kernel),
                            (PALLAS, msm_sw_kernel), (BLS12_381_G1, msm_sw_kernel),
                            (general_a_curve(), msm_sw_kernel), (SECP256R1, msm_sw_kernel)):
            pts = [curve.rand_point(pyrng)]
            for _ in range(63):
                pts.append(curve.double_host(pts[-1]))
            table = torch.from_numpy(fast_mod(curve).pack_table_grouped(curve, pts, 3)).cuda()
            idx = torch.randint(0, 8, (CHECK_ROWS, table.shape[0]), dtype=torch.int32, device="cuda", generator=gen)
            idx[0], idx[1] = 0, 7
            got = kern.grouped_msm(curve, table, idx)
            want = kern.grouped_msm_plain(curve, table, idx)
            torch.cuda.synchronize()
            name = "msm_te" if kern is msm_kernel else "msm_sw"
            errs[name] = max(errs[name], max_abs_err(got, want))
            require(torch.equal(got, want), f"{name} == plain on {curve.name}")
            aff, want = affine_kernel.to_affine(curve, got), affine_kernel.to_affine_plain(curve, got)
            errs["curve_affine"] = max(errs["curve_affine"], max_abs_err(aff, want))
            require(torch.equal(aff, want), f"curve_affine == plain on {curve.name}'s {name} sums")
            split = f", k={msm_sw_kernel.split_of(curve)}" if kern is msm_sw_kernel else ""
            log(f"  {name} {curve.name} (W={curve.base.num_words}, a={'0' if curve.a == 0 else 'p-1' if curve.a == curve.base.p - 1 else curve.a - curve.base.p}{split}): "
                f"{CHECK_ROWS} rows x {table.shape[0]} groups equal, and their affine steps")

        # the fixed-base shapes: doubling-power tables of 20 groups (msm_te,
        # below its 32-group index tile) and 84, 85 and 86 groups (G mod 3 =
        # 0, 1, 2: msm_sw's k = 3 ranges of unequal length)
        for curve in (JUBJUB, ED_ON_BLS12_377, BLS12_381_G1, SECP256R1):
            mod = fast_mod(curve)
            kern, name = (msm_kernel, "msm_te") if curve.coords == 4 else (msm_sw_kernel, "msm_sw")
            groups = []
            for nbits in ((60,) if curve.coords == 4 else ()) + (252, 255, 256):
                table = torch.from_numpy(mod.fixed_base_grouped_table(curve, curve.generator, nbits)).cuda()
                bits = torch.randint(0, 2, (CHECK_ROWS, nbits), dtype=torch.uint8, device="cuda", generator=gen)
                bits[0], bits[1] = 0, 1
                table, idx = curve_fast.grouped_operands(table, bits, 3)
                got = kern.grouped_msm(curve, table, idx)
                want = kern.grouped_msm_plain(curve, table, idx)
                torch.cuda.synchronize()
                errs[name] = max(errs[name], max_abs_err(got, want))
                require(torch.equal(got, want), f"{name} == plain on {curve.name}'s fixed-base table, {nbits} bits")
                groups.append(table.shape[0])
            log(f"  {name} {curve.name} fixed-base tables: {CHECK_ROWS} rows x {groups} groups equal")

        # Bowe-Hopwood's signed-digit table (negated points, identity rows
        # past n_real): 342 groups (128-byte inputs), 341 and 20 (partial
        # 32-group index tiles)
        bh = BoweHopwoodCRH(ED_ON_BLS12_377, Window(*BH_WINDOW))
        bh_params = bh.setup(random.Random(SEED + 9))
        for groups in (20, 341, 342):
            table = bh_params.device_signed_table(groups, torch.device("cuda"))
            bits = torch.randint(0, 2, (CHECK_ROWS, 3 * groups), dtype=torch.uint8, device="cuda", generator=gen)
            bits[0], bits[1] = 0, 1
            table, idx = curve_fast.grouped_operands(table, bits, 3)
            got = msm_kernel.grouped_msm(ED_ON_BLS12_377, table, idx)
            want = msm_kernel.grouped_msm_plain(ED_ON_BLS12_377, table, idx)
            torch.cuda.synchronize()
            errs["msm_te"] = max(errs["msm_te"], max_abs_err(got, want))
            require(torch.equal(got, want), f"msm_te == plain on the signed-combos table, {groups} groups")
        log(f"  msm_te ed_on_bls12_377 Bowe-Hopwood signed-combos table: {CHECK_ROWS} rows x 20, 341, 342 groups equal")

    launches = dict.fromkeys(KERNELS, 0)
    with Phase("phase 4: hashing paths at 2^20 leaves"):
        torch.cuda.reset_peak_memory_stats()
        leaves = torch.randint(0, 256, (LEAVES, 32), dtype=torch.uint8, device="cuda", generator=gen)
        idx = torch.arange(LEAVES, device="cuda")
        sel = torch.randperm(LEAVES, device="cuda", generator=gen)[:CHECK_ROWS].sort().values

        def sha_build():
            tree = sha256_device_tree(leaves, device="cuda")
            torch.cuda.synchronize()
            return tree

        sha_tree, counts = drive("SHA-256 tree: build", sha_build, ["sha256_compress"])
        launches["sha256_compress"] += counts["sha256_compress"]
        hashed_levels = 1 + len(sha_tree.inner_levels)  # the leaves, then every inner level
        require(counts["sha256_compress"] == hashed_levels,
                f"the SHA-256 build launches its kernel once per hashed level ({hashed_levels})")

        def sha_verify():
            leaf_sib, auth = sha_tree.proof_rows(idx)
            ok = sha_tree.verify_rows_batch(sha_tree.root_row(), sha_tree.leaf_digests, idx, leaf_sib, auth)
            require(bool(ok.all()), "every SHA-256 auth path verifies")
            bad = sha_tree.verify_rows_batch(torch.zeros_like(sha_tree.root_row()), sha_tree.leaf_digests[:64],
                                             idx[:64], leaf_sib[:64], auth[:64])
            require(not bool(bad.any()), "a wrong SHA-256 root is rejected")
            del leaf_sib, auth, ok
            m_sib, m_auth = sha_tree.proof_rows(sel)
            require(bool(sha_tree.multipath_verify_rows(sha_tree.root_row(), sha_tree.leaf_digests[sel],
                                                        sel.tolist(), m_sib, m_auth)),
                    "SHA-256 multipath verify over 4096 leaves")

        _, counts = drive("SHA-256 tree: verify all, wrong root, multipath", sha_verify, ["sha256_compress"])
        launches["sha256_compress"] += counts["sha256_compress"]
        t = time.time()
        host_root = host_sha_root(leaves.cpu().numpy())
        require(sha_tree.root() == host_root, "SHA-256 device root == hashlib root")
        log(f"  sha256 root {host_root.hex()} == hashlib build ({time.time() - t:.2f} s on the host)")

        pleaves = random_elements(FR, (LEAVES,), gen)
        pos_leaves = pleaves  # phase 10 proves membership of these leaves
        pos_tree, counts = drive("Poseidon tree: build",
                                 lambda: poseidon_device_tree(FR, cfg, pleaves, device="cuda"),
                                 ["poseidon_permute"])
        launches["poseidon_permute"] += counts["poseidon_permute"]
        mc = MerkleTreeConfig(PoseidonCRH(FR), PoseidonTwoToOneCRH(FR), FieldDigestDomain(FR),
                              FieldDigestDomain(FR), IdentityDigestConverter())
        root = pos_tree.root()
        picks = torch.randint(0, LEAVES, (64,), device="cuda", generator=gen).tolist()
        for i in picks:
            leaf = int(FR.unpack(pleaves[i].cpu()))
            require(pos_tree.generate_proof(i).verify(mc, cfg, cfg, root, [leaf]),
                    f"Poseidon auth path {i} reaches the device root on the host sponge")
        log(f"  poseidon root {root}: 64 auth paths verified by the host sponge")
        log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    breakdown = {}
    with Phase("phase 5: curve paths at full width"):
        torch.cuda.reset_peak_memory_stats()
        window = Window(*PEDERSEN_WINDOW)
        main_shapes, affine_shapes, msm_inputs = {}, {}, {}
        for curve, rows, kname in ((ED_ON_BLS12_377, TE_ROWS, "msm_te"), (BLS12_381_G1, SW_ROWS, "msm_sw")):
            t = time.time()
            crh = PedersenCRH(curve, window)
            params = crh.setup(random.Random(SEED))
            com = PedersenCommitment(curve, window)
            cparams = com.setup(random.Random(SEED + 1))
            params.packed_grouped(), cparams.packed_grouped(), cparams.crh_params().packed_grouped()
            log(f"  {curve.name}: setup and grouped tables on the host {time.time() - t:.2f} s")
            inputs = torch.randint(0, 256, (rows, PEDERSEN_BYTES), dtype=torch.uint8, device="cuda", generator=gen)
            digests, counts = drive(f"Pedersen CRH evaluate_batch, {curve.name}, {rows} rows",
                                    lambda: crh.evaluate_batch(params, inputs), [kname, "curve_affine"])
            launches[kname] += counts[kname]
            launches["curve_affine"] += counts["curve_affine"]
            sample = torch.randperm(rows, generator=torch.Generator().manual_seed(SEED))[:SAMPLE]
            host = [crh.evaluate(params, bytes(inputs[i].cpu().numpy())) for i in sample.tolist()]
            require(affine_host(curve, digests[sample]) == [(0, 0) if h is None else h for h in host],
                    f"{SAMPLE} CRH rows == host evaluate on {curve.name}")
            log(f"  {SAMPLE} sampled CRH digests equal the host evaluate")

            scalars = [com.rand_randomness(pyrng) for _ in range(rows)]
            rbits = torch.from_numpy(com.randomness_to_bits(scalars)).cuda()
            comms, counts = drive(f"Pedersen commit_batch, {curve.name}, {rows} rows",
                                  lambda: com.commit_batch(cparams, inputs, rbits), [kname, "curve_affine"])
            launches[kname] += counts[kname]
            launches["curve_affine"] += counts["curve_affine"]
            host = [com.commit(cparams, bytes(inputs[i].cpu().numpy()), scalars[i]) for i in sample.tolist()]
            require(affine_host(curve, comms[sample]) == [(0, 0) if h is None else h for h in host],
                    f"{SAMPLE} commitments == host commit on {curve.name}")
            log(f"  {SAMPLE} sampled commitments equal the host commit")

            # where the CRH's time goes: the grouped MSM, then the affine step
            mod = fast_mod(curve)
            t = time.time()
            acc = crh.evaluate_batch_projective(params, inputs)
            torch.cuda.synchronize()
            t_msm = time.time() - t
            t = time.time()
            mod.to_affine(curve, acc)
            torch.cuda.synchronize()
            t_aff = time.time() - t
            breakdown[curve.name] = (t_msm, t_aff)
            log(f"  {curve.name} CRH split: grouped MSM step {t_msm:.3f} s, to-affine {t_aff:.3f} s")
            # the CRH's own MSM operands: the table's first ceil(1024 / 3) =
            # 342 of 667 groups, the ones the 128-byte inputs reach
            table, idx = curve_fast.grouped_operands(mod.device_table(params, 3, inputs.device),
                                                     bytes_to_bits_batch(inputs), 3)
            main_shapes[kname] = (curve, table, idx)
            affine_shapes[kname] = (curve, acc)  # phase 6 times the affine step on the CRH's sums
            msm_inputs[curve.name] = (params, inputs)  # phase 12's sharded MSMs
            if curve is ED_ON_BLS12_377:  # phase 8's compressors run on the same inputs
                pedersen_te = (window, params, cparams, inputs, rbits, digests[:, 0].clone(), comms[:, 0].clone())
            del acc, digests, comms

        # the Pedersen Merkle tree (tests/test_merkle_pedersen.py:28-43)
        curve, leaf_window, two_window = JUBJUB, Window(4, 16), Window(4, 256)
        leaf_crh, two = PedersenCRH(curve, leaf_window), PedersenTwoToOneCRH(curve, two_window)
        tree_rng = random.Random(77)
        leaf_params, two_params = leaf_crh.setup(tree_rng), two.setup(tree_rng)
        pleaves = torch.randint(0, 256, (PEDERSEN_LEAVES, 8), dtype=torch.uint8, device="cuda", generator=gen)
        ped_tree, counts = drive(f"Pedersen tree over JubJub: build, {PEDERSEN_LEAVES} leaves",
                                 lambda: pedersen_device_tree(curve, leaf_params, two_params, leaf_window,
                                                              two_window, pleaves), ["msm_te"])
        launches["msm_te"] += counts["msm_te"]
        sel = torch.randperm(PEDERSEN_LEAVES, device="cuda", generator=gen)[:CHECK_ROWS]

        def verify_path():
            leaf_sib, auth = ped_tree.proof_rows(sel)
            ok = ped_tree.verify_rows_batch(ped_tree.root_row(), ped_tree.leaf_digests[sel], sel, leaf_sib, auth)
            bad_root = ped_tree.root_row().clone()
            bad_root[0] ^= 1
            bad = ped_tree.verify_rows_batch(bad_root, ped_tree.leaf_digests[sel[:64]], sel[:64],
                                             leaf_sib[:64], auth[:64])
            return ok, bad

        (ok, bad), counts = drive(f"Pedersen tree: verify {CHECK_ROWS} paths and a wrong root",
                                  verify_path, ["msm_te"])
        launches["msm_te"] += counts["msm_te"]
        require(bool(ok.all()), f"{CHECK_ROWS} Pedersen auth paths verify on the card")
        require(not bool(bad.any()), "a wrong Pedersen root is rejected")
        # the top HOST_TOP levels again on the host, from the device's level below
        t = time.time()
        cur = [ped_tree.to_host(r) for r in ped_tree.inner_levels[HOST_TOP].cpu().numpy()]
        while len(cur) > 1:
            cur = [two.compress(two_params, cur[i], cur[i + 1]) for i in range(0, len(cur), 2)]
        require(cur[0] == ped_tree.root(), "Pedersen root == host recomputation of the top levels")
        pc = MerkleTreeConfig(leaf_crh, two, PointDigestDomain(curve), PointDigestDomain(curve),
                              PointToBytesDigestConverter(curve))
        for i in sel[:16].tolist():
            require(ped_tree.generate_proof(i).verify(pc, leaf_params, two_params, ped_tree.root(),
                                                      bytes(pleaves[i].cpu().numpy())),
                    f"Pedersen auth path {i} verifies on the host")
        log(f"  Pedersen root {ped_tree.root()}: top {HOST_TOP} levels recomputed on the host, "
            f"16 auth paths verified by the host CRHs ({time.time() - t:.2f} s on the host)")
        # where the tree's time goes, on its two largest levels
        for lname, crh_, params_, data in (
            ("leaf level", leaf_crh, leaf_params, pleaves),
            ("first inner level", two.crh, two_params,
             ped_tree.leaf_digests.reshape(PEDERSEN_LEAVES // 2, -1)),
        ):
            t = time.time()
            acc = crh_.evaluate_batch_projective(params_, data)
            torch.cuda.synchronize()
            t_msm = time.time() - t
            t = time.time()
            curve_fast.to_affine(curve, acc)
            torch.cuda.synchronize()
            log(f"  Pedersen tree {lname} ({data.shape[0]} rows): grouped MSM step {t_msm:.3f} s, "
                f"to-affine {time.time() - t:.3f} s")
        log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with Phase("phase 7: signatures and encryption"):
        from crypto_primitives_tpu_torch.models.encryption import ElGamal
        from crypto_primitives_tpu_torch.models.signature import Schnorr

        torch.cuda.reset_peak_memory_stats()
        summary = []

        def step(fn):
            """fn() and its seconds, between two synchronisations."""
            torch.cuda.synchronize()
            t = time.time()
            out = fn()
            torch.cuda.synchronize()
            return out, time.time() - t

        for curve, kname, rows in ((ED_ON_BLS12_377, "msm_te", SIG_ROWS), (BLS12_381_G1, "msm_sw", SIG_ROWS_G1)):
            mod = fast_mod(curve)
            kern = msm_kernel if kname == "msm_te" else msm_sw_kernel
            srng, split_rng = random.Random(SEED + 7), random.Random(SEED + 8)
            sample = sorted(random.Random(SEED).sample(range(rows), SAMPLE))

            def bits_of(scalars):
                return torch.from_numpy(mod.scalars_to_bits(curve, scalars)).cuda()

            def points(pts):
                return torch.from_numpy(mod.pack_points(curve, pts)).cuda()

            def call(path, fn, needs):
                """One entry point, driven with the launch counts reset;
                returns its output, wall seconds and launches."""
                t = time.time()
                out, counts = drive(path, fn, needs)
                launches[kname] += counts[kname]
                launches["curve_affine"] += counts["curve_affine"]
                return out, time.time() - t, counts[kname]

            def record(path, n, wall, nl, msm=0.0, win=0.0, aff=0.0):
                summary.append((f"{path}, {curve.name}", n, wall, msm, win, aff, nl))
                log(f"    steps run again alone: MSM {msm:.3f} s, windowed {win:.3f} s, affine {aff:.3f} s; "
                    f"the rest of the wall time (host) {wall - msm - win - aff:.3f} s")

            scheme = Schnorr(curve)
            params = scheme.setup(srng)
            G = params.generator
            keys, wall, nl = call(f"Schnorr keygen_batch, {curve.name}, {rows} keys",
                                  lambda: scheme.keygen_batch(params, srng, rows), [kname])
            pks, sks = [pk for pk, _ in keys], [sk for _, sk in keys]
            require(all(pks[i] == curve.scalar_mul_host(G, sks[i]) for i in sample),
                    f"{SAMPLE} keygen_batch rows == host keygen on {curve.name}")
            bits = bits_of(sks)
            pts, t_msm = step(lambda: mod.fixed_base_mul(curve, G, bits))
            _, t_aff = step(lambda: mod.unpack_affine(curve, pts))
            record("Schnorr keygen_batch", rows, wall, nl, msm=t_msm, aff=t_aff)

            msg_rows = torch.randint(0, 256, (rows, SIG_MSG_BYTES), dtype=torch.uint8, device="cuda", generator=gen)
            msgs = [row.tobytes() for row in msg_rows.cpu().numpy()]
            sigs, wall, nl = call(f"Schnorr sign_batch, {curve.name}, {rows} messages x 4 candidates",
                                  lambda: scheme.sign_batch(params, sks, msgs, srng), [kname])
            require(all(scheme.verify(params, pks[i], msgs[i], sigs[i]) for i in sample),
                    f"the host verify accepts {SAMPLE} sampled signatures on {curve.name}")
            # the first pass's steps at its shape: 4 candidates a message
            kbits = bits_of([split_rng.randrange(curve.scalar.p) for _ in range(4 * rows)])
            cand, t_msm = step(lambda: mod.fixed_base_mul(curve, G, kbits))
            _, t_aff = step(lambda: mod.unpack_affine(curve, cand))
            record("Schnorr sign_batch (the split: its first pass, 4 candidates a message)", rows, wall, nl,
                   msm=t_msm, aff=t_aff)
            del cand

            ok, wall, nl = call(f"Schnorr verify_batch, {curve.name}, {rows} true signatures",
                                lambda: scheme.verify_batch(params, pks, msgs, sigs), [kname])
            require(ok == [True] * rows, f"every true signature verifies on {curve.name}")
            s_bits = bits_of([x.prover_response for x in sigs])
            e_bits = bits_of([x.verifier_challenge for x in sigs])
            pks_dev = points(pks)
            sg, t_msm = step(lambda: mod.fixed_base_mul(curve, G, s_bits))
            epk, t_win = step(lambda: mod.scalar_mul_bits_windowed(curve, pks_dev, e_bits))
            _, t_aff = step(lambda: mod.unpack_affine(curve, mod.add(curve, sg, epk)))
            record("Schnorr verify_batch", rows, wall, nl, msm=t_msm, win=t_win, aff=t_aff)
            del sg, epk
            altered = [bytes([m[0] ^ 1]) + m[1:] if i % 16 == 0 else m for i, m in enumerate(msgs)]
            bad, wall, nl = call(f"Schnorr verify_batch, {curve.name}, every 16th message altered",
                                 lambda: scheme.verify_batch(params, pks, altered, sigs), [kname])
            require(bad == [i % 16 != 0 for i in range(rows)], f"exactly the altered messages fail on {curve.name}")
            require(all(bad[i] == scheme.verify(params, pks[i], altered[i], sigs[i]) for i in sample),
                    f"{SAMPLE} verify_batch rows == host verify on {curve.name}")
            summary.append((f"Schnorr verify_batch (every 16th altered), {curve.name}", rows, wall,
                            None, None, None, nl))

            eg = ElGamal(curve)
            eparams = eg.setup(srng)
            epk, esk = eg.keygen(eparams, srng)
            emsgs = list(pks)  # random points of the group
            if curve.coords == 3:
                emsgs[0] = None  # the SW identity as a message
            rs = [eg.rand_randomness(srng) for _ in range(rows)]
            cts, wall, nl = call(f"ElGamal encrypt_batch, {curve.name}, {rows} messages (r pk fixed-base; "
                                 f"its table built on the host)",
                                 lambda: eg.encrypt_batch(eparams, epk, emsgs, rs), [kname])
            require(all(cts[i] == eg.encrypt(eparams, epk, emsgs[i], rs[i]) for i in sample),
                    f"{SAMPLE} encrypt_batch rows == host encrypt on {curve.name}")
            rbits = bits_of(rs)
            c1, t1 = step(lambda: mod.fixed_base_mul(curve, eparams.generator, rbits))
            rpk, t2 = step(lambda: mod.fixed_base_mul(curve, epk, rbits))
            m_dev = points(emsgs)
            _, t_aff = step(lambda: mod.unpack_affine(curve, torch.stack([c1, mod.add(curve, m_dev, rpk)], dim=1)))
            record("ElGamal encrypt_batch", rows, wall, nl, msm=t1 + t2, aff=t_aff)
            del c1, rpk, m_dev
            n = ELGAMAL_SMALL
            small, wall, nl = call(f"ElGamal encrypt_batch, {curve.name}, {n} messages (r pk windowed)",
                                   lambda: eg.encrypt_batch(eparams, epk, emsgs[:n], rs[:n]), [kname])
            require(small == cts[:n], f"the windowed route == the fixed-base route on {curve.name}")
            c1, t_msm = step(lambda: mod.fixed_base_mul(curve, eparams.generator, rbits[:n]))
            rpk, t_win = step(lambda: mod.scalar_mul_bits_windowed(curve, points(tuple(epk)), rbits[:n]))
            _, t_aff = step(lambda: mod.unpack_affine(curve, torch.stack([c1, mod.add(curve, points(emsgs[:n]), rpk)],
                                                                         dim=1)))
            record("ElGamal encrypt_batch", n, wall, nl, msm=t_msm, win=t_win, aff=t_aff)
            dec, wall, nl = call(f"ElGamal decrypt_batch, {curve.name}, {rows + n} ciphertexts (windowed only, as "
                                 f"in the JAX package: no kernel)",
                                 lambda: eg.decrypt_batch(eparams, esk, cts + small), [])
            require(nl == 0, f"decrypt_batch launches no kernel on {curve.name}")
            require(dec == emsgs + emsgs[:n], f"decrypt_batch round trips every message on {curve.name}")
            require(all(dec[i] == eg.decrypt(eparams, esk, cts[i]) for i in sample),
                    f"{SAMPLE} decrypt_batch rows == host decrypt on {curve.name}")
            c1s, c2s = points([c[0] for c in cts]), points([c[1] for c in cts])
            sk_bits = bits_of([esk] * rows)
            sc, t_win = step(lambda: mod.scalar_mul_bits_windowed(curve, c1s, sk_bits))
            _, t_aff = step(lambda: mod.unpack_affine(curve, mod.add(curve, c2s, mod.neg(curve, sc))))
            record(f"ElGamal decrypt_batch (the split on the first {rows} rows)", rows + n, wall, nl, win=t_win,
                   aff=t_aff)
            del c1s, c2s, sc

            # the kernel at the fixed-base shape: the first signing pass of 2^14 messages
            table = torch.from_numpy(mod.fixed_base_grouped_table(curve, G, curve.scalar.nbits)).cuda()
            fbits = torch.randint(0, 2, (FIXED_BASE_ROWS, curve.scalar.nbits), dtype=torch.uint8, device="cuda",
                                  generator=gen)
            table, idx = curve_fast.grouped_operands(table, fbits, 3)
            ms = median_ms(lambda: kern.grouped_msm(curve, table, idx), reps=10)
            sel = torch.randperm(idx.shape[0], device="cuda", generator=gen)[:CHECK_ROWS]
            got = kern.grouped_msm(curve, table, idx)[sel]
            want = kern.grouped_msm_plain(curve, table, idx[sel].contiguous())
            errs[kname] = max(errs[kname], max_abs_err(got, want))
            require(torch.equal(got, want), f"{kname} == plain on {CHECK_ROWS} rows of the fixed-base batch")
            plain = median_ms(lambda: kern.grouped_msm_plain(curve, table, idx[:CHECK_ROWS].contiguous()), reps=1,
                              warmup=0)
            b_ms, b_by = bound_ms(*msm_bound(curve, table, idx))
            log(f"  {kname} at the fixed-base shape ({curve.name}, {idx.shape[0]} rows x {table.shape[0]} groups): "
                f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x; plain {plain:.2f} ms at "
                f"{CHECK_ROWS} rows; {CHECK_ROWS} random rows equal to the plain version")
            del kbits, fbits, idx, table

        log("  phase 7 calls (wall; steps run again alone; launches of the curve's kernel):")
        for path, n, wall, msm, win, aff, nl in summary:
            steps = "" if msm is None else f"; MSM {msm:.3f} s, windowed {win:.3f} s, affine {aff:.3f} s"
            log(f"    {path} ({n} rows): {wall:.3f} s{steps}; {nl} launches")
        log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with Phase("phase 8: transcripts, protocols and the rest of the Pedersen family"):
        from crypto_primitives_tpu_torch.models.protocols.ipa_fold import (
            ipa_fold_prove,
            ipa_fold_prove_host,
            ipa_fold_verify_host,
        )
        from crypto_primitives_tpu_torch.models.protocols.sumcheck import (
            sumcheck_prove,
            sumcheck_prove_host,
            sumcheck_prover_compiled,
            sumcheck_verify_host,
        )
        from crypto_primitives_tpu_torch.models.sponge.fiat_shamir import fold_argument, fold_argument_host
        from crypto_primitives_tpu_torch.ops import field as ff
        from crypto_primitives_tpu_torch.ops.curve import te_to_affine

        torch.cuda.reset_peak_memory_stats()
        summary8 = []

        def call8(path, fn, needs):
            t = time.time()
            out, counts = drive(path, fn, needs)
            for k in ("msm_te", "poseidon_permute"):
                launches[k] += counts[k]
            return out, time.time() - t, counts

        def record8(path, wall, counts, steps, rest="host"):
            summary8.append((path, wall, steps, counts))
            log("    steps run again alone: " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
                + f"; the rest of the wall time ({rest}) {wall - sum(steps.values()):.3f} s")

        def k1_launch_ms(batch):
            """One poseidon_permute launch on (batch, 3, 8) states, by CUDA events."""
            states = random_elements(FR, (batch, cfg.t), gen)
            return median_ms(lambda: poseidon_kernel.permute(cfg, states), reps=20)

        # the Bowe-Hopwood CRH at the JAX bench's window (phase 3 set it up)
        curve = ED_ON_BLS12_377
        t = time.time()
        n_real = -(-(8 * 128) // 3)
        bh_params.device_signed_table(n_real, torch.device("cuda"))
        log(f"  Bowe-Hopwood {BH_WINDOW[0]} x {BH_WINDOW[1]}: signed-combos table ({n_real} of "
            f"{BH_WINDOW[0] * BH_WINDOW[1]} groups) on the card in {time.time() - t:.2f} s")
        bh_inputs = torch.randint(0, 256, (BH_ROWS, 128), dtype=torch.uint8, device="cuda", generator=gen)
        xs, wall, counts = call8(f"Bowe-Hopwood CRH evaluate_batch, {curve.name}, {BH_ROWS} rows",
                                 lambda: bh.evaluate_batch(bh_params, bh_inputs), ["msm_te"])
        sample = torch.randperm(BH_ROWS, generator=torch.Generator().manual_seed(SEED))[:SAMPLE].tolist()
        host = [bh.evaluate(bh_params, bytes(bh_inputs[i].cpu().numpy())) for i in sample]
        require([int(v) for v in curve.base.unpack(xs[sample].cpu())] == host,
                f"{SAMPLE} Bowe-Hopwood rows == host evaluate")
        log(f"  {SAMPLE} sampled Bowe-Hopwood digests equal the host evaluate")
        bh_table, bh_idx = curve_fast.grouped_operands(bh_params.device_signed_table(n_real, torch.device("cuda")),
                                                       bytes_to_bits_batch(bh_inputs), 3)
        acc, t_msm = step(lambda: msm_kernel.grouped_msm(curve, bh_table, bh_idx))
        _, t_aff = step(lambda: te_to_affine(curve, acc))
        record8(f"Bowe-Hopwood CRH, {BH_ROWS} rows", wall, counts, {"MSM": t_msm, "affine": t_aff})
        ms = median_ms(lambda: msm_kernel.grouped_msm(curve, bh_table, bh_idx), reps=10)
        b_ms, b_by = bound_ms(*msm_bound(curve, bh_table, bh_idx))
        log(f"  msm_te on the signed-combos table ({bh_idx.shape[0]} rows x {bh_table.shape[0]} groups): "
            f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x")
        del acc, xs, bh_idx

        # the injective-map compressors on phase 5's parameters and inputs
        window, params, cparams, inputs, rbits, digests_x, comms_x = pedersen_te
        crh_c, com_c = PedersenCRHCompressor(curve, window), PedersenCommitmentCompressor(curve, window)
        got, wall, counts = call8(f"PedersenCRHCompressor evaluate_batch, {curve.name}, {TE_ROWS} rows",
                                  lambda: crh_c.evaluate_batch(params, inputs), ["msm_te"])
        require(torch.equal(got, digests_x), "the CRH compressor == phase 5's CRH x-coordinates")
        acc, t_msm = step(lambda: crh_c.crh.evaluate_batch_projective(params, inputs))
        _, t_aff = step(lambda: te_to_affine(curve, acc))
        record8(f"PedersenCRHCompressor, {TE_ROWS} rows", wall, counts, {"MSM": t_msm, "affine": t_aff})
        got, wall, counts = call8(f"PedersenCommitmentCompressor commit_batch, {curve.name}, {TE_ROWS} rows",
                                  lambda: com_c.commit_batch(cparams, inputs, rbits), ["msm_te"])
        require(torch.equal(got, comms_x), "the commitment compressor == phase 5's commitment x-coordinates")
        acc, t_msm = step(lambda: curve_fast.add(curve, com_c.inner.crh.evaluate_batch_projective(
            cparams.crh_params(), inputs), curve_fast.conditional_sum_grouped_auto(curve, cparams, rbits, 3)))
        _, t_aff = step(lambda: te_to_affine(curve, acc))
        record8(f"PedersenCommitmentCompressor, {TE_ROWS} rows", wall, counts, {"MSM": t_msm, "affine": t_aff})
        log(f"  both compressors equal the x-coordinates of phase 5's CRH and commitment on all {TE_ROWS} rows")
        del acc, got

        # the fold argument
        perm_ms = {b: k1_launch_ms(b) for b in (FOLD_B, SUMCHECK_B, IPA_B)}
        coms = [[pyrng.randrange(FR.p) for _ in range(FOLD_R)] for _ in range(FOLD_B)]
        (tag, z), wall, counts = call8(f"fold argument, B = {FOLD_B}, R = {FOLD_R}",
                                       lambda: fold_argument(cfg, coms), ["poseidon_permute"])
        sample = sorted(random.Random(SEED).sample(range(FOLD_B), SAMPLE))
        tags, zs = fold_argument_host(cfg, [coms[i] for i in sample])
        require([int(v) for v in FR.unpack(tag[sample, 0].cpu())] == tags, f"{SAMPLE} fold tags == host")
        require([int(v) for v in FR.unpack(z[sample].cpu())] == zs, f"{SAMPLE} fold responses == host")
        log(f"  {SAMPLE} sampled fold tags and responses equal fold_argument_host")
        rows = random_elements(FR, (FOLD_B, FOLD_R), gen)

        def fold_field():
            acc = rows[:, 0]
            for r in range(1, FOLD_R):
                acc = ff.add(FR, ff.mont_mul(FR, acc, rows[:, r]), rows[:, r])
            return acc

        _, t_field = step(fold_field)
        record8(f"fold argument, B = {FOLD_B}", wall, counts,
                {"permutation": counts["poseidon_permute"] * perm_ms[FOLD_B] / 1e3, "field": t_field},
                rest="host: packing the commitments, sponge glue")
        del tag, z, rows

        # sumcheck, eagerly and through its CUDA graph
        table = random_elements(FR, (SUMCHECK_B, 1 << SUMCHECK_M), gen)
        eager, wall, counts = call8(f"sumcheck_prove (eager), B = {SUMCHECK_B}, m = {SUMCHECK_M}",
                                    lambda: sumcheck_prove(cfg, table), ["poseidon_permute"])
        record8(f"sumcheck_prove (eager), B = {SUMCHECK_B}", wall, counts,
                {"permutation": counts["poseidon_permute"] * perm_ms[SUMCHECK_B] / 1e3},
                rest="the field steps: the half-table sums and the folds")
        log(f"  peak device memory of the eager prover: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        fn = sumcheck_prover_compiled(cfg)
        first, wall, counts = call8("sumcheck_prover_compiled: eager warm-up, capture and the first replay",
                                    lambda: fn(table), ["poseidon_permute"])
        captured = fn.captured_launches[(tuple(table.shape), str(table.device))]
        require(captured > 0, "the sumcheck graph captured poseidon_permute launches")
        summary8.append(("sumcheck_prover_compiled: warm-up, capture, replay", wall, {}, counts))
        replay, wall, counts = call8("sumcheck_prover_compiled: replay", lambda: fn(table), [])
        require(counts["poseidon_permute"] == 0, "a graph replay does not pass through the wrapper")
        log(f"    the replay runs the {captured} poseidon_permute launches the graph captured from the eager run "
            f"(counted there, once; not counted again on a replay)")
        summary8.append((f"sumcheck_prover_compiled: replay ({captured} captured launches)", wall, {}, counts))
        replay_ms = median_ms(lambda: fn(table), reps=5, warmup=1)
        log(f"    a replay by CUDA events (the table's copy in, the graph, the outputs' copies out): "
            f"{replay_ms:.2f} ms")

        def flat(out):
            s_row, rounds, fin = out
            return torch.stack([s_row] + [x for pair in rounds for x in pair] + [fin])

        require(torch.equal(flat(eager), flat(first)) and torch.equal(flat(eager), flat(replay)),
                f"the sumcheck graph == the eager prover on all {SUMCHECK_B} instances")
        log(f"  the graph's outputs (first replay and a later one) equal the eager prover's on all {SUMCHECK_B} "
            f"instances")
        sample = sorted(random.Random(SEED).sample(range(SUMCHECK_B), SAMPLE_PROTOCOL))
        host_table = FR.unpack(table[sample].cpu())
        sums, rounds_h, _, finals = sumcheck_prove_host(cfg, host_table)
        s_row, rounds, fin = eager
        got_rounds = [[(int(a), int(b)) for a, b in zip(FR.unpack(p0[sample].cpu()), FR.unpack(p1[sample].cpu()))]
                      for p0, p1 in rounds]
        for k, i in enumerate(sample):
            msgs = [got_rounds[j][k] for j in range(SUMCHECK_M)]
            require(int(FR.unpack(s_row[i].cpu())) == sums[k] and msgs == rounds_h[k]
                    and int(FR.unpack(fin[i].cpu())) == finals[k], f"sumcheck instance {i} == host")
            require(sumcheck_verify_host(cfg, sums[k], msgs, finals[k]), f"sumcheck instance {i} verifies")
        log(f"  {SAMPLE_PROTOCOL} sampled instances equal sumcheck_prove_host and verify")
        del table, eager, first, replay

        # the IPA folding argument on JubJub
        curve = JUBJUB
        mod = fast_mod(curve)
        gens = [curve.rand_point(pyrng) for _ in range(IPA_N)]
        scalars = [[pyrng.randrange(curve.scalar.p) for _ in range(IPA_N)] for _ in range(IPA_B)]
        proof, wall, counts = call8(f"ipa_fold_prove, {curve.name}, n = {IPA_N}, B = {IPA_B}",
                                    lambda: ipa_fold_prove(curve, cfg, gens, scalars), ["poseidon_permute"])
        sample = sorted(random.Random(SEED).sample(range(IPA_B), SAMPLE_PROTOCOL))
        hosts = ipa_fold_prove_host(curve, cfg, gens, [scalars[i] for i in sample])
        for k, i in enumerate(sample):
            rounds_i = [(tuple(L[i]), tuple(R[i])) for L, R in proof["rounds"]]
            require(tuple(proof["commitment"][i]) == hosts[k]["commitment"] and rounds_i == hosts[k]["rounds"]
                    and proof["a_star"][i] == hosts[k]["a_star"], f"IPA instance {i} == host")
            require(ipa_fold_verify_host(curve, cfg, gens, proof["commitment"][i], rounds_i, proof["a_star"][i]),
                    f"IPA instance {i} verifies")
            require(not ipa_fold_verify_host(curve, cfg, gens, proof["commitment"][i], rounds_i,
                                             (proof["a_star"][i] + 1) % curve.scalar.p),
                    f"a forged a_star of IPA instance {i} is rejected")
        log(f"  {SAMPLE_PROTOCOL} sampled IPA proofs equal ipa_fold_prove_host, verify, and a forged a_star fails")
        # the prover's curve steps again alone, at its shapes: the windowed
        # products (the commitment over (B, n), then per round L and R, and
        # the two halves of G', each one call on stacked points) and the
        # affine steps (C, then L and R together)
        sbits = torch.from_numpy(mod.scalars_to_bits(curve, [v for row in scalars for v in row])).cuda()
        pts = torch.from_numpy(mod.pack_points(curve, gens)).cuda().expand(IPA_B, IPA_N, 4, -1)
        bits = sbits.reshape(IPA_B, IPA_N, -1)
        t_win, t_aff = 0.0, 0.0
        prods, dt = step(lambda: mod.scalar_mul_bits_windowed(curve, pts, bits))
        t_win += dt
        _, dt = step(lambda: mod.to_affine(curve, mod.sum(curve, prods)))
        t_aff += dt
        half = IPA_N
        while half > 1:
            half //= 2
            stacked = torch.stack([pts[:, :half], pts[:, half:2 * half]])
            prods, dt = step(lambda: mod.scalar_mul_bits_windowed(
                curve, stacked, torch.stack([bits[:, :half], bits[:, half:2 * half]])))
            t_win += dt
            _, dt = step(lambda: mod.to_affine(curve, mod.sum(curve, prods)))
            t_aff += dt
            _, dt = step(lambda: mod.scalar_mul_bits_windowed(curve, stacked, bits[None, :, :1].expand(2, -1, 1, -1)))
            t_win += dt
        record8(f"ipa_fold_prove, n = {IPA_N}, B = {IPA_B}", wall, counts,
                {"windowed": t_win, "affine (incl. the sums)": t_aff,
                 "permutation": counts["poseidon_permute"] * perm_ms[IPA_B] / 1e3},
                rest="scalar folds, bits, host reads")
        del prods, pts, bits, sbits

        log("  phase 8 calls (wall; steps run again alone; launches):")
        for path, wall, steps, counts in summary8:
            parts = "".join(f"; {k} {v:.3f} s" for k, v in steps.items() if v)
            log(f"    {path}: {wall:.3f} s{parts}; msm_te {counts['msm_te']}, "
                f"poseidon_permute {counts['poseidon_permute']}")
        log("  poseidon_permute per launch by CUDA events: "
            + ", ".join(f"{b} states {v:.4f} ms" for b, v in perm_ms.items()))
        log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with Phase("phase 9: Blake2s, the R1CS tier and its checks on the card"):
        import numpy as np

        from crypto_primitives_tpu_torch.models.commitment import Blake2sCommitment
        from crypto_primitives_tpu_torch.models.prf import Blake2sPRF, Blake2sWithParameterBlock
        from crypto_primitives_tpu_torch.ops.blake2s import blake2s
        from crypto_primitives_tpu_torch.r1cs import ConstraintSystem, FpVar
        from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem
        from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device
        from crypto_primitives_tpu_torch.r1cs.gadgets.blake2s import Blake2sPRFGadget
        from crypto_primitives_tpu_torch.r1cs.gadgets.poseidon import PoseidonTwoToOneCRHGadget
        from crypto_primitives_tpu_torch.r1cs.gadgets.sha256 import Sha256CRHGadget
        from crypto_primitives_tpu_torch.r1cs.vars import bytes_to_uint8s
        from crypto_primitives_tpu_torch.utils import profiling

        summary9 = []

        def timed(label, fn):
            """Host clock around fn, ending in a synchronize."""
            t = time.time()
            out = fn()
            torch.cuda.synchronize()
            dt = time.time() - t
            summary9.append((label, dt))
            return out, dt

        def hashlib_rows(rows_np, **kw):
            return np.frombuffer(b"".join(hashlib.blake2s(r.tobytes(), **kw).digest() for r in rows_np),
                                 dtype=np.uint8).reshape(rows_np.shape[0], -1)

        # Blake2s: the PRF, the parameter-block PRF and the commitment on 2^16 rows
        seeds = torch.randint(0, 256, (BLAKE_ROWS, 32), dtype=torch.uint8, device="cuda", generator=gen)
        inputs = torch.randint(0, 256, (BLAKE_ROWS, 32), dtype=torch.uint8, device="cuda", generator=gen)
        prf_out, _ = timed(f"Blake2sPRF.evaluate_batch, {BLAKE_ROWS} rows",
                           lambda: drive("Blake2sPRF.evaluate_batch", lambda: Blake2sPRF.evaluate_batch(seeds, inputs),
                                         [])[0])
        both = torch.cat([seeds, inputs], dim=1).cpu().numpy()
        require(np.array_equal(prf_out.cpu().numpy(), hashlib_rows(both)), f"{BLAKE_ROWS} PRF rows == hashlib")
        pblock = Blake2sWithParameterBlock(salt=b"saltsalt", personalization=b"personal")
        got, _ = timed(f"Blake2sWithParameterBlock.evaluate_batch, {BLAKE_ROWS} x 32 bytes",
                       lambda: pblock.evaluate_batch(inputs))
        require(np.array_equal(got.cpu().numpy(), hashlib_rows(inputs.cpu().numpy(), salt=b"saltsalt",
                                                               person=b"personal")),
                f"{BLAKE_ROWS} parameter-block PRF rows == hashlib")
        messages = torch.randint(0, 256, (BLAKE_ROWS, 128), dtype=torch.uint8, device="cuda", generator=gen)
        got, _ = timed(f"Blake2sCommitment.commit_batch, {BLAKE_ROWS} x 128 bytes + 32",
                       lambda: Blake2sCommitment().commit_batch(None, messages, seeds))
        require(np.array_equal(got.cpu().numpy(), hashlib_rows(torch.cat([messages, seeds], 1).cpu().numpy())),
                f"{BLAKE_ROWS} commitment rows == hashlib")
        for n in BLAKE_LENGTHS:
            msgs = torch.randint(0, 256, (BLAKE_LENGTH_ROWS, n), dtype=torch.uint8, device="cuda", generator=gen)
            host = msgs.cpu().numpy()
            for key in (b"", bytes(range(7, 39))):
                for size in (32, 16):
                    got = blake2s(msgs, size, key).cpu().numpy()
                    require(np.array_equal(got, hashlib_rows(host, digest_size=size, key=key)),
                            f"blake2s of {n} bytes, key of {len(key)}, digest {size} == hashlib")
        log(f"  Blake2s: {BLAKE_ROWS} rows of the PRF, the parameter-block PRF and the commitment, and "
            f"{BLAKE_LENGTH_ROWS} rows at lengths {BLAKE_LENGTHS}, keyed and not, digests of 32 and 16 bytes, "
            f"all equal to hashlib")

        # the batched byte circuits at N = R1CS_BYTE_N
        nprng = np.random.default_rng(SEED)
        bad = R1CS_TAMPERED

        def byte_circuit(name, synth, scalar_synth, want):
            """Synthesise N instances as one trace, hold the digests, check on the
            card, flip one digest bit's witness in one instance, and hold
            which_unsatisfied against the scalar tier on the host."""
            t = time.time()
            bcs = BatchConstraintSystem(FR, R1CS_BYTE_N)
            out = synth(bcs)
            digests = out.value
            t_synth = time.time() - t
            summary9.append((f"{name}: host synthesis of {R1CS_BYTE_N} instances", t_synth))
            require(np.array_equal(digests, want), f"{name}: every instance's digest == the native hash")
            ok, t_first = timed(f"{name}: satisfied_per_instance (first: COO centering, z to the card)",
                                lambda: bcs.satisfied_per_instance())
            require(bool(ok.all()), f"{name}: every instance satisfied on the card")
            _, t_check = timed(f"{name}: satisfied_per_instance (again)", lambda: bcs.satisfied_per_instance())
            t = time.time()
            scs = ConstraintSystem(FR)
            sout = scalar_synth(scs)
            summary9.append((f"{name}: scalar-tier synthesis of instance {bad}", time.time() - t))
            require((scs.num_constraints, scs.num_witness) == (bcs.num_constraints, bcs.num_witness),
                    f"{name}: constraint and witness counts == the scalar tier's")
            require(sout.value == digests[bad].tobytes(), f"{name}: instance {bad} == the scalar tier")
            k = list(out.bytes[0].bits[0].fp.lc.terms)[0]
            bcs.assignments[k].v[bad] ^= 1
            per, _ = timed(f"{name}: satisfied_per_instance after the flip", lambda: bcs.satisfied_per_instance())
            require(per.tolist() == [i != bad for i in range(R1CS_BYTE_N)],
                    f"{name}: exactly instance {bad} fails after its flip")
            first, _ = timed(f"{name}: which_unsatisfied", lambda: bcs.which_unsatisfied())
            scs.assignments[k] ^= 1
            host_first, _ = timed(f"{name}: the scalar tier's which_unsatisfied on the host",
                                  lambda: scs.which_unsatisfied())
            require(int(first[bad]) == host_first and bcs.which_unsatisfied(bad) == host_first
                    and int((first >= 0).sum()) == 1,
                    f"{name}: which_unsatisfied on the card names constraint {host_first}, as the host does")
            log(f"  {name}: {bcs.num_constraints} constraints, {bcs.num_witness} witnesses, {R1CS_BYTE_N} "
                f"instances; synthesis {t_synth:.3f} s, check {t_first:.3f} s first and {t_check:.3f} s again; "
                f"instance {bad} alone fails after its flip, at constraint {host_first} on the card and the host")
            return scs, k

        pseeds, pinputs = (nprng.integers(0, 256, (R1CS_BYTE_N, 32), dtype=np.uint8) for _ in range(2))
        want = Blake2sPRF.evaluate_batch(pseeds, pinputs).cpu().numpy()
        scs, k = byte_circuit(
            "Blake2s PRF circuit",
            lambda cs: Blake2sPRFGadget.evaluate(cs, Blake2sPRFGadget.new_seed(cs, pseeds), bytes_to_uint8s(cs, pinputs)),
            lambda cs: Blake2sPRFGadget.evaluate(cs, Blake2sPRFGadget.new_seed(cs, pseeds[bad].tobytes()),
                                                 bytes_to_uint8s(cs, pinputs[bad].tobytes())),
            want)
        require(scs.num_constraints == 21792, "one Blake2s block is 21792 constraints")
        # check_satisfied_device on the scalar circuit (its flip is in place): false,
        # then true once the flip is undone
        coo = scs.to_coo()
        nnz = sum(len(coo[m][0]) for m in "abc")
        flipped, t_false = timed(f"check_satisfied_device, scalar Blake2s PRF ({nnz} nonzeros), flipped",
                                 lambda: check_satisfied_device(scs))
        scs.assignments[k] ^= 1
        clean, t_true = timed(f"check_satisfied_device, scalar Blake2s PRF ({nnz} nonzeros)",
                              lambda: check_satisfied_device(scs))
        require(clean is True and flipped is False, "check_satisfied_device: true, and false after the flip")
        log(f"  check_satisfied_device on the scalar Blake2s PRF circuit, {nnz} nonzeros: true in {t_true:.3f} s, "
            f"false after the flip in {t_false:.3f} s")

        sdata = nprng.integers(0, 256, (R1CS_BYTE_N, 55), dtype=np.uint8)
        sdata_cuda = torch.from_numpy(sdata).cuda()
        (want, counts), _ = timed(f"ops.sha256 of the circuit's {R1CS_BYTE_N} messages",
                                  lambda: drive("ops.sha256, 55-byte messages", lambda: sha256(sdata_cuda),
                                                ["sha256_compress"]))
        launches["sha256_compress"] += counts["sha256_compress"]
        byte_circuit("SHA-256 CRH circuit, 55 bytes",
                     lambda cs: Sha256CRHGadget().evaluate(cs, bytes_to_uint8s(cs, sdata)),
                     lambda cs: Sha256CRHGadget().evaluate(cs, bytes_to_uint8s(cs, sdata[bad].tobytes())),
                     want.cpu().numpy())

        # the batched field circuit: Poseidon two-to-one at N = R1CS_FIELD_N
        left = random_elements(FR, (R1CS_FIELD_N,), gen)
        right = random_elements(FR, (R1CS_FIELD_N,), gen)
        t = time.time()
        bcs = BatchConstraintSystem(FR, R1CS_FIELD_N)
        pout = PoseidonTwoToOneCRHGadget(cfg).compress(bcs, FpVar.new_witness(bcs, left), FpVar.new_witness(bcs, right))
        torch.cuda.synchronize()
        t_synth = time.time() - t
        summary9.append((f"Poseidon two-to-one circuit: synthesis of {R1CS_FIELD_N} instances (field tier on the card)",
                         t_synth))
        (native, counts), _ = timed(f"PoseidonTwoToOneCRH.evaluate_batch, {R1CS_FIELD_N} rows",
                                    lambda: drive("PoseidonTwoToOneCRH.evaluate_batch",
                                                  lambda: PoseidonTwoToOneCRH(FR).evaluate_batch(cfg, left, right),
                                                  ["poseidon_permute"]))
        launches["poseidon_permute"] += counts["poseidon_permute"]
        require(torch.equal(pout.value, native), f"{R1CS_FIELD_N} Poseidon circuit outputs == evaluate_batch")
        torch.cuda.reset_peak_memory_stats()
        sat, t_check = timed("Poseidon two-to-one circuit: is_satisfied (the Montgomery check)",
                             lambda: bcs.is_satisfied())
        require(sat, "the Poseidon circuit is satisfied on the card")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kp = list(pout.lc.terms)[0]
        bcs.assignments[kp] = bcs.assignments[kp].clone()
        bcs.assignments[kp][bad] = left[bad]
        per, _ = timed("Poseidon two-to-one circuit: satisfied_per_instance after a flip",
                       lambda: bcs.satisfied_per_instance())
        require(per.tolist() == [i != bad for i in range(R1CS_FIELD_N)],
                f"Poseidon circuit: exactly instance {bad} fails after its output changed")
        log(f"  Poseidon two-to-one circuit: {bcs.num_constraints} constraints, {bcs.num_witness} witnesses, "
            f"{R1CS_FIELD_N} instances; synthesis {t_synth:.3f} s, Montgomery check {t_check:.3f} s (peak "
            f"{peak:.2f} GiB); outputs equal evaluate_batch; instance {bad} alone fails after its output changed")

        # a torch.profiler trace around one evaluate_batch
        with profiling.capture(str(build.BUILD_DIR / "profiles")) as trace_path:
            with profiling.annotate("blake2s_prf_evaluate_batch"):
                Blake2sPRF.evaluate_batch(seeds, inputs)
                torch.cuda.synchronize()
        events = json.load(open(trace_path))["traceEvents"]
        require(any(e.get("name") == "blake2s_prf_evaluate_batch" for e in events),
                "the captured trace holds the annotate span")
        n_kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"  utils.profiling.capture: {len(events)} events, the annotate span present, "
            f"{n_kernel_events} CUDA kernel events")

        log("  phase 9 calls (host clock, ending in a synchronize):")
        for label, dt in summary9:
            log(f"    {label}: {dt:.3f} s")

    with Phase("phase 10: the Merkle, curve and SNARK gadgets on the card") as phase:
        gadget_calls = Calls(launches)
        t_small = gadget_phase(cfg, pos_tree, pos_leaves, (JUBJUB, leaf_params, two_params, leaf_window, two_window),
                               bh, bh_params, bh_inputs, gadget_calls, gen)
        log("  phase 10 calls (host clock, ending in a synchronize):")
        gadget_calls.print_summary()
        t10 = time.time() - phase.t
        log(f"  phase 10: {t10:.2f} s (limit {PHASE10_LIMIT_S})")
        require(t10 <= PHASE10_LIMIT_S, f"phase 10 within its {PHASE10_LIMIT_S} s")

    with Phase("phase 11: the Pedersen CRH and compressor gadgets at phase 5's window") as phase:
        gadget_calls = Calls(launches)
        pedersen_gadgets(gadget_calls, Window(*PEDERSEN_WINDOW), PEDERSEN_BYTES, gen)
        log("  phase 11 calls (host clock, ending in a synchronize):")
        gadget_calls.print_summary()
        log(f"  phase 10 with these gadgets in place of its {CURVE_WINDOW[0]} x {CURVE_WINDOW[1]} ones: "
            f"{t10 - t_small + time.time() - phase.t:.2f} s (limit {PHASE10_LIMIT_S})")

    with Phase("phase 12: the sharded paths over NCCL at world size 1") as phase:
        sharded_phase(cfg, leaves, sha_tree, pos_leaves, pos_tree, msm_inputs, launches, gen)
        log(f"  phase 12: {time.time() - phase.t:.2f} s")

    with Phase("phase 6: times"):
        half = LEAVES // 2
        # one whole level of 2^19 compressions, as the trees launch them
        level = pos_tree.leaf_digests.reshape(half, 2, 8)
        pstates = torch.cat([torch.zeros((half, 1, 8), dtype=torch.int32, device="cuda"), level], dim=1).contiguous()
        # the SHA-256 tree's first inner level (80 bytes: length prefix and
        # digest, twice) and the level above it (64 bytes: two digests)
        prefix = torch.tensor(list((32).to_bytes(8, "little")), dtype=torch.uint8, device="cuda")
        sha80 = torch.cat([prefix.expand(LEAVES, 8), sha_tree.leaf_digests], dim=1).reshape(half, 80)
        sha64 = sha_tree.inner_levels[-1].reshape(half // 2, 64)
        sha64 = torch.cat([sha64, sha64]).contiguous()  # 2^19 rows, as many as the 80-byte level
        # the word entry at the same 2^19 two-block messages (the TPU kernel's contract)
        swords = torch.randint(-(1 << 31), 1 << 31, (half, 2, 16), dtype=torch.int64, device="cuda",
                               generator=gen).to(torch.int32)
        te_curve, te_table, te_idx = main_shapes["msm_te"]
        sw_curve, sw_table, sw_idx = main_shapes["msm_sw"]
        te_sums, sw_sums = affine_shapes["msm_te"][1], affine_shapes["msm_sw"][1]
        # (kernel, plain version, input at the path's shape, kernel reps, plain
        # reps); the MSMs' and the affine step's plain versions take about a
        # second or more at 4096 rows and were already run warm in phase 3, so
        # they are timed once, without warm-up
        calls = {
            "poseidon_permute": (lambda x: poseidon_kernel.permute(cfg, x),
                                 lambda x: poseidon_kernel.permute_plain(cfg, x), pstates, 10, 3),
            "sha256_compress": (sha256_kernel.digest, sha256_kernel.digest_plain, sha64, 20, 3),
            "sha256 80 bytes": (sha256_kernel.digest, sha256_kernel.digest_plain, sha80, 20, 3),
            "sha256 words": (sha256_kernel.compress, sha256_kernel.compress_plain, swords, 20, 3),
            "msm_te": (lambda x: msm_kernel.grouped_msm(te_curve, te_table, x),
                       lambda x: msm_kernel.grouped_msm_plain(te_curve, te_table, x), te_idx, 10, 1),
            "msm_sw": (lambda x: msm_sw_kernel.grouped_msm(sw_curve, sw_table, x),
                       lambda x: msm_sw_kernel.grouped_msm_plain(sw_curve, sw_table, x), sw_idx, 5, 1),
            "curve_affine": (lambda x: affine_kernel.to_affine(te_curve, x),
                             lambda x: affine_kernel.to_affine_plain(te_curve, x), te_sums, 20, 1),
            "curve_affine W=12": (lambda x: affine_kernel.to_affine(sw_curve, x),
                                  lambda x: affine_kernel.to_affine_plain(sw_curve, x), sw_sums, 20, 1),
        }
        times, plain_times = {}, {}
        for name, (kernel, plain, x, reps, plain_reps) in calls.items():
            times[name] = median_ms(lambda: kernel(x), reps=reps)
            # the kernel at the full timed batch, held on a seeded random
            # subset of its rows against the plain version on the same rows
            rows = torch.randperm(x.shape[0], device="cuda", generator=gen)[:CHECK_ROWS]
            got, want = kernel(x)[rows], plain(x[rows].contiguous())
            kname = "sha256_compress" if name.startswith("sha256") else name.split(" ")[0]
            errs[kname] = max(errs[kname], max_abs_err(got, want))
            require(torch.equal(got, want), f"{name} == plain on {CHECK_ROWS} rows of the {x.shape[0]}-row batch")
            log(f"  {name} at {x.shape[0]} rows: {CHECK_ROWS} random rows equal to the plain version")
            small = x[:CHECK_ROWS].contiguous()
            plain_times[name] = median_ms(lambda: plain(small), reps=plain_reps, warmup=1 if plain_reps > 1 else 0)

        image_bytes = cfg.schedule_tables(pstates.device)[1].numel() * 4
        work = {
            "poseidon_permute": (2 * pstates.numel() * 4 + image_bytes, half * poseidon_ops(cfg)),
            "sha256_compress": (sha64.numel() + half * 32, half * sha_ops(64)),
            "sha256 80 bytes": (sha80.numel() + half * 32, half * sha_ops(80)),
            "sha256 words": (swords.numel() * 4 + half * 32, half * 2 * SHA_OPS_PER_BLOCK),
            "msm_te": msm_bound(te_curve, te_table, te_idx),
            "msm_sw": msm_bound(sw_curve, sw_table, sw_idx),
            "curve_affine": affine_bound(te_curve, te_sums),
            "curve_affine W=12": affine_bound(sw_curve, sw_sums),
        }
        sources = {
            "poseidon_permute": ("crypto_primitives_tpu_torch/csrc/poseidon_permute.cu",
                                 "crypto_primitives_tpu/ops/poseidon_rns_pallas.py:609, "
                                 "crypto_primitives_tpu/ops/poseidon_pallas.py:412"),
            "sha256_compress": ("crypto_primitives_tpu_torch/csrc/sha256_compress.cu",
                                "crypto_primitives_tpu/ops/sha256_pallas.py:136"),
            "msm_te": ("crypto_primitives_tpu_torch/csrc/msm_te.cu", "crypto_primitives_tpu/ops/msm_rns_pallas.py:360"),
            "msm_sw": ("crypto_primitives_tpu_torch/csrc/msm_sw.cu",
                       "crypto_primitives_tpu/ops/msm_sw_rns_pallas.py:423"),
            "curve_affine": ("crypto_primitives_tpu_torch/csrc/curve_affine.cu", None),  # the JAX package: plain XLA
        }
        kernels = []
        for name in calls:
            nbytes, nops = work[name]
            tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_OPS_PER_S * 1e3
            b_ms, b_by = bound_ms(nbytes, nops)
            log(f"  {name}: {times[name]:.4f} ms at {calls[name][2].shape[0]} rows, bound {b_ms:.4f} ms ({b_by}; "
                f"bytes alone {tb:.4f} ms, operations alone {to:.4f} ms), "
                f"plain {plain_times[name]:.2f} ms at {CHECK_ROWS} rows"
                + (f", {launches[name]} launches" if name in KERNELS else ""))
            if name not in KERNELS:
                continue
            src, replaces = sources[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": times[name], "plain_ms": plain_times[name], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })
        # the transcripts' shapes: far under one wave of the card
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for b in (FOLD_B, SUMCHECK_B, IPA_B):
            before = poseidon_kernel.group_launches
            ms = k1_launch_ms(b)
            lanes = max(poseidon_kernel.GROUPS) if poseidon_kernel.group_launches > before else 1
            b_ms, b_by = bound_ms(2 * b * cfg.t * FR.num_words * 4 + image_bytes, b * poseidon_ops(cfg))
            log(f"  poseidon_permute at {b} states (a transcript's shape): {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {ms / b_ms:.1f}x; {lanes} lanes a state, {-(-b * lanes // poseidon_kernel.THREADS)} "
                f"blocks of {poseidon_kernel.THREADS} threads on {sms} SMs")
        log(f"  msm_sw row split k = {msm_sw_kernel.split_of(sw_curve)} ({sw_curve.name}); "
            f"split table {msm_sw_kernel.SPLIT}")

    log(f"total seconds: {time.time() - T0:.1f}")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
