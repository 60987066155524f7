#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels on one NVIDIA GPU and drive its main path.

Run from the root of the repository:  python3 chip_smoke.py

Phases (each prints a flushed line before and after, with its seconds):
  0. device: the card's name and power limit;
  1. build: nvcc compiles every kernel source in crypto_primitives_tpu_torch/csrc;
  2. known answers on the card: the pinned Poseidon sponge vector and SHA-256
     against hashlib;
  3. each kernel against its plain PyTorch version on the card, exactly;
  4. the main path at full size: a SHA-256 and a Poseidon Merkle tree over
     2^20 leaves each, built, proved and verified, with kernel launch counts;
  5. times: each kernel at the main path's shapes (its output there held on
     4096 random rows against the plain version), the plain version's time,
     and the bound the card sets.
It needs CUDA and the repository: without either it exits non-zero before
printing a result.  The last line is the JSON result.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import torch

T0 = time.time()
SEED = 20261017
LEAVES = 1 << 20
CHECK_ROWS = 4096

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

# Operations of one SHA-256 block: 48 schedule words at 13 operations, 64 rounds
# at 25, 8 final additions (a rotation is one funnel shift).
SHA_OPS_PER_BLOCK = 48 * 13 + 64 * 25 + 8


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
    W = spec.require_words()
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
    """32-bit integer operations of one permutation: each Montgomery product
    of W words does 4W^2 + W multiply(-add)s, two operations each."""
    W = config.field.require_words()
    a = config.alpha
    sbox = (a.bit_length() - 1) + (bin(a).count("1") - 1)
    t = config.t
    products = config.full_rounds * t * sbox + config.partial_rounds * sbox
    products += (config.full_rounds + config.partial_rounds) * t * t
    return products * 2 * (4 * W * W + W)


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


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 1

    from crypto_primitives_tpu_torch.models.crh import PoseidonCRH, PoseidonTwoToOneCRH
    from crypto_primitives_tpu_torch.models.merkle_tree import (
        FieldDigestDomain,
        IdentityDigestConverter,
        MerkleTreeConfig,
    )
    from crypto_primitives_tpu_torch.models.merkle_tree.device import (
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
    from crypto_primitives_tpu_torch.ops import poseidon_kernel, sha256_kernel
    from crypto_primitives_tpu_torch.ops.fields_known import ALL_FIELDS, BLS12_381_FQ, BLS12_381_FR as FR
    from crypto_primitives_tpu_torch.ops.sha256 import bytes_to_words, padding, sha256

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

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

    errs = {"poseidon_permute": 0.0, "sha256_compress": 0.0}
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
            log(f"  poseidon_permute {c.field.name} t={c.t} alpha={c.alpha}: {CHECK_ROWS} states equal")
        for nblocks in (1, 2, 4):
            words = torch.randint(-(1 << 31), 1 << 31, (CHECK_ROWS, nblocks, 16), dtype=torch.int64,
                                  device="cuda", generator=gen).to(torch.int32)
            got = sha256_kernel.compress(words)
            want = sha256_kernel.compress_plain(words)
            torch.cuda.synchronize()
            errs["sha256_compress"] = max(errs["sha256_compress"], max_abs_err(got, want))
            require(torch.equal(got, want), f"sha256_compress == plain, {nblocks} blocks")
            log(f"  sha256_compress {nblocks} blocks: {CHECK_ROWS} messages equal")

    with Phase("phase 4: main path at 2^20 leaves"):
        poseidon_kernel.launches = 0
        sha256_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()

        t = time.time()
        leaves = torch.randint(0, 256, (LEAVES, 32), dtype=torch.uint8, device="cuda", generator=gen)
        sha_tree = sha256_device_tree(leaves, device="cuda")
        torch.cuda.synchronize()
        log(f"  sha256 tree built: {time.time() - t:.3f} s")
        idx = torch.arange(LEAVES, device="cuda")
        leaf_sib, auth = sha_tree.proof_rows(idx)
        ok = sha_tree.verify_rows_batch(sha_tree.root_row(), sha_tree.leaf_digests, idx, leaf_sib, auth)
        require(bool(ok.all()), "every SHA-256 auth path verifies")
        bad = sha_tree.verify_rows_batch(torch.zeros_like(sha_tree.root_row()), sha_tree.leaf_digests[:64],
                                         idx[:64], leaf_sib[:64], auth[:64])
        require(not bool(bad.any()), "a wrong SHA-256 root is rejected")
        del leaf_sib, auth, ok
        sel = torch.randperm(LEAVES, device="cuda", generator=gen)[:CHECK_ROWS].sort().values
        m_sib, m_auth = sha_tree.proof_rows(sel)
        require(bool(sha_tree.multipath_verify_rows(sha_tree.root_row(), sha_tree.leaf_digests[sel],
                                                    sel.tolist(), m_sib, m_auth)),
                "SHA-256 multipath verify over 4096 leaves")
        t = time.time()
        host_root = host_sha_root(leaves.cpu().numpy())
        require(sha_tree.root() == host_root, "SHA-256 device root == hashlib root")
        log(f"  sha256 root {host_root.hex()} == hashlib build ({time.time() - t:.2f} s on the host)")

        t = time.time()
        pleaves = random_elements(FR, (LEAVES,), gen)
        pos_tree = poseidon_device_tree(FR, cfg, pleaves, device="cuda")
        torch.cuda.synchronize()
        log(f"  poseidon tree built: {time.time() - t:.3f} s")
        mc = MerkleTreeConfig(PoseidonCRH(FR), PoseidonTwoToOneCRH(FR), FieldDigestDomain(FR),
                              FieldDigestDomain(FR), IdentityDigestConverter())
        root = pos_tree.root()
        picks = torch.randint(0, LEAVES, (64,), device="cuda", generator=gen).tolist()
        for i in picks:
            leaf = int(FR.unpack(pleaves[i].cpu()))
            require(pos_tree.generate_proof(i).verify(mc, cfg, cfg, root, [leaf]),
                    f"Poseidon auth path {i} reaches the device root on the host sponge")
        log(f"  poseidon root {root}: 64 auth paths verified by the host sponge")
        launches = {"poseidon_permute": poseidon_kernel.launches, "sha256_compress": sha256_kernel.launches}
        log(f"  kernel launches on the main path: {launches}")
        log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(all(n > 0 for n in launches.values()), "every kernel launched on the main path")

    with Phase("phase 5: times"):
        half = LEAVES // 2
        # one whole level of 2^19 compressions, as the trees launch them
        level = pos_tree.leaf_digests.reshape(half, 2, 8)
        pstates = torch.cat([torch.zeros((half, 1, 8), dtype=torch.int32, device="cuda"), level], dim=1).contiguous()
        pos_ms = median_ms(lambda: poseidon_kernel.permute(cfg, pstates), reps=10)
        conv = torch.cat([torch.tensor(list((32).to_bytes(8, "little")), dtype=torch.uint8, device="cuda")
                          .expand(LEAVES, 8), sha_tree.leaf_digests], dim=1).reshape(half, 80)
        msgs = torch.cat([conv, torch.from_numpy(padding(80)).cuda().expand(half, -1)], dim=1)
        swords = bytes_to_words(msgs)
        sha_ms = median_ms(lambda: sha256_kernel.compress(swords), reps=20)
        # the kernels at the full timed batch, held on a seeded random subset
        # of its rows against the plain versions on the same rows
        rows = torch.randperm(half, device="cuda", generator=gen)[:CHECK_ROWS]
        for name, got, want in (
            ("poseidon_permute", poseidon_kernel.permute(cfg, pstates)[rows],
             poseidon_kernel.permute_plain(cfg, pstates[rows].contiguous())),
            ("sha256_compress", sha256_kernel.compress(swords)[rows],
             sha256_kernel.compress_plain(swords[rows].contiguous())),
        ):
            errs[name] = max(errs[name], max_abs_err(got, want))
            require(torch.equal(got, want), f"{name} == plain on {CHECK_ROWS} rows of the {half}-row batch")
            log(f"  {name} at {half} rows: {CHECK_ROWS} random rows equal to the plain version")
        small_p = pstates[:CHECK_ROWS].contiguous()
        small_s = swords[:CHECK_ROWS].contiguous()
        pos_plain_ms = median_ms(lambda: poseidon_kernel.permute_plain(cfg, small_p), reps=3, warmup=1)
        sha_plain_ms = median_ms(lambda: sha256_kernel.compress_plain(small_s), reps=3, warmup=1)

        tables = sum(x.numel() * 4 for x in cfg.tables(pstates.device))
        pos_bytes = 2 * pstates.numel() * 4 + tables + 32
        pos_ops = half * poseidon_ops(cfg)
        sha_bytes = swords.numel() * 4 + half * 32
        sha_ops = half * swords.shape[1] * SHA_OPS_PER_BLOCK

        def bound(nbytes, nops):
            tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_OPS_PER_S * 1e3
            return (tb, "bytes") if tb >= to else (to, "operations")

        kernels = []
        for name, src, replaces, ms, plain, (b_ms, b_by) in (
            ("poseidon_permute", "crypto_primitives_tpu_torch/csrc/poseidon_permute.cu",
             "crypto_primitives_tpu/ops/poseidon_rns_pallas.py:609, crypto_primitives_tpu/ops/poseidon_pallas.py:412",
             pos_ms, pos_plain_ms, bound(pos_bytes, pos_ops)),
            ("sha256_compress", "crypto_primitives_tpu_torch/csrc/sha256_compress.cu",
             "crypto_primitives_tpu/ops/sha256_pallas.py:136",
             sha_ms, sha_plain_ms, bound(sha_bytes, sha_ops)),
        ):
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })
            log(f"  {name}: {ms:.4f} ms at {half} rows, bound {b_ms:.4f} ms ({b_by}), "
                f"plain {plain:.2f} ms at {CHECK_ROWS} rows, {launches[name]} launches")

    log(f"total seconds: {time.time() - T0:.1f}")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
