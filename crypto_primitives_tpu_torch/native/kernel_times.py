"""Time the port's four path kernels at the main paths' shapes, for one tree.

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
warm-up.  Where the root has the field probe's chain ops, it also times the
Montgomery product alone: 132 x 8 blocks of 128 threads (eight per SM), each
thread 1000 dependent products (``mul_chain``) or squares (``sqr_chain``) at
W = 8 (BLS12-381 Fr) and W = 12 (BLS12-381 Fq), reported in G products/s:
the ceiling that the field arithmetic sets for every kernel built on it.
Prints one JSON line: the root, the card, its power limit, the times in ms,
the product rates, ptxas's registers and spills for every msm_sw build, and
the SASS instruction counts of one mont_mul<8> of the root's csrc/field.cuh
and of one SHA-256 block of its csrc/sha256_compress.cu (where that source
has the shared block function), from this file's own native/build.py.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import random
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve()
SEED = 20261017


def _own_build():
    """This file's native/build.py, loaded by path so that it is not the
    --root tree's copy."""
    spec = importlib.util.spec_from_file_location("_kernel_times_build", HERE.parent / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median_ms(fn, reps: int) -> float:
    for _ in range(2):
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
    own_build = _own_build()
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
    if importlib.util.find_spec("crypto_primitives_tpu_torch.ops.affine_kernel") is not None:
        from crypto_primitives_tpu_torch.ops import affine_kernel

        for curve in (ED_ON_BLS12_377, BLS12_381_G1):
            pts = words(curve.base, (1 << 16, curve.coords))
            W = curve.base.num_words
            if not torch.equal(affine_kernel.to_affine(curve, pts), affine_kernel.to_affine_plain(curve, pts)):
                raise SystemExit(f"curve_affine on {curve.name} differs from its plain version")
            times[f"curve_affine_w{W}"] = median_ms(lambda: affine_kernel.to_affine(curve, pts), 10)
            times[f"curve_affine_plain_w{W}"] = median_ms(lambda: affine_kernel.to_affine_plain(curve, pts), 3)
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
        "ms": times, "k1_card": k1_card, "k1_sizes": k1_sizes, "g_products_per_s": rates,
        "ptxas_msm_sw": own_build.ptxas_report("msm_sw", build.BUILD_DIR),
        "sass_mont_mul_8": own_build.sass_mix(csrc / "field.cuh"),
        "sass_sha256_block": own_build.sha256_sass(csrc / "sha256_compress.cu") if has_block else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
