"""The port's ``parallel/`` over gloo on the CPU against the JAX package's
single-device results.

For each world size D in (1, 2, 4), one module fixture spawns D ranks with a
gloo group; each rank runs every sharded path on its shard and sends back
numpy results.  The parent computes the JAX package's single-device results
from the same numpy seed (``sha256_device_tree``'s proofs and updates,
``MerkleTree.new``'s Poseidon root and paths, ``poseidon.permute``'s XLA
path, and the grouped conditional sums on JubJub and BLS12-381 G1) and compares bytes, and ints
after ``interop``.  Sizes follow JAX's sharded tests
(tests/test_parallel_sharded_tree.py:31, tests/test_parallel.py): 512
SHA-256 leaves, 64 Poseidon leaves, 32 points x 3 rows, 16 x D states.
Tolerance: exact equality; the MSMs as affine points.

The ranks import neither JAX nor the JAX package: JAX is imported inside
the parent's fixtures only.
"""

import os
import random

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLDS = (1, 2, 4)
SEED = 20261017
SHA_LEAVES, LEAF_BYTES = 512, 16
POS_LEAVES = 64
MSM_POINTS, MSM_ROWS = 32, 3
PERMUTE_PER_RANK = 16
UPDATES = [0, 1, 77, 200, 201, SHA_LEAVES - 1]  # spread over the shards, two in one shard
REPEATED = [5, 300, 5, 511]  # leaf 5 twice in one batch
MULTIPATH = [3, 4, 5, 100, 101, 333, 444, 511]
TAMPERED = 3  # the local row whose auth path is altered


def _inputs():
    """Every input, from one numpy seed; the same in the parent and ranks."""
    from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, JUBJUB
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR

    rng = np.random.default_rng(SEED)

    def elements(n):
        return [int.from_bytes(rng.bytes(40), "little") % FR.p for _ in range(n)]

    prng = random.Random(SEED)
    return {
        "sha_leaves": rng.integers(0, 256, (SHA_LEAVES, LEAF_BYTES), dtype=np.uint8),
        "new_leaves": rng.integers(0, 256, (len(UPDATES), LEAF_BYTES), dtype=np.uint8),
        "repeat_leaves": rng.integers(0, 256, (len(REPEATED), LEAF_BYTES), dtype=np.uint8),
        "pos_leaves": elements(POS_LEAVES),
        "states": {D: elements(PERMUTE_PER_RANK * D * 3) for D in WORLDS},
        "te_points": [JUBJUB.rand_point(prng) for _ in range(MSM_POINTS + 1)],
        "sw_points": [BLS12_381_G1.rand_point(prng) for _ in range(MSM_POINTS + 1)],
        "bits": rng.integers(0, 2, (MSM_ROWS, MSM_POINTS + 1), dtype=np.uint8),
    }


def _rank_checks(rank, world):
    """Every sharded path on this rank's shard; returns numpy results."""
    from crypto_primitives_tpu_torch.models.crh import PoseidonCRH, PoseidonTwoToOneCRH
    from crypto_primitives_tpu_torch.models.merkle_tree import (
        FieldDigestDomain,
        IdentityDigestConverter,
        MerkleTreeConfig,
    )
    from crypto_primitives_tpu_torch.models.merkle_tree.device import poseidon_tree_fns, sha256_tree_fns
    from crypto_primitives_tpu_torch.models.sponge import get_default_poseidon_parameters
    from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, JUBJUB
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
    from crypto_primitives_tpu_torch.parallel import (
        make_mesh,
        sharded_fixed_base_msm,
        sharded_fixed_base_msm_sw,
        sharded_merkle_build_prove_all,
        sharded_merkle_root,
        sharded_merkle_tree,
        sharded_multipath_verify_rows,
        sharded_permute_batch,
    )

    inp = _inputs()
    mesh = make_mesh(world, device_type="cpu")
    out = {}

    def local(rows, n):
        return rows[rank * (n // world):(rank + 1) * (n // world)]

    # -- SHA-256: build and prove all, the tree, updates, verify, multipath
    leaf_hash, compress, level, convert = sha256_tree_fns()
    leaves = torch.from_numpy(local(inp["sha_leaves"], SHA_LEAVES))
    root, sib, auth = sharded_merkle_build_prove_all(leaf_hash, compress, leaves, mesh, leaf_convert=convert,
                                                     compress_level_batch=level)
    out.update(sha_root=root.numpy(), sha_sib=sib.numpy(), sha_auth=auth.numpy())
    # the default level compressor (pairs as views of compress_batch)
    out["sha_root_pairwise"] = sharded_merkle_build_prove_all(leaf_hash, compress, leaves, mesh,
                                                              leaf_convert=convert)[0].numpy()
    tree = sharded_merkle_tree(leaf_hash, compress, leaves, mesh, leaf_convert=convert, compress_level_batch=level)
    all_idx = torch.arange(SHA_LEAVES)
    s, a = tree.proof_rows(all_idx)
    out.update(tree_sib=s.numpy(), tree_auth=a.numpy())
    ok = tree.verify_rows_batch(tree.root_row, tree.leaf_digests, local(all_idx, SHA_LEAVES), sib, auth)
    bad_auth = auth.clone()
    bad_auth[TAMPERED, -1, 0] ^= 1
    out["verify"] = ok.numpy()
    out["verify_tampered"] = tree.verify_rows_batch(tree.root_row, tree.leaf_digests, local(all_idx, SHA_LEAVES),
                                                    sib, bad_auth).numpy()
    sel = torch.tensor(MULTIPATH)
    m_sib, m_auth = tree.proof_rows(sel)
    m_leaves = leaf_hash(torch.from_numpy(inp["sha_leaves"][MULTIPATH]))
    out["multipath"] = bool(sharded_multipath_verify_rows(compress, convert, tree.root_row, m_leaves, MULTIPATH,
                                                          m_sib, m_auth, mesh))
    wrong = tree.root_row.clone()
    wrong[0] ^= 1
    out["multipath_wrong_root"] = bool(sharded_multipath_verify_rows(compress, convert, wrong, m_leaves, MULTIPATH,
                                                                     m_sib, m_auth, mesh))
    new_digests = leaf_hash(torch.from_numpy(inp["new_leaves"]))
    tree.update_batch(UPDATES, new_digests)
    s, a = tree.proof_rows(all_idx)
    out.update(upd_root=tree.root_row.numpy(), upd_sib=s.numpy(), upd_auth=a.numpy())
    tree.update_batch(REPEATED, leaf_hash(torch.from_numpy(inp["repeat_leaves"])))
    s, a = tree.proof_rows(all_idx)
    out.update(rep_root=tree.root_row.numpy(), rep_sib=s.numpy(), rep_auth=a.numpy())

    # -- Poseidon: the root through MerkleTreeConfig, and the tree's functions
    cfg = get_default_poseidon_parameters(FR, 2, False)
    pleaves = torch.from_numpy(FR.pack(local(inp["pos_leaves"], POS_LEAVES)))
    mc = MerkleTreeConfig(PoseidonCRH(FR), PoseidonTwoToOneCRH(FR), FieldDigestDomain(FR), FieldDigestDomain(FR),
                          IdentityDigestConverter())
    out["pos_root"] = sharded_merkle_root(mc, cfg, cfg, pleaves.unsqueeze(1), mesh).numpy()
    p_leaf, p_compress, p_level = poseidon_tree_fns(cfg)
    proot, psib, pauth = sharded_merkle_build_prove_all(p_leaf, p_compress, pleaves, mesh, compress_level_batch=p_level)
    out.update(pos_tree_root=proot.numpy(), pos_sib=psib.numpy(), pos_auth=pauth.numpy())

    # -- the data-parallel permutation
    n_states = PERMUTE_PER_RANK * world
    states = FR.pack(np.asarray(inp["states"][world], dtype=object).reshape(n_states, 3))
    out["permuted"] = sharded_permute_batch(cfg, torch.from_numpy(local(states, n_states)), mesh).numpy()

    # -- the sharded fixed-base MSMs, as affine words, and N % D != 0
    from crypto_primitives_tpu_torch.ops.curve import te_to_affine
    from crypto_primitives_tpu_torch.ops.curve_sw import sw_to_affine

    bits = torch.from_numpy(inp["bits"])
    n = MSM_POINTS
    out["te"] = te_to_affine(JUBJUB, sharded_fixed_base_msm(JUBJUB, inp["te_points"][:n], bits[:, :n], mesh)).numpy()
    out["sw"] = sw_to_affine(BLS12_381_G1, sharded_fixed_base_msm_sw(BLS12_381_G1, inp["sw_points"][:n],
                                                                     bits[:, :n], mesh)).numpy()
    raised = []
    for fn, curve, pts in ((sharded_fixed_base_msm, JUBJUB, inp["te_points"]),
                           (sharded_fixed_base_msm_sw, BLS12_381_G1, inp["sw_points"])):
        try:
            fn(curve, pts, bits, mesh)
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["uneven_raises"] = np.asarray(raised)
    # refusals before any collective: every rank raises alike
    refusals = [(ValueError, lambda: make_mesh(world + 1, device_type="cpu")),
                (ValueError, lambda: sharded_merkle_build_prove_all(leaf_hash, compress, leaves[:3], mesh,
                                                                    leaf_convert=convert)),
                (IndexError, lambda: tree.proof_rows([SHA_LEAVES])),
                (IndexError, lambda: tree.update_batch([-1], new_digests[:1]))]
    raised = []
    for err, call in refusals:
        try:
            call()
            raised.append(False)
        except err:
            raised.append(True)
    out["refusals_raise"] = np.asarray(raised)
    return out


def _rank(rank, world, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_rank_checks(rank, world))
    finally:
        dist.destroy_process_group()


def _jax_reference():
    """The JAX package's single-device results on the same inputs."""
    import jax.numpy as jnp

    from crypto_primitives_tpu.models.crh.poseidon import PoseidonCRH, PoseidonTwoToOneCRH
    from crypto_primitives_tpu.models.merkle_tree import (
        FieldDigestDomain,
        IdentityDigestConverter,
        MerkleTree,
        MerkleTreeConfig,
    )
    from crypto_primitives_tpu.models.merkle_tree.device import _sha_leaf_hash, sha256_device_tree
    from crypto_primitives_tpu.models.sponge import get_default_poseidon_parameters
    from crypto_primitives_tpu.models.sponge import poseidon as jposeidon
    from crypto_primitives_tpu.ops import curve_rns as jcr
    from crypto_primitives_tpu.ops import curve_sw_rns as jsr
    from crypto_primitives_tpu.ops.curves_known import BLS12_381_G1, JUBJUB
    from crypto_primitives_tpu.ops.fields_known import BLS12_381_FR as FR

    inp = _inputs()
    ref = {}
    single = sha256_device_tree(jnp.asarray(inp["sha_leaves"]))
    idx = jnp.arange(SHA_LEAVES)
    sib, auth = single.proof_rows(idx)
    ref.update(sha_root=np.asarray(single.root_row()), sha_sib=np.asarray(sib), sha_auth=np.asarray(auth))
    single.update_batch(UPDATES, _sha_leaf_hash(jnp.asarray(inp["new_leaves"])))
    sib, auth = single.proof_rows(idx)
    ref.update(upd_root=np.asarray(single.root_row()), upd_sib=np.asarray(sib), upd_auth=np.asarray(auth))

    cfg = get_default_poseidon_parameters(FR, 2, False)
    mc = MerkleTreeConfig(PoseidonCRH(FR), PoseidonTwoToOneCRH(FR), FieldDigestDomain(FR), FieldDigestDomain(FR),
                          IdentityDigestConverter())
    tree = MerkleTree.new(mc, cfg, cfg, jnp.asarray(FR.pack([[v] for v in inp["pos_leaves"]])))
    ref["pos_root"] = tree.root()
    ref["pos_paths"] = [tree.generate_proof(i) for i in range(POS_LEAVES)]

    ref["permuted"] = {}
    for D in WORLDS:
        states = FR.pack(np.asarray(inp["states"][D], dtype=object).reshape(-1, 3))
        out = np.asarray(jposeidon.permute(FR, cfg.packed(), jnp.asarray(states)))
        ref["permuted"][D] = [[int(v) for v in row] for row in FR.unpack(out)]

    # JAX's grouped conditional sums (its XLA fast path); cv.te_conditional_sum
    # and its SW twin are the same sums, eager, and take about 70 s on the CPU
    bits = jnp.asarray(inp["bits"][:, :MSM_POINTS])
    for model, mod, curve, fn in (("te", jcr, JUBJUB, jcr.te_conditional_sum_grouped_rns),
                                  ("sw", jsr, BLS12_381_G1, jsr.sw_conditional_sum_grouped_rns)):
        table = jnp.asarray(mod.pack_table_grouped(curve, inp[f"{model}_points"][:MSM_POINTS], 3))
        ref[model] = list(mod.unpack_affine_rns(curve, np.asarray(fn(curve, table, bits, 3))))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(world size -> one dict of numpy results per rank, the JAX results):
    the ranks of every world size run while the parent computes JAX's."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("ranks")
    contexts = {}
    for world in WORLDS:
        out_dir = tmp / str(world)
        out_dir.mkdir()
        contexts[world] = mp.start_processes(_rank, args=(world, str(out_dir / "store"), str(out_dir)),
                                             nprocs=world, join=False, start_method="spawn")
    ref = _jax_reference()
    results = {}
    for world, ctx in contexts.items():
        while not ctx.join():
            pass
        results[world] = [dict(np.load(tmp / str(world) / f"rank{r}.npz")) for r in range(world)]
    return results, ref


@pytest.fixture(scope="module")
def ranks(run):
    return run[0]


@pytest.fixture(scope="module")
def jax_ref(run):
    return run[1]


def _shard(rows, rank, world):
    n = rows.shape[0] // world
    return rows[rank * n:(rank + 1) * n]


@pytest.mark.parametrize("world", WORLDS)
def test_sha256_build_prove_all_bitequal(ranks, jax_ref, world):
    for r, res in enumerate(ranks[world]):
        assert res["sha_root"].tobytes() == jax_ref["sha_root"].tobytes()
        assert res["sha_root_pairwise"].tobytes() == jax_ref["sha_root"].tobytes()
        assert np.array_equal(res["sha_sib"], _shard(jax_ref["sha_sib"], r, world))
        assert np.array_equal(res["sha_auth"], _shard(jax_ref["sha_auth"], r, world))
        # every rank's replicated proof_rows are every leaf's paths
        assert np.array_equal(res["tree_sib"], jax_ref["sha_sib"])
        assert np.array_equal(res["tree_auth"], jax_ref["sha_auth"])


@pytest.fixture(scope="module")
def port_repeated():
    """The port's single-device tree after both updates: (root, leaf_sib, auth)."""
    from crypto_primitives_tpu_torch.models.merkle_tree.device import sha256_device_tree, sha256_tree_fns

    leaf_hash = sha256_tree_fns()[0]
    inp = _inputs()
    single = sha256_device_tree(inp["sha_leaves"], device="cpu")
    single.update_batch(UPDATES, leaf_hash(torch.from_numpy(inp["new_leaves"])))
    single.update_batch(REPEATED, leaf_hash(torch.from_numpy(inp["repeat_leaves"])))
    return (single.root_row(), *single.proof_rows(torch.arange(SHA_LEAVES)))


@pytest.mark.parametrize("world", WORLDS)
def test_update_batch_bitequal(ranks, jax_ref, port_repeated, world):
    root, sib, auth = port_repeated
    for res in ranks[world]:
        assert res["upd_root"].tobytes() == jax_ref["upd_root"].tobytes()
        assert np.array_equal(res["upd_sib"], jax_ref["upd_sib"])
        assert np.array_equal(res["upd_auth"], jax_ref["upd_auth"])
        # a repeated index: the port's single-device semantics
        assert res["rep_root"].tobytes() == root.numpy().tobytes()
        assert res["rep_root"].tobytes() != res["upd_root"].tobytes()
        assert np.array_equal(res["rep_sib"], sib.numpy())
        assert np.array_equal(res["rep_auth"], auth.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_verify_rows_batch(ranks, world):
    for res in ranks[world]:
        assert res["verify"].all() and res["verify"].shape == (SHA_LEAVES // world,)
        want = np.ones(SHA_LEAVES // world, dtype=bool)
        want[TAMPERED] = False
        assert np.array_equal(res["verify_tampered"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_multipath_verify(ranks, world):
    for res in ranks[world]:
        assert bool(res["multipath"]) and not bool(res["multipath_wrong_root"])


@pytest.mark.parametrize("world", WORLDS)
def test_poseidon_roots_and_paths(ranks, jax_ref, world):
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR

    n_local = POS_LEAVES // world
    for r, res in enumerate(ranks[world]):
        assert int(FR.unpack(res["pos_root"])) == jax_ref["pos_root"]
        assert int(FR.unpack(res["pos_tree_root"])) == jax_ref["pos_root"]
        for i in range(n_local):
            path = jax_ref["pos_paths"][r * n_local + i]
            assert int(FR.unpack(res["pos_sib"][i])) == int(path.leaf_sibling_hash)
            assert [int(v) for v in FR.unpack(res["pos_auth"][i])] == [int(v) for v in path.auth_path]


@pytest.mark.parametrize("world", WORLDS)
def test_permute_bitequal(ranks, jax_ref, world):
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR

    want = jax_ref["permuted"][world]
    for r, res in enumerate(ranks[world]):
        got = [[int(v) for v in row] for row in FR.unpack(res["permuted"])]
        assert got == want[r * PERMUTE_PER_RANK:(r + 1) * PERMUTE_PER_RANK]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("model", ["te", "sw"])
def test_sharded_msm_affine(ranks, jax_ref, world, model):
    from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, JUBJUB

    curve = JUBJUB if model == "te" else BLS12_381_G1
    for res in ranks[world]:
        got = [(int(x), int(y)) for x, y in curve.base.unpack(res[model])]
        want = [(0, 0) if pt is None else pt for pt in jax_ref[model]]
        assert got == want


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_raise(ranks, world):
    for res in ranks[world]:
        # 33 points split over 1 rank, never over 2 or 4
        assert list(res["uneven_raises"]) == [world > 1] * 2
        # a mesh of another size, a shard of 3 leaves, leaf indexes out of range
        assert res["refusals_raise"].all()


def test_make_mesh_needs_a_group():
    import torch.distributed as dist

    from crypto_primitives_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        make_mesh(1, device_type="cpu")
