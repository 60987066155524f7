"""The port stands alone: no JAX, nothing of the JAX package, no build at
import time, and no silent drop to the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "crypto_primitives_tpu_torch"

torch.set_num_threads(1)

_PROBE = r"""
import importlib, pkgutil, subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a subprocess was started at import time")
subprocess.Popen = refuse
import crypto_primitives_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from crypto_primitives_tpu_torch.native import build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "crypto_primitives_tpu"
             or m.startswith("crypto_primitives_tpu."))
assert not bad, bad
assert not build._loaded, "a kernel library was loaded at import time"
print(len(names))
"""


def test_port_imports_without_jax_or_build():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 78  # every module was imported


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("torch_*.py")))
def test_sources_import_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "crypto_primitives_tpu"), f"{path} imports {name}"


def test_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from crypto_primitives_tpu_torch.errors import DeviceUnavailable
    from crypto_primitives_tpu_torch.models.commitment import PedersenCommitment
    from crypto_primitives_tpu_torch.models.crh import (
        PedersenCRH,
        PedersenTwoToOneCRH,
        PoseidonCRH,
        Sha256CRH,
        Window,
    )
    from crypto_primitives_tpu_torch.models.merkle_tree.device import (
        pedersen_device_tree,
        poseidon_device_tree,
        sha256_device_tree,
    )
    from crypto_primitives_tpu_torch.models.encryption import ElGamal, ElGamalParameters
    from crypto_primitives_tpu_torch.models.signature import Schnorr, SchnorrParameters, SchnorrSignature
    from crypto_primitives_tpu_torch.ops.curves_known import BLS12_381_G1, JUBJUB
    from crypto_primitives_tpu_torch.models.sponge import PoseidonSpongeBatch, get_default_poseidon_parameters
    from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FR as FR
    from crypto_primitives_tpu_torch.models.commitment import PedersenCommitmentCompressor
    from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodCRH
    from crypto_primitives_tpu_torch.models.crh.injective_map import PedersenCRHCompressor
    from crypto_primitives_tpu_torch.models.protocols import sumcheck_prove
    from crypto_primitives_tpu_torch.models.protocols.ipa_fold import ipa_fold_prove
    from crypto_primitives_tpu_torch.models.sponge.fiat_shamir import FiatShamir, fold_argument
    from crypto_primitives_tpu_torch.models.commitment import Blake2sCommitment
    from crypto_primitives_tpu_torch.models.prf import Blake2sPRF, Blake2sWithParameterBlock
    from crypto_primitives_tpu_torch.ops.blake2s import blake2s
    from crypto_primitives_tpu_torch.r1cs import ConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.batch import BatchConstraintSystem
    from crypto_primitives_tpu_torch.r1cs.device_check import check_satisfied_device

    cfg = get_default_poseidon_parameters(FR, 2)
    leaves = np.zeros((4, 32), dtype=np.uint8)
    # parameters are never touched: the device is resolved first
    ped, two, com = PedersenCRH(JUBJUB, Window(4, 8)), PedersenTwoToOneCRH(JUBJUB, Window(4, 8)), \
        PedersenCommitment(BLS12_381_G1, Window(4, 8))
    calls = [
        lambda: PoseidonSpongeBatch(cfg, batch_shape=(2,)),
        lambda: sha256_device_tree(leaves),
        lambda: poseidon_device_tree(FR, cfg, [1, 2, 3, 4]),
        lambda: Sha256CRH().evaluate_batch(None, leaves),
        lambda: PoseidonCRH(FR).evaluate_batch(cfg, torch.zeros((2, 1, 8), dtype=torch.int32)),
        lambda: ped.evaluate_batch(None, leaves[:, :4]),
        lambda: two.evaluate_batch(None, leaves[:, :2], leaves[:, :2]),
        lambda: two.compress_batch(None, torch.zeros((2, 2, 8), dtype=torch.int32),
                                   torch.zeros((2, 2, 8), dtype=torch.int32)),
        lambda: com.commit_batch(None, leaves[:, :4], np.zeros((4, 255), dtype=np.uint8)),
        lambda: pedersen_device_tree(JUBJUB, None, None, Window(4, 16), Window(4, 256), leaves[:, :8]),
        lambda: ped.evaluate_batch_many([None], [leaves[:, :4]]),
        lambda: Schnorr(JUBJUB).keygen_batch(SchnorrParameters(JUBJUB.generator, bytes(32)), None, 2),
        lambda: Schnorr(BLS12_381_G1).sign_batch(None, [1], [b"m"], None),
        lambda: Schnorr(JUBJUB).verify_batch(None, [JUBJUB.generator], [b"m"], [SchnorrSignature(1, 1)]),
        lambda: ElGamal(JUBJUB).encrypt_batch(ElGamalParameters(JUBJUB.generator), JUBJUB.generator,
                                              [JUBJUB.generator], [1]),
        lambda: ElGamal(BLS12_381_G1).decrypt_batch(None, 1, [(None, None)]),
        lambda: BoweHopwoodCRH(JUBJUB, Window(4, 8)).evaluate_batch(None, leaves[:, :4]),
        lambda: PedersenCRHCompressor(JUBJUB, Window(4, 8)).evaluate_batch(None, leaves[:, :4]),
        lambda: PedersenCommitmentCompressor(JUBJUB, Window(4, 8)).commit_batch(None, leaves[:, :4],
                                                                                 np.zeros((4, 252), dtype=np.uint8)),
        lambda: FiatShamir(cfg, batch_shape=(2,)),
        lambda: fold_argument(cfg, [[1, 2], [3, 4]]),
        lambda: sumcheck_prove(cfg, torch.zeros((2, 4, 8), dtype=torch.int32)),
        lambda: ipa_fold_prove(JUBJUB, cfg, [JUBJUB.generator] * 2, [[1, 2]]),
        lambda: blake2s(leaves),
        lambda: Blake2sPRF.evaluate_batch(leaves, leaves),
        lambda: Blake2sWithParameterBlock().evaluate_batch(leaves),
        lambda: Blake2sCommitment().commit_batch(None, leaves, leaves),
        lambda: BatchConstraintSystem(FR, 2),
        lambda: check_satisfied_device(ConstraintSystem(FR)),
    ]
    for call in calls:
        with pytest.raises(DeviceUnavailable):
            call()
