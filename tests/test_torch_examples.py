"""The port's example twins (``examples/torch_*.py``) run to their own
checks on the CPU, each in its own process (``--device cpu``;
``torch_multichip_sharding.py`` with ``--world-size 4`` over gloo), all
started together; without ``--device`` an example needs a card.  And the
port's scheme bases: their methods are the JAX package's, and every scheme
class derives from one.
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    "torch_quickstart_sponge.py": [],
    "torch_merkle_membership.py": [],
    "torch_sign_encrypt_commit.py": [],
    "torch_sumcheck_protocol.py": [],
    "torch_ipa_folding.py": [],
    "torch_multichip_sharding.py": ["--world-size", "4"],
}
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs():
    """script -> (exit code, stdout, stderr), every script run at once."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {
        name: subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", name), "--device", "cpu", *extra],
                               cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, extra in EXAMPLES.items()
    }
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out[name] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(runs, script):
    rc, stdout, stderr = runs[script]
    assert rc == 0, stderr
    assert stdout.strip(), "the example printed nothing"


def test_multichip_example_checks_every_path(runs):
    rc, stdout, _ = runs["torch_multichip_sharding.py"]
    assert rc == 0
    assert "over 4 cpu ranks" in stdout and "all 128 auth paths bit-equal" in stdout


def test_example_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs there")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "torch_quickstart_sponge.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "DeviceUnavailable" in proc.stderr


def _methods(cls):
    return sorted(name for name, v in vars(cls).items() if callable(v) and not name.startswith("_"))


def test_scheme_bases_match_jax():
    from crypto_primitives_tpu.models import commitment as jcom
    from crypto_primitives_tpu.models import crh as jcrh
    from crypto_primitives_tpu_torch.models import commitment as tcom
    from crypto_primitives_tpu_torch.models import crh as tcrh

    for jbase, tbase in ((jcrh.CRHScheme, tcrh.CRHScheme), (jcrh.TwoToOneCRHScheme, tcrh.TwoToOneCRHScheme),
                         (jcom.CommitmentScheme, tcom.CommitmentScheme)):
        assert _methods(tbase) == _methods(jbase), tbase.__name__


def test_schemes_derive_from_the_bases():
    from crypto_primitives_tpu_torch.models.commitment import (
        Blake2sCommitment,
        CommitmentScheme,
        PedersenCommitment,
        PedersenCommitmentCompressor,
    )
    from crypto_primitives_tpu_torch.models.crh import (
        CRHScheme,
        PedersenCRH,
        PedersenTwoToOneCRH,
        PoseidonCRH,
        PoseidonTwoToOneCRH,
        Sha256CRH,
        Sha256TwoToOneCRH,
        TwoToOneCRHScheme,
    )
    from crypto_primitives_tpu_torch.models.crh.bowe_hopwood import BoweHopwoodCRH, BoweHopwoodTwoToOneCRH
    from crypto_primitives_tpu_torch.models.crh.injective_map import (
        PedersenCRHCompressor,
        PedersenTwoToOneCRHCompressor,
    )

    for cls in (PoseidonCRH, Sha256CRH, PedersenCRH, BoweHopwoodCRH, PedersenCRHCompressor):
        assert issubclass(cls, CRHScheme), cls
    for cls in (PoseidonTwoToOneCRH, Sha256TwoToOneCRH, PedersenTwoToOneCRH, BoweHopwoodTwoToOneCRH,
                PedersenTwoToOneCRHCompressor):
        assert issubclass(cls, TwoToOneCRHScheme), cls
    for cls in (PedersenCommitment, PedersenCommitmentCompressor, Blake2sCommitment):
        assert issubclass(cls, CommitmentScheme), cls
