"""Tests that need the card (marked ``cuda``; each skips without one).

Run on the card from the root of the repository:
``python -m pytest portbench/tests -q -m cuda``."""

import random

import pytest
import torch

from portbench.harness import control, runner
from portbench.reference.grain import ark_and_mds
from portbench.reference.poseidon_ref import Field64, Poseidon64, permute_int

P = 52435875175126190479447740508185965837690552500527637822603658699938581184513
SMALL = {"num_leaves": 4096, "batch": 256, "check_jobs": 2, "trace_jobs": 4}
CELLS = ["sha256_tree.commit", "poseidon_tree.commit", "poseidon_tree.paths", "sha256_tree.paths"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_float64_reference_is_exact_on_the_card(cuda):
    """cuBLAS's float64 products sum integers below 2^53 exactly: the card's
    batched permutation equals the Python-int one and the CPU's."""
    ark, mds = ark_and_mds(P, 3, 8, 31, 0)
    rng = random.Random(5)
    states = [[rng.randrange(P) for _ in range(3)] for _ in range(256)] + [[P - 1] * 3, [0, 0, 0]]
    gpu, cpu = Field64(P, cuda), Field64(P, "cpu")
    x = torch.stack([gpu.from_ints(s) for s in states])
    y = Poseidon64(gpu, 17, 8, 31, ark, mds)(x)
    assert [gpu.to_ints(y[i]) for i in range(len(states))] == [permute_int(P, 17, 8, 31, ark, mds, s) for s in states]
    big = torch.randint(0, 1 << 17, (1 << 16, 3, 18), generator=torch.Generator().manual_seed(9)).double()
    on_card = Poseidon64(gpu, 17, 8, 31, ark, mds)(big.to(cuda)).cpu()
    on_cpu = Poseidon64(cpu, 17, 8, 31, ark, mds)(big)
    assert torch.equal(on_card, on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_is_correct_and_traced(cuda, cell):
    result, _ = runner.run(cell, 2**31 + 77, 0.3, True, device=cuda, scale=SMALL)
    assert result["correct"], result["checks"]
    names = set(result["metrics"])
    kernel = "k1_roofline" if cell.startswith("poseidon") else "k3_roofline"
    assert any(n.startswith(kernel) for n in names), names
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(cuda, cell):
    result, _ = runner.run(cell, 2**31 + 78, 0.2, False, device=cuda, scale=SMALL, program=control.ReferenceProgram)
    assert not result["correct"]
