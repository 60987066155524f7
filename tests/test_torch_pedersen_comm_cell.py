"""The port's Pedersen commitment at upstream's ``benches/comm.rs`` window
(250 x 8, ed-on-bls12-377) against the benchmark's plain reference
(``portbench/reference/pedersen_comm_ref.py``), on the CPU: a seeded setup,
8-12 rows of random, all-zero, all-0xFF and 1-byte records with openings 0,
1, r - 1, 2^250 and random, bit for bit, and the port's host ``commit`` on
row 0; the reference's refusal of a bad blinding base; the configuration's
inputs (deterministic, every opening below r); the commitment's spans under
``torch.profiler`` and the benchmark's readers of them.  On the card (marked
``cuda``, skipped without one): the configuration's program against the
reference, through three launches."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.models.commitment import PedersenCommitment
from crypto_primitives_tpu_torch.models.crh import Window
from crypto_primitives_tpu_torch.ops.curves_known import ED_ON_BLS12_377
from crypto_primitives_tpu_torch.utils import profiling
from portbench.harness import loader

CFG = loader.data("configs", "pedersen_comm_ed377_250x8")
CFGMOD = loader.module("configs", "pedersen_comm_ed377_250x8")
P = ED_ON_BLS12_377.base.p
ORDER = ED_ON_BLS12_377.scalar.p
R = 1 << 256
EDGE_OPENINGS = [0, 1, ORDER - 1, 1 << 250]


def _records(case):
    g = torch.Generator().manual_seed(7)
    if case == "random":
        return torch.randint(0, 256, (12, 128), dtype=torch.uint8, generator=g)
    if case == "zeros":
        return torch.zeros((8, 128), dtype=torch.uint8)
    if case == "ones":
        return torch.full((8, 128), 0xFF, dtype=torch.uint8)
    return torch.randint(0, 256, (8, 1), dtype=torch.uint8, generator=g)  # one byte, zero-padded


def _openings(n, first):
    """n openings: the edge values from ``first`` on, then uniform ones."""
    rng = random.Random(11 + first)
    edges = EDGE_OPENINGS[first:] + EDGE_OPENINGS[:first]
    return edges + [rng.randrange(ORDER) for _ in range(n - len(edges))]


@pytest.fixture(scope="module")
def cell():
    comm = PedersenCommitment(ED_ON_BLS12_377, Window(CFG["window_size"], CFG["num_windows"]))
    params = comm.setup(random.Random(2**31 + 19))
    bases = ([win[0] for win in params.generators], params.randomness_generator[0])
    return comm, params, bases, CFGMOD.Reference(CFG, "cpu")


def _words(v):
    return [(v * R % P) >> (32 * j) & 0xFFFFFFFF for j in range(8)]


@pytest.mark.parametrize("case, first", [("random", 0), ("random", 2), ("zeros", 0), ("ones", 1), ("one_byte", 3)])
def test_program_equals_the_reference(cell, case, first):
    comm, params, bases, ref = cell
    x = _records(case)
    scalars = _openings(x.shape[0], first)
    bits = torch.from_numpy(comm.randomness_to_bits(scalars))
    assert bits.shape == (x.shape[0], CFG["opening_bits"])
    got = comm.commit_batch(params, x, bits, device="cpu").numpy()
    want = ref.digests(bases, (x, bits))
    assert got.shape == want.shape == (x.shape[0], 2, 8)
    assert np.array_equal(got, want)
    # and the port's host tier, on the first row
    hx, hy = comm.commit(params, bytes(x[0].tolist()), scalars[0])
    assert got[0].view(np.uint32).tolist() == [_words(hx), _words(hy)]
    if case == "zeros":  # no message and opening 0: the identity, affine (0, 1)
        assert got[scalars.index(0)].view(np.uint32).tolist() == [_words(0), _words(1)]


@pytest.mark.parametrize("bad", ["off_curve", "outside_subgroup"])
def test_reference_refuses_a_bad_blinding_base(cell, bad):
    _, _, (window_bases, (x, y)), ref = cell
    if bad == "off_curve":
        h, match = (x, (y + 1) % P), "blinding base is not on the curve"
    else:  # h + (0, -1), the point of order 2 added
        h, match = ((-x) % P, (-y) % P), "blinding base is not in the subgroup"
    inputs = (_records("random")[:2], torch.zeros((2, CFG["opening_bits"]), dtype=torch.uint8))
    with pytest.raises(ValueError, match=match):
        ref.digests((window_bases, h), inputs)


def _value(row):
    return sum(int(b) << j for j, b in enumerate(row.tolist()))


def test_inputs_repeat_from_the_seed_and_every_opening_is_below_r():
    records, bits = CFGMOD.make_inputs(CFG, 2**40 + 3, 4096, "cpu")
    assert records.shape == (4096, 128) and records.dtype == torch.uint8
    assert bits.shape == (4096, 251) and bits.dtype == torch.uint8 and int(bits.max()) == 1
    again = CFGMOD.make_inputs(CFG, 2**40 + 3, 4096, "cpu")
    assert torch.equal(records, again[0]) and torch.equal(bits, again[1])
    other = CFGMOD.make_inputs(CFG, 2**40 + 4, 4096, "cpu")
    assert not torch.equal(records, other[0]) and not torch.equal(bits, other[1])
    values = [_value(row) for row in bits]
    assert max(values) < ORDER
    assert max(values) >= 1 << 250 and len(set(values)) == 4096  # the top bit is drawn too


def test_below_at_the_edges():
    def limbs(v):
        return [(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]

    values = [0, 1, ORDER - 1, ORDER, ORDER + 1, (1 << 251) - 1, 1 << 250, ORDER ^ 1, ORDER ^ (1 << 40),
              ORDER - (1 << 224), ORDER + (1 << 200)]
    rows = torch.tensor([limbs(v) for v in values], dtype=torch.int64)
    assert CFGMOD.below(rows, torch.tensor(limbs(ORDER))).tolist() == [v < ORDER for v in values]


def test_spans_of_a_commitment(cell):
    comm, params, _, _ = cell
    x = _records("random")[:4]
    bits = torch.from_numpy(comm.randomness_to_bits(_openings(4, 0)))
    with profile(activities=[ProfilerActivity.CPU]):
        out = comm.commit_batch(params, x, bits, device="cpu")
    spans = profiling.spans()
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["comm.pedersen"]
    children = [s for s in spans if s.parent == roots[0].id]
    assert [c.name for c in children] == ["crh.bits", "crh.msm", "comm.blind", "comm.add", "comm.affine"]
    kernels = [(s.name, s.parent, s.rows) for s in spans if s.name.startswith("kernel.")]
    assert kernels == [("kernel.k4", children[1].id, 4), ("kernel.k4", children[2].id, 4),
                       ("kernel.add", children[3].id, None),  # the plain addition and affine step give no rows
                       ("kernel.affine", children[4].id, None)]
    assert "crh.pedersen" not in {s.name for s in spans}
    assert torch.equal(comm.commit_batch(params, x, bits, device="cpu"), out)


def _read(metric, run):
    return loader.module("metrics", metric).read(run)


def test_readers_of_the_commitment_spans():
    """``comm_self_ms`` and ``comm_add_ms`` read the ``comm.pedersen`` roots,
    less K4's spans or of ``comm.add`` alone; None without a trace or where
    no root is ``comm.pedersen``, as on a program whose commitment keeps no
    spans (its CRH spans then stand as roots of their own)."""
    traced = SimpleNamespace(trace=object())
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.annotate("comm.pedersen"):
                with profiling.annotate("crh.msm"), profiling.annotate("kernel.k4", 8):
                    pass
                with profiling.annotate("comm.add"):
                    pass
    ms = {}
    for s in profiling.spans():
        ms[s.name] = ms.get(s.name, 0) + (s.end_ns - s.start_ns) * 1e-6 / 2
    assert _read("comm_self_ms", traced) == pytest.approx(ms["comm.pedersen"] - ms["kernel.k4"])
    assert _read("comm_add_ms", traced) == pytest.approx(ms["comm.add"])
    assert 0 < _read("comm_add_ms", traced) <= _read("comm_self_ms", traced)
    assert _read("comm_self_ms", SimpleNamespace(trace=None)) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("crh.bits"):
            pass
        with profiling.annotate("crh.msm"), profiling.annotate("kernel.k4", 8):
            pass
    assert _read("comm_self_ms", traced) is None and _read("comm_add_ms", traced) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_program_on_the_card_equals_the_reference(cuda):
    """The configuration's ``Program.hash`` on 256 rows on the card:
    commitments bit for bit the reference's, in two K4 launches and one
    affine launch."""
    program = CFGMOD.Program(CFG, cuda)
    program.setup(2**31 + 31)
    x = CFGMOD.make_inputs(CFG, 37, 256, cuda)
    before = program.launches()
    got = program.to_host(program.hash(x))
    after = program.launches()
    assert {k: after[k] - before[k] for k in after} == {"crypto_primitives_tpu_torch.ops.msm_kernel": 2,
                                                        "crypto_primitives_tpu_torch.ops.affine_kernel": 1}
    want = CFGMOD.Reference(CFG, cuda).digests(program.bases(), x)
    assert np.array_equal(got, want)
