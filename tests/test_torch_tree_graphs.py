"""The device trees' CUDA graph path (``models/merkle_tree/device.py``:
``GraphCache``, ``_Graph``, ``DeviceMerkleTree._replayed``) on the CPU: the
key, second-sight and least-recently-used logic; a replay's launch counters,
span and copies, with the CUDA graph stood in for; CPU trees, which never
take the path and keep their spans and verdicts; and the converter's
prefix, kept on each device.  The replays themselves are the card tests'
(``tests/test_torch_cuda.py``)."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto_primitives_tpu_torch.models.merkle_tree import ByteDigestConverter
from crypto_primitives_tpu_torch.models.merkle_tree import device as tree_device
from crypto_primitives_tpu_torch.models.merkle_tree.device import GRAPH_KEYS, GraphCache, sha256_device_tree, sha256_tree_fns
from crypto_primitives_tpu_torch.ops import poseidon_kernel, sha256_kernel
from crypto_primitives_tpu_torch.utils import profiling


class _Captures:
    """A capture function that counts its calls and returns a fresh entry."""

    def __init__(self):
        self.made = []

    def __call__(self):
        self.made.append(object())
        return self.made[-1]


def test_a_key_is_eager_once_captured_on_its_second_call_then_replayed():
    cache, capture = GraphCache(), _Captures()
    assert cache.get("a", capture) is None and not capture.made
    entry = cache.get("a", capture)
    assert capture.made == [entry]
    for _ in range(3):
        assert cache.get("a", capture) is entry
    assert len(capture.made) == 1 and list(cache.entries) == ["a"] and not cache.seen


def test_one_off_keys_never_capture_and_are_forgotten_least_recent_first():
    cache, capture = GraphCache(), _Captures()
    keys = [("verify_rows_batch", b) for b in range(GRAPH_KEYS + 1)]
    for key in keys:
        assert cache.get(key, capture) is None
    assert not capture.made and list(cache.seen) == keys[1:]
    assert cache.get(keys[0], capture) is None  # forgotten: seen once more, still eager
    assert cache.get(keys[-1], capture) is not None and len(capture.made) == 1


@pytest.mark.parametrize("size", [1, 2, GRAPH_KEYS])
def test_entries_stay_within_the_bound_least_recently_used_first_out(size):
    cache, capture = GraphCache(size), _Captures()
    for key in range(size):
        cache.get(key, capture)
        cache.get(key, capture)
    cache.get(0, capture)  # 0 is used again: 1 is now the least recent (0 itself at size 1)
    cache.get(size, capture)
    cache.get(size, capture)
    assert len(capture.made) == size + 1
    evicted = 0 if size == 1 else 1
    assert sorted(cache.entries) == sorted(set(range(size + 1)) - {evicted})
    assert cache.get(evicted, capture) is None  # a key evicted starts over


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs the captured
    function again on the static inputs, writing the static outputs."""

    captured = None

    def replay(self):
        fn, inputs, outputs = self.captured
        for out, new in zip(outputs, fn(*inputs)):
            out.copy_(new)


def test_a_replay_counts_its_launches_opens_its_span_and_hands_out_copies(monkeypatch):
    graph = _FakeGraph()

    @contextlib.contextmanager
    def capturing(g):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: graph)
    monkeypatch.setattr(torch.cuda, "graph", capturing)

    def fn(x):  # two K3 launches and one K1 launch in groups, as a wrapper would count them
        sha256_kernel.launches += 2
        poseidon_kernel.launches += 1
        poseidon_kernel.group_launches += 1
        return (x * 2, x + 1)

    first = torch.arange(4)
    before = (sha256_kernel.launches, poseidon_kernel.launches, poseidon_kernel.group_launches)
    replay = tree_device._Graph(fn, (first,), rows=12)
    graph.captured = (fn, replay.inputs, replay.outputs)
    assert (sha256_kernel.launches, poseidon_kernel.launches, poseidon_kernel.group_launches) == before
    assert sorted(replay.launched, reverse=True)[:3] == [2, 1, 1] and sum(replay.launched) == 4
    assert replay.inputs[0] is not first and torch.equal(replay.inputs[0], first)

    # the fake replay runs fn, which counts as the wrappers would: take that out
    def run(x):
        out = replay((x,))
        sha256_kernel.launches -= 2
        poseidon_kernel.launches -= 1
        poseidon_kernel.group_launches -= 1
        return out

    a = run(torch.arange(4))
    b = run(torch.arange(4) + 10)
    assert (sha256_kernel.launches, poseidon_kernel.launches, poseidon_kernel.group_launches) == \
        (before[0] + 4, before[1] + 2, before[2] + 2)
    assert torch.equal(a[0], torch.arange(4) * 2) and torch.equal(b[0], (torch.arange(4) + 10) * 2)
    assert all(x is not y for x, y in zip(b, replay.outputs))
    with profile(activities=[ProfilerActivity.CPU]):
        run(torch.arange(4))
    assert [(s.name, s.rows) for s in profiling.spans()] == [("kernel.graph", 12)]


def _sha_tree(n=16):
    leaves = torch.randint(0, 256, (n, 32), dtype=torch.uint8, generator=torch.Generator().manual_seed(3))
    return sha256_device_tree(leaves, device="cpu")


def _spans_of(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [(s.name, s.rows) for s in profiling.spans()]


def test_cpu_trees_build_no_graph_and_keep_their_spans_and_verdicts():
    tree = _sha_tree()
    idx = torch.tensor([0, 3, 8, 15])
    digests = tree.leaf_digests[torch.tensor([0, 3, 9, 15])]  # the third swapped
    calls = []
    for _ in range(3):
        calls.append(_spans_of(lambda: tree.proof_rows(idx)))
        sib, auth = calls[-1][0]
        calls.append(_spans_of(lambda: tree.verify_rows_batch(tree.root_row(), digests, idx, sib, auth)))
    assert not tree.graphs.entries and not tree.graphs.seen
    assert calls[1][0].tolist() == [True, True, False, True]
    for k in (2, 4):
        assert all(torch.equal(a, b) for a, b in zip(calls[k][0], calls[0][0]))
        assert torch.equal(calls[k + 1][0], calls[1][0])
        assert calls[k][1] == calls[0][1] and calls[k + 1][1] == calls[1][1]
    assert [name for name, _ in calls[0][1]] == ["tree.gather_paths"] + ["tree.gather_level"] * 4 + ["tree.stack_paths"]
    verify = [name for name, _ in calls[1][1] if name.startswith("tree.")]
    assert verify == ["tree.verify_paths", "tree.convert_leaves"] + ["tree.select_level", "tree.hash_level"] * 4
    assert ("kernel.k3", 4) in calls[1][1] and not any(name == "kernel.graph" for name, _ in calls[1][1])


def test_shape_checks_raise_before_any_hash():
    tree = _sha_tree()
    hashed = []
    compress = tree.compress_batch
    tree.compress_batch = lambda left, right: hashed.append(1) or compress(left, right)
    idx = torch.tensor([1, 2])
    sib, auth = tree.proof_rows(idx)
    digests = tree.leaf_digests[idx]
    with pytest.raises(ValueError, match="canonical_root_row"):
        tree.verify_rows_batch(tree.root_row()[None], digests, idx, sib, auth)
    with pytest.raises(ValueError, match="hash raw leaves"):
        tree.verify_rows_batch(tree.root_row(), digests[:, :8], idx, sib, auth)
    assert not hashed
    assert tree.verify_rows_batch(tree.root_row(), digests, idx, sib, auth).tolist() == [True, True]
    assert len(hashed) == tree.height - 1


def test_the_converter_keeps_its_prefix_on_each_device():
    conv = ByteDigestConverter(32)
    rows = torch.randint(0, 256, (3, 32), dtype=torch.uint8, generator=torch.Generator().manual_seed(4))
    got = conv.convert_batch(rows)
    assert [bytes(r.numpy()) for r in got] == [conv.convert(bytes(r.numpy())) for r in rows]
    meta = torch.empty((2, 32), dtype=torch.uint8, device="meta")
    assert conv.convert_batch(meta).shape == (2, 40)
    kept = conv._prefixes["meta"]
    conv.convert_batch(meta)
    assert conv._prefixes["meta"] is kept and sorted(conv._prefixes) == ["cpu", "meta"]
    assert sha256_tree_fns()[3].__self__._prefixes["cpu"].tolist() == list((32).to_bytes(8, "little"))
