"""Device-resident Merkle trees: every node level lives on the device.

Twin of ``crypto_primitives_tpu/models/merkle_tree/device.py``, the design for
the reference's flagship 2^20-leaf benchmark (benches/merkle_tree.rs): build,
proof extraction, verification and updates are batched device work, and the
host sees digests only at explicit conversion points (``root()``,
``generate_proof()``).

Three instantiations:
  * :func:`sha256_device_tree`: byte digests ``(n, 32)`` uint8; a whole level
    is one SHA-256 kernel launch (padding and byte order in the kernel), and
    the first inner level adds the length prefix with one ``torch.cat``;
  * :func:`poseidon_device_tree`: digests are ``(n, W)`` Montgomery words; the
    leaf hash is ``permute([0, x, 0])[1]`` and ``compress(l, r)`` is
    ``permute([0, l, r])[1]``, the exact duplex schedule of the reference's
    sponge CRHs (src/crh/poseidon/mod.rs:58-79); a whole level is one
    permutation launch.  The JAX package builds this tree on RNS residues
    (``poseidon_rns_device_tree``); the port builds it on limbs, so its digest
    rows are already canonical;
  * :func:`pedersen_device_tree`: the reference's primary byte-tree config
    (Pedersen leaf and two-to-one hashes over a TE curve); digest rows are
    the x || y uncompressed bytes of the affine Pedersen outputs, and a whole
    level is one grouped MSM launch plus the affine step.

On a CUDA tree, ``proof_rows`` and ``verify_rows_batch`` become one CUDA
graph replay each from the second call at a key (the batch, the inputs'
shapes and dtypes, the device): :class:`GraphCache` and :class:`_Graph`.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Callable, List, Sequence

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.crh.pedersen import PedersenCRH, PedersenParameters, Window
from crypto_primitives_tpu_torch.models.merkle_tree import ByteDigestConverter, Path, tree_height
from crypto_primitives_tpu_torch.models.sponge.poseidon import PoseidonConfig, permute
from crypto_primitives_tpu_torch.ops import affine_kernel, msm_kernel, msm_sw_kernel, poseidon_kernel, sha256_kernel
from crypto_primitives_tpu_torch.ops.curve import affine_to_uncompressed_bytes
from crypto_primitives_tpu_torch.ops.field import FieldSpec
from crypto_primitives_tpu_torch.ops.sha256 import sha256
from crypto_primitives_tpu_torch.utils import profiling


@functools.lru_cache(maxsize=256)
def _multipath_schedule(idx: tuple, n_levels: int) -> tuple:
    """Host-side gather plan for the deduplicated MultiPath verify: per level,
    (width of the computed-digest buffer, one [lefts | rights] source index
    array).  Sources below the width point at computed digests (the
    reference's LUT-first precedence); sources at or above it point at
    proof-supplied rows, offset by the proving leaf's row."""
    m = len(idx)
    if len(set(idx)) != m:
        raise ValueError("indexes must be distinct")
    schedule = []
    known = {p: s for s, p in enumerate(idx)}
    reps = list(range(m))
    for _ in range(n_levels + 1):
        parents = sorted({p >> 1 for p in known})
        lsrc, rsrc, new_reps = [], [], []
        for p in parents:
            srcs = []
            for c in (2 * p, 2 * p + 1):
                if c in known:
                    srcs.append(known[c])  # computed: current buffer
                else:
                    srcs.append(len(known) + reps[known[c ^ 1]])  # from the proof
            lsrc.append(srcs[0])
            rsrc.append(srcs[1])
            child = 2 * p if 2 * p in known else 2 * p + 1
            new_reps.append(reps[known[child]])
        schedule.append((len(known), np.asarray(lsrc + rsrc, dtype=np.int64)))
        known = {p: s for s, p in enumerate(parents)}
        reps = new_reps
    if list(known) != [0]:
        raise ValueError("paths did not converge to the root")
    return tuple(schedule)


# CUDA graphs a tree keeps (and keys it remembers as seen once), least
# recently used first out
GRAPH_KEYS = 4

# The kernel wrappers' launch counters.  A replay launches the captured kernels
# without passing through the wrappers, so it raises each counter by what the
# capture added to it.
_COUNTERS = ((sha256_kernel, "launches"), (poseidon_kernel, "launches"), (poseidon_kernel, "group_launches"),
             (msm_kernel, "launches"), (msm_sw_kernel, "launches"), (affine_kernel, "launches"))


class GraphCache:
    """Which calls replay a CUDA graph, by key.  :meth:`get` returns None for
    a key seen for the first time (the caller runs eagerly, which also makes
    every first-use upload), ``capture()`` for a key seen again, kept as the
    key's entry, and that entry from then on.  It keeps at most ``size``
    entries and ``size`` keys seen once, least recently used first out, so a
    one-off shape never pays for a capture and varying shapes cannot grow
    memory without limit."""

    def __init__(self, size: int = GRAPH_KEYS):
        self.size = size
        self.seen: OrderedDict = OrderedDict()
        self.entries: OrderedDict = OrderedDict()

    @staticmethod
    def _put(store: OrderedDict, key, value, size: int) -> None:
        store[key] = value
        if len(store) > size:
            store.popitem(last=False)

    def get(self, key, capture):
        if key in self.entries:
            self.entries.move_to_end(key)
            return self.entries[key]
        if key not in self.seen:
            self._put(self.seen, key, None, self.size)
            return None
        del self.seen[key]
        entry = capture()
        self._put(self.entries, key, entry, self.size)
        return entry


class _Graph:
    """``fn(*inputs)`` captured as one CUDA graph on copies of ``inputs``.  The
    call before at the same key ran ``fn`` eagerly, so the capture reads
    nothing from the host.  A call copies its inputs in, replays (span
    ``kernel.graph``, ``rows``: the kernel rows the graph runs), raises the
    launch counters by the captured launches, and hands out copies of the
    outputs: a later replay overwrites them.  Nothing catches a failed
    capture."""

    def __init__(self, fn, inputs, rows: int):
        self.inputs = [x.clone() for x in inputs]
        self.rows = rows
        before = [getattr(mod, name) for mod, name in _COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)
        self.launched = []
        for (mod, name), count in zip(_COUNTERS, before):
            self.launched.append(getattr(mod, name) - count)
            setattr(mod, name, count)  # the capture ran nothing; the replays count

    def __call__(self, inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        with profiling.annotate("kernel.graph", self.rows):
            self.graph.replay()
        for (mod, name), count in zip(_COUNTERS, self.launched):
            setattr(mod, name, getattr(mod, name) + count)
        return tuple(out.clone() for out in self.outputs)


class DeviceMerkleTree:
    """``inner_levels[0]`` is the root level (1 row); ``inner_levels[-1]`` is
    the bottom inner level (n/2 rows); ``leaf_digests`` is ``(n, ...)``.
    All tensors live on one device, and are updated in place only (the
    graphs read them through the addresses they captured)."""

    def __init__(
        self,
        compress_batch: Callable,
        leaf_digests: torch.Tensor,
        inner_levels: List[torch.Tensor],
        to_host: Callable,
        leaf_convert: Callable = lambda x: x,
    ):
        self.compress_batch = compress_batch
        self.leaf_digests = leaf_digests
        self.inner_levels = inner_levels
        self.to_host = to_host
        # LeafInnerDigestConverter twin (mod.rs:60-88): applied to leaf
        # digests before the bottom inner hash only
        self.leaf_convert = leaf_convert
        self.height = tree_height(int(leaf_digests.shape[0]))
        self.graphs = GraphCache()

    @property
    def device(self) -> torch.device:
        return self.leaf_digests.device

    # -- construction ---------------------------------------------------

    @classmethod
    def build(
        cls,
        leaf_hash_batch: Callable,
        compress_batch: Callable,
        leaves: torch.Tensor,
        to_host: Callable,
        compress_level_batch: Callable,
        leaf_convert: Callable = lambda x: x,
    ) -> "DeviceMerkleTree":
        """Hash ``leaves`` (on their device) and every inner level.

        ``compress_level_batch`` compresses a whole level ``(B, D) -> (B/2, D)``
        from the contiguous pair layout (the children of node i are the
        adjacent rows 2i and 2i+1, so pairing them is a free reshape instead
        of two strided gathers).

        Spans: ``tree.build_tree``, and inside it ``tree.convert_leaves`` and
        one ``tree.hash_level`` a level."""
        n = int(leaves.shape[0])
        if n < 2 or n & (n - 1):
            raise ValueError("the leaf count must be a power of two, at least 2")
        with profiling.annotate("tree.build_tree"):
            leaf_digests = leaf_hash_batch(leaves)
            with profiling.annotate("tree.convert_leaves"):
                cur = leaf_convert(leaf_digests)
            levels = []
            for _ in range(n.bit_length() - 1):
                with profiling.annotate("tree.hash_level"):
                    cur = compress_level_batch(cur)
                levels.append(cur)
            levels.reverse()
            return cls(compress_batch, leaf_digests, levels, to_host, leaf_convert)

    # -- accessors -------------------------------------------------------

    def root_row(self) -> torch.Tensor:
        return self.inner_levels[0][0]

    def root(self):
        return self.to_host(self.root_row().cpu().numpy())

    def canonical_root_row(self) -> torch.Tensor:
        """The root in canonical digest form, for comparing with a root from
        another process (the JAX package's twin, whose RNS rows need a
        conversion).  The port's rows are canonical already (bytes, or fully
        reduced Montgomery words), so this is :meth:`root_row`."""
        return self.root_row()

    # -- proofs ----------------------------------------------------------

    def proof_rows(self, indexes):
        """Batched auth-path gather on the device.

        indexes: (B,) leaf indexes.  Returns (leaf_sibling (B, D), auth
        (B, height-2, D) root first), the array twin of Path.auth_path
        (reference mod.rs:547-569), one gather per level.

        Spans: ``tree.gather_paths``, and inside it either one
        ``tree.gather_level`` a level and ``tree.stack_paths`` (eager), or
        ``kernel.graph`` with ``rows`` 0 (a replay, :meth:`_replayed`)."""
        idx = torch.as_tensor(indexes, dtype=torch.int64, device=self.device)
        with profiling.annotate("tree.gather_paths"):
            return self._replayed("proof_rows", self._gather, (idx,), 0)

    def _gather(self, idx):
        """The eager body of :meth:`proof_rows`."""
        with profiling.annotate("tree.gather_level"):
            leaf_sib = self.leaf_digests.index_select(0, idx ^ 1)
        auth = []
        node = idx >> 1  # index in the bottom inner level
        for level in self.inner_levels[:0:-1]:  # bottom ... level 1; the root is not in a path
            with profiling.annotate("tree.gather_level"):
                auth.append(level.index_select(0, node ^ 1))
                node = node >> 1
        auth.reverse()  # root first
        if not auth:  # 2-leaf tree: the path is just the leaf sibling
            return leaf_sib, self.leaf_digests.new_zeros(
                (idx.shape[0], 0) + tuple(self.leaf_digests.shape[1:])
            )
        with profiling.annotate("tree.stack_paths"):
            return leaf_sib, torch.stack(auth, dim=1)

    def _replayed(self, name: str, fn, inputs: tuple, rows: int):
        """``fn(*inputs)``: eager on a CPU tree and at a key's first call; on a
        CUDA tree from the second call at (``name``, the inputs' shapes and
        dtypes, the device) a replay of the graph captured then
        (:class:`GraphCache`)."""
        if self.device.type != "cuda":
            return fn(*inputs)
        key = (name, *((tuple(x.shape), x.dtype) for x in inputs), str(self.device))
        graph = self.graphs.get(key, lambda: _Graph(fn, inputs, rows))
        return fn(*inputs) if graph is None else graph(inputs)

    def generate_proof(self, index: int) -> Path:
        """Host Path (interoperates with Path.verify)."""
        leaf_sib, auth = self.proof_rows([index])
        return Path(
            leaf_sibling_hash=self.to_host(leaf_sib[0].cpu().numpy()),
            auth_path=[self.to_host(r) for r in auth[0].cpu().numpy()],
            leaf_index=index,
        )

    def verify_rows_batch(self, root_row, leaf_digests, indexes, leaf_sib, auth,
                          root_canonical: bool = False) -> torch.Tensor:
        """Batched verification from already-hashed leaf digests (hash raw
        leaves with the tree's leaf hash first); returns (B,) bool, the
        reference's Ok(false) posture (mod.rs:252-294).  Equality is bitwise
        on digest rows.  ``root_canonical`` says that ``root_row`` is in
        canonical form (a root from another process); the JAX package then
        canonicalizes the recomputed root, and here every row is canonical
        already, so both settings compare the same rows.

        Spans: ``tree.verify_paths``, and inside it either
        ``tree.convert_leaves``, then a level's sides picked
        (``tree.select_level``) and hashed (``tree.hash_level``) (eager), or
        ``kernel.graph`` with ``rows`` B x (height - 1), the rows the levels
        hash (a replay, :meth:`_replayed`)."""
        dev = self.device
        idx = torch.as_tensor(indexes, dtype=torch.int64, device=dev)
        B = idx.shape[0]
        with profiling.annotate("tree.verify_paths"):
            leaf_digests, leaf_sib, auth, root_row = (
                torch.as_tensor(x, device=dev) for x in (leaf_digests, leaf_sib, auth, root_row)
            )
            d = tuple(self.leaf_digests.shape[1:])
            if tuple(leaf_digests.shape) != (B,) + d or tuple(leaf_sib.shape) != (B,) + d:
                raise ValueError(
                    f"leaf_digests/leaf_sib must be (B, D) = {(B,) + d} digest rows (got "
                    f"{tuple(leaf_digests.shape)} / {tuple(leaf_sib.shape)}); hash raw leaves "
                    "with the tree's leaf hash first"
                )
            if auth.dim() != 2 + len(d) or auth.shape[0] != B:
                raise ValueError(f"auth must be (B, height-2, D) as proof_rows returns (got {tuple(auth.shape)})")
            node_row = tuple(self.inner_levels[0].shape[1:])  # what the compress returns
            if tuple(root_row.shape) != node_row:
                raise ValueError(
                    f"root_row must be one digest row of shape {node_row} (got "
                    f"{tuple(root_row.shape)}); use canonical_root_row()/root_canonical=True for "
                    "roots from another process"
                )
            inputs = (root_row, leaf_digests, idx, leaf_sib, auth)
            return self._replayed("verify_rows_batch", self._verify, inputs, B * (auth.shape[1] + 1))[0]

    def _verify(self, root_row, leaf_digests, idx, leaf_sib, auth) -> tuple:
        """The eager body of :meth:`verify_rows_batch`: its verdicts, as a
        one-tuple like every body a graph captures."""

        def pick(cond, a, b):
            return torch.where(cond.unsqueeze(-1), a, b)

        with profiling.annotate("tree.convert_leaves"):
            curr = self.leaf_convert(leaf_digests)
            sibs = [self.leaf_convert(leaf_sib)]
        sibs += auth.unbind(1)[::-1]  # bottom up: auth is stored root first
        node = idx
        for sib in sibs:
            with profiling.annotate("tree.select_level"):
                is_left = (node & 1) == 0
                left, right = pick(is_left, curr, sib), pick(is_left, sib, curr)
                node = node >> 1
            with profiling.annotate("tree.hash_level"):
                curr = self.compress_batch(left, right)
        return ((curr == root_row).all(dim=-1),)

    def multipath_verify_rows(self, root_row, leaf_digests, indexes: Sequence[int], leaf_sib, auth) -> torch.Tensor:
        """Deduplicated batch verification, the twin of MultiPath's memoized
        verify (reference mod.rs:272-330): every shared inner node is hashed
        once, and computed digests take precedence over proof-supplied
        siblings.  ``indexes`` are distinct host ints (the gather plan is made
        on the host); ``leaf_sib`` (m, D) and ``auth`` (m, height-2, D) root
        first, as proof_rows returns them.  Returns a scalar bool tensor."""
        dev = self.device
        auth = torch.as_tensor(auth, device=dev)
        n_levels = int(auth.shape[1])
        schedule = _multipath_schedule(tuple(int(i) for i in indexes), n_levels)
        cur = self.leaf_convert(torch.as_tensor(leaf_digests, device=dev))
        sib0 = self.leaf_convert(torch.as_tensor(leaf_sib, device=dev))
        for li, (k_prev, src) in enumerate(schedule):
            # proof rows for this level: leaf siblings at the bottom, then the
            # auth columns bottom-up (stored root first)
            rows = sib0 if li == 0 else auth[:, n_levels - li]
            buf = torch.cat([cur[:k_prev], rows], dim=0)
            both = buf.index_select(0, torch.from_numpy(src).to(dev))
            k = src.shape[0] // 2
            cur = self.compress_batch(both[:k], both[k:])
        return (cur[0] == torch.as_tensor(root_row, device=dev)).all()

    # -- updates ----------------------------------------------------------

    def update_batch(self, indexes: Sequence[int], new_leaf_digests) -> None:
        """Write new leaf digests and recompute the touched ancestors level by
        level (duplicate parents recompute the same value, so no dedup pass
        is needed); twin of mod.rs:629-680.  The tree's own tensors are
        updated in place."""
        dev = self.device
        idx = torch.as_tensor(indexes, dtype=torch.int64, device=dev)
        self.leaf_digests[idx] = torch.as_tensor(new_leaf_digests, device=dev)
        node = idx >> 1
        for li in range(len(self.inner_levels) - 1, -1, -1):
            bottom = li == len(self.inner_levels) - 1
            child = self.leaf_digests if bottom else self.inner_levels[li + 1]
            left = child.index_select(0, node * 2)
            right = child.index_select(0, node * 2 + 1)
            if bottom:
                left, right = self.leaf_convert(left), self.leaf_convert(right)
            self.inner_levels[li][node] = self.compress_batch(left, right)
            node = node >> 1


# --------------------------------------------------------------------------
# SHA-256 byte tree (the reference's flagship bench configuration)
# --------------------------------------------------------------------------


def _sha_leaf_hash(leaves: torch.Tensor) -> torch.Tensor:
    with profiling.annotate("tree.hash_leaves"):
        return sha256(leaves, device=leaves.device)


def _sha_compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return sha256(torch.cat([left, right], dim=-1), device=left.device)


def _sha_compress_level(cur: torch.Tensor) -> torch.Tensor:
    """Whole-level compress: l || r of adjacent rows is a reshape."""
    return sha256(cur.reshape(cur.shape[0] // 2, 2 * cur.shape[1]), device=cur.device)


_SHA_CONVERT = ByteDigestConverter(32).convert_batch


def sha256_tree_fns():
    """(leaf_hash, compress, compress_level, leaf_convert) of the SHA-256 byte
    tree, for the sharded trees (``parallel/merkle_tree_sharded.py``)."""
    return _sha_leaf_hash, _sha_compress, _sha_compress_level, _SHA_CONVERT


def sha256_device_tree(leaves, device=None) -> DeviceMerkleTree:
    """leaves: ``(n, N)`` uint8.  Digests are (32,) uint8 rows; the semantics
    are the generic MerkleTree's with Sha256CRH + ByteDigestConverter."""
    leaves = torch.as_tensor(leaves, dtype=torch.uint8, device=resolve_device(device))
    return DeviceMerkleTree.build(
        _sha_leaf_hash,
        _sha_compress,
        leaves,
        to_host=lambda row: bytes(np.asarray(row).astype(np.uint8)),
        leaf_convert=_SHA_CONVERT,
        compress_level_batch=_sha_compress_level,
    )


# --------------------------------------------------------------------------
# Poseidon field tree on Montgomery words
# --------------------------------------------------------------------------


def poseidon_tree_fns(config: PoseidonConfig):
    """(leaf_hash, compress, compress_level) for the Poseidon tree: a fresh
    sponge state with the inputs in rate slots 1.. , one permutation, the
    squeezed slot 1."""
    if config.rate < 2 or config.capacity != 1:
        raise ValueError("the Poseidon device tree needs rate >= 2 and capacity 1")
    t = config.t

    def run(rows: torch.Tensor) -> torch.Tensor:
        # rows (B, k, W) fill slots 1..k of zeroed states
        B, k, W = rows.shape
        zero = rows.new_zeros((B, 1, W))
        state = torch.cat([zero, rows, rows.new_zeros((B, t - 1 - k, W))], dim=1)
        return permute(config, state)[:, 1]

    def leaf_hash(x: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("tree.hash_leaves"):
            return run(x.unsqueeze(1))

    def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        return run(torch.stack([left, right], dim=1))

    def compress_level(cur: torch.Tensor) -> torch.Tensor:
        return run(cur.reshape(cur.shape[0] // 2, 2, cur.shape[1]))

    return leaf_hash, compress, compress_level


def poseidon_device_tree(spec: FieldSpec, config: PoseidonConfig, leaf_elements, device=None) -> DeviceMerkleTree:
    """leaf_elements: Python ints (field values), or an ``(n, W)`` int32
    tensor of Montgomery words.  ``root()`` and ``generate_proof()`` give
    canonical ints that match the generic MerkleTree with the Poseidon CRHs
    (``PoseidonCRH`` leaves of one element, ``PoseidonTwoToOneCRH`` nodes)."""
    if config.field is not spec:
        raise ValueError("config.field must be spec")
    dev = resolve_device(device)
    if isinstance(leaf_elements, torch.Tensor):
        leaves = leaf_elements.to(dev)
    else:
        leaves = torch.from_numpy(spec.pack(list(leaf_elements))).to(dev)
    leaf_hash, compress, compress_level = poseidon_tree_fns(config)
    return DeviceMerkleTree.build(
        leaf_hash, compress, leaves, to_host=lambda row: int(spec.unpack(row)),
        compress_level_batch=compress_level,
    )


# --------------------------------------------------------------------------
# Pedersen byte tree (the reference's primary byte-tree config,
# src/merkle_tree/tests/mod.rs:5-50: Pedersen leaf and two-to-one hashes over
# a TE curve, ByteDigestConverter = x || y uncompressed bytes)
# --------------------------------------------------------------------------


def pedersen_tree_fns(curve, leaf_params: PedersenParameters, two_params: PedersenParameters,
                      leaf_window: Window, two_window: Window):
    """(leaf_hash, compress, compress_level, to_host) for the Pedersen byte
    tree.  Digest rows are the (2 * bigint_bytes,) uint8 x || y bytes of the
    affine outputs; to_host turns a row into the (x, y) tuple of the generic
    MerkleTree's PointDigestDomain."""
    leaf_crh = PedersenCRH(curve, leaf_window)
    two_crh = PedersenCRH(curve, two_window)
    cb = curve.base.bigint_bytes
    if 2 * 2 * cb * 8 > two_crh.input_size_bits:
        raise ValueError("the two-to-one window is too small for two digests")

    def digest(crh: PedersenCRH, params: PedersenParameters, inputs: torch.Tensor) -> torch.Tensor:
        return affine_to_uncompressed_bytes(curve, crh.evaluate_batch(params, inputs, device=inputs.device))

    def leaf_hash(leaves: torch.Tensor) -> torch.Tensor:
        return digest(leaf_crh, leaf_params, leaves)

    def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        return digest(two_crh, two_params, torch.cat([left, right], dim=-1))

    def compress_level(cur: torch.Tensor) -> torch.Tensor:
        # children of node i are adjacent rows, so l || r is a reshape
        return digest(two_crh, two_params, cur.reshape(cur.shape[0] // 2, 2 * cur.shape[1]))

    def to_host(row) -> tuple:
        b = bytes(np.asarray(row).astype(np.uint8))
        return (int.from_bytes(b[:cb], "little"), int.from_bytes(b[cb:2 * cb], "little"))

    return leaf_hash, compress, compress_level, to_host


def pedersen_device_tree(curve, leaf_params: PedersenParameters, two_params: PedersenParameters,
                         leaf_window: Window, two_window: Window, leaves, device=None) -> DeviceMerkleTree:
    """leaves: (n, LB) uint8.  Digest rows are the x || y uncompressed bytes
    of affine Pedersen outputs; ``root()`` and ``generate_proof()`` give
    affine (x, y) tuples that match the generic MerkleTree with Pedersen CRHs,
    ``PointDigestDomain`` and ``PointToBytesDigestConverter``."""
    leaves = torch.as_tensor(leaves, dtype=torch.uint8, device=resolve_device(device))
    leaf_hash, compress, compress_level, to_host = pedersen_tree_fns(
        curve, leaf_params, two_params, leaf_window, two_window)
    return DeviceMerkleTree.build(leaf_hash, compress, leaves, to_host, compress_level_batch=compress_level)
