"""The short-Weierstrass grouped MSM kernel and its plain PyTorch version.

``grouped_msm`` is the counterpart of the JAX package's TPU kernel
``grouped_msm_sw_pallas`` (``ops/msm_sw_rns_pallas.py``): for each batch row b
it returns sum_g table[g][idx[b, g]] as a projective point (X, Y, Z).  The
table is :func:`curve_sw_fast.pack_table_grouped`'s: group g holds the 2^w
subset sums of w fixed points, projective, in Montgomery words.  On a CUDA
tensor it launches ``csrc/msm_sw.cu``; on a CPU tensor it runs
:func:`grouped_msm_plain`.  Both split each row's G groups into k contiguous
ranges of ceil(G / k) groups, sum each range in order from the identity with
complete Renes-Costello-Batina additions (``curve_sw.sw_add``'s formulas), and
merge the k partial sums in one pairwise tree, (P0 + P1) + (P2 + P3) and so
on, an odd one carried up a round.  k is fixed per kernel build in
:data:`SPLIT`, which both read, so every intermediate is the same fully
reduced field element in both and the two agree word for word.  There is no
fallback between them.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve_sw import sw_add_digits
from crypto_primitives_tpu_torch.ops.msm_kernel import check_operands

# Threads per batch row, per kernel build (W, a == 0): the fastest of
# k = 1, 2, 3, 4, 8 in native/kernel_times.py at 2^14 rows x 342 groups on the
# H100 (PERF.md section 6; at W = 8 with a = 0 every k > 1 timed the same).
# A curve with no build takes 1 in the plain version, and raises on CUDA
# tensors.
SPLIT = {(8, True): 4, (8, False): 3, (9, False): 3, (12, True): 3}

# Kernel launches in this process; the benchmark's programs and the card
# tests read it.
launches = 0


def split_of(curve) -> int:
    """k, the threads (and group ranges) per row for this curve's build."""
    return SPLIT.get((curve.base.num_words, curve.a == 0), 1)


def split_sum_digits(curve, tab: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """The grouped sum of digit tables (G, 2^w, 3, L) at indices (B, G) with
    each row split k ways: k in-order range sums, then the pairwise merge."""
    G, B = tab.shape[0], idx.shape[0]
    chunk = -(-G // k)
    ident = curve._consts(tab.device)["identity"]
    parts = ident.expand((k, B) + ident.shape)
    idx = idx.to(torch.int64)
    for step in range(chunk):
        # ranges [j chunk, min(G, (j+1) chunk)) shrink with j: the ones that
        # still have a group at this step are a prefix 0 .. m-1
        m = sum(1 for j in range(k) if j * chunk + step < G)
        g = torch.arange(m, device=tab.device) * chunk + step
        pts = tab[g.unsqueeze(1), idx[:, g].T]  # (m, B, 3, L)
        parts = torch.cat([sw_add_digits(curve, parts[:m], pts), parts[m:]])
    parts = list(parts.unbind(0))
    while len(parts) > 1:
        merged = [sw_add_digits(curve, parts[i], parts[i + 1]) for i in range(0, len(parts) - 1, 2)]
        parts = merged + parts[len(parts) - len(parts) % 2:]
    return parts[0]


def grouped_msm_plain(curve, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table (G, 2^w, 3, W), idx (B, G) -> (B, 3, W),
    split as the kernel splits it (:func:`split_of`)."""
    return ff.from_digits(split_sum_digits(curve, ff.to_digits(table), idx, split_of(curve)))


def grouped_msm(curve, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sum_g table[g][idx[b, g]] for every row b: the CUDA kernel for CUDA
    tensors, :func:`grouped_msm_plain` for CPU ones.  The kernel is built for
    W = 8 and W = 9 (any a) and W = 12 (a = 0); another curve raises on CUDA
    tensors.  ``idx`` entries must lie in [0, 2^w), as
    ``msm_kernel.grouped_msm``'s do, with the same result for another index."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return grouped_msm_plain(curve, table, idx)
    q = curve.base
    W = q.num_words
    check_operands("msm_sw", table, idx, W)
    (G, E), B = table.shape[:2], idx.shape[0]
    out = torch.empty((B, 3, W), dtype=torch.int32, device=table.device)
    if B == 0:
        return out
    # p, the Montgomery one, a and 3b in Montgomery form
    consts = ff.host_words(q, [q.p, q.R_mod_p, q.to_mont(curve.a), q.to_mont(3 * curve.b % q.p)])
    lib = build.load("msm_sw")
    err = lib.msm_sw(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), consts.ctypes.data, q.n0_word,
        int(curve.a == 0), B, G, E, W, split_of(curve), table.device.index or 0,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    build.check(lib, err, "msm_sw")
    global launches
    launches += 1
    return out
