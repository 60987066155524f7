"""The short-Weierstrass grouped MSM kernel and its plain PyTorch version.

``grouped_msm`` is the counterpart of the JAX package's TPU kernel
``grouped_msm_sw_pallas`` (``ops/msm_sw_rns_pallas.py``): for each batch row b
it returns sum_g table[g][idx[b, g]] as a projective point (X, Y, Z).  The
table is :func:`curve_sw_fast.pack_table_grouped`'s: group g holds the 2^w
subset sums of w fixed points, projective, in Montgomery words.  On a CUDA
tensor it launches ``csrc/msm_sw.cu`` (one thread per row, one complete
Renes-Costello-Batina addition per group); on a CPU tensor it runs
:func:`grouped_msm_plain`, which adds the same points in the same order with
``curve_sw.sw_add``'s formulas.  Every intermediate is the same fully reduced
field element in both, so the two agree word for word.  There is no fallback
between them.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.curve_sw import sw_add_digits
from crypto_primitives_tpu_torch.ops.msm_kernel import check_operands

# Kernel launches in this process; chip_smoke.py resets and reads it.
launches = 0


def grouped_msm_plain(curve, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table (G, 2^w, 3, W), idx (B, G) -> (B, 3, W),
    the groups added in order to the identity."""
    curve.base.require_words()
    tab = ff.to_digits(table)
    ident = curve._consts(table.device)["identity"]
    acc = ident.expand((idx.shape[0],) + ident.shape)
    idx = idx.to(torch.int64)
    for g in range(table.shape[0]):
        acc = sw_add_digits(curve, acc, tab[g].index_select(0, idx[:, g]))
    return ff.from_digits(acc)


def grouped_msm(curve, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sum_g table[g][idx[b, g]] for every row b: the CUDA kernel for CUDA
    tensors, :func:`grouped_msm_plain` for CPU ones.  The kernel is built for
    W = 8 (any a) and W = 12 (a = 0); another curve raises on CUDA tensors.
    ``idx`` entries must lie in [0, 2^w), as ``msm_kernel.grouped_msm``'s
    do, with the same result for another index."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return grouped_msm_plain(curve, table, idx)
    q = curve.base
    W = q.require_words()
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
        int(curve.a == 0), B, G, E, W, table.device.index or 0,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    build.check(lib, err, "msm_sw")
    global launches
    launches += 1
    return out
