"""The twisted-Edwards grouped MSM kernel and its plain PyTorch version.

``grouped_msm`` is the counterpart of the JAX package's TPU kernel
``grouped_msm_pallas`` (``ops/msm_rns_pallas.py``): for each batch row b it
returns sum_g table[g][idx[b, g]] as an extended point (X, Y, T, Z).  The
table is :func:`curve_fast.pack_table_grouped`'s: group g holds the 2^w
subset sums of w fixed points, affine as (x, y, d*x*y), in Montgomery words.
On a CUDA tensor it launches ``csrc/msm_te.cu`` (one thread per row, one
mixed add-2008-hwcd addition per group, 8 carry-chain products, the indices
staged in shared memory, table points read as 16-byte vectors); on a CPU
tensor it runs :func:`grouped_msm_plain`, which takes the same steps in the
same order, so the two agree word for word.  There is no fallback between them.
Span ``kernel.k4`` (``rows``: the batch rows) covers both branches.
"""

from __future__ import annotations

import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.utils import profiling

# Kernel launches in this process; the benchmark's programs and the card
# tests read it.
launches = 0


def _check_curve(curve) -> None:
    if curve.a != curve.base.p - 1:
        raise ValueError(f"{curve.name}: the grouped TE MSM is specialised for a = -1")


def _mixed_add_digits(curve, acc: torch.Tensor, combo: torch.Tensor) -> torch.Tensor:
    """acc (B, 4, L) extended + combo (B, 3, L) affine (x, y, d x y), a = -1:
    A = X1 x2, B = Y1 y2, C = T1 (d x2 y2), E = (X1+Y1)(x2+y2) - A - B,
    F = Z1 - C, G = Z1 + C, H = B + A; (E F, G H, E H, F G)."""
    q = curve.base
    X1, Y1, T1, Z1 = acc.unbind(-2)
    x2, y2, t2 = combo.unbind(-2)
    s = ff.add_digits(q, torch.stack([X1, x2]), torch.stack([Y1, y2]))
    r1 = ff.mont_mul_digits(q, torch.stack([X1, Y1, T1, s[0]], dim=-2), torch.stack([x2, y2, t2, s[1]], dim=-2))
    A, B, C, S = r1.unbind(-2)
    diff = ff.sub_digits(q, torch.stack([S, Z1]), torch.stack([A, C]))
    E, F = ff.sub_digits(q, diff[0], B), diff[1]
    G, H = ff.add_digits(q, torch.stack([Z1, B]), torch.stack([C, A]))
    return ff.mont_mul_digits(q, torch.stack([E, G, E, F], dim=-2), torch.stack([F, H, H, G], dim=-2))


def grouped_msm_plain(curve, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table (G, 2^w, 3, W), idx (B, G) -> (B, 4, W),
    the groups added in order to the identity."""
    _check_curve(curve)
    tab = ff.to_digits(table)
    ident = curve._consts(table.device)["identity"]
    acc = ident.expand((idx.shape[0],) + ident.shape)
    idx = idx.to(torch.int64)
    for g in range(table.shape[0]):
        acc = _mixed_add_digits(curve, acc, tab[g].index_select(0, idx[:, g]))
    return ff.from_digits(acc)


def check_operands(name: str, table: torch.Tensor, idx: torch.Tensor, W: int) -> None:
    """What both MSM kernels take: one CUDA device, an int32 (G, 2^w, 3, W)
    table and int32 (B, G) indices, both contiguous."""
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one device, not {table.device} / {idx.device}")
    if table.dtype != torch.int32 or table.dim() != 4 or tuple(table.shape[2:]) != (3, W):
        raise ValueError(f"table must be int32 (G, 2^w, 3, {W}), got {table.dtype} {tuple(table.shape)}")
    G, E = table.shape[0], table.shape[1]
    if E < 2 or E & (E - 1):
        raise ValueError(f"the table must hold 2^w combos per group, got {E}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] != G:
        raise ValueError(f"idx must be int32 (B, {G}), got {idx.dtype} {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")


def grouped_msm(curve, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sum_g table[g][idx[b, g]] for every row b: the CUDA kernel for CUDA
    tensors, :func:`grouped_msm_plain` for CPU ones.  ``idx`` entries must lie
    in [0, 2^w), as :func:`curve_fast.window_indices` makes them; nothing
    checks it.  For another index the plain version raises and the kernel
    returns a meaningless sum (its read stays inside the table).  The kernel
    reads the table in 16-byte vectors: a table that does not start on a
    16-byte boundary (a view at an odd offset) raises."""
    global launches
    with profiling.annotate("kernel.k4", idx.shape[0]):
        if table.device.type == "cpu" and idx.device.type == "cpu":
            return grouped_msm_plain(curve, table, idx)
        _check_curve(curve)
        q = curve.base
        W = q.num_words
        check_operands("msm_te", table, idx, W)
        (G, E), B = table.shape[:2], idx.shape[0]
        out = torch.empty((B, 4, W), dtype=torch.int32, device=table.device)
        if B == 0:
            return out
        consts = ff.host_words(q, [q.p, q.R_mod_p])  # p, the Montgomery one
        lib = build.load("msm_te")
        err = lib.msm_te(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), consts.ctypes.data, q.n0_word,
            B, G, E, W, table.device.index or 0, torch.cuda.current_stream(table.device).cuda_stream,
        )
        build.check(lib, err, "msm_te")
        launches += 1
        return out
