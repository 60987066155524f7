"""R1CS satisfaction on the card: Az o Bz == Cz in Montgomery form.

Twin of ``crypto_primitives_tpu/r1cs/device_check.py``.  The reference's
tests call ``cs.is_satisfied()`` (host, constraint by constraint); here the
whole constraint matrix is evaluated at once in torch on ``device``:
a gather of z, one Montgomery product per distinct (column, coefficient)
pair of a matrix, gathered into the matrix's nonzero slots, an int64
``index_add_`` of the products' 16-bit digits into their rows, a carry,
a reduction of each row below p, and one Montgomery product a * b compared
word for word with c.

Table-driven gadgets (Pedersen and Bowe-Hopwood windowed sums) produce
millions of nonzeros but only thousands of distinct (column, coefficient)
pairs, so the products are computed per pair (``_pack_matrix``), not per
nonzero.  It is plain torch on the card: the JAX package has no Pallas
kernel for it.
"""

from __future__ import annotations

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops import field as ff


def _coeff_ids(coeffs):
    """coefficient list -> (distinct values, (nnz,) int32 index)."""
    vals = list(set(coeffs))
    ids = {c: i for i, c in enumerate(vals)}
    return vals, np.fromiter(map(ids.__getitem__, coeffs), np.int32, len(coeffs))


def _pack_matrix(spec, rows_idx, cols_idx, coeffs, device):
    """Host-side COO prep: returns (rows, pair_idx, pair_cols, pair_coeff_m,
    max_terms) on ``device``, with one Montgomery-packed coefficient per
    distinct (column, coefficient) pair."""
    if len(coeffs) == 0:
        rows_idx, cols_idx, coeffs = [0], [0], [0]
    vals, cidx = _coeff_ids(coeffs)
    packed = spec.pack(vals)  # (C, W)
    cols = np.asarray(cols_idx, np.int64)
    key = (cols << 32) | cidx
    pkeys, pidx = np.unique(key, return_inverse=True)
    pair_cols = pkeys >> 32
    pair_coeff_m = packed[(pkeys & 0xFFFFFFFF).astype(np.int64)]
    rows = np.asarray(rows_idx, np.int64)
    max_terms = int(np.bincount(rows).max())

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dev(rows), dev(pidx.astype(np.int64)), dev(pair_cols), dev(pair_coeff_m), max_terms


def _p_shifted_digits(spec, j: int, ndigits: int, device) -> torch.Tensor:
    return torch.tensor(ff._int_to_limbs(spec.p << j, ndigits).astype(np.int64), device=device)


def rows_eval(spec, matrix, z_mont: torch.Tensor, num_rows: int) -> torch.Tensor:
    """<M_i, z> for every row i of one packed matrix: ``(num_rows, W)``, or
    ``(num_rows, N, W)`` for a batched witness matrix ``(V, N, W)``; fully
    reduced Montgomery words."""
    rows, pair_idx, pair_cols, pair_coeff_m, max_terms = matrix
    zg = z_mont[pair_cols]  # (P, W) or (P, N, W)
    cm = pair_coeff_m[:, None, :] if zg.dim() == 3 else pair_coeff_m
    prods = ff.mont_mul(spec, cm, zg)[pair_idx]  # one product per pair, into its slots
    # each canonical 16-bit digit summed into its row: a row's sum is below
    # max_terms * 2^16 per digit, far inside int64
    D = spec.num_digits + 2
    digits = ff.to_digits(prods)
    sums = digits.new_zeros((num_rows,) + digits.shape[1:-1] + (D,))
    sums[..., : spec.num_digits].index_add_(0, rows, digits)
    u, _ = ff._carry(sums)  # the row's value < max_terms * p, in D canonical digits
    # subtract p * 2^j where it fits, j from the top: below p after j = 0
    for j in reversed(range(max(max_terms.bit_length() - 1, 0) + 1)):
        u = ff._reduce(u, _p_shifted_digits(spec, j, D, u.device), 1)
    return ff.from_digits(u[..., : spec.num_digits])


def check_satisfied_device(cs, device=None) -> bool:
    """``cs.is_satisfied()`` evaluated on ``device`` (``None`` means CUDA),
    bit-exact."""
    dev = resolve_device(device)
    spec = cs.field
    n = cs.num_constraints
    if n == 0:
        return True
    coo = cs.to_coo()
    z = torch.from_numpy(spec.pack(cs.assignments)).to(dev)  # Montgomery
    a, b, c = (rows_eval(spec, _pack_matrix(spec, *coo[m], dev), z, n) for m in "abc")
    return bool(torch.equal(ff.mont_mul(spec, a, b), c))
