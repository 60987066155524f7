"""Sparse factorization of the Poseidon partial-round MDS layers.

The port's own copy of the JAX package's host math
(``crypto_primitives_tpu/ops/poseidon_sparse.py``; the port imports nothing
of that package).  The dense MDS matmul of each partial round factors as
M = S M' with S sparse (dense first row and column, identity elsewhere) and
M' = diag(1, Mhat); moving the M' factors right through the element-0-only
S-boxes and merging them into the matmul before the run gives a schedule in
which partial rounds apply only sparse matrices (2t - 1 products instead of
t^2), and the last dense matmul before the run absorbs the accumulated
factors.  The round constants transform alongside: a partial round's ark
vector collapses to a scalar on element 0, plus one vector fold on the run's
last round.  Only HOW the linear layers are computed changes; the outputs are
equal mod p to the reference permutation
(crypto-primitives/src/sponge/poseidon/mod.rs:98-121).

The JAX package caps a run's length (``max_run_len``) because its RNS values
grow in a sparse round.  The port's words are fully reduced after every
round, so :func:`port_schedule` takes one run over every partial round but
the last, and the trivial schedule (every round dense) where the
factorization meets a singular Mhat.

Everything here is exact host math over Python ints mod p.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


def _matmul(A, B, p):
    n, m, q = len(A), len(B), len(B[0])
    assert len(A[0]) == m
    return [
        [sum(A[i][k] * B[k][j] for k in range(m)) % p for j in range(q)]
        for i in range(n)
    ]


def _matvec(A, x, p):
    return [sum(A[i][k] * x[k] for k in range(len(x))) % p for i in range(len(A))]


def _inv_mat(A, p):
    n = len(A)
    M = [list(r) + [int(i == j) for j in range(n)] for i, r in enumerate(A)]
    for c in range(n):
        piv = next((r for r in range(c, n) if M[r][c] % p), None)
        if piv is None:
            raise ZeroDivisionError("singular matrix")
        M[c], M[piv] = M[piv], M[c]
        iv = pow(M[c][c], -1, p)
        M[c] = [v * iv % p for v in M[c]]
        for r in range(n):
            if r != c and M[r][c]:
                f = M[r][c]
                M[r] = [(M[r][j] - f * M[c][j]) % p for j in range(2 * n)]
    return [row[n:] for row in M]


def _factor(Mi, p):
    """Mi = S @ M' with M' = diag(1, Mhat), S = [[m00, v@Mhat^-1],[w, I]]."""
    t = len(Mi)
    Mhat = [row[1:] for row in Mi[1:]]
    w = [row[0] for row in Mi[1:]]
    Mhat_inv = _inv_mat(Mhat, p)
    v = Mi[0][1:]
    v_hat = [
        sum(v[k] * Mhat_inv[k][j] for k in range(t - 1)) % p for j in range(t - 1)
    ]
    Mp = [[1] + [0] * (t - 1)] + [[0] + Mhat[i] for i in range(t - 1)]
    S = [[Mi[0][0]] + v_hat] + [
        [w[i]] + [int(j == i) for j in range(t - 1)] for i in range(t - 1)
    ]
    assert _matmul(S, Mp, p) == [[x % p for x in row] for row in Mi]
    return Mp, S


def _apply_sparse(m00, v_hat, w, x, p):
    """S @ x for S = [[m00, v_hat],[w, I]]: the 2t-1-product form the
    kernel mirrors."""
    out0 = (m00 * x[0] + sum(a * b for a, b in zip(v_hat, x[1:]))) % p
    return [out0] + [(x[i + 1] + w[i] * x[0]) % p for i in range(len(w))]


@dataclass
class SparseSchedule:
    """Kernel-consumable transformed schedule for one PoseidonConfig.

    Indexing: partial rounds i = 0..R_P-1 (absolute round rf2+i).
    `folds[r]` is the vector added after round r's matmul for EVERY round
    r in 0..R_T-1 (replaces the naive ark[r+1]; folds[R_T-1] = 0).
    `pre_full` replaces the MDS of full round rf2-1; `dense_mats[i]`
    replaces the MDS of dense partial round i.  Sparse partial round i
    applies (sp_m00[i], sp_v[i], sp_w[i])."""

    p: int
    t: int
    rf2: int
    R_P: int
    is_sparse: List[bool]
    pre_full: List[List[int]]
    dense_mats: Dict[int, List[List[int]]] = field(default_factory=dict)
    sp_m00: Dict[int, int] = field(default_factory=dict)
    sp_v: Dict[int, List[int]] = field(default_factory=dict)
    sp_w: Dict[int, List[int]] = field(default_factory=dict)
    folds: List[List[int]] = field(default_factory=list)


def build_sparse_schedule(config, max_run_len: int) -> SparseSchedule:
    """Transform `config`'s partial segment into sparse runs of at most
    `max_run_len` rounds, each terminated by a dense round (the last
    partial round is always dense).  Raises ZeroDivisionError if a
    factorization step hits a singular Mhat (:func:`port_schedule` then
    takes the trivial schedule)."""
    p = config.field.p
    t = config.t
    rf2 = config.full_rounds // 2
    R_P = config.partial_rounds
    R_T = config.full_rounds + R_P
    M = [[int(x) % p for x in row] for row in config.mds]
    ark = [[int(x) % p for x in row] for row in config.ark]
    assert max_run_len >= 1

    # naive folds: folds[r] = ark[r+1], last round folds nothing
    folds = [list(ark[r + 1]) for r in range(R_T - 1)] + [[0] * t]

    # choose dense partial rounds: end of each capped run + the final round
    is_sparse = [False] * R_P
    i = 0
    while i < R_P - 1:
        run = min(max_run_len, R_P - 1 - i)
        for j in range(i, i + run):
            is_sparse[j] = True
        i += run + 1  # the round after the run stays dense

    sched = SparseSchedule(
        p=p, t=t, rf2=rf2, R_P=R_P, is_sparse=is_sparse, pre_full=M, folds=folds
    )

    # transform each maximal sparse run [s, s+L) (absolute rounds rf2+s..)
    s = 0
    while s < R_P:
        if not is_sparse[s]:
            sched.dense_mats[s] = M
            s += 1
            continue
        L = 0
        while s + L < R_P and is_sparse[s + L]:
            L += 1
        entry = rf2 + s - 1  # round whose matmul absorbs the M' factors
        # factorization iteration: curr_{j+1} = M'_j @ M; sparse matrices
        # apply in REVERSED build order (first factored = last round)
        sparses = []
        mprimes = []
        curr = M
        for _ in range(L):
            Mp, S = _factor(curr, p)
            sparses.append(S)
            mprimes.append(Mp)
            curr = _matmul(Mp, M, p)
        pre = curr
        # constants: cs[i] = fold of round entry+i (i = 0..L), i.e. the
        # pre-sbox constant of round entry+i+1
        cs = [folds[entry + i] for i in range(L + 1)]
        # step A: mprimes[j] (factored from the run's (L-j)-th round)
        # migrates right past the constant before that round's sbox
        chat = [list(c) for c in cs[:L]]
        for j in range(L):
            chat[L - j - 1] = _matvec(mprimes[j], chat[L - j - 1], p)
        # step B: split each pre-sbox vector into an element-0 scalar and
        # a rest-part that passes the sbox and the round's sparse matrix,
        # merging into the next constant; the final carry lands on the
        # fold of the run's LAST sparse round (a full vector).
        scalars = [0] * L
        carry = [0] * t
        order = list(reversed(sparses))  # application order
        for i2 in range(L):
            tot = [(chat[i2][j] + carry[j]) % p for j in range(t)]
            scalars[i2] = tot[0]
            rest = [0] + tot[1:]
            S = order[i2]
            m00 = S[0][0]
            v_hat = S[0][1:]
            w = [S[r][0] for r in range(1, t)]
            carry = _apply_sparse(m00, v_hat, w, rest, p)
        c_exit = [(a + b) % p for a, b in zip(cs[L], carry)]

        # write back: entry matmul <- pre; folds become scalars; the last
        # sparse round folds c_exit
        if entry == rf2 - 1:
            sched.pre_full = pre
        else:
            sched.dense_mats[s - 1] = pre
        for i2 in range(L):
            e0 = [0] * t
            e0[0] = scalars[i2]
            folds[entry + i2] = e0
        folds[rf2 + s + L - 1] = c_exit
        for i2 in range(L):
            S = order[i2]
            sched.sp_m00[s + i2] = S[0][0]
            sched.sp_v[s + i2] = S[0][1:]
            sched.sp_w[s + i2] = [S[r][0] for r in range(1, t)]
        s += L
    return sched


def permute_with_schedule(config, sched: SparseSchedule, state: List[int]) -> List[int]:
    """Host-exact permutation through the transformed schedule (the
    oracle for the kernel's round structure; must equal the naive
    reference permutation bit-for-bit)."""
    p, t = sched.p, sched.t
    rf2, R_P = sched.rf2, sched.R_P
    R_T = config.full_rounds + R_P
    alpha = config.alpha
    s = [(int(x) + int(a)) % p for x, a in zip(state, config.ark[0])]

    def sbox_all(x):
        return [pow(v, alpha, p) for v in x]

    def sbox0(x):
        return [pow(x[0], alpha, p)] + list(x[1:])

    for r in range(R_T):
        if r < rf2 or r >= rf2 + R_P:
            z = sbox_all(s)
            mat = sched.pre_full if r == rf2 - 1 else config.mds
            s = _matvec([[int(x) for x in row] for row in mat], z, p)
        else:
            i = r - rf2
            z = sbox0(s)
            if sched.is_sparse[i]:
                s = _apply_sparse(
                    sched.sp_m00[i], sched.sp_v[i], sched.sp_w[i], z, p
                )
            else:
                s = _matvec(sched.dense_mats[i], z, p)
        s = [(a + b) % p for a, b in zip(s, sched.folds[r])]
    return s


def trivial_schedule(config) -> SparseSchedule:
    """Every round dense with the config's own MDS; folds[r] = ark[r + 1]."""
    p, t = config.field.p, config.t
    R_T = config.full_rounds + config.partial_rounds
    M = [[int(x) % p for x in row] for row in config.mds]
    return SparseSchedule(
        p=p, t=t, rf2=config.full_rounds // 2, R_P=config.partial_rounds,
        is_sparse=[False] * config.partial_rounds, pre_full=M,
        dense_mats={i: M for i in range(config.partial_rounds)},
        folds=[[int(x) % p for x in config.ark[r + 1]] for r in range(R_T - 1)] + [[0] * t],
    )


def port_schedule(config) -> SparseSchedule:
    """The schedule the port's kernel runs: one sparse run over every partial
    round but the last (the port's words are fully reduced every round, so no
    cap), or the trivial schedule where no run is possible (fewer than two
    partial rounds, no full round before them) or the factorization meets a
    singular Mhat (an MDS that is not Cauchy)."""
    if config.full_rounds < 2 or config.partial_rounds < 2:
        return trivial_schedule(config)
    try:
        return build_sparse_schedule(config, config.partial_rounds - 1)
    except ZeroDivisionError:
        return trivial_schedule(config)


def kernel_rows(config, sched: SparseSchedule):
    """The schedule as the kernel reads it: (n_sparse, rows), rows a flat list
    of field elements (canonical ints) in this order:

      ark[0]                                      t
      mds (full rounds and dense partial rounds)  t * t
      pre_full (the matmul of full round rf2 - 1) t * t
      per sparse round i < n_sparse: m00, v, w    2t - 1 each
      scalar folds, rounds rf2 - 1 .. rf2 + n_sparse - 2   1 each
      vector folds, every other round in order    t each

    The sparse rounds are the first n_sparse partial rounds.  Raises
    ValueError for a schedule outside that layout (a dense partial round
    whose matrix is not the MDS, or a scalar round with a vector fold)."""
    t, rf2, R_P = sched.t, sched.rf2, sched.R_P
    n_sparse = sum(sched.is_sparse)
    if sched.is_sparse != [True] * n_sparse + [False] * (R_P - n_sparse):
        raise ValueError("the sparse rounds must be the first partial rounds")
    M = [[int(x) % sched.p for x in row] for row in config.mds]
    if any(sched.dense_mats[i] != M for i in range(n_sparse, R_P)):
        raise ValueError("every dense partial round must apply the MDS itself")
    scalar_rounds = range(rf2 - 1, rf2 - 1 + n_sparse)
    if any(any(sched.folds[r][1:]) for r in scalar_rounds):
        raise ValueError("a scalar-fold round has a vector fold")
    rows = [int(x) % sched.p for x in config.ark[0]]
    rows += [x for row in M for x in row]
    rows += [x for row in sched.pre_full for x in row]
    for i in range(n_sparse):
        rows += [sched.sp_m00[i]] + list(sched.sp_v[i]) + list(sched.sp_w[i])
    rows += [sched.folds[r][0] for r in scalar_rounds]
    for r in range(len(sched.folds)):
        if r not in scalar_rounds:
            rows += list(sched.folds[r])
    return n_sparse, rows
