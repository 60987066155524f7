"""Batched multilinear sumcheck over the Fiat-Shamir transcript.

Twin of ``crypto_primitives_tpu/models/protocols/sumcheck.py``.  The sumcheck
argument (Lund-Fortnow-Karloff-Nisan) for S = sum over x in {0,1}^m of g(x),
g multilinear and given by its table of 2^m evaluations: each round the
prover sends p_i(0) and p_i(1), the sums of the table's two halves; the
transcript absorbs them and squeezes a challenge r_i; the table folds to
T <- (1 - r_i) T|_0 + r_i T|_1.  After m rounds the table is the single value
g(r).  The JAX package keeps the prover in RNS residues with bound
bookkeeping; the port keeps it in reduced Montgomery words of the sponge's
field (``ops/field.py``), every permutation one launch of ``poseidon_permute``
on the card.  B instances run as one batch.

:func:`sumcheck_prover_compiled` is the twin of the JAX package's one-dispatch
jitted prover: on the card it replays a CUDA graph of the whole m-round
prover.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.models.sponge.fiat_shamir import FiatShamir
from crypto_primitives_tpu_torch.models.sponge.poseidon import PoseidonConfig, PoseidonSponge
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops import poseidon_kernel


def _tree_sum(spec, x: torch.Tensor) -> torch.Tensor:
    """Pairwise sum over axis -2 of (..., n, W) words, n a power of two, as
    the JAX package pairs them: (..., W)."""
    d = ff.to_digits(x)
    while d.shape[-2] > 1:
        d = ff.add_digits(spec, d[..., 0::2, :], d[..., 1::2, :])
    return ff.from_digits(d[..., 0, :])


def sumcheck_prove(config: PoseidonConfig, table, device=None):
    """The prover (the twin of ``sumcheck_prove_rns``).  ``table``:
    (B, 2^m, W) Montgomery words of the multilinear evaluations, moved to
    ``device`` (``None`` means CUDA).  Returns ``(s_row, rounds,
    final_row)``: the claimed sums S (B, W), the m pairs (p_i(0), p_i(1)) of
    (B, W) rows, and g(r) (B, W).

    Transcript schedule (the host oracle's exactly): absorb S, then each
    round absorb [p_i(0), p_i(1)] and squeeze one challenge.  Each round's
    fold is the two products the JAX package makes, one after the other, so
    the memory of only one is live at a time.  No step reads the device from
    the host, so a CUDA graph can capture the whole prover."""
    dev = resolve_device(device)
    table = torch.as_tensor(table, device=dev)
    B, n = table.shape[0], table.shape[1]
    m = n.bit_length() - 1
    if n != 1 << m or m < 1:
        raise ValueError(f"the table must hold 2^m >= 2 evaluations per instance, got {n}")
    spec = config.field
    t = FiatShamir(config, batch_shape=(B,), device=dev)
    s_row = _tree_sum(spec, table)
    t.absorb(s_row[:, None, :])
    one = ff.from_digits(spec._consts(dev)["one"])  # 1 in Montgomery form
    rounds: List[Tuple[torch.Tensor, torch.Tensor]] = []
    T = table
    for _ in range(m):
        half = T.shape[1] // 2
        T0, T1 = T[:, :half], T[:, half:]
        p0, p1 = _tree_sum(spec, T0), _tree_sum(spec, T1)
        rounds.append((p0, p1))
        t.absorb(torch.stack([p0, p1], dim=1))
        r = t.challenge()
        a0 = ff.mont_mul(spec, T0, ff.sub(spec, one, r)[:, None, :])
        a1 = ff.mont_mul(spec, T1, r[:, None, :])
        T = ff.add(spec, a0, a1)
    return s_row, rounds, T[:, 0, :]


class CompiledProver:
    """:func:`sumcheck_prove` as one CUDA graph per (table shape, device).

    The first call for a CUDA table runs the prover once eagerly, which
    builds and uploads everything it touches (the kernel library, the
    schedule's constant image, the field constants) and so leaves nothing
    for the capture to read from the host; then it captures the prover into
    a graph on a copy of the table.  Every call copies its table into the
    graph's input and replays it.  ``captured_launches[key]`` is the number
    of ``poseidon_permute`` launches the captured run made: a replay makes
    the same launches without passing through the wrapper, so the kernel's
    launch count does not grow on replays.  A CPU table runs the eager
    prover.  Nothing catches a failed capture."""

    def __init__(self, config: PoseidonConfig):
        self.config = config
        self.graphs: dict = {}
        self.captured_launches: dict = {}

    def _capture(self, table: torch.Tensor):
        sumcheck_prove(self.config, table, device=table.device)  # the eager warm-up
        static_in = table.clone()
        graph = torch.cuda.CUDAGraph()
        before = poseidon_kernel.launches
        with torch.cuda.graph(graph):
            out = sumcheck_prove(self.config, static_in, device=static_in.device)
        self.captured_launches[(tuple(table.shape), str(table.device))] = poseidon_kernel.launches - before
        return graph, static_in, out

    def __call__(self, table: torch.Tensor):
        if table.device.type != "cuda":
            return sumcheck_prove(self.config, table, device=table.device)
        key = (tuple(table.shape), str(table.device))
        if key not in self.graphs:
            self.graphs[key] = self._capture(table)
        graph, static_in, (s_row, rounds, final_row) = self.graphs[key]
        static_in.copy_(table)
        graph.replay()
        # a later replay overwrites the graph's outputs: hand out copies
        return s_row.clone(), [(p0.clone(), p1.clone()) for p0, p1 in rounds], final_row.clone()


@functools.lru_cache(maxsize=16)
def sumcheck_prover_compiled(config: PoseidonConfig) -> CompiledProver:
    """The one-dispatch prover (the twin of the JAX package's jitted
    ``sumcheck_prover_compiled``): ``fn(table) -> (s_row, rounds,
    final_row)``, a CUDA graph of the whole m-round prover for a CUDA table
    (:class:`CompiledProver`), the eager prover for a CPU table."""
    return CompiledProver(config)


def sumcheck_prove_host(config: PoseidonConfig, table_host) -> tuple:
    """The host oracle (Python ints).  ``table_host``: (B, 2^m) ints.
    Returns ``(sums, rounds, challenges, finals)``, per-instance lists."""
    p = config.field.p
    B, n = len(table_host), len(table_host[0])
    m = n.bit_length() - 1
    if n != 1 << m:
        raise ValueError(f"the table must hold 2^m evaluations per instance, got {n}")
    sums, rounds, challenges, finals = [], [], [], []
    for b in range(B):
        sp = PoseidonSponge(config)
        T = [int(v) % p for v in table_host[b]]
        S = sum(T) % p
        sp.absorb_elements([S])
        rs, ps = [], []
        for _ in range(m):
            half = len(T) // 2
            p0 = sum(T[:half]) % p
            p1 = sum(T[half:]) % p
            sp.absorb_elements([p0, p1])
            r = sp.squeeze_native_field_elements(1)[0]
            T = [(T[j] * (1 - r) + T[half + j] * r) % p for j in range(half)]
            rs.append(r)
            ps.append((p0, p1))
        sums.append(S)
        rounds.append(ps)
        challenges.append(rs)
        finals.append(T[0])
    return sums, rounds, challenges, finals


def sumcheck_verify_host(config: PoseidonConfig, claimed_sum: int, rounds, g_r: int) -> bool:
    """The host verifier: replays the transcript, checks p_i(0) + p_i(1) ==
    p_{i-1}(r_{i-1}) (== S for i = 0), and the final value g(r)."""
    p = config.field.p
    sp = PoseidonSponge(config)
    sp.absorb_elements([claimed_sum % p])
    expect = claimed_sum % p
    last = None
    for p0, p1 in rounds:
        if (p0 + p1) % p != expect:
            return False
        sp.absorb_elements([p0 % p, p1 % p])
        r = sp.squeeze_native_field_elements(1)[0]
        expect = (p0 * (1 - r) + p1 * r) % p
        last = expect
    return last == g_r % p
