"""The lane-group Poseidon kernel's arithmetic and the choice of its group, on
the CPU.

``csrc/poseidon_permute.cu``'s ``permute_kernel_group`` spreads each state
over G lanes of a warp, K = W / G words a lane, and runs every product as a
Montgomery reduction by digits of K words with a carry-lookahead across the
lanes.  The kernel runs only on the card; here a model of it in Python ints
keeps its structure lane by lane (each lane's words as one integer, the
quotient digit word by word from n0, the shift down one lane, the owed carries
paid up, the lookaheads of the conditional subtractions) and is held against
field arithmetic, and its round function, walked over the kernel's image with
the kernel's offsets and subtraction counts, against ``permute_plain``.  The
choice of G (``poseidon_kernel.choose_group``) is a pure function of the
batch and the card, tested as such.
"""

import itertools
import random

import numpy as np
import pytest
import torch

from crypto_primitives_tpu_torch.models.sponge import (
    PoseidonConfig,
    find_poseidon_ark_and_mds,
    get_default_poseidon_parameters,
)
from crypto_primitives_tpu_torch.ops import poseidon_kernel
from crypto_primitives_tpu_torch.ops.fields_known import BLS12_381_FQ, BLS12_381_FR, JUBJUB_FR

M32 = (1 << 32) - 1


class LaneGroup:
    """One group of G lanes over an N-word field, as the kernel runs it."""

    def __init__(self, p: int, N: int, G: int):
        self.p, self.N, self.G, self.K = p, N, G, N // G
        self.B = 1 << (32 * self.K)  # one lane's words
        self.n0 = -pow(p, -1, 1 << 32) % (1 << 32)
        self.pk = self.lanes(p)

    def lanes(self, v: int) -> list:
        return [(v >> (32 * self.K * lane)) % self.B for lane in range(self.G)]

    def value(self, x: list, top: int = 0) -> int:
        return sum(w << (32 * self.K * lane) for lane, w in enumerate(x)) + (top << (32 * self.N))

    def carries(self, gen: list, prop: list) -> int:
        """group_carries: bit i the carry into lane i, bit G out of the group."""
        g = sum(1 << lane for lane in range(self.G) if gen[lane])
        a = g | sum(1 << lane for lane in range(self.G) if prop[lane])
        return (a + g) ^ a ^ g

    def settle(self, x: list, c: list) -> tuple:
        """group_settle: every lane's owed carry paid into the lane above."""
        G, B = self.G, self.B
        ins = [0] + c[:-1]
        y, gen, prop = [], [], []
        for lane in range(G):
            v = x[lane] + ins[lane]
            gen.append(v >= B)
            y.append(v % B)
            prop.append(y[-1] == B - 1)
        cv = self.carries(gen, prop)
        top = 0
        for lane in range(G):
            v = y[lane] + ((cv >> lane) & 1)
            y[lane] = v % B
            if lane == G - 1:
                top = c[lane] + gen[lane] + (v >> (32 * self.K))
        assert top <= M32
        return y, top

    def sub_if_geq(self, x: list, top: int) -> tuple:
        """group_sub_if_geq: (x, top) -= p where (x, top) >= p."""
        G, B, wide = self.G, self.B, 1 << (32 * (self.K + 1))
        d, gen, prop = [], [], []
        for lane in range(G):
            own = top if lane == G - 1 else 0
            v = x[lane] + own * B - self.pk[lane]  # K words and the word above
            gen.append(v < 0)
            d.append(v % wide)
            prop.append(d[-1] == 0)
        borrows = self.carries(gen, prop)
        if (borrows >> G) & 1:
            return x, top
        out = []
        for lane in range(G):
            v = (d[lane] - ((borrows >> lane) & 1)) % wide
            out.append(v % B)
            if lane == G - 1:
                top = v // B
        return out, top

    def quotient(self, low: int) -> int:
        """quotient_digit: the K words q with low + q p = 0 mod 2^(32 K),
        word by word, each word's product added in one 64-bit row."""
        K, pw = self.K, [(self.p >> (32 * j)) & M32 for j in range(self.K)]
        y, q = [(low >> (32 * j)) & M32 for j in range(K)], []
        for j in range(K):
            q.append(y[j] * self.n0 & M32)
            t = 0
            for m in range(j, K):
                t = q[j] * pw[m - j] + y[m] + (t >> 32)
                assert t < 1 << 64
                y[m] = t & M32
        assert y == [0] * K
        return sum(w << (32 * j) for j, w in enumerate(q))

    def mont(self, terms: list, addends: list, subs: int) -> int:
        """group_mont: sum a b R^-1 + sum addends, fully reduced by subs
        conditional subtractions; terms are (a, b) with a spread over the
        lanes and b the same in every lane.  Each step a lane takes the
        lane above's low K words as they were before the quotient product
        (the step's one shuffle) and adds that lane's share of q p itself."""
        G, K, B = self.G, self.K, self.B
        pu = self.pk[1:] + [0]  # the lane above's words of p
        x, c = [0] * G, [0] * G
        spread = [self.lanes(a) for a, _ in terms]
        for i in range(G):
            acc = []
            for lane in range(G):
                s = x[lane] + (c[lane] << (32 * K))
                for (_, b), a in zip(terms, spread):
                    s += a[lane] * ((b >> (32 * K * i)) % B)
                acc.append(s)
            up = [acc[lane + 1] % B if lane < G - 1 else 0 for lane in range(G)]
            q = self.quotient(acc[0] % B)
            acc = [s + q * pk for s, pk in zip(acc, self.pk)]
            assert acc[0] % B == 0 and all(s < 1 << (32 * (2 * K + 1)) for s in acc)
            for lane in range(G):
                lo = (up[lane] + q * pu[lane]) % B if lane < G - 1 else 0
                assert lo == (acc[lane + 1] % B if lane < G - 1 else 0)
                hi = acc[lane] >> (32 * K)
                v = hi % B + lo
                x[lane], c[lane] = v % B, (hi >> (32 * K)) + (v >> (32 * K))
        for y in addends:
            for lane, w in enumerate(self.lanes(y)):
                v = x[lane] + w
                x[lane], c[lane] = v % B, c[lane] + (v >> (32 * K))
        x, top = self.settle(x, c)
        assert self.value(x, top) < (subs + 1) * self.p  # the bound the subtractions rely on
        for _ in range(subs):
            x, top = self.sub_if_geq(x, top)
        assert top == 0
        return self.value(x)

    def add(self, a: int, b: int) -> int:
        """The kernel's s + ark[0]: lane words added, settled, one subtraction."""
        x, c = [], []
        for u, v in zip(self.lanes(a), self.lanes(b)):
            x.append((u + v) % self.B)
            c.append((u + v) // self.B)
        x, top = self.settle(x, c)
        x, top = self.sub_if_geq(x, top)
        assert top == 0
        return self.value(x)


GROUP = max(poseidon_kernel.GROUPS)  # the lanes a state the group kernel is built for
SHAPES = [(8, GROUP), (12, GROUP)]


def _field(N):
    return BLS12_381_FR if N == 8 else BLS12_381_FQ


def test_lookahead_equals_a_ripple():
    """group_carries against a lane-by-lane ripple on every pattern."""
    G = GROUP
    g = LaneGroup(BLS12_381_FR.p, 8, G)
    for pattern in itertools.product(range(3), repeat=G):
        gen, prop = [s == 1 for s in pattern], [s == 2 for s in pattern]
        carry, want = 0, 0
        for lane in range(G):
            want |= carry << lane
            carry = 1 if gen[lane] else carry if prop[lane] else 0
        want |= carry << G
        assert g.carries(gen, prop) == want


@pytest.mark.parametrize("N, G", SHAPES)
def test_settle_and_subtract_carry_across_lanes(N, G):
    """Owed carries and borrows that run through every lane of all ones."""
    g = LaneGroup(_field(N).p, N, G)
    ones = [g.B - 1] * G
    x, top = g.settle(ones, [1] + [0] * (G - 1))
    assert g.value(x, top) == g.value(ones) + g.B and top == 1
    c = [3] * G
    x, top = g.settle(list(ones), c)
    assert g.value(x, top) == g.value(ones) + sum(3 * g.B << (32 * g.K * lane) for lane in range(G))
    # p plus small amounts in the lowest lane, and exactly p
    for extra in (0, 1, g.B - g.pk[0] - 1):
        v = g.p + extra
        x, top = g.sub_if_geq(g.lanes(v % (1 << (32 * N))), v >> (32 * N))
        assert g.value(x, top) == extra
    x, top = g.sub_if_geq(g.lanes(g.p - 1), 0)
    assert g.value(x, top) == g.p - 1


@pytest.mark.parametrize("N, G", SHAPES)
def test_group_product_equals_field_arithmetic(N, G):
    """Sums of T products and A addends, reduced by the kernel's kSubs, equal
    sum a b R^-1 + sum x mod p, on random operands and the largest ones."""
    spec = _field(N)
    p, R = spec.p, 1 << (32 * N)
    g = LaneGroup(p, N, G)
    rng = random.Random(N * 10 + G)
    r_inv = pow(R, -1, p)
    for T, A in [(1, 0), (3, 1), (1, 2), (2, 1)]:
        subs = (T + 2 * A + 1) // 2
        cases = [[p - 1] * (2 * T + A), [0] * (2 * T) + [p - 1] * A]
        cases += [[rng.randrange(p) for _ in range(2 * T + A)] for _ in range(40)]
        for vals in cases:
            terms = list(zip(vals[:T], vals[T:2 * T]))
            want = (sum(a * b for a, b in terms) * r_inv + sum(vals[2 * T:])) % p
            assert g.mont(terms, vals[2 * T:], subs) == want
    for a, b in [(p - 1, p - 1), (0, p - 1), (rng.randrange(p), rng.randrange(p))]:
        assert g.add(a, b) == (a + b) % p


def _image_elems(cfg):
    n_sparse, image = poseidon_kernel.kernel_image(cfg)
    W = cfg.field.num_words
    body = image[poseidon_kernel.IMAGE_HEADER_WORDS:].astype(np.int64) & M32
    rows = body.reshape(-1, W)
    return n_sparse, [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in rows]


def _group_permute(cfg, g: LaneGroup, state: list) -> list:
    """permute_kernel_group's round function on one state of Montgomery ints,
    with the kernel's offsets into its image and its subtraction counts
    (kSubs<TMAX, 1> and kSubs<1, 2> at TMAX = 3)."""
    n_sparse, el = _image_elems(cfg)
    t, alpha = cfg.t, cfg.alpha
    o_mds, rf2 = t, cfg.full_rounds // 2
    o_pre = o_mds + t * t
    o_sp = o_pre + t * t
    o_fs = o_sp + n_sparse * (2 * t - 1)
    o_fv = o_fs + n_sparse
    first, other = (3 + 2 + 1) // 2, (1 + 4 + 1) // 2
    s = [g.add(x, el[k]) for k, x in enumerate(state)]
    for r in range(cfg.full_rounds + cfg.partial_rounds):
        full = r < rf2 or r >= rf2 + cfg.partial_rounds
        for k in range(t if full else 1):
            base = s[k]
            for bit in range(alpha.bit_length() - 2, -1, -1):
                s[k] = g.mont([(s[k], s[k])], [], 1)
                if (alpha >> bit) & 1:
                    s[k] = g.mont([(base, s[k])], [], 1)
        scalar = rf2 - 1 <= r < rf2 - 1 + n_sparse
        fold = o_fs + r - (rf2 - 1) if scalar else o_fv + (r if r < rf2 - 1 else r - n_sparse) * t
        i = r - rf2
        if not full and i < n_sparse:
            c = o_sp + i * (2 * t - 1)
            o = [g.mont([(s[k], el[c + k]) for k in range(t)], [el[fold]], first)]
            o += [g.mont([(s[0], el[c + t - 1 + k])], [s[k]] + ([] if scalar else [el[fold + k]]), other)
                  for k in range(1, t)]
        else:
            mat = o_pre if r == rf2 - 1 else o_mds
            o = [g.mont([(s[k], el[mat + j * t + k]) for k in range(t)],
                        [el[fold if scalar else fold + j]] if not scalar or j == 0 else [], first)
                 for j in range(t)]
        s = o
    return s


def _singular():
    base = get_default_poseidon_parameters(BLS12_381_FR, 2)
    return PoseidonConfig(BLS12_381_FR, 8, 31, 17, base.ark, [[2, 3, 5], [7, 1, 1], [11, 1, 1]], 2, 1)


def _config(spec, rate, full, partial, alpha):
    ark, mds = find_poseidon_ark_and_mds(spec, rate, full, partial, 0)
    return PoseidonConfig(spec, full, partial, alpha, ark, mds, rate, 1)


@pytest.mark.parametrize("which", ["fr_rate2", "jubjub_rate2", "fr_rate1", "singular", "fq_rate2"])
def test_group_round_function_equals_plain(which):
    cfg = {
        "fr_rate2": lambda: get_default_poseidon_parameters(BLS12_381_FR, 2),
        "jubjub_rate2": lambda: _config(JUBJUB_FR, 2, 8, 31, 17),
        "fr_rate1": lambda: _config(BLS12_381_FR, 1, 8, 31, 17),
        "singular": _singular,
        "fq_rate2": lambda: _config(BLS12_381_FQ, 2, 8, 60, 5),
    }[which]()
    spec, t = cfg.field, cfg.t
    rng = random.Random(7)
    states = [[spec.p - 1] * t, [rng.randrange(spec.p) for _ in range(t)]]
    words = torch.from_numpy(spec.pack(np.asarray(states, dtype=object)))
    want = poseidon_kernel.permute_plain(cfg, words).numpy()
    W = spec.num_words
    g = LaneGroup(spec.p, W, GROUP)
    for row, state in enumerate(states):
        mont = [sum(int(w & M32) << (32 * j) for j, w in enumerate(words[row, k].tolist())) for k in range(t)]
        got = _group_permute(cfg, g, mont)
        assert got == [sum(int(w) << (32 * j) for j, w in enumerate(want[row, k].astype(np.int64) & M32))
                       for k in range(t)]
        assert all(x < spec.p for x in got)


H100_SMS, H100_BLOCKS = 132, 6  # the one-thread kernel at 80 registers: 6 blocks of 128 an SM


def test_choice_of_group_at_the_paths_shapes():
    choose = poseidon_kernel.choose_group
    for W, row in poseidon_kernel.CROSSOVER.items():
        assert choose(4096, H100_SMS, H100_BLOCKS, row) > 1  # a paths level: under one wave
        assert choose(1 << 19, H100_SMS, H100_BLOCKS, row) == 1  # a wide commit level
        assert choose(H100_SMS * H100_BLOCKS * 128, H100_SMS, H100_BLOCKS, row) == 1  # exactly a wave
        assert choose(1, H100_SMS, H100_BLOCKS, row) == row[0][1]
    assert choose(5, H100_SMS, H100_BLOCKS, ()) == 1  # a (W, t) built with one thread a state


@pytest.mark.parametrize("sms, blocks", [(132, 6), (132, 1), (114, 6), (1, 4), (16, 8)])
@pytest.mark.parametrize("W", sorted(poseidon_kernel.CROSSOVER))
def test_group_never_rises_with_the_batch(sms, blocks, W):
    row = poseidon_kernel.CROSSOVER[W]
    wave = sms * blocks * poseidon_kernel.THREADS
    batches = sorted({1, 2, 3, 31, 300, 4096, 4097, 8191, wave - 1, wave, wave + 1, 1 << 17, 1 << 20}
                     | set(range(1, 4 * wave, max(1, wave // 97))))
    chosen = [poseidon_kernel.choose_group(b, sms, blocks, row) for b in batches]
    assert all(g in poseidon_kernel.GROUPS for g in chosen)
    assert all(a >= b for a, b in zip(chosen, chosen[1:]))
    assert all(g == 1 for b, g in zip(batches, chosen) if b >= wave)


def test_wrapper_counts_no_group_launch_on_the_cpu():
    """The CPU branch runs permute_plain: no launch of either kernel."""
    cfg = get_default_poseidon_parameters(BLS12_381_FR, 2)
    before = (poseidon_kernel.launches, poseidon_kernel.group_launches)
    states = torch.from_numpy(BLS12_381_FR.pack(np.asarray([[1, 2, 3]], dtype=object)))
    poseidon_kernel.permute(cfg, states)
    assert (poseidon_kernel.launches, poseidon_kernel.group_launches) == before
    with pytest.raises(ValueError):
        poseidon_kernel.permute(cfg, torch.empty((4, 3, 8), dtype=torch.int32, device="meta"))
