"""The port's sparse partial-round schedule and the kernel's view of it.

The Poseidon kernel (csrc/poseidon_permute.cu) runs the schedule of
crypto_primitives_tpu_torch/ops/poseidon_sparse.py out of a constant-bank
image, with one reduction per output of each linear layer.  The kernel runs
only on the card; these tests hold on the CPU what it reads and assumes: the
schedule equals the JAX package's, the schedule's permutation equals the
plain one and JAX's, the image has the layout the kernel indexes (a Python
walk of the image with the kernel's offsets gives the permutation), and the
reduction bounds the kernel's conditional subtractions rely on hold in
Python ints for every field it is instantiated for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_primitives_tpu.models import sponge as jsponge
from crypto_primitives_tpu.models.sponge import poseidon as jposeidon
from crypto_primitives_tpu.ops import fields_known as jfk
from crypto_primitives_tpu.ops import poseidon_sparse as jsparse
from crypto_primitives_tpu_torch import interop
from crypto_primitives_tpu_torch.models import sponge as tsponge
from crypto_primitives_tpu_torch.ops import fields_known as tfk
from crypto_primitives_tpu_torch.ops import poseidon_kernel
from crypto_primitives_tpu_torch.ops import poseidon_sparse as tsparse
from crypto_primitives_tpu_torch.ops.curves_known import SW_CURVES, TE_CURVES

torch.set_num_threads(1)

# (name, rate, optimized_for_weights) of the BLS12-381 Fr tables, and "fq":
# the rate-2, alpha-5, 8 + 60 round shape over BLS12-381 Fq (W = 12)
CONFIGS = [("fr", 2, False), ("fr", 4, False), ("fr", 8, True), ("fq", 2, False)]


def _configs(name, rate, weights):
    if name == "fr":
        jcfg = jsponge.get_default_poseidon_parameters(jfk.BLS12_381_FR, rate, weights)
    else:
        ark, mds = jsponge.find_poseidon_ark_and_mds(jfk.BLS12_381_FQ, rate, 8, 60, 0)
        jcfg = jsponge.PoseidonConfig(jfk.BLS12_381_FQ, 8, 60, 5, ark, mds, rate, 1)
    tcfg = interop.poseidon_config(jcfg.field.p, jcfg.ark, jcfg.mds, jcfg.full_rounds,
                                   jcfg.partial_rounds, jcfg.alpha, jcfg.rate, jcfg.capacity)
    return jcfg, tcfg


def _states(p, t, n, seed):
    rng = np.random.default_rng(seed)
    nbytes = (p.bit_length() + 7) // 8 + 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n * t)]
    vals[:t] = [p - 1] * t
    return [vals[i * t:(i + 1) * t] for i in range(n)]


def _host_permute(cfg, state):
    sponge = tsponge.PoseidonSponge(cfg)
    sponge.state = list(state)
    sponge.permute()
    return sponge.state


def _sched_fields(s):
    return (s.p, s.t, s.rf2, s.R_P, s.is_sparse, s.pre_full, s.dense_mats, s.sp_m00, s.sp_v,
            s.sp_w, s.folds)


@pytest.mark.parametrize("max_run", ["port", 3])
@pytest.mark.parametrize("name,rate,weights", CONFIGS)
def test_schedule_ints_match_jax(name, rate, weights, max_run):
    """The port's copy builds the JAX package's schedule, int for int, at the
    port's one-run length and at a short cap like the RNS kernel's."""
    jcfg, tcfg = _configs(name, rate, weights)
    L = tcfg.partial_rounds - 1 if max_run == "port" else max_run
    assert _sched_fields(tsparse.build_sparse_schedule(tcfg, L)) == \
        _sched_fields(jsparse.build_sparse_schedule(jcfg, L))
    if max_run == "port":
        sched = tsparse.port_schedule(tcfg)
        assert sched.is_sparse == [True] * (tcfg.partial_rounds - 1) + [False]
        assert _sched_fields(sched) == _sched_fields(jsparse.build_sparse_schedule(jcfg, L))


@pytest.mark.parametrize("name,rate,weights", CONFIGS)
def test_permute_with_schedule_matches_plain_and_jax(name, rate, weights):
    jcfg, tcfg = _configs(name, rate, weights)
    spec = tcfg.field
    states = _states(spec.p, tcfg.t, 4, seed=31)
    sched = tsparse.port_schedule(tcfg)
    got = [tsparse.permute_with_schedule(tcfg, sched, s) for s in states]
    plain = poseidon_kernel.permute_plain(tcfg, torch.from_numpy(spec.pack(states)))
    assert [[int(v) for v in row] for row in spec.unpack(plain)] == got
    jspec = jcfg.field
    want = np.asarray(jposeidon.permute(jspec, jcfg.packed(), jnp.asarray(jspec.pack(states))))
    assert [[int(v) for v in row] for row in jspec.unpack(want)] == got


def _singular_config():
    """t = 3 with an MDS whose lower-right 2 x 2 block is singular, so the
    factorization meets a singular Mhat."""
    spec = tfk.BLS12_381_FR
    base = tsponge.get_default_poseidon_parameters(spec, 2, False)
    mds = [[2, 3, 5], [7, 1, 1], [11, 1, 1]]
    return tsponge.PoseidonConfig(spec, base.full_rounds, base.partial_rounds, base.alpha,
                                  base.ark, mds, 2, 1)


def test_singular_mhat_takes_the_trivial_schedule():
    cfg = _singular_config()
    with pytest.raises(ZeroDivisionError):
        tsparse.build_sparse_schedule(cfg, cfg.partial_rounds - 1)
    sched = tsparse.port_schedule(cfg)
    assert _sched_fields(sched) == _sched_fields(tsparse.trivial_schedule(cfg))
    assert not any(sched.is_sparse)
    assert sched.folds[:-1] == [[int(x) for x in row] for row in cfg.ark[1:]]
    n_sparse, _ = tsparse.kernel_rows(cfg, sched)
    assert n_sparse == 0
    for s in _states(cfg.field.p, 3, 3, seed=32):
        assert tsparse.permute_with_schedule(cfg, sched, s) == _host_permute(cfg, s)


def _walk_image(cfg, n_sparse, image, state):
    """The permutation as the kernel computes it from its constant-bank image:
    the same offsets and round logic as permute_kernel, in Python ints."""
    spec = cfg.field
    W, p, t = spec.num_words, spec.p, cfg.t
    assert int(image[15]) == spec.n0_word
    assert sum(int(image[j]) << (32 * j) for j in range(W)) == p
    body = image[poseidon_kernel.IMAGE_HEADER_WORDS:].astype(np.int64) & 0xFFFFFFFF

    def elem(e):
        return spec.from_mont(sum(int(body[e * W + j]) << (32 * j) for j in range(W)))

    o_mds, rf2, R_P = t, cfg.full_rounds // 2, cfg.partial_rounds
    o_pre = o_mds + t * t
    o_sp = o_pre + t * t
    o_fs = o_sp + n_sparse * (2 * t - 1)
    o_fv = o_fs + n_sparse
    s = [(x + elem(k)) % p for k, x in enumerate(state)]
    for r in range(cfg.full_rounds + R_P):
        full = r < rf2 or r >= rf2 + R_P
        s = [pow(x, cfg.alpha, p) if (full or k == 0) else x for k, x in enumerate(s)]
        scalar = rf2 - 1 <= r < rf2 - 1 + n_sparse
        if scalar:
            fold = [elem(o_fs + r - (rf2 - 1))] + [0] * (t - 1)
        else:
            fold = [elem(o_fv + (r if r < rf2 - 1 else r - n_sparse) * t + k) for k in range(t)]
        i = r - rf2
        if not full and i < n_sparse:
            c = [elem(o_sp + i * (2 * t - 1) + k) for k in range(2 * t - 1)]
            o = [sum(c[k] * s[k] for k in range(t))] + [s[k] + c[t - 1 + k] * s[0] for k in range(1, t)]
        else:
            mat = o_pre if r == rf2 - 1 else o_mds
            o = [sum(elem(mat + j * t + k) * s[k] for k in range(t)) for j in range(t)]
        s = [(x + f) % p for x, f in zip(o, fold)]
    return s


@pytest.mark.parametrize("name,rate,weights", CONFIGS + [("singular", 2, False)])
def test_kernel_image_layout(name, rate, weights):
    """The image has the size the C entry point checks, and walking it with
    the kernel's offsets gives the reference permutation."""
    cfg = _singular_config() if name == "singular" else _configs(name, rate, weights)[1]
    n_sparse, image = poseidon_kernel.kernel_image(cfg)
    W, t, R_T = cfg.field.num_words, cfg.t, cfg.full_rounds + cfg.partial_rounds
    rows = t + 2 * t * t + n_sparse * (2 * t - 1) + n_sparse + (R_T - n_sparse) * t
    assert image.dtype == np.uint32
    assert image.shape == (poseidon_kernel.IMAGE_HEADER_WORDS + W * rows,)
    assert image.shape[0] <= poseidon_kernel.IMAGE_MAX_WORDS
    assert n_sparse == (0 if name == "singular" else cfg.partial_rounds - 1)
    dev_n, dev_image = cfg.schedule_tables("cpu")
    assert dev_n == n_sparse and np.array_equal(dev_image.numpy().view(np.uint32), image)
    for s in _states(cfg.field.p, t, 2, seed=33):
        assert _walk_image(cfg, n_sparse, image, s) == _host_permute(cfg, s)


def _k_subs(T, A):
    # field.cuh's kSubs<T, A>
    return (T + 2 * A + 1) // 2


# (W, TMAX) of each kernel instantiation, with the (products, addends) of
# each reduction it makes: a dense row or sparse row 0 (TMAX, 1), a sparse
# row k >= 1 (1, 2), a plain product (1, 0); and the fields of that width
WIDTHS = {8: [(3, 3), (9, 9)], 12: [(3, 3)]}


@pytest.mark.parametrize("W", [8, 12])
def test_lazy_reduction_bounds_hold(W):
    """Every reduction's input fits the 2N words and top word the kernel
    gives it, and kSubs conditional subtractions take its output below p:
    for every field of that width, and for the largest modulus with a spare
    top bit."""
    R = 1 << (32 * W)
    fields = tfk.ALL_FIELDS + [tfk.BLS12_381_FQ] + [c.base for c in TE_CURVES + SW_CURVES]
    primes = [f.p for f in fields if f.num_limbs == 2 * W and f.p < R // 2] + [R // 2 - 1]
    assert len(primes) > 1
    for p in primes:
        for _, tmax in WIDTHS[W]:
            for T, A in ((tmax, 1), (1, 2), (1, 0)):
                x = T * (p - 1) ** 2 + A * (p - 1) * R  # the largest input
                assert x + (R - 1) * p < 1 << (32 * (2 * W + 1))
                out = (x + (R - 1) * p) // R  # the largest output before subtracting
                assert out < (_k_subs(T, A) + 1) * p, (p, T, A)
