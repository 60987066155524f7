"""The Poseidon permutation kernel and its plain PyTorch version.

``permute`` is the counterpart of both TPU kernels of the JAX package that
compute this permutation: ``permute_rns`` (``ops/poseidon_rns_pallas.py``,
over RNS residues) and ``permute_pallas`` (``ops/poseidon_pallas.py``, over
16-bit digits).  On a CUDA tensor it launches ``csrc/poseidon_permute.cu``
(carry-chain Montgomery products on 32-bit words, the sparse partial rounds
of :func:`poseidon_sparse.port_schedule` and one reduction per output of each
linear layer), with one thread a state once the batch fills the card and,
below that, one group of G lanes a state (:func:`choose_group`); on a CPU
tensor it runs :func:`permute_plain`, the dense round function on the plain
field tier.
Both compute the same permutation, so they agree word for word.  There is no
fallback between the two: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from crypto_primitives_tpu_torch.native import build
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops import poseidon_sparse
from crypto_primitives_tpu_torch.utils import profiling

# The kernel's constant bank: a header of 16 words (p from word 0, n0 at
# word 15), then the schedule's rows; at most 16384 words (64 KB).
IMAGE_HEADER_WORDS = 16
IMAGE_MAX_WORDS = 16384

# Threads in a block of either kernel (kThreads in csrc/poseidon_permute.cu).
THREADS = 128

# Lanes a state the kernel is built for at t <= 3 (W = 8 and 12); every other
# (W, t) runs one thread a state.
GROUPS = (1, 4)

# The crossover table's rule (PERF.md section 6, K1), by words an element at
# t <= 3: below a wave of the one-thread kernel, (states per SM, G) pairs, the
# G measured fastest up to so many states per SM, in the order of growing
# batch.  On the H100, W = 8: G = 4 led from 1 to 8192 states (62 an SM), G = 1
# from 12288 (93 an SM); W = 12: G = 4 led through 12288 states, the largest
# batch measured below its wave.  G = 2 and 8 never led G = 4.
CROSSOVER = {8: ((72, 4),), 12: ((96, 4),)}

# Kernel launches in this process, and those of them made with G > 1; the
# benchmark's programs read the first, the card tests both.
launches = 0
group_launches = 0

_cards: dict = {}  # (device, W, t) -> (SMs, blocks of the one-thread kernel an SM)


def choose_group(batch: int, sms: int, blocks_per_sm: int, crossover) -> int:
    """Lanes a state for a launch of ``batch`` states on a card of ``sms``
    SMs, where ``blocks_per_sm`` blocks of the one-thread kernel fit an SM: 1
    once the batch fills a wave of that kernel, and below it the G of the
    first (states per SM, G) pair of ``crossover`` (a :data:`CROSSOVER` row)
    whose states per SM the batch does not pass, 1 past them all.  G never
    rises as the batch grows."""
    if batch >= sms * blocks_per_sm * THREADS:
        return 1
    for most, group in crossover:
        if batch <= most * sms:
            return group
    return 1


def _card(lib, device: int, W: int, t: int) -> tuple:
    """(SMs, blocks of the one-thread kernel an SM) for ``device``, asked once."""
    key = (device, W, t)
    if key not in _cards:
        blocks = ctypes.c_int(0)
        err = lib.poseidon_permute_blocks_per_sm(W, t, device, ctypes.addressof(blocks))
        build.check(lib, err, "poseidon_permute_blocks_per_sm")
        _cards[key] = (torch.cuda.get_device_properties(device).multi_processor_count, blocks.value)
    return _cards[key]


def permute_plain(config, state: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch permutation of ``state`` ``(B, t, W)`` int32 Montgomery
    words: ark, S-box x^alpha (every element in full rounds, the first in
    partial rounds), MDS, in the reference's round order
    (src/sponge/poseidon/mod.rs:98-121)."""
    spec = config.field
    ark, mds = config.tables(state.device)
    ark, mds = ff.to_digits(ark), ff.to_digits(mds)
    s = ff.to_digits(state)
    half = config.full_rounds // 2
    for r in range(config.full_rounds + config.partial_rounds):
        s = ff.add_digits(spec, s, ark[r])
        if r < half or r >= half + config.partial_rounds:
            s = ff.pow_const_digits(spec, s, config.alpha)
        else:
            s = torch.cat([ff.pow_const_digits(spec, s[..., :1, :], config.alpha), s[..., 1:, :]], dim=-2)
        # new[i] = sum_j mds[i][j] * s[j], one reduction per output
        s = ff.mont_dot_digits(spec, mds, s.unsqueeze(-3))
    return ff.from_digits(s)


def kernel_image(config) -> tuple:
    """(n_sparse, image): the words the kernel loads into its constant bank
    for ``config``, a host uint32 array of the header and the rows of
    :func:`poseidon_sparse.kernel_rows` (Montgomery form) for the config's
    :func:`poseidon_sparse.port_schedule`."""
    spec = config.field
    W = spec.num_words
    n_sparse, rows = poseidon_sparse.kernel_rows(config, poseidon_sparse.port_schedule(config))
    header = np.zeros(IMAGE_HEADER_WORDS, dtype=np.uint32)
    header[:W] = [(spec.p >> (32 * j)) & 0xFFFFFFFF for j in range(W)]
    header[15] = spec.n0_word
    words = spec.pack(rows).reshape(-1).view(np.uint32)
    return n_sparse, np.concatenate([header, words])


def permute(config, state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of ``state`` ``(B, t, W)`` int32 Montgomery words:
    the CUDA kernel for a CUDA tensor, :func:`permute_plain` for a CPU one.
    A (W, t) the kernel is not instantiated for makes its C entry point
    return an error, which raises here.  The lanes a state come from the
    batch and the card (:func:`choose_group`); the output is the same.
    Span ``kernel.k1`` (``rows``: the states), on both branches."""
    global launches, group_launches
    shape = state.shape  # read once, for the span and the launch
    with profiling.annotate("kernel.k1", shape[0]):
        if state.device.type == "cpu":
            return permute_plain(config, state)
        if state.device.type != "cuda":
            raise ValueError(f"poseidon_permute runs on CUDA or CPU tensors, not {state.device}")
        spec = config.field
        W, t = spec.num_words, config.t
        if state.dtype != torch.int32 or len(shape) != 3 or tuple(shape[1:]) != (t, W):
            raise ValueError(f"state must be int32 (B, {t}, {W}), got {state.dtype} {tuple(shape)}")
        if not state.is_contiguous():
            raise ValueError("state must be contiguous")
        out = torch.empty_like(state)
        if shape[0] == 0:
            return out
        n_sparse, image = config.schedule_tables(state.device)
        if image.numel() > IMAGE_MAX_WORDS:
            raise ValueError(f"the schedule's tables take {image.numel()} words, more than the kernel's "
                             f"constant bank of {IMAGE_MAX_WORDS}")
        lib = build.load("poseidon_permute")
        device = state.device.index or 0
        crossover = CROSSOVER.get(W, ()) if t <= 3 else ()
        group = choose_group(shape[0], *_card(lib, device, W, t), crossover) if crossover else 1
        err = lib.poseidon_permute(
            state.data_ptr(), out.data_ptr(), image.data_ptr(), image.numel(), shape[0], W, t,
            config.alpha, config.full_rounds, config.partial_rounds, n_sparse, group,
            device, torch.cuda.current_stream(state.device).cuda_stream,
        )
        build.check(lib, err, "poseidon_permute")
        launches += 1
        group_launches += group > 1
        return out
