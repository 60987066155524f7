"""The Poseidon permutation kernel and its plain PyTorch version.

``permute`` is the counterpart of both TPU kernels of the JAX package that
compute this permutation: ``permute_rns`` (``ops/poseidon_rns_pallas.py``,
over RNS residues) and ``permute_pallas`` (``ops/poseidon_pallas.py``, over
16-bit digits).  On a CUDA tensor it launches ``csrc/poseidon_permute.cu``
(one thread per state, carry-chain Montgomery products on 32-bit words, the
sparse partial rounds of :func:`poseidon_sparse.port_schedule` and one
reduction per output of each linear layer); on a CPU tensor it runs
:func:`permute_plain`, the dense round function on the plain field tier.
Both compute the same permutation, so they agree word for word.  There is no
fallback between the two: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

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

# Kernel launches in this process; chip_smoke.py resets and reads it.
launches = 0


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
    return an error, which raises here.
    Span ``kernel.k1`` (``rows``: the states), on both branches."""
    global launches
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
        err = lib.poseidon_permute(
            state.data_ptr(), out.data_ptr(), image.data_ptr(), image.numel(), shape[0], W, t,
            config.alpha, config.full_rounds, config.partial_rounds, n_sparse,
            state.device.index or 0, torch.cuda.current_stream(state.device).cuda_stream,
        )
        build.check(lib, err, "poseidon_permute")
        launches += 1
        return out
