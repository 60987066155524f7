"""What stands in the program's place to show that a run can come out not
correct: the control (the plain reference with one stated guarantee broken,
every leaf hashed) and the planted faults of the timed path.

A fault is a context manager that patches the program's kernel wrappers
(``ops.poseidon_kernel.permute``, ``ops.sha256_kernel.digest``), which every
hash of the tree layer goes through:

* ``state_unchanged``: a step returns its state unchanged (the permutation
  gives back its input; the compression keeps its initial state);
* ``half_batch``: the second half of every batch is left out (its rows zero);
* ``answer_altered``: every word of the first row of each call's output has
  its lowest bit flipped where it is produced.

The exchange between chips is not a fault these cells can have: every cell
runs on one chip.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import merkle_ref


class ReferenceProgram:
    """The control: the configuration's plain reference, with its
    ``control`` switch on, behind the program's interface."""

    def __init__(self, cfgmod, cfg, device):
        self.ref = cfgmod.Reference(cfg, device, control=True)

    def build(self, raw):
        return merkle_ref.build(self.ref.scheme, self.ref.inputs(raw))

    def root(self, levels):
        return self.ref.value_row(self.ref.root_value(levels))

    def leaf_hash(self, levels, raw):
        return self.ref.scheme.leaf_hash(self.ref.inputs(raw))

    def proof_rows(self, levels, idx):
        return None, None  # the verify walk takes the siblings from its own levels

    def verify(self, levels, digests, idx, sib, auth):
        return merkle_ref.verify_digests(self.ref.scheme, levels, digests, torch.as_tensor(idx).cpu().numpy())

    def to_host(self, x):
        return np.asarray(x)

    def launches(self) -> dict:
        return {}


def _state_unchanged(name, orig):
    if name == "permute":
        return lambda config, state: state.clone()

    def digest(msgs):
        from crypto_primitives_tpu_torch.ops.sha256_kernel import H0

        h0 = np.array(H0, dtype=">u4").view(np.uint8)
        return torch.from_numpy(h0.copy()).to(msgs.device).expand(msgs.shape[0], 32).clone()

    return digest


def _half_batch(name, orig):
    def half(*args):
        x = args[-1]
        keep = max(x.shape[0] // 2, 1)
        out = orig(*args[:-1], x[:keep].contiguous())
        return torch.cat([out, out.new_zeros((x.shape[0] - keep,) + tuple(out.shape[1:]))])

    return half


def _answer_altered(name, orig):
    def altered(*args):
        out = orig(*args).clone()
        out[0] ^= 1
        return out

    return altered


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered}


@contextlib.contextmanager
def planted(fault: str):
    from crypto_primitives_tpu_torch.ops import poseidon_kernel, sha256_kernel

    make = FAULTS[fault]
    saved = (poseidon_kernel.permute, sha256_kernel.digest)
    poseidon_kernel.permute = make("permute", saved[0])
    sha256_kernel.digest = make("digest", saved[1])
    try:
        yield
    finally:
        poseidon_kernel.permute, sha256_kernel.digest = saved
