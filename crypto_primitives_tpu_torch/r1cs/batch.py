"""Vectorized R1CS synthesis: N circuit instances as one trace, checked on the card.

Twin of ``crypto_primitives_tpu/r1cs/batch.py``.  The scalar tier
(``r1cs/cs.py``) computes witnesses with per-instance Python ints; here the
same gadget code (every value step goes through the ConstraintSystem ``v_*``
hooks) runs once, recording the constraint structure a single time while
every witness value holds all N instances.  Constraint counts are the
scalar tier's by construction, and satisfaction is checked for all
instances at once on ``device`` (``None`` means CUDA).

Two value planes:
  * field circuits (FpVar / Boolean: the Poseidon sponge and CRH gadgets,
    select, is_eq): values are ``(N, W)`` int32 Montgomery words on the
    device, computed by the port's plain field tier (``ops/field.py``), on
    the card each product, sum and linear layer replayed from a CUDA graph
    per input shape (:class:`_Replay`);
  * byte circuits (UInt8 / UInt32: the SHA-256 and Blake2s gadgets): bits
    and words stay host numpy (:class:`SmallWord`), as in the JAX package,
    so the dense bitwise traffic of a hash circuit costs no device call.

Checks:
  * the small-domain check (``_small_check_data``): where every value,
    coefficient and row sum is small, a * b == c holds mod p iff it holds
    over the integers, so the check is an int64 gather, product and
    ``index_add_`` over the COO triples on the device.  Byte circuits
    always qualify; it also names each instance's first failing constraint
    (``which_unsatisfied``);
  * otherwise the Montgomery check of ``device_check``, over chunks of
    instances sized from :data:`CHUNK_BYTES` (JAX's semantics: a field
    circuit is checked in the field, not a fallback between devices).
"""

from __future__ import annotations

import numpy as np
import torch

from crypto_primitives_tpu_torch.device import resolve_device
from crypto_primitives_tpu_torch.ops import field as ff
from crypto_primitives_tpu_torch.ops.field import WORD_MASK, FieldSpec
from crypto_primitives_tpu_torch.r1cs.cs import ConstraintSystem
from crypto_primitives_tpu_torch.r1cs.device_check import _pack_matrix, rows_eval

# Device memory the checks may fill at once with their largest intermediate:
# the plain tier's int64 digit products of a Montgomery product ((2W)^2 of
# them per element, 2 KiB at W = 8) or the int64 products of the small check.
CHUNK_BYTES = 1 << 30

_SMALL_LIMIT = 1 << 62  # int64-safe magnitude ceiling


def _mont_dot_rows(spec: FieldSpec, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(R, N, W) Montgomery words of sum_k m[r, k] x[n, k] for words x
    (N, K, W) and m (R, K, W): one reduction a row."""
    return ff.from_digits(ff.mont_dot_digits(spec, ff.to_digits(m).unsqueeze(1), ff.to_digits(x)))


class _Replay:
    """``fn(spec, *args)`` captured as one CUDA graph on copies of ``args``,
    after an eager warm-up that uploads the field constants.  A call copies
    its inputs in, replays, and hands out a copy of the output (a later
    replay overwrites it).  A plain field op is a couple of hundred small
    launches; a replay is one, beside the copies."""

    def __init__(self, fn, spec: FieldSpec, args):
        fn(spec, *args)
        self.inputs = [a.clone() for a in args]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(spec, *self.inputs)

    def __call__(self, args):
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        return self.out.clone()


class SmallWord:
    """Standard-domain small field value: an (N,) int64 numpy array of
    centered residues mod p with a tracked magnitude bound.

    The byte-circuit tier keeps every bit and word value in this host
    representation, so a hash circuit synthesises as numpy with no device
    call; the checks move all SmallWord rows to the device at once."""

    __slots__ = ("v", "bound")

    def __init__(self, v: np.ndarray, bound: int):
        self.v = v
        self.bound = bound


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer))


def _is_bool(v) -> bool:
    return isinstance(v, (bool, np.bool_))


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _mont_bytes(spec: FieldSpec) -> int:
    """Bytes of int64 intermediates of one plain Montgomery product."""
    L = spec.num_digits
    return 8 * (L * L + 4 * L)


class BatchConstraintSystem(ConstraintSystem):
    """ConstraintSystem whose assignment values are ``(N, W)`` Montgomery
    word tensors on ``device`` or SmallWord rows (constants stay Python
    ints: they are instance-independent)."""

    def __init__(self, field: FieldSpec, batch: int, device=None):
        self.device = resolve_device(device)
        super().__init__(field)
        self.batch = batch
        self._const_cache: dict = {}
        self._rows_cache: dict = {}
        self._replays: dict = {}  # (fn, input shapes) -> _Replay
        self._small_coo = None  # centered COO triples, per constraint count
        self._small_coo_n = -1
        self._device_coo: dict = {}  # (kind, constraint count) -> tensors on the device

    # -- helpers --

    def _packed_const(self, c: int) -> torch.Tensor:
        c %= self.field.p
        hit = self._const_cache.get(c)
        if hit is None:
            hit = torch.from_numpy(self.field.pack([c])[0]).to(self.device)  # (W,) Montgomery
            self._const_cache[c] = hit
        return hit

    def _packed_rows(self, rows) -> torch.Tensor:
        """Montgomery words on the device of a constant vector or matrix,
        cached: a sponge's MDS matrix and round constants recur in every
        permutation."""
        key = tuple(tuple(r) if isinstance(r, (list, tuple)) else r for r in rows)
        hit = self._rows_cache.get(key)
        if hit is None:
            hit = torch.from_numpy(self.field.pack(rows)).to(self.device)
            self._rows_cache[key] = hit
        return hit

    def _op(self, fn, *args) -> torch.Tensor:
        """``fn(field, *args)`` on word tensors: on the card replayed from
        one CUDA graph per (fn, input shapes), eager elsewhere."""
        if self.device.type != "cuda":
            return fn(self.field, *args)
        key = (fn, *(tuple(a.shape) for a in args))
        replay = self._replays.get(key)
        if replay is None:
            replay = self._replays[key] = _Replay(fn, self.field, args)
        return replay(args)

    def _centered(self, c: int):
        """Centered representative of c mod p (small iff c or p-c is)."""
        c %= self.field.p
        return c - self.field.p if c > self.field.p // 2 else c

    @staticmethod
    def _small(v: np.ndarray) -> "SmallWord":
        """SmallWord with its bound taken from the actual magnitudes.
        Symbolic bound products compound (a 256-term conjunction of
        bound-2 booleans would claim 2^256 and force the Montgomery path)
        while the values stay 0/1; pre-op guards still use the operand
        bounds, so int64 never overflows mid-op."""
        return SmallWord(v, int(np.abs(v).max(initial=0)))

    def _small_to_mont(self, vals: np.ndarray) -> torch.Tensor:
        """(..., N) int64 centered values -> (..., N, W) Montgomery words on
        the device: |v| < 2^62 fills two 32-bit words, then ``to_mont``, and
        ``neg`` where v < 0."""
        mag = np.abs(vals.astype(np.int64))
        words = np.zeros(vals.shape + (self.field.num_words,), np.uint32)
        words[..., 0] = (mag & WORD_MASK).astype(np.uint32)
        words[..., 1] = (mag >> 32).astype(np.uint32)
        m = ff.to_mont(self.field, torch.from_numpy(words.view(np.int32)).to(self.device))
        negative = torch.from_numpy(vals < 0).to(self.device)
        return torch.where(negative.unsqueeze(-1), ff.neg(self.field, m), m)

    def _promote(self, v) -> torch.Tensor:
        """int constant / SmallWord -> (N, W) Montgomery words."""
        if _is_int(v):
            return self._packed_const(int(v)).expand(self.batch, self.field.num_words)
        if isinstance(v, SmallWord):
            return self._small_to_mont(v.v)
        return v

    def _bool_tensor(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.asarray(v, dtype=bool), device=self.device)

    def _bool_op(self, np_op, torch_op, a, b):
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return torch_op(self._bool_tensor(a), self._bool_tensor(b))
        return np_op(np.asarray(a), np.asarray(b))

    # -- value hooks (batched) --

    def v_norm(self, v):
        if _is_int(v):
            return int(v) % self.field.p
        if isinstance(v, SmallWord):
            if v.v.shape != (self.batch,):
                raise ValueError(f"expected ({self.batch},) values, got {v.v.shape}")
            return v
        v = torch.as_tensor(v, device=self.device)
        if tuple(v.shape) != (self.batch, self.field.num_words):
            raise ValueError(f"expected ({self.batch}, {self.field.num_words}) words, got {tuple(v.shape)}")
        return v

    def v_add(self, a, b):
        if _is_int(a) and _is_int(b):
            return (int(a) + int(b)) % self.field.p
        # SmallWord fast paths: stay in host int64 while bounds allow
        if isinstance(a, SmallWord) or isinstance(b, SmallWord):
            if _is_int(a):
                a, b = b, a
            if _is_int(b):
                cc = self._centered(int(b))
                if isinstance(a, SmallWord) and abs(cc) + a.bound < _SMALL_LIMIT:
                    return self._small(a.v + cc)
            elif isinstance(a, SmallWord) and isinstance(b, SmallWord):
                if a.bound + b.bound < _SMALL_LIMIT:
                    return self._small(a.v + b.v)
        return self._op(ff.add, self._promote(a), self._promote(b))

    def v_scale(self, a, c: int):
        if _is_int(a):
            return (int(a) * c) % self.field.p
        if isinstance(a, SmallWord):
            cc = self._centered(c)
            if abs(cc) * a.bound < _SMALL_LIMIT:
                return self._small(a.v * cc)
        return self._op(ff.mont_mul, self._promote(a), self._packed_const(c))

    def v_mul(self, a, b):
        if _is_int(a) and _is_int(b):
            return (int(a) * int(b)) % self.field.p
        if isinstance(a, SmallWord) and isinstance(b, SmallWord):
            if a.bound * b.bound < _SMALL_LIMIT:
                return self._small(a.v * b.v)
        return self._op(ff.mont_mul, self._promote(a), self._promote(b))

    def v_mul_many(self, a, b):
        """One Montgomery product for all pairs when every value is on the
        device; SmallWord rows keep v_mul's small-domain path."""
        if all(isinstance(v, torch.Tensor) for v in (*a, *b)):
            return list(self._op(ff.mont_mul, torch.stack(a), torch.stack(b)).unbind(0))
        return super().v_mul_many(a, b)

    def v_affine(self, vals, rows, consts):
        """One Montgomery dot product for every row, over all instances (the
        plain tier's ``mont_dot_digits``, one reduction a row), where the
        scalar steps would take one product a coefficient and one addition
        a term."""
        if all(_is_int(v) for v in vals):
            return super().v_affine([int(v) for v in vals], rows, consts)
        x = torch.stack([self._promote(v) for v in vals], dim=-2)  # (N, K, W)
        out = self._op(_mont_dot_rows, x, self._packed_rows(rows))  # (R, N, W); the rows' words are c R
        if any(k % self.field.p for k in consts):
            out = self._op(ff.add, out, self._packed_rows(consts).unsqueeze(1))
        return list(out.unbind(0))

    def v_inv0(self, a):
        if _is_int(a):
            return super().v_inv0(int(a))
        # Fermat, a^(p - 2) by square-and-multiply (ff.inv's chain): inv(0) == 0
        x = acc = self._promote(a)
        for bit in bin(self.field.p - 2)[3:]:
            acc = self._op(ff.mont_mul, acc, acc)
            if bit == "1":
                acc = self._op(ff.mont_mul, acc, x)
        return acc

    def v_is_zero(self, a):
        if _is_int(a):
            return int(a) % self.field.p == 0
        if isinstance(a, SmallWord):
            # |a| < 2^62 << p/2: the centered residue is 0 iff the value is
            return a.v == 0
        return ff.is_zero(self.field, a)  # (N,) bool

    def v_bits(self, a, nbits: int):
        if _is_int(a):
            return super().v_bits(int(a), nbits)
        if isinstance(a, SmallWord):
            # host path: addmany decompositions of nonnegative word sums
            if (a.v < 0).any() or (nbits < 63 and (a.v >= (1 << nbits)).any()):
                raise ValueError("value does not fit requested bits")
            v = a.v.astype(np.uint64)
            return [((v >> np.uint64(i)) & 1) != 0 for i in range(nbits)]
        # device path (field-plane decompositions), after from_mont
        std = ff.from_mont(self.field, a).to(torch.int64) & WORD_MASK  # (N, W)
        shifts = torch.arange(32, device=std.device)
        bits = ((std.unsqueeze(-1) >> shifts) & 1).flatten(-2)[:, :nbits] == 1  # (N, nbits)
        return list(bits.unbind(1))

    def v_bool(self, b):
        if isinstance(b, (bool, int, np.bool_, np.integer)):
            return bool(b)
        return b  # (N,) bool array or tensor

    def v_from_bool(self, b):
        if isinstance(b, (bool, int, np.bool_, np.integer)):
            return int(bool(b))
        if isinstance(b, np.ndarray):
            # host bool plane (byte circuits): 0/1 SmallWord rows
            return SmallWord(b.astype(np.int64), 1)
        # device bool plane (field circuits): Montgomery 0 or 1
        one = self._packed_const(1)
        return torch.where(b.unsqueeze(-1), one, torch.zeros_like(one))

    def v_not(self, b):
        if _is_bool(b):
            return not b
        if isinstance(b, torch.Tensor):
            return torch.logical_not(b)
        return np.logical_not(b)

    def v_and(self, a, b):
        if _is_bool(a) and _is_bool(b):
            return a and b
        return self._bool_op(np.logical_and, torch.logical_and, a, b)

    def v_xor(self, a, b):
        if _is_bool(a) and _is_bool(b):
            return a ^ b
        return self._bool_op(np.logical_xor, torch.logical_xor, a, b)

    # word-level hooks (byte circuits): word values are (N,) numpy uint64
    # arrays, bit values (N,) numpy bool arrays; scalars stay Python
    # (instance-independent constants)

    def v_word_bits(self, value, n: int):
        if _is_int(value):
            return super().v_word_bits(int(value), n)
        v = _host(value)
        if v.shape != (self.batch,):
            raise ValueError(f"expected ({self.batch},) words, got {v.shape}")
        return [((v.astype(np.uint64) >> np.uint64(i)) & 1) != 0 for i in range(n)]

    def v_pack_word(self, bit_vals):
        if all(_is_bool(b) for b in bit_vals):
            return super().v_pack_word(bit_vals)
        acc = np.zeros((self.batch,), np.uint64)
        for i, b in enumerate(bit_vals):
            acc |= _host(b).astype(np.uint64) << np.uint64(i)
        return acc

    def v_word_to_field(self, word):
        if _is_int(word):
            return super().v_word_to_field(word)
        v = _host(word).astype(np.uint64)
        if (v >= _SMALL_LIMIT).any():
            raise ValueError("a word value must be below 2^62")
        return SmallWord(v.astype(np.int64), int(v.max(initial=0)) + 1)

    def v_select(self, c, a, b):
        if _is_bool(c):
            return a if c else b
        if isinstance(c, torch.Tensor) or isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return torch.where(self._bool_tensor(c), self._bool_tensor(a), self._bool_tensor(b))
        return np.where(c, a, b)

    # -- witness matrix --

    def stack_assignments(self) -> torch.Tensor:
        """(V, N, W) Montgomery witness matrix on the device (constants
        broadcast).  The SmallWord rows (the byte-circuit plane) go through
        ``to_mont`` in chunks of variables sized from CHUNK_BYTES."""
        small_idx = [i for i, v in enumerate(self.assignments) if isinstance(v, SmallWord)]
        small_rows = None
        if small_idx:
            vals = np.stack([self.assignments[i].v for i in small_idx], axis=0)  # (Vs, N)
            vc = max(1, CHUNK_BYTES // (max(self.batch, 1) * _mont_bytes(self.field)))
            small_rows = torch.cat([self._small_to_mont(vals[s : s + vc]) for s in range(0, vals.shape[0], vc)])
        rows = []
        si = 0
        for v in self.assignments:
            if isinstance(v, SmallWord):
                rows.append(small_rows[si])
                si += 1
            else:
                rows.append(self._promote(v))
        return torch.stack(rows, dim=0)

    def value_host(self, v, instance: int) -> int:
        """One instance's value of an assignment-style value, as an int."""
        if _is_int(v):
            return int(v) % self.field.p
        if isinstance(v, SmallWord):
            return int(v.v[instance]) % self.field.p
        return int(self.field.unpack(v[instance].cpu()))

    def eval_lc(self, lc):
        raise NotImplementedError(
            "BatchConstraintSystem is checked on the device: is_satisfied() / satisfied_per_instance()"
        )

    # -- the small-domain check (byte circuits) --

    def _small_check_data(self):
        """(the centered COO triples of the exact-int64 check, the (V, N)
        int64 centered values), or None when a value, coefficient, row bound
        or product bound exceeds the int64 budget.  Soundness: with every LC
        evaluation |a|, |b|, |c| < 2^55 and |a * b| < 2^62 << p, a * b == c
        (mod p) holds iff it holds over the integers, so no Montgomery
        arithmetic is needed.  Byte circuits (SHA-256, Blake2s: booleanity,
        xor, and, word packing) always qualify; field circuits take the
        Montgomery check."""
        LIM_V = 1 << 40  # value / coefficient magnitude budget
        LIM_R = 1 << 55  # per-row LC bound
        rows = np.empty((len(self.assignments), self.batch), np.int64)
        for i, v in enumerate(self.assignments):
            if isinstance(v, SmallWord):
                rows[i] = v.v
            elif _is_int(v):
                c = self._centered(int(v))
                if abs(c) >= LIM_V:
                    return None
                rows[i] = c
            else:
                return None
        vmax = np.abs(rows).max(axis=1, initial=0).astype(np.float64)
        if (vmax >= LIM_V).any():
            return None
        # centered COO coefficients do not depend on the values: cached per
        # constraint count (to_coo and the centering are the costly part);
        # the value bounds are checked again on every call, so a tampered
        # assignment can never overflow int64 unseen
        if self._small_coo is None or self._small_coo_n != self.num_constraints:
            coo = self.to_coo()
            cached = []
            for name in "abc":
                ri, ci, coeffs = coo[name]
                centered = {c: self._centered(int(c)) for c in set(coeffs)}
                if any(abs(c) >= LIM_V for c in centered.values()):
                    cached = False
                    break
                cc = np.fromiter(map(centered.__getitem__, coeffs), np.int64, len(coeffs))
                cached.append((ri.astype(np.int64), ci.astype(np.int64), cc))
            self._small_coo, self._small_coo_n = cached, self.num_constraints
        if self._small_coo is False:
            return None
        bounds = []
        for ri, ci, cc in self._small_coo:
            rb = np.zeros(self.num_constraints, np.float64)
            if len(ri):
                np.add.at(rb, ri, np.abs(cc).astype(np.float64) * vmax[ci])
            if rb.size and rb.max() >= LIM_R:
                return None
            bounds.append(rb)
        if self.num_constraints and (bounds[0] * bounds[1]).max() >= float(1 << 61):
            return None
        return tuple(self._small_coo), rows

    def _small_eval(self, sd, chunk):
        """Yield (start, (n, chunk) bool: a * b == c per constraint) over
        chunks of instances, from ``_small_check_data``'s result.  The
        centered COO triples go to the device once per constraint count."""
        triples, rows = sd
        key = ("small", self.num_constraints)
        if key not in self._device_coo:
            self._device_coo[key] = tuple(
                tuple(torch.from_numpy(x).to(self.device) for x in tri) for tri in triples
            )
        tris = self._device_coo[key]
        z = torch.from_numpy(rows).to(self.device)
        n = self.num_constraints
        if chunk is None:
            nnz = max(1, max(len(t[0]) for t in triples))
            chunk = max(1, min(self.batch, CHUNK_BYTES // (16 * nnz)))

        def ev(tri, zc):
            ri, ci, cc = tri
            prods = zc.index_select(0, ci) * cc.unsqueeze(1)
            return zc.new_zeros((n, zc.shape[1])).index_add_(0, ri, prods)

        for s in range(0, self.batch, chunk):
            zc = z[:, s : s + chunk]
            a, b, c = (ev(t, zc) for t in tris)
            yield s, a * b == c

    def which_unsatisfied(self, instance: int = None):
        """Each instance's first failing constraint, as an (N,) int64 tensor
        on the device (-1: satisfied); or one instance's index, or None, when
        ``instance`` is given (the scalar tier's debugging twin).  Byte
        circuits take the small-domain check, field circuits the Montgomery
        check (where the JAX package raises NotImplementedError)."""
        n = self.num_constraints
        firsts = []
        for _, ok in self._evaluate(None):
            # a failing sentinel row n below the constraints: argmax is n where all pass
            bad = torch.cat([~ok, ok.new_ones((1, ok.shape[1]))])
            first = bad.to(torch.uint8).argmax(dim=0)
            firsts.append(torch.where(first < n, first, -1))
        out = torch.cat(firsts)
        if instance is None:
            return out
        idx = int(out[instance])
        return None if idx < 0 else idx

    # -- checks --

    def is_satisfied(self) -> bool:
        """All instances satisfied."""
        return bool(self.satisfied_per_instance().all())

    def _mont_device(self):
        """The three packed matrices (``device_check._pack_matrix``) on the
        device, cached per constraint count."""
        key = ("mont", self.num_constraints)
        if key not in self._device_coo:
            coo = self.to_coo()
            self._device_coo[key] = [_pack_matrix(self.field, *coo[m], self.device) for m in "abc"]
        return self._device_coo[key]

    def _mont_eval(self, chunk):
        """Yield (start, (n, chunk) bool: a * b == c per constraint) over
        chunks of instances, in Montgomery form."""
        spec, n = self.field, self.num_constraints
        z = self.stack_assignments()  # (V, N, W)
        mats = self._mont_device()
        if chunk is None:
            per_instance = max(m[2].shape[0] * _mont_bytes(spec) + m[1].shape[0] * 16 * spec.num_words
                               for m in mats)
            chunk = max(1, min(self.batch, CHUNK_BYTES // per_instance))
        for s in range(0, self.batch, chunk):
            zc = z[:, s : s + chunk]
            a, b, c = (rows_eval(spec, m, zc, n) for m in mats)
            yield s, (ff.mont_mul(spec, a, b) == c).all(dim=-1)

    def _evaluate(self, chunk):
        """The per-constraint verdicts of the small-domain check where it
        applies, else of the Montgomery check."""
        if self.num_constraints == 0:
            return iter([(0, torch.ones((0, self.batch), dtype=torch.bool, device=self.device))])
        sd = self._small_check_data()
        return self._small_eval(sd, chunk) if sd is not None else self._mont_eval(chunk)

    def satisfied_per_instance(self, chunk: int = None) -> torch.Tensor:
        """(N,) bool on the device.  Byte circuits take the exact int64
        small-domain check; the others the Montgomery check, over chunks of
        ``chunk`` instances (by default as many as CHUNK_BYTES holds)."""
        return torch.cat([ok.all(dim=0) for _, ok in self._evaluate(chunk)])
