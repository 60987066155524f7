"""crypto_primitives_tpu_torch: the PyTorch/CUDA port of crypto_primitives_tpu.

Each module has a twin of the same path in the JAX package, which stays the
reference the port is tested against.  Field elements are Montgomery words:
``torch.int32`` tensors of shape ``(..., W)`` holding uint32 bit patterns,
little-endian, with the JAX package's Montgomery radix R = 2^(16 L) = 2^(32 W).
The hot loops (the Poseidon permutation and SHA-256 compression) are CUDA
kernels written for Hopper (``csrc/``), built with ``nvcc`` at first use
(``native/build.py``); on CPU tensors the same functions run their plain
PyTorch versions.

Importing the package builds nothing and imports neither JAX nor the JAX
package.
"""

__version__ = "0.1.0"
