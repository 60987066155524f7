"""Library-wide error types.

The same small hierarchy as the JAX package's ``errors.py`` (the reference's
``Error::{IncorrectInputLength, NotPrimeOrder, GenericError,
SerializationError}``), plus the errors the port raises where the JAX package
returned ``None`` or fell back silently.  Verification APIs return ``False``
rather than raising, as the reference's ``Ok(false)`` does.
"""


class CryptoError(Exception):
    """Base class for all framework errors."""


class IncorrectInputLength(CryptoError):
    def __init__(self, length: int):
        super().__init__(f"incorrect input length {length}")
        self.length = length


class NotPrimeOrder(CryptoError):
    def __init__(self):
        super().__init__("element is not prime order")


class SerializationError(CryptoError):
    pass


class DeviceUnavailable(CryptoError):
    """The requested device (CUDA by default) is not present."""


class MissingParameters(CryptoError):
    """No default parameter table exists for the requested configuration."""
