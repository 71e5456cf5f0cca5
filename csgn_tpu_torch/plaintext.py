"""One-bit plaintext over F2.

Mirrors reference `certFHE::Plaintext` (src/Plaintext.{h,cpp}): the value is
always masked to its low bit (reference src/Plaintext.cpp:49-52 uses the BIT
macro, src/utils.h:1).
"""

from __future__ import annotations

__all__ = ["Plaintext"]


class Plaintext:
    """A single bit.  ``Plaintext(v)`` keeps only ``v & 1``."""

    __slots__ = ("_value",)

    def __init__(self, value: int = 0):
        self._value = int(value) & 0x01

    @property
    def value(self) -> int:
        return self._value

    def set_value(self, value: int) -> None:
        self._value = int(value) & 0x01

    def __int__(self) -> int:
        return self._value

    def __eq__(self, other) -> bool:
        if isinstance(other, Plaintext):
            return self._value == other._value
        if isinstance(other, int):
            return self._value == (other & 0x01)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(("Plaintext", self._value))

    def __repr__(self) -> str:
        return f"Plaintext({self._value})"

    def __str__(self) -> str:
        # Reference prints bare '0'/'1' (src/Plaintext.cpp:10-19).
        return str(self._value)
