"""Native (C++) enforcement front-end — the eBPF-datapath role of the
reference rebuilt as a userspace batch evaluator consuming the
policy state the port compiles on the card (SURVEY native census
item 1)."""

from .build import available as native_available
from .fastpath import NativeFastpath

__all__ = ["NativeFastpath", "native_available"]
