"""Label and LabelArray.

Reference semantics: pkg/labels/labels.go (Label struct, NewLabel,
ParseLabel source-prefix handling) and pkg/labels/array.go (sorted
canonical form used as the identity allocation key).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Tuple

_DEFAULT_SOURCE = "unspec"
_ANY_SOURCE = "any"


@dataclasses.dataclass(frozen=True, order=True)
class Label:
    """A single security-relevant label.

    Ordering/equality are over (source, key, value) which makes sorted
    tuples of labels canonical identity keys.
    """

    source: str
    key: str
    value: str = ""

    def __str__(self) -> str:
        if self.value:
            return f"{self.source}:{self.key}={self.value}"
        return f"{self.source}:{self.key}"

    @property
    def is_reserved(self) -> bool:
        return self.source == "reserved"

    @property
    def is_cidr(self) -> bool:
        return self.source == "cidr"

    def matches(self, other: "Label") -> bool:
        """Selector-style match: ``self`` (the selector label) matches
        ``other`` when key and value agree and the source agrees or the
        selector's source is ``any`` (pkg/labels/labels.go Label.Matches).
        """
        if self.key != other.key or self.value != other.value:
            return False
        return self.source == _ANY_SOURCE or self.source == other.source


def parse_label(text: str) -> Label:
    """Parse ``source:key=value`` (source and value optional).

    ``app=web`` → unspec source. ``k8s:app=web`` → k8s source. A leading
    ``any:`` keeps the wildcard source. Mirrors pkg/labels ParseLabel.
    """
    text = text.strip()
    source = _DEFAULT_SOURCE
    rest = text
    if ":" in text:
        maybe_source, after = text.split(":", 1)
        # Only treat the prefix as a source when it looks like one (no '='
        # before the colon), matching the reference parser.
        if "=" not in maybe_source:
            source, rest = (maybe_source or _DEFAULT_SOURCE), after
    if "=" in rest:
        key, value = rest.split("=", 1)
    else:
        key, value = rest, ""
    return Label(source=source, key=key, value=value)


def parse_label_array(texts: Iterable[str]) -> "LabelArray":
    return LabelArray(parse_label(t) for t in texts)


class LabelArray:
    """An immutable, sorted, de-duplicated set of labels.

    The sorted tuple is the canonical form: two LabelArrays with the same
    labels in any order are equal and hash equal — this is the identity
    allocation key (pkg/identity/allocator.go globalIdentity keyed by
    sorted label list).
    """

    __slots__ = ("_labels",)

    def __init__(self, labels: Iterable[Label] = ()):
        self._labels: Tuple[Label, ...] = tuple(sorted(set(labels)))

    def __iter__(self) -> Iterator[Label]:
        return iter(self._labels)

    def __len__(self) -> int:
        return len(self._labels)

    def __contains__(self, label: Label) -> bool:
        return label in self._labels

    def __eq__(self, other: object) -> bool:
        return isinstance(other, LabelArray) and self._labels == other._labels

    def __hash__(self) -> int:
        return hash(self._labels)

    def __repr__(self) -> str:
        return f"LabelArray([{', '.join(str(l) for l in self._labels)}])"

    def sorted_key(self) -> str:
        """Canonical string key for kvstore identity allocation."""
        return ";".join(str(l) for l in self._labels)

    def union(self, other: "LabelArray") -> "LabelArray":
        return LabelArray((*self._labels, *other._labels))

    def has(self, selector_label: Label) -> bool:
        """True when any member matches ``selector_label`` under
        wildcard-source rules."""
        return any(selector_label.matches(l) for l in self._labels)

    def to_strings(self) -> Tuple[str, ...]:
        return tuple(str(l) for l in self._labels)
