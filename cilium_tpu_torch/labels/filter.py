"""User label filter.

Reference semantics: pkg/labels/filter.go — an ordered allow/deny prefix
list deciding which workload labels are security-relevant (only those
feed identity allocation). Default: k8s/container/reserved labels are
included; ``io.kubernetes``-style infra labels are excluded.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from .label import Label

_DEFAULT_DENIED_PREFIXES = (
    "io.kubernetes",
    "kubernetes.io",
    "pod-template-generation",
    "pod-template-hash",
    "controller-revision-hash",
    "annotation.",
    "etcd_node",
)


class LabelFilter:
    """Ordered include/exclude prefix filter over label keys.

    Each entry is (include: bool, source or "", key-prefix). First match
    wins; unmatched labels are included unless any explicit inclusive
    filter exists (mirroring the reference's behaviour where a user
    allowlist flips the default).
    """

    def __init__(self, entries: Iterable[Tuple[bool, str, str]] = ()):
        self._entries: List[Tuple[bool, str, str]] = list(entries)
        for prefix in _DEFAULT_DENIED_PREFIXES:
            self._entries.append((False, "", prefix))
        self._has_includes = any(inc for inc, _, _ in self._entries)

    @classmethod
    def parse(cls, specs: Iterable[str]) -> "LabelFilter":
        """Parse CLI-style specs: ``[+|-]source:prefix`` (pkg/labels
        ParseLabelPrefixCfg). ``+`` or bare = include, ``-`` = exclude."""
        entries = []
        for spec in specs:
            include = True
            if spec.startswith("!") or spec.startswith("-"):
                include, spec = False, spec[1:]
            elif spec.startswith("+"):
                spec = spec[1:]
            source, _, prefix = spec.rpartition(":")
            entries.append((include, source, prefix))
        return cls(entries)

    def allows(self, label: Label) -> bool:
        for include, source, prefix in self._entries:
            if source and source != label.source:
                continue
            if label.key.startswith(prefix):
                return include
        if label.is_reserved:
            return True
        return not self._has_includes

    def filter(self, labels: Iterable[Label]) -> Tuple[List[Label], List[Label]]:
        """Split labels into (security-relevant, ignored)."""
        kept, dropped = [], []
        for l in labels:
            (kept if self.allows(l) else dropped).append(l)
        return kept, dropped
