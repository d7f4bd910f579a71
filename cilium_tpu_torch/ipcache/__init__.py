"""IP → identity cache (reference: pkg/ipcache)."""

from .ipcache import Entry, IPCache, SOURCE_AGENT, SOURCE_K8S, SOURCE_KVSTORE
from .prefilter import PreFilter

__all__ = [
    "Entry",
    "IPCache",
    "PreFilter",
    "SOURCE_AGENT",
    "SOURCE_K8S",
    "SOURCE_KVSTORE",
]
