"""Datapath: the batched IPv4 flow pipeline (reference: bpf/ +
pkg/datapath)."""

from .fastpath import VerdictFastpath
from .pipeline import DatapathPipeline, DatapathTables, DROP_PREFILTER, DROP_POLICY, FORWARD

__all__ = [
    "DatapathPipeline",
    "DatapathTables",
    "VerdictFastpath",
    "DROP_PREFILTER",
    "DROP_POLICY",
    "FORWARD",
]
