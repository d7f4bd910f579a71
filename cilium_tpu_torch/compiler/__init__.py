"""Policy compiler: Repository + IdentityRegistry → dense device tensors.

This is the TPU-native replacement for the reference's per-endpoint
policy resolution loop (pkg/endpoint/policy.go:317-389, the O(identities
× rules) walk) and the clang/llc datapath compile pipeline
(pkg/datapath/loader/compile.go): instead of compiling C programs per
endpoint, the whole rule repository is lowered once into dense arrays
that a jitted verdict kernel evaluates for *batches* of flows.
"""

from .selectors import SelectorTable
from .program import (
    CompiledPolicy,
    CompileState,
    DirectionPacker,
    DirectionProgram,
    compile_policy,
    compile_policy_state,
    host_selector_matches,
    try_append_rules,
)

__all__ = [
    "SelectorTable",
    "CompiledPolicy",
    "CompileState",
    "DirectionPacker",
    "DirectionProgram",
    "compile_policy",
    "compile_policy_state",
    "host_selector_matches",
    "try_append_rules",
]
