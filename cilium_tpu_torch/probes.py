"""Node capability probes + graceful degradation flags.

Reference: bpf/run_probes.sh + bpf/probes/*.t — at
agent boot the reference probes the kernel for BPF features and writes
``bpf_features.h`` so the datapath compiles against what the node
actually supports, degrading gracefully (e.g. hash-fallback ipcache on
non-LPM kernels). Same stance here: probe the accelerator + toolchain
once at boot, expose the result in ``cilium status``/debuginfo, and
let subsystems gate on it instead of crashing mid-datapath.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

_lock = threading.Lock()
_cached: Optional[Dict] = None


def _probe_device() -> Dict:
    try:
        import torch

        if torch.cuda.is_available():
            return {
                "ok": True,
                "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count(),
                "accelerator": True,
            }
        return {
            "ok": True,
            "platform": "cpu",
            "device_kind": "cpu",
            "device_count": 1,
            "accelerator": False,
        }
    except Exception as e:  # no usable backend: host-only mode
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def _probe_donation() -> bool:
    """In-place update of a caller's buffer (the in-place device CT
    update path). PyTorch has no buffer donation; one ``add_(1)`` into
    an int32[8] zero tensor on the probed device, read back as all
    ones, is the same contract."""
    try:
        import torch

        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        x = torch.zeros(8, dtype=torch.int32, device=dev)
        x.add_(1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return bool((x == 1).all().item())
    except Exception:
        return False


def _probe_native() -> Dict:
    """The C++ front-end toolchain (g++ + dlopen), the run_probes
    analog for SURVEY native census item 1."""
    try:
        from .native import build

        build.load()
        return {"ok": True, "so": build._so_path()}
    except Exception as e:
        return {"ok": False, "error": str(e)[:200]}


def _probe_dfa() -> bool:
    """L7 regex → DFA compilation (device L7 offload)."""
    try:
        from .l7.regex_compile import compile_patterns

        compile_patterns(["/probe/[a-z]+"])
        return True
    except Exception:
        return False


def _probe_sqlite_kvstore() -> bool:
    try:
        import sqlite3

        conn = sqlite3.connect(":memory:")
        conn.execute("create table t (k text primary key, v blob)")
        conn.close()
        return True
    except Exception:
        return False


def probe_features(force: bool = False) -> Dict:
    """Run (or return the cached) node capability probe set. Cheap
    probes run eagerly; the native build probe compiles at most once
    (cached by source hash in native/build.py)."""
    global _cached
    with _lock:
        if _cached is not None and not force:
            return _cached
        device = _probe_device()
        native = _probe_native()
        feats = {
            "device": device,
            "device_donation": _probe_donation() if device.get("ok") else False,
            "native_fastpath": native,
            "l7_dfa": _probe_dfa(),
            "kvstore_sqlite": _probe_sqlite_kvstore(),
        }
        feats["degraded"] = sorted(
            name
            for name, ok in (
                ("accelerator", bool(device.get("accelerator"))),
                ("native_fastpath", bool(native.get("ok"))),
                ("l7_dfa", feats["l7_dfa"]),
                ("kvstore_sqlite", feats["kvstore_sqlite"]),
            )
            if not ok
        )
        _cached = feats
        return feats


def peek_features() -> Optional[Dict]:
    """The cached probe result, or None while probing hasn't finished —
    the non-blocking read a status endpoint wants (the first probe can
    pay a g++ compile + backend init)."""
    with _lock:
        return _cached


def probe_in_background() -> None:
    """Kick off the probe set on a daemon thread (the agent-boot
    analog of running bpf/run_probes.sh once at startup)."""
    threading.Thread(target=probe_features, daemon=True).start()


def reset_cache() -> None:
    global _cached
    with _lock:
        _cached = None
