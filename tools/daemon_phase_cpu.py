"""Phase 3u of chip_smoke.py (the daemon and its REST API) on the CPU: a
rehearsal, not a test.

    python3 tools/daemon_phase_cpu.py [--small]

Runs chip_smoke.daemon_main_path(0, "cpu", dev="cpu") with both agents on
the plain versions: the card agent's device resolved to the CPU and
torch.cuda.synchronize a no-op, and the plain K1 selector_match, K2
bool_mm, K3 lpm_wide and K4 policymap_verdict counted as launches of
their kernels (the phase's launch checks read them). At the bench
world's full size (10 000 rules, 2 048 identities, 64 endpoints,
1 048 576-flow batches) by default; --small: 800 rules, 256 identities,
16 endpoints, 65 536-flow batches, 16 384-lane slices. The phase's wall
limit is lifted. Prints the phase's lines, then the launches and the
wall.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def count_as(mod, name: str, kernel: str) -> None:
    from cilium_tpu_torch import _kernels

    plain = getattr(mod, name)

    def counted(*a, **k):
        with _kernels._count_lock:
            _kernels.KERNELS[kernel].launches += 1
        return plain(*a, **k)

    setattr(mod, name, counted)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as c
    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops import bitmap, lookup, lpm, verdict

    resolve = _kernels.resolve_device
    _kernels.resolve_device = lambda d: resolve(
        "cpu" if d is None or str(d).startswith("cuda") else d)
    torch.cuda.synchronize = lambda *a, **k: None
    count_as(bitmap, "selector_match_plain", "selector_match")
    count_as(verdict, "bool_mm_plain", "bool_mm")
    count_as(lpm, "lpm_wide_plain", "lpm_wide")
    count_as(lookup, "policymap_verdict_plain", "policymap_verdict")
    if args.small:
        c.N_RULES, c.N_IDENTITIES, c.N_ENDPOINTS, c.BATCH = 800, 256, 16, 1 << 16
        c.DAEMON_SLICE = 1 << 14
    c.DAEMON_PHASE_LIMIT_S = float("inf")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    c.daemon_main_path(0, "cpu", dev="cpu")
    print(f"launches {_kernels.launches()}; wall {time.perf_counter() - t0!r}s", flush=True)


if __name__ == "__main__":
    main()
