"""``python -m cilium_tpu_torch.monitor`` — the standalone node monitor
process (cilium-node-monitor entry point, monitor/monitor.go)."""

import sys

from .standalone import main

if __name__ == "__main__":
    sys.exit(main())
