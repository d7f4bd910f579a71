"""``python -m cilium_tpu_torch.health`` — the standalone per-node health
endpoint process (cilium-health/main.go entry point)."""

import sys

from .standalone import main

if __name__ == "__main__":
    sys.exit(main())
