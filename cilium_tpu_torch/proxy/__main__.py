"""``python -m cilium_tpu_torch.proxy`` — the external L7 proxy process."""

import sys

from .standalone import main

if __name__ == "__main__":
    sys.exit(main())
