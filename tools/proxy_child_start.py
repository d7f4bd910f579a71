"""What a fresh external-proxy child spends before it serves: a probe,
not a test.

    python3 tools/proxy_child_start.py [REPS]

Runs each step of a child's start in a fresh interpreter, REPS times
(default 3): the interpreter alone, import torch, + torch.cuda.is_available(),
+ a CUDA context (a tensor on the card), the import of
cilium_tpu_torch.proxy.standalone, and that import with the child's
resolve_device(None) and a context. Prints each wall, and once the
card's name and power limit (nvidia-smi), the installation's bytecode
setting and torch's compiled-module folder. Needs a card for the CUDA
steps.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

STEPS = {
    "interpreter": "pass",
    "import torch": "import torch",
    "+ cuda.is_available": "import torch; torch.cuda.is_available()",
    "+ a context": "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()",
    "import standalone": "import cilium_tpu_torch.proxy.standalone",
    "import standalone + resolve + context": (
        "import cilium_tpu_torch.proxy.standalone, torch; "
        "from cilium_tpu_torch._kernels import resolve_device; "
        "torch.zeros(1, device=resolve_device(None)); torch.cuda.synchronize()"),
}


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    torch_dir = Path(importlib.util.find_spec("torch").origin).parent
    print(f"bytecode writing off: {bool(sys.flags.dont_write_bytecode)}; torch's __pycache__ "
          f"present: {(torch_dir / '__pycache__').is_dir()} [{card}]", flush=True)
    for rep in range(reps):
        for name, code in STEPS.items():
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
            print(f"child start, rep {rep}: {name} {time.perf_counter() - t0!r} s [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
