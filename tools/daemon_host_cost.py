"""What one port agent's host work costs at the bench world: a probe, not
a test.

    python3 tools/daemon_host_cost.py [REPS]

Builds chip_smoke's bench world with its L7 rules (10 000 rules over 512
apps, 2 048 identities) and times, REPS times each (default 3), the host
steps a Daemon repeats: Repository.resolve_l4_policy of one endpoint's
labels (every endpoint's regeneration with the proxy walks the rules
once a direction), the rules' JSON for PUT /policy, and save_state's
body (rule_to_dict of every rule, json.dump with indent=1 to a file),
which every endpoint add and every restored endpoint pays. Host only: no
card is needed. Prints each step's times, and the card's name and power
limit where nvidia-smi answers.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3

    import chip_smoke as c
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api.serialization import rule_to_dict, rules_from_json

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    print(f"card: {smi or 'none'}", flush=True)
    t0 = time.perf_counter()
    repo, _reg, _cache, idents, labels_of = c.build_world(0, l7=True)
    print(f"world: {len(repo.rules)} rules, {len(idents)} identities in "
          f"{time.perf_counter() - t0!r}s", flush=True)

    def timed(what, fn):
        xs = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            xs.append(time.perf_counter() - t)
        print(f"{what}: {[round(x, 6) for x in xs]} s", flush=True)

    labels = [parse_label_array(labels_of[idents[k].id]) for k in range(reps)]
    it = iter(labels * 2)
    timed("resolve_l4_policy (one endpoint, both directions)",
          lambda: repo.resolve_l4_policy(next(it)))
    text = json.dumps([rule_to_dict(r) for r in repo.rules])
    timed("rules to JSON (PUT /policy body)",
          lambda: json.dumps([rule_to_dict(r) for r in repo.rules]))
    timed("rules_from_json (the PUT's parse)", lambda: rules_from_json(text))
    with tempfile.TemporaryDirectory() as tmp:
        def save():
            body = {"rules": [rule_to_dict(r) for r in repo.rules]}
            with open(f"{tmp}/state.json", "w") as f:
                json.dump(body, f, indent=1)

        timed("save_state's state.json (every endpoint add and restored endpoint)", save)


if __name__ == "__main__":
    main()
