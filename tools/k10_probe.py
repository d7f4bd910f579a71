"""Where K10 ct_step's time goes on the card: a probe, not a test.

    python3 tools/k10_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k10_probe/, copies of cilium_tpu_torch/csrc/ct_step.cu with parts
compiled out or changed, and tools/k10_split_layout.cu (the first
version: the table as seven [C] arrays and an owner array), and times
one step of both entries with the verdict tail in a CUDA graph
(chip_smoke.graph_ms: the device's time without the wrapper's host
work) at the bench's 2^22 slots, 1 048 576 lanes of random keys, every
lane allowed, 64 endpoints:

  insert-heavy  every slot expired: a graph holds the table's exp reset
                (timed alone and taken off) and 20 steps, each at a clock
                past the last one's TCP lifetime, so every step finds a
                free table and inserts
  hit-heavy     the table after one insert step of the same lanes, the
                clock fixed: the steps refresh their hits and change
                nothing else

Variants of the record layout run through the port's own wrapper
(datapath/device_ct.py ct_step_verdict, the library handle swapped for
the copy's); the seven-array layout through the same allocations and
its own two entries:

  record            the kernel as built (its outputs checked equal to the
                    plain version and to the seven-array layout's)
  seven arrays      the first version: five more arrays a key match
                    reads, seven writes an insert, windows loaded one
                    after the other
  no claims         the owner atomicMax compiled out (no lane inserts:
                    ct_commit writes only verdicts and counters)
  no reply window   the reply tuple never probed (its loads and compares
                    compiled out)
  serial windows    the reply window's exp and kc_lo loaded only after
                    the forward window's compares, as the first version
                    did
  no record reads   a live kc_lo tag taken as a match without reading
                    the record

Only "record" computes the step; the others time what is left. The
patches match exact source lines and the probe exits non-zero when one
is gone, so edit PATCHES with the kernel. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "cilium_tpu_torch" / "csrc" / "ct_step.cu"
SPLIT = Path(__file__).resolve().parent / "k10_split_layout.cu"
OUT = REPO / "build" / "k10_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared"]

REPLY_LOAD = "    load_window(t, hr, cmask, e_r, k_r);\n"
PATCHES = {
    "record": [],
    "no claims": [("        atomicMax(t.rec + (int64_t)ins * REC + OWNER, (int)i);\n", "")],
    "no reply window": [(REPLY_LOAD, "#pragma unroll\n    for (int p = 0; p < CT_PROBES; ++p) "
                                     "{\n        e_r[p] = now;\n        k_r[p] = 0;\n    }\n")],
    "serial windows": [(REPLY_LOAD, ""),
                       ("    // reply window\n",
                        "    // reply window\n    asm volatile(\"\" ::: \"memory\");\n" + REPLY_LOAD)],
    "no record reads": [("k_f[p] == w[5] && record_is(t, s, w)", "k_f[p] == w[5]"),
                        ("k_r[p] == f[5] && record_is(t, s, f)", "k_r[p] == f[5]")],
}
SPLIT_NAME = "seven arrays"
CT_BITS = 22
N_LANES = 1 << 20
N_EPS = 64
STEPS = 20


def build() -> dict:
    """One shared library per variant, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    sources = {}
    for name, patches in PATCHES.items():
        src = text
        for old, new in patches:
            if old not in src:
                sys.exit(f"k10_probe: the line {old!r} of {SRC.name} is gone; edit PATCHES")
            src = src.replace(old, new)
        sources[name] = src
    sources[SPLIT_NAME] = SPLIT.read_text()
    procs = {}
    for k, (name, src) in enumerate(sources.items()):
        cu = OUT / f"v{k}.cu"
        cu.write_text(src)
        so = OUT / f"v{k}.so"
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-I", str(SRC.parent), str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k10_probe: nvcc failed on {name!r}:\n{out}")
        libs[name] = so
    return libs


class Variant:
    """A library handle for the wrapper: the copy's two K10 entries."""

    def __init__(self, path: Path) -> None:
        from cilium_tpu_torch import _kernels

        lib = ctypes.CDLL(str(path))
        for name in ("ct_probe_claim", "ct_commit"):
            k = _kernels.KERNELS[name]
            fn = getattr(lib, k.symbol)
            fn.argtypes = [*k.argtypes, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            setattr(self, k.symbol, fn)

    @staticmethod
    def cilium_error_string(err: int) -> bytes:
        return f"CUDA error {err}".encode()


class SplitTable:
    """The first version's table (seven [C] arrays and an owner array)
    and a step through its two entries, with the wrapper's allocations."""

    def __init__(self, path: Path, c: int, dev) -> None:
        import torch

        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.lib = ctypes.CDLL(str(path))
        self.claim = self.lib.cilium_ct_probe_claim
        self.claim.argtypes = [*[P] * 8, L, *[P] * 6, P, P, P, P, I, P, P, L, I, P]
        self.commit = self.lib.cilium_ct_commit
        self.commit.argtypes = [*[P] * 8, *[P] * 6, P, I, P, P, P, P, P, P, P, I, L, I, P]
        for fn in (self.claim, self.commit):
            fn.restype = ctypes.c_int
        self.arrays = [torch.zeros(c, dtype=torch.int32, device=dev) for _ in range(7)]
        self.owner = torch.full((c,), -1, dtype=torch.int32, device=dev)
        self.c, self.dev = c, dev

    def step(self, words, proto, now, verdict, redirect, valid, ep_idx, ep_count):
        import torch

        b = proto.shape[0]
        verdict, redirect = verdict.clone(), redirect.clone()
        counters = torch.zeros((ep_count, 3), dtype=torch.int32, device=self.dev)
        est = torch.empty(b, dtype=torch.bool, device=self.dev)
        target = torch.empty(b, dtype=torch.int32, device=self.dev)
        tab = [a.data_ptr() for a in self.arrays] + [self.owner.data_ptr()]
        q = [w.data_ptr() for w in words]
        stream = torch.cuda.current_stream().cuda_stream
        dev = self.dev.index or 0
        for err in (
            self.claim(*tab, self.c, *q, proto.data_ptr(), verdict.data_ptr(), redirect.data_ptr(),
                       valid.data_ptr(), now, est.data_ptr(), target.data_ptr(), b, dev, stream),
            self.commit(*tab, *q, proto.data_ptr(), now, target.data_ptr(), est.data_ptr(),
                        verdict.data_ptr(), redirect.data_ptr(), ep_idx.data_ptr(),
                        valid.data_ptr(), counters.data_ptr(), ep_count, b, dev, stream),
        ):
            if err:
                sys.exit(f"k10_probe: the seven-array entries failed to launch ({err})")
        return verdict, redirect, counters, est

    def exp(self):
        return self.arrays[6]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k10_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath import device_ct as dct

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    rs = np.random.default_rng(10)
    peer = [torch.from_numpy(rs.integers(-2**31, 2**31, N_LANES).astype(np.int32)).to(dev)
            for _ in range(4)]
    fields = [rs.integers(0, N_EPS, N_LANES), rs.integers(1024, 60001, N_LANES),
              rs.choice(np.array([80, 443, 8080, 53]), N_LANES), rs.choice(np.array([6, 17]), N_LANES)]
    ep, sp, dp, pr = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in fields)
    kc = dct.pack_kc_words(ep, sp, dp, pr, 1)
    words = (*peer, *kc)
    tail = [torch.ones(N_LANES, dtype=torch.int8, device=dev),
            torch.zeros(N_LANES, dtype=torch.bool, device=dev),
            torch.ones(N_LANES, dtype=torch.bool, device=dev), ep]
    now0, life = 1000, dct.LIFE_TCP_S + 1
    c = 1 << CT_BITS

    def record_step(st, now):
        return dct.ct_step_verdict(st, words[:2], words[2:4], words[4:], pr, now, *tail, N_EPS)

    results = {}
    for name, path in libs.items():
        if name == SPLIT_NAME:
            tab = SplitTable(path, c, dev)

            def step(now, tab=tab):
                return tab.step(words, pr, now, *tail, N_EPS)

            exp = tab.exp()
        else:
            with _kernels._lock:
                _kernels._lib = Variant(path)
            st = dct.make_state(CT_BITS, device=dev)

            def step(now, st=st):
                return record_step(st, now)

            exp = st.exp
        # insert-heavy: the reset and STEPS steps at rising clocks in one graph
        exp.zero_()
        out = step(now0)
        if name in ("record", SPLIT_NAME):
            results[name] = [x.cpu() for x in out]

        def inserts(exp=exp, step=step):
            exp.zero_()
            for k in range(STEPS):
                step(now0 + k * life)

        reset = smoke.median(smoke.graph_ms(exp.zero_))
        ins = smoke.median(smoke.graph_ms(inserts, launches=1))
        # hit-heavy: the table after one insert step, the clock fixed
        exp.zero_()
        step(now0)
        hit_out = step(now0)
        if name in ("record", SPLIT_NAME):
            results[name + " hit"] = [x.cpu() for x in hit_out]
        hits = smoke.graph_ms(lambda step=step: step(now0))
        print(f"{name:<16} insert-heavy graph_ms {(ins - reset) / STEPS!r} (the graph of the exp "
              f"reset and {STEPS} steps {ins!r}, the reset alone {reset!r}); hit-heavy graph_ms "
              f"{smoke.median(hits)!r} {hits}; established on the hit-heavy step "
              f"{int(hit_out[3].sum())} of {N_LANES} [{card}]", flush=True)
    # the record kernel against the plain version and the seven-array layout
    st_p = dct.make_state(CT_BITS, device=dev)
    plain = dct.ct_step_verdict_plain(st_p, words[:2], words[2:4], words[4:], pr, now0, *tail,
                                      N_EPS)
    plain_hit = dct.ct_step_verdict_plain(st_p, words[:2], words[2:4], words[4:], pr, now0, *tail,
                                          N_EPS)
    bad = 0
    for want, got in ((plain, results["record"]), (plain_hit, results["record hit"]),
                      (results[SPLIT_NAME], results["record"]),
                      (results[SPLIT_NAME + " hit"], results["record hit"])):
        bad += sum(int((a.cpu().to(torch.int64) != b.to(torch.int64)).sum())
                   for a, b in zip(want, got))
    print(f"record: mismatches against the plain version and the seven-array layout {bad}",
          flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
