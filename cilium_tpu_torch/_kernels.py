"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``
(Hopper) into one shared library with a plain C interface, on first
use and never at import: the CPU tests import every module on a
machine with no CUDA toolkit. The library lands in
``build/cilium_tpu_torch/<hash of the sources>/`` at the repository
root, so an edited source builds anew and an unchanged one is reused.
One ``nvcc`` process per source compiles them all at once, and one
more links the objects.

Each kernel is reached through a :class:`Kernel`, which checks the
launch's return code (``cudaGetLastError()`` right after the launch)
and counts its launches, so a run can show which kernels a path went
through.

A missing ``nvcc``, a failed compile or link, a library that does not
load and a launch the C entry refuses all raise :class:`KernelError`:
the pipeline's failsafe treats it as a programmer error and lets it
reach the caller, never retrying it nor serving around it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "cilium_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# K12 ident_gather and K4 policymap_verdict take the row shards of an
# identity table as one struct by value (csrc/common.cuh ShardList)
IDENT_MAX_SHARDS = 16


class ShardList(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p * IDENT_MAX_SHARDS),
        ("row_lo", ctypes.c_int64 * IDENT_MAX_SHARDS),
        ("rows", ctypes.c_int64 * IDENT_MAX_SHARDS),
        ("n", ctypes.c_int),
    ]


def shard_list(shards) -> ShardList:
    """A :class:`ShardList` of ``(tensor, row_lo)`` pairs, each tensor a
    contiguous [rows, W] table holding rows [row_lo, row_lo + rows)."""
    lst = ShardList()
    for k, (t, row_lo) in enumerate(shards):
        lst.ptr[k], lst.row_lo[k], lst.rows[k] = t.data_ptr(), row_lo, t.shape[0]
    lst.n = len(shards)
    return lst


# K6 first_rule takes one to three terms as one struct by value
# (csrc/first_rule.cu FirstRuleTerms)
FIRST_RULE_MAX_TERMS = 3


class FirstRuleTerms(ctypes.Structure):
    _fields_ = [
        ("mask", ctypes.c_void_p * FIRST_RULE_MAX_TERMS),
        ("rule_of", ctypes.c_void_p * FIRST_RULE_MAX_TERMS),
        ("out", ctypes.c_void_p * FIRST_RULE_MAX_TERMS),
        ("width", ctypes.c_int * FIRST_RULE_MAX_TERMS),
        ("n", ctypes.c_int),
    ]


class KernelError(RuntimeError):
    """A kernel that could not be built, loaded or launched. Raised to
    the caller as is: it is no device fault a retry or a quarantine
    could cure (``datapath/pipeline.py`` ``_classify``)."""


_lock = threading.Lock()
# launch counts: a shadow rebuild launches K2 on its own thread while
# the serving thread launches K3 / K4, and ``+=`` is not atomic
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def resolve_device(device) -> torch.device:
    """``None`` means the card. Only an explicit CPU device runs the
    plain PyTorch versions; asking for CUDA without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cilium_tpu_torch runs on a CUDA device and none is available;"
            " pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build() -> Path:
    """Compile every ``csrc/*.cu`` into ``libcilium_kernels.so`` unless
    the library for these exact sources exists; returns its path. The
    sources compile in parallel, one ``nvcc`` process each, then one
    ``nvcc`` call links them."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libcilium_kernels.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        failed = []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise KernelError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise KernelError("nvcc link failed:\n" + proc.stdout)
        # atomic publish: a concurrent builder sees the old state or the
        # whole library, never a half-written file
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:  # a transient kind to the failsafe: say what it is
                raise KernelError(f"kernel library {path} failed to load: {e}") from e
            for k in KERNELS.values():
                fn = getattr(lib, k.symbol)
                fn.argtypes = [*k.argtypes, _I, _P]  # + device, stream
                fn.restype = _I
            lib.cilium_error_string.argtypes = [_I]
            lib.cilium_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One C entry point of the library plus its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence) -> None:
        self.name = name
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        lib = library()
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(index).cuda_stream
        err = getattr(lib, self.symbol)(*args, index, stream)
        if err != 0:
            msg = lib.cilium_error_string(err).decode()
            raise KernelError(f"CUDA kernel {self.name} failed to launch: {msg} ({err})")
        with _count_lock:
            self.launches += 1


KERNELS: Dict[str, Kernel] = {
    k.name: k
    for k in (
        # id_bits, conj_req, conj_forbid, conj_valid, req_count, out, n, w, s,
        # cps, staged
        Kernel("selector_match", "cilium_selector_match",
               [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]),
        # x, w, out, b, a, c, complement_x
        Kernel("bool_mm", "cilium_bool_mm", [_P, _P, _P, _I, _I, _I, _I]),
        # root_info, root_child, sub_child, sub_info, m, flat, addr, out, b
        Kernel("lpm_wide", "cilium_lpm_wide",
               [_P, _P, _P, _P, _I, _I, _P, _P, _L]),
        # id_bits shards, words, gathered, col_ep, col_port, col_proto,
        # col_is_l3, c, src_rows, ep_idx, dport, proto, denied_pf,
        # verdict, redirect, counters, ep_count, b
        Kernel("policymap_verdict", "cilium_policymap_verdict",
               [ShardList, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                _P, _I, _L]),
        # child, info, m, common, k, addr, stride, levels, out, b, vec
        Kernel("lpm_stride8", "cilium_lpm_stride8",
               [_P, _P, _I, _P, _I, _P, _I, _I, _P, _L, _I]),
        # terms (one to three masks, rule_of, outputs), b
        Kernel("first_rule", "cilium_first_rule", [FirstRuleTerms, _L]),
        # id_bits shards, rule_tab shards, words, gathered, col_ep,
        # col_port, col_proto, col_is_l3, c, src_rows, ep_idx, dport,
        # proto, denied_pf, verdict, redirect, rule, l4_covered,
        # counters, ep_count, hits, n_hits, b
        Kernel("policymap_verdict_attrib", "cilium_policymap_verdict_attrib",
               [ShardList, ShardList, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                _P, _P, _P, _P, _P, _I, _P, _I, _L]),
        # trans, q, accept_lo, accept_hi, starts, start_stride, bytes,
        # byte_size, row_stride, max_len, lengths, out_lo, out_hi, b,
        # table, vec_bytes, byte_class, class_trans, classes; one C
        # entry, counted apart for the scalar start (stride 0) and the
        # per-row starts of a fused table (stride 1)
        Kernel("dfa_walk", "cilium_dfa_walk",
               [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _L, _I, _I, _P, _P, _I]),
        Kernel("dfa_walk_fused", "cilium_dfa_walk",
               [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _L, _I, _I, _P, _P, _I]),
        # pair, q, accept_lo, accept_hi, starts, bytes, byte_size,
        # row_stride, max_len, lengths, out_lo, out_hi, b, vec_bytes
        Kernel("dfa_pair_walk", "cilium_dfa_pair_walk",
               [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _L, _I]),
        # the two entries of K9 lb_translate. index build: fe_bytes,
        # fe_port, fe_proto, f, l, index, n_slots
        Kernel("lb_index_build", "cilium_lb_index_build", [_P, _P, _P, _I, _I, _P, _L]),
        # translate: index, n_slots, fe_bytes, fe_port, fe_proto, fe_seq,
        # s, fe_seq_len, fe_revnat, f, be_bytes, be_port, nb, l, peer,
        # dport, proto, fhash, new_bytes, new_port, revnat, ok,
        # no_backend, b
        Kernel("lb_translate", "cilium_lb_translate",
               [_P, _L, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                _P, _P, _P, _P, _P, _L]),
        # the two entries of K10 ct_step. Both take the table (exp,
        # kc_lo, rec) and the six query word arrays. probe_claim: table,
        # c, words, proto, verdict, redirect, valid, now, established,
        # target, b
        Kernel("ct_probe_claim", "cilium_ct_probe_claim",
               [*[_P] * 3, _L, *[_P] * 6, _P, _P, _P, _P, _I, _P, _P, _L]),
        # commit: table, words, proto, now, target, established, verdict,
        # redirect, ep_idx, valid, counters, ep_count, b
        Kernel("ct_commit", "cilium_ct_commit",
               [*[_P] * 3, *[_P] * 6, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _L]),
        # the two entries of K11 shed_walk. wide: root_info, root_child,
        # sub_child, sub_info, m, flat, shed_tab, n_rows, world_row, addr,
        # dport, proto, out, b
        Kernel("shed_walk_wide", "cilium_shed_walk_wide",
               [_P, _P, _P, _P, _I, _I, _P, _L, _I, _P, _P, _P, _P, _L]),
        # stride8: child, info, m, common, k, shed_tab, n_rows, world_row,
        # addr, stride, levels, dport, proto, out, b, vec
        Kernel("shed_walk_stride8", "cilium_shed_walk_stride8",
               [_P, _P, _I, _P, _I, _P, _L, _I, _P, _I, _I, _P, _P, _P, _L, _I]),
        # K12 ident_gather: shards (every shard on one device), w, src,
        # b, out
        Kernel("ident_gather", "cilium_ident_gather", [ShardList, _I, _P, _L, _P]),
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def ptr(t: Optional[torch.Tensor]):
    """Device pointer of a contiguous tensor (None → null)."""
    return None if t is None else t.data_ptr()


def operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor: ``x`` itself when it is
    one already, without a call into torch (a wrapper's host work is
    a K4 or K6 launch's larger part)."""
    return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()


def check_cuda(name: str, device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on ``device``."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")


def dispatch_device(*tensors: torch.Tensor) -> torch.device:
    """The device every tensor lies on; a wrapper runs its plain
    version only when this is the CPU."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
