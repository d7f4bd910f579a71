"""Build + load the native front-end shared library.

The reference ships its datapath as C compiled on the node by the
agent (clang via pkg/datapath/loader); same stance here — g++ is part
of the node toolchain, the .so is built once per source hash and
cached, and loading is a plain dlopen via ctypes (no pybind11 in the
image; SURVEY environment notes)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "fastpath.cpp")
# per-user 0700 cache dir: the path is predictable, so a shared dir
# would let another local user pre-plant a .so at the known hash path
# and get code into our process at dlopen
_CACHE_DIR = os.environ.get(
    "CILIUM_TPU_TORCH_NATIVE_CACHE",
    os.path.join(
        tempfile.gettempdir(), f"cilium_tpu_torch_native_{os.getuid()}"
    ),
)

# fastpath.cpp is the reference's byte for byte. It names std::string and
# std::move without including <string> or <utility>; g++ 12 pulls both in
# through <map>, g++ 13 does not and refuses the file. The build
# force-includes them instead of editing the source.
FORCE_INCLUDE = ("string", "utility")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_CACHE_DIR, f"fastpath_{digest}.so")


def _check_owned(path: str) -> bool:
    try:
        st = os.stat(path)
    except OSError:
        return False
    return st.st_uid == os.getuid()


def compile_command(out: str) -> list:
    """The g++ command that builds fastpath.cpp into ``out``."""
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
    for header in FORCE_INCLUDE:
        cmd += ["-include", header]
    return cmd + ["-o", out, _SRC]


def build() -> str:
    """Compile (cached by source hash) → .so path. A cached .so is
    trusted only if we own it — never dlopen another user's file."""
    so = _so_path()
    if os.path.exists(so) and _check_owned(so):
        return so
    os.makedirs(_CACHE_DIR, mode=0o700, exist_ok=True)
    if not _check_owned(_CACHE_DIR):
        raise RuntimeError(f"native cache dir {_CACHE_DIR} not owned by us")
    tmp = so + f".tmp.{os.getpid()}"
    cmd = compile_command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed: {proc.stderr[-2000:]}")
    os.replace(tmp, so)  # atomic: concurrent builders race safely
    return so


def load() -> ctypes.CDLL:
    """Build if needed and dlopen; signature setup happens here once."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(_build_error)
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        _build_error = str(e)
        raise RuntimeError(_build_error) from None
    c = ctypes
    u8p, i8p = c.POINTER(c.c_uint8), c.POINTER(c.c_int8)
    i32p, u32p = c.POINTER(c.c_int32), c.POINTER(c.c_uint32)
    i64p, u64p = c.POINTER(c.c_int64), c.POINTER(c.c_uint64)
    lib.nf_create.restype = c.c_void_p
    lib.nf_create.argtypes = [c.c_uint32, c.c_int]
    lib.nf_destroy.argtypes = [c.c_void_p]
    lib.nf_set_world.argtypes = [c.c_void_p, c.c_uint64]
    lib.nf_load_policy.restype = c.c_int64
    lib.nf_load_policy.argtypes = [
        c.c_void_p, c.c_int64, u64p, u32p, u32p, u32p, u32p, u8p,
    ]
    lib.nf_load_trie.argtypes = [
        c.c_void_p, c.c_int, i32p, i32p, c.c_int32, c.c_int,
    ]
    lib.nf_ct_flush.argtypes = [c.c_void_p]
    lib.nf_set_endpoint_ids.argtypes = [c.c_void_p, c.c_int64, u32p]
    lib.nf_load_lb.argtypes = [
        c.c_void_p, c.c_int, c.c_int32, c.c_int, u8p, i32p, i32p, i32p,
        i32p, i32p, c.c_int32, u8p, i32p,
    ]
    lib.nf_l7_set_http.argtypes = [
        c.c_void_p, c.c_uint32, c.c_uint32, c.c_uint8,
        i32p, u64p, c.c_int32, c.c_int32,  # method DFA
        i32p, u64p, c.c_int32, c.c_int32,  # path DFA
        i32p, u64p, c.c_int32, c.c_int32,  # host DFA
        c.c_int32, i32p, i32p, i32p, u8p, i64p, u64p,
    ]
    lib.nf_l7_set_kafka.argtypes = [
        c.c_void_p, c.c_uint32, c.c_uint32, c.c_uint8,
        c.c_int32, u32p, u8p, i32p, i32p, i32p, u8p, i64p, u64p,
        c.c_int32, u8p, i64p, c.c_int32, u8p, i64p,
    ]
    lib.nf_l7_http_batch.argtypes = [
        c.c_void_p, c.c_uint32, c.c_uint32, c.c_uint8, c.c_int64,
        u8p, c.c_int32, i32p, u8p, c.c_int32, i32p, u8p, c.c_int32, i32p,
        u64p, u8p,
    ]
    lib.nf_l7_kafka_batch.argtypes = [
        c.c_void_p, c.c_uint32, c.c_uint32, c.c_uint8, c.c_int64,
        i32p, i32p, u8p, c.c_int32, i32p, u8p, c.c_int32, i32p,
        u64p, u8p,
    ]
    lib.nf_eval_batch.argtypes = [
        c.c_void_p, c.c_int64, u8p, c.c_int, i32p, i32p, i32p, i32p,
        c.c_uint8, i8p, u8p,
    ]
    lib.nf_counters.argtypes = [c.c_void_p, i64p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False
