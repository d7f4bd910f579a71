"""Runs reference tests that build a ``Daemon`` through both packages.

A reference test module is rebuilt for each package from its own source
(``load``). For the port, every ``cilium_tpu`` name, in imports and in
module-path strings, names ``cilium_tpu_torch``, and every call of a
port constructor that takes ``device=`` (``Daemon``, ``PolicyEngine``,
``DatapathPipeline``) gets ``device="cpu"`` unless it names a device,
in the test's code and in the Python source it hands a child process
as a string. The port's CLI runs on the CPU too: ``--device cpu`` goes
before the argv of every in-process ``cli.main`` call and after
``-m cilium_tpu_torch[.cli]`` in every subprocess argv. A name the port
keeps elsewhere stays unbound, and the test classes that no case names
are left out. The JAX package's copy is rebuilt the same way, without
the renames, so both run the same code.

``run_case("test_cli_api.py::TestDaemon::test_policy_crud")`` runs one
test in each package, one after the other. Before each run the
package's process globals are reset: the option config, every metric,
the L7DeviceBatch gate, the probe cache and the fault hub; then the probe
set runs once, so ``status()`` reads its result in both. Fixtures are
resolved as pytest would: the module's and the class's own (autouse
ones included), ``tmp_path`` (one directory for each package) and
``monkeypatch`` (undone after the run). The port's device seam
(``placement.visible_devices``) gives 8 CPU records, as JAX's 8 virtual
CPU devices in the tests. During a run, what the test
reads back from the package is recorded: the result of every public
``Daemon`` method, every ``APIClient`` call and every pipeline batch
(``process`` / ``process_v6``) that the test's own thread makes, each
outside any other recorded call, and what the CLI printed, at each
``capsys.readouterr()`` (its standard output; JSON parsed). A result is normalised before it is
recorded: floats (times, rates), in strings too, become ``"<float>"``, the package's
temp directory ``"<tmp>"``, arrays and tensors lists, and the keys of
``VOLATILE`` (wall clocks, paths, thread-timed counters) are dropped.
The two records must be equal: every value compared is an integer, a
string or a bool, with tolerance 0.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import enum
import importlib
import inspect
import io
import json
import random
import re
import sys
import threading
import types
import uuid
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Tuple

import numpy as np
import pytest
import torch

from test_torch_harness import PKGS

TESTS = Path(__file__).resolve().parent
PORT = PKGS[1]

# constructors of the port that take device= (None = the card)
DEVICE_CALLS = {"Daemon", "PolicyEngine", "DatapathPipeline"}
# the same calls in Python source held in a string, without a device
_DEVICE_SRC = re.compile(r"\b(%s)\((?!\s*device=)" % "|".join(sorted(DEVICE_CALLS)))
# the port's CLI modules a child process runs with -m
_CLI_MODULES = (PORT, f"{PORT}.cli")
# keys whose values are wall clocks, host paths, thread timing or the
# machine's own names: left out of the record
VOLATILE = {
    "uptime", "ts", "timestamp", "wall_ts", "hlc", "time", "at", "since",
    "last", "last_seen", "last_success", "last_failure", "last-failure-msg",
    "success-count", "failure-count", "consecutive-failure-count",
    "controllers", "so", "error", "duration", "elapsed", "started",
    "updated", "created", "mtime", "age_s", "last_probe", "rtt_ms",
    "pid", "path", "socket",
}
# a decimal number, not a part of a dotted address
_FLOAT = re.compile(r"(?<![\d.])\d+\.\d+(e[-+]?\d+)?(?![\d.])")
# Daemon methods whose result is text or a blob with times in it: the
# test's own assertions read them, the record does not
UNRECORDED = {"shutdown", "metrics_text", "debuginfo", "traces", "profile",
              "metrics", "features", "fleet_status", "fleet_history",
              "health_report", "health_probe_now", "health"}


# -- loading ------------------------------------------------------------------------


def _cli_mains(body) -> Dict[str, bool]:
    """Names the statements ``body`` bind by import (not inside nested
    functions): True for the port CLI's ``main``, False for any other."""
    out: Dict[str, bool] = {}
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = node.module == f"{PORT}.cli" and a.name == "main"
        elif isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = False
        stack.extend(ast.iter_child_nodes(node))
    return out


class _DeviceCPU(ast.NodeTransformer):
    """The port's device and CLI on the CPU (see the module docstring)."""

    def __init__(self, module_names: Dict[str, bool]) -> None:
        self.scopes = [module_names]

    def _is_cli_main(self, name: str) -> bool:
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return False

    def visit_FunctionDef(self, node):
        self.scopes.append(_cli_mains(node.body))
        self.generic_visit(node)
        self.scopes.pop()
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None
        if name in DEVICE_CALLS and not any(k.arg in ("device", None) for k in node.keywords):
            node.keywords.append(ast.keyword(arg="device", value=ast.Constant("cpu")))
        if isinstance(f, ast.Name) and self._is_cli_main(f.id) and node.args:
            node.args[0] = ast.List(elts=[ast.Constant("--device"), ast.Constant("cpu"),
                                          ast.Starred(node.args[0], ast.Load())], ctx=ast.Load())
        return node

    def visit_List(self, node):
        self.generic_visit(node)
        for k in range(len(node.elts) - 1):
            a, b = node.elts[k], node.elts[k + 1]
            if (isinstance(a, ast.Constant) and a.value == "-m"
                    and isinstance(b, ast.Constant) and b.value in _CLI_MODULES):
                node.elts[k + 2:k + 2] = [ast.Constant("--device"), ast.Constant("cpu")]
                break
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str) and _DEVICE_SRC.search(node.value):
            return ast.Constant(_DEVICE_SRC.sub(r"\1(device='cpu', ", node.value))
        return node


_cache: Dict[Tuple[str, str, Tuple[str, ...]], types.ModuleType] = {}


def load(ref: str, pkg: str, classes: Iterable[str]) -> types.ModuleType:
    """Reference test module ``ref`` (``test_x.py``) rebuilt on ``pkg``,
    holding the named test classes and every helper."""
    classes = tuple(sorted(set(classes)))
    key = (ref, pkg, classes)
    if key in _cache:
        return _cache[key]
    src = (TESTS / ref).read_text()
    if pkg == PORT:
        src = re.sub(r"\bcilium_tpu\b", PORT, src)
    tree = ast.parse(src)
    body = []
    for node in tree.body:
        if (isinstance(node, ast.ClassDef) and node.name.startswith("Test")
                and node.name not in classes):
            continue
        if pkg == PORT and isinstance(node, ast.ImportFrom) and (node.module or "").startswith(PORT):
            # a name the port keeps elsewhere (or not at all) stays
            # unbound: a test that reads it fails on the NameError
            for a in node.names:
                body += ast.parse(f"try:\n    from {node.module} import {a.name}"
                                  f"{' as ' + a.asname if a.asname else ''}\n"
                                  "except ImportError:\n    pass\n").body
            continue
        body.append(node)
    tree.body = body
    if pkg == PORT:
        tree = _DeviceCPU(_cli_mains(tree.body)).visit(tree)
    ast.fix_missing_locations(tree)
    name = f"_bar_{pkg}_{ref[:-3]}"
    mod = types.ModuleType(name)
    mod.__file__ = str(TESTS / ref)
    sys.modules[name] = mod
    exec(compile(tree, f"<{pkg}:{ref}>", "exec"), mod.__dict__)
    _cache[key] = mod
    return mod


# -- process globals ----------------------------------------------------------------


def reset_globals(pkg: str) -> None:
    """The option config, the metrics, the L7DeviceBatch gate, the probe
    cache and the fault hub of ``pkg``, as a fresh process has them."""
    option = importlib.import_module(f"{pkg}.option")
    option.set_config(option.DaemonConfig())
    metrics = importlib.import_module(f"{pkg}.metrics")
    for m in list(metrics.registry._metrics.values()):
        with m._lock:
            if hasattr(m, "_values"):
                m._values.clear()
            else:
                m._series.clear()
    importlib.import_module(f"{pkg}.datapath.l7_pipeline")._reset_for_tests()
    importlib.import_module(f"{pkg}.probes").reset_cache()
    importlib.import_module(f"{pkg}.faults").hub.reset()


# -- recording ----------------------------------------------------------------------


class _Recorder:
    def __init__(self, tmp: str) -> None:
        self.tmp = tmp
        self.log: List = []
        self.depth = 0
        self.thread = threading.get_ident()

    def norm(self, v):
        if isinstance(v, bool) or v is None:
            return v
        if isinstance(v, enum.Enum):
            return self.norm(v.value)
        if isinstance(v, (int, np.integer)):
            return int(v)
        if isinstance(v, (float, np.floating)):
            return "<float>"
        if isinstance(v, str):
            return _FLOAT.sub("<float>", v.replace(self.tmp, "<tmp>"))
        if isinstance(v, bytes):
            return v.hex()
        if isinstance(v, torch.Tensor):
            return self.norm(v.detach().cpu().numpy())
        if isinstance(v, np.ndarray):
            return ["<float>"] * v.size if v.dtype.kind == "f" else v.tolist()
        if isinstance(v, dict):
            return {str(self.norm(k)): self.norm(x) for k, x in v.items() if k not in VOLATILE}
        if isinstance(v, (list, tuple)):
            return [self.norm(x) for x in v]
        if isinstance(v, (set, frozenset)):
            return sorted(map(repr, (self.norm(x) for x in v)))
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return self.norm({f.name: getattr(v, f.name) for f in dataclasses.fields(v)})
        return f"<{type(v).__name__}>"

    def wrap(self, fn, name):
        rec = self

        def recorded(*a, **kw):
            if threading.get_ident() != rec.thread or rec.depth:
                return fn(*a, **kw)
            rec.depth += 1
            try:
                out = fn(*a, **kw)
            except Exception as e:
                rec.log.append((name, "raised", type(e).__name__))
                raise
            finally:
                rec.depth -= 1
            rec.log.append((name, rec.norm(out)))
            return out

        return recorded


def _record(mp: pytest.MonkeyPatch, pkg: str, rec: _Recorder) -> None:
    daemon = importlib.import_module(f"{pkg}.daemon").Daemon
    for name, fn in list(vars(daemon).items()):
        if inspect.isfunction(fn) and not name.startswith("_") and name not in UNRECORDED:
            mp.setattr(daemon, name, rec.wrap(fn, f"Daemon.{name}"))
    client = importlib.import_module(f"{pkg}.api.client").APIClient
    for name, fn in list(vars(client).items()):
        if inspect.isfunction(fn) and not name.startswith("_") and name not in UNRECORDED | {
                "connect"}:
            mp.setattr(client, name, rec.wrap(fn, f"APIClient.{name}"))
    pipe = importlib.import_module(f"{pkg}.datapath.pipeline").DatapathPipeline
    for name in ("process", "process_v6"):
        mp.setattr(pipe, name, rec.wrap(vars(pipe)[name], f"DatapathPipeline.{name}"))


# -- fixtures -----------------------------------------------------------------------


class _Capsys:
    """pytest's ``capsys`` for one run: standard output and error are
    captured from the fixture's first use to the run's end, and every
    ``readouterr()`` records what was printed since the last one."""

    class Result(NamedTuple):
        out: str
        err: str

    def __init__(self, rec: "_Recorder", stack: contextlib.ExitStack) -> None:
        self.rec = rec
        self.out, self.err = io.StringIO(), io.StringIO()
        stack.enter_context(contextlib.redirect_stdout(self.out))
        stack.enter_context(contextlib.redirect_stderr(self.err))

    def readouterr(self) -> "_Capsys.Result":
        res = self.Result(self.out.getvalue(), self.err.getvalue())
        for buf in (self.out, self.err):
            buf.seek(0)
            buf.truncate()
        try:
            printed = json.loads(res.out)
        except ValueError:
            printed = res.out
        self.rec.log.append(("capsys.readouterr", self.rec.norm(printed)))
        return res


class _Fixtures:
    """Resolves a test's arguments the way pytest would, for one run."""

    def __init__(self, mod, cls, inst, tmp_path: Path, stack: contextlib.ExitStack,
                 rec: "_Recorder"):
        self.mod, self.cls, self.inst = mod, cls, inst
        self.tmp_path, self.stack, self.rec = tmp_path, stack, rec
        self.values: Dict[str, object] = {}

    def _definition(self, name: str):
        for scope in (vars(self.cls) if self.cls else {}, vars(self.mod)):
            f = scope.get(name)
            if hasattr(f, "_fixture_function"):
                return f
        return None

    def autouse(self) -> None:
        for scope in (vars(self.mod), vars(self.cls) if self.cls else {}):
            for name, f in list(scope.items()):
                if hasattr(f, "_fixture_function_marker") and f._fixture_function_marker.autouse:
                    self.get(name)

    def get(self, name: str):
        if name in self.values:
            return self.values[name]
        if name == "tmp_path":
            val = self.tmp_path
        elif name == "monkeypatch":
            mp = pytest.MonkeyPatch()
            self.stack.callback(mp.undo)
            val = mp
        elif name == "capsys":
            val = _Capsys(self.rec, self.stack)
        else:
            f = self._definition(name)
            if f is None:
                raise LookupError(f"fixture {name!r} is not supported by the bar runner")
            fn = f._fixture_function
            params = list(inspect.signature(fn).parameters)
            args = []
            if params and params[0] == "self":
                args.append(self.inst)
                params = params[1:]
            args += [self.get(p) for p in params]
            out = fn(*args)
            if inspect.isgenerator(out):
                val = next(out)
                self.stack.callback(lambda g=out: next(g, None))
            else:
                val = out
        self.values[name] = val
        return val


def _run_one(pkg: str, case: str, tmp_path: Path):
    ref, *names = case.split("::")
    classes = [names[0]] if len(names) == 2 else []
    mod = load(ref, pkg, classes)
    cls = getattr(mod, names[0]) if len(names) == 2 else None
    inst = cls() if cls else None
    fn = getattr(inst, names[-1]) if cls else getattr(mod, names[-1])
    # short paths: a test's unix sockets live under them
    tmp = tmp_path / str(PKGS.index(pkg))
    tmp.mkdir()
    reset_globals(pkg)
    # the boot probes done before the test: status()'s non-blocking
    # peek then reads the probe set's result, never "probing"
    importlib.import_module(f"{pkg}.probes").probe_features()
    rec = _Recorder(str(tmp))
    with contextlib.ExitStack() as stack:
        mp = pytest.MonkeyPatch()
        stack.callback(mp.undo)
        if pkg == PORT:
            # the device seam as JAX's 8 virtual CPU devices: placement
            # plans, their generations and the pipeline's mode agree
            place = importlib.import_module(f"{PORT}.datapath.placement")
            mp.setattr(place, "visible_devices", lambda: [
                place.DeviceRecord(i, 0, torch.device("cpu")) for i in range(8)])
        # container and sandbox names drawn from uuid4: the same in both
        rng = random.Random(0)
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
        _record(mp, pkg, rec)
        sets = _parameter_sets(fn)
        for k, params in enumerate(sets):
            with contextlib.ExitStack() as inner:
                sub = tmp / str(k) if len(sets) > 1 else tmp
                sub.mkdir(exist_ok=True)
                fx = _Fixtures(mod, cls, inst, sub, inner, rec)
                fx.values.update(params)
                fx.autouse()
                fn(*[fx.get(p) for p in inspect.signature(fn).parameters])
        mp.undo()
    reset_globals(pkg)
    return rec.log


def _parameter_sets(fn) -> List[Dict]:
    """Every argument set of the test's ``parametrize`` marks, in order
    (one empty set without them)."""
    sets: List[Dict] = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        rows = [v.values if hasattr(v, "values") and type(v).__name__ == "ParameterSet" else v
                for v in values]
        rows = [r if len(names) > 1 else (r,) for r in rows]
        sets = [{**s, **dict(zip(names, r))} for s in sets for r in rows]
    return sets


def cases(ref: str, classes: Iterable[str] = (), tests: Iterable[str] = ()) -> List[str]:
    """Case ids: every ``test_*`` of the named classes of reference
    module ``ref``, then the named ``Class::test`` / ``test`` ids."""
    tree = ast.parse((TESTS / ref).read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name in set(classes):
            out += [f"{ref}::{node.name}::{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")]
    return out + [f"{ref}::{t}" for t in tests]


def _polled(log: List, names) -> List:
    """``log`` with each run of consecutive calls of one name in
    ``names`` cut to its last: a wait that polls until a condition
    holds reads it a varying number of times, and ends on equal values."""
    out: List = []
    for e in log:
        if out and e[0] in names and out[-1][0] == e[0]:
            out[-1] = e
        else:
            out.append(e)
    return out


def run_case(case: str, tmp_path: Path, unrecorded: Iterable[str] = (),
             polled: Iterable[str] = ()) -> List:
    """Run reference test ``case`` in both packages; their records, but
    for the calls named in ``unrecorded`` (results that depend on thread
    timing), with the polls of the calls named in ``polled`` cut to
    their last reads, must be equal."""
    skip, polled = set(unrecorded), set(polled)
    logs = []
    for pkg in PKGS:
        log = _run_one(pkg, case, tmp_path)
        logs.append(_polled([e for e in log if e[0] not in skip], polled))
    a, b = logs
    for k, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"call {k} differs:\n{x}\n{y}"
    assert len(a) == len(b), (a[len(b):], b[len(a):])
    return a
