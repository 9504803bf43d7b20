"""pio-lint rules: the repo's documented hazard classes.

A copy of incubator_predictionio_tpu/analysis/rules.py (:1-1585), with
the same 23 rules, names, severities and messages. The one change: the
flight-recorder gateways that ``recorder-in-serve-path`` resolves are
the port's (``incubator_predictionio_tpu_torch.obs.recorder.get_recorder``
/ ``get_capture``; JAX :1257-1260). The path-suffix exemptions
(``obs/profile.py``, ``/utils/http.py``, ``/obs/controller.py``,
``obs/recorder.py``) match the port's identical relative paths.

The rules whose roots are JAX traces (``host-sync``, ``neg-gather``,
``probe-arity``, ``tracer-branch``, ``f64``, ``wallclock``,
``metric-in-trace``, ``host-gather-in-mesh``) find nothing in a package
that imports no JAX; they are kept as they are.

Rules are pure AST visitors over :class:`~.engine.Module`: nothing is
imported or executed, so the pass needs no device and cannot be confused
by import-time side effects.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from incubator_predictionio_tpu_torch.analysis.engine import (
    CONFIG_MODULE_RE,
    Finding,
    Module,
)


class Rule:
    name: str = ""
    severity: str = "warning"
    #: one-line hazard description for --list-rules and docs
    doc: str = ""

    def check(self, mod: Module) -> Iterator[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# 1. host syncs inside traced code
# ---------------------------------------------------------------------------

_HOST_SYNC_CALLS = {
    "jax.device_get",
    "numpy.asarray",
    "numpy.array",
}
_HOST_SYNC_ATTRS = {"block_until_ready", "item"}
#: builtin scalar coercions that force a device fetch when fed a traced
#: value — the per-sweep ``float(delta) < tol`` convergence-check
#: anti-pattern (the probe pattern fetches OUTSIDE the trace, once per
#: PIO_RETRAIN_PROBE_EVERY-sweep chunk; see ops/retrain.py)
_SCALAR_COERCIONS = {"float", "int", "bool"}
_JAX_VALUED_PREFIXES = ("jax.numpy.", "jax.lax.", "jax.ops.", "jax.nn.")


class HostSyncInTrace(Rule):
    name = "host-sync"
    severity = "error"
    doc = ("host-sync call (jax.device_get / .block_until_ready() / "
           "np.asarray / .item() / float()-on-a-traced-value) inside a "
           "jit/pjit/shard_map-traced function — inside a trace these "
           "operate on tracers, either raising TracerError or silently "
           "baking a device round-trip into every step; fetch outside "
           "the trace (e.g. the chunked convergence probe, "
           "ops/retrain.py)")

    def check(self, mod: Module) -> Iterator[Finding]:
        for root, statics in mod.traced_roots:
            params = _param_names(root) - statics
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                rname = mod.resolved(node.func)
                if rname in _HOST_SYNC_CALLS:
                    yield mod.finding(
                        self, node,
                        f"{rname}() inside traced function "
                        f"{_root_name(root)!r} — move the host sync "
                        "outside the trace")
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _HOST_SYNC_ATTRS
                        and rname not in _HOST_SYNC_CALLS):
                    yield mod.finding(
                        self, node,
                        f".{node.func.attr}() inside traced function "
                        f"{_root_name(root)!r} — move the host sync "
                        "outside the trace")
                elif (isinstance(node.func, ast.Name)
                        and node.func.id in _SCALAR_COERCIONS
                        and len(node.args) == 1
                        and _is_jax_valued(mod, node.args[0], params)):
                    yield mod.finding(
                        self, node,
                        f"{node.func.id}() on a traced value inside "
                        f"{_root_name(root)!r} — a per-step host sync "
                        "(or TracerError); fetch the scalar outside the "
                        "trace (chunked probe pattern)")


def _is_jax_valued(mod: Module, expr: ast.AST,
                   params: "Set[str]") -> bool:
    """Heuristic: the expression is (or contains) a jnp/lax call, or is a
    bare non-static traced parameter — the cases where a builtin scalar
    coercion must materialize a device value."""
    if isinstance(expr, ast.Name):
        return expr.id in params
    return any(
        isinstance(sub, ast.Call)
        and (mod.resolved(sub.func) or "").startswith(_JAX_VALUED_PREFIXES)
        for sub in ast.walk(expr))


def _root_name(root: ast.AST) -> str:
    return getattr(root, "name", "<lambda>")


# ---------------------------------------------------------------------------
# 2. negative-padding gather wraparound
# ---------------------------------------------------------------------------

_IDS_NAME_RE = re.compile(r"(?:^|_)ids?$")
_CLAMP_CALLS = {
    "jax.numpy.maximum", "jax.numpy.minimum", "jax.numpy.clip",
    "jax.numpy.where", "numpy.maximum", "numpy.minimum", "numpy.clip",
    "numpy.where", "jax.numpy.abs",
}


class NegativeGather(Rule):
    name = "neg-gather"
    severity = "warning"
    doc = ("fancy-index gather fed by an *_ids variable that can carry "
           "-1 padding: JAX/numpy wrap negative indices to the LAST row, "
           "so padding rows silently read real data (the ADVICE.md "
           "als.py:518 class) — clamp (jnp.maximum(ids, 0)) and mask "
           "(jnp.where(ids >= 0, ..., 0)) or record the downstream "
           "drop justification in the baseline")

    def check(self, mod: Module) -> Iterator[Finding]:
        # module-scope clamp assignments apply everywhere; function-scope
        # ones only inside their own function (chain) — a clamp in one
        # function must not blind the rule to a same-named raw id in
        # another (clamping is scope-local, not flow-sensitive)
        module_clamped: Set[str] = set()
        stack = list(mod.tree.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            _add_clamp_assign(mod, n, module_clamped)
            stack.extend(ast.iter_child_nodes(n))
        yield from self._visit(mod, mod.tree, frozenset(module_clamped))

    def _visit(self, mod: Module, node: ast.AST,
               clamped: "frozenset[str]") -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                local: Set[str] = set()
                for sub in ast.walk(child):
                    _add_clamp_assign(mod, sub, local)
                yield from self._visit(mod, child, clamped | local)
                continue
            finding = self._check_subscript(mod, child, clamped)
            if finding is not None:
                yield finding
            yield from self._visit(mod, child, clamped)

    def _check_subscript(self, mod: Module, node: ast.AST,
                         clamped: "frozenset[str]") -> Optional[Finding]:
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)):
            return None
        # x.at[ids] carries explicit out-of-bounds semantics
        # (mode="drop"/"fill") — the repo's scatter path
        if (isinstance(node.value, ast.Attribute)
                and node.value.attr == "at"):
            return None
        idx = node.slice
        if not (isinstance(idx, ast.Name)
                and _IDS_NAME_RE.search(idx.id)):
            return None
        if idx.id in clamped:
            return None
        return mod.finding(
            self, node,
            f"gather indexed by {idx.id!r} without a clamp/where "
            "guard — -1 padding ids wrap to the last row")


def _add_clamp_assign(mod: Module, node: ast.AST, into: Set[str]) -> None:
    """Record ``name = jnp.where/maximum/clip(...)``-style assignments."""
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and mod.resolved(node.value.func) in _CLAMP_CALLS):
        into.add(node.targets[0].id)


# ---------------------------------------------------------------------------
# 3. availability probes that skip operands production passes
# ---------------------------------------------------------------------------


class ProbeArity(Rule):
    name = "probe-arity"
    severity = "error"
    doc = ("a *_available() probe calls a kernel entry point without one "
           "of its optional array operands — the probe then green-lights "
           "a kernel whose production variant (extra BlockSpec / input "
           "spec) was never compiled on the real backend (the "
           "als_kernel_available/x0 class: interpret passes, Mosaic "
           "fails at the first real train step)")

    def check(self, mod: Module) -> Iterator[Finding]:
        defs = {
            n.name: n for n in ast.walk(mod.tree)
            if isinstance(n, ast.FunctionDef)
        }
        for probe in ast.walk(mod.tree):
            if not (isinstance(probe, ast.FunctionDef)
                    and probe.name.endswith("_available")):
                continue
            for call in ast.walk(probe):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)):
                    continue
                callee = defs.get(call.func.id)
                if callee is None:
                    continue
                missing = _unbound_optional_arrays(callee, call)
                for param in missing:
                    yield mod.finding(
                        self, call,
                        f"probe {probe.name!r} never passes the optional "
                        f"array operand {param!r} of {callee.name!r} — "
                        "the production variant's kernel is never "
                        "compiled by the probe")


def _unbound_optional_arrays(
    callee: ast.FunctionDef, call: ast.Call
) -> List[str]:
    """Optional[jax.Array]-annotated params of ``callee`` with default
    None that ``call`` binds neither positionally nor by keyword."""
    args = callee.args
    positional = args.posonlyargs + args.args
    defaults = args.defaults
    # map trailing defaults onto the positional tail
    default_by_name = {}
    for arg, default in zip(positional[len(positional) - len(defaults):],
                            defaults):
        default_by_name[arg.arg] = default
    for arg, default in zip(args.kwonlyargs, args.kw_defaults):
        if default is not None:
            default_by_name[arg.arg] = default

    optional_arrays = []
    for arg in positional + args.kwonlyargs:
        default = default_by_name.get(arg.arg)
        if not (isinstance(default, ast.Constant) and default.value is None):
            continue
        if "jax.Array" in _annotation_text(arg.annotation):
            optional_arrays.append(arg.arg)

    bound = {kw.arg for kw in call.keywords if kw.arg}
    if any(kw.arg is None for kw in call.keywords):  # **kwargs: assume bound
        return []
    n_pos = len(call.args)
    bound |= {a.arg for a in positional[:n_pos]}
    return [p for p in optional_arrays if p not in bound]


def _annotation_text(annotation: Optional[ast.AST]) -> str:
    if annotation is None:
        return ""
    if isinstance(annotation, ast.Constant) and isinstance(
            annotation.value, str):
        return annotation.value
    try:
        return ast.unparse(annotation)
    except Exception:
        return ""


# ---------------------------------------------------------------------------
# 4. Python control flow on tracer values
# ---------------------------------------------------------------------------

_TRACER_VALUED_PREFIXES = ("jax.numpy.", "jax.lax.", "jax.ops.", "jax.nn.")


class TracerBranch(Rule):
    name = "tracer-branch"
    severity = "error"
    doc = ("Python if/while on a tracer-valued expression inside a "
           "traced function — the branch is resolved ONCE at trace time "
           "(or raises TracerBoolConversionError); use jnp.where / "
           "lax.cond / lax.while_loop")

    def check(self, mod: Module) -> Iterator[Finding]:
        for root, statics in mod.traced_roots:
            params = _param_names(root) - statics
            for node in ast.walk(root):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                test = node.test
                if _is_none_check(test):
                    continue
                jnp_call = next(
                    (sub for sub in ast.walk(test)
                     if isinstance(sub, ast.Call)
                     and (mod.resolved(sub.func) or "").startswith(
                         _TRACER_VALUED_PREFIXES)),
                    None)
                bare_param = (isinstance(test, ast.Name)
                              and test.id in params)
                if jnp_call is not None:
                    yield mod.finding(
                        self, node,
                        f"`{ast.unparse(test)}` branches on a traced "
                        f"array inside {_root_name(root)!r} — use "
                        "jnp.where / lax.cond")
                elif bare_param:
                    yield mod.finding(
                        self, node,
                        f"branch on non-static parameter {test.id!r} "
                        f"inside traced function {_root_name(root)!r} — "
                        "mark it static or use lax.cond")


def _param_names(root: ast.AST) -> Set[str]:
    args = getattr(root, "args", None)
    if args is None:
        return set()
    return {a.arg for a in
            args.posonlyargs + args.args + args.kwonlyargs}


def _is_none_check(test: ast.AST) -> bool:
    return (isinstance(test, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot))
                    for op in test.ops))


# ---------------------------------------------------------------------------
# 5. os.environ reads at import time
# ---------------------------------------------------------------------------


class EnvReadAtImport(Rule):
    name = "env-import"
    severity = "warning"
    doc = ("os.environ read at module import time outside a config-style "
           "module — the knob freezes at first import, so runtime "
           "overrides (tests, bench sweeps, launcher re-exec) are "
           "silently ignored; read it in the consumer, or baseline it "
           "with the read-once justification")

    def check(self, mod: Module) -> Iterator[Finding]:
        if CONFIG_MODULE_RE.search(Path(mod.relpath).name):
            return
        seen_lines: Set[int] = set()
        for node in _import_time_nodes(mod.tree):
            rname = mod.resolved(node) if isinstance(
                node, (ast.Name, ast.Attribute)) else None
            if rname in ("os.environ", "os.getenv"):
                line = node.lineno
                if line not in seen_lines:
                    seen_lines.add(line)
                    yield mod.finding(
                        self, node,
                        "os.environ read at import time — the value "
                        "freezes before any runtime override")


def _import_time_nodes(tree: ast.Module) -> Iterator[ast.AST]:
    """Every AST node evaluated while the module is being imported:
    module/class bodies plus decorator lists, default argument values
    and annotations of function definitions — but NOT function/lambda
    bodies."""
    stack: List[ast.AST] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(d for d in node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        if isinstance(node, ast.Lambda):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# 6. float64 without enable_x64
# ---------------------------------------------------------------------------


class Float64WithoutX64(Rule):
    name = "f64"
    severity = "warning"
    doc = ("jnp.float64 / dtype='float64' requested without enable_x64 "
           "anywhere in the module — JAX silently downgrades to float32 "
           "unless jax.config.update('jax_enable_x64', True) ran, so "
           "the extra precision the code asks for never materializes")

    def check(self, mod: Module) -> Iterator[Finding]:
        if "enable_x64" in mod.source:
            return
        for node in ast.walk(mod.tree):
            if (isinstance(node, (ast.Attribute, ast.Name))
                    and mod.resolved(node) == "jax.numpy.float64"):
                yield mod.finding(
                    self, node,
                    "jnp.float64 without enable_x64 — silently float32")
            elif isinstance(node, ast.Call):
                rname = mod.resolved(node.func) or ""
                if not rname.startswith(("jax.", "jax.numpy.")):
                    continue
                for sub in list(node.args) + [
                        kw.value for kw in node.keywords]:
                    if (isinstance(sub, ast.Constant)
                            and sub.value == "float64"):
                        yield mod.finding(
                            self, sub,
                            f"dtype 'float64' passed to {rname} without "
                            "enable_x64 — silently float32")


# ---------------------------------------------------------------------------
# 7. wall clock inside traced code
# ---------------------------------------------------------------------------

_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}


class WallClockInTrace(Rule):
    name = "wallclock"
    severity = "warning"
    doc = ("time.time()/perf_counter()/datetime.now() inside a traced "
           "function — the value is captured ONCE at trace time and "
           "baked into the compiled program as a constant; take "
           "timestamps outside the jit boundary")

    def check(self, mod: Module) -> Iterator[Finding]:
        for root, _statics in mod.traced_roots:
            for node in ast.walk(root):
                if (isinstance(node, ast.Call)
                        and mod.resolved(node.func) in _WALLCLOCK_CALLS):
                    yield mod.finding(
                        self, node,
                        f"{mod.resolved(node.func)}() inside traced "
                        f"function {_root_name(root)!r} — trace-time "
                        "constant, not a per-step timestamp")


# ---------------------------------------------------------------------------
# 8. unlocked shared mutable state in async server handlers
# ---------------------------------------------------------------------------

_MUTATING_METHODS = {
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popleft", "popitem", "update", "setdefault", "clear",
}
_LOCK_NAME_RE = re.compile(r"lock", re.IGNORECASE)


class ServerUnlockedState(Rule):
    name = "server-state"
    severity = "warning"
    doc = ("read-modify-write of shared instance/module state from an "
           "async server handler without a lock — handlers interleave "
           "at every await (and the pool-dispatch ingest path runs them "
           "on threads), so counters and dicts mutated bare lose "
           "updates under load (servers/*.py only)")

    def check(self, mod: Module) -> Iterator[Finding]:
        if "/servers/" not in f"/{mod.relpath}":
            return
        seen: Set[Tuple[int, str]] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                for f in self._visit(mod, node.body, in_lock=False,
                                     fn=node.name):
                    # nested async defs are walked twice — dedupe
                    if (f.line, f.message) not in seen:
                        seen.add((f.line, f.message))
                        yield f

    def _visit(self, mod: Module, body: Sequence[ast.stmt],
               in_lock: bool, fn: str) -> Iterator[Finding]:
        for stmt in body:
            # nested defs get their own ast.walk root (async) or run in
            # an unknown context (sync) — descending here would report
            # their mutations twice under two handler names
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            locked = in_lock
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                ctx = " ".join(
                    ast.unparse(item.context_expr) for item in stmt.items)
                locked = in_lock or bool(_LOCK_NAME_RE.search(ctx))
            if not locked:
                yield from self._flag_mutations(mod, stmt, fn)
            for field in ("body", "orelse", "finalbody", "handlers"):
                sub = getattr(stmt, field, None)
                if not sub:
                    continue
                for child in sub:
                    child_body = (child.body
                                  if isinstance(child, ast.ExceptHandler)
                                  else [child])
                    yield from self._visit(mod, child_body, locked, fn)

    def _flag_mutations(self, mod: Module, stmt: ast.stmt,
                        fn: str) -> Iterator[Finding]:
        if isinstance(stmt, ast.AugAssign) and _is_shared_target(
                stmt.target):
            yield mod.finding(
                self, stmt,
                f"read-modify-write of shared state "
                f"`{ast.unparse(stmt.target)}` in async handler "
                f"{fn!r} without a lock")
        elif isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if (isinstance(tgt, ast.Subscript)
                        and _is_shared_target(tgt.value)):
                    yield mod.finding(
                        self, stmt,
                        f"item assignment to shared state "
                        f"`{ast.unparse(tgt)}` in async handler "
                        f"{fn!r} without a lock")
        elif isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Call):
            func = stmt.value.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in _MUTATING_METHODS
                    and _is_shared_target(func.value)):
                yield mod.finding(
                    self, stmt,
                    f"`{ast.unparse(func)}()` mutates shared state in "
                    f"async handler {fn!r} without a lock")


def _is_shared_target(node: ast.AST) -> bool:
    """self.<attr> (possibly nested, e.g. self.stats.counts)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


# ---------------------------------------------------------------------------
# 9. long-running native scans under the storage lock
# ---------------------------------------------------------------------------

#: the event-log scan entry points whose wall scales with the log size
#: (seconds at training scale). The native side snapshots under its own
#: short mutex, so nothing is gained — and every concurrent writer is
#: stalled — by holding a Python storage lock across them.
_NATIVE_SCAN_RE = re.compile(
    r"^(pio_evlog_scan\w*|_scan_native|_scan_sharded)$")


class LockNativeScan(Rule):
    name = "lock-native-scan"
    severity = "error"
    doc = ("long-running native scan entry point (pio_evlog_scan* / "
           "_scan_native / _scan_sharded) called inside a `with ...lock:` "
           "body — the scan snapshots consistently under its own short "
           "native mutex, so holding the Python storage lock across it "
           "stalls every concurrent event write for the whole scan "
           "(the ~13 s cpplog.scan_interactions class this repo fixed): "
           "snapshot counts under the lock, scan outside it, revalidate "
           "before publishing derived state")

    def check(self, mod: Module) -> Iterator[Finding]:
        seen: Set[Tuple[int, int]] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            ctx = " ".join(
                ast.unparse(item.context_expr) for item in node.items)
            if not _LOCK_NAME_RE.search(ctx):
                continue
            for call in self._calls_in_body(node):
                func = call.func
                cname = (func.attr if isinstance(func, ast.Attribute)
                         else func.id if isinstance(func, ast.Name)
                         else None)
                if cname is None or not _NATIVE_SCAN_RE.match(cname):
                    continue
                key = (call.lineno, call.col_offset)
                if key in seen:  # nested lock withs walk the call twice
                    continue
                seen.add(key)
                yield mod.finding(
                    self, call,
                    f"native scan {cname!r} called while holding "
                    f"`{ctx}` — scans snapshot under their own native "
                    "mutex; release the storage lock before scanning")

    @staticmethod
    def _calls_in_body(with_node: ast.AST) -> Iterator[ast.Call]:
        """Call nodes lexically under the with, excluding nested function
        bodies (a function *defined* under a lock is not *called* under
        it)."""
        stack: List[ast.AST] = list(
            ast.iter_child_nodes(with_node))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                yield n
            stack.extend(ast.iter_child_nodes(n))


# ---------------------------------------------------------------------------
# 10. metrics mutation inside traced code
# ---------------------------------------------------------------------------

#: obs-registry mutators (obs/metrics.py): Counter.inc / Gauge.inc/dec /
#: Histogram.observe. ``set`` is handled separately — ``x.at[i].set(v)``
#: is the JAX scatter idiom and must stay exempt.
_METRIC_MUTATORS = {"inc", "dec", "observe"}


class MetricInTrace(Rule):
    name = "metric-in-trace"
    severity = "error"
    doc = ("metrics-registry mutation (.inc()/.dec()/.observe()/metric "
           ".set()) inside a jit/pjit/shard_map/pallas_call-traced "
           "function — at trace time it books once and never again (a "
           "lying counter), and any host-callback variant would "
           "serialize the device per step; book metrics outside the "
           "trace boundary (obs/metrics.py's hot-path contract)")

    def check(self, mod: Module) -> Iterator[Finding]:
        for root, _statics in mod.traced_roots:
            for node in ast.walk(root):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                attr = node.func.attr
                if attr in _METRIC_MUTATORS or (
                        attr == "set"
                        and not _is_at_indexed(node.func.value)):
                    yield mod.finding(
                        self, node,
                        f".{attr}() metric mutation inside traced "
                        f"function {_root_name(root)!r} — book metrics "
                        "outside the trace boundary")


def _is_at_indexed(node: ast.AST) -> bool:
    """True for ``x.at[...]`` receivers (the JAX functional-update
    idiom ``x.at[i].set(v)``, including chained updates)."""
    return (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "at")


# ---------------------------------------------------------------------------
# 11. blocking storage reads on the serving hot path
# ---------------------------------------------------------------------------

#: EventStore read entry points whose wall scales with the event log —
#: a synchronous storage round trip per query is the latency class the
#: speed layer's TTL micro-cache (speed/cache.py) exists to remove
_EVENTSTORE_READS = {
    "find", "find_by_entity", "aggregate_properties", "interactions",
    "extract_entity_map",
}
_SERVE_ENTRY_POINTS = {"predict", "batch_predict", "batch_serve_json"}


class ServeBlockingIO(Rule):
    name = "serve-blocking-io"
    severity = "warning"
    doc = ("direct EventStore read (find/find_by_entity/"
           "aggregate_properties/...) reachable from a predict() hot "
           "path — a synchronous storage round trip per query; route it "
           "through the bounded TTL micro-cache (speed/cache.py "
           "TTLCache, invalidated by the speed-layer cursor) and record "
           "the cache-miss loader in the baseline")

    def check(self, mod: Module) -> Iterator[Finding]:
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            # intra-class call graph over self.<method>() edges —
            # ast.walk covers lambdas/closures, so a loader passed to a
            # cache helper still counts as reachable (its read then
            # carries a baseline justification)
            edges: dict = {}
            for name, fn in methods.items():
                callees = set()
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "self"
                            and node.func.attr in methods):
                        callees.add(node.func.attr)
                edges[name] = callees
            reachable: Set[str] = set()
            stack = [m for m in _SERVE_ENTRY_POINTS if m in methods]
            while stack:
                m = stack.pop()
                if m in reachable:
                    continue
                reachable.add(m)
                stack.extend(edges.get(m, ()))
            for name in sorted(reachable):
                for node in ast.walk(methods[name]):
                    if not (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr in _EVENTSTORE_READS):
                        continue
                    base = mod.resolved(node.func.value) or ""
                    if base != "EventStore" and not base.endswith(
                            ".EventStore"):
                        continue
                    yield mod.finding(
                        self, node,
                        f"EventStore.{node.func.attr}() reachable from "
                        f"the serving hot path (via {name!r}) — a "
                        "storage round trip per query; front it with "
                        "the TTL micro-cache (speed/cache.py)")


# ---------------------------------------------------------------------------
# 12. blocking profiler calls on the serving hot path
# ---------------------------------------------------------------------------

#: profiler-capture entry points — each one either serializes the device
#: (block_until_ready per query) or starts a process-wide trace capture;
#: both are catastrophic inside a predict path that is supposed to
#: pipeline dispatches
_PROFILER_CAPTURE_CALLS = {
    "jax.block_until_ready",
    "jax.profiler.start_trace",
    "jax.profiler.stop_trace",
    "jax.profiler.trace",
    "jax.profiler.start_server",
    "jax.profiler.TraceAnnotation",
}


class BlockingProfiler(Rule):
    name = "blocking-profiler"
    severity = "error"
    doc = ("block_until_ready / jax.profiler capture call reachable "
           "from a predict/batch_predict/batch_serve_json hot path — "
           "each query then synchronizes (or trace-captures) the whole "
           "device instead of pipelining dispatches; route device-wall "
           "attribution through obs/profile.py (profile.t0()/record(), "
           "gated on PIO_PROFILE and exempt from this rule)")

    def check(self, mod: Module) -> Iterator[Finding]:
        # obs/profile.py IS the sanctioned guard: its record() exists so
        # nobody else ever writes a bare block_until_ready on a serve
        # path, and its own block is env-gated
        path = str(mod.path).replace("\\", "/")
        if path.endswith("obs/profile.py"):
            return
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            edges: dict = {}
            for name, fn in methods.items():
                callees = set()
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "self"
                            and node.func.attr in methods):
                        callees.add(node.func.attr)
                edges[name] = callees
            reachable: Set[str] = set()
            stack = [m for m in _SERVE_ENTRY_POINTS if m in methods]
            while stack:
                m = stack.pop()
                if m in reachable:
                    continue
                reachable.add(m)
                stack.extend(edges.get(m, ()))
            for name in sorted(reachable):
                for node in ast.walk(methods[name]):
                    if not isinstance(node, ast.Call):
                        continue
                    rname = mod.resolved(node.func) or ""
                    blocking = rname in _PROFILER_CAPTURE_CALLS or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "block_until_ready")
                    if not blocking:
                        continue
                    what = (f"{rname}()" if rname
                            else f".{node.func.attr}()")
                    yield mod.finding(
                        self, node,
                        f"{what} reachable from the serving hot path "
                        f"(via {name!r}) — a device sync/capture per "
                        "query; use obs/profile.py's gated "
                        "t0()/record() instead")


# ---------------------------------------------------------------------------
# 13. host gathers inside an active mesh context
# ---------------------------------------------------------------------------

#: `with mesh:` / `with Mesh(...):` / `with placement.mesh:` context
#: expressions — the lexical scope in which factor tables and sweep
#: outputs are mesh-distributed
_MESH_CTX_RE = re.compile(r"(?i)(^|[^\w])mesh\b|[^\w]Mesh\(|^Mesh\(")
_HOST_GATHER_CALLS = {"jax.device_get", "numpy.asarray", "numpy.array"}
_HOST_GATHER_ATTRS = {"tolist", "item"}


class HostGatherInMesh(Rule):
    name = "host-gather-in-mesh"
    severity = "error"
    doc = ("jax.device_get / np.asarray / .tolist() / .item() on a "
           "value inside an active mesh context (`with mesh:` body) — "
           "on mesh-sharded values each fetch is a cross-device "
           "gather + host round trip in the middle of the training "
           "loop, exactly the anti-pattern the sharded ALS sweep "
           "forbids (ROADMAP item 1: no host round-trips between "
           "dispatches); keep the loop device-side and fetch once "
           "after the mesh context closes (obs/profile.py's gated "
           "attribution is the one sanctioned exception)")

    def check(self, mod: Module) -> Iterator[Finding]:
        # obs/profile.py is the sanctioned sync point: its record() is
        # env-gated and a wall measurement IS a host sync
        path = str(mod.path).replace("\\", "/")
        if path.endswith("obs/profile.py"):
            return
        seen: Set[Tuple[int, int]] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            ctx = " ".join(
                ast.unparse(item.context_expr) for item in node.items)
            if not _MESH_CTX_RE.search(ctx):
                continue
            # reuse the lock rule's body walk: nested function DEFS are
            # exempt (host-sync already covers shard_map-traced bodies)
            for call in LockNativeScan._calls_in_body(node):
                rname = mod.resolved(call.func)
                if rname in _HOST_GATHER_CALLS:
                    what = f"{rname}()"
                elif (isinstance(call.func, ast.Attribute)
                        and call.func.attr in _HOST_GATHER_ATTRS
                        and rname not in _HOST_GATHER_CALLS):
                    what = f".{call.func.attr}()"
                else:
                    continue
                key = (call.lineno, call.col_offset)
                if key in seen:  # nested mesh withs walk the call twice
                    continue
                seen.add(key)
                yield mod.finding(
                    self, call,
                    f"{what} inside active mesh context `{ctx}` — a "
                    "cross-shard gather + host round trip mid-loop; "
                    "fetch after the mesh context closes")


# ---------------------------------------------------------------------------
# 14. unbounded metric label values
# ---------------------------------------------------------------------------

#: value names that smell like per-entity/per-request data — one time
#: series per distinct value, which is how a registry (and every scraper
#: behind it) OOMs. Terminal name of the expression (Name id / Attribute
#: attr) is matched; bounded-set names (route patterns, status codes,
#: phases, modes) deliberately absent.
_UNBOUNDED_LABEL_NAME_RE = re.compile(
    r"(?:^|_)(id|ids|uuid|guid|key|token|path|url|uri|query|entity|"
    r"user|item|session|trace|span|instance|host|hostname|addr|"
    r"address|exc|exception|err|error|message|detail)s?$",
    re.IGNORECASE)


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class MetricLabelCardinality(Rule):
    name = "metric-label-cardinality"
    severity = "error"
    doc = ("unbounded value (id / raw path / exception string / "
           "interpolated f-string) used as a metric label value in a "
           "``.labels(...)`` call — every distinct value mints a new "
           "time series, so wire-derived label values grow the registry "
           "(and every scrape) without bound until the process OOMs; "
           "label values must come from BOUNDED sets (route PATTERNS, "
           "status codes, enum/phase names — obs/metrics.py's "
           "cardinality contract), or carry a boundedness justification "
           "in the baseline")

    def check(self, mod: Module) -> Iterator[Finding]:
        exc_names: Set[str] = {
            h.name for h in ast.walk(mod.tree)
            if isinstance(h, ast.ExceptHandler) and h.name
        }
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"):
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue  # **kwargs: opaque, other rules' problem
                reason = self._unbounded(kw.value, exc_names)
                if reason:
                    yield mod.finding(
                        self, kw.value,
                        f"label {kw.arg!r} value {reason} — one time "
                        "series per distinct value; use a bounded set "
                        "(pattern/code/enum), bucket the value, or "
                        "baseline it with a boundedness justification")

    def _unbounded(self, v: ast.AST,
                   exc_names: "Set[str]") -> Optional[str]:
        if isinstance(v, ast.JoinedStr) and any(
                isinstance(x, ast.FormattedValue) for x in v.values):
            return "is an interpolated f-string"
        if isinstance(v, ast.BinOp) and isinstance(
                v.op, (ast.Add, ast.Mod)) and not (
                isinstance(v.left, ast.Constant)
                and isinstance(v.right, ast.Constant)):
            return "is built by string concatenation/%-formatting"
        if isinstance(v, ast.Call):
            f = v.func
            if isinstance(f, ast.Attribute) and f.attr == "format":
                return "is built by .format()"
            if (isinstance(f, ast.Name) and f.id in ("str", "repr")
                    and len(v.args) == 1):
                arg = v.args[0]
                if (isinstance(arg, ast.Name) and arg.id in exc_names):
                    return (f"stringifies caught exception "
                            f"{ast.unparse(arg)!r}")
                nm = _terminal_name(arg)
                if nm and _UNBOUNDED_LABEL_NAME_RE.search(nm):
                    return f"stringifies {ast.unparse(arg)!r}"
            return None
        if isinstance(v, ast.Name) and v.id in exc_names:
            return f"is the caught exception {v.id!r}"
        nm = _terminal_name(v)
        if nm and _UNBOUNDED_LABEL_NAME_RE.search(nm):
            try:
                text = ast.unparse(v)
            except Exception:
                text = nm
            return f"reads {text!r} (unbounded-looking name)"
        return None


# ---------------------------------------------------------------------------
# 15. unbatched device dispatch from server modules
# ---------------------------------------------------------------------------

#: device-dispatch entry points the serving scheduler exists to front:
#: direct top-k/fold-in calls from a server module bypass the queue →
#: ladder → shed plane entirely
_DISPATCH_ENTRY_POINTS = {
    "score_and_top_k", "score_user_and_top_k", "batch_score_top_k",
    "sharded_top_k", "top_k_with_exclusions", "FoldInSolver",
    "als_fused_solve_cg_pallas", "score_and_top_k_pallas",
}
#: algorithm methods that reach the device — sanctioned ONLY from the
#: scheduler's handle_batch callback (whose calls carry baseline
#: justifications) and the deploy-time warmup cold path
_DISPATCH_METHODS = {"predict", "batch_predict", "batch_serve_json",
                     "warmup"}


class UnbatchedDispatch(Rule):
    name = "unbatched-dispatch"
    severity = "warning"
    doc = ("direct solver/top-k device dispatch (ops/topk entries, "
           "FoldInSolver, or an algorithm predict/batch_predict/"
           "batch_serve_json/warmup call) in a server module "
           "(servers/*.py) — query-path device work must route through "
           "the continuous-batching scheduler seam "
           "(serving/scheduler.py) so queue-depth coalescing and SLO "
           "shedding apply; the scheduler's own handle_batch callback "
           "and deploy-time warmup are the sanctioned baseline-"
           "justified exceptions")

    def check(self, mod: Module) -> Iterator[Finding]:
        if "/servers/" not in f"/{mod.relpath}":
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            rname = mod.resolved(node.func) or ""
            tail = rname.rsplit(".", 1)[-1] if rname else ""
            attr = (node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else (node.func.id
                          if isinstance(node.func, ast.Name) else ""))
            if tail in _DISPATCH_ENTRY_POINTS \
                    or attr in _DISPATCH_ENTRY_POINTS:
                what = rname or attr
                yield mod.finding(
                    self, node,
                    f"direct device dispatch `{what}()` in a server "
                    "module bypasses the continuous-batching scheduler "
                    "seam (serving/scheduler.py) — no queue coalescing, "
                    "no shed policy")
            elif attr in _DISPATCH_METHODS and isinstance(
                    node.func, ast.Attribute):
                yield mod.finding(
                    self, node,
                    f"device-dispatching `{attr}()` call in a server "
                    "module outside the scheduler seam — route query "
                    "work through BatchScheduler.submit (the scheduler's "
                    "handle_batch callback and deploy warmup belong in "
                    "the baseline)")


# ---------------------------------------------------------------------------
# 16. exhaustive full-table scans that bypass the MIPS auto-router
# ---------------------------------------------------------------------------

#: scoring entries BELOW the auto-router seam: calling one of these
#: directly pins the query to the exhaustive full-table scan even when
#: a two-stage MIPS index is registered (ops/mips.py). The public
#: routers (score_and_top_k / score_user_and_top_k / batch_score_top_k)
#: are the sanctioned entries — they fall back to exhaustive themselves
#: when the index/mode says so.
_EXHAUSTIVE_BYPASS = {
    "_score_and_top_k_xla", "_score_user_top_k_xla",
    "_batch_score_top_k_xla", "score_and_top_k_pallas",
    "sharded_top_k", "top_k_with_exclusions",
}


class ExhaustiveScan(Rule):
    name = "exhaustive-scan"
    severity = "warning"
    doc = ("direct full-table scoring call in a server/serving module "
           "(servers/*.py, serving/*.py) below the MIPS auto-router "
           "seam — sharded_top_k / top_k_with_exclusions / the private "
           "XLA+Pallas scoring entries, or a raw jax.lax.top_k over "
           "catalogue scores. These pin the query to the exhaustive "
           "scan even when a registered two-stage index (ops/mips.py) "
           "could serve it at a fraction of the device wall; route "
           "through score_and_top_k / score_user_and_top_k / "
           "batch_score_top_k, which auto-route and keep exhaustive as "
           "the fallback")

    def check(self, mod: Module) -> Iterator[Finding]:
        rel = f"/{mod.relpath}"
        if "/servers/" not in rel and "/serving/" not in rel:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            rname = mod.resolved(node.func) or ""
            tail = rname.rsplit(".", 1)[-1] if rname else ""
            attr = (node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else (node.func.id
                          if isinstance(node.func, ast.Name) else ""))
            if tail in _EXHAUSTIVE_BYPASS or attr in _EXHAUSTIVE_BYPASS:
                what = rname or attr
                yield mod.finding(
                    self, node,
                    f"`{what}()` scores the FULL catalogue from a "
                    "server/serving module, bypassing the MIPS "
                    "auto-router — use the ops/topk router entries so "
                    "a registered two-stage index can serve the query")
            elif rname == "jax.lax.top_k":
                yield mod.finding(
                    self, node,
                    "raw `jax.lax.top_k()` in a server/serving module "
                    "— full-score ranking belongs behind the ops/topk "
                    "auto-routers (exhaustive stays their fallback)")


# ---------------------------------------------------------------------------
# 17. ad-hoc retry loops outside the shared RetryPolicy
# ---------------------------------------------------------------------------


class UnboundedRetry(Rule):
    name = "unbounded-retry"
    severity = "warning"
    doc = ("retry loop swallowing exceptions with a bare fixed-delay "
           "time.sleep (no backoff, no deadline) outside utils/http.py "
           "— fixed delays herd every client back onto a struggling "
           "server in lockstep and the loop never gives up; route "
           "client retries through utils/http.RetryPolicy (jittered "
           "exponential backoff under an overall deadline, Retry-After "
           "honored, idempotent-only by default)")

    def check(self, mod: Module) -> Iterator[Finding]:
        rel = f"/{mod.relpath}".replace("\\", "/")
        if rel.endswith("/utils/http.py"):  # RetryPolicy's own home
            return
        seen: Set[Tuple[int, int]] = set()
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.While, ast.For)):
                continue
            # a retry loop = a loop that both swallows a failure (an
            # except handler in its own body) and sleeps a CONSTANT
            # delay anywhere in that body. Computed delays (backoff
            # expressions) and sleeps outside failure loops stay silent
            # — this is a drift detector, not a sleep ban.
            if not any(isinstance(n, ast.ExceptHandler)
                       for n in self._body_nodes(loop)):
                continue
            for call in self._body_nodes(loop):
                if not (isinstance(call, ast.Call)
                        and mod.resolved(call.func) == "time.sleep"
                        and len(call.args) == 1
                        and isinstance(call.args[0], ast.Constant)):
                    continue
                key = (call.lineno, call.col_offset)
                if key in seen:  # nested loops walk the call twice
                    continue
                seen.add(key)
                yield mod.finding(
                    self, call,
                    "fixed-delay time.sleep() in a retry loop — no "
                    "backoff, no deadline, no jitter; use "
                    "utils/http.RetryPolicy")

    @staticmethod
    def _body_nodes(loop: ast.AST) -> Iterator[ast.AST]:
        """Nodes lexically inside the loop body, excluding nested
        function bodies (a function DEFINED in a loop is not the loop
        retrying) and the loop's else clause."""
        stack: List[ast.AST] = list(loop.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))


# ---------------------------------------------------------------------------
# 18. fleet actuation outside the decision-record emitter
# ---------------------------------------------------------------------------

#: the retrain/reload actuator surface reachable from the freshness
#: controller: the workflow's training entry, the front door's rolling
#: reload, and the controller's own injected actuator callables
_ACTUATION_CALLS = {
    "run_train", "rolling_reload", "rolling_reload_async",
    "retrain_fn", "reload_fn", "_retrain_fn", "_reload_fn",
}


class UnauditedActuation(Rule):
    name = "unaudited-actuation"
    severity = "error"
    doc = ("call into a retrain/reload actuator (CoreWorkflow."
           "run_train, FrontDoor.rolling_reload, or the controller's "
           "injected retrain_fn/reload_fn callables) from "
           "obs/controller.py OUTSIDE the decision-record emitter — "
           "every fleet actuation must flow through "
           "FreshnessController._actuate, which runs it inside the "
           "decision's trace context and writes the outcome into the "
           "audit ring; an actuation anywhere else is a fleet mutation "
           "nothing audited (actuator FACTORIES — functions named "
           "*_fn building the callables the emitter later invokes — "
           "are the sanctioned construction sites)")

    def check(self, mod: Module) -> Iterator[Finding]:
        rel = f"/{mod.relpath}".replace("\\", "/")
        if not rel.endswith("/obs/controller.py"):
            return
        # map every call to its enclosing function-def stack
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            attr = (node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else (node.func.id
                          if isinstance(node.func, ast.Name) else ""))
            rname = mod.resolved(node.func) or ""
            tail = rname.rsplit(".", 1)[-1] if rname else ""
            if attr not in _ACTUATION_CALLS \
                    and tail not in _ACTUATION_CALLS:
                continue
            # sanctioned scopes: the emitter itself (_actuate, nested
            # defs included) and actuator factories (*_fn) whose
            # closures the emitter invokes later
            sanctioned = False
            cur = parents.get(node)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    if cur.name == "_actuate" \
                            or cur.name.endswith("_fn"):
                        sanctioned = True
                        break
                cur = parents.get(cur)
            if sanctioned:
                continue
            what = rname or attr
            yield mod.finding(
                self, node,
                f"actuator call `{what}()` outside the decision-record "
                "emitter — route fleet retrain/reload through "
                "FreshnessController._actuate so the action lands in "
                "the audit ring under its decision's trace ID")


# ---------------------------------------------------------------------------
# 19. flight-recorder snapshot/capture on the serving hot path
# ---------------------------------------------------------------------------

#: recorder snapshot/capture entry points (obs/recorder.py): each one
#: walks the whole registry (sample_now), replays the delta ring
#: (dump), or writes a multi-worker JSON bundle to disk (capture_now) —
#: milliseconds-to-seconds of work that must only ever run on the
#: recorder/capture module's OWN threads and the admin/debug HTTP
#: executor, never where a query dispatch can reach it
_RECORDER_CAPTURE_ATTRS = {"sample_now", "capture_now"}
_RECORDER_GATEWAYS = {
    "incubator_predictionio_tpu_torch.obs.recorder.get_recorder",
    "incubator_predictionio_tpu_torch.obs.recorder.get_capture",
}
#: serve-path roots for this rule: the predict-family entries the other
#: serve rules guard PLUS the scheduler's admission/dispatch methods
#: (serving/scheduler.py) — incident capture must never block serving
_RECORDER_SERVE_ENTRY_POINTS = _SERVE_ENTRY_POINTS | {
    "submit", "_run", "_handle_batch", "handle_batch",
}


class RecorderInServePath(Rule):
    name = "recorder-in-serve-path"
    severity = "error"
    doc = ("flight-recorder snapshot/capture call (sample_now / "
           "capture_now / a get_recorder()/get_capture() gateway) "
           "reachable from a predict/batch_predict/scheduler-dispatch "
           "path outside obs/recorder.py — a registry walk, ring "
           "replay or bundle write inline with a query dispatch stalls "
           "serving exactly when an incident fires; the serve path's "
           "only sanctioned recorder exposure is the exemplar "
           "reservoir inside Histogram.observe(), everything else runs "
           "on the recorder's own sampler/capture threads "
           "(IncidentCapture.trigger() is the non-blocking hook)")

    def check(self, mod: Module) -> Iterator[Finding]:
        # obs/recorder.py owns the sampler/capture threads these calls
        # are FOR
        path = str(mod.path).replace("\\", "/")
        if path.endswith("obs/recorder.py"):
            return
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            edges: dict = {}
            for name, fn in methods.items():
                callees = set()
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "self"
                            and node.func.attr in methods):
                        callees.add(node.func.attr)
                edges[name] = callees
            reachable: Set[str] = set()
            stack = [m for m in _RECORDER_SERVE_ENTRY_POINTS
                     if m in methods]
            while stack:
                m = stack.pop()
                if m in reachable:
                    continue
                reachable.add(m)
                stack.extend(edges.get(m, ()))
            for name in sorted(reachable):
                for node in ast.walk(methods[name]):
                    if not isinstance(node, ast.Call):
                        continue
                    rname = mod.resolved(node.func) or ""
                    hit = rname in _RECORDER_GATEWAYS or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr in _RECORDER_CAPTURE_ATTRS)
                    if not hit:
                        continue
                    what = (f"{rname}()" if rname
                            else f".{node.func.attr}()")
                    yield mod.finding(
                        self, node,
                        f"{what} reachable from the serving/dispatch "
                        f"hot path (via {name!r}) — recorder snapshots "
                        "and incident captures run on obs/recorder.py's "
                        "own threads; from a serve path use the "
                        "non-blocking IncidentCapture.trigger() hook "
                        "(or nothing: the sampler already records)")


# ---------------------------------------------------------------------------
# 20. serving-knob mutation outside the audited apply seam
# ---------------------------------------------------------------------------

#: the registered serving-knob env surface — a LITERAL copy of
#: obs/knobs.KNOB_ENV_VARS (rules must not import runtime modules;
#: tests/test_knobs.py pins the two sets equal so they cannot drift)
_KNOB_ENV_VARS = {
    "PIO_SERVE_MIPS_NPROBE",
    "PIO_SERVE_MIPS_CANDIDATES",
    "PIO_SERVE_MAX_BATCH",
    "PIO_SERVE_MAX_WAIT_MS",
    "PIO_SERVE_SHED",
    "PIO_SPEED_MAX_BATCH",
    "PIO_SERVE_MIPS_PQ_M",
    "PIO_SERVE_MIPS_PQ_CANDIDATES",
    "PIO_MIPS_REBUILD_TAIL",
    "PIO_MIPS_REBUILD_AGE_S",
}
#: knob-backed scheduler fields (serving/scheduler.py) — assigning them
#: on ANOTHER object's scheduler bypasses both the env seam and
#: apply_knobs()'s lock; writes on `self` are the scheduler's own
_KNOB_SCHED_FIELDS = {"cap", "max_batch", "wait_bound_s", "_shed"}
#: sanctioned writer scopes: the knob controller's single audited seam
#: (KnobController._apply), the worker/front-door /knobs handlers
#: (both deliberately named post_knobs), and actuator factories (*_fn)
_KNOB_SANCTIONED_DEFS = ("_apply", "post_knobs")


class UnauditedKnobWrite(Rule):
    name = "unaudited-knob-write"
    severity = "error"
    doc = ("mutation of a registered serving knob (a PIO_SERVE_*/"
           "PIO_SPEED_MAX_BATCH env write via os.environ assignment/"
           "setdefault/putenv, or a knob-backed scheduler field poked "
           "on another object) outside the audited apply seam — every "
           "knob change must flow through KnobController._apply or the "
           "POST /knobs route handlers (post_knobs), which run it "
           "inside a knob.decision trace and record it in the audit "
           "ring; a knob write anywhere else is a serving-behavior "
           "mutation nothing audited and incident rollback cannot "
           "undo (actuator factories — *_fn functions building the "
           "callables _apply later invokes — are the sanctioned "
           "construction sites)")

    @staticmethod
    def _is_os_environ(mod: Module, expr: ast.AST) -> bool:
        if (isinstance(expr, ast.Attribute) and expr.attr == "environ"
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "os"):
            return True
        rname = mod.resolved(expr) or ""
        return rname == "os.environ" or rname.endswith(".os.environ")

    @staticmethod
    def _literal_knob(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Index):  # py<3.9 slice wrapper
            expr = expr.value
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str) \
                and expr.value in _KNOB_ENV_VARS:
            return expr.value
        return None

    def check(self, mod: Module) -> Iterator[Finding]:
        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

        def sanctioned(node: ast.AST) -> bool:
            cur = parents.get(node)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    if cur.name in _KNOB_SANCTIONED_DEFS \
                            or cur.name.endswith("_fn"):
                        return True
                cur = parents.get(cur)
            return False

        for node in ast.walk(mod.tree):
            hit: Optional[str] = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and self._is_os_environ(mod, t.value):
                        env = self._literal_knob(t.slice)
                        if env:
                            hit = (f"os.environ[{env!r}] write")
                    elif isinstance(t, ast.Attribute) \
                            and t.attr in _KNOB_SCHED_FIELDS \
                            and not (isinstance(t.value, ast.Name)
                                     and t.value.id == "self"):
                        hit = (f"scheduler knob field `.{t.attr}` "
                               "assigned on another object")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.args:
                env = self._literal_knob(node.args[0])
                if env and node.func.attr == "setdefault" \
                        and self._is_os_environ(mod, node.func.value):
                    hit = f"os.environ.setdefault({env!r}, ...)"
                elif env and node.func.attr == "putenv":
                    hit = f"os.putenv({env!r}, ...)"
            if hit is None or sanctioned(node):
                continue
            yield mod.finding(
                self, node,
                f"{hit} outside the audited knob seam — route serving-"
                "knob changes through KnobController._apply or the "
                "POST /knobs handlers (post_knobs) so the change lands "
                "in the audit ring under a knob.decision trace and "
                "incident rollback can restore the last-known-good "
                "vector")


# ---------------------------------------------------------------------------
# 21. tenant-attributable serving metrics booked without a bounded
#     tenant label
# ---------------------------------------------------------------------------

#: the serving-plane metric families the multi-tenant platform
#: attributes per tenant (serving/tenancy.py) — booking one of these
#: without a ``tenant`` label silently merges every tenant's traffic
#: into one series, and booking it with a WIRE value (raw accessKey,
#: raw tenant parameter) mints unbounded series
_TENANT_SCOPED_METRICS = {
    "pio_query_latency_seconds",
    "pio_serve_shed_total",
    "pio_serve_queue_depth",
}
#: registry constructor attributes whose first argument names the family
_METRIC_CTOR_ATTRS = {"histogram", "counter", "gauge"}


class UnscopedTenantMetric(Rule):
    name = "unscoped-tenant-metric"
    severity = "error"
    doc = ("serving-path ``.labels(...)`` call on a tenant-attributable "
           "metric family (pio_query_latency_seconds / "
           "pio_serve_shed_total / pio_serve_queue_depth) without a "
           "``tenant=`` label, or with a tenant value that is not a "
           "string literal or a bounded-registry ``.label(...)`` "
           "gateway call — an unlabeled booking merges every tenant's "
           "traffic into one series (per-tenant SLOs and the "
           "noisy-neighbor evidence go blind), and a raw wire value "
           "(the request's tenant/accessKey) mints one series per "
           "distinct value; route every tenant label through "
           "TenantRegistry.label(), which maps unknown ids to the "
           "bounded 'default' child")

    def check(self, mod: Module) -> Iterator[Finding]:
        path = str(mod.path).replace("\\", "/")
        if "/serving/" not in path and "/servers/" not in path:
            return
        # module-level bindings of the scoped families: NAME =
        # REGISTRY.histogram("pio_query_latency_seconds", ...)
        scoped: Set[str] = set()
        for stmt in mod.tree.body:
            if not (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)
                    and isinstance(stmt.value.func, ast.Attribute)
                    and stmt.value.func.attr in _METRIC_CTOR_ATTRS
                    and stmt.value.args
                    and isinstance(stmt.value.args[0], ast.Constant)
                    and stmt.value.args[0].value
                    in _TENANT_SCOPED_METRICS):
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    scoped.add(tgt.id)
        if not scoped:
            return
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in scoped):
                continue
            family = node.func.value.id
            tenant_kw = next((kw for kw in node.keywords
                              if kw.arg == "tenant"), None)
            if tenant_kw is None:
                yield mod.finding(
                    self, node,
                    f"{family}.labels(...) books a tenant-attributable "
                    "series without a tenant= label — every tenant's "
                    "traffic merges into one child and the per-tenant "
                    "SLO/isolation evidence goes blind; pass "
                    "tenant=<registry>.label(...)")
                continue
            v = tenant_kw.value
            bounded = isinstance(v, ast.Constant) or (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Attribute)
                and v.func.attr == "label")
            if not bounded:
                try:
                    text = ast.unparse(v)
                except Exception:  # pragma: no cover — unparse is total
                    text = "<expr>"
                yield mod.finding(
                    self, v,
                    f"{family}.labels(tenant={text}) passes a raw "
                    "(wire-derived) tenant value — one series per "
                    "distinct value until the registry OOMs; route it "
                    "through the bounded TenantRegistry.label() "
                    "gateway (unknown ids collapse to 'default')")


# whole-program (rule API v2) passes live in their own module — they
# consume the package index, not a single Module
from incubator_predictionio_tpu_torch.analysis.concur import (  # noqa: E402
    ThreadLifecycle,
    UnguardedSharedState,
)

ALL_RULES: Sequence[Rule] = (
    HostSyncInTrace(),
    NegativeGather(),
    ProbeArity(),
    TracerBranch(),
    EnvReadAtImport(),
    Float64WithoutX64(),
    WallClockInTrace(),
    ServerUnlockedState(),
    LockNativeScan(),
    MetricInTrace(),
    ServeBlockingIO(),
    BlockingProfiler(),
    HostGatherInMesh(),
    MetricLabelCardinality(),
    UnbatchedDispatch(),
    ExhaustiveScan(),
    UnboundedRetry(),
    UnauditedActuation(),
    UnauditedKnobWrite(),
    RecorderInServePath(),
    UnscopedTenantMetric(),
    UnguardedSharedState(),
    ThreadLifecycle(),
)

RULES_BY_NAME = {r.name: r for r in ALL_RULES}
