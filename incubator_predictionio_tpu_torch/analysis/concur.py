"""Whole-program lock-discipline analysis (rule API v2).

A copy of incubator_predictionio_tpu/analysis/concur.py (:1-997). The
serving system is a set of cooperating threads (scheduler dispatch
loops, the recorder's lock-free sampler ring, overlay pollers, the
controller loops) whose locking discipline is otherwise enforced only
by convention. This module is the RacerD-style guardrail, run as a
two-phase whole-program pass over the :class:`~.engine.Package`:

Phase one (:func:`build_index`) indexes every class in the package:
spawned ``threading.Thread`` / ``threading.Timer`` / executor-submit
entry points, per-method attribute reads and writes, ``with
self._lock:``-style guard regions (nested and locally aliased locks
included), the class's lock attributes, and the intra-class call graph
(the ``serve-blocking-io`` machinery, extended to closures).

Phase two reports:

``unguarded-shared-state`` (error) — an attribute written on a
thread-entry-reachable path and accessed on another path with
inconsistent lock protection. The GuardedBy set is INFERRED from the
guard regions the code already has, never annotated by hand.

``thread-lifecycle`` (warning) — a spawned thread with no daemon flag,
stop-event, or join seam (leaked threads are why shutdown-race tests
exist), and a ``ThreadPoolExecutor`` that is neither scoped by ``with``
nor ever shut down.

Sanctioned lock-free idioms are expressible, not baselined away:

* attributes holding thread-safe types (``queue.Queue`` handoff,
  ``threading.Event``, ``contextvars.ContextVar``, locks themselves)
  are exempt by construction;
* writes in ``__init__`` (and writes textually before the first spawn
  in the spawning method) are pre-publication and exempt;
* ``# pio-lint: publish-only`` declares a single-writer
  immutable-publish attribute (the recorder ring's tuple-swap); the
  analyzer VERIFIES the single-writer half — a publish-only attribute
  written from more than one thread domain is still an error;
* ``# pio-lint: guarded-by(<lock>)`` pins an attribute to a specific
  lock; a write outside any region of that lock is still an error.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from incubator_predictionio_tpu_torch.analysis.engine import (
    Finding,
    Module,
    Package,
)

#: constructors whose product is a lock — both a guard region source
#: (``with self.<attr>:``) and exempt from shared-state analysis
_LOCK_TYPES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}
#: constructors whose product is safe to share without a lock: the
#: queue/contextvar handoff idioms, events, thread-locals
_SAFE_TYPES = _LOCK_TYPES | {
    "threading.Event", "threading.Barrier", "threading.local",
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
    "queue.SimpleQueue", "contextvars.ContextVar",
    "asyncio.Queue", "asyncio.Event", "asyncio.Lock",
}
_THREAD_CTORS = {"threading.Thread": "thread", "threading.Timer": "timer"}
_EXECUTOR_CTORS = {
    "concurrent.futures.ThreadPoolExecutor",
    "concurrent.futures.thread.ThreadPoolExecutor",
}
#: method names that mutate their receiver in place (a
#: ``self.attr.append(...)`` is a WRITE of ``attr`` for race purposes) —
#: applied only to attributes known to BE plain containers; a method
#: named ``discard`` on a domain object is that object's business (deep
#: ownership: an object synchronizes itself)
_MUTATING_CALLS = {
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popleft", "popitem", "update", "setdefault", "clear",
    "move_to_end", "sort", "reverse",
}
_CONTAINER_CTORS = {
    "dict", "set", "list", "collections.deque",
    "collections.defaultdict", "collections.OrderedDict",
    "collections.Counter",
}
_CONTAINER_LITERALS = (ast.Dict, ast.Set, ast.List, ast.DictComp,
                       ast.SetComp, ast.ListComp)
_LOCK_NAME_RE = re.compile(r"lock", re.IGNORECASE)
_GUARDED_BY_RE = re.compile(r"^guarded-by\((?:self\.)?([\w.]+)\)$")


def _self_dotted(node: ast.AST) -> Optional[str]:
    """Dotted attribute path rooted at ``self`` — ``self.lock`` →
    ``"lock"``, ``self.client.lock`` → ``"client.lock"``; None for
    anything else. Lock guards routinely live on a collaborator (a DAO
    synchronizing on its client's lock), so lock identity must be the
    whole path, not just the first hop."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(reversed(parts))
    return None

_INDEX_CACHE_KEY = "concur.index"


# ---------------------------------------------------------------------------
# phase one: the package index
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Access:
    """One read or write of ``self.<attr>`` somewhere in a class."""

    attr: str
    kind: str            # "read" | "write"
    line: int
    locks: frozenset     # lock attr names held at the access site
    node: str            # method key, or "<method>.<nested>" for closures


@dataclasses.dataclass
class SpawnSite:
    """One thread/timer/executor creation site."""

    kind: str                      # "thread" | "timer" | "executor"
    line: int
    node: str                      # node key the spawn happens in
    target: Optional[str] = None   # entry node key, when resolvable
    daemon: bool = False           # daemon=True kwarg at the ctor
    bound: Optional[Tuple[str, str]] = None  # ("self", attr)|("local", n)
    #: every name the spawn is bound to — a chained assignment
    #: (``pool = self._pool = Executor(...)``) yields several live
    #: handles, and a lifecycle seam through ANY of them counts
    bounds: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)
    structured: bool = False       # executor opened by a with-block
    ctor: str = ""                 # resolved constructor name

    def bind(self, scope: str, name: str) -> None:
        self.bound = (scope, name)
        self.bounds.append((scope, name))


class NodeInfo:
    """Per method (or nested function) facts."""

    def __init__(self, key: str) -> None:
        self.key = key
        self.calls: Set[str] = set()         # callee node keys
        #: (callee key, locks held at the call site) — feeds the
        #: caller-held-lock propagation for `_locked`-style helpers
        self.call_sites: List[Tuple[str, frozenset]] = []
        self.accesses: List[Access] = []
        self.spawn_lines: List[int] = []     # thread-publication points
        self.local_joins: Set[str] = set()   # locals .join()/.cancel()ed
        self.local_daemons: Set[str] = set()  # locals with .daemon = True
        self.local_shutdowns: Set[str] = set()


class ClassInfo:
    """Phase-one index of one class: locks, accesses, spawns, edges."""

    def __init__(self, mod: Module, node: ast.ClassDef) -> None:
        self.mod = mod
        self.name = node.name
        self.node = node
        self.methods: Dict[str, ast.AST] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.lock_attrs: Set[str] = set()
        self.safe_attrs: Set[str] = set()
        self.container_attrs: Set[str] = set()
        self.attr_types: Dict[str, str] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.spawns: List[SpawnSite] = []
        self.entries: Set[str] = set()
        #: attr → directives ("publish-only" / "guarded-by:<lock>")
        self.annotations: Dict[str, Set[str]] = {}
        #: attr → method names ever called on it (stop-event detection)
        self.attr_calls: Dict[str, Set[str]] = {}
        self.joined_attrs: Set[str] = set()
        self.daemon_attrs: Set[str] = set()

    # -- reachability -------------------------------------------------------

    def reachable_from(self, entry: str) -> Set[str]:
        seen: Set[str] = set()
        stack = [entry]
        while stack:
            k = stack.pop()
            if k in seen or k not in self.nodes:
                continue
            seen.add(k)
            stack.extend(self.nodes[k].calls)
        return seen

    def held_locks(self) -> Dict[str, frozenset]:
        """Caller-held-lock propagation: the locks a node can rely on
        its callers holding. A ``_pick_locked()``-style private helper
        called only from ``with self._cv:`` regions inherits ``_cv``.
        Public methods and thread entries are callable from anywhere
        and inherit nothing; closures are only callable where visible,
        so they always qualify. Fixpoint over the call graph with the
        intersection of (site locks | caller's inherited locks) across
        every call site."""
        top = frozenset(self.lock_attrs)
        sites: Dict[str, List[Tuple[str, frozenset]]] = {}
        for caller, info in self.nodes.items():
            for callee, lks in info.call_sites:
                if callee in self.nodes:
                    sites.setdefault(callee, []).append((caller, lks))
        held: Dict[str, frozenset] = {}
        pinned: Set[str] = set()
        for key in self.nodes:
            nested = ".<" in key
            private = key.startswith("_") and not key.startswith("__")
            if key in self.entries or not (nested or private):
                held[key] = frozenset()
                pinned.add(key)
            elif not sites.get(key):
                held[key] = frozenset()
            else:
                held[key] = top
        changed = True
        while changed:
            changed = False
            for key, slist in sites.items():
                if key in pinned:
                    continue
                new = frozenset.intersection(*[
                    lks | held.get(caller, frozenset())
                    for caller, lks in slist])
                if new != held[key]:
                    held[key] = new
                    changed = True
        return held

    def domains_of(self) -> Dict[str, frozenset]:
        """node key → the thread domains it runs in: one domain per
        spawn entry whose reachable set contains it, else the caller
        ("main") domain."""
        per_entry = {e: self.reachable_from(e) for e in self.entries}
        out: Dict[str, frozenset] = {}
        for key in self.nodes:
            doms = frozenset(
                f"thread:{e}" for e, reach in per_entry.items()
                if key in reach)
            out[key] = doms or frozenset({"main"})
        return out


class ConcurrencyIndex:
    """The whole-package phase-one product shared by both rules."""

    def __init__(self) -> None:
        self.classes: List[ClassInfo] = []
        #: spawns in module-level functions (no ``self`` state to race,
        #: but the lifecycle contract still applies)
        self.function_spawns: List[Tuple[Module, SpawnSite, NodeInfo]] = []


def get_index(package: Package) -> ConcurrencyIndex:
    """Build (once per run) and share the package index."""
    idx = package.cache.get(_INDEX_CACHE_KEY)
    if idx is None:
        idx = build_index(package.modules)
        package.cache[_INDEX_CACHE_KEY] = idx
    return idx


def build_index(modules: Sequence[Module]) -> ConcurrencyIndex:
    index = ConcurrencyIndex()
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                index.classes.append(_index_class(mod, node))
        _index_module_functions(mod, index)
    return index


def _index_module_functions(mod: Module, index: ConcurrencyIndex) -> None:
    """Spawn/lifecycle facts for functions outside classes."""
    fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
    class_fns = {
        id(fn) for cls in ast.walk(mod.tree)
        if isinstance(cls, ast.ClassDef)
        for fn in ast.walk(cls) if isinstance(fn, fn_types)
    }
    # closures inside module functions belong to their parent's scan —
    # only top functions get their own pass
    nested_fns = {
        id(inner) for outer in ast.walk(mod.tree)
        if isinstance(outer, fn_types)
        for inner in ast.walk(outer)
        if inner is not outer and isinstance(inner, fn_types)
    }
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, fn_types):
            continue
        if id(fn) in class_fns or id(fn) in nested_fns:
            continue
        dummy = ClassInfo(mod, ast.ClassDef(
            name="<module>", bases=[], keywords=[], body=[],
            decorator_list=[]))
        scanner = _FunctionScanner(dummy, mod)
        info = scanner.scan(fn, fn.name, is_init=False)
        for site in dummy.spawns:
            index.function_spawns.append((mod, site, info))


def _index_class(mod: Module, node: ast.ClassDef) -> ClassInfo:
    cls = ClassInfo(mod, node)
    _collect_lock_and_safe_attrs(cls, mod)
    scanner = _FunctionScanner(cls, mod)
    for name, fn in cls.methods.items():
        cls.nodes[name] = scanner.scan(fn, name, is_init=(name == "__init__"))
    # spawn targets become thread entries
    for site in cls.spawns:
        if site.target is not None and site.target in cls.nodes:
            cls.entries.add(site.target)
    return cls


def _collect_lock_and_safe_attrs(cls: ClassInfo, mod: Module) -> None:
    """Pass A: lock attributes (typed lock assignment anywhere, or a
    lock-named ``with self.<attr>:`` guard) and thread-safe-typed
    attributes (queue/event/contextvar handoffs)."""
    for sub in ast.walk(cls.node):
        if isinstance(sub, (ast.Assign, ast.AnnAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) \
                else [sub.target]
            value = sub.value
            if value is None:
                continue
            rname = (mod.resolved(value.func) or "") \
                if isinstance(value, ast.Call) else ""
            container = (rname in _CONTAINER_CTORS
                         or isinstance(value, _CONTAINER_LITERALS))
            for tgt in targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    if rname in _LOCK_TYPES:
                        cls.lock_attrs.add(tgt.attr)
                    if rname in _SAFE_TYPES:
                        cls.safe_attrs.add(tgt.attr)
                    if container:
                        cls.container_attrs.add(tgt.attr)
                    if rname:
                        cls.attr_types[tgt.attr] = rname
        elif isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                path = _self_dotted(item.context_expr)
                if (path is not None
                        and _LOCK_NAME_RE.search(path.rsplit(".", 1)[-1])):
                    cls.lock_attrs.add(path)
    cls.safe_attrs |= cls.lock_attrs
    # the root of a dotted lock path (``client`` in ``client.lock``) is
    # reached in order to TAKE the lock, so it cannot itself be guarded
    # by it — it must be stably published (Java's final-field rule for
    # @GuardedBy paths); exempt it from inference
    cls.safe_attrs |= {p.split(".", 1)[0] for p in cls.lock_attrs
                       if "." in p}


class _FunctionScanner:
    """Single-method walker: guard regions (nested + aliased locks),
    attribute accesses, spawn sites, call edges. Nested functions get
    their own node (``method.<name>``) — a closure handed to
    ``threading.Thread(target=run)`` is its own thread entry, while
    code before the spawn stays in the caller's domain."""

    def __init__(self, cls: ClassInfo, mod: Module) -> None:
        self.cls = cls
        self.mod = mod

    def scan(self, fn: ast.AST, key: str, is_init: bool) -> NodeInfo:
        info = NodeInfo(key)
        self.cls.nodes[key] = info
        nested_defs = [n for n in fn.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
        # pre-register nested names so a spawn can resolve a target
        # defined later in the body too
        self._nested_names = {n.name for n in ast.walk(fn)
                              if isinstance(n, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))
                              and n is not fn}
        self._info = info
        self._spawned_calls: Dict[int, SpawnSite] = {}
        aliases: Dict[str, str] = {}
        for stmt in fn.body:
            self._visit(stmt, frozenset(), aliases)
        # nested functions (any depth) become their own nodes
        collected: List[ast.AST] = []

        def collect(n: ast.AST) -> None:
            for child in ast.walk(n):
                if (isinstance(child, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                        and child is not n):
                    collected.append(child)
        collect(fn)
        saved = (self._info, self._spawned_calls, self._nested_names)
        for sub in collected:
            sub_key = f"{key}.<{sub.name}>"
            sub_info = NodeInfo(sub_key)
            self.cls.nodes[sub_key] = sub_info
            self._info = sub_info
            self._spawned_calls = {}
            self._nested_names = set()
            sub_aliases: Dict[str, str] = {}
            for stmt in sub.body:
                self._visit(stmt, frozenset(), sub_aliases)
        self._info, self._spawned_calls, self._nested_names = saved
        # init-time / pre-spawn accesses are pre-publication: no other
        # thread can observe them (RacerD's ownership rule). Scope:
        # __init__ wholesale unless __init__ itself spawns, else only
        # lines before the method's first spawn.
        first_spawn = min(info.spawn_lines, default=None)
        pruned: List[Access] = []
        for a in info.accesses:
            if is_init and (first_spawn is None or a.line < first_spawn):
                continue
            if (not is_init and first_spawn is not None
                    and a.line < first_spawn):
                continue
            pruned.append(a)
        info.accesses = pruned
        del nested_defs
        return info

    # -- recording ----------------------------------------------------------

    def _record(self, attr: str, kind: str, line: int,
                locks: frozenset) -> None:
        cls = self.cls
        if attr in cls.safe_attrs or attr in cls.methods:
            if attr in cls.methods:
                self._info.calls.add(attr)
                self._info.call_sites.append((attr, locks))
            return
        for d in self.mod.annotations_at(line):
            cls.annotations.setdefault(attr, set()).add(d)
        self._info.accesses.append(Access(
            attr=attr, kind=kind, line=line, locks=locks,
            node=self._info.key))

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _self_root_attr(self, node: ast.AST) -> Optional[str]:
        """Innermost self attribute of an attribute/subscript chain
        (``self.a.b[c].d`` → ``a``)."""
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            inner = self._self_attr(node)
            if inner is not None:
                return inner
            node = node.value
        return None

    def _lock_of(self, expr: ast.AST, aliases: Dict[str, str]
                 ) -> Optional[str]:
        path = _self_dotted(expr)
        if path is not None and path in self.cls.lock_attrs:
            return path
        if isinstance(expr, ast.Name):
            return aliases.get(expr.id)
        return None

    # -- the walk -----------------------------------------------------------

    def _visit(self, node: ast.AST, locks: frozenset,
               aliases: Dict[str, str]) -> None:
        if node is None:
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # separate node; scanned by the caller
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(locks)
            for item in node.items:
                self._visit(item.context_expr, locks, aliases)
                lk = self._lock_of(item.context_expr, aliases)
                if lk is not None:
                    inner.add(lk)
                # `with ThreadPoolExecutor(...) as pool:` — structured
                if isinstance(item.context_expr, ast.Call):
                    site = self._spawned_calls.get(
                        id(item.context_expr))
                    if site is not None:
                        site.structured = True
                        if (item.optional_vars is not None
                                and isinstance(item.optional_vars,
                                               ast.Name)):
                            site.bind("local",
                                      item.optional_vars.id)
            inner_f = frozenset(inner)
            for stmt in node.body:
                self._visit(stmt, inner_f, aliases)
            return
        if isinstance(node, ast.Assign):
            self._visit(node.value, locks, aliases)
            for tgt in node.targets:
                self._visit_target(tgt, locks, aliases)
            self._post_assign(node.targets, node.value, aliases)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._visit(node.value, locks, aliases)
                self._post_assign([node.target], node.value, aliases)
            self._visit_target(node.target, locks, aliases)
            return
        if isinstance(node, ast.AugAssign):
            self._visit(node.value, locks, aliases)
            attr = self._self_attr(node.target)
            if attr is not None:
                self._record(attr, "write", node.lineno, locks)
            else:
                self._visit_target(node.target, locks, aliases)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._visit_target(tgt, locks, aliases)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, locks, aliases)
            return
        if isinstance(node, ast.Attribute):
            attr = self._self_attr(node)
            if attr is not None:
                kind = ("write" if isinstance(node.ctx,
                                              (ast.Store, ast.Del))
                        else "read")
                self._record(attr, kind, node.lineno, locks)
                return
            self._visit(node.value, locks, aliases)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, locks, aliases)

    def _visit_target(self, tgt: ast.AST, locks: frozenset,
                      aliases: Dict[str, str]) -> None:
        """Assignment/delete target: a store through a self attribute —
        direct (``self.x = v``), item (``self.x[k] = v``), or nested
        (``self.x.y = v``) — is a write of the root attribute."""
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._visit_target(el, locks, aliases)
            return
        if isinstance(tgt, ast.Starred):
            self._visit_target(tgt.value, locks, aliases)
            return
        root = self._self_root_attr(tgt)
        if root is not None:
            self._record(root, "write", tgt.lineno, locks)
            if isinstance(tgt, ast.Subscript):
                self._visit(tgt.slice, locks, aliases)
            return
        # t.daemon = True on a local thread handle
        if (isinstance(tgt, ast.Attribute) and tgt.attr == "daemon"
                and isinstance(tgt.value, ast.Name)):
            self._info.local_daemons.add(tgt.value.id)
        if isinstance(tgt, ast.Subscript):
            self._visit(tgt.value, locks, aliases)
            self._visit(tgt.slice, locks, aliases)

    def _post_assign(self, targets: Sequence[ast.AST], value: ast.AST,
                     aliases: Dict[str, str]) -> None:
        """Track lock aliases (``lk = self._lock``), spawn bindings
        (``self._thread = threading.Thread(...)``), and daemon flags.
        Chained assignments (``pool = self._pool = Executor(...)``)
        bind every target — each one is a live handle to the spawn."""
        for tgt in targets:
            self._post_assign_one(tgt, value, aliases)

    def _post_assign_one(self, tgt: ast.AST, value: ast.AST,
                         aliases: Dict[str, str]) -> None:
        if isinstance(tgt, ast.Name):
            lk = self._lock_of(value, aliases)
            if lk is not None:
                aliases[tgt.id] = lk
            else:
                aliases.pop(tgt.id, None)
            site = self._spawned_calls.get(id(value))
            if site is not None:
                site.bind("local", tgt.id)
        else:
            attr = self._self_attr(tgt)
            if attr is not None:
                site = self._spawned_calls.get(id(value))
                if site is not None:
                    site.bind("self", attr)
                if (isinstance(value, ast.Constant)
                        and value.value is True and attr == "daemon"):
                    pass  # self.daemon = True is not a thread handle
        # self.<attr>.daemon = True
        if (isinstance(tgt, ast.Attribute) and tgt.attr == "daemon"
                and isinstance(value, ast.Constant)
                and value.value is True):
            base = self._self_attr(tgt.value)
            if base is not None:
                self.cls.daemon_attrs.add(base)
            elif isinstance(tgt.value, ast.Name):
                self._info.local_daemons.add(tgt.value.id)

    # -- calls --------------------------------------------------------------

    def _visit_call(self, node: ast.Call, locks: frozenset,
                    aliases: Dict[str, str]) -> None:
        f = node.func
        consumed: Optional[ast.AST] = None
        if isinstance(f, ast.Attribute):
            recv_attr = self._self_attr(f.value)
            if self._self_attr(f) is not None:
                # self.m(...) — call edge (methods/properties) or a
                # read of a stored callable
                self._record(f.attr, "read", f.lineno, locks)
                consumed = f
            elif recv_attr is not None:
                # self.<attr>.<m>(...) — a mutator counts as a write
                # only on a plain container; a domain object owns its
                # own synchronization (deep ownership)
                self.cls.attr_calls.setdefault(recv_attr, set()).add(
                    f.attr)
                kind = ("write" if f.attr in _MUTATING_CALLS
                        and recv_attr in self.cls.container_attrs
                        else "read")
                self._record(recv_attr, kind, f.lineno, locks)
                if f.attr in ("join", "cancel"):
                    self.cls.joined_attrs.add(recv_attr)
                consumed = f.value
            elif isinstance(f.value, ast.Name):
                if f.attr in ("join", "cancel"):
                    self._info.local_joins.add(f.value.id)
                elif f.attr == "shutdown":
                    self._info.local_shutdowns.add(f.value.id)
            if f.attr == "submit" and node.args:
                self._register_submit(node, locks)
        rname = self.mod.resolved(node.func) or ""
        if rname in _THREAD_CTORS:
            self._register_thread_ctor(node, _THREAD_CTORS[rname],
                                       rname)
        elif rname in _EXECUTOR_CTORS:
            site = SpawnSite(kind="executor", line=node.lineno,
                             node=self._info.key, ctor=rname)
            self.cls.spawns.append(site)
            self._spawned_calls[id(node)] = site
            self._info.spawn_lines.append(node.lineno)
        # local nested-def call: run() invoked synchronously
        if isinstance(f, ast.Name) and f.id in self._nested_names:
            nested_key = f"{self._info.key}.<{f.id}>"
            self._info.calls.add(nested_key)
            self._info.call_sites.append((nested_key, locks))
        if consumed is None and not isinstance(f, ast.Name):
            self._visit(f, locks, aliases)
        for arg in node.args:
            self._visit(arg, locks, aliases)
        for kw in node.keywords:
            self._visit(kw.value, locks, aliases)

    def _callable_key(self, expr: ast.AST) -> Optional[str]:
        """Entry node key for a callable handed to a thread/executor:
        a bound method (``self._run``) or a nested function name."""
        attr = self._self_attr(expr)
        if attr is not None and attr in self.cls.methods:
            return attr
        if isinstance(expr, ast.Name) and expr.id in self._nested_names:
            base = self._info.key
            return f"{base}.<{expr.id}>"
        return None

    def _register_thread_ctor(self, node: ast.Call, kind: str,
                              rname: str) -> None:
        daemon = any(
            kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True for kw in node.keywords)
        target_expr: Optional[ast.AST] = None
        if kind == "thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        else:  # Timer(interval, function, ...)
            for kw in node.keywords:
                if kw.arg == "function":
                    target_expr = kw.value
            if target_expr is None and len(node.args) >= 2:
                target_expr = node.args[1]
        target = (self._callable_key(target_expr)
                  if target_expr is not None else None)
        site = SpawnSite(kind=kind, line=node.lineno,
                         node=self._info.key, target=target,
                         daemon=daemon, ctor=rname)
        self.cls.spawns.append(site)
        self._spawned_calls[id(node)] = site
        self._info.spawn_lines.append(node.lineno)

    def _register_submit(self, node: ast.Call, locks: frozenset) -> None:
        target = self._callable_key(node.args[0])
        if target is None:
            return
        site = SpawnSite(kind="executor", line=node.lineno,
                         node=self._info.key, target=target,
                         daemon=True,  # pool workers are pool-managed
                         structured=True, ctor="submit")
        self.cls.spawns.append(site)
        self._info.spawn_lines.append(node.lineno)


# ---------------------------------------------------------------------------
# phase two: the rules
# ---------------------------------------------------------------------------


class UnguardedSharedState:
    name = "unguarded-shared-state"
    severity = "error"
    whole_program = True
    doc = ("attribute written on a thread-entry-reachable path and "
           "accessed on another path with inconsistent lock protection "
           "(GuardedBy inferred from the class's own `with self._lock:` "
           "regions) — also verifies the `# pio-lint: guarded-by(<lock>)`"
           " / `# pio-lint: publish-only` annotations and exempts the "
           "sanctioned idioms: queue/event/contextvar handoff, "
           "pre-publication `__init__` writes, single-writer "
           "immutable-publish")

    def check(self, mod: Module) -> Iterator[Finding]:
        return iter(())  # v2 rule: per-file phase contributes nothing

    def check_package(self, package: Package) -> Iterator[Finding]:
        index = get_index(package)
        for cls in index.classes:
            if not cls.entries:
                continue
            yield from self._check_class(cls)

    # -- per-class analysis -------------------------------------------------

    def _check_class(self, cls: ClassInfo) -> Iterator[Finding]:
        domains = cls.domains_of()
        held = cls.held_locks()
        by_attr: Dict[str, List[Access]] = {}
        for info in cls.nodes.values():
            for a in info.accesses:
                inherited = held.get(a.node, frozenset())
                if inherited:
                    a = dataclasses.replace(
                        a, locks=a.locks | inherited)
                by_attr.setdefault(a.attr, []).append(a)
        for attr in sorted(by_attr):
            if attr.startswith("__"):
                continue
            yield from self._check_attr(cls, attr, by_attr[attr],
                                        domains)

    def _check_attr(self, cls: ClassInfo, attr: str,
                    accesses: List[Access],
                    domains: Dict[str, frozenset]) -> Iterator[Finding]:
        mod = cls.mod
        writes = [a for a in accesses if a.kind == "write"]
        if not writes:
            return
        ann = cls.annotations.get(attr, set())
        dom = {a: domains.get(a.node, frozenset({"main"}))
               for a in accesses}

        gb = next((m.group(1) for d in ann
                   for m in [_GUARDED_BY_RE.match(d)] if m), None)
        if gb is not None:
            for w in writes:
                if gb not in w.locks:
                    yield mod.finding_at(
                        self, w.line,
                        f"`self.{attr}` ({cls.name}) is declared "
                        f"guarded-by({gb}) but this write holds "
                        + (f"{{{', '.join(sorted(w.locks))}}}"
                           if w.locks else "no lock")
                        + f" — every write must hold `self.{gb}`")
            return

        if "publish-only" in ann:
            ordered = sorted(writes, key=lambda w: w.line)
            primary = dom[ordered[0]]
            for w in ordered:
                if dom[w] == primary:
                    continue
                yield mod.finding_at(
                    self, w.line,
                    f"`self.{attr}` ({cls.name}) is declared "
                    "publish-only (single-writer immutable-publish) "
                    "but is written from more than one thread domain "
                    "— the idiom is only safe with exactly one writer")
            return

        # cross-domain conflict: a write in one domain, any access in
        # another — same-domain state (however racy it looks) is
        # sequential and out of scope
        conflict = any(dom[w] != dom[a] for w in writes for a in accesses)
        if not conflict:
            return

        guarded = [a for a in accesses if a.locks]
        unguarded = [a for a in accesses if not a.locks]
        if not guarded:
            yield from self._flag_fully_unguarded(
                cls, attr, accesses, writes, dom)
            return
        # GuardedBy inference: a lock held at EVERY access means the
        # discipline is consistent; otherwise infer the majority lock
        # and flag the accesses that skip it
        common = frozenset.intersection(*[a.locks for a in accesses])
        if common:
            return
        counts: Dict[str, int] = {}
        for a in guarded:
            for lk in a.locks:
                counts[lk] = counts.get(lk, 0) + 1
        inferred = max(sorted(counts), key=lambda k: counts[k])
        n_guarded = sum(1 for a in guarded if inferred in a.locks)
        seen_lines: Set[int] = set()
        for a in sorted(accesses, key=lambda a: a.line):
            if inferred in a.locks or a.line in seen_lines:
                continue
            seen_lines.add(a.line)
            where = ("a thread-entry path"
                     if dom[a] != frozenset({"main"})
                     else "the caller side")
            yield mod.finding_at(
                self, a.line,
                f"`self.{attr}` ({cls.name}) {a.kind} without "
                f"`self.{inferred}` on {where} — {n_guarded} other "
                f"access(es) of this attribute hold it (inferred "
                f"GuardedBy({inferred})); hold the lock here or "
                "declare the idiom (docs/lint.md \"Concurrency "
                "contract\")")

    def _flag_fully_unguarded(self, cls: ClassInfo, attr: str,
                              accesses: List[Access],
                              writes: List[Access],
                              dom: Dict[Access, frozenset]
                              ) -> Iterator[Finding]:
        """No lock anywhere: report once per attribute, anchored at the
        first thread-side write (per the rule contract, a write must be
        thread-entry-reachable to count as a race here)."""
        thread_writes = [w for w in writes
                         if dom[w] != frozenset({"main"})]
        if not thread_writes:
            return
        w = min(thread_writes, key=lambda a: a.line)
        others = sorted({a.line for a in accesses
                         if dom[a] != dom[w]})
        entry = sorted(dom[w])[0].partition(":")[2]
        yield cls.mod.finding_at(
            self, w.line,
            f"`self.{attr}` ({cls.name}) is written on the "
            f"{entry!r} thread path and accessed from other paths "
            f"(line(s) {', '.join(map(str, others))}) with no lock "
            "held anywhere — guard it, hand it over via queue.Queue, "
            "or declare `# pio-lint: publish-only` if it is a "
            "single-writer immutable publish (docs/lint.md "
            "\"Concurrency contract\")")


class ThreadLifecycle:
    name = "thread-lifecycle"
    severity = "warning"
    whole_program = True
    doc = ("spawned thread/timer with no daemon flag, stop-event, or "
           "join seam (a leaked non-daemon thread blocks interpreter "
           "exit and is why shutdown-race tests exist), or a "
           "ThreadPoolExecutor neither scoped by `with` nor ever shut "
           "down")

    def check(self, mod: Module) -> Iterator[Finding]:
        return iter(())

    def check_package(self, package: Package) -> Iterator[Finding]:
        index = get_index(package)
        for cls in index.classes:
            stop_event = self._has_stop_event(cls)
            for site in cls.spawns:
                yield from self._check_site(cls.mod, site, cls,
                                            stop_event)
        for mod, site, info in index.function_spawns:
            yield from self._check_site(mod, site, None, False,
                                        fn_info=info)

    @staticmethod
    def _has_stop_event(cls: ClassInfo) -> bool:
        """A stop-event discipline: an Event attribute that some method
        sets and the loop side waits on / polls."""
        for attr, typ in cls.attr_types.items():
            if typ != "threading.Event":
                continue
            calls = cls.attr_calls.get(attr, set())
            if "set" in calls and ({"wait", "is_set"} & calls):
                return True
        return False

    def _check_site(self, mod: Module, site: SpawnSite,
                    cls: Optional[ClassInfo], stop_event: bool,
                    fn_info: Optional[NodeInfo] = None
                    ) -> Iterator[Finding]:
        if site.kind == "executor":
            if site.ctor == "submit" or site.structured:
                return
            shut = False
            for scope, name in site.bounds:
                if cls is not None:
                    if scope == "self":
                        shut = "shutdown" in cls.attr_calls.get(
                            name, set())
                    else:
                        shut = any(name in n.local_shutdowns
                                   for n in cls.nodes.values())
                elif fn_info is not None:
                    shut = name in fn_info.local_shutdowns
                if shut:
                    break
            if not shut:
                yield mod.finding_at(
                    self, site.line,
                    "ThreadPoolExecutor created outside a `with` block "
                    "and never shut down — workers leak past the "
                    "owner's lifetime; scope it with `with` or keep a "
                    ".shutdown() seam")
            return
        if site.daemon:
            return
        if self._daemon_set_later(site, cls, fn_info):
            return
        if self._join_seam(site, cls, fn_info):
            return
        if stop_event:
            return
        what = ("threading.Timer" if site.kind == "timer"
                else "threading.Thread")
        yield mod.finding_at(
            self, site.line,
            f"{what} spawned with no daemon flag, stop-event, or join "
            "seam — a leaked non-daemon thread blocks interpreter exit "
            "(and survives its owner); pass daemon=True, keep a "
            ".join()/.cancel() seam, or guard the loop with a stop "
            "Event")

    @staticmethod
    def _daemon_set_later(site: SpawnSite, cls: Optional[ClassInfo],
                          fn_info: Optional[NodeInfo]) -> bool:
        for scope, name in site.bounds:
            if scope == "self":
                if cls is not None and name in cls.daemon_attrs:
                    return True
                continue
            if cls is not None:
                node = cls.nodes.get(site.node)
                if node is not None and name in node.local_daemons:
                    return True
            if fn_info is not None and name in fn_info.local_daemons:
                return True
        return False

    @staticmethod
    def _join_seam(site: SpawnSite, cls: Optional[ClassInfo],
                   fn_info: Optional[NodeInfo]) -> bool:
        for scope, name in site.bounds:
            if scope == "self":
                if cls is not None and name in cls.joined_attrs:
                    return True
                continue
            if cls is not None:
                node = cls.nodes.get(site.node)
                if node is not None and name in node.local_joins:
                    return True
            if fn_info is not None and name in fn_info.local_joins:
                return True
        return False


__all__ = [
    "Access", "ClassInfo", "ConcurrencyIndex", "NodeInfo", "SpawnSite",
    "ThreadLifecycle", "UnguardedSharedState", "build_index",
    "get_index",
]
