"""Gremlin-style fluent traversal DSL.

Re-creation of the reference's TinkerPop process surface + Titan optimizer
strategies (reference: titan-core graphdb/tinkerpop/optimize/ —
TitanGraphStepStrategy folds ``has()`` into the start step,
TitanVertexStep batches ALL current traversers into one multi-vertex
adjacency query, TitanVertexStep.java:69-96). The interpreter here is a
pull-based pipeline over batches of traversers, so every ``out()/in()/both()``
step issues ONE batched backend multi-query for the whole frontier instead
of one slice per vertex — the same optimization, without the TinkerPop
machinery.

Traverser bulking (TP3 LazyBarrierStrategy semantics, which the reference
inherits from the TinkerPop runtime it embeds via pom.xml:62): after every
adjacency step, traversers standing on the same element with the same
labels/sack merge into ONE traverser with a ``bulk`` count. A k-hop
``out()*k.count()`` therefore does per-hop work bounded by the DISTINCT
frontier's adjacency, not by the number of paths (deg^k). Path-tracking
traversals (``path()``/``simplePath()``) disable merging, exactly like
TP3's PathRetractionStrategy interplay. ``TITAN_TPU_NO_BULK=1`` forces the
un-bulked interpreter (used by the equivalence tests).

Supported steps: V, E, has/hasLabel/hasId, out/in/both, outE/inE/bothE,
inV/outV/otherV/bothV, values/properties/valueMap/id/label, count, limit,
dedup, order, where/filter/not_/and_/or_, repeat(...).times/until/emit,
simplePath, path, select, as_, union, coalesce, choose/branch + option,
project, group/groupCount, local, sack (with_sack on the source), store/
aggregate + cap, unfold, fold, constant, sum/max/min/mean, ``by`` modulators
for order/group/groupCount/project/select/dedup/sack — all for OLTP
interpretation; a subset compiles to supersteps on the card
(traversal/olap_compile.py).

The port's copy of ``titan_tpu/traversal/dsl.py``. Its computer is
``"gpu"``: ``g.traversal().with_computer("gpu", snapshot=None,
device=None)`` runs a compilable chain on ``device`` (``None`` means
CUDA, and raises when there is no card; tests pass ``"cpu"``), as
``graph.compute(backend="gpu")`` does. ``with_computer(None)``
interprets; any other name raises ``ValueError``.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, Iterator, Optional

from titan_tpu_torch.core.defs import Direction
from titan_tpu_torch.core.elements import Edge, Vertex, VertexProperty
from titan_tpu_torch.device import resolve_device
from titan_tpu_torch.query.predicates import P

_BATCH = 512
_MISSING = object()


class Traverser:
    __slots__ = ("obj", "prev", "path", "labels", "sack", "bulk")

    def __init__(self, obj, path=None, labels=None, prev=None, sack=None,
                 bulk=1):
        self.obj = obj
        self.prev = prev      # object at the previous step (for otherV)
        self.path = path if path is not None else [obj]
        self.labels = labels or {}
        self.sack = sack
        self.bulk = bulk

    def extend(self, obj, step_label=None, with_path=False):
        t = Traverser(obj,
                      (self.path + [obj]) if with_path else self.path,
                      self.labels, prev=self.obj, sack=self.sack,
                      bulk=self.bulk)
        if step_label:
            t.labels = dict(self.labels)
            t.labels[step_label] = obj
        return t

    def split(self, bulk: int) -> "Traverser":
        """Clone with a given bulk (used by limit-splitting, union teeing
        and emit — TP3 Traverser.split)."""
        return Traverser(self.obj, self.path, self.labels, prev=self.prev,
                         sack=self.sack, bulk=bulk)


class GraphTraversalSource:
    """``g = graph.traversal()``"""

    def __init__(self, graph, tx=None, computer=None, snapshot=None,
                 sack_init=_MISSING, device=None):
        self.graph = graph
        self._tx = tx
        self._computer = computer          # None = OLTP interpreter; "gpu"
        self._snapshot = snapshot          # reusable CSR snapshot
        self._sack_init = sack_init
        self._device = device              # the gpu computer's device

    def with_computer(self, computer: Optional[str] = "gpu", snapshot=None,
                      device=None) -> "GraphTraversalSource":
        """Route compilable read traversals through supersteps on
        ``device`` (reference: TitanBlueprintsGraph.compute() engine
        selection — unsupported patterns fall back to the OLTP
        interpreter). ``device=None`` means CUDA and raises without a
        card; ``computer=None`` interprets."""
        if computer is None:
            dev = None
        elif computer == "gpu":
            dev = resolve_device(device)
        else:
            raise ValueError(f"unknown traversal computer {computer!r}: "
                             "the port's is 'gpu' (None interprets)")
        return GraphTraversalSource(self.graph, self._tx, computer, snapshot,
                                    self._sack_init, dev)

    def with_sack(self, init) -> "GraphTraversalSource":
        """TP3 ``withSack(initial)`` — every start traverser carries the
        value (a callable is treated as a per-traverser supplier)."""
        return GraphTraversalSource(self.graph, self._tx, self._computer,
                                    self._snapshot, init, self._device)

    @property
    def tx(self):
        return self._tx if self._tx is not None else self.graph.tx()

    def V(self, *ids) -> "Traversal":
        t = Traversal(self)
        t._steps.append(("V", ids))
        return t

    def E(self) -> "Traversal":
        t = Traversal(self)
        t._steps.append(("E", ()))
        return t

    def add_v(self, label: Optional[str] = None, **props) -> "Traversal":
        t = Traversal(self)
        t._steps.append(("addV", (label, props)))
        return t


def anon() -> "Traversal":
    """Anonymous sub-traversal for repeat()/union()/... bodies — the
    TinkerPop ``__`` (double-underscore) helper."""
    return Traversal(None)


class _AnonBuilder:
    """TP3's ``__`` spelling: ``__.out("x")`` starts a fresh anonymous
    traversal (``__`` in TP3 is a static-method namespace, not a
    callable)."""

    def __getattr__(self, name):
        def start(*args, **kwargs):
            return getattr(anon(), name)(*args, **kwargs)
        return start


__ = _AnonBuilder()


def conditions_to_query(q, conditions):
    """Translate folded has-conditions onto a GraphQuery. Returns the id
    filter set (or None), or raises _Unsupported when a condition can't be
    answered by the graph-centric engine (pseudo-keys, multi-label OR)."""
    id_filter = None
    for name, args in conditions:
        if name in ("has", "hasKey") and args[0] in ("id", "label"):
            raise _Unsupported(args[0])   # pseudo-keys: stream filter instead
        if name == "has":
            q.has(args[0], args[1])
        elif name == "hasKey":
            q.has(args[0])
        elif name == "hasLabel":
            labels = args[0]
            if len(labels) != 1:
                raise _Unsupported("multi-label")
            q.has_label(labels[0])
        elif name == "hasId":
            ids = set(args[0])
            id_filter = ids if id_filter is None else id_filter & ids
        else:
            raise _Unsupported(name)
    return id_filter


class _Unsupported(Exception):
    pass


# modulator step names folded onto the preceding step at execution time
_MODULATORS = frozenset({"by", "option", "times", "until", "emit"})
# steps after which the bulk barrier runs (the explosive ones)
_BARRIER_AFTER = frozenset({"vstep", "edgevertex"})
# bulking-barrier chunk: TP3's LazyBarrierStrategy uses NoOpBarrierStep
# with maxBarrierSize=2500 precisely to bound the laziness loss
_BARRIER_CHUNK = 2500
# bulk-aware aggregates: a barrier right before them is wasted work
_BULK_AGGREGATES = frozenset({"count", "sum", "mean", "groupCount",
                              "group"})


class Traversal:
    def __init__(self, source: Optional[GraphTraversalSource]):
        self.source = source
        self._steps: list[tuple] = []
        self._path_needed = False
        self._side_effects: dict = {}

    # -- step builders -------------------------------------------------------

    def _append(self, name, *args):
        self._steps.append((name, args))
        return self

    def has(self, key, value=None):
        if value is None and not isinstance(key, tuple):
            return self._append("hasKey", key)
        pred = value if isinstance(value, P) else P.eq(value)
        return self._append("has", key, pred)

    def has_label(self, *labels):
        return self._append("hasLabel", labels)

    hasLabel = has_label

    def has_id(self, *ids):
        return self._append("hasId", set(ids))

    def out(self, *labels):
        return self._append("vstep", Direction.OUT, labels, "vertex")

    def in_(self, *labels):
        return self._append("vstep", Direction.IN, labels, "vertex")

    def both(self, *labels):
        return self._append("vstep", Direction.BOTH, labels, "vertex")

    def out_e(self, *labels):
        return self._append("vstep", Direction.OUT, labels, "edge")

    outE = out_e

    def in_e(self, *labels):
        return self._append("vstep", Direction.IN, labels, "edge")

    inE = in_e

    def both_e(self, *labels):
        return self._append("vstep", Direction.BOTH, labels, "edge")

    bothE = both_e

    def out_v(self):
        return self._append("edgevertex", "out")

    outV = out_v

    def in_v(self):
        return self._append("edgevertex", "in")

    inV = in_v

    def other_v(self):
        return self._append("edgevertex", "other")

    otherV = other_v

    def values(self, *keys):
        return self._append("values", keys)

    def properties(self, *keys):
        return self._append("properties", keys)

    def value_map(self, *keys):
        return self._append("valueMap", keys)

    valueMap = value_map

    def id_(self):
        return self._append("id")

    def label(self):
        return self._append("label")

    def count(self):
        return self._append("count")

    def sum_(self):
        return self._append("sum")

    def max_(self):
        return self._append("max")

    def min_(self):
        return self._append("min")

    def mean(self):
        return self._append("mean")

    def fold(self):
        return self._append("fold")

    def unfold(self):
        return self._append("unfold")

    def constant(self, v):
        return self._append("constant", v)

    def limit(self, n: int):
        return self._append("limit", n)

    def dedup(self):
        return self._append("dedup")

    def order(self, by: Optional[str] = None, desc: bool = False):
        return self._append("order", by, desc)

    def filter_(self, fn: Callable[[Any], bool]):
        return self._append("filter", fn)

    def _absorb_path(self, *subs):
        """Sub-traversals that track paths force path mode on the parent
        (their traversers are seeded from ours, so OUR paths must be real)."""
        for s in subs:
            if isinstance(s, Traversal) and s._path_needed:
                self._path_needed = True

    def where(self, cond):
        """Callable predicate on the object, or an anonymous traversal that
        must produce at least one result (TP3 ``where(traversal)``)."""
        if isinstance(cond, Traversal):
            self._absorb_path(cond)
            return self._append("whereSub", cond)
        return self._append("filter", cond)

    def not_(self, sub: "Traversal"):
        self._absorb_path(sub)
        return self._append("not", sub)

    def and_(self, *subs: "Traversal"):
        self._absorb_path(*subs)
        return self._append("and", subs)

    def or_(self, *subs: "Traversal"):
        self._absorb_path(*subs)
        return self._append("or", subs)

    def as_(self, label: str):
        return self._append("as", label)

    def select(self, *labels: str):
        return self._append("select", labels)

    def path(self):
        self._path_needed = True
        return self._append("path")

    def simple_path(self):
        self._path_needed = True
        return self._append("simplePath")

    simplePath = simple_path

    def repeat(self, sub: "Traversal"):
        self._absorb_path(sub)
        return self._append("repeat", sub)

    def times(self, n: int):
        return self._append("times", n)

    def until(self, cond):
        return self._append("until", cond)

    def emit(self, cond=None):
        return self._append("emit", cond) if cond is not None \
            else self._append("emit")

    def group_count(self, by: Optional[str] = None):
        return self._append("groupCount", by)

    groupCount = group_count

    def group(self):
        return self._append("group")

    def project(self, *keys: str):
        return self._append("project", keys)

    def union(self, *subs: "Traversal"):
        self._absorb_path(*subs)
        return self._append("union", *subs)

    def coalesce(self, *subs: "Traversal"):
        self._absorb_path(*subs)
        return self._append("coalesce", *subs)

    def choose(self, cond, true_sub: Optional["Traversal"] = None,
               false_sub: Optional["Traversal"] = None):
        """``choose(pred, t, f)`` if-then-else form, or ``choose(keyfn)``
        followed by ``.option(key, sub)`` switch form (TP3 ChooseStep)."""
        self._absorb_path(cond, true_sub, false_sub)
        return self._append("choose", cond, true_sub, false_sub)

    def branch(self, selector):
        """``branch(fn).option(key, sub)`` — the traverser is routed to
        EVERY option whose key matches (plus ``"any"`` options); TP3
        BranchStep with Pick.any."""
        self._absorb_path(selector)
        return self._append("branch", selector)

    def option(self, key, sub: "Traversal"):
        self._absorb_path(sub)
        return self._append("option", key, sub)

    def local(self, sub: "Traversal"):
        """Apply sub to each traverser in isolation (TP3 LocalStep —
        barriers inside don't cross traversers)."""
        self._absorb_path(sub)
        return self._append("local", sub)

    def match(self, *patterns: "Traversal"):
        """TP3 MatchStep (conjunctive subset): each pattern is an
        anonymous traversal that STARTS at a variable — written
        ``anon().as_("a")...`` — and usually ENDS with ``.as_("b")``
        binding the result. Patterns join on shared variable names; the
        incoming traverser seeds the FIRST pattern's start variable.
        Emits one traverser per consistent binding (its object is the
        binding dict — follow with ``select`` to project variables)."""
        self._absorb_path(*patterns)
        return self._append("match", patterns)

    def sack(self, op: Optional[Callable] = None):
        """No-arg: read the sack into the stream. With ``op(sack, operand)``:
        update the sack; operand is the ``by`` modulator's value (default:
        the current object)."""
        return self._append("sack", op)

    def store(self, key: str):
        return self._append("store", key)

    def aggregate(self, key: str):
        """TP3 eager aggregate: store + barrier."""
        return self._append("aggregate", key)

    def cap(self, key: str):
        return self._append("cap", key)

    def by(self, spec=None, desc: bool = False):
        """Modulator for the preceding order/group/groupCount/project/
        select/dedup/sack step. ``spec``: property-key string, callable,
        anonymous traversal, or None (identity)."""
        return self._append("by", spec, desc)

    # -- execution -----------------------------------------------------------

    def __iter__(self):
        return iter(self.to_list())

    def to_list(self) -> list:
        out: list = []
        for t in self._execute():
            if t.bulk == 1:
                out.append(t.obj)
            else:
                out.extend(itertools.repeat(t.obj, t.bulk))
        return out

    def next(self):
        for t in self._execute():
            return t.obj
        raise StopIteration

    def _bulk_enabled(self) -> bool:
        return not self._path_needed and \
            not os.environ.get("TITAN_TPU_NO_BULK")

    def _execute(self, _stages: Optional[list] = None) -> Iterator[Traverser]:
        if self.source is None:
            raise ValueError(
                "anonymous traversal can only be used as a sub-traversal")
        tx = self.source.tx
        steps = self._fold_has_into_start(list(self._steps))

        # OLAP compilation: a supported V().has(...).out()...count() chain on
        # the gpu computer runs as CSR supersteps instead of interpretation
        if _stages is None:
            results = self._run_compiled(steps)
            if results is not None:
                return results

        def timed(name, it):
            # .profile(): wrap each pipeline stage with a timing iterator
            if _stages is None:
                return it
            from titan_tpu_torch.query.profile import StepMetrics, TimedStage
            stage = TimedStage(it, StepMetrics(name),
                               _stages[-1] if _stages else None)
            _stages.append(stage)
            return stage

        self._side_effects = {}
        nsteps = self._normalize(steps)
        bulked = self._bulk_enabled()
        traversers: Iterable[Traverser] = iter(())
        i = 0
        # V().has(...) start goes through the index-aware query engine
        if len(nsteps) >= 2 and nsteps[0][:2] == ("V", ()) and \
                nsteps[1][0] == "Vfiltered":
            indexed = self._indexed_start(tx, nsteps[1][1][0])
            if indexed is not None:
                traversers = timed("V(indexed)", indexed)
                i = 2
        while i < len(nsteps):
            name, args, mods = nsteps[i]
            # fused adjacency-count: the last hop of out()...count() needs
            # only per-source matching-edge counts, not materialized
            # neighbor traversers (TP3 CountGlobalStep + the reference's
            # TitanVertexStep multiQuery seam collapse the same way)
            if bulked and name == "vstep" and i + 1 < len(nsteps) and \
                    nsteps[i + 1][0] == "count":
                traversers = timed("vstep+count", self._vertex_step_count(
                    tx, traversers, *args))
                i += 2
                continue
            traversers = timed(name,
                               self._apply(tx, traversers, name, args, mods))
            if bulked and name in _BARRIER_AFTER and not (
                    i + 1 < len(nsteps)
                    and nsteps[i + 1][0] in _BULK_AGGREGATES):
                traversers = self._barrier(traversers)
            i += 1
        return iter(traversers)

    @staticmethod
    def _normalize(steps: list) -> list:
        """Fold modulator steps (by/option/times/until/emit) into the mods
        dict of the step they modulate: [(name, args, mods), ...].

        A repeat-modulator BEFORE its repeat() (TP3 ``until(p).repeat(x)``)
        is held pending and attached with while-do semantics (checked
        before each body application, seeds included). A modulator on a
        step that cannot read it is an error, not a silent no-op."""
        _BY_STEPS = ("order", "group", "groupCount", "project", "select",
                     "dedup", "sack")
        _OPTION_STEPS = ("choose", "branch")
        out: list = []
        pending: dict = {}
        for name, args in steps:
            if name == "by":
                if not out or out[-1][0] not in _BY_STEPS:
                    raise ValueError(
                        "by() must follow one of "
                        f"{'/'.join(_BY_STEPS)}")
                out[-1][2].setdefault("by", []).append(args)
            elif name == "option":
                if not out or out[-1][0] not in _OPTION_STEPS:
                    raise ValueError("option() must follow choose()/"
                                     "branch()")
                out[-1][2].setdefault("option", []).append(args)
            elif name in ("times", "until", "emit"):
                if out and out[-1][0] == "repeat":
                    mods = out[-1][2]
                    if name == "times":
                        mods["times"] = args[0]
                    elif name == "until":
                        mods["until"] = args[0]
                    else:
                        mods["emit"] = args[0] if args else None
                else:
                    # while-do form: hold for the NEXT repeat()
                    if name == "times":
                        pending["times"] = args[0]
                    elif name == "until":
                        pending["until_pre"] = args[0]
                    else:
                        pending["emit_pre"] = args[0] if args else None
            else:
                mods = {}
                if name == "repeat" and pending:
                    mods, pending = pending, {}
                out.append((name, args, mods))
        if pending:
            raise ValueError(
                f"{'/'.join(sorted(pending))} modulator without a "
                "following repeat()")
        return out

    def _run_compiled(self, steps) -> Optional[Iterator[Traverser]]:
        """Try the superstep compiler on folded steps; None means interpret
        (not on the gpu computer / unsupported pattern / runtime fallback).
        Only the compiler's semantic FallbackToInterpreter interprets: a
        device error inside the compiled run raises."""
        if self.source is None or self.source._computer != "gpu":
            return None
        from titan_tpu_torch.traversal.olap_compile import (
            FallbackToInterpreter, try_compile)
        compiled = try_compile(steps, self.source)
        if compiled is None:
            return None
        try:
            return compiled.run()
        except FallbackToInterpreter:
            return None

    def profile(self):
        """Execute and return per-step TraversalMetrics (reference:
        Gremlin ``.profile()`` via TP3ProfileWrapper)."""
        import time as _time

        from titan_tpu_torch.query.profile import (StepMetrics, TimedStage,
                                                   TraversalMetrics)
        if self.source is not None and self.source._computer == "gpu":
            # compiled plans execute as one fused device program — report
            # them as a single step rather than pretending per-step times
            steps = self._fold_has_into_start(list(self._steps))
            t0 = _time.perf_counter_ns()
            results = self._run_compiled(steps)
            if results is not None:
                results = list(results)
                total = _time.perf_counter_ns() - t0
                sm = StepMetrics("olap(compiled)")
                sm.count = len(results)
                sm.time_ns = sm.own_ns = total
                return TraversalMetrics([sm], total, compiled=True)
        stages: list[TimedStage] = []
        t0 = _time.perf_counter_ns()
        for _ in self._execute(_stages=stages):
            pass
        total = _time.perf_counter_ns() - t0
        for s in stages:
            s.finalize()
        return TraversalMetrics([s.metrics for s in stages], total)

    @staticmethod
    def _fold_has_into_start(steps: list) -> list:
        """TitanGraphStepStrategy analog: pull has()/hasLabel() immediately
        after V() into the start step so an index (or at worst one filtered
        scan) answers it."""
        if not steps or steps[0][0] != "V":
            return steps
        folded = [steps[0]]
        i = 1
        conditions = []
        while i < len(steps) and steps[i][0] in ("has", "hasLabel", "hasId"):
            conditions.append(steps[i])
            i += 1
        if conditions:
            folded.append(("Vfiltered", (conditions,)))
        folded.extend(steps[i:])
        return folded

    # -- bulking -------------------------------------------------------------

    @staticmethod
    def _merge_key(t: Traverser):
        """Hashable identity for merging, or None if this traverser can't
        merge (unhashable object/labels/sack)."""
        o = t.obj
        if isinstance(o, (Vertex, Edge, VertexProperty)):
            ok = (o.__class__.__name__, o.id)
        else:
            try:
                hash(o)
            except TypeError:
                return None
            ok = ("val", o)
        if t.labels:
            try:
                lk = tuple(sorted(
                    (k, v.id if isinstance(v, (Vertex, Edge)) else v)
                    for k, v in t.labels.items()))
                hash(lk)
            except TypeError:
                return None
        else:
            lk = ()
        sk = t.sack
        if sk is not None:
            try:
                hash(sk)
            except TypeError:
                return None
        if isinstance(o, Edge):
            # otherV() depends on prev — only merge edges from the same hop
            pk = t.prev.id if isinstance(t.prev, (Vertex, Edge)) else None
            return (ok, lk, sk, pk)
        return (ok, lk, sk)

    def _opt_int(self, option, default: int) -> int:
        """Tuning option from the source graph's config (query.* knobs);
        ``default`` for detached traversals."""
        g = getattr(self.source, "graph", None) \
            if self.source is not None else None
        if g is not None:
            from titan_tpu_torch.config import defaults as d
            got = g.config.get(getattr(d, option))
            if got:
                return int(got)
        return default

    def _barrier(self, traversers) -> Iterator[Traverser]:
        """LazyBarrierStrategy analog: merge traversers with equal
        location into one with summed bulk — within bounded chunks of
        ``query.barrier-size`` (TP3 inserts ``NoOpBarrierStep(2500)``,
        not an unbounded drain), so ``g.V().out().limit(1)`` stays lazy
        instead of expanding the whole frontier before limit() can cut
        it."""
        cls = type(self)   # _merge_key is a classmethod helper
        chunk = self._opt_int("BARRIER_SIZE", _BARRIER_CHUNK)

        def gen():
            it = iter(traversers)
            while True:
                batch = list(itertools.islice(it, chunk))
                if not batch:
                    return
                merged: dict = {}
                extras: list = []
                for t in batch:
                    k = cls._merge_key(t)
                    if k is None:
                        extras.append(t)
                        continue
                    cur = merged.get(k)
                    if cur is None:
                        merged[k] = t
                    else:
                        cur.bulk += t.bulk
                yield from merged.values()
                yield from extras
        return gen()

    # -- sub-traversal helpers ----------------------------------------------

    def _apply_sub(self, tx, traversers, sub: "Traversal"):
        """Run an anonymous sub-traversal over a traverser stream (with the
        same barrier placement as the main pipeline)."""
        bulked = self._bulk_enabled() and not sub._path_needed
        # normalize once per sub-traversal, not once per seeded traverser
        # (where/not_/local re-enter this per element on hot filter paths)
        cached = getattr(sub, "_nsteps_cache", None)
        if cached is not None and cached[0] == len(sub._steps):
            nsteps = cached[1]
        else:
            nsteps = self._normalize(sub._steps)
            sub._nsteps_cache = (len(sub._steps), nsteps)
        stream: Iterable = traversers
        j = 0
        while j < len(nsteps):
            name, args, mods = nsteps[j]
            if bulked and name == "vstep" and j + 1 < len(nsteps) and \
                    nsteps[j + 1][0] == "count":
                stream = self._vertex_step_count(tx, stream, *args)
                j += 2
                continue
            stream = self._apply(tx, stream, name, args, mods)
            if bulked and name in _BARRIER_AFTER and not (
                    j + 1 < len(nsteps)
                    and nsteps[j + 1][0] in _BULK_AGGREGATES):
                stream = self._barrier(stream)
            j += 1
        return stream

    def _seeded(self, tx, t: Traverser, sub: "Traversal") -> list:
        """Run sub seeded with a clone of one traverser; list of results."""
        return list(self._apply_sub(tx, iter([t.split(t.bulk)]), sub))

    @staticmethod
    def _binding_eq(a, b) -> bool:
        if isinstance(a, (Vertex, Edge)) and isinstance(b, (Vertex, Edge)):
            return type(a) is type(b) and a.id == b.id
        return a == b

    @staticmethod
    def _compile_pattern(pat: "Traversal") -> tuple:
        """(start_var, body_sub, end_var) — built ONCE per pattern so
        _apply_sub's normalization cache actually hits on re-entry."""
        start = pat._steps[0][1][0]
        body = pat._steps[1:]
        end_var = None
        if body and body[-1][0] == "as":
            end_var = body[-1][1][0]
            body = body[:-1]
        sub = Traversal(None)
        sub._steps = list(body)
        sub._path_needed = pat._path_needed
        return start, sub, end_var

    def _match_solve(self, tx, bindings: dict, patterns: list
                     ) -> Iterator[dict]:
        """Backtracking pattern join (TP3 MatchStep, conjunctive subset):
        pick a pattern whose start variable is bound, enumerate its
        solutions, extend/check bindings, recurse on the rest.
        ``patterns``: list of _compile_pattern tuples."""
        if not patterns:
            yield bindings
            return
        for k, (start, _, _) in enumerate(patterns):
            if start in bindings:
                chosen, rest = patterns[k], patterns[:k] + patterns[k + 1:]
                break
        else:
            names = [p[0] for p in patterns]
            raise ValueError(
                f"match(): none of the remaining patterns {names} starts "
                "at a bound variable (patterns must be connected)")
        start, sub, end_var = chosen
        seed = Traverser(bindings[start], labels=dict(bindings))
        for r in self._apply_sub(tx, iter([seed]), sub):
            # join constraint for EVERY shared variable, including those
            # an as_() mid-body rebound (overwrite would silently break
            # the join semantics the docstring promises)
            if any(k2 in bindings and
                   not self._binding_eq(bindings[k2], v2)
                   for k2, v2 in r.labels.items()):
                continue
            newb = dict(bindings)
            newb.update(r.labels)
            if end_var is not None:
                if end_var in bindings and \
                        not self._binding_eq(bindings[end_var], r.obj):
                    continue           # join constraint violated
                newb[end_var] = r.obj
            yield from self._match_solve(tx, newb, rest)

    def _matches(self, tx, t: Traverser, cond) -> bool:
        """Filter condition: callable on the object, or an anonymous
        traversal that must yield >= 1 traverser."""
        if isinstance(cond, Traversal):
            for _ in self._apply_sub(tx, iter([t.split(1)]), cond):
                return True
            return False
        return bool(cond(t.obj))

    def _by_value(self, tx, t: Traverser, spec):
        """Resolve a ``by`` modulator against one traverser: None =
        identity, str = property key, callable = fn(obj), traversal =
        first result (None if empty)."""
        if spec is None:
            return t.obj
        if isinstance(spec, str):
            return self._value_of(t.obj, spec)
        if isinstance(spec, Traversal):
            for r in self._apply_sub(tx, iter([t.split(1)]), spec):
                return r.obj
            return None
        return spec(t.obj)

    @staticmethod
    def _group_key(k):
        return k.id if isinstance(k, (Vertex, Edge)) else k

    # the interpreter core
    def _apply(self, tx, traversers, name, args, mods=None
               ) -> Iterator[Traverser]:
        mods = mods or {}
        if name == "V":
            ids = args
            sack = self._sack0()
            if ids:
                return (Traverser(v, sack=sack()) for v in
                        (tx.vertex(i) for i in ids) if v is not None)
            return (Traverser(v, sack=sack()) for v in tx.vertices())
        if name == "addV":
            label, props = args
            return iter([Traverser(tx.add_vertex(label, **props),
                                   sack=self._sack0()())])
        if name == "E":
            def all_edges(sack=self._sack0()):
                seen = set()
                for v in tx.vertices():
                    for e in v.out_edges():
                        if e.id not in seen:
                            seen.add(e.id)
                            yield Traverser(e, sack=sack())
            return all_edges()
        if name == "Vfiltered":
            return self._apply_conditions(tx, traversers, args[0])
        if name == "vstep":
            return self._vertex_step(tx, traversers, *args)
        if name == "edgevertex":
            mode = args[0]

            def ev(ts=traversers):
                for t in ts:
                    e: Edge = t.obj
                    if mode == "out":
                        yield t.extend(e.out_vertex(), with_path=self._path_needed)
                    elif mode == "in":
                        yield t.extend(e.in_vertex(), with_path=self._path_needed)
                    else:
                        prev = t.prev if isinstance(t.prev, Vertex) else None
                        yield t.extend(e.other(prev) if prev is not None
                                       else e.in_vertex(),
                                       with_path=self._path_needed)
            return ev()
        if name == "has":
            key, pred = args

            def fhas(ts=traversers):
                for t in ts:
                    v = self._value_of(t.obj, key)
                    if v is not None and pred(v):
                        yield t
            return fhas()
        if name == "hasKey":
            key = args[0]
            return (t for t in traversers
                    if self._value_of(t.obj, key) is not None)
        if name == "hasLabel":
            labels = set(args[0])
            return (t for t in traversers if t.obj.label() in labels)
        if name == "hasId":
            ids = args[0]
            return (t for t in traversers if t.obj.id in ids)
        if name == "values":
            keys = args[0]

            def fvalues(ts=traversers):
                for t in ts:
                    if isinstance(t.obj, Vertex):
                        for p in t.obj.properties(*keys):
                            yield t.extend(p.value)
                    elif isinstance(t.obj, Edge):
                        for k in (keys or t.obj.property_map().keys()):
                            val = t.obj.value(k)
                            if val is not None:
                                yield t.extend(val)
            return fvalues()
        if name == "properties":
            keys = args[0]

            def fprops(ts=traversers):
                for t in ts:
                    for p in t.obj.properties(*keys):
                        yield t.extend(p)
            return fprops()
        if name == "valueMap":
            keys = args[0]

            def fvm(ts=traversers):
                for t in ts:
                    if isinstance(t.obj, Vertex):
                        m: dict = {}
                        for p in t.obj.properties(*keys):
                            m.setdefault(p.key(), []).append(p.value)
                        yield t.extend(m)
                    else:
                        yield t.extend(t.obj.property_map())
            return fvm()
        if name == "id":
            return (t.extend(t.obj.id) for t in traversers)
        if name == "label":
            return (t.extend(t.obj.label()) for t in traversers)
        if name == "count":
            return iter([Traverser(sum(t.bulk for t in traversers))])
        if name == "sum":
            # TP3: an empty reducing barrier emits NOTHING (only count
            # emits 0) — pinned by tests/test_tp3_differential.py
            tot, seen = 0, False
            for t in traversers:
                tot += t.obj * t.bulk
                seen = True
            return iter([Traverser(tot)] if seen else [])
        if name == "max":
            vals = [t.obj for t in traversers]
            return iter([Traverser(max(vals))] if vals else [])
        if name == "min":
            vals = [t.obj for t in traversers]
            return iter([Traverser(min(vals))] if vals else [])
        if name == "mean":
            tot, n = 0, 0
            for t in traversers:
                tot += t.obj * t.bulk
                n += t.bulk
            return iter([Traverser(tot / n)] if n else [])
        if name == "fold":
            folded: list = []
            for t in traversers:
                folded.extend(itertools.repeat(t.obj, t.bulk))
            return iter([Traverser(folded)])
        if name == "unfold":
            def funfold(ts=traversers):
                for t in ts:
                    o = t.obj
                    items = o.items() if isinstance(o, dict) else \
                        (o if isinstance(o, (list, tuple, set)) else [o])
                    for x in items:
                        yield t.extend(x)
            return funfold()
        if name == "constant":
            return (t.extend(args[0]) for t in traversers)
        if name == "limit":
            def flimit(ts=traversers, n=args[0]):
                left = n
                if left <= 0:
                    return
                for t in ts:
                    if t.bulk <= left:
                        yield t
                        left -= t.bulk
                    else:
                        yield t.split(left)
                        left = 0
                    if left <= 0:
                        return
            return flimit()
        if name == "dedup":
            by = (mods.get("by") or [(None, False)])[0][0]

            def fdedup(ts=traversers):
                seen = set()
                for t in ts:
                    k = self._by_value(tx, t, by) if by is not None else t.obj
                    k = self._group_key(k) if not isinstance(k, dict) \
                        else tuple(sorted(k.items()))
                    if k not in seen:
                        seen.add(k)
                        t.bulk = 1          # TP3: dedup resets bulk
                        yield t
            return fdedup()
        if name == "order":
            # TP3: first by() is the primary key, later ones are
            # tie-breakers; chained stable sorts applied in reverse give
            # exactly that (and allow per-key desc)
            specs = mods.get("by") or [args]

            def keyfn_for(by):
                if by is None:
                    return lambda t: t.obj
                if callable(by) and not isinstance(by, (str, Traversal)):
                    return lambda t: by(t.obj)
                return lambda t: self._by_value(tx, t, by)

            ordered = list(traversers)
            for by, desc in reversed(specs):
                ordered.sort(key=keyfn_for(by), reverse=desc)
            return iter(ordered)
        if name == "filter":
            fn = args[0]
            return (t for t in traversers if fn(t.obj))
        if name == "whereSub":
            sub = args[0]
            return (t for t in traversers if self._matches(tx, t, sub))
        if name == "not":
            sub = args[0]
            return (t for t in traversers if not self._matches(tx, t, sub))
        if name == "and":
            subs = args[0]
            return (t for t in traversers
                    if all(self._matches(tx, t, s) for s in subs))
        if name == "or":
            subs = args[0]
            return (t for t in traversers
                    if any(self._matches(tx, t, s) for s in subs))
        if name == "as":
            label = args[0]

            def fas(ts=traversers):
                for t in ts:
                    t.labels = dict(t.labels)
                    t.labels[label] = t.obj
                    yield t
            return fas()
        if name == "select":
            labels = args[0]
            bys = [b[0] for b in mods.get("by", [])]

            def _sel(t, lbl, j):
                v = t.labels.get(lbl)
                if j < len(bys) and v is not None:
                    return self._by_value(tx, t.split(1).extend(v), bys[j])
                return v

            def fsel(ts=traversers):
                for t in ts:
                    if len(labels) == 1:
                        yield t.extend(_sel(t, labels[0], 0))
                    else:
                        yield t.extend({l: _sel(t, l, j)
                                        for j, l in enumerate(labels)})
            return fsel()
        if name == "path":
            return (t.extend(list(t.path)) for t in traversers)
        if name == "simplePath":
            def fsp(ts=traversers):
                for t in ts:
                    ids = [o.id for o in t.path if hasattr(o, "id")]
                    if len(ids) == len(set(ids)):
                        yield t
            return fsp()
        if name == "repeat":
            return self._repeat(tx, traversers, args[0], mods)
        if name == "union":
            subs = args

            def funion(ts=traversers):
                batch = list(ts)
                for sub in subs:
                    yield from self._apply_sub(
                        tx, iter([t.split(t.bulk) for t in batch]), sub)
            return funion()
        if name == "coalesce":
            subs = args

            def fcoalesce(ts=traversers):
                for t in ts:
                    for sub in subs:
                        results = self._seeded(tx, t, sub)
                        if results:
                            yield from results
                            break
            return fcoalesce()
        if name == "choose":
            cond, true_sub, false_sub = args
            options = mods.get("option", [])

            def fchoose(ts=traversers):
                for t in ts:
                    if true_sub is not None or false_sub is not None:
                        sub = true_sub if self._matches(tx, t, cond) \
                            else false_sub
                        if sub is None:
                            yield t
                        else:
                            yield from self._seeded(tx, t, sub)
                    else:
                        key = self._by_value(tx, t, cond)
                        matched = False
                        for k, sub in options:
                            if k == key:
                                matched = True
                                yield from self._seeded(tx, t, sub)
                        if not matched:
                            for k, sub in options:
                                if k == "none":
                                    matched = True
                                    yield from self._seeded(tx, t, sub)
                        if not matched:
                            yield t
            return fchoose()
        if name == "branch":
            selector = args[0]
            options = mods.get("option", [])

            def fbranch(ts=traversers):
                for t in ts:
                    key = self._by_value(tx, t, selector)
                    matched = False
                    for k, sub in options:
                        if k == key or k == "any":
                            matched = True
                            yield from self._seeded(tx, t, sub)
                    if not matched:
                        for k, sub in options:
                            if k == "none":
                                yield from self._seeded(tx, t, sub)
            return fbranch()
        if name == "local":
            sub = args[0]

            def flocal(ts=traversers):
                for t in ts:
                    yield from self._seeded(tx, t, sub)
            return flocal()
        if name == "match":
            patterns = args[0]
            if not patterns:
                raise ValueError("match() needs at least one pattern")
            for pat in patterns:
                if not pat._steps or pat._steps[0][0] != "as":
                    raise ValueError(
                        "match() patterns must start with as_(<var>)")

            compiled = [self._compile_pattern(p) for p in patterns]

            def fmatch(ts=traversers):
                start0 = compiled[0][0]
                for t in ts:
                    bindings0 = dict(t.labels)
                    bindings0[start0] = t.obj
                    for b in self._match_solve(tx, bindings0,
                                               list(compiled)):
                        nt = t.extend(b)
                        nt.labels = b    # select() projects variables
                        yield nt
            return fmatch()
        if name == "project":
            keys = args[0]
            bys = [b[0] for b in mods.get("by", [])]

            def fproject(ts=traversers):
                for t in ts:
                    d = {}
                    for j, k in enumerate(keys):
                        d[k] = self._by_value(tx, t,
                                              bys[j] if j < len(bys)
                                              else None)
                    yield t.extend(d)
            return fproject()
        if name == "group":
            bys = mods.get("by", [])
            kby = bys[0][0] if bys else None
            vby = bys[1][0] if len(bys) > 1 else None
            groups: dict = {}
            for t in traversers:
                k = self._group_key(self._by_value(tx, t, kby))
                groups.setdefault(k, []).append(t)
            out: dict = {}
            agg = isinstance(vby, Traversal) and vby._steps and \
                vby._steps[-1][0] in ("count", "sum", "max", "min",
                                      "mean", "fold")
            for k, members in groups.items():
                if agg:
                    seeds = iter([m.split(m.bulk) for m in members])
                    res = list(self._apply_sub(tx, seeds, vby))
                    out[k] = res[0].obj if res else None
                else:
                    vals: list = []
                    for m in members:
                        v = self._by_value(tx, m, vby)
                        vals.extend(itertools.repeat(v, m.bulk))
                    out[k] = vals
            return iter([Traverser(out)])
        if name == "groupCount":
            by = args[0]
            for spec, _d in mods.get("by", []):
                by = spec
            counts: dict = {}
            for t in traversers:
                k = self._by_value(tx, t, by) if by is not None else t.obj
                k = self._group_key(k)
                counts[k] = counts.get(k, 0) + t.bulk
            return iter([Traverser(counts)])
        if name == "sack":
            op = args[0]
            by = (mods.get("by") or [(None, False)])[0][0]

            def fsack(ts=traversers):
                for t in ts:
                    if op is None:
                        yield t.extend(t.sack)
                    else:
                        operand = self._by_value(tx, t, by) \
                            if by is not None else t.obj
                        t2 = t.split(t.bulk)
                        t2.sack = op(t.sack, operand)
                        yield t2
            return fsack()
        if name in ("store", "aggregate"):
            key = args[0]
            bucket = self._side_effects.setdefault(key, [])

            def fstore(ts=traversers, eager=(name == "aggregate")):
                src = list(ts) if eager else ts
                for t in src:
                    bucket.extend(itertools.repeat(t.obj, t.bulk))
                    if not eager:
                        yield t
                if eager:
                    yield from iter(src)
            return fstore()
        if name == "cap":
            key = args[0]

            def fcap(ts=traversers):
                for _ in ts:          # drain the stream (barrier)
                    pass
                yield Traverser(list(self._side_effects.get(key, [])))
            return fcap()
        raise ValueError(f"unknown step {name!r}")

    def _sack0(self):
        """Per-start-traverser sack supplier from with_sack()."""
        init = self.source._sack_init if self.source is not None else _MISSING
        if init is _MISSING:
            return lambda: None
        if callable(init):
            return init
        return lambda: init

    def _repeat(self, tx, traversers, sub, mods) -> Iterator[Traverser]:
        times = mods.get("times")
        until = mods.get("until")
        until_pre = mods.get("until_pre")       # while-do: until().repeat()
        emit_spec = mods.get("emit", _MISSING)
        emit_pre = mods.get("emit_pre", _MISSING)
        any_emit = emit_spec is not _MISSING or emit_pre is not _MISSING

        def gen():
            current = list(traversers)
            k = 0
            while current:
                # while-do modulators run BEFORE the body, seeds included
                if until_pre is not None:
                    keep = []
                    for t in current:
                        if self._matches(tx, t, until_pre):
                            yield t
                        else:
                            keep.append(t)
                    current = keep
                    if not current:
                        return
                if emit_pre is not _MISSING:
                    for t in current:
                        if emit_pre is None or \
                                self._matches(tx, t, emit_pre):
                            yield t.split(t.bulk)
                if times is not None and k >= times:
                    if not any_emit:
                        yield from current
                    return
                nxt = list(self._apply_sub(tx, iter(current), sub))
                k += 1
                if until is not None:
                    keep = []
                    for t in nxt:
                        if self._matches(tx, t, until):
                            yield t
                        else:
                            keep.append(t)
                    nxt = keep
                if emit_spec is not _MISSING:
                    for t in nxt:
                        if emit_spec is None or \
                                self._matches(tx, t, emit_spec):
                            yield t.split(t.bulk)
                if times is None and until is None and until_pre is None:
                    # bare repeat() with no terminator: one application
                    if not any_emit:
                        yield from nxt
                    return
                current = nxt
        return gen()

    def _apply_conditions(self, tx, traversers, conditions):
        """Apply folded has-conditions by streaming filters (used when the
        start step isn't a bare V() — e.g. V(ids).has(...))."""
        stream = traversers
        for name, args in conditions:
            stream = self._apply(tx, stream, name, args)
        return stream

    def _indexed_start(self, tx, conditions):
        """Answer V().has(...) through the graph-centric query engine so a
        composite/mixed index serves the start step (reference:
        TitanGraphStepStrategy folding has() into TitanGraphStep, which
        GraphCentricQueryBuilder then answers from an index). None when a
        condition needs the streaming filters (pseudo-keys, multi-label)."""
        q = tx.query()
        try:
            id_filter = conditions_to_query(q, conditions)
        except _Unsupported:
            return None
        vertices = q.vertices()
        if id_filter is not None:
            vertices = [v for v in vertices if v.id in id_filter]
        sack = self._sack0()
        return (Traverser(v, sack=sack()) for v in vertices)

    def _vertex_step_count(self, tx, traversers, direction, labels, kind):
        """Fused vstep+count: per-source matching-edge counts × bulk,
        without materializing neighbor traversers."""
        labels = list(labels) or None

        nbatch = self._opt_int("TRAVERSAL_BATCH", _BATCH)

        def gen():
            total = 0
            it = iter(traversers)
            while True:
                batch = list(itertools.islice(it, nbatch))
                if not batch:
                    break
                vids = [t.obj.id for t in batch]
                edges_by_vid = tx.multi_vertex_edges(vids, direction, labels)
                for t in batch:
                    edges = edges_by_vid[t.obj.id]
                    if kind == "edge" or direction is Direction.BOTH:
                        c = len(edges)
                    else:
                        vid = t.obj.id
                        c = sum(1 for e in edges
                                if e.rel.direction_of(vid) is direction)
                    total += c * t.bulk
            yield Traverser(total)
        return gen()

    # batched adjacency: ONE multiQuery per frontier batch
    def _vertex_step(self, tx, traversers, direction, labels, kind):
        labels = list(labels) or None

        nbatch = self._opt_int("TRAVERSAL_BATCH", _BATCH)

        def gen():
            it = iter(traversers)
            while True:
                batch = list(itertools.islice(it, nbatch))
                if not batch:
                    return
                vids = [t.obj.id for t in batch]
                edges_by_vid = tx.multi_vertex_edges(vids, direction, labels)
                for t in batch:
                    for e in edges_by_vid[t.obj.id]:
                        if kind == "edge":
                            yield t.extend(e, with_path=self._path_needed)
                        else:
                            d = e.rel.direction_of(t.obj.id)
                            if direction is Direction.BOTH:
                                other = e.other(t.obj)
                            elif d is direction:
                                other = e.other(t.obj)
                            else:
                                continue
                            yield t.extend(other, with_path=self._path_needed)
        return gen()

    @staticmethod
    def _value_of(obj, key):
        if key == "id":
            return obj.id
        if key == "label":
            return obj.label()
        if isinstance(obj, Vertex):
            return obj.value(key)
        if isinstance(obj, Edge):
            return obj.value(key)
        if isinstance(obj, dict):
            return obj.get(key)
        return None
