"""Micro-traversal -> batched-frontier compilation for the interactive lane
(port of ``titan_tpu/olap/serving/interactive/compile.py``).

Bounded-depth point queries (``g.V(x).out().out().dedup().id_()``-class
chains) lower onto the batched ``[K, n]`` frontier machinery
(``models/bfs_hybrid.frontier_bfs_batched``, ``mode="hops"``), so many
users' queries fuse into ONE device run sharing every plan and
edge-chunk gather.

Hops mode computes exact per-hop frontier SETS, so the compilable subset
is the set-semantics one:

    V(id, ...)                       >= 1 explicit start id
    .out(*L) | .in_(*L) | .both(*L)  1..max_depth hops, ONE direction;
                                     one label set for the chain, or a
                                     set per hop (mixed-label chains)
    [.repeat(<hop>).times(k)]        expands to k copies of the hop
    .dedup()                         REQUIRED: the terminal dedup makes
                                     set semantics equal the
                                     interpreter's bulked multiset
    .id_() | .count() | .values(k)   terminal

Everything else returns ``None`` from :func:`compile_steps`, and the
caller falls back loudly to the dsl interpreter
(:class:`FallbackToInterpreter` is the run-time form of that seam).

Direction lowering: the hops sweep is bottom-up (candidate ``w`` joins
the next hop when one of w's CSR chunk neighbours is in the frontier), so
``both()`` runs on the symmetrized lease's forward CSR, ``in_()`` on the
directed lease's forward CSR, and ``out()`` on the REVERSED layout,
which needs no sort: the snapshot's dst-sorted arrays are already the
in-CSR (:func:`reversed_chunked_csr`).

``Direction`` is the port's ``core/defs.Direction`` and
``FallbackToInterpreter`` is ``traversal/olap_compile``'s, one class
caught by the dsl, the compiled path and the lane alike. A plan made by
the JAX package does not compare equal to the port's by direction
identity, so plans cross between the packages as wire bodies or step
lists. The device caches (the reversed CSR, the label masks) are kept on
the snapshot by device under the port's own names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from titan_tpu_torch.core.defs import Direction
from titan_tpu_torch.device import cache_key
from titan_tpu_torch.models.bfs_hybrid import (chunked_layout,
                                               layout_slot_positions)
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.traversal.olap_compile import FallbackToInterpreter

__all__ = ["TraversalPlan", "PPRPlan", "compile_steps",
           "compile_traversal", "plan_from_wire", "traversal_from_plan",
           "reversed_chunked_csr", "hop_label_masks", "Direction",
           "FallbackToInterpreter", "DEFAULT_MAX_DEPTH"]

#: default bounded-depth ceiling (LDBC IS3 is a 4-hop; anything deeper
#: is an analytics job for the heavy queue, not a point query)
DEFAULT_MAX_DEPTH = 4


_DIR_NAMES = {"out": Direction.OUT, "in": Direction.IN,
              "both": Direction.BOTH}
_NAME_OF_DIR = {v: k for k, v in _DIR_NAMES.items()}


@dataclass(frozen=True)
class TraversalPlan:
    """One compiled point query: fuses with plans sharing
    :meth:`fuse_key` (direction + labels; depth is NOT part of the key,
    shallower members deactivate early through the per-job keep mask).

    Mixed-label chains: ``hop_labels`` is a per-hop tuple of label tuples
    (length == depth); ``labels`` is then their union (the snapshot the
    lane leases), and each hop masks the union layout down to its own set
    through per-level slot bitmaps (:func:`hop_label_masks`). Such chains
    fuse only with identical chains, so ``hop_labels`` joins the key."""

    start_ids: tuple
    direction: Direction
    labels: Optional[tuple]          # None = all labels (union if mixed)
    depth: int
    terminal: Union[str, tuple]      # "id" | "count" | ("values", key)
    hop_labels: Optional[tuple] = None   # per-hop label tuples (mixed)

    def fuse_key(self) -> tuple:
        return ("traverse", self.direction, self.labels, self.hop_labels)

    def describe(self) -> str:
        hop = _NAME_OF_DIR[self.direction]
        term = self.terminal if isinstance(self.terminal, str) \
            else f"values({self.terminal[1]})"
        if self.hop_labels is not None:
            hops = "".join(f".{hop}({','.join(ls)})"
                           for ls in self.hop_labels)
            return (f"V({','.join(str(i) for i in self.start_ids)})"
                    f"{hops}.dedup().{term}")
        labs = ",".join(self.labels) if self.labels else ""
        return (f"V({','.join(str(i) for i in self.start_ids)})"
                f".{hop}({labs})x{self.depth}.dedup().{term}")


@dataclass(frozen=True)
class PPRPlan:
    """One user's personalized-PageRank recommendation query: fuses with
    plans sharing the iteration budget, damping and snapshot selection
    into one ``[S, n]`` run
    (``models/pagerank.pagerank_personalized_batched``)."""

    source: int                      # original vertex id
    iterations: int = 20
    damping: float = 0.85
    top_k: int = 10
    labels: Optional[tuple] = None
    directed: bool = False
    include_source: bool = False

    def fuse_key(self) -> tuple:
        return ("ppr", self.iterations, round(float(self.damping), 9),
                self.labels, self.directed)

    def describe(self) -> str:
        return (f"ppr({self.source}, it={self.iterations}, "
                f"d={self.damping}, top{self.top_k})")


def _expand_hops(steps: list, i: int, max_depth: int):
    """Consume the hop run at ``steps[i:]``: plain vsteps and
    repeat(<single vstep>).times(k). Returns (hops, next_i) or None."""
    hops: list = []
    while i < len(steps):
        name, args = steps[i][0], steps[i][1]
        if name == "vstep":
            direction, labels, kind = args
            if kind != "vertex":
                return None
            hops.append((direction, tuple(labels)))
            i += 1
        elif name == "repeat" and i + 1 < len(steps) \
                and steps[i + 1][0] == "times":
            sub, times = args[0], steps[i + 1][1][0]
            body = []
            for sname, sargs in sub._steps:
                if sname != "vstep" or sargs[2] != "vertex":
                    return None
                body.append((sargs[0], tuple(sargs[1])))
            if times < 1:
                return None
            hops.extend(h for _ in range(times) for h in body)
            i += 2
        else:
            break
        if len(hops) > max_depth:
            return None
    return hops, i


def compile_steps(steps: list,
                  max_depth: int = DEFAULT_MAX_DEPTH
                  ) -> Optional[TraversalPlan]:
    """Match a folded dsl step list against the compilable subset; None
    means interpret instead (the loud fallback is the caller's). A hop's
    direction is taken by value, so the dsl's own ``Direction`` members
    compile to the port's."""
    if not steps or steps[0][0] != "V" or not steps[0][1]:
        return None
    got = _expand_hops(steps, 1, max_depth)
    if got is None:
        return None
    hops, i = got
    if not hops:
        return None
    directions = {h[0] for h in hops}
    label_sets = {h[1] for h in hops}
    if len(directions) != 1:
        # mixed directions would need a different CSR orientation per
        # level: the interpreter's job
        return None
    hop_labels = None
    if len(label_sets) != 1:
        # per-hop label changes lease the UNION-label snapshot and mask
        # each level down to its hop's set; an all-labels hop (empty
        # set) inside a labeled chain would need the unfiltered edges
        if any(not h[1] for h in hops):
            return None
        hop_labels = tuple(h[1] for h in hops)
    if i >= len(steps) or steps[i][0] != "dedup":
        # no terminal dedup = path-multiplicity semantics, which a
        # frontier SET machine cannot carry
        return None
    i += 1
    if i >= len(steps):
        return None
    name, args = steps[i][0], steps[i][1]
    if name == "count" and i == len(steps) - 1:
        terminal = "count"
    elif name == "id" and i == len(steps) - 1:
        terminal = "id"
    elif name == "values" and i == len(steps) - 1 \
            and len(args[0]) == 1:
        terminal = ("values", args[0][0])
    else:
        return None
    if hop_labels is not None:
        labels = tuple(sorted({name for ls in hop_labels
                               for name in ls}))
    else:
        labels = label_sets.pop() or None
    return TraversalPlan(tuple(steps[0][1]), Direction(directions.pop()),
                         labels, len(hops), terminal,
                         hop_labels=hop_labels)


def compile_traversal(t, max_depth: int = DEFAULT_MAX_DEPTH
                      ) -> Optional[TraversalPlan]:
    """Compile a dsl ``Traversal`` (folds has-into-start first, exactly
    like the execution path, so ``V(ids)``-rooted chains normalize the
    same way)."""
    from titan_tpu_torch.traversal.dsl import Traversal
    steps = Traversal._fold_has_into_start(list(t._steps))
    return compile_steps(steps, max_depth)


def plan_from_wire(body: dict):
    """Structured ``POST /traverse`` body -> plan. Raises ValueError on
    malformed requests (the 400 path). Depth is NOT gated here: the
    lane's ceiling raises FallbackToInterpreter at submit."""
    kind = body.get("kind", "traverse")
    if kind == "ppr":
        if "source" not in body:
            raise ValueError("ppr needs 'source' (vertex id)")
        iterations = int(body.get("iterations", 20))
        if not 1 <= iterations <= 1000:
            raise ValueError("iterations must be in [1, 1000], "
                             f"got {iterations}")
        damping = float(body.get("damping", 0.85))
        if not 0.0 <= damping < 1.0:
            raise ValueError(f"damping must be in [0, 1), got {damping}")
        top_k = int(body.get("top_k", 10))
        if not 1 <= top_k <= 1000:
            # a recommendation query is bounded by contract
            raise ValueError(f"top_k must be in [1, 1000], got {top_k}")
        labels = _wire_labels(body)
        return PPRPlan(int(body["source"]),
                       iterations=iterations,
                       damping=damping,
                       top_k=top_k,
                       labels=labels,
                       directed=bool(body.get("directed", False)),
                       include_source=bool(
                           body.get("include_source", False)))
    if kind != "traverse":
        raise ValueError(f"unknown interactive kind {kind!r} "
                         "(traverse | ppr)")
    start = body.get("start")
    if not isinstance(start, (list, tuple)):
        # scalar form: a bare vertex id (0 is a valid id)
        start = [start] if start is not None else []
    if not start:
        raise ValueError("traverse needs 'start': [vertex id, ...]")
    dir_name = body.get("dir", "out")
    if dir_name not in _DIR_NAMES:
        raise ValueError(f"dir must be out|in|both, got {dir_name!r}")
    hops = int(body.get("hops", 1))
    if not 1 <= hops <= 32:
        # an unbounded value would build an unbounded step chain
        raise ValueError(f"hops must be in [1, 32], got {hops}")
    term = body.get("terminal", "id")
    if isinstance(term, dict) and "values" in term:
        terminal = ("values", str(term["values"]))
    elif term in ("id", "count"):
        terminal = term
    else:
        raise ValueError("terminal must be 'id', 'count' or "
                         "{'values': <key>}")
    labels = body.get("labels")
    hop_labels = None
    if isinstance(labels, (list, tuple)) and labels \
            and all(isinstance(x, (list, tuple)) for x in labels):
        # per-hop label form: "labels": [["a"], ["b"]], one set per hop
        if len(labels) != hops:
            raise ValueError(
                f"per-hop labels must list one set per hop "
                f"({hops}), got {len(labels)}")
        sets = []
        for ls in labels:
            if not ls or not all(isinstance(x, str) for x in ls):
                raise ValueError(
                    "each per-hop label set must be a non-empty list "
                    f"of label names, got {ls!r}")
            sets.append(tuple(ls))
        if len(set(sets)) > 1:
            hop_labels = tuple(sets)
            wire_labels = tuple(sorted({n for ls in sets for n in ls}))
        else:
            wire_labels = sets[0]
    else:
        wire_labels = _wire_labels(body)
    return TraversalPlan(tuple(int(v) for v in start),
                         _DIR_NAMES[dir_name],
                         wire_labels,
                         hops, terminal, hop_labels=hop_labels)


def _wire_labels(body: dict) -> Optional[tuple]:
    """``labels`` must be a list of names: a bare string would tuple()
    into per-character labels and answer from an empty edge set."""
    labels = body.get("labels")
    if labels is None or labels == []:
        return None
    if not isinstance(labels, (list, tuple)) \
            or not all(isinstance(x, str) for x in labels):
        raise ValueError("labels must be a list of label names, got "
                         f"{labels!r}")
    return tuple(labels)


def traversal_from_plan(plan: TraversalPlan, g):
    """Rebuild the equivalent dsl traversal on ``g`` (duck-typed: a
    traversal source with ``V``, whose steps have ``out``/``in_``/
    ``both``, ``dedup`` and the terminals)."""
    t = g.V(*plan.start_ids)
    step = {"out": "out", "in": "in_", "both": "both"}[
        _NAME_OF_DIR[plan.direction]]
    if plan.hop_labels is not None:
        for ls in plan.hop_labels:
            t = getattr(t, step)(*ls)
    else:
        labels = plan.labels or ()
        for _ in range(plan.depth):
            t = getattr(t, step)(*labels)
    t = t.dedup()
    if plan.terminal == "count":
        return t.count()
    if plan.terminal == "id":
        return t.id_()
    return t.values(plan.terminal[1])


# -- device caches ------------------------------------------------------------

def _by_device(snap, attr: str) -> dict:
    """The snapshot's per-device cache ``attr``, made when absent (a
    snapshot that cannot take the attribute gets a throwaway dict)."""
    cache = getattr(snap, attr, None)
    if cache is None:
        cache = {}
        try:
            setattr(snap, attr, cache)
        except AttributeError:        # __slots__ or a frozen object
            pass
    return cache


def reversed_chunked_csr(snap, device=None) -> dict:
    """Chunked CSR of the REVERSED edges on ``device`` (``None`` means
    CUDA): the ``out()`` orientation (candidate w's chunks hold w's
    IN-neighbours). No sort: the snapshot's arrays are dst-sorted, so
    ``snap.src`` is the in-CSR payload and ``snap.indptr_in`` its index;
    one O(E) layout scatter. Cached on the snapshot in
    ``_hybrid_csr_rev_by_device``; each upload counts once on
    ``obs/devprof``'s ``interactive.rev_csr`` H2D site."""
    dev = cache_key(device)
    cache = _by_device(snap, "_hybrid_csr_rev_by_device")
    got = cache.get(dev)
    if got is not None:
        return got
    n = snap.n
    deg = np.diff(snap.indptr_in).astype(np.int64)       # in-degree
    dstT, colstart, degc, q_total = chunked_layout(
        snap.src, snap.indptr_in, deg, n)
    devprof.count_h2d("interactive.rev_csr",
                      dstT.nbytes + 3 * (n + 1) * 4)
    out = {"dstT": torch.from_numpy(dstT).to(dev),
           "colstart": torch.from_numpy(colstart.astype(np.int32)).to(dev),
           "degc": torch.from_numpy(
               np.concatenate([degc, [0]]).astype(np.int32)).to(dev),
           "deg": torch.from_numpy(
               np.concatenate([deg, [0]]).astype(np.int32)).to(dev),
           "q_total": q_total, "n": n}
    cache[dev] = out
    return out


def hop_label_masks(snap, plan: TraversalPlan, direction,
                    device=None) -> list:
    """Per-hop edge-slot bitmaps for a mixed-label chain over the
    union-label lease, on ``device`` (``None`` means CUDA): hop h's
    bitmap sets the bit of every slot whose edge label is NOT in hop h's
    set (1 = not a parent this level; the overlay tombstone packing,
    byte = chunk column, bit = lane), for
    ``frontier_bfs_batched(level_masks=)``.

    Built on the layout the chain sweeps: the forward chunked CSR
    (``both``/``in_``: labels permuted through ``_out_csr_order``) or the
    reversed one (``out()``: labels align with the dst-sorted rows).
    Hops sharing a label set share one bitmap; the masks are cached on
    the snapshot in ``_hop_label_masks_by_device`` per (direction, hop
    chain) and upload once (``interactive.label_masks`` H2D site).

    Raises FallbackToInterpreter when the lease carries no label codes."""
    if snap.labels is None:
        raise FallbackToInterpreter(
            "mixed-label chain over a snapshot without label codes")
    dev = cache_key(device)
    direction = Direction(direction)
    cache = _by_device(snap, "_hop_label_masks_by_device") \
        .setdefault(dev, {})
    key = (direction, plan.hop_labels)
    got = cache.get(key)
    if got is not None:
        return got
    n = snap.n
    if direction is Direction.OUT:
        # reversed layout: the payload is snap.src in dst-sorted order,
        # so the labels align 1:1
        deg = np.diff(snap.indptr_in).astype(np.int64)
        pos, colstart, _degc = layout_slot_positions(
            snap.indptr_in, deg, n)
        labs = snap.labels
    else:
        _dst_by_src, indptr_out = snap.out_csr()
        deg = snap.out_degree.astype(np.int64)
        pos, colstart, _degc = layout_slot_positions(
            indptr_out, deg, n)
        labs = snap.labels[snap._out_csr_order]
    q_total = int(colstart[-1]) + 1
    code_of = {v: k for k, v in snap.label_names.items()}
    masks: list = []
    by_set: dict = {}
    total_bytes = 0
    for ls in plan.hop_labels:
        mask = by_set.get(ls)
        if mask is None:
            codes = [code_of[name] for name in ls if name in code_of]
            dead = ~np.isin(labs, np.asarray(codes, np.int32))
            tomb = np.zeros(q_total, np.uint8)
            p = pos[dead]
            np.bitwise_or.at(tomb, p >> 3,
                             np.uint8(1) << (p & 7).astype(np.uint8))
            mask = torch.from_numpy(tomb).to(dev)
            by_set[ls] = mask
            total_bytes += tomb.nbytes
        masks.append(mask)
    devprof.count_h2d("interactive.label_masks", total_bytes)
    cache[key] = masks
    return masks
