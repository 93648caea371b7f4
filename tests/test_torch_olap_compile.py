"""The port's compiled traversal path (titan_tpu_torch/traversal/
olap_compile.py) against the JAX package's, on the CPU.

On twin graphs (tests/torch_twins.py: the same seeded operations in both
packages, so ids agree) ``try_compile`` gives JAX's plans for the chain
catalogue of tests/test_olap_compile.py (directions by name, predicates
by op and value); the compiled path on ``device="cpu"`` gives the port's
interpreter's answers and JAX's compiled answers (integers and ids
exact, ``sum``/``mean`` bit-equal: the same float64 dot product); the
explicit and auto snapshot guards raise or fall back as JAX's do, with
JAX's messages. The port counts in int64: on K_50 at 6 hops it gives the
interpreter's 50 * 49^6, where JAX's int32 counts wrap (ROADMAP queue 3,
item 10). A port traversal compiles onto the interactive lane and
answers as the JAX lane does for the JAX traversal."""

import importlib

import pytest
import torch

from titan_tpu.olap.serving.interactive import compile as JComp
from titan_tpu.olap.serving.scheduler import JobScheduler as JaxScheduler
from titan_tpu.olap.tpu import snapshot as JS
from titan_tpu.traversal import olap_compile as JOC
from titan_tpu_torch.obs import devprof
from titan_tpu_torch.olap import snapshot as PS
from titan_tpu_torch.olap.serving import JobScheduler
from titan_tpu_torch.olap.serving.interactive import compile as PComp
from titan_tpu_torch.traversal import olap_compile as POC

from torch_twins import PKGS, canon, complete, people

def source(g, which: str, compiled: bool, snapshot=None):
    """The interpreter's source, or the package's compiled computer."""
    t = g.traversal()
    if not compiled:
        return t
    if which == "jax":
        return t.with_computer("tpu", snapshot=snapshot)
    return t.with_computer("gpu", snapshot=snapshot, device="cpu")


#: tests/test_olap_compile.py's chains (and the matcher's refusals), as
#: builders of (traversal source, P, anon, a start id)
CHAINS = {
    "two_hop_count": lambda t, P, A, v: t.V().out().out().count(),
    "labeled_count": lambda t, P, A, v: t.V().out("knows").count(),
    "in_then_out": lambda t, P, A, v: t.V().in_("likes").out("knows")
    .count(),
    "both_count": lambda t, P, A, v: t.V().both().count(),
    "dedup_count": lambda t, P, A, v: t.V().out().out().dedup().count(),
    "ids_then_id": lambda t, P, A, v: t.V(v).out().id_(),
    "repeat_times": lambda t, P, A, v: t.V().repeat(A().out()).times(3)
    .count(),
    "has_start": lambda t, P, A, v: t.V().has("name", "p0").out().count(),
    "vertices": lambda t, P, A, v: t.V().out("knows").dedup(),
    "start_dedup": lambda t, P, A, v: t.V(v, v).dedup().count(),
    "start_dedup_out": lambda t, P, A, v: t.V(v, v).dedup().out().count(),
    "midchain_gt": lambda t, P, A, v: t.V().out("knows")
    .has("age", P.gt(40)).count(),
    "midchain_lte": lambda t, P, A, v: t.V().out().has("age", P.lte(30))
    .out("likes").count(),
    "midchain_eq_dedup": lambda t, P, A, v: t.V().out().has("age", 27)
    .dedup().count(),
    "values_sum": lambda t, P, A, v: t.V().out("knows").values("age")
    .sum_(),
    "values_mean": lambda t, P, A, v: t.V().out().out().values("age")
    .mean(),
    "values": lambda t, P, A, v: t.V().out("likes").values("age"),
    "group_count_key": lambda t, P, A, v: t.V().out("knows")
    .group_count("age"),
    "group_count_by": lambda t, P, A, v: t.V().out().group_count()
    .by("name"),
    "group_count": lambda t, P, A, v: t.V().out().group_count(),
    "group_count_id": lambda t, P, A, v: t.V().out("knows")
    .group_count("id"),
    "group_count_label": lambda t, P, A, v: t.V().out("knows")
    .group_count("label"),
    "group_count_missing": lambda t, P, A, v: t.V().out("knows")
    .group_count("nickname"),
    "ldbc_is3": lambda t, P, A, v: t.V(v).out("knows").out("knows")
    .out("knows").out("knows").count(),
    "empty_sum": lambda t, P, A, v: t.V().out("knows")
    .has("age", P.gt(10 ** 6)).values("age").sum_(),
    "has_values": lambda t, P, A, v: t.V().has("name", "p3")
    .values("name"),
    "both_labeled_dedup_id": lambda t, P, A, v: t.V(v).both("knows")
    .dedup().both().dedup().id_(),
    "limit": lambda t, P, A, v: t.V().out().limit(3),
    "two_keys": lambda t, P, A, v: t.V().values("name", "age"),
    "order": lambda t, P, A, v: t.V().out().order(),
    "unlabeled_has": lambda t, P, A, v: t.V().out().has("age", P.gt(25))
    .count(),
    "pseudo_label": lambda t, P, A, v: t.V().has("label", "person")
    .out().count(),
}
#: the chains that do not compile (try_compile returns None in both
#: packages; the interpreter answers)
REFUSED = {"group_count_label", "limit", "two_keys", "order",
           "pseudo_label", "midchain_eq_dedup"}


@pytest.fixture(scope="module")
def twins():
    out = {w: people(w) for w in PKGS}
    yield out
    for g in out.values():
        g.close()


def start_id(g) -> int:
    tx = g.new_transaction()
    vid = min(v.id for v in tx.vertices())
    tx.rollback()
    return vid


def build(twins, which, name, compiled, snapshot=None):
    g = twins[which]
    _, _, P, dsl, _ = PKGS[which]
    return CHAINS[name](source(g, which, compiled, snapshot), P, dsl.anon,
                        start_id(g))


def plan_of(ct):
    """A compiled plan in a form both packages share."""
    if ct is None:
        return None
    ops = []
    for op in ct.ops:
        if op[0] == "expand":
            ops.append(("expand", op[1].name, op[2], op[3]))
        else:
            ops.append(("filter", op[1], op[2].op, op[2].value))
    start = ct.start
    if start[0] == "query":
        start = ("query", tuple((n, tuple(
            (a.op, a.value) if type(a).__name__ == "P" else a
            for a in args)) for n, args in start[1]))
    return start, tuple(ops), ct.terminal, ct.dedup_start


def compiled_of(t, oc):
    steps = type(t)._fold_has_into_start(list(t._steps))
    return oc.try_compile(steps, t.source)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_try_compile_gives_the_jax_plan(twins, name):
    jct = compiled_of(build(twins, "jax", name, True), JOC)
    pct = compiled_of(build(twins, "port", name, True), POC)
    assert (pct is None) == (name in REFUSED)
    assert plan_of(pct) == plan_of(jct)


def answer(t):
    return sorted(map(canon, t.to_list()), key=repr)


@pytest.mark.parametrize("name", sorted(set(CHAINS) - {"order"}))
def test_compiled_equals_the_interpreter_and_jax(twins, name):
    """(``order()`` of vertices raises in both interpreters: it is a
    matcher refusal only.) ``sum`` is a float on the compiled path and
    an int in the interpreter, equal in value."""
    port_compiled = answer(build(twins, "port", name, True))
    assert port_compiled == answer(build(twins, "port", name, False))
    assert port_compiled == answer(build(twins, "jax", name, True))


@pytest.mark.parametrize("chain", [
    lambda t, A, v: t.V().out("knows"),
    lambda t, A, v: t.V().repeat(A().both()).times(2).id_(),
    lambda t, A, v: t.V(v, v).out().out()])
def test_vertex_terminal_keeps_path_multiplicity(twins, chain):
    """ROADMAP queue 3, item 11: JAX's compiled vertex terminal yields each
    reached vertex once; the interpreter, and the port's compiled path,
    one per path. Its id terminal keeps them in both packages."""
    got = {}
    for which in PKGS:
        g, A = twins[which], PKGS[which][3].anon
        v = start_id(g)
        got[which] = [answer(chain(source(g, which, c), A, v))
                      for c in (False, True)]
    (jax_interp, jax_compiled), (port_interp, port_compiled) = \
        got["jax"], got["port"]
    assert port_compiled == port_interp == jax_interp
    assert len(port_compiled) > len(set(map(repr, port_compiled)))
    if isinstance(port_compiled[0], tuple):          # vertices
        assert jax_compiled == sorted({repr(x): x for x in jax_interp}
                                      .values(), key=repr)
    else:                                            # ids
        assert jax_compiled == jax_interp


def test_float_terminals_are_bit_equal_to_jax(twins):
    for name in ("values_sum", "values_mean"):
        (j,) = build(twins, "jax", name, True).to_list()
        (p,) = build(twins, "port", name, True).to_list()
        assert isinstance(p, float) and p == j, name


def test_profile_reports_one_compiled_step(twins):
    m = build(twins, "port", "two_hop_count", True).profile()
    assert m.compiled and [s.name for s in m.steps] == ["olap(compiled)"]
    assert m.steps[0].count == 1
    m = build(twins, "port", "limit", True).profile()
    assert not m.compiled
    assert not build(twins, "port", "two_hop_count", False).profile() \
        .compiled


def test_the_computer_is_gpu_and_cuda_by_default(twins, monkeypatch):
    g = twins["port"]
    with pytest.raises(ValueError, match="'gpu'"):
        g.traversal().with_computer("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.traversal().with_computer("gpu")
    with pytest.raises(RuntimeError):
        g.traversal().with_computer()
    # None interprets, as in JAX
    t = g.traversal().with_computer(None).V().out().out().count()
    assert t.profile().compiled is False


def test_a_device_error_is_not_turned_into_interpretation(twins,
                                                          monkeypatch):
    def broken(*args):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(POC, "_supersteps", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        build(twins, "port", "two_hop_count", True).to_list()


def test_counts_are_int64_and_transfers_are_counted(twins, monkeypatch):
    seen = []
    real = POC._supersteps

    def spy(counts, src, dst, masks, sig):
        seen.append((counts.dtype, src.data_ptr(), dst.data_ptr()))
        return real(counts, src, dst, masks, sig)
    monkeypatch.setattr(POC, "_supersteps", spy)
    g = twins["port"]
    snap = PS.build(g)
    try:
        with devprof.DeviceCostProfiler() as prof:
            for _ in range(2):
                t = g.traversal().with_computer("gpu", snapshot=snap,
                                                device="cpu")
                t.V().out("knows").has("age", 27).out().count().to_list()
            stats = prof.stats()
            kernels = prof.kernel_stats()
    finally:
        snap.close()
    assert [s[0] for s in seen] == [torch.int64, torch.int64]
    # the edge arrays went up once: both runs read the same tensors
    assert seen[0][1:] == seen[1][1:]
    assert kernels["traversal.supersteps"]["calls"] == 2
    n, e = snap.n, snap.num_edges
    # each run: the start counts, the label mask, the has() mask up; the
    # final counts back
    assert stats["d2h_bytes"] == 2 * 8 * n
    graph = 2 * 4 * e + 4 * n + n       # src, dst, last_idx, seg_has
    assert stats["h2d_bytes"] == graph + 2 * (8 * n + e + n)


# -- the snapshot guards -------------------------------------------------------

def both_raise(run_j, run_p, match):
    with pytest.raises(ValueError, match=match) as je:
        run_j()
    with pytest.raises(ValueError, match=match) as pe:
        run_p()
    assert str(pe.value) == str(je.value)


def stripped(snap_mod, full):
    return snap_mod.from_arrays(full.n, full.src, full.dst, full.vertex_ids)


def test_label_filter_without_codes_raises_on_an_explicit_snapshot(twins):
    snaps = {"jax": stripped(JS, JS.build(twins["jax"])),
             "port": stripped(PS, PS.build(twins["port"]))}

    def run(which, name):
        return lambda: build(twins, which, name, True,
                             snaps[which]).to_list()
    both_raise(run("jax", "labeled_count"), run("port", "labeled_count"),
               "label")
    # unfiltered steps on the same snapshot still run on the device
    assert answer(build(twins, "port", "two_hop_count", True,
                        snaps["port"])) == \
        answer(build(twins, "jax", "two_hop_count", True, snaps["jax"]))


def test_unbound_snapshot_refuses_column_build(twins):
    snaps = {"jax": stripped(JS, JS.build(twins["jax"])),
             "port": stripped(PS, PS.build(twins["port"]))}

    def run(which):
        return lambda: build(twins, which, "unlabeled_has", True,
                             snaps[which]).to_list()
    both_raise(run("jax"), run("port"), "not bound")
    for which in PKGS:
        snaps[which].attach_vertex_values(twins[which], ["age"])
    assert run("port")() == run("jax")() == \
        build(twins, "port", "unlabeled_has", False).to_list()


def fresh_people(which):
    return people(which, seed=5, n=30, m=120)


def test_stale_explicit_snapshot_refuses_then_refresh_heals():
    gs = {w: fresh_people(w) for w in PKGS}
    try:
        snaps = {"jax": JS.build(gs["jax"]), "port": PS.build(gs["port"])}
        for g in gs.values():
            tx = g.new_transaction()
            v = tx.vertex(start_id(g))
            v.property("age", 1)
            tx.commit()
        assert all(s.stale for s in snaps.values())

        def run(which):
            return lambda: CHAINS["midchain_gt"](
                source(gs[which], which, True, snaps[which]),
                PKGS[which][2], None, None).to_list()
        both_raise(run("jax"), run("port"), "stale")
        for which in PKGS:
            snaps[which].refresh()
        got = run("port")()
        gs["port"].tx().rollback()
        assert got == run("jax")() == CHAINS["midchain_gt"](
            gs["port"].traversal(), PKGS["port"][2], None, None).to_list()
        for s in snaps.values():
            s.close()
    finally:
        for g in gs.values():
            g.close()


def test_stale_auto_snapshot_falls_back_to_the_interpreter():
    gs = {w: fresh_people(w) for w in PKGS}
    try:
        got = {}
        for which, g in gs.items():
            src = source(g, which, True)
            src.V().out().count().to_list()        # builds the auto snapshot
            assert src._snapshot._auto_built
            tx = g.new_transaction()
            tx.vertex(start_id(g)).property("age", 1)
            tx.commit()
            g.tx().rollback()
            P = PKGS[which][2]
            got[which] = src.V().out("knows").has("age", P.gt(25)).count() \
                .to_list()
            assert got[which] == g.traversal().V().out("knows") \
                .has("age", P.gt(25)).count().to_list()
        assert got["port"] == got["jax"]
    finally:
        for g in gs.values():
            g.close()


def test_refresh_invalidates_property_columns():
    gs = {w: fresh_people(w) for w in PKGS}
    try:
        for which, g in gs.items():
            snap = (JS if which == "jax" else PS).build(g)
            P = PKGS[which][2]

            def chain(t):
                return t.V().out("knows").has("age", P.gt(25)).count()
            assert chain(source(g, which, True, snap)).to_list() == \
                chain(g.traversal()).to_list()
            tx = g.new_transaction()
            for v in list(tx.vertices()):
                if (v.value("age") or 0) > 25:
                    v.property("age", 0)
            tx.commit()
            snap.refresh()
            g.tx().rollback()
            assert chain(source(g, which, True, snap)).to_list() == \
                chain(g.traversal()).to_list() == [0]
            snap.close()
    finally:
        for g in gs.values():
            g.close()


# -- past 2^31 paths at a vertex -----------------------------------------------

def int32_wrap(x: int) -> int:
    x %= 1 << 32
    return x - (1 << 32) if x >= 1 << 31 else x


@pytest.fixture(scope="module")
def k50():
    out = {w: complete(w, 50) for w in PKGS}
    yield out
    for g in out.values():
        g.close()


@pytest.mark.parametrize("hops", [5, 6])
def test_k50_counts_equal_the_interpreter_past_2_31(k50, hops):
    """K_50 at 6 hops: 50 * 49^6 paths, 49^6 = 13,841,287,201 at each
    vertex, past 2^31. The port's compiled count equals its interpreter
    and the exact number; at 5 hops JAX agrees too."""
    g = k50["port"]
    A = PKGS["port"][3].anon
    exact = 50 * 49 ** hops
    got = source(g, "port", True).V().repeat(A().out()).times(hops) \
        .count().to_list()
    assert got == source(g, "port", False).V().repeat(A().out()) \
        .times(hops).count().to_list() == [exact]
    if hops == 5:
        JA = PKGS["jax"][3].anon
        assert source(k50["jax"], "jax", True).V().repeat(JA().out()) \
            .times(hops).count().to_list() == [exact]


def test_jax_compiled_counts_wrap_at_2_31(k50):
    """ROADMAP queue 3, item 10: JAX's compiled counts are int32 (x64
    off), so at 6 hops each vertex's 49^6 wraps mod 2^32 and the count is
    50 * 956,385,313 = 47,819,265,650, not the interpreter's
    692,064,360,050. Hold such chains to the interpreter, never to JAX."""
    g = k50["jax"]
    A = PKGS["jax"][3].anon
    got = source(g, "jax", True).V().repeat(A().out()).times(6).count() \
        .to_list()
    assert got == [50 * int32_wrap(49 ** 6)] == [47_819_265_650]
    assert got != source(g, "jax", False).V().repeat(A().out()).times(6) \
        .count().to_list()


def test_self_loop_in_diverges_between_interpreter_and_compiled():
    """ROADMAP queue 3, item 13: a vertex a with edges a->a and a->b. In
    both packages the interpreter never yields the loop under ``in()``
    (the loop's IN entry resolves to OUT), yields it twice under
    ``both()``, and the transaction's edge reads count it once
    (``vertex_edges``) or twice (``multi_vertex_edges``) under BOTH; the
    compiled path reads the snapshot's (a, a) row and gives ``in()`` =
    [a]. Hold no ``in()``/``both()`` chain on a graph with loops compiled
    against interpreted."""
    got = {}
    for which in PKGS:
        pkg, place, _, dsl = PKGS[which][:4]
        g = pkg.open("inmemory")
        g.id_assigner.placement = place(g.idm.num_partitions, batch_size=5,
                                        seed=11)
        try:
            tx = g.new_transaction()
            a, b = tx.add_vertex("node"), tx.add_vertex("node")
            tx.add_edge(a, "link", a)
            tx.add_edge(a, "link", b)
            tx.commit()
            D = importlib.import_module(
                f"{pkg.__name__}.core.defs").Direction
            t = g.traversal()

            def ids(trav):
                return [v.id for v in trav.to_list()]
            interp = (ids(t.V(a.id).out()), ids(t.V(a.id).in_()),
                      ids(t.V(a.id).both()))
            tx = g.new_transaction(read_only=True)
            single = [len(list(tx.vertex_edges(a.id, d)))
                      for d in (D.OUT, D.IN, D.BOTH)]
            multi = [len(tx.multi_vertex_edges([a.id], d)[a.id])
                     for d in (D.OUT, D.IN, D.BOTH)]
            tx.rollback()
            compiled = ids(source(g, which, True).V(a.id).in_())
            got[which] = (a.id, b.id, interp, single, multi, compiled)
        finally:
            g.close()
    assert got["port"] == got["jax"]
    a, b, interp, single, multi, compiled = got["port"]
    assert interp == (sorted([a, b]), [], sorted([a, a, b]))
    assert single == [2, 0, 2] and multi == [2, 0, 3]
    assert compiled == [a]


# -- the interactive lane ------------------------------------------------------

LANE_CHAINS = [
    lambda t, A, v: t.V(v).out().out().dedup().id_(),
    lambda t, A, v: t.V(v).both("knows").both("knows").dedup().count(),
    lambda t, A, v: t.V(v).repeat(A().in_("likes")).times(2).dedup()
    .values("name"),
    lambda t, A, v: t.V(v).out("knows").out("likes").dedup().id_(),
    lambda t, A, v: t.V(v).out().id_(),                  # no dedup
]


def test_a_port_traversal_answers_on_the_lane_as_jax(twins):
    """compile_traversal of a port traversal, submitted to
    ``JobScheduler.interactive()``, answers as the JAX lane does for the
    JAX traversal; what does not compile falls back in both, and a chain
    past the lane's ceiling raises the one FallbackToInterpreter class of
    traversal/olap_compile."""
    assert PComp.FallbackToInterpreter is POC.FallbackToInterpreter
    gj, gp = twins["jax"], twins["port"]
    js = JS.build(gj, directed=False)
    js.attach_vertex_values(gj, ["name"])
    ps = PS.build(gp, directed=False)
    ps.attach_vertex_values(gp, ["name"])
    jsch = JaxScheduler(snapshot=js)
    psch = JobScheduler(snapshot=ps, device="cpu")
    try:
        jl, pl = jsch.interactive(), psch.interactive()
        v = start_id(gp)
        answered = 0
        for chain in LANE_CHAINS:
            jp = JComp.compile_traversal(chain(gj.traversal(),
                                               PKGS["jax"][3].anon, v))
            pp = PComp.compile_traversal(chain(gp.traversal(),
                                               PKGS["port"][3].anon, v))
            assert (jp is None) == (pp is None)
            if pp is None:
                continue
            jr, pr = jl.submit(jp), pl.submit(pp)
            assert sorted(map(repr, canon(pr["result"]))) == \
                sorted(map(repr, canon(jr["result"]))) \
                if isinstance(pr["result"], list) \
                else pr["result"] == jr["result"]
            assert pr["hops"] == jr["hops"]
            answered += 1
        assert answered == 4
        deep = gp.traversal().V(v)
        for _ in range(PComp.DEFAULT_MAX_DEPTH + 1):
            deep = deep.out()
        plan = PComp.compile_traversal(deep.dedup().count(), max_depth=8)
        with pytest.raises(POC.FallbackToInterpreter):
            pl.submit(plan)
    finally:
        jsch.close()
        psch.close()
        js.close()
        ps.close()
