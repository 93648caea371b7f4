"""Closed-loop autotuning: the telemetry plane drives the serving knobs.

The port's copy of ``titan_tpu/olap/serving/autotune.py``. The signals
(SLO burn rates, per-tenant device-seconds, per-kernel device cost,
queue depth, overlay fill, replay cost) exist without it, and every
control knob is static configuration. This module closes
the loop with a :class:`Controller` the :class:`JobScheduler` owns: on
a fixed tick (injectable clock, like ``obs/slo.py``) it reads its
signals EXCLUSIVELY through the existing metric/SLO registries and
applies bounded, hysteresis-guarded rules to the knobs:

* **batch K** (``batcher.target_k``) — grow the batcher's target K
  while recent batch occupancy runs near the current target and no p95
  burn is spending budget; shrink it back when occupancy collapses.
  Steps are multiplicative (×2 / ÷2), clamped to ``[k_min, k_cap]``,
  one move per cooldown window.
* **tenant shed / restore** (``tenant.quota_scale.<tenant>``) — when an
  SLO burn spikes past ``shed_burn``, halve the quota scale of the
  biggest recent device-seconds consumer that no objective protects
  (quotas already answer retryable 429s — the controller flips a SCALE
  on the configured quota, never hard state); when every burn recedes
  under ``restore_burn``, scales double back toward 1.0, one tenant per
  tick.
* **compaction trigger** (``live.compact``) — predict the device-merge
  wall from devprof-measured per-row merge cost × (base + overlay)
  rows, weigh it against the overlay scan penalty the current job rate
  pays per tick, and trigger the epoch fold when deferring costs more
  than merging — instead of waiting for the plane's fixed fill
  fraction.
* **checkpoint cadence** (``recovery.checkpoint_every``, stretch) —
  Young's approximation ``every ≈ sqrt(2 · c · R)`` from the measured
  checkpoint commit cost ``c`` (in rounds, via the device round wall)
  and the measured replay-per-failure ``R``; applied as the default
  cadence for retryable jobs that did not pick their own.

**Shadow mode is the default** (``JobScheduler(autotune=...)`` /
``TITAN_TPU_AUTOTUNE``; ``"enforce"`` opts in): decisions are computed,
journaled and exported, but NO knob moves — serving behavior and every
pre-existing metric family stay byte-identical with the controller off
(regression-pinned in tests/test_autotune.py). Signal reads are
strictly non-creating (``MetricManager.histogram_stats`` & friends) so
shadow observation cannot mint registry entries either.

**Every decision is explainable from the journal alone**: each entry
carries the full signal snapshot the rules consumed (knob state
included), the rule id, old→new value, the rule parameters and the
cooldown it armed — :func:`replay` re-runs the SAME pure rule functions
on a journaled entry and must reproduce its decision (the
"explainable" guarantee, pinned by the replay test). The journal is
bounded (oldest dropped, counted); it surfaces via ``GET /controller``,
rides in flight-recorder postmortem bundles (``state.controller``), is
stitched as ``controller`` spans into the traces of jobs running under
freshly-applied decisions, and exports as ``controller.*`` labeled
metrics (docs/monitoring.md).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

from titan_tpu_torch.olap.serving.tenants import TenantQuota
from titan_tpu_torch.utils.metrics import MetricManager

MODES = ("shadow", "enforce")

#: knob identifiers (journal ``knob`` field; tenant scales append the
#: tenant: ``tenant.quota_scale.<tenant>``)
KNOB_K = "batcher.target_k"
KNOB_SCALE = "tenant.quota_scale"
KNOB_COMPACT = "live.compact"
KNOB_CKPT = "recovery.checkpoint_every"
KNOB_FLEET = "fleet.routing_weight"

#: rule parameter defaults. Every decision records the EFFECTIVE params
#: it was evaluated under, so a journaled entry replays bit-equal even
#: after the controller is reconfigured.
DEFAULT_PARAMS = {
    # batch-K rule
    "k_min": 1,
    "k_cap": 32,
    "grow_occupancy": 0.9,     # recent mean K >= frac * target → grow
    "shrink_occupancy": 0.25,  # recent mean K <= frac * target → shrink
    "burn_ceiling": 1.0,       # any p95 burn above this blocks growth
    "k_cooldown_s": 10.0,
    # tenant shed/restore rule
    "shed_burn": 2.0,          # fast-window burn that triggers a shed
    "restore_burn": 0.5,       # every burn under this → restore
    "scale_min": 0.25,         # shed floor (scales halve per decision)
    "shed_cooldown_s": 10.0,
    # compaction rule
    "compact_min_rows": 64,    # overlay rows before the rule engages
    "compact_cooldown_s": 5.0,
    "overlay_us_per_row": 0.5,  # per-job overlay scan penalty model
    "merge_us_per_row": 0.05,   # merge-cost fallback when unmeasured
    # checkpoint-cadence rule
    "ckpt_min_every": 1,
    "ckpt_max_every": 64,
    "ckpt_cooldown_s": 30.0,
    # fleet routing-weight rule (olap/fleet: the router's controller
    # feeds a "fleet" signal block; the scheduler-side controller never
    # produces one, so this rule is inert there)
    "fleet_spread_high": 1.0,   # (max-min)/mean depth that biases harder
    "fleet_spread_low": 0.25,   # spread under which the bias decays back
    "fleet_weight_cap": 8.0,
    "fleet_cooldown_s": 5.0,
}

DEFAULT_TICK_S = 1.0
DEFAULT_JOURNAL_CAP = 256


def resolve_mode(value) -> str:
    """``JobScheduler(autotune=)`` / TITAN_TPU_AUTOTUNE → a mode:
    ``"off"`` (no controller), ``"shadow"`` (default) or
    ``"enforce"``."""
    if value is None or value == "":
        return "shadow"
    v = str(value).strip().lower()
    if v in ("0", "false", "off", "none", "disabled"):
        return "off"
    if v in ("1", "true", "on", "enforce", "enforced"):
        return "enforce"
    if v in ("shadow", "default"):
        return "shadow"
    raise ValueError(f"autotune mode {value!r} not in "
                     f"('off', 'shadow', 'enforce')")


# -- pure rules --------------------------------------------------------------
#
# Each rule is a pure function of (signals, knob state, params) →
# proposals. tick() and replay() call the SAME functions — this is what
# makes every journal entry reconstructible from its snapshot alone.


def _rule_batch_k(sig: dict, knobs: dict, p: dict) -> list:
    occ = sig.get("occupancy") or {}
    recent = occ.get("recent_mean")
    if recent is None:
        return []                 # no executed batch since last tick
    k = int(knobs["target_k"])
    burn = float(sig.get("burn_max") or 0.0)
    if recent >= p["grow_occupancy"] * k and burn <= p["burn_ceiling"] \
            and k < p["k_cap"]:
        return [{"rule": "batch_k.grow", "knob": KNOB_K, "old": k,
                 "new": min(int(p["k_cap"]), k * 2),
                 "why": (f"recent occupancy {recent:.2f} >= "
                         f"{p['grow_occupancy']:.2f}*K={k} and max burn "
                         f"{burn:.3f} <= {p['burn_ceiling']:.2f}")}]
    if recent <= p["shrink_occupancy"] * k and k > p["k_min"]:
        return [{"rule": "batch_k.shrink", "knob": KNOB_K, "old": k,
                 "new": max(int(p["k_min"]), k // 2),
                 "why": (f"recent occupancy {recent:.2f} <= "
                         f"{p['shrink_occupancy']:.2f}*K={k}")}]
    return []


def _rule_tenant(sig: dict, knobs: dict, p: dict) -> list:
    burn = float(sig.get("burn_max") or 0.0)
    scales = knobs.get("scales") or {}
    if burn >= p["shed_burn"]:
        protected = set(sig.get("protected_tenants") or ())
        deltas = sig.get("tenant_device_s_delta") or {}
        tens = sig.get("tenants") or {}
        cands = []
        for t, row in tens.items():
            if t in protected or scales.get(t, 1.0) <= p["scale_min"]:
                continue
            d = float(deltas.get(t, 0.0))
            if d > 0 or row.get("in_flight", 0) > 0:
                cands.append((-d, t))
        if not cands:
            return []
        cands.sort()              # biggest recent consumer, then name
        t = cands[0][1]
        old = scales.get(t, 1.0)
        return [{"rule": "tenant.shed", "knob": f"{KNOB_SCALE}.{t}",
                 "old": old, "new": max(p["scale_min"], old / 2),
                 "tenant": t,
                 "why": (f"burn {burn:.3f} ({sig.get('burn_max_slo')}) "
                         f">= shed_burn {p['shed_burn']:.2f}; tenant "
                         f"{t!r} is the largest unprotected consumer "
                         f"(+{float((sig.get('tenant_device_s_delta') or {}).get(t, 0.0)):.4f} dev-s)")}]
    if burn <= p["restore_burn"]:
        for t in sorted(scales):
            old = scales[t]
            if old < 1.0:
                return [{"rule": "tenant.restore",
                         "knob": f"{KNOB_SCALE}.{t}", "old": old,
                         "new": min(1.0, old * 2), "tenant": t,
                         "why": (f"max burn {burn:.3f} <= restore_burn "
                                 f"{p['restore_burn']:.2f}")}]
    return []


def _rule_compact(sig: dict, knobs: dict, p: dict) -> list:
    live = sig.get("live")
    if not live:
        return []
    rows = int(live.get("overlay_rows") or 0) \
        + int(live.get("tombs") or 0)
    if rows < p["compact_min_rows"]:
        return []
    merge_us = live.get("merge_us_per_row")
    if merge_us is None:
        merge_us = p["merge_us_per_row"]
    base = int(live.get("base_edges") or 0)
    merge_ms = float(merge_us) * (base + rows) / 1e3
    jobs = int(sig.get("jobs_delta") or 0)
    defer_ms = rows * p["overlay_us_per_row"] / 1e3 * jobs
    if defer_ms >= merge_ms:
        return [{"rule": "live.compact", "knob": KNOB_COMPACT,
                 "old": "deferred", "new": "compact",
                 "why": (f"predicted merge {merge_ms:.3f}ms "
                         f"({merge_us:.4f}us/row x {base + rows} rows) "
                         f"<= one tick's overlay scan penalty "
                         f"{defer_ms:.3f}ms ({rows} rows x {jobs} "
                         f"jobs)")}]
    return []


def _rule_ckpt(sig: dict, knobs: dict, p: dict) -> list:
    rec = sig.get("recovery") or {}
    if not rec.get("retries_delta"):
        return []                 # cadence updates only on failure news
    c_ms = rec.get("checkpoint_ms_mean")
    r_ms = rec.get("round_ms_mean")
    retries = int(rec.get("retries_delta") or 0)
    replayed = int(rec.get("replayed_delta") or 0)
    if not c_ms or not r_ms or retries <= 0 or replayed <= 0:
        return []
    cost_rounds = float(c_ms) / float(r_ms)     # checkpoint cost, rounds
    replay_per_failure = replayed / retries     # measured MTBF proxy
    every = int(round(math.sqrt(2.0 * cost_rounds * replay_per_failure)))
    every = max(int(p["ckpt_min_every"]),
                min(int(p["ckpt_max_every"]), every))
    old = int(knobs.get("checkpoint_every") or 0)
    if every == old:
        return []
    return [{"rule": "recovery.cadence", "knob": KNOB_CKPT, "old": old,
             "new": every,
             "why": (f"Young: sqrt(2 x {cost_rounds:.3f} ckpt-rounds x "
                     f"{replay_per_failure:.1f} replay/failure) -> "
                     f"every {every}")}]


def _rule_fleet(sig: dict, knobs: dict, p: dict) -> list:
    """Fleet routing-weight rule (olap/fleet): the router's
    controller injects a ``fleet`` signal block — per-replica in-flight
    ``depth_spread`` ((max-min)/mean). A wide spread means the weighted
    pick is not steering hard enough toward idle replicas: double the
    ``depth`` weight (capped); a collapsed spread decays it back toward
    the neutral 1.0. Scheduler-side controllers never collect a
    ``fleet`` block, so the rule is inert there by construction."""
    fl = sig.get("fleet")
    if not fl:
        return []
    spread = fl.get("depth_spread")
    if spread is None:
        return []
    spread = float(spread)
    weights = knobs.get("fleet_weights") or {}
    w = float(weights.get("depth", 1.0))
    if spread >= p["fleet_spread_high"] and w < p["fleet_weight_cap"]:
        new = min(float(p["fleet_weight_cap"]), w * 2)
        return [{"rule": "fleet.rebalance",
                 "knob": f"{KNOB_FLEET}.depth", "old": w, "new": new,
                 "signal": "depth",
                 "why": (f"in-flight depth spread {spread:.2f} >= "
                         f"{p['fleet_spread_high']:.2f}: bias routing "
                         f"harder toward idle replicas")}]
    if spread <= p["fleet_spread_low"] and w > 1.0:
        return [{"rule": "fleet.relax",
                 "knob": f"{KNOB_FLEET}.depth", "old": w,
                 "new": max(1.0, w / 2), "signal": "depth",
                 "why": (f"depth spread {spread:.2f} <= "
                         f"{p['fleet_spread_low']:.2f}: decay the "
                         f"routing bias back toward neutral")}]
    return []


#: rule id prefix → (evaluator, cooldown param) — tick and replay
#: dispatch through this one table
_RULES = (
    (_rule_batch_k, "k_cooldown_s"),
    (_rule_tenant, "shed_cooldown_s"),
    (_rule_compact, "compact_cooldown_s"),
    (_rule_ckpt, "ckpt_cooldown_s"),
    (_rule_fleet, "fleet_cooldown_s"),
)


def evaluate(sig: dict, knobs: dict, params: dict) -> list:
    """Run every rule over one signal snapshot — pure, cooldown-blind.
    Returns proposal dicts (rule / knob / old / new / why)."""
    out = []
    for fn, cool in _RULES:
        for prop in fn(sig, knobs, params):
            prop["cooldown_s"] = float(params[cool])
            out.append(prop)
    return out


def replay(entry: dict) -> Optional[dict]:
    """Re-derive a journaled decision from its own snapshot — the
    explainability contract. Returns the matching proposal (or None if
    the snapshot no longer produces one, which the replay test treats
    as a failure)."""
    sig = entry["signals"]
    props = evaluate(sig, sig["knobs"], entry["params"])
    for prop in props:
        if prop["rule"] == entry["rule"] and prop["knob"] == entry["knob"]:
            return prop
    return None


class Controller:
    """See module doc. One controller per scheduler (``scheduler`` may
    be None for pure-simulation tests driving injected ``signals``)."""

    def __init__(self, scheduler=None, *, mode: str = "shadow",
                 clock=None, tick_s: Optional[float] = None,
                 journal_cap: int = DEFAULT_JOURNAL_CAP,
                 metrics: Optional[MetricManager] = None,
                 tracer=None, signals=None, k_init: Optional[int] = None,
                 **params):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        unknown = set(params) - set(DEFAULT_PARAMS)
        if unknown:
            raise ValueError(f"unknown autotune params: {sorted(unknown)}")
        self.scheduler = scheduler
        self.mode = mode
        self.clock = clock or time.time
        self.tick_s = float(tick_s if tick_s is not None
                            else DEFAULT_TICK_S)
        self.journal_cap = int(journal_cap)
        self.params = {**DEFAULT_PARAMS, **params}
        if metrics is not None:
            self.metrics = metrics
        elif scheduler is not None:
            self.metrics = scheduler._metrics
        else:
            self.metrics = MetricManager.instance()
        self.tracer = tracer if tracer is not None else (
            scheduler.tracer if scheduler is not None else None)
        self._signals_fn = signals or self._collect
        # knob state — tracked in BOTH modes (the journal shows the
        # full trajectory either way); the system only moves in enforce
        self.target_k = int(k_init if k_init is not None
                            else scheduler.max_batch
                            if scheduler is not None else 16)
        self.scales: dict[str, float] = {}
        self.checkpoint_every = 0
        # fleet routing-weight multipliers (signal name → weight); only
        # populated on a router-owned controller whose signal source
        # injects a "fleet" block — read back via routing_weights()
        self.fleet_weights: dict[str, float] = {}
        self.ticks = 0
        self._cooldowns: dict[str, float] = {}
        self._journal: list[dict] = []
        self._dropped = 0
        self._seq = 0
        self._last_tick = self.clock()
        self._prev: dict = {}
        self._lock = threading.RLock()
        self._gauges: list = []
        self._register_gauges()

    # -- gauges --------------------------------------------------------------

    def _register_gauges(self) -> None:
        # the gauges read EFFECTIVE values (what the system actually
        # runs), never the shadow trajectory — an operator debugging
        # batch shapes must not read a K the scheduler never used
        for knob, fn in ((KNOB_K,
                          lambda: self._effective_knobs()[KNOB_K]),
                         (KNOB_CKPT,
                          lambda: self._effective_knobs()[KNOB_CKPT])):
            g = self.metrics.gauge("controller.knob.value", fn=fn,
                                   labels={"knob": knob})
            self._gauges.append((g, fn))

    def detach_gauges(self) -> None:
        """Identity-checked detach, like the SLO engine's — a closed
        scheduler's controller must not keep reading dead state on
        every scrape."""
        for g, fn in self._gauges:
            if g.fn is fn:
                g.fn = None
                g.set(0.0)
        self._gauges = []

    # -- signal collection (non-creating reads only) -------------------------

    def _collect(self) -> dict:
        """One signal snapshot off the registries. EVERY read here must
        be non-creating (``counter_value`` / ``histogram_stats`` /
        plain attribute reads): in shadow mode the controller observes,
        and observation must not mint metric entries the autotune-off
        twin would lack (the byte-identical regression)."""
        now = self.clock()
        sched = self.scheduler
        m = self.metrics
        prev = self._prev
        sig: dict = {"t": now}
        occ = m.histogram_stats("serving.batch.occupancy")
        if occ is not None:
            dc = occ["count"] - prev.get("occ_count", 0)
            dt = occ["total"] - prev.get("occ_total", 0.0)
            prev["occ_count"] = occ["count"]
            prev["occ_total"] = occ["total"]
            sig["occupancy"] = {
                "recent_mean": round(dt / dc, 4) if dc > 0 else None,
                "batches": dc, "cum_mean": round(occ["mean"], 4)}
        else:
            sig["occupancy"] = {"recent_mean": None, "batches": 0}
        sig["queue_depth"] = m.counter_value("serving.queue.depth")
        burn: dict = {}
        burn_max = 0.0
        burn_max_slo = None
        protected: list = []
        slo = sched.slo if sched is not None else None
        if slo is not None:
            for o in slo.objectives:
                if o.tenant is not None:
                    protected.append(o.tenant)
                w = min(o.windows)
                r = slo.burn_rate(o.name, w)
                burn[o.name] = {f"{w:g}s": round(r, 6)}
                if r > burn_max:
                    burn_max, burn_max_slo = r, o.name
        sig["burn"] = burn
        sig["burn_max"] = round(burn_max, 6)
        sig["burn_max_slo"] = burn_max_slo
        sig["protected_tenants"] = sorted(set(protected))
        tens: dict = {}
        deltas: dict = {}
        if sched is not None:
            for t, r in sched.tenants.stats().items():
                tens[t] = {"in_flight": r["in_flight"],
                           "device_seconds": round(r["device_seconds"],
                                                   6)}
                d = r["device_seconds"] - prev.get(("dev", t), 0.0)
                deltas[t] = round(max(0.0, d), 6)
                prev[("dev", t)] = r["device_seconds"]
        sig["tenants"] = tens
        sig["tenant_device_s_delta"] = deltas
        comp = m.counter_value("serving.jobs.completed")
        sig["jobs_delta"] = comp - prev.get("jobs", 0)
        prev["jobs"] = comp
        prof = sched.profiler if sched is not None else None
        if prof is not None:
            sig["device"] = prof.stats()
        live = sched.live if sched is not None else None
        if live is not None:
            with live._lock:
                ov = live.overlay
                base = live.snapshot.num_edges
                lv = {"overlay_rows": ov.count, "tombs": ov.tomb_count,
                      "fill": round(ov.fill_fraction(), 6),
                      "tomb_fraction": round(ov.tombstone_fraction(), 6),
                      "base_edges": int(base),
                      "fallbacks": m.counter_value(
                          "serving.live.device_merge_fallbacks")}
            cd = m.histogram_stats("serving.live.compact_device_ms")
            lv["merge_us_per_row"] = (
                round(cd["mean"] * 1e3 / max(base, 1), 6)
                if cd is not None and cd["count"] else None)
            sig["live"] = lv
        ck = m.histogram_stats("serving.recovery.checkpoint_ms")
        ex = m.histogram_stats("device.exec.ms")
        retries = m.counter_value("serving.recovery.retries")
        replayed = m.counter_value("serving.recovery.rounds_replayed")
        sig["recovery"] = {
            "retries": retries, "rounds_replayed": replayed,
            "retries_delta": retries - prev.get("retries", 0),
            "replayed_delta": replayed - prev.get("replayed", 0),
            "checkpoint_ms_mean": round(ck["mean"], 4)
            if ck is not None and ck["count"] else None,
            "round_ms_mean": round(ex["mean"], 4)
            if ex is not None and ex["count"] else None}
        prev["retries"] = retries
        prev["replayed"] = replayed
        # the knob snapshot rides IN the signals so replay() can
        # reconstruct candidate selection (scales) and diffs (old K)
        sig["knobs"] = {"target_k": self.target_k,
                        "scales": dict(self.scales),
                        "checkpoint_every": self.checkpoint_every,
                        "fleet_weights": dict(self.fleet_weights)}
        return sig

    # -- tick ----------------------------------------------------------------

    def maybe_tick(self) -> list:
        """Worker-loop entry: tick if the interval elapsed, else
        nothing. Never raises past itself — the caller is the one
        serving worker."""
        now = self.clock()
        with self._lock:
            if now - self._last_tick < self.tick_s:
                return []
        return self.tick()

    def tick(self, force: bool = False) -> list:
        """One control evaluation: collect signals, run the rules, gate
        on cooldowns, journal every decision, apply in enforce mode.
        Returns the new journal entries."""
        now = self.clock()
        applies: list = []
        with self._lock:
            if not force and now - self._last_tick < self.tick_s \
                    and self.ticks > 0:
                return []
            self._last_tick = now
            self.ticks += 1
            self.metrics.counter("controller.tick.count").inc()
            sig = self._signals_fn()
            if "knobs" not in sig:
                # injected signal sources (tests, simulations) may omit
                # the knob snapshot — stamp it in, because replay()
                # reconstructs candidate selection from it and every
                # journaled snapshot must be self-contained
                sig["knobs"] = {"target_k": self.target_k,
                                "scales": dict(self.scales),
                                "checkpoint_every": self.checkpoint_every,
                                "fleet_weights": dict(
                                    self.fleet_weights)}
            knobs = sig["knobs"]
            entries = []
            for prop in evaluate(sig, knobs, self.params):
                until = self._cooldowns.get(prop["knob"], 0.0)
                if now < until:
                    continue      # hysteresis: the knob is cooling down
                entry = self._decide(prop, sig, now)
                entries.append(entry)
                applies.append(entry)
        # enforce-mode application OUTSIDE the controller lock: a
        # compaction can hold the live plane's lock for a while, and
        # GET /controller must stay answerable meanwhile
        if self.mode == "enforce":
            for entry in applies:
                self._apply(entry)
        return entries

    def _decide(self, prop: dict, sig: dict, now: float) -> dict:
        self._seq += 1
        applied = self.mode == "enforce"
        entry = {"seq": self._seq, "t": now, "rule": prop["rule"],
                 "knob": prop["knob"], "old": prop["old"],
                 "new": prop["new"], "why": prop["why"],
                 "mode": "enforced" if applied else "shadow",
                 "applied": applied,
                 "cooldown_s": prop["cooldown_s"],
                 "cooldown_until": now + prop["cooldown_s"],
                 "params": dict(self.params),
                 "signals": sig}
        self._cooldowns[prop["knob"]] = entry["cooldown_until"]
        # knob state advances in BOTH modes so shadow journals the same
        # trajectory enforcement would walk (restore sequencing,
        # hysteresis); only _apply moves the actual system
        rule = prop["rule"]
        if rule.startswith("batch_k."):
            self.target_k = int(prop["new"])
        elif rule in ("tenant.shed", "tenant.restore"):
            t = prop["tenant"]
            if prop["new"] >= 1.0:
                self.scales.pop(t, None)
            else:
                self.scales[t] = float(prop["new"])
        elif rule == "recovery.cadence":
            self.checkpoint_every = int(prop["new"])
        elif rule.startswith("fleet."):
            s = prop["signal"]
            if prop["new"] <= 1.0:
                self.fleet_weights.pop(s, None)
            else:
                self.fleet_weights[s] = float(prop["new"])
        self._journal.append(entry)
        if len(self._journal) > self.journal_cap:
            del self._journal[0]
            self._dropped += 1
            self.metrics.counter("controller.journal.dropped").inc()
        name = "controller.decisions.applied" if applied \
            else "controller.decisions.shadowed"
        self.metrics.counter(name, labels={"rule": rule}).inc()
        if self.tracer is not None:
            # the reserved "controller" trace id holds the decision
            # timeline (like "live" holds the plane's) — enforced
            # decisions are ALSO stitched into affected job traces by
            # the scheduler's execute path
            self.tracer.event("controller", "decision", rule=rule,
                              knob=entry["knob"], old=entry["old"],
                              new=entry["new"], mode=entry["mode"],
                              why=entry["why"])
        return entry

    def _apply(self, entry: dict) -> None:
        """Move the actual knob (enforce mode only). Tenant scales are
        read by the scheduler's quota gate via :meth:`scaled_quota`;
        compaction pokes the live plane; K and cadence write scheduler
        state the worker thread owns."""
        sched = self.scheduler
        rule = entry["rule"]
        if sched is None:
            return
        if rule.startswith("batch_k."):
            sched.max_batch = int(entry["new"])
            sched.batcher.max_batch = int(entry["new"])
        elif rule == "live.compact" and sched.live is not None:
            try:
                sched.live.compact_now(why="controller")
            except Exception:
                pass              # the plane's own fallbacks are loud

    # -- knob reads (scheduler seams) ----------------------------------------

    def scaled_quota(self, tenant: str, quota):
        """The quota the admission gate should check for ``tenant``:
        the configured one, scaled down by the shed state — enforce
        mode only (shadow must not change admission), and only when a
        quota is configured (the controller scales limits, it never
        invents them)."""
        if self.mode != "enforce" or quota is None:
            return quota
        s = self.scales.get(tenant, 1.0)
        if s >= 1.0:
            return quota
        return TenantQuota(
            # floor of 1: a shed HALVES a tenant's admission, it never
            # zeroes it — int() truncation on a small limit would turn
            # "throttle" into a total outage no restore could be
            # observed through
            max_in_flight=max(1, int(quota.max_in_flight * s))
            if quota.max_in_flight is not None else None,
            max_hbm_bytes=quota.max_hbm_bytes * s
            if quota.max_hbm_bytes is not None else None,
            max_device_seconds=quota.max_device_seconds * s
            if quota.max_device_seconds is not None else None)

    def routing_weights(self) -> dict:
        """Fleet routing-weight multipliers for the olap/fleet router's
        weighted pick (signal name → weight; absent = 1.0). Empty
        outside enforce mode — shadow journals the trajectory, the
        router must keep routing neutrally."""
        if self.mode != "enforce":
            return {}
        with self._lock:
            return dict(self.fleet_weights)

    def checkpoint_every_hint(self) -> int:
        """The adaptive default cadence for retryable jobs that did not
        set their own ``checkpoint_every`` — 0 (no hint) outside
        enforce mode or before a cadence decision."""
        return self.checkpoint_every if self.mode == "enforce" else 0

    # -- observation surface -------------------------------------------------

    def journal(self) -> list:
        with self._lock:
            return list(self._journal)

    def decisions_since(self, seq: int) -> list:
        """Journal entries newer than ``seq`` (the scheduler's stitch
        watermark)."""
        with self._lock:
            return [e for e in self._journal if e["seq"] > seq]

    def _effective_knobs(self) -> dict:
        """What the SYSTEM is actually running. In enforce mode the
        controller's internal state IS the applied state; in shadow
        the real knobs never moved, so this reads the scheduler's
        live values (and no tenant is actually scaled)."""
        if self.mode == "enforce" or self.scheduler is None:
            return {KNOB_K: self.target_k,
                    KNOB_SCALE: dict(self.scales),
                    KNOB_CKPT: self.checkpoint_every,
                    KNOB_FLEET: dict(self.fleet_weights)}
        return {KNOB_K: self.scheduler.max_batch,
                KNOB_SCALE: {}, KNOB_CKPT: 0, KNOB_FLEET: {}}

    def state(self) -> dict:
        """The ``GET /controller`` envelope + the flight-recorder
        bundle's ``state.controller`` section. ``knobs`` is the
        EFFECTIVE state; in shadow mode the would-be trajectory the
        journal walked is reported separately as ``shadow_knobs`` so
        the two can never be confused."""
        with self._lock:
            out = {"mode": self.mode, "tick_s": self.tick_s,
                   "ticks": self.ticks,
                   "knobs": self._effective_knobs(),
                   "cooldowns": {k: v for k, v in
                                 sorted(self._cooldowns.items())
                                 if v > self.clock()},
                   "journal_dropped": self._dropped,
                   "decisions": list(self._journal)}
            if self.mode != "enforce":
                out["shadow_knobs"] = {
                    KNOB_K: self.target_k,
                    KNOB_SCALE: dict(self.scales),
                    KNOB_CKPT: self.checkpoint_every,
                    KNOB_FLEET: dict(self.fleet_weights)}
            return out
