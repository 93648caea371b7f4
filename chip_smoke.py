#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # both main paths at their full sizes

Phases, each of which raises on failure:

1. print the card's name and power limit; build the kernels from the
   sources in the checkout (``nvcc`` for ``csrc/frontier_round.cu``,
   ``csrc/batched_exhaust.cu``, ``csrc/seg_scan.cu``,
   ``csrc/bfs_fused.cu``, ``csrc/probes.cu`` and ``csrc/window_sum.cu``,
   ``g++`` for the
   native host library: the Graph500 pipeline and the store scan's
   codec), all at once, and print each kernel's ptxas
   registers, shared memory and spills; start the host builds of the two
   Graph500 graphs (scale 22, then scale 26) in the background;
2. hold the ``frontier_round`` CUDA kernel bit-equal to its plain PyTorch
   version on the card, the K jobs' frontiers as vertex-major words:
   K in {1, 3, 16, 17}, lanes in {2, 8},
   tbits absent and given, C in {70, 2^20}, a case with Q > 2^28
   (64-bit offsets), one
   with C = 3*2^22 + 4099 (far more tiles than are resident at once),
   K = 5 with out-of-range columns, parents and slots (the clamps),
   K = 40 (two groups of jobs), every candidate missing the narrow
   lanes, no survivors, every candidate a survivor, C = 1, C one past a
   multiple of the tile, and the opener's shape on a real graph (scale
   ``CASE_SCALE``: the unvisited vertices in order, so the columns rise
   and lie close together, then dead slots); then ``REPEATS``
   back-to-back launches of the largest case, each bit-equal to the
   first; then the ``batched_exhaust`` kernel bit-equal to its plain
   version: K in {1, 3, 16, 40} with p_total < P, tbits, one owner over
   2^17 warps (a hub), each pair its own owner, p_total 0 and 1,
   out-of-range columns and parents (the clamps), and the cases aimed at
   its frontier summary (``summary_inputs``: K in {1, 3, 16, 32}, one
   vertex at the first, a middle and the last slot of a summary block;
   parents at n, n + 1, past the plane and below 0; K = 40 with jobs in
   the second plane only; every block set; with and without tbits), the
   summary kernel held bit-equal to its plain version in every case;
   then ``REPEATS`` back-to-back launches of the hub and the K = 40 case,
   each bit-equal to the first;
3. hold the ``seg_scan`` CUDA kernel against its plain PyTorch version on
   the card, for every combine (sum, min, max) and type (float32,
   int32): E in {1, 70, a tile - 1, a tile, a tile + 1, 2^20,
   3*2^22 + 4099} with random segment starts, one segment spanning every
   tile (a pure carry chain, far more tiles than are resident at once),
   hub-like segments spanning 2-300 tiles among short ones, every element
   its own segment, and ``flags[0]`` False. Exact except float32 sums
   (``FLOAT_SUM_RTOL``). Then ``REPEATS`` back-to-back float32 sums of
   the one-segment and the hub inputs, each run bit-equal to the first
   (stale statuses and look-back races would show here). Then the K-row
   launch: K in ``ROW_KS``, E below a tile, odd, 2 mod 4 and 2 mod 4
   with hub-like starts, the row stride ld = E and padded to 4, every
   type and combine; every row bit-equal to the one-row launch on that
   row and the whole to the plain version; ``REPEATS`` back-to-back
   K = 16 launches bit-equal to the first;
4. at Graph500 scale 16, the port's BFS on the card equals the port's
   BFS on the CPU (plain path), and ``frontier_round`` was launched;
   4b: the fused BFS kernel bit-equal to its plain version on the card
   (dist, levels and modes) and to ``frontier_bfs_hybrid``, with the
   endgame caps JAX's and 1, and cut by ``max_levels`` 1-3, then on the
   graphs whose counts land on the mode rule's thresholds
   (``fused_threshold_cases``, the CPU tests' graphs), each taking the
   mode its counts give;
5. the vertex-program engine's main path at Graph500 scale 22, edge
   factor 16 (the JAX package's LiveJournal-class PageRank graph):
   ``from_chunked_csr``, upload, then PageRank (alpha 0.85, 20
   iterations), BFS and WCC through ``GPUGraphComputer.run``, all
   through ``seg_scan``. PageRank is held to a float64 scipy PageRank
   (``PAGERANK_RTOL``), BFS to ``frontier_bfs_hybrid`` exactly and WCC
   to scipy's components (each label the smallest id of its component).
   Then one PageRank superstep's message array is replayed: the kernel
   against its plain version, its byte bound and
   ``torch.segment_reduce``, beside an int32 ``min`` at the same flags
   and a plain ``copy_`` of the messages; and the superstep's parts are
   timed. Phase 5b, on the same snapshot: ``GPUGraphComputer.run_batched``
   of K = 16 BFS sources (bench.py's rule), each row's dist and
   iterations equal to ``GPUGraphComputer.run`` and dist to
   ``frontier_bfs_hybrid``, and of K = 4 PageRank jobs, each row
   bit-equal to the single run; walls, peak memory, launches, and each
   batch's widest K-row scan replayed (``row_scan_replay``: rows against
   the one-row launch and the plain version, the two byte bounds, and
   ``torch.segment_reduce`` over the rows for float32). Phase 5c:
   PageRank checkpointed every ``CKPT_EVERY`` supersteps, bit-equal to
   the run without checkpoints; rounds 15 and 20 removed and resumed,
   round 10 corrupted and resumed from 5 (``latest`` falls back), both
   bit-equal; a classic MapReduce (an in-degree histogram over the
   vertex views) against numpy;
6. the BFS main path at the full scale: native R-MAT host build, upload,
   direction-optimizing BFS from sources sampled by bench.py's rule (one
   warm-up run, best of 3 per source), TEPS as bench.py computes it, and
   Graph500's validation rules checked on the card. One run a source is
   traced (CUDA events around every ``frontier_round`` call, the summed
   kernel time printed a source); then two of the traced calls are replayed to
   time the kernel against its plain version and its bound: the widest
   (the first of the largest C) and the one whose bound bytes are
   largest (``round_bytes``: the smaller of the ``[8, Q]`` and ``[Q, 8]``
   counts of the dstT sectors). 6b: the single-launch BFS
   (``models/bfs_hybrid_fused``, ``csrc/bfs_fused.cu``) from the same
   sources, best of 3, one cooperative launch a BFS, each ``dist``
   bit-equal to phase 6's validated result and to the plain fused
   version on the card, whose ``levels`` it equals (printed beside the
   hybrid's); each source's wall, TEPS and their harmonic mean beside
   phase 6's, the kernel's ms against its byte bound (``fused_bytes``:
   the dstT chunks and visited-bitmap sectors that each level's decision
   must read, a bottom-up vertex's chunks up to its first parent; the
   older model's ``dist`` sectors beside it) and the plain version's,
   and each source's split (``%globaltimer`` after each of the kernel's
   grid barriers: each level's mode and the ms of its top, scan and
   walk_lists). (The push BFS
   at s26 is ``scripts/torch_push_s26.py``'s: its host out-CSR takes
   longer than the smoke can spend.);
7. the batched ``[K, n]`` BFS on phase 6's graph: the serving layer's
   BFS cohort (K = 16 sources by bench.py's rule; one warm-up, best of
   3, one traced run) with every row bit-equal to ``frontier_bfs_hybrid``
   from its source, its wall time beside the 16 single-source best
   times, the per-level split into plan, rounds and exhaust, each
   ``batched_exhaust`` call's time, the largest exhaust ``p_cap`` and
   the peak memory; the interactive lane's hops batch (K = 16, depth 2,
   ``start_level`` 1, the depth kept by an ``on_level`` mask) against a
   top-down expansion in plain torch; the widest K = 16
   ``frontier_round`` call replayed twice, as run and with 1% of slots
   tombstoned, then cut to its first 4, 8 and 16 jobs (``k_sweep``); the
   largest cohort sweep replayed (``batched_exhaust`` against its plain
   version, its time against ``exhaust_bytes``' bound; its frontier
   summary against the summary's plain version and its byte bound, the
   planes read once); then at scale 16
   the batched BFS on the card
   equals the CPU port under a live overlay with adds and removals, with
   level masks, in a checkpoint and a resume from it, and with jobs
   dropped through ``on_level``;
8. the frontier models at scale 22, on a chunked-CSR dict from phase 5's
   host build: ``pagerank_dense`` as bench.py's LiveJournal stage runs it
   (2 warm-up iterations, then seconds an iteration over 10) and its
   20-iteration ranks against phase 5's float64 PageRank; the batched
   personalized PageRank of 16 users (bench.py's source rule), every row
   against ``pagerank_dense(reset=one-hot)`` on the card
   (``PPR_RTOL``), and its ``top_k_per_user``; ``frontier_sssp`` from
   bench.py's SSSP source (the first vertex of degree > 0), checked by
   its edges (``check_sssp``); ``frontier_wcc`` equal to scipy's
   components; the K = 4 SSSP cohort, every row and round count
   bit-equal to its solo run. 8b, on phase 5's snapshot: the
   push-frontier BFS (``models/bfs``: ``frontier_bfs``,
   ``frontier_bfs_tiled`` with its defaults and with 2^25 edges a shard,
   4 shards or more) from bench.py's first source, each ``dist`` equal
   to ``frontier_bfs_hybrid``'s, walls and levels; then the fused
   kernel against its plain version on the card from that source;
9. bench.py's ``sssp_wcc`` stage on phase 6's scale-26 graph: one
   ``frontier_sssp`` with ``_trace_rounds`` and ``_trace_plan_drain``
   set (seconds, rounds, plan seconds a round, each round's plan and
   pushes), then ``frontier_wcc`` without them (seconds, rounds, the
   ``frontier_round`` launches of its BFS peel), the peak memory; SSSP
   checked by its edges, WCC by its edges and label rules, its giant
   label's set equal to the set a BFS from phase 6's first source
   reaches;
10. the serving layer at s22 (run after phase 8, on phase 5's snapshot,
   under a device profiler for the whole phase): the chunked CSR built
   once, its ``torch.cuda.memory_allocated`` growth against
   ``snapshot_csr_bytes`` (``ALLOC_SLACK``) and the second call cached;
   then ``JobScheduler`` (``olap/serving``) on the card, paused while
   each stream is submitted: 16 BFS jobs from phase 5b's sources fused
   into one K = 16 batch (occupancy, every row equal to
   ``frontier_bfs_hybrid``), its wall from the first submit against a
   direct ``frontier_bfs_batched`` call, one K = 1 job's latency, the
   ledger's resident bytes; a mixed stream under two tenants (an SSSP
   and a WCC cohort of 4, 2 ``pagerank`` and 2 ``dense`` PageRank jobs),
   SSSP and WCC equal to the direct calls, ``pagerank`` to
   ``pagerank_dense`` within ``FLOAT_SUM_RTOL``, ``dense`` bit-equal to
   phase 5's ``GPUGraphComputer.run``, the tenants' device-seconds equal
   to the batches' walls; a BFS crashed at level 2 and a dense PageRank
   at superstep 10 (``FaultPlan``), both resumed from checkpoints on
   attempt 2 and bit-equal to their uninterrupted runs; a cancel and an
   expired deadline; ``bfs.chunked_csr`` counted once; the
   ``device.exec`` children of the three kernels; the K = 16 batch with
   the profiler on and off, in turns. The served runs' launches are
   ``launches_by_path["serving"]`` of each kernel;
11. the live plane and the interactive lane at s22 (after phase 10, on
   phase 5's snapshot). 11a: two epochs over the snapshot, bench.py's
   default-policy epoch (batches of 256 undirected adds and 8 removed
   undirected base edges until ``EpochCompactor.should_compact``) and a
   large one (2^18 undirected adds, one killed in place, 4,096
   removed undirected base edges, stopped at ``REMOVE_BUDGET_S``); each
   compacted on the card through a logged HBM ledger: ``device`` mode
   with no fallback, the double buffer reserved, re-keyed and unpinned,
   ``memory_allocated`` grown by the merged CSR (``ALLOC_SLACK``); the
   device merge timed (best of ``MERGE_REPS`` by CUDA events, after a
   warm-up), its peak memory and its top ops under ``torch.profiler``,
   the host sync (``merge_delta``, of it ``_merge_out_csr``) timed; the
   BFS of phase 5b's 16 sources over base + overlay equal to the merged
   epoch's; then each epoch bit-equal to its host oracle (the compactor's
   full re-sort and a CPU ``build_chunked_csr``, run in a background
   thread meanwhile): the device CSR, the synced arrays and their
   incremental out-CSR, the lazy mirror's ``dstT``. 11b: the lane through
   ``JobScheduler.interactive()``, fused (window ``LANE_WINDOW_S``, up to
   16) and solo (``SOLO_WINDOW_S``), as bench.py's ``interactive_stage``:
   bursts of 16 2-hop ``both()`` counts, each one batch, p50/p95 ms
   against solo queries, every count equal to a top-down expansion
   (``expand_once``); ids at depths 1-4 in one batch against the
   expansion and a direct hops call; ``out()`` (the reversed layout,
   uploaded once) and ``in_()`` equal to ``both()``; a mixed-label
   ``out()`` chain on a labeled view of the same arrays against a
   label-filtered expansion; counts under 11a's large-epoch overlay equal
   to the merged epoch's, a directed chain falling back; 8 PPR queries in
   one batch against a direct ``pagerank_personalized_batched``
   (``PPR_RTOL``). The two paths' launches are ``launches_by_path
   ["live"]`` and ``["interactive"]`` of ``frontier_round`` and
   ``batched_exhaust``;
12. bench.py's ``store_ingest`` stage at s21, one below the engine's
   scale (``STORE_SCALE``: the store path sets the smoke's clock; after
   phase 11, before the s26 phases): ``olap/bulk.ingest_rmat_store``
   bulk-loads the R-MAT edges (phase 5's generator, edge factor and seed
   at ``STORE_SCALE``) into
   ``titan_tpu_torch.open("inmemory")`` and scans them back into a
   symmetric snapshot; bench.py's keys (``store_ingest_s21``) and the
   host's peak RSS are printed. The snapshot's ``vertex_ids`` are the
   loader's, ascending; its (src, dst) multiset is the generated edges
   plus their reverse (duplicates and self-loops kept; sorted on the
   card). Its chunked CSR and BFS from bench.py's source equal the BFS on
   the generated graph of that scale (``bulk.dist_match``). Then
   ``g.compute(backend="gpu")``: ``snapshot(directed=False)`` built
   through the graph entry, 20 PageRank supersteps through ``seg_scan``
   within ``PAGERANK_RTOL`` of a float64 scipy PageRank over the same
   arrays, two BFS jobs through ``computer.scheduler()`` (the
   graph-backed pool) equal to the direct call; a transaction of
   ``STORE_ADDS`` added and ``STORE_REMOVES`` removed edges leaves both
   snapshots stale, and the BFS on the ``refresh()``ed snapshot equals
   the BFS on the ``rebuild_in_place()``d one. The path's launches are
   ``launches_by_path["store"]``; ``frontier_round`` and ``seg_scan`` must
   be above zero. The phase's snapshots are closed; its graph stays open
   for phase 13;
13. the live plane (``olap/live/plane.py``) over phase 12's store graph
   at s21 (13a) and a cross-instance sqlite graph (13b). 13a:
   ``LiveGraphPlane(graph, device="cuda")`` (the default policy; the
   overlay's smallest bucket ``PLANE_MIN_CAP``) and
   ``JobScheduler(live=plane)``, pumped by hand: 16 BFS jobs fused to
   K = 16 over the clean base, each row equal to ``frontier_bfs_batched``
   on the plane's base; commits of bench.py's live_refresh shape
   (``LIVE_BATCH_EDGES`` undirected adds, ``LIVE_BATCH_REMOVES`` removed
   base edges) through ``graph.new_transaction()``, the 16 BFS served
   over base + overlay just before the budget fires (each row equal to
   the BFS on the host oracle ``EpochCompactor.merge``, ``ran_epoch`` the
   plane's), then the fold on the card: ``device`` mode, no fallback, the
   republished base bit-equal to the host oracle; under a dirty overlay
   an SSSP and a WCC job equal to the direct calls on the same lease, a
   fused lane batch of 16 2-hop ``both()`` counts, then a ``pagerank``
   and a ``dense`` job that compact that overlay before they run
   (``ran_epoch["seq"] == 0``), within ``PAGERANK_RTOL`` of float64 over
   the merged arrays, and the lane's counts equal to ``expand_once`` over
   them; a resync (``_resync``, a full rescan) whose BFS rows equal the
   rows served before it. No compaction may be for HBM admission and
   none may fall back. Printed: apply_ms p50/p95, the commits' wall,
   each compaction's why, mode and ms, the device merges and the host
   syncs (``merge_delta``) apart, the served walls clean and dirty,
   ``stats()["freshness"]``, the resync's seconds, the host's peak
   resident set. 13b: two handles with distinct instance ids over one
   sqlite directory (``FEED_VERTICES`` vertices), the plane on the first
   with ``log_identifier=``; the second handle's tagged commits reach a
   BFS served on the card through the feed, the plane's own tagged
   commit arrives once, and the BFS equals the BFS on a rebuilt
   snapshot; then one new vertex with an edge (the host path,
   ``why="vertex-set change"``, the compactor's one ``apply-path``
   fallback) reached by the next BFS, equal to a rebuild's. The served
   runs' launches are ``launches_by_path["plane"]``; all three kernels
   must be above zero. The store and its snapshots are freed before
   s26;
14. Gremlin traversals compiled onto the card
   (``traversal/olap_compile.py``; no kernel of the port: each expand is
   a gather and an int64 ``index_add_``). 14a on phase 12's refreshed
   s21 store snapshot, passed explicitly before phase 12 closes it:
   ``V().out().out().count()``, ``V().repeat(out()).times(3).count()``
   (counts past 2^31 at a vertex), ``V(16 seeded ids).both().dedup()
   .both().dedup().count()`` and ``V(hub).out().out().dedup().id_()``
   through ``g.traversal().with_computer("gpu", snapshot=snap)``, each
   held to have compiled (``run_compiled``) and equal to an int64 host
   reference (scipy over the snapshot's src and dst); each chain's wall
   and device ms, the largest count at one vertex, one expand's gather
   and ``index_add_`` against their byte bounds. 14b (after phase 12):
   the chain shapes of tests/test_olap_compile.py on the graph of the
   gods and a seeded ``PROPERTY_VERTICES``-vertex labelled property
   graph, compiled on CUDA and equal to the port's interpreter, and
   K_50's 6-hop count equal to the interpreter's and to 50 * 49^6;
15. the front door (``server.py``) on phase 12's refreshed s21 store
   snapshot and graph, inside phase 12's hook after 14a: a
   ``GraphServer`` over the store graph with
   ``JobScheduler(snapshot=snap, device="cuda")`` on port 0, every
   request through a socket (``utils/httpnode``): 16 BFS jobs (bench.py's
   source rule) POSTed to the paused scheduler run as one K = 16 batch,
   each polled over ``GET /jobs/<id>`` with reached, levels and a target
   equal to ``frontier_bfs_batched`` and its row bit-equal; a ``dense``
   PageRank job (20 supersteps, through ``submit_job``, the seam POST
   /jobs calls: its program is an object) bit-equal to
   ``GPUGraphComputer.run``; two bursts of 16 concurrent ``POST
   /traverse`` 2-hop ``both()`` counts from 16 threads, each one batch
   of 16 equal to ``expand_once``; a gremlin chain through the lane
   (compiled); a ``POST /traversal`` script interpreted on the store
   graph, ``out().out().dedup().count()`` from a seeded low-degree
   vertex, equal to the count over the loaded edges (the bulk loader
   writes one OUT entry an edge, as the reference does);
   the observation endpoints answer JSON, ``/metrics`` parses as
   exposition 0.0.4 with ``serving_jobs_completed`` and the three
   kernels' ``device.exec`` children; a bad body 400, an unknown job
   404. Printed: each request kind's walls, the K = 16 batch's wall
   over HTTP beside phase 10's served and direct walls. Its launches are
   ``launches_by_path["server"]``; all three must be above zero;
16. the replica fleet at bench.py's ``fleet_stage`` shape (after phase
   13): one storage node (the port's ``KCVSServer``) mounted as bench.py
   mounts it, ``storage.backend: remote-cluster`` with the node as the
   ring's one host, holding n = 192 and 900 edges of seed 42, two
   replicas from ``olap/fleet/replica.build`` on the card behind a
   ``FleetRouter``: 4 BFS, 4 SSSP and 4 WCC jobs, each equal to the
   direct call on a snapshot of the same graph, the per-replica routed
   counts, the federated ``/metrics?federate=1`` and ``/fleet``; then a
   victim replica (never started) stopped after dispatch, its job
   finished on the survivor on attempt 2 with one redispatch, equal to
   the direct BFS. Its launches are ``launches_by_path["fleet"]`` where
   above zero;
17. the scan cluster and mixed indexes (host code beside the card).
   17d, inside phase 16 before its storage stops: ``compute(backend=
   "host")`` runs an in-degree ``VertexProgram`` on the fleet graph
   through a ``JobScheduler`` on the card (``run_async``) beside a
   ``dense`` PageRank job; the degrees equal the directed snapshot's
   counted on the card, the PageRank is bit-equal to
   ``GPUGraphComputer.run``; its launches are
   ``launches_by_path["host_computer"]``. Then, at bench.py's
   ``distributed_scan_stage`` shape: (a) two storage nodes at
   replication 2 holding 64 persons, two HTTP scan workers, a traced
   ``RemoteScanRunner``: ``VertexCountJob`` counts 64, equal to
   ``InProcessSplitRunner`` and ``StandardScanner``, the stitched trace
   4 coordinator splits of 4 spans with nothing dropped; (b)
   ``DistributedScanRunner`` in two spawned processes over a sqlite graph
   of the same 64 persons, while this process holds the CUDA context,
   equal to (a); (c) a mixed index on ``name`` over ``memindex``,
   ``lucene`` (sqlite FTS5) and an ``IndexServer`` (``remote-index``),
   each REGISTER, REINDEX over (a)'s workers, ENABLE, then an
   ``index_query`` and a ``textPrefix`` graph query on the mixed cover
   (the profiler's groups) equal to a full scan, then DISABLE; (e) each
   step's wall on the host clock. Phases 16 and 17 must end within 60 s;
18. the OLTP remainder on the card's host, with phase 14b's 2,000-vertex
   property graph: written with ``write_graphbin`` and
   ``write_graphson``, each read back into a ``gdbm`` graph equal to it;
   ``graph.compute()`` PageRank (within ``PAGERANK_RTOL`` of float64)
   and BFS (equal to a host BFS over the edges read back) on the card
   over the gdbm graph, its ``seg_scan`` launches
   ``launches_by_path["gdbm"]``; a ``metrics.enabled`` gdbm graph whose
   store counters count and whose CSV reporter writes; ``deploy`` start,
   status and stop of a storage node and a scan worker. Within 60 s;
19. the multi-device paths (``parallel/``) on the one card. 19a (after
   phase 18, on phase 5's s22 snapshot): ``engine.run_sharded`` over a
   world-1 NCCL mesh in this process, PageRank (20 supersteps, within
   ``PAGERANK_RTOL`` of float64) and BFS (equal to phase 5's
   ``frontier_bfs_hybrid``), its ``seg_scan`` launches
   ``launches_by_path["sharded"]``. 19c (then): ``parallel/multihost.
   launch`` spawns 2 ranks sharing ``cuda:0`` over gloo, each memory-
   mapping phase 5's host graph (saved once with ``np.save``) and packing
   only its block: the sharded hybrid BFS from 4 sources and the sharded
   push BFS from phase 5's source, bit-equal in ``dist`` and ``levels``
   to the single-card runs, and ``run_sharded`` PageRank within
   ``PAGERANK_RTOL`` of float64; both ranks launch ``frontier_round`` and
   ``seg_scan`` (added under ``"sharded"``). 19b (after phase 6b, on
   phase 6's s26 graph): ``frontier_bfs_hybrid_sharded`` over a world-1
   NCCL mesh from bench.py's 4 sources (its ``bfs23_sharded`` stage at
   the headline scale), each ``dist`` bit-equal to phase 6's validated
   one and ``levels`` equal, best of 3 after a call that packs and
   uploads the block, the ratio to phase 6's time, the profile's
   dispatches and retries by level; its ``frontier_round`` launches under
   ``"sharded"``; the block (a second copy of dstT) is freed after;
20. the serving plane's ``mesh=`` at s22 (right after phase 10, on
   phase 5's snapshot; ``phase_mesh_s22``): for a ``local_mesh`` of 2,
   then 3 blocks sharing ``cuda:0`` (``MESH_SHARDS``), and of every card
   when there are several: the snapshot placed (``place_batched_csr``;
   each block's bytes against the card's ``memory_allocated`` growth);
   the K = 16 batch of phase 10's sources served through
   ``JobScheduler(mesh=)``, every row bit-equal to the direct one-device
   ``frontier_bfs_batched``, its run spans ``meshed`` = D, the ledger's
   resident bytes equal to ``meshed_snapshot_csr_bytes``, its wall beside
   phase 10's direct and served walls and a direct placed call's, the
   frontier words copied a level; a BFS crashed at level 2 and resumed
   from its checkpoint on the mesh, equal; then direct placed calls each
   equal to the one-device call: hops mode with level masks, jobs dropped
   by ``on_level``, an ``init_dist`` resume. The served runs' launches
   are ``launches_by_path["mesh"]``;
21. the probe kernels of experiments/ (``ops/probes.py``,
   ``csrc/probes.cu``; last, after phase 7's s16 batch and
   ``torch.cuda.empty_cache()``). 21a: each kernel against its plain
   version on the card, bit-equal (``set`` by ``scatter_set_ok``: every
   written cell holds a value written to it, untouched cells 0), at
   small and ragged shapes: copies of 1, 3, 5 and 10^6 + 3 words and
   sizes off the copy's 4,096-word block; tables
   of 3-4096 rows (8, 448, 449 and 4096 among them) and widths 4, 12
   and 128 against row counts off the block, with and
   without shifts; shuffles of 1-65537 rows; the three scatters (add
   wrapping) on both of ``scatter_path``'s designs: the slab (stripes of
   8 at 7-7263 rows of width 128, of 4 at widths 4, 12 and 132 and up
   to 14527 rows; the largest slab of each stripe fills the block's
   shared memory) and the global kernel (tables past the slab's shared
   memory), over ragged row counts; transposes of 1-1001 tiles;
   probe3b's V1-V6, probe3c's W1-W3, probe3_dma's four cases with every
   5th segment dead, and 16 B-16 KB segments at 1, 2, 3, 8, 31 and 32 in
   flight, written ranges only. 21b: the six launch counts zeroed,
   ``run_probes`` at the TPU probes' shapes (``probes.PROBES``: each
   checked once at full size against its plain version, then timed by
   CUDA events with its bound, sector model, plain version and library
   call), each record printed with the card's name and power limit, the
   counts read (``launches_by_path["probes"]``), the peak memory (under
   6 GB) and the phase's wall (under ``PROBES_BUDGET_S``);
22. the row window sum (``ops/window_sum.py``, ``csrc/window_sum.cu``,
   the port of the lint fixture's ``_ok_kernel``; right after phase 21).
   22a: the kernel bit-equal to its plain version on the card, int32 and
   float32 (signed zeros among the floats), widths 64, 128, 300, 1024
   and 4099, rows 1, 2 and 1001, with and without ``masked``, ``block``
   1, 64, 100 and 256 at width 300, and a row base off 16 bytes. 22b:
   the count zeroed, ``run_window_sum`` at (2^21, 128) int32 and float32
   (each checked once at full size, then timed beside its bound, its
   plain version and, for float32, ``F.conv1d`` with a ones filter and
   TF32 off, whose difference is printed), the count read
   (``launches_by_path["window_sum"]``).

The line before the last is the ``{"kernels": [...]}`` record of the
twelve kernels (each record's ``launches`` sums its paths, listed under
``launches_by_path``; ``seg_scan``'s ``rows`` holds phase 5b's two
K-row replays; ``exhaust_summary`` is the sweep's frontier summary, one
launch before each sweep; ``bfs_fused``'s ``per_source`` holds each
source's split; the six probe kernels' records stand at each one's
probe that moves the most bytes, by the sector model where there is
one, ``cases`` holding all its probes; ``row_window_sum``'s stands at
int32, its float32 run under ``cases``);
the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SCALE = 26                       # the BFS main path: bench.py's "bfs26"
EDGE_FACTOR = 16
SEED = 2
SMALL_SCALE = 16
CASE_SCALE = 20                  # phase 2's opener-shaped rounds
ENGINE_SCALE = 22                # the engine's: bench.py's lj_scale
NUM_SOURCES = 4
REPS = 3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
KERNEL = {"name": "frontier_round", "route": "cuda",
          "source": "titan_tpu_torch/csrc/frontier_round.cu",
          "replaces": "titan_tpu/ops/pallas_frontier.py:79"}
SEG_KERNEL = {"name": "seg_scan", "route": "cuda",
              "source": "titan_tpu_torch/csrc/seg_scan.cu",
              "replaces": "titan_tpu/ops/pallas_segment.py:41"}
#: the batched BFS's straggler sweep: its JAX counterpart is XLA (the
#: found-per-candidate half of _batched_exhaust), not a Pallas kernel
EXHAUST_KERNEL = {"name": "batched_exhaust", "route": "cuda",
                  "source": "titan_tpu_torch/csrc/batched_exhaust.cu",
                  "replaces": "titan_tpu/models/bfs_hybrid.py:1070"}
#: the single-launch BFS: the port's own kernel; its JAX counterpart is
#: the XLA program of bfs_hybrid_fused.py (one lax.while_loop), not Pallas
#: the sweep's frontier summary, a launch of its own just before the
#: sweep in the same file
SUMMARY_KERNEL = {"name": "exhaust_summary", "route": "cuda",
                  "source": "titan_tpu_torch/csrc/batched_exhaust.cu",
                  "replaces": "titan_tpu/models/bfs_hybrid.py:1070"}
FUSED_KERNEL = {"name": "bfs_fused", "route": "cuda",
                "source": "titan_tpu_torch/csrc/bfs_fused.cu",
                "replaces": "titan_tpu/models/bfs_hybrid_fused.py:311"}
#: the lint fixture's Pallas kernel, never imported by any path: its
#: port runs as a phase of its own (22)
WINDOW_KERNEL = {
    "name": "row_window_sum", "route": "cuda",
    "source": "titan_tpu_torch/csrc/window_sum.cu",
    "replaces": "tests/fixtures/graftlint/titan_tpu/models/pallas_ok.py:14"}
#: float32 sums: |kernel - plain| <= FLOAT_SUM_RTOL * (the scan of |x|).
#: The kernel adds in tile order (16 in a thread, a warp tree, a block
#: tree: about 27 adds inside a tile, then the carry, a left fold with one
#: add a tile the segment spans) and the plain version in Hillis-Steele
#: order (log2 E <= 27 adds); each order's error is at most its depth
#: times float32's 2^-24 times the scan of |x|. That bound holds on the
#: engine's graph, where a hub spans at most 40 tiles: under 100 adds in
#: all, 6e-6 of the scan of |x|. It does not hold for phase 3's longest
#: segments: the one-segment case folds 3073 tiles (bound 1.9e-4) and the
#: hub case up to 300 (2.1e-5). Those cases stay inside 1e-5 only because
#: their values, uniform in [-1, 1) at a fixed seed, cancel: each add errs
#: by at most 2^-24 of the running sum, and running sums of values of
#: random sign stay far below the scan of |x|. Positive values (as
#: PageRank's messages) over such spans would not.
FLOAT_SUM_RTOL = 1e-5
#: back-to-back launches of phase 3's repeat check
REPEATS = 20
#: PageRank at s22 against float64: max |r32 - r64| / r64. Each float32
#: superstep's sums err by at most about 80 * 2^-24 (5e-6) relative (the
#: messages are positive); PageRank contracts by alpha = 0.85 a step, so
#: 20 steps accumulate under 5e-6 / 0.15 = 3.3e-5.
PAGERANK_RTOL = 1e-4
#: a personalized row against pagerank_dense(reset=one-hot) on the card,
#: max |a - b| / b over b > 0 (and a == 0 exactly where b == 0): both
#: add the same positive float32 terms, each in the order its atomics
#: land, so each is within PAGERANK_RTOL of the exact ranks by the
#: argument above and the two within twice that
PPR_RTOL = 2 * PAGERANK_RTOL
#: the personalized batch: the interactive lane's max_batch
PPR_USERS = 16
#: the SSSP cohort of phase 8
SSSP_COHORT = 4


T0 = time.time()


def say(msg: str) -> None:
    """Print a progress line with the seconds since the script started."""
    print(f"[{time.time() - T0:6.1f}s] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


class Background(threading.Thread):
    """Runs fn() in a daemon thread; ``result()`` joins and re-raises."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.out, self.err = fn, None, None
        self.start()

    def run(self):
        try:
            self.out = self.fn()
        except BaseException as e:  # re-raised in the caller's thread
            self.err = e

    def result(self):
        self.join()
        if self.err is not None:
            raise self.err
        return self.out


def kernel_name(sym: str) -> str:
    """A mangled kernel symbol's own name (the last of its length-prefixed
    names), with its template arguments as mangled (``ILb1EE``: true;
    ``ILi2EE``: 2; ``IfNS_3MaxEE``: float, Max)."""
    nested = sym.startswith("_ZN")
    i, name = 3 if nested else 2, sym
    while (m := re.match(r"\d+", sym[i:])):
        end = i + m.end() + int(m.group())
        name, i = sym[i + m.end():end], end
        if not nested:
            break
    args = re.match(r"I(?:L[a-z]\d+E|[a-z]|NS_\d+[A-Za-z_]\w*?E)+E", sym[i:])
    return name + (args.group() if args else "")


def ptxas_lines(lib) -> list[str]:
    """The register, shared-memory and spill lines of a kernel library's
    ``-Xptxas -v`` log (``titan_tpu_torch.build``), each once, headed by
    the kernels that print it (``kernel_name``)."""
    by_line, name = {}, "?"
    with open(lib._name + ".log") as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = kernel_name(m.group(1))
            elif re.search(r"registers|spill", ln):
                line = re.sub(r"^ptxas info\s*:\s*", "", ln.strip())
                by_line.setdefault(line, []).append(name)
    return [f"{', '.join(dict.fromkeys(names))}: {line}"
            for line, names in by_line.items()]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def pack_rows(bits):
    """[K, 8*nb] bool -> [K, nb] uint8 little-endian bitmaps (uint8
    temporaries: the bits of a byte are distinct, so the sum is an OR)."""
    sh = torch.arange(8, dtype=torch.uint8, device=bits.device)
    K = bits.shape[0]
    return (bits.view(K, -1, 8).to(torch.uint8) << sh).sum(
        -1, dtype=torch.uint8)


def word_bits(K: int) -> tuple[int, int]:
    """(Kp, G) of the vertex-major frontier words of K jobs: Kp =
    min(next_pow2(K), 32) bits a vertex in each of G = ceil(K / 32)
    planes; job g*32 + k of vertex v is bit v*Kp + k of plane g
    (``titan_tpu_torch/ops/frontier.py``)."""
    return min(1 << (K - 1).bit_length(), 32), -(-K // 32)


def rows_to_words(rows, K: int):
    """[K, nb] uint8 job-major bitmaps -> [G, nb*Kp] uint8 words, in
    plain torch and independent of the package's packer."""
    Kp, G = word_bits(K)
    nb, dev = rows.shape[1], rows.device
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    out = torch.empty((G, nb * Kp), dtype=torch.uint8, device=dev)
    for g in range(G):
        w = torch.zeros(nb * 8, dtype=torch.int64, device=dev)
        for k in range(min(32, K - 32 * g)):
            bit = ((rows[32 * g + k][:, None] >> shifts) & 1).flatten()
            w |= bit.long() << k
        if Kp >= 8:
            out[g] = w.view(torch.uint8).view(nb * 8, 8)[:, :Kp // 8] \
                .flatten()
        else:
            sh = torch.arange(8 // Kp, device=dev) * Kp
            out[g] = (w.view(-1, 8 // Kp) << sh).sum(1).to(torch.uint8)
    return out


def words_to_rows(words, K: int):
    """[G, plane] uint8 words -> [K, ceil(nv/8)] uint8 job-major bitmaps,
    nv = plane*8/Kp vertices; the inverse of ``rows_to_words``."""
    Kp, G = word_bits(K)
    plane, dev = words.shape[1], words.device
    nv = plane * 8 // Kp
    if Kp >= 8:
        b = words.view(G, nv, Kp // 8).long()
        w = sum(b[:, :, i] << (8 * i) for i in range(Kp // 8))
    else:
        sh = torch.arange(8 // Kp, device=dev) * Kp
        w = ((words[:, :, None].long() >> sh) & ((1 << Kp) - 1)) \
            .view(G, -1)[:, :nv]
    bits = torch.zeros((K, -(-nv // 8) * 8), dtype=torch.bool, device=dev)
    for k in range(K):
        bits[k, :nv] = ((w[k // 32] >> (k % 32)) & 1) > 0
    return pack_rows(bits)


def as_rows(fbits, K: int):
    """``(rows, plane)``: the job-major [K, nb] bitmaps of a round's
    ``fbits`` and the bytes of a words plane of them. ``fbits`` is words
    ([G, plane]); a [K, nb] array at K > 1 (G < K there) is the
    job-major layout of the port before words, taken as it is so a copy
    of this file can count a parent checkout's calls."""
    Kp, _ = word_bits(K)
    if K > 1 and fbits.shape[0] == K:
        return fbits, fbits.shape[1] * Kp
    return (fbits if K == 1 else words_to_rows(fbits, K)), fbits.shape[1]


def first_jobs(a, k: int) -> dict:
    """The round ``a`` cut to its first k jobs (``undec`` rows and the
    frontier bits), in the layout ``a`` came in."""
    K = a["undec"].shape[0]
    rows, _ = as_rows(a["fbits"], K)
    rows = rows[:k].contiguous()
    job_major = K > 1 and a["fbits"].shape[0] == K
    return {**a, "undec": a["undec"][:k].contiguous(),
            "fbits": rows if job_major or k == 1 else rows_to_words(rows, k)}


def round_inputs(gen, K, C, Q, n_val, masked, kind="random"):
    """Random round inputs on the card, the frontier bits random and
    given as words (``rows_to_words``). ``kind``: "random"; "high" puts
    half the columns near Q (so lane*Q + col and col*8 + lane pass 2^31
    when Q does 2^28); "junk" puts columns, parents and slots out of
    range, to hold the kernel's clamps to the plain version's;
    "narrow_miss" gives lanes 0 and 1 even parents and the bitmaps odd
    vertices only, so every undecided candidate misses the narrow lanes
    and is refetched; "none_survive" clears ``has_more``; "all_survive"
    leaves every job undecided, sets ``has_more`` and empties the
    bitmaps, so every candidate survives."""
    dev = "cuda"

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    junk = kind == "junk"
    cols = ri(-Q, 2 * Q, (C,)) if junk else ri(0, Q, (C,))
    if kind == "high":
        cols[::2] = Q - 1 - ri(0, min(Q, 1 << 24), (C - C // 2,))
    nb = (n_val + 9) // 8
    lo, hi = (-64, n_val + 512) if junk else (0, n_val + 1)
    tb = Q // 2 if junk else Q
    a = dict(
        cols=cols,
        undec=torch.rand((K, C), generator=gen, device=dev) < 0.7,
        has_more=torch.rand((C,), generator=gen, device=dev) < 0.6,
        pay0=ri(0, n_val, (C,)), pay1=ri(0, 8, (C,)),
        fbits=torch.rand((K, nb * 8), generator=gen, device=dev) < 0.15,
        tbits=(torch.randint(0, 256, (tb,), generator=gen, device=dev,
                             dtype=torch.uint8) if masked else None),
        dstT=ri(lo, hi, (8, Q)))
    if kind == "narrow_miss":
        a["dstT"][:2] &= -2
        a["fbits"][:, 0::2] = False
    elif kind == "none_survive":
        a["has_more"][:] = False
    elif kind == "all_survive":
        a["undec"][:] = True
        a["has_more"][:] = True
        a["fbits"][:] = False
    a["fbits"] = rows_to_words(pack_rows(a["fbits"]), K)
    return a


def opener_inputs(gen, g, K, masked):
    """A round shaped as the bottom-up opener makes it
    (``models/bfs_hybrid._bu_open``) on the device graph ``g``: the
    candidates are the unvisited vertices of degree > 0 in vertex order,
    so their columns rise and lie close together, followed by dead slots
    (column q_pad, no job) up to the next power of two; random frontier
    bits as words, and for K > 1 each job wanting most of the
    candidates."""
    from titan_tpu_torch.device import next_pow2
    dev = "cuda"
    n, dstT = g["n"], g["dstT"]
    q_pad = dstT.shape[1] - 1
    unvis = (torch.rand((n,), generator=gen, device=dev) < 0.6) \
        & (g["degc"][:n] > 0)
    cand = torch.nonzero(unvis).flatten().to(torch.int32)
    C = next_pow2(n)
    alive = torch.arange(C, device=dev) < cand.numel()
    v = torch.full((C,), n, dtype=torch.int32, device=dev)
    v[:cand.numel()] = cand
    undec = alive[None].repeat(K, 1)
    if K > 1:
        undec &= torch.rand((K, C), generator=gen, device=dev) < 0.8
    nb = (n + 9) // 8
    return dict(
        cols=torch.where(alive, g["colstart"][v.long()], q_pad),
        undec=undec, has_more=alive & (g["degc"][v.long()] > 1), pay0=v,
        pay1=torch.ones(C, dtype=torch.int32, device=dev),
        fbits=rows_to_words(pack_rows(torch.rand(
            (K, nb * 8), generator=gen, device=dev) < 0.15), K),
        tbits=(torch.randint(0, 256, (dstT.shape[1],), generator=gen,
                             device=dev, dtype=torch.uint8)
               if masked else None),
        dstT=dstT)


def call(fn, a, lanes, fill0=-7, fill1=-9):
    return fn(a["cols"], a["undec"], a["has_more"], a["pay0"], a["pay1"],
              a["fbits"], a["tbits"], a["dstT"], lanes=lanes, fill0=fill0,
              fill1=fill1)


def max_abs_err(got, ref) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(got, ref))


def phase_kernel_cases(F, G) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    tile = F.kernel_library().tt_frontier_round_tile()
    # (K, lanes, tbits given, C, Q, n_val, kind)
    cases = [(K, lanes, masked, C, C + 31, 1 << 20, "random")
             for C in (70, 1 << 20) for K in (1, 3, 16, 17)
             for lanes in (2, 8)
             for masked in (False, True)]
    q_big = (1 << 28) + (1 << 24)          # 8*Q and Q*8 pass 2^31
    big = (3 << 22) + 4099                 # far more tiles than resident
    cases += [(1, 2, True, 1 << 20, q_big, 1 << 26, "high"),
              (1, 2, False, big, 1 << 22, 1 << 22, "random")]
    cases += [(5, lanes, True, 100003, 4099, 1000, "junk")
              for lanes in (2, 8)]
    m = 1 << 20
    cases += [(40, 2, True, 100003, 1 << 16, 1 << 16, "random"),  # 2 groups
              (1, 2, False, m, m, m, "narrow_miss"),
              (3, 2, True, m, m, m, "narrow_miss"),
              (2, 2, False, m, m, m, "none_survive"),
              (2, 8, True, m, m, m, "all_survive"),
              (2, 2, False, m, m, m, "all_survive"),
              (1, 2, False, 1, 31, 1000, "random"),
              (3, 8, True, 1, 31, 1000, "random"),
              (1, 2, False, 5 * tile + 1, m, m, "random"),
              (3, 8, True, 5 * tile + 1, m, m, "random")]
    cases += [(K, lanes, masked, None, None, None, "opener")
              for K, lanes, masked in ((1, 2, False), (3, 2, True),
                                       (1, 8, False))]
    hg = G.load_or_build(CASE_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    g = G.graph_from_numpy(hg, "cuda")
    launches0 = F.frontier_round.launches
    k_total = p_total = 0.0
    for K, lanes, masked, C, Q, n_val, kind in cases:
        a = (opener_inputs(gen, g, K, masked) if kind == "opener" else
             round_inputs(gen, K, C, Q, n_val, masked, kind))
        C, Q = a["cols"].numel(), a["dstT"].shape[1]
        got = call(F.frontier_round, a, lanes)
        ref = call(F.frontier_round_reference, a, lanes)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        k_ms = cuda_ms(lambda: call(F.frontier_round, a, lanes), 5)
        p_ms = cuda_ms(lambda: call(F.frontier_round_reference, a, lanes), 2)
        what = {"random": "", "high": "columns near Q ",
                "junk": "out-of-range inputs ",
                "narrow_miss": "every candidate missing the narrow lanes ",
                "none_survive": "no survivors ",
                "all_survive": "every candidate a survivor ",
                "opener": f"opener columns of the s{CASE_SCALE} graph "}[kind]
        say(f"frontier_round K={K} lanes={lanes} "
            f"tbits={'given' if masked else 'none'} C={C} Q={Q} {what}"
            f"nsur={int(got[3])}: "
            f"{'bit-equal' if err == 0 else f'DIFFERS by {err}'}; "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        check(err == 0, "frontier_round differs from its plain version")
        check(round_bytes(a, lanes)["nsur"] == int(got[3]),
              "the byte model's survivor count differs from the kernel's")
        if kind == "all_survive":
            check(int(got[3]) == C, "not every candidate survived")
        if kind == "none_survive":
            check(int(got[3]) == 0, "a candidate survived")
        k_total, p_total = k_total + k_ms, p_total + p_ms
        del a, got, ref
    del g
    # back-to-back launches of the largest case: a stale status or a race
    # in the look-back would change a slot
    a = round_inputs(gen, 1, big, 1 << 22, 1 << 22, False)
    runs = [call(F.frontier_round, a, 2) for _ in range(REPEATS)]
    same = sum(all(torch.equal(x, y) for x, y in zip(r, runs[0]))
               for r in runs)
    say(f"frontier_round K=1 lanes=2 C={big}: {same}/{REPEATS} "
        f"back-to-back launches bit-equal to the first")
    check(same == REPEATS, "back-to-back frontier_round runs differ")
    del a, runs
    torch.cuda.empty_cache()
    n_cases = len(cases)
    say(f"phase 2: frontier_round bit-equal to its plain version in "
        f"{n_cases}/{n_cases} cases (tolerance 0: every output is "
        f"an integer) and run to run ({REPEATS} back-to-back launches), "
        f"tile {tile}, {F.frontier_round.launches - launches0} launches; "
        f"kernel {k_total:.4f} ms against plain {p_total:.4f} ms, summed "
        f"over one call of each case")


def exhaust_inputs(gen, K, P, Q, nv, c_cap, p_total, kind="random",
                   masked=False) -> dict:
    """Random sweep inputs on the card: frontier bits of density 0.02 as
    words; ``kind`` "random" (owners in sorted runs over [0, c_cap)),
    "hub" (one owner for every pair), "distinct" (each pair its own
    owner), "junk" (columns in [-Q, 2Q) and parents in [-64, nv+512), to
    hold the kernel's clamps to the plain version's). Pairs from
    ``p_total`` on are dead as ``enumerate_chunk_pairs`` lists them: the
    all-pad sink column Q - 1, whose parents are the pad vertex nv + 1,
    which no job holds."""
    dev = "cuda"

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    junk = kind == "junk"
    bits = torch.rand((K, ((nv + 9) // 8) * 8), generator=gen,
                      device=dev) < 0.02
    bits[:, nv + 1] = False
    dstT = ri(-64, nv + 512, (8, Q)) if junk else ri(0, nv + 2, (8, Q))
    dstT[:, Q - 1] = nv + 1
    cols = ri(-Q, 2 * Q, (P,)) if junk else ri(0, Q - 1, (P,))
    cols[p_total:] = Q - 1
    if kind == "hub":
        owner = torch.zeros(P, dtype=torch.int32, device=dev)
    elif kind == "distinct":
        owner = torch.arange(P, dtype=torch.int32, device=dev)
    else:
        owner = torch.sort(ri(0, c_cap, (P,))).values
    return dict(cols=cols, owner=owner,
                p_total=torch.tensor(p_total, dtype=torch.int32, device=dev),
                fbits=rows_to_words(pack_rows(bits), K),
                tbits=(torch.randint(0, 256, (Q,), generator=gen,
                                     device=dev, dtype=torch.uint8)
                       if masked else None),
                dstT=dstT, K=K, c_cap=c_cap)


def summary_inputs(F, gen, K, kind, masked=False) -> dict:
    """Sweep inputs aimed at the kernel's frontier summary
    (``exhaust_summary``): 2^20 vertices, 2^20 pairs over 2^20 columns
    (owners in sorted runs over 2^16 candidates, the last 99 pairs dead),
    parents uniform over the vertices and the pad, and the frontier
    ``kind`` says: "first", "middle", "last" (the last job holds one
    vertex, that of a summary block in the plane's middle, which 64
    columns hold as a parent), "clamps" (jobs hold the plane's first and
    last slots and vertex nv, parents at nv, nv + 1, past the plane and
    below 0), "second" (only jobs 32 and up, density 0.02), "dense"
    (density 0.5: every block set)."""
    dev, nv = "cuda", 1 << 20
    P = Q = nv
    Kp, _ = word_bits(K)
    rbytes = -(-(nv + 2) // 8)
    slots = 8 * rbytes                   # vertex slots of a plane

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    bits = torch.zeros((K, slots), dtype=torch.bool, device=dev)
    dstT = ri(0, nv + 2, (8, Q))
    dstT[:, Q - 1] = nv + 1
    if kind in ("first", "middle", "last"):
        nb = rbytes * Kp                 # a plane's bytes
        sh, _ = F.summary_shape(nb, K)
        per = (8 << sh) // Kp            # vertices a summary bit
        v0 = (((nb + (1 << sh) - 1) >> sh) // 2) * per
        v = {"first": v0, "middle": v0 + per // 2,
             "last": v0 + per - 1}[kind]
        bits[K - 1, v] = True
        dstT[ri(0, 8, (64,)).long(), ri(0, Q - 1, (64,)).long()] = v
    elif kind == "clamps":
        bits[0, 0] = bits[K - 1, slots - 1] = bits[K // 2, nv] = True
        at = ri(0, Q - 1, (256,)).long()
        for i, par in enumerate((nv, nv + 1, slots + 5, 2**31 - 1, -5,
                                 -2**31)):
            dstT[i % 8, at[i::6]] = par
    elif kind == "second":
        bits[32:] = torch.rand((K - 32, slots), generator=gen,
                               device=dev) < 0.02
    else:
        bits = torch.rand((K, slots), generator=gen, device=dev) < 0.5
    bits[:, nv + 1] = False              # the pad, every dead pair's parent
    cols = ri(0, Q - 1, (P,))
    cols[P - 99:] = Q - 1
    return dict(cols=cols, owner=torch.sort(ri(0, 1 << 16, (P,))).values,
                p_total=torch.tensor(P - 99, dtype=torch.int32, device=dev),
                fbits=rows_to_words(pack_rows(bits), K),
                tbits=(torch.randint(0, 256, (Q,), generator=gen,
                                     device=dev, dtype=torch.uint8)
                       if masked else None),
                dstT=dstT, K=K, c_cap=1 << 16)


def check_summary(F, e, what: str) -> None:
    """The summary kernel bit-equal to its plain version on ``e``'s
    words."""
    got = F._launch_summary(e["fbits"], e["K"])
    ref = F.exhaust_summary_reference(e["fbits"], e["K"])
    check(torch.equal(got, ref), f"exhaust_summary differs from its plain "
          f"version (K={e['K']}, {what})")


def phase_exhaust_cases(F) -> None:
    """``batched_exhaust``'s kernel against its plain version on the card,
    bit-equal, then back-to-back launches each bit-equal to the first;
    its summary kernel bit-equal to the summary's plain version in every
    case; then the cases aimed at the summary (``summary_inputs``)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    m = 1 << 20
    # (K, P, Q, nv, c_cap, p_total, kind, tbits given, what)
    cases = [(K, m, m, m, 1 << 16, m - 12345, "random", False, "")
             for K in (1, 3, 16, 40)]
    cases += [(16, m, m, m, 1 << 16, m - 99, "random", True, "tbits "),
              (16, 1 << 22, m, m, 1 << 10, (1 << 22) - 7, "hub", False,
               "one owner over 2^17 warps "),
              (16, m, m, m, m, m, "distinct", False,
               "each pair its own owner "),
              (3, 1 << 16, 4099, 1000, 512, 0, "random", False,
               "p_total 0 "),
              (3, 1 << 16, 4099, 1000, 512, 1, "random", False,
               "p_total 1 "),
              (5, 100003, 4099, 1000, 4096, 90001, "junk", True,
               "out-of-range columns and parents "),
              (16, 100003, 4099, 1000, 4096, 100003, "junk", False,
               "out-of-range columns and parents, every pair live ")]
    launches0 = F.batched_exhaust.launches
    s_launches0 = F._launch_summary.launches
    k_total = p_total = 0.0

    def one(e, what):
        nonlocal k_total, p_total
        got = exhaust_call(F.batched_exhaust, e)
        ref = exhaust_call(F.batched_exhaust_reference, e)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        k_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust, e), 5)
        p_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust_reference, e),
                       2)
        say(f"batched_exhaust K={e['K']} P={e['cols'].numel()} p_total="
            f"{int(e['p_total'])} c_cap={e['c_cap']} {what}("
            f"{int(got.sum())} candidate bits found): "
            f"{'bit-equal' if same else 'DIFFERS'}; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms")
        check(same, "batched_exhaust differs from its plain version")
        check_summary(F, e, what)
        k_total, p_total = k_total + k_ms, p_total + p_ms
        return got

    for K, P, Q, nv, c_cap, pt, kind, masked, what in cases:
        e = exhaust_inputs(gen, K, P, Q, nv, c_cap, pt, kind, masked)
        got = one(e, what)
        if pt == 0:
            check(not got.any(), "p_total 0 found a candidate")
        del e, got
    # (K, frontier, tbits given): the summary's blocks, its clamps, the
    # second plane alone, every block set
    aimed = [(K, kind, False) for K in (1, 3, 16, 32)
             for kind in ("first", "middle", "last")]
    aimed += [(16, "middle", True), (32, "last", True)]
    aimed += [(K, "clamps", K in (3, 40)) for K in (1, 3, 16, 32, 40)]
    aimed += [(40, "second", False), (40, "second", True),
              (16, "dense", False), (40, "dense", True)]
    for K, kind, masked in aimed:
        e = summary_inputs(F, gen, K, kind, masked)
        got = one(e, f"summary case {kind}{', tbits' if masked else ''} ")
        check(bool(got.any()) or masked, f"the summary case {kind} at "
              f"K={K} found nothing: it tests no bit")
        del e, got
    for K, P, Q, nv, c_cap, pt, kind, masked, _ in (cases[5], cases[3]):
        e = exhaust_inputs(gen, K, P, Q, nv, c_cap, pt, kind, masked)
        runs = [exhaust_call(F._launch_exhaust, e) for _ in range(REPEATS)]
        same = sum(torch.equal(r, runs[0]) for r in runs)
        say(f"batched_exhaust K={K} P={P} ({kind}): {same}/{REPEATS} "
            f"back-to-back launches bit-equal to the first")
        check(same == REPEATS, "back-to-back batched_exhaust runs differ")
        del e, runs
    torch.cuda.empty_cache()
    n = len(cases) + len(aimed)
    say(f"phase 2: batched_exhaust and its summary bit-equal to their "
        f"plain versions in {n}/{n} cases ({len(aimed)} aimed at the "
        f"summary: a vertex at a block's first, middle and last slot, the "
        f"clamps, the second plane alone, every block set; tolerance 0: "
        f"bits) and run to run ({REPEATS} back-to-back launches of the hub "
        f"and the K = 40 cases), "
        f"{F.batched_exhaust.launches - launches0} sweep and "
        f"{F._launch_summary.launches - s_launches0} summary launches; "
        f"kernel {k_total:.4f} ms against plain {p_total:.4f} ms, summed "
        f"over one call of each case")


def hub_flags(seed: int, e: int, tile: int):
    """Hub-like segment starts on the card: segments spanning 2-300 tiles,
    each followed by a run of 1-8 tiles of short segments (a start every
    32 elements on average)."""
    rng = np.random.default_rng(seed)
    flags = rng.random(e) < 1 / 32
    pos = int(rng.integers(0, tile))
    while pos < e:
        span = int(rng.integers(2 * tile, 300 * tile + 1))
        flags[pos] = True
        flags[pos + 1:pos + span] = False
        pos += span
        if pos < e:
            flags[pos] = True
        pos += int(rng.integers(tile, 8 * tile + 1))
    return torch.from_numpy(flags).cuda()


def seg_inputs(gen, e: int, dtype, density, first: bool = True,
               tile: int = 0):
    """Random scan inputs on the card: values uniform in [-1, 1) or over
    the whole int32 range, segment starts with ``density`` (or hub-like
    ones, ``hub_flags``, when it is "hubs"), and ``flags[0]`` set to
    ``first``."""
    if dtype == torch.float32:
        values = torch.rand((e,), generator=gen, device="cuda") * 2 - 1
    else:
        values = torch.randint(-2**31, 2**31, (e,), generator=gen,
                               device="cuda", dtype=torch.int32)
    if density == "hubs":
        flags = hub_flags(int(torch.randint(0, 2**31, (), generator=gen,
                                            device="cuda")), e, tile)
    else:
        flags = torch.rand((e,), generator=gen, device="cuda") < density
    flags[0] = first
    return values, flags


def scan_error(S, got, ref, values, flags, combine) -> float:
    """max |got - ref|; raises unless exact, or, for float32 sums, within
    FLOAT_SUM_RTOL of the scan of |values| at every position."""
    err = float((got.double() - ref.double()).abs().max())
    if combine == "sum" and values.dtype == torch.float32:
        scale = S.seg_scan_reference(values.abs(), flags, "sum")
        ok = bool(((got - ref).abs() <= FLOAT_SUM_RTOL * scale).all())
    else:
        ok = bool(torch.equal(got, ref))
    check(ok, f"seg_scan {combine} {values.dtype} E={values.numel()} "
          f"differs from its plain version by {err}")
    return err


def phase_seg_scan_cases(S) -> None:
    gen = torch.Generator(device="cuda").manual_seed(11)
    tile = S.kernel_library().tt_seg_scan_tile()
    big = (3 << 22) + 4099
    cases = [(e, d, True, "random starts") for e, d in (
        (1, 0.5), (70, 0.2), (tile - 1, 0.01), (tile, 0.01),
        (tile + 1, 0.01), (1 << 20, 1e-3), (big, 1e-5))]
    one, hubs = ((big, 0.0, False, "one segment spanning every tile"),
                 (big, "hubs", True, "hub-like segments spanning 2-300 "
                                     "tiles"))
    cases += [one, hubs, (big, 1.0, True, "every element its own segment"),
              (1 << 20, 1e-3, False, "flags[0] False")]
    launches0 = S.seg_scan.launches
    k_total = p_total = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.int32):
        for combine in S.COMBINES:
            for e, density, first, what in cases:
                values, flags = seg_inputs(gen, e, dtype, density, first,
                                           tile)
                got = S.seg_scan(values, flags, combine)
                ref = S.seg_scan_reference(values, flags, combine)
                err = scan_error(S, got, ref, values, flags, combine)
                k_ms = cuda_ms(lambda: S.seg_scan(values, flags, combine), 5)
                p_ms = cuda_ms(lambda: S.seg_scan_reference(values, flags,
                                                            combine), 2)
                again = S.seg_scan(values, flags, combine)
                check(torch.equal(got, again), "two seg_scan runs differ")
                if e >= big:
                    say(f"seg_scan {combine} {str(dtype)[6:]} E={e} "
                        f"({what}): max_abs_err {err:.3g}; kernel "
                        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
                k_total, p_total = k_total + k_ms, p_total + p_ms
                n_cases += 1
                del values, flags, got, ref, again
    for e, density, first, what in (one, hubs):
        values, flags = seg_inputs(gen, e, torch.float32, density, first,
                                   tile)
        runs = [S.seg_scan(values, flags, "sum") for _ in range(REPEATS)]
        same = sum(torch.equal(r, runs[0]) for r in runs)
        say(f"seg_scan sum float32 E={e} ({what}): {same}/{REPEATS} "
            f"back-to-back launches bit-equal to the first")
        check(same == REPEATS, "back-to-back seg_scan runs differ")
        del values, flags, runs
    torch.cuda.empty_cache()
    say(f"phase 3: seg_scan agrees with its plain version in "
        f"{n_cases}/{n_cases} cases (min, max and int32 sums exact; "
        f"float32 sums within {FLOAT_SUM_RTOL:g} of the scan of |x|), "
        f"bit-equal run to run ({REPEATS} back-to-back float32 sums twice), "
        f"tile {tile}, {S.seg_scan.launches - launches0} launches; kernel "
        f"{k_total:.4f} ms against plain {p_total:.4f} ms, summed over one "
        f"call of each case")


#: the K-row scan's cases: K jobs, E below a tile, odd across tiles,
#: E = 2 mod 4 (the s22 engine's: its odd rows start 8 bytes off 16 when
#: ld = E), and the hub-like starts over E = 2 mod 4
ROW_KS = (1, 3, 16)


def row_inputs(gen, k: int, e: int, ld: int, dtype, density, tile: int):
    """K rows of random scan inputs ([k, ld]; columns past E hold values
    the scan must not read) under one flag array [E]."""
    values, _ = seg_inputs(gen, k * ld, dtype, 0.0)
    _, flags = seg_inputs(gen, e, dtype, density, True, tile)
    return values.view(k, ld), flags


def phase_seg_scan_rows(S) -> None:
    """The K-row launch: every row bit-equal to the one-row launch on that
    row (a contiguous copy, so 16-byte aligned), the whole against the
    plain version (exact, float32 sums within FLOAT_SUM_RTOL); then
    REPEATS back-to-back launches of the largest hub case, each bit-equal
    to the first."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    tile = S.kernel_library().tt_seg_scan_tile()
    shapes = [(70, 0.2, "below a tile"), (5 * tile + 1, 0.01, "odd"),
              ((1 << 20) + 2, 1e-3, "2 mod 4"),
              ((1 << 22) + 2, "hubs", "2 mod 4, hub-like starts")]
    launches0 = S.seg_scan.launches
    n_cases = 0
    for k in ROW_KS:
        for e, density, what in shapes:
            for ld in (e, e + 4 - e % 4):
                for dtype in (torch.float32, torch.int32):
                    for combine in S.COMBINES:
                        values, flags = row_inputs(gen, k, e, ld, dtype,
                                                   density, tile)
                        got = S.seg_scan(values, flags, combine)
                        check(tuple(got.shape) == (k, e),
                              f"K-row seg_scan shape {tuple(got.shape)}")
                        for r in range(k):
                            one = S.seg_scan(values[r, :e].contiguous(),
                                             flags, combine)
                            check(torch.equal(got[r], one),
                                  f"K-row seg_scan {combine} {dtype} K={k} "
                                  f"E={e} ld={ld} ({what}): row {r} differs "
                                  "from the one-row launch")
                        ref = S.seg_scan_reference(values, flags, combine)
                        scan_error(S, got, ref, values[:, :e], flags,
                                   combine)
                        n_cases += 1
                        del values, flags, got, ref
    e = shapes[-1][0]
    values, flags = row_inputs(gen, ROW_KS[-1], e, e, torch.float32,
                               "hubs", tile)
    runs = [S.seg_scan(values, flags, "sum") for _ in range(REPEATS)]
    same = sum(torch.equal(r, runs[0]) for r in runs)
    check(same == REPEATS, "back-to-back K-row seg_scan runs differ")
    del values, flags, runs
    torch.cuda.empty_cache()
    say(f"phase 3: K-row seg_scan (K in {ROW_KS}, E in "
        f"{[sh[0] for sh in shapes]}, ld = E and padded to 4, both types, "
        f"every combine): {n_cases}/{n_cases} cases, every row bit-equal to "
        f"the one-row launch and the whole to the plain version (float32 "
        f"sums within {FLOAT_SUM_RTOL:g}); {same}/{REPEATS} back-to-back "
        f"K={ROW_KS[-1]} float32 sums over E={e} (hubs) bit-equal to the "
        f"first; {S.seg_scan.launches - launches0} launches")


def sample_sources(deg, k: int):
    """bench.py's rule: distinct sources of degree > 0, default_rng(12345)."""
    rng = np.random.default_rng(12345)
    nonzero = np.flatnonzero(np.asarray(deg) > 0)
    return [int(s) for s in rng.choice(nonzero, size=min(k, len(nonzero)),
                                       replace=False)]


#: BFS thresholds that send every level past the head's first through the
#: top-down steps and the bottom-up rounds: below 2^21 vertices the
#: endgame would otherwise finish the whole search
FORCE_BU = {"END_C_CAP": 0, "END_P_CAP": 0, "HEAD_F_CAP": 1}


def phase_small(F, P, G) -> None:
    hg = G.load_or_build(SMALL_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    g_gpu = G.graph_from_numpy(hg, "cuda")
    g_cpu = G.graph_from_numpy(hg, "cpu")
    default = {k: getattr(P, k) for k in FORCE_BU}
    for forced in (False, True):
        for k, v in (FORCE_BU if forced else default).items():
            setattr(P, k, v)
        F.frontier_round.launches = 0
        for src in sample_sources(hg["deg"], 2):
            d_gpu, lv_gpu = P.frontier_bfs_hybrid(g_gpu, src)
            d_cpu, lv_cpu = P.frontier_bfs_hybrid(g_cpu, src, device="cpu")
            check(np.array_equal(d_gpu, d_cpu) and lv_gpu == lv_cpu,
                  f"s{SMALL_SCALE} source {src} (forced bottom-up: "
                  f"{forced}): CUDA BFS differs from CPU BFS")
        launches = F.frontier_round.launches
        say(f"phase 4: s{SMALL_SCALE} CUDA BFS equals the CPU BFS "
            f"(2 sources, {lv_gpu} levels, forced bottom-up: {forced}), "
            f"frontier_round launches {launches}")
    for k, v in default.items():
        setattr(P, k, v)
    check(launches > 0, "the CUDA BFS never launched frontier_round")


def fused_plain(PF, g, src: int, max_levels: int = 1000) -> tuple:
    """The plain fused BFS on ``g``'s device: ``(dist [n+2], levels,
    trace)``, the trace ``(level, mode, chunks gathered)`` a decision."""
    g["_trace_modes"] = trace = []
    try:
        dist, levels = PF.fused_bfs_reference(g, src, max_levels)
    finally:
        del g["_trace_modes"]
    return dist, levels, trace


def _first_hit_chunks(PF, g, dist, found, level: int,
                      rounds: int = 8) -> int:
    """Chunk columns that bottom-up vertices ``found`` (int64, each with a
    parent at ``level``) read up to and including the first that holds
    such a parent, walking their chunks in order."""
    dstT, colstart, degc = g["dstT"], g["colstart"], g["degc"]

    def hits(cols):
        return torch.cat([(dist[dstT[:, cols[i:i + PF.SLICE]].long()]
                           == level).any(dim=0)
                          for i in range(0, cols.numel(), PF.SLICE)])

    # most parents sit in the first few chunks: ``rounds`` of those a
    # chunk at a time, then every remaining chunk of the rest at once,
    # keeping the first hit's index (the count does not depend on rounds)
    chunks, todo, r = 0, found, 0
    while todo.numel() and r < rounds:
        hit = hits(colstart[todo].long() + r)
        chunks += (r + 1) * int(hit.sum())
        todo, r = todo[~hit], r + 1
    if todo.numel() == 0:
        return chunks
    rem = (degc[todo] - r).long()
    big = torch.iinfo(torch.int64).max
    for lo, hi in PF._slices(rem):
        base = colstart[todo[lo:hi]].long()
        cols, owner = PF._pairs(base + r, rem[lo:hi])
        idx = cols - base[owner]
        first = torch.full((hi - lo,), big, dtype=torch.int64,
                           device=cols.device).scatter_reduce_(
            0, owner, torch.where(hits(cols), idx, big), reduce="amin")
        check(bool((first < big).all()), "fused_bytes: a vertex found "
              f"at level {level + 1} has no parent at {level}")
        chunks += int((first + 1).sum())
    return chunks


def fused_bytes(PF, g, dist, trace) -> dict:
    """The fused BFS's byte bound, worked out from what the function
    reads given its decisions (``trace``, the plain version's) and its
    result (``dist``, validated): each top-down level reads 32 B of dstT
    for each chunk column of its frontier and tests its neighbours
    against a visited bitmap (n/8 B), one 32 B sector for each distinct
    sector they fall in (``vis_td``); each bottom-up level, the endgame's
    included, writes the frontier's bitmap (n/8 B, which L2 holds) and
    reads it once, and each candidate reads 32 B of dstT a chunk up to
    and including the first that holds a parent, or all its chunks where
    it has none; ``dist`` is written once, ``colstart`` and ``degc`` read
    once. Returns the parts and the ``bound``; ``total`` is the older
    model, which tests the neighbours against ``dist`` (one 32 B sector
    of ``dist`` for each distinct sector, ``dist_td``) and is kept only
    for comparison with the records taken by it; ``plain`` is what the
    plain version gathered."""
    n = g["n"]
    degc = g["degc"][:n].long()
    d = dist[:n].long()
    parts = {"dstT_td": 0, "dist_td": 0, "dstT_bu": 0, "bitmaps": 0}
    vis_td = 0

    def bottom_up(level):
        cand = (d > level) & (degc > 0)
        found = torch.nonzero(d == level + 1).flatten()
        miss = cand & (d != level + 1)
        parts["dstT_bu"] += 32 * (int(degc[miss].sum()) + _first_hit_chunks(
            PF, g, dist, found, level))
        parts["bitmaps"] += 2 * (-(-(n + 2) // 8))
        return found.numel()

    for level, mode, _ in trace:
        if mode == "td":
            fr = torch.nonzero(d == level).flatten()
            counts = degc[fr]
            parts["dstT_td"] += 32 * int(counts.sum())
            seen = torch.zeros(n // 8 + 1, dtype=torch.bool,
                               device=dist.device)
            seen_vis = torch.zeros(n // 256 + 1, dtype=torch.bool,
                                   device=dist.device)
            for lo, hi in PF._slices(counts):
                cols, _ = PF._pairs(g["colstart"][fr[lo:hi]].long(),
                                   counts[lo:hi])
                nbr = g["dstT"][:, cols].reshape(-1).long()
                nbr = nbr[nbr < n]
                seen[nbr >> 3] = True
                seen_vis[nbr >> 8] = True
            parts["dist_td"] += 32 * int(seen.sum())
            vis_td += 32 * int(seen_vis.sum())
        elif mode == "bu":
            bottom_up(level)
        else:                    # bottom-up levels until one finds nothing
            lvl = level
            while bottom_up(lvl):
                lvl += 1
    parts["once"] = 4 * (n + 2) + 8 * (n + 1)
    parts["total"] = sum(parts.values())
    parts["vis_td"] = vis_td
    parts["bound"] = parts["total"] - parts["dist_td"] + vis_td
    parts["plain"] = 32 * sum(c for _, _, c in trace) + parts["once"]
    return parts


def check_fused(PF, g, src: int, where: str, max_levels: int = 1000,
                want=None) -> dict:
    """The fused kernel against its plain version on the card, from one
    source: dist over [0, n), levels and the modes bit for bit, one
    launch. ``want``: a validated dist the kernel's must equal too."""
    n = g["n"]
    before = PF.fused_bfs.launches
    g["_trace_modes"] = modes = []
    try:
        dk, lk = PF.fused_bfs(g, src, max_levels)
    finally:
        del g["_trace_modes"]
    mk = [m for _, m, _ in modes]
    check(PF.fused_bfs.launches == before + 1, f"{where}: the fused BFS "
          f"launched {PF.fused_bfs.launches - before} times")
    dp, lp, trace = fused_plain(PF, g, src, max_levels)
    mp = [m for _, m, _ in trace]
    err = int((dk[:n].long() - dp[:n].long()).abs().max())
    check(torch.equal(dk[:n], dp[:n]) and lk == lp and mk == mp,
          f"{where}: the fused kernel from {src} differs from its plain "
          f"version (levels {lk} against {lp}, modes {mk} against {mp}, "
          f"max |dist| difference {err})")
    if want is not None:
        check(torch.equal(dk[:n], want[:n]), f"{where}: the fused kernel "
              f"from {src} differs from frontier_bfs_hybrid")
    return {"levels": lk, "modes": mk, "trace": trace, "max_abs_err": err}


#: graphs whose counts land on the fused BFS's mode rule
#: (``fused_threshold_cases``): (rule, graph seed, level). "m8f": m8_f ==
#: m8_unvis // 8 with f > 1 there, a top-down level one chunk short of
#: bottom-up (seeds found by scanning); "end_c": n_unvis == end_c there,
#: the endgame's first level; "top_f": f == top_f there, a top-down level
#: one vertex short of a forced bottom-up one
FUSED_THRESHOLDS = (("m8f", 97, 1), ("m8f", 212, 1), ("m8f", 326, 2),
                    ("m8f", 332, 2), ("end_c", 4, 1), ("end_c", 5, 2),
                    ("top_f", 4, 1), ("top_f", 7, 1))


def random_sym_edges(seed: int) -> tuple:
    """``(n, src, dst)``: tests/test_frontier_models.py's random graph draw
    for ``seed``, symmetrized."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(80, 400))
    m = int(rng.integers(2 * n, 8 * n))
    src = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, n, m).astype(np.int64)
    return n, np.concatenate([src, dst]), np.concatenate([dst, src])


def level_counts(degc, dist) -> list:
    """``[f, m8_f, m8_unvis, n_unvis]`` at the top of each level of a BFS
    whose distances are ``dist`` (numpy, INF for the unreached), as the
    fused BFS's mode rule reads them."""
    dc = np.asarray(degc, np.int64)[:len(dist)]
    out, level = [], 0
    while (dist == level).any():
        fr, un = dist == level, dist > level
        out.append([int(fr.sum()), int(dc[fr].sum()), int(dc[un].sum()),
                    int((un & (dc > 0)).sum())])
        level += 1
    return out


def fused_threshold_cases(from_arrays, PH, device) -> list[dict]:
    """The ``FUSED_THRESHOLDS`` graphs (``from_arrays`` builds a snapshot
    of either package) from their first vertex with an edge: each dict's
    ``snap``, ``g`` (the chunked CSR on ``device``), ``source``, ``level``,
    its ``counts``, the ``mode`` the rule must take there, and ``caps``:
    ``END_C_CAP``, ``END_P_CAP`` and the top top-down pair ``top`` (None:
    the module's) that put the counts on the threshold."""
    cases = []
    for rule, seed, level in FUSED_THRESHOLDS:
        n, src, dst = random_sym_edges(seed)
        snap = from_arrays(n, src, dst)
        source = int(np.flatnonzero(np.bincount(src, minlength=n) > 0)[0])
        g = PH.build_chunked_csr(snap, device)
        counts = level_counts(g["degc"].cpu().numpy(),
                              host_bfs(n, src, dst, source))
        f, m8f, m8u, nu = counts[level]
        caps, mode = {"END_C_CAP": 1, "END_P_CAP": 1, "top": None}, "td"
        if rule == "m8f":
            ok = f > 1 and m8f == m8u // 8
        elif rule == "end_c":
            caps.update(END_C_CAP=nu, END_P_CAP=1 << 30)
            ok, mode = counts[level - 1][3] > nu, "endgame"
        else:
            caps["top"] = (f, 1 << 30)
            ok = not (m8f > m8u // 8 and f > 1)
        check(ok, f"threshold graph {rule} (seed {seed}) misses its "
              f"threshold at level {level}: counts {counts[level]}")
        cases.append({"rule": rule, "seed": seed, "snap": snap, "g": g,
                      "source": source, "level": level,
                      "counts": counts[level], "mode": mode, "caps": caps})
    return cases


#: leaves of the star whose centre the fused kernel walks with every
#: block (more than its grid-list threshold of 2^14 chunks)
STAR_LEAVES = 140_000


def giant_star_cases(from_arrays, PH, device) -> list[dict]:
    """A star of ``STAR_LEAVES`` leaves round vertex 0, the last leaf also
    joined to a vertex ``s`` with a second neighbour: from leaf 1
    (top-down levels expand the centre) and from ``s`` with the top
    top-down pair at one vertex (level 1 is bottom-up and the centre
    finds its parent in its last chunk). Each dict as
    ``fused_threshold_cases``'s, without counts."""
    m = STAR_LEAVES
    s = m + 1
    src = np.concatenate([np.zeros(m, np.int64), [s, s]])
    dst = np.concatenate([np.arange(1, m + 1), [m, m + 2]])
    snap = from_arrays(m + 3, np.concatenate([src, dst]),
                       np.concatenate([dst, src]))
    g = PH.build_chunked_csr(snap, device)
    caps = {"END_C_CAP": 1, "END_P_CAP": 1, "top": None}
    return [{"rule": "star, top-down", "seed": 0, "snap": snap, "g": g,
             "source": 1, "level": 1, "mode": "td", "caps": caps},
            {"rule": "star, bottom-up", "seed": 0, "snap": snap, "g": g,
             "source": s, "level": 1, "mode": "bu",
             "caps": {**caps, "top": (1, 1 << 30)}}]


def phase_fused_small(PF, P, G, card) -> None:
    """Phase 4b at scale 16: the fused kernel against its plain version
    on the card and against frontier_bfs_hybrid, with the JAX endgame
    caps and with them at 1 (every level top-down or bottom-up), and
    with max_levels cutting the search short; then on the threshold
    graphs (``fused_threshold_cases``), whose counts land on the mode
    rule, with each case's caps."""
    from titan_tpu_torch.olap import snapshot as SN

    hg = G.load_or_build(SMALL_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    g = G.graph_from_numpy(hg, "cuda")
    saved = (PF.END_C_CAP, PF.END_P_CAP, PF.FUSED_TD_MAX)
    seen, runs = set(), 0
    try:
        for forced in (False, True):
            PF.END_C_CAP, PF.END_P_CAP = (1, 1) if forced else saved[:2]
            for src in sample_sources(hg["deg"], 2):
                want, _ = P.frontier_bfs_hybrid(g, src, return_device=True)
                r = check_fused(PF, g, src, f"phase 4b s{SMALL_SCALE}",
                                want=want)
                seen.update(r["modes"])
                runs += 1
            for cut in (1, 2, 3):
                r = check_fused(PF, g, src, f"phase 4b s{SMALL_SCALE} "
                                f"max_levels={cut}", max_levels=cut)
                check(r["levels"] <= cut, f"max_levels={cut} gave "
                      f"{r['levels']} levels")
                runs += 1
        cases = (fused_threshold_cases(SN.from_arrays, P, "cuda")
                 + giant_star_cases(SN.from_arrays, P, "cuda"))
        for c in cases:
            caps = c["caps"]
            PF.END_C_CAP, PF.END_P_CAP = caps["END_C_CAP"], caps["END_P_CAP"]
            PF.FUSED_TD_MAX = caps["top"] or saved[2]
            r = check_fused(PF, c["g"], c["source"], f"phase 4b threshold "
                            f"graph {c['rule']} (seed {c['seed']})")
            check(r["modes"][c["level"]] == c["mode"], f"phase 4b: the "
                  f"threshold graph {c['rule']} (seed {c['seed']}) took "
                  f"{r['modes']}, not {c['mode']} at level {c['level']}")
            runs += 1
    finally:
        PF.END_C_CAP, PF.END_P_CAP, PF.FUSED_TD_MAX = saved
    check(seen >= {"endgame", "td", "bu"}, f"phase 4b took only {seen}")
    say(f"phase 4b: s{SMALL_SCALE} fused BFS kernel bit-equal to its plain "
        f"version on {card} in {runs} runs (dist, levels, modes; endgame "
        f"caps JAX's and 1; max_levels 1-3; {len(cases) - 2} threshold "
        f"graphs whose counts land on the mode rule and a star whose centre "
        f"every block walks, top-down and bottom-up, each taking its mode) "
        f"and "
        f"to frontier_bfs_hybrid; modes {sorted(seen)}; one launch a BFS")


def phase_fused_main(PF, G, g, hg, per_source, teps6, card) -> dict:
    """Phase 6b on phase 6's scale-26 graph: the fused kernel from
    bench.py's sources, each dist bit-equal to phase 6's validated
    frontier_bfs_hybrid result and levels to the plain fused version's on
    the card, one launch a BFS; the wall and TEPS a source; the kernel's
    time against its byte bound and the plain version's."""
    from titan_tpu_torch.device import INF

    deg_orig = np.asarray(hg["deg_orig"])
    deg_dev = G.device_degrees(deg_orig, "cuda")
    n = g["n"]
    PF.fused_bfs(g, per_source[0]["source"])                # warm-up
    rows, bounds = [], []
    PF.fused_bfs.launches = 0
    # ---- the main path, with the kernel count from 0
    for r in per_source:
        src = r["source"]
        best = None
        for _ in range(REPS):
            (dist, levels), t = wall_s(lambda: PF.fused_bfs(g, src))
            if best is None or t < best[2]:
                best = (dist, levels, t)
        rows.append((src, *best))
    launches = PF.fused_bfs.launches
    # ---- end of the main path
    check(launches == REPS * len(per_source), f"phase 6b: {launches} "
          f"launches for {REPS * len(per_source)} BFS runs")
    out, plain_ms, ms = [], [], []
    for (src, dist, levels, t), r in zip(rows, per_source):
        check(torch.equal(dist[:n], r["dist"][:n]), f"phase 6b: the fused "
              f"kernel from {src} differs from phase 6's validated dist")
        (dp, lp, trace), p_s = timed(lambda: fused_plain(PF, g, src))
        check(torch.equal(dist[:n], dp[:n]) and levels == lp,
              f"phase 6b: the fused kernel from {src} differs from its "
              f"plain version (levels {levels} against {lp})")
        m2, _ = G.reachable_edge_sum(dist[:n], deg_orig, INF,
                                     deg_dev=deg_dev)
        (_, _), k_s = timed(lambda: PF.fused_bfs(g, src))
        g["_trace_split"] = split = []
        try:
            PF.fused_bfs(g, src)
        finally:
            del g["_trace_split"]
        parts = fused_bytes(PF, g, dist, trace)
        bounds.append(parts["bound"] / HBM_BYTES_PER_S * 1e3)
        ms.append(k_s * 1e3)
        plain_ms.append(p_s * 1e3)
        out.append({"source": src, "levels": levels,
                    "hybrid_levels": r["levels"],
                    "modes": [m for _, m, _ in trace], "t_bfs": t,
                    "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
                    "bound_ms": bounds[-1],
                    "dist_model_ms": parts["total"] / HBM_BYTES_PER_S * 1e3,
                    "bytes": parts,
                    "m_traversed": m2 // 2, "teps": (m2 // 2) / t,
                    "split": split[0]})
        del dist, dp
    teps = len(out) / sum(1.0 / o["teps"] for o in out)
    say(f"phase 6b: fused BFS (one cooperative launch a BFS) at s{SCALE} on "
        f"{card}: TEPS {teps:.6g} (harmonic mean over {len(out)} sources, "
        f"best of {REPS}) against phase 6's {teps6:.6g}; dist bit-equal to "
        f"phase 6's validated results and to the plain fused version, whose "
        f"levels it equals; per source " + json.dumps(
            [{k: v for k, v in o.items() if k != "split"} for o in out]))
    for o in out:
        sp = o["split"]
        say(f"phase 6b: split of the fused kernel from {o['source']} on "
            f"{card} (%globaltimer after each grid barrier, ms): first "
            f"pass {sp['init_ms']:.4f}, stamped total {sp['total_ms']:.4f}; "
            f"by level (mode, top, scan, walk_lists) "
            + json.dumps([[r["mode"], round(r["top_ms"], 4),
                           round(r["scan_ms"], 4), round(r["walk_ms"], 4)]
                          for r in sp["levels"]]))
    del deg_dev
    torch.cuda.empty_cache()
    i = int(np.argmax(ms))
    return {**FUSED_KERNEL, "launches": launches, "max_abs_err": 0,
            "ms": ms[i], "plain_ms": plain_ms[i], "bound_ms": bounds[i],
            "bound_by": "bytes", "library_ms": None,
            "per_source": [{k: o[k] for k in (
                "source", "levels", "hybrid_levels", "ms", "plain_ms",
                "bound_ms", "dist_model_ms", "bytes", "t_bfs", "teps",
                "split")}
                for o in out],
            "teps": teps}


def timed(fn):
    """(fn(), seconds by CUDA events around the call)."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1) / 1e3


def wall_s(fn):
    """(fn(), host seconds around the call, the card synchronised)."""
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t


def host_pagerank(snap, alpha: float, iterations: int):
    """Float64 PageRank on the host with scipy.sparse over the snapshot's
    edges, by models/pagerank.py's formula."""
    import scipy.sparse as sp
    n = snap.n
    a = sp.csr_matrix((np.ones(snap.num_edges), snap.src, snap.indptr_in),
                      shape=(n, n))
    deg = snap.out_degree.astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    rank = np.full(n, 1.0 / n)
    for _ in range(iterations):
        rank = (1.0 - alpha) / n + alpha * (a @ (rank * inv))
    return rank


def min_label_components(snap) -> np.ndarray:
    """Each vertex's smallest vertex id in its component (scipy)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    n = snap.n
    a = sp.csr_matrix((np.ones(snap.num_edges, np.int8), snap.src,
                       snap.indptr_in), shape=(n, n))
    _, comp = connected_components(a, directed=True, connection="weak")
    _, first = np.unique(comp, return_index=True)   # lowest id of each
    return first[comp].astype(np.int32)


def seg_scan_replay(S, SG, g, msg, n, deg) -> dict:
    """The widest main-path call, one PageRank superstep's [E] messages:
    agreement with the plain version, times, the byte bound, and
    torch.segment_reduce (the same combine, scan and gather, in one
    PyTorch call) timed beside the port's combine. Also, at the same
    flags, the int32 ``min`` of BFS and WCC over random labels (exact
    against the plain version) and a plain ``copy_`` of the messages,
    the rate the card reaches for traffic with no dependences."""
    got = S.seg_scan(msg, g.flags, "sum")
    ref = S.seg_scan_reference(msg, g.flags, "sum")
    err = scan_error(S, got, ref, msg, g.flags, "sum")
    ms = cuda_ms(lambda: S.seg_scan(msg, g.flags, "sum"), 20, warmup=2)
    plain_ms = cuda_ms(lambda: S.seg_scan_reference(msg, g.flags, "sum"), 3)
    del got, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    labels = torch.randint(0, n, msg.shape, generator=gen, device="cuda",
                           dtype=torch.int32)
    scan_error(S, S.seg_scan(labels, g.flags, "min"),
               S.seg_scan_reference(labels, g.flags, "min"), labels,
               g.flags, "min")
    min_ms = cuda_ms(lambda: S.seg_scan(labels, g.flags, "min"), 20,
                     warmup=2)
    dst = torch.empty_like(msg)
    copy_ms = cuda_ms(lambda: dst.copy_(msg), 20, warmup=2)
    del labels, dst

    def combine():
        return SG.segment_combine(msg, g.dst, n, "sum", last_idx=g.last_idx,
                                  seg_has=g.seg_has, flags=g.flags)
    lengths = torch.from_numpy(deg.astype(np.int64)).cuda()

    def library():
        return torch.segment_reduce(msg, "sum", lengths=lengths, unsafe=True)
    check(torch.allclose(combine(), library(), rtol=FLOAT_SUM_RTOL,
                         atol=0.0), "segment_combine and "
          "torch.segment_reduce disagree")
    combine_ms = cuda_ms(combine, 10, warmup=2)
    library_ms = cuda_ms(library, 10, warmup=2)
    e = msg.numel()
    nbytes = e * (msg.element_size() + 1 + msg.element_size())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"E": e, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "combine_ms": combine_ms, "library_ms": library_ms,
            "bytes": nbytes, "bound_ms": bound_ms, "share": bound_ms / ms,
            "min_ms": min_ms, "copy_ms": copy_ms,
            "copy_bytes": 2 * e * msg.element_size()}


def superstep_parts(SG, g, rank, inv_outdeg, n) -> dict:
    """Device ms of each part of one PageRank superstep at these inputs."""
    from titan_tpu_torch.models.pagerank import PageRank
    prog = PageRank(0.85, 20, 0.0)
    state = {"rank": rank, "inv_outdeg": inv_outdeg}
    params = {"n": torch.tensor(n, dtype=torch.int32, device="cuda")}
    src_state = {k: v.index_select(0, g.src) for k, v in state.items()}
    msg = prog.message(src_state, {}, params)
    agg = SG.segment_combine(msg, g.dst, n, "sum", last_idx=g.last_idx,
                             seg_has=g.seg_has, flags=g.flags)
    return {
        "gather": cuda_ms(lambda: [v.index_select(0, g.src)
                                   for v in state.values()], 10),
        "message": cuda_ms(lambda: prog.message(src_state, {}, params), 10),
        "combine": cuda_ms(lambda: SG.segment_combine(
            msg, g.dst, n, "sum", last_idx=g.last_idx, seg_has=g.seg_has,
            flags=g.flags), 10),
        "apply": cuda_ms(lambda: prog.apply(state, agg, 0, params), 10)}


def engine_references(host_build) -> dict:
    """Host side of the engine phase, run while the s26 build still
    occupies the host: the s22 snapshot (from_chunked_csr) and the
    float64 PageRank and component labels that phase 5 checks against."""
    from titan_tpu_torch.olap import snapshot as SN

    hg, build_s = host_build.result()
    t0 = time.time()
    snap = SN.from_chunked_csr(hg)
    snap_s = time.time() - t0
    t0 = time.time()
    ref = {"hg": hg, "snap": snap, "pagerank": host_pagerank(snap, 0.85, 20),
           "labels": min_label_components(snap)}
    say(f"phase 5: s{ENGINE_SCALE} ef{EDGE_FACTOR} host build {build_s:.1f} "
        f"s, from_chunked_csr {snap_s:.1f} s: {snap.n} vertices, "
        f"{snap.num_edges} directed edges (symmetric, deduplicated); "
        f"float64 scipy PageRank and components {time.time() - t0:.1f} s")
    return ref


def phase_engine(S, P, G, ref, card) -> dict:
    """The engine's main path at s22: PageRank, BFS and WCC through
    GPUGraphComputer.run, then checks, the replay and the parts."""
    from titan_tpu_torch.device import INF
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.models import wcc as MW
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.ops import segment as SG

    hg, snap = ref["hg"], ref["snap"]
    comp = E.GPUGraphComputer(snapshot=snap)
    t0 = time.time()
    g = E.device_graph(snap, comp.device)
    torch.cuda.synchronize()
    say(f"phase 5: upload {time.time() - t0:.1f} s")
    n = snap.n
    src0 = sample_sources(hg["deg"], 1)[0]
    real, captured = E.segment_combine, {}

    def capture(msg, *args, **kw):        # keeps the last superstep's [E]
        captured["msg"] = msg
        return real(msg, *args, **kw)

    # ---- the main path, with the kernel counts from 0
    S.seg_scan.launches = 0
    E.segment_combine = capture
    try:
        _, warm_s = timed(lambda: MP.run(comp, 0.85, 20, 0.0, snap))
    finally:
        E.segment_combine = real
    pr, pr_s = timed(lambda: MP.run(comp, 0.85, 20, 0.0, snap))
    bfs, bfs_s = timed(lambda: MB.run(comp, src0, snapshot=snap))
    wcc, wcc_s = timed(lambda: MW.run(comp, snapshot=snap))
    launches = S.seg_scan.launches
    # ---- end of the main path
    check(launches > 0, "the engine never launched seg_scan")
    check(pr.iterations == 20, f"PageRank ran {pr.iterations} supersteps")
    say(f"phase 5: PageRank {pr.iterations} supersteps in {pr_s:.4f} s "
        f"({pr_s / pr.iterations * 1e3:.4f} ms a superstep, CUDA events "
        f"over GPUGraphComputer.run, upload excluded, init and the ranks' "
        f"readback included; the first run took {warm_s:.4f} s); BFS "
        f"from {src0}: {bfs.iterations} supersteps in {bfs_s:.4f} s; WCC "
        f"{wcc.iterations} supersteps in {wcc_s:.4f} s; seg_scan launches "
        f"{launches} over the 4 runs")

    rel = float(np.max(np.abs(pr["rank"] - ref["pagerank"])
                       / ref["pagerank"]))
    check(rel <= PAGERANK_RTOL, f"PageRank differs from float64 by {rel}")
    ref["engine_rank"] = pr["rank"]       # phase 10's dense jobs match it
    g500 = G.graph_from_numpy(hg, "cuda")
    dist, levels = P.frontier_bfs_hybrid(g500, src0)
    check(np.array_equal(bfs["dist"], dist), "the engine's BFS differs "
          "from frontier_bfs_hybrid")
    ref["bfs_source"], ref["bfs_dist"] = src0, dist    # phase 19's
    ref["pagerank_s"], ref["bfs_s"] = pr_s, bfs_s
    label = wcc["label"]
    check(np.array_equal(label, ref["labels"]), "a WCC label is not the "
          "smallest vertex id of its component")
    reached = bfs["dist"] < INF
    check(bool((label[reached] == label[src0]).all()), "the vertices BFS "
          "reached do not share one WCC label")
    say(f"phase 5: PageRank within {rel:.3g} of float64 scipy (tolerance "
        f"{PAGERANK_RTOL:g}, max relative error); BFS dist equals "
        f"frontier_bfs_hybrid ({levels} levels, {int(reached.sum())} "
        f"reached); WCC labels are the smallest id of each scipy "
        f"component ({len(np.unique(label))} components) and BFS's reached "
        f"set shares one")
    del g500

    deg = np.diff(snap.indptr_in)
    rec = seg_scan_replay(S, SG, g, captured.pop("msg"), n, deg)
    parts = superstep_parts(
        SG, g, torch.from_numpy(pr["rank"]).cuda(),
        torch.from_numpy(np.where(snap.out_degree > 0, 1.0 / np.maximum(
            snap.out_degree, 1), 0.0).astype(np.float32)).cuda(), n)
    say(f"phase 5: widest seg_scan call (a PageRank superstep's messages, "
        f"E={rec['E']}): max_abs_err {rec['max_abs_err']:.3g} (float32 "
        f"sum, within {FLOAT_SUM_RTOL:g} of the scan of |x|); kernel "
        f"{rec['ms']:.4f} ms (mean of 20), plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bytes']} bytes at 3.35 "
        f"TB/s: values and flags read once, out written once), "
        f"{100 * rec['share']:.1f}% of the bound, "
        f"{rec['bytes'] / rec['ms'] / 1e9:.3f} TB/s; the whole "
        f"combine {rec['combine_ms']:.4f} ms against torch.segment_reduce "
        f"{rec['library_ms']:.4f} ms")
    say(f"phase 5: at the same flags, seg_scan min int32 (BFS's and WCC's "
        f"combine, random labels): exact; {rec['min_ms']:.4f} ms (mean of "
        f"20), {100 * rec['bound_ms'] / rec['min_ms']:.1f}% of the bound; a "
        f"plain copy_ of the messages {rec['copy_ms']:.4f} ms, "
        f"{rec['copy_bytes'] / rec['copy_ms'] / 1e9:.3f} TB/s")
    say(f"phase 5: one PageRank superstep on {card}, device ms: "
        + json.dumps(parts))
    return {**SEG_KERNEL, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": rec["library_ms"]}, \
        pr_s / pr.iterations


#: the batched PageRank of phase 5b
PR_BATCH = 4
#: the checkpoint cadence of phase 5c's 20-superstep PageRank
CKPT_EVERY = 5


def row_scan_replay(S, values, flags, combine: str, deg=None) -> dict:
    """The widest K-row call of a batched run, ``values`` [K, ld]: every
    row bit-equal to the one-row launch, the plain version row by row
    (exact, float32 sums within FLOAT_SUM_RTOL), times, the two byte
    bounds (flags read once; flags read again for each row, since 50 MB
    of L2 cannot keep them), and, for float32 (``deg`` given),
    torch.segment_reduce over the K rows (axis 1) timed beside the scan.
    torch.segment_reduce takes no int32, so the int32 call has none."""
    k, e = values.shape[0], flags.shape[0]
    got = S.seg_scan(values, flags, combine)
    err = 0.0
    for r in range(k):
        row = values[r, :e].contiguous()
        check(torch.equal(got[r], S.seg_scan(row, flags, combine)),
              f"K-row seg_scan row {r} differs from the one-row launch")
        err = max(err, scan_error(S, got[r], S.seg_scan_reference(
            row, flags, combine), row, flags, combine))
        del row
    del got
    ms = cuda_ms(lambda: S.seg_scan(values, flags, combine), 10, warmup=2)
    plain_ms = cuda_ms(lambda: [S.seg_scan_reference(values[r, :e], flags,
                                                     combine)
                                for r in range(k)], 1)
    size = values.element_size()
    nbytes = 2 * size * k * e + e
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    reread_ms = (2 * size + 1) * k * e / HBM_BYTES_PER_S * 1e3
    rec = {"K": k, "E": e, "ld": values.shape[1],
           "dtype": str(values.dtype)[6:], "combine": combine,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bytes": nbytes, "bound_ms": bound_ms, "share": bound_ms / ms,
           "bound_ms_flags_per_row": reread_ms,
           "share_flags_per_row": reread_ms / ms, "library_ms": None}
    if deg is not None:
        data = values[:, :e].contiguous()
        lengths = torch.from_numpy(np.tile(deg.astype(np.int64),
                                           (k, 1))).cuda()

        def library():
            return torch.segment_reduce(data, combine, lengths=lengths,
                                        axis=1, unsafe=True)
        lib = library()
        check(lib.shape == (k, deg.shape[0]), "segment_reduce shape")
        rec["library_ms"] = cuda_ms(library, 5, warmup=1)
        del data, lengths, lib
    return rec


def say_rows(name: str, r: dict, card: str) -> None:
    say(f"phase 5b: widest K-row seg_scan of the {name} (K={r['K']}, "
        f"E={r['E']}, ld={r['ld']}, {r['dtype']} {r['combine']}) on {card}: "
        f"every row bit-equal to the one-row launch, max_abs_err against "
        f"the plain version {r['max_abs_err']:.3g}; kernel {r['ms']:.4f} "
        f"ms (mean of 10), plain {r['plain_ms']:.4f} ms; bound "
        f"{r['bound_ms']:.4f} ms ({r['bytes']} bytes at 3.35 TB/s, flags "
        f"once), {100 * r['share']:.1f}% of it; with the flags read again "
        f"for each row {r['bound_ms_flags_per_row']:.4f} ms, "
        f"{100 * r['share_flags_per_row']:.1f}%; torch.segment_reduce "
        f"(axis 1) " + ("takes no int32" if r["library_ms"] is None
                        else f"{r['library_ms']:.4f} ms"))


def phase_engine_batched(S, P, G, ref, card) -> dict:
    """Phase 5b on phase 5's s22 snapshot: GPUGraphComputer.run_batched
    for K = 16 BFS sources (bench.py's rule), each row's dist and
    iterations equal to GPUGraphComputer.run from that source and dist
    equal to frontier_bfs_hybrid; K = 4 PageRank jobs, each row bit-equal
    to the single run's ranks; the walls, the peak memory, the launches
    and the widest K-row scan of each replayed against its bounds."""
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E

    hg, snap = ref["hg"], ref["snap"]
    comp = E.GPUGraphComputer(snapshot=snap)
    n = snap.n
    srcs = sample_sources(hg["deg"], BATCH_K)
    real, captured = E.sorted_segment_combine, {}

    def capture(values, *args, **kw):     # the run's [K, ld] messages
        captured["values"] = values
        return real(values, *args, **kw)

    # ---- the main path: the batched BFS, counts from 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    S.seg_scan.launches = 0
    E.sorted_segment_combine = capture
    try:
        bres, bfs_s = wall_s(lambda: comp.run_batched(
            MB.BFS(), [{"source_dense": s} for s in srcs]))
    finally:
        E.sorted_segment_combine = real
    launches_bfs = S.seg_scan.launches
    # ---- end of the main path
    check(launches_bfs > 0, "the batched BFS never launched seg_scan")
    bfs_peak = torch.cuda.max_memory_allocated()
    singles, singles_s = wall_s(lambda: [MB.run(comp, s, snapshot=snap)
                                         for s in srcs])
    g500 = G.graph_from_numpy(hg, "cuda")
    for s, b, one in zip(srcs, bres, singles):
        check(b.iterations == one.iterations and np.array_equal(
            b["dist"], one["dist"]), f"batched BFS row of source {s} "
              "differs from GPUGraphComputer.run")
        dist, _ = P.frontier_bfs_hybrid(g500, s)
        check(np.array_equal(b["dist"], dist), f"batched BFS row of source "
              f"{s} differs from frontier_bfs_hybrid")
        ref.setdefault("bfs_rows", {})[s] = dist    # phase 10's references
    del g500
    say(f"phase 5b: s{ENGINE_SCALE} run_batched(BFS, K={BATCH_K}) on "
        f"{card}: {bfs_s:.4f} s wall (the {BATCH_K} single runs "
        f"{singles_s:.4f} s), supersteps {[b.iterations for b in bres]}, "
        f"every row's dist and iterations equal to GPUGraphComputer.run "
        f"and dist to frontier_bfs_hybrid; seg_scan launches "
        f"{launches_bfs}; peak memory {bfs_peak / 2**30:.3f} GiB")
    rows = [row_scan_replay(S, captured.pop("values"), E.device_graph(
        snap, comp.device).flags, "min")]
    say_rows("BFS batch", rows[0], card)
    del bres, singles
    torch.cuda.empty_cache()

    prog = MP.PageRank(0.85, 20, 0.0)
    inv = np.where(snap.out_degree > 0, 1.0 / np.maximum(
        snap.out_degree, 1), 0.0).astype(np.float32)
    params = {"n": n, "inv_outdeg": inv}
    # ---- the main path: the batched PageRank, counts from 0
    torch.cuda.reset_peak_memory_stats()
    S.seg_scan.launches = 0
    E.sorted_segment_combine = capture
    try:
        pres, pr_s = wall_s(lambda: comp.run_batched(prog,
                                                     [params] * PR_BATCH))
    finally:
        E.sorted_segment_combine = real
    launches_pr = S.seg_scan.launches
    # ---- end of the main path
    check(launches_pr > 0, "the batched PageRank never launched seg_scan")
    pr_peak = torch.cuda.max_memory_allocated()
    one, one_s = wall_s(lambda: comp.run(prog, params))
    for j, r in enumerate(pres):
        check(r.iterations == one.iterations == 20 and np.array_equal(
            r["rank"], one["rank"]), f"batched PageRank row {j} is not "
              "bit-equal to the single run")
    say(f"phase 5b: s{ENGINE_SCALE} run_batched(PageRank, K={PR_BATCH}, 20 "
        f"supersteps) on {card}: {pr_s:.4f} s wall (one single run "
        f"{one_s:.4f} s), every row bit-equal to the single run; seg_scan "
        f"launches {launches_pr}; peak memory {pr_peak / 2**30:.3f} GiB")
    rows.append(row_scan_replay(S, captured.pop("values"), E.device_graph(
        snap, comp.device).flags, "sum", deg=np.diff(snap.indptr_in)))
    say_rows("PageRank batch", rows[1], card)
    del pres
    torch.cuda.empty_cache()
    return {"launches": launches_bfs + launches_pr, "rows": rows,
            "bfs_s": bfs_s, "pagerank_s": pr_s, "bfs_peak": bfs_peak,
            "pagerank_peak": pr_peak}


def phase_checkpoint(S, ref, card) -> int:
    """Phase 5c on phase 5's s22 snapshot: PageRank, 20 supersteps,
    checkpointed every CKPT_EVERY into a directory of the checkout
    (``.bench_cache/``, ignored): bit-equal to the run without
    checkpoints; the round-15 and round-20 checkpoints removed, the
    resumed run bit-equal; the newest remaining one corrupted, ``latest``
    falls back to round 5 and the resumed run is bit-equal again. Then a
    classic MapReduce, a histogram of the in-degrees an InDegree program
    computes through seg_scan, against numpy. Returns the seg_scan
    launches of the checkpointed, resumed and MapReduce runs."""
    import os
    import shutil

    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.olap.api import DenseProgram, MapReduce
    from titan_tpu_torch.olap.recovery import CheckpointStore, FaultPlan

    class InDegree(DenseProgram):
        combine = "sum"
        max_iterations = 1

        def init(self, n, params):
            return {"deg": torch.zeros((n,), dtype=torch.int32)}

        def message(self, src_state, edge_data, params):
            return torch.ones_like(src_state["deg"])

        def apply(self, state, agg, iteration, params):
            return {"deg": agg}

    class DegreeHistogram(MapReduce):
        memory_key = "degrees"

        def map(self, vertex, emitter):
            emitter.emit(vertex.value("deg"), 1)

        def combine(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def reduce(self, key, values, emitter):
            emitter.emit(key, sum(values))

        def finalize(self, results):
            return {k: v[0] for k, v in results.items()}

    snap = ref["snap"]
    comp = E.GPUGraphComputer(snapshot=snap)
    prog = MP.PageRank(0.85, 20, 0.0)
    params = {"n": snap.n, "inv_outdeg": np.where(
        snap.out_degree > 0, 1.0 / np.maximum(snap.out_degree, 1),
        0.0).astype(np.float32)}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    plain = comp.run(prog, params)
    # ---- the checkpoint path, counts from 0
    S.seg_scan.launches = 0
    full, full_s = wall_s(lambda: comp.run(prog, params, checkpoint_to=root,
                                           checkpoint_every=CKPT_EVERY))
    store = CheckpointStore(root)
    paths = store.checkpoints("run")
    names = [os.path.basename(p) for p in paths]
    check(names == [f"ckpt-a0001-r{r:08d}" for r in (5, 10, 15, 20)],
          f"checkpoints {names}")
    check(full.iterations == 20 and np.array_equal(full["rank"],
                                                   plain["rank"]),
          "the checkpointed PageRank differs from the uncheckpointed run")
    for p in paths[2:]:
        shutil.rmtree(p)
    res1, res1_s = wall_s(lambda: comp.run(prog, params, resume_from=root))
    check(res1.iterations == 20 and np.array_equal(res1["rank"],
                                                   full["rank"]),
          "PageRank resumed from round 10 differs")
    FaultPlan.corrupt(paths[1])
    check(store.latest("run").round == 5, "latest() did not fall back to "
          "round 5 past the corrupted round 10")
    res2 = comp.run(prog, params, resume_from=root)
    check(res2.iterations == 20 and np.array_equal(res2["rank"],
                                                   full["rank"]),
          "PageRank resumed from round 5 differs")
    mr, mr_s = wall_s(lambda: comp.run(InDegree(), {},
                                       map_reduces=[DegreeHistogram()]))
    launches = S.seg_scan.launches
    # ---- end of the checkpoint path
    check(launches > 0, "the checkpoint path never launched seg_scan")
    shutil.rmtree(root, ignore_errors=True)
    deg = np.diff(snap.indptr_in)
    check(np.array_equal(mr["deg"], deg), "InDegree differs from indptr")
    values, counts = np.unique(deg, return_counts=True)
    check(mr.memory["degrees"] == dict(zip(values.tolist(),
                                           counts.tolist())),
          "the classic MapReduce degree histogram differs from numpy")
    say(f"phase 5c: s{ENGINE_SCALE} PageRank checkpointed every "
        f"{CKPT_EVERY} on {card}: {full_s:.4f} s (rounds 5, 10, 15, 20), "
        f"bit-equal to the run without checkpoints; rounds 15 and 20 "
        f"removed, resumed from 10 in {res1_s:.4f} s, bit-equal; round 10 "
        f"corrupted, latest() fell back to 5, resumed bit-equal; classic "
        f"MapReduce (in-degree histogram, {len(values)} degrees over "
        f"{snap.n} vertex views) equal to numpy in {mr_s:.1f} s; seg_scan "
        f"launches {launches}")
    return launches


def validate(g, dist, source: int, inf: int) -> None:
    """Graph500's BFS validation rules, on the card, over every stored
    (symmetric) edge: dist[source] == 0; every edge joins two reached or
    two unreached vertices, with |dist[u] - dist[v]| <= 1; every reached
    vertex other than the source has a neighbour one level closer."""
    n, dstT, degc = g["n"], g["dstT"], g["degc"]
    check(int(dist[source]) == 0, "dist[source] != 0")
    q = g["q_total"] - 1
    owner = torch.repeat_interleave(
        torch.arange(n, device=dist.device, dtype=torch.int32),
        degc[:n].long(), output_size=q)
    has_parent = torch.zeros(n + 1, dtype=torch.bool, device=dist.device)
    bad = torch.zeros((), dtype=torch.int64, device=dist.device)
    step = 1 << 25
    for c0 in range(0, q, step):
        c1 = min(c0 + step, q)                 # the sink column owns nothing
        u = owner[c0:c1].long()
        du = dist[u]
        for lane in range(8):
            v = dstT[lane, c0:c1]
            real = v < n
            dv = dist[v.clamp(max=n - 1).long()]
            ru, rv = du < inf, dv < inf
            bad += (real & ((ru != rv) | (ru & ((du - dv).abs() > 1)))).sum()
            up = real & ru & (dv == du - 1)
            has_parent[torch.where(up, u, n)] = True
    orphan = (dist < inf) & ~has_parent[:n]
    orphan[source] = False
    check(int(bad) == 0, f"{int(bad)} edges break the level rules")
    check(int(orphan.sum()) == 0,
          f"{int(orphan.sum())} reached vertices have no parent")


def sector_bytes(offsets, itemsize: int) -> int:
    """Bytes in the distinct 32-byte sectors that hold the elements at
    int64 ``offsets`` of an array of ``itemsize``-byte elements."""
    return 32 * torch.unique((offsets * itemsize) >> 5).numel()


def word_byte(par, Kp: int, plane: int):
    """The byte offset of the parents' words in a plane of ``plane``
    bytes, clamped as the kernels clamp them (int64)."""
    par = par.long()
    if Kp >= 8:
        return par.clamp(0, plane * 8 // Kp - 1) * (Kp // 8)
    return ((par * Kp) >> 3).clamp(0, plane - 1)


def word_value(plane, wbyte, par, Kp: int):
    """The int64 words of the parents ``par`` at their byte offsets
    ``wbyte`` (``word_byte``) in one plane (uint8)."""
    if Kp >= 8:
        return sum(plane[wbyte + i].long() << (8 * i) for i in range(Kp // 8))
    return (plane[wbyte].long() >> ((par.long() * Kp) & 7)) & ((1 << Kp) - 1)


def round_bytes(a, lanes: int) -> dict:
    """The bytes one round must move for these inputs, each input read
    once and each output written once. A read that depends on the data
    counts the 32-byte sectors this call's data needs: ``cols`` and the
    dstT lanes of candidates some job still wants; the frontier sectors
    of the parents tested; ``has_more`` for the candidates that missed in
    every lane; ``pay0``/``pay1`` for the survivors. ``undec`` is read
    whole, and ``found`` and the two compacted lists are written whole.
    The dstT sectors are counted under two layouts of the same lanes:
    ``[8, Q]``, the port's, where the leading ``lanes`` rows are read for
    the wanted candidates and the other rows for those some job missed
    in them (``dstT_8q``), and ``[Q, 8]``, where one column's 8 lanes
    share one sector (``dstT_q8``: 32 B a distinct wanted column). The
    frontier sectors are counted under two layouts of the same bits:
    job-major ``[K, nb]`` bitmaps, one sector a (parent, job) tested
    (``fbits_rows``), and the vertex-major words, one sector a (parent,
    group of 32 jobs) tested (``fbits_words``). ``bytes`` takes the
    smaller of each pair: the least the card could move for this work;
    ``bytes_8q``/``bytes_q8`` fix the dstT layout and ``bytes_rows``/
    ``bytes_words`` the frontier's. Also returns the wanted candidates
    (``live``) and the survivor count this model finds, which must equal
    the kernel's ``nsur``."""
    dstT, tb, undec, fb = a["dstT"], a["tbits"], a["undec"], a["fbits"]
    K, C = undec.shape
    Kp, G = word_bits(K)
    # the bits as given: words, or a parent checkout's job-major rows
    job_major = K > 1 and fb.shape[0] == K
    if job_major:
        nb, plane = fb.shape[1], fb.shape[1] * Kp
    else:
        plane = fb.shape[1]
        nb = -(-(plane * 8 // Kp) // 8)
    Q = dstT.shape[1]
    dev = dstT.device
    col = a["cols"].long().clamp(0, Q - 1)
    j = torch.arange(C, device=dev)
    live = undec.any(0)
    open_ = None
    if tb is not None:
        lane = torch.arange(8, device=dev)[:, None]
        w = tb[col.clamp(max=tb.numel() - 1)].int()   # slot col*8+l: byte col
        open_ = ((w[None] >> lane) & 1) == 0
    # the 32-byte sectors that the tests touch, marked job by job (rows)
    # and group by group (words): no [K, lanes, C] temporary (34 GB at
    # K = 16, C = 2^26)
    touched = torch.zeros(((K * nb - 1) >> 5) + 1, dtype=torch.bool,
                          device=dev)
    wtouched = torch.zeros(((G * plane - 1) >> 5) + 1, dtype=torch.bool,
                           device=dev)

    def test(l0, l1, want):
        """Hits of lanes [l0, l1) for the [K, C] candidates in ``want``,
        each parent clamped by the rule of the layout given."""
        par = dstT[l0:l1][:, col]
        byte = (par >> 3).long().clamp(0, nb - 1)
        shift = (par & 7).to(torch.uint8)
        wbyte = word_byte(par, Kp, plane)
        words = []
        for g in range(G):
            tested = want[32 * g:32 * g + 32].any(0)[None, :].expand_as(par)
            if open_ is not None:
                tested = tested & open_[l0:l1]
            wtouched[(g * plane + wbyte[tested]) >> 5] = True
            if not job_major:
                words.append(word_value(fb[g], wbyte, par, Kp))
        del wbyte
        hit = torch.empty((K, C), dtype=torch.bool, device=dev)
        for k in range(K):
            tested = want[k][None, :].expand_as(par)
            if open_ is not None:
                tested = tested & open_[l0:l1]
            touched[(k * nb + byte[tested]) >> 5] = True
            bit = ((fb[k][byte] >> shift) & 1 if job_major
                   else (words[k >> 5] >> (k & 31)) & 1) > 0
            torch.any(tested & bit, dim=0, out=hit[k])
        return hit

    hit = test(0, lanes, undec)
    missed = undec & ~hit
    del hit
    wide = missed.any(0) if lanes < 8 else torch.zeros_like(live)
    if lanes < 8:
        missed = missed & ~test(lanes, 8, missed)
    out_miss = missed.any(0)
    del missed
    surv = out_miss & a["has_more"]
    dstT_8q = sum(sector_bytes(l * Q + col[live if l < lanes else wide], 4)
                  for l in range(8))
    dstT_q8 = sector_bytes(col[live], 32)
    fbits_rows = 32 * int(touched.sum())
    fbits_words = 32 * int(wtouched.sum())
    rest = (sector_bytes(j[live], 4) + K * C
            + (0 if tb is None else sector_bytes(col[live], 1))
            + sector_bytes(j[out_miss], 1) + 2 * sector_bytes(j[surv], 4)
            + K * C + 8 * C + 4)
    d_min, f_min = min(dstT_8q, dstT_q8), min(fbits_rows, fbits_words)
    return {"bytes": rest + d_min + f_min,
            "bytes_8q": rest + dstT_8q + f_min,
            "bytes_q8": rest + dstT_q8 + f_min,
            "bytes_rows": rest + d_min + fbits_rows,
            "bytes_words": rest + d_min + fbits_words,
            "dstT_8q": dstT_8q, "dstT_q8": dstT_q8,
            "fbits_rows": fbits_rows, "fbits_words": fbits_words,
            "live": int(live.sum()), "nsur": int(surv.sum())}


EXHAUST_ARGS = ("cols", "owner", "p_total", "fbits", "tbits", "dstT")


def exhaust_call(fn, e):
    """``fn`` (the sweep's wrapper, plain version or kernel launch) on the
    inputs ``e``."""
    return fn(*(e[k] for k in EXHAUST_ARGS), K=e["K"], c_cap=e["c_cap"])


def exhaust_bytes(e) -> dict:
    """The bytes one sweep must move for these inputs, each input read
    once and each output written once, in the 32-byte sectors this call's
    data needs: ``cols`` and ``owner`` of the live pairs (j < p_total, a
    contiguous run); the dstT sectors of their open slots, under
    ``[8, Q]`` (the port's) and under ``[Q, 8]`` (32 B a distinct column
    with an open slot), the smaller counting; the ``tbits`` sector of
    each live column; the word sectors of their open parents, plane by
    plane; ``p_total``; the ``[G, c_cap]`` words written once. Marked in
    slices of 2^24 pairs on bool arrays, not listed."""
    K, c_cap = e["K"], e["c_cap"]
    Kp, G = word_bits(K)
    dstT, fb, tb = e["dstT"], e["fbits"], e["tbits"]
    Q, plane, dev = dstT.shape[1], fb.shape[1], dstT.device
    live = min(max(int(e["p_total"]), 0), e["cols"].numel())
    d8q = torch.zeros(((8 * Q * 4 - 1) >> 5) + 1, dtype=torch.bool,
                      device=dev)
    dq8 = torch.zeros(Q, dtype=torch.bool, device=dev)
    tsec = torch.zeros((((tb.numel() if tb is not None else 1) - 1) >> 5)
                       + 1, dtype=torch.bool, device=dev)
    wsec = torch.zeros(((G * plane - 1) >> 5) + 1, dtype=torch.bool,
                       device=dev)
    lane = torch.arange(8, device=dev)[:, None]
    step = 1 << 24
    for s0 in range(0, live, step):
        col = e["cols"][s0:min(s0 + step, live)].long().clamp(0, Q - 1)
        if tb is None:
            open_ = torch.ones((8, col.numel()), dtype=torch.bool,
                               device=dev)
        else:
            tcol = col.clamp(max=tb.numel() - 1)
            tsec[tcol >> 5] = True
            open_ = ((tb[tcol][None].int() >> lane) & 1) == 0
        d8q[((lane * Q + col[None]) * 4 >> 5)[open_]] = True
        dq8[col[open_.any(0)]] = True
        wb = word_byte(dstT[:, col], Kp, plane)[open_]
        for g in range(G):
            wsec[(g * plane + wb) >> 5] = True
        del open_, wb
    pairs = 2 * 32 * (-(-live * 4 // 32))
    dstT_8q, dstT_q8 = 32 * int(d8q.sum()), 32 * int(dq8.sum())
    words = 32 * int(wsec.sum())
    rest = (pairs + (32 * int(tsec.sum()) if tb is not None else 0) + 4
            + words + G * c_cap * 4)
    return {"bytes": rest + min(dstT_8q, dstT_q8), "dstT_8q": dstT_8q,
            "dstT_q8": dstT_q8, "words": words, "live": live}


def exhaust_replay(F, e) -> dict:
    """One sweep replayed: the kernel's words and the wrapper's found_per
    against the plain version (bit-equal), the kernel's time (its launch
    and the zeroed words: ``ms``), the wrapper's (with the expansion to
    [K, c_cap] bool: ``wrapper_ms``) and the plain version's, each the
    mean of several after a warm-up, and the bound (``exhaust_bytes``)."""
    got = exhaust_call(F.batched_exhaust, e)
    ref = exhaust_call(F.batched_exhaust_reference, e)
    check(torch.equal(got, ref), "batched_exhaust differs from its plain "
          f"version (K={e['K']}, P={e['cols'].numel()})")
    ms = cuda_ms(lambda: exhaust_call(F._launch_exhaust, e), 10, warmup=2)
    wrapper_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust, e), 10)
    plain_ms = cuda_ms(lambda: exhaust_call(F.batched_exhaust_reference, e),
                       2)
    work = exhaust_bytes(e)
    out = {"K": e["K"], "P": e["cols"].numel(), "c_cap": e["c_cap"],
           "found": int(got.sum()), "max_abs_err": 0, "ms": ms,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "bound_ms": work["bytes"] / HBM_BYTES_PER_S * 1e3, **work}
    if hasattr(F, "_launch_summary"):    # a checkout with the summary
        out["summary"] = summary_replay(F, e["fbits"], e["K"])
    return out


def summary_replay(F, fbits, K: int) -> dict:
    """The summary kernel on one sweep's words: bit-equal to its plain
    version, its time and the plain version's (means after a warm-up),
    its set bits, and its bound: the planes read once, the summary
    written once."""
    got = F._launch_summary(fbits, K)
    ref = F.exhaust_summary_reference(fbits, K)
    check(torch.equal(got, ref), f"exhaust_summary differs from its plain "
          f"version (K={K})")
    sh, nsw = F.summary_shape(fbits.shape[1], K)
    nbytes = fbits.numel() + 4 * nsw
    bits = int(((got.long()[:, None] >> torch.arange(32, device=got.device))
                & 1).sum())
    return {"ms": cuda_ms(lambda: F._launch_summary(fbits, K), 10,
                          warmup=2),
            "plain_ms": cuda_ms(lambda: F.exhaust_summary_reference(
                fbits, K), 3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "bytes_a_bit": 1 << sh, "bits": -(-fbits.shape[1] >> sh),
            "bits_set": bits, "max_abs_err": 0}


ROUND_ARGS = ("cols", "undec", "has_more", "pay0", "pay1", "fbits", "tbits",
              "dstT")


def trace_calls(P, g, src: int):
    """One BFS from ``src`` with CUDA events around every
    ``frontier_round`` call. Returns ``(calls, levels, seconds)``: each
    call a dict of its inputs ``a``, ``kw``, ``C`` and device
    ``ms``; the inputs are kept for replays."""
    real = P.frontier_round
    calls = []

    def traced(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        calls.append({"a": dict(zip(ROUND_ARGS, args)), "kw": kw,
                      "C": args[0].shape[0], "events": (e0, e1)})
        return out

    P.frontier_round = traced
    try:
        torch.cuda.synchronize()
        t = time.time()
        _, levels = P.frontier_bfs_hybrid(g, src, return_device=True)
        torch.cuda.synchronize()
        seconds = time.time() - t
    finally:
        P.frontier_round = real
    for c in calls:
        e0, e1 = c.pop("events")
        c["ms"] = e0.elapsed_time(e1)
    return calls, levels, seconds


def replay(F, c) -> dict:
    """Replays one main-path call: bit-equality with the plain version,
    the kernel's time (mean of 10 after 2 warm-ups) and the plain
    version's, and the bytes and bound under both dstT layouts."""
    a, kw = c["a"], c["kw"]
    args = [a[k] for k in ROUND_ARGS]
    got = F.frontier_round(*args, **kw)
    ref = F.frontier_round_reference(*args, **kw)
    err = max_abs_err(got, ref)
    check(err == 0, "frontier_round differs from its plain version at a "
          "main-path call")
    ms = cuda_ms(lambda: F.frontier_round(*args, **kw), 10, warmup=2)
    plain_ms = cuda_ms(lambda: F.frontier_round_reference(*args, **kw), 3)
    work = round_bytes(a, kw["lanes"])
    check(work["nsur"] == int(got[3]), "the byte model's survivor count "
          "differs from the kernel's")

    def bound(b):
        return b / HBM_BYTES_PER_S * 1e3
    return {"source": c["source"], "call": c["index"], "C": c["C"],
            "K": a["undec"].shape[0], "nsur": int(got[3]),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound(work["bytes"]),
            "bound_ms_8q": bound(work["bytes_8q"]),
            "bound_ms_q8": bound(work["bytes_q8"]),
            "bound_ms_rows": bound(work["bytes_rows"]),
            "bound_ms_words": bound(work["bytes_words"]), **work}


def trace_sources(P, g, srcs):
    """One traced BFS per source (``trace_calls``); returns the widest
    call (the first of the largest C), the call whose bound bytes
    (``round_bytes``) are largest, each tagged with its source and
    index, and the number of calls per source. Only those two calls'
    inputs are kept."""
    widest = heaviest = None
    per_source = []
    for src in srcs:
        calls, levels, seconds = trace_calls(P, g, src)
        for i, c in enumerate(calls):
            c.update(source=src, index=i,
                     **round_bytes(c["a"], c["kw"]["lanes"]))
            if widest is None or c["C"] > widest["C"]:
                widest = c
            if heaviest is None or c["bytes"] > heaviest["bytes"]:
                heaviest = c
        per_source.append(len(calls))
        say(f"traced BFS from {src}: {levels} levels in {seconds:.4f} s, "
            f"frontier_round {len(calls)} calls, "
            f"{sum(c['ms'] for c in calls):.4f} ms summed (CUDA events "
            f"around each call); each call's C, wanted candidates, ms, "
            f"dstT sector bytes under [8, Q] and [Q, 8], bound bytes: "
            + "; ".join(f"{c['C']} {c['live']} {c['ms']:.4f} {c['dstT_8q']} "
                        f"{c['dstT_q8']} {c['bytes']}" for c in calls))
        del calls
    return widest, heaviest, per_source


def say_replay(name: str, r: dict) -> None:
    say(f"{name} frontier_round call (source {r['source']}, call "
        f"{r['call']}) C={r['C']} K={r['K']} nsur={r['nsur']}: bit-equal to "
        f"the plain version (max_abs_err {r['max_abs_err']}, tolerance 0); "
        f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; bytes "
        f"under [8, Q] {r['bytes_8q']} (dstT {r['dstT_8q']}), under [Q, 8] "
        f"{r['bytes_q8']} (dstT {r['dstT_q8']}); frontier sectors "
        f"{r['fbits_rows']} B job-major, {r['fbits_words']} B as words; "
        f"bound {r['bound_ms']:.4f} ms (the smaller counts at 3.35 TB/s; "
        f"dstT [8, Q] {r['bound_ms_8q']:.4f}, [Q, 8] {r['bound_ms_q8']:.4f}; "
        f"frontier job-major {r['bound_ms_rows']:.4f}, words "
        f"{r['bound_ms_words']:.4f} ms), {100 * r['bound_ms'] / r['ms']:.1f}% "
        f"of it; the survivor count of the byte model equals nsur")


#: the jobs the widest cohort call is cut to: the frontier bits of 4 jobs
#: fit the 50 MB L2 at s26 in either layout, those of 16 do not
SWEEP_K = (4, 8, 16)


def k_sweep(F, widest, card) -> list[dict]:
    """The widest cohort call replayed with its first k jobs, k in
    ``SWEEP_K`` (``first_jobs``): time, time a job, bound, and the
    frontier sectors under both layouts."""
    out = []
    for k in SWEEP_K:
        r = replay(F, {**widest, "a": first_jobs(widest["a"], k)})
        out.append({"K": k, "ms": r["ms"], "ms_per_job": r["ms"] / k,
                    **{x: r[x] for x in (
                        "plain_ms", "bound_ms", "bound_ms_rows",
                        "bound_ms_words", "fbits_rows", "fbits_words",
                        "nsur")}})
        say(f"K sweep on {card}: the widest cohort call (C={r['C']}) cut "
            f"to its first {k} jobs: kernel {r['ms']:.4f} ms, "
            f"{r['ms'] / k:.4f} ms a job; bit-equal to the plain version "
            f"({r['plain_ms']:.4f} ms); frontier sectors {r['fbits_rows']} B "
            f"job-major, {r['fbits_words']} B as words; bound "
            f"{r['bound_ms']:.4f} ms (job-major {r['bound_ms_rows']:.4f}, "
            f"words {r['bound_ms_words']:.4f})")
        torch.cuda.empty_cache()
    return out


def phase_main(F, P, G, host_build, card) -> tuple:
    from titan_tpu_torch.device import INF

    hg, build_s = host_build.result()
    t0 = time.time()
    g = G.graph_from_numpy(hg, "cuda")
    torch.cuda.synchronize()
    upload_s = time.time() - t0
    say(f"phase 6: s{SCALE} host build {build_s:.1f} s (native, "
        f"{hg['n']} vertices, {hg['e_sym']} symmetrized input edges, "
        f"q_total {hg['q_total']}), upload {upload_s:.1f} s, dstT "
        f"{g['dstT'].numel() * 4 / 1e9:.2f} GB")
    srcs = sample_sources(hg["deg"], NUM_SOURCES)
    deg_orig = np.asarray(hg["deg_orig"])
    deg_dev = G.device_degrees(deg_orig, "cuda")

    # ---- the main path, with the kernel counts from 0
    F.frontier_round.launches = 0
    runs = 0

    def bfs(src):
        nonlocal runs
        torch.cuda.synchronize()
        t = time.time()
        dist, levels = P.frontier_bfs_hybrid(g, src, return_device=True)
        torch.cuda.synchronize()
        runs += 1
        return dist, levels, time.time() - t

    bfs(srcs[0])                                   # warm-up
    warm = F.frontier_round.launches
    # one traced run a source: CUDA events around every frontier_round
    # call, and the widest and the heaviest call kept for the replays
    widest, heaviest, per_call = trace_sources(P, g, srcs)
    runs += len(srcs)

    per_source = []
    for src in srcs:
        best = None
        for _ in range(REPS):
            dist, levels, t = bfs(src)
            if best is None or t < best[2]:
                best = (dist, levels, t)
        dist, levels, t_bfs = best
        m2, nreach = G.reachable_edge_sum(dist, deg_orig, INF,
                                          deg_dev=deg_dev)
        per_source.append({"source": src, "dist": dist, "levels": levels,
                           "t_bfs": t_bfs, "reach": nreach,
                           "m_traversed": m2 // 2,
                           "teps": (m2 // 2) / t_bfs})
    launches = F.frontier_round.launches
    # ---- end of the main path
    check(launches > 0, "the main path never launched frontier_round")
    check(launches == warm + (1 + REPS) * sum(per_call),
          "a source's BFS runs launched frontier_round unequal times")

    for r in per_source:
        validate(g, r["dist"], r["source"], INF)
    teps = len(per_source) / sum(1.0 / r["teps"] for r in per_source)
    say(f"phase 6: Graph500 s{SCALE} ef{EDGE_FACTOR} on {card}: "
        f"TEPS {teps:.6g} (harmonic mean over {len(per_source)} "
        f"sources, best of {REPS}); per source "
        + json.dumps([{k: v for k, v in r.items() if k != "dist"}
                      for r in per_source]))
    say(f"phase 6: Graph500 validation passed for every source; "
        f"frontier_round launches {launches} over {runs} BFS runs "
        f"({per_call} a run, by source)")
    recs = {"widest": replay(F, widest)}
    recs["heaviest"] = (recs["widest"] if heaviest is widest
                        else replay(F, heaviest))
    for name, r in recs.items():
        say_replay(name, r)
    w = recs["widest"]
    return g, hg, per_source, teps, {**KERNEL, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": w["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "replays": [{"replay": name, **{k: r[k] for k in (
                "source", "call", "C", "nsur", "ms", "plain_ms", "bound_ms",
                "bound_ms_8q", "bound_ms_q8", "bytes_8q", "bytes_q8",
                "dstT_8q", "dstT_q8")}} for name, r in recs.items()]}


#: the batched BFS cohort and the interactive lane's hops batch: the
#: serving batcher's and the interactive scheduler's max_batch
BATCH_K = 16
#: the interactive shape V(x).out().out()
HOPS_DEPTH = 2
#: the share of edge slots the seeded tbits of the K = 16 replay mask
TOMB_SHARE = 0.01
#: exhaust pairs a slice of the plain sweep at s16, so the CPU folds many
#: slices there (the kernel does not slice); at s26 the module's own
SMALL_EXHAUST_SLICE = 1 << 12


class BatchedTrace:
    """CUDA events around the batched BFS's level steps (plan, rounds,
    exhaust, overlay scatter), every frontier_round call and every
    batched_exhaust call of one run. Keeps the inputs of the widest round
    (the first of the largest C) and of the largest sweep (the first of
    the most listed pairs) for the replays, the largest exhaust p_cap and
    each level's split. (A checkout from before the sweep kernel has no
    ``batched_exhaust`` to trace; the rest is traced the same.)"""

    #: each step, the position of its ``level`` argument and its column
    STEPS = {"_batched_plan": (2, "plan"), "_batched_rounds": (5, "rounds"),
             "_batched_exhaust": (5, "exhaust"),
             "_overlay_scatter_batched": (4, "overlay")}

    def __init__(self, P):
        self.P, self.events, self.calls, self.sweeps = P, [], [], []
        self.widest, self.largest, self.p_cap = None, None, 0

    def __enter__(self):
        P = self.P
        self.real = {k: getattr(P, k) for k in (
            *self.STEPS, "frontier_round", "batched_exhaust")
            if hasattr(P, k)}

        def wrap(name, fn, at, col):
            def traced(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.events.append((col, int(a[at]), e0, e1))
                if col == "exhaust":
                    self.p_cap = max(self.p_cap, int(a[8]))
                return out
            return traced

        def round_(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.real["frontier_round"](*a, **kw)
            e1.record()
            C = a[0].shape[0]
            self.calls.append((C, a[1].shape[0], e0, e1))
            if self.widest is None or C > self.widest["C"]:
                self.widest = {"a": dict(zip(ROUND_ARGS, a)), "kw": kw,
                               "C": C, "index": len(self.calls) - 1}
            return out
        def sweep(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.real["batched_exhaust"](*a, **kw)
            e1.record()
            n = a[0].shape[0]
            self.sweeps.append((n, e0, e1))
            if self.largest is None or n > self.largest["P"]:
                self.largest = {**dict(zip(EXHAUST_ARGS, a)), **kw, "P": n,
                                "index": len(self.sweeps) - 1}
            return out
        for k, (at, col) in self.STEPS.items():
            setattr(P, k, wrap(k, self.real[k], at, col))
        P.frontier_round = round_
        if "batched_exhaust" in self.real:
            P.batched_exhaust = sweep
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.P, k, fn)
        torch.cuda.synchronize()
        return False

    def split(self) -> list[dict]:
        """Per level: device ms of plan, rounds, exhaust, overlay."""
        rows = {}
        for col, level, e0, e1 in self.events:
            r = rows.setdefault(level, {"level": level, "plan": 0.0,
                                        "rounds": 0.0, "exhaust": 0.0,
                                        "overlay": 0.0})
            r[col] += e0.elapsed_time(e1)
        return [rows[k] for k in sorted(rows)]

    def kernel_ms(self) -> float:
        return sum(e0.elapsed_time(e1) for _, _, e0, e1 in self.calls)

    def sweep_ms(self) -> list[float]:
        """Device ms of each batched_exhaust call, in order."""
        return [e0.elapsed_time(e1) for _, e0, e1 in self.sweeps]


def expand_once(g, mask):
    """The top-down neighbour set of the vertices in ``mask`` (bool [n]),
    in plain torch from dstT: each vertex's columns, all 8 lanes, pads
    dropped; in slices of 2^24 columns."""
    n, dstT = g["n"], g["dstT"]
    v = torch.nonzero(mask).flatten()
    cnt = g["degc"][v].long()
    first = g["colstart"][v].long()
    ends = torch.cumsum(cnt, 0)
    total = int(ends[-1]) if v.numel() else 0
    out = torch.zeros(n + 2, dtype=torch.bool, device=dstT.device)
    step = 1 << 24
    for c0 in range(0, total, step):
        j = torch.arange(c0, min(c0 + step, total), device=dstT.device)
        owner = torch.searchsorted(ends, j, right=True)
        cols = first[owner] + (j - (ends[owner] - cnt[owner]))
        out[dstT[:, cols].flatten().long()] = True
    return out[:n]


def hop_encoding(g, x: int, depth: int, start_level: int):
    """What a hops run of ``depth`` sweeps from ``x`` leaves in its dist
    row: the last hop h a vertex is in, stamped h + start_level, 0 where
    none; from ``expand_once`` alone."""
    cur = torch.zeros(g["n"], dtype=torch.bool, device=g["dstT"].device)
    cur[x] = True
    enc = torch.where(cur, start_level, 0).to(torch.int32)
    sizes = []
    for h in range(1, depth + 1):
        cur = expand_once(g, cur)
        enc[cur] = h + start_level
        sizes.append(int(cur.sum()))
    return enc, sizes


def phase_batched(F, P, G, g, hg, card) -> tuple[list, dict, list, dict]:
    """Phase 7 at s26 on phase 6's graph: the K = 16 BFS cohort against
    16 single-source runs, the interactive hops batch against a top-down
    expansion, the widest K = 16 frontier_round call replayed with and
    without tbits and cut to 4, 8 and 16 jobs, and the largest cohort
    sweep replayed. Returns frontier_round's replays, its launches by
    path and the K sweep, and batched_exhaust's record."""
    from titan_tpu_torch.device import INF

    n = g["n"]
    srcs = sample_sources(hg["deg"], BATCH_K)
    deg_orig = np.asarray(hg["deg_orig"])
    deg_dev = G.device_degrees(deg_orig, "cuda")

    # the references: single-source BFS from each source, best of REPS
    singles = []
    for src in srcs:
        best = None
        for _ in range(REPS):
            (dist, levels), t = wall_s(lambda: P.frontier_bfs_hybrid(
                g, src, return_device=True))
            if best is None or t < best[2]:
                best = (dist, levels, t)
        singles.append(best)
    t_singles = sum(b[2] for b in singles)
    edges = [G.reachable_edge_sum(b[0], deg_orig, INF, deg_dev=deg_dev)[0]
             // 2 for b in singles]

    # ---- the main path (the serving batcher's BFS cohort), counts from 0
    F.frontier_round.launches = 0
    F.batched_exhaust.launches = F._launch_summary.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()

    def cohort():
        return P.frontier_bfs_batched(g, srcs, return_device=True)
    cohort()                                             # warm-up
    runs = []
    for _ in range(REPS):
        runs.append(wall_s(cohort))
    (dist, levels, completed), t_batch = min(runs, key=lambda r: r[1])
    with BatchedTrace(P) as tr:
        _, t_traced = wall_s(cohort)
    launches = F.frontier_round.launches
    x_launches = F.batched_exhaust.launches
    s_launches = F._launch_summary.launches
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    per_run = len(tr.calls)
    check(per_run > 0 and launches == (2 + REPS) * per_run,
          f"the cohort launched frontier_round {launches} times over "
          f"{2 + REPS} runs of {per_run} calls")
    check(tr.sweeps and x_launches == (2 + REPS) * len(tr.sweeps),
          f"the cohort launched batched_exhaust {x_launches} times over "
          f"{2 + REPS} runs of {len(tr.sweeps)} calls")
    check(all(k == BATCH_K for _, k, _, _ in tr.calls),
          "a cohort round ran with another K")
    check(bool(completed.all()), "a cohort job did not complete")
    for k, (d1, lv1, _) in enumerate(singles):
        check(torch.equal(dist[k], d1), f"cohort row {k} (source "
              f"{srcs[k]}) differs from frontier_bfs_hybrid")
        check(int(levels[k]) == lv1, f"cohort row {k}: {levels[k]} "
              f"levels, frontier_bfs_hybrid {lv1}")
    del runs, singles
    m_batch = sum(edges)
    say(f"phase 7: K={BATCH_K} cohort at s{SCALE} on {card}: all 16 rows "
        f"bit-equal to frontier_bfs_hybrid from the same sources, levels "
        f"equal, every job completed; batched wall {t_batch:.4f} s (best "
        f"of {REPS} after a warm-up; traced run {t_traced:.4f} s) against "
        f"{t_singles:.4f} s summed over the 16 single-source best-of-"
        f"{REPS} times; {m_batch} traversed input edges summed over the "
        f"jobs (Graph500's count), {m_batch / t_batch:.6g} edges/s over "
        f"the batched wall ({sum(edges) / t_singles:.6g} over the summed "
        f"single-source times); frontier_round {launches} launches over "
        f"{2 + REPS} runs ({per_run} a run, K={BATCH_K}), "
        f"{tr.kernel_ms():.4f} ms summed in the traced run; "
        f"batched_exhaust {x_launches} launches ({len(tr.sweeps)} a run), "
        f"{', '.join(f'{x:.4f}' for x in tr.sweep_ms())} ms each in the "
        f"traced run; largest exhaust p_cap {tr.p_cap}; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - base_mem) / 2**30:.3f} GiB "
        f"above the graph and the 16 reference rows)")
    say(f"phase 7: cohort per-level split on {card} (device ms by CUDA "
        f"events, traced run): " + json.dumps(
            [{k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in r.items()} for r in tr.split()]))
    widest = {**tr.widest, "source": "cohort"}
    largest = tr.largest
    del tr, dist

    # ---- the interactive lane's hops batch, counts from 0
    depths = [HOPS_DEPTH] * BATCH_K

    def on_level(level, nf):
        keep = np.asarray([level <= d for d in depths])
        return keep if not keep.all() else None

    def hops():
        return P.frontier_bfs_batched(
            g, srcs, max_levels=HOPS_DEPTH + 1, start_level=1,
            on_level=on_level, mode="hops", return_device=True)
    F.frontier_round.launches = 0
    F.batched_exhaust.launches = F._launch_summary.launches = 0
    hops()
    h_runs = [wall_s(hops) for _ in range(REPS)]
    h_launches = F.frontier_round.launches
    h_x_launches = F.batched_exhaust.launches
    h_s_launches = F._launch_summary.launches
    # ---- end of the hops path
    (hd, _, _), t_hops = min(h_runs, key=lambda r: r[1])
    check(h_launches > 0, "the hops batch never launched frontier_round")
    sizes = []
    for k, x in enumerate(srcs):
        enc, sz = hop_encoding(g, x, HOPS_DEPTH, 1)
        check(torch.equal(hd[k], enc), f"hops row {k} (start {x}) differs "
              f"from the top-down expansion")
        sizes.append(sz)
    del h_runs, hd
    say(f"phase 7: hops batch K={BATCH_K}, depth {HOPS_DEPTH}, start_level "
        f"1 at s{SCALE} on {card}: every row equals a top-down expansion "
        f"from dstT in plain torch (dist == 3 is hop 2, dist == 2 hop 1 "
        f"minus hop 2, dist == 1 the start if in neither); hop-1 and hop-2 "
        f"sizes {sizes}; {t_hops:.4f} s (best of {REPS}), frontier_round "
        f"{h_launches} launches, batched_exhaust {h_x_launches}, over "
        f"{1 + REPS} runs")

    # ---- the widest K = 16 call, replayed as run and with seeded tbits
    recs = {"cohort_k16": replay(F, widest)}
    q = g["dstT"].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(13)
    tb = torch.zeros(q, dtype=torch.uint8, device="cuda")
    for b in range(8):
        tb |= ((torch.rand(q, generator=gen, device="cuda") < TOMB_SHARE)
               .to(torch.uint8) << b)
    masked = {**widest, "a": {**widest["a"], "tbits": tb}}
    recs["cohort_k16_tbits"] = replay(F, masked)
    for name, r in recs.items():
        say_replay(f"{name} (K={BATCH_K}) on {card}:", r)
    del masked, tb
    sweep = k_sweep(F, widest, card)
    del widest
    torch.cuda.empty_cache()

    # ---- the largest cohort sweep, replayed
    x = exhaust_replay(F, largest)
    say(f"largest cohort batched_exhaust call (call {largest['index']}, "
        f"K={x['K']}, P={x['P']}, {x['live']} live pairs, c_cap="
        f"{x['c_cap']}, {x['found']} candidate bits found) on {card}: "
        f"bit-equal to the plain version (tolerance 0); kernel "
        f"{x['ms']:.4f} ms (the launch and its zeroed words; with the "
        f"wrapper's expansion to [K, c_cap] bool {x['wrapper_ms']:.4f} ms), "
        f"plain {x['plain_ms']:.4f} ms; bytes {x['bytes']} (dstT "
        f"[8, Q] {x['dstT_8q']}, [Q, 8] {x['dstT_q8']}; words "
        f"{x['words']}); bound {x['bound_ms']:.4f} ms at 3.35 TB/s, "
        f"{100 * x['bound_ms'] / x['ms']:.1f}% of it")
    sm = x["summary"]
    check(s_launches == x_launches and h_s_launches == h_x_launches,
          f"exhaust_summary launched {s_launches} and {h_s_launches} times "
          f"beside {x_launches} and {h_x_launches} sweeps")
    say(f"its frontier summary (exhaust_summary, {sm['bits']} bits of "
        f"{sm['bytes_a_bit']} B, {sm['bits_set']} set) on {card}: "
        f"bit-equal to the plain version; kernel {sm['ms']:.4f} ms (inside "
        f"the sweep's {x['ms']:.4f}), plain {sm['plain_ms']:.4f} ms, bound "
        f"{sm['bound_ms']:.4f} ms ({sm['bytes']} B), "
        f"{100 * sm['bound_ms'] / sm['ms']:.1f}% of it")
    del largest
    torch.cuda.empty_cache()
    x_rec = {**EXHAUST_KERNEL, "launches": x_launches + h_x_launches,
             "max_abs_err": 0, "ms": x["ms"], "plain_ms": x["plain_ms"],
             "bound_ms": x["bound_ms"], "bound_by": "bytes",
             "library_ms": None,
             "launches_by_path": {"bfs_batched": x_launches,
                                  "hops": h_x_launches},
             "replay": {k: x[k] for k in (
                 "K", "P", "live", "c_cap", "found", "ms", "wrapper_ms",
                 "plain_ms", "bound_ms", "bytes", "dstT_8q", "dstT_q8",
                 "words")},
             "summary": {**SUMMARY_KERNEL,
                         "launches": s_launches + h_s_launches,
                         "max_abs_err": 0, "ms": sm["ms"],
                         "plain_ms": sm["plain_ms"],
                         "bound_ms": sm["bound_ms"], "bound_by": "bytes",
                         "library_ms": None,
                         "launches_by_path": {"bfs_batched": s_launches,
                                              "hops": h_s_launches},
                         "replay": sm}}
    return ([{"replay": name, "K": BATCH_K, **{k: r[k] for k in (
        "source", "call", "C", "nsur", "ms", "plain_ms", "bound_ms",
        "bound_ms_8q", "bound_ms_q8", "bound_ms_rows", "bound_ms_words",
        "bytes_8q", "bytes_q8", "bytes_rows", "bytes_words", "dstT_8q",
        "dstT_q8", "fbits_rows", "fbits_words")}}
             for name, r in recs.items()],
            {"bfs_batched": launches, "hops": h_launches}, sweep, x_rec)


def phase_batched_small(F, P, G, SN, OV, card) -> None:
    """Phase 7 at s16: the batched BFS on the card equals the port on the
    CPU under a live overlay with adds and removals, with level masks, in
    a checkpoint and a resume from it, and with a job dropped through
    on_level; every card run launches frontier_round, the overlay and
    mask runs with tbits."""
    hg = G.load_or_build(SMALL_SCALE, EDGE_FACTOR, seed=SEED, verbose=False)
    snap = SN.from_chunked_csr(hg)
    rng = np.random.default_rng(21)
    srcs = sample_sources(hg["deg"], BATCH_K)
    n = snap.n
    add_s = rng.integers(0, n, 300).astype(np.int32)
    add_d = rng.integers(0, n, 300).astype(np.int32)
    rm = rng.choice(snap.num_edges, 150, replace=False)
    graphs = {dev: P.build_chunked_csr(snap, dev) for dev in ("cuda", "cpu")}
    lm = rng.integers(0, 256, graphs["cpu"]["q_total"]).astype(np.uint8)
    lm[-1] = 0                                   # the all-pad sink column

    def views(dev):
        ov = OV.DeltaOverlay(snap, min_cap=1024, device=dev)
        ov.append_edges(np.concatenate([add_s, add_d]),
                        np.concatenate([add_d, add_s]),
                        np.zeros(600, np.int32))
        for i in rm:
            u, v = int(snap.src[i]), int(snap.dst[i])
            ov.remove_edge(u, v, None)
            ov.remove_edge(v, u, None)
        return ov.view()

    real_slice = F.EXHAUST_SLICE
    F.EXHAUST_SLICE = SMALL_EXHAUST_SLICE
    try:
        out, masked_calls = {}, {}
        for dev, g in graphs.items():
            lmt = torch.from_numpy(lm).to(dev)
            caps = {}

            def keep(level, dist, active):
                caps[level] = dist

            def drop(level, nf):
                return np.arange(BATCH_K) >= 4 if level >= 2 else None
            calls, sweeps = [], []
            real, real_x = P.frontier_round, P.batched_exhaust

            def spy(*a, **kw):
                calls.append(a[6] is not None)
                return real(*a, **kw)

            def spy_x(*a, **kw):
                sweeps.append(a[4] is not None)
                return real_x(*a, **kw)
            P.frontier_round, P.batched_exhaust = spy, spy_x
            try:
                runs = {
                    "overlay": P.frontier_bfs_batched(
                        g, srcs, overlay=views(dev), device=dev),
                    "level_masks": P.frontier_bfs_batched(
                        g, srcs, mode="hops", start_level=1, max_levels=4,
                        level_masks=[None, lmt, lmt], device=dev),
                    "full": P.frontier_bfs_batched(g, srcs, device=dev,
                                                   checkpoint=keep)}
                runs["resume"] = P.frontier_bfs_batched(
                    g, srcs, init_dist=caps[2][:, :n], start_level=2,
                    device=dev)
                runs["drop"] = P.frontier_bfs_batched(g, srcs,
                                                      on_level=drop,
                                                      device=dev)
            finally:
                P.frontier_round, P.batched_exhaust = real, real_x
            out[dev] = runs
            masked_calls[dev] = (len(calls), sum(calls), len(sweeps),
                                 sum(sweeps))
    finally:
        F.EXHAUST_SLICE = real_slice
    for name in out["cpu"]:
        a, b = out["cuda"][name], out["cpu"][name]
        check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              and np.array_equal(a[2], b[2]),
              f"s{SMALL_SCALE} batched {name}: the card differs from the CPU")
    check(np.array_equal(out["cuda"]["resume"][0], out["cuda"]["full"][0]),
          "the resumed run differs from the uninterrupted one")
    total, masked, x_total, x_masked = masked_calls["cuda"]
    check(total > 0 and masked > 0, "the s16 card runs did not launch "
          "frontier_round with tbits")
    check(x_total > 0 and x_masked > 0, "the s16 card runs did not launch "
          "batched_exhaust with tbits")
    say(f"phase 7: s{SMALL_SCALE} batched BFS (K={BATCH_K}; the CPU's plain "
        f"sweep in slices of {SMALL_EXHAUST_SLICE} pairs) on the card "
        f"equals the CPU port "
        f"under a live overlay (600 rows added, {2 * len(rm)} removed), "
        f"with level masks [None, mask, mask] in hops mode, uninterrupted "
        f"and resumed from its level-2 checkpoint (equal to each other), "
        f"and with 4 jobs dropped at level 2; frontier_round {total} calls "
        f"on the card, {masked} of them with tbits; batched_exhaust "
        f"{x_total} calls, {x_masked} of them with tbits")


def edge_windows(FR, g):
    """(c0, c1, owners int64) over the real columns of ``g`` in windows of
    2^24 columns (the sink column owns nothing)."""
    owner = FR._colowner(g)
    q, step = g["q_total"] - 1, 1 << 24
    for c0 in range(0, q, step):
        c1 = min(c0 + step, q)
        yield c0, c1, owner[c0:c1].long()


def check_sssp(FR, g, dist, source: int) -> int:
    """SSSP checked by its edges, on ``dist``'s device, in column
    windows: dist[source] == 0; every stored edge (u, v) of weight w (the
    hash of its slot) with u reached has dist[v] <= fl(dist[u] + w) (no
    edge can still lower a distance) and joins two reached or two
    unreached vertices; every reached vertex but the source has a tight
    in-edge (dist[v] == fl(dist[u] + w)); the unreached hold FINF.
    Returns the number of reached vertices."""
    n, dstT = g["n"], g["dstT"]
    finf = float(FR.FINF)
    check(float(dist[source]) == 0.0, "dist[source] != 0")
    tight = torch.zeros(n + 1, dtype=torch.bool, device=dist.device)
    bad = torch.zeros((), dtype=torch.int64, device=dist.device)
    for c0, c1, u in edge_windows(FR, g):
        du = dist[u]
        ru = du < finf
        cols = torch.arange(c0, c1, dtype=torch.int64, device=dist.device)
        for lane in range(8):
            v = dstT[lane, c0:c1]
            real = v < n
            vl = v.clamp(max=n - 1).long()
            dv = dist[vl]
            m = du + FR._hash_weight_expr(cols * 8 + lane, 0.0, 1.0)
            bad += (real & ((ru != (dv < finf)) | (ru & (dv > m)))).sum()
            tight[torch.where(real & ru & (dv == m), vl, n)] = True
    reached = dist < finf
    orphan = reached & ~tight[:n]
    orphan[source] = False
    check(int(bad) == 0, f"{int(bad)} edges could still lower a distance "
          f"or join a reached and an unreached vertex")
    check(int(orphan.sum()) == 0,
          f"{int(orphan.sum())} reached vertices have no tight in-edge")
    check(bool((dist[~reached] == finf).all()), "an unreached vertex does "
          "not hold FINF")
    return int(reached.sum())


def check_wcc(FR, g, label) -> int:
    """WCC checked on ``label``'s device: both ends of every stored edge
    share a label (so each component carries one), no label exceeds its
    vertex, and each label labels itself. Two components sharing one
    label would pass: phase 8 compares with scipy's components, phase 9
    the giant's set with a BFS. Returns the number of labels (vertices
    that are their own label)."""
    n, dstT = g["n"], g["dstT"]
    bad = torch.zeros((), dtype=torch.int64, device=label.device)
    for _c0, _c1, u in edge_windows(FR, g):
        lu = label[u]
        for lane in range(8):
            v = dstT[lane, _c0:_c1]
            real = v < n
            bad += (real & (label[v.clamp(max=n - 1).long()] != lu)).sum()
    ids = torch.arange(n, dtype=torch.int32, device=label.device)
    check(int(bad) == 0, f"{int(bad)} edges join two labels")
    check(bool((label <= ids).all()), "a label exceeds its vertex")
    check(bool((label[label.long()] == label).all()), "a label is not its "
          "own label")
    return int((label == ids).sum())


def phase_frontier_s22(F, P, G, FR, PR, ref, card, superstep_s) -> int:
    """Phase 8 at s22 on a chunked-CSR dict from phase 5's host build:
    dense PageRank as bench.py times it, the personalized batch, SSSP,
    WCC and the SSSP cohort. Returns the WCC peel's frontier_round
    launches."""
    hg = ref["hg"]
    g = G.graph_from_numpy(hg, "cuda")
    n = g["n"]

    # ---- pagerank_dense as bench.py's pagerank_stage runs it
    FR.pagerank_dense(g, iterations=2, return_device=True)       # warm
    _, t10 = wall_s(lambda: FR.pagerank_dense(g, iterations=10,
                                              return_device=True))
    sec_it = t10 / 10
    (pr, it), t20 = wall_s(lambda: FR.pagerank_dense(g, iterations=20,
                                                     return_device=True))
    rel = float(np.max(np.abs(pr.cpu().numpy() - ref["pagerank"])
                       / ref["pagerank"]))
    check(it == 20, f"pagerank_dense ran {it} iterations")
    check(rel <= PAGERANK_RTOL, f"pagerank_dense differs from float64 by "
          f"{rel}")
    say(f"phase 8: s{ENGINE_SCALE} pagerank_dense on {card}: "
        f"{sec_it:.6f} s an iteration (bench.py's pagerank_lj_sec_per_iter "
        f"rule: the host wall of 10 iterations after a 2-iteration warm-up, "
        f"over 10; bench.py reports this one); 20 iterations in "
        f"{t20:.4f} s, within {rel:.3g} of float64 scipy (tolerance "
        f"{PAGERANK_RTOL:g}); beside it the engine's PageRank, "
        f"{superstep_s:.6f} s a superstep (phase 5, GPUGraphComputer.run "
        f"over 20)")
    del pr

    # ---- the personalized batch of the interactive lane
    users = sample_sources(hg["deg"], PPR_USERS)
    (ranks, _), t_ppr = wall_s(lambda: PR.pagerank_personalized_batched(
        g, users, iterations=20, return_device=True))
    worst, t_rows = 0.0, 0.0
    for s, v in enumerate(users):
        one = torch.zeros(n, dtype=torch.float32, device="cuda")
        one[v] = 1.0
        (row, _), t = wall_s(lambda: FR.pagerank_dense(
            g, iterations=20, reset=one, return_device=True))
        t_rows += t
        live = row > 0
        check(torch.equal(live, ranks[s] > 0), f"user {s}: the batched "
              f"row is zero elsewhere than pagerank_dense(reset=one-hot)")
        err = float(((ranks[s][live] - row[live]).abs() / row[live]).max())
        check(err <= PPR_RTOL, f"user {s} (vertex {v}): the batched row "
              f"differs from pagerank_dense(reset=one-hot) by {err}")
        worst = max(worst, err)
    top = PR.top_k_per_user(ranks, np.arange(n), k=10, exclude=users)
    for s, rows in enumerate(top):
        vals = [r for _, r in rows]
        check(len(rows) == 10 and vals == sorted(vals, reverse=True)
              and users[s] not in [v for v, _ in rows],
              f"user {s}: top-k rows are not 10 sorted others")
    say(f"phase 8: personalized PageRank, {PPR_USERS} users (bench.py's "
        f"source rule), 20 iterations: {t_ppr:.4f} s batched against "
        f"{t_rows:.4f} s for the {PPR_USERS} pagerank_dense(reset=one-hot) "
        f"runs; every row within {worst:.3g} of its run (tolerance "
        f"{PPR_RTOL:g}, relative, zeros equal); top_k_per_user: 10 sorted "
        f"rows a user, the user's own vertex excluded")
    del ranks

    # ---- SSSP and WCC from bench.py's source
    src = int(np.flatnonzero(np.asarray(hg["deg"]) > 0)[0])
    (dist, rounds), t_sssp = wall_s(lambda: FR.frontier_sssp(
        g, src, return_device=True))
    nreach = check_sssp(FR, g, dist, src)
    F.frontier_round.launches = 0
    (label, wrounds), t_wcc = wall_s(lambda: FR.frontier_wcc(
        g, return_device=True))
    peel = F.frontier_round.launches
    ncomp = check_wcc(FR, g, label)
    check(np.array_equal(label.cpu().numpy(), ref["labels"]), "WCC differs "
          "from scipy's components")
    check(torch.equal(dist < float(FR.FINF), label == label[src]),
          "SSSP's reached set is not the source's component")
    say(f"phase 8: frontier_sssp from {src} (bench.py's source): {rounds} "
        f"rounds in {t_sssp:.4f} s, {nreach} reached, every edge checked "
        f"(none can lower a distance, every reached vertex has a tight "
        f"in-edge); frontier_wcc: {wrounds} rounds (BFS peel levels "
        f"included) in {t_wcc:.4f} s, equal to scipy's components "
        f"({ncomp}), frontier_round {peel} launches in the peel")
    del dist, label

    # ---- the SSSP cohort against its solo runs
    srcs = sample_sources(hg["deg"], SSSP_COHORT)
    (outs, crounds, stopped), t_co = wall_s(lambda: FR.frontier_sssp_batched(
        g, srcs, return_device=True))
    t_solo = 0.0
    for k, s in enumerate(srcs):
        (d1, r1), t = wall_s(lambda: FR.frontier_sssp(g, s,
                                                      return_device=True))
        t_solo += t
        check(torch.equal(outs[k].view(torch.int32), d1.view(torch.int32))
              and crounds[k] == r1, f"cohort member {k} (source {s}) "
              f"differs from its solo run")
    check(stopped == [None] * SSSP_COHORT, "a cohort member stopped")
    say(f"phase 8: K={SSSP_COHORT} frontier_sssp_batched: every row and "
        f"round count ({crounds}) bit-equal to its solo run; {t_co:.4f} s "
        f"against {t_solo:.4f} s for the solo runs")
    del outs, g
    torch.cuda.empty_cache()
    return peel


#: the mixed stream: an SSSP cohort, a WCC cohort, PageRank and the
#: engine's PageRank, under two tenants
SERVE_SSSP, SERVE_WCC, SERVE_PR, SERVE_DENSE = 4, 4, 2, 2
#: profiling on/off: each served K = 16 batch this many times, in turns
PROFILE_REPS = 2
#: one chunked-CSR upload on top of torch.cuda.memory_allocated: each of
#: the four tensors is rounded up by the caching allocator, a small one
#: to 512 B, a large one to its 2 MiB segment (the rest of a segment under
#: 1 MiB stays with the block), so the increase exceeds the prediction by
#: less than 4 * 2 MiB
ALLOC_SLACK = 4 * (2 << 20)


class ServedLaunches:
    """The kernels' launches inside served runs only: each served segment
    zeroes the counts just before the scheduler runs and reads them just
    after its last job; direct comparison calls stay out."""

    def __init__(self, F, S):
        self.F, self.S = F, S
        self.total = {"frontier_round": 0, "batched_exhaust": 0,
                      "exhaust_summary": 0, "seg_scan": 0}

    def run(self, fn):
        F, S = self.F, self.S
        torch.cuda.synchronize()
        F.frontier_round.launches = 0
        F.batched_exhaust.launches = F._launch_summary.launches = 0
        S.seg_scan.launches = 0
        out = fn()
        self.total["frontier_round"] += F.frontier_round.launches
        self.total["batched_exhaust"] += F.batched_exhaust.launches
        self.total["exhaust_summary"] += F._launch_summary.launches
        self.total["seg_scan"] += S.seg_scan.launches
        return out


def serve(sched, specs, wait_s: float = 300.0):
    """Submit ``specs`` under the scheduler's lock, so that its worker
    takes them as one group, start it if it is paused, and wait for every
    job; returns ``(jobs, wall)``, the wall from the first submit to the
    last job's end."""
    t0 = time.time()
    with sched._cv:                      # re-entrant: submit takes it too
        jobs = [sched.submit(s) for s in specs]
    sched.start()
    for j in jobs:
        check(j.wait(wait_s), f"{j} did not finish in {wait_s} s")
    # the worker finalizes counters just after the last state change
    deadline = time.time() + 30
    while time.time() < deadline and sched.stats()["running_batch"]:
        time.sleep(0.001)
    return jobs, max(j.finished_at for j in jobs) - t0


def split(sched, job) -> dict:
    """Where a served job's time went, from its trace: queue (submit to
    start), the model call (its ``run`` span, the batch's device run
    and readback) and the rest of its execution (the batcher's result
    dicts and the scheduler's bookkeeping), in ms."""
    t = sched.trace_summary(job.id) or {}
    exec_ms = job.exec_seconds() * 1e3
    run_ms = t.get("device_ms", 0.0)
    return {"queue_ms": t.get("queue_ms"), "run_ms": run_ms,
            "rest_ms": round(exec_ms - run_ms, 3),
            "exec_ms": round(exec_ms, 3)}


def phase_serving_s22(F, P, FR, S, ref, card) -> dict:
    """The serving phase at s22, on phase 5's snapshot: the port's
    JobScheduler on the card drives a fused K = 16 BFS batch, a mixed
    stream under two tenants, two recovered jobs and the admission
    paths, under a phase-wide device profiler. Returns the kernels'
    served launches."""
    import shutil

    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.obs import devprof
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.recovery import FaultPlan
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.olap.serving.hbm import snapshot_csr_bytes
    from titan_tpu_torch.utils.metrics import MetricManager

    snap, hg = ref["snap"], ref["hg"]
    n = snap.n
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "serving_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    launches = ServedLaunches(F, S)
    phase_m = MetricManager()
    prof = devprof.DeviceCostProfiler(metrics=phase_m).install()
    scheds = []

    def scheduler(**kw):
        s = JobScheduler(snapshot=snap, checkpoint_dir=root,
                         autostart=False, max_batch=BATCH_K,
                         metrics=MetricManager(), **kw)
        scheds.append(s)
        return s

    try:
        # ---- the chunked CSR: built once, measured, then cached
        if hasattr(snap, "_hybrid_csr_by_device"):
            del snap._hybrid_csr_by_device
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        a0 = torch.cuda.memory_allocated()
        g = P.build_chunked_csr(snap)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - a0
        predicted = snapshot_csr_bytes(snap)
        check(0 <= grew - predicted < ALLOC_SLACK, f"the chunked CSR took "
              f"{grew} bytes, the ledger predicts {predicted}")
        check(P.build_chunked_csr(snap) is g, "a second build_chunked_csr "
              "call did not return the cached graph")
        say(f"phase 10: s{ENGINE_SCALE} chunked CSR built once: "
            f"torch.cuda.memory_allocated grew {grew} bytes, "
            f"snapshot_csr_bytes predicts {predicted} (+{grew - predicted}, "
            f"allocator rounding, limit {ALLOC_SLACK}); the second call "
            f"returned the cached tensors")

        # ---- 1. the fused K = 16 BFS batch
        srcs = sample_sources(hg["deg"], BATCH_K)
        bfs_specs = [JobSpec(kind="bfs", params={"source_dense": s})
                     for s in srcs]
        sched = scheduler()
        jobs, served_s = launches.run(lambda: serve(sched, bfs_specs))
        occ = sched._metrics.histogram("serving.batch.occupancy")
        check((occ.count, occ.max) == (1, float(BATCH_K)), f"occupancy "
              f"{occ.to_dict()}: not one batch of {BATCH_K}")
        for s, j in zip(srcs, jobs):
            check(j.state.value == "done" and j.batch_k == BATCH_K,
                  f"BFS job from {s}: {j.state.value}, batch_k {j.batch_k}"
                  f", {j.error}")
            check(np.array_equal(j.result["dist"], ref["bfs_rows"][s]),
                  f"served BFS from {s} differs from frontier_bfs_hybrid")
        resident = sched.ledger.resident_bytes()
        check(resident == predicted, f"ledger resident {resident}, "
              f"snapshot_csr_bytes {predicted}")
        # one K = 1 job on the running scheduler
        one = sched.submit(JobSpec(kind="bfs",
                                   params={"source_dense": srcs[0]}))
        check(one.wait(300) and one.state.value == "done", "K = 1 BFS job")
        lat1 = one.finished_at - one.submitted_at
        parts16, parts1 = split(sched, jobs[0]), split(sched, one)
        sched.close()
        # the batcher's host result work a BFS job: the reached count
        rows = [j.result["dist"] for j in jobs]
        _, reached_s = wall_s(lambda: [int((r < (1 << 30)).sum())
                                       for r in rows])
        (_, _, _), direct_s = wall_s(lambda: P.frontier_bfs_batched(snap,
                                                                    srcs))
        say(f"phase 10: served K={BATCH_K} BFS batch on {card}: "
            f"{served_s:.4f} s from the first submit to the last result, "
            f"one batch of {BATCH_K} (occupancy), every row equal to "
            f"frontier_bfs_hybrid (phase 5b's rows); frontier_bfs_batched "
            f"called directly on the same snapshot {direct_s:.4f} s, so the "
            f"serving layer adds {served_s - direct_s:.4f} s; one K=1 BFS "
            f"job on the running scheduler: {lat1:.4f} s submit to result; "
            f"ledger resident {resident} bytes = snapshot_csr_bytes; "
            f"first job of the batch {parts16}, the K=1 job {parts1}; the "
            f"batcher's host reached counts of the {BATCH_K} rows "
            f"{reached_s:.4f} s")

        # ---- 2. the mixed stream under two tenants
        nz = np.flatnonzero(np.asarray(hg["deg"]) > 0)
        sssp_src = [int(x) for x in nz[:SERVE_SSSP]]
        outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
        inv = np.where(snap.out_degree > 0, 1.0 / outdeg,
                       0.0).astype(np.float32)      # models/pagerank.run's
        specs = ([JobSpec(kind="sssp", tenant="alpha",
                          params={"source_dense": s}) for s in sssp_src]
                 + [JobSpec(kind="wcc", tenant="beta")] * SERVE_WCC
                 + [JobSpec(kind="pagerank", tenant="alpha",
                            params={"iterations": 20})] * SERVE_PR
                 + [JobSpec(kind="dense", tenant="beta", params={
                     "program": MP.PageRank(0.85, 20, 0.0), "n": n,
                     "inv_outdeg": inv})] * SERVE_DENSE)
        sched = scheduler()
        walls = []
        attribute = sched._attribute

        def record(group, wall, nbytes):     # every batch's own wall
            walls.append(wall)
            attribute(group, wall, nbytes)
        sched._attribute = record
        jobs, mixed_s = launches.run(lambda: serve(sched, specs))
        ts = sched.tenant_stats()["tenants"]
        m = sched._metrics
        parts = {f"{j.spec.kind}#{i}": split(sched, j)
                 for i, j in enumerate(jobs)
                 if i in (0, SERVE_SSSP, SERVE_SSSP + SERVE_WCC,
                          len(jobs) - 1)}
        sched.close()
        check(all(j.state.value == "done" for j in jobs),
              "mixed stream: " + ", ".join(f"{j.spec.kind} {j.state.value}"
                                           f" {j.error}" for j in jobs))
        ks = [j.batch_k for j in jobs]
        check(ks == [SERVE_SSSP] * SERVE_SSSP + [SERVE_WCC] * SERVE_WCC
              + [1] * (SERVE_PR + SERVE_DENSE), f"batch compositions {ks}")
        dev_s = sum(r["device_seconds"] for r in ts.values())
        check(abs(dev_s - sum(walls)) <= 1e-9 * max(sum(walls), 1.0),
              f"tenant device-seconds {dev_s} != batch walls {sum(walls)}")
        labeled = sum(c.count for _, c in m.children(
            "serving.jobs.completed"))
        check(labeled == m.counter_value("serving.jobs.completed")
              == len(jobs), "labeled completions do not sum to the total")
        for s, j in zip(sssp_src, jobs[:SERVE_SSSP]):
            d, r = FR.frontier_sssp(snap, s)
            check(np.array_equal(j.result["dist"].view(np.int32),
                                 d.view(np.int32))
                  and j.result["rounds"] == r,
                  f"served SSSP from {s} differs from frontier_sssp")
        (_, _, _), sssp_direct = wall_s(lambda: FR.frontier_sssp_batched(
            snap, sssp_src))
        (_, _, _), wcc_direct = wall_s(lambda: FR.frontier_wcc_batched(
            snap, SERVE_WCC))
        (lab, wr), wcc1 = wall_s(lambda: FR.frontier_wcc(snap))
        _, unique_s = wall_s(lambda: len(np.unique(lab)))
        for j in jobs[SERVE_SSSP:SERVE_SSSP + SERVE_WCC]:
            check(np.array_equal(j.result["labels"], lab)
                  and j.result["rounds"] == wr
                  and np.array_equal(lab, ref["labels"]),
                  "served WCC differs from frontier_wcc or scipy")
        rank, _ = FR.pagerank_dense(snap, iterations=20)
        pr_jobs = jobs[SERVE_SSSP + SERVE_WCC:][:SERVE_PR]
        pr_err = max(float(np.max(np.abs(j.result["rank"] - rank) / rank))
                     for j in pr_jobs)
        pr_bits = all(np.array_equal(j.result["rank"], rank)
                      for j in pr_jobs)
        check(pr_err <= FLOAT_SUM_RTOL, f"served pagerank differs from "
              f"pagerank_dense by {pr_err}")
        for j in jobs[-SERVE_DENSE:]:
            check(j.result["iterations"] == 20 and np.array_equal(
                j.result["rank"], ref["engine_rank"]), "served dense "
                "PageRank is not bit-equal to GPUGraphComputer.run")
        say(f"phase 10: mixed stream on {card}: {SERVE_SSSP} SSSP (one "
            f"cohort), {SERVE_WCC} WCC (one cohort), {SERVE_PR} pagerank, "
            f"{SERVE_DENSE} dense PageRank (20 supersteps) under tenants "
            f"alpha and beta in {mixed_s:.4f} s; batches {len(walls)}, "
            f"walls {[round(w, 4) for w in walls]} s; SSSP and WCC equal "
            f"to the direct calls (WCC to scipy too); pagerank within "
            f"{pr_err:.3g} of pagerank_dense (bit-equal: {pr_bits}; "
            f"index_add_ adds in no fixed order on the card); dense "
            f"bit-equal to phase 5's GPUGraphComputer.run; tenant "
            f"device-seconds {dev_s:.6f} = the batch walls' sum, labeled "
            f"completions sum to the total ({labeled}); direct calls: the "
            f"SSSP cohort {sssp_direct:.4f} s, the WCC cohort "
            f"{wcc_direct:.4f} s, one frontier_wcc {wcc1:.4f} s, the "
            f"batcher's host np.unique of one label array {unique_s:.4f} "
            f"s; per-job split {parts}")

        # ---- 3. recovery: a crashed BFS and a crashed dense PageRank
        rec_specs = [
            JobSpec(kind="bfs", params={"source_dense": srcs[1],
                                        "faults": FaultPlan(
                                            crash_at_round=2)},
                    checkpoint_every=1, max_retries=1,
                    retry_backoff_s=0.01),
            JobSpec(kind="dense", params={
                "program": MP.PageRank(0.85, 20, 0.0), "n": n,
                "inv_outdeg": inv,
                "faults": FaultPlan(crash_at_round=10)},
                checkpoint_every=5, max_retries=1, retry_backoff_s=0.01)]
        sched = scheduler()
        jobs, rec_s = launches.run(lambda: serve(sched, rec_specs))
        rm = sched._metrics
        sched.close()
        b, d = jobs
        check(all(j.state.value == "done" and j.attempt == 2 for j in jobs),
              "recovered jobs: " + ", ".join(
                  f"{j.state.value} attempt {j.attempt} {j.error}"
                  for j in jobs))
        check(rm.counter_value("serving.recovery.resumes") == 2,
              "recovery: not one resume a job")
        check(np.array_equal(b.result["dist"], ref["bfs_rows"][srcs[1]]),
              "recovered BFS differs from frontier_bfs_hybrid")
        check(np.array_equal(d.result["rank"], ref["engine_rank"]),
              "recovered dense PageRank is not bit-equal to the "
              "uninterrupted run")
        ck = rm.histogram("serving.recovery.checkpoint_ms").to_dict()
        say(f"phase 10: recovery on {card}: BFS crashed at level 2 "
            f"(checkpoint every level), dense PageRank at superstep 10 "
            f"(every 5); both done on attempt 2 with one resume each, "
            f"bit-equal to their uninterrupted runs, in {rec_s:.4f} s; "
            f"rounds_replayed BFS {b.rounds_replayed}, dense "
            f"{d.rounds_replayed}; {ck['count']} checkpoints, "
            f"checkpoint_ms mean {ck['mean']:.3f}, max {ck['max']:.3f}")

        # ---- 4. admission: a cancel and a deadline while paused
        sched = scheduler()
        c = sched.submit(JobSpec(kind="bfs", params={"source_dense": 0}))
        check(sched.cancel(c.id) and c.state.value == "cancelled",
              "a queued job did not cancel")
        e = sched.submit(JobSpec(kind="bfs", params={"source_dense": 0},
                                 deadline=time.time() + 0.05))
        time.sleep(0.1)
        sched.start()
        check(e.wait(60) and e.state.value == "expired",
              f"a job past its deadline went {e.state.value}")
        sched.close()
        h2d = phase_m.counter_value("device.xfer.h2d_bytes",
                                    {"site": "bfs.chunked_csr"})
        check(h2d == predicted, f"bfs.chunked_csr H2D {h2d} bytes across "
              f"the phase, one upload is {predicted}")
        say(f"phase 10: admission: a queued job cancelled, a job past its "
            f"deadline expired while paused; bfs.chunked_csr H2D "
            f"{h2d} bytes across the phase: one upload")

        # ---- 5. profiling: the kernels' children, then on against off
        ex = {k: phase_m.counter_value("device.exec.calls", {"kernel": k})
              for k in ("frontier_round", "batched_exhaust", "seg_scan")}
        check(all(ex.values()), f"device.exec.calls children {ex}")
        ms = {k: round(sum(c.child.total for _, c in phase_m.children(
            "device.exec.ms", {"kernel": k})), 3) for k in ex}
        prof.uninstall()
        walls_pf = {True: [], False: []}
        for on in (False, True, True, False)[:2 * PROFILE_REPS]:
            sched = scheduler(profiling=on)
            jobs, w = serve(sched, bfs_specs)
            sched.close()
            check(all(np.array_equal(j.result["dist"], ref["bfs_rows"][s])
                      for s, j in zip(srcs, jobs)), "profiled BFS rows")
            walls_pf[on].append(w)
            check(snap._hybrid_csr_by_device.get(g["dstT"].device) is g,
                  "the cached chunked CSR was rebuilt")
        on_s = sum(walls_pf[True]) / len(walls_pf[True])
        off_s = sum(walls_pf[False]) / len(walls_pf[False])
        say(f"phase 10: device.exec children (CUDA events over the phase): "
            f"calls {ex}, ms {ms}; the served K={BATCH_K} batch with the "
            f"profiler on {on_s:.4f} s, off {off_s:.4f} s (mean of "
            f"{PROFILE_REPS} each, in turns off/on/on/off): "
            f"{on_s / off_s:.3f}x (the JAX package's guard is 1.15x; "
            f"reported, not gated)")
    finally:
        for s in scheds:
            if not s.closed:
                s.close()
        prof.uninstall()
        shutil.rmtree(root, ignore_errors=True)
    check(all(launches.total.values()), f"a kernel was never launched "
          f"by the served runs: {launches.total}")
    say(f"phase 10: served launches {launches.total}")
    return {"launches": launches.total, "served_s": served_s,
            "direct_s": direct_s, "k1_s": lat1, "profile_on_s": on_s,
            "profile_off_s": off_s}


#: phase 20's meshes on the one card: this many blocks share cuda:0
MESH_SHARDS = (2, 3)


def run_spans(sched, job) -> list:
    """The attributes of a served job's ``run`` spans."""
    out = []

    def walk(node):
        if node["name"] == "run":
            out.append(node.get("attrs", {}))
        for c in node["children"]:
            walk(c)
    for root in sched.tracer.tree(job.id)["spans"]:
        walk(root)
    return out


def same_rows(got, want, what: str) -> None:
    """``(dist, levels, completed)`` of two batched runs, bit-equal."""
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
          and np.array_equal(got[2], want[2]), f"{what}: rows, levels or "
          f"completion differ from the one-device run")


def phase_mesh_s22(F, P, S, ref, card, phase10) -> dict:
    """Phase 20 at s22, on phase 5's snapshot: the serving plane's
    ``mesh=``. For each ``local_mesh`` (``MESH_SHARDS`` blocks on cuda:0,
    then every card when there are several): the snapshot placed
    (``place_batched_csr``; each block's bytes and the allocator's growth
    on each card), the K = 16 batch served through ``JobScheduler(mesh=)``
    bit-equal row by row to the direct one-device ``frontier_bfs_batched``
    (its wall beside phase 10's direct and served walls), the run spans'
    ``meshed``, the ledger's resident bytes equal to
    ``meshed_snapshot_csr_bytes``, a BFS crashed at level 2 and resumed
    from its checkpoint on the mesh; then direct placed calls each equal
    to the one-device call: hops mode with level masks, a job dropped by
    ``on_level``, an ``init_dist`` resume. Returns the served runs'
    launches (``launches_by_path["mesh"]``)."""
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.recovery import FaultPlan
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.olap.serving.hbm import meshed_snapshot_csr_bytes
    from titan_tpu_torch.parallel import partition as PP
    from titan_tpu_torch.parallel.mesh import local_mesh
    from titan_tpu_torch.utils.metrics import MetricManager

    snap, hg = ref["snap"], ref["hg"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "mesh_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    srcs = sample_sources(hg["deg"], BATCH_K)
    specs = [JobSpec(kind="bfs", params={"source_dense": s}) for s in srcs]
    launches = ServedLaunches(F, S)
    # the one-device references, on the snapshot's cached chunked CSR
    direct = P.frontier_bfs_batched(snap, srcs)
    _, direct_s = wall_s(lambda: P.frontier_bfs_batched(snap, srcs))
    for k, s in enumerate(srcs):
        check(np.array_equal(direct[0][k], ref["bfs_rows"][s]), f"direct "
              f"row {k} differs from frontier_bfs_hybrid")
    q_total = P.build_chunked_csr(snap)["q_total"]
    lm = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, q_total, dtype=np.uint8)).cuda()
    hops_kw = dict(mode="hops", start_level=1, max_levels=4,
                   level_masks=[lm, None, lm])
    hops_ref = P.frontier_bfs_batched(snap, srcs, **hops_kw)
    check(not np.array_equal(hops_ref[0], P.frontier_bfs_batched(
        snap, srcs, mode="hops", start_level=1, max_levels=4)[0]),
        "the level masks changed no hop set")

    def on_level(level, nf):
        keep = np.ones(len(nf), bool)
        keep[1], keep[3] = level < 2, level < 3
        return keep
    drop_ref = P.frontier_bfs_batched(snap, srcs, on_level=on_level)
    check(not drop_ref[2][1] and not drop_ref[2][3], "on_level dropped "
          "no job")
    part = P.frontier_bfs_batched(snap, srcs, max_levels=2)[0]
    meshes = [local_mesh(["cuda:0"] * d) for d in MESH_SHARDS]
    if torch.cuda.device_count() > 1:
        meshes.append(local_mesh())
    out = []
    try:
        for mesh in meshes:
            D = mesh.size
            cards = sorted(set(mesh.devices), key=str)
            for d in cards:
                torch.cuda.synchronize(d)
            a0 = {d: torch.cuda.memory_allocated(d) for d in cards}
            placed, place_s = wall_s(lambda: PP.place_batched_csr(snap,
                                                                  mesh))
            grew = {str(d): torch.cuda.memory_allocated(d) - a0[d]
                    for d in cards}
            blocks = [{"device": str(sh["device"]), "vertices":
                       [sh["lo"], sh["hi"]], "columns": sh["q_total"],
                       "bytes": sum(sh[k].numel() * sh[k].element_size()
                                    for k in ("dstT", "colstart", "degc"))}
                      for sh in placed["_shards"]]
            for d in cards:
                mine = [b["bytes"] for b in blocks if b["device"] == str(d)]
                check(0 <= grew[str(d)] - sum(mine)
                      < ALLOC_SLACK * len(mine), f"the blocks on {d} hold "
                      f"{mine} bytes, its memory_allocated grew "
                      f"{grew[str(d)]}")
            sched = JobScheduler(snapshot=snap, mesh=mesh,
                                 device=mesh.devices[0], checkpoint_dir=root,
                                 autostart=False, max_batch=BATCH_K,
                                 metrics=MetricManager())
            try:
                jobs, served_s = launches.run(lambda: serve(sched, specs))
                copied = {k: list(v) for k, v in
                          P.LAST_WORDS_COPIED.items()}
                for k, j in enumerate(jobs):
                    check(j.state.value == "done" and j.batch_k == BATCH_K,
                          f"meshed BFS job {k}: {j.state.value}, batch_k "
                          f"{j.batch_k}, {j.error}")
                    check(np.array_equal(j.result["dist"], direct[0][k])
                          and j.result["levels"] == direct[1][k],
                          f"served meshed row {k} (D={D}) differs from "
                          f"the direct one-device call")
                    check([sp.get("meshed") for sp in run_spans(sched, j)]
                          == [D], f"job {k}'s run spans do not say meshed "
                          f"{D}")
                resident = sched.ledger.resident_bytes()
                per_dev = meshed_snapshot_csr_bytes(snap, D)
                check(resident == per_dev, f"ledger resident {resident}, "
                      f"meshed_snapshot_csr_bytes {per_dev}")
                rec = JobSpec(kind="bfs", params={
                    "source_dense": srcs[1],
                    "faults": FaultPlan(crash_at_round=2)},
                    checkpoint_every=1, max_retries=1,
                    retry_backoff_s=0.01)
                (rj,), rec_s = launches.run(lambda: serve(sched, [rec]))
                check(rj.state.value == "done" and rj.attempt == 2
                      and rj.rounds_replayed is not None
                      and np.array_equal(rj.result["dist"], direct[0][1]),
                      f"the crashed meshed job: {rj.state.value}, attempt "
                      f"{rj.attempt}, {rj.error}")
                check(sched._metrics.counter_value(
                    "serving.recovery.resumes") == 1, "the crashed meshed "
                    "job did not resume from its checkpoint")
            finally:
                sched.close()
            same_rows(P.frontier_bfs_batched(placed, srcs, **hops_kw),
                      hops_ref, f"D={D} hops with level masks")
            same_rows(P.frontier_bfs_batched(placed, srcs,
                                             on_level=on_level),
                      drop_ref, f"D={D} on_level drops")
            same_rows(P.frontier_bfs_batched(placed, srcs, init_dist=part,
                                             start_level=2),
                      direct, f"D={D} init_dist resume")
            (_, _, _), placed_s = wall_s(lambda: P.frontier_bfs_batched(
                placed, srcs))
            r = {"blocks_on": [str(d) for d in mesh.devices],
                 "blocks": blocks, "allocated_growth": grew,
                 "place_s": place_s, "served_s": served_s,
                 "direct_placed_s": placed_s, "recovered_s": rec_s,
                 "words_copied": copied, "ledger_resident": resident}
            out.append(r)
            say(f"phase 20: D={D} blocks on {r['blocks_on']} at "
                f"s{ENGINE_SCALE} on {card}: placed in {place_s:.4f} s "
                f"(host layout and upload), blocks {blocks}, "
                f"memory_allocated grew {grew}; served K={BATCH_K} batch "
                f"{served_s:.4f} s from the first submit to the last result, "
                f"every row bit-equal to the direct one-device call, run "
                f"spans meshed={D}, ledger resident {resident} = "
                f"meshed_snapshot_csr_bytes; a direct placed call "
                f"{placed_s:.4f} s against {direct_s:.4f} s on one device "
                f"(phase 10: direct {phase10['direct_s']:.4f} s, served "
                f"{phase10['served_s']:.4f} s); frontier words copied a "
                f"level {copied['bytes']} B (between cards "
                f"{copied['between_devices']}); a BFS crashed at level 2 "
                f"resumed from its checkpoint on attempt 2 in {rec_s:.4f} "
                f"s, equal; hops with level masks, on_level drops and an "
                f"init_dist resume equal to the one-device calls")
            del placed
            delattr(snap, PP.MESH_CACHE)
            torch.cuda.empty_cache()
    finally:
        if hasattr(snap, PP.MESH_CACHE):
            delattr(snap, PP.MESH_CACHE)
        shutil.rmtree(root, ignore_errors=True)
    check(launches.total["frontier_round"] > 0
          and launches.total["batched_exhaust"] > 0, f"a kernel was never "
          f"launched on the mesh path: {launches.total}")
    say(f"phase 20: mesh launches {launches.total}; records "
        + json.dumps(out))
    return {"launches": launches.total, "runs": out}


# ---- phase 11: the live plane's epoch merge and the interactive lane

#: bench.py's live_refresh_stage batch: undirected adds and removed
#: undirected base edges a delta batch
LIVE_BATCH_EDGES = 256
LIVE_BATCH_REMOVES = 8
#: the large epoch: undirected adds (2^19 rows fill the 2^19 bucket) and
#: removed undirected base edges, stopped at REMOVE_BUDGET_S (remove_edge
#: walks a row in a Python loop); 2^18 adds keep the smoke's clock, whose
#: host sync grows with the rows added
LARGE_ADDS = 1 << 18
LARGE_REMOVES = 4096
REMOVE_BUDGET_S = 60.0
#: the device merge is timed as the best of these runs, after a warm-up
MERGE_REPS = 3
#: the interactive lane as bench.py's interactive_stage sets it up
LANE_WINDOW_S = 0.05
SOLO_WINDOW_S = 1e-4
LANE_REPS = 3
LANE_DEPTH = 4
PPR_LANE_USERS = 8
PPR_LANE_ITERS = 10
TOP_K = 10


class LoggedLedger:
    """An HBM ledger whose reserve / release / unpin calls are logged;
    ``steps(names)`` reads the log with the keys named."""

    def __init__(self, ledger):
        self.ledger, self.log = ledger, []

    def reserve(self, key, nbytes):
        self.log.append(("reserve", key, nbytes))
        self.ledger.reserve(key, nbytes)

    def release(self, key):
        self.log.append(("release", key))
        self.ledger.release(key)

    def unpin(self, key):
        self.log.append(("unpin", key))
        self.ledger.unpin(key)

    def steps(self, names: dict) -> list:
        """The log, a tuple key (the compactor's double buffer) named
        ``next`` and the others by ``names``."""
        return [(op, "next" if isinstance(key, tuple) else names[key],
                 *rest) for op, key, *rest in self.log]


def remove_base_edges(ov, snap, pool, rng, count: int,
                      budget_s: float = float("inf")) -> tuple:
    """Tombstone ``count`` distinct undirected base edges, both rows, with
    ``remove_edge``; ``pool`` lists the rows with src < dst (each
    undirected edge once). Stops once ``budget_s`` has passed. Returns
    (edges removed, seconds)."""
    rows = pool[rng.choice(len(pool), count, replace=False)]
    t0 = time.time()
    done = 0
    for i in rows:
        if time.time() - t0 > budget_s:
            break
        u, v = int(snap.src[i]), int(snap.dst[i])
        check(ov.remove_edge(u, v, None) and ov.remove_edge(v, u, None),
              f"base edge {u}-{v} was not live")
        done += 1
    return done, time.time() - t0


def live_epochs(OV, snap, rng):
    """The two epochs of phase 11a over ``snap``: bench.py's default-policy
    epoch (delta batches until ``should_compact`` fires) and the large
    one. Returns one dict an epoch: overlay, metrics, what went in."""
    from titan_tpu_torch.olap.live import EpochCompactor
    from titan_tpu_torch.utils.metrics import MetricManager

    n = snap.n
    pool = np.flatnonzero(snap.src < snap.dst)
    zeros = np.zeros(2 * LIVE_BATCH_EDGES, np.int32)
    m1 = MetricManager()
    ov1 = OV.DeltaOverlay(snap, metrics=m1)
    batches = 0
    while not EpochCompactor().should_compact(ov1):
        a_s = rng.integers(0, n, LIVE_BATCH_EDGES).astype(np.int32)
        a_d = rng.integers(0, n, LIVE_BATCH_EDGES).astype(np.int32)
        ov1.append_edges(np.concatenate([a_s, a_d]),
                         np.concatenate([a_d, a_s]), zeros)
        remove_base_edges(ov1, snap, pool, rng, LIVE_BATCH_REMOVES)
        ov1.view()
        batches += 1
    epochs = [{"name": "default-policy", "ov": ov1, "metrics": m1,
               "batches": batches, "removed": batches * LIVE_BATCH_REMOVES,
               "remove_s": None}]
    m2 = MetricManager()
    ov2 = OV.DeltaOverlay(snap, metrics=m2)
    a_s = rng.integers(0, n, LARGE_ADDS).astype(np.int32)
    a_d = rng.integers(0, n, LARGE_ADDS).astype(np.int32)
    ov2.append_edges(np.concatenate([a_s, a_d]), np.concatenate([a_d, a_s]),
                     np.zeros(2 * LARGE_ADDS, np.int32))
    # one undirected add killed in place, both of its rows (as the plane
    # removes an edge of a symmetric base): the first whose ends are no
    # base edge. One row alone would leave a half edge, which the
    # overlay's top-down scatter follows and the merged epoch's
    # bottom-up rounds do not, in both packages
    dbs, ip = snap.out_csr()
    k = next(i for i in range(LARGE_ADDS)
             if a_s[i] != a_d[i]
             and not (dbs[ip[a_s[i]]:ip[a_s[i] + 1]] == a_d[i]).any())
    check(ov2.remove_edge(int(a_s[k]), int(a_d[k]), None)
          and ov2.remove_edge(int(a_d[k]), int(a_s[k]), None)
          and ov2.dead_adds == 2, "the add was not killed in place")
    removed, remove_s = remove_base_edges(ov2, snap, pool, rng,
                                          LARGE_REMOVES, REMOVE_BUDGET_S)
    ov2.view()
    epochs.append({"name": "large", "ov": ov2, "metrics": m2, "batches": 1,
                   "removed": removed, "remove_s": remove_s})
    return epochs


def host_oracles(snap, epochs):
    """The host oracle of each epoch, run beside the card's work: the
    compactor's full stable re-sort (``EpochCompactor.merge``), then
    ``build_chunked_csr`` on the CPU."""
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.olap.live import EpochCompactor

    out = []
    for ep in epochs:
        t0 = time.time()
        oracle = EpochCompactor(device="cpu").merge(snap, ep["ov"])
        t1 = time.time()
        ocsr = P.build_chunked_csr(oracle, "cpu")
        out.append({"snap": oracle, "csr": ocsr, "merge_s": t1 - t0,
                    "build_s": time.time() - t1})
    return out


def top_ops(prof, k: int = 8) -> list:
    """The ``k`` aten ops of a torch.profiler run with the most device
    time of their own: (name, calls, ms)."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.key.startswith("aten::"):
            rows.append((e.key, e.count, round(us / 1e3, 4)))
    return sorted(rows, key=lambda r: -r[2])[:k]


class Clocked:
    """Wraps the named functions of a module so that each call's seconds
    are kept under its name, in order, until ``restore()``."""

    def __init__(self, mod, names):
        self.mod = mod
        self.orig = {n: getattr(mod, n) for n in names}
        self.s = {n: [] for n in names}
        for n in names:
            setattr(mod, n, self._wrap(n))

    def _wrap(self, name):
        fn = self.orig[name]

        def call(*a, **kw):
            t = time.time()
            try:
                return fn(*a, **kw)
            finally:
                self.s[name].append(time.time() - t)
        return call

    def restore(self) -> None:
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)


def compact_epoch(P, SN, EM, snap, ep, launches, srcs, card) -> dict:
    """One epoch on the card: the compactor's device path through a
    logged ledger, the memory it takes, the device merge's time (best of
    MERGE_REPS by CUDA events, after a warm-up) and its top ops, and the
    BFS of ``srcs`` over base + overlay against the merged epoch."""
    from titan_tpu_torch.olap.live import EpochCompactor
    from titan_tpu_torch.olap.serving.hbm import (HBMLedger,
                                                  chunked_csr_bytes,
                                                  snapshot_csr_bytes)

    ov, mm = ep["ov"], ep["metrics"]
    view = ov.view()
    g = P.build_chunked_csr(snap)
    _, _, _, q_new = EM.merged_degrees_host(snap, ov)
    nbytes = chunked_csr_bytes(snap.n, q_new)

    def merge():
        return EM.merge_chunked_csr(g, view, q_total_new=q_new,
                                    e_base=snap.num_edges)
    merge()                                   # warm-up, discarded
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    comp = EpochCompactor()
    ledger = LoggedLedger(HBMLedger())
    base_bytes = snapshot_csr_bytes(snap)
    ledger.reserve(id(snap), base_bytes)      # the served current epoch
    ledger.unpin(id(snap))
    a0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the host sync's seconds, and those of its incremental out-CSR
    clock = Clocked(SN, ("merge_delta", "_merge_out_csr"))
    try:
        (merged, mode), compact_s = wall_s(lambda: comp.compact(
            snap, ov, ledger=ledger, metrics=mm))
    finally:
        clock.restore()
    host_s = {name: (s[-1] if s else None)
              for name, s in clock.s.items()}
    peak = torch.cuda.max_memory_allocated() - a0
    grew = torch.cuda.memory_allocated() - a0
    check(mode == "device" and comp.fallbacks == {}, f"epoch "
          f"{ep['name']}: mode {mode}, fallbacks {comp.fallbacks}")
    steps = ledger.steps({id(snap): "base", id(merged): "merged"})
    check(steps[2:] == [("reserve", "next", nbytes), ("release", "next"),
                        ("reserve", "merged", nbytes), ("unpin", "merged")]
          and ledger.ledger._bytes == {id(snap): base_bytes,
                                       id(merged): nbytes}
          and ledger.ledger.pinned_bytes() == 0,
          f"epoch {ep['name']}: ledger steps {steps}")
    check(0 <= grew - nbytes < ALLOC_SLACK, f"epoch {ep['name']}: the "
          f"merged CSR took {grew} bytes, the ledger predicts {nbytes}")
    out = merged._hybrid_csr_by_device[g["dstT"].device]
    ms = [timed(merge)[1] * 1e3 for _ in range(MERGE_REPS)]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        merge()
        torch.cuda.synchronize()
    ops = top_ops(prof)

    # the semantic check: what the overlay served is what the merge kept
    def bfs_both():
        d_ov, _, _ = P.frontier_bfs_batched(snap, srcs, overlay=view,
                                            return_device=True)
        d_m, _, _ = P.frontier_bfs_batched(merged, srcs,
                                           return_device=True)
        return d_ov, d_m
    d_ov, d_m = launches.run(bfs_both)
    check(torch.equal(d_ov, d_m), f"epoch {ep['name']}: the BFS over "
          f"base + overlay differs from the BFS on the merged epoch")
    del d_ov, d_m
    rec = {"epoch": ep["name"], "rows_added": ov.count,
           "dead_adds": ov.dead_adds, "tombstones": ov.tomb_count,
           "batches": ep["batches"], "removed_edges": ep["removed"],
           "remove_s": ep["remove_s"], "q_total": q_new,
           "device_merge_ms": min(ms), "device_merge_ms_runs": ms,
           "peak_bytes": peak, "grew_bytes": grew,
           "compact_device_s": compact_s,
           "merge_delta_s": host_s["merge_delta"],
           "merge_out_csr_s": host_s["_merge_out_csr"],
           "compact_device_ms": mm.histogram(
               "serving.live.compact_device_ms").max,
           "delta_bytes": mm.counter_value("serving.live.upload_bytes"),
           "full_bytes": snapshot_csr_bytes(merged), "top_ops": ops}
    say(f"phase 11a: epoch {ep['name']} on {card}: "
        f"{ov.count} rows added ({ov.dead_adds} killed in place), "
        f"{ov.tomb_count} base rows tombstoned; compact() in device mode, "
        f"no fallback, {compact_s:.4f} s (merge_delta "
        f"{host_s['merge_delta']:.4f} s, of it _merge_out_csr "
        f"{host_s['_merge_out_csr']:.4f} s); "
        f"device merge {min(ms):.4f} ms (best of {MERGE_REPS}: "
        f"{[round(x, 4) for x in ms]}), peak {peak} bytes above the "
        f"start, memory_allocated grew {grew} bytes for a {nbytes}-byte "
        f"merged CSR; ledger: the next epoch reserved beside the current, "
        f"re-keyed and unpinned; delta bytes {rec['delta_bytes']} against "
        f"{rec['full_bytes']} of the merged image; BFS of {len(srcs)} "
        f"sources over base + overlay equal to the merged epoch's; top "
        f"ops {ops}")
    return rec, merged, out


def check_against_oracle(ep, merged, out, oracle) -> None:
    """The merged epoch against its host oracle: the device CSR, the
    delta-synced arrays and their incremental out-CSR, the lazy mirror."""
    o, ocsr = oracle["snap"], oracle["csr"]
    name = ep["name"]
    check(out["q_total"] == ocsr["q_total"], f"epoch {name}: q_total")
    dstT = out["dstT"].cpu().numpy()
    check(np.array_equal(dstT, ocsr["dstT"].numpy()),
          f"epoch {name}: the device dstT differs from the host oracle's")
    for k in ("colstart", "degc", "deg"):
        check(torch.equal(out[k].cpu(), ocsr[k]), f"epoch {name}: {k}")
    for attr in ("src", "dst", "indptr_in", "out_degree"):
        check(np.array_equal(getattr(merged, attr), getattr(o, attr)),
              f"epoch {name}: merge_delta's {attr} differs from the oracle")
    for a, b, what in ((merged._out_csr[0], o._out_csr[0], "dst_by_src"),
                       (merged._out_csr[1], o._out_csr[1], "indptr_out"),
                       (merged._out_csr_order, o._out_csr_order,
                        "out_csr order")):
        check(np.array_equal(a, b), f"epoch {name}: the incremental "
              f"{what} differs from a fresh out_csr()")
    check(np.array_equal(out["_host"]["dstT"], dstT),
          f"epoch {name}: LazyHostMirror['dstT'] differs from the card's")


def phase_live_s22(P, SN, OV, EM, ref, card, launches) -> dict:
    """Phase 11a on phase 5's snapshot: two epochs merged on the card,
    each against its host oracle (computed in the background). Returns
    the epochs' records and the large epoch's overlay view and merged
    snapshot for phase 11b."""
    snap, hg = ref["snap"], ref["hg"]
    srcs = sample_sources(hg["deg"], BATCH_K)
    t0 = time.time()
    epochs = live_epochs(OV, snap, np.random.default_rng(SEED))
    say(f"phase 11a: overlays built in {time.time() - t0:.1f} s: "
        f"default policy {epochs[0]['batches']} batch(es) of "
        f"{2 * LIVE_BATCH_EDGES} rows and {LIVE_BATCH_REMOVES} undirected "
        f"removals; large {epochs[1]['ov'].count} rows, "
        f"{epochs[1]['removed']} of {LARGE_REMOVES} undirected base edges "
        f"removed in {epochs[1]['remove_s']:.1f} s (budget "
        f"{REMOVE_BUDGET_S:.0f} s)")
    oracles = Background(lambda: host_oracles(snap, epochs))
    recs, results = [], []
    for ep in epochs:
        rec, merged, out = compact_epoch(P, SN, EM, snap, ep, launches,
                                         srcs, card)
        recs.append(rec)
        results.append((merged, out))
    t0 = time.time()
    done = oracles.result()
    waited = time.time() - t0
    for ep, (merged, out), oracle, rec in zip(epochs, results, done, recs):
        check_against_oracle(ep, merged, out, oracle)
        rec["compact_host_s"] = oracle["merge_s"]
        rec["oracle_csr_s"] = oracle["build_s"]
    del done
    say(f"phase 11a: both epochs bit-equal to the host oracle (dstT, "
        f"colstart, degc, deg, q_total; src, dst, indptr_in, out_degree "
        f"and the incremental out-CSR against a fresh out_csr(); the lazy "
        f"mirror's dstT against the card's); compact_host_s "
        f"{[round(r['compact_host_s'], 3) for r in recs]}, the oracle's "
        f"CPU chunked CSR {[round(r['oracle_csr_s'], 3) for r in recs]} s "
        f"(in the background; waited {waited:.1f} s)")
    say("phase 11a: records " + json.dumps(
        [{k: v for k, v in r.items() if k != "top_ops"} for r in recs]))
    return {"records": recs, "view": epochs[-1]["ov"].view(),
            "merged": results[-1][0]}


def hop_sets(g, x: int, depth: int) -> list:
    """The exact hop-1..depth sets from ``x`` (bool [n] each), by
    ``expand_once`` alone."""
    cur = torch.zeros(g["n"], dtype=torch.bool, device=g["dstT"].device)
    cur[x] = True
    out = []
    for _ in range(depth):
        cur = expand_once(g, cur)
        out.append(cur)
    return out


def labeled_expansion(ends, n: int, x: int, hop_codes) -> torch.Tensor:
    """The hop set of an out() chain whose hop h follows only edges with a
    label code in ``hop_codes[h]``, in plain torch over the snapshot's
    (src, dst, label) rows on the card."""
    src, dst, lab = ends
    cur = torch.zeros(n, dtype=torch.bool, device=src.device)
    cur[x] = True
    for codes in hop_codes:
        keep = cur[src] & torch.isin(lab, torch.tensor(codes,
                                                        device=lab.device))
        nxt = torch.zeros_like(cur)
        nxt[dst[keep]] = True
        cur = nxt
    return cur


def burst(lane, bodies, plan_from_wire) -> list:
    """Submit ``bodies`` to ``lane`` from one thread each, released
    together; returns [(result, ms from submit to reply)] in order. The
    garbage of earlier answers (lists of millions of ids) is collected
    first: a collection inside the burst holds every submitter for tens
    of ms, longer than the fuse window."""
    gc.collect()
    out = [None] * len(bodies)
    gate = threading.Barrier(len(bodies))

    def go(i):
        plan = plan_from_wire(bodies[i])
        gate.wait()
        t = time.time()
        try:
            out[i] = (lane.submit(plan), (time.time() - t) * 1e3)
        except Exception as e:           # re-raised below, in order
            out[i] = (e, None)
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        check(not t.is_alive(), "a point query did not return")
    for res, _ in out:
        if isinstance(res, Exception):
            raise res
    return out


def one_batch(out, k: int, what: str) -> list:
    """The results of a burst that must have run as ONE batch of k."""
    res = [r for r, _ in out]
    check({r["fused_k"] for r in res} == {k}
          and len({r["batch"] for r in res}) == 1,
          f"{what}: not one batch of {k}: "
          f"{[(r['batch'], r['fused_k']) for r in res]}")
    return res


def phase_interactive_s22(P, FR, PR, SN, ref, live, card, launches) -> dict:
    """Phase 11b on phase 5's snapshot: the interactive lane through
    ``JobScheduler.interactive()``, fused (window LANE_WINDOW_S, up to 16)
    beside solo (SOLO_WINDOW_S), as bench.py's interactive_stage runs
    it; every answer against a top-down expansion; then the same lane
    under phase 11a's large-epoch overlay, and personalized PageRank."""
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.olap.serving.hbm import snapshot_csr_bytes
    from titan_tpu_torch.olap.serving.interactive import (
        FallbackToInterpreter, plan_from_wire)
    from titan_tpu_torch.utils.metrics import MetricManager, nearest_rank

    snap, hg = ref["snap"], ref["hg"]
    n = snap.n
    g = P.build_chunked_csr(snap)
    srcs = sample_sources(hg["deg"], BATCH_K)
    t0 = time.time()
    sets = {x: hop_sets(g, x, LANE_DEPTH) for x in srcs}
    sets_s = time.time() - t0
    scheds = []

    def scheduler(s, window):
        sch = JobScheduler(snapshot=s, metrics=MetricManager(),
                           autostart=False, interactive_window_s=window,
                           interactive_max_fuse=BATCH_K)
        scheds.append(sch)
        return sch

    def q(x, **kw):
        return dict({"start": [int(x)], "dir": "both", "hops": 2,
                     "terminal": "count"}, **kw)

    def same_ids(res, want, what):
        got = np.sort(np.asarray(res["result"], np.int64))
        check(np.array_equal(got, torch.nonzero(want).flatten()
                             .cpu().numpy()), f"{what}: ids differ from "
              f"the top-down expansion")

    try:
        fused = scheduler(snap, LANE_WINDOW_S)
        solo = scheduler(snap, SOLO_WINDOW_S)
        lane_f, lane_s = fused.interactive(), solo.interactive()

        # ---- the fused K = 16 count batch against solo queries
        def lane_runs():
            lane_s.submit(plan_from_wire(q(srcs[0])))          # warm
            burst(lane_f, [q(x) for x in srcs], plan_from_wire)
            fused_runs = [burst(lane_f, [q(x) for x in srcs],
                                plan_from_wire) for _ in range(LANE_REPS)]
            seq = []
            for _ in range(LANE_REPS):
                for x in srcs:
                    t = time.time()
                    r = lane_s.submit(plan_from_wire(q(x)))
                    seq.append((r, (time.time() - t) * 1e3))
            return fused_runs, seq
        fused_runs, seq = launches.run(lane_runs)
        for out in fused_runs:
            for x, r in zip(srcs, one_batch(out, BATCH_K, "fused counts")):
                check(r["result"] == int(sets[x][1].sum()), f"count of "
                      f"{x}: {r['result']}, expansion {int(sets[x][1].sum())}")
        for (r, _), x in zip(seq, srcs * LANE_REPS):
            check(r["fused_k"] == 1 and r["result"] == int(sets[x][1].sum()),
                  f"solo count of {x}")
        fused_ms = [ms for out in fused_runs for _, ms in out]
        exec_ms = [r["exec_ms"] for out in fused_runs for r, _ in out]
        seq_ms = [ms for _, ms in seq]
        occ = fused._metrics.histogram("serving.interactive.fuse_k") \
            .to_dict()
        check(occ["count"] == LANE_REPS + 1 and occ["min"] == BATCH_K,
              f"fuse occupancy {occ}")
        # where a fused batch's time goes: the same hops sweep called
        # directly (with its [16] size readback), and the ledger's byte
        # count the lane computes a batch
        def direct():
            dist, _, _ = P.frontier_bfs_batched(
                g, srcs, max_levels=3, start_level=1, mode="hops",
                on_level=lambda level, nf: None if level <= 2
                else np.zeros(BATCH_K, bool), return_device=True)
            return (dist == 3).sum(dim=1, dtype=torch.int32).cpu()
        direct()
        sizes, direct_s = min((wall_s(direct) for _ in range(REPS)),
                              key=lambda r: r[1])
        check(sizes.tolist() == [int(sets[x][1].sum()) for x in srcs],
              "the direct hops sweep's sizes differ from the expansion")
        _, bytes_s = wall_s(lambda: snapshot_csr_bytes(snap))
        stats = {"point_query_fused_p50_ms": nearest_rank(fused_ms, 0.5),
                 "point_query_fused_p95_ms": nearest_rank(fused_ms, 0.95),
                 "point_query_seq_p50_ms": nearest_rank(seq_ms, 0.5),
                 "point_query_seq_p95_ms": nearest_rank(seq_ms, 0.95),
                 "fused_exec_ms_per_batch": nearest_rank(exec_ms, 0.5),
                 "fused_device_ms_per_query":
                     nearest_rank(exec_ms, 0.5) / BATCH_K,
                 "solo_exec_ms_p50": nearest_rank(
                     [r["exec_ms"] for r, _ in seq], 0.5),
                 "direct_hops_ms": direct_s * 1e3,
                 "ledger_bytes_ms": bytes_s * 1e3,
                 "fuse_occupancy": occ}
        say(f"phase 11b: interactive lane at s{ENGINE_SCALE} on {card}: "
            f"{LANE_REPS} bursts of {BATCH_K} 2-hop both() counts, each one "
            f"batch of {BATCH_K}, against {LANE_REPS * BATCH_K} solo "
            f"queries, every count equal to the top-down expansion (hop "
            f"sets to depth {LANE_DEPTH} of the {BATCH_K} sources in "
            f"{sets_s:.1f} s): " + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in stats.items()}))

        # ---- id terminal at depths 1-4, against the direct hops call
        depths = [1 + i % LANE_DEPTH for i in range(BATCH_K)]
        bodies = [q(x, hops=d, terminal="id") for x, d in zip(srcs, depths)]
        res = one_batch(launches.run(lambda: burst(
            lane_f, bodies, plan_from_wire)), BATCH_K, "ids at depths 1-4")
        for x, d, r in zip(srcs, depths, res):
            same_ids(r, sets[x][d - 1], f"{x} at depth {d}")
        del res

        def on_level(level, nf):
            keep = np.asarray([level <= d for d in depths])
            return keep if not keep.all() else None
        dist, _, _ = P.frontier_bfs_batched(
            g, srcs, max_levels=LANE_DEPTH + 1, start_level=1,
            on_level=on_level, mode="hops", return_device=True)
        for k, (x, d) in enumerate(zip(srcs, depths)):
            check(torch.equal(dist[k] == d + 1, sets[x][d - 1]),
                  f"direct hops row {k} differs from the expansion")
        del dist

        # ---- out() on the reversed layout, in_(): both equal both()
        rev_before = fused._metrics.counter_value(
            "device.xfer.h2d_bytes", {"site": "interactive.rev_csr"})
        for dirname in ("out", "in", "out"):
            bodies = [q(x, dir=dirname, terminal="id" if i < 4 else "count")
                      for i, x in enumerate(srcs)]
            res = one_batch(launches.run(lambda: burst(
                lane_f, bodies, plan_from_wire)), BATCH_K, dirname)
            for i, (x, r) in enumerate(zip(srcs, res)):
                if i < 4:
                    same_ids(r, sets[x][1], f"{dirname}() from {x}")
                else:
                    check(r["result"] == int(sets[x][1].sum()),
                          f"{dirname}() count from {x}")
            del res
        rev = snap._hybrid_csr_rev_by_device[g["dstT"].device]
        rev_bytes = fused._metrics.counter_value(
            "device.xfer.h2d_bytes", {"site": "interactive.rev_csr"}) \
            - rev_before
        check(rev_bytes == rev["dstT"].numel() * 4 + 3 * (n + 1) * 4,
              f"the reversed layout uploaded {rev_bytes} bytes: not once")
        check(torch.equal(rev["dstT"], g["dstT"]), "the reversed layout of "
              "a symmetric graph differs from its forward layout")
        say(f"phase 11b: ids at depths 1-4 (one batch of {BATCH_K}) equal "
            f"the expansion and a direct frontier_bfs_batched(mode='hops'); "
            f"out() and in_() equal both() and the expansion; the reversed "
            f"layout uploaded once ({rev_bytes} bytes), bit-equal to the "
            f"forward one on this symmetric graph")

        # ---- a mixed-label chain over a labeled view of the same arrays
        labels = np.random.default_rng(SEED).integers(
            0, 3, snap.num_edges).astype(np.int32)
        lsnap = SN.GraphSnapshot(n, snap.vertex_ids, snap.src, snap.dst,
                                 snap.indptr_in, snap.out_degree, {},
                                 labels, {0: "a", 1: "b", 2: "c"})
        # the same arrays: the layouts and the out-CSR carry over
        lsnap._out_csr, lsnap._out_csr_order = snap.out_csr(), \
            snap._out_csr_order
        lsnap._hybrid_csr_rev_by_device = dict(
            snap._hybrid_csr_rev_by_device)
        lane_l = scheduler(lsnap, LANE_WINDOW_S).interactive()
        chain = [["a"], ["b", "c"]]
        bodies = [q(x, dir="out", labels=chain, terminal="id")
                  for x in srcs]
        (res, t_mixed) = wall_s(lambda: launches.run(lambda: burst(
            lane_l, bodies, plan_from_wire)))
        res = one_batch(res, BATCH_K, "mixed-label chain")
        dev = g["dstT"].device
        ends = (torch.from_numpy(snap.src).to(dev).long(),
                torch.from_numpy(snap.dst).to(dev).long(),
                torch.from_numpy(labels).to(dev))
        sizes = []
        for x, r in zip(srcs, res):
            want = labeled_expansion(ends, n, x, [[0], [1, 2]])
            same_ids(r, want, f"mixed-label chain from {x}")
            sizes.append(int(want.sum()))
        del ends, lsnap, labels, res
        say(f"phase 11b: mixed-label out() chain a then b|c (per-hop slot "
            f"masks on the reversed layout), one batch of {BATCH_K} in "
            f"{t_mixed:.4f} s with the masks' build, ids equal to a "
            f"label-filtered expansion; hop-2 sizes {sizes}")

        # ---- under phase 11a's large-epoch overlay
        merged = scheduler(live["merged"], LANE_WINDOW_S).interactive()
        snap._live_overlay = live["view"]
        try:
            bodies = [q(x) for x in srcs]
            res = one_batch(launches.run(lambda: burst(
                lane_f, bodies, plan_from_wire)), BATCH_K, "overlay")
            want = one_batch(launches.run(lambda: burst(
                merged, bodies, plan_from_wire)), BATCH_K, "merged epoch")
            check([r["result"] for r in res] == [r["result"] for r in want],
                  "counts over base + overlay differ from the merged "
                  "epoch's")
            try:
                lane_f.submit(plan_from_wire(q(srcs[0], dir="out")))
                check(False, "a directed chain over the overlay ran")
            except FallbackToInterpreter:
                pass
        finally:
            del snap._live_overlay
        say(f"phase 11b: under the large epoch's overlay, {BATCH_K} 2-hop "
            f"both() counts equal the merged epoch's "
            f"{[r['result'] for r in res][:4]}...; a directed chain falls "
            f"back to the interpreter")

        # ---- personalized PageRank, fused
        users = srcs[:PPR_LANE_USERS]
        bodies = [{"kind": "ppr", "source": x, "iterations": PPR_LANE_ITERS,
                   "top_k": TOP_K} for x in users]
        res = one_batch(launches.run(lambda: burst(
            lane_f, bodies, plan_from_wire)), PPR_LANE_USERS, "ppr")
        (ranks, _), batched_s = wall_s(
            lambda: PR.pagerank_personalized_batched(
                snap, users, iterations=PPR_LANE_ITERS))
        seq_s = 0.0
        for x in users:
            one = torch.zeros(n, dtype=torch.float32, device=dev)
            one[x] = 1.0
            _, t = wall_s(lambda: FR.pagerank_dense(
                snap, iterations=PPR_LANE_ITERS, reset=one,
                return_device=True))
            seq_s += t
        worst = 0.0
        for s, (x, r) in enumerate(zip(users, res)):
            row = ranks[s]
            mine = PR.top_k_per_user(ranks[s:s + 1], snap.vertex_ids,
                                     k=TOP_K, exclude=[x])[0]
            check(len(r["result"]) == len(mine) == TOP_K, f"ppr {x}: "
                  f"{len(r['result'])} recommendations")
            for (v, rank), (w, _) in zip(r["result"], mine):
                err = abs(rank - row[v]) / row[v]
                worst = max(worst, err)
                check(err <= PPR_RTOL, f"ppr {x}: rank of {v} off by {err}")
                check(v == w or abs(row[v] - row[w])
                      <= PPR_RTOL * max(row[v], row[w]),
                      f"ppr {x}: {v} recommended where the direct run "
                      f"ranks {w}")
        stats.update({"ppr_users": PPR_LANE_USERS,
                      "ppr_iterations": PPR_LANE_ITERS,
                      "ppr_lane_exec_ms": res[0]["exec_ms"],
                      "ppr_batched_wall_s": batched_s,
                      "ppr_seq_wall_s": seq_s})
        say(f"phase 11b: {PPR_LANE_USERS} ppr queries ({PPR_LANE_ITERS} "
            f"iterations) in one batch, ranks within {worst:.3g} of a direct "
            f"pagerank_personalized_batched (tolerance {PPR_RTOL:g}), top-"
            f"{TOP_K} ids equal where ranks differ by more; lane exec "
            f"{res[0]['exec_ms']:.3f} ms; batched {batched_s:.4f} s against "
            f"{seq_s:.4f} s for {PPR_LANE_USERS} pagerank_dense(reset="
            f"one-hot) runs")
    finally:
        for s in scheds:
            s.close()
    return stats


#: bench.py's store_ingest stage (bench.py:992) one scale below the
#: engine's, with bench.py's edge factor and seed, bulk-loaded into the
#: port's in-memory store. The store path (phases 12-15) is host-bound
#: and sets the smoke's clock: at s22 the smoke took 1,153 s of its
#: 1,200 s on an H100 80GB HBM3 at 700.00 W whose host ran phases 12-13
#: 1.23 times slower than the one before, so the path runs at s21, where
#: every kernel still launches on it (the K = 2 and K = 16 batches)
STORE_SCALE = ENGINE_SCALE - 1
#: the freshness commit of phase 12: edges added and removed
STORE_ADDS, STORE_REMOVES = 64, 4


def rss_bytes() -> int:
    """This process's resident set."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class PeakRss(threading.Thread):
    """Samples this process's resident set every 0.2 s until ``stop()``;
    ``first`` is the first sample and ``peak`` the largest, in bytes."""

    def __init__(self):
        super().__init__(daemon=True)
        self.first = self.peak = rss_bytes()
        self._done = threading.Event()
        self.start()

    def run(self):
        while not self._done.wait(0.2):
            self.peak = max(self.peak, rss_bytes())

    def stop(self) -> int:
        self._done.set()
        self.join(5)
        return self.peak


def freshness_commit(g, snap, rng) -> None:
    """One transaction through the graph's tx API: ``STORE_ADDS`` edges
    between random vertices and ``STORE_REMOVES`` removed out-edges of
    low-degree vertices (their rows are short to read)."""
    vids = snap.vertex_ids
    tx = g.new_transaction()
    for a, b in rng.integers(0, snap.n, size=(STORE_ADDS, 2)):
        tx.vertex(int(vids[a])).add_edge("related", tx.vertex(int(vids[b])))
    low = np.flatnonzero((snap.out_degree >= 2) & (snap.out_degree <= 4))
    removed = 0
    for v in rng.choice(low, size=len(low), replace=False).tolist():
        out = list(tx.vertex(int(vids[v])).out_edges("related"))
        if out:
            out[0].remove()
            removed += 1
        if removed == STORE_REMOVES:
            break
    check(removed == STORE_REMOVES, f"only {removed} edges to remove")
    tx.commit()


def phase_store_ingest(P, G, ref, card, runs, traverse=None) -> tuple:
    """Phase 12, bench.py's store_ingest stage at ``STORE_SCALE``
    (``bench.py:992``): the R-MAT edges bulk-loaded into
    ``titan_tpu_torch.open("inmemory")`` and scanned back into a
    symmetric snapshot (``ingest_rmat_store``), its arrays checked against
    the generated edges, its BFS against the BFS on the generated graph of
    the same scale; then ``graph.compute()``: two BFS
    jobs through the graph-backed scheduler, whose pool's snapshot must
    equal the ingest's, PageRank through ``seg_scan`` over it, a
    freshness commit and its ``refresh()``. ``runs`` counts the main
    path's launches; the comparisons run outside it. Returns the bench.py
    record, the store's graph, open, its snapshots closed (phase 13
    serves it and closes it), and the refreshed snapshot's vertex arrays,
    epoch and BFS from the phase's source, which phase 13 holds its
    plane's fresh scan to. ``traverse(graph, snapshot)``, when given, runs
    on the refreshed snapshot before it is closed (phase 14a)."""
    from titan_tpu_torch import native
    from titan_tpu_torch.device import INF
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import bulk as B
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.utils.metrics import MetricManager

    dev = torch.device("cuda")
    scale = STORE_SCALE
    hg = G.load_or_build(scale, EDGE_FACTOR, seed=SEED, verbose=False)
    n, m = 1 << scale, (1 << scale) * EDGE_FACTOR
    # bench.py:1055-1079: the dists compare only when the reference graph
    # and the ingest came from the same generator, scale and seed
    made = (hg.get("generator"), int(hg["scale"]), hg.get("edge_factor"),
            hg.get("seed"))
    check(made == ("native", scale, EDGE_FACTOR, SEED), f"the reference "
          f"graph was made by {made}, the ingest by ('native', {scale}, "
          f"{EDGE_FACTOR}, {SEED}): the BFS distances are not comparable")
    source = sample_sources(hg["deg"], 1)[0]
    gref = G.graph_from_numpy(hg, dev)
    dist_ref, levels_ref = P.frontier_bfs_hybrid(gref, source,
                                                 return_device=True,
                                                 device=dev)
    del gref
    rss = PeakRss()

    t0 = time.time()
    res = B.ingest_rmat_store(scale, edge_factor=EDGE_FACTOR, seed=SEED)
    g, isnap = res["graph"], res["snapshot"]
    sched = kept = None
    try:
        say(f"phase 12: s{scale} ingest {res['ingest_s']:.1f} s "
            f"(bulk_load_adjacency, {res['m']} edges into the in-memory "
            f"store), scan into a symmetric snapshot {res['scan_s']:.1f} s "
            f"({isnap.n} vertices, {isnap.num_edges} rows)")
        # ---- the snapshot's arrays on the host against the generated edges
        vids = isnap.vertex_ids
        check(isnap.n == n and bool((np.diff(vids) > 0).all())
              and np.array_equal(vids, res["vertex_ids"]),
              "the snapshot's vertex_ids are not the loader's, ascending")
        src, dst = native.rmat_gen(m, scale, seed=SEED)
        want = torch.from_numpy(np.concatenate([src, dst])).to(dev)
        wdst = torch.from_numpy(np.concatenate([dst, src])).to(dev)
        del src, dst
        want = want.long() * n + wdst
        del wdst
        got = torch.from_numpy(isnap.src).to(dev).long() * n \
            + torch.from_numpy(isnap.dst).to(dev)
        same = bool(torch.equal(torch.sort(want).values,
                                torch.sort(got).values))
        del want, got
        check(same, "the store snapshot's (src, dst) multiset is not the "
              "generated edges plus their reverse")
        # ---- bench.py's BFS over the store snapshot
        t1 = time.time()
        csr = P.build_chunked_csr(isnap, dev)
        torch.cuda.synchronize()
        csr_s = time.time() - t1
        t2 = time.time()
        dist, levels = runs.run(lambda: P.frontier_bfs_hybrid(
            isnap, source, return_device=True, device=dev))
        torch.cuda.synchronize()
        bfs_s = time.time() - t2
        match = B.dist_match(dist, dist_ref, int(INF))
        check(match, "the store snapshot's BFS differs from the BFS on the "
              "generated graph")
        del csr
        rec = {"n_vertices": res["n"], "m_edges_ingested": res["m"],
               "ingest_seconds": round(res["ingest_s"], 1),
               "scan_snapshot_seconds": round(res["scan_s"], 1),
               "csr_build_upload_seconds": round(csr_s, 1),
               "bfs_seconds": round(bfs_s, 3),
               "bfs_levels": levels, "bfs_levels_ref": levels_ref,
               "dist_matches_generated": match,
               "total_seconds": round(time.time() - t0, 1)}
        say(f"phase 12: store_ingest_s{scale} " + json.dumps(rec))
        rec["scale"] = scale

        # ---- graph.compute(): two BFS jobs through the graph-backed
        # scheduler, whose pool scans the store; its snapshot then serves
        # PageRank and the freshness check (the store scans set the
        # smoke's clock: one is enough)
        comp = g.compute(backend="gpu", device=dev)
        sched = comp.scheduler(autostart=False, max_batch=BATCH_K,
                               metrics=MetricManager())
        srcs = sample_sources(hg["deg"], 2)
        specs = [JobSpec(kind="bfs", params={"source": int(vids[s])},
                         directed=False) for s in srcs]
        jobs, served_s = runs.run(lambda: serve(sched, specs))
        with sched.pool.acquire(directed=False) as csnap:
            pool = sched.pool.stats()
        check(pool["entries"] == 1 and pool["snapshots"] == 1,
              f"pool {pool}")
        check(all(np.array_equal(getattr(csnap, f), getattr(isnap, f))
                  for f in ("vertex_ids", "src", "dst", "indptr_in",
                            "out_degree")),
              "the pool's snapshot(directed=False) differs from the "
              "ingest's")
        isnap.close()
        isnap._invalidate_layout_caches()
        for j, s in zip(jobs, srcs):
            check(j.state.value == "done", f"{j} {j.state} {j.error}")
            d, _ = P.frontier_bfs_hybrid(csnap, s, device=dev)
            check(np.array_equal(j.result["dist"], np.minimum(d, INF)),
                  f"the served BFS from {s} differs from the direct call")
        f64 = Background(lambda: host_pagerank(csnap, 0.85, 20))
        pr = runs.run(lambda: MP.run(comp, 0.85, 20, 0.0, snapshot=csnap))
        torch.cuda.synchronize()
        rel = float(np.max(np.abs(pr["rank"] - f64.result())
                           / f64.result()))
        check(pr.iterations == 20 and rel <= PAGERANK_RTOL,
              f"store PageRank differs from float64 by {rel}")
        say(f"phase 12: compute() on {card}: 2 BFS jobs through the "
            f"graph-backed scheduler in {served_s:.3f} s (its pool scanned "
            f"the store), equal to the direct call; the pool's snapshot "
            f"equal to the ingest's; PageRank 20 supersteps over it within "
            f"{rel:.3g} of float64 scipy")
        # ---- freshness: a commit, refresh() of the pool's snapshot; the
        # rescan it is held to is phase 13's plane build
        t4 = time.time()
        freshness_commit(g, csnap, np.random.default_rng(SEED))
        commit_s = time.time() - t4
        check(csnap.stale, "a committed snapshot is not stale")
        t5 = time.time()
        stats = csnap.refresh()
        refresh_s = time.time() - t5
        check(stats == {"added_edges": STORE_ADDS,
                        "removed_edges": STORE_REMOVES,
                        "added_vertices": 0, "removed_vertices": 0},
              f"refresh() applied {stats}")
        with sched.pool.acquire(directed=False) as leased:
            check(leased is csnap and not csnap.stale
                  and csnap.epoch == g.mutation_epoch
                  and csnap.num_edges == res["m"] * 2
                  + 2 * (STORE_ADDS - STORE_REMOVES),
                  "the pool does not lease the refreshed snapshot")
            d_fresh, _ = runs.run(lambda: P.frontier_bfs_hybrid(
                csnap, source, return_device=True, device=dev))
        fresh = {f: getattr(csnap, f) for f in ("vertex_ids", "indptr_in",
                                                "out_degree")}
        fresh.update(epoch=csnap.epoch, num_edges=csnap.num_edges,
                     source=source, dist=d_fresh)
        if traverse is not None:
            traverse(g, csnap)
        sched.close()                    # closes the pool's snapshot
        sched = None
        rec.update(peak_rss_bytes=rss.stop(), start_rss_bytes=rss.first,
                   served_scan_seconds=round(served_s, 1),
                   commit_seconds=round(commit_s, 2),
                   refresh_seconds=round(refresh_s, 2),
                   phase_seconds=round(time.time() - t0, 1))
        say(f"phase 12: {STORE_ADDS} added and {STORE_REMOVES} removed "
            f"edges committed in {commit_s:.2f} s; the pool's snapshot "
            f"stale, refresh() {refresh_s:.2f} s, then leased at the "
            f"graph's epoch; the host's resident set "
            f"{rec['start_rss_bytes']} B at the phase's start, "
            f"{rec['peak_rss_bytes']} B at its peak")
        say(f"phase 12: record " + json.dumps(rec))
        kept = g
        return rec, kept, fresh
    finally:
        rss.stop()
        if sched is not None:
            sched.close()
        if kept is None:
            g.close()


# ---- phase 13: the live plane on phase 12's store graph

#: the plane's smallest overlay bucket: one commit of bench.py's
#: live_refresh shape (2 * LIVE_BATCH_EDGES rows) stays in the overlay
#: and the second reaches the default fill budget (0.5); at the overlay's
#: default of 1,024 rows the first commit would fold at once
PLANE_MIN_CAP = 2048
#: phase 13b's cross-instance graph: vertices, edges among the first half
#: of them, and the second handle's tagged commits
FEED_VERTICES, FEED_EDGES, FEED_COMMITS = 1000, 4000, 4
FEED_WAIT_S = 60.0


class FrozenOverlay:
    """What ``EpochCompactor.merge`` reads of an overlay, copied: the
    killed base rows and the live adds."""

    def __init__(self, ov):
        self.tomb_row_mask = ov.tomb_row_mask.copy()
        self._adds = ov.live_adds()           # copies

    def live_adds(self):
        return self._adds


def check_done(jobs) -> None:
    for j in jobs:
        check(j.state.value == "done", f"{j.spec.kind} job: "
              f"{j.state.value}, {j.error}")


def plane_commit(g, base, rng, low) -> tuple:
    """One commit of bench.py's live_refresh shape through the graph's
    transaction API: LIVE_BATCH_EDGES undirected adds between random
    existing vertices and LIVE_BATCH_REMOVES removed base edges, each the
    first out-edge of the next vertex of ``low`` (an iterator over
    low-degree vertices of ``base``). Returns (start, the writes'
    seconds, ``tx.commit()``'s seconds)."""
    vids = base.vertex_ids
    t0 = time.time()
    tx = g.new_transaction()
    for a, b in rng.integers(0, base.n, size=(LIVE_BATCH_EDGES, 2)):
        tx.vertex(int(vids[a])).add_edge("related", tx.vertex(int(vids[b])))
    removed = 0
    for v in low:
        out = list(tx.vertex(int(vids[v])).out_edges("related"))
        if out:
            out[0].remove()
            removed += 1
        if removed == LIVE_BATCH_REMOVES:
            break
    check(removed == LIVE_BATCH_REMOVES, f"only {removed} edges to remove")
    t1 = time.time()
    tx.commit()
    return t0, t1 - t0, time.time() - t1


def bfs_rows(jobs) -> np.ndarray:
    return np.stack([j.result["dist"] for j in jobs])


def top_down_rows(g, srcs) -> np.ndarray:
    """BFS levels from each of ``srcs`` by ``expand_once`` alone, INF
    where unreached: a BFS row's plain reference."""
    from titan_tpu_torch.device import INF
    n, dev = g["n"], g["dstT"].device
    rows = []
    for x in srcs:
        dist = torch.full((n,), INF, dtype=torch.int32, device=dev)
        cur = torch.zeros(n, dtype=torch.bool, device=dev)
        cur[x] = True
        seen, level = cur.clone(), 0
        while bool(cur.any()):
            dist[cur] = level
            cur = expand_once(g, cur) & ~seen
            seen |= cur
            level += 1
        rows.append(dist.cpu().numpy())
    return np.stack(rows)


def oracle_rows(P, oracle, base, frozen, srcs, dev) -> tuple:
    """The BFS rows over the host oracle ``EpochCompactor.merge(base,
    frozen)``: by ``frontier_bfs_batched``, and by ``top_down_rows`` over
    the same merged CSR."""
    merged = oracle.merge(base, frozen)
    rows = P.frontier_bfs_batched(merged, srcs, device=dev)[0]
    return rows, top_down_rows(P.build_chunked_csr(merged, dev), srcs)


class GcPauses:
    """Python's collector pauses, (generation, start, seconds), from
    construction until ``stop()``."""

    def __init__(self):
        self.pauses, self._t = [], 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.time()
        else:
            self.pauses.append((info["generation"], self._t,
                                time.time() - self._t))

    def within(self, t0: float, t1: float) -> float:
        return sum(s for _, t, s in self.pauses if t0 <= t < t1)

    def stop(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)


def compactions(sched) -> list:
    """The plane's compaction events on the scheduler's tracer (the
    reserved ``live`` trace): why, mode, epoch, ms."""
    return [{"why": s.attrs["why"], "mode": s.attrs["mode"],
             "epoch": s.attrs["epoch"], "ms": s.duration_ms}
            for s in sched.tracer.spans("live") or () if s.name == "compact"]


def phase_live_plane(P, FR, SN, card, g, runs, fresh) -> dict:
    """Phase 13a, the live plane's local lane over phase 12's store graph
    at s21: ``LiveGraphPlane`` and ``JobScheduler(live=)``, its fresh scan
    held to phase 12's refreshed snapshot (``fresh``), the 16 BFS on a
    clean base, commits in bench.py's live_refresh shape served over base
    + overlay until the default budget folds the epoch on the card, SSSP,
    WCC, the lane, and the compact-before-run jobs under a dirty overlay,
    then a resync; every result against its reference. ``runs`` counts
    the served runs' launches."""
    from titan_tpu_torch.device import INF, cache_key
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import bulk as B
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.live import EpochCompactor, LiveGraphPlane
    from titan_tpu_torch.olap.live import overlay as OVM
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.olap.serving.interactive import plan_from_wire
    from titan_tpu_torch.utils.metrics import MetricManager

    dev = torch.device("cuda")
    rss = PeakRss()
    mm = MetricManager()
    clock = Clocked(SN, ("merge_delta", "_merge_out_csr"))
    # the first removal in each overlay orders the base's labels by source
    labels_clock = Clocked(OVM.DeltaOverlay, ("_labels_src_order",))
    pauses = GcPauses()
    oracle = EpochCompactor(device="cpu")          # merge() is host-only
    rec = {}
    sched = None
    t_phase = time.time()
    try:
        t0 = time.time()
        plane = LiveGraphPlane(g, device=dev, metrics=mm,
                               min_cap=PLANE_MIN_CAP)
        rec["build_s"] = time.time() - t0
        sched = JobScheduler(live=plane, metrics=MetricManager(),
                             max_batch=BATCH_K, device=dev,
                             interactive_window_s=LANE_WINDOW_S,
                             interactive_max_fuse=BATCH_K)
        plane.pump()
        base = plane.snapshot
        n = base.n
        srcs = sample_sources(base.out_degree, BATCH_K)
        src_vids = [int(base.vertex_ids[s]) for s in srcs]
        bfs_specs = [JobSpec(kind="bfs", params={"source": v})
                     for v in src_vids]
        check(base.epoch == fresh["epoch"]
              and base.num_edges == fresh["num_edges"]
              and all(np.array_equal(getattr(base, f), fresh[f])
                      for f in ("vertex_ids", "indptr_in", "out_degree")),
              "the plane's fresh scan differs from phase 12's refreshed "
              "snapshot")
        say(f"phase 13a: LiveGraphPlane over the s{STORE_SCALE} store graph "
            f"built in {rec['build_s']:.1f} s ({n} vertices, "
            f"{base.num_edges} rows; one store scan, the overlay's out-CSR "
            f"index), its arrays equal to phase 12's refreshed snapshot's; "
            f"policy {plane.compactor.policy()}")

        # ---- a clean base
        jobs, rec["served_clean_s"] = runs.run(
            lambda: serve(sched, bfs_specs))
        check_done(jobs)
        check({j.batch_k for j in jobs} == {BATCH_K}, "the clean BFS jobs "
              f"ran as {[j.batch_k for j in jobs]}")
        direct, _, _ = P.frontier_bfs_batched(base, srcs, device=dev)
        check(np.array_equal(bfs_rows(jobs), direct), "a served BFS row "
              "over the clean base differs from frontier_bfs_batched")
        check(all(j.ran_epoch == {"epoch": 0, "seq": 0,
                                  "applied_epoch": g.mutation_epoch}
                  for j in jobs), f"ran_epoch {jobs[0].ran_epoch}")
        del direct
        d, _ = P.frontier_bfs_hybrid(base, fresh["source"],
                                     return_device=True, device=dev)
        check(B.dist_match(d, fresh["dist"], INF), "the BFS on the plane's "
              "fresh scan differs from the BFS on phase 12's refreshed "
              "snapshot")
        del d, fresh
        say(f"phase 13a: {BATCH_K} BFS jobs served over the clean base in "
            f"one batch of {BATCH_K}: {rec['served_clean_s']:.4f} s from "
            f"the first submit (the base's chunked CSR built and uploaded "
            f"on the way); every row equal to frontier_bfs_batched on the "
            f"plane's base; the BFS from phase 12's source equal to its "
            f"BFS on the refreshed snapshot")

        # ---- writes until the default budget folds the epoch on the card
        rng = np.random.default_rng(SEED)
        low = iter(rng.permutation(np.flatnonzero(
            (base.out_degree >= 2) & (base.out_degree <= 4))).tolist())
        commits, dirty = [], None
        while plane.epoch == 0:
            check(len(commits) < 64, "the default budget never fired")
            folding = plane.overlay
            commits.append(plane_commit(g, base, rng, low))
            plane.pump()
            ov = plane.overlay
            if plane.epoch == 0 and dirty is None and (
                    ov.count + 2 * LIVE_BATCH_EDGES
                    >= plane.compactor.max_fill * ov.cap):
                # the next commit folds: serve over base + overlay now
                snap_d, view_d, info_d = plane.lease_state()
                check(snap_d is base and not view_d.empty, "no overlay")
                jobs, rec["served_dirty_s"] = runs.run(
                    lambda: serve(sched, bfs_specs))
                check_done(jobs)
                check(all(j.ran_epoch == info_d for j in jobs),
                      f"ran_epoch {jobs[0].ran_epoch}, the plane's {info_d}")
                # the host oracle's BFS, beside the fold, over a copy of
                # the overlay's state: the next commit appends to it
                frozen = FrozenOverlay(ov)
                dirty = (ov.count, ov.tomb_count, info_d, bfs_rows(jobs),
                         Background(lambda: oracle_rows(
                             P, oracle, base, frozen, srcs, dev)))
        check(dirty is not None, "the epoch folded before a dirty serve")
        merged = plane.snapshot
        folds = compactions(sched)
        check([(c["why"], c["mode"]) for c in folds] == [("budget",
                                                          "device")]
              and plane.compactor.fallbacks == {}
              and mm.counter_value("serving.live.device_merge_fallbacks")
              == 0, f"the budget fold: {folds}, fallbacks "
              f"{plane.compactor.fallbacks}")
        t1 = time.time()
        want, plain = dirty[4].result()
        waited = time.time() - t1
        check(np.array_equal(dirty[3], want), "a served BFS row over base "
              "+ overlay differs from the BFS on the host oracle "
              "EpochCompactor.merge(base, overlay)")
        check(np.array_equal(np.minimum(dirty[3], INF), plain), "a served "
              "BFS row over base + overlay differs from the top-down BFS "
              "by expand_once over the host oracle's CSR")
        del want, plain
        say(f"phase 13a: {len(commits)} commits of {LIVE_BATCH_EDGES} "
            f"undirected adds and {LIVE_BATCH_REMOVES} removed base edges; "
            f"{BATCH_K} BFS served over base + overlay ({dirty[0]} rows "
            f"added, {dirty[1]} tombstoned, ran_epoch {dirty[2]}) in "
            f"{rec['served_dirty_s']:.4f} s, every row equal to the BFS on "
            f"the host oracle and to the top-down BFS by expand_once over "
            f"its CSR (both run beside the fold; waited {waited:.1f} s); "
            f"the next commit folded the epoch on the card: {folds[0]}")
        del dirty
        # the republished base against the host oracle, in the background
        fold_oracle = Background(lambda: host_oracles(
            base, [{"ov": folding}])[0])

        # ---- under a dirty overlay: SSSP, WCC, the lane, then the
        # compact-before-run jobs
        commits.append(plane_commit(g, base, rng, low))
        plane.pump()
        snap2, view2, info2 = plane.lease_state()
        check(snap2 is merged and not view2.empty and info2["epoch"] == 1,
              f"lease {info2}")
        sssp_vid = int(snap2.vertex_ids[np.flatnonzero(
            snap2.out_degree > 0)[0]])
        jobs, mixed_s = runs.run(lambda: serve(sched, [
            JobSpec(kind="sssp", params={"source": sssp_vid}),
            JobSpec(kind="wcc")]))
        check_done(jobs)
        check(all(j.ran_epoch == info2 for j in jobs), "SSSP/WCC ran_epoch")
        d, r = FR.frontier_sssp(snap2, snap2.dense_of(sssp_vid),
                                overlay=view2, device=dev)
        check(np.array_equal(jobs[0].result["dist"].view(np.int32),
                             d.view(np.int32))
              and jobs[0].result["rounds"] == r,
              "the served SSSP differs from frontier_sssp on its lease")
        lab, wr = FR.frontier_wcc(snap2, overlay=view2, device=dev)
        served_labels = jobs[1].result["labels"]
        check(np.array_equal(served_labels, lab)
              and jobs[1].result["rounds"] == wr,
              "the served WCC differs from frontier_wcc on its lease")
        del d, lab
        lane = sched.interactive()
        bodies = [{"start": [v], "dir": "both", "hops": 2,
                   "terminal": "count"} for v in src_vids]
        res = one_batch(runs.run(lambda: burst(lane, bodies,
                                               plan_from_wire)),
                        BATCH_K, "the lane over the overlay")
        check(all(r_["epoch"] == info2 for r_ in res),
              f"the lane answered at {res[0]['epoch']}, the plane's {info2}")
        # the compact-before-run jobs fold this same overlay
        jobs, pr_s = runs.run(lambda: serve(sched, [
            JobSpec(kind="pagerank", params={"iterations": 20})]))
        check_done(jobs)
        snap3 = plane.snapshot
        check(jobs[0].ran_epoch["seq"] == 0
              and jobs[0].ran_epoch["epoch"] == 2, f"the pagerank job "
              f"ran at {jobs[0].ran_epoch}: it did not compact first")
        f64 = Background(lambda: host_pagerank(snap3, 0.85, 20))
        components = Background(lambda: min_label_components(snap3))
        inv = np.where(snap3.out_degree > 0, 1.0 / np.maximum(
            snap3.out_degree, 1), 0.0).astype(np.float32)
        dense, dense_s = runs.run(lambda: serve(sched, [
            JobSpec(kind="dense", params={
                "program": MP.PageRank(0.85, 20, 0.0), "n": n,
                "inv_outdeg": inv})]))
        check_done(dense)
        check(dense[0].ran_epoch == jobs[0].ran_epoch, f"the dense job ran "
              f"at {dense[0].ran_epoch}, pagerank at {jobs[0].ran_epoch}")
        # the lane's counts against expand_once over the merged arrays
        g3 = snap3._hybrid_csr_by_device[cache_key(dev)]
        for s, r_ in zip(srcs, res):
            want = int(hop_sets(g3, s, 2)[1].sum())
            check(r_["result"] == want, f"lane count from {s}: "
                  f"{r_['result']}, expansion over the merged arrays {want}")
        rank64 = f64.result()
        errs = [float(np.max(np.abs(j.result["rank"] - rank64) / rank64))
                for j in (jobs[0], dense[0])]
        check(max(errs) <= PAGERANK_RTOL, f"pagerank / dense differ from "
              f"float64 over the merged arrays by {errs}")
        check(np.array_equal(served_labels, components.result()), "the "
              "served WCC labels differ from scipy's components over the "
              "merged arrays")
        del rank64, g3, served_labels, components
        folds = compactions(sched)
        check([(c["why"], c["mode"]) for c in folds[1:]]
              == [("compact-before-run", "device")]
              and mm.counter_value("serving.live.device_merge_fallbacks")
              == 0, f"compact-before-run: {folds}")
        say(f"phase 13a: under a dirty overlay (ran_epoch {info2}): SSSP "
            f"and WCC served in {mixed_s:.4f} s, equal to frontier_sssp "
            f"and frontier_wcc on the same lease; a fused lane batch of "
            f"{BATCH_K} 2-hop both() counts (exec {res[0]['exec_ms']:.3f} "
            f"ms); then pagerank ({pr_s:.3f} s) and dense ({dense_s:.3f} s) "
            f"jobs compacted that overlay before they ran (ran_epoch "
            f"{jobs[0].ran_epoch}; the fold {folds[1]}), within "
            f"{max(errs):.3g} of float64 over the merged arrays; the WCC "
            f"labels equal scipy's components and the lane's counts "
            f"expand_once over them")
        out = getattr(merged, "_hybrid_csr_by_device", {}).get(
            cache_key(dev))
        check(out is not None, "the budget epoch was published without "
              "its device CSR")
        t1 = time.time()
        check_against_oracle({"name": "budget"}, merged, out,
                             fold_oracle.result())
        say(f"phase 13a: the budget epoch's republished base bit-equal to "
            f"its host oracle (the device CSR, merge_delta's arrays and "
            f"incremental out-CSR, the lazy mirror; waited "
            f"{time.time() - t1:.1f} s)")
        del out, fold_oracle, folding, merged, base

        # ---- resync: the listener-overflow recovery, a full rescan
        jobs, _ = runs.run(lambda: serve(sched, bfs_specs))
        check_done(jobs)
        before = bfs_rows(jobs)
        t1 = time.time()
        with plane._lock:
            plane._resync("chip check")
        rec["resync_s"] = time.time() - t1
        jobs, after_s = runs.run(lambda: serve(sched, bfs_specs))
        check_done(jobs)
        check(np.array_equal(bfs_rows(jobs), before), "the BFS rows over "
              "the resynced base differ from the rows served before it")
        check(mm.counter_value("serving.live.resyncs") == 1, "resyncs")

        folds = compactions(sched)
        check(all(c["why"] != "hbm admission" for c in folds),
              f"a compaction for HBM admission: {folds}")
        stats = plane.stats()
        apply_ms = mm.histogram("serving.live.apply_ms").to_dict()
        rec.update(commits=len(commits),
                   write_s=[w for _, w, _ in commits],
                   commit_s=[c for _, _, c in commits],
                   commit_gc_s=[pauses.within(t, t + w + c)
                                for t, w, c in commits],
                   apply_ms=mm.histogram("serving.live.apply_ms").values(),
                   apply_ms_p50=apply_ms["p50"], apply_ms_p95=apply_ms["p95"],
                   labels_order_s=[x for x in labels_clock.s[
                       "_labels_src_order"] if x >= 1e-3],
                   gc_pauses=[(gen, round(t - t_phase, 3), x)
                              for gen, t, x in pauses.pauses if x >= 0.05],
                   compactions=folds,
                   device_merge_ms=mm.histogram(
                       "serving.live.compact_device_ms").values(),
                   merge_delta_s=clock.s["merge_delta"],
                   merge_out_csr_s=clock.s["_merge_out_csr"],
                   freshness=stats["freshness"],
                   served_after_resync_s=after_s)
        say(f"phase 13a: resync (a full rescan, the queue re-anchored) in "
            f"{rec['resync_s']:.1f} s; the {BATCH_K} BFS rows over the "
            f"resynced base equal the rows served before it ({after_s:.3f} "
            f"s with the upload)")
        say(f"phase 13a: {len(commits)} commits in "
            f"{sum(rec['write_s']) + sum(rec['commit_s']):.3f} s: the "
            f"writes s {rec['write_s']}, "
            f"tx.commit() s {rec['commit_s']}, the collector's pauses in "
            f"them s {rec['commit_gc_s']}; applies ms {rec['apply_ms']}, "
            f"of them the base labels' source order (each overlay's first "
            f"removal) s {rec['labels_order_s']}; the collector's pauses "
            f"of 0.05 s or more in the phase (generation, at s, s) "
            f"{rec['gc_pauses']}")
        say(f"phase 13a: apply_ms p50 {apply_ms['p50']:.3f} p95 "
            f"{apply_ms['p95']:.3f} over {apply_ms['count']} applies; "
            f"compactions {folds}; device merge ms "
            f"{rec['device_merge_ms']}; host sync merge_delta s "
            f"{[round(x, 2) for x in rec['merge_delta_s']]} (of it "
            f"_merge_out_csr {[round(x, 2) for x in rec['merge_out_csr_s']]}"
            f"); served K={BATCH_K} clean {rec['served_clean_s']:.4f} s, "
            f"dirty {rec['served_dirty_s']:.4f} s; freshness "
            f"{stats['freshness']}")
        sched.close()                    # closes the plane
        sched = None
        rec["phase_s"] = time.time() - t_phase
        rec["peak_rss_bytes"] = rss.stop()
        say(f"phase 13a: the host's resident set {rss.first} B at the "
            f"phase's start, {rec['peak_rss_bytes']} B at its peak; the "
            f"phase {rec['phase_s']:.1f} s; record " + json.dumps(
                {k: v for k, v in rec.items() if k != "compactions"}))
        return rec
    finally:
        clock.restore()
        labels_clock.restore()
        pauses.stop()
        rss.stop()
        if sched is not None:
            sched.close()


def phase_live_feed(P, SN, card, runs) -> None:
    """Phase 13b on a small sqlite graph (correctness only, host-sized):
    two port handles over one directory; the plane on the first, with
    ``log_identifier=``, serves the second handle's tagged commits through
    the change feed, and its own tagged commit arrives once; then a
    vertex-set change, which the plane folds on the host path and the
    next BFS reaches."""
    import tempfile

    import titan_tpu_torch
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.live import LiveGraphPlane
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.utils.metrics import MetricManager

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as d:
        def handle(instance):
            return titan_tpu_torch.open({
                "storage.backend": "sqlite", "storage.directory": d,
                "graph.unique-instance-id": instance})
        g1, g2 = handle("a"), handle("b")
        sched = None
        try:
            rng = np.random.default_rng(SEED)
            half = FEED_VERTICES // 2
            tx = g1.new_transaction()
            vs = [tx.add_vertex() for _ in range(FEED_VERTICES)]
            for a, b in rng.integers(0, half, size=(FEED_EDGES, 2)):
                vs[a].add_edge("link", vs[b])
            tx.commit()
            vids = [v.id for v in vs]
            mm = MetricManager()
            plane = LiveGraphPlane(g1, device=dev, metrics=mm,
                                   log_identifier="chip")
            sched = JobScheduler(live=plane, metrics=MetricManager(),
                                 max_batch=BATCH_K, device=dev)
            # the second handle: a chain from the first half into the
            # isolated second half, one tagged commit a link
            chain = [vids[0]] + vids[half:half + FEED_COMMITS]
            for a, b in zip(chain, chain[1:]):
                tx = g2.new_transaction(log_identifier="chip")
                tx.vertex(a).add_edge("link", tx.vertex(b))
                tx.commit()
            # the plane's own tagged commit: through the listener only
            tx = g1.new_transaction(log_identifier="chip")
            tx.vertex(chain[-1]).add_edge("link", tx.vertex(
                vids[half + FEED_COMMITS]))
            tx.commit()
            rows = 2 * (FEED_COMMITS + 1)
            deadline = time.time() + FEED_WAIT_S
            while time.time() < deadline:
                plane.pump()
                if plane.overlay.count >= rows:
                    break
                time.sleep(0.05)
            time.sleep(0.5)
            plane.pump()
            st = plane.stats()
            check(plane.overlay.count == rows
                  and st["counters"]["feed_batches"] == FEED_COMMITS
                  and st["freshness"]["feed_pending"] == 0,
                  f"the feed lane: {plane.overlay.count} rows of {rows}, "
                  f"{st['counters']}")
            srcs = [vids[0], vids[1], vids[half]]
            specs = [JobSpec(kind="bfs", params={"source": v})
                     for v in srcs]
            jobs, _ = runs.run(lambda: serve(sched, specs))
            check_done(jobs)
            fresh = SN.build(g1, directed=False)
            want, _, _ = P.frontier_bfs_batched(
                fresh, [fresh.dense_of(v) for v in srcs], device=dev)
            check(np.array_equal(bfs_rows(jobs), want), "a BFS served "
                  "through the feed differs from the BFS on a rebuilt "
                  "snapshot")
            reach = jobs[0].result["dist"]
            snap = plane.snapshot
            check(all(reach[snap.dense_of(v)] < (1 << 30)
                      for v in chain + [vids[half + FEED_COMMITS]]),
                  "the BFS does not reach the second handle's chain")
            say(f"phase 13b: sqlite, two handles, {FEED_VERTICES} vertices: "
                f"the second handle's {FEED_COMMITS} tagged commits reached "
                f"the plane through the feed ({st['counters']['feed_batches']}"
                f" batches) and the plane's own once ({plane.overlay.count} "
                f"overlay rows); the BFS served on {card} reaches the chain "
                f"and equals the BFS on a rebuilt snapshot")
            # ---- a vertex-set change: the host path, then apply_changes
            tx = g1.new_transaction()
            w = tx.add_vertex()
            tx.vertex(vids[0]).add_edge("link", w)
            tx.commit()
            jobs, vs_s = runs.run(lambda: serve(sched, specs))
            check_done(jobs)
            s2 = plane.snapshot
            row = jobs[0].result["dist"]
            folds = compactions(sched)
            check(s2.n == FEED_VERTICES + 1
                  and row[s2.dense_of(w.id)] == row[s2.dense_of(vids[0])] + 1
                  and [(c["why"], c["mode"]) for c in folds]
                  == [("vertex-set change", "host")]
                  and plane.compactor.fallbacks == {"apply-path": 1},
                  f"the vertex-set change: {folds}, fallbacks "
                  f"{plane.compactor.fallbacks}")
            fresh = SN.build(g1, directed=False)
            want, _, _ = P.frontier_bfs_batched(
                fresh, [fresh.dense_of(v) for v in srcs], device=dev)
            check(np.array_equal(bfs_rows(jobs), want), "the BFS after the "
                  "vertex-set change differs from the BFS on a rebuilt "
                  "snapshot")
            say(f"phase 13b: one vertex with an edge committed; the plane "
                f"folded on the host path ({folds[0]}) and the next BFS "
                f"({vs_s:.3f} s) reaches it, equal to the BFS on a rebuilt "
                f"snapshot")
        finally:
            if sched is not None:
                sched.close()
            g1.close()
            g2.close()

# ---- phase 14: Gremlin traversals compiled onto the card

#: the seeded starts of the store snapshot's both() chain
TRAVERSAL_STARTS = 16
#: timed runs of each store chain after its first (checked) run
TRAVERSAL_REPS = 3
#: the seeded labelled property graph of the small-graph checks
PROPERTY_VERTICES, PROPERTY_EDGES = 2000, 10000


def run_compiled(OC, t):
    """``t.to_list()`` through the user's entry point, held to have run
    the compiled supersteps: ``try_compile`` matches the chain and the
    device profiler's ``traversal.supersteps`` seam counts exactly one
    call (the interpreter never reaches it, and a semantic fallback
    would leave it at zero). Returns (result, wall s, device ms)."""
    from titan_tpu_torch.obs import devprof
    steps = type(t)._fold_has_into_start(list(t._steps))
    check(OC.try_compile(steps, t.source) is not None,
          f"the chain {steps} does not compile")
    with devprof.DeviceCostProfiler() as prof:
        out, wall = wall_s(t.to_list)
        k = prof.kernel_stats().get("traversal.supersteps",
                                    {"calls": 0, "exec_s": 0.0})
    check(k["calls"] == 1, f"the chain {steps} did not run compiled "
          f"({k['calls']} superstep runs)")
    return out, wall, k["exec_s"] * 1e3


def host_expand(A, c, direction: str):
    """One expand of the int64 count vector ``c`` on the host: ``A`` is
    the snapshot's edges as a scipy CSR with rows = dst, columns = src,
    so ``A @ c`` sums c over each vertex's in-edges (out())."""
    if direction == "out":
        return A @ c
    if direction == "in":
        return A.T @ c
    return A @ c + A.T @ c


def store_traversal_refs(snap, starts, hub) -> dict:
    """The four store chains' answers in int64 on the host, computed from
    the snapshot's src and dst alone (scipy sparse), and the largest
    count at one vertex of the 2- and 3-hop chains."""
    import scipy.sparse as sp
    n = snap.n
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        snap.dst, minlength=n), dtype=np.int64)])
    A = sp.csr_matrix((np.ones(len(snap.src), np.int64), snap.src, indptr),
                      shape=(n, n))
    ones = np.ones(n, np.int64)
    c1 = host_expand(A, ones, "out")
    c2 = host_expand(A, c1, "out")
    c3 = host_expand(A, c2, "out")
    s = np.zeros(n, np.int64)
    np.add.at(s, starts, 1)
    s = (host_expand(A, s, "both") > 0).astype(np.int64)
    s = host_expand(A, s, "both") > 0
    h = np.zeros(n, np.int64)
    h[hub] = 1
    h = host_expand(A, host_expand(A, h, "out"), "out") > 0
    for c in (c1, c2, c3):
        check(c.dtype == np.int64 and (c >= 0).all(),
              "the host reference is not a non-negative int64 count")
    return {"out_out": int(c2.sum()), "repeat3": int(c3.sum()),
            "both_dedup": int(s.sum()),
            "hub_ids": snap.vertex_ids[np.flatnonzero(h)].tolist(),
            "max2": int(c2.max()), "max3": int(c3.max())}


def expand_parts(snap, dev) -> dict:
    """One out() expand from all-ones counts on the store snapshot, by
    CUDA events: the
    gather ``counts[src]`` and the ``index_add_`` into [n] apart, each
    beside the time its bytes take at the card's memory rate (each
    input read once, each output written once); and the same
    ``index_add_`` into seeded uniform targets, which have no hub runs
    (what the atomics' contention at hubs costs)."""
    from titan_tpu_torch.olap.engine import device_graph
    dg = device_graph(snap, dev)
    n, e = snap.n, snap.num_edges
    counts = torch.ones(n, dtype=torch.int64, device=dev)
    contrib = counts.index_select(0, dg.src)
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    gather = cuda_ms(lambda: counts.index_select(0, dg.src), 5)
    scatter = cuda_ms(lambda: out.zero_().index_add_(0, dg.dst, contrib), 5)
    flat = torch.randint(0, n, (e,), dtype=torch.int32, device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED))
    uniform = cuda_ms(lambda: out.zero_().index_add_(0, flat, contrib), 5)
    del flat
    return {"gather_ms": round(gather, 4), "index_add_ms": round(scatter, 4),
            "index_add_uniform_ms": round(uniform, 4),
            "gather_bound_ms": round((4 * e + 8 * n + 8 * e)
                                     / HBM_BYTES_PER_S * 1e3, 4),
            "index_add_bound_ms": round((8 * e + 4 * e + 8 * n)
                                        / HBM_BYTES_PER_S * 1e3, 4)}


def phase_traversal_store(F, S, OC, g, snap, card) -> None:
    """Phase 14a on phase 12's store snapshot (passed explicitly, so
    nothing rescans the store): four chains through
    ``g.traversal().with_computer("gpu", snapshot=snap)``, each compiled
    (``run_compiled``) and equal to the int64 host reference; the 3-hop
    chain's counts pass 2^31 at a vertex. Each chain's first run is
    checked and timed (the first uploads the snapshot's edge arrays)
    while the reference runs in a thread, then ``TRAVERSAL_REPS`` more
    (one for the hub's ids) are timed."""
    from titan_tpu_torch.traversal.dsl import anon
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    live = np.flatnonzero(snap.out_degree > 0)
    starts = rng.choice(live, TRAVERSAL_STARTS, replace=False)
    hub = int(np.argmax(snap.out_degree))
    ref = Background(lambda: store_traversal_refs(snap, starts, hub))
    src = g.traversal().with_computer("gpu", snapshot=snap)
    chains = {
        "out_out": lambda: src.V().out().out().count(),
        "repeat3": lambda: src.V().repeat(anon().out()).times(3).count(),
        "both_dedup": lambda: src.V(*(int(snap.vertex_ids[s])
                                      for s in starts))
        .both().dedup().both().dedup().count(),
        "hub_ids": lambda: src.V(int(snap.vertex_ids[hub])).out().out()
        .dedup().id_(),
    }
    got, times = {}, {}
    F.frontier_round.launches = F.batched_exhaust.launches = 0
    S.seg_scan.launches = 0
    for name, chain in chains.items():
        out, wall, dev_ms = run_compiled(OC, chain())
        got[name] = out if name == "hub_ids" else out[0]
        times[name] = [(round(wall, 4), round(dev_ms, 4))]
    want = ref.result()          # the timed runs with the host otherwise idle
    for name, chain in chains.items():
        # the hub's ids cost seconds of Python a run (a traverser an id)
        for _ in range(1 if name == "hub_ids" else TRAVERSAL_REPS):
            out, wall, dev_ms = run_compiled(OC, chain())
            check((out if name == "hub_ids" else out[0]) == got[name],
                  f"{name}: a repeat run differs")
            times[name].append((round(wall, 4), round(dev_ms, 4)))
    launches = {"frontier_round": F.frontier_round.launches,
                "batched_exhaust": F.batched_exhaust.launches,
                "seg_scan": S.seg_scan.launches}
    for name in chains:
        check(got[name] == want[name], f"{name}: the compiled answer "
              f"{str(got[name])[:80]} differs from the int64 host "
              f"reference {str(want[name])[:80]}")
    check(want["max3"] > (1 << 31) - 1, f"the 3-hop chain's largest "
          f"count {want['max3']} does not pass 2^31")
    for name in chains:
        say(f"phase 14a: s{STORE_SCALE} {name} on {card}: "
            f"{str(got[name]) if name != 'hub_ids' else len(got[name])}"
            f"{' ids' if name == 'hub_ids' else ''} equal to the int64 host "
            f"reference; (wall s, device ms) first then warm: {times[name]}")
    say(f"phase 14a: largest count at one vertex: 2 hops {want['max2']}, "
        f"3 hops {want['max3']} (2^31 = {1 << 31}); kernel launches on the "
        f"traversal path {launches} (its expand is index_add_, no kernel "
        f"of the port)")
    parts = expand_parts(snap, torch.device("cuda"))
    say(f"phase 14a: one out() expand at s{STORE_SCALE} on {card}: "
        + json.dumps(parts))
    say(f"phase 14a: {time.time() - t0:.1f} s")


def property_graph(seed: int):
    """A seeded labelled property graph: ``PROPERTY_VERTICES`` persons and
    places (name, age on persons, score), ``PROPERTY_EDGES`` edges labelled
    knows, likes or visits, in one commit of the port's in-memory graph."""
    import titan_tpu_torch
    g = titan_tpu_torch.open("inmemory")
    rng = np.random.default_rng(seed)
    tx = g.new_transaction()
    vs = []
    for i in range(PROPERTY_VERTICES):
        if i % 5:
            vs.append(tx.add_vertex("person", name=f"p{i}",
                                    age=int(rng.integers(1, 90)),
                                    score=float(rng.random())))
        else:
            vs.append(tx.add_vertex("place", name=f"c{i}"))
    labels = ("knows", "likes", "visits")
    for a, b, k in zip(rng.integers(0, PROPERTY_VERTICES, PROPERTY_EDGES),
                       rng.integers(0, PROPERTY_VERTICES, PROPERTY_EDGES),
                       rng.integers(0, 3, PROPERTY_EDGES)):
        if a != b:
            vs[int(a)].add_edge(labels[int(k)], vs[int(b)])
    tx.commit()
    return g, [v.id for v in vs]


#: tests/test_olap_compile.py's chain shapes, over (source, P, anon, a
#: start id): labels, mid-chain has, values().sum()/mean(),
#: groupCount().by(k), id, vertices, repeat().times()
SMALL_CHAINS = {
    "out_out_count": lambda t, P, A, v: t.V().out().out().count(),
    "labels": lambda t, P, A, v: t.V().in_("likes").out("knows").count(),
    "both": lambda t, P, A, v: t.V().both().count(),
    "dedup": lambda t, P, A, v: t.V().out().out().dedup().count(),
    "ids": lambda t, P, A, v: t.V(v).out().out().id_(),
    "repeat_times": lambda t, P, A, v: t.V().repeat(A().out()).times(3)
    .count(),
    "has_start": lambda t, P, A, v: t.V().has("name", "p1").out().count(),
    "vertices": lambda t, P, A, v: t.V().out("knows").dedup(),
    "vertex_paths": lambda t, P, A, v: t.V().out("visits"),
    "midchain_has": lambda t, P, A, v: t.V().out("knows")
    .has("age", P.gt(40)).out().count(),
    "values_sum": lambda t, P, A, v: t.V().out("knows").values("age")
    .sum_(),
    "values_mean": lambda t, P, A, v: t.V().out().out().values("age")
    .mean(),
    "values": lambda t, P, A, v: t.V().out("visits").values("name"),
    "group_count_by": lambda t, P, A, v: t.V().out().group_count()
    .by("age"),
    "group_count": lambda t, P, A, v: t.V().out("likes").group_count(),
    "ldbc_is3": lambda t, P, A, v: t.V(v).out("knows").out("knows")
    .out("knows").out("knows").count(),
}

#: the gods (titan_tpu_torch/example.py)
GODS_CHAINS = {
    "two_hops": lambda t, P, A, v: t.V().out().out().count(),
    "battled": lambda t, P, A, v: t.V().has("name", "hercules")
    .out("battled").values("name"),
    "brothers": lambda t, P, A, v: t.V().both("brother").dedup().id_(),
    "ages": lambda t, P, A, v: t.V().out("father").values("age").sum_(),
    "lives": lambda t, P, A, v: t.V().in_("lives").group_count()
    .by("name"),
}


def canonical(x):
    """A traversal output with vertices by id, in a sortable form (equal
    values compare equal: a compiled sum is a float, the interpreter's
    an int)."""
    if type(x).__name__ in ("Vertex", "Edge"):
        return ("element", x.id)
    if isinstance(x, dict):
        return sorted((repr(k), v) for k, v in x.items())
    return x


def phase_traversal_small(OC, card) -> None:
    """Phase 14b on the card: every chain shape of
    tests/test_olap_compile.py on the graph of the gods and a seeded
    labelled property graph, compiled on CUDA (``run_compiled``) and
    equal to the port's interpreter; K_50's 6-hop count equal to the
    interpreter's and to 50 * 49^6 (past 2^31 at every vertex)."""
    import titan_tpu_torch
    from titan_tpu_torch import example
    from titan_tpu_torch.query.predicates import P
    from titan_tpu_torch.traversal.dsl import anon
    t0 = time.time()
    graphs = []
    gods = titan_tpu_torch.open("inmemory")
    example.load(gods)
    graphs.append(("gods", gods, GODS_CHAINS,
                   min(v.id for v in gods.traversal().V().to_list())))
    pg, vids = property_graph(SEED)
    graphs.append(("property", pg, SMALL_CHAINS, vids[1]))
    try:
        ran = 0
        for what, g, chains, v in graphs:
            dev = g.traversal().with_computer("gpu")
            for name, chain in chains.items():
                got, _, _ = run_compiled(OC, chain(dev, P, anon, v))
                want = chain(g.traversal(), P, anon, v).to_list()
                g.rollback()
                check(sorted(map(canonical, got), key=repr)
                      == sorted(map(canonical, want), key=repr),
                      f"{what} {name}: compiled {str(got)[:80]} differs from "
                      f"the interpreter's {str(want)[:80]}")
                ran += 1
        k50 = titan_tpu_torch.open("inmemory")
        graphs.append(("k50", k50, None, None))
        tx = k50.new_transaction()
        vs = [tx.add_vertex("node") for _ in range(50)]
        for a in vs:
            for b in vs:
                if a is not b:
                    a.add_edge("link", b)
        tx.commit()
        def six(t):
            return t.V().repeat(anon().out()).times(6).count()
        got, _, _ = run_compiled(OC, six(k50.traversal().with_computer("gpu")))
        want = six(k50.traversal()).to_list()
        check(got == want == [50 * 49 ** 6], f"K_50 at 6 hops: compiled "
              f"{got}, interpreter {want}, exact {50 * 49 ** 6}")
        say(f"phase 14b: {ran} chains on the gods and a {PROPERTY_VERTICES}-"
            f"vertex labelled property graph compiled on {card}, each equal "
            f"to the interpreter; K_50 at 6 hops {got[0]} = 50 * 49^6 on "
            f"the card and in the interpreter; {time.time() - t0:.1f} s")
    finally:
        for _, g, _, _ in graphs:
            g.close()


# ---- phase 15: the front door on the store graph, over HTTP

#: the HTTP lane burst's fuse window: the batch closes when its 16th
#: request arrives, so a wide window costs nothing once all are in
HTTP_WINDOW_S = 0.5
#: the interpreter's start: a seeded vertex of at most this degree whose
#: out-neighbours have at most INTERP_MAX_NBR_DEG each
INTERP_MAX_DEG = 8
INTERP_MAX_NBR_DEG = 64

_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*")*\})? '
    r"([+-]?\d+\.?\d*(?:[eE][+-]?\d+)?)$")


def parse_exposition(text: str) -> dict:
    """Prometheus text 0.0.4 as ``{sample with its labels: value}``;
    fails on any line outside the grammar."""
    out = {}
    check(text.endswith("\n"), "the exposition does not end in a newline")
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            check(len(ln.split()) == 4 and ln.split()[3] in (
                "counter", "gauge", "summary"), f"bad TYPE line {ln!r}")
        elif ln.startswith("# HELP ") or not ln:
            continue
        else:
            m = _SAMPLE.match(ln)
            check(m is not None, f"not an exposition 0.0.4 sample: {ln!r}")
            out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def http_final(url: str, jid: str, wait_s: float = 300.0) -> dict:
    """``GET /jobs/<id>`` until the job is terminal."""
    from titan_tpu_torch.utils.httpnode import text_get
    t_end = time.time() + wait_s
    while True:
        w = json.loads(text_get(url, f"/jobs/{jid}"))
        if w["status"] not in ("queued", "running", "retrying"):
            return w
        check(time.time() < t_end, f"job {jid} still {w['status']} after "
              f"{wait_s} s")
        time.sleep(0.002)


def interp_start(snap, edges) -> tuple[int, int]:
    """A seeded low-degree start for the interpreter and its
    ``out().out().dedup().count()``. The bulk loader writes one OUT entry
    an edge, as the reference does, so the interpreter sees the loaded
    edges' directions, which the symmetric snapshot has lost: the count
    comes from the generated ``edges`` (src, dst). A start qualifies when
    its row and its out-neighbours' rows are the load's alone: each one's
    neighbours in the snapshot equal its out- and in-edges among
    ``edges`` (the freshness commit touched none of them)."""
    src, dst = edges
    deg = snap.out_degree
    ip, ssrc = snap.indptr_in, snap.src
    rng = np.random.default_rng(SEED)
    cand = np.flatnonzero((deg > 0) & (deg <= INTERP_MAX_DEG))
    for v in rng.permutation(cand)[:64].tolist():
        outs = dst[src == v]
        if not outs.size or deg[outs].max() > INTERP_MAX_NBR_DEG:
            continue
        if all(np.array_equal(np.sort(ssrc[ip[w]:ip[w + 1]]), np.sort(
                np.concatenate([dst[src == w], src[dst == w]])))
               for w in np.unique(np.append(outs, v)).tolist()):
            return int(v), int(np.unique(dst[np.isin(src, outs)]).size)
    raise AssertionError("no low-degree start whose 2-hop rows the load "
                         "alone wrote")


def http_status(url: str, path: str, data: bytes | None = None) -> int:
    """The HTTP status of one request (a body POSTs it)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url + path, data=data, method="POST"
                                 if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def phase_server_store(F, P, g, snap, card, runs, phase10) -> None:
    """Phase 15 on phase 12's refreshed store snapshot and its graph:
    ``GraphServer(graph, scheduler=JobScheduler(snapshot=snap,
    device="cuda"))`` on port 0, device profiling on, every request
    through a socket (``utils/httpnode``). ``runs`` counts the served
    launches; the direct reference calls run outside it; ``phase10``
    holds phase 10's served and direct walls, printed beside this
    phase's."""
    from titan_tpu_torch import native
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap.engine import GPUGraphComputer
    from titan_tpu_torch.olap.serving import JobScheduler
    from titan_tpu_torch.server import GraphServer
    from titan_tpu_torch.utils.httpnode import json_call, text_get
    from titan_tpu_torch.utils.metrics import MetricManager, nearest_rank

    t_phase = time.time()
    dev = torch.device("cuda")
    n, vids = snap.n, snap.vertex_ids
    srcs = sample_sources(snap.out_degree, BATCH_K)
    probe = int(vids[srcs[-1]])
    sched = JobScheduler(snapshot=snap, device="cuda", autostart=False,
                         max_batch=BATCH_K, metrics=MetricManager(),
                         interactive_window_s=HTTP_WINDOW_S,
                         interactive_max_fuse=BATCH_K)
    server = GraphServer(g, port=0, scheduler=sched).start()
    url = f"http://{server.host}:{server.port}"
    walls: dict = {}

    def timed(kind, fn):
        t = time.time()
        out = fn()
        walls.setdefault(kind, []).append(round((time.time() - t) * 1e3, 3))
        return out

    outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
    inv = np.where(snap.out_degree > 0, 1.0 / outdeg,
                   0.0).astype(np.float32)      # models/pagerank.run's
    lane_q = [{"start": [int(vids[x])], "dir": "both", "hops": 2,
               "terminal": "count"} for x in srcs]
    # the loaded edges, as phase 12 generated them
    edges = native.rmat_gen((1 << STORE_SCALE) * EDGE_FACTOR, STORE_SCALE,
                            seed=SEED)
    v0, want_i = interp_start(snap, edges)
    del edges
    setup_s = time.time() - t_phase
    script = f"g.V({int(vids[v0])}).out().out().dedup().count()"

    def burst():
        # no collection inside a burst: a full one over the store's
        # heap takes seconds, longer than the fuse window
        gc.disable()
        try:
            return fire()
        finally:
            gc.enable()

    def fire():
        out = [None] * BATCH_K
        gate = threading.Barrier(BATCH_K)

        def go(i):
            gate.wait()
            t = time.time()
            try:
                out[i] = (json_call(url, "/traverse", lane_q[i],
                                    timeout=300), (time.time() - t) * 1e3)
            except Exception as e:       # re-raised below, in order
                out[i] = (e, None)
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(BATCH_K)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
            check(not t.is_alive(), "a /traverse request did not return")
        for res, _ in out:
            if isinstance(res, Exception):
                raise res
        return out

    def main_path():
        # ---- the K = 16 BFS cohort: 16 POSTs to a paused scheduler
        t0 = time.time()
        subs = [timed("POST /jobs", lambda s=s: json_call(url, "/jobs", {
            "kind": "bfs", "source": int(vids[s]), "targets": [probe]}))
            for s in srcs]
        sched.start()
        finals = [timed("GET /jobs/<id> to done",
                        lambda w=w: http_final(url, w["job"]))
                  for w in subs]
        cohort_s = time.time() - t0
        occ = sched._metrics.histogram("serving.batch.occupancy").to_dict()
        # ---- one dense PageRank job, 20 supersteps: its program is an
        # object, which JSON cannot carry, so it enters through
        # submit_job, the seam POST /jobs itself calls, and is polled
        # over HTTP
        t1 = time.time()
        dj = server.submit_job({"kind": "dense", "params": {
            "program": MP.PageRank(0.85, 20, 0.0), "n": n,
            "inv_outdeg": inv}})
        dense = timed("GET /jobs/<id> to done",
                      lambda: http_final(url, dj.id))
        dense_s = time.time() - t1
        # ---- a burst of 16 2-hop both() counts on the fresh lane
        first = burst()
        warm = burst()
        glane = timed("POST /traverse gremlin", lambda: json_call(
            url, "/traverse", {"gremlin": f"g.V({probe}).both().both()"
                                          f".dedup().count()"}))
        interp = timed("POST /traversal", lambda: json_call(
            url, "/traversal", {"gremlin": script}))
        return (subs, finals, cohort_s, occ, dj, dense, dense_s, first,
                warm, glane, interp)

    try:
        t_path = time.time()
        (subs, finals, cohort_s, occ, dj, dense, dense_s, first, warm,
         glane, interp) = runs.run(main_path)
        path_s = time.time() - t_path
        for kind, out in (("POST /traverse burst", first),
                          ("POST /traverse burst, warm", warm)):
            walls[kind] = [round(ms, 3) for _, ms in out]
        # ---- the cohort against the direct batched BFS
        check(all(w["status"] == "queued" for w in subs),
              f"submits {[w['status'] for w in subs]}")
        check((occ["count"], occ["max"]) == (1, float(BATCH_K)), f"occupancy "
              f"{occ}: the 16 HTTP submits are not one batch")
        (dist, levels, _), direct_s = wall_s(lambda: P.frontier_bfs_batched(
            snap, srcs, device=dev))
        pd = snap.dense_of(probe)
        for i, (s, w) in enumerate(zip(srcs, finals)):
            r = w["result"]
            want_t = int(dist[i][pd])
            check(w["status"] == "done" and w["batch_k"] == BATCH_K
                  and r["reached"] == int((dist[i] < (1 << 30)).sum())
                  and r["levels"] == int(levels[i])
                  and r["targets"] == {str(probe): want_t
                                       if want_t < (1 << 30) else None},
                  f"BFS from {s} over HTTP: {w}")
            check(np.array_equal(sched.get(w["job"]).result["dist"],
                                 dist[i]), f"served BFS row from {s} "
                  f"differs from frontier_bfs_batched")
        # ---- the dense job against GPUGraphComputer.run
        ref = MP.run(GPUGraphComputer(snapshot=snap, device=dev), 0.85, 20,
                     0.0)
        check(dense["status"] == "done"
              and dense["result"]["iterations"] == 20
              and np.array_equal(dj.result["rank"], ref["rank"]),
              f"dense PageRank over HTTP is not bit-equal to "
              f"GPUGraphComputer.run: {dense}")
        # ---- the lane
        csr = P.build_chunked_csr(snap, dev)
        want = {x: int(hop_sets(csr, x, 2)[1].sum()) for x in srcs}
        for what, out in (("first", first), ("warm", warm)):
            res = [r for r, _ in out]
            check({(r["fused_k"], r["batch"]) for r in res} == {
                (BATCH_K, res[0]["batch"])} and not any(
                    r["fallback"] for r in res), f"the {what} burst is not "
                  f"one batch of {BATCH_K}: "
                  f"{[(r['batch'], r['fused_k']) for r in res]}")
            for x, r in zip(srcs, res):
                check(r["result"] == want[x], f"/traverse count of {x}: "
                      f"{r['result']}, expand_once {want[x]}")
        check(glane["fallback"] is False
              and glane["result"] == want[srcs[-1]], f"gremlin through "
              f"the lane: {glane}, expand_once {want[srcs[-1]]}")
        check(interp["result"] == [want_i], f"the interpreter's "
              f"{script}: {interp['result']}, the loaded edges' {want_i}")
        # ---- the observation endpoints
        for path in ("/healthz", "/jobs", "/tenants", "/live", "/slo",
                     "/controller", f"/trace?job={subs[0]['job']}",
                     "/status", "/schema"):
            body = timed("GET " + path.split("?")[0],
                         lambda p=path: json.loads(text_get(url, p)))
            check(isinstance(body, dict), f"{path}: {body}")
            if path == "/healthz":
                check(body["ready"] is True, f"/healthz {body}")
            if path == "/live":
                check(body == {"enabled": False}, f"/live {body}")
        text = timed("GET /metrics", lambda: text_get(url, "/metrics"))
        samples = parse_exposition(text)
        ran = len(finals) + 1
        check(samples.get("serving_jobs_completed") == ran,
              f"serving_jobs_completed "
              f"{samples.get('serving_jobs_completed')}, jobs run {ran}")
        kern = {k: (samples.get(f'device_exec_calls{{kernel="{k}"}}'),
                    samples.get(f'device_exec_ms_count{{kernel="{k}"}}'))
                for k in ("frontier_round", "batched_exhaust", "seg_scan")}
        check(all(c and t for c, t in kern.values()), f"/metrics "
              f"device.exec children (calls, timed) {kern}")
        bad = http_status(url, "/jobs", b"{not json")
        unknown = http_status(url, "/jobs/job-nope")
        check(bad == 400 and unknown == 404, f"a bad body got {bad}, an "
              f"unknown job {unknown}")
    finally:
        server.stop()           # closes the scheduler
    lat = {k: {"n": len(v), "p50_ms": nearest_rank(v, 0.5),
               "max_ms": max(v)} for k, v in walls.items()}
    say(f"phase 15: GraphServer on {card} at s{STORE_SCALE}: {BATCH_K} BFS "
        f"jobs POSTed to a paused scheduler ran as one batch of {BATCH_K}, "
        f"every row bit-equal to frontier_bfs_batched and reached, levels "
        f"and the target equal over the wire; the K={BATCH_K} batch "
        f"{cohort_s:.4f} s from the first POST to the last GET done "
        f"(frontier_bfs_batched called directly {direct_s:.4f} s; phase "
        f"10 on {card}: served {phase10['served_s']:.4f} s, direct "
        f"{phase10['direct_s']:.4f} s); dense PageRank (20 supersteps) "
        f"{dense_s:.4f} s submit to GET done, bit-equal to "
        f"GPUGraphComputer.run; two bursts of {BATCH_K} /traverse 2-hop "
        f"both() counts from {BATCH_K} threads, each one batch of "
        f"{BATCH_K}, every count equal to expand_once; a gremlin chain "
        f"through the lane (compiled) and the interpreter's {script} "
        f"({want_i}) equal to the loaded edges'; /metrics parses as 0.0.4 "
        f"with serving_jobs_completed {ran} and device.exec counts {kern}; "
        f"a bad body 400, an unknown job 404; {time.time() - t_phase:.1f} s "
        f"(set-up {setup_s:.1f} s: the loaded edges and the interpreter's "
        f"start; the served path {path_s:.1f} s)")
    say("phase 15: request walls by kind (ms) " + json.dumps(lat))


# ---- phase 16: the replica fleet at bench.py's fleet_stage shape

#: bench.py's fleet_stage graph (bench.py:1377-1506)
FLEET_N, FLEET_M, FLEET_SEED = 192, 900, 42
FLEET_WAIT_S = 120.0


def fleet_drive(router, jids, wait_s: float = FLEET_WAIT_S) -> list:
    """Pump the router until every job is terminal; their wire bodies."""
    from titan_tpu_torch.utils.httpnode import text_get
    t_end = time.time() + wait_s
    while True:
        router.pump()
        ws = [json.loads(text_get(router.url, f"/jobs/{j}")) for j in jids]
        if all(w["state"] in ("done", "failed", "timeout", "cancelled",
                              "expired") for w in ws):
            return ws
        check(time.time() < t_end, f"the fleet stream stalled: "
              f"{[w['state'] for w in ws]}")
        time.sleep(0.01)


def phase_fleet(card, runs, after=None) -> None:
    """Phase 16: bench.py's fleet_stage on the card. One storage node (the
    port's ``KCVSServer`` over an in-memory store, mounted as bench.py
    mounts it, ``storage.backend: remote-cluster`` with the node as the
    ring's one host) holds the n = 192, 900-edge graph of seed 42; two
    replicas from ``olap/fleet/replica.build`` (GraphServer + JobScheduler
    on CUDA each) behind a ``FleetRouter`` take a stream of 4 BFS, 4 SSSP
    and 4 WCC jobs, each result equal to the direct call on a snapshot of
    the same graph; then one failover. ``runs`` counts the served
    launches; ``after(cfg)`` runs on the same storage before it stops."""
    import shutil

    import titan_tpu_torch
    from titan_tpu_torch.models.bfs_hybrid import frontier_bfs_batched
    from titan_tpu_torch.models.frontier import frontier_sssp, frontier_wcc
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.olap.fleet import FleetRouter
    from titan_tpu_torch.olap.fleet.replica import build
    from titan_tpu_torch.storage.inmemory import InMemoryStoreManager
    from titan_tpu_torch.storage.remote import KCVSServer
    from titan_tpu_torch.utils.httpnode import json_call, text_get
    from titan_tpu_torch.utils.metrics import MetricManager

    t_phase = time.time()
    dev = torch.device("cuda")
    ck = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      ".bench_cache", "fleet_checkpoints")
    shutil.rmtree(ck, ignore_errors=True)
    # bench.py:1398-1399: remote-cluster over this one node
    storage = KCVSServer(InMemoryStoreManager()).start()
    cfg = {"storage.backend": "remote-cluster",
           "storage.hostname": [f"127.0.0.1:{storage.port}"]}
    reps, routers = [], []
    try:
        loader = titan_tpu_torch.open(dict(cfg))
        try:
            tx = loader.new_transaction()
            vs = [tx.add_vertex("node", name=f"v{i}")
                  for i in range(FLEET_N)]
            rng = np.random.default_rng(FLEET_SEED)
            for _ in range(FLEET_M):
                a, b = rng.integers(0, FLEET_N, 2)
                tx.add_edge(vs[int(a)], "link", vs[int(b)])
            tx.commit()
            ids = [v.id for v in vs]
            snap = SN.build(loader, directed=False)
        finally:
            loader.close()
        load_s = time.time() - t_phase
        for i in range(2):
            reps.append(build({"graph": cfg, "checkpoint_dir": ck}))
            reps[-1][2].start()
        mm = MetricManager()
        router = FleetRouter(metrics=mm, autotune="shadow", autopump=False)
        routers.append(router)
        insts = {}
        for i, (_, sch, srv) in enumerate(reps):
            check(sch.device.type == "cuda", f"replica {i} on {sch.device}")
            inst = router.add_replica(f"http://{srv.host}:{srv.port}",
                                      instance=f"replica-{i}")
            insts[inst] = sch
        router.start()
        bfs_k, sssp_k = (0, 3, 7, 11), (1, 5, 9, 13)
        stream = ([{"kind": "bfs", "source": ids[k]} for k in bfs_k]
                  + [{"kind": "sssp", "source": ids[k]} for k in sssp_k]
                  + [{"kind": "wcc"} for _ in range(4)])

        def run_stream():
            t0 = time.time()
            jids = [json_call(router.url, "/jobs", b)["job"] for b in stream]
            return fleet_drive(router, jids), time.time() - t0
        finals, stream_s = runs.run(run_stream)
        check(all(w["state"] == "done" for w in finals), "fleet stream: "
              + str([(w["state"], w["remote"].get("error")) for w in finals]))

        def served(w):
            return insts[w["replica"]].get(w["remote_job"]).result
        dense = [snap.dense_of(ids[k]) for k in bfs_k]
        dist, levels, _ = frontier_bfs_batched(snap, dense, device=dev)
        for i, w in enumerate(finals[:4]):
            check(np.array_equal(served(w)["dist"], dist[i])
                  and w["remote"]["result"]["levels"] == int(levels[i]),
                  f"fleet BFS from {ids[bfs_k[i]]} differs from "
                  f"frontier_bfs_batched")
        for k, w in zip(sssp_k, finals[4:8]):
            d, r = frontier_sssp(snap, snap.dense_of(ids[k]), device=dev)
            got = served(w)
            check(np.array_equal(got["dist"].view(np.int32),
                                 d.view(np.int32)) and got["rounds"] == r,
                  f"fleet SSSP from {ids[k]} differs from frontier_sssp")
        lab, wr = frontier_wcc(snap, device=dev)
        for w in finals[8:]:
            got = served(w)
            check(np.array_equal(got["labels"], lab)
                  and got["rounds"] == wr, "fleet WCC differs from "
                  "frontier_wcc")
        routed = {inst: int(mm.counter_value(
            "serving.fleet.routed", labels={"instance": inst}))
            for inst in insts}
        check(sum(routed.values()) == len(stream)
              and mm.counter_value("serving.jobs.submitted") == len(stream),
              f"routed {routed}, submitted "
              f"{mm.counter_value('serving.jobs.submitted')}")
        fed = text_get(router.url, "/metrics?federate=1")
        samples = parse_exposition(fed)
        fl = json.loads(text_get(router.url, "/fleet"))
        check(any('instance="replica-0"' in k for k in samples)
              and any('instance="replica-1"' in k for k in samples)
              and fl["up"] == 2, f"federation: /fleet up {fl['up']}")
        router.stop()
        for g_, sch, srv in reps:
            srv.stop()              # closes the scheduler
            g_.close()
        reps.clear()

        # ---- failover: the victim's scheduler never starts
        for name, kw in (("a-victim", {"autostart": False}),
                         ("b-survivor", {})):
            reps.append(build({"graph": cfg, "checkpoint_dir": ck,
                               "scheduler": kw}))
            reps[-1][2].start()
        m2 = MetricManager()
        router2 = FleetRouter(metrics=m2, autotune="off", autopump=False)
        routers.append(router2)
        for name, (_, _, srv) in zip(("a-victim", "b-survivor"), reps):
            router2.add_replica(f"http://{srv.host}:{srv.port}",
                                instance=name)
        router2.start()

        def failover():
            out = json_call(router2.url, "/jobs", {
                "kind": "bfs", "source": ids[0], "checkpoint_every": 1,
                "targets": [ids[-1]]})
            check(out["replica"] == "a-victim", f"first pick {out}")
            router2.pump()
            reps[0][2].stop()
            return fleet_drive(router2, [out["job"]])[0]
        w = runs.run(failover)
        got = reps[1][1].get(w["remote_job"]).result
        lat = m2.histogram_stats("serving.fleet.redispatch_latency_ms")
        check(w["state"] == "done" and w["replica"] == "b-survivor"
              and w["attempts"] == 2
              and m2.counter_value("serving.fleet.redispatches") == 1
              and m2.counter_value("serving.jobs.submitted") == 1
              and np.array_equal(got["dist"], dist[0]),
              f"failover: {w}")
        say(f"phase 16: fleet on {card} (bench.py's fleet_stage shape: "
            f"n={FLEET_N}, {FLEET_M} edges, seed {FLEET_SEED}, remote-cluster "
            f"over one storage node, loaded and snapshotted in "
            f"{load_s:.1f} s): "
            f"4 BFS, 4 SSSP and 4 WCC through the router in "
            f"{stream_s:.4f} s, each equal to the direct call on the "
            f"card; routed per replica {routed}; /metrics?federate=1 "
            f"carries both instances and /fleet shows {fl['up']} up; "
            f"failover: the job finished on b-survivor on attempt 2, one "
            f"redispatch, equal to the direct BFS, redispatch latency "
            f"{lat['max']:.3f} ms; {time.time() - t_phase:.1f} s")
        if after is not None:
            after(cfg)
    finally:
        for r in routers:
            r.stop()
        for g_, sch, srv in reps:
            srv.stop()
            g_.close()
        storage.stop()
        shutil.rmtree(ck, ignore_errors=True)

# ---- phase 17: the scan cluster and mixed indexes (host code), at
# bench.py's distributed_scan_stage shape

#: bench.py's distributed_scan_stage graph (bench.py:1303-1375)
SCAN_N = 64
#: phase 17c's graph query, its mixed cover, and its index query
MIXED_PREFIX, MIXED_TOKEN = "b1", "b7"


def degree_program():
    """In-degree by messages (``tests/test_olap.py``'s program): each vertex
    sends 1 along every out-edge, then sums what it received."""
    from titan_tpu_torch.olap.api import VertexProgram

    class Degree(VertexProgram):
        def execute(self, vertex, messenger, memory):
            if memory.iteration == 0:
                messenger.send(1, [n.id for n in vertex.out()])
            else:
                vertex.set_state("indeg", sum(messenger.receive()))

        def terminate(self, memory):
            return memory.iteration >= 1

        def combiner(self):
            return lambda a, b: a + b
    return Degree()


def phase_host_computer(cfg, card, runs) -> dict:
    """Phase 17d, on phase 16's fleet graph before its storage stops:
    ``compute(backend="host")`` runs the in-degree ``VertexProgram``
    through a ``JobScheduler`` on the card (``run_async``, kind
    ``callable``) beside a ``dense`` PageRank job on the graph's
    snapshot; the degrees equal the directed snapshot's, counted on the
    card, and the PageRank is bit-equal to ``GPUGraphComputer.run``.
    ``runs`` counts the scheduler's launches."""
    import titan_tpu_torch
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.olap.api import JobSpec
    from titan_tpu_torch.olap.computer import HostGraphComputer
    from titan_tpu_torch.olap.serving import JobScheduler

    t0 = time.time()
    dev = torch.device("cuda")
    g = titan_tpu_torch.open(dict(cfg))
    sched = None
    try:
        comp = g.compute(backend="host")
        check(isinstance(comp, HostGraphComputer), f"compute('host') gave "
              f"{type(comp).__name__}")
        dsnap = SN.build(g, directed=True)
        usnap = SN.build(g, directed=False)
        inv = np.where(usnap.out_degree > 0, 1.0 / np.maximum(
            usnap.out_degree, 1), 0.0).astype(np.float32)
        sched = JobScheduler(snapshot=usnap, autostart=False)

        def both():
            with sched._cv:
                host = comp.run_async(degree_program(), sched)
                dense = sched.submit(JobSpec(kind="dense", params={
                    "program": MP.PageRank(0.85, 20, 0.0), "n": usnap.n,
                    "inv_outdeg": inv}))
            sched.start()
            for j in (host, dense):
                check(j.wait(120.0), f"{j} did not finish in 120 s")
            return host, dense
        (host, dense), served_s = wall_s(lambda: runs.run(both))
        check(host.state.value == "done" and dense.state.value == "done",
              f"host job {host.state.value} {host.error}, dense job "
              f"{dense.state.value} {dense.error}")
        res = host.result["value"]
        got = np.array([res.state_of(int(v)).get("indeg", 0)
                        for v in dsnap.vertex_ids], dtype=np.int64)
        want = torch.bincount(torch.as_tensor(dsnap.dst, device=dev),
                              minlength=dsnap.n).cpu().numpy()
        check(res.iterations == 2 and np.array_equal(got, want),
              f"host in-degrees differ from the snapshot's on the card at "
              f"{int(np.sum(got != want))} vertices")
        direct = MP.run(E.GPUGraphComputer(snapshot=usnap), 0.85, 20, 0.0,
                        usnap)
        check(dense.result["iterations"] == 20 and np.array_equal(
            dense.result["rank"], direct["rank"]), "the dense PageRank "
            "beside the host computer is not bit-equal to "
            "GPUGraphComputer.run")
    finally:
        if sched is not None:
            sched.close()
        g.close()
    wall = time.time() - t0
    say(f"phase 17d: compute(backend='host') in-degrees of the fleet graph "
        f"({dsnap.n} vertices, {len(dsnap.dst)} directed edges) equal the "
        f"snapshot's counted on {card}; served beside a dense PageRank "
        f"(bit-equal to GPUGraphComputer.run) in {served_s:.4f} s; "
        f"{wall:.2f} s")
    return {"host_computer_s": wall}


def scan_counts(m) -> dict:
    from titan_tpu_torch.olap.jobs import VertexCountJob
    return {"vertices": m.get(VertexCountJob.VERTICES),
            "edges": m.get(VertexCountJob.EDGES)}


def stitched(tree) -> tuple[int, int]:
    """(spans, remote instances) of a stitched scan trace."""
    spans, instances, stack = 0, set(), list(tree["spans"])
    while stack:
        node = stack.pop()
        spans += 1
        attrs = node.get("attrs") or {}
        if attrs.get("remote"):
            instances.add(attrs["instance"])
        stack.extend(node["children"])
    return spans, len(instances)


def mixed_index_round(cfg, workers, backing: str, P) -> dict:
    """One mixed index on ``name`` backed by ``backing``: REGISTER, REINDEX
    over the scan workers, ENABLE; ``index_query`` and a graph query that
    the profiler shows on the mixed cover, each equal to a full scan;
    then DISABLE, so the next backing's index is the cover."""
    import titan_tpu_torch
    from titan_tpu_torch.olap.scan_worker import distributed_reindex_remote
    from titan_tpu_torch.query import profile as QP

    name = f"name_{backing}"
    g = titan_tpu_torch.open(dict(cfg))
    try:
        mgmt = g.management()
        mgmt.build_index(name, "vertex").add_key(
            g.schema.get_by_name("name")).build_mixed_index(backing)
        mgmt.update_index(name, "register")
        mgmt.commit()
    finally:
        g.close()
    m, reindex_s = wall_s(lambda: distributed_reindex_remote(
        [f"127.0.0.1:{w.port}" for w in workers], cfg, name))
    check(m.get("index-entries-added") == SCAN_N, f"REINDEX {name} added "
          f"{m.get('index-entries-added')} != {SCAN_N}")
    g = titan_tpu_torch.open(dict(cfg))
    try:
        g.management().update_index(name, "enable")
        tx = g.new_transaction(read_only=True)
        names = {v.id: v.value("name") for v in tx.vertices()}
        tx.rollback()
        hits, query_s = wall_s(lambda: g.index_query(
            name, f"name:{MIXED_TOKEN}"))
        check({v.id for v, _ in hits}
              == {i for i, s in names.items() if s == MIXED_TOKEN},
              f"index_query on {name}: {[v.id for v, _ in hits]}")
        pred = P.text_prefix(MIXED_PREFIX)
        root = QP.QueryProfiler()
        tx = g.new_transaction(read_only=True)
        got = {v.id for v in tx.query().has("name", pred)
               .with_profiler(root).vertices()}
        tx.rollback()
        want = {i for i, s in names.items() if s is not None and pred(s)}
        kids = root.to_dict()["children"]
        check([c["name"] for c in kids] == [QP.OPTIMIZATION,
                                            QP.BACKEND_QUERY]
              and kids[0]["annotations"].get("indexed") is True
              and kids[1]["annotations"].get("hits") == len(want)
              and got == want and len(want) == 11,
              f"graph query on {name}: profile {kids}, {len(got)} of "
              f"{len(want)}")
        g.management().update_index(name, "disable")
    finally:
        g.close()
    return {"reindex_s": reindex_s, "index_query_s": query_s}


def phase_scan_cluster(card) -> dict:
    """Phase 17a-c: bench.py's distributed_scan_stage (two storage nodes
    at replication factor 2, n = 64 persons, two HTTP scan workers with
    trace propagation), held to ``InProcessSplitRunner`` and
    ``StandardScanner``; ``DistributedScanRunner`` over a sqlite graph in
    two spawned processes while this process holds the CUDA context; a
    mixed index on ``name`` over ``memindex``, ``lucene`` (FTS5) and one
    ``IndexServer`` (``remote-index``), each reindexed over the workers."""
    import shutil

    import titan_tpu_torch
    from titan_tpu_torch.indexing.memindex import MemoryIndex
    from titan_tpu_torch.indexing.remote import IndexServer
    from titan_tpu_torch.obs.tracing import Tracer
    from titan_tpu_torch.olap.distributed import (DistributedScanRunner,
                                                  InProcessSplitRunner,
                                                  ScanJobSpec)
    from titan_tpu_torch.olap.jobs import VertexCountJob
    from titan_tpu_torch.olap.scan_worker import (RemoteScanRunner,
                                                  ScanWorkerServer)
    from titan_tpu_torch.query.predicates import P
    from titan_tpu_torch.storage.inmemory import InMemoryStoreManager
    from titan_tpu_torch.storage.remote import KCVSServer
    from titan_tpu_torch.storage.scan import StandardScanner
    from titan_tpu_torch.utils.metrics import MetricManager

    walls = {}
    t_phase = time.time()
    spec = ScanJobSpec("titan_tpu_torch.olap.jobs:make_vertex_count_job")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "scan_cluster")
    shutil.rmtree(root, ignore_errors=True)
    storage = [KCVSServer(InMemoryStoreManager()).start() for _ in range(2)]
    workers = [ScanWorkerServer().start() for _ in range(2)]
    node = IndexServer(MemoryIndex("node")).start()
    try:
        cfg = {"storage.backend": "remote-cluster",
               "storage.hostname": [f"127.0.0.1:{s.port}" for s in storage],
               "storage.cluster.replication-factor": 2}

        def load(c):
            g = titan_tpu_torch.open(dict(c))
            try:
                tx = g.new_transaction()
                for i in range(SCAN_N):
                    tx.add_vertex("person", name=f"b{i}")
                tx.commit()
            finally:
                g.close()
        _, walls["load_s"] = wall_s(lambda: load(cfg))

        # ---- (a) bench.py's stage: the scan over HTTP workers, traced
        mm, tracer = MetricManager(), Tracer()
        runner = RemoteScanRunner([f"127.0.0.1:{w.port}" for w in workers],
                                  cfg, metrics=mm, tracer=tracer,
                                  trace_id="bench-scan")
        got, walls["remote_scan_s"] = wall_s(lambda: runner.run(spec))
        remote = scan_counts(got)
        tree = tracer.tree("bench-scan")
        check(tree is not None, "no stitched trace for bench-scan")
        spans, instances = stitched(tree)
        ingest = int(mm.counter_value("obs.ingest.spans"))
        dropped = int(mm.counter_value("obs.ingest.dropped"))
        g = titan_tpu_torch.open(dict(cfg))
        try:
            inproc, walls["in_process_s"] = wall_s(lambda: scan_counts(
                InProcessSplitRunner(g, num_workers=2).run(spec)))
            b = g.backend
            full, walls["scanner_s"] = wall_s(lambda: scan_counts(
                StandardScanner(b.edge_store.store, b.manager).execute(
                    VertexCountJob(g), graph=g)))
        finally:
            g.close()
        check(remote["vertices"] == SCAN_N and remote == inproc == full,
              f"scan counts: remote {remote}, in-process {inproc}, "
              f"scanner {full}")
        check(len(tree["spans"]) == 2 * len(workers) and spans
              == 4 * len(tree["spans"]) and ingest == spans
              - len(tree["spans"]) and dropped == 0,
              f"stitched trace: {len(tree['spans'])} coordinator splits, "
              f"{spans} spans, ingest {ingest}, dropped {dropped}")
        say(f"phase 17a: distributed_scan_stage on the host beside {card}: "
            f"{remote['vertices']} vertices over {len(workers)} HTTP scan "
            f"workers (remote-cluster, 2 nodes, replication 2), equal to "
            f"InProcessSplitRunner and StandardScanner; stitched trace: "
            f"{len(tree['spans'])} coordinator splits, {spans} spans, "
            f"{instances} remote instances, ingest {ingest} spans, "
            f"{dropped} dropped")

        # ---- (b) split processes (spawn) over sqlite, CUDA held here
        check(torch.cuda.is_initialized(), "the coordinator holds no CUDA "
              "context")
        scfg = {"storage.backend": "sqlite",
                "storage.directory": os.path.join(root, "sqlite")}
        load(scfg)
        dist, walls["spawned_s"] = wall_s(lambda: scan_counts(
            DistributedScanRunner(scfg, num_workers=2).run(spec)))
        g = titan_tpu_torch.open(dict(scfg))
        try:
            local = scan_counts(InProcessSplitRunner(g, num_workers=2)
                                .run(spec))
        finally:
            g.close()
        check(dist == local == remote, f"spawned splits {dist}, "
              f"in-process {local}, phase 17a {remote}")
        say(f"phase 17b: DistributedScanRunner, 2 spawned processes over "
            f"sqlite while this process holds the CUDA context: {dist}, "
            f"equal to InProcessSplitRunner and to phase 17a")

        # ---- (c) mixed indexes on name, reindexed over the workers; the
        # 64 persons lie in one partition (bench.py's default placement),
        # so one split writes the memindex directory, which keeps only
        # its last writer's snapshot (ROADMAP queue 3, item 14)
        icfg = dict(cfg)
        icfg.update({
            "index.memindex.backend": "memindex",
            "index.memindex.directory": os.path.join(root, "memindex"),
            "index.lucene.backend": "lucene",
            "index.lucene.directory": os.path.join(root, "lucene"),
            "index.node.backend": "remote-index",
            "index.node.hostname": ["127.0.0.1"],
            "index.node.port": node.port})
        for backing in ("memindex", "lucene", "node"):
            r = mixed_index_round(icfg, workers, backing, P)
            walls[f"{backing}_reindex_s"] = r["reindex_s"]
            walls[f"{backing}_index_query_s"] = r["index_query_s"]
        say(f"phase 17c: a mixed index on name over memindex, lucene (FTS5) "
            f"and an IndexServer (remote-index): each REGISTER, REINDEX over "
            f"{len(workers)} scan workers ({SCAN_N} entries), ENABLE; "
            f"index_query 'name:{MIXED_TOKEN}' and has('name', "
            f"textPrefix('{MIXED_PREFIX}')) on the mixed cover equal to a "
            f"full scan")
    finally:
        for n_ in workers + storage + [node]:
            n_.stop()
        shutil.rmtree(root, ignore_errors=True)
    walls["phase_s"] = time.time() - t_phase
    return walls


# ---- phase 8b: the push-frontier BFS (models/bfs.py)

def drop_push_caches(snap) -> None:
    """The push-frontier BFS's device caches on ``snap``."""
    for attr in ("_frontier_csr_by_device", "_tiled_shards_by_device",
                 "_out_degree_by_device"):
        setattr(snap, attr, {})


def push_runs(PB, snap, src: int, want, shard_edges, where: str) -> list:
    """frontier_bfs (when the edges fit int32), frontier_bfs_tiled with its
    defaults, and with ``shard_edges`` a shard; each dist equal to
    ``want`` (numpy); the second run of each is timed (the first uploads
    and caches the out-CSR)."""
    runs = []
    calls = [("frontier_bfs_tiled", {})]
    if snap.num_edges < (1 << 31):
        calls.insert(0, ("frontier_bfs", {}))
    if shard_edges is not None:
        calls.append(("frontier_bfs_tiled", {"max_shard_edges": shard_edges}))
    for name, kw in calls:
        fn = getattr(PB, name)
        fn(snap, src, **kw)
        (dist, levels), t = wall_s(lambda: fn(snap, src, **kw))
        check(np.array_equal(dist, want), f"{where}: {name}({kw}) from {src} "
              f"differs from frontier_bfs_hybrid at "
              f"{int(np.sum(dist != want))} vertices")
        row = {"call": name, **kw, "levels": levels, "wall_s": t}
        if name == "frontier_bfs_tiled":
            (_, (bounds, *_)), = snap._tiled_shards_by_device.values()
            row["shards"] = len(bounds) - 1
        runs.append(row)
    return runs


def phase_push_s22(PB, P, PF, G, ref, card) -> None:
    """Phase 8b on phase 5's s22 snapshot (from_chunked_csr): the push
    BFS, plain and tiled (its defaults, and 2^25 edges a shard: 4 shards
    or more), each equal to frontier_bfs_hybrid from bench.py's first
    source; then the fused kernel against its plain version on the card
    and frontier_bfs_hybrid from the same source."""
    t0 = time.time()
    snap, hg = ref["snap"], ref["hg"]
    g = G.graph_from_numpy(hg, "cuda")
    src = sample_sources(hg["deg"], 1)[0]
    want, lh = P.frontier_bfs_hybrid(g, src, return_device=True)
    runs = push_runs(PB, snap, src, want.cpu().numpy(), 1 << 25,
                     "phase 8b")
    check(runs[-1]["shards"] >= 4, f"max_shard_edges=2^25 gave "
          f"{runs[-1]['shards']} shards")
    drop_push_caches(snap)
    r = check_fused(PF, g, src, f"phase 8b s{ENGINE_SCALE}", want=want)
    del g, want
    torch.cuda.empty_cache()
    say(f"phase 8b: s{ENGINE_SCALE} push-frontier BFS from {src} on {card}, "
        f"each dist equal to frontier_bfs_hybrid's ({lh} levels): "
        + json.dumps(runs) + f"; the fused kernel bit-equal to its plain "
        f"version on the card ({r['levels']} levels, modes {r['modes']}) "
        f"and to frontier_bfs_hybrid; {time.time() - t0:.1f} s")


# ---- phase 18: the OLTP remainder on the card's host

def graph_signature(g) -> tuple:
    """A graph's vertices (label, name, age, score) and edges (label,
    out name, in name), sorted: equal for graphs equal up to their ids."""
    tx = g.new_transaction(read_only=True)
    try:
        vs, es = [], []
        for v in tx.vertices():
            vs.append((v.label(), v.value("name"), v.value("age"),
                       v.value("score")))
            for e in v.out_edges():
                es.append((e.label(), v.value("name"),
                           e.in_vertex().value("name")))
    finally:
        tx.rollback()
    return sorted(vs, key=repr), sorted(es)


def host_bfs(n: int, src, dst, source: int) -> np.ndarray:
    """Level-synchronous BFS over the directed edge arrays, numpy."""
    from titan_tpu_torch.device import INF
    dist = np.full(n, INF, np.int64)
    dist[source] = 0
    frontier, level = np.array([source]), 0
    while frontier.size:
        nxt = np.unique(dst[np.isin(src, frontier)])
        nxt = nxt[dist[nxt] == INF]
        level += 1
        dist[nxt] = level
        frontier = nxt
    return dist


def phase_oltp_remainder(S, card, dev="cuda") -> dict:
    """Phase 18 on the card's host, with phase 14b's 2,000-vertex property
    graph: graphbin and GraphSON written and each read back into a
    ``gdbm`` graph, equal to the source graph; ``graph.compute()``
    PageRank and BFS on the card over the gdbm graph (within
    PAGERANK_RTOL of float64; equal to a host BFS over the edges read
    back), counting its seg_scan launches; a ``metrics.enabled`` gdbm
    graph with a CSV reporter; ``deploy`` start, status and stop of a
    storage node and a scan worker. Returns the walls and launches.
    ``dev`` is where compute() runs."""
    import shutil

    import titan_tpu_torch
    from titan_tpu_torch import deploy
    from titan_tpu_torch import io as tio
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.utils.metrics import MERGED_STORE, MetricManager

    t0 = time.time()
    walls = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "oltp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    fast = {"storage.lock.wait-time": 5, "ids.authority.wait-time": 5}

    def gdbm(name, **extra):
        return titan_tpu_torch.open({"storage.backend": "gdbm",
                                     "storage.directory": os.path.join(
                                         root, name), **fast, **extra})

    pg, _ = property_graph(SEED)
    try:
        want = graph_signature(pg)
        files = {"graphbin": os.path.join(root, "g.bin"),
                 "graphson": os.path.join(root, "g.json")}
        counts, walls["write_graphbin_s"] = wall_s(
            lambda: tio.write_graphbin(pg, files["graphbin"]))
        _, walls["write_graphson_s"] = wall_s(
            lambda: tio.write_graphson(pg, files["graphson"]))
    finally:
        pg.close()
    readers = {"graphbin": tio.read_graphbin, "graphson": tio.read_graphson}
    for fmt, path in files.items():
        g = gdbm(fmt)
        try:
            got, walls[f"read_{fmt}_s"] = wall_s(lambda: readers[fmt](g, path))
            check(got == counts, f"read_{fmt}: {got} against {counts}")
            check(graph_signature(g) == want, f"the gdbm graph read from "
                  f"{fmt} differs from the property graph")
        finally:
            g.close()
    say(f"phase 18: the {counts['vertices']}-vertex property graph "
        f"({counts['edges']} edges) written to graphbin "
        f"({os.path.getsize(files['graphbin'])} B) and GraphSON "
        f"({os.path.getsize(files['graphson'])} B), each read back into a "
        f"gdbm graph equal to it")

    # ---- graph.compute() on the card over the gdbm graph (reopened)
    g = gdbm("graphbin")
    try:
        comp = g.compute(device=dev)
        snap = SN.build(g, directed=False)
        src_vid = int(snap.vertex_ids[int(np.argmax(snap.out_degree))])
        S.seg_scan.launches = 0
        # ---- the gdbm path, with the seg_scan count from 0
        pr = MP.run(comp, 0.85, 20, 0.0, snapshot=snap)
        bfs = MB.run(comp, src_vid, snapshot=snap)
        torch.cuda.synchronize()
        launches = S.seg_scan.launches
        # ---- end of the gdbm path
        f64 = host_pagerank(snap, 0.85, 20)
        rel = float(np.max(np.abs(np.asarray(pr["rank"]) - f64) / f64))
        check(pr.iterations == 20 and rel <= PAGERANK_RTOL,
              f"gdbm PageRank differs from float64 by {rel}")
        tx = g.new_transaction(read_only=True)
        try:
            ends = [(snap.dense_of(v.id), snap.dense_of(e.in_vertex().id))
                    for v in tx.vertices() for e in v.out_edges()]
        finally:
            tx.rollback()
        a = np.array(ends, np.int64).T
        ref = host_bfs(snap.n, np.concatenate([a[0], a[1]]),
                       np.concatenate([a[1], a[0]]), snap.dense_of(src_vid))
        got = np.asarray(bfs["dist"]).astype(np.int64)
        check(np.array_equal(got, ref),
              f"gdbm BFS differs from a host BFS over the edges read back "
              f"at {int(np.sum(got != ref))} vertices")
        check(launches > 0, "compute() over the gdbm graph never launched "
              "seg_scan")
        snap.close()
    finally:
        g.close()
    say(f"phase 18: compute() on {card} over the gdbm graph: PageRank 20 "
        f"supersteps within {rel:.3g} of float64, BFS from its hub equal to "
        f"a host BFS over the edges read back; seg_scan launches {launches}")

    # ---- metrics.enabled with a CSV reporter
    MetricManager.instance().reset()
    csv_dir = os.path.join(root, "csv")
    g = gdbm("metered", **{"metrics.enabled": True,
                           "metrics.csv.interval-s": 0.05,
                           "metrics.csv.directory": csv_dir})
    try:
        tio.read_graphbin(g, files["graphbin"])
        g.traversal().V().out().count().next()
        deadline = time.time() + 10.0
        while not g._reporters[0].reports and time.time() < deadline:
            time.sleep(0.02)
        m = MetricManager.instance()
        calls = {op: m.counter_value(f"titan_tpu.{MERGED_STORE}.{op}.calls")
                 for op in ("getSlice", "getSliceMulti", "mutateMany")}
        commits = m.counter_value("titan_tpu.tx.commit")
    finally:
        g.close()
    rows = open(os.path.join(csv_dir, "metrics.csv")).read().splitlines()
    check(all(calls.values()) and commits > 0 and len(rows) > 1,
          f"metrics.enabled: store calls {calls}, commits {commits}, "
          f"{len(rows)} CSV lines")
    say(f"phase 18: metrics.enabled on a gdbm graph: store calls {calls}, "
        f"{commits} commits, the CSV reporter wrote {len(rows)} lines")

    # ---- deploy: a storage node and a scan worker, spawned and stopped
    dep = os.path.join(root, "deploy.yaml")
    with open(dep, "w") as f:
        f.write(f"services:\n  - kind: storage-node\n    name: store-a\n"
                f"    data-dir: {root}/store-a\n    port: 0\n"
                f"  - kind: scan-worker\n    name: worker-a\n    port: 0\n")
    t1 = time.time()
    check(deploy.start(dep) == 2, "deploy start did not start 2 services")
    try:
        time.sleep(1.0)
        st = deploy.status(dep)
        check(st["store-a"] and st["worker-a"], f"deploy status {st}")
        check(deploy.start(dep) == 0, "a second deploy start spawned again")
    finally:
        stopped = deploy.stop(dep)
    st = deploy.status(dep)
    check(stopped == 2 and st == {"store-a": None, "worker-a": None},
          f"deploy stop {stopped}, status {st}")
    walls["deploy_s"] = time.time() - t1
    shutil.rmtree(root, ignore_errors=True)
    walls["phase_s"] = time.time() - t0
    say(f"phase 18: deploy started, saw and stopped a storage node and a "
        f"scan worker (pidfiles); walls (host clock, s) " + json.dumps(walls))
    check(walls["phase_s"] < 60.0, f"phase 18 took {walls['phase_s']:.1f} s")
    return {"launches": launches, **walls}


#: phase 19c's gloo ranks, sharing the one card
GLOO_RANKS = 2


def mesh_group(backend: str):
    """A world-1 process group in this process over a file rendezvous in
    a fresh temporary directory, and its mesh on ``cuda:0``. Returns
    ``(mesh, tmpdir)``; the caller shuts the group down and removes the
    directory."""
    from titan_tpu_torch.parallel import multihost as M
    from titan_tpu_torch.parallel.mesh import vertex_mesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    M.init(os.path.join(tmp, "rendezvous"), 1, 0, backend, "cuda:0")
    return vertex_mesh(1, "cuda:0", backend), tmp


def pagerank_params(snap) -> dict:
    """``models/pagerank.run``'s params for ``snap``."""
    outdeg = np.maximum(snap.out_degree, 1).astype(np.float32)
    return {"n": snap.n, "inv_outdeg": np.where(
        snap.out_degree > 0, 1.0 / outdeg, 0.0).astype(np.float32)}


def phase_sharded_engine(S, ref, card) -> int:
    """Phase 19a: run_sharded on phase 5's s22 snapshot over a world-1
    NCCL mesh; returns its seg_scan launches."""
    from titan_tpu_torch.models import bfs as MB
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.parallel import multihost as M

    t_phase = time.time()
    snap, src0 = ref["snap"], ref["bfs_source"]
    params = pagerank_params(snap)
    mesh, tmp = mesh_group("nccl")
    try:
        _, pack_s = wall_s(lambda: E.sharded_block(snap, mesh))
        # ---- the main path, with the kernel counts from 0
        S.seg_scan.launches = 0
        _, warm_s = timed(lambda: E.run_sharded(
            MP.PageRank(0.85, 20, 0.0), snap, params, mesh))
        pr, pr_s = timed(lambda: E.run_sharded(
            MP.PageRank(0.85, 20, 0.0), snap, params, mesh))
        for _ in range(2):               # the first run warms its types
            bfs, bfs_s = timed(lambda: E.run_sharded(
                MB.BFS(), snap, {"source_dense": src0}, mesh))
        launches = S.seg_scan.launches
        # ---- end of the main path
    finally:
        M.shutdown()
        snap._sharded_csr_by_mesh.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    check(launches > 0, "run_sharded never launched seg_scan")
    check(pr.iterations == 20, f"PageRank ran {pr.iterations} supersteps")
    rel = float(np.max(np.abs(pr["rank"] - ref["pagerank"])
                       / ref["pagerank"]))
    check(rel <= PAGERANK_RTOL, f"sharded PageRank differs from float64 "
          f"by {rel}")
    check(np.array_equal(bfs["dist"], ref["bfs_dist"]), "the sharded "
          "engine's BFS differs from frontier_bfs_hybrid")
    say(f"phase 19a: s{ENGINE_SCALE} run_sharded over a world-1 NCCL mesh "
        f"on {card}: PageRank 20 supersteps in {pr_s:.4f} s (CUDA events; "
        f"phase 5's run_single {ref['pagerank_s']:.4f} s, ratio "
        f"{pr_s / ref['pagerank_s']:.3f}; the first run {warm_s:.4f} s), "
        f"within {rel:.3g} of float64; BFS from {src0}: {bfs.iterations} "
        f"supersteps in {bfs_s:.4f} s (the second run; phase 5's "
        f"{ref['bfs_s']:.4f} s), dist equal to frontier_bfs_hybrid; "
        f"the rank's block packed and uploaded in {pack_s:.2f} s; seg_scan "
        f"launches {launches}; {time.time() - t_phase:.1f} s")
    return launches


def gloo_rank(mesh, gdir: str, meta: dict, srcs: list, src0: int,
              want: list, push_want: tuple, pr_ref) -> dict:
    """Phase 19c in one of the ranks sharing ``cuda:0`` over gloo: the
    host graph memory-mapped from ``gdir``, the rank's blocks packed and
    uploaded, then the sharded hybrid BFS from ``srcs``, the sharded push
    BFS from ``src0`` and run_sharded PageRank; rank 0 checks them
    against the single-card results (``want``: (dist, levels) a source;
    ``push_want``; the float64 ranks) and returns the walls and every
    rank's kernel launches."""
    from titan_tpu_torch.models import bfs as PB
    from titan_tpu_torch.models import bfs_hybrid_sharded as SH
    from titan_tpu_torch.models import pagerank as MP
    from titan_tpu_torch.olap import engine as E
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.ops import frontier as F
    from titan_tpu_torch.ops import seg_scan as S

    t0 = time.time()
    hg = dict(meta, **{k: np.load(os.path.join(gdir, k + ".npy"),
                                  mmap_mode="r")
                       for k in ("dstT", "colstart", "deg")})
    snap = SN.from_chunked_csr(hg)
    snap.out_csr()
    walls = {"setup_s": time.time() - t0}
    F.frontier_round.launches = S.seg_scan.launches = 0
    got = []
    (_, walls["hybrid_first_s"]) = wall_s(
        lambda: SH.frontier_bfs_hybrid_sharded(hg, srcs[0], mesh))
    for src in srcs:
        (dist, levels), t = wall_s(
            lambda: SH.frontier_bfs_hybrid_sharded(hg, src, mesh))
        got.append((dist, levels, t))
    (push, walls["push_s"]) = wall_s(
        lambda: PB.frontier_bfs_sharded(snap, src0, mesh))
    params = pagerank_params(snap)
    (_, walls["pagerank_first_s"]) = wall_s(lambda: E.run_sharded(
        MP.PageRank(0.85, 20, 0.0), snap, params, mesh))
    (pr, walls["pagerank_s"]) = wall_s(lambda: E.run_sharded(
        MP.PageRank(0.85, 20, 0.0), snap, params, mesh))
    counts = mesh.all_gather(torch.tensor(
        [F.frontier_round.launches, S.seg_scan.launches]))
    if mesh.rank != 0:
        return {}
    for (dist, levels, _), (wd, wl), src in zip(got, want, srcs):
        check(np.array_equal(dist, wd) and levels == wl, f"phase 19c: the "
              f"sharded BFS from {src} differs from the single card's")
    check(np.array_equal(push[0], push_want[0])
          and push[1] == push_want[1], "phase 19c: the sharded push BFS "
          "differs from the single card's frontier_bfs")
    rel = float(np.max(np.abs(pr["rank"] - pr_ref) / pr_ref))
    check(rel <= PAGERANK_RTOL, f"phase 19c: sharded PageRank differs "
          f"from float64 by {rel}")
    walls["hybrid_s"] = [t for _, _, t in got]
    return {"walls": walls, "pagerank_rel": rel,
            "levels": [lv for _, lv, _ in got],
            "profile": [dict(p) for p in SH.LAST_PROFILE],
            "launches": counts.tolist()}


def phase_sharded_gloo(P, PB, G, ref, card) -> dict:
    """Phase 19c: 2 ranks sharing the one card over gloo at s22 (see the
    module doc). Returns the two kernels' launches over both ranks."""
    from titan_tpu_torch.parallel import multihost as M

    t_phase = time.time()
    hg, snap, src0 = ref["hg"], ref["snap"], ref["bfs_source"]
    srcs = sample_sources(hg["deg"], NUM_SOURCES)
    g500 = G.graph_from_numpy(hg, "cuda")
    want = [P.frontier_bfs_hybrid(g500, s) for s in srcs]
    del g500
    push_want = PB.frontier_bfs(snap, src0, device="cuda")
    torch.cuda.empty_cache()
    gdir = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    try:
        for k in ("dstT", "colstart", "deg"):
            np.save(os.path.join(gdir, k + ".npy"), np.asarray(hg[k]))
        meta = {"n": int(hg["n"]), "q_total": int(hg["q_total"])}
        rec, wall = wall_s(lambda: M.launch(
            gloo_rank, GLOO_RANKS, "cuda:0", "gloo", args=(
                gdir, meta, srcs, src0, want, push_want, ref["pagerank"]),
            timeout=600))
    finally:
        shutil.rmtree(gdir, ignore_errors=True)
    per_rank = rec["launches"]
    check(all(f > 0 and s > 0 for f, s in per_rank), f"phase 19c: a rank "
          f"launched no frontier_round or no seg_scan: {per_rank}")
    w = rec["walls"]
    say(f"phase 19c: s{ENGINE_SCALE}, {GLOO_RANKS} ranks sharing one card "
        f"over gloo ({card}; not a multi-card number): the sharded hybrid "
        f"BFS from {srcs} bit-equal to the single card's (levels "
        f"{rec['levels']}), the sharded push BFS from {src0} equal to "
        f"frontier_bfs, run_sharded PageRank within "
        f"{rec['pagerank_rel']:.3g} of float64; walls on 2 ranks sharing "
        f"one card over gloo (host clock, rank 0, s): "
        + json.dumps(w) + f"; launches [frontier_round, seg_scan] by rank "
        f"{per_rank}; the launch {wall:.1f} s, the phase "
        f"{time.time() - t_phase:.1f} s")
    say("phase 19c: the last source's profile on 2 ranks sharing one card "
        "over gloo " + json.dumps([{k: p[k] for k in (
            "level", "mode", "nf", "found_max_per_chip", "found_cap",
            "retries", "dispatches")} for p in rec["profile"]]))
    return {"frontier_round": sum(f for f, _ in per_rank),
            "seg_scan": sum(s for _, s in per_rank)}


def phase_sharded_bfs(F, hg, per_source, teps6, card) -> int:
    """Phase 19b on phase 6's s26 graph: the sharded hybrid BFS over a
    world-1 NCCL mesh from bench.py's sources; returns its frontier_round
    launches."""
    from titan_tpu_torch.models import bfs_hybrid_sharded as SH
    from titan_tpu_torch.parallel import multihost as M

    t_phase = time.time()
    n = hg["n"]
    mesh, tmp = mesh_group("nccl")
    rows = []
    try:
        # ---- the main path, with the kernel counts from 0
        F.frontier_round.launches = 0
        _, pack_s = wall_s(lambda: SH.frontier_bfs_hybrid_sharded(
            hg, per_source[0]["source"], mesh, return_device=True))
        for r in per_source:
            best = None
            for _ in range(REPS):
                (dist, levels), t = wall_s(
                    lambda: SH.frontier_bfs_hybrid_sharded(
                        hg, r["source"], mesh, return_device=True))
                if best is None or t < best[2]:
                    best = (dist, levels, t, list(SH.LAST_PROFILE))
            dist, levels, t, prof = best
            check(torch.equal(dist, r["dist"][:n]), f"phase 19b: the "
                  f"sharded BFS from {r['source']} differs from phase 6's "
                  f"validated dist")
            check(levels == r["levels"], f"phase 19b: {levels} levels from "
                  f"{r['source']}, phase 6 took {r['levels']}")
            rows.append({"source": r["source"], "levels": levels,
                         "t_bfs": t, "hybrid_t_bfs": r["t_bfs"],
                         "ratio": t / r["t_bfs"],
                         "teps": r["m_traversed"] / t,
                         "levels_profile": [{k: p[k] for k in (
                             "mode", "dispatches", "retries", "found_cap",
                             "found_max_per_chip")} for p in prof]})
        launches = F.frontier_round.launches
        # ---- end of the main path
    finally:
        hg.pop(SH._CACHE, None)
        M.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    check(launches > 0, "the sharded BFS never launched frontier_round")
    teps = len(rows) / sum(1.0 / r["teps"] for r in rows)
    ratio = sum(r["t_bfs"] for r in rows) / sum(r["hybrid_t_bfs"]
                                                 for r in rows)
    say(f"phase 19b: s{SCALE} sharded hybrid BFS over a world-1 NCCL mesh "
        f"on {card} (bench.py's bfs23_sharded at the headline scale): "
        f"TEPS {teps:.6g} (harmonic mean, best of {REPS}) against phase "
        f"6's {teps6:.6g}; sharding_overhead_ratio {ratio:.4f} (summed "
        f"walls); dist bit-equal to phase 6's validated results, levels "
        f"equal; the block packed and uploaded with the first call in "
        f"{pack_s:.1f} s; frontier_round launches {launches}; "
        f"{time.time() - t_phase:.1f} s; per source " + json.dumps(rows))
    return launches


def sssp_round_split(trace) -> list[dict]:
    """Per round from a drained ``_trace_rounds``: the plan's seconds and
    the pushes' (from the end of this plan to the start of the next,
    whose drain waited for them)."""
    rows = []
    for i, (band, nf, m8, t, plan_s) in enumerate(trace):
        push = (trace[i + 1][3] - trace[i + 1][4] - t) \
            if i + 1 < len(trace) else 0.0
        rows.append({"round": i, "nf": nf, "m8": m8,
                     "plan_s": round(plan_s, 6), "push_s": round(push, 6)})
    return rows


def phase_frontier_s26(F, P, FR, g, hg, card) -> int:
    """Phase 9: bench.py's sssp_wcc stage on the s26 graph, then the
    checks. Returns the WCC peel's frontier_round launches."""
    from titan_tpu_torch.device import INF

    src = int(np.flatnonzero(np.asarray(hg["deg"]) > 0)[0])
    torch.cuda.reset_peak_memory_stats()
    trace = []
    g["_trace_rounds"] = trace
    g["_trace_plan_drain"] = True
    try:
        (dist, rounds), t_sssp = wall_s(lambda: FR.frontier_sssp(
            g, src, return_device=True))
    finally:
        del g["_trace_rounds"], g["_trace_plan_drain"]
    plans = np.asarray([r[4] for r in trace])
    split = sssp_round_split(trace)
    # ---- the WCC main path, the kernel counts from 0
    F.frontier_round.launches = 0
    (label, wrounds), t_wcc = wall_s(lambda: FR.frontier_wcc(
        g, return_device=True))
    peel = F.frontier_round.launches
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    check(peel > 0, "the WCC peel never launched frontier_round")
    say(f"phase 9: s{SCALE} frontier_sssp from {src} (bench.py's sssp_wcc, "
        f"traced and drained as bench.py runs it) on {card}: {rounds} "
        f"rounds in {t_sssp:.4f} s; plan seconds a round mean "
        f"{plans.mean():.6f}, p50 {np.median(plans):.6f}, max "
        f"{plans.max():.6f}, total {plans.sum():.6f} over {len(plans)} "
        f"plans; pushes {sum(r['push_s'] for r in split):.6f} s in all")
    say(f"phase 9: each SSSP plan (nf, m8, plan_s, push_s): "
        + json.dumps(split))
    say(f"phase 9: s{SCALE} frontier_wcc: {wrounds} rounds (BFS peel levels "
        f"included) in {t_wcc:.4f} s; frontier_round {peel} launches in "
        f"the peel; peak memory {peak / 2**30:.3f} GiB")
    t0 = time.time()
    nreach = check_sssp(FR, g, dist, src)
    ncomp = check_wcc(FR, g, label)
    check(torch.equal(dist < float(FR.FINF), label == label[src]),
          "SSSP's reached set is not the source's component")
    bfs_src = sample_sources(hg["deg"], NUM_SOURCES)[0]
    bfs, _ = P.frontier_bfs_hybrid(g, bfs_src, return_device=True)
    giant = label == label[bfs_src]
    check(torch.equal(bfs < INF, giant), "the giant label's set differs "
          "from what a BFS from phase 6's first source reaches")
    say(f"phase 9: SSSP checked by its {(g['q_total'] - 1) * 8} slot "
        f"tests ({nreach} reached, none can lower a distance, every reached "
        f"vertex has a tight in-edge); WCC checked by its edges and label "
        f"rules ({ncomp} components), the giant's {int(giant.sum())} "
        f"vertices equal to a BFS from {bfs_src}; checks "
        f"{time.time() - t0:.1f} s")
    del dist, label, bfs, giant
    torch.cuda.empty_cache()
    return peel


#: phase 21: each probe kernel's record on the kernels line, and the TPU
#: kernel it stands for (the first of its sites in PERF.md section 6)
PROBE_REPLACES = {
    "stream_copy": "experiments/probe_pallas_gather.py:56",
    "table_gather": "experiments/probe_pallas_gather.py:68",
    "row_shuffle": "experiments/probe_pallas_gather.py:87",
    "table_scatter": "experiments/probe_pallas_gather.py:100",
    "tile_transpose": "experiments/probe2_rates.py:136",
    "segment_copy": "experiments/probe3_dma.py:26"}
#: phase 21's wall, the probes' checks and timing together
PROBES_BUDGET_S = 30.0


def probe_segment_cases(dev):
    """Phase 21's segment copies: (name, src, starts, outpos, length,
    out_len, lens, inflight). probe3b's V1-V6 (E = 2^22, 128 words; V1-V3
    one copy into a 256-word output, V4-V6 1024 copies, V5's guard
    ``s >= 0`` as ``lens``, V6 with 8 semaphores), probe3c's W1-W3 (8-row
    segments of a [2^15, 128] pool: W1 row 0 into an [8, 128] output, W2
    1024 and W3 4096 with 8 in flight), probe3_dma's four cases with
    every 5th segment dead (``lens`` 0), and the kernel's edges: the
    smallest segment (16 B), the largest (16 KB) at 8 in flight, and 1,
    2, 3, 31 and 32 in flight over ragged counts."""
    i32 = torch.int32
    e = 1 << 22
    edges = torch.arange(e, device=dev, dtype=i32)
    st = (torch.arange(1024, device=dev, dtype=i32) * 128) % (e - 256)
    k = torch.arange(1024, device=dev, dtype=i32)
    one = torch.zeros(1, device=dev, dtype=i32)
    cases = [("V1", edges, one, one, 128, 256, None, 1),
             ("V2", edges, one, one, 128, 256, None, 1),
             ("V3", edges, st[:1], one, 128, 256, None, 1),
             ("V4", edges, st, k * 128, 128, 1024 * 128, None, 1),
             ("V5", edges, st, k * 128, 128, 1024 * 128,
              (st >= 0).to(i32), 1),
             ("V6", edges, st, k * 128, 128, 1024 * 128, None, 8)]
    r = 1 << 15
    rows = torch.arange(r * 128, device=dev, dtype=i32)
    st2 = (torch.arange(4096, device=dev, dtype=i32) * 7) % (r - 8)
    k2 = torch.arange(4096, device=dev, dtype=i32)
    cases += [("W1", rows, one, one, 8 * 128, 8 * 128, None, 1),
              ("W2", rows, st2[:1024] * 128, k2[:1024] * 1024, 1024,
               1024 * 1024, None, 1),
              ("W3", rows, st2 * 128, k2 * 1024, 1024, 4096 * 1024, None,
               8)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    pool = torch.randint(0, 2**20, (1 << 25,), generator=gen, device=dev,
                         dtype=i32)
    for deg, pad, n in ((32, 128, 1 << 17), (128, 128, 1 << 17),
                        (512, 512, 1 << 15), (4096, 4096, 1 << 12)):
        kk = torch.arange(n, device=dev, dtype=i32)
        lens = torch.where(kk % 5 == 4, 0, deg).to(i32)
        cases.append((f"probe3_dma deg={deg}", pool, kk * deg, kk * pad,
                      pad, n * pad, lens, 8))
    for length, n, f in ((4, 1001, 8), (4096, 333, 8), (64, 999, 1),
                         (64, 1000, 2), (36, 1003, 3), (128, 5001, 31),
                         (128, 5003, 32)):
        starts = torch.randint(0, (len(pool) - length) // 4, (n,),
                               generator=gen, device=dev, dtype=i32) * 4
        cases.append((f"L={length} n={n} inflight={f}", pool, starts,
                      torch.randperm(n, generator=gen, device=dev).to(i32)
                      * length, length, n * length, None, f))
    return cases


def phase_probe_cases(PR, dev) -> int:
    """Phase 21a: each probe kernel against its plain version on the card,
    bit-equal (``set`` by ``scatter_set_ok``), at small and ragged
    shapes. Returns the number of cases."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2021)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    n = 0
    for shape in ((1,), (3,), (5,), (1000003,), (17, 128), (2049 * 128 + 3,),
                  (4096 * 3 + 4,), (4096 * 257 + 1025,), (4095,)):
        x = ri(-2**31, 2**31 - 1, shape)
        check(torch.equal(PR.stream_copy(x), PR.stream_copy_reference(x)),
              f"phase 21: stream_copy differs at {shape}")
        n += 1
    for t_rows, width in ((8, 128), (448, 128), (449, 128), (4096, 128),
                          (3, 4), (100, 12)):
        tab = ri(0, 2**20, (t_rows, width))
        for rows in (1, 3, 1001, (1 << 18) + 5):
            idx = ri(0, t_rows, (rows, width))
            for shift in (None, ri(0, 32, (rows, width))):
                check(torch.equal(PR.table_gather(tab, idx, shift),
                                  PR.table_gather_reference(tab, idx,
                                                            shift)),
                      f"phase 21: table_gather differs at T={t_rows}, "
                      f"W={width}, rows={rows}, bits={shift is not None}")
                n += 1
    for rows in (1, 7, 1001, 65537):
        v, idx = ri(-2**31, 2**31 - 1, (rows, 128)), ri(0, 128, (rows, 128))
        check(torch.equal(PR.row_shuffle(v, idx),
                          PR.row_shuffle_reference(v, idx)),
              f"phase 21: row_shuffle differs at {rows} rows")
        n += 1
    paths = set()
    # (7263, 128) and (14527, 12): the largest slabs of stripes 8 and 4,
    # at the block's shared-memory limit (probes.SHARED_BYTES)
    for t_rows, width in ((8, 128), (448, 128), (4096, 128), (7, 128),
                          (7263, 128), (14528, 128), (4096, 4), (7, 12),
                          (4096, 132), (14527, 12), (14528, 12),
                          (20000, 4)):
        paths.add(PR.scatter_path(t_rows, width))
        for rows in (1, 1001, (1 << 17) + 3):
            idx = ri(0, t_rows, (rows, width))
            for mode, (lo, hi) in (("set", (-100, 100)),
                                   ("max", (-100, 100)),
                                   ("add", (-2**31, 2**31 - 1))):
                val = ri(lo, hi, (rows, width))
                got = PR.table_scatter(idx, val, t_rows, mode)
                check(PR.scatter_set_ok(got, idx, val) if mode == "set"
                      else torch.equal(got, PR.table_scatter_reference(
                          idx, val, t_rows, mode)),
                      f"phase 21: table_scatter {mode} differs at "
                      f"T={t_rows}, W={width}, rows={rows} (stripe "
                      f"{PR.scatter_path(t_rows, width)})")
                n += 1
    check(paths == {0, 4, 8}, f"phase 21: the scatter cases took the "
          f"designs {paths}, not the slab's two stripes and the global one")
    for rows in (128, 256, 128 * 1001):
        v = ri(-2**31, 2**31 - 1, (rows, 128))
        check(torch.equal(PR.tile_transpose(v),
                          PR.tile_transpose_reference(v)),
              f"phase 21: tile_transpose differs at {rows} rows")
        n += 1
    for name, src, starts, outpos, length, out_len, lens, f in \
            probe_segment_cases(dev):
        got = PR.segment_copy(src, starts, outpos, length, out_len, lens, f)
        want = PR.segment_copy_reference(src, starts, outpos, length,
                                         out_len, lens, f)
        live = outpos if lens is None else outpos[lens > 0]
        at = (live.long()[:, None]
              + torch.arange(length, device=dev)).reshape(-1)
        check(torch.equal(got[at], want[at]),
              f"phase 21: segment_copy differs in {name}")
        n += 1
    torch.cuda.synchronize()
    return n


def say_probe(r: dict, card: str) -> None:
    sector = "" if r["sector_share"] is None else (
        f"; sector model {r['sector_bound_ms']:.4f} ms "
        f"({100 * r['sector_share']:.1f}%, {r['sector_gb_s']:.1f} GB/s with "
        f"the streams, {r['lookup_sector_gb_s']:.1f} GB/s of lookup sectors "
        f"alone)")
    lib = "none" if r["library_ms"] is None else \
        f"{r['library']} {r['library_ms']:.4f} ms"
    say(f"phase 21: {r['probe']} [{r['kernel']}, {r['where']}] on {card}: "
        f"{r['ms']:.4f} ms (median {r['median_ms']:.4f}), "
        f"{r['g_elem_s']:.2f} G elem/s, {r['gb_s']:.1f} GB/s; bound "
        f"{r['bound_ms']:.4f} ms ({100 * r['share']:.1f}%){sector}; plain "
        f"{r['plain_ms']:.4f} ms; library {lib}")


def phase_probes(PR, card) -> list[dict]:
    """Phase 21: the probe kernels of experiments/ (``ops/probes.py``).
    21a holds each against its plain version on the card at small and
    ragged shapes (``phase_probe_cases``); 21b zeroes the six launch
    counts, runs ``run_probes`` (every probe at the TPU probes' shapes,
    each checked once at full size, then timed) and reads the counts.
    Returns the six kernels' records for the kernels line, each at its
    probe that moves the most bytes (by the sector model where there is
    one), its other probes under ``cases``."""
    t0 = time.time()
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = phase_probe_cases(PR, dev)
    say(f"phase 21a: {cases} probe cases bit-equal to the plain versions "
        f"({time.time() - t0:.1f} s)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in PR.KERNELS:
        k.launches = 0
    recs = PR.run_probes(dev)
    launches = {k.__name__: k.launches for k in PR.KERNELS}
    peak = torch.cuda.max_memory_allocated() - base
    for r in recs:
        say_probe(r, card)
    out = []
    for name, replaces in PROBE_REPLACES.items():
        mine = [r for r in recs if r["kernel"] == name]
        top = max(mine, key=lambda r: r["sector_bytes"] or r["bytes"])
        check(launches[name] > 0, f"phase 21: {name} was never launched")
        out.append({
            "name": name, "route": "cuda",
            "source": "titan_tpu_torch/csrc/probes.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {"probes": launches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "probe": top["probe"],
            "sector_bound_ms": top["sector_bound_ms"],
            "cases": [{k: r[k] for k in (
                "probe", "where", "ms", "median_ms", "g_elem_s", "gb_s",
                "bound_ms", "share", "sector_share", "plain_ms",
                "library", "library_ms")} for r in mine]})
    wall = time.time() - t0
    say(f"phase 21b: launches {launches}; peak {peak / 1e9:.2f} GB above "
        f"the {base / 1e9:.2f} GB held before; phase 21 wall {wall:.1f} s")
    check(peak < 6e9, f"phase 21: peak memory {peak / 1e9:.2f} GB >= 6 GB")
    check(wall < PROBES_BUDGET_S, f"phase 21 took {wall:.1f} s "
          f"(budget {PROBES_BUDGET_S} s)")
    return out


def window_sum_cases(WS, dev):
    """Phase 22a's inputs: (x, block, masked) on the card; the floats
    hold -0.0 in every fifth column."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2022)

    def rand(shape, dtype):
        if dtype == torch.int32:
            return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                 device=dev, dtype=dtype)
        x = torch.randn(shape, generator=gen, device=dev)
        x.view(-1)[::5] = -0.0
        return x
    for dtype in WS.DTYPES:
        for width in (64, 128, 300, 1024, 4099):
            for rows in (1, 2, 1001):
                x = rand((rows, width), dtype)
                for masked in (False, True):
                    yield x, WS.BLOCK, masked
        x = rand((5, 300), dtype)
        for block in (1, 64, 100, 256):
            yield x, block, True
        # a row base 4 bytes off 16: the kernel's scalar path at W = 128
        yield rand((1001 * 128 + 1,), dtype)[1:].view(1001, 128), \
            WS.BLOCK, False


def phase_window_sum(WS, card) -> dict:
    """Phase 22: the row window sum, the port of the lint fixture's
    ``_ok_kernel``. 22a holds the kernel bit-equal to its plain version
    at small and ragged shapes; 22b zeroes the launch count, runs
    ``run_window_sum`` at (2^21, 128) int32 and float32 and reads the
    count. Returns the kernel's record for the kernels line (int32 at
    the top, both dtypes under ``cases``)."""
    t0 = time.time()
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 0
    for x, block, masked in window_sum_cases(WS, dev):
        got = WS.row_window_sum(x, block=block, masked=masked)
        want = WS.row_window_sum_reference(x, block=block, masked=masked)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"phase 22: row_window_sum differs at {tuple(x.shape)} "
              f"{x.dtype}, block {block}, masked {masked}")
        n += 1
    torch.cuda.synchronize()
    say(f"phase 22a: {n} window-sum cases bit-equal to the plain version "
        f"({time.time() - t0:.1f} s)")
    torch.cuda.empty_cache()
    WS.row_window_sum.launches = 0
    recs = WS.run_window_sum(dev)
    launches = WS.row_window_sum.launches
    check(launches > 0, "phase 22: row_window_sum was never launched")
    for r in recs:
        lib = "none" if r["library_ms"] is None else (
            f"{r['library']} {r['library_ms']:.4f} ms (TF32 off; max "
            f"|conv - ladder| {r['library_max_abs_diff']:.3g})")
        say(f"phase 22: row_window_sum {r['dtype']} {tuple(r['shape'])} on "
            f"{card}: {r['ms']:.4f} ms (median {r['median_ms']:.4f}), "
            f"{r['gb_s']:.1f} GB/s; bound {r['bound_ms']:.4f} ms "
            f"({100 * r['share']:.1f}%); plain {r['plain_ms']:.4f} ms; "
            f"library {lib}")
    say(f"phase 22b: launches {launches}; phase 22 wall "
        f"{time.time() - t0:.1f} s")
    top = recs[0]
    return {**WINDOW_KERNEL, "launches": launches,
            "launches_by_path": {"window_sum": launches},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "dtype": top["dtype"],
            "cases": recs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from titan_tpu_torch import native
    from titan_tpu_torch.models import bfs as PB
    from titan_tpu_torch.models import bfs_hybrid as P
    from titan_tpu_torch.models import bfs_hybrid_fused as PF
    from titan_tpu_torch.models import frontier as FR
    from titan_tpu_torch.models import pagerank as PR
    from titan_tpu_torch.olap import graph500 as G
    from titan_tpu_torch.olap import snapshot as SN
    from titan_tpu_torch.olap.live import overlay as OV
    from titan_tpu_torch.ops import epoch_merge as EM
    from titan_tpu_torch.ops import frontier as F
    from titan_tpu_torch.ops import probes as PRB
    from titan_tpu_torch.ops import seg_scan as S
    from titan_tpu_torch.ops import window_sum as WS
    from titan_tpu_torch.traversal import olap_compile as OC

    card = card_line()
    print(card, flush=True)
    t0 = time.time()
    builds = [Background(F.kernel_library), Background(F.exhaust_library),
              Background(S.kernel_library), Background(PF.kernel_library),
              Background(PRB.kernel_library), Background(WS.kernel_library),
              Background(native.library)]
    for b in builds:
        b.result()
    say(f"phase 1: built frontier_round, batched_exhaust, seg_scan, "
        f"bfs_fused, the probes and the window sum (nvcc, sm_90a, one "
        f"process each, all at "
        f"once) and the native Graph500 library in {time.time() - t0:.1f} s")
    for name, lib in (("frontier_round", F.kernel_library()),
                      ("batched_exhaust", F.exhaust_library()),
                      ("seg_scan", S.kernel_library()),
                      ("bfs_fused", PF.kernel_library()),
                      ("probes", PRB.kernel_library()),
                      ("window_sum", WS.kernel_library())):
        say(f"phase 1: ptxas {name}: " + "; ".join(ptxas_lines(lib)))
    say(f"phase 1: bfs_fused's cooperative grid: "
        f"{PF.kernel_library().tt_bfs_fused_grid()} blocks of 256 threads")

    def host_build(scale):
        t = time.time()
        hg = G.load_or_build(scale, EDGE_FACTOR, seed=SEED, verbose=False)
        return hg, time.time() - t
    engine_build = Background(lambda: host_build(ENGINE_SCALE))
    main_build = Background(lambda: (engine_build.join(),
                                     host_build(SCALE))[1])

    phase_kernel_cases(F, G)
    phase_exhaust_cases(F)
    phase_seg_scan_cases(S)
    phase_seg_scan_rows(S)
    phase_small(F, P, G)
    phase_fused_small(PF, P, G, card)
    ref = engine_references(engine_build)
    main_build.join()     # the timed phases run with the host otherwise idle
    seg_rec, superstep_s = phase_engine(S, P, G, ref, card)
    batched = phase_engine_batched(S, P, G, ref, card)
    ckpt_launches = phase_checkpoint(S, ref, card)
    seg_rec["launches_by_path"] = {"engine": seg_rec["launches"],
                                   "engine_batched": batched["launches"],
                                   "engine_checkpoint": ckpt_launches}
    seg_rec["launches"] = sum(seg_rec["launches_by_path"].values())
    seg_rec["rows"] = batched["rows"]
    peel22 = phase_frontier_s22(F, P, G, FR, PR, ref, card, superstep_s)
    phase_push_s22(PB, P, PF, G, ref, card)
    phase10 = phase_serving_s22(F, P, FR, S, ref, card)
    served = phase10["launches"]
    meshed = phase_mesh_s22(F, P, S, ref, card, phase10)["launches"]
    seg_rec["launches_by_path"]["serving"] = served["seg_scan"]
    live_runs, lane_runs = ServedLaunches(F, S), ServedLaunches(F, S)
    live = phase_live_s22(P, SN, OV, EM, ref, card, live_runs)
    phase_interactive_s22(P, FR, PR, SN, ref, live, card, lane_runs)
    del live
    for path, runs in (("live", live_runs), ("interactive", lane_runs)):
        check(runs.total["frontier_round"] > 0
              and runs.total["batched_exhaust"] > 0, f"a kernel was never "
              f"launched on the {path} path: {runs.total}")
        say(f"phase 11: {path} launches {runs.total}")
    store_runs, server_runs = ServedLaunches(F, S), ServedLaunches(F, S)

    def on_store(g, snap):
        phase_traversal_store(F, S, OC, g, snap, card)
        phase_server_store(F, P, g, snap, card, server_runs, phase10)
    _, store_g, fresh = phase_store_ingest(P, G, ref, card, store_runs,
                                           traverse=on_store)
    check(all(server_runs.total.values()), f"a kernel was never launched "
          f"on the server path: {server_runs.total}")
    say(f"phase 15: server launches {server_runs.total}")
    check(store_runs.total["frontier_round"] > 0
          and store_runs.total["seg_scan"] > 0, f"a kernel was never "
          f"launched on the store path: {store_runs.total}")
    say(f"phase 12: store launches {store_runs.total}")
    phase_traversal_small(OC, card)
    gc.collect()
    torch.cuda.empty_cache()
    plane_runs = ServedLaunches(F, S)
    try:
        phase_live_plane(P, FR, SN, card, store_g, plane_runs, fresh)
    finally:
        store_g.close()
    del store_g, fresh
    phase_live_feed(P, SN, card, plane_runs)
    check(all(plane_runs.total[k] > 0 for k in plane_runs.total),
          f"a kernel was never launched on the plane path: "
          f"{plane_runs.total}")
    say(f"phase 13: plane launches {plane_runs.total}")
    fleet_runs, host_runs = ServedLaunches(F, S), ServedLaunches(F, S)
    walls = {}
    t16 = time.time()
    phase_fleet(card, fleet_runs, after=lambda cfg: walls.update(
        phase_host_computer(cfg, card, host_runs)))
    walls["fleet_s"] = time.time() - t16 - walls["host_computer_s"]
    say(f"phase 16: fleet launches {fleet_runs.total}")
    check(host_runs.total["seg_scan"] > 0, f"seg_scan was never launched "
          f"beside the host computer: {host_runs.total}")
    say(f"phase 17d: launches {host_runs.total}")
    walls.update(phase_scan_cluster(card))
    say("phase 17e: walls (host clock, s) " + json.dumps(walls))
    check(walls["fleet_s"] + walls["host_computer_s"] + walls["phase_s"]
          < 60.0, f"phases 16 and 17 took more than 60 s: {walls}")
    oltp = phase_oltp_remainder(S, card)
    sharded_seg = phase_sharded_engine(S, ref, card)
    gloo = phase_sharded_gloo(P, PB, G, ref, card)
    gc.collect()          # the store and its snapshots, before s26
    del ref               # and with it the s22 graph cached on the card
    torch.cuda.empty_cache()
    g, hg, per_source, teps6, rec = phase_main(F, P, G, main_build, card)
    fused_rec = phase_fused_main(PF, G, g, hg, per_source, teps6, card)
    sharded_rounds = phase_sharded_bfs(F, hg, per_source, teps6, card)
    del per_source
    replays, paths, sweep, x_rec = phase_batched(F, P, G, g, hg, card)
    peel26 = phase_frontier_s26(F, P, FR, g, hg, card)
    del g
    torch.cuda.empty_cache()
    phase_batched_small(F, P, G, SN, OV, card)
    gc.collect()
    torch.cuda.empty_cache()
    probe_recs = phase_probes(PRB, card)
    window_rec = phase_window_sum(WS, card)
    rec["replays"] += replays
    rec["k_sweep"] = sweep
    rec["launches_by_path"] = {"bfs": rec["launches"], **paths,
                               "wcc_peel_s22": peel22,
                               "wcc_peel_s26": peel26,
                               "serving": served["frontier_round"],
                               "mesh": meshed["frontier_round"],
                               "live": live_runs.total["frontier_round"],
                               "interactive":
                                   lane_runs.total["frontier_round"]}
    rec["launches_by_path"]["store"] = store_runs.total["frontier_round"]
    rec["launches_by_path"]["plane"] = plane_runs.total["frontier_round"]
    seg_rec["launches_by_path"]["store"] = store_runs.total["seg_scan"]
    seg_rec["launches_by_path"]["plane"] = plane_runs.total["seg_scan"]
    seg_rec["launches_by_path"]["gdbm"] = oltp["launches"]
    rec["launches_by_path"]["sharded"] = sharded_rounds \
        + gloo["frontier_round"]
    seg_rec["launches_by_path"]["sharded"] = sharded_seg + gloo["seg_scan"]
    s_rec = x_rec.pop("summary")
    for r, key in ((x_rec, "batched_exhaust"), (s_rec, "exhaust_summary")):
        r["launches_by_path"].update(
            serving=served[key], mesh=meshed[key], live=live_runs.total[key],
            interactive=lane_runs.total[key], store=store_runs.total[key],
            plane=plane_runs.total[key])
    for r, key in ((rec, "frontier_round"), (seg_rec, "seg_scan"),
                   (x_rec, "batched_exhaust"), (s_rec, "exhaust_summary")):
        r["launches_by_path"]["server"] = server_runs.total[key]
        if fleet_runs.total[key]:
            r["launches_by_path"]["fleet"] = fleet_runs.total[key]
        if host_runs.total[key]:
            r["launches_by_path"]["host_computer"] = host_runs.total[key]
        r["launches"] = sum(r["launches_by_path"].values())
    fused_rec["launches_by_path"] = {"bfs_fused": fused_rec["launches"]}
    print(json.dumps({"kernels": [rec, seg_rec, x_rec, s_rec, fused_rec,
                                  *probe_recs, window_rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
