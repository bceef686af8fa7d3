#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the full run: fold n = 2^20, dense n = 2^16
    python3 chip_smoke.py --log2n 14   # a quicker run at smaller graphs

Phases, each fatal on failure:

1. card: the card's name and power limit (nvidia-smi);
2. build: compile every kernel of the port from ``csrc/`` (nvcc, sm_90a);
3. kernel vs plain: K1 against its plain PyTorch version on random
   ragged single tiers (a one-tier work list), and on random multi-tier
   operators through the all-tier launch (a zero-slot tier, bulk tiers
   and a 6,000-slot hub row split across CTAs), against the plain
   version and the work-list twin, each bit for bit equal to a second
   launch; every carriage, binary and weighted;
4. main path: Barabasi-Albert n=2^20 m=8, decomposed at width 2048 (10
   levels, seed 7), saved and loaded as an artifact, folded into one
   SELL operator on the card (its tier ladder logged), stepped through
   ``MultiLevelArrow`` at k=16 and k=128 (f32; every step and the chain
   of 10 iterations at k=16, of 2 at k=128, validated against the host
   golden ``A^s x`` over the graph itself), one bf16 and one int8 step, and the tight packing (growth
   1.1, align 1) for 3 iterations; ms/iter is the median of 7 timed
   chains of 10; the host goldens are kept for phase 11; K1's
   launch count must equal its launches per product (one, two with
   split rows) x iterations, whatever the tier count;
5. per-kernel numbers at the main path's shapes: K1 against its plain
   version on the real operator, its time per product (median of 20,
   eager; the graph replays of every row were cut for time: they
   differed from eager by at most 0.6%), its bound, the plain version's
   time, one PyTorch call computing the same product
   (``torch.sparse.mm``) as a yardstick; K1's registers and spills from
   ptxas; beside
   the bound that reads X once, the bound of a gather that reads every
   gathered row (nnz rows and indices, and the output); and, run in
   phase 11 where the operators exist, K1 on one ELL stack and on one
   HYB light tier against its plain version, each repeated bit for bit;
6. dense kernels vs plain: K2 (column blocks) and K3 (head row) against
   their plain PyTorch versions on random stacks, (nb, w) in {(3, 48),
   (5, 64), (33, 200), (4, 2048)}, k in {8, 16, 128}, banded and
   block-diagonal, f32 and bf16 blocks, and each bit for bit equal to a
   second launch on the same inputs;
7. dense main path: Barabasi-Albert n=2^16 m=8 (dense stacks of 2^20
   rows would not fit the card), decomposed at width 2048 to
   convergence (max_levels=10, seed 7), saved and loaded, tiled into
   dense arrow blocks on the card by ``MultiLevelArrow(fmt="dense")``
   and stepped at k=16 and k=128 (f32 blocks, 10 chained iterations,
   every step and the chain validated against the host golden; ms/iter
   the median of 7 timed chains), one step with bf16 blocks at each k;
   K2's and K3's launch counts must equal levels x iterations, K4's
   (levels - 1) gathers and as many gather-adds an iteration, and a
   step must equal the step routed by ``index_select`` bit for bit;
8. per-kernel numbers at the dense path's shapes: K2 and K3 against
   their plain versions on the real blocks, their time per step
   (median of 20), bound, the plain versions' time, and the same
   function through cuBLAS (f32 blocks) as a yardstick; K4 over the
   f32 path's routing, as in phase 11;
9. K4 vs plain: its row gather and fused gather-add against their
   plain PyTorch versions (``index_select``, and ``index_select`` then
   ``add_``) bit for bit, on rows with a -0.0 and a NaN payload, at k in
   {1, 3, 4, 36} (also on a view off 16-byte alignment: the scalar
   body), at the probe's shape (n = 2^20, S = 2^21, k = 16) and at the
   routing's (a permutation of 2^20 rows, k = 16 and 128), each
   repeated bit for bit; and the probe's granule entry at (n, S) in
   {(2^10, 256), (2^14, 2^12), (2^20, 2^21), (1000, 360)}, equal to its
   plain version (granule lines, then the sub-row) by value and to
   ``take`` bit for bit;
10. the gather probes at full size (their main path): the granule probe's
   three variants (``torch_take``, ``torch_granule``, K4) with K4's
   bound, the gather rates of ``take`` (and of ``x[idx]`` and, in f32,
   of K4 beside it) over k, dtype and index order, and the fold step at
   k = 16 and 128 for both carriages, on phase 4's fold (max_levels 10,
   where the JAX probe decomposes again at 12);
11. the other formats at full size, run right after phase 5 on phase
   4's decomposition: ``MultiLevelArrow`` with ``fmt`` auto (dense while
   the levels fit half the card's free memory, then ELL), ell (the head
   resolved as on the card) and hyb, each built, stepped once at k=16
   and k=128 and for a 3-step chain at k=16 against the host golden,
   timed (median of 3 chains of 10 steps, eager and from one CUDA
   graph; the levels' products and the routing apart, the routing as
   the step runs it (K4) beside the ``index_select`` routing it
   replaced, with its bound), its K1, K2, K3 and K4 launches equal to
   the formats' per step, each step bit for bit equal to the step
   routed by ``index_select``, then K1 over all its operators (and
   K2/K3 on auto's dense levels) and K4 over its routing (the gathers
   and the gather-adds apart) against the plain versions, with bounds
   and library calls;
12. the ELL head layouts (gell, flat, per-block ELL) and the dense
   format at ``bench.py``'s kernel-comparison shape (BA n = 2^16 m=8,
   width 2048, 2 levels, seed 7): one validated step each, with its
   launches (a flat head adds one K4 gather a level), bit for bit
   equal to the step routed by ``index_select``, and ms/iter (the dense
   format is left out, and says so, when its blocks would not fit the
   card's free memory);
13. the model families at full size, run right after phase 11 on phase
   4's decomposition (k_in = hidden = 128, k_out = 16; 5 Adam steps
   each, forward, backward and train-step ms from CUDA events, median of
   the last 4 steps, with the launches of each kernel per step and the
   propagation's bound): on the symmetric ``D^-1/2 A D^-1/2`` (each
   level's rows and columns scaled), where the backward runs the
   forward operator, ``SGCModel`` (2 hops) and ``APPNPModel`` (10 hops,
   alpha 0.1) on ``fmt="auto"`` and the carried forms of both and of
   ``GCNModel`` (128, 128, 16) on its fold (``GCNModel`` on ``auto`` was
   cut for time: it trains on ``hyb`` and ``dense`` below); on the
   asymmetric ``D⁻¹A`` (each level's
   rows scaled), where the backward runs the kernels over transposed
   packs, ``GCNModel`` on ``hyb``, ``GCNCarried`` on its fold and
   ``GCNModel`` on ``dense`` at phase 7's shape; every first-step
   forward and gradient against a float64 host golden (scipy with the
   explicit transpose, numpy for the dense layers; at 2^20 computed by
   a host process from the start over phase 4's graph as its host saves
   it, whose digest must be the levels' sum's), the losses finite and
   falling; one ``Aᵀ g``
   against scipy for every format family; the solvers (power iteration
   and CG on phase 4's fold, label propagation over ``D⁻¹A`` and
   PageRank over ``A D⁻¹`` on hyb) against their float64 host
   iterations; K1 and K4 over the transposed packs and K2/K3 over the
   transposed dense blocks against their plain versions, with bounds and
   library calls;
14. the native decomposer and the port's bench: (a) Barabasi-
   Albert n = 2^20 m=8 (phase 4's graph) decomposed at width 2048
   (max_levels 12, seed 7) by the port's native (C++) decomposer, its
   seconds beside phase 4's numpy seconds, its levels checked (they
   reconstruct A exactly; every level within its width) and saved under
   the bench's cache key; (b) ``python -m arrow_matrix_tpu_torch.bench``
   as a subprocess on that cache (kernel comparison off: phase 12 covers
   its variants; the race fold and auto: phase 4 times fold_tight and
   phase 11 hyb),
   whose last line must carry the card's platform and
   name, a finite ``value`` within ``frobenius_gate``, ``k128_ms``
   within ``k128_gate``, ``roofline_frac`` at most 1 and a ``fmt_used``,
   and whose candidates each launched the kernels of their format (the
   counts each candidate's subprocess read around its measurement);
   the line stamped ``"platform": "gpu"`` and the card's name, any
   ``last_onchip`` a "gpu" record, and the same line as the one
   ``kind="bench"`` record in phase 18's run-local ledger.

15. the serving runtime, run right after phase 13 on phase 4's
   decomposition (its fold built once by a closure over the levels, the
   ladder's rungs that fold with their column schedule), with the card's
   own HBM budget: (a) 32 requests (4 tenants,
   k = 16, 10 iterations, seed 7; the first request's X phase 4's k=16
   input) through ``ArrowServer`` batched to k = 128 (4 batches; queue
   64): every ticket completed with no fault, K1's launches exactly
   batches x iterations x launches a product, each batch's first
   request served alone equal to its slice bit for bit, phase 4's input
   within the 10-step gate of phase 4's golden, and each batch's price
   (its requests' admission prices) at or above the measured peak of
   device memory; requests/s, p50/p99, per-batch device ms (CUDA events
   around the supervised loop), host ms of ``set_features``,
   ``gather_result`` and the concatenation; (b) one k = 128 batch on
   each rung of the ladder from repl=2, overlap_slabs=2, each equal to
   the base bit for bit with K1 launched c x S products a step, then an
   error plan exhausting the retries that walks the tenant down every
   rung to the same bits; (c) the port's ``tools/serve_gate.py``
   (``run_serve_scenarios`` over this phase's factory and trace): its
   in-process scenarios (hang, a corrupt checkpoint, overflow, an HBM
   budget of one request) and its NaN rollback, each ending equal to
   the fault-free replay; (d) ``graft_serve`` as a subprocess at BA n = 2^16, SIGKILLed
   by a kill plan and rerun from its checkpoints, equal to a never-killed
   run, in a thread beside (b) and (c) (its subprocesses time nothing);
   then K1 at the batch shape against its plain version with its
   time, bound and ``torch.sparse.mm``.
16. observed serving, right after phase 15 on its factory and trace:
   (a) the first 16 of the same requests again with a ``PulseMonitor`` (0.5 s
   windows, the default burn rules), a ``Tracer``, a ``PulseEndpoint``
   on port 0 scraped (``/metrics``, ``/pulse.json``, ``/healthz``)
   during the run, and a ledger under the run's directory: every result
   bit-equal to phase 15's, the ring and exposition valid, the monitor's
   latency count/p50/p99 equal to the SLO report's, every span stamped
   with its request id, the ledger's ``serve`` and ``pulse`` records
   valid and stamped with the card's name, K1's launches batches x
   iterations x launches a product; requests/s and p50/p99 beside phase
   15's; (b) ``utils/logging.trace`` (``torch.profiler``) around a chain
   of 10 fold steps at f32 k=16 and around one k=128 batch: each trace
   holds exactly the K1 launches the wrapper counted (``sell_kernel``,
   ``sum_rows_kernel``) and the tracer's spans as annotations; the
   kernel (and copy) share of each window and K1's time a product
   beside CUDA events'; (c) ``smoke_serve`` at its defaults; (d)
   ``graft_serve --pulse --pulse_port 0`` at (d)'s arguments, bit-equal
   to phase 15's run without ``--pulse``, its trace and ring valid (a
   subprocess in a thread beside (a)-(c) and (e)); (e)
   one k=128 batch result (host numbers) through ``fleet/wire`` over a
   socket pair inline and as a shared-memory descriptor, bit-equal, and
   ``measure_transports`` (the inline frame carries the result's first
   quarter of rows).
17. the fleet, right after phase 19, while the ranks finish their work
   of phases 20-23 (so (a)'s requests/s and latencies are taken beside
   their host transports), its K1 after phase 20 on the card otherwise
   idle: (a) ``graft_fleet`` as a subprocess, 2 worker
   processes on the card each over ``ba_executor_factory(2^20, 2048,
   seed 11)`` (the fold, K1; the graph decomposed once, in a process
   of its own from the start, and loaded by the workers and the replay
   through ``AMT_BA_CACHE_DIR``), ring placement, the wire over shared
   memory, 4 tenants, 8 requests at k = 16, 10 iterations: every
   request completed, bit-equal to a single-process replay built in a
   thread beside the fleet; the fleet p99 the exact pooled quantile;
   the workers' budgets summing to at most the card's, each worker's
   allocator peak within its budget; ``nvidia-smi`` listing every
   process on the card; K1 launched requests x iterations x launches a
   product in the workers (their own counts, which start at 0 in each
   fresh process); the workers' ledgers stamped with the card;
   ``fleet_xray.json`` and ``xray_report.json`` written, and
   ``graft_xray`` and ``graft_pulse`` reading the run dir; (b)-(e) the
   port's ``tools/fleet_gate.py`` scenarios at serve_kill's graph (BA
   n = 2^16, width 2048) with the lock witness armed: ``fleet_kill``,
   ``fleet_host_kill``, ``router_quorum`` and ``fleet_migrate``, each
   with zero loss, requeue and resume where the scenario asks, and
   results bit-equal to the replay; then K1 at the fleet's shape
   against its plain version.

18. the lens, the probe and the ledger, after phase 14 on phase 4's
   levels (read back from its artifact through a ``"dir"`` source, so
   no graph is decomposed twice): (a) ``obs/lens.profile_fold`` at
   k=128, f32 and bf16 (20 chained iterations a sample, 5 interleaved
   sweeps): the full step beside phase 4's (f32) and phase 5's (bf16)
   K1 time, each tier's ms from the differences of K1 over tier
   prefixes, with its K1 launches counted by the wrapper (the phase's
   K1 count must equal the profile's), coverage within 10%, every
   fitted tier's measured/predicted ratio in [0.5, 2.0] and
   ``check_profile`` clean; the model's prediction at k=16 beside phase
   4's (reported, not gated); the profile's records into the run-local
   ledger; (b) ``obs/memview.memory_report`` of one fold step at k=128
   beside ``predicted_hbm_bytes(128)``, and K1 over the bulk prefix
   (tiers of at most 48 slots) against its plain version at each
   carriage with its bounds and ``torch.sparse.mm``; (c) the accuracy
   probe at k=16, 8 iterations, f32, bf16 and int8 on the card into the
   run-local ledger: the f32 curve all zeros, every point finite, the
   bf16 curve's first point within phase 4's 2e-2, and
   ``classes.find_certificate`` returning the card's bf16 curve; (d)
   ``graft_ledger`` rebaseline, check (exit 0) and report on the
   run-local ledger, ``export --round 99`` whose ``parsed`` is stamped
   "gpu" and the card's name (when phase 14 wrote its record), and
   ``graft_lens check`` on (a)'s profile and model (exit 0); (e) right
   after (a), the lens at K1's knob points with its load-depth sweep,
   ``profile_fold(kernel="pallas", ring_sweep=True)`` at f32 k=128:
   coverage within 10%, every fitted ratio in [0.5, 2.0],
   ``check_profile`` clean, every tier alone bit for bit equal at batch
   4 and batch 8, K1's launches as the profile counts them; its full
   step beside (a)'s, the wait a family and the model's batch-4
   prediction beside the fold step at batch 4 through
   ``MultiLevelArrow(kernel="pallas_sell", kernel_opts={"batch": 4})``
   (reported), and K1 at batch 4 over the fold against its plain version
   and equal to batch 8, with its time, bounds and ``torch.sparse.mm``
   (the ``sell_tier_spmm[lens-batch4]`` entry, its launches the step's).

19. graft-tune on the card, after phase 18 on phase 4's levels (a
   ``"dir"`` source): (a) ``tune.search`` at k = 16 over the restricted
   set (``default``, K1 through ``kernel_opts`` at its defaults and
   with one CTA an SM, the synthesized exact schedule ``synth_ladder``,
   ``fold_tight``, ``overlap2``, ``repl2``, ``bf16`` as a diagnostic;
   the other knobs off their defaults are (d)'s) and at k = 128 over
   four of them (``default``, ``pallas_sell``, ``pallas_sell_ctas1``,
   ``bf16``), each child a subprocess alone on the card
   (the next three import while it runs, and the next starts on the
   card as soon as it has printed its result): each child's
   ms/iter, bit identity to the golden default fold, K1 launches a
   step and where its seconds went, the pruned set with its reasons,
   the winner bit-identical and saved in a run-local plan cache;
   (b) a second search at each k, a pure hit with zero children;
   (c) ``MultiLevelArrow(plan="auto")`` at each k applies the winner,
   launches K1 with its knobs as often as the winner's child did, and
   equals the golden bit for bit; (d) K1 at every knob point of the
   contract (12: chunk 64/128/256, batch 4/8, one or two CTAs an SM)
   against the work list's twin on phase 3's random tiers (f32/bf16/
   int8, k 16 and 128; int8 bit for bit) and on the fold at k = 16
   (f32), the points that keep the order bit for bit equal to the
   default; each fold point first drives the main path,
   ``MultiLevelArrow.load_folded(kernel="pallas_sell", kernel_opts=
   point)`` over the race's exported fold, one step with the counts set
   to 0 just before it (the step equal to the golden, bit for bit where
   the point keeps the order), and is an entry of the kernels line (its
   time, the twin's, the bound, ``torch.sparse.mm``, and the launches
   of that step); (e) ``graft_tune check`` (its timed replay alone on
   the card, after (d)), the port's ``tools/tune_gate`` (``--no-timing``,
   a process beside (c), (f) and (d)'s random tiers) and ``python -m
   arrow_matrix_tpu_torch.analysis kernels --check`` (a host process
   from the phase's start) exit 0; (f) a
   search at BA n = 2^16 (k = 128) restricted to the 2^20 k = 128
   winner's K1 candidate (``pallas_sell`` when the winner is not one),
   an ``ArrowServer(tune_plan=)`` over ``ba_executor_factory(plan=)``
   serving three k = 128 requests with ``tune_plan_applied`` in the
   flight recorder, and an error plan walking the tenant from
   ``"pallas_sell"`` down to ``"xla"`` with the same bits.

20. the mesh executors on ranks, after phase 19 (MESH): (a) on 4 gloo
   ranks sharing the card (their tensors on the card; what gloo cannot
   move there staged through pinned host buffers and counted), the main
   path ``SellMultiLevel(routing="a2a")`` over phase 4's levels (read
   back from its artifact by each rank, which packed its own shards on
   the host in a process started once the artifact existed, beside the
   phases that follow, and moved them to the card when released): the
   f32 k=16 3-step chain with each rank's K1 and K4 launches equal to
   its executor's own count (``launch_counts``: K1's launches a product
   over every body and head operator of every level; K4's halo gather,
   head unsort, a2a pack and unpack) x steps, the counts set to 0 just
   before it; then k=128, a bf16 carriage, ``routing="gather"``,
   ``overlap_slabs=2`` and 2.5D ``repl`` 2 on a (blocks, repl) grid for
   one step each; every result within ``relative_tolerance`` of phase
   4's host golden (bf16 2e-2) and of the port's fold on rank 0;
   gather, overlap 2 and a repeat equal to the a2a step bit for bit;
   ms/iter (a transport through the host, not a speed of the executor)
   and one step's collective bytes by kind beside ``ideal_comm_bytes``
   and the host-staged bytes; (b) the same chain on one NCCL rank a
   card; (c) ``MultiLevelArrow(mesh=)`` over phase 7's graph (BA 2^16)
   on the 4 ranks: auto (slim, a2a), dense banded, and the wide layout
   on an (arm=2, blocks=2) grid, one k=16 step each against the host
   golden with its K1/K2/K3/K4 launches; (d) on rank 0, K1 over its
   shards' operators and K4's pack and unpack of its first exchange
   against their plain versions (K4 bit for bit; each timed eager and
   from one CUDA graph: these small products are launch-bound eager),
   and K2 and K3 over its dense banded (c) shards, each with time,
   bound, plain time and one PyTorch call; the probe, (a) and (c) run
   on the gloo ranks beside phase 19 (they time no kernel: their ms are
   transports through the host, taken while phase 19 loads the host),
   (d) after phase 19 with the card otherwise idle, (b) alone after it;
21. training through the mesh executors and the space-shared modes, in
   phase 20's rank pools: (b) and (c) on the gloo ranks right after
   phase 20's (c), beside phase 19, (d) after phase 20's (d), and (a)
   on the NCCL rank after phase 20's (b): (a) over
   phase 20 (b)'s ``SellMultiLevel`` at the 2^20 levels, ``GCNCarried``
   (dims 128, 128, 16) for 5 Adam steps (the first step's forward and
   gradients against float64 on the host, computed in a thread from
   phase 19 on; the losses finite and falling; ms a step), power iteration
   and CG (50 iterations each) against their host iterations, the
   transposed build packing nothing (the levels are symmetric); (b) on
   the 4 gloo ranks at phase 7's graph: a GCN train step over
   ``MultiLevelArrow(mesh=, fmt="ell", routing="a2a")`` and ``GCNCarried`` over
   ``SellMultiLevel`` a2a on ``D^-1 A`` (every level packed transposed:
   its build seconds and bytes), each 5 steps with its first step held
   to float64, losses and parameters equal bit for bit on every rank;
   power iteration, one eigenvalue on every rank within 1e-2 of the
   host's; (c) the same ranks as a (lvl=2, blocks=2) mesh over the
   first two levels of phase 7's decomposition (their sum the operator:
   the 2-level decomposition's grown last level is 36,679 wide, whose
   dense blocks would not fit the card): ``SellSpaceShared`` and
   ``SpaceSharedArrow`` dense and ell, one step at k=16 and at k=128
   and a chain of 3 against the host golden, and ``GCNCarried`` trained
   through ``SellSpaceShared``; every run's K1/K2/K3/K4 launches equal
   what its executor counts; (d) on rank 0, K1 over its transposed
   ``D^-1 A`` shards, K2 and K3 over its space-shared dense shard and
   K4 over its space routes, against their plain versions, timed
   beside bound, plain version and one PyTorch call.

22. the paper's two comparison baselines and the five-algorithm smoke,
   in phase 20's rank pools (BASE22): (a) on the NCCL rank after phase
   21 (a), at full width, the CLIs' own graph
   ``normalize_scale(random_adjacency(2^20, 2^24, seed 42))`` (16
   nonzeros a row, the main path's count; made, with its float64 host
   goldens, by a host process from the start), ``MatrixSlice1D`` over
   one slice and ``SpMM15D`` over a (1, 1) grid at k=16 and k=128: one
   step within ``relative_tolerance(16, 1)`` and a chain of 3 within
   ``(16, 3)``, each run's K1 (and K4) launches equal to
   ``launch_counts`` with the counts set to 0 just before it, a repeat
   bit for bit, ms/iter the median of 7 chains, and K1 over each one's
   operator against its plain version, timed beside its bytes bound and
   ``torch.sparse.mm`` on the same CSR; (b) on phase 20's 4 gloo ranks,
   beside phase 19, the same graph at k=16: ``MatrixSlice1D`` over 4
   slices and ``SpMM15D`` over (4, 1) and (2, 2), each one step and a
   chain of 3 against the goldens with its launches, each rank's
   counted bytes a step beside ``ideal_comm_bytes(16)``, the 1D pack
   (K4) bit for bit equal to ``index_select``, the (2, 2) replicas bit
   for bit equal; then the paper's comparison at phase 7's BA 2^16
   graph: the counted bytes of one step of 1D, 1.5D c=1, 1.5D c=2 and
   ``SellMultiLevel`` a2a over its decomposition beside each one's
   ideal, on one line; after phase 21 (d), with the card otherwise
   idle, K1 over one step's operators of gloo rank 0 (the 1D local and
   nonlocal stacks; the four (4, 1) round blocks) and K4's pack, each
   timed beside its bound (the feature rows it references read once),
   plain version and one PyTorch call, with (b)'s launches; (c) beside phase 19, as subprocesses:
   ``graft_trace smoke --devices 4`` on the card at the smoke's
   defaults (its run directory valid, ``summarize``, ``export`` and
   ``diff run run`` exit 0), and ``spmm_arrow --obs_dir --mem_report
   --trace`` over phase 4's saved 2^20 artifact on one card for 3
   iterations (its profiler trace names K1).

23. serving and state on a mesh of ranks, in phase 20's rank pools
   (STATE): (a) on the NCCL rank after phase 22 (a), phase 15's
   deployment (32 requests, 4 tenants, k = 16, 10 iterations, batched
   to k = 128, its first request phase 4's k=16 input) through
   ``ArrowServer`` over ``MultiLevelArrow(mesh=the one NCCL rank,
   fmt="ell")`` at phase 4's 2^20 levels (built on that rank beside the
   earlier phases): every ticket completed, K1's and K4's launches
   exactly ``launch_counts(128)`` x batches x iterations (the counts set
   to 0 just before the trace), each batch's first request served alone
   equal to its slice bit for bit, phase 4's input within the 10-step
   gate of phase 4's golden; requests/s, p50/p99 and per-batch device
   and host ms beside phase 15's; then K1 over one step's shard
   operators and K4 over one step's routing at k = 128 against their
   plain versions, timed beside bound and one PyTorch call; (b) on
   phase 20's 4 gloo ranks beside phase 19 (they time no kernel), the
   same trace at phase 7's graph served in lockstep (rank 0 decides)
   over ``MultiLevelArrow(mesh=, fmt="ell", routing="a2a")``, every rank's results equal
   bit for bit, each within ``relative_tolerance`` of the host golden,
   each rank's launches its executor's count, and on each rank a
   request's admission price (``carriage_hbm_bytes``, with the a2a
   exchange scratch) beside the rank's measured growth of
   ``max_memory_allocated`` over one k=128 step (reported, not gated);
   ``grow`` from ranks (0, 1)
   to all 4 (``fmt="auto"``) with 8 step-2 checkpoints (phase 15's
   gate: 8 requests of 4 iterations), every request resumed at 2 and
   equal bit for bit to a never-grown 4-rank server resuming the same
   states; and the port's ``tools/reshard_gate.py`` (kill mid-migration)
   on gloo ranks on the card; (c) ``spmm_arrow --devices 2 --fmt sell
   --carry --checkpoint --checkpoint_every 1 --validate`` on gloo ranks,
   2 then 4 iterations, the second resuming at 2; (d) ``spmm_arrow
   --memmap --validate --carry --checkpoint`` over phase 4's artifact on
   1 rank (the fold) and 4 gloo ranks (sell), each final carriage equal
   bit for bit to the same executor's over the loaded levels from the
   same input (phase 4's fold; phase 20's ``SellMultiLevel`` on the
   gloo ranks); after (a) on the
   NCCL rank, ``arrow_blocks_streamed`` of level 0 byte for byte equal
   to the eager pack; the peak host RSS of that pack (sampled from
   ``/proc/self/statm``: a spawned process's ``ru_maxrss`` starts at its
   parent's) streamed from the memmapped artifact and from the artifact
   loaded whole, each in a process of its own;
   (e) the two processes of ``plan_host_mesh(2, 1)`` joining one gloo
   group on the card host (an all-reduce over it sums both).  The
   subprocesses of (b)-(e) run one after the other in a thread from
   phase 4 on (beside phase 19 alone they starved its race) and are
   collected after phase 22; (d)'s one-rank reference is phase 4's
   fold's.

24. the analysis family and the doctor on the card (ANALYSIS), as
   subprocesses one after the other in a thread of their own from phase
   4 on, beside phase 23's, at the lowest CPU priority (they time no
   kernel, and take only the cores the phases leave idle), collected
   last, after phase 17: (a) ``python -m arrow_matrix_tpu_torch.analysis prove --device
   cuda --check``: the 20 entries on 4 gloo ranks sharing the card, each
   ok, the 4 skips, no drift from the CPU-made manifest, and each rank's
   K1/K4 launches in a step equal to its executor's ``launch_counts``
   (14 entries; the folds and the reshard routes have none); (b)
   ``analysis audit --device cuda --check``: the four entry points'
   second calls load, build and keep nothing, launch what the first did,
   and leave ``memory_allocated`` where it was; (c) ``analysis lint``
   and ``analysis sync --check`` over the port's tree; (d)
   ``amt_doctor_torch`` on the card: every core check passes and the
   card answers; and (e), in a second thread beside the first, at the
   same priority, from a working directory of its own (GATES24): the
   port's ``tools.chaos_gate --fast``, ``tools.obs_gate``,
   ``tools.kernel_gate`` (K1 at every certified knob point on the card
   after the certification), ``tools.comm_report`` on 4 gloo ranks,
   ``spmm_arrow --logdir`` then ``log_upload`` listing its run, and
   ``graft_lens profile --kernel pallas --ring-sweep`` at BA 2^16 (m=8,
   width 2048, seed 7), each with ``--device cuda``.  Each exits 0;
   their seconds are logged.

25. the planar class (PLANAR), after phase 5: ``tools/planar_bench.py``'s
   graph through the port's own code, ``grid_graph(1024)`` (n = 2^20,
   4,190,208 nonzeros; the JAX default side 4096 is cut for the time
   limit) scrambled by ``default_rng(3).permutation``, decomposed at
   width 1280 (side x 5/4; max_levels 10, seed 7) in a process of its
   own from the start into exactly one level (the RCM fast
   path); the fold and the tight packing (growth 1.1, align 1), their
   tier ladders logged, stepped at f32 k = 16 and 128 from inputs
   permuted on the card as ``set_features`` permutes them (the host
   goldens, made and saved by its host process, are read back one by
   one): every step from the host golden's input within
   ``relative_tolerance(nnz/n, 1)`` of the next host golden, and a
   10-step ``run`` within ``(nnz/n, 10)``, K1's launches its launches a
   product x products with the counts set to 0 just before; then
   ``hyb_spmm_t`` and ``ell_spmm_t`` over the level's HYB form at k=16,
   each K1 against its plain version and repeated bit for bit; then K1
   on both packings at both k against its plain version, repeated bit
   for bit, timed (median of 20) beside its bytes bound, its
   gathered-bytes bound, the plain version and ``torch.sparse.mm``.

The phases run in the order 1-3, 6-9, 12, 14, 4, 5, 25, 11, 13, 15, 16, 10,
18, 19, 17, 20, 21, 22, 23, 24: the host work of phase 4
(generating the 2^20 graph, decomposing it with the numpy decomposer,
the host goldens of its inputs, beside the decomposition) and of phase
14 (the native decomposition) runs in processes of their own from the
start, beside the build and phases 3, 6-9, 12 and 14; so, at niceness
19 (they take the cores the phases leave idle; their readers come
later), does that of phase 22 (its graph and goldens), phase 13 (its
float64 goldens, once phase 4's graph is saved), phase 25 (the grid,
its decomposition and goldens) and phase 17 (decomposing the fleet's
graph); phase 20's ranks pack their shards from the moment phase 4's
artifact is saved; phase 23's subprocesses run one after the other from
phase 4 on, at niceness 19, and phase 24's beside them; phases 20-23's
rank work that times no kernel runs beside phases 19 and 17.

``--dense`` runs phases 1, 2 and 6-8 alone (the dense path and its
kernels K2 and K3), ``--bench`` phases 1, 2 and 14 (its kernels line is
empty: the bench's launches are in its candidates' records), ``--serve``
phases 1, 2, 15 and 16 (phase 4's decomposition and golden made first),
``--fleet`` phases 1, 2 and 17, ``--lens`` phases 1, 2 and 18 (phase
4's decomposition made first; (d) then has no bench record to export),
``--tune`` phases 1, 2 and 19 (phase 4's decomposition made first),
``--mesh`` phases 1, 2 and 20-23 (phase 4's decomposition and the
goldens phases 20 and 23 gate against made first), ``--state`` phases
1, 2 and 23 (the same, on rank pools of its own), ``--analysis`` phases
1, 2 and 24, ``--planar`` phases 1, 2 and 25.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 2 and prints no result.

Every 5 s a thread writes where the host's cores went (the cores of
this process's main thread, of its other threads and of each process
it started) as a JSON line to ``AMT_SMOKE_CPU_TRACE`` (by default
``arrow_matrix_tpu_torch/_build/smoke_cpu_trace.jsonl``).

The script stops every process it starts.  It makes itself the reaper
of its descendants' orphans (``PR_SET_CHILD_SUBREAPER``), and at its end,
whether a phase failed or not, it stops the multiprocessing resource
tracker, then stops and reaps any process still below it, naming each
on standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import shutil
import statistics
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32, outside the tensor cores
SOURCES = {"K1": "arrow_matrix_tpu_torch/csrc/sell_tier_spmm.cu",
           "K2": "arrow_matrix_tpu_torch/csrc/arrow_blocks_spmm.cu",
           "K3": "arrow_matrix_tpu_torch/csrc/arrow_blocks_spmm.cu",
           "K4": "arrow_matrix_tpu_torch/csrc/granule_gather.cu"}
REPLACES = {"K1": "arrow_matrix_tpu/ops/pallas_sell.py:298",
            "K2": "arrow_matrix_tpu/ops/pallas_blocks.py:175",
            "K3": "arrow_matrix_tpu/ops/pallas_blocks.py:261",
            "K4": "tools/pallas_gather_probe.py:81"}
#: Phase 9's (n, S) of the granule entry: the two shapes of the JAX
#: package's CPU checks, the probe's full size, and a ragged one.
GRANULE_SHAPES = ((1 << 10, 256), (1 << 14, 1 << 12), (1 << 20, 1 << 21),
                  (1000, 360))
#: Phase 9's (n, S, k, misaligned) of the row gather and gather-add: odd
#: widths, both bodies, the probe's shape and the routing's (S = n: a
#: permutation of 2^20 rows).
ROW_SHAPES = ((5000, 20_011, 1, False), (5000, 20_011, 3, False),
              (5000, 20_011, 4, True), (5000, 20_011, 36, False),
              (5000, 20_011, 36, True), (1 << 20, 1 << 21, 16, False),
              (1 << 20, 1 << 20, 16, False), (1 << 20, 1 << 20, 128, False))
REPS = 7                       # timed runs of each main-path chain
#: Timed runs of each of phase 11's chains, eager and from a graph, and
#: phase 10's of each gather rate: fewer than REPS, for the script's time
#: limit (PERF.md lists each cut with its seconds).
FORMAT_REPS = 3
RATE_REPS = 5
#: Steps of phase 4's fold validated one by one against the host golden
#: and then as one chain, by k (a validated step at k=128 costs seconds
#: of host work at n = 2^20, so its chain is cut to 2 steps for the time
#: limit).
VALIDATED = {16: 10, 128: 2}
#: Phase 4's inputs: (k, seed of ``random_dense``).
GOLDEN_INPUTS = ((16, 3), (128, 4))
#: K1's carriage dtypes by name (resolved when torch is imported).
CARRIAGE_DTYPES = {}
#: Phase 5 times K1 over the bulk tiers (rows of at most this many
#: slots) and the rest apart.
BULK_SLOTS = 48

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.1f}s] {msg}", flush=True)


def counters() -> tuple:
    """(K1, K2, K3, K4 gathers, K4 gather-adds) launches so far."""
    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell

    return (cuda_sell.LAUNCHES, cuda_blocks.LAUNCHES_K2,
            cuda_blocks.LAUNCHES_K3, cuda_gather.LAUNCHES,
            cuda_gather.LAUNCHES_ADD)


def reset_counters() -> None:
    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell

    cuda_sell.LAUNCHES = 0
    cuda_blocks.LAUNCHES_K2 = cuda_blocks.LAUNCHES_K3 = 0
    cuda_gather.LAUNCHES = cuda_gather.LAUNCHES_ADD = 0


def demangle(text: str) -> str:
    """``text`` with C++ symbols demangled by ``c++filt`` where the
    machine has it."""
    import subprocess

    tool = shutil.which("c++filt")
    if tool is None:
        return text
    return subprocess.run([tool], input=text, capture_output=True,
                          text=True).stdout


def graph_ms(fn, reps: int) -> tuple:
    """(median ms, result) of ``fn`` captured once in a CUDA graph and
    replayed: the same kernels with no host work between launches."""
    import torch

    from arrow_matrix_tpu_torch.utils.timing import cuda_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return cuda_ms(graph.replay, reps), out


def device_relative_error(got, want) -> float:
    """``relative_error`` (float64 Frobenius norms) of two card tensors,
    taken on the card."""
    import torch

    diff = torch.linalg.vector_norm(got.double() - want.double())
    return float(diff / torch.linalg.vector_norm(want.double()).clamp_min(
        1e-30))


def card_relative_error(got, want) -> float:
    """``relative_error`` of two host arrays, taken on the card: the
    float64 norms of a 2^20 x 128 result cost seconds of the host's
    cores, which the phases' host processes keep busy."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    return device_relative_error(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (got, want)))


def compare(got, want, row_nnz: float, exact: bool) -> tuple:
    """(max abs error, pass) of a kernel result against the plain one:
    bitwise for exact int8 sums, one ulp in bf16, else the relative
    Frobenius error within ``relative_tolerance(row_nnz)``."""
    import torch

    from arrow_matrix_tpu_torch.utils import (
        bf16_within_one_ulp,
        relative_tolerance,
    )

    if not bool(torch.isfinite(got.float()).all()):
        return float("nan"), False
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    if exact:
        return err, bool(torch.equal(got, want))
    if got.dtype == torch.bfloat16:
        return err, bf16_within_one_ulp(got, want, row_nnz)
    return err, device_relative_error(got, want) <= relative_tolerance(
        row_nnz)


def random_tier(rng, m_t: int, n_t: int, n_table: int) -> tuple:
    """(cols, deg, vals) of a random ragged tier: row r holds deg[r]
    slots, the padding points at row 0 with weight 0, and slot 0 of row
    0 gathers the last row of x."""
    import numpy as np

    deg = rng.integers(0, m_t + 1, n_t).astype(np.int32)
    pad = np.arange(m_t)[:, None] >= deg[None, :]
    cols = rng.integers(0, n_table, (m_t, n_t)).astype(np.int32)
    cols[pad] = 0
    if cols.size:
        cols[0, 0] = n_table - 1
    vals = np.where(pad, 0.0, rng.uniform(-1, 1, (m_t, n_t))
                    ).astype(np.float32)
    return cols, deg, vals


#: Phase 3's multi-tier operators: a zero-slot tier, bulk tiers, a mid
#: tier, hub tiers and a 6,000-slot hub row (split across CTAs).
MULTI_TIER_SHAPES = ((0, 37), (8, 20_000), (16, 9_000), (40, 3_000),
                     (72, 700), (700, 40), (2_000, 5), (6_000, 1))


def phase_random_tiers(dev) -> None:
    """Phase 3: K1 against its plain version on random ragged tiers, one
    at a time and all in one launch."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell, sell, worklist
    from arrow_matrix_tpu_torch.ops.ell import ell_tier_spmm, out_dtype_for

    rng = np.random.default_rng(0)
    n_table = 50_000
    checks = 0
    # k=20 takes the kernel's scalar-load path (20 * 2 bytes is not a
    # whole number of 16-byte loads).
    for k in (16, 64, 128, 20):
        x32 = torch.from_numpy(
            rng.uniform(-1, 1, (n_table, k)).astype(np.float32)).to(dev)
        xs = {"f32": x32, "bf16": x32.to(torch.bfloat16),
              "int8": torch.from_numpy(rng.integers(
                  -127, 128, (n_table, k)).astype(np.int8)).to(dev)}
        # 700 slots: a hub-like tier, whose rows K1 cuts into chunks.
        for m_t in (1, 5, 16, 40, 700):
            n_t = int(rng.integers(1, 3000 if m_t < 100 else 300))
            cols, deg, vals = random_tier(rng, m_t, n_t, n_table)
            c = torch.from_numpy(cols).to(dev)
            for binary in (True, False):
                w = dict(deg=torch.from_numpy(deg).to(dev)) if binary \
                    else dict(data=torch.from_numpy(vals).to(dev))
                for name, x in xs.items():
                    out = torch.empty((n_t, k), dtype=out_dtype_for(x.dtype),
                                      device=dev)
                    got = cuda_sell.sell_tier_spmm(c, x, out, **w)
                    want = ell_tier_spmm(c, x, **w)
                    torch.cuda.synchronize()
                    err, ok = compare(got, want, float(deg.mean()),
                                      exact=name == "int8" and binary)
                    checks += 1
                    if not ok:
                        raise SystemExit(
                            f"kernel != plain on a random tier: k={k} "
                            f"m_t={m_t} n_t={n_t} binary={binary} "
                            f"{name}: max abs err {err:.3e}")
            log(f"random tiers k={k:3d} m_t={m_t:3d} n_t={n_t:4d}: "
                f"f32/bf16/int8 x binary/weighted agree")
        n_m = sum(n_t for _, n_t in MULTI_TIER_SHAPES)
        for binary in (True, False):
            parts = [random_tier(rng, m_t, n_t, n_m)
                     for m_t, n_t in MULTI_TIER_SHAPES]
            starts = np.cumsum([0] + [n_t for _, n_t in
                                      MULTI_TIER_SHAPES[:-1]])
            m = sell.sell_from_arrays(
                [p[0] for p in parts],
                None if binary else [p[2] for p in parts],
                [p[1] for p in parts] if binary else None,
                n_m, starts, device=dev)
            for name, x_all in xs.items():
                x = x_all[:n_m]
                before = cuda_sell.LAUNCHES
                got = cuda_sell.sell_spmm_cuda(m, x)
                again = cuda_sell.sell_spmm_cuda(m, x)
                wl = next(iter(p.wl for key, p in m.plans.items()
                               if key[:2] == (k, x.dtype)))
                twin = worklist.sell_spmm_worklist(m, x, wl)
                want = sell.sell_spmm(m, x)
                torch.cuda.synchronize()
                if cuda_sell.LAUNCHES - before != 2 * wl.launches:
                    raise SystemExit("multi-tier product: launch count "
                                     "is not the work list's")
                if not torch.equal(got, again):
                    raise SystemExit(
                        f"K1 not deterministic: multi-tier k={k} "
                        f"binary={binary} {name}: two launches differ")
                for ref_name, ref in (("plain", want), ("twin", twin)):
                    err, ok = compare(got, ref, 6000.0,
                                      exact=name == "int8" and binary)
                    checks += 1
                    if not ok:
                        raise SystemExit(
                            f"K1 != {ref_name} on a multi-tier operator: "
                            f"k={k} binary={binary} {name}: max abs err "
                            f"{err:.3e}")
            log(f"multi-tier k={k:3d} binary={binary}: "
                f"{len(MULTI_TIER_SHAPES)} tiers in one launch "
                f"(+{wl.launches - 1} split pass, {wl.n_parts} partials "
                f"in the last carriage) agree with plain and twin, "
                f"repeated bit for bit")
    log(f"phase 3: {checks} kernel-vs-plain checks passed")


def ladder(sell) -> list:
    """The operator's tier shapes ``(m_t, n_t)``, in tier order."""
    return [tuple(int(d) for d in c.shape) for c in sell.cols]


def k1_per_product(sell, k: int, dtype) -> int:
    """K1's launches in one product of ``sell`` at ``k`` features of
    ``dtype`` with 16-byte loads, stated from the kernel's contract and
    not from its work list: a row takes one lane per 16 bytes, rounded
    up to a power of two of at most 32 lanes, in a CTA of 256 threads,
    and a lane walks at most 128 slots of its row.  A row longer than
    ``256 / lanes * 128`` slots is split across CTAs, and then a second
    launch adds its partials.  (At BA n = 2^20 the hub row of 5,792
    slots gives one launch at k=16 and two at k=128, each carriage.)"""
    lanes = min(32, 1 << (-(-k * dtype.itemsize // 16) - 1).bit_length())
    hub = max(m_t for m_t, _ in ladder(sell))
    return 1 + (hub > 256 // lanes * 128)


def host_golden(levels, x, cores=None):
    """``decomposition_spmm(levels, x)`` on the host (``levels`` a sparse
    matrix: ``levels @ x``), over blocks of feature columns in parallel
    threads, one block a core (SpMM is separable per column and scipy
    sums each element over its row in the same order whatever the
    block's width, so the result is the same bit for bit; scipy's
    sparse products release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from scipy import sparse

    from arrow_matrix_tpu_torch.decomposition import decomposition_spmm

    def product(b):
        if sparse.issparse(levels):
            return levels @ b
        return decomposition_spmm(levels, b)

    cores = cores or os.cpu_count() or 1
    width = max(1, -(-x.shape[1] // cores))
    blocks = [np.ascontiguousarray(x[:, lo:lo + width])
              for lo in range(0, x.shape[1], width)]
    with ThreadPoolExecutor(max_workers=min(len(blocks), cores)) as pool:
        parts = list(pool.map(product, blocks))
    return np.concatenate(parts, axis=1)


def sorted_csr(sell, dtype):
    """A K1 operator (the fold in sorted coordinates, or a level's ELL
    or HYB operator) as a torch CSR on the card (the ``library_ms``
    yardstick's operand)."""
    import torch

    dev = sell.device
    rows = [torch.zeros(0, dtype=torch.int64, device=dev)]
    cols = [torch.zeros(0, dtype=torch.int64, device=dev)]
    vals = [torch.zeros(0, dtype=torch.float32, device=dev)]
    for t in sell.live_tiers():
        c = sell.cols[t]
        m_t, n_t = c.shape
        slot = torch.arange(m_t, device=c.device)[:, None]
        if sell.binary:
            live = slot < sell.deg[t][None, :]
            v = torch.ones_like(c, dtype=torch.float32)
        else:
            live = sell.data[t] != 0
            v = sell.data[t]
        r = (sell.row_starts[t]
             + torch.arange(n_t, device=c.device))[None, :].expand(m_t, n_t)
        rows.append(r[live])
        cols.append(c[live].long())
        vals.append(v[live])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    shape = (sell.n_rows, sell.x_rows or sell.n_rows)
    a = torch.sparse_coo_tensor(idx, torch.cat(vals).to(dtype),
                                shape).coalesce()
    return a.to_sparse_csr()


def ptxas_registers(text: str) -> list:
    """(entry, registers, spill store bytes) of each kernel instance in
    a ``-Xptxas -v`` report, entries demangled where ``c++filt`` is."""
    import re

    out, entry = [], None
    spill = 0
    for line in demangle(text).splitlines():
        m = re.search(r"Compiling entry function '(.+)' for", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1)), spill))
            entry = None
    return out


def phase_k1_numbers(exes: dict, launches: dict, n: int, row_nnz: float,
                     main: dict, phase: str = "phase 5") -> list:
    """Phase 5: K1 at the main path's shapes, one entry of the kernels
    line per (operator, carriage, k) the main path ran (``exes`` the
    fold executors by operator name), each held against its plain
    version and repeated bit for bit."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    kernels = []
    lib_ops, inputs = {}, {}
    for key in launches:
        op_name, carriage, k = key
        exe = exes[op_name]
        sell = exe.sell
        exe.feature_dtype = CARRIAGE_DTYPES[carriage]
        if k not in inputs:
            inputs[k] = random_dense(n, k, seed=5)
        xt = exe.set_features(inputs[k])
        x = xt[0] if carriage == "int8" else xt
        got = cuda_sell.sell_spmm_cuda(sell, x)
        again = cuda_sell.sell_spmm_cuda(sell, x)
        want = sell_spmm(sell, x)
        torch.cuda.synchronize()
        err, ok = compare(got, want, row_nnz,
                          exact=carriage == "int8" and sell.binary)
        if not ok:
            raise SystemExit(f"{phase} {key}: kernel != plain on the real "
                             f"operator (max abs err {err:.3e})")
        if not torch.equal(got, again):
            raise SystemExit(f"{phase} {key}: a repeat differs")
        del got, again, want
        runs = cuda_runs(lambda: cuda_sell.sell_spmm_cuda(sell, x), 20)
        ms = statistics.median(runs)
        tag = f"{op_name}_{carriage}_k{k}"
        main[f"{tag}_k1_ms_runs"] = runs
        plain_ms = cuda_ms(lambda: sell_spmm(sell, x), 3)
        library_ms = None
        if carriage != "int8":
            lib_key = (op_name, x.dtype)
            if lib_key not in lib_ops:
                lib_ops[lib_key] = sorted_csr(sell, x.dtype)
            a_csr = lib_ops[lib_key]
            library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 5)
        item = x.element_size()
        out_item = 4 if carriage in ("f32", "int8") else 2
        bytes_, flops = fold_work(sell, exe.nnz, k, item, out_item)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        # A gather reads a row per nonzero (binary rows stop at their
        # degree; weighted padding multiplies row 0 by zero, counted
        # here as not read), plus its column index, and writes the
        # output once.
        gathered = exe.nnz * (k * item + 4) + sell.n_rows * k * out_item
        gather_ms = gathered / HBM_BYTES_PER_S * 1e3
        main[f"{tag}_k1_gather_bound_ms"] = gather_ms
        kernels.append({
            "name": f"sell_tier_spmm[{op_name},{carriage},k={k}]",
            "route": "cuda", "source": SOURCES["K1"],
            "replaces": REPLACES["K1"],
            "launches": launches[key], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "gather_bound_ms": gather_ms})
        per = k1_per_product(sell, k, x.dtype)
        log(f"{phase} {op_name} {carriage} k={k}: K1 {ms:.4f} ms/product "
            f"eager (median of 20, min {min(runs):.4f}, max "
            f"{max(runs):.4f}; {per} launch{'es' if per > 1 else ''}); "
            f"bound {bound:.4f} ms with X read once ({bytes_} B; "
            f"{100 * bound / ms:.1f}%), {gather_ms:.4f} ms with every "
            f"gathered row read "
            f"({gathered} B; {100 * gather_ms / ms:.1f}% eager), plain "
            f"{plain_ms:.4f} ms, "
            f"torch.sparse.mm "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}; "
            f"kernel vs plain max abs err {err:.3e}, repeated bit for bit")
    return kernels


def block_stack_names(banded: bool) -> tuple:
    return ("diag", "col", "lo", "hi") if banded else ("diag", "col")


def phase_block_kernels(dev) -> None:
    """Phase 6: K2 and K3 against their plain versions on random stacks."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops import arrow_blocks, cuda_blocks
    from arrow_matrix_tpu_torch.utils import (
        relative_error,
        relative_tolerance,
    )

    rng = np.random.default_rng(1)
    checks = 0
    # (33, 200): off every row and contraction tile, K3 split 33 ways.
    for nb, w in ((3, 48), (5, 64), (33, 200), (4, 2048)):
        f32 = {name: torch.from_numpy(rng.uniform(
            -1, 1, (nb, w, w)).astype(np.float32)).to(dev)
            for name in ("head", "diag", "col", "lo", "hi")}
        tol = relative_tolerance(w)
        worst = {"f32": 0.0, "bf16": 0.0, "bf16_vs_f32": 0.0}
        max_abs = 0.0
        for k in (8, 16, 128):
            x = torch.from_numpy(rng.uniform(-1, 1, (nb, w, k)).astype(
                np.float32)).to(dev)
            for banded in (False, True):
                names = block_stack_names(banded)
                want32 = (arrow_blocks.column_spmm(
                    *(f32[n] for n in names[:2]), x,
                    *(f32[n] for n in names[2:])),
                    arrow_blocks.head_spmm(f32["head"], x))
                for dtype, key in ((torch.float32, "f32"),
                                   (torch.bfloat16, "bf16")):
                    m = {n: t.to(dtype) for n, t in f32.items()}
                    got = (cuda_blocks.column_spmm(
                        *(m[n] for n in names[:2]), x,
                        *(m[n] for n in names[2:])),
                        cuda_blocks.head_spmm(m["head"], x))
                    want = (arrow_blocks.column_spmm(
                        *(m[n] for n in names[:2]), x,
                        *(m[n] for n in names[2:])),
                        arrow_blocks.head_spmm(m["head"], x))
                    again = (cuda_blocks.column_spmm(
                        *(m[n] for n in names[:2]), x,
                        *(m[n] for n in names[2:])),
                        cuda_blocks.head_spmm(m["head"], x))
                    torch.cuda.synchronize()
                    if not all(map(torch.equal, got, again)):
                        raise SystemExit(
                            f"K2/K3 not deterministic: nb={nb} w={w} k={k} "
                            f"banded={banded} {key}: two launches differ")
                    for g, wt, w32 in zip(got, want, want32):
                        g, wt, w32 = (t.cpu().numpy() for t in (g, wt, w32))
                        err = relative_error(g, wt)
                        max_abs = max(max_abs, float(np.abs(g - wt).max()))
                        worst[key] = max(worst[key], err)
                        ok = bool(np.isfinite(g).all()) and err <= tol
                        if key == "bf16":
                            err32 = relative_error(g, w32)
                            worst["bf16_vs_f32"] = max(
                                worst["bf16_vs_f32"], err32)
                            ok = ok and err32 <= 2e-2
                        checks += 1
                        if not ok:
                            raise SystemExit(
                                f"K2/K3 != plain: nb={nb} w={w} k={k} "
                                f"banded={banded} {key}: rel err {err:.3e}"
                                f" (gate {tol:.1e})")
        log(f"dense kernels nb={nb} w={w} (K3 split "
            f"{cuda_blocks.head_split(nb, w, 16)} ways at k=16): every "
            f"result bit for bit repeated; worst rel err f32 "
            f"{worst['f32']:.3e}, bf16 {worst['bf16']:.3e} (gate "
            f"{tol:.1e}); bf16 blocks vs f32 blocks "
            f"{worst['bf16_vs_f32']:.3e} (gate 2e-2); max abs err "
            f"{max_abs:.3e}")
    log(f"phase 6: {checks} K2/K3-vs-plain checks passed, each "
        f"repeated bit for bit")


def block_work(blocks, k: int, kernel: str) -> tuple:
    """(bytes, operations) the function of K2 or K3 needs on one level:
    each block it reads once, the features once, its output written
    once; 2 w^2 k operations per block product."""
    nb, w = blocks.n_blocks, blocks.width
    item = blocks.dtype.itemsize
    if kernel == "K3":
        pairs, out_blocks = nb, 1
    else:
        pairs, out_blocks = 2 * (nb - 1), nb - 1
        if blocks.banded:
            pairs += (nb - 1) + max(nb - 2, 0)
    bytes_ = pairs * w * w * item + (nb + out_blocks) * w * k * 4
    return bytes_, pairs * 2 * w * w * k


def dense_kernel_numbers(blocks_list, k: int, launches: tuple, tag: str,
                         tol: float, dev, phase: str) -> tuple:
    """K2 and K3 at the shapes of ``blocks_list`` (the dense levels of one
    executor) at ``k`` features: held against their plain versions on
    the real blocks, timed (median of 20), with their bound, the plain
    versions' time and the same function through cuBLAS (f32 blocks).
    Returns (kernel entries, {name: runs})."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops import arrow_blocks, cuda_blocks
    from arrow_matrix_tpu_torch.utils import relative_error
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    dtype = "bf16" if blocks_list[0].dtype == torch.bfloat16 else "f32"
    rng = np.random.default_rng(k)
    xs = [torch.from_numpy(rng.uniform(-1, 1, (b.n_blocks, b.width, k))
                           .astype(np.float32)).to(dev)
          for b in blocks_list]
    outs = [torch.zeros_like(x) for x in xs]

    def k2():
        for b, x, o in zip(blocks_list, xs, outs):
            cuda_blocks.column_spmm(b.diag_data, b.col_data, x,
                                    b.lo_data, b.hi_data, out=o)

    def k3():
        for b, x, o in zip(blocks_list, xs, outs):
            cuda_blocks.head_spmm(b.head_data, x, out=o[0])

    def plain2():
        return [arrow_blocks.column_spmm(b.diag_data, b.col_data, x,
                                         b.lo_data, b.hi_data)
                for b, x in zip(blocks_list, xs)]

    def plain3():
        return [arrow_blocks.head_spmm(b.head_data, x)
                for b, x in zip(blocks_list, xs)]

    def lib2():
        res = []
        for b, x in zip(blocks_list, xs):
            c = torch.baddbmm(torch.matmul(b.col_data[1:], x[0]),
                              b.diag_data[1:], x[1:])
            if b.banded:
                c.baddbmm_(b.lo_data[1:], x[:-1])
                c[:-1].baddbmm_(b.hi_data[1:-1], x[2:])
            res.append(c)
        return res

    def lib3():
        return [torch.einsum("bij,bjk->ik", b.head_data, x)
                for b, x in zip(blocks_list, xs)]

    # Held against the plain versions on the real blocks.
    k2()
    k3()
    want2, want3 = plain2(), plain3()
    torch.cuda.synchronize()
    errs = {}
    for name, pairs in (
            ("K2", [(o[1:], w[1:]) for o, w in zip(outs, want2)]),
            ("K3", [(o[0], w) for o, w in zip(outs, want3)])):
        err = 0.0
        for got, want in pairs:
            got, want = got.cpu().numpy(), want.cpu().numpy()
            rel = relative_error(got, want)
            if not (np.isfinite(got).all() and rel <= tol):
                raise SystemExit(f"{name} {tag}: kernel != plain on the "
                                 f"real blocks (rel err {rel:.3e} > "
                                 f"{tol:.1e})")
            err = max(err, float(np.abs(got - want).max()))
        errs[name] = err
    del want2, want3
    kernels, all_runs = [], {}
    for name, fn, plain_fn, lib_fn, idx in (
            ("K2", k2, plain2, lib2, 0), ("K3", k3, plain3, lib3, 1)):
        runs = cuda_runs(fn, 20)
        ms = statistics.median(runs)
        plain_ms = cuda_ms(plain_fn, 5)
        library_ms = cuda_ms(lib_fn, 5) if dtype == "f32" else None
        work_ = [block_work(b, k, name) for b in blocks_list]
        bytes_ = sum(b for b, _ in work_)
        ops = sum(o for _, o in work_)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        kname = ("column_blocks_spmm" if name == "K2"
                 else "head_blocks_spmm")
        kernels.append({
            "name": f"{kname}[{tag}]", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[idx], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": bound_by,
            "library_ms": library_ms})
        all_runs[name] = runs
        lib = ("n/a (no cuBLAS call takes bf16 blocks with f32 "
               "features)" if library_ms is None
               else f"{library_ms:.4f} ms")
        split = "" if name == "K2" else ", split " + "/".join(
            str(cuda_blocks.head_split(b.n_blocks, b.width, k))
            for b in blocks_list)
        per_step = (sum(b.n_blocks > 1 for b in blocks_list)
                    if name == "K2" else len(blocks_list))
        log(f"{phase} {name} {tag}: {ms:.4f} ms/step (median of 20, min "
            f"{min(runs):.4f}, max {max(runs):.4f}; {per_step} "
            f"launches{split}), bound {max(t_bytes, t_ops):.4f} ms by "
            f"{bound_by} ({bytes_} B, {ops} ops), plain {plain_ms:.4f} ms, "
            f"cuBLAS {lib}; kernel vs plain max abs err {errs[name]:.3e}")
    del xs, outs
    return kernels, all_runs


def dense_path(dev, n: int, work: str):
    """Phases 7 and 8: the dense main path and its kernels' numbers.
    Returns (results, kernel entries)."""
    import torch

    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import (
        as_levels,
        load_decomposition,
        load_level_widths,
        save_decomposition,
    )
    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import (
        barabasi_albert,
        random_dense,
        relative_error,
        relative_tolerance,
    )
    from arrow_matrix_tpu_torch.utils.timing import cuda_runs

    m, width, seed = 8, 2048, 7
    base = os.path.join(work, f"ba_{n}_{m}_dense")
    tic = time.perf_counter()
    a = barabasi_albert(n, m, seed=seed)
    t_gen = time.perf_counter() - tic
    tic = time.perf_counter()
    levels = arrow_decomposition(a, width, max_levels=10,
                                 block_diagonal=True, seed=seed)
    t_dec = time.perf_counter() - tic
    save_decomposition(levels, base, block_diagonal=True)
    levels = as_levels(load_decomposition(base, width, block_diagonal=True),
                       load_level_widths(base, width, True))
    del a
    nnz = sum(int(lvl.matrix.nnz) for lvl in levels)
    log(f"phase 7: BA n={n} m={m}: {nnz} nnz; generate {t_gen:.1f} s, "
        f"decompose {t_dec:.1f} s ({len(levels)} levels, nnz "
        f"{[int(lvl.matrix.nnz) for lvl in levels]}); artifact saved and "
        f"loaded")

    # The main path: every count at 0 just before, read just after.
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    exes = {}
    for dtype in ("f32", "bf16"):
        tic = time.perf_counter()
        exe = MultiLevelArrow(levels, width, fmt="dense", dtype=dtype,
                              device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - tic
        exes[dtype] = exe
        log(f"dense {dtype}: {len(exe.blocks)} levels, widths "
            f"{exe.widths}, banded {[b.banded for b in exe.blocks]}, "
            f"total_rows {exe.total_rows}, blocks "
            f"{sum(b.device_nbytes() for b in exe.blocks)} B on the card; "
            f"pack and upload {t_build:.1f} s; peak device memory so far "
            f"{torch.cuda.max_memory_allocated()} B")
    # K2, K3, and K4's gathers and gather-adds (one each a level pair).
    pairs = len(exes["f32"].blocks) - 1
    per_iter = (sum(b.n_blocks > 1 for b in exes["f32"].blocks),
                len(exes["f32"].blocks), pairs, pairs)

    def counters():
        return (cuda_blocks.LAUNCHES_K2, cuda_blocks.LAUNCHES_K3,
                cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD)

    def count(key, fn, iters):
        before = counters()
        out = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(counters(), before))
        if delta != tuple(p * iters for p in per_iter):
            raise SystemExit(f"dense {key}: (K2, K3, K4, K4 add) launches "
                             f"{delta}, expected {per_iter} per iteration "
                             f"x {iters}")
        launches[key] = tuple(a + b for a, b in
                              zip(launches.get(key, (0,) * 4), delta))
        return out

    row_nnz = nnz / n
    tol1 = relative_tolerance(row_nnz, 1)
    iters = 10
    results = {}
    ml = exes["f32"]
    for k, xseed in ((16, 3), (128, 4)):
        key = ("f32", k)
        g = random_dense(n, k, seed=xseed)
        x = ml.set_features(g)
        worst = 0.0
        for it in range(iters):
            y = count(key, lambda: ml.step(ml.set_features(g)), 1)
            g_next = host_golden(levels, g)
            err = card_relative_error(ml.gather_result(y), g_next)
            worst = max(worst, err)
            if not err <= tol1:
                raise SystemExit(f"dense k={k} step {it}: rel err "
                                 f"{err:.3e} > gate {tol1:.1e}")
            g = g_next
        y = count(key, lambda: ml.run(x, iters), iters)
        err10 = card_relative_error(ml.gather_result(y), g)
        tol10 = relative_tolerance(row_nnz, iters)
        if not err10 <= tol10:
            raise SystemExit(f"dense k={k} 10-step chain: rel err "
                             f"{err10:.3e} > gate {tol10:.1e}")
        runs = [t / iters for t in count(
            key, lambda: cuda_runs(lambda: ml.run(x, iters), REPS),
            (1 + REPS) * iters)]
        ms = statistics.median(runs)
        results[f"f32_k{k}_ms_per_iter"] = ms
        results[f"f32_k{k}_ms_per_iter_runs"] = runs
        results[f"f32_k{k}_worst_step_rel_err"] = worst
        results[f"f32_k{k}_chain_rel_err"] = err10
        log(f"dense f32 k={k}: every step within {tol1:.1e} (worst "
            f"{worst:.3e}); 10-step chain {err10:.3e} (gate {tol10:.1e}); "
            f"{ms:.4f} ms/iter, median of {REPS} chains (min "
            f"{min(runs):.4f}, max {max(runs):.4f})")
    exe = exes["bf16"]
    for k, xseed in ((16, 3), (128, 4)):
        g = random_dense(n, k, seed=xseed)
        y = count(("bf16", k), lambda: exe.step(exe.set_features(g)), 1)
        err = relative_error(exe.gather_result(y), host_golden(levels, g))
        if not err <= 2e-2:
            raise SystemExit(f"dense bf16 blocks k={k}: rel err {err:.3e} "
                             f"> 2e-2")
        results[f"bf16_k{k}_rel_err"] = err
        log(f"dense bf16 blocks k={k}: one step, rel err {err:.3e} "
            f"(gate 2e-2)")
    totals = counters()
    if totals != tuple(sum(v[i] for v in launches.values())
                       for i in range(4)) or cuda_sell.LAUNCHES:
        raise SystemExit("dense launch counts disagree with their parts")
    if pairs and not (totals[2] and totals[3]):
        raise SystemExit("the dense path's routing launched no K4")
    log(f"dense main path: K2.LAUNCHES = {totals[0]}, K3.LAUNCHES = "
        f"{totals[1]}, K4.LAUNCHES = {totals[2]}, K4 add LAUNCHES = "
        f"{totals[3]} ({', '.join(f'{k}: {v}' for k, v in launches.items())}"
        f"); peak device memory {torch.cuda.max_memory_allocated()} B")
    # After the counts are read: the routed step against index_select's.
    for dtype, e in exes.items():
        for k, xseed in ((16, 3), (128, 4)):
            check_routed_step(e, e.set_features(random_dense(n, k,
                                                             seed=xseed)),
                              f"dense {dtype} k={k}")
    log("dense: a step of each block dtype at k = 16 and 128 bit for bit "
        "equal to the step routed by index_select")
    results.update(
        n=n, nnz=nnz, levels=len(levels), widths=ml.widths,
        total_rows=ml.total_rows, host_generate_s=t_gen,
        host_decompose_s=t_dec,
        blocks_bytes={d: sum(b.device_nbytes() for b in e.blocks)
                      for d, e in exes.items()},
        peak_device_bytes=int(torch.cuda.max_memory_allocated()))

    # -- 8. per-kernel numbers at the dense path's shapes ----------------------
    kernels = []
    for dtype, k in launches:
        exe = exes[dtype]
        entries, runs = dense_kernel_numbers(
            exe.blocks, k, launches[(dtype, k)], f"dense,{dtype},k={k}",
            relative_tolerance(max(ml.widths)), dev, "phase 8")
        kernels += entries
        for name, r in runs.items():
            results[f"{name}_{dtype}_k{k}_ms_runs"] = r
        if dtype == "f32":
            kernels += k4_format_numbers(exe, "dense", k,
                                         launches[(dtype, k)][2:], n)
    return results, kernels


#: Phase 11's formats at full size (``fmt``, ``head_fmt`` "auto":
#: resolved as on the card) and phase 12's head layouts at the JAX
#: package's kernel-comparison shape (``bench.py:COMPARE_VARIANTS``).
FORMAT_CELLS = ("auto", "ell", "hyb")
HEAD_CELLS = (("ell_headgell", dict(fmt="ell", head_fmt="gell")),
              ("ell_headflat", dict(fmt="ell", head_fmt="flat")),
              ("ell_headell", dict(fmt="ell", head_fmt="ell")),
              ("dense", dict(fmt="dense")))
CHAIN = 10                     # steps of a timed chain of a format


def level_k1_ops(exe) -> list:
    """``(level, name, operator)`` of every K1 operator one step of
    ``exe`` runs: the ELL levels' stacks and heads, the HYB levels'
    light and heavy tiers."""
    from arrow_matrix_tpu_torch.ops.cuda_ell import hyb_operands, k1_operands
    from arrow_matrix_tpu_torch.ops.hyb import HybLevel
    from arrow_matrix_tpu_torch.ops.sell import SellMatrix

    out = []
    for i, blk in enumerate(exe.blocks):
        if isinstance(blk, HybLevel):
            ops = hyb_operands(blk)
        elif blk.fmt == "ell":
            ops = k1_operands(blk)
        else:
            continue
        out += [(i, name, op) for name, op in ops.items()
                if isinstance(op, SellMatrix)]
    return out


def step_launches(exe, k: int) -> tuple:
    """(K1, K2, K3, K4 gathers, K4 gather-adds) launches of one step of
    ``exe`` at ``k`` f32 features, stated from the kernels' contracts:
    K1 one launch per operator, two where its longest row is split
    across CTAs (:func:`k1_per_product`); K2 one per dense level of more
    than one block, K3 one per dense level; K4 one gather forward and
    one gather-add backward a pair of levels, and one gather a flat
    ELL head."""
    import torch

    dense = [b for b, f in zip(exe.blocks, exe.fmts) if f == "dense"]
    pairs = len(exe.blocks) - 1
    return (sum(k1_per_product(op, k, torch.float32)
                for _, _, op in level_k1_ops(exe)),
            sum(b.n_blocks > 1 for b in dense), len(dense),
            pairs + exe.head_layouts().count("flat"), pairs)


def level_inputs(exe, x) -> list:
    """Each level's input of one step from the carriage ``x`` (the
    forward routing, through K4 as in the step)."""
    from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather

    xs = [x]
    for i in range(len(exe.blocks) - 1):
        xs.append(row_gather(xs[-1], exe.fwd[i]))
    return xs


def index_select_step(exe, x):
    """One step of ``exe`` with the routing by ``index_select`` and
    ``add_``, as the executor ran it before K4 carried the routing: the
    bit-for-bit reference of the step."""
    from arrow_matrix_tpu_torch.parallel.multi_level import (
        level_spmm,
        resolve_chunk,
    )

    total, k = x.shape
    partials, cur = [], x
    for i, (blk, w) in enumerate(zip(exe.blocks, exe.widths)):
        if i:
            cur = cur.index_select(0, exe.fwd[i - 1])
        partials.append(level_spmm(blk, cur, w, resolve_chunk(
            exe.chunk, blk, total, k, exe.gather_budget)))
    agg = partials[-1]
    for i in range(len(exe.blocks) - 1, 0, -1):
        agg = partials[i - 1].add_(agg.index_select(0, exe.bwd[i - 1]))
    return agg


def check_routed_step(exe, x, tag: str) -> None:
    """Raise unless one step of ``exe`` on ``x`` equals
    :func:`index_select_step` bit for bit."""
    import torch

    got = exe.step(x)
    want = index_select_step(exe, x)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise SystemExit(f"{tag}: the K4-routed step differs from the "
                         f"index_select-routed step in {diff} elements")


def split_ms(exe, x) -> dict:
    """One step of ``exe`` on ``x`` apart, each the median of 7
    CUDA-event timings: every level's product on its input
    (``products``), the routing as the step runs it, K4's gathers
    forward and gather-adds backward (``routing``), and the routing it
    replaced, ``index_select`` forward and ``index_select`` then
    ``add_`` backward (``index_select_routing``); with the routing's
    bytes bound."""
    from arrow_matrix_tpu_torch.bench import routing_bytes
    from arrow_matrix_tpu_torch.ops.cuda_gather import (
        row_gather,
        row_gather_add_,
    )
    from arrow_matrix_tpu_torch.parallel.multi_level import level_spmm
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms

    xs = level_inputs(exe, x)
    # Bases the timed aggregations add into, in place, as the step does.
    parts = [level_spmm(b, xi, w) for b, xi, w in
             zip(exe.blocks, xs, exe.widths)]
    pairs = len(exe.blocks) - 1

    def products():
        for b, xi, w in zip(exe.blocks, xs, exe.widths):
            level_spmm(b, xi, w)

    def routing():
        cur = x
        for i in range(pairs):
            cur = row_gather(cur, exe.fwd[i])
        agg = parts[-1]
        for i in range(pairs, 0, -1):
            agg = row_gather_add_(parts[i - 1], agg, exe.bwd[i - 1])

    def index_select_routing():
        cur = x
        for i in range(pairs):
            cur = cur.index_select(0, exe.fwd[i])
        agg = parts[-1]
        for i in range(pairs, 0, -1):
            agg = parts[i - 1].add_(agg.index_select(0, exe.bwd[i - 1]))

    gather_b, add_b = routing_bytes(exe, x.shape[1])
    return {"products_ms": cuda_ms(products, 7),
            "routing_ms": cuda_ms(routing, 7),
            "index_select_routing_ms": cuda_ms(index_select_routing, 7),
            "routing_bound_ms": (gather_b + add_b) / HBM_BYTES_PER_S * 1e3}


def k4_format_numbers(exe, tag: str, k: int, launches: tuple, n: int
                      ) -> list:
    """K4 at one format's routing (phases 8 and 11): one step's gathers
    and gather-adds
    (each on the step's own shapes and tables) against their plain
    versions bit for bit, each set timed (median of 20, and from one
    CUDA graph) beside the plain versions and one PyTorch call each
    (``index_select``; for the gather-add ``index_add_`` over the
    inverse table, ``fwd`` being ``bwd``'s inverse), with its bytes
    bound.  ``launches`` is the main path's (gathers, gather-adds)."""
    import torch

    from arrow_matrix_tpu_torch.bench import routing_bytes
    from arrow_matrix_tpu_torch.ops.cuda_gather import (
        row_gather,
        row_gather_add_,
    )
    from arrow_matrix_tpu_torch.ops.gather import (
        row_gather_add_plain,
        row_gather_plain,
    )
    from arrow_matrix_tpu_torch.parallel.multi_level import level_spmm
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    pairs = len(exe.blocks) - 1
    xs = level_inputs(exe, exe.set_features(random_dense(n, k, seed=5)))
    parts = [level_spmm(b, xi, w) for b, xi, w in
             zip(exe.blocks, xs, exe.widths)]
    bases = [p.clone() for p in parts[:-1]]
    gather_args = [(xs[i], exe.fwd[i]) for i in range(pairs)]
    add_args = [(bases[i], parts[i + 1], exe.bwd[i]) for i in range(pairs)]
    for i, ((x, t), (b, src, bt)) in enumerate(zip(gather_args, add_args)):
        got = row_gather(x, t)
        got_add = row_gather_add_(b.clone(), src, bt)
        want = row_gather_plain(x, t)
        want_add = row_gather_add_plain(b.clone(), src, bt)
        lib_add = b.clone().index_add_(0, exe.fwd[i], src)
        torch.cuda.synchronize()
        if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(got_add.view(torch.int32),
                                want_add.view(torch.int32))):
            raise SystemExit(f"K4 {tag} k={k}: a routing gather differs "
                             f"from its plain version")
        if not torch.equal(lib_add, want_add):
            raise SystemExit(f"{tag} k={k}: index_add_ over the inverse "
                             f"table is not the gather-add")
        del got, got_add, want, want_add, lib_add
    gather_b, add_b = routing_bytes(exe, k)
    entries = []
    for name, kernel, plain, library, bytes_, count in (
            ("row_gather",
             lambda: [row_gather(x, t) for x, t in gather_args],
             lambda: [row_gather_plain(x, t) for x, t in gather_args],
             lambda: [x.index_select(0, t) for x, t in gather_args],
             gather_b, launches[0]),
            ("row_gather_add",
             lambda: [row_gather_add_(b, src, t) for b, src, t in add_args],
             lambda: [row_gather_add_plain(b, src, t)
                      for b, src, t in add_args],
             lambda: [b.index_add_(0, exe.fwd[i], src)
                      for i, (b, src, _) in enumerate(add_args)],
             add_b, launches[1])):
        runs = cuda_runs(kernel, 20)
        ms = statistics.median(runs)
        g_ms, _ = graph_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 5)
        library_ms = cuda_ms(library, 5)
        bound = bytes_ / HBM_BYTES_PER_S * 1e3
        rows = pairs * exe.total_rows
        lib = ("index_select" if name == "row_gather"
               else "index_add_ over the inverse table")
        log(f"K4 {name} {tag} k={k}: {pairs} calls of "
            f"{exe.total_rows} rows: {ms:.4f} ms/step (median of 20, min "
            f"{min(runs):.4f}, max {max(runs):.4f}; {count} launches in "
            f"the main path), {g_ms:.4f} ms from one CUDA graph, "
            f"{rows / ms / 1e6:.3f} G rows/s; bound {bound:.4f} ms "
            f"({bytes_} B; {100 * bound / ms:.1f}%), plain {plain_ms:.4f} "
            f"ms, {lib} {library_ms:.4f} ms; bit for bit equal to plain")
        entries.append({
            "name": f"{name}[{tag} routing,k={k}]", "route": "cuda",
            "source": SOURCES["K4"], "replaces": REPLACES["K4"],
            "launches": count, "max_abs_err": 0.0, "ms": ms,
            "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms})
    return entries


def op_nnz(op) -> int:
    """Nonzeros of a K1 operator (degrees, or nonzero weights)."""
    import torch

    if op.deg is not None:
        return int(sum(int(d.sum()) for d in op.deg))
    return int(sum(int(torch.count_nonzero(d)) for d in op.data))


def k1_format_numbers(exe, tag: str, k: int, launches: int, n: int,
                      phase: str = "phase 11") -> dict:
    """K1 at one format's shapes: every K1 product of one step (each
    operator on its level's input) held against the plain version,
    timed (median of 20) beside the plain version and
    ``torch.sparse.mm`` over the same operators (one call each), with
    the X-once bound and the gathered-bytes bound (:func:`k1_work`)."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    ops = level_k1_ops(exe)
    x = exe.set_features(random_dense(n, k, seed=5))
    xs = level_inputs(exe, x)
    err = 0.0
    for i, name, op in ops:
        got = sell_spmm_cuda(op, xs[i])
        want = sell_spmm(op, xs[i])
        torch.cuda.synchronize()
        hub = max(int(c.shape[0]) for c in op.cols)
        e, ok = compare(got, want, float(hub), exact=False)
        if not ok:
            raise SystemExit(f"K1 {tag} k={k} level {i} {name}: kernel != "
                             f"plain (max abs err {e:.3e})")
        err = max(err, e)
    del got, want
    csrs = [sorted_csr(op, torch.float32) for _, _, op in ops]

    def k1():
        for i, _, op in ops:
            sell_spmm_cuda(op, xs[i])

    def plain():
        for i, _, op in ops:
            sell_spmm(op, xs[i])

    def library():
        for (i, _, _), a in zip(ops, csrs):
            torch.sparse.mm(a, xs[i])

    runs = cuda_runs(k1, 20)
    ms = statistics.median(runs)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 5)
    del csrs
    bytes_, flops, gathered, nnz = k1_work(exe, k)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    gather_ms = gathered / HBM_BYTES_PER_S * 1e3
    log(f"{phase} K1 {tag} k={k}: {len(ops)} operators, {nnz} nnz: "
        f"{ms:.4f} ms/step (median of 20, min {min(runs):.4f}, max "
        f"{max(runs):.4f}; {launches} launches in the main path), bound "
        f"{max(t_bytes, t_ops):.4f} ms with X read once ({bytes_} B), "
        f"{gather_ms:.4f} ms with every gathered row read ({gathered} B; "
        f"{100 * gather_ms / ms:.1f}%), plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm {library_ms:.4f} ms; kernel vs plain max abs "
        f"err {err:.3e}")
    return {"name": f"sell_tier_spmm[{tag},f32,k={k}]", "route": "cuda",
            "source": SOURCES["K1"], "replaces": REPLACES["K1"],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "gather_bound_ms": gather_ms}


def check_k1_forms(exe, tag: str, n: int) -> None:
    """Phase 5's addition on phase 11's operators: K1 on the first K1
    operator of level 0 (an ELL stack, or the HYB light tier) against
    its plain version, and bit for bit equal to a second launch."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import random_dense

    i, name, op = level_k1_ops(exe)[0]
    for k in (16, 128):
        x = level_inputs(exe, exe.set_features(random_dense(n, k, seed=6)))[i]
        got, again = sell_spmm_cuda(op, x), sell_spmm_cuda(op, x)
        want = sell_spmm(op, x)
        torch.cuda.synchronize()
        err, ok = compare(got, want, float(op.cols[0].shape[0]), exact=False)
        if not ok or not torch.equal(got, again):
            raise SystemExit(f"K1 on {tag} level {i} {name} k={k}: "
                             f"{'!= plain' if not ok else 'not repeated'} "
                             f"(max abs err {err:.3e})")
        log(f"phase 5 (on phase 11's operators) K1 {tag} level {i} {name} "
            f"{tuple(op.cols[0].shape)} k={k}: agrees with plain (max abs "
            f"err {err:.3e}), repeated bit for bit")


def host_rss_peak() -> int:
    """Peak resident bytes of this process so far."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def drive_format(exe, tag: str, goldens: dict, row_nnz: float,
                 chain: bool, timed: bool) -> tuple:
    """One format's main path, every count at 0 just before it and read
    just after: one validated step at each k of ``goldens`` ({k: (x,
    want)}), the 3-step chain at k=16 against ``goldens["chain"]`` (when
    ``chain``), and (when ``timed``) ms/iter over :data:`FORMAT_REPS`
    timed chains of :data:`CHAIN` steps, eager and from one CUDA graph.
    Launch counts must be the formats' (:func:`step_launches`).  After
    the counts are
    read, one step at each k must equal the step routed by
    ``index_select`` bit for bit, and (when ``timed``) the step is timed
    apart (:func:`split_ms`).  Returns (results, {k: (K1, K2, K3, K4
    gathers, K4 gather-adds) launches})."""
    import torch

    from arrow_matrix_tpu_torch.utils import relative_tolerance
    from arrow_matrix_tpu_torch.utils.timing import cuda_runs

    ks = [k for k in goldens if k != "chain"]
    per = {k: step_launches(exe, k) for k in ks}
    counts = {k: (0,) * 5 for k in ks}
    reset_counters()

    def count(k, fn, steps):
        before = counters()
        out = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(counters(), before))
        if delta != tuple(p * steps for p in per[k]):
            raise SystemExit(f"{tag} k={k}: (K1, K2, K3, K4, K4 add) "
                             f"launches {delta}, expected {per[k]} per "
                             f"step x {steps}")
        counts[k] = tuple(a + b for a, b in zip(counts[k], delta))
        return out

    res = {}
    tol1 = relative_tolerance(row_nnz, 1)
    for k in ks:
        g, want = goldens[k]
        y = count(k, lambda: exe.step(exe.set_features(g)), 1)
        err = card_relative_error(exe.gather_result(y), want)
        if not err <= tol1:
            raise SystemExit(f"{tag} k={k}: one step rel err {err:.3e} > "
                             f"gate {tol1:.1e}")
        res[f"k{k}_step_rel_err"] = err
    if chain:
        g, want = goldens["chain"]
        y = count(16, lambda: exe.run(exe.set_features(g), 3), 3)
        err3 = card_relative_error(exe.gather_result(y), want)
        tol3 = relative_tolerance(row_nnz, 3)
        if not err3 <= tol3:
            raise SystemExit(f"{tag} 3-step chain: rel err {err3:.3e} > "
                             f"gate {tol3:.1e}")
        res["k16_chain3_rel_err"] = err3
    log(f"{tag}: every step within {tol1:.1e} ("
        + ", ".join(f"k={k} {res[f'k{k}_step_rel_err']:.3e}" for k in ks)
        + (f"; 3-step chain {res['k16_chain3_rel_err']:.3e}" if chain
           else "") + ")")
    if timed:
        for k in ks:
            x = exe.set_features(goldens[k][0])
            runs = [t / CHAIN for t in count(
                k, lambda: cuda_runs(lambda: exe.run(x, CHAIN),
                                     FORMAT_REPS),
                (1 + FORMAT_REPS) * CHAIN)]
            # graph_ms runs the chain once to warm up and once to capture.
            g_ms = count(k, lambda: graph_ms(lambda: exe.run(x, CHAIN),
                                             FORMAT_REPS)[0],
                         2 * CHAIN) / CHAIN
            ms = statistics.median(runs)
            res.update({f"k{k}_ms_per_iter": ms,
                        f"k{k}_ms_per_iter_runs": runs,
                        f"k{k}_graph_ms_per_iter": g_ms})
            log(f"{tag} f32 k={k}: {ms:.4f} ms/iter eager, median of "
                f"{FORMAT_REPS} chains of {CHAIN} (min {min(runs):.4f}, max "
                f"{max(runs):.4f}); {g_ms:.4f} ms/iter from one CUDA "
                f"graph")
    totals = counters()
    if totals != tuple(sum(c[j] for c in counts.values())
                       for j in range(5)):
        raise SystemExit(f"{tag}: launch counts disagree with their parts")
    names = ("K1", "K2", "K3", "K4", "K4 add")
    launched = [name for name, total, want in
                zip(names, totals, per[ks[0]]) if want and not total]
    if launched:
        raise SystemExit(f"{tag}: {launched} launched no time")
    log(f"{tag} main path: " + ", ".join(
        f"{name}.LAUNCHES = {total}" for name, total in zip(names, totals))
        + " (per step " + ", ".join(f"k={k}: {per[k]}" for k in ks) + ")")
    res["launches_per_step"] = {str(k): per[k] for k in ks}
    # After the main path's counts are read: these launches are not the
    # main path's.
    for k in ks:
        check_routed_step(exe, exe.set_features(goldens[k][0]),
                          f"{tag} k={k}")
    log(f"{tag}: one step at each k bit for bit equal to the step routed "
        f"by index_select")
    for k in ks if timed else ():
        split = split_ms(exe, exe.set_features(goldens[k][0]))
        res.update({f"k{k}_{key}": v for key, v in split.items()})
        prod_ms, route_ms = split["products_ms"], split["routing_ms"]
        log(f"{tag} f32 k={k} apart: the levels' products {prod_ms:.4f} "
            f"ms, routing (K4: forward gathers, backward gather-adds) "
            f"{route_ms:.4f} ms "
            f"({100 * route_ms / (prod_ms + route_ms):.1f}%; bound "
            f"{split['routing_bound_ms']:.4f} ms, "
            f"{100 * split['routing_bound_ms'] / route_ms:.1f}%), the "
            f"index_select routing it replaced "
            f"{split['index_select_routing_ms']:.4f} ms")
    return res, counts


def phase_formats(dev, levels, n: int, width: int, gold: dict) -> tuple:
    """Phase 11: ``fmt`` auto, ell and hyb on phase 4's decomposition
    through ``MultiLevelArrow``, each built, driven (:func:`drive_format`)
    and freed in turn, then its kernels' numbers.  ``gold`` holds phase
    4's host goldens (``gold[(k, s)]`` = A^s x).  Returns (results,
    kernel entries)."""
    import torch

    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    nnz = sum(int(lvl.matrix.nnz) for lvl in levels)
    row_nnz = nnz / n
    goldens = {16: (gold[(16, 0)], gold[(16, 1)]),
               128: (gold[(128, 0)], gold[(128, 1)]),
               "chain": (gold[(16, 0)], gold[(16, 3)])}
    results, kernels = {}, []
    for fmt in FORMAT_CELLS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        exe = MultiLevelArrow(levels, width, fmt=fmt, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - tic
        ops = level_k1_ops(exe)
        rec = {"fmts": exe.fmts, "heads": exe.head_layouts(),
               "dense_budget": exe.dense_budget, "build_s": t_build,
               "device_bytes": sum(b.device_nbytes() for b in exe.blocks),
               "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
               "host_rss_peak_bytes": host_rss_peak(),
               "k1_operators": [(i, name, [tuple(c.shape) for c in op.cols])
                                for i, name, op in ops]}
        log(f"phase 11 {fmt}: formats {exe.fmts}, heads "
            f"{exe.head_layouts()}, dense budget {exe.dense_budget} B; "
            f"{len(ops)} K1 operators; {rec['device_bytes']} B on the "
            f"card (peak {rec['peak_device_bytes']} B); pack and upload "
            f"{t_build:.1f} s; host peak RSS {rec['host_rss_peak_bytes']} "
            f"B")
        if fmt in ("ell", "hyb"):
            check_k1_forms(exe, fmt, n)
        res, counts = drive_format(exe, f"phase 11 {fmt}", goldens,
                                   row_nnz, chain=True, timed=True)
        rec.update(res)
        kernels += format_kernel_numbers(exe, fmt, counts, n, rec, dev)
        results[fmt] = rec
        del exe, ops
    torch.cuda.empty_cache()
    return results, kernels


def format_kernel_numbers(exe, fmt: str, counts: dict, n: int, rec: dict,
                          dev) -> list:
    """The kernels' entries of one phase 11 format: K1 over its
    operators, K4 over its routing, and K2/K3 over its dense levels, at
    each k of ``counts`` ({k: main-path (K1, K2, K3, K4 gathers, K4
    gather-adds) launches})."""
    from arrow_matrix_tpu_torch.utils import relative_tolerance

    entries = []
    dense = [b for b, f in zip(exe.blocks, exe.fmts) if f == "dense"]
    for k, (k1, k2, k3, k4, k4_add) in counts.items():
        if k1:
            entries.append(k1_format_numbers(exe, fmt, k, k1, n))
        if k4:
            entries += k4_format_numbers(exe, fmt, k, (k4, k4_add), n)
        if dense:
            more, runs = dense_kernel_numbers(
                dense, k, (k2, k3), f"{fmt},f32,k={k}",
                relative_tolerance(max(exe.widths)), dev, "phase 11")
            entries += more
            rec.update({f"{name}_k{k}_ms_runs": r
                        for name, r in runs.items()})
    return entries


def phase_heads(dev, n: int) -> dict:
    """Phase 12: the ELL head layouts (gell, flat, per-block ELL) and
    the dense format at ``bench.py``'s kernel-comparison shape (BA n
    m=8, width 2048, 2 levels, seed 7): one validated step each and
    ms/iter.  A format whose blocks would not fit the card's free memory
    is logged and left out."""
    import torch

    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import barabasi_albert, random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_runs

    width = 2048
    tic = time.perf_counter()
    levels = arrow_decomposition(barabasi_albert(n, 8, seed=7), width,
                                 max_levels=2, block_diagonal=True, seed=7)
    nnz = sum(int(lvl.matrix.nnz) for lvl in levels)
    g = random_dense(n, 16, seed=3)
    goldens = {16: (g, host_golden(levels, g))}
    log(f"phase 12: BA n={n} m=8, 2 levels (achieved widths "
        f"{[lvl.arrow_width for lvl in levels]}, nnz "
        f"{[int(lvl.matrix.nnz) for lvl in levels]}); decomposition and "
        f"golden {time.perf_counter() - tic:.1f} s")
    results = {}
    for tag, kw in HEAD_CELLS:
        torch.cuda.empty_cache()
        if kw["fmt"] == "dense":
            # The executor's widths and rows: the last level (and any
            # grown one) banded at its own width, 5 stacks, else 3.
            widths = [w if lvl.arrow_width <= w and i < len(levels) - 1
                      else -(-lvl.arrow_width // w) * w
                      for i, lvl, w in ((i, lvl, width)
                                        for i, lvl in enumerate(levels))]
            rows = max(widths) * -(-n // max(widths))
            need = sum(rows * w * (3 if w == width and i < len(widths) - 1
                                   else 5) * 4
                       for i, w in enumerate(widths))
            free = torch.cuda.mem_get_info(dev)[0]
            if need > 0.9 * free:
                log(f"phase 12 {tag}: left out, its blocks ({need} B) "
                    f"exceed 90% of the card's free memory ({free} B)")
                results[tag] = {"left_out": f"{need} B of blocks, "
                                            f"{free} B free"}
                continue
        tic = time.perf_counter()
        exe = MultiLevelArrow(levels, width, device=dev, **kw)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - tic
        res, _ = drive_format(exe, f"phase 12 {tag}", goldens, nnz / n,
                              chain=False, timed=False)
        x = exe.set_features(g)
        runs = [t / CHAIN for t in
                cuda_runs(lambda: exe.run(x, CHAIN), REPS)]
        res.update(heads=exe.head_layouts(), fmts=exe.fmts,
                   widths=exe.widths, build_s=t_build,
                   device_bytes=sum(b.device_nbytes() for b in exe.blocks),
                   k16_ms_per_iter=statistics.median(runs),
                   k16_ms_per_iter_runs=runs)
        log(f"phase 12 {tag}: widths {exe.widths}, heads "
            f"{exe.head_layouts()}, {res['device_bytes']} B on the card, "
            f"build {t_build:.1f} s; {res['k16_ms_per_iter']:.4f} ms/iter "
            f"(median of {REPS} chains of {CHAIN}, min {min(runs):.4f}, "
            f"max {max(runs):.4f})")
        results[tag] = res
        del exe
    torch.cuda.empty_cache()
    return results


def phase_k4_kernel(dev) -> float:
    """Phase 9: K4 against its plain versions.  Returns the granule
    entry's max abs error against its plain version at the probe's full
    size (n = 2^20, S = 2^21)."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_gather
    from arrow_matrix_tpu_torch.ops.gather import (
        granule_gather_plain,
        pack_granules,
        row_gather_add_plain,
        row_gather_plain,
        take,
    )

    def bits(t):
        return t.view(torch.int32)

    checks = 0
    for n, s, k, misalign in ROW_SHAPES:
        rng = np.random.default_rng(n + s + k)
        host = rng.standard_normal((n, k)).astype(np.float32)
        host[0] = -0.0
        host.view(np.int32)[1, 0] = 0x7FC12345        # a NaN's payload
        x = torch.from_numpy(host).to(dev)
        if misalign:
            buf = torch.empty(n * k + 1, device=dev)
            buf[1:] = x.view(-1)
            x = buf[1:].view(n, k)
        if s == n:                                     # a routing table
            idx = rng.permutation(n).astype(np.int32)
        else:
            idx = rng.integers(0, n, size=s, dtype=np.int32)
            idx[:3] = (0, 1, n - 1)
        it = torch.from_numpy(idx).to(dev)
        base = torch.from_numpy(rng.standard_normal((s, k)).astype(
            np.float32)).to(dev)
        got = cuda_gather.row_gather(x, it)
        again = cuda_gather.row_gather(x, it)
        added = cuda_gather.row_gather_add_(base.clone(), x, it)
        added2 = cuda_gather.row_gather_add_(base.clone(), x, it)
        want = row_gather_plain(x, it)
        want_add = row_gather_add_plain(base, x, it)
        torch.cuda.synchronize()
        for what, a, b in (("gather != index_select", got, want),
                           ("gather not repeated", again, got),
                           ("gather-add != index_select + add_", added,
                            want_add),
                           ("gather-add not repeated", added2, added)):
            checks += 1
            if not torch.equal(bits(a), bits(b)):
                raise SystemExit(f"K4 {what} at n={n} S={s} k={k} "
                                 f"misaligned={misalign}")
        log(f"K4 n={n} S={s} k={k}{' (misaligned view)' if misalign else ''}:"
            f" gather and gather-add bit for bit equal to index_select "
            f"(+ add_) and to a second launch; -0.0 and the NaN payload "
            f"kept")
        del x, it, base, got, again, added, added2, want, want_add
    full_err = None
    for n, s in GRANULE_SHAPES:
        rng = np.random.default_rng(n + s)
        x = rng.standard_normal((n, 16)).astype(np.float32)
        x[5] = -0.0
        idx = rng.integers(0, n, size=s, dtype=np.int32)
        idx[:3] = (0, n - 1, 5)
        xp = pack_granules(torch.from_numpy(x).to(dev))
        it = torch.from_numpy(idx).to(dev)
        got = cuda_gather.granule_gather(xp, it)
        want = granule_gather_plain(xp, it)
        rows = take(xp.view(-1, 16), it)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        checks += 2
        if not torch.equal(got, want):
            raise SystemExit(f"K4's granule entry != plain at n={n} S={s}: "
                             f"max abs err {err:.3e}")
        if not torch.equal(bits(got.view(-1, 16)), bits(rows)):
            raise SystemExit(f"K4's granule entry did not copy the rows' "
                             f"bits at n={n} S={s}")
        if (n, s) == (1 << 20, 1 << 21):
            full_err = err
        log(f"K4 granule entry n={n} S={s}: equal to plain by value, to "
            f"take bit for bit (the -0.0 row kept its sign)")
    torch.cuda.empty_cache()
    log(f"phase 9: {checks} K4-vs-plain checks passed")
    return full_err


def phase_probes(dev, ml, k4_err: float) -> tuple:
    """Phase 10: the gather probes at full size, their main path, on
    phase 4's fold ``ml``.  Returns (results, K4's kernel entry)."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell
    from arrow_matrix_tpu_torch.tools import gather_probe, granule_gather_probe

    # The main path: every count at 0 just before, read just after.
    reset_counters()
    probe = granule_gather_probe.run_probe(dev)
    rates = gather_probe.gather_rates(device=dev, reps=RATE_REPS)
    folds = [gather_probe.fold_step(k, ml) for k in (16, 128)]
    torch.cuda.synchronize()
    k4_launches, k1_launches = cuda_gather.LAUNCHES, cuda_sell.LAUNCHES
    # The granule probe: 1 checked call + 1 warm-up + 20 timed; the f32
    # gather rates: per k and index order 1 checked + 1 warm-up +
    # RATE_REPS.
    k4_expected = 22 + (2 + RATE_REPS) * sum(1 for r in rates
                                             if "k4_ms" in r)
    if k4_launches != k4_expected or cuda_gather.LAUNCHES_ADD:
        raise SystemExit(f"phase 10: {k4_launches} K4 launches, expected "
                         f"{k4_expected}, and no gather-add")
    # fold_step takes, per k and carriage, one step and 1 + 7 timed
    # chains of 10 (chained_iteration_ms): 81 products of K1's launches.
    k1_expected = sum(81 * k1_per_product(ml.sell, k, dtype)
                      for k in (16, 128)
                      for dtype in (torch.float32, torch.bfloat16))
    if k1_launches != k1_expected:
        raise SystemExit(f"phase 10: {k1_launches} K1 launches, expected "
                         f"{k1_expected}")
    if cuda_blocks.LAUNCHES_K2 or cuda_blocks.LAUNCHES_K3:
        raise SystemExit("phase 10 launched a dense-block kernel")
    v = probe["variants"]
    if not all(r["exact"] for r in v.values()) or "verdict" not in probe:
        raise SystemExit(f"granule probe: a variant was not exact: {v}")
    bound = probe["bound_ms"]
    log(f"phase 10 granule probe (n={probe['n']}, S={probe['slots']}; "
        f"{probe['distinct_rows']} distinct rows): " + "; ".join(
            f"{name} {r['ms']:.4f} ms ({r['mslots_s']:.1f} M slots/s, "
            f"{100 * bound / r['ms']:.1f}% of bound)"
            for name, r in v.items())
        + f"; K4 bound {bound:.4f} ms ({probe['bytes']} B; the TPU "
        f"kernel's lines would move {probe['line_bytes']} B), K4 "
        f"{probe['bytes'] / v['cuda_granule']['ms'] / 1e9:.3f} TB/s; "
        f"cuda_vs_torch "
        f"{probe['cuda_vs_torch']:.3f}: {probe['verdict']}; "
        f"K4.LAUNCHES = {k4_launches}")
    for r in rates:
        if not r["exact"] or not r.get("k4_exact", True):
            raise SystemExit(f"gather_rates: a gather was not exact: {r}")
        k4 = (f"; K4 {r['k4_ms']:.4f} ms ({r['k4_mslots_s']:.1f} M "
              f"slots/s, {r['k4_mslots_s'] / r['mslots_s']:.2f}x take)"
              if "k4_ms" in r else "")
        log(f"phase 10 take k={r['k']:3d} {r['dtype']:4s} {r['order']:6s}: "
            f"{r['ms']:.4f} ms ({r['mslots_s']:.1f} M slots/s, "
            f"{r['slots']} slots); x[idx] {r['index_ms']:.4f} ms "
            f"({r['index_mslots_s']:.1f} M slots/s){k4}")
    for rec in folds:
        if not gather_probe.fold_gate(rec, ml.nnz / ml.n):
            raise SystemExit(f"fold_step k={rec['k']}: kernel != plain "
                             f"{rec['carriages']}")
        log(f"phase 10 fold k={rec['k']} (phase 4's fold, max_levels 10): "
            f"{rec['tiers']} tiers, {rec['slots']} slots "
            f"({rec['slots_per_nnz']:.3f}x nnz), {rec['device_bytes']} B; "
            + "; ".join(f"{name} {c['ms_per_iter']:.4f} ms/iter "
                        f"({c['mslots_s']:.1f} M slots/s, vs plain "
                        f"{c['rel_err_vs_plain']:.2e})"
                        for name, c in rec["carriages"].items()))
    log(f"probes' main path: K4.LAUNCHES = {k4_launches}, K1.LAUNCHES = "
        f"{k1_launches}")
    entry = {
        "name": "granule_gather[probe,k=16]", "route": "cuda",
        "source": SOURCES["K4"], "replaces": REPLACES["K4"],
        "launches": k4_launches, "max_abs_err": k4_err,
        "ms": v["cuda_granule"]["ms"], "plain_ms": v["torch_granule"]["ms"],
        "bound_ms": bound, "bound_by": "bytes",
        "library_ms": v["torch_take"]["ms"]}
    return {"granule_probe": probe, "gather_rates": rates, "fold": folds,
            "k1_launches": k1_launches}, entry


# -- 13. the models at full size ---------------------------------------------

#: Phase 13's feature widths (the protocol's two: k_in = hidden = 128,
#: k_out = 16), propagation depths and Adam steps.
MODEL_DIMS = (128, 128, 16)
SGC_HOPS = 2
APPNP_HOPS, APPNP_ALPHA = 10, 0.1
TRAIN_STEPS = 5
#: Iterations of phase 13's solvers.
SOLVER_ITERS = {"pagerank": 50, "label_propagation": 20,
                "power_iteration": 50, "conjugate_gradient": 50}
KERNEL_NAMES = ("K1", "K2", "K3", "K4", "K4 add")


def host_matrix(levels, n: int):
    """The decomposed operator in original row order as one float64 host
    CSR, ``A[perm[r], perm[c]] += B_i[r, c]`` over the levels (the
    product ``decomposition_spmm`` computes)."""
    import numpy as np
    from scipy import sparse

    rows, cols, vals = [], [], []
    for lvl in levels:
        coo = lvl.matrix.tocoo()
        p = np.asarray(lvl.permutation)
        rows.append(p[coo.row])
        cols.append(p[coo.col])
        vals.append(coo.data.astype(np.float64))
    a = sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                  np.concatenate(cols))),
                          shape=(n, n))
    a.sum_duplicates()
    return a


class HostOp:
    """A float64 host CSR cut into row blocks, ``op @ x`` computed block
    by block in threads (scipy's products release the GIL)."""

    def __init__(self, a):
        import numpy as np

        parts = os.cpu_count() or 1
        self.shape = a.shape
        cut = np.linspace(0, a.shape[0], parts + 1).astype(int)
        self.blocks = [a[lo:hi] for lo, hi in zip(cut[:-1], cut[1:])]

    def __matmul__(self, x):
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        with ThreadPoolExecutor(len(self.blocks)) as pool:
            return np.concatenate(list(pool.map(lambda b: b @ x,
                                                self.blocks)))


def model_products(name: str) -> tuple:
    """(forward, backward) feature widths of the products one training
    step of model ``name`` crosses (SGC's propagation runs before the
    steps on the fold: ``sgc_carried`` crosses none)."""
    k_in, hidden, k_out = MODEL_DIMS
    return {"sgc": ([k_in] * SGC_HOPS, []),
            "sgc_carried": ([], []),
            "gcn": ([k_in, hidden], [hidden]),
            "appnp": ([k_out] * APPNP_HOPS, [k_out] * APPNP_HOPS)}[name]


def host_model(name: str, a, at, x, y, params, masks=None) -> dict:
    """Model ``name``'s forward (logits), masked-MSE loss over the ``n``
    real rows and its gradients, in float64 on the host: scipy products
    with ``a`` forward and the explicit transpose ``at`` backward, numpy
    for the dense layers.  ``params``: [(w, b)] as float64.  GCN's ReLUs
    open where ``masks`` (one bool array a hidden layer) say, when given,
    else where the float64 pre-activation is positive; ``"masks"`` in
    the result are the ones used."""
    import numpy as np

    n = x.shape[0]
    if name == "sgc":
        (w, b), = params
        p = x
        for _ in range(SGC_HOPS):
            p = a @ p
        out = p @ w + b
        g = 2.0 * (out - y) / n
        grads = [(p.T @ g, g.sum(0))]
    elif name == "gcn":
        h, cache, used = x, [], []
        for i, (w, b) in enumerate(params):
            z = a @ h
            pre = z @ w + b
            cache.append(z)
            if i < len(params) - 1:
                used.append(pre > 0.0 if masks is None else masks[i])
                h = np.where(used[i], pre, 0.0)
            else:
                h = pre
        out = h
        g = 2.0 * (out - y) / n
        grads = []
        for i in range(len(params) - 1, -1, -1):
            z = cache[i]
            if i < len(params) - 1:
                g = g * used[i]
            grads.append((z.T @ g, g.sum(0)))
            if i:
                g = at @ (g @ params[i][0].T)
        grads.reverse()
    else:
        (w, b), = params
        h = x @ w + b
        z = h
        for _ in range(APPNP_HOPS):
            z = (1 - APPNP_ALPHA) * (a @ z) + APPNP_ALPHA * h
        out = z
        gz = 2.0 * (out - y) / n
        gh = np.zeros_like(gz)
        for _ in range(APPNP_HOPS):
            gh += APPNP_ALPHA * gz
            gz = (1 - APPNP_ALPHA) * (at @ gz)
        gh += gz
        grads = [(x.T @ gh, gh.sum(0))]
    rec = {"logits": out, "loss": float(((out - y) ** 2).sum() / n),
           "grads": grads}
    if name == "gcn":
        rec["masks"] = used
    return rec


def model_params(params) -> list:
    """A model's heads (an ``SGCParams`` or a list of them) as [(w, b)]
    float64 host arrays."""
    import numpy as np
    import torch

    heads = params if isinstance(params, torch.nn.ModuleList) else [params]
    return [(h.w.detach().cpu().numpy().astype(np.float64),
             h.b.detach().cpu().numpy().astype(np.float64)) for h in heads]


def train_timed(model, xs, ys, mask, steps: int) -> dict:
    """``steps`` Adam steps of ``model`` (the models' default optimizer,
    ``torch.optim.Adam(lr=1e-2)``) on the carriage ``xs`` against
    ``ys``: the body of their ``fit`` and train steps
    (``models/propagation.py:_optimizer_step``: zero_grad, forward,
    masked MSE, backward, update) with CUDA events and the launch
    counters read between the parts.  Returns the losses, the per-step
    (forward, backward, step) ms, the per-step forward and backward
    launches, and the first step's output and gradients."""
    import torch

    from arrow_matrix_tpu_torch.models.propagation import (
        default_optimizer,
        masked_mse,
    )

    opt = default_optimizer(model.parameters())
    marks, losses, first = [], [], None
    for s in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        cs = [counters()]
        opt.zero_grad()
        out = model(xs)
        loss = masked_mse(out, ys, mask)
        ev[1].record()
        cs.append(counters())
        loss.backward()
        ev[2].record()
        cs.append(counters())
        if s == 0:
            first = (out.detach(), [p.grad.detach().clone()
                                    for p in model.parameters()])
        opt.step()
        ev[3].record()
        losses.append(loss.detach())
        marks.append((ev, cs))
    torch.cuda.synchronize()
    per = [(ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
            ev[0].elapsed_time(ev[3])) for ev, _ in marks]
    launches = [(tuple(b - a for a, b in zip(cs[0], cs[1])),
                 tuple(b - a for a, b in zip(cs[1], cs[2])))
                for _, cs in marks]
    return {"losses": [float(v) for v in losses], "ms": per,
            "launches": launches, "first_out": first[0],
            "first_grads": first[1]}


def fold_work(sell, nnz: int, k: int, item: int = 4,
              out_item: int = 4, x_rows=None) -> tuple:
    """(bytes, operations) of K1 over the SELL operator ``sell`` of
    ``nnz`` nonzeros at ``k`` features of ``item`` bytes: the operator
    once (4 B an index, plus 4 B a row of degrees or a value), X
    (``x_rows`` rows, default the output's) read once and the output
    (``out_item`` bytes) written once."""
    op_bytes = 4 * nnz + (4 * sell.n_rows if sell.binary else 4 * nnz)
    x_rows = sell.n_rows if x_rows is None else x_rows
    return (op_bytes + (x_rows * item + sell.n_rows * out_item) * k,
            (1 if sell.binary else 2) * nnz * k)


def fold_bound_ms(sell, nnz: int, k: int) -> float:
    """K1's bound over ``sell`` at ``k`` f32 features (:func:`fold_work`)."""
    bytes_, flops = fold_work(sell, nnz, k)
    return max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def k1_work(exe, k: int) -> tuple:
    """(bytes with X read once, operations, gathered bytes, nonzeros) of
    the K1 products of one step of the per-level ``exe`` at ``k`` f32
    features: each operator moved once (4 B an index, plus 4 B a row of
    degrees or a value), X read once a level, the outputs written once;
    gathered: a row and its index read per nonzero, plus the outputs."""
    ops = level_k1_ops(exe)
    nnz = [op_nnz(op) for _, _, op in ops]
    levels_read = {i for i, _, _ in ops}
    out_bytes = sum(op.n_rows for _, _, op in ops) * k * 4
    op_bytes = sum(4 * z + (4 * op.n_rows if op.deg is not None else 4 * z)
                   for z, (_, _, op) in zip(nnz, ops))
    bytes_ = op_bytes + len(levels_read) * exe.total_rows * k * 4 + out_bytes
    flops = sum((1 if op.deg is not None else 2) * z * k
                for z, (_, _, op) in zip(nnz, ops))
    return (bytes_, flops, sum(nnz) * (k * 4 + 4) + out_bytes, sum(nnz))


def unsort_bound_ms(exe, k: int) -> float:
    """K4's bound for the transposed fold's unsort at ``k`` f32
    features: two carriages and the int32 table, each moved once."""
    return ((2 * exe.total_rows * k * 4 + exe.total_rows * 4)
            / HBM_BYTES_PER_S * 1e3)


def step_bound_ms(exe, k: int, transposed: bool = False) -> float:
    """The least time of one step (``transposed``: of its backward) at
    ``k`` f32 features: the sum of its kernels' bounds, K1 over the
    ELL/HYB operators, K2 and K3 over the dense levels, K4's routing;
    the fold's one K1 product (a transposed pack adds K4's unsort)."""
    from arrow_matrix_tpu_torch.bench import routing_bytes

    if exe.folded:
        t = exe.transposed() if transposed else None
        if t is None or t.sell is None:
            return fold_bound_ms(exe.sell, exe.nnz, k)
        return fold_bound_ms(t.sell, exe.nnz, k) + unsort_bound_ms(exe, k)
    view = transposed_view(exe) if transposed else exe
    bytes_, flops, _, _ = k1_work(view, k)
    total = max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS)
    for b, f in zip(view.blocks, view.fmts):
        if f == "dense":
            for kernel in ("K2", "K3"):
                bb, oo = block_work(b, k, kernel)
                total += max(bb / HBM_BYTES_PER_S, oo / F32_FLOPS)
    gather_b, add_b = routing_bytes(view, k)
    return (total + (gather_b + add_b) / HBM_BYTES_PER_S) * 1e3


def transposed_view(exe):
    """``exe`` with its transposed levels as its blocks: what the kernel
    numbers of phases 8 and 11 read (routing, formats, widths kept)."""
    import copy

    view = copy.copy(exe)
    view.blocks = exe.transposed().blocks
    return view


def check_transposed(exe, at, n: int, tag: str, row_nnz: float) -> float:
    """One ``Aᵀ g`` through the executor's transposed step against scipy
    with the explicit transpose, at k = 16."""
    from arrow_matrix_tpu_torch.utils import (
        random_dense,
        relative_error,
        relative_tolerance,
    )

    g = random_dense(n, 16, seed=31)
    got = exe.gather_result(exe.transposed_step(exe.set_features(g)))
    err = relative_error(got, at @ g.astype("float64"))
    tol = relative_tolerance(row_nnz, 1)
    if not err <= tol:
        raise SystemExit(f"phase 13 {tag}: transposed step rel err "
                         f"{err:.3e} > gate {tol:.1e}")
    t = exe.transposed()
    log(f"phase 13 {tag}: A^T g (k=16) within {tol:.1e} of scipy's "
        f"explicit transpose ({err:.3e}); levels packed transposed "
        f"{t.packed}")
    return err


def drive_model(name: str, model, exe, x, y, golden: dict, row_nnz: float,
                tag: str) -> dict:
    """Train ``model`` (phase 13) for :data:`TRAIN_STEPS` steps on ``x``
    (host, original order) against ``y`` and check it: the first step's
    forward and every gradient against ``golden`` (float64 host), the
    losses finite and the last under the first.  Returns its record
    (times, launches, errors, bound, transposed build)."""
    import numpy as np

    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    carried = exe.folded
    if name == "sgc" and carried:
        xs = model.propagate(x)
    else:
        xs = exe.set_features(x)
    ys = exe.set_features(y)
    mask = exe.carried_mask() if carried else exe.real_row_mask()
    run = train_timed(model, xs, ys, mask, TRAIN_STEPS)
    fwd_k, bwd_k = model_products("sgc_carried" if name == "sgc" and carried
                                  else name)
    chain_fwd, chain_bwd = model_products(name)
    s = max(1, len(chain_fwd) + len(chain_bwd))
    tol_fwd = relative_tolerance(row_nnz, max(1, len(chain_fwd)))
    tol_grad = relative_tolerance(row_nnz, s)
    fwd_err = relative_error(exe.gather_result(run["first_out"]),
                             golden["logits"])
    if not fwd_err <= tol_fwd:
        raise SystemExit(f"phase 13 {tag}: forward rel err {fwd_err:.3e} > "
                         f"gate {tol_fwd:.1e}")
    want = [g for pair in golden["grads"] for g in pair]
    grad_errs = [relative_error(got.cpu().numpy(), w)
                 for got, w in zip(run["first_grads"], want)]
    if len(grad_errs) != len(want) or not max(grad_errs) <= tol_grad:
        raise SystemExit(f"phase 13 {tag}: gradient rel errs {grad_errs} > "
                         f"gate {tol_grad:.1e}")
    losses = run["losses"]
    loss_err = abs(losses[0] - golden["loss"]) / abs(golden["loss"])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and loss_err <= tol_fwd):
        raise SystemExit(f"phase 13 {tag}: losses {losses} (first vs host "
                         f"{loss_err:.3e}): not finite, not decreasing, or "
                         f"off the host's")
    per_step = run["launches"]
    if any(p != per_step[0] for p in per_step):
        raise SystemExit(f"phase 13 {tag}: launches differ between steps "
                         f"{per_step}")
    tail = run["ms"][1:]
    fwd_ms, bwd_ms, step_ms = (statistics.median(t[i] for t in tail)
                               for i in range(3))
    bound = (sum(fwd_k.count(k) * step_bound_ms(exe, k) for k in set(fwd_k))
             + sum(bwd_k.count(k) * step_bound_ms(exe, k, transposed=True)
                   for k in set(bwd_k)))
    t = exe.transposed() if bwd_k else None
    built = (f"transposed operator: levels {t.packed} packed in "
             f"{t.seconds:.2f} s, {t.device_bytes} B on the card"
             if t is not None and t.packed else
             "transposed operator: none packed (symmetric: the backward "
             "runs the forward operator)" if t is not None else
             "no backward product")
    log(f"phase 13 {tag}: losses {', '.join(f'{v:.6g}' for v in losses)}; "
        f"forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms, train step "
        f"{step_ms:.4f} ms (median of steps 2-{TRAIN_STEPS}); per step "
        f"forward {dict(zip(KERNEL_NAMES, per_step[0][0]))}, backward "
        f"{dict(zip(KERNEL_NAMES, per_step[0][1]))} launches; propagation "
        f"bound {bound:.4f} ms ({len(fwd_k)} products forward at k "
        f"{fwd_k}, {len(bwd_k)} backward); forward rel err {fwd_err:.3e} "
        f"(gate {tol_fwd:.1e}), gradients max rel err {max(grad_errs):.3e} "
        f"(gate {tol_grad:.1e}, {s} products); {built}")
    return {"losses": losses, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "step_ms": step_ms, "ms_runs": run["ms"],
            "launches_forward": per_step[0][0],
            "launches_backward": per_step[0][1],
            "propagation_bound_ms": bound, "forward_rel_err": fwd_err,
            "forward_gate": tol_fwd, "grad_rel_errs": grad_errs,
            "grad_gate": tol_grad, "products": [fwd_k, bwd_k],
            "transposed_packed": None if t is None else t.packed,
            "transposed_s": None if t is None else t.seconds,
            "transposed_bytes": None if t is None else t.device_bytes}


def scaled_levels(levels, rows=None, cols=None):
    """The levels of ``diag(rows) A diag(cols)`` (``rows``/``cols``: per
    original vertex, None for ones): each level's row r scaled by
    ``rows[permutation[r]]``, its column c by ``cols[permutation[c]]``;
    since ``A = sum_i P_iᵀ B_i P_i`` this needs no second decomposition.
    ``D⁻¹A`` is ``rows = 1/deg``, ``A D⁻¹`` ``cols = 1/deg`` and the
    symmetric ``D^-1/2 A D^-1/2`` both ``1/sqrt(deg)`` (each entry then
    the same two float32 factors either way round: exactly symmetric)."""
    import numpy as np
    from scipy import sparse

    from arrow_matrix_tpu_torch.decomposition.decompose import ArrowLevel

    out = []
    for lvl in levels:
        p = np.asarray(lvl.permutation)
        m = lvl.matrix.astype(np.float32)
        if rows is not None:
            m = sparse.diags(rows[p].astype(np.float32)) @ m
        if cols is not None:
            m = m @ sparse.diags(cols[p].astype(np.float32))
        out.append(ArrowLevel(m.tocsr(), lvl.permutation, lvl.arrow_width))
    return out


def host_solvers(name: str, a, **kw):
    """The solvers' float64 host iterations, as the port runs them."""
    import numpy as np

    if name == "pagerank":
        n, d = a.shape[0], kw["damping"]
        r = np.full((n, 1), 1.0 / n)
        for _ in range(SOLVER_ITERS[name]):
            r = d * (a @ r) + (1.0 - d) / n
        return r
    if name == "label_propagation":
        labels, seed_mask = kw["labels"], kw["seed_mask"]
        seeds = labels * seed_mask[:, None]
        y = labels.astype(np.float64)
        for _ in range(SOLVER_ITERS[name]):
            y = np.where(seed_mask[:, None], seeds, a @ y)
        return y
    if name == "power_iteration":
        x = kw["x0"].astype(np.float64)
        for _ in range(SOLVER_ITERS[name]):
            y = a @ x
            x = y / max(np.linalg.norm(y), 1e-30)
        y = a @ x
        return x, float((x * y).sum() / (x * x).sum())
    b, shift = kw["b"].astype(np.float64), kw["shift"]
    x, r, p = np.zeros_like(b), b.copy(), b.copy()
    rz = float((r * r).sum())
    for _ in range(SOLVER_ITERS[name]):
        ap = shift * p + a @ p
        denom = float((p * ap).sum())
        alpha = rz / (denom if denom else 1.0)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = float((r * r).sum())
        p = r + rz_new / (rz if rz else 1.0) * p
        rz = rz_new
    return x


#: Phase 13's float64 host goldens, in the order :func:`models_host`
#: starts them (three at a time), and phase 21 (a)'s GCN over A.
MODEL_GOLDENS = (("sgc", "sym"), ("gcn", "sym"), ("appnp", "sym"),
                 "power_iteration", "conjugate_gradient", ("gcn", "asym"),
                 "label_propagation", "pagerank", "gcn_a")


def model_golden_path(base: str, key) -> str:
    """The pickle of one of :data:`MODEL_GOLDENS` (or ``"digest"``)."""
    slug = key if isinstance(key, str) else "_".join(key)
    return f"{base}_m13_{slug}.pkl"


def model_operators(a, names=("a", "a_hat", "a_hat_t", "a_rn", "a_rn_t",
                              "a_cn")) -> tuple:
    """(degrees, {name: HostOp}) of phase 13's host operators over the
    float64 CSR ``a``: A, D^-1/2 A D^-1/2 and D^-1 A with their explicit
    transposes, and A D^-1; only those in ``names``."""
    import numpy as np

    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    inv_sqrt = 1.0 / np.sqrt(deg)
    made = {"a": lambda: a}
    made["a_hat"] = lambda: a.multiply(inv_sqrt[:, None]).multiply(
        inv_sqrt[None, :]).tocsr()
    made["a_rn"] = lambda: a.multiply(1.0 / deg[:, None]).tocsr()
    made["a_cn"] = lambda: a.multiply(1.0 / deg[None, :]).tocsr()
    ops, mats = {}, {}
    for name in names:
        src = name[:-2] if name.endswith("_t") else name
        if src not in mats:
            mats[src] = made[src]()
        ops[name] = HostOp(mats[src].T.tocsr() if name.endswith("_t")
                           else mats[src])
    return deg, ops


def model_inputs(n: int) -> dict:
    """Phase 13's seeded host inputs at ``n`` rows: the features ``x``
    and targets ``y``, CG's right-hand sides ``b``, power iteration's
    start ``x0``, label propagation's ``labels`` and ``seed_mask``, and
    the models' initial parameters (seed 0) as float64 ``init``."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.models import gcn_init, sgc_init
    from arrow_matrix_tpu_torch.utils import random_dense

    k_in, _, k_out = MODEL_DIMS
    x, y = train_inputs(n)
    draw = torch.Generator
    init = {"sgc": model_params(sgc_init(draw().manual_seed(0), k_in,
                                         k_out)),
            "gcn": model_params(gcn_init(draw().manual_seed(0),
                                         MODEL_DIMS))}
    init["appnp"] = init["sgc"]
    return {"x": x, "y": y, "b": random_dense(n, 4, seed=23),
            "x0": np.ones((n, 1), np.float32),
            "labels": np.eye(4, dtype=np.float32)[
                np.random.default_rng(24).integers(0, 4, n)],
            "seed_mask": np.random.default_rng(25).random(n) < 0.1,
            "init": init}


def graph_digest(a) -> str:
    """A digest of a CSR's structure (``indptr`` and ``indices``)."""
    import hashlib

    import numpy as np

    h = hashlib.sha1(np.ascontiguousarray(a.indptr, np.int64).tobytes())
    h.update(np.ascontiguousarray(a.indices, np.int64).tobytes())
    return h.hexdigest()


def models_host(base: str, n: int, out: str) -> None:
    """Phase 13's float64 host goldens (and phase 21 (a)'s GCN over A) in
    a process of its own from the start, over phase 4's graph as
    :func:`phase4_host` saves it: each of :data:`MODEL_GOLDENS` pickled
    as ``(result, seconds)`` to :func:`model_golden_path` when it is
    done, three at a time, so that phase 13 reads them instead of
    computing them beside its own work; the graph's digest first."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from scipy import sparse

    deadline = time.monotonic() + 1800
    while not os.path.exists(graph_path(base, "ready")):
        if time.monotonic() > deadline:
            raise SystemExit("models_host: phase 4's graph never came")
        time.sleep(0.5)
    indptr = np.load(graph_path(base, "indptr"))
    indices = np.load(graph_path(base, "indices"))
    a = sparse.csr_matrix((np.ones(indices.size), indices, indptr),
                          shape=(n, n))

    def save(key, value) -> None:
        path = model_golden_path(base, key)
        with open(path + ".tmp", "wb") as fh:
            pickle.dump(value, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)

    save("digest", graph_digest(a))
    deg, ops = model_operators(a)
    inp = model_inputs(n)
    x64, y64 = inp["x"].astype(np.float64), inp["y"].astype(np.float64)
    init = inp["init"]
    jobs = {("sgc", "sym"): (host_model, "sgc", ops["a_hat"],
                             ops["a_hat_t"], x64, y64, init["sgc"]),
            ("gcn", "sym"): (host_model, "gcn", ops["a_hat"],
                             ops["a_hat_t"], x64, y64, init["gcn"]),
            ("appnp", "sym"): (host_model, "appnp", ops["a_hat"],
                               ops["a_hat_t"], x64, y64, init["appnp"]),
            ("gcn", "asym"): (host_model, "gcn", ops["a_rn"], ops["a_rn_t"],
                              x64, y64, init["gcn"]),
            "gcn_a": (host_model, "gcn", ops["a"], ops["a"], x64, y64,
                      init["gcn"])}
    solver_kw = {"power_iteration": ("a", dict(x0=inp["x0"])),
                 "conjugate_gradient": ("a", dict(
                     b=inp["b"], shift=float(deg.max()) + 1.0)),
                 "label_propagation": ("a_rn", dict(
                     labels=inp["labels"], seed_mask=inp["seed_mask"])),
                 "pagerank": ("a_cn", dict(damping=0.85))}

    def one(key) -> float:
        tic = time.perf_counter()
        if key in jobs:
            fn, *args = jobs[key]
            value = fn(*args)
        else:
            op, kw = solver_kw[key]
            value = host_solvers(key, ops[op], **kw)
        seconds = time.perf_counter() - tic
        save(key, (value, seconds))
        return seconds

    with ThreadPoolExecutor(3) as pool:
        seconds = dict(zip(map(str, MODEL_GOLDENS),
                           pool.map(one, MODEL_GOLDENS)))
    with open(out, "w") as fh:
        json.dump({"seconds": seconds}, fh)


class HostGolden:
    """One of :func:`models_host`'s goldens: ``result()`` waits for its
    pickle (fatal if the process ended without it) and returns
    ``(result, seconds)``, loaded once."""

    def __init__(self, host: tuple, base: str, key):
        self.proc, self.path = host[0], model_golden_path(base, key)
        self.key, self.value = key, None

    def result(self):
        import pickle

        while self.value is None:
            if os.path.exists(self.path):
                with open(self.path, "rb") as fh:
                    self.value = pickle.load(fh)
            elif not self.proc.is_alive() and not os.path.exists(self.path):
                raise SystemExit(f"phase 13: the host goldens' process "
                                 f"exited {self.proc.exitcode} without "
                                 f"{self.key}")
            else:
                time.sleep(0.2)
        return self.value


def check_solver(name: str, got, want, row_nnz: float) -> float:
    """A solver's result against its float64 host iteration within
    ``relative_tolerance(nnz/n, iterations)`` (the chain rule: f32 sums
    in another order, compounding at most linearly)."""
    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    err = relative_error(got, want)
    tol = relative_tolerance(row_nnz, SOLVER_ITERS[name])
    if not err <= tol:
        raise SystemExit(f"phase 13 {name}: rel err {err:.3e} > gate "
                         f"{tol:.1e}")
    return err


def fold_transposed_numbers(exe, k: int, launches: tuple, n: int) -> list:
    """The kernels of the fold's transposed step (phase 13, asymmetric
    fold) at ``k``: K1 over the pack of ``Sᵀ`` and K4's unsort gather,
    each against its plain version, timed (median of 20) beside the
    plain version and one PyTorch call (``torch.sparse.mm``,
    ``index_select``), with its bound.  ``launches``: the main path's
    backward (K1, K4) launches."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.ops.gather import row_gather_plain
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    t = exe.transposed()
    g = exe.set_features(random_dense(n, k, seed=32))
    got, want = sell_spmm_cuda(t.sell, g), sell_spmm(t.sell, g)
    torch.cuda.synchronize()
    err, ok = compare(got, want, exe.nnz / n, exact=False)
    back, back_plain = row_gather(got, t.inv), row_gather_plain(got, t.inv)
    torch.cuda.synchronize()
    if not ok or not torch.equal(back.view(torch.int32),
                                 back_plain.view(torch.int32)):
        raise SystemExit(f"phase 13 fold^T k={k}: K1 != plain (max abs err "
                         f"{err:.3e}) or the unsort gather != plain")
    a_csr = sorted_csr(t.sell, torch.float32)
    entries = []
    rows = [("sell_tier_spmm", "K1", lambda: sell_spmm_cuda(t.sell, g),
             lambda: sell_spmm(t.sell, g), lambda: torch.sparse.mm(a_csr, g),
             fold_bound_ms(t.sell, exe.nnz, k), err, launches[0]),
            ("row_gather", "K4", lambda: row_gather(got, t.inv),
             lambda: row_gather_plain(got, t.inv),
             lambda: got.index_select(0, t.inv), unsort_bound_ms(exe, k),
             0.0, launches[1])]
    # K1's gathered-bytes bound over the transposed pack, as phase 5's:
    # a row and its index read per nonzero, the output written once.
    gathered = exe.nnz * (k * 4 + 4) + t.sell.n_rows * k * 4
    gather_ms = gathered / HBM_BYTES_PER_S * 1e3
    for name, kernel, fn, plain, lib, bound, e, count in rows:
        runs = cuda_runs(fn, 20)
        ms = statistics.median(runs)
        plain_ms, library_ms = cuda_ms(plain, 3), cuda_ms(lib, 5)
        log(f"phase 13 {kernel} fold^T k={k}: {ms:.4f} ms (median of 20, "
            f"min {min(runs):.4f}, max {max(runs):.4f}; {count} launches "
            f"in the main path's backwards), bound {bound:.4f} ms"
            + (f", gathered-bytes bound {gather_ms:.4f} ms ({gathered} B "
               f"over {t.sell.n_rows} rows)" if kernel == "K1" else "")
            + f", plain {plain_ms:.4f} ms, library {library_ms:.4f} ms; "
            f"max abs err {e:.3e}")
        entries.append({
            "name": f"{name}[fold^T{' unsort' if kernel == 'K4' else ''},"
                    f"f32,k={k}]",
            "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": count,
            "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library_ms,
            **({"gathered_bound_ms": gather_ms} if kernel == "K1" else {})})
    return entries


def phase_models(dev, levels, n: int, width: int, ml, host13: tuple,
                 base: str) -> tuple:
    """Phase 13: the model families at full size on phase 4's
    decomposition (and, for the dense format, phase 7's shape), trained
    through K1-K4 with the transposed-operator backward, against the
    float64 host goldens of ``host13`` (:func:`models_host`'s process
    over phase 4's graph at ``base``).  Every count at 0 just before,
    read just after.  Returns (results, kernel entries, its host power
    iteration, CG and GCN over A: ``{"n", "shift", "power", "cg",
    "gcn"}``, the last three :class:`HostGolden`, which phase 21 (a)
    reuses)."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.models import (
        APPNPCarried,
        APPNPModel,
        GCNCarried,
        GCNModel,
        SGCCarried,
        SGCModel,
        conjugate_gradient,
        label_propagation,
        pagerank,
        power_iteration,
    )
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import (
        barabasi_albert,
        random_dense,
        relative_tolerance,
    )

    k_in, hidden, k_out = MODEL_DIMS
    dims = MODEL_DIMS
    results, kernels = {}, []
    ml.feature_dtype = torch.float32      # phase 4 left it at int8
    reset_counters()
    backward_asym = [0] * 5
    aside = [0] * 5

    def apart(fn, *args, **kw):
        """A check or a kernel's numbers: its launches are not the main
        path's."""
        before = counters()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        for i, (b0, b1) in enumerate(zip(before, counters())):
            aside[i] += b1 - b0
        return out

    # The symmetric operator is the GCN normalization D^-1/2 A D^-1/2
    # (spectral radius 1): over the raw A, APPNP's 10 hops grow the
    # gradients past the square root of f32's range, Adam's second
    # moment overflows and no step moves.  The asymmetric one is D^-1 A.
    tic = time.perf_counter()
    a = host_matrix(levels, n)
    deg, ops = model_operators(a, ("a_hat_t", "a_rn_t"))
    inv_sqrt = 1.0 / np.sqrt(deg)
    row_nnz = a.nnz / n
    inp = model_inputs(n)
    x, y, b, x0 = inp["x"], inp["y"], inp["b"], inp["x0"]
    labels, seed_mask, init = inp["labels"], inp["seed_mask"], inp["init"]
    shift = float(deg.max()) + 1.0
    log(f"phase 13: host operator A and the explicit transposes of "
        f"D^-1/2 A D^-1/2 and D^-1 A ({a.nnz} nnz, max degree "
        f"{int(deg.max())}) in {time.perf_counter() - tic:.1f} s")

    # The float64 host goldens, made from the initial parameters the
    # models draw (seed 0; checked against each model) by a process of
    # their own from the start, over phase 4's graph: its digest must be
    # this A's.
    host = {key: HostGolden(host13, base, key) for key in MODEL_GOLDENS}
    if HostGolden(host13, base, "digest").result() != graph_digest(a):
        raise SystemExit("phase 13: the host goldens' graph is not the "
                         "decomposition's A")

    def host_result(key):
        tic = time.perf_counter()
        out, seconds = host[key].result()
        results.setdefault("host_golden_s", {})[str(key)] = seconds
        log(f"phase 13 host float64 {key}: {seconds:.1f} s in the golden "
            f"process, {time.perf_counter() - tic:.1f} s waited for")
        return out

    def golden(name, kind, model):
        """The float64 host golden of (model, operator); the model's
        initial parameters must be the ones it was computed from."""
        if not all(np.array_equal(p, q)
                   for pp, qq in zip(model_params(model.params), init[name])
                   for p, q in zip(pp, qq)):
            raise SystemExit(f"phase 13 {name}: the model's initial "
                             f"parameters are not seed 0's")
        return host_result((name, kind))

    def drive(tag, name, kind, model, exe, gold=None,
              data=(x, y, row_nnz)):
        """Train and check one model (:func:`drive_model`) against
        ``gold`` (default: the shared golden of ``kind``)."""
        torch.cuda.reset_peak_memory_stats()
        rec = drive_model(name, model, exe, data[0], data[1],
                          gold or golden(name, kind, model), data[2], tag)
        rec["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
        if kind != "sym":
            for i, v in enumerate(rec["launches_backward"]):
                backward_asym[i] += v * TRAIN_STEPS
        results[tag] = rec
        return rec

    # -- symmetric: the backward reuses the forward operator ----------------
    sym_levels = scaled_levels(levels, inv_sqrt, inv_sqrt)
    tic = time.perf_counter()
    torch.cuda.empty_cache()
    exe = MultiLevelArrow(sym_levels, width, device=dev)
    torch.cuda.synchronize()
    log(f"phase 13 auto over D^-1/2 A D^-1/2: formats {exe.fmts}, built in "
        f"{time.perf_counter() - tic:.1f} s")
    for name, model in (("sgc", SGCModel(exe, k_in, k_out, hops=SGC_HOPS)),
                        ("appnp", APPNPModel(exe, k_in, k_out,
                                             hops=APPNP_HOPS,
                                             alpha=APPNP_ALPHA))):
        drive(f"{name} auto", name, "sym", model, exe)
    if exe.transposed().packed:
        raise SystemExit("phase 13 auto: a level of the symmetric operator "
                         "was packed transposed")
    apart(check_transposed, exe, ops["a_hat_t"], n, "auto (sym)", row_nnz)
    del exe, model
    torch.cuda.empty_cache()

    tic = time.perf_counter()
    fold = MultiLevelArrow(sym_levels, width, fmt="fold", device=dev)
    torch.cuda.synchronize()
    log(f"phase 13 fold over D^-1/2 A D^-1/2: built in "
        f"{time.perf_counter() - tic:.1f} s")
    for name, model in (("sgc", SGCCarried(fold, k_in, k_out,
                                           hops=SGC_HOPS)),
                        ("gcn", GCNCarried(fold, dims)),
                        ("appnp", APPNPCarried(fold, k_in, k_out,
                                               hops=APPNP_HOPS,
                                               alpha=APPNP_ALPHA))):
        drive(f"{name}_carried fold", name, "sym", model, fold)
    if fold.transposed().packed:
        raise SystemExit("phase 13 fold: the symmetric fold was packed "
                         "transposed")
    apart(check_transposed, fold, ops["a_hat_t"], n, "fold (sym)", row_nnz)
    del fold, model, sym_levels
    torch.cuda.empty_cache()

    # -- solvers on phase 4's fold (the adjacency A) -------------------------
    tic = time.perf_counter()
    v, lam = power_iteration(ml, x0, iterations=SOLVER_ITERS[
        "power_iteration"])
    t_dev = time.perf_counter() - tic
    hv, hlam = host_result("power_iteration")
    err = check_solver("power_iteration", v, hv, row_nnz)
    lam_err = abs(lam - hlam) / abs(hlam)
    if not lam_err <= relative_tolerance(row_nnz, SOLVER_ITERS[
            "power_iteration"]):
        raise SystemExit(f"phase 13 power_iteration: eigenvalue {lam} vs "
                         f"host {hlam}")
    results["power_iteration fold"] = {"rel_err": err, "lambda": lam,
                                       "lambda_rel_err": lam_err,
                                       "host_s": t_dev}
    log(f"phase 13 power_iteration (fold, {SOLVER_ITERS['power_iteration']}"
        f" iterations): vector rel err {err:.3e}, eigenvalue {lam:.6f} (host "
        f"{hlam:.6f}, rel err {lam_err:.3e}); {t_dev:.2f} s")
    tic = time.perf_counter()
    sol, rnorm = conjugate_gradient(
        ml, b, shift=shift, iterations=SOLVER_ITERS["conjugate_gradient"])
    t_dev = time.perf_counter() - tic
    err = check_solver("conjugate_gradient", sol,
                       host_result("conjugate_gradient"), row_nnz)
    results["conjugate_gradient fold"] = {"rel_err": err, "residual": rnorm,
                                          "shift": shift, "s": t_dev}
    log(f"phase 13 conjugate_gradient (fold, shift {shift}, "
        f"{SOLVER_ITERS['conjugate_gradient']} iterations, k=4): rel err "
        f"{err:.3e} against the host CG, residual {rnorm:.3e}; {t_dev:.2f} s")

    # -- asymmetric D^-1 A: a transposed pack built and run -----------------
    rn_levels = scaled_levels(levels, rows=1.0 / deg)
    rn_nnz = row_nnz
    tic = time.perf_counter()
    torch.cuda.empty_cache()
    exe = MultiLevelArrow(rn_levels, width, fmt="hyb", device=dev)
    torch.cuda.synchronize()
    log(f"phase 13 hyb over D^-1 A: built in "
        f"{time.perf_counter() - tic:.1f} s")
    rec = drive("gcn hyb D^-1A", "gcn", "asym", GCNModel(exe, dims), exe)
    apart(check_transposed, exe, ops["a_rn_t"], n, "hyb (D^-1 A)", rn_nnz)
    view = transposed_view(exe)
    k1_b, _, _, k4_b, k4a_b = (v * TRAIN_STEPS
                               for v in rec["launches_backward"])
    kernels.append(apart(k1_format_numbers, view, "hyb^T", hidden, k1_b, n,
                         phase="phase 13"))
    kernels += apart(k4_format_numbers, view, "hyb^T", hidden,
                     (k4_b, k4a_b), n)
    tic = time.perf_counter()
    got = label_propagation(exe, labels, seed_mask,
                            iterations=SOLVER_ITERS["label_propagation"])
    t_dev = time.perf_counter() - tic
    err = check_solver("label_propagation", got,
                       host_result("label_propagation"), rn_nnz)
    results["label_propagation hyb D^-1A"] = {"rel_err": err, "s": t_dev}
    log(f"phase 13 label_propagation (hyb over D^-1 A, "
        f"{SOLVER_ITERS['label_propagation']} iterations, 4 classes): rel "
        f"err {err:.3e}; {t_dev:.2f} s")
    del exe, view
    torch.cuda.empty_cache()

    tic = time.perf_counter()
    fold = MultiLevelArrow(rn_levels, width, fmt="fold", device=dev)
    torch.cuda.synchronize()
    log(f"phase 13 fold over D^-1 A: built in "
        f"{time.perf_counter() - tic:.1f} s")
    rec = drive("gcn_carried fold D^-1A", "gcn", "asym",
                GCNCarried(fold, dims), fold)
    apart(check_transposed, fold, ops["a_rn_t"], n, "fold (D^-1 A)",
          rn_nnz)
    k1_b, _, _, k4_b, _ = (v * TRAIN_STEPS for v in rec["launches_backward"])
    kernels += apart(fold_transposed_numbers, fold, hidden, (k1_b, k4_b),
                     n)
    del fold, rn_levels
    torch.cuda.empty_cache()

    cn_levels = scaled_levels(levels, cols=1.0 / deg)
    tic = time.perf_counter()
    exe = MultiLevelArrow(cn_levels, width, fmt="hyb", device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - tic
    tic = time.perf_counter()
    got = pagerank(exe, damping=0.85,
                   iterations=SOLVER_ITERS["pagerank"])
    t_dev = time.perf_counter() - tic
    err = check_solver("pagerank", got, host_result("pagerank"), row_nnz)
    results["pagerank hyb A D^-1"] = {"rel_err": err, "s": t_dev,
                                      "build_s": t_build}
    log(f"phase 13 pagerank (hyb over A D^-1, built in {t_build:.1f} s, "
        f"{SOLVER_ITERS['pagerank']} iterations): rel err {err:.3e}; "
        f"{t_dev:.2f} s")
    del exe, cn_levels, ops, a
    torch.cuda.empty_cache()

    # -- dense at phase 7's shape: K2/K3 over transposed blocks -------------
    n16 = 1 << min(16, n.bit_length() - 1)
    tic = time.perf_counter()
    levels16 = arrow_decomposition(barabasi_albert(n16, 8, seed=7), width,
                                   max_levels=10, block_diagonal=True,
                                   seed=7)
    a16 = host_matrix(levels16, n16)
    deg16 = np.maximum(np.asarray(a16.sum(axis=1)).ravel(), 1.0)
    a16_rn = a16.multiply(1.0 / deg16[:, None]).tocsr()
    rn16 = scaled_levels(levels16, rows=1.0 / deg16)
    x16, y16 = random_dense(n16, k_in, seed=26), random_dense(n16, k_out,
                                                             seed=27)
    exe = MultiLevelArrow(rn16, width, fmt="dense", device=dev)
    torch.cuda.synchronize()
    log(f"phase 13 dense over D^-1 A at n={n16} ({len(levels16)} levels): "
        f"decomposed and built in {time.perf_counter() - tic:.1f} s")
    model = GCNModel(exe, dims)
    gold16 = host_model("gcn", HostOp(a16_rn), HostOp(a16_rn.T.tocsr()),
                        x16.astype(np.float64), y16.astype(np.float64),
                        model_params(model.params))
    rec = drive(f"gcn dense D^-1A n={n16}", "gcn", "asym", model, exe,
                gold16, (x16, y16, a16.nnz / n16))
    apart(check_transposed, exe, a16_rn.T.tocsr(), n16, "dense (D^-1 A)",
          a16.nnz / n16)
    view = transposed_view(exe)
    _, k2_b, k3_b, k4_b, k4a_b = (v * TRAIN_STEPS
                                  for v in rec["launches_backward"])
    more, _ = apart(
        dense_kernel_numbers,
        [b for b, f in zip(view.blocks, view.fmts) if f == "dense"], hidden,
        (k2_b, k3_b), f"dense^T,f32,k={hidden}",
        relative_tolerance(max(exe.widths)), dev, "phase 13")
    kernels += more
    kernels += apart(k4_format_numbers, view, "dense^T", hidden,
                     (k4_b, k4a_b), n16)
    del exe, view, model
    torch.cuda.empty_cache()

    totals = tuple(c - a for c, a in zip(counters(), aside))
    log(f"phase 13 main path: " + ", ".join(
        f"{k}.LAUNCHES = {v}" for k, v in zip(KERNEL_NAMES, totals))
        + "; inside backwards over asymmetric operators: " + ", ".join(
        f"{k} {v}" for k, v in zip(KERNEL_NAMES, backward_asym)))
    idle = [k for k, v in zip(KERNEL_NAMES, totals) if not v]
    if idle:
        raise SystemExit(f"phase 13: {idle} launched no time")
    idle = [k for k, v in zip(KERNEL_NAMES[:4], backward_asym) if not v]
    if idle:
        raise SystemExit(f"phase 13: {idle} ran in no backward over an "
                         f"asymmetric operator")
    results["launches"] = dict(zip(KERNEL_NAMES, totals))
    results["backward_asymmetric_launches"] = dict(zip(KERNEL_NAMES,
                                                       backward_asym))
    # Phase 21 (a) iterates the same solvers and trains the same GCN over
    # the same A and inputs.
    solvers = {"n": n, "shift": shift, "power": host["power_iteration"],
               "cg": host["conjugate_gradient"], "gcn": host["gcn_a"]}
    return results, kernels, solvers


# -- 15. the serving runtime ---------------------------------------------------

#: Phase 15's deployment: the trace (tenants, requests, k, iterations,
#: seed), the batch width and the queue.
SERVE = dict(tenants=4, requests=32, k=16, iterations=10, seed=7,
             max_batch_k=128, queue=64)
#: Phase 15's gate scenarios: the first requests of the trace, fewer
#: iterations (tools/serve_gate.py's 8 requests of 4 iterations).
GATE = dict(requests=8, iterations=4)
#: serve_kill's subprocess graph: BA n = 2^16 at width 2048, so that its
#: three decompositions fit the time limit (the phase's 2^20 graph takes
#: about 120 s to generate and decompose).
SERVE_KILL = dict(vertices=1 << 16, width=2048, features=16, tenants=4,
                  requests=8, iterations=4, seed=11, after=18)


class TimedExecutor:
    """A ``MultiLevelArrow`` as the server calls it, timed: one record a
    batch in ``log`` with the host ms of ``set_features`` and
    ``gather_result``, and the CUDA-event device ms and host wall ms
    from the end of ``set_features`` to the start of ``gather_result``
    (the supervised loop).  Every other attribute is the executor's."""

    def __init__(self, ex):
        self.ex = ex
        self.log = []

    def __getattr__(self, name):
        return getattr(self.ex, name)

    def set_features(self, x):
        import torch

        tic = time.perf_counter()
        out = self.ex.set_features(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.log.append({"k": int(x.shape[1]), "start": start,
                         "wall0": time.perf_counter(),
                         "set_features_ms":
                             (time.perf_counter() - tic) * 1e3})
        return out

    def step(self, x):
        return self.ex.step(x)

    def gather_result(self, y):
        import torch

        rec = self.log[-1]
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        rec["device_ms"] = rec.pop("start").elapsed_time(end)
        rec["loop_wall_ms"] = (time.perf_counter() - rec.pop("wall0")) * 1e3
        tic = time.perf_counter()
        out = self.ex.gather_result(y)
        rec["gather_ms"] = (time.perf_counter() - tic) * 1e3
        return out


def serve_factory(levels, width: int, dev, built: dict):
    """The phase's executor factory: a closure over phase 4's levels
    that builds the fold ``MultiLevelArrow`` of a ladder rung once (the
    server caches it too; later servers of the phase reuse it).  A rung
    that differs from a built one only in its column schedule (``repl``,
    ``overlap_slabs``: how the fold runs, not how it is packed) is that
    executor with its schedule set, sharing its packed operator."""
    import copy

    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    def factory(cfg):
        key = (cfg.kernel, cfg.repl, cfg.overlap_slabs, cfg.feature_dtype)
        if key not in built:
            packed = next((t.ex for k, t in built.items()
                           if (k[0], k[3]) == (key[0], key[3])), None)
            if packed is None:
                ex = MultiLevelArrow(
                    levels, width, fmt="fold", kernel=cfg.kernel,
                    repl=cfg.repl, overlap_slabs=cfg.overlap_slabs,
                    feature_dtype=cfg.feature_dtype, device=dev)
            else:
                ex = copy.copy(packed)
                ex.repl, ex.overlap_slabs = cfg.repl, cfg.overlap_slabs
            built[key] = TimedExecutor(ex)
        return built[key]

    return factory


def result_bytes(tickets) -> dict:
    return {t.request.request_id: t.result.tobytes() for t in tickets
            if t.result is not None}


def serve_alone(serve, factory, request, policy):
    """``request`` served alone (no batching) on the base rung."""
    srv = serve.ArrowServer(factory, serve.ExecConfig(), policy=policy,
                            name="alone")
    (t,) = serve.run_trace(srv, [request])
    if t.status != "completed":
        raise SystemExit(f"phase 15: {request.request_id} alone: {t.status}")
    return t.result


def phase_serve_batches(serve, factory, trace, n: int, row_nnz: float,
                        x16, gold16, policy) -> tuple:
    """Phase 15 step 1: the trace at full width, batched to k = 128."""
    import dataclasses

    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    it, kmax = SERVE["iterations"], SERVE["max_batch_k"]
    trace = list(trace)
    trace[0] = dataclasses.replace(trace[0], x=x16)   # phase 4's input
    base = factory(serve.ExecConfig())
    srv = serve.ArrowServer(factory, serve.ExecConfig(), policy=policy,
                            queue_capacity=SERVE["queue"],
                            max_batch_k=kmax, name="phase15")
    base.log.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bytes = torch.cuda.memory_allocated()
    reset_counters()
    tic = time.perf_counter()
    tickets = serve.run_trace(srv, trace)
    wall = time.perf_counter() - tic
    launches = counters()
    peak = torch.cuda.max_memory_allocated() - before_bytes
    s = srv.summary()
    bad = [t.request.request_id for t in tickets if t.status != "completed"]
    if bad or s["faults_seen"]:
        raise SystemExit(f"phase 15: not completed {bad}, faults "
                         f"{s['faults_seen']}")
    per = k1_per_product(base.sell, kmax, torch.float32)
    if s["batches"] != SERVE["requests"] * SERVE["k"] // kmax:
        raise SystemExit(f"phase 15: {s['batches']} batches")
    if launches[0] != s["batches"] * it * per or any(launches[1:]):
        raise SystemExit(f"phase 15: launches {launches}, expected K1 "
                         f"{s['batches']} batches x {it} x {per} and no "
                         f"other kernel")
    # Each batch: its first request alone equals its slice bit for bit.
    per_batch = kmax // SERVE["k"]
    for b in range(s["batches"]):
        t = tickets[b * per_batch]
        alone = serve_alone(serve, factory, t.request, policy)
        if alone.tobytes() != t.result.tobytes():
            raise SystemExit(f"phase 15: {t.request.request_id} batched != "
                             f"alone")
    err = relative_error(tickets[0].result, gold16)
    tol = relative_tolerance(row_nnz, it)
    if not err <= tol:
        raise SystemExit(f"phase 15: phase 4's input after {it} served "
                         f"steps: rel err {err:.3e} > {tol:.1e}")
    prices = [sum(t.predicted_bytes for t in tickets[b * per_batch:
                                                     (b + 1) * per_batch])
              for b in range(s["batches"])]
    if min(prices) < peak:
        raise SystemExit(f"phase 15: a batch's price {min(prices)} B is "
                         f"below the measured peak {peak} B")
    batches = [rec for rec in base.log if rec["k"] == kmax]
    concat_ms = []
    for b in range(s["batches"]):
        xs = [t.request.x for t in tickets[b * per_batch:(b + 1) *
                                            per_batch]]
        tic = time.perf_counter()
        np.concatenate(xs, axis=1)
        concat_ms.append((time.perf_counter() - tic) * 1e3)
    lat = serve.latency_summary_ms(tickets)
    out = {"requests": len(tickets), "wall_s": wall,
           "requests_per_s": len(tickets) / wall,
           "latency_ms": lat, "batches": s["batches"],
           "k1_launches": launches[0], "k1_per_product": per,
           "batch_device_ms": [r["device_ms"] for r in batches],
           "batch_loop_wall_ms": [r["loop_wall_ms"] for r in batches],
           "set_features_ms": [r["set_features_ms"] for r in batches],
           "gather_result_ms": [r["gather_ms"] for r in batches],
           "concat_ms": concat_ms,
           "batch_price_bytes": prices, "measured_peak_bytes": peak,
           "price_k128_bytes": base.carriage_hbm_bytes(kmax),
           "resident_bytes": s["hbm"]["resident_bytes"],
           "budget_bytes": s["hbm"]["budget_bytes"],
           "phase4_input_err": err, "phase4_input_gate": tol}
    log(f"phase 15 serve: {len(tickets)} requests (k={SERVE['k']}, "
        f"{it} iterations, {SERVE['tenants']} tenants) in {s['batches']} "
        f"batches of k={kmax}: {out['requests_per_s']:.2f} req/s, p50 "
        f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms, wall {wall:.2f} s; "
        f"K1 {launches[0]} launches ({s['batches']} x {it} x {per}); "
        f"batch device ms {[round(v, 3) for v in out['batch_device_ms']]} "
        f"(loop wall {[round(v, 3) for v in out['batch_loop_wall_ms']]}), "
        f"host ms: set_features "
        f"{[round(v, 1) for v in out['set_features_ms']]}, gather_result "
        f"{[round(v, 1) for v in out['gather_result_ms']]}, concat "
        f"{[round(v, 1) for v in concat_ms]}; price of a batch "
        f"{prices[0]} B >= measured peak {peak} B (price at k={kmax} "
        f"{out['price_k128_bytes']} B); every batch's first request "
        f"alone equals its slice bit for bit; phase 4's input after {it} "
        f"steps {err:.3e} (gate {tol:.1e})")
    return out, tickets


def phase_serve_ladder(serve, faults, factory, trace, policy) -> dict:
    """Phase 15 step 2: one k = 128 batch on each rung of the ladder
    from repl=2, overlap_slabs=2, then an error plan that exhausts the
    retries twice, walking the tenant down to the last rung."""
    import dataclasses

    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell

    it, kmax = SERVE["iterations"], SERVE["max_batch_k"]
    batch = [dataclasses.replace(r, tenant="ladder")
             for r in trace[:kmax // SERVE["k"]]]
    rungs = serve.degradation_ladder(serve.ExecConfig(repl=2,
                                                      overlap_slabs=2))
    results, launches = [], []
    for cfg in rungs:
        srv = serve.ArrowServer(factory, cfg, policy=policy,
                                max_batch_k=kmax, name="rung")
        ex = factory(cfg)
        slabs = cfg.repl * cfg.overlap_slabs
        want = it * slabs * k1_per_product(ex.sell, kmax // slabs,
                                           torch.float32)
        before = cuda_sell.LAUNCHES
        tickets = serve.run_trace(srv, batch)
        got = cuda_sell.LAUNCHES - before
        if srv.batches != 1 or got != want or any(
                t.status != "completed" for t in tickets):
            raise SystemExit(f"phase 15 rung {cfg}: {srv.batches} batches, "
                             f"{got} K1 launches (expected {want})")
        results.append(result_bytes(tickets))
        launches.append(got)
        if results[-1] != results[0]:
            raise SystemExit(f"phase 15 rung {cfg} != the base rung")
    faults.set_plan({"scenario": "error", "site": "multi_level.step",
                     "after": 0, "count": 2 * (len(rungs) - 1)})
    try:
        srv = serve.ArrowServer(
            factory, rungs[0], max_batch_k=kmax, degrade_after=1,
            policy=dataclasses.replace(policy, max_retries=1), name="walk")
        tickets = serve.run_trace(srv, batch)
    finally:
        faults.clear_plan()
    s = srv.summary()
    walk = [(d["from"], d["to"]) for d in s["tenants"]["ladder"][
        "degradations"]]
    want_walk = [(dataclasses.asdict(a), dataclasses.asdict(b))
                 for a, b in zip(rungs, rungs[1:])]
    if (walk != want_walk or result_bytes(tickets) != results[0]
            or s["faults_seen"] != 2 * (len(rungs) - 1)
            or any(t.attempts != len(rungs) for t in tickets)):
        raise SystemExit(f"phase 15 ladder walk: {walk}, faults "
                         f"{s['faults_seen']}, attempts "
                         f"{[t.attempts for t in tickets]}")
    log(f"phase 15 ladder: rungs "
        f"{[(c.repl, c.overlap_slabs) for c in rungs]} each equal to the "
        f"base bit for bit, K1 launches a batch {launches} ({it} steps x "
        f"c x S x launches a product); an error plan exhausting the "
        f"retries walked the tenant down every rung ({s['faults_seen']} "
        f"faults) to the same bits")
    return {"rungs": [dataclasses.asdict(c) for c in rungs],
            "k1_launches": launches, "walk_faults": s["faults_seen"]}


def phase_serve_gate(factory, trace, work: str) -> dict:
    """Phase 15 step 3: the port's ``tools/serve_gate.py`` in-process
    scenarios (``serve_hang``, ``serve_corrupt``, ``serve_overflow``,
    ``serve_hbm``, and its ``serve_nan``) over phase 15's factory on the
    card and the first :data:`GATE` requests of its trace, each ending
    bit-equal to the fault-free replay."""
    import dataclasses

    from arrow_matrix_tpu_torch.tools import serve_gate

    gate = [dataclasses.replace(r, iterations=GATE["iterations"])
            for r in trace[:GATE["requests"]]]
    names = ("serve_hang", "serve_corrupt", "serve_overflow", "serve_hbm",
             "serve_nan")
    tic = time.perf_counter()
    problems, ran = serve_gate.run_serve_scenarios(
        work, fast=True, factory=factory, trace=gate, scenarios=names)
    if problems or list(ran) != list(names):
        raise SystemExit(f"phase 15 gate scenarios failed: {problems} "
                         f"(ran {ran})")
    out = {"scenarios": list(ran), "seconds": time.perf_counter() - tic}
    log(f"phase 15 gate (tools/serve_gate.py): {list(ran)} each recovered "
        f"to the fault-free replay's bits ({out['seconds']:.1f} s)")
    return out


def serve_cli(work: str, name: str) -> tuple:
    """``graft_serve``'s command at :data:`SERVE_KILL`'s arguments, its
    environment (the checkout on the path, no fault plan) and a fresh
    working directory ``work/name``."""
    c = SERVE_KILL
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("AMT_FAULT_PLAN", None)
    cwd = os.path.join(work, name)
    os.makedirs(cwd, exist_ok=True)
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_serve",
           "--vertices", str(c["vertices"]), "--width", str(c["width"]),
           "--features", str(c["features"]), "--tenants", str(c["tenants"]),
           "--requests", str(c["requests"]), "--iterations",
           str(c["iterations"]), "--seed", str(c["seed"]),
           "--checkpoint_every", "2"]
    return cmd, env, cwd


def phase_serve_kill(work: str) -> dict:
    """Phase 15 step 4: ``graft_serve`` as a subprocess on the card,
    SIGKILLed by a kill plan, rerun from its checkpoints; its results
    equal a never-killed run's bit for bit.  The never-killed results
    stay in ``work`` (``ref_path``) for phase 16."""
    import subprocess

    import numpy as np

    c = SERVE_KILL
    cmd, env, cwd = serve_cli(work, "serve_kill")
    ref_cwd = serve_cli(work, "serve_kill_ref")[2]

    def start(extra, plan=None, where=cwd):
        e = dict(env)
        if plan is not None:
            e["AMT_FAULT_PLAN"] = json.dumps(plan)
        return (subprocess.Popen(cmd + extra, env=e, cwd=where,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
                time.perf_counter())

    def finish(started):
        proc, tic = started
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SystemExit(f"phase 15 serve_kill: {proc.args} ran past "
                             f"300 s")
        return (subprocess.CompletedProcess(proc.args, proc.returncode,
                                            stdout, stderr),
                time.perf_counter() - tic)

    ref, out, ck = (os.path.join(cwd, f) for f in ("ref.npz", "kill.npz",
                                                     "ck"))
    # The never-killed run beside the killed one and its rerun.
    first = start(["--results_out", ref], where=ref_cwd)
    try:
        r2, s2 = finish(start(["--results_out", out, "--checkpoint", ck],
                              {"scenario": "kill", "site": "*.step",
                               "after": c["after"]}))
        r3, s3 = finish(start(["--results_out", out, "--checkpoint", ck]))
    finally:
        r1, s1 = finish(first)
    if r1.returncode or r2.returncode != -9 or r3.returncode:
        raise SystemExit(f"phase 15 serve_kill: exit codes {r1.returncode}, "
                         f"{r2.returncode}, {r3.returncode}: "
                         f"{(r1.stderr + r3.stderr)[-800:]}")
    if "resumed request" not in r3.stdout:
        raise SystemExit("phase 15 serve_kill: the rerun resumed nothing")
    with np.load(ref) as a, np.load(out) as b:
        if sorted(a.files) != sorted(b.files) or len(a.files) != \
                c["requests"] or any(a[f].tobytes() != b[f].tobytes()
                                     for f in a.files):
            raise SystemExit("phase 15 serve_kill: the resumed results "
                             "differ from the never-killed run")
    resumed = [ln for ln in r3.stdout.splitlines() if "resumed request" in ln]
    log(f"phase 15 serve_kill (BA n={c['vertices']} width {c['width']}, a "
        f"smaller graph so that three subprocess decompositions fit; the "
        f"never-killed run beside the other two): "
        f"killed at step hit {c['after']}, rerun {resumed[0].strip()!r} "
        f"and {len(resumed) - 1} more; {c['requests']} results equal the "
        f"never-killed run bit for bit; subprocess seconds {s1:.1f}, "
        f"{s2:.1f}, {s3:.1f}")
    kept = os.path.join(work, "serve_kill_ref.npz")
    os.replace(ref, kept)
    shutil.rmtree(cwd, ignore_errors=True)
    shutil.rmtree(ref_cwd, ignore_errors=True)
    return {"subprocess_s": [s1, s2, s3], "resumed": len(resumed),
            "ref_path": kept}


def phase_serve(dev, levels, n: int, width: int, row_nnz: float, x16,
                gold16, work: str) -> tuple:
    """Phase 15: the serving runtime on phase 4's decomposition.
    Returns (results, K1's kernel entry at the serve batch's shape, what
    phase 16 serves again: the factory, the policy, the trace as served
    and its results by request id)."""
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from arrow_matrix_tpu_torch import faults, serve
    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    t_phase = time.perf_counter()
    built = {}
    factory = serve_factory(levels, width, dev, built)
    policy = faults.RetryPolicy(max_retries=2, backoff_s=0.01, jitter=0.2,
                                seed=SERVE["seed"])
    tic = time.perf_counter()
    trace = serve.synthetic_trace(n, tenants=SERVE["tenants"],
                                  requests=SERVE["requests"], k=SERVE["k"],
                                  iterations=SERVE["iterations"],
                                  seed=SERVE["seed"])
    t_trace = time.perf_counter() - tic
    results, tickets = phase_serve_batches(serve, factory, trace, n,
                                           row_nnz, x16, gold16, policy)
    results["trace_s"] = t_trace
    # Step 4's subprocesses, which time nothing, beside steps 2 and 3.
    kill = ThreadPoolExecutor(1)
    try:
        killed = kill.submit(phase_serve_kill, work)
        results["ladder"] = phase_serve_ladder(serve, faults, factory, trace,
                                               policy)
        results["gate"] = phase_serve_gate(factory, trace, work)
        ctx = {"factory": factory, "policy": policy,
               "trace": [t.request for t in tickets],
               "results": {t.request.request_id: t.result for t in tickets}}
        del tickets, trace
        results["kill"] = killed.result()
    finally:
        kill.shutdown(wait=True)

    # K1 at the serve batch's shape, against its plain version.
    ex = factory(serve.ExecConfig())
    sell, k = ex.sell, SERVE["max_batch_k"]
    x = ex.set_features(random_dense(n, k, seed=5))
    got = cuda_sell.sell_spmm_cuda(sell, x)
    want = sell_spmm(sell, x)
    torch.cuda.synchronize()
    err, ok = compare(got, want, row_nnz, exact=False)
    if not ok:
        raise SystemExit(f"phase 15: K1 != plain at k={k} (max abs err "
                         f"{err:.3e})")
    del got, want
    runs = cuda_runs(lambda: cuda_sell.sell_spmm_cuda(sell, x), 20)
    ms = statistics.median(runs)
    plain_ms = cuda_ms(lambda: sell_spmm(sell, x), 3)
    a_csr = sorted_csr(sell, x.dtype)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 5)
    bytes_, flops = fold_work(sell, ex.nnz, k)
    t_bytes, t_ops = (bytes_ / HBM_BYTES_PER_S * 1e3,
                      flops / F32_FLOPS * 1e3)
    busy = SERVE["iterations"] * ms
    walls = [d + s + g for d, s, g in zip(results["batch_loop_wall_ms"],
                                          results["set_features_ms"],
                                          results["gather_result_ms"])]
    results.update(k1_ms=ms, k1_runs=runs, k1_plain_ms=plain_ms,
                   k1_library_ms=library_ms, k1_max_abs_err=err,
                   k1_bound_ms=max(t_bytes, t_ops),
                   k1_bound_by="bytes" if t_bytes >= t_ops else "operations",
                   batch_busy_ms=busy, batch_wall_ms=walls,
                   device_busy_share=[busy / w for w in walls],
                   phase_s=time.perf_counter() - t_phase)
    log(f"phase 15 K1 at the batch shape (k={k}): {ms:.4f} ms/product "
        f"(median of 20), plain {plain_ms:.4f} ms, torch.sparse.mm "
        f"{library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms; a batch's "
        f"{SERVE['iterations']} products {busy:.3f} ms of its "
        f"{[round(w, 1) for w in walls]} ms wall (device busy share "
        f"{[round(busy / w, 4) for w in walls]}); phase 15 "
        f"{results['phase_s']:.1f} s")
    entry = {"name": f"sell_tier_spmm[serve,f32,k={k}]", "route": "cuda",
             "source": SOURCES["K1"], "replaces": REPLACES["K1"],
             "launches": results["k1_launches"], "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
    del x, a_csr, ex, built
    torch.cuda.empty_cache()
    return results, entry, ctx


# -- 16. observed serving -----------------------------------------------------

#: Phase 16's pulse window (s), and the seconds it should stay within.
OBSERVE = dict(window_s=0.5, budget_s=90.0)
#: K1's kernels by name: the tier kernel, and the sum of split rows.
K1_NAMES = ("sell_kernel", "sum_rows_kernel")


def k1_events(prof) -> list:
    """K1's kernel events in a profile, matched on their demangled
    names."""
    names = demangle("\n".join(k["name"] for k in prof.kernels)
                     ).splitlines()
    if len(names) != len(prof.kernels):
        names = [k["name"] for k in prof.kernels]
    return [k for k, name in zip(prof.kernels, names)
            if any(s in name for s in K1_NAMES)]


def profile_shares(prof) -> dict:
    """Kernel time, copy time and K1 time of a profile over its window."""
    kernel_us = sum(k["dur"] for k in prof.kernels)
    copy_us = sum(c["dur"] for c in prof.copies)
    k1 = k1_events(prof)
    return {"window_ms": prof.wall_us / 1e3,
            "kernel_ms": kernel_us / 1e3, "copy_ms": copy_us / 1e3,
            "k1_launches": len(k1),
            "k1_ms": sum(k["dur"] for k in k1) / 1e3,
            "k1_ms_per_launch": (sum(k["dur"] for k in k1) / 1e3 / len(k1)
                                 if k1 else None),
            "kernel_share": kernel_us / prof.wall_us,
            "device_share": (kernel_us + copy_us) / prof.wall_us,
            "kernels": len(prof.kernels), "trace": prof.path}


def scrape_loop(url: str, stop, out: list) -> None:
    """Fetch ``/metrics``, ``/pulse.json`` and ``/healthz`` every 0.25 s
    until ``stop`` is set; each reply (or error) lands in ``out`` with
    its host time."""
    import urllib.request

    while True:
        for path in ("/metrics", "/pulse.json", "/healthz"):
            try:
                with urllib.request.urlopen(url + path, timeout=10) as r:
                    out.append((time.perf_counter(), path, r.status,
                                r.read().decode()))
            except OSError as e:
                out.append((time.perf_counter(), path, None, repr(e)))
        if stop.wait(0.25):
            return


def bit_equal(a, b) -> bool:
    import numpy as np

    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def observe_serve(ctx: dict, run_dir: str, dev, p15: dict) -> dict:
    """Phase 16 (a): phase 15's trace served again with a pulse monitor
    (window 0.5 s, the default burn rules), a tracer, a scrape endpoint
    on port 0 scraped during the run, and a ledger under ``run_dir``."""
    import threading

    import torch

    from arrow_matrix_tpu_torch import serve
    from arrow_matrix_tpu_torch.ledger import Ledger, device_stamp, record
    from arrow_matrix_tpu_torch.obs import Tracer, pulse

    it, kmax = SERVE["iterations"], SERVE["max_batch_k"]
    # The first half of phase 15's trace (two k = 128 batches).
    factory, trace = ctx["factory"], ctx["trace"][:len(ctx["trace"]) // 2]
    ledger_dir = os.path.join(run_dir, "ledger")
    ring = os.path.join(run_dir, "pulse_ring.json")
    tracer = Tracer("phase16")
    monitor = pulse.PulseMonitor(window_s=OBSERVE["window_s"],
                                 ring_path=ring, ledger_dir=ledger_dir,
                                 watchdog=pulse.SloWatchdog(),
                                 name="phase16")
    srv = serve.ArrowServer(factory, serve.ExecConfig(),
                            policy=ctx["policy"],
                            queue_capacity=SERVE["queue"], max_batch_k=kmax,
                            tracer=tracer, name="phase16")
    srv.attach_pulse(monitor)
    endpoint = pulse.PulseEndpoint(monitor, port=0).start()
    scrapes, stop = [], threading.Event()
    scraper = threading.Thread(target=scrape_loop,
                               args=(endpoint.url, stop, scrapes),
                               daemon=True)
    try:
        torch.cuda.synchronize()
        reset_counters()
        scraper.start()
        tic = time.perf_counter()
        tickets = serve.run_trace(srv, trace)
        toc = time.perf_counter()
        launches = counters()
        stop.set()
        scraper.join(30)
        monitor.close()
    finally:
        stop.set()
        endpoint.stop()
    wall = toc - tic
    s = srv.summary()
    summary = serve.slo_summary(srv, tickets, wall, pulse=monitor)
    name = torch.cuda.get_device_name(0)
    rec = record("serve", "requests_per_s", summary["requests_per_s"],
                 directory=ledger_dir, unit="req/s",
                 knobs={"requests": len(trace), "k": SERVE["k"],
                        "iterations": it, "max_batch_k": kmax},
                 payload={key: summary[key] for key in (
                     "requests", "completed", "wall_s", "latency_ms",
                     "batches")},
                 **device_stamp(dev))
    bad = []
    per = k1_per_product(factory(serve.ExecConfig()).sell, kmax,
                         torch.float32)
    if [t.status for t in tickets] != ["completed"] * len(trace) \
            or s["faults_seen"]:
        bad.append(f"statuses {[t.status for t in tickets]}, faults "
                   f"{s['faults_seen']}")
    unequal = [t.request.request_id for t in tickets
               if t.result is None or not bit_equal(
                   t.result, ctx["results"][t.request.request_id])]
    if unequal:
        bad.append(f"results differ from phase 15's: {unequal}")
    if s["batches"] != len(trace) * SERVE["k"] // kmax or \
            launches[0] != s["batches"] * it * per or any(launches[1:]):
        bad.append(f"{s['batches']} batches, launches {launches} "
                   f"(expected K1 {s['batches']} x {it} x {per} only)")
    ring_doc = pulse.load_ring(ring)
    problems = (pulse.validate_ring(ring_doc)
                + pulse.validate_ring(monitor.snapshot())
                + pulse.validate_exposition(monitor.exposition_text()))
    if problems:
        bad.append(f"ring/exposition: {problems}")
    during = {}
    for t, path, status, body in scrapes:
        if not tic <= t <= toc:
            continue
        if status != 200:
            bad.append(f"scrape {path}: {body}")
            continue
        if path == "/metrics":
            ok = not pulse.validate_exposition(body)
        elif path == "/pulse.json":
            ok = not pulse.validate_ring(json.loads(body))
        else:
            ok = body == "ok\n"
        during[path] = during.get(path, 0) + 1
        if not ok:
            bad.append(f"scrape {path} invalid: {body[:200]}")
    if set(during) != {"/metrics", "/pulse.json", "/healthz"}:
        bad.append(f"scrapes during the run: {during}")
    mlat, rlat = monitor.totals_dict()["latency_ms"], summary["latency_ms"]
    if mlat["count"] != rlat["count"] or \
            len(monitor.merged_latency().values) != rlat["count"] or any(
                abs(mlat[q] - rlat[q]) > 1e-2 for q in ("p50", "p99")):
        bad.append(f"pulse latency {mlat} != SLO report {rlat}")
    spans = [e for e in tracer.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    unstamped = sorted({e["name"] for e in spans
                        if not e["args"].get("request_id")})
    if not spans or unstamped:
        bad.append(f"serve spans without request_id: {unstamped}")
    tracer.save(os.path.join(run_dir, "serve_trace.json"))
    lg = Ledger(ledger_dir)
    kinds = {r["kind"]: r for r in lg.read_all()}
    if lg.validate() or set(kinds) != {"serve", "pulse"} or rec is None \
            or any((r["platform"], r["device_kind"]) != ("gpu", name)
                   for r in kinds.values()):
        bad.append(f"ledger: {lg.validate()}, kinds {sorted(kinds)}, "
                   f"stamps {[(r['platform'], r['device_kind']) for r in kinds.values()]}")
    if bad:
        raise SystemExit(f"phase 16 (a): {'; '.join(bad)}")
    lat = summary["latency_ms"]
    out = {"requests": len(tickets), "wall_s": wall,
           "requests_per_s": len(tickets) / wall, "latency_ms": lat,
           "batches": s["batches"], "k1_launches": launches[0],
           "k1_per_product": per, "windows": len(monitor.series()),
           "scrapes_during_run": during,
           "burn_events": len(monitor.burn_events),
           "ledger_records": sorted(kinds),
           "phase15_requests_per_s": p15["requests_per_s"],
           "phase15_latency_ms": p15["latency_ms"]}
    log(f"phase 16 (a) observed serve: {len(tickets)} requests in "
        f"{s['batches']} batches, {out['requests_per_s']:.2f} req/s, p50 "
        f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms (phase 15 without "
        f"telemetry: {p15['requests_per_s']:.2f} req/s, p50 "
        f"{p15['latency_ms']['p50']:.1f}, p99 "
        f"{p15['latency_ms']['p99']:.1f}); every result bit-equal to phase "
        f"15's; K1 {launches[0]} launches ({s['batches']} x {it} x {per}); "
        f"{out['windows']} windows of {OBSERVE['window_s']} s, ring and "
        f"exposition valid, {sum(during.values())} scrapes during the run "
        f"{during}; pulse count/p50/p99 {mlat['count']}/{mlat['p50']}/"
        f"{mlat['p99']} = report {rlat['count']}/{rlat['p50']:.3f}/"
        f"{rlat['p99']:.3f}; {len(spans)} spans, each with its request_id; "
        f"ledger {sorted(kinds)} valid, stamped gpu / {name}")
    return out


def observe_profile(ctx: dict, run_dir: str, n: int) -> dict:
    """Phase 16 (b): ``utils/logging.trace`` around a chain of 10 fold
    steps at f32 k=16 and around one k=128 batch of (a)."""
    import torch

    from arrow_matrix_tpu_torch import serve
    from arrow_matrix_tpu_torch.obs import Tracer
    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.utils import logging as wb, random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_runs

    factory = ctx["factory"]
    ml = factory(serve.ExecConfig()).ex
    traces = os.path.join(run_dir, "traces")
    steps, kmax = 10, SERVE["max_batch_k"]
    bad = []
    x = ml.set_features(random_dense(n, 16, seed=3))
    ml.run(x, steps)
    torch.cuda.synchronize()
    per16 = k1_per_product(ml.sell, 16, torch.float32)
    tracer = Tracer("phase16b")
    before = cuda_sell.LAUNCHES
    with wb.trace(traces) as prof:
        with tracer.span("fold_chain", k=16, steps=steps):
            ml.run(x, steps)
    counted = cuda_sell.LAUNCHES - before
    chain = profile_shares(prof)
    if not chain["k1_launches"] == counted == steps * per16:
        bad.append(f"fold chain: {chain['k1_launches']} K1 kernels in the "
                   f"profile, {counted} counted, expected {steps} x {per16}")
    if "fold_chain" not in prof.annotations:
        bad.append("fold chain: the span is not in the profile")
    runs = cuda_runs(lambda: ml.run(x, steps), REPS)
    chain.update(k1_ms_per_product=chain["k1_ms"] / steps,
                 cuda_event_ms_per_iter=statistics.median(runs) / steps,
                 cuda_event_runs=[r / steps for r in runs])

    batch = ctx["trace"][:kmax // SERVE["k"]]
    tracer2 = Tracer("phase16b")
    srv = serve.ArrowServer(factory, serve.ExecConfig(),
                            policy=ctx["policy"], max_batch_k=kmax,
                            tracer=tracer2, name="profiled")
    per128 = k1_per_product(ml.sell, kmax, torch.float32)
    torch.cuda.synchronize()
    before = cuda_sell.LAUNCHES
    with wb.trace(traces) as prof2:
        got = serve.run_trace(srv, batch)
    counted = cuda_sell.LAUNCHES - before
    served = profile_shares(prof2)
    if not served["k1_launches"] == counted == steps * per128:
        bad.append(f"batch: {served['k1_launches']} K1 kernels in the "
                   f"profile, {counted} counted, expected {steps} x "
                   f"{per128}")
    missing = sorted({s.name for s in tracer2.spans}
                     - set(prof2.annotations))
    if srv.batches != 1 or missing:
        bad.append(f"batch: {srv.batches} batches, spans missing from "
                   f"the profile {missing}")
    if any(not bit_equal(t.result, ctx["results"][t.request.request_id])
           for t in got):
        bad.append("batch: results differ from phase 15's")
    served["k1_ms_per_product"] = served["k1_ms"] / steps
    if bad:
        raise SystemExit(f"phase 16 (b): {'; '.join(bad)}")
    log(f"phase 16 (b) profiler: fold chain f32 k=16, {steps} steps: "
        f"{chain['k1_launches']} K1 kernels (= {steps} x {per16}, the "
        f"wrapper's count), {chain['kernels']} kernels in all; kernel "
        f"share {chain['kernel_share']:.4f} of the {chain['window_ms']:.3f} "
        f"ms window; K1 {chain['k1_ms_per_launch']:.4f} ms a launch, "
        f"{chain['k1_ms_per_product']:.4f} ms a product (profiler) vs {chain['cuda_event_ms_per_iter']:.4f} ms/iter "
        f"(CUDA events, median of {REPS} chains)"
        + (f", phase 4 {ctx['phase4_ms']:.4f}" if ctx.get("phase4_ms")
           else "")
        + f"; one k={kmax} batch: {served['k1_launches']} K1 kernels (= "
        f"{steps} x {per128}), K1 {served['k1_ms_per_launch']:.4f} ms a "
        f"launch, {served['k1_ms_per_product']:.4f} ms a product, kernels {served['kernel_ms']:.3f} ms + copies "
        f"{served['copy_ms']:.3f} ms of the {served['window_ms']:.1f} ms "
        f"window: kernel share {served['kernel_share']:.4f}, device share "
        f"{served['device_share']:.4f}; spans "
        f"{sorted({s.name for s in tracer2.spans})} annotated; traces "
        f"{chain['trace']}, {served['trace']}")
    return {"chain": chain, "batch": served}


def observe_smoke(run_dir: str) -> dict:
    """Phase 16 (c): ``smoke_serve`` at its defaults on the card."""
    from arrow_matrix_tpu_torch import serve
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.obs import pulse

    out = os.path.join(run_dir, "smoke")
    tic = time.perf_counter()
    summary = serve.smoke_serve(out)
    secs = time.perf_counter() - tic
    with open(os.path.join(out, "serve_summary.json"),
              encoding="utf-8") as fh:
        saved = json.load(fh)
    with open(os.path.join(out, "pulse_metrics.prom"),
              encoding="utf-8") as fh:
        prom = fh.read()
    problems = (pulse.validate_ring(pulse.load_ring(
        os.path.join(out, "pulse_ring.json")))
        + pulse.validate_exposition(prom)
        + Ledger(os.path.join(out, "ledger")).validate())
    if problems or not saved.get("ledger_record_id") or \
            saved["ledger_record_id"] != summary["ledger_record_id"] or \
            summary["completed"] != summary["requests"]:
        raise SystemExit(f"phase 16 (c) smoke_serve: {problems}, "
                         f"ledger_record_id {saved.get('ledger_record_id')},"
                         f" completed {summary['completed']}")
    log(f"phase 16 (c) smoke_serve on the card: {summary['completed']} "
        f"requests in {secs:.1f} s; serve_summary.json, pulse_ring.json, "
        f"pulse_metrics.prom valid; ledger record "
        f"{summary['ledger_record_id']}")
    return {"seconds": secs, "ledger_record_id": summary["ledger_record_id"]}


def observe_cli(work: str, ref_path: str) -> dict:
    """Phase 16 (d): ``graft_serve --pulse --pulse_port 0`` as a
    subprocess at phase 15 (d)'s arguments; its results equal phase 15's
    run of them without ``--pulse`` bit for bit."""
    import subprocess

    import numpy as np

    from arrow_matrix_tpu_torch.obs import pulse

    cmd, env, cwd = serve_cli(work, "serve_pulse")
    obs, out = os.path.join(cwd, "obs"), os.path.join(cwd, "pulse.npz")
    tic = time.perf_counter()
    proc = subprocess.run(cmd + ["--pulse", "--pulse_port", "0",
                                 "--obs_dir", obs, "--results_out", out],
                          env=env, cwd=cwd, capture_output=True, text=True,
                          timeout=300)
    secs = time.perf_counter() - tic
    if proc.returncode:
        raise SystemExit(f"phase 16 (d): graft_serve --pulse exited "
                         f"{proc.returncode}: {proc.stderr[-800:]}")
    bad = []
    with np.load(ref_path) as a, np.load(out) as b:
        files = sorted(f for f in b.files if f != "_pulse_windows")
        if "_pulse_windows" not in b.files or files != sorted(a.files) \
                or any(a[f].tobytes() != b[f].tobytes() for f in files):
            bad.append("results differ from the run without --pulse")
    ring = pulse.load_ring(os.path.join(obs, "pulse_ring.json"))
    bad += pulse.validate_ring(ring)
    with open(os.path.join(obs, "serve_trace.json"), encoding="utf-8") as fh:
        spans = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]
    if not spans or any(not e["args"].get("request_id") for e in spans):
        bad.append("serve_trace.json: spans without request_id")
    if "pulse endpoint at http://" not in proc.stdout:
        bad.append("no pulse endpoint")
    if bad:
        raise SystemExit(f"phase 16 (d): {bad}")
    shutil.rmtree(cwd, ignore_errors=True)
    log(f"phase 16 (d) graft_serve --pulse --pulse_port 0 (BA n="
        f"{SERVE_KILL['vertices']}): {len(files)} results bit-equal to "
        f"phase 15's run without --pulse; ring ({len(ring['windows'])} "
        f"windows) and serve_trace.json ({len(spans)} spans) valid; "
        f"subprocess {secs:.1f} s")
    return {"seconds": secs, "windows": len(ring["windows"]),
            "spans": len(spans)}


def wire_round(host, transport: str, pool) -> dict:
    """``host`` through ``wire.send_msg``/``recv_msg`` over a socket
    pair; host seconds and MB/s of the whole round."""
    import socket
    import threading

    from arrow_matrix_tpu_torch.fleet import wire

    a, b = socket.socketpair()
    got = {}

    def reader():
        got["msg"], got["stats"] = wire.recv_msg_stats(b)

    t = threading.Thread(target=reader, daemon=True)
    st = {}
    try:
        t.start()
        tic = time.perf_counter()
        st = wire.send_msg(a, {"op": "result", "y": host},
                           transport=transport, shm_pool=pool)
        t.join(300)
        secs = time.perf_counter() - tic
    finally:
        for desc in st.get("shm_descs", ()):
            pool.release(desc)
        a.close()
        b.close()
    y = got.get("msg", {}).get("y")
    if y is None or not bit_equal(y, host):
        raise SystemExit(f"phase 16 (e): the {transport} round trip is not "
                         f"bit-equal")
    return {"seconds": secs, "mb_per_s": host.nbytes / 2**20 / secs,
            "frame_bytes": st["frame_bytes"],
            "serialize_ms": st["serialize_ms"]
            + got["stats"]["serialize_ms"]}


def observe_wire(ctx: dict) -> dict:
    """Phase 16 (e): one k=128 batch's result copied from the card to the
    host, then sent as a shared-memory descriptor, and its first quarter
    of rows (128 MiB at 2^20) inline: base64 JSON runs at tens of MB/s,
    so the whole result would take 20 s of the phase's budget."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch import serve
    from arrow_matrix_tpu_torch.fleet import shm, wire

    kmax = SERVE["max_batch_k"]
    ml = ctx["factory"](serve.ExecConfig()).ex
    batch = ctx["trace"][:kmax // SERVE["k"]]
    y = ml.run(ml.set_features(np.concatenate([r.x for r in batch],
                                              axis=1)), SERVE["iterations"])
    torch.cuda.synchronize()
    tic = time.perf_counter()
    host = ml.gather_result(y)
    copy_s = time.perf_counter() - tic
    del y
    if host.shape != (ml.n, kmax) or host.dtype != np.float32:
        raise SystemExit(f"phase 16 (e): result {host.shape} {host.dtype}")
    free = shutil.disk_usage("/dev/shm").free
    need = host.nbytes + (1 << 20)
    log(f"phase 16 (e): /dev/shm free {free} B; a {host.shape} f32 result "
        f"is {host.nbytes} B")
    if free < need:
        raise SystemExit(f"phase 16 (e): /dev/shm has {free} B free, the "
                         f"segment pool needs {need} B")
    inline = wire_round(np.ascontiguousarray(host[:host.shape[0] // 4]),
                        "json", None)
    pool = shm.SegmentPool(slots=1, slot_bytes=host.nbytes, name="phase16")
    try:
        desc = wire_round(host, "shm", pool)
    finally:
        leaks = pool.close(strict=False)
    if leaks:
        raise SystemExit(f"phase 16 (e): the segment pool leaked {leaks}")
    transports = wire.measure_transports()
    log(f"phase 16 (e) host numbers: card-to-host copy of the result "
        f"{copy_s * 1e3:.1f} ms; wire inline (base64 JSON) "
        f"{inline['mb_per_s']:.1f} MB/s ({inline['seconds']:.2f} s, frame "
        f"{inline['frame_bytes']} B), shared-memory descriptor "
        f"{desc['mb_per_s']:.1f} MB/s ({desc['seconds']:.2f} s, frame "
        f"{desc['frame_bytes']} B), both bit-equal; measure_transports "
        f"(1 MiB): {json.dumps(transports)}")
    return {"result_bytes": int(host.nbytes), "dev_shm_free": free,
            "copy_to_host_s": copy_s, "inline": inline, "shm": desc,
            "measure_transports": transports, "host_numbers": True}


def phase_observe(ctx: dict, p15: dict, n: int, work: str, dev) -> tuple:
    """Phase 16: observed serving on the card, on phase 15's factory and
    trace.  Returns (results, K1's kernel entry read from the profiler)."""
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    run_dir = os.path.join(work, "observe")
    os.makedirs(run_dir, exist_ok=True)
    # (d)'s subprocess, which times nothing, beside (a)-(c) and (e).
    with ThreadPoolExecutor(1) as pool:
        cli = pool.submit(observe_cli, work, p15["kill"]["ref_path"])
        results = observe_serve(ctx, run_dir, dev, p15)
        results["profile"] = observe_profile(ctx, run_dir, n)
        results["smoke"] = observe_smoke(run_dir)
        results["wire"] = observe_wire(ctx)
        results["cli"] = cli.result()
    results["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {results['phase_s']:.1f} s (budget "
        f"{OBSERVE['budget_s']:.0f} s)")
    batch = results["profile"]["batch"]
    entry = {"name": f"sell_tier_spmm[observe,f32,k="
                     f"{SERVE['max_batch_k']}]",
             "route": "cuda", "source": SOURCES["K1"],
             "replaces": REPLACES["K1"],
             "launches": results["k1_launches"],
             "profiler_launches": batch["k1_launches"],
             "max_abs_err": p15["k1_max_abs_err"],
             "ms": batch["k1_ms_per_product"],
             "cuda_event_ms": p15["k1_ms"], "plain_ms": p15["k1_plain_ms"],
             "bound_ms": p15["k1_bound_ms"], "bound_by": p15["k1_bound_by"],
             "library_ms": p15["k1_library_ms"]}
    return results, entry


# -- 17. the fleet ------------------------------------------------------------

#: Phase 17 (a): the Serve cell's size.  Two worker processes on the
#: card, each over ``ba_executor_factory(2^20, 2048, seed 11)`` (BA m=3,
#: the fold, K1), ring placement, the wire over shared memory; 8
#: requests at k = 16, 10 iterations.  The ring hashes the names
#: tenant0-tenant7 all onto worker-1, so the trace draws from 9 names
#: with seed 4: 4 tenants (tenant2, 3, 6 and 8), 5 requests on worker-1
#: and 3 on worker-0.  5 s pulse windows, so that a worker idle at the
#: end stays within the ring's gap fill.
FLEET = dict(vertices=1 << 20, width=2048, seed=11, workers=2, tenants=9,
             requests=8, k=16, iterations=10, trace_seed=4, window_s=5.0)
#: Phase 17 (b)-(e): the fleet gate's scenarios at serve_kill's graph
#: (BA n = 2^16, width 2048), and the seconds the phase should stay
#: within.
FLEET_GATE = dict(vertices=SERVE_KILL["vertices"], width=SERVE_KILL["width"],
                  budget_s=200.0)


def smi_query(query: str) -> list:
    """``nvidia-smi --query-...=... --format=csv,noheader,nounits``
    rows, each a list of fields."""
    import subprocess

    out = subprocess.run(["nvidia-smi", query,
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return [[f.strip() for f in line.split(",")]
            for line in out.splitlines() if line.strip()]


def fleet_poll(stop, polls: list) -> None:
    """Every 0.5 s until ``stop``: the card's compute processes (pid,
    used MiB) and its used memory (MiB), as ``nvidia-smi`` reads them."""
    while not stop.wait(0.5):
        polls.append({"apps": smi_query("--query-compute-apps=pid,"
                                        "used_memory"),
                      "used_mib": smi_query("--query-gpu=memory.used")})


def fleet_replay(out: dict) -> None:
    """Phase 17 (a)'s single-process replay on the card (run in a
    thread while the fleet's workers build): the trace through one
    ``ArrowServer`` over the same factory, its results by request id
    and its base executor for K1's numbers."""
    try:
        from arrow_matrix_tpu_torch.serve import (
            ArrowServer,
            ExecConfig,
            ba_executor_factory,
            run_trace,
            synthetic_trace,
        )

        c = FLEET
        tic = time.perf_counter()
        factory, n_rows = ba_executor_factory(c["vertices"], c["width"],
                                              c["seed"], fmt="fold")
        server = ArrowServer(factory, ExecConfig(), name="fleet-ref")
        out["build_s"] = time.perf_counter() - tic
        trace = synthetic_trace(n_rows, tenants=c["tenants"],
                                requests=c["requests"], k=c["k"],
                                iterations=c["iterations"],
                                seed=c["trace_seed"])
        tickets = run_trace(server, trace)
        out["results"] = {t.request.request_id: t.result.tobytes()
                          for t in tickets if t.result is not None}
        out["executor"] = server._executors[server.base_config]
        out["s"] = time.perf_counter() - tic
    except BaseException as e:      # re-raised by the phase's thread
        out["error"] = e


def fleet_clis(run_dir: str) -> dict:
    """``graft_xray report`` and ``graft_pulse merge`` / ``check`` over a
    fleet run dir, each through its ``main`` in this process (a process
    of its own costs seconds to start); each must exit 0."""
    from arrow_matrix_tpu_torch.cli import graft_pulse, graft_xray

    out = {}
    workers = sorted(d for d in os.listdir(run_dir)
                     if d.startswith("worker-"))
    for tag, main, argv in (
            ("graft_xray report", graft_xray.main,
             ["report", run_dir, "--json"]),
            ("graft_pulse merge", graft_pulse.main,
             ["merge"] + [os.path.join(run_dir, w) for w in workers]),
            ("graft_pulse check", graft_pulse.main,
             ["check", os.path.join(run_dir, workers[0])])):
        rc, text = cli_main(main, argv)
        if rc != 0:
            raise SystemExit(f"phase 17: {tag} exited {rc}: {text[-800:]}")
        out[tag] = text.strip().splitlines()[-1]
    return out


def fleet_host(cache: str, out: str) -> None:
    """Phase 17 (a)'s host work in a process of its own: the fleet's
    graph (:data:`FLEET`) decomposed as ``ba_executor_factory``
    decomposes it and saved in ``cache`` (``AMT_BA_CACHE_DIR``), where
    the workers and the replay load it; its seconds in ``out``."""
    from arrow_matrix_tpu_torch.serve import ba_executor_factory

    c = FLEET
    os.environ["AMT_BA_CACHE_DIR"] = cache
    tic = time.perf_counter()
    ba_executor_factory(c["vertices"], c["width"], c["seed"], device="cpu")
    with open(out, "w") as fh:
        json.dump({"t_build": time.perf_counter() - tic}, fh)


def fleet_baseline(dev, work: str, cache: str) -> tuple:
    """Phase 17 (a): ``graft_fleet`` as a subprocess at :data:`FLEET`,
    its single-process replay built in a thread beside it, ``nvidia-smi``
    polled meanwhile; the workers and the replay load the graph's
    decomposition from ``cache`` (:func:`fleet_host`).  Returns
    (results, the replay)."""
    import subprocess
    import threading

    import torch

    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.tools import fleet_gate as gate

    c = FLEET
    name = torch.cuda.get_device_name(dev)
    run_dir, npz = (os.path.join(work, f) for f in ("fleet", "fleet.npz"))
    env = gate.fleet_env()
    env["AMT_BA_CACHE_DIR"] = cache
    replay, polls, stop = {}, [], threading.Event()
    threads = [threading.Thread(target=fleet_replay, args=(replay,),
                                daemon=True),
               threading.Thread(target=fleet_poll, args=(stop, polls),
                                daemon=True)]
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_fleet",
           "--run_dir", run_dir, "--workers", str(c["workers"]),
           "--vertices", str(c["vertices"]), "--width", str(c["width"]),
           "--seed", str(c["seed"]), "--tenants", str(c["tenants"]),
           "--requests", str(c["requests"]), "--k", str(c["k"]),
           "--iterations", str(c["iterations"]),
           "--trace_seed", str(c["trace_seed"]), "--transport", "auto",
           "--window_s", str(c["window_s"]), "--results_npz", npz]
    tic = time.perf_counter()
    os.environ["AMT_BA_CACHE_DIR"] = cache     # the replay's factory
    for t in threads:
        t.start()
    with open(os.path.join(work, "fleet.out"), "w") as out_fh, \
            open(os.path.join(work, "fleet.err"), "w") as err_fh:
        proc = subprocess.Popen(cmd, env=env, cwd=work, stdout=out_fh,
                                stderr=err_fh, text=True)
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - tic
    stop.set()
    threads[0].join(600)
    threads[1].join(10)
    os.environ.pop("AMT_BA_CACHE_DIR", None)
    stdout = open(os.path.join(work, "fleet.out")).read()
    stderr = open(os.path.join(work, "fleet.err")).read()
    verdict = gate.last_json(stdout)
    if rc != 0 or verdict is None:
        raise SystemExit(f"phase 17 (a): graft_fleet exited {rc}: "
                         f"{(stdout + stderr)[-1500:]}")
    if "error" in replay or "results" not in replay:
        raise SystemExit(f"phase 17 (a): the replay failed: "
                         f"{replay.get('error')!r}")
    with open(os.path.join(run_dir, "fleet_report.json")) as fh:
        report = json.load(fh)
    bad = []
    if verdict["completed"] != c["requests"] or verdict["dead_workers"] \
            or verdict["pulse_problems"]:
        bad.append(f"verdict {json.dumps(verdict)}")
    if set(verdict["transports"].values()) != {"shm"} \
            or not verdict["wire_shm_bytes"]:
        bad.append(f"the wire: {verdict['transports']}, shm bytes "
                   f"{verdict['wire_shm_bytes']}")
    bad += gate.check_bit_identity("phase 17 (a)", npz, replay["results"])
    bad += gate.check_exact_pooled_p99("phase 17 (a)", run_dir)
    bad += gate.check_xray_artifacts("phase 17 (a)", run_dir)
    # Budgets: the workers' shares of the card's budget, and each
    # worker's allocator peak within its share.
    hello = report["worker_hello"]
    budgets = {w: h["budget_bytes"] for w, h in hello.items()}
    card = report.get("card_budget_bytes")
    if card is None or sum(budgets.values()) > card:
        bad.append(f"budgets {budgets} against the card's {card}")
    ex = replay["executor"]
    per = k1_per_product(ex.sell, c["k"], torch.float32)
    launches, memory = {}, {}
    for wid, rec in sorted(report["workers"].items()):
        launches[wid] = rec.get("kernel_launches") or {}
        memory[wid] = rec.get("device_memory") or {}
        if hello[wid]["device"] != str(dev):
            bad.append(f"{wid} served on {hello[wid]['device']}")
        if not launches[wid].get("K1") or any(
                launches[wid].get(kern) for kern in KERNEL_NAMES[1:]):
            bad.append(f"{wid} launches {launches[wid]}")
        if not memory[wid].get("max_reserved", 0) <= budgets[wid]:
            bad.append(f"{wid} reserved {memory[wid]} over its budget "
                       f"{budgets[wid]}")
        led = Ledger(os.path.join(run_dir, wid, "ledger"))
        recs = led.read_all()
        if not recs or led.validate() or any(
                (r.get("platform"), r.get("device_kind")) != ("gpu", name)
                for r in recs):
            bad.append(f"{wid} ledger: {len(recs)} records, "
                       f"{led.validate()}, stamps "
                       f"{[(r.get('platform'), r.get('device_kind')) for r in recs]}")
    k1_total = sum(v.get("K1", 0) for v in launches.values())
    if k1_total != c["requests"] * c["iterations"] * per:
        bad.append(f"K1 {k1_total} launches, expected {c['requests']} x "
                   f"{c['iterations']} x {per}")
    # nvidia-smi: this process, the router and each worker hold a
    # context on the card while the fleet serves.
    rows = max((len(p["apps"]) for p in polls), default=0)
    used = max((int(p["used_mib"][0][0]) for p in polls), default=0)
    if rows < c["workers"] + 2 or not all(
            int(r[1]) > 0 for p in polls for r in p["apps"]):
        bad.append(f"nvidia-smi listed at most {rows} compute processes")
    if bad:
        raise SystemExit(f"phase 17 (a): {'; '.join(bad)}")
    clis = fleet_clis(run_dir)
    lat = verdict["latency_ms"]
    builds = {w: h["build_s"] for w, h in hello.items()}
    log(f"phase 17 (a) fleet: {c['workers']} workers on {name}, BA "
        f"n={c['vertices']} m=3 width {c['width']} seed {c['seed']} (fold, "
        f"K1), ring placement, shm wire; {c['requests']} requests (k="
        f"{c['k']}, {c['iterations']} iterations, {c['tenants']} tenants) "
        f"in {wall:.1f} s of subprocess: {verdict['requests_per_s']:.3f} "
        f"req/s, p50 {lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms (the "
        f"exact pooled nearest-rank quantile); worker build s {builds}; "
        f"budget_bytes {budgets} (sum {sum(budgets.values())} <= the "
        f"card's {card}); allocator peaks "
        f"{ {w: m.get('max_reserved') for w, m in memory.items()} } B; "
        f"nvidia-smi: {rows} compute processes at most (pids "
        f"{sorted({r[0] for p in polls for r in p['apps']})}: the "
        f"container's namespace), {used} MiB used at most; "
        f"wire_shm_bytes {verdict['wire_shm_bytes']}; K1 launches "
        f"{ {w: v.get('K1') for w, v in launches.items()} } ({c['requests']}"
        f" x {c['iterations']} x {per}); every result bit-equal to the "
        f"single-process replay (built beside it in "
        f"{replay['build_s']:.1f} s, served in {replay['s']:.1f} s); "
        f"ledgers stamped gpu / {name}; graft_xray and graft_pulse read "
        f"the run dir: {clis['graft_pulse check']}")
    return ({"wall_s": wall, "verdict": verdict, "worker_build_s": builds,
             "budget_bytes": budgets, "card_budget_bytes": card,
             "device_memory": memory, "smi_rows": rows, "smi_used_mib": used,
             "k1_launches": k1_total, "k1_per_product": per,
             "replay_build_s": replay["build_s"], "replay_s": replay["s"],
             "clis": clis}, replay)


def fleet_k1_entry(replay: dict, launches: int) -> tuple:
    """K1 at the fleet's shape (the replay's fold, f32 k = 16) against
    its plain version: the phase's kernel entry (``launches``: the
    workers' count in (a))."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    ex, k, n = replay["executor"], FLEET["k"], FLEET["vertices"]
    sell = ex.sell
    x = ex.set_features(random_dense(n, k, seed=5))
    got = cuda_sell.sell_spmm_cuda(sell, x)
    want = sell_spmm(sell, x)
    torch.cuda.synchronize()
    err, ok = compare(got, want, ex.nnz / n, exact=False)
    if not ok:
        raise SystemExit(f"phase 17: K1 != plain at the fleet's shape (max "
                         f"abs err {err:.3e})")
    del got, want
    ms = statistics.median(cuda_runs(
        lambda: cuda_sell.sell_spmm_cuda(sell, x), 20))
    plain_ms = cuda_ms(lambda: sell_spmm(sell, x), 3)
    a_csr = sorted_csr(sell, x.dtype)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 5)
    bytes_, flops = fold_work(sell, ex.nnz, k)
    t_bytes, t_ops = (bytes_ / HBM_BYTES_PER_S * 1e3,
                      flops / F32_FLOPS * 1e3)
    # As phase 5's: a row and an index read per nonzero, the output once.
    gathered = (ex.nnz * (k * 4 + 4) + n * k * 4) / HBM_BYTES_PER_S * 1e3
    log(f"phase 17 K1 at the fleet's shape (BA 2^20 m=3 fold, {ex.nnz} nnz, "
        f"k={k}): {ms:.4f} ms/product (median of 20), plain {plain_ms:.4f} "
        f"ms, torch.sparse.mm {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms, gathered-bytes bound {gathered:.4f} "
        f"ms; max abs err {err:.3e}")
    return {"name": f"sell_tier_spmm[fleet,f32,k={k}]", "route": "cuda",
            "source": SOURCES["K1"], "replaces": REPLACES["K1"],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def fleet_scenarios(work: str) -> dict:
    """Phase 17 (b)-(e): the port's fleet gate on worker processes on the
    card at :data:`FLEET_GATE`'s graph, the lock witness armed in this
    process: (b) ``fleet_kill``, (c) ``fleet_host_kill``, (d)
    ``router_quorum``, (e) ``fleet_migrate``, run at once; each fatal."""
    from concurrent.futures import ThreadPoolExecutor

    from arrow_matrix_tpu_torch import sync
    from arrow_matrix_tpu_torch.tools import fleet_gate as gate

    shape = gate.GateShape(FLEET_GATE["vertices"], FLEET_GATE["width"],
                           "cuda")
    gate_dir = os.path.join(work, "fleet_gate")
    os.makedirs(gate_dir, exist_ok=True)
    registry = sync.enable_witness()
    try:
        tic = time.perf_counter()
        ref = gate.reference_results(shape)
        ref4 = gate.reference_results(shape, k=4, iters=gate.HOST_KILL_ITERS)
        if ref is None or ref4 is None:
            raise SystemExit("phase 17: the gate's replay did not complete")
        out = {"replay_s": time.perf_counter() - tic}

        def timed(fn, want):
            tic = time.perf_counter()
            problems = fn(gate_dir, want, shape)
            return problems, time.perf_counter() - tic

        # The four scenarios at once: each has its own workers, run dir
        # and checkpoints (and each router its own budget split).
        tic = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as pool:
            runs = [(letter, name, pool.submit(timed, fn, want))
                    for letter, name, fn, want in (
                        ("b", "fleet_kill", gate.scenario_fleet_kill, ref),
                        ("c", "fleet_host_kill",
                         gate.scenario_fleet_host_kill, ref4),
                        ("d", "router_quorum", gate.scenario_router_quorum,
                         ref),
                        ("e", "fleet_migrate", gate.scenario_fleet_migrate,
                         ref))]
            for letter, name, fut in runs:
                problems, out[f"{name}_s"] = fut.result()
                if problems:
                    raise SystemExit(f"phase 17 ({letter}) {name}: "
                                     f"{'; '.join(problems)}")
        out["scenarios_s"] = time.perf_counter() - tic
        snap = registry.snapshot()
    finally:
        sync.disable_witness()
    if snap["violations"]:
        raise SystemExit(f"phase 17: lock witness {snap['violations']}")
    with open(os.path.join(gate_dir, "fleet_host_kill",
                           "fleet_report.json")) as fh:
        shm_bytes = json.load(fh)["wire"]["totals"]["shm_bytes"]
    log(f"phase 17 (b)-(e) at BA n={shape.n} width {shape.width} on the "
        f"card: fleet_kill (the armed worker alone buried, zero loss, "
        f"requeued, a survivor resumed) {out['fleet_kill_s']:.1f} s; "
        f"fleet_host_kill (host-1 buried, shm bytes {shm_bytes}) "
        f"{out['fleet_host_kill_s']:.1f} s; router_quorum (agreement, "
        f"failover, no loss) {out['router_quorum_s']:.1f} s; fleet_migrate "
        f"(handed off, resumed on the destination) "
        f"{out['fleet_migrate_s']:.1f} s; {out['scenarios_s']:.1f} s for "
        f"the four at once; every result bit-equal to the "
        f"single-process replay ({out['replay_s']:.1f} s); lock witness "
        f"{snap['acquisitions']} acquisitions, no violation")
    out["host_kill_shm_bytes"] = shm_bytes
    return out


def phase_fleet(dev, work: str, host: tuple, cache: str) -> tuple:
    """Phase 17: the fleet on the card.  (a) the baseline at the Serve
    cell's size, its graph decomposed into ``cache`` by ``host``
    (:func:`fleet_host`'s process), (b)-(e) the gate's fault scenarios
    at 2^16.  Returns (results, the replay), whose executor
    :func:`fleet_k1_entry` times K1 on."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    os.makedirs(work, exist_ok=True)      # phases 6-8 removed it
    tic = time.perf_counter()
    rec = join_host(*host, "phase 17 (a)'s graph")
    log(f"phase 17 (a): the fleet's graph decomposed in {rec['t_build']:.1f} "
        f"s in a process of its own (waited {time.perf_counter() - tic:.1f} "
        f"s); the workers and the replay load it")
    results, replay = fleet_baseline(dev, work, cache)
    results["graph_build_s"] = rec["t_build"]
    results["scenarios"] = fleet_scenarios(work)
    results["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {results['phase_s']:.1f} s (budget "
        f"{FLEET_GATE['budget_s']:.0f} s)")
    return results, replay


# -- 18. the lens and the ledger -----------------------------------------------

#: Phase 18: the lens at k=128 (f32, bf16), its model's prediction at
#: k=16, the probe's curves at k=16 (8 iterations), the one-step bf16
#: gate of phase 4.
LENS = dict(k=128, dtypes=("f32", "bf16"), iters=20, predict_k=16,
            probe_k=16, probe_iterations=8, probe_dtypes=("f32", "bf16",
                                                          "int8"),
            bf16_gate=2e-2)


def cli_main(main, argv: list) -> tuple:
    """(exit code, stdout) of a CLI's ``main(argv)`` run in this
    process."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def lens_prefix_entry(sell, carriage: str, launches: int, row_nnz: float,
                      dev) -> dict:
    """K1 over the lens's bulk prefix (tiers 0..the last of at most
    :data:`BULK_SLOTS` slots) at k=128 against its plain version, timed
    beside its bounds and ``torch.sparse.mm``: a kernels-line entry of
    phase 18 (``launches``: K1's launches in the phase's profile of
    ``carriage``)."""
    import torch

    from arrow_matrix_tpu_torch.obs.lens import tier_prefix
    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    k = LENS["k"]
    last = max(t for t, c in enumerate(sell.cols)
               if 0 < c.shape[0] <= BULK_SLOTS)
    prefix = tier_prefix(sell, last)
    x = torch.from_numpy(random_dense(sell.n_rows, k, seed=5)).to(dev).to(
        CARRIAGE_DTYPES[carriage])
    got = cuda_sell.sell_spmm_cuda(prefix, x)
    want = sell_spmm(prefix, x)
    torch.cuda.synchronize()
    err, ok = compare(got, want, row_nnz, exact=False)
    if not ok:
        raise SystemExit(f"phase 18: K1 != plain on the bulk prefix "
                         f"({carriage}, max abs err {err:.3e})")
    del got, want
    ms = statistics.median(cuda_runs(
        lambda: cuda_sell.sell_spmm_cuda(prefix, x), 20))
    plain_ms = cuda_ms(lambda: sell_spmm(prefix, x), 3)
    a_csr = sorted_csr(prefix, x.dtype)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 5)
    nnz = int(a_csr.values().numel())
    # The rows the prefix gathers, each read once.
    read = int(torch.unique(a_csr.col_indices()).numel())
    del a_csr
    item = x.element_size()
    op_bytes = 4 * nnz + 4 * prefix.n_rows
    t_bytes = (op_bytes + (read + prefix.n_rows) * k * item) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = nnz * k / F32_FLOPS * 1e3
    gathered = (nnz * (k * item + 4) + prefix.n_rows * k * item) \
        / HBM_BYTES_PER_S * 1e3
    log(f"phase 18 K1 on the bulk prefix (tiers 0-{last}, "
        f"{prefix.n_rows} rows, {nnz} nnz, {read} rows read), {carriage} "
        f"k={k}: {ms:.4f} ms/product (median of 20), plain {plain_ms:.4f} "
        f"ms, torch.sparse.mm {library_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms, gathered-bytes bound "
        f"{gathered:.4f} ms; max abs err {err:.3e}")
    return {"name": f"sell_tier_spmm[lens prefix 0-{last},{carriage},"
                    f"k={k}]", "route": "cuda", "source": SOURCES["K1"],
            "replaces": REPLACES["K1"], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "gather_bound_ms": gathered}


def phase_lens_sweep(dev, levels, width: int, full_a) -> tuple:
    """Phase 18 (e): the lens at K1's knob points with its load-depth
    sweep (``profile_fold(kernel="pallas", ring_sweep=True)``, f32
    k=128) on phase 4's levels, every gate fatal; then the fold step at
    batch 4 through ``MultiLevelArrow(kernel="pallas_sell",
    kernel_opts={"batch": 4})``, its launches counted from 0 just before
    it, and K1 at batch 4 against its plain version, equal bit for bit
    to batch 8, timed beside its bounds and ``torch.sparse.mm`` (a
    kernels-line entry).  ``full_a``: (a)'s f32 ``full_ms``."""
    import torch

    from arrow_matrix_tpu_torch.obs import lens
    from arrow_matrix_tpu_torch.obs.costmodel import predict_iter_ms
    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.ops.worklist import LaunchOpts
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.tune import structure_fingerprint
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    k = LENS["k"]
    reset_counters()
    tic = time.perf_counter()
    prof = lens.profile_fold(levels, width, k, kernel="pallas",
                             ring_sweep=True, feature_dtypes=("f32",),
                             iters=LENS["iters"], device=dev)
    torch.cuda.synchronize()
    out = {"profile_s": time.perf_counter() - tic}
    counts = counters()
    e = prof["dtypes"]["f32"]
    live = [t for t in e["tiers"] if t["slot_width"] > 0]
    want = e["launches"] + sum(t["launches"] + t["sweep_launches"]
                               for t in live)
    model = lens.fit_from_profile(prof)
    problems = lens.check_profile(prof, model)
    ratios = lens.ratio_points(prof, model)
    problems += [f"tier {p['tier']} ratio {p['ratio']:.3f}" for p in ratios
                 if p["tier"] is not None and not
                 lens.LENS_RATIO_MIN <= p["ratio"] <= lens.LENS_RATIO_MAX]
    if abs(e["coverage"] - 1.0) > lens.LENS_COVERAGE_TOL:
        problems.append(f"coverage {e['coverage']:.4f}")
    if counts[0] != want or any(counts[1:]):
        problems.append(f"launches {counts} != the profile's K1 count "
                        f"{want}")
    sweep = prof.get("sweep") or {}
    if sweep.get("bit_equal_tiers") != len(live) or sweep.get("deep") != 8:
        problems.append(f"sweep {sweep} over {len(live)} tiers")
    if problems:
        raise SystemExit(f"phase 18 (e): {problems}")
    waits = e["dma_wait_ms"]
    for t in live:
        log(f"    tier {t['tier']:2d} m_t={t['slot_width']:5d} "
            f"({t['family']}): {t['measured_ms']:.4f} ms; alone at batch 4 "
            f"{t['ring1_ms']:.4f} ms, wait {t['dma_wait_ms']:.4f} ms"
            f"{' (below resolution)' if t.get('below_resolution') else ''}")
    fp = structure_fingerprint(levels, width)
    pred8 = predict_iter_ms(fp, k, model, kernel="pallas")
    pred4 = predict_iter_ms(fp, k, model, kernel="pallas",
                            kernel_opts={"batch": 4})

    # The fold step at batch 4 through the executor a user builds.
    tic = time.perf_counter()
    ml4 = MultiLevelArrow(levels, width, fmt="fold", kernel="pallas_sell",
                          kernel_opts={"batch": 4}, device=dev)
    out["fold_build_s"] = time.perf_counter() - tic
    x = ml4.set_features(random_dense(ml4.n, k, seed=3))
    ml4.step(x)
    torch.cuda.synchronize()
    reset_counters()
    y = ml4.step(x)
    torch.cuda.synchronize()
    launches = counters()
    step_ms = statistics.median(cuda_runs(lambda: ml4.step(x), 20))
    opts = LaunchOpts(batch=4)
    got = cuda_sell.sell_spmm_cuda(ml4.sell, x, opts)
    deep = cuda_sell.sell_spmm_cuda(ml4.sell, x, LaunchOpts(batch=8))
    plain = sell_spmm(ml4.sell, x)
    torch.cuda.synchronize()
    row_nnz = ml4.nnz / ml4.n
    err, ok = compare(got, plain, row_nnz, exact=False)
    if not (ok and torch.equal(got, deep) and torch.equal(got, y)) \
            or launches[0] < 1 or any(launches[1:]):
        raise SystemExit(f"phase 18 (e): K1 at batch 4: max abs err "
                         f"{err:.3e} against plain, equal to batch 8 "
                         f"{torch.equal(got, deep)}, to the step "
                         f"{torch.equal(got, y)}; launches {launches}")
    del got, deep, plain, y
    ms = statistics.median(cuda_runs(
        lambda: cuda_sell.sell_spmm_cuda(ml4.sell, x, opts), 20))
    plain_ms = cuda_ms(lambda: sell_spmm(ml4.sell, x), 3)
    a_csr = sorted_csr(ml4.sell, x.dtype)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 5)
    nnz = int(a_csr.values().numel())
    read = int(torch.unique(a_csr.col_indices()).numel())
    del a_csr
    n_rows, item = ml4.sell.n_rows, x.element_size()
    t_bytes = (4 * nnz + 4 * n_rows + (read + n_rows) * k * item) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = nnz * k / F32_FLOPS * 1e3
    gathered = (nnz * (k * item + 4) + n_rows * k * item) \
        / HBM_BYTES_PER_S * 1e3
    out.update(full_ms=e["full_ms"], full_a_ms=full_a,
               coverage=e["coverage"], sweep=sweep, waits=waits,
               k1_launches=counts[0], predicted_batch8_ms=pred8,
               predicted_batch4_ms=pred4, step_batch4_ms=step_ms,
               step_launches=launches[0], ratios=ratios,
               tiers=[[t["tier"], t["slot_width"], t["measured_ms"],
                       t["ring1_ms"], t["dma_wait_ms"],
                       bool(t.get("below_resolution"))] for t in live])
    log(f"phase 18 (e) lens pallas f32 k={k} with the load-depth sweep "
        f"(batch 8 against 4): full {e['full_ms']:.4f} ms/iter ((a)'s "
        f"{'not run' if full_a is None else f'{full_a:.4f} ms'}), "
        f"coverage {e['coverage']:.4f}, every tier bit-equal at batch 4 "
        f"and 8 ({sweep['bit_equal_tiers']} tiers), {counts[0]} K1 "
        f"launches as the profile counts; wait by family "
        f"{ {f: round(w, 4) for f, w in waits.items()} } ms; model: "
        f"batch 8 {pred8:.4f}, batch 4 {pred4:.4f} ms/iter beside the "
        f"measured step at batch 4 {step_ms:.4f} ms ({launches[0]} K1 "
        f"launches a step; reported, not gated); K1 at batch 4 "
        f"{ms:.4f} ms/product, plain {plain_ms:.4f}, torch.sparse.mm "
        f"{library_ms:.4f}, bound {max(t_bytes, t_ops):.4f}, "
        f"gathered-bytes bound {gathered:.4f} ms, max abs err {err:.3e}; "
        f"profile {out['profile_s']:.1f} s, fold {out['fold_build_s']:.1f}"
        f" s")
    del ml4, x
    torch.cuda.empty_cache()
    entry = {"name": "sell_tier_spmm[lens-batch4]", "route": "cuda",
             "source": SOURCES["K1"], "replaces": REPLACES["K1"],
             "launches": launches[0], "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms, "gather_bound_ms": gathered}
    return out, entry


def phase_lens(dev, base: str, width: int, store: str, run_dir: str,
               main: dict) -> tuple:
    """Phase 18: the lens, the memory report, the probe and the ledger's
    CLIs on phase 4's levels (read back through a ``"dir"`` source),
    every check fatal; ``store`` is the run-local ledger phase 14's bench
    wrote into (when it ran)."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.classes import find_certificate
    from arrow_matrix_tpu_torch.cli import graft_ledger, graft_lens
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.ledger.probe import error_curves_for_source
    from arrow_matrix_tpu_torch.obs import lens, memview
    from arrow_matrix_tpu_torch.obs.costmodel import predict_iter_ms
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.tune import (
        load_levels_from_source,
        structure_fingerprint,
    )
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

    t_phase = time.perf_counter()
    os.makedirs(run_dir, exist_ok=True)
    name = torch.cuda.get_device_name(0)
    src = {"kind": "dir", "base": base, "width": width}
    tic = time.perf_counter()
    levels, width = load_levels_from_source(src)
    out = {"load_s": time.perf_counter() - tic}

    # (a) the lens: K1 per tier prefix, f32 and bf16 at k=128.
    reset_counters()
    tic = time.perf_counter()
    prof = lens.profile_fold(levels, width, LENS["k"],
                             feature_dtypes=LENS["dtypes"],
                             iters=LENS["iters"], device=dev)
    torch.cuda.synchronize()
    out["profile_s"] = time.perf_counter() - tic
    counts = counters()
    per_dtype = {fd: e["launches"] + sum(t.get("launches", 0)
                                         for t in e["tiers"])
                 for fd, e in prof["dtypes"].items()}
    if counts[0] != sum(per_dtype.values()) or any(counts[1:]):
        raise SystemExit(f"phase 18: launches {counts} disagree with the "
                         f"profile's K1 count {per_dtype}")
    if (prof["platform"], prof["device_kind"]) != ("gpu", name):
        raise SystemExit(f"phase 18: profile stamped {prof['platform']} "
                         f"{prof['device_kind']}")
    model = lens.fit_from_profile(prof)
    problems = lens.check_profile(prof, model)
    ratios = lens.ratio_points(prof, model)
    bad = [p for p in ratios if p["tier"] is not None
           and not lens.LENS_RATIO_MIN <= p["ratio"] <= lens.LENS_RATIO_MAX]
    phase4 = {"f32": main.get("f32_k128_ms_per_iter"),
              "bf16": (statistics.median(main["fold_bf16_k128_k1_ms_runs"])
                       if "fold_bf16_k128_k1_ms_runs" in main else None)}
    out["lens"] = {}
    for fd, e in prof["dtypes"].items():
        live = [t for t in e["tiers"] if t["slot_width"] > 0]
        idle = [t["tier"] for t in live if not t.get("launches")]
        if idle:
            raise SystemExit(f"phase 18 {fd}: tier prefixes {idle} "
                             f"launched no K1")
        if abs(e["coverage"] - 1.0) > lens.LENS_COVERAGE_TOL:
            problems.append(f"{fd} coverage {e['coverage']:.4f}")
        bulk = sum(t["measured_ms"] for t in live
                   if t["slot_width"] <= BULK_SLOTS)
        out["lens"][fd] = {
            "full_ms": e["full_ms"], "phase4_ms": phase4.get(fd),
            "coverage": e["coverage"], "chain_floor_ms": e["chain_floor_ms"],
            "resolution_ms": e["resolution_ms"], "bulk_ms": bulk,
            "full_launches": e["launches"],
            "tiers": [[t["tier"], t["slot_width"], t["rows"], t["nnz"],
                       t["measured_ms"], bool(t.get("below_resolution")),
                       t["launches"]] for t in live]}
        p4 = phase4.get(fd)
        log(f"phase 18 (a) lens {fd} k={LENS['k']}: full {e['full_ms']:.4f} "
            f"ms/iter (phase 4/5's K1 "
            f"{'not run' if p4 is None else f'{p4:.4f} ms'}), coverage "
            f"{e['coverage']:.4f}, chain floor {e['chain_floor_ms']:.4f} "
            f"ms, resolution {e['resolution_ms']:.4f} ms; bulk tiers "
            f"(m_t <= {BULK_SLOTS}) {bulk:.4f} ms; K1 launches {e['launches']} "
            f"(the full step's chains) + "
            f"{sum(t['launches'] for t in live)} (prefixes)")
        for t in live:
            log(f"    tier {t['tier']:2d} m_t={t['slot_width']:5d} "
                f"rows={t['rows']:8d} nnz={t['nnz']:9d}: "
                f"{t['measured_ms']:.4f} ms"
                f"{' (below resolution)' if t.get('below_resolution') else ''}"
                f", {t['launches']} K1 launches")
    for p in ratios:
        log(f"    ratio {p['dtype']} "
            f"{'full' if p['tier'] is None else 'tier %d' % p['tier']} "
            f"({p['family']}): measured {p['measured_ms']:.4f} / predicted "
            f"{p['predicted_ms']:.4f} = {p['ratio']:.3f}")
    if problems or bad:
        raise SystemExit(f"phase 18 (a): {problems} {bad}")
    gap = lens.explain_gap(prof, model=model)
    fp = structure_fingerprint(levels, width)
    pred = predict_iter_ms(fp, LENS["predict_k"], model)
    out.update(structure_hash=prof["structure_hash"], ratios=ratios,
               coeffs=model.coeffs, gap=gap, k16_predicted_ms=pred,
               k16_phase4_ms=main.get("f32_k16_ms_per_iter"),
               k1_launches=counts[0], launches_by_dtype=per_dtype)
    p16 = main.get("f32_k16_ms_per_iter")
    log(f"phase 18 (a) model {sorted(model.coeffs)}; {gap['note']}; "
        f"predicted f32 k={LENS['predict_k']} {pred:.4f} ms/iter beside "
        f"phase 4's {'not run' if p16 is None else f'{p16:.4f} ms'} "
        f"(reported, not gated); profile {out['profile_s']:.1f} s")
    prof_path = os.path.join(run_dir, "lens_profile.json")
    model_path = os.path.join(run_dir, "lens_model.json")
    atomic_write_json(prof_path, prof, indent=2, sort_keys=True)
    atomic_write_json(model_path, model.to_dict(), indent=2,
                      sort_keys=True)
    out["lens_records"] = len(lens.record_profile(prof, model,
                                                  directory=store))

    # (e) the lens at K1's knob points with its load-depth sweep.
    out["sweep"], sweep_entry = phase_lens_sweep(
        dev, levels, width, prof["dtypes"].get("f32", {}).get("full_ms"))

    # (b) one fold step's device memory beside the executor's model.
    tic = time.perf_counter()
    ml = MultiLevelArrow(levels, width, fmt="fold", device=dev)
    out["fold_build_s"] = time.perf_counter() - tic
    x = ml.set_features(random_dense(ml.n, LENS["k"], seed=3))
    ml.raw_step(x, ml.sell)            # the work list, built once
    rep = memview.memory_report(ml.raw_step, x, ml.sell)
    pred_bytes = ml.predicted_hbm_bytes(LENS["k"])
    if rep["source"] != "cuda_allocator" or rep["temp_bytes"] is None:
        raise SystemExit(f"phase 18 (b): {rep}")
    out["memory"] = dict(rep, predicted_bytes=pred_bytes,
                         ratio=rep["total_bytes"] / pred_bytes)
    log(f"phase 18 (b) memory of one fold step at k={LENS['k']}: arguments "
        f"{rep['argument_bytes']} B, output {rep['output_bytes']} B, "
        f"temporaries {rep['temp_bytes']} B, total {rep['total_bytes']} B "
        f"against predicted_hbm_bytes {pred_bytes} B (ratio "
        f"{out['memory']['ratio']:.4f}); fold built in "
        f"{out['fold_build_s']:.1f} s")
    row_nnz = ml.nnz / ml.n
    entries = [lens_prefix_entry(ml.sell, fd, per_dtype[fd], row_nnz, dev)
               for fd in LENS["dtypes"]] + [sweep_entry]
    del ml, x
    torch.cuda.empty_cache()

    # (c) the probe: f32, bf16 and int8 trajectories on the card.
    before = counters()[0]
    tic = time.perf_counter()
    recs = error_curves_for_source(
        src, k=LENS["probe_k"], iterations=LENS["probe_iterations"],
        dtypes=LENS["probe_dtypes"], ledger=Ledger(store), device=dev)
    out["probe_s"] = time.perf_counter() - tic
    out["probe_k1_launches"] = counters()[0] - before
    curves = {r["knobs"]["dtype"]: r["payload"]["rel_frobenius"]
              for r in recs}
    out["curves"] = curves
    for r in recs:
        log(f"phase 18 (c) {r['metric']} k={LENS['probe_k']}: "
            f"{[float('%.4e' % v) for v in curves[r['knobs']['dtype']]]} "
            f"({r['platform']}, {r['device_kind']})")
    shash = recs[0]["structure_hash"]
    cert = find_certificate(shash, "bf16", ledger_dir=store)
    bad = []
    if shash != prof["structure_hash"]:
        bad.append(f"probe hash {shash} != lens hash")
    if any(v != 0.0 for v in curves["f32"]):
        bad.append("the f32 curve is not all zeros")
    if not all(np.isfinite(v) for c in curves.values() for v in c):
        bad.append("a curve point is not finite")
    if not curves["bf16"][0] <= LENS["bf16_gate"]:
        bad.append(f"bf16 first point {curves['bf16'][0]:.3e} > "
                   f"{LENS['bf16_gate']}")
    if cert is None or cert.record_id != recs[1]["record_id"]:
        bad.append(f"find_certificate returned {cert}")
    if any(r["platform"] != "gpu" for r in recs):
        bad.append("a curve is not stamped gpu")
    if bad:
        raise SystemExit(f"phase 18 (c): {'; '.join(bad)}")
    out["certificate"] = {"record_id": cert.record_id,
                          "tolerance": cert.tolerance}
    log(f"phase 18 (c) probe {out['probe_s']:.1f} s ({out['probe_k1_launches']} "
        f"K1 launches); find_certificate({shash}, bf16) -> "
        f"{cert.record_id} (tolerance {cert.tolerance})")

    # (d) the ledger through its CLIs, on the run-local store.
    lg = Ledger(store)
    if lg.validate():
        raise SystemExit(f"phase 18 (d): {lg.validate()}")
    kinds = sorted({r["kind"] for r in lg.read_all()})
    rc_re, _ = cli_main(graft_ledger.main, ["--ledger-dir", store,
                                            "rebaseline"])
    rc_check, text = cli_main(graft_ledger.main, ["--ledger-dir", store,
                                                  "check"])
    print(text, end="")
    rc_rep, text = cli_main(graft_ledger.main, ["--ledger-dir", store,
                                                "report"])
    print(text, end="")
    if (rc_re, rc_check, rc_rep) != (0, 0, 0):
        raise SystemExit(f"phase 18 (d): rebaseline/check/report exited "
                         f"{rc_re}/{rc_check}/{rc_rep}")
    out["ledger"] = {"records": len(lg.read_all()), "kinds": kinds}
    if "bench" in kinds:
        rc, _ = cli_main(graft_ledger.main, ["--ledger-dir", store,
                                             "export", "--round", "99",
                                             "--out", run_dir])
        with open(os.path.join(run_dir, "BENCH_r99.json")) as fh:
            parsed = json.load(fh)["parsed"]
        if rc != 0 or (parsed.get("platform"), parsed.get("device_kind")) \
                != ("gpu", name):
            raise SystemExit(f"phase 18 (d): export rc {rc}, parsed "
                             f"{parsed.get('platform')} "
                             f"{parsed.get('device_kind')}")
        out["ledger"]["export"] = {"platform": parsed["platform"],
                                   "device_kind": parsed["device_kind"],
                                   "value": parsed.get("value"),
                                   "curves": len(parsed["error_curves"])}
        log(f"phase 18 (d) export --round 99: parsed platform "
            f"{parsed['platform']}, {parsed['device_kind']}, value "
            f"{parsed.get('value')}, {len(parsed['error_curves'])} curves")
    else:
        log("phase 18 (d) no bench record in the store (phase 14 not "
            "run): export left out")
    rc_lens, text = cli_main(graft_lens.main, ["check", prof_path,
                                               "--model", model_path])
    print(text, end="")
    if rc_lens != 0:
        raise SystemExit(f"phase 18 (d): graft_lens check exited {rc_lens}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18 (d) graft_ledger rebaseline/check/report exit 0 over "
        f"{out['ledger']['records']} records ({', '.join(kinds)}); "
        f"graft_lens check exit 0; phase 18 {out['phase_s']:.1f} s")
    return out, entries


# -- 19. graft-tune on the card ------------------------------------------------

#: Phase 19's race (the restricted set), its widths and the serving step.
TUNE = dict(ks=(16, 128), iters=3, timeout_s=240.0,
            # The knobs off their defaults but one CTA an SM (chunk 64 and
            # 256, batch 4) race no more: (d) drives each knob point's
            # main-path step and times it.
            race=("default", "pallas_sell", "pallas_sell_ctas1",
                  "synth_ladder", "fold_tight", "overlap2", "repl2",
                  "bf16"),
            # k=128 races the default, K1 at its defaults and with the
            # k=16 winner's knob, and bf16.
            race_k128=("default", "pallas_sell", "pallas_sell_ctas1",
                       "bf16"),
            serve_n=1 << 16, serve_width=2048, serve_seed=7,
            serve_requests=3, serve_iterations=4, knob_k=16)


def tune_race(source: dict, k: int, work: str, dev) -> tuple:
    """Phase 19 (a): ``search`` at width ``k`` over the restricted set,
    each child alone on the card; returns (plan, report)."""
    from arrow_matrix_tpu_torch.tune import search

    race = TUNE.get(f"race_k{k}", TUNE["race"])
    tic = time.perf_counter()
    plan, rep = search(source, k, iters=TUNE["iters"],
                       timeout_s=TUNE["timeout_s"],
                       plan_dir=os.path.join(work, "tune_plans"),
                       restrict=list(race),
                       run_dir=os.path.join(work, "tune_runs", f"k{k}"),
                       ledger_dir=os.path.join(work, "ledger"), synth=True,
                       device=dev, quiet=True)
    wall = time.perf_counter() - tic
    if plan is None or rep.get("cache_hit"):
        raise SystemExit(f"phase 19 k={k}: no plan ({rep.get('error')}, "
                         f"cache_hit={rep.get('cache_hit')})")
    res = rep["results"]
    if set(res) != set(race) or rep["children_spawned"] != len(res):
        raise SystemExit(f"phase 19 k={k}: raced {sorted(res)}, pruned "
                         f"{ {c: r for c, r in rep['pruned'].items() if c in race} }")
    for name, r in res.items():
        if r.get("error") or r.get("ms") is None \
                or not r.get("k1_launches_per_step"):
            raise SystemExit(f"phase 19 k={k} {name}: {r}")
    if not res["default"]["bit_identical"] or not plan.bit_identical:
        raise SystemExit(f"phase 19 k={k}: the default or the winner is "
                         f"not bit-identical to the golden")
    if not res["bf16"]["rel_frobenius"] <= 2e-2:
        raise SystemExit(f"phase 19 k={k} bf16: rel err "
                         f"{res['bf16']['rel_frobenius']}")
    log(f"phase 19 (a) k={k}: {len(res)} children in {wall:.1f} s; winner "
        f"{plan.candidate!r} {plan.measured_ms:.4f} ms/iter vs default "
        f"{plan.default_ms:.4f} (margin {plan.margin})")
    for name in race:
        r = res[name]
        sec = r["seconds"]
        log(f"    {name:22s} {r['ms']:9.4f} ms/iter  bit_identical="
            f"{r['bit_identical']!s:5s}  rel_err={r['rel_frobenius']:.2e}  "
            f"K1 launches a step {r['k1_launches_per_step']}  (s: turn "
            f"{r['turn_s']:.2f}, of it build {sec['build']:.2f}, check "
            f"{sec['check']:.2f}, timing {sec['timing']:.2f}; waited "
            f"{sec['waited']:.2f} after {sec['before_wait']:.2f})")
    pruned = {c: why for c, why in rep["pruned"].items()
              if why != "not in restricted candidate set"}
    log(f"    pruned: {pruned}")
    return plan, dict(rep, wall_s=wall, pruned_screens=pruned)


def knob_points() -> list:
    """Every knob point of K1's contract, as ``LaunchOpts``."""
    import itertools

    from arrow_matrix_tpu_torch.ops import worklist

    return [worklist.LaunchOpts(chunk_slots=cs, batch=b, ctas_per_sm=ctas)
            for cs, b, ctas in itertools.product(
                worklist.CHUNK_SLOTS_CHOICES, worklist.BATCH_CHOICES,
                worklist.CTAS_PER_SM_CHOICES)]


def knob_tag(opts) -> str:
    return f"cs{opts.chunk_slots},b{opts.batch},ctas{opts.ctas_per_sm}"


def tune_knob_main_path(fold_dir: str, golden, row_nnz: float,
                        dev) -> dict:
    """Phase 19 (d)'s main path: for each knob point, the race's exported
    default fold loaded as ``MultiLevelArrow.load_folded(kernel=
    "pallas_sell", kernel_opts=point)`` and stepped once on the golden's
    input, its K1 launches counted from zero; the step equals the golden
    bit for bit where the point keeps the order, else within the
    fold's tolerance.  Returns {tag: launches}."""
    import numpy as np

    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.tune.search import GOLDEN_SEED
    from arrow_matrix_tpu_torch.utils import (
        random_dense,
        relative_error,
        relative_tolerance,
    )

    k = golden.shape[1]
    x_host = random_dense(golden.shape[0], k, seed=GOLDEN_SEED)
    launches = {}
    for opts in knob_points():
        ml = MultiLevelArrow.load_folded(
            fold_dir, device=dev, kernel="pallas_sell",
            kernel_opts={"chunk_slots": opts.chunk_slots,
                         "batch": opts.batch,
                         "ctas_per_sm": opts.ctas_per_sm})
        x = ml.set_features(x_host)
        reset_counters()
        y = ml.gather_result(ml.step(x))
        got = launches[knob_tag(opts)] = cuda_sell.LAUNCHES
        err = relative_error(y, golden)
        same = bool(np.array_equal(y, golden))
        if got == 0 or not err <= relative_tolerance(row_nnz, 1) \
                or (opts.keeps_order() and not same):
            raise SystemExit(f"phase 19 (d) {opts}: {got} K1 launches, rel "
                             f"err {err:.3e} against the golden (bit-equal "
                             f"{same})")
        del ml, x
    return launches


def tune_knob_points(sell, x, row_nnz: float, want_default, dev,
                     launches: dict) -> list:
    """Phase 19 (d) on the fold: K1 at every knob point of the contract
    (f32, k = ``x``'s width) against the work list's twin, the points
    that keep the order bit for bit against the default; each point's
    time beside the twin's, the bound and ``torch.sparse.mm``, and its
    launches on its main-path run (``launches``, by tag)."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell, worklist
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    k = x.shape[1]
    nnz = int(sum(int(d.sum()) for d in sell.deg)) if sell.binary else \
        int(sum(int((d != 0).sum()) for d in sell.data))
    bound = fold_bound_ms(sell, nnz, k)
    by, fl = fold_work(sell, nnz, k)
    bound_by = "bytes" if by / HBM_BYTES_PER_S >= fl / F32_FLOPS \
        else "operations"
    a_csr = sorted_csr(sell, torch.float32)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 5)
    del a_csr
    twins, twin_ms = {}, {}
    entries = []
    for opts in knob_points():
        cs = opts.chunk_slots
        got = cuda_sell.sell_spmm_cuda(sell, x, opts)
        if cs not in twins:
            wl = cuda_sell.plan_for(sell, k, x.dtype, True, opts).wl
            twins[cs] = worklist.sell_spmm_worklist(sell, x, wl)
            twin_ms[cs] = cuda_ms(
                lambda: worklist.sell_spmm_worklist(sell, x, wl), 2)
        torch.cuda.synchronize()
        err, ok = compare(got, twins[cs], row_nnz, exact=False)
        if not ok or (opts.keeps_order() and not torch.equal(got,
                                                             want_default)):
            raise SystemExit(f"phase 19 (d): K1 at {opts} != its twin "
                             f"(max abs err {err:.3e}) or, keeping the "
                             f"order, != the default")
        ms = statistics.median(cuda_runs(
            lambda: cuda_sell.sell_spmm_cuda(sell, x, opts), 20))
        entries.append({
            "name": f"sell_tier_spmm[knob {knob_tag(opts)},fold,f32,k={k}]",
            "route": "cuda", "source": SOURCES["K1"],
            "replaces": REPLACES["K1"],
            "launches": launches[knob_tag(opts)],
            "max_abs_err": err, "ms": ms,
            "plain_ms": twin_ms[cs], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms,
            "keeps_order": opts.keeps_order()})
        del got
    best = min(entries, key=lambda e: e["ms"])
    log(f"phase 19 (d): K1 at {len(entries)} knob points on the fold, f32 "
        f"k={k}: each within its twin's tolerance, the order-keeping ones "
        f"equal to the default bit for bit; default "
        f"{next(e['ms'] for e in entries if 'cs128,b8,ctas2' in e['name']):.4f} "
        f"ms, fastest {best['name']} {best['ms']:.4f} ms, bound "
        f"{bound:.4f} ms, torch.sparse.mm {library_ms:.4f} ms")
    for e in entries:
        log(f"    {e['name']}: {e['ms']:.4f} ms (twin {e['plain_ms']:.1f} "
            f"ms), launches on its main-path step {e['launches']}")
    return entries


def tune_random_knobs(dev) -> int:
    """Phase 19 (d) on phase 3's random tiers: K1 at every knob point of
    each carriage against the work list's twin, binary, k 16 and 128."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell, sell, worklist

    rng = np.random.default_rng(19)
    n_m = sum(n_t for _, n_t in MULTI_TIER_SHAPES)
    parts = [random_tier(rng, m_t, n_t, n_m) for m_t, n_t in MULTI_TIER_SHAPES]
    starts = np.cumsum([0] + [n_t for _, n_t in MULTI_TIER_SHAPES[:-1]])
    m = sell.sell_from_arrays([p[0] for p in parts], None,
                              [p[1] for p in parts], n_m, starts, device=dev)
    checks = 0
    for k in (16, 128):
        x32 = torch.from_numpy(rng.uniform(-1, 1, (n_m, k)).astype(
            np.float32)).to(dev)
        xs = {"f32": x32, "bf16": x32.to(torch.bfloat16),
              "int8": torch.from_numpy(rng.integers(
                  -127, 128, (n_m, k)).astype(np.int8)).to(dev)}
        for name, x in xs.items():
            base = cuda_sell.sell_spmm_cuda(m, x)
            for opts in knob_points():
                got = cuda_sell.sell_spmm_cuda(m, x, opts)
                wl = cuda_sell.plan_for(m, k, x.dtype, True, opts).wl
                twin = worklist.sell_spmm_worklist(m, x, wl)
                torch.cuda.synchronize()
                err, ok = compare(got, twin, 6000.0, exact=name == "int8")
                if not ok or (opts.keeps_order()
                              and not torch.equal(got, base)):
                    raise SystemExit(f"phase 19 (d) random tiers k={k} "
                                     f"{name} {opts}: K1 != twin "
                                     f"({err:.3e}) or != the default")
                checks += 1
    log(f"phase 19 (d): {checks} knob points on phase 3's random tiers "
        f"(f32/bf16/int8, k 16 and 128) equal their twins (int8 bit for "
        f"bit), the order-keeping ones the default bit for bit")
    return checks


def tune_serve(plan128, work: str, dev) -> dict:
    """Phase 19 (f): a search at BA 2^16 (k=128) restricted to the 2^20
    k=128 winner's K1 candidate, an ``ArrowServer(tune_plan=)`` over
    ``ba_executor_factory(plan=)`` serving a few k=128 requests (its
    ``tune_plan_applied`` event read back from the flight recorder),
    and an error plan that forces the tenant down the ladder to
    ``"xla"``, with the same bits."""
    import dataclasses

    from arrow_matrix_tpu_torch import faults, serve
    from arrow_matrix_tpu_torch.obs import flight
    from arrow_matrix_tpu_torch.tune import search

    name = plan128.candidate if plan128.kernel == "pallas_sell" \
        else "pallas_sell"
    source = {"kind": "ba", "n": TUNE["serve_n"], "m": 3,
              "width": TUNE["serve_width"], "seed": TUNE["serve_seed"],
              "max_levels": 10}
    plan, rep = search(source, 128, iters=TUNE["iters"],
                       timeout_s=TUNE["timeout_s"],
                       plan_dir=os.path.join(work, "tune_plans_serve"),
                       restrict=[name],
                       run_dir=os.path.join(work, "tune_runs", "serve"),
                       ledger_dir=os.path.join(work, "ledger"), synth=True,
                       device=dev, quiet=True)
    if plan is None or plan.kernel != "pallas_sell":
        raise SystemExit(f"phase 19 (f): no pallas_sell plan at 2^16 "
                         f"({rep.get('error')}, {rep.get('results')})")
    factory, n = serve.ba_executor_factory(
        TUNE["serve_n"], TUNE["serve_width"], TUNE["serve_seed"],
        plan=plan, device=dev)
    trace = serve.synthetic_trace(n, tenants=1, requests=TUNE["serve_requests"],
                                  k=128, iterations=TUNE["serve_iterations"],
                                  seed=19)
    rec = flight.FlightRecorder(None)
    prior = flight.get_recorder()
    flight.set_recorder(rec)
    try:
        srv = serve.ArrowServer(factory, tune_plan=plan, name="tuned")
        tickets = serve.run_trace(srv, trace)
    finally:
        flight.set_recorder(prior)
    applied = [e for e in rec.snapshot()["events"]
               if e["name"] == "tune_plan_applied"]
    if not applied or any(t.status != "completed" for t in tickets) \
            or srv.base_config.kernel != "pallas_sell":
        raise SystemExit(f"phase 19 (f): tune_plan_applied {applied}, "
                         f"tickets {[t.status for t in tickets]}")
    base = result_bytes(tickets)
    rungs = serve.degradation_ladder(srv.base_config)
    faults.set_plan({"scenario": "error", "site": "multi_level.step",
                     "after": 0, "count": 2 * (len(rungs) - 1)})
    try:
        walk = serve.ArrowServer(
            factory, tune_plan=plan, degrade_after=1, name="walk",
            policy=faults.RetryPolicy(max_retries=1, backoff_s=0.0))
        walked = serve.run_trace(walk, trace[:1])
    finally:
        faults.clear_plan()
    s = walk.summary()
    degr = [(d["from"]["kernel"], d["to"]["kernel"])
            for t in s["tenants"].values() for d in t["degradations"]]
    if ("pallas_sell", "xla") not in degr \
            or result_bytes(walked) != {trace[0].request_id:
                                        base[trace[0].request_id]}:
        raise SystemExit(f"phase 19 (f): the ladder walk {degr} or its "
                         f"bits differ from the tuned rung")
    log(f"phase 19 (f): ArrowServer(tune_plan={plan.candidate!r}) over "
        f"ba_executor_factory(plan=) at BA {n}: {len(tickets)} k=128 "
        f"requests completed, tune_plan_applied logged "
        f"({applied[0]['data']['base_config']}); an error plan walked the "
        f"tenant {degr} to the same bits")
    return {"candidate": plan.candidate, "requests": len(tickets),
            "walk": degr, "rungs": [dataclasses.asdict(c) for c in rungs]}


def phase_tune(dev, base: str, width: int, work: str) -> tuple:
    """Phase 19: graft-tune on the card over phase 4's 2^20 artifact."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.cli import graft_tune
    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.tune import search
    from arrow_matrix_tpu_torch.tune.search import GOLDEN_SEED
    from arrow_matrix_tpu_torch.utils import random_dense

    import subprocess

    t0 = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # (e)'s certifier needs no card: it runs on the host from the start,
    # against the committed program store.
    kcheck = subprocess.Popen(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.analysis", "kernels",
         "--check"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
        env={k_: v for k_, v in os.environ.items()
             if k_ != "AMT_SYNTH_STORE"})
    os.environ["AMT_SYNTH_STORE"] = os.path.join(work, "synth_programs.json")
    os.environ["AMT_FLIGHT_DIR"] = os.path.join(work, "flight")
    plan_dir = os.path.join(work, "tune_plans")
    source = {"kind": "dir", "base": base, "width": width}
    out, plans, reports = {}, {}, {}
    # (a) the race at k = 16 and 128.
    for k in TUNE["ks"]:
        plans[k], reports[k] = tune_race(source, k, work, dev)
    # (b) a second search: a pure hit.
    for k in TUNE["ks"]:
        tic = time.perf_counter()
        again, rep = search(source, k, plan_dir=plan_dir, device=dev,
                            quiet=True)
        if not rep["cache_hit"] or rep["children_spawned"] != 0 \
                or again.candidate != plans[k].candidate:
            raise SystemExit(f"phase 19 (b) k={k}: {rep}")
        log(f"phase 19 (b) k={k}: a second search is a pure hit, 0 children "
            f"({time.perf_counter() - tic:.1f} s with the fingerprint)")
    # (e)'s bit-identity replay (tools/tune_gate --no-timing) runs in a
    # process of its own beside (c), (f) and (d)'s random tiers, which
    # time nothing; graft_tune check, whose replay is timed, runs here
    # after (d).
    gate = subprocess.Popen(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.tools.tune_gate",
         "--plan-dir", plan_dir, "--no-timing"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    # (c) plan="auto" on the main path: K1 with the winner's knobs.
    levels = as_levels_of(base, width)
    os.environ["AMT_TUNE_PLAN_DIR"] = plan_dir
    auto_launches = {}
    try:
        for k in TUNE["ks"]:
            ml = MultiLevelArrow(levels, width, fmt="fold", plan="auto",
                                 plan_k=k, device=dev)
            p = plans[k]
            if ml.tune_plan is None or ml.tune_plan.candidate != p.candidate \
                    or ml.kernel != p.kernel:
                raise SystemExit(f"phase 19 (c) k={k}: plan='auto' applied "
                                 f"{ml.tune_plan}")
            x = ml.set_features(random_dense(ml.n, k, seed=GOLDEN_SEED))
            reset_counters()
            y = ml.gather_result(ml.step(x))
            got = auto_launches[k] = cuda_sell.LAUNCHES
            want = reports[k]["results"][p.candidate]["k1_launches_per_step"]
            golden = np.load(os.path.join(work, "tune_runs", f"k{k}",
                                          f"golden_k{k}.npy"))
            if got != want or not np.array_equal(y, golden):
                raise SystemExit(f"phase 19 (c) k={k}: {got} K1 launches "
                                 f"(the winner's child {want}), bit-equal "
                                 f"{np.array_equal(y, golden)}")
            log(f"phase 19 (c) k={k}: MultiLevelArrow(plan='auto') applied "
                f"{p.candidate!r} (kernel {ml.kernel}, kernel_opts "
                f"{ml.kernel_opts}); one step launched K1 {got} times, as "
                f"the winner's child did, and equals the golden bit for bit")
            del ml, x
        # (f) the tuned server.
        out["serve"] = tune_serve(plans[128], work, dev)
    finally:
        os.environ.pop("AMT_TUNE_PLAN_DIR", None)
    del levels
    # (d) every knob point: on phase 3's random tiers against the twin,
    # then on the race's exported 2^20 fold at k = 16, each point's
    # main-path step first, then K1 against the twin and timed.
    random_checks = tune_random_knobs(dev)
    gate_out = gate.communicate(timeout=600)[0]
    kd = TUNE["knob_k"]
    run_dir = os.path.join(work, "tune_runs", f"k{kd}")
    golden = np.load(os.path.join(run_dir, f"golden_k{kd}.npy"))
    ml = MultiLevelArrow.load_folded(os.path.join(run_dir, "fold"),
                                     device=dev)
    row_nnz = ml.nnz / ml.n
    point_launches = tune_knob_main_path(os.path.join(run_dir, "fold"),
                                         golden, row_nnz, dev)
    xs = torch.from_numpy(random_dense(ml.total_rows, kd, seed=5)).to(dev)
    want_default = cuda_sell.sell_spmm_cuda(ml.sell, xs)
    entries = tune_knob_points(ml.sell, xs, row_nnz, want_default, dev,
                               point_launches)
    del ml, want_default, xs
    torch.cuda.empty_cache()
    # (e) the gates.
    rc_check, text = cli_main(graft_tune.main, ["check", "--plan-dir",
                                                plan_dir])
    kc_out = kcheck.communicate(timeout=600)[0]
    if rc_check or gate.returncode or kcheck.returncode:
        raise SystemExit(f"phase 19 (e): graft_tune check rc {rc_check}, "
                         f"tune_gate rc {gate.returncode}, analysis kernels "
                         f"--check rc {kcheck.returncode}:\n{text}\n"
                         f"{gate_out[-2000:]}\n{kc_out[-2000:]}")
    log(f"phase 19 (e): graft_tune check, tools/tune_gate and analysis "
        f"kernels --check exit 0 ({kc_out.strip().splitlines()[-2]})")
    for line in text.strip().splitlines() + [
            f"tools/tune_gate: {g}" for g in gate_out.splitlines()
            if g.startswith("tune-gate")]:
        log(f"    {line}")
    for k in TUNE["ks"]:
        rep = reports[k]
        out[f"k{k}"] = {
            "winner": plans[k].candidate, "measured_ms": plans[k].measured_ms,
            "default_ms": plans[k].default_ms, "margin": plans[k].margin,
            "wall_s": rep["wall_s"], "pruned": rep["pruned_screens"],
            "results": {n: {kk: r.get(kk) for kk in
                            ("ms", "bit_identical", "rel_frobenius",
                             "k1_launches_per_step", "k1_launches",
                             "seconds", "turn_s")}
                        for n, r in rep["results"].items()}}
    out.update(random_knob_checks=random_checks,
               auto_k1_launches=auto_launches,
               knob_k1_launches=point_launches,
               seconds=time.perf_counter() - t0)
    os.environ.pop("AMT_SYNTH_STORE", None)
    log(f"phase 19: {out['seconds']:.1f} s")
    return out, entries


# -- 20. the mesh executors ------------------------------------------------------

#: Phase 20: ranks sharing the card over gloo (the main path and its
#: variants at 2^20, MultiLevelArrow at 2^16), one rank a card over NCCL.
MESH = dict(world=4, chain=3, n_small=1 << 16, reps=3)
#: A rank's executors between phase 20's jobs (in the rank's process).
_RANK = {}


def mesh_counted(exe, k: int, steps: int, fn, tag: str,
                 phase: str = "phase 20") -> tuple:
    """(result, launches) of ``fn`` in a rank, the counts set to 0 just
    before it; fatal unless each kernel launched exactly
    ``exe.launch_counts(k)`` x ``steps`` times on this rank."""
    import torch

    torch.cuda.synchronize()
    reset_counters()
    out = fn()
    torch.cuda.synchronize()
    got = dict(zip(KERNEL_NAMES, counters()))
    want = {name: v * steps for name, v in exe.launch_counts(k).items()}
    bad = {name: (got[name], v) for name, v in want.items()
           if got[name] != v}
    if bad or not any(got.values()):
        raise SystemExit(f"{phase} {tag}: launches (got, expected) {bad} "
                         f"of {got}")
    return out, got


def mesh_rank_build(ctx, base: str, width: int, n_small: int) -> dict:
    """Phase 20's host work in a rank, on the CPU while the earlier
    phases run: phase 4's levels read back from its artifact and packed
    into this rank's shards (``SellMultiLevel``, a2a, over the whole
    world, and the 2.5D one on a (blocks, repl=2) grid), and phase 7's
    graph (BA ``n_small`` m=8, width 2048, seed 7) decomposed."""
    import torch

    name_process(f"{ctx.backend}-rank{ctx.rank}")
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.parallel.mesh import (
        make_mesh,
        make_repl_mesh,
    )
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    # torch.optim's first step imports torch._dynamo (seconds): once here,
    # beside the earlier phases, not in phase 21's timed training.
    import torch._dynamo  # noqa: F401

    torch.set_num_threads(2)
    out = {}
    tic = time.perf_counter()
    levels = as_levels_of(base, width)
    # Gloo ranks pack with their collectives on the CPU and take the card
    # when released; a NCCL rank's collectives need its card.
    host = "cpu" if ctx.backend == "gloo" else ctx.device
    mesh = make_mesh((ctx.world,), ("blocks",), device=host)
    _RANK["exe"] = SellMultiLevel(levels, width, mesh, routing="a2a")
    out["a2a_s"] = time.perf_counter() - tic
    if ctx.backend == "gloo":
        tic = time.perf_counter()
        rmesh = make_repl_mesh(ctx.world, 2, device="cpu")
        _RANK["repl"] = SellMultiLevel(levels, width, rmesh, routing="a2a",
                                       repl_axis="repl")
        out["repl_s"] = time.perf_counter() - tic
        tic = time.perf_counter()
        a = barabasi_albert(n_small, 8, seed=7)
        _RANK["small"] = (a, arrow_decomposition(
            a, width, max_levels=10, block_diagonal=True, seed=7))
        out["small_s"] = time.perf_counter() - tic
        if ctx.rank == 0:       # phase 21 (b)/(c)'s host goldens
            _RANK["gold"] = mesh_small_goldens(*_RANK["small"])
            out["small_gold_s"] = _RANK["gold"]["seconds"]
    _RANK.update(levels=levels, base=base, width=width)
    exe = _RANK["exe"]
    out.update(levels=len(levels), hops=[o.hops for o in exe.ops],
               rows_local=exe.rows_local,
               slots=[r.slots for r in exe.fwd + exe.bwd])
    return out


def mesh_rank_main(ctx) -> dict:
    """Phase 20 (a) and (b) in a rank: the executor to the card, then
    the f32 k=16 chain (the main path, counts set to 0 just before it),
    and on the gloo ranks k=128, bf16, ``routing="gather"``, ``repl``
    2 and ``overlap_slabs=2`` for one step each, every result gated by
    rank 0 against phase 4's host golden; the bit identities; ms/iter
    and the collective bytes of a step."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.utils import (
        commstats,
        random_dense,
        relative_error,
        relative_tolerance,
    )

    exe = _RANK["exe"].to(ctx.device)
    base, width, levels = _RANK["base"], _RANK["width"], _RANK["levels"]
    first = ctx.rank == 0
    n, chain = exe.n, MESH["chain"]
    row_nnz = sum(int(lvl.matrix.nnz) for lvl in levels) / n
    res = {"backend": ctx.backend, "world": ctx.world,
           "cards": torch.cuda.device_count()}
    gates = {}

    def gate(tag, got, k, s, tol):
        if not first:
            return
        err = relative_error(got, np.load(golden_path(base, k, s)))
        gates[tag] = err
        if not err <= tol:
            raise SystemExit(f"phase 20 {tag}: rel err {err:.3e} > "
                             f"gate {tol:.1e}")

    x16 = random_dense(n, 16, seed=3)
    c = exe.set_features(x16)
    y, res["chain_launches"] = mesh_counted(
        exe, 16, chain, lambda: exe.run(c, chain), "f32 k=16 chain")
    gate("f32_k16_chain", exe.gather_result(y), 16, chain,
         relative_tolerance(row_nnz, chain))
    commstats.reset()
    y1 = exe.step(c)
    torch.cuda.synchronize()
    res["step_comm"] = commstats.snapshot()
    r1 = exe.gather_result(y1)
    tol1 = relative_tolerance(row_nnz, 1)
    gate("f32_k16_step", r1, 16, 1, tol1)
    res["ideal_comm_bytes"] = exe.ideal_comm_bytes(16)
    res["reduce_comm_bytes"] = exe.reduce_comm_bytes(16)
    torch.cuda.synchronize()
    runs = []
    for _ in range(MESH["reps"]):
        tic = time.perf_counter()
        exe.run(c, chain)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - tic) * 1e3 / chain)
    res["ms_per_iter_runs"] = runs
    res["ms_per_iter"] = statistics.median(runs)
    same = {"repeat": exe.gather_result(exe.step(c))}
    if ctx.backend == "gloo":
        c128 = exe.set_features(random_dense(n, 128, seed=4))
        y, _ = mesh_counted(exe, 128, 1, lambda: exe.step(c128), "k=128")
        gate("f32_k128_step", exe.gather_result(y), 128, 1, tol1)
        del c128, y
        exe.feature_dtype = torch.bfloat16
        cb = exe.set_features(x16)
        y, _ = mesh_counted(exe, 16, 1, lambda: exe.step(cb), "bf16")
        gate("bf16_k16_step", exe.gather_result(y), 16, 1, max(tol1, 2e-2))
        exe.feature_dtype = torch.float32
        g = exe.with_routing("gather")
        y, _ = mesh_counted(g, 16, 1, lambda: g.step(c), "gather")
        same["gather"] = g.gather_result(y)
        del g
        exe.overlap_slabs = 2
        y, _ = mesh_counted(exe, 16, 1, lambda: exe.step(c), "overlap 2")
        same["overlap_slabs=2"] = exe.gather_result(y)
        exe.overlap_slabs = 1
        rep = _RANK["repl"].to(ctx.device)
        cr = rep.set_features(x16)
        y, _ = mesh_counted(rep, 16, 1, lambda: rep.step(cr), "repl 2")
        gate("repl2_k16_step", rep.gather_result(y), 16, 1, tol1)
        del rep, cr, _RANK["repl"]
    if first:
        for tag, other in same.items():
            if not np.array_equal(other, r1):
                raise SystemExit(f"phase 20: {tag} differs from the a2a "
                                 f"step (max {np.abs(other - r1).max()})")
        res["bits_equal"] = sorted(same)
    if first and ctx.backend == "gloo":
        # (b) holds its NCCL rank to the golden; the fold is built once.
        from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

        fold = MultiLevelArrow(levels, width, fmt="fold", device=ctx.device)
        f1 = fold.gather_result(fold.step(fold.set_features(x16)))
        gates["vs_fold"] = relative_error(r1, f1)
        if not gates["vs_fold"] <= tol1:
            raise SystemExit(f"phase 20: the mesh step and the fold differ "
                             f"by {gates['vs_fold']:.3e} > {tol1:.1e}")
        del fold
    res["gates"] = gates
    _RANK.update(x16=x16, row_nnz=row_nnz, launches=res["chain_launches"])
    del c, y1
    torch.cuda.empty_cache()
    return res


#: Elements a rank of phase 20's gloo probe moves in each collective.
GLOO_PROBE_ELEMS = 1 << 20


def mesh_rank_gloo_probe(ctx) -> dict:
    """Phase 20's probe, on the gloo ranks sharing the card: which of
    the collectives ``parallel/collectives.py`` stages through pinned
    host buffers torch's gloo runs on CUDA tensors itself.  Each of
    all-gather, all-to-all and gather (and broadcast and all-reduce,
    which the port hands gloo on the card) is called directly on CUDA
    tensors of :data:`GLOO_PROBE_ELEMS` f32 a rank, its result checked
    against the values it must hold, and timed (median of 5) beside the
    port's staged call of the same exchange.  The halo's send/recv is
    not probed: torch's backend table does not list it for gloo on
    CUDA.  Rank 0 returns ``{"torch": version, op: {"ok", "error",
    "direct_ms", "staged_ms"}}``."""
    import torch
    import torch.distributed as dist

    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((ctx.world,), ("blocks",), device=ctx.device)
    p, r, n, dev = ctx.world, ctx.rank, GLOO_PROBE_ELEMS, ctx.device
    ranks = torch.arange(p, device=dev, dtype=torch.float32)
    mine = torch.full((n,), float(r), device=dev)
    # All-to-all: rank r sends r * p + d to rank d, so receives s * p + r.
    send = (r * p + ranks).repeat_interleave(n // p)
    got_a2a = (ranks * p + r).repeat_interleave(n // p)
    gathered = ranks.repeat_interleave(n)

    def all_gather():
        out = torch.empty(p * n, device=dev)
        coll._ALL_GATHER(out, mine)
        return out, gathered

    def all_to_all():
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send)
        return out, got_a2a

    def gather():
        parts = ([torch.empty(n, device=dev) for _ in range(p)]
                 if r == 0 else None)
        dist.gather(mine, gather_list=parts, dst=0)
        return ((torch.cat(parts), gathered) if r == 0
                else (mine, mine))

    def broadcast():
        t = mine.clone()
        dist.broadcast(t, src=0)
        return t, torch.zeros_like(t)

    def all_reduce():
        t = mine.clone()
        dist.all_reduce(t)
        return t, torch.full_like(t, float(sum(range(p))))

    staged = {"all_gather": lambda: coll.all_gather(mine, mesh, "blocks"),
              "all_to_all": lambda: coll.all_to_all(send, mesh, "blocks"),
              "gather": lambda: coll.reduce_to_first(mine, mesh, "blocks")}

    def ms(fn):
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - tic) * 1e3)
        return statistics.median(runs)

    out = {"torch": torch.__version__, "elements": n}
    for name, fn in (("all_gather", all_gather), ("all_to_all", all_to_all),
                     ("gather", gather), ("broadcast", broadcast),
                     ("all_reduce", all_reduce)):
        rec = {"ok": False, "error": None, "direct_ms": None,
               "staged_ms": None}
        try:
            val, want = fn()
            torch.cuda.synchronize()
            rec["ok"] = bool(torch.equal(val, want))
            rec["direct_ms"] = ms(fn)
        except Exception as e:           # the probe's reading, not a fault
            rec["error"] = f"{type(e).__name__}: {str(e)[:160]}"
        if name in staged:
            rec["staged_ms"] = ms(staged[name])
        out[name] = rec
    return out if r == 0 else None


def mesh_rank_kernels(ctx):
    """Phase 20 (d)'s K1 and K4 entries (:func:`mesh_kernel_entries`)
    and K2 and K3 over (c)'s dense banded shards
    (:func:`mesh_block_entries`), on rank 0 while the card is otherwise
    idle; the other ranks return None.  Phase 20's executors are
    dropped after it."""
    import torch

    exe, banded = _RANK.pop("exe"), _RANK.pop("banded", None)
    try:
        if ctx.rank != 0:
            return None
        return (mesh_block_entries(*banded)
                + mesh_kernel_entries(exe, exe.set_features(_RANK["x16"]),
                                      _RANK["row_nnz"], _RANK["launches"]))
    finally:
        del exe, banded
        torch.cuda.empty_cache()


def mesh_kernel_entries(exe, c, row_nnz: float, launches: dict) -> list:
    """Phase 20 (d) on rank 0: K1 over every body and head operator of its
    shards (one step's products, on random operands of their shapes)
    against K1's plain version, and K4's pack and unpack of its first
    exchange against ``index_select`` bit for bit; each timed beside its
    bound, its plain version and one PyTorch call."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    dev, k = c.device, c.shape[1]
    gen = torch.Generator(device=dev).manual_seed(20)
    ops, xs = [], []
    for o in exe.ops:
        for name, rows in (("body", o.operand_rows), ("head", o.rows_out)):
            ops.append(o.dev[name])
            xs.append(torch.rand((rows, k), device=dev, generator=gen))
    got = [sell_spmm_cuda(m, x) for m, x in zip(ops, xs)]
    want = [sell_spmm(m, x) for m, x in zip(ops, xs)]
    err = 0.0
    for g, w in zip(got, want):
        e, ok = compare(g, w, row_nnz, exact=False)
        if not ok:
            raise SystemExit(f"phase 20 (d): K1 on a shard operator differs "
                             f"from its plain version (max {e:.3e})")
        err = max(err, e)
    csrs = [sorted_csr(m, torch.float32) for m in ops]
    nnz = sum(int(a.values().numel()) for a in csrs)
    work = [fold_work(m, int(a.values().numel()), k, x_rows=m.x_rows)
            for a, m in zip(csrs, ops)]
    bytes_, flops = (sum(w[i] for w in work) for i in (0, 1))
    bound1 = max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    k1 = lambda: [sell_spmm_cuda(m, x) for m, x in zip(ops, xs)]
    runs = cuda_runs(k1, 20)
    g1, _ = graph_ms(k1, 20)
    e1 = {"name": "sell_tier_spmm[mesh,f32,k=16]", "route": "cuda",
          "source": SOURCES["K1"], "replaces": REPLACES["K1"],
          "launches": launches["K1"], "max_abs_err": err,
          "ms": statistics.median(runs), "graph_ms": g1,
          "plain_ms": cuda_ms(lambda: [sell_spmm(m, x)
                                       for m, x in zip(ops, xs)], 5),
          "bound_ms": bound1, "bound_by": "bytes"
          if bytes_ / HBM_BYTES_PER_S >= flops / F32_FLOPS
          else "operations",
          "library_ms": cuda_ms(lambda: [torch.sparse.mm(a, x)
                                         for a, x in zip(csrs, xs)], 5)}
    log(f"phase 20 (d) K1 on rank 0's shards: {len(ops)} products "
        f"({nnz} nnz) {e1['ms']:.4f} ms a step eager (launch-bound: small "
        f"products), {g1:.4f} ms from one CUDA graph, plain "
        f"{e1['plain_ms']:.4f}, torch.sparse.mm {e1['library_ms']:.4f}, "
        f"bound {bound1:.4f} ms; max abs err {err:.3e}")
    del got, want, csrs
    # K4: the pack and the unpack of the first exchange, each reading
    # its source in two parts as routed_take passes it (the rank's rows,
    # then the zero row and the received slots).
    r = exe.fwd[0]
    tail = torch.cat([c.new_zeros((1, k)),
                      torch.rand((r.n_dev * r.slots, k), device=dev,
                                 generator=gen)])
    pairs = [(r.send, tail[:1]), (r.unpack, tail)]
    for idx, x2 in pairs:
        a = row_gather(c, idx, x2)
        b = torch.cat([c, x2]).index_select(0, idx.long())
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise SystemExit("phase 20 (d): K4 pack/unpack differs from "
                             "index_select")
    rows = sum(int(idx.numel()) for idx, _ in pairs)
    bytes4 = rows * (2 * k * 4 + 4)
    k4 = lambda: [row_gather(c, i, x2) for i, x2 in pairs]
    runs = cuda_runs(k4, 20)
    g4, _ = graph_ms(k4, 20)
    longs = [(torch.cat([c, x2]), i.long()) for i, x2 in pairs]
    sel = cuda_ms(lambda: [x.index_select(0, i) for x, i in longs], 5)
    e4 = {"name": "row_gather[mesh-route,f32,k=16]", "route": "cuda",
          "source": SOURCES["K4"], "replaces": REPLACES["K4"],
          "launches": launches["K4"] + launches["K4 add"],
          "max_abs_err": 0.0, "ms": statistics.median(runs),
          "graph_ms": g4, "plain_ms": sel,
          "bound_ms": bytes4 / HBM_BYTES_PER_S * 1e3,
          "bound_by": "bytes", "library_ms": sel}
    log(f"phase 20 (d) K4 pack + unpack of rank 0's first exchange ({rows} "
        f"rows, S={r.slots}): {e4['ms']:.4f} ms eager, {g4:.4f} ms from "
        f"one CUDA graph, index_select {sel:.4f}, "
        f"bound {e4['bound_ms']:.4f} ms; bit for bit")
    return [e1, e4]


def mesh_rank_small(ctx) -> dict:
    """Phase 20 (c) in a rank: ``MultiLevelArrow(mesh=)`` over phase 7's
    graph, auto (slim, a2a), dense banded, and the wide layout on an
    (arm=2, blocks=2) grid, one k=16 step each with its launches, gated
    by rank 0 against the host golden; rank 0 keeps its dense banded
    executor for (d)'s K2 and K3 timings."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.decomposition import decomposition_spmm
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.utils import (
        random_dense,
        relative_error,
        relative_tolerance,
    )

    a, levels = _RANK["small"]      # phase 21 takes it on
    width, n = _RANK["width"], a.shape[0]
    x = random_dense(n, 16, seed=3)
    want = decomposition_spmm(levels, x) if ctx.rank == 0 else None
    tol = relative_tolerance(a.nnz / n, 1)
    out = {"levels": len(levels)}
    slim = make_mesh((ctx.world,), ("blocks",), device=ctx.device)
    wide = make_mesh((2, ctx.world // 2), ("arm", "blocks"),
                     device=ctx.device)
    for tag, mesh, kw in (
            ("auto_a2a", slim, dict(fmt="auto", routing="a2a")),
            ("dense_banded", slim, dict(fmt="dense", banded=True)),
            ("wide", wide, dict(fmt="dense", layout="wide"))):
        tic = time.perf_counter()
        exe = MultiLevelArrow(levels, width, mesh=mesh, **kw)
        t_build = time.perf_counter() - tic
        c = exe.set_features(x)
        y, got = mesh_counted(exe, 16, 1, lambda: exe.step(c), tag)
        res = exe.gather_result(y)
        rec = {"fmts": exe.fmts, "build_s": t_build, "launches": got}
        if ctx.rank == 0:
            rec["err"] = relative_error(res, want)
            if not rec["err"] <= tol:
                raise SystemExit(f"phase 20 (c) {tag}: rel err "
                                 f"{rec['err']:.3e} > {tol:.1e}")
            if tag == "dense_banded":     # timed in (d), the card idle
                _RANK["banded"] = (exe, c, got, tol)
        out[tag] = rec
        del exe, c, y
        torch.cuda.empty_cache()
    return out


def shard_block_work(sb, k: int, kernel: str) -> tuple:
    """(bytes, operations) the function of K2 or K3 needs on one rank's
    dense shard of a level (:func:`block_work` for a shard): K2 the
    blocks of its own block rows (the first rank's head row left out,
    the last rank's missing right neighbour too), its operand read once
    and its rows written once; K3 the head blocks, the rank's rows and
    C_0; 2 w^2 k operations per block product."""
    w = sb.width
    item = sb.stacks["head"].element_size()
    if kernel == "K3":
        pairs, feats = sb.nb_local, sb.nb_local + 1
    else:
        rows = sb.column_rows
        pairs = rows * sum(n in sb.stacks for n in ("diag", "col", "lo",
                                                    "hi"))
        pairs -= int(sb.banded and sb.last and rows > 0)
        feats = (sb.column_operand + rows) if rows else 0
    return (pairs * w * w * item + feats * w * k * 4,
            2 * pairs * w * w * k)


def mesh_block_entries(exe, c, launches: dict, tol: float,
                       phase: str = "phase 20 (d)") -> list:
    """K2 and K3 over rank 0's dense banded shards (every level: its
    column stacks over its extended operand, and its head blocks), as
    the step calls them, held against their plain versions and timed
    beside their bounds, their plain versions and cuBLAS."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops import arrow_blocks
    from arrow_matrix_tpu_torch.ops.cuda_blocks import (
        column_rows_spmm,
        head_spmm,
    )
    from arrow_matrix_tpu_torch.utils import relative_error
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    k, dev = c.shape[1], c.device
    gen = torch.Generator(device=dev).manual_seed(21)
    sbs = [sb for sb in exe.blocks if sb.column_rows]
    # Each level's K2 operand (the extended one, less X_next on the last
    # rank), its first row and its stacks, as column_blocks passes them.
    xe = [torch.rand((sb.column_operand, sb.width, k), device=dev,
                     generator=gen) for sb in sbs]
    xo = [torch.rand((sb.nb_local, sb.width, k), device=dev, generator=gen)
          for sb in exe.blocks]
    f = [sb.first + sb.skip for sb in sbs]
    s = [sb.stacks for sb in sbs]
    h = [sb.stacks["head"] for sb in exe.blocks]
    k2 = lambda: [column_rows_spmm(t["diag"], t["col"], x, a, t.get("lo"),
                                   t.get("hi")) for t, x, a in zip(s, xe, f)]
    p2 = lambda: [arrow_blocks.column_rows_spmm(t["diag"], t["col"], x, a,
                                                t.get("lo"), t.get("hi"))
                  for t, x, a in zip(s, xe, f)]
    k3 = lambda: [head_spmm(t, x) for t, x in zip(h, xo)]
    p3 = lambda: [arrow_blocks.head_spmm(t, x) for t, x in zip(h, xo)]
    l3 = lambda: [torch.einsum("bij,bjk->ik", t, x) for t, x in zip(h, xo)]

    def l2():
        res = []
        for t, x, a in zip(s, xe, f):
            r = t["diag"].shape[0]
            o = torch.baddbmm(torch.matmul(t["col"], x[0]), t["diag"],
                              x[a:a + r])
            if "lo" in t:
                o.baddbmm_(t["lo"], x[a - 1:a + r - 1])
                n_hi = min(r, x.shape[0] - a - 1)
                o[:n_hi].baddbmm_(t["hi"][:n_hi], x[a + 1:a + 1 + n_hi])
            res.append(o)
        return res

    entries = []
    for name, fn, plain, lib, kname, idx, levels in (
            ("K2", k2, p2, l2, "column_spmm", "K2", sbs),
            ("K3", k3, p3, l3, "head_spmm", "K3", exe.blocks)):
        err = 0.0
        for g, w in zip(fn(), plain()):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            if not relative_error(g, w) <= tol:
                raise SystemExit(f"{phase}: {name} on a shard differs "
                                 f"from its plain version")
            err = max(err, float(np.abs(g - w).max()))
        work = [shard_block_work(sb, k, name) for sb in levels]
        bytes_, ops = (sum(wk[i] for wk in work) for i in (0, 1))
        t_b, t_o = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        runs = cuda_runs(fn, 20)
        entries.append({
            "name": f"{kname}[mesh,f32,k={k}]", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[idx], "max_abs_err": err,
            "ms": statistics.median(runs), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": cuda_ms(lib, 5)})
        log(f"{phase} {name} on rank 0's dense banded shards "
            f"({len(levels)} levels): {entries[-1]['ms']:.4f} ms, "
            f"plain {entries[-1]['plain_ms']:.4f}, library "
            f"{entries[-1]['library_ms']:.4f}, bound "
            f"{entries[-1]['bound_ms']:.4f} ms by {entries[-1]['bound_by']}")
    return entries


def start_mesh(base: str, width: int):
    """Phase 20's gloo ranks, started once phase 4's artifact exists:
    they pack on the host and wait (the card untouched); the first
    computes phase 21's host goldens at phase 7's graph."""
    from arrow_matrix_tpu_torch.parallel.launch import RankPool

    pool = RankPool(MESH["world"], backend="gloo", threads=2)
    pool.submit("chip_smoke", "mesh_rank_build", base, width,
                MESH["n_small"])
    return pool


def mesh_rank_chain(ctx) -> dict:
    """Phase 20's probe, (a) and (c), and phase 21 (b) and (c), in a
    gloo rank as one job, started beside phase 19 (the kernel timings,
    (d), wait for an otherwise idle card); each part's result and the
    seconds of (a) and of phase 21's part."""
    out = {}
    tic = time.perf_counter()
    out["probe"] = mesh_rank_gloo_probe(ctx)
    out["main"] = mesh_rank_main(ctx)
    out["a_s"] = time.perf_counter() - tic
    out["small"] = mesh_rank_small(ctx)
    tic = time.perf_counter()
    out["train"] = mesh_rank_train(ctx)
    out["space"] = mesh_rank_space(ctx)
    out["p21_s"] = time.perf_counter() - tic
    return out


def start_mesh_work(pool, base: str, width: int, host22: tuple,
                    solvers=None, subs23=None,
                    fold_ref_on_rank: bool = True) -> dict:
    """Start what phases 20-22 do without timing a kernel, once phase
    4's artifact and goldens exist: the gloo ranks' chain
    (:func:`mesh_rank_chain`, queued behind their packing) and phase 22
    (b) (:func:`base22_ranks`, behind it), phase 22 (c)'s subprocesses,
    phase 21 (a)'s float64 host goldens in a thread (``solvers``: phase
    13's, as :func:`mesh_train_goldens` takes them), and the NCCL rank,
    packing.  ``host22`` is phase 22's host process (:func:`start_host`),
    ``subs23`` phase 23's subprocesses where they were started earlier
    (:func:`start_state23`; else from here); ``fold_ref_on_rank`` builds
    (d)'s one-rank reference on the NCCL rank (a run with phase 4's fold
    takes it from there).  :func:`phase_mesh` collects them."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from arrow_matrix_tpu_torch.parallel.launch import RankPool

    keep = os.path.dirname(base)
    pool.submit("chip_smoke", "mesh_rank_chain")
    pool.submit("chip_smoke", "base22_ranks", keep)
    pool.submit("chip_smoke", "state23_ranks", keep)
    clis = start_base22_clis(keep, base)
    goldens = ThreadPoolExecutor(1)
    gold_a = goldens.submit(mesh_train_goldens, base, width, solvers)
    if subs23 is None:
        subs23 = start_state23(keep, base)
    nccl = RankPool(torch.cuda.device_count(), backend="nccl", threads=2)
    nccl.submit("chip_smoke", "mesh_rank_build", base, width, 0)
    nccl.submit("chip_smoke", "state23_nccl_build", width,
                fold_ref_on_rank)
    return dict(pool=pool, nccl=nccl, goldens=goldens, gold_a=gold_a,
                subs23=subs23, keep=keep, base=base, clis=clis,
                host22=host22, started=time.perf_counter())


def phase_mesh(work: dict, fold_gcn_ms=None, serve15=None,
               fold_ref=None) -> tuple:
    """Phases 20-23 (the module docstring) on :func:`start_mesh_work`'s
    ranks: (results, kernel entries); ``fold_gcn_ms`` is phase 13's
    GCNCarried fold step, ``serve15`` phase 15's results and ``fold_ref``
    phase 23 (d)'s one-rank reference from phase 4's fold, where this run
    has them."""
    import numpy as np

    pool, nccl, goldens = work["pool"], work["nccl"], work["goldens"]
    tic0 = time.perf_counter()
    try:
        try:
            built = pool.collect(job_timeout_s=900)
            chain = pool.collect(job_timeout_s=900)
            b22 = pool.collect(job_timeout_s=900)
            b23 = pool.collect(job_timeout_s=900)
            waited = time.perf_counter() - tic0
            log(f"phase 20: ranks built in processes of their own beside "
                f"the earlier phases, and their chain (the probe, (a), (c) "
                f"and phase 21 (b)-(c)) run beside phase 19 (waited "
                f"{waited:.1f} s here): {built[0]}")
            res = {"built": built, "chain_wait_s": waited}
            res["gloo_probe"] = probe = chain[0]["probe"]
            log(f"phase 20 gloo probe (torch {probe['torch']}, "
                f"{probe['elements']} f32 a rank, {pool.world} ranks on "
                f"the card): " + "; ".join(
                    f"{op} direct {'ok' if v['ok'] else v['error'] or 'wrong values'}"
                    + (f" {v['direct_ms']:.3f} ms" if v["direct_ms"] else "")
                    + (f", staged {v['staged_ms']:.3f} ms"
                       if v["staged_ms"] else "")
                    for op, v in probe.items() if isinstance(v, dict)))
            main = [c["main"] for c in chain]
            small = [c["small"] for c in chain]
            train = [c["train"] for c in chain]
            space = [c["space"] for c in chain]
            t_a, t21_gloo = chain[0]["a_s"], chain[0]["p21_s"]
            # (d) and phase 21 (d): the kernel timings, the card idle.
            k_entries = pool.run("chip_smoke", "mesh_rank_kernels",
                                 job_timeout_s=600)[0]
            entries21 = pool.run("chip_smoke", "mesh_rank_space_kernels",
                                 job_timeout_s=300)[0]
            tic22 = time.perf_counter()
            entries22 = pool.run("chip_smoke", "base22_kernels",
                                 job_timeout_s=300)[0]
            t22 = time.perf_counter() - tic22
        finally:
            pool.close()
        tic = time.perf_counter()
        res["nccl_built"] = nccl.collect(job_timeout_s=600)[0]
        built23 = nccl.collect(job_timeout_s=600)[0]
        res["nccl_wait_s"] = time.perf_counter() - tic
        prod = nccl.run("chip_smoke", "mesh_rank_main", job_timeout_s=600)
        tic = time.perf_counter()
        gold = work["gold_a"].result(timeout=900)
        t_gold_wait = time.perf_counter() - tic
        tic21a = time.perf_counter()
        # (a): where the device's ReLUs open first, so a host golden at
        # those signs (where any differs) runs beside the training.
        masks = nccl.run("chip_smoke", "mesh_rank_relu_nccl",
                         job_timeout_s=300)[0]
        gold["flips"] = int(sum(np.count_nonzero(m != g) for m, g in
                                zip(masks, gold["gcn"]["masks"])))
        regold = (goldens.submit(gold["regold"], masks)
                  if gold["flips"] else None)
        nccl_train = nccl.run("chip_smoke", "mesh_rank_train_nccl",
                              gold["shift"], job_timeout_s=600)[0]
        t21_nccl = time.perf_counter() - tic21a
        tic22 = time.perf_counter()
        a22 = nccl.run("chip_smoke", "base22_nccl", work["keep"],
                       job_timeout_s=600)[0]
        t22 += time.perf_counter() - tic22
        tic23 = time.perf_counter()
        a23 = nccl.run("chip_smoke", "state23_nccl", work["base"],
                       job_timeout_s=900)[0]
        d23 = nccl.run("chip_smoke", "state23_streamed", work["base"], 2048,
                       job_timeout_s=600)[0]
        t23 = time.perf_counter() - tic23
        if regold is not None:
            gold["gcn"] = regold.result(timeout=900)
    finally:
        nccl.close()
        goldens.shutdown(wait=False)
    r0 = main[0]
    res.update(gloo=r0, gloo_launches=[r["chain_launches"] for r in main],
               nccl=prod[0], small=small[0],
               small_launches=[{k: v["launches"] for k, v in s.items()
                                if isinstance(v, dict)} for s in small],
               seconds=time.perf_counter() - tic0)
    st = r0["step_comm"]
    log(f"phase 20 (a): SellMultiLevel a2a on {r0['world']} gloo ranks "
        f"sharing the card ({r0['cards']} card(s)): gates {r0['gates']}; "
        f"bit for bit {r0['bits_equal']} against the a2a step; "
        f"{r0['ms_per_iter']:.3f} ms/iter (median of {MESH['reps']} "
        f"chains of {MESH['chain']}; a transport through pinned host "
        f"buffers, not a speed of the executor); one step on rank 0: "
        f"{ {k: v for k, v in st.items() if isinstance(v, dict) and v['count']} } "
        f"total {st['total_bytes']} B, host staged {st['host_staged_bytes']} "
        f"B; ideal {r0['ideal_comm_bytes']} B, reduce "
        f"{r0['reduce_comm_bytes']} B; launches a rank "
        f"{res['gloo_launches']}")
    p0 = prod[0]
    log(f"phase 20 (b): the same executor on {p0['world']} NCCL rank(s), "
        f"one a card (packed in {res['nccl_built']['a2a_s']:.1f} s beside "
        f"the gloo ranks' work, waited {res['nccl_wait_s']:.1f} s): gates "
        f"{p0['gates']}, {p0['ms_per_iter']:.3f} ms/iter, launches "
        f"{p0['chain_launches']}, step bytes "
        f"{p0['step_comm']['total_bytes']}")
    log(f"phase 20 (c): MultiLevelArrow(mesh=) at n={MESH['n_small']}: "
        f"{res['small']}; launches a rank {res['small_launches']}")
    res["phase21"] = {"a": check_nccl_train(nccl_train, gold, fold_gcn_ms),
                      **check_gloo_train(train, space),
                      "gloo_s": t21_gloo, "nccl_s": t21_nccl,
                      "golden_wait_s": t_gold_wait}
    tic22 = time.perf_counter()
    host22 = join_host(*work["host22"], "phase 22")
    res["phase22"] = phase_baselines(b22, a22, entries22 + a22["entries"],
                                     work["clis"], host22)
    t22 += time.perf_counter() - tic22
    res["phase22"]["main_s"] = t22
    tic23 = time.perf_counter()
    subs = work["subs23"].result(timeout=STATE["timeout_s"])
    t23_wait = time.perf_counter() - tic23
    res["phase23"] = phase_state(a23, d23, b23, built23, subs, serve15,
                                 fold_ref)
    res["phase23"]["main_s"] = t23 = t23 + time.perf_counter() - tic23
    res["phase23"]["subprocess_wait_s"] = t23_wait
    log(f"phase 20: {res['seconds']:.1f} s of the script's wall ((a) "
        f"{t_a:.1f} s), of which phase 21 {t21_gloo:.1f} s on the gloo "
        f"ranks and {t21_nccl:.1f} s on the NCCL rank (waited "
        f"{t_gold_wait:.1f} s for its host goldens); phase 22 {t22:.1f} s "
        f"of the main process's wall (its graph made in {host22['t_gen']:.1f}"
        f" s and goldens in {host22['t_gold']:.1f} s by a host process); "
        f"phase 23 {t23:.1f} s of it (waited {t23_wait:.1f} s for its "
        f"subprocesses)")
    return res, (k_entries + entries21 + entries22 + a22["entries"]
                 + a23["entries"])


# -- 21. training through the mesh executors, and the space-shared modes -----

#: Phase 21: Adam steps of each training run, and the solvers' iterations
#: on the mesh (phase 13's dims, :data:`MODEL_DIMS`).
MESH_TRAIN = dict(steps=5, iters=50)


def scaled(counts: dict, m: int) -> dict:
    """Launch counts ``counts`` times ``m``."""
    return {name: v * m for name, v in counts.items()}


def added(*counts: dict) -> dict:
    """The sum of launch counts."""
    out = {}
    for c in counts:
        for name, v in c.items():
            out[name] = out.get(name, 0) + v
    return out


def train_counts(exe, steps: int) -> dict:
    """A GCN train step's launches at :data:`MODEL_DIMS` on this rank:
    two forward products at k_in and hidden, one transposed product at
    hidden (the gradient of the second layer's input), ``steps`` times."""
    k_in, hidden, _ = MODEL_DIMS
    return scaled(added(exe.launch_counts(k_in), exe.launch_counts(hidden),
                        exe.launch_counts(hidden, transposed=True)), steps)


def mesh_gate(want: dict, fn, tag: str) -> tuple:
    """(result, launches) of ``fn`` in a rank, the counts set to 0 just
    before it and read just after; fatal unless each kernel of ``want``
    launched exactly that often and some kernel launched."""
    import torch

    torch.cuda.synchronize()
    reset_counters()
    out = fn()
    torch.cuda.synchronize()
    got = dict(zip(KERNEL_NAMES, counters()))
    bad = {name: (got[name], v) for name, v in want.items()
           if got[name] != v}
    if bad or not any(got.values()):
        raise SystemExit(f"phase 21 {tag}: launches (got, expected) {bad} "
                         f"of {got}")
    return out, got


class FirstGrads:
    """An optimizer factory (``fit(optimizer=)``) whose Adam (lr 1e-2, the
    models' default) keeps the first step's gradients, summed over the
    mesh, as host arrays."""

    def __init__(self):
        self.grads = None

    def __call__(self, params):
        import torch

        keep = self

        class Adam(torch.optim.Adam):
            def step(self, closure=None):
                if keep.grads is None:
                    keep.grads = [p.grad.detach().cpu().numpy().copy()
                                  for g in self.param_groups
                                  for p in g["params"]]
                return super().step(closure)

        return Adam(params, lr=1e-2)


def degrees(levels, n: int):
    """Each vertex's degree (row nonzeros summed over the levels)."""
    import numpy as np

    deg = np.zeros(n, dtype=np.float64)
    for lvl in levels:
        p = np.asarray(lvl.permutation)
        np.add.at(deg, p[:lvl.matrix.shape[0]], np.diff(lvl.matrix.indptr))
    return deg


def train_inputs(n: int) -> tuple:
    """Phase 13's model inputs at ``n`` rows: x (k_in), y (k_out)."""
    from arrow_matrix_tpu_torch.utils import random_dense

    return (random_dense(n, MODEL_DIMS[0], seed=21),
            random_dense(n, MODEL_DIMS[-1], seed=22))


def gcn_golden(a, x, y, at=None, masks=None) -> dict:
    """The float64 host GCN (seed 0's parameters at :data:`MODEL_DIMS`):
    logits, loss and gradients over ``a`` (``at`` its transpose), its
    ReLUs at ``masks`` when given (:func:`host_model`)."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.models import gcn_init

    init = model_params(gcn_init(torch.Generator().manual_seed(0),
                                 MODEL_DIMS))
    return host_model("gcn", a, a if at is None else at,
                      x.astype(np.float64), y.astype(np.float64), init,
                      masks=masks)


def relu_masks(model, exe, xs) -> list:
    """Where a GCN's hidden ReLUs open on the device for the carriage
    ``xs`` (its first step's), each as a host (n, hidden) bool array in
    original row order."""
    import torch

    out, x = [], xs
    with torch.no_grad():
        for p in list(model.params)[:-1]:
            pre = p(exe.step(x))
            out.append(exe.gather_result(pre) > 0.0)
            x = torch.relu(pre)
    return out


def at_device_relus(gold: dict, masks: list, regold) -> tuple:
    """``(golden, flips)``: the host golden with its ReLUs where the
    device's opened (``regold(masks)``) if any pre-activation's sign
    differs between the two, else ``gold``.  A pre-activation within
    f32 rounding of zero can take either sign; the gradient then jumps
    by the ReLU's step, which no tolerance of the products covers."""
    import numpy as np

    flips = int(sum(np.count_nonzero(m != g)
                    for m, g in zip(masks, gold["masks"])))
    return (regold(masks) if flips else gold), flips


def mesh_train_goldens(base: str, width: int, solvers=None) -> dict:
    """Phase 21 (a)'s float64 host goldens, computed in a thread of the
    script from phase 19 on: over phase 4's operator A (its levels
    summed, symmetric), the GCN's first step, power iteration and CG as
    the port runs them (from phase 13's ``solvers``, where they are over
    the same A and shift)."""
    import numpy as np

    from arrow_matrix_tpu_torch.utils import random_dense

    tic = time.perf_counter()
    levels = as_levels_of(base, width)
    n = levels[0].matrix.shape[0]
    a = host_matrix(levels, n)
    deg = degrees(levels, n)
    del levels
    op = HostOp(a)
    x, y = train_inputs(n)
    out = {"n": n, "row_nnz": a.nnz / n, "shift": float(deg.max()) + 1.0,
           "regold": lambda m: gcn_golden(op, x, y, masks=m)}
    if solvers and (solvers["n"], solvers["shift"]) == (n, out["shift"]):
        out["gcn"] = solvers["gcn"].result()[0]
        out["power"] = solvers["power"].result()[0]
        out["cg"] = solvers["cg"].result()[0]
    else:
        out["gcn"] = gcn_golden(op, x, y)
        out["power"] = host_solvers("power_iteration", op,
                                    x0=np.ones((n, 1), np.float32))
        out["cg"] = host_solvers("conjugate_gradient", op,
                                 b=random_dense(n, 4, seed=23),
                                 shift=out["shift"])
    out["seconds"] = time.perf_counter() - tic
    return out


def mesh_small_goldens(a, levels) -> dict:
    """Phase 21 (b)'s and (c)'s host goldens at phase 7's graph, computed
    on the first gloo rank while it packs: the float64 GCN over A and
    over ``D^-1 A``, power iteration over A; over the first two levels
    (their sum A2), the GCN and the space-shared steps' goldens (k=16
    one step and a chain of 3, k=128 one step)."""
    import numpy as np
    from scipy import sparse

    from arrow_matrix_tpu_torch.utils import random_dense

    tic = time.perf_counter()
    n = a.shape[0]
    a64 = sparse.csr_matrix(a, dtype=np.float64)
    deg = np.maximum(np.asarray(a64.sum(axis=1)).ravel(), 1.0)
    a_rn = (sparse.diags(1.0 / deg) @ a64).tocsr()
    x, y = train_inputs(n)
    a_rn_t = a_rn.T.tocsr()
    out = {"gcn": gcn_golden(a64, x, y),
           "gcn_rn": gcn_golden(a_rn, x, y, at=a_rn_t),
           "power": host_solvers("power_iteration", a64,
                                 x0=np.ones((n, 1), np.float32)),
           "row_nnz": a.nnz / n}
    two = levels[:2]
    a2 = host_matrix(two, n)
    out["gcn2"] = gcn_golden(a2, x, y)
    out["regold"] = {
        "gcn": lambda m: gcn_golden(a64, x, y, masks=m),
        "gcn_rn": lambda m: gcn_golden(a_rn, x, y, at=a_rn_t, masks=m),
        "gcn2": lambda m: gcn_golden(a2, x, y, masks=m)}
    out["row_nnz2"] = a2.nnz / n
    g = out["k16"] = host_golden(two, random_dense(n, 16, seed=3), 2)
    for _ in range(2):
        g = host_golden(two, g, 2)
    out["chain3"] = g
    out["k128"] = host_golden(two, random_dense(n, 128, seed=4), 2)
    out["seconds"] = time.perf_counter() - tic
    return out


def mesh_rank_relu_nccl(ctx) -> list:
    """Phase 21 (a)'s first step on the NCCL rank up to its ReLUs: where
    they open (:func:`relu_masks`), as host bool arrays."""
    from arrow_matrix_tpu_torch.models import GCNCarried

    exe = _RANK["exe"]
    x, _ = train_inputs(exe.n)
    model = GCNCarried(exe, MODEL_DIMS, seed=0)
    return relu_masks(model, exe, exe.set_features(x))


def mesh_rank_train_nccl(ctx, shift: float) -> dict:
    """Phase 21 (a) on the NCCL rank, over phase 20 (b)'s SellMultiLevel
    at the 2^20 levels: ``GCNCarried`` for :data:`MESH_TRAIN` steps
    (timed as phase 13 times the fold's), power iteration and CG, each
    with its launches gated."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.models import (
        GCNCarried,
        conjugate_gradient,
        power_iteration,
    )
    from arrow_matrix_tpu_torch.utils import random_dense

    exe, steps, iters = _RANK["exe"], MESH_TRAIN["steps"], MESH_TRAIN["iters"]
    n = exe.n
    tic = time.perf_counter()
    t = exe.transposed()
    res = {"transposed": {"packed": t.packed, "bytes": t.device_bytes,
                          "seconds": t.seconds,
                          "wall_s": time.perf_counter() - tic}}
    if t.packed or t.device_bytes:
        raise SystemExit("phase 21 (a): a level of the symmetric 2^20 "
                         "operator was packed transposed")
    x, y = train_inputs(n)
    model = GCNCarried(exe, MODEL_DIMS, seed=0)
    xs, ys, mask = exe.set_features(x), exe.set_features(y), \
        exe.carried_mask()
    parts = {"setup_s": time.perf_counter() - tic}
    tic = time.perf_counter()
    reset_counters()
    run = train_timed(model, xs, ys, mask, steps)
    parts["train_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    k_in, hidden, _ = MODEL_DIMS
    fwd = added(exe.launch_counts(k_in), exe.launch_counts(hidden))
    bwd = exe.launch_counts(hidden, transposed=True)
    for f, b in run["launches"]:
        got_f, got_b = (dict(zip(KERNEL_NAMES, v)) for v in (f, b))
        if any(got_f[k] != v for k, v in fwd.items()) or any(
                got_b[k] != v for k, v in bwd.items()):
            raise SystemExit(f"phase 21 (a) train: launches a step "
                             f"{got_f} / {got_b}, expected {fwd} / {bwd}")
    res.update(losses=run["losses"], ms=run["ms"],
               step_ms=statistics.median(v[2] for v in run["ms"][1:]),
               launches_step=added(fwd, bwd),
               first_out=exe.gather_result(run["first_out"]),
               first_grads=[g.cpu().numpy() for g in run["first_grads"]])
    parts["results_s"] = time.perf_counter() - tic
    del model, xs, ys, run
    tic = time.perf_counter()
    ones = np.ones((n, 1), np.float32)
    (v, lam), _ = mesh_gate(scaled(exe.launch_counts(1), iters + 1),
                            lambda: power_iteration(exe, ones, iters),
                            "(a) power iteration")
    parts["power_s"] = time.perf_counter() - tic
    b = random_dense(n, 4, seed=23)
    tic = time.perf_counter()
    (xc, rnorm), _ = mesh_gate(
        scaled(exe.launch_counts(4), iters),
        lambda: conjugate_gradient(exe, b, shift=shift, iterations=iters),
        "(a) conjugate gradient")
    res.update(power=(v, lam), cg=xc, cg_rnorm=rnorm,
               cg_s=time.perf_counter() - tic, parts=parts)
    torch.cuda.empty_cache()
    return res


def check_model_run(tag: str, out, grads, losses, gold: dict,
                    row_nnz: float, masks=None, regold=None) -> dict:
    """A GCN run's first forward and gradients against the float64 host
    (gates ``relative_tolerance(nnz/n, products)``: 2 products forward,
    3 for the gradients), its ReLUs where the device's opened
    (:func:`at_device_relus`, given the device's ``masks`` and
    ``regold``); its losses finite and falling."""
    import numpy as np

    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    flips = 0
    if masks is not None:
        gold, flips = at_device_relus(gold, masks, regold)

    tol_f, tol_g = relative_tolerance(row_nnz, 2), relative_tolerance(
        row_nnz, 3)
    errs = {"forward": relative_error(out, gold["logits"])}
    want = [g for pair in gold["grads"] for g in pair]
    errs["grads"] = max(relative_error(g, w) for g, w in zip(grads, want))
    errs["loss"] = abs(losses[0] - gold["loss"]) / abs(gold["loss"])
    if not (errs["forward"] <= tol_f and errs["grads"] <= tol_g
            and errs["loss"] <= tol_f and len(grads) == len(want)):
        raise SystemExit(f"phase 21 {tag}: rel errs {errs} against the "
                         f"float64 host (gates {tol_f:.1e} / {tol_g:.1e})")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit(f"phase 21 {tag}: losses {losses} not finite or "
                         f"not falling")
    return {"errs": errs, "gates": (tol_f, tol_g), "relu_flips": flips}


def mesh_rank_train(ctx) -> dict:
    """Phase 21 (b) on the gloo ranks at phase 7's graph (BA 2^16):
    a GCN train step over ``MultiLevelArrow(mesh=, fmt="ell")``,
    ``GCNCarried`` over ``SellMultiLevel`` a2a on ``D^-1 A`` (every
    level packed transposed) and power iteration, each gated by its
    launches; the float64 host goldens were computed when the ranks
    packed."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.models import (
        GCNCarried,
        GCNModel,
        gcn_forward,
        make_gcn_train_step,
        power_iteration,
    )
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel

    from arrow_matrix_tpu_torch.utils import relative_error

    a, levels = _RANK["small"]
    width, n = _RANK["width"], a.shape[0]
    gold = _RANK.get("gold", {})
    steps, iters = MESH_TRAIN["steps"], MESH_TRAIN["iters"]
    mesh = make_mesh((ctx.world,), ("blocks",), device=ctx.device)
    x, y = train_inputs(n)
    res = {}

    def params():
        return [p.detach().cpu().numpy().copy()
                for p in model.parameters()]

    # A GCN train step over MultiLevelArrow(mesh=, fmt="ell"), routed by
    # the a2a tables: the default all-gather moves the whole carriage
    # through pinned host buffers on ranks that share the card.
    exe = MultiLevelArrow(levels, width, mesh=mesh, fmt="ell",
                          routing="a2a")
    model = GCNModel(exe, MODEL_DIMS, seed=0)
    xs, ys, mask = exe.set_features(x), exe.set_features(y), \
        exe.real_row_mask()
    with torch.no_grad():
        out = exe.gather_result(gcn_forward(model.params, xs, exe))
    masks = relu_masks(model, exe, xs)
    first = FirstGrads()
    step = make_gcn_train_step(exe, first(model.params.parameters()))
    tic = time.perf_counter()
    losses, got = mesh_gate(
        train_counts(exe, steps),
        lambda: [float(step(model.params, xs, ys, mask))
                 for _ in range(steps)], "(b) GCN over MultiLevelArrow(mesh=)")
    res["gcn_ell"] = dict(losses=losses, params=params(), launches=got,
                          step_s=(time.perf_counter() - tic) / steps,
                          packed=exe.transposed().packed)
    if ctx.rank == 0:
        res["gcn_ell"].update(check_model_run(
            "(b) GCN over MultiLevelArrow(mesh=)", out, first.grads, losses,
            gold["gcn"], gold["row_nnz"], masks, gold["regold"]["gcn"]))
    (v, lam), got = mesh_gate(
        scaled(exe.launch_counts(1), iters + 1),
        lambda: power_iteration(exe, np.ones((n, 1), np.float32), iters),
        "(b) power iteration")
    res["power"] = dict(lam=lam, launches=got)
    if ctx.rank == 0:
        hv, hlam = gold["power"]
        res["power"].update(host_lam=hlam, lam_err=abs(lam - hlam) / abs(hlam),
                            v_err=relative_error(v, hv))
        if not res["power"]["lam_err"] <= 1e-2:
            raise SystemExit(f"phase 21 (b) power iteration: {lam} against "
                             f"the host's {hlam}")
    del exe, model, xs, ys
    # GCNCarried over SellMultiLevel a2a on D^-1 A: its transpose packed.
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    sm = SellMultiLevel(scaled_levels(levels, rows=1.0 / deg), width, mesh,
                        routing="a2a")
    t = sm.transposed()
    if t.packed != list(range(len(levels))):
        raise SystemExit(f"phase 21 (b): D^-1 A packed levels {t.packed}")
    model = GCNCarried(sm, MODEL_DIMS, seed=0)
    with torch.no_grad():
        out = sm.gather_result(model(sm.set_features(x)))
    masks = relu_masks(model, sm, sm.set_features(x))
    first = FirstGrads()
    tic = time.perf_counter()
    losses, got = mesh_gate(train_counts(sm, steps),
                            lambda: model.fit(x, y, steps=steps,
                                              optimizer=first),
                            "(b) GCNCarried over SellMultiLevel(D^-1 A)")
    res["gcn_sell_rn"] = dict(
        losses=losses, params=params(), launches=got,
        step_s=(time.perf_counter() - tic) / steps,
        transposed={"packed": t.packed, "bytes": t.device_bytes,
                    "seconds": t.seconds})
    if ctx.rank == 0:
        res["gcn_sell_rn"].update(check_model_run(
            "(b) GCNCarried over SellMultiLevel(D^-1 A)", out, first.grads,
            losses, gold["gcn_rn"], gold["row_nnz"], masks,
            gold["regold"]["gcn_rn"]))
    _RANK["sell_rn"] = sm
    _RANK["sell_rn_launches"] = got
    torch.cuda.empty_cache()
    return res


def mesh_rank_space(ctx) -> dict:
    """Phase 21 (c) on the gloo ranks as a (lvl=2, blocks=2) mesh over the
    first two levels of phase 7's decomposition: ``SellSpaceShared`` and
    ``SpaceSharedArrow`` (dense and ell), one step at k=16 and k=128 and
    a chain of 3 at k=16 against the host golden, each with its
    launches; ``GCNCarried`` trained through ``SellSpaceShared``."""
    import torch

    from arrow_matrix_tpu_torch.models import GCNCarried
    from arrow_matrix_tpu_torch.parallel import (
        SellSpaceShared,
        SpaceSharedArrow,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.utils import random_dense

    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    _, levels = _RANK["small"]
    levels = levels[:2]
    width, n = _RANK["width"], levels[0].matrix.shape[0]
    gold = _RANK.get("gold", {})

    def gate(tag, got, key, steps):
        if ctx.rank != 0:
            return None
        err = relative_error(got, gold[key])
        tol = relative_tolerance(gold["row_nnz2"], steps)
        if not err <= tol:
            raise SystemExit(f"phase 21 (c) {tag} {key}: rel err "
                             f"{err:.3e} > gate {tol:.1e}")
        return err

    mesh = make_mesh((2, ctx.world // 2), ("lvl", "blocks"),
                     device=ctx.device)
    x16, x128 = random_dense(n, 16, seed=3), random_dense(n, 128, seed=4)
    res = {}
    for tag, build in (
            ("sell_space", lambda: SellSpaceShared(levels, width, mesh)),
            ("space_dense", lambda: SpaceSharedArrow(levels, width, mesh,
                                                     fmt="dense")),
            ("space_ell", lambda: SpaceSharedArrow(levels, width, mesh,
                                                   fmt="ell"))):
        tic = time.perf_counter()
        exe = build()
        rec = {"build_s": time.perf_counter() - tic}
        c = exe.set_features(x16)
        y, rec["launches_k16"] = mesh_counted(exe, 16, 1,
                                              lambda: exe.step(c), tag)
        rec["err_k16"] = gate(tag, exe.gather_result(y), "k16", 1)
        tic = time.perf_counter()
        y, _ = mesh_counted(exe, 16, 3, lambda: exe.run(c, 3), tag)
        rec["chain_ms_per_iter"] = (time.perf_counter() - tic) * 1e3 / 3
        rec["err_chain3"] = gate(tag, exe.gather_result(y), "chain3", 3)
        c = exe.set_features(x128)
        y, rec["launches_k128"] = mesh_counted(exe, 128, 1,
                                               lambda: exe.step(c), tag)
        rec["err_k128"] = gate(tag, exe.gather_result(y), "k128", 1)
        del c, y
        if tag == "space_dense":
            _RANK["space_dense"] = exe
        res[tag] = rec
        if tag != "sell_space":
            del exe
        else:
            sell_space = exe
        torch.cuda.empty_cache()
    x, y = train_inputs(n)
    model = GCNCarried(sell_space, MODEL_DIMS, seed=0)
    with torch.no_grad():
        out = sell_space.gather_result(model(sell_space.set_features(x)))
    masks = relu_masks(model, sell_space, sell_space.set_features(x))
    first = FirstGrads()
    tic = time.perf_counter()
    losses, got = mesh_gate(
        train_counts(sell_space, MESH_TRAIN["steps"]),
        lambda: model.fit(x, y, steps=MESH_TRAIN["steps"], optimizer=first),
        "(c) GCNCarried through SellSpaceShared")
    res["gcn_space"] = dict(
        losses=losses, launches=got,
        params=[p.detach().cpu().numpy().copy() for p in model.parameters()],
        step_s=(time.perf_counter() - tic) / MESH_TRAIN["steps"],
        packed=sell_space.transposed().packed)
    if ctx.rank == 0:
        res["gcn_space"].update(check_model_run(
            "(c) GCNCarried through SellSpaceShared", out, first.grads,
            losses, gold["gcn2"], gold["row_nnz2"], masks,
            gold["regold"]["gcn2"]))
    _RANK["phase21_launches"] = {
        "K1": _RANK.pop("sell_rn_launches")["K1"],
        **{k: res["space_dense"]["launches_k16"][k]
           for k in ("K2", "K3", "K4")}}
    torch.cuda.empty_cache()
    return res


def mesh_rank_space_kernels(ctx):
    """Phase 21 (d) on rank 0 while the card is otherwise idle: K1 over
    its shards of the transposed ``D^-1 A`` levels at k=128, K2 and K3
    over its ``SpaceSharedArrow`` dense shard, K4's pack and unpack of
    its space routes, each against its plain version, timed beside its
    bound, the plain version and one PyTorch call; the other ranks
    return None."""
    if ctx.rank != 0:
        _RANK.pop("sell_rn", None)
        _RANK.pop("space_dense", None)
        return None
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils import relative_tolerance
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    sm, space = _RANK.pop("sell_rn"), _RANK.pop("space_dense")
    launches = _RANK["phase21_launches"]
    dev, k = ctx.device, MODEL_DIMS[1]
    gen = torch.Generator(device=dev).manual_seed(22)
    ops, xs = [], []
    for t in sm.transposed().blocks:
        for name, rows in (("body", t.ops.operand_rows),
                           ("head", t.ops.rows_out)):
            ops.append(t.ops.dev[name])
            xs.append(torch.rand((rows, k), device=dev, generator=gen))
    err = 0.0
    for m, x in zip(ops, xs):
        e, ok = compare(sell_spmm_cuda(m, x), sell_spmm(m, x),
                        _RANK["gold"]["row_nnz"], exact=False)
        if not ok:
            raise SystemExit(f"phase 21 (d): K1 on a transposed shard "
                             f"differs from its plain version ({e:.3e})")
        err = max(err, e)
    csrs = [sorted_csr(m, torch.float32) for m in ops]
    work = [fold_work(m, int(a.values().numel()), k, x_rows=m.x_rows)
            for a, m in zip(csrs, ops)]
    bytes_, flops = (sum(w[i] for w in work) for i in (0, 1))
    t_b, t_o = bytes_ / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    k1 = lambda: [sell_spmm_cuda(m, x) for m, x in zip(ops, xs)]
    e1 = {"name": f"sell_tier_spmm[mesh-transposed,f32,k={k}]",
          "route": "cuda", "source": SOURCES["K1"],
          "replaces": REPLACES["K1"], "launches": launches["K1"],
          "max_abs_err": err, "ms": statistics.median(cuda_runs(k1, 20)),
          "plain_ms": cuda_ms(lambda: [sell_spmm(m, x)
                                       for m, x in zip(ops, xs)], 5),
          "bound_ms": max(t_b, t_o),
          "bound_by": "bytes" if t_b >= t_o else "operations",
          "library_ms": cuda_ms(lambda: [torch.sparse.mm(a, x)
                                         for a, x in zip(csrs, xs)], 5)}
    log(f"phase 21 (d) K1 on rank 0's transposed D^-1 A shards: "
        f"{len(ops)} products at k={k}, {e1['ms']:.4f} ms, plain "
        f"{e1['plain_ms']:.4f}, torch.sparse.mm {e1['library_ms']:.4f}, "
        f"bound {e1['bound_ms']:.4f} ms; max abs err {err:.3e}")
    del csrs, xs
    shim = type("SpaceShards", (), {"blocks": [space.blocks]})()
    c = torch.rand((space.rows_local, 16), device=dev, generator=gen)
    entries = [e1] + [
        dict(e, name=e["name"].replace("[mesh,", "[space,"))
        for e in mesh_block_entries(
            shim, c, {"K2": launches["K2"], "K3": launches["K3"]},
            relative_tolerance(_RANK["gold"]["row_nnz2"], 1),
            phase="phase 21 (d) space")]
    # K4: the pack and the unpack of both space routes, each source in
    # the two parts routed_take passes.
    pairs = []
    for r in (space.bwd_route, space.fwd_route):
        tail = torch.cat([c.new_zeros((1, 16)), torch.rand(
            (r.n_dev * r.slots, 16), device=dev, generator=gen)])
        if r.slots:
            pairs.append((r.send, tail[:1]))
        pairs.append((r.unpack, tail))
    for idx, x2 in pairs:
        got = row_gather(c, idx, x2)
        want = torch.cat([c, x2]).index_select(0, idx.long())
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit("phase 21 (d): K4 on a space route differs "
                             "from index_select")
    rows = sum(int(idx.numel()) for idx, _ in pairs)
    k4 = lambda: [row_gather(c, i, x2) for i, x2 in pairs]
    longs = [(torch.cat([c, x2]), i.long()) for i, x2 in pairs]
    sel = cuda_ms(lambda: [x.index_select(0, i) for x, i in longs], 5)
    entries.append({
        "name": "row_gather[space-route,f32,k=16]", "route": "cuda",
        "source": SOURCES["K4"], "replaces": REPLACES["K4"],
        "launches": launches["K4"], "max_abs_err": 0.0,
        "ms": statistics.median(cuda_runs(k4, 20)), "plain_ms": sel,
        "bound_ms": rows * (2 * 16 * 4 + 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": sel})
    log(f"phase 21 (d) K4 over rank 0's two space routes ({rows} rows): "
        f"{entries[-1]['ms']:.4f} ms, index_select {sel:.4f}, bound "
        f"{entries[-1]['bound_ms']:.4f} ms; bit for bit")
    torch.cuda.empty_cache()
    return entries


def check_nccl_train(a: dict, gold: dict, fold_ms) -> dict:
    """Phase 21 (a)'s results from the NCCL rank against the float64 host
    goldens (:func:`mesh_train_goldens`); its record."""
    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    iters = MESH_TRAIN["iters"]
    row_nnz = gold["row_nnz"]
    rec = {"losses": a["losses"], "step_ms": a["step_ms"], "ms": a["ms"],
           "parts_s": a["parts"],
           "transposed": a["transposed"], "fold_gcn_carried_ms": fold_ms,
           "launches_step": a["launches_step"],
           "host_golden_s": gold["seconds"],
           **check_model_run(
               "(a) GCNCarried on SellMultiLevel", a["first_out"],
               a["first_grads"], a["losses"], gold["gcn"], row_nnz)}
    rec["relu_flips"] = gold["flips"]
    v, lam = a["power"]
    hv, hlam = gold["power"]
    tol = relative_tolerance(row_nnz, iters)
    rec["power"] = {"lam": lam, "host_lam": hlam,
                    "v_err": relative_error(v, hv),
                    "lam_err": abs(lam - hlam) / abs(hlam)}
    rec["cg"] = {"err": relative_error(a["cg"], gold["cg"]),
                 "rnorm": a["cg_rnorm"], "seconds": a["cg_s"]}
    if not (rec["power"]["v_err"] <= tol and rec["power"]["lam_err"] <= tol
            and rec["cg"]["err"] <= tol):
        raise SystemExit(f"phase 21 (a) solvers: {rec['power']}, "
                         f"{rec['cg']} against the host (gate {tol:.1e})")
    fold = ("" if fold_ms is None
            else f" (phase 13's GCNCarried fold step this run: "
                 f"{fold_ms:.4f} ms)")
    log(f"phase 21 (a) on one NCCL rank at 2^20: GCNCarried losses "
        f"{', '.join(f'{v:.6g}' for v in a['losses'])}; train step "
        f"{a['step_ms']:.4f} ms (median of steps 2-{MESH_TRAIN['steps']})"
        f"{fold}; rel errs {rec['errs']} (gates {rec['gates']}; ReLU "
        f"signs decided apart from float64: {rec['relu_flips']}); launches "
        f"a step {a['launches_step']}; transposed build {a['transposed']}; "
        f"power iteration {rec['power']}; CG {rec['cg']}; host goldens "
        f"{gold['seconds']:.1f} s in a thread beside phase 20; the NCCL "
        f"rank's parts {a['parts']}")
    return rec


def check_gloo_train(train: list, space: list) -> dict:
    """Phase 21 (b) and (c) from the gloo ranks (rank 0 held each result
    to the host already): losses and parameters equal bit for bit on
    every rank, one eigenvalue; the records."""
    out = {"b": {}, "c": {}}
    for tag, rec in train[0].items():
        if "losses" in rec:
            check_ranks_equal([r[tag] for r in train], "losses", f"(b) {tag}")
            check_ranks_equal([r[tag] for r in train], "params", f"(b) {tag}")
        out["b"][tag] = {k: v for k, v in rec.items() if k != "params"}
        out["b"][tag]["launches_by_rank"] = [r[tag]["launches"]
                                             for r in train]
    lams = {r["power"]["lam"] for r in train}
    if len(lams) != 1:
        raise SystemExit(f"phase 21 (b): power iteration eigenvalues "
                         f"{sorted(lams)} differ between ranks")
    check_ranks_equal([r["gcn_space"] for r in space], "losses",
                      "(c) gcn_space")
    check_ranks_equal([r["gcn_space"] for r in space], "params",
                      "(c) gcn_space")
    for tag, rec in space[0].items():
        out["c"][tag] = {k: v for k, v in rec.items() if k != "params"}
        out["c"][tag]["launches_by_rank"] = [
            r[tag].get("launches_k16", r[tag].get("launches"))
            for r in space]
    b, c = out["b"], out["c"]
    log(f"phase 21 (b) on {len(train)} gloo ranks at BA 2^16: GCN over "
        f"MultiLevelArrow(mesh=, ell, a2a) losses {b['gcn_ell']['losses']}, "
        f"{b['gcn_ell']['step_s'] * 1e3:.1f} ms a step, errs "
        f"{b['gcn_ell'].get('errs')} (ReLU flips "
        f"{b['gcn_ell'].get('relu_flips')}); GCNCarried over SellMultiLevel "
        f"a2a (D^-1 A) losses {b['gcn_sell_rn']['losses']}, "
        f"{b['gcn_sell_rn']['step_s'] * 1e3:.1f} ms a step, errs "
        f"{b['gcn_sell_rn'].get('errs')} (ReLU flips "
        f"{b['gcn_sell_rn'].get('relu_flips')}), transposed "
        f"{b['gcn_sell_rn']['transposed']}; power iteration "
        f"{b['power']}; losses and parameters bit-equal on every rank")
    log(f"phase 21 (c) on a (lvl=2, blocks=2) mesh, the first two levels "
        f"of BA 2^16: " + "; ".join(
            f"{tag} built {c[tag]['build_s']:.1f} s, errs k16 "
            f"{c[tag]['err_k16']}, chain3 {c[tag]['err_chain3']}, k128 "
            f"{c[tag]['err_k128']}, chain {c[tag]['chain_ms_per_iter']:.1f} "
            f"ms/iter, launches {c[tag]['launches_by_rank']}"
            for tag in ("sell_space", "space_dense", "space_ell"))
        + f"; GCNCarried through SellSpaceShared losses "
          f"{c['gcn_space']['losses']}, {c['gcn_space']['step_s'] * 1e3:.1f}"
          f" ms a step, errs {c['gcn_space'].get('errs')} (ReLU flips "
          f"{c['gcn_space'].get('relu_flips')})")
    return out


def check_ranks_equal(results: list, key: str, tag: str) -> None:
    """Fatal unless every rank's ``key`` is the same, bit for bit."""
    import numpy as np

    first = results[0][key]
    for r in results[1:]:
        other = r[key]
        same = (len(other) == len(first) and all(
            np.array_equal(np.asarray(u), np.asarray(w))
            for u, w in zip(other, first)))
        if not same:
            raise SystemExit(f"phase 21 {tag}: {key} differ between ranks")

# -- 22. the comparison baselines, and the smoke ------------------------------

#: Phase 22: the CLIs' own uniform graph at the main path's nonzero count
#: (2^20 rows, 16 a row), its inputs' seeds, the chains and their reps.
BASE22 = dict(n=1 << 20, edges=1 << 24, seed=42, xseeds={16: 1, 128: 2},
              chain=3, reps=7)


def base22_file(keep: str, what: str) -> str:
    """A file of phase 22's graph or goldens under ``keep``."""
    return os.path.join(keep, f"base22_{what}.npy")


def phase22_host(keep: str, out: str) -> None:
    """Phase 22's host work in a process of its own: the graph
    ``normalize_scale(random_adjacency(2^20, 2^24, seed 42))`` saved as
    an npy CSR triplet, and the host goldens ``A^s x`` (s = 1 and the
    chain's) of its k=16 and k=128 inputs, in float64, saved as f32; a
    ``done`` marker last, which the ranks wait for."""
    import numpy as np

    from arrow_matrix_tpu_torch.cli.common import (
        normalize_scale,
        random_adjacency,
    )
    from arrow_matrix_tpu_torch.utils import random_dense

    tic = time.perf_counter()
    a = normalize_scale(random_adjacency(BASE22["n"], BASE22["edges"],
                                         BASE22["seed"]))
    t_gen = time.perf_counter() - tic
    for name in ("data", "indices", "indptr"):
        np.save(base22_file(keep, name), getattr(a, name))
    tic = time.perf_counter()
    a64 = a.astype(np.float64)
    for k, xseed in BASE22["xseeds"].items():
        g = random_dense(BASE22["n"], k, seed=xseed).astype(np.float64)
        for s in range(1, BASE22["chain"] + 1):
            g = a64 @ g
            if s in (1, BASE22["chain"]):
                np.save(base22_file(keep, f"gold_k{k}_s{s}"),
                        g.astype(np.float32))
    rec = {"t_gen": t_gen, "t_gold": time.perf_counter() - tic,
           "nnz": int(a.nnz), "max_row": int(np.diff(a.indptr).max())}
    with open(base22_file(keep, "done")[:-4] + ".json", "w") as fh:
        json.dump(rec, fh)
    with open(out, "w") as fh:
        json.dump(rec, fh)


def base22_graph(keep: str, timeout_s: float = 900.0):
    """Phase 22's graph as a scipy CSR, once :func:`phase22_host` is
    done (waits for its marker)."""
    import numpy as np
    from scipy import sparse

    marker = base22_file(keep, "done")[:-4] + ".json"
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(marker):
        if time.monotonic() > deadline:
            raise SystemExit("phase 22: the graph's host process did not "
                             "finish")
        time.sleep(0.5)
    n = BASE22["n"]
    parts = [np.load(base22_file(keep, name))
             for name in ("data", "indices", "indptr")]
    return sparse.csr_matrix(tuple(parts), shape=(n, n))


def base22_gate(tag: str, got, keep: str, k: int, s: int) -> float:
    """The relative error of ``got`` against ``A^s x`` (k-wide input);
    fatal beyond ``relative_tolerance(16, s)``."""
    import numpy as np

    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    err = relative_error(got, np.load(base22_file(keep, f"gold_k{k}_s{s}")))
    tol = relative_tolerance(BASE22["edges"] / BASE22["n"], s)
    if not err <= tol:
        raise SystemExit(f"phase 22 {tag}: rel err {err:.3e} > gate "
                         f"{tol:.1e}")
    return err


def base22_build(kind: str, a, shape: tuple, device=None):
    """A baseline over a mesh of ``shape``: ``MatrixSlice1D`` ("1d", a
    ``slices`` axis) or ``SpMM15D`` ("15d", a (rows, repl) grid)."""
    from arrow_matrix_tpu_torch.parallel import MatrixSlice1D, SpMM15D
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    if kind == "1d":
        return MatrixSlice1D(a, make_mesh(shape, ("slices",), device=device))
    return SpMM15D(a, make_mesh(shape, ("rows", "repl"), device=device))


def live_rows(op) -> int:
    """Rows of its features that the one-tier weighted operator ``op``
    reads: the distinct columns of its nonzero slots (padding slots,
    weight 0, read nothing the function needs)."""
    import torch

    cols = op.cols[0]
    return int(torch.unique(cols[op.data[0] != 0]).numel())


def base22_k1_entry(pairs, tag: str, launches: int, row_nnz: float) -> dict:
    """K1 over the baseline operators of one step, ``pairs`` of
    (operator, features) -- a 1D rank's local and nonlocal stacks or a
    1.5D rank's round blocks --, against its plain version: the step's
    products timed together (median of 20) beside their bytes bound
    (each operator's referenced feature rows read once,
    :func:`live_rows`), the plain version's time and ``torch.sparse.mm``
    over the same CSRs; ``launches`` is the driven run's count."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    k = pairs[0][1].shape[1]
    err = 0.0
    for op, x in pairs:
        e, ok = compare(sell_spmm_cuda(op, x), sell_spmm(op, x), row_nnz,
                        exact=False)
        if not ok:
            raise SystemExit(f"phase 22 K1 {tag} k={k}: kernel != plain "
                             f"(max abs err {e:.3e})")
        err = max(err, e)
    csrs = [sorted_csr(op, torch.float32) for op, _ in pairs]
    nnz = sum(int(c.values().numel()) for c in csrs)
    work = [fold_work(op, int(c.values().numel()), k, x_rows=live_rows(op))
            for c, (op, _) in zip(csrs, pairs)]
    bytes_, flops = (sum(w[i] for w in work) for i in (0, 1))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    runs = cuda_runs(lambda: [sell_spmm_cuda(op, x) for op, x in pairs], 20)
    e = {"name": f"sell_tier_spmm[{tag},f32,k={k}]", "route": "cuda",
         "source": SOURCES["K1"], "replaces": REPLACES["K1"],
         "launches": launches, "max_abs_err": err,
         "ms": statistics.median(runs),
         "plain_ms": cuda_ms(lambda: [sell_spmm(op, x) for op, x in pairs],
                             3),
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": cuda_ms(lambda: [torch.sparse.mm(c, x) for c, (_, x)
                                        in zip(csrs, pairs)], 5)}
    shapes = ", ".join(f"{op.n_rows}x{op.cols[0].shape[0]}"
                       for op, _ in pairs)
    log(f"phase 22 K1 {tag} k={k}: {len(pairs)} products (rows x slots "
        f"{shapes}), {nnz} nnz: {e['ms']:.4f} ms a step (median of 20, min "
        f"{min(runs):.4f}), bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
        f"plain {e['plain_ms']:.4f}, torch.sparse.mm {e['library_ms']:.4f}; "
        f"{launches} launches in the driven run; max abs err {err:.3e}")
    del csrs
    return e


def base22_nccl(ctx, keep: str) -> dict:
    """Phase 22 (a) on one NCCL rank, at full width: ``MatrixSlice1D``
    (one slice) and ``SpMM15D`` ((1, 1) grid) over the 2^20 graph, at
    k=16 and k=128: one step and a chain against the host goldens, their
    launches equal to ``launch_counts`` (the counts set to 0 just
    before), a repeat bit for bit, ms/iter (median of 7 chains), and K1
    over each executor's operator timed beside its bound."""
    import torch

    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import cuda_runs

    a = base22_graph(keep)
    row_nnz = a.nnz / a.shape[0]
    chain = BASE22["chain"]
    res, entries = {}, []
    for kind, shape in (("1d", (1,)), ("15d", (1, 1))):
        tic = time.perf_counter()
        exe = base22_build(kind, a, shape)
        torch.cuda.synchronize()
        rec = {"build_s": time.perf_counter() - tic}
        op = exe.local_op if kind == "1d" else exe.ops[0]
        for k, xseed in BASE22["xseeds"].items():
            tag = f"{kind} k={k}"
            x = exe.set_features(random_dense(BASE22["n"], k, seed=xseed))
            y1, launched1 = mesh_counted(exe, k, 1, lambda: exe.spmm(x),
                                         tag, phase="phase 22 (a)")
            err1 = base22_gate(f"(a) {tag} step", exe.gather_result(y1),
                               keep, k, 1)
            if not torch.equal(exe.spmm(x), y1):
                raise SystemExit(f"phase 22 (a) {tag}: a repeat differs")
            y3, launched = mesh_counted(exe, k, chain,
                                        lambda: exe.run(x, chain), tag,
                                        phase="phase 22 (a)")
            err3 = base22_gate(f"(a) {tag} chain", exe.gather_result(y3),
                               keep, k, chain)
            del y1, y3
            runs = [t / chain for t in
                    cuda_runs(lambda: exe.run(x, chain), BASE22["reps"])]
            rec[f"k{k}"] = {"err1": err1, f"err{chain}": err3,
                            "ms_per_iter": statistics.median(runs),
                            "ms_per_iter_runs": runs,
                            "launches": launched}
            log(f"phase 22 (a) {tag} on one NCCL rank: step {err1:.3e}, "
                f"{chain}-step chain {err3:.3e}, repeat bit for bit; "
                f"{rec[f'k{k}']['ms_per_iter']:.4f} ms/iter (median of "
                f"{BASE22['reps']} chains of {chain}, min {min(runs):.4f}); "
                f"launches of the chain {launched}")
            entries.append(base22_k1_entry(
                [(op, x)], "1d-local" if kind == "1d" else "15d-round",
                launched["K1"], row_nnz))
            del x
            torch.cuda.empty_cache()
        res[kind] = rec
        del exe, op
        torch.cuda.empty_cache()
    return {"a": res, "entries": entries}


def base22_ranks(ctx, keep: str) -> dict:
    """Phase 22 (b) on phase 20's gloo ranks sharing the card, at k=16:
    ``MatrixSlice1D`` over 4 slices and ``SpMM15D`` over (4, 1) and (2, 2)
    on the 2^20 graph, each one step and a chain against the goldens
    (rank 0 gates), its launches equal to ``launch_counts``, this rank's
    counted bytes a step beside ``ideal_comm_bytes(16)``; the 1D pack
    bit-equal to ``index_select``, the (2, 2) replicas bit-equal; then
    the paper's comparison over phase 7's graph (BA 2^16): one step's
    counted bytes of 1D, 1.5D c=1 and c=2 and ``SellMultiLevel`` a2a
    over its decomposition, beside each one's ideal."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel
    from arrow_matrix_tpu_torch.utils import (
        commstats,
        random_dense,
        relative_error,
        relative_tolerance,
    )

    first = ctx.rank == 0
    chain = BASE22["chain"]
    a = base22_graph(keep)
    x16 = random_dense(BASE22["n"], 16, seed=BASE22["xseeds"][16])
    res = {}

    def step_bytes(exe, x) -> dict:
        torch.cuda.synchronize()
        commstats.reset()
        y = exe.step(x)
        torch.cuda.synchronize()
        return y, commstats.snapshot()

    for kind, shape in (("1d", (4,)), ("15d", (4, 1)), ("15d", (2, 2))):
        tag = f"{kind} {shape}"
        exe = base22_build(kind, a, shape)
        x = exe.set_features(x16)
        y1, _ = mesh_counted(exe, 16, 1, lambda: exe.spmm(x), tag,
                             phase="phase 22 (b)")
        out1 = exe.gather_result(y1)
        y3, launched = mesh_counted(exe, 16, chain,
                                    lambda: exe.run(x, chain), tag,
                                    phase="phase 22 (b)")
        out3 = exe.gather_result(y3)
        _, st = step_bytes(exe, x)
        rec = {"launches": launched, "bytes": st["total_bytes"],
               "by_kind": {kk: v for kk, v in st.items()
                           if isinstance(v, dict) and v["count"]},
               "staged": st["host_staged_bytes"],
               "ideal": exe.ideal_comm_bytes(16)}
        if first:
            rec["err1"] = base22_gate(f"(b) {tag} step", out1, keep, 16, 1)
            rec[f"err{chain}"] = base22_gate(f"(b) {tag} chain", out3, keep,
                                             16, chain)
        if kind == "1d":
            got = row_gather(x, exe.send_dev)
            want = x.index_select(0, exe.send_dev.long())
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise SystemExit("phase 22 (b): the K4 pack differs from "
                                 "index_select")
            rec["slot"] = exe.slot
            _RANK["b22_1d"] = (exe, x, launched)
        elif shape == (4, 1):
            _RANK["b22_15d"] = (exe, x, launched)
        else:
            blocks = coll.all_gather(y1.contiguous(), exe.mesh, None)
            parts = blocks.view(4, -1, 16)
            if not (torch.equal(parts[0], parts[1])
                    and torch.equal(parts[2], parts[3])):
                raise SystemExit("phase 22 (b): the (2, 2) replicas differ")
            rec["replicas_bit_equal"] = True
            del exe, x
        res[tag] = rec
        del y1, y3, out1, out3
    torch.cuda.empty_cache()

    # The paper's comparison over phase 7's graph and its decomposition.
    a_s, levels = _RANK["small"]
    n_s = a_s.shape[0]
    xs = random_dense(n_s, 16, seed=6)
    want = np.asarray(a_s @ xs) if first else None
    tol = relative_tolerance(a_s.nnz / n_s)
    comp = {}
    for tag, build in (
            ("1d", lambda: base22_build("1d", a_s, (4,))),
            ("15d c=1", lambda: base22_build("15d", a_s, (4, 1))),
            ("15d c=2", lambda: base22_build("15d", a_s, (2, 2))),
            ("sell a2a", lambda: SellMultiLevel(
                levels, 2048, make_mesh((4,), ("blocks",)),
                routing="a2a"))):
        exe = build()
        y, st = step_bytes(exe, exe.set_features(xs))
        out = exe.gather_result(y)
        comp[tag] = {"bytes": st["total_bytes"],
                     "ideal": exe.ideal_comm_bytes(16)}
        if first:
            comp[tag]["err"] = err = relative_error(out, want)
            if not err <= tol:
                raise SystemExit(f"phase 22 (b) comparison {tag}: rel err "
                                 f"{err:.3e} > {tol:.1e}")
        del exe, y
        torch.cuda.empty_cache()
    res["comparison"] = comp
    return res


def base22_kernels(ctx) -> list:
    """Phase 22's kernel timings on gloo rank 0 of (b), the card
    otherwise idle: K1 over a step's operators -- the 1D local and
    nonlocal stacks, the four (4, 1) round blocks --, and K4's 1D pack
    against ``index_select``, each beside its bound, its plain version
    and one PyTorch call, with the launches of (b)'s driven chain; the
    other ranks return None.  (b)'s executors are dropped after it."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    d1, x, l1 = _RANK.pop("b22_1d")
    d15, x15, l15 = _RANK.pop("b22_15d")
    try:
        if ctx.rank != 0:
            return None
        row_nnz = BASE22["edges"] / BASE22["n"]
        gen = torch.Generator(device=x.device).manual_seed(22)
        recv = torch.rand((d1.n_dev * d1.slot, 16), device=x.device,
                          generator=gen)
        # Each round of the step reads its own broadcast block: distinct
        # buffers, so no round finds its features in L2.
        rounds = [(op, x15 if r == 0 else torch.rand(
            x15.shape, device=x.device, generator=gen))
            for r, op in enumerate(d15.ops)]
        entries = [
            base22_k1_entry([(d1.local_op, x), (d1.nonlocal_op, recv)],
                            "1d-step-of-4", l1["K1"], row_nnz),
            base22_k1_entry(rounds, "15d-step-of-4x1", l15["K1"], row_nnz)]
        del recv, rounds
        idx = d1.send_dev
        rows = int(idx.numel())
        src = int(torch.unique(idx).numel())
        runs = cuda_runs(lambda: row_gather(x, idx), 20)
        sel = cuda_ms(lambda: x.index_select(0, idx.long()), 5)
        # The source rows it references read once, the index read and
        # the packed rows written once.
        bound = (src * 16 * 4 + rows * (16 * 4 + 4)) / HBM_BYTES_PER_S * 1e3
        e4 = {"name": "row_gather[1d-pack,f32,k=16]", "route": "cuda",
              "source": SOURCES["K4"], "replaces": REPLACES["K4"],
              "launches": l1["K4"], "max_abs_err": 0.0,
              "ms": statistics.median(runs), "plain_ms": sel,
              "bound_ms": bound, "bound_by": "bytes", "library_ms": sel}
        log(f"phase 22 K4 1D pack on gloo rank 0 ({rows} rows of {src} "
            f"distinct, slot {d1.slot}): {e4['ms']:.4f} ms (median of 20), "
            f"index_select {sel:.4f}, bound {bound:.4f} ms; bit for bit in "
            f"(b)")
        return entries + [e4]
    finally:
        del d1, d15, x, x15
        torch.cuda.empty_cache()


def start_base22_clis(keep: str, base: str) -> dict:
    """Phase 22 (c)'s subprocesses, which time nothing, started beside
    phase 19: ``graft_trace smoke --devices 4`` on the card at the
    smoke's defaults, and ``spmm_arrow --obs_dir --mem_report --trace``
    over phase 4's saved 2^20 artifact on one card for 3 iterations."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(keep, "smoke22")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=root)
    procs = {}
    for name, argv in (
            ("smoke", ["-m", "arrow_matrix_tpu_torch.obs", "smoke",
                       os.path.join(work, "run"), "--devices", "4"]),
            ("spmm_arrow", ["-m", "arrow_matrix_tpu_torch.cli.spmm_arrow",
                            "--path", base, "--width", "2048",
                            "--features", "16", "--iterations", "3",
                            "--obs_dir", os.path.join(work, "obs"),
                            "--mem_report", "--trace",
                            os.path.join(work, "trace")])):
        log_path = os.path.join(work, f"{name}.log")
        fh = open(log_path, "w")
        procs[name] = (subprocess.Popen([sys.executable, *argv], cwd=root,
                                        env=env, stdout=fh,
                                        stderr=subprocess.STDOUT),
                       fh, log_path, time.perf_counter())
    return {"work": work, "procs": procs}


def finish_base22_clis(clis: dict) -> dict:
    """Phase 22 (c): both subprocesses exit 0; the smoke's run directory
    is valid (``validate_run_dir`` empty) and ``graft_trace summarize``,
    ``export`` and ``diff run run`` exit 0 on it; ``spmm_arrow`` left its
    span trace and ``metrics.jsonl``, its memory and imbalance reports,
    and a profiler trace whose kernel events name K1."""
    import contextlib
    import io

    from arrow_matrix_tpu_torch.obs.__main__ import main as trace_main
    from arrow_matrix_tpu_torch.obs.smoke import validate_run_dir

    work, res = clis["work"], {}
    for name, (proc, fh, log_path, started) in clis["procs"].items():
        try:
            rc = proc.wait(timeout=600)
        finally:
            fh.close()
        with open(log_path) as f:
            text = f.read()
        res[name] = {"rc": rc,
                     "collected_after_s": time.perf_counter() - started}
        if rc != 0:
            raise SystemExit(f"phase 22 (c) {name} exited {rc}:\n"
                             f"{text[-3000:]}")
        res[name]["text"] = text
    run = os.path.join(work, "run")
    problems = validate_run_dir(run)
    rcs = {}
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rcs["summarize"] = trace_main(["summarize", run])
        rcs["export"] = trace_main(["export", run, "--out",
                                    os.path.join(work, "merged.json")])
        rcs["diff"] = trace_main(["diff", run, run])
    if problems or any(rcs.values()):
        raise SystemExit(f"phase 22 (c) smoke: problems {problems}, exit "
                         f"codes {rcs}")
    res["smoke"].update(cli_rcs=rcs, summary=buf.getvalue().splitlines())
    obs = os.path.join(work, "obs")
    for f in ("spmm_arrow.trace.json", "metrics.jsonl"):
        if not os.path.getsize(os.path.join(obs, f)):
            raise SystemExit(f"phase 22 (c): spmm_arrow left an empty {f}")
    text = res["spmm_arrow"].pop("text")
    res["smoke"].pop("text")
    traces = sorted(os.listdir(os.path.join(work, "trace")))
    k1 = kernels = 0
    for t in traces:
        with open(os.path.join(work, "trace", t)) as f:
            events = json.load(f).get("traceEvents", [])
        names = [e.get("name", "") for e in events
                 if e.get("ph") == "X" and e.get("cat") == "kernel"]
        kernels += len(names)
        k1 += sum(any(s in nm for s in K1_NAMES) for nm in names)
    if not traces or not k1:
        raise SystemExit(f"phase 22 (c): the profiler trace of spmm_arrow "
                         f"({traces}) names no K1 kernel ({kernels} "
                         f"kernels)")
    reports = [line for line in text.splitlines()
               if line.startswith(("measured vs format-model",
                                   "per-shard load balance"))]
    if len(reports) != 2:
        raise SystemExit(f"phase 22 (c): spmm_arrow printed no memory and "
                         f"imbalance report:\n{text[-3000:]}")
    res["spmm_arrow"].update(trace_files=traces, kernel_events=kernels,
                             k1_events=k1, reports=reports)
    return res


def phase_baselines(b22: list, a22: dict, kernels: list, clis: dict,
                    host: dict) -> dict:
    """Phase 22's results (module docstring) gathered and logged: (a) from
    the NCCL rank, (b) from the gloo ranks, the kernel entries, (c)'s
    subprocesses."""
    tic = time.perf_counter()
    res = {"host": host, "a": a22["a"]}
    r0 = b22[0]
    per_rank = {tag: [r[tag]["bytes"] for r in b22]
                for tag in r0 if tag != "comparison"}
    res["b"] = {tag: dict(rec, bytes_per_rank=per_rank[tag])
                for tag, rec in r0.items() if tag != "comparison"}
    for tag, rec in res["b"].items():
        log(f"phase 22 (b) {tag} on 4 gloo ranks sharing the card: step "
            f"{rec['err1']:.3e}, chain {rec['err' + str(BASE22['chain'])]:.3e}; "
            f"counted bytes a step by rank {rec['bytes_per_rank']} "
            f"({ {kk: v['bytes'] for kk, v in rec['by_kind'].items()} } on "
            f"rank 0, host staged {rec['staged']}) beside "
            f"ideal_comm_bytes(16) {rec['ideal']}; launches a rank "
            f"{[r[tag]['launches'] for r in b22]}")
    comp = {tag: {"ideal": rec["ideal"], "err": rec["err"],
                  "bytes_per_rank": [r["comparison"][tag]["bytes"]
                                     for r in b22]}
            for tag, rec in r0["comparison"].items()}
    res["comparison"] = comp
    log("phase 22 (b) the paper's comparison at BA 2^16 (phase 7's graph), "
        "k=16, 4 ranks, counted bytes a step summed over the ranks "
        "(ideal_comm_bytes(16)): " + "; ".join(
            f"{tag} {sum(v['bytes_per_rank'])} ({v['ideal']})"
            for tag, v in comp.items()))
    res["c"] = finish_base22_clis(clis)
    sm = res["c"]["smoke"]
    log(f"phase 22 (c): graft_trace smoke --devices 4 on the card (done "
        f"within {sm['collected_after_s']:.1f} s of its start), valid, "
        f"summarize/export/diff exit 0: " + " | ".join(sm["summary"][1:7]))
    sa = res["c"]["spmm_arrow"]
    log(f"phase 22 (c): spmm_arrow --obs_dir --mem_report --trace over the "
        f"2^20 artifact (done within {sa['collected_after_s']:.1f} s of its "
        f"start): {sa['k1_events']} K1 events of {sa['kernel_events']} "
        f"kernel events in {sa['trace_files']}; {sa['reports']}")
    res["kernels"] = [e["name"] for e in kernels]
    res["wrapup_s"] = time.perf_counter() - tic
    return res


# -- 23. serving and state on a mesh of ranks ---------------------------------

#: Phase 23: the step-2 checkpoints' migration budget of (b)'s grow (bytes
#: a stage), (c)'s graph (the CLI generates it), (d)'s run over phase 4's
#: artifact (its input the CLI's ``random_dense(n, 4, seed=42)``), and
#: the seconds any of its subprocesses may take.
STATE_ITERS = 2
STATE = dict(reshard_budget=1 << 20,
             cli=["--vertices", "16384", "--ba_neighbors", "8", "--width",
                  "512", "--features", "4"],
             memmap=["--width", "2048", "--features", "4", "--iterations",
                     str(STATE_ITERS), "--carry", "--validate"],
             timeout_s=900)


def state23_prepare(ctx, base: str, width: int, n_small: int) -> None:
    """``--state``'s ranks, as phases 20-22 leave them for phase 23: the
    NCCL rank holds phase 4's levels, the gloo ranks phase 20's
    ``SellMultiLevel`` a2a over them (on the card), phase 7's graph and
    its decomposition."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    levels = as_levels_of(base, width)
    if ctx.backend == "nccl":
        _RANK.update(levels=levels, width=width)
        return
    mesh = make_mesh((ctx.world,), ("blocks",), device="cpu")
    _RANK["exe"] = SellMultiLevel(levels, width, mesh,
                                  routing="a2a").to(ctx.device)
    a = barabasi_albert(n_small, 8, seed=7)
    _RANK["small"] = (a, arrow_decomposition(a, width, max_levels=10,
                                             block_diagonal=True, seed=7))


def state23_fold_ref(fold):
    """(d)'s reference on one rank: the carriage the CLI's fold (its
    default format there) checkpoints after its iterations from its
    input, as a host array, here from a fold over the loaded levels."""
    from arrow_matrix_tpu_torch.utils import random_dense

    c = fold.run(fold.set_features(random_dense(fold.n, 4, seed=42)),
                 STATE_ITERS)
    return c.cpu().numpy()


def state23_nccl_build(ctx, width: int, fold_ref: bool) -> dict:
    """Phase 23 (a)'s executor on the NCCL rank, built beside the earlier
    phases: ``MultiLevelArrow(mesh=, fmt="ell")`` over phase 4's levels on
    the mesh of this one rank, the one rung (the base) of the server's
    factory; and the trace it serves (phase 15's, its first request
    phase 4's k=16 input); with ``fold_ref`` (a run without phase 4's
    fold) (d)'s reference on one rank."""
    import dataclasses

    import torch

    from arrow_matrix_tpu_torch import serve
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.utils import random_dense

    tic = time.perf_counter()
    mesh = make_mesh((ctx.world,), ("blocks",))
    exe = MultiLevelArrow(_RANK["levels"], width, mesh=mesh, fmt="ell")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - tic
    trace = serve.synthetic_trace(exe.n, tenants=SERVE["tenants"],
                                  requests=SERVE["requests"], k=SERVE["k"],
                                  iterations=SERVE["iterations"],
                                  seed=SERVE["seed"])
    trace[0] = dataclasses.replace(trace[0],
                                   x=random_dense(exe.n, 16, seed=3))
    _RANK.update(serve23=exe, trace23=trace)
    if fold_ref:
        fold = MultiLevelArrow(_RANK["levels"], width, fmt="fold",
                               device=ctx.device)
        _RANK["fold_ref23"] = state23_fold_ref(fold)
        del fold
        torch.cuda.empty_cache()
    return {"build_s": t_build, "fmts": exe.fmts,
            "heads": exe.head_layouts(), "rows_local": exe.rows_local,
            "operator_bytes": exe.operator_bytes()}


def state23_nccl(ctx, base: str) -> dict:
    """Phase 23 (a) on the NCCL rank: phase 15's deployment served over
    the ELL mesh executor (module docstring), then K1 over one step's
    shard operators and K4 over one step's routing at the batch shape
    against their plain versions; returns the results and the two kernel
    entries."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch import faults, serve
    from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

    exe = TimedExecutor(_RANK.pop("serve23"))
    trace = _RANK.pop("trace23")
    n, it, kmax = exe.n, SERVE["iterations"], SERVE["max_batch_k"]
    row_nnz = exe.nnz / n
    builds = {}

    def factory(cfg):
        builds[str(cfg)] = builds.get(str(cfg), 0) + 1
        return exe

    policy = faults.RetryPolicy(max_retries=2, backoff_s=0.01, jitter=0.2,
                                seed=SERVE["seed"])
    srv = serve.ArrowServer(factory, serve.ExecConfig(), policy=policy,
                            queue_capacity=SERVE["queue"], max_batch_k=kmax,
                            name="phase23")
    exe.log.clear()
    torch.cuda.synchronize()
    reset_counters()
    tic = time.perf_counter()
    tickets = serve.run_trace(srv, trace)
    wall = time.perf_counter() - tic
    got = dict(zip(KERNEL_NAMES, counters()))
    s = srv.summary()
    bad = [t.request.request_id for t in tickets if t.status != "completed"]
    if bad or s["faults_seen"] or srv.lockstep:
        raise SystemExit(f"phase 23 (a): not completed {bad}, faults "
                         f"{s['faults_seen']}, lockstep {srv.lockstep}")
    if s["batches"] != SERVE["requests"] * SERVE["k"] // kmax:
        raise SystemExit(f"phase 23 (a): {s['batches']} batches")
    want = {name: v * s["batches"] * it
            for name, v in exe.launch_counts(kmax).items()}
    if got != want or not got["K1"] or not got["K4"]:
        raise SystemExit(f"phase 23 (a): launches {got}, expected "
                         f"{want} (launch_counts x {s['batches']} batches "
                         f"x {it} iterations)")
    per_batch = kmax // SERVE["k"]
    for b in range(s["batches"]):
        t = tickets[b * per_batch]
        if serve_alone(serve, factory, t.request, policy).tobytes() != \
                t.result.tobytes():
            raise SystemExit(f"phase 23 (a): {t.request.request_id} batched "
                             f"!= alone")
    err = relative_error(tickets[0].result,
                         np.load(golden_path(base, 16, it)))
    tol = relative_tolerance(row_nnz, it)
    if not err <= tol:
        raise SystemExit(f"phase 23 (a): phase 4's input after {it} served "
                         f"steps: rel err {err:.3e} > {tol:.1e}")
    if builds != {str(serve.ExecConfig()): 1 + s["batches"]}:
        raise SystemExit(f"phase 23 (a): factory calls {builds}")
    batches = [rec for rec in exe.log if rec["k"] == kmax]
    res = {"requests": len(tickets), "wall_s": wall,
           "requests_per_s": len(tickets) / wall,
           "latency_ms": serve.latency_summary_ms(tickets),
           "batches": s["batches"], "launches": got,
           "batch_device_ms": [r["device_ms"] for r in batches],
           "batch_loop_wall_ms": [r["loop_wall_ms"] for r in batches],
           "set_features_ms": [r["set_features_ms"] for r in batches],
           "gather_result_ms": [r["gather_ms"] for r in batches],
           "phase4_input_err": err, "phase4_input_gate": tol,
           "fmts": exe.fmts, "heads": exe.head_layouts()}
    del tickets, trace
    entries = state23_kernel_entries(exe.ex, kmax, row_nnz, got)
    res["entries"] = entries
    res["fold_ref"] = _RANK.pop("fold_ref23", None)
    del exe
    torch.cuda.empty_cache()
    return res


def state23_kernel_entries(exe, k: int, row_nnz: float, got: dict) -> list:
    """Phase 23 (a)'s K1 over one step's shard operators (every ELL stack
    and head of every level, on random operands of their shapes) and K4
    over one step's routing (the forward gathers and the backward
    gather-adds), each against its plain version (K4 bit for bit), timed
    beside its bound, its plain version and one PyTorch call."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_gather import (
        row_gather,
        row_gather_add_,
    )
    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.ops.sell import sell_spmm
    from arrow_matrix_tpu_torch.utils.timing import cuda_ms, cuda_runs

    dev = exe.mesh.device
    gen = torch.Generator(device=dev).manual_seed(23)
    shared = {}

    def operand(rows):
        if rows not in shared:
            shared[rows] = torch.rand((rows, k), device=dev, generator=gen)
        return shared[rows]

    ops = [op for sb in exe.blocks for name, op in sb.ops.items()
           if name != "head_inv"]
    xs = [operand(op.x_rows) for op in ops]
    err = 0.0
    for m, x in zip(ops, xs):
        e, ok = compare(sell_spmm_cuda(m, x), sell_spmm(m, x), row_nnz,
                        exact=False)
        if not ok:
            raise SystemExit(f"phase 23 (a): K1 on a shard operator differs "
                             f"from its plain version (max {e:.3e})")
        err = max(err, e)
    csrs = [sorted_csr(m, torch.float32) for m in ops]
    work = [fold_work(m, int(a.values().numel()), k, x_rows=m.x_rows)
            for a, m in zip(csrs, ops)]
    bytes1, flops1 = (sum(w[i] for w in work) for i in (0, 1))
    t_b, t_o = bytes1 / HBM_BYTES_PER_S * 1e3, flops1 / F32_FLOPS * 1e3
    runs = cuda_runs(lambda: [sell_spmm_cuda(m, x)
                              for m, x in zip(ops, xs)], 10)
    e1 = {"name": f"sell_tier_spmm[serve-mesh,f32,k={k}]", "route": "cuda",
          "source": SOURCES["K1"], "replaces": REPLACES["K1"],
          "launches": got["K1"], "max_abs_err": err,
          "ms": statistics.median(runs),
          "plain_ms": cuda_ms(lambda: [sell_spmm(m, x)
                                       for m, x in zip(ops, xs)], 3),
          "bound_ms": max(t_b, t_o),
          "bound_by": "bytes" if t_b >= t_o else "operations",
          "library_ms": cuda_ms(lambda: [torch.sparse.mm(a, x)
                                         for a, x in zip(csrs, xs)], 3)}
    log(f"phase 23 (a) K1 on the NCCL rank's shards at k={k}: {len(ops)} "
        f"products {e1['ms']:.4f} ms a step, plain {e1['plain_ms']:.4f}, "
        f"torch.sparse.mm {e1['library_ms']:.4f}, bound "
        f"{e1['bound_ms']:.4f} ms; max abs err {err:.3e}")
    del csrs, shared, xs
    # K4: one step's routing as the step runs it on one rank (the
    # all-gather of one rank is a copy): a gather a level boundary
    # forward, a gather-add backward.
    x = torch.rand((exe.rows_local, k), device=dev, generator=gen)
    acc = torch.rand((exe.rows_local, k), device=dev, generator=gen)
    fwd = [t.idx for t in exe.fwd]
    bwd = [t.idx for t in exe.bwd]
    for i in fwd:
        if not torch.equal(row_gather(x, i).view(torch.int32),
                           x.index_select(0, i.long()).view(torch.int32)):
            raise SystemExit("phase 23 (a): K4 gather != index_select")
    for i in bwd:
        a = row_gather_add_(acc.clone(), x, i)
        b = acc + x.index_select(0, i.long())
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise SystemExit("phase 23 (a): K4 gather-add != index_select "
                             "then add")
    rows_f = sum(int(i.numel()) for i in fwd)
    rows_b = sum(int(i.numel()) for i in bwd)
    bytes4 = rows_f * (2 * k * 4 + 4) + rows_b * (3 * k * 4 + 4)
    longs_f, longs_b = [i.long() for i in fwd], [i.long() for i in bwd]
    runs = cuda_runs(lambda: ([row_gather(x, i) for i in fwd],
                              [row_gather_add_(acc, x, i) for i in bwd]), 10)
    plain = cuda_ms(lambda: ([x.index_select(0, i) for i in longs_f],
                             [acc.add_(x.index_select(0, i))
                              for i in longs_b]), 5)
    e4 = {"name": f"row_gather[serve-mesh-route,f32,k={k}]", "route": "cuda",
          "source": SOURCES["K4"], "replaces": REPLACES["K4"],
          "launches": got["K4"] + got["K4 add"], "max_abs_err": 0.0,
          "ms": statistics.median(runs), "plain_ms": plain,
          "bound_ms": bytes4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
          "library_ms": cuda_ms(lambda: (
              [x.index_select(0, i) for i in longs_f],
              [acc.index_add_(0, i, x) for i in longs_b]), 5)}
    log(f"phase 23 (a) K4 over one step's routing at k={k} ({len(fwd)} "
        f"gathers, {len(bwd)} gather-adds, {rows_f + rows_b} rows): "
        f"{e4['ms']:.4f} ms, plain {plain:.4f}, library "
        f"{e4['library_ms']:.4f}, bound {e4['bound_ms']:.4f} ms; bit for "
        f"bit")
    return [e1, e4]


def state23_streamed(ctx, base: str, width: int) -> dict:
    """Phase 23 (d) on the NCCL rank: ``arrow_blocks_streamed`` of phase
    4's memmapped level 0 on the mesh of this rank against the eager
    pack of the same level, every array byte for byte."""
    import torch

    from arrow_matrix_tpu_torch.io import load_decomposition
    from arrow_matrix_tpu_torch.ops.arrow_blocks import (
        arrow_blocks_from_csr,
        arrow_blocks_streamed,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    triplet = load_decomposition(base, width, mem_map=True)[0][0]
    mesh = make_mesh((ctx.world,), ("blocks",))
    tic = time.perf_counter()
    got = arrow_blocks_streamed(triplet, width, mesh, fmt="ell")
    t_stream = time.perf_counter() - tic
    tic = time.perf_counter()
    want = arrow_blocks_from_csr(_RANK["levels"][0].matrix, width, fmt="ell",
                                 device=ctx.device)
    t_eager = time.perf_counter() - tic
    a, b = got.tensors(), want.tensors()

    def same(x, y):
        return (x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x.contiguous().view(torch.uint8),
                                y.contiguous().view(torch.uint8)))

    if sorted(a) != sorted(b) or got.head_flat != want.head_flat or \
            not all(same(a[k], b[k]) for k in a):
        raise SystemExit(f"phase 23 (d): the streamed pack of level 0 "
                         f"differs from the eager one ({sorted(a)} against "
                         f"{sorted(b)})")
    out = {"arrays": sorted(a), "head_flat": got.head_flat,
           "bytes": got.device_nbytes(), "streamed_s": t_stream,
           "eager_s": t_eager}
    del got, want
    torch.cuda.empty_cache()
    return out


def state23_ranks(ctx, keep: str) -> dict:
    """Phase 23 (b) on the gloo ranks sharing the card, beside phase 19
    (they time no kernel): phase 15's trace at phase 7's graph served in
    lockstep over ``MultiLevelArrow(mesh=4 ranks, fmt="ell")``, then the
    grow from ranks (0, 1) to all 4 with 8 step-2 checkpoints against a
    never-grown 4-rank server resuming the same states."""
    import hashlib

    import numpy as np
    import torch

    from arrow_matrix_tpu_torch import faults, serve
    from arrow_matrix_tpu_torch.obs.memview import request_bytes_for
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.utils import (
        random_dense,
        relative_error,
        relative_tolerance,
    )
    from arrow_matrix_tpu_torch.utils.checkpoint import load_state, save_state

    a, levels = _RANK["small"]
    n, width, it, kmax = a.shape[0], 2048, SERVE["iterations"], \
        SERVE["max_batch_k"]
    out = {}
    # (d)'s reference on 4 ranks: the carriage the CLI's SellMultiLevel
    # a2a (its default on a mesh) checkpoints after its iterations,
    # from phase 20's executor over the loaded levels.
    sell = _RANK["exe"]
    c = sell.run(sell.set_features(random_dense(sell.n, 4, seed=42)),
                 STATE_ITERS)
    ref = coll.all_gather(c.contiguous(), sell.mesh, sell.axis)
    out["sell_ref"] = ref.cpu().numpy() if ctx.rank == 0 else None
    del sell, c, ref
    mesh4 = make_mesh((ctx.world,), ("blocks",))
    mesh2 = make_mesh((2,), ("blocks",), ranks=(0, 1))
    policy = faults.RetryPolicy(max_retries=2, backoff_s=0.01, jitter=0.2,
                                seed=SERVE["seed"])

    def rungs(mesh, fmt):
        built = {}

        def factory(cfg):
            key = str(cfg)
            if key not in built:
                built[key] = MultiLevelArrow(levels, width, mesh=mesh,
                                             fmt=fmt, routing="a2a")
            return built[key]
        return factory, built

    def digest(tickets):
        return {t.request.request_id: hashlib.sha256(
            t.result.tobytes()).hexdigest() for t in tickets}

    # Serving: the trace, rank 0 deciding the batches.
    tic = time.perf_counter()
    fac, built = rungs(mesh4, "ell")
    exe = fac(serve.ExecConfig())
    trace = serve.synthetic_trace(n, tenants=SERVE["tenants"],
                                  requests=SERVE["requests"], k=SERVE["k"],
                                  iterations=it, seed=SERVE["seed"])
    srv = serve.ArrowServer(fac, serve.ExecConfig(), policy=policy,
                            queue_capacity=SERVE["queue"], max_batch_k=kmax,
                            name="phase23b")
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    tickets = serve.run_trace(srv, trace)
    wall = time.perf_counter() - t0
    got = dict(zip(KERNEL_NAMES, counters()))
    want = {name: v * srv.batches * it
            for name, v in exe.launch_counts(kmax).items()}
    if [t.status for t in tickets] != ["completed"] * len(trace) \
            or got != want or len(built) != 1:
        raise SystemExit(f"phase 23 (b) rank {ctx.rank}: statuses "
                         f"{[t.status for t in tickets]}, launches {got} "
                         f"against {want}, rungs built {sorted(built)}")
    out["serve"] = {"digest": digest(tickets), "batches": srv.batches,
                    "wall_s": wall, "requests_per_s": len(trace) / wall,
                    "latency_ms": serve.latency_summary_ms(tickets),
                    "launches": got, "leader": srv.leader,
                    "seconds": time.perf_counter() - tic}
    # A request's admission price (with the a2a exchange scratch) beside
    # this rank's measured device-memory growth over one k=128 batch
    # step: recorded, not gated (a price below the peak is a fault of
    # the model, which follows the JAX package's).
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    y = exe.step(exe.set_features(random_dense(n, kmax, seed=3)))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del y
    out["price"] = {"request_bytes": request_bytes_for(exe, SERVE["k"]),
                    "request_k": SERVE["k"],
                    "batch_k": kmax,
                    "batch_price_bytes": exe.carriage_hbm_bytes(kmax),
                    "scratch_bytes": exe.exchange_scratch_bytes(kmax),
                    "measured_peak_bytes": peak}
    served = golden = None
    if ctx.rank == 0:
        # The host goldens in a thread beside the grow's collectives.
        from concurrent.futures import ThreadPoolExecutor

        served = {t.request.request_id: (t.request.x, t.result)
                  for t in tickets}
        ids = sorted(served)

        def goldens(xs):
            for _ in range(it):
                xs = host_golden(levels, xs, 2)
            return xs

        gold_pool = ThreadPoolExecutor(1)
        golden = gold_pool.submit(goldens, np.concatenate(
            [served[i][0] for i in ids], axis=1))
    del tickets, srv, built, exe

    # The grow: step-2 checkpoints of GATE's requests on ranks (0, 1).
    tic = time.perf_counter()
    root = os.path.join(keep, "state23")
    dirs = {name: os.path.join(root, name) for name in ("grow", "never")}
    if ctx.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
        for d in dirs.values():
            os.makedirs(d)
    coll.barrier()
    fac2, _ = rungs(mesh2, "auto")
    fac4, _ = rungs(mesh4, "auto")
    ex2, ex4 = fac2(serve.ExecConfig()), fac4(serve.ExecConfig())
    gate_trace = serve.synthetic_trace(n, tenants=SERVE["tenants"],
                                       requests=GATE["requests"],
                                       k=SERVE["k"],
                                       iterations=GATE["iterations"],
                                       seed=SERVE["seed"])
    for r in gate_trace:
        tag = f"serve/{r.request_id}/k{r.k}/it{r.iterations}"
        stem = f"ck_{r.request_id}"
        if mesh2.member:
            x = ex2.set_features(r.x)
            for _ in range(2):
                x = ex2.step(x)
            save_state(os.path.join(dirs["grow"], stem), x, 2, layout=tag,
                       mesh=mesh2)
        coll.barrier()
        # The never-grown server's state: the same carriage moved by hand
        # (through the original row order), not by a staged plan.
        full, _ = load_state(os.path.join(dirs["grow"], stem), layout=tag)
        orig = full.numpy()[ex2.inv_perm0][:n]
        save_state(os.path.join(dirs["never"], stem), ex4.set_features(orig),
                   2, layout=tag, mesh=mesh4)
    grown = serve.ArrowServer(fac2, serve.ExecConfig(), name="phase23grow",
                              checkpoint_dir=dirs["grow"], checkpoint_every=2,
                              grow_factory=fac4,
                              reshard_budget_bytes=STATE["reshard_budget"])
    if not grown.grow(reason="phase 23"):
        raise SystemExit(f"phase 23 (b) rank {ctx.rank}: grow refused")
    g_tickets = [grown.submit(r) for r in gate_trace]
    grown.drain()
    never = serve.ArrowServer(fac4, serve.ExecConfig(), name="phase23never",
                              checkpoint_dir=dirs["never"],
                              checkpoint_every=2)
    n_tickets = serve.run_trace(never, gate_trace)
    for ts in (g_tickets, n_tickets):
        if [t.resumed_step for t in ts] != [2] * len(gate_trace):
            raise SystemExit(f"phase 23 (b) rank {ctx.rank}: resumed at "
                             f"{[t.resumed_step for t in ts]}")
    if digest(g_tickets) != digest(n_tickets):
        raise SystemExit(f"phase 23 (b) rank {ctx.rank}: the grown "
                         f"server's results differ from the never-grown "
                         f"one's")
    # Layouts of equal stored rows (and row order) have nothing to
    # migrate: the checkpoint holds the same global carriage.
    stored = (ex2.reshard_layout().stored_rows,
              ex4.reshard_layout().stored_rows)
    out["grow"] = {"digest": digest(g_tickets), "migrated":
                   grown.checkpoints_resharded, "grows": grown.grows,
                   "stored_rows": stored,
                   "expect_migrated": (len(gate_trace)
                                       if stored[0] != stored[1] else 0),
                   "fmts2": ex2.fmts, "fmts4": ex4.fmts,
                   "member2": mesh2.member,
                   "seconds": time.perf_counter() - tic}
    del grown, never, ex2, ex4, g_tickets, n_tickets
    torch.cuda.empty_cache()
    if ctx.rank == 0:
        # Every served request against its host golden.
        tic = time.perf_counter()
        xs = golden.result()
        gold_pool.shutdown()
        tol = relative_tolerance(a.nnz / n, it)
        errs = [relative_error(served[i][1],
                               xs[:, j * SERVE["k"]:(j + 1) * SERVE["k"]])
                for j, i in enumerate(ids)]
        if not max(errs) <= tol:
            raise SystemExit(f"phase 23 (b): a served request's rel err "
                             f"{max(errs):.3e} > gate {tol:.1e}")
        out["serve"].update(max_err=max(errs), gate=tol,
                            golden_wait_s=time.perf_counter() - tic)
    return out


def sampled_peak_rss(fn, every_s: float = 0.002) -> tuple:
    """``(fn(), peak)``: the peak resident bytes of this process's own
    address space while ``fn`` runs, sampled from ``/proc/self/statm``
    every ``every_s`` by a thread.  ``ru_maxrss`` is no measure of a
    spawned process here: it starts at its parent's resident bytes, so a
    child of this script reads the script's own gigabytes."""
    page = os.sysconf("SC_PAGE_SIZE")
    peak, stop = [0], threading.Event()

    def sample():
        while not stop.is_set():
            with open("/proc/self/statm") as fh:
                peak[0] = max(peak[0], int(fh.read().split()[1]) * page)
            stop.wait(every_s)

    watcher = threading.Thread(target=sample, daemon=True)
    watcher.start()
    try:
        out = fn()
    finally:
        stop.set()
        watcher.join()
    return out, peak[0]


def state23_rss(base: str, width: int, memmap: bool, out: str) -> None:
    """Phase 23 (d)'s peak host RSS of one pack, in a process of its own:
    level 0 of phase 4's artifact as ELL stacks on the card, streamed
    from the memmapped artifact (``arrow_blocks_streamed`` on a mesh of
    one gloo rank) or packed from the artifact loaded whole
    (``arrow_blocks_from_csr``, as a run without ``--memmap`` loads it);
    the peak is :func:`sampled_peak_rss`'s over the load and the pack,
    the process's resident bytes before them beside it."""
    import tempfile

    import torch
    import torch.distributed as dist

    from arrow_matrix_tpu_torch.io import load_decomposition
    from arrow_matrix_tpu_torch.ops.arrow_blocks import (
        arrow_blocks_from_csr,
        arrow_blocks_streamed,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)        # the context, before the window
    mesh = None
    if memmap:
        store = dist.FileStore(tempfile.mktemp(prefix="rss23_"), 1)
        init_distributed(0, 1, "gloo", dev, store=store)
        mesh = make_mesh(device=dev)
    _, before = sampled_peak_rss(lambda: None)

    def pack():
        loaded = load_decomposition(base, width, mem_map=memmap)
        if memmap:
            blk = arrow_blocks_streamed(loaded[0][0], width, mesh, fmt="ell")
        else:
            blk = arrow_blocks_from_csr(loaded[0][0], width, fmt="ell",
                                        device=dev)
        torch.cuda.synchronize()
        return blk

    tic = time.perf_counter()
    blk, peak = sampled_peak_rss(pack)
    rec = {"memmap": memmap, "pack_s": time.perf_counter() - tic,
           "peak_rss_bytes": peak, "rss_before_bytes": before,
           "device_bytes": blk.device_nbytes()}
    if memmap:
        dist.destroy_process_group()
    with open(out, "w") as fh:
        json.dump(rec, fh)


JOIN23 = r"""
import sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from arrow_matrix_tpu_torch.fleet.worker import maybe_init_distributed
joined = maybe_init_distributed(verbose=True)
t = torch.ones(1, device="cuda")
dist.all_reduce(t)
print("JOINED", joined, dist.get_world_size(), dist.get_rank(),
      int(t.item()), flush=True)
dist.destroy_process_group()
"""


def start_state23(keep: str, base: str):
    """Phase 23's subprocesses (:func:`state23_subprocesses`) in a thread
    of their own, started once phase 4's artifact exists; the future."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    fut = pool.submit(state23_subprocesses, keep, base)
    pool.shutdown(wait=False)
    return fut


def state23_subprocesses(keep: str, base: str) -> dict:
    """Phase 23's subprocesses, which time no kernel, one after the other
    in a thread from phase 4 on (beside phase 19 alone they starved its
    race), each at niceness 19:
    (b) the port's reshard gate on gloo ranks on the card, (d) the two
    ``spmm_arrow --memmap`` runs over phase 4's artifact (1 and 4 ranks;
    their final carriages are returned), (c) ``spmm_arrow --devices 2``
    run twice over one checkpoint, (e) the two processes of
    ``plan_host_mesh(2, 1)``, then (d)'s two RSS packs; each one's gate
    and its seconds."""
    import socket
    import subprocess

    import numpy as np

    from arrow_matrix_tpu_torch.fleet.host import plan_host_mesh

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(keep, "state23_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("AMT_FAULT_PLAN", None)
    res = {}

    def start(name, argv, extra_env=None):
        fh = open(os.path.join(work, f"{name}.log"), "w")
        p = subprocess.Popen([sys.executable, *argv], cwd=work,
                             env=dict(env, **(extra_env or {})), stdout=fh,
                             stderr=subprocess.STDOUT,
                             preexec_fn=lambda: os.nice(19))
        return name, p, fh, time.perf_counter()

    def wait(started):
        name, p, fh, t0 = started
        try:
            rc = p.wait(timeout=STATE["timeout_s"])
        finally:
            fh.close()
        with open(os.path.join(work, f"{name}.log")) as f:
            text = f.read()
        if rc != 0:
            raise SystemExit(f"phase 23 {name} exited {rc}:\n"
                             f"{text[-3000:]}")
        return text, time.perf_counter() - t0

    def run(name, argv):
        return wait(start(name, argv))

    spmm = ["-m", "arrow_matrix_tpu_torch.cli.spmm_arrow"]
    text, t = run("reshard_gate", ["-m",
                                   "arrow_matrix_tpu_torch.tools.reshard_gate",
                                   os.path.join(work, "gate")])
    if "RESHARD GATE: OK" not in text:
        raise SystemExit(f"phase 23 (b) reshard gate:\n{text[-3000:]}")
    res["gate"] = {"seconds": t, "line": [ln for ln in text.splitlines()
                                         if "kill_mid_migration" in ln]}
    # (d): each final carriage is held to the same executor over the
    # loaded levels (phase_state).
    res["d"] = {}
    for devices in ("1", "4"):
        text, t = run(f"memmap{devices}",
                      spmm + ["--path", base, *STATE["memmap"], "--devices",
                              devices, "--backend", "gloo", "--checkpoint",
                              f"ck{devices}", "--memmap"])
        errs = [ln for ln in text.splitlines() if ln.startswith("iteration ")]
        if len(errs) != STATE_ITERS:
            raise SystemExit(f"phase 23 (d): --devices {devices}: {errs}")
        with np.load(os.path.join(work, f"ck{devices}.npz")) as z:
            x, step = np.array(z["x"]), int(z["step"])
        res["d"][devices] = {"errors": errs, "seconds": t, "x": x,
                             "step": step}
    resume = ["--devices", "2", "--backend", "gloo", "--fmt", "sell",
              "--carry", "--checkpoint", "ck", "--checkpoint_every", "1",
              "--validate", *STATE["cli"]]
    _, t1 = run("resume_first", spmm + resume + ["--iterations", "2"])
    text, t2 = run("resume_second", spmm + resume + ["--iterations", "4"])
    if "resumed from ck at iteration 2" not in text:
        raise SystemExit(f"phase 23 (c): the second run did not resume at "
                         f"iteration 2:\n{text[-3000:]}")
    res["c"] = {"seconds": [t1, t2],
                "errors": [ln for ln in text.splitlines()
                           if ln.startswith("iteration ")]}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    joins = [start(f"join{r}", ["-c", JOIN23.format(root=root)], plan)
             for r, plan in enumerate(plan_host_mesh(2, 1, port=port))]
    res["e"] = []
    for r, j in enumerate(joins):
        text_j, t_j = wait(j)
        if f"JOINED True 2 {r} 2" not in text_j or "over gloo" not in text_j:
            raise SystemExit(f"phase 23 (e): rank {r} printed {text_j}")
        res["e"].append(t_j)
    res["d"]["rss"] = {("memmap" if mm else "eager"): join_host(
        *start_host(state23_rss, base, 2048, mm), "phase 23 (d) rss")
        for mm in (True, False)}
    return res


def phase_state(a: dict, d: dict, b: list, built: dict, subs: dict,
                serve15=None, fold_ref=None) -> dict:
    """Phase 23's results (module docstring) gathered, checked across the
    ranks and logged: (a) and (d)'s streamed pack from the NCCL rank, (b)
    from the gloo ranks, the subprocesses' (b)-(e)."""
    b0 = b[0]
    for tag in ("serve", "grow"):
        digests = [r[tag]["digest"] for r in b]
        if any(dg != digests[0] for dg in digests):
            raise SystemExit(f"phase 23 (b) {tag}: the ranks' results "
                             f"differ")
    if [r["serve"]["leader"] for r in b] != [True] + [False] * (len(b) - 1) \
            or b0["grow"]["migrated"] != b0["grow"]["expect_migrated"] \
            or b0["grow"]["grows"] != 1:
        raise SystemExit(f"phase 23 (b): leaders "
                         f"{[r['serve']['leader'] for r in b]}, grows "
                         f"{b0['grow']['grows']}, migrated "
                         f"{b0['grow']['migrated']} (stored rows "
                         f"{b0['grow']['stored_rows']})")
    fold_ref = a["fold_ref"] if fold_ref is None else fold_ref
    for devices, ref in (("1", fold_ref), ("4", b0["sell_ref"])):
        run = subs["d"][devices]
        if run["step"] != STATE_ITERS or run["x"].dtype != ref.dtype \
                or run["x"].tobytes() != ref.tobytes():
            raise SystemExit(f"phase 23 (d): --devices {devices} --memmap "
                             f"ended at step {run['step']} in another "
                             f"carriage than the same executor built from "
                             f"the loaded levels")
        del run["x"]
    rss = subs["d"]["rss"]
    for rec in rss.values():
        rec["growth_bytes"] = rec["peak_rss_bytes"] - rec["rss_before_bytes"]
    ratio = rss["memmap"]["growth_bytes"] / max(rss["eager"]["growth_bytes"],
                                                1)
    lat = a["latency_ms"]
    log(f"phase 23 (a): {a['requests']} requests (phase 15's trace) over "
        f"MultiLevelArrow(mesh=1 NCCL rank, fmt='ell') (built "
        f"{built['build_s']:.1f} s beside the earlier phases; formats "
        f"{a['fmts']}, heads {a['heads']}) in {a['batches']} batches of "
        f"k={SERVE['max_batch_k']}: {a['requests_per_s']:.2f} req/s, p50 "
        f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms"
        + (f" (phase 15's fold: {serve15['requests_per_s']:.2f} req/s, p50 "
           f"{serve15['latency_ms']['p50']:.1f}, p99 "
           f"{serve15['latency_ms']['p99']:.1f} ms, batch device ms "
           f"{[round(v, 3) for v in serve15['batch_device_ms']]})"
           if serve15 else "")
        + f"; launches {a['launches']} (launch_counts x batches x "
        f"iterations); batch device ms "
        f"{[round(v, 3) for v in a['batch_device_ms']]}, host ms: "
        f"set_features {[round(v, 1) for v in a['set_features_ms']]}, "
        f"gather_result {[round(v, 1) for v in a['gather_result_ms']]}; "
        f"every batch's first request alone equals its slice; phase 4's "
        f"input after {SERVE['iterations']} steps "
        f"{a['phase4_input_err']:.3e} (gate {a['phase4_input_gate']:.1e})")
    sv, gr = b0["serve"], b0["grow"]
    log(f"phase 23 (b): the trace at 2^16 on {len(b)} gloo ranks sharing "
        f"the card, rank 0 deciding: {sv['batches']} batches, results "
        f"equal on every rank bit for bit, worst {sv['max_err']:.3e} "
        f"against the host golden (gate {sv['gate']:.1e}), "
        f"{sv['requests_per_s']:.2f} req/s (host transport); grow from "
        f"ranks (0, 1) ({gr['fmts2']}) to 4 ({gr['fmts4']}): "
        f"{gr['migrated']} step-2 checkpoints migrated (stored rows "
        f"{gr['stored_rows']}), every request "
        f"resumed at 2, results equal to the never-grown 4-rank server's "
        f"bit for bit ({gr['seconds']:.1f} s); the reshard gate: "
        f"{subs['gate']['line']} ({subs['gate']['seconds']:.1f} s)")
    for rank, r in enumerate(b):
        pr = r["price"]
        log(f"phase 23 (b) rank {rank}: a k={pr['request_k']} request's "
            f"admission price {pr['request_bytes']} B; a k={pr['batch_k']} "
            f"batch's {pr['batch_price_bytes']} B (of it the a2a exchange "
            f"scratch {pr['scratch_bytes']} B) against the rank's measured "
            f"growth of max_memory_allocated over one k={pr['batch_k']} "
            f"step {pr['measured_peak_bytes']} B"
            + ("" if pr["batch_price_bytes"] >= pr["measured_peak_bytes"]
               else " (the price is below the peak: a fault of the model)"))
    log(f"phase 23 (c): spmm_arrow --devices 2 --carry --checkpoint over 2 "
        f"then 4 iterations: resumed at 2, {subs['c']['errors']}")
    log(f"phase 23 (d): spmm_arrow --memmap over phase 4's artifact, its "
        f"final carriage equal bit for bit to the same executor's built "
        f"from the loaded levels (the fold on one rank, phase 20's "
        f"SellMultiLevel on 4): "
        f"{ {k: v for k, v in subs['d'].items() if k != 'rss'} }; the "
        f"streamed pack of level 0 equal to the eager one ({d['arrays']}, "
        f"{d['bytes']} B; {d['streamed_s']:.1f} / {d['eager_s']:.1f} s); "
        f"host RSS over level 0's load and pack, streamed from the "
        f"memmapped artifact: peak {rss['memmap']['peak_rss_bytes']} B, "
        f"{rss['memmap']['growth_bytes']} B above the process before it; "
        f"from the artifact loaded whole: {rss['eager']['peak_rss_bytes']} "
        f"B, {rss['eager']['growth_bytes']} B above (growth ratio "
        f"{ratio:.3f})")
    log(f"phase 23 (e): plan_host_mesh(2, 1)'s two processes joined one "
        f"gloo group on the card host ({subs['e']} s)")
    return {"a": {k: v for k, v in a.items()
                  if k not in ("entries", "fold_ref")},
            "a_built": built, "b": [{t: {k: v for k, v in r[t].items()
                                          if k != "digest"}
                                      for t in r if t != "sell_ref"}
                                     for r in b],
            "streamed": d, "subprocesses": subs, "rss_ratio": ratio}


# -- 24. the analysis family and the doctor -----------------------------------

#: Phase 24: its subprocesses in order, (name, argv after ``python -m``,
#: the line its output must hold).
ANALYSIS = (
    ("prove", ["arrow_matrix_tpu_torch.analysis", "prove", "--device",
               "cuda", "--check"], "proof passed"),
    ("audit", ["arrow_matrix_tpu_torch.analysis", "audit", "--device",
               "cuda", "--check"], "audit passed"),
    ("lint", ["arrow_matrix_tpu_torch.analysis", "lint"], None),
    ("sync", ["arrow_matrix_tpu_torch.analysis", "sync", "--check"],
     "sync proof passed"),
    ("doctor", ["arrow_matrix_tpu_torch.cli.doctor"], "core checks passed"),
)
#: Proved entries, skips, and entries whose launches are checked.
PROVE_ENTRIES, PROVE_SKIPS, PROVE_LAUNCH_CHECKS = 20, 4, 14
ANALYSIS_TIMEOUT_S = 900.0


#: Phase 24's second thread: the reference's last gates and CLIs, each
#: (name, argv after ``python -m``, the text its output must hold), run
#: in the thread's working directory (``{work}``).
GATES24 = (
    ("chaos", ["arrow_matrix_tpu_torch.tools.chaos_gate", "--fast",
               "--device", "cuda", "{work}/chaos"], "chaos gate: ok"),
    ("obs", ["arrow_matrix_tpu_torch.tools.obs_gate", "--device", "cuda",
             "{work}/obs"], "obs gate: ok"),
    ("kernel", ["arrow_matrix_tpu_torch.tools.kernel_gate", "--device",
                "cuda"], "kernel gate: ok (K1 at every certified"),
    ("comm", ["arrow_matrix_tpu_torch.tools.comm_report", "4096", "128",
              "16", "4", "--device", "cuda"], '"ideal_routing"'),
    ("spmm_logdir", ["arrow_matrix_tpu_torch.cli.spmm_arrow", "--device",
                     "cuda", "--vertices", "16384", "--width", "512",
                     "--features", "16", "--iterations", "3", "--validate",
                     "--logdir", "{work}/logs"], "log written to"),
    ("log_upload", ["arrow_matrix_tpu_torch.cli.log_upload", "-f",
                    "{work}/logs"], "1 run(s) handled"),
    ("lens", ["arrow_matrix_tpu_torch.cli.graft_lens", "profile", "--ba",
              "65536,2048,7", "--ba_m", "8", "--k", "128", "--dtypes", "f32",
              "--kernel", "pallas", "--ring-sweep", "--iters", "20",
              "--device", "cuda", "--out", "{work}/lens_profile.json"],
     '"sweep"'),
)


def start_analysis24(keep: str) -> tuple:
    """Phase 24's two lists of subprocesses (:data:`ANALYSIS` from the
    checkout's root, :data:`GATES24` from a working directory of its
    own), each in a thread of its own; their futures."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(2)
    futs = (pool.submit(analysis24_subprocesses, keep, ANALYSIS,
                        "analysis24", False),
            pool.submit(analysis24_subprocesses, keep, GATES24, "gates24",
                        True))
    pool.shutdown(wait=False)
    return futs


def analysis24_subprocesses(keep: str, cmds: tuple, tag: str,
                            in_work: bool) -> dict:
    """``cmds`` one after the other, each at niceness 19 (its ranks and
    probes inherit it), from ``keep/tag`` when ``in_work`` (``{work}`` in
    an argument names it) else from the checkout's root: each one's exit
    code, output and seconds."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(keep, tag)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("AMT_FAULT_PLAN", None)
    if in_work:
        # The card machine has wandb but no account: log_upload's runs
        # go through wandb with every call a no-op and nothing sent.
        env["WANDB_MODE"] = "disabled"
    res = {"started_s": time.perf_counter() - T0, "work": work}
    for name, argv, _ in cmds:
        log_path = os.path.join(work, f"{name}.log")
        tic = time.perf_counter()
        with open(log_path, "w") as fh:
            p = subprocess.Popen(
                [sys.executable, "-m", *(a.format(work=work) for a in argv)],
                cwd=work if in_work else root, env=env, stdout=fh,
                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))
            try:
                rc = p.wait(timeout=ANALYSIS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
        with open(log_path) as f:
            res[name] = {"rc": rc, "text": f.read(),
                         "seconds": time.perf_counter() - tic}
    res["ended_s"] = time.perf_counter() - T0
    return res


def phase_analysis(futs) -> dict:
    """Phase 24's results (module docstring) collected and gated; its
    seconds in the main process."""
    tic = time.perf_counter()
    subs, gates = (f.result(timeout=ANALYSIS_TIMEOUT_S * len(cmds)
                            + STATE["timeout_s"])
                   for f, cmds in zip(futs, (ANALYSIS, GATES24)))
    waited = time.perf_counter() - tic
    out = {"gates": {}}
    for done, cmds, into in ((subs, ANALYSIS, out),
                             (gates, GATES24, out["gates"])):
        for name, _, must in cmds:
            r = done[name]
            text = r["text"]
            if r["rc"] != 0 or (must is not None and must not in text):
                raise SystemExit(f"phase 24 {name} exited {r['rc']}:\n"
                                 f"{text[-4000:]}")
            into[name] = {"seconds": r["seconds"]}
    lines = subs["prove"]["text"].splitlines()
    ok = [ln for ln in lines if ln.startswith("[ok  ] ")]
    skips = [ln for ln in lines if ln.startswith("[skip] ")]
    passed = [ln for ln in ok if "| launches:pass" in ln]
    if (len(ok) != PROVE_ENTRIES or len(skips) != PROVE_SKIPS
            or len(passed) != PROVE_LAUNCH_CHECKS
            or any("launches:fail" in ln for ln in lines)):
        raise SystemExit(f"phase 24 (a): {len(ok)} entries ok, "
                         f"{len(skips)} skipped, {len(passed)} with their "
                         f"launches checked:\n" + "\n".join(lines[-40:]))
    out["prove"]["entries"] = [ln[len("[ok  ] "):].split(":")[0]
                               for ln in ok]
    audit_ok = [ln for ln in subs["audit"]["text"].splitlines()
                if ln.startswith("[ok  ] ")]
    if len(audit_ok) != 4:
        raise SystemExit("phase 24 (b): "
                         + subs["audit"]["text"][-3000:])
    doctor = subs["doctor"]["text"].splitlines()
    if not any(ln.startswith("[ok  ] card") for ln in doctor):
        raise SystemExit("phase 24 (d): the doctor did not see the card:\n"
                         + "\n".join(doctor[:20]))
    out["doctor"]["checks"] = [ln for ln in doctor if ln.startswith("[")]
    out["audit"]["lines"] = audit_ok
    out["subprocess_window_s"] = [subs["started_s"], subs["ended_s"]]
    out["gates_window_s"] = [gates["started_s"], gates["ended_s"]]
    logs = os.path.join(gates["work"], "logs")
    runs = sorted(f for f in os.listdir(logs) if f.endswith(".json"))
    if len(runs) != 1 or not os.path.exists(
            os.path.join(logs, runs[0][:-len(".json")] + ".logged")):
        raise SystemExit(f"phase 24 (e): log_upload did not take the "
                         f"spmm_arrow run: {sorted(os.listdir(logs))}")
    lens_doc = json.loads(gates["lens"]["text"].strip().splitlines()[-1])
    sweep = lens_doc.get("sweep") or {}
    if not sweep.get("bit_equal_tiers"):
        raise SystemExit(f"phase 24 (e): graft_lens profile --kernel pallas "
                         f"--ring-sweep: {lens_doc}")
    out["gates"]["lens"]["summary"] = lens_doc
    out["main_s"] = time.perf_counter() - tic
    log(f"phase 24: prove {out['prove']['seconds']:.1f} s ({len(ok)} "
        f"entries ok, {len(skips)} skipped, {len(passed)} with each rank's "
        f"launches equal to launch_counts), audit "
        f"{out['audit']['seconds']:.1f} s, lint "
        f"{out['lint']['seconds']:.1f} s, sync {out['sync']['seconds']:.1f}"
        f" s, doctor {out['doctor']['seconds']:.1f} s, as subprocesses from "
        f"{subs['started_s']:.1f} s to {subs['ended_s']:.1f} s of the run; "
        f"{out['main_s']:.1f} s of the main process (waited {waited:.1f} s)")
    for ln in out["doctor"]["checks"]:
        print(f"    doctor {ln[:160]}")
    secs = ", ".join(f"{name} {r['seconds']:.1f} s"
                     for name, r in out["gates"].items())
    log(f"phase 24 (e): the reference's last gates and CLIs on the card "
        f"({secs}), each exit 0, as subprocesses from {gates['started_s']:.1f} s "
        f"to {gates['ended_s']:.1f} s of the run; graft_lens's sweep "
        f"{sweep}, full {lens_doc['dtypes']}")
    return out


# -- 25. the planar class --------------------------------------------------------

#: Phase 25: ``tools/planar_bench.py``'s cell, the scrambled 2-D grid (the
#: planar class the paper's bound is proved for) at side 1024, n = 2^20
#: (the JAX default side is 4096: cut for the script's time limit); its
#: inputs are ``(k, seed)``.
PLANAR = dict(side=1024, width=1280, max_levels=10, scramble_seed=3,
              seed=7, steps=10, inputs=((16, 5), (128, 6)), hyb_k=16)


def planar_base(keep: str) -> str:
    """Phase 25's artifact base under ``keep``."""
    return os.path.join(keep, f"grid_{PLANAR['side']}")


def planar_golden_path(keep: str, k: int, s: int) -> str:
    """The file of ``A^s x`` for phase 25's k-wide input."""
    return f"{planar_base(keep)}_gold_k{k}_s{s}.npy"


def planar_host(keep: str, out: str) -> None:
    """Phase 25's host work in a process of its own: ``grid_graph(side)``
    scrambled by ``default_rng(3).permutation`` (as
    ``tools/planar_bench.py`` builds it), decomposed by the numpy
    decomposer at width ``side * 5 / 4`` and saved as an artifact, the
    scrambled graph saved beside it, and the host goldens of the inputs
    over the graph itself (``A^s x``, every step, on half the cores),
    each saved as :func:`planar_golden_path`; its seconds in ``out``."""
    import numpy as np
    from scipy import sparse

    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import save_decomposition
    from arrow_matrix_tpu_torch.utils import grid_graph, random_dense

    c = PLANAR
    base = planar_base(keep)
    tic = time.perf_counter()
    shuf = np.random.default_rng(c["scramble_seed"]).permutation(
        c["side"] ** 2)
    a = grid_graph(c["side"])[shuf][:, shuf].tocsr()
    t_gen = time.perf_counter() - tic
    tic = time.perf_counter()
    levels = arrow_decomposition(a, c["width"], max_levels=c["max_levels"],
                                 block_diagonal=True, seed=c["seed"])
    t_dec = time.perf_counter() - tic
    save_decomposition(levels, base, block_diagonal=True)
    sparse.save_npz(base + "_graph.npz", a, compressed=False)
    tic = time.perf_counter()
    cores = max(1, (os.cpu_count() or 2) // 2)
    for k, xseed in c["inputs"]:
        g = random_dense(a.shape[0], k, seed=xseed)
        for s in range(c["steps"]):
            g = host_golden(a, g, cores)
            np.save(planar_golden_path(keep, k, s + 1), g)
    with open(out, "w") as fh:
        json.dump({"t_gen": t_gen, "t_dec": t_dec,
                   "t_gold": time.perf_counter() - tic}, fh)


def counted(launches: dict, key: tuple, fn, iters: int, sell):
    """``fn()``, its K1 launches added to ``launches[key]``; fatal unless
    they are ``k1_per_product`` of ``sell`` at ``key``'s (carriage, k)
    times ``iters`` products."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell

    per = k1_per_product(sell, key[2], CARRIAGE_DTYPES[key[1]])
    before = cuda_sell.LAUNCHES
    out = fn()
    torch.cuda.synchronize()
    delta = cuda_sell.LAUNCHES - before
    if delta != per * iters:
        raise SystemExit(f"{key}: {delta} launches, expected {per} per "
                         f"product x {iters} products")
    launches[key] = launches.get(key, 0) + delta
    return out


def planar_transposes(dev, level, row_nnz: float) -> dict:
    """Phase 25's feature-major products on the card: ``hyb_spmm_t`` over
    the planar level's HYB form and ``ell_spmm_t`` over its light ELL,
    each one K1 product of the launches K1's contract gives it, against
    its plain version on the same card tensors, repeated bit for bit."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_ell, cuda_sell
    from arrow_matrix_tpu_torch.ops.ell import ell_spmm_t, ell_tier_spmm
    from arrow_matrix_tpu_torch.ops.hyb import (
        hyb_from_csr,
        hyb_spmm,
        hyb_spmm_t,
    )
    from arrow_matrix_tpu_torch.utils import random_dense

    k = PLANAR["hyb_k"]
    hyb = hyb_from_csr(level.matrix, device=dev)
    x_t = torch.from_numpy(random_dense(k, hyb.n_rows, seed=8)).to(dev)
    light = (hyb.light_cols, hyb.light_data, hyb.light_deg)
    ops = cuda_ell.hyb_operands(hyb)
    runs = {
        "hyb_spmm_t": (lambda: hyb_spmm_t(hyb, x_t),
                       lambda: hyb_spmm(hyb, x_t.T.contiguous()).T,
                       [ops[p] for p in ("light", "heavy") if p in ops]),
        "ell_spmm_t": (lambda: ell_spmm_t(light[0], x_t, data=light[1],
                                          deg=light[2]),
                       lambda: ell_tier_spmm(light[0], x_t.T.contiguous(),
                                             data=light[1],
                                             deg=light[2]).T,
                       [cuda_ell.one_tier(*light, x_rows=hyb.n_rows)])}
    out = {"heavy_rows": int(hyb.heavy_idx.shape[0])}
    for name, (fn, plain, k1_ops) in runs.items():
        per = sum(k1_per_product(op, k, torch.float32) for op in k1_ops)
        before = cuda_sell.LAUNCHES
        got, again = fn(), fn()
        torch.cuda.synchronize()
        if cuda_sell.LAUNCHES - before != 2 * per:
            raise SystemExit(f"phase 25 {name}: "
                             f"{cuda_sell.LAUNCHES - before} K1 launches "
                             f"for two products, expected {2 * per}")
        err, ok = compare(got, plain(), row_nnz, exact=False)
        if not ok or not torch.equal(got, again):
            raise SystemExit(f"phase 25 {name}: K1 != plain (max abs err "
                             f"{err:.3e}) or a repeat differs")
        out[name] = {"max_abs_err": err, "launches": 2 * per}
    return out


def phase_planar(dev, host25, keep: str) -> tuple:
    """Phase 25 (module docstring): (its results, its kernels entries)."""
    import numpy as np
    import torch
    from scipy import sparse

    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import random_dense, relative_tolerance

    c = PLANAR
    tic = time.perf_counter()
    rec = join_host(*host25, "phase 25")
    waited = time.perf_counter() - tic
    base = planar_base(keep)
    levels = as_levels_of(base, c["width"])
    a = sparse.load_npz(base + "_graph.npz").tocsr()
    n = a.shape[0]
    if len(levels) != 1:
        raise SystemExit(f"phase 25: the scrambled grid decomposed into "
                         f"{len(levels)} levels; the RCM fast path makes "
                         f"one")
    nnz = int(levels[0].matrix.nnz)
    if nnz != a.nnz:
        raise SystemExit(f"phase 25: the level holds {nnz} of {a.nnz} "
                         f"nonzeros")
    row_nnz = nnz / n
    log(f"phase 25: grid {c['side']} x {c['side']} scrambled (n={n}, {nnz} "
        f"nnz), one level of width {levels[0].arrow_width} (the RCM fast "
        f"path); generate {rec['t_gen']:.1f} s, decompose "
        f"{rec['t_dec']:.1f} s, the host goldens {rec['t_gold']:.1f} s, in "
        f"a process of its own (waited {waited:.1f} s)")
    res = {"n": n, "nnz": nnz, "levels": len(levels),
           "arrow_width": int(levels[0].arrow_width),
           "host_generate_s": rec["t_gen"], "host_decompose_s": rec["t_dec"]}
    exes = {}
    for name, kw in (("planar_fold", {}),
                     ("planar_fold_tight", dict(fold_growth=1.1,
                                                fold_align=1))):
        tic = time.perf_counter()
        exe = exes[name] = MultiLevelArrow(levels, c["width"], fmt="fold",
                                           device=dev, **kw)
        res[f"{name}_ladder"] = ladder(exe.sell)
        log(f"phase 25 {name}: {len(exe.sell.cols)} tiers "
            f"({len(exe.sell.live_tiers())} live), {exe.sell.n_slots} "
            f"slots / {exe.nnz} nnz ({exe.sell.n_slots / exe.nnz:.3f}x), "
            f"built in {time.perf_counter() - tic:.1f} s; ladder (m_t, n_t): "
            f"{ladder(exe.sell)}")

    # The main path, the counts set to 0 just before it.
    torch.cuda.synchronize()
    reset_counters()
    launches = {}
    tol1 = relative_tolerance(row_nnz, 1)
    tol_chain = relative_tolerance(row_nnz, c["steps"])
    maps = {name: (torch.from_numpy(e.perm0).long().to(dev),
                   torch.from_numpy(e.inv_perm0[:n]).long().to(dev))
            for name, e in exes.items()}
    for k, xseed in c["inputs"]:
        tic = time.perf_counter()
        x0 = random_dense(n, k, seed=xseed)
        g, worst = x0, dict.fromkeys(exes, 0.0)
        # Every step from the golden input (permuted on the card, as
        # set_features does on the host), against the next golden.
        for s in range(c["steps"]):
            path = planar_golden_path(keep, k, s + 1)
            g_next = np.load(path)
            os.remove(path)
            gd, want = (torch.from_numpy(v).to(dev) for v in (g, g_next))
            for name, exe in exes.items():
                perm, inv = maps[name]
                xin = gd.new_zeros((exe.total_rows, k))
                xin[:n] = gd
                y = counted(launches, (name, "f32", k),
                            lambda: exe.step(xin[perm]), 1, exe.sell)
                err = device_relative_error(y[inv], want)
                worst[name] = max(worst[name], err)
                if not err <= tol1:
                    raise SystemExit(f"phase 25 {name} k={k} step {s}: rel "
                                     f"err {err:.3e} > gate {tol1:.1e}")
            g = g_next
        del gd, want, xin, y
        chain = {}
        x0d, gd = (torch.from_numpy(v).to(dev) for v in (x0, g))
        for name, exe in exes.items():
            perm, inv = maps[name]
            x = x0d.new_zeros((exe.total_rows, k))
            x[:n] = x0d
            x = x[perm]
            y = counted(launches, (name, "f32", k),
                        lambda: exe.run(x, c["steps"]), c["steps"], exe.sell)
            chain[name] = device_relative_error(y[inv], gd)
            if not chain[name] <= tol_chain:
                raise SystemExit(f"phase 25 {name} k={k} {c['steps']}-step "
                                 f"chain: rel err {chain[name]:.3e} > gate "
                                 f"{tol_chain:.1e}")
        res[f"k{k}"] = {"worst_step": worst, "chain": chain,
                        "seconds": time.perf_counter() - tic}
        log(f"phase 25 f32 k={k}: every step of both packings within "
            f"{tol1:.1e} (worst {max(worst.values()):.3e}); "
            f"{c['steps']}-step chains {chain} (gate {tol_chain:.1e}); "
            f"{time.perf_counter() - tic:.1f} s")
    del x, y, x0d, gd
    res["transposes"] = planar_transposes(dev, levels[0], row_nnz)
    total = cuda_sell.LAUNCHES
    want_total = sum(launches.values()) + sum(
        v["launches"] for v in res["transposes"].values()
        if isinstance(v, dict))
    if total != want_total:
        raise SystemExit(f"phase 25: K1.LAUNCHES = {total}, its parts "
                         f"{want_total}")
    if (cuda_blocks.LAUNCHES_K2 or cuda_blocks.LAUNCHES_K3
            or cuda_gather.LAUNCHES or cuda_gather.LAUNCHES_ADD):
        raise SystemExit("phase 25: the fold launched a dense-block or a "
                         "gather kernel")
    log(f"phase 25 main path: K1.LAUNCHES = {total} "
        f"({', '.join(f'{k}: {v}' for k, v in launches.items())}); "
        f"hyb_spmm_t and ell_spmm_t on the card {res['transposes']}")
    res["launches"] = {",".join(map(str, key)): v
                       for key, v in launches.items()}
    kernels = phase_k1_numbers(exes, launches, n, row_nnz, res,
                               phase="phase 25")
    del exes, maps
    torch.cuda.empty_cache()
    return res, kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=20,
                        help="log2 of the fold path's vertex count (20); "
                             "the dense path takes min(16, log2n)")
    parser.add_argument("--dense", action="store_true",
                        help="run phases 1, 2 and 6-8 only (the dense path)")
    parser.add_argument("--bench", action="store_true",
                        help="run phases 1, 2 and 14 only (the native "
                             "decomposer and the port's bench)")
    parser.add_argument("--fleet", action="store_true",
                        help="run phases 1, 2 and 17 only (the fleet of "
                             "worker processes on the card)")
    parser.add_argument("--lens", action="store_true",
                        help="run phases 1, 2 and 18 only (the lens, the "
                             "probe and the ledger, on phase 4's "
                             "decomposition, made here)")
    parser.add_argument("--tune", action="store_true",
                        help="run phases 1, 2 and 19 only (graft-tune on "
                             "phase 4's decomposition, made here)")
    parser.add_argument("--mesh", action="store_true",
                        help="run phases 1, 2 and 20-23 only (the mesh "
                             "executors on ranks, training through them "
                             "and the space-shared modes, the two "
                             "baselines and the smoke, serving and state "
                             "on a mesh; phase 4's decomposition and "
                             "goldens made here)")
    parser.add_argument("--state", action="store_true",
                        help="run phases 1, 2 and 23 only (serving and "
                             "state on a mesh of ranks; phase 4's "
                             "decomposition and goldens made here)")
    parser.add_argument("--analysis", action="store_true",
                        help="run phases 1, 2 and 24 only (the analysis "
                             "family and the doctor on the card)")
    parser.add_argument("--planar", action="store_true",
                        help="run phases 1, 2 and 25 only (the planar "
                             "class: a scrambled 2-D grid, one level, "
                             "through the fold)")
    parser.add_argument("--serve", action="store_true",
                        help="run phases 1, 2, 15 and 16 only (the serving "
                             "runtime and its observability, on phase 4's "
                             "decomposition and its k=16 golden, computed "
                             "here)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from arrow_matrix_tpu_torch.io import (
        as_levels,
        load_decomposition,
        load_level_widths,
    )
    from arrow_matrix_tpu_torch.ops import (
        _build,
        cuda_blocks,
        cuda_gather,
        cuda_sell,
    )
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import (
        card_report,
        random_dense,
        relative_error,
        relative_tolerance,
    )
    from arrow_matrix_tpu_torch.utils.timing import cuda_runs

    dev = torch.device("cuda", 0)
    CARRIAGE_DTYPES.update(f32=torch.float32, bf16=torch.bfloat16,
                           int8=torch.int8)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card -------------------------------------------------------------
    smi = card_report(dev)
    print(smi, flush=True)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "arrow_matrix_tpu_torch", "_build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # Phase 4's artifact, phase 17's graph and phase 18's run-local
    # ledger, which phases 6-8 (they empty ``work``) must not remove.
    keep = work + "_lens"
    shutil.rmtree(keep, ignore_errors=True)
    os.makedirs(keep)
    store = os.path.join(keep, "ledger")
    full = not (args.dense or args.bench or args.fleet or args.lens
                or args.tune or args.mesh or args.serve or args.state
                or args.analysis or args.planar)
    fleet_cache = os.path.join(keep, "fleet_cache")
    if full:
        # Phase 4's host work (the graph, its numpy decomposition saved as
        # an artifact, the host goldens) and phase 14's (the native
        # decomposition) run in processes of their own from here, beside
        # the build and phases 3, 6-9, 12 and 14, which do not need them;
        # and, at the lowest priority (their readers come much later),
        # that of phase 22 (its graph and goldens), phase 13 (its host
        # goldens, over phase 4's graph once it is made), phase 25 (the
        # planar graph and its goldens) and phase 17 (the fleet's graph).
        n, m, width, seed = 1 << args.log2n, 8, 2048, 7
        base = os.path.join(keep, f"ba_{n}_{m}")
        host4 = start_host(phase4_host, n, base)
        host14 = start_host(phase14_host, n)
        host22 = start_host(phase22_host, keep, nice=19)
        host13 = start_host(models_host, base, n, nice=19)
        host25 = start_host(planar_host, keep, nice=19)
        host17 = start_host(fleet_host, fleet_cache, nice=19)
        # Phase 20's ranks start packing on the host as soon as phase 4's
        # artifact is saved, beside phase 14's bench.
        early4 = {}
        watch4 = threading.Thread(target=after_host, daemon=True,
                                  args=(host4, "phase 4", early4,
                                        lambda: start_mesh(base, width)))
        watch4.start()

    # -- 2. build ------------------------------------------------------------
    tic = time.perf_counter()
    paths = _build.build_all()
    log(f"phase 2: built {sorted(paths)} in "
        f"{time.perf_counter() - tic:.1f} s")
    for name, rec in _build.BUILD_LOG.items():
        log(f"  {name}: nvcc {rec['seconds']:.1f} s")
        for line in demangle(rec["ptxas"]).splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print(f"    ptxas {name}: {line.strip()}")

    n_dense = 1 << min(16, args.log2n)
    if args.dense:
        dense, kernels = dense_phases(dev, n_dense, work)
        return finish({"dense": dense, "card": smi}, kernels)
    if args.bench:
        bench = phase_bench(dev, 1 << args.log2n,
                            start_host(phase14_host, 1 << args.log2n), None,
                            ledger_dir=store)
        return finish({"bench": bench, "card": smi}, [])
    if args.fleet:
        fleet, replay = phase_fleet(dev, work,
                                    start_host(fleet_host, fleet_cache),
                                    fleet_cache)
        return finish({"fleet": fleet, "card": smi},
                      [fleet_k1_entry(replay, fleet["k1_launches"])])
    if args.lens:
        base, _ = decompose_phase4(1 << args.log2n, keep)
        lens_res, entries = phase_lens(dev, base, 2048, store,
                                       os.path.join(keep, "run"), {})
        return finish({"lens": lens_res, "card": smi}, entries)
    if args.tune:
        base, _ = decompose_phase4(1 << args.log2n, keep)
        tune_res, entries = phase_tune(dev, base, 2048,
                                       os.path.join(keep, "tune"))
        return finish({"tune": tune_res, "card": smi}, entries)
    if args.mesh:
        mesh_res, entries = mesh_only(1 << args.log2n, keep)
        return finish({"mesh": mesh_res, "card": smi}, entries)
    if args.state:
        state_res, entries = state_only(1 << args.log2n, keep)
        return finish({"state": state_res, "card": smi}, entries)
    if args.analysis:
        return finish({"analysis": phase_analysis(start_analysis24(keep)),
                       "card": smi}, [])
    if args.planar:
        planar, entries = phase_planar(dev, start_host(planar_host, keep),
                                       keep)
        return finish({"planar": planar, "card": smi}, entries)
    if args.serve:
        serve_res, entry, ctx = serve_only(dev, 1 << args.log2n, work)
        observe, observe_entry = phase_observe(ctx, serve_res,
                                               1 << args.log2n, work, dev)
        return finish({"serve": serve_res, "observe": observe, "card": smi},
                      [entry, observe_entry])

    # -- 3. kernel vs plain on random tiers ------------------------------------
    phase_random_tiers(dev)

    # -- 6-8. the dense path ---------------------------------------------------
    results = {}
    results["dense"], kernels = dense_phases(dev, n_dense, work)
    os.makedirs(work, exist_ok=True)      # phases 6-8 removed it

    # -- 9. K4 against its plain versions --------------------------------------
    k4_err = phase_k4_kernel(dev)

    # -- 12. the ELL head layouts at the kernel-comparison shape -------------
    results["heads"] = phase_heads(dev, n_dense)

    # -- 14. the native decomposer and the port's bench ----------------------
    # torch.optim's first step (phase 13) imports torch._dynamo, seconds
    # of host work: here, while the bench runs in a process of its own.
    dynamo = threading.Thread(target=importlib.import_module,
                              args=("torch._dynamo",), daemon=True)
    dynamo.start()
    results["bench"] = phase_bench(dev, n, host14, None, ledger_dir=store)
    dynamo.join()

    # -- 4. main path ----------------------------------------------------------
    tic = time.perf_counter()
    watch4.join()
    if "error" in early4:
        raise early4["error"]
    rec, mesh_pool = early4["rec"], early4["then"]
    subs23 = start_state23(keep, base)
    subs24 = start_analysis24(keep)
    t_gen, t_dec = rec["t_gen"], rec["t_dec"]
    loaded = load_decomposition(base, width, block_diagonal=True)
    levels = as_levels(loaded, load_level_widths(base, width, True))
    nnz = sum(int(lvl.matrix.nnz) for lvl in levels)
    log(f"phase 4: BA n={n} m={m}: {nnz} nnz; generate {t_gen:.1f} s, "
        f"decompose {t_dec:.1f} s ({len(levels)} levels, width {width}), "
        f"the host goldens over A beside it {rec['t_gold']:.1f} s, in a "
        f"process beside the build and "
        f"phases 3, 6-9, 12 and 14 (waited {time.perf_counter() - tic:.1f} "
        f"s); artifact saved and loaded")

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    launches = {}

    def count(key, fn, iters, sell):
        return counted(launches, key, fn, iters, sell)

    tic = time.perf_counter()
    ml = MultiLevelArrow(levels, width, fmt="fold", device=dev)
    t_fold = time.perf_counter() - tic
    live = len(ml.sell.live_tiers())
    log(f"fold: {len(ml.sell.cols)} tiers ({live} live), "
        f"{ml.sell.n_slots} slots / {ml.nnz} nnz, operator "
        f"{ml.sell.device_nbytes()} B on the card; fold {t_fold:.1f} s; "
        f"ladder (m_t, n_t): {ladder(ml.sell)}")
    row_nnz = ml.nnz / n
    tol1 = relative_tolerance(row_nnz, 1)
    results["main"] = {}
    iters = 10
    # The host goldens, ``gold[(k, s)]`` = A^s x, shared by every later
    # check of these inputs (phases 4 and 11).
    gold = {}
    for k, xseed in GOLDEN_INPUTS:
        key = ("fold", "f32", k)
        ml.feature_dtype = torch.float32
        g = gold[(k, 0)] = random_dense(n, k, seed=xseed)
        x = ml.set_features(g)
        worst = 0.0
        for it in range(VALIDATED[k]):
            y = count(key, lambda: ml.step(ml.set_features(g)), 1, ml.sell)
            g_next = gold[(k, it + 1)] = np.load(golden_path(base, k, it + 1))
            err = card_relative_error(ml.gather_result(y), g_next)
            worst = max(worst, err)
            if not err <= tol1:
                raise SystemExit(f"k={k} step {it}: rel err {err:.3e} > "
                                 f"gate {tol1:.1e}")
            g = g_next
        steps = VALIDATED[k]
        y = count(key, lambda: ml.run(x, steps), steps, ml.sell)
        err10 = card_relative_error(ml.gather_result(y), g)
        tol10 = relative_tolerance(row_nnz, steps)
        if not err10 <= tol10:
            raise SystemExit(f"k={k} {steps}-step chain: rel err "
                             f"{err10:.3e} > gate {tol10:.1e}")
        runs = [t / iters for t in count(
            key, lambda: cuda_runs(lambda: ml.run(x, iters), REPS),
            (1 + REPS) * iters, ml.sell)]
        ms = statistics.median(runs)
        results["main"][f"f32_k{k}_ms_per_iter"] = ms
        results["main"][f"f32_k{k}_ms_per_iter_runs"] = runs
        log(f"f32 k={k}: every step within {tol1:.1e} (worst "
            f"{worst:.3e}); {steps}-step chain {err10:.3e} (gate "
            f"{tol10:.1e}); {ms:.4f} ms/iter, median of {REPS} chains (min "
            f"{min(runs):.4f}, max {max(runs):.4f})")

    int8_pool, int8_checks = ThreadPoolExecutor(1), []
    for k in (16, 128):
        g, want = gold[(k, 0)], gold[(k, 1)]
        ml.feature_dtype = torch.bfloat16
        y = count(("fold", "bf16", k),
                  lambda: ml.step(ml.set_features(g)), 1, ml.sell)
        err = card_relative_error(ml.gather_result(y), want)
        if not err <= max(tol1, 2e-2):
            raise SystemExit(f"bf16 k={k}: rel err {err:.3e} > 2e-2")
        log(f"bf16 k={k}: rel err {err:.3e} (gate 2e-2)")
        ml.feature_dtype = torch.int8
        xq = ml.set_features(g)
        q, scale = count(("fold", "int8", k), lambda: ml.step(xq), 1,
                             ml.sell)
        # Its float64 host golden in a thread beside phases 5 and 11.
        int8_checks.append(int8_pool.submit(
            int8_check, levels, ml.gather_result(xq),
            ml.gather_result((q, scale)), scale.cpu().numpy(), k))

    tic = time.perf_counter()
    tight = MultiLevelArrow(levels, width, fmt="fold", fold_growth=1.1,
                            fold_align=1, device=dev)
    t_tight = time.perf_counter() - tic
    live_tight = len(tight.sell.live_tiers())
    x = tight.set_features(gold[(16, 0)])
    y = count(("fold_tight", "f32", 16), lambda: tight.run(x, 3), 3,
              tight.sell)
    err = relative_error(tight.gather_result(y), gold[(16, 3)])
    if not err <= relative_tolerance(row_nnz, 3):
        raise SystemExit(f"fold_tight 3-step chain: rel err {err:.3e}")
    runs = [t / 3 for t in count(
        ("fold_tight", "f32", 16),
        lambda: cuda_runs(lambda: tight.run(x, 3), REPS),
        (1 + REPS) * 3, tight.sell)]
    ms_tight = statistics.median(runs)
    results["main"]["fold_tight_f32_k16_ms_per_iter"] = ms_tight
    results["main"]["fold_tight_f32_k16_ms_per_iter_runs"] = runs
    log(f"fold_tight: {len(tight.sell.cols)} tiers ({live_tight} live), "
        f"{tight.sell.n_slots} slots; 3-step chain {err:.3e}; "
        f"{ms_tight:.4f} ms/iter, median of {REPS} chains (min "
        f"{min(runs):.4f}, max {max(runs):.4f}); fold {t_tight:.1f} s; "
        f"ladder (m_t, n_t): {ladder(tight.sell)}")
    total = cuda_sell.LAUNCHES
    if total != sum(launches.values()):
        raise SystemExit("launch count disagrees with its parts")
    if (cuda_blocks.LAUNCHES_K2 or cuda_blocks.LAUNCHES_K3
            or cuda_gather.LAUNCHES or cuda_gather.LAUNCHES_ADD):
        raise SystemExit("the fold path launched a dense-block or a "
                         "gather kernel")
    log(f"main path: K1.LAUNCHES = {total} "
        f"({', '.join(f'{k}: {v}' for k, v in launches.items())}); peak "
        f"device memory {torch.cuda.max_memory_allocated()} B")
    results["main"].update(
        n=n, nnz=ml.nnz, tiers=len(ml.sell.cols), live_tiers=live,
        ladder=ladder(ml.sell), ladder_tight=ladder(tight.sell),
        host_generate_s=t_gen, host_decompose_s=t_dec, host_fold_s=t_fold,
        peak_device_bytes=int(torch.cuda.max_memory_allocated()))
    # Phase 23 (d)'s reference on one rank, after the main path's count.
    ml.feature_dtype = torch.float32
    fold_ref23 = state23_fold_ref(ml)

    # -- 5. per-kernel numbers at the main path's shapes -----------------------
    regs = ptxas_registers(_build.BUILD_LOG.get("sell_tier_spmm", {}).get(
        "ptxas", ""))
    for entry, used, spill in regs:
        log(f"phase 5 K1 ptxas: {used} registers, {spill} B spilled: "
            f"{entry}")
    results["main"]["k1_registers"] = regs
    kernels += phase_k1_numbers({"fold": ml, "fold_tight": tight}, launches,
                                n, row_nnz, results["main"])
    del tight
    torch.cuda.empty_cache()

    # -- 25. the planar class, its graph made beside the earlier phases ------
    results["planar"], planar_kernels = phase_planar(dev, host25, keep)
    kernels += planar_kernels

    # -- 11. the other formats at full size, on phase 4's decomposition ------
    results["formats"], format_kernels = phase_formats(dev, levels, n, width,
                                                       gold)
    kernels += format_kernels
    for check in int8_checks:             # phase 4's int8 steps
        log(check.result())
    int8_pool.shutdown()

    # -- 13. the models at full size, on phase 4's decomposition -------------
    results["models"], model_kernels, solvers = phase_models(
        dev, levels, n, width, ml, host13, base)
    kernels += model_kernels

    # -- 15. the serving runtime, on phase 4's decomposition -----------------
    results["serve"], serve_entry, ctx = phase_serve(
        dev, levels, n, width, row_nnz, gold[(16, 0)], gold[(16, 10)], work)
    kernels.append(serve_entry)

    # -- 16. observed serving, on phase 15's factory and trace ---------------
    ctx["phase4_ms"] = results["main"]["f32_k16_ms_per_iter"]
    results["observe"], observe_entry = phase_observe(ctx, results["serve"],
                                                      n, work, dev)
    kernels.append(observe_entry)
    del ctx
    del levels, loaded, gold      # phase 10 steps ml again
    torch.cuda.empty_cache()

    # -- 10. the gather probes on phase 4's fold -----------------------------
    results["probes"], k4_entry = phase_probes(dev, ml, k4_err)
    kernels.append(k4_entry)
    del ml
    torch.cuda.empty_cache()

    # -- 18. the lens, the probe and the ledger, on phase 4's levels ---------
    results["lens"], lens_entries = phase_lens(
        dev, base, width, store, os.path.join(keep, "run"), results["main"])
    kernels += lens_entries

    # -- 19. graft-tune on the card, on phase 4's levels ---------------------
    # Beside it, the ranks' work of phases 20-22 that times no kernel.
    mesh_work = start_mesh_work(mesh_pool, base, width, host22, solvers,
                                subs23, fold_ref_on_rank=False)
    del solvers
    results["tune"], tune_entries = phase_tune(dev, base, width,
                                               os.path.join(keep, "tune"))
    kernels += tune_entries

    # -- 17. the fleet of worker processes on the card, while the ranks
    # finish their work of phases 20-23 (its K1 is timed after them) ------
    results["fleet"], replay17 = phase_fleet(dev, work, host17, fleet_cache)

    # -- 20. the mesh executors on ranks sharing the card and over NCCL ------
    results["mesh"], mesh_entries = phase_mesh(
        mesh_work,
        results["models"].get("gcn_carried fold", {}).get("step_ms"),
        results["serve"], fold_ref23)
    kernels += mesh_entries

    # -- 17. K1 at the fleet's shape, the card otherwise idle ----------------
    kernels.append(fleet_k1_entry(replay17, results["fleet"]["k1_launches"]))
    del replay17
    torch.cuda.empty_cache()

    # -- 24. the analysis family and the doctor, run from phase 4 on ---------
    results["analysis"] = phase_analysis(subs24)

    results["card"] = smi
    return finish(results, kernels)


def mesh_only(n: int, keep: str) -> tuple:
    """``--mesh``: phase 4's decomposition (made and saved here) and the
    host goldens phase 20 gates against, then phases 20-22, whose ranks
    pack while the goldens are computed (phase 22's graph in a host
    process from the start)."""
    import numpy as np

    from arrow_matrix_tpu_torch.utils import random_dense

    width = 2048
    host22 = start_host(phase22_host, keep)
    base, _ = decompose_phase4(n, keep)
    pool = start_mesh(base, width)
    tic = time.perf_counter()
    levels = as_levels_of(base, width)
    for k, xseed, steps in ((16, 3, max(MESH["chain"],
                                        SERVE["iterations"])),
                            (128, 4, 1)):
        g = random_dense(n, k, seed=xseed)
        for s in range(steps):
            g = host_golden(levels, g, max(1, (os.cpu_count() or 2) // 2))
            np.save(golden_path(base, k, s + 1), g)
    log(f"phase 4 (for phase 20): the host goldens in "
        f"{time.perf_counter() - tic:.1f} s")
    del levels
    return phase_mesh(start_mesh_work(pool, base, width, host22))


def state_only(n: int, keep: str) -> tuple:
    """``--state``: phase 4's decomposition (made and saved here) and its
    k=16 input's host goldens, then phase 23 on rank pools of its own (4
    gloo ranks holding phase 7's graph, the NCCL rank phase 4's levels),
    its subprocesses beside the ranks' work."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.parallel.launch import RankPool
    from arrow_matrix_tpu_torch.utils import random_dense

    width = 2048
    base, _ = decompose_phase4(n, keep)
    pool = RankPool(MESH["world"], backend="gloo", threads=2)
    nccl = RankPool(torch.cuda.device_count(), backend="nccl", threads=2)
    subs = ThreadPoolExecutor(1)
    try:
        for ranks, n_small in ((pool, MESH["n_small"]), (nccl, 0)):
            ranks.submit("chip_smoke", "state23_prepare", base, width,
                         n_small)
        tic = time.perf_counter()
        levels = as_levels_of(base, width)
        g = random_dense(n, 16, seed=3)
        for step in range(SERVE["iterations"]):
            g = host_golden(levels, g)
            np.save(golden_path(base, 16, step + 1), g)
        del levels
        log(f"phase 4 (for phase 23): the k=16 input's host goldens in "
            f"{time.perf_counter() - tic:.1f} s")
        pool.collect(job_timeout_s=900)
        nccl.collect(job_timeout_s=900)
        pool.submit("chip_smoke", "state23_ranks", keep)
        nccl.submit("chip_smoke", "state23_nccl_build", width, True)
        sub = subs.submit(state23_subprocesses, keep, base)
        b23 = pool.collect(job_timeout_s=900)
        built = nccl.collect(job_timeout_s=900)[0]
        a23 = nccl.run("chip_smoke", "state23_nccl", base,
                       job_timeout_s=900)[0]
        d23 = nccl.run("chip_smoke", "state23_streamed", base, width,
                       job_timeout_s=600)[0]
        res = phase_state(a23, d23, b23, built,
                          sub.result(timeout=STATE["timeout_s"]))
    finally:
        pool.close()
        nccl.close()
        subs.shutdown(wait=False)
    return res, a23["entries"]


def serve_only(dev, n: int, work: str) -> tuple:
    """``--serve``: phase 4's decomposition (generated, decomposed,
    saved and loaded as in phase 4) and its k=16 input's 10-step host
    golden, then phase 15 (whose results phase 16 takes on)."""
    from arrow_matrix_tpu_torch.utils import random_dense

    m, width = 8, 2048
    base, t_dec = decompose_phase4(n, work)
    levels = as_levels_of(base, width)
    nnz = sum(int(lvl.matrix.nnz) for lvl in levels)
    tic = time.perf_counter()
    x16 = g = random_dense(n, 16, seed=3)
    for _ in range(SERVE["iterations"]):
        g = host_golden(levels, g)
    log(f"phase 4 (for phase 15): BA n={n} m={m}: {nnz} nnz, {len(levels)} "
        f"levels, generated, decomposed, saved and loaded in {t_dec:.1f} s; "
        f"the k=16 input's {SERVE['iterations']}-step host golden "
        f"{time.perf_counter() - tic:.1f} s")
    return phase_serve(dev, levels, n, width, nnz / n, x16, g, work)


def phase4_host(n: int, base: str, out: str) -> None:
    """Phase 4's host work in a process of its own: BA ``n`` m=8 (seed 7)
    decomposed at width 2048 (10 levels) by the numpy decomposer and
    saved as the artifact ``base``; beside the decomposition, in a
    thread, the host goldens of its inputs over the graph itself
    (``A^s x`` for the k=16 and k=128 inputs, :data:`VALIDATED` steps,
    on half the cores), each saved as :func:`golden_path`; its seconds
    in ``out``."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import save_decomposition
    from arrow_matrix_tpu_torch.utils import barabasi_albert, random_dense

    tic = time.perf_counter()
    a = barabasi_albert(n, 8, seed=7)
    t_gen = time.perf_counter() - tic
    # The graph for phase 13's host goldens (:func:`models_host`).
    np.save(graph_path(base, "indptr"), a.indptr)
    np.save(graph_path(base, "indices"), a.indices)
    with open(graph_path(base, "ready"), "w"):
        pass

    def goldens() -> float:
        tic = time.perf_counter()
        cores = max(1, (os.cpu_count() or 2) // 2)
        for k, xseed in GOLDEN_INPUTS:
            g = random_dense(n, k, seed=xseed)
            for s in range(VALIDATED[k]):
                g = host_golden(a, g, cores)
                np.save(golden_path(base, k, s + 1), g)
        return time.perf_counter() - tic

    with ThreadPoolExecutor(1) as pool:
        gold = pool.submit(goldens)
        tic = time.perf_counter()
        levels = arrow_decomposition(a, 2048, max_levels=10,
                                     block_diagonal=True, seed=7)
        t_dec = time.perf_counter() - tic
        save_decomposition(levels, base, block_diagonal=True)
        t_gold = gold.result()
    with open(out, "w") as fh:
        json.dump({"t_gen": t_gen, "t_dec": t_dec, "t_gold": t_gold}, fh)


def int8_check(levels, xin, got, step, k: int) -> str:
    """Phase 4's int8 step at width ``k`` against the float64 host
    product of its dequantized input ``xin``: every element of ``got``
    within one quantization step (``step``, by column); fatal
    otherwise, else the line to log."""
    import numpy as np

    exact = host_golden(levels, xin.astype(np.float64),
                        max(1, (os.cpu_count() or 2) // 2))
    dev_err = np.abs(got - exact)
    if not np.all(dev_err <= step * (1 + 1e-6)):
        raise SystemExit(f"int8 k={k}: an element is off by more than one "
                         f"quantization step")
    return (f"int8 k={k}: every element within one quantization step "
            f"(worst {float((dev_err / step).max()):.3f} steps; its host "
            f"golden beside phases 5 and 11)")


def golden_path(base: str, k: int, s: int) -> str:
    """The file of ``A^s x`` for phase 4's k-wide input."""
    return f"{base}_gold_k{k}_s{s}.npy"


def graph_path(base: str, part: str) -> str:
    """A file of phase 4's graph as :func:`phase4_host` saves it for
    :func:`models_host`: its CSR ``indptr`` and ``indices`` (.npy), and
    ``ready`` once both are there."""
    return f"{base}_graph_{part}" + ("" if part == "ready" else ".npy")


def name_process(name: str) -> None:
    """Set the calling thread's name: the process's (``/proc/<pid>/comm``,
    as :func:`cpu_trace` reads it) when called from its main thread."""
    import ctypes

    PR_SET_NAME = 15
    ctypes.CDLL(None).prctl(PR_SET_NAME, name[:15].encode(), 0, 0, 0)


def named_host(target, nice: int, *args) -> None:
    """A host process's body: named after ``target``, at niceness
    ``nice``, then ``target(*args)``."""
    name_process(target.__name__)
    os.nice(nice)
    target(*args)


def start_host(target, *args, nice: int = 0) -> tuple:
    """Start a phase's host work, ``target(*args, out)``, in a spawned
    process at niceness ``nice`` (19 for work whose result waits long
    for its reader: it then takes only the cores the phases leave
    idle); (the process, ``out``, a JSON file the target writes)."""
    import multiprocessing
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "arrow_matrix_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    fd, out = tempfile.mkstemp(suffix=".json", prefix=target.__name__,
                               dir=build)
    os.close(fd)
    # A daemon: a run that fails before joining it does not wait for it.
    proc = multiprocessing.get_context("spawn").Process(
        target=named_host, args=(target, nice, *args, out),
        name=target.__name__, daemon=True)
    proc.start()
    return proc, out


def join_host(proc, out: str, phase: str) -> dict:
    """Wait for :func:`start_host`'s process; the record it wrote.  Fatal
    if it failed."""
    proc.join()
    try:
        if proc.exitcode != 0:
            raise SystemExit(f"{phase}: its host process exited "
                             f"{proc.exitcode}")
        with open(out) as fh:
            return json.load(fh)
    finally:
        os.remove(out)


def after_host(host: tuple, phase: str, out: dict, then) -> None:
    """Wait for :func:`start_host`'s process ``host`` (:func:`join_host`),
    then call ``then()``: their results as ``out["rec"]`` and
    ``out["then"]``, or the exception as ``out["error"]`` (a thread's
    body; its reader raises it)."""
    try:
        out["rec"] = join_host(*host, phase)
        out["then"] = then()
    except BaseException as e:      # re-raised by the reader
        out["error"] = e


def decompose_phase4(n: int, directory: str) -> tuple:
    """Phase 4's decomposition for a short form: BA ``n`` m=8 decomposed
    at width 2048 (10 levels, seed 7) by the numpy decomposer and saved
    as an artifact under ``directory``; returns (its base, seconds)."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import save_decomposition
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    m, width, seed = 8, 2048, 7
    tic = time.perf_counter()
    a = barabasi_albert(n, m, seed=seed)
    levels = arrow_decomposition(a, width, max_levels=10,
                                 block_diagonal=True, seed=seed)
    base = os.path.join(directory, f"ba_{n}_{m}")
    save_decomposition(levels, base, block_diagonal=True)
    t_dec = time.perf_counter() - tic
    log(f"phase 4 (for a short form): BA n={n} m={m} decomposed into "
        f"{len(levels)} levels and saved in {t_dec:.1f} s")
    return base, t_dec


def as_levels_of(base: str, width: int):
    """The levels of the artifact at ``base``, loaded as phase 4 loads
    them."""
    from arrow_matrix_tpu_torch.io import (
        as_levels,
        load_decomposition,
        load_level_widths,
    )

    return as_levels(load_decomposition(base, width, block_diagonal=True),
                     load_level_widths(base, width, True))


def dense_phases(dev, n: int, work: str) -> tuple:
    """Phases 6-8; the dense blocks are freed on return."""
    import torch

    phase_block_kernels(dev)
    out = dense_path(dev, n, work)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


#: The kernels each bench candidate's step must launch (phase 14).
BENCH_KERNELS = {"fold": ("K1",), "hyb": ("K1", "K4", "K4 add"),
                 "auto": ("K1", "K2", "K3", "K4", "K4 add")}
#: Phase 14's race: fold and auto, whose steps launch every kernel
#: (phase 11 drives and times hyb at the same graph and width).
BENCH_RACE = ("fold", "auto")


def check_levels(a, levels, width: int) -> None:
    """Raise unless ``levels`` reconstruct ``a`` exactly and every level
    keeps its edges within its width: the block diagonal or the head
    for every level but the last, the band of its achieved width or the
    head for the last."""
    import numpy as np

    from arrow_matrix_tpu_torch.decomposition import reconstruct

    if (reconstruct(levels) != a).nnz:
        raise SystemExit("phase 14: the native levels do not reconstruct A")
    for i, lvl in enumerate(levels):
        coo = lvl.matrix.tocoo()
        r, c = coo.row.astype(np.int64), coo.col.astype(np.int64)
        w = lvl.arrow_width
        head = (r < w) | (c < w)
        if i < len(levels) - 1:
            inside = (w == width) & np.all(head | (r // w == c // w))
        else:
            inside = np.all(head | (np.abs(r - c) <= w))
        if not inside:
            raise SystemExit(f"phase 14: native level {i} leaves its width "
                             f"{w}")


def phase14_host(n: int, out: str) -> None:
    """Phase 14's host work in a process of its own: BA ``n`` m=8 (seed
    7) decomposed at width 2048 (max_levels 12) by the native decomposer
    into the bench's cache, the levels checked (:func:`check_levels`);
    its seconds and levels in ``out``."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.tools import gather_probe
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    m, width, seed, max_levels = 8, 2048, 7, 12
    a = barabasi_albert(n, m, seed=seed)
    tic = time.perf_counter()
    levels = arrow_decomposition(a, width, max_levels=max_levels,
                                 block_diagonal=True, seed=seed,
                                 backend="native")
    t_native = time.perf_counter() - tic
    tic = time.perf_counter()
    check_levels(a, levels, width)
    t_check = time.perf_counter() - tic
    base = gather_probe.cache_base(n, m, width, seed, max_levels, "native",
                                   gather_probe.CACHE_DIR)
    gather_probe.store_levels(levels, base)
    with open(out, "w") as fh:
        json.dump({"t_native": t_native, "t_check": t_check, "base": base,
                   "widths": [lvl.arrow_width for lvl in levels]}, fh)


def phase_bench(dev, n: int, host14: tuple, t_numpy, ledger_dir: str
                ) -> dict:
    """Phase 14: the native decomposition of BA ``n`` m=8 into the
    bench's cache (``host14``: :func:`phase14_host`'s process and its
    output file), then the bench as a subprocess on it, its ledger
    record into ``ledger_dir``; every check fatal."""
    import subprocess

    import torch

    from arrow_matrix_tpu_torch import bench
    from arrow_matrix_tpu_torch.tools import gather_probe
    from arrow_matrix_tpu_torch.utils.artifacts import parse_last_json_line

    tic = time.perf_counter()
    rec = join_host(*host14, "phase 14")
    cache = gather_probe.CACHE_DIR
    numpy_s = ("phase 4's numpy decomposer (max_levels 10) "
               f"{t_numpy:.1f} s" if t_numpy is not None
               else "phase 4's numpy seconds are in its line")
    log(f"phase 14: native decomposer {rec['t_native']:.1f} s "
        f"({len(rec['widths'])} levels, widths {rec['widths']}; in a "
        f"process of its own, waited {time.perf_counter() - tic:.1f} s); "
        f"{numpy_s}; levels reconstruct A exactly and stay within their "
        f"widths (checked in {rec['t_check']:.1f} s); saved as "
        f"{rec['base']}")
    out = {"native_decompose_s": rec["t_native"],
           "numpy_decompose_s": t_numpy, "native_levels": len(rec["widths"])}
    torch.cuda.empty_cache()

    # The race without fold_tight and hyb: phase 4 times that packing and
    # phase 11 that format on the same graph, and a candidate costs a
    # subprocess of 20-30 s.
    env = dict(os.environ, AMT_BENCH_COMPARE="0", AMT_BENCH_CACHE_DIR=cache,
               AMT_BENCH_N=str(n), AMT_BENCH_DEADLINE="1500",
               AMT_BENCH_FMT=",".join(BENCH_RACE))
    for key in ("AMT_BENCH_LEVELS", "AMT_BENCH_K128",
                "AMT_BENCH_SMALL", "AMT_BENCH_FULL", "AMT_LEDGER"):
        env.pop(key, None)
    env["AMT_LEDGER_DIR"] = ledger_dir
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    tic = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "arrow_matrix_tpu_torch.bench"],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=1560)
    t_bench = time.perf_counter() - tic
    for line in proc.stderr.splitlines():
        print(f"    bench: {line}")
    line = parse_last_json_line(proc.stdout)
    print(f"phase 14 bench line: {json.dumps(line)}", flush=True)
    if proc.returncode != 0 or line is None:
        raise SystemExit(f"phase 14: the bench exited {proc.returncode}")
    name = torch.cuda.get_device_name(0)
    bad = []
    if line.get("platform") != "gpu" or line.get("device_kind") != name:
        bad.append(f"platform/device_kind {line.get('platform')} "
                   f"{line.get('device_kind')}")
    if line.get("config", {}).get("decompose_backend") != "native":
        bad.append("the bench did not load the native decomposition")
    value = line.get("value")
    if not isinstance(value, float) or not math.isfinite(value):
        bad.append(f"value {value}")
    if not line.get("frobenius_err_vs_cpu", 1.0) <= line.get(
            "frobenius_gate", 0.0):
        bad.append("frobenius_err_vs_cpu above its gate")
    if "k128_ms" not in line or not line.get("k128_err", 1.0) <= line.get(
            "k128_gate", 0.0):
        bad.append(f"k128: {line.get('k128_error', 'no k128_ms')}")
    frac = line.get("roofline_frac")
    if frac is None or not frac <= 1.0:
        bad.append(f"roofline_frac {frac}")
    if not line.get("fmt_used"):
        bad.append("no fmt_used")
    onchip = line.get("last_onchip")
    if onchip is not None and onchip["summary"].get("platform") != "gpu":
        bad.append(f"last_onchip from {onchip['path']}")
    from arrow_matrix_tpu_torch.ledger import Ledger

    recs = [r for r in Ledger(ledger_dir).read_all() if r["kind"] == "bench"]
    if (len(recs) != 1 or recs[0]["payload"]["parsed"] != line
            or recs[0]["platform"] != "gpu"):
        bad.append(f"the bench's ledger record: {len(recs)} records")
    for cand, run in line.get("device_runs", {}).items():
        idle = [k for k in BENCH_KERNELS.get(cand, ())
                if not run.get("launches", {}).get(k)]
        if "ms" in run and idle:
            bad.append(f"{cand} launched no {idle}")
    if bad:
        raise SystemExit(f"phase 14: {'; '.join(bad)}")
    log(f"phase 14: bench {t_bench:.1f} s: {line['fmt_used']} "
        f"{value:.4f} ms/iter at k=16 (vs scipy {line['vs_baseline']}x, "
        f"err {line['frobenius_err_vs_cpu']:.3e} <= "
        f"{line['frobenius_gate']:.1e}, roofline {frac}), k=128 "
        f"{line['k128_ms']:.4f} ms/iter; candidates "
        + ", ".join(f"{c}: {r.get('ms', r.get('error'))} ms, launches "
                    f"{r.get('launches')}"
                    for c, r in line["device_runs"].items()))
    out.update(bench_s=t_bench, line=line,
               peak_bytes_s=bench.peak_bytes_s(name))
    return out


def finish(results: dict, kernels: list) -> int:
    """Print the results, the kernels' line and the last line."""
    import torch

    log(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all")
    print(json.dumps(results))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- the processes the run starts ----------------------------------------------

#: The ``prctl`` option that makes a process the reaper of the orphans
#: among its descendants (Linux, ``<linux/prctl.h>``).
PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> None:
    """Make this process the parent of every orphan among its
    descendants (a process whose own parent exited first, such as a
    fleet worker's resource tracker), so that :func:`stop_descendants`
    finds every process the run started and reaps those that exited."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        print(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed (errno "
              f"{ctypes.get_errno()}): an orphan of a child may outlive "
              f"the run", file=sys.stderr, flush=True)


def descendants() -> list:
    """Every process below this one, as (pid, state letter), each
    parent before its children."""
    children = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        children.setdefault(int(fields[1]), []).append((int(name),
                                                        fields[0]))
    out, todo = [], [os.getpid()]
    while todo:
        for pid, state in children.get(todo.pop(0), []):
            out.append((pid, state))
            todo.append(pid)
    return out


def command_line(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return fh.read().replace(b"\0", b" ").decode(
                errors="replace").strip()[:240]
    except OSError:
        return "?"


def reap_children() -> None:
    """Reap every child of this process that has exited."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants(grace_s: float = 10.0) -> list:
    """Stop every process the run started that is still there at its
    end: the multiprocessing resource tracker by closing its pipe (it
    ignores SIGTERM), any other by SIGTERM and, after ``grace_s``,
    SIGKILL; each is reaped.  Returns the command lines of those that
    were still running, each also named on standard error."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    stop = getattr(tracker, "_stop", None)
    if stop is not None and getattr(tracker, "_pid", None) is not None:
        stop()
    stopped = {}
    deadline = time.monotonic() + grace_s
    while True:
        reap_children()
        live = [pid for pid, state in descendants() if state != "Z"]
        if not live:
            break
        late = time.monotonic() > deadline
        if late and time.monotonic() > deadline + grace_s:
            print(f"chip_smoke: processes {live} survived SIGKILL",
                  file=sys.stderr, flush=True)
            break
        for pid in live:
            if pid not in stopped:
                stopped[pid] = command_line(pid)
                print(f"chip_smoke: pid {pid} was still running at the "
                      f"end, stopping it: {stopped[pid]}", file=sys.stderr,
                      flush=True)
            try:
                os.kill(pid, signal.SIGKILL if late else signal.SIGTERM)
            except ProcessLookupError:
                pass
        time.sleep(0.1)
    reap_children()
    return list(stopped.values())


def proc_ticks(path: str) -> tuple:
    """(utime + stime clock ticks, parent pid, name) of the
    ``/proc/<pid>[/task/<tid>]/stat`` at ``path``; None if it is gone."""
    try:
        with open(path) as fh:
            head, tail = fh.read().rsplit(")", 1)
        f = tail.split()
        return int(f[11]) + int(f[12]), int(f[1]), head.split("(", 1)[1]
    except (OSError, IndexError, ValueError):
        return None


def cpu_trace(path: str, every_s: float = 5.0) -> None:
    """Write, every ``every_s`` until the run ends, one JSON line to
    ``path``: the seconds since the start, the cores this run's
    processes kept busy over the interval, of them this process's main
    thread and its other threads, and each descendant's cores (a
    descendant's parent, name and command line on the first line that
    names it).  A record of where the host's cores went, read after a
    run."""
    tick = os.sysconf("SC_CLK_TCK")
    prev, seen, then = {}, set(), time.perf_counter()
    me = os.getpid()
    with open(path, "w") as out:
        while True:
            time.sleep(every_s)
            now = time.perf_counter()
            cur, about = {}, {}
            for tid in os.listdir(f"/proc/{me}/task"):
                got = proc_ticks(f"/proc/{me}/task/{tid}/stat")
                if got is not None:
                    cur[("thread", int(tid))] = got[0]
            for pid, state in descendants():
                got = proc_ticks(f"/proc/{pid}/stat")
                if got is not None and state != "Z":
                    cur[("proc", pid)] = got[0]
                    about[pid] = f"{got[1]} ({got[2]})"
            dt = now - then
            cores = {key: (v - prev.get(key, v)) / tick / dt
                     for key, v in cur.items()}
            rec = {"t": round(now - T0, 1),
                   "run_cores": round(sum(cores.values()), 2),
                   "main": round(cores.get(("thread", me), 0.0), 2),
                   "main_threads": round(sum(
                       c for (kind, i), c in cores.items()
                       if kind == "thread" and i != me), 2),
                   "procs": {str(i): round(c, 2)
                             for (kind, i), c in cores.items()
                             if kind == "proc" and c >= 0.05}}
            for kind, i in cur:
                if kind == "proc" and i not in seen:
                    seen.add(i)
                    rec.setdefault("new", {})[str(i)] = (
                        f"{about[i]} {command_line(i)[:160]}")
            out.write(json.dumps(rec) + "\n")
            out.flush()
            prev, then = cur, now


def run() -> int:
    """:func:`main`, and every process it started stopped at its end."""
    adopt_orphans()
    trace = os.environ.get("AMT_SMOKE_CPU_TRACE", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "arrow_matrix_tpu_torch",
        "_build", "smoke_cpu_trace.jsonl"))
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    threading.Thread(target=cpu_trace, args=(trace,), daemon=True,
                     name="cpu-trace").start()
    try:
        return main()
    finally:
        stop_descendants()


if __name__ == "__main__":
    sys.exit(run())
