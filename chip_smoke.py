#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``karpenter_core_tpu_torch``) on one
NVIDIA card and check it.

Phases 1-3 in order, then 4-23 in four lanes side by side (``LANES``);
any failure exits non-zero:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile the Hopper compat∧offering kernel, the three pack
   kernels, the disruption screens (nvcc) and the C++ packer (g++) from
   the repo's sources, one compiler each, in parallel.
3. Kernel: the kernel, through the wrapper's own tile pick and with
   each of its two tile shapes forced, against its plain PyTorch
   versions on the card, bit for bit, on seeded ragged planes, the
   slice's, config 3's, the cluster-spread, config 6 and both
   anti-affinity phases' own catalog shapes (T = 2000; config 6 T = 400,
   anti-dense T = 200), bench config 7's (T = 500) whole and for four of
   its teams alone (the shape of a warm tick's missing signatures),
   S ∈ {4, 16, 17, 64, 65, 128, 512} × T=2048 at the
   slice's widths and S=8192 × T=2048; one JSON line per shape with
   ``kernel_ms`` (CUDA events around back-to-back launches alone, queued
   behind a device sleep so host enqueue time is hidden), per tile shape,
   ``wrapper_ms`` (events around one ``allowed_via_kernel`` call, host
   checks and ctypes included), the plain version's time,
   ``library_ms`` (the same function as per-key fp16 ``torch.matmul``
   calls — a yardstick the port never calls), ``bound_ms`` (the least
   time at the published peaks) and ``alu_ceiling_ms`` (the CUDA cores'
   32-bit logic rate at the card's maximum SM clock), and for the main
   shapes the kernel's device time from torch.profiler
   (``profiled_kernel_ms``) and, at 8192 × 2048, the SM clock and power
   sampled under load; and the ptxas registers, shared memory and spills
   of each tile instantiation.
4. Slice: 50,000 pods × 2,000 instance types (bench config 3's mix and
   seed without its topology-spread share) through
   ``TorchScheduler(device="cuda").solve``: one cold solve, the median
   of three warm ones, the kernel's launch count over those four, the
   identical plan stream from ``device="cpu"``, and the plan invariants.
   In phases 4–12 a path whose cold solve takes over ``DEEP_SOLVE_MS``
   (2 s) runs one warm solve instead of three, and one whose warm solve
   does is not profiled.
5. Cluster: the same 50,000 pods against a live cluster through
   ``solve(pods, state_nodes, daemonset_pods)``: 1,000 initialized
   existing nodes with about 10k bound pods, three daemonsets, and two
   NodePools, ``reserved`` (weight 10, limits cpu 1000 / memory 1000Gi)
   and ``default``. One cold and three warm solves on the card, the
   kernel's launches over those four, plans, existing plans and pod
   errors identical to the ``device="cpu"`` solve, the fit of every
   existing node, the limit, every pod accounted once, and the C++
   existing-node first-fit against its plain PyTorch version on the card
   on the solve's own inputs.
6. Config 3: bench config 3 whole (``config3_world``: the slice's pods
   with its zone spread on residues 5 and 6), one cold and three warm
   solves on the card, the kernel's launches, plans and errors identical
   to the ``device="cpu"`` solve, the plan invariants and
   ``check_spread`` (every zone that received a spread group's pods is
   within max_skew of the group's least-loaded supported zone).
7. Cluster spread: phase 6's pods plus 800 ``app=ha-web`` pods with a
   hostname spread (one replica per node) against phase 5's cluster,
   whose nodes and bound pods also sit in a ``KubeClient`` passed as
   ``kube_client`` (zone-1 workers labeled ``app=svc-5``, a bound
   ha-web pod on every 5th node): the same solves and comparisons,
   ``check_cluster``, ``check_spread`` against the seeds and
   ``check_hostname``.
8. Config 6: bench config 6 whole (``config6_world``: karpenter-core's
   diverse mix, 7,000 pods × 400 types, two sevenths of them with pod
   affinity on hostname or zone, resolved by the post-pass): the same
   solves and comparisons, ``check_invariants``, ``check_affinity``
   (every placed affinity pod shares its zone or node with a pod each
   term matches) and ``check_spread_serial``.
9. Anti-affinity: config 13's ``anti_dense`` (10,000 pods with one- and
   three-term anti-affinity against eight bound ``ext-*`` anchors) and a
   six-pod zone quorum, first as the bench builds it (``anti_dense_world``:
   200 types, no existing nodes, so the zone exclusion narrows each
   group's pool rows and the quorum takes unmerged one-pod nodes), then
   against phase 5's cluster in a kube store with the anchors on
   existing nodes (``anti_cluster_world``): the same solves and
   comparisons, ``check_invariants`` (``check_cluster`` on the
   cluster), and ``check_anti`` (no anti pod shares an excluded zone or node with
   a matching pod, one quorum member per zone).

10. Stateful: config 13's ``stateful_dense`` (10,000 pods: ephemeral
   volumes, host ports 8000–8011, plain; 16 existing nodes with CSI
   attach limit 8, built in the solver's units) and ``spread_skew`` as
   the bench builds them, then ``stateful_cluster_world``: phase 5's
   cluster with CSI limits, mounted claims and node-exporter's
   hostPort 9100, a ``db`` pool, the ``stateful_dense`` pods, 100
   hostPort-9100 agents and three 50-replica StatefulSets whose claims
   pin zones: the same solves and comparisons (the CPU solve on its
   own copy of the pods), ``check_cluster`` where there are nodes,
   ``check_ports``, ``check_volumes``, ``check_zone_pins`` (``check_spread``
   for ``spread_skew``), and the C++ first-fit against its plain version
   on the card on every stateful first-fit's inputs.

11. Oracle and relaxation: bench config 1 (1,000 uniform pods × 10
   types) through the port's greedy scheduler (``build_scheduler(...)
   .solve``) as the bench runs it, host only; ``oracle_mix_world``
   (config 6 whole plus 342 pods of Helm releases with Bitnami's soft
   pod anti-affinity, ten one-selector releases and two postgresql
   releases whose selector matches their primary and read replicas),
   which the solve's routing sends to the greedy fallback, as built and
   against phase 5's cluster in a kube store (``oracle_cluster_world``);
   ``relax_cluster_world`` (phase 5's world with every ``test-zone-3``
   offering unavailable, every 5th pod preferring that zone and every
   20th with a two-term required zone affinity whose first term no
   offering meets), which the preference-relaxation retry solves; and
   ``packing_parity_vs_oracle`` (``bench.py:214-243``) of the solve on
   the card against the port's greedy scheduler on config 6's
   1,500-pod stratified subsample and on config 1. Each path: the same
   solves and cuda-vs-cpu comparisons (the greedy fallback's claims
   included), ``check_oracle`` (exactly the release pods routed off,
   one replica per node wherever the soft preference held, every claim
   fits its cheapest option), ``check_affinity`` and
   ``check_spread_serial`` for config 6's part, ``check_cluster`` on the
   clusters, no new node in the drought zone, and a relaxation that
   placed pods.

12. Pack engines: with ``KARPENTER_TORCH_NATIVE=0`` (the device engine)
   bench config 3 whole and phase 5's cluster, one cold and three warm
   solves on the card with the launches of the FFD scan kernel
   (``csrc/ffd_pack.cu``) and the existing-node first-fit kernel
   (``csrc/pack_existing.cu``) counted, plans, existing plans and errors
   equal to the ``device="cpu"`` solve through their plain versions, and
   the idle share; the LP backend (``KARPENTER_TORCH_PACK_BACKEND=lp``)
   on bench config 10 whole: each of its eleven shapes under ffd and lp
   on the card, plans equal to the CPU's, each shape's $/hr equal to the
   JAX package's (``CONFIG10_REFERENCE``), lp <= ffd, bound <= cost, the
   same pods, the 41.2 % adversarial saving and a dual-ascent launch
   (``csrc/dual_ascent.cu``) in every lp solve; config 10 again under lp
   with the native packer off (repair packs through the scan kernel);
   bench config 5 whole (10,000 pods x 2,000 types x 6 zones) under ffd,
   lp and auto (threshold pinned): 164 nodes at $873.4703/hr each, the
   cost guard keeping FFD, the calibrated threshold on its own line.
   Then every distinct captured call of each pack kernel against its
   plain version on the card, bit for bit, with ``kernel_ms`` (events
   around queued launches), the plain version's time and ``bound_ms``;
   for the two scans also ``step_us``, the time of one pod step (over
   the longest job's pods for B5, over all pods for B6), for B7
   ``iter_us`` (over its iterations) and its plan (threads, replicas,
   layout);
   synthetic calls at shapes no path gives (``synthetic_scan_calls``,
   ``synthetic_dual_calls``: B5 at widths 12 and 700, B6 wide and past
   4,096 nodes, B7 at 4,096 types and with its work area in device
   memory); and ``lp.relax`` split into its uploads, kernel, downloads
   and host bound on a captured config 5 and config 10 call
   (``relax_split``).

13. Provisioner: the port's ``Provisioner.reconcile`` over a live
   in-memory store (``KubeClient`` + ``Informers`` into a ``Cluster`` +
   ``Recorder`` + ``Metrics``, every clock fixed), on the batched path
   (``use_tpu_solver``) on the card, each kernel's launches counted from
   0 just before the reconcile and read just after. 13a
   ``config2-provisioner``: bench config 2 whole (10,000 pods, 480 + 20
   GPU types) as pending pods: one reconcile, three ``schedule()``
   calls, plans equal to a direct ``TorchScheduler.solve``, one claim
   per plan, a Nominated event per placed pod, ``nodeclaims_created``
   and ``solver_duration`` counted, the trace ``provisioner.reconcile``
   → ``snapshot_nodes``, ``pending_pods``, ``solve``,
   ``create_node_claims``; the same claims from a CPU reconcile in a
   fresh store; then one parity shadow and its ``solver_parity`` gauge.
   13b ``cluster-provisioner``: phase 5's world as store objects (1,000
   nodes with their NodeClaims, the bound pods, three DaemonSets, two
   pools) and its 50,000 pending pods, reconciled with the C++ packer
   and with ``KARPENTER_TORCH_NATIVE=0`` (the scan kernels), and with the
   C++ packer on the CPU: plans equal to the direct solve of phase 5's
   inputs under the same packer (the device engine's direct solve is
   phase 12's cluster-device path, held there to the CPU's plain
   scans), existing placements nominated with no claim,
   ``check_cluster``; a captured compat call and the device run's
   existing-node first-fit held against their plain versions. 13c
   ``anti-cluster-oracle``: phase 9's cluster cut to 200 nodes and 3,000
   anti pods, three bound guards with required anti-affinity, and phase
   11's Helm release pods (the greedy fallback, whose topology walks the
   guards): ``check_inverse`` (no greedy placement in a domain a guard
   excludes; the tensor path's counted, as the JAX package's), the
   claims and the fallback's equal to a CPU reconcile's.

14. Config 7 ticks: bench config 7 (``bench.py:763-960``) on the card
   (``run_config7_phase``): 10,000 pods of RandomState(23), 480 + 20 GPU
   types, 40 teams, 20 ticks (bench config 7's 30, cut for the script's
   time) at 5 % churn on four teams, every tenth a
   1 % price rise on every 16th type, a catalog generation bump and a
   pool weight change. Each tick a restart-shaped cold leg (fresh pods,
   catalog, pool and TorchScheduler, ``KARPENTER_TORCH_INCREMENTAL=0``)
   and a warm leg on one long-lived ``TorchScheduler(device="cuda")``:
   plans identical every tick, the warm leg's compat launches at most
   the cold leg's; a no-op tick that replays with no compat and no FFD
   launch; ten more ticks with ``KARPENTER_TORCH_NATIVE=0``, whose FFD
   scan launches are one per (size class, width) class of the jobs the
   job memo missed, plans equal to a cold solve of the tick's pods on the
   same engine and, on its last tick, to a cold CPU solve through the
   plain scans; a restart (``snapshot``, ``simulate_process_death``,
   ``restore`` into a fresh card scheduler) whose first solve of the last
   tick's pods is plan-identical to the un-killed scheduler's with no
   compat launch; and the last tick's plan equal to a cold CPU solve's.
   Every compat and FFD call of the phase's solves is captured, and each
   distinct shape is held against its plain version on the card, bit for
   bit; ``sections_s`` splits the phase's wall time. Phases 4-13 run
   with ``KARPENTER_TORCH_INCREMENTAL=0``: they measure the cold
   pipeline, as before the warm state existed.
15. Disruption (``run_disruption_phase``), the warm state on, every
   world built twice (card and CPU) with the same generated identities.
   15a ``config4-consolidation``: bench config 4 whole
   (``bench.py:552-602``): 5,000 initialized ``fake-it-4`` nodes with one
   100m / 128Mi pod each, an hour on, ``get_candidates`` then
   ``MultiNodeConsolidation.compute_command`` (the batched engine: the
   prefix and subset screens, the repack bound, greedy simulations);
   again with ``KARPENTER_TORCH_NATIVE=0`` (the repack bound on B6); both
   commands and engine stats equal to a CPU run's. 15b
   ``config9-disruption``: bench config 9 (``bench.py:1150-1460``): 500
   ``dx-host`` nodes carrying ``scenario_spot_storm(50,000, 20 teams,
   seed 9)``'s base step (49,973 pods bind), a 5 % budget, the batched
   solver's simulations; phase A's decision and five steady ones, phase
   B's churn steps (the storm recovering at 70 %, a price storm), the
   single-node decision, each batched and sequential with equal command
   keys, all equal to a CPU run's; the churn steps again with
   ``KARPENTER_TORCH_NATIVE=0`` (B6 and the FFD scan), the same commands.
   15c ``controller-e2e``: a 40-node store world with drift, expiration,
   emptiness and an underutilized pool: the markers, ``reconcile`` until
   nothing is left, the orchestration queue; conditions, taints, claims,
   deletion marks, events and disruption metrics equal to a CPU run's.
   15d: every distinct captured screen call, and the synthetic shapes
   past them (``synthetic_screen_calls``: the subset family at its cap of
   8,193 rows and at 8 columns, the prefix at 1,000 × 8 and 4,097 × 3,
   sums past 2^24), against its plain version on the card, bit for bit,
   with its time, the reference formula's as one PyTorch expression
   (``library_ms``), the bound, the chain (``chain_ms``: the dependent
   adds at FADD_CYCLES cycles each at the maximum SM clock) and the
   largest partial sum. ``sections_s`` splits the phase's wall time.
16. Serving (``run_serving_phase``), the warm state on. 16c, the
   kernels under serving: ``KARPENTER_TORCH_NATIVE=0``, bench config 8's
   ``rollout`` and ``cascade`` at scale 400 in lockstep through the
   ``ServingPipeline`` and the ``SequentialLoop`` on the card and the
   pipeline on the CPU, a ``DisruptionController`` every second tick
   (the world's clocks fixed, joined nodes labeled as their claims pin,
   replacements launched): plan streams, disruption passes and stores
   equal across the three, no fault of the serving logger; every
   compat, FFD, first-fit and screen call of the card legs' ticks and
   prewarm thread held to its plain version bit for bit, each distinct
   shape timed, launches split tick against prewarm. 16a, bench config
   8 whole (``bench.py:1035-1131``): the five scenarios at scale 400 and
   pace 0.2 s, each measurement its own ``python -m
   karpenter_core_tpu_torch.serving.trafficgen`` process (lockstep
   sequential and pipeline on the card and sequential on the CPU, eight
   at a time; then the free pipeline runs and churn10x's free sequential
   run one at a time): plan hashes equal, decisions monotonic, no
   orphaned span; steady latency, pods/s, queues, stage attribution and
   flight-recorder coverage reported. 16b, bench config 14
   (``bench.py:2325-2458``): ``restart_wave`` at 600 pods × 480 types,
   kill at step 6, per seed the kill and the unkilled reference, then
   the warm and the cold resume, each a process on the card; both
   resumes' plan hashes equal the reference's. Seed 7 always; 17 and 27
   while the phase's projection stays within ``SERVING_BUDGET_S`` and the
   script's within ``SCRIPT_BUDGET_S`` less the reserves of the phases
   after it in its lane (``PHASE_RESERVE_S``).
17. The chaos pack (``run_chaos_phase``), never cut short. 17a, bench
   config 15 whole (``bench.py:2460-2530``): ``rollout`` at scale 240,
   seed 7, under each of the five faults (``watch_flap``,
   ``watch_hang``, ``latency_spike``, ``failover``, ``clock_skew``) and
   clean (``--chaos none``) on the card and clean on the CPU, each its own
   ``trafficgen --chaos`` process, four at a time: every plan hash equal
   to the card's clean twin, which equals the CPU's; no plan emitted
   while a guard held, no NodeClaim written while deposed, every pod
   decided in tick order, a held tick under each holding fault, no fault
   of the serving logger; steady latency and SLO burn reported. 17b, the
   kernels under chaos, ``KARPENTER_TORCH_NATIVE=0``: ``run_chaos`` in
   this process, clean and under ``failover``, in config 15's world
   (hashes equal 17a's clean twin) and with the joined nodes labeled as
   their claims pin (the first-fit; equal to each other and to a CPU
   run); compat, the FFD scan and the first-fit launched under the
   fault, every captured call held to its plain version bit for bit,
   each distinct shape timed.
18. The operator (``run_operator_phase``), never cut short. 18a, bench
   config 2 whole (``bench.py:421-466``: 10,000 pods, 480 + 20 GPU
   types) under one ``Operator`` through ``reconcile_all_once`` on a
   stepped clock, admission on, a ``default`` pool and a tainted ``gpu``
   pool with a startup taint, a PDB over a tenth of the pods, the
   script's kubelet joining claims, removing startup taints, binding
   nominated pods and recreating evicted ones (``OperatorWorld``):
   provisioning, launch through the ``MetricsDecorator``, registration
   and initialization; a drifted gpu pool (an instance type excluded)
   and its replacement; a 60 % scale-down, consolidation (B8) and
   drains through the ``EvictionQueue``; an instance dropped from the
   provider and its claim collected; an orphaned node lease collected;
   disruption frozen and the last pods bound. With
   ``KARPENTER_TORCH_NATIVE=0`` on the card, then on the CPU (the plain
   versions; the C++ packer's plans differ from the scans' at this
   size): the store (claims, nodes, taints, bindings, leases, events,
   the nodeclaims/nodes/pods/disruption metric samples) equal after
   every pass, every pod bound once, no node over its allocatable, no
   PDB breach, all 14 controllers reconciled every pass with no error,
   ``/metrics`` well formed; every compat, FFD, first-fit and screen call
   held to its plain version bit for bit, each distinct shape timed.
   18b, ``Operator(...).start()`` with leader election, ephemeral ports
   and the serving pipeline in bench config 8's ``rollout`` world at
   scale 400 beside a follower on the same store: every route after the
   first decision, ``/debug/device`` 200, the follower writes nothing, a
   stop and a start that leads, decides and reconciles again, no
   orphaned span.
19. The fleet (``run_fleet_phase``), never cut short. 19a, bench config
   11 (``bench.py:1712-1948``) through the port's ``FleetRegistry``,
   ``FleetEngine`` and the default (C++) packer: catalog archetypes of
   64, 160 and 320 types with 12 GPU types each, 60 % of the tenants
   content twins, a burst then churn rounds of 10 % fresh arrivals,
   tenant 0's catalog bumped before round 1, the catalog cache at 2 ·
   tenants + 16; the two warm-up runs, the curve ({8, 32, 128} tenants ×
   200 pods and 8 × 1,000, 3 rounds; the 1,000-pod bursts at 32 and 128
   tenants are left out for the script's time), solo and batched, every cell's plans
   held batched against solo) and the identity runs (8 × 200): no tenant
   error, no library built or loaded in a steady round; pods/s, round
   ms, the dispatch stats and compat launches per engine reported. 19b,
   the identity run batched on the CPU, every tenant's plans every round
   equal the card's. 19c, ``KARPENTER_TORCH_NATIVE=0``: the identity
   world batched and solo on the card and batched on the CPU, then one
   round of it under ``KARPENTER_TORCH_PACK_BACKEND=lp`` the same three
   ways; plans equal across each group's legs and the FFD legs' equal to
   19a's; every captured compat, FFD
   and dual-ascent call held to its plain version bit for bit, each
   distinct shape timed; the FFD scan's launches per flush and jobs per
   launch, and at least one launch carrying two tenants' jobs. 19d,
   ``trafficgen --fleet 8 --scenario rollout --scale 200`` batched and
   solo on the card and batched on the CPU, each its own process: plan
   hashes equal, decisions monotonic, no orphaned span.
20. The device plane (``run_deviceplane_phase``; shape contracts are on
   for the whole run, and a breach fails the phase it fires in). 20a
   phase 5's cluster with ``KARPENTER_TORCH_NATIVE=0`` (compat, the FFD
   scan, the first-fit), a cold solve and a steady one; 20b bench config
   10 under lp, every shape cold and warm, its $/hr the JAX package's;
   20c bench config 4's decision at 1,000 nodes (phase 15 runs its
   5,000) in a device-time scope (the screens);
   20d the config 10 restart shape's warm solver snapshotted, restored in
   a fresh process, the boot prewarm, the first solve, then a first
   consolidation decision (config 4 at 300 nodes); 20e the slow-solve
   capture and a breach dump written to a temporary directory and read
   back; 20f one warm solve with the plane on against off, in turns.
   Checks: each kernel's launches as the plane reads them (the kernel's
   own counter) equal torch.profiler's count of its device function over
   a cluster solve, a fresh lp solve and a fresh decision (more in the
   trace fails, as does a kernel its run never launched; a trace that
   dropped events is retried, then reported "not measured"); compile events (library loads) equal the libraries loaded
   and the steady pass raises none; bytes moved at every boundary with
   device time (compat, pack, existing, lp, screen); the high-water mark
   between the largest footprint and the card's memory; a device block on
   every solve; the restored first solve and first decision load nothing
   (the screens' library comes into the boot prewarm only through the
   restored manifest) and the solve plans as the unkilled one; the files
   load back; on ≤ off × 1.25 + 2 ms. Then over the whole run's process:
   one load and one compile event per library, bytes at every boundary.

21. Bench config 12, the sharded mega-solve (``run_shard_phase``; a mesh
   is D shards of the one card, ``solver/sharding.py``). 21a
   ``shardbench.py``'s curve: 500,000 pods × 10,000 types at D ∈ {1, 2,
   4, 8}, 125,000, 250,000 and 1,000,000 pods at D = 8 and 500,000 ×
   2,000 at D = 8, each warm once then three measured runs (median wall,
   the four stage times, nodes, frontier rows, pods/s, the shard stats,
   B5's time from CUDA events around its launch, the shard boundary's
   device ms and bytes); every pod scheduled, every node within its
   type, one B5 launch a mega-solve. 21b the unchunked node ratio at
   20,000 pods × 10,000 types, three seeds, D = 8 (the two engines are
   one launch on one card; the CPU tests hold each to the JAX package);
   the 1,000,000-pod chunked launch against eight solo launches;
   ``TorchScheduler.solve`` on an 8-shard mesh, chunk threshold 64, on
   the card and the CPU: equal plans, ``last_shard_stats`` and the
   padding gauge set. 21d ``__graft_entry__.dryrun_multichip``'s sequence
   on an 8-shard mesh. 21c B5 through ``sharded_pod_pack`` (D = 1 and 8,
   4,096 pods), on the 125,000-pod cell's own first launch (8 × 15,625
   pods; its renumbered plain ids equal that run's node ids, every one)
   and through ``sharded_batch_pack``, B1 through ``allowed_sharded``
   (10,003 types padded to 8 shards) and B8's prefix screen through
   ``sharded_prefix_screen``, each against its plain version bit for bit
   and the CPU's result. Its reserve is what ``SCRIPT_BUDGET_S`` has
   left past its lane's later reserves, at most 100 s; with less than 100 s left, or past 60 % of it, a
   cell other than the anchor and the 1,000,000-pod one runs once,
   without its warm run.

22. The static-analysis plane (``run_analysis_phase``, within
   ``ANALYSIS_RESERVE_S``, kept out of its lane's earlier budgets). 22a
   ``python -m karpenter_core_tpu_torch.analysis --format json`` over the
   checkout in a process of its own: exit 0, no finding, no stale
   baseline entry, neither torch nor jax imported; files scanned,
   findings by disposition and seconds. 22b ``python -m
   karpenter_core_tpu_torch.witness --device cuda`` with the native
   packer off: the lock and knob witnesses over the serving pipeline at
   config 8's scale (prewarm, disruption stage), the batched fleet, an
   ``Operator.start()`` and a warm-store restore; observed lock edges ⊆
   the static order graph, observed knob reads ⊆ the static inventory,
   every required lock acquired, the compat and pack kernels launched;
   the edges, locks, knobs and launches per kernel. 22c ``python -m
   karpenter_core_tpu_torch.analysis --contracts --device cuda`` in a
   process of its own: every ``@contract`` at prime sizes on the card,
   the dispatching wrappers of B1 (``allowed``, ``allowed_via_kernel``,
   ``compat_via_kernel``), B5 (``ffd_pack``, ``ffd_pack_batched``) and B6
   (``pack_existing``) each launching its kernel and bit-equal to its
   plain version on the CPU, the reference's six checked contracts
   covered; each contract's sizes, verdict and launches.

23. The mesh across cards (``run_cards_phase``; ``solver/sharding.py``'s
   mesh as D shards over placements, one launch a placement, the
   collectives copies to the first). 23a, on the one card: bench config
   12's 125,000 × 10,000 cell with its D = 4 shards as four placements of
   the card, warm once then three measured runs, then ``allowed_sharded``
   over 21c's 10,003-type catalog and the folded
   ``sharded_prefix_screen``, the launches counted from 0 just before
   (B5 four a mega-solve, B1 four, B8 four); ids, node count, allowed
   matrix and screen bit-equal to phase 21's one placement holding the four
   shards; each placement's B5 (at 4,096 pods), B1 and B8 launch against
   its plain version on the card, and B1's library yardstick at the
   padded shape. 23b, only under ``--phases 23 --cards N``
   (``run_cards_across``, N cards of one host): bench config 12 at full
   width across the cards (``CARDS_CELLS``: 500,000 × 10,000 at D = 2 on
   2 cards, D = 4 and 8 on 4, 1,000,000 at D = 4 and 8 on 4), each warm
   once then three measured runs, nodes and frontier rows against the
   reference's record where it has one and node ids against the one-card
   mesh of the same D, each card's B5 ms and the boundary's; the
   dryrun's sequence over N cards held to the JAX package's numbers on N
   devices (``DRYRUN_REFERENCE``) and to one card's; an 8-shard
   ``TorchScheduler`` solve across the cards equal to the CPU's; solves
   on ``cuda:1`` alone while ``cuda:0`` is current (the cluster with the
   scans, config 5 under lp, config 4's consolidation) equal to
   ``cuda:0``'s, with every kernel's captured call held to its plain
   version there; each card's B1, B5 and B8 launch held to its plain
   version, and the gather's ms and bytes.

The lanes start once phase 3 is done, so that its timings have the card
and the host to themselves: phases 4-11 in this process, and 12, 13, 20,
22, 17; 15, 16, 23; 18, 14, 19, 21 each in a process of its own
(``--lane``), whose output this process relays once it ends; a lane that
fails fails the run. Each lane's torch takes its share of the host's
cores. The host's pace comes before phase 3: a fixed host-only probe
(``pace_probe_once``) against ``PACE_PROBE_FAST_S``. ``depth_plan`` keeps
full depth while the predicted script (``PHASE_FULL_S``: phases 1-3 and
the longest lane, times the pace) fits ``SCRIPT_BUDGET_S``, and else
cuts phases 4-16 to ``DEPTH_CUT``: fewer warm solves and profiles, kernel
case reps, config 7 ticks and 16b seeds, never a check or a comparison
with a plain version. A ``pace`` line before phase 3 prints the pace and
each cut, a ``pace_summary`` line before the kernels line each phase's
and each lane's seconds.

Then a ``{"kernels": [...]}`` line (the compat kernel's cases at the
shapes of phases 8–11 too, the three pack kernels and the disruption
screens; launches by path, phase 13's to 19's, 22's and 23's legs included),
and the last line ``{"ok": true, "device": {...}}``.
The profiled warm solves of phases 4–11 report device times only from
traces that hold every kernel launch of the solve (``profile_solve``).

Run from the repository root: ``python3 chip_smoke.py`` (``--log PATH``
appends every JSON line to PATH as well). ``--phases 16,17`` builds the
kernels as step 2 does, then runs only the named phases (of 14–23) in
this process, at full depth, and prints no result line; ``--phases 23
--cards N`` runs phase 23's 23b across N cards instead of 23a.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import json
import os
import pickle
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM published float32 rate outside the tensor cores: the yardstick
# of bound_ms, kept so rows stay comparable across revisions. The CUDA cores'
# 32-bit logic and compare rate is half of it (64 results per clock per
# SM, compute capability 9.0): alu_ceiling_ms uses that
FP32_OPS_PER_S = 67e12
N_SMS = 132
LOGIC_PER_CLOCK_PER_SM = 64
DEVICE_SLEEP_CYCLES = 20_000_000  # ~10 ms at 2 GHz: launches queue up behind it
# cycles of one dependent float32 add on the CUDA cores: the assumption of
# the B8 screens' chain_ms (a fixed-order sum is that many cycles a step)
FADD_CYCLES = 4
N_PODS = 50_000
N_TYPES = 2_000
# a path whose cold solve takes longer than this runs one warm solve, not
# three, and one whose warm solve does is not profiled: the script's time
# for phase 19
DEEP_SOLVE_MS = 2_000.0
SEED = 11  # bench.py config 3's RandomState
N_NODES = 1_000  # existing nodes of the cluster phase
NODE_SEED = 12
N_HA = 800  # phase 7's HA front end: one replica per node
# the NodePool example of Karpenter's documentation (Concepts → NodePools)
RESERVED_LIMITS = {"cpu": "1000", "memory": "1000Gi"}
N_CONFIG6 = 7_000  # bench.py config 6: pods, instance types, RandomState
N_CONFIG6_TYPES = 400
CONFIG6_SEED = 17
N_ANTI = 10_000  # bench.py config 13 anti_dense: pods, RandomState
ANTI_SEED = 13
N_ANTI_TYPES = 200  # the catalog config 13 builds
N_QUORUM = 6  # phase 9's zone quorum: three place, one per zone
N_STATEFUL = 10_000  # bench.py config 13 stateful_dense and spread_skew: pods
CSI_DRIVER = "ebs.csi.bench"  # the CSI driver of config 13's default StorageClass
N_REPLICAS = 50  # phase 10's stateful cluster: replicas of each of three StatefulSets
N_CONFIG1 = 1_000  # bench.py config 1: uniform pods
N_RELEASES = 10  # phase 11's Helm releases with the soft anti-affinity preset, and their
N_RELEASE_REPLICAS = 30  # replicas; requests drawn per release from RandomState(21)
RELEASE_SEED = 21
RELEASE_CHARTS = (
    "redis", "memcached", "rabbitmq", "kafka", "mongodb", "nginx", "keycloak", "elasticsearch",
    "mariadb", "minio",
)
DROUGHT_ZONE = "test-zone-3"  # phase 11's relax-cluster: every offering there unavailable
N_PARITY = 1_500  # bench.py config 6's stratified subsample for packing parity


# ``--log PATH``: every emitted line is appended there too (the output a
# caller keeps may hold only its end)
LOG_PATH: Optional[str] = None


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(json.dumps({"fail": msg}) + "\n")
    sys.exit(1)


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(line + "\n")


# -- the host's pace and the lanes ------------------------------------------------
#
# Phases 4-23 run in ``LANES`` once phase 3 is done: the first lane in this
# process, each other in a process of its own (``--lane``), all on the one
# card, so that phase 3's timings have the card and the host to themselves
# and the script's length is its longest lane's. A probe times a fixed
# host-only workload (``pace_probe_once``) before phase 3; its least time
# over ``PACE_PROBE_RUNS`` runs against ``PACE_PROBE_FAST_S`` is the host's
# pace. ``depth_plan(pace)`` keeps ``DEPTH_FULL`` while the predicted script
# (``predicted_s``) fits ``SCRIPT_BUDGET_S``, and else cuts phases 4-16 to
# ``DEPTH_CUT``: fewer warm solves, profiles, kernel-case reps, config 7
# ticks and 16b seeds. Every check and every comparison with a plain
# version stays.
PACE_PROBE_RUNS = 5
# the probe's least time on the calibration host, the machine of an NVIDIA
# H100 80GB HBM3, 700.00 W (chip_smoke.py's "pace" line, PERF.md §5): pace 1.0
PACE_PROBE_FAST_S = 0.6118
# phase 20 reads its own process's device plane after 12 and 13 moved
# bytes at every boundary; 16, the longest phase, has a lane with 15; 23
# follows 21, in the lane that ended first (PERF.md §5)
LANES = ((4, 5, 6, 7, 8, 9, 10, 11), (12, 13, 20, 22, 17), (15, 16), (18, 14, 19, 21, 23))
DEPTH_FULL = {"warm": 3, "profile_attempts": 3, "reps": 1.0, "config7_ticks": 20, "config7_native_off_ticks": 10,
              "config14_seeds": 3}
# config 7 keeps a mutating tick (every CONFIG7_MUTATE_EVERY = 10th) and its
# device-engine pass three ticks; 16b keeps its first seed; a timing keeps
# three reps
DEPTH_CUT = {"warm": 1, "profile_attempts": 0, "reps": 0.1, "config7_ticks": 11, "config7_native_off_ticks": 3,
             "config14_seeds": 1}
DEPTH = dict(DEPTH_FULL)  # the depth the running phase repeats at
DEPTH_PLAN: dict = {}  # the plan this run chose: its depth, pace and predicted seconds
# each phase's seconds at full depth, the lanes running, over the pace (so
# at pace 1.0), and a lane process's start before its first phase: the
# "pace_summary" line of a whole run on an NVIDIA H100 80GB HBM3, 700.00 W
# machine at pace 0.765, phase 22 (with 22c) of one at pace 1.300, phase 23
# (23a) of one at pace 0.985 (PERF.md §5)
PHASE_FULL_S = {
    1: 0.7, 2: 13.1, 3: 77.1, 4: 1.8, 5: 30.2, 6: 15.0, 7: 30.8, 8: 11.5, 9: 115.6, 10: 42.4, 11: 99.6, 12: 176.7,
    13: 52.3, 14: 70.4, 15: 103.5, 16: 272.8, 17: 33.2, 18: 88.2, 19: 82.7, 20: 27.3, 21: 75.9, 22: 36.7,
    23: 36.5,
}
LANE_START_S = 12.3


def pace_probe_once() -> float:
    """Seconds of a fixed host-only workload: pure Python (dicts, a sort,
    JSON, hashing) and single-threaded numpy, what the script's host
    work is made of."""
    t0 = time.perf_counter()
    rows = [{"name": f"pod-{i}", "cpu": (i * 7919) % 4000, "zone": f"zone-{i % 3}"} for i in range(100_000)]
    rows.sort(key=lambda r: (r["zone"], -r["cpu"], r["name"]))
    back = json.loads(json.dumps(rows))
    h = hashlib.sha256()
    for r in back[::7]:
        h.update(r["name"].encode())
    a = np.random.RandomState(0).rand(2_000, 500)
    for _ in range(5):
        a = np.cumsum(np.sort(a, axis=0), axis=1) / 500.0
    return time.perf_counter() - t0


def host_pace() -> tuple:
    """(the probe's least seconds over ``PACE_PROBE_RUNS`` runs, the
    pace: that over ``PACE_PROBE_FAST_S``)."""
    best = min(pace_probe_once() for _ in range(PACE_PROBE_RUNS))
    return best, best / PACE_PROBE_FAST_S


def predicted_s(pace: float) -> float:
    """The script's predicted seconds at full depth and ``pace``: phases
    1-3, then the longest lane (a lane process's start included), each
    phase as the calibration host took it, times the pace."""
    lanes = max(sum(PHASE_FULL_S[n] for n in lane) + (LANE_START_S if i else 0.0) for i, lane in enumerate(LANES))
    return pace * (PHASE_FULL_S[1] + PHASE_FULL_S[2] + PHASE_FULL_S[3] + lanes)


def depth_plan(pace: float, budget_s: Optional[float] = None) -> dict:
    """Full depth while ``predicted_s(pace)`` fits ``budget_s``
    (``SCRIPT_BUDGET_S``), else ``DEPTH_CUT`` → the depth, whether it cuts,
    the pace and the prediction at full depth."""
    budget_s = SCRIPT_BUDGET_S if budget_s is None else budget_s
    t = predicted_s(pace)
    return {**(DEPTH_CUT if t > budget_s else DEPTH_FULL), "cut": t > budget_s, "pace": pace, "predicted_s": t}


def phase_depth(n: int) -> dict:
    """Phase ``n``'s depth: the plan's for phases 4-16, else full."""
    plan = DEPTH_PLAN if DEPTH_PLAN and 4 <= n <= 16 else DEPTH_FULL
    return {k: plan[k] for k in DEPTH_FULL}


def cut_reps(reps: int) -> int:
    """``reps`` at the run's depth, never fewer than three."""
    return max(3, int(round(reps * DEPTH["reps"])))


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch

    reps = cut_reps(reps)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 3 helpers -------------------------------------------------------------


def random_planes(rng, S, T, widths, Z=3, C=2):
    keys = tuple(f"key-{i}" for i in range(len(widths)))
    sig = {"valid": rng.rand(S) > 0.1}
    tm, th, tn = {}, {}, {}
    for key, vk in zip(keys, widths):
        sig[f"mask:{key}"] = rng.rand(S, vk) > 0.6
        sig[f"has:{key}"] = rng.rand(S) > 0.3
        sig[f"neg:{key}"] = rng.rand(S) > 0.7
        tm[key] = rng.rand(T, vk) > 0.6
        th[key] = rng.rand(T) > 0.3
        tn[key] = rng.rand(T) > 0.7
    return dict(
        keys=keys, sig=sig, tm=tm, th=th, tn=tn,
        zone_ok=rng.rand(S, Z) > 0.3, ct_ok=rng.rand(S, C) > 0.3, avail=rng.rand(T, Z, C) > 0.5,
    )


def slice_planes(pools, provider, pods, kube=None):
    """The compat inputs the slice's solve builds (the first pool), from
    the port's own encode functions; with ``kube``, after the solve's
    PVC zone pins join the pods."""
    from karpenter_core_tpu_torch.solver import podcache
    from karpenter_core_tpu_torch.solver.encode import (
        encode_signature_for_pool,
        extend_encoded_masks,
        finalize_signature_masks,
        group_pods,
    )
    from karpenter_core_tpu_torch.solver.kernels import build_compat_inputs, zone_ct_masks
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
    if kube is not None:
        solver._inject_volume_zones(pods)
    groups = group_pods(pods, memos=podcache.get_memos(pods))
    enc_pools, catalogs = solver._build_pools()
    entry = solver._catalog_entry(catalogs[0])
    compats = [encode_signature_for_pool(g, enc_pools[0], entry.vocab) for g in groups]
    extend_encoded_masks(entry.enc, entry.vocab)
    finalize_signature_masks(compats, entry.vocab)
    enc = entry.enc
    zone_ok, ct_ok = zone_ct_masks(compats, enc)
    return dict(
        keys=tuple(sorted(enc.key_masks)),
        sig=build_compat_inputs(compats, enc, entry.vocab),
        tm=dict(enc.key_masks), th=dict(enc.key_has), tn=dict(enc.key_neg),
        zone_ok=zone_ok, ct_ok=ct_ok, avail=enc.offering_avail,
    )


def library_half(keys, sig, tm, th, tn, avail, zone_ok, ct_ok, dev) -> dict:
    """``library_allowed``'s inputs on ``dev``: the masks as fp16, the
    flags as bool, the zone x capacity-type pairs against the offerings."""
    import torch

    S, T = sig["valid"].shape[0], avail.shape[0]
    half = {"valid": torch.from_numpy(sig["valid"]).to(dev)}
    for key in keys:
        half[f"mask:{key}"] = torch.from_numpy(sig[f"mask:{key}"]).to(dev).half()
        half[f"type:{key}"] = torch.from_numpy(tm[key]).to(dev).half()
        half[f"has:{key}"] = torch.from_numpy(sig[f"has:{key}"]).to(dev)
        half[f"neg:{key}"] = torch.from_numpy(sig[f"neg:{key}"]).to(dev)
        half[f"thas:{key}"] = torch.from_numpy(th[key]).to(dev)
        half[f"tneg:{key}"] = torch.from_numpy(tn[key]).to(dev)
    half["pair"] = torch.from_numpy((zone_ok[:, :, None] & ct_ok[:, None, :]).reshape(S, -1)).to(dev).half()
    half["avail"] = torch.from_numpy(avail.reshape(T, -1)).to(dev).half()
    return half


def library_allowed(half, keys, offering: bool = True):
    """The same function as per-key fp16 torch.matmul calls (exact: 0/1
    products summed in fp32, tested > 0); without the offering leg it is
    compat ∧ valid. Timed as a yardstick only."""
    import torch

    valid = half["valid"]
    S, T = valid.shape[0], half["avail"].shape[0]
    ok = valid[:, None].expand(S, T).clone()
    for key in keys:
        overlap = torch.matmul(half[f"mask:{key}"], half[f"type:{key}"].T) > 0
        both_has = half[f"has:{key}"][:, None] & half[f"thas:{key}"][None, :]
        both_neg = half[f"neg:{key}"][:, None] & half[f"tneg:{key}"][None, :]
        ok &= ~both_has | overlap | both_neg
    return ok & (torch.matmul(half["pair"], half["avail"].T) > 0) if offering else ok


def raw_kernel_ms(catalog, planes, tile: int, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back launches of the wrapper's
    launch alone (no allocation, no plain version), queued behind a device
    sleep so the host's enqueue time is hidden → ms per launch."""
    import torch

    reps = cut_reps(reps)
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    out = torch.empty((planes.shape[1], catalog.n_types), dtype=torch.uint8, device=planes.device)
    for _ in range(3):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(DEVICE_SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernel_ms(catalog, planes, tile: int, reps: int):
    """The kernel's device time per launch from torch.profiler over
    ``reps`` launches, or "not measured" where the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    reps = cut_reps(reps)
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    out = torch.empty((planes.shape[1], catalog.n_types), dtype=torch.uint8, device=planes.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
        torch.cuda.synchronize()
    us, calls = 0.0, 0
    for evt in prof.key_averages():
        if "compat_allowed_" in evt.key and "_kernel" in evt.key:
            us += float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
            calls += int(evt.count)
    return us / 1000.0 / calls if us > 0.0 and calls else "not measured"


def sm_clock_under_load(catalog, planes, tile: int, launches: int) -> list:
    """``nvidia-smi`` SM clock and power samples while ``launches``
    queued launches keep the card busy."""
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    out = torch.empty((planes.shape[1], catalog.n_types), dtype=torch.uint8, device=planes.device)
    for _ in range(launches):
        ck.COMPAT_ALLOWED.launch(planes, catalog, out, tile=tile)
    samples = []
    for _ in range(3):
        time.sleep(0.05)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        samples.append(smi.stdout.strip())
    torch.cuda.synchronize()
    return samples


def kernel_case(
    label: str, planes: dict, reps: int, plain_reps: int, sm_mhz: float, device="cuda",
    profiled: bool = False, clock_launches: int = 0,
) -> dict:
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import kernels as pk

    dev = torch.device(device)
    keys, sig = planes["keys"], planes["sig"]
    tm, th, tn = planes["tm"], planes["th"], planes["tn"]
    zone_ok, ct_ok, avail = planes["zone_ok"], planes["ct_ok"], planes["avail"]
    catalog = ck.catalog_to_device(tm, th, tn, keys, avail, dev)
    side = ck.signature_side(sig, zone_ok, ct_ok, catalog)
    W, S = side.shape
    T, K = catalog.n_types, len(catalog.layout.keys)

    got = ck.allowed_via_kernel(side, catalog)
    plain = ck.allowed_packed_reference(side, catalog.planes, catalog.layout)
    semantic = pk.allowed_reference(
        pk.to_tensors(sig, dev), pk.to_tensors(tm, dev), pk.to_tensors(th, dev),
        pk.to_tensors(tn, dev), torch.from_numpy(zone_ok).to(dev),
        torch.from_numpy(ct_ok).to(dev), torch.from_numpy(avail).to(dev), keys,
    )
    compat = ck.compat_via_kernel(sig, tm, th, tn, keys, dev)
    compat_plain = pk.compat_reference(
        pk.to_tensors(sig, dev), pk.to_tensors(tm, dev), pk.to_tensors(th, dev),
        pk.to_tensors(tn, dev), keys,
    )
    forced = {}
    for tile in (ck.TILE_SMALL, ck.TILE_LARGE):
        out = torch.full((S, T), 7, dtype=torch.uint8, device=dev)
        ck.COMPAT_ALLOWED.launch(side, catalog, out, tile=tile)
        forced[tile] = out
    half = library_half(keys, sig, tm, th, tn, avail, zone_ok, ct_ok, dev)
    library = library_allowed(half, keys)

    err = 0
    for name, a, b in (
        ("kernel vs packed plain", got, plain),
        ("kernel vs plain allowed_reference", got, semantic),
        ("small tile vs packed plain", forced[ck.TILE_SMALL], plain),
        ("large tile vs packed plain", forced[ck.TILE_LARGE], plain),
        ("compat_via_kernel vs compat_reference", compat, compat_plain),
        ("library yardstick vs kernel", library, got),
    ):
        if a.shape != b.shape:
            fail(f"{label}: {name}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
        diff = int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item()) if a.numel() else 0
        if diff:
            fail(f"{label}: {name} disagree (max abs err {diff})")
        err = max(err, diff)

    tile = ck.tile_for(S)
    tile_ms = {
        name: raw_kernel_ms(catalog, side, t, reps)
        for name, t in (("small", ck.TILE_SMALL), ("large", ck.TILE_LARGE))
    }
    wrapper_ms = median_ms(lambda: ck.allowed_via_kernel(side, catalog), reps)
    plain_ms = median_ms(
        lambda: ck.allowed_packed_reference(side, catalog.planes, catalog.layout), plain_reps
    )
    library_ms = median_ms(lambda: library_allowed(half, keys), plain_reps)
    # least time: each input read once, the output written once; the
    # operations are one AND and one OR per (s, t, word) at the published
    # float32 rate (the reckoning of the kernel's first revision, kept comparable)
    nbytes = (S + T) * W * 4 + (K + 1) * 4 + S * T
    ops = 2 * S * T * W
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    # the CUDA cores' own ceiling: one LOP3 per cell-word, one IMNMX per cell-key
    alu_ceiling_ms = S * T * (W + K) / (N_SMS * LOGIC_PER_CLOCK_PER_SM * sm_mhz * 1e6) * 1e3
    row = dict(
        shape=label, S=int(S), T=int(T), W=int(W), K=int(K),
        tile="small" if tile == ck.TILE_SMALL else "large",
        kernel_ms=tile_ms["small" if tile == ck.TILE_SMALL else "large"],
        kernel_ms_small_tile=tile_ms["small"], kernel_ms_large_tile=tile_ms["large"],
        wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        alu_ceiling_ms=alu_ceiling_ms,
        bytes=int(nbytes), ops=int(ops), max_abs_err=err,
    )
    if profiled:
        row["profiled_kernel_ms"] = profiled_kernel_ms(catalog, side, tile, reps)
        # the compat route (compat_via_kernel): the same kernel on an
        # all-ones offering chunk, against compat_reference and the
        # library yardstick without the offering leg
        ones_cat = ck.catalog_to_device(tm, th, tn, keys, np.ones((T, 1, 1), dtype=bool), dev)
        ones_side = ck.signature_side(
            sig, np.ones((S, 1), dtype=bool), np.ones((S, 1), dtype=bool), ones_cat
        )
        cW = ones_side.shape[0]
        t_sig, t_tm = pk.to_tensors(sig, dev), pk.to_tensors(tm, dev)
        t_th, t_tn = pk.to_tensors(th, dev), pk.to_tensors(tn, dev)
        c_bytes = (S + T) * cW * 4 + (K + 1) * 4 + S * T
        c_bytes_ms = c_bytes / HBM_BYTES_PER_S * 1e3
        c_ops_ms = 2 * S * T * cW / FP32_OPS_PER_S * 1e3
        row["compat_route"] = dict(
            W=int(cW),
            kernel_ms=raw_kernel_ms(ones_cat, ones_side, tile, reps),
            plain_ms=median_ms(lambda: pk.compat_reference(t_sig, t_tm, t_th, t_tn, keys), plain_reps),
            library_ms=median_ms(lambda: library_allowed(half, keys, offering=False), plain_reps),
            bound_ms=max(c_bytes_ms, c_ops_ms),
            bound_by="bytes" if c_bytes_ms >= c_ops_ms else "operations",
            alu_ceiling_ms=S * T * (cW + K) / (N_SMS * LOGIC_PER_CLOCK_PER_SM * sm_mhz * 1e6) * 1e3,
        )
    if clock_launches:
        row["sm_clock_under_load"] = sm_clock_under_load(catalog, side, tile, clock_launches)
    emit({"kernel_case": row})
    return row


def profiler_probe(catalog, planes, sessions: int = 4) -> dict:
    """What torch.profiler records of the wrapper's launches, against
    what the launch counter saw, in the ways a profiled solve can meet
    them: ``n`` back-to-back ``allowed_via_kernel`` launches with their
    host copies, in fresh sessions (``plain``), each after a short
    session of its own (``after_session``), with a synchronize between
    launches (``sync_between``), with ``acc_events`` (``acc_events``), a
    torch kernel beside them (``torch_op``: its ``add`` events), 100 ms
    of host work before each launch (``host_busy``), and as a solve
    issues them: all launches queued, 100 ms of host work, then the host
    copies (``queued``).
    → per variant and ``n``, the kernel events each session held."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x = torch.ones(1024, device="cuda")

    def host_work(seconds: float) -> None:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pass

    def session(n: int, variant: str) -> list:
        kw = {"acc_events": True} if variant == "acc_events" else {}
        if variant == "after_session":
            with profile(activities=acts):
                x.add_(1)
                torch.cuda.synchronize()
        with profile(activities=acts, **kw) as prof:
            if variant == "queued":
                outs = [ck.allowed_via_kernel(planes, catalog) for _ in range(n)]
                host_work(0.1)
                for out in outs:
                    out.cpu()
            for _ in range(0 if variant == "queued" else n):
                if variant == "host_busy":
                    host_work(0.1)
                ck.allowed_via_kernel(planes, catalog).cpu()
                if variant == "sync_between":
                    torch.cuda.synchronize()
                if variant == "torch_op":
                    x.add_(1)
            torch.cuda.synchronize()
        kernels = adds = 0
        for evt in prof.key_averages():
            if "compat_allowed_" in evt.key and "_kernel" in evt.key:
                kernels += int(evt.count)
            if float(getattr(evt, "self_device_time_total", 0.0) or 0.0) > 0 and "add" in evt.key.lower():
                adds += int(evt.count)
        return [kernels, adds] if variant == "torch_op" else kernels

    out = {}
    for variant in (
        "plain", "after_session", "sync_between", "acc_events", "torch_op", "host_busy", "queued",
    ):
        for n in (1, 2, 4):
            try:
                out[f"{variant} n={n}"] = [session(n, variant) for _ in range(sessions)]
            except TypeError as e:  # a torch without acc_events
                out[f"{variant} n={n}"] = f"not run: {e}"
    return out


def ptxas_usage(log: str) -> dict:
    """Registers, shared memory and spills per kernel from nvcc -Xptxas=-v."""
    usage, name = {}, None
    for line in log.splitlines():
        for tag in ("compat_allowed_small_kernel", "compat_allowed_large_kernel"):
            if tag in line:
                name = tag
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            usage.setdefault(name, {}).update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    return usage


# -- phase 4: the slice ----------------------------------------------------------


def slice_world(n_pods: int = N_PODS, n_types: int = N_TYPES, spread: bool = False):
    """bench.py config 3 (RandomState(11), 50k pods, instance_types(2000),
    NodePool "default"). Without ``spread`` (phases 4 and 5) it drops the
    topology-spread share: residues 5 and 6 become plain pods, so the
    count stays 50,000. With it (``config3_world``) residues 5 and 6
    carry config 3's zone spread: max_skew 1, DoNotSchedule, selector
    ``app=svc-{i % 9}``."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.objects import (
        Container,
        LabelSelector,
        Pod,
        PodCondition,
        PodSpec,
        ResourceRequirements,
        Toleration,
        TopologySpreadConstraint,
    )
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    rng = np.random.RandomState(SEED)
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    pods = []
    for i in range(n_pods):
        r = i % 9
        cpu = ["100m", "250m", "500m", "1", "1500m", "2"][rng.randint(6)]
        mem = ["128Mi", "256Mi", "512Mi", "1Gi", "2Gi"][rng.randint(5)]
        pod = Pod()
        pod.metadata.name = f"bench-{i}"
        pod.metadata.labels = {"app": f"svc-{r}"}
        requests = {"cpu": parse_quantity(cpu), "memory": parse_quantity(mem)}
        pod.spec = PodSpec(
            containers=[Container(name="main", resources=ResourceRequirements(requests=requests))]
        )
        if r < 3:
            pod.spec.node_selector = {wk.CAPACITY_TYPE_LABEL_KEY: ["spot", "on-demand"][i % 2]}
        elif r < 5:
            pod.spec.tolerations = [Toleration(key="dedicated", operator="Exists")]
        elif r < 7 and spread:
            pod.spec.topology_spread_constraints = [
                TopologySpreadConstraint(
                    max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector(match_labels={"app": f"svc-{r}"}),
                )
            ]
        pod.status.conditions = [
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        ]
        pods.append(pod)
    return [nodepool], provider, pods


def config3_world(n_pods: int = N_PODS, n_types: int = N_TYPES):
    """bench.py config 3 whole (``bench.py:469``): its 2/9 zone-spread
    share included, nothing reduced."""
    return slice_world(n_pods, n_types, spread=True)


def plan_stream(res) -> list:
    return [
        (p.nodepool_name, p.instance_type.name, p.zone, p.capacity_type, p.price, list(p.pod_indices))
        for p in res.node_plans
    ]


def check_invariants(res, pods) -> None:
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.scheduling import resources

    seen = set()
    for plan in res.node_plans:
        for i in plan.pod_indices:
            if i in seen:
                fail(f"pod {i} is planned twice")
            seen.add(i)
        if not resources.fits(plan.requests, plan.instance_type.allocatable()):
            fail(f"plan on {plan.instance_type.name} overflows its allocatable")
        offering = plan.instance_type.offerings.get(plan.capacity_type, plan.zone)
        if offering is None or not offering.available or offering.price != plan.price:
            fail(f"plan on {plan.instance_type.name} names no available offering at {plan.price}")
        for i in plan.pod_indices:
            want = pods[i].spec.node_selector.get(wk.CAPACITY_TYPE_LABEL_KEY)
            if want is not None and want != plan.capacity_type:
                fail(f"pod {i} selects {want} but lands on {plan.capacity_type}")
    greedy = set(oracle_placements(res, pods))
    if seen & greedy:
        fail(f"{len(seen & greedy)} pods are planned by both the tensor path and the greedy fallback")
    seen |= greedy
    errored = {i for i, p in enumerate(pods) if p.uid in res.pod_errors}
    if seen & errored or len(seen | errored) != len(pods):
        fail(f"{len(pods) - len(seen | errored)} pods neither planned nor errored")


def _profile_once(solver, pods, after_session: bool = False, **solve_kw) -> dict:
    """One warm solve under torch.profiler (``after_session``: right
    after a short session of its own) → wall ms, the device's busy time
    (sum of self device time over every event), the compat kernel's
    device time and calls, and the launches the wrapper's counter saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    if after_session:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    counted_before = ck.COMPAT_ALLOWED.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(pods, **solve_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    busy_us = kernel_us = 0.0
    kernel_calls = device_events = 0
    for evt in prof.key_averages():
        dev_us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        busy_us += dev_us
        device_events += int(evt.count) if dev_us > 0.0 else 0
        if "compat_allowed_" in evt.key and "_kernel" in evt.key:
            kernel_us += dev_us
            kernel_calls += int(evt.count)
    return dict(
        wall_ms=wall_ms, busy_us=busy_us, kernel_us=kernel_us, kernel_calls=kernel_calls,
        device_events=device_events, counted=ck.COMPAT_ALLOWED.launches - counted_before,
    )


def _try_summary(got: dict) -> dict:
    return {
        k: got[k]
        for k in ("after_session", "wall_ms", "device_events", "busy_us", "kernel_calls", "counted")
    }


def profile_solve(solver, pods, attempts: int = 3, **solve_kw) -> dict:
    """A warm solve under torch.profiler: the device's busy time, the
    compat kernel's device time and the idle share of the solve's wall
    time. A trace is complete when it holds every kernel launch the
    wrapper's counter saw in that solve; an incomplete one is retried up
    to ``attempts`` times. If none is complete the numbers are "not
    measured", and a ``profiler_gap`` line before the phase's line says
    what each attempt recorded: a run prints no device time the profiler
    did not record in full. After a warm solve past ``DEEP_SOLVE_MS`` none
    is made (such paths are host-bound: every one profiled before read an
    idle share of 0.9999 or more). The run's depth caps the attempts; at
    none, no profile is made either."""
    attempts = min(attempts, DEPTH["profile_attempts"])
    if attempts == 0 or (solver.last_timings or {}).get("total_ms", 0.0) > DEEP_SOLVE_MS:
        return {key: "not measured" for key in (
            "profiled_wall_ms", "device_busy_ms", "device_idle_share", "kernel_device_ms_per_launch")}
    tries = []
    for attempt in range(attempts):
        got = _profile_once(solver, pods, after_session=attempt % 2 == 1, **solve_kw)
        got["after_session"] = attempt % 2 == 1
        tries.append(got)
        if got["busy_us"] > 0.0 and got["counted"] and got["kernel_calls"] == got["counted"]:
            return {
                "profile_tries": [_try_summary(t) for t in tries],
                "profiled_wall_ms": got["wall_ms"],
                "device_busy_ms": got["busy_us"] / 1000.0,
                "device_idle_share": 1.0 - got["busy_us"] / 1000.0 / got["wall_ms"],
                "kernel_device_ms_per_launch": got["kernel_us"] / 1000.0 / got["kernel_calls"],
                "kernel_launches_profiled": got["kernel_calls"],
                "kernel_launches_counted": got["counted"],
            }
    emit({
        "profiler_gap": (
            "no trace of this solve held every compat kernel launch the wrapper counted; "
            "its device times are not measured"
        ),
        "attempts": [_try_summary(t) for t in tries],
    })
    return {
        "profiled_wall_ms": tries[-1]["wall_ms"],
        "device_busy_ms": "not measured",
        "device_idle_share": "not measured",
        "kernel_device_ms_per_launch": "not measured",
        "kernel_launches_counted": tries[-1]["counted"],
    }


def warm_depth(ms: float) -> int:
    """Warm solves a path gets after a cold solve of ``ms``: the run's
    depth (three on a fast host), or one past ``DEEP_SOLVE_MS``."""
    return DEPTH["warm"] if ms <= DEEP_SOLVE_MS else 1


def solve_runs(solver, pods, **solve_kw):
    """One cold solve and ``warm_depth(cold ms)`` warm ones, with the
    kernel's launches counted from 0 just before and read just after →
    (cold result, cold ms, [(warm ms, last_timings)], launches). Fails if a
    warm solve changes the plans."""
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    ck.COMPAT_ALLOWED.launches = 0
    t0 = time.perf_counter()
    cold = solver.solve(pods, **solve_kw)
    cold_ms = (time.perf_counter() - t0) * 1000.0
    warm_runs = []
    for _ in range(warm_depth(cold_ms)):
        t0 = time.perf_counter()
        warm = solver.solve(pods, **solve_kw)
        warm_runs.append(((time.perf_counter() - t0) * 1000.0, dict(solver.last_timings)))
        if (plan_stream(warm), existing_stream(warm), warm.pod_errors) != (
            plan_stream(cold), existing_stream(cold), cold.pod_errors
        ):
            fail("a warm solve changed the plans")
    return cold, cold_ms, warm_runs, ck.COMPAT_ALLOWED.launches


def timing_row(cold, cold_ms, warm_runs, launches) -> dict:
    warm_ms = statistics.median(ms for ms, _ in warm_runs)
    return {
        "pods_per_s": cold.pods_scheduled / (warm_ms / 1000.0),
        "cold_ms": cold_ms,
        "warm_ms": warm_ms,
        "warm_runs_ms": [ms for ms, _ in warm_runs],
        "device_ms": statistics.median(t["device_ms"] for _, t in warm_runs),
        "host_ms": statistics.median(t["host_ms"] for _, t in warm_runs),
        "warm_phases_ms": {
            k: statistics.median(t[k] for _, t in warm_runs) for k in warm_runs[0][1] if k.endswith("_ms")
        },
        "pods_scheduled": cold.pods_scheduled,
        "pod_errors": len(cold.pod_errors),
        "pod_error_kinds": sorted({e.split(":")[0] for e in cold.pod_errors.values()}),
        "nodes": cold.node_count,
        "total_price": cold.total_price,
        "solves": 1 + len(warm_runs),
        "kernel_launches": launches,
    }


def same_as_cpu(res, cpu, what: str) -> None:
    if plan_stream(cpu) != plan_stream(res):
        fail(f"{what}: the plans differ between cuda and cpu")
    if existing_stream(cpu) != existing_stream(res):
        fail(f"{what}: the existing plans differ between cuda and cpu")
    if cpu.pod_errors != res.pod_errors:
        fail(f"{what}: the pod errors differ between cuda and cpu")


# -- phase 5: the cluster --------------------------------------------------------


def cluster_world(n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES):
    """The slice's pods against a live cluster → (nodepools, provider,
    pods, state_nodes, daemonset_pods, missing): ``missing`` maps each
    node name to the requests of the daemons it should run but does not.

    - NodePools ``reserved`` (weight 10, RESERVED_LIMITS) and ``default``
      (weight 0, no limits).
    - ``n_nodes`` initialized nodes from RandomState(12): type
      ``fake-it-k`` with k uniform in 7..31 (8–32 vCPU), zones
      ``test-zone-1..3`` round-robin, capacity type alternating, every
      50th node in ``reserved`` (20 of 1,000), every 4th tainted
      ``dedicated=true:NoSchedule``; bound pods filling 40–80 % of the
      CPU allocatable, plus the daemon pods the node runs, with ``cni``
      missing on every 10th node.
    - Daemonsets ``cni`` (100m / 64Mi, tolerates everything), ``logs``
      (200m / 256Mi) and ``exporter`` (50m / 32Mi, on-demand nodes only).
    """
    return _cluster_world(n_pods, n_types, n_nodes)[:6]


def cluster_spread_world(
    n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_ha: int = N_HA
):
    """``cluster_world`` with bench config 3's pods whole, an HA front
    end rolling out, and the cluster in a kube store → (nodepools,
    provider, pods, state_nodes, daemonset_pods, missing, kube):

    - the pending pods are ``config3_world``'s, then ``n_ha`` pods
      ``app=ha-web`` (250m / 256Mi) with a self-selecting hostname spread
      (max_skew 1, DoNotSchedule): one replica per node;
    - the bound worker pods on ``test-zone-1`` nodes carry ``app=svc-5``,
      so svc-5's zone seeds are skewed;
    - every 5th node also runs one bound ``app=ha-web`` pod;
    - ``kube`` holds every node and every bound pod, daemons included.
    """
    return _cluster_world(n_pods, n_types, n_nodes, n_ha=n_ha)


def _cluster_world(
    n_pods: int, n_types: int, n_nodes: int, n_ha: Optional[int] = None, store: bool = False
):
    """The cluster of phases 5, 7 and 9 (``n_ha`` None: phase 5's, with a
    kube store when ``store``); the random draws are the same either
    way."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import (
        Container,
        LabelSelector,
        Node,
        OwnerReference,
        Pod,
        PodCondition,
        PodSpec,
        ResourceRequirements,
        Taint,
        Toleration,
        TopologySpreadConstraint,
    )
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.scheduling import Taints, resources
    from karpenter_core_tpu_torch.state import StateNode

    spread = n_ha is not None
    pools, provider, pods = slice_world(n_pods, n_types, spread=spread)
    kube = KubeClient() if spread or store else None
    default = pools[0]
    default.spec.weight = 0
    reserved = NodePool()
    reserved.metadata.name = "reserved"
    reserved.spec.weight = 10
    reserved.spec.limits = {k: parse_quantity(v) for k, v in RESERVED_LIMITS.items()}

    def pod(name, cpu, mem, node_name="", daemonset=False, tolerations=(), selector=None, labels=None):
        p = Pod()
        p.metadata.name = name
        p.metadata.labels = dict(labels or {})
        if daemonset:
            p.metadata.owner_references = [OwnerReference(kind="DaemonSet", name=name)]
        p.spec = PodSpec(
            node_name=node_name,
            node_selector=dict(selector or {}),
            tolerations=list(tolerations),
            containers=[
                Container(
                    name="main",
                    resources=ResourceRequirements(
                        requests={"cpu": parse_quantity(cpu), "memory": parse_quantity(mem)}
                    ),
                )
            ],
        )
        p.status.phase = "Running" if node_name else "Pending"
        return p

    daemon_specs = (
        ("cni", "100m", "64Mi", (Toleration(operator="Exists"),), None),
        ("logs", "200m", "256Mi", (), None),
        ("exporter", "50m", "32Mi", (), {wk.CAPACITY_TYPE_LABEL_KEY: wk.CAPACITY_TYPE_ON_DEMAND}),
    )
    daemons = [
        pod(name, cpu, mem, daemonset=True, tolerations=tol, selector=sel)
        for name, cpu, mem, tol, sel in daemon_specs
    ]
    daemon_requests = {name: (cpu, mem) for name, cpu, mem, _, _ in daemon_specs}
    dedicated = Taint(key="dedicated", value="true", effect="NoSchedule")
    rng = np.random.RandomState(NODE_SEED)
    catalog = provider.instance_types
    cpus = ["250m", "500m", "1", "2"]
    mems = ["256Mi", "512Mi", "1Gi", "2Gi"]
    nodes, missing = [], {}
    for m in range(n_nodes):
        it = catalog[int(rng.randint(7, 32))]
        name = f"node-{m:04d}"
        ct = (wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND)[m % 2]
        node = Node()
        node.metadata.name = name
        node.metadata.labels = {
            wk.NODEPOOL_LABEL_KEY: "reserved" if m % 50 == 0 else "default",
            wk.NODE_REGISTERED_LABEL_KEY: "true",
            wk.NODE_INITIALIZED_LABEL_KEY: "true",
            wk.LABEL_HOSTNAME: name,
            wk.LABEL_INSTANCE_TYPE: it.name,
            wk.LABEL_TOPOLOGY_ZONE: f"test-zone-{m % 3 + 1}",
            wk.CAPACITY_TYPE_LABEL_KEY: ct,
            wk.LABEL_ARCH: "amd64",
            wk.LABEL_OS: "linux",
        }
        node.spec.provider_id = f"fake:///{name}"
        node.spec.taints = [dedicated] if m % 4 == 0 else []
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = it.allocatable()
        sn = StateNode(node=node)
        bound = []
        worker_labels = (
            {"app": "svc-5"} if spread and node.metadata.labels[wk.LABEL_TOPOLOGY_ZONE] == "test-zone-1" else {}
        )
        target = node.status.allocatable["cpu"] * rng.uniform(0.4, 0.8)
        used, j = 0, 0
        while True:
            c, mem = cpus[rng.randint(len(cpus))], mems[rng.randint(len(mems))]
            if used + parse_quantity(c) > target:
                break
            bound.append(pod(f"{name}-w{j}", c, mem, node_name=name, labels=worker_labels))
            used += parse_quantity(c)
            j += 1
        if spread and m % 5 == 0:
            bound.append(pod(f"{name}-ha", "250m", "256Mi", node_name=name, labels={"app": "ha-web"}))
        runs = [
            d
            for d in daemons
            if Taints(node.spec.taints).tolerates(d) is None
            and all(node.metadata.labels.get(k) == v for k, v in d.spec.node_selector.items())
        ]
        absent = runs[:1] if m % 10 == 0 else []  # cni, which every node runs
        for d in runs[len(absent):]:
            cpu, mem = daemon_requests[d.name]
            bound.append(pod(f"{name}-{d.name}", cpu, mem, node_name=name, daemonset=True))
        for p in bound:
            sn.update_for_pod(p)
        if kube is not None:
            kube.create(node)
            for p in bound:
                kube.create(p)
        missing[name] = resources.requests_for_pods(*absent) if absent else {}
        nodes.append(sn)
    for k in range(n_ha or 0):
        p = pod(f"ha-web-{k}", "250m", "256Mi", labels={"app": "ha-web"})
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(
                max_skew=1, topology_key=wk.LABEL_HOSTNAME, when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={"app": "ha-web"}),
            )
        ]
        p.status.conditions = [
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")
        ]
        pods.append(p)
    return [reserved, default], provider, pods, nodes, daemons, missing, kube


def existing_stream(res) -> list:
    return [(e.state_node.name(), list(e.pod_indices)) for e in res.existing_plans]


def check_cluster(res, pods, nodes, daemons, missing, spill: bool = True, pools=()) -> dict:
    """Fail unless the cluster solve's plans hold: every pod placed,
    planned or errored exactly once (the greedy fallback's placements
    included); each existing node's placements, over every plan that
    names it, plus its bound pods and its missing daemons fit its
    allocatable; each new node's pods plus its daemons fit its type;
    ``reserved``'s new nodes from the tensor path stay within its limits
    and, with ``spill`` (the 50k-pod worlds, whose new nodes outgrow its
    limits), some pods spill to ``default``. A new node of a pool in
    ``pools`` runs the daemons that tolerate the pool's taints; other new
    nodes run every daemon. The greedy fallback's claims in ``reserved``
    are reported beside the limit, not held to it: the greedy scheduler
    starts from the pools' limits less the existing nodes, without the
    tensor path's new nodes, as the JAX package's does."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.scheduling import Taints, resources

    index = {p.uid: i for i, p in enumerate(pods)}
    placed = [(("new", i), p.pod_indices) for i, p in enumerate(res.node_plans)] + [
        (("existing", e.state_node.name()), e.pod_indices) for e in res.existing_plans
    ]
    greedy = res.oracle_results
    if greedy is not None:
        placed += [(("claim", n), [index[p.uid] for p in c.pods]) for n, c in enumerate(greedy.new_node_claims)]
        placed += [
            (("existing", e.name()), [index[p.uid] for p in e.pods]) for e in greedy.existing_nodes if e.pods
        ]
    seen = {}
    on_node = {}
    for where, members in placed:
        for i in members:
            if i in seen:
                fail(f"pod {i} is placed twice: {seen[i]} and {where}")
            seen[i] = where
        if where[0] == "existing":
            on_node.setdefault(where[1], []).extend(members)
    errored = {i for i, p in enumerate(pods) if p.uid in res.pod_errors}
    if set(seen) & errored or len(set(seen) | errored) != len(pods):
        fail(f"{len(pods) - len(set(seen) | errored)} pods neither placed, planned nor errored")
    by_name = {sn.name(): sn for sn in nodes}
    for name, members in on_node.items():
        sn = by_name[name]
        load = resources.merge(*(resources.requests_for_pods(pods[i]) for i in members), missing[name])
        if not resources.fits(load, sn.available()):
            fail(f"existing node {name} is overcommitted by its placements")
        taints = Taints(sn.taints())
        if any(taints.tolerates(pods[i]) is not None for i in members):
            fail(f"a pod on {name} does not tolerate its taints")
    # no pool carries a capacity-type requirement: a new node runs every
    # daemon its pool's taints admit
    taints = {p.name: Taints(p.spec.template.taints) for p in pools}
    for plan in res.node_plans:
        pool_taints = taints.get(plan.nodepool_name)
        overhead = resources.requests_for_pods(
            *(d for d in daemons if pool_taints is None or pool_taints.tolerates(d) is None)
        )
        if not resources.fits(resources.merge(plan.requests, overhead), plan.instance_type.allocatable()):
            fail(f"plan on {plan.instance_type.name} overflows its allocatable with its daemons")
    used = resources.merge(
        *(sn.capacity() for sn in nodes if sn.labels().get(wk.NODEPOOL_LABEL_KEY) == "reserved"),
        *(p.instance_type.capacity for p in res.node_plans if p.nodepool_name == "reserved"),
    )
    for k, v in RESERVED_LIMITS.items():
        if used.get(k, 0) > parse_quantity(v):
            fail(f"reserved uses {used.get(k, 0)} {k}, over its limit {v}")
    # the greedy claims' largest option is what its limit tracking charges
    greedy_reserved = resources.merge(
        *(
            resources.max_resources(*(it.capacity for it in c.instance_type_options))
            for c in (greedy.new_node_claims if greedy is not None else ())
            if c.nodepool_name == "reserved"
        )
    )
    per_pool = {}
    for p in res.node_plans:
        per_pool.setdefault(p.nodepool_name, [0, 0])
        per_pool[p.nodepool_name][0] += 1
        per_pool[p.nodepool_name][1] += len(p.pod_indices)
    if spill and per_pool.get("default", [0, 0])[1] == 0:
        fail("no pod spilled to the default pool")
    return {
        "pods_on_existing": sum(len(m) for m in on_node.values()),
        "existing_nodes_used": len(on_node),
        "new_nodes_by_pool": {k: v[0] for k, v in sorted(per_pool.items())},
        "new_node_pods_by_pool": {k: v[1] for k, v in sorted(per_pool.items())},
        "reserved_cpu_used": used.get("cpu", 0) / 1e9,
        "reserved_memory_gi_used": used.get("memory", 0) / 1e9 / 2**30,
        "reserved_cpu_greedy_claims_max": greedy_reserved.get("cpu", 0) / 1e9,
    }


def pack_existing_check(inputs, device: str = "cuda") -> dict:
    """The C++ existing-node first-fit against its plain PyTorch version
    on ``device``, on the inputs a solve handed it."""
    import torch

    from karpenter_core_tpu_torch.solver import pack as pk

    reqs, sig_ids, compat, free = inputs
    t0 = time.perf_counter()
    assign, left = pk.run_pack_existing(reqs, sig_ids, compat, free)
    native_ms = (time.perf_counter() - t0) * 1000.0
    dev = torch.device(device)
    tensors = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (reqs, sig_ids, compat, free)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_assign, plain_left = pk.pack_existing_reference(*tensors)
    plain_assign, plain_left = plain_assign.cpu().numpy(), plain_left.cpu().numpy()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    err = max(
        int(np.abs(assign.astype(np.int64) - plain_assign).max()) if assign.size else 0,
        int(np.abs(left.astype(np.int64) - plain_left).max()) if left.size else 0,
    )
    if err:
        fail(f"pack_existing_native and pack_existing_reference disagree (max abs err {err})")
    return {
        "P": int(reqs.shape[0]), "M": int(free.shape[0]), "R": int(reqs.shape[1]),
        "S": int(compat.shape[0]), "assigned": int((assign >= 0).sum()),
        "native_ms": native_ms, "plain_ms_on_" + dev.type: plain_ms, "max_abs_err": err,
    }


def capture_pack_existing(fn, calls: int = 1):
    """Run ``fn()`` and return the inputs the solve handed to
    ``run_pack_existing`` (copies): those of its one call, or with
    ``calls`` None the list of every call's."""
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    real = solver_mod.run_pack_existing
    seen = []

    def spy(reqs, sig_ids, compat, free, **kw):
        seen.append(tuple(np.array(x) for x in (reqs, sig_ids, compat, free)))
        return real(reqs, sig_ids, compat, free, **kw)

    solver_mod.run_pack_existing = spy
    try:
        out = fn()
    finally:
        solver_mod.run_pack_existing = real
    if calls is None:
        return out, seen
    if len(seen) != calls:
        fail(f"the solve ran the existing-node pack {len(seen)} times, not once")
    return out, seen[0]


def run_cluster_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES,
                      n_nodes: int = N_NODES) -> dict:
    """Phase 5 → its summary line (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing = cluster_world(n_pods, n_types, n_nodes)
    world_s = time.perf_counter() - t0
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
    if device == "cuda" and launches == 0:
        fail("the cluster solve never launched the compat kernel")
    cpu, inputs = capture_pack_existing(
        lambda: TorchScheduler(pools, provider, device="cpu").solve(pods, **kw)
    )
    same_as_cpu(cold, cpu, "cluster")
    summary = check_cluster(cold, pods, nodes, daemons, missing)
    packed = pack_existing_check(inputs, device)
    emit({"pack_existing": packed})
    profiled = profile_solve(solver, pods, **kw) if device == "cuda" else {}
    row = {
        "cluster": (
            f"{n_pods} pods x {n_types} types x {n_nodes} existing nodes, pools reserved "
            f"(limited) + default, daemonsets cni/logs/exporter"
        ),
        "world_build_s": world_s,
        "bound_pods": sum(len(sn.pod_requests) for sn in nodes),
        **timing_row(cold, cold_ms, warm_runs, launches),
        **summary,
        **profiled,
    }
    emit(row)
    return row


# -- phases 6 and 7: topology spread ---------------------------------------------


def check_spread(res, pods, nodes, provider, kube=None) -> list:
    """Fail unless every zone-spread group holds what the serial greedy
    guarantees: for each zone that received any of the group's pods, the
    final count of pods matching its selector (bound pods in ``kube``
    plus placements on existing and new nodes) minus the minimum over
    its supported zones is at most max_skew. A group is the pods sharing
    one (selector, namespace, max_skew); supported zones are those of
    the catalog's available offerings and of the existing nodes (the
    worlds here put no zone requirement or node filter on spread pods).
    → one summary per group."""
    from karpenter_core_tpu_torch.apis import labels as wk

    zone_key = wk.LABEL_TOPOLOGY_ZONE
    where = {}
    for plan in res.node_plans:
        for i in plan.pod_indices:
            where[i] = plan.zone
    for e in res.existing_plans:
        for i in e.pod_indices:
            where[i] = e.state_node.labels().get(zone_key)
    supported = {o.zone for it in provider.instance_types for o in it.offerings if o.available}
    supported |= {sn.labels()[zone_key] for sn in nodes if zone_key in sn.labels()}
    bound = []
    if kube is not None:
        node_zone = {n.name: n.metadata.labels.get(zone_key) for n in kube.list("Node")}
        bound = [
            (p, node_zone.get(p.spec.node_name))
            for p in kube.list("Pod")
            if p.spec.node_name
            and p.status.phase not in ("Succeeded", "Failed")
            and p.metadata.deletion_timestamp is None
        ]
    groups = {}
    for i, p in enumerate(pods):
        for c in p.spec.topology_spread_constraints:
            if c.topology_key == zone_key:
                key = (c.label_selector.key(), p.namespace, c.max_skew)
                groups.setdefault(key, (c.label_selector, []))[1].append(i)
    out = []
    for (_, ns, skew), (sel, members) in sorted(groups.items(), key=lambda kv: repr(kv[0])):
        final = dict.fromkeys(supported, 0)
        for p, z in bound:
            if z is not None and p.namespace == ns and sel.matches(p.metadata.labels):
                final[z] = final.get(z, 0) + 1
        for i, z in where.items():
            if z is not None and pods[i].namespace == ns and sel.matches(pods[i].metadata.labels):
                final[z] = final.get(z, 0) + 1
        lo = min(final[z] for z in supported)
        received = sorted({where[i] for i in members if i in where})
        worst = max((final[z] - lo for z in received), default=0)
        if worst > skew:
            fail(
                f"spread {sel.match_labels} breaks max_skew {skew}: final counts "
                f"{dict(sorted(final.items()))}, pods landed in {received}"
            )
        placed = {}
        for i in members:
            if i in where:
                placed[where[i]] = placed.get(where[i], 0) + 1
        out.append({
            "selector": dict(sel.match_labels), "max_skew": skew, "pods": len(members),
            "placed_by_zone": dict(sorted(placed.items())),
            "final_by_zone": dict(sorted(final.items())), "worst_skew": worst,
        })
    if not out:
        fail("the world has no zone-spread group")
    return out


def check_hostname(res, pods, kube, app: str = "ha-web") -> dict:
    """Fail unless every node that received a pod ``app=<app>`` (existing
    or new) holds at most max_skew of them, bound pods in ``kube``
    included: one replica per node at max_skew 1."""
    from karpenter_core_tpu_torch.apis import labels as wk

    members = [i for i, p in enumerate(pods) if p.metadata.labels.get("app") == app]
    if not members:
        fail(f"the world has no {app} pod")
    (cap,) = {
        c.max_skew
        for i in members
        for c in pods[i].spec.topology_spread_constraints
        if c.topology_key == wk.LABEL_HOSTNAME
    }
    bound = {}
    for p in kube.list("Pod"):
        if p.spec.node_name and p.metadata.labels.get("app") == app:
            bound[p.spec.node_name] = bound.get(p.spec.node_name, 0) + 1
    on_existing = on_new = 0
    for e in res.existing_plans:
        n = sum(1 for i in e.pod_indices if pods[i].metadata.labels.get("app") == app)
        on_existing += n
        if n and n + bound.get(e.state_node.name(), 0) > cap:
            fail(f"existing node {e.state_node.name()} holds {n} + {bound.get(e.state_node.name(), 0)} {app} pods")
    for plan in res.node_plans:
        n = sum(1 for i in plan.pod_indices if pods[i].metadata.labels.get("app") == app)
        on_new += n
        if n > cap:
            fail(f"a new {plan.instance_type.name} node holds {n} {app} pods")
    return {
        "hostname_spread": app, "max_skew": cap, "pods": len(members),
        "on_existing": on_existing, "on_new": on_new,
        "errors": sum(1 for i in members if pods[i].uid in res.pod_errors),
        "bound_seeds": sum(bound.values()),
    }


def run_config3_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES) -> dict:
    """Phase 6: bench config 3 whole, spread share included → its line
    (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    pools, provider, pods = config3_world(n_pods, n_types)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods)
    if device == "cuda" and launches < 1 + len(warm_runs):
        fail(f"config 3 launched the compat kernel {launches} times in {1 + len(warm_runs)} solves")
    same_as_cpu(cold, TorchScheduler(pools, provider, device="cpu").solve(pods), "config 3")
    check_invariants(cold, pods)
    spread = check_spread(cold, pods, [], provider)
    row = {
        "config3": f"{n_pods} pods x {n_types} types (bench config 3, zone spread on 2/9)",
        **timing_row(cold, cold_ms, warm_runs, launches),
        "spread": spread,
        **(profile_solve(solver, pods) if device == "cuda" else {}),
    }
    emit(row)
    return row


def run_cluster_spread_phase(
    device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES,
    n_ha: int = N_HA,
) -> dict:
    """Phase 7: config 3 and an HA front end against the live cluster,
    seeded from its kube store → its line (also emitted); fails on any
    check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing, kube = cluster_spread_world(
        n_pods, n_types, n_nodes, n_ha
    )
    world_s = time.perf_counter() - t0
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
    if device == "cuda" and launches < 1 + len(warm_runs):
        fail(f"the cluster spread solve launched the compat kernel {launches} times in {1 + len(warm_runs)} solves")
    cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(pods, **kw)
    same_as_cpu(cold, cpu, "cluster spread")
    summary = check_cluster(cold, pods, nodes, daemons, missing)
    spread = check_spread(cold, pods, nodes, provider, kube)
    ha = check_hostname(cold, pods, kube)
    row = {
        "cluster_spread": (
            f"{len(pods)} pods ({n_pods} config 3 + {n_ha} ha-web) x {n_types} types x "
            f"{n_nodes} existing nodes, kube store seeds"
        ),
        "world_build_s": world_s,
        "bound_pods": len(kube.list("Pod")),
        **timing_row(cold, cold_ms, warm_runs, launches),
        **summary,
        "spread": spread,
        "hostname": ha,
        **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
    }
    emit(row)
    return row


# -- phases 8 and 9: pod affinity and anti-affinity -------------------------------


_QUANTITIES: dict = {}


def pending_pod(name: str, cpu: str, mem: str, labels=None):
    """A pending pod as ``bench.py::_mk_pod`` builds it."""
    from karpenter_core_tpu_torch.kube.objects import (
        Container,
        Pod,
        PodCondition,
        PodSpec,
        ResourceRequirements,
    )
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    pod = Pod()
    pod.metadata.name = name
    pod.metadata.labels = dict(labels or {})
    # parsed quantities are ints: one parse per distinct string
    for q in (cpu, mem):
        if q not in _QUANTITIES:
            _QUANTITIES[q] = parse_quantity(q)
    requests = {"cpu": _QUANTITIES[cpu], "memory": _QUANTITIES[mem]}
    pod.spec = PodSpec(containers=[Container(name="main", resources=ResourceRequirements(requests=requests))])
    pod.status.conditions = [PodCondition(type="PodScheduled", status="False", reason="Unschedulable")]
    return pod


def config6_world(n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES, seed: int = CONFIG6_SEED):
    """bench.py config 6 whole (``bench.py:674``, RandomState(17)):
    karpenter-core's ``makeDiversePods`` mix
    (scheduling_benchmark_test.go:184-287). 3/7 generic, then 1/7 each
    of zone spread, hostname spread (max_skew 1, DoNotSchedule, selector
    ``my-label`` drawn from seven values, so mostly counting other
    pods), hostname pod affinity and zone pod affinity (selector
    ``my-affininity`` from the same seven values). Catalog
    ``instance_types(n_types)``, one NodePool ``default``, no cluster.
    → ([nodepool], provider, pods)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        LabelSelector,
        PodAffinity,
        PodAffinityTerm,
        TopologySpreadConstraint,
    )

    rng = np.random.RandomState(seed)
    vals = ["a", "b", "c", "d", "e", "f", "g"]
    cpus = ["100m", "250m", "500m", "1", "1500m"]
    mems = ["100Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]

    def rnd(seq):
        return seq[rng.randint(len(seq))]

    seventh = n_pods // 7
    pods = []

    def base(labels):
        return pending_pod(f"bench-{len(pods)}", rnd(cpus), rnd(mems), labels=labels)

    for _ in range(3 * seventh + (n_pods - 7 * seventh)):
        pods.append(base({"my-label": rnd(vals)}))
    for key in (wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME):
        for _ in range(seventh):
            p = base({"my-label": rnd(vals)})
            p.spec.topology_spread_constraints = [
                TopologySpreadConstraint(
                    max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector(match_labels={"my-label": rnd(vals)}),
                )
            ]
            pods.append(p)
    for key in (wk.LABEL_HOSTNAME, wk.LABEL_TOPOLOGY_ZONE):
        for _ in range(seventh):
            p = base({"my-affininity": rnd(vals)})
            p.spec.affinity = Affinity(
                pod_affinity=PodAffinity(
                    required=[
                        PodAffinityTerm(
                            topology_key=key,
                            label_selector=LabelSelector(match_labels={"my-affininity": rnd(vals)}),
                        )
                    ]
                )
            )
            pods.append(p)
    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    return [nodepool], provider, pods


def anti_dense_pods(n_pods: int = N_ANTI, n_quorum: int = N_QUORUM) -> list:
    """bench.py config 13 ``anti_dense``'s pending pods
    (``bench.py:2035-2090``, RandomState(13)): 55 % ``team=t-d`` with a
    required zone anti-affinity to ``app=ext-(d % 8)``, 15 % ``team=m-d``
    with two zone terms (``ext-(d % 8)``, ``ext-((d + 3) % 8)``) and a
    hostname term (``ext-(d % 8)``), 30 % plain 500m / 512Mi; then
    ``n_quorum`` ``app=quorum`` pods (1 CPU / 2Gi) with a required zone
    self-anti-affinity: an etcd-style quorum, one member per zone."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        LabelSelector,
        PodAffinityTerm,
        PodAntiAffinity,
    )

    def anti(*terms):
        return Affinity(
            pod_anti_affinity=PodAntiAffinity(
                required=[
                    PodAffinityTerm(topology_key=key, label_selector=LabelSelector(match_labels={"app": app}))
                    for key, app in terms
                ]
            )
        )

    zone, host = wk.LABEL_TOPOLOGY_ZONE, wk.LABEL_HOSTNAME
    rng = np.random.RandomState(ANTI_SEED)
    pods = []
    for i in range(n_pods):
        roll = rng.rand()
        d = rng.randint(24)
        if roll < 0.55:
            p = pending_pod(
                f"bench-{i}", ["250m", "500m", "1"][rng.randint(3)], ["256Mi", "1Gi"][rng.randint(2)],
                labels={"team": f"t-{d}"},
            )
            p.spec.affinity = anti((zone, f"ext-{d % 8}"))
        elif roll < 0.70:
            p = pending_pod(
                f"bench-{i}", ["250m", "500m"][rng.randint(2)], ["256Mi", "512Mi"][rng.randint(2)],
                labels={"team": f"m-{d}"},
            )
            s1, s2 = d % 8, (d + 3) % 8
            p.spec.affinity = anti((zone, f"ext-{s1}"), (zone, f"ext-{s2}"), (host, f"ext-{s1}"))
        else:
            p = pending_pod(f"bench-{i}", "500m", "512Mi")
        pods.append(p)
    for k in range(n_quorum):
        p = pending_pod(f"quorum-{k}", "1", "2Gi", labels={"app": "quorum"})
        p.spec.affinity = anti((zone, "quorum"))
        pods.append(p)
    return pods


def bound_anchor(name: str, labels: dict, node_name: str):
    """A running 100m / 128Mi pod bound to ``node_name``."""
    p = pending_pod(name, "100m", "128Mi", labels=labels)
    p.spec.node_name = node_name
    p.status.phase = "Running"
    p.status.conditions = []
    return p


def anti_dense_world(n_pods: int = N_ANTI, n_types: int = N_ANTI_TYPES, n_quorum: int = N_QUORUM):
    """bench.py config 13 ``anti_dense`` as the bench builds it
    (``bench.py:1953-2090``): ``instance_types(n_types)``, one NodePool
    ``default``, no existing nodes, a kube store holding nodes
    ``seed-test-zone-1..3`` (a zone label only) and the eight anchors
    ``ext-s`` (``app=ext-s``) on ``seed-test-zone-{s % 3 + 1}``; the pods
    of ``anti_dense_pods``. Every pod takes a new node. → ([nodepool],
    provider, pods, [], [], {}, kube)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import Node

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    kube = KubeClient()
    for z in range(3):
        node = Node()
        node.metadata.name = f"seed-test-zone-{z + 1}"
        node.metadata.labels = {wk.LABEL_TOPOLOGY_ZONE: f"test-zone-{z + 1}"}
        kube.create(node)
    for s in range(8):
        kube.create(bound_anchor(f"seed-ext-{s}", {"app": f"ext-{s}"}, f"seed-test-zone-{s % 3 + 1}"))
    return [nodepool], provider, anti_dense_pods(n_pods, n_quorum), [], [], {}, kube


def anti_cluster_world(
    n_pods: int = N_ANTI, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_quorum: int = N_QUORUM
):
    """``anti_dense_pods`` against phase 5's cluster in a kube store →
    (nodepools, provider, pods, state_nodes, daemonset_pods, missing,
    kube): the cluster is ``_cluster_world``'s (RandomState(12), pools
    ``reserved`` and ``default``, the ``instance_types(n_types)``
    catalog), every node and bound pod also in ``kube``, and the anchor
    ``ext-s`` is bound on ``node-{s + 3:04d}`` (nodes 0003..0010), a node
    of zone ``test-zone-{s % 3 + 1}``, the zone ``bench.py`` seeds it
    in."""
    from karpenter_core_tpu_torch.apis import labels as wk

    pools, provider, _, nodes, daemons, missing, kube = _cluster_world(0, n_types, n_nodes, store=True)
    by_name = {sn.name(): sn for sn in nodes}
    for s in range(8):
        node_name = f"node-{s + 3:04d}"
        sn = by_name[node_name]
        if sn.labels()[wk.LABEL_TOPOLOGY_ZONE] != f"test-zone-{s % 3 + 1}":
            fail(f"anchor node {node_name} is not in zone test-zone-{s % 3 + 1}")
        p = bound_anchor(f"seed-ext-{s}", {"app": f"ext-{s}"}, node_name)
        sn.update_for_pod(p)
        kube.create(p)
    return pools, provider, anti_dense_pods(n_pods, n_quorum), nodes, daemons, missing, kube


def placements(res) -> dict:
    """pod index → (zone, node key) of every placement; node keys are
    ``("existing", name)`` and ``("new", plan ordinal)``."""
    from karpenter_core_tpu_torch.apis import labels as wk

    where = {}
    for n, plan in enumerate(res.node_plans):
        for i in plan.pod_indices:
            where[i] = (plan.zone, ("new", n))
    for e in res.existing_plans:
        for i in e.pod_indices:
            where[i] = (e.state_node.labels().get(wk.LABEL_TOPOLOGY_ZONE), ("existing", e.state_node.name()))
    return where


def bound_domains(kube) -> list:
    """(pod, zone, node key) of every pod bound in ``kube`` that counts."""
    from karpenter_core_tpu_torch.apis import labels as wk

    if kube is None:
        return []
    node_zone = {n.name: n.metadata.labels.get(wk.LABEL_TOPOLOGY_ZONE) for n in kube.list("Node")}
    return [
        (p, node_zone.get(p.spec.node_name), ("existing", p.spec.node_name))
        for p in kube.list("Pod")
        if p.spec.node_name
        and p.status.phase not in ("Succeeded", "Failed")
        and p.metadata.deletion_timestamp is None
    ]


def check_affinity(res, pods, kube=None) -> dict:
    """Fail unless every placed pod with required pod-affinity terms
    shares, for each term, its zone (zone terms) or its node (hostname
    terms) with a pod of its namespace the term's selector matches:
    another placement of this batch, a planned member, a bound pod, or
    itself (the pod that seeds an empty domain of its own selector)."""
    from karpenter_core_tpu_torch.apis import labels as wk

    where = placements(res)
    by_zone, by_node = {}, {}
    for i, (z, node) in where.items():
        by_zone.setdefault(z, []).append((pods[i].namespace, pods[i].metadata.labels))
        by_node.setdefault(node, []).append((pods[i].namespace, pods[i].metadata.labels))
    for p, z, node in bound_domains(kube):
        by_zone.setdefault(z, []).append((p.namespace, p.metadata.labels))
        by_node.setdefault(node, []).append((p.namespace, p.metadata.labels))
    checked = {"zone": 0, "hostname": 0}
    for i, (z, node) in sorted(where.items()):
        a = pods[i].spec.affinity
        if a is None or a.pod_affinity is None:
            continue
        for t in a.pod_affinity.required:
            hostname = t.topology_key == wk.LABEL_HOSTNAME
            members = by_node[node] if hostname else by_zone[z]
            if not any(ns == pods[i].namespace and t.label_selector.matches(lbl) for ns, lbl in members):
                fail(
                    f"pod {pods[i].name} on {node} in {z} has no pod matching its "
                    f"{t.topology_key} affinity {t.label_selector.match_labels}"
                )
            checked["hostname" if hostname else "zone"] += 1
    affinity_pods = [i for i, p in enumerate(pods) if p.spec.affinity is not None and p.spec.affinity.pod_affinity]
    if not affinity_pods:
        fail("the world has no pod-affinity pod")
    return {
        "affinity_pods": len(affinity_pods),
        "affinity_placed": sum(1 for i in affinity_pods if i in where),
        "affinity_errors": sum(1 for i in affinity_pods if pods[i].uid in res.pod_errors),
        "terms_checked": checked,
    }


def check_anti(res, pods, kube) -> dict:
    """Fail unless no placed pod with required anti-affinity shares its
    zone (zone terms) or its node (hostname terms) with another pod of
    its namespace the term's selector matches, bound or placed, and at
    most one ``app=quorum`` pod sits in each zone."""
    from karpenter_core_tpu_torch.apis import labels as wk

    where = placements(res)
    by_zone, by_node = {}, {}
    for i, (z, node) in where.items():
        by_zone.setdefault(z, []).append((i, pods[i].namespace, pods[i].metadata.labels))
        by_node.setdefault(node, []).append((i, pods[i].namespace, pods[i].metadata.labels))
    for p, z, node in bound_domains(kube):
        by_zone.setdefault(z, []).append((None, p.namespace, p.metadata.labels))
        by_node.setdefault(node, []).append((None, p.namespace, p.metadata.labels))
    checked = {"zone": 0, "hostname": 0}
    for i, (z, node) in sorted(where.items()):
        a = pods[i].spec.affinity
        if a is None or a.pod_anti_affinity is None:
            continue
        for t in a.pod_anti_affinity.required:
            hostname = t.topology_key == wk.LABEL_HOSTNAME
            for j, ns, lbl in by_node.get(node, []) if hostname else by_zone.get(z, []):
                if j != i and ns == pods[i].namespace and t.label_selector.matches(lbl):
                    fail(
                        f"pod {pods[i].name} on {node} in {z} shares its {t.topology_key} with "
                        f"a pod its anti-affinity {t.label_selector.match_labels} excludes"
                    )
            checked["hostname" if hostname else "zone"] += 1
    quorum = [i for i, p in enumerate(pods) if p.metadata.labels.get("app") == "quorum"]
    per_zone = {}
    for i in quorum:
        if i in where:
            per_zone[where[i][0]] = per_zone.get(where[i][0], 0) + 1
    if any(n > 1 for n in per_zone.values()):
        fail(f"quorum members share a zone: {per_zone}")
    anti = [i for i, p in enumerate(pods) if p.spec.affinity is not None and p.spec.affinity.pod_anti_affinity]
    return {
        "anti_pods": len(anti),
        "anti_placed": sum(1 for i in anti if i in where),
        "anti_on_existing": sum(1 for i in anti if i in where and where[i][1][0] == "existing"),
        "terms_checked": checked,
        "quorum_by_zone": dict(sorted(per_zone.items())),
        "quorum_errors": sorted({res.pod_errors[pods[i].uid] for i in quorum if pods[i].uid in res.pod_errors}),
    }


def check_spread_serial(res, pods, provider, first=()) -> list:
    """Fail unless every zone-spread group holds its max_skew in the
    serial order the tensor path schedules a batch whose spread groups
    share one pack class (bench config 6): the spread groups in the
    order of their first pod, each seeing the spread pods placed before
    it, the pods without a spread after all of them. A self-selecting
    group's zones must end within max_skew of the least-loaded supported
    zone, its own pods counted; a group whose selector does not match
    its own pods adds nothing to the counts, so the zones it took must
    have been within max_skew when it came (topologygroup.go:166-175).
    The final counts, which ``check_spread`` reads, also hold the pods
    without a constraint placed later, which the constraint does not
    bound. ``first``: pods placed before every spread group (against a
    cluster, the unconstrained pods the existing-node first-fit placed).
    → one summary per group."""
    from karpenter_core_tpu_torch.apis import labels as wk

    zone_key = wk.LABEL_TOPOLOGY_ZONE
    where = {i: z for i, (z, _) in placements(res).items()}
    supported = sorted({o.zone for it in provider.instance_types for o in it.offerings if o.available})
    groups = {}
    for i, p in enumerate(pods):
        for c in p.spec.topology_spread_constraints:
            if c.topology_key == zone_key:
                key = (p.namespace, tuple(sorted(p.metadata.labels.items())), c.label_selector.key(), c.max_skew)
                groups.setdefault(key, (c, []))[1].append(i)
    before: list = list(first)
    out = []
    for (ns, _, _, skew), (c, members) in groups.items():
        sel = c.label_selector
        counts = dict.fromkeys(supported, 0)
        for j in before:
            if j in where and pods[j].namespace == ns and sel.matches(pods[j].metadata.labels):
                counts[where[j]] += 1
        placed = {}
        for i in members:
            if i in where:
                placed[where[i]] = placed.get(where[i], 0) + 1
        self_selecting = sel.matches(pods[members[0]].metadata.labels)
        if self_selecting:
            counts = {z: n + placed.get(z, 0) for z, n in counts.items()}
        lo = min(counts.values())
        worst = max((counts[z] - lo for z in placed), default=0)
        if worst > skew:
            fail(
                f"spread {sel.match_labels} of pods {dict(pods[members[0]].metadata.labels)} breaks "
                f"max_skew {skew}: counts {counts}, pods landed in {sorted(placed)}"
            )
        out.append({
            "selector": dict(sel.match_labels), "self_selecting": self_selecting, "pods": len(members),
            "placed_by_zone": dict(sorted(placed.items())), "worst_skew": worst,
        })
        before.extend(members)
    if not out:
        fail("the world has no zone-spread group")
    return out


def run_config6_phase(device: str = "cuda", n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES) -> dict:
    """Phase 8: bench config 6 whole → its line (also emitted); fails on
    any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    pools, provider, pods = config6_world(n_pods, n_types)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods)
    if device == "cuda" and launches < 1 + len(warm_runs):
        fail(f"config 6 launched the compat kernel {launches} times in {1 + len(warm_runs)} solves")
    same_as_cpu(cold, TorchScheduler(pools, provider, device="cpu").solve(pods), "config 6")
    check_invariants(cold, pods)
    row = {
        "config6": f"{n_pods} pods x {n_types} types (bench config 6, karpenter-core's diverse mix)",
        **timing_row(cold, cold_ms, warm_runs, launches),
        "affinity": check_affinity(cold, pods),
        "spread": check_spread_serial(cold, pods, provider),
        **(profile_solve(solver, pods) if device == "cuda" else {}),
    }
    emit(row)
    return row


def run_anti_phase(device: str = "cuda", n_pods: int = N_ANTI, n_nodes: int = N_NODES,
                   n_quorum: int = N_QUORUM, n_types=(N_ANTI_TYPES, N_TYPES)) -> tuple:
    """Phase 9: config 13 ``anti_dense`` and a zone quorum, first as the
    bench builds it (every pod on a new node), then against the live
    cluster → their two lines (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    rows = []
    for name, world, args in (
        ("anti_dense", anti_dense_world, (n_pods, n_types[0], n_quorum)),
        ("anti_cluster", anti_cluster_world, (n_pods, n_types[1], n_nodes, n_quorum)),
    ):
        t0 = time.perf_counter()
        pools, provider, pods, nodes, daemons, missing, kube = world(*args)
        world_s = time.perf_counter() - t0
        kw = dict(state_nodes=nodes, daemonset_pods=daemons)
        solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
        cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
        if device == "cuda" and launches < (1 + len(warm_runs)) * len(pools):
            fail(f"{name} launched the compat kernel {launches} times in {1 + len(warm_runs)} solves")
        cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(pods, **kw)
        same_as_cpu(cold, cpu, name)
        if not nodes:
            check_invariants(cold, pods)
        row = {
            name: (
                f"{len(pods)} pods ({n_pods} config 13 anti_dense + {n_quorum} zone quorum) x "
                f"{len(provider.instance_types)} types"
                + (f" x {len(nodes)} existing nodes" if nodes else ", no existing nodes")
                + ", kube store seeds"
            ),
            "world_build_s": world_s,
            "bound_pods": len(kube.list("Pod")),
            **timing_row(cold, cold_ms, warm_runs, launches),
            **(check_cluster(cold, pods, nodes, daemons, missing, spill=False) if nodes else {}),
            "anti": check_anti(cold, pods, kube),
            **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
        }
        emit(row)
        rows.append(row)
    return tuple(rows)


# -- phase 10: host ports and CSI volumes ------------------------------------------


def stateful_dense_pods(n_pods: int = N_STATEFUL) -> list:
    """bench.py config 13 ``stateful_dense``'s pending pods
    (``bench.py:2102-2134``, RandomState(13)): 40 % StatefulSet-shaped
    pods with one generic ephemeral volume (250m or 500m, 512Mi or 1Gi),
    30 % host-port deployments (250m / 256Mi) on one of the 12 ports
    8000–8011, 30 % plain 500m / 512Mi."""
    from karpenter_core_tpu_torch.kube.objects import ContainerPort, Volume

    rng = np.random.RandomState(ANTI_SEED)
    pods = []
    for i in range(n_pods):
        roll = rng.rand()
        if roll < 0.4:
            p = pending_pod(f"bench-{i}", ["250m", "500m"][rng.randint(2)], ["512Mi", "1Gi"][rng.randint(2)])
            p.spec.volumes = [Volume(name="data", ephemeral=True)]
        elif roll < 0.7:
            p = pending_pod(f"bench-{i}", "250m", "256Mi")
            p.spec.containers[0].ports = [ContainerPort(host_port=8000 + int(rng.randint(12)))]
        else:
            p = pending_pod(f"bench-{i}", "500m", "512Mi")
        pods.append(p)
    return pods


def _default_storage_class(kube) -> None:
    """The default StorageClass of config 13 (``bench-standard``,
    provisioner ``ebs.csi.bench``)."""
    from karpenter_core_tpu_torch.kube.objects import StorageClass

    sc = StorageClass(provisioner=CSI_DRIVER)
    sc.metadata.name = "bench-standard"
    sc.metadata.annotations = {"storageclass.kubernetes.io/is-default-class": "true"}
    kube.create(sc)


def stateful_dense_world(n_pods: int = N_STATEFUL, n_types: int = N_ANTI_TYPES, bench_units: bool = False):
    """bench.py config 13 ``stateful_dense`` (``bench.py:2102-2150``):
    ``stateful_dense_pods``, ``instance_types(n_types)``, one NodePool
    ``default``, a kube store holding the default StorageClass, and 16
    initialized nodes ``csi-node-m`` in zones ``test-zone-(m % 3 + 1)``
    with CSI attach limit 8 for ``ebs.csi.bench`` → (nodepools, provider,
    pods, state_nodes, [], missing, kube). The nodes hold 16 CPU, 64Gi
    and 110 pods in the solver's units (``parse_quantity``); with
    ``bench_units`` they hold the raw integers ``bench.py`` writes (16e9
    nano-CPU, but 64·2^30 nano-bytes and 110 nano-pods: no pod fits)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import Node
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.state import StateNode

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    kube = KubeClient()
    _default_storage_class(kube)
    pods = stateful_dense_pods(n_pods)
    if bench_units:
        capacity = {"cpu": 16 * 10**9, "memory": 64 * 1024**3, "pods": 110}
    else:
        capacity = {"cpu": parse_quantity("16"), "memory": parse_quantity("64Gi"), "pods": parse_quantity("110")}
    nodes = []
    for m in range(16):
        node = Node()
        node.metadata.name = f"csi-node-{m}"
        node.metadata.labels = {
            wk.NODEPOOL_LABEL_KEY: "default",
            wk.LABEL_HOSTNAME: f"csi-node-{m}",
            wk.LABEL_TOPOLOGY_ZONE: f"test-zone-{m % 3 + 1}",
            wk.NODE_REGISTERED_LABEL_KEY: "true",
            wk.NODE_INITIALIZED_LABEL_KEY: "true",
        }
        node.status.capacity = dict(capacity)
        node.status.allocatable = dict(capacity)
        sn = StateNode(node=node)
        sn.volume_usage.csi_limits = {CSI_DRIVER: 8}
        nodes.append(sn)
    return [nodepool], provider, pods, nodes, [], {sn.name(): {} for sn in nodes}, kube


def spread_skew_world(n_pods: int = N_STATEFUL, n_types: int = N_ANTI_TYPES):
    """bench.py config 13 ``spread_skew`` as the bench builds it
    (``bench.py:2009-2034``, RandomState(13)): pods ``app=svc-d`` (d
    uniform in 0..19; 250m, 500m or 1 CPU; 256Mi or 1Gi) with a zone
    spread (max_skew 1, DoNotSchedule) on their own service, against
    seeds skewed to ``test-zone-1``: every even service has ``d % 5 + 1``
    bound pods on ``seed-test-zone-1``. ``instance_types(n_types)``, one
    NodePool ``default``, no existing nodes → (nodepools, provider, pods,
    [], [], {}, kube)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube.client import KubeClient
    from karpenter_core_tpu_torch.kube.objects import LabelSelector, Node, TopologySpreadConstraint

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    kube = KubeClient()
    node = Node()
    node.metadata.name = "seed-test-zone-1"
    node.metadata.labels = {wk.LABEL_TOPOLOGY_ZONE: "test-zone-1"}
    for d in range(0, 20, 2):
        for k in range(d % 5 + 1):
            if kube.get("Node", node.name) is None:
                kube.create(node)
            kube.create(bound_anchor(f"seed-skew-{d}-{k}", {"app": f"svc-{d}"}, node.name))
    rng = np.random.RandomState(ANTI_SEED)
    pods = []
    for i in range(n_pods):
        d = rng.randint(20)
        p = pending_pod(
            f"bench-{i}", ["250m", "500m", "1"][rng.randint(3)], ["256Mi", "1Gi"][rng.randint(2)],
            labels={"app": f"svc-{d}"},
        )
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(
                max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE, when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={"app": f"svc-{d}"}),
            )
        ]
        pods.append(p)
    return [nodepool], provider, pods, [], [], {}, kube


def stateful_cluster_world(
    n_pods: int = N_STATEFUL, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_replicas: int = N_REPLICAS
):
    """``stateful_dense_pods`` and three StatefulSets against phase 5's
    cluster in a kube store → (nodepools, provider, pods, state_nodes,
    daemonset_pods, missing, kube):

    - the cluster is ``_cluster_world``'s (RandomState(12), pools
      ``reserved`` and ``default``), every node with a CSI attach limit
      of 25 for ``ebs.csi.bench`` (EBS on Nitro instances); on every
      third node the first 20–25 bound workers (RandomState(14); all of
      them where it runs fewer) mount one claim each (four of 1,000
      nodes full);
    - the ``exporter`` daemon takes hostPort 9100, as Prometheus'
      node-exporter does, on every on-demand node;
    - a third NodePool ``db`` (label and taint ``workload=db``) for the
      databases;
    - pending: ``stateful_dense_pods(n_pods)``; ``n_pods // 100``
      ``app=metrics-agent`` pods on hostPort 9100 (100m / 128Mi), which
      the exporter's nodes refuse; and three StatefulSets of
      ``n_replicas`` replicas, each replica with its own claim:
      ``pg`` (2 CPU / 8Gi, on ``db``) and ``redis`` (500m / 2Gi, any
      node) with claims bound to PersistentVolumes pinned to zone
      ``test-zone-(k % 3 + 1)``, ``kafka`` (1 CPU / 4Gi, on ``db``) with
      unbound claims of StorageClass ``zonal`` (allowed topologies
      ``test-zone-1`` and ``test-zone-2``)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.kube.objects import (
        ContainerPort,
        PersistentVolume,
        PersistentVolumeClaim,
        StorageClass,
        Taint,
        Toleration,
        Volume,
    )
    from karpenter_core_tpu_torch.scheduling.volumes import get_volumes

    pools, provider, _, nodes, daemons, missing, kube = _cluster_world(0, n_types, n_nodes, store=True)
    _default_storage_class(kube)
    zonal = StorageClass(provisioner=CSI_DRIVER, zones=["test-zone-1", "test-zone-2"])
    zonal.metadata.name = "zonal"
    kube.create(zonal)
    exporter = next(d for d in daemons if d.name == "exporter")
    exporter.spec.containers[0].ports = [ContainerPort(host_port=9100)]
    bound_by_node = {}
    for p in kube.list("Pod"):
        bound_by_node.setdefault(p.spec.node_name, []).append(p)
    rng = np.random.RandomState(NODE_SEED + 2)
    for m, sn in enumerate(nodes):
        sn.volume_usage.csi_limits = {CSI_DRIVER: 25}
        bound = kube.get("Pod", f"{sn.name()}-exporter", namespace="default")
        if bound is not None:
            bound.spec.containers[0].ports = [ContainerPort(host_port=9100)]
            sn.update_for_pod(bound)
        if m % 3:
            continue
        workers = [w for w in bound_by_node.get(sn.name(), ()) if w.name.startswith(f"{sn.name()}-w")]
        for p in workers[: int(rng.randint(20, 26))]:
            claim = PersistentVolumeClaim(storage_class_name="bench-standard")
            claim.metadata.name = f"data-{p.name}"
            kube.create(claim)
            p.spec.volumes = [Volume(name="data", persistent_volume_claim=claim.name)]
            sn.volume_usage.add(p, get_volumes(kube, p))
    db = NodePool()
    db.metadata.name = "db"
    db.spec.template.metadata.labels = {"workload": "db"}
    db.spec.template.taints = [Taint(key="workload", value="db", effect="NoSchedule")]
    pods = stateful_dense_pods(n_pods)
    for k in range(n_pods // 100):
        p = pending_pod(f"metrics-agent-{k}", "100m", "128Mi", labels={"app": "metrics-agent"})
        p.spec.containers[0].ports = [ContainerPort(host_port=9100)]
        pods.append(p)
    for sts, cpu, mem, on_db, pinned in (
        ("pg", "2", "8Gi", True, True), ("kafka", "1", "4Gi", True, False), ("redis", "500m", "2Gi", False, True),
    ):
        for k in range(n_replicas):
            claim = PersistentVolumeClaim(storage_class_name="bench-standard" if pinned else "zonal")
            claim.metadata.name = f"data-{sts}-{k}"
            if pinned:
                pv = PersistentVolume(zones=[f"test-zone-{k % 3 + 1}"], driver=CSI_DRIVER)
                pv.metadata.name = f"pv-{sts}-{k}"
                kube.create(pv)
                claim.volume_name = pv.name
            kube.create(claim)
            p = pending_pod(f"{sts}-{k}", cpu, mem, labels={"app": sts})
            p.spec.volumes = [Volume(name="data", persistent_volume_claim=claim.name)]
            if on_db:
                p.spec.node_selector = {"workload": "db"}
                p.spec.tolerations = [Toleration(key="workload", value="db", effect="NoSchedule")]
            pods.append(p)
    return [*pools, db], provider, pods, nodes, daemons, missing, kube


def pod_host_ports(pod) -> list:
    from karpenter_core_tpu_torch.scheduling.hostports import HostPort

    return [
        HostPort(ip=p.host_ip or "0.0.0.0", port=p.host_port, protocol=p.protocol or "TCP")
        for c in pod.spec.containers + pod.spec.init_containers
        for p in c.ports
        if p.host_port
    ]


def check_ports(res, pods, nodes=()) -> dict:
    """Fail unless no node, existing or new, holds two pods whose host
    ports conflict (``HostPort.matches``: same protocol and port, equal
    IPs or either unspecified), the existing nodes' own reservations
    counted."""
    where = placements(res)
    by_node = {}
    for sn in nodes:
        for key, ports in sn.host_port_usage.reserved.items():
            if ports:
                by_node.setdefault(("existing", sn.name()), []).append((("bound",) + key, ports))
    port_pods = 0
    for i, (_, node) in where.items():
        ports = pod_host_ports(pods[i])
        if ports:
            port_pods += 1
            by_node.setdefault(node, []).append((i, ports))
    for node, entries in by_node.items():
        for a in range(len(entries)):
            for b in range(a):
                if any(x.matches(y) for x in entries[a][1] for y in entries[b][1]):
                    fail(f"pods {entries[a][0]} and {entries[b][0]} on {node} hold conflicting host ports")
    return {
        "port_pods_placed": port_pods,
        "port_pods_on_existing": sum(1 for i, (_, n) in where.items() if n[0] == "existing" and pod_host_ports(pods[i])),
    }


def pod_volume_ids(pod, kube) -> dict:
    """driver → claim ids of a pod's volumes, resolved PVC → bound PV's
    driver, else its StorageClass's (the default class for ephemeral
    volumes and claims without one); an ephemeral volume's claim is
    ``<pod>-<volume>``."""
    classes = kube.list("StorageClass")
    default = next(
        (sc.name for sc in classes if sc.metadata.annotations.get("storageclass.kubernetes.io/is-default-class") == "true"),
        None,
    )
    out = {}
    for v in pod.spec.volumes:
        if v.persistent_volume_claim:
            pvc = kube.get("PersistentVolumeClaim", v.persistent_volume_claim, namespace=pod.namespace)
            if pvc is None:
                continue
            claim, pv_name, sc_name = v.persistent_volume_claim, pvc.volume_name, pvc.storage_class_name or default
        elif v.ephemeral:
            claim, pv_name, sc_name = f"{pod.name}-{v.name}", "", default
        else:
            continue
        pv = kube.get("PersistentVolume", pv_name) if pv_name else None
        sc = kube.get("StorageClass", sc_name) if sc_name else None
        driver = pv.driver if pv is not None and pv.driver else (sc.provisioner if sc is not None else "")
        if driver:
            out.setdefault(driver, set()).add(f"{pod.namespace}/{claim}")
    return out


def check_volumes(res, pods, nodes, kube) -> dict:
    """Fail unless, on every existing node and for every CSI driver, the
    claims it mounts and those its new pods bring, shared claims counted
    once, stay within its attach limit."""
    by_name = {sn.name(): sn for sn in nodes}
    volume_pods = 0
    for e in res.existing_plans:
        sn = by_name[e.state_node.name()]
        mounted = {d: set(ids) for d, ids in sn.volume_usage.volumes.items()}
        for i in e.pod_indices:
            ids = pod_volume_ids(pods[i], kube)
            volume_pods += bool(ids)
            for d, claims in ids.items():
                mounted.setdefault(d, set()).update(claims)
        for d, claims in mounted.items():
            limit = sn.volume_usage.csi_limits.get(d)
            if limit is not None and len(claims) > limit:
                fail(f"existing node {sn.name()} mounts {len(claims)} {d} volumes, over its limit {limit}")
    return {
        "volume_pods_on_existing": volume_pods,
        "volume_pods_placed": sum(1 for i in placements(res) if pods[i].spec.volumes),
    }


def check_zone_pins(res, pods, kube) -> dict:
    """Fail unless every placed pod whose claim is pinned (a bound PV
    with zones, else a StorageClass with allowed zones) sits in a zone
    the pin allows."""
    where = placements(res)
    pinned = 0
    for i, (zone, node) in sorted(where.items()):
        for v in pods[i].spec.volumes:
            if not v.persistent_volume_claim:
                continue
            pvc = kube.get("PersistentVolumeClaim", v.persistent_volume_claim, namespace=pods[i].namespace)
            if pvc is None:
                continue
            pv = kube.get("PersistentVolume", pvc.volume_name) if pvc.volume_name else None
            sc = kube.get("StorageClass", pvc.storage_class_name) if pvc.storage_class_name else None
            zones = pv.zones if pv is not None and pv.zones else (sc.zones if sc is not None else [])
            if not zones:
                continue
            pinned += 1
            if zone not in zones:
                fail(f"pod {pods[i].name} on {node} sits in {zone}, outside its claim's zones {zones}")
    return {"pinned_placed": pinned}



def stateful_pack_check(calls, axis_width: int, device: str = "cuda") -> dict:
    """``pack_existing_check`` on every existing-node first-fit of a
    solve whose inputs carry port or ephemeral-volume columns beyond the
    resource axis (the stateful pass) → their sums."""
    extended = [c for c in calls if c[3].shape[1] > axis_width]
    rows = [pack_existing_check(c, device) for c in extended]
    return {
        "calls": len(calls), "extended_calls": len(extended),
        "P": sum(r["P"] for r in rows), "max_R": max((r["R"] for r in rows), default=0),
        "assigned": sum(r["assigned"] for r in rows),
        "native_ms": sum(r["native_ms"] for r in rows),
        f"plain_ms_on_{device}": sum(r[f"plain_ms_on_{device}"] for r in rows),
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=0),
    }


def run_stateful_phase(device: str = "cuda", n_pods: int = N_STATEFUL, n_nodes: int = N_NODES,
                       n_replicas: int = N_REPLICAS, n_types=(N_ANTI_TYPES, N_TYPES)) -> tuple:
    """Phase 10: config 13 ``stateful_dense`` (its nodes in the solver's
    units) and ``spread_skew`` as the bench builds them, then the
    stateful cluster → their three lines (also emitted); fails on any
    check. The CPU solve gets its own copy of the pods, made before the
    card's solves pin their claims' zones."""
    import copy

    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    rows = []
    for name, world, args in (
        ("stateful_dense", stateful_dense_world, (n_pods, n_types[0])),
        ("spread_skew", spread_skew_world, (n_pods, n_types[0])),
        ("stateful_cluster", stateful_cluster_world, (n_pods, n_types[1], n_nodes, n_replicas)),
    ):
        t0 = time.perf_counter()
        pools, provider, pods, nodes, daemons, missing, kube = world(*args)
        cpu_pods = copy.deepcopy(pods)
        world_s = time.perf_counter() - t0
        kw = dict(state_nodes=nodes, daemonset_pods=daemons)
        solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
        cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
        if device == "cuda" and launches < (1 + len(warm_runs)) * len(pools):
            fail(f"{name} launched the compat kernel {launches} times in {1 + len(warm_runs)} solves")
        cpu_solver = TorchScheduler(pools, provider, device="cpu", kube_client=kube)
        cpu, calls = capture_pack_existing(lambda: cpu_solver.solve(cpu_pods, **kw), calls=None)
        same_as_cpu(cold, cpu, name)
        row = {
            name: (
                f"{len(pods)} pods x {len(provider.instance_types)} types"
                + (f" x {len(nodes)} existing nodes" if nodes else ", no existing nodes")
                + f", {len(pools)} nodepools, kube store"
            ),
            "world_build_s": world_s,
            **timing_row(cold, cold_ms, warm_runs, launches),
        }
        if nodes:
            row.update(check_cluster(cold, pods, nodes, daemons, missing, spill=False, pools=pools))
            if solver._existing_ctx is not None:
                row["pack_existing"] = stateful_pack_check(calls, solver._existing_ctx["axis"].count, device)
        else:
            check_invariants(cold, pods)
        if name == "spread_skew":
            row["spread"] = check_spread(cold, pods, nodes, provider, kube)
        else:
            row["ports"] = check_ports(cold, pods, nodes)
            row["volumes"] = check_volumes(cold, pods, nodes, kube)
            row["zone_pins"] = check_zone_pins(cold, pods, kube)
        if device == "cuda":
            row.update(profile_solve(solver, pods, **kw))
        emit(row)
        rows.append(row)
    return tuple(rows)


# -- phase 11: the greedy oracle, the oracle fallback and preference relaxation --


def config1_world(n_pods: int = N_CONFIG1):
    """bench.py config 1 (``bench.py:388-419``): ``n_pods`` uniform
    500m / 512Mi pods, ``instance_types(10)``, one NodePool ``default``
    → ([nodepool], provider, pods)."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(10)
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    return [nodepool], provider, [pending_pod(f"bench-{i}", "500m", "512Mi") for i in range(n_pods)]


def soft_anti_affinity(selector: dict):
    """Bitnami's ``common.affinities.pods.soft`` (``podAntiAffinityPreset:
    soft``): one preferred term of weight 1 on ``kubernetes.io/hostname``
    whose selector is ``selector``."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        LabelSelector,
        PodAffinityTerm,
        PodAntiAffinity,
        WeightedPodAffinityTerm,
    )

    term = PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME, label_selector=LabelSelector(match_labels=dict(selector)))
    return Affinity(pod_anti_affinity=PodAntiAffinity(preferred=[WeightedPodAffinityTerm(1, term)]))


def release_pods(n_releases: int = N_RELEASES, replicas: int = N_RELEASE_REPLICAS, seed: int = RELEASE_SEED) -> list:
    """Helm releases with Bitnami's default soft pod anti-affinity:

    - ``n_releases`` releases ``{chart}-{k}`` of ``replicas`` replicas,
      labels ``app.kubernetes.io/name``, ``/instance`` and ``/component``,
      the selector all three (one replica per node while it holds), the
      requests drawn per release from RandomState(``seed``);
    - two ``postgresql`` releases whose selector leaves out ``component``:
      a primary (1 replica, 1 CPU / 2Gi) and 20 read replicas (500m /
      1Gi), so each selector matches two groups of the batch.
    """
    rng = np.random.RandomState(seed)
    pods = []
    for k in range(n_releases):
        chart = RELEASE_CHARTS[k % len(RELEASE_CHARTS)]
        labels = {
            "app.kubernetes.io/name": chart,
            "app.kubernetes.io/instance": f"{chart}-{k}",
            "app.kubernetes.io/component": "server",
        }
        cpu = ["250m", "500m", "1", "2"][rng.randint(4)]
        mem = ["256Mi", "1Gi", "2Gi", "4Gi"][rng.randint(4)]
        for j in range(replicas):
            p = pending_pod(f"{chart}-{k}-server-{j}", cpu, mem, labels=labels)
            p.spec.affinity = soft_anti_affinity(labels)
            pods.append(p)
    for k in range(2):
        base = {"app.kubernetes.io/name": "postgresql", "app.kubernetes.io/instance": f"pg-{k}"}
        for component, n, cpu, mem in (("primary", 1, "1", "2Gi"), ("read", 20, "500m", "1Gi")):
            for j in range(n):
                p = pending_pod(
                    f"pg-{k}-{component}-{j}", cpu, mem,
                    labels={**base, "app.kubernetes.io/component": component},
                )
                p.spec.affinity = soft_anti_affinity(base)
                pods.append(p)
    return pods


def oracle_mix_world(n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES, n_releases: int = N_RELEASES):
    """Bench config 6 whole (``config6_world``) and ``release_pods`` →
    ([nodepool], provider, pods, [], [], {}, None): the release pods go
    to the greedy fallback, config 6's to the tensor path."""
    pools, provider, pods = config6_world(n_pods, n_types)
    return pools, provider, pods + release_pods(n_releases), [], [], {}, None


def oracle_cluster_world(
    n_pods: int = N_CONFIG6, n_types: int = N_TYPES, n_nodes: int = N_NODES, n_releases: int = N_RELEASES
):
    """``oracle_mix_world``'s pods against phase 5's cluster in a kube
    store (``_cluster_world``: pools ``reserved`` and ``default``, the
    ``instance_types(n_types)`` catalog, ``n_nodes`` nodes with their
    bound pods, three daemonsets) → (nodepools, provider, pods,
    state_nodes, daemonset_pods, missing, kube)."""
    pools, provider, _, nodes, daemons, missing, kube = _cluster_world(0, n_types, n_nodes, store=True)
    pods = config6_world(n_pods, 1)[2] + release_pods(n_releases)
    return pools, provider, pods, nodes, daemons, missing, kube


def relax_cluster_world(n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES):
    """Phase 5's world whole (``cluster_world``) under a capacity drought
    and with soft preferences → (nodepools, provider, pods, state_nodes,
    daemonset_pods, missing, None):

    - every offering in ``test-zone-3`` is unavailable, as bench config
      10's capacity-drought shape marks a zone (``bench.py:1495-1568``);
    - every 5th pod prefers ``test-zone-3`` (preferred node affinity,
      weight 100): existing nodes there may take it, a new node cannot;
    - every 20th pod also has a required node affinity of two terms, the
      first naming ``test-zone-4``, a zone no offering has, the second
      ``test-zone-1`` or ``test-zone-2``.
    """
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import (
        Affinity,
        NodeAffinity,
        NodeSelector,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        PreferredSchedulingTerm,
    )

    pools, provider, pods, nodes, daemons, missing = cluster_world(n_pods, n_types, n_nodes)
    for it in provider.instance_types:
        for o in it.offerings:
            if o.zone == DROUGHT_ZONE:
                o.available = False

    def zone_term(*zones):
        return NodeSelectorTerm(
            match_expressions=[NodeSelectorRequirement(wk.LABEL_TOPOLOGY_ZONE, "In", list(zones))]
        )

    for i, p in enumerate(pods):
        if i % 5:
            continue
        na = NodeAffinity(preferred=[PreferredSchedulingTerm(weight=100, preference=zone_term(DROUGHT_ZONE))])
        if i % 20 == 0:
            na.required = NodeSelector(
                node_selector_terms=[zone_term("test-zone-4"), zone_term("test-zone-1", "test-zone-2")]
            )
        p.spec.affinity = Affinity(node_affinity=na)
    return pools, provider, pods, nodes, daemons, missing, None


def greedy_stream(results, pods) -> dict:
    """A greedy ``Results`` by content: claims (nodepool, pod indices,
    instance-type options), existing nodes' pods, errors by pod index."""
    index = {p.uid: i for i, p in enumerate(pods)}
    return dict(
        claims=[
            (c.nodepool_name, [index[p.uid] for p in c.pods], [it.name for it in c.instance_type_options])
            for c in results.new_node_claims
        ],
        existing=[(e.name(), [index[p.uid] for p in e.pods]) for e in results.existing_nodes if e.pods],
        errors={index[uid]: err for uid, err in results.pod_errors.items()},
    )


def same_oracle_as_cpu(res, pods, cpu, cpu_pods, what: str) -> None:
    mine = greedy_stream(res.oracle_results, pods) if res.oracle_results is not None else None
    theirs = greedy_stream(cpu.oracle_results, cpu_pods) if cpu.oracle_results is not None else None
    if mine != theirs:
        fail(f"{what}: the greedy fallback's claims differ between cuda and cpu")


def oracle_placements(res, pods) -> dict:
    """pod index → node key of every greedy-fallback placement: existing
    nodes ``("existing", name)``, claims ``("claim", ordinal)``."""
    where = {}
    if res.oracle_results is None:
        return where
    index = {p.uid: i for i, p in enumerate(pods)}
    for n, c in enumerate(res.oracle_results.new_node_claims):
        for p in c.pods:
            where[index[p.uid]] = ("claim", n)
    for e in res.oracle_results.existing_nodes:
        for p in e.pods:
            where[index[p.uid]] = ("existing", e.name())
    return where


def check_oracle(res, pods, n_release_pods: int, route: dict) -> dict:
    """Fail unless the greedy fallback took exactly the release pods
    (``route``: the solve's ``last_route_stats``), every release pod that
    kept its soft anti-affinity shares no node with another pod its
    selector matches (placements of the tensor path and of the fallback
    both), and every claim's requests fit its cheapest option."""
    from karpenter_core_tpu_torch.cloudprovider.types import order_by_price
    from karpenter_core_tpu_torch.scheduling import resources

    if route["oracle"] != n_release_pods or res.oracle_results is None:
        fail(f"{route['oracle']} pods went to the greedy fallback, not the {n_release_pods} release pods")
    where = {i: node for i, (_, node) in placements(res).items()}
    where.update(oracle_placements(res, pods))
    by_node = {}
    for i, node in where.items():
        by_node.setdefault(node, []).append(i)
    kept = relaxed = 0
    for i, p in enumerate(pods):
        if "app.kubernetes.io/instance" not in p.metadata.labels:
            continue
        a = p.spec.affinity
        if a is None or a.pod_anti_affinity is None or not a.pod_anti_affinity.preferred:
            relaxed += 1
            continue
        kept += 1
        if i not in where:
            continue
        sel = a.pod_anti_affinity.preferred[0].pod_affinity_term.label_selector
        for j in by_node[where[i]]:
            if j != i and sel.matches(pods[j].metadata.labels):
                fail(f"release pod {p.name} shares {where[i]} with {pods[j].name}, which its soft anti-affinity matches")
    claims = res.oracle_results.new_node_claims
    for c in claims:
        cheapest = order_by_price(c.instance_type_options, c.requirements)[0]
        if not resources.fits(c.requests, cheapest.allocatable()):
            fail(f"a greedy claim's requests overflow its cheapest option {cheapest.name}")
    return {
        "oracle_pods": route["oracle"], "oracle_share": route["oracle_share"],
        "oracle_claims": len(claims),
        "oracle_on_existing": sum(len(e.pods) for e in res.oracle_results.existing_nodes),
        "soft_kept": kept, "soft_relaxed": relaxed,
    }


def first_fit(res, pods) -> list:
    """Pods without a topology spread or pod affinity that the solve put
    on existing nodes: the existing-node first-fit places them before any
    spread group gets its zones."""
    return [
        i
        for i, (_, node) in placements(res).items()
        if node[0] == "existing"
        and not pods[i].spec.topology_spread_constraints
        and not (pods[i].spec.affinity is not None and pods[i].spec.affinity.pod_affinity is not None)
    ]


def run_config1_phase(n_pods: int = N_CONFIG1) -> dict:
    """Phase 11, config1: bench config 1 through the port's greedy
    scheduler, as the bench runs it (a warm build and solve, then a fresh
    build and the timed solve); its claims must equal those of a solve of
    the same world built afresh. Host only: no kernel runs."""
    from karpenter_core_tpu_torch.scheduler.builder import build_scheduler

    pools, provider, pods = config1_world(n_pods)
    build_scheduler(None, None, pools, provider, pods).solve(pods)
    sched = build_scheduler(None, None, pools, provider, pods)
    t0 = time.perf_counter()
    res = sched.solve(pods)
    dt = time.perf_counter() - t0
    pools2, provider2, pods2 = config1_world(n_pods)
    again = build_scheduler(None, None, pools2, provider2, pods2).solve(pods2)
    if greedy_stream(res, pods) != greedy_stream(again, pods2):
        fail("config1: the greedy scheduler's claims differ between two builds of the world")
    if res.pod_errors:
        fail(f"config1: {len(res.pod_errors)} pods failed")
    per_node = np.asarray([len(c.pods) for c in res.new_node_claims] or [0], dtype=np.float64)
    row = {
        "config1": f"{n_pods} uniform 500m/512Mi pods x 10 types (bench config 1), the greedy scheduler "
                   "on the host: nothing of this runs on the card",
        "pods_per_s": sum(len(c.pods) for c in res.new_node_claims) / dt,
        "solve_ms": dt * 1000.0,
        "nodes": len(res.new_node_claims),
        "pods_per_node_min": int(per_node.min()), "pods_per_node_max": int(per_node.max()),
        "pods_per_node_mean": float(per_node.mean()), "pods_per_node_stddev": float(per_node.std()),
    }
    emit(row)
    return row


def run_oracle_phase(device: str = "cuda", n_pods: int = N_CONFIG6, n_nodes: int = N_NODES,
                     n_releases: int = N_RELEASES, n_types=(N_CONFIG6_TYPES, N_TYPES)) -> tuple:
    """Phase 11, oracle-mix and oracle-cluster: bench config 6 and the
    Helm releases, as built and against phase 5's cluster → their two
    lines (also emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    rows = []
    for name, world, args in (
        ("oracle_mix", oracle_mix_world, (n_pods, n_types[0], n_releases)),
        ("oracle_cluster", oracle_cluster_world, (n_pods, n_types[1], n_nodes, n_releases)),
    ):
        t0 = time.perf_counter()
        pools, provider, pods, nodes, daemons, missing, kube = world(*args)
        world_s = time.perf_counter() - t0
        n_release = len(pods) - n_pods
        # the CPU solve's own copy, taken before any solve (the greedy
        # scheduler relaxes the pods it is given in place)
        cpu_pods = copy.deepcopy(pods)
        kw = dict(state_nodes=nodes, daemonset_pods=daemons)
        solver = TorchScheduler(pools, provider, device=device, kube_client=kube)
        cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
        if device == "cuda" and launches < (1 + len(warm_runs)) * len(pools):
            fail(f"{name} launched the compat kernel {launches} times in {1 + len(warm_runs)} solves")
        route = dict(solver.last_route_stats)
        cpu = TorchScheduler(pools, provider, device="cpu", kube_client=kube).solve(cpu_pods, **kw)
        same_as_cpu(cold, cpu, name)
        same_oracle_as_cpu(cold, pods, cpu, cpu_pods, name)
        if not nodes:
            check_invariants(cold, pods)
        row = {
            name: (
                f"{len(pods)} pods ({n_pods} bench config 6 + {n_release} Helm release pods with "
                f"Bitnami's soft anti-affinity) x {len(provider.instance_types)} types"
                + (f" x {len(nodes)} existing nodes, kube store seeds" if nodes else ", no existing nodes")
            ),
            "world_build_s": world_s,
            **timing_row(cold, cold_ms, warm_runs, launches),
            **(check_cluster(cold, pods, nodes, daemons, missing, spill=False) if nodes else {}),
            "oracle": check_oracle(cold, pods, n_release, route),
            "affinity": check_affinity(cold, pods, kube),
            "spread": check_spread_serial(cold, pods, provider, first=first_fit(cold, pods)),
            **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
        }
        emit(row)
        rows.append(row)
    return tuple(rows)


def run_relax_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES,
                    n_nodes: int = N_NODES) -> dict:
    """Phase 11, relax-cluster: ``relax_cluster_world`` → its line (also
    emitted); fails on any check."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing, _ = relax_cluster_world(n_pods, n_types, n_nodes)
    world_s = time.perf_counter() - t0
    kw = dict(state_nodes=nodes, daemonset_pods=daemons)
    solver = TorchScheduler(pools, provider, device=device)
    cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **kw)
    relax = dict(solver.last_relax_stats)
    if solver.last_route_stats["oracle"]:
        fail(f"relax-cluster sent {solver.last_route_stats['oracle']} pods to the greedy fallback")
    if relax["rounds"] == 0 or relax["pods_placed"] == 0:
        fail(f"relax-cluster: the relaxation placed no pod ({relax})")
    if device == "cuda" and launches < (1 + len(warm_runs)) * len(pools) * 2:
        fail(f"relax-cluster launched the compat kernel {launches} times in {1 + len(warm_runs)} solves")
    if cold.pod_errors:
        fail(f"relax-cluster: {len(cold.pod_errors)} pods failed")
    if any(p.zone == DROUGHT_ZONE for p in cold.node_plans):
        fail(f"relax-cluster opened a node in {DROUGHT_ZONE}, whose offerings are all unavailable")
    cpu = TorchScheduler(pools, provider, device="cpu").solve(pods, **kw)
    same_as_cpu(cold, cpu, "relax-cluster")
    where = placements(cold)
    row = {
        "relax_cluster": (
            f"{n_pods} pods x {n_types} types x {n_nodes} existing nodes (phase 5's world), every "
            f"{DROUGHT_ZONE} offering unavailable, every 5th pod preferring it, every 20th with a "
            "two-term required zone affinity whose first term no offering meets"
        ),
        "world_build_s": world_s,
        **timing_row(cold, cold_ms, warm_runs, launches),
        **check_cluster(cold, pods, nodes, daemons, missing),
        "relax_rounds": relax["rounds"],
        "relax_pods_retried": relax["pods_retried"],
        "relax_pods_placed": relax["pods_placed"],
        "preferring_pods_in_drought_zone": sum(
            1 for i in range(0, len(pods), 5) if where[i][0] == DROUGHT_ZONE
        ),
        "launches_per_solve": launches / (1 + len(warm_runs)),
        **(profile_solve(solver, pods, **kw) if device == "cuda" else {}),
    }
    emit(row)
    return row


def packing_parity(pods, provider, nodepool, device: str, subsample: Optional[int] = None) -> dict:
    """``packing_parity_vs_oracle`` as ``bench.py:214-243`` computes it,
    the port alone: the port's greedy scheduler against ``TorchScheduler``
    on ``device`` over the same (stratified every-k-th) pods, with the
    batched solve's kernel launches counted from 0."""
    from karpenter_core_tpu_torch.scheduler.builder import build_scheduler
    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    sel = pods
    if subsample is not None and subsample < len(pods):
        step = len(pods) / float(subsample)
        sel = [pods[int(i * step)] for i in range(subsample)]
    t0 = time.perf_counter()
    oracle = build_scheduler(None, None, [nodepool], provider, sel).solve(sel)
    oracle_ms = (time.perf_counter() - t0) * 1000.0
    o_nodes = len(oracle.new_node_claims)
    o_sched = sum(len(c.pods) for c in oracle.new_node_claims)
    ck.COMPAT_ALLOWED.launches = 0
    t0 = time.perf_counter()
    batched = TorchScheduler([nodepool], provider, device=device).solve(sel)
    batched_ms = (time.perf_counter() - t0) * 1000.0
    launches = ck.COMPAT_ALLOWED.launches
    if device == "cuda" and launches == 0:
        fail("the parity solve never launched the compat kernel")
    if batched.pods_scheduled < o_sched:
        parity = 0.0  # scheduling fewer pods is a failure, not "fewer nodes"
    elif batched.node_count <= o_nodes:
        parity = 1.0  # one-sided: "not worse than the oracle"
    else:
        parity = o_nodes / batched.node_count
    return {
        "packing_parity_vs_oracle": round(parity, 4),
        "parity_oracle_nodes": o_nodes,
        "parity_batched_nodes": batched.node_count,
        "parity_oracle_pods": o_sched,
        "parity_batched_pods": batched.pods_scheduled,
        "parity_pods": len(sel),
        "oracle_solve_ms": oracle_ms,
        "batched_cold_solve_ms": batched_ms,
        "kernel_launches": launches,
    }


def run_parity_phase(device: str = "cuda", n_pods: int = N_CONFIG6, n_types: int = N_CONFIG6_TYPES,
                     subsample: int = N_PARITY, n_config1: int = N_CONFIG1) -> tuple:
    """Phase 11, parity: ``packing_parity_vs_oracle`` on config 6's
    stratified subsample and on config 1 → their two lines."""
    rows = []
    pools, provider, pods = config6_world(n_pods, n_types)
    rows.append({
        "parity_config6": f"bench config 6's stratified {subsample}-pod subsample (bench.py:759) x {n_types} types",
        **packing_parity(pods, provider, pools[0], device, subsample),
    })
    pools, provider, pods = config1_world(n_config1)
    rows.append({
        "parity_config1": f"bench config 1, {n_config1} pods x 10 types",
        **packing_parity(pods, provider, pools[0], device),
    })
    for row in rows:
        emit(row)
    return tuple(rows)


# -- phase 12: the pack engines (device scans and the LP backend) --------------

N_CONFIG5 = 10_000  # bench.py config 5: pods, types, six zones, RandomState(3)
N_CONFIG5_TYPES = 2_000
# bench config 10 (bench.py:1463-1660), $/hr per shape under ffd and lp as
# the JAX package gives them: bench.py's config10() run on the JAX
# package on a CPU host (JAX_PLATFORMS=cpu, default knobs, its native
# packer), the run tests/test_torch_lp.py repeats against these values
CONFIG10_REFERENCE = {
    "bignode-trap": (100.0, 68.8),
    "midsize-sweetspot": (74.6, 50.6),
    "podcap-trap": (25.6, 17.6),
    "hetero-split": (99.0, 59.8),
    "hetero-split-narrow": (82.0, 82.0),
    "hetero-split-wide": (150.0, 30.9),
    "spot-cliff-steep": (104.0, 35.7),
    "spot-cliff-shallow": (33.8, 33.02),
    "capacity-drought": (54.7, 44.8),
    "superlinear-ladder": (88.0, 54.4),
    "linear-control": (128.1026, 128.1026),
}
CONFIG10_SAVING_PCT = 41.2  # adversarial shapes, 811.7 -> 477.62 $/hr
# bench config 5 whole under ffd, lp and auto (nodes, $/hr): bench.py's
# config 5 world solved by the JAX package on a CPU host under each backend
CONFIG5_REFERENCE = (164, 873.4703)


def config10_shapes() -> list:
    """bench.py config 10's eleven price shapes (``_price_shapes``) from
    the port's classes: (name, catalog, pods), pods named as
    ``_mk_pod`` names them."""
    from karpenter_core_tpu_torch.cloudprovider.fake import instance_types, new_instance_type
    from karpenter_core_tpu_torch.cloudprovider.types import Offering

    def it(name, cpu, mem_gi, pods, price, available=True):
        return new_instance_type(
            name,
            {"cpu": str(cpu), "memory": f"{mem_gi}Gi", "pods": str(pods)},
            offerings=[
                Offering("on-demand", "test-zone-1", price, available),
                Offering("on-demand", "test-zone-2", price, available),
            ],
        )

    def mk(name, cpu, mem):
        return pending_pod(f"bench-{name}", cpu, mem)

    rng = np.random.RandomState(17)
    shapes = [
        ("bignode-trap", [it("huge", 64, 128, 110, 20.0), it("small", 4, 8, 110, 0.8)],
         [mk(f"big-{i}", "1", "2Gi") for i in range(256)]),
        ("midsize-sweetspot",
         [it("xl", 96, 192, 220, 14.0), it("m", 48, 96, 110, 4.6), it("s", 8, 16, 110, 1.1)],
         [mk(f"mid-{i}", "2", "3Gi") for i in range(240)]),
        ("podcap-trap", [it("dense", 16, 32, 32, 3.2), it("lean", 16, 32, 8, 0.55)],
         [mk(f"cap-{i}", "100m", "128Mi") for i in range(256)]),
    ]

    def hetero(tag, gen_price, cpu_price, mem_price):
        cat = [it(f"general-{tag}", 32, 64, 110, gen_price), it(f"cpuopt-{tag}", 32, 8, 110, cpu_price),
               it(f"memopt-{tag}", 4, 64, 110, mem_price)]
        pods = [mk(f"cpuh-{tag}-{i}", "3", "256Mi") for i in range(96)] + [
            mk(f"memh-{tag}-{i}", "100m", "4Gi") for i in range(96)
        ]
        return cat, pods

    shapes.append(("hetero-split", *hetero("mid", 9.9, 3.6, 3.4)))
    shapes.append(("hetero-split-narrow", *hetero("nar", 8.2, 6.9, 6.7)))
    shapes.append(("hetero-split-wide", *hetero("wide", 15.0, 1.9, 1.7)))
    cliff = [it("cliff-s", 4, 8, 110, 0.6), it("cliff-m", 8, 16, 110, 1.3), it("cliff-l", 16, 32, 110, 8.0)]
    shapes.append(("spot-cliff-steep", cliff, [mk(f"spot-{i}", "1", "2Gi") for i in range(192)]))
    shallow = [it("shal-s", 4, 8, 110, 0.62), it("shal-m", 8, 16, 110, 1.2), it("shal-l", 16, 32, 110, 2.6)]
    shapes.append(("spot-cliff-shallow", shallow, [mk(f"shal-{i}", "1", "2Gi") for i in range(192)]))
    drought = [
        it("dry-s", 4, 8, 110, 0.7),
        it("dry-m1", 8, 16, 110, 1.3, available=False),
        it("dry-m2", 16, 32, 110, 2.5, available=False),
        it("dry-l", 64, 128, 110, 18.0),
    ]
    shapes.append(("capacity-drought", drought, [mk(f"dry-{i}", "1", "2Gi") for i in range(192)]))
    ladder = [it("lad-4", 4, 8, 110, 0.8), it("lad-8", 8, 16, 110, 1.7), it("lad-16", 16, 32, 110, 3.8),
              it("lad-32", 32, 64, 110, 9.0), it("lad-64", 64, 128, 110, 22.0)]
    shapes.append(("superlinear-ladder", ladder, [mk(f"lad-{i}", "1", "2Gi") for i in range(224)]))
    lin = [
        mk(f"lin-{i}", ["250m", "500m", "1", "2"][rng.randint(4)], ["512Mi", "1Gi", "2Gi"][rng.randint(3)])
        for i in range(400)
    ]
    shapes.append(("linear-control", instance_types(20), lin))
    return shapes


def config5_world(n_pods: int = N_CONFIG5, n_types: int = N_CONFIG5_TYPES):
    """bench.py config 5 (``config5``, :617-671): spot-weighted packing,
    2,000 types x 6 zones with on-demand and spot offerings drawn from
    RandomState(3), 10,000 pods → (nodepool, provider, pods)."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import (
        FakeCloudProvider,
        new_instance_type,
        price_from_resources,
    )
    from karpenter_core_tpu_torch.cloudprovider.types import Offering
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    rng = np.random.RandomState(3)
    zones = [f"test-zone-{z}" for z in range(1, 7)]
    cat = []
    for i in range(n_types):
        cpu, mem = (i % 64) + 1, 2 * ((i % 64) + 1)
        res = {"cpu": str(cpu), "memory": f"{mem}Gi", "pods": str(max(110, cpu * 8))}
        base = price_from_resources({k: parse_quantity(v) for k, v in res.items()})
        offerings = []
        for z in zones:
            od = base * (1.0 + 0.05 * rng.rand())
            spot = od * (0.25 + 0.5 * rng.rand())
            offerings.append(Offering(wk.CAPACITY_TYPE_ON_DEMAND, z, od))
            offerings.append(Offering(wk.CAPACITY_TYPE_SPOT, z, spot))
        cat.append(new_instance_type(f"fake-it-{i}", res, offerings=offerings))
    provider = FakeCloudProvider()
    provider.instance_types = cat
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    pods = []
    for i in range(n_pods):
        cpu = ["250m", "500m", "1", "2"][rng.randint(4)]
        mem = ["512Mi", "1Gi", "2Gi"][rng.randint(3)]
        pods.append(pending_pod(f"bench-{i}", cpu, mem))
    return nodepool, provider, pods


def plan_sha256(res) -> str:
    """Digest of the ordered plan stream (the ROADMAP's plan identity)."""
    return hashlib.sha256(json.dumps(plan_stream(res)).encode()).hexdigest()


def pack_kernels() -> dict:
    """The pack engines' kernel wrappers, by kernel name."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver.backends import lp

    return {"ffd_pack": pack.FFD_PACK, "pack_existing": pack.PACK_EXISTING, "dual_ascent": lp.DUAL_ASCENT}


def reset_pack_launches() -> None:
    for k in pack_kernels().values():
        k.launches = 0


def pack_launches() -> dict:
    return {name: k.launches for name, k in pack_kernels().items()}


class knobs:
    """Environment knobs set for a block, restored after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class capture:
    """Record (on the CPU) the tensor arguments of every call of
    ``module.attr`` inside the block, up to ``limit`` calls."""

    def __init__(self, module, attr: str, limit: int = 1 << 30):
        self.module, self.attr, self.limit, self.calls = module, attr, limit, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.attr)

        def spy(*args):
            if len(self.calls) < self.limit:
                self.calls.append(tuple(a.detach().cpu().clone() if hasattr(a, "detach") else a for a in args))
            return real(*args)

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


class capture_kw:
    """Record the arguments of the first ``limit`` calls of
    ``module.attr`` inside the block as keyword dicts (numpy arrays
    copied; ``device`` left out)."""

    def __init__(self, module, attr: str, limit: int = 1):
        self.module, self.attr, self.limit, self.calls = module, attr, limit, []

    def __enter__(self):
        import inspect

        real = self.real = getattr(self.module, self.attr)
        sig = inspect.signature(real)

        def spy(*args, **kw):
            if len(self.calls) < self.limit:
                bound = sig.bind(*args, **kw).arguments
                self.calls.append({k: (np.array(v) if isinstance(v, np.ndarray) else v)
                                   for k, v in bound.items() if k != "device"})
            return real(*args, **kw)

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


class timed:
    """Sum the wall time of every call of ``module.attr`` inside the block
    (a device function's callers sync on its result, so this is its
    share of the solve)."""

    def __init__(self, module, attr: str):
        self.module, self.attr, self.ms, self.n = module, attr, 0.0, 0

    def __enter__(self):
        real = self.real = getattr(self.module, self.attr)

        def spy(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                self.ms += (time.perf_counter() - t0) * 1000.0
                self.n += 1

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


def config10_rows(device: str, profile: bool = False) -> list:
    """bench config 10 on ``device``: each shape solved under ffd and lp
    (a cold solve, the scheduler fresh and the relax memo empty, then a
    warm one) → one row per shape: $/hr, nodes, pods, plan digest, cold
    and warm ms of both, the cold lp solve's pack stats, pack and relax
    ms and dual-ascent launches, and the relaxation lower bound of the lp
    plan; with ``profile`` a profiled cold lp solve too (the idle share)."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends, plancost
    from karpenter_core_tpu_torch.solver.backends import lp

    rows = []
    for name, catalog, pods in config10_shapes():
        row = {"shape": name, "pods": len(pods), "types": len(catalog)}
        for bk in ("ffd", "lp"):
            backends.reset_for_tests()
            provider = FakeCloudProvider()
            provider.instance_types = list(catalog)
            pool = NodePool()
            pool.metadata.name = "default"
            solver = TorchScheduler([pool], provider, device=device)
            before = lp.DUAL_ASCENT.launches
            with knobs(KARPENTER_TORCH_PACK_BACKEND=bk):
                with timed(lp, "relax") as relax:
                    t0 = time.perf_counter()
                    res = solver.solve(pods)
                    solve_ms = (time.perf_counter() - t0) * 1000.0
                if bk == "lp":
                    row["dual_ascent_launches"] = lp.DUAL_ASCENT.launches - before
                    row["relax_ms"] = relax.ms
                    row["relax_share"] = relax.ms / solve_ms
                    row["pack_ms"] = solver.last_timings["pack_ms"]
                    row["stats"] = dict(solver.last_pack_stats)
                t0 = time.perf_counter()
                solver.solve(pods)  # warm: the relax memo hits, no dual ascent
                row[f"{bk}_warm_ms"] = (time.perf_counter() - t0) * 1000.0
                if profile and bk == "lp":
                    # a cold lp solve under the profiler: its relaxations run again
                    backends.reset_for_tests()
                    row["lp_cold_profile"] = profile_solve(solver, pods)
            row[bk] = round(res.total_price, 4)
            row[f"{bk}_nodes"] = res.node_count
            row[f"{bk}_pods"] = res.pods_scheduled
            row[f"{bk}_sha"] = plan_sha256(res)
            row[f"{bk}_ms"] = solve_ms
            if bk == "lp":
                row["bound"] = plancost.relaxation_lower_bound(res.node_plans, catalog, device=device)
        rows.append(row)
    return rows


def check_config10(rows) -> dict:
    """The JAX package's $/hr per shape and backend, lp <= ffd, bound <=
    cost, the same pods scheduled under both, and the adversarial
    saving."""
    for r in rows:
        want = CONFIG10_REFERENCE[r["shape"]]
        if (r["ffd"], r["lp"]) != want:
            fail(f"config10 {r['shape']}: $/hr {(r['ffd'], r['lp'])}, the JAX package gives {want}")
        if r["lp"] > r["ffd"] + 1e-6:
            fail(f"config10 {r['shape']}: lp {r['lp']} prices above ffd {r['ffd']}")
        if r["bound"] > r["lp"] + 1e-6:
            fail(f"config10 {r['shape']}: bound {r['bound']} above the lp plan's {r['lp']}")
        if r["lp_pods"] != r["ffd_pods"]:
            fail(f"config10 {r['shape']}: lp schedules {r['lp_pods']} pods, ffd {r['ffd_pods']}")
    adv = [r for r in rows if r["shape"] != "linear-control"]
    ffd, lp = sum(r["ffd"] for r in adv), sum(r["lp"] for r in adv)
    saving = round((ffd - lp) / ffd * 100.0, 1)
    if saving != CONFIG10_SAVING_PCT:
        fail(f"config10: adversarial saving {saving} %, the JAX package's is {CONFIG10_SAVING_PCT} %")
    return {"adversarial_ffd": round(ffd, 4), "adversarial_lp": round(lp, 4), "saving_pct": saving}


def events_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` back-to-back calls of ``fn`` queued
    behind a device sleep (host enqueue hidden) → ms per call."""
    import torch

    reps = cut_reps(reps)
    fn()
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(DEVICE_SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_row(bytes_moved: float, ops: float) -> dict:
    b, o = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations", "bytes": bytes_moved, "ops": ops}


def ffd_kernel_case(call, reps: int = 3, check=None) -> dict:
    """The FFD scan kernel against its plain version on the card, on one
    captured call (requests, frontiers, caps, k_open, n_pods), bit for
    bit, with both times and the bound: each real pod's requests read
    once, the frontiers once, ids and counts written once; the fit tests
    the pods need, (K + 1) x F x R int32 compares each at most.
    ``step_us``: the kernel's time over the longest job's pods (the
    jobs run side by side). ``check(plain_ids, plain_counts)``, when
    given, holds the plain result to what the captured call's caller
    made of the kernel's."""
    import torch

    from karpenter_core_tpu_torch.solver import pack

    req, front, caps, k_open, n = (a.cuda() if hasattr(a, "cuda") else a for a in call)
    G, P, R = req.shape
    F = front.shape[1]
    ids, counts = pack.ffd_pack_batched(req, front, caps, k_open, n)
    m = int(n.max())
    t0 = time.perf_counter()
    plain_ids, plain_counts = pack.ffd_pack_reference(req[:, :m], front, caps, k_open)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    plain_ids = torch.nn.functional.pad(plain_ids, (0, P - m), value=-1)
    if not (torch.equal(ids, plain_ids) and torch.equal(counts, plain_counts)):
        fail(f"ffd_pack kernel differs from its plain version at G={G} P={P} F={F} R={R}")
    if check is not None:
        check(plain_ids, plain_counts)
    pods = int(n.sum())
    kernel_ms = events_ms(lambda: pack.ffd_pack_batched(req, front, caps, k_open, n), reps)
    return {
        "G": G, "P": P, "F": F, "R": R, "pods": pods, "longest_job": m, "max_abs_err": 0,
        "kernel_ms": kernel_ms, "step_us": kernel_ms * 1000.0 / max(m, 1),
        "plain_ms": plain_ms,
        **bound_row(pods * R * 4 + G * F * R * 4 + pods * 4 + G * 8, pods * (k_open + 1) * F * R),
    }


def existing_kernel_case(call, reps: int = 3) -> dict:
    """The existing-node first-fit kernel against its plain version on
    the card, bit for bit; the bound counts the node checks this data
    needs (each pod walks the nodes up to the one it takes, all of them
    when it fits none, R compares each). ``step_us``: the kernel's time
    over the pods."""
    import torch

    from karpenter_core_tpu_torch.solver import pack

    req, sig, compat, free = (a.cuda() for a in call)
    P, R = req.shape
    S, M = compat.shape
    assign, free_out = pack.pack_existing(req, sig, compat, free)
    t0 = time.perf_counter()
    plain_assign, plain_free = pack.pack_existing_reference(req, sig, compat, free)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if not (torch.equal(assign, plain_assign) and torch.equal(free_out, plain_free)):
        fail(f"pack_existing kernel differs from its plain version at P={P} M={M} R={R}")
    walked = torch.where(assign >= 0, assign + 1, torch.full_like(assign, M)).sum().item()
    kernel_ms = events_ms(lambda: pack.pack_existing(req, sig, compat, free), reps)
    return {
        "P": P, "M": M, "R": R, "S": S, "placed": int((assign >= 0).sum()), "max_abs_err": 0,
        "kernel_ms": kernel_ms, "step_us": kernel_ms * 1000.0 / max(P, 1),
        "plain_ms": plain_ms,
        **bound_row(P * (R + 1) * 4 + S * M + 2 * M * R * 4 + P * 4, walked * R),
    }


def synthetic_scan_calls(seed: int = 0) -> dict:
    """Scan calls at shapes a solve gives but phase 12's paths do not,
    from a seed, each (label, call): the stateful widths (cpu, memory and
    pods, then host-port columns holding 1 and CSI-driver volume columns
    holding 16, a pod asking for each with chance 0.05 and 0.3), which
    take B5's shared-memory rows and B6's wide register path, a width
    past what B5 prefetches (700 columns), and a cluster past 4,096 nodes,
    which takes B6's generic path."""
    import torch

    rng = np.random.RandomState(seed)

    def columns(shape, R, free_lo, free_hi):
        free = np.zeros(shape + (R,), np.int32)
        free[..., 0] = rng.randint(free_lo[0], free_hi[0], shape)
        free[..., 1] = rng.randint(free_lo[1], free_hi[1], shape)
        free[..., 2] = 110
        for r in range(3, R):
            free[..., r] = 1 if r % 2 else 16
        return free

    def pods(shape, R):
        req = np.zeros(shape + (R,), np.int32)
        req[..., 0] = rng.randint(100, 2000, shape)
        req[..., 1] = rng.randint(128, 4096, shape)
        req[..., 2] = 1
        for r in range(3, R):
            req[..., r] = rng.rand(*shape) < (0.05 if r % 2 else 0.3)
        return req

    def existing(P, M, R, S):
        compat = (rng.rand(S, M) < 0.7).astype(np.uint8) if S > 1 else np.ones((1, M), np.uint8)
        arrays = (pods((P,), R), rng.randint(0, S, P).astype(np.int32), compat,
                  columns((M,), R, (4000, 16000), (64000, 256000)))
        return tuple(torch.from_numpy(a) for a in arrays)

    def ffd_class(G, P, R):
        req = pods((G, P), R)
        req = req[np.arange(G)[:, None], np.argsort(-req[..., 0], axis=1, kind="stable")]
        return (torch.from_numpy(req), torch.from_numpy(columns((G, 3), R, (8000, 32000), (64000, 256000))),
                torch.full((G,), 110, dtype=torch.int32), 16, torch.full((G,), P, dtype=torch.int32))

    # drawn in this order, so each case keeps its data as cases are added
    width12 = ffd_class(4, 4096, 12)
    existing_calls = [("stateful width 12, 1,000 nodes", existing(10_000, 1000, 12, 1)),
                      ("5,000 nodes", existing(10_000, 5000, 3, 4))]
    # width 12 prefetches its requests and keeps the usage rows in shared
    # memory; width 700 reads its requests in place
    return {
        "ffd_pack": [("stateful width 12", width12), ("width 700, requests in place", ffd_class(4, 1024, 700))],
        "pack_existing": existing_calls,
    }


def dual_kernel_case(call, reps: int = 5) -> dict:
    """The dual-ascent kernel against its plain version on the card, bit
    for bit (t*, has_fit and w).
    The bound counts the work this data needs, not the padded shape's:
    the real signatures (count > 0), the valid types some real signature
    fits, and per iteration the routing over the pairs that fit (2R flops
    each), the projection and the update of those types (4R each) and the
    demand sums of the routed signatures (R each); the bytes read the real
    rows and the valid mask once (1 byte per type) and write the real rows
    of w, t* and has_fit once. ``iter_us``: the kernel's time over its
    iters + 1 routes."""
    import torch

    from karpenter_core_tpu_torch.solver.backends import lp

    torch.backends.cuda.matmul.allow_tf32 = False
    reqs, counts, alloc, prices, valid, w0, iters = (a.cuda() if hasattr(a, "cuda") else a for a in call)
    S, R = reqs.shape
    T = alloc.shape[0]
    plan = lp.dual_ascent_plan(S, T, R)
    w, t_star, has_fit = lp.dual_ascent(reqs, counts, alloc, prices, valid, w0, iters)
    t0 = time.perf_counter()
    pw, pt, ph = lp.dual_ascent_reference(reqs, counts, alloc, prices, valid, w0, iters)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if not (torch.equal(t_star, pt) and torch.equal(has_fit, ph)):
        fail(f"dual_ascent kernel's routes differ from its plain version at S={S} T={T} R={R}")
    if not torch.equal(w, pw):
        fail(f"dual_ascent kernel's weights differ from its plain version at S={S} T={T} R={R} "
             f"(max {float((w - pw).abs().max())})")
    real = counts > 0
    fit = (reqs[:, None, :] <= alloc[None, :, :]).all(dim=-1) & valid[None, :] & real[:, None]
    s_real, t_valid = int(real.sum()), int(valid.sum())
    pairs, t_fit, s_routed = int(fit.sum()), int(fit.any(dim=0).sum()), int(fit.any(dim=1).sum())
    flops = (iters + 1) * (pairs * 2 * R + t_fit * 4 * R) + iters * (s_routed * R + t_fit * 4 * R)
    nbytes = s_real * (R + 1) * 4 + t_valid * (2 * R + 1) * 4 + T + t_valid * R * 4 + s_real * 5
    kernel_ms = events_ms(lambda: lp.dual_ascent(reqs, counts, alloc, prices, valid, w0, iters), reps)
    return {
        "S": S, "T": T, "R": R, "iters": iters, "s_real": s_real, "t_valid": t_valid, "pairs": pairs,
        "plan": plan,
        "max_abs_err": float((w - pw).abs().max()), "bit_equal": True,
        "kernel_ms": kernel_ms, "iter_us": kernel_ms * 1000.0 / (iters + 1),
        "plain_ms": plain_ms,
        **bound_row(nbytes, flops),
    }


def synthetic_dual_calls(seed: int = 0) -> list:
    """Dual-ascent calls at shapes no phase-12 path gives, from a seed,
    each (label, call), padded as ``lp.relax`` pads: a catalog past 2,048
    types (T = 4,096 × S = 64, R = 3) and a work area past shared memory
    (T = 2,048 × S = 64, R = 12, 40 iterations), which takes the
    device-memory layout."""
    import torch

    rng = np.random.RandomState(seed)

    def call(S, T, R, iters):
        s_real, t_real = S - S // 4, T - T // 40
        reqs = np.zeros((S, R), np.float32)
        reqs[:s_real] = rng.randint(1, 200, size=(s_real, R))
        counts = np.zeros(S, np.float32)
        counts[:s_real] = rng.randint(1, 50, size=s_real)
        alloc = np.zeros((T, R), np.float32)
        alloc[:t_real] = rng.randint(100, 4000, size=(t_real, R))
        prices = np.full(T, np.float32(1e12), np.float32)
        prices[:t_real] = rng.rand(t_real) * 10 + 0.5
        valid = np.arange(T) < t_real
        w0 = (1.0 / np.maximum(alloc, 1.0)).astype(np.float32)
        return tuple(torch.from_numpy(a) for a in (reqs, counts, alloc, prices, valid, w0)) + (iters,)

    return [("catalog of 4,096 types", call(64, 4096, 3, 160)),
            ("work area in device memory", call(64, 2048, 12, 40))]


def relax_split(call: dict, reps: int = 10) -> dict:
    """One captured ``lp.relax`` call (keyword arguments) on the card,
    split into its parts (pad, the six uploads, the kernel, the three
    downloads, the host's float64 bound), median ms over ``reps``, beside
    the whole call unsplit (no syncs between its parts)."""
    from karpenter_core_tpu_torch.solver.backends import lp

    parts: dict = {}
    for _ in range(reps + 1):
        got: dict = {}
        lp.relax(**call, device="cuda", timings=got)
        for k, v in got.items():
            parts.setdefault(k, []).append(v)
    t0 = time.perf_counter()
    for _ in range(reps):
        lp.relax(**call, device="cuda")
    out = {k: float(np.median(v[1:])) for k, v in parts.items()}
    out["relax_ms"] = (time.perf_counter() - t0) * 1000.0 / reps
    reqs, alloc = call["reqs"], call["alloc"]
    out.update({"S": int(reqs.shape[0]), "T": int(alloc.shape[0]), "iters": int(call["iters"])})
    return out


def device_engine_path(label: str, device: str, world, solve_kw: dict, cpu_world=None) -> tuple:
    """One device-engine path (KARPENTER_TORCH_NATIVE=0): ``solve_runs``'s
    cold and warm solves on ``device`` with the pack kernels' launches counted from
    0, the kernels' captured inputs, the same world solved on the CPU
    through the plain scans (``cpu_world``: a smaller world when the
    plain scans would take too long) → (row, ffd calls, existing calls)."""
    from karpenter_core_tpu_torch.solver import TorchScheduler, pack

    pools, provider, pods = world[:3]
    with knobs(KARPENTER_TORCH_NATIVE=0):
        solver = TorchScheduler(pools, provider, device=device)
        with capture(pack, "ffd_pack_batched", 64) as ffd, capture(pack, "pack_existing", 64) as ex:
            reset_pack_launches()
            with timed(pack, "batch_pack") as scan:
                cold, cold_ms, warm_runs, launches = solve_runs(solver, pods, **solve_kw)
            kernels = pack_launches()
        # batch_pack syncs on its results: its wall time holds the scans
        row = {"path": label, **timing_row(cold, cold_ms, warm_runs, launches), "pack_kernel_launches": kernels,
               "batch_pack_ms_per_solve": scan.ms / (1 + len(warm_runs))}
        if device == "cuda":
            if kernels["ffd_pack"] == 0 or (solve_kw.get("state_nodes") and kernels["pack_existing"] == 0):
                fail(f"{label}: the device engine's solves launched {kernels}")
            row.update(profile_solve(solver, pods, **solve_kw))
        check = cpu_world or world
        cpu_pods = check[2]
        ref = TorchScheduler(check[0], check[1], device="cpu")
        t0 = time.perf_counter()
        cpu = ref.solve(cpu_pods, **check[3]) if cpu_world else ref.solve(pods, **solve_kw)
        row["cpu_solve_s"] = time.perf_counter() - t0
        if cpu_world is None:
            same_as_cpu(cold, cpu, label)
        else:
            res = TorchScheduler(check[0], check[1], device=device).solve(cpu_pods, **check[3])
            same_as_cpu(res, cpu, f"{label} at {len(cpu_pods)} pods")
            row["cpu_compare_pods"] = len(cpu_pods)
    return row, ffd.calls, ex.calls


def run_pack_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES, n_nodes: int = N_NODES,
                   cpu_pods: Optional[int] = None) -> dict:
    """Phase 12 → its rows and the kernel cases."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends, calibrate
    from karpenter_core_tpu_torch.solver.backends import lp

    out: dict = {"paths": [], "launches": {}}
    # the device engine on config 3 whole and on phase 5's cluster
    small = None
    if cpu_pods is not None:
        pools, provider, pods = config3_world(cpu_pods, n_types)
        small = (pools, provider, pods, {})
    row, ffd_calls, _ = device_engine_path(
        "config3-device", device, config3_world(n_pods, n_types), {}, small
    )
    out["paths"].append(row)
    out["launches"]["config3-device"] = row["pack_kernel_launches"]
    cw = cluster_world(n_pods, n_types, n_nodes)
    small = None
    if cpu_pods is not None:
        sw = cluster_world(cpu_pods, n_types, n_nodes)
        small = (sw[0], sw[1], sw[2], dict(state_nodes=sw[3], daemonset_pods=sw[4]))
    row, cluster_ffd, ex_calls = device_engine_path(
        "cluster-device", device, cw, dict(state_nodes=cw[3], daemonset_pods=cw[4]), small
    )
    out["paths"].append(row)
    out["launches"]["cluster-device"] = row["pack_kernel_launches"]
    out["ffd_calls"], out["existing_calls"] = ffd_calls + cluster_ffd, ex_calls

    # the LP backend on bench config 10 whole: the card, then the CPU
    with capture(lp, "dual_ascent", 512) as duals, capture_kw(lp, "relax") as relax10:
        reset_pack_launches()
        rows = config10_rows(device, profile=device == "cuda")
        out["launches"]["config10"] = pack_launches()
    if device == "cuda":
        cpu_rows = config10_rows("cpu")
        for r, c in zip(rows, cpu_rows):
            if (r["ffd_sha"], r["lp_sha"]) != (c["ffd_sha"], c["lp_sha"]):
                fail(f"config10 {r['shape']}: the plans differ between cuda and cpu")
        for r in rows:
            if r["dual_ascent_launches"] == 0:
                fail(f"config10 {r['shape']}: the lp solve launched no dual ascent")
    out["config10"] = {"rows": rows, **check_config10(rows)}
    # config 10's repair packs through the device scan (lp, native off)
    with knobs(KARPENTER_TORCH_NATIVE=0):
        reset_pack_launches()
        dev_rows = config10_rows_device(device)
        out["launches"]["config10-device"] = pack_launches()
    out["config10_device"] = dev_rows

    # bench config 5 whole under ffd, lp and auto (threshold pinned), at size
    cal = calibrate.lp_calibration(device)
    emit({"lp_calibration": cal})
    nodepool, provider, pods = config5_world()
    c5 = {}
    with capture(lp, "dual_ascent", 8) as big_duals, capture_kw(lp, "relax") as relax5:
        for bk in ("ffd", "lp", "auto"):
            backends.reset_for_tests()
            with knobs(KARPENTER_TORCH_PACK_BACKEND=bk, KARPENTER_TORCH_LP_MIN_WORK=1), timed(lp, "relax") as relax:
                solver = TorchScheduler([nodepool], provider, device=device)
                reset_pack_launches()
                cold_stats = []
                real_solve = solver.solve

                def solve_and_keep_stats(*a, **kw):
                    res = real_solve(*a, **kw)
                    cold_stats.append(dict(solver.last_pack_stats))
                    return res

                solver.solve = solve_and_keep_stats
                cold, cold_ms, warm_runs, launches = solve_runs(solver, pods)
                solver.solve = real_solve
                kernels = pack_launches()
                row = {"path": f"config5-{bk}", **timing_row(cold, cold_ms, warm_runs, launches),
                       "pack_kernel_launches": kernels, "pack_stats": cold_stats[0],
                       "warm_ascent_iters": [st.get("ascent_iters", 0) for st in cold_stats[1:]],
                       "relax_ms_4_solves": relax.ms, "relax_share": relax.ms / (cold_ms + sum(m for m, _ in warm_runs)),
                       "plan_sha256": plan_sha256(cold)}
                if device == "cuda":
                    row.update(profile_solve(solver, pods))
            if (cold.node_count, round(cold.total_price, 4)) != CONFIG5_REFERENCE:
                fail(f"config5 {bk}: {cold.node_count} nodes at {cold.total_price}/hr, "
                     f"the JAX package gives {CONFIG5_REFERENCE}")
            if bk != "ffd":
                if kernels["dual_ascent"] == 0 and device == "cuda":
                    fail(f"config5 {bk}: no dual ascent launched")
                if row["pack_stats"].get("ffd_kept") != 1 or row["pack_stats"].get("lp_won") != 0:
                    fail(f"config5 {bk}: the cost guard did not keep FFD ({row['pack_stats']})")
            c5[bk] = cold
            out["paths"].append(row)
            out["launches"][f"config5-{bk}"] = kernels
    if len({plan_sha256(r) for r in c5.values()}) != 1:
        fail("config5: ffd, lp and auto give different plans")
    if device == "cuda":
        with knobs(KARPENTER_TORCH_PACK_BACKEND="lp"):
            backends.reset_for_tests()
            cpu = TorchScheduler([nodepool], provider, device="cpu").solve(pods)
        same_as_cpu(c5["lp"], cpu, "config5 lp")
    out["dual_calls"] = duals.calls + big_duals.calls
    out["relax_calls"] = {"config5": relax5.calls, "config10": relax10.calls}
    backends.reset_for_tests()
    return out


def config10_rows_device(device: str) -> list:
    """config 10 under lp with the native packer off: the FFD candidate
    and every repair pack (one-row frontiers) through the device scan; lp
    <= ffd's plan, and on the card the plans equal the CPU's."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends

    rows = []
    for name, catalog, pods in config10_shapes():
        got = {}
        for dev in (device, "cpu") if device == "cuda" else (device,):
            for bk in ("ffd", "lp"):
                backends.reset_for_tests()
                provider = FakeCloudProvider()
                provider.instance_types = list(catalog)
                pool = NodePool()
                pool.metadata.name = "default"
                with knobs(KARPENTER_TORCH_PACK_BACKEND=bk):
                    res = TorchScheduler([pool], provider, device=dev).solve(pods)
                got[(dev, bk)] = (plan_sha256(res), round(res.total_price, 4), res.pods_scheduled)
        if device == "cuda" and got[("cuda", "lp")] != got[("cpu", "lp")]:
            fail(f"config10 {name} on the device scan: the plans differ between cuda and cpu")
        if got[(device, "lp")][1] > got[(device, "ffd")][1] + 1e-6 or got[(device, "lp")][2] != got[(device, "ffd")][2]:
            fail(f"config10 {name} on the device scan: lp {got[(device, 'lp')]} against ffd {got[(device, 'ffd')]}")
        rows.append({"shape": name, "ffd": got[(device, "ffd")][1], "lp": got[(device, "lp")][1]})
    return rows


def distinct_shapes(calls) -> list:
    """The first captured call of each distinct argument shape (tensor
    shapes and scalar arguments), in capture order."""
    seen, out = set(), []
    for call in calls:
        key = tuple(tuple(a.shape) if hasattr(a, "shape") else a for a in call)
        if key not in seen:
            seen.add(key)
            out.append(call)
    return out


PACK_SOURCES = {
    "ffd_pack": ("karpenter_core_tpu_torch/csrc/ffd_pack.cu", "karpenter_core_tpu/solver/pack.py:80"),
    "pack_existing": ("karpenter_core_tpu_torch/csrc/pack_existing.cu", "karpenter_core_tpu/solver/pack.py:155"),
    "dual_ascent": ("karpenter_core_tpu_torch/csrc/dual_ascent.cu", "karpenter_core_tpu/solver/backends/lp.py:97"),
}


def pack_kernel_entry(name: str, rows: list, launches: dict, relax_rows: Optional[dict] = None,
                      config12: Optional[list] = None) -> dict:
    """One pack kernel's entry of the kernels line: its launches on the
    phase-12 paths, and the numbers of its largest case (by kernel
    time), the other cases beside them; for B7 the ``lp.relax`` call
    around it (``wrapper_ms``: config 5's whole relax call, and each
    split); for B5 ``config12``, phase 21a's curve (its launch's time in
    each cell)."""
    main = max((r for r in rows if "synthetic" not in r), key=lambda r: r["kernel_ms"])
    by_path = {path: counts[name] for path, counts in launches.items()}
    source, replaces = PACK_SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        # no one PyTorch call computes a sequential scan or an iterated ascent
        "library_ms": None,
        **({"step_us": main["step_us"]} if "step_us" in main else {}),
        **({"iter_us": main["iter_us"], "plan": main["plan"]} if "iter_us" in main else {}),
        **({"wrapper_ms": relax_rows["config5"]["relax_ms"], "relax_split": relax_rows} if relax_rows else {}),
        **({"at_config12": [{k: r[k] for k in ("pods", "types", "n_devices", "b5_ms", "wall_ms")} for r in config12]}
           if config12 else {}),
        "cases": rows,
    }


# -- phase 13: the provisioner entry -----------------------------------------------

N_CONFIG2 = 10_000  # bench.py config 2: pods, RandomState(7), 480 + 20 GPU types
CONFIG2_SEED = 7
N_GUARD_NODES = 200  # phase 13c's cut: phase 9's cluster at 200 nodes and 3,000 anti pods
N_GUARD_ANTI = 3_000
STORE_CLOCK = 50_000.0  # the fixed clock of phase 13's stores, clusters and recorders


def config2_world(n_pods: int = N_CONFIG2):
    """bench.py config 2 whole (``bench.py:421-466``): ``instance_types(480)``
    plus 20 ``fake-gpu-g`` types (8(g+1) CPU, 16(g+1) Gi, 110 pods,
    min(8, g+1) ``nvidia.com/gpu``), one NodePool ``default``, ``n_pods``
    pods of RandomState(7) sizes, one in ten asking one GPU →
    ([nodepool], provider, pods)."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types, new_instance_type
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    rng = np.random.RandomState(CONFIG2_SEED)
    provider = FakeCloudProvider()
    catalog = instance_types(480)
    for g in range(20):
        catalog.append(new_instance_type(
            f"fake-gpu-{g}",
            {"cpu": str(8 * (g + 1)), "memory": f"{16 * (g + 1)}Gi", "pods": "110",
             "nvidia.com/gpu": str(min(8, g + 1))},
        ))
    provider.instance_types = catalog
    nodepool = NodePool()
    nodepool.metadata.name = "default"
    pods = []
    for i in range(n_pods):
        cpu = ["100m", "250m", "500m", "1", "2", "4"][rng.randint(6)]
        mem = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi"][rng.randint(5)]
        pod = pending_pod(f"bench-{i}", cpu, mem)
        if rng.rand() < 0.1:
            pod.spec.containers[0].resources.requests["nvidia.com/gpu"] = parse_quantity("1")
        pods.append(pod)
    return [nodepool], provider, pods


def store_objects(pools, pods, nodes=(), bound=(), daemons=()) -> list:
    """A live cluster's objects for a store, in the order its watches
    would see them: for each existing node (``StateNode``) its launched
    NodeClaim (the node's provider id, labels and resources) and its
    Node; the ``bound`` pods; a DaemonSet per daemon pod; the NodePools;
    then the pending ``pods``."""
    from karpenter_core_tpu_torch.apis.nodeclaim import NodeClaim
    from karpenter_core_tpu_torch.kube.objects import DaemonSet

    out = []
    for sn in nodes:
        nc = NodeClaim()
        nc.metadata.name = f"claim-{sn.name()}"
        nc.metadata.labels = dict(sn.node.metadata.labels)
        nc.status.provider_id = sn.provider_id()
        nc.status.capacity = dict(sn.node.status.capacity)
        nc.status.allocatable = dict(sn.node.status.allocatable)
        out += [nc, sn.node]
    out += list(bound)
    for d in daemons:
        ds = DaemonSet(pod_template_spec=copy.deepcopy(d.spec))
        ds.metadata.name, ds.metadata.namespace = d.name, d.namespace
        out.append(ds)
    return out + list(pools) + list(pods)


class Stack:
    """The port's provisioning stack over one in-memory store on a fixed
    clock: a ``KubeClient``, ``Informers`` feeding a ``Cluster``, a
    ``Recorder``, ``Metrics`` and a ``Provisioner`` on the batched path
    (``use_tpu_solver``) on ``device``. ``objects`` go into the store
    after the informers start, as a live cluster's watches deliver them."""

    def __init__(self, device: str, provider, objects):
        from karpenter_core_tpu_torch.events import Recorder
        from karpenter_core_tpu_torch.kube.client import KubeClient
        from karpenter_core_tpu_torch.metrics import Metrics
        from karpenter_core_tpu_torch.provisioning import Provisioner
        from karpenter_core_tpu_torch.state.cluster import Cluster
        from karpenter_core_tpu_torch.state.informers import Informers

        clock = lambda: STORE_CLOCK  # noqa: E731
        self.kube = KubeClient(clock=clock)
        self.cluster = Cluster(self.kube, provider, clock=clock)
        self.informers = Informers(self.kube, self.cluster)
        self.informers.start()
        for obj in objects:
            self.kube.create(obj)
        self.recorder = Recorder(self.kube, clock=clock, capacity=1 << 20)
        self.metrics = Metrics()
        self.provisioner = Provisioner(
            self.kube, provider, self.cluster, recorder=self.recorder, use_tpu_solver=True,
            metrics=self.metrics, device=device,
        )
        if not self.cluster.synced():
            fail("the cluster state is not synced with its store")

    def stop(self) -> None:
        self.informers.stop()

    def reset_claims(self) -> None:
        """Delete the claims a reconcile created, its events and its
        metric samples, so the next reconcile meets a synced cluster, a
        fresh event stream and fresh counters."""
        from karpenter_core_tpu_torch.metrics import Metrics

        for nc in self.kube.list("NodeClaim"):
            if not nc.status.provider_id:
                self.kube.delete(nc)
        self.recorder.reset()
        self.metrics = self.provisioner.metrics = Metrics()
        if self.provisioner._tpu_solver is not None:
            self.provisioner._tpu_solver[1].metrics = self.metrics
        if not self.cluster.synced():
            fail("the cluster is not synced after its new claims were deleted")


class kept_solves:
    """Every ``TorchScheduler.solve`` inside the block, kept as (pods,
    result)."""

    def __enter__(self):
        from karpenter_core_tpu_torch.solver.solver import TorchScheduler

        self.cls, self.real, self.solves = TorchScheduler, TorchScheduler.solve, []
        real, solves = self.real, self.solves

        def solve(solver, pods, *args, **kw):
            res = real(solver, pods, *args, **kw)
            solves.append((list(pods), res))
            return res

        TorchScheduler.solve = solve
        return self

    def __exit__(self, *exc):
        self.cls.solve = self.real


def all_kernels() -> dict:
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    return {"compat_allowed": ck.COMPAT_ALLOWED, **pack_kernels()}


def claim_content(stack) -> list:
    """The claims a reconcile created as a content multiset: labels,
    annotations, requirements, requests, owner references, and the pods
    their Nominated events name."""
    claims = {nc.name: nc for nc in stack.kube.list("NodeClaim") if not nc.status.provider_id}
    nominated = {name: [] for name in claims}
    for e in stack.recorder.find("Nominated"):
        target = e.message.rsplit(": ", 1)[-1]
        if target in nominated:
            nominated[target].append(e.involved_object.name)
    return sorted(
        (
            sorted(nc.metadata.labels.items()), sorted(nc.metadata.annotations.items()),
            sorted((r.key, r.operator, tuple(sorted(r.values))) for r in nc.spec.requirements),
            sorted(nc.spec.resources.requests.items()),
            [(o.kind, o.name) for o in nc.metadata.owner_references],
            sorted(nominated[nc.name]),
        )
        for nc in claims.values()
    )


def trace_split(tr) -> dict:
    """The root lane's provisioner-level spans of the reconcile's
    buffered trace, ms; fails unless it holds ``provisioner.reconcile``
    → ``snapshot_nodes``, ``pending_pods``, ``solve``,
    ``create_node_claims``."""
    if tr is None or tr.name != "provisioner.reconcile" or not tr.contains_solve:
        fail(f"the reconcile left no solve trace in the ring (last: {tr and tr.name})")
    out = {}
    for s in tr.spans:
        if s.tid == tr.root_tid and s.depth <= 1:
            out[s.name] = out.get(s.name, 0.0) + s.dur_ns / 1e6
    for name in ("provisioner.reconcile", "snapshot_nodes", "pending_pods", "solve", "create_node_claims"):
        if name not in out:
            fail(f"the reconcile's trace has no {name} span ({sorted(out)})")
    return {f"{k}_ms": v for k, v in out.items()}


def reconcile_once(stack, what: str) -> dict:
    """One ``reconcile`` with every kernel's launch counter set to 0 just
    before and read just after → its wall ms, the created names, the one
    batched solve it ran (pods, result), the solver's timings, the
    trace's span split and the launches."""
    from karpenter_core_tpu_torch.tracing import tracer

    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    with kept_solves() as kept:
        t0 = time.perf_counter()
        names, reason = stack.provisioner.reconcile()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = {name: k.launches for name, k in kernels.items()}
    if reason is not None or not names:
        fail(f"{what}: the reconcile created {len(names)} claims, reason {reason!r}")
    if len(kept.solves) != 1:
        fail(f"{what}: the reconcile ran {len(kept.solves)} batched solves, not one")
    pods, res = kept.solves[0]
    return {
        "wall_ms": wall_ms, "names": names, "pods": pods, "res": res,
        "timings": dict(stack.provisioner._tpu_solver[1].last_timings),
        "trace": trace_split(tracer.RING.last()), "launches": launches,
    }


def check_reconcile(stack, run, what: str) -> dict:
    """Fail unless one claim stands in the store per new plan, pinned to
    the plan's pool, type, zone and capacity type, and one per greedy
    claim; every placed pod has exactly one Nominated event, naming its
    claim or its existing node; every existing node that took pods is
    nominated in the cluster; no claim was made for an existing
    placement; and ``nodeclaims_created`` counts the claims per pool."""
    from karpenter_core_tpu_torch.apis import labels as wk

    res, pods = run["res"], run["pods"]
    claims = {nc.name: nc for nc in stack.kube.list("NodeClaim") if not nc.status.provider_id}
    greedy = res.oracle_results.new_node_claims if res.oracle_results is not None else []
    if len(claims) != len(res.node_plans) + len(greedy) or sorted(run["names"]) != sorted(claims):
        fail(f"{what}: {len(claims)} claims for {len(res.node_plans)} plans and {len(greedy)} greedy claims")
    nominated = {}
    for e in stack.recorder.find("Nominated"):
        nominated.setdefault(e.involved_object.name, []).append(e.message.rsplit(": ", 1)[-1])
    for plan in res.node_plans:
        nc = claims.get(getattr(plan, "created_claim_name", None))
        if nc is None:
            fail(f"{what}: a plan on {plan.instance_type.name} has no claim")
        req = {r.key: list(r.values) for r in nc.spec.requirements}
        got = (nc.metadata.labels[wk.NODEPOOL_LABEL_KEY], req[wk.LABEL_INSTANCE_TYPE],
               req[wk.LABEL_TOPOLOGY_ZONE], req[wk.CAPACITY_TYPE_LABEL_KEY])
        if got != (plan.nodepool_name, [plan.instance_type.name], [plan.zone], [plan.capacity_type]):
            fail(f"{what}: claim {nc.name} is {got}, its plan another")
        for i in plan.pod_indices:
            if nominated.get(pods[i].name) != [nc.name]:
                fail(f"{what}: pod {pods[i].name} is not nominated to its claim alone")
    for c in greedy:
        for p in c.pods:
            if nominated.get(p.name) != [c.created_claim_name]:
                fail(f"{what}: greedy pod {p.name} is not nominated to its claim alone")
    existing = list(res.existing_plans)
    if res.oracle_results is not None:
        existing += [e for e in res.oracle_results.existing_nodes if e.pods]
    on_existing = 0
    for e in existing:
        tensor = hasattr(e, "pod_indices")  # else a greedy ExistingNode
        name, pid = (e.state_node.name(), e.state_node.provider_id()) if tensor else (e.name(), e.provider_id())
        if not stack.cluster.is_node_nominated(pid):
            fail(f"{what}: existing node {name} took pods and is not nominated")
        members = [pods[i] for i in e.pod_indices] if tensor else list(e.pods)
        for p in members:
            if nominated.get(p.name) != [name]:
                fail(f"{what}: pod {p.name} on {name} has no Nominated event for it alone")
        on_existing += len(members)
    placed = res.pods_scheduled
    if len(nominated) != placed:
        fail(f"{what}: {len(nominated)} pods have Nominated events, {placed} were placed")
    per_pool = {}
    for nc in claims.values():
        pool = nc.metadata.labels[wk.NODEPOOL_LABEL_KEY]
        per_pool[pool] = per_pool.get(pool, 0) + 1
    for pool, n in per_pool.items():
        if stack.metrics.nodeclaims_created.get(reason="provisioning", nodepool=pool) != n:
            fail(f"{what}: nodeclaims_created{{nodepool={pool}}} is not its {n} claims")
    route = stack.metrics.solver_route_pods
    return {
        "claims": len(claims), "claims_by_pool": dict(sorted(per_pool.items())),
        "nominated_pods": len(nominated), "pods_on_existing": on_existing,
        "nominated_nodes": sum(1 for pid in stack.cluster.nodes if stack.cluster.is_node_nominated(pid)),
        "pod_errors": len(res.pod_errors),
        "route_pods": {k[0][1]: v for k, v in sorted(route.values.items())},
    }


def same_plans(run, direct, direct_pods, what: str) -> None:
    """Fail unless the reconcile's batched solve has the direct solve's
    plans, existing plans and errors (by pod index: the two batches hold
    the same pods in the same order, as distinct objects)."""
    def errors(res, pods):
        return {i: res.pod_errors[p.uid] for i, p in enumerate(pods) if p.uid in res.pod_errors}

    res = run["res"]
    if [p.name for p in run["pods"]] != [p.name for p in direct_pods]:
        fail(f"{what}: the reconcile's batch is not the direct solve's pods in order")
    if (plan_stream(res), existing_stream(res), errors(res, run["pods"])) != (
        plan_stream(direct), existing_stream(direct), errors(direct, direct_pods)
    ):
        fail(f"{what}: the reconcile's plans differ from the direct solve's")


def reconcile_row(run, check: dict) -> dict:
    t = run["timings"]
    return {
        "reconcile_ms": run["wall_ms"], "solve_ms": t["total_ms"], "solve_device_ms": t["device_ms"],
        **{f"span_{k}": v for k, v in run["trace"].items()},
        "solve_phases_ms": {k: v for k, v in t.items() if k.endswith("_ms") and k not in ("total_ms", "device_ms", "host_ms")},
        "nodes": run["res"].node_count, "pods_scheduled": run["res"].pods_scheduled,
        **check, "kernel_launches": run["launches"],
    }


def run_provisioner_config2(device: str = "cuda", n_pods: int = N_CONFIG2) -> dict:
    """Phase 13a, config2-provisioner: bench config 2 as pending pods in
    a store, one reconcile on ``device``, three more ``schedule()``
    calls, the claims against a direct solve and a CPU reconcile in a
    fresh store, the metrics and the trace; then one parity shadow."""
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods = config2_world(n_pods)
    stack = Stack(device, provider, store_objects(pools, pods))
    world_s = time.perf_counter() - t0
    stack.provisioner.PARITY_SAMPLE_EVERY = 0  # the shadow runs below, after the counts
    run = reconcile_once(stack, "config2-provisioner")
    if device == "cuda" and run["launches"]["compat_allowed"] == 0:
        fail("config2-provisioner: the reconcile never launched the compat kernel")
    check = check_reconcile(stack, run, "config2-provisioner")
    warm = []
    for _ in range(3):
        t1 = time.perf_counter()
        stack.provisioner.schedule()
        warm.append((time.perf_counter() - t1) * 1000.0)
    solves = sum(stack.metrics.solver_duration.totals.values())
    if solves != 4 or sum(stack.metrics.solver_device_duration.totals.values()) != 4:
        fail(f"config2-provisioner: solver_duration observed {solves} solves, not 4")
    direct_pods = config2_world(n_pods)[2]
    direct = TorchScheduler(pools, provider, device=device).solve(direct_pods)
    same_plans(run, direct, direct_pods, "config2-provisioner")
    cpu_pools, _, cpu_pods = config2_world(n_pods)
    cpu = Stack("cpu", provider, store_objects(cpu_pools, cpu_pods))
    cpu_run = reconcile_once(cpu, "config2-provisioner on the cpu")
    if claim_content(cpu) != claim_content(stack):
        fail("config2-provisioner: the claims differ between cuda and cpu")
    cpu.stop()
    # the parity shadow: the greedy scheduler and a batched solve on a
    # 500-pod subsample, on a daemon thread; it swallows its errors, so
    # its gauge is read explicitly
    stack.provisioner.PARITY_SAMPLE_EVERY = 1
    stack.provisioner.schedule()
    deadline = time.monotonic() + 120
    while stack.provisioner._parity_inflight and time.monotonic() < deadline:
        time.sleep(0.05)
    parity = stack.metrics.solver_parity.get()
    if parity is None:
        fail("config2-provisioner: the parity shadow set no solver_parity")
    stack.stop()
    row = {
        "provisioner": "config2",
        "world": f"{n_pods} pods (bench config 2, 10 % asking a GPU) x {len(provider.instance_types)} types, no existing nodes",
        "world_and_store_s": world_s,
        **reconcile_row(run, check),
        "schedule_warm_ms": statistics.median(warm), "schedule_warm_runs_ms": warm,
        "cpu_reconcile_ms": cpu_run["wall_ms"], "solver_parity": parity,
        "solver_duration_count": solves,
    }
    emit(row)
    return row


def run_provisioner_cluster(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES,
                            n_nodes: int = N_NODES) -> dict:
    """Phase 13b, cluster-provisioner: phase 5's world as objects in a
    store (1,000 initialized nodes with their NodeClaims, the bound pods,
    three DaemonSets, pools ``reserved`` and ``default``) fed through the
    informers, then the 50,000 pending pods: a reconcile with the C++
    packer and three ``schedule()`` calls, then a reconcile with
    ``KARPENTER_TORCH_NATIVE=0`` (the device scans), each against a
    direct solve of phase 5's inputs under the same packer
    (``solve(pods, state_nodes, daemonset_pods)``), and a CPU reconcile
    with the C++ packer. The device run's CPU counterpart is phase 12's:
    its cluster-device path holds the direct device-engine solve of the
    same inputs to the plain scans on the CPU. One captured compat call,
    and one existing-node first-fit call of the device run, held against
    their plain versions."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver import solver as solver_mod
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, missing, kube = _cluster_world(n_pods, n_types, n_nodes, store=True)
    stack = Stack(device, provider, store_objects(pools, pods, nodes, kube.list("Pod"), daemons))
    world_s = time.perf_counter() - t0
    stack.provisioner.PARITY_SAMPLE_EVERY = 0  # no shadow solve among the counted ones
    if len(stack.cluster.nodes) != n_nodes or len(stack.cluster.bindings) != sum(len(sn.pod_requests) for sn in nodes):
        fail("cluster-provisioner: the cluster state does not hold the store's nodes and bound pods")
    rows = {}
    with capture(solver_mod, "allowed_via_kernel", 1) as compat_call:
        run = reconcile_once(stack, "cluster-provisioner")
    # the direct solves come after the first reconcile, which so meets
    # the pods unmemoized
    direct = TorchScheduler(pools, provider, device=device).solve(pods, state_nodes=nodes, daemonset_pods=daemons)
    with knobs(KARPENTER_TORCH_NATIVE=0):
        direct_dev = TorchScheduler(pools, provider, device=device).solve(
            pods, state_nodes=nodes, daemonset_pods=daemons
        )
    same_plans(run, direct, pods, "cluster-provisioner")
    if device == "cuda" and run["launches"]["compat_allowed"] == 0:
        fail("cluster-provisioner: the reconcile never launched the compat kernel")
    check = check_reconcile(stack, run, "cluster-provisioner")
    summary = check_cluster(run["res"], run["pods"], nodes, daemons, missing)
    content = claim_content(stack)
    warm = []
    for _ in range(3):
        t1 = time.perf_counter()
        stack.provisioner.schedule()
        warm.append((time.perf_counter() - t1) * 1000.0)
    rows["cluster"] = {
        "provisioner": "cluster", "world_and_store_s": world_s,
        "store_objects": len(stack.kube.list("Node")) + len(stack.kube.list("Pod")) + len(stack.kube.list("NodeClaim")),
        **reconcile_row(run, check), **summary,
        "schedule_warm_ms": statistics.median(warm), "schedule_warm_runs_ms": warm,
    }
    # the captured compat call against its plain version, bit for bit
    rows["cluster"]["captured_compat"] = compat_call_case(compat_call.calls[0])
    compat_err = rows["cluster"]["captured_compat"]["max_abs_err"]

    stack.reset_claims()
    with knobs(KARPENTER_TORCH_NATIVE=0), capture(pack, "pack_existing", 1) as ex_call:
        dev_run = reconcile_once(stack, "cluster-provisioner device engine")
    same_plans(dev_run, direct_dev, pods, "cluster-provisioner device engine")
    if device == "cuda" and (dev_run["launches"]["ffd_pack"] == 0 or dev_run["launches"]["pack_existing"] == 0
                             or dev_run["launches"]["compat_allowed"] == 0):
        fail(f"cluster-provisioner device engine: the reconcile launched {dev_run['launches']}")
    dev_check = check_reconcile(stack, dev_run, "cluster-provisioner device engine")
    check_cluster(dev_run["res"], dev_run["pods"], nodes, daemons, missing)
    rows["cluster-device"] = {"provisioner": "cluster-device", **reconcile_row(dev_run, dev_check)}
    existing_case = existing_kernel_case(ex_call.calls[0]) if device == "cuda" else None

    # the same store on the CPU with the C++ packer: a fresh solver
    stack.reset_claims()
    stack.provisioner.device = "cpu"
    stack.provisioner._tpu_solver = None
    cpu_run = reconcile_once(stack, "cluster-provisioner on the cpu")
    if claim_content(stack) != content:
        fail("cluster-provisioner: the claims differ between cuda and cpu")
    same_plans(cpu_run, direct, pods, "cluster-provisioner on the cpu")
    rows["cluster"]["cpu_reconcile_ms"] = cpu_run["wall_ms"]
    stack.stop()
    for r in rows.values():
        emit(r)
    return {"rows": rows, "existing_case": existing_case, "compat_err": compat_err}


def guard_pods(nodes) -> list:
    """Bound pods with required anti-affinity on existing nodes, each in
    the store: ``guard-redis`` on ``node-0002`` (test-zone-3) refuses the
    redis release's pods on its node; ``guard-pg`` on ``node-0001``
    (test-zone-2) refuses the ``pg-0`` release in its zone; ``guard-team``
    on ``node-0004`` refuses ``team=t-0`` pods (tensor-routed) on its
    node."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.kube.objects import Affinity, LabelSelector, PodAffinityTerm, PodAntiAffinity

    by_name = {sn.name(): sn for sn in nodes}
    out = []
    for name, node, key, selector in (
        ("guard-redis", "node-0002", wk.LABEL_HOSTNAME, {"app.kubernetes.io/name": "redis"}),
        ("guard-pg", "node-0001", wk.LABEL_TOPOLOGY_ZONE, {"app.kubernetes.io/instance": "pg-0"}),
        ("guard-team", "node-0004", wk.LABEL_HOSTNAME, {"team": "t-0"}),
    ):
        p = bound_anchor(name, {"role": "guard"}, node)
        p.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(required=[
            PodAffinityTerm(topology_key=key, label_selector=LabelSelector(match_labels=selector)),
        ]))
        by_name[node].update_for_pod(p)
        out.append(p)
    return out


def guard_world(n_anti: int = N_GUARD_ANTI, n_types: int = N_TYPES, n_nodes: int = N_GUARD_NODES,
                n_releases: int = N_RELEASES):
    """Phase 9's ``anti_cluster_world`` (its eight ``ext-*`` anchors on
    existing nodes) cut to ``n_nodes`` nodes and ``n_anti`` anti pods,
    the ``guard_pods``, and phase 11's Helm release pods → (pools,
    provider, pods, nodes, daemons, missing, bound pods: the workers,
    daemons, anchors and guards)."""
    pools, provider, pods, nodes, daemons, missing, kube = anti_cluster_world(n_anti, n_types, n_nodes)
    bound = kube.list("Pod") + guard_pods(nodes)
    return pools, provider, pods + release_pods(n_releases), nodes, daemons, missing, bound


def check_inverse(res, pods, kube, zones) -> dict:
    """Every bound pod of ``kube`` with required anti-affinity against
    every placement of the solve its selector matches: a hostname term
    excludes its node, a zone term its node's zone (a greedy claim may
    launch in any zone its requirements leave). Fails on a greedy
    placement in an excluded domain; counts the tensor path's (the JAX
    package's tensor path does not read the inverse anti-affinity of
    bound pods either; ROADMAP C8)."""
    from karpenter_core_tpu_torch.apis import labels as wk

    node_zone = {n.name: n.metadata.labels.get(wk.LABEL_TOPOLOGY_ZONE) for n in kube.list("Node")}
    tensor = {i: (z, node) for i, (z, node) in placements(res).items()}
    greedy = {}
    if res.oracle_results is not None:
        index = {p.uid: i for i, p in enumerate(pods)}
        for c in res.oracle_results.new_node_claims:
            allowed = set(zones)
            if c.requirements.has(wk.LABEL_TOPOLOGY_ZONE):
                req = c.requirements.get_req(wk.LABEL_TOPOLOGY_ZONE)
                allowed = allowed - req.values if req.complement else set(req.values)
            for p in c.pods:
                greedy[index[p.uid]] = (allowed, ("claim", id(c)))
        for e in res.oracle_results.existing_nodes:
            for p in e.pods:
                greedy[index[p.uid]] = ({node_zone[e.name()]}, ("existing", e.name()))
    out = {"guards": 0, "greedy_checked": 0, "tensor_violations": []}
    for g in kube.list("Pod"):
        a = g.spec.affinity
        if not g.spec.node_name or a is None or a.pod_anti_affinity is None or not a.pod_anti_affinity.required:
            continue
        out["guards"] += 1
        for t in a.pod_anti_affinity.required:
            hostname = t.topology_key == wk.LABEL_HOSTNAME
            for i, p in enumerate(pods):
                if p.namespace != g.namespace or not t.label_selector.matches(p.metadata.labels):
                    continue
                if i in greedy:
                    out["greedy_checked"] += 1
                    allowed, node = greedy[i]
                    bad = node == ("existing", g.spec.node_name) if hostname else node_zone[g.spec.node_name] in allowed
                    if bad:
                        fail(f"greedy placement of {p.name} on {node} is in a domain {g.name} excludes")
                elif i in tensor:
                    z, node = tensor[i]
                    bad = node == ("existing", g.spec.node_name) if hostname else z == node_zone[g.spec.node_name]
                    if bad:
                        out["tensor_violations"].append((p.name, g.name))
    out["tensor_violations"] = sorted(out["tensor_violations"])
    return out


def run_provisioner_guard(device: str = "cuda", n_anti: int = N_GUARD_ANTI, n_types: int = N_TYPES,
                          n_nodes: int = N_GUARD_NODES, n_releases: int = N_RELEASES) -> dict:
    """Phase 13c, anti-cluster-oracle: ``guard_world`` in a store, one
    reconcile on ``device`` and one on the CPU in a fresh store: the
    claims, the greedy fallback's claims and the inverse-anti-affinity
    check equal, ``check_anti`` and ``check_oracle`` on the card's
    solve."""
    def build(dev):
        pools, provider, pods, nodes, daemons, missing, bound = guard_world(n_anti, n_types, n_nodes, n_releases)
        stack = Stack(dev, provider, store_objects(pools, pods, nodes, bound, daemons))
        return stack, (pools, provider, pods, nodes, daemons, missing)

    t0 = time.perf_counter()
    stack, (pools, provider, pods, nodes, daemons, missing) = build(device)
    world_s = time.perf_counter() - t0
    stack.provisioner.PARITY_SAMPLE_EVERY = 0
    run = reconcile_once(stack, "anti-cluster-oracle")
    if device == "cuda" and run["launches"]["compat_allowed"] == 0:
        fail("anti-cluster-oracle: the reconcile never launched the compat kernel")
    res, batch = run["res"], run["pods"]
    check = check_reconcile(stack, run, "anti-cluster-oracle")
    route = dict(stack.provisioner._tpu_solver[1].last_route_stats)
    zones = sorted({sn.labels().get("topology.kubernetes.io/zone") for sn in nodes})
    inverse = check_inverse(res, batch, stack.kube, zones)
    if inverse["guards"] != 3 or inverse["greedy_checked"] == 0:
        fail(f"anti-cluster-oracle: the inverse check saw {inverse['guards']} guards, "
             f"{inverse['greedy_checked']} greedy placements they select")
    cpu, _ = build("cpu")
    cpu.provisioner.PARITY_SAMPLE_EVERY = 0
    cpu_run = reconcile_once(cpu, "anti-cluster-oracle on the cpu")
    if claim_content(cpu) != claim_content(stack):
        fail("anti-cluster-oracle: the claims differ between cuda and cpu")
    same_plans(cpu_run, res, batch, "anti-cluster-oracle on the cpu")
    same_oracle_as_cpu(res, batch, cpu_run["res"], cpu_run["pods"], "anti-cluster-oracle")
    if check_inverse(cpu_run["res"], cpu_run["pods"], cpu.kube, zones) != inverse:
        fail("anti-cluster-oracle: the inverse check differs between cuda and cpu")
    cpu.stop()
    row = {
        "provisioner": "anti-cluster-oracle",
        "world": (f"{len(pods)} pods ({n_anti} config 13 anti_dense + 6 quorum + {len(pods) - n_anti - N_QUORUM} "
                  f"Helm release pods) x {len(provider.instance_types)} types x {len(nodes)} existing nodes "
                  f"(phase 9's cluster cut from {N_NODES}), 8 anchors, 3 guards"),
        "world_and_store_s": world_s,
        **reconcile_row(run, check),
        "oracle": check_oracle(res, batch, len(pods) - n_anti - N_QUORUM, route),
        "anti": check_anti(res, batch, stack.kube),
        "inverse_anti": inverse,
        **check_cluster(res, batch, nodes, daemons, missing, spill=False),
        "cpu_reconcile_ms": cpu_run["wall_ms"],
    }
    stack.stop()
    emit(row)
    return row


def run_provisioner_phase(device: str = "cuda", sizes: Optional[dict] = None) -> dict:
    """Phase 13 → its three parts' rows; ``sizes`` cuts them for a
    rehearsal on the CPU (``config2``, ``cluster`` (pods, types, nodes),
    ``guard`` (anti pods, types, nodes, releases))."""
    sizes = sizes or {}
    out = {"config2": run_provisioner_config2(device, *sizes.get("config2", ()))}
    out.update(run_provisioner_cluster(device, *sizes.get("cluster", ())))
    out["guard"] = run_provisioner_guard(device, *sizes.get("guard", ()))
    return out


# -- phase 14: cross-tick warm state (bench config 7) ------------------------------

N_CONFIG7 = 10_000  # bench.py config 7 (bench.py:763-960): pods, RandomState(23)
CONFIG7_SEED = 23
CONFIG7_TEAMS = 40
CONFIG7_TYPES = 480  # plus 20 GPU types
CONFIG7_TICKS = 20  # bench config 7 runs 30: cut for the script's time
CONFIG7_CHURN = 0.05
CONFIG7_MUTATE_EVERY = 10
CONFIG7_NATIVE_OFF_TICKS = 10  # the second warm pass, on the FFD scan kernel


def compat_call_case(call, reps: int = 20) -> dict:
    """One captured ``allowed_via_kernel`` call (signature planes, device
    catalog) against its plain version on the catalog's device, bit for
    bit, and the kernel's time on the card."""
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    sig, catalog = call[:2]
    # the capture's copy is compact: lay it out in the kernel's padded storage again
    sig = ck.to_planes(sig.T.contiguous().numpy(), catalog.device)
    got = ck.allowed_via_kernel(sig, catalog)
    plain = ck.allowed_packed_reference(sig, catalog.planes, catalog.layout)
    err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max().item()) if got.numel() else 0
    row = {"S": int(sig.shape[1]), "T": catalog.n_types, "W": int(sig.shape[0]), "max_abs_err": err}
    if err:
        fail(f"a captured compat call differs from its plain version: {row}")
    if catalog.device.type == "cuda":
        row["kernel_ms"] = events_ms(lambda: ck.allowed_via_kernel(sig, catalog), reps)
    return row


def distinct_compat_calls(calls) -> list:
    """The first captured compat call of each (signature planes shape,
    types) pair, in capture order."""
    seen, out = set(), []
    for call in calls:
        key = (tuple(call[0].shape), call[1].n_types)
        if key not in seen:
            seen.add(key)
            out.append(call)
    return out


class Config7:
    """bench config 7's churning world on the port: ``n_pods`` pods of
    the config-2 size mix (one in ten asks one GPU) over ``teams`` team
    deployments (``bench-team`` selector and label), ``cap-{i}`` types
    ((i % 64) + 1 CPU, twice that in Gi) and 20 GPU types, one pool
    ``bench-team In t0..t{teams-1}``. ``churn_tick`` swaps about
    ``churn`` of the pods on a tenth of the teams; ``mutate`` raises the
    price of every 16th type 1 % in place, bumps the catalog generation
    and the pool's weight; ``clones`` build the restart-shaped copies of
    the current tick (fresh pods, catalog and pool objects)."""

    def __init__(self, n_pods: int = N_CONFIG7, n_types: int = CONFIG7_TYPES, teams: int = CONFIG7_TEAMS,
                 churn: float = CONFIG7_CHURN):
        from karpenter_core_tpu_torch.apis.nodepool import NodePool
        from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, new_instance_type
        from karpenter_core_tpu_torch.kube.objects import NodeSelectorRequirement

        self.new_instance_type = new_instance_type
        self.rng = np.random.RandomState(CONFIG7_SEED)
        self.teams, self.churn = teams, churn
        self.cat_specs = [
            (f"cap-{i}", {"cpu": str((i % 64) + 1), "memory": f"{2 * ((i % 64) + 1)}Gi", "pods": "110"})
            for i in range(n_types)
        ] + [
            (f"cap-gpu-{g}", {"cpu": str(8 * (g + 1)), "memory": f"{16 * (g + 1)}Gi", "pods": "110",
                              "nvidia.com/gpu": str(min(8, g + 1))})
            for g in range(20)
        ]
        self.provider = FakeCloudProvider()
        self.provider.instance_types = [new_instance_type(n, r) for n, r in self.cat_specs]
        self.provider.bump_catalog_generation()  # the caller owns catalog invalidation
        self.pool = NodePool()
        self.pool.metadata.name = "default"
        self.pool.spec.template.requirements = [
            NodeSelectorRequirement("bench-team", "In", [f"t{t}" for t in range(teams)])
        ]
        self.counter = 0
        self.pods = [self.mk(t % teams) for t in range(n_pods)]

    def _pod(self, i: int, spec: tuple):
        from karpenter_core_tpu_torch.kube.quantity import parse_quantity

        cpu, mem, gpu, team = spec
        pod = pending_pod(f"bench-{i}", cpu, mem, labels={"bench-team": f"t{team}"})
        pod.spec.node_selector = {"bench-team": f"t{team}"}
        if gpu:
            pod.spec.containers[0].resources.requests["nvidia.com/gpu"] = parse_quantity(gpu)
        pod.__dict__["_config7_spec"] = spec
        return pod

    def mk(self, team: int):
        rng = self.rng
        cpu = ["100m", "250m", "500m", "1", "2", "4"][rng.randint(6)]
        mem = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi"][rng.randint(5)]
        gpu = "1" if rng.rand() < 0.1 else None
        self.counter += 1
        return self._pod(self.counter - 1, (cpu, mem, gpu, team))

    def churn_tick(self) -> None:
        rng = self.rng
        hit = rng.choice(self.teams, max(1, self.teams // 10), replace=False)
        target = int(len(self.pods) * self.churn)
        removed, keep = 0, []
        for p in self.pods:
            t = int(p.metadata.labels["bench-team"][1:])
            if t in hit and removed < target and rng.rand() < 0.5:
                removed += 1
                continue
            keep.append(p)
        self.pods = keep + [self.mk(int(hit[k % len(hit)])) for k in range(removed)]

    def mutate(self) -> None:
        types = self.provider.instance_types
        for it in types[:: max(1, len(types) // 16)]:
            for o in it.offerings:
                o.price *= 1.01
        self.provider.bump_catalog_generation()
        self.pool.spec.weight = (self.pool.spec.weight or 0) + 1

    def clones(self) -> tuple:
        """(pods, provider, pool): fresh objects of the current tick."""
        from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
        from karpenter_core_tpu_torch.cloudprovider.types import Offering

        provider = FakeCloudProvider()
        provider.instance_types = [
            self.new_instance_type(name, res, offerings=[
                Offering(o.capacity_type, o.zone, o.price, o.available) for o in live.offerings
            ])
            for (name, res), live in zip(self.cat_specs, self.provider.instance_types)
        ]
        pods = [self._pod(i, p.__dict__["_config7_spec"]) for i, p in enumerate(self.pods)]
        return pods, provider, copy.deepcopy(self.pool)


class nogc:
    """A collector-free timed region, as bench.py's ``nogc``: at this
    scale the collector owns millions of objects, and a full collection
    inside a timed solve would be measured as the solve."""

    def __enter__(self):
        gc.collect()
        self.was_enabled = gc.isenabled()
        gc.disable()
        return self

    def __exit__(self, *exc):
        if self.was_enabled:
            gc.enable()


class frozen_heap:
    """The heap's survivors frozen out of every collection for the block,
    as phase 14 does: each ``nogc`` collection inside it then walks only
    what the block made, not the earlier phases' worlds."""

    def __enter__(self):
        gc.collect()
        gc.freeze()
        return self

    def __exit__(self, *exc):
        gc.unfreeze()


def config7_canon(res, pods) -> tuple:
    """A tick's plans by pod position (the cold leg solves clones, so
    uids differ; the batch order is shared)."""
    index = {p.uid: i for i, p in enumerate(pods)}
    return plan_stream(res), sorted((index[uid], e) for uid, e in res.pod_errors.items())


def _pctl(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_config7_phase(device: str = "cuda", n_pods: int = N_CONFIG7, n_types: int = CONFIG7_TYPES,
                      ticks: int = CONFIG7_TICKS, native_off_ticks: int = CONFIG7_NATIVE_OFF_TICKS) -> dict:
    """Phase 14: bench config 7's ticks on ``device``. Every tick solves
    twice: the cold leg restart-shaped (fresh pods, catalog and pool, a
    fresh TorchScheduler, KARPENTER_TORCH_INCREMENTAL=0), the warm leg on
    one long-lived TorchScheduler; the plans must be identical and the
    warm leg's compat launches at most the cold leg's. Then a no-op tick
    (a replay: no compat, no FFD launch); a second warm pass with
    KARPENTER_TORCH_NATIVE=0, whose FFD scan launches are exactly one per
    (size class, width) class of the jobs the job memo missed, none on a
    tick whose jobs all hit, its plans equal to a cold solve of the tick's
    pods on the same engine; a restart: snapshot, simulated process death,
    restore into a fresh scheduler whose first solve of the last tick's
    pods is plan-identical and launches no compat kernel; and the last
    tick's plan against a cold CPU solve (the device-engine pass's last
    tick's too, through the plain scans). On the card every compat and FFD
    call the phase's solves make is captured, and each distinct shape is
    held against its plain version bit for bit. → the phase's row."""
    import tempfile

    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import pack, warmstore
    from karpenter_core_tpu_torch.solver import solver as solver_mod
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    compat, ffd = ck.COMPAT_ALLOWED, pack.FFD_PACK
    sections: dict = {}
    t_section = time.perf_counter()

    def section(name):
        nonlocal t_section
        now = time.perf_counter()
        sections[name] = now - t_section
        t_section = now

    world = Config7(n_pods, n_types)
    legs = {leg: {"compat": [], "ffd": [], "host_ms": [], "total_ms": [], "timings": []} for leg in ("cold", "warm")}
    identical, hit_rates = 0, []
    hits: dict = {}
    misses: dict = {}

    def solve(solver, pods, leg):
        compat.launches = ffd.launches = 0
        with nogc():
            res = solver.solve(pods)
        row = legs[leg]
        row["compat"].append(compat.launches)
        row["ffd"].append(ffd.launches)
        row["host_ms"].append(solver.last_timings["host_ms"])
        row["total_ms"].append(solver.last_timings["total_ms"])
        row["timings"].append(dict(solver.last_timings))
        return res

    def cold_leg(leg="cold"):
        pods, provider, pool = world.clones()
        with knobs(KARPENTER_TORCH_INCREMENTAL=0):
            return solve(TorchScheduler([pool], provider, device=device), pods, leg), pods

    def check_tick(tick, res, ref, ref_pods):
        nonlocal identical
        if config7_canon(res, world.pods) == config7_canon(ref, ref_pods):
            identical += 1
        else:
            fail(f"config7 tick {tick}: the warm plans differ from the cold plans")
        if legs["warm"]["compat"][-1] > legs["cold"]["compat"][-1]:
            fail(f"config7 tick {tick}: the warm leg launched more compat kernels than the cold leg")
        cs = warm.last_cache_stats or {}
        if "hit_rate" in cs:
            hit_rates.append(cs["hit_rate"])
        for name, n in cs.get("hits", {}).items():
            hits[name] = hits.get(name, 0) + n
        for name, n in cs.get("misses", {}).items():
            misses[name] = misses.get(name, 0) + n

    # as bench.py's config 7: the earlier phases' survivors frozen out of
    # every collection, each timed solve collector-free
    gc.collect()
    gc.freeze()
    section("world_s")
    warm = TorchScheduler([world.pool], world.provider, device=device)
    with capture(solver_mod, "allowed_via_kernel", 64) as compat_cap:
        for tick in range(ticks):
            if tick:
                world.churn_tick()
                if tick % CONFIG7_MUTATE_EVERY == 0:
                    world.mutate()
            ref, ref_pods = cold_leg()
            res = solve(warm, world.pods, "warm")
            check_tick(tick, res, ref, ref_pods)
    last_plan, last_pods = res, list(world.pods)
    section("main_pass_s")

    # the no-op tick: unchanged inputs replay whole
    compat.launches = ffd.launches = 0
    with nogc():
        t0 = time.perf_counter()
        noop = warm.solve(world.pods)
        noop_wall_ms = (time.perf_counter() - t0) * 1000.0
    noop_row = {
        "host_ms": warm.last_timings["host_ms"], "wall_ms": noop_wall_ms,
        "compat_launches": compat.launches, "ffd_launches": ffd.launches,
        "cache": warm.last_cache_stats,
    }
    if warm.last_cache_stats.get("hits", {}).get("warmstart") != 1:
        fail(f"config7 no-op tick did not replay: {warm.last_cache_stats}")
    if compat.launches or ffd.launches:
        fail(f"config7 no-op tick launched kernels: compat {compat.launches}, ffd {ffd.launches}")
    if plan_stream(noop) != plan_stream(last_plan):
        fail("config7 no-op tick changed the plans")
    section("noop_s")

    # the second warm pass on the device engine: FFD scan launches per
    # class of the job-memo misses. Its reference is a cold solve of the
    # tick's own objects (a fresh scheduler, the warm state off): the
    # plans are checked here, the restart-shaped timing in the first pass
    native_rows = []
    with knobs(KARPENTER_TORCH_NATIVE=0), capture(pack, "ffd_pack_batched", 64) as ffd_cap:
        for k in range(native_off_ticks):
            if k:
                world.churn_tick()
            with knobs(KARPENTER_TORCH_INCREMENTAL=0):
                ref = solve(TorchScheduler([world.pool], world.provider, device=device), world.pods, "cold")
            ref_pods = world.pods
            real = pack.batch_pack
            calls = []

            def spy(jobs, *a, **kw):
                calls.append([(pack._pad_class(j[0].shape[0]), j[0].shape[1]) for j in jobs])
                return real(jobs, *a, **kw)

            pack.batch_pack = spy
            try:
                res = solve(warm, world.pods, "warm")
            finally:
                pack.batch_pack = real
            cs = warm.last_cache_stats
            job_misses = cs.get("misses", {}).get("job", 0)
            classes = sum(len(set(c)) for c in calls)
            row = {
                "tick": k, "job_hits": cs.get("hits", {}).get("job", 0), "job_misses": job_misses,
                "jobs_packed": sum(len(c) for c in calls), "classes": classes,
                "ffd_launches": legs["warm"]["ffd"][-1], "cold_ffd_launches": legs["cold"]["ffd"][-1],
                "compat_launches": legs["warm"]["compat"][-1], "cold_compat_launches": legs["cold"]["compat"][-1],
                "host_ms": legs["warm"]["host_ms"][-1], "cold_host_ms": legs["cold"]["host_ms"][-1],
            }
            native_rows.append(row)
            if row["jobs_packed"] != job_misses:
                fail(f"config7 device engine tick {k}: {row['jobs_packed']} jobs packed, {job_misses} job misses")
            # on the CPU the scan's plain version runs: no launch to count
            expect = classes if device == "cuda" else 0
            if row["ffd_launches"] != expect or (classes == 0) != (job_misses == 0):
                fail(f"config7 device engine tick {k}: {row}")
            if config7_canon(res, world.pods) != config7_canon(ref, ref_pods):
                fail(f"config7 device engine tick {k}: the warm plans differ from the cold plans")
        # the pass's last warm plans against a cold CPU solve through the
        # plain scans
        with knobs(KARPENTER_TORCH_INCREMENTAL=0):
            cpu_scan = TorchScheduler([world.pool], world.provider, device="cpu").solve(world.pods)
        if config7_canon(res, world.pods) != config7_canon(cpu_scan, world.pods):
            fail("config7 device engine: the last warm plans differ from a cold CPU solve's")
    section("native_off_pass_s")

    # the restart: snapshot, process death, restore into a fresh scheduler
    last_pods, last_provider, last_pool = world.clones()
    compat.launches = ffd.launches = 0
    unkilled = warm.solve(world.pods)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = warm.snapshot(directory=tmp)
        snapshot_ms = (time.perf_counter() - t0) * 1000.0
        if path is None:
            fail("config7: the warm store wrote no snapshot")
        snapshot_bytes = os.path.getsize(path)
        warmstore.simulate_process_death()
        last_provider.bump_catalog_generation()
        restored = TorchScheduler([last_pool], last_provider, device=device)
        with nogc():
            t0 = time.perf_counter()
            outcome = restored.restore(path)
            restore_ms = (time.perf_counter() - t0) * 1000.0
    # memo entries of catalogs mutated away since are dropped (their
    # fingerprint witnesses no live catalog); the live catalog's restore
    restored_planes = outcome.get("restored", {})
    if outcome.get("dropped", {}).get("catalog") or not all(
        restored_planes.get(plane) for plane in ("catalog", "compat", "route", "job")
    ):
        fail(f"config7 restore: {outcome}")
    compat.launches = ffd.launches = 0
    with nogc():
        t0 = time.perf_counter()
        first = restored.solve(last_pods)
        restored_ms = (time.perf_counter() - t0) * 1000.0
    restart_row = {
        "restored": outcome["restored"], "dropped": outcome["dropped"], "restore_ms": restore_ms,
        "snapshot_ms": snapshot_ms, "snapshot_bytes": snapshot_bytes,
        "first_solve_ms": restored_ms, "first_solve_host_ms": restored.last_timings["host_ms"],
        "compat_launches": compat.launches, "ffd_launches": ffd.launches,
        "cache": restored.last_cache_stats,
    }
    if config7_canon(first, last_pods) != config7_canon(unkilled, world.pods):
        fail("config7: the restored scheduler's first solve differs from the un-killed scheduler's")
    if compat.launches:
        fail(f"config7: the restored first solve launched {compat.launches} compat kernels")
    section("restart_s")

    # the last tick's plan against a cold solve on the CPU
    with knobs(KARPENTER_TORCH_INCREMENTAL=0):
        cpu = TorchScheduler([world.pool], world.provider, device="cpu").solve(world.pods)
    if plan_sha256(cpu) != plan_sha256(first):
        fail("config7: the last tick's plan differs from the cold CPU solve's")
    section("cpu_check_s")

    # every distinct compat and FFD shape the phase's solves gave, against
    # the plain versions on the card (these launches are not counted)
    kernel_cases = {"compat_allowed": [], "ffd_pack": []}
    if device == "cuda":
        kernel_cases["compat_allowed"] = [compat_call_case(c) for c in distinct_compat_calls(compat_cap.calls)]
        kernel_cases["ffd_pack"] = [ffd_kernel_case(c) for c in distinct_shapes(ffd_cap.calls)]
        if not kernel_cases["compat_allowed"] or not kernel_cases["ffd_pack"]:
            fail(f"config7: no compat or FFD call was captured: {len(compat_cap.calls)}, {len(ffd_cap.calls)}")
    section("kernel_cases_s")

    gc.unfreeze()
    cold_p50, warm_p50 = _pctl(legs["cold"]["host_ms"][:ticks], 50), _pctl(legs["warm"]["host_ms"][:ticks], 50)
    return {
        "ticks": ticks,
        "plan_identical_ticks": identical,
        "native_off_plan_identical_ticks": len(native_rows),
        "cold_tick_host_ms_p50": cold_p50,
        "cold_tick_host_ms_p99": _pctl(legs["cold"]["host_ms"][:ticks], 99),
        "warm_tick_host_ms_p50": warm_p50,
        "warm_tick_host_ms_p99": _pctl(legs["warm"]["host_ms"][:ticks], 99),
        "cold_over_warm_p50": cold_p50 / warm_p50 if warm_p50 else None,
        "warm_tick_wall_ms_p50": _pctl(legs["warm"]["total_ms"][:ticks], 50),
        # each leg's solve phases (last_timings), median over the ticks
        **{
            f"{leg}_tick_phases_ms_p50": {
                k: _pctl([t[k] for t in legs[leg]["timings"][:ticks]], 50)
                for k in legs[leg]["timings"][0] if k.endswith("_ms")
            }
            for leg in ("cold", "warm")
        },
        "noop_tick_host_ms": noop_row["host_ms"],
        "noop": noop_row,
        "mean_hit_rate": float(np.mean(hit_rates)) if hit_rates else 0.0,
        "hits": hits,
        "misses": misses,
        "launches": {
            "cold": {"compat": sum(legs["cold"]["compat"][:ticks]), "ffd": sum(legs["cold"]["ffd"][:ticks])},
            "warm": {"compat": sum(legs["warm"]["compat"][:ticks]), "ffd": sum(legs["warm"]["ffd"][:ticks])},
            "noop": {"compat": noop_row["compat_launches"], "ffd": noop_row["ffd_launches"]},
            "native-off-cold": {"compat": sum(r["cold_compat_launches"] for r in native_rows),
                                "ffd": sum(r["cold_ffd_launches"] for r in native_rows)},
            "native-off-warm": {"compat": sum(r["compat_launches"] for r in native_rows),
                                "ffd": sum(r["ffd_launches"] for r in native_rows)},
            "restored": {"compat": restart_row["compat_launches"], "ffd": restart_row["ffd_launches"]},
        },
        "compat_launches_by_tick": {"cold": legs["cold"]["compat"][:ticks], "warm": legs["warm"]["compat"][:ticks]},
        "native_off": native_rows,
        "restart": restart_row,
        "kernel_cases": kernel_cases,
        "sections_s": sections,
        "last_plan_sha256": plan_sha256(first),
        "nodes": len(first.node_plans),
        "total_price": first.total_price,
        # the JAX package's 3x warm/cold gate is a TPU number: recorded here, never asserted
        "tpu_gate_3x_met": bool(warm_p50 and cold_p50 / warm_p50 >= 3.0),
    }


# -- phase 15: disruption (bench configs 4 and 9, the controller) ------------------

N_CONFIG4 = 5_000  # bench.py config 4 (bench.py:552-602): initialized fake-it-4 nodes, one pod each
N_CONFIG9_NODES = 500  # bench.py config 9 (bench.py:1150-1460): dx-host nodes
CONFIG9_PODS_PER_NODE = 100
CONFIG9_SEED = 9  # scenario_spot_storm's seed
CONFIG9_TEAMS = 20
CONFIG9_STEADY = 5  # phase A's steady decisions
N_CONTROLLER_NODES = 40  # phase 15c's store world
CONTROLLER_SEED = 15
DISRUPT_CLOCK = 10_000.0  # tests/helpers.py Env's clock at start
SCREEN_REPLACES = {
    "prefix": "karpenter_core_tpu/disruption/tpu_repack.py:40",
    "subsets": "karpenter_core_tpu/disruption/tpu_repack.py:69",
    "singles": "karpenter_core_tpu/disruption/tpu_repack.py:102",
}


def disrupt_launches() -> dict:
    """Every kernel phase 15's paths launch, by name: the three screen
    entries (B8), the existing-node first-fit (B6), the FFD scan (B5)
    and the compat kernel."""
    from karpenter_core_tpu_torch.disruption import screen_kernels as sk

    return {**{f"disrupt_screen.{k}": v.launches for k, v in sk.KERNELS.items()},
            **{k: v.launches for k, v in all_kernels().items()}}


def reset_disrupt_launches() -> None:
    from karpenter_core_tpu_torch.disruption import screen_kernels as sk

    for k in [*sk.KERNELS.values(), *all_kernels().values()]:
        k.launches = 0


class same_identities:
    """Generated names, claim hostnames and uids restart inside the block
    (a counter stands in for uuid4), so two runs of one world on two
    devices give their objects the same identities: the greedy queue
    breaks ties by uid."""

    def __enter__(self):
        import itertools
        import uuid

        from karpenter_core_tpu_torch.kube import objects
        from karpenter_core_tpu_torch.scheduler import nodeclaim

        objects._sequence = itertools.count(1)
        nodeclaim._hostname_counter = itertools.count(1)
        ids = itertools.count(1)
        self.uuid4, uuid.uuid4 = uuid.uuid4, lambda: uuid.UUID(int=next(ids))
        return self

    def __exit__(self, *exc):
        import uuid

        uuid.uuid4 = self.uuid4


class DisruptWorld:
    """tests/helpers.py's ``Env`` on the port, the batched solve's and
    the screens' device ``device``: an in-memory store, the fake
    provider (``instance_types(10)``), ``Informers`` feeding a
    ``Cluster``, a ``Recorder``, a ``Provisioner`` and a
    ``DisruptionController`` (no validation wait), one NodePool
    ``default`` (consolidate when underutilized, at once, budget 100 %),
    all on a clock the world moves (``now``)."""

    def __init__(self, device: str):
        from karpenter_core_tpu_torch.apis.nodepool import CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED
        from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_core_tpu_torch.disruption import DisruptionController
        from karpenter_core_tpu_torch.events import Recorder
        from karpenter_core_tpu_torch.kube.client import KubeClient
        from karpenter_core_tpu_torch.provisioning import Provisioner
        from karpenter_core_tpu_torch.state.cluster import Cluster
        from karpenter_core_tpu_torch.state.informers import Informers

        self.now = DISRUPT_CLOCK
        self.kube = KubeClient()
        self.provider = FakeCloudProvider()
        self.provider.instance_types = instance_types(10)
        self.cluster = Cluster(self.kube, self.provider, clock=self.clock)
        self.informers = Informers(self.kube, self.cluster)
        self.informers.start()
        self.recorder = Recorder()
        self.provisioner = Provisioner(self.kube, self.provider, self.cluster, recorder=self.recorder, device=device)
        self.nodepool = self.pool("default", CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED)
        self.controller = DisruptionController(
            self.kube, self.cluster, self.provisioner, self.provider, recorder=self.recorder,
            clock=self.clock, validation_sleep=lambda t: None,
        )

    def clock(self) -> float:
        return self.now

    def pool(self, name: str, policy: str):
        from karpenter_core_tpu_torch.apis.nodepool import Budget, NodePool

        np_ = NodePool()
        np_.metadata.name = name
        np_.spec.disruption.budgets = [Budget(nodes="100%")]
        np_.spec.disruption.consolidation_policy = policy
        np_.spec.disruption.consolidate_after = 0.0
        self.kube.create(np_)
        return np_

    def make_initialized_node(self, instance_type_name: str = "fake-it-4", zone: str = "test-zone-1",
                              capacity_type: str = "on-demand", pods=(), nodepool=None):
        """An initialized Node and NodeClaim of ``nodepool`` (the
        world's own by default), the ``pods`` bound to it and running."""
        from karpenter_core_tpu_torch.apis import labels as wk
        from karpenter_core_tpu_torch.apis.nodeclaim import COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED, NodeClaim
        from karpenter_core_tpu_torch.kube.objects import Node, next_name

        pool = nodepool or self.nodepool
        it = next(i for i in self.provider.get_instance_types(pool) if i.name == instance_type_name)
        provider_id = f"fake:///node-{len(self.kube.list('Node'))}"
        nc = NodeClaim()
        nc.metadata.name = f"claim-{len(self.kube.list('NodeClaim'))}"
        nc.metadata.labels = {
            wk.NODEPOOL_LABEL_KEY: pool.name, wk.LABEL_INSTANCE_TYPE: instance_type_name,
            wk.LABEL_TOPOLOGY_ZONE: zone, wk.CAPACITY_TYPE_LABEL_KEY: capacity_type,
        }
        nc.metadata.annotations = {wk.NODEPOOL_HASH_ANNOTATION_KEY: pool.static_hash()}
        nc.status.provider_id = provider_id
        nc.status.capacity = dict(it.capacity)
        nc.status.allocatable = it.allocatable()
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
            nc.set_condition(cond, "True")
        self.kube.create(nc)
        self.provider.created_node_claims[provider_id] = nc
        node = Node()
        node.metadata.name = next_name("node")
        node.metadata.labels = {**nc.metadata.labels, wk.LABEL_HOSTNAME: node.metadata.name,
                                wk.NODE_REGISTERED_LABEL_KEY: "true", wk.NODE_INITIALIZED_LABEL_KEY: "true"}
        node.spec.provider_id = provider_id
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = it.allocatable()
        node.metadata.creation_timestamp = self.now - 100
        self.kube.create(node)
        for pod in pods:
            pod.spec.node_name = node.name
            pod.status.phase = "Running"
            pod.status.conditions = []
            self.kube.create(pod)
        return node, nc

    def stop(self) -> None:
        self.informers.stop()


def bound_pod(name: str, cpu: str = "100m", mem: Optional[str] = "128Mi", labels=None):
    """A pod of one container requesting ``cpu`` (and ``mem``), to be
    bound by ``make_initialized_node``."""
    from karpenter_core_tpu_torch.kube.objects import Container, Pod, PodSpec, ResourceRequirements
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    pod = Pod()
    pod.metadata.name = name
    pod.metadata.labels = dict(labels or {})
    requests = {"cpu": parse_quantity(cpu)}
    if mem is not None:
        requests["memory"] = parse_quantity(mem)
    pod.spec = PodSpec(containers=[Container(name="c", resources=ResourceRequirements(requests=requests))])
    return pod


def disrupt_cmd_key(cmd) -> tuple:
    """bench.py's ``_disrupt_cmd_key``: action, disrupted nodes,
    replacement types."""
    reps = tuple(tuple(sorted(it.name for it in r.instance_type_options)) for r in (cmd.replacements or []))
    return (cmd.action(), tuple(sorted(c.name() for c in cmd.candidates)), reps)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def config4_world(device: str, n_nodes: int = N_CONFIG4) -> DisruptWorld:
    """bench config 4's world: ``n_nodes`` initialized ``fake-it-4``
    nodes, each running one 100m / 128Mi pod, an hour on the clock."""
    w = DisruptWorld(device)
    for i in range(n_nodes):
        w.make_initialized_node("fake-it-4", pods=[bound_pod(f"r-{i}")])
    w.now += 3600.0
    if not w.cluster.synced():
        fail("config4: the cluster is not synced with its store")
    return w


def run_config4(device: str, n_nodes: int = N_CONFIG4) -> dict:
    """Phase 15a: bench config 4 whole on ``device``: ``get_candidates``
    then ``MultiNodeConsolidation.compute_command`` (the batched engine;
    the simulations on the greedy scheduler, as the bench's provisioner
    has no batched path), launches counted from 0 just before."""
    from karpenter_core_tpu_torch.disruption.helpers import get_candidates
    from karpenter_core_tpu_torch.disruption.methods import MultiNodeConsolidation

    with same_identities():
        w = config4_world(device, n_nodes)
        try:
            method = MultiNodeConsolidation(w.controller.ctx)
            reset_disrupt_launches()
            with nogc():
                t0 = time.perf_counter()
                candidates = get_candidates(w.cluster, w.kube, w.recorder, w.clock, w.provider, method.should_disrupt)
                cmd = method.compute_command(candidates)
                _sync(device)
                elapsed = time.perf_counter() - t0
            launches = disrupt_launches()
        finally:
            w.stop()
    stats = method.last_decision_stats or {}
    if cmd.action() == "no-op":
        fail("config4: 5,000 underutilized nodes and no consolidation")
    return {
        "candidates": len(candidates), "candidates_per_s": len(candidates) / elapsed,
        "disrupted": len(cmd.candidates), "action": cmd.action(), "elapsed_ms": elapsed * 1000.0,
        "decision_ms": stats.get("decision_ms"),
        "engine": {k: stats.get(k) for k in ("screen_upper_k", "repack_lower_k", "subsets_screened",
                                             "screen_feasible_subsets", "subsets_verified", "family_capped")},
        "key": disrupt_cmd_key(cmd), "kernel_launches": launches,
    }


def config9_fleet(device: str, n_nodes: int = N_CONFIG9_NODES, pods_per_node: int = CONFIG9_PODS_PER_NODE,
                  seed: int = CONFIG9_SEED):
    """bench config 9's fleet (``bench.py:disrupt_fleet``): ``n_nodes``
    initialized ``dx-host`` nodes (160 CPU, 320Gi, ``pods_per_node``
    pods; three in ten spot, two zones) under one pool with the batched
    solver and a 5 % budget, the catalog ``dx-host`` and ``dx-half``
    with spot at 0.4 of on-demand; ``scenario_spot_storm(scale=n_nodes *
    pods_per_node, teams=20, seed)`` as the stream. A pod binds first-fit
    from a start node given by its name (CRC-32, where the bench takes
    Python's per-process string hash) under 155 CPU and the pods cap →
    (world, scenario, bind_step, mutate_catalog)."""
    import zlib

    from karpenter_core_tpu_torch.apis.nodepool import Budget
    from karpenter_core_tpu_torch.cloudprovider.fake import new_instance_type, price_from_resources
    from karpenter_core_tpu_torch.cloudprovider.types import Offering
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    def catalog(price_factor: float = 1.0):
        out = []
        for name, cpu, mem, pods in (("dx-host", "160", "320Gi", str(pods_per_node)),
                                     ("dx-half", "80", "160Gi", str(max(1, pods_per_node // 2)))):
            res = {"cpu": cpu, "memory": mem, "pods": pods}
            price = price_from_resources({k: parse_quantity(v) for k, v in res.items()}) * price_factor
            out.append(new_instance_type(name, res, offerings=[
                Offering(ct, z, price * (0.4 if ct == "spot" else 1.0))
                for ct in ("spot", "on-demand") for z in ("test-zone-1", "test-zone-2")
            ]))
        return out

    w = DisruptWorld(device)
    w.provider.set_instance_types(catalog())
    w.provisioner.use_tpu_solver = True
    w.nodepool.spec.disruption.budgets = [Budget(nodes="5%")]
    w.kube.apply(w.nodepool)
    nodes = [
        w.make_initialized_node("dx-host", zone=f"test-zone-{1 + i % 2}",
                                capacity_type="spot" if i % 10 < 3 else "on-demand")[0]
        for i in range(n_nodes)
    ]
    cpu_cap_m = 155_000
    used = {n.name: [0, 0] for n in nodes}
    by_name: dict = {}

    def bind(spec) -> bool:
        cpu_m = int(str(spec.cpu)[:-1])
        start = zlib.crc32(spec.name.encode()) % n_nodes
        for j in range(n_nodes):
            node = nodes[(start + j) % n_nodes]
            u = used[node.name]
            if u[0] + cpu_m <= cpu_cap_m and u[1] < pods_per_node:
                pod = bound_pod(spec.name, spec.cpu, spec.mem, labels={"team": f"t{spec.team}"})
                pod.spec.node_name = node.name
                pod.status.phase = "Running"
                w.kube.create(pod)
                u[0] += cpu_m
                u[1] += 1
                by_name[spec.name] = (pod, node.name, cpu_m)
                return True
        return False

    def bind_step(step, create_fraction: float = 1.0) -> dict:
        removed = 0
        for name in list(step.evicts) + list(step.deletes):
            ent = by_name.pop(name, None)
            if ent is None:
                continue
            pod, node_name, cpu_m = ent
            w.kube.delete(pod)
            used[node_name][0] -= cpu_m
            used[node_name][1] -= 1
            removed += 1
        creates = step.creates[: int(len(step.creates) * create_fraction)]
        bound = sum(1 for spec in creates if bind(spec))
        return {"bound": bound, "dropped": len(creates) - bound, "removed": removed}

    storms = [0]

    def mutate_catalog() -> None:
        storms[0] += 1
        w.provider.set_instance_types(catalog(1.0 + 0.1 * (storms[0] % 3)))

    scenario = tg.scenario_spot_storm(scale=n_nodes * pods_per_node, teams=CONFIG9_TEAMS, seed=seed)
    return w, scenario, bind_step, mutate_catalog


def disrupt_decide(w: DisruptWorld, mode: str, device: str, single: bool = False):
    """bench.py's ``disrupt_decide``: one consolidation decision under
    ``mode`` (batched | sequential), a fresh method on the world's
    controller-shared engine → (command, ms, engine stats, candidates)."""
    from karpenter_core_tpu_torch.disruption.budgets import build_disruption_budgets
    from karpenter_core_tpu_torch.disruption.helpers import get_candidates
    from karpenter_core_tpu_torch.disruption.methods import MultiNodeConsolidation, SingleNodeConsolidation

    with knobs(KARPENTER_TORCH_DISRUPT_ENGINE=mode):
        ctx = w.controller.ctx
        ctx.budgets = build_disruption_budgets(w.cluster, w.kube, w.clock, w.controller.queue)
        method = (SingleNodeConsolidation if single else MultiNodeConsolidation)(ctx)
        candidates = get_candidates(w.cluster, w.kube, w.recorder, w.clock, w.provider, method.should_disrupt,
                                    w.controller.queue)
        t0 = time.perf_counter()
        cmd = method.compute_command(candidates)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1000.0
    return cmd, ms, dict(method.last_decision_stats or {}), len(candidates)


ENGINE_STAT_KEYS = ("candidates", "screen_upper_k", "repack_lower_k", "subsets_screened",
                    "screen_feasible_subsets", "subsets_verified", "family_capped")


def run_config9(device: str, n_nodes: int = N_CONFIG9_NODES, pods_per_node: int = CONFIG9_PODS_PER_NODE,
                steady: int = CONFIG9_STEADY, sequential: bool = True, churn_only: bool = False) -> dict:
    """Phase 15b: bench config 9 on ``device``. Phase A on the pods-full
    fleet (a screen-proven no-op, then ``steady`` steady decisions), phase
    B the stream's churn steps (the storm recovering at 70 %, a price
    storm after the second step), then the single-node decision. Every
    decision runs batched and, with ``sequential``, sequential; their
    command keys must be equal. ``churn_only`` skips the steady decisions
    and the single-node decision. Launches are counted from 0 just before
    the first decision. → the row, with every batched key in order
    (``keys``)."""
    with same_identities():
        t0 = time.perf_counter()
        w, scenario, bind_step, mutate_catalog = config9_fleet(device, n_nodes, pods_per_node)
        try:
            base = bind_step(scenario.steps[0])
            w.now += 3600.0
            if not w.cluster.synced():
                fail("config9: the cluster is not synced with its store")
            build_s = time.perf_counter() - t0
            keys, steps, steady_ms, churn_ms, seq_churn_ms = [], [], [], [], []

            def decide(label, single=False):
                cmd_b, ms_b, st, n = disrupt_decide(w, "batched", device, single)
                row = {"step": label, "batched_ms": ms_b, "action": cmd_b.action(),
                       "disrupted": len(cmd_b.candidates), "candidates": n,
                       **{k: st.get(k) for k in ENGINE_STAT_KEYS}, "cache": st.get("cache")}
                if sequential:
                    cmd_s, ms_s, _, _ = disrupt_decide(w, "sequential", device, single)
                    row["sequential_ms"] = ms_s
                    if disrupt_cmd_key(cmd_s) != disrupt_cmd_key(cmd_b):
                        fail(f"config9 {label}: batched {disrupt_cmd_key(cmd_b)} != sequential {disrupt_cmd_key(cmd_s)}")
                keys.append(disrupt_cmd_key(cmd_b))
                steps.append(row)
                return row

            reset_disrupt_launches()
            with nogc():
                first = decide("A0")
                if not churn_only:
                    for i in range(steady):
                        cmd, ms, st, _ = disrupt_decide(w, "batched", device)
                        steady_ms.append(ms)
                        if disrupt_cmd_key(cmd) != keys[0]:
                            fail("config9: a steady decision differs from the first")
                for i, step in enumerate(scenario.steps[1:]):
                    storm = len(step.evicts) > n_nodes * pods_per_node * 0.1
                    bind_step(step, create_fraction=0.7 if storm else 1.0)
                    if i == 1:
                        mutate_catalog()
                    w.now += 60.0
                    row = decide(f"B{i + 1}")
                    churn_ms.append(row["batched_ms"])
                    if sequential:
                        seq_churn_ms.append(row["sequential_ms"])
                if not churn_only:
                    decide("single", single=True)
            launches = disrupt_launches()
        finally:
            w.stop()
    return {
        "pods": base["bound"], "dropped": base["dropped"], "nodes": n_nodes, "steps": steps, "keys": keys,
        "build_s": build_s, "kernel_launches": launches,
        # bench config 9's steady no-op on the pods-full fleet, decided by the screen alone
        "steady_noop_screen_proven": first["action"] == "no-op" and first["screen_upper_k"] == 0,
        "steady_decision_ms": {"p50": _pctl(steady_ms, 50), "p99": _pctl(steady_ms, 99)} if steady_ms else None,
        "churn_decision_ms": {"p50": _pctl(churn_ms, 50), "p99": _pctl(churn_ms, 99)},
        "churn_sequential_ms": ({"p50": _pctl(seq_churn_ms, 50), "p99": _pctl(seq_churn_ms, 99)}
                                if seq_churn_ms else None),
    }


def controller_world(device: str, n_nodes: int = N_CONTROLLER_NODES, seed: int = CONTROLLER_SEED) -> DisruptWorld:
    """Phase 15c's store world: ``n_nodes`` nodes of ``fake-it-2`` ..
    ``fake-it-8`` across two zones, three in ten spot, carrying 0-5 bound
    pods (100m to 900m) in three pools: ``default`` (underutilized:
    consolidation; one claim's pool hash stale: drift), ``spare``
    (``expire_after`` 30 min: expiration) and ``empty`` (consolidate when
    empty, two empty nodes: emptiness); the provider reports no drift of
    its own; an hour on the clock."""
    from karpenter_core_tpu_torch.apis import labels as wk
    from karpenter_core_tpu_torch.apis.nodepool import CONSOLIDATION_POLICY_WHEN_EMPTY, CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED

    rng = np.random.RandomState(seed)
    w = DisruptWorld(device)
    w.provider.drifted = ""
    spare = w.pool("spare", CONSOLIDATION_POLICY_WHEN_UNDERUTILIZED)
    spare.spec.disruption.expire_after = 1800.0
    w.kube.apply(spare)
    empty = w.pool("empty", CONSOLIDATION_POLICY_WHEN_EMPTY)
    for i in range(n_nodes):
        pool = spare if rng.rand() < 0.2 else w.nodepool
        pods = [bound_pod(f"p-{i}-{j}", f"{int(rng.choice([100, 200, 400, 900]))}m", None)
                for j in range(int(rng.randint(0, 6)))]
        w.make_initialized_node(f"fake-it-{int(rng.randint(2, 9))}", zone=f"test-zone-{1 + int(rng.randint(2))}",
                                capacity_type="spot" if rng.rand() < 0.3 else "on-demand", pods=pods,
                                nodepool=pool)
    for _ in range(2):
        w.make_initialized_node("fake-it-3", nodepool=empty)
    claims = sorted((nc for nc in w.kube.list("NodeClaim") if nc.metadata.labels[wk.NODEPOOL_LABEL_KEY] == "default"),
                    key=lambda nc: nc.metadata.name)
    stale = claims[int(rng.randint(len(claims)))]
    stale.metadata.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = "stale"
    w.kube.apply(stale)
    for pool in w.kube.list("NodePool"):
        pool.metadata.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = pool.static_hash()
        w.kube.apply(pool)
    w.now += 3600.0
    if not w.cluster.synced():
        fail("controller-e2e: the cluster is not synced with its store")
    return w


def run_controller_e2e(device: str, n_nodes: int = N_CONTROLLER_NODES) -> dict:
    """Phase 15c: ``NodeClaimDisruptionController.reconcile_all``, then
    ``DisruptionController.reconcile`` until it returns nothing, then
    ``OrchestrationQueue.reconcile``, on the batched solver → the
    executed methods and the store: conditions, taints, claims, deletion
    marks, events, the disruption metric samples; launches counted from 0
    just before the first reconcile."""
    from karpenter_core_tpu_torch.apis.nodeclaim import COND_EMPTY
    from karpenter_core_tpu_torch.disruption import NodeClaimDisruptionController
    from karpenter_core_tpu_torch.metrics import Metrics

    with same_identities():
        w = controller_world(device, n_nodes)
        try:
            w.provisioner.use_tpu_solver = True
            metrics = Metrics()
            w.controller.metrics = w.controller.queue.metrics = metrics
            reset_disrupt_launches()
            t0 = time.perf_counter()
            NodeClaimDisruptionController(w.kube, w.provider, w.cluster, clock=w.clock).reconcile_all()
            for nc in w.kube.list("NodeClaim"):
                # conditions carry wall-clock stamps; the world runs on its own clock
                cond = nc.get_condition(COND_EMPTY)
                if cond is not None:
                    cond.last_transition_time = w.now - 60.0
            passes = []
            for _ in range(3 * n_nodes):
                done = w.controller.reconcile()
                passes.append(done)
                if done is None:
                    break
            w.controller.queue.reconcile()
            _sync(device)
            elapsed = time.perf_counter() - t0
            launches = disrupt_launches()
            store = {
                "passes": passes,
                "conditions": sorted((nc.metadata.name, sorted((c.type, c.status) for c in nc.status.conditions))
                                     for nc in w.kube.list("NodeClaim")),
                "taints": sorted((n.metadata.name, sorted((t.key, t.value, t.effect) for t in n.spec.taints))
                                 for n in w.kube.list("Node")),
                "claims": sorted((nc.metadata.name, sorted(nc.metadata.labels.items()),
                                  sorted((r.key, r.operator, tuple(sorted(r.values))) for r in nc.spec.requirements),
                                  nc.metadata.deletion_timestamp is not None)
                                 for nc in w.kube.list("NodeClaim")),
                "marked": sorted(pid for pid, n in w.cluster.nodes.items() if n.marked_for_deletion),
                "events": sorted((e.type, e.reason, getattr(e.involved_object, "name", ""), e.message)
                                 for e in w.recorder.events),
                "actions": sorted(metrics.disruption_actions.values.items()),
                "eligible": sorted(metrics.eligible_nodes.values.items()),
                "subsets": sorted(metrics.disruption_subsets.values.items()),
                "disrupted": sorted(metrics.nodeclaims_disrupted.values.items()),
            }
        finally:
            w.stop()
    methods = {m for m in passes if m}
    if not {"expiration", "drift", "emptiness", "consolidation"} <= methods:
        fail(f"controller-e2e: the passes {passes} miss a method")
    return {"store": store, "elapsed_ms": elapsed * 1000.0, "kernel_launches": launches,
            "passes": passes, "actions": store["actions"]}


def _screen_formula_library(kind: str, args):
    """The reference's formula as one PyTorch expression on the card
    (``torch.cumsum`` / ``masks.float() @ loads.float()``): the yardstick
    of ``library_ms``, never called on the port's path."""
    import torch

    if kind == "subsets":
        masks, loads, free, fleet, cap = args
        m = masks.float()
        return (m @ loads.float() <= fleet.float()[None] + (1.0 - m) @ free.float() + cap.float()[None]).all(-1)
    loads, free, fleet, cap = args
    lf, ff = loads.float(), free.float()
    if kind == "prefix":
        surv = ff.sum(0)[None] - torch.cumsum(ff, 0)
        return (torch.cumsum(lf, 0) <= fleet.float()[None] + surv + cap.float()[None]).all(-1)
    return (lf <= fleet.float()[None] + (ff.sum(0)[None] - ff) + cap.float()[None]).all(-1)


def screen_chain_adds(kind: str, N: int, R: int) -> int:
    """The longest chain of dependent float32 adds one screen call runs in
    disrupt_screen.cu: a subset row walks the N candidates once for each
    chunk of 8 columns, the prefix pass and a single row's total walk
    them once (the prefix twice past one tile of shared memory, which no
    shape here reaches)."""
    return N * max(1, -(-R // 8)) if kind == "subsets" else N


def screen_kernel_case(kind: str, call, path: str, sm_mhz: float, reps: int = 20) -> dict:
    """One screen call against its plain version on the card, bit for bit,
    with the kernel's time, the plain version's, the reference formula's
    as one PyTorch expression (and whether it agrees), the bound, the
    chain (``chain_ms``: ``screen_chain_adds`` dependent float32 adds at
    FADD_CYCLES cycles each, at the maximum SM clock ``sm_mhz``; an
    assumption, not a measurement), and the largest float32 partial sum
    of the inputs (above 2^24 the order of the additions can move a
    verdict). ``path``: where the call was captured, or "synthetic"."""
    import torch

    from karpenter_core_tpu_torch.disruption import screen_kernels as sk

    args = tuple(a.cuda() for a in call)
    fn = {"prefix": sk.screen_prefix, "subsets": sk.screen_subsets, "singles": sk.screen_singles}[kind]
    plain = {"prefix": sk.prefix_screen_reference, "subsets": sk.subset_screen_reference,
             "singles": sk.single_screen_reference}[kind]
    before = sk.KERNELS[kind].launches
    got = fn(*args)
    t0 = time.perf_counter()
    want = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if not torch.equal(got, want):
        fail(f"disrupt_screen {kind} differs from its plain version at {[tuple(a.shape) for a in args]}")
    kernel_ms = events_ms(lambda: fn(*args), reps)
    library_ms = events_ms(lambda: _screen_formula_library(kind, args), reps)
    library_agrees = bool(torch.equal(_screen_formula_library(kind, args), got))
    sk.KERNELS[kind].launches = before  # the comparison's launches are not the path's
    loads, free = args[-4], args[-3]
    N, R = loads.shape
    rows = args[0].shape[0] if kind == "subsets" else N
    bytes_moved = 2 * N * R * 4 + 2 * R * 4 + rows + (rows * N if kind == "subsets" else 0)
    ops = {"prefix": 6 * N * R, "singles": 5 * N * R, "subsets": 4 * rows * N * R}[kind]
    max_sum = float(max(loads.double().sum(0).max().item(), free.double().sum(0).max().item())) if N else 0.0
    chain = screen_chain_adds(kind, N, R)
    return {
        "entry": kind, "captured": path, "rows": rows, "N": N, "R": R, "max_abs_err": 0,
        "true_rows": int(got.sum()), "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_agrees": library_agrees, "max_partial_sum": max_sum, "above_2_24": max_sum >= 2.0**24,
        "chain_adds": chain, "chain_ms": chain * FADD_CYCLES / (sm_mhz * 1e3),
        **bound_row(bytes_moved, ops),
    }


SYNTHETIC_SCREENS = (("subsets", 8193, 1000, 3), ("subsets", 999, 1000, 8), ("prefix", 0, 1000, 8),
                     ("prefix", 0, 4097, 3))


def synthetic_screen_calls(seed: int = 14) -> list:
    """Screen calls past the captured shapes, on the CPU: the subset family
    at its cap (``FAMILY_MAX`` + 1 = 8,193 rows × 1,000 candidates, its
    first 999 rows prefixes as the engine's family begins), 8 columns at
    config 4's 999 × 1,000, and the prefix at 1,000 × 8 and 4,097 × 3;
    loads and free below 2^29 (a quantized memory column), so partial sums
    pass 2^24. → [(kind, call)]."""
    import torch

    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = []
    for kind, S, N, R in SYNTHETIC_SCREENS:
        loads = rng.randint(0, 1 << 29, (N, R)).astype(np.int32)
        free = rng.randint(0, 1 << 29, (N, R)).astype(np.int32)
        fleet = rng.randint(0, 1 << 30, R).astype(np.int32)
        cap = rng.randint(0, 1 << 30, R).astype(np.int32)
        if kind == "prefix":
            out.append((kind, (t(loads), t(free), t(fleet), t(cap))))
            continue
        masks = (rng.rand(S, N) < 0.5).astype(np.uint8)
        masks[: N - 1] = np.tril(np.ones((N, N), dtype=np.uint8))[1:]
        out.append((kind, (t(masks), t(loads), t(free), t(fleet), t(cap))))
    return out


class capture_screens:
    """Capture every screen call (the three wrappers' tensors, on the CPU)
    inside the block, by entry."""

    def __enter__(self):
        from karpenter_core_tpu_torch.disruption import screen_kernels as sk

        self.caps = {kind: capture(sk, f"screen_{kind}") for kind in ("prefix", "subsets", "singles")}
        for c in self.caps.values():
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in self.caps.values():
            c.__exit__(*exc)

    def calls(self) -> dict:
        return {kind: c.calls for kind, c in self.caps.items()}


def run_disruption_phase(device: str = "cuda", sizes: Optional[dict] = None, sm_mhz: float = 0.0) -> dict:
    """Phase 15 on ``device`` with the warm state on: 15a bench config 4
    (also with ``KARPENTER_TORCH_NATIVE=0``: the repack bound on B6),
    15b bench config 9 (batched against sequential every decision; the
    churn steps again with ``KARPENTER_TORCH_NATIVE=0``: B6 and the FFD
    scan), 15c the controller end to end; each against a CPU run of the
    same world (15b's CPU leg batched only, its steady decisions left
    out). On the card, 15d holds every distinct captured screen call and
    the synthetic ones (``synthetic_screen_calls``) against its plain
    version; ``sm_mhz``, the maximum SM clock, prices their chains.
    ``sizes``: {"config4": n_nodes, "config9": (n_nodes, pods_per_node),
    "controller": n_nodes} → the phase's row."""
    sizes = {"config4": N_CONFIG4, "config9": (N_CONFIG9_NODES, CONFIG9_PODS_PER_NODE),
             "controller": N_CONTROLLER_NODES, **(sizes or {})}
    sections: dict = {}
    t_section = time.perf_counter()

    def section(name):
        nonlocal t_section
        now = time.perf_counter()
        sections[name] = now - t_section
        t_section = now

    n9, ppn = sizes["config9"]
    with frozen_heap(), capture_screens() as screens:
        config4 = run_config4(device, sizes["config4"])
        with knobs(KARPENTER_TORCH_NATIVE=0):
            config4_native_off = run_config4(device, sizes["config4"])
        section("config4_s")
        config9 = run_config9(device, n9, ppn)
        section("config9_s")
        with knobs(KARPENTER_TORCH_NATIVE=0):
            config9_native_off = run_config9(device, n9, ppn, churn_only=True)
        section("config9_native_off_s")
        controller = run_controller_e2e(device, sizes["controller"])
        section("controller_s")
    # the same worlds on the CPU (the C++ packer; the card's native-off
    # legs are held to the same commands)
    cpu4 = run_config4("cpu", sizes["config4"])
    for label, row in (("config4", config4), ("config4-native-off", config4_native_off)):
        if (row["key"], row["engine"]) != (cpu4["key"], cpu4["engine"]):
            fail(f"{label}: the card's command {row['key'][:1]} {row['engine']} differs from the CPU's "
                 f"{cpu4['key'][:1]} {cpu4['engine']}")
    section("cpu_config4_s")
    cpu9 = run_config9("cpu", n9, ppn, steady=0, sequential=False)
    if cpu9["keys"] != config9["keys"]:
        fail(f"config9: the card's commands {config9['keys']} differ from the CPU's {cpu9['keys']}")
    churn_keys = config9["keys"][:-1]
    if config9_native_off["keys"] != churn_keys:
        fail(f"config9 native off: {config9_native_off['keys']} differ from the C++ packer's {churn_keys}")
    section("cpu_config9_s")
    cpu_ctrl = run_controller_e2e("cpu", sizes["controller"])
    if cpu_ctrl["store"] != controller["store"]:
        diff = [k for k in controller["store"] if controller["store"][k] != cpu_ctrl["store"][k]]
        fail(f"controller-e2e: the card's effects differ from the CPU's in {diff}")
    section("cpu_controller_s")
    # 15d: every distinct captured screen shape against its plain version
    cases = []
    if device == "cuda":
        if sm_mhz <= 0:
            fail("phase 15d needs the card's maximum SM clock to price the screens' chains")
        for kind, calls in screens.calls().items():
            for call in distinct_shapes(calls):
                cases.append(screen_kernel_case(kind, call, "phase15", sm_mhz))
        if {c["entry"] for c in cases} != {"prefix", "subsets", "singles"}:
            fail(f"phase 15 captured no call of some screen entry: {sorted({c['entry'] for c in cases})}")
        for kind, call in synthetic_screen_calls():
            cases.append(screen_kernel_case(kind, call, "synthetic", sm_mhz))
    section("kernel_cases_s")
    return {
        "config4": config4, "config4_native_off": config4_native_off, "config9": config9,
        "config9_native_off": config9_native_off, "controller": controller, "screen_cases": cases,
        "sections_s": sections,
        "launches": {
            "config4": config4["kernel_launches"], "config4-native-off": config4_native_off["kernel_launches"],
            "config9": config9["kernel_launches"], "config9-native-off": config9_native_off["kernel_launches"],
            "controller-e2e": controller["kernel_launches"],
        },
    }


def screen_kernel_entry(cases: list, launches: dict) -> dict:
    """B8's entry of the kernels line: its launches on phase 15's paths,
    by path and by entry point, and the numbers of its largest captured
    subset case (bench config 4's family), each entry's largest captured
    case beside them; the synthetic cases in ``cases``."""
    kinds = ("prefix", "subsets", "singles")
    keys = ("rows", "N", "R", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "chain_ms")
    by_path = {path: sum(n[f"disrupt_screen.{k}"] for k in kinds) for path, n in launches.items()}
    captured = [c for c in cases if c["captured"] != "synthetic"]
    entries = {}
    for kind in kinds:
        rows = [c for c in captured if c["entry"] == kind]
        big = max(rows, key=lambda r: r["rows"] * r["N"])
        entries[kind] = {
            "replaces": SCREEN_REPLACES[kind],
            "launches": sum(n[f"disrupt_screen.{kind}"] for n in launches.values()),
            **{k: big[k] for k in keys},
            "synthetic": [{k: c[k] for k in keys} for c in cases if c["captured"] == "synthetic" and c["entry"] == kind],
        }
    main = max((c for c in captured if c["entry"] == "subsets"), key=lambda r: r["rows"] * r["N"])
    return {
        "name": "disrupt_screen", "route": "cuda", "source": "karpenter_core_tpu_torch/csrc/disrupt_screen.cu",
        "replaces": SCREEN_REPLACES["subsets"], "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "chain_ms": main["chain_ms"], "entries": entries, "cases": cases,
    }


# -- phase 16: the serving pipeline -----------------------------------------------

CONFIG8_SCENARIOS = ("rollout", "spot_storm", "cascade", "diurnal", "churn10x")  # bench.py:1057
CONFIG8_SCALE = 400  # bench.py config 8: BENCH_STREAM_SCALE and BENCH_STREAM_PACE defaults
CONFIG8_PACE = 0.2
CONFIG14_SCALE = 600  # bench.py config 14: restart_wave at 600 pods x 480 types, kill at step 6
CONFIG14_TYPES = 480
CONFIG14_KILL = 6
CONFIG14_SEEDS = (7, 17, 27)
SERVING_SCALE = 400  # 16c's legs, at config 8's scale
SERVING_SCENARIOS = ("rollout", "cascade")
SERVING_CLOCK = 50_000.0  # 16c's world clock at start; it moves SERVING_STEP_S a step,
SERVING_STEP_S = 60.0  # past the 20 s nomination window
SERVING_DISRUPT_EVERY = 2
# the seconds phase 16 may take before 16b stops adding seeds past the first,
# and the seconds the whole script may have run by then (its limit is 1,200)
SERVING_BUDGET_S = 240.0
SCRIPT_BUDGET_S = 1000.0
# main waits for its lanes until the script has run this long, then fails
# (inside the 1,200 s a run of the script is allowed)
LANE_DEADLINE_S = 1150.0
# phase 22's reserve (the analyzer, the witnessed run and the contract
# pass), kept out of the budgets of the phases before it in its lane
ANALYSIS_RESERVE_S = 60.0


def trafficgen(args: list, timeout: float = 600.0) -> dict:
    """One ``python -m karpenter_core_tpu_torch.serving.trafficgen`` run
    from the checkout root → its JSON line with ``process_s`` (the
    process's wall seconds), or ``{"error": ...}`` on a nonzero exit, a
    missing line or a fault of the serving logger (the caller fails).
    The child is killed at ``timeout``."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "karpenter_core_tpu_torch.serving.trafficgen", *map(str, args)]
    try:
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"{' '.join(cmd[3:])} timed out after {timeout} s"}
    if proc.returncode != 0:
        return {"error": f"{' '.join(cmd[3:])} exited {proc.returncode}: {proc.stderr[-2000:]}"}
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"error": f"{' '.join(cmd[3:])} printed no JSON line: {proc.stdout[-500:]}"}
    if out.get("serving_log_faults"):
        return {"error": f"{' '.join(cmd[3:])}: the serving logger reported {out['serving_log_faults'][:5]}"}
    out["process_s"] = time.perf_counter() - t0
    return out


def trafficgen_all(jobs: dict, workers: int, phase: str = "phase 16") -> dict:
    """``trafficgen`` over ``jobs`` (key → args), ``workers`` processes at
    a time; fails, once all have ended, naming ``phase`` and every run
    that failed."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {key: pool.submit(trafficgen, args) for key, args in jobs.items()}
    out = {key: f.result() for key, f in futures.items()}
    errors = [f"{key}: {r['error']}" for key, r in out.items() if "error" in r]
    if errors:
        fail(f"{phase}: " + " | ".join(errors))
    return out


def run_config8_phase(device: str = "cuda", scale: int = CONFIG8_SCALE, pace: float = CONFIG8_PACE,
                      scenarios=CONFIG8_SCENARIOS, workers: int = 8) -> dict:
    """16a, bench config 8 (``bench.py:1035-1131``): each scenario in
    lockstep through the sequential loop and the pipeline on ``device``,
    and (on the card) through the sequential loop on the CPU, ``workers``
    processes at a time (identity does not depend on timing); then each
    free-running through the pipeline, and churn10x's through the
    sequential loop too, one process at a time (the latency measurement).
    Every measurement is its own ``trafficgen`` process, as the bench's
    ``_stream_measure``. Fails unless the plan hashes agree pipeline
    against sequential and card against CPU, decisions are monotonic,
    every injected pod is decided in lockstep, and no span is orphaned.
    → per-scenario rows and the wall seconds."""
    t0 = time.perf_counter()

    def args(name, mode, drive, dev):
        return ["--scenario", name, "--mode", mode, "--drive", drive, "--scale", scale, "--pace", pace,
                "--device", dev]

    jobs = {}
    for name in scenarios:
        jobs[(name, "sequential")] = args(name, "sequential", "lockstep", device)
        jobs[(name, "pipeline")] = args(name, "pipeline", "lockstep", device)
        if device != "cpu":
            jobs[(name, "cpu")] = args(name, "sequential", "lockstep", "cpu")
    lock = trafficgen_all(jobs, workers)
    lockstep_s = time.perf_counter() - t0
    free = {}
    for name in scenarios:
        free[(name, "pipeline")] = trafficgen_all({0: args(name, "pipeline", "free", device)}, 1)[0]
        if name == "churn10x":
            free[(name, "sequential")] = trafficgen_all({0: args(name, "sequential", "free", device)}, 1)[0]
    rows = {}
    for name in scenarios:
        seq, pipe, fr = lock[(name, "sequential")], lock[(name, "pipeline")], free[(name, "pipeline")]
        cpu = lock.get((name, "cpu"), seq)
        hashes = {"sequential": seq["plan_sha256"], "pipeline": pipe["plan_sha256"], "cpu": cpu["plan_sha256"]}
        if len(set(hashes.values())) != 1:
            fail(f"config8 {name}: the lockstep plan streams differ: {hashes}")
        for label, run in (("sequential", seq), ("pipeline", pipe), ("free", fr)):
            if not run["monotonic_decision_order"]:
                fail(f"config8 {name} {label}: decisions out of tick order")
        for label, run in (("pipeline", pipe), ("free", fr)):
            if run.get("orphan_spans") != 0:
                fail(f"config8 {name} {label}: {run.get('orphan_spans')} orphaned spans")
        for label, run in (("sequential", seq), ("pipeline", pipe)):
            if run["pods_decided"] != run["pods_injected"] or run["pod_errors"]:
                fail(f"config8 {name} {label}: {run['pods_decided']} of {run['pods_injected']} pods decided, "
                     f"{run['pod_errors']} errors")
        row = {
            "steps": pipe["steps"], "pods_injected": pipe["pods_injected"], "plans_emitted": pipe["plans_emitted"],
            "plan_identical": True, "card_equals_cpu": device != "cpu", "plan_sha256": pipe["plan_sha256"],
            "monotonic_decision_order": True, "prewarm_runs_lockstep": pipe.get("prewarm", {}).get("runs", 0),
            "lockstep_wall_s": {"sequential": seq["wall_s"], "pipeline": pipe["wall_s"]},
            "decision_latency_ms": fr["decision_latency_ms"],
            "steady_decision_latency_ms": fr["steady_decision_latency_ms"], "steady_samples": fr["steady_samples"],
            "pods_decided": fr["pods_decided"], "pod_errors": fr["pod_errors"], "ticks": fr["ticks"],
            "pods_per_sec": fr["pods_per_sec"], "free_wall_s": fr["wall_s"], "queue_stats": fr.get("queues", {}),
            "stage_attribution_ms": fr.get("stage_attribution_ms", {}),
            "flightrec_coverage": fr.get("flightrec", {}).get("coverage"), "orphan_spans": fr.get("orphan_spans"),
            "prewarm_free": {k: fr.get("prewarm", {}).get(k) for k in ("runs", "catalog_prewarms")},
            "process_s": {"sequential": seq["process_s"], "pipeline": pipe["process_s"], "free": fr["process_s"]},
        }
        if (name, "sequential") in free:
            sq = free[(name, "sequential")]
            if not sq["monotonic_decision_order"]:
                fail(f"config8 {name} sequential free: decisions out of tick order")
            row["sequential_steady_decision_latency_ms"] = sq["steady_decision_latency_ms"]
            p99_pipe = row["steady_decision_latency_ms"].get("p99", 0.0)
            p99_seq = sq["steady_decision_latency_ms"].get("p99", 0.0)
            row["steady_p99_ratio_sequential_over_pipeline"] = p99_seq / p99_pipe if p99_pipe > 0 else None
        rows[name] = row
    return {"scenarios": rows, "lockstep_s": lockstep_s, "free_s": time.perf_counter() - t0 - lockstep_s,
            "wall_s": time.perf_counter() - t0}


def run_config14_seed(device: str, seed: int, scale: int = CONFIG14_SCALE, n_types: int = CONFIG14_TYPES,
                      kill_step: int = CONFIG14_KILL) -> dict:
    """16b for one seed, bench config 14 (``bench.py:2325-2458``): the
    kill phase and the unkilled reference side by side, then the warm
    resume (the snapshot restored before the first tick) and the cold
    resume alone, each its own ``trafficgen`` process on ``device``.
    Fails unless both resumes' plan hashes equal the reference's and the
    warm one restored on the device that wrote the snapshot. → the
    seed's row."""
    import tempfile

    t0 = time.perf_counter()
    base = ["--scenario", "restart_wave", "--n-types", n_types, "--device", device]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-restart-") as workdir:
        first = trafficgen_all({
            "kill": base + ["--scale", scale, "--seed", seed, "--restart-kill-at", kill_step, "--workdir", workdir],
            "reference": base + ["--scale", scale, "--seed", seed, "--restart-reference"],
        }, 2)
        kill, ref = first["kill"], first["reference"]
        if not kill.get("snapshot_path"):
            fail(f"config14 seed {seed}: the kill phase wrote no snapshot")
        warm = trafficgen_all({0: base + ["--restart-resume", kill["handoff_path"]]}, 1)[0]
        cold = trafficgen_all({0: base + ["--restart-resume", kill["handoff_path"], "--cold"]}, 1)[0]
    for mode, out in (("warm", warm), ("cold", cold)):
        if out["plan_sha256"] != ref["plan_sha256"]:
            fail(f"config14 seed {seed}: the {mode} resume's plan stream differs from the unkilled reference's")
    if not warm["restored"] or warm["snapshot_device"] != warm["device"]:
        fail(f"config14 seed {seed}: the warm resume did not restore on the snapshot's device: "
             f"{warm['restored']} {warm['snapshot_device']} {warm['device']}")
    ws = warm.get("warmstore") or {}
    row = {"seed": seed, "plan_identity": 1.0, "plans_emitted": ref["plans_emitted"], "kill_step": kill_step,
           "steady_step_ms_p50": kill["steady_step_ms_p50"], "restore_ms": warm["restore_ms"],
           "warmstore": {"restored": ws.get("restored"), "dropped": ws.get("dropped")},
           "prewarm_ms": warm["prewarm_ms"], "prewarm": warm["prewarm"],
           "process_s": {k: v["process_s"] for k, v in (("kill", kill), ("reference", ref), ("warm", warm),
                                                         ("cold", cold))},
           "wall_s": time.perf_counter() - t0}
    for mode, out in (("warm", warm), ("cold", cold)):
        row[mode] = {k: out[k] for k in ("first_solve_ms", "first_solve_host_ms", "first_solve_device_ms",
                                         "ticks_to_warm", "post_restart_step_ms")}
    return row


class launch_roles:
    """Count the launches each kernel makes inside the block by the
    launching thread: the serving pipeline's prewarm thread
    (``serve-prewarm``), or any other (``tick``: the plan thread, the
    sequential loop, the disruption stage). Each kernel's own ``launches``
    still counts them all."""

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.counts = {name: {"tick": 0, "prewarm": 0} for name in kernels}

    def __enter__(self):
        import threading

        lock = threading.Lock()
        for name, kernel in self.kernels.items():
            real = kernel.launch

            def spy(*args, _real=real, _name=name, **kw):
                _real(*args, **kw)
                role = "prewarm" if threading.current_thread().name == "serve-prewarm" else "tick"
                with lock:
                    self.counts[_name][role] += 1

            kernel.launch = spy
        return self

    def __exit__(self, *exc):
        for kernel in self.kernels.values():
            del kernel.launch


def serving_kernels() -> dict:
    from karpenter_core_tpu_torch.disruption import screen_kernels as sk

    return {**all_kernels(), **{f"disrupt_screen.{k}": v for k, v in sk.KERNELS.items()}}


def label_joined_nodes(harness) -> None:
    """Make the harness's kubelet register each joined node with the
    labels its NodeClaim pins (every single-valued ``In`` requirement, the
    pods' ``team`` selector among them), as a node launched from the claim
    carries them; the harness alone labels only instance type, zone,
    capacity type and hostname, so no pod it schedules could land on an
    existing node."""
    real = harness._launch_and_bind

    def launch_and_bind(claim_name, it, zone, ct, pods):
        real(claim_name, it, zone, ct, pods)
        nc = harness.kube.get("NodeClaim", claim_name)
        node = harness.kube.get("Node", f"node-{claim_name}")
        if nc is None or node is None:
            return
        extra = {r.key: r.values[0] for r in nc.spec.requirements
                 if r.operator == "In" and len(r.values) == 1 and r.key not in node.metadata.labels}
        if extra:
            node.metadata.labels.update(extra)
            harness.kube.apply(node)

    harness._launch_and_bind = launch_and_bind


def launch_replacements(harness) -> None:
    """The lifecycle the harness lacks for a disruption stage: launch every
    NodeClaim that has no provider id (a consolidation's replacement) as
    the fake provider creates it (its cheapest compatible offering) and
    join its node, empty, through the harness's kubelet; without it the
    cluster never syncs again and provisioning waits for ever."""
    from karpenter_core_tpu_torch.apis import labels as wk

    for nc in sorted(harness.kube.list("NodeClaim"), key=lambda c: c.metadata.name):
        if nc.status.provider_id or nc.metadata.deletion_timestamp is not None:
            continue
        labels = harness.provider.create(nc).metadata.labels
        it = next(t for t in harness.provider.instance_types if t.name == labels[wk.LABEL_INSTANCE_TYPE])
        harness._launch_and_bind(nc.metadata.name, it, labels[wk.LABEL_TOPOLOGY_ZONE],
                                 labels[wk.CAPACITY_TYPE_LABEL_KEY], [])


def serving_kernel_leg(device: str, mode: str, scale: int, scenario: str = "rollout") -> dict:
    """One 16c leg: bench config 8's ``scenario`` (its default seed) in
    lockstep through ``mode`` (the pipeline, or the sequential loop with the same
    disruption cadence by hand) on ``device``, a ``DisruptionController``
    on the harness's store every ``SERVING_DISRUPT_EVERY`` ticks, the
    world's clocks fixed (``SERVING_CLOCK``, ``SERVING_STEP_S`` a step),
    no parity shadow. → the plan stream, the disruption passes, the
    store's claims and marked nodes, each kernel's launches by role and
    the serving logger's faults."""
    from karpenter_core_tpu_torch.apis.nodepool import Budget
    from karpenter_core_tpu_torch.disruption import DisruptionController
    from karpenter_core_tpu_torch.serving import PipelineConfig, SequentialLoop, ServingPipeline
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    with same_identities():
        sc = tg.build_scenario(scenario, scale=scale)
        h = tg.TrafficHarness(teams=sc.teams, device=device)
        now = [SERVING_CLOCK]
        clock = lambda: now[0]  # noqa: E731
        for part in (h.kube, h.cluster, h.recorder):
            part.clock = clock
        h.provisioner.PARITY_SAMPLE_EVERY = 0
        # tests/helpers.py Env's pool: consolidate when underutilized, at once, budget 100 %
        pool = h.kube.get("NodePool", "default")
        pool.spec.disruption.budgets = [Budget(nodes="100%")]
        pool.spec.disruption.consolidate_after = 0.0
        h.kube.apply(pool)
        ctrl = DisruptionController(h.kube, h.cluster, h.provisioner, h.provider, recorder=h.recorder, clock=clock,
                                    validation_sleep=lambda t: None, metrics=h.metrics)
        disrupt_pass = ctrl.reconcile

        def reconcile():
            executed = disrupt_pass()
            launch_replacements(h)
            return executed

        ctrl.reconcile = reconcile
        label_joined_nodes(h)
        rec = tg._StreamRecorder(h)
        config = PipelineConfig(idle_seconds=0.02, max_seconds=1.0, disrupt_every=SERVING_DISRUPT_EVERY)
        h.warmup()
        passes = []
        t0 = time.perf_counter()
        with tg._ServingFaults() as faults, launch_roles(serving_kernels()) as roles:
            if mode == "pipeline":
                pipe = ServingPipeline(h.provisioner, metrics=h.metrics, config=config, on_decision=rec,
                                       disruption=ctrl)
                h.on_catalog_event = pipe.observe_catalog_event
                pipe.attach_watch()
                pipe.hold()
                pipe.start()
                try:
                    for i, step in enumerate(sc.steps):
                        now[0] += SERVING_STEP_S
                        h.inject_step(step, i)
                        pipe.release()
                        if not pipe.quiesce(timeout=300.0):
                            fail(f"16c {device} pipeline: no quiesce at step {i}")
                        pipe.hold()
                    passes = [(p["tick"], p["executed"]) for p in pipe._disrupt_log]
                    prewarm = pipe.debug_state()["prewarm"]
                finally:
                    pipe.stop()
            else:
                loop = SequentialLoop(h.provisioner, metrics=h.metrics, config=config, on_decision=rec)
                loop.attach_watch()
                prewarm = None
                try:
                    for i, step in enumerate(sc.steps):
                        now[0] += SERVING_STEP_S
                        h.inject_step(step, i)
                        tick = loop.step_once()["tick"]
                        if tick % SERVING_DISRUPT_EVERY == 0:
                            passes.append((tick, ctrl.reconcile()))
                finally:
                    loop.stop()
            _sync(device)
        wall_s = time.perf_counter() - t0
        store = {
            "claims": sorted((nc.metadata.name, nc.metadata.labels.get("node.kubernetes.io/instance-type"),
                              nc.metadata.deletion_timestamp is not None) for nc in h.kube.list("NodeClaim")),
            "marked": sorted(pid for pid, n in h.cluster.nodes.items() if n.marked_for_deletion),
            "taints": sorted((n.metadata.name, sorted((t.key, t.effect) for t in n.spec.taints))
                             for n in h.kube.list("Node") if n.spec.taints),
        }
        h.close()
    return {"stream": rec.stream, "passes": passes, "store": store, "launches": roles.counts,
            "faults": faults.faults, "wall_s": wall_s, "pods": sc.total_creates, "prewarm": prewarm}


def hold_serving_call(kind: str, call, phase: str = "16c") -> None:
    """One captured call against its plain version on the card, bit for
    bit (the wrapper's launch, then the plain PyTorch version)."""
    import torch

    from karpenter_core_tpu_torch.disruption import screen_kernels as sk
    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import pack

    if kind == "compat_allowed":
        catalog = call[1]
        sig = ck.to_planes(call[0].T.contiguous().numpy(), catalog.device)
        same = torch.equal(ck.allowed_via_kernel(sig, catalog),
                           ck.allowed_packed_reference(sig, catalog.planes, catalog.layout))
    elif kind == "ffd_pack":
        req, front, caps, k_open, n = (a.cuda() if hasattr(a, "cuda") else a for a in call)
        ids, counts = pack.ffd_pack_batched(req, front, caps, k_open, n)
        m = int(n.max())
        plain_ids, plain_counts = pack.ffd_pack_reference(req[:, :m], front, caps, k_open)
        plain_ids = torch.nn.functional.pad(plain_ids, (0, req.shape[1] - m), value=-1)
        same = torch.equal(ids, plain_ids) and torch.equal(counts, plain_counts)
    elif kind == "pack_existing":
        args = tuple(a.cuda() for a in call)
        got, want = pack.pack_existing(*args), pack.pack_existing_reference(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        entry = kind.split(".")[1]
        args = tuple(a.cuda() for a in call)
        fn = {"prefix": sk.screen_prefix, "subsets": sk.screen_subsets, "singles": sk.screen_singles}[entry]
        plain = {"prefix": sk.prefix_screen_reference, "subsets": sk.subset_screen_reference,
                 "singles": sk.single_screen_reference}[entry]
        same = torch.equal(fn(*args), plain(*args))
    if not same:
        fail(f"{phase}: a captured {kind} call differs from its plain version")


def hold_and_time(calls: dict, phase: str, screen_path: str = "", sm_mhz: float = 0.0) -> dict:
    """Every captured call of ``calls`` (kind → calls) held to its plain
    version on the card bit for bit, once: the first call of each distinct
    shape through its case function, which holds and times it, the others
    through ``hold_serving_call`` (``hold_dual_call`` for B7). → the cases
    by kernel (B8's entries together under ``disrupt_screen``)."""
    case_fn = {"compat_allowed": compat_call_case, "ffd_pack": ffd_kernel_case,
               "pack_existing": existing_kernel_case, "dual_ascent": dual_kernel_case}
    cases: dict = {}
    for kind, kind_calls in calls.items():
        distinct = (distinct_compat_calls if kind == "compat_allowed" else distinct_shapes)(kind_calls)
        firsts = {id(c) for c in distinct}
        for call in kind_calls:
            if id(call) not in firsts:
                if kind == "dual_ascent":
                    hold_dual_call(call)
                else:
                    hold_serving_call(kind, call, phase)
        if kind.startswith("disrupt_screen"):
            cases.setdefault("disrupt_screen", []).extend(
                screen_kernel_case(kind.split(".")[1], c, screen_path, sm_mhz) for c in distinct)
        else:
            cases[kind] = [case_fn[kind](c) for c in distinct]
    return cases


def run_serving_kernels_phase(device: str = "cuda", scale: int = SERVING_SCALE, sm_mhz: float = 0.0,
                              scenarios=SERVING_SCENARIOS) -> dict:
    """16c, the kernels under serving, ``KARPENTER_TORCH_NATIVE=0`` (the
    device scans): for each scenario, ``serving_kernel_leg`` through the
    pipeline and the sequential loop on ``device`` and through the
    pipeline on the CPU; plan streams, disruption passes and the stores
    equal across the three, no serving-logger fault. ``rollout``'s waves
    empty whole nodes, so every pass deletes empty nodes and reaches no
    screen; ``cascade``'s partial evictions leave underutilized nodes for
    the multi- and single-node consolidations (B8 and the repack bound on
    B6). On the card every compat, FFD, first-fit and B8 call the card
    legs' ticks and prewarm thread make is captured and held against its
    plain version bit for bit, each distinct shape timed (the phase 12,
    14 and 15 cases), and each kernel of the path must have launched.
    → the phase's row."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    legs = {}
    with knobs(KARPENTER_TORCH_NATIVE=0):
        with capture(solver_mod, "allowed_via_kernel") as compat_cap, \
                capture(pack, "ffd_pack_batched") as ffd_cap, capture(pack, "pack_existing") as ex_cap, \
                capture_screens() as screens:
            for name in scenarios:
                for mode in ("pipeline", "sequential"):
                    legs[(name, mode)] = serving_kernel_leg(device, mode, scale, name)
        if device != "cpu":
            for name in scenarios:
                legs[(name, "cpu")] = serving_kernel_leg("cpu", "pipeline", scale, name)
    rows = {}
    for name in scenarios:
        ref = legs[(name, "pipeline")]
        for (leg_name, label), leg in legs.items():
            if leg_name != name:
                continue
            if leg["faults"]:
                fail(f"16c {name} {label}: the serving logger reported {leg['faults'][:5]}")
            for key in ("stream", "passes", "store"):
                if leg[key] != ref[key]:
                    fail(f"16c {name}: the {label} leg's {key} differs from the {device} pipeline's")
        if not ref["stream"]:
            fail(f"16c {name}: the leg emitted no plan")
        rows[name] = {
            "plans": len(ref["stream"]), "pods": ref["pods"], "passes": ref["passes"],
            "claims": len(ref["store"]["claims"]), "marked_nodes": len(ref["store"]["marked"]),
            "launches": {mode: legs[(name, mode)]["launches"] for mode in ("pipeline", "sequential")},
            "wall_s": {label: leg["wall_s"] for (n, label), leg in legs.items() if n == name},
            "prewarm": ref["prewarm"],
        }
    calls = {"compat_allowed": compat_cap.calls, "ffd_pack": ffd_cap.calls, "pack_existing": ex_cap.calls,
             **{f"disrupt_screen.{k}": v for k, v in screens.calls().items()}}
    launches = {mode: {k: {"tick": sum(r["launches"][mode][k]["tick"] for r in rows.values()),
                           "prewarm": sum(r["launches"][mode][k]["prewarm"] for r in rows.values())}
                       for k in serving_kernels()}
                for mode in ("pipeline", "sequential")}
    if not all(calls[k] for k in ("compat_allowed", "ffd_pack", "pack_existing")) or not any(
            calls[k] for k in calls if k.startswith("disrupt_screen")):
        fail(f"16c: a kernel of the path was never called: {({k: len(v) for k, v in calls.items()})}")
    cases = {}
    if device == "cuda":
        totals = {k: sum(n[k]["tick"] + n[k]["prewarm"] for n in launches.values()) for k in serving_kernels()}
        for name in ("compat_allowed", "ffd_pack", "pack_existing"):
            if not totals[name]:
                fail(f"16c: {name} never launched on the serving legs ({totals})")
        if not sum(n for name, n in totals.items() if name.startswith("disrupt_screen")):
            fail(f"16c: no disruption screen launched on the serving legs ({totals})")
        cases = hold_and_time(calls, "16c", "phase16", sm_mhz)
    return {"scenarios": rows, "captured_calls": {k: len(v) for k, v in calls.items()}, "launches": launches,
            "cases": cases}


def run_serving_phase(device: str = "cuda", sizes: Optional[dict] = None, sm_mhz: float = 0.0,
                      budget_s: float = SERVING_BUDGET_S) -> dict:
    """Phase 16 on ``device``: 16c the kernels under serving, 16a bench
    config 8, 16b bench config 14 (the first seed always, the next while
    the phase's projected time stays within ``budget_s``).
    ``sizes``: {"kernels": 16c's scale, "config8": (scale, pace,
    scenarios), "config14": (scale, types, kill step, seeds), or None to
    leave 16b out} → the phase's row."""
    sizes = {"kernels": SERVING_SCALE, "config8": (CONFIG8_SCALE, CONFIG8_PACE, CONFIG8_SCENARIOS),
             "config14": (CONFIG14_SCALE, CONFIG14_TYPES, CONFIG14_KILL, CONFIG14_SEEDS), **(sizes or {})}
    t0 = time.perf_counter()
    kernels = run_serving_kernels_phase(device, sizes["kernels"], sm_mhz)
    kernels_s = time.perf_counter() - t0
    scale, pace, scenarios = sizes["config8"]
    config8 = run_config8_phase(device, scale, pace, scenarios)
    seeds = []
    if sizes["config14"] is not None:
        c14_scale, c14_types, kill_step, c14_seeds = sizes["config14"]
        for seed in c14_seeds:
            elapsed = time.perf_counter() - t0
            if seeds and elapsed + seeds[-1]["wall_s"] > budget_s:
                break
            seeds.append(run_config14_seed(device, seed, c14_scale, c14_types, kill_step))
    return {"kernels": kernels, "kernels_s": kernels_s, "config8": config8, "config14": seeds,
            "config14_seeds": [r["seed"] for r in seeds], "wall_s": time.perf_counter() - t0}


# -- phase 17: the chaos pack ---------------------------------------------------

CONFIG15_SCENARIO = "rollout"  # bench.py config 15 (bench.py:2460-2530): rollout at scale 240, seed 7,
CONFIG15_SCALE = 240  # the five faults and the clean twin, each its own process
CONFIG15_SEED = 7
CONFIG15_FAULTS = ("watch_flap", "watch_hang", "latency_spike", "failover", "clock_skew")
# the faults whose degradation is a held tick, and the hold counter that shows it
CONFIG15_HOLDING = {"watch_flap": "stale", "watch_hang": "stale", "failover": "leader"}
CHAOS_IN_PROCESS = ("none", "failover")  # 17b's faults, native packing off
# the seconds kept for phase 17 out of SCRIPT_BUDGET_S: phase 16, before it
# in its lane, has the rest
CHAOS_RESERVE_S = 60.0


def chaos_row(run: dict) -> dict:
    """The fields of one chaos run that phase 17 checks and prints."""
    steady = run["steady_decision_latency_ms"]
    return {
        "fault": run["fault"], "device": run["device"], "plan_sha256": run["plan_sha256"],
        "plans_emitted": run["plans_emitted"], "pods_decided": run["pods_decided"],
        "pods_injected": run["pods_injected"], "pod_errors": run["pod_errors"], "fault_steps": run["fault_steps"],
        "held_ticks": run["held_ticks"], "stale_plans_emitted": run["stale_plans_emitted"],
        "single_writer_ok": run["single_writer_ok"], "monotonic_decision_order": run["monotonic_decision_order"],
        "steady_p50_ms": steady.get("p50"), "steady_p99_ms": steady.get("p99"), "slo_burn": run["slo_burn"],
        "wall_s": run["wall_s"], "serving_log_faults": run["serving_log_faults"],
    }


def check_chaos_run(label: str, run: dict, clean_sha: str) -> None:
    """Fail unless one chaos run kept config 15's gates: its plan stream
    equal to the clean twin's, every pod decided without error, no plan
    emitted while a guard held, no NodeClaim written while deposed,
    decisions in tick order, the fault scheduled and, for a holding
    fault, a tick held; and no fault of the serving logger."""
    fault = run["fault"]
    if run["plan_sha256"] != clean_sha:
        fail(f"{label} {fault}: the plan stream differs from the clean twin's")
    if run["pods_decided"] != run["pods_injected"] or run["pod_errors"]:
        fail(f"{label} {fault}: {run['pods_decided']} of {run['pods_injected']} pods decided, "
             f"{run['pod_errors']} errors")
    if run["stale_plans_emitted"] != 0:
        fail(f"{label} {fault}: {run['stale_plans_emitted']} plans emitted while a guard held")
    if not run["single_writer_ok"]:
        fail(f"{label} {fault}: a NodeClaim was written while deposed")
    if not run["monotonic_decision_order"]:
        fail(f"{label} {fault}: decisions out of tick order")
    if fault != "none" and not run["fault_steps"]:
        fail(f"{label} {fault}: no step ran inside the fault window")
    counter = CONFIG15_HOLDING.get(fault)
    if counter is not None and run["held_ticks"].get(counter, 0) < 1:
        fail(f"{label} {fault}: no tick held ({run['held_ticks']})")
    if run["serving_log_faults"]:
        fail(f"{label} {fault}: the serving logger reported {run['serving_log_faults'][:5]}")


def run_config15_phase(device: str = "cuda", scale: int = CONFIG15_SCALE, seed: int = CONFIG15_SEED,
                       faults=CONFIG15_FAULTS, workers: int = 4) -> dict:
    """17a, bench config 15 whole (``bench.py:2460-2530``): ``rollout`` at
    ``scale``, ``seed``, in lockstep through the pipeline on ``device``
    under each fault and clean (``--chaos none``), and (on the card) clean
    on the CPU, each its own ``trafficgen`` process, ``workers`` at a time
    (plan identity does not depend on timing). Fails unless every run
    keeps ``check_chaos_run``'s gates against the clean twin and the card's
    clean twin equals the CPU's. → the runs' rows and the wall seconds."""
    t0 = time.perf_counter()
    base = ["--scenario", CONFIG15_SCENARIO, "--scale", scale, "--seed", seed]
    jobs = {fault: base + ["--chaos", fault, "--device", device] for fault in ("none", *faults)}
    if device != "cpu":
        jobs["cpu"] = base + ["--chaos", "none", "--device", "cpu"]
    runs = trafficgen_all(jobs, workers, phase="17a")
    clean = runs["none"]["plan_sha256"]
    rows = {}
    for key, run in runs.items():
        check_chaos_run("17a", run, clean)
        rows[key] = {**chaos_row(run), "process_s": run["process_s"]}
    return {"runs": rows, "clean_sha256": clean, "card_equals_cpu": device != "cpu",
            "wall_s": time.perf_counter() - t0}


class labeled_harness:
    """Inside the block, every ``TrafficHarness`` registers its joined
    nodes with the labels their NodeClaims pin (``label_joined_nodes``),
    so later ticks place pods on existing nodes (the first-fit); the
    harness alone labels none the pods select."""

    def __enter__(self):
        from karpenter_core_tpu_torch.serving import trafficgen as tg

        self.real = real = tg.TrafficHarness

        def harness(*args, **kwargs):
            h = real(*args, **kwargs)
            label_joined_nodes(h)
            return h

        tg.TrafficHarness = harness
        return self

    def __exit__(self, *exc):
        from karpenter_core_tpu_torch.serving import trafficgen as tg

        tg.TrafficHarness = self.real


def chaos_kernel_run(device: str, fault: str, scale: int, seed: int, labeled: bool) -> dict:
    """One in-process ``run_chaos`` of config 15 on ``device`` (the
    joined nodes labeled where ``labeled``, identities restarted) → its
    row, each kernel's launches by role and the serving logger's
    faults."""
    from karpenter_core_tpu_torch.serving import trafficgen as tg

    with same_identities(), labeled_harness() if labeled else contextlib.nullcontext(), \
            tg._ServingFaults() as faults, launch_roles(all_kernels()) as roles:
        run = tg.run_chaos(CONFIG15_SCENARIO, fault, scale=scale, seed=seed, device=device)
        _sync(device)
    run["serving_log_faults"] = faults.faults
    return {**chaos_row(run), "launches": roles.counts}


def run_chaos_kernels_phase(device: str = "cuda", scale: int = CONFIG15_SCALE, seed: int = CONFIG15_SEED,
                            clean_sha: Optional[str] = None, faults=CHAOS_IN_PROCESS) -> dict:
    """17b, the kernels under chaos, ``KARPENTER_TORCH_NATIVE=0`` (the
    device scans): ``run_chaos`` in this process on ``device`` for each
    of ``faults``, in config 15's world and in the same world with its
    joined nodes labeled (``labeled_harness``: config 15's pods select a
    team label the harness's nodes lack, so only then does a tick reach
    the existing-node first-fit), and the labeled world clean on the CPU.
    Fails unless every run keeps ``check_chaos_run``'s gates: config 15's
    world against ``clean_sha`` (17a's clean twin; None: this phase's
    own clean run), the labeled world against its own clean run. On the
    card every compat, FFD and first-fit call is captured and held
    against its plain version bit for bit, each distinct shape timed, and
    under the faults compat, the FFD scan and the first-fit must each
    have launched. → the phase's row."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    t0 = time.perf_counter()
    runs = {}
    with knobs(KARPENTER_TORCH_NATIVE=0):
        with capture(solver_mod, "allowed_via_kernel") as compat_cap, \
                capture(pack, "ffd_pack_batched") as ffd_cap, capture(pack, "pack_existing") as ex_cap:
            for world, labeled in (("config15", False), ("labeled", True)):
                for fault in faults:
                    runs[(world, fault)] = chaos_kernel_run(device, fault, scale, seed, labeled)
        if device != "cpu":
            runs[("labeled", "cpu")] = chaos_kernel_run("cpu", "none", scale, seed, True)
    clean = {"config15": clean_sha or runs[("config15", "none")]["plan_sha256"],
             "labeled": runs[("labeled", "none")]["plan_sha256"]}
    for (world, fault), run in runs.items():
        check_chaos_run(f"17b {world}", run, clean[world])
    calls = {"compat_allowed": compat_cap.calls, "ffd_pack": ffd_cap.calls, "pack_existing": ex_cap.calls}
    if not all(calls.values()):
        fail(f"17b: a kernel of the path was never called: {({k: len(v) for k, v in calls.items()})}")
    launches = {f"{world}-{fault}": {name: n["tick"] + n["prewarm"] for name, n in run["launches"].items()}
                for (world, fault), run in runs.items()}
    cases = {}
    if device == "cuda":
        faulted = {name: sum(launches[f"{world}-{fault}"][name] for world in ("config15", "labeled")
                             for fault in faults if fault != "none")
                   for name in ("compat_allowed", "ffd_pack", "pack_existing")}
        missing = [name for name, n in faulted.items() if not n]
        if missing:
            fail(f"17b: {missing} never launched under {[f for f in faults if f != 'none']} ({launches})")
        cases = hold_and_time(calls, "17b")
    return {"runs": {f"{world}-{fault}": {k: v for k, v in run.items() if k != "launches"}
                     for (world, fault), run in runs.items()},
            "clean_sha256": clean, "launches": launches, "roles": {f"{world}-{fault}": run["launches"]
                                                                    for (world, fault), run in runs.items()},
            "captured_calls": {k: len(v) for k, v in calls.items()}, "cases": cases,
            "wall_s": time.perf_counter() - t0}


def run_chaos_phase(device: str = "cuda", scale: int = CONFIG15_SCALE, seed: int = CONFIG15_SEED,
                    faults=CONFIG15_FAULTS, workers: int = 4) -> dict:
    """Phase 17 on ``device``: 17a bench config 15 in ``trafficgen``
    processes, then 17b the kernels under chaos in this process, held to
    17a's clean twin. Never cut short. → the phase's row."""
    t0 = time.perf_counter()
    config15 = run_config15_phase(device, scale, seed, faults, workers)
    kernels = run_chaos_kernels_phase(device, scale, seed, config15["clean_sha256"])
    return {"config15": config15, "kernels": kernels, "wall_s": time.perf_counter() - t0}


def report_chaos_phase(chaos: dict, card: str) -> None:
    """Print phase 17's lines: one per 17a run and per 17b run, 17b's
    kernel cases, and the phase's summary, each with the card."""
    for key, row in chaos["config15"]["runs"].items():
        emit({"phase17_config15": key, **row, "card": card})
    ck17 = chaos["kernels"]
    for key, row in ck17["runs"].items():
        emit({"phase17_kernels": key, **row, "launches_by_role": ck17["roles"][key], "card": card})
    for name, rows in ck17["cases"].items():
        for r in rows:
            emit({"phase17_kernel_case": name, **r, "card": card})
    emit({"phase17": "chaos-config15", "clean_sha256": chaos["config15"]["clean_sha256"],
          "card_equals_cpu": chaos["config15"]["card_equals_cpu"], "config15_s": chaos["config15"]["wall_s"],
          "kernels_s": ck17["wall_s"], "captured_calls": ck17["captured_calls"], "launches": ck17["launches"],
          "wall_s": chaos["wall_s"], "card": card})


# -- phase 18: the operator -------------------------------------------------------

PORT_PACKAGE = "karpenter_core_tpu_torch"
# the stepped clock of 18a starts at the wall clock's second and moves
# this far each pass (and consolidation's validation wait, 15 s, when a
# command is validated): past the nomination window (20 s) and the GC
# grace (10 s). Objects and conditions are stamped with the wall clock
# while the TTLs read the stepped one (ROADMAP C13), so the whole run
# stays less than the registration TTL (15 min) ahead of the wall clock's
# start: a claim is never collected as unregistered in the pass that
# creates it. Each stage's cap bounds the run's steps
OPERATOR_STEP_S = 21.0
OPERATOR_PASS_CAP = 6  # a stage's passes: until one changes nothing in the store, at most this many
OPERATOR_SCALE_DOWN = 0.6  # 18a's scale-down: this share of the pods deleted, seeded
OPERATOR_GPU_TYPES = 20  # bench config 2's GPU types (fake-gpu-0 .. 19)
OPERATOR_GPU_TAINT = ("nvidia.com/gpu", "true", "NoSchedule")  # the gpu pool's taint, which GPU pods tolerate
OPERATOR_STARTUP_TAINT = ("example.com/gpu-driver", "installing", "NoSchedule")  # removed once registered
OPERATOR_CONTROLLERS = 14
OPERATOR_METRIC_PREFIXES = ("karpenter_nodeclaims_", "karpenter_nodes_", "karpenter_pods_", "karpenter_disruption_")
OPERATOR_SERVED_SCALE = 400  # 18b: bench config 8's rollout at its scale
# phase 18's share of SCRIPT_BUDGET_S, kept out of the budgets of the phases
# before it in its lane
OPERATOR_RESERVE_S = 150.0


def port_module(name: str):
    """``name`` of the port's package (``kube.client``, ...)."""
    import importlib

    return importlib.import_module(f"{PORT_PACKAGE}.{name}")


class operator_identities(same_identities):
    """``same_identities``, with uids whose first 16 hex digits differ too:
    the fake provider names instances by ``uuid4().hex[:16]``, which the
    plain counter leaves at zeros."""

    def __enter__(self):
        import itertools
        import uuid

        super().__enter__()
        ids = itertools.count(1)
        uuid.uuid4 = lambda: (lambda n: uuid.UUID(int=(n << 64) | n))(next(ids))
        return self


def operator_metric_samples(text: str, prefixes=OPERATOR_METRIC_PREFIXES) -> list:
    """The samples of an exposition whose family starts with one of
    ``prefixes``, as (name with labels, value); histograms by their
    ``_count`` samples only (durations are the wall clock's)."""
    histograms = {line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE ") and line.split()[3] == "histogram"}
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample, value = line.rsplit(" ", 1)
        name = sample.split("{", 1)[0]
        if not name.startswith(prefixes):
            continue
        family = next((h for h in histograms if name.startswith(h + "_")), None)
        if family is not None and name != family + "_count":
            continue
        out.append((sample, float(value)))
    return sorted(out)


def store_state(kube, recorder, metrics_text: str) -> dict:
    """A store by content: claims (conditions, labels, requirements,
    taints, finalizers, provider ids), nodes (labels, taints, finalizers),
    pod bindings, leases, the recorder's events in order and the metric
    samples of ``OPERATOR_METRIC_PREFIXES`` in ``metrics_text``. Time
    stamps are left out; the classes are read by field, so any package's
    store reads alike."""

    def meta(o):
        return (o.metadata.name, sorted(o.metadata.labels.items()), sorted(o.metadata.finalizers),
                o.metadata.deletion_timestamp is not None)

    def taints(ts):
        return sorted((t.key, t.value, t.effect) for t in ts)

    return {
        "claims": sorted(
            (*meta(c), sorted((x.type, x.status, x.reason, x.message) for x in c.status.conditions),
             c.status.provider_id, c.status.node_name,
             sorted((r.key, r.operator, tuple(r.values)) for r in c.spec.requirements),
             taints(list(c.spec.taints) + list(c.spec.startup_taints)))
            for c in kube.list("NodeClaim")),
        "nodes": sorted((*meta(n), n.spec.provider_id, taints(n.spec.taints)) for n in kube.list("Node")),
        "pods": sorted((p.namespace, p.metadata.name, p.spec.node_name, p.status.phase,
                        p.metadata.deletion_timestamp is not None) for p in kube.list("Pod")),
        "leases": sorted((l.namespace, l.metadata.name) for l in kube.list("Lease")),
        "events": [(e.type, e.reason, e.message, type(e.involved_object).__name__,
                    getattr(e.involved_object, "name", "")) for e in recorder.events],
        "metrics": operator_metric_samples(metrics_text),
    }


class OperatorKubelet:
    """18a's kubelet and ReplicaSet, the script's own: after each pass it
    joins a Ready node (and its node lease) for every launched claim that
    has none, removes a claim's startup taints from its node once the node
    is registered, binds each pending pod to the node of its latest
    nomination (a claim's node once joined, Ready and free of taints the
    pod does not tolerate, or an existing node that still stands), and
    recreates every evicted pod, pending, under a new name."""

    def __init__(self, world):
        self.w = world
        self.seen = 0  # events read so far (the recorder's ring never rolls over here)
        self.nominated: dict = {}
        self.recreated = 0
        self.bound = 0

    def sync(self) -> None:
        w = self.w
        kube, wk, ob = w.kube, w.wk, w.ob
        claims = sorted(kube.list("NodeClaim"), key=lambda c: c.metadata.name)
        nodes_by_pid = {n.spec.provider_id: n for n in kube.list("Node") if n.spec.provider_id}
        for nc in claims:
            pid = nc.status.provider_id
            if nc.metadata.deletion_timestamp is not None or not pid or pid in nodes_by_pid:
                continue
            if not nc.status_condition_is_true(w.nc_mod.COND_LAUNCHED):
                continue
            node = ob.Node()
            node.metadata.name = f"node-{nc.metadata.name}"
            node.metadata.labels = {**nc.metadata.labels, wk.LABEL_HOSTNAME: node.metadata.name}
            node.spec.provider_id = pid
            node.spec.taints = [ob.Taint(key=t.key, value=t.value, effect=t.effect)
                                for t in list(nc.spec.taints) + list(nc.spec.startup_taints)]
            node.status.capacity = dict(nc.status.capacity)
            node.status.allocatable = dict(nc.status.allocatable)
            node.status.conditions = [ob.Condition(type="Ready", status="True")]
            kube.create(node)
            lease = ob.Lease()
            lease.metadata.name = node.metadata.name
            lease.metadata.namespace = "kube-node-lease"
            lease.metadata.owner_references = [ob.OwnerReference(kind="Node", name=node.metadata.name)]
            kube.create(lease)
            nodes_by_pid[pid] = node
        for nc in claims:
            node = nodes_by_pid.get(nc.status.provider_id)
            if node is None or not nc.spec.startup_taints:
                continue
            if node.metadata.labels.get(wk.NODE_REGISTERED_LABEL_KEY) != "true":
                continue
            keep = [t for t in node.spec.taints if not any(t.match(s) for s in nc.spec.startup_taints)]
            if len(keep) != len(node.spec.taints):
                node.spec.taints = keep
                kube.apply(node)
        events = w.op.recorder.events
        evicted = []
        for e in events[self.seen:]:
            if e.reason == "Nominated":
                self.nominated[(e.involved_object.namespace, e.involved_object.name)] = e.message.split(": ", 1)[1]
            elif e.reason == "Evicted":
                evicted.append(e.involved_object)
        self.seen = len(events)
        claim_nodes = {nc.metadata.name: nodes_by_pid.get(nc.status.provider_id) for nc in claims}
        nodes = {n.metadata.name: n for n in kube.list("Node")}
        taints_mod = w.imp("scheduling.taints")
        for pod in sorted(kube.list("Pod"), key=lambda p: (p.namespace, p.name)):
            if pod.spec.node_name or pod.metadata.deletion_timestamp is not None:
                continue
            target = self.nominated.get((pod.namespace, pod.name))
            node = nodes.get(target) or claim_nodes.get(target)
            if node is None or node.metadata.deletion_timestamp is not None:
                continue
            if not any(c.type == "Ready" and c.status == "True" for c in node.status.conditions):
                continue
            if taints_mod.Taints(node.spec.taints).tolerates(pod) is not None:
                continue
            pod.spec.node_name = node.metadata.name
            pod.status.phase = "Running"
            pod.status.conditions = []
            kube.apply(pod)
            self.bound += 1
        for pod in evicted:
            self.recreated += 1
            stem = pod.metadata.name.split("-r", 1)[0]
            w.create_pod(f"{stem}-r{self.recreated}", pod.spec, dict(pod.metadata.labels))


class OperatorWorld:
    """Bench config 2 whole (``bench.py:421-466``: ``instance_types(480)``
    plus its 20 GPU types, ``n_pods`` pods of RandomState(``seed``) sizes,
    one in ten asking one GPU) under one ``Operator`` on ``device``, its
    clock stepped ``OPERATOR_STEP_S`` a pass from the wall clock's second
    at the start, admission on, election off, the parity shadow off. Two
    pools: ``default`` (WhenUnderutilized, no GPU type) and ``gpu`` (the
    GPU types, weight 10, a taint the GPU pods tolerate and a startup
    taint the kubelet removes); one PDB over every tenth pod (``maxUnavailable``:
    a twentieth of them). ``imp`` resolves the package's modules and
    ``make_operator(provider, kube, options, clock, validation_sleep)``
    builds the operator (None: the port's on ``device``), so the same
    world runs on another package."""

    def __init__(self, device, n_pods: int = N_CONFIG2, n_types: int = 480, seed: int = CONFIG2_SEED,
                 imp=port_module, make_operator=None, keep_states: bool = True):
        self.imp = imp
        self.keep_states = keep_states
        wk, ob = imp("apis.labels"), imp("kube.objects")
        self.wk, self.ob, self.nc_mod = wk, ob, imp("apis.nodeclaim")
        q = imp("kube.quantity").parse_quantity
        fake, npm, opm = imp("cloudprovider.fake"), imp("apis.nodepool"), imp("operator")
        rng = np.random.RandomState(seed)
        provider = self.provider = fake.FakeCloudProvider()
        catalog = fake.instance_types(n_types)
        gpu_names = [f"fake-gpu-{g}" for g in range(OPERATOR_GPU_TYPES)]
        for g, name in enumerate(gpu_names):
            catalog.append(fake.new_instance_type(name, {
                "cpu": str(8 * (g + 1)), "memory": f"{16 * (g + 1)}Gi", "pods": "110",
                "nvidia.com/gpu": str(min(8, g + 1))}))
        provider.instance_types = catalog
        provider.drifted = ""  # drift comes from the pools alone
        self.start = float(int(time.time()))
        self.now = [self.start]
        clock = lambda: self.now[0]  # noqa: E731
        self.kube = imp("kube.client").KubeClient(clock=clock)
        options = opm.Options(enable_leader_election=False, metrics_port=0, health_probe_port=0,
                              use_tpu_solver=True)
        if make_operator is None:
            self.op = opm.Operator(provider, kube_client=self.kube, options=options, clock=clock, device=device,
                                   validation_sleep=self.advance)
        else:
            self.op = make_operator(provider, self.kube, options, clock, self.advance)
        self.op.recorder.capacity = 1 << 40
        self.op.provisioner.PARITY_SAMPLE_EVERY = 0
        default = npm.NodePool()
        default.metadata.name = "default"
        default.spec.template.requirements = [ob.NodeSelectorRequirement(wk.LABEL_INSTANCE_TYPE, "NotIn", gpu_names)]
        gpu = npm.NodePool()
        gpu.metadata.name = "gpu"
        gpu.spec.template.requirements = [ob.NodeSelectorRequirement(wk.LABEL_INSTANCE_TYPE, "In", gpu_names)]
        gpu.spec.template.taints = [ob.Taint(*OPERATOR_GPU_TAINT)]
        gpu.spec.template.startup_taints = [ob.Taint(*OPERATOR_STARTUP_TAINT)]
        gpu.spec.weight = 10  # tried first: the pods that do not tolerate its taint go on to default
        for pool in (default, gpu):
            self.kube.create(pool)
        self.guarded = 0
        for i in range(n_pods):
            cpu = ["100m", "250m", "500m", "1", "2", "4"][rng.randint(6)]
            mem = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi"][rng.randint(5)]
            spec = ob.PodSpec(containers=[ob.Container(name="main", resources=ob.ResourceRequirements(
                requests={"cpu": q(cpu), "memory": q(mem)}))])
            if rng.rand() < 0.1:
                spec.containers[0].resources.requests["nvidia.com/gpu"] = q("1")
                spec.tolerations = [ob.Toleration(key=OPERATOR_GPU_TAINT[0], operator="Exists")]
            labels = {"app": "guarded" if i % 10 == 0 else "bench"}
            self.guarded += i % 10 == 0
            self.create_pod(f"bench-{i}", spec, labels)
        self.pdb = ob.PodDisruptionBudget(selector=ob.LabelSelector(match_labels={"app": "guarded"}),
                                          max_unavailable=max(1, self.guarded // 20))
        self.pdb.metadata.name = "guarded"
        self.pdb.metadata.namespace = "default"
        self.kube.create(self.pdb)
        self.kubelet = OperatorKubelet(self)
        self.passes: list = []  # per pass: stage, wall ms, the store's digest (and state, if kept)
        self.last_state: Optional[dict] = None
        # the PDB's ledger: guarded pods seen, deleted by the scale-down,
        # evicted (admitted, refused, admitted with no budget left)
        self.guarded_seen = {p.metadata.name for p in self.kube.list("Pod")
                             if p.metadata.labels.get("app") == "guarded"}
        self.scaled_names: set = set()
        self.pdb_ledger = {"admitted": 0, "refused": 0, "over_budget": 0, "unexplained": []}
        self.evicted_names: set = set()
        queue = self.op.eviction_queue
        evict = queue.evict
        allowed = imp("lifecycle.node_termination").pdb_disruptions_allowed

        def guarded_evict(pod):
            guarded = pod.metadata.labels.get("app") == "guarded"
            before = allowed(self.kube, self.pdb) if guarded else None
            admitted = evict(pod)
            if guarded:
                self.pdb_ledger["admitted" if admitted else "refused"] += 1
                self.pdb_ledger["over_budget"] += admitted and before <= 0
            if admitted:
                self.evicted_names.add(pod.metadata.name)
            return admitted

        queue.evict = guarded_evict

    def advance(self, seconds: float) -> None:
        """Consolidation's validation wait: the clock moves, nothing sleeps."""
        self.now[0] += seconds

    def create_pod(self, name: str, spec, labels: dict) -> None:
        ob = self.ob
        pod = ob.Pod()
        pod.metadata.name = name
        pod.metadata.namespace = "default"
        pod.metadata.labels = labels
        pod.spec = copy.deepcopy(spec)
        pod.spec.node_name = ""
        pod.status.phase = "Pending"
        pod.status.conditions = [ob.PodCondition(type="PodScheduled", status="False", reason="Unschedulable")]
        self.kube.create(pod)

    def state(self) -> dict:
        return store_state(self.kube, self.op.recorder, self.op.metrics_text())

    def check_pdb(self) -> None:
        """The PDB's ledger after a pass: every guarded pod that went was
        deleted by the scale-down or evicted through the queue, and no
        eviction was admitted with no disruption left in the budget."""
        now = {p.metadata.name for p in self.kube.list("Pod") if p.metadata.labels.get("app") == "guarded"}
        gone = self.guarded_seen - now - self.scaled_names - self.evicted_names
        self.pdb_ledger["unexplained"] += sorted(gone)
        self.guarded_seen = now

    def one_pass(self, stage: str) -> dict:
        """``reconcile_all_once``, the kubelet, the clock's step → the
        store's state after it (recorded with its wall ms)."""
        t0 = time.perf_counter()
        self.op.reconcile_all_once()
        self.kubelet.sync()
        wall_ms = (time.perf_counter() - t0) * 1000.0
        self.now[0] += OPERATOR_STEP_S
        self.check_pdb()
        state = self.last_state = self.state()
        self.passes.append({"stage": stage, "wall_ms": wall_ms, "digest": state_digest(state),
                            "state": state if self.keep_states else None})
        return state

    def settle(self, stage: str, cap: int = OPERATOR_PASS_CAP, least: int = 1) -> int:
        """Passes until one leaves claims, nodes and pods as they were (at
        least ``least``, at most ``cap``) → the passes run."""
        before = None
        for k in range(cap):
            state = self.one_pass(stage)
            now = (state["claims"], state["nodes"], state["pods"])
            if k + 1 >= least and now == before:
                return k + 1
            before = now
        return cap

    def drift_pool(self) -> str:
        """Drift the ``gpu`` pool's template: exclude the GPU type that the
        fewest of its live claims run (at least one), so those claims drift
        on their requirements. → the excluded type."""
        wk, ob = self.wk, self.ob
        counts: dict = {}
        for nc in self.kube.list("NodeClaim"):
            if nc.metadata.labels.get(wk.NODEPOOL_LABEL_KEY) == "gpu" and nc.metadata.deletion_timestamp is None:
                it = nc.metadata.labels.get(wk.LABEL_INSTANCE_TYPE)
                if it:
                    counts[it] = counts.get(it, 0) + 1
        if not counts:
            fail("18a: the gpu pool launched no claim to drift")
        excluded = min(sorted(counts), key=lambda it: counts[it])
        pool = self.kube.get("NodePool", "gpu")
        pool.spec.template.requirements = list(pool.spec.template.requirements) + [
            ob.NodeSelectorRequirement(wk.LABEL_INSTANCE_TYPE, "NotIn", [excluded])]
        self.kube.update(pool)
        return excluded

    def scale_down(self, seed: int) -> int:
        """Delete ``OPERATOR_SCALE_DOWN`` of the pods, chosen by
        RandomState(``seed``) → how many."""
        pods = sorted(self.kube.list("Pod"), key=lambda p: (p.namespace, p.metadata.name))
        rng = np.random.RandomState(seed)
        gone = rng.choice(len(pods), int(len(pods) * OPERATOR_SCALE_DOWN), replace=False)
        for i in sorted(gone):
            self.scaled_names.add(pods[i].metadata.name)
            self.kube.delete(pods[i])
        return len(gone)

    def drop_instance(self) -> str:
        """Drop the instance of the first initialized claim from the
        provider behind the store's back → its provider id."""
        for nc in sorted(self.kube.list("NodeClaim"), key=lambda c: c.metadata.name):
            if nc.metadata.deletion_timestamp is None and nc.status_condition_is_true(self.nc_mod.COND_INITIALIZED):
                del self.provider.created_node_claims[nc.status.provider_id]
                return nc.status.provider_id
        fail("18a: no initialized claim to drop")

    def freeze_disruption(self) -> None:
        """Every pool's disruption budget to zero nodes: what is in flight
        finishes, nothing new is disrupted."""
        budget = self.imp("apis.nodepool").Budget
        for pool in sorted(self.kube.list("NodePool"), key=lambda p: p.metadata.name):
            pool.spec.disruption.budgets = [budget(nodes="0")]
            self.kube.update(pool)

    def orphan_lease(self) -> None:
        lease = self.ob.Lease()
        lease.metadata.name = "orphaned-node-lease"
        lease.metadata.namespace = "kube-node-lease"
        self.kube.create(lease)


def run_operator_world(device, n_pods: int = N_CONFIG2, n_types: int = 480, seed: int = CONFIG2_SEED,
                       imp=port_module, make_operator=None, cap: int = OPERATOR_PASS_CAP,
                       keep_states: bool = True) -> "OperatorWorld":
    """18a's sequence on one world: provision (the compat kernel), launch
    through the ``MetricsDecorator``, join, register and initialize; drift
    the gpu pool (replacement); scale down by ``OPERATOR_SCALE_DOWN`` and
    consolidate (B8's screens, replacements); terminate (taint, drain
    through the ``EvictionQueue`` under the PDB, delete; evicted pods
    pending again and placed on nodes that still stand); drop an instance
    (garbage collection); consistency and lease GC; then every pool's
    budget to zero and the last evicted pods placed. Each stage's passes
    run until one changes nothing, at most ``cap``. → the world."""
    with operator_identities():
        w = OperatorWorld(device, n_pods, n_types, seed, imp, make_operator, keep_states)
        stages = {}
        stages["provision"] = w.settle("provision", cap, least=3)
        launched = len(w.kube.list("NodeClaim"))
        w.excluded = w.drift_pool()
        stages["drift"] = w.settle("drift", cap, least=2)
        w.scaled_down = w.scale_down(seed + 1)
        stages["consolidate"] = w.settle("consolidate", cap + 2, least=2)
        w.dropped = w.drop_instance()
        stages["gc"] = w.settle("gc", cap - 2, least=2)
        w.orphan_lease()
        stages["lease_gc"] = w.settle("lease_gc", 2, least=1)
        # the end: disruption frozen, the evicted pods placed and bound
        w.freeze_disruption()
        stages["settle"] = w.settle("settle", cap, least=2)
        w.op.stop()
    w.stages, w.launched_first = stages, launched
    return w


def state_digest(state: dict) -> dict:
    """A digest of each part of a store's state."""
    return {k: hashlib.sha256(repr(v).encode()).hexdigest()[:16] for k, v in state.items()}


def operator_stream_digest(passes: list) -> list:
    """Per pass: the stage and the digest of each part of the state."""
    return [(p["stage"], p["digest"]) for p in passes]


def check_operator_world(w, label: str) -> dict:
    """18a's gates on one run: every pod bound exactly once to a node that
    stands, no node over its allocatable, the PDB never breached, every
    controller reconciled with no error, ``/metrics`` well formed, the
    drift, consolidation, termination, GC and lease GC happened. → the
    run's counts."""
    resources = w.imp("scheduling.resources")
    textcheck = w.imp("metrics").check_exposition
    kube, wk = w.kube, w.wk
    nodes = {n.metadata.name: n for n in kube.list("Node") if n.metadata.deletion_timestamp is None}
    used: dict = {}
    unbound = [p.metadata.name for p in kube.list("Pod") if p.spec.node_name not in nodes]
    if unbound:
        fail(f"18a {label}: {len(unbound)} pods end unbound or on a gone node, {unbound[:3]}, "
             f"after stages {w.stages}")
    for pod in kube.list("Pod"):
        used[pod.spec.node_name] = resources.merge(used.get(pod.spec.node_name, {}),
                                                   resources.requests_for_pods(pod))
    for name, req in used.items():
        if not resources.fits(req, nodes[name].status.allocatable):
            fail(f"18a {label}: node {name} is over its allocatable")
    if w.pdb_ledger["over_budget"] or w.pdb_ledger["unexplained"]:
        fail(f"18a {label}: the PDB was breached: {w.pdb_ledger}")
    ttl = w.imp("lifecycle.nodeclaim_lifecycle").REGISTRATION_TTL
    if w.now[0] - w.start >= ttl:
        fail(f"18a {label}: the stepped clock ran {w.now[0] - w.start} s ahead, past the registration TTL")
    m = w.op.metrics
    errors = {dict(k).get("controller"): v for k, v in m.reconcile_errors.values.items() if v}
    if errors:
        fail(f"18a {label}: reconcile errors {errors}")
    per_controller = {dict(k)["controller"]: (m.reconcile_duration.totals[k], m.reconcile_duration.sums[k] * 1000.0)
                      for k in m.reconcile_duration.totals}
    if len(per_controller) != OPERATOR_CONTROLLERS or any(n != len(w.passes) for n, _ in per_controller.values()):
        fail(f"18a {label}: not every controller reconciled every pass: "
             f"{ {c: n for c, (n, _) in per_controller.items()} } over {len(w.passes)} passes")
    problems = textcheck(w.op.metrics_text())
    if problems:
        fail(f"18a {label}: /metrics is malformed: {problems[:3]}")
    reasons = [e.reason for e in w.op.recorder.events]
    terminated = {dict(k).get("reason"): v for k, v in m.nodeclaims_terminated.values.items()}
    counts = {
        "passes": len(w.passes), "stages": w.stages, "clock_s": w.now[0] - w.start,
        "pods_end": len(kube.list("Pod")),
        "claims_launched": int(sum(m.nodeclaims_launched.values.values())),
        "claims_after_provision": w.launched_first,
        "drift_commands": int(sum(v for k, v in m.nodeclaims_disrupted.values.items()
                                  if dict(k).get("method") == "drift")),
        "consolidation_commands": int(sum(v for k, v in m.nodeclaims_disrupted.values.items()
                                          if dict(k).get("method") == "consolidation")),
        "claims_consolidated": int(sum(int(dict(k).get("count", 1)) * v for k, v in m.nodeclaims_disrupted.values.items()
                                       if dict(k).get("method") == "consolidation")),
        "claims_terminated": terminated, "nodes_terminated": int(sum(m.nodes_terminated.values.values())),
        "pods_bound": w.kubelet.bound, "pods_evicted": reasons.count("Evicted"), "pods_recreated": w.kubelet.recreated,
        "scaled_down": w.scaled_down, "excluded_type": w.excluded,
        "pdb": {k: v for k, v in w.pdb_ledger.items() if k != "unexplained"},
        "pdb_max_unavailable": w.pdb.max_unavailable,
        "pass_wall_ms": [round(p["wall_ms"], 3) for p in w.passes],
        "controller_ms": {c: round(ms, 3) for c, (_, ms) in sorted(per_controller.items())},
    }
    if not counts["drift_commands"]:
        fail(f"18a {label}: no claim was replaced for drift ({counts})")
    if not counts["consolidation_commands"]:
        fail(f"18a {label}: no claim was consolidated ({counts})")
    if not counts["pods_evicted"] or not counts["nodes_terminated"]:
        fail(f"18a {label}: no drain evicted a pod or deleted a node ({counts})")
    if not terminated.get("deleted"):
        fail(f"18a {label}: no NodeClaim terminated ({counts})")
    if any(name == "orphaned-node-lease" for _, name in w.last_state["leases"]):
        fail(f"18a {label}: the orphaned node lease was not collected")
    if any(nc.status.provider_id == w.dropped for nc in kube.list("NodeClaim")):
        fail(f"18a {label}: the claim whose instance was dropped was not collected")
    return counts


def _http_get(port: int, path: str) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _until(predicate, timeout: float, step: float = 0.05) -> bool:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return predicate()


OPERATOR_ROUTES = ("/debug/decisions", "/debug/decisions/last", "/debug/solve/stats", "/debug/traces/last",
                   "/debug/serving")


def run_operator_served(device: str = "cuda", scale: int = OPERATOR_SERVED_SCALE) -> dict:
    """18b: ``Operator(...).start()`` on ``device`` with leader election,
    ephemeral ports and the serving pipeline, in bench config 8's
    ``rollout`` world at ``scale`` (its harness's store, catalog and pool);
    a second operator on the same store. Gates: the first leads and the
    second follows; after the first decision ``/healthz`` and ``/readyz``
    give 200, ``/metrics`` passes ``check_exposition``, every route of
    ``OPERATOR_ROUTES`` gives 200 with a payload and ``/debug/device``
    200 with the device plane's registry; the follower wrote no NodeClaim; stopped and started again, the
    operator leads, serves and reconciles again and decides new pods; no
    orphaned span. → the leg's row."""
    from karpenter_core_tpu_torch.metrics import check_exposition
    from karpenter_core_tpu_torch.operator import Operator, Options
    from karpenter_core_tpu_torch.serving import trafficgen as tg
    from karpenter_core_tpu_torch.tracing import RECORDER, tracer

    t0 = time.perf_counter()
    RECORDER.clear()
    orphans0 = tracer.orphan_spans()
    sc = tg.build_scenario("rollout", scale=scale)
    h = tg.TrafficHarness(teams=sc.teams, device=device)
    opts = dict(enable_leader_election=True, metrics_port=0, health_probe_port=0, use_serving_pipeline=True,
                batch_idle_duration=0.05, batch_max_duration=1.0)
    leader = Operator(h.provider, kube_client=h.kube, options=Options(**opts), device=device)
    follower = Operator(h.provider, kube_client=h.kube, options=Options(**opts), device=device)
    row: dict = {"scale": scale}
    try:
        leader.start()
        follower.start()
        if not (leader._leading() and not follower._leading()):
            fail(f"18b: the first operator does not lead alone ({leader._leading()}, {follower._leading()})")
        h.inject_step(sc.steps[0], 0)
        if not _until(lambda: RECORDER.last() is not None and leader.kube_client.list("NodeClaim"), 60.0):
            fail("18b: the served operator made no decision")
        row["first_decision_s"] = time.perf_counter() - t0
        port, probe = leader.http.metrics_port, leader.http.probe_port
        if not _until(lambda: _http_get(probe, "/readyz")[0] == 200, 15.0):
            fail(f"18b: /readyz never gave 200 ({_http_get(probe, '/readyz')})")
        status, _ = _http_get(probe, "/healthz")
        if status != 200:
            fail(f"18b: /healthz gave {status}")
        status, text = _http_get(port, "/metrics")
        problems = check_exposition(text)
        if status != 200 or problems:
            fail(f"18b: /metrics gave {status}, {problems[:3]}")
        routes = {}
        for path in OPERATOR_ROUTES:
            if not _until(lambda: _http_get(port, path)[0] == 200, 15.0):
                fail(f"18b: {path} never gave 200 ({_http_get(port, path)[0]})")
            status, body = _http_get(port, path)
            payload = json.loads(body)
            if not payload:
                fail(f"18b: {path} gave an empty payload")
            routes[path] = len(body)
        status, body = _http_get(port, "/debug/device")
        if status != 200 or not json.loads(body).get("registry"):
            fail(f"18b: /debug/device gave {status} {body[:200]!r}, not 200 with the device plane's registry")
        row["routes_bytes"] = routes
        row["leader_claims_created"] = sum(leader.metrics.nodeclaims_created.values.values())
        if not _until(lambda: follower.serving.held_ticks()["leader"] >= 1, 15.0):
            fail("18b: the follower's pipeline never held a tick")
        row["follower_claims_created"] = sum(follower.metrics.nodeclaims_created.values.values())
        row["follower_held_ticks"] = follower.serving.held_ticks()["leader"]
        row["follower_reconciles"] = sum(follower.metrics.reconcile_duration.totals.values())
        if row["follower_claims_created"] or row["follower_reconciles"]:
            fail(f"18b: the follower wrote or reconciled ({row})")
        follower.stop()
        # stop and start again: the operator leads, serves and reconciles anew
        leader.stop()
        before = sum(leader.metrics.reconcile_duration.totals.values())
        decisions = len(RECORDER.debug_state(tail=1 << 20)["decisions"])
        leader.start()
        if not leader._leading():
            fail("18b: the restarted operator does not lead")
        h.inject_step(sc.steps[1], 1)
        if not _until(lambda: len(RECORDER.debug_state(tail=1 << 20)["decisions"]) > decisions, 60.0):
            fail("18b: the restarted operator made no decision")
        if not _until(lambda: sum(leader.metrics.reconcile_duration.totals.values()) > before, 15.0):
            fail("18b: the restarted operator's controllers never reconciled")
        status, _ = _http_get(leader.http.probe_port, "/healthz")
        if status != 200:
            fail(f"18b: the restarted operator's /healthz gave {status}")
        row["decisions"] = len(RECORDER.debug_state(tail=1 << 20)["decisions"])
        row["leader_reconciles"] = sum(leader.metrics.reconcile_duration.totals.values())
        row["reconcile_errors"] = sum(leader.metrics.reconcile_errors.values.values())
        if row["reconcile_errors"]:
            fail(f"18b: reconcile errors {dict(leader.metrics.reconcile_errors.values)}")
    finally:
        follower.stop()
        leader.stop()
        h.close()
    _sync(device)
    row["orphan_spans"] = tracer.orphan_spans() - orphans0
    if row["orphan_spans"]:
        fail(f"18b: {row['orphan_spans']} orphaned spans")
    row["wall_s"] = time.perf_counter() - t0
    return row


def operator_twin_start(n_pods: int, n_types: int) -> subprocess.Popen:
    """18a's CPU twin started in a process of its own: ``run_operator_world``
    on the CPU with ``KARPENTER_TORCH_NATIVE=0`` and contracts on, its
    checks, its stream of pass digests and its seconds as one JSON line."""
    script = f"""
import json, time
import chip_smoke as cs
from karpenter_core_tpu_torch.solver import contracts
contracts.enable()
t0 = time.perf_counter()
cpu = cs.run_operator_world("cpu", {n_pods}, {n_types}, keep_states=False)
cpu_s = time.perf_counter() - t0
print(json.dumps({{"cpu_s": cpu_s, "counts": cs.check_operator_world(cpu, "cpu"),
                  "stream": cs.operator_stream_digest(cpu.passes)}}))
"""
    env = dict(os.environ, KARPENTER_TORCH_NATIVE="0")
    return subprocess.Popen([sys.executable, "-c", script], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def operator_twin_result(proc: subprocess.Popen, timeout: float = 600.0) -> dict:
    """Wait for 18a's CPU twin → its line, or fail with its errors."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        fail(f"18a: the CPU twin failed ({proc.returncode}): {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def run_operator_phase(device: str = "cuda", sizes: Optional[dict] = None, sm_mhz: float = 0.0) -> dict:
    """Phase 18 on ``device``, never cut short. 18a: ``run_operator_world``
    on ``device`` with ``KARPENTER_TORCH_NATIVE=0`` (compat, the FFD scan,
    the first-fit and B8's screens), every call of those four captured,
    then on the CPU on the same engine (the plain versions);
    ``check_operator_world`` on both, and the card's store equal to the
    CPU's after every pass; on the card the CPU twin runs in a process of
    its own beside the card's run (``operator_twin_start``). On the card
    every captured call is held to its plain version bit for bit, each
    distinct shape timed, and each of the four kernels must have
    launched. 18b: ``run_operator_served``. ``sizes``: {"world": (pods,
    types), "served": scale} → the phase's row."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver import solver as solver_mod

    sizes = {"world": (N_CONFIG2, 480), "served": OPERATOR_SERVED_SCALE, **(sizes or {})}
    n_pods, n_types = sizes["world"]
    t0 = time.perf_counter()
    # the CPU twin on the same engine (the scans' plain versions), in a
    # process of its own beside the card's run: at 10,000 pods the C++
    # packer's plans differ from the scans' from the first pass, in both
    # packages
    twin = operator_twin_start(n_pods, n_types) if device != "cpu" else None
    try:
        with knobs(KARPENTER_TORCH_NATIVE=0):
            with capture(solver_mod, "allowed_via_kernel") as compat_cap, \
                    capture(pack, "ffd_pack_batched") as ffd_cap, capture(pack, "pack_existing") as ex_cap, \
                    capture_screens() as screens:
                reset_disrupt_launches()
                card = run_operator_world(device, n_pods, n_types, keep_states=False)
                _sync(device)
                launches = disrupt_launches()
        card_s = time.perf_counter() - t0
        card_counts = check_operator_world(card, device)
        stream = json.loads(json.dumps(operator_stream_digest(card.passes)))
        del card
        gc.collect()
        row = {"card_s": card_s, device: card_counts, "launches": launches}
        if twin is not None:
            t1 = time.perf_counter()
            cpu = operator_twin_result(twin)
            row["cpu_wait_s"] = time.perf_counter() - t1
    finally:
        if twin is not None and twin.poll() is None:
            twin.kill()
            twin.wait()
    if twin is not None:
        row["cpu_s"], row["cpu"], cpu_stream = cpu["cpu_s"], cpu["counts"], cpu["stream"]
        if len(cpu_stream) != len(stream):
            fail(f"18a: the card ran {len(stream)} passes, the CPU {len(cpu_stream)}")
        for k, ((stage, a), (_, b)) in enumerate(zip(stream, cpu_stream)):
            if a != b:
                fail(f"18a: after pass {k} ({stage}) the card's store differs from the CPU's in "
                     f"{[part for part in a if a[part] != b[part]]}")
    row["passes_equal"] = len(stream)
    calls = {"compat_allowed": compat_cap.calls, "ffd_pack": ffd_cap.calls, "pack_existing": ex_cap.calls,
             **{f"disrupt_screen.{k}": v for k, v in screens.calls().items()}}
    row["captured_calls"] = {k: len(v) for k, v in calls.items()}
    if not all(calls[k] for k in ("compat_allowed", "ffd_pack", "pack_existing")) or not any(
            calls[k] for k in calls if k.startswith("disrupt_screen")):
        fail(f"18a: a kernel of the path was never called: {row['captured_calls']}")
    cases: dict = {}
    if device == "cuda":
        missing = [k for k in ("compat_allowed", "ffd_pack", "pack_existing") if not launches[k]]
        if missing or not any(n for k, n in launches.items() if k.startswith("disrupt_screen")):
            fail(f"18a: {missing or 'no screen'} never launched on the operator's path ({launches})")
        if sm_mhz <= 0:
            fail("18a needs the card's maximum SM clock to price the screens' chains")
        cases = hold_and_time(calls, "18a", "phase18", sm_mhz)
    del calls
    row["cases"] = cases
    row["served"] = run_operator_served(device, sizes["served"])
    row["wall_s"] = time.perf_counter() - t0
    return row


def report_operator_phase(op: dict, card: str) -> None:
    """Print phase 18's lines, each with the card."""
    for leg in [k for k in op if k in ("cuda", "cpu")]:
        emit({"phase18a": leg, **op[leg], "card": card})
    for name, rows in op["cases"].items():
        for r in rows:
            emit({"phase18_kernel_case": name, **r, "card": card})
    emit({"phase18b": "served", **op["served"], "card": card})
    emit({"phase18": "operator", "passes_equal": op["passes_equal"], "launches": op["launches"],
          "captured_calls": op["captured_calls"], "card_s": op["card_s"], "cpu_s": op.get("cpu_s"),
          "served_s": op["served"]["wall_s"], "wall_s": op["wall_s"], "card": card})


# -- phase 19: the fleet -------------------------------------------------------------

# bench config 11 (bench.py:1712-1948): catalog archetypes of 64, 160 and 320
# types (12 of them GPU types each); the curve's tenants and pods a tenant;
# the rounds of each run (a burst, then churn rounds of 10 % fresh arrivals,
# tenant 0's catalog bumped before round 1); the identity runs' cell
FLEET_ARCHETYPE_SIZES = (64, 160, 320)
FLEET_GPU_TYPES = 12
FLEET_TENANTS = (8, 32, 128)
FLEET_PODS = (200, 1000)
# the curve's cells this script leaves out, for its time: the 1,000-pod
# bursts past 8 tenants (the benchmark runs config 11 whole)
FLEET_CUT_CELLS = ((32, 1000), (128, 1000))
FLEET_ROUNDS = 3
FLEET_IDENTITY = (8, 200)
FLEET_SEED = 11
FLEET_ENGINES = ("solo", "batched")
# 19d: trafficgen --fleet at bench config 8's rollout, 8 tenants, scale 200
FLEET_TG_TENANTS = 8
FLEET_TG_SCALE = 200
# phase 19's share of SCRIPT_BUDGET_S, kept out of the budgets of the phases
# before it in its lane
FLEET_RESERVE_S = 150.0


def fleet_catalog(archetype: int, bump: int = 0) -> list:
    """One archetype's menu as ``bench.py::fleet_catalog`` builds it (a GPU
    tail for a second resource axis); ``bump`` gives a content-distinct
    revision."""
    from karpenter_core_tpu_torch.cloudprovider.fake import instance_types, new_instance_type

    size = FLEET_ARCHETYPE_SIZES[archetype % len(FLEET_ARCHETYPE_SIZES)]
    cat = instance_types(size - FLEET_GPU_TYPES + bump)
    for g in range(FLEET_GPU_TYPES):
        cat.append(new_instance_type(
            f"fleet-gpu-{archetype}-{g}",
            {"cpu": str(8 * (g + 1)), "memory": f"{16 * (g + 1)}Gi", "pods": "110", "nvidia.com/gpu": str(min(8, g + 1))},
        ))
    return cat


def fleet_env(n_tenants: int, device: str, seed: int = FLEET_SEED):
    """A registry and engine on ``device`` as ``bench.py::fleet_env`` builds
    them: tenants cycle the archetypes (each its own provider with fresh,
    content-identical objects), 60 % of them content twins (``t % 5 < 3``)
    running their archetype's standard workload."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.fleet import FleetEngine, FleetRegistry

    registry = FleetRegistry(device=device)
    engine = FleetEngine(registry)
    tenants = []
    for t in range(n_tenants):
        archetype = t % len(FLEET_ARCHETYPE_SIZES)
        tid = f"fleet-{t:03d}"
        provider = FakeCloudProvider()
        provider.instance_types = fleet_catalog(archetype)
        provider.bump_catalog_generation()
        nodepool = NodePool()
        nodepool.metadata.name = "default"
        registry.add_tenant(tid, [nodepool], provider)
        tenants.append({"tid": tid, "idx": t, "archetype": archetype, "twin": (t % 5) < 3, "seed": seed})
    return registry, engine, tenants


def fleet_pod(name: str, cpu: str, mem: str, gpu: Optional[str]):
    """A pending pod as ``bench.py::_mk_pod`` builds it, with a GPU request."""
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity

    pod = pending_pod(f"bench-{name}", cpu, mem)
    if gpu:
        pod.spec.containers[0].resources.requests["nvidia.com/gpu"] = parse_quantity(gpu)
    return pod


def fleet_work(tenants: list, pods_each: int, round_idx: int) -> dict:
    """One round's pending pods a tenant, as ``bench.py::fleet_work``: round
    0 the burst, churn rounds 10 % fresh arrivals; twins of an archetype
    draw the same request content."""
    work = {}
    for t in tenants:
        n = pods_each if round_idx == 0 else max(1, int(pods_each * 0.1))
        content_seed = t["seed"] + 7919 * round_idx + (t["archetype"] if t["twin"] else 104_729 + t["idx"])
        rng = np.random.RandomState(content_seed)
        pods = []
        for i in range(n):
            cpu = ["100m", "250m", "500m", "1", "2", "4"][rng.randint(6)]
            mem = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi"][rng.randint(5)]
            gpu = "1" if rng.rand() < 0.1 else None
            pods.append(fleet_pod(f"{t['tid']}-r{round_idx}-{i}", cpu, mem, gpu))
        work[t["tid"]] = pods
    return work


def fleet_plan_identity(plan) -> tuple:
    """``bench.py::_fleet_plan_identity``: a plan's content, the engines'
    parity projection."""
    return (plan.nodepool_name, plan.instance_type.name, plan.zone, plan.capacity_type, round(plan.price, 9),
            tuple(plan.pod_indices), plan.max_pods_per_node)


class count_builds:
    """Count the kernel and packer libraries built or loaded
    (``buildlib.build_shared`` calls) while ``on`` is set."""

    def __init__(self):
        self.n, self.on = 0, False

    def __enter__(self):
        from karpenter_core_tpu_torch import buildlib

        self.module, real = buildlib, buildlib.build_shared
        self.real = real

        def spy(*args, **kw):
            if self.on:
                self.n += 1
            return real(*args, **kw)

        buildlib.build_shared = spy
        return self

    def __exit__(self, *exc):
        self.module.build_shared = self.real


class record_flushes:
    """Record each mega-dispatch flush's lanes: per lane (one tenant's pack
    call) the (pad class, width) of each of its jobs."""

    def __init__(self):
        self.flushes: list = []

    def __enter__(self):
        from karpenter_core_tpu_torch.fleet import megasolve
        from karpenter_core_tpu_torch.solver.pack import _pad_class

        self.cls, real = megasolve._MegaDispatcher, megasolve._MegaDispatcher._run_batch
        self.real = real

        def spy(dispatcher, batch):
            self.flushes.append([[(_pad_class(int(j[0].shape[0])), int(j[0].shape[1])) for j in w.jobs] for w in batch])
            return real(dispatcher, batch)

        self.cls._run_batch = spy
        return self

    def __exit__(self, *exc):
        self.cls._run_batch = self.real

    def scan_launches(self) -> dict:
        """The FFD scan's launches these flushes make with the C++ packer
        off: ``pack.batch_pack`` launches once per (pad class, width) class
        of a flush. → launches, jobs a launch, launches a flush and the
        launches that carry jobs of two or more tenants."""
        per_flush, jobs_per_launch, mixed = [], [], 0
        for lanes in self.flushes:
            classes: dict = {}
            for lane, shapes in enumerate(lanes):
                for shape in shapes:
                    classes.setdefault(shape, []).append(lane)
            per_flush.append(len(classes))
            for members in classes.values():
                jobs_per_launch.append(len(members))
                mixed += len(set(members)) >= 2
        return {
            "flushes": len(self.flushes), "launches": sum(per_flush),
            "launches_per_flush": round(sum(per_flush) / len(per_flush), 3) if per_flush else 0.0,
            "max_launches_per_flush": max(per_flush, default=0),
            "jobs_per_launch": round(sum(jobs_per_launch) / len(jobs_per_launch), 3) if jobs_per_launch else 0.0,
            "max_jobs_per_launch": max(jobs_per_launch, default=0), "multi_tenant_launches": mixed,
        }


def fleet_run(n_tenants: int, pods_each: int, engine_name: str, device: str, rounds: int = FLEET_ROUNDS,
              collect_plans: bool = False) -> dict:
    """One engine's fleet measurement, ``bench.py::fleet_run`` on the port:
    a burst, then churn rounds, tenant 0's catalog bumped before round 1.
    The wall covers the solve rounds only; the catalog cache holds 2 ·
    tenants + 16 entries. ``steady_round_builds``: libraries built or
    loaded during rounds ≥ 1 (the reference's steady-round recompiles;
    must be 0). Fails on any tenant's error."""
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    with knobs(KARPENTER_TORCH_FLEET_ENGINE=engine_name, KARPENTER_TORCH_CATALOG_CACHE_MAX=2 * n_tenants + 16), \
            count_builds() as builds:
        registry, engine, tenants = fleet_env(n_tenants, device)
        works = [fleet_work(tenants, pods_each, r) for r in range(rounds)]
        # everything alive frozen (no full collection of the script's heap):
        # each round's collection before its timer (nogc) then walks only
        # what the earlier rounds made
        gc.freeze()
        plans: dict = {}
        decided = 0
        dispatch = {"flushes": 0, "pack_calls": 0, "jobs": 0, "max_occupancy": 0, "padding_waste": []}
        wall = 0.0
        per_round_ms = []
        ck.COMPAT_ALLOWED.launches = 0  # counted from 0 just before the run, read just after
        for r, work in enumerate(works):
            if r == 1:
                registry.get(tenants[0]["tid"]).provider.set_instance_types(fleet_catalog(tenants[0]["archetype"], bump=1))
            builds.on = r >= 1
            with nogc():
                t0 = time.perf_counter()
                outcomes = engine.solve_round(work)
                dt = time.perf_counter() - t0
            builds.on = False
            wall += dt
            per_round_ms.append(dt * 1000.0)
            d = engine.last_round.get("dispatch") or {}
            for k in ("flushes", "pack_calls", "jobs"):
                dispatch[k] += d.get(k, 0)
            dispatch["max_occupancy"] = max(dispatch["max_occupancy"], d.get("max_occupancy", 0))
            if d:
                dispatch["padding_waste"].append(d.get("padding_waste", 0.0))
            for tid in sorted(outcomes):
                o = outcomes[tid]
                if o.error is not None:
                    fail(f"phase 19: the fleet solve of {tid} failed ({engine_name}, {n_tenants} x {pods_each}, "
                         f"round {r}, {device}): {o.error}")
                decided += o.pods
                if collect_plans:
                    plans[(r, tid)] = tuple(sorted(fleet_plan_identity(p) for p in o.result.node_plans))
        compat = ck.COMPAT_ALLOWED.launches
        canon = registry.plane.debug_state()["canonical_catalogs"]
        gc.unfreeze()
        del registry, engine, works
    return {
        "engine": engine_name, "device": device, "tenants": n_tenants, "pods_each": pods_each, "rounds": rounds,
        "pods_decided": decided, "wall_ms": wall * 1000.0, "round_ms": per_round_ms,
        "pods_per_sec": decided / wall if wall else 0.0, "dispatch": dispatch, "plans": plans,
        "steady_round_builds": builds.n, "compat_launches": compat, "canonical_catalogs": canon,
    }


def identical_cells(a: dict, b: dict) -> tuple:
    """(cells whose plans are equal, cells) over two runs' plan maps."""
    cells = set(a) | set(b)
    return sum(1 for c in cells if a.get(c) == b.get(c)), len(cells)


def check_identity(label: str, a: dict, b: dict) -> str:
    same, n = identical_cells(a, b)
    if same != n or not n:
        first = sorted(c for c in set(a) | set(b) if a.get(c) != b.get(c))[:3]
        fail(f"phase 19: {label}: {same}/{n} cells identical; first differing (round, tenant): {first}")
    return f"{same}/{n}"


def fleet_row(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "plans"}


def run_fleet_config11(device: str, tenants=FLEET_TENANTS, pods=FLEET_PODS, rounds: int = FLEET_ROUNDS,
                       identity=FLEET_IDENTITY) -> dict:
    """19a, bench config 11 on ``device``: the two warm-up runs, the curve
    (every cell but ``FLEET_CUT_CELLS`` solo and batched, plans held cell
    by cell) and the identity runs; no tenant error and no library built
    in a steady round."""
    for engine in FLEET_ENGINES:
        fleet_run(2, 40, engine, device, rounds=1)
    curve = []
    for n_tenants in tenants:
        for pods_each in pods:
            if (n_tenants, pods_each) in FLEET_CUT_CELLS:
                continue
            runs = {engine: fleet_run(n_tenants, pods_each, engine, device, rounds, collect_plans=True)
                    for engine in FLEET_ENGINES}
            solo, batched = runs["solo"], runs["batched"]
            identity_cells = check_identity(f"19a {n_tenants} x {pods_each} batched against solo",
                                            batched["plans"], solo["plans"])
            curve.append({
                "tenants": n_tenants, "pods_each": pods_each,
                "solo_pods_per_sec": solo["pods_per_sec"], "batched_pods_per_sec": batched["pods_per_sec"],
                "throughput_ratio": batched["pods_per_sec"] / solo["pods_per_sec"] if solo["pods_per_sec"] else 0.0,
                "solo_round_ms": solo["round_ms"], "batched_round_ms": batched["round_ms"],
                "dispatch": batched["dispatch"], "identical": identity_cells,
                "compat_launches": {e: r["compat_launches"] for e, r in runs.items()},
                "canonical_catalogs": batched["canonical_catalogs"],
                "steady_round_builds": solo["steady_round_builds"] + batched["steady_round_builds"],
            })
            del runs, solo, batched
    ident = {engine: fleet_run(*identity, engine, device, rounds, collect_plans=True) for engine in FLEET_ENGINES}
    identical = check_identity("19a identity batched against solo", ident["batched"]["plans"], ident["solo"]["plans"])
    builds = sum(c["steady_round_builds"] for c in curve) + sum(r["steady_round_builds"] for r in ident.values())
    if builds:
        fail(f"phase 19a: {builds} libraries built or loaded in steady rounds")
    small = [c for c in curve if c["tenants"] == max(tenants) and c["pods_each"] == min(pods)]
    return {
        "curve": curve, "identity": {e: fleet_row(r) for e, r in ident.items()}, "plan_identity": identical,
        "plans": ident["batched"]["plans"], "steady_round_builds": builds,
        "throughput_ratio_at_largest_small": small[0]["throughput_ratio"] if small else None,
    }


def fleet_kernel_leg(identity, engine: str, device: str, rounds: int):
    """One 19c leg: the identity world's run on ``device`` from fresh pack
    backends (an earlier leg's relaxations would serve this one's from the
    ``lprelax`` memo), the counts set to 0 just before it and read just
    after, its flushes recorded."""
    from karpenter_core_tpu_torch.solver import backends

    backends.reset_for_tests()
    reset_pack_launches()  # fleet_run sets compat's to 0 itself
    with record_flushes() as rec:
        run = fleet_run(*identity, engine, device, rounds, collect_plans=True)
        _sync(device)
    launches = {"compat_allowed": run["compat_launches"], **pack_launches()}
    return run, launches, rec


def hold_dual_call(call) -> None:
    """One captured dual-ascent call against its plain version on the card,
    bit for bit (weights, routes and fits)."""
    import torch

    from karpenter_core_tpu_torch.solver.backends import lp

    args = tuple(a.cuda() if hasattr(a, "cuda") else a for a in call)
    got, want = lp.dual_ascent(*args), lp.dual_ascent_reference(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("19c: a captured dual_ascent call differs from its plain version")


def run_fleet_kernels(device: str, identity=FLEET_IDENTITY, rounds: int = FLEET_ROUNDS, plans_19a=None) -> dict:
    """19c, ``KARPENTER_TORCH_NATIVE=0``: the identity world batched and solo
    on ``device`` and (on the card) batched on the CPU, then one round
    under ``KARPENTER_TORCH_PACK_BACKEND=lp`` the same three ways. Plans
    equal across each group's legs, the FFD legs' equal to 19a's (the C++
    packer's). On the card every captured compat, FFD and
    dual-ascent call is held to its plain version bit for bit and each
    distinct shape timed, and a B5 launch must carry two tenants' jobs."""
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver import solver as solver_mod
    from karpenter_core_tpu_torch.solver.backends import lp

    out: dict = {"legs": {}, "launches": {}, "scan": {}}
    calls: dict = {"compat_allowed": [], "ffd_pack": [], "dual_ascent": []}
    for backend, leg_rounds in (("ffd", rounds), ("lp", 1)):
        plans = {}
        legs = [("batched", device), ("solo", device)] + ([("batched", "cpu")] if device != "cpu" else [])
        for engine, dev in legs:
            key = f"{backend}-{engine}-{dev}"
            with knobs(KARPENTER_TORCH_NATIVE=0, KARPENTER_TORCH_PACK_BACKEND=backend), \
                    capture(solver_mod, "allowed_via_kernel") as compat_cap, \
                    capture(pack, "ffd_pack_batched") as ffd_cap, capture(lp, "dual_ascent") as dual_cap:
                run, launches, rec = fleet_kernel_leg(identity, engine, dev, leg_rounds)
            plans[key] = run.pop("plans")
            out["legs"][key] = fleet_row(run)
            if dev != "cpu":
                out["launches"][key] = launches
                calls["compat_allowed"] += compat_cap.calls
                calls["ffd_pack"] += ffd_cap.calls
                calls["dual_ascent"] += dual_cap.calls
            if engine == "batched":
                out["scan"][key] = rec.scan_launches()
            del run
        first = next(iter(plans))
        for key in plans:
            check_identity(f"19c {key} against {first}", plans[key], plans[first])
        if backend == "ffd" and plans_19a is not None:
            # the scans' plans against the C++ packer's (19a): equal at
            # these sizes
            out["ffd_equal_to_19a"] = check_identity(f"19c {first} against 19a", plans[first], plans_19a)
    multi = [s["multi_tenant_launches"] for k, s in out["scan"].items() if k.startswith("ffd-batched")]
    if not any(multi):
        fail(f"phase 19c: no FFD scan launch carried two tenants' jobs: {out['scan']}")
    out["captured_calls"] = {k: len(v) for k, v in calls.items()}
    cases: dict = {}
    if device == "cuda":
        for kind in ("compat_allowed", "ffd_pack", "dual_ascent"):
            if not calls[kind]:
                fail(f"phase 19c: no {kind} call was captured under the fleet")
        for key, n in out["launches"].items():
            backend, engine = key.split("-")[:2]
            need = ("compat_allowed", "ffd_pack") + (("dual_ascent",) if backend == "lp" else ())
            missing = [k for k in need if not n[k]]
            if missing:
                fail(f"phase 19c: {missing} never launched on the {key} leg ({n})")
            if backend == "ffd" and engine == "batched" and n["ffd_pack"] < out["scan"][key]["launches"]:
                fail(f"phase 19c: {n['ffd_pack']} FFD launches on {key}, its flushes' classes need "
                     f"{out['scan'][key]['launches']}")
        cases = hold_and_time(calls, "19c")
    out["cases"] = cases
    return out


def run_fleet_trafficgen(device: str, n_tenants: int = FLEET_TG_TENANTS, scale: int = FLEET_TG_SCALE) -> dict:
    """19d, ``trafficgen --fleet N --scenario rollout --scale S``: batched
    and solo on ``device`` and (on the card) batched on the CPU, each its
    own process, three at a time: plan hashes equal, decisions monotonic,
    no orphaned span, no decision error."""
    base = ["--scenario", "rollout", "--fleet", n_tenants, "--scale", scale]
    jobs = {f"{engine}-{device}": base + ["--engine", engine, "--device", device] for engine in FLEET_ENGINES}
    if device != "cpu":
        jobs["batched-cpu"] = base + ["--engine", "batched", "--device", "cpu"]
    with knobs(KARPENTER_TORCH_CATALOG_CACHE_MAX=2 * n_tenants + 16):
        runs = trafficgen_all(jobs, workers=3, phase="phase 19d")
    hashes = {k: r["plan_sha256"] for k, r in runs.items()}
    if len(set(hashes.values())) != 1:
        fail(f"phase 19d: the --fleet plan hashes differ: {hashes}")
    for k, r in runs.items():
        if not r["decisions_monotonic"] or r["orphan_spans"] or r["decision_errors"] or r["pods_decided"] != r["pods_injected"]:
            fail(f"phase 19d: {k}: monotonic {r['decisions_monotonic']}, orphan spans {r['orphan_spans']}, "
                 f"errors {r['decision_errors']}, decided {r['pods_decided']} of {r['pods_injected']}")
    return {"plan_sha256": next(iter(hashes.values())), "runs": {k: {
        key: r[key] for key in ("engine", "device", "rounds", "pods_decided", "wall_s", "pods_per_sec",
                                "decision_latency_ms", "dispatch", "scheduler", "process_s")
    } for k, r in runs.items()}}


def run_fleet_phase(device: str = "cuda", tenants=FLEET_TENANTS, pods=FLEET_PODS, rounds: int = FLEET_ROUNDS,
                    identity=FLEET_IDENTITY, tg=(FLEET_TG_TENANTS, FLEET_TG_SCALE), card: Optional[str] = None) -> dict:
    """Phase 19 on ``device``, never cut short: 19a bench config 11 (but ``FLEET_CUT_CELLS``),
    19b the identity runs batched on the CPU against the card's, 19c the
    kernels under the fleet (native off, then ``lp``), 19d three
    ``trafficgen --fleet`` processes. With ``card`` each part prints its
    lines as it ends. → the phase's row, ``sections_s`` per part."""
    t0 = time.perf_counter()
    sections = {}
    row = {"config11": run_fleet_config11(device, tenants, pods, rounds, identity)}
    plans = row["config11"].pop("plans")
    sections["19a"] = time.perf_counter() - t0
    if card is not None:
        report_fleet_part(row, "19a", card)
    if device != "cpu":
        t1 = time.perf_counter()
        cpu = fleet_run(*identity, "batched", "cpu", rounds, collect_plans=True)
        row["cpu_identity"] = check_identity("19b the CPU's batched identity run against the card's", cpu.pop("plans"),
                                             plans)
        row["cpu_run"] = cpu
        sections["19b"] = time.perf_counter() - t1
        if card is not None:
            report_fleet_part(row, "19b", card)
    t1 = time.perf_counter()
    row["kernels"] = run_fleet_kernels(device, identity, rounds, plans_19a=plans)
    sections["19c"] = time.perf_counter() - t1
    if card is not None:
        report_fleet_part(row, "19c", card)
    t1 = time.perf_counter()
    row["trafficgen"] = run_fleet_trafficgen(device, *tg)
    sections["19d"] = time.perf_counter() - t1
    row["sections_s"] = sections
    row["wall_s"] = time.perf_counter() - t0
    if card is not None:
        report_fleet_part(row, "19d", card)
    return row


def report_fleet_part(fleet: dict, part: str, card: str) -> None:
    """Print one part of phase 19's lines, each with the card (19d's with
    the phase's summary)."""
    if part == "19a":
        c11 = fleet["config11"]
        for cell in c11["curve"]:
            emit({"phase19a_cell": f"{cell['tenants']}x{cell['pods_each']}", **cell, "card": card})
        emit({"phase19a": "config11", "plan_identity": c11["plan_identity"], "identity": c11["identity"],
              "steady_round_builds": c11["steady_round_builds"],
              "throughput_ratio_at_largest_small": c11["throughput_ratio_at_largest_small"], "card": card})
    elif part == "19b":
        emit({"phase19b": "card=cpu", "identical": fleet["cpu_identity"], "cpu_run": fleet["cpu_run"], "card": card})
    elif part == "19c":
        k = fleet["kernels"]
        for name, rows in k["cases"].items():
            for r in rows:
                emit({"phase19_kernel_case": name, **r, "card": card})
        emit({"phase19c": "kernels", "legs": k["legs"], "launches": k["launches"], "scan": k["scan"],
              "captured_calls": k["captured_calls"], "ffd_equal_to_19a": k.get("ffd_equal_to_19a"), "card": card})
    else:
        emit({"phase19d": "trafficgen --fleet", **fleet["trafficgen"], "card": card})
        emit({"phase19": "fleet", "sections_s": fleet["sections_s"], "wall_s": fleet["wall_s"], "card": card})


# -- phase 20: the device plane ---------------------------------------------------

# phase 20's share of SCRIPT_BUDGET_S, kept out of the budgets of the phases
# before it in its lane
DEVICEPLANE_RESERVE_S = 60.0
# the kernels by their device-plane names (the reference's jit names)
PLANE_KERNELS = ("kernels.allowed_kernel", "pack.ffd_pack_batched", "pack.pack_existing", "lp.dual_ascent",
                 "disrupt.prefix_screen", "disrupt.subset_screen", "disrupt.single_screen")
# the boundaries a card run moves bytes across (the compat one only on the card)
PLANE_PHASES = ("compat", "pack", "existing", "lp", "screen")
DEVICEPLANE_RESTART_SHAPE = "hetero-split"  # 20d's world: bench config 10's shape, under lp
DEVICEPLANE_CONFIG4_NODES = 1_000  # 20c's cut of config 4 (phase 15 runs its 5,000 whole)
DEVICEPLANE_RESTART_DECISION_NODES = 300  # 20d: the restored process's first decision, config 4 cut
DEVICEPLANE_TURNS = 4  # 20f: on, off, off, on, this many times


def plane_kernels() -> dict:
    """The device plane's kernels by name (each module imported, so each
    is bound)."""
    import karpenter_core_tpu_torch.disruption.screen_kernels  # noqa: F401
    import karpenter_core_tpu_torch.solver.backends.lp  # noqa: F401
    import karpenter_core_tpu_torch.solver.solver  # noqa: F401
    from karpenter_core_tpu_torch import buildlib

    return {name: buildlib.KERNELS[name] for name in PLANE_KERNELS}


# each kernel's device function, as torch.profiler names it: one launch
# function launches one of these once
PLANE_DEVICE_NAMES = {
    "kernels.allowed_kernel": ("compat_allowed_large_kernel", "compat_allowed_small_kernel"),
    "pack.ffd_pack_batched": ("ffd_pack_kernel",), "pack.pack_existing": ("pack_existing_kernel",),
    "lp.dual_ascent": ("dual_ascent_kernel",), "disrupt.prefix_screen": ("prefix_kernel",),
    "disrupt.subset_screen": ("subset_kernel",), "disrupt.single_screen": ("single_kernel",),
}


def traced_launches(run, names, attempts: int = 3) -> dict:
    """Check (a) against the card's own record: ``run()`` under
    torch.profiler, each kernel of ``names`` counted in the trace beside
    its counter's launches over the same run (the count the device plane
    reads). A trace count above the counter fails (the counter missed a
    launch); equal counts of a kernel that launched verify it; fewer (a
    trace that dropped events, as this profiler sometimes does) retry, up
    to ``attempts`` runs. → name → {"trace", "counted"}, else "not
    measured" (with a ``profiler_gap`` line) or "not launched" (no run
    launched it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_core_tpu_torch import buildlib

    tries = []
    verified: dict = {}
    for _ in range(attempts):
        # a short session of its own first: after a long stretch with no
        # profiling, sessions have recorded no device activity
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        before = {name: buildlib.KERNELS[name].total_launches for name in names}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        counted = {name: buildlib.KERNELS[name].total_launches - before[name] for name in names}
        trace = dict.fromkeys(names, 0)
        for evt in prof.key_averages():
            for name in names:
                if any(fn in evt.key for fn in PLANE_DEVICE_NAMES[name]):
                    trace[name] += int(evt.count)
        tries.append({"trace": trace, "counted": counted})
        over = {name: (trace[name], counted[name]) for name in names if trace[name] > counted[name]}
        if over:
            fail(f"phase 20 (a): the trace holds more launches than the counters count: {over}")
        for name in names:
            if counted[name] and trace[name] == counted[name] and name not in verified:
                verified[name] = {"trace": trace[name], "counted": counted[name]}
        if len(verified) == len(names):
            break
    launched = {name for t in tries for name in names if t["counted"][name]}
    gaps = [name for name in launched if name not in verified]
    if gaps:
        emit({"profiler_gap": f"no trace held every launch of {gaps} that the counters counted; "
                              "check (a) for them is not measured", "attempts": tries})
    return {name: verified.get(name, "not measured" if name in launched else "not launched") for name in names}


def plane_solve(solver, label: str, *args, **kw) -> dict:
    """One solve and what the device plane says of it: its block, its
    device time per boundary, the plan's digest."""
    from karpenter_core_tpu_torch.solver import stats as solver_stats

    t0 = time.perf_counter()
    res = solver.solve(*args, **kw)
    wall_ms = (time.perf_counter() - t0) * 1000.0
    block = solver.last_device_stats
    if block is None or solver_stats.solve_stats(solver)["device"] is None:
        fail(f"phase 20 {label}: the solve has no device block")
    return {"label": label, "res": res, "wall_ms": wall_ms, "block": block,
            "phase_ms": dict(solver.last_device_phase_ms), "device_ms": solver.last_timings["device_ms"]}


def restart_child(path: str, device: str, decision_nodes: int = DEVICEPLANE_RESTART_DECISION_NODES) -> dict:
    """20d's fresh process: config 10's restart shape, the snapshot at
    ``path`` restored, the boot prewarm, then the first solve under lp,
    then a first consolidation decision (bench config 4 at
    ``decision_nodes`` nodes: the screens, whose library only the
    restored manifest names to the prewarm) → the solve's compile
    events, plan digest and cache hits, and the decision's compile events
    (the process's solve-attributed count across it) and screen
    launches."""
    script = f"""
import json, os
import chip_smoke as cs
from karpenter_core_tpu_torch.apis.nodepool import NodePool
from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
from karpenter_core_tpu_torch.disruption import screen_kernels
from karpenter_core_tpu_torch.solver import TorchScheduler, contracts, prewarm
from karpenter_core_tpu_torch.tracing import deviceplane
contracts.enable()
cs.plane_kernels()  # every entry point bound, as in an operator's process
catalog, pods = next((c, p) for name, c, p in cs.config10_shapes() if name == {DEVICEPLANE_RESTART_SHAPE!r})
provider = FakeCloudProvider()
provider.instance_types = list(catalog)
pool = NodePool()
pool.metadata.name = "default"
solver = TorchScheduler([pool], provider, device={device!r})
outcome = solver.restore({path!r})
boot = prewarm.warmup_compile_only(solver)
res = solver.solve(pods)
solve_stats = solver.last_device_stats
with cs.same_identities():
    w = cs.config4_world({device!r}, {decision_nodes})
    try:
        before = deviceplane.compile_count()
        cmd = cs.disrupt_decide(w, "batched", {device!r})[0]
        decision_compiles = deviceplane.compile_count() - before
    finally:
        w.stop()
print(json.dumps({{"outcome": outcome, "boot": {{k: v for k, v in boot.items() if k != "calibration"}},
                  "compiles": solve_stats["compiles"], "events": solve_stats["compile_events"],
                  "sha": cs.plan_sha256(res), "hits": solver.last_cache_stats["hits"],
                  "decision_action": cmd.action(), "decision_compiles": decision_compiles,
                  "decision_screens": screen_kernels.launches(),
                  "recent_compiles": deviceplane.recent_compiles(8)}}))
"""
    env = dict(os.environ, KARPENTER_TORCH_PACK_BACKEND="lp")
    proc = subprocess.run([sys.executable, "-c", script], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"phase 20d: the restored process failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def wrapper_turns(pool, provider, pods, device: str, turns: int, reps: int = 50) -> dict:
    """20f's second part: one ``allowed_via_kernel`` call on the world's
    compat inputs, the device plane and the shape contracts both on
    against both off, in turns (on, off, off, on): the median ms of
    ``reps`` calls each (``median_ms``'s events on the card, the host
    clock off it) → {"on": [...], "off": [...], "on_ms", "off_ms"}. The
    layers' host cost is what the calls differ by."""
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import contracts
    from karpenter_core_tpu_torch.tracing import deviceplane

    sp = slice_planes([pool], provider, pods)
    catalog = ck.catalog_to_device(sp["tm"], sp["th"], sp["tn"], sp["keys"], sp["avail"], torch.device(device))
    side = ck.signature_side(sp["sig"], sp["zone_ok"], sp["ct_ok"], catalog)

    def call():
        ck.allowed_via_kernel(side, catalog)

    def host_ms():
        call()
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            samples.append((time.perf_counter() - t0) * 1000.0)
        return statistics.median(samples)

    got: dict = {"on": [], "off": []}
    was = contracts.enabled()
    try:
        for _ in range(turns):
            for on in (True, False, False, True):
                deviceplane.DEVICEPLANE = on
                contracts.enable(on)
                got["on" if on else "off"].append(median_ms(call, reps) if device == "cuda" else host_ms())
    finally:
        deviceplane.DEVICEPLANE = True
        contracts.enable(was)
    return {**got, "on_ms": statistics.median(got["on"]), "off_ms": statistics.median(got["off"])}


def run_deviceplane_phase(device: str = "cuda", n_pods: int = N_PODS, n_types: int = N_TYPES,
                          n_nodes: int = N_NODES, config4_nodes: int = DEVICEPLANE_CONFIG4_NODES,
                          decision_nodes: int = DEVICEPLANE_RESTART_DECISION_NODES,
                          turns: int = DEVICEPLANE_TURNS, workdir: Optional[str] = None) -> dict:
    """Phase 20: the device plane over solves of its own, each kernel's
    counter beside the plane's. 20a phase 5's cluster (``n_pods`` pods,
    ``n_types`` types, ``n_nodes`` nodes) with the native packer off:
    compat, the FFD scan and the first-fit, a cold solve then a steady
    one. 20b bench config 10 under lp: every shape cold (the dual ascent)
    and warm, its $/hr the JAX package's. 20c bench config 4's decision
    (``config4_nodes`` nodes; the screens), in a device-time scope. 20d a
    restart: the config 10 shape's warm solver snapshotted, restored in a
    fresh process, its boot prewarm, then its first solve and a first
    decision (config 4 at ``decision_nodes`` nodes). 20e the
    slow-solve capture and a breach dump into a temporary directory, read
    back. 20f one warm solve (one pod's version bumped each time, so the
    solve runs its path) with the plane on against off, in turns.
    Checks: (a) on the card, each kernel's launches in the plane (its
    counter) equal the profiler trace's over a cluster solve, a fresh lp
    solve and a fresh decision (``traced_launches``: more in the trace
    fails, as does a kernel its run never launched; a trace that dropped
    events is retried, then "not measured");
    (b) compile events equal the libraries loaded in the phase, and the
    steady pass raises none; (c) every boundary with device time moved
    bytes; (d) the card's high-water mark lies between the largest
    footprint and the card's memory; (e) every solve has its device
    block and its device time per boundary (the screens' in 20c's scope);
    (f) the restored first solve raises no compile event and plans as
    the unkilled one, and the restored process's first decision (its
    screens, whose library only the restored manifest brings into the
    boot prewarm) raises none either; (g) the files load back; (h) on ≤ off × 1.25 + 2
    ms, the reference's bound. 20d's snapshot and 20e's files go under
    ``workdir`` (None: a temporary directory, removed after). → the
    phase's numbers."""
    import shutil
    import tempfile

    import torch

    from karpenter_core_tpu_torch import buildlib
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_core_tpu_torch.metrics import Metrics
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends, devicetime
    from karpenter_core_tpu_torch.tracing import RING, capture, deviceplane, flightrec

    t_phase = time.perf_counter()
    sections = {}
    card = device == "cuda"
    kernels = plane_kernels()
    for k in kernels.values():
        k.launches = 0
    libs_before = {row["library"] for row in buildlib.loaded_libraries()}
    events_before = deviceplane.compile_count() + deviceplane.prewarm_compile_count()
    totals_before = deviceplane.totals()["transfer_bytes"]
    metrics = Metrics()
    solves = []

    # 20a: phase 5's cluster, native off: compat, B5, B6; cold then steady
    t0 = time.perf_counter()
    pools, provider, pods, nodes, daemons, _missing, _kube = _cluster_world(n_pods, n_types, n_nodes)
    with knobs(KARPENTER_TORCH_NATIVE=0):
        solver = TorchScheduler(pools, provider, device=device, metrics=metrics)
        cold = plane_solve(solver, "20a-cold", pods, state_nodes=nodes, daemonset_pods=daemons)
        steady = [plane_solve(solver, "20a-steady", pods, state_nodes=nodes, daemonset_pods=daemons)]
    solves += [cold, *steady]
    sections["20a"] = time.perf_counter() - t0

    # 20b: bench config 10 under lp, every shape cold and warm
    t0 = time.perf_counter()
    shapes = {}
    restart_solver = restart_pods = None
    with knobs(KARPENTER_TORCH_PACK_BACKEND="lp"):
        for name, catalog, shape_pods in config10_shapes():
            backends.reset_for_tests()
            shape_provider = FakeCloudProvider()
            shape_provider.instance_types = list(catalog)
            pool = NodePool()
            pool.metadata.name = "default"
            shape_solver = TorchScheduler([pool], shape_provider, device=device, metrics=metrics)
            first = plane_solve(shape_solver, f"20b-{name}", shape_pods)
            price = round(first["res"].total_price, 4)
            if price != CONFIG10_REFERENCE[name][1]:
                fail(f"phase 20b {name}: lp $/hr {price}, the JAX package's is {CONFIG10_REFERENCE[name][1]}")
            warm = plane_solve(shape_solver, f"20b-{name}-steady", shape_pods)
            solves.append(first)
            steady.append(warm)
            shapes[name] = {"price": price, "device_ms": first["device_ms"], "phase_ms": first["phase_ms"],
                            "sha": plan_sha256(warm["res"])}
            if name == DEVICEPLANE_RESTART_SHAPE:
                restart_solver, restart_pods, restart_provider = shape_solver, shape_pods, shape_provider
    solves += steady[1:]
    sections["20b"] = time.perf_counter() - t0

    # 20c: bench config 4's decision, the screens in a device-time scope
    t0 = time.perf_counter()
    screen_before = deviceplane.totals()["transfer_bytes"]
    traced = {}
    with same_identities():
        w = config4_world(device, config4_nodes)
        try:
            with devicetime.scope(device) as decision_clock:
                cmd, decision_ms, _stats, n_candidates = disrupt_decide(w, "batched", device)
            screen_after = deviceplane.totals()["transfer_bytes"]
            # the phase's launches, read before (a)'s traced runs add theirs
            launched = {name: k.launches for name, k in kernels.items()}
            if card:
                # (a) against the card's trace: a steady cluster solve that
                # runs its path (one pod's new version: B5, B6), a config
                # 10 shape's lp solve on a fresh pool and fresh relaxations
                # (compat, B7), a first decision on a fresh config 4 world
                # (the screens 20c launched)
                bumped = iter(pods)

                def cluster_solve():
                    p = next(bumped)
                    p.metadata.resource_version = str(int(p.metadata.resource_version or 0) + 1)
                    with knobs(KARPENTER_TORCH_NATIVE=0):
                        solver.solve(pods, state_nodes=nodes, daemonset_pods=daemons)

                fresh_pools = iter(range(10))

                def lp_solve():
                    # a pool of a new name: the signature rows cached for
                    # the shape's pool do not serve it, so compat launches
                    backends.reset_for_tests()
                    pool = NodePool()
                    pool.metadata.name = f"traced-{next(fresh_pools)}"
                    with knobs(KARPENTER_TORCH_PACK_BACKEND="lp"):
                        TorchScheduler([pool], restart_provider, device=device).solve(restart_pods)

                def fresh_decision():
                    with same_identities():
                        w2 = config4_world(device, decision_nodes)
                        try:
                            disrupt_decide(w2, "batched", device)
                        finally:
                            w2.stop()

                traced.update(traced_launches(cluster_solve, ("pack.ffd_pack_batched", "pack.pack_existing")))
                traced.update(traced_launches(lp_solve, ("kernels.allowed_kernel", "lp.dual_ascent")))
                traced.update(traced_launches(fresh_decision, [n for n in PLANE_KERNELS[4:] if launched[n]]))
        finally:
            w.stop()
    decision = {"action": cmd.action(), "candidates": n_candidates, "decision_ms": decision_ms,
                "phase_ms": decision_clock.phase_ms(),
                "screen_bytes": {d: screen_after.get(f"{d}.screen", 0) - screen_before.get(f"{d}.screen", 0)
                                 for d in ("h2d", "d2h")}}
    if cmd.action() == "no-op":
        fail("phase 20c: config 4 and no consolidation")
    sections["20c"] = time.perf_counter() - t0

    # the phase's own checks: (a) above (a kernel its run never launched
    # fails it), (b), (c), (d), (e)
    unlaunched = [name for name, got in traced.items() if got == "not launched"]
    if unlaunched:
        fail(f"phase 20 (a): {unlaunched} never launched in their traced runs")
    new_libs = [row for row in buildlib.loaded_libraries() if row["library"] not in libs_before]
    events = deviceplane.compile_count() + deviceplane.prewarm_compile_count() - events_before
    if events != len(new_libs):
        fail(f"phase 20 (b): {events} compile events, {len(new_libs)} libraries loaded")
    if any(s["block"]["compiles"] for s in steady):
        fail(f"phase 20 (b): the steady pass raised compile events: {[s['block']['compile_events'] for s in steady]}")
    ran = set(decision["phase_ms"])
    moved = {"screen"} if any(decision["screen_bytes"].values()) else set()
    largest = 0
    for s in solves:
        ran |= {p for p, ms in s["phase_ms"].items() if ms > 0}
        moved |= {p for p, dirs in s["block"]["transfer_by_phase"].items() if sum(dirs.values()) > 0}
        largest = max(largest, s["block"]["footprint_bytes"])
        if abs(s["device_ms"] - sum(s["phase_ms"].values())) > 1e-6:
            fail(f"phase 20 (e) {s['label']}: device_ms {s['device_ms']} is not its pairs' sum {s['phase_ms']}")
    if card:
        for name in PLANE_KERNELS[:5]:
            if not launched[name]:
                fail(f"phase 20 (a): {name} never launched")
        if ran != set(PLANE_PHASES):
            fail(f"phase 20 (e): device time at {sorted(ran)}, not at every boundary {PLANE_PHASES}")
        if not ran <= moved:
            fail(f"phase 20 (c): no bytes moved at {sorted(ran - moved)}")
        high = metrics.hbm_high_water.get()
        total = torch.cuda.mem_get_info()[1]
        if high is None or not largest <= high <= total:
            fail(f"phase 20 (d): high-water mark {high} outside [{largest}, {total}]")
    else:
        high, total = None, None
        if ran:
            fail(f"phase 20 (e): device time off the card: {ran}")

    # 20d: the restart, in a fresh process
    t0 = time.perf_counter()
    tmp = workdir or tempfile.mkdtemp(prefix="phase20-")
    try:
        path = restart_solver.snapshot(directory=os.path.join(tmp, "warmstore"))
        if path is None:
            fail("phase 20d: the snapshot was not written")
        child = restart_child(path, device, decision_nodes)
        unkilled = shapes[DEVICEPLANE_RESTART_SHAPE]["sha"]
        if child["compiles"] != 0 or child["sha"] != unkilled:
            fail(f"phase 20 (f): the restored first solve raised {child['events']} and planned "
                 f"{child['sha'][:12]}, the unkilled {unkilled[:12]}")
        if child["outcome"]["dropped"] or (card and not child["outcome"]["restored"].get("compilecache")):
            fail(f"phase 20 (f): the restore gave {child['outcome']}")
        if child["decision_action"] == "no-op" or child["decision_compiles"] != 0:
            fail(f"phase 20 (f): the restored process's first decision gave {child['decision_action']} and raised "
                 f"{child['decision_compiles']} compile events ({child['recent_compiles']})")
        if card:
            # the screens' library is not on the solve path: only the
            # restored manifest brings it into the boot prewarm (through
            # the screens the snapshot's process had bound)
            if not child["decision_screens"] or not any(
                    name.startswith("disrupt.") for name in child["boot"]["libraries"]):
                fail(f"phase 20 (f): the decision launched {child['decision_screens']} screens; the boot "
                     f"prewarm loaded {child['boot']['libraries']}")
        sections["20d"] = time.perf_counter() - t0

        # 20e: the slow-solve capture and a breach dump, read back
        t0 = time.perf_counter()
        saved = (capture.SLOW_MS, capture.DIR, flightrec.SLO_BREACH_DUMP_MS)
        capture.SLOW_MS, capture.DIR, flightrec.SLO_BREACH_DUMP_MS = 0.0, os.path.join(tmp, "traces"), 0.0
        try:
            restart_solver.solve(restart_pods)
            trace = RING.last()
            rec = flightrec.FlightRecorder(capacity=4).record("phase20", 1, trace=trace, latency_ms=[1.0],
                                                               pods_decided=len(restart_pods))
        finally:
            capture.SLOW_MS, capture.DIR, flightrec.SLO_BREACH_DUMP_MS = saved
        files = sorted(os.listdir(os.path.join(tmp, "traces")))
        traces = [f for f in files if f.endswith(".trace.json")]
        breaches = [f for f in files if f.endswith(".breach.json")]
        with open(os.path.join(tmp, "traces", traces[-1])) as f:
            chrome = json.load(f)
        with open(os.path.join(tmp, "traces", breaches[-1])) as f:
            dump = json.load(f)
        if not chrome.get("traceEvents") or dump["record"]["decision_id"] != rec.decision_id or not any(
                e.get("name") == "solve" for e in dump["trace_events"]):
            fail("phase 20 (g): the capture or the breach dump does not load back")
        sections["20e"] = time.perf_counter() - t0
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)

    # 20f: one warm solve, the plane on against off, in turns
    t0 = time.perf_counter()
    catalog, turn_pods = next((c, p) for n, c, p in config10_shapes() if n == "linear-control")
    turn_provider = FakeCloudProvider()
    turn_provider.instance_types = list(catalog)
    pool = NodePool()
    pool.metadata.name = "default"
    turn_solver = TorchScheduler([pool], turn_provider, device=device)
    turn_solver.solve(turn_pods)
    times = {True: [], False: []}
    try:
        for turn in range(turns):
            for k, on in enumerate((True, False, False, True)):
                # one pod's new version: the solve runs its path, not a replay
                p = turn_pods[(4 * turn + k) % len(turn_pods)]
                p.metadata.resource_version = str(int(p.metadata.resource_version or 0) + 1)
                deviceplane.DEVICEPLANE = on
                t1 = time.perf_counter()
                turn_solver.solve(turn_pods)
                times[on].append((time.perf_counter() - t1) * 1000.0)
    finally:
        deviceplane.DEVICEPLANE = True
    on_ms, off_ms = statistics.median(times[True]), statistics.median(times[False])
    if on_ms > off_ms * 1.25 + 2.0:
        fail(f"phase 20 (h): the plane on {on_ms:.3f} ms against off {off_ms:.3f} ms")
    wrapper = wrapper_turns(pool, turn_provider, turn_pods, device, turns)
    sections["20f"] = time.perf_counter() - t0

    out = {
        "cold": {k: cold[k] for k in ("wall_ms", "device_ms", "phase_ms")} | {
            "compile_events": [(e["fn"], e["library"], e["built"]) for e in cold["block"]["compile_events"]],
            "transfer_by_phase": cold["block"]["transfer_by_phase"], "footprint_bytes": cold["block"]["footprint_bytes"],
            "hbm": cold["block"]["hbm"]},
        "steady": {k: steady[0][k] for k in ("wall_ms", "device_ms", "phase_ms")},
        "config10_lp": {name: {k: v for k, v in s.items() if k != "sha"} for name, s in shapes.items()},
        "decision": decision, "launches": launched, "traced_launches": traced,
        "libraries_loaded": [r["library"] for r in new_libs],
        "compile_events": events, "hbm_high_water": high, "card_memory": total, "largest_footprint": largest,
        "restart": {"compiles": child["compiles"], "boot": child["boot"], "restored": child["outcome"]["restored"],
                    "hits": child["hits"], "decision_action": child["decision_action"],
                    "decision_compiles": child["decision_compiles"], "decision_screens": child["decision_screens"]},
        "capture_files": len(traces), "breach_files": len(breaches),
        "plane_on_ms": on_ms, "plane_off_ms": off_ms, "turn_ms": times, "compat_wrapper_ms": wrapper,
        "transfers": {k: v - totals_before.get(k, 0) for k, v in deviceplane.totals()["transfer_bytes"].items()
                      if v - totals_before.get(k, 0)},
        "sections_s": sections, "wall_s": time.perf_counter() - t_phase,
    }
    return out


def check_process_plane() -> dict:
    """Phase 20 over the whole script's process: (b) every library the
    process loaded raised its compile event, one load per library; (c)
    bytes moved at every boundary. → the totals, with each kernel's
    launches (its own counter, which the device plane reads)."""
    from karpenter_core_tpu_torch import buildlib
    from karpenter_core_tpu_torch.tracing import deviceplane

    libs = buildlib.loaded_libraries()
    sources = [row["source"] for row in libs]
    if len(set(sources)) != len(sources) or not all(row["compile_event"] for row in libs):
        fail(f"phase 20 (b), the process: libraries and their events {libs}")
    moved = deviceplane.totals()["transfer_bytes"]
    missing = [p for p in PLANE_PHASES if not moved.get(f"h2d.{p}") or not moved.get(f"d2h.{p}")]
    if missing:
        fail(f"phase 20 (c), the process: no bytes moved at {missing}")
    return {"launches": deviceplane.launch_counts(), "libraries": [(r["library"], r["built"], r["ms"]) for r in libs],
            "transfer_bytes": moved}


def report_deviceplane_phase(dp: dict, card: str) -> None:
    """Print phase 20's lines, each with the card."""
    emit({"phase20": "20a-cluster-native-off", **{k: dp[k] for k in ("cold", "steady")}, "card": card})
    emit({"phase20": "20b-config10-lp", "shapes": dp["config10_lp"], "card": card})
    emit({"phase20": "20c-config4-decision", **dp["decision"], "card": card})
    emit({"phase20": "20d-restart", **dp["restart"], "card": card})
    emit({"phase20": "device-plane", **{k: dp[k] for k in (
        "launches", "traced_launches", "libraries_loaded", "compile_events", "hbm_high_water", "card_memory", "largest_footprint",
        "capture_files", "breach_files", "plane_on_ms", "plane_off_ms", "turn_ms", "compat_wrapper_ms", "transfers",
        "sections_s",
        "wall_s")}, "card": card})


# -- phase 21: the sharded mega-solve (bench config 12) --------------------------

# phase 21's share of SCRIPT_BUDGET_S, kept out of the budgets of the phases
# before it in its lane
SHARD_RESERVE_S = 100.0
# shardbench.py's cells (:205-222): the device sweep at the anchor (500,000
# pods x 10,000 types), the pod sweep and the type sweep at D = 8
SHARD_CELLS = (
    (500_000, 10_000, 1), (500_000, 10_000, 2), (500_000, 10_000, 4), (500_000, 10_000, 8),
    (125_000, 10_000, 8), (250_000, 10_000, 8), (1_000_000, 10_000, 8), (500_000, 2_000, 8),
)
# never cut: the anchor and the 1,000,000-pod cell (whose chunks 21b
# holds against solo launches)
SHARD_KEEP = ((500_000, 10_000, 8), (1_000_000, 10_000, 8))
SHARD_REPS = 3  # measured runs a cell, after one warm run
SHARD_SEED = 12  # shardbench.run_cell: catalog seed, pods seed + 1, masks seed + 2
SHARD_RATIO = (20_000, 10_000, 3, 8)  # shardbench's parity worlds: pods, types, seeds, shards
SHARD_SOLVE = (10_000, 400, 64)  # 21b's TorchScheduler solve: pods, types, the chunk threshold
SHARD_PLAIN_PODS = 4_096  # 21c: B5 against its plain version (a per-step loop) at D = 1 and 8
# 21c: the curve cell whose own B5 launch is held against the plain version
# (8 chunks of 15,625 pods: the plain loop's 15,625 steps)
SHARD_PLAIN_CELL = (125_000, 10_000, 8)
SHARD_SCREEN = (8, 1_000, 4)  # 21c's prefix screen: shards, candidates a shard, columns
# nodes and frontier rows of the reference's plan in each cell (BENCH_r08.json's
# config 12 curve, the JAX package on CPU host devices): plan contents the
# port's chunked pack must reproduce
CONFIG12_REFERENCE = {
    (500_000, 10_000, 1): (8923, 22), (500_000, 10_000, 2): (8925, 22), (500_000, 10_000, 4): (8925, 22),
    (500_000, 10_000, 8): (8923, 22), (125_000, 10_000, 8): (2210, 22), (250_000, 10_000, 8): (4449, 22),
    (1_000_000, 10_000, 8): (17893, 22), (500_000, 2_000, 8): (8730, 24),
}


# __graft_entry__.dryrun_multichip's sequence on the JAX package's D host
# devices (its RandomState(0) draws at D = 4 and 8): the group pack's fleet
# total, the overlap product's sum, the prefix screen's feasible rows and the
# sha256 of the pack's node ids as int32 (first 16 hex digits)
DRYRUN_REFERENCE = {
    4: {"fleet_total": 80, "overlap_sum": 33304, "feasible": 16, "ids_sha256": "061185256de59d3e"},
    8: {"fleet_total": 158, "overlap_sum": 33638, "feasible": 40, "ids_sha256": "b1fbd1bff9c16f5f"},
}


def shard_catalog(n_types: int, n_res: int, seed: int):
    """shardbench.build_catalog: ``n_types`` types from 40 proportionally
    scaled families, size-correlated prices with ±20 % jitter."""
    rng = np.random.RandomState(seed)
    fam = rng.randint(0, 40, n_types)
    base = rng.randint(4, 64, (40, n_res))
    size = (1 + rng.randint(0, 250, n_types))[:, None]
    alloc = (base[fam] * size).clip(1, 2**20).astype(np.int32)
    prices = np.round((alloc.sum(axis=1, dtype=np.int64) / 100.0) * (0.8 + 0.4 * rng.rand(n_types)), 4)
    return alloc, prices


def shard_pods(n_pods: int, n_res: int, seed: int) -> np.ndarray:
    """shardbench.build_pods."""
    return np.random.RandomState(seed).randint(1, 300, (n_pods, n_res)).astype(np.int32)


def shard_masks(n_sigs: int, n_types: int, seed: int, width: int = 64):
    """shardbench.build_masks."""
    rng = np.random.RandomState(seed)
    sig = (rng.rand(n_sigs, width) < 0.7).astype(np.float32)
    typ = (rng.rand(n_types, width) < 0.7).astype(np.float32)
    return sig, typ


def shard_world(pods: int, types: int, seed: int = SHARD_SEED) -> tuple:
    """One config-12 cell's inputs, as shardbench.run_cell makes them."""
    alloc, prices = shard_catalog(types, 4, seed)
    sig, typ = shard_masks(8, types, seed + 2)
    return shard_pods(pods, 4, seed + 1), alloc, prices, sig, typ


SHARD_CATALOG_TYPES = 10_003  # 21c's and 23's B1 catalog: a type count no shard count divides


def shard_catalog_inputs(T: int, S: int, seed: int = 22) -> tuple:
    """B1's inputs for the sharded catalog: three requirement keys of 30,
    12 and 5 values, 3 zones x 2 capacity types → (type masks, has, neg,
    offerings, signature arrays, zone_ok, ct_ok, keys)."""
    rng = np.random.RandomState(seed)
    keys = ("a", "b", "c")
    widths = {"a": 30, "b": 12, "c": 5}
    tm = {k: rng.rand(T, w) < 0.3 for k, w in widths.items()}
    th = {k: rng.rand(T) < 0.8 for k in keys}
    tn = {k: rng.rand(T) < 0.1 for k in keys}
    avail = rng.rand(T, 3, 2) < 0.6
    sig_arrays = {"valid": rng.rand(S) < 0.9}
    for k, w in widths.items():
        sig_arrays[f"mask:{k}"] = rng.rand(S, w) < 0.4
        sig_arrays[f"has:{k}"] = rng.rand(S) < 0.7
        sig_arrays[f"neg:{k}"] = rng.rand(S) < 0.1
    zone_ok, ct_ok = rng.rand(S, 3) < 0.7, rng.rand(S, 2) < 0.8
    return tm, th, tn, avail, sig_arrays, zone_ok, ct_ok, keys


def pad_types(Tp: int, tm: dict, th: dict, tn: dict, avail) -> tuple:
    """The catalog's type axis padded with zero rows to ``Tp``, as
    ``prepare_sharded_catalog`` pads it."""
    def pad(a):
        return np.concatenate([a, np.zeros((Tp - a.shape[0],) + a.shape[1:], dtype=a.dtype)])

    return ({k: pad(v) for k, v in tm.items()}, {k: pad(v) for k, v in th.items()},
            {k: pad(v) for k, v in tn.items()}, pad(avail))


class b5_events:
    """CUDA events around every launch of B5's wrapper
    (``pack.ffd_pack_batched``, as ``sharding`` calls it) inside the block,
    on the current stream of the card its tensors lie on (the current
    device left as it is) → ``ms()``, one time a launch, and
    ``by_card()`` (none off the card)."""

    def __enter__(self):
        import torch

        from karpenter_core_tpu_torch.solver import pack

        self.pack, self.real, self.pairs = pack, pack.ffd_pack_batched, []

        def spy(*args, **kw):
            dev = args[0].device
            if dev.type != "cuda":
                return self.real(*args, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            out = self.real(*args, **kw)
            end.record(torch.cuda.current_stream(dev))
            self.pairs.append((str(dev), start, end))
            return out

        pack.ffd_pack_batched = spy
        return self

    def __exit__(self, *exc):
        self.pack.ffd_pack_batched = self.real

    def ms(self) -> list:
        out = []
        for _, start, end in self.pairs:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def by_card(self) -> dict:
        out: dict = {}
        for (card, _, _), ms in zip(self.pairs, self.ms()):
            out.setdefault(card, []).append(ms)
        return out


def shard_launches() -> dict:
    """The launch counts of the kernels phase 21's paths run."""
    from karpenter_core_tpu_torch.disruption import screen_kernels as sk
    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import pack

    return {"ffd_pack": pack.FFD_PACK.launches, "compat_allowed": ck.COMPAT_ALLOWED.launches,
            "disrupt_screen.prefix": sk.SCREEN_PREFIX.launches}


def launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in shard_launches().items()}


def check_mega(label: str, out: dict, reqs: np.ndarray, alloc: np.ndarray, phase: str = "21") -> None:
    """Every pod scheduled, every node's usage within its chosen type."""
    from karpenter_core_tpu_torch.solver import pack

    if out.get("error") or out["scheduled"] != len(reqs):
        fail(f"phase {phase} {label}: {out.get('error')}, {out['scheduled']} of {len(reqs)} pods scheduled")
    usage = pack.node_usage_from_assignment(np.ascontiguousarray(reqs[out["node_order"]]), out["node_ids"],
                                            out["nodes"])
    if len(out["chosen_types"]) != out["nodes"] or not np.all(usage <= alloc[out["chosen_types"]]):
        fail(f"phase {phase} {label}: a node's usage exceeds its chosen type")


def shard_cell(device: str, pods: int, types: int, D: int, reps: int, warm: bool = True,
               hold: bool = False, devices=None, phase: str = "21", hold_at: int = 0) -> tuple:
    """One config-12 cell: a warm run (unless ``warm`` is False), then ``reps`` measured ones, each
    in a device-time scope and a device-plane accumulator of its own (a
    mega-solve runs outside any solve), B5 timed by events around each
    launch. The mesh is D shards on ``device``, or over ``devices`` (its
    placements: one B5 launch each). With ``hold``, the first run's B5
    arguments (placement ``hold_at``'s launch) and node ids are kept for
    21c and 23. → (the row: the median run's
    wall and stages, nodes, pods/s, the shard stats, B5 ms (the longest
    launch's) and each card's, the shard boundary's device ms (its
    longest card's), each card's and its bytes; the last result and its
    inputs; the held launch or None)."""
    from karpenter_core_tpu_torch.solver import devicetime, pack, sharding
    from karpenter_core_tpu_torch.tracing import deviceplane

    reqs, alloc, prices, sig, typ = shard_world(pods, types)
    mesh = sharding.make_mesh(D, device=device) if devices is None else sharding.make_mesh(D, devices=devices)
    launches = len(mesh.placements)
    held = None

    def solve():
        nonlocal held
        if not hold or held is not None:
            return sharding.sharded_mega_solve(mesh, reqs, alloc, prices, sig, typ)
        with capture(pack, "ffd_pack_batched") as seen:
            out = sharding.sharded_mega_solve(mesh, reqs, alloc, prices, sig, typ)
        held = (seen.calls[hold_at], out["node_ids"], out["nodes"])
        return out

    if warm:
        solve()
    runs = []
    label = f"{pods}x{types} D={D}" + (f" over {len(mesh.cards)} cards" if len(mesh.cards) > 1 else "")
    for _ in range(reps):
        deviceplane.reset_solve()
        with b5_events() as ev, devicetime.scope(device) as clock:
            out = solve()
        plane = deviceplane.consume_solve()
        moved = plane["transfer_by_phase"].get("shard", {}) if plane else {}
        runs.append((out, ev.ms(), clock.phase_ms().get("shard", 0.0), moved, ev.by_card(), clock.card_ms()))
        check_mega(label, out, reqs, alloc, phase)
        if not moved.get("h2d") or not moved.get("d2h"):
            fail(f"phase {phase} {label}: the shard boundary moved no bytes ({moved})")
        if device == "cuda" and (len(runs[-1][1]) != launches or runs[-1][2] <= 0.0):
            fail(f"phase {phase} {label}: B5 launched {len(runs[-1][1])} times for {launches} placements, "
                 f"shard device ms {runs[-1][2]}")
    out, b5_ms, shard_ms, moved, b5_cards, shard_cards = sorted(runs, key=lambda r: r[0]["wall_ms"])[len(runs) // 2]
    want = CONFIG12_REFERENCE.get((pods, types, D))
    if want is not None and (out["nodes"], out["frontier_rows"]) != want:
        fail(f"phase {phase} {label}: {out['nodes']} nodes, {out['frontier_rows']} frontier rows; the reference's "
             f"plan has {want}")
    row = {
        "pods": pods, "types": types, "n_devices": D, "reps": reps, "warm": warm, "wall_ms": out["wall_ms"],
        **{k: out[k] for k in ("compat_ms", "prep_ms", "pack_ms", "assign_ms", "nodes", "scheduled",
                               "frontier_rows", "viable_types", "total_price", "shard")},
        "pods_per_s": round(pods / (out["wall_ms"] / 1000.0), 1) if out["wall_ms"] else 0.0,
        "b5_ms": max(b5_ms) if b5_ms else None, "b5_ms_runs": [max(r[1]) if r[1] else None for r in runs],
        "shard_device_ms": shard_ms if device == "cuda" else None, "shard_bytes": moved,
        "wall_ms_runs": [r[0]["wall_ms"] for r in runs],
    }
    if len(mesh.placements) > 1:
        row.update(placements=[str(d) for d in mesh.placements], b5_ms_by_card=b5_cards,
                   shard_device_ms_by_card=shard_cards or None, reference_record=want is not None)
    return row, (reqs, alloc, prices, sig, typ, runs[-1][0]), held


def shard_unchunked_ratio(device: str, pods: int, types: int, seeds: int, D: int) -> dict:
    """shardbench.run_parity's ratio on the card: on its worlds, one FFD
    scan of all pods over the whole catalog's frontier against the
    chunked plan's nodes at D shards. (Its engine parity is one launch on
    one card, held against the JAX package by the CPU tests.)"""
    import torch

    from karpenter_core_tpu_torch.solver import pack, sharding
    from karpenter_core_tpu_torch.solver.backend import resolve_device

    dev = resolve_device(device)
    mesh = sharding.make_mesh(D, device=device)
    ratios = []
    for seed in range(seeds):
        alloc, prices = shard_catalog(types, 4, 100 + seed)
        reqs = shard_pods(pods, 4, 200 + seed)
        sig, typ = shard_masks(8, types, 300 + seed)
        a = sharding.sharded_mega_solve(mesh, reqs, alloc, prices, sig, typ)
        check_mega(f"ratio D={D} seed {seed}", a, reqs, alloc)
        order = np.lexsort((-reqs[:, 1], -reqs[:, 0]))
        frontier = pack.pareto_frontier(alloc.astype(np.int32))
        _, n_ref = pack.ffd_pack(torch.from_numpy(np.ascontiguousarray(reqs[order])).to(dev),
                                 torch.from_numpy(frontier).to(dev), int(pack.INT_INF))
        ratios.append(int(n_ref) / a["nodes"])
    return {"pods": pods, "types": types, "n_devices": D, "seeds": seeds,
            "unchunked_node_ratio_min": round(min(ratios), 4)}


def chunk_identity(device: str, reqs, alloc, sig, typ, out: dict, D: int) -> dict:
    """21b at full size: the chunked launch's ids equal D solo ``ffd_pack``
    launches, one on each chunk, renumbered, and the mega-solve's own."""
    import torch

    from karpenter_core_tpu_torch.solver import pack, sharding

    viable = ((sig @ typ.T) > 0.0).all(axis=0)
    frontier = pack.pareto_frontier(np.ascontiguousarray(alloc[np.flatnonzero(viable)], dtype=np.int32))
    s = np.ascontiguousarray(reqs[np.lexsort((-reqs[:, 1], -reqs[:, 0]))], dtype=np.int32)
    mesh = sharding.make_mesh(D, device=device)
    gids, n = sharding.sharded_pod_pack(mesh, s, frontier, pack.INT_INF)
    sharding.reset_shard_stats()
    Pc = -(-len(s) // D)
    front = torch.from_numpy(frontier).to(mesh.device)
    solo, offset = [], 0
    for d in range(D):
        ids, cnt = pack.ffd_pack(torch.from_numpy(s[d * Pc:(d + 1) * Pc]).to(mesh.device), front, int(pack.INT_INF))
        ids = ids.cpu().numpy()
        solo.append(np.where(ids >= 0, ids + offset, -1))
        offset += int(cnt)
    solo_ids = np.concatenate(solo).astype(np.int32)
    if not (np.array_equal(solo_ids, gids) and offset == n and np.array_equal(gids, out["node_ids"])):
        fail(f"phase 21b: the chunked launch at {len(s)} pods, D={D}, differs from {D} solo launches")
    return {"pods": len(s), "n_devices": D, "chunk_len": Pc, "nodes": n, "solo_launches": D, "identical": True}


def shard_solve_world(n_pods: int, n_types: int, seed: int = SHARD_SEED):
    """21b's solve: one pool over ``instance_types(n_types)`` and pods of
    tests/test_sharding.py::TestIntegratedMegaShardSolve's request mix."""
    from karpenter_core_tpu_torch.apis.nodepool import NodePool
    from karpenter_core_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_core_tpu_torch.kube import objects as ob
    from karpenter_core_tpu_torch.kube.quantity import parse_quantity as pq

    provider = FakeCloudProvider()
    provider.instance_types = instance_types(n_types)
    pool = NodePool()
    pool.metadata.name = "default"
    rng = np.random.RandomState(seed)
    pods = []
    for i in range(n_pods):
        pod = ob.Pod()
        pod.metadata.name = f"mega-{i}"
        requests = {"cpu": pq(["250m", "500m", "1", "2"][rng.randint(4)]),
                    "memory": pq(["512Mi", "1Gi", "2Gi"][rng.randint(3)])}
        pod.spec = ob.PodSpec(containers=[ob.Container(name="main", resources=ob.ResourceRequirements(requests=requests))])
        pods.append(pod)
    return [pool], provider, pods


@contextlib.contextmanager
def shard_mesh(D: int, device: str, engine: str, min_pods: int, devices=None):
    """The sharding seam for a block: a D-shard mesh on ``device`` (or over
    the placements ``devices``) installed, the chunk engine and threshold
    set, all restored after."""
    from karpenter_core_tpu_torch.solver import sharding

    saved = (sharding.SHARD_ENGINE, sharding.SHARD_MIN_PODS)
    mesh = sharding.make_mesh(D, device=device) if devices is None else sharding.make_mesh(D, devices=devices)
    prev = sharding.install_mesh(mesh)
    sharding.SHARD_ENGINE, sharding.SHARD_MIN_PODS = engine, min_pods
    try:
        yield
    finally:
        sharding.install_mesh(prev)
        sharding.SHARD_ENGINE, sharding.SHARD_MIN_PODS = saved


def shard_solve(device: str, n_pods: int, n_types: int, min_pods: int, devices=None) -> dict:
    """21b: ``TorchScheduler.solve`` on an 8-shard mesh with the chunk
    threshold at ``min_pods`` (C++ packer off, cold pipeline) reaches the
    mega branch; its plan equals the CPU's on an 8-shard CPU mesh, and
    ``last_shard_stats`` and the padding gauge are set. ``devices``: the
    card leg's mesh spans these placements (23b), the solver on the
    first."""
    from karpenter_core_tpu_torch.metrics import Metrics
    from karpenter_core_tpu_torch.solver import TorchScheduler, sharding

    rows, streams = {}, {}
    with knobs(KARPENTER_TORCH_NATIVE=0, KARPENTER_TORCH_INCREMENTAL=0):
        legs = [(device, "sharded")] + ([("cpu", "sharded")] if device != "cpu" else [])
        for dev, engine in legs:
            pools, provider, pods = shard_solve_world(n_pods, n_types)
            metrics = Metrics()
            over = devices if dev == device else None
            with shard_mesh(8, dev, engine, min_pods, over), timed(sharding, "sharded_pod_pack") as mega:
                solver = TorchScheduler(pools, provider, device=over[0] if over else dev, metrics=metrics)
                t0 = time.perf_counter()
                res = solver.solve(pods)
                ms = (time.perf_counter() - t0) * 1000.0
            label = f"{dev}-{engine}"
            stats = solver.last_shard_stats
            gauge = {axis: metrics.shard_padding_waste.get(axis=axis) for axis in ("pods", "types")}
            if mega.n == 0 or not stats or stats.get("engine") != engine or None in gauge.values():
                fail(f"phase 21b solve {label}: mega packs {mega.n}, stats {stats}, gauge {gauge}")
            if res.pods_scheduled != n_pods:
                fail(f"phase 21b solve {label}: {res.pods_scheduled} of {n_pods} pods scheduled")
            streams[label] = plan_stream(res)
            rows[label] = {"solve_ms": ms, "mega_packs": mega.n, "nodes": res.node_count,
                           "total_price": round(res.total_price, 4), "shard": stats, "gauge": gauge,
                           "device_phase_ms": solver.last_device_phase_ms}
    first = streams[f"{device}-sharded"]
    if any(s != first for s in streams.values()):
        fail(f"phase 21b solve: plans differ across {sorted(streams)}")
    return {"pods": n_pods, "types": n_types, "min_pods": min_pods, "legs": rows, "plans_equal": sorted(streams)}


def shard_dryrun(device: str, D: int = 8, devices=None) -> dict:
    """21d: ``__graft_entry__.dryrun_multichip``'s sequence on a D-shard
    mesh of one card, or over ``devices`` (23b): the group-sharded pack
    and its fleet total, the type-sharded overlap product, the sharded
    prefix screen; where ``DRYRUN_REFERENCE`` has D, each held to the
    JAX package's numbers on D host devices."""
    import torch

    from karpenter_core_tpu_torch.solver import sharding

    mesh = sharding.make_mesh(D, device=device) if devices is None else sharding.make_mesh(D, devices=devices)
    rng = np.random.RandomState(0)
    G, P, R, F = 2 * D, 64, 4, 4
    requests = rng.randint(1, 1000, size=(G, P, R)).astype(np.int32)
    requests[..., 2] = 1
    frontiers = np.broadcast_to(np.array([[4000, 4000, 16, 4000]] * F, dtype=np.int32), (G, F, R)).copy()
    caps = np.full(G, 1 << 30, dtype=np.int32)
    ids, counts, fleet_total = sharding.sharded_batch_pack(mesh, *(torch.from_numpy(a) for a in (requests, frontiers, caps)))
    if int(fleet_total) != int(counts.sum()) or tuple(ids.shape) != (G, P):
        fail(f"phase 21d: fleet total {int(fleet_total)} against counts {counts.tolist()}")
    S, T, W = 16, 64, 128
    sig = (rng.rand(S, W) > 0.5).astype(np.float32)
    typ = (rng.rand(T, W) > 0.5).astype(np.float32)
    overlap = sharding.sharded_compat(mesh, sig, typ)
    if not np.array_equal(overlap.cpu().numpy(), sig @ typ.T):
        fail("phase 21d: the sharded overlap product differs from the host matmul")
    N = D * 8
    loads = rng.randint(1, 50, size=(N, R)).astype(np.int32)
    free = rng.randint(0, 40, size=(N, R)).astype(np.int32)
    fleet_local = rng.randint(0, 100, size=(D, R)).astype(np.int32)
    cap = np.array([200, 200, 16, 200], dtype=np.int32)
    feasible = sharding.sharded_prefix_screen(mesh, loads, free, fleet_local, cap)
    if tuple(feasible.shape) != (N,):
        fail(f"phase 21d: the prefix screen gave {tuple(feasible.shape)}")
    got = {"fleet_total": int(fleet_total), "overlap_sum": int(overlap.sum()), "feasible": int(feasible.sum()),
           "ids_sha256": hashlib.sha256(ids.cpu().numpy().astype(np.int32).tobytes()).hexdigest()[:16]}
    want = DRYRUN_REFERENCE.get(D)
    if want is not None and got != want:
        fail(f"phase 21d on {[str(d) for d in mesh.placements]}: {got}, the JAX package on {D} devices gives {want}")
    return {"groups": G, "overlap": [S, T], "screen_candidates": N, "n_devices": D,
            "placements": [str(d) for d in mesh.placements], "reference_held": want is not None, **got}


def shard_screen_inputs(D: int, per: int, R: int, seed: int = 21):
    """A fleet's prefix screen over D candidate shards, every partial sum
    below 2^24."""
    rng = np.random.RandomState(seed)
    N = D * per
    loads = rng.randint(1, 50, (N, R)).astype(np.int32)
    free = rng.randint(0, 40, (N, R)).astype(np.int32)
    fleet_local = rng.randint(0, 40 * per, (D, R)).astype(np.int32)
    cap = rng.randint(50, 200, R).astype(np.int32)
    return loads, free, fleet_local, cap


def shard_plain_cases(device: str, sm_mhz: float, held=None) -> dict:
    """21c, against the plain versions on the card (these launches are not
    the path's): B5 as ``sharded_pod_pack`` at D ∈ {1, 8} on
    ``SHARD_PLAIN_PODS`` pods of config 12's world, on ``held`` (the
    arguments of one of 21a's own launches, whose renumbered plain ids
    must equal that run's node ids, all of them) and as the dryrun's
    ``sharded_batch_pack``; B1 as ``allowed_sharded`` over a catalog of
    10,003 types padded to 8 shards; B8's prefix screen as
    ``sharded_prefix_screen``; ``sharded_compat`` (a ``torch.matmul``) at
    config 12's masks. Each bit-equal, and the port on the CPU gives the
    same ids and rows."""
    import torch

    from karpenter_core_tpu_torch.disruption import screen_kernels as sk
    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import pack, sharding

    cases = {"sharded_pod_pack": [], "sharded_batch_pack": [], "allowed_sharded": [], "sharded_prefix_screen": [],
             "sharded_compat": []}
    reqs, alloc, prices, sig, typ = shard_world(SHARD_PLAIN_PODS, 10_000)
    for D in (1, 8):
        with capture(pack, "ffd_pack_batched") as cap_calls:
            card = sharding.sharded_mega_solve(sharding.make_mesh(D, device=device), reqs, alloc, prices, sig, typ)
        cpu = sharding.sharded_mega_solve(sharding.make_mesh(D, device="cpu"), reqs, alloc, prices, sig, typ)
        if not np.array_equal(card["node_ids"], cpu["node_ids"]):
            fail(f"phase 21c: sharded_pod_pack at {SHARD_PLAIN_PODS} pods, D={D}: card ids differ from the CPU's")
        cases["sharded_pod_pack"].append({"n_devices": D, "cpu_equal": True, **ffd_kernel_case(cap_calls.calls[0])})
    if held is not None:
        call, gids, nodes = held

        def same_ids(plain_ids, plain_counts):
            counts = plain_counts.cpu().numpy().astype(np.int64)
            offsets = np.concatenate([[0], np.cumsum(counts[:-1])])
            ids = plain_ids.cpu().numpy()
            mine = np.where(ids >= 0, ids + offsets[:, None], -1).reshape(-1)[: len(gids)]
            if not (np.array_equal(mine, gids) and int(counts.sum()) == nodes):
                fail(f"phase 21c: the plain B5 on 21a's launch at {len(gids)} pods gives other node ids")

        t0 = time.perf_counter()
        row = ffd_kernel_case(call, check=same_ids)
        cases["sharded_pod_pack"].append({"n_devices": call[0].shape[0], "main_path": True, "ids_equal": True,
                                          "case_s": time.perf_counter() - t0, **row})
    with capture(pack, "ffd_pack_batched") as cap_calls:
        shard_dryrun(device)
    req, front, caps, k_open, n = cap_calls.calls[0]
    if n is None:  # sharded_batch_pack's groups carry no padding: every pod is real
        n = torch.full((req.shape[0],), req.shape[1], dtype=torch.int32)
    cases["sharded_batch_pack"].append({"n_devices": 8, **ffd_kernel_case((req, front, caps, k_open, n))})

    # B1 over the padded catalog
    T, S = SHARD_CATALOG_TYPES, 8
    tm, th, tn, avail, sig_arrays, zone_ok, ct_ok, keys = shard_catalog_inputs(T, S)
    out = {}
    for dev in (device, "cpu"):
        prepared = sharding.prepare_sharded_catalog(sharding.make_mesh(8, device=dev), tm, th, tn, avail)
        out[dev] = (prepared, sharding.allowed_sharded(prepared, sig_arrays, zone_ok, ct_ok, keys))
    sharding.reset_shard_stats()
    (sharded, _), got = out[device]
    catalog = sharded.catalogs[0]  # one placement: the whole padded catalog
    planes = ck.signature_side(sig_arrays, zone_ok, ct_ok, catalog, keys=keys)
    t0 = time.perf_counter()
    want = ck.allowed_packed_reference(planes, catalog.planes, catalog.layout)[:, :T]
    _sync(device)
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if not (torch.equal(got, want) and np.array_equal(got.cpu().numpy(), out["cpu"][1].numpy())):
        fail("phase 21c: allowed_sharded differs from its plain version or the CPU's")
    Wd, Tp = catalog.planes.shape
    library_ms = None
    if device == "cuda":
        # the same function at the padded shape (S x Tp) as B1's library
        # yardstick: per-key fp16 torch.matmul calls
        half = library_half(keys, sig_arrays, *pad_types(Tp, tm, th, tn, avail), zone_ok, ct_ok, catalog.device)
        if not torch.equal(library_allowed(half, keys)[:, :T], want):
            fail("phase 21c: the library yardstick differs from allowed_sharded")
        library_ms = median_ms(lambda: library_allowed(half, keys), 20)
    cases["allowed_sharded"].append({
        "S": S, "T": T, "T_padded": Tp, "W": Wd, "max_abs_err": 0, "cpu_equal": True, "plain_ms": plain_ms,
        "kernel_ms": events_ms(lambda: ck.allowed_via_kernel(planes, catalog), 20) if device == "cuda" else None,
        "wrapper_ms": events_ms(lambda: sharding.allowed_sharded(out[device][0], sig_arrays, zone_ok, ct_ok, keys), 20)
        if device == "cuda" else None,
        "library_ms": library_ms, **bound_row(Wd * (S + Tp) * 4 + S * T, 2 * S * Tp * Wd),
    })

    # B8's prefix screen over 8 candidate shards
    D, per, R = SHARD_SCREEN
    loads, free, fleet_local, capv = shard_screen_inputs(D, per, R)
    mesh = sharding.make_mesh(D, device=device)
    on_card = tuple(torch.from_numpy(a).to(mesh.device) for a in (loads, free, fleet_local, capv))
    got = sharding.sharded_prefix_screen(mesh, *on_card)
    args = tuple(torch.from_numpy(a).to(mesh.device) for a in (loads, free, fleet_local.sum(axis=0).astype(np.int32), capv))
    t0 = time.perf_counter()
    want = sk.prefix_screen_reference(*args)
    _sync(device)
    plain_ms = (time.perf_counter() - t0) * 1000.0
    cpu = sharding.sharded_prefix_screen(sharding.make_mesh(D, device="cpu"), loads, free, fleet_local, capv)
    if not (torch.equal(got, want) and torch.equal(got.cpu(), cpu)):
        fail("phase 21c: sharded_prefix_screen differs from its plain version or the CPU's")
    N = D * per
    max_sum = float(max(loads.astype(np.float64).sum(0).max(), free.astype(np.float64).sum(0).max()))
    cases["sharded_prefix_screen"].append({
        "n_devices": D, "N": N, "R": R, "max_abs_err": 0, "cpu_equal": True, "true_rows": int(got.sum()),
        "max_partial_sum": max_sum, "above_2_24": max_sum >= 2.0**24, "plain_ms": plain_ms,
        "kernel_ms": events_ms(lambda: sk.screen_prefix(*args), 20) if device == "cuda" else None,
        "wrapper_ms": events_ms(lambda: sharding.sharded_prefix_screen(mesh, *on_card), 20) if device == "cuda" else None,
        "library_ms": events_ms(lambda: _screen_formula_library("prefix", args), 20) if device == "cuda" else None,
        "chain_ms": N * FADD_CYCLES / (sm_mhz * 1e3) if sm_mhz else None,
        **bound_row(2 * N * R * 4 + D * R * 4 + R * 4 + N, 6 * N * R),
    })

    # the type-sharded overlap product at config 12's masks
    Tc = 10_000
    sig8, typ8 = shard_masks(8, Tc, SHARD_SEED + 2)
    mesh = sharding.make_mesh(8, device=device)
    q, m = (torch.from_numpy(a).to(mesh.device) for a in (sig8, typ8))
    got = sharding.sharded_compat(mesh, q, m)
    t0 = time.perf_counter()
    host = sig8 @ typ8.T
    host_ms = (time.perf_counter() - t0) * 1000.0
    if not np.array_equal(got.cpu().numpy(), host):
        fail("phase 21c: sharded_compat differs from the host matmul")
    Sq, Wq = sig8.shape
    cases["sharded_compat"].append({
        "S": Sq, "T": Tc, "W": Wq, "max_abs_err": 0, "host_ms": host_ms,
        "ms": events_ms(lambda: sharding.sharded_compat(mesh, q, m), 20) if device == "cuda" else None,
        **bound_row((Sq * Wq + Tc * Wq + Sq * Tc) * 4, 2 * Sq * Tc * Wq),
    })
    return cases


def run_shard_phase(device: str = "cuda", cells=SHARD_CELLS, keep=SHARD_KEEP, reps: int = SHARD_REPS,
                    ratio=SHARD_RATIO, solve=SHARD_SOLVE, budget_s: float = SHARD_RESERVE_S,
                    sm_mhz: float = 0.0, plain_cell=SHARD_PLAIN_CELL) -> dict:
    """Phase 21, bench config 12 on ``device``: 21a the curve (each cell
    warm once, then ``reps`` measured runs; with ``budget_s`` under
    ``SHARD_RESERVE_S``, or past 60 % of it, a cell outside ``keep`` runs
    once, unwarmed, and ``cuts`` says so); 21b the unchunked node ratio,
    the full-size chunk identity at the largest cell, the integrated
    solve on an 8-shard mesh; 21d the dryrun's sequence. The launches
    from just before 21a to just after 21d are the path's; 21c holds each
    kernel against its plain version afterwards (on the card only),
    ``plain_cell``'s own first launch among them. → the phase's row."""
    t0 = time.perf_counter()
    sections = {}
    before = shard_launches()
    curve, cuts, big, held = [], [], None, None
    for pods, types, D in cells:
        late = budget_s < SHARD_RESERVE_S or time.perf_counter() - t0 >= 0.6 * budget_s
        cut = (pods, types, D) not in keep and late
        if cut:
            cuts.append(f"{pods}x{types} D={D}: 1 measured run, no warm run")
        hold = device == "cuda" and (pods, types, D) == plain_cell
        row, inputs, kept = shard_cell(device, pods, types, D, 1 if cut else reps, warm=not cut, hold=hold)
        held = kept or held
        curve.append(row)
        if D == max(c[2] for c in cells) and (big is None or pods > big[0]):
            big = (pods, D, inputs)
    curve_launches = launch_delta(before)
    want = sum(int(r["warm"]) + r["reps"] for r in curve)
    if curve_launches["ffd_pack"] != (want if device == "cuda" else 0):
        fail(f"phase 21a: B5 launched {curve_launches['ffd_pack']} times over {want} mega-solves")
    sections["21a"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    mark = shard_launches()
    unchunked = shard_unchunked_ratio(device, *ratio)
    ratio_launches = launch_delta(mark)
    mark = shard_launches()
    solved = shard_solve(device, *solve)
    solve_launches = launch_delta(mark)
    sections["21b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    mark = shard_launches()
    dry = shard_dryrun(device)
    dry_launches = launch_delta(mark)
    sections["21d"] = time.perf_counter() - t1
    launches = {"phase21a": curve_launches, "phase21b-ratio": ratio_launches, "phase21b-solve": solve_launches,
                "phase21d": dry_launches}
    if device == "cuda":
        for path, kernel in (("phase21a", "ffd_pack"), ("phase21b-ratio", "ffd_pack"), ("phase21b-solve", "ffd_pack"),
                             ("phase21b-solve", "compat_allowed"), ("phase21d", "ffd_pack"),
                             ("phase21d", "disrupt_screen.prefix")):
            if not launches[path][kernel]:
                fail(f"phase 21 {path}: {kernel} never launched ({launches[path]})")
    elif any(n for counts in launches.values() for n in counts.values()):
        fail(f"phase 21 on the CPU launched a kernel: {launches}")
    t1 = time.perf_counter()
    pods, D, (reqs, alloc, _, sig, typ, out) = big
    identity = chunk_identity(device, reqs, alloc, sig, typ, out, D)
    sections["21b-identity"] = time.perf_counter() - t1
    cases = {}
    if device == "cuda":
        t1 = time.perf_counter()
        if held is None:
            fail(f"phase 21c: the curve ran no {plain_cell} cell to hold against the plain B5")
        cases = shard_plain_cases(device, sm_mhz, held)
        sections["21c"] = time.perf_counter() - t1
    return {"curve": curve, "cuts": cuts, "unchunked": unchunked, "chunk_identity": identity, "solve": solved, "dryrun": dry,
            "launches": launches, "cases": cases, "sections_s": sections, "wall_s": time.perf_counter() - t0}


def report_shard_phase(sh: dict, card: str) -> None:
    """Print phase 21's lines, each with the card."""
    for row in sh["curve"]:
        emit({"phase21a_cell": f"{row['pods']}x{row['types']} D={row['n_devices']}", **row, "card": card})
    emit({"phase21b": "unchunked-ratio", **sh["unchunked"], "card": card})
    emit({"phase21b": "chunk-identity", **sh["chunk_identity"], "card": card})
    emit({"phase21b": "solve", **sh["solve"], "card": card})
    emit({"phase21d": "dryrun", **sh["dryrun"], "card": card})
    for name, rows in sh["cases"].items():
        for r in rows:
            emit({"phase21c_case": name, **r, "card": card})
    anchor = next((r for r in sh["curve"] if (r["pods"], r["types"], r["n_devices"]) == SHARD_KEEP[0]), None)
    emit({"phase21": "config12", "cuts": sh["cuts"], "launches": sh["launches"], "sections_s": sh["sections_s"],
          "wall_s": sh["wall_s"], "anchor_wall_ms": anchor and anchor["wall_ms"],
          "unchunked_node_ratio_min": sh["unchunked"]["unchunked_node_ratio_min"], "card": card})


# -- phase 23: the mesh across cards ------------------------------------------------

# 23a, in the default run on its one card: a config-12 cell whose D shards are
# D placements of that card (D launches), against phase 21's one placement
# holding the D shards (one launch)
CARDS_CELL = (125_000, 10_000, 4)
CARDS_REPS = 3  # measured runs a cell, after one warm run
CARDS_PLAIN_PODS = 4_096  # each placement's B5 launch against its plain version: P / D pods a launch
CARDS_SCREEN = (1_000, 4)  # the prefix screen: candidates a shard, columns
# 23b, ``--phases 23 --cards N``: bench config 12 at full width across the
# cards, (pods, types, shards, cards); two shards a card at D = 8. The cells
# at D = 4 and 2 on 500,000 pods and at D = 8 on 1,000,000 have the
# reference's record; each is held to the one-card mesh of its D
CARDS_CELLS = (
    (500_000, 10_000, 2, 2), (500_000, 10_000, 4, 4), (500_000, 10_000, 8, 4),
    (1_000_000, 10_000, 4, 4), (1_000_000, 10_000, 8, 4),
)
CARDS_SOLVE = (10_000, 400, 64)  # 23b's 8-shard TorchScheduler solve across the cards, as 21b's
# 23b's solves on the second card alone: the cluster (pods, types, nodes), bench
# config 5 under lp (pods, types), bench config 4's consolidation (nodes)
CARDS_OTHER = {"cluster": (10_000, 2_000, 300), "config5": (2_000, 512), "config4": 1_000}
# 23b's solves under the default mesh (``auto``, none installed) against the
# one-card path: a serving-sized world (21b's pods over 96 types) and the
# cluster; each mode with the solve pipeline's memo on (the default) and off
# (every solve's compat launched), a cold solve then ``CARDS_AUTO_REPS``
CARDS_AUTO = {"serving": (400, 96), "cluster": CARDS_OTHER["cluster"]}
CARDS_AUTO_REPS = 3
# 23a's seconds at full depth, its plain B5 at 31,250 pods among them:
# kept out of phase 21's budget
CARDS_RESERVE_S = 60.0


def card_names(n: int) -> list:
    return [f"cuda:{i}" for i in range(n)]


def cards_delta(before: dict) -> dict:
    """Every kernel's launches since ``disrupt_launches()`` gave ``before``."""
    return {k: v - before[k] for k, v in disrupt_launches().items()}


def hold_call(kind: str, call, dev) -> dict:
    """One captured call of a kernel's wrapper replayed on ``dev`` with
    the current device left as it is, against its plain version on
    ``dev``, bit for bit → its shape and plain ms."""
    import torch

    from karpenter_core_tpu_torch.disruption import screen_kernels as sk
    from karpenter_core_tpu_torch.solver import pack
    from karpenter_core_tpu_torch.solver.backends import lp

    args = tuple(a.to(dev) if hasattr(a, "to") else a for a in call)
    t0 = time.perf_counter()
    if kind == "ffd_pack":
        req, front, caps, k_open, n = args
        if n is None:
            n = torch.full((req.shape[0],), req.shape[1], dtype=torch.int32, device=dev)
        got = pack.ffd_pack_batched(req, front, caps, k_open, n)
        t0 = time.perf_counter()
        m = int(n.max())
        ids, counts = pack.ffd_pack_reference(req[:, :m], front, caps, k_open)
        want = (torch.nn.functional.pad(ids, (0, req.shape[1] - m), value=-1), counts)
        G, P, R = req.shape
        F, pods = front.shape[1], int(n.sum())
        # as ffd_kernel_case counts it
        shape = {"G": G, "P": P, "F": F, "R": R, "longest_job": m,
                 **bound_row(pods * R * 4 + G * F * R * 4 + pods * 4 + G * 8, pods * (k_open + 1) * F * R)}
    elif kind == "pack_existing":
        got = pack.pack_existing(*args)
        t0 = time.perf_counter()
        want = pack.pack_existing_reference(*args)
        shape = {"P": args[0].shape[0], "M": args[3].shape[0]}
    elif kind == "dual_ascent":
        got = lp.dual_ascent(*args)
        t0 = time.perf_counter()
        want = lp.dual_ascent_reference(*args)
        shape = {"S": args[0].shape[0], "T": args[2].shape[0], "iters": args[6]}
    else:
        got = getattr(sk, f"screen_{kind}")(*args)
        t0 = time.perf_counter()
        want = getattr(sk, {"prefix": "prefix", "subsets": "subset", "singles": "single"}[kind]
                       + "_screen_reference")(*args)
        shape = {"N": args[-4].shape[0], "R": args[-4].shape[1]}
        got, want = (got,), (want,)
    plain_ms = (time.perf_counter() - t0) * 1000.0
    if any(g.device != torch.device(dev) for g in got):
        fail(f"phase 23: {kind} on {dev} left its result on {[str(g.device) for g in got]}")
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"phase 23: {kind} on {dev} differs from its plain version at {shape}")
    return {"kernel": kind, "card": str(dev), **shape, "max_abs_err": 0, "plain_ms": plain_ms}


def held_path_b5(held: tuple, dev) -> dict:
    """The main path's own B5 launch (``shard_cell``'s held call: one
    placement's of the cell's first run) against its plain version on
    ``dev``, its card, bit for bit; on the card with the kernel's ms
    (events on its stream)."""
    import torch

    from karpenter_core_tpu_torch.solver import pack

    row = {**hold_call("ffd_pack", held[0], dev), "launch": "path"}
    if torch.device(dev).type == "cuda":
        args = [a.to(dev) for a in held[0][:3]] + [held[0][3], held[0][4].to(dev)]
        with torch.cuda.device(dev):
            row["kernel_ms"] = events_ms(lambda: pack.ffd_pack_batched(*args), 3)
    return row


def cards_held(mesh) -> dict:
    """Each placement's B1, B5 and B8 launch against its plain version on
    its card, bit for bit (these launches are not the path's): B5 through
    ``sharded_mega_solve`` at ``CARDS_PLAIN_PODS`` pods of config 12's
    world, B1 through ``allowed_sharded`` over 21c's catalog, B8 through
    ``sharded_prefix_screen``; each card's kernel ms (events on its
    stream), the one-placement mesh's gathered results equal to these,
    the gather's ms and bytes where the mesh spans cards, and B1's
    library yardstick at the padded shape."""
    import torch

    from karpenter_core_tpu_torch.disruption import screen_kernels as sk
    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import pack, sharding

    D = mesh.size
    one = sharding.make_mesh(D, device=str(mesh.device))
    rows = {"b5": [], "b1": [], "b8": []}
    reqs, alloc, prices, sig, typ = shard_world(CARDS_PLAIN_PODS, 10_000)
    with capture(pack, "ffd_pack_batched") as calls:
        got = sharding.sharded_mega_solve(mesh, reqs, alloc, prices, sig, typ)
    want = sharding.sharded_mega_solve(one, reqs, alloc, prices, sig, typ)
    if not np.array_equal(got["node_ids"], want["node_ids"]) or len(calls.calls) != len(mesh.placements):
        fail(f"phase 23 held: {len(calls.calls)} B5 launches over {len(mesh.placements)} placements, ids equal "
             f"{np.array_equal(got['node_ids'], want['node_ids'])}")
    for dev, call in zip(mesh.placements, calls.calls):
        row = {**hold_call("ffd_pack", call, dev), "launch": "replay"}
        args = [a.to(dev) for a in call[:3]] + [call[3], call[4].to(dev)]
        with torch.cuda.device(dev):
            row["kernel_ms"] = events_ms(lambda: pack.ffd_pack_batched(*args), 3)
        rows["b5"].append(row)

    T, S = SHARD_CATALOG_TYPES, 8
    tm, th, tn, avail, sig_arrays, zone_ok, ct_ok, keys = shard_catalog_inputs(T, S)
    prepared = sharding.prepare_sharded_catalog(mesh, tm, th, tn, avail)
    allowed = sharding.allowed_sharded(prepared, sig_arrays, zone_ok, ct_ok, keys)
    single = sharding.allowed_sharded(sharding.prepare_sharded_catalog(one, tm, th, tn, avail), sig_arrays,
                                      zone_ok, ct_ok, keys)
    sharding.reset_shard_stats()
    if not torch.equal(allowed, single):
        fail("phase 23 held: allowed_sharded over the placements differs from the one-placement mesh's")
    for catalog in prepared[0].catalogs:
        planes = ck.signature_side(sig_arrays, zone_ok, ct_ok, catalog, keys=keys)
        block = ck.allowed_via_kernel(planes, catalog)
        t0 = time.perf_counter()
        plain = ck.allowed_packed_reference(planes, catalog.planes, catalog.layout)
        torch.cuda.synchronize(catalog.device)
        plain_ms = (time.perf_counter() - t0) * 1000.0
        if not torch.equal(block, plain):
            fail(f"phase 23 held: B1 on {catalog.device} differs from its plain version")
        with torch.cuda.device(catalog.device):
            kernel_ms = events_ms(lambda: ck.allowed_via_kernel(planes, catalog), 20)
        Wd, Tb = catalog.planes.shape
        rows["b1"].append({"kernel": "compat_allowed", "card": str(catalog.device), "S": S, "T": Tb, "W": Wd,
                           "max_abs_err": 0, "plain_ms": plain_ms, "kernel_ms": kernel_ms,
                           **bound_row(Wd * (S + Tb) * 4 + S * Tb, 2 * S * Tb * Wd)})
    Tp = prepared[0].n_types
    half = library_half(keys, sig_arrays, *pad_types(Tp, tm, th, tn, avail), zone_ok, ct_ok, mesh.device)
    if not torch.equal(library_allowed(half, keys)[:, :T], allowed):
        fail("phase 23 held: the library yardstick differs from allowed_sharded")
    library = {"S": S, "T_padded": Tp, "library_ms": median_ms(lambda: library_allowed(half, keys), 20)}

    per, R = CARDS_SCREEN
    loads, free, fleet_local, capv = shard_screen_inputs(D, per, R)
    with capture(sk, "screen_prefix") as screens:
        feasible = sharding.sharded_prefix_screen(mesh, loads, free, fleet_local, capv)
    whole = sk.prefix_screen_reference(*(torch.from_numpy(a).to(mesh.device) for a in (
        loads, free, fleet_local.sum(axis=0).astype(np.int32), capv)))
    if not (torch.equal(feasible, whole) and torch.equal(
            feasible, sharding.sharded_prefix_screen(one, loads, free, fleet_local, capv))):
        fail("phase 23 held: the folded prefix screen differs from the plain screen over all candidates")
    for dev, call in zip(mesh.placements, screens.calls):
        row = hold_call("prefix", call, dev)
        args = [a.to(dev) for a in call]
        with torch.cuda.device(dev):
            row["kernel_ms"] = events_ms(lambda: sk.screen_prefix(*args), 20)
        row["fleet_folded"] = call[2].tolist()
        rows["b8"].append(row)

    gather = None
    if len(mesh.cards) > 1:
        # the all-gather alone: every card's compat block ready, then
        # events on the first card around the copies and the join
        sig8, typ8 = shard_masks(8, 10_000, SHARD_SEED + 2)
        parts = [torch.from_numpy(sig8).to(dev) @ torch.from_numpy(typ8[a:b]).to(dev).T
                 for dev, a, b in sharding._blocks(mesh, 10_000)]
        for dev in mesh.cards:
            torch.cuda.synchronize(dev)
        with torch.cuda.device(mesh.device):
            gather_ms = events_ms(lambda: sharding._gather(mesh.device, parts, dim=1), 20)
        crossed = sum(p.numel() * p.element_size() for p in parts if p.device != mesh.device)
        gather = {"S": 8, "T": 10_000, "gather_ms": gather_ms, "peer_bytes": crossed}
    return {"rows": rows, "library": library, "gather": gather, "screen_true_rows": int(feasible.sum())}


def run_cards_phase(device: str = "cuda", cell=CARDS_CELL, reps: int = CARDS_REPS) -> dict:
    """23a on ``device``'s one card: ``cell``'s D shards as D placements of
    that card, the main path (one config-12 mega-solve warm, then ``reps``,
    B1 through ``allowed_sharded``, B8 through ``sharded_prefix_screen``)
    with the launches counted from 0 just before it; then phase 21's
    one-placement mesh at the same D on the same inputs (ids, counts,
    allowed matrix and prefix screen bit-equal), the path's own B5
    launch (the first placement's, 31,250 pods) against its plain
    version, and on the card each placement's launches against their
    plain versions (``cards_held``)."""
    import torch

    from karpenter_core_tpu_torch.solver import sharding

    t0 = time.perf_counter()
    pods, types, D = cell
    placements = [device] * D
    mesh = sharding.make_mesh(D, devices=placements)
    one = sharding.make_mesh(D, device=device)
    T, S = SHARD_CATALOG_TYPES, 8
    tm, th, tn, avail, sig_arrays, zone_ok, ct_ok, keys = shard_catalog_inputs(T, S)
    per, R = CARDS_SCREEN
    screen_in = shard_screen_inputs(D, per, R)

    before = disrupt_launches()
    row, (reqs, alloc, prices, sig, typ, out), path_b5 = shard_cell(device, pods, types, D, reps, hold=True,
                                                                    devices=placements, phase="23a")
    allowed = sharding.allowed_sharded(sharding.prepare_sharded_catalog(mesh, tm, th, tn, avail), sig_arrays,
                                       zone_ok, ct_ok, keys)
    feasible = sharding.sharded_prefix_screen(mesh, *screen_in)
    launches = cards_delta(before)
    sharding.reset_shard_stats()
    if device != "cpu":
        want = {"ffd_pack": D * (1 + reps), "compat_allowed": D, "disrupt_screen.prefix": D}
        if any(launches[k] != n for k, n in want.items()):
            fail(f"phase 23a: launches {launches}, the {D} placements give {want}")
    elif any(launches.values()):
        fail(f"phase 23a on the CPU launched a kernel: {launches}")

    single = sharding.sharded_mega_solve(one, reqs, alloc, prices, sig, typ)
    if not (np.array_equal(single["node_ids"], out["node_ids"]) and single["nodes"] == out["nodes"]
            and single["frontier_rows"] == out["frontier_rows"]):
        fail(f"phase 23a: {D} placements give {out['nodes']} nodes, the one-placement mesh {single['nodes']}, or "
             "other node ids")
    one_allowed = sharding.allowed_sharded(sharding.prepare_sharded_catalog(one, tm, th, tn, avail), sig_arrays,
                                           zone_ok, ct_ok, keys)
    one_feasible = sharding.sharded_prefix_screen(one, *screen_in)
    sharding.reset_shard_stats()
    if not (torch.equal(allowed, one_allowed) and torch.equal(feasible, one_feasible)):
        fail("phase 23a: the allowed matrix or the prefix screen over the placements differs from the one-placement "
             "mesh's")
    held = cards_held(mesh) if device != "cpu" else {"rows": {"b5": []}}
    held["rows"]["b5"].insert(0, held_path_b5(path_b5, mesh.placements[0]))
    return {"cell": row, "launches": launches, "one_placement_equal": True, "allowed_true": int(allowed.sum()),
            "screen_true_rows": int(feasible.sum()), "held": held, "wall_s": time.perf_counter() - t0}


def other_card_solves(card: str, base: str = "cuda:0") -> dict:
    """23b's step-0 check: solves on ``card`` alone while ``base`` is the
    current device, no mesh, against the same solves on ``base``: the
    cluster world with the native packer off (B1, B5, B6), bench config 5
    under lp (B7) and bench config 4's consolidation (B8's prefix and
    subset screens); plans and commands equal, every kernel launched on
    ``card``, and each kernel's first captured call on ``card`` (B8's
    single screen on seeded inputs) held to its plain version there."""
    import torch

    from karpenter_core_tpu_torch.disruption import screen_kernels as sk
    from karpenter_core_tpu_torch.solver import TorchScheduler, backends, pack, sharding
    from karpenter_core_tpu_torch.solver.backends import lp

    if torch.cuda.current_device() != torch.device(base).index:
        fail(f"phase 23b: {base} is not the current device")
    out, calls = {}, {}
    saved = sharding.SHARDED
    sharding.SHARDED = "off"  # a plain solve on each card: no mesh
    try:
        with knobs(KARPENTER_TORCH_NATIVE=0, KARPENTER_TORCH_INCREMENTAL=0):
            pools, provider, pods, nodes, daemons, _ = cluster_world(*CARDS_OTHER["cluster"])
            kw = dict(state_nodes=nodes, daemonset_pods=daemons)
            res = {}
            for dev in (base, card):
                before = disrupt_launches()
                with capture(pack, "ffd_pack_batched", 64) as ffd, capture(pack, "pack_existing", 64) as ex:
                    t0 = time.perf_counter()
                    res[dev] = TorchScheduler(pools, provider, device=dev).solve(pods, **kw)
                    ms = (time.perf_counter() - t0) * 1000.0
                out[f"cluster@{dev}"] = {"solve_ms": ms, "launches": cards_delta(before),
                                         "nodes": res[dev].node_count}
                calls[dev] = {"ffd_pack": min(ffd.calls, key=lambda c: c[0].shape[1], default=None),
                              "pack_existing": min(ex.calls, key=lambda c: c[0].shape[0], default=None)}
            same_as_cpu(res[card], res[base], f"phase 23b: the cluster solve on {card} against {base}")
            nodepool, provider5, pods5 = config5_world(*CARDS_OTHER["config5"])
            sha = {}
            with knobs(KARPENTER_TORCH_PACK_BACKEND="lp", KARPENTER_TORCH_LP_MIN_WORK=1):
                for dev in (base, card):
                    backends.reset_for_tests()
                    before = disrupt_launches()
                    with capture(lp, "dual_ascent", 1) as duals:
                        r = TorchScheduler([nodepool], provider5, device=dev).solve(pods5)
                    sha[dev] = (plan_sha256(r), round(r.total_price, 4))
                    out[f"config5-lp@{dev}"] = {"launches": cards_delta(before), "nodes": r.node_count,
                                                "total_price": round(r.total_price, 4)}
                    calls[dev]["dual_ascent"] = duals.calls[0] if duals.calls else None
            backends.reset_for_tests()
            if sha[card] != sha[base]:
                fail(f"phase 23b: config 5 under lp on {card} gives {sha[card]}, on {base} {sha[base]}")
        keys = {}
        for dev in (base, card):
            with capture_screens() as scr:
                c4 = run_config4(dev, CARDS_OTHER["config4"])
            keys[dev] = c4["key"]
            out[f"config4@{dev}"] = {"launches": c4["kernel_launches"], "disrupted": c4["disrupted"]}
            calls[dev].update({kind: c[0] if c else None for kind, c in scr.calls().items()})
        if keys[card] != keys[base]:
            fail(f"phase 23b: config 4's consolidation on {card} differs from {base}'s")
    finally:
        sharding.SHARDED = saved
    on_card = {k: sum(out[f"{p}@{card}"]["launches"].get(k, 0) for p in ("cluster", "config5-lp", "config4"))
               for k in ("compat_allowed", "ffd_pack", "pack_existing", "dual_ascent", "disrupt_screen.prefix",
                         "disrupt_screen.subsets")}
    if not all(on_card.values()):
        fail(f"phase 23b: the solves on {card} launched {on_card}")
    rng = np.random.RandomState(23)
    N, R = 37, 5
    calls[card]["singles"] = (torch.from_numpy(rng.randint(1, 50, (N, R)).astype(np.int32)),
                              torch.from_numpy(rng.randint(0, 40, (N, R)).astype(np.int32)),
                              torch.from_numpy(rng.randint(0, 400, R).astype(np.int32)),
                              torch.from_numpy(rng.randint(50, 200, R).astype(np.int32)))
    held = [hold_call(kind, call, torch.device(card)) for kind, call in calls[card].items() if call is not None]
    if {h["kernel"] for h in held} != {"ffd_pack", "pack_existing", "dual_ascent", "prefix", "subsets", "singles"}:
        fail(f"phase 23b: held on {card} only {sorted(h['kernel'] for h in held)}")
    return {"card": card, "base": base, "paths": out, "launches_on_card": on_card, "held": held,
            "plans_equal": True}


def auto_mesh_solves(n_cards: int, reps: int = CARDS_AUTO_REPS, sizes=CARDS_AUTO, device: str = "cuda:0") -> dict:
    """23b: the default on a host of ``n_cards`` cards. With ``SHARDED``
    at ``auto`` and no mesh installed, a ``TorchScheduler`` on ``device``
    shards over every card (``active_mesh``); each world of ``sizes`` is
    solved that way and on the one-card path (``SHARDED`` off), a fresh
    solver a mode, memo on and off: a cold solve, then ``reps`` of the
    same pods. Every plan equals the one-card path's, and with the memo
    off the cold ``auto`` solve launches B1 on every card (its
    ``card_ms``) → each leg's cold and median warm solve ms and launches."""
    from karpenter_core_tpu_torch.solver import TorchScheduler, sharding

    saved, prev = sharding.SHARDED, sharding.install_mesh(None)
    out = {}
    try:
        for name, size in sizes.items():
            for memo in ("on", "off"):
                streams = {}
                for mode in ("off", "auto"):
                    sharding.SHARDED = mode
                    with knobs(KARPENTER_TORCH_INCREMENTAL=None if memo == "on" else 0):
                        if name == "serving":
                            pools, provider, pods = shard_solve_world(*size)
                            kw = {}
                        else:
                            pools, provider, pods, nodes, daemons, _ = cluster_world(*size)
                            kw = dict(state_nodes=nodes, daemonset_pods=daemons)
                        solver = TorchScheduler(pools, provider, device=device)
                        mesh = solver._mesh()
                        if (mesh is None) != (mode == "off") or (mesh is not None
                                                                 and len(mesh.placements) != n_cards):
                            fail(f"phase 23b auto {name}: SHARDED={mode} gives the mesh {mesh}")
                        runs, res = [], []
                        for i in range(1 + reps):
                            before = disrupt_launches()
                            t0 = time.perf_counter()
                            res.append(solver.solve(pods, **kw))
                            runs.append(((time.perf_counter() - t0) * 1000.0, cards_delta(before),
                                         (solver.last_shard_stats or {}).get("card_ms")))
                    streams[mode] = [(plan_stream(r), existing_stream(r), r.pod_errors) for r in res]
                    warm = sorted(ms for ms, _, _ in runs[1:])
                    cold_launches, card_ms = runs[0][1], runs[0][2]
                    out[f"{name}-memo-{memo}@{mode}"] = {
                        "pods": len(pods), "cold_ms": runs[0][0], "warm_ms": warm[len(warm) // 2],
                        "warm_ms_runs": [ms for ms, _, _ in runs[1:]], "cold_launches": cold_launches,
                        "warm_launches": [l for _, l, _ in runs[1:]], "cold_card_ms": card_ms,
                        "nodes": res[0].node_count}
                    if mode == "auto" and memo == "off" and device != "cpu" and (
                            cold_launches["compat_allowed"] < n_cards or len(card_ms or {}) != n_cards):
                        fail(f"phase 23b auto {name}: the cold solve launched {cold_launches} with card ms {card_ms}")
                if streams["auto"] != streams["off"]:
                    fail(f"phase 23b auto {name} (memo {memo}): the plans over {n_cards} cards differ from one card's")
    finally:
        sharding.SHARDED = saved
        sharding.install_mesh(prev)
    return {"cards": n_cards, "legs": out, "plans_equal": True}


def run_cards_across(n_cards: int, cells=CARDS_CELLS, reps: int = CARDS_REPS, solve=CARDS_SOLVE,
                     devices=None) -> dict:
    """23b over ``n_cards`` cards of one host (``--phases 23 --cards N``):
    bench config 12 at full width across them (each cell of ``cells``
    whose cards are there: warm once, then ``reps``; nodes and frontier
    rows against the reference's record where it has one; node ids equal
    to the one-card mesh of the same D on ``cuda:0``), the dryrun's
    sequence over the cards (against the JAX package's numbers on as
    many devices), an 8-shard ``TorchScheduler`` solve across them
    against the CPU's, the step-0 solves on ``cuda:1`` against ``cuda:0``,
    the default ``auto`` mesh's solves against the one-card path
    (``auto_mesh_solves``), and each card's B1, B5 and B8 launches
    against their plain versions, the second card's own launch in the
    first cell over every card among them.
    Fails with fewer cards than ``n_cards``. ``devices``: ``n_cards``
    placements to use instead of the cards (``["cpu"] * n``: a rehearsal
    of the mesh's paths, without the step-0 and ``auto`` solves and the
    held cases but the path's own B5 launch)."""
    import torch

    from karpenter_core_tpu_torch.solver import sharding

    if devices is None:
        visible = torch.cuda.device_count()
        if n_cards < 2 or visible < n_cards:
            fail(f"phase 23b: --cards {n_cards} needs that many cards, and {visible} are visible")
    t0 = time.perf_counter()
    cards = card_names(n_cards) if devices is None else list(devices)
    device = "cpu" if cards[0] == "cpu" else "cuda"
    sections, launches, curve, path_b5 = {}, {}, [], None
    for pods, types, D, c in cells:
        if c > n_cards:
            continue
        label = f"{pods}x{types} D={D} over {c} cards"
        before = disrupt_launches()
        # the first cell over every card holds the second card's own B5 launch
        hold = path_b5 is None and c == n_cards
        row, (reqs, alloc, prices, sig, typ, out), kept = shard_cell(device, pods, types, D, reps, hold=hold,
                                                                     devices=cards[:c], phase="23b", hold_at=1)
        path_b5 = kept or path_b5
        launches[label] = cards_delta(before)
        t1 = time.perf_counter()
        single = sharding.sharded_mega_solve(sharding.make_mesh(D, device=cards[0]), reqs, alloc, prices, sig, typ)
        if not (np.array_equal(single["node_ids"], out["node_ids"]) and single["nodes"] == out["nodes"]):
            fail(f"phase 23b {label}: {out['nodes']} nodes, the one-card mesh {single['nodes']}, or other ids")
        row.update(cards=c, one_card_equal=True, one_card_wall_ms=single["wall_ms"],
                   one_card_pack_ms=single["pack_ms"], one_card_s=time.perf_counter() - t1)
        curve.append(row)
    sections["cells"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    before = disrupt_launches()
    dry = shard_dryrun(device, n_cards, devices=cards)
    one_dry = shard_dryrun(cards[0], n_cards)
    if {k: dry[k] for k in ("fleet_total", "overlap_sum", "feasible", "ids_sha256")} != \
            {k: one_dry[k] for k in ("fleet_total", "overlap_sum", "feasible", "ids_sha256")}:
        fail(f"phase 23b: the dryrun over {n_cards} cards gives {dry}, on one card {one_dry}")
    launches["dryrun"] = cards_delta(before)
    sections["dryrun"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    before = disrupt_launches()
    solved = shard_solve(device, *solve, devices=cards)
    launches["solve"] = cards_delta(before)
    sections["solve"] = time.perf_counter() - t1
    other, auto, held = None, None, {"rows": {"b5": [], "b1": [], "b8": []}, "gather": None, "library": None}
    if device == "cuda":
        t1 = time.perf_counter()
        other = other_card_solves(cards[1], cards[0])
        sections["other_card"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        auto = auto_mesh_solves(n_cards)
        sections["auto"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        held = cards_held(sharding.make_mesh(n_cards, devices=cards))
        sections["held"] = time.perf_counter() - t1
        for path, kernels in (("solve", ("ffd_pack", "compat_allowed")),
                              ("dryrun", ("ffd_pack", "disrupt_screen.prefix"))):
            if not all(launches[path][k] for k in kernels):
                fail(f"phase 23b {path}: launches {launches[path]}")
    elif any(n for counts in launches.values() for n in counts.values()):
        fail(f"phase 23b on the CPU launched a kernel: {launches}")
    if path_b5 is None:
        fail(f"phase 23b: no cell over the {n_cards} cards ran to hold its own B5 launch")
    t1 = time.perf_counter()
    held["rows"]["b5"].insert(0, held_path_b5(path_b5, torch.device(cards[1])))
    sections["held-path"] = time.perf_counter() - t1
    return {"cards": n_cards, "curve": curve, "dryrun": dry, "solve": solved, "other_card": other, "auto": auto,
            "held": held, "launches": launches, "sections_s": sections, "wall_s": time.perf_counter() - t0}


def report_cards_phase(c: dict, card: str) -> None:
    """Print phase 23's lines, each with the card and the card count."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if "cell" in c:
        emit({"phase23a_cell": "{pods}x{types} D={n_devices}".format(**c["cell"]), **c["cell"], "card": card,
              "cards_visible": n})
        for name, rows in c["held"].get("rows", {}).items():
            for r in rows:
                emit({"phase23a_held": name, **r, "card": card})
        emit({"phase23a": "placements", "launches": c["launches"], "one_placement_equal": c["one_placement_equal"],
              "library": c["held"].get("library"), "wall_s": c["wall_s"], "card": card, "cards_visible": n})
        return
    for row in c["curve"]:
        emit({"phase23b_cell": f"{row['pods']}x{row['types']} D={row['n_devices']} cards={row['cards']}", **row,
              "card": card, "cards": c["cards"]})
    emit({"phase23b": "dryrun", **c["dryrun"], "card": card, "cards": c["cards"]})
    emit({"phase23b": "solve", **c["solve"], "card": card, "cards": c["cards"]})
    if c["other_card"]:
        emit({"phase23b": "other-card", **c["other_card"], "card": card, "cards": c["cards"]})
    if c.get("auto"):
        emit({"phase23b": "auto-mesh", **c["auto"], "card": card})
    for name, rows in c["held"]["rows"].items():
        for r in rows:
            emit({"phase23b_held": name, **r, "card": card, "cards": c["cards"]})
    emit({"phase23b": "config12-across-cards", "gather": c["held"]["gather"], "library": c["held"]["library"],
          "launches": c["launches"], "sections_s": c["sections_s"], "wall_s": c["wall_s"], "card": card,
          "cards": c["cards"]})


# -- phase 22: the static-analysis plane --------------------------------------------

ANALYSIS_TIMEOUT_S = 300.0
# the witness's device-plane names → the kernels line's
WITNESS_KERNELS = {
    "kernels.allowed_kernel": "compat_allowed", "pack.ffd_pack_batched": "ffd_pack",
    "pack.pack_existing": "pack_existing", "lp.dual_ascent": "dual_ascent",
    "disrupt.prefix_screen": "disrupt_screen.prefix", "disrupt.subset_screen": "disrupt_screen.subsets",
    "disrupt.single_screen": "disrupt_screen.singles",
}


def run_analysis_cli() -> dict:
    """22a: ``python -m karpenter_core_tpu_torch.analysis --format json``
    over the checkout, in a process of its own → files scanned, findings
    by disposition, seconds, and the top packages of that process's
    ``sys.modules``. Fails unless it exits 0 with no finding and no stale
    baseline entry, and neither torch nor jax was imported."""
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['analysis', '--format', 'json']\n"
        "rc = 0\n"
        "try:\n"
        "    runpy.run_module('karpenter_core_tpu_torch.analysis', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print(json.dumps({'rc': rc, 'heavy': sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'jax', 'numpy'})}))\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"22a: the analyzer's process failed ({proc.returncode}): {proc.stderr[-2000:]}")
    tail = json.loads(lines[-1])
    report = json.loads("\n".join(lines[:-1]))
    if tail["rc"] != 0 or not report["ok"] or report["findings"] or report["stale_baseline"] or report["parse_errors"]:
        fail(f"22a: the analyzer is not clean: rc {tail['rc']}, findings {report['findings'][:5]}, "
             f"stale {report['stale_baseline'][:5]}, parse errors {report['parse_errors'][:5]}")
    if tail["heavy"]:
        fail(f"22a: the analyzer's process imported {tail['heavy']}")
    return {"files_scanned": report["files_scanned"], "findings": len(report["findings"]),
            "suppressed": len(report["suppressed"]), "baselined": len(report["baselined"]),
            "stale_baseline": len(report["stale_baseline"]), "analyzer_s": report["seconds"],
            "process_s": wall_s, "imported": tail["heavy"]}


def run_analysis_witness(device: str = "cuda") -> dict:
    """22b: the witnessed run (``python -m karpenter_core_tpu_torch.witness``)
    on ``device`` with the native packer off, so the kernels launch from
    the plan, prewarm and dispatcher threads → its observation: lock
    edges and locks, knob reads, each kernel's launches. Fails unless
    observed ⊆ static for both witnesses, every required lock was
    acquired, and on the card the pack scans and the compat kernel
    launched."""
    t0 = time.perf_counter()
    with knobs(KARPENTER_TORCH_NATIVE=0):
        proc = subprocess.run(
            [sys.executable, "-m", "karpenter_core_tpu_torch.witness", "--device", device, "--json"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.startswith("{") and '"problems"' in ln]
    if not lines:
        fail(f"22b: the witnessed run printed no result ({proc.returncode}): {proc.stderr[-3000:]}")
    got = json.loads(lines[-1])
    if proc.returncode != 0 or not got["ok"]:
        fail(f"22b: the witness gate failed ({proc.returncode}): {got['problems']}")
    if not got.get("lock_edges") or not got.get("locks") or not got.get("knobs"):
        fail(f"22b: an empty observation: {len(got.get('lock_edges', ()))} edges, {len(got.get('locks', ()))} locks, "
             f"{len(got.get('knobs', ()))} knobs")
    launches = {WITNESS_KERNELS[name]: n for name, n in got["workload"]["launches"].items() if name in WITNESS_KERNELS}
    if device == "cuda" and not all(launches.get(k) for k in ("compat_allowed", "ffd_pack", "pack_existing")):
        fail(f"22b: the witnessed workload did not launch the compat and pack kernels: {launches}")
    return {"lock_edges": got["lock_edges"], "locks": got["locks"], "knobs": got["knobs"],
            "instrumented": got["instrumented"], "launches": launches,
            "workload": {k: v for k, v in got["workload"].items() if k != "launches"},
            "witness_s": got["seconds"], "process_s": wall_s}


def run_contracts_pass(device: str = "cuda") -> dict:
    """22c: ``python -m karpenter_core_tpu_torch.analysis --contracts
    --device cuda --format json`` in a process of its own → each
    contract's sizes, verdict, kernel, launches and bit-equality, and the
    launches per kernel. Fails unless every contract holds (on the card a
    wrapper holds when it launched its kernel and equalled its plain
    version bit for bit), the reference's six are covered, and on the card
    every dispatching wrapper (``ROUTES``) ran its kernel."""
    from karpenter_core_tpu_torch.analysis.shape_contracts import ROUTES

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_core_tpu_torch.analysis", "--contracts", "--device", device,
         "--format", "json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    try:
        got = json.loads(proc.stdout)
    except ValueError:
        fail(f"22c: the contract pass printed no result ({proc.returncode}): {proc.stderr[-3000:]}")
    bad = [f"{c['name']}: {c['detail']}" for c in got["contracts"] if not c["ok"]]
    if proc.returncode != 0 or not got["ok"] or bad or not all(got["reference_covered"].values()):
        fail(f"22c: the contract pass failed ({proc.returncode}): {bad}, covered {got['reference_covered']}")
    routed = {c["name"] for c in got["contracts"] if c["kernel"]}
    if device == "cuda" and routed != set(ROUTES):
        fail(f"22c: the wrappers that ran a kernel are {sorted(routed)}, not {sorted(ROUTES)}")
    launches = {WITNESS_KERNELS[name]: sum(c["launches"] for c in got["contracts"] if c["kernel"] == name)
                for name in sorted(set(ROUTES.values()))}
    return {"contracts": [{k: c[k] for k in ("name", "ok", "checked", "sizes", "kernel", "launches", "bit_equal", "ms")}
                          for c in got["contracts"]],
            "checked": sum(c["checked"] for c in got["contracts"]), "launches": launches,
            "reference_covered": got["reference_covered"], "pass_s": got["seconds"], "process_s": wall_s}


def run_analysis_phase(device: str = "cuda") -> dict:
    """Phase 22: 22a the analyzer over the checkout, 22b the witnessed run
    on ``device``, 22c the shape-contract pass on ``device``."""
    t0 = time.perf_counter()
    cli = run_analysis_cli()
    witness = run_analysis_witness(device)
    contracts = run_contracts_pass(device)
    return {"cli": cli, "witness": witness, "contracts": contracts, "wall_s": time.perf_counter() - t0}


def report_analysis_phase(an: dict, card: str) -> None:
    """Print phase 22's lines, each with the card."""
    emit({"phase22a": "analyzer", **an["cli"], "card": card})
    w = an["witness"]
    emit({"phase22b": "witness", "edges": [" -> ".join(e) for e in w["lock_edges"]], "locks": w["locks"],
          "knobs": w["knobs"], "instrumented": w["instrumented"], "launches": w["launches"],
          "workload": w["workload"], "witness_s": w["witness_s"], "process_s": w["process_s"], "card": card})
    c = an["contracts"]
    emit({"phase22c": "contracts", "contracts": c["contracts"], "checked": c["checked"], "launches": c["launches"],
          "reference_covered": c["reference_covered"], "pass_s": c["pass_s"], "process_s": c["process_s"],
          "card": card})
    emit({"phase22": "analysis", "wall_s": an["wall_s"], "reserve_s": ANALYSIS_RESERVE_S, "card": card})


def probe_card() -> tuple:
    """Step 1: the card, or fail. Prints the card's name and power limit
    as nvidia-smi gives them and the device line. → (torch's device name,
    the nvidia-smi line, the maximum SM clock in MHz)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    try:
        import karpenter_core_tpu_torch.disruption.screen_kernels  # noqa: F401
        import karpenter_core_tpu_torch.solver.solver  # noqa: F401
    except ImportError as e:
        fail(f"run from the repository root: the port does not import ({e})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        sm_mhz = float(clock.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no maximum SM clock: {clock.stdout!r} {clock.stderr!r}")
    kind = torch.cuda.get_device_name(0)
    emit({"device": kind, "nvidia_smi": card, "max_sm_mhz": sm_mhz, "torch": torch.__version__, "cuda": torch.version.cuda})
    return kind, card, sm_mhz


def build_kernels() -> dict:
    """Step 2: build every kernel library from the checkout's sources,
    one compiler per source, started together, and print the build and
    ptxas lines. → the compat kernel's ptxas usage."""
    from karpenter_core_tpu_torch import native
    from karpenter_core_tpu_torch.disruption import screen_kernels as sk
    from karpenter_core_tpu_torch.solver import compat_kernels as ck

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=6) as pool:
        kernel_build = pool.submit(ck.COMPAT_ALLOWED.build)
        packer_build = pool.submit(native.build)
        pack_builds = {name: pool.submit(k.build) for name, k in pack_kernels().items()}
        # the three screen entry points share one source and one library
        pack_builds["disrupt_screen"] = pool.submit(sk.SCREEN_SUBSETS.build)
        (kernel_lib, kernel_log), (packer_lib, _) = kernel_build.result(), packer_build.result()
        pack_libs = {name: f.result() for name, f in pack_builds.items()}
    build_s = time.perf_counter() - t0
    emit({"build_s": build_s, "kernel_lib": kernel_lib, "packer_lib": packer_lib,
          "kernel_libs": {name: lib for name, (lib, _) in pack_libs.items()}})
    for line in kernel_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    usage = ptxas_usage(kernel_log)
    emit({"ptxas": usage})
    if len(usage) != 2:
        fail(f"ptxas reported {sorted(usage)}, not both tile instantiations")
    for name, (_, log) in pack_libs.items():
        emit({"ptxas_" + name: [
            line.strip() for line in log.splitlines()
            if "entry function" in line or "registers" in line or "spill" in line
        ]})
    return usage


def report_config7_phase(config7: dict, card: str) -> None:
    """Print phase 14's lines, each with the card."""
    emit({"phase14": "config7-ticks", **{k: v for k, v in config7.items() if k not in ("native_off", "kernel_cases")},
          "card": card})
    for r in config7["native_off"]:
        emit({"phase14_native_off_tick": r["tick"], **r, "card": card})
    for r in config7["kernel_cases"]["compat_allowed"]:
        emit({"compat_case": "config7-captured", **r, "card": card})
    for r in config7["kernel_cases"]["ffd_pack"]:
        emit({"pack_kernel_case": "ffd_pack", "captured": "config7-native-off", **r, "card": card})


def report_disruption_phase(disrupt: dict, card: str) -> None:
    """Print phase 15's lines, each with the card, and fail unless every
    kernel a phase-15 path runs was launched on it."""
    c4, c9 = disrupt["config4"], disrupt["config9"]
    emit({"phase15": "config4-consolidation", **{k: v for k, v in c4.items() if k != "key"},
          "native_off_kernel_launches": disrupt["config4_native_off"]["kernel_launches"], "card": card})
    emit({"phase15": "config9-disruption", **{k: v for k, v in c9.items() if k not in ("keys", "steps")},
          "identical_decisions": len(c9["keys"]), "card": card})
    for row in c9["steps"]:
        emit({"phase15_config9_step": row["step"], **row, "card": card})
    emit({"phase15": "config9-native-off", **{k: v for k, v in disrupt["config9_native_off"].items()
                                               if k not in ("keys", "steps")}, "card": card})
    for row in disrupt["config9_native_off"]["steps"]:
        emit({"phase15_config9_native_off_step": row["step"], **row, "card": card})
    emit({"phase15": "controller-e2e", **{k: v for k, v in disrupt["controller"].items() if k != "store"},
          "card": card})
    for r in disrupt["screen_cases"]:
        emit({"screen_case": r["entry"], **r, "card": card})
    emit({"phase15_sections_s": disrupt["sections_s"]})
    for path, want in (("config4", ("disrupt_screen.prefix", "disrupt_screen.subsets")),
                       ("config4-native-off", ("disrupt_screen.subsets", "pack_existing")),
                       ("config9", ("disrupt_screen.prefix", "disrupt_screen.subsets", "disrupt_screen.singles",
                                    "compat_allowed")),
                       ("config9-native-off", ("disrupt_screen.subsets", "pack_existing", "compat_allowed")),
                       ("controller-e2e", ("disrupt_screen.prefix", "disrupt_screen.subsets",
                                           "disrupt_screen.singles", "compat_allowed"))):
        missing = [k for k in want if not disrupt["launches"][path][k]]
        if missing:
            fail(f"phase 15 {path}: {missing} never launched ({disrupt['launches'][path]})")


def report_serving_phase(serving: dict, card: str) -> None:
    """Print phase 16's lines, each with the card."""
    sk16 = serving["kernels"]
    emit({"phase16": "kernels-under-serving", **{k: v for k, v in sk16.items() if k != "cases"}, "card": card})
    for name, rows in sk16["cases"].items():
        for r in rows:
            emit({"phase16_kernel_case": name, **r, "card": card})
    for name, row in serving["config8"]["scenarios"].items():
        emit({"phase16_config8": name, **row, "card": card})
    emit({"phase16": "config8", **{k: v for k, v in serving["config8"].items() if k != "scenarios"},
          "card": card})
    for row in serving["config14"]:
        emit({"phase16_config14_seed": row["seed"], **row, "card": card})
    emit({"phase16": "config14", "seeds": serving["config14_seeds"], "wall_s": serving["wall_s"],
          "kernels_s": serving["kernels_s"], "card": card})


# the phases ``--phases`` can run alone, after the build: each runs on the
# card and prints its lines
# -- phases 12-22, each a runner: run in a lane, in this process or another ------

PACK_NAMES = ("ffd_pack", "pack_existing", "dual_ascent")
# the seconds a phase keeps for itself: a phase before it in its lane keeps
# them out of its own budget
PHASE_RESERVE_S = {17: CHAOS_RESERVE_S, 18: OPERATOR_RESERVE_S, 19: FLEET_RESERVE_S, 20: DEVICEPLANE_RESERVE_S,
                   21: SHARD_RESERVE_S, 22: ANALYSIS_RESERVE_S, 23: CARDS_RESERVE_S}


def lane_elapsed_s(ctx: dict) -> float:
    """Seconds since the script started (``ctx["t0"]``, the wall clock)."""
    return time.time() - ctx["t0"]


def later_reserve_s(ctx: dict, n: int) -> float:
    """The reserves of the phases after ``n`` in its lane."""
    lane = ctx["lane"]
    return sum(PHASE_RESERVE_S.get(m, 0.0) for m in lane[lane.index(n) + 1:])


def phase_12(ctx: dict) -> dict:
    """12. The pack engines on the card: the device FFD scan and the
    existing-node first-fit (native packer off) on config 3 whole and on
    phase 5's cluster, the LP backend on bench config 10 whole and on
    config 5 whole (one relaxation over 2,000 types); then each captured
    scan against its plain version."""
    card = ctx["card"]
    with knobs(KARPENTER_TORCH_INCREMENTAL=0):
        pack = run_pack_phase("cuda")
    emit({"elapsed_s": lane_elapsed_s(ctx), "after": "phase 12 paths"})
    for r in pack["paths"]:
        emit({"phase12": r["path"], **{k: v for k, v in r.items() if k != "path"}, "card": card})
    emit({"phase12": "config10", **{k: v for k, v in pack["config10"].items() if k != "rows"}, "card": card})
    for r in pack["config10"]["rows"]:
        emit({"phase12_config10_shape": r["shape"], **{k: v for k, v in r.items() if k != "shape"}})
    emit({"phase12": "config10-device-scan", "rows": pack["config10_device"]})
    cases = {"ffd_pack": [], "pack_existing": [], "dual_ascent": []}
    for call in distinct_shapes(pack["ffd_calls"]):
        cases["ffd_pack"].append(ffd_kernel_case(call))
    for call in distinct_shapes(pack["existing_calls"]):
        cases["pack_existing"].append(existing_kernel_case(call))
    for call in distinct_shapes(pack["dual_calls"]):
        cases["dual_ascent"].append(dual_kernel_case(call))
    for name, rows in cases.items():
        if not rows:
            fail(f"no {name} call was captured on the main paths")
    scan_case = {"ffd_pack": ffd_kernel_case, "pack_existing": existing_kernel_case}
    for name, calls in synthetic_scan_calls().items():
        cases[name] += [{"synthetic": label, **scan_case[name](call)} for label, call in calls]
    cases["dual_ascent"] += [{"synthetic": label, **dual_kernel_case(call)} for label, call in synthetic_dual_calls()]
    for name, rows in cases.items():
        for row in rows:
            emit({"pack_kernel_case": name, **row, "card": card})
    # lp.relax around the kernel: uploads, kernel, downloads, host bound
    relax_splits = {}
    for label, calls in pack["relax_calls"].items():
        if not calls:
            fail(f"no lp.relax call was captured on the {label} path")
        relax_splits[label] = relax_split(calls[0])
        emit({"relax_split": label, **relax_splits[label], "card": card})
    return {"pack_launches": pack["launches"], "pack_cases": cases, "relax_splits": relax_splits}


def phase_13(ctx: dict) -> dict:
    """13. The provisioner entry: Provisioner.reconcile over a live store
    on bench config 2, phase 5's cluster (C++ packer and device scans) and
    the anti-affinity / greedy-fallback world."""
    with knobs(KARPENTER_TORCH_INCREMENTAL=0):
        prov = run_provisioner_phase("cuda")
    prov_rows = {"provisioner-config2": prov["config2"], **{
        f"provisioner-{k}": v for k, v in prov["rows"].items()
    }, "provisioner-anti-cluster-oracle": prov["guard"]}
    existing = {"captured": "provisioner-cluster-device", **prov["existing_case"]}
    emit({"pack_kernel_case": "pack_existing", **existing, "card": ctx["card"]})
    emit({"phase13": {path: {k: row[k] for k in (
        "reconcile_ms", "solve_ms", "span_snapshot_nodes_ms", "span_pending_pods_ms", "span_solve_ms",
        "span_create_node_claims_ms", "claims", "nominated_pods", "kernel_launches",
    )} for path, row in prov_rows.items()}, "card": ctx["card"]})
    return {"pack_launches": {path: {name: row["kernel_launches"][name] for name in PACK_NAMES}
                              for path, row in prov_rows.items()},
            "pack_cases": {"pack_existing": [existing]},
            "compat_paths": {path: row["kernel_launches"]["compat_allowed"] for path, row in prov_rows.items()},
            "compat_err": [prov["compat_err"]]}


def phase_14(ctx: dict) -> dict:
    """14. Bench config 7's ticks: the cross-tick warm state on the card."""
    config7 = run_config7_phase("cuda", ticks=DEPTH["config7_ticks"], native_off_ticks=DEPTH["config7_native_off_ticks"])
    report_config7_phase(config7, ctx["card"])
    return {"compat_paths": {f"config7-{leg}": n["compat"] for leg, n in config7["launches"].items()},
            "pack_launches": {f"config7-{leg}": {"ffd_pack": n["ffd"], "pack_existing": 0, "dual_ascent": 0}
                              for leg, n in config7["launches"].items()},
            "pack_cases": {"ffd_pack": [{"captured": "config7-native-off", **r}
                                        for r in config7["kernel_cases"]["ffd_pack"]]},
            "compat_captured": {"config7_captured": config7["kernel_cases"]["compat_allowed"]}}


def phase_15(ctx: dict) -> dict:
    """15. Disruption on the card, the warm state on: bench config 4 and
    config 9 whole, the controller end to end, every screen shape."""
    disrupt = run_disruption_phase("cuda", sm_mhz=ctx["sm_mhz"])
    report_disruption_phase(disrupt, ctx["card"])
    paths = {f"phase15-{path}": n for path, n in disrupt["launches"].items()}
    return {"pack_launches": {path: {name: n[name] for name in PACK_NAMES} for path, n in paths.items()},
            "compat_paths": {path: n["compat_allowed"] for path, n in paths.items()},
            "screen_launches": paths, "screen_cases": disrupt["screen_cases"]}


def phase_16(ctx: dict) -> dict:
    """16. The serving pipeline on the card: 16c the kernels under serving
    (native off, a disruption stage), 16a bench config 8 whole, 16b bench
    config 14 (each measurement its own process), the later phases of its
    lane's reserves kept out of its budget (16b drops a later seed
    first)."""
    serving = run_serving_phase("cuda", sm_mhz=ctx["sm_mhz"], sizes={"config14": (
        CONFIG14_SCALE, CONFIG14_TYPES, CONFIG14_KILL, CONFIG14_SEEDS[:DEPTH["config14_seeds"]])}, budget_s=min(
        SERVING_BUDGET_S, SCRIPT_BUDGET_S - later_reserve_s(ctx, 16) - lane_elapsed_s(ctx)))
    report_serving_phase(serving, ctx["card"])
    sk16 = serving["kernels"]
    return {"pack_launches": {f"phase16-{mode}": {name: counts[name]["tick"] + counts[name]["prewarm"]
                                                  for name in PACK_NAMES} for mode, counts in sk16["launches"].items()},
            "pack_cases": {name: [{"captured": "phase16", **r} for r in sk16["cases"][name]]
                           for name in ("ffd_pack", "pack_existing")},
            "compat_paths": {f"phase16-{mode}-{role}": n["compat_allowed"][role]
                             for mode, n in sk16["launches"].items() for role in ("tick", "prewarm")},
            "compat_captured": {"serving_captured": sk16["cases"]["compat_allowed"]},
            "screen_launches": {f"phase16-{mode}": {name: c["tick"] + c["prewarm"] for name, c in n.items()}
                                for mode, n in sk16["launches"].items()},
            "screen_cases": sk16["cases"]["disrupt_screen"]}


def phase_17(ctx: dict) -> dict:
    """17. The chaos pack on the card: 17a bench config 15 whole (each
    fault and the clean twin its own process), 17b the kernels under
    chaos."""
    chaos = run_chaos_phase("cuda")
    report_chaos_phase(chaos, ctx["card"])
    ck17 = chaos["kernels"]
    return {"pack_launches": {f"phase17-{key}": {name: counts[name] for name in PACK_NAMES}
                              for key, counts in ck17["launches"].items()},
            "pack_cases": {name: [{"captured": "phase17", **r} for r in ck17["cases"][name]]
                           for name in ("ffd_pack", "pack_existing")},
            "compat_paths": {f"phase17-{key}": n["compat_allowed"] for key, n in ck17["launches"].items()},
            "compat_captured": {"chaos_captured": ck17["cases"]["compat_allowed"]}}


def phase_18(ctx: dict) -> dict:
    """18. The operator on the card: 18a bench config 2 whole through one
    Operator's whole node lifecycle (native off), held pass by pass to a
    CPU run; 18b the operator served, with a follower."""
    op18 = run_operator_phase("cuda", sm_mhz=ctx["sm_mhz"])
    report_operator_phase(op18, ctx["card"])
    launches = op18["launches"]
    return {"pack_launches": {"phase18-operator": {name: launches[name] for name in PACK_NAMES}},
            "pack_cases": {name: [{"captured": "phase18", **r} for r in op18["cases"][name]]
                           for name in ("ffd_pack", "pack_existing")},
            "compat_paths": {"phase18-operator": launches["compat_allowed"]},
            "compat_captured": {"operator_captured": op18["cases"]["compat_allowed"]},
            "screen_launches": {"phase18-operator": launches}, "screen_cases": op18["cases"]["disrupt_screen"]}


def phase_19(ctx: dict) -> dict:
    """19. The fleet on the card: 19a bench config 11 (solo and batched),
    19b its identity runs on the CPU, 19c the kernels under the fleet
    (native off, then lp), 19d three trafficgen --fleet processes."""
    fleet19 = run_fleet_phase("cuda", card=ctx["card"])
    fk = fleet19["kernels"]
    compat = {f"phase19-{key}": n["compat_allowed"] for key, n in fk["launches"].items()}
    for cell in fleet19["config11"]["curve"]:
        for engine, n in cell["compat_launches"].items():
            compat[f"phase19a-{cell['tenants']}x{cell['pods_each']}-{engine}"] = n
    for engine, run in fleet19["config11"]["identity"].items():
        compat[f"phase19a-identity-{engine}"] = run["compat_launches"]
    return {"pack_launches": {f"phase19-{key}": {name: counts[name] for name in PACK_NAMES}
                              for key, counts in fk["launches"].items()},
            "pack_cases": {name: [{"captured": "phase19", **r} for r in fk["cases"][name]]
                           for name in ("ffd_pack", "dual_ascent")},
            "compat_paths": compat, "compat_captured": {"fleet_captured": fk["cases"]["compat_allowed"]}}


def phase_20(ctx: dict) -> dict:
    """20. The device plane: its own solves (phase 5's cluster native off,
    config 10 under lp, config 4's decision), a restart in a fresh
    process, the capture and a breach dump, the plane on against off; then
    its checks over the whole of its process."""
    dp20 = run_deviceplane_phase("cuda")
    report_deviceplane_phase(dp20, ctx["card"])
    emit({"phase20": "process", **check_process_plane(), "card": ctx["card"]})
    launches = dp20["launches"]
    return {"pack_launches": {"phase20": {name: launches[plane] for name, plane in (
        ("ffd_pack", "pack.ffd_pack_batched"), ("pack_existing", "pack.pack_existing"),
        ("dual_ascent", "lp.dual_ascent"))}},
            "compat_paths": {"phase20": launches["kernels.allowed_kernel"]},
            "screen_launches": {"phase20": {f"disrupt_screen.{kind}": launches[plane] for kind, plane in (
                ("prefix", "disrupt.prefix_screen"), ("subsets", "disrupt.subset_screen"),
                ("singles", "disrupt.single_screen"))}}}


def phase_21(ctx: dict) -> dict:
    """21. Bench config 12 on the card: 21a the curve, 21b the unchunked
    node ratio, the chunk identity at 1,000,000 pods and the solve on an
    8-shard mesh, 21d the dryrun's sequence, 21c the kernels against their
    plain versions, one of 21a's own launches at 125,000 pods among them.
    Its reserve shrinks with what is left of SCRIPT_BUDGET_S on a slow
    host: then the cells but the anchor and 1,000,000 pods run once."""
    sh21 = run_shard_phase("cuda", sm_mhz=ctx["sm_mhz"], budget_s=max(0.0, min(
        SHARD_RESERVE_S, SCRIPT_BUDGET_S - later_reserve_s(ctx, 21) - lane_elapsed_s(ctx))))
    report_shard_phase(sh21, ctx["card"])
    return {"pack_launches": {path: {"ffd_pack": n["ffd_pack"], "pack_existing": 0, "dual_ascent": 0}
                              for path, n in sh21["launches"].items()},
            "compat_paths": {path: n["compat_allowed"] for path, n in sh21["launches"].items()},
            "pack_cases": {"ffd_pack": [{"captured": f"phase21c-{name}", **r}
                                        for name in ("sharded_pod_pack", "sharded_batch_pack")
                                        for r in sh21["cases"][name]]},
            "screen_launches": {path: {"disrupt_screen.prefix": n["disrupt_screen.prefix"],
                                       "disrupt_screen.subsets": 0, "disrupt_screen.singles": 0}
                                for path, n in sh21["launches"].items()},
            "config12": sh21["curve"]}


def phase_22(ctx: dict) -> dict:
    """22. The static-analysis plane: 22a the port's analyzer over this
    checkout, 22b the lock and knob witnesses over a threaded workload on
    the card (native packer off: the kernels launch from its threads),
    22c the shape-contract pass on the card."""
    an22 = run_analysis_phase("cuda")
    report_analysis_phase(an22, ctx["card"])
    w22, c22 = an22["witness"]["launches"], an22["contracts"]["launches"]
    return {"pack_launches": {"phase22": {name: w22.get(name, 0) for name in PACK_NAMES},
                              "phase22c": {name: c22.get(name, 0) for name in PACK_NAMES}},
            "compat_paths": {"phase22": w22.get("compat_allowed", 0), "phase22c": c22.get("compat_allowed", 0)},
            "screen_launches": {"phase22": {kind: w22.get(kind, 0) for kind in (
                "disrupt_screen.prefix", "disrupt_screen.subsets", "disrupt_screen.singles")}}}


def phase_23(ctx: dict) -> dict:
    """23. The mesh across cards: in the default run 23a on the one card
    (a config-12 cell's four shards as four placements of it, against one
    placement holding them); with ``--cards N`` 23b across N cards
    instead."""
    n_cards = ctx.get("cards", 0)
    if n_cards:
        c23 = run_cards_across(n_cards)
        paths = {f"phase23b-{path}": n for path, n in c23["launches"].items()}
    else:
        c23 = run_cards_phase("cuda")
        paths = {"phase23a": c23["launches"]}
    report_cards_phase(c23, ctx["card"])
    return {"pack_launches": {path: {name: n.get(name, 0) for name in PACK_NAMES} for path, n in paths.items()},
            "compat_paths": {path: n["compat_allowed"] for path, n in paths.items()},
            "pack_cases": {"ffd_pack": [{"captured": "phase23-held", **r} for r in c23["held"]["rows"]["b5"]]},
            "screen_launches": {path: {f"disrupt_screen.{k}": n.get(f"disrupt_screen.{k}", 0)
                                       for k in ("prefix", "subsets", "singles")} for path, n in paths.items()}}


PHASE_RUNNERS = {12: phase_12, 13: phase_13, 14: phase_14, 15: phase_15, 16: phase_16, 17: phase_17, 18: phase_18,
                 19: phase_19, 20: phase_20, 21: phase_21, 22: phase_22, 23: phase_23}
SELECTABLE_PHASES = tuple(range(14, 24))


PHASE_T: dict = {}
LANE_PROCS: list = []  # the lane processes this run started, polled at every phase mark


def phase_mark(n: int) -> None:
    """Phase ``n`` starts: its seconds run from here to the next mark. A
    lane process that has failed by then fails the run."""
    for lane in LANE_PROCS:
        rc = lane["proc"].poll()
        if rc not in (None, 0):
            lane_failed(lane, rc)
    DEPTH.update(phase_depth(n))
    PHASE_T[n] = time.perf_counter()


def phase_seconds(t_end: float) -> dict:
    marks = sorted(PHASE_T.items(), key=lambda mark: mark[1])
    return {n: round((marks[i + 1][1] if i + 1 < len(marks) else t_end) - t, 3) for i, (n, t) in enumerate(marks)}


def run_runners(ctx: dict, phases) -> dict:
    """``phases`` of ``PHASE_RUNNERS`` in order in this process, each
    after its mark → {phase: what it adds to the kernels line}."""
    parts = {}
    for n in phases:
        phase_mark(n)
        parts[n] = PHASE_RUNNERS[n](ctx)
        emit({"elapsed_s": lane_elapsed_s(ctx), "after": f"phase {n}"})
    return parts


def share_host() -> None:
    """Every lane gets its share of the host's cores for torch's CPU
    threads, so that the lanes' CPU solves do not oversubscribe them."""
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // len(LANES)))


def run_phases(phases: list, cards: int = 0) -> None:
    """``--phases``: the card and the build as ``main`` has them, then only
    ``phases`` of ``SELECTABLE_PHASES``, in order, at full depth; with
    ``cards`` (``--cards N``, phase 23 alone) phase 23 runs across that
    many cards. Prints no result line: the contract's last line is
    ``main``'s."""
    from karpenter_core_tpu_torch.solver import contracts

    t0 = time.time()
    _, card, sm_mhz = probe_card()
    contracts.enable()  # a shape contract's breach fails the phase it fires in
    build_kernels()
    run_runners({"card": card, "sm_mhz": sm_mhz, "t0": t0, "lane": tuple(phases), "cards": cards}, phases)


def run_lane(phases: list, pace: float, t0: float, out_path: str) -> None:
    """``--lane``: one lane of ``main``'s, in a process of its own: the
    card and the build, the depth ``main``'s pace gives, then ``phases``;
    what they add to the kernels line and their seconds are pickled to
    ``out_path`` for ``main``."""
    from karpenter_core_tpu_torch.solver import contracts

    _, card, sm_mhz = probe_card()
    contracts.enable()
    build_kernels()
    share_host()
    DEPTH_PLAN.update(depth_plan(pace))
    ctx = {"card": card, "sm_mhz": sm_mhz, "t0": t0, "lane": tuple(phases)}
    first_s = lane_elapsed_s(ctx)
    parts = run_runners(ctx, phases)
    with open(out_path, "wb") as f:
        pickle.dump({"parts": parts, "phase_s": phase_seconds(time.perf_counter()), "first_s": first_s}, f)


def relay(path: str) -> None:
    """A lane's output, line by line, as this process's own."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return
    for line in text.splitlines():
        print(line, flush=True)
        if LOG_PATH and line.startswith("{"):
            with open(LOG_PATH, "a") as f:
                f.write(line + "\n")


def start_lane(phases, pace: float, t0: float, tmp: str) -> dict:
    """Start ``chip_smoke.py --lane`` for ``phases``, its output kept
    under ``tmp`` until ``main`` relays it."""
    stem = os.path.join(tmp, "lane-" + "-".join(map(str, phases)))
    out, err = open(stem + ".out", "w"), open(stem + ".err", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lane", ",".join(map(str, phases)), "--pace", repr(pace),
         "--t0", repr(t0), "--out", stem + ".pkl"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out, stderr=err, start_new_session=True)
    out.close()
    err.close()
    return {"phases": tuple(phases), "proc": proc, "stem": stem}


def lane_failed(lane: dict, rc) -> None:
    relay(lane["stem"] + ".out")
    try:
        with open(lane["stem"] + ".err") as f:
            err = f.read()[-3000:]
    except OSError:
        err = ""
    fail(f"the lane of phases {list(lane['phases'])} exited {rc}: {err}")


def finish_lane(lane: dict, deadline_s: float) -> dict:
    """Wait for a lane (at most ``deadline_s``), relay its output → what it
    pickled. Fails if it does not end 0 in time."""
    try:
        rc = lane["proc"].wait(timeout=max(1.0, deadline_s))
    except subprocess.TimeoutExpired:
        lane_failed(lane, f"nothing: still running after {deadline_s:.0f} s")
    if rc != 0:
        lane_failed(lane, rc)
    relay(lane["stem"] + ".out")
    with open(lane["stem"] + ".pkl", "rb") as f:
        return pickle.load(f)


@contextlib.contextmanager
def lanes_running(pace: float, t0: float):
    """``LANES[1:]`` started, each in a process of its own; on the way out
    every one still running is killed with the processes it started."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lanes_") as tmp:
        try:
            LANE_PROCS.extend(start_lane(lane, pace, t0, tmp) for lane in LANES[1:])
            yield LANE_PROCS
        finally:
            for lane in LANE_PROCS:
                if lane["proc"].poll() is None:
                    os.killpg(lane["proc"].pid, signal.SIGKILL)
                    lane["proc"].wait()
            LANE_PROCS.clear()


def kernels_parts(parts: list) -> dict:
    """The parts phases 12-22 add to the kernels line, merged in phase
    order."""
    k = {"compat_paths": {}, "compat_captured": {}, "compat_err": [], "pack_launches": {},
         "pack_cases": {name: [] for name in PACK_NAMES}, "screen_launches": {}, "screen_cases": [],
         "relax_splits": None, "config12": None}
    for part in parts:
        for key in ("compat_paths", "compat_captured", "pack_launches", "screen_launches"):
            k[key].update(part.get(key, {}))
        k["compat_err"] += part.get("compat_err", [])
        k["screen_cases"] += part.get("screen_cases", [])
        for name, rows in part.get("pack_cases", {}).items():
            k["pack_cases"][name] += rows
        for key in ("relax_splits", "config12"):
            if key in part:
                k[key] = part[key]
    return k


def main() -> None:
    import torch

    from karpenter_core_tpu_torch.solver import compat_kernels as ck
    from karpenter_core_tpu_torch.solver import contracts
    from karpenter_core_tpu_torch.solver.solver import TorchScheduler

    t_start, t0 = time.perf_counter(), time.time()
    # 1. device; 2. build
    phase_mark(1)
    kind, card, sm_mhz = probe_card()
    contracts.enable()  # for the whole run: a breach fails the phase it fires in
    phase_mark(2)
    usage = build_kernels()
    # the host's pace, and the depth phases 4-16 run at
    probe_s, pace = host_pace()
    DEPTH_PLAN.update(depth_plan(pace))
    emit({"pace": pace, "probe_s": probe_s, "probe_fast_s": PACE_PROBE_FAST_S, "plan": dict(DEPTH_PLAN),
          "cuts": {k: (DEPTH_FULL[k], DEPTH_PLAN[k]) for k in DEPTH_FULL if DEPTH_PLAN[k] != DEPTH_FULL[k]},
          "lanes": LANES, "card": card})

    # 3. kernel vs plain versions on the card
    phase_mark(3)
    rng = np.random.RandomState(0)
    ragged = (1, 31, 32, 33, 200, 300)
    for n_keys in range(1, len(ragged) + 1):
        for S, T in ((1, 1), (1, 37), (29, 1)):
            kernel_case(
                f"ragged keys={n_keys} S={S} T={T}",
                random_planes(rng, S, T, ragged[:n_keys]), reps=20, plain_reps=5, sm_mhz=sm_mhz,
            )
    pools, provider, pods = slice_world()
    sp = slice_planes(pools, provider, pods)
    slice_row = kernel_case(
        "slice 50k x 2000", sp, reps=200, plain_reps=20, sm_mhz=sm_mhz, profiled=True
    )
    probe_catalog = ck.catalog_to_device(
        sp["tm"], sp["th"], sp["tn"], sp["keys"], sp["avail"], torch.device("cuda")
    )
    emit({"profiler_probe": profiler_probe(
        probe_catalog, ck.signature_side(sp["sig"], sp["zone_ok"], sp["ct_ok"], probe_catalog)
    )})
    # the compat shapes of phases 6 and 7 (S = 12 and 13 signatures), from
    # their own worlds, built afresh so those phases' pods meet the solver
    # unmemoized
    spread_rows = [
        kernel_case(
            "config3 50k x 2000", slice_planes(*config3_world()), reps=200, plain_reps=20,
            sm_mhz=sm_mhz, profiled=True,
        ),
        kernel_case(
            "cluster-spread 50.8k x 2000", slice_planes(*cluster_spread_world()[:3]), reps=200,
            plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ),
    ]
    widths = [sp["tm"][k].shape[1] for k in sp["keys"]]
    for S in (4, 16, 17, 64, 65, 128, 512):
        kernel_case(
            f"S={S} x T=2048", random_planes(np.random.RandomState(2 + S), S, 2048, widths),
            reps=100, plain_reps=10, sm_mhz=sm_mhz, profiled=True,
        )
    # the compat shapes of phases 8 and 9, from their own worlds
    affinity_rows = [
        kernel_case(
            "config6 7k x 400", slice_planes(*config6_world()), reps=200, plain_reps=20,
            sm_mhz=sm_mhz, profiled=True,
        ),
        kernel_case(
            "anti-dense 10k x 200", slice_planes(*anti_dense_world()[:3]), reps=200,
            plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ),
        kernel_case(
            "anti-cluster 10k x 2000", slice_planes(*anti_cluster_world()[:3]), reps=200,
            plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ),
    ]
    # the compat shapes of phase 10, from their own worlds, claims pinned
    stateful_rows = []
    for label, world in (
        ("stateful-dense 10k x 200", stateful_dense_world),
        ("spread-skew 10k x 200", spread_skew_world),
        ("stateful-cluster 10.25k x 2000", stateful_cluster_world),
    ):
        w = world()
        stateful_rows.append(kernel_case(
            label, slice_planes(*w[:3], kube=w[6]), reps=200, plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ))
    # the compat shapes of phase 11's tensor passes, from their own worlds
    relax_rows = []
    for label, world in (
        ("oracle-mix 7.34k x 400", oracle_mix_world),
        ("oracle-cluster 7.34k x 2000", oracle_cluster_world),
        ("relax-cluster 50k x 2000", relax_cluster_world),
    ):
        w = world()
        relax_rows.append(kernel_case(
            label, slice_planes(*w[:3], kube=w[6]), reps=200, plain_reps=20, sm_mhz=sm_mhz, profiled=True,
        ))
    # the compat shapes of phase 14: bench config 7's world whole, and the
    # signatures of four of its teams alone (a warm tick's missing subset)
    c7 = Config7()
    c7_subset = [p for p in c7.pods if p.metadata.labels["bench-team"] in ("t0", "t1", "t2", "t3")]
    config7_rows = [
        kernel_case(
            label, slice_planes([c7.pool], c7.provider, c7_pods), reps=200, plain_reps=20,
            sm_mhz=sm_mhz, profiled=True,
        )
        for label, c7_pods in (("config7 10k x 500", c7.pods), ("config7 4-team subset x 500", c7_subset))
    ]
    del c7, c7_subset
    big_row = kernel_case(
        "S=8192 x T=2048",
        random_planes(np.random.RandomState(1), 8192, 2048, widths), reps=20, plain_reps=5,
        sm_mhz=sm_mhz, profiled=True, clock_launches=2000,
    )

    emit({"elapsed_s": time.perf_counter() - t_start, "after": "phase 3"})
    # phases 4-23 in LANES: the first here, each other one in a process of
    # its own, started now (the warm state on); phases 4-13 measure the
    # cold pipeline: the warm state off, so their repeated solves of one
    # batch stay pipeline solves (phase 14 runs it)
    lanes_at_s = time.time() - t0
    with lanes_running(pace, t0) as lanes, knobs(KARPENTER_TORCH_INCREMENTAL=0):
        share_host()
        phase_mark(4)
        # 4. the slice on the card: counts from 0 just before the main path
        solver = TorchScheduler(pools, provider, device="cuda")
        cold, cold_ms, warm_runs, slice_launches = solve_runs(solver, pods)
        if slice_launches == 0:
            fail("the solve never launched the compat kernel")
        same_as_cpu(cold, TorchScheduler(pools, provider, device="cpu").solve(pods), "slice")
        check_invariants(cold, pods)
        emit(
            {
                "slice": f"{N_PODS} pods x {N_TYPES} types (bench config 3 mix without spread)",
                **timing_row(cold, cold_ms, warm_runs, slice_launches),
                **profile_solve(solver, pods),
            }
        )

        phase_mark(5)
        # 5. the cluster: existing nodes, daemonset overhead, NodePool limits
        cluster = run_cluster_phase("cuda")

        # 6. bench config 3 whole; 7. with the cluster, its kube store and an
        # HA front end
        phase_mark(6)
        config3 = run_config3_phase("cuda")
        phase_mark(7)
        cluster_spread = run_cluster_spread_phase("cuda")

        # 8. bench config 6 whole; 9. config 13's anti_dense and a zone
        # quorum against the cluster and its kube store
        phase_mark(8)
        config6 = run_config6_phase("cuda")
        phase_mark(9)
        anti_dense, anti_cluster = run_anti_phase("cuda")

        # 10. config 13's stateful_dense and spread_skew, and the stateful
        # cluster: host ports, CSI limits and zone-pinned claims
        phase_mark(10)
        stateful_dense, spread_skew, stateful_cluster = run_stateful_phase("cuda")

        # 11. the greedy scheduler alone (bench config 1, host only), the
        # greedy fallback beside the tensor path (config 6 and Helm releases
        # with the soft anti-affinity preset, as built and against the
        # cluster), preference relaxation against the cluster under a zone
        # drought, and packing parity against the greedy scheduler
        phase_mark(11)
        config1 = run_config1_phase()
        oracle_mix, oracle_cluster = run_oracle_phase("cuda")
        relax_cluster = run_relax_phase("cuda")
        parity6, parity1 = run_parity_phase("cuda")
        emit({"phase11": {
            "config1_pods_per_s": config1["pods_per_s"],
            "packing_parity_vs_oracle": {
                "config6_subsample": parity6["packing_parity_vs_oracle"],
                "config1": parity1["packing_parity_vs_oracle"],
            },
            "card": card,
        }})

        t_lane0 = time.perf_counter()
        emit({"elapsed_s": t_lane0 - t_start, "after": "phase 11"})
        lane_out = [finish_lane(lane, LANE_DEADLINE_S - (time.time() - t0)) for lane in lanes]

    t_end = time.perf_counter()
    phase_s = phase_seconds(t_lane0)
    for out in lane_out:
        phase_s.update(out["phase_s"])
    emit({"pace_summary": {"pace": pace, "cut": DEPTH_PLAN["cut"], "predicted_s": DEPTH_PLAN["predicted_s"],
                           "script_s": t_end - t_start, "phase_s": dict(sorted(phase_s.items())),
                           "lane_s": [round(sum(phase_s[n] for n in lane), 3) for lane in LANES],
                           "lane_start_s": [round(out["first_s"] - lanes_at_s, 3) for out in lane_out],
                           "lane0_wait_s": round(t_end - t_lane0, 3)},
          "card": card})
    parts = {n: part for out in lane_out for n, part in out["parts"].items()}
    kp = kernels_parts([parts[n] for n in sorted(parts)])

    # the kernels line, then the last line
    paths = {
        "slice": slice_launches, "cluster": cluster["kernel_launches"],
        "config3": config3["kernel_launches"], "cluster-spread": cluster_spread["kernel_launches"],
        "config6": config6["kernel_launches"], "anti-dense": anti_dense["kernel_launches"],
        "anti-cluster": anti_cluster["kernel_launches"],
        "stateful-dense": stateful_dense["kernel_launches"], "spread-skew": spread_skew["kernel_launches"],
        "stateful-cluster": stateful_cluster["kernel_launches"],
        "oracle-mix": oracle_mix["kernel_launches"], "oracle-cluster": oracle_cluster["kernel_launches"],
        "relax-cluster": relax_cluster["kernel_launches"],
        "parity-config6": parity6["kernel_launches"], "parity-config1": parity1["kernel_launches"],
        **kp["compat_paths"],
    }
    path_keys = (
        "shape", "S", "T", "W", "kernel_ms", "profiled_kernel_ms", "wrapper_ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by", "max_abs_err",
    )
    emit(
        {
            "kernels": [
                {
                    "name": "compat_allowed",
                    "route": "cuda",
                    "source": "karpenter_core_tpu_torch/csrc/compat_allowed.cu",
                    "replaces": "karpenter_core_tpu/solver/pallas_kernels.py:118",
                    "launches": sum(paths.values()),
                    "launches_by_path": paths,
                    "max_abs_err": max(
                        [row["max_abs_err"] for row in [
                            slice_row, big_row, *spread_rows, *affinity_rows, *stateful_rows, *relax_rows,
                            *config7_rows, *[r for rows in kp["compat_captured"].values() for r in rows],
                        ]] + kp["compat_err"]
                    ),
                    "ms": slice_row["kernel_ms"],
                    "kernel_ms": slice_row["kernel_ms"],
                    "profiled_kernel_ms": slice_row["profiled_kernel_ms"],
                    "wrapper_ms": slice_row["wrapper_ms"],
                    "plain_ms": slice_row["plain_ms"],
                    "bound_ms": slice_row["bound_ms"],
                    "bound_by": slice_row["bound_by"],
                    "alu_ceiling_ms": slice_row["alu_ceiling_ms"],
                    "library_ms": slice_row["library_ms"],
                    "at_8192x2048": {
                        k: big_row[k]
                        for k in (
                            "kernel_ms", "profiled_kernel_ms", "wrapper_ms", "plain_ms",
                            "library_ms", "bound_ms", "bound_by", "alu_ceiling_ms",
                        )
                    },
                    "at_spread_paths": [{k: row[k] for k in path_keys} for row in spread_rows],
                    "at_affinity_paths": [{k: row[k] for k in path_keys} for row in affinity_rows],
                    "at_stateful_paths": [{k: row[k] for k in path_keys} for row in stateful_rows],
                    "at_relax_paths": [{k: row[k] for k in path_keys} for row in relax_rows],
                    "at_config7_paths": [{k: row[k] for k in path_keys} for row in config7_rows],
                    **kp["compat_captured"],
                    "compat_route": slice_row["compat_route"],
                    "ptxas": usage,
                },
                *[pack_kernel_entry(name, kp["pack_cases"][name], kp["pack_launches"],
                                    kp["relax_splits"] if name == "dual_ascent" else None,
                                    config12=kp["config12"] if name == "ffd_pack" else None) for name in PACK_NAMES],
                screen_kernel_entry(kp["screen_cases"], kp["screen_launches"]),
            ]
        }
    )
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one NVIDIA card and hold every kernel "
                                             "against its plain version.")
    ap.add_argument("--log", default=None, metavar="PATH", help="append every emitted line to PATH too")
    ap.add_argument("--phases", default=None, metavar="N[,N...]",
                    help=f"build the kernels, then run only these phases (of {list(SELECTABLE_PHASES)}); "
                         "no result line")
    ap.add_argument("--cards", type=int, default=0, metavar="N",
                    help="with --phases 23: run phase 23 across N cards of this host (N >= 2)")
    # one of main's lanes, in the process main starts for it
    ap.add_argument("--lane", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pace", type=float, default=1.0, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=0.0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    cli = ap.parse_args()
    if cli.log:
        LOG_PATH = cli.log
        os.makedirs(os.path.dirname(os.path.abspath(LOG_PATH)), exist_ok=True)
    if cli.lane is not None:
        run_lane([int(n) for n in cli.lane.split(",")], cli.pace, cli.t0, cli.out)
    elif cli.phases is None:
        if cli.cards:
            fail("--cards runs phase 23 alone: give it with --phases 23")
        main()
    else:
        try:
            selected = [int(n) for n in cli.phases.split(",")]
        except ValueError:
            selected = []
        if not selected or any(n not in SELECTABLE_PHASES for n in selected):
            fail(f"--phases takes a comma-separated list of {list(SELECTABLE_PHASES)}, not {cli.phases!r}")
        if cli.cards and (selected != [23] or cli.cards < 2):
            fail(f"--cards takes N >= 2 with --phases 23 alone, not --cards {cli.cards} with --phases {cli.phases}")
        run_phases(selected, cli.cards)
