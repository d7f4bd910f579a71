"""Smoke run of cilium_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

1. Builds the port's CUDA kernels (csrc/*.cu → build/cilium_tpu_torch/),
   counts the IGMMA (int8 wgmma) instructions cuobjdump -sass finds in
   the bool_mm kernels (none fails the run), and holds every kernel
   against its plain version on shapes the main paths do not reach
   (ragged sizes, K2 at every tile edge of k2_edge_shapes(), K12 over
   1, 2 and 4 shards of one device, the 16-8-8 trie, out-of-range trie
   bytes and child ids, wide policymaps, global-atomic histograms; K4
   on sorted and shuffled columns around its staging budget and over
   shard lists in both row modes, K6 with one to three terms:
   edge_checks8; K9's frontend index on its traps: repeated keys, ANY
   frontends before and after specific ones, protocol-0 flows, dport -1
   against padded slots, one forced chain, F = 20 000: edge_checks4;
   K10 on tables at ~90% load: edge_checks5; K7, K5 and K11's stride-8
   entry on the layouts that choose their routes, each launch on the
   route its layout names: edge_checks9; K3 on both trie layouts at
   ragged batch sizes and offset views, K1's staged and wide routes over
   W 1 to 800, S 1 to 640, CPS 0 to 3, N 0 to 2 048 and its conjunct
   kinds: edge_checks10; K8 on its vector and scalar row reads, and K7's
   class route on the same tables' byte classes, over odd and even
   max_len from 0 to 256, offset views, B = 0 to 200 003, Q 126 tables
   whose byte classes fit and do not, and a pair table _pair_table did
   not build: edge_checks11; K11's IPv6 entry on its vector and
   scalar routes at K 0 to 16, levels 8 / 12 / 16, B = 0 to 1 048 583,
   addresses that differ from a stored prefix in each byte 0-15, bytes
   outside [0, 255] in either 32-byte sector of a row and rows past the
   shed table, and the C entry's refusals: edge_checks12).
2. Builds the headline deployment of bench.py with the port's own
   modules: 10 000 rules over 512 apps (30% with an L4 port), 2 048
   identities with one /32 and one fd00::{hi}:{lo}/128 ipcache entry
   each (bench.py:588-593), 64 endpoints.
3. Drives three main paths, every launch count set to 0 just before
   each and read just after; each fails unless its kernels launched;
   a path that launched K1 prints the route its latest launch took:
   - v4: PolicyEngine.refresh → DatapathPipeline.rebuild → process()
     of 1 048 576-flow batches, once with an empty prefilter (identity
     walk only) and once with the four bench prefilter CIDRs plus two
     IPv6 deny prefixes (the fused deny+identity walks);
   - v6: process_v6() of a 1 048 576-flow IPv6 batch (1/16 of the
     peers in 2001:db8::/32, the world) on both pipelines: the elided
     identity walk (K = 13 shared bytes, 3 levels) and the fused walk;
   - attribution: set_attribution(True) on the prefilter pipeline, then
     one v4 and one v6 batch (the attribution sweep, the first-rule
     reductions and the policymap kernel's attribution entry).
4. Holds 65 536 flows of each v4 and v6 run against the same path run
   with device="cpu" (the plain PyTorch versions) and 400 against the
   host oracle Repository.allows_ingress plus prefilter membership;
   holds the attribution (rule, l4_covered, rule hits, counters and the
   rule_hits_total / drop_reasons_total deltas) of 16 384 flows of each
   family against a CPU pipeline over the first four endpoints, and
   explain_one against the CPU engine; then a small world with deny and
   L7 rules, where every attribution reason code must occur on the card.
4d. The L7 main path, launch counts from zero (L7DeviceBatch off, then
   on; the off half must launch no fused or pair walk):
   - a 3-field HTTP policy at the pattern cap (7 methods, 64 path
     patterns, one of them demoted to host re, 3 hosts; fused Q 735, K7
     only): HTTPPolicy.check_batch of 131 072 requests, paths longer
     than 128 and 256 among them;
   - Kafka (bench.py:290-308): 32 produce rules, 100 000 requests
     through Proxy.check_kafka (the literal walk on K8 at rung 3), and
     handle_kafka_bytes on produce frames with allowed and rejected
     topics;
   - the redirect path: the bench world again with every port-80 rule
     carrying HTTP rules of the bench's L7 corpus, refreshed and rebuilt;
     process() of the v4 batch, the redirects from
     EndpointManager.regenerate_all(pipe, proxy=proxy) over one Endpoint
     per bench endpoint (equal to build_redirects' from
     resolve_l4_policy, every HTTPPolicy / KafkaACL on the card), and one
     HTTP request per redirected flow of an HTTP batch (131 072 port-80
     flows to the redirecting peers) through Proxy.check_http.
   Each is held against the port's CPU path (a slice) and re.fullmatch
   of the rules (400 requests), on and off. K8's launches are printed
   by table and shape with their route, Q and class table width C;
   every one must take the "classes" route.
4e. The services+CT main path, launch counts from zero: the bench world
   plus one egress rule per endpoint app (pods of zones z0-z3 on the
   service ports; the bench world alone has no egress rule, so every
   egress flow would drop), a ServiceManager with 1 024 v4 ClusterIP
   frontends in 10.96.0.0/16 and 256 v6 ones in fd00:96::/112 (1-8
   backends at bench identity addresses, weights on a quarter, 16 v4
   and 4 v6 with no backend, ANY frontends on a specific one's VIP and
   port) and a FlowConntrack of 2^22 slots. Each family runs four
   1 048 576-flow batches through process() / process_v6() with sports:
   egress pass 1 (1/4 to the frontends; LB stage on K9, miss tail, CT
   creation), pass 2 (the same batch: admitted flows bypass, only the
   rest reach K4), the replies from each flow's backend with the ports
   flipped and return_rev_nat=True, and an overlay batch (1/8 of the
   lanes carry tunnel identities, half unknown). Host-clock times of
   each pass and its stages (LB stage, CT lookup, miss tail, CT create).
   Checks: both K9 entries launch once per egress batch, pass 2 dispatches exactly
   the flows pass 1 did not admit, replies of admitted flows forward
   with their services' revNAT ids, and 400 translated flows of each
   family against Repository.allows_egress for the backend's identity
   and port; then the first 65 536 flows of each sequence on a CPU
   pipeline (its own conntrack) and on the card: outputs, counters and
   live CT keys after every pass.
4f. The device-CT main path, launch counts from zero: the services
   world with no LB (an LB table sends a family to the host CT), as
   DatapathPipeline(engine, cache, pf, device_ct_bits=22), and per
   family four 1 048 576-flow passes: egress pass 1 and the same batch
   again (K3 / K5, K4 without counters, both K10 entries), the replies
   from each flow's destination (without LB, the peer itself) with the
   ports swapped, and the overlay batch, which must take the host CT
   fallback (no K10 launch). Host-clock times beside the host-CT
   pipeline's passes of 4e; admitted, inserted, lost, established
   counts. Checks: nothing is established on the fresh table, no flow
   whose policy verdict is a drop comes back established, pass 2
   establishes exactly the flows whose keys pass 1 inserted, every
   reply of an inserted flow forwards; then the first 65 536 flows of
   each sequence on a CPU pipeline (device="cpu", same device_ct_bits,
   time.monotonic pinned for both) and on the card: outputs, counters,
   the device table slot by slot and the host CT keys after every pass.
4g. The submit and admission main path, launch counts from zero: the
   bench world with the prefilter CIDRs as DatapathPipeline(...,
   admission=True, prefilter_shed=True, pipeline_max_depth=8). 8 v4
   batches of 1 048 576 flows through process() one by one and through
   submit() at depth 2 and at depth 4 (resolved after all were
   submitted), each twice, in the order serial, 2, 4, 4, 2, serial; 4
   v6 batches serially and at depth 2 (serial, 2, 2, serial); two
   host-CT batches serially and at depth 2. Wall time and the card's busy share
   (CUDA events around every K3 / K5 and K4 launch, summed, over the
   wall) of each; outputs and counters equal across them (and the CT
   entry count for the host-CT pair). With 50 ms of work queued ahead
   on the stream, a depth-2 submit() must return before its batch ran
   (event.query() False): no hidden sync. Then the admission gate, forced by
   the fault hub, on a deny-heavy batch of each family (3/4 of the
   peers moved to the world): shed lanes DROP_PREFILTER, no lane the
   ungated run forwards shed, kept lanes equal, admission_shed_total
   and drop_reasons_total{producer="admission"} moved by the shed
   count; the _shed_walk and process() wall times; the route of the v6
   gate's K11 launch, printed.
4h. The incremental-update main path, launch counts from zero, on a
   bench world of its own (bench.py:2622-2770 without the epoch swap):
   the full refresh + forced rebuild for comparison; then through
   PolicyEngine.refresh() → wait_device() → DatapathPipeline.rebuild()
   on the prefilter pipeline, 20 identity allocations (released between
   samples) and one burst of 16, 12 appends of an L3 rule from an
   endpoint's app to a new zone ∧ env selector and 12 deletes of them,
   and one append with attribution on (K6 on the column patch): p50 /
   p99 of refresh and of rebuild, patch hits (12 of 12), K2 / K6
   launches and each scatter helper's calls, card time and bytes per
   delta. After each kind: the patched pipeline against a forced full
   rebuild of a fresh engine (policymap words, bitmaps, rule tables,
   1 048 576-flow v4 and v6 verdicts) and the host oracle on 40 flows.
4i. The sparse-delta and epoch-swap main path, launch counts from zero,
   on a bench world of its own with DatapathPipeline(engine, cache,
   PreFilter(), sparse_deltas=True) (bench.py:2862-2877, :2742-2753):
   20 ipcache churn rounds a family (upsert a new address under an
   existing identity, rebuild, delete, rebuild) with the trie mirrors
   and with set_sparse_deltas(False): rebuild p50 / p99, patches,
   mirrors kept, the trie scatter ops' calls, card time and bytes; the
   fallbacks (a v6 address outside the elided bytes, a spent v4 node
   pool, a churn on the prefilter pipeline), each a full trie build;
   after each kind, 1 048 576-flow v4 and v6 batches whose first lanes
   carry the churned addresses == a fresh sparse-off pipeline, and the
   host oracle on 20 flows. Then two epoch swaps: a forced refresh
   (kick-to-publish wall, the publish and its trie build, beside a
   synchronous full rebuild) and a rule that gives endpoint 0's app
   port 9443 while 1 048 576-flow batches are served (each before the
   publish == the pre-append verdicts, after it == a synchronous
   rebuild); each shadow's state == a synchronous sweep of its snapshot.
4j. The multi-device placement main path, launch counts from zero, on a
   bench world of its own with DatapathPipeline(engine, cache,
   PreFilter(), sharding=True, mesh_2d=True): on the real one-card plan
   no grid forms and process() launches no K12; then the seam
   placement.visible_devices gives four records on cuda:0 (2 flows x 2
   ident) and rebuild, v4 and v6 1 048 576-flow process(), a depth-2
   submit() of three batches, one identity add, one rule append and one
   attributed batch of each family run on the ident-sharded tables (a
   batch makes one K4 launch a flow shard that reads each row in place
   from the ident shard owning it, and no K12; the sweeps read sel_match
   through K12); each result == the unplaced card pipeline and, on
   16 384 flows, the CPU plain path; K4 and K12 launches per batch and
   the 2D wall beside the unplaced one. Real multi-GPU transfers are not
   exercised: every record is one card.
4k. The failsafe main path, launch counts from zero, on the bench
   world's engine and batches (failsafe_main_path): the fault hub armed
   but quiet against off (bit-identical outputs, counters and launches,
   v4 and v6); each site (h2d, dispatch, complete) fired once as a
   transient (invisible) and as a poisoned fault (DROP_DEGRADED, one
   quarantine, the next batch clean), three transients at complete, and
   ct_epoch on a host-CT pipeline; the ladder on four virtual records
   (0 → 1 → 2 → 0: level 2 launches no K3 / K4 / K5 and equals the
   device verdicts on 65 536-flow cuts); the device-CT rescue (a
   poisoned completion after a 1M-flow pass on 2^22 slots, the next pass
   seeded: exactly the rescued flows established); a real stall under
   the watchdog (a spin on the stream ahead of one submitted batch: the
   waiter unblocks inside 2 x 50 ms plus one sweep, the late result does
   not overwrite it; a spun forced rebuild shows one compile stall).
   Every pipeline the other phases made ends at level 0 with no
   quarantine, and pipeline_faults_total moves only by the phase's own
   injected faults and stalls (FailsafeWatch, checked before and after
   the phase and at the end).
4l. The observe main path, launch counts from zero (observe_main_path):
   the tracer, the device profiler and the depth tuner on three new
   pipelines. 1 048 576-flow v4 and v6 process() on the bench world's
   prefilter pipeline, twice each with everything off, traced, and
   traced and profiled at every batch: results, counters and K3 / K4 /
   K5 launches equal; each traced batch's phases in ms and their
   coverage of its total_ns (within 20%, else the run fails), beside the
   sample's h2d / device_compute / d2h from CUDA events. Then the
   services (host CT + LB) and device-CT v4 passes of 4e / 4f on fresh
   pipelines, traced and sampled: each pass equal to its phase's, one
   sample a K4 launch. One pattern-cap check_batch with L7DeviceBatch
   on, sampled at the l7 site, equal to 4d's. Then 8 v4 batches
   submitted at depth 2, autotune off and on (epoch 2, max depth 4) in
   turns off, on, on, off: the depth after each submit, the tuner's
   state, results, counters and launches equal. Last, with everything
   off, one batch builds no trace, span, profiler, sample or tuner.
4m. The events main path, launch counts from zero (events_main_path):
   flow events and the flow ring with a MonitorHub, one subscriber and
   FlowAttribution on, the tracer and the profiler at every batch. The
   1 048 576-flow v4 and v6 batches with drop notifications on (the v4
   one also streamed through a MonitorServer on a unix socket to a
   monitor_stream client, which must receive every event the hub
   published), then the same two with no subscriber (nothing
   published), a 65 536-flow v4 batch with verdict notifications (one
   PolicyVerdictNotify a flow), a device-CT batch (4f's v4 pass 1) and a
   1 048 576-flow batch forced through the admission gate. Each batch's
   DropNotify count equals its lanes with verdict >= DROP_POLICY, each
   reason agrees with the verdict and the attribution arrays, the ring
   records at most SAMPLE_CAP flows a batch, drops first, and a
   subscriber moves neither the results, the launches nor the d2h
   transfers. Prints per batch the events published, the emit_events
   phase's wall, the events a second and the flows recorded.
4n. The restore main path, launch counts from zero (restore_main_path):
   the bench engine's snapshot saved with both directions' policymaps;
   a fresh engine's trusted restore (no K1) and a fresh pipeline's v4
   and v6 1M-flow batches, equal to the original's (results, counters,
   the DevicePolicy words), with the load, upload, rebuild and
   restore-to-first-batch (on_first_batch) walls beside a full refresh
   + rebuild of the same world; an untrusted restore on a copy of the
   world, one rule added, the background refresh kicked: the batches
   served on the restored tables meanwhile equal the original's and,
   on 65 536 flows, the CPU plain path over the restored tables; the
   install runs on the refresh thread after the event recorded on its
   side stream completed, and after rebuild() the results equal a
   fresh engine's. The CT snapshot of the services world's 2^22-slot
   table after pass 1: saved, loaded, restored into a fresh pipeline's
   table with the hold, the held rebuild keeps every entry and pass 2's
   miss tail holds none of them; with a rule added first, the rebuild
   flushes them. A device-CT pipeline's table is kept by a held rebuild
   and reset by an unheld one.
4o. The endpoints and native main path, launch counts from zero
   (endpoints_main_path): a fresh bench world, engine and prefilter
   pipeline; one Endpoint per bench endpoint (its identity, v4 and v6
   address) in an EndpointManager, regenerate_all: 64 regenerated, each
   READY at the compiled revision with its PolicyMap equal to the
   pipeline's snapshot, at the launches of one full refresh + rebuild (K1
   once, K2 for the two directions' sweeps, equal to a second fresh
   engine's refresh + rebuild timed beside it), per-endpoint
   RegenerationStats p50 / max; one rule added and regenerate_all again
   (the sync_policy_map totals equal the snapshot diff); LXCMap.
   sync_endpoints. Then the native C++ enforcer, built with g++
   (native.build.load(), never skipped): NativeFastpath.from_pipeline(
   pipe, ct_bits=22) equal to the card pipeline on every lane of the v4
   and v6 1 048 576-flow batches in both directions, and in its
   per-endpoint counters; its verdicts/s on 1 and 4 host threads beside
   the card pipeline's process() wall; from the services world with no
   CT (one egress 1M-flow batch a family, K9 on the card) its LB stage
   equal to the card's; load_l7_http from the bench L7 corpus policy (16
   path patterns) and check_http_batch of 131 072 requests equal to
   HTTPPolicy.check_batch on the card (K7), the Kafka ACL of 4d the same
   way, and the pattern-cap policy refused (NativeL7Unsupported).
4p. The distributed-state main path, launch counts from zero
   (distributed_main_path): a KVStoreServer on loopback; agent A on an
   InMemoryBackend of the server's own store, agent B a NetBackend over
   TCP; each with its own bench repository, an IdentityRegistry behind a
   DistributedIdentityAllocator, an IPCache behind an IPIdentitySync and
   a PolicyEngine. The 2 048 bench label sets are allocated in order, A
   owning one in eight (its 512 addresses: one ipcache delta window), B
   the rest, 1 in 16 by both; an agent allocates once its watch has
   delivered every earlier allocation, so both registries give each
   identity the same row. Each owner upserts and announces its v4 /32 and
   v6 /128; both pump until every entry came from the store. Checks:
   equal registries (ids, labels, rows) and ipcaches; after each agent's
   refresh and rebuild on the card (B with sparse_deltas) one K1 launch
   and two sweeps an agent, both directions' policymap id_bits equal on
   the card; the v4 and v6 1 048 576-flow batches, ingress and egress,
   equal on A, B and a single-node bench pipeline (endpoints matched by
   labels; uncounted), every lane and counter. A's lease revoked: B's
   rebuild patches its tries (each of A's prefixes, mirrors kept), a
   second B pipeline without sparse deltas rebuilds them in full
   (uncounted), both == a fresh pipeline (uncounted); run_gc over TCP reaps exactly the identities only A
   held, B's refresh takes the release as a "rows" delta (no K1), both
   pipelines == a fresh engine's full compile. A FederationMember on each
   agent (A on a new session), the epoch swap on, one rule pushed at
   both: each shadow build swaps in (policy_epoch 1) and
   wait_cluster_epoch(1) converges within 30 s. Cluster east exports the
   services world's v4 frontends with half their backends, B keeps the
   other half and merges east's through ClusterMesh: B's 1 048 576-flow
   v4 egress batch through its LB stage (K9 once) == a pipeline given the
   merged set directly (uncounted), every lane of the outputs and of the
   LB stage's translation. Two subprocesses with a scrubbed environment call
   mesh_bootstrap (gloo, loopback) and resolve_plan(placement_config(),
   sharding=True): each summary 2 processes, its own rank, 1 local and 2
   global cards, the same plan generation and axes, its card tagged with
   its rank; each runs a 65 536-flow small-world v4 batch on its card,
   equal to the other's and to this process's (uncounted). On one card
   each child sees only its own, so the plan check shows the rank tag
   and the agreement, not the process_index filter against its fallback
   (tests/test_torch_mesh_bootstrap.py shows that). Prints the CAS allocation
   wall per identity in memory and over TCP, the pump, the rebuild walls
   after the lease death and the GC, the push-to-convergence wall and
   the bootstrap walls.
4q. The fleet-observability main path, launch counts from zero
   (fleet_main_path): two agents, A and B, over the bench repository,
   registry and ipcache of section 2, each with its own PolicyEngine (a
   full compile: K1 and the sweeps), a pipeline on the card with the
   tracer, the admission gate and the prefilter CIDRs, and a
   FederationMember on a NetBackend to one KVStoreServer (TCP loopback);
   an EventJournal on the pipeline's, its admission controller's and
   the member's on_journal slots, a JournalPublisher and a FleetSampler
   on the member's backend. A is primed, serves four v4 and four v6
   1 048 576-flow batches and is sampled; then B with two of each: vps x
   dt equals the verdicts the pulled arrays hold, drop_ratio their drop
   share, transfer_bps x dt the bytes device_transfer_bytes_total moved,
   and p50 / p99 the quantiles of the process's batch histogram after
   exactly these batches' traces (it also holds every earlier phase's
   traced batches). A's journal, in the order of the operations: the
   first rebuild, an identity delta's one rebuild (its basis the
   pipeline's _mat_basis), an epoch swap on both agents (epoch_swap with
   policy_epoch 1, then the publishing rebuild; the cluster epoch 1 on
   both), a deny-heavy batch through submit with the gate forced (K11;
   shed_start), shed_end after SHED_HOLD_S with the controller's
   per-reason move, and two poisoned completions on A (in watch.allowed)
   moving the ladder to single-device and three clean cut batches back;
   every kind and severity the reference's. B's merged timeline holds
   both nodes' events, HLC-consistent; aggregate of fresh telemetry
   frames: 2 nodes, epoch skew 0, fleet_vps the frames' sum. Prints the
   walls of sample_once, publish_once, a telemetry publish + pump,
   merged_timeline, a v4 batch with the planes armed and unarmed, and
   each objective's burn ratio per window (no state asserted). The
   phase's identity and rule are taken out again at its end; the phase
   fails past 30 s.
4r. The Kubernetes and DNS policy sources, launch counts from zero
   (k8s_main_path): a cluster drawn from the seed (k8s_cluster: 2 048
   dual-stack Pods in 32 labelled Namespaces, 192 ClusterIP Services of
   the SVC_PORTS mix with 1-4 backends, 32 of them selector-less with
   external Endpoints, 16 behind an Ingress on the node's address, 8
   Nodes, 512 NetworkPolicies and multi-spec CNPs: podSelector /
   namespaceSelector peers, ipBlocks with an except, ports, 64 toServices
   and 64 toFQDNs specs) through cilium_tpu_torch.k8s.K8sWatcher into
   K8sAgent (the five methods a Daemon offers the watcher; a
   PolicyEngine and a DatapathPipeline on the card with its
   ServiceManager as the LB) and a DNSPoller with a seeded resolver.
   Six steps, each ended by a checkpoint (the CIDR identities of the
   rules' prefixes, refresh + rebuild) and a 1 048 576-flow v4 egress
   batch with services: the initial resync in the Informer's kind order
   and a poll (a v6 batch too), a MODIFIED CNP swapping its peer
   namespace and then a status-only MODIFIED (no revision, no ask, no
   launch), a pod deleted and re-added with other labels, a toServices
   target's Endpoints moved (a v6 batch too; its frontend's lanes go to
   the new backends), a toFQDNs answer moved by poll_once past the TTL,
   and a resync lacking one NetworkPolicy and one pod (both reaped).
   Each step: 8 192 lanes == the plain path over the same tables
   (verdicts, redirects, the LB stage's translation and revNAT ids), the
   oracle on 400 lanes and on lanes inside and outside each ipBlock's
   except, every lane that moved one the step touched and every touched
   lane == the oracle, some lane flipped, the LB frontends == the
   objects'. Prints each step's walls (event, CIDR identities,
   checkpoint, event to first verdict) and asks, the resync's time in
   policy_replace and in policy_translate + the LB sync, and the
   launches; fails past 45 s.
4s. The external proxy and its xDS channel, launch counts from zero
   (external_proxy_main_path): phase 3d's redirect world. The path
   under test is the child's request path, on the host of another
   process: it launches no kernel here, and the phase fails if a count
   moved. Into an xds.ResourceCache go the NPDS resources
   (endpoint_policy_resource) of the endpoints regenerated on the card
   and of the world's Kafka redirect, as many as keep their listeners
   under half the child's RLIMIT_NOFILE, and NPHDS rows mapping
   127.0.1.1-64 to the 64 most frequent source identities of the
   requests; 127.0.2.1 stays unmapped (the world). An XDSServer serves
   them on a unix socket, an AccessLogSocketServer collects the log. An
   unmodified ProxyLauncher child with no --device (the card) is
   spawned after the publication: spawn to the ACKs. The requests: 280
   of each of the 4 largest (endpoint, port) groups of phase 3d's set
   (1 120; paths past 256 bytes among them), each over a keep-alive
   HTTP/1.1 connection per (source alias, proxy port), an identity past
   the 64 and every 16th request from the unmapped alias; 8 Kafka
   produce frames of 32-33 topics to the Kafka redirect from a mapped
   and the unmapped alias. The card's check_batch of the same requests
   a group (and of each frame's topics), L7DeviceBatch off then on
   (equal; uncounted, the oracle's launches printed apart), decides:
   every 200 / 403 and Kafka ack / reject of the child equals it, and
   the streamed records equal the requests in number and verdict. Then
   one endpoint's resource without the rule that alone allows most of
   its group's requests (push to ACK): the requests the card flips flip
   in the child, the rest do not. Then a SIGKILL: one restart, kill to
   the first request it serves 200 (a request no rule allows the
   world), every listener bound, and the same answers again. Fails past
   45 s.
4t. Workload runtimes and health, launch counts from zero
   (workloads_main_path): a node at kubelet's defaults (110 containers,
   --max-pods; a /24 pod CIDR, --node-cidr-mask-size) over the bench
   world's rules (selectors in the any: source, so that they select the
   container: labels the workload watcher gives) and identities, behind
   two stand-ins for the Daemon (WorkloadAgent: a real IPAM, an
   EndpointManager of real Endpoints, a pipeline with a prefilter, a host
   FlowConntrack and a ServiceManager), one on the card and one on the
   plain versions, both with a 6 s regeneration debounce. Boot in one
   debounce window: the policy import's regeneration, the policy
   compiled, a DockerPlugin's libnetwork sequence up to Join, where netns
   is allowed three containers behind real veths, and one PLEG sweep of
   an in-process runtime (4 of its containers ignored), all folded into
   one regeneration (K1, K2). Then a batch of frames to the Docker
   endpoint, real UDP from the veth containers sniffed off their host
   veths, and 65 536 seeded Ethernet frames (802.1Q, fragments,
   truncated and non-IPv4 among them) through parse_ipv4_frame and
   WireEnforcer twice (the host CT pre-pass answers the replay; the miss
   tails on K3 and K4); then 10 containers exit, the Docker container
   leaves and the veth containers go, in the next window, and the frames
   once more. Every batch's flows enforced, per-endpoint counts and lanes
   equal the plain stand-in's; the health child (python -m
   cilium_tpu_torch.health) against a stub agent: READY, /probe,
   /status, a SIGKILL and its launcher's restart. Fails past 20 s.
5. Holds every kernel against its plain version on the card, at the
   main paths' shapes, with exact equality (all outputs are integers),
   and times kernel, plain version and, where one exists, a library
   call computing the same function (CUDA events: the median of five
   runs' per-launch means, after 50 ms of warm-up launches), printing
   the SM clock (nvidia-smi clocks.sm) right after each timed series.
   K1 is timed on both clocks too, its bound the larger of its bytes
   and one popcount a row for each nonzero word of a valid conjunct at
   132 SMs x 16 a clock (the SM clock read), the first version's dense
   int8-product figure printed beside it.
   K2 and K6 are also held, call by call, at the shapes one row patch,
   one column patch and one attributed column patch give them, and the
   largest of each is timed. K2 (at the sweep's shape and the three
   patch shapes), K4 (both entries), K6 and K12 are timed on two
   clocks, CUDA events around back-to-back wrapper calls and the same
   calls replayed from a CUDA graph (no wrapper host work), and so are
   K2's and K12's library yardsticks (torch._int_mm thresholded, the
   same function; bare torch._int_mm is printed beside it). K6 is
   timed on the sweep block's allow term [8 192, 640], on one
   three-term launch of the sweep, and on the attributed column
   patch's widest term [8 192, 4 096] and its three-term launch.
   The attribution flow-route sweep (_sweep_device_attrib, on K2 + K6)
   is timed the same way, its plain version with the plain K2 / K6, and
   so is the plain flow-route sweep (_sweep_device, off the main paths);
   then three sweeps are split into their K2 and K6 launches (CUDA
   events around each) and the rest.
   K7 (both entries) and K8 are timed on the bench's L7 corpus
   (bench.py:266-430: 16 path patterns, 131 072 requests) at every
   length rung, K8 on its pair table (its bound on the pair table's
   entries), K7 on the same rows on its [Q + 1, 256] and class routes
   (the L7 walk of this table from 16-byte rows), and K7 on the pattern-cap
   policy's fused table and at
   the shapes the L7 main path launched it (its launches by shape are
   printed; one redirect group's path batch, int32 at max_len 256, and
   one 16 384-row chunk of the pattern-cap table are timed, each with
   its launches at that shape). Each K7, K5 and K11 stride-8 line names
   the route its kernel took (the table in shared memory or through L2,
   the row bytes as 16-byte vectors or one a step). K9 is
   timed on each family's pass-1 batch (1 048 576 flows x 1 024 / 256
   frontends) on both clocks, the whole call (index build + probe) and
   the build entry alone, its bound the bytes the function needs (flows
   in, results out, the tables once); the probe entry alone is timed in
   a graph, and the compares of the first version's first-match scan
   are printed beside them. K10 (both entries and the verdict tail) is
   timed on each family's pass-1 inputs over a fresh table
   (insert-heavy) and its pass-2 inputs over the table pass 2 saw
   (hit-heavy), by CUDA events only (each step changes the table), its
   bound the lesser of the 32-byte sectors its windows need in the
   record layout and in the first version's seven arrays (both
   printed). K3, K5 and K11 (both entries) are timed on both clocks
   too; K11 on the gate's deny-heavy batches, its bound the trie bytes
   its identity walk touches, 9 bytes a flow and the shed table's
   sectors; its v6 entry on each route (vector, scalar: views 0 and 1
   int32 in) on the deny-heavy and the ungated batch, each beside its
   sector floor (what a read of only the 32-byte sectors the walk needs
   would move: one of a lane's two when its compare fails in bytes
   0-7, plus dport, proto and out). K12 is timed over both ident shards of the
   mesh phase's ingress id_bits (one launch, as the several-device
   route makes it a block; one card's 2D batch reads in place instead)
   on a 16 384-lane block of peer rows, its bound the block's rows
   written, the distinct owned rows read and the ids; its library
   yardstick torch.index_select on the whole table. The mesh phase's
   other shapes are recorded as its main path calls them and held call
   by call: K12 on the sweeps' sel_match reads of the first 2D rebuild
   (the largest timed), and K4 (both entries, gathered mode) over the
   shard lists of one v4 batch and one attributed v4 batch, a whole
   524 288-flow shard a call (one of each timed).

Prints each phase's wall time as it ends ("phase ..." lines, the
numbers of the sections above), then the card's name and power limit,
one JSON line with every kernel's numbers and, last, the result line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line. Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import ipaddress
import json
import random
import socket
import subprocess
import sys
import time
from pathlib import Path

N_RULES = 10_000
N_IDENTITIES = 2_048
N_ENDPOINTS = 64
N_APPS = 512
BATCH = 1 << 20
SLICE = 1 << 16
N_ORACLE = 400
PREFILTER_CIDRS = ["192.0.2.0/24", "198.51.100.0/24", "10.3.0.0/16", "10.250.7.0/28"]
V6_DENY = ["fd00::3:0/120", "fd00::5:10/124"]
N_ATTR_EPS = 4  # endpoints of the CPU pipeline the attribution slice is held against
ATTR_SLICE = 1 << 14
# L7 (bench.py:266-430 and :290-308): the 16-pattern path corpus, its
# 131 072-request batch, the 32-topic Kafka ACL and its 100 000 requests
L7_PATHS = [f"/api/v{i}/[a-z0-9]*" for i in range(8)] + [f"/svc{i}/.*" for i in range(8)]
L7_BATCH = 1 << 17
KAFKA_REQS = 100_000
L7_SLICE = 1 << 13  # requests of the pattern-cap policy held against the CPU path
N_L7_CPU_EPS = 4  # endpoints whose redirects are held against the CPU path

# services+CT (the LB stage's K9 and the host conntrack): frontends per
# family, the ports they take, conntrack slots (a load of 0.25 at 1M flows)
N_FE4, N_FE6 = 1024, 256
SVC_PORTS = [(80, "TCP"), (443, "TCP"), (8080, "TCP"), (5432, "TCP"), (53, "UDP")]
CT_BITS = 22

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# int8 tensor-core operations/s; int32 operations/s on the CUDA cores
# (the Hopper white paper's 64 INT32 lanes per SM x 132 SMs x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_world(seed: int, l7: bool = False, source: str = "k8s"):
    """bench.py build_world (10k rules / 2 048 identities) with the
    port's modules; rule and identity draws from ``random.Random(seed)``.
    With ``l7`` every port-80 rule also carries one to three HTTP rules
    over the bench's L7 corpus (bench.py:2416-2422: the eight
    /api/v{i}/[a-z0-9]* and eight /svc{i}/.* paths), half of them with
    a method (GET or POST), drawn from a second generator so that the
    rules, identities and endpoints are the same as without it. The
    rules' selectors name ``source`` (the identities' labels stay k8s:);
    "any" also selects the container: labels the workload watcher gives
    a container (phase 3t), the same draws otherwise."""
    from cilium_tpu_torch.identity import IdentityRegistry
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api import (
        EndpointSelector, HTTPRule, IngressRule, L7Rules, PortProtocol, PortRule, rule,
    )
    from cilium_tpu_torch.policy.repository import Repository

    rng = random.Random(seed)
    hrng = random.Random(seed + 80)

    def l7_rules(port):
        if not l7 or port != 80:
            return L7Rules()
        return L7Rules(http=tuple(
            HTTPRule(method=hrng.choice(["GET", "POST"]) if hrng.random() < 0.5 else "", path=p)
            for p in hrng.sample(L7_PATHS, hrng.randint(1, 3))))
    repo = Repository()
    rules = []
    for _ in range(N_RULES):
        app = rng.randrange(N_APPS)
        peer = EndpointSelector.make([f"{source}:app=a{rng.randrange(N_APPS)}"])
        if rng.random() < 0.3:
            port = rng.choice([80, 443, 8080, 53, 5432])
            proto = "UDP" if port == 53 else "TCP"
            ing = IngressRule(
                from_endpoints=(peer,),
                to_ports=(PortRule(ports=(PortProtocol(port, proto),), rules=l7_rules(port)),),
            )
        else:
            ing = IngressRule(from_endpoints=(peer,))
        rules.append(rule([f"{source}:app=a{app}"], ingress=[ing]))
    repo.add_list(rules)
    reg = IdentityRegistry()
    idents, labels_of = [], {}
    for _ in range(N_IDENTITIES):
        labels = [f"k8s:app=a{rng.randrange(N_APPS)}", f"k8s:zone=z{rng.randrange(8)}"]
        if rng.random() < 0.5:
            labels.append(f"k8s:env={'prod' if rng.random() < 0.5 else 'dev'}")
        ident = reg.allocate(parse_label_array(labels))
        idents.append(ident)
        labels_of[ident.id] = labels
    return repo, reg, bench_ipcache(idents), idents, labels_of


def bench_ipcache(idents):
    """An IPCache with one /32 and one fd00::{hi}:{lo}/128 entry an
    identity (bench.py:588-593)."""
    from cilium_tpu_torch.ipcache.ipcache import IPCache

    cache = IPCache()
    for i, ident in enumerate(idents):
        cache.upsert(f"10.{(i >> 8) & 255}.{i & 255}.1/32", ident.id, source="k8s")
        cache.upsert(f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128", ident.id, source="k8s")
    return cache


def make_flows(seed: int, n_idents: int):
    """bench.py's flow batch: peers drawn over the identity /32s."""
    import numpy as np

    nrng = np.random.default_rng(seed)
    i_sel = nrng.integers(0, n_idents, BATCH)
    ips = (
        np.uint32(10) << 24
        | ((i_sel >> 8) & 255).astype(np.uint32) << 16
        | (i_sel & 255).astype(np.uint32) << 8
        | 1
    ).astype(np.uint32)
    eps = nrng.integers(0, N_ENDPOINTS, BATCH).astype(np.int32)
    dports = nrng.choice(np.array([80, 443, 8080, 53, 22], np.int32), BATCH)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return ips, eps, dports.astype(np.int32), protos, i_sel


def make_flows6(seed: int, n_idents: int):
    """A v6 batch: peers fd00::{hi}:{lo} over the identities, 1/16 of
    them random addresses in 2001:db8::/32 (the world); ``i_sel`` is -1
    for a world peer."""
    import numpy as np

    nrng = np.random.default_rng(seed + 6)
    i_sel = nrng.integers(0, n_idents, BATCH)
    world = nrng.random(BATCH) < 1 / 16
    addr = np.zeros((BATCH, 16), np.int32)
    addr[:, 0] = 0xFD
    addr[:, 13] = (i_sel >> 8) & 255
    addr[:, 15] = i_sel & 255
    addr[world] = nrng.integers(0, 256, (int(world.sum()), 16))
    addr[world, :4] = (0x20, 0x01, 0x0D, 0xB8)
    i_sel = np.where(world, -1, i_sel)
    eps = nrng.integers(0, N_ENDPOINTS, BATCH).astype(np.int32)
    dports = nrng.choice(np.array([80, 443, 8080, 53, 22], np.int32), BATCH)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return addr, eps, dports.astype(np.int32), protos, i_sel


# K2's tile edges (rows around its 64 / 128-row tiles, contracted widths
# around its 16-byte vectors and 64-byte stages, columns around its
# 4-byte loads and 128-column tiles); tests/test_torch_verdict.py holds
# bool_mm_plain against JAX's _mm on the same shapes
K2_EDGE_B = (1, 63, 64, 65, 129, 8193)
K2_EDGE_A = (0, 1, 5, 31, 32, 33, 640, 641)
K2_EDGE_C = (1, 7, 8, 129, 4097)


def k2_edge_shapes():
    """(b, a, c) of K2's edge checks: every b with every a at c = 129,
    and every other c with every a at b = 65."""
    return ([(b, a, 129) for b in K2_EDGE_B for a in K2_EDGE_A]
            + [(65, a, c) for c in K2_EDGE_C if c != 129 for a in K2_EDGE_A])


def k2_edge_operands(b: int, a: int, c: int, seed: int):
    """Seeded numpy operands of one edge shape: x mostly 0 / 1 with a few
    -1 and 2 (int8 of any sign), w signed in -3..3."""
    import numpy as np

    rs = np.random.default_rng(seed)
    x = np.where(rs.random((b, a)) < 0.3, 1, 0) * rs.choice(
        np.array([1, 1, 1, 1, 1, 1, -1, 2], np.int8), (b, a))
    return x.astype(np.int8), rs.integers(-3, 4, (a, c)).astype(np.int8)


def igmma_count() -> int:
    """IGMMA (int8 wgmma) instructions in the SASS of the built library's
    bool_mm kernels (cuobjdump -sass)."""
    from cilium_tpu_torch import _kernels

    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(tool), "-sass", str(_kernels.build())],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump -sass: {r.stderr.strip()[:400]}")
    count, in_k2 = 0, False
    for line in r.stdout.splitlines():
        if "Function :" in line:
            in_k2 = "bool_mm_kernel" in line
        elif in_k2 and "IGMMA" in line:
            count += 1
    return count


def sm_clock() -> str:
    """The SM clock right now (nvidia-smi clocks.sm)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "?"


def timed(fn, **kw):
    """(cuda_ms of fn, the SM clock read right after the timed runs)."""
    ms = cuda_ms(fn, **kw)
    return ms, sm_clock()


def cuda_ms(fn, iters: int = 20, reps: int = 5, warm_s: float = 0.05):
    """Per-launch means (ms, CUDA events) of ``reps`` runs of ``iters``
    launches, sorted. Launches for at least ``warm_s`` seconds first, so
    that a card idle through the host phases has raised its clocks."""
    import torch

    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return sorted(out)


def graph_ms(fn, launches: int = 20, reps: int = 5):
    """Per-launch device time (ms) of ``fn`` without the wrapper's host
    work: ``launches`` calls captured in one CUDA graph, whose replays
    are timed as ``cuda_ms`` times calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    torch.cuda.synchronize()
    return [ms / launches for ms in cuda_ms(g.replay, iters=5, reps=reps)]


def median(xs):
    return xs[len(xs) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int, ops_per_s: float = INT8_OPS_PER_S):
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def lpm_touched_bytes(root_info, root_child, sub_info, addr) -> int:
    """Bytes the flat 16+16 walk must move for these addresses: each
    address in and each value out once, plus the distinct table entries
    this data reaches (the root_info and root_child entry of every
    address's top 16 bits, and the sub_info entry below it). The flat
    walk never reads sub_child."""
    import torch

    if sub_info.shape[-1] != 65536:
        fail("lpm_touched_bytes counts the flat layout only")
    q = addr.to(torch.int64) & 0xFFFFFFFF
    hi = q >> 16
    node = root_child[hi].to(torch.int64)
    ok = (node > 0) & (node < sub_info.shape[0])
    sub = torch.unique(node[ok] * 65536 + (q[ok] & 0xFFFF)).numel()
    return 4 * (2 * addr.numel() + 2 * torch.unique(hi).numel() + sub)


def stride8_touched_bytes(child, info, common, addr, levels: int) -> int:
    """Bytes the elided stride-8 walk must move for these addresses:
    each address's int32 bytes up to where its walk stops (the K
    compare ends at the first mismatch), one int32 out per address, the
    K common bytes, and the distinct (node, byte) cells it reaches (info
    and child, 4 bytes each)."""
    import torch

    b = addr.shape[0]
    k = common.shape[0]
    m = info.shape[0]
    reads = torch.zeros(b, dtype=torch.int64, device=addr.device)
    alive = torch.ones(b, dtype=torch.bool, device=addr.device)
    for j in range(k):
        reads += alive.long()
        alive &= addr[:, j] == common[j]
    node = torch.zeros(b, dtype=torch.int64, device=addr.device)
    cells = []
    flat_c = child.reshape(-1)
    for lvl in range(k, levels):
        reads += alive.long()
        byte = addr[:, lvl].long()
        alive &= (byte >= 0) & (byte < 256)
        flat = node * 256 + byte
        cells.append(flat[alive])
        nxt = flat_c[torch.where(alive, flat, 0)].long()
        alive &= (nxt > 0) & (nxt < m)
        node = torch.where(alive, nxt, node)
    n_cells = torch.unique(torch.cat(cells)).numel() if cells else 0
    return 4 * (int(reads.sum()) + b + k) + 8 * n_cells


def sweep_ops(t, n_flows: int) -> int:
    """int8 multiply-adds ×2 of the flow-route sweep's products for
    ``n_flows`` flows: deny and allow [S, S], s1 / en / ee [S, K1], p1
    [P4, K1], gpn / gpe [S, G], s7 [S, K7], p7 [P4, K7], g7 [G, K7]."""
    s = t.deny_t.shape[0]
    k1 = t.s1_mat.shape[1]
    p4 = t.p1_mat.shape[0]
    g = t.gpn_mat.shape[1]
    k7 = t.s7_mat.shape[1]
    per = 2 * s * s + 3 * s * k1 + p4 * k1 + 2 * s * g + s * k7 + p4 * k7 + g * k7
    return 2 * n_flows * per


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# Repository.allows_ingress answers by (repository, its revision, peer
# labels, subject labels, dport, proto): phase 4 holds both pipelines'
# verdicts of the same flows, and one answer a key serves both (each call
# walks the 10 000 rules in Python, ~0.1 s)
_ALLOWS = {}


def oracle_allows(repo, peer, subj, dport: int, proto: int) -> bool:
    from cilium_tpu_torch.policy.search import Decision, PortContext, SearchContext

    key = (repo, repo.revision, peer, subj, dport, proto)
    ok = _ALLOWS.get(key)
    if ok is None:
        pc = PortContext(dport, "UDP" if proto == 17 else "TCP")
        ok = _ALLOWS[key] = repo.allows_ingress(
            SearchContext(src=peer, dst=subj, dports=(pc,))) == Decision.ALLOWED
    return ok


def oracle_check(repo, labels_of, idents, pipe_name, ips, eps, dports, protos,
                 i_sel, verdicts, denied_net, endpoints, n: int = N_ORACLE):
    """Hold the first ``n`` flows against Repository.allows_ingress (and
    the prefilter membership for the deny stage)."""
    from cilium_tpu_torch.labels import parse_label_array

    for i in range(n):
        ip = ipaddress.IPv4Address(int(ips[i]))
        if any(ip in net for net in denied_net):
            want = 3
        else:
            subj = parse_label_array(labels_of[endpoints[int(eps[i])]])
            peer = parse_label_array(labels_of[idents[int(i_sel[i])].id])
            ok = oracle_allows(repo, peer, subj, int(dports[i]), int(protos[i]))
            want = 1 if ok else 2
        if int(verdicts[i]) != want:
            fail(f"{pipe_name}: flow {i} verdict {int(verdicts[i])}, oracle {want}")


def oracle_check6(repo, reg, labels_of, idents, pipe_name, addr, eps, dports, protos,
                  i_sel, verdicts, denied_net, endpoints):
    """Hold N_ORACLE v6 flows against Repository.allows_ingress (world
    peers carry the reserved:world labels) and the v6 deny prefixes."""
    from cilium_tpu_torch.identity.model import ID_WORLD
    from cilium_tpu_torch.labels import parse_label_array

    world_labels = reg.get(ID_WORLD).labels
    for i in range(N_ORACLE):
        ip = ipaddress.IPv6Address(bytes(int(x) for x in addr[i]))
        if any(ip in net for net in denied_net):
            want = 3
        else:
            subj = parse_label_array(labels_of[endpoints[int(eps[i])]])
            j = int(i_sel[i])
            peer = world_labels if j < 0 else parse_label_array(labels_of[idents[j].id])
            ok = oracle_allows(repo, peer, subj, int(dports[i]), int(protos[i]))
            want = 1 if ok else 2
        if int(verdicts[i]) != want:
            fail(f"{pipe_name} v6: flow {i} ({ip}) verdict {int(verdicts[i])}, oracle {want}")


def edge_checks2(dev) -> None:
    """K5, K6 and K4's attribution entry against their plain versions,
    exact, on shapes the main paths do not reach: K5 over a 4-level and a
    16-level trie with no elision, bytes outside [0, 255] and child ids
    outside [1, M); K6 with ragged row widths, empty rows and NO_RULE
    entries; K4's attribution entry over 1 280 columns (several staged
    chunks) with 2 100 endpoints and 40 000 rules (global-atomic
    counters and hits) and with 64 endpoints and 300 rules (shared)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.lookup import PolicymapTables, policymap_verdict, policymap_verdict_plain
    from cilium_tpu_torch.ops.lpm import build_trie, build_trie_elided, elided_lookup, lpm_stride8_plain
    from cilium_tpu_torch.ops.verdict import NO_RULE, first_rule, first_rule_plain

    rs = np.random.default_rng(4321)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for ipv6 in (False, True):
        size = 16 if ipv6 else 4
        base = int(ipaddress.ip_address("fd00::" if ipv6 else "10.0.0.0"))
        prefixes = [("::/0" if ipv6 else "0.0.0.0/0", 1)]
        for j in range(3000):
            plen = int(rs.choice([8, 16, 24, 32, 48, 64, 100, 120, 128] if ipv6 else [8, 12, 16, 20, 24, 28, 32]))
            a = base + int(rs.integers(0, 1 << (20 if not ipv6 else 40)))
            prefixes.append((str(ipaddress.ip_network((a, plen), strict=False)), j + 2))
        child, info = build_trie(prefixes, ipv6=ipv6)
        child[rs.random(child.shape) < 0.002] = child.shape[0] + 5  # out-of-range child ids
        child[rs.random(child.shape) < 0.002] = -3
        addr = np.array([list((base + int(rs.integers(0, 1 << 20))).to_bytes(size, "big"))
                         for _ in range(20000)], np.int32)
        addr[rs.random(addr.shape) < 0.03] = rs.choice(np.array([-1, 256, 1 << 20], np.int32))
        tabs = [t(child), t(info), t(np.zeros(0, np.int32)), t(addr)]
        if max_abs_err(elided_lookup(*tabs, size), lpm_stride8_plain(*tabs, size)):
            fail(f"lpm_stride8 disagrees on a {size}-level trie with out-of-range bytes")
    child, info, common = build_trie_elided([(f"fd00::{j:x}:0/112", j) for j in range(300)])
    if common.shape[0] == 0:
        fail("the elided edge trie kept no shared bytes")
    addr = np.zeros((5000, 16), np.int32)
    addr[:, 0] = 0xFD
    addr[:, 12:14] = rs.integers(0, 2, (5000, 2))
    addr[:, 13] = rs.integers(0, 300, 5000) & 255
    addr[rs.random(5000) < 0.2, 1] = 7  # differs in the elided bytes
    tabs = [t(child), t(info), t(common), t(addr)]
    if max_abs_err(elided_lookup(*tabs, 16), lpm_stride8_plain(*tabs, 16)):
        fail("lpm_stride8 disagrees on the elided compare")

    for b, s in ((777, 1), (777, 31), (4099, 33), (8192, 700)):
        mask = t(rs.random((b, s)) < 0.02)
        rule_of = rs.integers(0, 10**6, s).astype(np.int32)
        rule_of[rs.random(s) < 0.3] = NO_RULE
        if max_abs_err(first_rule(mask, t(rule_of)), first_rule_plain(mask, t(rule_of))):
            fail(f"first_rule disagrees on [{b}, {s}]")

    n_rows, words, b = 300, 80, 50_000  # 1 280 columns
    c = words // 2 * 32
    bits = rs.integers(-2**31, 2**31, (n_rows, words), dtype=np.int64).astype(np.int32)
    pm = PolicymapTables(
        col_ep=t(rs.integers(-1, 40, c).astype(np.int32)),
        col_port=t(rs.choice(np.array([0, 80, 443], np.int32), c)),
        col_proto=t(rs.choice(np.array([6, 17], np.int32), c)),
        col_is_l3=t(rs.random(c) < 0.2),
        id_bits=t(bits & bits // 3),
    )
    flows = [t(rs.integers(-5, n_rows + 5, b).astype(np.int32)),
             t(rs.integers(-1, 41, b).astype(np.int32)),
             t(rs.choice(np.array([80, 443, 22], np.int32), b)),
             t(rs.choice(np.array([6, 17], np.int32), b))]
    denied = t(rs.random(b) < 0.1)
    for eps, n_rules in ((64, 300), (2100, 40_000)):
        rule_tab = t(np.where(rs.random((n_rows, c)) < 0.7,
                              rs.integers(0, n_rules + 50, (n_rows, c)), -1).astype(np.int32))
        for pf in (None, denied):
            got = policymap_verdict(pm, *flows, denied_pf=pf, ep_count=eps, rule_tab=rule_tab,
                                    n_rules=n_rules)
            want = policymap_verdict_plain(pm, *flows, denied_pf=pf, ep_count=eps,
                                           rule_tab=rule_tab, n_rules=n_rules)
            if any(max_abs_err(g, w_) for g, w_ in zip(got, want)):
                fail(f"policymap_verdict (attribution) disagrees on {c} columns / {eps} "
                     f"endpoints / {n_rules} rules")
    torch.cuda.synchronize()


def edge_checks(dev) -> None:
    """Kernel vs plain version, exact, on shapes the main path does not
    reach: ragged selector counts with several conjuncts (K1), ragged
    int8 products (K2), the 16-8-8 trie layout (K3), and a policymap
    wider than one staged column chunk with more endpoints than the
    shared counter histogram holds (K4)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.bitmap import compute_selector_matches, selector_match_plain
    from cilium_tpu_torch.ops.lookup import PolicymapTables, policymap_verdict, policymap_verdict_plain
    from cilium_tpu_torch.ops.lpm import build_wide_trie, lpm_lookup_wide, lpm_wide_plain
    from cilium_tpu_torch.ops.verdict import bool_mm, bool_mm_plain

    rs = np.random.default_rng(1234)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n, s, cps, w = 1000, 45, 3, 2
    k1 = (
        t(rs.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(np.int32)),
        t((rs.integers(0, 2**31, (s, cps, w)) & rs.integers(0, 2**31, (s, cps, w))
           & rs.integers(0, 2**31, (s, cps, w))).astype(np.int32)),
        t((rs.integers(0, 2**31, (s, cps, w)) & rs.integers(0, 2**31, (s, cps, w))
           & rs.integers(0, 2**31, (s, cps, w)) & rs.integers(0, 2**31, (s, cps, w))).astype(np.int32)),
        t(rs.random((s, cps)) < 0.8),
        t(rs.integers(0, 12, (s, cps)).astype(np.int32)),
    )
    if max_abs_err(compute_selector_matches(*k1), selector_match_plain(*k1)):
        fail("selector_match disagrees on ragged conjuncts")

    x = t((rs.random((777, 333)) < 0.3).astype(np.int8))
    wm = t(rs.integers(-3, 4, (333, 201)).astype(np.int8))
    for comp in (False, True):
        if max_abs_err(bool_mm(x, wm, complement_x=comp), bool_mm_plain(x, wm, complement_x=comp)):
            fail(f"bool_mm disagrees on a ragged product (complement {comp})")
    k2_edge_checks(dev)

    prefixes = [("0.0.0.0/0", 1), ("10.0.0.0/8", 2)]
    for j in range(129):
        for _ in range(4):
            addr = ((100 << 24) | (j << 16)) | int(rs.integers(0, 1 << 16))
            plen = int(rs.choice([17, 20, 24, 28, 32]))
            prefixes.append((str(ipaddress.ip_network((addr, plen), strict=False)), len(prefixes)))
    tabs = [t(a) for a in build_wide_trie(prefixes)]
    if tabs[3].shape[-1] != 256:
        fail("129 deep /16s did not build the 16-8-8 layout")
    addr = t(((100 << 24) | rs.integers(0, 1 << 24, 200_000)).astype(np.uint32).view(np.int32))
    if max_abs_err(lpm_lookup_wide(*tabs, addr), lpm_wide_plain(*tabs, addr)):
        fail("lpm_wide disagrees on the 16-8-8 layout")

    n_rows, words, ep_count, b = 300, 80, 2100, 50_000  # 1 280 columns
    c = words // 2 * 32
    bits = rs.integers(-2**31, 2**31, (n_rows, words), dtype=np.int64).astype(np.int32)
    pm = PolicymapTables(
        col_ep=t(rs.integers(-1, 40, c).astype(np.int32)),
        col_port=t(rs.choice(np.array([0, 80, 443], np.int32), c)),
        col_proto=t(rs.choice(np.array([6, 17], np.int32), c)),
        col_is_l3=t(rs.random(c) < 0.2),
        id_bits=t(bits & bits // 3),
    )
    flows = [t(rs.integers(-5, n_rows + 5, b).astype(np.int32)),
             t(rs.integers(-1, 41, b).astype(np.int32)),
             t(rs.choice(np.array([80, 443, 22], np.int32), b)),
             t(rs.choice(np.array([6, 17], np.int32), b))]
    denied = t(rs.random(b) < 0.1)
    for eps in (64, ep_count):
        got = policymap_verdict(pm, *flows, denied_pf=denied, ep_count=eps)
        want = policymap_verdict_plain(pm, *flows, denied_pf=denied, ep_count=eps)
        if any(max_abs_err(g, w_) for g, w_ in zip(got, want)):
            fail(f"policymap_verdict disagrees on {c} columns / {eps} endpoints")
    torch.cuda.synchronize()


def k2_edge_checks(dev) -> None:
    """K2 against bool_mm_plain, exact: every tile-edge shape of
    k2_edge_shapes() with signed operands, both complement_x values; a
    non-contiguous slice of each operand; bool operands; contiguous
    operands whose first byte sits one past a 16-byte boundary (a and c
    would take the vector loads, the pointers do not allow them)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.verdict import bool_mm, bool_mm_plain

    def check(x, w, what):
        for comp in (False, True):
            got = bool_mm(x, w, complement_x=comp)
            if got.dtype != torch.bool or max_abs_err(got, bool_mm_plain(x, w, complement_x=comp)):
                fail(f"bool_mm disagrees on {what} (complement {comp})")

    for i, (b, a, c) in enumerate(k2_edge_shapes()):
        x, w = (torch.from_numpy(v).to(dev) for v in k2_edge_operands(b, a, c, i))
        check(x, w, f"[{b},{a}] x [{a},{c}]")
    rs = np.random.default_rng(77)
    big_x = torch.from_numpy((rs.random((300, 700)) < 0.4).astype(np.int8)).to(dev)
    big_w = torch.from_numpy(rs.integers(-3, 4, (700, 900)).astype(np.int8)).to(dev)
    check(big_x[1::2, 3:643], big_w[3:643, 5:900:2], "non-contiguous slices")
    check(big_x[:, 1:641], big_w[1:641, :256], "column-offset views")
    check(big_x.to(torch.bool), big_w > 0, "bool operands")
    flat_x = torch.from_numpy((rs.random(1 + 200 * 640) < 0.4).astype(np.int8)).to(dev)
    flat_w = torch.from_numpy(rs.integers(-3, 4, 1 + 640 * 128).astype(np.int8)).to(dev)
    check(flat_x[1:].view(200, 640), flat_w[1:].view(640, 128), "operands off their alignment")
    torch.cuda.synchronize()


def build_small_world(seed: int):
    """A small world with deny (from_requires), L4 and L7-HTTP rules in
    both directions, where every attribution reason code occurs: 40
    rules over 8 apps, 48 identities with one /32 and one /128 each."""
    from cilium_tpu_torch.identity import IdentityRegistry
    from cilium_tpu_torch.ipcache.ipcache import IPCache
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api import (
        EgressRule, EndpointSelector, HTTPRule, IngressRule, L7Rules, PortProtocol, PortRule,
        rule,
    )
    from cilium_tpu_torch.policy.repository import Repository

    rng = random.Random(seed)
    apps = [f"k8s:app=s{i}" for i in range(8)]
    envs = ["k8s:env=prod", "k8s:env=dev"]

    def port_rule():
        port = rng.choice([80, 443, 8080, 53])
        proto = "UDP" if port == 53 else "TCP"
        l7 = L7Rules()
        if proto == "TCP" and rng.random() < 0.5:
            l7 = L7Rules(http=(HTTPRule(method="GET", path="/api/.*"),))
        return PortRule(ports=(PortProtocol(port, proto),), rules=l7)

    rules = []
    for i in range(40):
        peer = EndpointSelector.make([rng.choice(apps)])
        ing = IngressRule(
            from_endpoints=(peer,),
            from_requires=((EndpointSelector.make([rng.choice(envs)]),) if rng.random() < 0.25 else ()),
            to_ports=((port_rule(),) if rng.random() < 0.6 else ()),
        )
        eg = EgressRule(to_endpoints=(EndpointSelector.make([rng.choice(apps)]),),
                        to_ports=((port_rule(),) if rng.random() < 0.5 else ()))
        rules.append(rule([rng.choice(apps)], labels=[f"k8s:policy=small{i}"],
                          ingress=[ing], egress=[eg] if rng.random() < 0.5 else []))
    repo = Repository()
    repo.add_list(rules)
    reg = IdentityRegistry()
    cache = IPCache()
    idents = []
    for i in range(48):
        labels = [rng.choice(apps), rng.choice(envs), f"k8s:uid=s{i}"]
        ident = reg.allocate(parse_label_array(labels))
        idents.append(ident)
        cache.upsert(f"172.16.0.{i + 1}/32", ident.id, source="k8s")
        cache.upsert(f"fd00::9:{i + 1:x}/128", ident.id, source="k8s")
    return repo, reg, cache, idents


def build_redirects(repo, reg, proxy, ep_id: int, ep_labels, device) -> None:
    """One redirect per redirecting L4 filter of the endpoint, each with
    an HTTPPolicy / KafkaACL on ``device`` whose rules are scoped to the
    identities its peer selector matches: the logic of the JAX
    package's endpoint/endpoint.py:199-247 ``_update_redirects``, written
    out here as the oracle that the redirects of the port's
    ``EndpointManager.regenerate_all`` are held against (phase 3d)."""
    from cilium_tpu_torch.l7 import HTTPPolicy, KafkaACL
    from cilium_tpu_torch.policy.api import HTTPRule, KafkaRule

    l4 = repo.resolve_l4_policy(ep_labels)
    identities = list(reg)
    for direction_map, ingress in ((l4.ingress, True), (l4.egress, False)):
        for f in direction_map:
            if not f.is_redirect:
                continue
            http_rules, kafka_rules = [], []
            for sel, rules in f.l7_rules_per_ep.items():
                idents = None if sel.is_wildcard else {
                    i.id for i in identities if sel.matches(i.labels)}
                http_rules += [(hr, idents) for hr in rules.http]
                kafka_rules += [(kr, idents) for kr in rules.kafka]
                if not rules.http and not rules.kafka:
                    # wildcarded L7: this peer passes the proxy unrestricted
                    if f.l7_parser == "http":
                        http_rules.append((HTTPRule(), idents))
                    elif f.l7_parser == "kafka":
                        kafka_rules.append((KafkaRule(), idents))
            proxy.create_or_update_redirect(
                ep_id, f.port, f.l7_parser, ingress=ingress,
                http_policy=HTTPPolicy(http_rules, device=device) if f.l7_parser == "http" else None,
                kafka_acl=KafkaACL(kafka_rules, device=device) if f.l7_parser == "kafka" else None,
            )


def redirect_set(proxy):
    """{key: (endpoint, port, ingress, parser, [(rule, sorted scope)])}
    of a Proxy's redirects: what two ways of building them must agree on."""
    out = {}
    for key, r in proxy.redirects().items():
        rules = []
        if r.http_policy is not None:
            rules = [(cr.rule, None if cr.allowed_identities is None
                      else sorted(cr.allowed_identities)) for cr in r.http_policy._rules]
        if r.kafka_acl is not None:
            rules = [(kr, None if ids is None else sorted(ids)) for kr, ids in r.kafka_acl._rules]
        out[key] = (r.endpoint_id, r.dst_port, r.ingress, r.parser, rules)
    return out


def cap_policy_rules():
    """A 3-field HTTP policy at the pattern cap: 7 methods, 64 path
    patterns (the last one in syntax the DFA compiler refuses, so it is
    demoted to host re) and 3 host patterns, one rule per path."""
    from cilium_tpu_torch.policy.api import HTTPRule

    methods = ["GET", "POST", "PUT", "DELETE", "PATCH", "HEAD", "OPTIONS"]
    hosts = ["api[.]example[.]com", "[a-z]+[.]internal", "svc[0-9]+[.]local"]
    paths = ([f"/api/v{i % 8}/r{i}/[a-z0-9]*" for i in range(40)]
             + [f"/svc{i}/.*" for i in range(23)] + ["/legacy/(?:v1|v2)/.*"])
    return [(HTTPRule(method=methods[i % 7], path=p, host=hosts[i % 3] if i % 2 else ""), None)
            for i, p in enumerate(paths)]


def cap_requests(seed: int, n: int):
    """Requests for the pattern-cap policy: most aim at one rule's path
    with that rule's method and host three times in four; 1/16 of the
    paths are longer than 128 bytes and 1/32 longer than 256 (the host
    walk)."""
    import numpy as np

    from cilium_tpu_torch.l7 import HTTPRequest

    rs = np.random.default_rng(seed + 70)
    methods = ["GET", "POST", "PUT", "DELETE", "PATCH", "HEAD", "OPTIONS", "TRACE"]
    hosts = ["api.example.com", "db.internal", "svc12.local", "", "evil.com"]
    out = []
    for j, k, a, b, s_ in zip(rs.integers(0, 64, n).tolist(), rs.integers(0, 32, n).tolist(),
                              rs.integers(0, 32, n).tolist(), rs.integers(0, 32, n).tolist(),
                              rs.integers(256, 4096, n).tolist()):
        if k == 0:
            path = f"/svc{j % 23}/" + "b" * 300
        elif k < 3:
            path = f"/svc{j % 30}/" + "a" * 150
        elif k < 5:
            path = f"/legacy/v{j % 4}/x"
        elif k < 26:
            path = f"/api/v{j % 8}/r{j}/obj{k}" if j < 40 else f"/svc{j - 40}/up/{k}"
        elif k < 30:
            path = f"/api/v{(j + 1) % 8}/r{j}/x"
        else:
            path = "/nope"
        method = methods[j % 7] if a < 24 else methods[a % 8]
        host = hosts[j % 3] if b < 24 else hosts[b % 5]
        out.append(HTTPRequest(method=method, path=path, host=host, src_identity=s_))
    return out


def kafka_bench():
    """bench.py:290-308: 32 produce rules over topics t0..t31 and
    100 000 requests over t0..t47."""
    from cilium_tpu_torch.l7 import KafkaRequest
    from cilium_tpu_torch.policy.api import KafkaRule

    rules = [(KafkaRule(role="produce", topic=f"t{i}"), None) for i in range(32)]
    reqs = [KafkaRequest(api_key=0, api_version=2, client_id="c", topic=f"t{i % 48}")
            for i in range(KAFKA_REQS)]
    return rules, reqs


def produce_frame(client: str, topics, cid: int = 7) -> bytes:
    """A Kafka produce request frame (v0), built with the port's wire
    module's constants and string encoder."""
    import struct

    from cilium_tpu_torch.l7 import kafka_wire

    body = struct.pack(">hhi", kafka_wire.API_PRODUCE, 0, cid) + kafka_wire._w_str(client)
    body += struct.pack(">hi", 1, 30000) + struct.pack(">i", len(topics))
    for t in topics:
        body += kafka_wire._w_str(t) + struct.pack(">i", 1) + struct.pack(">ii", 0, 10) + b"\x00" * 10
    return struct.pack(">i", len(body)) + body


def http_oracle(pol, reqs):
    """re.fullmatch of a policy's rules (HTTPRule.matches) with their
    identity scopes, request by request."""
    import numpy as np

    return np.array([any(cr.rule.matches(q.method, q.path, q.host)
                         and (cr.allowed_identities is None
                              or q.src_identity in cr.allowed_identities)
                         for cr in pol._rules) for q in reqs], bool)


def dfa_touched_bytes(table, starts, sb, lens, max_len: int, pair: bool) -> int:
    """Bytes a DFA walk must move for these rows: the string bytes it
    walks (min(length, max_len) per row, at the batch's element size),
    each row's length and start (one start when ``starts`` holds one)
    and its two mask words, plus the distinct table entries the walks
    reach and the accept words of the distinct final states."""
    import torch

    b = sb.shape[0]
    state = starts.long().expand(b) if starts.numel() == 1 else starts.long()
    end = lens.long().clamp(max=max_len)
    alive = lens >= 0
    flat = table.reshape(-1)
    cells = []
    for lvl in range(0, max_len, 2 if pair else 1):
        step = alive & (lvl < end)
        if pair:
            b1 = sb[:, lvl + 1].long() if lvl + 1 < max_len else torch.zeros_like(state)
            b1 = torch.where(lvl + 1 < end, b1, 256)
            idx = (state * 257 + sb[:, lvl].long()) * 257 + b1
        else:
            idx = state * 256 + sb[:, lvl].long()
        idx = torch.where(step, idx, 0)
        cells.append(idx[step])
        state = torch.where(step, flat[idx].long(), state)
    n_cells = torch.unique(torch.cat(cells)).numel() if cells else 0
    n_final = torch.unique(state[alive]).numel()
    walked = int(end.clamp(min=0).sum())
    return (walked * sb.element_size() + b * (4 + 8) + 4 * starts.numel()
            + 4 * n_cells + 8 * n_final)


def edge_checks3(dev) -> None:
    """K7 (both entries) and K8 against their plain versions, exact, on
    shapes the main paths do not reach: random automata at every rung
    and at odd caps (3, 5, 17), uint8 and int32 bytes, batch widths
    wider than max_len, lengths -1 and past max_len (the pair walk
    reads no byte at or past max_len), starts outside [0, Q), int32
    bytes outside [0, 255], max_len 0, and an empty batch (no launch)."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import (
        accept_words, dfa_match_batch, dfa_match_batch_fused, dfa_match_batch_pair,
        dfa_pair_walk_plain, dfa_walk_plain, fuse_dfas,
    )

    rs = np.random.default_rng(777)
    rng = random.Random(777)
    atoms = ["a", "b", "/", "[a-z]", "[0-9]", ".", "x+", "b*", "(ab|ba)", "c?", "[^a]"]

    def pats(n):
        return ["".join(rng.choice(atoms) for _ in range(rng.randrange(1, 6))) for _ in range(n)]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fused = fuse_dfas([compile_patterns(pats(rng.randrange(2, 8))) for _ in range(3)])
    if fused.pair is None:
        fail("the edge automata are too large for a pair table")
    lo, hi = (t(w) for w in accept_words(fused.accept))
    q = fused.n_states
    for max_len in (0, 3, 5, 16, 17, 32, 64, 128, 256):
        b = 20_000
        width = max_len + int(rs.integers(0, 5))
        for dtype in (np.uint8, np.int32):
            sb = rs.choice(np.frombuffer(b"ab/xyz019c\x00", np.uint8), (b, width)).astype(dtype)
            lens = rs.integers(-1, max_len + 6, b).astype(np.int32)
            starts = rs.choice(fused.starts, b).astype(np.int32)
            starts[rs.random(b) < 0.01] = q + 3
            starts[rs.random(b) < 0.01] = -2
            if dtype == np.int32:
                sb[rs.random(sb.shape) < 0.002] = rs.choice(np.array([-1, 256, 1 << 20], np.int32))
            args = (lo, hi, t(starts), t(sb), t(lens), max_len)
            for fn, plain, tab in ((dfa_match_batch_fused, dfa_walk_plain, fused.trans),
                                   (dfa_match_batch_pair, dfa_pair_walk_plain, fused.pair)):
                got, want = fn(t(tab), *args), plain(t(tab), *args)
                if any(max_abs_err(g, w) for g, w in zip(got, want)):
                    fail(f"{fn.__name__} disagrees at max_len {max_len}, {np.dtype(dtype).name} bytes")
            if max_abs_err(dfa_match_batch_pair(t(fused.pair), *args)[0],
                           dfa_match_batch_fused(t(fused.trans), *args)[0]):
                fail(f"the pair walk and the single-byte walk differ at max_len {max_len}")
            start = torch.tensor(int(fused.starts[1]), dtype=torch.int32, device=dev)
            got = dfa_match_batch(t(fused.trans), lo, hi, start, *args[3:])
            want = dfa_walk_plain(t(fused.trans), lo, hi, start.expand(b), *args[3:])
            if any(max_abs_err(g, w) for g, w in zip(got, want)):
                fail(f"dfa_match_batch disagrees at max_len {max_len}")
    before = _kernels.launches()
    empty = (lo, hi, t(np.zeros(0, np.int32)), t(np.zeros((0, 16), np.uint8)),
             t(np.zeros(0, np.int32)), 16)
    for fn, tab in ((dfa_match_batch_fused, fused.trans), (dfa_match_batch_pair, fused.pair)):
        if fn(t(tab), *empty)[0].shape != (0,):
            fail("an empty DFA batch returned rows")
    if _kernels.launches() != before:
        fail("an empty DFA batch launched a kernel")
    torch.cuda.synchronize()


class WalkRecorder:
    """Counts a path's K7 launches by shape and keeps the operands of
    the launches of the shapes section 5 times (``keep``): wraps
    ops.dfa._walk, which every DFA walk wrapper calls. A shape is (part,
    entry, byte type, row width, max_len, Q, rows); ``part`` tags the
    launches that follow it. K8's launches are counted apart (``pairs``)
    by (part, byte type, row width, max_len, Q, rows, the route the
    launch took)."""

    def __init__(self, device_type: str = "cuda"):
        self.part = ""
        self.shapes = {}
        self.pairs = {}
        self.device_type = device_type

    def keep(self, key) -> int:
        """How many launches of a shape to keep the operands of: a
        redirect group's first path or host walk, and the first 24
        full chunks of the pattern-cap batch (one check_batch: its
        methods, paths and hosts)."""
        part, entry, dtype, _, max_len, _, rows = key
        if (part, entry, dtype, max_len) == ("redirect", "dfa_walk", "int32", 256):
            return 1
        return 24 if (part, entry, rows) == ("cap", "dfa_walk_fused", 16384) else 0

    def __enter__(self):
        from cilium_tpu_torch.ops import dfa

        self.real = real = dfa._walk

        def walk(kernel, plain, table, width, accept_lo, accept_hi, starts, str_bytes, lengths,
                 max_len, scalar_start, classes=None):
            if (kernel != "dfa_pair_walk" and str_bytes.device.type == self.device_type
                    and str_bytes.shape[0]):
                key = (self.part, kernel, str(str_bytes.dtype).replace("torch.", ""),
                       str_bytes.shape[1], max_len, table.shape[0], str_bytes.shape[0])
                hit = self.shapes.setdefault(key, [0, []])
                if len(hit[1]) < self.keep(key):
                    hit[1].append((tuple(x.clone() for x in (table, accept_lo, accept_hi, starts,
                                                             str_bytes, lengths)), classes))
                hit[0] += 1
            out = real(kernel, plain, table, width, accept_lo, accept_hi, starts, str_bytes,
                       lengths, max_len, scalar_start, classes)
            if (kernel == "dfa_pair_walk" and str_bytes.device.type == self.device_type
                    and str_bytes.shape[0]):
                route = dfa.WALK_ROUTES.get(kernel) if self.device_type == "cuda" else None
                key = (self.part, str(str_bytes.dtype).replace("torch.", ""), str_bytes.shape[1],
                       max_len, table.shape[0], str_bytes.shape[0], route)
                self.pairs[key] = self.pairs.get(key, 0) + 1
            return out

        dfa._walk = walk
        return self

    def __exit__(self, *exc):
        from cilium_tpu_torch.ops import dfa

        dfa._walk = self.real


def l7_main_path(seed: int, card: str, v4_flows, endpoints):
    """The L7 main path on the card (see 4d in the module docstring),
    L7DeviceBatch off and then on; returns what the CPU checks and the
    kernel rows need, and the launch counts of the off half."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath import l7_pipeline as l7rt
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.endpoint import Endpoint, EndpointManager
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.l7 import HTTPPolicy, HTTPRequest, KafkaACL
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.proxy import Proxy

    r = {}
    t0 = time.perf_counter()
    repo, reg, cache, idents, labels_of = build_world(seed, l7=True)
    engine = PolicyEngine(repo, reg)
    engine.refresh()
    pipe = DatapathPipeline(engine, cache)
    pipe.set_endpoints(endpoints)
    pipe.rebuild()
    torch.cuda.synchronize()
    _, red = pipe.process(*v4_flows)
    n_bench = int(red.sum())
    # the redirects come from the endpoints' regeneration on the card
    # pipeline (its tables are built: every rebuild returns early), and
    # must equal the ones build_redirects writes out
    proxy = Proxy()
    ident_of = {ident.id: ident for ident in idents}
    mgr = EndpointManager()
    for ep in endpoints:
        e = Endpoint(ep, parse_label_array(labels_of[ep]))
        e.set_identity(ident_of[ep])
        mgr.insert(e)
    t0r = time.perf_counter()
    n_regen = mgr.regenerate_all(pipe, reason="l7 main path", proxy=proxy)
    t_regen = time.perf_counter() - t0r
    mgr.shutdown()
    oracle = Proxy()
    t0r = time.perf_counter()
    for ep in endpoints:
        build_redirects(repo, reg, oracle, ep, parse_label_array(labels_of[ep]), None)
    t_oracle = time.perf_counter() - t0r
    if n_regen != len(endpoints):
        fail(f"l7: {n_regen} of {len(endpoints)} endpoints regenerated")
    if redirect_set(proxy) != redirect_set(oracle):
        fail("l7: the endpoints' redirects differ from build_redirects'")
    off_card = [k for k, r in proxy.redirects().items()
                if (r.http_policy or r.kafka_acl).device.type != "cuda"]
    if off_card:
        fail(f"l7: the policies of redirects {off_card[:4]} are not on the card")
    n_redirects = len(proxy.redirects())
    print(f"main path l7 [redirect world]: regenerate_all of {len(endpoints)} endpoints with the "
          f"proxy {t_regen!r}s, {n_redirects} redirects == build_redirects' ({t_oracle!r}s), "
          f"every HTTPPolicy / KafkaACL on the card [{card}]", flush=True)
    # the HTTP batch: port-80 flows to endpoints with a port-80 redirect,
    # 7/8 of them from the peers its HTTP rules name (a peer that an
    # L3-only rule also allows is not redirected), 1/8 from any identity
    index_of = {ident.id: j for j, ident in enumerate(idents)}
    peers_of = {}
    for e, ep in enumerate(endpoints):
        rd = proxy.lookup(ep, 80, ingress=True)
        if rd is not None:
            ids = set().union(*(cr.allowed_identities or set() for cr in rd.http_policy._rules
                                if cr.rule.path or cr.rule.method))
            peers_of[e] = np.array(sorted(index_of[i] for i in ids if i in index_of))
    rs = np.random.default_rng(seed + 81)
    n_h = 2 * L7_BATCH
    ep_h = rs.choice(np.array(sorted(k for k, v in peers_of.items() if v.size)), n_h)
    pick = rs.integers(0, 1 << 30, n_h)
    j = np.array([peers_of[e][k % peers_of[e].size] for e, k in zip(ep_h.tolist(), pick.tolist())])
    j = np.where(rs.random(n_h) < 1 / 8, rs.integers(0, len(idents), n_h), j)
    ips_h = ((10 << 24) | ((j >> 8) & 255) << 16 | (j & 255) << 8 | 1).astype(np.uint32)
    http_flows = (ips_h, ep_h.astype(np.int32), np.full(n_h, 80, np.int32),
                  np.full(n_h, 6, np.int32))
    _, red_h = pipe.process(*http_flows)
    # one request per redirected flow: the bench batch's, then the HTTP batch's
    bench_idx = np.nonzero(red)[0]
    ep_r = np.concatenate([v4_flows[1][bench_idx], ep_h[red_h]])[:L7_BATCH]
    port_r = np.concatenate([v4_flows[2][bench_idx], np.full(int(red_h.sum()), 80)])[:L7_BATCH]
    ip_r = np.concatenate([v4_flows[0][bench_idx], ips_h[red_h]])[:L7_BATCH]
    j_r = ((ip_r.astype(np.int64) >> 16) & 255) << 8 | ((ip_r.astype(np.int64) >> 8) & 255)
    src_r = np.array([ident.id for ident in idents])[j_r]
    groups = {}
    for i, (e, port) in enumerate(zip(ep_r.tolist(), port_r.tolist())):
        groups.setdefault((endpoints[e], port), []).append(i)
    # half the requests take a path and method of one of the redirect's
    # rules, the rest any corpus path (and some past the 256-byte cap)
    methods, paths = [""] * ep_r.size, [""] * ep_r.size
    corpus = [f"/api/v{a}/obj{a}" for a in range(10)] + [f"/svc{a}/x/y" for a in range(10)]
    for (ep, port), sel in groups.items():
        rd = proxy.lookup(ep, port, ingress=True)
        own = [cr.rule for cr in rd.http_policy._rules] if rd is not None else []
        for i, a, b in zip(sel, rs.integers(0, 64, len(sel)).tolist(),
                           rs.integers(0, 1 << 30, len(sel)).tolist()):
            if own and a < 32:
                rule = own[b % len(own)]
                paths[i] = rule.path.replace("[a-z0-9]*", f"obj{a}").replace(".*", "x/y")
                methods[i] = rule.method or ["GET", "POST", "PUT"][a % 3]
            else:
                paths[i] = corpus[b % 20] if a < 60 else "/api/v1/" + "a" * 300
                methods[i] = ["GET", "POST", "PUT", "DELETE"][a % 4]
    reqs_d = [HTTPRequest(method=m, path=p_, src_identity=int(s_))
              for m, p_, s_ in zip(methods, paths, src_r)]
    t_setup = time.perf_counter() - t0
    print(f"main path l7 [redirect world]: {n_bench} of {BATCH} bench flows redirect "
          f"({int(red_h.sum())} of the {n_h}-flow HTTP batch), {n_redirects} redirects over "
          f"{len(endpoints)} endpoints, {len(groups)} (endpoint, port) groups of requests, "
          f"{ep_r.size} requests; world, refresh, rebuild, process and redirects "
          f"{t_setup!r}s [{card}]", flush=True)
    if n_bench <= 0 or ep_r.size < L7_BATCH // 4:
        fail("the redirect world sends too few flows through the proxy")

    pol_b = HTTPPolicy(cap_policy_rules())
    if not pol_b._paths.host_pids:
        fail("the pattern-cap policy demoted no pattern")
    reqs_b = cap_requests(seed, L7_BATCH)
    k_rules, k_reqs = kafka_bench()
    acl = KafkaACL(k_rules)
    rk = proxy.create_or_update_redirect(1 << 20, 9092, "kafka", kafka_acl=acl)
    frames = [produce_frame("c", ["t3"]), produce_frame("c", ["t40"]),
              produce_frame("c", ["t1", "t2"]), produce_frame("c", ["t5", "t33"]), b"\x00\x00"]
    # each state runs twice: the first pass of the on state builds and
    # uploads the fused (and pair) tables, the second is the steady state
    walks = WalkRecorder()
    for on in (False, True):
        tag = "on" if on else "off"
        l7rt.set_device_batch(on)
        for rep in ("first", "second"):
            walks.part = "cap"
            t0 = time.perf_counter()
            with walks:
                out_b = pol_b.check_batch(reqs_b)
            t_b = time.perf_counter() - t0
            walks.part = "kafka"
            with walks:
                t0 = time.perf_counter()
                out_c = np.asarray(proxy.check_kafka(rk, k_reqs))
                t_c = time.perf_counter() - t0
                out_f = [proxy.handle_kafka_bytes(rk, f, src_identity=5) for f in frames]
            walks.part = "redirect"
            allow = np.zeros(ep_r.size, bool)
            with walks:
                t0 = time.perf_counter()
                for (ep, port), sel in groups.items():
                    rd = proxy.lookup(ep, port, ingress=True)
                    if rd is None or rd.parser != "http":
                        fail(f"a redirected flow to ({ep}, {port}) has no HTTP redirect")
                    allow[sel] = proxy.check_http(rd, [reqs_d[i] for i in sel])
                t_d = time.perf_counter() - t0
            if rep == "second" and not (np.array_equal(out_b, r[("b", tag)])
                                        and np.array_equal(out_c, r[("c", tag)])
                                        and out_f == r[("frames", tag)]
                                        and np.array_equal(allow, r[("d", tag)])):
                fail(f"L7: two passes with L7DeviceBatch {tag} disagree")
            r[("b", tag)], r[("c", tag)], r[("frames", tag)], r[("d", tag)] = (
                out_b, out_c, out_f, allow)
            print(f"main path l7 [L7DeviceBatch {tag}, {rep} pass]: pattern-cap check_batch "
                  f"{L7_BATCH} requests {t_b!r}s = {L7_BATCH / t_b!r} req/s "
                  f"({int(out_b.sum())} allowed); kafka check_kafka {KAFKA_REQS} requests "
                  f"{t_c!r}s = {KAFKA_REQS / t_c!r} req/s ({int(out_c.sum())} allowed); redirect "
                  f"check_http {ep_r.size} requests {t_d!r}s = {ep_r.size / t_d!r} req/s "
                  f"({int(allow.sum())} allowed); handle_kafka_bytes forward "
                  f"{[f for f, _ in out_f]} [{card}]", flush=True)
        if not on:
            r["off_launches"] = _kernels.launches()
    l7rt.set_device_batch(False)
    for part in ("b", "c", "d"):
        if not np.array_equal(r[(part, "on")], r[(part, "off")]):
            fail(f"L7 {part}: L7DeviceBatch on and off disagree on the card")
    if r[("frames", "on")] != r[("frames", "off")]:
        fail("handle_kafka_bytes: L7DeviceBatch on and off disagree on the card")
    if [f for f, _ in r[("frames", "on")]] != [True, False, True, False, False]:
        fail(f"handle_kafka_bytes forwarded {[f for f, _ in r[('frames', 'on')]]}")
    for part in ("b", "c", "d"):
        if not (r[(part, "on")].any() and not r[(part, "on")].all()):
            fail(f"L7 {part}: the requests are all allowed or all denied")
    r.update(walks=walks.shapes, pairs=walks.pairs, pol_b=pol_b, reqs_b=reqs_b, k_rules=k_rules, k_reqs=k_reqs,
             frames=frames,
             proxy=proxy, groups=groups, reqs_d=reqs_d, repo=repo, reg=reg, labels_of=labels_of)
    return r


def pair_walk_lines(pairs, card: str) -> None:
    """Prints the L7 main path's K8 launches (a WalkRecorder's
    ``pairs``) by table and shape: its route and Q; fails unless every
    launch walked rows under PAIR_WALK_BELOW_RUNG bytes on the pair
    route (a table with a pair table walks its byte classes on K7 from
    there: ops/dfa.py l7_walk_route, and every main-path table has
    them)."""
    from cilium_tpu_torch.ops.dfa import PAIR_WALK_BELOW_RUNG

    total = 0
    for key in sorted(pairs, key=lambda k: (k[0], k[4], -pairs[k])):
        part, dtype, width, max_len, q, rows, route = key
        print(f"L7 main path K8 {part} table Q {q}: {dtype} width {width} max_len {max_len} "
              f"rows {rows}, route {route}: {pairs[key]} launches [{card}]", flush=True)
        if route is None or route[0] != "pair" or max_len >= PAIR_WALK_BELOW_RUNG:
            fail(f"a K8 launch of the L7 main path took route {route} at max_len {max_len} "
                 f"({part}, Q {q})")
        total += pairs[key]
    print(f"L7 main path K8: {total} launches over {len({(k[0], k[4]) for k in pairs})} "
          f"(part, table) pairs, every one on the pair route under {PAIR_WALK_BELOW_RUNG} "
          f"bytes a row [{card}]", flush=True)


def walk_rows(shapes, row) -> None:
    """K7 at the shapes the L7 main path launched it (a WalkRecorder's
    ``shapes``): prints its launches by shape, then holds and times one
    redirect group's path batch (HTTPPolicy.masks, the off path: the
    kept shape launched most often, then the largest) and the 24
    16 384-row chunks of one pattern-cap check_batch (l7_pipeline.submit,
    the on path: methods, paths and hosts; times and bound per launch,
    the mean over the 24), each with its launches at that shape."""
    from cilium_tpu_torch.ops.dfa import (
        dfa_match_batch, dfa_match_batch_classes, dfa_match_batch_fused, dfa_walk_plain,
    )

    for key in sorted(shapes, key=lambda k: -shapes[k][0] * k[6]):
        print(f"L7 main path K7 shape {key[0]} {key[1]} {key[2]} width {key[3]} max_len "
              f"{key[4]} Q {key[5]} rows {key[6]}: {shapes[key][0]} launches", flush=True)
    for entry, part in (("dfa_walk", "redirect"), ("dfa_walk_fused", "cap")):
        kept = [k for k in shapes if k[:2] == (part, entry) and shapes[k][1]]
        if not kept:
            fail(f"the L7 main path launched no {entry} at a kept {part} shape")
        key = max(kept, key=lambda k: (shapes[k][0], k[6]))
        n_at, launches = shapes[key]
        max_len, q, rows = key[4], key[5], key[6]

        def call(ops, classes, m=max_len):
            if entry == "dfa_walk":
                return dfa_match_batch(*ops, m)
            if classes is None:
                return dfa_match_batch_fused(*ops, m)
            return dfa_match_batch_classes(ops[0], *classes, *ops[1:], m)

        def plain_of(ops, m=max_len):
            tab, alo, ahi, st, sb, ln = ops
            return dfa_walk_plain(tab, alo, ahi, st.reshape(-1).expand(sb.shape[0])
                                  if st.numel() == 1 else st, sb, ln, m)

        err = max(max_abs_err(x, y) for ops, cls in launches
                  for x, y in zip(call(ops, cls), plain_of(ops)))
        moved = sum(dfa_touched_bytes(ops[0], ops[3].reshape(-1), ops[4], ops[5], max_len, False)
                    for ops, _ in launches)
        b_ms, b_by = bound(moved // len(launches), 0)
        if entry == "dfa_walk":
            what = f"one redirect group's path batch: {rows} rows, int32, max_len {max_len}"
        else:
            what = (f"the {len(launches)} {rows}-row chunks of one pattern-cap check_batch at "
                    f"rung {max_len} (per launch, their mean)")
        row(entry, "cilium_tpu_torch/csrc/dfa_walk.cu",
            f"cilium_tpu/ops/dfa.py:{104 if entry == 'dfa_walk' else 236}", err,
            lambda: [call(ops, cls) for ops, cls in launches],
            lambda: [plain_of(ops) for ops, _ in launches], b_ms, b_by,
            f"{what}, Q {q}; {n_at} launches at this shape on the L7 main path", plain_iters=1,
            reps=3, graph=True, per_call=len(launches))


def l7_cpu_checks(r) -> None:
    """Hold the card's L7 results against the port's CPU path (the
    pattern-cap policy on its first L7_SLICE requests, the Kafka ACL on
    every request and frame, the redirects of the first N_L7_CPU_EPS
    endpoints that receive requests) and against re.fullmatch of the rules (400 requests of
    each HTTP policy), for L7DeviceBatch off and on."""
    import numpy as np

    from cilium_tpu_torch.datapath import l7_pipeline as l7rt
    from cilium_tpu_torch.l7 import HTTPPolicy, KafkaACL
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.proxy import Proxy

    cpu_eps = []
    for ep, _port in r["groups"]:
        if ep not in cpu_eps and len(cpu_eps) < N_L7_CPU_EPS:
            cpu_eps.append(ep)
    cpu_pol = HTTPPolicy(cap_policy_rules(), device="cpu")
    cpu_acl = KafkaACL(r["k_rules"], device="cpu")
    cpu_proxy = Proxy()
    rk = cpu_proxy.create_or_update_redirect(1 << 20, 9092, "kafka", kafka_acl=cpu_acl)
    for ep in cpu_eps:
        build_redirects(r["repo"], r["reg"], cpu_proxy, ep,
                        parse_label_array(r["labels_of"][ep]), "cpu")
    n_d = 0
    try:
        for on in (False, True):
            tag = "on" if on else "off"
            l7rt.set_device_batch(on, device="cpu")
            got = cpu_pol.check_batch(r["reqs_b"][:L7_SLICE])
            if not np.array_equal(got, r[("b", tag)][:L7_SLICE]):
                fail(f"pattern-cap policy: card and CPU disagree (L7DeviceBatch {tag})")
            if not np.array_equal(np.asarray(cpu_proxy.check_kafka(rk, r["k_reqs"])), r[("c", tag)]):
                fail(f"kafka: card and CPU disagree (L7DeviceBatch {tag})")
            if [cpu_proxy.handle_kafka_bytes(rk, f, src_identity=5) for f in r["frames"]] != r[
                    ("frames", tag)]:
                fail(f"handle_kafka_bytes: card and CPU disagree (L7DeviceBatch {tag})")
            n_d = 0
            for (ep, port), sel in r["groups"].items():
                if ep not in cpu_eps:
                    continue
                rd = cpu_proxy.lookup(ep, port, ingress=True)
                got = cpu_proxy.check_http(rd, [r["reqs_d"][i] for i in sel])
                if not np.array_equal(got, r[("d", tag)][sel]):
                    fail(f"redirect ({ep}, {port}): card and CPU disagree (L7DeviceBatch {tag})")
                n_d += len(sel)
    finally:
        l7rt.set_device_batch(False)
    if n_d < 32:
        fail("the CPU slice of the redirect path holds too few requests")
    if not np.array_equal(http_oracle(r["pol_b"], r["reqs_b"][:N_ORACLE]),
                          r[("b", "on")][:N_ORACLE]):
        fail("pattern-cap policy: the card disagrees with re.fullmatch")
    checked = 0
    for (ep, port), sel in r["groups"].items():
        rd = r["proxy"].lookup(ep, port, ingress=True)
        sel = sel[:N_ORACLE - checked]
        if not np.array_equal(http_oracle(rd.http_policy, [r["reqs_d"][i] for i in sel]),
                              r[("d", "on")][sel]):
            fail(f"redirect ({ep}, {port}): the card disagrees with re.fullmatch")
        checked += len(sel)
        if checked >= N_ORACLE:
            break
    want = np.array([any(rule.matches(q.api_key, q.api_version, q.client_id, q.topic)
                         for rule, _ in r["k_rules"]) for q in r["k_reqs"][:N_ORACLE]])
    if not np.array_equal(want, r[("c", "on")][:N_ORACLE]):
        fail("kafka: the card disagrees with KafkaRule.matches")
    print(f"L7: card == CPU path (pattern-cap policy on {L7_SLICE} requests, kafka on "
          f"{KAFKA_REQS} and on the frames, the redirects of {N_L7_CPU_EPS} endpoints on {n_d} "
          f"requests) and == re.fullmatch / KafkaRule.matches on {N_ORACLE} requests each, "
          f"L7DeviceBatch off and on", flush=True)


def random_lb_case(rs, f: int, length: int, nb: int, b: int, proto0: float = 0.0):
    """Random K9 inputs: frontends over a small pool of addresses and
    ports (ANY frontends beside specific ones, keys repeated), 1/8 with
    no backend, sequence lengths past the sequence width, sequence rows
    past the backend table and negative ones, half the flows aimed at a
    frontend, flow hashes of either sign; a ``proto0`` share of the
    flows keeps protocol 0 (which matches only ANY frontends)."""
    import numpy as np

    pool = rs.integers(0, 256, (max(2, f // 3), length))
    fe_bytes = pool[rs.integers(0, pool.shape[0], f)]
    fe_port = rs.choice(np.array([53, 80, 443, 8080]), f)
    fe_proto = rs.choice(np.array([0, 6, 17]), f)
    tables = lb_case_tables(rs, fe_bytes, fe_port, fe_proto, nb)
    return tables, lb_case_flows(rs, fe_bytes, fe_port, fe_proto, b, proto0)


def lb_case_tables(rs, fe_bytes, fe_port, fe_proto, nb: int):
    """LBTables on the CPU around these frontend keys: random selection
    sequences (1/8 of the frontends with no backend, lengths past the
    width, rows past the backend table and negative), revNAT ids and
    backends."""
    import numpy as np

    from cilium_tpu_torch.convert import lb_tables_from_numpy
    from cilium_tpu_torch.lb.device import MAX_SEQ

    f, length = fe_bytes.shape
    fe_seq_len = rs.integers(1, MAX_SEQ + 1, f)
    fe_seq_len[rs.random(f) < 0.125] = 0
    fe_seq_len[rs.random(f) < 0.05] = MAX_SEQ + 7
    fe_seq = rs.integers(0, nb, (f, MAX_SEQ))
    wild = rs.random((f, MAX_SEQ)) < 0.1
    fe_seq[wild] = rs.integers(-2 * nb - 3, 2 * nb + 3, int(wild.sum()))
    return lb_tables_from_numpy(
        fe_bytes, fe_port, fe_proto, fe_seq, fe_seq_len, rs.integers(1, 65536, f),
        rs.integers(0, 256, (nb, length)), rs.integers(1, 65536, nb), device="cpu")


def lb_case_flows(rs, fe_bytes, fe_port, fe_proto, b: int, proto0: float = 0.0):
    """[peer, dport, proto, fhash] CPU tensors: half the flows aimed at a
    frontend's address and port (its protocol 70% of the time, else TCP
    or UDP; an ANY frontend's flows TCP unless kept at 0), the rest
    random; a ``proto0`` share of all flows at protocol 0."""
    import numpy as np
    import torch

    f, length = fe_bytes.shape
    pick = rs.integers(0, f, b)
    aim = rs.random(b) < 0.5
    peer = np.where(aim[:, None], fe_bytes[pick], rs.integers(0, 256, (b, length)))
    dport = np.where(aim, fe_port[pick], rs.choice(np.array([53, 80, 443, 22]), b))
    proto = np.where(rs.random(b) < 0.7, fe_proto[pick], rs.choice(np.array([6, 17]), b))
    proto = np.where(proto == 0, 6, proto)
    proto[rs.random(b) < proto0] = 0
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        peer, dport, proto, rs.integers(-(2 ** 31), 2 ** 31, b))]


def k9_check(dev, tables, flows, what: str) -> None:
    """K9 on the card (both entries) against its plain version, exact:
    the five outputs of lb_translate, and the frontends the card's
    index holds against the plain index's (sorted)."""
    import dataclasses

    import torch

    from cilium_tpu_torch.lb.device import (
        lb_index_build, lb_index_build_plain, lb_index_entries, lb_translate, lb_translate_plain,
    )

    gt = dataclasses.replace(tables, **{
        fl.name: getattr(tables, fl.name).to(dev) for fl in dataclasses.fields(tables)})
    g_flows = [x.to(dev) for x in flows]
    got = lb_translate(gt, *g_flows)
    idx = lb_index_build(gt)
    # the plain version's dense [B, F, L] compare, on the same device, in
    # slices of at most 2^26 compares
    f, length = tables.fe_bytes.shape
    step = max(1, (1 << 26) // (f * length))
    parts = [lb_translate_plain(gt, *(x[lo:lo + step] for x in g_flows))
             for lo in range(0, max(flows[0].shape[0], 1), step)]
    want = [torch.cat([p[k] for p in parts]) for k in range(5)]
    torch.cuda.synchronize()
    for name, g, w in zip(("new_bytes", "new_port", "revnat", "ok", "no_backend"), got, want):
        if max_abs_err(g.cpu(), w.cpu()):
            fail(f"K9 lb_translate edge {what}: {name} differs")
    if not torch.equal(lb_index_entries(idx.cpu()), lb_index_entries(lb_index_build_plain(tables))):
        fail(f"K9 lb_index_build edge {what}: the index holds other frontends than the plain one")


def k9_trap_cases(rs, length: int):
    """(what, tables, flows) of the index's traps, CPU tensors: keys
    repeated (the lower frontend wins), ANY frontends before and after
    specific ones, protocol-0 flows, dport -1 against padded slots
    (fe_port -1, zero bytes, protocol 0), every key equal (one slot),
    and keys whose hashes all share one home slot (one chain)."""
    import numpy as np

    from cilium_tpu_torch.lb.device import lb_index_slots, lb_key_hash_np

    out = []
    # repeated keys: 24 distinct keys, each at 8 frontends
    keys = rs.integers(0, 256, (24, length))
    ports = rs.choice(np.array([80, 443]), 24)
    protos = rs.choice(np.array([0, 6, 17]), 24)
    pick = rs.permutation(np.repeat(np.arange(24), 8))
    fb, fp, fr = keys[pick], ports[pick], protos[pick]
    out.append(("repeated keys", fb, fp, fr, 0.1))
    # ANY before and after a specific frontend of one VIP and port
    vip = rs.integers(0, 256, (4, length))
    fb = vip[[0, 0, 1, 1, 2, 2, 2, 3]]
    fp = np.array([80, 80, 80, 80, 53, 53, 53, 443])
    fr = np.array([0, 6, 6, 0, 17, 0, 6, 0])
    out.append(("ANY before / after specific", fb, fp, fr, 0.2))
    # protocol-0 flows only
    out.append(("protocol-0 flows", fb, fp, fr, 1.0))
    # padded slots behind live frontends: dport -1 flows with zero bytes
    f = 40
    fb = np.zeros((f, length), np.int64)
    fb[:20] = rs.integers(0, 256, (20, length))
    fp = np.full(f, -1)
    fp[:20] = rs.choice(np.array([80, 443]), 20)
    fr = np.zeros(f, np.int64)
    fr[:20] = rs.choice(np.array([0, 6, 17]), 20)
    out.append(("padded slots", fb, fp, fr, 0.3))
    # every key equal
    f = 300
    out.append(("every key equal", np.repeat(rs.integers(0, 256, (1, length)), f, 0),
                np.full(f, 443), np.full(f, 6), 0.1))
    # one chain: 100 distinct keys with one home slot (words outside
    # [0, 255] among them: the index hashes full words)
    f = 100
    n = lb_index_slots(f)
    cand = rs.integers(-(2 ** 31), 2 ** 31, (60_000, length))
    cand[: 30_000] &= 255
    c_port = rs.choice(np.array([80, 443, -1]), 60_000)
    c_proto = rs.choice(np.array([0, 6, 17]), 60_000)
    home = (lb_key_hash_np(cand, c_port, c_proto) & np.uint32(n - 1)).astype(np.int64)
    top = np.bincount(home, minlength=n).argmax()
    sel = np.nonzero(home == top)[0][:f]
    if sel.size < f:
        fail(f"K9 edge: only {sel.size} candidate keys share a home slot")
    out.append(("one chain", cand[sel], c_port[sel], c_proto[sel], 0.1, int(top)))
    cases = []
    for what, fb, fp, fr, p0, *home in out:
        tables = lb_case_tables(rs, np.asarray(fb), np.asarray(fp), np.asarray(fr), 17)
        flows = lb_case_flows(rs, np.asarray(fb), np.asarray(fp), np.asarray(fr), 5000, p0)
        if what == "padded slots":
            flows[1][::3] = -1
            flows[0][::6] = 0
        cases.append((what, tables, flows, home[0] if home else None))
    return cases


def edge_checks4(dev) -> None:
    """K9 lb_translate (both entries) against its plain version, exact,
    on shapes the main path does not reach: F = 1, 300, 1025 and 20 000,
    F at 2^k and 2^k + 1 around the index's size steps (32 / 33, 1 024
    / 1 025, 4 096 / 4 097), B = 1 and ragged B, both address widths,
    ANY frontends shadowing specific ones, no-backend frontends,
    sequence rows past the backend table and negative, sequence lengths
    past the width, negative flow hashes, an empty batch; and the
    index's traps (k9_trap_cases): repeated keys, ANY before and after
    a specific frontend, protocol-0 flows, dport -1 against padded
    slots, every key equal, and 100 keys forced into one chain, whose
    slots on the card must be the chain's run from its home slot."""
    import numpy as np
    import torch

    from cilium_tpu_torch.lb.device import lb_index_build, lb_index_slots

    rs = np.random.default_rng(909)
    for length in (4, 16):
        for f, nb, b in ((1, 1, 1), (1, 3, 777), (2, 5, 1), (300, 40, 4099), (1025, 513, 1),
                         (1025, 513, 70_001), (5, 2, 0), (32, 9, 3001), (33, 9, 3001),
                         (1024, 300, 20_000), (4096, 900, 20_000), (4097, 900, 20_000),
                         (20_000, 4000, 70_001)):
            tables, flows = random_lb_case(rs, f, length, nb, b, proto0=0.05 if f > 30 else 0.0)
            k9_check(dev, tables, flows, f"F={f} NB={nb} B={b} L={length}")
        for what, tables, flows, home in k9_trap_cases(rs, length):
            k9_check(dev, tables, flows, f"{what} L={length}")
            if home is not None:
                f = tables.fe_port.shape[0]
                n = lb_index_slots(f)
                idx = lb_index_build(dataclasses.replace(tables, **{
                    fl.name: getattr(tables, fl.name).to(dev)
                    for fl in dataclasses.fields(tables)})).cpu()
                run = (home + torch.arange(n)) % n
                used = (idx[run] >= 0).to(torch.int64)
                if int(used[:f].sum()) != f or int(used[f:].sum()):
                    fail(f"K9 lb_index_build edge {what} L={length}: the {f} keys do not fill "
                         f"the {f} slots from their home slot {home}")


def build_services_world(seed: int):
    """The bench world with egress rules, and its services.

    The bench world has ingress rules only, so under default deny every
    egress flow would drop and no connection would ever be tracked.
    One egress rule per distinct endpoint app lets the endpoints reach
    pods of zones z0-z3 (half the identities) on the service ports
    {80, 443, 8080, 5432}/TCP and 53/UDP.

    Services (a ServiceManager): N_FE4 IPv4 ClusterIP frontends in
    10.96.0.0/16 and N_FE6 IPv6 ones in fd00:96::/112, each on a port of
    {80, 443, 8080, 5432}/TCP or 53/UDP; 1-8 backends each at bench
    identity addresses (10.x.y.1 / fd00::{hi}:{lo}) on a port the rules
    name, weights 1-4 on a quarter of the frontends; 16 v4 and 4 v6
    frontends with no backend; 8 v4 and 2 v6 proto-ANY frontends on the
    VIP and port of a specific one (half of them added before it, so
    they come first in the table)."""
    from cilium_tpu_torch.lb import Backend, L3n4Addr, ServiceManager
    from cilium_tpu_torch.policy.api import EgressRule, EndpointSelector, PortProtocol, PortRule, rule

    repo, reg, cache, idents, labels_of = build_world(seed)
    apps = sorted({labels_of[idents[j].id][0] for j in range(N_ENDPOINTS)})
    to = tuple(EndpointSelector.make([f"k8s:zone=z{z}"]) for z in range(4))
    ports = (PortRule(ports=tuple(PortProtocol(p, pr) for p, pr in SVC_PORTS)),)
    repo.add_list([rule([a], egress=[EgressRule(to_endpoints=to, to_ports=ports)]) for a in apps])

    rng = random.Random(seed + 96)
    m = ServiceManager()
    for fam, n_fe, n_empty, n_any in ((4, N_FE4, 16, 8), (6, N_FE6, 4, 2)):
        n_spec = n_fe - n_any
        empty = set(rng.sample(range(n_spec), n_empty))
        shadow = rng.sample(range(n_spec), n_any)
        for i in range(n_spec):
            vip = (f"10.96.{(i + 1) >> 8}.{(i + 1) & 255}" if fam == 4
                   else f"fd00:96::{i + 1:x}")
            port, proto = rng.choice(SVC_PORTS)
            weighted = rng.random() < 0.25
            backs = []
            for _ in range(0 if i in empty else rng.randint(1, 8)):
                j = rng.randrange(len(idents))
                ip = (f"10.{(j >> 8) & 255}.{j & 255}.1" if fam == 4
                      else f"fd00::{(j >> 8) & 255:x}:{j & 255:x}")
                bport = 53 if proto == "UDP" else rng.choice([80, 443, 8080, 5432])
                backs.append(Backend(ip, bport, rng.randint(1, 4) if weighted else 1))
            any_fe = L3n4Addr(vip, port, "ANY")
            if i in shadow[: n_any // 2]:
                m.upsert(any_fe, backs[:1])
            m.upsert(L3n4Addr(vip, port, proto), backs)
            if i in shadow[n_any // 2:]:
                m.upsert(any_fe, backs[:1])
    return repo, reg, cache, idents, labels_of, m


def make_svc_flows(seed: int, fam: int, n_idents: int, manager):
    """A 1 048 576-flow egress batch: 3/4 the bench's flows, 1/4 to the
    family's frontends (an ANY frontend's flows TCP or UDP), sports
    uniform in 1024-60000. → (peer, ep, dport, proto, sport, peer bytes);
    ``peer`` is uint32 for v4 and the [B, 16] bytes for v6."""
    import numpy as np

    from cilium_tpu_torch.ops.lpm import ipv4_to_bytes, ipv6_to_bytes

    if fam == 4:
        ips, eps, dports, protos, _ = make_flows(seed + 40, n_idents)
        pb = ipv4_to_bytes(ips)
    else:
        pb, eps, dports, protos, _ = make_flows6(seed + 40, n_idents)
    nrng = np.random.default_rng(seed + 41 + fam)
    fes = [s.frontend for s in manager.list() if s.frontend.family == fam]
    fe_bytes = (ipv4_to_bytes(np.array([int(ipaddress.IPv4Address(f.ip)) for f in fes], np.uint32))
                if fam == 4 else ipv6_to_bytes([f.ip for f in fes]))
    vip = nrng.random(BATCH) < 0.25
    pick = nrng.integers(0, len(fes), BATCH)
    any_proto = nrng.choice(np.array([6, 17], np.int32), BATCH)
    fe_port = np.array([f.port for f in fes], np.int32)[pick]
    fe_proto = np.array([f.proto_num for f in fes], np.int32)[pick]
    pb = np.where(vip[:, None], fe_bytes[pick], pb).astype(np.int32)
    dports = np.where(vip, fe_port, dports).astype(np.int32)
    protos = np.where(vip, np.where(fe_proto == 0, any_proto, fe_proto), protos).astype(np.int32)
    sports = nrng.integers(1024, 60001, BATCH)
    peer = pack_u32(pb) if fam == 4 else pb
    return peer, eps, dports, protos, sports, pb


def pack_u32(pb):
    import numpy as np

    b = pb.astype(np.uint32)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def lb_inputs(pipe, fam: int, pb, eps, dports, protos, sports):
    """The pipeline's LB stage inputs as tensors on its device: its
    tables and (peer bytes, dport, proto, flow hash over the stable
    endpoint ids)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.lb.device import flow_hash32

    ep_ids = np.asarray(pipe._endpoint_ids, np.int64)[eps]
    fh = flow_hash32(pb, sports, dports, protos, ep_ids)
    return pipe._lb_tables[fam], [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(pipe.device)
                                  for a in (pb, dports, protos, fh)]


def lb_scan_ops(t, peer, dport, proto) -> int:
    """int32 compares the first version of K9 (a first-match frontend
    scan) could not skip on these flows: one for each frontend it passes
    over, L + 2 (address bytes, port, protocol) for the one it stops at;
    all F for a flow that matches none. The old design's work, not the
    function's: printed beside K9's row, not its bound."""
    import torch

    f, length = t.fe_bytes.shape
    total = 0
    for lo in range(0, peer.shape[0], 1 << 17):
        p, d, r = peer[lo:lo + (1 << 17)], dport[lo:lo + (1 << 17)], proto[lo:lo + (1 << 17)]
        m = (t.fe_bytes[None] == p[:, None]).all(-1) & (d[:, None] == t.fe_port[None])
        m &= (t.fe_proto[None] == 0) | (r[:, None] == t.fe_proto[None])
        hit = m.any(1)
        first = m.to(torch.int8).argmax(1)
        scanned = torch.where(hit, first + 1, f)
        total += int(scanned.sum()) + int(hit.sum()) * (length + 1)
    return total


def svc_sequence(pipe, fam: int, batch, reply, overlay, probe=None):
    """The services+CT sequence on one pipeline → [(v, r) pass 1,
    (v, r) pass 2, (v, r, revnat) replies, (v, r) overlay]. ``probe``
    is called after each pass with its index."""
    call = getattr(pipe, "process" if fam == 4 else "process_v6")
    out = []
    peer, eps, dports, protos, sports = batch
    for k in range(2):  # pass 1: all new; pass 2: the same flows again
        out.append(call(peer, eps, dports, protos, ingress=False, sports=sports))
        if probe:
            probe(k)
    out.append(call(*reply[:4], ingress=True, sports=reply[4], return_rev_nat=True))
    if probe:
        probe(2)
    out.append(call(*overlay[:4], ingress=True, sports=overlay[4], tunnel_identities=overlay[5]))
    if probe:
        probe(3)
    return out


class PhaseClock:
    """Host-clock time of the pipeline's stages, by wrapping the methods
    that run them: the LB stage, the CT lookup (the pre-pass), the miss
    tail's device dispatch (both halves: enqueue and completion) and the
    CT creation. Records the size of each dispatch."""

    STAGES = (("lb", "pipe", "_lb_stage"), ("ct_prepass", "ct", "lookup_batch"),
              ("miss_tail", "pipe", "_dispatch_enqueue"),
              ("miss_tail", "pipe", "_dispatch_complete"), ("ct_create", "ct", "create_batch"))

    def __init__(self, pipe):
        self.objs = {"pipe": pipe, "ct": pipe.conntrack}
        self.secs = {name: 0.0 for name, _, _ in self.STAGES}
        self.tails = []
        for name, owner, attr in self.STAGES:
            real = getattr(self.objs[owner], attr)

            def timed_call(*a, _real=real, _name=name, _attr=attr, **k):
                if _attr == "_dispatch_enqueue":
                    self.tails.append(len(a[2]) if a[2] is not None else -1)
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    self.secs[_name] += time.perf_counter() - t0

            setattr(self.objs[owner], attr, timed_call)

    def take(self):
        out = dict(self.secs)
        for k in self.secs:
            self.secs[k] = 0.0
        return out

    def close(self):
        for _name, owner, attr in self.STAGES:
            delattr(self.objs[owner], attr)


def ct_live_keys(ct):
    import numpy as np

    s = ct.snapshot_arrays()
    order = np.lexsort((s["kc"], s["kb"], s["ka"]))
    return {k: s[k][order] for k in ("ka", "kb", "kc", "revnat", "packets")}


def svc_oracle(repo, labels_of, idents, endpoints, fam, pb_new, new_port, eps, protos, ok,
               verdicts, seed):
    """Hold N_ORACLE translated flows of pass 1 against
    Repository.allows_egress for the backend's identity and port."""
    import numpy as np

    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.search import Decision, PortContext, SearchContext

    idx = np.nonzero(ok)[0]
    sample = np.random.default_rng(seed).choice(idx, min(N_ORACLE, idx.size), replace=False)
    n_allowed = 0
    for i in sample:
        hi, lo = (int(pb_new[i, 1]), int(pb_new[i, 2])) if fam == 4 else (int(pb_new[i, 13]),
                                                                        int(pb_new[i, 15]))
        peer = parse_label_array(labels_of[idents[hi * 256 + lo].id])
        subj = parse_label_array(labels_of[endpoints[int(eps[i])]])
        pc = PortContext(int(new_port[i]), "UDP" if int(protos[i]) == 17 else "TCP")
        allowed = repo.allows_egress(SearchContext(src=subj, dst=peer, dports=(pc,))) == Decision.ALLOWED
        n_allowed += allowed
        if int(verdicts[i]) != (1 if allowed else 2):
            fail(f"services v{fam}: translated flow {i} verdict {int(verdicts[i])}, oracle "
                 f"{'allow' if allowed else 'deny'} for backend identity {hi * 256 + lo} port "
                 f"{int(new_port[i])}")
    if not 0 < n_allowed < sample.size:
        fail(f"services v{fam}: the oracle sample is all one verdict ({n_allowed}/{sample.size})")
    return sample.size


def services_main_path(seed: int, card: str):
    """The services+CT main path on the card, both families; returns
    what the CPU checks and the K9 rows need."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import DROP_NO_SERVICE, FORWARD, DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.lb.device import lb_translate

    t0 = time.perf_counter()
    repo, reg, cache, idents, labels_of, manager = build_services_world(seed)
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    engine = PolicyEngine(repo, reg)
    pipe = DatapathPipeline(engine, cache, conntrack=FlowConntrack(capacity_bits=CT_BITS),
                            lb=manager)
    # stable endpoint ids (the flow hash's input) apart from identity ids
    pipe.set_endpoints([(10_000 + j, e) for j, e in enumerate(endpoints)])
    pipe.rebuild()
    torch.cuda.synchronize()
    print(f"services world: {len(repo.rules)} rules ({len(repo.rules) - N_RULES} egress), "
          f"{manager.version} service upserts, frontends v4 {pipe._lb_tables[4].fe_port.shape[0]} "
          f"/ v6 {pipe._lb_tables[6].fe_port.shape[0]}, backends v4 "
          f"{pipe._lb_tables[4].be_port.shape[0]} / v6 {pipe._lb_tables[6].be_port.shape[0]}, "
          f"CT {pipe.conntrack.capacity} slots, refresh + rebuild in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # inputs of every batch, made before the launch counts are reset: the
    # replies need each flow's backend, which K9 computes here
    seqs = {}
    nrng = np.random.default_rng(seed + 77)
    for fam in (4, 6):
        peer, eps, dports, protos, sports, pb = make_svc_flows(seed, fam, len(idents), manager)
        tabs, flows = lb_inputs(pipe, fam, pb, eps, dports, protos, sports)
        nb, npo, rv, ok, nobk = (x.cpu().numpy() for x in lb_translate(tabs, *flows))
        reply = (pack_u32(nb) if fam == 4 else nb, eps, sports.astype(np.int32), protos,
                 npo.astype(np.int64))
        tun = np.zeros(BATCH, np.int64)
        lanes = nrng.random(BATCH) < 1 / 8
        known = nrng.random(BATCH) < 0.5
        ids = np.array(endpoints + [i.id for i in idents], np.int64)
        tun[lanes & known] = ids[nrng.integers(0, ids.size, int((lanes & known).sum()))]
        tun[lanes & ~known] = 900_000 + nrng.integers(0, 1000, int((lanes & ~known).sum()))
        overlay = (peer, eps, dports, protos, nrng.integers(1024, 60001, BATCH), tun)
        seqs[fam] = dict(batch=(peer, eps, dports, protos, sports), pb=pb, reply=reply,
                         overlay=overlay, lb=(nb, npo, rv, ok, nobk))

    _kernels.reset_launches()
    clock = PhaseClock(pipe)
    res = {}
    pass_times = {}
    k4 = []
    for fam in (4, 6):
        s = seqs[fam]
        times, stages = [], []
        t_last = [time.perf_counter()]

        def probe(k):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append(now - t_last[0])
            stages.append(clock.take())
            k4.append(_kernels.launches()["policymap_verdict"])
            t_last[0] = time.perf_counter()

        clock.tails.clear()
        before = _kernels.launches()["policymap_verdict"]
        k4.clear()
        out = svc_sequence(pipe, fam, s["batch"], s["reply"], s["overlay"], probe=probe)
        res[fam] = out
        pass_times[fam] = times
        (v1, r1), (v2, _r2), (vr, _rr, rev), (vo, _ro) = out
        nb, npo, rv, ok, nobk = s["lb"]
        admitted = (v1 == FORWARD) & ~r1
        want_tail = int((~admitted).sum())
        tails = list(clock.tails)
        print(f"main path services+CT v{fam} [{card}]: {BATCH} flows a pass, host clock "
              f"(torch.cuda.synchronize after each), n_ct {len(pipe.conntrack)}", flush=True)
        for name, dt, st in zip(("pass 1 (new)", "pass 2 (established)",
                                 "replies (revNAT)", "overlay"), times, stages):
            print(f"  {name}: {dt!r}s = {BATCH / dt!r} flows/s; stages {st}", flush=True)
        print(f"  verdicts pass 1 {np.bincount(v1, minlength=5)[1:].tolist()} (translated "
              f"{int(ok.sum())}, no backend {int(nobk.sum())}), pass 2 "
              f"{np.bincount(v2, minlength=5)[1:].tolist()}, replies "
              f"{np.bincount(vr, minlength=5)[1:].tolist()} (revNAT ids {int((rev != 0).sum())}),"
              f" overlay {np.bincount(vo, minlength=5)[1:].tolist()}; miss tails {tails}; "
              f"policymap_verdict launches after each pass {[x - before for x in k4]}", flush=True)
        if not (ok.any() and nobk.any() and admitted.any() and (~admitted).any()):
            fail(f"services v{fam}: pass 1 lacks translated, no-backend, admitted or denied flows")
        if not (v1[nobk] == DROP_NO_SERVICE).all() or (v1[~nobk] == DROP_NO_SERVICE).any():
            fail(f"services v{fam}: DROP_NO_SERVICE does not follow the no-backend flows")
        if tails[:2] != [BATCH, want_tail]:
            fail(f"services v{fam}: miss tails {tails[:2]}, expected [{BATCH}, {want_tail}]")
        if [x - before for x in k4[:2]] != [1, 2]:
            fail(f"services v{fam}: K4 launched {[x - before for x in k4[:2]]} on passes 1-2")
        if not ((v2 == v1) | admitted).all() or not (v2[admitted] == FORWARD).all():
            fail(f"services v{fam}: pass 2 differs from pass 1 outside the bypass")
        if not (vr[admitted] == FORWARD).all():
            fail(f"services v{fam}: a reply of an admitted flow was not forwarded")
        # an entry keeps the revNAT id of the first admitted flow with its
        # key: a direct flow to a backend can share its key with a flow
        # translated to that backend (same endpoint, sport, port)
        keys = np.concatenate([nb.astype(np.int64), np.stack(
            [s["batch"][1], s["batch"][4], npo, s["batch"][3]], 1).astype(np.int64)], 1)[admitted]
        _u, first, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
        want_rev = np.zeros(BATCH, np.uint16)
        want_rev[admitted] = rv[admitted][first][inv.reshape(-1)]
        shared = int((want_rev != np.where(admitted, rv, 0)).sum())
        if not np.array_equal(rev, want_rev) or not rev.any():
            fail(f"services v{fam}: reply revNAT ids differ from the services' ids")
        for i in np.nonzero(rev)[0][:8]:
            fe = pipe.rev_nat_frontend(int(rev[i]))
            if fe is None or fe.port != int(s["batch"][2][i]):
                fail(f"services v{fam}: rev_nat_frontend({int(rev[i])}) = {fe}")
        tun = s["overlay"][5]
        if not (vo[(tun > 0) & (tun < 900_000)] == FORWARD).any():
            fail(f"services v{fam}: no overlay flow with a trusted identity was forwarded")
        print(f"  replies: {int((rev != 0).sum())} revNAT ids, each its service's; {shared} "
              "flows share their key with an earlier admitted flow of another revNAT id",
              flush=True)
    clock.close()
    k9 = {k: _kernels.launches()[k] for k in ("lb_index_build", "lb_translate")}
    if set(k9.values()) != {4}:
        fail(f"K9's entries launched {k9}, expected each once per egress batch (4)")
    for fam in (4, 6):
        nb, npo, rv, ok, nobk = seqs[fam]["lb"]
        n = svc_oracle(repo, labels_of, idents, endpoints, fam, nb, npo, seqs[fam]["batch"][1],
                       seqs[fam]["batch"][3], ok, res[fam][0][0], seed + fam)
    print(f"services: translated flows == host oracle (allows_egress for the backend's identity "
          f"and port) on {n} flows of each family", flush=True)
    return dict(repo=repo, reg=reg, cache=cache, manager=manager, pipe=pipe, seqs=seqs,
                res=res, endpoints=endpoints, pass_times=pass_times)


def services_cpu_checks(r) -> None:
    """The first SLICE flows of each batch sequence on a CPU pipeline
    over the same world (its own conntrack) and on the card pipeline
    (conntrack flushed, counters zeroed): verdicts, redirects, revNAT
    ids, counters and live CT keys equal; and the card's full-batch
    results equal to the CPU's on those flows."""
    import numpy as np

    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine

    t0 = time.perf_counter()
    gpu = r["pipe"]
    cpu = DatapathPipeline(PolicyEngine(r["repo"], r["reg"], device="cpu"), r["cache"],
                           conntrack=FlowConntrack(capacity_bits=18), lb=r["manager"],
                           device="cpu")
    cpu.set_endpoints([(10_000 + j, e) for j, e in enumerate(r["endpoints"])])
    cpu.rebuild()
    s_ = slice(0, SLICE)
    for fam in (4, 6):
        q = r["seqs"][fam]
        args = [tuple(a[s_] for a in q[k]) for k in ("batch", "reply", "overlay")]
        gpu.conntrack.flush()
        gpu.counters[:] = 0
        runs = []
        for pipe in (gpu, cpu):
            state = []
            out = svc_sequence(pipe, fam, *args, probe=lambda k, pipe=pipe, state=state: state.append(
                (pipe.counters.copy(), ct_live_keys(pipe.conntrack))))
            runs.append((out, state))
        (g_out, g_state), (c_out, c_state) = runs
        for k in range(4):
            if not all(np.array_equal(a, b) for a, b in zip(g_out[k], c_out[k])):
                fail(f"services v{fam}: pass {k} outputs differ between card and CPU")
            if not np.array_equal(g_state[k][0], c_state[k][0]):
                fail(f"services v{fam}: counters after pass {k} differ between card and CPU")
            for key in g_state[k][1]:
                if not np.array_equal(g_state[k][1][key], c_state[k][1][key]):
                    fail(f"services v{fam}: live CT {key} after pass {k} differ between card "
                         "and CPU")
            # the full card batch, on its first SLICE flows
            for a, b in zip(r["res"][fam][k], c_out[k]):
                if not np.array_equal(a[s_], b):
                    bad = int(np.argmax(a[s_] != b))
                    fail(f"services v{fam}: pass {k} of the full card batch differs from the "
                         f"CPU path at flow {bad}")
        if not len(cpu.conntrack):
            fail(f"services v{fam}: the CPU slice created no CT entry")
        cpu.conntrack.flush()
        cpu.counters[:] = 0
    print(f"services: card == CPU on the first {SLICE} flows of each batch sequence (verdicts, "
          f"redirects, revNAT ids, counters and live CT keys after every pass), v4 and v6, in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)


def ct_clone(st, device=None):
    """A copy of a DeviceCTState (on ``device``, default its own)."""
    import dataclasses

    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).to(device or getattr(st, f.name).device, copy=True)
        for f in dataclasses.fields(st)})


def ct_state_err(a, b) -> int:
    import dataclasses

    return max(max_abs_err(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


def dense_ct_state(rs, bits: int, pool, kc, now: int):
    """A CPU DeviceCTState at ~90% load around a pool of flows (``pool``
    the four peer words, ``kc`` their kc words, uint32 or int32): live
    slots with exp in (now, now + 200], random keys; in three slots of
    each pool flow's forward window and two of its reply window a decoy
    that carries the tuple's kc_lo tag and differs from its key in one
    other word (the record must reject it); the real key in a slot of
    the forward window for 1/3 of the flows and the flipped key in the
    reply window for 1/4. → (state, lanes whose windows hold a live
    decoy)."""
    import numpy as np

    from cilium_tpu_torch.convert import device_ct_state_from_numpy
    from cilium_tpu_torch.datapath import device_ct as dct

    def u(a):
        return np.asarray(a).astype(np.int64).astype(np.uint32)

    c = 1 << bits
    fwd = [u(w) for w in (*pool, *kc)]
    f_hi, f_lo = dct._flip_kc_words(torch_i32(fwd[4]), torch_i32(fwd[5]))
    rep = [*fwd[:4], u(f_hi.numpy()), u(f_lo.numpy())]
    arrays = [rs.integers(0, 1 << 32, c, dtype=np.uint64).astype(np.uint32) for _ in range(6)]
    exp = np.zeros(c, np.int32)
    live = rs.random(c) < 0.9
    exp[live] = now + rs.integers(1, 201, int(live.sum()))
    n = fwd[0].shape[0]
    for key, n_decoy, share in ((fwd, 3, 1 / 3), (rep, 2, 1 / 4)):
        h = dct._hash_tuple_np(*key).astype(np.int64)
        slots = (h[:, None] + rs.integers(0, dct.CT_PROBES, (n, n_decoy))) & (c - 1)
        other = rs.integers(0, 5, (n, n_decoy))  # the key word the decoy changes
        for d in range(n_decoy):
            for k in range(6):
                arrays[k][slots[:, d]] = key[k]
            col = other[:, d]
            for k in range(5):
                sel = col == k
                arrays[k][slots[sel, d]] = key[k][sel] ^ np.uint32(1 + k)
        real = np.nonzero(rs.random(n) < share)[0]
        at = (h[real] + rs.integers(0, dct.CT_PROBES, real.size)) & (c - 1)
        for k in range(6):
            arrays[k][at] = key[k][real]
        exp[at] = np.maximum(exp[at], now + 50)
    st = device_ct_state_from_numpy([*arrays, exp], device="cpu")
    h = dct._hash_tuple_np(*fwd).astype(np.int64)
    win = (h[:, None] + np.arange(dct.CT_PROBES)[None, :]) & (c - 1)
    tags = (exp[win] > now) & (arrays[5][win] == fwd[5][:, None])
    same = np.ones(win.shape, bool)
    for k in range(5):
        same &= arrays[k][win] == fwd[k][:, None]
    return st, int((tags & ~same).any(1).sum())


def torch_i32(a):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.int64).astype(np.uint32)
                                                 .view(np.int32)))


def edge_checks5(dev) -> None:
    """K10 ct_step (both entries) against its plain version, exact, over
    several steps of one table: 16-, 64- and 1024-slot tables with live,
    expired (UDP after 60 s) and reply-tuple entries, flows that repeat
    in a batch (contested slots), probe windows that wrap past C-1, B = 0
    and B = 1, ct_step alone and with the verdict tail (a shared and a
    global-atomic counter histogram, invalid lanes); 1024- and 4096-slot
    tables at ~90% load (dense_ct_state: windows full of live slots whose
    kc_lo tags match the lanes' and whose records differ in one word);
    4- and 8-slot tables (windows that wrap onto themselves);
    and the wrapper's refusals (C not a power of two, more endpoints than
    the 23 bits of the kc word hold, a record layout that is not [C, 8],
    records off a 32-byte boundary)."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.datapath import device_ct as dct

    rs = np.random.default_rng(4321)
    for bits, b, n_pool, ep_count, dense in (
            (4, 64, 24, 3, False), (4, 1, 4, 1, False), (4, 0, 4, 1, False),
            (6, 777, 300, 64, False), (10, 3000, 1200, 2100, False), (10, 2000, 128, 64, True),
            (12, 6000, 512, 64, True), (3, 200, 40, 4, False), (2, 50, 12, 4, False)):
        pool = [rs.integers(-2**31, 2**31, n_pool).astype(np.int32) for _ in range(4)]
        ep = rs.integers(0, ep_count, n_pool).astype(np.int32)
        sp = rs.integers(0, 65536, n_pool).astype(np.int32)
        dp = rs.integers(0, 65536, n_pool).astype(np.int32)
        pr = rs.choice(np.array([6, 17], np.int32), n_pool)
        dr = rs.integers(0, 2, n_pool).astype(np.int32)
        if dense:
            kc = dct.pack_kc_words(*(torch.from_numpy(x) for x in (ep, sp, dp, pr, dr)))
            st, n_decoy = dense_ct_state(rs, bits, pool, [x.numpy() for x in kc], 1000)
            if n_decoy < n_pool // 2:
                fail(f"K10 ct_step edge C={1 << bits}: only {n_decoy} of {n_pool} forward "
                     "windows hold a live decoy")
        else:
            st = dct.make_state(bits, device="cpu")
        for step in range(5):
            idx = rs.integers(0, n_pool, b)
            rep = rs.random(b) < (0.5 if step % 2 else 0.0)  # half the lanes as replies
            fields = [np.where(rep, dp[idx], sp[idx]), np.where(rep, sp[idx], dp[idx]),
                      np.where(rep, 1 - dr[idx], dr[idx])]
            cpu_in = [torch.from_numpy(np.ascontiguousarray(w[idx])) for w in pool]
            kc = dct.pack_kc_words(torch.from_numpy(ep[idx]), torch.from_numpy(fields[0]),
                                   torch.from_numpy(fields[1]), torch.from_numpy(pr[idx]),
                                   torch.from_numpy(fields[2]))
            cpu_in += [*kc, torch.from_numpy(pr[idx])]
            now = 1000 + 40 * step
            gpu, cpu = ct_clone(st, dev), ct_clone(st, "cpu")
            g_in = [x.to(dev) for x in cpu_in]
            if step % 2 == 0:
                allow = torch.from_numpy(rs.random(b) < 0.7)
                outs = [dct.ct_step(s, (x[0], x[1]), (x[2], x[3]), (x[4], x[5]), x[6], now,
                                    a) for s, x, a in ((gpu, g_in, allow.to(dev)),
                                                       (cpu, cpu_in, allow))]
            else:
                tail = [torch.from_numpy(rs.choice(np.array([1, 1, 2, 3], np.int8), b)),
                        torch.from_numpy(rs.random(b) < 0.2), torch.from_numpy(rs.random(b) < 0.9),
                        torch.from_numpy(ep[idx])]
                outs = [dct.ct_step_verdict(s, (x[0], x[1]), (x[2], x[3]), (x[4], x[5]), x[6],
                                            now, *t, ep_count)
                        for s, x, t in ((gpu, g_in, [y.to(dev) for y in tail]), (cpu, cpu_in, tail))]
            torch.cuda.synchronize()
            g_out, c_out = (o if isinstance(o, tuple) else (o,) for o in outs)
            err = max([max_abs_err(g.cpu(), c) for g, c in zip(g_out, c_out)] + [ct_state_err(gpu, cpu)])
            if err:
                fail(f"K10 ct_step edge C={1 << bits} B={b} step {step}{' dense' if dense else ''}: "
                     "card and plain differ")
            if dense and step == 0 and not bool(c_out[0].any()):
                fail(f"K10 ct_step edge C={1 << bits} dense: no lane was established")
            st = cpu
        if b > 1 and not int((st.exp > 1000 + 40 * 4).sum()):
            fail(f"K10 ct_step edge C={1 << bits} B={b}: no live entry after five steps")
    bad = dct.make_state(4, device=dev)
    cut = dataclasses.replace(bad, exp=bad.exp[:12].clone(), kc_lo=bad.kc_lo[:12].clone(),
                              rec=bad.rec[:12].clone())
    wide = dataclasses.replace(bad, rec=torch.zeros((16, 6), dtype=torch.int32, device=dev))
    off = dataclasses.replace(bad, rec=torch.zeros((17, 8), dtype=torch.int32, device=dev)
                              .view(-1)[4:4 + 16 * 8].view(16, 8))
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    for what, state, ep_count in (("C = 12", cut, 4), ("ep_count 2**23 + 1", bad, (1 << 23) + 1),
                                  ("a [16, 6] record table", wide, 4),
                                  ("records off a 32-byte boundary", off, 4)):
        try:
            dct.ct_step_verdict(state, (one, one), (one, one), (one, one), one + 6, 5,
                                (one + 1).to(torch.int8), one > 0, one == 0, one, ep_count)
        except ValueError:
            continue
        fail(f"K10 ct_step took {what}")


class CTRecorder:
    """Wraps the pipeline module's ct_step_verdict, which process_flows_ct
    calls, to keep each call's established lanes and arguments."""

    def __init__(self):
        from cilium_tpu_torch.datapath import pipeline as pmod

        self.mod, self.real = pmod, pmod.ct_step_verdict
        self.calls = []

        def call(*a, **k):
            out = self.real(*a, **k)
            self.calls.append((a, out[3]))
            return out

        pmod.ct_step_verdict = call

    def close(self):
        self.mod.ct_step_verdict = self.real


def flow_keys(fam: int, pb, eps, sports, dports, protos, ingress: bool):
    """[B] 24-byte CT keys of the flows (the host CT's pack_keys words),
    as a numpy void view for set tests."""
    import numpy as np

    from cilium_tpu_torch.datapath.conntrack import pack_keys
    from cilium_tpu_torch.datapath.pipeline import _peer_words

    hi, lo = _peer_words(np.asarray(pb), fam)
    b = hi.shape[0]
    ka, kb, kc = pack_keys(hi, lo, np.asarray(eps, np.uint64), np.asarray(sports, np.uint64),
                           np.asarray(dports, np.uint64), np.asarray(protos, np.uint64),
                           np.full(b, 0 if ingress else 1, np.uint64))
    return void_keys(ka, kb, kc)


def void_keys(ka, kb, kc):
    import numpy as np

    k = np.ascontiguousarray(np.stack([ka, kb, kc], 1).astype(np.uint64))
    return k.view(np.dtype((np.void, 24))).ravel()


def device_ct_main_path(svc, card: str):
    """The device-CT main path on the card, both families, on the
    services world with no LB: DatapathPipeline(engine, cache, pf,
    device_ct_bits=CT_BITS), launch counts from zero, four 1 048 576-flow
    passes per family (egress pass 1, the same batch, the replies from
    each flow's destination with the ports swapped, the overlay batch on
    the host CT fallback)."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.device_ct import pull_live_entries
    from cilium_tpu_torch.datapath.pipeline import FORWARD, DatapathPipeline
    from cilium_tpu_torch.ipcache.prefilter import PreFilter

    t0 = time.perf_counter()
    pipe = DatapathPipeline(svc["pipe"].engine, svc["cache"], PreFilter(), device_ct_bits=CT_BITS)
    pipe.set_endpoints([(10_000 + j, e) for j, e in enumerate(svc["endpoints"])])
    pipe.rebuild()
    torch.cuda.synchronize()
    c = 1 << CT_BITS
    print(f"device CT: pipeline with device_ct_bits={CT_BITS} ({c} slots) and no LB, host CT "
          f"fallback {pipe.conntrack.capacity} slots, rebuilt in {time.perf_counter() - t0:.2f}s",
          flush=True)
    seqs = {}
    for fam in (4, 6):
        q = svc["seqs"][fam]
        peer, eps, dports, protos, sports = q["batch"]
        seqs[fam] = dict(batch=q["batch"], pb=q["pb"],
                         reply=(peer, eps, sports.astype(np.int32), protos, dports.astype(np.int64)),
                         overlay=q["overlay"])

    _kernels.reset_launches()
    rec = CTRecorder()
    res, args, hit_state, pass_times = {}, {}, {}, {}
    for fam in (4, 6):
        q = seqs[fam]
        times, k10, live = [], [], []
        t_last = [time.perf_counter()]

        def probe(k):
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t_last[0])
            k10.append(_kernels.launches()["ct_probe_claim"])
            if k == 0:
                hit_state[fam] = ct_clone(pipe._device_ct)
            if k < 3:
                live.append(pull_live_entries(pipe._device_ct, int(time.monotonic()), limit=c))
            t_last[0] = time.perf_counter()

        n_calls = len(rec.calls)
        if len(pipe.conntrack):
            fail("device CT: the host CT fallback holds entries before the overlay pass")
        k10_0 = _kernels.launches()["ct_probe_claim"]
        out = svc_sequence(pipe, fam, q["batch"], q["reply"], q["overlay"], probe=probe)
        res[fam], pass_times[fam] = out, times
        calls = rec.calls[n_calls:]
        if len(calls) != 3 or [x - k10_0 for x in k10] != [1, 2, 3, 3]:
            fail(f"device CT v{fam}: K10 launched {[x - k10_0 for x in k10]} after the passes, "
                 f"expected [1, 2, 3, 3] (the overlay pass on the host CT)")
        args[fam] = (calls[0][0], calls[1][0])
        est1, est2, est_r = (x[1].cpu().numpy() for x in calls)
        (v1, r1), (v2, r2), (vr, _rr, rev), (vo, _ro) = out
        peer, eps, dports, protos, sports = q["batch"]
        keys = flow_keys(fam, q["pb"], eps, sports, dports, protos, False)
        admitted = (v1 == FORWARD) & ~r1
        in1 = np.isin(keys, void_keys(live[0]["ka"], live[0]["kb"], live[0]["kc"]))
        in2 = np.isin(keys, void_keys(live[1]["ka"], live[1]["kb"], live[1]["kc"]))
        n_keys = np.unique(keys[admitted]).size
        inserted1, inserted2 = len(live[0]["ka"]), len(live[1]["ka"]) - len(live[0]["ka"])
        print(f"main path device CT v{fam} [{card}]: {BATCH} flows a pass, host clock "
              f"(torch.cuda.synchronize after each)", flush=True)
        for name, dt, ht in zip(("pass 1 (new)", "pass 2 (established)", "replies",
                                 "overlay (host CT fallback)"), times, svc["pass_times"][fam]):
            print(f"  {name}: {dt!r}s = {BATCH / dt!r} flows/s (host CT pipeline with LB, same "
                  f"run: {ht!r}s)", flush=True)
        print(f"  pass 1: admitted {int(admitted.sum())} ({n_keys} distinct keys), inserted "
              f"{inserted1}, lost to conflicts or full windows {n_keys - inserted1}; pass 2: "
              f"established {int(est2.sum())}, inserted {inserted2}; replies: established "
              f"{int(est_r.sum())}, forwarded {int((vr == FORWARD).sum())}; verdicts pass 1 "
              f"{np.bincount(v1, minlength=4)[1:].tolist()}, pass 2 "
              f"{np.bincount(v2, minlength=4)[1:].tolist()}, replies "
              f"{np.bincount(vr, minlength=4)[1:].tolist()}, overlay "
              f"{np.bincount(vo, minlength=4)[1:].tolist()} (host CT {len(pipe.conntrack)} "
              f"entries); K10 launches {k10[-1] - k10_0}", flush=True)
        if est1.any():
            fail(f"device CT v{fam}: a flow was established on a fresh table")
        if not (admitted.any() and (~admitted).any() and inserted1 > 0):
            fail(f"device CT v{fam}: pass 1 admitted or inserted nothing, or everything")
        if (est2 & ~admitted).any() or (est_r & ~in2).any():
            fail(f"device CT v{fam}: a flow whose policy verdict is a drop came back established")
        if not np.array_equal(est2, in1):
            fail(f"device CT v{fam}: pass 2 established {int(est2.sum())} flows, pass 1 inserted "
                 f"the keys of {int(in1.sum())}")
        if not np.array_equal(est_r, in2) or not (vr[in2] == FORWARD).all():
            fail(f"device CT v{fam}: a reply of an inserted flow was not forwarded")
        if not (np.array_equal(v2, np.where(admitted, FORWARD, v1)) and not (r2 & admitted).any()):
            fail(f"device CT v{fam}: pass 2 differs from pass 1 outside the bypass")
        if rev.any():
            fail(f"device CT v{fam}: the device path returned revNAT ids")
        if not len(pipe.conntrack):
            fail(f"device CT v{fam}: the overlay pass did not take the host CT")
        with pipe._lock:
            pipe._flush_ct_locked()
    rec.close()
    print(f"device CT main path and its checks in {time.perf_counter() - t0:.2f}s", flush=True)
    return dict(pipe=pipe, seqs=seqs, res=res, args=args, hit_state=hit_state,
                pass_times=pass_times)


def host_ct_compare(svc, r, card: str) -> None:
    """The same four batches of each family through the pipeline that
    the device CT replaces on this path: host CT, no LB
    (DatapathPipeline(engine, cache, pf, FlowConntrack(CT_BITS))). Prints
    each pass's host-clock time beside the device-CT pass's, and holds
    passes 1-2 equal to the device-CT pipeline's (an admitted flow
    forwards whether or not it is established) and every reply that the
    device-CT pipeline forwards forwarded here too."""
    import numpy as np
    import torch

    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import FORWARD, DatapathPipeline
    from cilium_tpu_torch.ipcache.prefilter import PreFilter

    t0 = time.perf_counter()
    pipe = DatapathPipeline(svc["pipe"].engine, svc["cache"], PreFilter(),
                            FlowConntrack(capacity_bits=CT_BITS))
    pipe.set_endpoints([(10_000 + j, e) for j, e in enumerate(svc["endpoints"])])
    pipe.rebuild()
    for fam in (4, 6):
        q = r["seqs"][fam]
        times, t_last = [], [time.perf_counter()]

        def probe(_k):
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t_last[0])
            t_last[0] = time.perf_counter()

        t_last[0] = time.perf_counter()
        out = svc_sequence(pipe, fam, q["batch"], q["reply"], q["overlay"], probe=probe)
        dev = r["res"][fam]
        for k in range(2):
            if not all(np.array_equal(a, b) for a, b in zip(out[k], dev[k])):
                fail(f"host CT without LB v{fam}: pass {k + 1} differs from the device-CT pipeline")
        if ((dev[2][0] == FORWARD) & (out[2][0] != FORWARD)).any():
            fail(f"host CT without LB v{fam}: a reply the device CT forwards was not forwarded")
        print(f"host CT without LB v{fam} [{card}]: {len(pipe.conntrack)} entries after the four "
              f"passes; host clock (torch.cuda.synchronize after each)", flush=True)
        for name, ht, dt in zip(("pass 1 (new)", "pass 2 (established)", "replies",
                                 "overlay"), times, r["pass_times"][fam]):
            print(f"  {name}: {ht!r}s (device CT pipeline, same run: {dt!r}s, ratio "
                  f"{ht / dt!r})", flush=True)
        with pipe._lock:
            pipe._flush_ct_locked()
    print(f"host CT without LB on the device-CT batches in {time.perf_counter() - t0:.2f}s",
          flush=True)


def device_ct_cpu_checks(svc, r) -> None:
    """The first SLICE flows of each device-CT sequence on a CPU pipeline
    (device="cpu", same device_ct_bits) and on the card pipeline (tables
    flushed, counters zeroed), time.monotonic pinned for both: verdicts,
    redirects, revNAT ids, counters, the device table slot by slot
    (pull_live_entries and the live slots) and the host CT's live keys
    after every pass; and passes 1-2 of the full card batch on those
    flows."""
    import numpy as np

    from cilium_tpu_torch.datapath.device_ct import pull_live_entries
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter

    t0 = time.perf_counter()
    gpu = r["pipe"]
    cpu = DatapathPipeline(PolicyEngine(svc["repo"], svc["reg"], device="cpu"), svc["cache"],
                           PreFilter(), device_ct_bits=CT_BITS, device="cpu")
    cpu.set_endpoints([(10_000 + j, e) for j, e in enumerate(svc["endpoints"])])
    cpu.rebuild()
    now_s = int(time.monotonic())
    real_clock = time.monotonic
    time.monotonic = lambda: now_s + 0.5
    try:
        for fam in (4, 6):
            q = r["seqs"][fam]
            args = [tuple(a[:SLICE] for a in q[k]) for k in ("batch", "reply", "overlay")]
            runs = []
            for pipe in (gpu, cpu):
                with pipe._lock:
                    pipe._flush_ct_locked()
                pipe.counters[:] = 0
                state = []

                def probe(k, pipe=pipe, state=state):
                    dct = pull_live_entries(pipe._device_ct, now_s, limit=1 << CT_BITS)
                    slots = np.nonzero(pipe._device_ct.exp.cpu().numpy() > now_s)[0]
                    state.append((pipe.counters.copy(), dct, slots, ct_live_keys(pipe.conntrack)))

                runs.append((svc_sequence(pipe, fam, *args, probe=probe), state))
            (g_out, g_state), (c_out, c_state) = runs
            for k in range(4):
                if not all(np.array_equal(a, b) for a, b in zip(g_out[k], c_out[k])):
                    fail(f"device CT v{fam}: pass {k} outputs differ between card and CPU")
                (gc, gd, gs, gh), (cc, cd, cs, ch) = g_state[k], c_state[k]
                if not np.array_equal(gc, cc):
                    fail(f"device CT v{fam}: counters after pass {k} differ between card and CPU")
                if not np.array_equal(gs, cs) or any(not np.array_equal(gd[x], cd[x]) for x in gd):
                    fail(f"device CT v{fam}: the device table after pass {k} differs between card "
                         "and CPU")
                if any(not np.array_equal(gh[x], ch[x]) for x in gh):
                    fail(f"device CT v{fam}: host CT keys after pass {k} differ between card and "
                         "CPU")
            for k in range(2):
                for a, b in zip(r["res"][fam][k], c_out[k]):
                    if not np.array_equal(a[:SLICE], b):
                        fail(f"device CT v{fam}: pass {k} of the full card batch differs from the "
                             "CPU path")
            if not len(c_state[0][1]["ka"]) or not len(c_state[3][3]["ka"]):
                fail(f"device CT v{fam}: the CPU slice filled no device or host CT entry")
    finally:
        time.monotonic = real_clock
    for pipe in (gpu, cpu):
        with pipe._lock:
            pipe._flush_ct_locked()
    print(f"device CT: card == CPU on the first {SLICE} flows of each sequence (verdicts, "
          f"redirects, revNAT ids, counters, the device table slot by slot and the host CT keys "
          f"after every pass), v4 and v6, in {time.perf_counter() - t0:.2f}s", flush=True)


def ct_step_bytes(before, after, words, now: int, n_lanes: int, ep_count: int):
    """Bytes K10 must move, as this run's data needs them, in the two
    layouts → {"arrays": (distinct, per lane), "record": (distinct, per
    lane)}: "distinct" counts each 32-byte sector once, "per lane" as if
    no two windows shared a sector. Of each forward and reply window:
    exp up to the first live slot holding the key (all 8 slots without
    one), kc_lo of the live slots among those, and the other key words
    of that matching slot: five sectors in the seven [C] arrays of the
    first version, one record sector in the record layout; the sectors
    whose content the step changed, written once (an insert: seven
    arrays, or exp, kc_lo and the record); and the flows in (six words,
    proto, verdict, redirect, valid, ep_idx) and out (verdict, redirect,
    established, counters) once."""
    import torch

    from cilium_tpu_torch.datapath.device_ct import CT_PROBES, _flip_kc_words, _hash_u32, _window

    live = before.exp > now
    pos = torch.arange(CT_PROBES, device=live.device)
    f_hi, f_lo = _flip_kc_words(words[4], words[5])
    sectors = {"exp": [], "kc_lo": [], "key": []}
    window_lane = key_lane = 0
    for ws in (words, (*words[:4], f_hi, f_lo)):
        slots = _window(_hash_u32(*ws), before.capacity)
        lv = live[slots]
        match = lv.clone()
        for table, w in zip(before.keys(), ws):
            match &= table[slots] == w.to(torch.int32)[:, None]
        hit = match.any(1)
        first = match.to(torch.int8).argmax(1)
        need = pos[None, :] <= torch.where(hit, first, CT_PROBES - 1)[:, None]
        sec = slots >> 3
        head = sec[:, :1]  # a window spans its first slot's sector and at most one more
        for name, m in (("exp", need), ("kc_lo", need & lv)):
            sectors[name].append(sec[m])
            window_lane += int((m & (sec == head)).any(1).sum() + (m & (sec != head)).any(1).sum())
        sectors["key"].append(slots.gather(1, first[:, None])[hit, 0])
        key_lane += int(hit.sum())
    n = {k: torch.unique(torch.cat(v) >> (3 if k == "key" else 0)).numel()
         for k, v in sectors.items()}
    n_rec = torch.unique(torch.cat(sectors["key"])).numel()

    def changed(x, y, per_sector):
        diff = (x != y) if x.dim() == 1 else (x != y).any(1)
        return torch.unique(torch.nonzero(diff)[:, 0] // per_sector).numel() * 32

    w_exp = changed(before.exp, after.exp, 8)
    w_kc_lo = changed(before.kc_lo, after.kc_lo, 8)
    w_arrays = w_exp + w_kc_lo + sum(changed(x, y, 8) for x, y in zip(before.keys()[:5],
                                                                        after.keys()[:5]))
    w_rec = w_exp + w_kc_lo + changed(before.rec[:, :5], after.rec[:, :5], 1)
    flows = n_lanes * (6 * 4 + 4 + 1 + 1 + 1 + 4) + n_lanes * 3 + ep_count * 3 * 4
    window = (n["exp"] + n["kc_lo"]) * 32
    return {
        "arrays": (window + 5 * n["key"] * 32 + w_arrays + flows,
                   (window_lane + 5 * key_lane) * 32 + w_arrays + flows),
        "record": (window + n_rec * 32 + w_rec + flows,
                   (window_lane + key_lane) * 32 + w_rec + flows),
    }


def lb_rows(svc, row, card: str) -> None:
    """The K9 rows: ``row(...)`` for each family's pass-1 batch and both
    entries, and the probe entry alone in a CUDA graph."""
    from cilium_tpu_torch.lb.device import (
        lb_index_build, lb_index_build_plain, lb_index_entries, lb_probe, lb_translate,
        lb_translate_plain,
    )

    # K9 over each family's pass-1 batch of the services phase: v4
    # 1 048 576 flows x 1 024 frontends, v6 x 256. lb_translate is the
    # whole call (index build + probe, as the main path makes it), its
    # bound the bytes the function needs: the flows in and the results
    # out once and the tables once. lb_index_build is the build entry
    # alone, its bound the frontend keys read and the index written. The
    # compares a first-match scan makes on these flows (lb_scan_ops,
    # the first version's work) are printed beside them
    for fam in (4, 6):
        q = svc["seqs"][fam]
        tabs, flows = lb_inputs(svc["pipe"], fam, q["pb"], *q["batch"][1:])
        k_out = lb_translate(tabs, *flows)
        p_out = lb_translate_plain(tabs, *flows)
        err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
        ops = lb_scan_ops(tabs, *flows[:3])
        tab_t = [getattr(tabs, f.name) for f in dataclasses.fields(tabs)]
        b_ms, b_by = bound(nbytes(*tab_t, *flows, *k_out), 0)
        f_n, length = tabs.fe_bytes.shape
        index = lb_index_build(tabs)
        i_err = max_abs_err(lb_index_entries(index), lb_index_entries(lb_index_build_plain(tabs)))
        i_ms, i_by = bound(nbytes(tabs.fe_bytes, tabs.fe_port, tabs.fe_proto, index), 0)
        row("lb_index_build", "cilium_tpu_torch/csrc/lb_translate.cu",
            "cilium_tpu/lb/device.py:51", i_err, lambda tabs=tabs: lb_index_build(tabs),
            lambda tabs=tabs: lb_index_build_plain(tabs), i_ms, i_by,
            f"v{fam}: {f_n} frontends (L {length}) into {index.shape[0]} slots, "
            f"{int((index >= 0).sum())} distinct keys", plain_iters=2, reps=5, graph=True)
        row("lb_translate", "cilium_tpu_torch/csrc/lb_translate.cu", "cilium_tpu/lb/device.py:51",
            err, lambda tabs=tabs, flows=flows: lb_translate(tabs, *flows),
            lambda tabs=tabs, flows=flows: lb_translate_plain(tabs, *flows), b_ms, b_by,
            f"v{fam}: {BATCH} flows x {f_n} frontends (L {length}), {tabs.be_port.shape[0]} "
            f"backends, both entries; the first version's scan made {ops} compares "
            f"({ops / INT32_OPS_PER_S * 1e3!r} ms at {INT32_OPS_PER_S:.4g} int32 op/s)",
            plain_iters=2, reps=5, graph=True)
        # the probe entry alone over the built index
        if max(max_abs_err(a, b) for a, b in zip(lb_probe(tabs, index, *flows), p_out)):
            fail(f"K9 lb_translate v{fam}: the probe over a built index differs")
        pr_ms = graph_ms(lambda tabs=tabs, index=index, flows=flows: lb_probe(tabs, index, *flows))
        print(f"K9 v{fam} split (CUDA graph): the probe entry alone {median(pr_ms)!r} {pr_ms} ms "
              f"over a built index; the build is the lb_index_build row [{card}]", flush=True)


def ct_step_rows(dct, dev, row) -> None:
    """The K10 rows: ``row(...)`` for each family and table fill."""
    # K10 ct_step, both entries, as process_flows_ct calls them (the
    # verdict tail included), on each family's pass-1 inputs over a fresh
    # table (insert-heavy: every call advances the clock past the TCP
    # lifetime, so each finds every slot expired) and on its pass-2 inputs
    # over the table pass 2 saw (hit-heavy: after the first call the table
    # no longer changes). Bound: bytes, from the sectors this run's
    # windows need (ct_step_bytes)
    from cilium_tpu_torch.datapath.device_ct import LIFE_TCP_S, ct_step_verdict, ct_step_verdict_plain
    from cilium_tpu_torch.datapath.device_ct import make_state as ct_make_state

    for fam in (4, 6):
        a1, a2 = dct["args"][fam]
        for kind, base, a in (("insert-heavy", None, a1), ("hit-heavy", dct["hit_state"][fam], a2)):
            _st, ka_w, kb_w, kc_w, proto_t, now0, *tail = a
            words = (*ka_w, *kb_w, *kc_w)
            start = ct_make_state(CT_BITS, device=dev) if base is None else base
            st_k, st_p = ct_clone(start), ct_clone(start)
            k_out = ct_step_verdict(st_k, ka_w, kb_w, kc_w, proto_t, now0, *tail)
            p_out = ct_step_verdict_plain(st_p, ka_w, kb_w, kc_w, proto_t, now0, *tail)
            err = max([max_abs_err(x, y) for x, y in zip(k_out, p_out)] + [ct_state_err(st_k, st_p)])
            need = ct_step_bytes(start, st_k, words, now0, proto_t.shape[0], tail[-1])
            b_bytes = min(need["arrays"][0], need["record"][0])
            b_ms, b_by = bound(b_bytes, 0)
            step = [0]

            def now_of():
                step[0] += 1
                return now0 + step[0] * (LIFE_TCP_S + 1) if base is None else now0

            row("ct_step", "cilium_tpu_torch/csrc/ct_step.cu",
                "cilium_tpu/datapath/device_ct.py:166", err,
                lambda st=st_k, t=tail, nf=now_of: ct_step_verdict(st, ka_w, kb_w, kc_w, proto_t,
                                                                    nf(), *t),
                lambda st=st_p, t=tail, nf=now_of: ct_step_verdict_plain(st, ka_w, kb_w, kc_w,
                                                                         proto_t, nf(), *t),
                b_ms, b_by, f"v{fam} {kind}: {proto_t.shape[0]} flows, {1 << CT_BITS} slots, "
                f"{int(k_out[3].sum())} established, both entries + verdict tail; bytes needed "
                f"(distinct sectors / if no two windows shared a sector): record layout "
                f"{need['record'][0]} / {need['record'][1]}, the first version's seven arrays "
                f"{need['arrays'][0]} / {need['arrays'][1]} "
                f"({need['arrays'][0] / HBM_BYTES_PER_S * 1e3!r} ms); bound the lesser",
                plain_iters=2, reps=5)


def edge_checks6(dev) -> None:
    """K11 shed_walk, both entries, against its plain versions, exact,
    on shapes and values the main path does not reach: B = 0, 1, 31 and
    4 097; every dport of -1, 0, 1023, 1024, 32767, 32768, 65535 with
    every proto of 0, 6, 17, 255; the flat 16+16 and the 16-8-8 v4
    tries; trie values past the table's rows (which shed nothing); v6
    over an elided trie and one with no elision, with bytes outside
    [0, 255]."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.lpm import build_trie_elided, build_wide_trie
    from cilium_tpu_torch.ops.shed import (
        shed_walk_stride8, shed_walk_stride8_plain, shed_walk_wide, shed_walk_wide_plain,
    )

    rs = np.random.default_rng(6006)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dports = np.array([-1, 0, 1023, 1024, 32767, 32768, 65535], np.int32)
    protos = np.array([0, 6, 17, 255], np.int32)
    n_rows, world_row = 40, 3
    tab = t((rs.random((n_rows, 9)) < 0.6).astype(np.uint8))

    def classes(b):
        grid = np.stack(np.meshgrid(dports, protos), -1).reshape(-1, 2)
        pick = grid[np.arange(b) % len(grid)] if b >= len(grid) else grid[rs.integers(0, len(grid), b)]
        return t(pick[:, 0].copy()), t(pick[:, 1].copy())

    flat = [("0.0.0.0/8", 1)] + [(f"10.{j}.{k}.0/24", (j * 7 + k) % 60) for j in range(40)
                                 for k in range(0, 256, 16)]
    deep = [("0.0.0.0/0", 1), ("10.0.0.0/8", 2)]
    for j in range(129):
        for _ in range(4):
            a = ((100 << 24) | (j << 16)) | int(rs.integers(0, 1 << 16))
            deep.append((str(ipaddress.ip_network((a, int(rs.choice([17, 24, 32]))),
                                                  strict=False)), len(deep) % 60))
    for name, prefixes, top in (("flat", flat, 10), ("16-8-8", deep, 100)):
        tries = [t(a) for a in build_wide_trie(prefixes)]
        if (tries[3].shape[-1] == 65536) != (name == "flat"):
            fail(f"shed_walk edge checks: the {name} prefixes built the other layout")
        for b in (0, 1, 31, 4097):
            addr = t(((top << 24) | rs.integers(0, 1 << 24, b)).astype(np.uint32).view(np.int32))
            dp, pr = classes(b)
            got = shed_walk_wide(*tries, tab, world_row, addr, dp, pr)
            want = shed_walk_wide_plain(*tries, tab, world_row, addr, dp, pr)
            if max_abs_err(got, want):
                fail(f"shed_walk_wide disagrees on the {name} trie at B = {b}")
            if b == 4097 and not (want.any() and not want.all()):
                fail(f"shed_walk_wide edge checks: the {name} trie sheds all or nothing")
    v6 = [(f"fd00::{j:x}:0/112", (j * 5) % 60) for j in range(300)]
    for name, prefixes, k_want in (("elided", v6, True), ("no elision", v6 + [("2000::/3", 59)], False)):
        child, info, common = build_trie_elided(prefixes)
        if (common.shape[0] > 0) != k_want:
            fail(f"shed_walk edge checks: the {name} v6 trie has K {common.shape[0]}")
        tries = [t(child), t(info), t(common)]
        for b in (0, 1, 31, 4097):
            addr = np.zeros((b, 16), np.int32)
            addr[:, 0] = 0xFD
            addr[:, 13] = rs.integers(0, 2, b)
            addr[:, 15] = rs.integers(0, 256, b)
            addr[rs.random(b) < 0.1, 0] = 0x20
            addr[rs.random((b, 16)) < 0.03] = rs.choice(np.array([-1, 256, 1 << 20], np.int32))
            dp, pr = classes(b)
            got = shed_walk_stride8(*tries, tab, world_row, t(addr), dp, pr, 16)
            want = shed_walk_stride8_plain(*tries, tab, world_row, t(addr), dp, pr, 16)
            if max_abs_err(got, want):
                fail(f"shed_walk_stride8 disagrees on the {name} trie at B = {b}")
    torch.cuda.synchronize()


def edge_checks7(dev) -> None:
    """K12 ident_gather against its plain version on shapes the main path
    does not give it: ragged lane counts (0, 3, 4 097), one-word and
    2 500-word rows (more words than a block's cells), shard offsets,
    an empty shard, ids around and outside the shard; then a whole
    [96, 24] table row-sharded over a 2 x 2 grid of records on the card
    through ident_gather_rows == index_select, ids -1 and 96 all zero."""
    import numpy as np
    import torch

    from cilium_tpu_torch.datapath.placement import DeviceRecord, GridSharding
    from cilium_tpu_torch.ops.lookup import (
        ident_gather_rows, ident_gather_rows_plain, ident_gather_shard, shard_rows,
    )

    rs = np.random.default_rng(12)
    for rows, w, lo, b in ((96, 24, 0, 41), (48, 24, 48, 4097), (1, 1, 0, 3),
                           (300, 2500, 100, 77), (64, 7, 5, 0), (0, 5, 0, 9)):
        tab = torch.from_numpy(rs.integers(-2**31, 2**31 - 1, (rows, w)).astype(np.int32)).to(dev)
        src = torch.from_numpy(rs.integers(lo - 3, lo + rows + 3, b).astype(np.int32)).to(dev)
        k_out = ident_gather_shard(tab, src, lo)
        if k_out.shape != (b, w) or max_abs_err(k_out, ident_gather_rows_plain(tab, src, lo)):
            fail(f"ident_gather [{rows}, {w}] from row {lo}, {b} lanes: kernel != plain")
    full = torch.from_numpy(rs.integers(-2**31, 2**31 - 1, (96, 24)).astype(np.int32)).to(dev)
    grid = tuple(tuple(DeviceRecord(2 * r + k, 0, torch.device(dev)) for k in range(2))
                 for r in range(2))
    held = shard_rows(full, GridSharding(grid, ("ident", None)))
    src = torch.from_numpy(np.concatenate([rs.integers(0, 96, 1000), [-1, 96, 47, 48]])
                           .astype(np.int32)).to(dev)
    got = ident_gather_rows(held, src)
    if max_abs_err(got[:1000], full.index_select(0, src[:1000].long())) or got[1000:1002].any():
        fail("ident_gather_rows over a 2 x 2 grid differs from index_select")
    k12_multi_checks(dev)
    torch.cuda.synchronize()


K12_EDGE_W = (1, 18, 20, 288, 2500)  # row words: id_bits 18, sel_match 20, rule rows 288


def k12_multi_checks(dev) -> None:
    """K12's one launch over several shards of one device against its
    plain version and index_select: W in K12_EDGE_W; 1, 2 and 4 equal
    shards of a [96, W] table and a ragged 2-way split, each also with
    an empty shard listed; ids around the table, -1 and 96 among them;
    more shards than the kernel takes raise."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops.lookup import RowShard, ident_gather_shards, ident_gather_shards_plain

    rs = np.random.default_rng(13)
    n = 96
    ids = np.concatenate([rs.integers(-3, n + 3, 5000), [-1, n, 0, n - 1]]).astype(np.int32)
    src = torch.from_numpy(ids).to(dev)
    own = torch.from_numpy((ids >= 0) & (ids < n)).to(dev)
    for w in K12_EDGE_W:
        full = torch.from_numpy(rs.integers(-2**31, 2**31 - 1, (n, w)).astype(np.int32)).to(dev)
        ref = torch.where(own[:, None], full.index_select(0, src.long().clamp(0, n - 1)), 0)
        for cuts in ((0, n), (0, 48, n), (0, 33, n), (0, 24, 48, 72, n)):
            shards = [RowShard(lo, hi - lo, full[lo:hi]) for lo, hi in zip(cuts[:-1], cuts[1:])]
            for listed in (shards, shards + [RowShard(n, 0, full[n:])]):
                got = ident_gather_shards(listed, src)
                if max_abs_err(got, ident_gather_shards_plain(listed, src)) or max_abs_err(got, ref):
                    fail(f"ident_gather over {len(listed)} shards {cuts} of [{n}, {w}] != plain")
    try:
        ident_gather_shards([RowShard(0, n, full)] * (_kernels.IDENT_MAX_SHARDS + 1), src)
    except ValueError:
        pass
    else:
        fail("ident_gather took more shards than the kernel holds")


K4_EDGE_C = (288, 4064, 4096, 4128)  # bench columns; up to the columns staged once a block; past
K6_EDGE_W = (1, 15, 16, 17, 640, 4096)


def k4_edge_world(rs, n_rows: int, c: int, n_eps: int, shuffle: bool, dev):
    """A policymap laid out as the materializer lays it (endpoint-major:
    each endpoint's L3 column, then its L4 slots; the -1 padding last,
    port and proto 0), or with its columns shuffled; random allow and
    redirect words."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.lookup import PolicymapTables

    pad = int(rs.integers(1, 32))
    ep = np.sort(rs.integers(0, n_eps, c - pad)).astype(np.int32)
    l3 = np.r_[True, ep[1:] != ep[:-1]] | (rs.random(c - pad) < 0.1)
    port = np.where(l3, 0, rs.choice(np.array([80, 443, 8080], np.int32), c - pad))
    proto = np.where(l3, 0, rs.choice(np.array([6, 17], np.int32), c - pad))
    col = [np.r_[ep, np.full(pad, -1, np.int32)], np.r_[port, np.zeros(pad, np.int32)],
           np.r_[proto, np.zeros(pad, np.int32)], np.r_[l3, np.zeros(pad, bool)]]
    if shuffle:
        perm = rs.permutation(c)
        col = [a[perm] for a in col]
    bits = rs.integers(-2**31, 2**31, (n_rows, c // 16), dtype=np.int64).astype(np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in col]
    return PolicymapTables(col_ep=t[0].to(torch.int32), col_port=t[1].to(torch.int32),
                           col_proto=t[2].to(torch.int32), col_is_l3=t[3],
                           id_bits=torch.from_numpy(bits & bits // 3).to(dev))


def k4_edge_flows(rs, b: int, n_rows: int, n_eps: int, dev):
    """Flows whose rows run from -3 to N + 2 and endpoints from -2 to
    E + 2 (-1 selects the padding columns at port 0 / proto 0)."""
    import numpy as np
    import torch

    return [torch.from_numpy(a).to(dev) for a in (
        rs.integers(-3, n_rows + 3, b).astype(np.int32),
        rs.integers(-2, n_eps + 3, b).astype(np.int32),
        rs.choice(np.array([0, 80, 443, 22], np.int32), b),
        rs.choice(np.array([0, 6, 17], np.int32), b))]


def edge_checks8(dev) -> None:
    """K4 (both entries, both row modes) and K6 (one to three terms)
    against their plain versions, exactly:

    - K4 on materializer-laid (sorted col_ep) and shuffled columns at C
      in K4_EDGE_C (the bench's 288; 4 064 and 4 096, just under and at
      the columns a block stages once, and 4 128, one word past it: the
      chunked general path), flows with ep -1 and >= E, rows -3 to
      N + 2; B = 0, 1, 4 097 and a ragged 100 003 (20 003 past 288
      columns), with and without the prefilter mask, flow views one
      flow in (unaligned: no 16-byte loads), counters in shared memory
      (64 endpoints) and global (2 100), rule hits shared (300 rules)
      and global (40 000);
    - K4 over shard lists of 1, 2 and 4 shards of one table (a ragged
      split, and each with an empty shard listed), ids -1 and N, in
      direct and gathered mode, with and without attribution; a rule
      list over other row ranges raises;
    - K6 with 1, 2 and 3 terms at widths K6_EDGE_W, B = 0, 1, 777 and
      8 192, all-zero rows, NO_RULE entries and a mask view whose rows
      start off a 16-byte boundary."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.lookup import (
        RowShard, policymap_verdict, policymap_verdict_plain, policymap_verdict_shards,
        policymap_verdict_shards_plain,
    )
    from cilium_tpu_torch.ops.verdict import NO_RULE, first_rule_terms, first_rule_terms_plain

    rs = np.random.default_rng(8)

    def same(tag, got, want):
        for k, (g, w) in enumerate(zip(got, want)):
            if (g is None) != (w is None) or (g is not None and max_abs_err(g, w)):
                fail(f"policymap_verdict {tag}: output {k} differs from the plain version")

    n_rows = 2048
    for c in K4_EDGE_C:
        for shuffle in (False, True):
            pm = k4_edge_world(rs, n_rows, c, 64, shuffle, dev)
            for b in (0, 1, 4097, 100_003 if c == 288 else 20_003):
                fl = k4_edge_flows(rs, b, n_rows, 64, dev)
                denied = torch.from_numpy(rs.random(b) < 0.1).to(dev)
                tag = f"C {c} {'shuffled' if shuffle else 'sorted'} B {b}"
                for eps, n_rules in ((64, 300), (2100, 40_000)):
                    rule_tab = torch.from_numpy(np.where(
                        rs.random((n_rows, c)) < 0.7, rs.integers(0, n_rules + 50, (n_rows, c)),
                        -1).astype(np.int32)).to(dev)
                    for pf in (None, denied):
                        kw = dict(denied_pf=pf, ep_count=eps)
                        same(tag, policymap_verdict(pm, *fl, **kw),
                             policymap_verdict_plain(pm, *fl, **kw))
                        kw.update(rule_tab=rule_tab, n_rules=n_rules)
                        same(f"{tag} attrib", policymap_verdict(pm, *fl, **kw),
                             policymap_verdict_plain(pm, *fl, **kw))
                    if b > 1:  # views one flow in: no 16-byte flow loads
                        off = [x[1:] for x in fl]
                        same(f"{tag} unaligned", policymap_verdict(pm, *off, ep_count=eps),
                             policymap_verdict_plain(pm, *off, ep_count=eps))

    n = 96
    for c in (288, 4128):
        pm = k4_edge_world(rs, n, c, 12, False, dev)
        rule_tab = torch.from_numpy(rs.integers(-1, 500, (n, c)).astype(np.int32)).to(dev)
        fl = k4_edge_flows(rs, 5000, n, 12, dev)
        fl[0][:2] = torch.tensor([-1, n], dtype=torch.int32, device=dev)
        for cuts in ((0, n), (0, 48, n), (0, 33, n), (0, 24, 48, 72, n)):
            spans = list(zip(cuts[:-1], cuts[1:]))
            for empty in (False, True):
                bits = [RowShard(lo, hi - lo, pm.id_bits[lo:hi]) for lo, hi in spans]
                rules = [RowShard(lo, hi - lo, rule_tab[lo:hi]) for lo, hi in spans]
                if empty:
                    bits.append(RowShard(n, 0, pm.id_bits[n:]))
                    rules.append(RowShard(n, 0, rule_tab[n:]))
                for gathered in (False, True):
                    for rs_ in (None, rules):
                        kw = dict(ep_count=12, rule_shards=rs_, n_rules=500, gathered=gathered)
                        same(f"C {c} shards {cuts} empty {empty} gathered {gathered}",
                             policymap_verdict_shards(pm, bits, *fl, **kw),
                             policymap_verdict_shards_plain(pm, bits, *fl, **kw))
        try:
            policymap_verdict_shards(pm, [RowShard(0, 48, pm.id_bits[:48]),
                                          RowShard(48, 48, pm.id_bits[48:])], *fl,
                                     rule_shards=[RowShard(0, n, rule_tab)], n_rules=500)
        except ValueError:
            pass
        else:
            fail("policymap_verdict took rule_tab shards over other row ranges")

    for n_terms in (1, 2, 3):
        for b in (0, 1, 777, 8192):
            for w0 in K6_EDGE_W:
                widths = [w0, *rs.choice(K6_EDGE_W, n_terms - 1)]
                terms = []
                for w in widths:
                    mask = torch.from_numpy(rs.random((b, w)) < rs.choice([0.0, 0.003, 0.05])).to(dev)
                    if b > 3:
                        mask[b // 2] = False  # an all-zero row
                    rule_of = rs.integers(0, 10**6, w).astype(np.int32)
                    rule_of[rs.random(w) < 0.3] = NO_RULE
                    terms.append((mask, torch.from_numpy(rule_of).to(dev)))
                got, want = first_rule_terms(terms), first_rule_terms_plain(terms)
                if any(max_abs_err(g, x) for g, x in zip(got, want)):
                    fail(f"first_rule disagrees on {n_terms} terms of widths {widths}, B {b}")
    flat = torch.from_numpy(rs.random(1 + 777 * 640) < 0.01).to(dev)
    mask = flat[1:].view(777, 640)  # rows start one byte past a 16-byte boundary
    rule_of = torch.from_numpy(rs.integers(0, 10**6, 640).astype(np.int32)).to(dev)
    terms = [(mask, rule_of), (mask[:, :17].contiguous(), rule_of[:17])]
    if any(max_abs_err(g, x) for g, x in zip(first_rule_terms(terms), first_rule_terms_plain(terms))):
        fail("first_rule disagrees on a mask whose rows start off a 16-byte boundary")
    torch.cuda.synchronize()


# K7's edge tables: (Q, distinct columns, the fused walk's table route
# at DFA_SHARED_MIN_ROWS rows or more, the class walk's; None where
# class_table gives none): tables at DFA_SHARED_SMALL_Q states and one
# past it (shared at any row count; from DFA_SHARED_MIN_ROWS), the [Q, 256]
# table at the shared-memory budget and one state past it (256 classes
# save nothing), a class table under it, class tables at the budget's
# entries ([802, 128]) and one row past them, and the pattern-cap
# policy's Q 735 over 43 classes
K7_EDGE_TABLES = ((32, 32, "shared", "classes"), (33, 33, "shared", "classes"),
                  (400, 256, "shared", None), (401, 256, "l2", None),
                  (400, 100, "shared", "classes"), (801, 127, "l2", "classes"),
                  (802, 127, "l2", None), (735, 43, "l2", "classes"))


def k7_layout_cases():
    """K7's layout edges: (name, byte dtype, width, max_len, row offset,
    element offset, the route dfa_walk_route must give). Row strides of
    16 / 32 / 64 / 1 024 bytes take 16-byte vectors; 17, 20 and 24 bytes
    do not; a view one row in stays aligned when the row is, one
    element in never is."""
    import numpy as np

    return [
        ("u8 w16", np.uint8, 16, 16, 0, 0, "vector"),
        ("u8 w32 max_len 29", np.uint8, 32, 29, 0, 0, "vector"),
        ("u8 w17", np.uint8, 17, 17, 0, 0, "scalar"),
        ("u8 w20 max_len 17", np.uint8, 20, 17, 0, 0, "scalar"),
        ("u8 w16 one row in", np.uint8, 16, 16, 1, 0, "vector"),
        ("u8 w16 one element in", np.uint8, 16, 16, 0, 1, "scalar"),
        ("i32 w4", np.int32, 4, 4, 0, 0, "vector"),
        ("i32 w16 max_len 13", np.int32, 16, 13, 0, 0, "vector"),
        ("i32 w5", np.int32, 5, 5, 0, 0, "scalar"),
        ("i32 w6 max_len 5", np.int32, 6, 5, 0, 0, "scalar"),
        ("i32 w256", np.int32, 256, 256, 0, 0, "vector"),
        ("i32 w8 one row in", np.int32, 8, 8, 1, 0, "vector"),
        ("i32 w8 one element in", np.int32, 8, 8, 0, 1, "scalar"),
    ]


def strided_view(a, row_off: int, elem_off: int, dev):
    """``a`` ([B, W]) on ``dev`` as a contiguous view into a larger
    buffer, ``row_off`` rows and ``elem_off`` elements from its start."""
    import numpy as np
    import torch

    b, w = a.shape
    pad = np.zeros((row_off + b + 1) * w + elem_off, a.dtype)
    start = row_off * w + elem_off
    pad[start:start + b * w] = a.reshape(-1)
    buf = torch.from_numpy(pad).to(dev)
    view = buf[start:start + b * w].view(b, w)
    if not view.is_contiguous():
        fail("strided_view made a non-contiguous view")
    return view


def edge_checks9(dev) -> None:
    """K7 (both entries), K5 and K11's stride-8 entry against their plain
    versions, exactly, on the layouts that choose their paths, and each
    launch's route against the one the case names:

    - K7 on the synthetic tables of K7_EDGE_TABLES: Q = DFA_SMEM_MAX_Q
      (the shared-memory table) and one state past it (L1 / L2), class
      tables at the shared-memory entries and one row past them, the
      pattern-cap policy's Q 735 over 43 classes; a few entries outside
      [0, Q) (the sink state); uint8 and int32 bytes over every
      k7_layout_cases() layout, lengths -1, 0 and each one at, one
      under and one past every 16-byte chunk's end and past max_len,
      starts outside [0, Q); B = 1, 33 and 300 000 (several rows a
      thread of the persistent grid; the only B at which a [Q + 1, 256]
      table is copied to shared memory); each table through both entries
      and, where its classes fit, dfa_match_batch_classes; the C entry
      refuses a shared or class table past the budget, a class route
      with no class map and vector bytes on a misaligned row;
    - K5 at strides 16 and 20 (vector), 17 and 5 (scalar), levels 4 and
      16, a view one element in (scalar) and one row in (vector), K 0,
      13 and 16, bytes outside [0, 255] in the compared part and in the
      walked part; K11's stride-8 entry on the vector and scalar
      routes; the C entries refuse a vector walk on a misaligned row."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops import dfa as dfamod
    from cilium_tpu_torch.ops import lpm as lpmmod
    from cilium_tpu_torch.ops.dfa import (
        DFA_SHARED_MIN_ROWS, DFA_SHARED_SMALL_Q, DFA_SMEM_MAX_Q, class_table, dfa_match_batch,
        dfa_match_batch_classes, dfa_match_batch_fused, dfa_walk_plain,
    )
    from cilium_tpu_torch.ops.lpm import build_trie, elided_lookup, lpm_stride8_plain
    from cilium_tpu_torch.ops.shed import shed_walk_stride8, shed_walk_stride8_plain

    rs = np.random.default_rng(9009)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for q, n_cols, tab_fused, tab_classes in K7_EDGE_TABLES:
        # a table over n_cols distinct columns: n_cols byte classes
        base = rs.integers(0, q, (q, n_cols)).astype(np.int32)
        base[rs.random(base.shape) < 0.0005] = rs.choice(
            np.array([-1, q, q + 7, 65535, 65536 + 3, 1 << 30], np.int32))
        trans = base[:, rs.permutation(np.arange(256) % n_cols)]
        cls = class_table(trans)
        if (cls is not None) != (tab_classes == "classes"):
            fail(f"class_table at Q {q} over {n_cols} columns: {cls is not None}")
        lo, hi = (t(rs.integers(-2**31, 2**31, q).astype(np.int32)) for _ in range(2))
        tr = t(trans)
        bc, ct = (t(a) for a in cls) if cls is not None else (None, None)
        for name, dtype, width, max_len, row_off, elem_off, want in k7_layout_cases():
            for b in (1, 33, 300_000 if name == "u8 w16" else 4_099):
                sb = rs.integers(0, 256, (b, width)).astype(dtype)
                if dtype == np.int32:
                    sb[rs.random(sb.shape) < 0.001] = rs.choice(np.array([-1, 256, 1 << 20], np.int32))
                ch = 16 // np.dtype(dtype).itemsize
                edges = [-1, 0, max_len, max_len + 1] + [
                    c * ch + d for c in range(1, max_len // ch + 1) for d in (-1, 0, 1)]
                lens = np.array(edges, np.int32)[np.arange(b) % len(edges)]
                lens = np.where(rs.random(b) < 0.5, lens, rs.integers(-1, max_len + 3, b)).astype(np.int32)
                starts = rs.integers(0, q, b).astype(np.int32)
                starts[rs.random(b) < 0.01] = rs.choice(np.array([-1, q, q + 100], np.int32))
                view = strided_view(sb, row_off, elem_off, dev)
                args = (lo, hi, t(starts), view, t(lens), max_len)
                ref = dfa_walk_plain(tr, *args)
                st = torch.tensor(int(starts[0]), dtype=torch.int32, device=dev)
                calls = [("dfa_walk_fused", tab_fused, lambda: dfa_match_batch_fused(tr, *args), ref),
                         ("dfa_walk", tab_fused, lambda: dfa_match_batch(tr, lo, hi, st, *args[3:]),
                          dfa_walk_plain(tr, lo, hi, st.expand(b), *args[3:]))]
                if cls is not None:
                    calls.append(("dfa_walk_fused", "classes",
                                  lambda: dfa_match_batch_classes(tr, bc, ct, *args), ref))
                for kname, table, call, want_out in calls:
                    if table == "shared" and b < DFA_SHARED_MIN_ROWS and q > DFA_SHARED_SMALL_Q:
                        table = "l2"  # the copy of a [Q + 1, 256] table does not pay
                    got = call()
                    if any(max_abs_err(g, w) for g, w in zip(got, want_out)):
                        fail(f"{kname} ({table}) disagrees at Q {q}, {n_cols} columns, {name}, "
                             f"B = {b}")
                    if dfamod.WALK_ROUTES[kname] != (table, want):
                        fail(f"{kname} took route {dfamod.WALK_ROUTES[kname]} at Q {q}, {n_cols} "
                             f"columns, {name}; expected {(table, want)}")
    # the C entry refuses a route its inputs do not allow
    k7 = _kernels.KERNELS["dfa_walk_fused"]
    tr = t(rs.integers(0, DFA_SMEM_MAX_Q + 1, (DFA_SMEM_MAX_Q + 1, 256)).astype(np.int32))
    acc = t(np.zeros(DFA_SMEM_MAX_Q + 1, np.int32))
    b = 64
    st, ln = t(np.zeros(b, np.int32)), t(np.full(b, 16, np.int32))
    out_lo, out_hi = (torch.empty(b, dtype=torch.int32, device=dev) for _ in range(2))
    aligned = t(np.zeros((b, 16), np.uint8))
    odd = strided_view(np.zeros((b, 16), np.uint8), 0, 1, dev)
    cmap = t(np.zeros(256, np.uint8))
    ctab = t(np.zeros((DFA_SMEM_MAX_Q + 2, 256), np.int16))
    for what, q, bytes_, table, vec, cls, n_cls in (
        ("a shared table past the budget", DFA_SMEM_MAX_Q + 1, aligned, 1, 0, None, 0),
        ("a class table past the budget", DFA_SMEM_MAX_Q + 1, aligned, 2, 0, cmap, 256),
        ("a class table wider than the table", 64, aligned, 2, 0, cmap, 264),
        ("a class table with no class map", DFA_SMEM_MAX_Q + 1, aligned, 2, 0, None, 8),
        ("vector bytes on a misaligned row", DFA_SMEM_MAX_Q, odd, 0, 1, None, 0),
        ("vector bytes on a 17-byte row", DFA_SMEM_MAX_Q,
         t(np.zeros((b, 17), np.uint8)), 0, 1, None, 0),
    ):
        before = k7.launches
        try:
            k7.launch(dev, tr.data_ptr(), q, acc.data_ptr(), acc.data_ptr(), st.data_ptr(), 1,
                      bytes_.data_ptr(), 1, bytes_.shape[1], 16, ln.data_ptr(), out_lo.data_ptr(),
                      out_hi.data_ptr(), b, table, vec, None if cls is None else cls.data_ptr(),
                      ctab.data_ptr(), n_cls)
        except RuntimeError:
            pass
        else:
            fail(f"the dfa_walk C entry took {what}")
        if k7.launches != before:
            fail("a refused dfa_walk launch was counted")

    # K5 and K11's stride-8 entry
    prefixes = [("::/0", 1)] + [
        (str(ipaddress.ip_network((int(ipaddress.ip_address("fd00::")) + int(rs.integers(0, 1 << 40)),
                                   int(rs.choice([64, 100, 120, 128]))), strict=False)), j + 2)
        for j in range(2000)]
    c6, i6 = build_trie(prefixes, ipv6=True)
    c4, i4 = build_trie([("0.0.0.0/0", 1)] + [
        (f"10.{j % 256}.{(j * 7) % 256}.0/{int(rs.choice([16, 24, 28, 32]))}", j + 2)
        for j in range(1500)])
    shed_tab = t((rs.random((4100, 9)) < 0.5).astype(np.uint8))

    def addresses(b, levels, width, k, common):
        a = np.zeros((b, width), np.int32)
        a[:, :k] = common
        a[:, k:levels] = rs.integers(0, 256, (b, levels - k))
        if levels == 16:
            a[:, 0], a[:, 1] = 0xFD, 0
        a[:, levels:] = rs.integers(-5, 300, (b, width - levels))  # never read
        a[rs.random(b) < 0.2, :k] = 7 if k else 0  # differs in the compared part
        cmp = rs.random(a.shape) < 0.01
        cmp[:, k:] = False
        a[cmp] = rs.choice(np.array([-1, 256, 1 << 20], np.int32), int(cmp.sum()))
        walk = rs.random(a.shape) < 0.02
        walk[:, :k] = False
        walk[:, levels:] = False
        a[walk] = rs.choice(np.array([-1, 256, 1 << 20], np.int32), int(walk.sum()))
        return a

    for levels, width, k, row_off, elem_off, want in (
        (16, 16, 0, 0, 0, "vector"), (16, 16, 13, 0, 0, "vector"), (16, 16, 16, 0, 0, "vector"),
        (16, 20, 13, 0, 0, "vector"), (16, 17, 13, 0, 0, "scalar"), (16, 17, 0, 0, 0, "scalar"),
        (16, 16, 13, 1, 0, "vector"), (16, 16, 13, 0, 1, "scalar"), (16, 16, 0, 0, 1, "scalar"),
        (4, 5, 0, 0, 0, "scalar"), (4, 4, 0, 0, 0, "vector"), (4, 4, 2, 0, 1, "scalar"),
    ):
        common = np.array(list(bytes.fromhex("fd00") + bytes(14)), np.int32)[:k] if levels == 16 \
            else np.array([10, 3, 0, 0], np.int32)[:k]
        if levels == 16:
            child, info = c6, i6
        else:
            child, info = c4, i4
        tabs = [t(child), t(info), t(common)]
        for b in (1, 33, 20_003):
            a = addresses(b, levels, width, k, common)
            view = strided_view(a, row_off, elem_off, dev)
            got = elided_lookup(*tabs, view, levels)
            if max_abs_err(got, lpm_stride8_plain(*tabs, view, levels)):
                fail(f"lpm_stride8 disagrees at levels {levels}, width {width}, K {k}, "
                     f"offset {row_off} rows {elem_off} elements, B = {b}")
            if lpmmod.STRIDE8_ROUTES["lpm_stride8"] != want:
                fail(f"lpm_stride8 took route {lpmmod.STRIDE8_ROUTES['lpm_stride8']} at width "
                     f"{width}, offset {row_off} / {elem_off}; expected {want}")
            if b == 20_003 and k < levels and not bool((got > 0).any()):
                fail(f"lpm_stride8 edge case width {width}, K {k} matched nothing")
            if levels == 16:
                dp = t(rs.integers(0, 65536, b).astype(np.int32))
                pr = t(rs.choice(np.array([0, 6, 17], np.int32), b))
                got = shed_walk_stride8(*tabs, shed_tab, 5, view, dp, pr, levels)
                want_s = shed_walk_stride8_plain(*tabs, shed_tab, 5, view, dp, pr, levels)
                if max_abs_err(got, want_s):
                    fail(f"shed_walk_stride8 disagrees at width {width}, K {k}, offset "
                         f"{row_off} / {elem_off}, B = {b}")
                if lpmmod.STRIDE8_ROUTES["shed_walk_stride8"] != want:
                    fail(f"shed_walk_stride8 took route {lpmmod.STRIDE8_ROUTES['shed_walk_stride8']}"
                         f" at width {width}, offset {row_off} / {elem_off}; expected {want}")
    odd = strided_view(np.zeros((64, 16), np.int32), 0, 1, dev)
    tabs = [t(c6), t(i6), t(np.zeros(0, np.int32))]
    out = torch.empty(64, dtype=torch.int32, device=dev)
    for what, view, levels in (("a misaligned row", odd, 16),
                               ("a 17-element row", t(np.zeros((64, 17), np.int32)), 16)):
        try:
            _kernels.KERNELS["lpm_stride8"].launch(
                dev, tabs[0].data_ptr(), tabs[1].data_ptr(), c6.shape[0], tabs[2].data_ptr(), 0,
                view.data_ptr(), view.shape[1], levels, out.data_ptr(), 64, 1)
        except RuntimeError:
            pass
        else:
            fail(f"the lpm_stride8 C entry took a vector walk on {what}")
    torch.cuda.synchronize()


# K3's batch sizes: empty, one address, ragged against 4 and 256
K3_EDGE_B = (0, 1, 3, 4, 5, 1023, 1025, 200_003)


def k3_edge_trie(rs, layout: str):
    """Wide-trie arrays of one layout (flat 16+16: 6 deep /16s; 16-8-8:
    129), with root_child and sub_child entries outside [1, M)."""
    import numpy as np

    from cilium_tpu_torch.ops.lpm import build_wide_trie

    prefixes = [("0.0.0.0/0", 1), ("10.0.0.0/8", 2), ("100.0.0.0/8", 3)]
    for j in range(129 if layout == "16-8-8" else 6):
        for _ in range(4):
            addr = ((100 << 24) | (j << 16)) | int(rs.integers(0, 1 << 16))
            plen = int(rs.choice([17, 20, 24, 28, 32]))
            prefixes.append((str(ipaddress.ip_network((addr, plen), strict=False)), len(prefixes) + 1))
    ri, rc, sc, si = (np.array(a) for a in build_wide_trie(prefixes))
    if (si.shape[-1] == 65536) != (layout == "flat"):
        fail(f"the K3 edge trie did not build the {layout} layout")
    m = si.shape[0]
    rc[np.nonzero(rc)[0][:3]] = [m, m + 3, -1]
    rc[(100 << 8) | 200] = -7
    if layout == "16-8-8":
        live = np.nonzero(sc)
        pick = rs.choice(live[0].shape[0], 6, replace=False)
        sc[live[0][pick], live[1][pick]] = [m, m + 1, m + 9, -1, -2, 0]
    return ri, rc, sc, si


def k1_edge_case(rs, n: int, w: int, s: int, cps: int):
    """K1 inputs: identity rows of a few labels; conjuncts of one to
    three required labels of a row (so some match), some with a
    forbidden label; in fixed shares invalid, req_count 0 with no forbid
    (every row), forbid-only, every word nonzero (bit 0 of each word,
    which row 0 holds everywhere), and a req_count one off."""
    import numpy as np

    ids = np.zeros((max(n, 1), w), np.uint32)
    for r in range(ids.shape[0]):
        for b in rs.choice(32 * w, min(32 * w, 6), replace=False):
            ids[r, b // 32] |= np.uint32(1 << (b % 32))
    ids[0] |= np.uint32(1)
    req = np.zeros((s, cps, w), np.uint32)
    forbid = np.zeros((s, cps, w), np.uint32)
    kind = rs.choice(6, (s, cps), p=[0.55, 0.1, 0.1, 0.1, 0.1, 0.05])
    for si in range(s):
        for ci in range(cps):
            src = ids[rs.integers(0, ids.shape[0])]
            bits = np.nonzero(np.unpackbits(src.view(np.uint8), bitorder="little"))[0]
            if kind[si, ci] in (0, 1, 5):
                for b in rs.choice(bits, min(bits.size, int(rs.integers(1, 4))), replace=False):
                    req[si, ci, b // 32] |= np.uint32(1 << (b % 32))
            if kind[si, ci] in (0, 3) and rs.random() < 0.6:
                b = int(rs.integers(0, 32 * w))
                forbid[si, ci, b // 32] |= np.uint32(1 << (b % 32))
            if kind[si, ci] == 4:
                req[si, ci] = 1
    count = np.unpackbits(req.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int32)
    count[kind == 5] += 1
    return (ids[:n].view(np.int32), req.view(np.int32), forbid.view(np.int32), kind != 1, count)


def edge_checks10(dev) -> None:
    """K3 and K1 against their plain versions, exactly, on the shapes and
    layouts the main paths do not reach, and K1's launches against the
    route each case names:

    - K3 on both layouts (flat 16+16 and 16-8-8) with node ids outside
      [1, M), at B of K3_EDGE_B and on views one to four elements into
      a buffer;
    - K1 at W 1 / 34 / 300 (staged) and 800 (wide), S 1 / 31 / 33 /
      640, CPS 1 / 3 with invalid, req_count-0, forbid-only, dense and
      one-off conjuncts, N 0 / 1 / 129 / 2 048, W = 0, and rows and
      conjuncts off a 16-byte boundary (the kernel's 4-byte copies); the
      C entry refuses a staged route past the budget and shapes an entry
      cannot pack."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops import bitmap as bitmod
    from cilium_tpu_torch.ops.bitmap import compute_selector_matches, selector_match_plain
    from cilium_tpu_torch.ops.lpm import lpm_lookup_wide, lpm_wide_plain

    rs = np.random.default_rng(1010)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for layout in ("flat", "16-8-8"):
        tabs = [t(a) for a in k3_edge_trie(rs, layout)]
        for b in K3_EDGE_B:
            a = ((100 << 24) | (rs.integers(0, 8, b) << 16) | rs.integers(0, 1 << 16, b))
            a = np.where(rs.random(b) < 0.2, rs.integers(0, 1 << 32, b), a).astype(np.uint32)
            for elems_in in range(5):
                view = strided_view(a.view(np.int32).reshape(-1, 1), 0, elems_in, dev).reshape(-1)
                got = lpm_lookup_wide(*tabs, view)
                if max_abs_err(got, lpm_wide_plain(*tabs, view)):
                    fail(f"lpm_wide disagrees on the {layout} layout at B = {b}, {elems_in} "
                         f"elements in")
                if b > 1000 and not bool((got > 3).any()):
                    fail(f"lpm_wide edge case {layout}, B = {b} matched no deep prefix")

    def k1(case, offs=(0, 0)):
        ids, req, fb, valid, count = case
        n, w = ids.shape
        s, cps, _ = req.shape
        args = (strided_view(ids, 0, offs[0], dev),
                strided_view(req.reshape(s * cps, w), 0, offs[1], dev).view(s, cps, w),
                strided_view(fb.reshape(s * cps, w), 0, offs[1], dev).view(s, cps, w),
                t(valid), t(count))
        got = compute_selector_matches(*args)
        want = selector_match_plain(*args)
        if max_abs_err(got, want):
            fail(f"selector_match disagrees at N {n}, W {w}, S {s}, CPS {cps}, offsets {offs}")
        route = "wide" if w == 800 else "staged"
        if (n and s) and bitmod.SELECTOR_ROUTES["selector_match"] != route:
            fail(f"selector_match took route {bitmod.SELECTOR_ROUTES['selector_match']} at W {w}; "
                 f"expected {route}")
        return want

    for w, s, cps, n in ((1, 1, 1, 129), (1, 640, 3, 129), (34, 31, 1, 129), (34, 33, 3, 129),
                         (34, 640, 1, 2048), (34, 640, 3, 129), (300, 33, 3, 129),
                         (300, 640, 1, 129), (800, 64, 3, 129), (800, 33, 1, 1), (34, 33, 3, 0),
                         (34, 0, 1, 129), (34, 45, 0, 77)):
        want = k1(k1_edge_case(rs, n, w, s, cps))
        if n > 100 and s >= 31 and cps:
            bits = torch.stack([(want >> k) & 1 for k in range(32)], -1).reshape(n, -1)[:, :s]
            share = float(bits.float().mean())
            if not 0 < share < 1:
                fail(f"selector_match edge case W {w}, S {s}, CPS {cps} matched a share {share}")
    for offs in ((1, 0), (0, 1), (3, 2)):
        k1(k1_edge_case(rs, 129, 34, 70, 3), offs)
    k1(k1_edge_case(rs, 129, 300, 33, 1), (1, 3))
    # W = 0: no label words; a valid req_count-0 conjunct matches every row
    empty = (t(np.zeros((5, 0), np.int32)), t(np.zeros((40, 2, 0), np.int32)),
             t(np.zeros((40, 2, 0), np.int32)), t(rs.random((40, 2)) < 0.5),
             t(rs.integers(0, 2, (40, 2)).astype(np.int32)))
    if max_abs_err(compute_selector_matches(*empty), selector_match_plain(*empty)):
        fail("selector_match disagrees at W = 0")
    k1k = _kernels.KERNELS["selector_match"]
    ids, req, fb, valid, count = (t(x) for x in k1_edge_case(rs, 64, 800, 40, 1))
    out = torch.empty((64, 2), dtype=torch.int32, device=dev)
    for what, w, cps in (("a staged route past the budget", 800, 1),
                         ("W past 65 535", 65536, 1), ("CPS past 1 023", 34, 1024)):
        before = k1k.launches
        try:
            k1k.launch(dev, ids.data_ptr(), req.data_ptr(), fb.data_ptr(), valid.data_ptr(),
                       count.data_ptr(), out.data_ptr(), 64, w, 40, cps, 1)
        except RuntimeError:
            pass
        else:
            fail(f"the selector_match C entry took {what}")
        if k1k.launches != before:
            fail("a refused selector_match launch was counted")
    torch.cuda.synchronize()


def k8_edge_tables(rs):
    """K8's edge tables: (name, pair [Q, 257 * 257], the single-step
    table it was composed from or None, accept [Q] uint64, whether that
    table's byte classes fit K7's class route).

    - "edge automata": three fields of random patterns fused with
      fuse_dfas (its pair table and byte classes);
    - "Q 126, 40 columns": a synthetic [126, 256] table over 40 distinct
      columns and its pair table: a [127, 48] class table;
    - "Q 126, 256 columns": one whose 256 columns all differ, so that
      its classes do not fit (256 classes and the sink's column) and the
      L7 walk takes its pair table at every rung;
    - "hand-made": a [40, 257 * 257] pair table that _pair_table did not
      build (no single-step table, no classes), drawn as a [40, 9, 11]
      table through random maps of both positions, a few entries
      outside [0, Q) (-1, Q, Q + 5, 65 535) among them."""
    import numpy as np

    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import PAIR_ALPHA, _pair_table, fuse_dfas

    rng = random.Random(1111)
    atoms = ["a", "b", "/", "[a-z]", "[0-9]", ".", "x+", "b*", "(ab|ba)", "c?", "[^a]"]

    def pats(n):
        return ["".join(rng.choice(atoms) for _ in range(rng.randrange(1, 6))) for _ in range(n)]

    fused = fuse_dfas([compile_patterns(pats(rng.randrange(2, 8))) for _ in range(3)])
    if fused.pair is None:
        fail("the K8 edge automata are too large for a pair table")
    out = [("edge automata", fused.pair, fused.trans, fused.accept, True)]
    q = 126
    for n_cols, fits in ((40, True), (256, False)):
        base = rs.integers(0, q, (q, n_cols)).astype(np.int32)
        trans = np.ascontiguousarray(base[:, rs.permutation(np.arange(256) % n_cols)])
        out.append((f"Q 126, {n_cols} columns", _pair_table(trans), trans,
                    rs.integers(0, 1 << 63, q, dtype=np.uint64), fits))
    q = 40
    small = rs.integers(0, q, (q, 9, 11)).astype(np.int32)
    small[rs.random(small.shape) < 0.01] = rs.choice(np.array([-1, q, q + 5, 65535], np.int32))
    m0, m1 = (rs.permutation(np.arange(PAIR_ALPHA) % n) for n in (9, 11))
    pair = np.ascontiguousarray(small[:, m0][:, :, m1].reshape(q, -1))
    out.append(("hand-made", pair, None, rs.integers(0, 1 << 63, q, dtype=np.uint64), False))
    return out


# K8's row layouts: (name, byte dtype, width, max_len, row offset, element
# offset, bytes route); odd and even max_len from 0 to 256, rows wider
# than max_len
K8_LAYOUTS = [
    ("u8 w16 max_len 0", "uint8", 16, 0, 0, 0, "vector"),
    ("u8 w16 max_len 1", "uint8", 16, 1, 0, 0, "vector"),
    ("u8 w16 max_len 15", "uint8", 16, 15, 0, 0, "vector"),
    ("u8 w32 max_len 16", "uint8", 32, 16, 0, 0, "vector"),
    ("u8 w32 max_len 17", "uint8", 32, 17, 0, 0, "vector"),
    ("u8 w33 max_len 33", "uint8", 33, 33, 0, 0, "scalar"),
    ("u8 w64 max_len 63", "uint8", 64, 63, 0, 0, "vector"),
    ("u8 w128 max_len 128", "uint8", 128, 128, 0, 0, "vector"),
    ("u8 w256 max_len 255", "uint8", 256, 255, 0, 0, "vector"),
    ("u8 w256 max_len 256", "uint8", 256, 256, 0, 0, "vector"),
    ("u8 w20 max_len 18 one row in", "uint8", 20, 18, 1, 0, "scalar"),
    ("u8 w16 max_len 16 one row in", "uint8", 16, 16, 1, 0, "vector"),
    ("u8 w16 max_len 16 one element in", "uint8", 16, 16, 0, 1, "scalar"),
    ("i32 w4 max_len 3", "int32", 4, 3, 0, 0, "vector"),
    ("i32 w8 max_len 8", "int32", 8, 8, 0, 0, "vector"),
    ("i32 w7 max_len 7", "int32", 7, 7, 0, 0, "scalar"),
    ("i32 w20 max_len 17", "int32", 20, 17, 0, 0, "vector"),
    ("i32 w256 max_len 256", "int32", 256, 256, 0, 0, "vector"),
    ("i32 w8 max_len 5 one row in", "int32", 8, 5, 1, 0, "vector"),
    ("i32 w8 max_len 8 one element in", "int32", 8, 8, 0, 1, "scalar"),
]


def edge_checks11(dev) -> None:
    """K8 against its plain version, exactly, on both of its row reads,
    and each launch's route against the one the case names: the tables
    of k8_edge_tables (byte classes that fit, at Q 126 too, a Q 126 table
    whose classes do not, and a pair table _pair_table did not build);
    uint8 and int32 bytes over K8_LAYOUTS (odd and even max_len from 0
    to 256, widths past max_len, views one row and one element in, so
    the vector route falls back to scalar), lengths -1, 0 and at, under
    and past every 16-byte chunk's end and past max_len, starts outside
    [0, Q), int32 bytes -1, 256 and 2^20; B = 1, 255, 257 and 200 003
    (several rows a thread of the persistent grid), and B = 0 (no
    launch). Where the pair table was composed from a single-step table,
    the pair walk equals K7's walk on it, and on its byte classes (the
    class route, which the L7 walk takes for such a table from 16-byte
    rows: ops/dfa.py l7_walk_route). The C entry refuses a route its
    inputs do not allow."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops import dfa as dfamod
    from cilium_tpu_torch.ops.dfa import (
        accept_words, class_table, dfa_match_batch_classes, dfa_match_batch_fused,
        dfa_match_batch_pair, dfa_pair_walk_plain,
    )

    rs = np.random.default_rng(1111)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k8 = _kernels.KERNELS["dfa_pair_walk"]
    tables = k8_edge_tables(rs)
    for tname, pair, trans, accept, has_classes in tables:
        q = pair.shape[0]
        form = None if trans is None else class_table(trans)
        if (form is not None) != has_classes:
            fail(f"class_table of the {tname} table: {form is not None}")
        cls = None if form is None else tuple(t(a) for a in form)
        pr, tr = t(pair), None if trans is None else t(trans)
        lo, hi = (t(w) for w in accept_words(accept))
        accepted = 0
        for name, dtype, width, max_len, row_off, elem_off, want_bytes in K8_LAYOUTS:
            for b in (1, 255, 257, 200_003 if name in ("u8 w256 max_len 255", "i32 w20 max_len 17")
                      else 1_999):
                if dtype == "uint8":
                    sb = rs.choice(np.frombuffer(b"ab/xyz019c\x00", np.uint8), (b, width))
                    sb[rs.random(sb.shape) < 0.05] = rs.integers(0, 256)
                    ch = 16
                else:
                    sb = rs.integers(0, 256, (b, width)).astype(np.int32)
                    sb[rs.random(sb.shape) < 0.002] = rs.choice(np.array([-1, 256, 1 << 20],
                                                                         np.int32))
                    ch = 4
                edges = [-1, 0, max_len, max_len + 1, max_len + 7] + [
                    c * ch + d for c in range(1, max_len // ch + 1) for d in (-1, 0, 1)]
                lens = np.array(edges, np.int32)[np.arange(b) % len(edges)]
                lens = np.where(rs.random(b) < 0.5, lens,
                                rs.integers(-1, max_len + 3, b)).astype(np.int32)
                starts = rs.integers(0, q, b).astype(np.int32)
                starts[rs.random(b) < 0.01] = rs.choice(np.array([-1, q, q + 100], np.int32))
                args = (lo, hi, t(starts), strided_view(sb, row_off, elem_off, dev), t(lens),
                        max_len)
                want = dfa_pair_walk_plain(pr, *args)
                if any(max_abs_err(g, w) for g, w in zip(dfa_match_batch_pair(pr, *args), want)):
                    fail(f"dfa_pair_walk disagrees on the {tname} table, {name}, B = {b}")
                if dfamod.WALK_ROUTES["dfa_pair_walk"] != ("pair", want_bytes):
                    fail(f"dfa_pair_walk took route {dfamod.WALK_ROUTES['dfa_pair_walk']} on "
                         f"the {tname} table, {name}; expected {('pair', want_bytes)}")
                if tr is not None and any(max_abs_err(g, w) for g, w in zip(
                        want, dfa_match_batch_fused(tr, *args))):
                    fail(f"the pair walk and the single-byte walk differ on the {tname} table, "
                         f"{name}, B = {b}")
                if cls is not None:
                    if any(max_abs_err(g, w) for g, w in zip(
                            want, dfa_match_batch_classes(tr, *cls, *args))):
                        fail(f"the pair walk and K7's class walk differ on the {tname} table, "
                             f"{name}, B = {b}")
                    if dfamod.WALK_ROUTES["dfa_walk_fused"] != ("classes", want_bytes):
                        fail(f"K7 took route {dfamod.WALK_ROUTES['dfa_walk_fused']} on the "
                             f"{tname} table's classes, {name}")
                accepted += int((want[0] != 0).sum())
        if not accepted:
            fail(f"no row of the K8 edge cases on the {tname} table was accepted")
        # B = 0: no launch
        before = k8.launches
        empty = (lo, hi, t(np.zeros(0, np.int32)), t(np.zeros((0, 16), np.uint8)),
                 t(np.zeros(0, np.int32)), 16)
        if dfa_match_batch_pair(pr, *empty)[0].shape != (0,):
            fail("an empty pair-walk batch returned rows")
        if k8.launches != before:
            fail("an empty pair-walk batch launched a kernel")
    # the C entry refuses a route its inputs do not allow
    _, pair, _, accept, _ = tables[0]
    pr = t(pair)
    lo, hi = (t(w) for w in accept_words(accept))
    b = 64
    st, ln = t(np.zeros(b, np.int32)), t(np.full(b, 16, np.int32))
    out_lo, out_hi = (torch.empty(b, dtype=torch.int32, device=dev) for _ in range(2))
    aligned = t(np.zeros((b, 16), np.uint8))
    odd = strided_view(np.zeros((b, 16), np.uint8), 0, 1, dev)
    for what, bytes_, size, vec in (
        ("2-byte bytes", aligned, 2, 0),
        ("vector bytes on a misaligned row", odd, 1, 1),
        ("vector bytes on a 17-byte row", t(np.zeros((b, 17), np.uint8)), 1, 1),
    ):
        before = k8.launches
        try:
            k8.launch(dev, pr.data_ptr(), pair.shape[0], lo.data_ptr(), hi.data_ptr(),
                      st.data_ptr(), bytes_.data_ptr(), size, bytes_.shape[1], 16, ln.data_ptr(),
                      out_lo.data_ptr(), out_hi.data_ptr(), b, vec)
        except RuntimeError:
            pass
        else:
            fail(f"the dfa_pair_walk C entry took {what}")
        if k8.launches != before:
            fail("a refused dfa_pair_walk launch was counted")
    torch.cuda.synchronize()


# K11's v6 edge cases: (K, levels) with K <= levels on both sides of
# byte 8 (where a 64-byte int32 row's second 32-byte sector starts),
# batch sizes around a warp and a block, and views whose offsets take
# each route (int32 elements in: 0, 4 and 8 on 16 bytes, 1 on neither)
K11_EDGE_KL = tuple((k, lv) for lv in (8, 12, 16) for k in (0, 7, 8, 9, 13, 16) if k <= lv)
K11_EDGE_B = (0, 1, 31, 33, 4_097)
K11_EDGE_BIG = 1_048_583
K11_EDGE_OFFSETS = {0: "vector", 1: "scalar", 4: "vector", 8: "vector"}


def k11_edge_case(rs, k: int, n_rows: int):
    """A stride-8 trie over address bytes k.. of 40 prefixes sharing
    ``base[:k]`` (tails 1 to 16 - k bytes, values 0 .. n_rows + 7: some
    point past an [n_rows, 9] table), ``common`` = ``base[:k]``, and
    addresses: each prefix's full 16 bytes as it is and with byte j
    changed, for each j in 0-15."""
    import numpy as np

    from cilium_tpu_torch.ops.lpm import TrieBuilder

    base = rs.integers(0, 256, 16)
    trie = TrieBuilder(max(16 - k, 1))
    stored = []
    for _ in range(40 if k < 16 else 0):
        a = base.copy()
        a[k:] = rs.integers(0, 256, 16 - k)
        trie.insert(bytes(int(x) for x in a[k:]), 8 * int(rs.integers(1, 16 - k + 1)),
                    int(rs.integers(0, n_rows + 8)))
        stored.append(a)
    stored = np.array(stored or [base], np.int32)
    rows = [stored]
    for j in range(16):
        a = stored.copy()
        a[:, j] = (a[:, j] + rs.integers(1, 256, a.shape[0])) % 256
        rows.append(a)
    child, info = trie.arrays()
    return child, info, base[:k].astype(np.int32), np.concatenate(rows).astype(np.int32)


def edge_checks12(dev) -> None:
    """K11's IPv6 entry against its plain version, exactly, on both of
    its routes: (K, levels) over K11_EDGE_KL, B over K11_EDGE_B and
    1 048 583 (K 0 and 13 at levels 16, vector), each view of
    K11_EDGE_OFFSETS taking the route ``lpm_stride8_route`` names (read
    back from STRIDE8_ROUTES); addresses that differ from a stored
    prefix in each byte 0-15, bytes outside [0, 255] in either half of
    the row, rows past the shed table (which shed nothing). The C entry
    must refuse the vector route on a misaligned row and past 16
    levels."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops import lpm as lpmmod
    from cilium_tpu_torch.ops.shed import shed_walk_stride8, shed_walk_stride8_plain

    rs = np.random.default_rng(12012)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n_rows, world_row = 64, 5
    full = (rs.random((n_rows + 8, 9)) < 0.5).astype(np.uint8)
    full[world_row] = 1
    tabs = {"full": t(full), "short": t(full[:n_rows])}
    past = 0
    t0 = time.perf_counter()
    for k, levels in K11_EDGE_KL:
        child, info, common, pool = k11_edge_case(rs, k, n_rows)
        tries = [t(child), t(info), t(common)]
        sizes = K11_EDGE_B + ((K11_EDGE_BIG,) if levels == 16 and k in (0, 13) else ())
        for b in sizes:
            addr = pool[rs.integers(0, pool.shape[0], b)]
            bad = rs.random(addr.shape) < 0.02  # in either half of the row
            addr[bad] = rs.choice(np.array([-1, 256, 1 << 20, -(1 << 20)], np.int32), int(bad.sum()))
            dp = t(rs.choice(np.array([-1, 0, 80, 1024, 32768, 65535], np.int32), b))
            pr = t(rs.choice(np.array([0, 6, 17, 132], np.int32), b))
            offsets = (0, 1) if b == K11_EDGE_BIG else tuple(K11_EDGE_OFFSETS)
            for elem_off in offsets:
                view = strided_view(addr, 0, elem_off, dev)
                route = lpmmod.lpm_stride8_route(16, levels, view.data_ptr())
                # an empty view's data_ptr is 0, which is on 16 bytes
                if route != (K11_EDGE_OFFSETS[elem_off] if b else "vector"):
                    fail(f"lpm_stride8_route named {route} for a view {elem_off} int32 in, "
                         f"B = {b}")
                for tname, tab in tabs.items():
                    got = shed_walk_stride8(*tries, tab, world_row, view, dp, pr, levels)
                    if lpmmod.STRIDE8_ROUTES["shed_walk_stride8"] != route:
                        fail(f"shed_walk_stride8 took route "
                             f"{lpmmod.STRIDE8_ROUTES['shed_walk_stride8']}, not {route}")
                    want = shed_walk_stride8_plain(*tries, tab, world_row, view, dp, pr, levels)
                    if max_abs_err(got, want):
                        fail(f"shed_walk_stride8 ({route}) disagrees at K {k}, levels {levels}, "
                             f"B = {b}, {elem_off} int32 in, {tname} table")
                    if tname == "short" and b == 4_097 and elem_off == 0:
                        hit = lpmmod.lpm_stride8_plain(*tries, view, levels)
                        past += int((hit > n_rows).sum())
    if not past:
        fail("K11 edge checks: no lane's row fell past the short shed table")
    # the C entry refuses a vector route its inputs do not allow
    k11 = _kernels.KERNELS["shed_walk_stride8"]
    child, info, common, _pool = k11_edge_case(rs, 13, n_rows)
    tries = [t(child), t(info), t(common)]
    b = 64
    dp, pr = t(np.zeros(b, np.int32)), t(np.zeros(b, np.int32))
    out = torch.empty(b, dtype=torch.uint8, device=dev)
    for what, view, levels in (
        ("a row off 16 bytes", strided_view(np.zeros((b, 16), np.int32), 0, 1, dev), 16),
        ("17 levels", t(np.zeros((b, 24), np.int32)), 17),
    ):
        before = k11.launches
        try:
            k11.launch(dev, tries[0].data_ptr(), tries[1].data_ptr(), child.shape[0],
                       tries[2].data_ptr(), common.shape[0], tabs["full"].data_ptr(), n_rows + 8,
                       world_row, view.data_ptr(), view.shape[1], levels, dp.data_ptr(),
                       pr.data_ptr(), out.data_ptr(), b, 1)
        except RuntimeError:
            pass
        else:
            fail(f"the shed_walk_stride8 C entry took the vector route on {what}")
        if k11.launches != before:
            fail("a refused shed_walk_stride8 launch was counted")
    torch.cuda.synchronize()
    print(f"edge_checks12: K11 v6 on both routes in {time.perf_counter() - t0:.2f}s "
          f"({past} lanes past the short table)", flush=True)


class KernelClock:
    """CUDA events around every launch of the named kernels, by wrapping
    Kernel.launch while it is entered: ``ms()`` is the card's busy time
    on them."""

    def __init__(self, names):
        self.names = set(names)
        self.pairs = []

    def __enter__(self):
        import torch

        from cilium_tpu_torch import _kernels

        self.kernel_cls, self.real = _kernels.Kernel, _kernels.Kernel.launch
        clock, real = self, self.real

        def launch(k, device, *args):
            if k.name not in clock.names:
                return real(k, device, *args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            real(k, device, *args)
            end.record()
            clock.pairs.append((start, end))

        self.kernel_cls.launch = launch
        return self

    def __exit__(self, *exc):
        self.kernel_cls.launch = self.real

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


class GateClock:
    """Host-clock split of a pass through the admission gate, by
    wrapping the methods it runs: the outer _submit (gate and enqueue),
    the kept part's own _submit (gate=False), _shed_walk, _Batch.take,
    _resolve_at_gate, the kept part's PendingBatch.result (its wait and
    completion half) and _GatedPending.result (that, plus the merge)."""

    def __init__(self, pipe):
        from cilium_tpu_torch.datapath import pipeline as P

        self.secs = {}
        self.undo = []
        for name, owner, attr in (("shed_walk", pipe, "_shed_walk"),
                                  ("resolve_at_gate", pipe, "_resolve_at_gate"),
                                  ("take", P._Batch, "take"),
                                  ("result", P.PendingBatch, "result"),
                                  ("gated_result", P._GatedPending, "result"),
                                  ("submit", pipe, "_submit")):
            real = getattr(owner, attr)
            if isinstance(owner, type):
                def timed_call(*a, _real=real, _name=name, **k):
                    return self._time(_name, _real, a, k)
            else:
                def timed_call(*a, _real=real, _name=name, **k):
                    if _name == "submit" and not k.get("gate", True):
                        _name = "kept_submit"
                    return self._time(_name, _real, a, k)
            setattr(owner, attr, timed_call)
            self.undo.append((owner, attr, real))

    def _time(self, name, real, a, k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            self.secs[name] = self.secs.get(name, 0.0) + time.perf_counter() - t0

    def take(self) -> dict:
        """The split since the last take(): ``gate_rest`` is the outer
        _submit less what it called (the masks' np.nonzero, the sports
        take, the metrics and the AIMD controller), ``merge`` the gated
        result less the kept part's."""
        s, self.secs = self.secs, {}
        g = s.get("gated_result", 0.0)
        if g:
            s["merge"] = g - s.get("result", 0.0)
        if "shed_walk" in s:
            s["gate_rest"] = s.get("submit", 0.0) - sum(
                s.get(k, 0.0) for k in ("kept_submit", "shed_walk", "take", "resolve_at_gate"))
        return s

    def close(self):
        for owner, attr, real in self.undo:
            if isinstance(owner, type):
                setattr(owner, attr, real)
            else:
                delattr(owner, attr)


def staging_copies(pipe, card: str) -> None:
    """Host copies into pinned staging as _dispatch_enqueue makes them
    (a numpy assignment into a pinned buffer's view): 4 MB of int32 into
    one reused buffer, and into five in turn, the input tuples that a
    depth-4 queue rotates through; ms per copy, 40 copies a reading."""
    import numpy as np
    import torch

    src = np.random.default_rng(7).integers(0, 1 << 30, BATCH).astype(np.int32)
    views = [pipe._host_buffer((BATCH,), torch.int32).numpy() for _ in range(5)]
    ms = {1: [], 5: []}
    for n in (1, 5, 5, 1):
        t0 = time.perf_counter()
        for k in range(40):
            views[k % n][...] = src
        ms[n].append((time.perf_counter() - t0) / 40 * 1e3)
    print(f"main path submit [staging]: {BATCH * 4} bytes of int32 into pinned staging, ms per "
          f"copy: one buffer {ms[1]}, five in turn {ms[5]} [{card}]", flush=True)


def shed_inputs(pipe, fam: int, batch, dev, elem_off: int = 0):
    """K11's entry (``fn``), its plain version and their arguments for
    one batch through the pipeline's published ingress tries and shed
    table; v6 peers ``elem_off`` int32 into their buffer (a view whose
    offset takes another route: strided_view)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.datapath.pipeline import TRAFFIC_INGRESS
    from cilium_tpu_torch.ops.shed import (
        shed_walk_stride8, shed_walk_stride8_plain, shed_walk_wide, shed_walk_wide_plain,
    )

    peer, _eps, dports, protos = batch
    t = pipe._tables[(TRAFFIC_INGRESS, fam)]
    dp, pr = torch.from_numpy(dports).to(dev), torch.from_numpy(protos).to(dev)
    if fam == 4:
        addr = torch.from_numpy(peer.astype(np.uint32).view(np.int32)).to(dev)
        tries = (t.ip_root_info, t.ip_root_child, t.ip_sub_child, t.ip_sub_info)
        return dict(fn=shed_walk_wide, plain=shed_walk_wide_plain, name="shed_walk_wide",
                    replaces=":521", t=t, tries=tries, addr=addr, dp=dp, pr=pr,
                    args=(*tries, pipe._shed_tab, t.world_row, addr, dp, pr))
    addr = strided_view(peer, 0, elem_off, dev) if elem_off else torch.from_numpy(peer).to(dev)
    tries = (t.ip_child, t.ip_info, t.ip_common)
    return dict(fn=shed_walk_stride8, plain=shed_walk_stride8_plain, name="shed_walk_stride8",
                replaces=":537", t=t, tries=tries, addr=addr, dp=dp, pr=pr,
                args=(*tries, pipe._shed_tab, t.world_row, addr, dp, pr, 16))


def deny_heavy(fam: int, seed: int, flows):
    """The main path's batch with 3/4 of its peers moved to the world
    (v4 203.0.113.0/24, outside the prefilter CIDRs; v6 2001:db8::/32):
    no bench rule admits the world, so those flows are deny-for-sure."""
    import numpy as np

    rs = np.random.default_rng(seed + 60)
    peer, eps, dports, protos = (np.array(a) for a in flows)
    world = rs.random(peer.shape[0]) < 0.75
    if fam == 4:
        peer[world] = (np.uint32(203 << 24 | 0 << 16 | 113 << 8)
                       | rs.integers(0, 256, int(world.sum())).astype(np.uint32))
    else:
        peer[world] = rs.integers(0, 256, (int(world.sum()), 16))
        peer[world, :4] = (0x20, 0x01, 0x0D, 0xB8)
    return peer, eps, dports, protos


def submit_main_path(engine, cache, endpoints, flows4, flows6, seed: int, n_idents: int,
                     card: str):
    """The async entry point and the admission gate on the card, launch
    counts from zero: the bench world as DatapathPipeline(engine, cache,
    pf, admission=True, prefilter_shed=True, pipeline_max_depth=8) with
    the prefilter CIDRs (the gate's AIMD limit, 8, stays above the
    deepest queue here, so these runs are never gated).

    - 8 v4 batches of 1 048 576 flows, no CT: process() one by one and
      submit() at depth 2 and at depth 4, resolving after all were
      submitted, each twice; 4 v6 batches serially and at depth 2, each
      twice; a host-CT pair of
      batches serially and at depth 2 on pipelines of their own. Wall
      time and busy share (the K3 / K5 + K4 event ms over the wall) of
      each; outputs, counters and CT entry counts equal; event.query()
      right after a depth-2 submit returns.
    - A deny-heavy batch of each family with the gate forced by the
      fault hub: shed lanes DROP_PREFILTER, no lane the ungated run
      forwards shed, kept lanes equal, the admission metrics moved by
      the shed count; the _shed_walk and process() wall times; the v6
      gate's K11 route."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels, faults, metrics
    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import DROP_PREFILTER, FORWARD, DatapathPipeline
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.ops import lpm as lpmmod

    t_phase = time.perf_counter()
    pf = PreFilter()
    pf.insert(pf.revision, PREFILTER_CIDRS + V6_DENY)
    pipe = DatapathPipeline(engine, cache, pf, admission=True, prefilter_shed=True,
                            pipeline_max_depth=8)
    pipe.set_endpoints(endpoints)
    pipe.rebuild()
    if pipe._shed_tab is None:
        fail("submit: the shed table was not published")
    torch.cuda.synchronize()
    batches4 = [flows4] + [make_flows(seed + 100 + k, n_idents)[:4] for k in range(7)]
    batches6 = [flows6] + [make_flows6(seed + 200 + k, n_idents)[:4] for k in range(3)]
    # the pinned staging tuples the deepest run holds, allocated once
    # before anything is timed (a pin of 20-80 MB takes milliseconds)
    for call, batches in ((pipe.submit, batches4), (pipe.submit_v6, batches6)):
        pipe.pipeline_depth = 4
        for h in [call(*b) for b in batches]:
            h.result()
    torch.cuda.synchronize()

    # the CUDA event of the newest dispatch, by wrapping the enqueue half
    last_enq = [None]
    real_enqueue = pipe._dispatch_enqueue

    def enqueue(*a, **k):
        last_enq[0] = real_enqueue(*a, **k)
        return last_enq[0]

    pipe._dispatch_enqueue = enqueue
    _kernels.reset_launches()

    def run(label, fam, batches, depth, p=pipe):
        call = getattr(p, "submit" if fam == 4 else "submit_v6")
        serial_call = getattr(p, "process" if fam == 4 else "process_v6")
        p.counters[:] = 0
        p.pipeline_depth = max(depth, 1)
        query = []
        names = ("lpm_wide" if fam == 4 else "lpm_stride8", "policymap_verdict")
        torch.cuda.synchronize()
        with KernelClock(names) as clk:
            t0 = time.perf_counter()
            if depth == 0:  # serial
                outs = [serial_call(*b) for b in batches]
            else:
                hs = []
                for b in batches:
                    hs.append(call(*b))
                    if p._inflight:
                        query.append(last_enq[0].event.query())
                outs = [h.result() for h in hs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = clk.ms()
        print(f"main path submit [{label}]: {len(batches)} x {BATCH} flows, wall {wall!r}s = "
              f"{len(batches) * BATCH / wall!r} verdicts/s, K3/K5 + K4 busy {busy!r} ms = busy "
              f"share {busy / (wall * 1e3)!r}; event.query() right after each submit {query} "
              f"[{card}]", flush=True)
        return dict(outs=outs, counters=p.counters.copy())

    def same(a, b, what):
        for (x, y) in zip(a["outs"], b["outs"]):
            if not all(np.array_equal(u, v) for u, v in zip(x, y)):
                fail(f"submit: {what} outputs differ")
        if not np.array_equal(a["counters"], b["counters"]):
            fail(f"submit: {what} counters differ")

    # each sequence twice, in the order serial, 2, 4, 4, 2, serial, so a
    # drift of the host over the phase reads on every depth alike
    def sequence(fam, batches, depths):
        call = "submit" if fam == 4 else "submit_v6"
        done = {}
        for depth in depths:
            label = f"v{fam} {call}() depth {depth}" if depth else f"v{fam} serial process"
            done.setdefault(depth, []).append(run(f"{label}, run {len(done.get(depth, [])) + 1}",
                                                  fam, batches, depth))
            same(done[depth][-1], done[0][0], f"v{fam} depth {depth} and serial")

    sequence(4, batches4, (0, 2, 4, 4, 2, 0))
    staging_copies(pipe, card)
    # no hidden sync in the enqueue half: with about 50 ms of work queued
    # ahead of it on the stream, a depth-2 submit() must return while its
    # batch has not run (its event not reached)
    pipe.pipeline_depth = 2
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * 1.98e9))
    t0 = time.perf_counter()
    h = pipe.submit(*batches4[0])
    t_submit = time.perf_counter() - t0
    pending = last_enq[0].event.query()
    h.result()
    print(f"main path submit [enqueue]: with 50 ms of work queued ahead, submit() of {BATCH} "
          f"flows returned in {t_submit!r}s, event.query() right after: {pending} [{card}]",
          flush=True)
    if pending or t_submit >= 0.05:
        fail("submit: a depth-2 submit() waited for the card (a hidden sync in the enqueue half)")
    sequence(6, batches6, (0, 2, 2, 0))
    del pipe._dispatch_enqueue

    # host CT: two 1M-flow batches on two pipelines with their own CT
    rs = np.random.default_rng(seed + 300)
    ct_batches = batches4[:2]
    ct_sports = [rs.integers(1024, 60000, BATCH) for _ in ct_batches]
    ct_runs = {}
    for depth in (0, 2):
        cpipe = DatapathPipeline(engine, cache, pf, FlowConntrack(capacity_bits=CT_BITS))
        cpipe.set_endpoints(endpoints)
        cpipe.rebuild()
        cpipe.process(*ct_batches[0], sports=ct_sports[0])  # warm the staging
        with cpipe._lock:
            cpipe._flush_ct_locked()
        cpipe.counters[:] = 0
        torch.cuda.synchronize()
        with KernelClock(("lpm_wide", "policymap_verdict")) as clk:
            t0 = time.perf_counter()
            if depth:
                cpipe.pipeline_depth = depth
                hs = [cpipe.submit(*b, sports=sp) for b, sp in zip(ct_batches, ct_sports)]
                outs = [h.result() for h in hs]
            else:
                outs = [cpipe.process(*b, sports=sp) for b, sp in zip(ct_batches, ct_sports)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = clk.ms()
        ct_runs[depth] = (outs, len(cpipe.conntrack), cpipe.counters.copy())
        print(f"main path submit [host CT, {'serial' if not depth else 'depth 2'}]: 2 x {BATCH} "
              f"flows with sports, wall {wall!r}s, K3 + K4 (miss tail) busy {busy!r} ms = busy "
              f"share {busy / (wall * 1e3)!r}, CT entries {len(cpipe.conntrack)} [{card}]",
              flush=True)
    if not (all(np.array_equal(u, v) for x, y in zip(ct_runs[0][0], ct_runs[2][0])
                for u, v in zip(x, y))
            and ct_runs[0][1] == ct_runs[2][1] > 0
            and np.array_equal(ct_runs[0][2], ct_runs[2][2])):
        fail("submit: the host-CT pair differs between serial and depth 2")

    # the gate, forced by the fault hub, on a deny-heavy batch per family;
    # the mask it must shed comes from K11's plain version on the card
    # (no launch), and each gated pass launches its family's K11 entry
    # exactly once
    gate = {}
    pipe.pipeline_depth = 2
    clock = GateClock(pipe)
    for fam, flows in ((4, flows4), (6, flows6)):
        batch = deny_heavy(fam, seed, flows)
        call = getattr(pipe, "process" if fam == 4 else "process_v6")
        k11 = shed_inputs(pipe, fam, batch, pipe.device)
        entry = k11["name"]
        mask = k11["plain"](*k11["args"]).cpu().numpy()
        n_shed = int(mask.sum())
        clock.take()
        t0 = time.perf_counter()
        v_ref, r_ref = call(*batch)
        t_full = time.perf_counter() - t0
        split_full = clock.take()
        m0 = (metrics.admission_shed_total.get({"reason": "prefilter"}),
              metrics.drop_reasons_total.get({"reason": "prefilter", "producer": "admission"}))
        runs = []
        # twice: the first pins the kept part's staging capacity
        for _ in range(2):
            faults.hub.fail(faults.SITE_QUEUE_FULL, faults.KIND_TRANSIENT, times=1)
            before = _kernels.launches()
            t0 = time.perf_counter()
            out = call(*batch)
            runs.append((out, time.perf_counter() - t0, clock.take()))
            after = _kernels.launches()
            moved = {k: after[k] - before[k] for k in ("shed_walk_wide", "shed_walk_stride8")}
            if moved != {k: int(k == entry) for k in moved}:
                fail(f"submit gate v{fam}: a gated pass launched K11 {moved}, not one {entry}")
            if len(runs) == 1:
                m1 = (metrics.admission_shed_total.get({"reason": "prefilter"}),
                      metrics.drop_reasons_total.get({"reason": "prefilter",
                                                      "producer": "admission"}))
        faults.hub.reset()
        (v, red), t_gated, split = runs[0]
        print(f"main path submit [gate v{fam}]: deny-heavy batch of {BATCH}, forced queue-full: "
              f"shed {n_shed}; ungated process {t_full!r}s {split_full}; gated process "
              f"{t_gated!r}s (first, pins the kept part's staging) {split}, {runs[1][1]!r}s "
              f"(again) {runs[1][2]} [{card}]", flush=True)
        if not all(np.array_equal(x, y) for x, y in zip(runs[1][0], (v, red))):
            fail(f"submit gate v{fam}: two gated runs of one batch differ")
        if not (mask.any() and not mask.all()):
            fail(f"submit gate v{fam}: the deny-heavy batch shed all or nothing")
        if not (v[mask] == DROP_PREFILTER).all() or red[mask].any():
            fail(f"submit gate v{fam}: a lane of the plain mask is not DROP_PREFILTER")
        if (mask & (v_ref == FORWARD)).any():
            fail(f"submit gate v{fam}: a lane the ungated run forwards was shed")
        if not (np.array_equal(v[~mask], v_ref[~mask]) and np.array_equal(red[~mask], r_ref[~mask])):
            fail(f"submit gate v{fam}: kept lanes differ from the ungated run")
        if (m1[0] - m0[0], m1[1] - m0[1]) != (n_shed, n_shed):
            fail(f"submit gate v{fam}: the admission metrics moved by {m1[0] - m0[0]} and "
                 f"{m1[1] - m0[1]}, not {n_shed}")
        if fam == 6:
            route = lpmmod.STRIDE8_ROUTES["shed_walk_stride8"]
            print(f"main path submit [gate v6]: shed_walk_stride8 route (latest launch) {route} "
                  f"[{card}]", flush=True)
        gate[fam] = dict(batch=batch, mask=mask, t_full=t_full, ungated=flows)
    clock.close()
    print(f"submit main path and its checks in {time.perf_counter() - t_phase:.2f}s", flush=True)
    return dict(pipe=pipe, gate=gate, card=card)


def shed_rows(sub, dev, row) -> None:
    """K11's two entries against their plain versions on the gate's
    deny-heavy 1 048 576-flow batches, timed, with their bounds: the
    trie bytes the identity walk touches (lpm_touched_bytes /
    stride8_touched_bytes, less their 4-byte output), 8 bytes of dport
    and proto in and 1 byte out per flow, and the 32-byte sectors of
    the shed table the flows reach. The v6 entry on its vector and
    scalar routes (views 0 and 1 int32 into their buffer), on the
    deny-heavy and the ungated batch (make_flows6's: 1/16 world), each
    beside a second, named figure: the sector floor, what a read of only
    the 32-byte sectors the walk needs would move (one of a row's two
    for a lane whose compare fails in bytes 0-7, two for the rest) plus
    dport, proto and out; the L2 fetches a 64-byte row whole, so the
    kernel cannot reach it on int32 rows. Then the gate's whole
    shed decision (_shed_walk: h2d, K11, d2h of the mask) on the
    deny-heavy batches, after the main path's launch counts were
    read."""
    import numpy as np
    import torch

    from cilium_tpu_torch.datapath.admission import flow_class
    from cilium_tpu_torch.ops import lpm as lpmmod
    from cilium_tpu_torch.ops.lpm import elided_lookup, lpm_lookup_wide

    pipe = sub["pipe"]
    tab = pipe._shed_tab
    for fam in (4, 6):
        g = sub["gate"][fam]
        cases = [("deny-heavy", g["batch"], 0)]
        if fam == 6:
            cases += [("deny-heavy", g["batch"], 1)]
            cases += [("ungated", g["ungated"], off) for off in (0, 1)]
        for bname, batch, elem_off in cases:
            k11 = shed_inputs(pipe, fam, batch, dev, elem_off)
            fn, plain, name, t, tries, addr, args = (
                k11[k] for k in ("fn", "plain", "name", "t", "tries", "addr", "args"))
            if fam == 4:
                hit = lpm_lookup_wide(*tries, addr)
                walk = lpm_touched_bytes(tries[0], tries[1], tries[3], addr)
            else:
                hit = elided_lookup(*tries, addr, 16)
                walk = stride8_touched_bytes(*tries, addr, 16)
            k_out, p_out = fn(*args), plain(*args)
            if bname == "deny-heavy" and not torch.equal(k_out.cpu(), torch.from_numpy(g["mask"])):
                fail(f"{name}: the kernel's mask differs from the gate's")
            row_ = torch.where(hit > 0, hit.long() - 1, t.world_row)
            idx = row_ * 9 + flow_class(k11["dp"].long(), k11["pr"].long())
            sectors = torch.unique(idx[idx < tab.numel()] // 32).numel()
            n = addr.shape[0]
            b_ms, b_by = bound(walk - 4 * n + 9 * n + 32 * sectors, 0)
            shape = (f"v{fam}: {n} flows ({bname}), shed table {list(tab.shape)}, "
                     f"{int(k_out.sum())} shed, {sectors} table sectors")
            note = None
            if fam == 6:
                common = tries[2]
                kk = min(common.shape[0], 8)
                holds = (addr[:, :kk] == common[:kk]).all(1) if kk else torch.ones(
                    n, dtype=torch.bool, device=addr.device)
                floor = 32 * n + 32 * int(holds.sum()) + 9 * n
                note = (f"sector floor {floor / HBM_BYTES_PER_S * 1e3!r} ms: {floor} bytes, "
                        f"{n - int(holds.sum())} lanes whose compare fails in bytes 0-7")
                shape += f", rows {elem_off} int32 into their buffer"
            row(name, "cilium_tpu_torch/csrc/shed_walk.cu",
                f"cilium_tpu/datapath/pipeline.py{k11['replaces']}",
                max_abs_err(k_out, p_out), lambda fn=fn, args=args: fn(*args),
                lambda plain=plain, args=args: plain(*args), b_ms, b_by, shape, graph=True,
                note=note)
            if fam == 6:
                want = {0: "vector", 1: "scalar"}[elem_off]
                if lpmmod.STRIDE8_ROUTES[name] != want:
                    fail(f"{name} took route {lpmmod.STRIDE8_ROUTES[name]} on rows {elem_off} "
                         f"int32 in, not {want}")
        peer, _eps, dports, protos = g["batch"]
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = pipe._shed_walk(peer, dports, protos, family=fam)
            walls.append(time.perf_counter() - t0)
            if not (got == g["mask"]).all():
                fail(f"{name}: _shed_walk's mask differs from the gate's")
        # the shed lanes' per-endpoint counters, as _resolve_at_gate
        # counts them (np.bincount) and as the reference does (np.add.at)
        eps = np.asarray(g["batch"][1], np.int32)[np.nonzero(g["mask"])[0]]
        n_ep = pipe.counters.shape[0]
        ways = {"add.at": [], "bincount": []}
        for _ in range(3):
            at, bc = np.zeros((n_ep, 3), np.int64), np.zeros((n_ep, 3), np.int64)
            t0 = time.perf_counter()
            np.add.at(at, (eps, 2), 1)
            ways["add.at"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            bc[:, 2] += np.bincount(eps, minlength=n_ep)
            ways["bincount"].append(time.perf_counter() - t0)
            if not np.array_equal(at, bc):
                fail("the shed lanes' counters differ between np.add.at and np.bincount")
        print(f"main path submit [gate v{fam}]: _shed_walk (h2d, K11, d2h of the mask) {walls}s "
              f"against the ungated process {g['t_full']!r}s; the {eps.size} shed lanes' "
              f"counters (host) {ways}s [{sub['card']}]", flush=True)


# the delta phase (bench.py:2622-2770 _bench_updates without its
# epoch-swap leg): samples per kind and the identities of one burst
DELTA_SAMPLES = 12
IDENT_SAMPLES = 20
IDENT_BURST = 16
DELTA_ORACLE = 40  # flows held against the host oracle after each kind


class OpClock:
    """CUDA events around every call of the wrapped functions while
    entered (``targets``: (owner, attribute) pairs, a tensor method or a
    module function). Per helper (``label(attribute, args)``): calls,
    card time and the bytes the out-of-place op must move (every tensor
    argument read once, the outputs written once)."""

    def __init__(self, targets, label):
        self.targets = targets
        self.label = label
        self.by = {}  # helper → [calls, bytes, [(start, end)]]

    def __enter__(self):
        import torch

        self.saved = [(owner, name, getattr(owner, name)) for owner, name in self.targets]
        for owner, name, real in self.saved:
            def op(*args, _real=real, _name=name, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _real(*args, **kw)
                end.record()
                flat = [a for x in args for a in (x if isinstance(x, (tuple, list)) else (x,))]
                outs = out if isinstance(out, tuple) else (out,)
                e = self.by.setdefault(self.label(_name, args), [0, 0, []])
                e[0] += 1
                e[1] += nbytes(*(a for a in flat if isinstance(a, torch.Tensor)), *outs)
                e[2].append((start, end))
                return out
            setattr(owner, name, op)
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)

    def summary(self):
        """{helper: (calls, card ms, bytes)}."""
        import torch

        torch.cuda.synchronize()
        return {h: (c, sum(s.elapsed_time(e) for s, e in ev), b) for h, (c, b, ev) in self.by.items()}


def scatter_clock() -> OpClock:
    """The delta scatter helpers, one out-of-place op each: ``index_put``
    (the engine's ``_set_rows`` / ``_set_rows_cols`` / ``_patch_tables``),
    ``index_copy`` on dim 0 (``_patch_bitmap_rows``) and on dim 1
    (``patch_bitmap_cols``), ``slice_scatter`` (``_set_col_window``)."""
    import torch

    def label(op, args):
        if op == "index_put":
            return "engine index_put"
        if op == "slice_scatter":
            return "_set_col_window"
        return "_patch_bitmap_rows" if args[1] == 0 else "patch_bitmap_cols"
    return OpClock([(torch.Tensor, n) for n in ("index_put", "index_copy", "slice_scatter")], label)


def trie_clock(by_shape: bool = False) -> OpClock:
    """The trie scatter helpers of ops/lpm.py that the mirrors' flushes
    call, by helper, or by helper and the shape of the tensor it patches."""
    from cilium_tpu_torch.ops import lpm

    def label(name, args):
        return f"{name} {list(args[0].shape)}" if by_shape else name
    return OpClock([(lpm, n) for n in ("_patch_trie_rows", "_patch_span1", "_patch_span_row",
                                       "_patch_elems")], label)


def sel_clock() -> OpClock:
    """The placed sel_match's scatter helpers of ops/materialize.py, one
    out-of-place op a shard that owns a patched row."""
    from cilium_tpu_torch.ops import materialize as matmod

    return OpClock([(matmod, "_scatter_sel_rows"), (matmod, "_scatter_sel_cols")],
                   lambda op, args: op)


class CallRecorder:
    """Keeps the operands of the first ``keep`` calls of each wrapped
    function made while entered, keyed by name, to hold a kernel against
    its plain version at the shapes a path gives it. ``targets``:
    (module, function) pairs; by default the K2 / K6 calls of a patch
    (``verdict.bool_mm``, ``materialize.bool_mm``,
    ``verdict.first_rule_terms``; a patch makes fewer than 100 of
    each)."""

    def __init__(self, targets=None, keep: int = 256):
        from cilium_tpu_torch.ops import materialize as matmod
        from cilium_tpu_torch.ops import verdict as verdictmod

        self.targets = targets or [
            (verdictmod, "bool_mm"), (matmod, "bool_mm"), (verdictmod, "first_rule_terms")]
        self.keep = keep
        self.calls = {name: [] for _, name in self.targets}

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
        for mod, name, real in self.saved:
            def call(*args, real=real, name=name, **kw):
                if len(self.calls[name]) < self.keep:
                    self.calls[name].append((args, kw))
                return real(*args, **kw)
            setattr(mod, name, call)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


class uncounted:
    """Launches made while entered are not the counted path's: the
    launch counts are put back as they were on entry (the comparison
    runs of the deltas phase: a fresh engine's full refresh, its forced
    full rebuild and its batches, and the attributed re-sweep that
    switches the pipeline under test to attribution)."""

    def __enter__(self):
        from cilium_tpu_torch import _kernels

        self.saved = _kernels.launches()
        return self

    def __exit__(self, *exc):
        from cilium_tpu_torch import _kernels

        for name, n in self.saved.items():
            _kernels.KERNELS[name].launches = n


def pcts(samples):
    """(p50, p99) of host-clock seconds, in ms."""
    s = sorted(samples)
    return s[len(s) // 2] * 1e3, s[min(len(s) - 1, int(len(s) * 0.99))] * 1e3


def deltas_main_path(seed: int, card: str):
    """The incremental policy update on the card (bench.py:2622-2770
    without the epoch swap), on a bench world of its own so that no
    other phase sees its mutations: PolicyEngine(repo, reg).refresh() →
    wait_device() → DatapathPipeline(engine, cache, pf).rebuild() with
    the prefilter CIDRs.

    - The full refresh + forced rebuild of the world, for comparison;
      then every delta path warmed once.
    - Identity churn: 20 samples of allocate → refresh → wait_device
      (the engine's row scatters) and the rebuild (the row patch on K2)
      timed apart, a release between samples; then one burst of 16
      identities in one refresh.
    - 12 rule appends (one L3 rule from an endpoint's app to a new
      zone ∧ env selector) and 12 deletes of them, engine and rebuild
      timed apart; the patch hits (rebuilds that kept the materialized
      states) must be 12 of 12 each.
    - One append with set_attribution(True): the column re-sweep takes
      the attribution route (K2 + K6).
    After each kind the patched pipeline is held against a forced full
    rebuild of a fresh engine over the same repository and registry:
    bit-equal policymap words, allow / redirect bitmaps (and rule
    tables), equal verdicts and redirects of a 1 048 576-flow v4 and v6
    batch, and the host oracle on a sample. Launches of K2 / K6 and
    the scatter ops' card time and bytes are read per delta."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels, metrics
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api import EndpointSelector, IngressRule, rule

    t_phase = time.perf_counter()
    repo, reg, cache, idents, labels_of = build_world(seed)
    ips, eps, dports, protos, i_sel = make_flows(seed + 300, len(idents))
    flows6 = make_flows6(seed + 300, len(idents))[:4]
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    cidrs = PREFILTER_CIDRS + V6_DENY
    denied4 = [ipaddress.ip_network(c) for c in PREFILTER_CIDRS]

    def pipeline(engine, attrib=False):
        pf = PreFilter()
        pf.insert(pf.revision, cidrs)
        pipe = DatapathPipeline(engine, cache, pf)
        pipe.set_endpoints(endpoints)
        if attrib:
            pipe.set_attribution(True)
        return pipe

    engine = PolicyEngine(repo, reg)
    engine.refresh()
    pipe = pipeline(engine)
    pipe.rebuild()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.refresh(force=True)
    engine.wait_device()
    t_full_refresh = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.rebuild(force=True)
    torch.cuda.synchronize()
    t_full_rebuild = time.perf_counter() - t0
    print(f"main path deltas: full refresh {t_full_refresh!r}s + forced rebuild {t_full_rebuild!r}s "
          f"of the same world (for comparison) [{card}]", flush=True)

    apps = sorted({next(x for x in labels_of[e] if x.startswith("k8s:app=")) for e in endpoints})
    pairs = [(z, env) for env in ("prod", "dev") for z in range(8)]
    counts = {"appended": 0}

    def l3_rule(tag: str):
        """An L3 rule from an endpoint's app to a selector the world
        never used (one zone ∧ env pair each)."""
        z, env = pairs[counts["appended"]]
        counts["appended"] += 1
        return rule([apps[counts["appended"] % len(apps)]], ingress=[IngressRule(
            from_endpoints=(EndpointSelector.make([f"k8s:zone=z{z}", f"k8s:env={env}"]),))],
            labels=[f"k8s:policy={tag}"])

    def kept(base):
        return all(pipe._mat.get(d) is base[d] for d in base)

    def split(names):
        """Host-clock seconds spent in the named pipeline methods during
        one rebuild (instance attributes shadow the methods)."""
        spent = dict.fromkeys(names, 0.0)
        for name in names:
            def f(*a, _real=getattr(pipe, name), _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    spent[_name] += time.perf_counter() - t0
            setattr(pipe, name, f)
        return spent

    def step(mutate):
        """mutate(); refresh; wait_device; rebuild → (the mutation's s on
        the registry or repository, refresh + wait_device s, rebuild s
        and its split: the delta routing (the patches) and the trie
        build, kept the states, K2 / K6 launches, the scatter helpers'
        calls / card ms / bytes in the refresh and the rebuild)."""
        before = _kernels.launches()
        with scatter_clock() as sc:
            t0 = time.perf_counter()
            mutate()
            t_mut = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine.refresh()
            engine.wait_device()
            t_eng = time.perf_counter() - t0
            base = dict(pipe._mat)
            spent = split(("_route_deltas", "_build_tries_locked"))
            t0 = time.perf_counter()
            try:
                pipe.rebuild()
                torch.cuda.synchronize()
            finally:
                for name in spent:
                    delattr(pipe, name)
            t_reb = time.perf_counter() - t0
        after = _kernels.launches()
        return dict(mutate=t_mut, engine=t_eng, rebuild=t_reb, kept=kept(base), route=spent["_route_deltas"],
                    tries=spent["_build_tries_locked"],
                    k2=after["bool_mm"] - before["bool_mm"],
                    k6=after["first_rule"] - before["first_rule"], scatters=sc.summary())

    def hold(kind: str, attrib: bool = False):
        """The patched pipeline against a forced full rebuild of a fresh
        engine over the same repository and registry. Only the patched
        pipeline's batches count as the path's launches."""
        t0 = time.perf_counter()
        with uncounted():
            fresh = pipeline(PolicyEngine(repo, reg), attrib)
            fresh.rebuild(force=True)
        for d in (0, 1):
            m, f = pipe._mat[d], fresh._mat[d]
            if m.ep_slots != f.ep_slots:
                fail(f"deltas [{kind}]: direction {d} slot layout differs from a full rebuild")
            if not (np.array_equal(m.allow_nc, f.allow_nc) and np.array_equal(m.red_nc, f.red_nc)):
                fail(f"deltas [{kind}]: direction {d} allow / redirect bitmaps differ")
            if max_abs_err(m.tables.id_bits, f.tables.id_bits):
                fail(f"deltas [{kind}]: direction {d} policymap words differ")
            if attrib and (m.rule_tab is None or max_abs_err(m.rule_tab, f.rule_tab)):
                fail(f"deltas [{kind}]: direction {d} rule tables differ")
        v4 = None
        for call, flows in (("process", (ips, eps, dports, protos)), ("process_v6", flows6)):
            got = getattr(pipe, call)(*flows)
            with uncounted():
                want = getattr(fresh, call)(*flows)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                fail(f"deltas [{kind}]: {call} differs from a full rebuild")
            v4 = got[0] if v4 is None else v4
        # the host oracle walks all 10 000 rules per flow (~70 ms each)
        oracle_check(repo, labels_of, idents, f"deltas [{kind}]", ips, eps, dports, protos, i_sel,
                     v4, denied4, endpoints, n=DELTA_ORACLE)
        print(f"main path deltas [{kind}]: == a forced full rebuild of a fresh engine (policymap "
              f"words, allow / redirect bitmaps{', rule tables' if attrib else ''}; verdicts and "
              f"redirects of {BATCH} v4 and v6 flows) and the host oracle on {DELTA_ORACLE} flows, "
              f"in {time.perf_counter() - t0:.2f}s", flush=True)

    # warm every path once (first launches at the patch shapes)
    warm = reg.allocate(parse_label_array(["k8s:app=a1", "k8s:env=updwarm"]))
    step(lambda: None)
    step(lambda: reg.release(warm))
    step(lambda: repo.add_list([l3_rule("delta-warm")]))
    step(lambda: repo.delete_by_labels(parse_label_array(["k8s:policy=delta-warm"])))

    inc0 = metrics.engine_refreshes_total.get({"kind": "incremental"})
    full0 = metrics.engine_refreshes_total.get({"kind": "full"})
    samples = {}
    _kernels.reset_launches()
    ident = []
    for i in range(IDENT_SAMPLES):
        new = []
        ident.append(step(lambda: new.append(
            reg.allocate(parse_label_array([f"k8s:app=a{i % N_APPS}", "k8s:env=updbench"])))))
        step(lambda: reg.release(new[0]))
    samples["identity"] = ident
    burst = []
    samples["identity burst"] = [step(lambda: burst.extend(
        reg.allocate(parse_label_array([f"k8s:app=a{100 + j}", "k8s:env=updburst"]))
        for j in range(IDENT_BURST)))]
    hold("identity")
    appended, deleted = [], []
    for i in range(DELTA_SAMPLES):
        appended.append(step(lambda: repo.add_list([l3_rule(f"delta-{i}")])))
    hold("rule append")
    for i in range(DELTA_SAMPLES):
        deleted.append(step(lambda: repo.delete_by_labels(parse_label_array([f"k8s:policy=delta-{i}"]))))
    hold("rule delete")
    samples["rule append"], samples["rule delete"] = appended, deleted
    with uncounted():  # a full attributed sweep, not a delta
        pipe.set_attribution(True)
        pipe.rebuild()
    samples["rule append, attribution"] = [step(lambda: repo.add_list([l3_rule("delta-attrib")]))]
    hold("rule append, attribution", attrib=True)
    inc = metrics.engine_refreshes_total.get({"kind": "incremental"}) - inc0
    full = metrics.engine_refreshes_total.get({"kind": "full"}) - full0
    # the holds' fresh engines make the full refreshes
    if full != 4 or inc != 2 * IDENT_SAMPLES + 1 + 2 * DELTA_SAMPLES + 1:
        fail(f"deltas: {inc} incremental and {full} full refreshes, expected "
             f"{2 * IDENT_SAMPLES + 2 + 2 * DELTA_SAMPLES} and 4 (the holds')")

    for kind, ss in samples.items():
        hits = sum(x["kept"] for x in ss)
        if hits != len(ss):
            fail(f"deltas [{kind}]: {hits} of {len(ss)} rebuilds patched in place")
        p50m, p99m = pcts([x["mutate"] for x in ss])
        p50e, p99e = pcts([x["engine"] for x in ss])
        p50r, p99r = pcts([x["rebuild"] for x in ss])
        p50route, p99route = pcts([x["route"] for x in ss])
        p50t, p99t = pcts([x["tries"] for x in ss])
        k2 = sorted({x["k2"] for x in ss})
        k6 = sorted({x["k6"] for x in ss})
        print(f"main path deltas [{kind}] x{len(ss)}: the mutation (registry allocate / release, "
              f"repository add_list / delete_by_labels) p50 {p50m!r} ms, p99 {p99m!r} ms; "
              f"refresh + wait_device p50 {p50e!r} ms, p99 "
              f"{p99e!r} ms; rebuild p50 {p50r!r} ms, p99 {p99r!r} ms (of it the delta routing p50 "
              f"{p50route!r} / p99 {p99route!r} ms, the trie build p50 {p50t!r} / p99 {p99t!r} ms); "
              f"patch hits {hits}/{len(ss)}; "
              f"K2 launches per delta {k2}, K6 {k6} [{card}]", flush=True)
        for h in sorted({h for x in ss for h in x["scatters"]}):
            per = [x["scatters"].get(h, (0, 0.0, 0)) for x in ss]
            ms = sorted(p[1] for p in per)
            b = sorted({p[2] for p in per})
            print(f"main path deltas [{kind}] scatter {h}: calls per delta {sorted({p[0] for p in per})}, "
                  f"card ms per delta median {median(ms)!r} (min {ms[0]!r}, max {ms[-1]!r}), bytes "
                  f"{b[0]}-{b[-1]}, bound {b[-1] / HBM_BYTES_PER_S * 1e3!r} ms at the most bytes (bytes / "
                  f"3.35 TB/s) [{card}]", flush=True)
    if not any(x["k2"] for k in ("identity", "rule append", "rule delete") for x in samples[k]):
        fail("deltas: no patch launched K2")
    if not samples["rule append, attribution"][0]["k6"]:
        fail("deltas: the attributed column patch launched no K6")
    print(f"main path deltas: {time.perf_counter() - t_phase:.2f}s for the phase [{card}]", flush=True)
    return dict(pipe=pipe, repo=repo, reg=reg, l3_rule=l3_rule, step=step)


def k2_row(row, what: str, x, w, comp: bool, err: int) -> None:
    """K2's kernel line at one shape: the kernel, its plain version and
    the yardstick torch._int_mm thresholded (> 0, the same function) on
    the same operands made int8, complemented and contiguous beforehand,
    kernel and yardstick on both clocks; bare torch._int_mm (the sums
    alone, unthresholded) is printed beside it."""
    import torch

    from cilium_tpu_torch.ops.verdict import bool_mm, bool_mm_plain

    out = bool_mm(x, w, comp)
    b_ms, b_by = bound(nbytes(x, w, out), 2 * x.shape[0] * x.shape[1] * w.shape[1])
    xl = x.to(torch.int8)
    xl = (1 - xl if comp else xl).contiguous()
    wl = w.to(torch.int8).contiguous()
    lib_fn, note = None, "library none: torch._int_mm needs rows > 16 and k, n multiples of 8"
    if xl.shape[0] > 16 and xl.shape[1] % 8 == 0 and wl.shape[1] % 8 == 0:
        if max_abs_err(torch._int_mm(xl, wl) > 0, out):
            fail(f"bool_mm at {what} disagrees with the library product")
        bare, _ = timed(lambda: torch._int_mm(xl, wl))
        lib_fn = lambda: torch._int_mm(xl, wl) > 0  # noqa: E731
        note = f"library torch._int_mm > 0 (bare torch._int_mm {median(bare)!r} {bare})"
    row("bool_mm", "cilium_tpu_torch/csrc/bool_mm.cu", "cilium_tpu/ops/verdict.py:151", err,
        lambda: bool_mm(x, w, comp), lambda: bool_mm_plain(x, w, comp), b_ms, b_by,
        f"{what} [{x.shape[0]},{x.shape[1]}] x [{w.shape[0]},{w.shape[1]}] (complement {comp}), "
        f"{note}", lib_fn=lib_fn, graph=True)


def k6_row(row, what: str, terms, err: int) -> None:
    """K6's kernel line for one launch over ``terms`` ([(mask, rule_of)],
    one to three), on both clocks. Bound: bytes, each mask and rule_of
    read once and 4 bytes written a row and term."""
    from cilium_tpu_torch.ops.verdict import first_rule_terms, first_rule_terms_plain

    b = terms[0][0].shape[0]
    err = max([err] + [max_abs_err(g, w) for g, w in
                       zip(first_rule_terms(terms), first_rule_terms_plain(terms))])
    b_ms, b_by = bound(sum(nbytes(m, r) + 4 * b for m, r in terms),
                       sum(2 * m.numel() for m, _r in terms))
    shapes = " + ".join(f"[{m.shape[0]}, {m.shape[1]}] ({int(m.sum())} set)" for m, _r in terms)
    row("first_rule", "cilium_tpu_torch/csrc/first_rule.cu", "cilium_tpu/ops/verdict.py:224",
        err, lambda: first_rule_terms(terms), lambda: first_rule_terms_plain(terms), b_ms, b_by,
        f"{what}: {len(terms)} term(s) in one launch, mask {shapes}", graph=True)


def delta_rows(dl, row) -> None:
    """K2 and K6 at the shapes the patches give them, against their
    plain versions: the operands of one untimed identity row patch, one
    rule column patch and one attributed column patch, recorded as the
    pipeline calls the kernels; the largest of each kind is timed."""
    import torch

    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.ops.verdict import bool_mm, bool_mm_plain, first_rule_terms, first_rule_terms_plain

    step, reg, repo = dl["step"], dl["reg"], dl["repo"]
    dl["pipe"].set_attribution(False)
    dl["pipe"].rebuild()
    recs = {}
    for kind, mutate, attrib in (
        ("row patch", lambda: reg.allocate(parse_label_array(["k8s:app=a7", "k8s:env=updrec"])), False),
        ("column patch", lambda: repo.add_list([dl["l3_rule"]("delta-rec")]), False),
        ("attributed column patch", lambda: repo.add_list([dl["l3_rule"]("delta-rec-attr")]), True),
    ):
        if attrib:
            dl["pipe"].set_attribution(True)
            dl["pipe"].rebuild()
        with CallRecorder() as rec:
            got = step(mutate)
            if not got["kept"]:
                fail(f"deltas: the recorded {kind} did not patch in place")
        if len(rec.calls["bool_mm"]) != got["k2"] or len(rec.calls["first_rule_terms"]) != got["k6"]:
            fail(f"deltas: the {kind} recorded {len(rec.calls['bool_mm'])} K2 and "
                 f"{len(rec.calls['first_rule_terms'])} K6 calls of {got['k2']} and {got['k6']} "
                 "launches")
        recs[kind] = rec.calls
    for kind, calls in recs.items():
        k2 = calls["bool_mm"]
        if not k2:
            fail(f"deltas: the {kind} made no K2 call")
        err = 0
        for args, kw in k2:
            err = max(err, max_abs_err(bool_mm(*args, **kw), bool_mm_plain(*args, **kw)))
        (x, w, *rest), kw = max(k2, key=lambda c: c[0][0].numel() * c[0][1].shape[1])
        comp = bool(rest[0]) if rest else bool(kw.get("complement_x", False))
        k2_row(row, f"{kind}: {len(k2)} calls checked, timed", x, w, comp, err)
        k6 = calls["first_rule_terms"]
        if kind.startswith("attributed"):
            if not k6:
                fail("deltas: the attributed column patch made no K6 call")
            err = 0
            for a, k in k6:
                got_k6, want_k6 = first_rule_terms(*a, **k), first_rule_terms_plain(*a, **k)
                err = max([err] + [max_abs_err(g, w) for g, w in zip(got_k6, want_k6)])
            (terms,), _ = max(k6, key=lambda c: sum(m.numel() for m, _r in c[0][0]))
            mask, rule_of = max(terms, key=lambda mr: mr[0].numel())
            k6_row(row, f"{kind}: {len(k6)} calls checked, the widest term", [(mask, rule_of)], err)
            k6_row(row, f"{kind}: its {len(terms)}-term call", terms, err)


# the sparse-delta and epoch-swap phase (bench.py:2862-2877 ipcache churn,
# :2742-2753 epoch swap): churn samples per family, and flows a parity
# batch gives each churned address
SPARSE_SAMPLES = 20
SPARSE_LANES = 64
SPARSE_ORACLE = 20  # v4 flows held against the host oracle after each kind
GROW_PORT = 9443


def trie_builds(pipe):
    """Counts and times ``pipe``'s trie builds from now on: [calls, host
    seconds] (an instance attribute shadows the method)."""
    spent = [0, 0.0]
    inner = pipe._build_tries_locked

    def build(compiled):
        t0 = time.perf_counter()
        try:
            return inner(compiled)
        finally:
            spent[0] += 1
            spent[1] += time.perf_counter() - t0
    pipe._build_tries_locked = build
    return spent


class MatsRecorder:
    """Keeps the arguments of every ``_build_mats`` call of one pipeline
    (the shadow's and the synchronous sweep's) and the K2 launches made
    while the last call ran."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.calls = []
        self.k2 = []

    def __enter__(self):
        from cilium_tpu_torch import _kernels

        real = self.real = type(self.pipe)._build_mats

        def call(*args):
            self.calls.append(args)
            k0 = _kernels.launches()["bool_mm"]
            out = real(*args)
            self.k2.append(_kernels.launches()["bool_mm"] - k0)
            return out
        self.pipe._build_mats = call
        return self

    def __exit__(self, *exc):
        del self.pipe._build_mats


def sparse_main_path(seed: int, card: str):
    """Sparse trie deltas and the epoch swap on the card (bench.py:2862-2877
    and :2742-2753), on a bench world of its own: PolicyEngine(repo,
    reg).refresh() → DatapathPipeline(engine, cache, PreFilter(),
    sparse_deltas=True).rebuild(), launch counts from zero.

    - ipcache churn, 20 samples a family: cache.upsert of a new address
      under an existing identity, rebuild(), cache.delete, rebuild() — v4
      10.{hi}.{lo}.9 inside an existing /16 node (and one 172.16.0.9
      round, which takes a spare node), v6 fd00::{hi}:1{lo} (byte 14 = 1:
      new, inside the 13 elided bytes). rebuild() p50 / p99 with the
      mirrors (each churn a patch, the mirror objects kept, no trie
      build) and after set_sparse_deltas(False) (the full trie build);
      the trie scatter ops' calls, card ms and bytes per churn.
    - Fallbacks, each a full trie build that replaces the mirror: a v6
      address outside the elided fd00::/104; v4 /32s in new /16s until
      the 16-row node pool is spent; a churn on a pipeline with the
      bench prefilter (both deny sets live: nothing patched).
    - After each kind: process() / process_v6() of 1 048 576 flows whose
      first lanes carry the churned addresses == a fresh pipeline with
      sparse deltas off (verdicts and redirects), and the host oracle on
      20 v4 flows.
    - Epoch swap, round 1: set_epoch_swap(True), refresh(force=True);
      the wall from the kicking rebuild() to the publishing one, the
      publish timed apart (its trie build apart), beside a synchronous
      full rebuild of the same world.
    - Round 2: a rule giving endpoint 0's app port 9443/TCP (slot
      growth: the column patch refuses, the shadow sweeps) while v4
      1 048 576-flow batches are served until wait_epoch_swap() returns:
      their count and p50 against unloaded process(), the shadow's K2
      launches; batches before the publish == the pre-append verdicts,
      after it == a synchronous rebuild. Each round's shadow-built
      allow / redirect bitmaps and policymap words == a synchronous
      _build_mats of the same snapshot on the serving stream."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels, metrics
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.policy.api import (
        EndpointSelector, IngressRule, PortProtocol, PortRule, rule,
    )

    t_phase = time.perf_counter()
    repo, reg, cache, idents, labels_of = build_world(seed)
    ips, eps, dports, protos, i_sel = make_flows(seed + 400, len(idents))
    addr6, eps6, dports6, protos6, _ = make_flows6(seed + 400, len(idents))
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    _kernels.reset_launches()

    def prefilter(cidrs=()):
        pf = PreFilter()
        if cidrs:
            pf.insert(pf.revision, list(cidrs))
        return pf

    def pipeline(engine, pf, **kw):
        p = DatapathPipeline(engine, cache, pf, **kw)
        p.set_endpoints(endpoints)
        return p

    engine = PolicyEngine(repo, reg)
    engine.refresh()
    pipe = pipeline(engine, prefilter(), sparse_deltas=True)
    pipe.rebuild()
    torch.cuda.synchronize()
    p4, p6 = pipe._trie_patch[4], pipe._trie_patch[6]
    t4, t6 = pipe._tables[(0, 4)], pipe._tables[(0, 6)]
    if p4 is None or p6 is None:
        fail("sparse: the empty-prefilter pipeline built no trie mirror")
    if tuple(t4.ip_sub_info.shape) != (16, 65536) or len(p4._nodes) != 8:
        fail(f"sparse: v4 trie sub_info {tuple(t4.ip_sub_info.shape)} with {len(p4._nodes)} deep "
             f"nodes, expected [16, 65536] and 8")
    if t6.ip_common.shape[0] != 13:
        fail(f"sparse: the v6 trie elided {t6.ip_common.shape[0]} bytes, not 13")
    print(f"main path sparse: mirrors built, v4 flat trie sub_info {list(t4.ip_sub_info.shape)} "
          f"({len(p4._nodes)} deep nodes), v6 elided trie [{t6.ip_child.shape[0]}, 256] K "
          f"{t6.ip_common.shape[0]} ({len(p6._children)} nodes) [{card}]", flush=True)

    def sample(fam, i):
        """(address, identity index) of churn sample i."""
        j = (37 * i + 5) % len(idents)
        hi, lo = (j >> 8) & 255, j & 255
        if fam == 4:
            return ("172.16.0.9" if i == SPARSE_SAMPLES - 1 else f"10.{hi}.{lo}.9"), j
        return f"fd00::{hi:x}:1{lo:02x}", j

    builds = trie_builds(pipe)

    def patches(fam):
        return metrics.lpm_trie_patches_total.get({"family": str(fam)})

    def h2d():
        return metrics.device_transfer_bytes_total.get({"direction": "h2d"})

    def timed_rebuild(p):
        t0 = time.perf_counter()
        p.rebuild()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def churn(fam, sparse: bool):
        """20 upsert / delete rounds → rebuild seconds, mirror kept per
        round, trie scatter summaries and h2d bytes per churn."""
        secs, kept, clocks, moved = [], 0, [], []
        for i in range(SPARSE_SAMPLES):
            addr, j = sample(fam, i)
            mirror = pipe._trie_patch[fam] if sparse else None
            for mutate in (lambda: cache.upsert(addr, idents[j].id, source="k8s"),
                           lambda: cache.delete(addr, "k8s")):
                mutate()
                b0 = h2d()
                with trie_clock() as tc:
                    secs.append(timed_rebuild(pipe))
                clocks.append(tc.summary())
                moved.append(h2d() - b0)
            kept += sparse and pipe._trie_patch[fam] is mirror
        return secs, kept, clocks, moved

    # warm both families' patch paths once
    for fam in (4, 6):
        addr, j = f"10.0.0.9" if fam == 4 else "fd00::0:1ff", 0
        cache.upsert(addr, idents[j].id, source="k8s")
        pipe.rebuild()
        cache.delete(addr, "k8s")
        pipe.rebuild()
    builds[0] = 0
    results = {}
    for fam in (4, 6):
        n0, b0 = patches(fam), builds[0]
        secs, kept, clocks, moved = churn(fam, True)
        n_patch, n_build = patches(fam) - n0, builds[0] - b0
        if kept != SPARSE_SAMPLES or n_patch != 2 * SPARSE_SAMPLES or n_build:
            fail(f"sparse v{fam}: mirrors kept {kept}/{SPARSE_SAMPLES}, {n_patch} patches of "
                 f"{2 * SPARSE_SAMPLES}, {n_build} trie builds")
        results[fam] = (secs, kept, clocks, moved, n_patch)
    pipe.set_sparse_deltas(False)
    pipe.rebuild()
    dense = {}
    for fam in (4, 6):
        b0 = builds[0]
        dense[fam] = churn(fam, False)[0]
        if builds[0] - b0 != 2 * SPARSE_SAMPLES:
            fail(f"sparse off v{fam}: {builds[0] - b0} trie builds, expected {2 * SPARSE_SAMPLES}")
    pipe.set_sparse_deltas(True)
    pipe.rebuild()
    for fam in (4, 6):
        secs, kept, clocks, moved, n_patch = results[fam]
        p50, p99 = pcts(secs)
        d50, d99 = pcts(dense[fam])
        print(f"main path sparse [v{fam} ipcache churn] x{SPARSE_SAMPLES} upsert + delete: rebuild "
              f"p50 {p50!r} ms, p99 {p99!r} ms with the mirrors; with set_sparse_deltas(False) (the "
              f"full trie build) p50 {d50!r} ms, p99 {d99!r} ms; lpm_trie_patches_total"
              f"{{family=\"{fam}\"}} +{n_patch:g}, mirror objects kept {kept}/{SPARSE_SAMPLES}, trie "
              f"builds 0; h2d bytes per churn {sorted(set(int(x) for x in moved))} [{card}]", flush=True)
        for h in sorted({h for c in clocks for h in c}):
            per = [c.get(h, (0, 0.0, 0)) for c in clocks]
            ms = sorted(p[1] for p in per)
            nb = sorted({p[2] for p in per})
            print(f"main path sparse [v{fam} ipcache churn] scatter {h}: calls per churn "
                  f"{sorted({p[0] for p in per})}, card ms per churn median {median(ms)!r} (min "
                  f"{ms[0]!r}, max {ms[-1]!r}), bytes {nb[0]}-{nb[-1]}, bound "
                  f"{nb[-1] / HBM_BYTES_PER_S * 1e3!r} ms at the most bytes (bytes / 3.35 TB/s) "
                  f"[{card}]", flush=True)

    def parity(kind, p, live4=(), live6=(), cidrs=()):
        """p's 1M-flow v4 and v6 batches, the churned addresses in their
        first lanes, == a fresh pipeline with sparse deltas off; the host
        oracle on the first v4 flows → the batches' peer arrays."""
        t0 = time.perf_counter()
        f4 = [ips.copy(), eps, dports, protos]
        sel = i_sel.copy()
        for k, (addr, j) in enumerate(live4):
            lanes = np.arange(k, len(live4) * SPARSE_LANES, len(live4))
            f4[0][lanes] = int(ipaddress.IPv4Address(addr))
            sel[lanes] = j
        f6 = [addr6.copy(), eps6, dports6, protos6]
        for k, (addr, _j) in enumerate(live6):
            f6[0][np.arange(k, len(live6) * SPARSE_LANES, len(live6))] = np.frombuffer(
                ipaddress.IPv6Address(addr).packed, np.uint8)
        with uncounted():
            fresh = pipeline(engine, prefilter(cidrs))
            fresh.rebuild()
        v4 = None
        for call, flows in (("process", f4), ("process_v6", f6)):
            got = getattr(p, call)(*flows)
            with uncounted():
                want = getattr(fresh, call)(*flows)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                fail(f"sparse [{kind}]: {call} differs from a fresh dense pipeline")
            v4 = got[0] if v4 is None else v4
        denied = [ipaddress.ip_network(c) for c in cidrs if ":" not in c]
        oracle_check(repo, labels_of, idents, f"sparse [{kind}]", f4[0], eps, dports, protos, sel,
                     v4, denied, endpoints, n=SPARSE_ORACLE)
        print(f"main path sparse [{kind}]: process() / process_v6() of {BATCH} flows ({len(live4)} / "
              f"{len(live6)} churned addresses in {SPARSE_LANES} lanes each) == a fresh sparse-off "
              f"pipeline, host oracle on {SPARSE_ORACLE} v4 flows, in {time.perf_counter() - t0:.2f}s "
              f"[{card}]", flush=True)
        return f4[0], f6[0]

    # parity with every churn address live (one burst of 40, patched)
    live4 = [sample(4, i) for i in range(SPARSE_SAMPLES)]
    live6 = [sample(6, i) for i in range(SPARSE_SAMPLES)]
    n0 = patches(4) + patches(6)
    for addr, j in live4 + live6:
        cache.upsert(addr, idents[j].id, source="k8s")
    with trie_clock(by_shape=True) as tc:
        t_burst = timed_rebuild(pipe)
    if patches(4) + patches(6) - n0 != 2 * SPARSE_SAMPLES:
        fail("sparse: the burst of churned addresses was not patched")
    ops = tc.summary()
    print(f"main path sparse [burst of {2 * SPARSE_SAMPLES} upserts, one rebuild]: rebuild "
          f"{t_burst * 1e3!r} ms; trie scatter ops "
          f"{ {h: (c, round(ms, 4), b) for h, (c, ms, b) in sorted(ops.items())} } (calls, card ms, "
          f"bytes) [{card}]", flush=True)
    if any(c != 1 for c, _ms, _b in ops.values()):
        fail("sparse: the burst's flush made more than one op a tensor")
    # the patched tries, for K3 / K5 against their plain versions (a
    # patch never writes a published tensor, so these stay as they are)
    burst4, burst6 = pipe._tables[(0, 4)], pipe._tables[(0, 6)]
    peers4, peers6 = parity("ipcache churn", pipe, live4, live6)
    patched = [("v4 ipcache churn burst", 4, burst4, peers4),
               ("v6 ipcache churn burst", 6, burst6, peers6)]
    for addr, _j in live4 + live6:
        cache.delete(addr, "k8s")
    pipe.rebuild()

    def fallback(kind, fam, upserts):
        """Upserts that the mirror must refuse: a full trie build, a new
        mirror, no patch."""
        mirror, b0, n0 = pipe._trie_patch[fam], builds[0], patches(fam)
        for addr, j in upserts:
            cache.upsert(addr, idents[j].id, source="k8s")
        t = timed_rebuild(pipe)
        if builds[0] - b0 != 1 or pipe._trie_patch[fam] is mirror or patches(fam) != n0:
            fail(f"sparse [{kind}]: expected one full trie build and a new mirror")
        print(f"main path sparse [{kind}]: full trie build as expected, rebuild {t * 1e3!r} ms "
              f"[{card}]", flush=True)

    # a v6 address outside the 13 elided bytes
    out6 = ("fd00:1::9", 7)
    fallback("v6 elision violation", 6, [out6])
    if pipe._tables[(0, 6)].ip_common.shape[0] >= 13:
        fail("sparse: the elision violation kept 13 elided bytes")
    parity("v6 elision violation", pipe, live6=[out6])
    cache.delete(out6[0], "k8s")
    pipe.rebuild()

    # v4 /32s in new /16s until the 16-row pool is spent (row 0 is "no
    # node", so it holds 15 deep nodes)
    p4 = pipe._trie_patch[4]
    free = p4._cap_rows - 1 - len(p4._nodes)
    new16 = [(f"10.{200 + k}.0.9", k) for k in range(free + 1)]
    n0, b0 = patches(4), builds[0]
    for addr, j in new16[:free]:
        cache.upsert(addr, idents[j].id, source="k8s")
        pipe.rebuild()
    if patches(4) - n0 != free or builds[0] != b0 or pipe._trie_patch[4] is not p4:
        fail(f"sparse: {free} new /16s did not patch into the pool's spare rows")
    full4 = pipe._tables[(0, 4)]
    fallback("v4 node pool exhausted", 4, new16[free:])
    print(f"main path sparse [v4 node pool exhausted]: {free} new /16 nodes patched into the "
          f"{p4._cap_rows}-row pool, the next one full-built [{card}]", flush=True)
    peers4, _ = parity("v4 node pool exhausted", pipe, live4=new16)
    patched.append((f"v4 pool filled by patches ({len(p4._nodes)} deep nodes)", 4, full4, peers4))
    for addr, _j in new16:
        cache.delete(addr, "k8s")
    pipe.rebuild()

    # the prefilter pipeline: both deny sets live, so both families fuse
    # their walks and nothing is patched
    cidrs = PREFILTER_CIDRS + V6_DENY
    ppipe = pipeline(engine, prefilter(cidrs), sparse_deltas=True)
    ppipe.rebuild()
    if ppipe._trie_patch != {4: None, 6: None}:
        fail("sparse: the prefilter pipeline built a trie mirror")
    pb = trie_builds(ppipe)
    n0 = patches(4) + patches(6)
    churned = [sample(4, 0), sample(6, 0)]
    for addr, j in churned:
        cache.upsert(addr, idents[j].id, source="k8s")
    t = timed_rebuild(ppipe)
    if pb[0] != 1 or patches(4) + patches(6) != n0:
        fail("sparse: the prefilter pipeline patched a fused trie")
    print(f"main path sparse [prefilter pipeline churn]: full trie build, nothing patched, rebuild "
          f"{t * 1e3!r} ms [{card}]", flush=True)
    parity("prefilter pipeline churn", ppipe, [churned[0]], [churned[1]], cidrs)
    for addr, _j in churned:
        cache.delete(addr, "k8s")
    pipe.rebuild()

    def hold_shadow(rec, kind):
        """The installed state == a synchronous sweep of the shadow's
        snapshot on the serving stream, bit for bit."""
        with uncounted():
            sync = rec.real(*rec.calls[-1])
        for d in (0, 1):
            m, s = pipe._mat[d], sync[d]
            if not (np.array_equal(m.allow_nc, s.allow_nc) and np.array_equal(m.red_nc, s.red_nc)):
                fail(f"epoch swap [{kind}]: direction {d} allow / redirect bitmaps differ from a sync sweep")
            if max_abs_err(m.tables.id_bits, s.tables.id_bits):
                fail(f"epoch swap [{kind}]: direction {d} policymap words differ from a sync sweep")

    # -- epoch swap, round 1: a forced refresh ---------------------------
    swaps0 = metrics.engine_epoch_swaps_total.get()
    pipe.set_epoch_swap(True)
    with MatsRecorder(pipe) as rec:
        t0 = time.perf_counter()
        engine.refresh(force=True)
        engine.wait_device()
        t_refresh = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipe.rebuild()
        t_kick = time.perf_counter() - t0
        if not pipe.wait_epoch_swap(300):
            fail("epoch swap: the forced refresh's shadow did not finish")
        t_wait = time.perf_counter() - t0
        b0 = builds[1]
        t1 = time.perf_counter()
        pipe.rebuild()
        torch.cuda.synchronize()
        t_pub = time.perf_counter() - t1
        wall = time.perf_counter() - t0
        t_pub_tries = builds[1] - b0
    if pipe.policy_epoch != 1 or metrics.engine_epoch_swaps_total.get() - swaps0 != 1:
        fail(f"epoch swap: policy_epoch {pipe.policy_epoch} after the forced refresh")
    if len(rec.calls) != 1 or not rec.k2[0]:
        fail("epoch swap: the forced refresh's shadow made no sweep on K2")
    hold_shadow(rec, "forced refresh")
    with uncounted():
        pipe.set_epoch_swap(False)
        engine.refresh(force=True)
        engine.wait_device()
        t_sync = timed_rebuild(pipe)
    print(f"main path epoch swap [forced refresh]: refresh {t_refresh * 1e3!r} ms; kicking rebuild "
          f"{t_kick * 1e3!r} ms, shadow done {t_wait * 1e3!r} ms after the kick (K2 {rec.k2[0]} "
          f"launches on its stream), publishing rebuild {t_pub * 1e3!r} ms (of it the trie build "
          f"{t_pub_tries * 1e3!r} ms); wall kick to publish {wall * 1e3!r} ms; the synchronous full "
          f"rebuild of the same world {t_sync * 1e3!r} ms; shadow state == a synchronous sweep of its "
          f"snapshot [{card}]", flush=True)

    # -- round 2: a rule append that grows endpoint 0's slot set ---------
    grow = (ips, eps, np.where(eps == 0, GROW_PORT, dports).astype(np.int32),
            np.where(eps == 0, 6, protos).astype(np.int32))
    pre = pipe.process(*grow)
    unloaded = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.process(*grow)
        unloaded.append(time.perf_counter() - t0)
    app = next(x for x in labels_of[endpoints[0]] if x.startswith("k8s:app="))
    repo.add_list([rule([app], ingress=[IngressRule(
        from_endpoints=tuple(EndpointSelector.make([f"k8s:zone=z{z}"]) for z in range(4)),
        to_ports=(PortRule(ports=(PortProtocol(GROW_PORT, "TCP"),)),))],
        labels=["k8s:policy=sparse-grow"])])
    engine.refresh()
    engine.wait_device()
    pipe.set_epoch_swap(True)
    old_pm = pipe._tables[(0, 4)].policymap
    served = []
    with MatsRecorder(pipe) as rec:
        t0 = time.perf_counter()
        pipe.rebuild()  # the column patch refuses: the shadow sweeps
        shadow = pipe._shadow_thread
        if shadow is None or pipe.policy_epoch != 1:
            fail("epoch swap: the slot-growth append kicked no shadow")
        # (batch seconds, published, outputs, its trie-build seconds)
        def serve():
            b0 = builds[1]
            t1 = time.perf_counter()
            out = pipe.process(*grow)
            served.append((time.perf_counter() - t1, pipe._tables[(0, 4)].policymap is not old_pm,
                           out, builds[1] - b0))
        while shadow.is_alive():
            serve()
        if not pipe.wait_epoch_swap(300):
            fail("epoch swap: the slot-growth shadow did not finish")
        t_wait = time.perf_counter() - t0
        serve()  # publishes, unless a batch in the loop already did
        wall = time.perf_counter() - t0
    if pipe.policy_epoch != 2 or len(rec.calls) != 1:
        fail(f"epoch swap: policy_epoch {pipe.policy_epoch} after the slot-growth append")
    hold_shadow(rec, "slot growth")
    with uncounted():
        fresh = pipeline(engine, prefilter())
        fresh.rebuild()
        post = fresh.process(*grow)
    if np.array_equal(pre[0], post[0]):
        fail("epoch swap: the 9443/TCP append changed no verdict")
    before = [s for s in served if not s[1]]
    if not before or not served[-1][1]:
        fail(f"epoch swap: {len(before)} batches served before the publish, last published {served[-1][1]}")
    t_pub, _, _, t_pub_tries = served[len(before)]
    for _dt, published, out, _tries in served:
        want = post if published else pre
        if not all(np.array_equal(a, b) for a, b in zip(out, want)):
            fail(f"epoch swap: a batch served {'after' if published else 'before'} the publish differs "
                 f"from the {'synchronous rebuild' if published else 'pre-append verdicts'}")
    during = [s[0] for s in before]
    u50, _ = pcts(unloaded)
    s50, s99 = pcts(during)
    pipe.set_epoch_swap(False)
    print(f"main path epoch swap [slot growth, {GROW_PORT}/TCP]: {len(during)} v4 {BATCH}-flow "
          f"batches served during the shadow (p50 {s50!r} ms, p99 {s99!r} ms; unloaded process() p50 "
          f"{u50!r} ms), all == the pre-append verdicts; the batch after the publish == a synchronous "
          f"rebuild; shadow K2 launches {rec.k2[0]}; kick to shadow done {t_wait * 1e3!r} ms; the "
          f"batch that publishes (batch {len(before) + 1} of {len(served)}) {t_pub * 1e3!r} ms (of it "
          f"the trie build {t_pub_tries * 1e3!r} ms); kick to the last batch {wall * 1e3!r} ms; "
          f"shadow state == a synchronous sweep of its snapshot [{card}]", flush=True)
    print(f"main path sparse: {time.perf_counter() - t_phase:.2f}s for the phase [{card}]", flush=True)
    return dict(pipe=pipe, patched=patched)


def sparse_rows(sp, dev, row) -> None:
    """K3 lpm_wide and K5 lpm_stride8 on the tries the mirrors patched
    (the v4 pool: sub_info [16, 65536] with spare zero rows, or filled by
    patches; the v6 elided [cap, 256] pool) over the sparse phase's 1M-flow
    batches, whose first lanes carry the churned addresses."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.lpm import (
        elided_lookup, lpm_lookup_wide, lpm_stride8_plain, lpm_wide_plain,
    )

    for kind, fam, t, peers in sp["patched"]:
        if fam == 4:
            peer = torch.from_numpy(peers.view(np.int32)).to(dev)
            tabs = [getattr(t, f"ip_{f}") for f in ("root_info", "root_child", "sub_child", "sub_info")]
            b_ms, b_by = bound(lpm_touched_bytes(tabs[0], tabs[1], tabs[3], peer), 0)
            row("lpm_wide", "cilium_tpu_torch/csrc/lpm_wide.cu", "cilium_tpu/ops/lpm.py:346",
                max_abs_err(lpm_lookup_wide(*tabs, peer), lpm_wide_plain(*tabs, peer)),
                lambda tabs=tabs, peer=peer: lpm_lookup_wide(*tabs, peer),
                lambda tabs=tabs, peer=peer: lpm_wide_plain(*tabs, peer), b_ms, b_by,
                f"{BATCH} addresses, patched ip trie ({kind}) sub_info {list(tabs[3].shape)}",
                graph=True)
        else:
            peer = torch.from_numpy(peers).to(dev)
            tabs = [getattr(t, f"ip_{f}") for f in ("child", "info", "common")]
            b_ms, b_by = bound(stride8_touched_bytes(*tabs, peer, 16), 0)
            row("lpm_stride8", "cilium_tpu_torch/csrc/lpm_stride8.cu", "cilium_tpu/ops/lpm.py:144",
                max_abs_err(elided_lookup(*tabs, peer, 16), lpm_stride8_plain(*tabs, peer, 16)),
                lambda tabs=tabs, peer=peer: elided_lookup(*tabs, peer, 16),
                lambda tabs=tabs, peer=peer: lpm_stride8_plain(*tabs, peer, 16), b_ms, b_by,
                f"{BATCH} addresses, patched ip trie ({kind}) [{tabs[0].shape[0]}, 256], "
                f"K {tabs[2].shape[0]}", graph=True)


MESH_GRID = 4  # virtual device records on one card: 2 flows x 2 ident
MESH_SLICE = 1 << 14  # flows of each check held against the CPU plain path
MESH_ORACLE = 20  # v4 flows held against the host oracle after the rule append


def mesh_main_path(seed: int, card: str, dev=None):
    """Multi-device placement on the card, on a bench world of its own:
    PolicyEngine(repo, reg).refresh() → DatapathPipeline(engine, cache,
    PreFilter(), sharding=True, mesh_2d=True), launch counts from zero.

    - The real one-card plan: placement.visible_devices() lists one card,
      so resolve_plan forms no grid (the reference's ``want_mesh =
      sharding and n > 1``); a 1 048 576-flow process() launches no K12.
    - The seam placement.visible_devices gives four records on cuda:0: a
      2 flows x 2 ident grid. rebuild() (the sweeps read the
      ident-sharded sel_match through K12), v4 and v6 1 048 576-flow
      process() (each flow shard 524 288 flows in one K4 launch that
      reads every row in place from the ident shard owning it, both
      shards on the card: 2 K4 and no K12 a batch or the phase fails), a
      depth-2 submit() of three v4 batches, one identity add (row patch
      into the placed copies; with sparse_deltas the ident-sharded
      sel_match takes _scatter_sel_rows) and one rule append (column
      patch; _scatter_sel_cols for its new selector), then
      attribution on (the attributed sweep and the rule rows gathered
      too) and one attributed batch of each family.
    - Every result == the unplaced card pipeline over the same engine
      (its runs uncounted) and, on MESH_SLICE flows, the CPU plain path
      (device="cpu", unplaced); after the rule append 20 v4 flows ==
      the host oracle. K4 and K12 launches per v4 batch (and K4's
      attribution entry per attributed batch) and the wall of the 2D
      process() beside the unplaced one.

    ``dev`` is the device of the four records (None: cuda:0; a CPU
    rehearsal passes the CPU)."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath import placement
    from cilium_tpu_torch.datapath.pipeline import TRAFFIC_INGRESS, DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.ops import lookup
    from cilium_tpu_torch.ops.lpm import lpm_lookup_wide
    from cilium_tpu_torch.policy.api import EndpointSelector, IngressRule, rule

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else dev
    repo, reg, cache, idents, labels_of = build_world(seed)
    flows4 = make_flows(seed + 500, len(idents))
    flows6 = make_flows6(seed + 500, len(idents))
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    _kernels.reset_launches()
    engine = PolicyEngine(repo, reg)
    engine.refresh()
    cpu_engine = PolicyEngine(repo, reg, device="cpu")

    def pipeline(eng, **kw):
        p = DatapathPipeline(eng, cache, PreFilter(), **kw)
        p.set_endpoints(endpoints)
        return p

    def k12():
        return _kernels.launches()["ident_gather"]

    def k4(entry="policymap_verdict"):
        return _kernels.launches()[entry]

    def same(tag, got, want, n=None):
        for g, w in zip(got, want):
            if not np.array_equal(g, w if n is None else w[:n]):
                bad = int(np.argmax(g != (w if n is None else w[:n])))
                fail(f"mesh {tag}: differs at flow {bad}")

    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with uncounted():
        ref = pipeline(engine)
        ref.rebuild()
        want4 = ref.process(*flows4[:4])
        want6 = ref.process_v6(*flows6[:4])
        t_refs = sorted(wall(lambda: ref.process(*flows4[:4]))[1] for _ in range(3))
        t_ref = median(t_refs)
    cpu = pipeline(cpu_engine, device="cpu")
    s = slice(0, MESH_SLICE)

    # the real seam: one card, so no grid, and no K12
    one = pipeline(engine, sharding=True, mesh_2d=True)
    one.rebuild()
    same("one-card plan v4", one.process(*flows4[:4]), want4)
    st = one.placement_state()
    if one._plan.mesh is not None or st["axes"] or one._placed is not None or k12():
        fail(f"mesh: the one-card plan formed a grid {st} or launched K12 ({k12()})")
    print(f"main path mesh [one card]: placement {st}; process {BATCH} flows == unplaced, "
          f"K12 launches 0 [{card}]", flush=True)

    real_seam = placement.visible_devices
    placement.visible_devices = lambda: [
        placement.DeviceRecord(i, 0, dev) for i in range(MESH_GRID)]
    try:
        pipe = pipeline(engine, sharding=True, mesh_2d=True, pipeline_depth=2,
                        sparse_deltas=True)
        # the sweeps' K12 calls (their sel_match reads) recorded for mesh_rows
        with CallRecorder([(lookup, "ident_gather_shards")], keep=1 << 14) as rec_sweep:
            (_, t_rebuild) = wall(lambda: (pipe.rebuild(), torch.cuda.synchronize()))
        st = pipe.placement_state()
        if st["axes"] != {"flows": 2, "ident": 2} or not pipe._placed.ident2d:
            fail(f"mesh: the virtual grid resolved to {st}")
        pm = pipe._placed_pm[TRAFFIC_INGRESS][2]
        if not isinstance(pm.id_bits, lookup.IdentSharded):
            fail("mesh: the placed policymap is not ident-sharded")
        n0, k4_0 = k12(), k4()
        times, outs = [], []
        for _ in range(3):
            out, t = wall(lambda: pipe.process(*flows4[:4]))
            times.append(t)
            outs.append(out)
        per_batch = (k12() - n0) // 3
        k4_per_batch = (k4() - k4_0) // 3
        # one K4 launch a flow shard over both ident shards, which lie on
        # the one card: no gather
        flow_shards = len(pipe._placed.rows)
        if k12() - n0 or k4() - k4_0 != 3 * flow_shards:
            fail(f"mesh: 3 v4 batches launched {k12() - n0} K12 and {k4() - k4_0} K4, expected "
                 f"0 and {3 * flow_shards} (one K4 a flow shard)")
        for out in outs:
            same("v4", out, want4)
        got6, t6 = wall(lambda: pipe.process_v6(*flows6[:4]))
        same("v6", got6, want6)
        for fam, call, flows, got in (("v4", "process", flows4, outs[0]),
                                      ("v6", "process_v6", flows6, got6)):
            same(f"{fam} CPU slice", getattr(cpu, call)(*(a[s] for a in flows[:4])), got, MESH_SLICE)
        n_rows, w = pm.id_bits.shape
        print(f"main path mesh [2 flows x 2 ident on one card]: placement {st}; rebuild "
              f"{t_rebuild!r}s; id_bits [{n_rows}, {w}] in shards of {pm.id_bits.shards[0][0].rows} "
              f"rows; process {BATCH} flows {times}s, median {median(sorted(times))!r}s against "
              f"unplaced {t_refs}s, median {t_ref!r}s ({median(sorted(times)) / t_ref!r}x), "
              f"process_v6 {t6!r}s; "
              f"per v4 batch K4 launches {k4_per_batch} (one a flow shard, rows read in place "
              f"from both ident shards) and K12 {per_batch}; == unplaced card pipeline and the "
              f"CPU path on {MESH_SLICE} flows [{card}]", flush=True)

        # depth-2 submit: three v4 batches in flight
        batches = [tuple(np.roll(a, 7919 * k) for a in flows4[:4]) for k in range(3)]
        pend = [pipe.submit(*b) for b in batches]
        got = [h.result() for h in pend]
        with uncounted():
            for b, g in zip(batches, got):
                same("depth-2 submit", g, ref.process(*b))

        # one identity add: its address on the first lanes of the batch
        ident = reg.allocate(parse_label_array(["k8s:app=a1", "k8s:zone=z3", "k8s:env=prod"]))
        labels_of[ident.id] = ["k8s:app=a1", "k8s:zone=z3", "k8s:env=prod"]
        cache.upsert("10.250.9.1/32", ident.id, source="k8s")
        engine.refresh()
        kept = dict(pipe._mat)
        with sel_clock() as oc:
            _, t_add = wall(lambda: (pipe.rebuild(), torch.cuda.synchronize()))
        sel_ops = {"identity add": oc.summary()}
        if any(pipe._mat[d] is not m for d, m in kept.items()):
            fail("mesh: the identity add re-materialized instead of patching")
        b4 = list(a.copy() for a in flows4[:4])
        b4[0][:8192:2] = int(ipaddress.IPv4Address("10.250.9.1"))
        # this batch's K4 calls on the shard lists (and any K12 call: none)
        # recorded for mesh_rows
        with CallRecorder([(lookup, "policymap_verdict_shards"),
                           (lookup, "ident_gather_shards")]) as rec_v4:
            got = pipe.process(*b4)
        with uncounted():
            same("identity add", got, ref.process(*b4))
        same("identity add CPU slice", cpu.process(*(a[s] for a in b4)), got, MESH_SLICE)

        # one rule append on endpoint 0's app: a column patch
        app = next(lb for lb in labels_of[endpoints[0]] if lb.startswith("k8s:app="))
        repo.add_list([rule([app], ingress=[IngressRule(
            from_endpoints=(EndpointSelector.make(["k8s:zone=z3", "k8s:env=prod"]),))])])
        engine.refresh()
        kept = dict(pipe._mat)
        with sel_clock() as oc:
            _, t_rule = wall(lambda: (pipe.rebuild(), torch.cuda.synchronize()))
        sel_ops["rule append"] = oc.summary()
        if any(pipe._mat[d] is not m for d, m in kept.items()):
            fail("mesh: the rule append re-materialized instead of patching")
        # the placed sel_match was patched (rows, then cells), not re-placed
        _gen, src_sel, placed_sel = pipe._placed_sel
        if (src_sel is not engine.snapshot()[1].sel_match or not torch.equal(
                torch.cat([x.tensor for x in placed_sel.shards[0]]), src_sel)):
            fail("mesh: the ident-sharded sel_match left the engine's")
        if "_scatter_sel_rows" not in sel_ops["identity add"] or \
                "_scatter_sel_cols" not in sel_ops["rule append"]:
            fail(f"mesh: the selector scatters did not run: {sel_ops}")
        got = pipe.process(*b4)
        with uncounted():
            same("rule append", got, ref.process(*b4))
        same("rule append CPU slice", cpu.process(*(a[s] for a in b4)), got, MESH_SLICE)
        i_sel = np.where(b4[0] == int(ipaddress.IPv4Address("10.250.9.1")), len(idents), flows4[4])
        oracle_check(repo, labels_of, idents + [ident], "mesh rule append", b4[0], b4[1], b4[2],
                     b4[3], i_sel, got[0], [], endpoints, n=MESH_ORACLE)
        for d, m in pipe._mat.items():
            held = pipe._placed_pm[d]
            if held[1] is not m.tables or not torch.equal(
                    torch.cat([x.tensor for x in held[2].id_bits.shards[0]]), m.tables.id_bits):
                fail("mesh: the placed id_bits left the patched tables")
        print(f"main path mesh: identity add rebuild {t_add!r}s, rule append rebuild {t_rule!r}s "
              f"(patched in place, the placed copies with them); the placed sel_match's "
              f"scatters (calls, card ms, bytes) {sel_ops}; depth-2 submit of 3 batches, both == "
              f"unplaced; rule append == host oracle on {MESH_ORACLE} flows [{card}]", flush=True)

        # attribution: the attributed sweep and the rule rows gathered
        pipe.set_attribution(True)
        _, t_attr = wall(lambda: (pipe.rebuild(), torch.cuda.synchronize()))
        with uncounted():
            ref.set_attribution(True)
            ref.rebuild()
        for fam, call, flows in (("v4", "process", b4), ("v6", "process_v6", flows6[:4])):
            deltas = []
            outs = []
            for p_, counted in ((pipe, True), (ref, False)):
                before = metric_series()
                if counted:
                    a0 = k4("policymap_verdict_attrib")
                    with CallRecorder([(lookup, "policymap_verdict_shards")]) as rec:
                        outs.append(getattr(p_, call)(*flows))
                    if k4("policymap_verdict_attrib") - a0 != flow_shards:
                        fail(f"mesh: an attributed {fam} batch launched "
                             f"{k4('policymap_verdict_attrib') - a0} K4, expected {flow_shards}")
                    if fam == "v4":
                        rec_attr = rec
                else:
                    with uncounted():
                        outs.append(getattr(p_, call)(*flows))
                deltas.append(metric_delta(before, metric_series()))
            same(f"attributed {fam}", *outs)
            if deltas[0] != deltas[1] or not deltas[0]:
                fail(f"mesh attributed {fam}: metric deltas differ from the unplaced pipeline")
        print(f"main path mesh: attributed rebuild {t_attr!r}s; one attributed batch of each "
              f"family == unplaced (verdicts, redirects, rule-hit and drop-reason deltas), "
              f"{flow_shards} K4 attribution launches each [{card}]", flush=True)
    finally:
        placement.visible_devices = real_seam

    # K12's inputs for its kernel row: the first 16 384-lane block of the
    # v4 batch's peer rows (the identity walk on grid row 0's tries)
    t = pipe._placed.rows[0][1][(TRAFFIC_INGRESS, 4)]
    peer = torch.from_numpy(b4[0].view(np.int32)).to(dev)
    with uncounted():
        hit = lpm_lookup_wide(t.ip_root_info, t.ip_root_child, t.ip_sub_child, t.ip_sub_info, peer)
    src = torch.where(hit > 0, hit - 1, t.world_row).to(torch.int32)[:16384].contiguous()
    print(f"mesh phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    if not rec_sweep.calls["ident_gather_shards"] or \
            len(rec_v4.calls["policymap_verdict_shards"]) != flow_shards or \
            len(rec_attr.calls["policymap_verdict_shards"]) != flow_shards:
        fail("mesh: the sweeps made no K12 call, or a recorded batch did not make one K4 "
             "shard-list call a flow shard")
    if rec_v4.calls["ident_gather_shards"]:
        fail("mesh: a 2D v4 batch gathered its rows through K12")
    return {"pm": pipe._placed_pm[TRAFFIC_INGRESS][2].id_bits,
            "full": pipe._mat[TRAFFIC_INGRESS].tables.id_bits, "src": src, "per_batch": per_batch,
            "k4_per_batch": k4_per_batch, "sel": engine.snapshot()[1].sel_match,
            "k12_sweep": rec_sweep.calls["ident_gather_shards"],
            "k4": rec_v4.calls["policymap_verdict_shards"],
            "k4_attrib": rec_attr.calls["policymap_verdict_shards"]}


def mesh_rows(ms, row) -> None:
    """The mesh phase's kernels at the shapes its main path gave them,
    against their plain versions, exactly:

    - K12 ident_gather over both ident shards of grid row 0's placed
      ingress id_bits ([N/2, 2W] each, one launch, as the several-device
      route makes it) and a 16 384-lane block of the v4 batch's peer rows;
      the library yardstick is torch.index_select on the whole table;
    - every recorded K12 call: the sweeps' sel_match reads of the first
      2D rebuild (a 2D batch makes none); the largest is timed
      (index_select on the engine's whole sel_match the yardstick);
    - every recorded K4 call over a shard list in gathered mode (a whole
      524 288-flow shard of a 2D batch, rows read from both ident
      shards): one v4 batch's and one attributed v4 batch's, against
      policymap_verdict_shards_plain; one of each is timed on both
      clocks.

    K12 and its yardstick are timed on both clocks (CUDA events around
    back-to-back wrapper calls, and the same calls replayed from a CUDA
    graph, which leaves out the wrapper's host work). The bound counts
    each output written once, the ids read once, and the distinct rows
    the data reaches (a repeated id is one row read)."""
    import torch

    from cilium_tpu_torch.ops.lookup import (
        ident_gather_shards, ident_gather_shards_plain, policymap_verdict_shards,
        policymap_verdict_shards_plain,
    )

    def k12_bound(shards, src):
        b, w = src.shape[0], shards[0].tensor.shape[1]
        n = sum(int(torch.unique(src[(src >= s.row_lo) & (src < s.row_lo + s.rows)]).numel())
                for s in shards)
        return bound(b * w * 4 + n * w * 4 + b * 4, 0) + (n,)

    src = ms["src"]
    src64 = src.long()
    full = ms["full"]
    shards = list(ms["pm"].shards[0])
    b_ms, b_by, n = k12_bound(shards, src)
    row("ident_gather", "cilium_tpu_torch/csrc/ident_gather.cu",
        "cilium_tpu/ops/lookup.py:115",
        max_abs_err(ident_gather_shards(shards, src), ident_gather_shards_plain(shards, src)),
        lambda: ident_gather_shards(shards, src), lambda: ident_gather_shards_plain(shards, src),
        b_ms, b_by,
        f"{src.shape[0]} lanes over {len(shards)} shards of [{full.shape[0]}, {full.shape[1]}] in "
        f"one launch, {n} distinct owned rows; {ms['per_batch']} launches per 2D v4 batch",
        lib_fn=lambda: full.index_select(0, src64), graph=True)

    err = 0
    for args, kw in ms["k12_sweep"]:
        err = max(err, max_abs_err(ident_gather_shards(*args, **kw),
                                   ident_gather_shards_plain(*args, **kw)))
    if err:
        fail(f"mesh: a recorded ident_gather call differs from its plain version by {err}")
    (s_shards, s_src), _ = max(ms["k12_sweep"], key=lambda c: c[0][1].numel())
    s_shards = list(s_shards)
    b_ms, b_by, n = k12_bound(s_shards, s_src)
    sel, s64 = ms["sel"], s_src.long()
    row("ident_gather", "cilium_tpu_torch/csrc/ident_gather.cu", "cilium_tpu/ops/lookup.py:115",
        err, lambda: ident_gather_shards(s_shards, s_src),
        lambda: ident_gather_shards_plain(s_shards, s_src), b_ms, b_by,
        f"sweep sel_match read: {s_src.shape[0]} ids over {len(s_shards)} shards of "
        f"[{sel.shape[0]}, {sel.shape[1]}] in one launch, {n} distinct owned rows; "
        f"{len(ms['k12_sweep'])} sweep calls checked",
        lib_fn=lambda: sel.index_select(0, s64), graph=True)

    for kind, name, replaces in (("k4", "policymap_verdict", "cilium_tpu/ops/lookup.py:146"),
                                 ("k4_attrib", "policymap_verdict_attrib",
                                  "cilium_tpu/ops/lookup.py:202")):
        calls = ms[kind]
        err = 0
        for args, kw in calls:
            got = policymap_verdict_shards(*args, **kw)
            want = policymap_verdict_shards_plain(*args, **kw)
            err = max([err] + [max_abs_err(a, b) for a, b in zip(got, want) if a is not None])
        if err:
            fail(f"mesh: a recorded shard-list {name} call differs from its plain version")
        args, kw = calls[0]
        out = policymap_verdict_shards(*args, **kw)
        pm, shards, src_rows, ep = args[0], args[1], args[2], args[3]
        moved = nbytes(*(sh.tensor for sh in shards), pm.col_ep, pm.col_port, pm.col_proto,
                       pm.col_is_l3, *args[2:6],
                       *(x for x in (kw.get("denied_pf"),) + tuple(out) if x is not None))
        note = ""
        if kw.get("rule_shards") is not None:
            # rule_tab cells read: one per distinct (row, endpoint) of the
            # flows a rule decided
            decided = out[3] >= 0
            eps = int(kw.get("ep_count") or N_ENDPOINTS)
            cells = torch.unique(src_rows.long()[decided] * eps + ep.long()[decided]).numel()
            moved += 4 * cells
            note = f", rule_tab in {len(kw['rule_shards'])} shards, {cells} rule cells read"
        b_ms, b_by = bound(moved, 0)
        row(name, "cilium_tpu_torch/csrc/policymap_verdict.cu", replaces, err,
            lambda args=args, kw=kw: policymap_verdict_shards(*args, **kw),
            lambda args=args, kw=kw: policymap_verdict_shards_plain(*args, **kw), b_ms, b_by,
            f"a 2D flow shard in one launch: {src_rows.shape[0]} flows, id_bits in "
            f"{len(shards)} shards of {[list(sh.tensor.shape) for sh in shards]} read in place "
            f"(gathered mode){note}; {len(calls)} calls of one 2D v4 batch checked, "
            f"{ms['k4_per_batch']} K4 launches per 2D v4 batch", plain_iters=1, reps=3, graph=True)


FAILSAFE_CUT = 1 << 16  # flows of the host rung's batches: it walks the ipcache per flow in Python
FAILSAFE_STALL_MS = 50.0  # the watchdog's budget in the stall case
FAILSAFE_REPS = 3  # rounds of the quiet-hub and per-site cases
SPIN_CYCLES = 2_000_000_000  # torch.cuda._sleep clocks: about 1 s at the H100's 1.98 GHz


def device_spin(cycles: int) -> None:
    """Queue a spin of ``cycles`` SM clocks on the current CUDA stream:
    whatever is queued after it there, a batch's copies and its event
    too, waits on the card."""
    import torch

    torch.cuda._sleep(cycles)


class FailsafeWatch:
    """Every DatapathPipeline the script makes (weakly held), and every
    quarantine and ladder move any of them makes. Pipelines the failsafe
    phase makes for its faults go into ``allowed``; anywhere else a
    quarantine, a ladder move or a pipeline_faults_total move is a fault
    nobody injected, and ``check`` fails the run."""

    def __init__(self) -> None:
        import weakref

        from cilium_tpu_torch import metrics
        from cilium_tpu_torch.datapath.pipeline import DatapathPipeline, _MODE_NAMES

        self.pipes = weakref.WeakSet()
        self.allowed = weakref.WeakSet()
        self.quarantines = {True: 0, False: 0}  # allowed → count
        self.moves = {True: 0, False: 0}
        self.faults0 = dict(metrics.pipeline_faults_total.series())
        cls, watch = DatapathPipeline, self
        real_init, real_q, real_set = cls.__init__, cls._quarantine, cls._set_level

        def init(pipe, *a, **k):
            real_init(pipe, *a, **k)
            watch.pipes.add(pipe)

        def quarantine(pipe, inf):
            watch.quarantines[pipe in watch.allowed] += 1
            return real_q(pipe, inf)

        def set_level(pipe, level):
            if max(0, min(len(_MODE_NAMES) - 1, int(level))) != pipe._ladder_level:
                watch.moves[pipe in watch.allowed] += 1
            return real_set(pipe, level)

        cls.__init__, cls._quarantine, cls._set_level = init, quarantine, set_level

    def check(self, label: str, faults_expected: float = 0.0) -> None:
        """Every pipeline outside the failsafe phase at level 0 with no
        quarantine, no quarantine or ladder move outside it, and
        pipeline_faults_total (but its queue_full series) moved by
        exactly ``faults_expected`` (the failsafe phase's injected and
        real faults)."""
        from cilium_tpu_torch import metrics

        others = [p for p in self.pipes if p not in self.allowed]
        for p in others:
            st = p.failsafe_state()
            if st["level"] or st["quarantined_batches"] or st["breaker_faults"]:
                fail(f"failsafe watch [{label}]: a pipeline of another phase ended at {st}")
        if self.quarantines[False] or self.moves[False]:
            fail(f"failsafe watch [{label}]: {self.quarantines[False]} quarantines and "
                 f"{self.moves[False]} ladder moves outside the failsafe phase")
        # the submit phase forces the admission gate through the hub's
        # queue_full site: an overload signal, not a fault
        def faults(series):
            return sum(v for k, v in series.items() if ("site", "queue_full") not in k)

        now = dict(metrics.pipeline_faults_total.series())
        moved = faults(now) - faults(self.faults0)
        if moved != faults_expected:
            fail(f"failsafe watch [{label}]: pipeline_faults_total moved by {moved}, expected "
                 f"{faults_expected} ({metric_delta(self.faults0, now)})")
        print(f"failsafe watch [{label}]: {len(others)} pipelines of the other phases at level 0 "
              f"with no quarantine and no breaker fault; quarantines / ladder moves outside the "
              f"failsafe phase 0 / 0, inside it {self.quarantines[True]} / {self.moves[True]}; "
              f"pipeline_faults_total moved by {moved} (expected {faults_expected})", flush=True)


def failsafe_main_path(engine, cache, endpoints, flows4, flows6, seed: int, card: str, watch,
                       dev=None):
    """The failsafe on the card, on the bench world the script built
    (its engine, ipcache, endpoints and 1 048 576-flow batches), every
    pipeline with the prefilter CIDRs and registered in ``watch.allowed``:

    1. the hub armed but quiet: v4 and v6 batches bit-identical to the
       hub off (verdicts, redirects, counters, per-kernel launches),
       FAILSAFE_REPS of each in turns;
    2. each site fired once, v4 and v6 (h2d, dispatch, complete; the
       breaker threshold raised, the ladder is case 3's), in
       FAILSAFE_REPS rounds: a transient is invisible, a poisoned one
       gives DROP_DEGRADED and one quarantine and the next batch equals
       the clean one; three
       transients at complete quarantine; ct_epoch on a host-CT
       pipeline over a copy of the ipcache (FAILSAFE_CUT flows, a basis
       move by an unrelated /32 upsert);
    3. the ladder on four virtual records on the card (sharding=True,
       breaker_threshold 2, recover_after_clean 3): level 1 excludes
       records 1-3 and equals level 0, level 2 launches no K3 / K4 / K5
       and equals the device verdicts on FAILSAFE_CUT flows of each
       family, clean streaks climb to 0 and the launches return;
    4. the device-CT rescue (device_ct_bits=CT_BITS): a 1M-flow pass
       fills K10, a poisoned completion on a batch without sports
       quarantines, the rescue pulls up to device_ct_rescue_limit
       entries into the host CT, and the next device-CT pass seeds its
       table from it: exactly the rescued flows come back established;
    5. a real device stall under the watchdog (stall_ms 50): a spin
       ahead of a full rebuild shows one compile stall, and a spin ahead
       of one submitted batch holds its event, the waiter gets
       DROP_DEGRADED within 2 x 50 ms plus one sweep, and the late
       completion does not overwrite it.
    Times (host clock) beside the card: a transient retry's cost, a
    quarantine, the host rung's flows/s, a ladder move's first rebuild,
    the rescue's pull and seed. → the phase's injected and real fault
    count, for ``watch.check``."""
    import threading

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels, faults
    from cilium_tpu_torch.datapath import placement
    from cilium_tpu_torch.datapath import pipeline as pmod
    from cilium_tpu_torch.datapath.conntrack import CT_NEW, FlowConntrack, pack_keys
    from cilium_tpu_torch.datapath.pipeline import DROP_DEGRADED, DatapathPipeline
    from cilium_tpu_torch.ipcache.ipcache import IPCache
    from cilium_tpu_torch.ipcache.prefilter import PreFilter

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else dev
    hub = faults.hub
    hub.reset()
    fl4, fl6 = tuple(flows4[:4]), tuple(flows6[:4])
    call = {4: "process", 6: "process_v6"}
    fam_flows = {4: fl4, 6: fl6}
    cut = slice(0, FAILSAFE_CUT)

    def cutflows(fam):
        return tuple(a[cut] for a in fam_flows[fam])

    def pipeline(ipcache=cache, **kw):
        pf = PreFilter()
        pf.insert(pf.revision, PREFILTER_CIDRS + V6_DENY)
        p = DatapathPipeline(engine, ipcache, pf, **kw)
        watch.allowed.add(p)
        p.set_endpoints(endpoints)
        p.rebuild()
        return p

    def run(p, fam, flows=None, **kw):
        """→ (outputs, host-clock seconds, launches it made)."""
        k0 = _kernels.launches()
        t0 = time.perf_counter()
        out = getattr(p, call[fam])(*(fam_flows[fam] if flows is None else flows), **kw)
        dt = time.perf_counter() - t0
        k1 = _kernels.launches()
        return out, dt, {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}

    def same(tag, got, want):
        for g, w in zip(got, want):
            if not np.array_equal(g, w):
                fail(f"failsafe {tag}: differs at flow {int(np.argmax(g != w))}")

    def degraded(tag, out):
        if not ((out[0] == DROP_DEGRADED).all() and not out[1].any()):
            fail(f"failsafe {tag}: not every lane DROP_DEGRADED without a redirect")

    def state(tag, p, **want):
        st = p.failsafe_state()
        for k, v in want.items():
            if st[k] != v:
                fail(f"failsafe {tag}: failsafe_state {st}, expected {k} = {v}")
        return st

    # -- 1. the hub armed but quiet ------------------------------------------
    # off and on in turns, FAILSAFE_REPS each: the first call of a family
    # pays for warming its staging
    base = pipeline()
    ref = {}
    for fam in (4, 6):
        got = {False: [], True: []}
        for _ in range(FAILSAFE_REPS):
            for on in (False, True):
                if on:
                    hub.enable()
                base.counters[:] = 0
                out, dt, k = run(base, fam)
                got[on].append((out, base.counters.copy(), k, dt))
                hub.disable()
        (o_off, c_off, k_off, _), (o_on, c_on, k_on, _) = got[False][0], got[True][0]
        for o, c_, k, _ in got[False][1:] + got[True]:
            same(f"quiet hub v{fam}", o, o_off)
            if not np.array_equal(c_, c_off) or k != k_off or not k_off:
                fail(f"failsafe quiet hub v{fam}: counters or launches differ ({k_off} / {k})")
        ref[fam] = o_off
        t_off, t_on = ([g[3] for g in got[on]] for on in (False, True))
        print(f"failsafe [quiet hub v{fam}]: {BATCH} flows, hub on == hub off (verdicts, redirects, "
              f"counters), launches {k_on} each; process off {t_off}s, on {t_on}s in turns "
              f"(medians {median(t_off)!r} / {median(t_on)!r}s) [{card}]", flush=True)
    state("quiet hub", base, level=0, quarantined_batches=0, breaker_faults=0)

    # -- 2. each site fired once ----------------------------------------------
    # FAILSAFE_REPS rounds a site: clean, one transient, one poisoned, the
    # next batch, each checked; the times are host-clock medians
    sp = pipeline()
    sp.breaker_threshold = 1 << 20  # the ladder is case 3's
    site_t = {}  # (family, site) → [clean], [transient], [poisoned] seconds
    n_q = 0
    for fam in (4, 6):
        for site in (faults.SITE_H2D, faults.SITE_DISPATCH, faults.SITE_COMPLETE):
            ts = site_t[(fam, site)] = ([], [], [])
            for _ in range(FAILSAFE_REPS):
                out, dt, _ = run(sp, fam)
                same(f"clean v{fam}", out, ref[fam])
                ts[0].append(dt)
                hub.fail(site, faults.KIND_TRANSIENT, times=1)
                out, dt, _ = run(sp, fam)
                same(f"transient {site} v{fam}", out, ref[fam])
                ts[1].append(dt)
                state(f"transient {site} v{fam}", sp, level=0, quarantined_batches=n_q)
                hub.fail(site, faults.KIND_POISONED, times=1)
                out, dt, _ = run(sp, fam)
                degraded(f"poisoned {site} v{fam}", out)
                ts[2].append(dt)
                n_q += 1
                state(f"poisoned {site} v{fam}", sp, level=0, quarantined_batches=n_q)
                out, _, _ = run(sp, fam)
                same(f"after poisoned {site} v{fam}", out, ref[fam])
        hub.fail(faults.SITE_COMPLETE, faults.KIND_TRANSIENT, times=3)
        out, _, _ = run(sp, fam)
        degraded(f"three transients v{fam}", out)
        n_q += 1
        state(f"three transients v{fam}", sp, level=0, quarantined_batches=n_q)
    print(f"failsafe [sites h2d / dispatch / complete, v4 and v6, {BATCH} flows, "
          f"{FAILSAFE_REPS} rounds each]: each transient == the clean run with 0 quarantines at "
          f"level 0; each poisoned one DROP_DEGRADED on every lane and one quarantine, the next "
          f"batch == the clean run; three transients at complete quarantine; {n_q} quarantines "
          f"in all [{card}]", flush=True)
    for (fam, site), (t_clean, t_retry, t_quar) in site_t.items():
        print(f"failsafe times [v{fam} {site}, {BATCH}-flow process(), host clock, backoff "
              f"{sp.retry_min_s * 1e3:g} ms]: clean {t_clean}s, one transient (a retry) "
              f"{t_retry}s, poisoned (a quarantined batch) {t_quar}s; medians "
              f"{median(t_clean)!r} / {median(t_retry)!r} / {median(t_quar)!r}s, a retry "
              f"+{median(t_retry) - median(t_clean)!r}s [{card}]", flush=True)

    # ct_epoch on a host-CT pipeline over a copy of the ipcache
    hcache = IPCache()
    for cidr, e in cache.items():
        hcache.upsert(cidr, e.identity, source="k8s")
    hp = pipeline(ipcache=hcache, conntrack=FlowConntrack(capacity_bits=20))
    rs = np.random.default_rng(seed + 19)
    sports = rs.integers(1024, 65535, BATCH).astype(np.int32)
    c4 = cutflows(4)
    ct_ref, _, _ = run(hp, 4, c4, sports=sports[cut])
    same("host CT pass", ct_ref, tuple(a[cut] for a in ref[4]))
    for k, kind in enumerate((faults.KIND_TRANSIENT, faults.KIND_POISONED)):
        epoch0 = hp._ct_epoch
        hcache.upsert(f"203.0.113.{k + 7}/32", endpoints[0], source="k8s")  # no flow's peer
        hub.fail(faults.SITE_CT_EPOCH, kind, times=1)
        out, _, _ = run(hp, 4, c4, sports=sports[cut])
        if kind == faults.KIND_TRANSIENT:
            same("ct_epoch transient", out, ct_ref)
            if hp._ct_epoch <= epoch0 or hp._ct_flush_pending:
                fail("failsafe ct_epoch transient: the retried rebuild did not flush the CT")
            state("ct_epoch transient", hp, level=0, quarantined_batches=0)
        else:
            degraded("ct_epoch poisoned", out)
            state("ct_epoch poisoned", hp, level=0, quarantined_batches=1)
            out, _, _ = run(hp, 4, c4, sports=sports[cut])
            same("after ct_epoch poisoned", out, ct_ref)
            if hp._ct_flush_pending:
                fail("failsafe ct_epoch poisoned: the next rebuild did not flush the CT")
    print(f"failsafe [ct_epoch, host-CT pipeline, {FAILSAFE_CUT} flows with sports]: a transient "
          f"at the publish's CT flush == the clean pass (the retried rebuild flushed), a poisoned "
          f"one DROP_DEGRADED and one quarantine, the next pass == the clean pass [{card}]",
          flush=True)

    # -- 3. the ladder on four virtual records ---------------------------------
    real_seam = placement.visible_devices
    placement.visible_devices = lambda: [
        placement.DeviceRecord(i, 0, dev) for i in range(MESH_GRID)]
    walks = ("lpm_wide", "lpm_stride8", "policymap_verdict")
    try:
        lp = pipeline(sharding=True)
        lp.breaker_threshold, lp.recover_after_clean = 2, 3
        if lp.placement_state()["devices"] != list(range(MESH_GRID)):
            fail(f"failsafe ladder: plan {lp.placement_state()}")
        out, _, k_l0 = run(lp, 4)
        same("ladder level 0", out, ref[4])
        for _ in range(2):
            hub.fail(faults.SITE_COMPLETE, faults.KIND_POISONED, times=1)
            degraded("ladder poisoned complete", run(lp, 4, c4)[0])
        st = state("ladder level 1", lp, level=1, mode="single-device",
                   excluded_devices=list(range(1, MESH_GRID)))
        t0 = time.perf_counter()
        lp.rebuild()
        torch.cuda.synchronize()
        t_move1 = time.perf_counter() - t0
        out, _, k_l1 = run(lp, 4)
        same("ladder level 1", out, ref[4])
        if lp._plan.mesh is not None or lp.placement_state()["devices"] != [0]:
            fail(f"failsafe ladder level 1: plan {lp.placement_state()}")
        for _ in range(2):
            hub.fail(faults.SITE_DISPATCH, faults.KIND_POISONED, times=1)
            degraded("ladder poisoned dispatch", run(lp, 4, c4)[0])
        state("ladder level 2", lp, level=2, mode="host")
        t0 = time.perf_counter()
        lp.rebuild()
        torch.cuda.synchronize()
        t_move2 = time.perf_counter() - t0
        host_t = {}
        for fam in (4, 6):
            out, dt, k = run(lp, fam, cutflows(fam))
            same(f"ladder level 2 v{fam}", out, tuple(a[cut] for a in ref[fam]))
            if any(k.get(w) for w in walks):
                fail(f"failsafe ladder level 2 v{fam}: device walks launched {k}")
            host_t[fam] = dt
        levels = []
        while lp.pipeline_mode != "sharded" and len(levels) < 12:
            fam_flows_l = c4 if lp._ladder_level == 2 else None
            out, _, _ = run(lp, 4, fam_flows_l)
            same("ladder climb", out, ref[4] if fam_flows_l is None
                 else tuple(a[cut] for a in ref[4]))
            levels.append(lp._ladder_level)
        state("ladder back", lp, level=0, excluded_devices=[], quarantined_batches=4)
        out, _, k_back = run(lp, 4)
        same("ladder level 0 again", out, ref[4])
        if k_back != k_l0 or lp.placement_state()["devices"] != list(range(MESH_GRID)):
            fail(f"failsafe ladder: launches {k_back} against {k_l0} at level 0 before, plan "
                 f"{lp.placement_state()}")
    finally:
        placement.visible_devices = real_seam
    print(f"failsafe [ladder, {MESH_GRID} virtual records on one card, breaker 2, recovery 3]: "
          f"0 → 1 on two poisoned completions (excluded {st['excluded_devices']}, {BATCH} flows == "
          f"level 0, launches {k_l1}), 1 → 2 on two poisoned dispatches, level 2 on "
          f"{FAILSAFE_CUT}-flow cuts of each family (the host rung walks the ipcache per flow in "
          f"Python) == the device verdicts with no K3 / K4 / K5 launch; the climb's levels "
          f"{levels}; back at level 0 launches {k_back} == before {k_l0} [{card}]", flush=True)
    print(f"failsafe times [ladder]: the first rebuild after the move to level 1 {t_move1!r}s, to "
          f"level 2 {t_move2!r}s; host rung {FAILSAFE_CUT} flows v4 {host_t[4]!r}s = "
          f"{FAILSAFE_CUT / host_t[4]!r} flows/s, v6 {host_t[6]!r}s = {FAILSAFE_CUT / host_t[6]!r} "
          f"flows/s [{card}]", flush=True)

    # -- 4. the device-CT rescue ---------------------------------------------
    cp = pipeline(device_ct_bits=CT_BITS)
    ct_out, t_pass, k_pass = run(cp, 4, sports=sports)
    if not (k_pass.get("ct_probe_claim") and k_pass.get("ct_commit")):
        fail(f"failsafe rescue: the device-CT pass launched {k_pass}")
    live = int((cp._device_ct.exp > int(time.monotonic())).sum())
    clocked = {}
    for name in ("_rescue_device_ct", "_seed_device_ct"):
        real = getattr(cp, name)

        def timed_call(*a, _r=real, _n=name):
            t0 = time.perf_counter()
            r = _r(*a)
            torch.cuda.synchronize()
            clocked[_n] = time.perf_counter() - t0
            return r

        setattr(cp, name, timed_call)
    hub.fail(faults.SITE_COMPLETE, faults.KIND_POISONED, times=1)
    degraded("rescue's quarantine", run(cp, 4, c4)[0])
    state("rescue's quarantine", cp, level=0, quarantined_batches=1)
    kept = len(cp.conntrack)
    if cp._device_ct is not None or not cp._device_ct_seed or kept != min(live, cp.device_ct_rescue_limit):
        fail(f"failsafe rescue: {kept} host entries from {live} live device entries "
             f"(limit {cp.device_ct_rescue_limit}), seed armed {cp._device_ct_seed}")
    ips, eps, dports, protos = fl4
    ka, kb, kc = pack_keys(np.zeros(BATCH, np.uint64), ips.astype(np.uint64),
                           eps.astype(np.uint64), sports.astype(np.int64),
                           dports.astype(np.uint64), protos.astype(np.uint64),
                           np.zeros(BATCH, np.uint64))
    rescued = cp.conntrack.lookup_batch(ka, kb, kc)[0] != CT_NEW
    est = []
    real_step = pmod.ct_step_verdict

    def spy(*a, **k):
        r = real_step(*a, **k)
        est.append(r[3].cpu().numpy())
        return r

    pmod.ct_step_verdict = spy
    try:
        out, t_seeded, _ = run(cp, 4, sports=sports)
    finally:
        pmod.ct_step_verdict = real_step
    same("rescue's seeded pass", out, ct_out)
    if cp._device_ct_seed or "_seed_device_ct" not in clocked:
        fail("failsafe rescue: the next device-CT pass did not seed its table")
    if not rescued.any() or not np.array_equal(est[0], rescued):
        fail(f"failsafe rescue: {int(est[0].sum())} lanes established, {int(rescued.sum())} "
             f"lanes' keys rescued")
    print(f"failsafe [device-CT rescue, device_ct_bits={CT_BITS}]: a {BATCH}-flow pass left {live} "
          f"live entries; a poisoned completion on a {FAILSAFE_CUT}-flow batch without sports "
          f"quarantined and the rescue kept {kept} in the host CT (limit "
          f"{cp.device_ct_rescue_limit}); the next pass seeded K10's table and established exactly "
          f"the {int(rescued.sum())} lanes whose keys were rescued; verdicts == the first pass "
          f"[{card}]", flush=True)
    print(f"failsafe times [rescue]: pull into the host CT {clocked['_rescue_device_ct'] * 1e3!r} "
          f"ms, seed {clocked['_seed_device_ct'] * 1e3!r} ms (host clock, synchronized); device-CT "
          f"pass {t_pass!r}s, the seeded pass {t_seeded!r}s [{card}]", flush=True)

    # -- 5. a real device stall under the watchdog --------------------------
    wp = pipeline(pipeline_depth=2)
    run(wp, 4, c4)
    wp.set_stall_ms(FAILSAFE_STALL_MS)
    wd = wp._watchdog
    try:
        s0 = wd.stalls
        device_spin(SPIN_CYCLES // 5)
        t0 = time.perf_counter()
        wp.rebuild(force=True)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        if wd.stalls != s0 + 1 or wd.last_stall["site"] != "compile":
            fail(f"failsafe watchdog: a spun full rebuild gave stalls {s0} → {wd.stalls}, last "
                 f"{wd.last_stall}")
        compile_stall = dict(wd.last_stall)
        out, _, _ = run(wp, 4)
        same("watchdog rebuilt", out, ref[4])
        device_spin(SPIN_CYCLES)
        pend = wp.submit(*fl4)
        th = threading.Thread(target=pend.result, daemon=True)
        th.start()
        time.sleep(0.01)  # the thread waits in the batch's event
        t0 = time.monotonic()
        v, red = pend.result()
        waited = time.monotonic() - t0
        limit = 2 * FAILSAFE_STALL_MS / 1e3 + wd._poll_s
        degraded("watchdog waiter", (v, red))
        if waited >= limit or wd.last_stall["site"] != "dispatch":
            fail(f"failsafe watchdog: the waiter waited {waited!r}s (limit {limit!r}s), last "
                 f"stall {wd.last_stall}")
        published = pend._value
        th.join(10.0)
        if th.is_alive():
            fail("failsafe watchdog: the stalled completion never returned")
        if pend._value is not published or not (pend.result()[0] == DROP_DEGRADED).all():
            fail("failsafe watchdog: the late completion overwrote the degraded result")
        state("watchdog", wp, quarantined_batches=1)
        n_stalls = wd.stalls
    finally:
        torch.cuda.synchronize()
        wp.set_stall_ms(0)
    print(f"failsafe [watchdog, stall_ms {FAILSAFE_STALL_MS:g}, a spin of {SPIN_CYCLES} clocks "
          f"ahead of one {BATCH}-flow submit]: the waiter got DROP_DEGRADED after {waited!r}s "
          f"(limit 2 x budget + one {wd._poll_s!r}s sweep = {limit!r}s), the late completion did "
          f"not overwrite it; a spin of {SPIN_CYCLES // 5} clocks ahead of rebuild(force=True) "
          f"({t_full!r}s) gave one compile stall {compile_stall}; {n_stalls} stalls in all "
          f"[{card}]", flush=True)

    injected = float(sum(hub.injected.values()))
    hub.reset()
    print(f"failsafe: {int(injected)} injected faults, {n_stalls} watchdog stalls, "
          f"{watch.quarantines[True]} quarantines, {watch.moves[True]} ladder moves in "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)
    return injected + n_stalls


OBSERVE_BATCHES = 8  # v4 1M-flow batches of the autotune case
OBSERVE_SUBMIT_DEPTH = 2  # their static depth; the tuner moves it in [1, 4]


def trace_line(t) -> str:
    """One trace as "phase ms" pairs (a phase that recurs is summed) and
    its coverage of the batch's total_ns."""
    ms = {}
    for name, _rel, dur in t["phases"]:
        ms[name] = ms.get(name, 0.0) + dur / 1e6
    covered = sum(dur for _n, _r, dur in t["phases"]) / t["total_ns"]
    return (f"{t['kind']} total {t['total_ns'] / 1e6!r} ms, phases "
            f"{ {k: round(v, 4) for k, v in ms.items()} } ms, covered {covered!r}")


def sample_line(s) -> str:
    return (f"h2d {s['h2d_ms']!r} ms, device_compute {s['device_compute_ms']!r} ms, d2h "
            f"{s['d2h_ms']!r} ms (notes {s['notes']})")


def check_coverage(traces, what: str) -> None:
    """The phases of every traced batch cover its wall within 20% (the
    reference's bound, tests/test_observe.py)."""
    for t in traces:
        covered = sum(dur for _n, _r, dur in t["phases"])
        if not t["total_ns"] or abs(covered - t["total_ns"]) / t["total_ns"] > 0.20:
            fail(f"observe {what}: the phases cover {covered} of {t['total_ns']} ns")


class nothing_built:
    """Inside: building a BatchTrace, a _Span, a DeviceProfiler, a
    _DispatchSample or a DepthTuner raises (the off path builds none)."""

    def __enter__(self):
        from cilium_tpu_torch.datapath import pipeline as pmod
        from cilium_tpu_torch.observe import profiler as prof_mod
        from cilium_tpu_torch.observe import tracer as tr_mod

        def boom(*_a, **_k):
            raise AssertionError("an observer object was built with everything off")

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (tr_mod, "BatchTrace"), (tr_mod, "_Span"), (prof_mod, "DeviceProfiler"),
            (prof_mod, "_DispatchSample"), (pmod, "DepthTuner"))]
        for m, n, _v in self.saved:
            setattr(m, n, boom)
        return self

    def __exit__(self, *exc):
        for m, n, v in self.saved:
            setattr(m, n, v)
        return False


def observe_main_path(engine, cache, endpoints, flows4, flows6, svc, dct, l7res, card: str):
    """Phase 3l: the tracer, the device profiler and the depth tuner
    (A5b) on the bench world at full width, each case against the same
    batches with them off: results, counters and launch counts equal;
    per-phase ms and the h2d / compute / d2h split printed. The services
    and device-CT replays are held to their phases' results. Every
    pipeline here is made before the launch counts are reset."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch import metrics as tmetrics
    from cilium_tpu_torch.datapath import l7_pipeline as l7rt
    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.observe import DeviceProfiler

    t0 = time.perf_counter()
    pf = PreFilter()
    pf.insert(pf.revision, PREFILTER_CIDRS + V6_DENY)
    pipe = DatapathPipeline(engine, cache, pf, pipeline_depth=OBSERVE_SUBMIT_DEPTH)
    pipe.set_endpoints(endpoints)
    pipe.rebuild()
    ep_ids = [(10_000 + j, e) for j, e in enumerate(svc["endpoints"])]
    spipe = DatapathPipeline(svc["pipe"].engine, svc["cache"],
                             conntrack=FlowConntrack(capacity_bits=CT_BITS), lb=svc["manager"])
    spipe.set_endpoints(ep_ids)
    spipe.rebuild()
    dpipe = DatapathPipeline(svc["pipe"].engine, svc["cache"], PreFilter(), device_ct_bits=CT_BITS)
    dpipe.set_endpoints(ep_ids)
    dpipe.rebuild()
    torch.cuda.synchronize()
    print(f"observe: three pipelines (bench world with the prefilter, services with host CT "
          f"and LB, device CT) built in {time.perf_counter() - t0:.2f}s", flush=True)

    _kernels.reset_launches()
    walks = ("lpm_wide", "lpm_stride8", "policymap_verdict")

    # -- tracing and profiling on the 1M-flow v4 / v6 batches ------------
    calls = (("v4", "process", flows4), ("v6", "process_v6", flows6))
    modes = ("off", "traced", "traced+profiled")
    out, counts, ctr, traces, samples = {}, {}, {}, {}, {}
    for mode in modes:
        pipe.tracer.clear()
        if mode != "off":
            pipe.tracer.enable()
        if mode == "traced+profiled":
            pipe.set_profiling(True, sample_every=1)
        for fam, call, flows in calls:
            pipe.counters[:] = 0
            k0 = _kernels.launches()
            outs = [getattr(pipe, call)(*flows) for _ in range(2)]
            torch.cuda.synchronize()
            k1 = _kernels.launches()
            out[mode, fam] = outs
            counts[mode, fam] = {k: k1[k] - k0[k] for k in walks}
            ctr[mode, fam] = pipe.counters.copy()
        traces[mode] = pipe.tracer.traces()
        samples[mode] = pipe.profiler.samples() if pipe.profiler is not None else []
        pipe.tracer.disable()
        pipe.set_profiling(False)
    for mode in modes[1:]:
        for fam, _call, _flows in calls:
            for (v, r), (v0, r0) in zip(out[mode, fam], out["off", fam]):
                if not (np.array_equal(v, v0) and np.array_equal(r, r0)):
                    fail(f"observe {fam}: {mode} changed the verdicts or redirects")
            if not np.array_equal(ctr[mode, fam], ctr["off", fam]):
                fail(f"observe {fam}: {mode} changed the counters")
            if counts[mode, fam] != counts["off", fam]:
                fail(f"observe {fam}: launches {counts[mode, fam]} {mode}, "
                     f"{counts['off', fam]} off")
        if len(traces[mode]) != 4:
            fail(f"observe: {len(traces[mode])} traces {mode}, expected 4")
        check_coverage(traces[mode], mode)
    if traces["off"] or samples["off"] or samples["traced"]:
        fail("observe: a trace or a sample was made with the tracer or the profiler off")
    if len(samples["traced+profiled"]) != 4:
        fail(f"observe: {len(samples['traced+profiled'])} samples at sample_every=1, expected 4")
    for (fam, _c, _f), k in zip(calls, (0, 2)):
        print(f"observe [{fam}]: launches per 2 batches {counts['off', fam]} with everything "
              f"off, equal traced and traced+profiled; results and counters bit-identical "
              f"[{card}]", flush=True)
        for mode in modes[1:]:
            for j in (k, k + 1):
                line = trace_line(traces[mode][j])
                if mode == "traced+profiled":
                    line += "; " + sample_line(samples[mode][j])
                print(f"  {mode} batch {j - k + 1}: {line}", flush=True)
        for s in samples["traced+profiled"][k:k + 2]:
            if s["device_compute_ms"] <= 0 or s["h2d_ms"] <= 0 or s["d2h_ms"] <= 0:
                fail(f"observe {fam}: a split part is not positive: {sample_line(s)}")
    check_path_counts = {k: sum(counts[m, f][k] for m in modes for f in ("v4", "v6"))
                         for k in walks}

    # -- host CT with LB (services) and device CT, v4, traced + profiled -
    stateful = {}
    for name, p, ref in (("services", spipe, svc), ("device CT", dpipe, dct)):
        p.tracer.enable()
        p.set_profiling(True, sample_every=1)
        q = ref["seqs"][4]
        k0 = _kernels.launches()
        t1 = time.perf_counter()
        got = svc_sequence(p, 4, q["batch"], q["reply"], q["overlay"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        k1 = _kernels.launches()
        stateful[name] = {k: k1[k] - k0[k] for k in k1}
        for j, (a, b) in enumerate(zip(got, ref["res"][4])):
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                fail(f"observe {name}: pass {j + 1} differs from the untraced run of its phase")
        tr, sm = p.tracer.traces(), p.profiler.samples()
        p.tracer.disable()
        p.set_profiling(False)
        print(f"observe [{name} v4]: the 4 passes in {wall!r}s, each equal to its phase's "
              f"untraced run; launches {stateful[name]}; {len(sm)} samples [{card}]", flush=True)
        for j, t in enumerate(tr):
            print(f"  pass {j + 1}: {trace_line(t)}", flush=True)
        for s in sm:
            print(f"  sample: {sample_line(s)}", flush=True)
        # one sample a dispatch: a miss tail's or a device-CT pass's, one K4 each
        k4 = stateful[name]["policymap_verdict"]
        if len(sm) != k4 or len(tr) != 4:
            fail(f"observe {name}: {len(sm)} samples and {len(tr)} traces for {k4} K4 launches")
    s_l = stateful["services"]
    if (s_l["lb_index_build"], s_l["lb_translate"]) != (2, 2) or s_l["lpm_wide"] != s_l[
            "policymap_verdict"] or s_l["ct_probe_claim"]:
        fail(f"observe services: launches {s_l}")
    d_l = stateful["device CT"]
    if (d_l["ct_probe_claim"], d_l["ct_commit"]) != (3, 3) or d_l["lb_translate"]:
        fail(f"observe device CT: launches {d_l}")

    # -- one L7 check_batch with L7DeviceBatch on, sampled at the l7 site
    prof = DeviceProfiler(sample_every=1)
    l7rt.set_device_batch(True)
    l7rt.set_profiler(prof)
    k0 = _kernels.launches()
    t1 = time.perf_counter()
    out_b = l7res["pol_b"].check_batch(l7res["reqs_b"])
    wall = time.perf_counter() - t1
    k1 = _kernels.launches()
    l7rt.set_profiler(None)
    l7rt.set_device_batch(False)
    if not np.array_equal(out_b, l7res[("b", "on")]):
        fail("observe l7: the sampled check_batch differs from the L7 phase's")
    l7_samples = prof.samples()
    l7_k = {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}
    if len(l7_samples) != 1 or l7_samples[0]["site"] != "l7":
        fail(f"observe l7: {len(l7_samples)} samples")
    print(f"observe [l7]: pattern-cap check_batch {L7_BATCH} requests {wall!r}s, equal to the "
          f"L7 phase's; launches {l7_k}; sample {sample_line(l7_samples[0])} [{card}]",
          flush=True)

    # -- the depth tuner: 8 v4 batches in flight, autotune on and off, in
    # turns (off, on, on, off), each "on" with a fresh tuner ------------
    adj0 = {d: tmetrics.autotune_adjustments_total.get({"direction": d}) for d in ("up", "down")}
    runs, walls, trajectories = {}, {"off": [], "on": []}, []
    for mode in ("off", "on", "on", "off"):
        pipe.set_autotune(False)  # back at the static depth
        if mode == "on":
            pipe.set_autotune(True, max_depth=4, epoch=2)
        pipe.counters[:] = 0
        depths = []
        k0 = _kernels.launches()
        t1 = time.perf_counter()
        pend = []
        for _ in range(OBSERVE_BATCHES):
            pend.append(pipe.submit(*flows4))
            depths.append(pipe.pipeline_depth)
        res = [h.result() for h in pend]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        k1 = _kernels.launches()
        walls[mode].append(wall)
        if mode == "on":
            trajectories.append(depths)
        if mode in runs:
            continue  # the repeat of each mode is timed only
        runs[mode] = dict(res=res, depths=depths, wall=wall, counters=pipe.counters.copy(),
                          launches={k: k1[k] - k0[k] for k in walks},
                          state=pipe.autotune_state())
    pipe.set_autotune(False)
    adj = {d: tmetrics.autotune_adjustments_total.get({"direction": d}) - adj0[d]
           for d in ("up", "down")}
    for (v, r), (v0, r0) in zip(runs["on"]["res"], runs["off"]["res"]):
        if not (np.array_equal(v, v0) and np.array_equal(r, r0)):
            fail("observe autotune: the tuned run's verdicts differ from the static run's")
    if not np.array_equal(runs["on"]["counters"], runs["off"]["counters"]):
        fail("observe autotune: counters differ")
    if runs["on"]["launches"] != runs["off"]["launches"]:
        fail(f"observe autotune: launches {runs['on']['launches']} on, "
             f"{runs['off']['launches']} off")
    state = runs["on"]["state"]
    if state is None or state["epochs_seen"] < OBSERVE_BATCHES // 2 - 1:
        fail(f"observe autotune: the tuner saw too few epochs: {state}")
    print(f"observe [autotune]: {OBSERVE_BATCHES} v4 batches of {BATCH} flows submitted at "
          f"static depth {OBSERVE_SUBMIT_DEPTH}, in turns off, on, on, off: walls off "
          f"{walls['off']}s, on (epoch 2, max depth 4) {walls['on']}s; depth after each submit "
          f"{trajectories}; autotune_adjustments_total over both and the restores {adj}; the "
          f"first tuner's autotune_state {state}; "
          f"results, counters and launches {runs['on']['launches']} equal [{card}]",
          flush=True)

    # -- off again: a batch builds no trace, sample or tuner -------------
    if pipe.pipeline_depth != OBSERVE_SUBMIT_DEPTH or pipe.autotune_state() is not None:
        fail("observe: autotune off did not restore the static depth")
    n_tr = len(pipe.tracer.traces())
    with nothing_built():
        v, r = pipe.process(*flows4)
    if not (np.array_equal(v, out["off", "v4"][0][0]) and len(pipe.tracer.traces()) == n_tr
            and pipe.profiler is None):
        fail("observe: the batch after everything was turned off differs or was observed")
    print("observe [off again]: a v4 batch built no trace, span, profiler, sample or tuner",
          flush=True)
    counts_all = {k: check_path_counts[k] + 2 * (runs["on"]["launches"][k]
                                                 + runs["off"]["launches"][k]) for k in walks}
    print(f"observe: K3 / K5 / K4 launches of the v4 / v6 cases {counts_all}; phase in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    return dict(traces=traces, samples=samples, stateful=stateful, l7=l7_samples, runs=runs)


EVENTS_VERDICT_BATCH = 1 << 16  # the batch with a PolicyVerdictNotify a flow
# a subscription deep enough for every event of one 1M-flow batch (the
# hub's default 8192 keeps only the last 8192 of them)
EVENTS_SUB_CAPACITY = 1 << 21
EVENTS_PHASE_LIMIT_S = 120.0


def events_main_path(engine, cache, endpoints, labels_of, flows4, flows6, svc, dct, card: str):
    """Phase 3m: flow events and the flow ring (A6) on the bench world at
    full width. Three pipelines publish to one MonitorHub: the bench
    world's prefilter pipeline with attribution on (v4 and v6 process(),
    with and without a subscriber, then a verdict-notification batch), a
    device-CT pipeline on the services world and an admission-gated one.
    Every pipeline is made before the launch counts are reset. Returns
    the phase's wall."""
    import os
    import tempfile
    import threading

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels, faults
    from cilium_tpu_torch import metrics as tmetrics
    from cilium_tpu_torch.datapath.pipeline import (
        DROP_DEGRADED, DROP_NO_SERVICE, DROP_POLICY, DROP_PREFILTER, FORWARD, DatapathPipeline,
    )
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.monitor import (
        DropNotify, MonitorHub, MonitorServer, PolicyVerdictNotify, TraceSummary, monitor_stream,
    )
    from cilium_tpu_torch.monitor.events import (
        REASON_NO_SERVICE, REASON_PIPELINE_DEGRADED, REASON_POLICY, REASON_POLICY_DENY,
        REASON_POLICY_NO_L3, REASON_POLICY_NO_L4, REASON_PREFILTER, REASON_PROXY_REDIRECT,
    )
    from cilium_tpu_torch.observe import SAMPLE_CAP

    class DeepHub(MonitorHub):
        """A hub whose subscriptions, the server's too, hold a whole batch."""

        def subscribe(self, capacity: int = EVENTS_SUB_CAPACITY):
            return super().subscribe(capacity)

    t_phase = time.perf_counter()
    pf = PreFilter()
    pf.insert(pf.revision, PREFILTER_CIDRS + V6_DENY)
    hub = DeepHub()
    pipe = DatapathPipeline(engine, cache, pf, monitor=hub)
    pipe.set_endpoints(endpoints)
    pipe.set_attribution(True)
    pipe.identity_labels = lambda ident: tuple(labels_of.get(ident, ()))
    pipe.rebuild()
    gpipe = DatapathPipeline(engine, cache, pf, monitor=hub, admission=True, prefilter_shed=True)
    gpipe.set_endpoints(endpoints)
    gpipe.rebuild()
    ep_ids = [(10_000 + j, e) for j, e in enumerate(svc["endpoints"])]
    dpipe = DatapathPipeline(svc["pipe"].engine, svc["cache"], PreFilter(), monitor=hub,
                             device_ct_bits=CT_BITS)
    dpipe.set_endpoints(ep_ids)
    dpipe.rebuild()
    # the host time of every _emit_flow_events call (the device-CT path
    # emits outside the emit_events phase, as the reference does), and
    # the attribution arrays the completion half pulled
    emit_s, pulled = [], {}
    for p in (pipe, gpipe, dpipe):
        real_emit = p._emit_flow_events

        def timed_emit(*a, _real=real_emit, **k):
            t = time.perf_counter()
            _real(*a, **k)
            emit_s.append(time.perf_counter() - t)

        p._emit_flow_events = timed_emit
        p.tracer.enable()
        p.set_profiling(True, sample_every=1)
    real_complete = pipe._dispatch_complete

    def keep_complete(enq):
        out = real_complete(enq)
        pulled["out"] = out
        return out

    pipe._dispatch_complete = keep_complete
    shed = []
    real_gate = gpipe._resolve_at_gate

    def counted_gate(fl, idx, *, verdict_code, ingress):
        shed.append((verdict_code, int(idx.size)))
        return real_gate(fl, idx, verdict_code=verdict_code, ingress=ingress)

    gpipe._resolve_at_gate = counted_gate
    torch.cuda.synchronize()
    print(f"events: three pipelines (attributed bench world with the prefilter, admission gate, "
          f"device CT on the services world) on one MonitorHub built in "
          f"{time.perf_counter() - t_phase:.2f}s [{card}]", flush=True)

    def d2h():
        return (tmetrics.device_transfers_total.get({"direction": "d2h"}),
                tmetrics.device_transfer_bytes_total.get({"direction": "d2h"}))

    def run(p, call, flows, sub, **kw):
        """One batch → its result, drained events and counts."""
        pub0, rec0, n_emit, tr0 = hub.published, p.flow_ring.recorded, len(emit_s), len(
            p.tracer.traces())
        d0, k0 = d2h(), _kernels.launches()
        t = time.perf_counter()
        out = getattr(p, call)(*flows, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k1, d1 = _kernels.launches(), d2h()
        traces = p.tracer.traces()[tr0:]
        return dict(
            out=out, wall=wall, events=sub.drain() if sub is not None else [],
            published=hub.published - pub0, recorded=p.flow_ring.recorded - rec0,
            emit_ms=1e3 * sum(emit_s[n_emit:]),
            phase_ms=sum(d for tr in traces for n, _r, d in tr["phases"] if n == "emit_events") / 1e6,
            d2h=(d1[0] - d0[0], d1[1] - d0[1]),
            launches={k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]},
            d2h_ms=[s["d2h_ms"] for s in p.profiler.samples()[-len(traces):]] if traces else [])

    def of(evs, cls):
        return [e for e in evs if type(e) is cls]

    generic = {DROP_POLICY: REASON_POLICY, DROP_PREFILTER: REASON_PREFILTER,
               DROP_NO_SERVICE: REASON_NO_SERVICE, DROP_DEGRADED: REASON_PIPELINE_DEGRADED}

    def want_reasons(v, lanes, rule=None, l4x=None):
        """The reason each drop lane's event must carry."""
        codes = v[lanes].astype(np.int64)
        out = np.array([generic.get(int(c), 0) for c in range(6)])[codes]
        if rule is not None:
            pol = codes == DROP_POLICY
            out = np.where(pol & (rule[lanes] >= 0), REASON_POLICY_DENY, np.where(
                pol & l4x[lanes], REASON_POLICY_NO_L4, np.where(pol, REASON_POLICY_NO_L3, out)))
        return out

    def check_drops(name, r, v, flows, ep_of, rule=None, l4x=None):
        """The batch's DropNotify events: one a lane with verdict >=
        DROP_POLICY, in lane order, each with its lane's endpoint, dport
        and proto and the reason its verdict and attribution give."""
        drops = of(r["events"], DropNotify)
        lanes = np.nonzero(v >= DROP_POLICY)[0]
        if len(drops) != lanes.size:
            fail(f"events {name}: {len(drops)} DropNotify for {lanes.size} dropped lanes")
        n = lanes.size
        got = {f: np.fromiter((getattr(e, f) for e in drops), np.int64, n)
               for f in ("reason", "endpoint", "dport", "proto")}
        want = {"reason": want_reasons(v, lanes, rule, l4x), "endpoint": ep_of[flows[1][lanes]],
                "dport": flows[2][lanes], "proto": flows[3][lanes]}
        for f in got:
            if not np.array_equal(got[f], want[f]):
                bad = int(np.argmax(got[f] != want[f]))
                fail(f"events {name}: DropNotify {bad} (lane {lanes[bad]}) has {f} {got[f][bad]}, "
                     f"its lane says {want[f][bad]}")
        return collections_counter(got["reason"])

    def check_ring(name, r, v):
        """At most SAMPLE_CAP records, drops first."""
        n = r["recorded"]
        if n > SAMPLE_CAP or n != min(SAMPLE_CAP, int(((v >= DROP_POLICY) | (v == FORWARD)).sum())):
            fail(f"events {name}: {n} flows recorded")
        recs = pipe.flow_ring.query(limit=n)
        n_drop = min(SAMPLE_CAP, int((v >= DROP_POLICY).sum()))
        if any(rec["verdict"] == FORWARD for rec in recs[:n_drop]) or any(
                rec["verdict"] != FORWARD for rec in recs[n_drop:]):
            fail(f"events {name}: the ring's records are not drops first")
        return recs

    def line(name, r):
        evs = r["published"]
        rate = evs / (r["emit_ms"] / 1e3) if r["emit_ms"] else 0.0
        return (f"events [{name}]: published {evs}, emit_events phase {r['phase_ms']!r} ms "
                f"(_emit_flow_events {r['emit_ms']!r} ms, {rate!r} events/s), flows recorded "
                f"{r['recorded']}, d2h transfers {r['d2h'][0]} ({r['d2h'][1]} bytes), sampled d2h "
                f"{r['d2h_ms']} ms, batch wall {r['wall']!r}s [{card}]")

    ep_of = np.asarray(endpoints, np.int64)
    calls = (("v4", "process", flows4), ("v6", "process_v6", flows6))
    _kernels.reset_launches()

    # -- the 1M-flow v4 and v6 batches with a subscriber; v4 also streamed
    sock_dir = tempfile.mkdtemp(prefix="ev")
    here = os.getcwd()
    sock = os.path.join(sock_dir, "m.sock")
    if len(sock) > 100:  # past the unix socket path limit: bind relative
        os.chdir(sock_dir)
        sock = "m.sock"
    srv = MonitorServer(hub, sock)
    srv.start()
    streamed = {"n": 0, "drops": 0}

    def client():
        for ev in monitor_stream(sock, timeout=60.0):
            streamed["n"] += 1
            streamed["drops"] += type(ev) is DropNotify

    reader = threading.Thread(target=client, daemon=True)
    sub = None
    try:
        reader.start()
        deadline = time.monotonic() + 30
        while srv.clients < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        if srv.clients < 1:
            fail("events: the monitor_stream client never attached to the server")
        sub = hub.subscribe()
        on = {}
        for fam, call, flows in calls:
            t_s = time.perf_counter()
            on[fam] = r = run(pipe, call, flows, sub)
            if fam == "v4":
                deadline = time.monotonic() + 90
                while streamed["n"] < r["published"] and time.monotonic() < deadline:
                    time.sleep(0.05)
                t_stream = time.perf_counter() - t_s
                srv.stop()
                reader.join(timeout=30)
                if streamed["n"] != r["published"]:
                    fail(f"events v4: the monitor_stream client received {streamed['n']} events, "
                         f"the hub published {r['published']}")
            v, red = r["out"]
            _v, _r, _ctr, rule, l4x, _hits = pulled["out"]
            if not np.array_equal(_v, v):
                fail(f"events {fam}: the pulled attribution arrays are another batch's")
            reasons = check_drops(fam, r, v, flows, ep_of, rule, l4x)
            if len(of(r["events"], TraceSummary)) != 1 or r["published"] != len(r["events"]):
                fail(f"events {fam}: {r['published']} published, {len(r['events'])} drained")
            recs = check_ring(fam, r, v)
            print(line(f"{fam} subscribed", r) + f"; DropNotify reasons {reasons}; ring reasons "
                  f"{collections_counter([x['reason'] for x in recs])}", flush=True)
            r["events"] = None
        print(f"events [v4 streamed]: a MonitorServer on a unix socket sent all {streamed['n']} "
              f"events ({streamed['drops']} DropNotify) to a monitor_stream client, done "
              f"{t_stream!r}s after the batch started [{card}]", flush=True)
    finally:
        srv.stop()
        os.chdir(here)
        if sub is not None:
            sub.close()
        try:
            os.rmdir(sock_dir)
        except OSError:
            pass

    # -- the same two with no subscriber ------------------------------------
    deadline = time.monotonic() + 10  # the server's client thread closes its subscription
    while hub.active and time.monotonic() < deadline:
        time.sleep(0.01)
    if hub.active:
        fail("events: the hub still has a listener")
    for fam, call, flows in calls:
        r = run(pipe, call, flows, None)
        v, red = r["out"]
        if not (np.array_equal(v, on[fam]["out"][0]) and np.array_equal(red, on[fam]["out"][1])):
            fail(f"events {fam}: the results differ with and without a subscriber")
        if r["published"]:
            fail(f"events {fam}: {r['published']} events published with no subscriber")
        if r["d2h"] != on[fam]["d2h"]:
            fail(f"events {fam}: d2h transfers {r['d2h']} without a subscriber, "
                 f"{on[fam]['d2h']} with one")
        if r["launches"] != on[fam]["launches"]:
            fail(f"events {fam}: launches {r['launches']} without a subscriber, "
                 f"{on[fam]['launches']} with one")
        check_ring(f"{fam} unsubscribed", r, v)
        print(line(f"{fam} no subscriber", r) + f"; with a subscriber: emit_events phase "
              f"{on[fam]['phase_ms']!r} ms, d2h transfers {on[fam]['d2h'][0]} "
              f"({on[fam]['d2h'][1]} bytes), equal; launches {r['launches']} both", flush=True)

    # -- a 65 536-flow v4 batch with a PolicyVerdictNotify a flow ------------
    sub = hub.subscribe()
    pipe.verdict_notifications = True
    part = tuple(a[:EVENTS_VERDICT_BATCH] for a in flows4)
    r = run(pipe, "process", part, sub)
    pipe.verdict_notifications = False
    v, red = r["out"]
    _v, _r, _ctr, rule, l4x, _hits = pulled["out"]
    check_drops("verdicts", r, v, part, ep_of, rule, l4x)
    pv = of(r["events"], PolicyVerdictNotify)
    if len(pv) != EVENTS_VERDICT_BATCH:
        fail(f"events verdicts: {len(pv)} PolicyVerdictNotify for {EVENTS_VERDICT_BATCH} flows")
    act = np.fromiter((e.action for e in pv), np.int64, len(pv))
    rsn = np.fromiter((e.reason for e in pv), np.int64, len(pv))
    ri = np.fromiter((e.rule_index for e in pv), np.int64, len(pv))
    fwd = v == FORWARD
    lanes = np.arange(v.size)
    want_rsn = np.where(fwd, np.where(red, REASON_PROXY_REDIRECT, 0),
                        want_reasons(v, lanes, rule, l4x))
    if not (np.array_equal(act, np.where(fwd, np.where(red, 2, 1), 0))
            and np.array_equal(rsn, want_rsn) and np.array_equal(ri, rule)):
        fail("events verdicts: a PolicyVerdictNotify disagrees with its lane's verdict or rule")
    check_ring("verdicts", r, v)
    print(line("v4 verdict notifications", r) + f"; {len(pv)} PolicyVerdictNotify, actions "
          f"{collections_counter(act)}", flush=True)
    r["events"] = None

    # -- a device-CT batch (not attributed: the generic reasons) -------------
    peer, eps, dports, protos, sports = dct["seqs"][4]["batch"]
    d_flows = (peer, eps, dports, protos)
    r = run(dpipe, "process", d_flows, sub, ingress=False, sports=sports)
    v, red = r["out"]
    if not (np.array_equal(v, dct["res"][4][0][0]) and np.array_equal(red, dct["res"][4][0][1])):
        fail("events device CT: the batch differs from the device-CT phase's pass 1")
    d_ep = np.asarray([e for e, _i in ep_ids], np.int64)
    reasons = check_drops("device CT", r, v, d_flows, d_ep)
    if r["recorded"]:
        fail("events device CT: the unattributed device-CT path recorded flows")
    print(line("device CT v4 egress", r) + f"; DropNotify reasons {reasons}", flush=True)
    r["events"] = None

    # -- a 1M-flow batch forced through the admission gate ------------------
    faults.hub.fail(faults.SITE_QUEUE_FULL, faults.KIND_TRANSIENT, times=1)
    try:
        r = run(gpipe, "process", flows4, sub)
    finally:
        faults.hub.reset()
    sub.close()
    v, red = r["out"]
    n_shed = sum(n for code, n in shed if code == DROP_PREFILTER)
    drops = of(r["events"], DropNotify)
    n_adm = sum(e.producer == "admission" for e in drops)
    if not n_shed or n_adm != n_shed or len(drops) != int((v >= DROP_POLICY).sum()):
        fail(f"events gate: {len(drops)} DropNotify ({n_adm} from the gate) for "
             f"{int((v >= DROP_POLICY).sum())} dropped lanes, {n_shed} shed")
    got_r = collections_counter([e.reason for e in drops])
    want_r = collections_counter(want_reasons(v, np.nonzero(v >= DROP_POLICY)[0]))
    if got_r != want_r:
        fail(f"events gate: DropNotify reasons {got_r}, the verdicts give {want_r}")
    print(line("v4 admission gate", r) + f"; {n_shed} flows shed at the gate, {n_adm} DropNotify "
          f"with producer admission; reasons {got_r}", flush=True)
    r["events"] = None
    wall = time.perf_counter() - t_phase
    over = "" if wall <= EVENTS_PHASE_LIMIT_S else " OVER ITS LIMIT"
    print(f"events: phase in {wall:.2f}s (limit {EVENTS_PHASE_LIMIT_S:.0f}s){over} [{card}]",
          flush=True)
    return wall


RESTORE_SLICE = 1 << 16  # flows of each served batch held against the CPU plain path
RESTORE_MAX_SERVED = 400  # batches served while the background refresh runs, at most
RESTORE_PHASE_LIMIT_S = 60.0


def tables_on_cpu(t):
    """A copy of a dataclass of tensors (nested ones too) on the CPU,
    where every kernel wrapper runs its plain version."""
    import torch

    kw = {}
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.cpu()
        elif dataclasses.is_dataclass(v):
            kw[f.name] = tables_on_cpu(v)
    return dataclasses.replace(t, **kw)


def plain_slice(tables, fused: bool, ep_count: int, fam: int, flows):
    """The CPU plain path over a pipeline's ingress ``tables`` of family
    ``fam`` (no prefilter stage: the pipeline has none) on the first
    RESTORE_SLICE flows → (verdict, redirect)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.datapath.pipeline import process_flows, process_flows_wide

    t = tables_on_cpu(tables)
    part = [a[:RESTORE_SLICE] for a in flows]
    fargs = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in part[1:]]
    kw = dict(ep_count=ep_count, prefilter=False)
    if fam == 4:
        out = process_flows_wide(t, torch.from_numpy(np.ascontiguousarray(part[0]).view(np.int32)),
                                 *fargs, **kw)
    else:
        out = process_flows(t, torch.from_numpy(np.ascontiguousarray(part[0], np.int32)), *fargs,
                            levels=16, fused=fused, **kw)
    return out[0].numpy(), out[1].numpy()


class Stopwatch:
    """Host seconds spent in the wrapped module functions while entered
    (``targets``: (module, function) pairs), each call ended by a
    torch.cuda.synchronize, so the device work it queued counts."""

    def __init__(self, *targets):
        self.targets = targets
        self.secs = {name: 0.0 for _, name in targets}

    def __enter__(self):
        import torch

        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
        for mod, name, real in self.saved:
            def timed_call(*a, _real=real, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    self.secs[_name] += time.perf_counter() - t0
            setattr(mod, name, timed_call)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def restore_main_path(engine, cache, endpoints, flows4, flows6, svc, seed: int, card: str):
    """Phase 3n: compiled-state snapshots, the restore, the background
    refresh and the CT snapshot (A7a) on the bench world at full width
    (10 000 rules, 2 048 identities, 64 endpoints, 1 048 576-flow
    batches) and on the services world's 2^22-slot conntrack. The
    caller set the launch counts to 0; the comparison runs (the original
    pipeline's batches, the full refresh beside the restore, the fresh
    engine after the background refresh) are uncounted."""
    import os
    import tempfile
    import threading

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch import engine as engmod
    from cilium_tpu_torch.compiler import snapshot as snapmod
    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.ct_snapshot import load_ct_state, save_ct_state
    from cilium_tpu_torch.datapath.pipeline import FORWARD, TRAFFIC_EGRESS, TRAFFIC_INGRESS, DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.ops import materialize as matmod
    from cilium_tpu_torch.policy.api import EndpointSelector, IngressRule, rule

    t_phase = time.perf_counter()
    k1 = lambda: _kernels.launches()["selector_match"]  # noqa: E731
    batches = ((4, "process", flows4), (6, "process_v6", flows6))

    def run(pipe, call, flows):
        out = getattr(pipe, call)(*flows)
        torch.cuda.synchronize()
        return [np.asarray(x) for x in out]

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    def words_equal(a, b):
        """Two DevicePolicy objects' words and matrices, bit for bit."""
        if not (torch.equal(a.id_bits, b.id_bits) and torch.equal(a.sel_match, b.sel_match)):
            return False
        return all(torch.equal(getattr(getattr(a, d), f.name), getattr(getattr(b, d), f.name))
                   for d in ("ingress", "egress") for f in dataclasses.fields(a.ingress))

    def pipeline(eng, c):
        p = DatapathPipeline(eng, c)
        p.set_endpoints(endpoints)
        return p

    with tempfile.TemporaryDirectory(prefix="policyd-restore-") as tmp:
        path = os.path.join(tmp, "compiled.npz")
        # -- the original: the bench engine, a pipeline over it, its results
        with uncounted():
            pipe0 = pipeline(engine, cache)
            pipe0.rebuild()
            want = {fam: run(pipe0, call, flows) for fam, call, flows in batches}
            want_counters = pipe0.counters.copy()

        # -- 1. save -----------------------------------------------------
        with Stopwatch((snapmod, "save_compiled_state")) as sw:
            t0 = time.perf_counter()
            engine.save_snapshot(path, dict(pipe0._mat))
            t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"restore: save_snapshot (both directions' policymaps) {size} bytes in {t_save!r}s, "
              f"{sw.secs['save_compiled_state']!r}s of it the serialize and fsync outside the lock "
              f"[{card}]", flush=True)

        # -- the full refresh + rebuild of the same world, beside it -----
        with uncounted():
            stamp = []
            t0 = time.perf_counter()
            full = PolicyEngine(engine.repo, engine.registry)
            full.refresh()
            torch.cuda.synchronize()
            t_full_refresh = time.perf_counter() - t0
            pfull = pipeline(full, cache)
            pfull.on_first_batch = lambda: stamp.append(time.perf_counter())
            pfull.rebuild()
            torch.cuda.synchronize()
            t_full_rebuild = time.perf_counter() - t0 - t_full_refresh
            run(pfull, "process", flows4)
            t_full_first = stamp[0] - t0
            del full, pfull

        # -- 2. trusted restore ------------------------------------------
        stamp = []
        k1_0 = k1()
        with Stopwatch((snapmod, "load_compiled_state"), (engmod, "device_policy_from_numpy"),
                       (matmod, "state_from_snapshot")) as sw:
            t0 = time.perf_counter()
            e2 = PolicyEngine(engine.repo, engine.registry)
            mats = e2.restore_snapshot(path, trust_counters=True)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
        if k1() != k1_0:
            fail("restore_snapshot launched K1: the selector match must be loaded, not recomputed")
        if mats is None or set(mats) != {TRAFFIC_INGRESS, TRAFFIC_EGRESS}:
            fail(f"restore_snapshot gave {None if mats is None else sorted(mats)}")
        p2 = pipeline(e2, cache)
        p2.on_first_batch = lambda: stamp.append(time.perf_counter())
        t1 = time.perf_counter()
        p2.rebuild()
        torch.cuda.synchronize()
        t_rebuild = time.perf_counter() - t1
        got = {fam: run(p2, call, flows) for fam, call, flows in batches}
        if len(stamp) != 1:
            fail(f"on_first_batch fired {len(stamp)} times")
        t_first = stamp[0] - t0
        for fam in (4, 6):
            if not same(got[fam], want[fam]):
                fail(f"restore: the trusted restore's v{fam} batch differs from the original's")
        if not np.array_equal(p2.counters, want_counters):
            fail("restore: the trusted restore's counters differ from the original's")
        _c, dev0 = engine.snapshot()
        if not words_equal(e2._device, dev0):
            fail("restore: the restored DevicePolicy's words differ from the original's")
        for d, m in mats.items():
            if not (torch.equal(m.tables.id_bits, pipe0._mat[d].tables.id_bits)
                    and np.array_equal(m.allow_nc, pipe0._mat[d].allow_nc)):
                fail(f"restore: the restored policymap of direction {d} differs from the original's")
        if e2.refresh() is not e2._compiled or e2._bg_refresh is not None:
            fail("restore: a trusted restore over the same objects refreshed")
        print(f"restore: trusted restore (load {sw.secs['load_compiled_state']!r}s, upload "
              f"{sw.secs['device_policy_from_numpy']!r}s, policymaps {sw.secs['state_from_snapshot']!r}s; "
              f"{t_restore!r}s in all, no K1), rebuild {t_rebuild!r}s, restore to the first "
              f"completed batch (on_first_batch) {t_first!r}s; beside it the full refresh "
              f"{t_full_refresh!r}s + rebuild {t_full_rebuild!r}s, to its first batch "
              f"{t_full_first!r}s; v4 and v6 1M-flow batches, counters and the DevicePolicy "
              f"words equal to the original's [{card}]", flush=True)
        del e2, p2

        # -- 3. untrusted restore, one rule, the background refresh -----
        repo2, reg2, cache2, _idents2, _labels2 = build_world(seed)
        e3 = PolicyEngine(repo2, reg2)
        if e3.restore_snapshot(path) is None or e3._compiled.revision != -1:
            fail("restore: the untrusted restore did not re-stamp the counters")
        repo2.add_list([rule(["k8s:app=a7"], ingress=[IngressRule(
            from_endpoints=(EndpointSelector.make(["k8s:app=a9"]),))], labels=["k8s:policy=restored"])])
        # the install, seen: the thread it runs on and whether the event
        # recorded after the side stream's upload and K1 had completed.
        # The computed result waits (off the lock) for the first batch on
        # the restored tables, so the install cannot race it
        installs = []
        first_rebuilt = threading.Event()
        real_install, real_compute = e3._install_compiled, e3._compute_full

        def watched_install(*a):
            ev = e3._bg_ready
            installs.append((threading.current_thread().name, ev is not None and ev.query()))
            return real_install(*a)

        def compute_after_first_rebuild(*a):
            out = real_compute(*a)
            first_rebuilt.wait(60)
            return out

        e3._install_compiled = watched_install
        e3._compute_full = compute_after_first_rebuild
        p3 = pipeline(e3, cache2)
        k1_0 = k1()
        t0 = time.perf_counter()
        if e3.refresh().revision != -1:  # kicks the background refresh
            fail("restore: refresh() on the untrusted restore did not return the restored compile")
        p3.rebuild()  # on the restored tables
        t_rebuild3 = time.perf_counter() - t0
        if p3._mat_basis[0] != -1:
            fail("restore: the first rebuild after the untrusted restore did not serve its tables")
        restored_tabs = {fam: p3._tables[(TRAFFIC_INGRESS, fam)] for fam in (4, 6)}
        fused3 = p3._v6_fused
        served, walls = [], []
        while (not served or e3._bg_refresh.is_alive()) and len(served) < RESTORE_MAX_SERVED:
            fam, call, flows = batches[len(served) % 2]
            t1 = time.perf_counter()
            out = run(p3, call, flows)
            walls.append(time.perf_counter() - t1)
            served.append((fam, out, p3._mat_basis[0]))
            first_rebuilt.set()
        if not e3.wait_refreshed(120):
            fail("restore: the background refresh did not land in 120 s")
        t_bg = time.perf_counter() - t0
        plain = {fam: plain_slice(restored_tabs[fam], fused3, len(endpoints), fam, flows)
                 for fam, _c, flows in batches}
        for fam in (4, 6):
            if not same([x[:RESTORE_SLICE] for x in want[fam]], plain[fam]):
                fail(f"restore: the restored tables' plain v{fam} path differs from the original's")
        during = [(fam, out) for fam, out, rev in served if rev == -1]
        for fam, out in during:
            if not same(out, want[fam]) or not same([x[:RESTORE_SLICE] for x in out], plain[fam]):
                fail(f"restore: a v{fam} batch served during the background refresh differs from "
                     "the restored tables' plain path")
        if not during:
            fail("restore: no batch was served on the restored tables during the background refresh")
        if len(installs) != 1 or installs[0][0] != "policyd-bg-refresh" or not installs[0][1]:
            fail(f"restore: the background install {installs}: expected one, on its thread, after "
                 "its recorded event completed")
        if k1() <= k1_0:
            fail("restore: the background refresh launched no K1")
        if e3.refresh().revision != repo2.revision:
            fail("restore: the background refresh did not land the new rule")
        p3.rebuild()
        got3 = {fam: run(p3, call, flows) for fam, call, flows in batches}
        with uncounted():
            fresh = PolicyEngine(repo2, reg2)
            pf3 = pipeline(fresh, cache2)
            pf3.rebuild()
            want3 = {fam: run(pf3, call, flows) for fam, call, flows in batches}
            del fresh, pf3
        for fam in (4, 6):
            if not same(got3[fam], want3[fam]):
                fail(f"restore: after the background refresh, v{fam} differs from a fresh engine's")
        print(f"restore: untrusted restore + one rule: the first rebuild (beside the background "
              f"compile) {t_rebuild3!r}s after the kick, the first batch done "
              f"{t_rebuild3 + walls[0]!r}s after it; {len(served)} batches served while the "
              f"background refresh ran ({len(during)} on the restored tables, each equal to the "
              f"original's and, on {RESTORE_SLICE} flows, to the CPU plain path over the restored "
              f"tables), walls {[round(w, 6) for w in walls]} s; kick to landed {t_bg!r}s, K1 "
              f"launches {k1() - k1_0}, the install on {installs[0][0]} after its recorded event "
              f"completed; after rebuild() v4 and v6 equal to a fresh engine's on the new rules "
              f"[{card}]", flush=True)
        del e3, p3, repo2, reg2, cache2

        # -- 4. the CT snapshot on the services world --------------------
        sengine, scache, manager = svc["pipe"].engine, svc["cache"], svc["manager"]
        ep_ids = [(10_000 + j, e) for j, e in enumerate(svc["endpoints"])]
        peer, s_eps, s_dports, s_protos, s_sports = svc["seqs"][4]["batch"]

        def spipe(eng, **kw):
            p = DatapathPipeline(eng, scache, PreFilter(), **kw)
            p.set_endpoints(ep_ids)
            return p

        def egress(p):
            tails = []
            real = p._dispatch_enqueue
            p._dispatch_enqueue = lambda s, fl, sel, *a, **k: tails.append(len(sel)) or real(
                s, fl, sel, *a, **k)
            try:
                v, r = p.process(peer, s_eps, s_dports, s_protos, ingress=False, sports=s_sports)
            finally:
                del p._dispatch_enqueue
            return v, r, tails

        pS = spipe(sengine, conntrack=FlowConntrack(capacity_bits=CT_BITS), lb=manager)
        v1, r1, _t = egress(pS)  # pass 1
        admitted = (v1 == FORWARD) & ~r1
        n_live = len(pS.conntrack)
        cpath, ctpath = os.path.join(tmp, "svc.npz"), os.path.join(tmp, "ct.npz")
        sengine.save_snapshot(cpath)
        t0 = time.perf_counter()
        ct_bytes = save_ct_state(ctpath, pS.conntrack, basis=pS._mat_basis, ct_epoch=pS._ct_epoch)
        t_ct_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        snap = load_ct_state(ctpath)
        t_ct_load = time.perf_counter() - t0
        disk_basis = snapmod.read_snapshot_basis(cpath)
        if snap is None or snap["entries"] != n_live or disk_basis != snap["basis"]:
            fail(f"restore: the CT snapshot ({None if snap is None else snap['entries']} entries, "
                 f"basis {None if snap is None else snap['basis']}) does not match the table "
                 f"({n_live}) or the compiled snapshot's basis {disk_basis}")
        counts = {}
        for case in ("held", "void"):
            eR = PolicyEngine(sengine.repo, sengine.registry)
            eR.restore_snapshot(cpath, trust_counters=True)
            pR = spipe(eR, conntrack=FlowConntrack(capacity_bits=CT_BITS), lb=manager)
            t0 = time.perf_counter()
            kept, expired = pR.conntrack.restore_arrays(
                snap["ka"], snap["kb"], snap["kc"], snap["ttl"], packets=snap["packets"],
                revnat=snap["revnat"])
            t_ct_restore = time.perf_counter() - t0
            pR._ct_restore_hold = eR._compiled.revision
            void = None
            if case == "void":
                void = rule(["k8s:app=restore-void"], ingress=[IngressRule(
                    from_endpoints=(EndpointSelector.make(["k8s:app=a1"]),))],
                    labels=["k8s:policy=restore-void"])
                sengine.repo.add_list([void])
            t0 = time.perf_counter()
            pR.rebuild()
            torch.cuda.synchronize()
            t_rb = time.perf_counter() - t0
            n_after = len(pR.conntrack)
            v2, r2, tails = egress(pR)  # pass 2
            if void is not None:
                from cilium_tpu_torch.labels import parse_label_array

                sengine.repo.delete_by_labels(parse_label_array(["k8s:policy=restore-void"]))
            counts[case] = dict(kept=kept, expired=expired, flushed=kept - n_after,
                                restore_s=t_ct_restore, rebuild_s=t_rb, tail=tails)
            if case == "held":
                if expired or kept != n_live or n_after != kept or pR._ct_restore_hold is not None:
                    fail(f"restore: the held rebuild kept {n_after} of {kept} restored entries "
                         f"({expired} expired, {n_live} saved)")
                if tails != [int((~admitted).sum())] or not (v2[admitted] == FORWARD).all():
                    fail(f"restore: pass 2 after the held rebuild sent {tails} flows to the device, "
                         f"expected the {int((~admitted).sum())} pass 1 did not admit")
            elif n_after != 0 or tails != [BATCH]:
                fail(f"restore: a rule added before the first rebuild left {n_after} restored "
                     f"entries; pass 2 sent {tails} flows to the device")
            del eR, pR
        print(f"restore: CT snapshot of the services world's {1 << CT_BITS}-slot table after "
              f"pass 1: {n_live} entries, {ct_bytes} bytes, save {t_ct_save!r}s, load "
              f"{t_ct_load!r}s (warm file), restore into a fresh table {counts['held']['restore_s']!r}s "
              f"/ {counts['void']['restore_s']!r}s; held rebuild {counts['held']['rebuild_s']!r}s "
              f"kept {counts['held']['kept']} expired {counts['held']['expired']} flushed "
              f"{counts['held']['flushed']}, pass 2's miss tail {counts['held']['tail']} (none "
              f"restored); with a rule added first: rebuild {counts['void']['rebuild_s']!r}s "
              f"flushed {counts['void']['flushed']}, miss tail {counts['void']['tail']} [{card}]",
              flush=True)

        # -- 5. the device CT under the hold -----------------------------
        pD = spipe(sengine, device_ct_bits=CT_BITS)
        pD.process(peer, s_eps, s_dports, s_protos, ingress=False, sports=s_sports)
        table = pD._device_ct
        if table is None:
            fail("restore: the device-CT batch left no device table")
        pD._ct_restore_hold = sengine._compiled.revision
        scache.upsert("203.0.113.250/32", svc["endpoints"][0], source="k8s")
        pD.rebuild()
        kept_dev = pD._device_ct is table
        scache.delete("203.0.113.250/32", source="k8s")
        pD.rebuild()
        if not kept_dev or pD._device_ct is not None:
            fail(f"restore: device CT kept by the held rebuild {kept_dev}, reset by the unheld "
                 f"one {pD._device_ct is None}")
        del pD
    wall = time.perf_counter() - t_phase
    over = "" if wall <= RESTORE_PHASE_LIMIT_S else " OVER ITS LIMIT"
    print(f"restore: a held rebuild (an ipcache move) kept the {1 << CT_BITS}-slot device CT, the "
          f"unheld one reset it; phase in {wall:.2f}s (limit {RESTORE_PHASE_LIMIT_S:.0f}s){over} "
          f"[{card}]", flush=True)


ENDPOINTS_PHASE_LIMIT_S = 60.0
NATIVE_CT_BITS = 22
NATIVE_THREADS = (1, 4)
NATIVE_REPS = 3  # batches each host thread evaluates for the rate


def stat_ms(xs):
    """p50 and max of seconds, in ms."""
    xs = sorted(xs)
    return f"p50 {xs[len(xs) // 2] * 1e3:.3f} / max {xs[-1] * 1e3:.3f} ms"


def launch_delta(before):
    from cilium_tpu_torch import _kernels

    return {k: v - before.get(k, 0) for k, v in _kernels.launches().items() if v != before.get(k, 0)}


def native_rate(nf, call: str, flows, threads: int) -> float:
    """Verdicts/s of ``threads`` host threads, each evaluating the whole
    batch NATIVE_REPS times on one NativeFastpath (ctypes drops the GIL
    for the call)."""
    import threading

    barrier = threading.Barrier(threads + 1)

    def work():
        barrier.wait()
        for _ in range(NATIVE_REPS):
            getattr(nf, call)(*flows, ingress=True)

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    return threads * NATIVE_REPS * flows[0].shape[0] / (time.perf_counter() - t0)


def native_agrees(what: str, card_out, native_out) -> None:
    import numpy as np

    (pv, pr), (nv, nr) = card_out, native_out
    bad = np.nonzero((pv != nv) | (pr != nr))[0]
    if bad.size:
        i = int(bad[0])
        fail(f"native: {what}: {bad.size} lanes differ from the card pipeline, first {i} "
             f"(card {int(pv[i])}/{bool(pr[i])}, native {int(nv[i])}/{bool(nr[i])})")


def endpoints_main_path(seed: int, card: str, flows4, flows6, svc, l7res):
    """Phase 3o: the realized per-endpoint policymaps and their
    regeneration on the card, and the native C++ enforcer fed from the
    port's tables (A7b), at the bench world's full width (10 000 rules,
    2 048 identities, 64 endpoints, 1 048 576-flow batches). The caller
    set the launch counts to 0; the refresh + rebuild runs timed beside
    the regeneration are uncounted."""
    import concurrent.futures
    import os

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.pipeline import (
        DROP_NO_SERVICE, DROP_POLICY, DROP_PREFILTER, FORWARD, DatapathPipeline,
    )
    from cilium_tpu_torch.endpoint import Endpoint, EndpointManager, EndpointState
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.l7 import HTTPPolicy, HTTPRequest, KafkaACL
    from cilium_tpu_torch.l7.http_policy import NativeL7Unsupported
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.maps.lxcmap import LXCMap
    from cilium_tpu_torch.native import NativeFastpath
    from cilium_tpu_torch.native import build as native_build
    from cilium_tpu_torch.ops import materialize as matmod
    from cilium_tpu_torch.policy.api import (
        EndpointSelector, HTTPRule, IngressRule, PortProtocol, PortRule, rule,
    )

    t_phase = time.perf_counter()
    # -- 1. endpoints ---------------------------------------------------
    repo, reg, cache, idents, labels_of = build_world(seed)
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]

    def fresh_pipe():
        pf = PreFilter()
        pf.insert(pf.revision, PREFILTER_CIDRS + V6_DENY)
        p = DatapathPipeline(PolicyEngine(repo, reg), cache, pf)
        p.set_endpoints(endpoints)
        return p

    def refresh_rebuild():
        """A second fresh engine's refresh + rebuild of the same world:
        its wall, launches and sweeps (a comparison run: uncounted)."""
        with uncounted():
            ref = fresh_pipe()
            matmod.SWEEPS.clear()
            before = _kernels.launches()
            t0 = time.perf_counter()
            ref.engine.refresh()
            ref.rebuild()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, launch_delta(before), dict(matmod.SWEEPS)

    # the world's first refresh + rebuild, then regenerate_all, then the
    # refresh + rebuild again: the last one is what the regeneration holds
    t_cold, _, _ = refresh_rebuild()
    pipe = fresh_pipe()
    mgr = EndpointManager()
    eps, syncs = [], {}
    for j, ident in enumerate(idents[:N_ENDPOINTS]):
        ep = Endpoint(ident.id, parse_label_array(labels_of[ident.id]),
                      ipv4=f"10.{(j >> 8) & 255}.{j & 255}.1",
                      ipv6=f"fd00::{(j >> 8) & 255:x}:{j & 255:x}")
        ep.set_identity(ident)
        real_sync = ep.sync_policy_map

        def sync(desired, _real=real_sync, _id=ep.id):
            syncs[_id] = _real(desired)
            return syncs[_id]

        ep.sync_policy_map = sync
        mgr.insert(ep)
        eps.append(ep)
    matmod.SWEEPS.clear()
    before = _kernels.launches()
    t0 = time.perf_counter()
    n_ok = mgr.regenerate_all(pipe, reason="phase 3o")
    torch.cuda.synchronize()
    t_regen = time.perf_counter() - t0
    regen_launches = launch_delta(before)
    regen_sweeps = dict(matmod.SWEEPS)
    stats = [ep.stats for ep in eps]
    t_ref, ref_launches, ref_sweeps = refresh_rebuild()
    # and on a thread of its own, as a builder runs it
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        t_ref_thread = ex.submit(refresh_rebuild).result()[0]

    def stats_line(stats):
        return (f"per endpoint total {stat_ms([s.total.total() for s in stats])}, policy "
                f"calculation {stat_ms([s.policy_calculation.total() for s in stats])}, map sync "
                f"{stat_ms([s.map_sync.total() for s in stats])}")

    print(f"endpoints: regenerate_all of {N_ENDPOINTS} endpoints on a fresh engine {t_regen!r}s "
          f"({os.cpu_count()} builder threads), launches {regen_launches}, sweeps {regen_sweeps}; "
          f"a fresh engine's refresh + rebuild of the same world before it {t_cold!r}s and after "
          f"it {t_ref!r}s (on a worker thread {t_ref_thread!r}s), launches {ref_launches}, sweeps "
          f"{ref_sweeps}; {stats_line(stats)} [{card}]", flush=True)
    if n_ok != N_ENDPOINTS:
        fail(f"endpoints: regenerate_all returned {n_ok}, not {N_ENDPOINTS}")
    if (regen_launches != ref_launches or regen_launches.get("selector_match") != 1
            or set(regen_launches) != {"selector_match", "bool_mm"}
            or regen_sweeps != ref_sweeps or sum(regen_sweeps.values()) != 2):
        fail(f"endpoints: regenerate_all launched {regen_launches} with sweeps {regen_sweeps}, "
             f"one refresh + rebuild {ref_launches} with {ref_sweeps}")

    def check_maps(what):
        snaps = pipe.snapshots()
        rev = pipe.engine._compiled.revision
        for ep in eps:
            got = {k: e.proxy_port for k, e in ep.policy_map.dump()}
            if (ep.state != EndpointState.READY or ep.policy_revision != rev
                    or got != snaps[pipe.endpoint_index(ep.id)].entries):
                fail(f"endpoints ({what}): endpoint {ep.id} is {ep.state.value} at revision "
                     f"{ep.policy_revision} (compiled {rev}), or its policy map differs from "
                     "the pipeline's snapshot")
        return snaps

    snaps = check_maps("first regeneration")
    n_entries = sum(len(s.entries) for s in snaps)
    realized = {ep.id: {k: e.proxy_port for k, e in ep.policy_map.dump()} for ep in eps}
    app0, app1 = labels_of[endpoints[0]][0], labels_of[endpoints[1]][0]
    repo.add_list([rule([app0], ingress=[IngressRule(
        from_endpoints=(EndpointSelector.make([app1]),),
        to_ports=(PortRule(ports=(PortProtocol(9443, "TCP"),)),))])])
    syncs.clear()
    before = _kernels.launches()
    t0 = time.perf_counter()
    n_ok = mgr.regenerate_all(pipe, reason="rule added")
    torch.cuda.synchronize()
    t_delta = time.perf_counter() - t0
    delta_launches = launch_delta(before)
    snaps = check_maps("after the rule")
    want_add = want_del = 0
    for ep in eps:
        new, old = snaps[pipe.endpoint_index(ep.id)].entries, realized[ep.id]
        want_add += sum(1 for k, v in new.items() if old.get(k) != v)
        want_del += sum(1 for k in old if k not in new)
    got_add = sum(a for a, _ in syncs.values())
    got_del = sum(d for _, d in syncs.values())
    print(f"endpoints: {n_entries} ingress policymap entries over {N_ENDPOINTS} endpoints; one "
          f"rule added ({app0} from {app1} on 9443/TCP), regenerate_all {t_delta!r}s, launches "
          f"{delta_launches}, sync_policy_map added {got_add} deleted {got_del} (the snapshot "
          f"diff: {want_add} / {want_del}); {stats_line([ep.stats for ep in eps])} [{card}]",
          flush=True)
    if n_ok != N_ENDPOINTS or (got_add, got_del) != (want_add, want_del) or got_add <= 0:
        fail(f"endpoints: after the rule {n_ok} regenerated, syncs added / deleted {got_add} / "
             f"{got_del}, the snapshot diff {want_add} / {want_del}")
    if delta_launches.get("selector_match"):
        fail("endpoints: a rule append launched K1 (the engine recompiled in full)")
    lxc = LXCMap()
    n_lxc = lxc.sync_endpoints(mgr.endpoints())
    if n_lxc != 2 * N_ENDPOINTS or lxc.lookup(eps[5].ipv6).endpoint_id != eps[5].id:
        fail(f"endpoints: LXCMap.sync_endpoints gave {n_lxc} entries")
    mgr.shutdown()

    # -- 2. native, L3/L4 ------------------------------------------------
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    native_build.load()  # a build failure raises: this step is never skipped
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    nf = NativeFastpath.from_pipeline(pipe, ct_bits=NATIVE_CT_BITS)
    t_load = time.perf_counter() - t0
    n_loaded = sum(len({**a.entries, **b.entries})
                   for a, b in zip(pipe.snapshots(True), pipe.snapshots(False)))
    print(f"native: fastpath.cpp built and loaded in {t_build!r}s ({gxx.splitlines()[0]}, "
          f"cached by source hash in {native_build._CACHE_DIR}); from_pipeline(ct_bits={NATIVE_CT_BITS}) {t_load!r}s, "
          f"{n_loaded} policy entries of both directions [host CPU]", flush=True)
    before_counters = pipe.counters.copy()
    for fam, call, flows in ((4, "process", flows4), (6, "process_v6", flows6)):
        for ingress in (True, False):
            t0 = time.perf_counter()
            card_out = getattr(pipe, call)(*flows, ingress=ingress)
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            nat_out = getattr(nf, call)(*flows, ingress=ingress)
            t_nat = time.perf_counter() - t0
            what = f"v{fam} {'ingress' if ingress else 'egress'}"
            native_agrees(what, card_out, nat_out)
            print(f"native [{what}]: {BATCH} flows equal to the card pipeline on every lane "
                  f"(verdicts {collections_counter(card_out[0])}, redirects "
                  f"{int(card_out[1].sum())}); card process {t_card!r}s, native one thread "
                  f"{t_nat!r}s [{card}]", flush=True)
    counted = pipe.counters - before_counters
    if not np.array_equal(nf.counters, counted):
        fail("native: per-endpoint counters differ from the card pipeline's")
    rates = {(call, k): native_rate(nf, call, flows, k)
             for call, flows in (("process", flows4), ("process_v6", flows6))
             for k in NATIVE_THREADS}
    card_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.process(*flows4)
        card_ms.append(time.perf_counter() - t0)
    t_card = sorted(card_ms)[1]
    print(f"native rates (host CPU of the card's machine, {os.cpu_count()} cores): v4 "
          + ", ".join(f"{k} thread(s) {rates[('process', k)]!r}" for k in NATIVE_THREADS)
          + " verdicts/s; v6 "
          + ", ".join(f"{k} thread(s) {rates[('process_v6', k)]!r}" for k in NATIVE_THREADS)
          + f" verdicts/s; the card pipeline's process() of the same v4 batch {card_ms}s (median "
          f"{t_card!r}s = {BATCH / t_card!r} verdicts/s); counters equal over the four batches "
          f"[{card}]", flush=True)

    # -- 3. native LB --------------------------------------------------
    lb_pipe = DatapathPipeline(svc["pipe"].engine, svc["cache"], PreFilter(), lb=svc["manager"])
    lb_pipe.set_endpoints([(10_000 + j, e) for j, e in enumerate(svc["endpoints"])])
    t0 = time.perf_counter()
    nf_lb = NativeFastpath.from_pipeline(lb_pipe, ct_bits=NATIVE_CT_BITS)
    t_lb_load = time.perf_counter() - t0
    before = _kernels.launches()
    for fam, call in ((4, "process"), (6, "process_v6")):
        peer, s_eps, s_dports, s_protos = svc["seqs"][fam]["batch"][:4]
        t0 = time.perf_counter()
        card_out = getattr(lb_pipe, call)(peer, s_eps, s_dports, s_protos, ingress=False)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat_out = getattr(nf_lb, call)(peer, s_eps, s_dports, s_protos, ingress=False)
        t_nat = time.perf_counter() - t0
        native_agrees(f"LB v{fam} egress", card_out, nat_out)
        kinds = collections_counter(card_out[0])
        print(f"native LB [v{fam} egress, no CT]: {BATCH} flows equal to the card pipeline on "
              f"every lane (verdicts {kinds}); card process {t_card!r}s, native {t_nat!r}s; "
              f"from_pipeline of the services world {t_lb_load!r}s [{card}]", flush=True)
        if not {FORWARD, DROP_POLICY, DROP_NO_SERVICE} <= set(kinds):
            fail(f"native LB v{fam}: the batch missed a verdict class: {kinds}")
    lb_launches = launch_delta(before)
    if lb_launches.get("lb_translate") != 2 or lb_launches.get("lb_index_build") != 2:
        fail(f"native LB: the card pipeline's two egress batches launched K9 {lb_launches}")
    del lb_pipe, nf_lb

    # -- 4. native L7 --------------------------------------------------
    rs = np.random.default_rng(seed + 33)
    scope = {i.id for i in idents[:64]}
    pol = HTTPPolicy([(HTTPRule(method=["GET", "POST", ""][i % 3], path=p),
                       scope if i % 4 == 0 else None) for i, p in enumerate(L7_PATHS)])
    if pol._paths.host_pids or pol.device.type != "cuda":
        fail("native L7: the corpus policy demoted a pattern or is not on the card")
    paths = ([f"/api/v{a}/obj{a * 7}" for a in range(10)] + [f"/svc{a}/x/y" for a in range(10)]
             + ["/api/v1/", "/svc3", "/nope", "/api/v2/" + "a" * 300])
    ids = np.array([i.id for i in idents])
    reqs = [HTTPRequest(method=m, path=paths[k], src_identity=int(sid))
            for m, k, sid in zip(rs.choice(["GET", "POST", "PUT"], L7_BATCH).tolist(),
                                 rs.integers(0, len(paths), L7_BATCH).tolist(),
                                 rs.choice(ids[:128], L7_BATCH).tolist())]
    nf_l7 = NativeFastpath(ep_count=1, ct_bits=0)
    t0 = time.perf_counter()
    nf_l7.load_l7_http(7, 80, pol)
    t_l7_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = pol.check_batch(reqs)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = nf_l7.check_http_batch(7, 80, reqs)
    t_nat = time.perf_counter() - t0
    if not np.array_equal(got, want) or not (want.any() and not want.all()):
        fail(f"native L7: check_http_batch differs from the card's check_batch on "
             f"{int((got != want).sum())} requests ({int(want.sum())} allowed)")
    acl = KafkaACL(l7res["k_rules"])
    nf_l7.load_l7_kafka(7, 9092, acl)
    t0 = time.perf_counter()
    kwant = np.asarray(acl.check_batch(l7res["k_reqs"]))
    t_kcard = time.perf_counter() - t0
    t0 = time.perf_counter()
    kgot = nf_l7.check_kafka_batch(7, 9092, l7res["k_reqs"])
    t_knat = time.perf_counter() - t0
    if not np.array_equal(kgot, kwant) or not (kwant.any() and not kwant.all()):
        fail(f"native L7: check_kafka_batch differs from the card's on "
             f"{int((kgot != kwant).sum())} requests")
    try:
        nf_l7.load_l7_http(7, 81, l7res["pol_b"])
        fail("native L7: the pattern-cap policy (one pattern demoted to host re) was loaded")
    except NativeL7Unsupported:
        pass
    print(f"native L7: the corpus policy ({len(L7_PATHS)} path patterns) loaded in {t_l7_load!r}s; "
          f"{L7_BATCH} requests, card check_batch {t_card!r}s, native {t_nat!r}s, equal "
          f"({int(want.sum())} allowed); Kafka ACL {len(l7res['k_reqs'])} requests, card "
          f"{t_kcard!r}s, native {t_knat!r}s, equal ({int(kwant.sum())} allowed); the pattern-cap "
          f"policy refused (NativeL7Unsupported) [{card}]", flush=True)
    wall = time.perf_counter() - t_phase
    over = "" if wall <= ENDPOINTS_PHASE_LIMIT_S else " OVER ITS LIMIT"
    print(f"endpoints and native: phase in {wall:.2f}s (limit {ENDPOINTS_PHASE_LIMIT_S:.0f}s)"
          f"{over} [{card}]", flush=True)


# -- 3p. distributed state ------------------------------------------------------

DIST_PHASE_LIMIT_S = 60.0
# agent A owns label set i when i % DIST_OWNER_A == 0: its 256 label
# sets' 512 addresses are one ipcache delta window (IPCache.DELTA_LOG_CAP),
# so B's rebuild after A's lease death can take them as one trie patch
DIST_OWNER_A = 8
DIST_SYNC_S = 30.0  # the most a watch may take to deliver what the store holds
DIST_EPOCH_TIMEOUT_S = 30.0  # wait_cluster_epoch's bound
DIST_CHILD_TIMEOUT_S = 180.0
DIST_CHILD_FLOWS = 1 << 16
DIST_CHILD_EPS = 8

DIST_CHILD = r'''
import hashlib, json, sys, time
sys.path.insert(0, {root!r})
import numpy as np

from cilium_tpu_torch.datapath import placement
from cilium_tpu_torch.federation import mesh_bootstrap, placement_config
import chip_smoke

t0 = time.perf_counter()
summary = mesh_bootstrap({coord!r}, 2, {rank})
wall = time.perf_counter() - t0
cfg = placement_config()
plan = placement.resolve_plan(cfg, sharding=True)
recs = [r for r in placement.visible_devices() if r.id in plan.device_ids]
v, red, launches = chip_smoke.dist_small_batch({seed}, recs[0].device)
print(json.dumps({{
    "summary": summary, "bootstrap_s": wall, "generation": plan.generation,
    "axes": plan.axes, "device_ids": list(plan.device_ids),
    "owners": [r.process_index for r in recs], "device": str(recs[0].device),
    "digest": hashlib.sha256(v.tobytes() + red.tobytes()).hexdigest(),
    "verdicts": np.bincount(v, minlength=4).tolist(), "launches": launches,
}}))
'''


def dist_small_batch(seed: int, dev):
    """Phase 3p's bootstrapped processes' batch: the small world on
    ``dev``, DIST_CHILD_FLOWS v4 flows over its 48 identity addresses and
    one world address → (verdicts, redirects, the launches it made)."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine

    repo, reg, cache, idents = build_small_world(seed)
    before = _kernels.launches()
    pipe = DatapathPipeline(PolicyEngine(repo, reg, device=dev), cache, device=dev)
    pipe.set_endpoints([i.id for i in idents[:DIST_CHILD_EPS]])
    pipe.rebuild()
    rs = np.random.default_rng(seed + 3)
    peers = np.array([(172 << 24) | (16 << 16) | (i + 1) for i in range(len(idents))]
                     + [int(ipaddress.IPv4Address("8.8.8.8"))], np.uint32)
    ips = peers[rs.integers(0, len(peers), DIST_CHILD_FLOWS)]
    eps = rs.integers(0, DIST_CHILD_EPS, DIST_CHILD_FLOWS).astype(np.int32)
    dports = rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), DIST_CHILD_FLOWS)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    v, red = pipe.process(ips, eps, dports.astype(np.int32), protos)
    torch.cuda.synchronize()
    return v, red, launch_delta(before)


class DistAgent:
    """One node of phase 3p: its kvstore client, its own copy of the
    bench repository, an IdentityRegistry behind a
    DistributedIdentityAllocator, an IPCache behind an IPIdentitySync, a
    PolicyEngine and, once built, a DatapathPipeline on the card.
    ``registry`` and ``pipeline`` are what a FederationMember reads of
    its daemon."""

    def __init__(self, name: str, backend, repo, host_ip: str, sparse: bool):
        from cilium_tpu_torch.engine import PolicyEngine
        from cilium_tpu_torch.identity import IdentityRegistry
        from cilium_tpu_torch.identity.distributed import DistributedIdentityAllocator
        from cilium_tpu_torch.ipcache.ipcache import IPCache
        from cilium_tpu_torch.ipcache.kvstore_sync import IPIdentitySync

        self.name, self.backend, self.repo = name, backend, repo
        self.host_ip, self.sparse = host_ip, sparse
        self.registry = IdentityRegistry()
        self.ident = DistributedIdentityAllocator(backend, self.registry, name)
        self.ipcache = IPCache()
        self.ipsync = IPIdentitySync(backend, self.ipcache)
        self.engine = PolicyEngine(repo, self.registry)
        self.pipeline = None
        self.alloc_s = []
        self.announce_s = 0.0
        self.held = set()  # the identity ids this agent allocated

    def pump(self) -> int:
        return self.ident.pump() + self.ipsync.pump()

    def make_pipeline(self, ep_labels, *, engine=None, sparse=None, **kw):
        """A pipeline on the card over this agent's ipcache and no
        prefilter (the sparse path patches a family with no deny set),
        its endpoints the identities of ``ep_labels`` here."""
        from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
        from cilium_tpu_torch.ipcache.prefilter import PreFilter

        pipe = DatapathPipeline(engine or self.engine, self.ipcache, PreFilter(),
                                sparse_deltas=self.sparse if sparse is None else sparse, **kw)
        pipe.set_endpoints([self.registry.lookup_by_labels(lbls).id for lbls in ep_labels])
        pipe.rebuild()
        return pipe

    def close(self) -> None:
        for stop in (self.ident.close, self.ipsync.close):
            try:
                stop()
            except (OSError, RuntimeError):
                pass  # the backend died with its lease or its server


def dist_wait(what: str, done, pump) -> float:
    """Pump until ``done()``; the wall it took. Fails after DIST_SYNC_S."""
    t0 = time.perf_counter()
    while not done():
        if time.perf_counter() - t0 > DIST_SYNC_S:
            fail(f"distributed: {what} did not arrive within {DIST_SYNC_S:.0f}s")
        if not pump():
            time.sleep(0.0005)
    return time.perf_counter() - t0


def dist_results(pipe, flows4, flows6):
    """(verdicts, redirects, per-endpoint counters) of the v4 and v6
    batches, ingress then egress, each with the counters zeroed first."""
    out = []
    for call, flows in (("process", flows4), ("process_v6", flows6)):
        for ingress in (True, False):
            pipe.counters[:] = 0
            v, red = getattr(pipe, call)(*flows, ingress=ingress)
            out.append((v, red, pipe.counters.copy()))
    return out


def dist_same(what: str, got, want) -> None:
    import numpy as np

    for (gv, gr, gc), (wv, wr, wc), batch in zip(got, want, ("v4 ingress", "v4 egress",
                                                              "v6 ingress", "v6 egress")):
        bad = np.nonzero((gv != wv) | (gr != wr))[0]
        if bad.size:
            i = int(bad[0])
            fail(f"distributed: {what}: {batch}: {bad.size} lanes differ, first {i} "
                 f"({int(gv[i])}/{bool(gr[i])} against {int(wv[i])}/{bool(wr[i])})")
        if not np.array_equal(gc, wc):
            fail(f"distributed: {what}: {batch}: per-endpoint counters differ")


def distributed_main_path(seed: int, card: str, flows4, flows6, svc):
    """Phase 3p: distributed state on the card (A9a) at the bench world's
    full width (10 000 rules, 2 048 identities, 64 endpoints, 1 048 576-flow
    batches): two agents over one kvstore, A in memory on the server's
    store and B over TCP, converging to equal registries, ipcaches and
    policymap tables; A's lease death and the GC after it on B; the
    federation epoch across both; clustermesh services merged into B;
    and two processes bootstrapped into one torch.distributed mesh. The
    caller set the launch counts to 0. What the agents are held against
    is uncounted: the single-node and fresh pipelines, B's second
    pipeline without sparse deltas, the pipeline given the merged
    services directly, and this process's own small-world batch. On a
    one-card machine each bootstrapped child sees only its own card, so
    the plan check shows the rank tag on the records and the agreement of
    generation and axes, not the process_index filter against the
    fallback: tests/test_torch_mesh_bootstrap.py shows that on two
    cards a process."""
    import hashlib
    import os

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels, metrics
    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import (
        TRAFFIC_EGRESS, TRAFFIC_INGRESS, DatapathPipeline,
    )
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.federation import FederationMember
    from cilium_tpu_torch.ipcache.ipcache import SOURCE_KVSTORE
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.kvstore import (
        ClusterMesh, InMemoryBackend, InMemoryStore, KVStoreServer, NetBackend,
    )
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.lb import ServiceManager
    from cilium_tpu_torch.ops import materialize as matmod
    from cilium_tpu_torch.policy.api import (
        EndpointSelector, IngressRule, PortProtocol, PortRule, rule,
    )

    t_phase = time.perf_counter()
    opened = []  # closed on every way out, last first
    procs = []
    try:
        # -- 1. two agents over one kvstore ---------------------------------
        server = KVStoreServer().start()
        opened.append(server.stop)
        _, _, _, idents, labels_of = build_world(seed)
        labels = [parse_label_array(labels_of[i.id]) for i in idents]
        a = DistAgent("node-a", InMemoryBackend(server.store, "node-a"), build_world(seed)[0],
                      "192.168.0.1", sparse=False)
        opened.append(a.close)
        b = DistAgent("node-b", NetBackend(server.url, "node-b"), build_world(seed)[0],
                      "192.168.0.2", sparse=True)
        opened += [b.backend.close, b.close]
        matmod.SWEEPS.clear()

        def owns_a(i):
            return i % DIST_OWNER_A == 0

        def both(i):  # overlap: the other agent allocates it as well
            return i % (2 * DIST_OWNER_A) == 0 or i % DIST_OWNER_A == 1

        newest = 0  # the highest identity allocated yet
        for i, lbls in enumerate(labels):
            owner, other = (a, b) if owns_a(i) else (b, a)
            for ag in (owner, other) if both(i) else (owner,):
                # an agent allocates only once its watch has delivered
                # every earlier allocation (a watch delivers in order),
                # so both registries insert in one order and give each
                # identity the same row
                dist_wait(f"{ag.name}'s mirror of identity {newest}",
                          lambda ag=ag: not newest or ag.registry.get(newest) is not None,
                          ag.ident.pump)
                t0 = time.perf_counter()
                num = ag.ident.allocate(lbls).id
                ag.alloc_s.append(time.perf_counter() - t0)
                ag.held.add(num)
                newest = max(newest, num)
        for i, lbls in enumerate(labels):
            owner = a if owns_a(i) else b
            num = owner.registry.lookup_by_labels(lbls).id
            t0 = time.perf_counter()
            for cidr in (f"10.{(i >> 8) & 255}.{i & 255}.1/32",
                         f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128"):
                owner.ipcache.upsert(cidr, num, source="k8s")
                owner.ipsync.announce(cidr, num, host_ip=owner.host_ip)
            owner.announce_s += time.perf_counter() - t0
        n_entries = 2 * len(labels)
        # converged: every entry of both ipcaches learned from the store
        t_pump = dist_wait("the announcements",
                           lambda: all(len(x.ipcache) == n_entries and all(
                               e.source == SOURCE_KVSTORE for _, e in x.ipcache.items())
                               for x in (a, b)),
                           lambda: a.pump() + b.pump())
        ids = {x.name: {i.id: i.labels for i in x.registry} for x in (a, b)}
        rows = {x.name: {n: x.registry.row(n) for n in ids[x.name]} for x in (a, b)}
        if ids["node-a"] != ids["node-b"] or rows["node-a"] != rows["node-b"]:
            fail(f"distributed: the registries differ ({len(ids['node-a'])} / "
                 f"{len(ids['node-b'])} identities, rows equal: {rows['node-a'] == rows['node-b']})")
        if dict(a.ipcache.items()) != dict(b.ipcache.items()):
            fail("distributed: the two ipcaches hold different entries")
        n_a, n_b = len(a.alloc_s), len(b.alloc_s)
        print(f"distributed: {len(labels)} label sets allocated interleaved, {n_a} on A "
              f"(InMemoryBackend on the server's store) and {n_b} on B (NetBackend over TCP "
              f"loopback), {len(a.held & b.held)} by both; {len(a.held | b.held)} identities. CAS "
              f"allocation wall per identity: in memory {stat_ms(a.alloc_s)}, mean "
              f"{sum(a.alloc_s) / n_a * 1e3:.3f} ms; over TCP {stat_ms(b.alloc_s)}, mean "
              f"{sum(b.alloc_s) / n_b * 1e3:.3f} ms. Announcements: A {len(a.ipsync._announced)} "
              f"in {a.announce_s!r}s, B {len(b.ipsync._announced)} in {b.announce_s!r}s; pump to "
              f"convergence {t_pump!r}s; registries (ids, labels, rows) and ipcaches ({n_entries} "
              f"entries) equal [{card}]", flush=True)

        # the endpoints: label sets B holds itself, so they outlive A
        ep_idx = [i for i, lbls in enumerate(labels)
                  if b.registry.lookup_by_labels(lbls).id in b.held][:N_ENDPOINTS]
        ep_labels = [labels[i] for i in ep_idx]
        walls = {}
        for ag in (a, b):
            t0 = time.perf_counter()
            ag.engine.refresh()
            ag.pipeline = ag.make_pipeline(ep_labels)
            torch.cuda.synchronize()
            walls[ag.name] = time.perf_counter() - t0
        built = _kernels.launches()
        sweeps = dict(matmod.SWEEPS)
        print(f"distributed: refresh + rebuild A {walls['node-a']!r}s, B (sparse deltas) "
              f"{walls['node-b']!r}s; launches from zero {built}, sweeps {sweeps} [{card}]",
              flush=True)
        if built["selector_match"] != 2 or sum(sweeps.values()) != 4:
            fail(f"distributed: the two agents' refresh + rebuild launched K1 "
                 f"{built['selector_match']} times and swept {sweeps}: one K1 and two sweeps "
                 "an agent expected")
        for d, dn in ((TRAFFIC_INGRESS, "ingress"), (TRAFFIC_EGRESS, "egress")):
            ta, tb = a.pipeline._mat[d].tables.id_bits, b.pipeline._mat[d].tables.id_bits
            if ta.device.type != "cuda" or tb.device.type != "cuda":
                fail(f"distributed: the agents' {dn} policymap id_bits are not on the card")
            if not torch.equal(ta, tb):
                fail(f"distributed: the agents' {dn} policymap id_bits differ")
        res_a = dist_results(a.pipeline, flows4[:4], flows6[:4])
        res_b = dist_results(b.pipeline, flows4[:4], flows6[:4])
        dist_same("B against A", res_b, res_a)
        with uncounted():
            # the single-node bench pipeline: the same world through one
            # registry; identity numbers may differ, verdicts may not
            repo1, reg1, cache1, idents1, _ = build_world(seed)
            single = DatapathPipeline(PolicyEngine(repo1, reg1), cache1, PreFilter())
            single.set_endpoints([idents1[i].id for i in ep_idx])
            single.rebuild()
            res_1 = dist_results(single, flows4[:4], flows6[:4])
            # B's state through a second pipeline without sparse deltas
            b_full = b.make_pipeline(ep_labels, sparse=False)
        dist_same("A against the single-node pipeline", res_a, res_1)
        hist = np.bincount(res_b[0][0], minlength=4)[1:].tolist()
        print(f"distributed: policymap id_bits of both directions equal on the card "
              f"({tuple(a.pipeline._mat[TRAFFIC_INGRESS].tables.id_bits.shape)} words); the "
              f"1 048 576-flow v4 and v6 batches, ingress and egress: verdicts, redirects and "
              f"counters of A == B == the single-node pipeline on every lane (v4 ingress "
              f"verdicts {hist}) [{card}]", flush=True)

        # -- 2. A's lease dies; GC --------------------------------------------
        gone = set(a.ipsync._announced)
        mirrors = dict(b.pipeline._trie_patch)
        p0 = {f: metrics.lpm_trie_patches_total.get({"family": str(f)}) for f in (4, 6)}
        server.store.revoke_lease(a.backend.lease_id)
        t_gone = dist_wait("A's withdrawn announcements",
                           lambda: not any(b.ipcache.lookup_exact(c) for c in gone), b.pump)
        before = _kernels.launches()
        t0 = time.perf_counter()
        b.pipeline.rebuild()
        torch.cuda.synchronize()
        t_patch = time.perf_counter() - t0
        patch_launches = launch_delta(before)
        patched = {f: metrics.lpm_trie_patches_total.get({"family": str(f)}) - p0[f]
                   for f in (4, 6)}
        with uncounted():
            t0 = time.perf_counter()
            b_full.rebuild()
            torch.cuda.synchronize()
            t_full = time.perf_counter() - t0
        kept = all(b.pipeline._trie_patch[f] is mirrors[f] for f in (4, 6))
        if not kept or patched != {4: len(gone) // 2, 6: len(gone) // 2}:
            fail(f"distributed: B's rebuild after A's lease death did not patch its tries "
                 f"(mirrors kept: {kept}, prefixes patched {patched} of {len(gone)})")
        with uncounted():
            fresh = b.make_pipeline(ep_labels, sparse=False)
            res_fresh = dist_results(fresh, flows4[:4], flows6[:4])
            res_full = dist_results(b_full, flows4[:4], flows6[:4])
        dist_same("B after A's lease death against a fresh pipeline", dist_results(
            b.pipeline, flows4[:4], flows6[:4]), res_fresh)
        dist_same("B's sparse-off pipeline after A's lease death", res_full, res_fresh)
        print(f"distributed: A's lease revoked; its {len(gone)} announcements left B's ipcache "
              f"in {t_gone!r}s; B's rebuild on the patched tries {t_patch!r}s (prefixes patched "
              f"{patched}, launches {patch_launches}), a full trie rebuild of the same "
              f"state (sparse deltas off) {t_full!r}s; both == a fresh pipeline on every lane "
              f"[{card}]", flush=True)

        expect = a.held - b.held
        t0 = time.perf_counter()
        reaped = b.ident.run_gc()
        t_gc = time.perf_counter() - t0
        if set(reaped) != expect or not reaped:
            fail(f"distributed: GC reaped {len(reaped)} identities, {len(expect)} held only by A")
        t_rel = dist_wait("the master-key deletes",
                          lambda: all(b.registry.get(n) is None for n in reaped), b.pump)
        r0 = {k: metrics.engine_refreshes_total.get({"kind": k}) for k in ("full", "incremental")}
        before = _kernels.launches()
        t0 = time.perf_counter()
        b.engine.refresh()
        b.engine.wait_device()
        kinds = [k for _, k, _ in b.engine.deltas_since(b.pipeline._last_delta_seq)]
        b.pipeline.rebuild()
        torch.cuda.synchronize()
        t_delta = time.perf_counter() - t0
        gc_launches = launch_delta(before)
        r1 = {k: metrics.engine_refreshes_total.get({"kind": k}) - r0[k] for k in r0}
        if r1 != {"full": 0, "incremental": 1} or kinds != ["rows"] or "selector_match" in gc_launches:
            fail(f"distributed: the GC release was not an identity delta (refreshes {r1}, "
                 f"deltas {kinds}, launches {gc_launches})")
        with uncounted():
            t0 = time.perf_counter()
            b_full.rebuild()
            torch.cuda.synchronize()
            t_full_gc = time.perf_counter() - t0
            fresh = b.make_pipeline(ep_labels, engine=PolicyEngine(b.repo, b.registry),
                                    sparse=False)
            res_fresh = dist_results(fresh, flows4[:4], flows6[:4])
            res_full = dist_results(b_full, flows4[:4], flows6[:4])
        dist_same("B after the GC against a fresh engine and pipeline", dist_results(
            b.pipeline, flows4[:4], flows6[:4]), res_fresh)
        dist_same("B's sparse-off pipeline after the GC", res_full, res_fresh)
        del fresh, single
        print(f"distributed: GC over TCP reaped {len(reaped)} identities held only by A in "
              f"{t_gc!r}s, B's registry released them in {t_rel!r}s; B's refresh took them as "
              f"an identity delta ({kinds}) and refresh + rebuild ran in {t_delta!r}s (launches "
              f"{gc_launches}), the sparse-off pipeline's rebuild {t_full_gc!r}s; both == a "
              f"fresh engine's full compile and pipeline on every lane [{card}]", flush=True)

        # -- 3. federation ----------------------------------------------------
        a_backend = InMemoryBackend(server.store, "node-a")  # A restarts: a new session
        members = []
        for ag, be in ((a, a_backend), (b, b.backend)):
            mem = FederationMember(ag, be, ag.name, heartbeat_interval=3600.0)
            opened.append(mem.close)
            members.append(mem)
            ag.pipeline.set_epoch_swap(True)
        app0, app1 = (labels_of[idents[i].id][0] for i in ep_idx[:2])
        push = rule([app0], ingress=[IngressRule(
            from_endpoints=(EndpointSelector.make([app1]),),
            to_ports=(PortRule(ports=(PortProtocol(9443, "TCP"),)),))])
        t0 = time.perf_counter()
        for ag in (a, b):
            ag.repo.add_list([push])
            ag.engine.refresh()
            ag.pipeline.rebuild()  # kicks the shadow build
        for ag in (a, b):
            if not ag.pipeline.wait_epoch_swap(timeout=60.0):
                fail(f"distributed: {ag.name}'s shadow build did not finish")
            ag.pipeline.rebuild()  # publishes the swapped generation
        t_swap = time.perf_counter() - t0
        epochs = [ag.pipeline.policy_epoch for ag in (a, b)]
        if epochs != [1, 1]:
            fail(f"distributed: the rule push left policy epochs {epochs}, not [1, 1]")
        converged = members[0].wait_cluster_epoch(
            1, timeout=DIST_EPOCH_TIMEOUT_S, min_nodes=2,
            pump=lambda: [mem.pump() for mem in members])
        t_conv = time.perf_counter() - t0
        st = members[0].status()
        if not converged or st["cluster_epoch"] != 1 or st["epoch_lag"] != 0 or st["node_count"] != 2:
            fail(f"distributed: the cluster epoch did not converge within "
                 f"{DIST_EPOCH_TIMEOUT_S:.0f}s ({st['cluster_epoch']}, lag {st['epoch_lag']}, "
                 f"{st['node_count']} nodes)")
        print(f"distributed: one rule pushed at both agents ({app0} from {app1} on 9443/TCP), "
              f"each pipeline's shadow build swapped in (policy_epoch {epochs}) "
              f"{t_swap!r}s after the push; wait_cluster_epoch(1) converged {t_conv!r}s after "
              f"it (bound {DIST_EPOCH_TIMEOUT_S:.0f}s) [{card}]", flush=True)

        # -- 4. clustermesh services ----------------------------------------
        remote_store = InMemoryStore()
        remote = ServiceManager()
        local = ServiceManager()
        fes = [s for s in svc["manager"].list() if s.frontend.family == 4]
        n_local = n_remote = 0
        for s in fes:
            half = (len(s.backends) + 1) // 2
            local.upsert(s.frontend, s.backends[:half])
            remote.upsert(s.frontend, s.backends[half:])
            n_local += half
            n_remote += len(s.backends) - half
        remote.export_to_store(InMemoryBackend(remote_store, "east-agent"), "east")
        mesh = ClusterMesh(b.registry, b.ipcache, services=local)
        opened.append(mesh.close)
        mesh.add_cluster("east", InMemoryBackend(remote_store, "node-b-mesh"))
        mesh.pump()
        direct = ServiceManager()
        for s in local.list():
            direct.upsert(s.frontend, local.effective_backends(s.frontend))
        merged = sum(len(local.effective_backends(s.frontend)) for s in fes)
        if merged != n_local + n_remote or [s.id for s in direct.list()] != [s.id for s in local.list()]:
            fail(f"distributed: clustermesh merged {merged} backends, {n_local} local + "
                 f"{n_remote} remote expected")
        peer, s_eps, s_dports, s_protos, s_sports = svc["seqs"][4]["batch"]
        outs = {}

        def lb_batch(name, manager):
            pipe = b.make_pipeline(ep_labels, sparse=False, lb=manager,
                                   conntrack=FlowConntrack(capacity_bits=CT_BITS))
            seen = []
            real = pipe._lb_stage

            def lb_stage(lbt, fl, sports):
                got = real(lbt, fl, sports)
                seen.append((fl.bytes_().copy(), np.array(fl.dports, copy=True), got))
                return got

            pipe._lb_stage = lb_stage
            t0 = time.perf_counter()
            out = pipe.process(peer, s_eps, s_dports, s_protos, ingress=False, sports=s_sports,
                               return_rev_nat=True)
            outs[name] = (out, seen, time.perf_counter() - t0, pipe.counters.copy())
            del pipe._lb_stage

        before = _kernels.launches()
        lb_batch("mesh", local)
        k9 = {k: v for k, v in launch_delta(before).items() if k.startswith("lb_")}
        with uncounted():
            lb_batch("direct", direct)
        (om, sm, tm, cm), (od, sd, td, cd) = outs["mesh"], outs["direct"]
        for k, (x, y) in enumerate(zip(om, od)):
            if not np.array_equal(x, y):
                fail(f"distributed: clustermesh: output {k} of the merged services' batch differs "
                     f"from the direct one on {int((x != y).sum())} lanes")
        if not np.array_equal(cm, cd) or len(sm) != 1 or len(sd) != 1:
            fail("distributed: clustermesh: counters or LB stage calls differ")
        (pm, dm, (drop_m, rv_m)), (pd, dd, (drop_d, rv_d)) = sm[0], sd[0]
        if not (np.array_equal(pm, pd) and np.array_equal(dm, dd) and np.array_equal(drop_m, drop_d)
                and np.array_equal(rv_m, rv_d)):
            fail("distributed: clustermesh: the LB stage's translation differs from the direct one")
        if k9 != {"lb_index_build": 1, "lb_translate": 1}:
            fail(f"distributed: clustermesh: the merged services' pipeline launched K9 {k9}, "
                 "once expected")
        print(f"distributed: clustermesh: {len(fes)} v4 frontends with {n_local} local and "
              f"{n_remote} remote backends (exported by cluster east) merged into B's "
              f"ServiceManager; B's {BATCH}-flow v4 egress batch through its LB stage (K9 "
              f"{k9}) {tm!r}s == a pipeline given the merged set directly {td!r}s on every "
              f"lane: {int((rv_m != 0).sum())} translated, revNAT ids, verdicts "
              f"{np.bincount(om[0], minlength=5)[1:].tolist()} (the bench world has no egress "
              f"rule: every egress flow drops) [{card}]", flush=True)

        # -- 5. mesh bootstrap ------------------------------------------------
        root = str(Path(__file__).resolve().parent)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{s.getsockname()[1]}"
        env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LD_LIBRARY_PATH",
                                          "CUDA_HOME", "CUDA_VISIBLE_DEVICES") if k in os.environ}
        env["GLOO_SOCKET_IFNAME"] = "lo"
        t0 = time.perf_counter()
        for rank in (0, 1):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", DIST_CHILD.format(root=root, coord=coord, rank=rank,
                                                         seed=seed)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=root))
        kids = []
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=DIST_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"distributed: bootstrapped process {rank} ran past "
                     f"{DIST_CHILD_TIMEOUT_S:.0f}s")
            if p.returncode != 0:
                fail(f"distributed: bootstrapped process {rank} exited {p.returncode}: "
                     f"{err.decode()[-2000:]}")
            kids.append(json.loads(out.decode().strip().splitlines()[-1]))
        t_kids = time.perf_counter() - t0
        with uncounted():
            v, red, _ = dist_small_batch(seed, torch.device("cuda"))
        digest = hashlib.sha256(v.tobytes() + red.tobytes()).hexdigest()
        for rank, k in enumerate(kids):
            s = k["summary"]
            if (s["process_count"] != 2 or s["process_index"] != rank or s["local_devices"] != 1
                    or s["global_devices"] != 2 or k["owners"] != [rank]
                    or not k["device"].startswith("cuda")):
                fail(f"distributed: bootstrapped process {rank}: summary {s}, plan records owned "
                     f"by {k['owners']} on {k['device']}")
        if (kids[0]["generation"], kids[0]["axes"]) != (kids[1]["generation"], kids[1]["axes"]):
            fail(f"distributed: the bootstrapped processes' plans differ: {kids}")
        if not kids[0]["digest"] == kids[1]["digest"] == digest:
            fail("distributed: the bootstrapped processes' verdicts differ from each other or "
                 "from this process's on the same batch")
        print(f"distributed: mesh_bootstrap of 2 processes over gloo at {coord}: bootstrap "
              f"walls {[round(k['bootstrap_s'], 6) for k in kids]}s, both processes {t_kids!r}s "
              f"start to exit; summaries {[k['summary'] for k in kids]}; plans generation "
              f"{kids[0]['generation']}, axes {kids[0]['axes']}, each its card with its own rank "
              f"as process_index; the {DIST_CHILD_FLOWS}-flow small-world v4 batch on each "
              f"card (launches {kids[0]['launches']}): verdicts {kids[0]['verdicts'][1:]} equal "
              f"to each other and to this process's [{card}]", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for stop in reversed(opened):
            try:
                stop()
            except (OSError, RuntimeError):
                pass  # a backend that died with its lease or its server
    wall = time.perf_counter() - t_phase
    over = "" if wall <= DIST_PHASE_LIMIT_S else " OVER ITS LIMIT"
    print(f"distributed: phase in {wall:.2f}s (limit {DIST_PHASE_LIMIT_S:.0f}s){over} [{card}]",
          flush=True)


# -- 3q. fleet observability -------------------------------------------------------

FLEET_PHASE_LIMIT_S = 30.0
FLEET_A_BATCHES = 4  # v4 and v6 1M-flow batches each that agent A serves between its ticks
FLEET_B_BATCHES = 2
FLEET_REPS = 5  # armed / unarmed pairs of the overhead check
FLEET_SWAP_LABEL = "k8s:policy=fleet-swap"
# the reference's severity of each kind the phase's sequence emits
FLEET_SEVERITY = {"rebuild": "info", "epoch_swap": "info", "shed_start": "warning",
                  "shed_end": "info", "quarantine": "error"}


def hist_counts(h):
    """(per-bucket counts, +Inf last) of a histogram's unlabeled series."""
    with h._lock:
        return list(h._series[()].counts)


def hist_bucket(buckets, v: float) -> int:
    """The bucket a value lands in (len(buckets): +Inf), as observe() places it."""
    for i, b in enumerate(buckets):
        if v <= b:
            return i
    return len(buckets)


def hist_quantile(buckets, counts, q: float):
    """The q-quantile of bucket counts, the reference's estimate
    (linear within the landing bucket, clamped to the last bound)."""
    n = sum(counts)
    if not n:
        return None
    rank, cum = q * n, 0
    for i, b in enumerate(buckets):
        prev, cum = cum, cum + counts[i]
        if cum >= rank:
            lo = buckets[i - 1] if i else 0.0
            return b if counts[i] == 0 else lo + (b - lo) * (rank - prev) / counts[i]
    return buckets[-1]


def fleet_main_path(repo, reg, cache, endpoints, labels_of, flows4, flows6, seed: int, card: str,
                    watch) -> int:
    """Phase 3q: fleet observability on the card (A9c) at the bench
    world's full width (10 000 rules, 2 048 identities, 64 endpoints,
    1 048 576-flow batches): two agents, A and B, each its own
    PolicyEngine (one full compile: K1 and the sweeps) over the bench
    repository, registry and ipcache phase 2 built, a DatapathPipeline on
    the card with the tracer on, the admission gate and the prefilter
    CIDRs, and a FederationMember on a NetBackend to one KVStoreServer;
    an EventJournal armed on the pipeline, its admission controller and
    the member, a JournalPublisher and a FleetSampler (epoch source: the
    pipeline's policy_epoch), both exchanges on the member's backend, as
    the reference's daemon wires them (daemon.py:1285-1305, 1363-1396).
    The registry is process-wide, so A is primed, serves its batches and
    is sampled before B is primed. A's pipeline is in ``watch.allowed``
    (its injected faults). The caller set the launch counts to 0. The
    identity and the rule the phase adds go again at its end. → the
    injected faults, for ``watch.check``."""
    import types

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels, faults, metrics
    from cilium_tpu_torch.contracts import JOURNAL_KINDS, JOURNAL_SEVERITIES
    from cilium_tpu_torch.datapath.pipeline import (
        DROP_DEGRADED, DROP_PREFILTER, FORWARD, DatapathPipeline,
    )
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.federation import FederationMember
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.kvstore import KVStoreServer, NetBackend
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.observe.fleet import FleetSampler, TelemetryExchange, aggregate
    from cilium_tpu_torch.observe.journal import (
        EventJournal, JournalExchange, JournalPublisher, timeline_consistent,
    )
    from cilium_tpu_torch.policy.api import (
        EndpointSelector, IngressRule, PortProtocol, PortRule, rule,
    )

    t_phase = time.perf_counter()
    hub = faults.hub
    hub.reset()
    fl4, fl6 = tuple(flows4[:4]), tuple(flows6[:4])
    hist = metrics.batch_total_seconds
    opened = []  # closed on every way out, last first
    added = []  # the phase's identity and rule, taken out on every way out
    injected = 0
    try:
        server = KVStoreServer().start()
        opened.append(server.stop)
        agents = {}
        for name in ("node-a", "node-b"):
            t0 = time.perf_counter()
            backend = NetBackend(server.url, name)
            opened.append(backend.close)
            pf = PreFilter()
            pf.insert(pf.revision, PREFILTER_CIDRS + V6_DENY)
            pipe = DatapathPipeline(PolicyEngine(repo, reg), cache, pf, admission=True,
                                    prefilter_shed=True, pipeline_max_depth=8)
            if name == "node-a":
                watch.allowed.add(pipe)
            pipe.tracer.enable()
            ag = types.SimpleNamespace(name=name, registry=reg, pipeline=pipe, backend=backend)
            ag.member = FederationMember(ag, backend, name, heartbeat_interval=3600.0)
            opened.append(ag.member.close)
            ag.journal = EventJournal(node=name, capacity=512)
            pipe.on_journal = pipe._admission.on_journal = ag.member.on_journal = ag.journal.emit
            ag.pub = JournalPublisher(ag.journal, tail_n=64)
            ag.pub.attach_exchange(JournalExchange(backend, name))
            opened.append(ag.pub.stop)
            ag.sampler = FleetSampler(epoch_source=lambda p=pipe: p.policy_epoch)
            ag.sampler.attach_exchange(TelemetryExchange(backend, name))
            opened.append(ag.sampler.stop)
            pipe.set_endpoints(endpoints)
            pipe.rebuild()
            torch.cuda.synchronize()
            ag.build_s = time.perf_counter() - t0
            agents[name] = ag
        a, b = agents["node-a"], agents["node-b"]
        built = _kernels.launches()
        if built["selector_match"] != 2 or a.pipeline._shed_tab is None:
            fail(f"fleet: the agents' builds launched K1 {built['selector_match']} times, or A "
                 "published no shed table")
        print(f"fleet: agents A and B, each a full compile and rebuild on the card (A "
              f"{a.build_s!r}s, B {b.build_s!r}s; launches from zero {built}), a FederationMember "
              f"and both exchanges on a NetBackend to one KVStoreServer over TCP loopback [{card}]",
              flush=True)

        # -- 1. the sampler -------------------------------------------------
        def xfer():
            return sum(metrics.device_transfer_bytes_total.series().values())

        for ag, n_batches in ((a, FLEET_A_BATCHES), (b, FLEET_B_BATCHES)):
            pipe = ag.pipeline
            now0 = time.monotonic()
            t0 = time.perf_counter()
            ag.sampler.sample_once(now=now0)
            t_prime = time.perf_counter() - t0
            counts0 = hist_counts(hist)
            x0, tr0 = xfer(), len(pipe.tracer.traces())
            n_v = n_drop = 0
            walls = []
            for _ in range(n_batches):
                for call, flows in (("process", fl4), ("process_v6", fl6)):
                    t0 = time.perf_counter()
                    v, _red = getattr(pipe, call)(*flows)
                    walls.append(time.perf_counter() - t0)
                    n_v += v.size
                    n_drop += int(np.count_nonzero(v != FORWARD))
            x1 = xfer()
            totals = [t["total_ns"] / 1e9 for t in pipe.tracer.traces()[tr0:]]
            now1 = time.monotonic()
            t0 = time.perf_counter()
            s = ag.sampler.sample_once(now=now1)
            t_sample = time.perf_counter() - t0
            dt = now1 - now0
            if len(totals) != len(walls) or any(t > w for t, w in zip(totals, walls)):
                fail(f"fleet: {ag.name}'s {len(walls)} batches left {len(totals)} traces, or a "
                     "trace outlasted its call")
            if abs(s["vps"] * dt - n_v) >= 0.5:
                fail(f"fleet: {ag.name}'s vps x dt {s['vps'] * dt!r} != the {n_v} verdicts its "
                     "pulled arrays hold")
            if abs(s["drop_ratio"] - n_drop / n_v) > 1e-12:
                fail(f"fleet: {ag.name}'s drop_ratio {s['drop_ratio']!r} != the arrays' drop "
                     f"share {n_drop / n_v!r}")
            if abs(s["transfer_bps"] * dt - (x1 - x0)) >= 0.5 or x1 == x0:
                fail(f"fleet: {ag.name}'s transfer_bps x dt {s['transfer_bps'] * dt!r} != the "
                     f"{x1 - x0} bytes device_transfer_bytes_total moved")
            # the histogram is the process's: what it held before this
            # agent's batches, plus exactly these batches' trace totals
            placed = list(counts0)
            for t in totals:
                placed[hist_bucket(hist.buckets, t)] += 1
            if hist_counts(hist) != placed:
                fail(f"fleet: batch_total_seconds moved by other than {ag.name}'s traces")
            quant = {}
            for q, key in ((0.5, "verdict_p50_ms"), (0.99, "verdict_p99_ms")):
                want = hist_quantile(hist.buckets, placed, q)
                got = s[key]
                if got is None or abs(got - want * 1e3) > 1e-9 * max(1.0, got):
                    fail(f"fleet: {ag.name}'s {key} {got!r} != {want * 1e3!r} ms, the "
                         "quantile of the histogram its traces fed")
                quant[key] = (got, hist_bucket(hist.buckets, got / 1e3))
            wall_buckets = sorted({hist_bucket(hist.buckets, w) for w in walls})
            edges = [0.0, *hist.buckets, float("inf")]
            print(f"fleet sampler [{ag.name}]: {n_batches} v4 and {n_batches} v6 "
                  f"{BATCH}-flow batches between two ticks {dt!r}s apart: vps {s['vps']!r} "
                  f"(x dt = {n_v} verdicts, the pulled arrays'), drop_ratio {s['drop_ratio']!r} "
                  f"(= {n_drop} / {n_v}), shed_ratio {s['shed_ratio']!r}, transfer_bps "
                  f"{s['transfer_bps']!r} (x dt = {x1 - x0} bytes, "
                  f"device_transfer_bytes_total's move); p50 {quant['verdict_p50_ms'][0]!r} ms, "
                  f"p99 {quant['verdict_p99_ms'][0]!r} ms (buckets "
                  f"{[edges[k + 1] for _, k in quant.values()]} s of the process's histogram, "
                  f"{sum(placed)} traced batches, {len(totals)} of them these; these batches' "
                  f"walls {stat_ms(walls)} in the buckets up to {[edges[k + 1] for k in wall_buckets]}"
                  f" s); sample_once {t_sample!r}s (its frame published and pumped over TCP), "
                  f"the priming tick {t_prime!r}s [{card}]", flush=True)

        # -- 2. the journal on A ----------------------------------------------
        pipe = a.pipeline
        seen = [0]

        def new_events(kinds, what):
            evs = a.journal.events(512)[seen[0]:]
            if [e["kind"] for e in evs] != kinds:
                fail(f"fleet journal: {what} gave {[e['kind'] for e in evs]}, not {kinds}")
            seen[0] += len(evs)
            return evs

        (ev,) = new_events(["rebuild"], "A's first rebuild")
        if ev["attrs"]["prev_basis"] is not None or ev["attrs"]["policy_epoch"] != 0:
            fail(f"fleet journal: the first rebuild's attrs {ev['attrs']}")
        # an identity delta: a label set of the bench's vocabulary that no
        # identity holds yet
        held = {tuple(sorted(lbls)) for lbls in labels_of.values()}
        probe = next([f"k8s:app=a{i}", f"k8s:zone=z{z}"] for i in range(N_APPS) for z in range(8)
                     if tuple(sorted([f"k8s:app=a{i}", f"k8s:zone=z{z}"])) not in held)
        ident = reg.allocate(parse_label_array(probe))
        added.append(lambda: reg.release(ident))
        t0 = time.perf_counter()
        pipe.engine.refresh()
        pipe.rebuild()
        torch.cuda.synchronize()
        t_ident = time.perf_counter() - t0
        (ev,) = new_events(["rebuild"], "the identity delta")
        if ev["attrs"]["basis"] != list(pipe._mat_basis) or ev["attrs"]["prev_basis"] == ev["attrs"]["basis"]:
            fail(f"fleet journal: the identity delta's rebuild {ev['attrs']} against _mat_basis "
                 f"{pipe._mat_basis}")
        # an epoch swap on both agents: one rule growing endpoint 0's slots
        app0, app1 = (labels_of[e][0] for e in endpoints[:2])
        push = rule([app0], ingress=[IngressRule(
            from_endpoints=(EndpointSelector.make([app1]),),
            to_ports=(PortRule(ports=(PortProtocol(9443, "TCP"),)),))],
            labels=[FLEET_SWAP_LABEL])
        repo.add_list([push])
        added.append(lambda: repo.delete_by_labels(parse_label_array([FLEET_SWAP_LABEL])))
        t0 = time.perf_counter()
        for ag in (a, b):
            ag.pipeline.set_epoch_swap(True)
            ag.pipeline.engine.refresh()
            ag.pipeline.rebuild()  # kicks the shadow build
        for ag in (a, b):
            if not ag.pipeline.wait_epoch_swap(timeout=60.0):
                fail(f"fleet: {ag.name}'s shadow build did not finish")
            ag.pipeline.rebuild()  # publishes
        t_swap = time.perf_counter() - t0
        swap, _ = new_events(["epoch_swap", "rebuild"], "the epoch swap")
        if swap["attrs"]["policy_epoch"] != pipe.policy_epoch or pipe.policy_epoch != 1:
            fail(f"fleet journal: epoch_swap {swap['attrs']} with policy_epoch {pipe.policy_epoch}")
        if b.pipeline.policy_epoch != 1 or not a.member.wait_cluster_epoch(
                1, timeout=30.0, min_nodes=2, pump=lambda: [ag.member.pump() for ag in (a, b)]):
            fail("fleet: the cluster epoch did not reach 1 on both agents")
        # a deny-heavy batch through submit, the gate forced: K11 walks it
        adm = pipe._admission
        batch = deny_heavy(4, seed, fl4)
        k11 = shed_inputs(pipe, 4, batch, pipe.device)
        n_shed = int(k11["plain"](*k11["args"]).sum().item())
        shed0 = dict(adm.shed)
        k0 = _kernels.launches()["shed_walk_wide"]
        hub.fail(faults.SITE_QUEUE_FULL, faults.KIND_TRANSIENT, times=1)
        v, _red = pipe.submit(*batch).result()
        hub.reset()
        if _kernels.launches()["shed_walk_wide"] != k0 + 1 or int((v == DROP_PREFILTER).sum()) < n_shed:
            fail("fleet: the gated deny-heavy batch did not shed through K11")
        (ev,) = new_events(["shed_start"], "the gated batch")
        if ev["attrs"] != {"reason": "prefilter"}:
            fail(f"fleet journal: shed_start {ev['attrs']}")
        adm.episode_poll()
        new_events([], "a poll inside the hold")
        t0 = time.perf_counter()
        time.sleep(adm.SHED_HOLD_S)
        while adm.shedding():
            time.sleep(0.005)
        t_hold = time.perf_counter() - t0
        adm.episode_poll()
        (ev,) = new_events(["shed_end"], "the poll after the hold")
        moved = {r: n - shed0.get(r, 0) for r, n in adm.shed.items() if n != shed0.get(r, 0)}
        if ev["attrs"]["shed"] != moved or moved != {"prefilter": n_shed}:
            fail(f"fleet journal: shed_end {ev['attrs']} against the controller's move {moved} "
                 f"and the plain mask's {n_shed}")
        # two poisoned completions move the ladder down, clean batches back
        cut = tuple(x[:FAILSAFE_CUT] for x in fl4)
        knobs = (pipe.breaker_threshold, pipe.recover_after_clean)
        pipe.breaker_threshold, pipe.recover_after_clean = 2, 3
        t0 = time.perf_counter()
        for _ in range(2):
            hub.fail(faults.SITE_COMPLETE, faults.KIND_POISONED, times=1)
            v, _red = pipe.process(*cut)
            injected += 1
            if not (v == DROP_DEGRADED).all():
                fail("fleet: a poisoned completion did not give DROP_DEGRADED")
        hub.reset()
        level1 = pipe.pipeline_mode
        for _ in range(3):
            pipe.process(*cut)
        t_ladder = time.perf_counter() - t0
        pipe.breaker_threshold, pipe.recover_after_clean = knobs
        evs = new_events(["quarantine", "ladder_move", "quarantine", "ladder_move"], "the ladder")
        moves = [e for e in evs if e["kind"] == "ladder_move"]
        if (level1, pipe.pipeline_mode) != ("single-device", "sharded") or [
                (e["severity"], e["attrs"]) for e in moves] != [
                ("warning", {"from": "sharded", "to": "single-device", "level": 1}),
                ("info", {"from": "single-device", "to": "sharded", "level": 0})]:
            fail(f"fleet journal: the ladder went {level1} → {pipe.pipeline_mode}: {moves}")
        journal = a.journal.events(512)
        for e in journal:
            want = FLEET_SEVERITY.get(e["kind"], e["severity"])
            if (e["kind"] not in JOURNAL_KINDS or e["severity"] not in JOURNAL_SEVERITIES
                    or e["severity"] != want):
                fail(f"fleet journal: {e['kind']} / {e['severity']} is not the reference's")
        print(f"fleet journal [node-a]: {[e['kind'] for e in journal]} in the order of the "
              f"operations (kinds and severities the reference's); identity delta refresh + "
              f"rebuild {t_ident!r}s; the swap on both agents, kick to publish {t_swap!r}s, the "
              f"cluster epoch 1 on both; shed_start with the gated batch ({n_shed} shed through "
              f"K11), shed_end {t_hold!r}s later with the controller's per-reason move {moved}; "
              f"the ladder sharded → single-device → sharded over 5 {FAILSAFE_CUT}-flow batches "
              f"{t_ladder!r}s [{card}]", flush=True)

        # -- 3. the fleet -------------------------------------------------------
        walls = {}
        t0 = time.perf_counter()
        if not a.pub.publish_once():
            fail("fleet: A published no journal frame")
        walls["publish_once"] = time.perf_counter() - t0
        b.pub.publish_once()
        dist_wait("A's journal frame at B", lambda: len(
            b.pub.exchange.frames().get("node-a", {}).get("events", ())) == min(
            len(journal), a.pub.tail_n), b.pub.exchange.pump)
        t0 = time.perf_counter()
        merged = b.pub.merged_timeline(limit=512)
        walls["merged_timeline"] = time.perf_counter() - t0
        nodes = {e["node"] for e in merged}
        n_a = sum(e["node"] == "node-a" for e in merged)
        if nodes != {"node-a", "node-b"} or n_a != min(len(journal), a.pub.tail_n) \
                or not timeline_consistent(merged):
            fail(f"fleet: B's merged timeline holds {nodes}, {n_a} of A's events, consistent "
                 f"{timeline_consistent(merged)}")
        t_pub = time.time()  # the frames' stamps are wall clock
        for ag in (a, b):
            t0 = time.perf_counter()
            ag.sampler.exchange.publish(ag.sampler.frame_body())
            ag.sampler.exchange.pump()
            walls[f"telemetry publish + pump {ag.name}"] = time.perf_counter() - t0
        dist_wait("both fresh telemetry frames at B", lambda: {
            n for n, f in b.sampler.exchange.frames().items() if f["ts"] >= t_pub} == {
            "node-a", "node-b"}, b.sampler.exchange.pump)
        frames = b.sampler.exchange.frames()
        agg = aggregate(frames)
        if (agg["nodes_reporting"], agg["epoch_skew"]) != (2, 0) or agg["fleet_vps"] != round(
                sum(f["vps"] for f in frames.values()), 3) or agg["fleet_vps"] <= 0:
            fail(f"fleet: aggregate {agg}")
        print(f"fleet [B's view]: merged timeline {len(merged)} events of both nodes, "
              f"HLC-consistent; aggregate nodes_reporting {agg['nodes_reporting']}, epoch_skew "
              f"{agg['epoch_skew']}, fleet_vps {agg['fleet_vps']!r} (the frames' sum), "
              f"epoch_lag_max {agg['epoch_lag_max']!r}; walls "
              f"{ {k: round(v, 6) for k, v in walls.items()} } s [{card}]", flush=True)
        for ag in (a, b):
            objs = ag.sampler.last_slo["objectives"]
            print(f"fleet SLO [{ag.name}]: " + "; ".join(
                f"{n} {o['state']} {o['windows']}" for n, o in objs.items())
                + f"; worst {ag.sampler.last_slo['worst']} [{card}]", flush=True)
        print(f"fleet SLO [fleet]: worst_burn {agg['worst_burn']} (the batch histogram is the "
              f"process's: every earlier phase's traced batches are in its p99) [{card}]",
              flush=True)

        # -- 4. the planes' cost on the batch path ------------------------------
        times = {"armed": [], "unarmed": []}
        pipe.process(*fl4)  # after the ladder's cut batches: the full batch's staging again
        for k in range(2 * FLEET_REPS):
            armed = k % 4 in (0, 3)  # armed, unarmed, unarmed, armed, ...
            pipe.on_journal = adm.on_journal = a.journal.emit if armed else None
            t0 = time.perf_counter()
            pipe.process(*fl4)
            times["armed" if armed else "unarmed"].append(time.perf_counter() - t0)
        pipe.on_journal = adm.on_journal = a.journal.emit
        print(f"fleet cost [node-a]: a v4 {BATCH}-flow batch (tracer on) with the journal, "
              f"sampler and publisher armed {stat_ms(times['armed'])}, the journal's slots unarmed "
              f"{stat_ms(times['unarmed'])} [{card}]", flush=True)
    finally:
        hub.reset()
        for undo in reversed(added):
            undo()
        for stop in reversed(opened):
            try:
                stop()
            except (OSError, RuntimeError):
                pass  # a backend that died with its server
    wall = time.perf_counter() - t_phase
    if wall > FLEET_PHASE_LIMIT_S:
        fail(f"fleet: phase in {wall:.2f}s, over its {FLEET_PHASE_LIMIT_S:.0f}s limit")
    print(f"fleet: phase in {wall:.2f}s (limit {FLEET_PHASE_LIMIT_S:.0f}s) [{card}]", flush=True)
    return injected


# -- 3r. the Kubernetes and DNS policy sources -----------------------------------

K8S_PHASE_LIMIT_S = 45.0
K8S_NAMESPACES = 32
K8S_SERVICES = 192  # the sync is quadratic in them: tools/k8s_sync_size.py
K8S_EXTERNAL = 32  # selector-less services with Endpoints outside the cluster: the toServices targets
K8S_INGRESSES = 16
K8S_NODES = 8
# NetworkPolicies and CiliumNetworkPolicies, half each (a CNP holds 1-4
# specs): the initial sync is quadratic in rules x service events
K8S_POLICIES = 512
K8S_TO_SERVICES = 64  # CNP specs with toServices
K8S_TO_FQDNS = 64  # CNP specs with toFQDNs
K8S_FQDN_NAMES = 32
K8S_FQDN_TTL = 300.0
K8S_IPBLOCKS = 8  # 172.{16+b}.0.0/16 except 172.{16+b}.{x_b}.0/24, egress on NetworkPolicies
K8S_HOST_IP = "192.168.40.1"
K8S_NODE = "node-0"
K8S_ORACLE = 400  # sampled lanes of each batch held against the host oracle
K8S_BLOCK_LANES = 4  # lanes inside and outside each ipBlock's except held against it too
K8S_PLAIN_SLICE = 1 << 13  # holds every focus lane (k8s_focus) and ~3 000 others
K8S_NS_KEY = "k8s:io.kubernetes.pod.namespace"


def k8s_v4(i: int) -> str:
    """Pod i's IPv4 address: the bench world's identity /32s."""
    return f"10.{(i >> 8) & 255}.{i & 255}.1"


def k8s_v6(i: int) -> str:
    return f"fd00::{(i >> 8) & 255:x}:{i & 255:x}"


def k8s_pod(i: int, labels) -> dict:
    return {"kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": f"ns{i % K8S_NAMESPACES}",
                         "labels": dict(labels)},
            "spec": {"nodeName": f"node-{(i >> 8) % K8S_NODES}"},
            "status": {"podIP": k8s_v4(i), "podIPs": [{"ip": k8s_v4(i)}, {"ip": k8s_v6(i)}]}}


def k8s_pod_labels(rng) -> dict:
    """A pod's labels, drawn as build_world draws an identity's."""
    labels = {"app": f"a{rng.randrange(N_APPS)}", "zone": f"z{rng.randrange(8)}"}
    if rng.random() < 0.5:
        labels["env"] = "prod" if rng.random() < 0.5 else "dev"
    return labels


def k8s_cluster(seed: int, n_policies: int = None, n_services: int = None):
    """Phase 3r's cluster as the objects an apiserver would list, drawn
    from ``random.Random(seed)``: N_IDENTITIES dual-stack Pods in
    K8S_NAMESPACES labelled Namespaces; N_FE4 ClusterIP Services (ports of
    SVC_PORTS; K8S_INGRESSES of them on 8000 + k behind an Ingress),
    K8S_EXTERNAL of them selector-less with Endpoints in 198.18.0.0/16,
    the rest selecting an app of their namespace with 1-4 pod backends;
    K8S_NODES Nodes; ``n_policies`` policy objects, half NetworkPolicies
    (egress podSelector / namespaceSelector peers with ports, every fourth
    an ipBlock with an except; some ingress) and half multi-spec CNPs
    (cross-namespace toEndpoints, K8S_TO_SERVICES specs with toServices on
    the external services, K8S_TO_FQDNS with toFQDNs). → a dict of the
    objects by (kind, namespace, name) in the Informer's kind order, and
    what the phase needs to know of them."""
    rng = random.Random(seed + 800)
    n_policies = K8S_POLICIES if n_policies is None else n_policies
    objs = {}

    def put(obj):
        meta = obj["metadata"]
        ns = "" if obj["kind"] in ("Namespace", "Node") else meta.get("namespace", "default")
        objs[(obj["kind"], ns, meta["name"])] = obj

    n_ns = K8S_NAMESPACES
    pod_labels = [k8s_pod_labels(rng) for _ in range(N_IDENTITIES)]
    ns_pods = [[i for i in range(N_IDENTITIES) if i % n_ns == k] for k in range(n_ns)]
    ns_apps = [sorted({pod_labels[i]["app"] for i in ns_pods[k]}) for k in range(n_ns)]

    # services: the toServices targets, the Ingress targets, the rest
    n_svc = K8S_SERVICES if n_services is None else n_services
    order = rng.sample(range(n_svc), K8S_EXTERNAL + K8S_INGRESSES)
    external, ingress_of = order[:K8S_EXTERNAL], order[K8S_EXTERNAL:]
    ext_backends = {}
    svc_names = []
    for s in range(n_svc):
        ns = f"ns{s % n_ns}"
        name = f"svc{s}"
        svc_names.append((ns, name))
        if s in ingress_of:
            port, proto = 8000 + ingress_of.index(s), "TCP"
            tport = 80
        else:
            port, proto = rng.choice(SVC_PORTS)
            tport = 53 if proto == "UDP" else rng.choice([80, 443, 8080, 5432])
        spec = {"type": "ClusterIP", "clusterIP": f"10.96.{(s + 1) >> 8}.{(s + 1) & 255}",
                "ports": [{"name": "p", "port": port, "protocol": proto, "targetPort": tport}]}
        if s in external:
            k = external.index(s)
            ips = [f"198.18.{k}.{j + 1}" for j in range(rng.randint(1, 4))]
            ext_backends[(ns, name)] = ips
        else:
            spec["selector"] = {"app": rng.choice(ns_apps[s % n_ns])}
            ips = [k8s_v4(i) for i in rng.sample(ns_pods[s % n_ns], rng.randint(1, 4))]
        put({"kind": "Service", "metadata": {"name": name, "namespace": ns,
                                             "labels": {"tier": f"t{s % 4}"}}, "spec": spec})
        put({"kind": "Endpoints", "metadata": {"name": name, "namespace": ns},
             "subsets": [{"addresses": [{"ip": ip} for ip in ips],
                          "ports": [{"name": "p", "port": tport, "protocol": proto}]}]})
    for k, s in enumerate(ingress_of):
        ns, name = svc_names[s]
        put({"kind": "Ingress", "metadata": {"name": f"ing{k}", "namespace": ns},
             "spec": {"backend": {"serviceName": name, "servicePort": 8000 + k}}})

    # policies
    blocks = [(f"172.{16 + b}.0.0/16", f"172.{16 + b}.{(37 * b + 11) & 255}.0/24")
              for b in range(K8S_IPBLOCKS)]
    names = [f"api{k}.example.com" for k in range(K8S_FQDN_NAMES)]
    ext_ids = [svc_names[s] for s in external]
    n_np = n_policies // 2
    n_cnp = n_policies - n_np
    counts = [rng.randint(1, 4) for _ in range(n_cnp)]
    while sum(counts) < K8S_TO_SERVICES + K8S_TO_FQDNS + n_cnp:
        counts[rng.randrange(n_cnp)] += 1
    kinds = (["svc"] * K8S_TO_SERVICES + ["fqdn"] * K8S_TO_FQDNS
             + ["ep"] * (sum(counts) - K8S_TO_SERVICES - K8S_TO_FQDNS))
    rng.shuffle(kinds)

    def port_list(cnp: bool):
        port, proto = rng.choice(SVC_PORTS)
        return [{"port": str(port) if cnp else port, "protocol": proto}]

    for j in range(n_np):
        k = rng.randrange(n_ns)
        ns = f"ns{k}"
        sel = ({"app": rng.choice(ns_apps[k])} if rng.random() < 0.6
               else {"zone": f"z{rng.randrange(8)}"})
        r = rng.random()
        if r < 0.4:
            peer = {"podSelector": {"matchLabels": {"app": rng.choice(ns_apps[k])}}}
        elif r < 0.7:
            peer = {"namespaceSelector": {"matchLabels": {"team": f"t{rng.randrange(8)}"}}}
        else:
            peer = {"namespaceSelector": {"matchLabels": {"team": f"t{rng.randrange(8)}"}},
                    "podSelector": {"matchLabels": {"zone": f"z{rng.randrange(8)}"}}}
        egress = [{"to": [peer]}]
        if rng.random() < 0.5:
            egress[0]["ports"] = port_list(False)
        if j % 4 == 0:
            cidr, exc = blocks[(j // 4) % K8S_IPBLOCKS]
            blk = {"to": [{"ipBlock": {"cidr": cidr, "except": [exc]}}]}
            if rng.random() < 0.5:
                blk["ports"] = [{"port": 443, "protocol": "TCP"}]
            egress.append(blk)
        spec = {"podSelector": {"matchLabels": sel}, "policyTypes": ["Egress"], "egress": egress}
        if rng.random() < 0.3:
            spec["policyTypes"] = ["Ingress", "Egress"]
            spec["ingress"] = [{"from": [{"podSelector": {"matchLabels": {
                "app": rng.choice(ns_apps[k])}}}], "ports": port_list(False)}]
        put({"kind": "NetworkPolicy", "apiVersion": "networking.k8s.io/v1",
             "metadata": {"name": f"np{j}", "namespace": ns}, "spec": spec})
    it = iter(kinds)
    for j in range(n_cnp):
        k = rng.randrange(n_ns)
        specs = []
        for _ in range(counts[j]):
            kind = next(it)
            sel = ({"app": rng.choice(ns_apps[k])} if kind == "ep" and rng.random() < 0.6
                   else {"zone": f"z{rng.randrange(8)}"})
            if kind == "svc":
                sns, sname = rng.choice(ext_ids)
                eg = {"toServices": [{"k8sService": {"serviceName": sname, "namespace": sns}}]}
            elif kind == "fqdn":
                eg = {"toFQDNs": [{"matchName": rng.choice(names)}]}
                if rng.random() < 0.5:
                    eg["toPorts"] = [{"ports": [{"port": "443", "protocol": "TCP"}]}]
            else:
                r = rng.random()
                if r < 0.5:
                    peer = {"k8s:io.kubernetes.pod.namespace": f"ns{rng.randrange(n_ns)}"}
                elif r < 0.8:
                    peer = {"k8s:io.kubernetes.pod.namespace": f"ns{rng.randrange(n_ns)}",
                            "zone": f"z{rng.randrange(8)}"}
                else:
                    peer = {"app": rng.choice(ns_apps[k])}
                eg = {"toEndpoints": [{"matchLabels": peer}]}
                if rng.random() < 0.5:
                    eg["toPorts"] = [{"ports": port_list(True)}]
            spec = {"endpointSelector": {"matchLabels": sel}, "egress": [eg]}
            if kind == "ep" and rng.random() < 0.3:
                spec["ingress"] = [{"fromEndpoints": [{"matchLabels": {
                    "app": rng.choice(ns_apps[k])}}]}]
            specs.append(spec)
        put({"kind": "CiliumNetworkPolicy", "apiVersion": "cilium.io/v2",
             "metadata": {"name": f"cnp{j}", "namespace": f"ns{k}"}, "specs": specs})

    for i, labels in enumerate(pod_labels):
        put(k8s_pod(i, labels))
    for k in range(n_ns):
        put({"kind": "Namespace", "metadata": {"name": f"ns{k}", "labels": {
            "team": f"t{k % 8}", "stage": "prod" if k % 2 else "dev"}}})
    for k in range(K8S_NODES):
        put({"kind": "Node", "metadata": {"name": f"node-{k}", "labels": {"rack": f"r{k % 2}"}},
             "spec": {"podCIDR": f"10.{k}.0.0/16"},
             "status": {"addresses": [{"type": "InternalIP", "address": f"192.168.40.{k + 1}"}]}})
    answers = {n: ([f"100.64.{k}.{j + 1}" for j in range(1 + k % 2)], K8S_FQDN_TTL)
               for k, n in enumerate(names)}
    return {"objects": objs, "blocks": blocks, "names": names, "answers": answers,
            "external": ext_ids, "ext_backends": ext_backends, "pod_labels": pod_labels}


def k8s_snapshot(objs, drop=()):
    """The objects as one LIST across kinds returns them: the Informer's
    kind order, each kind's objects in their order; ``drop`` keys left out."""
    from cilium_tpu_torch.k8s.client import RESOURCES

    by_kind = {k: [] for k in RESOURCES}
    for key, obj in objs.items():
        if key not in drop:
            by_kind[key[0]].append(obj)
    return [o for k in RESOURCES for o in by_kind[k]]


class K8sAgent:
    """Phase 3r's stand-in for the agent the k8s watcher and the DNS
    poller drive (the port's Daemon comes with A7c): a Repository, an
    IdentityRegistry, an IPCache, a PolicyEngine on ``device``, a plain
    endpoint id -> endpoint map, a ServiceManager on the node's address as
    ``services``, ``ipam.net`` (the node's pod CIDR, read for the node
    annotation) and, once built, a DatapathPipeline with ``lb=`` that
    manager and no conntrack. Its five methods are the ones
    K8sWatcher and PodOrchestrator call, each doing what the reference
    Daemon's does (cilium_tpu/daemon.py policy_replace, policy_delete,
    policy_translate, endpoint_add, endpoint_delete). Each regeneration
    the daemon would run is counted in ``asks`` instead and run by
    ``regenerate()`` at a checkpoint. ``world`` (a repository, a registry
    and an ipcache) stands in for fresh ones."""

    def __init__(self, host_ip: str, pod_cidr: str, device=None, world=None):
        import types

        from cilium_tpu_torch.engine import PolicyEngine
        from cilium_tpu_torch.identity import IdentityRegistry
        from cilium_tpu_torch.ipcache.ipcache import IPCache
        from cilium_tpu_torch.lb import ServiceManager
        from cilium_tpu_torch.policy.repository import Repository

        self.repo, self.registry, self.ipcache = world or (
            Repository(), IdentityRegistry(), IPCache())
        self.engine = PolicyEngine(self.repo, self.registry, device=device)
        self.endpoints = {}
        self.services = ServiceManager(host_ip=host_ip)
        self.ipam = types.SimpleNamespace(net=ipaddress.ip_network(pod_cidr))
        self.pipeline = None
        self.asks = []

    # -- what the watcher calls ------------------------------------------------
    def policy_replace(self, labels, rules_json: str) -> dict:
        from cilium_tpu_torch.labels import parse_label_array
        from cilium_tpu_torch.policy.api.serialization import rules_from_json

        rules = rules_from_json(rules_json)
        rev, n_deleted = self.repo.replace_by_labels(parse_label_array(labels), rules)
        self.asks.append("policy replace")
        return {"revision": rev, "count": len(rules), "deleted": n_deleted}

    def policy_delete(self, labels) -> dict:
        from cilium_tpu_torch.labels import parse_label_array

        rev, deleted = self.repo.take_by_labels(parse_label_array(labels))
        if deleted:
            self.asks.append("policy delete")
        return {"revision": rev, "deleted": len(deleted)}

    def policy_translate(self, translator) -> dict:
        rev, n = self.repo.translate_rules(translator)
        if n:
            self.asks.append("policy translate")
        return {"revision": rev, "changed": n}

    def endpoint_add(self, endpoint_id: int, labels, *, ipv4=None, ipv6=None,
                     pod_name: str = "") -> dict:
        import types

        from cilium_tpu_torch.ipcache.ipcache import SOURCE_AGENT
        from cilium_tpu_torch.labels import parse_label_array

        if endpoint_id in self.endpoints:
            raise ValueError(f"endpoint {endpoint_id} exists")
        lbls = parse_label_array(labels)
        ident = self.registry.allocate(lbls)
        self.endpoints[endpoint_id] = types.SimpleNamespace(
            id=endpoint_id, labels=lbls, identity=ident, ipv4=ipv4, ipv6=ipv6, pod_name=pod_name)
        if ipv4:
            self.ipcache.upsert(f"{ipv4}/32", ident.id, source=SOURCE_AGENT)
        if ipv6:
            self.ipcache.upsert(f"{ipv6}/128", ident.id, source=SOURCE_AGENT)
        self.asks.append("endpoint created")
        return {"id": endpoint_id, "identity": ident.id, "ipv4": ipv4, "ipv6": ipv6}

    def endpoint_delete(self, endpoint_id: int) -> bool:
        from cilium_tpu_torch.ipcache.ipcache import SOURCE_AGENT

        ep = self.endpoints.pop(endpoint_id, None)
        if ep is None:
            return False
        if ep.ipv4:
            self.ipcache.delete(f"{ep.ipv4}/32", SOURCE_AGENT)
        if ep.ipv6:
            self.ipcache.delete(f"{ep.ipv6}/128", SOURCE_AGENT)
        self.registry.release(ep.identity)
        self.asks.append("endpoint deleted")
        return True

    # -- the checkpoint --------------------------------------------------------
    def regenerate(self) -> list:
        """The regeneration the asks since the last checkpoint stand for:
        the pipeline's endpoints (by endpoint id) when they moved, the
        engine's refresh and the pipeline's rebuild. → the asks covered."""
        eps = [(e.id, e.identity.id) for _, e in sorted(self.endpoints.items())]
        if eps != list(zip(self.pipeline._endpoint_ids, self.pipeline._endpoints)):
            self.pipeline.set_endpoints(eps)
        self.engine.refresh()
        self.pipeline.rebuild()
        asks, self.asks = self.asks, []
        return asks


def k8s_expected_frontends(objs, host_ip: str) -> dict:
    """The LB frontends the Service, Endpoints and Ingress objects define,
    read from the objects themselves: {(ip, port, protocol): [(backend
    ip, port), ...]} for every ClusterIP service port (backends from the
    Endpoints port of the same name), and one frontend on ``host_ip`` per
    Ingress at its servicePort (the service's one Endpoints port)."""
    svcs = {(ns, name): o for (kind, ns, name), o in objs.items() if kind == "Service"}
    eps = {}
    for (kind, ns, name), o in objs.items():
        if kind == "Endpoints":
            subsets = o.get("subsets") or ()
            ips = list(dict.fromkeys(a["ip"] for s in subsets for a in s.get("addresses") or ()))
            ports = {(p.get("name") or str(p["port"])): p["port"]
                     for s in subsets for p in s.get("ports") or ()}
            eps[(ns, name)] = (ips, ports)
    want = {}
    for key, o in svcs.items():
        cip = o["spec"].get("clusterIP")
        if not cip or cip == "None":
            continue
        for p in o["spec"]["ports"]:
            ips, ports = eps.get(key, ([], {}))
            tport = ports.get(p.get("name") or str(p["port"])) or ports.get(str(p["port"]))
            want[(cip, p["port"], p.get("protocol", "TCP").upper())] = (
                [(ip, tport) for ip in ips] if tport else [])
    for (kind, ns, name), o in objs.items():
        if kind == "Ingress":
            be = o["spec"]["backend"]
            ips, ports = eps.get((ns, be["serviceName"]), ([], {}))
            tport = ports.get(str(be["servicePort"])) or (
                next(iter(ports.values())) if len(ports) == 1 else None)
            want[(host_ip, be["servicePort"], "TCP")] = [(ip, tport) for ip in ips] if tport else []
    return want


def k8s_flows(seed: int, cl, subjects, n: int = None):
    """Phase 3r's v4 egress lanes: a subject pod each (from ``subjects``)
    and, by ``kind``, a peer among the pods (0, half the lanes), the
    ClusterIP frontends on their port and protocol (1), the Ingress
    frontends on the node's address (2), inside (3) and outside (4) an
    ipBlock's except (``block`` names it), the external services'
    backends as listed and as step 4 moves them (5), the DNS answers as
    listed and as step 5 moves them (6), and the world (7).
    → dict of numpy arrays; ``subj`` is a pod number."""
    import numpy as np

    nrng = np.random.default_rng(seed + 901)
    n = BATCH if n is None else n

    def u32(ip):
        return int(ipaddress.IPv4Address(ip))

    subj = np.asarray(subjects, np.int64)[nrng.integers(0, len(subjects), n)]
    kind = nrng.choice(8, n, p=[0.50, 0.15, 0.02, 0.05, 0.05, 0.05, 0.08, 0.10])
    pods = nrng.integers(0, N_IDENTITIES, n).astype(np.uint32)
    peer = ((np.uint32(10) << 24) | ((pods >> 8) & 255) << 16 | (pods & 255) << 8 | 1).astype(np.uint32)
    dports = nrng.choice(np.array([80, 443, 8080, 53, 5432, 22], np.int32), n)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    block = np.full(n, -1, np.int32)

    fes = [(u32(o["spec"]["clusterIP"]), p["port"], 17 if p.get("protocol") == "UDP" else 6)
           for (k, _ns, _n), o in cl["objects"].items() if k == "Service" for p in o["spec"]["ports"]]
    fes = np.array(fes, np.int64)
    m = kind == 1
    pick = fes[nrng.integers(0, len(fes), int(m.sum()))]
    peer[m], dports[m], protos[m] = pick[:, 0].astype(np.uint32), pick[:, 1], pick[:, 2]
    m = kind == 2
    peer[m] = u32(K8S_HOST_IP)
    dports[m] = 8000 + nrng.integers(0, K8S_INGRESSES, int(m.sum()))
    protos[m] = 6
    for kd in (3, 4):
        m = np.nonzero(kind == kd)[0]
        b = nrng.integers(0, K8S_IPBLOCKS, m.size)
        exc = np.array([int(cl["blocks"][j][1].split(".")[2]) for j in range(K8S_IPBLOCKS)])[b]
        third = exc if kd == 3 else (exc + nrng.integers(1, 256, m.size)) & 255
        peer[m] = ((172 << 24) | ((16 + b) << 16) | (third << 8)
                   | nrng.integers(1, 255, m.size)).astype(np.uint32)
        block[m] = b
        dports[m] = nrng.choice(np.array([443, 80], np.int32), m.size)
        protos[m] = 6
    m = np.nonzero(kind == 5)[0]
    peer[m] = ((198 << 24) | ((18 + nrng.integers(0, 2, m.size)) << 16)
               | (nrng.integers(0, K8S_EXTERNAL, m.size) << 8)
               | nrng.integers(1, 5, m.size)).astype(np.uint32)
    dports[m] = nrng.choice(np.array([5432, 80, 443], np.int32), m.size)
    protos[m] = 6
    m = np.nonzero(kind == 6)[0]
    peer[m] = ((100 << 24) | ((64 + nrng.integers(0, 2, m.size)) << 16)
               | (nrng.integers(0, K8S_FQDN_NAMES, m.size) << 8)
               | nrng.integers(1, 3, m.size)).astype(np.uint32)
    dports[m] = nrng.choice(np.array([443, 80], np.int32), m.size)
    protos[m] = 6
    m = np.nonzero(kind == 7)[0]
    peer[m] = ((8 << 24) | nrng.integers(0, 1 << 24, m.size)).astype(np.uint32)
    sports = nrng.integers(1024, 60001, n)
    return {"peer": peer, "subj": subj, "dports": dports.astype(np.int32),
            "protos": protos.astype(np.int32), "sports": sports, "kind": kind, "block": block}


def k8s_flows6(seed: int, subjects, n: int = None):
    """Phase 3r's v6 egress lanes: a subject pod each, peers the pods'
    fd00::{hi}:{lo} addresses, 1/16 of them in 2001:db8::/32 (the world)."""
    import numpy as np

    nrng = np.random.default_rng(seed + 906)
    n = BATCH if n is None else n
    subj = np.asarray(subjects, np.int64)[nrng.integers(0, len(subjects), n)]
    pods = nrng.integers(0, N_IDENTITIES, n)
    world = nrng.random(n) < 1 / 16
    addr = np.zeros((n, 16), np.int32)
    addr[:, 0] = 0xFD
    addr[:, 13] = (pods >> 8) & 255
    addr[:, 15] = pods & 255
    addr[world] = nrng.integers(0, 256, (int(world.sum()), 16))
    addr[world, :4] = (0x20, 0x01, 0x0D, 0xB8)
    dports = nrng.choice(np.array([80, 443, 8080, 53, 5432, 22], np.int32), n)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return {"addr": addr, "subj": subj, "dports": dports.astype(np.int32), "protos": protos,
            "sports": nrng.integers(1024, 60001, n)}


class K8sOracle:
    """Repository.allows_egress per lane, over the host ipcache's LPM
    (the world identity where nothing covers the address) and the
    subject endpoint's identity labels; one answer a (subject, peer
    identity, dport, proto) key. The rules asked are those that select
    the subject, in the repository's order: the only ones allows_egress
    reads for it, so the answer is the whole repository's (a rule whose
    selector pins another namespace is not asked to match). ``reset()``
    after every change of the repository, the registry or the ipcache."""

    def __init__(self, agent):
        from cilium_tpu_torch.identity.model import ID_WORLD

        self.agent = agent
        self.world = agent.registry.get(ID_WORLD).labels
        # (subject labels, the candidate rules' ids) -> the subject's rules
        # as a Repository and its answers: kept while those rules live
        self.repos = {}
        self.reset()

    def reset(self):
        self.peers, self.answers = {}, {}
        self.by_ns = {}
        for k, r in enumerate(self.agent.repo.rules):
            self.by_ns.setdefault(r.endpoint_selector.get_match(K8S_NS_KEY), []).append(k)

    def peer(self, ip: str):
        """(a key of the peer's identity labels, those labels)."""
        got = self.peers.get(ip)
        if got is None:
            e = self.agent.ipcache.lookup_by_ip(ip)
            labels = self.agent.registry.get(e.identity).labels if e is not None else self.world
            got = self.peers[ip] = (tuple(str(x) for x in labels), labels)
        return got

    def subject(self, ep_id: int):
        """(the subject's rules as a Repository, its answers by (peer
        labels, dport, proto)), reused across steps while the rules that
        could select it are the same objects."""
        from cilium_tpu_torch.policy.repository import Repository

        got = self.answers.get(ep_id)
        if got is None:
            subj = self.agent.endpoints[ep_id].labels
            ns = next((lb.value for lb in subj if lb.source == "k8s"
                       and lb.key == K8S_NS_KEY[4:]), None)
            rules = self.agent.repo.rules
            cand = [rules[k] for k in sorted(self.by_ns.get(None, []) + (
                self.by_ns.get(ns, []) if ns is not None else []))]
            key = (tuple(str(x) for x in subj), tuple(id(r) for r in cand))
            got = self.repos.get(key)
            if got is None:
                sub = Repository()
                sub.add_list([r for r in cand if r.endpoint_selector.matches(subj)])
                got = self.repos[key] = (sub, {}, cand)
            self.answers[ep_id] = got
        return got

    def allows(self, ep_id: int, ip: str, dport: int, proto: int) -> bool:
        from cilium_tpu_torch.policy.search import Decision, PortContext, SearchContext

        sub, answers, _held = self.subject(ep_id)
        pkey, plabels = self.peer(ip)
        key = (pkey, dport, proto)
        ok = answers.get(key)
        if ok is None:
            pc = PortContext(dport, "UDP" if proto == 17 else "TCP")
            ok = answers[key] = sub.allows_egress(SearchContext(
                src=self.agent.endpoints[ep_id].labels, dst=plabels,
                dports=(pc,))) == Decision.ALLOWED
        return ok


def k8s_selected(cl, ns: str, match: dict):
    """The pods of namespace ``ns`` whose labels hold ``match``."""
    k = int(ns[2:])
    return [i for i, lab in enumerate(cl["pod_labels"])
            if i % K8S_NAMESPACES == k and all(lab.get(a) == v for a, v in match.items())]


def k8s_plan(cl):
    """What steps 2-6 change, chosen from the cluster: a CNP spec with a
    zone subject and a namespace peer (step 2), a pod to relabel (3), an
    external service some toServices spec names (4), a toFQDNs name
    (5), a NetworkPolicy with an ipBlock and a pod for the resync to
    lack (6); with the pods each step's rules select."""
    objs = cl["objects"]
    cnps = [o for (k, _ns, _n), o in objs.items() if k == "CiliumNetworkPolicy"]
    ns_key = "k8s:io.kubernetes.pod.namespace"
    cnp, s_idx = next((o, s) for o in cnps for s, sp in enumerate(o["specs"])
                      if "zone" in sp["endpointSelector"]["matchLabels"]
                      and ns_key in (sp["egress"][0].get("toEndpoints") or [{"matchLabels": {}}])[0][
                          "matchLabels"] and k8s_selected(cl, o["metadata"]["namespace"],
                                                          sp["endpointSelector"]["matchLabels"]))

    def subjects(pred):
        return sorted({i for o in cnps for sp in o["specs"] if pred(sp["egress"][0])
                       for i in k8s_selected(cl, o["metadata"]["namespace"],
                                             sp["endpointSelector"]["matchLabels"])})

    svc = next(s for s in cl["external"] if subjects(lambda eg: any(
        (t["k8sService"]["namespace"], t["k8sService"]["serviceName"]) == s
        for t in eg.get("toServices", ()))))
    name = next(n for n in cl["names"] if subjects(lambda eg: any(
        f["matchName"] == n for f in eg.get("toFQDNs", ()))))
    nps = [k for k in sorted(objs) if k[0] == "NetworkPolicy" and k8s_selected(
        cl, k[1], objs[k]["spec"]["podSelector"]["matchLabels"])]
    with_block = [k for k in nps if any(p.get("ipBlock") for eg in objs[k]["spec"]["egress"]
                                        for p in eg["to"])]
    np_key = with_block[len(with_block) // 2]
    np_block = next(p["ipBlock"] for eg in objs[np_key]["spec"]["egress"] for p in eg["to"]
                    if p.get("ipBlock"))
    sp = cnp["specs"][s_idx]
    block_pods = []
    for cidr, _exc in cl["blocks"]:
        block_pods.append(sorted({i for k in nps for eg in objs[k]["spec"]["egress"]
                                  for peer in eg["to"] if peer.get("ipBlock", {}).get("cidr") == cidr
                                  for i in k8s_selected(cl, k[1], objs[k]["spec"]["podSelector"][
                                      "matchLabels"])}))
    tp = sp["egress"][0].get("toPorts")
    cnp_port = tp[0]["ports"][0] if tp else None
    cnp_pods = k8s_selected(cl, cnp["metadata"]["namespace"], sp["endpointSelector"]["matchLabels"])
    k_ns = int(cnp["metadata"]["namespace"][2:])
    relabel = next(i for i in range(N_IDENTITIES) if i % K8S_NAMESPACES == k_ns
                   and i not in cnp_pods)
    return {
        "cnp": cnp, "spec": s_idx, "cnp_port": cnp_port,
        "relabel": relabel, "relabel_zone": sp["endpointSelector"]["matchLabels"]["zone"],
        "cnp_pods": cnp_pods,
        "peer_ns": sp["egress"][0]["toEndpoints"][0]["matchLabels"][ns_key],
        "victim": N_IDENTITIES - 1,
        "svc": svc, "svc_pods": subjects(lambda eg: any(
            (t["k8sService"]["namespace"], t["k8sService"]["serviceName"]) == svc
            for t in eg.get("toServices", ()))),
        "name": name, "name_pods": subjects(lambda eg: any(
            f["matchName"] == name for f in eg.get("toFQDNs", ()))),
        "blocks": block_pods,
        "np": np_key, "np_block": (np_block["cidr"], np_block["except"][0]),
        "np_pods": k8s_selected(cl, np_key[1], objs[np_key]["spec"]["podSelector"][
            "matchLabels"]),
    }


K8S_FOCUS = 512  # lanes a step's focus group holds


def k8s_focus(seed: int, cl, plan, f4) -> None:
    """Rewrite lanes K8S_ORACLE onwards: first, for each ipBlock,
    K8S_BLOCK_LANES lanes inside and as many outside its except, their
    subjects pods of NetworkPolicies with that block (``f4["block_lanes"]``
    lists them); then groups aimed at what each step changes (its rules'
    subjects against its peers, the relabelled and the reaped pod as
    subject or peer), so that every step moves lanes."""
    import numpy as np

    rs = np.random.default_rng(seed + 907)
    groups = []

    def u32(ips):
        return np.array([int(ipaddress.IPv4Address(ip)) for ip in ips], np.uint32)

    ns_pods = lambda ns: [i for i in range(N_IDENTITIES) if i % K8S_NAMESPACES == int(ns[2:])]
    k_peer = int(plan["peer_ns"][2:])
    both = ns_pods(plan["peer_ns"]) + ns_pods(f"ns{(k_peer + 1) % K8S_NAMESPACES}")
    groups.append((plan["cnp_pods"], u32([k8s_v4(i) for i in both]), plan["cnp_port"]))
    groups.append(([plan["relabel"]], u32([k8s_v4(i) for i in both]), plan["cnp_port"]))
    groups.append(([plan["relabel"]], u32([k8s_v4(i) for i in range(N_IDENTITIES)]), None))
    groups.append((list(range(N_IDENTITIES - 1)), u32([k8s_v4(plan["relabel"])]), None))
    k = cl["external"].index(plan["svc"])
    old = cl["ext_backends"][plan["svc"]]
    svc = cl["objects"][("Service",) + plan["svc"]]["spec"]
    ips = old + [f"198.19.{k}.{j + 1}" for j in range(len(old))]
    groups.append((plan["svc_pods"], u32(ips), None))
    groups.append((plan["svc_pods"], u32([svc["clusterIP"]]), svc["ports"][0]))
    kn = cl["names"].index(plan["name"])
    ans = cl["answers"][plan["name"]][0]
    groups.append((plan["name_pods"], u32(ans + [f"100.65.{kn}.{j + 1}" for j in range(len(ans))]),
                   None))
    cidr, exc = plan["np_block"]
    outside = [str(a) for a in list(ipaddress.ip_network(cidr).hosts())[::97]
               if a not in ipaddress.ip_network(exc)]
    groups.append((plan["np_pods"], u32(outside), {"port": 443, "protocol": "TCP"}))
    groups.append((list(range(N_IDENTITIES - 1)), u32([k8s_v4(plan["victim"])]), None))
    lo = K8S_ORACLE
    f4["block_lanes"] = []
    for b, (cidr, exc) in enumerate(cl["blocks"]):
        subj = [i for i in plan["blocks"][b] if i != plan["victim"]] or [0]
        base, third = int(ipaddress.IPv4Address(cidr.split("/")[0])), int(exc.split(".")[2])
        for kd in (3, 4):
            sl = slice(lo, lo + K8S_BLOCK_LANES)
            t = third if kd == 3 else (third + rs.integers(1, 256, K8S_BLOCK_LANES)) & 255
            f4["subj"][sl] = np.asarray(subj, np.int64)[rs.integers(0, len(subj), K8S_BLOCK_LANES)]
            f4["peer"][sl] = (base | (t << 8) | rs.integers(1, 255, K8S_BLOCK_LANES)).astype(np.uint32)
            f4["dports"][sl], f4["protos"][sl] = 443, 6
            f4["kind"][sl], f4["block"][sl] = kd, b
            f4["block_lanes"] += list(range(lo, lo + K8S_BLOCK_LANES))
            lo += K8S_BLOCK_LANES
    for subj, peers, port in groups:
        subj = [i for i in subj if i != plan["victim"]]
        sl = slice(lo, lo + K8S_FOCUS)
        f4["subj"][sl] = np.asarray(subj, np.int64)[rs.integers(0, len(subj), K8S_FOCUS)]
        f4["peer"][sl] = peers[rs.integers(0, len(peers), K8S_FOCUS)]
        if port is None:
            f4["dports"][sl] = rs.choice(np.array([443, 80, 5432, 8080], np.int32), K8S_FOCUS)
            f4["protos"][sl] = 6
        else:
            f4["dports"][sl] = int(port["port"])
            f4["protos"][sl] = 17 if port.get("protocol") == "UDP" else 6
        f4["kind"][sl] = 8
        f4["block"][sl] = -1
        lo += K8S_FOCUS


def k8s_main_path(seed: int, card: str, dev=None):
    """Phase 3r: the Kubernetes and DNS policy sources (A9b1 + A9b2) on the
    card. k8s_cluster's objects go through K8sWatcher into K8sAgent (the
    five daemon methods; a PolicyEngine, a DatapathPipeline with the
    ServiceManager as its LB and no conntrack), and a DNSPoller with a
    seeded resolver answers the toFQDNs names. Six steps, each ended by a
    checkpoint (the CIDR identities of the rules' prefixes, then the
    agent's refresh + rebuild) and a 1 048 576-flow v4 egress batch with
    services (K3, K4, K9); steps 1 and 4 also a v6 batch (K5, K4):
    1. a resync of every object in the Informer's kind order, and a poll;
    2. a MODIFIED CNP whose spec swaps its peer namespace, then the same
       object with only its status changed (no revision, no ask, no launch);
    3. a pod deleted and added again with other labels;
    4. a toServices target's Endpoints moved to other addresses;
    5. a toFQDNs name's answer moved, poll_once after the old TTL;
    6. a resync whose snapshot lacks one NetworkPolicy and one pod.
    Checks at each step: the batch's verdicts, redirects, the LB stage's
    translation and revNAT ids on the first K8S_PLAIN_SLICE lanes equal
    the plain versions over the same tables on the CPU; K8S_ORACLE lanes
    and lanes inside and outside each ipBlock's except equal the host
    oracle (v6: K8S_ORACLE lanes); from step 2 on, every lane whose
    verdict, translation or revNAT id moved is one the step touched (its
    subject selected by a rule that changed or its endpoint moved, its
    peer under a changed ipcache prefix before or after translation, its
    frontend's backends changed), every touched lane equals the oracle,
    and some lane flipped; the LB frontends equal what the objects
    define. The caller set the launch counts to 0; the phase fails past
    K8S_PHASE_LIMIT_S."""
    import copy

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.pipeline import (
        DROP_NO_SERVICE, TRAFFIC_EGRESS, DatapathPipeline, process_flows_wide,
    )
    from cilium_tpu_torch.fqdn import DNSPoller
    from cilium_tpu_torch.ipcache.ipcache import SOURCE_GENERATED
    from cilium_tpu_torch.k8s import K8sWatcher
    from cilium_tpu_torch.labels import LabelArray
    from cilium_tpu_torch.labels.cidr import cidr_labels
    from cilium_tpu_torch.lb.device import flow_hash32, lb_translate
    from cilium_tpu_torch.ops.lpm import ipv4_to_bytes
    from cilium_tpu_torch.policy.api.serialization import rule_to_dict
    from cilium_tpu_torch.policy.cidr import compute_resultant_cidr_set

    t_phase = time.perf_counter()
    cl = k8s_cluster(seed)
    t_cluster = time.perf_counter() - t_phase
    objs = dict(cl["objects"])
    plan = k8s_plan(cl)
    victim, relabelled = plan["victim"], plan["relabel"]
    subjects = [i for i in range(N_IDENTITIES) if i != victim]
    f4 = k8s_flows(seed, cl, subjects)
    k8s_focus(seed, cl, plan, f4)
    f6 = k8s_flows6(seed, subjects)
    agent = K8sAgent(K8S_HOST_IP, "10.0.0.0/16", device=dev)
    agent.pipeline = pipe = DatapathPipeline(agent.engine, agent.ipcache, lb=agent.services,
                                             device=dev)
    watcher = K8sWatcher(agent)
    watcher.node_name = K8S_NODE
    answers = dict(cl["answers"])
    poller = DNSPoller(agent.repo, resolver=lambda name: answers.get(name, ([], 0.0)),
                       on_change=lambda rev: agent.asks.append("fqdn translate"))
    now0 = 1000.0
    oracle = K8sOracle(agent)
    cidr_ids = {}
    steps = []
    print(f"k8s setup: the cluster's objects {t_cluster!r}s, plan, flows and the agent "
          f"{time.perf_counter() - t_phase - t_cluster!r}s [{card}]", flush=True)

    def pod_of(ep_id: int) -> int:
        return int(agent.endpoints[ep_id].pod_name.split("/p")[1])

    def ep_index(subj):
        pos = {pid: k for k, pid in enumerate(pipe._endpoint_ids)}
        of_pod = np.full(N_IDENTITIES, -1, np.int64)
        for ep_id in agent.endpoints:
            of_pod[pod_of(ep_id)] = pos[ep_id]
        idx = of_pod[subj]
        if (idx < 0).any():
            fail("k8s: a lane's subject pod has no endpoint in the pipeline")
        return idx.astype(np.int32)

    def sync_cidrs() -> None:
        """A local identity with the prefix's cidr: labels, in the ipcache
        at source generated, for every prefix the rules allow: the CIDR
        identities an agent's ipcache holds for CIDR policy (the Daemon
        leaves them to its caller)."""
        want = set()
        for r in agent.repo.rules:
            for eg in r.egress:
                want.update(str(ipaddress.ip_network(c, strict=False)) for c in eg.to_cidr)
                want.update(compute_resultant_cidr_set(eg.to_cidr_set))
            for ing in r.ingress:
                want.update(str(ipaddress.ip_network(c, strict=False)) for c in ing.from_cidr)
                want.update(compute_resultant_cidr_set(ing.from_cidr_set))
        for p in sorted(set(cidr_ids) - want):
            agent.ipcache.delete(p, SOURCE_GENERATED)
            agent.registry.release(cidr_ids.pop(p))
        for p in sorted(want - set(cidr_ids)):
            ident = agent.registry.allocate(LabelArray(cidr_labels(p)), local=True)
            if not agent.ipcache.upsert(p, ident.id, source=SOURCE_GENERATED):
                fail(f"k8s: the CIDR identity of {p} lost to a higher ipcache source")
            cidr_ids[p] = ident

    def run4():
        eps = ep_index(f4["subj"])
        seen = []
        real = pipe._lb_stage

        def lb_stage(lbt, fl, sports):
            got = real(lbt, fl, sports)
            seen.append((pack_u32(fl.bytes_()), np.array(fl.dports, copy=True), got))
            return got

        pipe._lb_stage = lb_stage
        try:
            v, red = pipe.process(f4["peer"], eps, f4["dports"], f4["protos"], ingress=False,
                                  sports=f4["sports"])
        finally:
            del pipe._lb_stage
        if len(seen) != 1 or seen[0][2][0] is None:
            fail("k8s: the v4 egress batch did not go through one LB stage that translated")
        peer_t, dport_t, (drop, revnat) = seen[0]
        return {"v": v, "red": red, "peer": peer_t, "dport": dport_t, "drop": drop,
                "revnat": revnat, "eps": eps}

    def run6():
        eps = ep_index(f6["subj"])
        v, red = pipe.process_v6(f6["addr"], eps, f6["dports"], f6["protos"], ingress=False,
                                 sports=f6["sports"])
        return {"v": v, "red": red, "eps": eps}

    def plain4(r) -> None:
        """The pipeline's no-CT egress path over its own tables on the
        CPU, where each wrapper runs its plain version, on the slice."""
        n = K8S_PLAIN_SLICE

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))

        with uncounted():
            pb = ipv4_to_bytes(f4["peer"][:n])
            ep_ids = np.asarray(pipe._endpoint_ids, np.int64)[r["eps"][:n]]
            fh = flow_hash32(pb, f4["sports"][:n], f4["dports"][:n], f4["protos"][:n], ep_ids)
            nb, npo, rv, _ok, nobk = lb_translate(tables_on_cpu(pipe._lb_tables[4]), t(pb),
                                                  t(f4["dports"][:n]), t(f4["protos"][:n]), t(fh))
            peer_t = pack_u32(nb.numpy())
            v, red, _c = process_flows_wide(
                tables_on_cpu(pipe._tables[(TRAFFIC_EGRESS, 4)]), t(peer_t.view(np.int32)),
                t(r["eps"][:n]), npo.to(torch.int32), t(f4["protos"][:n]),
                ep_count=max(1, len(pipe._endpoints)), prefilter=False)[:3]
        nobk = nobk.numpy().astype(bool)
        v = np.where(nobk, np.int8(DROP_NO_SERVICE), v.numpy())
        red = red.numpy() & ~nobk
        for what, got, want in (("verdicts", r["v"][:n], v), ("redirects", r["red"][:n], red),
                                ("translated peers", r["peer"][:n], peer_t),
                                ("translated ports", r["dport"][:n], npo.numpy()),
                                ("no-backend drops", r["drop"][:n], nobk),
                                ("revNAT ids", r["revnat"][:n], rv.numpy())):
            bad = np.nonzero(np.asarray(got).astype(np.int64) != np.asarray(want).astype(np.int64))[0]
            if bad.size:
                fail(f"k8s: v4 {what} differ from the plain path on {bad.size} of {n} lanes "
                     f"(first {int(bad[0])})")

    def plain6(r) -> None:
        with uncounted():
            got = plain_slice(pipe._tables[(TRAFFIC_EGRESS, 6)], pipe._v6_fused,
                              max(1, len(pipe._endpoints)), 6,
                              [a[:K8S_PLAIN_SLICE] for a in (f6["addr"], r["eps"], f6["dports"],
                                                              f6["protos"])])
        n = len(got[0])
        if not (np.array_equal(r["v"][:n], got[0]) and np.array_equal(r["red"][:n], got[1])):
            fail("k8s: the v6 verdicts or redirects differ from the plain path")

    def want4(r, lanes):
        """The oracle's verdict of each v4 lane: DROP_NO_SERVICE for a
        frontend without backends, else 1 (allowed) or 2; one answer a
        distinct (endpoint, peer, dport, proto)."""
        lanes = np.asarray(lanes, np.int64)
        keys = np.stack([r["eps"][lanes].astype(np.int64), r["peer"][lanes].astype(np.int64),
                         r["dport"][lanes].astype(np.int64), f4["protos"][lanes].astype(np.int64)], 1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        ids = pipe._endpoint_ids
        ans = np.array([1 if oracle.allows(ids[int(e)], str(ipaddress.IPv4Address(int(p))),
                                           int(d), int(q)) else 2 for e, p, d, q in uniq], np.int8)
        out = ans[inv.reshape(-1)]
        out[np.asarray(r["drop"][lanes], bool)] = DROP_NO_SERVICE
        return out

    def sampled(r4, r6, label):
        blk = f4["block_lanes"]
        lanes = list(range(K8S_ORACLE)) + blk
        want = want4(r4, lanes)
        got = r4["v"][lanes]
        if not np.array_equal(got, want):
            i = int(np.nonzero(got != want)[0][0])
            fail(f"k8s: step {label}: v4 lane {lanes[i]} (kind {int(f4['kind'][lanes[i]])}) "
                 f"verdict {int(got[i])}, oracle {int(want[i])}")
        inside = [i for i in blk if f4["kind"][i] == 3]
        outside = [i for i in blk if f4["kind"][i] == 4]
        if r6 is not None:
            ids = pipe._endpoint_ids
            for i in range(K8S_ORACLE):
                ip = str(ipaddress.IPv6Address(bytes(int(x) for x in f6["addr"][i])))
                ok = oracle.allows(ids[int(r6["eps"][i])], ip, int(f6["dports"][i]),
                                   int(f6["protos"][i]))
                if int(r6["v"][i]) != (1 if ok else 2):
                    fail(f"k8s: step {label}: v6 lane {i} ({ip}) verdict {int(r6['v'][i])}, "
                         f"oracle {1 if ok else 2}")
        return len(lanes), (np.bincount(r4["v"][inside], minlength=3)[1:3].tolist(),
                            np.bincount(r4["v"][outside], minlength=3)[1:3].tolist())

    def frontends_check(label) -> int:
        got = {(s.frontend.ip, s.frontend.port, s.frontend.protocol):
               [(b.ip, b.port) for b in s.backends] for s in agent.services.list()}
        want = k8s_expected_frontends(objs, K8S_HOST_IP)
        if got != want:
            diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))[:3]
            fail(f"k8s: step {label}: the LB frontends differ from the objects' ({len(got)} "
                 f"against {len(want)}; first {diff})")
        return len(got)

    def state():
        return {"rules": [json.dumps(rule_to_dict(r), sort_keys=True) for r in agent.repo.rules],
                "rule_objs": list(agent.repo.rules),
                "ipcache": dict(agent.ipcache.items()),
                "lb": {s.frontend: s.backends for s in agent.services.list()},
                "eps": {pod_of(e.id): (e.id, e.identity.id, e.labels)
                        for e in agent.endpoints.values()}}

    def touched(before, after, r_old, r_new):
        """Lanes a step may move: the subject selected by a rule that
        changed or its endpoint moved, the peer (before or after
        translation) under an ipcache prefix that changed, the
        destination a frontend whose backends changed."""
        cand = np.zeros(BATCH, bool)
        old, new = set(before["rules"]), set(after["rules"])
        changed = [r for r, j in zip(before["rule_objs"], before["rules"]) if j not in new]
        changed += [r for r, j in zip(after["rule_objs"], after["rules"]) if j not in old]
        pods = {p for p in set(before["eps"]) | set(after["eps"])
                if before["eps"].get(p) != after["eps"].get(p)}
        for st in (before, after):
            for p, (_e, _i, labels) in st["eps"].items():
                if any(r.endpoint_selector.matches(labels) for r in changed):
                    pods.add(p)
        if pods:
            cand |= np.isin(f4["subj"], np.fromiter(pods, np.int64))
        moved = [p for p in set(before["ipcache"]) | set(after["ipcache"])
                 if before["ipcache"].get(p) != after["ipcache"].get(p)]
        for p in moved:
            net = ipaddress.ip_network(p)
            if net.version == 4:
                mask = np.uint32((0xFFFFFFFF << (32 - net.prefixlen)) & 0xFFFFFFFF)
                base = np.uint32(int(net.network_address))
                for peer in (r_old["peer"], r_new["peer"], f4["peer"]):
                    cand |= (peer & mask) == base
        n_fe = 0
        for fe in set(before["lb"]) | set(after["lb"]):
            if before["lb"].get(fe) != after["lb"].get(fe) and fe.family == 4:
                n_fe += 1
                hit = ((f4["peer"] == np.uint32(int(ipaddress.IPv4Address(fe.ip))))
                       & (f4["dports"] == fe.port))
                if fe.proto_num:
                    hit &= f4["protos"] == fe.proto_num
                cand |= hit
        return cand, {"rules": len(changed), "pods": len(pods), "prefixes": len(moved),
                      "frontends": n_fe}

    def flips(label, before, after, r_old, r_new):
        cand, why = touched(before, after, r_old, r_new)
        moved = r_new["v"] != r_old["v"]
        out = (moved | (r_old["peer"] != r_new["peer"]) | (r_old["dport"] != r_new["dport"])
               | (r_old["revnat"] != r_new["revnat"]) | (r_old["red"] != r_new["red"])) & ~cand
        if out.any():
            i = int(np.nonzero(out)[0][0])
            fail(f"k8s: step {label}: {int(out.sum())} lanes the step did not touch moved (first "
                 f"{i}: kind {int(f4['kind'][i])}, verdict {int(r_old['v'][i])} -> "
                 f"{int(r_new['v'][i])})")
        lanes = np.nonzero(cand)[0]
        want = want4(r_new, lanes)
        bad = np.nonzero(r_new["v"][lanes] != want)[0]
        if bad.size:
            i = int(lanes[bad[0]])
            fail(f"k8s: step {label}: {bad.size} touched lanes differ from the oracle (first {i}: "
                 f"kind {int(f4['kind'][i])}, verdict {int(r_new['v'][i])}, oracle "
                 f"{int(want[bad[0]])})")
        if not moved.any():
            fail(f"k8s: step {label} flipped no lane")
        return {"touched": int(cand.sum()), "flipped": int(moved.sum()),
                "to_drop": int((moved & (r_old["v"] == 1)).sum()),
                "to_allow": int((moved & (r_new["v"] == 1)).sum()), "changed": why}

    def step(label, event, *, v6: bool = False, prev=None):
        """``event``, then the checkpoint, the batches and the checks."""
        before = state() if prev is not None else None
        l0 = _kernels.launches()
        t0 = time.perf_counter()
        info = event()
        t_event = time.perf_counter() - t0
        t1 = time.perf_counter()
        sync_cidrs()
        t_cidr = time.perf_counter() - t1
        t1 = time.perf_counter()
        asks = agent.regenerate()
        if dev is None:
            torch.cuda.synchronize()
        t_regen = time.perf_counter() - t1
        t1 = time.perf_counter()
        r4 = run4()
        t_batch = time.perf_counter() - t1
        t_first = time.perf_counter() - t0
        r6 = run6() if v6 else None
        launches = launch_delta(l0)
        oracle.reset()
        t1 = time.perf_counter()
        plain4(r4)
        if r6 is not None:
            plain6(r6)
        t_plain = time.perf_counter() - t1
        t1 = time.perf_counter()
        n_or, blk = sampled(r4, r6, label)
        n_fe = frontends_check(label)
        t_oracle = time.perf_counter() - t1
        t1 = time.perf_counter()
        fl = flips(label, before, state(), prev, r4) if prev is not None else None
        t_flips = time.perf_counter() - t1
        by_ask = {a: asks.count(a) for a in dict.fromkeys(asks)}
        print(f"k8s step {label}: {info}; event {t_event!r}s, CIDR identities {t_cidr!r}s, "
              f"checkpoint (refresh + rebuild) {t_regen!r}s covering {len(asks)} asks {by_ask}, "
              f"v4 batch {t_batch!r}s: event to first verdict {t_first!r}s; launches {launches}; "
              f"v4 verdicts {np.bincount(r4['v'], minlength=5)[1:].tolist()} (allow, drop, "
              f"prefilter, no service), {int((r4['revnat'] != 0).sum())} translated; ipBlock lanes "
              f"inside / outside the except (allow, drop) {blk}; {len(cidr_ids)} CIDR identities; "
              f"{n_fe} LB frontends == the objects'; {K8S_PLAIN_SLICE} lanes == the plain path"
              f"{' (v4 and v6)' if v6 else ''}; {n_or} v4 lanes"
              f"{f' and {K8S_ORACLE} v6' if v6 else ''} == the oracle"
              + (f"; {fl}" if fl else "") + f"; checks: plain path {t_plain!r}s, sampled "
              f"oracle and frontends {t_oracle!r}s, touched lanes {t_flips!r}s [{card}]", flush=True)
        steps.append({"step": label, "first_s": t_first, "asks": len(asks), "launches": launches})
        return r4, asks

    # -- 1. the initial sync --------------------------------------------------------
    clock = {"policy_replace": 0.0, "policy_translate": 0.0, "sync_from_registry": 0.0}

    def timed_on(obj, name):
        real = getattr(obj, name)

        def call(*a, **k):
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                clock[name] += time.perf_counter() - t
        setattr(obj, name, call)
        return lambda: delattr(obj, name)

    def initial_sync():
        undo = [timed_on(agent, "policy_replace"), timed_on(agent, "policy_translate"),
                timed_on(agent.services, "sync_from_registry")]
        t0 = time.perf_counter()
        try:
            watcher.resync(k8s_snapshot(objs))
        finally:
            for u in undo:
                u()
        t_sync = time.perf_counter() - t0
        t0 = time.perf_counter()
        changed = poller.poll_once(now=now0)
        t_poll = time.perf_counter() - t0
        n_kind = collections.Counter(key[0] for key in objs)
        print(f"k8s sync: objects {dict(n_kind)} ({sum(len(o['specs']) for (k, _a, _b), o in objs.items() if k == 'CiliumNetworkPolicy')} "
              f"CNP specs, {K8S_TO_SERVICES} with toServices, {K8S_TO_FQDNS} with toFQDNs) -> "
              f"{len(agent.repo.rules)} rules, {len(agent.endpoints)} endpoints, "
              f"{len(watcher.nodes)} nodes; resync {t_sync!r}s: in policy_replace "
              f"{clock['policy_replace']!r}s, in policy_translate + the LB sync "
              f"{clock['policy_translate'] + clock['sync_from_registry']!r}s (translate "
              f"{clock['policy_translate']!r}s, sync_from_registry "
              f"{clock['sync_from_registry']!r}s), the rest "
              f"{t_sync - sum(clock.values())!r}s; the first poll {t_poll!r}s re-translated "
              f"{changed} rules [{card}]", flush=True)
        if len(agent.endpoints) != N_IDENTITIES or len(watcher.nodes) != K8S_NODES:
            fail(f"k8s: the sync left {len(agent.endpoints)} endpoints, {len(watcher.nodes)} nodes")
        return {"resync_s": t_sync, "poll_s": t_poll}

    r1, _ = step(1, initial_sync, v6=True)

    # -- 2. a MODIFIED CNP that swaps its peer, then a status-only change ---------
    cnp = plan["cnp"]
    key_cnp = ("CiliumNetworkPolicy", cnp["metadata"]["namespace"], cnp["metadata"]["name"])
    mod = copy.deepcopy(cnp)
    new_ns = f"ns{(int(plan['peer_ns'][2:]) + 1) % K8S_NAMESPACES}"
    mod["specs"][plan["spec"]]["egress"][0]["toEndpoints"][0]["matchLabels"][
        "k8s:io.kubernetes.pod.namespace"] = new_ns

    def modify():
        objs[key_cnp] = mod
        watcher.apply(mod)
        return {"cnp": key_cnp[1:], "peer": f"{plan['peer_ns']} -> {new_ns}"}

    r2, asks = step(2, modify, prev=r1)
    if asks != ["policy replace"]:
        fail(f"k8s: the MODIFIED CNP asked {asks}, one policy replace expected")
    status = dict(mod, status={"nodes": {K8S_NODE: {"ok": True, "enforcing": True}}})
    rev, l0 = agent.repo.revision, _kernels.launches()
    t0 = time.perf_counter()
    watcher.apply(status)
    t_status = time.perf_counter() - t0
    objs[key_cnp] = status
    if agent.repo.revision != rev or agent.asks or _kernels.launches() != l0:
        fail(f"k8s: the status-only MODIFIED moved the revision {rev} -> {agent.repo.revision}, "
             f"asked {agent.asks} or launched {launch_delta(l0)}")
    print(f"k8s step 2b: the same CNP with only its status changed: {t_status!r}s, revision "
          f"{rev} kept, no regeneration asked, no launch [{card}]", flush=True)

    # -- 3. a pod deleted and added again with other labels ------------------------
    key_pod = ("Pod", f"ns{relabelled % K8S_NAMESPACES}", f"p{relabelled}")
    old_pod = objs[key_pod]
    lab = old_pod["metadata"]["labels"]
    new_pod = k8s_pod(relabelled, dict(lab, app=f"a{(int(lab['app'][1:]) + 1) % N_APPS}",
                                       zone=plan["relabel_zone"]))

    def relabel():
        before = agent.ipcache.lookup_exact(f"{k8s_v4(relabelled)}/32").identity
        watcher.delete(old_pod)
        watcher.apply(new_pod)
        objs[key_pod] = new_pod
        after = agent.ipcache.lookup_exact(f"{k8s_v4(relabelled)}/32").identity
        if after == before:
            fail("k8s: the relabelled pod kept its identity")
        return {"pod": key_pod[1:], "identity": f"{before} -> {after}"}

    r3, asks = step(3, relabel, prev=r2)
    if sorted(asks) != ["endpoint created", "endpoint deleted"]:
        fail(f"k8s: the pod's delete and add asked {asks}")

    # -- 4. a toServices target's Endpoints move ----------------------------------
    key_ep = ("Endpoints",) + plan["svc"]
    k_ext = cl["external"].index(plan["svc"])
    old_ips = cl["ext_backends"][plan["svc"]]
    new_ips = [f"198.19.{k_ext}.{j + 1}" for j in range(len(old_ips))]
    new_ep = copy.deepcopy(objs[key_ep])
    new_ep["subsets"][0]["addresses"] = [{"ip": ip} for ip in new_ips]

    def move_backends():
        objs[key_ep] = new_ep
        watcher.apply(new_ep)
        return {"service": plan["svc"], "backends": f"{old_ips} -> {new_ips}"}

    r4, asks = step(4, move_backends, v6=True, prev=r3)
    if asks != ["policy translate"]:
        fail(f"k8s: the Endpoints move asked {asks}, one policy translate expected")
    vip = f4["peer"] == np.uint32(int(ipaddress.IPv4Address(
        objs[("Service",) + plan["svc"]]["spec"]["clusterIP"])))
    new_u32 = np.array([int(ipaddress.IPv4Address(ip)) for ip in new_ips], np.int64)
    if not vip.any() or not np.isin(r4["peer"][vip], new_u32).all():
        fail("k8s: K9 did not send the moved service's frontend lanes to its new backends")

    # -- 5. a toFQDNs name's answer moves -----------------------------------------
    name = plan["name"]
    k_name = cl["names"].index(name)
    old_ans = answers[name][0]
    new_ans = [f"100.65.{k_name}.{j + 1}" for j in range(len(old_ans))]

    def move_answer():
        answers[name] = (new_ans, K8S_FQDN_TTL)
        changed = poller.poll_once(now=now0 + 2 * K8S_FQDN_TTL)
        return {"name": name, "answer": f"{old_ans} -> {new_ans}", "rules": changed}

    r5, asks = step(5, move_answer, prev=r4)
    if asks != ["fqdn translate"]:
        fail(f"k8s: the DNS move asked {asks}, one fqdn translate expected")

    # -- 6. a resync that lacks one policy and one pod ------------------------------
    key_victim = ("Pod", f"ns{victim % K8S_NAMESPACES}", f"p{victim}")

    def reap():
        t0 = time.perf_counter()
        watcher.resync(k8s_snapshot(objs, drop=(plan["np"], key_victim)))
        t = time.perf_counter() - t0
        objs.pop(plan["np"])
        objs.pop(key_victim)
        if key_victim[1:] in watcher.pods.known_pods() or any(
                n == plan["np"][2] and ns == plan["np"][1]
                for n, ns in watcher._known_policy_labels()):
            fail("k8s: the resync did not reap the policy and the pod it lacked")
        return {"reaped": [plan["np"][1:], key_victim[1:]], "resync_s": t}

    _r6, asks = step(6, reap, prev=r5)
    if sorted(asks) != ["endpoint deleted", "policy delete"]:
        fail(f"k8s: the reaping resync asked {asks}")

    wall = time.perf_counter() - t_phase
    print(f"k8s: event to first verdict by step {[round(s['first_s'], 6) for s in steps]} s, "
          f"asks by checkpoint {[s['asks'] for s in steps]}; phase in {wall:.2f}s (limit "
          f"{K8S_PHASE_LIMIT_S:.0f}s) [{card}]", flush=True)
    if wall > K8S_PHASE_LIMIT_S:
        fail(f"k8s: phase in {wall:.2f}s, over its {K8S_PHASE_LIMIT_S:.0f}s limit")
    return steps


# -- 3s. the external proxy and its xDS channel -------------------------------------

# two child starts, each mostly a fresh interpreter's import torch
# (tools/proxy_child_start.py, PERF.md §7), and three rounds
EXTERNAL_PHASE_LIMIT_S = 45.0
EXTERNAL_GROUPS = 4  # the largest (endpoint, port) request groups of phase 3d's set
EXTERNAL_GROUP_REQS = 280  # requests taken from each
EXTERNAL_ALIASES = 64  # loopback aliases that NPHDS maps, one source identity each
EXTERNAL_UNMAPPED = "127.0.2.1"  # the alias NPHDS leaves out: the child resolves it to the world
EXTERNAL_THREADS = 16  # client connections open at once
EXTERNAL_WAIT_S = 20.0  # the most a READY, an ACK or the access log may take


def external_alias(k: int) -> str:
    return f"127.0.1.{k + 1}"


def http_session(alias: str, port: int, reqs):
    """One keep-alive HTTP/1.1 connection from ``alias`` to the child's
    listener on ``port``: each (method, path) request in turn, no
    header (what the child parses is the card's HTTPRequest); → (status
    codes, seconds from connect to the last response)."""
    c = socket.socket()
    c.bind((alias, 0))
    c.settimeout(EXTERNAL_WAIT_S)
    t0 = time.perf_counter()
    c.connect(("127.0.0.1", port))
    codes, buf = [], b""
    try:
        for method, path in reqs:
            c.sendall(f"{method} {path} HTTP/1.1\r\n\r\n".encode())
            while b"\r\n\r\n" not in buf:
                chunk = c.recv(65536)
                if not chunk:
                    fail(f"external proxy: the child closed {alias} -> :{port} mid-session")
                buf += chunk
            head, _, buf = buf.partition(b"\r\n\r\n")
            lines = head.decode("latin1").split("\r\n")
            clen = next(int(ln.split(":", 1)[1]) for ln in lines[1:]
                        if ln.lower().startswith("content-length"))
            while len(buf) < clen:
                chunk = c.recv(65536)
                if not chunk:
                    fail(f"external proxy: the child closed {alias} -> :{port} mid-body")
                buf += chunk
            buf = buf[clen:]
            codes.append(int(lines[0].split(" ", 2)[1]))
        return codes, time.perf_counter() - t0
    finally:
        c.close()


def kafka_session(alias: str, port: int, frames):
    """One connection to the child's Kafka listener; each frame in turn;
    → per frame True where the child acked it (terminating mode: an
    empty frame holding the correlation id), False where it answered a
    reject frame with error 29 in every partition."""
    import struct

    c = socket.socket()
    c.bind((alias, 0))
    c.settimeout(EXTERNAL_WAIT_S)
    c.connect(("127.0.0.1", port))
    out = []
    try:
        for cid, frame in frames:
            c.sendall(frame)
            body = b""
            while len(body) < 4:
                chunk = c.recv(4 - len(body))
                if not chunk:
                    fail(f"external proxy: the child closed the Kafka session from {alias}")
                body += chunk
            (size,) = struct.unpack(">i", body)
            body = b""
            while len(body) < size:
                chunk = c.recv(size - len(body))
                if not chunk:
                    fail(f"external proxy: the child closed the Kafka session from {alias}")
                body += chunk
            if struct.unpack(">i", body[:4])[0] != cid:
                fail(f"external proxy: a Kafka answer carries another correlation id than {cid}")
            if size == 4:
                out.append(True)
            elif struct.pack(">h", 29) in body:
                out.append(False)
            else:
                fail(f"external proxy: a Kafka answer of {size} bytes is neither ack nor reject")
        return out
    finally:
        c.close()


def external_proxy_main_path(r, card: str):
    """Phase 3s: the external proxy and its xDS channel (A9b3 + A9b4) on
    phase 3d's redirect world. The agent side publishes the NPDS
    resources of the endpoints regenerated on the card (and the world's
    Kafka redirect) and NPHDS rows mapping loopback aliases to the
    requests' source identities, serves them with an XDSServer and
    collects the access log through an AccessLogSocketServer; a
    ProxyLauncher child (no --device: the card) enforces them on real
    sockets. Every answer of the child is held to the card's check_batch
    of the same requests (L7DeviceBatch off and on), before and after a
    policy swap and after a SIGKILL and the launcher's restart. The
    child checks each request on its own, on the host (a lone request
    walks the host DFA; it never turns L7DeviceBatch on), so the path
    under test launches no kernel in this process; the card's
    check_batch is the oracle, run uncounted, its launch delta printed
    apart."""
    import collections
    import os
    import resource
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath import l7_pipeline as l7rt
    from cilium_tpu_torch.identity.model import ID_WORLD
    from cilium_tpu_torch.l7 import HTTPPolicy, HTTPRequest, KafkaRequest
    from cilium_tpu_torch.proxy.accesslog import AccessLogServer, AccessLogSocketServer
    from cilium_tpu_torch.proxy.launcher import ProxyLauncher
    from cilium_tpu_torch.utils.completion import WaitGroup
    from cilium_tpu_torch.xds import (
        NETWORK_POLICY_HOSTS_TYPE, NETWORK_POLICY_TYPE, ResourceCache, XDSServer,
        endpoint_policy_resource,
    )

    t_phase = time.perf_counter()
    proxy, groups, reqs_d = r["proxy"], r["groups"], r["reqs_d"]
    node = "external-proxy"

    # -- the NPDS resources: every regenerated endpoint whose listeners fit
    kafka_rds = [rd for rd in proxy.redirects().values() if rd.parser == "kafka"]
    if len(kafka_rds) != 1:
        fail(f"external proxy: phase 3d's proxy holds {len(kafka_rds)} Kafka redirects, not one")
    kafka_rd = kafka_rds[0]
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    room = soft // 2 if soft != resource.RLIM_INFINITY else 1 << 20
    resources = {kafka_rd.endpoint_id: endpoint_policy_resource(kafka_rd.endpoint_id, proxy)}
    n_listeners = len(resources[kafka_rd.endpoint_id]["l7_ports"])
    eps_all = sorted({rd.endpoint_id for rd in proxy.redirects().values()} - set(resources))
    for ep in eps_all:
        res = endpoint_policy_resource(ep, proxy)
        if n_listeners + len(res["l7_ports"]) > room:
            break
        resources[ep] = res
        n_listeners += len(res["l7_ports"])
    res_bytes = sum(len(json.dumps(x)) for x in resources.values())
    print(f"external proxy: {len(resources)} NPDS resources ({len(resources) - 1} of "
          f"{len(eps_all)} regenerated endpoints, the world's Kafka redirect), {n_listeners} "
          f"listeners under RLIMIT_NOFILE {soft} with half to spare, {res_bytes} bytes of JSON "
          f"[{card}]", flush=True)

    # -- the requests: the largest HTTP groups of phase 3d's set, published
    ok = [k for k, sel in groups.items() if k[0] in resources and len(sel) >= 32
          and proxy.lookup(*k, ingress=True).parser == "http"]
    chosen = sorted(ok, key=lambda k: (-len(groups[k]), k))[:EXTERNAL_GROUPS]
    picks = {k: groups[k][:EXTERNAL_GROUP_REQS] for k in chosen}
    n_http = sum(len(v) for v in picks.values())
    if n_http < 1024:
        fail(f"external proxy: only {n_http} requests in {len(chosen)} published groups")
    counts = collections.Counter(reqs_d[i].src_identity for v in picks.values() for i in v)
    mapped = sorted(counts, key=lambda s: (-counts[s], s))[:EXTERNAL_ALIASES]
    alias_of = {s: external_alias(k) for k, s in enumerate(mapped)}
    port_of = {k: proxy.lookup(*k, ingress=True).proxy_port for k in chosen}
    # each request as the child sees it: its source alias and the identity
    # NPHDS gives that alias; an identity past the mapped ones, and every
    # 16th request, comes from the unmapped alias
    plan = []  # (group, alias, HTTPRequest)
    for k in chosen:
        for n, i in enumerate(picks[k]):
            q = reqs_d[i]
            alias = EXTERNAL_UNMAPPED if n % 16 == 15 else alias_of.get(q.src_identity,
                                                                         EXTERNAL_UNMAPPED)
            ident = q.src_identity if alias != EXTERNAL_UNMAPPED else ID_WORLD
            plan.append((k, alias, HTTPRequest(method=q.method, path=q.path, src_identity=ident)))
    n_unmapped = sum(a == EXTERNAL_UNMAPPED for _, a, _ in plan)
    n_long = sum(len(q.path) > 256 for _, _, q in plan)
    if not n_unmapped or not n_long:
        fail(f"external proxy: {n_unmapped} requests from the unmapped alias, {n_long} paths "
             "past 256 bytes")
    # Kafka produce frames of 32 and 33 topics to the world's Kafka redirect
    topic_sets = [[f"t{i}" for i in range(32)], [f"t{i}" for i in range(33)],
                  [f"t{i}" for i in range(16, 48)], [f"t{i}" for i in range(31, -1, -1)]]
    kplan = []  # (alias, identity, cid, topics)
    for a, (alias, ident) in enumerate(((external_alias(0), mapped[0]),
                                        (EXTERNAL_UNMAPPED, ID_WORLD))):
        for j, topics in enumerate(topic_sets):
            kplan.append((alias, ident, 100 + 10 * a + j, topics))

    # -- what the card decides: check_batch per group, L7DeviceBatch off, then on
    def card_verdicts(policy_of):
        """→ (HTTP verdicts in plan order, Kafka verdicts) with
        L7DeviceBatch off, held equal to on, and {on: (seconds, launch
        delta)}. The oracle's launches: uncounted."""
        out, deltas = {}, {}
        for on in (False, True):
            with uncounted():
                l7rt.set_device_batch(on)
                before = _kernels.launches()
                t0 = time.perf_counter()
                v = np.zeros(len(plan), bool)
                for k in chosen:
                    idx = [j for j, (g, _, _) in enumerate(plan) if g == k]
                    v[idx] = policy_of(k).check_batch([plan[j][2] for j in idx])
                kv = [bool(np.asarray(kafka_rd.kafka_acl.check_batch(
                    [KafkaRequest(api_key=0, api_version=0, client_id="c", topic=t,
                                  src_identity=ident) for t in topics])).all())
                    for _, ident, _, topics in kplan]
                torch.cuda.synchronize()
                deltas[on] = (time.perf_counter() - t0, launch_delta(before))
                out[on] = (v, kv)
        l7rt.set_device_batch(False)
        if not (np.array_equal(out[False][0], out[True][0]) and out[False][1] == out[True][1]):
            fail("external proxy: the card's check_batch differs with L7DeviceBatch off and on")
        return out[False], deltas

    def print_card(what, deltas):
        for on, (s, d) in deltas.items():
            print(f"external proxy [{what}]: the card's check_batch of {len(plan)} HTTP requests "
                  f"in {len(chosen)} groups and {len(kplan)} Kafka frames' topics, L7DeviceBatch "
                  f"{'on' if on else 'off'}: {s * 1e3!r} ms, the oracle's launches {d} "
                  f"(uncounted) [{card}]", flush=True)

    want, deltas = card_verdicts(lambda k: proxy.lookup(*k, ingress=True).http_policy)
    print_card("before the swap", deltas)
    if want[0].all() or not want[0].any():
        fail("external proxy: the card allows all or none of the requests")
    if all(want[1]) or not any(want[1]):
        fail("external proxy: the card acks all or none of the Kafka frames")

    tmp = tempfile.mkdtemp(prefix="cilium-xds-")
    xds_path, al_path = os.path.join(tmp, "xds.sock"), os.path.join(tmp, "accesslog.sock")
    if len(al_path) > 100:
        fail(f"external proxy: the socket path {al_path} is too long for a unix socket")
    cache = ResourceCache()
    srv = XDSServer(cache, xds_path)
    srv.start()
    sink = AccessLogServer(capacity=1 << 16)
    records = []
    sink.subscribe(records.append)
    rx = AccessLogSocketServer(sink, al_path).start()
    launcher = None
    try:
        def waited(what, done, timeout=EXTERNAL_WAIT_S):
            t0 = time.perf_counter()
            while not done():
                if time.perf_counter() - t0 > timeout:
                    fail(f"external proxy: {what} did not come within {timeout:.0f}s")
                time.sleep(0.002)
            return time.perf_counter() - t0

        def ack_wait(type_url, version):
            """A WaitGroup that the ACK of ``version`` completes."""
            wg = WaitGroup()
            srv.wait_for_ack(type_url, version, node, wg.add())
            return wg

        def acked(what, wg):
            if not wg.wait(timeout=EXTERNAL_WAIT_S):
                fail(f"external proxy: no ACK of {what}")

        # -- the child, on the card: published first, then spawn to the ACKs
        for ep, res in resources.items():
            v_npds = cache.upsert(NETWORK_POLICY_TYPE, str(ep), res)
        for s in mapped:
            v_nphds = cache.upsert(NETWORK_POLICY_HOSTS_TYPE, str(s), {
                "policy": int(s), "host_addresses": [f"{alias_of[s]}/32"]})
        wg_npds = ack_wait(NETWORK_POLICY_TYPE, v_npds)
        wg_nphds = ack_wait(NETWORK_POLICY_HOSTS_TYPE, v_nphds)
        t0 = time.perf_counter()
        launcher = ProxyLauncher(xds_path, al_path, restart_backoff_s=0.1).start()
        acked(f"NPDS version {v_npds}", wg_npds)
        t_npds = time.perf_counter() - t0
        acked(f"NPHDS version {v_nphds}", wg_nphds)
        t_both = time.perf_counter() - t0
        print(f"external proxy: the child (ProxyLauncher, no --device: the card) spawn to the "
              f"ACK of {len(resources)} NPDS resources published before it (version {v_npds}) "
              f"{t_npds!r}s, to that of {len(mapped)} NPHDS rows (version {v_nphds}) {t_both!r}s "
              f"[{card}]", flush=True)

        def run_round(what, want):
            """Every request and frame through the child; its answers ==
            the card's ``want``; one record each."""
            start = len(records)
            sessions = collections.defaultdict(list)
            for j, (k, alias, q) in enumerate(plan):
                sessions[(alias, port_of[k])].append(j)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(EXTERNAL_THREADS) as pool:
                futs = {key: pool.submit(http_session, key[0], key[1],
                                         [(plan[j][2].method, plan[j][2].path) for j in idx])
                        for key, idx in sessions.items()}
                kfuts = {alias: pool.submit(kafka_session, alias, kafka_rd.proxy_port,
                                            [(cid, produce_frame("c", topics, cid))
                                             for a, _, cid, topics in kplan if a == alias])
                         for alias in {a for a, _, _, _ in kplan}}
                got = np.zeros(len(plan), bool)
                rates = []
                for key, fut in futs.items():
                    codes, secs = fut.result()
                    if set(codes) - {200, 403}:
                        fail(f"external proxy [{what}]: statuses {sorted(set(codes))}")
                    got[sessions[key]] = np.array(codes) == 200
                    rates.append(len(codes) / secs)
                kres = {}
                for alias, fut in kfuts.items():
                    kres.update(zip([cid for a, _, cid, _ in kplan if a == alias], fut.result()))
                kgot = [kres[cid] for _, _, cid, _ in kplan]
            wall = time.perf_counter() - t0
            bad = np.nonzero(got != want[0])[0]
            if bad.size:
                k, alias, q = plan[int(bad[0])]
                fail(f"external proxy [{what}]: {bad.size} of {len(plan)} answers differ from the "
                     f"card's, first {q.method} {q.path[:64]} from {alias} (identity "
                     f"{q.src_identity}) to {k}: child {bool(got[bad[0]])}, card "
                     f"{bool(want[0][bad[0]])}")
            if kgot != want[1]:
                fail(f"external proxy [{what}]: Kafka answers {kgot} != the card's {want[1]}")
            n_want = len(plan) + len(kplan)
            waited(f"{n_want} access-log records [{what}]", lambda: len(records) - start >= n_want)
            recs = records[start:]
            if len(recs) != n_want:
                fail(f"external proxy [{what}]: {len(recs)} records for {n_want} requests")
            have = collections.Counter(
                (x.src_identity, x.dst_port, x.http["method"], x.http["path"], x.verdict)
                if x.proto == "http" else (x.src_identity, x.dst_port, x.kafka["topic"], x.verdict)
                for x in recs)
            need = collections.Counter(
                (q.src_identity, k[1], q.method, q.path, "Forwarded" if w else "Denied")
                for (k, _, q), w in zip(plan, want[0]))
            need.update((ident, kafka_rd.dst_port, topics[0], "Forwarded" if w else "Denied")
                        for (_, ident, _, topics), w in zip(kplan, want[1]))
            if have != need:
                fail(f"external proxy [{what}]: the records differ from the requests and verdicts "
                     f"({sum((have - need).values())} unmatched)")
            rates.sort()
            print(f"external proxy [{what}]: {len(plan)} HTTP/1.1 requests ({n_unmapped} from the "
                  f"unmapped alias, {n_long} paths past 256 bytes) over {len(sessions)} keep-alive "
                  f"connections and {len(kplan)} Kafka produce frames of 32-33 topics in "
                  f"{wall!r}s ({EXTERNAL_THREADS} at once): {int(got.sum())} 200 / "
                  f"{int((~got).sum())} 403, Kafka acks {kgot}, == the card's check_batch; "
                  f"requests/s per connection p50 {rates[len(rates) // 2]!r} min {rates[0]!r} "
                  f"max {rates[-1]!r}; {len(recs)} records, one per request, verdicts == [{card}]",
                  flush=True)

        run_round("first push", want)

        # -- a policy swap: one endpoint's resource with one rule removed
        # (of a redirect that keeps one: an empty rule list allows all),
        # the rule that alone allows most of its group's requests
        def matching(pol, j):
            """The indices of the rules of ``pol`` that allow request j."""
            q = plan[j][2]
            return tuple(m for m, cr in enumerate(pol._rules)
                         if cr.rule.matches(q.method, q.path, q.host)
                         and (cr.allowed_identities is None
                              or q.src_identity in cr.allowed_identities))

        swaps = []
        for k in chosen:
            pol = proxy.lookup(*k, ingress=True).http_policy
            alone = collections.Counter(matching(pol, j) for j, (g, _, _) in enumerate(plan)
                                        if g == k)
            if len(pol._rules) >= 2:
                swaps += [(alone[(m,)], k, m) for m in range(len(pol._rules))]
        if not swaps or max(swaps)[0] <= 0:
            fail("external proxy: no rule of a chosen redirect alone allows one of its requests")
        _, k_swap, drop = max(swaps, key=lambda t: (t[0], -chosen.index(t[1]), -t[2]))
        idx = [j for j, (g, _, _) in enumerate(plan) if g == k_swap]
        res = json.loads(json.dumps(resources[k_swap[0]]))
        entry = next(p for p in res["l7_ports"] if p["port"] == k_swap[1] and p["ingress"])
        removed = entry["http_rules"].pop(drop)
        with uncounted():  # the oracle's policy
            swapped = HTTPPolicy.from_model(entry["http_rules"])
        want2, deltas2 = card_verdicts(lambda k: swapped if k == k_swap
                                       else proxy.lookup(*k, ingress=True).http_policy)
        print_card("after the swap", deltas2)
        flips = want[0] & ~want2[0]
        if not flips.any() or (~want[0] & want2[0]).any() or flips[
                [j for j in range(len(plan)) if j not in set(idx)]].any():
            fail(f"external proxy: removing rule {removed} flips {int(flips.sum())} requests")
        t0 = time.perf_counter()
        v_swap = cache.upsert(NETWORK_POLICY_TYPE, str(k_swap[0]), res)
        acked(f"NPDS version {v_swap}", ack_wait(NETWORK_POLICY_TYPE, v_swap))
        t_swap = time.perf_counter() - t0
        print(f"external proxy: swap of endpoint {k_swap[0]}'s resource without rule {removed} "
              f"(version {v_swap}): push to ACK {t_swap * 1e3!r} ms; {int(flips.sum())} of its "
              f"{len(idx)} requests flip to 403 on the card [{card}]", flush=True)
        run_round("after the swap", want2)

        # -- a kill: the launcher restarts the child, which resubscribes
        pid = launcher.pid()
        # the probe: a request that the card allows for its mapped identity
        # and no rule allows for the world's
        j0 = next((j for j in idx if want2[0][j] and plan[j][1] != EXTERNAL_UNMAPPED
                   and all(cr.allowed_identities is not None
                           and ID_WORLD not in cr.allowed_identities
                           for m, cr in enumerate(swapped._rules) if m in matching(swapped, j))),
                  None)
        if j0 is None:
            fail("external proxy: no request of the swapped group tells a mapped source from "
                 "the world")
        k0, alias0, q0 = plan[j0]
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        waited("the restarted child", lambda: launcher.pid() not in (None, pid))
        served = []

        def probe():
            # the first request this child answers 200 (it needs both its
            # NPDS listener and its NPHDS identity); each answer is logged
            try:
                served.append(http_session(alias0, port_of[k0], [(q0.method, q0.path)])[0][0])
            except OSError:
                return False
            return served[-1] == 200

        def listening():
            # every listener of the round bound (an empty connection
            # is served nothing and logged nothing)
            for port in {*port_of.values(), kafka_rd.proxy_port}:
                try:
                    socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
                except OSError:
                    return False
            return True

        n_before = len(records)
        waited("the restarted child's first served request", probe)
        t_served = time.perf_counter() - t_kill
        waited("the restarted child's listeners", listening)
        waited("the probes' records", lambda: len(records) - n_before >= len(served))
        if launcher.restarts != 1:
            fail(f"external proxy: {launcher.restarts} restarts after one kill")
        print(f"external proxy: SIGKILL of the child: restarts {launcher.restarts}, kill to the "
              f"first served request {t_served!r}s ({len(served)} probes) [{card}]", flush=True)
        run_round("after the restart", want2)
    finally:
        if launcher is not None:
            launcher.stop()
        rx.stop()
        srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    wall = time.perf_counter() - t_phase
    print(f"external proxy: phase in {wall:.2f}s (limit {EXTERNAL_PHASE_LIMIT_S:.0f}s) [{card}]",
          flush=True)
    if wall > EXTERNAL_PHASE_LIMIT_S:
        fail(f"external proxy: phase in {wall:.2f}s, over its {EXTERNAL_PHASE_LIMIT_S:.0f}s limit")


WORKLOADS_PHASE_LIMIT_S = 20.0
WL_PODS = 110  # containers the node's runtime lists: kubelet's default --max-pods
WL_IGNORED = 4  # of them carry workloads.IGNORE_LABEL (no endpoint)
WL_POD_CIDR = "10.244.3.0/24"  # a node CIDR: kube-controller-manager's --node-cidr-mask-size, 24
WL_DEBOUNCE_S = 6.0  # both stand-ins' regen_debounce (daemon.py:236-250)
WL_FRAMES = 1 << 16
WL_CHURN = 10  # containers that exit before the churn sweep
WL_DOCKER_FRAMES = 4096
WL_VETH_SENDS = 5  # datagrams each veth client sends (test_cni_wire.py)
WL_WAIT_S = 15.0  # the most a READY, a restart or a sniffed flow may take


class WorkloadAgent(K8sAgent):
    """Phase 3t's stand-in for the Daemon (A7c) that CNI, the Docker
    plugin and the workload watcher drive: K8sAgent's repository,
    registry, ipcache and engine (``world`` lends the first three), and
    what daemon.py builds for these modules and they call: ``ipam``, a
    real IPAM over the pod CIDR; ``endpoint_manager``, real Endpoints;
    a DatapathPipeline with a PreFilter, ``conntrack=`` a FlowConntrack
    and ``lb=`` the ServiceManager (daemon.py:114-124). endpoint_add /
    endpoint_delete / endpoint_list do what daemon.py:506-585 does; a
    regeneration is EndpointManager.regenerate_all (daemon.py:786),
    folded on a utils.trigger.Trigger when ``regen_debounce`` > 0
    (daemon.py:236-250). ``regenerations`` keeps the reason of each one
    run; settle() waits until they cover every ask and re-raises an
    error one met (the Trigger's loop swallows it)."""

    def __init__(self, pod_cidr: str, device=None, regen_debounce: float = 0.0, world=None):
        import threading

        from cilium_tpu_torch.datapath.conntrack import FlowConntrack
        from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
        from cilium_tpu_torch.endpoint import EndpointManager
        from cilium_tpu_torch.ipam import IPAM
        from cilium_tpu_torch.ipcache.prefilter import PreFilter
        from cilium_tpu_torch.utils.trigger import Trigger

        super().__init__("", pod_cidr, device=device, world=world)
        self.ipam = IPAM(pod_cidr)
        self.endpoint_manager = EndpointManager()
        self.prefilter = PreFilter()
        self.conntrack = FlowConntrack()
        self.pipeline = DatapathPipeline(self.engine, self.ipcache, self.prefilter,
                                         conntrack=self.conntrack, lb=self.services,
                                         device=device)
        self._lock = threading.RLock()
        self.regenerations, self.regen_errors, self._covered = [], [], 0
        self._regen_trigger = None
        if regen_debounce > 0:
            self._regen_trigger = Trigger(
                lambda reasons: self._regenerate_now("; ".join(reasons) or "debounced",
                                                     len(reasons)),
                min_interval=regen_debounce, name="fleet-regeneration")

    def _regenerate(self, reason: str) -> None:
        self.asks.append(reason)
        if self._regen_trigger is not None:
            self._regen_trigger.trigger(reason)
            return
        self._regenerate_now(reason, 1)

    def _regenerate_now(self, reason: str, n_asks: int) -> None:
        try:
            self.endpoint_manager.regenerate_all(self.pipeline, reason)
        except BaseException as e:
            self.regen_errors.append(e)
            raise
        finally:
            self.regenerations.append(reason)
            self._covered += n_asks

    def settle(self, what: str) -> None:
        deadline = time.monotonic() + 4 * WORKLOADS_PHASE_LIMIT_S
        while self._covered < len(self.asks):
            if time.monotonic() > deadline:
                fail(f"workloads: {what}: the regenerations did not settle")
            time.sleep(0.005)
        if self.regen_errors:
            raise self.regen_errors[0]

    def _sync_pipeline_endpoints(self) -> None:
        eps = self.endpoint_manager.endpoints()
        self.pipeline.set_endpoints([(ep.id, ep.identity.id) for ep in eps if ep.identity])

    def endpoint_add(self, endpoint_id: int, labels, *, ipv4=None, ipv6=None,
                     pod_name: str = "") -> dict:
        from cilium_tpu_torch.endpoint import Endpoint, EndpointState
        from cilium_tpu_torch.ipcache.ipcache import SOURCE_AGENT
        from cilium_tpu_torch.labels import parse_label_array

        with self._lock:
            if self.endpoint_manager.lookup(endpoint_id) is not None:
                raise ValueError(f"endpoint {endpoint_id} exists")
            lbls = parse_label_array(labels)
            ep = Endpoint(endpoint_id, lbls, ipv4=ipv4, ipv6=ipv6, pod_name=pod_name)
            ep.set_state(EndpointState.WAITING_FOR_IDENTITY)
            ep.identity = self.registry.allocate(lbls)
            ep.set_state(EndpointState.READY)
            self.endpoint_manager.insert(ep)
            if ipv4:
                self.ipcache.upsert(f"{ipv4}/32", ep.identity.id, source=SOURCE_AGENT)
            if ipv6:
                self.ipcache.upsert(f"{ipv6}/128", ep.identity.id, source=SOURCE_AGENT)
            self._sync_pipeline_endpoints()
            self._regenerate("endpoint created")
        return self._endpoint_model(ep)

    def endpoint_delete(self, endpoint_id: int) -> bool:
        from cilium_tpu_torch.ipcache.ipcache import SOURCE_AGENT

        with self._lock:
            ep = self.endpoint_manager.lookup(endpoint_id)
            if ep is None:
                return False
            self.endpoint_manager.remove(ep)
            if ep.ipv4:
                self.ipcache.delete(f"{ep.ipv4}/32", SOURCE_AGENT)
                self.ipam.release(ep.ipv4)
            if ep.ipv6:
                self.ipcache.delete(f"{ep.ipv6}/128", SOURCE_AGENT)
            if ep.identity is not None:
                self.registry.release(ep.identity)
            self._sync_pipeline_endpoints()
            self._regenerate("endpoint deleted")
        return True

    def endpoint_list(self) -> list:
        return [self._endpoint_model(ep) for ep in self.endpoint_manager.endpoints()]

    @staticmethod
    def _endpoint_model(ep) -> dict:
        return {"id": ep.id, "labels": list(ep.labels.to_strings()),
                "identity": ep.identity.id if ep.identity else None, "ipv4": ep.ipv4,
                "ipv6": ep.ipv6, "state": str(ep.state.value),
                "policy_revision": ep.policy_revision}

    def shutdown(self) -> None:
        if self._regen_trigger is not None:
            self._regen_trigger.shutdown()
        self.endpoint_manager.shutdown()


class WireLanes:
    """Keeps each pipeline call's lanes (endpoint index, verdict,
    redirect) and each conntrack pre-pass's established hits."""

    def __init__(self, agent):
        from cilium_tpu_torch.datapath.conntrack import CT_ESTABLISHED

        self.calls, self.established = [], []
        process, lookup = agent.pipeline.process, agent.conntrack.lookup_batch

        def recorded_process(*a, **k):
            v, red = process(*a, **k)
            self.calls.append((a[1].copy(), v.copy(), red.copy()))
            return v, red

        def recorded_lookup(*a, **k):
            out = lookup(*a, **k)
            self.established.append(int((out[0] == CT_ESTABLISHED).sum()))
            return out

        agent.pipeline.process = recorded_process
        agent.conntrack.lookup_batch = recorded_lookup


def wl_world_peers(idents, labels_of):
    """A fresh registry and ipcache holding build_world's identities and
    their addresses, allocated in the same order, so their ids are the
    world's."""
    from cilium_tpu_torch.identity import IdentityRegistry
    from cilium_tpu_torch.labels import parse_label_array

    reg = IdentityRegistry()
    for ident in idents:
        if reg.allocate(parse_label_array(labels_of[ident.id])).id != ident.id:
            fail("workloads: a world identity took another id")
    return reg, bench_ipcache(idents)


def wl_frame(src: int, dst: int, proto: int, sport: int, dport: int, vlan=None, frag: int = 0,
             ethertype: int = 0x0800) -> bytes:
    """An Ethernet frame (802.1Q-tagged with ``vlan``) carrying an IPv4
    packet with its L4 ports and 8 payload bytes."""
    import struct

    l2 = b"\x02\x00\x00\x00\x00\x01\x02\x00\x00\x00\x00\x02" + (
        struct.pack(">HHH", 0x8100, vlan, ethertype) if vlan is not None
        else struct.pack(">H", ethertype))
    body = struct.pack(">HHI", sport, dport, 0x00100000) + b"payload!"
    return l2 + struct.pack(">BBHHHBBHII", 0x45, 0, 20 + len(body), 7, frag, 64, proto, 0,
                            src, dst) + body


def wl_frames(seed: int, srcs, dsts, n: int):
    """``n`` frames from the seed: sources and destinations drawn from
    ``srcs`` / ``dsts``, ports from the world's L4 ports (53 UDP, the
    rest mostly TCP), 1/8 802.1Q-tagged, 1/32 non-first fragments (ports
    0), 1/64 truncated inside the IP header and 1/64 not IPv4 (both
    parse to None)."""
    import numpy as np

    rng = np.random.default_rng(seed + 28)
    src = np.asarray(srcs, np.uint32)[rng.integers(0, len(srcs), n)]
    dst = np.asarray(dsts, np.uint32)[rng.integers(0, len(dsts), n)]
    dport = rng.choice(np.array([80, 443, 8080, 53, 5432, 22, 9053]), n)
    proto = np.where((dport == 53) | (rng.random(n) < 0.1), 17, 6)
    sport = rng.integers(1024, 65536, n)
    kind = rng.random(n)
    vlan = np.where(rng.random(n) < 1 / 8, rng.integers(1, 4095, n), -1)
    out = []
    for i in range(n):
        k = kind[i]
        f = wl_frame(int(src[i]), int(dst[i]), int(proto[i]), int(sport[i]), int(dport[i]),
                     vlan=None if vlan[i] < 0 else int(vlan[i]),
                     frag=int(1 + (i % 0x1FFF)) if k < 1 / 32 else 0,
                     ethertype=0x86DD if 1 / 32 <= k < 1 / 32 + 1 / 64 else 0x0800)
        if 1 / 32 + 1 / 64 <= k < 1 / 32 + 1 / 32:
            f = f[:14 + (4 if vlan[i] >= 0 else 0) + int(k * 1e6) % 20]
        out.append(f)
    return out


def wl_docker_call(sock_path: str, method: str, body=None) -> dict:
    """One libnetwork plugin call: POST /<Driver>.<Method> over the unix socket."""
    import http.client

    class Conn(http.client.HTTPConnection):
        def connect(self):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.connect(sock_path)

    c = Conn("localhost", timeout=30)
    try:
        c.request("POST", f"/{method}", body=json.dumps(body or {}),
                  headers={"Content-Type": "application/json"})
        return json.loads(c.getresponse().read().decode())
    finally:
        c.close()


def wl_wait(what: str, done, timeout: float = WL_WAIT_S) -> float:
    """Polls ``done`` (OSError counts as not yet) → the seconds it took."""
    t0 = time.perf_counter()
    while True:
        try:
            if done():
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
            fail(f"workloads: {what} did not come within {timeout:.0f}s")
        time.sleep(0.01)


def wl_docker_join(sock: str, seed: int) -> dict:
    """The libnetwork sequence of one container up to Join (Activate,
    RequestPool, RequestAddress, CreateNetwork, CreateEndpoint, Join) →
    its replies, address, endpoint id and libnetwork ids."""
    import hashlib

    out = {"activate": wl_docker_call(sock, "Plugin.Activate"),
           "pool": wl_docker_call(sock, "IpamDriver.RequestPool", {"AddressSpace": "CiliumLocal"})}
    out["addr"] = wl_docker_call(sock, "IpamDriver.RequestAddress",
                                 {"PoolID": out["pool"]["PoolID"]})
    out["ip"] = out["addr"]["Address"].split("/")[0]
    out["eid"] = hashlib.sha256(f"docker-{seed}".encode()).hexdigest()
    for m, b in (("NetworkDriver.CreateNetwork", {"NetworkID": "net1"}),
                 ("NetworkDriver.CreateEndpoint",
                  {"NetworkID": "net1", "EndpointID": out["eid"],
                   "Interface": {"Address": out["addr"]["Address"]}}),
                 ("NetworkDriver.Join", {"NetworkID": "net1", "EndpointID": out["eid"],
                                         "SandboxKey": "/proc/1/ns/net"})):
        out[m] = wl_docker_call(sock, m, b)
        if "Err" in out[m]:
            fail(f"workloads: docker {m}: {out[m]['Err']}")
    out["ep_id"] = wl_docker_call(sock, "NetworkDriver.EndpointOperInfo",
                                  {"EndpointID": out["eid"]})["Value"]["ep_id"]
    return out


def wl_docker_leave(sock: str, dk: dict) -> list:
    """Leave, DeleteEndpoint and ReleaseAddress → their replies."""
    out = []
    for m, b in (("NetworkDriver.Leave", {"NetworkID": "net1", "EndpointID": dk["eid"]}),
                 ("NetworkDriver.DeleteEndpoint", {"EndpointID": dk["eid"]}),
                 ("IpamDriver.ReleaseAddress", {"PoolID": dk["pool"]["PoolID"],
                                                "Address": dk["addr"]["Address"]})):
        out.append(wl_docker_call(sock, m, b))
        if "Err" in out[-1]:
            fail(f"workloads: docker {m}: {out[-1]['Err']}")
    return out


def wl_veth_apps(repo):
    """(web, client, other): world apps such that an L3 rule (no port)
    lets client reach web and no rule lets other reach it."""
    l3_peers, any_peers = {}, {}
    for r in repo.rules:
        subj = r.endpoint_selector.match_labels[0][1]
        for ing in r.ingress:
            for sel in ing.from_endpoints:
                any_peers.setdefault(subj, set()).add(sel.match_labels[0][1])
                if not ing.to_ports:
                    l3_peers.setdefault(subj, set()).add(sel.match_labels[0][1])
    web = min(a for a in l3_peers if a not in l3_peers[a])
    other = next(f"a{k}" for k in range(N_APPS) if f"a{k}" not in any_peers[web] | {web})
    return web, min(l3_peers[web]), other


def workloads_main_path(seed: int, card: str, dev=None):
    """Phase 3t: workload runtimes and health (A9b5 + A9b6) on the card.
    A node at kubelet's defaults: the bench world's 10 000 rules (their
    selectors in the any: source, which also selects the container: labels
    the workload watcher gives a container), its 2 048 identities as peers
    in the ipcache, a /24 pod CIDR and WL_PODS containers, behind two
    WorkloadAgents (the Daemon's stand-in), one on the card and one with
    the plain versions (device="cpu"), each with regen_debounce
    WL_DEBOUNCE_S: a regeneration runs at once when none ran in the last
    WL_DEBOUNCE_S, else when that window ends, covering every ask since.
    1. Boot, inside one window per stand-in: the policy import's
       regeneration (no endpoint yet), the policy compiled (refresh +
       rebuild), a DockerPlugin on a unix socket up to Join, where netns
       is allowed three veth containers (web / client / other: in network
       namespaces behind real veths on the card stand-in, the same
       containers plumbed virtually on the plain one), and one
       runtimes.PLEGPoller.poll_once sweep of an in-process runtime
       listing WL_PODS containers (apps drawn from the world's,
       WL_IGNORED with IGNORE_LABEL): all of it folds into one
       regeneration. The health leg (wl_health_leg) runs in the window.
       (The CRI gRPC adapter is held in the CPU tests only.)
    2. Wire: WL_DOCKER_FRAMES frames to the Docker endpoint; where netns
       is allowed, WL_VETH_SENDS real UDP datagrams from client and from
       other to web, sniffed off their host veths (VethSniffer,
       WireEnforcer.run_from on the card) and replayed on the plain
       stand-in; WL_FRAMES frames from the seed (world and unmapped
       sources, endpoint and non-local destinations, 802.1Q, fragments,
       truncated and non-IPv4 frames) through parse_ipv4_frame and
       WireEnforcer.process_flows, then again (the host CT pre-pass
       answers the forwarded flows).
    3. Churn, inside the next window: WL_CHURN containers exit (one
       sweep), the Docker container leaves (Leave, DeleteEndpoint,
       ReleaseAddress), the veth containers go; the same flows again.
    Checks: equal endpoints, addresses, identities and IPAM occupancy on
    both stand-ins, each window's asks folded; every wire batch's flows
    enforced, per-endpoint verdict counts and lanes equal to the plain
    stand-in's; FORWARD and DROP_POLICY both occur; the replay's
    established hits are pass 1's forwarded lanes; the Docker endpoint's
    flows all drop (no rule selects its label: the host oracle allows no
    peer); the veth client forwarded and the other dropped; after the
    churn the exited containers' addresses are free, only surviving
    endpoints' flows are enforced and every lane's index is its
    endpoint's. The caller set the launch counts to 0; the phase fails
    past WORKLOADS_PHASE_LIMIT_S."""
    import dataclasses as dc
    import hashlib
    import os
    import shutil
    import tempfile
    import uuid

    import numpy as np

    from cilium_tpu_torch.datapath.pipeline import DROP_POLICY, FORWARD
    from cilium_tpu_torch.datapath.wire import WireEnforcer, parse_ipv4_frame
    from cilium_tpu_torch.plugins import netns as nsmod
    from cilium_tpu_torch.plugins.cni import cni_add, cni_del, endpoint_id_for, host_ifname
    from cilium_tpu_torch.plugins.docker import DockerPlugin
    from cilium_tpu_torch.runtimes import PLEGPoller
    from cilium_tpu_torch.workloads import IGNORE_LABEL, ContainerInfo, WorkloadWatcher

    t_phase = time.perf_counter()
    repo, _reg, _cache, idents, labels_of = build_world(seed, source="any")
    agents = {name: WorkloadAgent(WL_POD_CIDR, device=d, regen_debounce=WL_DEBOUNCE_S,
                                  world=(repo, *wl_world_peers(idents, labels_of)))
              for name, d in (("card", dev), ("plain", "cpu"))}
    card_agent = agents["card"]
    want_dev = "cuda" if dev is None else str(dev)
    if (card_agent.pipeline.device.type, card_agent.engine.device.type) != (want_dev, want_dev):
        fail(f"workloads: the card stand-in's pipeline is on {card_agent.pipeline.device}")
    print(f"workloads: world ({len(repo.rules)} rules, {len(idents)} identities) and two "
          f"stand-ins in {time.perf_counter() - t_phase:.2f}s [{card}]", flush=True)
    rng = random.Random(seed + 28)
    ignored = set(rng.sample(range(WL_PODS), WL_IGNORED))
    live = []
    for k in range(WL_PODS):
        labels = ({IGNORE_LABEL: "true"} if k in ignored else
                  {"app": f"a{rng.randrange(N_APPS)}", "io.kubernetes.pod.name": f"pod-{k}",
                   "io.kubernetes.pod.namespace": "default"})
        live.append(ContainerInfo(id=hashlib.sha256(f"pod-{seed}-{k}".encode()).hexdigest(),
                                  name=f"pod-{k}", labels=labels))

    class Runtime:
        def containers(self):
            return list(live)

    runtime = Runtime()
    watchers = {name: WorkloadWatcher(agent, runtime) for name, agent in agents.items()}
    lanes = {name: WireLanes(agent) for name, agent in agents.items()}

    def enforce(what: str, flows, dst_map, want_n=None):
        """One batch of ``flows`` through a WireEnforcer on each stand-in;
        the card's flows enforced, counts and lanes must equal the plain
        stand-in's → (n, counts, the card's pipeline calls)."""
        res = {}
        for name, agent in agents.items():
            enf = WireEnforcer(agent.pipeline, dst_map)
            n_calls = len(lanes[name].calls)
            t0 = time.perf_counter()
            n = enf.process_flows(flows)
            res[name] = (n, enf.verdicts, lanes[name].calls[n_calls:], time.perf_counter() - t0)
        (n, counts, calls, wall), (pn, pcounts, pcalls, pwall) = res["card"], res["plain"]
        if n != pn or counts != pcounts:
            fail(f"workloads: {what}: the card enforced {n} flows, the plain stand-in {pn}, "
                 f"or their per-endpoint counts differ")
        if len(calls) != len(pcalls) or any(
                not all(np.array_equal(x, y) for x, y in zip(a, b)) for a, b in zip(calls, pcalls)):
            fail(f"workloads: {what}: the pipeline call's lanes differ from the plain stand-in's")
        if want_n is not None and n != want_n:
            fail(f"workloads: {what}: {n} flows enforced, {want_n} expected")
        total = collections_counter(np.concatenate([c[1] for c in calls]) if calls else [])
        print(f"workloads: {what}: {n} of {len(flows)} flows enforced on {len(counts)} endpoints "
              f"in {wall!r}s (plain {pwall!r}s), verdicts {total}, == the plain stand-in's "
              f"(counts and lanes) [{card}]", flush=True)
        return n, counts, calls

    tmp = tempfile.mkdtemp(prefix="ctpu-wl-")
    plugins, veth = {}, {}
    try:
        # -- 1. boot, inside one debounce window a stand-in -----------------
        before = launch_delta({})
        t_boot = time.perf_counter()
        for agent in agents.values():
            agent._regenerate("policy import")
        compile_s = {}
        for name, agent in agents.items():
            t0 = time.perf_counter()
            agent.engine.refresh()
            agent.pipeline.rebuild()
            compile_s[name] = time.perf_counter() - t0
        docker = {}
        for name, agent in agents.items():
            plugins[name] = DockerPlugin(agent, os.path.join(tmp, f"docker-{name}.sock")).start()
            docker[name] = wl_docker_join(plugins[name].socket_path, seed)
        if docker["card"] != docker["plain"]:
            fail("workloads: the Docker plugin's replies differ between the stand-ins")
        dk = docker["card"]
        if nsmod.have_netns():
            web, client, other = wl_veth_apps(repo)
            tag = uuid.uuid4().hex[:8]
            for role, app in (("client", client), ("other", other), ("web", web)):
                cid = f"{role}-{tag}"
                ns = f"ctpu-{role[:2]}-{tag}"
                nsmod.create_netns(ns)
                veth[role] = {"cid": cid, "ns": ns, "app": app}
                for name, agent in agents.items():
                    veth[role][name] = cni_add(
                        agent, cid, labels=[f"container:app={app}", f"container:id={cid[:12]}"],
                        netns=ns if name == "card" else None)
        sweeps = {}
        for name in agents:
            t0 = time.perf_counter()
            changes = PLEGPoller(watchers[name], runtime, interval=3600).poll_once()
            sweeps[name] = (changes, time.perf_counter() - t0)
        asked_s = time.perf_counter() - t_boot
        extras = 1 + len(veth)
        # the frames, and the health leg, while the window runs
        booted = {name: [(ep.id, ep.ipv4, ep.identity.id) for ep in
                         agent.endpoint_manager.endpoints()] for name, agent in agents.items()}
        if booted["card"] != booted["plain"]:
            fail("workloads: the stand-ins' endpoints, addresses or identities differ")
        pod_ids = {watchers["card"].endpoint_of(c.id) for c in live} - {None}
        ep_ip = {ep_id: ip for ep_id, ip, _ in booted["card"] if ep_id in pod_ids}
        dst_map = {ip: ep_id for ep_id, ip in ep_ip.items()}
        world_srcs = [(10 << 24) | (((i >> 8) & 255) << 16) | ((i & 255) << 8) | 1
                      for i in range(len(idents))]
        world_set = set(world_srcs)
        unmapped = [int(ipaddress.IPv4Address("198.18.0.0")) + k for k in range(1, 129)]
        local = [int(ipaddress.IPv4Address(ip)) for ip in ep_ip.values()]
        remote = [int(ipaddress.IPv4Address("10.244.4.0")) + k for k in range(2, 30)]
        t0 = time.perf_counter()
        frames = wl_frames(seed, world_srcs * 8 + unmapped + local, local * 7 + remote, WL_FRAMES)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        flows = [t for t in map(parse_ipv4_frame, frames) if t is not None]
        parse_s = time.perf_counter() - t0
        dflows = [t for t in map(parse_ipv4_frame, wl_frames(
            seed + 1, world_srcs + unmapped, [int(ipaddress.IPv4Address(dk["ip"]))],
            WL_DOCKER_FRAMES)) if t is not None]
        wl_health_leg(tmp, card)
        for name, agent in agents.items():
            changes, sweep_s = sweeps[name]
            agent.settle(f"the {name} boot")
            n_eps = len(booted[name])
            print(f"workloads [{name}]: policy compiled in {compile_s[name]!r}s; boot sweep of "
                  f"{WL_PODS} containers ({WL_IGNORED} ignored): {changes} endpoints in "
                  f"{sweep_s!r}s, with the Docker and {len(veth)} veth containers {n_eps}; every "
                  f"ask within {asked_s!r}s of the policy import, settled "
                  f"{time.perf_counter() - t_boot!r}s after it in {len(agent.regenerations)} "
                  f"regenerations for {len(agent.asks)} asks (regen_debounce {WL_DEBOUNCE_S}s); "
                  f"IPAM {len(agent.ipam)} of {agent.ipam.capacity} [{card}]", flush=True)
            if changes != WL_PODS - WL_IGNORED or n_eps != changes + extras or \
                    len(agent.ipam) != n_eps:
                fail(f"workloads [{name}]: the sweep made {changes} endpoints, {n_eps} held, "
                     f"IPAM {len(agent.ipam)}")
            if any(watchers[name].endpoint_of(live[k].id) is not None for k in ignored):
                fail(f"workloads [{name}]: an ignored container has an endpoint")
            if not len(agent.regenerations) < len(agent.asks):
                fail(f"workloads [{name}]: {len(agent.regenerations)} regenerations for "
                     f"{len(agent.asks)} asks: nothing folded")
            if [e[0] for e in booted[name]] != agent.pipeline._endpoint_ids:
                fail(f"workloads [{name}]: the pipeline's endpoints are not the manager's")
        got = launch_delta(before)
        print(f"workloads: the boot's launches (the card stand-in's compile and regeneration): "
              f"K1 {got.get('selector_match', 0)}, K2 {got.get('bool_mm', 0)} [{card}]",
              flush=True)
        if not got.get("selector_match") or not got.get("bool_mm"):
            fail("workloads: the boot launched no K1 / K2")

        # -- 2. wire ----------------------------------------------------------
        ep = card_agent.endpoint_manager.lookup(dk["ep_id"])
        if ep is None or ep.ipv4 != dk["ip"] or card_agent.ipam.owner_of(dk["ip"]) != "docker":
            fail("workloads: docker Join registered no endpoint at its address")
        n, counts, _calls = enforce("docker endpoint (between Join and Leave)", dflows,
                                    {dk["ip"]: dk["ep_id"]}, want_n=len(dflows))
        _matched, selected = card_agent.repo.get_rules_matching(ep.labels)
        f0 = next(f for f in dflows if f[0] in world_set)
        peer = card_agent.ipcache.lookup_by_ip(str(ipaddress.IPv4Address(f0[0])))
        if selected or counts != {dk["ep_id"]: {int(DROP_POLICY): n}} or oracle_allows(
                card_agent.repo, card_agent.registry.get(peer.identity).labels, ep.labels,
                f0[4], f0[2]):
            fail(f"workloads: docker endpoint: verdicts {counts} (no rule selects it: every "
                 f"flow drops)")
        if veth:
            wl_veth_traffic(veth, agents, lanes, card)
        else:
            print(f"workloads [veth]: not run: plugins.netns.have_netns() is false on this "
                  f"host (no CAP_NET_ADMIN, or no iproute2 `ip netns`) [{card}]", flush=True)
        n_tagged = sum(1 for f in frames if len(f) >= 14 and f[12:14] == b"\x81\x00")
        local_set = set(local)
        to_local = sum(1 for f in flows if f[1] in local_set)
        print(f"workloads: {WL_FRAMES} frames built in {build_s!r}s, parsed in {parse_s!r}s: "
              f"{len(flows)} IPv4 tuples, {WL_FRAMES - len(flows)} not (truncated or not IPv4), "
              f"{n_tagged} 802.1Q, {sum(1 for f in flows if f[2] in (6, 17) and not f[4])} with "
              f"ports 0, {to_local} to endpoints [{card}]", flush=True)
        _n1, _c1, calls1 = enforce("pass 1", flows, dst_map, want_n=to_local)
        codes = {int(x) for c in calls1 for x in np.unique(c[1])}
        if not {int(FORWARD), int(DROP_POLICY)} <= codes:
            fail(f"workloads: pass 1's verdicts {sorted(codes)} lack FORWARD or DROP_POLICY")
        forwarded = sum(int(((c[1] == FORWARD) & ~c[2]).sum()) for c in calls1)
        enforce("replay", flows, dst_map, want_n=to_local)
        est = {name: lanes[name].established[-1] for name in agents}
        print(f"workloads: replay: established hits {est['card']} (plain {est['plain']}), pass 1 "
              f"forwarded {forwarded} [{card}]", flush=True)
        if est["card"] != forwarded or est["plain"] != forwarded:
            fail(f"workloads: the replay's established hits {est} are not pass 1's {forwarded} "
                 f"forwarded flows")

        # -- 3. churn, inside the next window ------------------------------------
        gone = [k for k in range(WL_PODS) if k not in ignored][:WL_CHURN]
        gone_ids = {watchers["card"].endpoint_of(live[k].id) for k in gone}
        for k in gone:
            live[k] = dc.replace(live[k], running=False)
        n_regen = {name: len(agent.regenerations) for name, agent in agents.items()}
        last_run = {name: agent._regen_trigger._last_run for name, agent in agents.items()}
        t_churn = time.perf_counter()
        for name in agents:
            sweeps[name] = PLEGPoller(watchers[name], runtime, interval=3600).poll_once()
        left = {name: wl_docker_leave(plugins[name].socket_path, docker[name]) for name in agents}
        if left["card"] != left["plain"]:
            fail("workloads: the Docker plugin's Leave replies differ between the stand-ins")
        for role, v in veth.items():
            for name, agent in agents.items():
                cni_del(agent, v["cid"])
        for name, agent in agents.items():
            agent.settle(f"the {name} churn")
            in_window = t_churn < last_run[name] + WL_DEBOUNCE_S
            n_eps = len(agent.endpoint_manager)
            print(f"workloads [{name}]: churn: {sweeps[name]} endpoints withdrawn by the sweep, "
                  f"the Docker and {len(veth)} veth containers gone, settled "
                  f"{time.perf_counter() - t_churn!r}s after the sweep in "
                  f"{len(agent.regenerations) - n_regen[name]} regenerations (the sweep "
                  f"{'inside' if in_window else 'after'} the boot regeneration's window); "
                  f"{n_eps} endpoints, IPAM {len(agent.ipam)} [{card}]", flush=True)
            if sweeps[name] != WL_CHURN or n_eps != WL_PODS - WL_IGNORED - WL_CHURN or \
                    len(agent.ipam) != n_eps or any(
                        agent.ipam.owner_of(ip) is not None for ip in
                        [ep_ip[i] for i in gone_ids] + [dk["ip"]]):
                fail(f"workloads [{name}]: the churn left {n_eps} endpoints, IPAM "
                     f"{len(agent.ipam)}, or kept a withdrawn container's address")
        survivors = {int(ipaddress.IPv4Address(ip)) for e, ip in ep_ip.items() if e not in gone_ids}
        _n3, c3, calls3 = enforce("after the churn", flows, dst_map,
                                  want_n=sum(1 for f in flows if f[1] in survivors))
        if gone_ids & set(c3):
            fail("workloads: a withdrawn endpoint's flow was enforced")
        ids_now = card_agent.pipeline._endpoint_ids
        want_idx = np.asarray([ids_now.index(dst_map[str(ipaddress.IPv4Address(f[1]))])
                               for f in flows if f[1] in survivors], np.int32)
        if not calls3 or not np.array_equal(np.concatenate([c[0] for c in calls3]), want_idx):
            fail("workloads: after the churn a lane's endpoint index is not its endpoint's")
    finally:
        for plugin in plugins.values():
            plugin.stop()
        for v in veth.values():  # cni_del removed them unless the phase failed first
            nsmod.delete_link(host_ifname(endpoint_id_for(v["cid"])))
            nsmod.delete_netns(v["ns"])
        shutil.rmtree(tmp, ignore_errors=True)
        for agent in agents.values():
            agent.shutdown()

    wall = time.perf_counter() - t_phase
    print(f"workloads: phase in {wall:.2f}s (limit {WORKLOADS_PHASE_LIMIT_S:.0f}s) [{card}]",
          flush=True)
    if wall > WORKLOADS_PHASE_LIMIT_S:
        fail(f"workloads: phase in {wall:.2f}s, over its {WORKLOADS_PHASE_LIMIT_S:.0f}s limit")


def wl_veth_traffic(veth: dict, agents: dict, lanes: dict, card: str) -> None:
    """Phase 3t's real-packet leg, test_cni_wire.py::
    test_wire_verdicts_match_policy's shape: client and other each send
    WL_VETH_SENDS UDP datagrams to web's address from their network
    namespaces; VethSniffer on their host veths and WireEnforcer.run_from
    verdict them on the card stand-in until client has WL_VETH_SENDS
    FORWARD and other as many DROP_POLICY; the same flows through the
    plain stand-in (its containers plumbed virtually): equal counts and
    lanes."""
    import numpy as np

    from cilium_tpu_torch.datapath.pipeline import DROP_POLICY, FORWARD
    from cilium_tpu_torch.datapath.wire import VethSniffer, WireEnforcer
    from cilium_tpu_torch.plugins import netns as nsmod

    t0 = time.perf_counter()
    web = veth["web"]["card"]
    dmap = {web.ipv4: web.endpoint_id}
    sniffers = [VethSniffer(veth[r]["card"].interface).start() for r in ("client", "other")]
    try:
        enf = WireEnforcer(agents["card"].pipeline, dmap)
        seen, real = [], enf.process_flows
        n_calls = len(lanes["card"].calls)

        def recorded(batch):
            seen.extend(batch)
            return real(batch)

        enf.process_flows = recorded
        send = ("import socket;s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM);"
                f"[s.sendto(b'x', ('{web.ipv4}', 9053)) for _ in range({WL_VETH_SENDS})]")
        for role in ("client", "other"):
            r = nsmod.netns_run(veth[role]["ns"], ["python3", "-c", send])
            if r.returncode != 0:
                fail(f"workloads [veth]: the {role} container could not send: {r.stderr}")
        n = [0]

        def enough():
            n[0] += enf.run_from(sniffers, duration=0.1, poll_s=0.02)
            c = enf.verdicts.get(web.endpoint_id, {})
            return (c.get(int(FORWARD), 0) >= WL_VETH_SENDS
                    and c.get(int(DROP_POLICY), 0) >= WL_VETH_SENDS)

        wl_wait("the sniffed veth flows", enough)
    finally:
        for s in sniffers:
            s.stop()
    pl = WireEnforcer(agents["plain"].pipeline, dmap)
    p_calls = len(lanes["plain"].calls)
    if pl.process_flows(seen) != n[0] or pl.verdicts != enf.verdicts:
        fail(f"workloads [veth]: the plain stand-in's verdicts {pl.verdicts} differ from the "
             f"card's {enf.verdicts}")
    card_v, plain_v = (np.concatenate([c[1] for c in calls]) for calls in
                       (lanes["card"].calls[n_calls:], lanes["plain"].calls[p_calls:]))
    if not np.array_equal(card_v, plain_v):
        fail("workloads [veth]: the card's lanes differ from the plain stand-in's")
    print(f"workloads [veth]: web {veth['web']['app']}, client {veth['client']['app']}, other "
          f"{veth['other']['app']}: {n[0]} real flows enforced, verdicts "
          f"{enf.verdicts[web.endpoint_id]} (client FORWARD and other DROP_POLICY >= "
          f"{WL_VETH_SENDS} each), == the plain stand-in's, in {time.perf_counter() - t0!r}s "
          f"[{card}]", flush=True)


def wl_health_leg(tmp: str, card: str) -> None:
    """Phase 3t step 6: the health child against a stub agent. The stub
    is the port's api/unixhttp.UnixHTTPServer answering
    APIClient.node_list with node "up" (its health port a live
    HealthResponder) and node "down" (a port nothing listens on). The
    child alone prints READY <port>; one /probe, then /status reports one
    node reachable and one not. Then HealthLauncher spawns it (its stdout
    goes nowhere: the API socket answering is its READY), a SIGKILL, and
    the launcher starts it again."""
    import os
    import signal
    import threading

    from cilium_tpu_torch.api.client import APIClient
    from cilium_tpu_torch.api.unixhttp import UnixHandler, UnixHTTPServer
    from cilium_tpu_torch.health.standalone import HealthAPIClient, HealthResponder
    from cilium_tpu_torch.proxy.launcher import HealthLauncher

    responder = HealthResponder("127.0.0.1", 0).start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    nodes = [{"name": "up", "cluster": "default", "ipv4": "127.0.0.1",
              "health_ip": "127.0.0.1", "health_port": responder.port},
             {"name": "down", "cluster": "default", "ipv4": "127.0.0.1",
              "health_ip": "127.0.0.1", "health_port": closed}]

    class Handler(UnixHandler):
        def do_GET(self):
            if self.path == "/node":
                self._json(200, nodes)
            else:
                self._json(404, {"error": "not found"})

    agent_sock = os.path.join(tmp, "agent.sock")
    srv = UnixHTTPServer(agent_sock, Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def check_status(c, what: str) -> dict:
        if c.probe() != {"probed": 2}:
            fail(f"workloads [health]: {what}: /probe did not probe both nodes")
        st = c.status()
        by = {n["name"]: n for n in st["nodes"]}
        if (st["total"], st["reachable"]) != (2, 1) or not by["up"]["reachable"] or \
                by["down"]["reachable"]:
            fail(f"workloads [health]: {what}: /status {st}")
        return st

    hl = None
    try:
        api = os.path.join(tmp, "health-alone.sock")
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "cilium_tpu_torch.health", "--agent", agent_sock, "--api", api,
             "--listen-ip", "127.0.0.1", "--port", "0", "--interval", "3600"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        guard = threading.Timer(WL_WAIT_S, p.kill)
        guard.start()
        try:
            line = p.stdout.readline().split()
            ready_s = time.perf_counter() - t0
            if not line or line[0] != "READY":
                fail(f"workloads [health]: the child printed {line} before READY")
            st = check_status(HealthAPIClient(api), "the child alone")
            if st["port"] != int(line[1]):
                fail("workloads [health]: /status names another port than READY")
        finally:
            guard.cancel()
            p.terminate()
            p.wait(timeout=10)
        api = os.path.join(tmp, "health.sock")
        healthz = APIClient(api, timeout=2)
        t0 = time.perf_counter()
        hl = HealthLauncher(agent_sock, api, restart_backoff_s=0.1).start()
        first_s = wl_wait("the launched health child",
                          lambda: healthz._request("GET", "/healthz") == {"ok": True})
        pid = hl.pid()
        check_status(HealthAPIClient(api), "the launched child")
        t0 = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        wl_wait("the health child's restart", lambda: hl.restarts == 1 and hl.pid() not in
                (None, pid))
        wl_wait("the restarted health child",
                lambda: healthz._request("GET", "/healthz") == {"ok": True})
        restart_s = time.perf_counter() - t0
        check_status(HealthAPIClient(api), "the restarted child")
        if hl.restarts != 1:
            fail(f"workloads [health]: {hl.restarts} restarts after one kill")
        print(f"workloads [health]: spawn to READY {ready_s!r}s; under HealthLauncher spawn to "
              f"/healthz {first_s!r}s, SIGKILL to the restarted child's /healthz {restart_s!r}s "
              f"(restarts {hl.restarts}); /status after /probe: 1 of 2 nodes reachable, probes "
              f"answered by the live responder {responder.accepted} [{card}]", flush=True)
    finally:
        if hl is not None:
            hl.stop()
        srv.shutdown()
        srv.server_close()
        responder.stop()


def collections_counter(xs) -> dict:
    """{value: count} of ``xs``, sorted by value."""
    import numpy as np

    vals, counts = np.unique(np.asarray(list(xs) if not hasattr(xs, "shape") else xs),
                             return_counts=True)
    return {int(k): int(n) for k, n in zip(vals, counts)}


def metric_series():
    """Snapshot of the attribution metrics (rule_hits_total and
    drop_reasons_total), keyed by (metric, labels)."""
    from cilium_tpu_torch import metrics

    return {(m.name, k): v for m in (metrics.rule_hits_total, metrics.drop_reasons_total)
            for k, v in m.series().items()}


def metric_delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.pipeline import (
        TRAFFIC_INGRESS, DatapathPipeline, process_flows, process_flows_wide,
    )
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.ops import materialize as matmod
    from cilium_tpu_torch.ops import verdict as verdictmod
    from cilium_tpu_torch.ops.bitmap import compute_selector_matches, selector_match_plain, unpack_bits_u32
    from cilium_tpu_torch.ops.lookup import policymap_verdict, policymap_verdict_plain
    from cilium_tpu_torch.ops.lpm import (
        build_trie_elided, elided_lookup, lpm_lookup_wide, lpm_stride8_plain, lpm_wide_plain,
    )
    from cilium_tpu_torch.ops.verdict import (
        ATTR_NAMES, bool_mm, bool_mm_plain, first_rule, first_rule_plain, first_rule_terms_plain,
    )
    from cilium_tpu_torch.convert import words_i32
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops import dfa as dfamod
    from cilium_tpu_torch.ops import bitmap as bitmod
    from cilium_tpu_torch.ops import lpm as lpmmod
    from cilium_tpu_torch.ops.dfa import (
        L7_LEN_LADDER, DeviceDFATable, device_dfa, dfa_match_batch, dfa_match_batch_fused,
        dfa_match_batch_classes, dfa_match_batch_pair, dfa_pair_walk_plain, dfa_walk_plain,
        fuse_dfas, len_rung, strings_to_batch, strings_to_batch_u8,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    t_start = time.perf_counter()
    t_mark = [t_start]

    def phase(label):
        """The wall time of the phase that ends here, and since the start."""
        now = time.perf_counter()
        print(f"phase {label}: {now - t_mark[0]:.1f}s (at {now - t_start:.1f}s)", flush=True)
        t_mark[0] = now

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build()
    _kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {_kernels.build_seconds if _kernels.build_seconds is not None else 0.0:.2f}s)",
          flush=True)

    n_igmma = igmma_count()
    if n_igmma <= 0:
        fail("the built bool_mm kernels hold no IGMMA (int8 wgmma) instruction")
    print(f"bool_mm SASS: {n_igmma} IGMMA (int8 tensor-core wgmma) instructions over its "
          f"kernels (cuobjdump -sass)", flush=True)

    edge_checks(dev)
    edge_checks2(dev)
    edge_checks3(dev)
    edge_checks4(dev)
    edge_checks5(dev)
    edge_checks6(dev)
    edge_checks7(dev)
    edge_checks8(dev)
    edge_checks9(dev)
    edge_checks10(dev)
    edge_checks11(dev)
    edge_checks12(dev)
    print("edge shapes: every kernel equals its plain version (ragged K1/K2, "
          "16-8-8 K3, 1 280-column / 2 100-endpoint K4; K2 at every tile edge of "
          f"{len(k2_edge_shapes())} shapes, non-contiguous, bool and misaligned operands;  4- and 16-level K5 with "
          "out-of-range bytes and child ids; ragged K6; K4 attribution with shared and "
          "global histograms; K7 both entries and K8 at every rung and odd caps, uint8 and "
          "int32 bytes, out-of-range starts and bytes, lengths past max_len, empty batches; K9 both "
          "entries at F = 1, 32 / 33, 300, 1 024 / 1 025, 4 096 / 4 097 and 20 000, B = 0, 1 and "
          "ragged, both address widths, repeated keys, ANY before and after specific frontends, "
          "protocol-0 flows, dport -1 against padded slots, every key equal, one forced chain; "
          "K10 both entries on 16-, 64- and 1024-slot tables over five steps, wrapped windows, "
          "contested slots, B = 0 and 1, 1 024- and 4 096-slot tables at ~90% load with tag-"
          "matching decoys, 4- and 8-slot tables; K11 both "
          "entries at B = 0, 1, 31 and 4 097 over every dport bucket edge and proto 0 / 6 / 17 / "
          "255, both v4 layouts, rows past the table, v6 bytes outside [0, 255]; K12 at B = 0, 3, "
          "41, 77, 4 097, W = 1 to 2 500, shard offsets, an empty shard, ids outside the shard, "
          "and a 2 x 2 grid's gather == index_select; one launch over 1, 2 and 4 shards, "
          "ragged and empty ones, W = 1 / 18 / 20 / 288 / 2 500, ids -1 and N; K4 both entries "
          f"on sorted and shuffled columns at C {K4_EDGE_C}, ep -1 and >= E against -1 padding, "
          "B = 0, 1, 4 097 and ragged, unaligned flow views, shared and global counters and "
          "hits, shard lists of 1, 2 and 4 shards with an empty one, ids -1 and N, direct and "
          f"gathered mode; K6 with 1 to 3 terms at widths {K6_EDGE_W}, all-zero rows, rows off "
          "a 16-byte boundary; K7 both entries at Q 400 / 401 around the shared-memory table, "
          "row strides of 16 / 32 / 64 / 1 024 bytes and of 17, 20, 24, views one row and one "
          "element in, lengths around every 16-byte chunk, B to 300 000; K5 and K11's stride-8 "
          "entry at strides 16, 20, 17, 5 and 4, views one row and one element in, K 0, 2, 13 "
          "and 16, bytes outside [0, 255] compared and walked; K3 on both layouts at B = 0 to "
          "200 003 and offset views; K1 on its staged and wide routes at W 0 to 800, S 0 to 640, "
          "CPS 0 to 3, N 0 to 2 048, dense and empty conjuncts, offset rows and conjuncts; K8 on "
          "its classes and L2 routes over odd and even max_len from 0 to 256, uint8 and int32 "
          "bytes, offset views, B = 0 to 200 003, Q 126 tables whose classes fit and do not "
          "and a hand-made pair table; K11's v6 entry on its vector and scalar routes at "
          "K 0 to 16, levels 8 / 12 / 16, B = 0 to 1 048 583, views 0 / 1 / 4 / 8 int32 in, bytes "
          "outside [0, 255] in either half of a row, rows past the shed table; each launch on the route "
          "its layout names, ill-formed class forms refused, and the C entries refuse a route "
          "their inputs do not allow)",
          flush=True)

    phase("1 build, edge checks")

    # -- 2. world --------------------------------------------------------
    t0 = time.perf_counter()
    repo, reg, cache, idents, labels_of = build_world(args.seed)
    ips, eps, dports, protos, i_sel = make_flows(args.seed, len(idents))
    addr6, eps6, dports6, protos6, i_sel6 = make_flows6(args.seed, len(idents))
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    print(f"world: {N_RULES} rules, {len(idents)} identities, {N_ENDPOINTS} endpoints "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    launches = {}

    def check_path(path, names):
        got = _kernels.launches()
        launches[path] = got
        print(f"main path [{path}] launches {got}", flush=True)
        for k in names:
            if got[k] <= 0:
                fail(f"kernel {k} never launched on the {path} main path")
        if got["selector_match"]:
            print(f"main path [{path}] selector_match route (latest launch) "
                  f"{bitmod.SELECTOR_ROUTES['selector_match']} [{card}]", flush=True)

    # every pipeline from here on, and every quarantine and ladder move
    watch = FailsafeWatch()

    phase("2 world")

    # -- 3a. v4 main path on the card, launch counts from zero -----------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    engine = PolicyEngine(repo, reg)
    engine.refresh()
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    pipes = {}
    results = {}
    pf_sets = (("no-prefilter", []), ("prefilter", PREFILTER_CIDRS + V6_DENY))
    for name, cidrs in pf_sets:
        pf = PreFilter()
        if cidrs:
            pf.insert(pf.revision, cidrs)
        pipe = DatapathPipeline(engine, cache, pf)
        pipe.set_endpoints(endpoints)
        t0 = time.perf_counter()
        pipe.rebuild()
        torch.cuda.synchronize()
        t_rebuild = time.perf_counter() - t0
        times, outs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            outs.append(pipe.process(ips, eps, dports, protos))
            times.append(time.perf_counter() - t0)
        v, red = outs[0]
        for v2, red2 in outs[1:]:
            if not (np.array_equal(v, v2) and np.array_equal(red, red2)):
                fail(f"{name}: runs of one batch disagree")
        pipes[name] = pipe
        results[name] = (v, red)
        fused = pipe._tables[(TRAFFIC_INGRESS, 4)].merged_sub_info.shape[-1] == 65536
        t_med = sorted(times)[1]
        print(f"main path [{name}]: rebuild {t_rebuild!r}s (both families' tries), process "
              f"{BATCH} flows {times}s (median {t_med!r}s = {BATCH / t_med!r} "
              f"verdicts/s end to end incl. h2d/d2h; fused walk: {fused}); verdicts "
              f"{np.bincount(v, minlength=4)[1:].tolist()}, redirects {int(red.sum())} "
              f"[{card}]", flush=True)
    print(f"refresh {t_refresh!r}s", flush=True)
    check_path("v4", ["selector_match", "bool_mm", "lpm_wide", "policymap_verdict"])
    if not pipes["prefilter"]._tables[(TRAFFIC_INGRESS, 4)].merged_sub_info.shape[-1] == 65536:
        fail("prefilter run did not take the fused walk")

    phase("3a v4 main path")

    # -- 3b. v6 main path -------------------------------------------------
    _kernels.reset_launches()
    results6 = {}
    for name, _cidrs in pf_sets:
        pipe = pipes[name]
        times, outs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            outs.append(pipe.process_v6(addr6, eps6, dports6, protos6))
            times.append(time.perf_counter() - t0)
        v, red = outs[0]
        for v2, red2 in outs[1:]:
            if not (np.array_equal(v, v2) and np.array_equal(red, red2)):
                fail(f"{name} v6: runs of one batch disagree")
        results6[name] = (v, red)
        t6 = pipe._tables[(TRAFFIC_INGRESS, 6)]
        k_ip, k_m = t6.ip_common.shape[0], t6.merged_common.shape[0]
        t_med = sorted(times)[1]
        print(f"main path v6 [{name}]: process_v6 {BATCH} flows {times}s (median {t_med!r}s = "
              f"{BATCH / t_med!r} verdicts/s end to end incl. h2d/d2h; fused walk: "
              f"{pipe._v6_fused}, K identity {k_ip}, K fused {k_m}); verdicts "
              f"{np.bincount(v, minlength=4)[1:].tolist()}, redirects {int(red.sum())} "
              f"[{card}]", flush=True)
        if k_ip != 13:
            fail(f"{name}: the v6 identity trie elided {k_ip} bytes, not 13")
    check_path("v6", ["lpm_stride8", "policymap_verdict"])
    if pipes["no-prefilter"]._v6_fused or not pipes["prefilter"]._v6_fused:
        fail("the v6 walks are not identity-only / fused as configured")
    if pipes["prefilter"]._tables[(TRAFFIC_INGRESS, 6)].merged_common.shape[0] != 13:
        fail("the fused v6 trie did not keep the 13 shared bytes")

    phase("3b v6 main path")

    # -- 4. against the plain path on the CPU and the host oracle --------
    t0 = time.perf_counter()
    cpu_engine = PolicyEngine(repo, reg, device="cpu")
    cpu_pipes = {}
    s = slice(0, SLICE)
    for name, cidrs in pf_sets:
        pf = PreFilter()
        if cidrs:
            pf.insert(pf.revision, cidrs)
        cpu_pipe = DatapathPipeline(cpu_engine, cache, pf, device="cpu")
        cpu_pipe.set_endpoints(endpoints)
        cpu_pipes[name] = cpu_pipe
        gpu_pipe = pipes[name]
        for fam, call, flows, res in (
            ("v4", "process", (ips, eps, dports, protos), results),
            ("v6", "process_v6", (addr6, eps6, dports6, protos6), results6),
        ):
            cpu_pipe.counters[:] = 0
            vc, rc = getattr(cpu_pipe, call)(*(a[s] for a in flows))
            v, red = res[name]
            if not (np.array_equal(vc, v[s]) and np.array_equal(rc, red[s])):
                bad = int(np.argmax((vc != v[s]) | (rc != red[s])))
                fail(f"{name} {fam}: card and CPU disagree at flow {bad}")
            gpu_pipe.counters[:] = 0
            getattr(gpu_pipe, call)(*(a[s] for a in flows))
            if not np.array_equal(gpu_pipe.counters, cpu_pipe.counters):
                fail(f"{name} {fam}: counters differ between card and CPU")
        denied = [ipaddress.ip_network(c) for c in cidrs]
        oracle_check(repo, labels_of, idents, name, ips, eps, dports, protos, i_sel,
                     results[name][0], [n for n in denied if n.version == 4], endpoints)
        oracle_check6(repo, reg, labels_of, idents, name, addr6, eps6, dports6, protos6, i_sel6,
                      results6[name][0], [n for n in denied if n.version == 6], endpoints)
    print(f"card == CPU plain path on {SLICE} flows (verdicts, redirects, counters) and "
          f"== host oracle on {N_ORACLE} flows, v4 and v6, both pipelines, in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    phase("4 CPU parity")

    # -- 3c. attribution main path ---------------------------------------
    _kernels.reset_launches()
    matmod.SWEEPS.clear()
    apipe = pipes["prefilter"]
    apipe.set_attribution(True)
    attr_blocks = [0]
    real_block = verdictmod._verdict_block

    def counted_block(*a, **kw):
        attr_blocks[0] += kw.get("origin") is not None
        return real_block(*a, **kw)

    verdictmod._verdict_block = counted_block
    try:
        t0 = time.perf_counter()
        apipe.rebuild()
        torch.cuda.synchronize()
        t_rebuild = time.perf_counter() - t0
    finally:
        verdictmod._verdict_block = real_block
    attr_out = {}
    for fam, call, flows in (("v4", "process", (ips, eps, dports, protos)),
                             ("v6", "process_v6", (addr6, eps6, dports6, protos6))):
        before = metric_series()
        t0 = time.perf_counter()
        v, red = getattr(apipe, call)(*flows)
        t_proc = time.perf_counter() - t0
        d = metric_delta(before, metric_series())
        attr_out[fam] = (v, red)
        drops = {dict(k[1])["reason"]: int(x) for k, x in d.items()
                 if k[0].endswith("drop_reasons_total")}
        n_hit = sum(int(x) for k, x in d.items() if k[0].endswith("rule_hits_total"))
        print(f"main path attribution [{fam}]: process {BATCH} flows {t_proc!r}s = "
              f"{BATCH / t_proc!r} verdicts/s end to end (first call after the attributed "
              f"rebuild); rule hits {n_hit}, drop reasons {drops} [{card}]", flush=True)
        if not np.array_equal(v, (results if fam == "v4" else results6)["prefilter"][0]):
            fail(f"attribution changed the {fam} verdicts")
    sweeps = dict(matmod.SWEEPS)
    print(f"attributed rebuild {t_rebuild!r}s ({sweeps} sweep calls) [{card}]", flush=True)
    check_path("attribution", ["bool_mm", "first_rule", "policymap_verdict_attrib",
                               "lpm_wide", "lpm_stride8"])
    k6_rebuild = launches["attribution"]["first_rule"]
    print(f"attributed rebuild: K6 launches {k6_rebuild} over {attr_blocks[0]} attributed sweep "
          "blocks (one launch a block for its three terms; the first version made three)", flush=True)
    if k6_rebuild != attr_blocks[0]:
        fail(f"the attributed rebuild launched K6 {k6_rebuild} times for {attr_blocks[0]} blocks")
    if sweeps.get("flow_attrib", 0) <= 0:
        fail("the attributed rebuild did not run the flow-route sweep")

    phase("3c attribution main path")

    # -- 4b. attribution against the CPU path on a slice -------------------
    t0 = time.perf_counter()
    cpu_apipe = DatapathPipeline(cpu_engine, cache, cpu_pipes["prefilter"].prefilter, device="cpu")
    cpu_apipe.set_endpoints(endpoints[:N_ATTR_EPS])
    cpu_apipe.set_attribution(True)
    cpu_apipe.rebuild()
    n_rules = apipe._attrib_n_rules
    if n_rules != N_RULES or cpu_apipe._attrib_n_rules != N_RULES:
        fail(f"attribution counts {n_rules} rules, expected {N_RULES}")
    for fam, flows in (("v4", (ips, eps, dports, protos)), ("v6", (addr6, eps6, dports6, protos6))):
        sel = np.nonzero(flows[1] < N_ATTR_EPS)[0][:ATTR_SLICE]
        part = [a[sel] for a in flows]
        outs = []
        for pipe, ep_count in ((apipe, N_ENDPOINTS), (cpu_apipe, N_ATTR_EPS)):
            fdev = pipe.device
            t = pipe._tables[(TRAFFIC_INGRESS, 4 if fam == "v4" else 6)]
            fargs = [torch.from_numpy(np.ascontiguousarray(a)).to(fdev) for a in part[1:]]
            kw = dict(ep_count=ep_count, prefilter=True, attrib=True, n_rules=n_rules,
                      rule_tab=pipe._rule_tabs[TRAFFIC_INGRESS])
            if fam == "v4":
                peer = torch.from_numpy(part[0].view(np.int32)).to(fdev)
                out = process_flows_wide(t, peer, *fargs, **kw)
            else:
                out = process_flows(t, torch.from_numpy(part[0]).to(fdev), *fargs, levels=16,
                                    fused=pipe._v6_fused, **kw)
            outs.append([x.cpu().numpy() for x in out])
        g, c = outs
        for k, what in ((0, "verdicts"), (1, "redirects"), (3, "rules"), (4, "l4_covered"),
                        (5, "rule hits")):
            if not np.array_equal(g[k], c[k]):
                fail(f"attribution {fam}: {what} differ between card and CPU")
        if not (np.array_equal(g[2][:N_ATTR_EPS], c[2]) and not g[2][N_ATTR_EPS:].any()):
            fail(f"attribution {fam}: counters differ between card and CPU")
        if not ((g[3] >= 0).any() and (g[3] == -1).any() and g[4].any()):
            fail(f"attribution {fam}: the slice attributes no rule or no drop")
        deltas = []
        call = "process" if fam == "v4" else "process_v6"
        for pipe in (apipe, cpu_apipe):
            before = metric_series()
            getattr(pipe, call)(*part)
            deltas.append(metric_delta(before, metric_series()))
        if deltas[0] != deltas[1] or not deltas[0]:
            fail(f"attribution {fam}: metric deltas differ between card and CPU")
    rs = np.random.default_rng(args.seed + 9)
    for _ in range(8):
        q = (int(rs.choice(endpoints)), int(idents[int(rs.integers(0, len(idents)))].id),
             int(rs.choice([80, 443, 8080, 53, 22])))
        q = (*q, 17 if q[2] == 53 else 6)
        for ingress in (True, False):
            if engine.explain_one(*q, ingress=ingress) != cpu_engine.explain_one(*q, ingress=ingress):
                fail(f"explain_one{q} (ingress {ingress}) differs between card and CPU")
    print(f"attribution: card == CPU path on {ATTR_SLICE} flows of each family over the first "
          f"{N_ATTR_EPS} endpoints (verdicts, rules, l4_covered, rule hits, counters, metric "
          f"deltas) and explain_one on 16 queries, in {time.perf_counter() - t0:.2f}s", flush=True)

    phase("4b attribution parity")

    # -- 4c. small world: every reason code on the card --------------------
    t0 = time.perf_counter()
    srepo, sreg, scache, sidents = build_small_world(args.seed)
    seng = {d: PolicyEngine(srepo, sreg, device=d) for d in ("cuda", "cpu")}
    rs = np.random.default_rng(args.seed + 11)
    ids = [i.id for i in sidents]
    q = (rs.choice(ids, 4096), rs.choice(ids, 4096),
         rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), 4096))
    q = (*q, np.where(q[2] == 53, 17, 6).astype(np.int32))
    hl4 = rs.random(4096) < 0.85
    for ingress in (True, False):
        (gv, ga, gh), (cv, ca, ch) = (seng[d].verdicts(*q, ingress=ingress, has_l4=hl4, attrib=True)
                                      for d in ("cuda", "cpu"))
        for a, b in ((gv.decision, cv.decision), (gv.l3, cv.l3), (gv.l7_redirect, cv.l7_redirect),
                     (ga.rule, ca.rule), (ga.reason, ca.reason), (gh, ch)):
            if max_abs_err(a.cpu(), b):
                fail(f"small world: engine attribution differs between card and CPU (ingress {ingress})")
        reasons = set(ga.reason.cpu().numpy().tolist())
        if ingress and reasons != set(ATTR_NAMES):
            fail(f"small world: reason codes {sorted(reasons)} on the card, expected all of {sorted(ATTR_NAMES)}")
    for k in range(12):
        a = (int(q[0][k]), int(q[1][k]), int(q[2][k]), int(q[3][k]))
        if seng["cuda"].explain_one(*a) != seng["cpu"].explain_one(*a):
            fail(f"small world: explain_one{a} differs between card and CPU")
    spipes = {}
    for d in ("cuda", "cpu"):
        spf = PreFilter()
        spf.insert(spf.revision, ["172.16.0.0/29", "fd00::9:0/125"])
        spipes[d] = DatapathPipeline(seng[d], scache, spf, device=d)
        spipes[d].set_endpoints([i.id for i in sidents[:6]])
        spipes[d].set_attribution(True)
    sflows4 = (np.array([int(ipaddress.IPv4Address(f"172.16.0.{int(j) + 1}"))
                         for j in rs.integers(0, 48, 4096)], np.uint32),
               rs.integers(0, 6, 4096).astype(np.int32), q[2], q[3])
    sflows6 = (np.stack([np.frombuffer(ipaddress.IPv6Address(f"fd00::9:{int(j) + 1:x}").packed,
                                       np.uint8) for j in rs.integers(0, 48, 4096)]).astype(np.int32),
               *sflows4[1:])
    for call, flows in (("process", sflows4), ("process_v6", sflows6)):
        for ingress in (True, False):
            out, deltas = [], []
            for d in ("cuda", "cpu"):
                before = metric_series()
                out.append(getattr(spipes[d], call)(*flows, ingress=ingress))
                deltas.append(metric_delta(before, metric_series()))
            if not all(np.array_equal(x, y) for x, y in zip(*out)) or deltas[0] != deltas[1]:
                fail(f"small world {call} (ingress {ingress}): card and CPU differ")
    print(f"small world (40 rules with deny and L7, 48 identities): every reason code "
          f"{sorted(ATTR_NAMES.values())} on the card, engine attribution, explain_one and "
          f"pipeline metric deltas == CPU, in {time.perf_counter() - t0:.2f}s", flush=True)

    phase("4c small world")

    # -- 3d. L7 main path, launch counts from zero -----------------------
    _kernels.reset_launches()
    l7res = l7_main_path(args.seed, card, (ips, eps, dports, protos), endpoints)
    off = l7res["off_launches"]
    if off["dfa_walk_fused"] or off["dfa_pair_walk"] or not off["dfa_walk"]:
        fail(f"the L7DeviceBatch-off path launched {off}")
    check_path("l7", ["dfa_walk", "dfa_walk_fused", "dfa_pair_walk"])
    pair_walk_lines(l7res["pairs"], card)
    if sum(l7res["pairs"].values()) != launches["l7"]["dfa_pair_walk"]:
        fail(f"the L7 main path's K8 launches by shape {sum(l7res['pairs'].values())} differ from "
             f"its count {launches['l7']['dfa_pair_walk']}")

    phase("3d L7 main path")

    # -- 4d. L7 against the CPU path and the rules' oracle -----------------
    t0 = time.perf_counter()
    l7_cpu_checks(l7res)
    print(f"L7 CPU and oracle checks in {time.perf_counter() - t0:.2f}s", flush=True)

    phase("4d L7 parity")

    # -- 3e. services+CT main path, launch counts from zero --------------
    svc = services_main_path(args.seed, card)
    check_path("services", ["lb_index_build", "lb_translate", "lpm_wide", "lpm_stride8",
                            "policymap_verdict"])

    phase("3e services main path")

    # -- 4e. services+CT against the CPU path -----------------------------
    services_cpu_checks(svc)

    phase("4e services parity")

    # -- 3f. device-CT main path, launch counts from zero ----------------
    dct = device_ct_main_path(svc, card)
    check_path("device_ct", ["lpm_wide", "lpm_stride8", "policymap_verdict", "ct_probe_claim",
                             "ct_commit"])
    if launches["device_ct"]["lb_translate"] or launches["device_ct"]["lb_index_build"]:
        fail("the device-CT pipeline has no LB, yet K9 launched")

    phase("3f device-CT main path")

    # -- 4f. device CT against the CPU path and the host CT -------------
    device_ct_cpu_checks(svc, dct)
    host_ct_compare(svc, dct, card)

    phase("4f device-CT parity")

    # -- 3g. submit and the admission gate, launch counts from zero ------
    sub = submit_main_path(engine, cache, endpoints, (ips, eps, dports, protos),
                           (addr6, eps6, dports6, protos6), args.seed, len(idents), card)
    check_path("submit", ["lpm_wide", "lpm_stride8", "policymap_verdict", "shed_walk_wide",
                          "shed_walk_stride8"])

    phase("3g submit main path")

    # -- 3h. incremental policy updates, launch counts from zero --------
    dl = deltas_main_path(args.seed, card)
    check_path("deltas", ["bool_mm", "first_rule", "lpm_wide", "lpm_stride8", "policymap_verdict"])
    if launches["deltas"]["selector_match"]:
        fail("a delta launched K1 selector_match: the engine recompiled in full")

    phase("3h deltas main path")

    # -- 3i. sparse trie deltas and the epoch swap, launch counts from zero
    sp = sparse_main_path(args.seed, card)
    check_path("sparse", ["selector_match", "bool_mm", "lpm_wide", "lpm_stride8", "policymap_verdict"])

    phase("3i sparse main path")

    # -- 3j. multi-device placement on a virtual grid, counts from zero --
    ms = mesh_main_path(args.seed, card)
    check_path("mesh", ["selector_match", "bool_mm", "first_rule", "ident_gather", "lpm_wide",
                        "lpm_stride8", "policymap_verdict", "policymap_verdict_attrib"])

    phase("3j mesh main path")

    # -- 3k. the failsafe ladder and the watchdog, counts from zero -----
    watch.check("after the other phases")
    _kernels.reset_launches()
    faults_expected = failsafe_main_path(engine, cache, endpoints, (ips, eps, dports, protos),
                                         (addr6, eps6, dports6, protos6), args.seed, card, watch)
    check_path("failsafe", ["bool_mm", "lpm_wide", "lpm_stride8", "policymap_verdict",
                            "ct_probe_claim", "ct_commit"])
    watch.check("after the failsafe phase", faults_expected)

    phase("3k failsafe main path")

    # -- 3l. tracing, the profiler and the depth tuner, counts from zero --
    observe_main_path(engine, cache, endpoints, (ips, eps, dports, protos),
                      (addr6, eps6, dports6, protos6), svc, dct, l7res, card)
    check_path("observe", ["lpm_wide", "lpm_stride8", "policymap_verdict", "lb_index_build",
                           "lb_translate", "ct_probe_claim", "ct_commit", "dfa_walk_fused"])

    phase("3l observe main path")

    # -- 3m. flow events and the flow ring, counts from zero -------------
    events_main_path(engine, cache, endpoints, labels_of, (ips, eps, dports, protos),
                     (addr6, eps6, dports6, protos6), svc, dct, card)
    check_path("events", ["lpm_wide", "lpm_stride8", "policymap_verdict",
                          "policymap_verdict_attrib", "shed_walk_wide", "ct_probe_claim",
                          "ct_commit"])

    phase("3m events main path")

    # -- 3n. snapshots, the restore and the CT snapshot, counts from zero
    _kernels.reset_launches()
    restore_main_path(engine, cache, endpoints, (ips, eps, dports, protos),
                      (addr6, eps6, dports6, protos6), svc, args.seed, card)
    check_path("restore", ["selector_match", "bool_mm", "lpm_wide", "lpm_stride8",
                           "policymap_verdict", "lb_index_build", "lb_translate", "ct_probe_claim",
                           "ct_commit"])

    phase("3n restore main path")

    # -- 3o. endpoints and the native enforcer, counts from zero ---------
    _kernels.reset_launches()
    endpoints_main_path(args.seed, card, (ips, eps, dports, protos),
                        (addr6, eps6, dports6, protos6), svc, l7res)
    check_path("endpoints", ["selector_match", "bool_mm", "lpm_wide", "lpm_stride8",
                             "policymap_verdict", "lb_index_build", "lb_translate", "dfa_walk"])

    phase("3o endpoints and native")

    # -- 3p. distributed state, counts from zero -------------------------
    _kernels.reset_launches()
    distributed_main_path(args.seed, card, (ips, eps, dports, protos),
                          (addr6, eps6, dports6, protos6), svc)
    check_path("distributed", ["selector_match", "bool_mm", "lpm_wide", "lpm_stride8",
                               "policymap_verdict", "lb_index_build", "lb_translate"])

    phase("3p distributed state")

    # -- 3q. fleet observability, counts from zero -----------------------
    _kernels.reset_launches()
    faults_expected += fleet_main_path(repo, reg, cache, endpoints, labels_of,
                                       (ips, eps, dports, protos),
                                       (addr6, eps6, dports6, protos6), args.seed, card, watch)
    check_path("fleet", ["selector_match", "bool_mm", "lpm_wide", "lpm_stride8",
                         "policymap_verdict", "shed_walk_wide"])
    watch.check("after the fleet phase", faults_expected)

    phase("3q fleet observability")

    # -- 3r. the Kubernetes and DNS policy sources, counts from zero -----
    _kernels.reset_launches()
    k8s_main_path(args.seed, card)
    check_path("k8s", ["selector_match", "bool_mm", "lpm_wide", "lpm_stride8",
                       "policymap_verdict", "lb_index_build", "lb_translate"])
    watch.check("after the k8s phase", faults_expected)

    phase("3r k8s and DNS policy sources")

    # -- 3s. the external proxy and its xDS channel, counts from zero ----
    _kernels.reset_launches()
    external_proxy_main_path(l7res, card)
    # the path under test is the child's, in another process: nothing
    # of it launches here, and the card's check_batch ran uncounted
    check_path("external proxy", [])
    if any(launches["external proxy"].values()):
        fail(f"external proxy: launches {launch_delta({})} counted in this process")

    phase("3s external proxy")

    # -- 3t. workload runtimes and health, counts from zero --------------
    _kernels.reset_launches()
    workloads_main_path(args.seed, card)
    check_path("workloads", ["selector_match", "bool_mm", "lpm_wide", "policymap_verdict"])
    watch.check("after the workloads phase", faults_expected)

    phase("3t workloads and health")

    # -- 5. each kernel against its plain version on the card ------------
    compiled, device = engine.snapshot()
    rows = []

    def route_of(name):
        """The path the kernel's latest launch took inside it (K7, K5,
        K11's stride-8 entry), else None."""
        if name in ("dfa_walk", "dfa_walk_fused", "dfa_pair_walk"):
            return " + ".join(dfamod.WALK_ROUTES[name])
        if name in ("lpm_stride8", "shed_walk_stride8"):
            return lpmmod.STRIDE8_ROUTES[name]
        if name == "selector_match":
            return bitmod.SELECTOR_ROUTES[name]
        return None

    def row(name, source, replaces, err, fn, plain_fn, b_ms, b_by, shape, lib_fn=None,
            iters=20, plain_iters=5, reps=5, graph=False, per_call=1, note=None):
        """Times fn, its plain version and lib_fn; ``per_call``: the
        launches one call of fn makes (each time is then per launch, the
        mean over them, and b_ms the bound of one such launch); ``note``
        is printed after the bound."""
        def each(times):
            return None if times is None else [t / per_call for t in times]

        ms, clk = timed(fn, iters=iters, reps=reps)
        route = route_of(name)
        plain_ms, pclk = timed(plain_fn, iters=plain_iters, reps=reps)
        lib = lib_graph = None
        if lib_fn is not None:
            lib, _ = timed(lib_fn, iters=iters, reps=reps)
            lib_graph = graph_ms(lib_fn) if graph else None
        rows.append(dict(name=name, source=source, replaces=replaces, err=err, ms=each(ms),
                         plain_ms=each(plain_ms), library_ms=each(lib), bound_ms=b_ms,
                         bound_by=b_by, shape=shape, clock=clk, plain_clock=pclk, route=route,
                         graph_ms=each(graph_ms(fn)) if graph else None,
                         library_graph_ms=each(lib_graph), note=note))

    # K1 selector_match at the engine's shapes
    k1_in = (
        words_i32(compiled.id_bits, dev), words_i32(compiled.conj_req, dev),
        words_i32(compiled.conj_forbid, dev),
        torch.from_numpy(np.ascontiguousarray(compiled.conj_valid, bool)).to(dev),
        torch.from_numpy(np.ascontiguousarray(compiled.req_count, np.int32)).to(dev),
    )
    k_out = compute_selector_matches(*k1_in)
    p_out = selector_match_plain(*k1_in)
    n, w = compiled.id_bits.shape
    s_, cps, _ = compiled.conj_req.shape
    # the function's least time: its bytes, or one popcount a row for
    # each nonzero word of a valid conjunct at 132 SMs x 16 a clock (the
    # SM clock read now); the TPU form's dense int8 products are printed
    # beside it, no floor for a kernel that skips the zero words
    nz_words = int(((k1_in[1] | k1_in[2]) != 0)[k1_in[3]].sum())
    clk = sm_clock().split()[0]
    clk_mhz = int(clk) if clk.isdigit() else 1980  # the H100 SXM's boost clock if unread
    b_ms, b_by = bound(nbytes(*k1_in, k_out), n * nz_words, 132 * 16 * clk_mhz * 1e6)
    dense_ms, _ = bound(0, 2 * 2 * n * (w * 32) * s_ * cps)
    row("selector_match", "cilium_tpu_torch/csrc/selector_match.cu", "cilium_tpu/ops/bitmap.py:57",
        max_abs_err(k_out, p_out), lambda: compute_selector_matches(*k1_in),
        lambda: selector_match_plain(*k1_in), b_ms, b_by,
        f"id_bits [{n},{w}], conj [{s_},{cps},{w}]", graph=True,
        note=f"the bound: bytes {nbytes(*k1_in, k_out)} and {n} x {nz_words} popcounts over "
             f"the valid conjuncts' nonzero words at {clk_mhz} MHz; the dense int8-product "
             f"figure (the first version's bound) {dense_ms!r} ms is no floor")

    # K2 bool_mm at the sweep's largest product: [1024, S] x [S, S], the
    # deny product with its complemented left operand
    t_in = device.ingress
    peer8 = unpack_bits_u32(device.sel_match[:1024])
    k_out = bool_mm(peer8, t_in.deny_t, complement_x=True)
    k2_row(row, "sweep", peer8, t_in.deny_t, True,
           max_abs_err(k_out, bool_mm_plain(peer8, t_in.deny_t, complement_x=True)))

    # K3 lpm_wide over the batch: identity trie (flat) and the fused trie
    peer = torch.from_numpy(ips.view(np.int32)).to(dev)
    for name, prefix in (("no-prefilter", "ip"), ("prefilter", "merged")):
        t = pipes[name]._tables[(TRAFFIC_INGRESS, 4)]
        tabs = [getattr(t, f"{prefix}_{f}") for f in ("root_info", "root_child", "sub_child", "sub_info")]
        b_ms, b_by = bound(lpm_touched_bytes(tabs[0], tabs[1], tabs[3], peer), 0)
        row("lpm_wide", "cilium_tpu_torch/csrc/lpm_wide.cu", "cilium_tpu/ops/lpm.py:346",
            max_abs_err(lpm_lookup_wide(*tabs, peer), lpm_wide_plain(*tabs, peer)),
            lambda: lpm_lookup_wide(*tabs, peer), lambda: lpm_wide_plain(*tabs, peer),
            b_ms, b_by, f"{BATCH} addresses, {prefix} trie sub_info {list(tabs[3].shape)}",
            graph=True)

    # K4 policymap_verdict over the batch with the prefilter run's rows
    t = pipes["prefilter"]._tables[(TRAFFIC_INGRESS, 4)]
    packed = lpm_lookup_wide(t.merged_root_info, t.merged_root_child, t.merged_sub_child,
                             t.merged_sub_info, peer)
    denied = (packed & (1 << 30)) != 0
    hit = packed & ((1 << 30) - 1)
    src_rows = torch.where(hit > 0, hit - 1, t.world_row).to(torch.int32)
    flow_t = [torch.from_numpy(a).to(dev) for a in (eps, dports, protos)]
    pm = t.policymap
    k_v, k_r, k_c = policymap_verdict(pm, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS)
    p_v, p_r, p_c = policymap_verdict_plain(pm, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS)
    err = max(max_abs_err(k_v, p_v), max_abs_err(k_r, p_r), max_abs_err(k_c, p_c))
    pm_bytes = nbytes(pm.id_bits, pm.col_ep, pm.col_port, pm.col_proto, pm.col_is_l3, src_rows,
                      *flow_t, denied, k_v, k_r, k_c)
    b_ms, b_by = bound(pm_bytes, 0)
    row("policymap_verdict", "cilium_tpu_torch/csrc/policymap_verdict.cu",
        "cilium_tpu/ops/lookup.py:146", err,
        lambda: policymap_verdict(pm, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS),
        lambda: policymap_verdict_plain(pm, src_rows, *flow_t, denied_pf=denied,
                                        ep_count=N_ENDPOINTS),
        b_ms, b_by, f"{BATCH} flows, id_bits {list(pm.id_bits.shape)}, {pm.col_ep.shape[0]} columns",
        graph=True)

    # K4 attribution entry over the batch, the attributed pipeline's rule table
    rule_tab = apipe._rule_tabs[TRAFFIC_INGRESS]
    pm_a = apipe._tables[(TRAFFIC_INGRESS, 4)].policymap
    k_out = policymap_verdict(pm_a, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS,
                              rule_tab=rule_tab, n_rules=n_rules)
    p_out = policymap_verdict_plain(pm_a, src_rows, *flow_t, denied_pf=denied,
                                    ep_count=N_ENDPOINTS, rule_tab=rule_tab, n_rules=n_rules)
    err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
    rule_k, l4x_k, hits_k = k_out[3], k_out[4], k_out[5]
    # rule_tab cells read: at least one per distinct (identity row,
    # endpoint) of the flows a rule decided (endpoints own disjoint columns)
    decided = rule_k >= 0
    rt_cells = torch.unique(src_rows.long()[decided] * N_ENDPOINTS + flow_t[0].long()[decided]).numel()
    b_ms, b_by = bound(pm_bytes + nbytes(rule_k, l4x_k, hits_k) + 4 * rt_cells, 0)
    row("policymap_verdict_attrib", "cilium_tpu_torch/csrc/policymap_verdict.cu",
        "cilium_tpu/ops/lookup.py:202", err,
        lambda: policymap_verdict(pm_a, src_rows, *flow_t, denied_pf=denied,
                                  ep_count=N_ENDPOINTS, rule_tab=rule_tab, n_rules=n_rules),
        lambda: policymap_verdict_plain(pm_a, src_rows, *flow_t, denied_pf=denied,
                                        ep_count=N_ENDPOINTS, rule_tab=rule_tab, n_rules=n_rules),
        b_ms, b_by, f"{BATCH} flows, rule_tab {list(rule_tab.shape)}, {n_rules} rules, "
        f"{rt_cells} (row, endpoint) rule cells read", graph=True)

    # K5 lpm_stride8 over the v6 batch: identity trie and fused trie, then
    # an edge trie with no elision (K = 0, 16 levels)
    peer6 = torch.from_numpy(addr6).to(dev)
    for name, prefix in (("no-prefilter", "ip"), ("prefilter", "merged")):
        t = pipes[name]._tables[(TRAFFIC_INGRESS, 6)]
        tabs = [getattr(t, f"{prefix}_{f}") for f in ("child", "info", "common")]
        b_ms, b_by = bound(stride8_touched_bytes(*tabs, peer6, 16), 0)
        row("lpm_stride8", "cilium_tpu_torch/csrc/lpm_stride8.cu", "cilium_tpu/ops/lpm.py:144",
            max_abs_err(elided_lookup(*tabs, peer6, 16), lpm_stride8_plain(*tabs, peer6, 16)),
            lambda: elided_lookup(*tabs, peer6, 16), lambda: lpm_stride8_plain(*tabs, peer6, 16),
            b_ms, b_by, f"{BATCH} addresses, {prefix} trie [{tabs[0].shape[0]}, 256], "
            f"K {tabs[2].shape[0]}", graph=True)
    edge = [f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128" for i in range(len(idents))]
    ech, ein, ecom = build_trie_elided([(c, i) for i, c in enumerate(edge)] + [("2000::/3", 9999)])
    if ecom.shape[0] != 0:
        fail("the edge v6 trie kept shared bytes")
    tabs = [torch.from_numpy(a).to(dev) for a in (ech, ein, ecom)]
    b_ms, b_by = bound(stride8_touched_bytes(*tabs, peer6, 16), 0)
    row("lpm_stride8", "cilium_tpu_torch/csrc/lpm_stride8.cu", "cilium_tpu/ops/lpm.py:144",
        max_abs_err(elided_lookup(*tabs, peer6, 16), lpm_stride8_plain(*tabs, peer6, 16)),
        lambda: elided_lookup(*tabs, peer6, 16), lambda: lpm_stride8_plain(*tabs, peer6, 16),
        b_ms, b_by, f"{BATCH} addresses, edge trie [{tabs[0].shape[0]}, 256], K 0, 16 levels",
        graph=True)

    # K3 / K5 on the tries the sparse phase patched
    sparse_rows(sp, dev, row)

    # K11 shed_walk, both entries, over the gate's deny-heavy batches
    shed_rows(sub, dev, row)

    # K12 ident_gather over the ident shards of the mesh phase's policymap
    mesh_rows(ms, row)

    # K6 first_rule at the sweep's block shape: the deny term of the
    # first 8192 sweep flows (endpoint 0's L3 segment x identity rows)
    origin, _ = engine.attribution(True)
    nrow = compiled.id_bits.shape[0]
    sb = 8192
    subj8 = unpack_bits_u32(device.sel_match[torch.full((sb,), int(compiled.rows_for(endpoints[:1])[0]),
                                                        device=dev, dtype=torch.long)])
    peer8 = unpack_bits_u32(device.sel_match[torch.arange(sb, device=dev) % nrow])
    mask = subj8.to(torch.bool) & bool_mm(peer8, t_in.allow_t)
    k6_row(row, "sweep block, allow term", [(mask, origin.allow_rule)],
           max_abs_err(first_rule(mask, origin.allow_rule), first_rule_plain(mask, origin.allow_rule)))

    # K2 and K6 at the shapes the row and column patches give them
    delta_rows(dl, row)

    # the attribution flow-route sweep, one direction at full width; its
    # plain version runs the same sweep with the plain K2 and K6
    # (the segments materialize_endpoints_state sweeps: each endpoint's
    # L3 segment, then one per L4 slot)
    ep_rows = compiled.rows_for(endpoints)
    ep_sel = device.sel_match[torch.from_numpy(ep_rows.astype(np.int64)).to(dev)]
    ep_sel = ep_sel.cpu().numpy().view(np.uint32)
    segs = []
    for e, r in enumerate(ep_rows):
        segs.append((int(r), 0, 0, False))
        segs += [(int(r), port, proto, True)
                 for port, proto in matmod._endpoint_slots(compiled, ep_sel[e], True)]
    seg = [torch.from_numpy(np.asarray(col, dt)).to(dev)
           for col, dt in zip(zip(*segs), (np.int32, np.int32, np.int32, bool))]

    def sweep():
        return matmod._sweep_device_attrib(device, *seg, origin, nrow, True, 8192, n_rules)

    def sweep_plain():
        real = (verdictmod.bool_mm, verdictmod.first_rule_terms)
        verdictmod.bool_mm, verdictmod.first_rule_terms = bool_mm_plain, first_rule_terms_plain
        try:
            return sweep()
        finally:
            verdictmod.bool_mm, verdictmod.first_rule_terms = real

    k_out, p_out = sweep(), sweep_plain()
    err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
    n_flows = seg[0].shape[0] * nrow
    b_ms, b_by = bound(nbytes(device.sel_match, *k_out), sweep_ops(t_in, n_flows))
    row("sweep_device_attrib", "cilium_tpu_torch/ops/materialize.py",
        "cilium_tpu/ops/materialize.py:163", err, sweep, sweep_plain, b_ms, b_by,
        f"{seg[0].shape[0]} segments x {nrow} identity rows = {n_flows} flows, K2 + K6",
        iters=1, plain_iters=1, reps=3)

    # K6 on one three-term launch of the sweep (its first block)
    with CallRecorder([(verdictmod, "first_rule_terms")], keep=1) as rec:
        sweep()
    (terms,), _ = rec.calls["first_rule_terms"][0]
    k6_row(row, "sweep block, its three terms (deny, pure-L3 allow, L4 combo)", list(terms), 0)

    # where the attributed sweep's time goes: CUDA events around every K2
    # and K6 launch of one sweep (the events add their own host work), the
    # wall on the host clock and the device span from the first event to
    # the last
    for rep_ in range(3):
        torch.cuda.synchronize()
        with KernelClock(("bool_mm",)) as k2c, KernelClock(("first_rule",)) as k6c:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            sweep()
            ev[1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        k2_ms, k6_ms = k2c.ms(), k6c.ms()
        print(f"attributed sweep split (run {rep_}): wall {wall!r} ms, device span "
              f"{ev[0].elapsed_time(ev[1])!r} ms; K2 {len(k2c.pairs)} launches {k2_ms!r} ms, K6 "
              f"{len(k6c.pairs)} launches {k6_ms!r} ms (CUDA events around each launch), the "
              f"rest {wall - k2_ms - k6_ms!r} ms (host work and the torch ops between) [{card}]",
              flush=True)

    # the plain flow-route sweep (_sweep_device, no attribution) at the
    # same segments: off the main paths, timed once for its row
    def sweep_flow():
        return matmod._sweep_device(device, *seg, nrow, True, 8192)

    def sweep_flow_plain():
        real = verdictmod.bool_mm
        verdictmod.bool_mm = bool_mm_plain
        try:
            return sweep_flow()
        finally:
            verdictmod.bool_mm = real

    err = max(max_abs_err(a, b) for a, b in zip(sweep_flow(), sweep_flow_plain()))
    if err:
        fail("sweep_device disagrees with its plain version")
    ms, clk = timed(sweep_flow, iters=1, reps=3)
    plain_ms, _ = timed(sweep_flow_plain, iters=1, reps=3)
    b_ms, b_by = bound(nbytes(device.sel_match, *sweep_flow()), sweep_ops(t_in, n_flows))
    print(f"sweep_device (no attribution, off the main paths) {seg[0].shape[0]} segments x {nrow} "
          f"identity rows = {n_flows} flows, K2: max_abs_err {err}, ms {median(ms)!r} {ms} (SM "
          f"clock after: {clk}), plain_ms {median(plain_ms)!r} {plain_ms}, bound_ms {b_ms!r} "
          f"({b_by}) [{card}]", flush=True)

    # K7 / K8 on the bench's L7 corpus (bench.py:266-430): the unfused
    # walk at max_len 64 over int32 bytes (the l7_dfa_rps definition),
    # then the fused entry and the pair walk at every length rung over the
    # same corpus padded to the rung
    mdfa = compile_patterns(L7_PATHS)
    l7_paths = [f"/api/v{i % 8}/obj{i % 97}".encode() for i in range(L7_BATCH)]
    sb, lens = strings_to_batch(l7_paths, 64)
    trans, alo, ahi, start = device_dfa(mdfa)
    sb_t, lens_t = torch.from_numpy(sb).to(dev), torch.from_numpy(lens).to(dev)
    args7 = (trans, alo, ahi, start, sb_t, lens_t, 64)
    plain7 = (trans, alo, ahi, start.expand(L7_BATCH), sb_t, lens_t, 64)
    k_out = dfa_match_batch(*args7)
    if not bool((k_out[0] != 0).all()):
        fail("a bench corpus path matched no pattern")
    b_ms, b_by = bound(dfa_touched_bytes(trans, start.reshape(1), sb_t, lens_t, 64, False), 0)
    row("dfa_walk", "cilium_tpu_torch/csrc/dfa_walk.cu", "cilium_tpu/ops/dfa.py:104",
        max(max_abs_err(a, b) for a, b in zip(k_out, dfa_walk_plain(*plain7))),
        lambda: dfa_match_batch(*args7), lambda: dfa_walk_plain(*plain7), b_ms, b_by,
        f"{L7_BATCH} paths, int32 bytes, max_len 64, Q {trans.shape[0]}", graph=True)
    table = DeviceDFATable(("bench-l7",), fuse_dfas([mdfa]))
    if not table.has_pair:
        fail("the bench corpus's fused table has no pair table")
    if table.class_trans is None:
        fail("the bench corpus's table has no class table")
    bcls = (table.byte_class, table.class_trans)
    print(f"bench corpus pair table [{table.n_states}, 257 x 257] ({nbytes(table.pair)} bytes); "
          f"class table {list(table.class_trans.shape)} ({table.class_bytes} bytes with its "
          f"class map)", flush=True)
    st = torch.from_numpy(np.repeat(table.starts_host, L7_BATCH)).to(dev)
    for rung in L7_LEN_LADDER:
        rp = l7_paths if rung == L7_LEN_LADDER[0] else [(x + b"x" * rung)[:rung] for x in l7_paths]
        usb, ul = (torch.from_numpy(a).to(dev) for a in strings_to_batch_u8(rp, rung))
        a8 = (table.accept_lo, table.accept_hi, st, usb, ul, rung)
        # K8 on the pair table (bound on the pair table's entries), then
        # K7 on the same rows: its [Q + 1, 256] table and its byte classes
        # in shared memory (the L7 pipeline's walk of this table from
        # 16-byte rows: ops/dfa.py l7_walk_route)
        for name, rep, fn, plain, tab, pair, what in (
            ("dfa_pair_walk", ":264", dfa_match_batch_pair, dfa_pair_walk_plain, table.pair,
             True, "pair table"),
            ("dfa_walk_fused", ":236", dfa_match_batch_fused, dfa_walk_plain, table.trans, False,
             "[Q + 1, 256] table"),
            ("dfa_walk_fused", ":236",
             lambda tr, *a: dfa_match_batch_classes(tr, *bcls, *a), dfa_walk_plain, table.trans,
             False, "byte classes"),
        ):
            k_out = fn(tab, *a8)
            if not bool((k_out[0] != 0).all()):
                fail(f"{name}: a padded corpus path matched no pattern at rung {rung}")
            b_ms, b_by = bound(dfa_touched_bytes(tab, st, usb, ul, rung, pair), 0)
            row(name, f"cilium_tpu_torch/csrc/{'dfa_pair_walk' if pair else 'dfa_walk'}.cu",
                f"cilium_tpu/ops/dfa.py{rep}",
                max(max_abs_err(x, y) for x, y in zip(k_out, plain(tab, *a8))),
                lambda fn=fn, tab=tab, a8=a8: fn(tab, *a8),
                lambda plain=plain, tab=tab, a8=a8: plain(tab, *a8), b_ms, b_by,
                f"{L7_BATCH} paths, uint8 bytes, rung {rung}, Q {table.n_states}, {what}",
                graph=True)
    # K7's fused entry on the pattern-cap policy's table (Q 735, no pair
    # table) over its main-path batch packed as submit() packs it, in
    # one launch, through its class table as the pipeline walks it (the
    # pipeline launches it in 16 384-row chunks: walk_rows)
    ptab = l7res["pol_b"]._fused_table
    reqs_b = l7res["reqs_b"]
    cols = [[q.method.encode() for q in reqs_b], [q.path.encode() for q in reqs_b],
            [q.host.encode() for q in reqs_b]]
    flat = cols[0] + cols[1] + cols[2]
    rung = len_rung(min(max(map(len, flat)), 256), 256)
    usb, ul = strings_to_batch_u8(flat, rung)
    ul[:L7_BATCH][ul[:L7_BATCH] > 16] = -1
    usb, ul = torch.from_numpy(usb).to(dev), torch.from_numpy(ul).to(dev)
    st = torch.from_numpy(np.repeat(ptab.starts_host, L7_BATCH)).to(dev)
    a8 = (ptab.accept_lo, ptab.accept_hi, st, usb, ul, rung)
    if ptab.class_trans is None:
        fail("the pattern-cap policy's table has no class table")
    cap_cls = (ptab.byte_class, ptab.class_trans)
    k_out = dfa_match_batch_classes(ptab.trans, *cap_cls, *a8)
    b_ms, b_by = bound(dfa_touched_bytes(ptab.trans, st, usb, ul, rung, False), 0)
    row("dfa_walk_fused", "cilium_tpu_torch/csrc/dfa_walk.cu", "cilium_tpu/ops/dfa.py:236",
        max(max_abs_err(x, y) for x, y in zip(k_out, dfa_walk_plain(ptab.trans, *a8))),
        lambda: dfa_match_batch_classes(ptab.trans, *cap_cls, *a8),
        lambda: dfa_walk_plain(ptab.trans, *a8),
        b_ms, b_by, f"pattern-cap policy: {len(flat)} rows (3 fields), rung {rung}, "
        f"Q {ptab.n_states}, class table {list(ptab.class_trans.shape)}", plain_iters=2, reps=3,
        graph=True)

    walk_rows(l7res["walks"], row)

    lb_rows(svc, row, card)
    ct_step_rows(dct, dev, row)

    # one JSON entry per kernel: a kernel timed on several inputs keeps
    # its first input's numbers and the largest error of all its checks
    total = {k: sum(p.get(k, 0) for p in launches.values()) for k in _kernels.launches()}
    total["sweep_device_attrib"] = sweeps.get("flow_attrib", 0)
    if total["ct_probe_claim"] != total["ct_commit"]:
        fail(f"K10's entries launched {total['ct_probe_claim']} and {total['ct_commit']} times")
    total["ct_step"] = total["ct_probe_claim"]
    by_name = {}
    for r in rows:
        if r["name"] in by_name:
            by_name[r["name"]]["err"] = max(by_name[r["name"]]["err"], r["err"])
        else:
            by_name[r["name"]] = dict(r)
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{median(r['library_ms'])!r} {r['library_ms']}"
        if r["library_graph_ms"] is not None:
            lib += f" (in a CUDA graph {median(r['library_graph_ms'])!r} {r['library_graph_ms']})"
        share = f"bound share {r['bound_ms'] / median(r['ms'])!r}"
        graph = "" if r["graph_ms"] is None else (
            f", in a CUDA graph (no wrapper host work) {median(r['graph_ms'])!r} {r['graph_ms']}")
        if r["graph_ms"] is not None:
            share += f" ({r['bound_ms'] / median(r['graph_ms'])!r} in the graph)"
        if r["route"] is not None:
            graph += f", route {r['route']}"
        note = "" if r["note"] is None else f" ({r['note']})"
        print(f"kernel {r['name']:<24} {r['shape']}: launches {total[r['name']]}, "
              f"max_abs_err {r['err']}, ms {median(r['ms'])!r} {r['ms']} (SM clock after: "
              f"{r['clock']}){graph}, plain_ms {median(r['plain_ms'])!r} {r['plain_ms']} (SM "
              f"clock after: {r['plain_clock']}), library_ms {lib}, bound_ms {r['bound_ms']!r} "
              f"({r['bound_by']}){note}, {share} [{card}]", flush=True)
        if r["err"] != 0:
            fail(f"kernel {r['name']} disagrees with its plain version")
        if total[r["name"]] <= 0:
            fail(f"kernel {r['name']} has no launch on a main path")
    torch.cuda.synchronize()
    watch.check("end", faults_expected)
    phase("5 kernel rows")
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": total[r["name"]],
            "max_abs_err": r["err"], "ms": median(r["ms"]),
            "plain_ms": median(r["plain_ms"]), "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None if r["library_ms"] is None else median(r["library_ms"]),
        }
        for r in by_name.values()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
