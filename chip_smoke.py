#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``m3_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--seed 0] [--series 100000] [--points 720]
                          [--agg-series 1000000] [--drain-series 100000]

Phases (any failure exits non-zero; nothing is caught and passed over):

1. print the card's name and power limit; build the four CUDA kernels
   from ``m3_tpu_torch/csrc`` with nvcc for sm_90a (in parallel) and
   print their ``-Xptxas -v`` reports;
2. hold each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, with the edge cases (keys out of
   range, widths 0 and 64 and out of range, offsets in the zero pad and
   negative, words with bit 63 set);
3. the main path: ``encode_batch`` then ``decode_batch`` on the card at
   S series x T points (the JAX package's flush setting ``out_words =
   max(16, T*40//64 + 8)``) over a seeded mix of counters, decimal gauges,
   dyadic random walks, constants and NaN-bearing series with jittered
   timestamps; every non-fallback series must round-trip exactly, the
   fallback share must stay under 5 %, both kernels must have launched,
   and a slice must give the same bytes as the CPU path (a warm-up pass
   on 1,000 series x 32 points first: the lazy inits and the kernels'
   first loads);
4. golden bytes: the Go-encoded streams in ``tests/data`` decode and
   re-encode to identical bytes, and the arithmetic batch hashes to the
   pinned digest;
5. times: datapoints/s of each pass with its phase split; each kernel,
   on the very inputs the timed pass handed it, held bit-equal to its
   plain version once more and timed beside its bound, its plain
   version and the library call; peak device memory;
6. the aggregator's two kernels (``segment_ingest``, ``segment_minmax``),
   in place into non-zero state columns and in their fresh forms,
   against their plain versions run on CPU copies, int64 and float64,
   at the path's shape (10^6 unique slots of 2^21) and at a collision
   shape (2^20 points in 4096 slots), and at the path's shape with 64
   duplicate ids, with out-of-range and negative
   slots, NaN, -0, an empty batch and empty slots; bit for bit, each
   run twice, and the ulp distance of the f64 collision sums between
   the two runs printed (0: kernel #3 adds in arrival order);
7. the aggregator at full width (BASELINE configs #3 and #4): f64
   arenas, capacity 2^20, one 1 m window of 10^6 counters and 10^6
   gauges (six 10 s scrapes each) and 10^6 timers (ten scrapes), one
   scrape into the next window and a few samples too early or too far
   ahead; the first scrape through ``Aggregator.add_untimed_batch``, the
   rest through ``MetricList.add_batch_slots``; ``consume`` checked
   against a numpy oracle built from the same samples, and both kernels
   must have launched;
8. drain -> encode -> decode: 10^5 gauges at 10 s under 1m:2d through
   120 windows (a 2 h block) on the default (packed) arena layout, the
   drained LAST values (bit-exact in both layouts) encoded and decoded
   on the card, exact round trip, fallback under 5 %;
9. times: samples/s through the entry point and the hot loop, one
   scrape per type under torch.profiler (host routing, device busy and
   idle share), consume split into device lanes and host ``_emit``; each
   aggregator kernel on the inputs the arena handed it, from CUDA events
   around a CUDA graph of 20 calls: in place beside its bound (the
   points read once, each touched 32-byte sector of the state columns
   read and written once), its plain version, the library calls into
   the same columns, the arena step against the earlier composition
   (fresh output, then ``add_`` / ``maximum`` / ``minimum``), kernel
   #3 on the same scrape with 64 duplicate ids, and the fresh forms;
   peak device memory;
10. the aggregator at full width on the default arena layout (packed:
   sort, cumsum, segmented scan and dense merges; none of the four
   kernels, and none may launch): phase 7's configuration and traffic
   from the same seed, consume held against phase 7's f64 run within
   the cross-layout envelopes (counter lanes, gauge COUNT/MIN/MAX/LAST
   and timer COUNT exact; gauge sums and timer moments rtol 1e-6; timer
   values f32-rounded, rel 1e-6; timer stdev rtol 1e-5); then the first
   2^16 series of the same traffic on the card and on the CPU, every
   state field bit-equal after every scrape, with a scrape of 64
   duplicate ids per type and a counter batch outside int16 that
   promotes 1000 slots into the overflow pool, and the flushed rows;
11. times of the packed layout beside phase 7's f64 numbers: samples/s
   through the entry point and the hot loop, one profiled scrape per
   type (wall, host routing, device busy, idle share, device kernels
   and copies launched), consume split into device lanes and host
   ``_emit``, peak device memory;
12. the PromQL query path at BASELINE config #5's full width: 12,500
   groups x 8 ``le`` buckets = 100,000 cumulative counters, 261 samples
   at 15 s (the JAX bench's generator), ``histogram_quantile(0.99,
   rate(m3_req_bucket[5m]))`` over 1 h at 15 s steps (241) through the
   port's engine on the card under both precision policies; sampled
   groups against scalar Prometheus oracles (rtol 1e-6 for f64, 5e-3 for
   f32) and the first 512 groups against the port's CPU run (rtol 1e-12
   and 1e-5); eval wall (one timed run after a warm-up), its host split
   (exclusive rows that add up to the wall), the raw block's uploads
   timed on the card with CUDA events and, from a torch.profiler trace,
   the union of the other kernel and copy intervals: their sum is device
   busy; idle share (against the profiled wall, which the profiler
   lengthens, and against the best unprofiled wall) and device ops; then one
   query per temporal family and device function over the full block
   (time and peak memory) and on the first 256 groups card against CPU
   (exact, or the prefix-sum bounds of ``family_bound``);
13. bytes to quantiles: phase 12's counters encoded on the card (fallback
   share under 5 %), then ``decode_rate_hq``: decoded timestamps and
   value bits equal to the codec's host path (and to the generated
   values but for the few M3TSZ snaps to a decimal, a few ulp each), rates
   equal to the engine's f64 ``rate`` over the decoded samples bit for
   bit, hq equal to the engine's ``histogram_quantile(0.99, sum by (le)
   (rate(...)))`` within rtol 1e-12; kernel #2 must launch, and its own
   outputs on this path (100,000 streams x 262 points) must equal its
   plain version on the same inputs bit for bit; its time there, and the
   pipeline's (one timed run) and profile; then 66 buckets (past the masked
   sum's 64) on 2,112 streams, twice on the card and once on the CPU:
   rates, bucket sums (kernel #3 in arrival order) and hq bit-equal, and
   the bucket sum's time at the path's width;
14. the storage node's write -> flush -> read path at BASELINE config
   #2's shape with ``NamespaceOptions()`` defaults (2 h blocks, 48 h
   retention, bufferPast 10 m, bufferFuture 2 m, 4 shards, cold writes
   on) and the commit log on: 100,000 untagged gauges x 120 scrapes at
   10 s over the first 20 minutes of one 2 h block (phase 3's value mix;
   720 would fill it), 1 % rewritten at the
   same timestamp with another value, 0.1 % two hours late (cold lists)
   and 100 samples beyond bufferFuture; the first 5 scrapes through
   ``Database.write_batch`` (shard hash, slot resolve, commit log,
   buffer), the other 115 through each shard's ``buffer.write`` with
   the slots resolved; ``tick`` past the block's end plus bufferPast
   (drain sort, ``encode_batch`` with kernel #1 held bit for bit
   against its plain version on its inputs, fileset write), late writes
   into the cold block and a tick (its volume 1), a tick past the next
   block; every volume decoded on the card (kernel #2, held against its
   plain version) equal bit for bit to a last-write-wins oracle of
   everything acknowledged; ``read_batch`` of 1,000 series equal to the
   oracle; snapshot and cleanup, then 10 scrapes (100 s, 1,000,000
   samples) of the next block through ``Database.write_batch``, left
   unflushed, and a restart whose ``bootstrap()`` replays their commit
   log into the card's buffers; the same reads, now over that block
   too, equal to the oracle; a card and a CPU Database fed the same 1,024 series
   x 64 scrapes write identical volume files (sha256); entry and hot
   samples/s with the entry's host rows, device time per append (CUDA
   events), one profiled scrape, drain and encode times per shard,
   fileset write time, peak memory;
15. PromQL over the storage node: phase 12's config #5 counters written
   into one open block (the first 2 scrapes through
   ``write_tagged_batch``, index insert and commit log; the rest through
   the shard buffers), then ``histogram_quantile(0.99,
   rate(m3_req_bucket[5m]))`` over 1 h at 15 s through
   ``Engine(DatabaseStorage(db))`` on the card: (a) from the open block,
   equal bit for bit to the engine over the in-memory block; (b) after
   the flush, over the 1 % of groups whose label ends in 00, equal to
   (a) within rtol 1e-12, its points read equal bit for bit to the
   codec's host decode of the volumes; eval wall with the host rows
   (index query, per-series reads, upload), device busy, peak memory;
16. the coordinator downsampler at BASELINE config #3's width: 1,000,000
   counters ``http_requests_total`` over {app: 100, endpoint: 20,
   status_code: 5, instance: 100}, integer deltas in [0, 1000), 10 s
   scrapes over two one-minute windows (two scrapes a window, cut from
   six, so each window folds two deltas a series), all through
   ``Downsampler.write_batch`` on the card, with M3's
   documented coordinator rules: a mapping rule to ``1m:48h``, a rollup
   to Sum by (app, endpoint, status_code) then Add, and a two-stage
   rollup (by route, then Sum by app, one window later), into a storage
   node whose output namespace ``1m:2d`` was made with
   ``ensure_namespace``; every flushed row against a numpy oracle; a
   checkpoint after the third scrape (window 2 half open)
   restored into a fresh Downsampler
   (sharing the first one's rule-match cache) that takes the later
   scrapes: its flushed batches equal the uninterrupted run's bit for
   bit; a tick past the block's end plus bufferPast warm-flushes the
   output namespace (kernel #1 held against its plain version on its
   inputs) and every volume, decoded on the card (kernel #2, held
   likewise), equals the oracle; the same rules over the first 2^12
   series and one window (two scrapes) on the card and on the CPU write
   sha256-identical files;
   write_batch samples/s with host rows (match, grouping, resolve, arena
   add), flush seconds a window with consume, ``_apply_tails`` and
   writeback, checkpoint bytes and seconds, one profiled write_batch,
   peak memory;
17. the aggregator's entry point with the native resolver
   (``MetricMap(use_native=True)``: a build failure fails the phase)
   against the Python one on phase 7's traffic (the first scrape a type):
   the same slots, samples/s of each; then 10^5 counters on four shards
   whose two-stage Sum tails forward by the next stage's id, on the f64
   layout (kernels #3 and #4 held against their plain versions on every
   call) and on the packed one: every stage-2 total exact, no stage-1
   aggregate flushed locally;
18. the node through its entry points: (a) ``run_node(NodeConfig(...))``
   on the card (namespace ``default`` at the defaults, commit log on,
   the coordinator on an ephemeral port, the mediator on with a tick the
   phase drives through ``run_once``) fed phase 12's 100,000 counters,
   21 scrapes at 15 s (2.1M samples), as 1,050 Prometheus remote-write
   requests of 2,000 samples (snappy + protobuf from the port's
   ``build_write_request``; three processes, started with the script,
   build them, as senders would); ``GET /api/v1/query_range`` of ``histogram_quantile(0.99,
   rate(m3_req_bucket[5m]))`` over the last minute at 15 s with
   ``timeout=`` set, 64 groups held against the scalar oracles within
   rtol 1e-6; ``/api/v1/query`` at one instant, a remote read of 100
   series and ``/api/v1/series`` and ``/labels`` against the data
   written, bit for bit; ``run_once`` past the block's end plus
   bufferPast (warm flush of each shard, kernel #1 held bit for bit
   against its plain version on every launch), the node's volumes
   decoded on the card (kernel #2, held likewise) against the data
   written (M3TSZ's decimal snaps within 1e-15 relative, and bit-equal
   to the CPU decode); the query again over the 1 % of groups whose
   label ends in 00, from the filesets, within rtol 1e-12 of before;
   ``/metrics`` (``m3tpu_db_writes_tagged`` equal to the samples
   acknowledged, no ``*_errors``) and ``/health``; one scrape into the
   next block, ``Assembly.close()`` and ``run_node`` again on the same
   root (commit-log replay, filesets): the same answers; (b)
   ``python -m m3_tpu_torch.server.node_main <config>`` as a subprocess
   on the card: ``node.json``, ``/health``, one remote write, a
   ``query_range`` within rtol 1e-12 of (a)'s, a remote read bit for
   bit, and SIGTERM: a drain and exit 0 within 60 s, with no failed
   drain stage in its log and the drain's fileset volumes, decoded,
   equal to the samples written; requests/s and
   samples/s with the node's host split (snappy, protobuf, documents,
   ``write_tagged_batch``), the first request alone, the query's wall
   with its host rows (index, reads, eval, handler, JSON), the device
   idle share of one profiled write request and of the query, flush,
   bootstrap, peak memory.

19. the aggregator tier at BASELINE config #3's width: 1,000,000 series
   (500,000 counters, 500,000 gauges), each sampled every 10 s: two of
   the six scrapes that fill one 1 m window (cut from six) and the first
   of the next (3M samples), sent by an ``AggregatorClient`` (one-instance
   placement of 64 shards, murmur3 routing, per-frame acks) as
   METRIC_BATCH frames of at most 2^16 samples (the client queue's
   default size, which one flush drains as one frame) to
   an ``IngestServer`` on localhost feeding ``aggregator_sink`` in front
   of the aggregator on the card (64 shards, packed layout, native
   resolver, 2^15 slots a type a shard, ``1m:48h``); a ``FlushManager``
   ticking as leader on a flush thread under the sink's lock publishes
   each closed window's rows as PASSTHROUGH_BATCH payloads on a
   ``BusServer`` topic (``aggregated_metrics``, SHARED ``coordinator``),
   and a ``RemoteBusConsumer`` polls and acks them; acked == sent, every
   flushed (id, window) value equal to a numpy oracle bit for bit, every
   message delivered once and none left unacked; window 1 through the
   HOPS tail (reshape, ``encode_batch`` with kernel #1 held against its
   plain version, ``DataFileSetWriter``) and decoded on the card (kernel
   #2, held likewise) equal to the flushed values; the first 2^14 series
   through the same server code on the CPU: the same rows and a
   sha256-equal volume; (a) the pinned HOPS corpus through
   ``m3_tpu_torch.tools.hops`` on the card, its volume's sha256 equal to
   the JAX package's; (b) an HA pair (mirrored placement of 8 shards,
   RF 2, two servers on one KV) fed 100,000 counters for three windows, the leader
   resigning in the second: the union of emitted windows equals a
   single instance's run; (c) ``max_queue_frames=2`` under six clients:
   BACKOFFs, parked and retried frames, every acknowledged sample in the
   flush; TIMED_BATCH, PASSTHROUGH_BATCH and FORWARDED_BATCH frames of
   10,000 samples card == CPU; samples/s with the host split (client
   routing, frame encode, server decode, the sink's shard routing,
   resolver and arena, queue wait), one profiled frame, consume a
   window, bus and volume seconds, kernel #1's time at the flush's
   shapes, each HOPS hop's wall and share, peak memory.

20. the device mesh on the card as a repeated device list (one process;
   each mesh device's program runs on it in turn; collectives reduce in
   shard order): (a) the sharded aggregator step at BASELINE config #3's
   width, 10^6 series routed by murmur3 to 8 shards of 2^17 slots, three
   samples a series (two in window 0, one in window 1), each a counter,
   a gauge and a timer value at one slot, on the packed layout and then
   the f64 one (kernels #3 and #4, each launch held bit for bit against
   its plain version on CPU copies): every shard's lanes equal to a
   one-device arena run on its samples, the cross-shard rollup to a
   numpy oracle added in shard order, ``err`` 0, window 1's samples
   left; the first 2^14 series card against CPU, every lane and state
   tensor bit for bit; over distinct cards where the machine has two or
   more (else logged as not run); (b) a 4 x 2 mesh at 2^16 series:
   ``replica_divergence`` all False, one flipped bit in one replica
   turns exactly that shard's two ring edges True, ``quorum_ack`` equal
   to numpy; (c) the sharded codec at config #2's width over two shards
   (S = 100,000, T cut to 120): words, ``total_bits`` and fallback equal
   to the one-device encode, the finalized streams' decode equal to the
   one-device decode on every output (kernels #1 and #2 held against
   their plain versions on every launch), the pinned batch over three
   shards hashing to the pinned digest, ``chains="fused"`` equal to
   ``"gather"`` on 2^12 streams; (d) ``sharded_decode_rate_hq`` at
   config #5 over four shards against ``single_device_reference``
   (rates rtol 1e-14, hq rtol 1e-12, errs exactly) and card against CPU
   on 128 streams a shard, bit for bit.  Each part's wall, launches and
   peak memory.

21. the replicated storage cluster, M3's documented setup: a placement
   of 64 shards at RF 3 over three dbnodes, one to an isolation group,
   in a ``KVServer`` (the etcd role) that every node and the session
   reach through ``RemoteKVStore``; each node ``run_node`` in this
   process (the port's ``Database`` on the card, on card k where the
   machine has three, its ``TopologyWatcher``, ``ShardMigrator`` and
   ``DbNodeRpcServer`` on loopback); ``ReplicatedSession.dynamic`` on the
   placement, writes at MAJORITY and reads at UNSTRICT_MAJORITY, one
   scrape a ``write_batch``, config #2's width (100,000 gauges every
   10 s from a block boundary): (a) scrapes with all three up, acked ==
   sent, each node owning its placement's shards; (b) C's RPC listener
   stopped, scrapes acked by A and B; (c) A and B ticked past the
   block's end (warm flush of 64 shards each, kernel #1 held against its
   plain version on every launch), C wiped and restarted with ``db.peers``
   and ``bootstrap_peers``: the three nodes' fileset files sha256-equal
   to each other and to one port ``Database`` of 64 shards fed the same
   scrapes; (d) every replica's volumes decoded on the card (kernel #2,
   held likewise) equal to the acked samples, and 1,000 seeded series
   through ``fetch_batch`` equal to them, each point once; (e) D joins
   through ``add_instance``, the mediators stream its shards from the
   donors over RPC (digest-verified), cut over by CAS and drop after the
   grace ticks: D's files sha256-equal to the donors', reads equal; (f)
   repair at 2^10 series (64 shards, RF 3): C misses 6 scrapes and
   rejoins from its own commit log, ``repair_namespace`` over three
   ``RemoteDatabase`` handles converges the replicas, and the card's
   files are sha256-equal to the same run's on the CPU (in a spawned
   process beside (a)-(e)).  Each part's wall, samples/s, flush and
   bootstrap seconds, the migration's blocks and seconds, peak memory,
   launches.

22. the device boundary and the control plane, in a lane (below) whose
   caching allocator runs in expandable segments: (a) a ``ShardBuffer``
   whose first tensor alone is larger than the card, with no budget: ``DeviceOOM`` caused by torch's
   OutOfMemoryError, counted on ``storage.buffer_append`` and opening its
   breaker, ``memory_allocated()`` unchanged; (b) the six arenas at 10^6
   slots (both layouts), the buffer at 100,000 series and the decoder's
   control table: one byte under its footprint ``device.mem_budget``
   refuses each before the card allocates, at the footprint each builds
   and ``memory_allocated()`` grows by the footprint to the byte; the
   encode and decode passes at config #2's 100,000 x 720 under
   transient reservations that cover their measured peaks (ratios
   printed); then the phase's main path, every launch counted: one
   scrape of 10^6 counters and one of 10^6 gauges through the
   ``arena.ingest`` stage of the f64 arenas (kernels #3 and #4 held
   against their plain versions), consumed and checked; (c) a node on
   the card (``run_node``, config #2's 100,000 gauges as JSON writes):
   ``device.dispatch`` armed through ``POST /api/v1/debug/faults``, each
   write of a scrape refused 503 and none acknowledged, the stage's
   breaker open on ``/health``; disarmed, after ``breaker_reset``, a
   scrape acknowledged and the breaker closed; ``/health``'s
   ``device.membudget`` equal to the ledger; the flush (kernel #1 held
   against its plain version) and every volume decoded on the card
   (kernel #2, held likewise) equal to exactly the acknowledged scrapes;
   (d) the same node configuration with ``selfmon`` and ``controller``
   on and a 1 s mediator tick, taking config #2 scrapes: a
   ``query.fetch`` latency fault past 1 s burns the query SLO, the
   controller sheds ``query_slots`` to its floor and, disarmed, relaxes
   them to their baseline; ``/health`` serves ``slo`` and ``controller``
   (no ``device_fallback``); the self-monitoring series, on the card,
   answer PromQL; (e) ``/debug/dump`` is a zip of the reference's
   members.  Each part's wall, the footprints, the transient ratios.

23. query federation and the Graphite front door: (a) after phase 22 in
   its lane, a node on the card (``run_node`` with
   ``coordinator.carbon_listen_port``) takes config #2's width as carbon
   plaintext over TCP: 100,000 paths ``m3.dc{0..3}.host{0..249}.{metric}``
   (100 metric names), 12 scrapes at 10 s from a block boundary (cut
   from 720), one connection a scrape; ``/render`` of six targets
   (``sumSeries`` over 250 series, ``groupByNode`` over 1,000,
   ``aliasByNode(highestAverage(...))``, ``movingAverage``, ``summarize``,
   ``asPercent``), graphite-web's ``"sumSeries"`` callback spelling (400,
   as the reference answers) and ``/metrics/find``, each against a numpy
   oracle of the sent lines (rtol 1e-12) and byte-equal to a node on the
   CPU fed the lines of the 1,612 paths they read; every path read back
   through ``/render`` of its host's glob under its own name, bit for
   bit; ``run_once`` past the block's end plus bufferPast (warm flush,
   kernel #1 held against its plain version on every launch), every
   volume decoded on the card (kernel #2, held likewise) equal to the
   lines sent, and the renders again from the filesets (equal to before,
   and to the CPU's); (b) in a lane of its own, config #5's 100,000
   counters, 21 scrapes at 15 s,
   through ``write_tagged_batch`` into two nodes on the card: A (groups
   0-6,249, ``query.listen_port``) and B (the rest, ``query.remotes:
   [A]``); B's ``rate(...[5m])`` and ``histogram_quantile(0.99, sum by
   (le, group) (rate(...[5m])))`` over the last minute equal to one node
   holding all 100,000 series (rtol 1e-12), and on 128 groups of each
   half equal to the same pair on the CPU; then A's query server
   stopped: B answers its half with a ``warnings`` entry, a front door
   over B with ``remotes_required`` answers 502, and after
   ``breaker_failures`` (3) failures the peer's breaker opens and the
   next query fails fast.  Carbon lines/s, the flush, each render's wall
   and its ``GraphiteStorage.fetch`` share, each query's wall and its
   remote fetch's share.

24. the runtime instruments and the proto value codec, after phase 23
   (b) in its lane: (a) ``tools/hops.run_pipeline`` on the card under
   ``x/hopwatch`` (a cold pass counted, a steady pass timed and not
   counted, a steady pass counted; three volumes sha256-equal) for the
   pinned HOPS corpus (1,024 x 320; its volume the JAX digest) and at
   config #3's width (10^6 series x 20 s: two drained windows), with
   ``x/tracewatch``'s build budget installed; then one more steady pass
   under ``x/hopwatch`` with the launches counted from 0: kernel #1's
   grids in the encode hop equal ``encode_place.launches`` and no other
   hop launches a hand kernel, kernel #1 launched again on each call's
   inputs equals its plain version, no kernel is built; on the pinned
   corpus that pass runs under torch.profiler, and the trace's HtoD and
   DtoH memcpys equal the ledger's transfers in count and bytes, and
   every kernel in the trace belongs to a counted dispatch (the aten op
   that launched it, by the profiler's correlation) or is a hand kernel
   as many times as the ledger's grids; any difference is printed by
   seam; and a catalogue of every seam (each transfer, factory and
   implicit sync once, each in a hop of its own) traced the same way;
   (b) ``tracewatch.no_transfers()``: ``.cpu()``, ``.to("cpu")``,
   ``.item()``, ``.tolist()``, ``copy_`` both ways, ``torch.tensor`` and
   ``torch.as_tensor`` of a list, an ndarray's upload and the implicit
   syncs (``nonzero``, a boolean-mask index, ``masked_select``,
   ``unique``, ``repeat_interleave``) each raise ``TransferError`` on a
   CUDA tensor, kernels #1 and #2 launched on resident tensors inside the
   guard raise nothing and equal their plain versions, and
   ``allow_transfers()`` escapes it; (c) phase 19's threaded ingest and
   ticks at ``tests/test_torch_gpu.py``'s size (four clients, three
   windows, a flush thread) with ``x/lockcheck`` armed in raise mode: no
   inversion, and the rows equal a serial run's on the card and on the
   CPU; (d) config #2's 100,000 series x 720 points through
   ``encode_batch`` on the card with a schema annotation
   (``pack_schema_annotation`` on fixed descriptor bytes, no protobuf) on
   every series' first datapoint: kernel #1 equal to its plain version,
   fallback under 5 %, and every 100th series through the scalar decoder
   gives back the annotation bytes and every point.
25. the measuring tools, after phase 23 (a) in its lane: (a) the COSTS
   artifact (``tools/costs.build_artifact``: one counted eager run a
   registered stage at the canonical shapes, after a warm-up) built twice
   on the card, the two equal in every gated metric, the first green
   against ``m3_tpu_torch/tools/costs_baseline_cuda.json``, each stage
   launching exactly the kernels ``costwatch.STAGE_KERNELS`` names, every
   launch held bit for bit against its plain version on inputs kept on
   the host and checked after both builds, the membudget formulas within
   [1, 2] of their measured actuals and the census's step counts within
   10 % of the documented ones; (b) ``tools/decode_profile`` in both
   modes at config #2's width over phase 3's corpus (``PROFILE_REPS``
   timed runs, PERF.md §4), its layers nesting in dispatches a step, each
   mode reporting the native host codec's ``native_cpp_dps``; (c)
   ``tools/card_bisect`` at its default corpus (512 x 720): stages 1-5
   equal on the card and on the CPU, stage 6 equal; (d) the PromQL
   comparator on the card, its default corpus and a 256-series x 360-point
   one: no mismatch; (e) the host aggregator baseline (``native/aggproxy``,
   single-core C++) at configs #3/#4's 10^6 series, its seconds printed
   on lines of their own, its quantiles held to numpy's order statistics
   on a sample of ids.
26. the static and IR gates, in a lane of their own: (a) the port's
   m3lint (``x/lint.run_repo``) over ``m3_tpu_torch/`` on the card's
   machine, equal to the committed (empty) baseline; (b) the IRLINT
   artifact (``x/irlint.build_artifact``) on the card from one census
   build, each stage launching exactly the kernels
   ``costwatch.STAGE_KERNELS`` names, every launch bit-equal to its
   plain version (the census's inputs kept on the host, the residency
   pass's on the card), each 64-bit ceiling equal to the card's census,
   the op and 64-bit type census equal to the CPU's on the same machine
   once each launch's own census less its plain version's is taken off,
   but for the card's routes (a ``_to_copy`` per transfer, ``_sqrt``'s
   ``aten::sqrt``), the residency pass at ``irlint.PIPE`` equal to its
   per-hop ledger with the ingest -> drain seam composed, and the artifact green
   against ``m3_tpu_torch/tools/irlint_baseline_cuda.json``, its five
   rule counts printed; (c) the residency at config #3's width (10^6
   series, T cut to 10 s as in phase 24), every seam equal to the
   ledger, the drain -> encode bytes printed beside phase 24's, each
   kernel #1 launch bit-equal to plain; (d) the
   five seeded regressions, each flipping its rule on the card, and a
   baseline pinned to another card or torch refused.
27. the ops CLI and the distributed tests, in a lane of their own: (a)
   ``dtest/agent.serve_agent_background`` and one node on the card driven
   through ``AgentClient`` (setup, start, status, a write, kill, start
   with the write read back, logs, teardown), each answer checked; (b)
   ``dtest/soak.run_soak`` on the card (every node ``device=None``) at
   the reference's default shape (3 nodes at rf 3 and a spare, 8 shards
   of 2^18 slots, batches of 10,000, churn 0.02, the 200-series query
   corpus, the 2,000 x 3 historical corpus, the full timeline healthy ->
   wire_faults -> device_faults -> sigkill -> corrupt -> replace ->
   recovered, selfmon and the controller on) with ``series`` cut 10^6 ->
   5 x 10^4 and each window shrunk in proportion to at least 10 s (PERF.md
   §4): zero acked loss with both digests equal, every chaos event ok, a
   quiet controller, the SLO record, each first node's encode calls
   above 0 and refusals only in the device window and only on node 0;
   per phase the driver and fleet p50/p99, samples/s, the verify's
   seconds and each node's ``device_mem_peak_bytes`` printed, the
   soak's artifact and node logs kept under ``build/phase27/``; (c)
   ``tools/cli`` over the soak's kept node roots (``read_data_files``,
   ``read_index_files``, ``read_commitlog``, ``verify_data_files``,
   ``scrub --inventory``: the only corrupt volume the corrupt event's, in
   quarantine), every segment decoded on the card with ``decode_batch``
   equal to the CLI's scalar decode and the historical corpus to the
   ledger's values, then re-encoded with ``encode_batch`` at its block
   start into the same bytes, each kernel #1 and #2 launch bit-equal to
   plain; (d) ``cli lint --json`` and ``cli hops --check`` on the card
   against ``m3_tpu_torch/tools/hops_baseline_cuda.json``, both green.
   The lane runs (a), then waits for phase 23 (b) to pass in its lane
   before (d), (b) and (c): they load the host, and 23 (b)'s remote
   fetches time out at 30 s.
28. the native host codec (``m3_tpu_torch.native`` over
   ``csrc/m3tsz.cc``, built with g++ at first use), in phase 26's lane
   once phase 23 (b) has passed: (a) BASELINE config #1 at full width
   (one series of 10^6 gauge points at 10 s, ``bench.py``'s seed-5
   series): the native encode, best of 3, byte-equal to the port's
   scalar ``Encoder`` over every point, and the native decode exact in
   timestamps and value bits, each pass's datapoints/s printed with the
   stream bytes, the thread count, ``os.cpu_count()`` and the host CPU
   model; (b) config #2's corpus (``x/costwatch.bench_corpus(100_000,
   720)``): the native ``encode_batch`` byte-equal on every series to
   the card's (kernel #1), the card's ``decode_batch`` (kernel #2) and
   the native one equal to each other and to the corpus, no fallback on
   either side, each launch bit-equal to plain, both codecs' datapoints/s
   printed; (c) ``instrument/selfmon.measure_overhead`` on the card at
   the reference's defaults (4 s, batches of 2,000, 20,000 series, a
   2 s cadence), printed and not gated.  Host and card figures of this
   lane are taken beside other lanes (``shared_card``).

Order.  Phases 16, 18-19 and 22-28 run in lanes: spawned processes of
their own, started with the script (phase 18's request builders start in
its lane then), released after phase 11 and joined after phase 17.  The main
process meanwhile runs phases 12-15, 20 and 17, in that order; phase 21
runs last, alone on the card.  Each lane's wall, the main process's wait
for it and its peak host memory are printed, and each kernel record's
``shared_card`` names the phases that ran beside a phase of another
process: the kernel times taken in them were taken on a shared card.

Each kernel record carries ``launches`` (phase 3's pass or phase 7's
drive), ``query_launches`` (phase 13), ``storage_launches`` (phase
14's write, flush, read and restart: kernel #1 once per shard per warm
flush, no other), ``storage_check_launches`` (phase 14's volume
check: kernel #2), ``downsample_launches`` (phases 16-17; each must
be above 0), ``node_launches`` (phase 18's node: kernel #1 in the
flush) and ``node_check_launches`` (its volume check: kernel #2), and
``tier_launches`` (phase 19's main path: kernel #1 in the volume's
encode, kernel #2 in its check), and ``mesh_launches`` (phase 20's
main paths: kernels #3 and #4 in (a)'s f64 step, #1 in (c)'s encode,
#2 in (c)'s decode and (d)'s query), and ``cluster_launches`` (phase
21's (a)-(c): kernel #1 once per shard of A's and B's warm flushes) and
``cluster_check_launches`` (its volume check (d): kernel #2), and
``device_launches`` (phase 22's main path: #3 and #4 in the f64 ingest,
#1 in (c)'s flush, #2 in (c)'s volume check), and ``graphite_launches``
(phase 23's path: #1 in (a)'s flush, #2 in its volume check), and
``instrument_launches`` (phase 24's path: #1 in (a)'s encode hops and
(d)'s encode; none of #2-#4: the packed layout and the scalar decoder),
and ``measure_launches`` (phase 25's (a)-(d): all four in (a)'s census,
#1 and #2 in (b)'s profile and (c)'s bisector), and ``gate_launches``
(phase 26's (b)-(c): all four in (b)'s census, #1 in the residency
passes' encodes), and ``dtest_launches`` (phase 27 (c): #1 in the
re-encode, #2 in the decode of the soak's segments; none of #3-#4),
and ``native_launches`` (phase 28 (b): #1 in the card's encode, #2 in
its decode; none of #3-#4);
``shared_card`` names the phases whose kernel times were taken while a
lane ran beside them.
The last three lines are a JSON line of kernel records, the card's name
and power limit, and the result line ``{"ok": true, "device": {...}}``.
Exact comparisons throughout, except where a phase names its tolerance.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
PINNED_ENCODE_DIGEST = (
    "27ea67c4b75585a1e2bffa6cfeae5e5faeefbaca75de4d5c4c559f15d89ccc18")
SEC = 10**9
WARMUP_POINTS = 32  # of the codec pass's T, in phase 3's warm-up (PERF.md §4)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


_SIDE: list = []  # the one stream graph_ms warms up and captures on


def graph_ms(fn, reps: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around one replay
    of a CUDA graph that holds ``reps`` calls: no host launch gaps
    between the calls, so a call of tens of microseconds is timed on the
    card rather than on the host's launch rate.  With ``flush`` (a
    tensor larger than the L2 cache), each call is preceded by zeroing
    it, so the call finds its data in device memory, not in L2, and the
    graph of the zeroing alone is timed and subtracted."""
    import torch

    if flush is not None:
        return (graph_ms(lambda: (flush.zero_(), fn()), reps)
                - graph_ms(flush.zero_, reps))
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture, on the capturing stream (the
        # segment_ingest wrapper keeps its scratch per stream)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def make_batch(seed: int, S: int, T: int):
    """The main path's seeded data mix: ~40 % monotonic integer counters,
    ~30 % gauges with 1-2 decimals, ~25 % random walks on a 2^-7 grid in [16, 32)
    (no decimal multiplier finds them: the XOR path), and the rest
    constants and NaN-bearing gauges; 10 s cadence with whole-second
    jitter and rare long gaps so that every delta-of-delta bucket is
    hit."""
    rng = np.random.default_rng(seed)
    start = 1_700_000_000 * SEC
    step = 10 + rng.integers(-3, 4, (S, T))
    gap = rng.random((S, T))
    step = np.where(gap < 0.002, 200, step)      # 9-bit bucket
    step = np.where(gap < 0.001, 1500, step)     # 12-bit bucket
    step = np.where(gap < 0.0003, 4000, step)    # 32-bit default bucket
    ts = start + np.cumsum(step, axis=1, dtype=np.int64) * SEC
    fam = rng.random(S)
    vals = np.empty((S, T))
    c = fam < 0.40
    vals[c] = np.cumsum(rng.integers(0, 1000, (int(c.sum()), T)), axis=1)
    g = (fam >= 0.40) & (fam < 0.70)
    n = int(g.sum())
    x = 50 + rng.normal(0, 10, (n, T))
    vals[g] = np.where(rng.random(n)[:, None] < 0.5, np.round(x, 1), np.round(x, 2))
    w = (fam >= 0.70) & (fam < 0.95)
    n = int(w.sum())
    m = np.mod(512 + np.cumsum(rng.choice([-2, -1, 1, 2], (n, T)), axis=1), 1024)
    vals[w] = 16 + (2 * m + 1) / 128  # odd multiples of 2^-7: 7 decimals
    k = (fam >= 0.95) & (fam < 0.97)
    vals[k] = rng.integers(-5, 5, int(k.sum()))[:, None]
    nn = fam >= 0.97
    n = int(nn.sum())
    v = np.round(20 + rng.normal(0, 2, (n, T)), 1)
    v[rng.random((n, T)) < 0.01] = np.nan
    vals[nn] = v
    vals = vals + 0.0  # no -0.0: the int path canonicalizes it
    return ts, vals, np.full(S, start, np.int64)


def pinned_batch():
    """The arithmetic batch whose packed bytes the JAX suite pins."""
    S0 = 1_600_000_000 * SEC
    S, T = 8, 64
    i = np.arange(S, dtype=np.int64)[:, None]
    j = np.arange(T, dtype=np.int64)[None, :]
    ts = S0 + np.cumsum(((i * 37 + j * 11) % 29 + 1) * SEC, axis=1)
    vals = ((i * 131 + j * 17) % 4001 - 2000) / 8.0
    vals[2] = np.float64((j[0] * 7) % 1000)
    vals[5, 10:] = vals[5, 9]
    return ts, vals, np.full(S, S0, np.int64)


T0_AGG = 1_700_000_040 * SEC  # a minute boundary
MINUTE = 60 * SEC


def same_bits(a, b) -> bool:
    """Bit-equal, every NaN taken as one NaN."""
    import torch

    if a.dtype.is_floating_point:
        a = torch.where(torch.isnan(a), float("nan"), a).double()
        b = torch.where(torch.isnan(b), float("nan"), b).double()
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the entries where both are finite."""
    import torch

    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


def max_ulp(a, b) -> int:
    """Largest distance in units in the last place between two f64
    tensors of finite values of one sign (0 when bit-equal)."""
    import torch

    ok = torch.isfinite(a) & torch.isfinite(b)
    d = (a[ok].view(torch.int64) - b[ok].view(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


def profiled(fn, tries: int = 3) -> dict:
    """``fn`` run once under torch.profiler: ``wall_s`` (the wall clock
    around it, ending in a synchronize; the profiler's host-side
    recording makes it a little longer than unprofiled), ``busy_s`` (the
    union of the device's own kernel, copy and memset intervals in the
    trace), ``ops`` (the number of those), and ``busy_no_htod_s`` /
    ``ops_no_htod`` / ``htod_s`` / ``htod_bytes``: the union and the
    count without the host-to-device copies, and those copies' time and
    bytes.  The profiler drops large
    pageable host-to-device copies from some traces (seen on the H100
    with config #5's 209 MB uploads), so a caller that uploads much
    times its copies with CUDA events and adds them to
    ``busy_no_htod_s``.  A trace with no device events at all is taken
    again, ``fn`` included, up to ``tries`` times."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    trace = ROOT / "build" / f"profile_trace.{os.getpid()}.json"  # one a process
    trace.parent.mkdir(parents=True, exist_ok=True)
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(str(trace))
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        trace.unlink()
        spans, rest = [], []
        htod_us = 0.0
        htod = 0
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
                continue
            span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            spans.append(span)
            if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", ""):
                htod_us += float(e["dur"])
                htod += int(e.get("args", {}).get("bytes", 0))
            else:
                rest.append(span)
        if spans:
            return {"wall_s": wall, "busy_s": _union_us(spans) * 1e-6, "ops": len(spans),
                    "busy_no_htod_s": _union_us(rest) * 1e-6, "ops_no_htod": len(rest),
                    "htod_s": htod_us * 1e-6, "htod_bytes": htod}
        log(f"profiled: trace {attempt + 1} of {tries} holds no device events; again")
    raise AssertionError("the profiler saw no device time")


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    end = -np.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def start_columns(rng, C: int, dtype):
    """Non-zero starting state columns (sum, int64 count, sum of squares,
    min, max); float min/max hold a few NaNs of their side's sign and
    the sums a few -0."""
    import torch

    if dtype.is_floating_point:
        cols = [np.round(rng.uniform(-500, 500, C), 2) for _ in range(5)]
        cols[0][::101] = -0.0
        cols[3][::89] = -np.float64(np.nan)
        cols[4][::97] = np.float64(np.nan)
    else:
        cols = [rng.integers(-(1 << 62), 1 << 62, C) for _ in range(5)]
    out = [torch.from_numpy(c).to(dtype) for c in cols]
    out[1] = torch.from_numpy(rng.integers(0, 1 << 40, C))
    return out


def with_dups(rng, slots, L: int, k: int):
    """A copy of ``slots`` in which k points take the slot of another
    point in [0, L): a few duplicate ids in a scrape."""
    out = slots.copy()
    src = rng.choice(np.flatnonzero((slots >= 0) & (slots < L)), k)
    out[rng.integers(0, slots.shape[0], k)] = slots[src]
    return out


def segment_kernel_checks(seed: int, dev) -> None:
    """Phase 6: both aggregator kernels, in place and in their fresh
    forms, against their plain versions run on CPU copies (on the CPU
    ``index_add_`` adds in arrival order; on the card its float adds are
    atomics), bit for bit, twice."""
    import torch

    from m3_tpu_torch.parallel import segment_ingest as si

    rng = np.random.default_rng(seed + 11)
    C_path, N_path = 1 << 21, 1_000_000
    path = np.concatenate([rng.permutation(C_path)[:N_path - 64],
                           rng.integers(-9, 0, 32), rng.integers(C_path, C_path + 9, 32)])
    shapes = {
        # the path: each series once per scrape, so unique slots
        "path": (C_path, path),
        # the same with a few duplicate ids (64 points repeat another's slot)
        "path+dups": (C_path, with_dups(rng, path, C_path, 64)),
        "collision": (4096, rng.integers(-10, 4096 + 10, 1 << 20)),
    }
    for shape, (C, slots_np) in shapes.items():
        slots = torch.from_numpy(slots_np.astype(np.int32))
        idx = slots.long()
        N = slots.shape[0]
        for dtype in (torch.int64, torch.float64):
            if dtype == torch.int64:
                v = rng.integers(-(1 << 62), 1 << 62, N)
            else:
                v = rng.uniform(-1, 1, N) * 10.0 ** rng.integers(-6, 7, N)  # order shows
                v[::997] = np.nan
                v[1::991] = -0.0
            vals = torch.from_numpy(v).to(dtype)
            start = start_columns(rng, C, dtype)
            want = [c.clone() for c in start]
            si.segment_ingest_into_plain(want[0], want[1], want[2], idx, vals)
            si.segment_minmax_into_plain(want[3], want[4], idx, vals)
            runs = []
            for _ in range(2):
                cols = [c.to(dev, copy=True) for c in start]
                si.segment_ingest_into(cols[0], cols[1], cols[2], idx.to(dev), vals.to(dev))
                si.segment_minmax_into(cols[3], cols[4], idx.to(dev), vals.to(dev))
                cols = [c.cpu() for c in cols]
                for name, g, w in zip(("sum", "count", "sq", "min", "max"), cols, want):
                    assert same_bits(g, w), f"{shape} {dtype} into {name}"
                runs.append(cols)
            fresh = [si.segment_ingest(slots.to(dev), vals.to(dev), C, with_sq=True),
                     si.segment_minmax(slots.to(dev), vals.to(dev), C)]
            plain = [si.segment_ingest_plain(slots, vals, C, with_sq=True),
                     si.segment_minmax_plain(slots, vals, C)]
            for got, exp in zip(fresh, plain):
                for g, w in zip(got, exp):
                    assert same_bits(g.cpu(), w), f"{shape} {dtype} fresh"
            empty = int((plain[0][1] == 0).sum())
            assert empty > 0 or shape == "collision"
            assert shape == "path" or int(plain[0][1].max()) > 1
            assert bool(torch.isnan(plain[1][0]).any()) == dtype.is_floating_point
            msg = (f"phase6 {shape} {str(dtype)[6:]}: N={N} C={C}, {empty} empty slots, "
                   f"non-zero starting columns")
            if dtype == torch.float64:
                ulp = max(max_ulp(runs[0][0], runs[1][0]), max_ulp(runs[0][2], runs[1][2]))
                assert ulp == 0, ulp
                msg += f", run-to-run f64 sums differ by {ulp} ulp"
                w = [c.to(dev, copy=True) for c in start[:3]]
                i_d, v_d = idx.to(dev), vals.to(dev)
                ms = graph_ms(lambda: si.segment_ingest_into(w[0], w[1], w[2], i_d, v_d))
                msg += f", segment_ingest into {ms:.4f} ms (CUDA graph)"
            log(msg + ": into and fresh kernels == plain, bit for bit, twice")
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    s0, c0 = si.segment_ingest(e, torch.zeros(0, dtype=torch.float64, device=dev), 8)
    mn0, mx0 = si.segment_minmax(e, torch.zeros(0, dtype=torch.int64, device=dev), 8)
    assert float(s0.abs().sum()) == 0 and int(c0.sum()) == 0
    assert int(mn0.min()) == np.iinfo(np.int64).max and int(mx0.max()) == np.iinfo(np.int64).min
    col = torch.ones(8, dtype=torch.float64, device=dev)
    si.segment_ingest_into(col, torch.ones(8, dtype=torch.int64, device=dev), None, e,
                           torch.zeros(0, dtype=torch.float64, device=dev))
    assert float(col.sum()) == 8
    log("phase6 empty batch: zeros and identities; columns untouched")


AGG_POLICY = "1m:2d"


def agg_kinds():
    """Aggregation IDs and scrapes per 1 m window of each metric type."""
    from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType as AT
    from m3_tpu_torch.metrics.types import MetricType as MT

    return {
        MT.COUNTER: (6, AggregationID.compress([AT.SUM, AT.MIN, AT.MAX]), b"cnt"),
        MT.GAUGE: (6, AggregationID.compress([AT.LAST, AT.SUM, AT.MIN, AT.MAX]), b"gau"),
        MT.TIMER: (10, AggregationID.DEFAULT, b"tim"),
    }


def agg_traffic(rng, n: int) -> dict:
    """One 1 m window of n series per type (each series once per scrape,
    in a fresh order each scrape) and one scrape's times into the next
    window: type -> (times (k, n), values (k, n), k + 1 permutations,
    next-window times (n,), ids)."""
    from m3_tpu_torch.metrics.types import MetricType as MT

    data = {}
    for mt, (k, aid, prefix) in agg_kinds().items():
        step = MINUTE // k
        times = (T0_AGG + np.arange(k, dtype=np.int64)[:, None] * step
                 + rng.integers(0, step, (k, n)))
        if mt is MT.COUNTER:
            vals = rng.integers(0, 1000, (k, n)).astype(np.float64)
        elif mt is MT.GAUGE:
            vals = np.round(rng.normal(50, 20, (k, n)), 3) + 0.0
            vals[rng.random((k, n)) < 0.001] = np.nan
        else:
            vals = np.round(rng.gamma(2.0, 40.0, (k, n)), 3)
        perms = [rng.permutation(n) for _ in range(k + 1)]
        nxt_t = T0_AGG + MINUTE + rng.integers(0, MINUTE, n)
        data[mt] = (times, vals, perms, nxt_t, [prefix + b".%07d" % i for i in range(n)])
    return data


def agg_drive(seed: int, n: int, dev, card: str, tag: str, layout=None):
    """Phases 7 and 10: one 1 m window of n counters, n gauges (six 10 s
    scrapes each) and n timers (ten scrapes) through the aggregator on
    the card, on ``layout`` (None: the default, packed), plus a scrape
    into the next window with a few samples too early and too far ahead.
    On the f64 layout, consume is checked against a numpy oracle.
    Returns the phase's times and the flushed values, (type, agg type)
    -> (n,) in series order."""
    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.metrics.aggregation import AggregationType as AT
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import MetricType as MT

    rng = np.random.default_rng(seed)
    policy = StoragePolicy.parse(AGG_POLICY)
    opts = te.AggregatorOptions(capacity=1 << 20, num_windows=2,
                                timer_sample_capacity=1 << 24, layout=layout,
                                storage_policies=(policy,))
    agg = te.Aggregator(num_shards=1, opts=opts, device=dev)
    ml = agg.shards[0].lists[policy]
    kinds = agg_kinds()
    data = agg_traffic(rng, n)

    t = {"n_series": n}
    emitted = {}
    # first scrape of each type: the entry point, which creates the series
    slot_of = {}
    for mt, (times, vals, perms, _, ids) in data.items():
        p = perms[0]
        ids_p = [ids[i] for i in p]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg.add_untimed_batch(mt, ids_p, vals[0, p], times[0, p], kinds[mt][1])
        torch.cuda.synchronize()
        t[f"{mt.name.lower()}_entry_samples_per_s"] = n / (time.perf_counter() - t0)
        slot_of[mt] = ml.maps[mt].resolve(ids, kinds[mt][1], mt)
    assert ml.consumed_until == T0_AGG
    # the rest: the hot loop, with the slots the entry point resolved
    n_bad = 100
    for mt, (times, vals, perms, nxt_t, _) in data.items():
        sl = slot_of[mt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(1, vals.shape[0]):
            p = perms[j]
            ml.add_batch_slots(mt, sl[p], vals[j, p], times[j, p])
        torch.cuda.synchronize()
        t[f"{mt.name.lower()}_hot_samples_per_s"] = (vals.shape[0] - 1) * n / (
            time.perf_counter() - t0)
        p = perms[-1]
        bad = rng.integers(0, n, 2 * n_bad)
        bad_t = np.concatenate([np.full(n_bad, T0_AGG - MINUTE),
                                np.full(n_bad, T0_AGG + 2 * MINUTE + 7 * SEC)])
        ml.add_batch_slots(mt, np.concatenate([sl[p], sl[bad]]),
                           np.concatenate([vals[0, p], vals[0, bad]]),
                           np.concatenate([nxt_t[p], bad_t]))
    assert agg.counters()["drops"] == 3 * 2 * n_bad, agg.counters()

    # consume at the window's end: device lanes and host _emit timed apart
    split = {"lanes": 0.0, "emit": 0.0}
    counts = {}

    def timed(key, fn, keep=None):
        def run(*a):
            t1 = time.perf_counter()
            out = fn(*a)
            if keep is not None:
                counts[keep] = out[1].cpu().numpy()
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t1
            return out
        return run

    for mt in kinds:
        arena = ml._arena(mt)
        arena.consume = timed("lanes", arena.consume, keep=mt)
    ml._emit = timed("emit", ml._emit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flushed = agg.consume(T0_AGG + MINUTE)
    torch.cuda.synchronize()
    t["consume_s"] = time.perf_counter() - t0
    t["consume_device_lanes_s"] = split["lanes"]
    t["consume_host_emit_s"] = split["emit"]
    assert ml.consumed_until == T0_AGG + MINUTE

    # the flushed values in series order, then (f64) the numpy oracle,
    # in scrape order
    q = opts.quantiles
    got = {}
    for fm in flushed:
        assert fm.timestamp_nanos == T0_AGG + MINUTE
        times, vals, perms, _, _ = data[fm.metric_type]
        k = vals.shape[0]
        inv = np.full(opts.capacity, -1, np.int64)
        inv[slot_of[fm.metric_type]] = np.arange(n)
        assert (counts[fm.metric_type][slot_of[fm.metric_type]] == k).all()
        for at in set(AT(x) for x in np.unique(fm.types)):
            sel = fm.types == int(at)
            idx = inv[fm.slots[sel]]
            assert sel.sum() == n and (idx >= 0).all(), (fm.metric_type, at)
            got[fm.metric_type, at] = np.empty(n)
            got[fm.metric_type, at][idx] = fm.values[sel]
        emitted[fm.metric_type.name] = int(fm.values.size)
        if layout != "f64":
            continue
        if fm.metric_type is MT.COUNTER:
            iv = vals.astype(np.int64)
            want = {AT.SUM: iv.sum(axis=0), AT.MIN: iv.min(axis=0), AT.MAX: iv.max(axis=0)}
        elif fm.metric_type is MT.GAUGE:
            nan = np.isnan(vals)
            acc = np.zeros(n)
            for j in range(k):
                acc = acc + np.where(nan[j], 0.0, vals[j])
            allnan = nan.all(axis=0)
            lo = np.where(nan, np.inf, vals).min(axis=0)
            hi = np.where(nan, -np.inf, vals).max(axis=0)
            want = {AT.LAST: vals[np.argmax(times, axis=0), np.arange(n)], AT.SUM: acc,
                    AT.MIN: np.where(allnan, np.nan, lo),
                    AT.MAX: np.where(allnan, np.nan, hi)}
        else:
            acc = np.zeros(n)
            acc_sq = np.zeros(n)
            for j in range(k):
                acc = acc + vals[j]
                acc_sq = acc_sq + vals[j] * vals[j]
            srt = np.sort(vals, axis=0)
            rank = lambda qq: int(np.ceil(qq * float(k))) - 1
            cnt = float(k)
            want = {AT.SUM: acc, AT.SUM_SQ: acc_sq, AT.MEAN: acc / k,
                    AT.COUNT: np.full(n, cnt), AT.MIN: srt[0], AT.MAX: srt[-1],
                    AT.MEDIAN: srt[rank(0.5)],
                    AT.STDEV: np.sqrt(np.maximum(cnt * acc_sq - acc * acc, 0.0)
                                      / (cnt * (cnt - 1)))}
            for qq, at in zip(q, (AT.P50, AT.P95, AT.P99)):
                want[at] = srt[rank(qq)]
        for at, w in want.items():
            g = got[fm.metric_type, at]
            w = np.asarray(w, np.float64)
            if at is AT.STDEV:
                np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=at.name)
            else:
                assert np.array_equal(g, w, equal_nan=True), (fm.metric_type, at)
    assert set(emitted) == {"COUNTER", "GAUGE", "TIMER"}, emitted

    # where a hot-loop scrape's time goes: one more scrape of each type
    # into the open next window, under the profiler
    for mt, (times, vals, perms, _, _) in data.items():
        p = perms[1]
        args = (slot_of[mt][p], vals[1, p], times[1, p] + MINUTE)
        route = []
        for _ in range(3):  # the host clock is noisy: median of three
            t0 = time.perf_counter()
            ml._route_windows(args[2])
            route.append(time.perf_counter() - t0)
        route_s = sorted(route)[1]
        prof = profiled(lambda: ml.add_batch_slots(mt, *args))
        wall_s, busy_s, ops = prof["wall_s"], prof["busy_s"], prof["ops"]
        name = mt.name.lower()
        t[f"{name}_scrape_wall_ms"] = wall_s * 1e3
        t[f"{name}_scrape_host_routing_ms"] = route_s * 1e3
        t[f"{name}_scrape_device_busy_ms"] = busy_s * 1e3
        t[f"{name}_scrape_device_idle_share"] = 1 - busy_s / wall_s
        t[f"{name}_scrape_device_ops"] = ops
    c = agg.counters()
    checked = ("exact against the numpy oracle (stdev rtol 1e-12)" if layout == "f64"
               else "held against the f64 run below")
    log(f"{tag} layout={layout or 'default'} n={n}: consume {checked} for {emitted} rows; "
        f"drops {c['drops']} (too early {n_bad} + too far {n_bad} per type)")
    for key, v in t.items():
        if key != "n_series":
            log(f"{tag} [{card}] {key}: {v:,.3f}")
    return t, got


def drain_encode_decode(seed: int, S: int, dev, card: str) -> None:
    """Phase 8: S gauges at 10 s raw under 1m:2d for 120 windows (2 h)
    through the hot loop on the default (packed) arena layout, each
    window consumed; the drained LAST values
    become (S, 120) matrices (as tools/hops.py builds them) and go
    through encode and decode on the card."""
    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import MetricType as MT

    rng = np.random.default_rng(seed)
    T, k = 120, 6
    policy = StoragePolicy.parse("1m:2d")
    opts = te.AggregatorOptions(capacity=1 << 17, num_windows=2,
                                timer_sample_capacity=1 << 10,
                                storage_policies=(policy,))
    agg = te.Aggregator(num_shards=1, opts=opts, device=dev)
    ml = agg.shards[0].lists[policy]
    ids = [b"hop.%06d" % i for i in range(S)]
    walk = np.round(50 + np.cumsum(rng.normal(0, 0.5, (T * k, S)), axis=0), 2) + 0.0
    step = 10 * SEC
    tmat = np.zeros((S, T), np.int64)
    vmat = np.zeros((S, T))
    agg.add_untimed_batch(MT.GAUGE, ids, walk[0], np.full(S, T0_AGG))
    slots = ml.maps[MT.GAUGE].resolve(ids, te.AggregationID.DEFAULT, MT.GAUGE)
    inv = np.full(opts.capacity, -1, np.int64)
    inv[slots] = np.arange(S)
    ingest_s = consume_s = 0.0
    for w in range(T):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(0 if w else 1, k):
            i = w * k + j
            p = rng.permutation(S)
            ml.add_batch_slots(MT.GAUGE, slots[p], walk[i, p],
                               T0_AGG + i * step + rng.integers(0, step, S))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flushed = agg.consume(T0_AGG + (w + 1) * MINUTE)
        t2 = time.perf_counter()
        ingest_s += t1 - t0
        consume_s += t2 - t1
        (fm,) = flushed
        rows = inv[fm.slots]
        assert fm.values.size == S and (rows >= 0).all()
        tmat[rows, w] = fm.timestamp_nanos
        vmat[rows, w] = fm.values
    assert np.array_equal(vmat, walk[k - 1::k].T), "drained LAST != last scrape"
    n_samples = T * k * S - S
    log(f"phase8 [{card}] {S} gauges x {T} windows: hot loop "
        f"{n_samples / ingest_s:,.0f} samples/s, consume {consume_s / T * 1e3:.1f} ms/window")
    W = max(16, T * 40 // 64 + 8)
    t0 = time.perf_counter()
    streams, fb = mt.encode_batch(tmat, vmat, np.full(S, T0_AGG, np.int64),
                                  out_words=W, device=dev)
    dts, dvals, cnts, dfb = mt.decode_batch(streams, T, device=dev)
    torch.cuda.synchronize()
    share = float(fb.mean())
    keep = ~fb
    assert share < 0.05, share
    assert not dfb[keep].any() and (cnts[keep] == T).all()
    assert np.array_equal(dts[keep], tmat[keep])
    assert np.array_equal(dvals[keep].view(np.uint64), vmat[keep].view(np.uint64))
    log(f"phase8 drain -> encode -> decode: fallback share {share:.5f} "
        f"({int(fb.sum())} of {S}), {int(keep.sum())} series round-trip exactly "
        f"({time.perf_counter() - t0:.1f} s)")


def cross_layout_check(packed: dict, f64: dict) -> dict:
    """Phase 10: the packed layout's flushed values against the f64
    run's, within the JAX package's cross-layout envelopes: counter
    lanes, gauge COUNT/MIN/MAX/LAST and timer COUNT exact; gauge sums
    and timer moments rtol 1e-6; timer values (min, max, quantiles)
    f32-rounded, rel 1e-6; timer stdev, cancellation-amplified, rtol
    1e-5.  Returns the largest relative difference per (type, agg type)."""
    from m3_tpu_torch.metrics.aggregation import AggregationType as AT
    from m3_tpu_torch.metrics.types import MetricType as MT

    assert packed.keys() == f64.keys(), (sorted(packed), sorted(f64))
    exact = {MT.COUNTER: set(AT), MT.GAUGE: {AT.COUNT, AT.MIN, AT.MAX, AT.LAST},
             MT.TIMER: {AT.COUNT}}
    worst = {}
    for (mt, at), g in packed.items():
        w = f64[mt, at]
        key = f"{mt.name}.{at.name}"
        if at in exact[mt]:
            assert np.array_equal(g, w, equal_nan=True), key
            worst[key] = 0.0
            continue
        rtol = 1e-5 if at is AT.STDEV else 1e-6
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=key)
        fin = np.isfinite(w) & (w != 0)
        worst[key] = float((np.abs(g - w)[fin] / np.abs(w[fin])).max()) if fin.any() else 0.0
    return worst


def packed_card_vs_cpu(seed: int, n: int, m: int, dev, card: str) -> None:
    """Phase 10, second part: the first m of phase 7's n series per type
    (the same traffic, each scrape's permutation restricted to them)
    through the default layout on the card and on the CPU, every state
    field compared bit for bit (NaN as one NaN) after every scrape; then
    a scrape with 64 duplicate ids per type, a counter batch with values
    outside int16 (pool promotions), the next-window scrape with its
    too-early and too-far samples, and consume, all compared the same
    way."""
    from m3_tpu_torch.aggregator import arena
    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import MetricType as MT

    data = agg_traffic(np.random.default_rng(seed), n)
    kinds = agg_kinds()
    policy = StoragePolicy.parse(AGG_POLICY)
    opts = te.AggregatorOptions(capacity=1 << 20, num_windows=2,
                                timer_sample_capacity=1 << 20, storage_policies=(policy,))
    sides = [te.Aggregator(opts=opts, device=d) for d in (dev, "cpu")]
    lists = [a.shards[0].lists[policy] for a in sides]
    rng = np.random.default_rng(seed + 5)
    compared = 0

    def same(x, y) -> bool:
        if x.dtype.kind != "f":
            return np.array_equal(x, y)
        ok = ~np.isnan(y)
        return (np.array_equal(np.isnan(x), ~ok)
                and np.array_equal(x[ok].view(np.uint64), y[ok].view(np.uint64)))

    def compare(mt, what):
        nonlocal compared
        a, b = (arena.state_to_numpy(ml._arena(mt).state) for ml in lists)
        for name in b:
            assert same(a[name], b[name]), f"card != CPU: {mt.name}.{name} after {what}"
        compared += 1

    def both(mt, slots, vals, times, what):
        for ml in lists:
            ml.add_batch_slots(mt, slots, vals, times)
        compare(mt, what)

    bad_t = np.concatenate([np.full(10, T0_AGG - MINUTE),
                            np.full(10, T0_AGG + 2 * MINUTE + 7 * SEC)])
    for mt, (times, vals, perms, nxt_t, ids) in data.items():
        sub = [p[p < m] for p in perms]
        aid = kinds[mt][1]
        for agg in sides:
            agg.add_untimed_batch(mt, [ids[i] for i in sub[0]], vals[0, sub[0]],
                                  times[0, sub[0]], aid)
        compare(mt, "scrape 0")
        slots = lists[0].maps[mt].resolve(ids[:m], aid, mt)
        assert np.array_equal(slots, lists[1].maps[mt].resolve(ids[:m], aid, mt))
        for j in range(1, vals.shape[0]):
            p = sub[j]
            both(mt, slots[p], vals[j, p], times[j, p], f"scrape {j}")
        p = sub[1]
        both(mt, with_dups(rng, slots[p], opts.capacity, 64), vals[1, p], times[1, p],
             "a scrape with 64 duplicate ids")
        if mt is MT.COUNTER:
            big = vals[2, p].copy()
            big[:1000] = np.where(np.arange(1000) % 2, 1.0, -1.0) * 2.0 ** 40
            both(mt, slots[p], big, times[2, p], "a batch outside int16")
            st = lists[0].counters.state
            assert int(st.pool_n) == 1000 and int(st.err) == 0, (int(st.pool_n), int(st.err))
        p = sub[-1]
        bad = rng.integers(0, m, 20)
        both(mt, np.concatenate([slots[p], slots[bad]]),
             np.concatenate([vals[0, p], vals[0, bad]]),
             np.concatenate([nxt_t[p], bad_t]), "the next-window scrape")
    out = [agg.consume(T0_AGG + MINUTE) for agg in sides]
    assert len(out[0]) == len(out[1]) == 3
    rows = 0
    for fa, fb in zip(*out):
        assert fa.metric_type == fb.metric_type and fa.timestamp_nanos == fb.timestamp_nanos
        assert np.array_equal(fa.slots, fb.slots) and np.array_equal(fa.types, fb.types)
        assert same(fa.values, fb.values), f"card != CPU: flushed {fa.metric_type.name}"
        rows += fa.values.size
    for mt in data:
        compare(mt, "consume")
    assert sides[0].counters() == sides[1].counters()
    log(f"phase10 [{card}] card == CPU bit for bit (NaN as one NaN) on {m} series per "
        f"type: {compared} state comparisons, every field, after every scrape (64 "
        f"duplicate ids per type; 1000 counter slots promoted into the pool, err 0; "
        f"next-window scrape; consume), and {rows} flushed rows")


def touched_bytes(idx, cols) -> int:
    """Bytes of the 32-byte sectors of ``cols`` that the in-range lanes of
    ``idx`` touch, each read once and written once."""
    import torch

    ok = idx[(idx >= 0) & (idx < cols[0].shape[0])]
    return sum(2 * 32 * int(torch.unique(ok * c.element_size() // 32).numel())
               for c in cols)


def fresh_then_fold_seg3(sum_col, sq_col, cnt_col, idx, values):
    """The arena step as composed before the in-place kernels: the kernel
    into fresh zeroed outputs, then ``add_`` passes and a cast into the
    state (with today's fresh form of the kernel)."""
    import torch

    from m3_tpu_torch.parallel import segment_ingest as si

    s, c, sq = si.segment_ingest(idx.to(torch.int32), values, sum_col.shape[0], with_sq=True)
    sum_col.add_(s)
    sq_col.add_(sq)
    cnt_col.add_(c.to(cnt_col.dtype))


def _pick(a, b, b_wins):
    """Elementwise pick of the earlier arena step: ``b`` where it wins in
    IEEE total order (-0 < +0), NaN where either side is NaN."""
    import torch

    from m3_tpu_torch.parallel import segment_ingest as si

    if not a.dtype.is_floating_point:
        return torch.where(b_wins(b, a), b, a)
    ka, kb = si._total_order_key(a.double()), si._total_order_key(b.double())
    out = torch.where(b_wins(kb, ka), b, a)
    return torch.where(torch.isnan(a) | torch.isnan(b), float("nan"), out)


def fresh_then_fold_minmax(max_col, min_col, idx, values):
    """The arena step as composed before the in-place kernels: the kernel
    into fresh identities, then the total-order maximum / minimum
    (``_pick``) and ``copy_`` into the state."""
    import torch

    from m3_tpu_torch.parallel import segment_ingest as si

    mn, mx = si.segment_minmax(idx.to(torch.int32), values, max_col.shape[0])
    max_col.copy_(_pick(max_col, mx, torch.gt))
    min_col.copy_(_pick(min_col, mn, torch.lt))


def segment_kernel_times(seen: dict, launches: dict, card: str) -> list:
    """Phase 9: each aggregator kernel on the inputs the arena handed it
    (a gauge scrape: the state's columns, the flat index, the values),
    held against its plain version (on CPU copies) once more, then timed
    on copies of those columns beside its bound, its plain version, the
    library calls doing the same in-place work, and the whole arena step
    against the fresh-output composition; the fresh forms beside them.  Each time
    from a CUDA graph of 20 calls (``graph_ms``: the wrappers' host
    launch overhead is larger than these kernels)."""
    import torch

    from m3_tpu_torch.aggregator import arena
    from m3_tpu_torch.parallel import segment_ingest as si

    (sum_c, cnt_c, sq_c, idx, vals), _ = seen["segment_ingest_into"]
    N, L = idx.shape[0], sum_c.shape[0]
    start = [c.clone() for c in (sum_c, cnt_c, sq_c)]
    want = [c.to("cpu", copy=True) for c in start]
    si.segment_ingest_into_plain(*want, idx.cpu(), vals.cpu())
    got = [c.clone() for c in start]
    si.segment_ingest_into(*got, idx, vals)
    assert all(same_bits(g.cpu(), w) for g, w in zip(got, want)), "segment_ingest != plain"
    err = max(max_abs_err(g.cpu(), w) for g, w in zip(got, want))
    ok = (idx >= 0) & (idx < L)
    li, lv = idx[ok], vals[ok]
    lones, lvv = torch.ones_like(li), lv * lv
    w = [c.clone() for c in start]
    # twice the 50 MB L2: the state columns are cold when a scrape reaches
    # the arena (the sorts and copies before it move more than L2 holds)
    flush = torch.empty(1 << 25, dtype=torch.float32, device=vals.device)

    def lib():
        w[0].index_add_(0, li, lv)
        w[1].index_add_(0, li, lones)
        w[2].index_add_(0, li, lvv)

    into = lambda: si.segment_ingest_into(w[0], w[1], w[2], idx, vals)
    ing = {
        "ms": graph_ms(into, flush=flush),
        "warm_ms": graph_ms(into),
        "eager_ms": cuda_ms(into),
        "plain_ms": graph_ms(lambda: si.segment_ingest_into_plain(w[0], w[1], w[2], idx, vals),
                            flush=flush),
        "library_ms": graph_ms(lib, flush=flush),
        "bound_ms": (N * (idx.element_size() + vals.element_size())
                     + touched_bytes(idx, start)) / HBM_BYTES_PER_S * 1e3,
        "step_ms": graph_ms(lambda: arena._seg3(w[0], w[2], w[1], idx, vals), flush=flush),
        "fresh_step_ms": graph_ms(lambda: fresh_then_fold_seg3(w[0], w[2], w[1], idx, vals), flush=flush),
    }
    # the same scrape with a few duplicate ids: 64 points take another's lane
    didx = torch.from_numpy(with_dups(np.random.default_rng(N), idx.cpu().numpy(), L, 64))
    dwant = [c.to("cpu", copy=True) for c in start]
    si.segment_ingest_into_plain(*dwant, didx, vals.cpu())
    didx = didx.to(idx.device)
    dgot = [c.clone() for c in start]
    si.segment_ingest_into(*dgot, didx, vals)
    assert all(same_bits(g.cpu(), x) for g, x in zip(dgot, dwant)), "dups: != plain"
    dok = (didx >= 0) & (didx < L)
    dli, dlv = didx[dok], vals[dok]
    dones, dlvv = torch.ones_like(dli), dlv * dlv

    def dlib():
        w[0].index_add_(0, dli, dlv)
        w[1].index_add_(0, dli, dones)
        w[2].index_add_(0, dli, dlvv)

    ing["dups_ms"] = graph_ms(lambda: si.segment_ingest_into(w[0], w[1], w[2], didx, vals),
                              flush=flush)
    ing["dups_library_ms"] = graph_ms(dlib, flush=flush)
    slots32 = idx.to(torch.int32)
    fresh = {}
    for form, with_sq, n_out in (("moments", True, 3), ("sum_count", False, 2)):
        fresh_fn = lambda: si.segment_ingest(slots32, vals, L, with_sq=with_sq)
        fresh[form] = {
            "ms": graph_ms(fresh_fn, flush=flush),
            "warm_ms": graph_ms(fresh_fn),
            "bound_ms": (N * (4 + vals.element_size())
                         + L * (vals.element_size() * (n_out - 1) + 4)) / HBM_BYTES_PER_S * 1e3,
        }
    ing["fresh"] = fresh

    (mn_c, mx_c, midx, mvals), _ = seen["segment_minmax_into"]
    Nm, Lm = midx.shape[0], mn_c.shape[0]
    mstart = [mn_c.clone(), mx_c.clone()]
    mwant = [c.to("cpu", copy=True) for c in mstart]
    si.segment_minmax_into_plain(*mwant, midx.cpu(), mvals.cpu())
    mgot = [c.clone() for c in mstart]
    si.segment_minmax_into(*mgot, midx, mvals)
    assert all(same_bits(g.cpu(), x) for g, x in zip(mgot, mwant)), "segment_minmax != plain"
    mm_err = max(max_abs_err(g.cpu(), x) for g, x in zip(mgot, mwant))
    mok = (midx >= 0) & (midx < Lm)
    mli, mlv = midx[mok], mvals[mok]
    m = [c.clone() for c in mstart]
    minto = lambda: si.segment_minmax_into(m[0], m[1], midx, mvals)
    mfresh = lambda: si.segment_minmax(midx.to(torch.int32), mvals, Lm)
    mm = {
        "ms": graph_ms(minto, flush=flush),
        "warm_ms": graph_ms(minto),
        "eager_ms": cuda_ms(minto),
        "plain_ms": graph_ms(lambda: si.segment_minmax_into_plain(m[0], m[1], midx, mvals),
                            flush=flush),
        "library_ms": graph_ms(lambda: (m[0].scatter_reduce_(0, mli, mlv, "amin"),
                                       m[1].scatter_reduce_(0, mli, mlv, "amax")), flush=flush),
        "bound_ms": (Nm * (midx.element_size() + mvals.element_size())
                     + touched_bytes(midx, mstart)) / HBM_BYTES_PER_S * 1e3,
        "step_ms": graph_ms(lambda: arena._minmax(m[1], m[0], midx, mvals), flush=flush),
        "fresh_step_ms": graph_ms(lambda: fresh_then_fold_minmax(m[1], m[0], midx, mvals), flush=flush),
        "fresh": {"ms": graph_ms(mfresh, flush=flush), "warm_ms": graph_ms(mfresh),
                  "bound_ms": (Nm * (4 + mvals.element_size()) + 2 * Lm * mvals.element_size())
                  / HBM_BYTES_PER_S * 1e3},
    }
    for name, r, lib_name in (("segment_ingest", ing, "index_add_ x3"),
                              ("segment_minmax", mm, "scatter_reduce_ x2")):
        log(f"phase9 [{card}] {name} into the state, N={N if r is ing else Nm} "
            f"lanes={L if r is ing else Lm}, L2 flushed before each call: {r['ms']:.4f} ms "
            f"(L2 warm {r['warm_ms']:.4f} ms, eager back-to-back {r['eager_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms (bytes), plain "
            f"{r['plain_ms']:.4f} ms, {lib_name} into the same columns "
            f"{r['library_ms']:.4f} ms; arena step {r['step_ms']:.4f} ms vs the fresh-output "
            f"composition {r['fresh_step_ms']:.4f} ms")
    log(f"phase9 [{card}] segment_ingest into the state, the same scrape with 64 "
        f"duplicate ids (bit-equal to plain): {ing['dups_ms']:.4f} ms, index_add_ x3 "
        f"{ing['dups_library_ms']:.4f} ms (L2 flushed)")
    for form, r in fresh.items():
        log(f"phase9 [{card}] segment_ingest fresh ({form}): {r['ms']:.4f} ms "
            f"(L2 warm {r['warm_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms (bytes)")
    log(f"phase9 [{card}] segment_minmax fresh: {mm['fresh']['ms']:.4f} ms "
        f"(L2 warm {mm['fresh']['warm_ms']:.4f} ms), "
        f"bound {mm['fresh']['bound_ms']:.4f} ms (bytes)")
    return [
        {"name": "segment_ingest", "route": "cuda",
         "source": "m3_tpu_torch/csrc/segment_ingest.cu",
         "replaces": "m3_tpu/parallel/pallas_ingest.py:65",
         "launches": launches[si.INGEST_KERNEL], "max_abs_err": err,
         "bound_by": "bytes", "library": "index_add_ x3 into the same columns",
         "form": "into the state (moments)", **ing},
        {"name": "segment_minmax", "route": "cuda",
         "source": "m3_tpu_torch/csrc/segment_minmax.cu",
         "replaces": "m3_tpu/parallel/pallas_ingest.py:191",
         "launches": launches[si.MINMAX_KERNEL], "max_abs_err": mm_err,
         "bound_by": "bytes", "library": "scatter_reduce_ x2 into the same columns",
         "form": "into the state", **mm},
    ]


# ---- phases 12-13: the PromQL query path (BASELINE config #5) ----

PROMQL_GROUPS, PROMQL_BUCKETS = 12_500, 8  # 100,000 series, as the JAX bench
PROMQL_START = 1_600_000_000 * SEC
PROMQL_STEP = 15 * SEC
PROMQL_RANGE = 3600 * SEC  # the 1 h query window
RATE_WIN = 5 * 60 * SEC  # rate(...[5m])
HQ_QUERY = "histogram_quantile(0.99, rate(m3_req_bucket[5m]))"
FINITE_UBS = (b"0.005", b"0.05", b"0.5", b"1", b"2.5", b"5", b"10")
# card against the port's own CPU run: the same elementwise ops on both
# (each rounded once), so config #5's rate and histogram_quantile agree
# but for reduction and scan orders
CARD_VS_CPU_RTOL = {"f64": 1e-12, "f32": 1e-5}
QUERY_TIMED_RUNS = 1  # timed evals after the warm-up, phases 12 and 13; of 3 (PERF.md §4)
# the per-family queries of phase 12, each held card against CPU on a
# slice; the kind names the tolerance (see family_bound)
FAMILY_QUERIES = (
    ("sum_over_time(m3_req_bucket[5m])", "prefix"),
    ("stddev_over_time(m3_req_bucket[5m])", "prefix_sq"),
    ("quantile_over_time(0.9, m3_req_bucket[5m])", "exact"),
    ("max_over_time(m3_req_bucket[5m])", "exact"),
    ("irate(m3_req_bucket[5m])", "exact"),
    ("deriv(m3_req_bucket[5m])", "regression"),
    ("resets(m3_req_bucket[5m])", "exact"),
    ("holt_winters(m3_req_bucket[5m], 0.3, 0.6)", "exact"),
    ("topk by (group) (3, rate(m3_req_bucket[5m]))", "exact"),
    ("quantile by (le) (0.5, rate(m3_req_bucket[5m]))", "exact"),
    ("sum_over_time(m3_req_bucket[5m]) / on (group, le) count_over_time(m3_req_bucket[5m])",
     "prefix"),
)


def promql_corpus(seed: int, G: int, B: int):
    """BASELINE config #5's data, as the JAX package's bench generates it
    (``bench.py`` ``_run_promql_bench``; seed 0 gives its data): G groups
    x B ``le`` buckets of cumulative counters, P = 261 samples at 15 s
    (the 1 h window plus the 5 m rate range), gamma increments at a
    per-series scale, a mid-stream reset in 0.1 % of the series, and
    per-bucket mass decaying geometrically, cumulated across the buckets.
    Returns (ts (S, P), vals (S, P), the upper-bound labels)."""
    rng = np.random.default_rng(11 + seed)
    P = (PROMQL_RANGE + RATE_WIN) // PROMQL_STEP + 1
    S = G * B
    ts = np.ascontiguousarray(np.broadcast_to(
        PROMQL_START + np.arange(P, dtype=np.int64) * PROMQL_STEP, (S, P)))
    scale = rng.uniform(0.5, 20.0, (S, 1))
    incr = rng.gamma(2.0, scale, (S, P))
    vals = np.cumsum(incr, axis=1)
    resets = rng.integers(0, S, max(S // 1000, 1))
    vals[resets, P // 2:] = np.cumsum(incr[resets, P // 2:], axis=1)
    decay = rng.uniform(0.3, 0.7, (G, 1, 1)) ** np.arange(B)[None, :, None]
    vals = (vals.reshape(G, B, P) * decay).cumsum(axis=1).reshape(S, P)
    return ts, vals, list(FINITE_UBS[:B - 1]) + [b"+Inf"]


class BlockStorage:
    """The engine's storage over one in-memory raw block (the JAX bench's
    ``_ArrayStorage``): every selector of the metric gets the whole
    block."""

    def __init__(self, raw, name: bytes = b"m3_req_bucket"):
        self.raw = raw
        self.name = name

    def fetch_raw(self, name, matchers, start_nanos, end_nanos):
        assert name == self.name and not matchers, (name, matchers)
        return self.raw


def raw_block(ts, vals, ub_labels, rows):
    """The corpus rows ``rows`` (an index array) as the port's RawBlock;
    row i is bucket ``i % B`` of group ``i // B``."""
    from m3_tpu_torch.query.block import RawBlock, SeriesMeta

    B = len(ub_labels)
    series = [SeriesMeta(((b"__name__", b"m3_req_bucket"), (b"group", b"g%06d" % (i // B)),
                          (b"le", ub_labels[i % B]))) for i in rows.tolist()]
    return RawBlock(ts[rows], vals[rows], np.full(len(rows), ts.shape[1], np.int64), series)


def oracle_rate(ts_row, vals_row, step_times, range_nanos):
    """Naive scalar Prometheus rate() (a copy of bench.py's
    ``_promql_oracle_rate``): (t-range, t] window, counter-reset
    correction, edge extrapolation capped at avg/2 and at the zero
    crossing."""
    out = np.full(len(step_times), np.nan)
    rng_s = range_nanos / 1e9
    for j, t_eval in enumerate(step_times):
        w0 = t_eval - range_nanos
        sel = np.nonzero((ts_row > w0) & (ts_row <= t_eval))[0]
        if sel.size < 2:
            continue
        t = ts_row[sel].astype(np.float64)
        v = vals_row[sel].astype(np.float64)
        adj = v.copy()
        add = 0.0
        for k in range(1, len(v)):
            if v[k] < v[k - 1]:
                add += v[k - 1]
            adj[k] = v[k] + add
        delta = adj[-1] - adj[0]
        sampled = t[-1] - t[0]
        if sampled <= 0:
            continue
        avg = sampled / (len(v) - 1)
        dur_start = t[0] - w0
        dur_end = t_eval - t[-1]
        ex_s = dur_start if dur_start < avg * 1.1 else avg / 2.0
        ex_e = dur_end if dur_end < avg * 1.1 else avg / 2.0
        if delta > 0 and v[0] >= 0:
            ex_s = min(ex_s, sampled * (v[0] / delta))
        out[j] = delta * (sampled + ex_s + ex_e) / sampled / rng_s
    return out


def oracle_hq(ubs, rates, q):
    """Naive scalar Prometheus histogram_quantile over cumulative bucket
    rates (a copy of bench.py's ``_promql_oracle_hq``)."""
    if np.isnan(rates).any():
        return np.nan
    total = rates[-1]
    if total == 0 or not np.isinf(ubs[-1]):
        return np.nan
    rank = q * total
    b = int(np.searchsorted(rates, rank, side="left"))
    if b >= len(ubs) - 1:
        return ubs[-2]
    lo = 0.0 if (b == 0 and ubs[0] > 0) else (ubs[b - 1] if b > 0 else ubs[0])
    if b == 0 and ubs[0] <= 0:
        return ubs[0]
    prev = rates[b - 1] if b > 0 else 0.0
    width = rates[b] - prev
    if width <= 0:
        return ubs[b]
    return lo + (ubs[b] - lo) * (rank - prev) / width


def zero_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.parallel import segment_ingest as si

    encode_place.launches = decode_gather.launches = 0
    for k in si.KERNELS:
        si.launches[k] = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.parallel import segment_ingest as si

    return {**si.launches, "place_words": encode_place.launches,
            "extract_fields64_t": decode_gather.launches}


class HostClock:
    """Host seconds spent in named callables, by wrapping them in place
    for one run (``restore`` puts them back).  Each key gets its own
    (exclusive) time: a wrapped call inside another, on the same thread,
    is taken out of the outer one's, so the keys add up to no more than
    the run's wall on each thread."""

    def __init__(self):
        import threading

        self.s: dict = {}
        self.calls: dict = {}
        self._tls = threading.local()  # per thread: time of wrapped calls
        self._lock = threading.Lock()  # nested in the open one
        self._undo: list = []

    def _inner(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = [0.0]
        return stack

    def wrap(self, owner, attr: str, key: str) -> None:
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            inner = self._inner()
            inner.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                own = dt - inner.pop()
                inner[-1] += dt
                with self._lock:
                    self.s[key] = self.s.get(key, 0.0) + own
                    self.calls[key] = self.calls.get(key, 0) + 1

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def words_touched(words_t, offs, widths) -> int:
    """Stream words that ``extract_fields64_t``'s in-range fields need:
    a field of w bits at bit offset o spans words o // 64 to
    (o + w - 1) // 64, at most two (w <= 64)."""
    import torch

    Wd, S = words_t.shape
    o, w = offs.long(), widths.long()
    ok = (w > 0) & (w <= 64) & (o >= 0) & (o + w <= Wd * 64)
    col = torch.arange(S, device=offs.device).expand_as(o)[ok]
    mask = torch.zeros((Wd, S), dtype=torch.bool, device=offs.device)
    mask[(o[ok] // 64), col] = True
    mask[((o[ok] + w[ok] - 1) // 64), col] = True
    return int(mask.sum())


class KernelCheck:
    """Within ``with``, every call of ``owner.attr`` (a kernel wrapper as
    its caller looks it up) runs as before, and its output is then held
    against ``plain`` on the same inputs, bit for bit; the comparison
    runs no kernel, so it adds nothing to the launch counts.  The last
    call's inputs are kept, to time the kernel on them."""

    def __init__(self, owner, attr: str, plain):
        self.owner, self.attr, self.plain = owner, attr, plain
        self.calls = 0
        self.err = 0
        self.args = None

    def __enter__(self):
        import torch

        fn = self.fn = getattr(self.owner, self.attr)

        def checked(*a):
            out = fn(*a)
            want = self.plain(*a)
            self.err = max(self.err, int((out ^ want).abs().max()) if out.numel() else 0)
            assert torch.equal(out, want), f"{self.attr} kernel != plain on the path's inputs"
            self.calls += 1
            self.args = a
            return out

        setattr(self.owner, self.attr, checked)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)
        return False

    def summary(self, *others) -> dict:
        """Calls and largest bit difference (this and ``others``), and the
        kernel's, its plain version's and its bound's times on the last
        call's inputs (rows of ``extract_fields64_t``: the lanes read once,
        each stream word a field needs read once, the output written
        once)."""
        calls = self.calls + sum(o.calls for o in others)
        assert self.calls > 0 and all(o.calls > 0 for o in others), "the kernel was not called"
        words_t, offs, widths = self.args
        nbytes = offs.numel() * (4 + 4 + 8) + words_touched(words_t, offs, widths) * 8
        return {"ext_calls": calls,
                "ext_max_abs_err": max([self.err] + [o.err for o in others]),
                "ext_words_shape": list(words_t.shape), "ext_lanes_shape": list(offs.shape),
                "ext_ms": cuda_ms(lambda: self.fn(*self.args)),
                "ext_plain_ms": cuda_ms(lambda: self.plain(*self.args)),
                "ext_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


# (owner module or class name, attribute, row of the host split)
QUERY_HOST_ROWS = (
    ("engine", "parse", "parse"),
    ("Engine", "_fetch", "fetch"),
    ("Engine", "_dev", "upload"),
    ("SeriesMeta", "drop_name", "drop_name"),
    ("temporal", "rate_family", "rate_launch"),
    ("Engine", "_eval_temporal", "rate_stage_rest"),
    ("functions", "histogram_quantile", "hq_tag_grouping"),
    ("device_fns", "histogram_quantile_groups", "hq_gather_plan"),
    ("device_fns", "_histogram_quantile_kernel", "hq_launch"),
    ("Block", "materialized", "materialize"),
)


def query_host_split(run, extra: tuple = ()) -> dict:
    """One run of ``run`` with the engine's host stages timed, each row
    exclusive of the others: parse; the storage fetch; the uploads
    (``Engine._dev``: the raw block's ts and values, the steps); the
    per-series ``drop_name``; the rate stencil's launches; the rest of
    the rate stage (the device ``nan_to_num`` and cast launches);
    histogram_quantile's tag grouping of the series; its gather plan;
    its launches; the copy to the host (which waits for the device); and
    ``other``, the wall left over (the engine's dispatch, and the
    clock's own cost on the ~10^5 ``drop_name`` calls).  ``extra`` adds
    (owner, attribute, row) triples, timed the same way (inside the
    fetch, the storage's own rows).  Also the uploads' time on the card,
    from CUDA events around each."""
    from m3_tpu_torch.query import block, device_fns, functions, temporal
    from m3_tpu_torch.query import engine as qe

    import torch

    owners = {"engine": qe, "Engine": qe.Engine, "SeriesMeta": block.SeriesMeta,
              "temporal": temporal, "functions": functions, "device_fns": device_fns,
              "Block": block.Block}
    # CUDA events around each upload: the copies' own time on the card
    dev_fn = qe.Engine._dev
    marks: list = []

    def dev_timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = dev_fn(*a, **kw)
        ev[1].record()
        marks.append(ev)
        return out

    qe.Engine._dev = dev_timed
    hc = HostClock()
    try:
        for owner, attr, key in QUERY_HOST_ROWS:
            hc.wrap(owners[owner], attr, key)
        for owner, attr, key in extra:
            hc.wrap(owner, attr, key)
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        hc.restore()
        qe.Engine._dev = dev_fn
    torch.cuda.synchronize()
    rows = {f"{key}_ms": hc.s.get(key, 0.0) * 1e3 for _, _, key in QUERY_HOST_ROWS + extra}
    return {"wall_ms": wall * 1e3, **rows, "other_ms": wall * 1e3 - sum(rows.values()),
            "drop_name_calls": hc.calls.get("drop_name", 0),
            "uploads": len(marks),
            "upload_copies_device_ms": sum(a.elapsed_time(b) for a, b in marks)}


def rel_err(a, b) -> float:
    """Largest |a - b| / |b| where b is finite and non-zero (NaN places
    must agree; checked by the caller)."""
    ok = np.isfinite(b) & (b != 0)
    return float((np.abs(a[ok] - b[ok]) / np.abs(b[ok])).max()) if ok.any() else 0.0


def family_bound(kind: str, raw, steps, out):
    """Per-row absolute tolerance of a card-vs-CPU comparison: exact (0)
    where both devices run the same elementwise ops, selections and
    sorts; for the prefix-difference families the card's parallel
    ``cumsum`` rounds differently from the CPU's sequential one, so 64
    eps64 of the row's largest prefix of |v| (sum/avg), the square root
    of 64 eps64 x max|v| x that prefix (stddev), or that error carried
    through the regression's first-order sensitivities (deriv)."""
    eps = float(np.finfo(np.float64).eps)
    v = raw.values
    pref = np.abs(v).cumsum(axis=1).max(axis=1, keepdims=True)
    if kind == "exact":
        return np.zeros((len(v), 1))
    if kind == "prefix":
        return 64 * eps * pref
    if kind == "prefix_sq":
        return np.sqrt(64 * eps * np.abs(v).max(axis=1, keepdims=True) * pref)
    # regression: window sums of v, t, t*v, t^2, each off by 64 eps of its
    # largest prefix, through the slope's sensitivities
    ts = raw.ts
    tsec = (ts - steps[0]).astype(np.float64) / 1e9
    ref = (steps - steps[0]).astype(np.float64)[None, :] / 1e9
    lo = np.stack([np.searchsorted(r, steps - RATE_WIN, side="right") for r in ts])
    hi = np.stack([np.searchsorted(r, steps, side="right") for r in ts])

    def wsum(x):
        c = np.concatenate([np.zeros((len(x), 1)), np.cumsum(x, axis=1)], axis=1)
        return (np.take_along_axis(c, hi, 1) - np.take_along_axis(c, lo, 1),
                64 * eps * np.abs(x).cumsum(axis=1).max(axis=1, keepdims=True))

    (Sv, Ev), (St, Et), (Stv, Etv), (Stt, Ett) = (
        wsum(v), wsum(tsec), wsum(tsec * v), wsum(tsec * tsec))
    n = (hi - lo).astype(np.float64)
    Stc = St - n * ref
    D = n * (Stt - 2 * ref * St + n * ref * ref) - Stc * Stc
    with np.errstate(all="ignore"):
        slope = np.nan_to_num(out)
        b = 2 * (n * Etv + np.abs(n * ref + Stc) * Ev
                 + np.abs(Sv + slope * (2 * n * ref + 2 * Stc)) * Et
                 + np.abs(slope) * n * Ett) / np.abs(D)
    return np.nan_to_num(b, nan=np.inf)


def promql_config5(seed: int, G: int, B: int, dev, card: str) -> dict:
    """Phase 12: BASELINE config #5 at full width through the port's
    engine on the card, under both precision policies; then one query per
    temporal family and device function.  Returns the times and the f64
    block of ``rate``, for phase 13."""
    import torch

    from m3_tpu_torch.query import engine as qe
    from m3_tpu_torch.query import precision

    ts, vals, ub_labels = promql_corpus(seed, G, B)
    S, P = ts.shape
    raw = raw_block(ts, vals, ub_labels, np.arange(S))
    eng = qe.Engine(BlockStorage(raw), device=dev)
    q_start = PROMQL_START + RATE_WIN
    q_end = q_start + PROMQL_RANGE
    steps = np.arange(q_start, q_end + 1, PROMQL_STEP, dtype=np.int64)
    T = len(steps)
    log(f"phase12 data: G={G} groups x B={B} buckets = {S} series, P={P} samples at 15 s, "
        f"T={T} steps; query {HQ_QUERY}")
    run = lambda: eng.execute_range(HQ_QUERY, q_start, q_end, PROMQL_STEP)
    ubs = np.array([np.inf if u == b"+Inf" else float(u) for u in ub_labels])
    check_groups = np.random.default_rng(seed + 5).choice(G, 6, replace=False)
    n_cpu = min(512, G)
    cpu_eng = qe.Engine(BlockStorage(raw_block(ts, vals, ub_labels, np.arange(n_cpu * B))),
                        device="cpu")
    times: dict = {}
    for policy in ("f64", "f32"):
        precision.set_compute_dtype(policy)
        try:
            t0 = time.perf_counter()
            blk = run()  # warm-up
            warm_s = time.perf_counter() - t0
            walls = []
            for _ in range(QUERY_TIMED_RUNS):
                t0 = time.perf_counter()
                run()
                walls.append(time.perf_counter() - t0)
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            split = query_host_split(run)
            launched = read_launches()
            t0 = time.perf_counter()
            [m.drop_name() for m in raw.series]  # the split's row, without its clock
            drop_name_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            prof = profiled(run)
            cpu_blk = cpu_eng.execute_range(HQ_QUERY, q_start, q_end, PROMQL_STEP)
        finally:
            precision.set_compute_dtype("f64")
        # device busy: the trace without its host-to-device copies (which
        # it may have dropped) plus the uploads timed with CUDA events
        busy = prof["busy_no_htod_s"] + split["upload_copies_device_ms"] * 1e-3
        # config #5 reads raw samples, not streams: no hand kernel is on it
        assert not any(launched.values()), launched
        assert blk.values.shape == (G, T) and blk.values.dtype == np.float64
        assert [m.as_dict()[b"group"] for m in blk.series] == [b"g%06d" % g for g in range(G)]
        assert np.isfinite(blk.values).mean() > 0.99, np.isfinite(blk.values).mean()
        # the scalar Prometheus oracles on sampled groups
        rtol = 1e-6 if policy == "f64" else 5e-3
        worst = 0.0
        for g in check_groups:
            rates = np.stack([oracle_rate(ts[g * B + b], vals[g * B + b], steps, RATE_WIN)
                              for b in range(B)])
            want = np.array([oracle_hq(ubs, rates[:, j], 0.99) for j in range(T)])
            got = blk.values[g]
            assert np.array_equal(np.isnan(got), np.isnan(want)), g
            assert np.allclose(got, want, rtol=rtol, atol=1e-12, equal_nan=True), (
                g, got[:4], want[:4])
            worst = max(worst, rel_err(got, want))
        # the port's own CPU run on the first groups
        assert cpu_blk.series == blk.series[:n_cpu]
        card_rows = blk.values[:n_cpu]
        assert np.array_equal(np.isnan(card_rows), np.isnan(cpu_blk.values))
        cvc = rel_err(card_rows, cpu_blk.values)
        assert cvc <= CARD_VS_CPU_RTOL[policy], (policy, cvc)
        t = {"eval_best_ms": min(walls) * 1e3, "eval_runs_ms": [w * 1e3 for w in walls],
             "warm_up_s": warm_s, **{f"split_{k}": v for k, v in split.items()},
             "drop_name_unclocked_ms": drop_name_s * 1e3,
             "profiled_wall_ms": prof["wall_s"] * 1e3,
             "device_busy_ms": busy * 1e3,
             "device_busy_no_upload_ms": prof["busy_no_htod_s"] * 1e3,
             "trace_htod_ms": prof["htod_s"] * 1e3, "trace_htod_bytes": prof["htod_bytes"],
             "device_idle_share": 1 - busy / prof["wall_s"],
             "device_idle_share_vs_best": 1 - busy / min(walls),
             "device_ops": prof["ops_no_htod"] + split["uploads"],
             "peak_mem_gib": peak / 2**30, "oracle_max_rel_err": worst,
             "card_vs_cpu_max_rel_err": cvc}
        times[policy] = t
        log(f"phase12 [{card}] config #5 {policy}: {len(check_groups)} groups == scalar "
            f"Prometheus oracles (rtol {rtol}, largest rel err {worst:.3e}); first {n_cpu} "
            f"groups card == CPU within rtol {CARD_VS_CPU_RTOL[policy]} (largest {cvc:.3e})")
        log(f"phase12 [{card}] config #5 {policy} times: " + json.dumps(t))
    times["families"] = family_queries(eng, ts, vals, ub_labels, steps, dev, card)
    return times


def family_queries(eng, ts, vals, ub_labels, steps, dev, card: str) -> dict:
    """Phase 12, second part: one query per temporal family and device
    function over the full block on the card (time and peak memory), then
    on the first 256 groups on the card and on the CPU, compared under
    ``family_bound``."""
    import torch

    from m3_tpu_torch.query import engine as qe

    B = len(ub_labels)
    n = min(256, ts.shape[0] // B) * B
    sl = raw_block(ts, vals, ub_labels, np.arange(n))
    card_sl = qe.Engine(BlockStorage(sl), device=dev)
    cpu_sl = qe.Engine(BlockStorage(sl), device="cpu")
    q0, q1 = int(steps[0]), int(steps[-1])
    out = {}
    for q, kind in FAMILY_QUERIES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        full = eng.execute_range(q, q0, q1, PROMQL_STEP)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        a = card_sl.execute_range(q, q0, q1, PROMQL_STEP)
        b = cpu_sl.execute_range(q, q0, q1, PROMQL_STEP)
        assert a.series == b.series and a.values.shape == b.values.shape, q
        assert np.array_equal(np.isnan(a.values), np.isnan(b.values)), q
        assert np.isfinite(full.values).any(), q
        per_row = len(b.series) == n  # a series-wise result: rows align with the slice
        bound = family_bound(kind, sl, steps, b.values) if per_row else 0.0
        d = np.abs(a.values - b.values)
        ok = ~np.isnan(b.values)
        assert (d[ok] <= np.broadcast_to(bound, d.shape)[ok]).all(), (q, float(d[ok].max()))
        out[q] = {"wall_ms": wall * 1e3, "peak_mem_gib": peak / 2**30,
                  "rows": full.values.shape[0], "card_vs_cpu_max_abs": float(d[ok].max())}
        log(f"phase12 [{card}] {q}: {full.values.shape[0]} x {full.values.shape[1]} in "
            f"{wall * 1e3:.1f} ms, peak device memory {peak / 2**30:.2f} GiB; first {n} series "
            f"card == CPU within the {kind} bound (largest |diff| {float(d[ok].max()):.3e})")
    return out


def bytes_to_quantiles(seed: int, G: int, B: int, dev, card: str) -> tuple:
    """Phase 13: phase 12's counters encoded with the port's encoder on
    the card, then ``decode_rate_hq`` from the stream words.  M3TSZ takes
    a value within one ulp of a decimal (x 10^k, k < 7) as that decimal
    (the reference's convertToIntFloat), so a few random doubles come
    back snapped: the decoded timestamps and value bits are held against
    the codec's host path (``decode_batch``) exactly, and against the
    generated values, which they equal but for those snaps (a few ulp
    each).
    The engine's f64 ``rate`` over the decoded samples must equal the
    pipeline's rates bit for bit, and its ``histogram_quantile(0.99, sum
    by (le) (rate(...)))`` the pipeline's hq within rtol 1e-12 (the
    bucket sums add in other orders).  Kernel #2's own outputs in
    ``decode_to_step_series`` and in the counted ``decode_rate_hq`` run
    are held bit for bit against ``extract_fields64_t_plain`` on the same
    inputs, and the kernel is timed on them.  Returns (times, the four
    kernels' launches on the path)."""
    import torch

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather
    from m3_tpu_torch.parallel import sharded_query as sq
    from m3_tpu_torch.query import engine as qe

    ts, vals, ub_labels = promql_corpus(seed, G, B)
    S, P = ts.shape
    # worst case ~80 bits a point (a 32-bit delta-of-delta and a full XOR)
    out_words = P * 80 // 64 + 8
    t0 = time.perf_counter()
    streams, fb = mt.encode_batch(ts, vals, ts[:, 0].copy(), out_words=out_words, device=dev)
    enc_s = time.perf_counter() - t0
    share = float(fb.mean())
    log(f"phase13 encode {S} x {P} counters on the card: {enc_s:.2f} s, fallback share "
        f"{share:.5f}")
    assert share < 0.05, share
    keep = np.flatnonzero(~fb)
    streams = [streams[i] for i in keep]
    words, nbits = mt.pack_streams(streams)
    bucket_ids = (keep % B).astype(np.int32)
    ubs = np.array([np.inf if u == b"+Inf" else float(u) for u in ub_labels])
    q_start = PROMQL_START + RATE_WIN
    steps = np.arange(q_start, q_start + PROMQL_RANGE + 1, PROMQL_STEP, dtype=np.int64)
    w_d = torch.from_numpy(words.view(np.int64)).to(dev)
    nb_d = torch.from_numpy(nbits).to(dev)

    h_ts, h_vals, h_counts, h_fb = mt.decode_batch(streams, P + 1, device=dev)
    assert not h_fb.any() and (h_counts == P).all()
    h_ts, h_vals = h_ts[:, :P], h_vals[:, :P]
    assert np.array_equal(h_ts, ts[keep])
    snapped = h_vals.view(np.int64) != vals[keep].view(np.int64)
    ulps = np.abs(h_vals.view(np.int64)[snapped] - vals[keep].view(np.int64)[snapped])
    # within one ulp of N at 10^k, so within a few ulp of N / 10^k
    assert snapped.mean() < 1e-5 and (ulps <= 4).all(), (int(snapped.sum()), ulps[:5])
    with KernelCheck(mt, "extract_fields64_t",
                     decode_gather.extract_fields64_t_plain) as check13:
        d_ts, d_vals, d_err = sq.decode_to_step_series(w_d, nb_d, P + 1)
    assert not bool(d_err.any())
    assert np.array_equal(d_ts[:, :P].cpu().numpy(), h_ts)
    assert np.array_equal(d_vals[:, :P].cpu().numpy().view(np.int64), h_vals.view(np.int64)), \
        "decoded value bits"
    log(f"phase13 decoded timestamps and value bits == the codec's host path for "
        f"{len(keep)} series; {int(snapped.sum())} of {snapped.size} values snapped to a "
        f"decimal by M3TSZ, at most {int(ulps.max(initial=0))} ulp from the generated value")
    del d_ts, d_vals, d_err

    run = lambda: sq.decode_rate_hq(w_d, nb_d, bucket_ids, steps, ubs, RATE_WIN, 0.99,
                                    P + 1, B, device=dev)
    run()  # warm-up
    with KernelCheck(mt, "extract_fields64_t",
                     decode_gather.extract_fields64_t_plain) as check:
        zero_launches()
        rates, hq, errs = run()
        torch.cuda.synchronize()
        launches = read_launches()
    log(f"phase13 launches of the four kernels in decode_rate_hq: {launches}")
    assert launches["extract_fields64_t"] > 0, launches
    ext = check.summary(check13)
    log(f"phase13 extract_fields64_t: the path's own outputs bit-equal to the plain version "
        f"on the same inputs in decode_to_step_series and decode_rate_hq "
        f"({ext['ext_calls']} calls; words {ext['ext_words_shape']}, lanes "
        f"{ext['ext_lanes_shape']}); kernel {ext['ext_ms']:.3f} ms, plain "
        f"{ext['ext_plain_ms']:.3f} ms, bound {ext['ext_bound_ms']:.3f} ms (bytes)")
    walls = []
    for _ in range(QUERY_TIMED_RUNS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = profiled(run)

    raw = raw_block(ts, vals, ub_labels, keep)
    raw.values = h_vals  # what storage would hand the engine: the decoded samples
    eng = qe.Engine(BlockStorage(raw), device=dev)
    want_rates = eng.execute_range("rate(m3_req_bucket[5m])", int(steps[0]), int(steps[-1]),
                                   PROMQL_STEP)
    want_hq = eng.execute_range(
        "histogram_quantile(0.99, sum by (le) (rate(m3_req_bucket[5m])))",
        int(steps[0]), int(steps[-1]), PROMQL_STEP)
    assert not bool(errs.any())
    r = rates.cpu().numpy()
    assert np.array_equal(r.view(np.int64), want_rates.values.view(np.int64)), "rates"
    h = hq.cpu().numpy()
    assert want_hq.values.shape == (1, len(steps))
    assert np.array_equal(np.isnan(h), np.isnan(want_hq.values[0]))
    hq_err = rel_err(h, want_hq.values[0])
    assert hq_err <= 1e-12, hq_err
    many = many_buckets_check(w_d, nb_d, rates, steps, P, dev)
    t = {"series": int(len(keep)), "encode_s": enc_s, "fallback_share": share, **many,
         "snapped_values": int(snapped.sum()),
         "pipeline_best_ms": min(walls) * 1e3, "pipeline_runs_ms": [w * 1e3 for w in walls],
         "profiled_wall_ms": prof["wall_s"] * 1e3, "device_busy_ms": prof["busy_s"] * 1e3,
         "device_idle_share": 1 - prof["busy_s"] / prof["wall_s"],
         "device_idle_share_vs_best": 1 - prof["busy_s"] / min(walls),
         "device_ops": prof["ops"], "hq_vs_engine_max_rel_err": hq_err, **ext}
    log(f"phase13 [{card}] bytes -> quantiles: rates == the engine's over the decoded "
        f"samples bit for bit, hq == the engine's sum-by-le form within rtol 1e-12 "
        f"(largest {hq_err:.3e}); times " + json.dumps(t))
    return t, launches


def many_buckets_check(w_d, nb_d, rates, steps, P: int, dev) -> dict:
    """Phase 13, B = 66 (past the masked sum's 64 buckets): the first
    66 x 32 streams as 66 buckets through ``decode_rate_hq`` twice on the
    card and once on the CPU; rates, bucket sums (kernel #3 adding each
    (bucket, step) lane's rates in series order) and hq bit-equal.  Then
    the bucket sum's time at the path's width (the phase's rates, 66
    buckets) beside the masked form at 64 buckets (pairwise folds), the
    same masked form reduced by ``sum`` (whose order differs between the
    card and the CPU) and ``index_add_``."""
    import torch

    from m3_tpu_torch.parallel import sharded_query as sq

    B = 66
    n = B * 32
    bid = torch.arange(n, dtype=torch.int32) % B
    ubs = np.concatenate([np.arange(1, B, dtype=np.float64), [np.inf]])
    args = (w_d[:n].cpu(), nb_d[:n].cpu(), bid, steps, ubs, RATE_WIN, 0.99, P + 1, B)
    r_h, h_h, _ = sq.decode_rate_hq(*args, device="cpu")
    s_h = sq._bucket_sum(r_h, bid, B)
    for run in range(2):
        r_c, h_c, _ = sq.decode_rate_hq(*args, device=dev)
        s_c = sq._bucket_sum(r_c, bid.to(dev), B)
        assert same_bits(r_c.cpu(), r_h) and same_bits(s_c.cpu(), s_h), f"B=66 run {run}"
        assert same_bits(h_c.cpu(), h_h), f"B=66 hq run {run}"
    S = rates.shape[0]
    bid_full = (torch.arange(S, device=dev) % B).to(torch.int32)
    r0 = torch.nan_to_num(rates)
    out = torch.zeros((B, rates.shape[1]), dtype=torch.float64, device=dev)
    t = {"b66_series": n, "b66_card_vs_cpu_bit_equal_runs": 2,
         "b66_bucket_sum_ms": cuda_ms(lambda: sq._bucket_sum(rates, bid_full, B)),
         "b64_masked_sum_ms": cuda_ms(lambda: sq._bucket_sum(rates, bid_full % 64, 64)),
         "b64_torch_sum_ms": cuda_ms(lambda: torch.stack([
             torch.where((bid_full % 64 == b)[:, None], r0, 0.0).sum(dim=0) for b in range(64)])),
         "b66_index_add_ms": cuda_ms(lambda: out.zero_().index_add_(0, bid_full.long(), r0)),
         "b66_bucket_sum_shape": list(rates.shape)}
    log(f"phase13 B=66: rates, bucket sums and hq bit-equal card (twice) vs CPU on {n} "
        f"streams; bucket sum at {list(rates.shape)}: kernel #3 {t['b66_bucket_sum_ms']:.3f} ms, "
        f"masked sum at 64 buckets {t['b64_masked_sum_ms']:.3f} ms (by torch.sum "
        f"{t['b64_torch_sum_ms']:.3f} ms), index_add_ "
        f"{t['b66_index_add_ms']:.3f} ms")
    return t


# ---- phases 14-15: the storage node -------------------------------------

BLOCK = 2 * 3600 * SEC  # NamespaceOptions() block size
STORE_START = (1_700_000_000 * SEC) // BLOCK * BLOCK  # a block boundary
STORE_SCRAPE = 10 * SEC
STORE_SERIES = 100_000  # config #2's width
STORE_SCRAPES = 120  # of the block's 720 (PERF.md §4)
STORE_ENTRY_SCRAPES = 5  # of the 720 through Database.write_batch (PERF.md §4)
STORE_TAIL_SCRAPES = 10  # of the next block, replayed from the commit log (PERF.md §4)
STORE_CHECK_SERIES = 1024  # the card-vs-CPU Database (PERF.md §4)
STORE_CHECK_SCRAPES = 64  # its scrapes, late writes from scrape 61 on (PERF.md §4)
STORE_READ_SAMPLE = 1000
STORE_FUTURE = 100  # samples beyond bufferFuture
PROMQL_ENTRY_SCRAPES = 2  # of the 261 through Database.write_tagged_batch (PERF.md §4)


def store_root(name: str) -> Path:
    """An empty directory under the checkout's ``build/`` for one node."""
    import shutil

    root = ROOT / "build" / name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    return root


class StorageTraffic:
    """Phase 14's seeded traffic: S untagged gauges scraped every 10 s
    over one 2 h block (K scrapes; phase 3's value mix, a fixed
    whole-second offset per series: the flush encodes in seconds, and a
    sub-second timestamp would send its series to the scalar encoder), and in scrape k's batch, after
    its S samples: 1 % of scrape k-1's samples again at the same
    timestamp with another value of the same series (the later write
    wins), 0.1 % of the samples two hours late (into the block before,
    from scrape 61 on, when that block is past bufferPast: the cold
    lists), and once, at scrape 100, ``STORE_FUTURE`` samples two hours
    ahead (beyond bufferFuture: cold lists of the next block).  ``final``
    is the oracle of the block: every acknowledged sample, the last
    write winning; ``cold`` the arrival-ordered (series, ts, value) of
    the other blocks."""

    def __init__(self, seed: int, S: int, K: int = 720):
        _, vals, _ = make_batch(seed + 14, S, K)
        rng = np.random.default_rng(seed + 140)
        self.S, self.K = S, K
        self.ids = [b"node%06d.gauge" % i for i in range(S)]
        off = rng.integers(0, 10, S).astype(np.int64) * SEC
        self.ts = STORE_START + np.arange(K, dtype=np.int64)[None, :] * STORE_SCRAPE + off[:, None]
        self.vals = vals
        self.final = vals.copy()
        self.extra: list = [None] * K  # scrape k's (series, ts, value) after its S samples
        cold_s, cold_t, cold_v = [], [], []
        for k in range(K):
            parts = []
            if k >= 1:
                rw = rng.choice(S, S // 100, replace=False)
                v = vals[rw, (k + K // 2) % K]
                self.final[rw, k - 1] = v
                parts.append((rw, self.ts[rw, k - 1], v))
            if k >= 61:
                late = rng.choice(S, max(S // 1000, 1), replace=False)
                parts.append((late, self.ts[late, k] - BLOCK, vals[late, k]))
            if k == min(100, K - 1):
                fut = rng.choice(S, STORE_FUTURE, replace=False)
                parts.append((fut, self.ts[fut, k] + BLOCK, vals[fut, k]))
            for p in parts[1:] if k >= 1 else parts:
                cold_s.append(p[0])
                cold_t.append(p[1])
                cold_v.append(p[2])
            if parts:
                self.extra[k] = tuple(np.concatenate(c) for c in zip(*parts))
        self.cold = (np.concatenate(cold_s), np.concatenate(cold_t), np.concatenate(cold_v))
        self.cold_cut = len(self.cold[0])
        self.tail = 0  # scrapes written again two blocks on (``store_tail``)

    def batch(self, k: int):
        """Scrape k as (series index, ts, values) in arrival order."""
        idx = np.arange(self.S)
        if self.extra[k] is None:
            return idx, self.ts[:, k], self.vals[:, k]
        e = self.extra[k]
        return (np.concatenate([idx, e[0]]), np.concatenate([self.ts[:, k], e[1]]),
                np.concatenate([self.vals[:, k], e[2]]))

    def now(self, k: int) -> int:
        """The node's clock when scrape k arrives."""
        return STORE_START + (k + 1) * STORE_SCRAPE

    def add_cold(self, idx, ts, vals) -> None:
        """Late writes after the first flush; ``cold_cut`` marks where
        they start."""
        self.cold_cut = len(self.cold[0])
        self.cold = tuple(np.concatenate([a, b]) for a, b in zip(self.cold, (idx, ts, vals)))

    def oracle(self, idx: int) -> list:
        """Every acknowledged point of series ``idx``, sorted, the last
        write of each timestamp winning."""
        pts = dict(zip(self.ts[idx].tolist(), self.final[idx].tolist()))
        m = self.cold[0] == idx
        pts.update(zip(self.cold[1][m].tolist(), self.cold[2][m].tolist()))
        pts.update(zip((self.ts[idx, :self.tail] + 2 * BLOCK).tolist(),
                       self.vals[idx, :self.tail].tolist()))
        return sorted(pts.items())


def store_drive(db, traffic: StorageTraffic, entry: int, clock=None,
                profile_scrape: int | None = None):
    """Scrapes 0..entry-1 through ``Database.write_batch`` (shard hash,
    slot resolve, commit log, buffer), the rest through each shard's
    ``buffer.write`` with the slots already resolved.  Returns (entry
    seconds, hot seconds, hot samples, the profiled scrape's profile)."""
    import torch

    from m3_tpu_torch.storage import database as tdb

    ns = db.namespaces["default"]
    sync = (lambda: torch.cuda.synchronize()) if db.device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    for k in range(entry):
        idx, ts, vals = traffic.batch(k)
        db.write_batch("default", [traffic.ids[i] for i in idx], ts, vals,
                       now_nanos=traffic.now(k))
    sync()
    entry_s = time.perf_counter() - t0
    if clock is not None:
        clock.restore()
    shard_of = np.asarray([tdb.shard_for_id(i, ns.opts.num_shards) for i in traffic.ids])
    slot_of = np.asarray([ns.shards[sh].slots.get(i) for sh, i in zip(shard_of, traffic.ids)],
                         np.int32)
    prof = None

    def scrape(k):
        idx, ts, vals = traffic.batch(k)
        now = traffic.now(k)
        sh_of = shard_of[idx]
        for sh, shard in enumerate(ns.shards):
            m = sh_of == sh
            shard.buffer.write(slot_of[idx[m]], ts[m], vals[m], shard.open_starts(now))
        return len(idx)

    n_hot = 0
    t0 = time.perf_counter()
    for k in range(entry, traffic.K):
        if k == profile_scrape:
            sync()
            dt = time.perf_counter() - t0
            prof = profiled(lambda: scrape(k))
            n_hot += traffic.S + (0 if traffic.extra[k] is None else len(traffic.extra[k][0]))
            t0 = time.perf_counter() - dt
            continue
        n_hot += scrape(k)
    sync()
    return entry_s, time.perf_counter() - t0, n_hot, prof


def store_tail(db, traffic: StorageTraffic, n: int) -> int:
    """Scrapes 0..n-1 again two blocks later (the block after the
    flushed ones, open) through ``Database.write_batch``, every sample
    warm; left unflushed, they are what a restart replays from the
    commit log.  Returns the samples written."""
    for k in range(n):
        res = db.write_batch("default", traffic.ids, traffic.ts[:, k] + 2 * BLOCK,
                             traffic.vals[:, k], now_nanos=traffic.now(k) + 2 * BLOCK)
        assert int(res) == 0, int(res)  # none cold
        traffic.tail = k + 1
    return n * traffic.S


def fileset_volumes(root, name: str = "default"):
    """[(shard, block_start, volume)] of every volume on disk."""
    from m3_tpu_torch.persist.fs import list_fileset_volumes

    out = []
    for sh in sorted(int(p.name) for p in (Path(root) / "data" / name).iterdir()):
        out += [(sh, bs, v) for bs, v in sorted(list_fileset_volumes(root, name, sh))]
    return out


def volume_digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((Path(root) / "data").rglob("*")) if p.is_file()}


def store_flush(db, traffic: StorageTraffic, cold_n: int = 1000):
    """The flush sequence: tick past the block's end plus bufferPast
    (warm flush of each shard: drain sort, ``encode_batch``, fileset
    write; the late samples' block flushed cold as volume 0), then
    ``cold_n`` more late writes into that block and a tick (its volume
    1, merged), then a tick past the next block (the future samples'
    volume 0).  Returns the three ticks' stats."""
    now = STORE_START + BLOCK + 10 * 60 * SEC + SEC
    stats = [db.tick(now)]
    rng = np.random.default_rng(traffic.S)
    idx = rng.choice(traffic.S, min(cold_n, traffic.S), replace=False)
    ts = STORE_START - BLOCK + 30 * 60 * SEC + idx.astype(np.int64) * 1000
    vals = traffic.vals[idx, 7]
    res = db.write_batch("default", [traffic.ids[i] for i in idx], ts, vals, now_nanos=now)
    assert int(res) == len(idx), int(res)  # all cold
    traffic.add_cold(idx, ts, vals)
    stats.append(db.tick(now + SEC))
    stats.append(db.tick(STORE_START + 2 * BLOCK + 11 * 60 * SEC))
    return stats


def store_check_volumes(db, traffic: StorageTraffic, dev) -> dict:
    """Every volume read with ``DataFileSetReader`` and decoded on the
    card with ``decode_batch`` (kernel #2; the warm volumes of the four
    shards in one call, the cold ones in another), equal bit for bit to
    the traffic's oracle: the warm block to ``final``; each cold volume
    to the late or future writes of its block that had arrived when it
    was written, the last write of each (series, ts) winning."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.persist.fs import DataFileSetReader
    from m3_tpu_torch.storage.buffer import dedupe_last_write_wins

    root = db.opts.root
    pos = {sid: i for i, sid in enumerate(traffic.ids)}
    vols = fileset_volumes(root)
    top = {}
    for sh, bs, v in vols:
        top[(sh, bs)] = max(top.get((sh, bs), -1), v)
    warm, cold = [], []  # (rows, streams) / (block, cut, rows, streams)
    for sh, bs, v in vols:
        r = DataFileSetReader(root, "default", sh, bs, v)
        series = list(r.read_all())
        r.close()
        rows = np.asarray([pos[sid] for sid, _ in series])
        segs = [seg for _, seg in series]
        if bs == STORE_START:
            warm.append((rows, segs))
        else:  # a lower volume holds what had come before the later cold writes
            cut = len(traffic.cold[0]) if v == top[(sh, bs)] else traffic.cold_cut
            cold.append((bs, cut, rows, segs))
    rows = np.concatenate([w[0] for w in warm])
    assert np.array_equal(np.sort(rows), np.arange(traffic.S)), "warm volumes miss series"
    d_ts, d_vals, counts, dfb = mt.decode_batch([s for w in warm for s in w[1]], traffic.K,
                                                device=dev)
    assert not dfb.any() and (counts == traffic.K).all()
    assert np.array_equal(d_ts, traffic.ts[rows]), "warm volume timestamps"
    assert np.array_equal(d_vals.view(np.int64), traffic.final[rows].view(np.int64)), \
        "warm volume values"
    points = int(counts.sum())
    cap = 64
    c_ts, c_vals, c_counts, c_fb = mt.decode_batch([s for c in cold for s in c[3]], cap,
                                                   device=dev)
    assert not c_fb.any() and (c_counts < cap).all()
    j = 0
    for bs, cut, crows, _ in cold:
        ci, ct, cv = (a[:cut] for a in traffic.cold)
        m = (ct >= bs) & (ct < bs + BLOCK)
        s_, t_, v_ = dedupe_last_write_wins(ci[m].astype(np.int32), ct[m], cv[m])
        assert set(crows.tolist()) <= set(s_.tolist())
        for row in crows:
            sel = s_ == row
            n = int(c_counts[j])
            assert n == int(sel.sum()), (bs, row)
            assert np.array_equal(c_ts[j, :n], t_[sel])
            assert np.array_equal(c_vals[j, :n].view(np.int64), v_[sel].view(np.int64))
            j += 1
        points += int(c_counts[j - len(crows):j].sum())
    # every late or future series is in some volume of its block
    for bs in {c[0] for c in cold}:
        ci, ct = traffic.cold[0], traffic.cold[1]
        want = set(ci[(ct >= bs) & (ct < bs + BLOCK)].tolist())
        got = set(np.concatenate([c[2] for c in cold if c[0] == bs and
                                  c[1] == len(traffic.cold[0])]).tolist())
        assert want == got, bs
    return {"volumes": len(vols), "series_points": points,
            "cold_blocks": sorted({c[0] for c in cold})}


def store_read_check(db, traffic: StorageTraffic, n: int, seed: int) -> list:
    """``read_batch`` of n sampled series over the four blocks against
    the oracle; returns the sample's ids."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(traffic.S, min(n, traffic.S), replace=False))
    sids = [traffic.ids[i] for i in rows]
    got = db.read_batch("default", sids, STORE_START - BLOCK, STORE_START + 3 * BLOCK)
    for i, pts in zip(rows, got):
        want = traffic.oracle(int(i))
        assert [t for t, _ in pts] == [t for t, _ in want], i
        assert (np.asarray([v for _, v in pts]).view(np.int64).tolist()
                == np.asarray([v for _, v in want]).view(np.int64).tolist()), i
    return sids


def storage_node(seed: int, S: int, dev, card: str) -> tuple:
    """Phase 14: the storage node's write -> flush -> read path at
    BASELINE config #2's shape, ``NamespaceOptions()`` defaults (2 h
    blocks, 48 h retention, bufferPast 10 m, bufferFuture 2 m, 4 shards,
    cold writes on), commit log on.  Returns (times, the four kernels'
    launches on the path, their launches in the volume check, kernel
    #1's record at the path's shapes)."""
    import torch

    from m3_tpu_torch.core.slots import SlotAllocator
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.persist.commitlog import CommitLogWriter
    from m3_tpu_torch.persist.fs import DataFileSetWriter
    from m3_tpu_torch.storage import buffer as tbuf
    from m3_tpu_torch.storage import database as tdb

    t_gen = time.perf_counter()
    traffic = StorageTraffic(seed, S, STORE_SCRAPES)
    log(f"phase14 data: {S} untagged gauges x {traffic.K} scrapes at 10 s over one 2 h "
        f"block ({S * traffic.K:,} samples), {sum(len(e[0]) for e in traffic.extra if e is not None):,} "
        f"more (1 % rewrites, 0.1 % late, {STORE_FUTURE} ahead); generated in "
        f"{time.perf_counter() - t_gen:.1f} s")
    root = store_root("phase14")
    db = tdb.Database(tdb.DatabaseOptions(root=str(root)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    clock = HostClock()
    clock.wrap(tdb, "shard_for_id", "shard_hash")
    clock.wrap(SlotAllocator, "resolve", "slot_resolve")
    clock.wrap(tbuf.ShardBuffer, "write", "buffer_write")
    clock.wrap(CommitLogWriter, "write_batch", "commit_log")
    events: list = []
    real_append = tbuf.buffer_append

    def timed_append(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_append(*a)
        e1.record()
        events.append((e0, e1))
        return out

    entry = min(STORE_ENTRY_SCRAPES, traffic.K)
    entry_samples = sum(len(traffic.batch(k)[0]) for k in range(entry))
    tbuf.buffer_append = timed_append
    try:
        entry_s, hot_s, hot_n, prof = store_drive(db, traffic, entry, clock=clock,
                                                  profile_scrape=traffic.K // 2)
    finally:
        tbuf.buffer_append = real_append
    entry_split = dict(clock.s)
    torch.cuda.synchronize()
    n_shards = db.namespaces["default"].opts.num_shards
    hot_events = events[entry * n_shards:]  # the entry scrapes' appends come first
    append_ms = [a.elapsed_time(b) for a, b in hot_events]
    buffered = {sh.shard_id: int(sh.buffer._n_host.sum()) for sh in db.namespaces["default"].shards}
    log(f"phase14 [{card}] entry {entry} scrapes: {entry_samples / entry_s:,.0f} samples/s; "
        f"hot loop {traffic.K - entry} scrapes: {hot_n / hot_s:,.0f} samples/s; buffered per "
        f"shard {buffered}; ring lanes per window "
        f"{db.namespaces['default'].shards[0].buffer.sample_capacity:,}")

    # the flush, with kernel #1 held against its plain version on its inputs
    fclock = HostClock()
    fclock.wrap(tbuf.ShardBuffer, "_drain_row", "drain")
    fclock.wrap(DataFileSetWriter, "write_all", "fileset_write")
    fclock.wrap(tdb.Shard, "_encode_runs", "encode_runs")
    enc_t: list = []
    real_encode = tdb.encode_batch

    def timed_encode(*a, **kw):
        kw["timings"] = t = {}
        t0 = time.perf_counter()
        out = real_encode(*a, **kw)
        t["wall"] = time.perf_counter() - t0
        enc_t.append(t)
        return out

    tdb.encode_batch = timed_encode
    try:
        with KernelCheck(mt, "place_words", encode_place.place_words_plain) as check:
            t0 = time.perf_counter()
            ticks = store_flush(db, traffic)
            flush_s = time.perf_counter() - t0
    finally:
        fclock.restore()
        tdb.encode_batch = real_encode
    torch.cuda.synchronize()
    launched = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"phase14 ticks: " + json.dumps(ticks))
    log(f"phase14 launches on the storage path: {launched}")
    assert launched["place_words"] == n_shards == len(enc_t), (launched, len(enc_t))
    assert check.calls == n_shards
    frags, keys, w_out = check.args
    place = {"storage_ms": cuda_ms(lambda: check.fn(frags, keys, w_out)),
             "storage_plain_ms": cuda_ms(lambda: encode_place.place_words_plain(frags, keys, w_out)),
             "storage_bound_ms": (frags.numel() * (8 + 4) + frags.shape[0] * w_out * 8)
             / HBM_BYTES_PER_S * 1e3,
             "storage_shape": [list(frags.shape), w_out], "storage_max_abs_err": check.err}
    del check, frags, keys
    log(f"phase14 place_words on the flush's inputs ({place['storage_shape']}): bit-equal to "
        f"the plain version in {n_shards} calls; {place['storage_ms']:.3f} ms, plain "
        f"{place['storage_plain_ms']:.3f} ms, bound {place['storage_bound_ms']:.3f} ms")

    # every volume decoded on the card against the oracle (kernel #2)
    zero_launches()
    t0 = time.perf_counter()
    with KernelCheck(mt, "extract_fields64_t",
                     decode_gather.extract_fields64_t_plain) as dcheck:
        vols = store_check_volumes(db, traffic, dev)
    check_s = time.perf_counter() - t0
    dec_launched = read_launches()
    assert dec_launched["extract_fields64_t"] > 0 and dcheck.calls > 0
    log(f"phase14 {vols['volumes']} volumes decoded on the card == the last-write-wins oracle "
        f"bit for bit ({vols['series_points']:,} points; {check_s:.1f} s); kernel #2 outputs "
        f"== plain in {dcheck.calls} calls")
    del dcheck
    zero_launches()
    t0 = time.perf_counter()
    sids = store_read_check(db, traffic, STORE_READ_SAMPLE, seed)
    read_s = time.perf_counter() - t0
    log(f"phase14 read_batch of {len(sids)} series == the oracle ({read_s:.2f} s)")
    # a restart: snapshot (rotating the commit log) and cleanup reclaim the
    # flushed blocks' log; the tail scrapes then fill the next block's log,
    # which the restart's bootstrap replays into the card's buffers
    snap = db.snapshot()
    clean = db.cleanup(STORE_START + 2 * BLOCK + 12 * 60 * SEC)
    t0 = time.perf_counter()
    n_tail = store_tail(db, traffic, STORE_TAIL_SCRAPES)
    tail_s = time.perf_counter() - t0
    db.close()
    db = tdb.Database(tdb.DatabaseOptions(root=str(root)), device=dev)
    t0 = time.perf_counter()
    boot = db.bootstrap()
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    assert boot["commitlog_replayed"] == n_tail, (boot, n_tail)
    store_read_check(db, traffic, STORE_READ_SAMPLE, seed)
    db.close()
    read_launched = read_launches()
    assert not any(read_launched.values()), read_launched  # reads decode on the host
    log(f"phase14 after snapshot {snap} and cleanup {clean}: {STORE_TAIL_SCRAPES} scrapes of "
        f"the next block through write_batch ({n_tail:,} samples, {n_tail / tail_s:,.0f} "
        f"samples/s), left unflushed; a restart's bootstrap {boot} in {boot_s:.2f} s "
        f"({n_tail / boot_s:,.0f} samples/s); the same reads, that block too, == the oracle")

    # card and CPU Databases fed the same traffic write the same bytes
    t0 = time.perf_counter()
    small = StorageTraffic(seed + 1, STORE_CHECK_SERIES, STORE_CHECK_SCRAPES)
    digests = []
    for d in (dev, "cpu"):
        r = store_root(f"phase14-{torch.device(d).type}")
        sdb = tdb.Database(tdb.DatabaseOptions(root=str(r)), device=d)
        store_drive(sdb, small, entry)
        store_flush(sdb, small, cold_n=100)
        sdb.close()
        digests.append(volume_digests(r))
    assert digests[0] == digests[1] and len(digests[0]) > 0
    log(f"phase14 card and CPU Databases fed {STORE_CHECK_SERIES} series x {small.K} scrapes "
        f"wrote identical volume files ({len(digests[0])} files, sha256; "
        f"{time.perf_counter() - t0:.1f} s)")

    drains = fclock.s.get("drain", 0.0)
    t = {"series": S, "scrapes": traffic.K, "entry_scrapes": entry,
         "entry_samples_per_s": entry_samples / entry_s, "entry_s": entry_s,
         **{f"entry_split_{k}_s": v for k, v in entry_split.items()},
         "entry_split_other_s": entry_s - sum(entry_split.values()),
         "hot_samples_per_s": hot_n / hot_s, "hot_s": hot_s,
         "append_device_ms_mean": float(np.mean(append_ms)),
         "append_device_ms_max": float(np.max(append_ms)), "appends_timed": len(append_ms),
         "scrape_profiled_wall_ms": prof["wall_s"] * 1e3,
         "scrape_device_busy_ms": prof["busy_s"] * 1e3,
         "scrape_device_idle_share": 1 - prof["busy_s"] / prof["wall_s"],
         "scrape_device_ops": prof["ops"],
         "flush_s": flush_s, "drain_ms_per_shard": drains * 1e3 / max(fclock.calls.get("drain", 1), 1),
         "drain_calls": fclock.calls.get("drain", 0),
         "encode_s_per_shard": [e["wall"] for e in enc_t],
         "encode_phase1_s_per_shard": [e["phase1"] for e in enc_t],
         "encode_phase2_s_per_shard": [e["phase2"] for e in enc_t],
         "encode_host_s_per_shard": [e["host"] for e in enc_t],
         "encode_runs_host_rest_s": fclock.s.get("encode_runs", 0.0)
         - sum(e["wall"] for e in enc_t),
         "fileset_write_s": fclock.s.get("fileset_write", 0.0),
         "fileset_writes": fclock.calls.get("fileset_write", 0),
         "peak_mem_gib": peak / 2**30, "volumes": vols["volumes"],
         "check_decode_s": check_s, "read_batch_s": read_s,
         "tail_samples": n_tail, "tail_samples_per_s": n_tail / tail_s,
         "bootstrap_s": boot_s, "bootstrap_samples_per_s": n_tail / boot_s}
    log(f"phase14 [{card}] storage node: " + json.dumps(t))
    return t, launched, dec_launched, place


def promql_over_storage(seed: int, G: int, B: int, dev, card: str) -> dict:
    """Phase 15: BASELINE config #5's counters (phase 12's generator)
    written into one open block of a storage node (``NamespaceOptions()``
    defaults, commit log on): the first ``PROMQL_ENTRY_SCRAPES`` scrapes
    through ``Database.write_tagged_batch`` (index insert, commit log),
    the rest through the shard buffers with the slots resolved; then
    ``histogram_quantile(0.99, rate(m3_req_bucket[5m]))`` over 1 h at 15 s
    through ``Engine(DatabaseStorage(db))`` on the card, (a) from the
    open block (the samples in the device buffer), equal to the same
    engine over the in-memory block of phase 12; (b) after ``tick``
    flushes the block to filesets, over the groups whose label ends in 00
    (1 %), equal to (a) on those groups within rtol 1e-12, its points
    read equal bit for bit to the codec's batched host decode of the
    volumes."""
    import torch

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.index.doc import Document
    from m3_tpu_torch.persist.fs import DataFileSetReader
    from m3_tpu_torch.query import engine as qe
    from m3_tpu_torch.query.storage_adapter import DatabaseStorage
    from m3_tpu_torch.storage import database as tdb

    ts, vals, ub_labels = promql_corpus(seed, G, B)
    S, P = ts.shape
    block = PROMQL_START // BLOCK * BLOCK
    assert ts.max() < block + BLOCK  # one block
    docs = [Document.from_tags(
        b"m3_req_bucket{group=g%06d,le=%s}" % (i // B, ub_labels[i % B]),
        {b"__name__": b"m3_req_bucket", b"group": b"g%06d" % (i // B),
         b"le": ub_labels[i % B]}) for i in range(S)]
    root = store_root("phase15")
    db = tdb.Database(tdb.DatabaseOptions(root=str(root)), device=dev)
    entry = min(PROMQL_ENTRY_SCRAPES, P)
    t0 = time.perf_counter()
    for k in range(entry):
        db.write_tagged_batch("default", docs, ts[:, k], vals[:, k],
                              now_nanos=int(ts[0, k]) + SEC)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    ns = db.namespaces["default"]
    shard_of = np.asarray([tdb.shard_for_id(d.id, ns.opts.num_shards) for d in docs])
    slot_of = np.asarray([ns.shards[sh].slots.get(d.id) for sh, d in zip(shard_of, docs)],
                         np.int32)
    t0 = time.perf_counter()
    for k in range(entry, P):
        now = int(ts[0, k]) + SEC
        for sh, shard in enumerate(ns.shards):
            m = shard_of == sh
            shard.buffer.write(slot_of[m], ts[m, k], vals[m, k], shard.open_starts(now))
    torch.cuda.synchronize()
    hot_s = time.perf_counter() - t0
    log(f"phase15 data: {S} tagged counters x {P} samples at 15 s into one open block: "
        f"{entry} scrapes through write_tagged_batch ({entry * S / entry_s:,.0f} samples/s), "
        f"{P - entry} through the shard buffers ({(P - entry) * S / hot_s:,.0f} samples/s)")

    q_start = PROMQL_START + RATE_WIN
    q_end = q_start + PROMQL_RANGE
    eng = qe.Engine(DatabaseStorage(db), device=dev)
    mem_eng = qe.Engine(BlockStorage(raw_block(ts, vals, ub_labels, np.arange(S))), device=dev)
    sel_q = 'histogram_quantile(0.99, rate(m3_req_bucket{group=~".*00"}[5m]))'
    store_rows = ((tdb.Database, "query_ids", "index_query"),
                  (tdb.Database, "read", "series_reads"))

    def by_group(blk):
        return {m.as_dict()[b"group"]: row for m, row in zip(blk.series, blk.values)}

    fetched: dict = {}
    real_fetch = DatabaseStorage.fetch_raw

    def keep_fetch(self, *a):
        fetched["raw"] = raw = real_fetch(self, *a)
        return raw

    def measured(q):
        """One eval under the profiler with the host rows clocked (the
        profiler records no Python frames: it adds little to a host-bound
        eval)."""
        out = {}
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        DatabaseStorage.fetch_raw = keep_fetch
        try:
            prof = profiled(lambda: out.__setitem__("split", query_host_split(
                lambda: out.__setitem__("blk", eng.execute_range(
                    q, q_start, q_end, PROMQL_STEP)), extra=store_rows)))
        finally:
            DatabaseStorage.fetch_raw = real_fetch
        split = out["split"]
        launched = read_launches()
        peak = torch.cuda.max_memory_allocated()
        busy = prof["busy_no_htod_s"] + split["upload_copies_device_ms"] * 1e-3
        assert not any(launched.values()), launched  # raw samples: no hand kernel
        t = {"eval_ms": split["wall_ms"], **{f"split_{k}": v for k, v in split.items()
                                             if k != "wall_ms"},
             "profiled_wall_ms": prof["wall_s"] * 1e3, "device_busy_ms": busy * 1e3,
             "device_idle_share": 1 - busy / prof["wall_s"],
             "device_ops": prof["ops_no_htod"] + split["uploads"],
             "peak_mem_gib": peak / 2**30}
        return out["blk"], t

    blk_a, t_a = measured(HQ_QUERY)
    want = mem_eng.execute_range(HQ_QUERY, q_start, q_end, PROMQL_STEP)
    ga, gm = by_group(blk_a), by_group(want)
    assert len(ga) == G and ga.keys() == gm.keys()
    for g, row in gm.items():
        assert np.array_equal(ga[g].view(np.int64), row.view(np.int64)), g
    log(f"phase15 (a) from the open block: {G} groups == the engine over the in-memory "
        f"block bit for bit; " + json.dumps(t_a))
    del mem_eng, want

    # the flush, then (b) over 1 % of the groups from the filesets
    t0 = time.perf_counter()
    stats = db.tick(block + BLOCK + 10 * 60 * SEC + SEC)
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    assert stats["default"]["warm_flushed"] == S and stats["default"]["index_sealed"] == 1, stats
    blk_b, t_b = measured(sel_q)
    gb = by_group(blk_b)
    assert len(gb) == G // 100 and all(g.endswith(b"00") for g in gb)
    worst = 0.0
    for g, row in gb.items():
        assert np.array_equal(np.isnan(row), np.isnan(ga[g])), g
        worst = max(worst, rel_err(row, ga[g]))
    assert worst <= CARD_VS_CPU_RTOL["f64"], worst
    # the points (b) read: the codec's batched host decode of the volumes
    raw = fetched["raw"]
    le_pos = {u: k for k, u in enumerate(ub_labels)}
    rows = np.asarray([int(m.as_dict()[b"group"][1:]) * B + le_pos[m.as_dict()[b"le"]]
                       for m in raw.series])
    assert len(rows) == S // 100 and ((rows // B) % 100 == 0).all()
    streams = {}
    for sh in range(ns.opts.num_shards):
        r = DataFileSetReader(str(root), "default", sh, block, 0)
        streams.update(r.read_all())
        r.close()
    h_ts, h_vals, h_counts, h_fb = mt.decode_batch([streams[docs[i].id] for i in rows], P + 1,
                                                   device="cpu")
    assert not h_fb.any() and (h_counts == P).all()
    lo = int(raw.ts[:, 0].min())
    hi = int(raw.ts[np.arange(len(rows)), raw.counts - 1].max())
    keep = (h_ts[0, :P] >= lo) & (h_ts[0, :P] <= hi)
    n = int(keep.sum())
    assert (raw.counts == n).all(), (raw.counts.min(), n)
    assert np.array_equal(raw.ts[:, :n], h_ts[:, :P][:, keep])
    assert np.array_equal(raw.values[:, :n].view(np.int64),
                          h_vals[:, :P][:, keep].view(np.int64)), "points read"
    snapped = int((h_vals[:, :P].view(np.int64) != vals[rows].view(np.int64)).sum())
    sel = rows
    log(f"phase15 (b) after the flush ({flush_s:.1f} s): {len(gb)} groups == (a) within rtol "
        f"1e-12 (largest {worst:.3e}); the points read == the codec's host decode of the "
        f"volumes bit for bit ({len(sel)} series x {n} points; {snapped} values snapped to a "
        f"decimal by M3TSZ); " + json.dumps(t_b))
    db.close()
    return {"entry_scrapes": entry, "entry_samples_per_s": entry * S / entry_s,
            "hot_samples_per_s": (P - entry) * S / hot_s, "open_block": t_a,
            "flush_s": flush_s, "after_flush": t_b, "after_flush_max_rel_err": worst,
            "snapped_values": snapped}


# ---- phases 16-17: the coordinator downsampler, cross-shard forwarding ----

# BASELINE config #3's width: 1,000,000 counters http_requests_total over
# {app: 100, endpoint: 20, status_code: 5, instance: 100}
DS_APPS, DS_ENDPOINTS, DS_CODES, DS_INSTANCES = 100, 20, 5, 100
DS_SERIES = DS_APPS * DS_ENDPOINTS * DS_CODES * DS_INSTANCES
DS_WINDOWS = 2  # one-minute windows (1m:48h; PERF.md §4)
DS_SCRAPES_PER_WINDOW = 2  # of the six 10 s scrapes a minute holds (PERF.md §4)
DS_CKPT_AFTER = 3  # scrapes written before the checkpoint (window 2 half open)
DS_CHECK_SERIES = 1 << 12  # the card-vs-CPU pair (PERF.md §4)
DS_POLICY = "1m:48h"  # its namespace's name is "1m:2d"
# M3's documented coordinator rollup rules: a mapping rule, a rollup to Sum
# over a groupBy list then Add, and a two-stage rollup
DS_RULES = {
    "namespace": "default", "version": 1,
    "mapping_rules": [{"name": "M", "filter": "__name__:http_requests_total",
                       "policies": [DS_POLICY]}],
    "rollup_rules": [
        {"name": "R1", "filter": "__name__:http_requests_total", "targets": [{
            "pipeline": [{"aggregation": "SUM"},
                         {"rollup": {"new_name": "http_requests_by_route",
                                     "tags": ["app", "endpoint", "status_code"],
                                     "aggregation": []}},
                         {"transformation": "ADD"}],
            "policies": [DS_POLICY]}]},
        {"name": "R2", "filter": "__name__:http_requests_total", "targets": [{
            "pipeline": [{"aggregation": "SUM"},
                         {"rollup": {"new_name": "stage1",
                                     "tags": ["app", "endpoint", "status_code"],
                                     "aggregation": []}},
                         {"rollup": {"new_name": "http_requests_by_app", "tags": ["app"],
                                     "aggregation": ["SUM"]}}],
            "policies": [DS_POLICY]}]},
    ],
}
FWD_SERIES, FWD_STAGE2 = 100_000, 20  # phase 17 (b)


class IntoCheck:
    """Within ``with``, every call of ``si.<attr>`` (an in-place aggregator
    kernel wrapper, as the arenas look it up) runs as before on the card,
    and its result columns are then held bit for bit against the plain
    version run on CPU copies of the same starting columns; the
    comparison launches no kernel."""

    def __init__(self, attr: str, plain):
        self.attr, self.plain = attr, plain
        self.calls = 0
        self.err = 0.0

    def __enter__(self):
        from m3_tpu_torch.parallel import segment_ingest as si

        fn = self.fn = getattr(si, attr := self.attr)

        def checked(*a):
            cols = [c for c in a[:-2]]
            want = [None if c is None else c.to("cpu", copy=True) for c in cols]
            fn(*a)
            self.plain(*want, a[-2].cpu(), a[-1].cpu())
            for c, w in zip(cols, want):
                if c is None:
                    continue
                assert same_bits(c.cpu(), w), f"{attr} kernel != plain on the path's inputs"
                self.err = max(self.err, max_abs_err(c.cpu(), w))
            self.calls += 1

        setattr(si, attr, checked)
        return self

    def __exit__(self, *exc):
        from m3_tpu_torch.parallel import segment_ingest as si

        setattr(si, self.attr, self.fn)
        return False


def downsample_docs(n: int):
    """The first n of the 1,000,000 series as index Documents, in the
    order (app, endpoint, status_code, instance), instance fastest; and
    each one's route group (app, endpoint, status_code) and app."""
    from m3_tpu_torch.index.doc import Document, Field

    name = Field(b"__name__", b"http_requests_total")
    apps = [b"app-%02d" % a for a in range(DS_APPS)]
    eps = [b"/api/v1/resource%02d" % e for e in range(DS_ENDPOINTS)]
    codes = [b"%d" % c for c in (200, 201, 404, 500, 503)]
    insts = [b"10.0.%d.%d:9100" % (i // 50, i % 50) for i in range(DS_INSTANCES)]
    f_app = [Field(b"app", v) for v in apps]
    f_ep = [Field(b"endpoint", v) for v in eps]
    f_code = [Field(b"status_code", v) for v in codes]
    f_inst = [Field(b"instance", v) for v in insts]
    docs = []
    for s in range(n):
        s2, i = divmod(s, DS_INSTANCES)
        s3, c = divmod(s2, DS_CODES)
        a, e = divmod(s3, DS_ENDPOINTS)
        sid = (b"http_requests_total{app=" + apps[a] + b",endpoint=" + eps[e]
               + b",instance=" + insts[i] + b",status_code=" + codes[c] + b"}")
        docs.append(Document(sid, (name, f_app[a], f_ep[e], f_inst[i], f_code[c])))
    idx = np.arange(n)
    route = idx // DS_INSTANCES
    app = route // (DS_ENDPOINTS * DS_CODES)
    return docs, route, app


class DownsampleTraffic:
    """Phase 16's seeded scrapes: per scrape, an integer delta in [0, 1000)
    for each series, at a fixed whole-millisecond offset per series inside
    its 10 s scrape slot; the numpy oracle of every output."""

    def __init__(self, seed: int, n: int):
        rng = np.random.default_rng(seed + 16)
        self.n = n
        self.K = DS_WINDOWS * DS_SCRAPES_PER_WINDOW
        self.deltas = rng.integers(0, 1000, (self.K, n)).astype(np.float64)
        self.offset = rng.integers(0, 10_000, n).astype(np.int64) * 1_000_000
        self.t0 = STORE_START  # a block boundary: every output lies in one block

    def ts(self, k: int) -> np.ndarray:
        w, j = divmod(k, DS_SCRAPES_PER_WINDOW)
        return self.t0 + w * MINUTE + j * 10 * SEC + self.offset

    def window_sums(self, route, app) -> dict:
        """(window sums per series, R1's running totals per route, R2's
        per-app sums): integers, exact in f64."""
        win = self.deltas.reshape(DS_WINDOWS, DS_SCRAPES_PER_WINDOW, self.n).sum(axis=1)
        groups = DS_APPS * DS_ENDPOINTS * DS_CODES
        by_route = np.stack([np.bincount(route, w, minlength=groups) for w in win])
        by_app = np.stack([np.bincount(app, w, minlength=DS_APPS) for w in win])
        return {"win": win, "r1": np.cumsum(by_route, axis=0), "r2": by_app}


def ds_canon(outs) -> list:
    """Flushed batches as comparable tuples (value bits)."""
    return [(fm.timestamp_nanos, int(fm.metric_type), fm.slots.tobytes(),
             fm.types.tobytes(), np.asarray(fm.values, np.float64).tobytes()) for fm in outs]


def ds_output_ids(docs, route, app) -> tuple:
    """id -> series row; R1 output id -> route group; the stage-1 ids; R2
    output id (before its ``.sum`` suffix) -> app."""
    row = {d.id: i for i, d in enumerate(docs)}
    r1, s1, r2 = {}, set(), {}
    for g in np.unique(route).tolist():
        t = docs[int(np.searchsorted(route, g))].tags()
        key = b"app=%s,endpoint=%s,status_code=%s" % (t[b"app"], t[b"endpoint"],
                                                        t[b"status_code"])
        r1[b"http_requests_by_route{" + key + b"}"] = g
        s1.add(b"stage1{" + key + b"}")
    for a in np.unique(app).tolist():
        r2[b"http_requests_by_app{app=%s}" % docs[int(np.searchsorted(app, a))].tags()[b"app"]] = a
    return row, r1, s1, r2


def ds_check_outputs(ml, outs, traffic, ids, route, app) -> dict:
    """Every flushed row of the 1m list against the numpy oracle: each
    series' window sum, R1's running totals, R2's per-app sums one window
    later; no stage-1 row flushes; nothing else."""
    from m3_tpu_torch.metrics.aggregation import AggregationType as AT
    from m3_tpu_torch.metrics.types import MetricType as MT

    oracle = traffic.window_sums(route, app)
    row, r1_ids, s1_ids, r2_ids = ids
    cmap, gmap = ml.maps[MT.COUNTER], ml.maps[MT.GAUGE]
    # slot -> (kind, index) once: 0 a series, 1 an R1 route, 2 a stage-1 id
    kind = np.full(ml.opts.capacity, -1, np.int64)
    index = np.zeros(ml.opts.capacity, np.int64)
    for s_ in range(ml.opts.capacity):
        sid = cmap.id_of(s_)
        if sid is None:
            continue
        if sid in row:
            kind[s_], index[s_] = 0, row[sid]
        elif sid in r1_ids:
            kind[s_], index[s_] = 1, r1_ids[sid]
        elif sid in s1_ids:
            kind[s_] = 2
    counts = {"series_rows": 0, "r1_rows": 0, "r2_rows": 0}
    for fm in outs:
        w = (fm.timestamp_nanos - traffic.t0) // MINUTE - 1
        if fm.metric_type == MT.COUNTER:
            assert (fm.types == int(AT.SUM)).all()
            k, ix = kind[fm.slots], index[fm.slots]
            assert not (k == 2).any(), "a stage-1 aggregate flushed locally"
            assert (k >= 0).all(), "an unknown counter row"
            m0, m1 = k == 0, k == 1
            assert np.array_equal(fm.values[m0], oracle["win"][w][ix[m0]]), w
            assert np.array_equal(fm.values[m1], oracle["r1"][w][ix[m1]]), w
            counts["series_rows"] += int(m0.sum())
            counts["r1_rows"] += int(m1.sum())
        else:
            assert fm.metric_type == MT.GAUGE and (fm.types == int(AT.SUM)).all()
            for s_, v in zip(fm.slots.tolist(), fm.values.tolist()):
                a = r2_ids[gmap.id_of(s_)]
                assert v == oracle["r2"][w - 1][a], (w, a)  # one window later
                counts["r2_rows"] += 1
    want = {"series_rows": traffic.n * DS_WINDOWS, "r1_rows": len(r1_ids) * DS_WINDOWS,
            "r2_rows": len(r2_ids) * DS_WINDOWS}
    assert counts == want, (counts, want)
    return counts


def ds_check_volumes(db, traffic, ids, route, app, dev) -> dict:
    """Every output volume decoded on the card (kernel #2) against the
    oracle: each series' three window sums, R1's running totals, R2's
    per-app sums (name suffix ``.sum``) one window later, at the
    window-end timestamps; every output series present once."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.persist.fs import DataFileSetReader

    oracle = traffic.window_sums(route, app)
    row, r1_ids, _, r2_ids = ids
    ns = "1m:2d"
    sids, segs = [], []
    for sh, bs, v in fileset_volumes(db.opts.root, ns):
        r = DataFileSetReader(db.opts.root, ns, sh, bs, v)
        for sid, seg in r.read_all():
            sids.append(sid)
            segs.append(seg)
        r.close()
    d_ts, d_vals, counts, dfb = mt.decode_batch(segs, 4, device=dev)
    assert not dfb.any() and (counts == DS_WINDOWS).all()
    ends = traffic.t0 + MINUTE * np.arange(1, DS_WINDOWS + 1)
    rows = np.fromiter((row.get(sid, -1) for sid in sids), np.int64, len(sids))
    series = rows >= 0
    want_t = np.broadcast_to(ends, (len(sids), DS_WINDOWS)).copy()
    want_v = np.empty((len(sids), DS_WINDOWS), np.float64)
    want_v[series] = oracle["win"][:, rows[series]].T
    n = {"series": int(series.sum()), "r1": 0, "r2": 0}
    for j in np.nonzero(~series)[0].tolist():
        sid = sids[j]
        if sid in r1_ids:
            want_v[j] = oracle["r1"][:, r1_ids[sid]]
            n["r1"] += 1
        else:
            assert sid.endswith(b".sum") and sid[:-4] in r2_ids, sid
            want_t[j], want_v[j] = ends + MINUTE, oracle["r2"][:, r2_ids[sid[:-4]]]
            n["r2"] += 1
    assert len(set(sids)) == len(sids)
    assert n == {"series": traffic.n, "r1": len(r1_ids), "r2": len(r2_ids)}, n
    assert np.array_equal(d_ts[:, :DS_WINDOWS], want_t), "volume timestamps"
    assert np.array_equal(d_vals[:, :DS_WINDOWS].view(np.int64), want_v.view(np.int64)), \
        "volume values"
    return {"volume_series": n, "volume_points": int(counts.sum())}


def ds_steps(traffic) -> list:
    """The phase's sequence: ("write", k) for each scrape, ("flush", now)
    whenever a window is complete, and one more flush for R2's stage 2
    of the last window."""
    steps = []
    for k in range(traffic.K):
        steps.append(("write", k))
        if (k + 1) % DS_SCRAPES_PER_WINDOW == 0:
            steps.append(("flush", traffic.t0 + (k + 1) // DS_SCRAPES_PER_WINDOW * MINUTE))
    steps.append(("flush", traffic.t0 + (DS_WINDOWS + 1) * MINUTE))
    return steps


def ds_run(ds, traffic, docs, steps, clock=None, split=None, profile_k=None, after=None,
           flush=None) -> dict:
    """``steps`` (see ``ds_steps``) through ``Downsampler.write_batch``
    and ``Downsampler.flush`` (or ``flush(now)``).  With ``clock``, its
    rows' seconds during the writes and during the flushes add into
    ``split["write"]`` and ``split["flush"]``.  Scrape ``profile_k`` runs
    under torch.profiler; ``after(step)`` runs after each step.  Returns
    seconds and the profile."""
    import torch

    from m3_tpu_torch.metrics.types import MetricType as MT

    flush = flush or (lambda now: ds.flush(now))
    out = {"write_s": [], "flush_s": [], "prof": None}

    def timed(kind, fn):
        before = dict(clock.s) if clock is not None else {}
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[kind + "_s"].append(time.perf_counter() - t0)
        if clock is not None:
            acc = split.setdefault(kind, {})
            for key, v in clock.s.items():
                acc[key] = acc.get(key, 0.0) + v - before.get(key, 0.0)

    def write(k):
        keep = ds.write_batch(docs, traffic.ts(k), traffic.deltas[k], metric_type=MT.COUNTER)
        assert keep.all()

    for step in steps:
        kind, arg = step
        if kind == "write" and arg == profile_k:
            out["prof"] = profiled(lambda: write(arg), tries=1)
        elif kind == "write":
            timed("write", lambda: write(arg))
        else:
            timed("flush", lambda: flush(arg))
        if after is not None:
            after(step)
    return out


def downsampler_phase(seed: int, dev, card: str) -> tuple:
    """Phase 16: the coordinator downsampler over the storage node at
    BASELINE config #3's width.  Returns (times, the four kernels'
    launches in the phase, kernel #1's and #2's records there)."""
    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.coordinator import downsample as tds
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.metrics import rules as trules
    from m3_tpu_torch.metrics import rules_json
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.storage import database as tdb

    t_gen = time.perf_counter()
    docs, route, app = downsample_docs(DS_SERIES)
    traffic = DownsampleTraffic(seed, DS_SERIES)
    ids = ds_output_ids(docs, route, app)
    rules = rules_json.ruleset_from_json(DS_RULES)
    K = traffic.K
    log(f"phase16 data: {DS_SERIES:,} counters, {K} scrapes over {DS_WINDOWS} one-minute "
        f"windows ({K * DS_SERIES:,} samples); generated in {time.perf_counter() - t_gen:.1f} s")
    ns_opts = tdb.NamespaceOptions(slot_capacity=1 << 18, sample_capacity=1 << 20)
    ds_opts = tds.DownsamplerOptions(capacity=1 << 20)

    def node(name, d):
        root = store_root(name)
        db = tdb.Database(tdb.DatabaseOptions(root=str(root)), device=d)
        db.ensure_namespace("1m:2d", ns_opts)
        return root, db, tds.Downsampler(db, rules, opts=ds_opts, now_nanos=traffic.t0,
                                         device=d)

    root, db, ds = node("phase16", dev)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    captured: list = []  # every consume's output, in order
    real_consume = te.MetricList.consume

    def capture(self, *a, **kw):
        out = real_consume(self, *a, **kw)
        captured.append(out)
        return out

    te.MetricList.consume = capture
    clock = HostClock()
    for owner, attr, key in ((trules.Matcher, "match", "match"),
                             (te.MetricMap, "resolve", "resolve"),
                             (te.MetricList, "add_batch_slots", "arena_add"),
                             (tds.Downsampler, "_write_batch_locked", "grouping"),
                             (te.MetricList, "consume", "consume"),
                             (te.MetricList, "_apply_tails", "apply_tails"),
                             (tdb.Database, "write_tagged_batch", "writeback_db"),
                             (tds.Downsampler, "_flush_locked", "writeback_host")):
        clock.wrap(owner, attr, key)
    ckpt = ROOT / "build" / "phase16.ckpt"
    saved: dict = {}

    steps = ds_steps(traffic)
    ckpt_step = steps.index(("write", DS_CKPT_AFTER - 1))

    def after(step):
        if step == steps[ckpt_step]:
            t0 = time.perf_counter()
            saved["bytes"] = ds.checkpoint_to(ckpt)
            saved["save_s"] = time.perf_counter() - t0
            saved["consumes"] = len(captured)

    split: dict = {}
    try:
        run = ds_run(ds, traffic, docs, steps, clock=clock, split=split,
                     profile_k=K - 1, after=after)
    finally:
        clock.restore()
        te.MetricList.consume = real_consume
    torch.cuda.synchronize()
    (ml,) = ds._lists.values()
    outs = [fm for o in captured for fm in o]
    counts = ds_check_outputs(ml, outs, traffic, ids, route, app)
    n_written = sum(fm.slots.size for fm in outs)
    log(f"phase16 every flushed row == the numpy oracle: {counts}")

    # a fresh Downsampler restored from the checkpoint takes the later
    # scrapes: its flushed batches equal the uninterrupted run's bit for
    # bit.  It shares the first one's rule-match cache (rules x tags only):
    # re-matching 1M ids would only repeat the first scrape's matching.
    after_ckpt = [fm for o in captured[saved["consumes"]:] for fm in o]
    ds2 = tds.Downsampler(db, rules, opts=ds_opts, now_nanos=traffic.t0, device=dev)
    ds2.matcher = ds.matcher
    t0 = time.perf_counter()
    ds2.restore_from(ckpt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ckpt.unlink()
    restored: list = []

    def consume_only(now):
        for ml2 in ds2._lists.values():
            restored.extend(ml2.consume(now))

    run2 = ds_run(ds2, traffic, docs, steps[ckpt_step + 1:], flush=consume_only)
    assert ds_canon(restored) == ds_canon(after_ckpt), "restored run != uninterrupted run"
    log(f"phase16 checkpoint after scrape {DS_CKPT_AFTER}: {saved['bytes']:,} bytes, saved in "
        f"{saved['save_s']:.2f} s, restored in {restore_s:.2f} s; the restored Downsampler's "
        f"{len(restored)} flushed batches == the uninterrupted run's bit for bit")
    del ds2, restored, after_ckpt

    # the output namespace's warm flush (kernel #1 held against its plain
    # version), then every volume decoded on the card (kernel #2)
    t0 = time.perf_counter()
    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as pcheck:
        tick = db.tick(traffic.t0 + BLOCK + 10 * MINUTE + SEC)
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    assert pcheck.calls > 0, tick
    t0 = time.perf_counter()
    with KernelCheck(mt, "extract_fields64_t", decode_gather.extract_fields64_t_plain) as dcheck:
        vols = ds_check_volumes(db, traffic, ids, route, app, dev)
    check_s = time.perf_counter() - t0
    launched = read_launches()
    peak = torch.cuda.max_memory_allocated()
    db.close()
    log(f"phase16 tick {tick} in {tick_s:.1f} s: kernel #1 == plain in {pcheck.calls} calls; "
        f"volumes decoded on the card == the oracle {vols} ({check_s:.1f} s); kernel #2 == "
        f"plain in {dcheck.calls} calls; launches {launched}")
    frags, keys, w_out = pcheck.args
    records = {
        "place_words": {
            "downsample_ms": cuda_ms(lambda: pcheck.fn(frags, keys, w_out)),
            "downsample_plain_ms": cuda_ms(lambda: encode_place.place_words_plain(
                frags, keys, w_out)),
            "downsample_bound_ms": (frags.numel() * (8 + 4) + frags.shape[0] * w_out * 8)
            / HBM_BYTES_PER_S * 1e3,
            "downsample_shape": [list(frags.shape), w_out], "max_abs_err": pcheck.err},
        "extract_fields64_t": {f"downsample_{k[4:]}": v for k, v in dcheck.summary().items()},
    }
    records["extract_fields64_t"]["max_abs_err"] = dcheck.err
    del pcheck, dcheck, frags, keys

    # card and CPU pairs fed the first DS_CHECK_SERIES series over the first window
    # (and the flush of its stage 2) write the same bytes
    t0 = time.perf_counter()
    n = DS_CHECK_SERIES
    small = DownsampleTraffic(seed, DS_SERIES)
    small.n, small.deltas, small.offset = n, small.deltas[:, :n], small.offset[:n]
    small.K = DS_SCRAPES_PER_WINDOW
    digests, matcher = [], None
    for d in (dev, "cpu"):
        r, sdb, sds = node(f"phase16-{torch.device(d).type}", d)
        if matcher is not None:
            sds.matcher = matcher  # the same rules over the same tags
        matcher = sds.matcher
        ds_run(sds, small, docs[:n], ds_steps(small))
        sdb.tick(traffic.t0 + BLOCK + 10 * MINUTE + SEC)
        sdb.close()
        digests.append(volume_digests(r))
    assert digests[0] == digests[1] and any("1m:2d" in k for k in digests[0])
    pair_s = time.perf_counter() - t0
    log(f"phase16 card and CPU Downsamplers over the first {n} series and one window wrote "
        f"identical files ({len(digests[0])}, sha256; {pair_s:.1f} s)")

    samples = K * DS_SERIES
    write_total = sum(run["write_s"]) + run["prof"]["wall_s"]
    w_split = split.get("write", {})
    f_split = split.get("flush", {})
    prof = run["prof"]
    t = {"series": DS_SERIES, "scrapes": K, "samples": samples,
         "write_samples_per_s": samples / write_total,
         "write_s_per_scrape": run["write_s"], "first_scrape_s": run["write_s"][0],
         **{f"write_split_{k}_s": v for k, v in w_split.items()
            if k in ("match", "resolve", "arena_add", "grouping")},
         "flush_s_per_window": run["flush_s"], "flushed_rows": n_written,
         **{f"flush_split_{k}_s": v for k, v in f_split.items() if v},
         "checkpoint_bytes": saved["bytes"], "checkpoint_save_s": saved["save_s"],
         "checkpoint_restore_s": restore_s,
         "restored_write_s_per_scrape": run2["write_s"],
         "profiled_write_wall_ms": prof["wall_s"] * 1e3,
         "profiled_write_device_busy_ms": prof["busy_s"] * 1e3,
         "profiled_write_idle_share": 1 - prof["busy_s"] / prof["wall_s"],
         "profiled_write_device_ops": prof["ops"],
         "tick_s": tick_s, "volume_check_s": check_s, "card_cpu_pair_s": pair_s,
         "peak_mem_gib": peak / 2**30}
    log(f"phase16 [{card}] downsampler: " + json.dumps(t))
    return t, launched, records


def forwarding_phase(seed: int, n: int, dev, card: str) -> tuple:
    """Phase 17: (a) phase 7's traffic (n series a type) through ``Aggregator.add_untimed_batch``
    with the native resolver (``use_native=True``: a build failure fails
    the phase) and with the Python one: the same slots, samples/s of
    each; (b) ``Aggregator(num_shards=4)`` on the f64 layout, then the
    packed one, 10^5 counters whose two-stage Sum tails forward by the
    next stage's id across shards: every stage-2 total exact,
    no stage-1 aggregate flushed locally, and on the f64 run kernels #3
    and #4 held against their plain versions.  Returns (times, the
    checks of kernels #3 and #4)."""
    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType as AT
    from m3_tpu_torch.metrics.pipeline import AppliedRollupOp, Pipeline
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import MetricType as MT
    from m3_tpu_torch.parallel import segment_ingest as si

    t: dict = {}
    data = agg_traffic(np.random.default_rng(seed), n)
    policy = StoragePolicy.parse(AGG_POLICY)
    opts = te.AggregatorOptions(capacity=1 << 20, num_windows=2, timer_sample_capacity=1 << 24,
                                storage_policies=(policy,))
    slots = {}
    for native in (True, False):
        agg = te.Aggregator(num_shards=1, opts=opts, device=dev)
        ml = agg.shards[0].lists[policy]
        for mt in list(ml.maps):
            ml.maps[mt] = te.MetricMap(opts.capacity, use_native=native)
        assert all(m.native == native for m in ml.maps.values())
        batches = []
        for mt, (k, aid, _) in agg_kinds().items():
            times, vals, perms, _, sids = data[mt]
            for j in range(1):  # the creating scrape (PERF.md §4)
                p = perms[j]
                batches.append((mt, [sids[i] for i in p], vals[j][p], times[j][p], aid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for mt, b_ids, b_vals, b_times, aid in batches:
            agg.add_untimed_batch(mt, b_ids, b_vals, b_times, aid)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tag = "native" if native else "python"
        t[f"entry_{tag}_samples_per_s"] = sum(len(b[1]) for b in batches) / dt
        t[f"entry_{tag}_s"] = dt
        slots[native] = {int(mt): [m.id_of(s) for s in range(n)] for mt, m in ml.maps.items()}
        del agg, ml, batches
        torch.cuda.empty_cache()
    assert slots[True] == slots[False], "native and Python resolvers assign different slots"
    log(f"phase17 (a) [{card}] entry point, one scrape x 3 types x {n:,} series: native "
        f"{t['entry_native_samples_per_s']:,.0f} samples/s, Python "
        f"{t['entry_python_samples_per_s']:,.0f} samples/s; the same slots")
    del slots, data

    # (b) stage 1 -> stage 2 across four shards
    sp = StoragePolicy.parse("10s:2d")
    r = 10 * SEC
    sum_id = AggregationID.compress([AT.SUM])
    rng = np.random.default_rng(seed + 17)
    vals = rng.integers(0, 1000, (2, FWD_SERIES)).astype(np.float64)
    s2_of = np.arange(FWD_SERIES) % FWD_STAGE2
    s1_ids = [b"fwd.s1.%06d" % i for i in range(FWD_SERIES)]
    s2_ids = [b"fwd.s2.%04d" % g for g in range(FWD_STAGE2)]
    pipes = [Pipeline((AppliedRollupOp(s2_ids[g], sum_id),)) for g in range(FWD_STAGE2)]
    # a stage-1 aggregate of window w forwards at the window's end and
    # flushes as stage 2 one window later
    want = {(sid, T0_AGG + (w + 2) * r): float(v) for w in range(2)
            for sid, v in zip(s2_ids, np.bincount(s2_of, vals[w], minlength=FWD_STAGE2))}
    checks: dict = {}
    for layout in ("f64", "packed"):
        agg = te.Aggregator(num_shards=4, opts=te.AggregatorOptions(
            capacity=1 << 15, num_windows=4, timer_sample_capacity=1 << 12, layout=layout,
            storage_policies=(sp,)), device=dev)
        groups: dict = {}
        for i, sid in enumerate(s1_ids):
            groups.setdefault((agg.shard_index(sid), int(s2_of[i])), []).append(i)
        got: dict = {}

        def handler(ml_, fm):
            assert fm.metric_type == MT.GAUGE, "a stage-1 aggregate flushed locally"
            assert (fm.types == int(AT.SUM)).all()
            gmap = ml_.maps[MT.GAUGE]
            for s_, v in zip(fm.slots.tolist(), fm.values.tolist()):
                key = (gmap.id_of(s_), fm.timestamp_nanos)
                assert key not in got, key
                got[key] = v

        ctx = ([IntoCheck("segment_ingest_into", si.segment_ingest_into_plain),
                IntoCheck("segment_minmax_into", si.segment_minmax_into_plain)]
               if layout == "f64" else [])
        for c in ctx:
            c.__enter__()
        t0 = time.perf_counter()
        try:
            for w in range(2):
                for (sh, g), rows in groups.items():
                    agg.shards[sh].lists[sp].add_batch(
                        MT.COUNTER, [s1_ids[i] for i in rows], vals[w][rows],
                        np.full(len(rows), T0_AGG + w * r + SEC, np.int64), sum_id,
                        pipeline=pipes[g])
            for k in range(1, 5):
                agg.consume(T0_AGG + k * r, flush_handler=handler)
            torch.cuda.synchronize()
        finally:
            for c in reversed(ctx):
                c.__exit__(None, None, None)
        t[f"forward_{layout}_s"] = time.perf_counter() - t0
        assert got == want, "stage-2 totals != the oracle"
        assert agg.counters()["forward_errors"] == 0
        if ctx:
            assert all(c.calls > 0 for c in ctx), [c.calls for c in ctx]
            checks = {"segment_ingest": ctx[0], "segment_minmax": ctx[1]}
        log(f"phase17 (b) {layout}: {FWD_SERIES:,} counters -> {FWD_STAGE2} stage-2 sums "
            f"across 4 shards, every stage-2 total == the oracle, no stage-1 "
            f"row flushed ({t[f'forward_{layout}_s']:.1f} s)"
            + (f"; kernels #3/#4 == plain in {[c.calls for c in ctx]} calls" if ctx else ""))
        del agg
    log(f"phase17 [{card}] aggregator: " + json.dumps(t))
    return t, checks


def downsample_lane(seed: int, card: str) -> dict:
    """Phase 16 in a lane of its own: its times, and each kernel's partial
    record, ``downsample_launches`` (its launches there) and its checks."""
    import torch

    torch.set_num_threads(LANE_THREADS)
    lane_wait()
    t0 = time.perf_counter()
    ds_t, ds_launched, ds_records = downsampler_phase(seed, torch.device("cuda"), card)
    log(f"phase16 done in {time.perf_counter() - t0:.1f} s")
    recs = []
    for name in KERNEL_NAMES:
        rec = {"name": name, "max_abs_err": 0, **ds_records.get(name, {}),
               "downsample_launches": ds_launched[name]}
        recs.append(rec)
    return {"records": recs, "times": ds_t}


def forwarding_phase_main(seed: int, agg_series: int, dev, card: str) -> tuple:
    """Phase 17 with every launch counted: (times, launches, each
    kernel's partial record: its launches and its checks)."""
    zero_launches()
    t0 = time.perf_counter()
    fwd_t, fwd_checks = forwarding_phase(seed, agg_series, dev, card)
    fwd_launched = read_launches()
    log(f"phase17 done in {time.perf_counter() - t0:.1f} s; launches {fwd_launched}")
    recs = []
    for name in KERNEL_NAMES:
        rec = {"name": name, "max_abs_err": 0}
        if name in fwd_checks:
            rec["max_abs_err"] = fwd_checks[name].err
            rec["downsample_checked_calls"] = fwd_checks[name].calls
        recs.append(rec)
    return fwd_t, fwd_launched, recs


def downsample_records(kernels: list, ds: dict, fwd: tuple, card: str) -> None:
    """Phases 16 and 17 into the kernel records: ``downsample_launches``
    (the two phases' launches, each above 0) and their checks."""
    fwd_t, fwd_launched, fwd_recs = fwd
    merge_records(kernels, ds["records"])
    merge_records(kernels, fwd_recs)
    for k in kernels:
        k["downsample_launches"] += fwd_launched[k["name"]]
    assert all(k["downsample_launches"] > 0 for k in kernels), \
        {k["name"]: k["downsample_launches"] for k in kernels}
    log(f"phase17 [{card}] downsample path: " + json.dumps({"phase16": ds["times"],
                                                           "phase17": fwd_t}))


# ---- phase 18: the node (config -> assembly -> mediator -> HTTP) ---------

NODE_SCRAPES = 21  # of config #5's 261: 5 min 15 s, one full rate(...[5m]) window (PERF.md §4)
NODE_BATCH = 2_000  # samples a request: Prometheus's queue_config.max_samples_per_send
NODE_READ_SERIES = 100  # remote read
NODE_CHECK_GROUPS = 64  # groups held against the scalar oracle
NODE_FLUSHED_QUERY = 'histogram_quantile(0.99, rate(m3_req_bucket{group=~".*00"}[5m]))'
NODE_TIMEOUT = "900s"  # the query's timeout= (the node's default, 30 s, stays)
NODE_WORKERS = 3  # processes that build the request bodies, as senders would
_NODE_CORPUS: dict = {}


def _node_init(seed: int, G: int, B: int) -> None:
    """A body builder's corpus (each worker process generates it once)."""
    _NODE_CORPUS["data"] = promql_corpus(seed, G, B)


def node_body(task) -> bytes:
    """One remote-write request: rows [lo, hi) of scrape k as snappy +
    protobuf, built with the port's ``build_write_request`` (which calls
    its ``compress``).  Runs in a builder process."""
    from m3_tpu_torch.server import prom_remote as pr

    k, lo, hi = task
    ts, vals, ubs = _NODE_CORPUS["data"]
    B = len(ubs)
    return pr.build_write_request([
        pr.PromTimeSeries({b"__name__": b"m3_req_bucket", b"group": b"g%06d" % (i // B),
                           b"le": ubs[i % B]}, [(int(ts[i, k]), float(vals[i, k]))])
        for i in range(lo, hi)])


class NodeClient:
    """HTTP to one node, with every status checked by the caller."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def call(self, path: str, body: bytes | None = None, headers=None):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=body, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=1200) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def write(self, body: bytes) -> None:
        st, _, out = self.call("/api/v1/prom/remote/write", body, {
            "Content-Encoding": "snappy", "Content-Type": "application/x-protobuf",
            "X-Prometheus-Remote-Write-Version": "0.1.0"})
        assert st == 204, (st, out[:300])

    def json(self, path: str):
        st, _, out = self.call(path)
        assert st == 200, (path, st, out[:500])
        return json.loads(out)


def node_query_path(query: str, start_ns: int, end_ns: int) -> str:
    from urllib.parse import urlencode

    return "/api/v1/query_range?" + urlencode({
        "query": query, "start": start_ns / 1e9, "end": end_ns / 1e9, "step": "15s",
        "timeout": NODE_TIMEOUT})


def node_answer(doc) -> dict:
    """A query_range answer: {group: {step seconds: value}}."""
    assert doc["status"] == "success" and doc["data"]["resultType"] == "matrix", doc
    return {r["metric"]["group"]: {float(t): float(v) for t, v in r["values"]}
            for r in doc["data"]["result"]}


def node_same(a: dict, b: dict, rtol: float) -> float:
    """Two answers over the same groups and steps, values within rtol;
    returns the largest relative difference."""
    assert a.keys() == b.keys() and a, (len(a), len(b))
    worst = 0.0
    for g, row in a.items():
        assert row.keys() == b[g].keys(), g
        x = np.array(list(row.values()))
        y = np.array([b[g][t] for t in row])
        worst = max(worst, rel_err(x, y))
    assert worst <= rtol, worst
    return worst


def node_config(root: Path, tick: str = "24h"):
    """config #5's node: namespace ``default`` at the defaults
    (``NamespaceOptions()``), commit log on, the coordinator on an
    ephemeral port, the mediator on with a tick too long to fire (the
    phase drives ``run_once``), snapshot and cleanup on each pass."""
    from m3_tpu_torch.core.config import (
        CoordinatorConfig, DBConfig, MediatorConfig, NodeConfig,
    )

    return NodeConfig(db=DBConfig(root=str(root)), coordinator=CoordinatorConfig(listen_port=0),
                      mediator=MediatorConfig(tick_interval=tick, snapshot_every=1,
                                              cleanup_every=1))


def node_main_check(root: Path, ts, vals, ubs, before: dict, q_start: int,
                    q_end: int, dev) -> dict:
    """(b) ``python -m m3_tpu_torch.server.node_main <config>`` on the card:
    node.json, /health, one remote write (every scrape of the first
    groups' series, under NODE_BATCH samples), one query_range equal to
    (a)'s on those groups within rtol 1e-12, one remote read bit-equal to
    the samples written, and SIGTERM: a drain and exit 0 within 60 s, no
    failed drain stage logged, and the drain's fileset volumes equal to
    the samples written."""
    import os
    import signal

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.persist.fs import DataFileSetReader
    from m3_tpu_torch.server import prom_remote as pr

    cfg = root / "node.yaml"
    cfg.write_text(f"db: {{root: {root / 'data'}}}\ncoordinator: {{listen_port: 0}}\n"
                   "mediator: {tick_interval: 24h}\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "m3_tpu_torch.server.node_main", str(cfg)],
                            cwd=str(root), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        status = root / "data" / "node.json"
        while not status.exists():
            assert proc.poll() is None, proc.stdout.read()
            assert time.perf_counter() - t0 < 120, "node_main: no node.json in 120 s"
            time.sleep(0.2)
        boot_s = time.perf_counter() - t0
        info = json.loads(status.read_text())
        assert info["pid"] == proc.pid and info["device"].startswith(str(dev)), info
        c = NodeClient(info["port"])
        assert c.json("/health")["ok"]
        B, K = len(ubs), NODE_SCRAPES
        groups = NODE_BATCH // (B * K)
        t1 = time.perf_counter()
        c.write(pr.build_write_request([pr.PromTimeSeries(
            {b"__name__": b"m3_req_bucket", b"group": b"g%06d" % (i // B), b"le": ubs[i % B]},
            list(zip(ts[i, :K].tolist(), vals[i, :K].tolist()))) for i in range(groups * B)]))
        got = node_answer(c.json(node_query_path(HQ_QUERY, q_start, q_end)))
        assert len(got) == groups, len(got)
        err = node_same(got, {g: before[g] for g in got}, 1e-12)
        read = node_read_check(c, ts, vals, ubs, q_end, G=groups)
        wq_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        drain_s = time.perf_counter() - t2
        out = proc.stdout.read()
        assert rc == 0, out[-2000:]
        assert not status.exists(), "node.json left after the drain"
        # the drain swallows a failed stage (the reference's semantics):
        # its log line, and the volumes its warm flush wrote, say whether
        # the flush on the card went through
        assert "drain:" not in out, out[-2000:]
        n = groups * B
        pos_id = {b"m3_req_bucket{group=g%06d,le=%s}" % (i // B, ubs[i % B]): i
                  for i in range(n)}
        rows, segs = [], []
        for sh, bs, v in fileset_volumes(root / "data"):
            r = DataFileSetReader(str(root / "data"), "default", sh, bs, v)
            for sid, seg in r.read_all():
                rows.append(pos_id[sid])
                segs.append(seg)
            r.close()
        rows = np.asarray(rows)
        assert np.array_equal(np.sort(rows), np.arange(n)), "drain volumes miss series"
        d_ts, d_vals, counts, dfb = mt.decode_batch(segs, K + 1, device="cpu")
        assert not dfb.any() and (counts == K).all(), "drain volumes: point counts"
        assert np.array_equal(d_ts[:, :K], ts[rows, :K]), "drain volumes: timestamps"
        vol_rel = rel_err(d_vals[:, :K].ravel(), vals[rows, :K].ravel())
        assert vol_rel <= 1e-15, vol_rel
        return {"boot_s": boot_s, "requests_s": wq_s, "drain_s": drain_s, "read_series": read,
                "groups": groups, "max_rel_err_vs_a": err, "drain_volume_series": n,
                "drain_volume_max_rel_err": vol_rel}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            raise AssertionError("node_main left running: killed")


def node_read_check(c: NodeClient, ts, vals, ubs, end: int, G: int) -> int:
    """Remote read of NODE_READ_SERIES series (groups < G, four buckets
    each): every sample bit-equal to what was written."""
    from m3_tpu_torch.server import prom_remote as pr

    B = len(ubs)
    ng = min(NODE_READ_SERIES // 4, G)
    groups = "|".join("g%06d" % g for g in range(ng))
    les = [0, 1, 2, B - 1]
    q = (pr._emit_field(1, 0, pr._emit_varint(int(ts[0, 0]) // 10**6))
         + pr._emit_field(2, 0, pr._emit_varint(end // 10**6)))
    for typ, name, value in ((0, b"__name__", b"m3_req_bucket"), (2, b"group", groups.encode()),
                             (2, b"le", b"|".join(ubs[i].replace(b"+", b"\\+") for i in les))):
        q += pr._emit_len(3, pr._emit_field(1, 0, pr._emit_varint(typ)) + pr._emit_len(2, name)
                          + pr._emit_len(3, value))
    st, h, body = c.call("/api/v1/prom/remote/read?timeout=" + NODE_TIMEOUT,
                         pr.snappy.compress(pr._emit_len(1, q)))
    assert st == 200, (st, body[:300])
    raw = pr.snappy.decompress(body)
    results = [v for f, _w, v in pr._fields(raw) if f == 1]
    series = [pr._parse_timeseries(v) for f, _w, v in pr._fields(results[0]) if f == 1]
    assert len(series) == ng * len(les), len(series)
    pos = {u: i for i, u in enumerate(ubs)}
    K = int((ts[0] <= end).sum())
    for s in series:
        row = int(s.labels[b"group"][1:]) * B + pos[s.labels[b"le"]]
        t = np.array([p[0] for p in s.samples], np.int64)
        v = np.array([p[1] for p in s.samples])
        assert np.array_equal(t, ts[row, :K]), row
        assert np.array_equal(v.view(np.int64), vals[row, :K].view(np.int64)), row
    return len(series)


def node_builders(seed: int, G: int, B: int):
    """Phase 18's request builders: a pool of NODE_WORKERS spawned
    processes already building every request body in order.  Returns
    (pool, the bodies' iterator, the tasks); the caller terminates the
    pool."""
    import multiprocessing

    S = G * B
    tasks = [(k, lo, min(lo + NODE_BATCH, S)) for k in range(NODE_SCRAPES)
             for lo in range(0, S, NODE_BATCH)]
    pool = multiprocessing.get_context("spawn").Pool(
        NODE_WORKERS, initializer=_node_init, initargs=(seed, G, B))
    return pool, pool.imap(node_body, tasks), tasks


def node_phase(seed: int, G: int, B: int, dev, card: str, builders) -> tuple:
    """Phase 18: the port's node, ``run_node(NodeConfig(...))`` on the
    card, at config #5's full width.  ``builders`` is ``node_builders``'
    result, started early so the bodies are ready.
    Returns (times, the four kernels' launches on the node's path, their
    launches in the volume check, kernel #1's record at the flush's
    shapes)."""
    import torch

    from m3_tpu_torch.server import assembly

    pool, bodies, tasks = builders
    try:
        ts, vals, ubs = promql_corpus(seed, G, B)
        S = ts.shape[0]
        K = NODE_SCRAPES
        root = store_root("phase18")
        log(f"phase18 data: {S:,} counters ({G:,} groups x {B} le) x {K} scrapes at 15 s "
            f"({S * K:,} samples) as {len(tasks)} remote-write requests of {NODE_BATCH}")
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        asm = assembly.run_node(node_config(root), device=dev)
        start_s = time.perf_counter() - t0
        try:
            out = node_drive(asm, bodies, tasks, ts, vals, ubs, start_s, seed, dev, card)
        finally:
            if asm.http_server is not None:
                asm.close()
    finally:
        pool.terminate()
        pool.join()
    return out


def node_drive(asm, bodies, tasks, ts, vals, ubs, start_s, seed, dev, card) -> tuple:
    """Phase 18 from the node's boot on: see node_phase."""
    from urllib.parse import urlencode

    import torch

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.persist.fs import DataFileSetReader
    from m3_tpu_torch.server import assembly, http_api
    from m3_tpu_torch.server import prom_remote as pr
    from m3_tpu_torch.server import snappy
    from m3_tpu_torch.storage import database as tdb

    S, B, K = ts.shape[0], len(ubs), NODE_SCRAPES
    G = S // B
    end = int(ts[0, K - 1])
    ub_f = np.array([np.inf if u == b"+Inf" else float(u) for u in ubs])
    root = Path(asm.db.opts.root)
    c = NodeClient(asm.port)
    assert c.json("/health")["ok"]

    # (a) remote writes, host split on the node's side
    clock = HostClock()
    clock.wrap(http_api._Handler, "_prom_remote_write", "documents")
    clock.wrap(pr, "parse_write_request", "protobuf")
    clock.wrap(snappy, "decompress", "snappy")
    clock.wrap(http_api._Handler, "_ingest_tagged", "ingest_rest")
    clock.wrap(tdb.Database, "write_tagged_batch", "write_tagged_batch")
    waits = 0.0
    first_s = None
    prof = None
    t0 = time.perf_counter()
    try:
        for i in range(len(tasks)):
            tw = time.perf_counter()
            body = bodies.next(timeout=300)  # a builder that died fails the phase
            waits += time.perf_counter() - tw
            tr = time.perf_counter()
            if i == len(tasks) // 2:
                prof = profiled(lambda: c.write(body), tries=1)
            else:
                c.write(body)
            if first_s is None:
                first_s = time.perf_counter() - tr
    finally:
        clock.restore()
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    split = {f"write_split_{k}_s": v for k, v in clock.s.items()}
    log(f"phase18 [{card}] {len(tasks)} remote-write requests in {write_s:.1f} s: "
        f"{len(tasks) / write_s:,.1f} requests/s, {S * K / write_s:,.0f} samples/s; first "
        f"request {first_s:.3f} s; node side " + json.dumps(split)
        + f"; waits on the builders {waits:.1f} s")

    # queries, each held against the data written
    q_end = end
    q_start = end - 60 * SEC
    steps = np.arange(q_start, q_end + 1, PROMQL_STEP, dtype=np.int64)
    out: dict = {}
    qrows = ((http_api._Handler, "_query", "handler"), (http_api._Handler, "_json", "json"),
             (tdb.Database, "query_ids", "index_query"), (tdb.Database, "read", "series_reads"))
    qprof = profiled(lambda: out.__setitem__("split", query_host_split(
        lambda: out.__setitem__("doc", c.json(node_query_path(HQ_QUERY, q_start, q_end))),
        extra=qrows)), tries=1)
    qsplit = out["split"]
    qbusy = qprof["busy_no_htod_s"] + qsplit["upload_copies_device_ms"] * 1e-3
    before = node_answer(out["doc"])
    assert len(before) == G, len(before)
    worst = 0.0
    check = np.random.default_rng(seed + 18).choice(G, NODE_CHECK_GROUPS, replace=False)
    for g in check:
        rates = np.stack([oracle_rate(ts[g * B + b, :K], vals[g * B + b, :K], steps, RATE_WIN)
                          for b in range(B)])
        want = np.array([oracle_hq(ub_f, rates[:, j], 0.99) for j in range(len(steps))])
        got = before[f"g{g:06d}"]
        assert sorted(got) == [t / 1e9 for t, w in zip(steps, want) if not np.isnan(w)], g
        x = np.array([got[t / 1e9] for t, w in zip(steps, want) if not np.isnan(w)])
        y = want[~np.isnan(want)]
        assert np.allclose(x, y, rtol=1e-6, atol=1e-12), (g, x[:3], y[:3])
        worst = max(worst, rel_err(x, y))
    log(f"phase18 query_range {HQ_QUERY} over the last minute: {G:,} groups; "
        f"{NODE_CHECK_GROUPS} == the scalar oracle within rtol 1e-6 (largest {worst:.3e}); "
        f"{qsplit['wall_ms']:.0f} ms, device idle {1 - qbusy / qprof['wall_s']:.4f}; "
        + json.dumps(qsplit))
    t0 = time.perf_counter()
    inst = c.json("/api/v1/query?" + urlencode({
        "query": 'm3_req_bucket{group=~"g00000[0-9]"}', "time": end / 1e9,
        "timeout": NODE_TIMEOUT}))
    assert inst["data"]["resultType"] == "vector" and len(inst["data"]["result"]) == 10 * B
    pos = {u.decode(): i for i, u in enumerate(ubs)}
    for r in inst["data"]["result"]:
        row = int(r["metric"]["group"][1:]) * B + pos[r["metric"]["le"]]
        assert r["value"] == [end / 1e9, repr(float(vals[row, K - 1]))], (r, vals[row, K - 1])
    n_read = node_read_check(c, ts, vals, ubs, end, G)
    labels = c.json(f"/api/v1/labels?start={ts[0, 0] / 1e9}&end={end / 1e9}")["data"]
    assert labels == ["__name__", "group", "le"], labels
    series = c.json(f"/api/v1/series?start={ts[0, 0] / 1e9}&end={end / 1e9}")["data"]
    assert len(series) == S and {s["le"] for s in series} == {u.decode() for u in ubs}
    reads_s = time.perf_counter() - t0
    log(f"phase18 query at one instant: {10 * B} series == the last scrape bit for bit; "
        f"remote read of {n_read} series == the samples written bit for bit; labels "
        f"{labels}; series {len(series):,} ({reads_s:.1f} s)")

    # the flush: run_once past the block's end + bufferPast, kernel #1 checked
    block = ts[0, 0] // BLOCK * BLOCK
    now = int(block + BLOCK + 10 * 60 * SEC + SEC)
    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as pcheck:
        t0 = time.perf_counter()
        stats = asm.mediator.run_once(now)
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
    launched = read_launches()
    n_shards = asm.db.namespaces["default"].opts.num_shards
    assert stats["tick"]["default"]["warm_flushed"] == S, stats
    assert launched["place_words"] == pcheck.calls == n_shards, (launched, pcheck.calls)
    frags, keys, w_out = pcheck.args
    place = {"node_ms": cuda_ms(lambda: pcheck.fn(frags, keys, w_out)),
             "node_plain_ms": cuda_ms(lambda: encode_place.place_words_plain(frags, keys, w_out)),
             "node_bound_ms": (frags.numel() * (8 + 4) + frags.shape[0] * w_out * 8)
             / HBM_BYTES_PER_S * 1e3,
             "node_shape": [list(frags.shape), w_out], "node_max_abs_err": pcheck.err}
    del frags, keys
    log(f"phase18 run_once past the block in {flush_s:.1f} s: " + json.dumps(
        {k: v for k, v in stats.items() if k != "duration_s"})
        + f"; kernel #1 == plain in {pcheck.calls} calls; launches {launched}")

    # the node's volumes decoded on the card (kernel #2) against the data written
    zero_launches()
    t0 = time.perf_counter()
    pos_id = {b"m3_req_bucket{group=g%06d,le=%s}" % (i // B, ubs[i % B]): i for i in range(S)}
    with KernelCheck(mt, "extract_fields64_t", decode_gather.extract_fields64_t_plain) as dcheck:
        rows, segs = [], []
        for sh in range(n_shards):
            r = DataFileSetReader(str(root), "default", sh, int(block), 0)
            for sid, seg in r.read_all():
                rows.append(pos_id[sid])
                segs.append(seg)
            r.close()
        rows = np.asarray(rows)
        d_ts, d_vals, counts, dfb = mt.decode_batch(segs, K + 1, device=dev)
    check_launched = read_launches()
    assert np.array_equal(np.sort(rows), np.arange(S)), "volumes miss series"
    assert not dfb.any() and (counts == K).all()
    assert np.array_equal(d_ts[:, :K], ts[rows, :K]), "volume timestamps"
    h_ts, h_vals, _, _ = mt.decode_batch(segs[:256], K + 1, device="cpu")
    assert np.array_equal(d_ts[:256, :K], h_ts[:, :K])
    assert np.array_equal(d_vals[:256, :K].view(np.int64), h_vals[:, :K].view(np.int64))
    snapped = int((d_vals[:, :K].view(np.int64) != vals[rows, :K].view(np.int64)).sum())
    vol_rel = rel_err(d_vals[:, :K].ravel(), vals[rows, :K].ravel())
    assert vol_rel <= 1e-15, vol_rel
    assert check_launched["extract_fields64_t"] > 0 and dcheck.calls > 0, check_launched
    check_s = time.perf_counter() - t0
    log(f"phase18 {n_shards} volumes decoded on the card (kernel #2 == plain in {dcheck.calls} "
        f"calls): timestamps == written; values == written but {snapped} snapped to a decimal "
        f"by M3TSZ (largest relative {vol_rel:.2e}), == the CPU decode bit for bit "
        f"({check_s:.1f} s)")
    del d_ts, d_vals, segs

    # after the flush: the 1 % of groups from the filesets == before (the
    # reads decode on the host: no kernel from here on)
    zero_launches()
    t0 = time.perf_counter()
    after = node_answer(c.json(node_query_path(NODE_FLUSHED_QUERY, q_start, q_end)))
    after_s = time.perf_counter() - t0
    sub = {g: before[g] for g in after}
    assert len(after) == G // 100
    flushed_err = node_same(after, sub, 1e-12)
    metrics = c.call("/metrics")[2].decode()
    written = [l for l in metrics.splitlines() if l.startswith("m3tpu_db_writes_tagged ")]
    assert written == [f"m3tpu_db_writes_tagged {S * K}"], written
    errors = [l for l in metrics.splitlines() if "_errors" in l and not l.startswith("#")]
    assert not errors, errors
    health = c.json("/health")
    assert health["ok"]
    log(f"phase18 after the flush: {len(after)} groups == before within rtol 1e-12 (largest "
        f"{flushed_err:.3e}, {after_s:.1f} s); /metrics writes_tagged {S * K:,}, no *_errors; "
        f"/health 200")

    # one scrape into the next block (left in the commit log), close, restart
    nxt = [(0, lo, min(lo + NODE_BATCH, S)) for lo in range(0, S, NODE_BATCH)]
    shift = int(block + BLOCK + 60 * SEC) - int(ts[0, 0])
    t0 = time.perf_counter()
    for k, lo, hi in nxt:
        c.write(pr.build_write_request([pr.PromTimeSeries(
            {b"__name__": b"m3_req_bucket", b"group": b"g%06d" % (i // B), b"le": ubs[i % B]},
            [(int(ts[i, 0]) + shift, float(vals[i, K - 1]))]) for i in range(lo, hi)]))
    tail_s = time.perf_counter() - t0
    asm.close()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    asm = assembly.run_node(node_config(root), device=dev)
    boot_s = time.perf_counter() - t0
    try:
        c = NodeClient(asm.port)
        again = node_answer(c.json(node_query_path(NODE_FLUSHED_QUERY, q_start, q_end)))
        restart_err = node_same(again, sub, 1e-12)
        # the next block's scrape, from the replayed commit log
        tail = c.json("/api/v1/query?" + urlencode({
            "query": 'm3_req_bucket{group=~"g00000[0-9]"}',
            "time": (int(ts[0, 0]) + shift) / 1e9, "timeout": NODE_TIMEOUT}))["data"]["result"]
        assert len(tail) == 10 * B, len(tail)
        for r in tail:
            row = int(r["metric"]["group"][1:]) * B + pos[r["metric"]["le"]]
            assert r["value"][1] == repr(float(vals[row, K - 1])), (r, row)
    finally:
        asm.close()
    rest = read_launches()
    assert not any(rest.values()), rest
    log(f"phase18 restart: run_node on the same root in {boot_s:.1f} s: {len(again)} groups "
        f"from the filesets == before within rtol 1e-12 (largest {restart_err:.3e}); the next "
        f"block's scrape from the replayed commit log == written on {len(tail)} series")

    # (b) the real entry point
    main_t = node_main_check(store_root("phase18-main"), ts, vals, ubs, before, q_start, q_end,
                             dev)
    log(f"phase18 (b) node_main on the card: " + json.dumps(main_t))

    t = {"series": S, "scrapes": K, "requests": len(tasks), "batch": NODE_BATCH,
         "start_s": start_s, "write_s": write_s, "requests_per_s": len(tasks) / write_s,
         "samples_per_s": S * K / write_s, "first_request_s": first_s,
         "builder_wait_s": waits, **split,
         "write_profiled_wall_ms": prof["wall_s"] * 1e3,
         "write_device_busy_ms": prof["busy_s"] * 1e3,
         "write_device_idle_share": 1 - prof["busy_s"] / prof["wall_s"],
         "write_device_ops": prof["ops"],
         "query_ms": qsplit["wall_ms"], **{f"query_split_{k}": v for k, v in qsplit.items()
                                          if k != "wall_ms"},
         "query_device_busy_ms": qbusy * 1e3,
         "query_device_idle_share": 1 - qbusy / qprof["wall_s"],
         "query_oracle_max_rel_err": worst, "reads_s": reads_s, "flush_s": flush_s,
         "check_decode_s": check_s, "snapped_values": snapped,
         "after_flush_query_s": after_s, "after_flush_max_rel_err": flushed_err,
         "tail_s": tail_s, "bootstrap_s": boot_s, "restart_max_rel_err": restart_err,
         "peak_mem_gib": peak / 2**30, "node_main": main_t}
    log(f"phase18 [{card}] node: " + json.dumps(t))
    return t, launched, check_launched, place


# ---- phase 19: the aggregator tier (wire -> ingest -> flush -> bus -> fileset) ----

TIER_SERIES = 1_000_000  # BASELINE config #3's width: half counters, half gauges
TIER_SHARDS = 64  # M3's documented aggregator placement
TIER_SCRAPES = 7  # six 10 s scrapes fill one 1 m window, the seventh opens the next
TIER_WINDOW1_SENT = 2  # of window 1's six scrapes, sent (PERF.md §4)
TIER_SENT = tuple(range(TIER_WINDOW1_SENT)) + (TIER_SCRAPES - 1,)
TIER_POLICY = "1m:48h"
TIER_CAPACITY = 1 << 15  # slots a type a shard: 15,625 series a shard, room for skew
TIER_TIMER_CAPACITY = 1 << 10  # the traffic holds no timers
# samples a frame: the client's queue holds 2^16 samples (InstanceQueue's
# default, as in m3_tpu/client/aggregator_client.py), and a flush sends
# what it holds as one frame
TIER_FRAME = 1 << 16
TIER_CHECK = 1 << 14  # the first series (half of each type) held card against CPU
HA_SERIES = 100_000  # counters
HA_SHARDS = 8  # the pair's placement and aggregators (PERF.md §4)
HA_SCRAPES = 6  # three 1 m windows of two 30 s scrapes; the leader resigns in the second
OVERLOAD_CLIENTS, OVERLOAD_FRAMES, OVERLOAD_BATCH = 6, 8, 2_500
KINDS_SAMPLES = 10_000  # in each of the timed, passthrough and forwarded frames
SMALL_SHARDS = 4  # the overload and frame-kind aggregators
# sha256 of the pinned HOPS corpus's volume (1,024 series x 320 s), as
# m3_tpu.tools.hops.run_pipeline(root=...) writes it
HOPS_PINNED_SHA256 = (
    "ed52859a25cd0dcad9eda465ea4955d81e8218dd552641d955b2e156446bcf01")


class TierTraffic:
    """n series, one sample each every ``step`` for K scrapes from
    ``T0_AGG`` (a minute boundary) with whole-second jitter: the first
    half counters ``agg.cnt.*`` (all of them with ``counters_only``),
    integer deltas in [0, 1000); the rest gauges ``agg.gau.*``, three
    decimals, 0.1 % NaN.  Each scrape goes out in its own order."""

    def __init__(self, seed: int, n: int, K: int = TIER_SCRAPES, step: int = 10 * SEC,
                 counters_only: bool = False, prefix: bytes = b"agg"):
        rng = np.random.default_rng(seed)
        self.n, self.K, self.step = n, K, step
        self.half = n if counters_only else n // 2
        self.ids = ([prefix + b".cnt.%07d" % i for i in range(self.half)]
                    + [prefix + b".gau.%07d" % i for i in range(n - self.half)])
        self.mts = np.r_[np.full(self.half, 1), np.full(n - self.half, 3)].astype(np.uint8)
        self.times = (T0_AGG + np.arange(K, dtype=np.int64)[:, None] * step
                      + rng.integers(0, step // SEC, (K, n)) * SEC)
        self.vals = np.empty((K, n))
        self.vals[:, :self.half] = rng.integers(0, 1000, (K, self.half))
        g = np.round(rng.normal(50, 20, (K, n - self.half)), 3) + 0.0
        g[rng.random(g.shape) < 0.001] = np.nan
        self.vals[:, self.half:] = g
        self.perms = [rng.permutation(n) for _ in range(K)]

    def frames(self, k: int, keep=None, shift: int = 0) -> list:
        """Scrape k as ``write_batch`` arguments, its counters then its
        gauges, in the scrape's order (only the series ``keep`` marks)."""
        p = self.perms[k] if keep is None else self.perms[k][keep[self.perms[k]]]
        out = []
        for want in (1, 3):
            q = p[self.mts[p] == want]
            if q.size:
                out.append((self.mts[q], [self.ids[i] for i in q], self.vals[k, q],
                            self.times[k, q] + shift))
        return out

    def window_oracle(self, scrapes) -> np.ndarray:
        """Each series' flushed value over ``scrapes`` (one window):
        counters SUM, gauges LAST (the latest sample; a NaN stays)."""
        v, t = self.vals[scrapes], self.times[scrapes]
        out = np.empty(self.n)
        out[:self.half] = v[:, :self.half].sum(axis=0)
        last = np.argmax(t[:, self.half:], axis=0)
        out[self.half:] = v[:, self.half:][last, np.arange(self.n - self.half)]
        return out


def tier_aggregator(dev, shards: int = TIER_SHARDS, **kw):
    """The packed layout (the default) with the native resolver (the
    default; it must build), arenas sized for one shard's series."""
    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.metrics.policy import StoragePolicy

    opts = te.AggregatorOptions(capacity=TIER_CAPACITY, num_windows=2,
                                timer_sample_capacity=TIER_TIMER_CAPACITY,
                                storage_policies=(StoragePolicy.parse(TIER_POLICY),))
    agg = te.Aggregator(num_shards=shards, opts=opts, device=dev, **kw)
    assert all(m.native for sh in agg.shards for ml in sh.lists.values()
               for m in ml.maps.values()), "the native resolver did not build"
    return agg


def tier_server(agg, sink=None, **kw):
    """An IngestServer on localhost feeding ``aggregator_sink(agg,
    lock)`` (or ``sink``); returns (server, the sink's lock, registry)."""
    import threading

    from m3_tpu_torch import instrument
    from m3_tpu_torch.server.ingest_tcp import aggregator_sink, serve_ingest_background

    lock = threading.Lock()
    clock = kw.pop("clock", None)
    if sink is None:
        sink = (aggregator_sink(agg, lock) if clock is None
                else aggregator_sink(agg, lock, clock=clock))
    reg = instrument.new_registry()
    srv = serve_ingest_background(sink, instrument=reg.scope(""), aggregator=agg, **kw)
    return srv, lock, reg


def tier_client(placement, ports: dict, **kw):
    from m3_tpu_torch.client.aggregator_client import AggregatorClient

    return AggregatorClient(placement, lambda iid: ("127.0.0.1", ports[iid]), **kw)


def one_instance(srv, iid: str = "agg-0", **kw):
    from m3_tpu_torch.cluster.placement import Instance, initial_placement

    placement = initial_placement([Instance(iid, endpoint=f"127.0.0.1:{srv.port}")],
                                  TIER_SHARDS, 1)
    return tier_client(placement, {iid: srv.port}, **kw)


def send_scrapes(client, traffic, scrapes, keep=None, routing=None, shift: int = 0) -> int:
    """Each scrape's samples of a type, ``TIER_FRAME`` at a time:
    ``write_batch``, then a flush that returns once every owner
    acknowledged its frame."""
    sent = 0
    for k in scrapes:
        for mts, ids, vals, ts in traffic.frames(k, keep, shift):
            for lo in range(0, len(ids), TIER_FRAME):
                hi = lo + TIER_FRAME
                t0 = time.perf_counter()
                reached = client.write_batch(mts[lo:hi], ids[lo:hi], vals[lo:hi], ts[lo:hi])
                if routing is not None:
                    routing[0] += time.perf_counter() - t0
                n = client.flush()
                assert n == reached, (n, reached)
                sent += n
    return sent


def wait_ingested(reg, n: int, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while reg.snapshot().get("ingest_tcp.samples", 0) < n:
        assert time.monotonic() < deadline, reg.snapshot()
        time.sleep(0.01)


def stop(*servers) -> None:
    for s in servers:
        s.shutdown()
        s.server_close()


def row_collector(rows: list, who=None):
    """A flush handler keeping (id, time, metric type, aggregation type,
    value bits[, who]) of each flushed row."""
    def handler(ml, fm):
        id_of = ml.maps[fm.metric_type].id_of
        n = len(fm.slots)
        cols = [[id_of(s) for s in fm.slots.tolist()], [fm.timestamp_nanos] * n,
                [int(fm.metric_type)] * n, fm.types.tolist(),
                np.asarray(fm.values, np.float64).view(np.int64).tolist()]
        if who is not None:
            cols.append([who] * n)
        rows.extend(zip(*cols))
    return handler


class BusTail:
    """The flush's far side: a BusServer topic ``aggregated_metrics``
    with a SHARED ``coordinator`` service; ``publish`` (a flush handler)
    sends each flushed batch as a PASSTHROUGH_BATCH payload through a
    RemoteBusProducer, and a consumer thread polls, decodes and acks
    through a RemoteBusConsumer as messages arrive (a redelivered id is
    counted, acked again and kept once).  ``drain`` waits until every
    message published so far has arrived."""

    def __init__(self, agg):
        import threading

        from m3_tpu_torch.msg.bus import ConsumerService, ConsumptionType, MessageBus, Topic
        from m3_tpu_torch.msg.transport import (RemoteBusConsumer, RemoteBusProducer,
                                                serve_bus_background)

        self.policy = str(agg.opts.storage_policies[0])
        self.shard_of = {id(ml): sh.shard_id for sh in agg.shards for ml in sh.lists.values()}
        self.bus = MessageBus(Topic("aggregated_metrics", TIER_SHARDS, (
            ConsumerService("coordinator", ConsumptionType.SHARED),)))
        self.srv = serve_bus_background(self.bus)
        addr = ("127.0.0.1", self.srv.port)
        self.producer = RemoteBusProducer(addr)
        self.consumer = RemoteBusConsumer(addr, "coordinator", "coord-0")
        self.published = 0
        self.redelivered = 0
        self.got: dict = {}  # message id -> (ids, times, values)
        self.taken: set = set()
        self.errors: list = []
        self.s = {"encode": 0.0, "publish": 0.0, "poll": 0.0, "decode": 0.0, "ack": 0.0}
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def publish(self, ml, fm) -> None:
        from m3_tpu_torch.metrics.aggregation import AggregationID
        from m3_tpu_torch.msg import protocol as wire

        # each type flushes its default aggregation only
        assert (fm.types == int(AggregationID.DEFAULT.types_for(fm.metric_type)[0])).all()
        t0 = time.perf_counter()
        id_of = ml.maps[fm.metric_type].id_of
        payload = wire.encode_passthrough_batch(
            self.policy, [id_of(s) for s in fm.slots.tolist()],
            np.asarray(fm.values, np.float64),
            np.full(len(fm.slots), fm.timestamp_nanos, np.int64))
        t1 = time.perf_counter()
        self.producer.publish(self.shard_of[id(ml)], payload)
        self.s["encode"] += t1 - t0
        self.s["publish"] += time.perf_counter() - t1
        with self._cv:
            self.published += 1

    def _consume(self) -> None:
        from m3_tpu_torch.msg import protocol as wire

        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                msgs = self.consumer.poll(timeout_s=0.2, max_messages=256)
                if msgs:  # a poll that waits for the next flush is idle time
                    self.s["poll"] += time.perf_counter() - t0
                for mid, _, payload in msgs:
                    t0 = time.perf_counter()
                    policy, i, v, t = wire.decode_passthrough_batch(payload)
                    t1 = time.perf_counter()
                    self.consumer.ack(mid)
                    self.s["decode"] += t1 - t0
                    self.s["ack"] += time.perf_counter() - t1
                    assert policy == self.policy
                    with self._cv:
                        if mid in self.got:
                            self.redelivered += 1
                        else:
                            self.got[mid] = (i, t, v)
                        self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — raised by drain
            self.errors.append(e)
            with self._cv:
                self._cv.notify_all()

    def drain(self):
        """(ids, times, values) of every message published so far that
        no earlier drain returned, once all of them arrived."""
        with self._cv:
            ok = self._cv.wait_for(lambda: self.errors or len(self.got) >= self.published,
                                   timeout=300)
            assert ok and not self.errors, (self.errors, len(self.got), self.published)
            new = [m for m in self.got if m not in self.taken]
            self.taken.update(new)
            parts = [self.got[m] for m in new]
        ids = [x for p in parts for x in p[0]]
        return (ids, np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10)
        self.producer.close()
        self.consumer.close()
        stop(self.srv)


def tier_volume(ids, ts, vs, root, dev, timings=None) -> np.ndarray:
    """One window's rows through the HOPS tail (``window_matrix``, then
    ``encode_batch`` with kernel #1 on the card and ``DataFileSetWriter``)
    into namespace ``1m:2d``, shard 0, at the window's 2 h block."""
    from m3_tpu_torch.tools import hops

    sids, tmat, vmat, counts = hops.window_matrix(ids, ts, vs)
    bs = int(ts.min()) // BLOCK * BLOCK
    fb = hops.write_volume(sids, tmat, vmat, counts, root, torch_device(dev),
                           namespace="1m:2d", block_start=bs, block_size=BLOCK,
                           timings=timings)
    assert not fb.any(), "a one-point stream fell back"
    return sids


def torch_device(dev):
    import torch

    return torch.device(dev)


def tier_check_volume(root, sids, want_t, want_v, dev) -> int:
    """The volume decoded on the card (kernel #2): every series once, its
    one point at the window's end with the flushed value's bits."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.persist.fs import DataFileSetReader

    (sh, bs, v), = fileset_volumes(root, "1m:2d")
    r = DataFileSetReader(root, "1m:2d", sh, bs, v)
    got = list(r.read_all())
    r.close()
    assert [s for s, _ in got] == sids
    d_ts, d_vals, counts, dfb = mt.decode_batch([seg for _, seg in got], 2, device=dev)
    assert not dfb.any() and (counts == 1).all()
    assert np.array_equal(d_ts[:, 0], want_t), "volume timestamps"
    assert np.array_equal(d_vals[:, 0].view(np.int64), want_v.view(np.int64)), "volume values"
    return len(got)


def by_id(ids, ts, vs, sids):
    """The rows' times and values in ``sids`` order (each id once)."""
    pos = {i: r for r, i in enumerate(ids)}
    idx = np.fromiter((pos[s] for s in sids), np.int64, len(sids))
    assert len(pos) == len(ids)
    return ts[idx], vs[idx]


def tier_main(traffic, dev, card: str) -> tuple:
    """Phase 19's main path at full width: an AggregatorClient routing
    through a one-instance placement of 64 shards sends each scrape as
    METRIC_BATCH frames to an IngestServer on localhost feeding the
    aggregator on the card; a FlushManager ticking as leader on a flush
    thread, under the sink's lock, publishes each closed window on the
    bus; the consumer writes window 1 as a fileset volume (kernel #1)
    and decodes it on the card (kernel #2)."""
    import threading

    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.aggregator.flush_mgr import FlushManager
    from m3_tpu_torch.cluster.kv import KVStore
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.msg import protocol as wire
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.server.ingest_tcp import aggregator_sink

    torch.cuda.reset_peak_memory_stats()
    agg = tier_aggregator(dev)
    lock = threading.Lock()
    base_sink = aggregator_sink(agg, lock)
    enq_at: dict = {}
    waits: list = []

    def sink(batch, kind=wire.METRIC_BATCH):
        waits.append(time.perf_counter() - enq_at.pop(id(batch)))
        base_sink(batch, kind)

    srv, _, reg = tier_server(agg, sink=sink)
    enqueue = srv._try_enqueue

    def stamped(conn, sock, ftype, batch, n, tctx=None):
        enq_at[id(batch)] = time.perf_counter()
        return enqueue(conn, sock, ftype, batch, n, tctx)

    srv._try_enqueue = stamped
    hc = HostClock()
    hc.wrap(wire, "encode_metric_batch", "frame_encode")
    hc.wrap(wire, "decode_metric_batch", "server_decode")
    hc.wrap(srv, "sink", "sink_arena_and_rest")
    hc.wrap(te.Aggregator, "_by_shard", "sink_shard_routing")
    hc.wrap(te.MetricMap, "resolve", "sink_resolver")
    client = one_instance(srv)
    tail = BusTail(agg)
    fmgr = FlushManager(agg, KVStore(), "agg-0", flush_handler=tail.publish)
    tick_s = []

    def tick(now):
        with lock:  # the ingest worker is the other thread on these arenas
            t0 = time.perf_counter()
            assert fmgr.tick(now) == "leader"
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t0)

    zero_launches()
    routing = [0.0]
    t0 = time.perf_counter()
    sent = send_scrapes(client, traffic, TIER_SENT[:-1], routing=routing)
    # window 1 flushes on the flush thread while the seventh scrape streams in
    flusher = threading.Thread(target=tick, args=(T0_AGG + MINUTE,))
    flusher.start()
    sent += send_scrapes(client, traffic, TIER_SENT[-1:], routing=routing)
    flusher.join(600)
    assert not flusher.is_alive() and len(tick_s) == 1, "the window-1 tick failed"
    torch.cuda.synchronize()  # the acked frames' device work, once, at the end
    ingest_s = time.perf_counter() - t0
    hc.restore()
    acked = reg.snapshot()["ingest_tcp.samples"]
    frames = len(waits)
    t1 = time.perf_counter()
    w1 = tail.drain()
    drain1_s = time.perf_counter() - t1
    tick(T0_AGG + 2 * MINUTE)
    w2 = tail.drain()

    # acked = sent = flushed: every sample in a flushed row equal to the oracle
    q_sent = sum(q.sent for q in client.queues.values())
    assert sent == q_sent == acked == traffic.n * len(TIER_SENT), (sent, q_sent, acked)
    row_of = {sid: r for r, sid in enumerate(traffic.ids)}
    oracle = {1: traffic.window_oracle(list(TIER_SENT[:-1])),
              2: traffic.window_oracle(list(TIER_SENT[-1:]))}
    for w, (ids, ts, vs) in ((1, w1), (2, w2)):
        rows = np.fromiter((row_of[i] for i in ids), np.int64, len(ids))
        assert len(ids) == traffic.n and np.unique(rows).size == traffic.n, \
            (w, len(ids), np.unique(rows).size)
        assert (ts == T0_AGG + w * MINUTE).all(), w
        assert np.array_equal(vs.view(np.int64), oracle[w][rows].view(np.int64)), \
            f"window {w} != the numpy oracle"
    deadline = time.monotonic() + 30
    while tail.bus.acked < tail.published and time.monotonic() < deadline:
        time.sleep(0.01)  # the last acks are in flight
    assert len(tail.got) == tail.published == tail.bus.published and tail.redelivered == 0, \
        (len(tail.got), tail.published, tail.bus.published, tail.redelivered)
    assert tail.bus.unacked("coordinator") == 0 and tail.bus.acked == tail.published
    log(f"phase19 acked == sent == {acked:,} samples in {frames} frames; windows 1 and 2 "
        f"({traffic.n:,} rows each) == the numpy oracle (counters SUM, gauges LAST, bit for "
        f"bit); the bus delivered {tail.published} messages once each, 0 unacked")

    # window 1 through the HOPS tail into a volume (kernel #1), decoded (kernel #2)
    root = store_root("phase19")
    vt: dict = {}
    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as pcheck:
        sids = tier_volume(*w1, root, dev, timings=vt)
    want_t, want_v = by_id(*w1, sids)
    t1 = time.perf_counter()
    with KernelCheck(mt, "extract_fields64_t", decode_gather.extract_fields64_t_plain) as dcheck:
        n_vol = tier_check_volume(root, sids, want_t, want_v, dev)
    check_s = time.perf_counter() - t1
    launched = read_launches()
    peak = torch.cuda.max_memory_allocated()
    assert launched["place_words"] > 0 and launched["extract_fields64_t"] > 0, launched
    log(f"phase19 window 1 volume: {n_vol:,} series decoded on the card == the flushed "
        f"values; kernel #1 == plain in {pcheck.calls} calls, kernel #2 == plain in "
        f"{dcheck.calls}; launches {launched}")

    backoffs = sum(q.backoffs for q in client.queues.values())
    dropped = sum(q.dropped for q in client.queues.values())
    shed = reg.snapshot().get("ingest_tcp.shed_frames", 0)
    assert backoffs == dropped == shed == 0, (backoffs, dropped, shed)

    client.close()
    tail.close()
    stop(srv)
    # one frame's sink under the profiler (on this thread, the server
    # stopped): scrape 7's first TIER_FRAME counters again, decoded off
    # their wire bytes, into the third window (never flushed; a retried
    # trace ingests again)
    (mts, ids, vals, ts), _ = traffic.frames(TIER_SCRAPES - 1, shift=2 * MINUTE)
    batch = wire.decode_metric_batch(wire.encode_metric_batch(wire.MetricBatch(
        mts[:TIER_FRAME], ids[:TIER_FRAME], vals[:TIER_FRAME], ts[:TIER_FRAME])))
    prof = profiled(lambda: base_sink(batch))

    frags, keys, w_out = pcheck.args
    place = {"tier_ms": cuda_ms(lambda: pcheck.fn(frags, keys, w_out)),
             "tier_plain_ms": cuda_ms(lambda: encode_place.place_words_plain(
                 frags, keys, w_out)),
             "tier_bound_ms": (frags.numel() * (8 + 4) + frags.shape[0] * w_out * 8)
             / HBM_BYTES_PER_S * 1e3,
             "tier_shape": [list(frags.shape), w_out], "tier_max_abs_err": pcheck.err}
    ext = {f"tier_{k[4:]}": v for k, v in dcheck.summary().items()}
    ext["tier_max_abs_err"] = dcheck.err
    log(f"phase19 [{card}] kernel #1 at the flush's shapes ({place['tier_shape']}): "
        f"{place['tier_ms']:.4f} ms, bound {place['tier_bound_ms']:.4f} ms (bytes), plain "
        f"{place['tier_plain_ms']:.4f} ms; kernel #2 on the volume check: {ext['tier_ms']:.4f} "
        f"ms, bound {ext['tier_bound_ms']:.4f} ms; peak device memory {peak / 2**30:.2f} GiB")
    split = {k: v for k, v in hc.s.items()}
    n = acked
    t = {"series": traffic.n, "shards": TIER_SHARDS, "scrapes": len(TIER_SENT),
         "samples": n, "frames": frames, "ingest_s": ingest_s,
         "samples_per_s": n / ingest_s,
         "split_client_routing_s": routing[0],
         **{f"split_{k}_s": v for k, v in split.items()},
         "split_queue_wait_s": sum(waits[:frames]), "queue_wait_max_s": max(waits[:frames]),
         "acks": frames, "client_backoffs": backoffs, "client_dropped": dropped,
         "server_shed_frames": shed,
         "bus_redeliveries": tail.redelivered,
         "profiled_frame_samples": len(batch.ids),
         "profiled_frame_wall_ms": prof["wall_s"] * 1e3,
         "profiled_frame_device_busy_ms": prof["busy_s"] * 1e3,
         "profiled_frame_idle_share": 1 - prof["busy_s"] / prof["wall_s"],
         "profiled_frame_device_ops": prof["ops"],
         "tick_s_per_window": tick_s, "consume_ms_per_window": [x * 1e3 for x in tick_s],
         "bus_messages": tail.published, "bus_drain_window1_s": drain1_s,
         **{f"bus_{k}_s": v for k, v in tail.s.items()},
         "volume_encode_s": vt["encode"], "volume_fileset_s": vt["fileset_write"],
         "volume_check_s": check_s, "peak_mem_gib": peak / 2**30}
    return t, {"w1": w1, "w2": w2}, launched, place, ext


def tier_card_vs_cpu(traffic, card_rows, dev) -> dict:
    """The first TIER_CHECK series (half of each type) of the same
    traffic through an IngestServer in front of the aggregator on the
    CPU: its flushed rows bit-equal to the card run's for those series,
    and its window-1 volume (CPU encode) sha256-equal to one written
    from the card's rows (kernel #1)."""
    from m3_tpu_torch.aggregator.flush_mgr import FlushManager
    from m3_tpu_torch.cluster.kv import KVStore
    from m3_tpu_torch.tools import hops

    keep = np.zeros(traffic.n, bool)
    keep[:TIER_CHECK // 2] = True
    keep[traffic.half:traffic.half + TIER_CHECK // 2] = True
    agg = tier_aggregator("cpu")
    srv, lock, reg = tier_server(agg)
    client = one_instance(srv)
    rows: list = []
    fmgr = FlushManager(agg, KVStore(), "agg-cpu", flush_handler=row_collector(rows))
    sent = send_scrapes(client, traffic, TIER_SENT, keep=keep)
    for w in (1, 2):
        with lock:
            assert fmgr.tick(T0_AGG + w * MINUTE) == "leader"
    client.close()
    stop(srv)
    assert sent == TIER_CHECK * len(TIER_SENT)
    want = {traffic.ids[i] for i in np.nonzero(keep)[0].tolist()}
    digests = []
    for w, (ids, ts, vs) in ((1, card_rows["w1"]), (2, card_rows["w2"])):
        card = sorted((i, t, v) for i, t, v in zip(ids, ts.tolist(),
                                                   vs.view(np.int64).tolist()) if i in want)
        cpu = sorted((r[0], r[1], r[4]) for r in rows if r[1] == T0_AGG + w * MINUTE)
        assert card == cpu and len(cpu) == TIER_CHECK, f"window {w}: card != CPU"
        if w == 1:
            for d, rows_ in ((dev, card), ("cpu", cpu)):
                i, t, v = zip(*rows_)
                root = store_root(f"phase19-{torch_device(d).type}")
                tier_volume(list(i), np.asarray(t, np.int64),
                            np.asarray(v, np.int64).view(np.float64), root, d)
                digests.append(hops.volume_digest(root))
    assert digests[0] == digests[1], "card and CPU volumes differ"
    return {"card_cpu_series": TIER_CHECK, "card_cpu_volume_sha256": digests[0]}


def hops_on_card(dev, card: str) -> dict:
    """(a) The pinned HOPS corpus (1,024 gauges x 320 s) through the
    port's ``tools/hops`` on the card, kernel #1 held against its plain
    version on every launch: the volume's sha256 is the one pinned from
    the JAX package, in the cold pass and the steady one."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import encode_place
    from m3_tpu_torch.tools import hops

    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as pcheck:
        doc = hops.run_pipeline(root=str(store_root("phase19-hops")), device=dev)
    assert (doc["volume_sha256"] == doc["cold_volume_sha256"] == doc["ledger_volume_sha256"]
            == HOPS_PINNED_SHA256), doc
    log(f"phase19 (a) HOPS corpus {doc['config']['S']} x {doc['config']['T']}: volume sha256 "
        f"== the pinned JAX digest (all three passes); kernel #1 == plain in {pcheck.calls} calls")
    for h, v in doc["hops"].items():
        log(f"phase19 (a) [{card}] {h}: steady {v['steady_wall_s']:.3f} s (uncounted pass), "
            f"share {v['host_time_fraction']:.4f}")
    return {"hops": doc["hops"], "hops_pipeline": doc["pipeline"],
            "hops_place_calls": pcheck.calls, "hops_place_max_abs_err": pcheck.err}


def ha_pair(seed: int, dev, card: str) -> dict:
    """(b) A mirrored placement of RF 2 (one shard set of two instances,
    each an IngestServer with an aggregator on the card; one KV): the
    client sends every sample to both.  The leader flushes window 1, the
    follower shadow-consumes; the leader resigns in window 2 and the
    follower takes over.  The union of the windows they emitted equals a
    single instance's run: none lost, none doubled."""
    import torch

    from m3_tpu_torch.aggregator.flush_mgr import FlushManager
    from m3_tpu_torch.cluster.kv import KVStore
    from m3_tpu_torch.cluster.placement import Instance
    from m3_tpu_torch.cluster.placement_mirrored import (mirrored_initial_placement,
                                                         validate_mirrored)
    from m3_tpu_torch.metrics.types import MetricType as MT

    traffic = TierTraffic(seed + 19, HA_SERIES, K=HA_SCRAPES, step=30 * SEC,
                          counters_only=True, prefix=b"ha")
    kv = KVStore()
    nodes, ports, rows = {}, {}, []
    for k, iid in enumerate(("agg-a", "agg-b")):
        agg = tier_aggregator(dev, shards=HA_SHARDS)
        srv, lock, reg = tier_server(agg)
        nodes[iid] = (srv, lock, reg, FlushManager(agg, kv, iid,
                                                   flush_handler=row_collector(rows, iid)))
        ports[iid] = srv.port
    placement = mirrored_initial_placement(
        [Instance(iid, f"g{k}", shard_set_id=1, endpoint=f"127.0.0.1:{ports[iid]}")
         for k, iid in enumerate(ports)], HA_SHARDS, 2)
    validate_mirrored(placement)
    client = tier_client(placement, ports)
    roles = []

    def tick(order, now):
        for iid in order:
            _, lock, _, fm = nodes[iid]
            with lock:
                roles.append((iid, fm.tick(now)))

    t0 = time.perf_counter()
    send_scrapes(client, traffic, [0, 1])
    tick(("agg-a", "agg-b"), T0_AGG + MINUTE)
    send_scrapes(client, traffic, [2])
    nodes["agg-a"][3].resign()  # mid-stream: the follower takes the lease
    tick(("agg-b", "agg-a"), T0_AGG + MINUTE + 30 * SEC)
    send_scrapes(client, traffic, [3])
    tick(("agg-b", "agg-a"), T0_AGG + 2 * MINUTE)
    send_scrapes(client, traffic, [4, 5])
    tick(("agg-b", "agg-a"), T0_AGG + 3 * MINUTE)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    client.close()
    for srv, _, reg, _ in nodes.values():
        assert reg.snapshot()["ingest_tcp.samples"] == HA_SERIES * HA_SCRAPES
        stop(srv)
    assert roles == [("agg-a", "leader"), ("agg-b", "follower"), ("agg-b", "leader"),
                     ("agg-a", "follower"), ("agg-b", "leader"), ("agg-a", "follower"),
                     ("agg-b", "leader"), ("agg-a", "follower")], roles

    single = tier_aggregator(dev, shards=HA_SHARDS)
    srows: list = []
    sfm = FlushManager(single, KVStore(), "solo", flush_handler=row_collector(srows))
    for k in range(HA_SCRAPES):
        (mts, ids, vals, ts), = traffic.frames(k)
        single.add_untimed_batch(MT.COUNTER, ids, vals, ts)
        if k % 2 == 1:
            assert sfm.tick(T0_AGG + (k // 2 + 1) * MINUTE) == "leader"
    emitted = {}
    for r in rows:
        emitted.setdefault(r[1], set()).add(r[5])
    union = sorted(r[:5] for r in rows)
    assert union == sorted(srows), "the pair's union != a single instance's run"
    assert len(set(union)) == len(union) == HA_SERIES * 3, "a window lost or doubled"
    assert emitted == {T0_AGG + MINUTE: {"agg-a"}, T0_AGG + 2 * MINUTE: {"agg-b"},
                       T0_AGG + 3 * MINUTE: {"agg-b"}}, emitted
    want = np.concatenate([traffic.window_oracle([2 * w, 2 * w + 1]) for w in range(3)])
    got = {(r[0], r[1]): r[4] for r in rows}
    idx = {i: j for j, i in enumerate(traffic.ids)}
    assert all(got[(i, T0_AGG + (w + 1) * MINUTE)] ==
               np.float64(want[w * HA_SERIES + idx[i]]).view(np.int64)
               for w in range(3) for i in traffic.ids[::97]), "HA sums != oracle"
    log(f"phase19 (b) HA pair, RF 2 mirrored over {HA_SHARDS} shards, {HA_SERIES:,} counters "
        f"x {HA_SCRAPES} scrapes to both: windows emitted {sorted((t - T0_AGG) // MINUTE for t in emitted)} "
        f"by {[sorted(v) for _, v in sorted(emitted.items())]}; the union == a single "
        f"instance's {len(srows):,} rows, none lost or doubled ({pair_s:.1f} s)")
    return {"ha_series": HA_SERIES, "ha_scrapes": HA_SCRAPES, "ha_rows": len(union),
            "ha_s": pair_s}


def overload_and_kinds(seed: int, dev, card: str) -> dict:
    """(c) max_queue_frames=2 with six clients sending at once: frames
    over the budget get INGEST_BACKOFF, the clients park and retry, and
    every acknowledged sample is in the flush.  Then TIMED_BATCH (on an
    injected server clock), PASSTHROUGH_BATCH and FORWARDED_BATCH frames
    of KINDS_SAMPLES each through a server on the card and one on the
    CPU: flushed rows and passthrough batches bit-equal."""
    import socket
    import threading

    import torch

    from m3_tpu_torch.aggregator import engine as te
    from m3_tpu_torch.metrics.aggregation import AggregationID, AggregationType as AT
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.msg import protocol as wire

    agg = tier_aggregator(dev, shards=SMALL_SHARDS)
    srv, lock, reg = tier_server(agg, max_queue_frames=2)
    rng = np.random.default_rng(seed + 23)
    vals = rng.integers(0, 100, (OVERLOAD_CLIENTS, OVERLOAD_FRAMES, OVERLOAD_BATCH)) * 1.0
    clients, errors = [], []

    def run(c):
        try:
            cl = one_instance(srv)
            clients.append(cl)
            ids = [b"ovl.%d.%05d" % (c, i) for i in range(OVERLOAD_BATCH)]
            for f in range(OVERLOAD_FRAMES):
                cl.write_batch(np.ones(OVERLOAD_BATCH, np.uint8), ids, vals[c, f],
                               np.full(OVERLOAD_BATCH, T0_AGG + (f * 7 + c) * SEC, np.int64))
                deadline = time.monotonic() + 120
                while cl.flush() == 0:  # parked on a BACKOFF: retry after its hint
                    assert time.monotonic() < deadline
                    time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(OVERLOAD_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not errors and not any(th.is_alive() for th in threads), errors
    over_s = time.perf_counter() - t0
    rows: list = []
    with lock:
        agg.consume(T0_AGG + MINUTE, row_collector(rows))
    total = OVERLOAD_CLIENTS * OVERLOAD_FRAMES * OVERLOAD_BATCH
    snap = reg.snapshot()
    backoffs = sum(q.backoffs for cl in clients for q in cl.queues.values())
    sent = sum(q.sent for cl in clients for q in cl.queues.values())
    for cl in clients:
        cl.close()
    stop(srv)
    assert sent == snap["ingest_tcp.samples"] == total, (sent, snap)
    assert backoffs > 0 and snap["ingest_tcp.shed_frames"] == backoffs, (backoffs, snap)
    want = {b"ovl.%d.%05d" % (c, i): vals[c, :, i].sum()
            for c in range(OVERLOAD_CLIENTS) for i in range(OVERLOAD_BATCH)}
    got = {r[0]: np.int64(r[4]).view(np.float64) for r in rows}
    assert got == want, "an acknowledged sample is missing from the flush"
    log(f"phase19 (c) overload, max_queue_frames=2, {OVERLOAD_CLIENTS} clients x "
        f"{OVERLOAD_FRAMES} frames of {OVERLOAD_BATCH:,}: {backoffs} BACKOFFs (server shed "
        f"{snap['ingest_tcp.shed_frames']}), every client parked and retried; acked == "
        f"sent == {total:,} and every series' flushed SUM == the oracle ({over_s:.1f} s)")

    # the other three frame kinds, card against CPU
    n = KINDS_SAMPLES
    ids = [b"kind.%s.%05d" % (b"c" if i % 2 == 0 else b"g", i) for i in range(n)]
    mts = np.where(np.arange(n) % 2 == 0, 1, 3).astype(np.uint8)
    kv_ = np.round(rng.normal(20, 5, n), 2)
    kt = T0_AGG + rng.integers(0, 60, n) * SEC
    kt[::97] = T0_AGG - 3600 * SEC  # too early for the server's clock
    sum_id = AggregationID.compress([AT.SUM])
    entries = [(te.ForwardSpec(b"fwd.stage2.%03d" % (i % 100), sum_id, ()), float(i % 13),
                int(T0_AGG + (i % 50) * SEC)) for i in range(n)]
    pt_policy = StoragePolicy.parse("1m:40d")
    out = []
    for d in (dev, "cpu"):
        batches = []
        kagg = tier_aggregator(d, shards=SMALL_SHARDS, passthrough_handler=batches.append)
        ksrv, klock, kreg = tier_server(kagg, clock=lambda: T0_AGG + 30 * SEC)
        cl = one_instance(ksrv)
        assert cl.write_timed_batch(mts, ids, kv_, kt) == n and cl.flush() == n
        assert cl.write_passthrough(ids, kv_, kt, pt_policy) == 1
        s = wire.connect(("127.0.0.1", ksrv.port))
        wire.send_frame(s, wire.FORWARDED_BATCH,
                        wire.encode_forwarded_batch(str(kagg.opts.storage_policies[0]), entries))
        wait_ingested(kreg, 3 * n)
        s.close()
        krows: list = []
        with klock:
            kagg.consume(T0_AGG + 2 * MINUTE, row_collector(krows))
        if torch_device(d).type == "cuda":
            torch.cuda.synchronize()
        out.append((sorted(krows), [(str(b.policy), b.ids, b.values.view(np.int64).tolist(),
                                     b.times.tolist()) for b in batches], kagg.counters()))
        cl.close()
        stop(ksrv)
    a, b = out
    assert a == b, "timed / passthrough / forwarded: card != CPU"
    rows_k, pts, counters = a
    assert counters["timed_rejects_too_early"] == len(kt[::97]) and len(pts) == 1
    assert len(pts[0][1]) == n and {r[0] for r in rows_k} >= {b"fwd.stage2.000"}
    log(f"phase19 (c) TIMED_BATCH, PASSTHROUGH_BATCH and FORWARDED_BATCH frames of {n:,} "
        f"each, card == CPU: {len(rows_k):,} flushed rows bit for bit, the passthrough batch, "
        f"{counters['timed_rejects_too_early']} timed samples refused as too early on both")
    return {"overload_backoffs": backoffs, "overload_samples": total, "overload_s": over_s,
            "kinds_rows": len(rows_k)}


def aggregator_tier_phase(seed: int, dev, card: str) -> tuple:
    """Phase 19: see the module docstring.  Returns (times, launches on
    the main path, kernel #1's record there, kernel #2's)."""
    import torch

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    traffic = TierTraffic(seed, TIER_SERIES)
    log(f"phase19 data: {TIER_SERIES:,} series ({traffic.half:,} counters, "
        f"{TIER_SERIES - traffic.half:,} gauges) x scrapes {list(TIER_SENT)} of "
        f"{TIER_SCRAPES} at 10 s from a minute boundary = "
        f"{TIER_SERIES * len(TIER_SENT):,} samples in frames of at most {TIER_FRAME:,}; "
        f"{TIER_SHARDS} shards, {TIER_CAPACITY} slots a type a shard, {TIER_POLICY}; "
        f"generated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    t, rows, launched, place, ext = tier_main(traffic, dev, card)
    t["main_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t.update(tier_card_vs_cpu(traffic, rows, dev))
    t["card_cpu_s"] = time.perf_counter() - t0
    log(f"phase19 card == CPU on the first {TIER_CHECK:,} series: flushed rows bit for bit, "
        f"window-1 volumes sha256-equal ({t['card_cpu_s']:.1f} s)")
    del rows
    torch.cuda.empty_cache()
    t.update(hops_on_card(dev, card))
    t.update(ha_pair(seed, dev, card))
    t.update(overload_and_kinds(seed, dev, card))
    t["phase_s"] = time.perf_counter() - t_all
    log(f"phase19 [{card}] aggregator tier: " + json.dumps(t))
    return t, launched, place, ext


# ---- phase 20: the device mesh (parallel/mesh.py and the sharded paths) ----

MESH_SERIES = 1_000_000  # BASELINE config #3's width: a counter and a gauge a series
MESH_SHARDS = 8
MESH_CAPACITY = 1 << 17  # slots a shard: 125,000 series a shard plus murmur3's skew
MESH_SAMPLE_CAPACITY = 1 << 18  # timer samples a window a shard (two a series in window 0)
MESH_CHECK = 1 << 14  # the first series, card against CPU
MESH_CARDS_SERIES = 1 << 16  # over distinct cards, where the machine has them
MESH_REPLICA_SERIES = 1 << 16
MESH_REPLICA_CAPACITY = 1 << 15
MESH_CODEC_SHARDS = 2
MESH_CODEC_POINTS = 120  # of config #2's 720 (PERF.md §4): each shard pays phase 1's steps
MESH_FUSED_CHECK = 1 << 12  # streams decoded by both chains tails
MESH_QUERY_SHARDS = 4
MESH_QUERY_CHECK = 1 << 9  # streams of the query's card-against-CPU pair
MESH_QUANTILES = (0.5, 0.95, 0.99)
MESH_OFFSETS = (10, 20, 70)  # seconds after T0_AGG: two samples in window 0, one in window 1


class MeshTraffic:
    """n series ``mesh.NNNNNNN`` routed to ``shards`` by the port's murmur3
    (``core/hash.shards_for``), each series' slot its rank in its shard;
    three samples a series (window 0 twice, window 1 once), each with a
    counter value (integers in [0, 1000)), a gauge value (three decimals,
    0.1 % NaN) and a timer value at the same slot."""

    def __init__(self, seed: int, n: int, shards: int):
        from m3_tpu_torch.core.hash import shards_for

        rng = np.random.default_rng(seed)
        self.n, self.shards = n, shards
        self.shard = shards_for([b"mesh.%07d" % i for i in range(n)], shards)
        counts = np.bincount(self.shard, minlength=shards)
        order = np.argsort(self.shard, kind="stable")
        self.slot = np.empty(n, np.int64)
        self.slot[order] = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts)
        K = len(MESH_OFFSETS)
        self.windows = np.array([(o * SEC) // MINUTE for o in MESH_OFFSETS], np.int32)
        self.times = (T0_AGG + np.array(MESH_OFFSETS, np.int64)[:, None] * SEC
                      + rng.integers(0, 10, (K, n)) * SEC // 10)
        self.cvals = rng.integers(0, 1000, (K, n)).astype(np.int64)
        g = np.round(rng.normal(50, 20, (K, n)), 3) + 0.0
        g[rng.random(g.shape) < 0.001] = np.nan
        self.gvals = g
        self.tvals = np.abs(rng.normal(0.1, 0.02, (K, n)))

    def rows(self, d: int, keep=None):
        """Shard d's samples, series in slot order, scrape by scrape:
        (windows, slots, counter, gauge, timer values, times)."""
        sel = self.shard == d
        if keep is not None:
            sel &= keep
        idx = np.flatnonzero(sel)
        idx = idx[np.argsort(self.slot[idx], kind="stable")]
        K = len(MESH_OFFSETS)
        return (np.repeat(self.windows, len(idx)), np.tile(self.slot[idx], K).astype(np.int32),
                self.cvals[:, idx].reshape(-1), self.gvals[:, idx].reshape(-1),
                self.tvals[:, idx].reshape(-1), self.times[:, idx].reshape(-1))

    def batch(self, capacity: int, keep=None):
        """The (D, N) ``ShardedBatch``: every shard's rows, padded with rows
        outside the ring and the slots (dropped)."""
        from m3_tpu_torch.parallel.sharded_agg import ShardedBatch

        per = [self.rows(d, keep) for d in range(self.shards)]
        N = max(len(r[0]) for r in per)
        fills = (len(MESH_OFFSETS), capacity, 0, 0.0, 0.0, 0)
        cols = []
        for k, fill in enumerate(fills):
            col = np.full((self.shards, N), fill, dtype=per[0][k].dtype)
            for d, r in enumerate(per):
                col[d, :len(r[k])] = r[k]
            cols.append(col)
        return ShardedBatch(*cols)

    def rollup_oracle(self, capacity: int) -> np.ndarray:
        """Window 0's cross-shard rollup from the samples in numpy, the
        shards added in order: [sum, count, min, max] a slot (min and max
        over the gauges' real values, NaN where no shard has one)."""
        w0 = [k for k, w in enumerate(self.windows) if w == 0]
        acc = None
        for d in range(self.shards):
            idx = np.flatnonzero(self.shard == d)
            slot = self.slot[idx]
            part = np.zeros((capacity, 4))
            part[:, 2], part[:, 3] = np.inf, -np.inf
            g = self.gvals[w0][:, idx]
            gsum = np.zeros(len(idx))
            for k in range(len(w0)):  # the arenas' order: arrival
                gsum = gsum + np.where(np.isnan(g[k]), 0.0, g[k])
            csum = self.cvals[w0][:, idx].sum(axis=0).astype(np.float64)
            part[slot, 0] = gsum + csum
            part[slot, 1] = 2.0 * len(w0)
            part[slot, 2] = np.fmin.reduce(np.where(np.isnan(g), np.inf, g), axis=0)
            part[slot, 3] = np.fmax.reduce(np.where(np.isnan(g), -np.inf, g), axis=0)
            if acc is None:
                acc = part
            else:
                acc[:, :2] = acc[:, :2] + part[:, :2]
                acc[:, 2] = np.minimum(acc[:, 2], part[:, 2])
                acc[:, 3] = np.maximum(acc[:, 3], part[:, 3])
        acc[:, 2] = np.where(np.isposinf(acc[:, 2]), np.nan, acc[:, 2])
        acc[:, 3] = np.where(np.isneginf(acc[:, 3]), np.nan, acc[:, 3])
        return acc


def mesh_step(devices, shards: int, replicas: int, batch, capacity: int, scap: int,
              layout: str):
    """One sharded step on a fresh state (window 0 drained): (state, lanes)."""
    from m3_tpu_torch.parallel import mesh, sharded_agg as sa

    topo = mesh.make_mesh(shards, replicas, devices)
    state = sa.sharded_init(topo, 2, capacity, scap, layout=layout)
    return sa.sharded_ingest_consume(topo, state, batch, 0, 2, capacity, MESH_QUANTILES,
                                     layout=layout)


def mesh_outputs(state, lanes) -> list:
    """Every lane, count, the rollup, ``err`` and every state tensor of
    every shard (replica 0), on the CPU, in a fixed order."""
    out = [lanes[k][i] for k in ("counter", "gauge", "timer") for i in (0, 1)]
    out += [lanes["rollup"], lanes["err"]]
    out += [t for field in state for row in field for t in row[0]]
    return [t.cpu() for t in out]


def mesh_same(a: list, b: list, what: str) -> None:
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape and same_bits(x, y), f"{what}: output {k}"


def mesh_sharded_step(seed: int, dev, card: str) -> tuple:
    """Phase 20 (a): the sharded step at config #3's width on 8 shards of
    the card (a repeated device list), packed then f64.  Returns (times,
    launches on the f64 run, kernels #3 and #4's largest bit difference)."""
    import torch

    from m3_tpu_torch.aggregator import arena
    from m3_tpu_torch.parallel import segment_ingest as si

    t_part = time.perf_counter()
    t0 = time.perf_counter()
    tr = MeshTraffic(seed, MESH_SERIES, MESH_SHARDS)
    batch = tr.batch(MESH_CAPACITY)
    batch_d = type(batch)(*(torch.from_numpy(a).to(dev) for a in batch))
    counts = np.bincount(tr.shard, minlength=MESH_SHARDS)
    t = {"series": MESH_SERIES, "shards": MESH_SHARDS, "samples": int(3 * MESH_SERIES),
         "rows_per_shard": int(batch.windows.shape[1]), "series_per_shard_max": int(counts.max()),
         "series_per_shard_min": int(counts.min()), "data_s": time.perf_counter() - t0}
    log(f"phase20 (a) data: {MESH_SERIES:,} series x 3 samples (counter, gauge and timer "
        f"lanes) on {MESH_SHARDS} shards by murmur3 ({counts.min():,}-{counts.max():,} a "
        f"shard), {MESH_CAPACITY} slots a shard; {t['data_s']:.1f} s")
    assert counts.max() <= MESH_CAPACITY
    want_rollup = torch.from_numpy(tr.rollup_oracle(MESH_CAPACITY))
    devices = [dev] * MESH_SHARDS
    launches, err = {}, 0.0
    warm = MeshTraffic(seed + 9, 256, MESH_SHARDS)
    for layout in ("packed", "f64"):
        mesh_step(devices, MESH_SHARDS, 1, warm.batch(64), 64, 1 << 10, layout)
        torch.cuda.synchronize()  # warm-up: lazy inits of this layout's ops
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        if layout == "f64":
            with IntoCheck("segment_ingest_into", si.segment_ingest_into_plain) as c3, \
                    IntoCheck("segment_minmax_into", si.segment_minmax_into_plain) as c4:
                state, lanes = mesh_step(devices, MESH_SHARDS, 1, batch_d, MESH_CAPACITY,
                                         MESH_SAMPLE_CAPACITY, layout)
                torch.cuda.synchronize()
            assert c3.calls > 0 and c4.calls > 0
            err = max(c3.err, c4.err)
        else:
            state, lanes = mesh_step(devices, MESH_SHARDS, 1, batch_d, MESH_CAPACITY,
                                     MESH_SAMPLE_CAPACITY, layout)
            torch.cuda.synchronize()
        got = read_launches()
        peak = torch.cuda.max_memory_allocated()
        if layout == "f64":
            launches = got
            assert got["segment_ingest"] > 0 and got["segment_minmax"] > 0, got
            log(f"phase20 (a) f64: kernels #3 and #4 bit-equal to their plain versions on "
                f"every launch ({c3.calls} and {c4.calls} calls); launches {got}")
        else:
            assert not any(got.values()), got
        del state
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the timed step: fresh state, no checks
        state, lanes = mesh_step(devices, MESH_SHARDS, 1, batch_d, MESH_CAPACITY,
                                 MESH_SAMPLE_CAPACITY, layout)
        torch.cuda.synchronize()
        t[f"{layout}_step_s"] = time.perf_counter() - t0
        t[f"{layout}_peak_gib"] = peak / 2**30

        # each shard against a one-device arena run on its own samples
        t0 = time.perf_counter()
        for d in range(MESH_SHARDS):
            rows = tr.rows(d)
            arenas = arena.make_arenas(2, MESH_CAPACITY, MESH_SAMPLE_CAPACITY, MESH_QUANTILES,
                                       layout=layout, device=dev)
            for a, kind, vals in zip(arenas, ("counter", "gauge", "timer"), rows[2:5]):
                a.ingest(rows[0], rows[1], vals, rows[5])
                want, cnt = a.consume(0)
                assert same_bits(lanes[kind][0][d], want), f"{layout} {kind} shard {d}"
                assert torch.equal(lanes[kind][1][d], cnt), f"{layout} {kind} count shard {d}"
        t[f"{layout}_oracle_s"] = time.perf_counter() - t0
        assert same_bits(lanes["rollup"].cpu(), want_rollup), f"{layout} rollup"
        assert not bool(lanes["err"].any()), lanes["err"]
        left = sum(int(st.count.sum()) if layout == "f64" else
                   int(arena_counts(st)) for st in (row[0] for row in state.counters))
        assert left == MESH_SERIES, left  # window 1's sample of every series
        log(f"phase20 (a) {layout}: every shard's counter, gauge and timer lanes == a "
            f"one-device arena run on its samples, bit for bit; the rollup == the numpy "
            f"oracle summed in shard order; err 0; {left:,} window-1 samples left; step "
            f"{t[f'{layout}_step_s']:.2f} s, peak {peak / 2**30:.2f} GiB")
        del state, lanes
        torch.cuda.empty_cache()

    # card against CPU on the first series, both layouts
    t0 = time.perf_counter()
    keep = np.arange(tr.n) < MESH_CHECK
    small = tr.batch(MESH_CAPACITY, keep)
    for layout in ("packed", "f64"):
        card_out = mesh_outputs(*mesh_step(devices, MESH_SHARDS, 1, small, MESH_CAPACITY,
                                           1 << 12, layout))
        cpu_out = mesh_outputs(*mesh_step(["cpu"] * MESH_SHARDS, MESH_SHARDS, 1, small,
                                          MESH_CAPACITY, 1 << 12, layout))
        mesh_same(card_out, cpu_out, f"(a) {layout} card vs CPU")
    t["card_cpu_s"] = time.perf_counter() - t0
    log(f"phase20 (a) card == CPU on the first {MESH_CHECK:,} series, both layouts: every "
        f"lane, the rollup, err and every state tensor bit for bit ({t['card_cpu_s']:.1f} s)")

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        keep = np.arange(tr.n) < MESH_CARDS_SERIES
        part = tr.batch(MESH_CAPACITY, keep)
        spread = [torch.device(f"cuda:{d % n_cards}") for d in range(MESH_SHARDS)]
        two = mesh_outputs(*mesh_step(spread, MESH_SHARDS, 1, part, MESH_CAPACITY, 1 << 14,
                                      "f64"))
        one = mesh_outputs(*mesh_step(devices, MESH_SHARDS, 1, part, MESH_CAPACITY, 1 << 14,
                                      "f64"))
        mesh_same(two, one, "(a) distinct cards vs one card")
        t["distinct_cards"] = n_cards
        log(f"phase20 (a) {MESH_CARDS_SERIES:,} series over {n_cards} distinct cards == the "
            f"same on one card, bit for bit (f64)")
    else:
        t["distinct_cards"] = 1
        log("phase20 (a) over distinct cards: did not run (this machine has one card)")
    t["part_s"] = time.perf_counter() - t_part
    return t, launches, err


def arena_counts(st) -> int:
    """Samples held in a packed counter state's base words."""
    from m3_tpu_torch.aggregator import packed

    cnt, _ = packed._unpack_base(st.base, packed.DEFAULT_WIDTHS)
    return int(cnt.sum())


def mesh_replicas(seed: int, dev, card: str) -> dict:
    """Phase 20 (b): a 4 x 2 mesh of the card, 2^16 series on the packed
    layout: the replicas agree; one bit flipped in one replica's counter
    state shows as exactly that shard's two ring edges; ``quorum_ack`` on a
    random ack matrix equals numpy."""
    import torch

    from m3_tpu_torch.parallel import mesh, replication

    t0 = time.perf_counter()
    tr = MeshTraffic(seed + 1, MESH_REPLICA_SERIES, 4)
    topo = mesh.make_mesh(4, 2, [dev] * 8)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    state, lanes = mesh_step([dev] * 8, 4, 2, tr.batch(MESH_REPLICA_CAPACITY),
                             MESH_REPLICA_CAPACITY, 1 << 16, "packed")
    div = replication.replica_divergence(topo, state)
    torch.cuda.synchronize()
    launched = read_launches()
    assert not any(launched.values()), launched
    assert div.shape == (4, 2) and not bool(div.any()), div
    assert not bool(lanes["err"].any())
    state.counters[1][1].base[17] ^= 1 << 20  # shard 1, replica 1: one bit of a count
    div = replication.replica_divergence(topo, state).cpu().numpy()
    want = np.zeros((4, 2), bool)
    want[1] = True  # two replicas: the flipped one's edge and its successor's
    assert np.array_equal(div, want), div
    rng = np.random.default_rng(seed + 2)
    acks = rng.integers(0, 2, (4, 2)).astype(np.int32)
    for required in (1, 2, 3):
        ok, got = replication.quorum_ack(topo, acks, required)
        assert np.array_equal(got.cpu().numpy(), acks.sum(axis=1))
        assert np.array_equal(ok.cpu().numpy(), acks.sum(axis=1) >= required)
    t = {"replica_series": MESH_REPLICA_SERIES, "replica_wall_s": time.perf_counter() - t0,
         "replica_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"phase20 (b) 4 x 2 mesh, {MESH_REPLICA_SERIES:,} series: replica_divergence all "
        f"False; one flipped bit in shard 1's replica 1 turns exactly shard 1's two edges "
        f"True; quorum_ack == numpy for required 1, 2, 3 ({t['replica_wall_s']:.1f} s)")
    return t


def mesh_codec(seed: int, S: int, T: int, dev, card: str) -> tuple:
    """Phase 20 (c): the sharded codec at config #2 over two shards of the
    card against the one-device codec; the pinned batch over three; the
    fused chains tail against the gather tail.  Returns (times, launches,
    kernel #1's and #2's largest bit difference)."""
    import torch

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.core.xtime import Unit
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.parallel.sharded_decode import decode_batch_device_sharded
    from m3_tpu_torch.parallel.sharded_encode import encode_batch_device_sharded

    t_part = time.perf_counter()
    ts, vals, starts = make_batch(seed, S, T)
    valid = np.ones((S, T), bool)
    vb = vals.view(np.int64)
    W = max(16, T * 40 // 64 + 8)  # phase 3's width
    devices = [dev] * MESH_CODEC_SHARDS
    t = {"codec_series": S, "codec_points": T, "codec_shards": MESH_CODEC_SHARDS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = mt.encode_batch_device(ts, vb, starts, valid, out_words=W, device=dev)
    torch.cuda.synchronize()
    t["encode_one_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as c1:
        enc = encode_batch_device_sharded(ts, vb, starts, valid, out_words=W, devices=devices)
        torch.cuda.synchronize()
    t["encode_sharded_s"] = time.perf_counter() - t0
    enc_launches = read_launches()
    for k in ("words", "total_bits", "fallback"):
        assert torch.equal(enc[k], one[k]), f"sharded encode {k}"
    assert c1.calls == MESH_CODEC_SHARDS and enc_launches["place_words"] == c1.calls
    log(f"phase20 (c) encode {S:,} x {T} over {MESH_CODEC_SHARDS} shards: words, total_bits "
        f"and fallback == the one-device encode; kernel #1 bit-equal to plain on each of "
        f"{c1.calls} launches; {t['encode_sharded_s']:.2f} s against {t['encode_one_s']:.2f} s "
        f"for one device ({t['encode_sharded_s'] / t['encode_one_s']:.2f}x)")
    del enc
    # the streams as storage holds them (the EOS tail appended), the
    # fallback series left out
    fb = one["fallback"].cpu().numpy()
    ok = ~fb
    assert fb.mean() < 0.05, fb.mean()
    t0 = time.perf_counter()
    streams = mt.finalize_streams(one["words"].cpu().numpy()[ok],
                                  one["total_bits"].cpu().numpy()[ok])
    words, nbits = (torch.from_numpy(a).to(dev) for a in mt.pack_streams(streams))
    words = words.view(torch.int64)
    t["finalize_pack_s"] = time.perf_counter() - t0
    del streams, one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec_one = mt.decode_batch_device(words, nbits, T + 1, device=dev)
    torch.cuda.synchronize()
    t["decode_one_s"] = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    with KernelCheck(mt, "extract_fields64_t", decode_gather.extract_fields64_t_plain) as c2:
        dec = decode_batch_device_sharded(words, nbits, T + 1, devices=devices)
        torch.cuda.synchronize()
    t["decode_sharded_s"] = time.perf_counter() - t0
    dec_launches = read_launches()
    t["codec_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    assert all(torch.equal(a, b) for a, b in zip(dec, dec_one)), "sharded decode"
    assert c2.calls == MESH_CODEC_SHARDS and dec_launches["extract_fields64_t"] == c2.calls
    assert not bool(dec[3].any()), "decode flagged encoded series"
    assert np.array_equal(dec[0][:, :T].cpu().numpy(), ts[ok]), "timestamps did not round-trip"
    log(f"phase20 (c) decode over {MESH_CODEC_SHARDS} shards == the one-device decode on "
        f"every output, timestamps round-trip on {int(ok.sum()):,} series; kernel #2 "
        f"bit-equal to plain on each of {c2.calls} launches; {t['decode_sharded_s']:.2f} s "
        f"against {t['decode_one_s']:.2f} s")
    del dec, dec_one

    pts, pvals, pstarts = pinned_batch()
    pin = encode_batch_device_sharded(pts, pvals.view(np.int64), pstarts,
                                      np.ones(pts.shape, bool), unit=int(Unit.SECOND),
                                      out_words=200, devices=[dev] * 3)
    assert not bool(pin["fallback"].any())
    pw, pn = mt.pack_streams(mt.finalize_streams(pin["words"].cpu().numpy(),
                                                 pin["total_bits"].cpu().numpy()))
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(pw).tobytes())
    h.update(np.ascontiguousarray(pn).tobytes())
    assert h.hexdigest() == PINNED_ENCODE_DIGEST, h.hexdigest()
    log("phase20 (c) the pinned batch over 3 shards: the pinned encode digest")

    n = MESH_FUSED_CHECK
    t0 = time.perf_counter()
    fused = mt.decode_batch_device(words[:n], nbits[:n], T + 1, device=dev, chains="fused")
    torch.cuda.synchronize()
    t["fused_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gather = mt.decode_batch_device(words[:n], nbits[:n], T + 1, device=dev, chains="gather")
    torch.cuda.synchronize()
    t["gather_s"] = time.perf_counter() - t0
    assert all(torch.equal(a, b) for a, b in zip(fused, gather)), "fused != gather"
    log(f"phase20 (c) chains='fused' == 'gather' on every output of the first {n:,} "
        f"streams ({t['fused_s']:.2f} s against {t['gather_s']:.2f} s)")
    t["codec_part_s"] = time.perf_counter() - t_part
    launches = {k: enc_launches[k] + dec_launches[k] for k in enc_launches}
    return t, launches, c1.err, c2.err


def mesh_query(seed: int, G: int, B: int, dev, card: str) -> tuple:
    """Phase 20 (d): ``sharded_decode_rate_hq`` at config #5 over four
    shards of the card against ``single_device_reference`` (rates rtol
    1e-14, hq rtol 1e-12, errs exactly), and card against CPU on a slice,
    bit for bit.  Returns (times, launches, kernel #2's largest bit
    difference)."""
    import torch

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, mesh
    from m3_tpu_torch.parallel import sharded_query as sq

    t_part = time.perf_counter()
    ts, vals, ub_labels = promql_corpus(seed, G, B)
    S, P = ts.shape
    t0 = time.perf_counter()
    streams, fb = mt.encode_batch(ts, vals, ts[:, 0].copy(), out_words=P * 80 // 64 + 8,
                                  device=dev)
    enc_s = time.perf_counter() - t0
    D = MESH_QUERY_SHARDS
    keep = np.flatnonzero(~fb)
    keep = keep[:len(keep) // D * D]
    words, nbits = mt.pack_streams([streams[i] for i in keep])
    del streams
    words = words.view(np.int64).reshape(D, len(keep) // D, -1)
    nbits = nbits.reshape(D, -1)
    bid = (keep % B).astype(np.int32).reshape(D, -1)
    ubs = np.array([np.inf if u == b"+Inf" else float(u) for u in ub_labels])
    q_start = PROMQL_START + RATE_WIN
    steps = np.arange(q_start, q_start + PROMQL_RANGE + 1, PROMQL_STEP, dtype=np.int64)
    args = (RATE_WIN, 0.99, P + 1, B)
    topo = mesh.make_mesh(D, 1, [dev] * D)
    w_d = torch.from_numpy(words).to(dev)
    nb_d = torch.from_numpy(nbits).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with KernelCheck(mt, "extract_fields64_t", decode_gather.extract_fields64_t_plain) as c2:
        rates, hq, errs = sq.sharded_decode_rate_hq(topo, w_d, nb_d, bid, steps, ubs, *args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    assert c2.calls == D and launches["extract_fields64_t"] == D, launches
    t0 = time.perf_counter()
    r_ref, hq_ref, e_ref = sq.single_device_reference(w_d, nb_d, bid, steps, ubs, *args,
                                                      device=dev)
    ref_s = time.perf_counter() - t0
    r, h, e = rates.cpu().numpy(), hq.cpu().numpy(), errs.cpu().numpy()
    assert np.array_equal(e, e_ref) and not e.any()
    rates_exact = same_bits(rates.cpu(), torch.from_numpy(r_ref))
    np.testing.assert_allclose(r, r_ref, rtol=1e-14)
    np.testing.assert_allclose(h, hq_ref, rtol=1e-12)
    assert np.isfinite(h).all()
    hq_err = rel_err(h, hq_ref)
    log(f"phase20 (d) config #5 ({len(keep):,} streams x {P} samples, encoded in {enc_s:.1f} "
        f"s) over {D} shards: rates {'bit-equal to' if rates_exact else 'within rtol 1e-14 of'} "
        f"single_device_reference, hq within rtol 1e-12 (largest {hq_err:.3e}), errs equal; "
        f"kernel #2 bit-equal to plain on each of {c2.calls} launches; {wall:.2f} s against "
        f"{ref_s:.2f} s for the reference")

    n = MESH_QUERY_CHECK // D
    sl = (w_d[:, :n].cpu(), nb_d[:, :n].cpu(), bid[:, :n], steps, ubs) + args
    card = sq.sharded_decode_rate_hq(topo, *sl)
    cpu = sq.sharded_decode_rate_hq(mesh.make_mesh(D, 1, ["cpu"] * D), *sl)
    for a, b, what in zip(card, cpu, ("rates", "hq", "errs")):
        assert same_bits(a.cpu(), b), f"(d) card vs CPU {what}"
    log(f"phase20 (d) card == CPU on the first {n} streams of each shard: rates, hq and errs "
        f"bit for bit")
    t = {"query_streams": int(len(keep)), "query_shards": D, "query_encode_s": enc_s,
         "query_sharded_s": wall, "query_reference_s": ref_s, "query_peak_gib": peak / 2**30,
         "query_rates_bit_equal_to_reference": rates_exact, "query_hq_max_rel_err": hq_err,
         "query_part_s": time.perf_counter() - t_part}
    return t, launches, c2.err


def mesh_phase(seed: int, S: int, dev, card: str) -> tuple:
    """Phase 20: see the module docstring.  Returns (times, launches on the
    mesh's main paths summed over the parts, the largest bit difference of
    each kernel against its plain version there)."""
    import torch

    t_all = time.perf_counter()
    t_a, l_a, err34 = mesh_sharded_step(seed, dev, card)
    torch.cuda.empty_cache()
    t_b = mesh_replicas(seed, dev, card)
    t_c, l_c, err1, err2c = mesh_codec(seed, S, MESH_CODEC_POINTS, dev, card)
    torch.cuda.empty_cache()
    t_d, l_d, err2d = mesh_query(seed, PROMQL_GROUPS, PROMQL_BUCKETS, dev, card)
    torch.cuda.empty_cache()
    launches = {k: l_a[k] + l_c[k] + l_d[k] for k in l_a}
    assert all(v > 0 for v in launches.values()), launches
    t = {"a": t_a, "b": t_b, "c": t_c, "d": t_d, "launches": launches,
         "phase_s": time.perf_counter() - t_all}
    log(f"phase20 [{card}] mesh: " + json.dumps(t))
    errs = {"place_words": err1, "extract_fields64_t": max(err2c, err2d),
            "segment_ingest": err34, "segment_minmax": err34}
    return t, launches, errs


# ---- phase 21: the replicated storage cluster ----

CLUSTER_SERIES = 100_000  # config #2's width
CLUSTER_SHARDS = 64  # M3's documented cluster placement: 64 shards
CLUSTER_RF = 3  # replication factor 3, one node to an isolation group
CLUSTER_UP_SCRAPES = 3  # (a): all three nodes up; of the 12 at first (PERF.md §4)
CLUSTER_DOWN_SCRAPES = 2  # (b): node C down; of the 6 at first (PERF.md §4)
CLUSTER_READ_SAMPLE = 1000
# per-shard sizing of the nodes' namespace; 0 keeps the storage defaults
# (2^17 slots, 2^18 samples a window)
CLUSTER_SLOT_CAPACITY = 0
CLUSTER_SAMPLE_CAPACITY = 0
REPAIR_SERIES = 1 << 10  # part (f): repair merges through the scalar host codec (PERF.md §4)
REPAIR_UP_SCRAPES = 1  # (f): scrapes all three nodes take
REPAIR_MISSED_SCRAPES = 6  # (f): scrapes node C misses
# (f)'s namespace sized for its 16 series a shard (at most 2^10 series,
# 7 samples each, in one shard)
REPAIR_SLOT_CAPACITY = 1 << 10
REPAIR_SAMPLE_CAPACITY = 1 << 13
CLUSTER_FLUSH_AT = STORE_START + BLOCK + 10 * 60 * SEC + SEC  # past the block and bufferPast


class ClusterTraffic:
    """Phase 21's seeded traffic: S untagged gauges scraped every 10 s
    from ``STORE_START`` (phase 3's value mix, a fixed whole-second
    offset per series), K scrapes; scrape k is one ``write_batch`` call.
    The same interface as ``StorageTraffic`` for ``store_drive``."""

    def __init__(self, seed: int, S: int, K: int, prefix: bytes = b"cluster"):
        _, vals, _ = make_batch(seed + 21, S, K)
        rng = np.random.default_rng(seed + 210)
        self.S, self.K = S, K
        self.ids = [b"%s%06d.gauge" % (prefix, i) for i in range(S)]
        off = rng.integers(0, 10, S).astype(np.int64) * SEC
        self.ts = STORE_START + np.arange(K, dtype=np.int64)[None, :] * STORE_SCRAPE + off[:, None]
        self.vals = vals
        self.extra: list = [None] * K

    def batch(self, k: int):
        return np.arange(self.S), self.ts[:, k], self.vals[:, k]

    def now(self, k: int) -> int:
        return STORE_START + (k + 1) * STORE_SCRAPE


def cluster_config(name: str, root: Path, kv_port: int, rpc_port: int = 0, peers=(),
                   capacity=(CLUSTER_SLOT_CAPACITY, CLUSTER_SAMPLE_CAPACITY)):
    """One dbnode of the cluster: namespace ``default`` with 64 shards at
    the other defaults, commit log on, the RPC listener on loopback, the
    cluster's KV (the etcd role) at ``kv_port``, ``instance_id`` set (the
    topology watcher and shard migrator), no HTTP front door, the mediator
    with a tick too long to fire (the phase drives ``run_once``) and an
    unbudgeted migration pass; ``peers`` turns on the peers bootstrap."""
    from m3_tpu_torch.core.config import (
        DBConfig, MediatorConfig, NamespaceConfig, NodeConfig,
    )

    ns = NamespaceConfig(num_shards=CLUSTER_SHARDS, slot_capacity=capacity[0],
                         sample_capacity=capacity[1])
    return NodeConfig(
        db=DBConfig(root=str(root), namespaces={"default": ns}, rpc_listen_port=rpc_port,
                    kv_endpoint=f"127.0.0.1:{kv_port}", instance_id=name,
                    peers=list(peers), bootstrap_peers=bool(peers)),
        coordinator=None,
        mediator=MediatorConfig(tick_interval="24h", scrub_volumes=0, migrate_blocks=0))


def node_counter(asm, name: str) -> float:
    """A counter of the node's registry, as ``/metrics`` renders it."""
    key = f"{asm.config.metrics_prefix}_{name} "
    for line in asm.registry.render_prometheus().splitlines():
        if line.startswith(key):
            return float(line.split()[-1])
    return 0.0


def wait_for(pred, what: str, timeout: float = 30.0) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


class Cluster:
    """A KV service and dbnodes (``run_node`` each, in this process,
    talking over loopback; ``devices`` names them, A, B and C boot at
    once), a placement of 64 shards at RF 3 over A, B and C, and a ``ReplicatedSession.dynamic`` on the placement
    (writes at MAJORITY, reads at UNSTRICT_MAJORITY, M3's client
    defaults).  The session's per-replica transport retries keep their
    three attempts with millisecond backoffs, so a node that is down
    fails its slot of a fan-out at once."""

    def __init__(self, tag: str, devices: dict,
                 capacity=(CLUSTER_SLOT_CAPACITY, CLUSTER_SAMPLE_CAPACITY)):
        from m3_tpu_torch.cluster.kv_remote import RemoteKVStore, serve_kv_background
        from m3_tpu_torch.cluster.placement import PlacementService, initial_placement

        self.tag, self.devices, self.capacity = tag, devices, capacity
        self.roots = {n: store_root(f"{tag}/{n}") for n in devices}
        self.kvs = serve_kv_background(root=str(store_root(f"{tag}/kv")))
        self.asms: dict = {}
        self.ports: dict = {}
        self.sess = None
        self.kv = RemoteKVStore(("127.0.0.1", self.kvs.port), watch_poll_s=0.2)
        self.ps = PlacementService(self.kv)
        try:
            for name in ("A", "B", "C"):
                self.boot(name)
            self.ps.set(initial_placement([self.instance(n, k) for k, n in enumerate("ABC")],
                                          CLUSTER_SHARDS, CLUSTER_RF))
            self.settle()
        except BaseException:
            self.close()
            raise

    def instance(self, name: str, group: int):
        from m3_tpu_torch.cluster.placement import Instance

        return Instance(name, isolation_group=f"g{group}",
                        endpoint=f"127.0.0.1:{self.ports[name]}")

    def boot(self, name: str, peers=()):
        from m3_tpu_torch.server.assembly import run_node

        cfg = cluster_config(name, self.roots[name], self.kvs.port,
                             rpc_port=self.ports.get(name, 0),
                             peers=[f"127.0.0.1:{self.ports[p]}" for p in peers],
                             capacity=self.capacity)
        asm = self.asms[name] = run_node(cfg, device=self.devices[name])
        self.ports[name] = asm.rpc_port
        return asm

    def settle(self) -> None:
        """Wait until every running node's topology watcher holds the
        placement's current version."""
        v = self.kv.get("placement").version
        for name, asm in self.asms.items():
            wait_for(lambda: asm.topology.view().version >= v, f"{name} at placement v{v}")

    def session(self):
        from m3_tpu_torch.client.session import ReplicatedSession
        from m3_tpu_torch.server.rpc import RemoteDatabase
        from m3_tpu_torch.x.retry import Retrier, RetryOptions

        def resolve(inst):
            host, _, port = inst.endpoint.rpartition(":")
            return RemoteDatabase((host, int(port)))

        self.sess = ReplicatedSession.dynamic(self.kv, resolve)
        self.sess.retrier = Retrier(RetryOptions(initial_backoff_s=0.001, max_backoff_s=0.002,
                                                 max_attempts=3), name="replication")
        return self.sess

    def write(self, traffic, k: int) -> None:
        rejected = self.sess.write_batch("default", traffic.ids, traffic.ts[:, k],
                                         traffic.vals[:, k], now_nanos=traffic.now(k))
        assert rejected == 0, rejected

    def down(self, name: str) -> None:
        """The node's RPC listener stopped and the session's connection
        to it dropped (its handler thread ends): the node is down to the
        session."""
        asm = self.asms[name]
        stop(asm.rpc_server)
        asm.rpc_server = None
        self.sess.connections[name].close()

    def close(self) -> None:
        if self.sess is not None:
            self.sess.close()
        for asm in self.asms.values():
            asm.close()
        self.kv.close()
        stop(self.kvs)


def replica_volumes(asm, traffic, dev) -> int:
    """Every volume of the node read with ``DataFileSetReader`` and
    decoded with ``decode_batch`` on ``dev`` (kernel #2), equal bit for
    bit to every sample the node holds for the block (``traffic``'s
    scrapes).  Returns the points."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.persist.fs import DataFileSetReader

    root = asm.db.opts.root
    pos = {sid: i for i, sid in enumerate(traffic.ids)}
    rows, segs = [], []
    for sh, bs, v in fileset_volumes(root):
        assert bs == STORE_START and v == 0, (sh, bs, v)
        r = DataFileSetReader(root, "default", sh, bs, v)
        for sid, seg in r.read_all():
            rows.append(pos[sid])
            segs.append(seg)
        r.close()
    rows = np.asarray(rows)
    assert np.array_equal(np.sort(rows), np.arange(traffic.S)), "volumes miss series"
    d_ts, d_vals, counts, dfb = mt.decode_batch(segs, traffic.K + 1, device=dev)
    assert not dfb.any() and (counts == traffic.K).all()
    assert np.array_equal(d_ts[:, :traffic.K], traffic.ts[rows]), "volume timestamps"
    assert np.array_equal(d_vals[:, :traffic.K].view(np.int64),
                          traffic.vals[rows].view(np.int64)), "volume values"
    return int(counts.sum())


def session_reads(sess, traffic, rows) -> list:
    """``fetch_batch`` of the sampled series at the session's read level,
    equal to the acknowledged samples, each point once.  Returns the
    points as (timestamp, value bits)."""
    sids = [traffic.ids[i] for i in rows]
    got = sess.fetch_batch("default", sids, STORE_START, STORE_START + BLOCK)
    bits = []
    for i, pts in zip(rows, got):
        assert [t for t, _ in pts] == traffic.ts[i].tolist(), i
        vb = np.asarray([v for _, v in pts]).view(np.int64).tolist()
        assert vb == traffic.vals[i].view(np.int64).tolist(), i
        bits.append(list(zip([t for t, _ in pts], vb)))
    return bits


def shard_digests(root, shards) -> dict:
    """sha256 of each file of the given shards' filesets."""
    return {k: v for k, v in volume_digests(root).items()
            if int(Path(k).parts[2]) in shards}


def repair_cluster(seed: int, dev, tag: str) -> dict:
    """Part (f) on ``dev``: a cluster of ``REPAIR_SERIES`` series; C takes
    the first ``REPAIR_UP_SCRAPES`` scrapes, is closed, misses
    ``REPAIR_MISSED_SCRAPES`` (acked by A and B), and restarts on its
    own root (its commit log replayed); the three flush; then
    ``repair_namespace`` over three ``RemoteDatabase`` handles rewrites
    C's blocks with the union, and a second pass finds them converged.
    Returns the files and times."""
    from m3_tpu_torch.server.rpc import RemoteDatabase
    from m3_tpu_torch.storage.repair import repair_namespace

    traffic = ClusterTraffic(seed + 1, REPAIR_SERIES, REPAIR_UP_SCRAPES + REPAIR_MISSED_SCRAPES,
                             prefix=b"repair")
    cl = Cluster(tag, {n: dev for n in "ABC"}, (REPAIR_SLOT_CAPACITY, REPAIR_SAMPLE_CAPACITY))
    try:
        cl.session()
        for k in range(REPAIR_UP_SCRAPES):
            cl.write(traffic, k)
        cl.down("C")
        cl.asms["C"].close()
        for k in range(REPAIR_UP_SCRAPES, traffic.K):
            cl.write(traffic, k)
        boot = cl.boot("C")
        held = boot.db.read_batch("default", traffic.ids, STORE_START, STORE_START + BLOCK)
        assert all(len(p) == REPAIR_UP_SCRAPES for p in held), "C's commit log replay"
        cl.settle()
        for name in "ABC":
            cl.asms[name].mediator.run_once(CLUSTER_FLUSH_AT)
        handles = [RemoteDatabase(("127.0.0.1", cl.ports[n])) for n in "ABC"]
        try:
            t0 = time.perf_counter()
            rep = repair_namespace(handles, "default", num_shards=CLUSTER_SHARDS)
            repair_s = time.perf_counter() - t0
            rep2 = repair_namespace(handles, "default", num_shards=CLUSTER_SHARDS)
            metas = [[h.block_metadata("default", sh, STORE_START) for sh in range(CLUSTER_SHARDS)]
                     for h in handles]
        finally:
            for h in handles:
                h.close()
        assert rep["series_diff"] == REPAIR_SERIES and rep["repaired_replicas"] == CLUSTER_SHARDS, rep
        assert rep2.converged and rep2["series_checked"] == REPAIR_SERIES, rep2
        assert metas[0] == metas[1] == metas[2], "replicas diverge after repair"
        sids = [traffic.ids[i] for i in range(traffic.S)]
        got = cl.sess.fetch_batch("default", sids, STORE_START, STORE_START + BLOCK)
        for i, pts in enumerate(got):
            assert [t for t, _ in pts] == traffic.ts[i].tolist(), i
        for name in "ABC":
            cl.asms[name].close()
        cl.asms.clear()
        files = {n: volume_digests(cl.roots[n]) for n in "ABC"}
    finally:
        cl.close()
    return {"report": dict(rep), "repair_s": repair_s, "files": files}


def repair_in_process(seed: int, device: str, side: str) -> tuple:
    """Part (f) on ``device``, in a process of its own (one torch
    thread): the result and its wall, ending in a synchronize."""
    import torch

    torch.set_num_threads(1)
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = repair_cluster(seed, dev, f"phase21-repair-{side}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def cluster_phase(seed: int, dev, card: str) -> tuple:
    """Phase 21: the replicated storage cluster.  Part (f)'s two runs, on
    the card and on the CPU, go to two spawned processes at once and run
    beside (a)-(e).  Returns (times, the four kernels' launches on the
    main path (a)-(c), their launches in the volume check (d), kernel
    #1's record at the flush's shapes)."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        repairs = {side: pool.apply_async(repair_in_process, (seed, str(d), side))
                   for side, d in (("card", dev), ("cpu", "cpu"))}
        return cluster_parts(seed, dev, card, repairs)
    finally:
        pool.terminate()
        pool.join()


def cluster_parts(seed: int, dev, card: str, repairs: dict) -> tuple:
    """Phase 21's parts (a)-(e), then (f)'s results from ``repairs``, its
    card and CPU runs in flight."""
    import shutil

    import torch

    from m3_tpu_torch.cluster.placement import ShardState, add_instance
    from m3_tpu_torch.core.config import MediatorConfig
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.server.assembly import namespace_options
    from m3_tpu_torch.storage import database as tdb

    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 3:
        devices = {n: torch.device("cuda", k) for k, n in enumerate("ABC")}
        devices["D"] = torch.device("cuda", 3 % n_cards)
    else:
        devices = {n: dev for n in "ABCD"}
    log("phase21 nodes on " + ", ".join(f"{n}: {d}" for n, d in devices.items()))
    t_gen = time.perf_counter()
    traffic = ClusterTraffic(seed, CLUSTER_SERIES, CLUSTER_UP_SCRAPES + CLUSTER_DOWN_SCRAPES)
    t = {"series": traffic.S, "shards": CLUSTER_SHARDS, "rf": CLUSTER_RF,
         "scrapes_up": CLUSTER_UP_SCRAPES, "scrapes_c_down": CLUSTER_DOWN_SCRAPES,
         "generate_s": time.perf_counter() - t_gen}
    part: dict = {}
    peaks: dict = {}

    def begin(key):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        part[key] = time.perf_counter()

    def end(key):
        torch.cuda.synchronize()
        part[key] = time.perf_counter() - part[key]
        peaks[key] = torch.cuda.max_memory_allocated() / 2**30

    begin("boot")
    cl = Cluster("phase21", devices)
    end("boot")
    try:
        p = cl.ps.get()
        for name, asm in cl.asms.items():
            owned = asm.db.owned_shards("default")
            assert owned == frozenset(p.instances[name].shards), name
        sess = cl.session()
        log(f"phase21 boot: KV service, A, B and C (run_node, RPC on loopback) and the "
            f"placement of {CLUSTER_SHARDS} shards at RF {CLUSTER_RF} in {part['boot']:.1f} s; "
            f"each node owns its placement's shards")

        # (a) all three up; (b) C's RPC server stopped
        zero_launches()
        begin("a")
        for k in range(CLUSTER_UP_SCRAPES):
            cl.write(traffic, k)
        end("a")
        cl.down("C")
        begin("b")
        for k in range(CLUSTER_UP_SCRAPES, traffic.K):
            cl.write(traffic, k)
        end("b")
        writes = {n: node_counter(a, "db_writes") for n, a in cl.asms.items()}
        S = traffic.S
        assert writes == {"A": traffic.K * S, "B": traffic.K * S,
                          "C": CLUSTER_UP_SCRAPES * S}, writes
        t["a_samples_per_s"] = CLUSTER_UP_SCRAPES * S / part["a"]
        t["b_samples_per_s"] = CLUSTER_DOWN_SCRAPES * S / part["b"]
        log(f"phase21 [{card}] (a) {CLUSTER_UP_SCRAPES} scrapes at MAJORITY, all three up: "
            f"acked == sent, {t['a_samples_per_s']:,.0f} samples/s; (b) C down, "
            f"{CLUSTER_DOWN_SCRAPES} scrapes each acked by A and B: "
            f"{t['b_samples_per_s']:,.0f} samples/s; replica writes {writes}")

        # (c) A and B flush; C is wiped and bootstraps from its peers
        begin("c_flush")
        flush_s = {}
        with KernelCheck(mt, "place_words", encode_place.place_words_plain) as check:
            for name in "AB":
                t0 = time.perf_counter()
                stats = cl.asms[name].mediator.run_once(CLUSTER_FLUSH_AT)
                torch.cuda.synchronize()
                flush_s[name] = time.perf_counter() - t0
                assert stats["tick"]["default"]["warm_flushed"] == S, stats
        end("c_flush")
        launched = read_launches()
        assert launched["place_words"] == 2 * CLUSTER_SHARDS == check.calls, launched
        assert not any(v for k, v in launched.items() if k != "place_words"), launched
        frags, keys, w_out = check.args
        place = {"cluster_ms": cuda_ms(lambda: check.fn(frags, keys, w_out)),
                 "cluster_plain_ms": cuda_ms(
                     lambda: encode_place.place_words_plain(frags, keys, w_out)),
                 "cluster_bound_ms": (frags.numel() * (8 + 4) + frags.shape[0] * w_out * 8)
                 / HBM_BYTES_PER_S * 1e3,
                 "cluster_shape": [list(frags.shape), w_out], "cluster_max_abs_err": check.err}
        del check, frags, keys
        begin("c_bootstrap")
        cl.asms["C"].close()
        shutil.rmtree(cl.roots["C"])
        cl.roots["C"].mkdir(parents=True)
        cl.boot("C", peers="AB")
        end("c_bootstrap")
        cl.settle()
        files = {n: volume_digests(cl.roots[n]) for n in "ABC"}
        assert len(files["A"]) == 7 * CLUSTER_SHARDS, len(files["A"])  # 7 files a fileset
        assert files["A"] == files["B"] == files["C"], "replica filesets differ"
        begin("c_reference")
        ref_root = store_root("phase21/reference")
        ns_cfg = cluster_config("reference", ref_root, cl.kvs.port).db.namespaces["default"]
        ref = tdb.Database(tdb.DatabaseOptions(root=str(ref_root)),
                           {"default": namespace_options(ns_cfg)}, device=dev)
        store_drive(ref, traffic, 1)
        ref.tick(CLUSTER_FLUSH_AT)
        ref.close()
        end("c_reference")
        ref_files = volume_digests(ref_root)
        assert ref_files == files["A"], "the replicas' filesets != one Database's"
        log(f"phase21 [{card}] (c) warm flush of A and B, {CLUSTER_SHARDS} shards each: "
            f"{flush_s['A']:.2f} s and {flush_s['B']:.2f} s; kernel #1 == plain in "
            f"{2 * CLUSTER_SHARDS} calls; C wiped and restarted with peers A, B: boot and peers "
            f"bootstrap {part['c_bootstrap']:.2f} s; all three nodes' {len(files['A'])} fileset "
            f"files sha256-equal, and equal to one Database of {CLUSTER_SHARDS} shards fed the "
            f"same {traffic.K} scrapes ({part['c_reference']:.1f} s)")

        # (d) every replica's volumes decoded on the card; reads at the session's level
        zero_launches()
        begin("d")
        points = {}
        with KernelCheck(mt, "extract_fields64_t",
                         decode_gather.extract_fields64_t_plain) as dcheck:
            for name in "ABC":
                points[name] = replica_volumes(cl.asms[name], traffic, devices[name])
        check_launched = read_launches()
        assert check_launched["extract_fields64_t"] > 0 and dcheck.calls > 0, check_launched
        rows = np.sort(np.random.default_rng(seed + 21).choice(
            S, min(CLUSTER_READ_SAMPLE, S), replace=False))
        before = session_reads(sess, traffic, rows)
        end("d")
        log(f"phase21 (d) every replica's volumes decoded on the card == the acked samples "
            f"bit for bit ({points} points; kernel #2 == plain in {dcheck.calls} calls); "
            f"{len(rows)} series through fetch_batch at unstrict_majority == the acked samples, "
            f"each point once ({part['d']:.1f} s)")
        del dcheck

        # (e) D joins; its shards stream from their donors, cut over, and the donors drop them
        zero_launches()
        begin("e")
        cl.boot("D")
        cl.ps.update(lambda pl: add_instance(pl, cl.instance("D", 3)))
        cl.settle()
        p1 = cl.ps.get()
        moved = sorted(s for s, a in p1.instances["D"].shards.items()
                       if a.state == ShardState.INITIALIZING)
        donors = {s: p1.instances["D"].shards[s].source_id for s in moved}
        assert moved and all(donors.values()), p1.instances["D"].shards
        # one unbudgeted migration pass streams every moved shard and cuts it over
        t0 = time.perf_counter()
        st = cl.asms["D"].mediator.run_once(CLUSTER_FLUSH_AT)["topology"]
        stream_s = time.perf_counter() - t0
        stream = {k: st[k] for k in ("blocks_streamed", "series_streamed")}
        cl.settle()
        p2 = cl.ps.get()
        assert all(a.state == ShardState.AVAILABLE for i in p2.instances.values()
                   for a in i.shards.values()), "shards left INITIALIZING or LEAVING"
        assert stream["blocks_streamed"] == st["cutovers"] == len(moved), (st, len(moved))
        dropped = dict.fromkeys("ABC", 0)
        for _ in range(MediatorConfig().migrate_grace_ticks + 1):  # the grace, then the drop
            for name in "ABC":
                st = cl.asms[name].mediator.run_once(CLUSTER_FLUSH_AT)["topology"]
                dropped[name] += st["shards_dropped"]
        assert sum(dropped.values()) == len(moved), (dropped, len(moved))
        for name in "ABC":
            mine = set(p2.instances[name].shards)
            gone = [s for s in range(CLUSTER_SHARDS) if s not in mine]
            assert all(not cl.asms[name].db.list_block_filesets("default", s) for s in gone), name
        d_shards = set(p2.instances["D"].shards)
        assert shard_digests(cl.roots["D"], d_shards) == shard_digests(ref_root, d_shards), \
            "D's filesets != the donors'"
        after = session_reads(sess, traffic, rows)
        assert after == before
        end("e")
        assert not any(read_launches().values())
        log(f"phase21 [{card}] (e) D joined through add_instance: {len(moved)} shards streamed "
            f"from their donors over RPC ({stream['blocks_streamed']} blocks, "
            f"{stream['series_streamed']:,} series, digest-verified) and cut over by CAS in "
            f"{stream_s:.2f} s; the donors dropped them after the grace ticks ({dropped}); D's "
            f"filesets sha256-equal to the donors'; reads before == after ({part['e']:.1f} s)")
    finally:
        cl.close()
    torch.cuda.empty_cache()

    # (f) repair, card against CPU, at 2^10 series
    f_t = {}
    runs = {}
    t0 = time.perf_counter()
    for side, res in repairs.items():
        runs[side], f_t[side] = res.get(timeout=600)
    f_t["wait"] = time.perf_counter() - t0
    assert runs["card"]["files"] == runs["cpu"]["files"], "repair: card files != CPU files"
    assert runs["card"]["report"] == runs["cpu"]["report"]
    log(f"phase21 [{card}] (f) {REPAIR_SERIES} series, C missing {REPAIR_MISSED_SCRAPES} scrapes "
        f"and rejoining from its commit log: repair_namespace over three RemoteDatabase handles "
        f"{runs['card']['report']} in {runs['card']['repair_s']:.2f} s (card) and "
        f"{runs['cpu']['repair_s']:.2f} s (CPU); then converged; card files == CPU files "
        f"({sum(len(v) for v in runs['card']['files'].values())} files, sha256); "
        f"part (f) {f_t['card']:.1f} s on the card and {f_t['cpu']:.1f} s on the CPU, each in "
        f"a process of its own beside (a)-(e) (waited {f_t['wait']:.1f} s for them)")
    t.update({f"{k}_s": v for k, v in part.items()})
    t.update({"flush_s_per_node": flush_s, "peak_gib": peaks,
              "stream_s": stream_s, "stream": stream, "moved_shards": len(moved),
              "repair_s": {k: v["repair_s"] for k, v in runs.items()},
              "f_s": f_t})
    log(f"phase21 [{card}] cluster: " + json.dumps(t))
    return t, launched, check_launched, place


# ---- phase 22: the device boundary and the control plane -----------------

DEV_SLOTS = 1_000_000  # slots an arena type (BASELINE configs #3-#4's width)
DEV_WINDOWS = 2
DEV_TIMER_SAMPLES = 1 << 22  # timer samples a window: four a timer
DEV_BUFFER_SERIES = 100_000  # config #2's width
DEV_BUFFER_SLOTS = 1 << 17  # slots of the buffer: room for the 100,000 series
DEV_BUFFER_SAMPLES = 1 << 21  # samples a window: 20 scrapes of the 100,000
DEV_CODEC_SERIES, DEV_CODEC_POINTS = 100_000, 720  # config #2's codec pass
CONTROL_SERIES = 100_000  # the nodes of (c) and (d): config #2's gauges
CONTROL_BATCH = 10_000  # samples a JSON write
CONTROL_ACKED = (0, 1, 3)  # (c)'s scrapes: 0 and 1 before the fault, 3 after
CONTROL_REFUSED = 2  # (c)'s scrape whose first writes meet the armed device.dispatch
CONTROL_FAILURES = 3  # (c)'s device.breaker_failures: the writes refused, to open it
CONTROL_QUERY_DELAY_MS = 1100  # (d)'s query.fetch latency fault: past 1.0 s
CONTROL_WAIT_S = 120.0  # the longest (d) waits for the controller to act
DEBUG_MEMBERS = ["threads.txt", "cpu.txt", "heap.txt", "host.json"]  # the reference's
# (d)'s query SLO: the built-in rule's ratio on a short ladder, so it burns
# and clears within the phase.  The latency fault slows the evaluator's own
# six fetches too (1.1 s each, as in the reference), so the evaluation gets
# a 30 s deadline and the windows hold several of its ~7 s passes.
CONTROL_RULES = [
    {"name": "query-latency", "objective": 0.99,
     "ratio": ('(sum(rate(m3tpu_query_seconds_count[{window}])) - '
               'sum(rate(m3tpu_query_seconds_bucket{le="1.0"}[{window}]))) / '
               'clamp_min(sum(rate(m3tpu_query_seconds_count[{window}])), 0.001)'),
     "windows": [{"long": "40s", "short": "20s", "factor": 14.4}]}]


def oom_through_a_stage(dev) -> dict:
    """(a): a ``ShardBuffer`` whose first tensor alone is larger than the
    card, with no budget set: one allocation that cannot succeed.  It
    must raise ``DeviceOOM`` caused by torch's OutOfMemoryError, counted
    on ``storage.buffer_append`` and opening its breaker (threshold 1
    here), with ``memory_allocated()`` back where it was."""
    import torch

    from m3_tpu_torch.storage.buffer import ShardBuffer
    from m3_tpu_torch.x import breaker, devguard, membudget

    _free, total = torch.cuda.mem_get_info(dev)
    samples = total // (4 * 2) + 1  # the (2, S) int32 slot lane alone > the card
    devguard.configure(failures=1, reset_s=3600.0)
    before = torch.cuda.memory_allocated(dev)
    used = membudget.used()
    try:
        ShardBuffer(BLOCK, 2, samples, DEV_BUFFER_SLOTS, device=dev)
    except devguard.DeviceOOM as e:
        err = e
    else:
        raise AssertionError("a buffer larger than the card was built")
    assert isinstance(err.__cause__, torch.cuda.OutOfMemoryError), repr(err.__cause__)
    assert torch.cuda.memory_allocated(dev) == before
    assert membudget.used() == used
    doc = devguard.status()["stages"]["storage.buffer_append"]
    assert doc == {"errors": {"oom": 1}, "breaker": "open"}, doc
    breaker.reset_registry()
    devguard.reset_stages()
    devguard.configure(failures=5, reset_s=10.0)
    return {"card_total_bytes": int(total), "asked_bytes": int(4 * 2 * samples),
            "error": str(err)[:120]}


def resident_checks(dev) -> dict:
    """(b): each resident structure at full width — the six arenas at
    10^6 slots, the buffer at 100,000 series, the decoder's control
    table: one byte below its footprint the budget refuses it before the
    card allocates anything; at the footprint it builds, and
    ``memory_allocated()`` grows by the footprint to the byte."""
    import gc

    import torch

    from m3_tpu_torch.aggregator import arena, packed
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.storage.buffer import ShardBuffer
    from m3_tpu_torch.x import membudget as mb

    W, C, SC = DEV_WINDOWS, DEV_SLOTS, DEV_TIMER_SAMPLES
    builds = [
        ("packed counter", lambda: packed.PackedCounterArena(W, C, device=dev),
         mb.counter_arena_bytes("packed", W, C)),
        ("packed gauge", lambda: packed.PackedGaugeArena(W, C, device=dev),
         mb.gauge_arena_bytes("packed", W, C)),
        ("packed timer", lambda: packed.PackedTimerArena(W, C, SC, device=dev),
         mb.timer_arena_bytes("packed", W, C, SC)),
        ("f64 counter", lambda: arena.CounterArena(W, C, device=dev),
         mb.counter_arena_bytes("f64", W, C)),
        ("f64 gauge", lambda: arena.GaugeArena(W, C, device=dev),
         mb.gauge_arena_bytes("f64", W, C)),
        ("f64 timer", lambda: arena.TimerArena(W, C, SC, device=dev),
         mb.timer_arena_bytes("f64", W, C, SC)),
        ("buffer", lambda: ShardBuffer(BLOCK, 2, DEV_BUFFER_SAMPLES, DEV_BUFFER_SLOTS,
                                       device=dev),
         mb.buffer_bytes(2, DEV_BUFFER_SAMPLES)),
    ]
    out = {}
    for name, build, need in builds:
        gc.collect()
        torch.cuda.synchronize(dev)
        base = mb.used()
        before = torch.cuda.memory_allocated(dev)
        mb.set_budget(base + need - 1)
        try:
            build()
        except mb.DeviceBudgetExceeded:
            pass
        else:
            raise AssertionError(f"{name}: built one byte over the budget")
        assert torch.cuda.memory_allocated(dev) == before, name
        mb.set_budget(base + need)
        obj = build()
        torch.cuda.synchronize(dev)
        delta = torch.cuda.memory_allocated(dev) - before
        assert delta == need == obj._mem.nbytes, (name, delta, need)
        out[name] = need
        del obj
    mb.set_budget(0)
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    mt.value_ctrl_table(dev)
    delta = torch.cuda.memory_allocated(dev) - before
    need = mt._CTRL_TBL_RESERVED[dev].nbytes
    assert delta == need == 1 << 20, (delta, need)
    out["decode.ctrl_table"] = need
    return out


def transient_checks(seed: int, dev) -> dict:
    """(b): the encode and decode passes at config #2's S x T from host
    arrays: each pass's device peak over what was allocated before it
    (``max_memory_allocated``) is covered by its transient reservation;
    the ratio is printed."""
    import torch

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.x import membudget as mb

    S, T = DEV_CODEC_SERIES, DEV_CODEC_POINTS
    W = max(16, T * 40 // 64 + 8)
    ts, vals, starts = make_batch(seed + 22, S, T)
    valid = np.ones((S, T), bool)

    def peak_of(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, torch.cuda.max_memory_allocated(dev) - base

    t0 = time.perf_counter()
    enc, enc_peak = peak_of(lambda: mt.encode_batch_device(
        ts, vals.view(np.int64), starts, valid, out_words=W, device=dev))
    enc_res = mb.encode_lane_bytes(S, T, W)
    fb = enc["fallback"].cpu().numpy()
    assert fb.mean() < 0.05, fb.mean()  # phase 3's bound on this mix
    streams = mt.finalize_streams(enc["words"].cpu().numpy().view(np.uint64),
                                  enc["total_bits"].cpu().numpy())
    del enc
    words, nbits = mt.pack_streams(streams)
    dec, dec_peak = peak_of(lambda: mt.decode_batch_device(
        torch.from_numpy(words.view(np.int64)), torch.from_numpy(nbits), T, device=dev))
    dec_res = mb.decode_lane_bytes(S, words.shape[1], T)
    assert np.array_equal(dec[0].cpu().numpy()[~fb], ts[~fb]), "decoded timestamps"
    del dec
    out = {"encode_reserved": enc_res, "encode_peak": int(enc_peak),
           "encode_ratio": enc_res / enc_peak, "decode_reserved": dec_res,
           "decode_peak": int(dec_peak), "decode_ratio": dec_res / dec_peak,
           "seconds": time.perf_counter() - t0}
    assert enc_res >= enc_peak and dec_res >= dec_peak, out
    return out


def f64_ingest_path(seed: int, dev) -> dict:
    """The ``arena.ingest`` stage on the f64 layout at full width: one
    scrape of 10^6 counters and one of 10^6 gauges into 10^6-slot arenas
    (kernels #3 and #4, each launch held bit for bit against its plain
    version on CPU copies), then each window's consume."""
    from m3_tpu_torch.aggregator import arena
    from m3_tpu_torch.parallel import segment_ingest as si
    from m3_tpu_torch.x import devguard

    rng = np.random.default_rng(seed + 220)
    C = DEV_SLOTS
    slots = rng.permutation(C).astype(np.int32)
    windows = np.zeros(C, np.int32)
    times = np.full(C, 1_700_000_000 * SEC, np.int64)
    cv = rng.integers(0, 1000, C)
    gv = np.round(rng.normal(50, 9, C), 2)
    c = arena.CounterArena(DEV_WINDOWS, C, device=dev)
    g = arena.GaugeArena(DEV_WINDOWS, C, device=dev)
    with IntoCheck("segment_ingest_into", si.segment_ingest_into_plain) as c3, \
            IntoCheck("segment_minmax_into", si.segment_minmax_into_plain) as c4:
        c.ingest(windows, slots, cv, times)
        g.ingest(windows, slots, gv, times)
    # one sample a slot: SUM, MIN and MAX are the sample, COUNT is 1
    for a, v in ((c, cv.astype(np.float64)), (g, gv)):
        lanes, cnt = (x.cpu().numpy() for x in a.consume(0))
        want = np.empty(C)
        want[slots] = v
        assert (cnt == 1).all() and np.array_equal(lanes[:, 5], want)
        assert np.array_equal(lanes[:, 1], want) and np.array_equal(lanes[:, 2], want)
    calls = devguard.counters()
    # two allocations a type, then the two scrapes
    assert calls["device.arena.ingest.calls"] >= 4 and calls["device.arena.consume.calls"] >= 2
    return {"into_calls": c3.calls + c4.calls,
            "max_abs_err": {"segment_ingest": c3.err, "segment_minmax": c4.err}}


class ControlNode:
    """One port node on the card for (c)-(e) and its HTTP client."""

    def __init__(self, name: str, extra: dict, dev):
        from m3_tpu_torch.server import assembly
        from m3_tpu_torch.x import breaker, devguard

        # the stage breakers and counters start fresh, as in a node's own
        # process: a breaker keeps the threshold it was created with, and
        # (a)-(b) created the stages' breakers before this node's config
        breaker.reset_registry()
        devguard.reset_stages()
        self.root = store_root(name)
        cfg = {"db": {"root": str(self.root)},
               "coordinator": {"listen_port": 0},
               "query": {"max_concurrent": 8, "max_queue": 64},
               "device": {"mem_budget": "70G", "breaker_failures": CONTROL_FAILURES,
                          "breaker_reset": "1s"}}
        cfg.update(extra)
        self.asm = assembly.run_node(json.dumps(cfg) + "\n", device=dev)
        self.acked = 0  # samples
        self.acked_requests = 0

    def call(self, path: str, body: bytes | None = None, method: str = "GET"):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{self.asm.port}{path}",
                                     data=body, method=method)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def health(self) -> dict:
        return json.loads(self.call("/health")[1])

    def faults(self, body: dict) -> None:
        st, out = self.call("/api/v1/debug/faults", json.dumps(body).encode(), "POST")
        assert st == 200, out

    def scrape(self, t_nanos: int, vals, requests: int | None = None) -> list:
        """One scrape of the CONTROL_SERIES gauges as JSON writes of
        CONTROL_BATCH samples (the first ``requests`` of them, if given);
        returns each request's status and body."""
        codes = []
        for lo in list(range(0, len(vals), CONTROL_BATCH))[:requests]:
            body = json.dumps([{"tags": {"__name__": "ctl", "i": str(i)},
                                "timestamp": t_nanos, "value": float(vals[i])}
                               for i in range(lo, min(lo + CONTROL_BATCH, len(vals)))])
            st, out = self.call("/api/v1/json/write", body.encode(), "POST")
            if st == 200:
                self.acked += json.loads(out)["written"]
                self.acked_requests += 1
            codes.append((st, out))
        return codes

    def close(self) -> None:
        self.asm.close()


def control_values(seed: int, k: int) -> np.ndarray:
    """Scrape k's integer-valued gauges (M3TSZ's int path: exact)."""
    return np.random.default_rng(seed * 1000 + k).integers(0, 10**6, CONTROL_SERIES) + 0.0


def breakers_on_a_node(seed: int, dev) -> dict:
    """(c): a node at config #2's 100,000 gauges; device.dispatch armed
    in error mode through the debug endpoint refuses (503) each write of
    one scrape, none acknowledged, and opens storage.buffer_append's
    breaker; disarmed, after breaker_reset, a write is acknowledged and
    closes it; after the flush every volume decodes on the card to
    exactly the acknowledged scrapes; /health's device.membudget equals
    the process's ledger."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.persist.fs import DataFileSetReader
    from m3_tpu_torch.x import membudget

    t0 = time.perf_counter()
    node = ControlNode("phase22-c", {"mediator": {"tick_interval": "1h"}}, dev)
    out = {"boot_s": time.perf_counter() - t0}
    try:
        for k in CONTROL_ACKED[:2]:
            assert all(st == 200 for st, _ in node.scrape(STORE_START + k * 10 * SEC,
                                                          control_values(seed, k)))
        node.faults({"arm": "device.dispatch=error"})
        refused = node.scrape(STORE_START + CONTROL_REFUSED * 10 * SEC,
                              control_values(seed, CONTROL_REFUSED), CONTROL_FAILURES)
        assert all(st == 503 and b"device oom at stage 'storage.buffer_append'" in body
                   for st, body in refused), refused[:1]
        doc = node.health()["device"]["stages"]["storage.buffer_append"]
        assert len(refused) == CONTROL_FAILURES and doc["breaker"] == "open", doc
        assert doc["errors"]["oom"] == CONTROL_FAILURES, doc
        node.faults({"disarm": ["device.dispatch"]})
        time.sleep(1.05)  # breaker_reset: the next append is the probe
        k = CONTROL_ACKED[2]
        assert all(st == 200 for st, _ in node.scrape(STORE_START + k * 10 * SEC,
                                                      control_values(seed, k)))
        health = node.health()
        assert health["device"]["stages"]["storage.buffer_append"]["breaker"] == "closed"
        assert health["device"]["membudget"] == membudget.snapshot()
        assert node.acked == CONTROL_SERIES * len(CONTROL_ACKED), node.acked
        out["refused_requests"] = len(refused)
        out["writes_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        with KernelCheck(mt, "place_words", encode_place.place_words_plain) as pcheck:
            node.asm.mediator.run_once(STORE_START + BLOCK + 10 * 60 * SEC + SEC)
        out["flush_s"] = time.perf_counter() - t1
        ids, segs = [], []
        for sh, bs, v in fileset_volumes(node.root):
            r = DataFileSetReader(node.root, "default", sh, bs, v)
            for sid, seg in r.read_all():
                ids.append(sid)
                segs.append(seg)
            r.close()
        with KernelCheck(mt, "extract_fields64_t",
                         decode_gather.extract_fields64_t_plain) as dcheck:
            d_ts, d_vals, counts, dfb = mt.decode_batch(segs, 8, device=dev)
        rows = np.asarray([int(sid[len(b"ctl{i="):-1]) for sid in ids])
        assert np.array_equal(np.sort(rows), np.arange(CONTROL_SERIES)), "volumes miss series"
        K = len(CONTROL_ACKED)
        assert not dfb.any() and (counts == K).all(), "refused samples in the volumes"
        want_t = STORE_START + np.asarray(CONTROL_ACKED, np.int64) * 10 * SEC
        assert (d_ts[:, :K] == want_t[None, :]).all()
        want_v = np.stack([control_values(seed, k) for k in CONTROL_ACKED], axis=1)[rows]
        assert np.array_equal(d_vals[:, :K].view(np.int64), want_v.view(np.int64))
        out.update(volumes=len(set((sh, bs, v) for sh, bs, v in fileset_volumes(node.root))),
                   samples_read_back=int(counts.sum()), place_calls=pcheck.calls,
                   extract_calls=dcheck.calls,
                   max_abs_err={"place_words": pcheck.err,
                                "extract_fields64_t": dcheck.err})
    finally:
        node.close()
    return out


def control_plane_on_a_node(seed: int, dev) -> dict:
    """(d) and (e): the node of (c) with selfmon and the controller on and
    a 1 s mediator tick, taking config #2 scrapes at wall-clock time:
    its self-monitoring series land in ``_m3_selfmon`` on the card and
    answer PromQL; a query.fetch latency fault past 1 s burns the query
    SLO and the controller sheds query_slots to its floor; disarmed, the
    slots go back to their baseline; /health serves ``slo`` and
    ``controller``; /debug/dump is a zip of the reference's members."""
    import io
    import threading
    import zipfile

    extra = {"mediator": {"tick_interval": "1s", "snapshot_every": 100000,
                          "cleanup_every": 100000},
             "selfmon": {"enabled": True, "default_rules": False, "rules": CONTROL_RULES,
                         "slo_deadline": "30s"},
             "controller": {"enabled": True, "min_action_interval": "0s",
                            "hold_ticks": 1}}
    t0 = time.perf_counter()
    node = ControlNode("phase22-d", extra, dev)
    out = {"boot_s": time.perf_counter() - t0}
    stop = threading.Event()
    queries = {"slow": 0, "fast": 0}

    def query_loop():
        while not stop.is_set():
            now = time.time()
            st, _ = node.call(f"/api/v1/query?query=ctl%7Bi%3D%227%22%7D&time={now}")
            assert st in (200, 503), st
            queries["slow" if time.time() - now > 1.0 else "fast"] += 1
            time.sleep(0.05)  # a dashboard's pace, not a flood

    def slots() -> float:
        return node.health()["controller"]["actuators"]["query_slots"]["value"]

    def wait_for(pred, what):
        end = time.monotonic() + CONTROL_WAIT_S
        while not pred():
            assert time.monotonic() < end, f"(d) waited {CONTROL_WAIT_S} s for {what}"
            time.sleep(0.5)

    threads = [threading.Thread(target=query_loop, daemon=True) for _ in range(2)]
    try:
        base = slots()
        t_scrape = (time.time_ns() // (10 * SEC)) * 10 * SEC
        assert all(st == 200 for st, _ in node.scrape(t_scrape, control_values(seed, 10)))
        node.faults({"arm": f"query.fetch=delay:ms={CONTROL_QUERY_DELAY_MS}"})
        for t in threads:
            t.start()
        t1 = time.perf_counter()
        wait_for(lambda: slots() == 2.0, "query_slots at its floor")
        out["shed_s"] = time.perf_counter() - t1
        assert all(st == 200 for st, _ in node.scrape(t_scrape + 10 * SEC,
                                                      control_values(seed, 11)))
        node.faults({"disarm": ["query.fetch"]})
        t1 = time.perf_counter()
        wait_for(lambda: slots() == base, "query_slots back at baseline")
        out["relax_s"] = time.perf_counter() - t1
        stop.set()
        for t in threads:
            t.join()
        health = node.health()
        ctl = health["controller"]
        acts = {(a["actuator"], a["action"]) for a in ctl["recent"]}
        assert {("query_slots", "shed"), ("query_slots", "relax")} <= acts, ctl["recent"]
        assert "device_fallback" not in ctl["actuators"]
        slo = health["slo"]
        assert "query-latency" in slo["rules"] and slo["selfmon"]["cycles"] > 0
        # the self-monitoring series on the card, through PromQL: the
        # stored count of write requests the HTTP front door took
        time.sleep(1.5)  # one more selfmon cycle after the last write
        q = (f"/api/v1/query?query=m3tpu_ingest_seconds_count&namespace=_m3_selfmon"
             f"&time={time.time()}")
        st, body = node.call(q)
        res = json.loads(body)["data"]["result"]
        assert st == 200 and res, body[:200]
        stored = float(res[0]["value"][1])
        assert stored == node.acked_requests == 2 * CONTROL_SERIES // CONTROL_BATCH, \
            (stored, node.acked_requests)
        assert node.acked == 2 * CONTROL_SERIES
        assert node.asm.db.namespaces["_m3_selfmon"].device.type == dev.type  # the card
        st, body = node.call("/debug/dump?seconds=0.2")
        members = zipfile.ZipFile(io.BytesIO(body)).namelist()
        assert st == 200 and members == DEBUG_MEMBERS, members
        out.update(baseline_slots=base, queries=dict(queries),
                   selfmon_cycles=slo["selfmon"]["cycles"],
                   controller_actions=ctl["actions_total"], debug_members=members)
    finally:
        stop.set()
        node.close()
    return out


def device_control_lane(seed: int, card: str) -> dict:
    """Phase 22, phase 23 (a) and phase 25 in a lane of their own (its
    caching allocator in expandable segments, which split every block to
    its request): (a) OOM, (b) budgets and footprints, then phase 22's
    main path with every launch counted — the f64 ingest stage at full
    width, (c) breakers on a node, (d)-(e) the control plane — and the
    wall of each part; then phase 23 (a) (``graphite_front_door``); then
    phase 25 (``measuring_tools_phase``).  Returns phase 22's parts'
    results, launches and each kernel's largest difference from its
    plain version, phase 23 (a)'s under ``front_door`` and phase 25's
    under ``measure``."""
    import torch

    torch.set_num_threads(1)
    lane_wait()
    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    out["a"] = oom_through_a_stage(dev)
    out["b_resident"] = resident_checks(dev)
    out["b_transient"] = transient_checks(seed, dev)
    out["ab_s"] = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    out["ingest"] = f64_ingest_path(seed, dev)
    out["c"] = breakers_on_a_node(seed, dev)
    out["d"] = control_plane_on_a_node(seed, dev)
    launches = read_launches()
    out["main_path_s"] = time.perf_counter() - t0
    err = dict(out["ingest"].pop("max_abs_err"))
    err.update(out["c"].pop("max_abs_err"))
    torch.cuda.empty_cache()
    front_door = front_door_part(graphite_front_door, seed, dev)
    log(f"phase23 (a) done in {front_door['part']['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    measure = measuring_tools_phase(seed, dev, card)
    log(f"phase25 done in {time.perf_counter() - t0:.1f} s")
    return {"parts": out, "launches": launches, "max_abs_err": err,
            "front_door": front_door, "measure": measure}


def device_control_records(kernels: list, got: dict, card: str) -> None:
    """Phase 22's result into the kernel records: ``device_launches`` (its
    main path's launches, each above 0) and its largest difference from
    the plain versions."""
    for k in kernels:
        name = k["name"]
        k["device_launches"] = got["launches"][name]
        k["max_abs_err"] = max(k["max_abs_err"], got["max_abs_err"].get(name, 0))
    assert all(k["device_launches"] > 0 for k in kernels), got["launches"]
    log(f"phase22 [{card}] launches on its path: {got['launches']}")
    log(f"phase22 [{card}] device boundary and control plane: " + json.dumps(got["parts"]))


def node_tier_lane(seed: int, card: str) -> dict:
    """Phases 18 and 19 in a lane of its own.  Phase 18's request builders
    start with the lane, so its bodies are built while the main process
    runs phases 1-11.  Returns each kernel's partial record: its launches
    on the node's and the tier's paths and its checks there."""
    import torch

    builders = node_builders(seed, PROMQL_GROUPS, PROMQL_BUCKETS)
    try:
        torch.set_num_threads(LANE_THREADS)
        lane_wait()
    except BaseException:
        builders[0].terminate()
        raise
    dev = torch.device("cuda")
    recs = [{"name": name, "max_abs_err": 0} for name in KERNEL_NAMES]
    t0 = time.perf_counter()
    _, node_launched, node_check, place_node = node_phase(
        seed, PROMQL_GROUPS, PROMQL_BUCKETS, dev, card, builders)
    log(f"phase18 done in {time.perf_counter() - t0:.1f} s")
    assert node_launched["place_words"] > 0 and node_check["extract_fields64_t"] > 0, \
        (node_launched, node_check)
    for k in recs:
        k["node_launches"] = node_launched[k["name"]]
        k["node_check_launches"] = node_check[k["name"]]
        if k["name"] == "place_words":  # also held at the node flush's shapes
            k["max_abs_err"] = max(k["max_abs_err"], place_node.pop("node_max_abs_err"))
            k.update(place_node)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tier_t, tier_launched, place_tier, ext_tier = aggregator_tier_phase(seed, dev, card)
    log(f"phase19 done in {time.perf_counter() - t0:.1f} s")
    for k in recs:
        k["tier_launches"] = tier_launched[k["name"]]
        rec = {"place_words": place_tier, "extract_fields64_t": ext_tier}.get(k["name"])
        if rec is not None:  # also held at the aggregator tier's shapes
            k["max_abs_err"] = max(k["max_abs_err"], rec.pop("tier_max_abs_err"))
            k.update(rec)
        if k["name"] == "place_words":  # and in the HOPS pipeline, every launch
            k["max_abs_err"] = max(k["max_abs_err"], tier_t["hops_place_max_abs_err"])
    return {"records": recs}


# ---- phase 23: query federation and the Graphite front door ---------------

GRAPHITE_DCS, GRAPHITE_HOSTS = 4, 250
GRAPHITE_METRICS = ("cpu_user", "cpu_total", "mem_used", "disk_io", "net_rx") + tuple(
    f"metric_{j:02d}" for j in range(95))  # 100 names: 100,000 paths, config #2's width
GRAPHITE_SCRAPES = 12  # of the block's 720 at 10 s (PERF.md §4)
GRAPHITE_READBACK_BATCH = 10  # host globs (100 paths each) a /render request
GRAPHITE_TARGETS = (
    "sumSeries(m3.dc0.*.cpu_user)",
    'groupByNode(m3.*.*.cpu_user, 1, "sum")',
    "aliasByNode(highestAverage(m3.dc1.*.mem_used, 10), 2)",
    "movingAverage(m3.dc2.host1*.disk_io, 3)",
    'summarize(m3.dc3.*.net_rx, "1min", "sum")',
    "asPercent(m3.dc0.host0.cpu_user, m3.dc0.host0.cpu_total)",
)
# graphite-web's spelling of groupByNode's callback: the reference takes
# the short names ("sum", "avg", "max", "min") and answers it 400
GRAPHITE_REFUSED = 'groupByNode(m3.*.*.cpu_user, 1, "sumSeries")'
GRAPHITE_FIND = "m3.dc0.*"
FED_QUERIES = ("rate(m3_req_bucket[5m])",
               "histogram_quantile(0.99, sum by (le, group) (rate(m3_req_bucket[5m])))")
FED_CHECK_GROUPS = 128  # groups of each node's half, card against CPU
FED_BREAKER_FAILURES = 3


class GraphiteTraffic:
    """Phase 23 (a)'s seeded carbon traffic: ``m3.dc{0..3}.host{0..249}.
    {metric}`` for 100 metric names, K scrapes at 10 s from a block
    boundary, values with two decimals."""

    def __init__(self, seed: int):
        self.hosts, self.K = GRAPHITE_HOSTS, GRAPHITE_SCRAPES
        self.paths = [f"m3.dc{d}.host{h}.{m}" for d in range(GRAPHITE_DCS)
                      for h in range(self.hosts) for m in GRAPHITE_METRICS]
        self.row = {p: i for i, p in enumerate(self.paths)}
        rng = np.random.default_rng(seed + 23)
        # + 0.0: a -0.0 line would come back +0.0 (M3TSZ's integer path)
        self.vals = np.round(rng.normal(50.0, 20.0, (len(self.paths), self.K)), 2) + 0.0
        self.ts = STORE_START + np.arange(self.K, dtype=np.int64) * 10 * SEC

    def lines(self, k: int, rows=None) -> bytes:
        """Scrape k as carbon plaintext (``path value seconds``)."""
        rows = range(len(self.paths)) if rows is None else rows
        t, col = int(self.ts[k] // SEC), self.vals[:, k].tolist()
        return "".join(f"{self.paths[i]} {col[i]!r} {t}\n" for i in rows).encode()

    def select(self, dc=None, host_prefix="", metric=None) -> list:
        """Paths matching each given component, sorted as the index
        returns them."""
        out = []
        for p in self.paths:
            _, d, h, m = p.split(".")
            if (dc is None or d == dc) and h.startswith(host_prefix) and (
                    metric is None or m == metric):
                out.append(p)
        return sorted(out)

    def window(self) -> str:
        t0 = int(STORE_START // SEC)
        return f"&from={t0}&until={t0 + self.K * 10}&step=10s"


def graphite_oracle(traffic: GraphiteTraffic) -> dict:
    """Each of GRAPHITE_TARGETS from the sent values with numpy: [(name,
    step seconds, values)], and the find's entries."""
    V = traffic.vals
    rows = lambda ps: V[[traffic.row[p] for p in ps]]  # noqa: E731
    out = {}
    ps = traffic.select(dc="dc0", metric="cpu_user")
    out[GRAPHITE_TARGETS[0]] = [(f"sumSeries({','.join(ps[:3])})", 10, rows(ps).sum(0))]
    out[GRAPHITE_TARGETS[1]] = [
        (f"dc{d}", 10, rows(traffic.select(dc=f"dc{d}", metric="cpu_user")).sum(0))
        for d in range(GRAPHITE_DCS)]
    ps = traffic.select(dc="dc1", metric="mem_used")
    mean = [float(V[traffic.row[p]].mean()) for p in ps]
    top = sorted(range(len(ps)), key=lambda i: -mean[i])[:10]
    out[GRAPHITE_TARGETS[2]] = [(ps[i].split(".")[2], 10, V[traffic.row[ps[i]]]) for i in top]
    out[GRAPHITE_TARGETS[3]] = []
    for p in traffic.select(dc="dc2", host_prefix="host1", metric="disk_io"):
        v = V[traffic.row[p]]
        out[GRAPHITE_TARGETS[3]].append((f"movingAverage({p},3)", 10, np.array(
            [v[max(0, i - 2):i + 1].mean() for i in range(len(v))])))
    out[GRAPHITE_TARGETS[4]] = []
    for p in traffic.select(dc="dc3", metric="net_rx"):
        v = V[traffic.row[p]]
        out[GRAPHITE_TARGETS[4]].append((f'summarize({p},"1min","sum")', 60, np.array(
            [v[b * 6:(b + 1) * 6].sum() for b in range(-(-len(v) // 6))])))
    a, b = (V[traffic.row[f"m3.dc0.host0.{m}"]] for m in ("cpu_user", "cpu_total"))
    out[GRAPHITE_TARGETS[5]] = [
        ("asPercent(m3.dc0.host0.cpu_user,m3.dc0.host0.cpu_total)", 10, 100.0 * a / b)]
    out["find"] = [{"text": h, "id": f"m3.dc0.{h}", "leaf": 0, "expandable": 1}
                   for h in sorted(f"host{i}" for i in range(traffic.hosts))]
    return out


def graphite_rows(traffic: GraphiteTraffic) -> list:
    """The rows the targets and the find read: what phase 23's CPU node
    takes."""
    ps = set(traffic.select(metric="cpu_user"))
    ps |= set(traffic.select(dc="dc1", metric="mem_used"))
    ps |= set(traffic.select(dc="dc2", host_prefix="host1", metric="disk_io"))
    ps |= set(traffic.select(dc="dc3", metric="net_rx"))
    ps.add("m3.dc0.host0.cpu_total")
    return sorted(traffic.row[p] for p in ps)


def graphite_same(doc: list, want: list, start_s: int) -> float:
    """A /render answer against the oracle's series: the same names and
    times, values within rtol 1e-12 (none missing).  Returns the largest
    relative difference."""
    assert [s["target"] for s in doc] == [w[0] for w in want], \
        ([s["target"] for s in doc][:3], [w[0] for w in want][:3])
    worst = 0.0
    for s, (name, step_s, vals) in zip(doc, want):
        assert [t for _, t in s["datapoints"]] == [start_s + i * step_s
                                                  for i in range(len(vals))], name
        got = np.array([np.nan if v is None else v for v, _ in s["datapoints"]])
        assert not np.isnan(got).any(), name
        assert np.allclose(got, vals, rtol=1e-12, atol=0), (name, got[:3], vals[:3])
        worst = max(worst, rel_err(got, np.asarray(vals, np.float64)))
    return worst


class CarbonNode:
    """A port node with ``coordinator.carbon_listen_port`` (and, for (b),
    the query listener or remotes), its carbon sender and HTTP client."""

    def __init__(self, name: str, dev, query: dict | None = None,
                 root: Path | None = None):
        from m3_tpu_torch.server import assembly

        self.root = root or store_root(name)
        cfg = {"db": {"root": str(self.root)},
               "coordinator": {"listen_port": 0, "carbon_listen_port": 0},
               "mediator": {"tick_interval": "24h"}}
        if query:
            cfg["query"] = query
        self.asm = assembly.run_node(json.dumps(cfg) + "\n", device=dev)
        self.http = NodeClient(self.asm.port)

    def send(self, payload: bytes) -> None:
        import socket

        with socket.create_connection(("127.0.0.1", self.asm.carbon_port)) as s:
            s.sendall(payload)

    def samples(self) -> int:
        return int(self.asm.registry.snapshot().get(
            f"{self.asm.config.metrics_prefix}.carbon.samples", 0))

    def render(self, targets, window: str):
        from urllib.parse import quote

        path = "/render?" + "&".join(f"target={quote(t)}" for t in targets) + window
        return self.http.call(path)

    def close(self) -> None:
        self.asm.close()


def carbon_ingest(node: CarbonNode, traffic: GraphiteTraffic, rows=None) -> dict:
    """Every scrape sent over one TCP connection each, then waited for
    until the listener has handed every line to the node; returns the
    seconds of the first scrape (100,000 new series) and of the rest."""
    n = len(traffic.paths) if rows is None else len(rows)
    base = node.samples()
    out = {}
    t0 = time.perf_counter()
    for k in range(traffic.K):
        node.send(traffic.lines(k, rows))
        if k == 0:
            wait_for(lambda: node.samples() >= base + n, "carbon scrape 0", 600)
            out["first_scrape_s"] = time.perf_counter() - t0
    wait_for(lambda: node.samples() >= base + n * traffic.K, "carbon scrapes", 1200)
    out["all_s"] = time.perf_counter() - t0
    assert node.samples() == base + n * traffic.K
    assert node_counter(node.asm, "carbon_malformed") == 0
    out["lines_per_s"] = n * traffic.K / out["all_s"]
    return out


def graphite_renders(node: CarbonNode, traffic: GraphiteTraffic, want: dict) -> tuple:
    """GRAPHITE_TARGETS, the refused spelling and the find through the
    node's HTTP front door, each held against the oracle; returns (the
    bodies, each render's wall and the share of it in
    ``GraphiteStorage.fetch``)."""
    from m3_tpu_torch.query import graphite

    start_s = int(STORE_START // SEC)
    bodies, times = [], {}
    for t in GRAPHITE_TARGETS:
        clock = HostClock()
        clock.wrap(graphite.GraphiteStorage, "fetch", "fetch")
        try:
            t0 = time.perf_counter()
            st, _, body = node.render([t], traffic.window())
            wall = time.perf_counter() - t0
        finally:
            clock.restore()
        assert st == 200, (t, st, body[:300])
        worst = graphite_same(json.loads(body), want[t], start_s)
        times[t] = {"wall_ms": wall * 1e3, "fetch_share": clock.s["fetch"] / wall,
                    "series_out": len(want[t]), "max_rel_err": worst}
        bodies.append(body)
    st, _, body = node.render([GRAPHITE_REFUSED], traffic.window())
    assert st == 400 and b"sumSeries" in body, (st, body)
    bodies.append(body)
    st, _, body = node.http.call(f"/metrics/find?query={GRAPHITE_FIND}")
    assert st == 200 and json.loads(body) == want["find"], body[:300]
    bodies.append(body)
    return bodies, times


def graphite_readback(node: CarbonNode, traffic: GraphiteTraffic) -> dict:
    """Every path sent read back through /render (the glob of its host,
    GRAPHITE_READBACK_BATCH globs a request), under its own name and
    equal to the values sent, bit for bit."""
    globs = [f"m3.dc{d}.host{h}.*" for d in range(GRAPHITE_DCS) for h in range(traffic.hosts)]
    start_s = int(STORE_START // SEC)
    times = [start_s + 10 * k for k in range(traffic.K)]
    seen = np.zeros(len(traffic.paths), bool)
    t0 = time.perf_counter()
    for lo in range(0, len(globs), GRAPHITE_READBACK_BATCH):
        st, _, body = node.render(globs[lo:lo + GRAPHITE_READBACK_BATCH], traffic.window())
        assert st == 200, (st, body[:300])
        for s in json.loads(body):
            i = traffic.row[s["target"]]
            assert not seen[i], s["target"]
            seen[i] = True
            assert [t for _, t in s["datapoints"]] == times, s["target"]
            got = np.array([v for v, _ in s["datapoints"]], np.float64)
            assert np.array_equal(got.view(np.int64), traffic.vals[i].view(np.int64)), \
                s["target"]
    assert seen.all(), int((~seen).sum())
    wall = time.perf_counter() - t0
    return {"paths": int(seen.sum()), "requests": -(-len(globs) // GRAPHITE_READBACK_BATCH),
            "wall_s": wall, "paths_per_s": int(seen.sum()) / wall}


def graphite_volumes(node: CarbonNode, traffic: GraphiteTraffic, dev) -> dict:
    """Every volume of the node decoded on the card (``decode_batch``,
    kernel #2) equal to the scrapes sent, bit for bit, each path once."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.persist.fs import DataFileSetReader

    ids, segs = [], []
    for sh, bs, v in fileset_volumes(node.root):
        r = DataFileSetReader(node.root, "default", sh, bs, v)
        for sid, seg in r.read_all():
            ids.append(sid)
            segs.append(seg)
        r.close()
    rows = np.asarray([traffic.row[sid.decode()] for sid in ids])
    assert np.array_equal(np.sort(rows), np.arange(len(traffic.paths))), "volumes miss paths"
    d_ts, d_vals, counts, dfb = mt.decode_batch(segs, traffic.K, device=dev)
    assert not dfb.any() and (counts == traffic.K).all()
    assert (d_ts == traffic.ts[None, :]).all()
    assert np.array_equal(d_vals.view(np.int64), traffic.vals[rows].view(np.int64))
    return {"series": len(ids), "points": int(counts.sum())}


def graphite_front_door(seed: int, dev) -> dict:
    """Phase 23 (a): see the module docstring."""
    import torch

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place

    traffic = GraphiteTraffic(seed)
    want = graphite_oracle(traffic)
    out: dict = {"paths": len(traffic.paths), "scrapes": traffic.K}
    check_rows = graphite_rows(traffic)
    node = CarbonNode("phase23-a", dev)
    cpu = CarbonNode("phase23-a-cpu", "cpu")
    try:
        out["ingest"] = carbon_ingest(node, traffic)
        log(f"phase23 (a) carbon: {len(traffic.paths) * traffic.K:,} lines in "
            f"{out['ingest']['all_s']:.1f} s ({out['ingest']['lines_per_s']:,.0f} lines/s; "
            f"first scrape {out['ingest']['first_scrape_s']:.1f} s)")
        carbon_ingest(cpu, traffic, check_rows)
        before, out["renders_buffer"] = graphite_renders(node, traffic, want)
        cpu_before, _ = graphite_renders(cpu, traffic, want)
        assert before == cpu_before, "card renders != CPU renders (buffers)"
        out["readback"] = graphite_readback(node, traffic)
        now = STORE_START + BLOCK + 10 * 60 * SEC + SEC
        t0 = time.perf_counter()
        with KernelCheck(mt, "place_words", encode_place.place_words_plain) as pcheck:
            st = node.asm.mediator.run_once(now)
        torch.cuda.synchronize()
        out["flush_s"] = time.perf_counter() - t0
        assert st["tick"]["default"]["warm_flushed"] > 0, st
        cpu.asm.mediator.run_once(now)
        with KernelCheck(mt, "extract_fields64_t",
                         decode_gather.extract_fields64_t_plain) as dcheck:
            out["volumes"] = graphite_volumes(node, traffic, dev)
        after, out["renders_fileset"] = graphite_renders(node, traffic, want)
        cpu_after, _ = graphite_renders(cpu, traffic, want)
        assert after == cpu_after, "card renders != CPU renders (filesets)"
        assert after == before, "renders changed across the flush"
        out.update(place_calls=pcheck.calls, extract_calls=dcheck.calls,
                   cpu_paths=len(check_rows),
                   max_abs_err={"place_words": pcheck.err,
                                "extract_fields64_t": dcheck.err})
        assert pcheck.calls > 0 and dcheck.calls > 0
    finally:
        node.close()
        cpu.close()
    return out


def fed_docs(rows, ubs):
    """Config #5's documents for the given rows (group i // B, le i % B)."""
    from m3_tpu_torch.index.doc import Document

    B = len(ubs)
    return [Document.from_tags(b"m3_req_bucket{group=g%06d,le=%s}" % (i // B, ubs[i % B]),
                               {b"__name__": b"m3_req_bucket", b"group": b"g%06d" % (i // B),
                                b"le": ubs[i % B]}) for i in rows]


def fed_write(asm, rows, ts, vals, ubs) -> float:
    """NODE_SCRAPES scrapes of ``rows`` through ``write_tagged_batch``;
    returns the seconds."""
    docs = fed_docs(rows, ubs)
    t0 = time.perf_counter()
    for k in range(NODE_SCRAPES):
        asm.db.write_tagged_batch("default", docs, ts[rows, k], vals[rows, k])
    return time.perf_counter() - t0


def fed_answer(doc) -> dict:
    """A query_range answer: {(group, le): {step seconds: value}}."""
    assert doc["status"] == "success" and doc["data"]["resultType"] == "matrix", doc
    return {(r["metric"].get("group"), r["metric"].get("le")):
            {float(t): float(v) for t, v in r["values"]} for r in doc["data"]["result"]}


def fed_same(a: dict, b: dict, rtol: float = 1e-12) -> float:
    """Two answers over the same series and steps, NaN in the same places,
    values within rtol; returns the largest relative difference."""
    assert a.keys() == b.keys() and a, (len(a), len(b))
    worst = 0.0
    for key, row in a.items():
        assert row.keys() == b[key].keys(), key
        x = np.array(list(row.values()))
        y = np.array([b[key][t] for t in row])
        assert np.array_equal(np.isnan(x), np.isnan(y)), key
        worst = max(worst, rel_err(x, y))
    assert worst <= rtol, worst
    return worst


def federation(seed: int, dev) -> dict:
    """Phase 23 (b): see the module docstring."""
    from m3_tpu_torch.server import http_api

    ts, vals, ubs = promql_corpus(seed, PROMQL_GROUPS, PROMQL_BUCKETS)
    S, B = ts.shape[0], len(ubs)
    half = S // 2
    q_end = int(ts[0, NODE_SCRAPES - 1])
    paths = [node_query_path(q, q_end - 60 * SEC, q_end) for q in FED_QUERIES]
    out: dict = {"series": S}
    made = []

    def node(name, d, query=None, root=None):
        made.append(CarbonNode(name, d, query, root))
        return made[-1]

    try:
        a = node("phase23-b-a", dev, {"listen_port": 0})
        a_port = a.asm.query_port
        b = node("phase23-b-b", dev, {
            "remotes": [f"127.0.0.1:{a_port}"],
            "breaker_failures": FED_BREAKER_FAILURES, "breaker_reset": "300s"})
        one = node("phase23-b-one", dev)
        out["write_s"] = {"a": fed_write(a.asm, np.arange(half), ts, vals, ubs),
                          "b": fed_write(b.asm, np.arange(half, S), ts, vals, ubs),
                          "one": fed_write(one.asm, np.arange(S), ts, vals, ubs)}
        clock = HostClock()
        clock.wrap(b.asm.remote_stores[0], "fetch_raw", "remote_fetch")
        answers, out["queries"] = [], {}
        try:
            for q, path in zip(FED_QUERIES, paths):
                clock.s.clear()
                t0 = time.perf_counter()
                got = fed_answer(b.http.json(path))
                wall = time.perf_counter() - t0
                ref = fed_answer(one.http.json(path))
                out["queries"][q] = {"wall_ms": wall * 1e3,
                                     "remote_fetch_share": clock.s["remote_fetch"] / wall,
                                     "series_out": len(got),
                                     "max_rel_err_vs_one_node": fed_same(got, ref)}
                answers.append(got)
        finally:
            clock.restore()
        log(f"phase23 (b) federated answers == one node of {S:,} series: "
            + json.dumps(out["queries"]))

        # the same run on the CPU, on FED_CHECK_GROUPS groups of each half
        g = np.arange(FED_CHECK_GROUPS)
        rows_a = (g[:, None] * B + np.arange(B)).ravel()
        rows_b = rows_a + half
        ca = node("phase23-b-cpu-a", "cpu", {"listen_port": 0})
        cb = node("phase23-b-cpu-b", "cpu", {"remotes": [f"127.0.0.1:{ca.asm.query_port}"]})
        fed_write(ca.asm, rows_a, ts, vals, ubs)
        fed_write(cb.asm, rows_b, ts, vals, ubs)
        out["card_vs_cpu"] = {}
        for q, path, got in zip(FED_QUERIES, paths, answers):
            cpu_got = fed_answer(cb.http.json(path))
            card = {k: got[k] for k in cpu_got}
            out["card_vs_cpu"][q] = {
                "series": len(cpu_got), "max_rel_err": fed_same(card, cpu_got),
                "bit_equal": all(np.array_equal(np.array(list(card[k].values())).view(
                    np.int64), np.array(list(v.values())).view(np.int64))
                    for k, v in cpu_got.items())}

        # A's query server stops; B's connections to it drop
        stop(a.asm.query_server)
        a.asm.query_server = None
        b.asm.remote_stores[0]._pool.close()
        hq = paths[1]
        doc = b.http.json(hq)
        assert doc.get("warnings") and "skipped" in doc["warnings"][0], doc.get("warnings")
        own = fed_answer(doc)
        ref = {k: v for k, v in answers[1].items() if int(k[0][1:]) >= PROMQL_GROUPS // 2}
        out["best_effort"] = {"groups": len(own), "max_rel_err": fed_same(own, ref),
                              "warning": doc["warnings"][0]}
        ctx = http_api.ApiContext(b.asm.db, remotes=b.asm.remote_stores,
                                  remotes_required=True)
        srv = http_api.serve_background(ctx)
        # one of B's groups: the local half of each failing query is cheap
        one_group = node_query_path(
            f'rate(m3_req_bucket{{group="g{PROMQL_GROUPS - 1:06d}"}}[5m])',
            q_end - 60 * SEC, q_end)
        try:
            req = NodeClient(srv.server_address[1])
            br = b.asm.remote_stores[0].breaker
            walls = []
            while True:
                t0 = time.perf_counter()
                st, _, body = req.call(one_group)
                walls.append((time.perf_counter() - t0) * 1e3)
                assert st == 502, (st, body[:300])
                if br.state == "open" or len(walls) > FED_BREAKER_FAILURES + 1:
                    break
            assert br.state == "open" and len(walls) == FED_BREAKER_FAILURES - 1, \
                (br.state, len(walls))  # the best-effort query counted one failure
            t0 = time.perf_counter()
            st, _, body = req.call(one_group)
            walls.append((time.perf_counter() - t0) * 1e3)
            assert st == 502 and b"circuit breaker open" in body, (st, body[:300])
        finally:
            stop(srv)
        breakers = b.http.json("/health")["query"]["breakers"]
        assert breakers[f"query:127.0.0.1:{a_port}"] == "open", breakers
        out["required"] = {"status": 502, "walls_ms": walls, "breaker": br.state,
                           "error": json.loads(body)["error"][:200],
                           "health_breakers": breakers}
    finally:
        for n in made:
            n.close()
    return out


def front_door_part(part, seed: int, dev) -> dict:
    """One part of phase 23 with every kernel's launches counted from 0
    over it: its result, its launches and each kernel's largest
    difference from its plain version."""
    from m3_tpu_torch.x import breaker, devguard

    # a node's process-global breakers and stage counters start fresh
    breaker.reset_registry()
    devguard.reset_stages()
    zero_launches()
    t0 = time.perf_counter()
    out = part(seed, dev)
    out["wall_s"] = time.perf_counter() - t0
    return {"part": out, "launches": read_launches(),
            "max_abs_err": out.pop("max_abs_err", {})}


def federation_lane(seed: int, card: str, done23b=None) -> dict:
    """Phase 23 (b) in a lane of its own (``front_door_part(federation)``),
    then phase 24 (``instruments_phase``) with every kernel's launches
    counted from 0 over its path.  ``done23b`` (an event) is set once
    phase 23 (b) has passed: its remote fetches time out at 30 s, so
    phase 27's host-heavy parts start only then."""
    import torch

    torch.set_num_threads(LANE_THREADS)
    lane_wait()
    dev = torch.device("cuda")
    fed = front_door_part(federation, seed, dev)
    if done23b is not None:
        done23b.set()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    inst = instruments_phase(seed, dev, card)
    inst["parts"]["wall_s"] = time.perf_counter() - t0
    log(f"phase24 done in {inst['parts']['wall_s']:.1f} s")
    return {"federation": fed, "instruments": inst}


def front_door_records(kernels: list, a: dict, b: dict, card: str) -> None:
    """Phase 23's parts into the kernel records: ``graphite_launches``
    (its path's launches, (a)'s and (b)'s: kernel #1 in (a)'s flush, #2
    in its volume check, each above 0) and its largest difference from
    the plain versions."""
    for k in kernels:
        name = k["name"]
        k["graphite_launches"] = a["launches"][name] + b["launches"][name]
        k["max_abs_err"] = max(k["max_abs_err"], a["max_abs_err"].get(name, 0),
                               b["max_abs_err"].get(name, 0))
    launches = {k["name"]: k["graphite_launches"] for k in kernels}
    assert launches["place_words"] > 0 and launches["extract_fields64_t"] > 0, launches
    log(f"phase23 [{card}] launches on its path: {launches}")
    log(f"phase23 [{card}] query federation and the Graphite front door: "
        + json.dumps({"a": a["part"], "b": b["part"]}))


# ---- phase 24: the runtime instruments and the proto value codec -----------

HOPS_WIDE_SERIES = 1_000_000  # BASELINE config #3's width
HOPS_WIDE_SECONDS = 10  # of the corpus's 320: one drained 10 s window (PERF.md §4)
PROTO_SERIES, PROTO_POINTS = 100_000, 720  # config #2's width
PROTO_CHECK_EVERY = 100  # every 100th series through the scalar decoder
PROTO_MESSAGE = "m3test.VehicleUpdate"
# a serialized FileDescriptorSet of one proto3 file (a position message
# nested in a vehicle update), fixed here so that no protobuf package is
# needed; tests/test_torch_proto.py rebuilds it with protobuf
PROTO_FDS = base64.b64decode(
    "Cs8BCg90ZWxlbWV0cnkucHJvdG8SBm0zdGVzdCIvCghQb3NpdGlvbhIQCghsYXRpdHVkZRgB"
    "IAEoARIRCglsb25naXR1ZGUYAiABKAEiewoNVmVoaWNsZVVwZGF0ZRIUCgxmdWVsX3BlcmNl"
    "bnQYASABKAESEAoIb2RvbWV0ZXIYAiABKAMSDgoGc3RhdHVzGAMgASgJEg4KBm1vdmluZxgE"
    "IAEoCBIiCghwb3NpdGlvbhgFIAEoCzIQLm0zdGVzdC5Qb3NpdGlvbmIGcHJvdG8z")
# the hand kernels' __global__ functions, by the wrappers' kernel names
HAND_KERNELS = {"place_words_kernel": "place_words", "extract_fields_kernel": "extract_fields",
                "count_kernel": "segment_ingest", "apply_unique": "segment_ingest",
                "scan_tiles": "segment_ingest", "compact_collided": "segment_ingest",
                "apply_collided": "segment_ingest", "segment_minmax_kernel": "segment_minmax"}


def trace_of(fn) -> tuple:
    """``fn()`` under torch.profiler (CPU and CUDA): (its result, the
    trace's complete events, the seconds of the profiled run, the
    trace's export and its parse)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    trace = ROOT / "build" / f"ledger_trace.{os.getpid()}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof.export_chrome_trace(str(trace))
    t2 = time.perf_counter()
    try:
        with open(trace) as fh:
            events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    finally:
        trace.unlink()
    return out, events, {"profiled": t1 - t0, "export": t2 - t1,
                         "parse": time.perf_counter() - t2}


def _ext_id(e):
    a = e.get("args", {})
    return a.get("External id", a.get("external id"))


def trace_vs_ledger(events, stats: dict, seams: dict) -> dict:
    """Hold a pass's ``x/hopwatch`` ledger against its profiler trace:
    (1) the trace's HtoD and DtoH memcpys, in count and bytes, equal the
    ledger's transfers; (2) every kernel in the trace belongs to a counted
    dispatch — the outermost op of its launching op's stack that the
    ledger counts, each counted op instance at most once per counted
    dispatch of its name — or is a hand kernel, as many as the ledger's
    grids.  Returns the figures and ``problems`` (empty when they agree),
    each naming its seam."""
    led: dict = {}
    for rows in seams.values():
        for key, (n, nb) in rows.items():
            c = led.setdefault(key, [0, 0])
            c[0] += n
            c[1] += nb
    counted = {k.split(":", 1)[1] for k in led if k.startswith("dispatch:aten")}
    transfer_ops = {k.split(":", 1)[1] for k in led if k[:4] in ("h2d:", "d2h:")}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    parent: dict = {}
    by_tid: dict = {}
    for i, e in enumerate(ops):
        by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(i)
    for idx in by_tid.values():
        stack: list = []
        for i in sorted(idx, key=lambda j: (float(ops[j]["ts"]), -float(ops[j]["dur"]))):
            t = float(ops[i]["ts"])
            while stack and float(ops[stack[-1]]["ts"]) + float(ops[stack[-1]]["dur"]) <= t:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)
    by_ext = {_ext_id(e): i for i, e in enumerate(ops) if _ext_id(e) is not None}
    runtime_ext = {e["args"].get("correlation"): _ext_id(e) for e in events
                   if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}

    def chain(e) -> list:
        ext = _ext_id(e)
        if ext is None or ext not in by_ext:
            ext = runtime_ext.get(e.get("args", {}).get("correlation"))
        i = by_ext.get(ext)
        out = []
        while i is not None:
            out.append(i)
            i = parent.get(i)
        return out[::-1]  # outermost first

    problems = []
    # (1) memcpys against the ledger's transfers
    trace_x = {"h2d": [0, 0], "d2h": [0, 0]}
    trace_by_op: dict = {}
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        kind = "h2d" if "HtoD" in e["name"] else "d2h" if "DtoH" in e["name"] else None
        if kind is None:
            continue
        nb = int(e.get("args", {}).get("bytes", 0))
        trace_x[kind][0] += 1
        trace_x[kind][1] += nb
        names = [ops[i]["name"] for i in chain(e)]
        op = next((n for n in names if n in transfer_ops), names[0] if names else "(no op)")
        row = trace_by_op.setdefault(f"{kind}:{op}", [0, 0])
        row[0] += 1
        row[1] += nb
    tot = {"h2d": [sum(s["h2d_count"] for s in stats.values()),
                   sum(s["h2d_bytes"] for s in stats.values())],
           "d2h": [sum(s["d2h_count"] for s in stats.values()),
                   sum(s["d2h_bytes"] for s in stats.values())]}
    for kind in ("h2d", "d2h"):
        if trace_x[kind] != tot[kind]:
            problems.append(
                f"{kind}: trace {trace_x[kind]} (count, bytes) != ledger {tot[kind]}; by seam, "
                f"trace {json.dumps({k: v for k, v in trace_by_op.items() if k.startswith(kind)})}"
                f" ledger {json.dumps({k: v for k, v in led.items() if k.startswith(kind)})}")
    # (2) kernels against the counted dispatches
    instances: dict = {}
    hand: dict = {}
    n_kernels = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        n_kernels += 1
        names = chain(e)
        owner = next((i for i in names if ops[i]["name"] in counted), None)
        if owner is not None:
            instances.setdefault(ops[owner]["name"], set()).add(owner)
            continue
        fn = next((k for g, k in HAND_KERNELS.items() if g in e["name"]), None)
        if fn is None or names:
            problems.append(f"kernel {e['name'][:120]!r} under "
                            f"{[ops[i]['name'] for i in names]} belongs to no counted dispatch")
            continue
        hand[fn] = hand.get(fn, 0) + 1
    for name, inst in sorted(instances.items()):
        if len(inst) > led[f"dispatch:{name}"][0]:
            problems.append(f"{name}: {len(inst)} launching instances in the trace, "
                            f"{led[f'dispatch:{name}'][0]} counted")
    for fn, n in sorted(hand.items()):
        if n != led.get(f"dispatch:kernel:{fn}", [0])[0]:
            problems.append(f"hand kernel {fn}: {n} in the trace, "
                            f"{led.get(f'dispatch:kernel:{fn}', [0])[0]} counted")
    return {"trace_memcpy": trace_x, "ledger_transfers": tot, "trace_kernels": n_kernels,
            "kernel_ops": {k: len(v) for k, v in sorted(instances.items())},
            "hand_kernels": hand, "problems": problems}


class InputRecord:
    """Within ``with``, every call of ``owner.attr`` (a kernel wrapper as
    its caller looks it up) runs as before, and its inputs are kept with
    whether ``x/hopwatch`` was installed and the launches it made;
    nothing else runs, so a pass under ``x/hopwatch`` counts only its own
    ops.  ``check`` then launches the kernel again on each kept call's
    inputs and holds it against ``plain`` on them (the caller writes into
    the output it was handed, so the output is not kept)."""

    def __init__(self, owner, attr: str, plain):
        self.owner, self.attr, self.plain = owner, attr, plain
        self.calls: list = []  # (inputs, counted, launches)

    def __enter__(self):
        from m3_tpu_torch.x import hopwatch

        fn = self.fn = getattr(self.owner, self.attr)

        def kept(*a):
            n = sum(read_launches().values())
            out = fn(*a)
            self.calls.append((a, hopwatch.installed(), sum(read_launches().values()) - n))
            return out

        setattr(self.owner, self.attr, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)
        return False

    def launches(self, counted: bool) -> int:
        return sum(n for _, c, n in self.calls if c == counted)

    def check(self) -> int:
        """Largest bit difference over the kept calls; raises unless 0."""
        import torch

        err = 0
        for a, _, _ in self.calls:
            out, want = self.fn(*a), self.plain(*a)
            err = max(err, int((out ^ want).abs().max()) if out.numel() else 0)
            assert torch.equal(out, want), f"{self.attr} kernel != plain on the path's inputs"
        self.calls.clear()
        return err


def kernel_grids(seams: dict) -> dict:
    """hop -> hand kernel -> grids, from a ledger by seam."""
    from m3_tpu_torch.x import optext

    return {h: optext.kernel_census(rows) for h, rows in seams.items()}


def hops_ledger(S: int, T: int, dev, card: str, tag: str, profile: bool) -> dict:
    """(a) for one corpus: ``tools/hops.run_pipeline`` on the card (cold
    ledger, uncounted walls, steady ledger; three volumes, sha256-equal,
    the pinned corpus's equal to the JAX digest; no build) with the
    launches counted from 0: kernel #1's grids in the encode hops of the
    two ledgers equal the launches its calls made while ``x/hopwatch``
    was installed, all its calls together ``encode_place.launches``, no
    other hop launches a hand kernel, and kernel #1 launched again on
    each call's inputs equals its plain version.  Where ``profile``, one
    more steady pass under ``x/hopwatch`` runs under torch.profiler,
    launches counted from 0 again: the same checks, and the ledger equals
    the trace (``trace_vs_ledger``)."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import encode_place
    from m3_tpu_torch.tools import hops
    from m3_tpu_torch.x import tracewatch

    def held(rec, ledgers: list, launched: dict) -> int:
        grids = [kernel_grids(sm) for sm in ledgers]
        enc = sum(g.get("encode", {}).get("place_words", 0) for g in grids)
        assert enc == rec.launches(True) > 0, (enc, rec.calls)
        assert rec.launches(True) + rec.launches(False) == launched["place_words"] \
            == sum(launched.values()), launched
        others = [(h, k) for g in grids for h, ks in g.items() for k in ks
                  if (h, k) != ("encode", "place_words")]
        assert not others, others
        return enc

    snap = tracewatch.snapshot()
    zero_launches()
    t0 = time.perf_counter()
    with InputRecord(mt, "place_words", encode_place.place_words_plain) as rec:
        doc = hops.run_pipeline(S, T, root=str(store_root(f"phase24-{tag}")), device=dev)
    run_s = time.perf_counter() - t0
    launched = read_launches()
    counted = held(rec, [doc["seams"]["cold"], doc["seams"]["steady"]], launched)
    err = rec.check()
    assert tracewatch.retraces_since(snap) == 0, tracewatch.compile_signatures()
    digests = {doc["volume_sha256"], doc["cold_volume_sha256"], doc["ledger_volume_sha256"]}
    assert len(digests) == 1, doc
    if (S, T) == (hops.S_DEFAULT, hops.T_DEFAULT):
        assert doc["volume_sha256"] == HOPS_PINNED_SHA256, doc["volume_sha256"]
    assert doc["pipeline"]["compiles_cold"] == doc["pipeline"]["compiles_steady"] == 0
    out = {"S": S, "T": T, "run_s": run_s, "hops": doc["hops"], "pipeline": doc["pipeline"],
           "seams": doc["seams"], "launches": launched, "place_max_abs_err": err,
           "kernel_grids": kernel_grids(doc["seams"]["steady"])}
    for h, v in doc["hops"].items():
        log(f"phase24 (a) [{card}] {tag} {h}: steady wall {v['steady_wall_s']:.3f} s "
            f"(uncounted pass), share {v['host_time_fraction']:.4f}; steady ledger "
            f"{json.dumps(v['steady'])}; cold ledger {json.dumps(v['cold'])}")
    log(f"phase24 (a) [{card}] {tag} steady ledger by seam: {json.dumps(doc['seams']['steady'])}")
    log(f"phase24 (a) [{card}] {tag} pipeline: {json.dumps(doc['pipeline'])}; kernel #1 "
        f"{launched['place_words']} launches ({counted} counted), all in the encode "
        f"hops, == plain")
    if not profile:
        return out
    frames, policy, opts = hops.pipeline_inputs(S, T)
    root = store_root(f"phase24-{tag}-traced")
    snap = tracewatch.snapshot()
    zero_launches()
    t0 = time.perf_counter()
    with InputRecord(mt, "place_words", encode_place.place_words_plain) as rec:
        (stats, seams, _), events, split = trace_of(
            lambda: hops.ledger_pass(frames, policy, opts, root, dev))
    traced = read_launches()
    held(rec, [seams], traced)
    out["place_max_abs_err"] = max(err, rec.check())
    assert tracewatch.retraces_since(snap) == 0, tracewatch.compile_signatures()
    assert hops.volume_digest(root) == doc["volume_sha256"]
    t1 = time.perf_counter()
    got = trace_vs_ledger(events, stats, seams)
    del events
    out.update(traced_pass_s=t1 - t0, trace_split_s=split, trace_check_s=time.perf_counter() - t1,
               traced_ledger=stats, traced_launches=traced, trace_check=got)
    for k, v in traced.items():
        out["launches"][k] += v
    assert not got["problems"], "ledger != trace:\n" + "\n".join(got["problems"])
    log(f"phase24 (a) {tag}: the ledger == the trace: memcpys {got['trace_memcpy']}, "
        f"{got['trace_kernels']} kernels, each under a counted dispatch or a hand kernel "
        f"({got['hand_kernels']})")
    return out


def seam_catalogue(dev):
    """Every seam of ``x/devseams`` once on the card, each in a hop of its
    own: (name, callable) pairs.  Tensors are made here, outside any
    counted region."""
    import torch

    x = torch.arange(8, dtype=torch.int64, device=dev)
    y = torch.arange(8, 0, -1, dtype=torch.int64, device=dev)
    xf = torch.arange(8, dtype=torch.float32, device=dev)
    r = torch.tensor([1, 2, 3], device=dev)
    host = torch.zeros(8, dtype=torch.int64)
    arr = np.arange(8, dtype=np.int64)
    arr32 = np.arange(8, dtype=np.float32)
    mask = x > 3
    return [
        (".cpu()", lambda: x.cpu()),
        (".to(cpu, float64)", lambda: xf.to("cpu", torch.float64)),
        (".to(card, float32) of float64", lambda: torch.arange(8.0, dtype=torch.float64).to(
            dev, torch.float32)),
        (".item()", lambda: x[3].item()),
        ("bool()", lambda: bool(x[3])),
        (".tolist()", lambda: x.tolist()),
        ("copy_ to the host", lambda: torch.zeros(8, dtype=torch.int64).copy_(x)),
        ("copy_ to the card", lambda: x.clone().copy_(host)),
        ("copy_ to the card, broadcast", lambda: torch.zeros(
            (4, 8), dtype=torch.int64, device=dev).copy_(host)),
        ("copy_ to the host, strided", lambda: torch.zeros(4, dtype=torch.int64).copy_(x[::2])),
        ("torch.tensor(list)", lambda: torch.tensor([1, 2, 3], device=dev)),
        ("torch.tensor(scalar)", lambda: torch.tensor(3.0, device=dev)),
        ("torch.as_tensor(list)", lambda: torch.as_tensor([1, 2, 3], device=dev)),
        ("torch.as_tensor(ndarray)", lambda: torch.as_tensor(arr, device=dev)),
        ("torch.as_tensor(ndarray, float64)", lambda: torch.as_tensor(
            arr32, dtype=torch.float64, device=dev)),
        ("ndarray .to", lambda: torch.from_numpy(arr).to(dev)),
        ("ndarray .to, non_blocking", lambda: torch.from_numpy(arr).to(dev, non_blocking=True)),
        ("nonzero", lambda: torch.nonzero(mask)),
        ("boolean-mask index", lambda: x[mask]),
        ("boolean-mask store of a scalar", lambda: x.clone().__setitem__(mask, 0)),
        ("boolean-mask store of a tensor", lambda: x.clone().__setitem__(
            mask, torch.arange(4, device=dev))),
        ("masked_select", lambda: torch.masked_select(x, mask)),
        ("unique", lambda: torch.unique(x)),
        ("unique, inverse and counts", lambda: torch.unique(
            x, return_inverse=True, return_counts=True)),
        ("unique over a dim", lambda: torch.unique(x.view(2, 4), dim=0)),
        ("unique_consecutive", lambda: torch.unique_consecutive(x, return_counts=True)),
        ("repeat_interleave", lambda: torch.repeat_interleave(r)),
        ("repeat_interleave of a tensor", lambda: torch.repeat_interleave(x[:3], r)),
        ("repeat_interleave, output_size", lambda: torch.repeat_interleave(r, output_size=6)),
        ("equal", lambda: torch.equal(x, y)),
        ("equal to itself", lambda: torch.equal(x, x)),
        ("allclose", lambda: torch.allclose(xf, xf)),
        ("bincount", lambda: torch.bincount(x)),
        ("histc", lambda: torch.histc(xf)),
        ("histc over a range", lambda: torch.histc(xf, bins=4, min=0, max=8)),
        ("argwhere", lambda: torch.argwhere(mask)),
        ("where(condition)", lambda: torch.where(mask)),
        ("any, as a bool", lambda: bool(mask.any())),
        ("arange to a card scalar", lambda: torch.arange(x[3])),
    ]


def seams_traced(dev, tries: int = 3) -> dict:
    """(a) the seam catalogue under ``x/hopwatch`` and torch.profiler: the
    trace's HtoD and DtoH memcpys equal the ledger's transfers in count
    and bytes, and every kernel belongs to a counted dispatch
    (``trace_vs_ledger``): the implicit syncs' counts and bytes in
    ``x/devseams`` are the card's.  The profiler has been seen to drop a
    record of a lone small copy, so a catalogue whose trace disagrees is
    traced again, up to ``tries`` times; one agreeing trace passes."""
    from m3_tpu_torch.x import hopwatch

    seams = seam_catalogue(dev)
    for _, fn in seams:  # warm: each op's first call out of the trace
        fn()

    def run():
        hopwatch.install()
        hopwatch.reset()
        try:
            for name, fn in seams:
                with hopwatch.hop(name):
                    fn()
            return hopwatch.stats(), hopwatch.seams()
        finally:
            hopwatch.uninstall()

    for attempt in range(tries):
        (stats, by_seam), events, _ = trace_of(run)
        got = trace_vs_ledger(events, stats, by_seam)
        if not got["problems"]:
            break
        log(f"phase24 (a) seam catalogue, trace {attempt + 1} of {tries}: "
            + "\n".join(got["problems"]))
    assert not got["problems"], "ledger != trace on the seam catalogue"
    log(f"phase24 (a) seam catalogue ({len(seams)} seams): the ledger == the trace "
        f"(trace {attempt + 1}): memcpys {got['trace_memcpy']}, {got['trace_kernels']} kernels")
    return {"seams": len(seams), "traces": attempt + 1, "memcpy": got["trace_memcpy"],
            "kernels": got["trace_kernels"],
            "by_hop": {h: {k: v for k, v in st.items() if k in (
                "h2d_count", "h2d_bytes", "d2h_count", "d2h_bytes")} for h, st in stats.items()}}


def guard_on_card(dev) -> dict:
    """(b) ``tracewatch.no_transfers()`` on the card: every seam raises
    ``TransferError`` naming the tensor, kernels #1 and #2 launched on
    resident tensors inside the guard raise nothing and equal their
    plain versions, and ``allow_transfers()`` escapes it."""
    import torch

    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.x import tracewatch

    x = torch.arange(8, dtype=torch.int64, device=dev)
    host = torch.arange(8, dtype=torch.int64)
    arr = np.arange(8, dtype=np.int64)
    seams = {
        ".cpu()": lambda: x.cpu(),
        '.to("cpu")': lambda: x.to("cpu"),
        ".item()": lambda: x[3].item(),
        ".tolist()": lambda: x.tolist(),
        "copy_ to the host": lambda: torch.empty(8, dtype=torch.int64).copy_(x),
        "copy_ to the card": lambda: x.copy_(host),
        "torch.tensor(list)": lambda: torch.tensor([1, 2, 3, 4, 5, 6, 7, 8], device=dev),
        "torch.as_tensor(list)": lambda: torch.as_tensor([1, 2, 3, 4, 5, 6, 7, 8], device=dev),
        "ndarray upload": lambda: torch.from_numpy(arr).to(dev),
        "torch.as_tensor(ndarray)": lambda: torch.as_tensor(arr, device=dev),
        "nonzero": lambda: torch.nonzero(x),
        "boolean-mask index": lambda: x[x > 3],
        "masked_select": lambda: torch.masked_select(x, x > 3),
        "unique": lambda: torch.unique(x),
        "repeat_interleave": lambda: torch.repeat_interleave(x[:3]),
    }
    raised = {}
    with tracewatch.no_transfers():
        for name, fn in seams.items():
            try:
                fn()
            except tracewatch.TransferError as e:
                raised[name] = str(e)
                continue
            raise AssertionError(f"{name} crossed the guard")
        with tracewatch.allow_transfers():
            assert x.cpu().tolist() == list(range(8))
    for name in (".cpu()", '.to("cpu")', ".tolist()", "copy_ to the host",
                 "torch.as_tensor(ndarray)", "ndarray upload"):
        assert "int64[8]" in raised[name], (name, raised[name])
    # resident inputs, made outside the guard
    g = torch.Generator(device=dev).manual_seed(24)
    S, F, W = 4096, 64, 24
    f = torch.arange(F, device=dev)
    keys = ((f // 64) * 6 + (torch.arange(S, device=dev)[:, None] % 5) - 2).to(torch.int32)
    frags = torch.where(torch.rand((S, F), device=dev, generator=g) < 0.5,
                        torch.ones((), dtype=torch.int64, device=dev) << (f % 64), 0)
    words = torch.randint(-(1 << 62), 1 << 62, (W, S), device=dev, generator=g)
    offs = torch.randint(0, W * 64, (8, S), device=dev, generator=g, dtype=torch.int32)
    widths = torch.randint(0, 65, (8, S), device=dev, generator=g, dtype=torch.int32)
    torch.cuda.synchronize()
    n1, n2 = encode_place.launches, decode_gather.launches
    with tracewatch.no_transfers():
        placed = encode_place.place_words(frags, keys, W)
        fields = decode_gather.extract_fields64_t(words, offs, widths)
    assert (encode_place.launches - n1, decode_gather.launches - n2) == (1, 1)
    a = encode_place.place_words_plain(frags, keys, W)
    b = decode_gather.extract_fields64_t_plain(words, offs, widths)
    err = {"place_words": int((placed ^ a).abs().max()),
           "extract_fields64_t": int((fields ^ b).abs().max())}
    assert torch.equal(placed, a) and torch.equal(fields, b), err
    return {"seams_raised": sorted(raised), "messages": raised, "max_abs_err": err}


def lockcheck_on_card(dev) -> dict:
    """(c) four clients stream three windows into an ``IngestServer`` in
    front of the aggregator on the card while a ``FlushManager`` ticks
    each window under the sink's lock (``tests/test_torch_gpu.py::
    test_threaded_ingest_and_ticks_on_card_equal_serial``'s run, at its
    size), with ``x/lockcheck`` armed in raise mode over every lock they
    make: no inversion, and the flushed rows equal a serial run's on the
    card and on the CPU."""
    import threading

    from m3_tpu_torch import instrument
    from m3_tpu_torch.aggregator.engine import Aggregator, AggregatorOptions
    from m3_tpu_torch.aggregator.flush_mgr import FlushManager
    from m3_tpu_torch.client.aggregator_client import AggregatorClient
    from m3_tpu_torch.cluster.kv import KVStore
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import MetricType
    from m3_tpu_torch.server.ingest_tcp import aggregator_sink, serve_ingest_background
    from m3_tpu_torch.x import lockcheck

    W = 10 * SEC
    t0 = 1_600_000_000 * SEC // W * W
    n_clients, n_windows, per = 4, 3, 400

    def frames(c, w):
        rng = np.random.default_rng(100 * c + w)
        ids = [b"cc%d.s%d" % (c, i) for i in range(per)]
        return [(np.full(per, 1 + (c % 2) * 2, np.uint8), ids,
                 np.round(rng.normal(10, 3, per), 2),
                 np.full(per, t0 + 1 + k + w * W, np.int64)) for k in range(2)]

    def node(d):
        agg = Aggregator(num_shards=4, opts=AggregatorOptions(
            capacity=1 << 12, num_windows=4, timer_sample_capacity=1 << 10,
            storage_policies=(StoragePolicy.parse("10s:2d"),)), device=d)
        rows = []

        def on_flush(ml, f):
            m = ml.maps[f.metric_type]
            rows.extend((m.id_of(s), f.timestamp_nanos, int(a),
                         np.float64(v).view(np.int64).item()) for s, a, v in
                        zip(f.slots.tolist(), f.types.tolist(), f.values.tolist()))

        return agg, FlushManager(agg, KVStore(), "i0", flush_handler=on_flush), rows

    lockcheck.reset()
    lockcheck.install(raise_on_cycle=True)
    wall = time.perf_counter()
    try:
        agg, fm, rows_conc = node(dev)
        lock = threading.Lock()
        reg = instrument.new_registry()
        srv = serve_ingest_background(aggregator_sink(agg, lock), instrument=reg.scope(""))
        placement = initial_placement([Instance("i0")], 4, 1)
        done = [0] * n_windows
        cv = threading.Condition()
        errors = []

        def run_client(c):
            try:
                cl = AggregatorClient(placement, lambda _: ("127.0.0.1", srv.port))
                for w in range(n_windows):
                    for f in frames(c, w):
                        cl.write_batch(*f)
                        assert cl.flush() == per
                    with cv:
                        done[w] += 1
                        cv.notify_all()
                cl.close()
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        def ticker():
            try:
                for w in range(n_windows):
                    with cv:
                        assert cv.wait_for(lambda: done[w] == n_clients, timeout=300)
                    with lock:
                        assert fm.tick(t0 + (w + 1) * W) == "leader"
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=run_client, args=(c,)) for c in range(n_clients)]
        threads.append(threading.Thread(target=ticker))
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            assert not any(t.is_alive() for t in threads) and not errors, errors
        finally:
            srv.shutdown()
            srv.server_close()
        found = lockcheck.findings()
        wall = time.perf_counter() - wall
    finally:
        lockcheck.uninstall()
        lockcheck.reset()
    assert not found, "\n".join(map(str, found))
    key = lambda r: (r[1], r)  # noqa: E731 — window, then the row
    for d in (dev, "cpu"):
        ser, sfm, rows_ser = node(d)
        for w in range(n_windows):
            for c in range(n_clients):
                for mts, ids, vals, ts in frames(c, w):
                    ser.add_untimed_batch(MetricType(int(mts[0])), ids, vals, ts)
            assert sfm.tick(t0 + (w + 1) * W) == "leader"
        assert sorted(rows_conc, key=key) == sorted(rows_ser, key=key), d
    assert len(rows_conc) == n_windows * n_clients * per
    return {"rows": len(rows_conc), "inversions": 0, "armed_wall_s": wall}


def proto_on_card(seed: int, dev) -> dict:
    """(d) config #2's 100,000 series x 720 points (phase 3's mix) through
    the batched encoder on the card with a schema annotation
    (``pack_schema_annotation`` on ``PROTO_FDS``; no protobuf import) on
    every series' first datapoint: kernel #1's outputs equal its plain
    version's, the fallback share stays under 5 %, and every 100th
    encoded series, through the scalar decoder, gives back the
    annotation bytes and every point."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.encoding.m3tsz import decode_series
    from m3_tpu_torch.encoding.proto_schema import (
        pack_schema_annotation, unpack_schema_annotation,
    )
    from m3_tpu_torch.parallel import encode_place

    from m3_tpu_torch.x import devseams

    assert not devseams.watching()  # nothing counts or guards this encode
    S, T = PROTO_SERIES, PROTO_POINTS
    ann = pack_schema_annotation(PROTO_FDS, PROTO_MESSAGE)
    assert unpack_schema_annotation(ann) == (PROTO_FDS, PROTO_MESSAGE)
    ts, vals, starts = make_batch(seed + 24, S, T)
    W = max(16, T * 40 // 64 + 8) + (len(ann) + 16) // 8  # room for the prefix
    split: dict = {}
    t0 = time.perf_counter()
    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as pcheck:
        streams, fb = mt.encode_batch(ts, vals, starts, out_words=W, device=dev,
                                      annotations=[ann] * S, timings=split)
    enc_s = time.perf_counter() - t0
    calls, err = pcheck.calls, pcheck.err
    share = float(fb.mean())
    assert calls > 0 and share < 0.05, (calls, share)
    t0 = time.perf_counter()
    checked = 0
    for i in range(0, S, PROTO_CHECK_EVERY):
        if fb[i]:
            continue
        pts = decode_series(streams[i])
        assert pts[0].annotation == ann, i
        assert [p.timestamp for p in pts] == ts[i].tolist(), i
        got = np.array([p.value for p in pts])
        assert np.array_equal(got.view(np.uint64), vals[i].view(np.uint64)), i
        checked += 1
    return {"series": S, "points": T, "annotation_bytes": len(ann), "out_words": W,
            "encode_s": enc_s, "encode_split_s": split, "fallback_share": share,
            "place_calls": calls,
            "decoded_series": checked, "decode_s": time.perf_counter() - t0,
            "max_abs_err": {"place_words": err}}


def instruments_phase(seed: int, dev, card: str) -> dict:
    """Phase 24: (a) ``x/hopwatch`` over the HOPS pipeline at the pinned
    corpus (held against torch.profiler) and at config #3's width, with
    ``x/tracewatch``'s build half installed; (b) the transfer guard;
    (c) ``x/lockcheck`` over threaded ingest and ticks; (d) the proto
    schema annotation through the batched encoder.  Kernel launches are
    counted from 0 over (a)'s pipelines and (d), the phase's main path;
    (a)'s checked passes and (b) count their own."""
    import torch

    from m3_tpu_torch.tools import hops
    from m3_tpu_torch.x import tracewatch

    out = {}
    tracewatch.reset()
    tracewatch.install(raise_on_violation=True)
    try:
        launches = dict.fromkeys(KERNEL_NAMES, 0)

        def add(got):
            for k, v in got.items():
                launches[k] += v

        t0 = time.perf_counter()
        out["a_seams"] = seams_traced(dev)
        out["a_pinned"] = hops_ledger(hops.S_DEFAULT, hops.T_DEFAULT, dev, card, "pinned",
                                      profile=True)
        add(out["a_pinned"]["launches"])
        out["a_wide"] = hops_ledger(HOPS_WIDE_SERIES, HOPS_WIDE_SECONDS, dev, card, "wide",
                                    profile=False)
        add(out["a_wide"]["launches"])
        out["a_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["b"] = guard_on_card(dev)
        out["c"] = lockcheck_on_card(dev)
        out["bc_s"] = time.perf_counter() - t0
        zero_launches()
        t0 = time.perf_counter()
        out["d"] = proto_on_card(seed, dev)
        out["d_s"] = time.perf_counter() - t0
        add(read_launches())
        out["builds"] = tracewatch.total_compiles()
        assert not tracewatch.findings(), tracewatch.findings()
    finally:
        tracewatch.uninstall()
    err = {"place_words": max(out["a_pinned"]["place_max_abs_err"],
                              out["a_wide"]["place_max_abs_err"],
                              out["d"]["max_abs_err"]["place_words"],
                              out["b"]["max_abs_err"]["place_words"]),
           "extract_fields64_t": out["b"]["max_abs_err"]["extract_fields64_t"]}
    return {"parts": out, "launches": launches, "max_abs_err": err}


def instrument_records(kernels: list, got: dict, card: str) -> None:
    """Phase 24's result into the kernel records: ``instrument_launches``
    (its path's: kernel #1 in (a)'s encode hops and (d)'s encode, above 0;
    #2, #3 and #4 none — the packed layout) and its largest difference
    from the plain versions ((b)'s guarded launches of #1 and #2
    included)."""
    for k in kernels:
        name = k["name"]
        k["instrument_launches"] = got["launches"][name]
        k["max_abs_err"] = max(k["max_abs_err"], got["max_abs_err"].get(name, 0))
    assert got["launches"]["place_words"] > 0, got["launches"]
    log(f"phase24 [{card}] launches on its path: {got['launches']}")
    parts = dict(got["parts"])
    for key in ("a_pinned", "a_wide"):
        parts[key] = {k: v for k, v in parts[key].items() if k != "seams"}
    log(f"phase24 [{card}] the runtime instruments and the proto codec: " + json.dumps(parts))


# ---- phase 25: the measuring tools ------------------------------------------

PROFILE_SERIES, PROFILE_POINTS = 100_000, 720  # config #2's width, phase 3's corpus
PROFILE_REPS = 1  # decode_profile's timed repetitions, of its 4 (PERF.md §4)
BISECT_SERIES, BISECT_POINTS = 512, 720  # card_bisect's default corpus
COMPARE_SERIES, COMPARE_POINTS = 256, 360  # (d)'s larger generated corpus
AGG_IDS = 1_000_000  # configs #3/#4's series
AGG_ROLLUP_SAMPLES = 6_000_000  # one 1 m window of six 10 s scrapes
AGG_TIMER_SAMPLES = 10_000_000  # config #4's 10M samples over 1M timer ids


class HostKept:
    """Within ``with``, every call of ``owner.attr`` (a kernel wrapper as
    its caller looks it up) runs as before, and host copies of its inputs
    are kept — made under ``costwatch.uncounted()``, so a census counts
    none of the copying, and held off the card, so no device memory is
    held across the pass.  ``check`` then launches the kernel again on
    device copies of each kept call's inputs and holds its result against
    ``plain`` run on the host copies, bit for bit: the returned tensor, or
    with ``cols`` the first ``cols`` arguments (in-place columns).

    A call made inside a counted run (``costwatch.counting()``) and
    labelled with its stage by ``tag`` is also counted in ``check``: the
    launch on the device copies and the wrapper on host copies (its plain
    version), each in a census of its own.  ``deltas`` holds, by stage,
    the ops and the 64-bit results the launches made less those their
    plain versions made: what the card's census of the stage differs from
    the CPU's by, launch for launch."""

    def __init__(self, owner, attr: str, plain, cols: int = 0):
        self.owner, self.attr, self.plain, self.cols = owner, attr, plain, cols
        self.calls: list = []  # [inputs, counted, stage]
        self.deltas: dict = {}

    def __enter__(self):
        import torch

        from m3_tpu_torch.x import costwatch

        fn = self.fn = getattr(self.owner, self.attr)

        def kept(*a):
            counted = costwatch.counting()
            with costwatch.uncounted():
                self.calls.append([tuple(x.to("cpu", copy=True) if isinstance(x, torch.Tensor)
                                         else x for x in a), counted, None])
            return fn(*a)

        setattr(self.owner, self.attr, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)
        return False

    def tag(self, stage: str) -> None:
        """Label every call not yet labelled as ``stage``'s."""
        for c in self.calls:
            if c[2] is None:
                c[2] = stage

    def _account(self, stage: str, launched: dict, plain: dict) -> None:
        from collections import Counter

        d = self.deltas.setdefault(stage, {"ops": Counter(), "wide": {}})
        for rec, sign in ((launched, 1), (plain, -1)):
            for op, n in rec["ops"].items():
                d["ops"][op] += sign * n
            for t, ops in rec["wide_results"].items():
                row = d["wide"].setdefault(t, Counter())
                for op, n in ops.items():
                    row[op] += sign * n

    def check(self, dev) -> tuple:
        """(calls checked, largest difference); raises unless bit-equal."""
        import torch

        from m3_tpu_torch.x import costwatch

        dup = lambda a, to=None: [(x.to(to) if to else x.clone())
                                  if isinstance(x, torch.Tensor) else x for x in a]
        err, n = 0.0, len(self.calls)
        for a, counted, stage in self.calls:
            on_dev, host = dup(a, dev), dup(a)
            with costwatch.census() as launched:
                got = self.fn(*on_dev)
            want = self.plain(*host)
            if self.cols:
                pairs = [(d, h) for d, h in zip(on_dev[:self.cols], host[:self.cols])
                         if d is not None]
            else:
                pairs = [(got, want)]
            for d, h in pairs:
                d = d.cpu()
                assert same_bits(d, h), f"{self.attr} kernel != plain on a stage's inputs"
                err = max(err, max_abs_err(d, h) if d.numel() else 0.0)
            if counted and stage is not None:
                again = dup(a)
                with costwatch.census() as plain:
                    self.fn(*again)  # the wrapper on the host: its plain version
                self._account(stage, launched.records(), plain.records())
        self.calls.clear()
        return n, err


class DeviceKept:
    """As :class:`HostKept` for a pass whose transfers are counted (a
    per-hop ledger): each call's inputs and result are kept as clones on
    the card, so no copy crosses to the host during the pass, and
    ``check`` holds each result as it was launched against ``plain`` on
    host copies of its inputs, bit for bit."""

    def __init__(self, owner, attr: str, plain):
        self.owner, self.attr, self.plain = owner, attr, plain
        self.calls: list = []

    def __enter__(self):
        import torch

        fn = self.fn = getattr(self.owner, self.attr)

        def kept(*a):
            out = fn(*a)
            self.calls.append((tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                     for x in a), out.clone()))
            return out

        setattr(self.owner, self.attr, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)
        return False

    def check(self) -> tuple:
        """(calls checked, largest difference); raises unless bit-equal."""
        import torch

        err, n = 0.0, len(self.calls)
        for a, out in self.calls:
            want = self.plain(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in a))
            got = out.cpu()
            assert same_bits(got, want), f"{self.attr} kernel != plain on a pass's inputs"
            err = max(err, max_abs_err(got, want) if got.numel() else 0.0)
        self.calls.clear()
        return n, err


def census_on_card(dev, card: str) -> dict:
    """(a) The COSTS artifact over every registered stage, built twice on
    the card: both builds agree in every gated metric (tolerance 0), the
    first checks green against ``costs_baseline_cuda.json``, each stage
    launches exactly the kernels ``costwatch.STAGE_KERNELS`` names, every
    launch is bit-equal to its plain version (its inputs kept on the host
    and checked after both builds), the membudget formulas hold to their
    contract and the census's step counts track the documented ones.  The
    artifact is written to ``build/costs_cuda.json``."""
    import contextlib

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.parallel import segment_ingest as si
    from m3_tpu_torch.tools import costs
    from m3_tpu_torch.x import costwatch

    recs = {"place_words": HostKept(mt, "place_words", encode_place.place_words_plain),
            "extract_fields64_t": HostKept(mt, "extract_fields64_t",
                                           decode_gather.extract_fields64_t_plain),
            "segment_ingest": HostKept(si, "segment_ingest_into",
                                       si.segment_ingest_into_plain, cols=3),
            "segment_minmax": HostKept(si, "segment_minmax_into",
                                       si.segment_minmax_into_plain, cols=2)}
    zero_launches()
    arts, walls = [], []
    with contextlib.ExitStack() as stack:
        for r in recs.values():
            stack.enter_context(r)
        for _ in range(2):
            costwatch.clear_stage_cache()
            t0 = time.perf_counter()
            arts.append(costs.build_artifact(device=dev))
            walls.append(time.perf_counter() - t0)
    launches = read_launches()
    art = arts[0]
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "costs_cuda.json").write_text(json.dumps(art, indent=1, sort_keys=True))
    diff = costs.check_artifact(arts[1], arts[0], tolerance=0.0)
    assert not diff, "the two card builds disagree:\n" + "\n".join(e["message"] for e in diff)
    base = costs.default_baseline_path("cuda")
    assert base.exists(), f"no card baseline at {base}"
    viol = costs.check_against_baseline(art, base)
    assert not viol, "census != costs_baseline_cuda.json:\n" + "\n".join(
        v["message"] for v in viol)
    bad = costs.stage_kernel_violations(art)
    assert not bad, bad
    mb = art["membudget_crosscheck"]
    for name, rec in {**mb["arena"], **mb["codec"]}.items():
        assert 1.0 <= rec["ratio"] <= 2.0, (name, rec)
    for key in ("decode", "encode"):
        assert 0.9 <= art["opsdp_crosscheck"][key]["census_vs_documented"] <= 1.1, \
            art["opsdp_crosscheck"]
    err, checked = {}, {}
    for name, r in recs.items():
        checked[name], err[name] = r.check(dev)
    assert all(checked.values()), checked
    for name, fp in art["stages"].items():
        log(f"phase25 (a) [{card}] {name}: {fp['dispatches']} dispatches "
            f"({json.dumps(fp['ops'])}), width64 {fp['width64']}, kernels "
            f"{json.dumps(fp['kernels'])}, transfers {json.dumps(fp['transfers'])}, "
            f"peak {fp['memory']['peak_bytes']} B, {fp['dispatches_per_dp']} dispatches/dp")
    log(f"phase25 (a) [{card}] membudget crosscheck: {json.dumps(mb)}")
    log(f"phase25 (a) [{card}] step counts: {json.dumps(art['opsdp_crosscheck'])}")
    log(f"phase25 (a) [{card}] two builds {walls[0]:.1f} s and {walls[1]:.1f} s, equal in "
        f"every gated metric, green against {base.name}; launches {launches}, each "
        f"re-launched on its kept inputs == plain ({checked} calls)")
    return {"build_s": walls, "launches": launches, "checked_calls": checked,
            "max_abs_err": err}


def profile_on_card(seed: int, dev, card: str) -> dict:
    """(b) ``tools/decode_profile`` in both modes on the card at config #2's
    width over phase 3's corpus (the encode first; the decode profiles its
    streams), ``PROFILE_REPS`` timed repetitions; word placement and the
    gather tail launch kernels #1 and #2."""
    from m3_tpu_torch.tools import decode_profile as dp

    corpus = make_batch(seed, PROFILE_SERIES, PROFILE_POINTS)
    keep: dict = {}
    zero_launches()
    t0 = time.perf_counter()
    enc = dp.profile_encode(PROFILE_SERIES, PROFILE_POINTS, dev, corpus=corpus,
                            reps=PROFILE_REPS, keep=keep)
    t1 = time.perf_counter()
    dec = dp.profile(PROFILE_SERIES, PROFILE_POINTS, dev, packed=keep.pop("packed"),
                     reps=PROFILE_REPS)
    launches = read_launches()
    assert launches["place_words"] > 0 and launches["extract_fields64_t"] > 0, launches
    for mode, got in (("encode", enc), ("decode", dec)):
        per = got["dispatches_per_step"]
        assert list(per.values()) == sorted(per.values()), (mode, per)  # the layers nest
        assert got["native_cpp_dps"] > 0, mode  # the host codec's yardstick on the same corpus
        log(f"phase25 (b) [{card}] decode_profile --mode {mode}: " + json.dumps(got))
    return {"encode": enc, "decode": dec, "encode_s": t1 - t0,
            "decode_s": time.perf_counter() - t1, "launches": launches}


def bisect_on_card(dev, card: str) -> dict:
    """(c) ``tools/card_bisect`` at its default corpus: stages 1-5 equal on
    the card and on the CPU; stage 6 (f64 made on the card) equal."""
    import torch

    from m3_tpu_torch.tools import card_bisect

    zero_launches()
    t0 = time.perf_counter()
    res = card_bisect.bisect(torch.device("cpu"), dev, BISECT_SERIES, BISECT_POINTS)
    launches = read_launches()
    assert not res["bad"], f"card_bisect: diverging stages {res['bad']}"
    assert res["f64_output_equal"]
    assert launches["place_words"] > 0 and launches["extract_fields64_t"] > 0, launches
    log(f"phase25 (c) [{card}] card_bisect S={BISECT_SERIES} T={BISECT_POINTS}: stages 1-5 "
        f"equal, stage 6 equal, in {time.perf_counter() - t0:.1f} s; launches {launches}")
    return {"wall_s": time.perf_counter() - t0, "launches": launches}


def comparator_on_card(seed: int, dev, card: str) -> dict:
    """(d) The PromQL comparator on the card: the default corpus, then a
    larger generated one; no mismatch in either."""
    from m3_tpu_torch.comparator import harness

    out = {}
    for tag, kw in (("default", {}),
                    ("large", {"seed": seed + 25, "num_series": COMPARE_SERIES,
                               "num_points": COMPARE_POINTS})):
        t0 = time.perf_counter()
        rep = harness.run_comparator(str(store_root(f"phase25-{tag}")), device=dev, **kw)
        sample = [(m.query, m.tags, m.step_index, m.engine_value, m.naive_value)
                  for m in rep.mismatches[:8]]
        assert rep.ok, (tag, len(rep.mismatches), sample)
        assert rep.queries_run == len(harness.DEFAULT_CORPUS)
        out[tag] = {"queries": rep.queries_run, "series": rep.series_compared,
                    "values": rep.values_compared, "wall_s": time.perf_counter() - t0}
    log(f"phase25 (d) [{card}] comparator, no mismatch: " + json.dumps(out))
    return out


def host_baseline(seed: int, card: str) -> dict:
    """(e) The single-core Go-aggregator proxy at configs #3/#4's 10^6
    series (host C++, not compared with the card): the counter and gauge
    rollups of one 1 m window, the timer quantiles of 10^7 samples, each
    id's quantiles held to numpy's order statistics on a sample."""
    from m3_tpu_torch.native import aggproxy

    rng = np.random.default_rng(seed + 250)
    C, N, NT = AGG_IDS, AGG_ROLLUP_SAMPLES, AGG_TIMER_SAMPLES
    ids = rng.integers(0, C, N, dtype=np.uint32)
    cvals = rng.integers(0, 1000, N, dtype=np.int64)
    gvals = np.round(rng.uniform(0, 100, N), 3)
    times = 1_700_000_000 * SEC + np.arange(N, dtype=np.int64)
    tc = aggproxy.counter_rollup_ns(ids, cvals, C)
    tg = aggproxy.gauge_rollup_ns(ids, gvals, times, C)
    tids = rng.integers(0, C, NT, dtype=np.uint32)
    tvals = np.round(rng.gamma(2.0, 50.0, NT), 3)
    qs = (0.5, 0.95, 0.99)
    tt, qout = aggproxy.timer_quantiles(tids, tvals, C, qs)
    order = np.argsort(tids, kind="stable")
    bounds = np.searchsorted(tids[order], np.arange(C + 1))
    for i in rng.integers(0, C, 100):
        mine = np.sort(tvals[order[bounds[i]:bounds[i + 1]]])
        if mine.size:
            ranks = [min(max(int(np.ceil(q * mine.size)) - 1, 0), mine.size - 1) for q in qs]
            assert np.array_equal(qout[i, :3], mine[ranks]), i
    out = {"counter_rollup_s": tc, "gauge_rollup_s": tg, "timer_quantiles_s": tt,
           "rollup_samples_per_s": 2 * N / (tc + tg), "timer_samples_per_s": NT / tt}
    log(f"phase25 (e) [{card}] host baseline counter rollup: {tc:.4f} s for {N:,} samples "
        f"over {C:,} ids")
    log(f"phase25 (e) [{card}] host baseline gauge rollup: {tg:.4f} s for {N:,} samples")
    log(f"phase25 (e) [{card}] host baseline timer p50/p95/p99: {tt:.4f} s for {NT:,} "
        f"samples over {C:,} ids")
    return out


def measuring_tools_phase(seed: int, dev, card: str) -> dict:
    """Phase 25: (a) the census and its ratchet, (b) the codec profile, (c)
    the card bisector, (d) the PromQL comparator, (e) the host aggregator
    baseline, each part's wall beside it.  Kernel launches are counted
    from 0 over (a)-(d), the phase's path; (a)'s are each held against
    the plain versions (those checking launches not counted), (b)'s run
    at phase 3's shapes, (c)'s outputs are held against the CPU's."""
    import torch

    from m3_tpu_torch.x import breaker, devguard

    breaker.reset_registry()
    devguard.reset_stages()
    parts, walls = {}, {}
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for key, fn in (("a", lambda: census_on_card(dev, card)),
                    ("b", lambda: profile_on_card(seed, dev, card)),
                    ("c", lambda: bisect_on_card(dev, card)),
                    ("d", lambda: comparator_on_card(seed, dev, card)),
                    ("e", lambda: host_baseline(seed, card))):
        zero_launches()
        t0 = time.perf_counter()
        parts[key] = fn()
        walls[key] = time.perf_counter() - t0
        # (a)-(c) read their launches before any check launches again
        for k, v in parts[key].get("launches", read_launches()).items():
            launches[k] += v
        torch.cuda.empty_cache()
    log(f"phase25 [{card}] part walls (s): {json.dumps(walls)}")
    parts["walls_s"] = walls
    return {"parts": parts, "launches": launches, "max_abs_err": parts["a"].pop("max_abs_err")}


def measuring_records(kernels: list, got: dict, card: str) -> None:
    """Phase 25's result into the kernel records: ``measure_launches`` (its
    path's launches, each above 0: the census runs all four) and its
    largest difference from the plain versions."""
    for k in kernels:
        name = k["name"]
        k["measure_launches"] = got["launches"][name]
        k["max_abs_err"] = max(k["max_abs_err"], got["max_abs_err"][name])
    assert all(k["measure_launches"] > 0 for k in kernels), got["launches"]
    log(f"phase25 [{card}] launches on its path: {got['launches']}")


# ---- phase 26: the static and IR gates ----

GATE_WIDE = {"S": 1_000_000, "T": 10, "resolution_s": 10}  # config #3's width, phase 24's cut
PHASE24_DRAIN_ENCODE = (503_316_480, 42_000_000)  # phase 24's wide pass: down, up (PERF.md §5)


def lint_on_card(card: str) -> dict:
    """(a) The port's m3lint over its own tree on the card's machine: the
    findings equal the committed (empty) baseline."""
    from m3_tpu_torch.x import lint

    t0 = time.perf_counter()
    findings, new, fixed = lint.run_repo()
    secs = time.perf_counter() - t0
    assert not new and not fixed, "m3lint != lint_baseline.json:\n" + "\n".join(
        f.render() for f in new + fixed)
    base = lint.load_baseline(lint.default_baseline_path())
    log(f"phase26 (a) [{card}] m3lint over m3_tpu_torch/: {len(findings)} findings, "
        f"{len(base)} in the baseline, equal; {secs:.1f} s")
    return {"findings": len(findings), "baseline": len(base), "s": secs}


def _less(card: dict, cpu: dict, launched: dict) -> dict:
    """card - cpu - launched, by op, without the zeros."""
    out = {op: card.get(op, 0) - cpu.get(op, 0) - launched.get(op, 0)
           for op in set(card) | set(cpu) | set(launched)}
    return {op: d for op, d in sorted(out.items()) if d}


def census_vs_cpu(card_stages: dict, cpu_stages: dict, launched: dict) -> dict:
    """The card's op census and 64-bit type census against the CPU's on
    this machine, stage by stage and op by op.  What the stage's launches
    account for (``launched``: by stage, from :class:`HostKept`, each
    launch's ops and 64-bit results less its plain version's) is taken
    off first; what is left must be the card's routes and nothing else:
    one ``aten::_to_copy`` for each of the stage's transfers (a no-op on
    the CPU), at most that many of them 64-bit, and ``arena._sqrt``'s
    ``aten::sqrt`` with one float64 result each (numpy on the CPU).
    Returns each stage's difference and the routes left of it."""
    from m3_tpu_torch.x import irlint

    out = {}
    for name, cs in card_stages.items():
        card, cpu = cs.records, cpu_stages[name].records
        acc = launched.get(name, {"ops": {}, "wide": {}})
        ops = _less(card["ops"], cpu["ops"], acc["ops"])
        wide = {t: _less(card["wide_results"].get(t, {}), cpu["wide_results"].get(t, {}),
                         acc["wide"].get(t, {})) for t in irlint.WIDE_TYPES}
        copies = sum(n for k, (n, _) in card["transfers"].items()
                     if k.endswith(":aten::_to_copy"))
        sqrt = ops.get("aten::sqrt", 0)
        assert (set(ops) <= {"aten::_to_copy", "aten::sqrt"} and sqrt >= 0
                and ops.get("aten::_to_copy", 0) == copies), (name, ops, copies, acc["ops"])
        wide_copies = sum(w.pop("aten::_to_copy", 0) for w in wide.values())
        assert 0 <= wide_copies <= copies, (name, wide_copies, copies)
        assert wide["float64"].pop("aten::sqrt", 0) == sqrt, (name, wide, sqrt)
        assert not any(wide.values()), (name, wide, acc["wide"])
        out[name] = {"ops": _less(card["ops"], cpu["ops"], {}),
                     "wide": {t: d for t in irlint.WIDE_TYPES if (d := _less(
                         card["wide_results"].get(t, {}), cpu["wide_results"].get(t, {}), {}))},
                     "routes": ops}
    return out


def irlint_on_card(dev, card: str) -> dict:
    """(b) The IRLINT artifact on the card from one census build: each
    stage launching exactly the kernels ``costwatch.STAGE_KERNELS`` names,
    every launch held bit for bit against its plain version (the census's
    inputs kept on the host, the residency pass's kept on the card, each
    checked after its pass), each 64-bit ceiling equal to the card's
    census, the op and type census equal to the CPU's on this machine
    but for what each launch accounts for and the card's routes, the
    residency pass at PIPE recorded equal to its per-hop ledger, and the
    artifact green against ``irlint_baseline_cuda.json`` (written to
    ``build/irlint_cuda.json``)."""
    import contextlib

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.parallel import segment_ingest as si
    from m3_tpu_torch.tools import costs
    from m3_tpu_torch.x import costwatch, irlint

    recs = {"place_words": HostKept(mt, "place_words", encode_place.place_words_plain),
            "extract_fields64_t": HostKept(mt, "extract_fields64_t",
                                           decode_gather.extract_fields64_t_plain),
            "segment_ingest": HostKept(si, "segment_ingest_into",
                                       si.segment_ingest_into_plain, cols=3),
            "segment_minmax": HostKept(si, "segment_minmax_into",
                                       si.segment_minmax_into_plain, cols=2)}

    def on_stage(name, _seconds):
        for r in recs.values():
            r.tag(name)

    costwatch.clear_stage_cache()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for r in recs.values():
            stack.enter_context(r)
        card_stages = costwatch.counted_stages(device=dev, on_stage=on_stage)  # the one build
    census_s = time.perf_counter() - t0
    # the residency pass's launches are kept on the card: a kept host
    # copy would be a transfer in the pass's ledger
    with DeviceKept(mt, "place_words", encode_place.place_words_plain) as res_kept:
        art = irlint.build_artifact(device=dev)
    launches = read_launches()
    build_s = time.perf_counter() - t0
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "irlint_cuda.json").write_text(json.dumps(art, indent=1, sort_keys=True))
    bad = costs.stage_kernel_violations(
        {"config": {"platform": "cuda"},
         "stages": {n: cs.fingerprint for n, cs in card_stages.items()}})
    assert not bad, bad
    err, checked = {}, {}
    for name, r in recs.items():
        checked[name], err[name] = r.check(dev)
    n, e = res_kept.check()
    assert n, "the residency pass launched no place_words"
    checked["place_words"] += n
    err["place_words"] = max(err["place_words"], e)
    assert all(checked.values()), checked
    for name, cs in card_stages.items():
        ceil, types = irlint.width_contract(name, "cuda"), cs.fingerprint["types"]
        for t in irlint.WIDE_TYPES:
            if t not in irlint.WIDE_FORBIDDEN.get(name, ()):
                assert types.get(t, 0) == ceil[t], (name, t, types.get(t, 0), ceil[t])
    res = art["residency"]
    assert res["ledger_equal"], json.dumps(res)
    assert res["seams"][0]["composed"], res["seams"][0]
    base = irlint.default_baseline_path("cuda")
    assert base.exists(), f"no card baseline at {base}"
    errs = irlint.check_against_baseline(art, base)
    assert not errs, "irlint != irlint_baseline_cuda.json:\n" + "\n".join(
        e["message"] for e in errs)
    t1 = time.perf_counter()
    cpu_stages = costwatch.counted_stages(device="cpu")
    launched: dict = {}
    for r in recs.values():
        for stage, d in r.deltas.items():
            acc = launched.setdefault(stage, {"ops": {}, "wide": {}})
            for op, k in d["ops"].items():
                acc["ops"][op] = acc["ops"].get(op, 0) + k
            for t, row in d["wide"].items():
                for op, k in row.items():
                    acc["wide"].setdefault(t, {})[op] = acc["wide"].get(t, {}).get(op, 0) + k
    diff = census_vs_cpu(card_stages, cpu_stages, launched)
    assert set(launched) == set(costwatch.STAGE_KERNELS), sorted(launched)
    cpu_s = time.perf_counter() - t1
    for f in art["findings"]:
        log(f"phase26 (b) [{card}] [{f['rule']}] {f['path']}: {f['message']}")
    for name, d in diff.items():
        log(f"phase26 (b) [{card}] {name}: card - CPU ops {json.dumps(d['ops'])}, 64-bit "
            f"results {json.dumps(d['wide'])}; routes left after the launches "
            f"{json.dumps(d['routes'])}")
    for sm in res["seams"]:
        log(f"phase26 (b) [{card}] residency at PIPE {sm['seam']}: composed {sm['composed']}, "
            f"{sm['transfers']} crossings {sm['bytes']} B, scalars {json.dumps(sm['scalars'])}, "
            f"ledger {json.dumps(sm.get('ledger'))}")
    log(f"phase26 (b) [{card}] rule counts {json.dumps(art['counts'])}; census {census_s:.1f} s, "
        f"artifact {build_s:.1f} s, CPU census {cpu_s:.1f} s; green against {base.name}; "
        f"launches {launches} (the residency pass's place_words {n}), each held against "
        f"plain ({checked} calls)")
    return {"counts": art["counts"], "launches": launches, "checked_calls": checked,
            "max_abs_err": err, "census_s": census_s, "build_s": build_s, "cpu_census_s": cpu_s,
            "residency": res, "census_vs_cpu": diff}


def residency_wide_on_card(dev, card: str) -> dict:
    """(c) The chain's residency at config #3's width (10^6 series, T cut
    to 10 s as phase 24 cut it): every seam's transfers equal to the
    per-hop ledger of the same pass, the ingest -> drain seam composed,
    the drain -> encode bytes beside phase 24's, and each of the pass's
    kernel launches held bit for bit against its plain version."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import encode_place
    from m3_tpu_torch.x import irlint

    zero_launches()
    t0 = time.perf_counter()
    with DeviceKept(mt, "place_words", encode_place.place_words_plain) as kept:
        found, res = irlint.residency_report(dev, GATE_WIDE)
    secs = time.perf_counter() - t0
    launches = read_launches()
    checked, err = kept.check()
    assert checked == launches["place_words"] > 0, (checked, launches)
    assert res["ledger_equal"], json.dumps(res)
    assert res["seams"][0]["composed"], res["seams"][0]
    assert res["samples"] == GATE_WIDE["S"] * GATE_WIDE["T"]
    drain = res["seams"][1]
    down = sum(c["bytes_each"] * c["transfers"] for c in drain["crossings"]
               if c["direction"] == "d2h")
    up = sum(c["bytes_each"] * c["transfers"] for c in drain["crossings"]
             if c["direction"] == "h2d")
    for f in found:
        log(f"phase26 (c) [{card}] [{f.rule}] {f.path}: {f.message}")
    for sm in res["seams"]:
        log(f"phase26 (c) [{card}] {sm['seam']}: composed {sm['composed']}, {sm['transfers']} "
            f"crossings {sm['bytes']} B, scalars {json.dumps(sm['scalars'])}, ledger "
            f"{json.dumps(sm.get('ledger'))}")
    log(f"phase26 (c) [{card}] drain -> encode at 10^6 x 10: {down} B down and {up} B up "
        f"(phase 24: {PHASE24_DRAIN_ENCODE[0]} B and {PHASE24_DRAIN_ENCODE[1]} B); "
        f"entry {json.dumps(res['entry'])}, exit {json.dumps(res['exit'])}; {secs:.1f} s; "
        f"launches {launches}, place_words == plain on each ({checked} calls)")
    return {"s": secs, "down": down, "up": up, "launches": launches,
            "max_abs_err": {"place_words": err},
            "seams": [{k: sm[k] for k in ("seam", "composed", "transfers", "bytes")}
                      for sm in res["seams"]]}


def seeded_on_card(dev, card: str) -> dict:
    """(d) The five seeded regressions on the card, each flipping its rule
    (an added ``scatter_``, an added int64 cast, an added ``.item()`` in a
    stage, the decoder's table moved to a per-call upload, the ingest's
    state pulled to the host at the composed ingest -> drain seam), and a
    baseline pinned to another card or torch refused."""
    import copy

    import torch

    from m3_tpu_torch.aggregator import engine
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.x import costwatch, irlint

    stages = {s.name: s for s in costwatch.STAGES}

    def flips(name, seeded, rule, fn_args=None):
        fn, args, dp = fn_args or stages[name].build(dev)[:3]
        good = irlint.program(name, fn, args, dp, dev)
        bad = irlint.program(name, seeded(fn), args, dp, dev)
        before = [f for f in irlint.analyze_program(good)[0] if f.rule == rule]
        after = [f for f in irlint.analyze_program(bad)[0] if f.rule == rule]
        assert not before and after, (name, rule, before, after)
        return after[0].message

    def scatter(fn):
        def run(*a):
            out = fn(*a)
            torch.zeros(8, dtype=torch.float64, device=dev).scatter_(
                0, torch.arange(2, dtype=torch.int64, device=dev),
                torch.ones(2, dtype=torch.float64, device=dev))
            return out
        return run

    def cast(fn):
        def run(st):
            out = fn(st)
            out[1].to(torch.int32).to(torch.int64)  # the counts: an added int64 cast
            return out
        return run

    def item(fn):
        def run(st):
            out = fn(st)
            out[0].sum().item()
            return out
        return run

    def upload(fn):
        return lambda tbl, i: fn(torch.as_tensor(mt._VALUE_CTRL_TBL.astype(np.int32),
                                                 device=i.device), i)

    t0 = time.perf_counter()
    got = {
        "scatter-budget": flips("arena/counter_consume_packed", scatter, "scatter-budget"),
        "width-discipline": flips("arena/counter_consume_f64", cast, "width-discipline"),
        "transfer-free": flips("arena/gauge_consume_f64", item, "transfer-free"),
        "ir-const-bloat": flips("decode/gather", upload, "ir-const-bloat", fn_args=(
            lambda tbl, i: tbl[i], (mt.value_ctrl_table(dev),
                                    torch.zeros(16, dtype=torch.int64, device=dev)), 16)),
    }
    add = engine.Aggregator.add_untimed_batch

    def pulled(self, *a, **kw):
        out = add(self, *a, **kw)
        for shard in self.shards:
            for ml in shard.lists.values():
                for t in ml.gauges.state:
                    if isinstance(t, torch.Tensor) and t.dim():
                        t.cpu()
        return out

    engine.Aggregator.add_untimed_batch = pulled
    try:
        found, res = irlint.residency_report(dev, {"S": 1024, "T": 10, "resolution_s": 10})
    finally:
        engine.Aggregator.add_untimed_batch = add
    seam = res["seams"][0]
    assert not seam["composed"] and res["ledger_equal"], seam
    hits = [f for f in found if f.path == "seam:arena_ingest->window_drain"]
    assert hits and all(" d2h arena_ingest." in f" {f.message}" for f in hits), found
    got["residency-composition"] = hits[0].message
    art = json.loads((ROOT / "build" / "irlint_cuda.json").read_text())
    for key, value in (("device_name", "NVIDIA A100-SXM4-80GB"), ("torch", "0.0.0")):
        base = copy.deepcopy(art)
        base["config"][key] = value
        kinds = [e["kind"] for e in irlint.check_artifact(art, base)]
        assert kinds == [{"device_name": "device", "torch": "torch-version"}[key]], kinds
    for rule, msg in got.items():
        log(f"phase26 (d) [{card}] seeded: [{rule}] {msg}")
    log(f"phase26 (d) [{card}] a baseline pinned to another card or torch: refused; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"flipped": sorted(got), "s": time.perf_counter() - t0}


def gates_phase(seed: int, dev, card: str) -> dict:
    """Phase 26: (a) m3lint, (b) irlint on the card, (c) residency at
    config #3's width, (d) the seeded regressions; each part's wall.
    Kernel launches are counted from 0 over (b) and (c), the phase's
    path."""
    import torch

    walls, parts = {}, {}
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for key, fn in (("a", lambda: lint_on_card(card)), ("b", lambda: irlint_on_card(dev, card)),
                    ("c", lambda: residency_wide_on_card(dev, card)),
                    ("d", lambda: seeded_on_card(dev, card))):
        t0 = time.perf_counter()
        parts[key] = fn()
        walls[key] = time.perf_counter() - t0
        for k, v in parts[key].get("launches", {}).items():
            launches[k] += v
        torch.cuda.empty_cache()
    err = dict.fromkeys(KERNEL_NAMES, 0.0)
    for part in parts.values():
        for k, v in part.pop("max_abs_err", {}).items():
            err[k] = max(err[k], v)
    log(f"phase26 [{card}] part walls (s): {json.dumps(walls)}")
    return {"parts": parts, "walls_s": walls, "launches": launches, "max_abs_err": err}


def gates_lane(seed: int, card: str, done23b) -> dict:
    """Phases 26 and 28 in a lane of their own; phase 28 waits for
    ``done23b`` (phase 23 (b) passed in its lane): its threaded host codec
    loads the host, and 23 (b)'s remote fetches time out at 30 s."""
    import os

    import torch

    torch.set_num_threads(LANE_THREADS)
    lane_wait()
    t0 = time.perf_counter()
    out = gates_phase(seed, torch.device("cuda"), card)
    log(f"phase26 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    while not done23b.wait(2.0):
        if os.getppid() != _LANE["ppid"]:
            raise SystemExit("chip_smoke: the main process is gone")
    log(f"phase28 waited {time.perf_counter() - t0:.1f} s for phase 23 (b)")
    t0 = time.perf_counter()
    out["native"] = native_phase(torch.device("cuda"), card)
    log(f"phase28 done in {time.perf_counter() - t0:.1f} s")
    return out


def gates_records(kernels: list, got: dict, card: str) -> None:
    """Phase 26's result into the kernel records: ``gate_launches`` (its
    path's launches, each above 0: the census runs all four) and its
    largest difference from the plain versions."""
    for k in kernels:
        name = k["name"]
        k["gate_launches"] = got["launches"][name]
        k["max_abs_err"] = max(k["max_abs_err"], got["max_abs_err"][name])
    assert all(k["gate_launches"] > 0 for k in kernels), got["launches"]
    log(f"phase26 [{card}] launches on its path: {got['launches']}")


# ---- phase 27: the ops CLI and the distributed tests ----

SOAK_SERIES = 50_000  # of the reference's 10^6 (PERF.md §4)
SOAK_WINDOW_FLOOR_S = 10.0  # each phase window, shrunk in proportion, at least this
AGENT_NODE = """
db:
  root: {root}
  namespaces:
    default: {{num_shards: 2}}
coordinator: {{listen_port: 0}}
mediator: {{enabled: false}}
"""


def soak_config():
    """The reference's default soak shape (3 nodes at rf 3 and a spare,
    8 shards of 2^18 slots, batches of 10,000, churn 0.02, the 200-series
    query corpus, the 2,000 x 3 historical corpus, the full timeline,
    selfmon and the controller on) with its depth cut: ``series`` to
    ``SOAK_SERIES`` and each phase window shrunk in the same proportion,
    to at least ``SOAK_WINDOW_FLOOR_S``; ``max_sweeps`` grows by the
    series cut, so the cap bounds the reference's samples and ends no
    load before the timeline has run.  Returns (config, the cuts)."""
    from m3_tpu_torch.dtest.soak import SoakConfig

    base = SoakConfig()
    scale = SOAK_SERIES / base.series
    cuts = {"series": SOAK_SERIES,
            "max_sweeps": -(-base.max_sweeps * base.series // SOAK_SERIES)}
    for key in ("t_healthy", "t_wire", "t_device", "t_kill", "t_corrupt"):
        cuts[key] = max(SOAK_WINDOW_FLOOR_S, getattr(base, key) * scale)
    return SoakConfig(**cuts), {k: (getattr(base, k), v) for k, v in cuts.items()}


def cli_run(argv, keep: int | None = None) -> tuple:
    """``m3_tpu_torch.tools.cli.main(argv)`` with its standard output
    parsed line by line: (rc, the lines (the first ``keep`` of them, all
    when None), how many lines there were)."""
    import contextlib
    import io

    from m3_tpu_torch.tools import cli

    class Sink(io.TextIOBase):
        def __init__(self):
            self.n, self.lines, self.part = 0, [], ""

        def write(self, s):
            self.part += s
            *done, self.part = self.part.split("\n")
            for line in done:
                if line.strip():
                    self.n += 1
                    if keep is None or len(self.lines) < keep:
                        self.lines.append(json.loads(line))
            return len(s)

    sink = Sink()
    with contextlib.redirect_stdout(sink):
        rc = cli.main(argv)
    return rc, sink.lines, sink.n


def agent_on_card(workdir: Path, card: str) -> dict:
    """(a) ``serve_agent_background`` and one node on the card driven
    through ``AgentClient``: setup, start, status, a write, kill, start
    (the write back from the commit log), logs, teardown; each answer
    checked."""
    import urllib.request

    from m3_tpu_torch.dtest.agent import AgentClient, serve_agent_background

    t0 = time.perf_counter()
    srv = serve_agent_background(str(workdir / "agent"))  # device None: the card
    client = AgentClient(srv.server_address)
    walls = {}
    try:
        root = workdir / "agent" / "n1" / "data"
        assert client.setup("n1", AGENT_NODE.format(root=root)) == {"name": "n1",
                                                                 "root": str(root)}
        t = time.perf_counter()
        st = client.start("n1")
        walls["start_s"] = time.perf_counter() - t
        assert st["alive"] and st["port"] and st["device"].startswith("cuda"), st
        assert client.status()["nodes"]["n1"]["alive"]
        ts = STORE_START // SEC + 10
        req = urllib.request.Request(
            f"http://127.0.0.1:{st['port']}/api/v1/json/write",
            data=json.dumps([{"tags": {"__name__": "agent27"}, "timestamp": ts,
                              "value": 27.5}]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.load(r)["written"] == 1
        assert client.kill("n1") == {"name": "n1", "killed": True}
        assert not client.status()["nodes"]["n1"]["alive"]
        t = time.perf_counter()
        st2 = client.start("n1")
        walls["restart_s"] = time.perf_counter() - t
        assert st2["alive"] and st2["device"].startswith("cuda"), st2
        url = (f"http://127.0.0.1:{st2['port']}/api/v1/query_range?query=agent27"
               f"&start={ts - 10}&end={ts + 10}&step=10s")
        with urllib.request.urlopen(url, timeout=60) as r:
            res = json.load(r)["data"]["result"]
        assert res and [ts, "27.5"] in res[0]["values"], res
        logs = client.logs("n1", tail=1 << 16)
        assert b"node up" in logs and b"'device': 'cuda" in logs, logs[-500:]
        assert client.teardown("n1") == {"name": "n1", "torn_down": True}
        assert "n1" not in client.status()["nodes"] and not (workdir / "agent" / "n1").exists()
    finally:
        srv.agent.close()
        srv.shutdown()
        srv.server_close()
    walls["s"] = time.perf_counter() - t0
    log(f"phase27 (a) [{card}] agent: setup, start ({walls['start_s']:.1f} s), status, write, "
        f"kill, start ({walls['restart_s']:.1f} s; the write read back), logs, teardown: "
        f"every answer as expected; {walls['s']:.1f} s")
    return walls


def soak_on_card(workdir: Path, card: str) -> dict:
    """(b) The reference's default soak on the card (``run_soak``, every
    node ``device=None``) at ``soak_config()``'s cut: zero acked loss with
    both digests equal, every chaos event ok, a quiet controller, the SLO
    record, and each node's device boundary (encode calls, refusals only
    in the device window and only on node 0).  The node roots are kept
    for (c)."""
    from m3_tpu_torch.dtest.soak import build_timeline, run_soak

    cfg, cuts = soak_config()
    timeline = build_timeline(cfg)
    log(f"phase27 (b) [{card}] soak cuts (reference -> here): " + json.dumps(cuts) +
        f"; nodes {cfg.nodes} (rf {cfg.rf}) + spare, shards {cfg.num_shards}, slot capacity "
        f"{cfg.slot_capacity}, batch {cfg.batch}, churn {cfg.churn}, query corpus "
        f"{cfg.query_corpus}, historical {cfg.hist_series} x {cfg.hist_points}; timeline "
        f"{[e.arg for e in timeline if e.action == 'phase']}")
    t0 = time.perf_counter()
    art = run_soak(cfg, workdir=str(workdir / "soak"), keep_workdir=True,
                   log=lambda m: log(f"phase27 (b) {m}"))
    wall = time.perf_counter() - t0
    out = ROOT / "build" / "phase27"
    out.mkdir(parents=True, exist_ok=True)
    (out / "soak.json").write_text(json.dumps(art, indent=1))
    for k in range(cfg.nodes + 1):  # each node's log, for the record
        node_log = workdir / "soak" / f"n{k}" / "data" / "node.log"
        if node_log.exists():
            (out / f"n{k}.log").write_bytes(node_log.read_bytes()[-(4 << 20):])
    v = art["verdict"]
    assert v["zero_acked_loss"] and v["missing"] == 0 and v["mismatched"] == 0, v
    assert v["ledger_sha256"] == v["recovered_sha256"], v
    assert v["active_series"] >= SOAK_SERIES, v
    bad = [e for e in art["chaos"] if not e["ok"]]
    assert not bad, bad
    fired = {e["action"] for e in art["chaos"]}
    assert {"wire_fault", "device_fault", "kill", "restart", "corrupt", "replace"} <= fired, fired
    assert v["controller_quiet"] and v["controller_relaxed"], art.get("controller")
    assert v["slo_recorded"], art.get("selfmon")
    names = [p["name"] for p in art["phases"]]
    assert names == ["setup", "healthy", "wire_faults", "device_faults", "sigkill", "corrupt",
                     "replace", "recovered"], names
    nodes = art["device"]["nodes"]
    for inst in (f"i{k}" for k in range(cfg.nodes)):
        rec = nodes[inst]
        assert rec["encode_calls"] > 0, (inst, rec)
        errs = {p for p, n in rec["errors_by_phase"].items() if n}
        assert errs == ({"device_faults"} if inst == "i0" else set()), (inst, rec)
    for inst, rec in nodes.items():
        assert not any(rec["errors_by_phase"].get(p) for p in names if p != "device_faults"), \
            (inst, rec)
    for p in art["phases"]:
        fi, fq = p.get("fleet_ingest", {}), p.get("fleet_query", {})
        log(f"phase27 (b) [{card}] {p['name']}: {p['duration_s']} s, acked "
            f"{p['ingest']['acked_samples']} samples ({p['ingest']['samples_per_s']} "
            f"samples/s), failed batches {p['ingest']['failed_batches']}; ingest driver "
            f"p50/p99 {p['ingest']['driver_p50_ms']}/{p['ingest']['driver_p99_ms']} ms, fleet "
            f"{fi.get('quantiles')} s; query ok/shed/err {p['query']['ok']}/"
            f"{p['query']['shed']}/{p['query']['errors']}, driver p50/p99 "
            f"{p['query']['driver_p50_ms']}/{p['query']['driver_p99_ms']} ms, fleet "
            f"{fq.get('quantiles')} s; counters {json.dumps(p.get('counters'))}")
    peaks = {inst: rec["mem_peak_bytes"] for inst, rec in nodes.items()}
    log(f"phase27 (b) [{card}] verdict: zero_acked_loss {v['zero_acked_loss']}, acked "
        f"{v['acked_samples']} samples over {v['active_series']} series, missing "
        f"{v['missing']}, mismatched {v['mismatched']}, unacked extras {v['unacked_extras']}, "
        f"digests equal ({v['ledger_sha256'][:16]}), verify {v['verify_seconds']} s; sweeps "
        f"{art['sweeps_completed']}; controller actions {art['controller']['actions_total']}; "
        f"SLO verdicts {len(art['selfmon']['verdicts'])}")
    log(f"phase27 (b) [{card}] each node's device: " + json.dumps(
        {i: {"encode_calls": r["encode_calls"], "errors_by_phase": {
            p: n for p, n in r["errors_by_phase"].items() if n},
            "error_stages": r["error_stages"]} for i, r in nodes.items()}))
    log(f"phase27 (b) [{card}] device_mem_peak_bytes by node: {json.dumps(peaks)}, sum "
        f"{sum(peaks.values()) / 2**30:.3f} GiB; soak wall {wall:.1f} s (its own {art['wall_s']} s)")
    return {"wall_s": wall, "verify_s": v["verify_seconds"], "acked": v["acked_samples"],
            "series": v["active_series"], "peaks": peaks, "cluster_log": art["cluster_log"],
            "workdir": str(workdir / "soak"), "nodes": cfg.nodes + 1,
            "hist": (cfg.hist_series, cfg.hist_points)}


def cli_on_soak(soak: dict, dev, card: str) -> dict:
    """(c) The CLI over the soak's kept node roots: ``read_data_files``,
    ``read_index_files``, ``read_commitlog``, ``verify_data_files`` and
    ``scrub --inventory`` (the only corrupt volume the one the corrupt
    event damaged, in quarantine); then every segment decoded on the card
    with ``decode_batch`` (each kernel #2 launch bit-equal to plain)
    equal to the CLI's scalar decode, the historical corpus equal to the
    ledger's values, and re-encoded on the card with ``encode_batch`` at
    its block start (each kernel #1 launch bit-equal to plain) into the
    same bytes."""
    import re

    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.encoding.m3tsz import encode_series
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.parallel import segment_ingest as si
    from m3_tpu_torch.persist.fs import DataFileSetReader, list_filesets

    t0 = time.perf_counter()
    wd = Path(soak["workdir"])
    roots = [wd / f"n{k}" / "data" for k in range(soak["nodes"])]
    m = next(m for line in soak["cluster_log"]
             for m in [re.search(r"corrupted (data/(\S+)/(\d+)/fileset-(\d+)-\d+-data\.db) "
                                 r"on node (\d+)", line)] if m)
    victim, victim_node = m.group(1), int(m.group(5))
    victim_block = (m.group(2), int(m.group(3)), int(m.group(4)))  # (ns, shard, block)
    out: dict = {"nodes": {}}
    scalar = {}  # (node, ns, shard, block, volume, id) -> points of the CLI's decode
    for k, root in enumerate(roots):
        rec = {}
        rc, lines, n = cli_run(["read_data_files", str(root)])
        assert rc == 0
        rec["data_series"] = n
        for ln in lines:
            scalar[(k, ln["namespace"], ln["shard"], ln["block_start"], ln["volume"],
                    ln["id"])] = ln["points"]
        rc, lines, n = cli_run(["read_index_files", str(root)])
        assert rc == 0 and all(ln["num_docs"] >= 0 for ln in lines)
        rec["index_segments"] = n
        rc, lines, n = cli_run(["read_commitlog", str(root)], keep=1000)
        assert rc == 0 and all(set(ln) == {"log", "namespace", "id", "timestamp", "value"}
                               for ln in lines)
        rec["commitlog_entries"] = n
        rc, lines, n = cli_run(["verify_data_files", str(root)])
        assert rc == 0 and all(ln["ok"] for ln in lines), [ln for ln in lines if not ln["ok"]]
        rec["volumes_ok"] = n
        rc, lines, n = cli_run(["scrub", str(root), "--inventory"])
        assert rc == 0 and lines[-1]["corrupt"] == 0, lines[-1]
        inv = lines[:-1]
        if k == victim_node:
            assert len(inv) == 1 and inv[0]["path"].endswith(victim), (inv, victim)
            assert Path(inv[0]["dir"]).is_dir()
            # whether the scrub's peer repair wrote the block back (its
            # volume then verified with the rest)
            rec["victim_rewritten"] = (root / victim).exists()
        else:
            assert inv == [], inv
        rec["quarantined"] = len(inv)
        out["nodes"][f"i{k}"] = rec
    log(f"phase27 (c) [{card}] CLI over the kept roots: " + json.dumps(out["nodes"]) +
        f"; the corrupt event's volume ({victim} on node {victim_node}) is the only one in "
        "quarantine, every other volume verifies")
    t_cli = time.perf_counter() - t0

    # the same segments on the card
    for name in si.KERNELS:
        si.launches[name] = 0
    encode_place.launches = decode_gather.launches = 0
    hist_n, hist_pts = soak["hist"]
    n_segs = n_pts = n_hist = same_bytes = 0
    misses, partial, full = [], [], set()
    with KernelCheck(mt, "extract_fields64_t", decode_gather.extract_fields64_t_plain) as ext, \
            KernelCheck(mt, "place_words", encode_place.place_words_plain) as place:
        for k, root in enumerate(roots):
            groups: dict = {}
            for ns in sorted(p.name for p in (root / "data").iterdir() if p.is_dir()):
                for sh in sorted(int(p.name) for p in (root / "data" / ns).iterdir()
                                 if p.name.isdigit()):
                    for bs, vol in list_filesets(str(root), ns, sh):
                        r = DataFileSetReader(str(root), ns, sh, bs, vol)
                        for sid, seg in r.read_all():
                            groups.setdefault((ns, bs), []).append((sh, vol, sid, seg))
                        r.close()
            for (ns, bs), rows in sorted(groups.items()):
                want = [scalar[(k, ns, sh, bs, vol, sid.decode(errors="replace"))]
                        for sh, vol, sid, seg in rows]
                T = max(1, max(len(w) for w in want))
                d_ts, d_vals, counts, dfb = mt.decode_batch([seg for *_, seg in rows], T,
                                                            device=dev)
                assert not dfb.any(), (ns, bs)
                for r, w in enumerate(want):
                    c = int(counts[r])
                    assert c == len(w)
                    assert d_ts[r, :c].tolist() == [p[0] for p in w], (ns, rows[r][2])
                    assert np.array_equal(d_vals[r, :c], np.asarray([p[1] for p in w])), \
                        (ns, rows[r][2])
                n_segs += len(rows)
                n_pts += int(counts.sum())
                hist = [r for r, row in enumerate(rows) if row[2].startswith(b"soakhist.")]
                if not hist:
                    continue
                # the ledger's historical values: series i holds i + p*1000 at
                # block + (p+1) s (dtest/soak.py _write_historical).  Only the
                # corrupt event's (node, shard, block) may hold an older volume
                # alone, which lacks the later cold writes (ROADMAP Queue C):
                # its points are a subset; every other copy is whole
                for r in hist:
                    i = int(rows[r][2][len(b"soakhist."):])
                    c = int(counts[r])
                    pts = (d_ts[r, :c] - bs) // SEC - 1
                    assert 0 < c <= hist_pts and ((pts >= 0) & (pts < hist_pts)).all()
                    assert np.array_equal(d_ts[r, :c], bs + (pts + 1) * SEC), rows[r][2]
                    assert np.array_equal(d_vals[r, :c], i + 1000.0 * pts), rows[r][2]
                    if c == hist_pts:
                        full.add(i)
                    else:
                        partial.append((k, ns, rows[r][0], bs, rows[r][1], i, c))
                n_hist += len(hist)
                cnt = counts[hist].astype(np.int64)
                streams, fb = mt.encode_batch(d_ts[hist], d_vals[hist],
                                              np.full(len(hist), bs, np.int64), counts=cnt,
                                              fit_words=True, device=dev)
                for j, r in enumerate(hist):
                    c = int(cnt[j])
                    got = (encode_series(list(zip(d_ts[r, :c].tolist(), d_vals[r, :c].tolist())),
                                         start=bs) if fb[j] else streams[j])
                    if got == rows[r][3]:
                        same_bytes += 1
                    elif len(misses) < 5:
                        misses.append((k, ns, bs, rows[r][2].decode(), rows[r][3].hex(), got.hex()))
    launches = {"place_words": encode_place.launches,
                "extract_fields64_t": decode_gather.launches, **si.launches}
    log(f"phase27 (c) [{card}] decode_batch on the card: {n_segs} segments, {n_pts} points, "
        f"equal to the CLI's scalar decode; {n_hist} historical series equal to the ledger; "
        f"kernel #2 {ext.calls} launches, kernel #1 {place.calls}, each bit-equal to plain")
    log(f"phase27 (c) [{card}] re-encode at the block start: {same_bytes} of {n_hist} "
        f"historical segments byte-equal" + (f"; misses {misses}" if misses else ""))
    assert not misses, misses
    # every historical series whole on at least one root (the soak's
    # verdict read each point at Majority), and every partial copy in the
    # corrupt event's block on its node
    assert full == set(range(hist_n)), hist_n - len(full)
    stray = [p for p in partial if (p[0], *p[1:4]) != (victim_node, *victim_block)]
    assert not stray, stray[:5]
    vols = sorted({p[4] for p in partial})
    log(f"phase27 (c) [{card}] historical copies that hold part of the series: "
        f"{len(partial)}, all on node {victim_node} in the corrupt event's (namespace, shard, "
        f"block) {victim_block} (volumes {vols}); every other copy whole, every series whole "
        f"on at least one root")
    assert launches["place_words"] > 0 and launches["extract_fields64_t"] > 0, launches
    assert launches["segment_ingest"] == launches["segment_minmax"] == 0, launches
    assert place.calls == launches["place_words"] and ext.calls == launches["extract_fields64_t"]
    return {"launches": launches, "s": time.perf_counter() - t0, "cli_s": t_cli,
            "max_abs_err": {"place_words": place.err, "extract_fields64_t": ext.err,
                            "segment_ingest": 0, "segment_minmax": 0}}


def gates_cli_on_card(card: str) -> dict:
    """(d) ``cli lint --json`` and ``cli hops --check`` on the card at the
    pinned corpus against ``tools/hops_baseline_cuda.json``: both green."""
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import encode_place

    t0 = time.perf_counter()
    rc, lines, _ = cli_run(["lint", "--json"])
    assert rc == 0 and lines[0]["ok"] and lines[0]["findings"] == 0, lines
    lint_doc = lines[0]
    t_lint = time.perf_counter() - t0
    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as place:
        rc, lines, _ = cli_run(["hops", "--check"])
    chk = lines[0]["hops_check"]
    assert rc == 0 and chk["ok"] and chk["baseline"].endswith("hops_baseline_cuda.json"), chk
    pipe = chk["pipeline"]
    log(f"phase27 (d) [{card}] cli lint --json: ok, {lint_doc['findings']} findings, baseline "
        f"{lint_doc['baseline']} ({t_lint:.1f} s); "
        f"cli hops --check: green against hops_baseline_cuda.json (steady: "
        f"{pipe['transfers_steady']} transfers, {pipe['transfer_bytes_steady']} B, "
        f"{pipe['dispatches_steady']} dispatches, {pipe['compiles_steady']} builds; "
        f"{pipe['samples_per_s_wire_to_bytes']:.0f} samples/s uncounted); kernel #1 "
        f"{place.calls} launches, each bit-equal to plain; {time.perf_counter() - t0:.1f} s")
    return {"lint_s": t_lint, "s": time.perf_counter() - t0, "hops_place_launches": place.calls,
            "place_err": place.err}


def dtest_phase(seed: int, dev, card: str, after_agent=None) -> dict:
    """Phase 27: (a) the agent, then (after ``after_agent()``, when given)
    (d) the lint and hops gates, (b) the soak and (c) the CLI over its
    roots; each part's wall.  Kernel launches are counted from 0 over
    (c), the phase's path in this process (the soak's nodes launch
    theirs in their own processes)."""
    import torch

    workdir = store_root("dtest27")
    walls, parts = {}, {}
    t0 = time.perf_counter()
    parts["a"] = agent_on_card(workdir, card)
    walls["a"] = time.perf_counter() - t0
    if after_agent is not None:
        t0 = time.perf_counter()
        after_agent()
        walls["wait"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts["d"] = gates_cli_on_card(card)
    walls["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parts["b"] = soak_on_card(workdir, card)
    walls["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts["c"] = cli_on_soak(parts["b"], dev, card)
    walls["c"] = time.perf_counter() - t0
    log(f"phase27 [{card}] part walls (s): {json.dumps(walls)}")
    err = dict(parts["c"]["max_abs_err"])
    err["place_words"] = max(err["place_words"], parts["d"]["place_err"])
    return {"walls_s": walls, "launches": parts["c"]["launches"], "max_abs_err": err,
            "peaks": parts["b"]["peaks"]}


def dtest_lane(seed: int, card: str, done23b) -> dict:
    """Phase 27 in a lane of its own; after (a) it waits for ``done23b``
    (phase 23 (b) passed in its lane)."""
    import torch

    torch.set_num_threads(LANE_THREADS)
    lane_wait()

    def after_23b():
        import os

        while not done23b.wait(2.0):
            if os.getppid() != _LANE["ppid"]:
                raise SystemExit("chip_smoke: the main process is gone")

    t0 = time.perf_counter()
    out = dtest_phase(seed, torch.device("cuda"), card, after_agent=after_23b)
    log(f"phase27 done in {time.perf_counter() - t0:.1f} s")
    return out


def dtest_records(kernels: list, got: dict, card: str) -> None:
    """Phase 27's result into the kernel records: ``dtest_launches`` ((c)'s
    launches: #1 and #2 above 0, #3 and #4 none) and its largest
    difference from the plain versions."""
    for k in kernels:
        name = k["name"]
        k["dtest_launches"] = got["launches"][name]
        k["max_abs_err"] = max(k["max_abs_err"], got["max_abs_err"][name])
    log(f"phase27 [{card}] launches on its path: {got['launches']}")


# ---- phase 28: the native host codec ----

NATIVE_POINTS = 1_000_000  # BASELINE config #1: one gauge series at 10 s
NATIVE_SERIES, NATIVE_T = 100_000, 720  # config #2's corpus (x/costwatch.bench_corpus)
# selfmon.measure_overhead at the reference's defaults
OVERHEAD = {"duration_s": 4.0, "batch": 2000, "series": 20_000, "cadence_s": 2.0}


def host_cpu() -> str:
    """The host's CPU model: the machine type and what /proc/cpuinfo names
    (``model name`` on x86; implementer and part on Arm, which has none)."""
    import platform

    fields: dict = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, sep, val = line.partition(":")
        if sep:
            fields.setdefault(key.strip(), val.strip())
    names = [f"{k} {fields[k]}" for k in ("model name", "Model", "Hardware", "CPU implementer",
                                          "CPU part") if k in fields]
    return f"{platform.machine()}: " + ("; ".join(names) or "no model in /proc/cpuinfo")


def native_single_series(card: str) -> dict:
    """(a) BASELINE config #1 at full width, ``bench.py``'s series: 10^6
    points at 10 s, seed 5, ``round(100 + cumsum(N(0, 0.5)), 2)``.  The
    native encode (best of 3) must give the port's scalar ``Encoder``'s
    bytes over every point, and the native decode the timestamps and value
    bits back."""
    import os

    from m3_tpu_torch import native
    from m3_tpu_torch.encoding.m3tsz import Datapoint, Encoder

    N = NATIVE_POINTS
    start = 1_600_000_000 * SEC
    rng = np.random.default_rng(5)
    ts = (start + np.arange(1, N + 1, dtype=np.int64) * 10 * SEC)[None, :]
    vals = np.round(100.0 + np.cumsum(rng.normal(0, 0.5, N)), 2)[None, :]
    starts = np.full(1, start, np.int64)
    enc_s, dec_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        streams, fb = native.encode_batch(ts, vals, starts)
        enc_s.append(time.perf_counter() - t0)
        assert not fb.any(), "config #1: the native encode fell back"
    for _ in range(3):
        t0 = time.perf_counter()
        dts, dvals, counts, dfb = native.decode_batch(streams, N + 1)
        dec_s.append(time.perf_counter() - t0)
    assert not dfb.any() and int(counts[0]) == N
    assert np.array_equal(dts[0, :N], ts[0])
    assert np.array_equal(dvals[0, :N].view(np.uint64), vals[0].view(np.uint64))
    assert native.encode_series(ts[0], vals[0], start) == streams[0]
    t0 = time.perf_counter()
    enc = Encoder(start)
    for t, v in zip(ts[0].tolist(), vals[0].tolist()):
        enc.encode(Datapoint(t, v))
    scalar = enc.stream()
    scalar_s = time.perf_counter() - t0
    assert scalar == streams[0], "config #1: native bytes != the scalar encoder's"
    out = {"points": N, "stream_bytes": len(streams[0]),
           "bytes_per_point": len(streams[0]) / N,
           "encode_dps": [N / s for s in enc_s], "encode_best_dps": N / min(enc_s),
           "decode_dps": [N / s for s in dec_s], "decode_best_dps": N / min(dec_s),
           "scalar_encode_s": scalar_s, "scalar_encode_dps": N / scalar_s,
           "threads": 1, "nthreads_default": native._nthreads(None),
           "cpu_count": os.cpu_count(), "cpu": host_cpu()}
    log(f"phase28 (a) [{card}] config #1, one series of {N} points: native encode "
        f"{[round(x) for x in out['encode_dps']]} dps (best {out['encode_best_dps']:.0f}), "
        f"decode {[round(x) for x in out['decode_dps']]} dps (best "
        f"{out['decode_best_dps']:.0f}), {out['stream_bytes']} stream bytes "
        f"({out['bytes_per_point']:.4f} a point), byte-equal to the scalar encoder over every "
        f"point ({scalar_s:.1f} s, {out['scalar_encode_dps']:.0f} dps), round trip exact; "
        f"one series runs on 1 thread (pool {out['nthreads_default']}); os.cpu_count() "
        f"{out['cpu_count']}; host CPU {out['cpu']}; shared_card (beside other lanes)")
    return out


def native_corpus_on_card(dev, card: str) -> dict:
    """(b) Config #2's corpus at full width (``bench_corpus(100_000,
    720)``): the native ``encode_batch`` against the card's (kernel #1),
    byte for byte on every series, and the native ``decode_batch``
    against the card's (kernel #2), timestamps and value bits, both equal
    to the corpus; no series falls back on either side.  Every launch is
    held against its plain version (``KernelCheck``)."""
    import os

    from m3_tpu_torch import native
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import decode_gather, encode_place
    from m3_tpu_torch.x import costwatch

    S, T = NATIVE_SERIES, NATIVE_T
    ts, vals, starts = costwatch.bench_corpus(S, T)
    threads = native._nthreads(None)
    t0 = time.perf_counter()
    n_streams, n_fb = native.encode_batch(ts, vals, starts)
    n_enc = time.perf_counter() - t0
    assert not n_fb.any(), "config #2: the native encode fell back"
    t0 = time.perf_counter()
    n_ts, n_vals, n_counts, n_dfb = native.decode_batch(n_streams, T + 1)
    n_dec = time.perf_counter() - t0
    zero_launches()
    with KernelCheck(mt, "place_words", encode_place.place_words_plain) as place, \
            KernelCheck(mt, "extract_fields64_t", decode_gather.extract_fields64_t_plain) as ext:
        t0 = time.perf_counter()
        c_streams, c_fb = mt.encode_batch(ts, vals, starts, fit_words=True, device=dev)
        c_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        c_ts, c_vals, c_counts, c_dfb = mt.decode_batch(n_streams, T + 1, device=dev)
        c_dec = time.perf_counter() - t0
    launches = read_launches()
    assert not c_fb.any() and not n_dfb.any() and not c_dfb.any()
    diff = [i for i in range(S) if c_streams[i] != n_streams[i]]
    assert not diff, f"config #2: {len(diff)} series differ, the first {diff[:5]}"
    for got_ts, got_vals, got_counts in ((n_ts, n_vals, n_counts), (c_ts, c_vals, c_counts)):
        assert (got_counts == T).all()
        assert np.array_equal(got_ts[:, :T], ts)
        assert np.array_equal(got_vals[:, :T].view(np.uint64), vals.view(np.uint64))
    assert launches["place_words"] > 0 and launches["extract_fields64_t"] > 0, launches
    assert launches["segment_ingest"] == launches["segment_minmax"] == 0, launches
    nbytes = sum(len(x) for x in n_streams)
    out = {"S": S, "T": T, "stream_bytes": nbytes, "bytes_per_point": nbytes / (S * T),
           "native_encode_dps": S * T / n_enc, "native_decode_dps": S * T / n_dec,
           "card_encode_dps": S * T / c_enc, "card_decode_dps": S * T / c_dec,
           "native_encode_s": n_enc, "native_decode_s": n_dec,
           "card_encode_s": c_enc, "card_decode_s": c_dec,
           "threads": threads, "cpu_count": os.cpu_count(), "launches": launches,
           "max_abs_err": {"place_words": place.err, "extract_fields64_t": ext.err,
                           "segment_ingest": 0, "segment_minmax": 0}}
    log(f"phase28 (b) [{card}] config #2, {S} x {T}: native encode {out['native_encode_dps']:.0f} "
        f"dps ({n_enc:.2f} s), decode {out['native_decode_dps']:.0f} dps ({n_dec:.2f} s) on "
        f"{threads} threads, nproc {out['cpu_count']}; the card's encode_batch "
        f"{out['card_encode_dps']:.0f} dps ({c_enc:.2f} s), decode_batch "
        f"{out['card_decode_dps']:.0f} dps ({c_dec:.2f} s), host walls; every series "
        f"byte-equal ({nbytes} bytes, {out['bytes_per_point']:.4f} a point), both decodes "
        f"equal to the corpus, no fallback; kernel #1 {place.calls} launches, kernel #2 "
        f"{ext.calls}, each bit-equal to plain; shared_card (beside other lanes)")
    return out


def selfmon_overhead_on_card(dev, card: str) -> dict:
    """(c) ``selfmon.measure_overhead`` on the card at the reference's
    defaults; recorded, not gated (the reference records it so)."""
    from m3_tpu_torch.instrument import selfmon

    root = ROOT / "build" / "phase28"
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = selfmon.measure_overhead(**OVERHEAD, root=str(root), device=dev)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase28 (c) [{card}] selfmon.measure_overhead on the card (not gated; "
        f"shared_card): " + json.dumps(out))
    return out


def native_phase(dev, card: str) -> dict:
    """Phase 28: (a) config #1 on the host, (b) config #2's corpus, the
    native codec against the card's, (c) selfmon's overhead on the card;
    each part's wall.  Launches are counted from 0 over (b), the phase's
    path."""
    import torch

    from m3_tpu_torch import native

    t0 = time.perf_counter()
    assert native.available(), "the native codec did not build"
    log(f"phase28 native codec loaded (g++ build included) in {time.perf_counter() - t0:.1f} s")
    walls, parts = {}, {}
    for key, fn in (("a", lambda: native_single_series(card)),
                    ("b", lambda: native_corpus_on_card(dev, card)),
                    ("c", lambda: selfmon_overhead_on_card(dev, card))):
        t0 = time.perf_counter()
        parts[key] = fn()
        walls[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    log(f"phase28 [{card}] part walls (s): {json.dumps(walls)}")
    return {"parts": parts, "walls_s": walls, "launches": parts["b"].pop("launches"),
            "max_abs_err": parts["b"].pop("max_abs_err")}


def native_records(kernels: list, got: dict, card: str) -> None:
    """Phase 28's result into the kernel records: ``native_launches``
    ((b)'s launches: #1 and #2 above 0, #3 and #4 none) and its largest
    difference from the plain versions."""
    for k in kernels:
        name = k["name"]
        k["native_launches"] = got["launches"][name]
        k["max_abs_err"] = max(k["max_abs_err"], got["max_abs_err"][name])
    log(f"phase28 [{card}] launches on its path: {got['launches']}")


# ---- lanes: phases in processes of their own, beside the main one ----

KERNEL_NAMES = ("place_words", "extract_fields64_t", "segment_ingest", "segment_minmax")
LANE_THREADS = 2  # torch's CPU threads in a lane: four processes share the host
_LANE: dict = {}


def lane_wait() -> None:
    """Block a lane until the main process releases it (after phase 11);
    end it if the main process is gone."""
    import os

    while not _LANE["go"].wait(2.0):
        if os.getppid() != _LANE["ppid"]:
            raise SystemExit("chip_smoke: the main process is gone")


def lane_main(go, conn, fn, args) -> None:
    """A lane's process: ``fn(*args)`` (which calls ``lane_wait`` before it
    touches the card), then ("ok", result, its end's wall-clock time, peak
    host RSS in KiB) or ("error", the traceback) down ``conn``.  SIGTERM ends it through
    SystemExit, so its own pools and servers are shut down."""
    import os
    import resource
    import signal
    import traceback

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    _LANE.update(go=go, ppid=os.getppid())
    try:
        out = fn(*args)
        conn.send(("ok", out, time.time(),
                   resource.getrusage(resource.RUSAGE_SELF).ru_maxrss))
    except BaseException:
        conn.send(("error", traceback.format_exc(), None, None))
        raise
    finally:
        conn.close()


class Lane:
    """One or more phases run by ``fn(*args)`` in a spawned process of
    their own (not a pool worker: a lane may start processes itself),
    started with the script so that its imports and set-up overlap the
    builds, and released by ``release`` after phase 11.  ``env`` is set
    for the lane's process alone."""

    def __init__(self, name: str, fn, *args, env: dict | None = None):
        import multiprocessing
        import os

        ctx = multiprocessing.get_context("spawn")
        self.name = name
        self.go = ctx.Event()
        self._recv, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=lane_main, args=(self.go, send, fn, args),
                                name=name)
        env = env or {}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            self.proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        send.close()
        self.span = None

    def release(self) -> None:
        self.go.set()
        self.released = time.time()

    def result(self, timeout: float = 1200.0):
        """The lane's result; raises if it failed, died or is still
        running after ``timeout`` seconds.  Sets ``span`` (release, end)."""
        t0 = time.perf_counter()
        if not self._recv.poll(timeout):
            raise TimeoutError(f"{self.name} still running after {timeout} s")
        try:
            kind, out, end, rss = self._recv.recv()
        except EOFError:
            self.proc.join(30)
            raise RuntimeError(f"{self.name} exited {self.proc.exitcode} with no result")
        self.proc.join(60)
        if kind != "ok":
            raise RuntimeError(f"{self.name} failed:\n{out}")
        self.span = (self.released, end)
        log(f"lane {self.name}: ran {end - self.released:.1f} s; the main process waited "
            f"{time.perf_counter() - t0:.1f} s for it; peak host RSS {rss / 2**20:.2f} GiB")
        return out

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(30)


def merge_records(kernels: list, recs: list) -> None:
    """A lane's partial kernel records into the script's: the larger
    ``max_abs_err``, every other key set."""
    by_name = {k["name"]: k for k in kernels}
    for rec in recs:
        k = by_name[rec["name"]]
        for key, v in rec.items():
            if key == "max_abs_err":
                k[key] = max(k[key], v)
            elif key != "name":
                k[key] = v


def shared_phases(spans: dict) -> list:
    """The phases (``spans``: phase -> (process, start, end)) whose wall
    overlapped a phase of another process: their kernel times were taken
    on a shared card."""
    return sorted(p for p, (who, a, b) in spans.items()
                  if any(o != who and a < d and b > c for o, c, d in spans.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--series", type=int, default=100_000)
    ap.add_argument("--points", type=int, default=720)
    ap.add_argument("--agg-series", type=int, default=1_000_000)
    ap.add_argument("--drain-series", type=int, default=100_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import multiprocessing

    import m3_tpu_torch  # noqa: F401  (without the port the script ends here)

    card = card_line()
    t_start = time.perf_counter()
    # phases 16, 18-19 and 22-28 run in lanes, processes of their own started
    # now and released after phase 11, beside phases 12-15, 20 and 17 in
    # this one (PERF.md §4)
    lanes = []
    try:
        lanes.append(Lane("phase16", downsample_lane, args.seed, card))
        lanes.append(Lane("phases18-19", node_tier_lane, args.seed, card))
        lanes.append(Lane("phases22-23a-25", device_control_lane, args.seed, card,
                          env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}))
        done23b = multiprocessing.get_context("spawn").Event()
        lanes.append(Lane("phases23b-24", federation_lane, args.seed, card, done23b))
        lanes.append(Lane("phases26-28", gates_lane, args.seed, card, done23b))
        # the soak's node processes inherit the lane's environment: two
        # torch threads each, beside the other lanes
        lanes.append(Lane("phase27", dtest_lane, args.seed, card, done23b,
                          env={"OMP_NUM_THREADS": str(LANE_THREADS)}))
        return run(args, lanes, card, t_start)
    finally:
        for lane in lanes:
            lane.stop()


def run(args, lanes: list, card: str, t_start: float) -> int:
    """Phases 1-28 (see the module docstring); ``lanes`` wait for their
    release after phase 11."""
    import torch

    from m3_tpu_torch.core.xtime import Unit
    from m3_tpu_torch.encoding import m3tsz_torch as mt
    from m3_tpu_torch.parallel import _cuda, decode_gather, encode_place
    from m3_tpu_torch.parallel import segment_ingest as si

    dev = torch.device("cuda")
    S, T = args.series, args.points
    W = max(16, T * 40 // 64 + 8)

    # ---- phase 1: card, builds ----
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    names = [encode_place.KERNEL, decode_gather.KERNEL, *si.KERNELS]
    _cuda.build(names)
    log(f"phase1 build: {time.perf_counter() - t0:.1f} s ({len(names)} nvcc in parallel)")
    for name in names:
        log(f"--- ptxas {name} ---\n{_cuda.ptxas_report(name).strip()}")

    # ---- phase 2: kernels vs plain versions at the main path's shapes ----
    rng = np.random.default_rng(args.seed + 1)
    F = 2 * 4 * T                                  # [hi | lo] fragments
    f = torch.arange(F, device=dev)
    s_col = torch.arange(S, device=dev)[:, None]
    keys = ((f // 64) * 6 + (s_col % 5) - 2).to(torch.int32)   # some < 0, some >= W
    onebit = torch.ones((), dtype=torch.int64, device=dev) << (f % 64)
    frags = torch.where(torch.rand((S, F), device=dev) < 0.5, onebit, 0)
    a = encode_place.place_words(frags, keys, W)
    b = encode_place.place_words_plain(frags, keys, W)
    place_err = int((a ^ b).abs().max())
    assert torch.equal(a, b), "place_words kernel != plain"
    assert bool(((keys < 0) | (keys >= W)).any()) and bool((a < 0).any())
    log(f"phase2 place_words: bit-equal on ({S}, {F}) -> ({S}, {W})")

    Wd = W + mt._PAD_WORDS
    Fx = 2 * T
    wnp = rng.integers(0, 1 << 64, (Wd, S), dtype=np.uint64)
    wnp[W:] = 0                                   # the decoder's zero pad
    words_t = torch.from_numpy(wnp.view(np.int64)).to(dev)
    offs = torch.from_numpy(rng.integers(-100, Wd * 64 + 200, (Fx, S))
                            .astype(np.int32)).to(dev)
    widths = torch.from_numpy(rng.integers(-2, 67, (Fx, S)).astype(np.int32)).to(dev)
    widths[0] = 0
    widths[1] = 64
    a = decode_gather.extract_fields64_t(words_t, offs, widths)
    b = decode_gather.extract_fields64_t_plain(words_t, offs, widths)
    ext_err = int((a ^ b).abs().max())
    assert torch.equal(a, b), "extract_fields64_t kernel != plain"
    assert bool((a < 0).any()) and bool((offs >= W * 64).any())
    log(f"phase2 extract_fields64_t: bit-equal on ({Wd}, {S}) words, ({Fx}, {S}) lanes")

    del frags, keys, onebit, words_t, offs, widths, a, b
    torch.cuda.empty_cache()

    # ---- phase 3: the main path ----
    ts, vals, starts = make_batch(args.seed, S, T)
    log(f"phase3 data: S={S} T={T} out_words={W} seed={args.seed}")
    t0 = time.perf_counter()
    # a slice: the lazy inits and the kernels' first loads (PERF.md §4)
    n, Tw = min(S, 1000), min(T, WARMUP_POINTS)
    streams, fb = mt.encode_batch(ts[:n, :Tw], vals[:n, :Tw], starts[:n],
                                  out_words=max(16, Tw * 40 // 64 + 8), device=dev)
    mt.decode_batch(streams, Tw, device=dev)
    log(f"phase3 warm-up pass on {n} series x {Tw} points: {time.perf_counter() - t0:.1f} s")

    # the timed pass keeps each kernel's inputs, to time the kernels on
    # exactly what the main path hands them (phase 5)
    seen: dict = {}

    def keep_args(name, fn):
        def rec(*a):
            seen[name] = a
            return fn(*a)
        return rec

    orig = (mt.place_words, mt.extract_fields64_t)
    mt.place_words = keep_args("place_words", orig[0])
    mt.extract_fields64_t = keep_args("extract_fields64_t", orig[1])
    torch.cuda.reset_peak_memory_stats()
    encode_place.launches = 0
    decode_gather.launches = 0
    enc_t: dict = {}
    dec_t: dict = {}
    t0 = time.perf_counter()
    streams, fb = mt.encode_batch(ts, vals, starts, out_words=W, device=dev,
                                  timings=enc_t)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dts, dvals, counts, dfb = mt.decode_batch(streams, T, device=dev,
                                              timings=dec_t)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = {"place_words": encode_place.launches,
                "extract_fields64_t": decode_gather.launches}
    peak = torch.cuda.max_memory_allocated()
    mt.place_words, mt.extract_fields64_t = orig
    log(f"phase3 launches on the main path: {launches}")
    assert all(v > 0 for v in launches.values()), launches

    share = float(fb.mean())
    log(f"phase3 fallback share: {share:.5f} ({int(fb.sum())} of {S})")
    assert share < 0.05, share
    keep = ~fb
    assert not dfb[keep].any(), "decode flagged encoded series"
    assert (counts[keep] == T).all()
    assert np.array_equal(dts[keep], ts[keep]), "timestamps did not round-trip"
    assert np.array_equal(dvals[keep].view(np.uint64), vals[keep].view(np.uint64)), \
        "value bits did not round-trip"
    log(f"phase3 round trip exact for {int(keep.sum())} series")

    n = 64
    cpu_streams, cpu_fb = mt.encode_batch(ts[:n], vals[:n], starts[:n],
                                          out_words=W, device="cpu")
    assert cpu_streams == streams[:n] and np.array_equal(cpu_fb, fb[:n])
    log(f"phase3 card bytes == CPU bytes on {n} series")

    # ---- phase 4: golden bytes ----
    with open(ROOT / "tests" / "data" / "m3tsz_sample_series.json") as fh:
        gold = [base64.b64decode(s) for s in json.load(fh)]
    gts, gvals, gcounts, gfb = mt.decode_batch(gold, 1500, device=dev)
    assert not gfb.any()
    Tg = int(gcounts.max())
    gwords, _ = mt.pack_streams(gold)
    # the Go encoder's default unit is SECOND; its points are in ms
    re, rfb = mt.encode_batch(gts[:, :Tg], gvals[:, :Tg], gwords[:, 0].view(np.int64),
                              counts=gcounts, unit=Unit.MILLISECOND,
                              default_unit=Unit.SECOND, out_words=W, device=dev)
    assert not rfb.any() and re == gold, "Go golden streams not reproduced"
    log(f"phase4 Go golden streams: {len(gold)} of {len(gold)} byte-identical")
    pts, pvals, pstarts = pinned_batch()
    pstreams, pfb = mt.encode_batch(pts, pvals, pstarts, out_words=200, device=dev)
    assert not pfb.any()
    pw, pn = mt.pack_streams(pstreams)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(pw).tobytes())
    h.update(np.ascontiguousarray(pn).tobytes())
    assert h.hexdigest() == PINNED_ENCODE_DIGEST, h.hexdigest()
    log("phase4 pinned encode digest: match")

    # ---- phase 5: times (kernel launches here do not count) ----
    frags, keys, w_out = seen["place_words"]
    a = encode_place.place_words(frags, keys, w_out)
    b = encode_place.place_words_plain(frags, keys, w_out)
    place_err = max(place_err, int((a ^ b).abs().max()))
    assert torch.equal(a, b), "place_words kernel != plain on main-path inputs"
    place_ms = cuda_ms(lambda: encode_place.place_words(frags, keys, w_out))
    place_plain_ms = cuda_ms(lambda: encode_place.place_words_plain(frags, keys, w_out))
    kl = keys.clamp(0, w_out - 1).long()
    fm = torch.where((keys >= 0) & (keys < w_out), frags, 0)
    out0 = torch.zeros_like(a)
    place_lib_ms = cuda_ms(lambda: out0.scatter_add_(1, kl, fm))
    place_bytes = frags.numel() * (8 + 4) + a.numel() * 8
    del a, b, kl, fm, out0, frags, keys
    words_t, offs, widths = seen["extract_fields64_t"]
    a = decode_gather.extract_fields64_t(words_t, offs, widths)
    b = decode_gather.extract_fields64_t_plain(words_t, offs, widths)
    ext_err = max(ext_err, int((a ^ b).abs().max()))
    assert torch.equal(a, b), "extract_fields64_t kernel != plain on main-path inputs"
    ext_ms = cuda_ms(lambda: decode_gather.extract_fields64_t(words_t, offs, widths))
    ext_plain_ms = cuda_ms(
        lambda: decode_gather.extract_fields64_t_plain(words_t, offs, widths))
    # each input read once, the output written once
    ext_bytes = offs.numel() * (4 + 4 + 8) + words_t.numel() * 8
    log("phase5 both kernels bit-equal to their plain versions on the "
        "main path's own inputs")
    dp = S * T
    log(f"phase5 [{card}] encode {dp / enc_s:,.0f} dp/s ({enc_s:.2f} s: "
        f"phase1 {enc_t['phase1']:.2f} s, phase2 {enc_t['phase2']:.3f} s, "
        f"host {enc_t['host']:.2f} s)")
    log(f"phase5 [{card}] decode {dp / dec_s:,.0f} dp/s ({dec_s:.2f} s: "
        f"host pack+unpack {dec_t['host']:.2f} s, phase1 {dec_t['phase1']:.2f} s, "
        f"phase2 {dec_t['phase2']:.3f} s)")
    log(f"phase5 [{card}] peak device memory {peak / 2**30:.2f} GiB")
    kernels = [
        {"name": "place_words", "route": "cuda",
         "source": "m3_tpu_torch/csrc/place_words.cu",
         "replaces": "m3_tpu/parallel/pallas_encode.py:52",
         "launches": launches["place_words"], "max_abs_err": place_err,
         "ms": place_ms, "plain_ms": place_plain_ms,
         "bound_ms": place_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": place_lib_ms},
        {"name": "extract_fields64_t", "route": "cuda",
         "source": "m3_tpu_torch/csrc/extract_fields.cu",
         "replaces": "m3_tpu/parallel/pallas_decode.py:95",
         "launches": launches["extract_fields64_t"], "max_abs_err": ext_err,
         "ms": ext_ms, "plain_ms": ext_plain_ms,
         "bound_ms": ext_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
    ]
    for k in kernels:
        log(f"phase5 [{card}] {k['name']}: {k['ms']:.3f} ms, bound "
            f"{k['bound_ms']:.3f} ms ({k['bound_by']}), plain {k['plain_ms']:.3f} ms, "
            f"library {k['library_ms']}, launches/pass {k['launches']}")
    del seen, a, b, words_t, offs, widths, streams, dts, dvals
    torch.cuda.empty_cache()

    # ---- phases 6-9: the aggregator ----
    t0 = time.perf_counter()
    segment_kernel_checks(args.seed, dev)
    log(f"phase6 done in {time.perf_counter() - t0:.1f} s")
    agg_drive(args.seed + 7, 20_000, dev, card, "warm-up", layout="f64")  # lazy inits
    seen_agg: dict = {}
    orig_agg = (si.segment_ingest_into, si.segment_minmax_into)

    def keep_first(name, fn):
        def rec(*a, **kw):
            # the path's shape: a gauge scrape into the (W*C,) arena
            if (name not in seen_agg and a[-1].dtype == torch.float64
                    and a[-1].shape[0] == args.agg_series):
                seen_agg[name] = (a, kw)
            return fn(*a, **kw)
        return rec

    si.segment_ingest_into = keep_first("segment_ingest_into", orig_agg[0])
    si.segment_minmax_into = keep_first("segment_minmax_into", orig_agg[1])
    torch.cuda.reset_peak_memory_stats()
    for k in si.KERNELS:
        si.launches[k] = 0
    agg_t, f64_got = agg_drive(args.seed, args.agg_series, dev, card, "phase7", layout="f64")
    agg_launches = dict(si.launches)
    agg_peak = torch.cuda.max_memory_allocated()
    si.segment_ingest_into, si.segment_minmax_into = orig_agg
    log(f"phase7 launches on the aggregator path: {agg_launches}")
    assert all(agg_launches[k] > 0 for k in si.KERNELS), agg_launches
    log(f"phase7 [{card}] peak device memory {agg_peak / 2**30:.2f} GiB")
    drain_encode_decode(args.seed + 3, args.drain_series, dev, card)
    kernels += segment_kernel_times(seen_agg, agg_launches, card)
    log(f"phase9 [{card}] aggregator: " + json.dumps(agg_t))

    # ---- phases 10-11: the aggregator on the default (packed) layout ----
    t0 = time.perf_counter()
    agg_drive(args.seed + 7, 20_000, dev, card, "warm-up")  # lazy inits, same path
    for k in si.KERNELS:
        si.launches[k] = 0
    encode_place.launches = decode_gather.launches = 0
    torch.cuda.reset_peak_memory_stats()
    packed_t, packed_got = agg_drive(args.seed, args.agg_series, dev, card, "phase10")
    packed_peak = torch.cuda.max_memory_allocated()
    launched = {**si.launches, "place_words": encode_place.launches,
                "extract_fields64_t": decode_gather.launches}
    log(f"phase10 launches of the four kernels on the packed path: {launched}")
    assert not any(launched.values()), launched
    worst = cross_layout_check(packed_got, f64_got)
    log(f"phase10 consume == the f64 run of phase 7 within the cross-layout envelopes "
        f"(largest relative difference per lane): " + json.dumps(worst))
    del packed_got, f64_got
    packed_card_vs_cpu(args.seed, args.agg_series, 1 << 16, dev, card)
    log(f"phase10 done in {time.perf_counter() - t0:.1f} s")
    for key, v in packed_t.items():
        log(f"phase11 [{card}] {key}: f64 {agg_t[key]:,.3f} | packed {v:,.3f}")
    log(f"phase11 [{card}] peak device memory: f64 {agg_peak / 2**30:.2f} GiB | "
        f"packed {packed_peak / 2**30:.2f} GiB")
    log(f"phase11 [{card}] aggregator, packed: " + json.dumps(packed_t))
    del packed_t
    torch.cuda.empty_cache()

    # ---- the lanes start: phases 16, 18-19 and 22-28 beside 12-15, 20, 17 ----
    for lane in lanes:
        lane.release()
    spans = {}  # phase -> (process, wall start, wall end)

    # ---- phases 12-13: the PromQL query path (BASELINE config #5) ----
    w0 = time.time()
    t0 = time.perf_counter()
    promql_t = promql_config5(args.seed, PROMQL_GROUPS, PROMQL_BUCKETS, dev, card)
    log(f"phase12 done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe_t, query_launches = bytes_to_quantiles(args.seed, PROMQL_GROUPS, PROMQL_BUCKETS,
                                                dev, card)
    log(f"phase13 done in {time.perf_counter() - t0:.1f} s")
    spans["phases12-13"] = ("main", w0, time.time())
    for k in kernels:
        k["query_launches"] = query_launches[k["name"]]
        if k["name"] == "extract_fields64_t":  # also held at the query path's shapes
            k["max_abs_err"] = max(k["max_abs_err"], pipe_t["ext_max_abs_err"])
            k.update(query_ms=pipe_t["ext_ms"], query_plain_ms=pipe_t["ext_plain_ms"],
                     query_bound_ms=pipe_t["ext_bound_ms"])
    log(f"phase13 [{card}] query path: " + json.dumps({"config5": promql_t, "pipeline": pipe_t}))
    torch.cuda.empty_cache()

    # ---- phases 14-15: the storage node ----
    w0 = time.time()
    t0 = time.perf_counter()
    store_t, storage_launches, check_launches, place_store = storage_node(
        args.seed, STORE_SERIES, dev, card)
    log(f"phase14 done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    promql_store_t = promql_over_storage(args.seed, PROMQL_GROUPS, PROMQL_BUCKETS, dev, card)
    log(f"phase15 done in {time.perf_counter() - t0:.1f} s")
    spans["phases14-15"] = ("main", w0, time.time())
    for k in kernels:
        k["storage_launches"] = storage_launches[k["name"]]
        k["storage_check_launches"] = check_launches[k["name"]]
        if k["name"] == "place_words":  # also held at the storage flush's shapes
            k["max_abs_err"] = max(k["max_abs_err"], place_store.pop("storage_max_abs_err"))
            k.update(place_store)
    log(f"phase15 [{card}] storage node: " + json.dumps({"phase14": store_t,
                                                          "phase15": promql_store_t}))
    torch.cuda.empty_cache()

    # ---- phase 20: the device mesh ----
    w0 = time.time()
    t0 = time.perf_counter()
    _, mesh_launched, mesh_err = mesh_phase(args.seed, S, dev, card)
    log(f"phase20 done in {time.perf_counter() - t0:.1f} s")
    spans["phase20"] = ("main", w0, time.time())
    for k in kernels:
        k["mesh_launches"] = mesh_launched[k["name"]]
        k["max_abs_err"] = max(k["max_abs_err"], mesh_err[k["name"]])
    torch.cuda.empty_cache()

    # ---- phase 17: the aggregator's entry point, forwarding ----
    w0 = time.time()
    fwd = forwarding_phase_main(args.seed, args.agg_series, dev, card)
    spans["phase17"] = ("main", w0, time.time())
    torch.cuda.empty_cache()

    # ---- the lanes end: phase 16, phases 18-19, phases 22-25, 23b-24, 26-28 and 27 ----
    ds_lane, node_lane, ctl_lane, fed_lane, gate_lane, soak_lane = lanes
    downsample_records(kernels, ds_lane.result(), fwd, card)
    merge_records(kernels, node_lane.result()["records"])
    ctl = ctl_lane.result()
    device_control_records(kernels, ctl, card)
    fed = fed_lane.result()
    front_door_records(kernels, ctl["front_door"], fed["federation"], card)
    instrument_records(kernels, fed["instruments"], card)
    measuring_records(kernels, ctl["measure"], card)
    gates = gate_lane.result()
    gates_records(kernels, gates, card)
    native_records(kernels, gates["native"], card)
    dtest_records(kernels, soak_lane.result(), card)
    for lane in lanes:
        spans[lane.name] = (lane.name, *lane.span)
    shared = shared_phases(spans)
    for k in kernels:
        k["shared_card"] = shared
    log(f"phases [{card}] on a shared card (each beside a phase of another process): {shared}; "
        "walls " + json.dumps({p: round(b - a, 1) for p, (_, a, b) in spans.items()}))
    torch.cuda.empty_cache()

    # ---- phase 21: the replicated storage cluster ----
    t0 = time.perf_counter()
    _, cluster_launched, cluster_check, place_cluster = cluster_phase(args.seed, dev, card)
    log(f"phase21 done in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["cluster_launches"] = cluster_launched[k["name"]]
        k["cluster_check_launches"] = cluster_check[k["name"]]
        if k["name"] == "place_words":  # also held at the cluster flush's shapes
            k["max_abs_err"] = max(k["max_abs_err"], place_cluster.pop("cluster_max_abs_err"))
            k.update(place_cluster)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
