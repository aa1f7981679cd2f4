#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cugraph_gnn_tpu_torch``) on one
NVIDIA GPU: builds the kernels, holds each against its plain PyTorch version
at the training paths' shapes and times it, then trains sampled GraphSAGE at
the full width of ``bench.py``'s configuration, directly and through the
``GraphStore`` / ``FeatureStore`` / ``NeighborLoader`` path, link prediction
through ``LinkNeighborLoader``, GIN through the loader, weighted, temporal
and disjoint sampling through both loaders, the distributed loaders and
trainer at world 1 over NCCL, R-GCN at ogbn-mag width (the
typed block, the hetero loaders and a typed link batch, and the typed
distributed loaders at world 1 with the distributed trainer), the
hierarchical gather on a 1 x 1 (node, device) mesh, the package surface
(the doctor, the native IO, a profiler trace, the meter, DCP checkpoints),
the OGB examples at ogbn-products width, the twelve other example scripts
(and KG link classification, MovieLens, hetero link prediction, R-GCN
hetero, fraud detection and xgb's encoder at their datasets' scale), and
full-batch GraphSAGE, GCN, GIN, R-GCN and 4-head GAT over a banded graph at
ogbn-products scale, and the attention backward's bfloat16 compute mode and
warp-per-node design there.

    python3 chip_smoke.py            # every phase, on one card
    python3 chip_smoke.py --probe    # phases 1, 2 and 11b alone

Phases (any failure raises and exits non-zero):
1. card: nvidia-smi's name and power limit; no CUDA device is an error.
2. build: nvcc on every ``csrc/*.cu`` source, all at once, and g++ on the
   host graph builders; build seconds and ptxas's register / shared-memory
   lines.
3. kernels: on the synthetic ogbn-products graph (2,449,029 nodes,
   121,124,824 edges, mean degree ~49.5), the fused sampler at hop 0 (10,240
   seeds) and hop 1 (112,640 seeds), k = 10, and the row gather (123,904 ids
   into the 2,449,029 x 128 f32 table, to bf16 and to f32), each bit-equal
   to its plain version on the same inputs (the sampler also between two
   launches, and at k = 16, 17 and 33 on 10,007 seeds and on one hub
   seed); then CUDA-event times of kernel, plain version and, where one
   exists, the single PyTorch call that computes the same function, with
   the L2 cache flushed before each launch.  The sampler's byte bound
   counts its random reads at 4 bytes; its sector floor at 32 bytes for
   each distinct ``indptr`` and ``indices`` sector the call reads.
4. small-input agreement: one small graph trained for three f32 steps on the
   card (kernels) and on the CPU (plain versions) from the same weights and
   draws; samples and gathered rows bit-equal, losses within 1e-4.
5. train: 1 warm-up and 3 timed blocks of 10 steps (batch 1024, fanouts
   10/10, hidden 256, 47 classes, bf16 activations, Adam 1e-3); losses must
   be finite and each kernel's launch count must match the path (gather 10,
   sampler 2 per block).  Then one block timed stage by stage.
5b. loader path: the same graph put into a ``GraphStore`` (edges neighbor
   -> row, so its reversed CSR is the graph's CSR, checked) and its
   features and labels into a ``FeatureStore`` (host seconds of the build,
   as set-up); ``NeighborLoader`` (batch 1024, fanouts 10/10, shuffled)
   with ``dedup=True`` trains GraphSAGE (128 -> 256 -> 47, bf16
   activations, Adam 1e-3) for 12 batches (2 warm-up), then with
   ``dedup=False`` for 6 (2 warm-up): per batch the loss (finite), ms,
   sampled edges, nodes and slots per level and peak memory; per batch 2
   sampler launches and 1 row-gather launch, no other kernel.  Then one
   more batch of each timed stage by stage (sample, feature gather, label
   gather, model step), and, with ``dedup=True``, the sampler alone at that
   batch's two hops (1,024 and 11,264 slots): bit-equal to its plain
   version, timed, with its byte bound and sector floor.
5c. small-input agreement, sampler: ``NeighborSampler(dedup=True)`` on the
   card and on the CPU, on phase 4's 2,000-node graph with the same
   uniforms, uncapped and with ``max_unique_per_hop``: every level, map and
   count equal.
5d. small-input agreement, embeddings: on phase 4's graph, a 2,000 x 32
   table, GraphSAGE 32 -> 32 -> 5 and ``NeighborSampler(dedup=True)`` with
   the same uniforms, three f32 steps (gather, forward and backward, Adam,
   ``add_gradients``, ``apply_gradients``) of ``CachedHostEmbedding``
   (adagrad, 256 slots: it evicts) and of ``DistEmbedding`` (lazy_adam, world
   1: NCCL on the card, a gloo group on the CPU) on the card and on the CPU:
   losses within 1e-4, the cache's host metadata (tags, counters, modified
   bits, hits, misses) equal after every step, the table after ``flush`` and
   the optimizer state within 1e-5; then two runs of two ``apply_gradients``
   from one state on the card, bit for bit equal, for each.
5e. embedding training at full width (``examples/cached_embedding_training.py``
   on phase 3's graph): a learnable 2,449,029 x 128 f32 table in host memory
   (0.05 * N(0, 1), numpy seed 0) behind ``CachedHostEmbedding(adagrad,
   cache_ratio=0.2, ways=8)`` (489,800 slots, 251 MB of rows on the card;
   AdaGrad's state on the host), ``NeighborSampler`` (batch 1024, fanouts
   10/10, dedup), GraphSAGE 128 -> 256 -> 47 in bf16 with Adam 1e-3, the
   embedding's lr 3e-3: 2 warm-up and 10 timed steps, then ``DistEmbedding``
   (lazy_adam, world 1 over NCCL, the same initial table in device memory)
   for 2 + 5.  Per step: the loss (finite), ms, peak memory, the hit rate,
   rows uploaded and dirty rows written back, each stage (sample; the
   lookup; the model; the apply: dedup, state streamed up and down,
   optimizer, cache update; and the two gathers' (the lookup's and the
   apply's) host plans and upload + combine, with its writeback) by CUDA
   events and host clocks between synchronisations, and the
   launches of rows 1, 2 and 3, which must be what the path makes (row 1:
   two cache reads and one per writeback, or one lookup; row 2: two; row 3:
   one dedup, or two) and no other kernel.  Afterwards rows that no step
   touched are bit-equal to the initial table, and, after ``flush``, a
   fresh ``HostManagedCache`` over the host table gathers the last step's
   rows bit-equal to the trained cache; row 1 at the cache's slot read and
   at the ``DistEmbedding`` lookup (f32): bit-equal to its plain version,
   timed beside it and ``index_select``.
5f. the loader over host-located features: phase 5b's stores with ``x`` at
   ``location="host"`` (``CachePolicy()``: 32 ways, 20% of the rows), the
   labels on the card; ``NeighborLoader(dedup=True)`` trains GraphSAGE for 2
   warm-up and 4 batches: per batch the ms, hit rate, loss (finite) and the
   rows bit-equal to the device-located store's for the same ids; 1 row-gather
   (and one per writeback: none, nothing is dirty) and 2 sampler launches.
5g. row 3 at the dedup's shape: ``segment_add`` over the last cached step's
   ~125,000 input-node ids x 128 f32 gradients (the dedup's plan) against
   ``csr_spmm_ref`` (phase 7's tolerance), launched twice bit for bit, timed
   beside ``index_add_`` with its byte bound.
5h. link path (``examples/link_prediction.py`` at phase 5b's scale): 196,608
   of the graph's edges (a fixed draw) as positives, ``LinkNeighborLoader``
   (binary negatives, amount 1, rejecting true edges, batch 1024, fanouts
   10/10, shuffled: 4,096 seeds a batch, levels of 4,096 / 45,056 / 495,616
   slots), GraphSAGE 128 -> 256 -> 16 in bf16, Adam 1e-3, ``train_link.
   link_step``: 12 binary batches (2 warm-up), then 4 triplet batches (1
   warm-up); per batch the loss (finite), ms, valid positives and
   negatives, negatives re-drawn and left unresolved, nodes and slots per
   level, peak memory; exactly 2 sampler and 1 row-gather launches a batch.
   One more batch stage by stage (negatives, sample, feature gather, the
   whole batch, ``link_step``; an epoch's second batch, past its shuffle), the AUC over 4 evaluation batches (printed,
   not gated), and rows 1 and 2 at that batch's shapes: bit-equal to their
   plain versions, timed, with their byte bounds.
5i. small-input agreement, link path: on phase 4's graph, 600 of its edges
   through ``LinkNeighborLoader`` on the card and on the CPU with the same
   negatives' candidates and uniforms: seeds, labels, levels, maps and
   gathered rows bit-equal over three batches; three f32 ``link_step``
   losses within 1e-4.
5j. GIN through ``NeighborLoader`` (128 -> 256 -> 47, bf16, Adam 1e-3): 6
   batches (2 warm-up), launches as in 5b.
5k. ``DeviceLFUCache`` (100,000 x 128 f32 host rows, 512 sets of 8 ways)
   with 32 misses a batch in one set and -1 pads, six batches: every
   gathered row and a later gather of every cached id (all hits) equal the
   host rows; two runs bit for bit equal.
5l. weighted sampling: 5b's graph store and a feature store with ``x``,
   ``y``, an f32 edge weight ``w`` (0.05 + U[0, 1)) and an int32 edge time
   ``t`` (U{0..999}), both made on the card from seed 12;
   ``NeighborLoader(weight_attr="w")`` (batch 1024, fanouts 10/10, dedup,
   shuffled) trains GraphSAGE (128 -> 256 -> 47, bf16, Adam 1e-3) for 8
   batches (2 warm-up): per batch the loss (finite), ms, each stage by
   CUDA events and host clocks between synchronisations (hop 0, hop 1, the
   whole sample, feature gather, model), each hop's targets, edges scored
   and the chunks JAX's loop would take, nodes and slots per level, peak
   memory; 1 row-gather launch a batch and no sampler launch (the weighted
   hops are plain PyTorch: the JAX package has no kernel for them).
5m. temporal sampling: the same loader with ``time_attr="t"`` and an
   ``input_time`` per node (U{0..999}, seed 12) for 8 batches (2 warm-up),
   every sampled edge checked no newer than its target's propagated time;
   then ``LinkNeighborLoader(time_attr="t", edge_label_time=...)`` on 5h's
   196,608 positives (each labelled with its own edge's time), binary with
   rejection, batch 1024, GraphSAGE 128 -> 256 -> 16: 6 batches (2 warm-up)
   by stage (negatives, hops, sample, feature gather, ``link_step``), the
   same check on every batch; 1 row-gather launch a batch, no sampler
   launch.
5n. disjoint sampling: ``NeighborLoader(disjoint=True)`` (batch 1024: levels
   of 1 / 11 / 121 slots a seed, 123,904 at the last) trains GraphSAGE over
   ``DisjointBatch.flat()`` for 6 batches (2 warm-up), each batch checked:
   every seed's levels a prefix chain without repeats, every sampled edge a
   true edge of its target, every map pointing at its neighbor in the
   seed's row; 2 sampler and 1 row-gather launches a batch.
5o. small-input agreement, sampling variants: on phase 4's graph, weighted,
   temporal and disjoint ``NeighborLoader`` batches on the card and on the
   CPU with the same uniforms and key words: seeds, rows, levels, maps and
   edge ids bit-equal over three batches, three f32 GraphSAGE steps' losses
   within 1e-4.
5p. mag-shaped set-up (``train_hetero``, ``benchmarks/model_bench.py``'s
   part B): 736,389 papers, 1,134,649 authors and 59,965 fields, three edge
   types into papers (cites, writes, rev_has_topic: 18,913,760 edges for
   seed 1), the 1,931,003 x 128 f32 table and paper labels (349 classes) on
   the card; then the same graph as a ``GraphStore`` / ``FeatureStore``
   (host seconds of each).
5q. the typed R-GCN block: RGCN 128 -> 256 -> 349 (3 relations, bf16
   input rows, Adam 1e-3), 1 warm-up and 3 timed blocks of 10 steps of 512
   paper seeds through ``hetero_multihop_batched`` with typed target
   segments (fanouts 8/8, 8/8, 4/4): per block the losses (finite), ms a
   step, sampled edges/s and peak memory; 6 sampler launches (2 hops x 3
   edge types) and 10 row-gather launches a block, no other kernel.  One
   more block stage by stage (sample, feature gather, model) with its level
   sizes checked (512 / 10,752 / 102,912 a step); then row 2 at each of
   that block's six hop calls and row 1 at its 102,912-id gather (to
   bf16): bit-equal to their plain versions, timed, with their bounds.
5r. the hetero loaders: ``NeighborLoader(input_nodes=("paper", ids))``
   (batch 512, shuffled) with typed target segments (``dedup=False``, 8
   batches, 2 warm-up), then deduplicated (6, 2 warm-up), R-GCN 128 -> 256 ->
   349 over the summed per-type features in bf16: per batch the loss
   (finite), ms, each stage (sample, feature join, labels, model) by CUDA
   events and host clocks, nodes and slots per level, peak memory; 6
   sampler launches and 3 row-gather launches (one per node type with
   ``x``) a batch.  After each, one more batch with rows 2 and 1 at its
   shapes (each hop call; the paper join, f32).
5s. the typed link batch: 196,608 author-writes-paper edges (a fixed draw)
   as positives, ``LinkNeighborLoader(edge_label_index=(("author", "writes",
   "paper"), ...))`` (binary negatives within the endpoint types, rejecting
   true edges, batch 512, deduplicated levels), an R-GCN encoder 128 -> 256
   -> 256 and ``train_link.link_step``: 6 batches (2 warm-up), as 5r; then
   rows 2 and 1 at one more batch's shapes.  Last, small-input agreement,
   hetero: on a 7,300-node mag-shaped graph, the typed block (3 steps of 64
   seeds), the typed and deduplicated loaders and the typed link loader (3
   batches each) on the card and on the CPU with the same uniforms and
   negatives: samples, gathered rows and feature dicts bit-equal, f32 losses
   within 1e-4.
5t. (run after 5o, before 5p: on phase 5's graph and 5b's stores) the
   distributed loader at full width, world 1 over NCCL (``tcp://localhost``):
   ``DistNeighborLoader`` (batch 1024, fanouts 10/10, shuffled; the graph
   sharded by ``DistGraph.from_global_csr`` of the store's CSR, the features
   and labels the store's tensors as one shard) and
   ``train_dist.dist_train_step`` (GraphSAGE 128 -> 256 -> 47, bf16, Adam
   1e-3), ``dedup`` on for 12 batches (2 warm-up), off for 6 (2): per batch
   the loss (finite), ms, sampled edges, nodes and slots per level, the
   collectives and host reads of the loader and of the step
   (``store/dist_array.py::EXCHANGES``), peak memory; per batch 2 sampler
   launches and 1 row-gather launch, no other kernel.  Then 3 batches stage
   by stage (each hop's seed routing, the owner's sample and the return
   routing; the whole sample, feature and label gathers, the step), and,
   with ``dedup``, rows 2 and 1 at one batch's calls (the owner's received
   rows at each hop; its f32 feature read): bit-equal to their plain
   versions, timed, with their bounds.  Then one batch through the
   rank-local mode (``put_local_edge_index`` of the whole COO, routed by
   ``store/edge_exchange.py``; host seconds of each part): its shard and
   batch equal to the global mode's bit for bit.
5u. the distributed link loader at world 1: ``DistLinkNeighborLoader`` on
   5h's 196,608 positives (binary, rejecting true edges, batch 1024,
   deduplicated levels), GraphSAGE 128 -> 256 -> 16, ``train_link.
   link_step``: 6 batches (2 warm-up), as 5t, and 3 more by stage
   (negatives, hops, sample, gathers, ``link_step``).
5v. checks: world-1 dist batches (``dedup`` on and off) against
   ``NeighborLoader`` batches on the same draws (the one-device sampler's
   uniforms at its valid targets, which at world 1 are the owner's rows),
   three batches each: levels, blocks, edge ids, features and the valid
   seeds' labels bit-equal (the dist pads' labels -1), and three Adam steps'
   losses equal; the same for ``DistLinkNeighborLoader`` against
   ``LinkNeighborLoader`` on the same negatives' candidates (seed layout,
   labels, features, ``link_step`` losses); on phase 4's graph, uniform,
   weighted and temporal ``DistNeighborLoader`` batches on the card (NCCL)
   and on the CPU (a gloo group of one rank) with the same CPU draws,
   bit-equal over three batches, and every temporal edge no newer than its
   target's propagated time.
5y. (run after 5v, in the same world of 1) the hierarchical gather: 5t's
   ``DistNeighborLoader`` (dedup on, 5b's stores) on a 1 x 1
   ``create_hierarchical_mesh`` (its node and device subgroups over NCCL),
   whose feature and label gathers take ``store/hierarchical.py``'s
   two-level gather, the owner reading through row 1: 3 batches bit-equal
   to the flat loader's on the same seed (samples, features, labels), 1
   row-1 and 2 sampler launches a batch, no other kernel; then
   ``HierarchicalDistArray.gather_with_stats`` of the last batch's deepest
   level equal to its features, the cross-node count 0; the loader's feature
   gather timed on both meshes, and row 1 at the owner's read (the level's
   distinct ids) timed beside its plain version and ``index_select`` with
   its byte bound.
5z. (run after 5y, on phase 5's graph and 5b's graph store) surface: the
   doctor (``doctor.smoke_check()`` on the card: one row-2 launch, its ring
   sample checked); the host library's ``degrees`` over the graph's
   121,124,824 neighbor ids and ``load_filelist_bytes`` of a 256,435,456-byte
   three-file list (written from the feature table's bytes) at offset 4,097
   (not 4 KiB aligned) across both boundaries, with 8 threads and with
   ``O_DIRECT``: each equal to its numpy version, timed (GB/s; the read is
   warm: the files were just written); ``profiling.trace`` around three 5b
   loader batches (dedup, batch 1024, fanouts 10/10, GraphSAGE 128 -> 256 ->
   47 in bf16, Adam 1e-3), each in a ``profiling.annotate`` region: the trace
   JSON names ``gather_rows_kernel`` 3 times and ``uniform_sample_groups`` /
   ``uniform_sample_rows`` 6 times, and the regions; ``PerformanceMeter``
   (2 warm-up, 10 timed) on the same step, beside 10 of its CUDA-event
   times; every one of these batches exactly 1 row-1 and 2 row-2 launches.
   Then ``utils/orbax_ckpt.py``'s DCP round trips at world 1 over NCCL:
   ``save_dist_array`` / ``restore_dist_array`` of 5b's f32 ``x`` (2,449,029
   x 128) as a ``DistArray``, and (run inside 5e, on its trained state)
   ``save_embedding`` / ``restore_embedding`` of 5e's lazy-Adam
   ``DistEmbedding`` (the table, m, v and t): seconds and GB/s each way,
   every tensor restored bit-equal.
5zz. (after 5z, the graph freed) examples at full width:
   ``cugraph_gnn_tpu_torch/examples/ogbn_convert.py --synthetic 2449029
   61859140 100 --parts 8`` (ogbn-products' node count, undirected edge
   count and feature width) into a temporary directory, deleted
   afterwards, then ``ogbn_train.py
   --epochs 1 --hidden-dim 256 --neighbors 10,10 --batch-size 1024`` on it:
   123,718,280 directed edges, F padded to 128, 1,435 train batches and 479
   valid and 479 test batches, each 1 row-1 and 2 row-2 launches; the epoch
   line, its train seconds and ms a batch, peak memory.  Then
   ``node_classification.py --dataset synthetic --epochs 2`` at its defaults
   (10,000 nodes, 100,000 edges, F = 100): 10 batches an epoch and 10 to
   evaluate, launches as above.  Then the twelve other scripts' ``main`` at
   the JAX scripts' defaults (``--epochs 1`` where the script has no
   accuracy gate; stdout kept): fraud detection, cached embeddings, R-GCN
   hetero, hetero link prediction (shared and ``--disjoint``), KG link
   classification, MovieLens, multichip, hetero dist (8 epochs) and dist
   full batch (60 epochs) over a world of one (NCCL), xgb (without
   scikit-learn ``main`` must raise ``ImportError`` and its encoder and
   export run alone), full batch (GCN, SAGE, R-GCN, GAT) and link
   prediction on a karate-format stand-in (``karate_standin``, a
   temporary file): each run's wall seconds, ms a
   batch, losses (finite), accuracy or AUC, peak memory and launches, exactly
   1 row-1 and 2 row-2 launches a homogeneous loader batch, a row-1 launch
   per node type and a row-2 launch per hop and edge type a hetero batch
   (none on MovieLens' key-based temporal hops), the cache's two reads, its
   writebacks and one row-3 dedup a cached-embedding step; row 9 alone for
   the dist full batch, row 4 alone for full-batch GCN, SAGE and R-GCN,
   row 5 and the one backward family ``backward_design`` picks for GAT.
   Last the new paths at full width, the scripts' own widths at their
   datasets' scale, each graph freed before the next: ``fraud_detection``
   ``main`` at Elliptic's 203,769 nodes (``--avg-degree 1 --feat-dim 165
   --epochs 1``: ~140 train and 199 export batches, then the downstream
   model the machine has), xgb's encoder and export at 203,769 nodes (its
   ``main`` where scikit-learn imports), and through the scripts' functions
   (2 warm-up and 5 timed steps each, per step its ms, loss, accuracy,
   nodes and slots per level, launches and peak memory): KG link
   classification at ogbl-wikikg2 (2,500,604 learned 256-wide entities,
   535 relations, 16,109,182 triples), MovieLens at ML-25M (162,541 users,
   62,423 movies, 25,000,095 ratings, both orientations timed), hetero link
   prediction at ogbn-mag (736,389 papers, 1,134,649 authors, 7,145,660
   writes, shared and disjoint) and R-GCN hetero at ogbn-mag (and 8,740
   institutions).
5w. (run after 5s, on 5p's mag graph and 5r's stores) the hetero dist
   loader at full width, world 1 over NCCL: the typed ``DistNeighborLoader``
   (512 paper seeds, fanouts 8/8, 8/8, 4/4, shuffled; every edge type
   sharded by ``HeteroDistGraph.from_sampling_graph`` on one even book, the
   features the stores' tables as one shard each) and ``train_dist.
   dist_train_step`` with R-GCN (128 -> 256 -> 349, bf16, Adam 1e-3) in
   ``train_hetero.RGCNEncoder``:
   6 batches (2 warm-up), per batch the loss (finite), ms, nodes and slots
   per level, the collectives and host reads of the loader and of the step,
   peak memory; per batch 6 sampler launches (a hop samples every edge type
   on the owner) and 3 row-gather launches (one per node type), no other
   kernel.  Then 3 batches stage by stage (each hop's routing, each edge
   type's sample on the owner, the return; each type's feature gather, the
   labels, the step), and one more batch with rows 2 and 1 at its shapes.
5x. the hetero dist link loader: ``DistLinkNeighborLoader`` with 5s's
   author-writes-paper positives as a typed ``edge_label_index`` (binary,
   rejecting true edges, batch 512), an R-GCN encoder 128 -> 256 -> 256 and
   ``train_link.link_step``: 6 batches (2 warm-up), as 5w; one more batch
   with rows 2 and 1 at its shapes.  Then the checks: world-1 hetero dist
   batches against the typed ``NeighborLoader``'s (dedup) on the same draws
   (the one-device uniforms at the valid targets), three batches: levels,
   blocks, edge ids, each type's features and the valid seeds' labels
   bit-equal, and three Adam steps' losses equal; 5x's batches against
   ``LinkNeighborLoader``'s on the same negatives' candidates and draws
   (seed layout, labels, features, ``link_step`` losses); on a 7,300-node
   mag-shaped graph, uniform, weighted and temporal hetero dist batches on
   the card (NCCL) and on the CPU (a gloo group of one rank) with the same
   CPU draws, bit-equal over three batches, and every temporal edge no
   newer than its target's propagated time.
6. full-batch data: the banded graph of ``train_full`` (2,449,029 nodes, 12
   in-band sources within +-256 and 1 uniform source per node: 31,837,377
   edges) and its ``FullBatchGraph`` (reorder "none", R = 256) with the
   transpose; host seconds of each build.
7. full-batch kernels: the slab SpMM (``slab_spmm``: band, fallback edges,
   'mean' divide and cast in one launch) and its band-only mode
   (``slab_spmm_band``), and the CSR SpMM kernel on the fallback edges, over
   the graph and its transpose, on f32 and bf16 x at F = 128 and 256,
   against the float32 sums of their plain versions: within 1e-5 absolute
   plus 1e-5 relative to the sum of the terms' magnitudes (the sum order
   differs, and the transpose's hub rows sum hundreds of terms), a bf16
   output within one bf16 ulp more; each launched twice, bit for bit equal
   (the CSR kernel in accumulate mode into a float32 output).  Then times at
   the three calls of one training step (bf16 x: graph F = 128 'mean',
   graph F = 256 'mean', transpose F = 256 'sum') of kernel, plain version
   and ``torch.sparse.mm`` over the same edges (for ``slab_spmm`` the whole
   graph's CSR, values 1/degree for 'mean'), with the byte and operation
   counts that bound them.
8. small-input agreement, full batch: GraphSAGE and GCN each trained for
   three f32 steps on the card and on the CPU from the same weights; losses
   within 1e-4.
9. full-batch train: GraphSAGE, then GCN (F = 128, hidden 256, 47 classes,
   bf16 activations, f32 params, Adam 5e-3), 1 warm-up and 3 timed steps
   each; finite losses, and 3 ``slab_spmm`` launches per step (two forward
   aggregations and one backward: layer 0's input needs no gradient), no
   band-only or CSR-kernel launch.  Then one step timed stage by stage.
9b. full-batch GIN (128 -> 256 -> 47, MLP width 256, bf16, Adam 5e-3), 1
   warm-up and 3 timed steps: finite losses, per step 3 ``slab_spmm``
   launches (2 'sum' over the graph forward, 1 'sum' over the transpose
   backward) and no other kernel; one step stage by stage; then row 4's
   'sum' over the graph at GIN's two forward shapes (F = 128 and 256, bf16
   and f32 x) against its plain version (phase 7's tolerance), twice bit for
   bit, timed beside ``torch.sparse.mm`` with its byte bound.
9c. full-batch R-GCN: phase 6's graph split into 2 relations by endpoint
   parity (``examples/full_batch_training.py``), a ``RelationalFullBatch``
   (reorder "none", R = 256; host seconds), small-input agreement (3 f32
   steps card against CPU on 3,000 nodes, losses within 1e-4), then RGCN
   128 -> 256 -> 47 (bf16 input, Adam 5e-3), 1 warm-up and 3 timed steps:
   finite losses, per step 6 ``slab_spmm`` launches (2 relations x 2 layers
   forward, each relation's transpose for layer 1's backward; layer 0's
   input needs no gradient), each call's relation, orientation, reduction,
   width and dtype checked, no other kernel; one step stage by stage; row 4
   at relation 0's three calls against its plain version (phase 7's
   tolerance), twice bit for bit, timed beside ``torch.sparse.mm``.
10. attention pairs: the graph's (R = 256, bit planes) and a second
    ``FullBatchGraph`` of the same graph at R = 512 (no bit planes: ``t_ell``),
    each with the band CSR by source; host seconds of each, the bytes of
    each transpose index and the host seconds of the band CSR's build; the
    backward kernels each pair takes at both layers' widths
    (``slab_attn_grad.backward_design``, decided by shape): the window
    kernels for both, or the phase fails.
11. attention kernels at full width: the forward and backward kernels on
    both pairs at GAT's two layers' shapes (H=4, F=64 and H=1, F=47, f32 x)
    plus one bf16-x forward, against their plain versions: within 1e-5
    absolute plus 1e-5 of the same sums over the terms' magnitudes (|x|,
    and for the backward |g| and -|t|: every term's absolute value; the
    kernels sum in another order and factor the dot products out of the
    sums), m equal and s within 1e-5; each kernel launched twice, bit for
    bit equal; the backward's design and chunk width.  Then CUDA-event
    times of kernel and plain version at the main path's calls, with the
    byte and operation counts that bound them (the backward's transpose
    index counted as the design reads it: the band CSR by source for the
    window kernels, t_ell's real entries for warp per node; no single
    PyTorch call computes the fused attention: library_ms is null).
11b. the one-pass backward's phase probe (row 15 of the TPU-kernel table,
    ``slab_attn_grad.onepass_bwd_probe``) on the R = 256 pair at both
    layers' shapes: with every phase on, bit for bit the kernel's result;
    then times of the dst pass and the src pass alone, each also without
    expf, without the dot/FMA work and with neither (the same memory
    traffic).  Then on the R = 512 pair's band CSR: every phase on, bit for
    bit rows 7 and 8's result; times of the kernel (256-row tiles) by pass.
    A few seconds; ``--probe`` runs it alone on phase 6's graph.
11c. the attention backward's bfloat16 compute mode (rows 6-8) and its
    warp-per-node design: a third pair of the graph at R = 768 (``t_ell``;
    its 3R-row window does not fit the backward's shared memory, so
    ``backward_design`` must give warp per node at both layers' widths, or
    the phase fails; host seconds).  The path, counted from zero for each
    run: ``differentiable_slab_attention_mh`` (H=4, F=64) and
    ``differentiable_slab_attention`` (H=1, F=47), forward then backward
    through autograd, with ``bwd_compute_dtype`` bfloat16 on the R = 256,
    512 and 768 pairs and float32 on R = 768: finite outputs and gradients,
    per run 2 forward launches and one backward launch a layer
    (``onepass_bwd`` at R = 256, ``slab_attention_bwd`` /
    ``slab_attention_bwd_mh`` beyond), no other kernel.  Then each call
    against its plain version with the same ``compute_dtype`` (phase 11's
    tolerance; the forward too at R = 768), twice bit for bit, a bfloat16
    result unequal to the float32 one; CUDA-event times of kernel (the
    bfloat16 mode beside the float32 mode on the same inputs) and plain
    version, with the byte bound (both modes move the same bytes).
12. small-input agreement, GAT: three f32 full-batch steps on the card and
    on the CPU from the same weights; losses within 1e-4.
13. full-batch GAT train (``gat4h``: 4 heads of 64, then 47 classes, f32,
    Adam 5e-3), 1 warm-up and 3 timed steps at R = 256; finite losses and,
    per step, 2 forward attention launches and 2 ``onepass_bwd`` launches
    (layer 0's input ``wx`` needs a gradient: ``lin`` has parameters), no
    other kernel; then one step timed stage by stage.  The same at R = 512:
    per step 2 forward launches, 1 ``slab_attention_bwd`` (layer 1, H = 1)
    and 1 ``slab_attention_bwd_mh`` (layer 0, H = 4).
14. shard kernels at a 4-rank geometry, in this one process: a banded graph
    of 100,000 nodes (3 in-band and 1 uniform source each: ~1/4 fallback
    edges) split into 4 row shards as ``DistFullBatchGraph`` splits it
    (R = 256 with bit planes; R = 512 and 768 with ``t_ell``); each shard's
    inputs are its tables, built from the whole arrays as the exchanges
    build them: its rows, an R-row halo on each side (zeros past the ends)
    and the remote rows its fallback edges read, so the kernels run with
    nonzero offsets, real halos and remote rows.  Every shard wrapper (rows
    9-14: the whole SpMM on each shard's table, 'mean' over the graph and
    'sum' over its transpose, and its band-only mode, at F = 128 bf16 and
    F = 256 f32; the whole attention forward over table A and backward over
    tables A and B at GAT's two layers' shapes) against its plain version,
    and against the whole graph's single-graph kernel on the shard's rows
    (the whole ``slab_spmm`` and attention; band edges only for the
    band-only mode): within 1e-5 absolute plus 1e-5 of the same sums over
    the terms' magnitudes, a bf16 output one bf16 ulp more; the SpMM and
    each attention call launched twice, bit for bit equal; every shard
    reads remote rows (each attention table too); the backward takes the
    window kernels at R = 256 and 512 and the warp-per-node kernels at R =
    768, or the phase fails.
15. row-sharded training at world size 1 over NCCL (``tcp://localhost``):
    ``DistFullBatchGraph`` of phase 6's graph (R = 256, then R = 512);
    GCN (bf16 activations) and ``gat4h``, 1 warm-up and 3 timed
    ``dist_full_batch_step``s each at R = 256 and GAT's at R = 512;
    finite losses; per step 3 launches of row 9 (the whole SpMM: band,
    fallback, divide and cast) (GCN), and 1 of row 13, 1 of row 10 and 2 of
    row 11 (GAT, R = 256) or 1 each of rows 13, 10, 14 and 12 (R = 512),
    each attention call the whole function (band and fallback edges), no
    other kernel (none of the CSR kernel); one step of each timed stage by
    stage (GAT at both R).  Reproducibility: GCN and GAT each take one step twice
    from the same weights and inputs; losses and every gradient bit for bit
    equal (every sum of the sharded step has a fixed order).  Agreement:
    one float32 GCN step and one GAT step from the same
    weights through ``full_batch_step`` on the single-device graph and
    through ``dist_full_batch_step`` (after phase 16): losses within 1e-5
    relative, each gradient tensor within 1e-3 of its own largest entry,
    the parameters after the step within 1e-4 where the gradient is at least
    1e-5 (Adam's first update, lr * g / (|g| + 1e-8), turns sum-order noise
    in a small g into up to lr).
16. rows 9-14 at the world-1 path's calls: each kernel against its plain
    version on the same inputs (the tolerance of phase 14; row 9 on bf16
    and f32 x) and launched twice, bit for bit equal (rows 10-14 also bit
    for bit equal to the path's own call); then CUDA-event times of kernel,
    plain version and, for row 9, ``torch.sparse.mm`` over the shard's
    whole CSR into its table and the band-only mode's time, for rows 10-14
    the whole call (halos, remote rows, launch) and its halo and remote-row
    exchanges, with the byte and operation counts of the whole function
    that bound them (an ELL's bytes are its real entries, not its -1
    padding; the tables' parts and tails, both fallback CSRs).  Where a
    sharded SpMM call's time goes: GCN layer 1's forward (whole call, halo
    exchange, remote-row exchange, kernel).
17. the ``kernels`` summary line (rows 1-14, phase 11c's rows after row 8:
    rows 6-8 in the bfloat16 mode and rows 7 and 8 on warp per node in both
    modes, each counting its run's launches; then the probe, which the
    main path launches no time; rows 1 and 2 count the launches of phases
    5, 5b, 5e, 5f, 5h, 5j, 5l-5n, 5q-5s, 5t-5u, 5w-5y, 5z and 5zz (rows 3-6
    and 9 also 5zz's, under ``launches_examples``), split by
    path (the dist paths' also timed at a dist batch's calls, beside their
    ``gap_ms_dist``; the hetero dist paths' at their own calls, beside
    ``gap_ms_hetero_dist``; row 1 at 5y's owner read) (row 1 also timed at
    5e's two shapes, at 5h's and at each hetero path's; row 2 also at 5h's
    hops and at each hetero path's hop calls), row 4 those of 9b and 9c
    beside GIN's 'sum' calls and R-GCN's relation calls,
    row 2 also carries its time per hop and its sector floor, at
    phase 3's block hops and at phase 5b's loader hops, its launches split
    by path, and a gap that prices each path's launches at its own hops;
    rows 5-14 also carry their timed calls, the
    gap launches * (ms - bound) / calls and, for the backward rows, the
    design each layer took; row 9 also the band-only mode's time at the same
    calls, rows 10-14 the whole calls' and their exchanges'; row 3's numbers
    are phase 7's one-card fallback calls (no full-batch path launches it),
    its embedding launches and phase 5g's numbers under
    ``launches_embedding`` and ``*_dedup``), and last the ``ok`` line.

Every JSON line carries the card's name and power limit, and its seconds since
the start (``t_s``).
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time


def _sampler_bytes(indptr, seeds, k, out):
    """The bytes the fused sampler must move for one call, counted two ways:
    (the byte bound: each input read once at its size, each output written
    once; the sector floor: the same, but 32 bytes for each distinct
    ``indptr`` and ``indices`` sector the call reads, counted on the host
    from the seeds and the sampled positions).  Both count the uniforms of
    the seeds of degree > k only, and ``indices`` reads where a slot is
    sampled."""
    import numpy as np

    n = indptr.numel() - 1
    sd = seeds.cpu().numpy().astype(np.int64)
    valid = sd >= 0
    ip = indptr.cpu().numpy()
    lo = np.minimum(sd[valid], n)
    hi = np.minimum(sd[valid] + 1, n)
    deg = ip[hi] - ip[lo]
    e = out.edge_ids.cpu().numpy()
    e = e[e >= 0].astype(np.int64)
    coalesced = 4 * sd.size + 4 * k * int((deg > k).sum()) + (8 * k + 4) * sd.size
    nbytes = coalesced + 8 * int(valid.sum()) + 4 * e.size
    sectors = np.unique(np.concatenate([lo, hi]) // 8).size + np.unique(e // 8).size
    return nbytes, coalesced + 32 * sectors


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()

H100_F32_OPS = 67e12   # H100 SXM float32 outside the tensor cores (data sheet)


def _loader_step(model, opt, batch) -> "torch.Tensor":
    """One Adam step on a loader batch, the examples' step: masked mean
    cross-entropy of the valid seeds against the batch's labels.  Returns
    the loss (f32, on the device)."""
    from cugraph_gnn_tpu_torch.examples.common import loader_step

    return loader_step(model, opt, batch)


def loader_path(dev, emit, graph, small_cpu, counters, cuda_ms, hbm):
    """Phases 5b and 5c (see the module docstring).  Returns each kernel's
    launches over the loader runs of phase 5b, and the sampler's timed rows
    at a loader batch's two hops."""
    import numpy as np
    import torch

    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
    from cugraph_gnn_tpu_torch.loader import NeighborLoader, NodeBatch
    from cugraph_gnn_tpu_torch.loader.node_loader import gather_node_features
    from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
        fused_uniform_sample,
        fused_uniform_sample_ref,
    )
    from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler

    # -- 5b. the loader path at full width ---------------------------------
    t0 = time.perf_counter()
    n = graph.num_nodes
    indptr = graph.indptr.cpu().numpy()
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    # edge (neighbor -> row): the store's reversed CSR is the graph's CSR
    gs = GraphStore(device=dev)
    gs.put_edge_index((graph.indices.cpu().numpy(), rows), ("node", "to", "node"),
                      num_nodes=(n, n))
    del rows
    t1 = time.perf_counter()
    csr = gs.finalize().homogeneous_csr()
    fs = FeatureStore(device=dev)
    fs["x"] = graph.feats
    fs["y"] = graph.labels
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not (torch.equal(csr[0], graph.indptr) and torch.equal(csr[1], graph.indices)):
        raise AssertionError("the graph store's reversed CSR differs from the graph's CSR")
    emit({"phase": "loader_stores", "setup_s": t2 - t0, "put_edge_index_s": t1 - t0,
          "finalize_and_features_s": t2 - t1, "nodes": n, "edges": int(csr[1].numel())})
    gs_csr = (graph.indptr, graph.indices)   # equal to the store's, checked above
    del csr

    torch.manual_seed(0)
    model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, T.CLASSES, num_layers=len(T.FANOUTS),
                      dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    total = {fn.__name__: 0 for fn in counters}
    for dedup, batches, warmup in ((True, 12, 2), (False, 6, 2)):
        loader = NeighborLoader((fs, gs), num_neighbors=T.FANOUTS, batch_size=T.BATCH,
                                shuffle=True, dedup=dedup)
        batch_iter = iter(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        ms = []
        for i in range(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(batch_iter)
            loss = _loader_step(model, opt, batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            if i >= warmup:
                ms.append(dt)
            loss = float(loss)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite loader loss {loss} (dedup={dedup})")
            caps = [int(lv.numel()) for lv in batch.sample.levels]
            emit({"phase": "loader_train", "dedup": dedup, "batch": i,
                  "warmup": i < warmup, "loss": loss, "ms": dt,
                  "sampled_edges": int(sum(hop.mask.sum() for hop in batch.sample.hops)),
                  "nodes_per_level": [int(c) for c in batch.sample.level_counts],
                  "slots_per_level": caps,
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
        launches = {fn.__name__: fn.launches for fn in counters}
        want = {**{fn.__name__: 0 for fn in counters},
                "gather_rows": batches, "fused_uniform_sample": 2 * batches}
        emit({"phase": "loader_launch_counts", "dedup": dedup, "batches": batches,
              "launches": launches, "expected": want,
              "ms_per_batch": sum(ms) / len(ms), "batches_timed": len(ms)})
        if launches != want:
            raise AssertionError(f"loader kernel launches {launches}, expected {want}")
        for k, v in launches.items():
            total[k] += v
        # one more batch stage by stage (CUDA events; each stage synchronised)
        seeds = torch.as_tensor(loader.input_nodes[:T.BATCH].astype(np.int32), device=dev)
        ev = {}

        def timed(name, fn):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            r = fn()
            b.record()
            torch.cuda.synchronize()
            ev[name] = a.elapsed_time(b)
            return r

        sample = timed("sample", lambda: loader.sampler.sample(seeds))
        x = timed("feature_gather", lambda: gather_node_features(fs, gs, "x", sample.input_nodes))
        y = timed("label_gather", lambda: fs.get_tensor("", "y", ids=seeds))
        timed("model", lambda: _loader_step(model, opt, NodeBatch(sample, x, y, seeds, seeds,
                                                                   T.BATCH)))
        emit({"phase": "loader_stages", "dedup": dedup, "ms": ev})
        if dedup:
            # the sampler at this batch's two hops (1,024 and 11,264 slots, as
            # with dedup=False), so that row 2 prices the loader's launches
            # at their own size
            g_u = torch.Generator(device=dev).manual_seed(2)
            sampler_rows = []
            for h, (sd, kf) in enumerate(zip(sample.levels, T.FANOUTS)):
                u = torch.rand((sd.numel(), kf), generator=g_u, device=dev)
                got = fused_uniform_sample(gs_csr[0], gs_csr[1], sd, u, kf)
                want = fused_uniform_sample_ref(gs_csr[0], gs_csr[1], sd, u, kf)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"sampler at the loader's hop {h} differs "
                                         f"from the plain version")
                nbytes, floor_bytes = _sampler_bytes(gs_csr[0], sd, kf, want)
                row = {"kernel": "uniform_sample", "path": "loader", "hop": h,
                       "seeds": sd.numel(), "k": kf,
                       "ms": cuda_ms(lambda: fused_uniform_sample(
                           gs_csr[0], gs_csr[1], sd, u, kf)),
                       "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
                       "sector_floor_ms": floor_bytes / hbm * 1e3, "bit_equal": True}
                emit(row)
                sampler_rows.append(row)
        del loader, batch_iter, batch, sample, x, y

    # -- 5c. NeighborSampler(dedup=True): card against CPU -------------------
    g_cpu = torch.Generator().manual_seed(6)
    seeds = torch.randint(0, small_cpu.num_nodes, (64,), generator=g_cpu, dtype=torch.int32)
    seeds[::9] = -1
    for caps in (None, (300, 1500)):
        kw = dict(dedup=True, max_unique_per_hop=caps)
        s_cpu = NeighborSampler(small_cpu.indptr, small_cpu.indices, (10, 10), device="cpu", **kw)
        s_gpu = NeighborSampler(small_cpu.indptr, small_cpu.indices, (10, 10), device=dev, **kw)
        lv = s_cpu.level_caps(seeds.numel())
        us = [torch.rand((lv[h], 10), generator=g_cpu) for h in range(2)]
        a = s_cpu.sample(seeds, u=us)
        b = s_gpu.sample(seeds, u=us)
        same = all(torch.equal(x, y.cpu()) for x, y in
                   zip(a.levels + a.level_counts + [a.seed_count],
                       b.levels + b.level_counts + [b.seed_count]))
        same &= all(torch.equal(x, y.cpu()) for ha, hb in zip(a.hops, b.hops)
                    for x, y in zip(ha[:3], hb[:3]))
        if not same:
            raise AssertionError(f"NeighborSampler(dedup=True, caps={caps}): card and CPU differ")
        emit({"phase": "small_input_agreement_sampler", "dedup": True, "caps": caps,
              "slots_per_level": lv, "nodes_per_level": [int(c) for c in a.level_counts],
              "equal": True})
    return total, sampler_rows, gs


class _Stages:
    """Device (CUDA events) and host-clock milliseconds of named stages:
    ``wrap`` replaces an attribute by a call timed between two
    synchronisations, so that nested stages time their own work."""

    def __init__(self):
        self.ms, self.host_ms, self.calls = {}, {}, {}

    def run(self, stage, fn, *args, **kw):
        import torch

        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn(*args, **kw)
        b.record()
        torch.cuda.synchronize()
        self.host_ms[stage] = self.host_ms.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3
        self.ms[stage] = self.ms.get(stage, 0.0) + a.elapsed_time(b)
        self.calls[stage] = self.calls.get(stage, 0) + 1
        return out

    def wrap(self, obj, name, stage):
        fn = getattr(obj, name)
        setattr(obj, name, lambda *a, **kw: self.run(stage, fn, *a, **kw))

    def take(self):
        out = {"ms": self.ms, "host_ms": self.host_ms, "calls": self.calls}
        self.ms, self.host_ms, self.calls = {}, {}, {}
        return out


def _count_writebacks(cache):
    """Make ``cache`` count its writebacks that read slots (each one launch
    of the row gather) in ``cache.writeback_reads``."""
    inner = cache._writeback
    cache.writeback_reads = 0

    def counted(s, w, ids):
        cache.writeback_reads += int(len(ids) > 0)
        return inner(s, w, ids)

    cache._writeback = counted


def _emb_step(model, opt, emb, sample, seeds, labels, lr, stages=None):
    """One step of the example's loop: the rows of the sample's input nodes
    through ``emb`` (a ``DistEmbedding``'s lookup, a ``CachedHostEmbedding``'s
    gather) plus a tap, the model's Adam step, then the rows' gradients (the
    tap's) applied by the embedding's sparse optimizer; with ``stages`` (a
    ``_Stages``) the three parts timed as "lookup", "model" and "apply".
    Returns the loss (a float: the step synchronises) and the tap's
    gradient."""
    from cugraph_gnn_tpu_torch.loader import NodeBatch

    def run(stage, fn, *args):
        return fn(*args) if stages is None else stages.run(stage, fn, *args)

    tap = emb.make_tap(sample.input_nodes.shape[0])
    if hasattr(emb, "lookup"):
        x = run("lookup", emb.lookup, tap, sample.input_nodes)
    else:
        x = run("lookup", emb.gather, sample.input_nodes) + tap
    y = labels[seeds.clamp(min=0).long()]
    loss = run("model", _loader_step, model, opt,
               NodeBatch(sample, x, y, seeds, seeds, seeds.numel()))
    emb.add_gradients(sample.input_nodes, tap.grad)
    run("apply", emb.apply_gradients, lr)
    return float(loss), tap.grad


def _bits_equal(a, b) -> bool:
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))


EMB_DIM, EMB_LR = 128, 3e-3


def embedding_paths(dev, emit, graph, small_cpu, counters, cuda_ms, hbm, gs):
    """Phases 5d-5g (see the module docstring).  Returns each kernel's
    launches on each new path and row 3's numbers at the dedup's shape."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch.data import FeatureStore
    from cugraph_gnn_tpu_torch.embedding import CachedHostEmbedding, DistEmbedding, HostManagedCache
    from cugraph_gnn_tpu_torch.embedding import cached as cached_mod
    from cugraph_gnn_tpu_torch.embedding import embedding as emb_mod
    from cugraph_gnn_tpu_torch.loader import NeighborLoader
    from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows_ref
    from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import csr_spmm_ref
    from cugraph_gnn_tpu_torch.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import NeighborSampler
    from cugraph_gnn_tpu_torch.store.dist_array import DistArray, segment_add
    from cugraph_gnn_tpu_torch.utils import distributed as D

    names = [fn.__name__ for fn in counters]

    def reset():
        for fn in counters:
            fn.launches = 0

    def read():
        return {fn.__name__: fn.launches for fn in counters}

    def expect(gather, sample, dedup):
        return {**{n: 0 for n in names}, "gather_rows": gather,
                "fused_uniform_sample": sample, "csr_spmm": dedup}

    launches = {}
    mesh = D.init(init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        _require_nccl(mesh)
        cpu_mesh = create_store_mesh("cpu", group=dist.new_group([0], backend="gloo"))

        # -- 5d. small input, embeddings: card against CPU ---------------------
        t0 = time.perf_counter()
        dim, n_small, batch = 32, small_cpu.num_nodes, 64
        host0 = (0.05 * np.random.default_rng(7).standard_normal((n_small, dim))).astype(
            np.float32)
        g_u = torch.Generator().manual_seed(8)
        seeds_s = [torch.randint(0, n_small, (batch,), generator=g_u, dtype=torch.int32)
                   for _ in range(3)]
        s_cpu = NeighborSampler(small_cpu.indptr, small_cpu.indices, (10, 10), device="cpu")
        s_gpu = NeighborSampler(small_cpu.indptr, small_cpu.indices, (10, 10), device=dev)
        lv = s_cpu.level_caps(batch)
        us = [[torch.rand((lv[h], 10), generator=g_u) for h in range(2)] for _ in range(3)]
        report = {}
        for kind in ("cached", "dist"):
            sides = {}
            for where, sampler, dmesh in (("cpu", s_cpu, cpu_mesh), ("card", s_gpu, mesh)):
                d = torch.device("cpu") if where == "cpu" else dev
                torch.manual_seed(9)
                model = GraphSAGE(dim, 32, 5, device="cpu").to(d)
                opt = torch.optim.Adam(model.parameters(), lr=1e-3)
                if kind == "cached":
                    emb = CachedHostEmbedding(host0.copy(), optimizer="adagrad", capacity=256,
                                              ways=8, device=d)
                else:
                    emb = DistEmbedding(DistArray.from_array(host0, dmesh),
                                        optimizer="lazy_adam")
                losses, metas = [], []
                for i in range(3):
                    smp = sampler.sample(seeds_s[i], u=us[i])
                    loss, _ = _emb_step(model, opt, emb, smp, seeds_s[i].to(d),
                                        small_cpu.labels.to(d), EMB_LR)
                    losses.append(loss)
                    if kind == "cached":
                        c = emb.cache
                        metas.append((c.tags.copy(), c.freq.copy(), c.modified.copy(),
                                      c.hits, c.misses))
                if kind == "cached":
                    emb.flush()
                    table, state = emb.host_table, emb._state
                else:
                    table = emb.table.to_global().numpy()
                    state = {k: v.cpu().numpy() for k, v in emb._state.items()}
                sides[where] = (losses, metas, table, state)
            (lc, mc, tc, sc), (lg, mg, tg, sg) = sides["cpu"], sides["card"]
            loss_diff = max(abs(a - b) for a, b in zip(lc, lg))
            meta_equal = all(all(np.array_equal(np.asarray(x), np.asarray(y))
                                 for x, y in zip(a, b)) for a, b in zip(mc, mg))
            table_diff = float(np.abs(tc - tg).max())
            state_diff = max([float(np.abs(sc[k] - sg[k]).max()) for k in sc] or [0.0])
            if not (loss_diff <= 1e-4 and meta_equal and table_diff <= 1e-5
                    and state_diff <= 1e-5):
                raise AssertionError(f"{kind} embedding, card vs CPU: losses {loss_diff}, "
                                     f"metadata equal {meta_equal}, table {table_diff}, "
                                     f"state {state_diff}")
            report[kind] = {"max_loss_abs_diff": loss_diff, "metadata_equal": meta_equal,
                            "table_max_abs_diff": table_diff,
                            "state_max_abs_diff": state_diff}
        # two apply_gradients from one state, on the card: bit for bit
        smp = s_gpu.sample(seeds_s[0], u=us[0])
        g = torch.Generator(device=dev).manual_seed(10)
        grads = torch.randn((smp.input_nodes.numel(), dim), generator=g, device=dev)
        runs = {}
        for kind in ("cached", "dist"):
            out = []
            for _ in range(2):
                if kind == "cached":
                    emb = CachedHostEmbedding(host0.copy(), optimizer="adagrad", capacity=256,
                                              ways=8, device=dev)
                    emb.gather(smp.input_nodes)
                else:
                    emb = DistEmbedding(DistArray.from_array(host0, mesh),
                                        optimizer="lazy_adam")
                for _ in range(2):
                    emb.add_gradients(smp.input_nodes, grads)
                    emb.apply_gradients(EMB_LR)
                if kind == "cached":
                    emb.flush()
                    out.append([emb.host_table] + list(emb._state.values()))
                else:
                    out.append([emb.table.data] + [emb._state[k] for k in sorted(emb._state)])
            runs[kind] = all(_bits_equal(a, b) for a, b in zip(*out))
        if not all(runs.values()):
            raise AssertionError(f"two apply_gradients from one state differ: {runs}")
        emit({"phase": "small_input_agreement_embeddings", "steps": 3, "nodes": n_small,
              "dim": dim, **report, "loss_tolerance": 1e-4, "table_state_tolerance": 1e-5,
              "apply_bit_equal": runs, "seconds": time.perf_counter() - t0})

        # -- 5e. embedding training at full width ------------------------------
        n = graph.num_nodes
        t0 = time.perf_counter()
        host = np.random.default_rng(0).standard_normal((n, EMB_DIM), dtype=np.float32)
        host *= np.float32(0.05)
        initial = host.copy()
        t_table = time.perf_counter() - t0
        sampler = NeighborSampler(graph.indptr, graph.indices, T.FANOUTS, device=dev)
        gen = torch.Generator(device=dev).manual_seed(11)
        path_launches = {}

        def train(kind, emb, warmup, timed):
            torch.manual_seed(0)
            model = GraphSAGE(EMB_DIM, T.HIDDEN, T.CLASSES, num_layers=len(T.FANOUTS),
                              dtype=torch.bfloat16, device=dev)
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            st = _Stages()
            dedup_fn = emb_mod.dedup_ids_grads
            c = emb.cache if kind == "cached" else None
            if c is not None:
                # inside "lookup" and "apply": the host plan, the writeback of
                # dirty slots inside the upload + combine, the state streams,
                # the optimizer and the cache's update
                _count_writebacks(c)
                for name, stage in (("_plan", "plan_host"), ("_apply_plan", "upload_combine"),
                                    ("_writeback", "writeback"), ("update", "cache_update")):
                    st.wrap(c, name, stage)
                for name, stage in (("_state_rows", "state_stream_up"),
                                    ("_store_state", "state_stream_down"),
                                    ("_update_fn", "optimizer")):
                    st.wrap(emb, name, stage)
                st.wrap(cached_mod, "dedup_ids_grads", "dedup")
            else:
                st.wrap(emb_mod, "dedup_ids_grads", "dedup")
            touched = np.zeros(n, bool)
            ms, total = [], {k: 0 for k in names}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            try:
                for i in range(warmup + timed):
                    seeds = torch.randint(0, n, (T.BATCH,), generator=gen, device=dev,
                                          dtype=torch.int32)
                    if c is not None:
                        before = (c.hits, c.misses, c.uploaded, c.written_back,
                                  c.writeback_reads)
                    torch.cuda.synchronize()
                    reset()
                    t1 = time.perf_counter()
                    smp = st.run("sample", sampler.sample, seeds, generator=gen)
                    loss, grad = _emb_step(model, opt, emb, smp, seeds, graph.labels, EMB_LR,
                                           stages=st)
                    torch.cuda.synchronize()
                    dt = (time.perf_counter() - t1) * 1e3
                    got = read()
                    if i >= warmup:
                        ms.append(dt)
                    if not math.isfinite(loss):
                        raise AssertionError(f"non-finite {kind} embedding loss {loss}")
                    ids = smp.input_nodes.cpu().numpy()
                    touched[ids[ids >= 0]] = True
                    stages = st.take()
                    row = {"phase": "embedding_train", "path": kind, "step": i,
                           "warmup": i < warmup, "loss": loss, "ms": dt,
                           "input_nodes": int((ids >= 0).sum()),
                           "max_memory_allocated": torch.cuda.max_memory_allocated(),
                           "stages": stages, "launches": got}
                    if c is not None:
                        hits, misses, up, wb, reads = (
                            a - b for a, b in zip((c.hits, c.misses, c.uploaded,
                                                   c.written_back, c.writeback_reads), before))
                        want = expect(2 + reads, 2, 1)
                        row.update(hit_rate=hits / max(hits + misses, 1), rows_uploaded=up,
                                   rows_written_back=wb, writeback_reads=reads)
                    else:
                        want = expect(1, 2, 2)
                    row["expected"] = want
                    emit(row)
                    if got != want:
                        raise AssertionError(f"{kind} embedding step {i}: launches {got}, "
                                             f"expected {want}")
                    for k, v in got.items():
                        total[k] += v
            finally:
                setattr(emb_mod, "dedup_ids_grads", dedup_fn)
                setattr(cached_mod, "dedup_ids_grads", dedup_fn)
            path_launches[kind] = total
            return ms, touched, smp, grad

        t0 = time.perf_counter()
        emb = CachedHostEmbedding(host, optimizer="adagrad", cache_ratio=0.2, ways=8,
                                  device=dev)
        c = emb.cache
        emit({"phase": "embedding_setup", "path": "cached", "rows": n, "dim": EMB_DIM,
              "table_bytes": host.nbytes, "table_draw_s": t_table,
              "capacity": int(n * 0.2), "sets": c.sets, "ways": c.ways,
              "slots": c.sets * c.ways, "cache_bytes": c.rows.numel() * 4,
              "host_state_bytes": sum(v.nbytes for v in emb._state.values()),
              "setup_s": time.perf_counter() - t0})
        ms, touched, smp, grad = train("cached", emb, 2, 10)
        # row 1 at the cache's slot read: the last step's input nodes at the
        # slots the metadata gives them (read, not planned), f32 out
        ids_np = smp.input_nodes.cpu().numpy().astype(np.int64)
        sv = c._set_of(np.maximum(ids_np, 0))
        eq = c.tags[sv] == ids_np[:, None]
        hit = eq.any(1) & (ids_np >= 0)
        slot = torch.as_tensor(np.where(hit, sv * c.ways + eq.argmax(1), -1), device=dev)
        read_rows_at = {"cache_read": _gather_row(emit, c._flat, slot, int(hit.sum()), cuda_ms,
                                                  hbm, "cached embedding: cache slots")}
        t0 = time.perf_counter()
        reset()
        emb.flush()
        flush_reads = read()["gather_rows"]
        flush_s = time.perf_counter() - t0
        untouched_equal = _bits_equal(host[~touched], initial[~touched])
        fresh = HostManagedCache(host, c.sets * c.ways, ways=c.ways, device=dev)
        ids = smp.input_nodes
        same_rows = _bits_equal(emb.gather(ids), fresh.gather(ids))
        emit({"phase": "embedding_train_summary", "path": "cached", "steps_timed": len(ms),
              "ms_per_step": sum(ms) / len(ms), "hit_rate_overall": c.hit_rate,
              "flush_s": flush_s, "flush_gather_launches": flush_reads,
              "rows_touched": int(touched.sum()), "untouched_rows_bit_equal": untouched_equal,
              "fresh_cache_rows_bit_equal": same_rows})
        if not (untouched_equal and same_rows):
            raise AssertionError(f"cached embedding: untouched rows equal {untouched_equal}, "
                                 f"a fresh cache's rows equal {same_rows}")
        dedup_ids, dedup_grads = smp.input_nodes, grad
        del emb, fresh, c, host
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        demb = DistEmbedding(DistArray.from_array(initial, mesh), optimizer="lazy_adam")
        torch.cuda.synchronize()
        emit({"phase": "embedding_setup", "path": "dist", "world": mesh.world,
              "backend": mesh.backend, "table_bytes": demb.table.data.numel() * 4,
              "state_bytes": sum(v.numel() * 4 for v in demb._state.values()),
              "setup_s": time.perf_counter() - t0})
        ms, touched, smp, _ = train("dist", demb, 2, 5)
        ids = smp.input_nodes
        read_rows_at["dist_lookup"] = _gather_row(
            emit, demb.table.data, ids, int(torch.unique(ids[ids >= 0]).numel()), cuda_ms, hbm,
            "DistEmbedding at world 1: the local read")
        table = demb.table.to_global().numpy()
        untouched_equal = _bits_equal(table[~touched], initial[~touched])
        emit({"phase": "embedding_train_summary", "path": "dist", "steps_timed": len(ms),
              "ms_per_step": sum(ms) / len(ms), "rows_touched": int(touched.sum()),
              "untouched_rows_bit_equal": untouched_equal})
        if not untouched_equal:
            raise AssertionError("DistEmbedding changed rows that no step touched")
        # phase 5z's checkpoint of this trained lazy-Adam embedding
        checkpoint_round_trip(emit, "dist_embedding", demb, mesh)
        del demb, table, initial
        torch.cuda.empty_cache()
    finally:
        D.finalize()
    launches.update(path_launches)

    # -- 5f. the loader over host-located features -----------------------------
    t0 = time.perf_counter()
    fs = FeatureStore(device=dev)
    fs.put_tensor(graph.feats.cpu().numpy(), "", "x", location="host")
    fs["y"] = graph.labels
    cache = fs._store[("", "x")][1][1]
    emit({"phase": "host_loader_stores", "setup_s": time.perf_counter() - t0,
          "sets": cache.sets, "ways": cache.ways, "slots": cache.sets * cache.ways})
    _count_writebacks(cache)
    torch.manual_seed(0)
    model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, T.CLASSES, num_layers=len(T.FANOUTS),
                      dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loader = NeighborLoader((fs, gs), num_neighbors=T.FANOUTS, batch_size=T.BATCH,
                            shuffle=True, dedup=True)
    it = iter(loader)
    ms, total = [], {k: 0 for k in names}
    for i in range(6):
        hm0, reads0 = (cache.hits, cache.misses), cache.writeback_reads
        torch.cuda.synchronize()
        reset()
        t1 = time.perf_counter()
        batch = next(it)
        loss = float(_loader_step(model, opt, batch))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) * 1e3
        got = read()
        if i >= 2:
            ms.append(dt)
        want = expect(1 + cache.writeback_reads - reads0, 2, 0)
        same = _bits_equal(batch.x, gather_rows_ref(graph.feats, batch.sample.input_nodes))
        hits, misses = cache.hits - hm0[0], cache.misses - hm0[1]
        emit({"phase": "host_loader_train", "batch": i, "warmup": i < 2, "loss": loss,
              "ms": dt, "hit_rate": hits / max(hits + misses, 1),
              "rows_bit_equal_device_store": same, "launches": got, "expected": want,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if not (math.isfinite(loss) and same and got == want):
            raise AssertionError(f"host-located loader batch {i}: loss {loss}, rows equal "
                                 f"{same}, launches {got}, expected {want}")
        for k, v in got.items():
            total[k] += v
    emit({"phase": "host_loader_summary", "batches_timed": len(ms),
          "ms_per_batch": sum(ms) / len(ms), "hit_rate_overall": cache.hit_rate})
    launches["host_loader"] = total
    del loader, it, batch, fs, cache, model, opt

    # -- 5g. row 3 at the dedup's shape ------------------------------------------
    uids, plan = emb_mod.dedup_plan(dedup_ids)
    grads = dedup_grads.contiguous()
    u, f = plan.num_rows, grads.shape[1]
    got = segment_add(torch.zeros((u, f), device=dev), plan, grads)
    again = segment_add(torch.zeros((u, f), device=dev), plan, grads)
    want = csr_spmm_ref(plan, grads, out=torch.zeros((u, f), device=dev))
    mag = csr_spmm_ref(plan, grads.abs(), out=torch.zeros((u, f), device=dev))
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= 1e-5 + 1e-5 * mag).all())
    if not (ok and _bits_equal(got, again)):
        raise AssertionError(f"row 3 at the dedup's shape: max abs err {err}, within "
                             f"tolerance {ok}, two launches equal {_bits_equal(got, again)}")
    slots = int(plan.rowptr[-1])
    nbytes = slots * (4 + 4 * f) + (u + 1) * 8 + 2 * u * f * 4
    out = torch.zeros((u, f), device=dev)
    valid = plan.rows >= 0
    idx, vals = plan.rows[valid].long(), grads[plan.cols[valid].long()]
    dedup_row = {
        "kernel": "csr_spmm", "path": "dedup", "ids": int(dedup_ids.numel()),
        "unique": int((uids >= 0).sum()), "slots": slots, "f": f,
        "ms": cuda_ms(lambda: segment_add(out, plan, grads)),
        "plain_ms": cuda_ms(lambda: csr_spmm_ref(plan, grads, out=out), iters=5),
        "library_ms": cuda_ms(lambda: out.index_add_(0, idx, vals)),
        "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "max_abs_err": err,
        "bit_equal_two_launches": True}
    emit(dedup_row)
    return launches, {"dedup": dedup_row, **read_rows_at}


LINK_EDGES = 196_608   # bench.py's seed split, as the link path's positives
LINK_OUT = 16          # examples/link_prediction.py's embedding width


def _link_positives(graph, dev):
    """The link path's positives: LINK_EDGES of the graph's edges (a fixed
    draw), as CSR positions and as (neighbor, row) pairs, the graph store's
    edge direction."""
    import numpy as np
    import torch

    indptr = graph.indptr.cpu().numpy()
    rng = np.random.default_rng(0)
    pos = rng.permutation(np.unique(rng.integers(0, int(indptr[-1]),
                                                 LINK_EDGES + LINK_EDGES // 50)))[:LINK_EDGES]
    eli = np.stack([graph.indices[torch.as_tensor(pos, device=dev)].cpu().numpy(),
                    np.searchsorted(indptr, pos, side="right") - 1]).astype(np.int64)
    return pos, eli


def _link_negatives(loader, stats=None, draws_from=None):
    """Replace ``loader._negatives`` by the same draw made in two visible
    steps: the candidates (from the loader's generator, or from a fresh CPU
    generator seeded ``draws_from`` every batch, moved to the loader's
    device), then ``draw_negatives`` on them.  With ``stats``, appends per
    batch (pairs that hit a true edge at the first draw, pairs left -1) as
    device tensors."""
    import torch

    from cugraph_gnn_tpu_torch.loader.link_loader import draw_negatives
    from cugraph_gnn_tpu_torch.sampler.negative import NegativeDraws, draw_candidates, is_edge

    triplet = loader.neg.mode == "triplet"
    table = loader._edge_key_sorted

    def negatives(ps, n_neg):
        if draws_from is None:
            gen, where = loader._generator, loader.device
        else:
            gen, where = torch.Generator().manual_seed(draws_from), torch.device("cpu")
        draws = draw_candidates(loader.num_src, loader.num_dst, n_neg, loader.neg,
                                pinned_src=triplet, rejection=table is not None,
                                generator=gen, device=where)
        draws = NegativeDraws(*(None if d is None else d.to(loader.device) for d in draws))
        ns, nd = draw_negatives(ps, n_neg, loader.num_src, loader.num_dst, loader.neg,
                                table, draws=draws, device=loader.device)
        if stats is not None:
            src = ps.repeat_interleave(max(int(loader.neg.amount), 1))[:n_neg] if triplet \
                else draws.src
            stats.append((is_edge(table, src, draws.dst).sum(), (nd < 0).sum()))
        return ns, nd

    loader._negatives = negatives


def link_paths(dev, emit, graph, small_cpu, counters, cuda_ms, hbm, gs):
    """Phases 5h-5k (see the module docstring).  Returns each kernel's
    launches on the link path (5h) and on GIN's loader path (5j), and rows 1
    and 2 timed at a link batch's shapes."""
    import numpy as np
    import torch

    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch import train_link as TL
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
    from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader, NeighborLoader
    from cugraph_gnn_tpu_torch.loader import link_loader as LL
    from cugraph_gnn_tpu_torch.models.zoo import GIN, GraphSAGE
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows, gather_rows_ref
    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
        fused_uniform_sample,
        fused_uniform_sample_ref,
    )

    names = [fn.__name__ for fn in counters]

    def reset():
        for fn in counters:
            fn.launches = 0

    def check_launches(what, batches):
        got = {fn.__name__: fn.launches for fn in counters}
        want = {**{n: 0 for n in names}, "gather_rows": batches,
                "fused_uniform_sample": 2 * batches}
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
        return got

    fs = FeatureStore(device=dev)
    fs["x"] = graph.feats
    fs["y"] = graph.labels

    # -- 5h. the link path at full width -------------------------------------
    t0 = time.perf_counter()
    _, eli = _link_positives(graph, dev)
    kw = dict(num_neighbors=T.FANOUTS, edge_label_index=eli, batch_size=T.BATCH,
              shuffle=True, reject_true_edges=True)
    loader = LinkNeighborLoader((fs, gs), neg_sampling="binary", **kw)
    triplet = LinkNeighborLoader((fs, gs), neg_sampling=dict(mode="triplet", amount=1),
                                 seed=1, **kw)
    torch.cuda.synchronize()
    emit({"phase": "link_setup", "positives": LINK_EDGES, "batches_per_epoch": len(loader),
          "level_caps": loader.sampler.level_caps(4 * T.BATCH),
          "setup_s": time.perf_counter() - t0})
    torch.manual_seed(0)
    model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, LINK_OUT, num_layers=len(T.FANOUTS),
                      dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    launches = {}
    summary = {}
    for mode, ld, batches, warmup in (("binary", loader, 12, 2), ("triplet", triplet, 4, 1)):
        stats = []
        _link_negatives(ld, stats)
        it = iter(ld)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        ms = []
        for i in range(batches):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch = next(it)
            loss = TL.link_step(model, opt, batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t1) * 1e3
            if i >= warmup:
                ms.append(dt)
            loss = float(loss)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite link loss {loss} ({mode}, batch {i})")
            b, sd = T.BATCH, batch.seeds
            nn_ = sd.numel() // 2 - b
            hit, unresolved = stats[-1]
            emit({"phase": "link_train", "mode": mode, "batch": i, "warmup": i < warmup,
                  "loss": loss, "ms": dt,
                  "valid_positives": int((sd[:b] >= 0).sum()),
                  "valid_negatives": int(((sd[2 * b:2 * b + nn_] >= 0)
                                          & (sd[2 * b + nn_:] >= 0)).sum()),
                  "negatives_redrawn": int(hit), "negatives_unresolved": int(unresolved),
                  "nodes_per_level": [int(c) for c in batch.sample.level_counts],
                  "slots_per_level": [int(lv.numel()) for lv in batch.sample.levels],
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
        launches[mode] = check_launches(f"link path ({mode})", batches)
        summary[mode] = {"batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms),
                         "ms_min": min(ms), "ms_max": max(ms)}
    emit({"phase": "link_launch_counts", "launches": launches, **summary})

    # one batch stage by stage (CUDA events and host clocks; each stage
    # synchronised)
    stages = _Stages()
    negatives = loader._negatives
    stages.wrap(loader, "_negatives", "negatives")
    stages.wrap(loader.sampler, "sample", "sample")
    orig_gather = LL.gather_node_features
    LL.gather_node_features = lambda *a: stages.run("feature_gather", orig_gather, *a)
    try:
        it = iter(loader)
        next(it)          # the epoch's first batch also shuffles the positives
        stages.take()
        batch = stages.run("batch", next, it)
        stages.run("link_step", TL.link_step, model, opt, batch)
    finally:
        LL.gather_node_features = orig_gather
        loader._negatives = negatives
        del loader.sampler.sample
    emit({"phase": "link_stages", **stages.take()})

    # the AUC over 4 evaluation batches (printed, not gated)
    reset()
    scores, labels = [], []
    for _, b in zip(range(4), iter(loader)):
        s, lab = TL.link_eval_scores(model, b)
        scores.append(s)
        labels.append(lab)
    launches["eval"] = check_launches("link evaluation", 4)
    emit({"phase": "link_auc", "batches": 4, "pairs": int(sum(len(s) for s in scores)),
          "auc": TL.link_auc(np.concatenate(scores), np.concatenate(labels))})

    # rows 1 and 2 at this batch's shapes: the sampler at its two hops
    # (4,096 and 45,056 slots) and the gather of its 495,616-slot level
    g_u = torch.Generator(device=dev).manual_seed(3)
    rows = {"sampler": []}
    for h, (sd, kf) in enumerate(zip(batch.sample.levels, T.FANOUTS)):
        u = torch.rand((sd.numel(), kf), generator=g_u, device=dev)
        got = fused_uniform_sample(graph.indptr, graph.indices, sd, u, kf)
        want = fused_uniform_sample_ref(graph.indptr, graph.indices, sd, u, kf)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"sampler at the link batch's hop {h} differs from the "
                                 f"plain version")
        nbytes, floor_bytes = _sampler_bytes(graph.indptr, sd, kf, want)
        row = {"kernel": "uniform_sample", "path": "link", "hop": h, "seeds": sd.numel(),
               "valid_seeds": int((sd >= 0).sum()), "k": kf,
               "ms": cuda_ms(lambda: fused_uniform_sample(graph.indptr, graph.indices, sd,
                                                          u, kf)),
               "plain_ms": cuda_ms(lambda: fused_uniform_sample_ref(
                   graph.indptr, graph.indices, sd, u, kf), iters=5),
               "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
               "sector_floor_ms": floor_bytes / hbm * 1e3, "bit_equal": True}
        emit(row)
        rows["sampler"].append(row)
    ids = batch.sample.input_nodes
    got = gather_rows(graph.feats, ids, torch.bfloat16)
    if not torch.equal(got.view(torch.int16),
                       gather_rows_ref(graph.feats, ids, torch.bfloat16).view(torch.int16)):
        raise AssertionError("row gather at the link batch differs from the plain version")
    f = graph.feats.shape[1]
    uniq = int(torch.unique(ids[ids >= 0]).numel())
    nbytes = 4 * ids.numel() + 4 * f * uniq + 2 * f * ids.numel()
    rows["gather"] = {
        "kernel": "gather_rows", "path": "link", "ids": ids.numel(), "distinct": uniq,
        "out_dtype": "bfloat16",
        "ms": cuda_ms(lambda: gather_rows(graph.feats, ids, torch.bfloat16)),
        "plain_ms": cuda_ms(lambda: gather_rows_ref(graph.feats, ids, torch.bfloat16)),
        "library_ms": cuda_ms(lambda: torch.index_select(
            graph.feats, 0, ids.clamp(min=0)).to(torch.bfloat16)),
        "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "bit_equal": True}
    emit(rows["gather"])
    del loader, triplet, it, batch, model, opt, got

    # -- 5i. small input, the link path: card against CPU ----------------------
    sm = small_cpu
    rows_s = np.repeat(np.arange(sm.num_nodes), np.diff(sm.indptr.numpy()))
    pick = np.random.default_rng(5).choice(len(rows_s), 600, replace=False)
    eli_s = np.stack([sm.indices.numpy()[pick], rows_s[pick]])
    sides = {}
    for where in ("cpu", "card"):
        d = torch.device("cpu") if where == "cpu" else dev
        gs_s, fs_s = GraphStore(device=d), FeatureStore(device=d)
        gs_s.put_edge_index((sm.indices.numpy(), rows_s), ("n", "to", "n"),
                            num_nodes=(sm.num_nodes, sm.num_nodes))
        fs_s["x"] = sm.feats
        ld = LinkNeighborLoader((fs_s, gs_s), (10, 10), eli_s, neg_sampling="binary",
                                batch_size=64, shuffle=True, reject_true_edges=True)
        _link_negatives(ld, draws_from=12)
        inner = ld.sampler

        class Fixed:
            fanouts = inner.fanouts

            def sample(self, seeds, generator=None):
                g = torch.Generator().manual_seed(13)
                caps = inner.level_caps(seeds.shape[0])
                return inner.sample(seeds, u=[torch.rand((caps[h], k), generator=g)
                                              for h, k in enumerate(inner.fanouts)])

        ld.sampler = Fixed()
        torch.manual_seed(7)
        m = GraphSAGE(sm.feats.shape[1], 32, 8, device="cpu").to(d)
        o = torch.optim.Adam(m.parameters(), lr=1e-3)
        out = []
        for _, b in zip(range(3), ld):
            out.append((b, float(TL.link_step(m, o, b))))
        sides[where] = out
    equal, loss_diff = True, 0.0
    for (bc, lc), (bg, lg) in zip(sides["cpu"], sides["card"]):
        a = [bc.seeds, bc.edge_label, bc.x] + bc.sample.levels + bc.sample.level_counts + [
            t for hop in bc.sample.hops for t in hop[:3]]
        b = [bg.seeds, bg.edge_label, bg.x] + bg.sample.levels + bg.sample.level_counts + [
            t for hop in bg.sample.hops for t in hop[:3]]
        equal &= all(_bits_equal(x.cpu(), y.cpu()) if x.is_floating_point()
                     else torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
        loss_diff = max(loss_diff, abs(lc - lg))
    if not (equal and loss_diff <= 1e-4):
        raise AssertionError(f"small link path, card vs CPU: batches equal {equal}, "
                             f"losses differ by {loss_diff}")
    emit({"phase": "small_input_agreement_link", "batches": 3, "equal": True,
          "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # -- 5j. GIN through NeighborLoader at full width ---------------------------
    torch.manual_seed(0)
    model = GIN(T.FEAT_DIM, T.HIDDEN, T.CLASSES, num_layers=len(T.FANOUTS),
                dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    it = iter(NeighborLoader((fs, gs), num_neighbors=T.FANOUTS, batch_size=T.BATCH,
                             shuffle=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = float(_loader_step(model, opt, next(it)))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) * 1e3
        if i >= 2:
            ms.append(dt)
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite GIN loader loss {loss} at batch {i}")
        emit({"phase": "gin_loader_train", "batch": i, "warmup": i < 2, "loss": loss,
              "ms": dt, "max_memory_allocated": torch.cuda.max_memory_allocated()})
    launches["gin_loader"] = check_launches("GIN loader path", 6)
    emit({"phase": "gin_loader_launch_counts", "launches": launches["gin_loader"],
          "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms)})
    del model, opt, it

    # -- 5k. DeviceLFUCache with an overfilled set, on the card ------------------
    device_cache_check(dev, emit)
    return launches, rows


def device_cache_check(dev, emit):
    """Phase 5k: ``DeviceLFUCache`` with more than ``ways`` misses in one
    set and -1 pads on the card: every gathered row and a later hit equal
    the host rows, and two runs are bit for bit equal."""
    import numpy as np
    import torch

    from cugraph_gnn_tpu_torch.embedding.cache import DeviceLFUCache

    host = np.random.default_rng(3).standard_normal((100_000, 128)).astype(np.float32)
    runs = []
    for _ in range(2):
        cache = DeviceLFUCache(host, capacity=4096, ways=8, device=dev)
        crowded = np.nonzero(cache._set_of(torch.arange(100_000)).numpy() == 0)[0]
        rng = np.random.default_rng(4)
        rows = []
        for _ in range(6):
            ids = np.concatenate([rng.choice(crowded, 4 * cache.ways, replace=False),
                                  rng.integers(0, 100_000, 3000), [-1] * 100])
            ids[::7] = -1
            ids = torch.as_tensor(rng.permutation(ids), device=dev)
            got = cache.gather(ids)
            want = torch.as_tensor(host[ids.clamp(min=0).cpu().numpy()], device=dev)
            want[ids < 0] = 0
            tags = cache.tags[cache.tags >= 0]
            hits = cache.hits
            again = cache.gather(tags)
            if not (torch.equal(got, want) and cache.hits == hits + tags.numel()
                    and torch.equal(again, torch.as_tensor(host[tags.cpu().numpy()],
                                                           device=dev))):
                raise AssertionError("DeviceLFUCache with an overfilled set returned "
                                     "rows other than the host rows")
            rows.append(got)
        runs.append((rows, cache.rows.clone(), cache.tags.clone(), cache.freq.clone(),
                     cache.hits, cache.misses))
    (r1, rows1, tags1, freq1, h1, m1), (r2, rows2, tags2, freq2, h2, m2) = runs
    same = (all(_bits_equal(a, b) for a, b in zip(r1, r2)) and _bits_equal(rows1, rows2)
            and torch.equal(tags1, tags2) and torch.equal(freq1, freq2) and (h1, m1) == (h2, m2))
    if not same:
        raise AssertionError("two DeviceLFUCache runs on the card differ")
    emit({"phase": "device_lfu_cache_check", "sets": cache.sets, "ways": cache.ways,
          "batches": 6, "misses_in_set_0_per_batch": 4 * cache.ways,
          "hit_rate": cache.hit_rate, "rows_equal_host": True, "bit_equal_two_runs": True})


T_RANGE = 1_000   # edge and seed times of phases 5l-5o, drawn in [0, T_RANGE)


def _flat_batch(batch):
    """A disjoint NodeBatch as one batch a model runs: the seeds' blocks one
    after the other (``DisjointBatch.flat``), features (B * cap, F)."""
    from cugraph_gnn_tpu_torch.loader import NodeBatch

    x = batch.x.reshape(-1, batch.x.shape[-1])
    return NodeBatch(batch.sample.flat(), x, batch.y, batch.seeds, batch.input_id,
                     batch.batch_size)


def _check_times(sample, seed_time, edge_times) -> int:
    """Every sampled edge of ``sample`` is no newer than its target's
    propagated time (the seeds' ``seed_time``, then the scatter-min of each
    hop); raises otherwise.  Returns the edges checked."""
    from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import propagate_times

    st, checked = seed_time[None], 0
    for h, hop in enumerate(sample.hops):
        e = hop.edge_ids.long()
        ok = e >= 0
        if bool((ok & (edge_times[e.clamp(min=0)] > st[0][:, None])).any()):
            raise AssertionError(f"hop {h} sampled an edge newer than its target's time")
        checked += int(ok.sum())
        st = propagate_times(st, hop.neigh_local[None], sample.levels[h + 1].shape[0])
    return checked


def _check_disjoint(batch, indptr, indices) -> int:
    """Each seed's levels form a subgraph of its own: targets a prefix of the
    next level, no node twice in a row, every sampled edge a true edge of its
    target, every map pointing at its neighbor in the seed's row.  Returns
    the seeds checked."""
    import torch

    lv = batch.levels
    for a, b in zip(lv[:-1], lv[1:]):
        if not torch.equal(b[:, :a.shape[1]], a):
            raise AssertionError("a seed's level is not a prefix of its next level")
        srt = torch.sort(b, dim=1).values
        if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
            raise AssertionError("a node appears twice in one seed's level")
    for h, hop in enumerate(batch.hops):
        tgt = lv[h].long()[:, :, None].expand_as(hop.edge_ids)
        ok = hop.neigh_local >= 0
        e = hop.edge_ids.long().clamp(min=0)
        t = tgt.clamp(min=0)
        good = (e >= indptr[t].long()) & (e < indptr[t + 1].long()) & (
            indices[e] == hop.neigh_global)
        row = torch.gather(lv[h + 1], 1, hop.neigh_local.long().clamp(min=0).reshape(
            hop.neigh_local.shape[0], -1)).view_as(hop.neigh_global)
        if not bool((good & (row == hop.neigh_global))[ok].all()):
            raise AssertionError(f"disjoint hop {h}: a sampled edge or map is wrong")
    return int(batch.seed_valid.sum())


class _KeyedFixed:
    """A loader's sampler whose draws are given, batch after batch: the same
    CPU uniforms and key words (one per seed when disjoint) on either device."""

    def __init__(self, inner, seed):
        self.inner, self.seed = inner, seed
        self.fanouts = inner.fanouts

    def sample(self, seeds, node_times=None, generator=None):
        import torch

        g = torch.Generator().manual_seed(self.seed)
        caps = self.inner.level_caps(seeds.shape[0])
        rows = seeds.shape[0] if hasattr(self.inner, "base") else 1
        u = [torch.rand((caps[h] * rows, k), generator=g) for h, k in enumerate(self.fanouts)]
        keys = [torch.randint(0, 2**32, (rows, 2) if rows > 1 else (2,), generator=g)
                for _ in self.fanouts]
        return self.inner.sample(seeds, node_times, u=u, hash_keys=keys)


def sampling_variants(dev, emit, graph, small_cpu, counters, gs):
    """Phases 5l-5o (see the module docstring).  Returns each kernel's
    launches on each new path."""
    import numpy as np
    import torch

    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch import train_link as TL
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
    from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader, NeighborLoader
    from cugraph_gnn_tpu_torch.loader import link_loader as LL
    from cugraph_gnn_tpu_torch.loader import node_loader as NL
    from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
    from cugraph_gnn_tpu_torch.sampler.disjoint import DisjointBatch

    names = [fn.__name__ for fn in counters]

    def reset():
        for fn in counters:
            fn.launches = 0

    def check_launches(what, batches, sampler_per_batch):
        got = {fn.__name__: fn.launches for fn in counters}
        want = {**{n: 0 for n in names}, "gather_rows": batches,
                "fused_uniform_sample": sampler_per_batch * batches}
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
        return got

    # -- the stores: 5b's graph store; x, y, an f32 weight and an int32 time
    # per edge (COO order = CSR order here), made from the seed ------------------
    t0 = time.perf_counter()
    e = graph.indices.numel()
    gen = torch.Generator(device=dev).manual_seed(12)
    fs = FeatureStore(device=dev)
    fs["x"] = graph.feats
    fs["y"] = graph.labels
    fs["w"] = 0.05 + torch.rand((e,), generator=gen, device=dev)
    fs["t"] = torch.randint(0, T_RANGE, (e,), generator=gen, device=dev, dtype=torch.int32)
    input_time = torch.randint(0, T_RANGE, (graph.num_nodes,), generator=gen, device=dev,
                               dtype=torch.int32).cpu().numpy()
    torch.cuda.synchronize()
    emit({"phase": "variants_setup", "edges": e, "setup_s": time.perf_counter() - t0,
          "edge_attr_bytes": 8 * e})

    stages = _Stages()

    def watch_hops(sampler):
        """Time each hop apart."""
        inner = sampler._one_hop
        calls = [0]

        def one_hop(targets, fanout, seed_time, **kw):
            h = calls[0] % len(sampler.fanouts)
            calls[0] += 1
            return stages.run(f"hop{h}", inner, targets, fanout, seed_time, **kw)

        sampler._one_hop = one_hop

    def hop_edges(sampler, sample):
        """Per key-based hop, read after the batch: its valid targets, the
        edges the port scores (their degrees, cut at JAX's loop bound), the
        256-edge chunks its largest target needs, and the chunks JAX's loop
        runs for every seed."""
        limit = max(-(-int(sampler.max_degree) // sampler.chunk), 1) * sampler.chunk
        ip, n = sampler.indptr, sampler.indptr.numel() - 1
        out = []
        for h in range(len(sampler.fanouts)):
            targets = sample.levels[h].reshape(-1)
            safe = targets.long().clamp(0, n)
            deg = torch.where(targets >= 0, (ip[(safe + 1).clamp(max=n)].long()
                                             - ip[safe].long()).clamp(max=limit), 0)
            out.append({"hop": h, "targets": int((targets >= 0).sum()),
                        "edges_scored": int(deg.sum()),
                        "chunks_needed": -(-int(deg.max()) // sampler.chunk),
                        "jax_chunk_iterations": limit // sampler.chunk})
        return out

    def run_node(what, loader, model, opt, batches, warmup, sampler_per_batch, check=None):
        base = getattr(loader.sampler, "base", loader.sampler)
        watch_hops(base)
        stages.wrap(loader.sampler, "sample", "sample")
        orig = NL.gather_node_features
        NL.gather_node_features = lambda *a: stages.run("feature_gather", orig, *a)
        it = iter(loader)
        ms, checked = [], 0
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            for i in range(batches):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                batch = stages.run("batch", next, it)
                step = _flat_batch(batch) if isinstance(batch.sample, DisjointBatch) else batch
                loss = stages.run("model", _loader_step, model, opt, step)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t1) * 1e3
                if i >= warmup:
                    ms.append(dt)
                loss = float(loss)
                if not math.isfinite(loss):
                    raise AssertionError(f"non-finite {what} loss {loss} at batch {i}")
                emit({"phase": f"{what}_train", "batch": i, "warmup": i < warmup,
                      "loss": loss, "ms": dt, "stages": stages.take(),
                      "hops": hop_edges(base, batch.sample) if base.key_based(True) else None,
                      "nodes_per_level": [int((lv >= 0).sum()) for lv in batch.sample.levels],
                      "slots_per_level": [int(lv.numel()) for lv in batch.sample.levels],
                      "max_memory_allocated": torch.cuda.max_memory_allocated()})
                if check is not None:
                    checked += check(batch)
            launches = check_launches(what, batches, sampler_per_batch)
        finally:
            NL.gather_node_features = orig
            del loader.sampler.sample, base._one_hop
        emit({"phase": f"{what}_launch_counts", "launches": launches, "batches": batches,
              "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms),
              "ms_min": min(ms), "ms_max": max(ms), "checked": checked})
        return launches

    def sage(out=T.CLASSES):
        torch.manual_seed(0)
        model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, out, num_layers=len(T.FANOUTS),
                          dtype=torch.bfloat16, device=dev)
        return model, torch.optim.Adam(model.parameters(), lr=1e-3)

    launches = {}
    kw = dict(num_neighbors=T.FANOUTS, batch_size=T.BATCH, shuffle=True)
    # -- 5l. weighted ------------------------------------------------------------
    t0 = time.perf_counter()
    loader = NeighborLoader((fs, gs), weight_attr="w", **kw)
    emit({"phase": "weighted_loader_setup", "s": time.perf_counter() - t0,
          "max_degree": loader.sampler.max_degree, "chunk": loader.sampler.chunk})
    launches["weighted"] = run_node("weighted_loader", loader, *sage(), 8, 2, 0)
    del loader

    # -- 5m. temporal: the node loader, then the link loader ---------------------
    loader = NeighborLoader((fs, gs), time_attr="t", input_time=input_time, **kw)
    et = loader.sampler.edge_times

    def node_times(batch):
        ids = batch.input_id.clamp(min=0)
        st = torch.where(batch.input_id >= 0,
                         torch.as_tensor(input_time, device=dev)[ids], 0)
        return _check_times(batch.sample, st, et)

    launches["temporal"] = run_node("temporal_loader", loader, *sage(), 8, 2, 0, node_times)
    del loader

    pos, eli = _link_positives(graph, dev)
    label_time = fs["t"][torch.as_tensor(pos, device=dev)].cpu().numpy()
    loader = LinkNeighborLoader((fs, gs), neg_sampling="binary", time_attr="t",
                                edge_label_time=label_time, edge_label_index=eli,
                                reject_true_edges=True, **kw)
    base = loader.sampler
    watch_hops(base)
    stages.wrap(loader, "_negatives", "negatives")
    seen = []
    sample_inner = base.sample

    def sample(seeds, node_times=None, generator=None):
        out = stages.run("sample", sample_inner, seeds, node_times, generator=generator)
        seen.append((out, node_times))
        return out

    loader.sampler.sample = sample
    orig = LL.gather_node_features
    LL.gather_node_features = lambda *a: stages.run("feature_gather", orig, *a)
    model, opt = sage(LINK_OUT)
    ms, checked = [], 0
    try:
        it = iter(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        for i in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch = stages.run("batch", next, it)
            loss = float(stages.run("link_step", TL.link_step, model, opt, batch))
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t1) * 1e3
            if i >= 2:
                ms.append(dt)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite temporal link loss {loss} at batch {i}")
            checked += _check_times(*seen[-1], base.edge_times)
            emit({"phase": "temporal_link_train", "batch": i, "warmup": i < 2, "loss": loss,
                  "ms": dt, "stages": stages.take(), "hops": hop_edges(base, batch.sample),
                  "nodes_per_level": [int(c) for c in batch.sample.level_counts],
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
        launches["link_temporal"] = check_launches("temporal link path", 6, 0)
    finally:
        LL.gather_node_features = orig
    emit({"phase": "temporal_link_launch_counts", "launches": launches["link_temporal"],
          "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms), "ms_min": min(ms),
          "ms_max": max(ms), "edges_checked": checked})
    del loader, base, seen, batch, model, opt, it

    # -- 5n. disjoint --------------------------------------------------------------
    loader = NeighborLoader((fs, gs), disjoint=True, **kw)
    launches["disjoint"] = run_node(
        "disjoint_loader", loader, *sage(), 6, 2, 2,
        lambda b: _check_disjoint(b.sample, graph.indptr, graph.indices))
    del loader, fs

    # -- 5o. small input: weighted, temporal, disjoint, card against CPU -------------
    sm = small_cpu
    rows_s = np.repeat(np.arange(sm.num_nodes), np.diff(sm.indptr.numpy()))
    rng = np.random.default_rng(14)
    w_s = rng.uniform(0.05, 1.0, len(rows_s)).astype(np.float32)
    t_s = rng.integers(0, T_RANGE, len(rows_s)).astype(np.int32)
    it_s = rng.integers(0, T_RANGE, sm.num_nodes)
    for variant, vkw in (("weighted", dict(weight_attr="w")),
                         ("temporal", dict(time_attr="t", input_time=it_s)),
                         ("disjoint", dict(disjoint=True))):
        sides = {}
        for where in ("cpu", "card"):
            d = torch.device("cpu") if where == "cpu" else dev
            gs_s, fs_s = GraphStore(device=d), FeatureStore(device=d)
            gs_s.put_edge_index((sm.indices.numpy(), rows_s), ("n", "to", "n"),
                                num_nodes=(sm.num_nodes, sm.num_nodes))
            fs_s["x"], fs_s["y"], fs_s["w"], fs_s["t"] = sm.feats, sm.labels, w_s, t_s
            ld = NeighborLoader((fs_s, gs_s), (10, 10), batch_size=64, shuffle=True, **vkw)
            ld.sampler = _KeyedFixed(ld.sampler, 15)
            torch.manual_seed(7)
            m = GraphSAGE(sm.feats.shape[1], 32, 5, device="cpu").to(d)
            o = torch.optim.Adam(m.parameters(), lr=1e-3)
            out = []
            for _, b in zip(range(3), ld):
                step = _flat_batch(b) if variant == "disjoint" else b
                out.append((b, float(_loader_step(m, o, step))))
            sides[where] = out
        equal, loss_diff = True, 0.0
        for (bc, lc), (bg, lg) in zip(sides["cpu"], sides["card"]):
            a = [bc.seeds, bc.x] + bc.sample.levels + [t for h in bc.sample.hops for t in h[:3]]
            b = [bg.seeds, bg.x] + bg.sample.levels + [t for h in bg.sample.hops for t in h[:3]]
            equal &= all(_bits_equal(x.cpu(), y.cpu()) if x.is_floating_point()
                         else torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
            loss_diff = max(loss_diff, abs(lc - lg))
        if not (equal and loss_diff <= 1e-4):
            raise AssertionError(f"small {variant} loader, card vs CPU: batches equal {equal}, "
                                 f"losses differ by {loss_diff}")
        emit({"phase": "small_input_agreement_variants", "variant": variant, "batches": 3,
              "equal": True, "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})
    return launches


DIST_STAGES = ("route_to_owners", "sample_owned", "route_back")


class _RecordDraws:
    """A one-device loader's sampler whose uniforms come from a CPU generator
    (seeded), kept with the batch's levels for :class:`_FrameDraws`."""

    def __init__(self, inner, seed):
        import torch

        self.inner, self.fanouts = inner, inner.fanouts
        self.gen = torch.Generator().manual_seed(seed)
        self.last = None

    def sample(self, seeds, node_times=None, generator=None):
        import torch

        caps = self.inner.level_caps(seeds.shape[0])
        u = [torch.rand((caps[h], k), generator=self.gen).to(seeds.device)
             for h, k in enumerate(self.fanouts)]
        batch = self.inner.sample(seeds, node_times, u=u)
        self.last = (u, batch.levels)
        return batch


class _FrameDraws:
    """A world-1 dist sampler taking the draws of the one-device batch just
    recorded: at world 1 a hop's frame is its level's valid targets, in
    order."""

    def __init__(self, inner, record):
        self.inner, self.record, self.fanouts = inner, record, inner.fanouts

    def sample(self, seeds, node_times=None, generator=None):
        u, levels = self.record.last
        return self.inner.sample(seeds, node_times,
                                 u=[uh[lv >= 0] for uh, lv in zip(u, levels)])


def _cpu_draws(seed, module=None):
    """A stand-in for ``sample_owned`` (of ``module``: default
    ``dist_sampler``) that draws each hop's uniforms (or key words) from one
    CPU generator, so that the card's and the CPU's samplers take the same
    draws."""
    import torch

    from cugraph_gnn_tpu_torch.sampler import dist_sampler as DS

    gen, inner = torch.Generator().manual_seed(seed), (module or DS).sample_owned

    def sample_owned(graph, local, fanout, *, req_time=None, **kw):
        if graph.weights is not None or (graph.times is not None and req_time is not None):
            kw["hash_key"] = torch.randint(0, 1 << 32, (2,), generator=gen)
        else:
            kw["u"] = torch.rand((local.shape[0], fanout), generator=gen).to(local.device)
        return inner(graph, local, fanout, req_time=req_time, **kw)

    return sample_owned


def _same_batches(a, b, fields) -> bool:
    """Two batches' sample (levels, counts, hops) and ``fields`` bit for bit
    equal (float tensors by their bits), on the host."""
    import torch

    def pairs():
        yield from zip(a.sample.levels + a.sample.level_counts,
                       b.sample.levels + b.sample.level_counts)
        for ha, hb in zip(a.sample.hops, b.sample.hops):
            yield from zip(ha[:3], hb[:3])
        for f in fields:
            yield getattr(a, f), getattr(b, f)

    return all(_bits_equal(x.cpu(), y.cpu()) if x.is_floating_point()
               else torch.equal(x.cpu(), y.cpu()) for x, y in pairs())


def dist_paths(dev, emit, graph, small_cpu, counters, cuda_ms, hbm, gs):
    """Phases 5t-5v (see the module docstring).  Returns each kernel's
    launches on the dist loader (5t) and dist link (5u) paths, and rows 1
    and 2 timed at a dist batch's shapes."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch import train_dist as TD
    from cugraph_gnn_tpu_torch import train_link as TL
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
    from cugraph_gnn_tpu_torch.loader import (
        DistLinkNeighborLoader,
        DistNeighborLoader,
        LinkNeighborLoader,
        NeighborLoader,
    )
    from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows, gather_rows_ref
    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
        fused_uniform_sample,
        fused_uniform_sample_ref,
    )
    from cugraph_gnn_tpu_torch.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu_torch.sampler import dist_sampler as DS
    from cugraph_gnn_tpu_torch.store import dist_array as DA
    from cugraph_gnn_tpu_torch.utils import distributed as D

    names = [fn.__name__ for fn in counters]

    def reset():
        for fn in counters:
            fn.launches = 0

    def check_launches(what, batches):
        got = {fn.__name__: fn.launches for fn in counters}
        want = {**{n: 0 for n in names}, "gather_rows": batches,
                "fused_uniform_sample": 2 * batches}
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
        return got

    def exchanges():
        return dict(DA.EXCHANGES)

    def delta(before):
        return {k: DA.EXCHANGES[k] - before[k] for k in before}

    def sage(out=T.CLASSES):
        torch.manual_seed(0)
        model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, out, num_layers=len(T.FANOUTS),
                          dtype=torch.bfloat16, device=dev)
        return model, torch.optim.Adam(model.parameters(), lr=1e-3)

    stages = _Stages()

    def watch(loader):
        """Time each hop's three parts (CUDA events and host clocks between
        synchronisations), the sample, the feature and label gathers; undo
        with the returned function."""
        calls = [0]
        saved = {name: getattr(DS, name) for name in DIST_STAGES}

        def part(name):
            def run(*a, **kw):
                hop = calls[0] // 3 % len(T.FANOUTS)
                calls[0] += 1
                return stages.run(f"hop{hop}_{name}", saved[name], *a, **kw)
            return run

        for name in DIST_STAGES:
            setattr(DS, name, part(name))
        stages.wrap(loader.sampler, "sample", "sample")
        gather = loader.gather
        loader.gather = lambda arr, ids, fill=0, read=None: stages.run(
            "feature_gather" if read is not None else "label_gather", gather, arr, ids, fill,
            read)

        def undo():
            for name, fn in saved.items():
                setattr(DS, name, fn)
            del loader.sampler.sample, loader.gather
        return undo

    mesh = D.init(init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    launches, rows = {}, {}
    try:
        _require_nccl(mesh)
        cpu_mesh = create_store_mesh("cpu", group=dist.new_group([0], backend="gloo"))
        fs = FeatureStore(device=dev)
        fs["x"] = graph.feats
        fs["y"] = graph.labels

        # -- 5t. the distributed loader at full width, world 1 over NCCL --------
        model, opt = sage()
        launches["dist_loader"] = {n: 0 for n in names}
        for dedup, batches, warmup in ((True, 12, 2), (False, 6, 2)):
            t0 = time.perf_counter()
            loader = DistNeighborLoader((fs, gs), T.FANOUTS, mesh, batch_size=T.BATCH,
                                        shuffle=True, dedup=dedup)
            torch.cuda.synchronize()
            emit({"phase": "dist_loader_setup", "dedup": dedup,
                  "setup_s": time.perf_counter() - t0,
                  "book_offsets": [int(o) for o in loader.graph.book.offsets],
                  "shard_edges": int(loader.graph.indices.numel())})
            it = iter(loader)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            ms = []
            for i in range(batches):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                before = exchanges()
                batch = next(it)
                in_loader = delta(before)
                loss = TD.dist_train_step(model, opt, batch, mesh)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t1) * 1e3
                if i >= warmup:
                    ms.append(dt)
                loss = float(loss)
                if not math.isfinite(loss):
                    raise AssertionError(f"non-finite dist loader loss {loss} (dedup={dedup})")
                emit({"phase": "dist_loader_train", "dedup": dedup, "batch": i,
                      "warmup": i < warmup, "loss": loss, "ms": dt,
                      "sampled_edges": int(sum(hop.mask.sum() for hop in batch.sample.hops)),
                      "nodes_per_level": [int(c) for c in batch.sample.level_counts],
                      "slots_per_level": [int(lv.numel()) for lv in batch.sample.levels],
                      "loader_exchanges": in_loader,
                      "step_exchanges": {k: v - in_loader[k] for k, v in delta(before).items()},
                      "max_memory_allocated": torch.cuda.max_memory_allocated()})
            got = check_launches(f"dist loader (dedup={dedup})", batches)
            for k, v in got.items():
                launches["dist_loader"][k] += v
            emit({"phase": "dist_loader_launch_counts", "dedup": dedup, "batches": batches,
                  "launches": got, "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms),
                  "ms_min": min(ms), "ms_max": max(ms)})
            # three more batches stage by stage
            undo = watch(loader)
            try:
                for _ in range(3):
                    batch = stages.run("batch", next, it)
                    stages.run("model", TD.dist_train_step, model, opt, batch, mesh)
            finally:
                undo()
            emit({"phase": "dist_loader_stages", "dedup": dedup, "batches": 3,
                  **stages.take()})
            if dedup:
                # rows 2 and 1 at this batch's calls: the owner's two hops
                # (its received rows) and its feature read
                recorded, inner = [], DS.sample_owned
                DS.sample_owned = lambda g, local, k, **kw: (
                    recorded.append((g, local, k)), inner(g, local, k, **kw))[1]
                try:
                    batch = next(it)
                finally:
                    DS.sample_owned = inner
                g_u = torch.Generator(device=dev).manual_seed(4)
                rows["sampler"] = []
                for h, (g, local, kf) in enumerate(recorded):
                    u = torch.rand((local.numel(), kf), generator=g_u, device=dev)
                    got_s = fused_uniform_sample(g.indptr, g.indices, local, u, kf)
                    want_s = fused_uniform_sample_ref(g.indptr, g.indices, local, u, kf)
                    if not all(torch.equal(a, b) for a, b in zip(got_s, want_s)):
                        raise AssertionError(f"sampler at the dist batch's hop {h} differs "
                                             f"from the plain version")
                    nbytes, floor_bytes = _sampler_bytes(g.indptr, local, kf, want_s)
                    row = {"kernel": "uniform_sample", "path": "dist_loader", "hop": h,
                           "seeds": local.numel(), "k": kf,
                           "ms": cuda_ms(lambda: fused_uniform_sample(
                               g.indptr, g.indices, local, u, kf)),
                           "plain_ms": cuda_ms(lambda: fused_uniform_sample_ref(
                               g.indptr, g.indices, local, u, kf), iters=5),
                           "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
                           "sector_floor_ms": floor_bytes / hbm * 1e3, "bit_equal": True}
                    emit(row)
                    rows["sampler"].append(row)
                ids = batch.sample.input_nodes
                ids = ids[ids >= 0]                # the owner's read: its received ids
                table = loader.features.data
                got_g = gather_rows(table, ids)
                if not torch.equal(got_g.view(torch.int32),
                                   gather_rows_ref(table, ids).view(torch.int32)):
                    raise AssertionError("row gather at the dist batch differs from the "
                                         "plain version")
                f = table.shape[1]
                uniq = int(torch.unique(ids).numel())
                nbytes = 4 * ids.numel() + 4 * f * uniq + 4 * f * ids.numel()
                rows["gather"] = {
                    "kernel": "gather_rows", "path": "dist_loader", "ids": ids.numel(),
                    "distinct": uniq, "out_dtype": "float32",
                    "ms": cuda_ms(lambda: gather_rows(table, ids)),
                    "plain_ms": cuda_ms(lambda: gather_rows_ref(table, ids)),
                    "library_ms": cuda_ms(lambda: torch.index_select(table, 0, ids)),
                    "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "bit_equal": True}
                emit(rows["gather"])
            del loader, it, batch

        # what one exchange of the path costs at world 1 on this card: the
        # sizes exchange with its host read, a 1,024-id and a 113,000-id
        # all_to_all_single, an all_reduce of the level counts
        counts = torch.ones(1, dtype=torch.int64, device=dev)

        def sizes_and_read():
            recv = torch.empty_like(counts)
            dist.all_to_all_single(recv, counts, group=mesh.group)
            return recv.tolist()

        costs = {"sizes_exchange_and_host_read": sizes_and_read}
        for n_ids in (1024, 113_000):
            ids_buf = torch.zeros(n_ids, dtype=torch.int32, device=dev)
            out_buf = torch.empty_like(ids_buf)
            costs[f"all_to_all_single_{n_ids}_ids"] = (
                lambda o=out_buf, i=ids_buf: dist.all_to_all_single(
                    o, i, [i.numel()], [i.numel()], group=mesh.group))
        level_counts = torch.ones(3, dtype=torch.int32, device=dev)
        costs["all_reduce_3_counts"] = lambda: dist.all_reduce(level_counts, group=mesh.group)
        emit({"phase": "dist_collective_costs", "world": 1, "backend": mesh.backend,
              "ms": {k: cuda_ms(fn) for k, fn in costs.items()}})

        # one batch through the rank-local mode: this rank's slice (at world 1
        # the whole COO) routed to its owner, against the global mode's first
        # batch (the same seed: the same draws)
        t0 = time.perf_counter()
        n = graph.num_nodes
        gs_local = GraphStore(device=dev)
        gs_local.put_local_edge_index(
            (graph.indices.cpu().numpy(),
             np.repeat(np.arange(n, dtype=np.int32), np.diff(graph.indptr.cpu().numpy()))),
            ("node", "to", "node"), num_nodes=(n, n))
        t1 = time.perf_counter()
        local = DistNeighborLoader((fs, gs_local), T.FANOUTS, mesh, batch_size=T.BATCH,
                                   shuffle=True, dedup=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        glob = DistNeighborLoader((fs, gs), T.FANOUTS, mesh, batch_size=T.BATCH,
                                  shuffle=True, dedup=True)
        same_graph = all(torch.equal(a, b) for a, b in (
            (local.graph.indptr, glob.graph.indptr), (local.graph.indices, glob.graph.indices)))
        reset()
        a, b = next(iter(local)), next(iter(glob))
        if not (same_graph and _same_batches(a, b, ("seeds", "x", "y"))):
            raise AssertionError(f"rank-local batch differs from the global mode's "
                                 f"(shards equal: {same_graph})")
        launches["dist_local"] = check_launches("rank-local dist batch", 2)
        emit({"phase": "dist_rank_local", "put_local_edge_index_s": t1 - t0,
              "route_and_build_s": t2 - t1, "shard_equal": True, "batch_equal": True,
              "nodes_per_level": [int(c) for c in a.sample.level_counts]})
        del gs_local, local, glob, a, b

        # -- 5u. the distributed link loader at world 1 --------------------------
        _, eli = _link_positives(graph, dev)
        link_kw = dict(edge_label_index=eli, neg_sampling="binary", batch_size=T.BATCH,
                       shuffle=True, reject_true_edges=True, dedup=True)
        loader = DistLinkNeighborLoader((fs, gs), T.FANOUTS, mesh, **link_kw)
        model, opt = sage(LINK_OUT)
        it = iter(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        ms = []
        for i in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            before = exchanges()
            batch = next(it)
            in_loader = delta(before)
            loss = float(TL.link_step(model, opt, batch))
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t1) * 1e3
            if i >= 2:
                ms.append(dt)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite dist link loss {loss} at batch {i}")
            emit({"phase": "dist_link_train", "batch": i, "warmup": i < 2, "loss": loss,
                  "ms": dt, "nodes_per_level": [int(c) for c in batch.sample.level_counts],
                  "slots_per_level": [int(lv.numel()) for lv in batch.sample.levels],
                  "loader_exchanges": in_loader,
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
        launches["dist_link"] = check_launches("dist link path", 6)
        stages.wrap(loader, "_negatives", "negatives")
        undo = watch(loader._nl)
        try:
            for _ in range(3):
                batch = stages.run("batch", next, it)
                stages.run("link_step", TL.link_step, model, opt, batch)
        finally:
            undo()
            del loader._negatives
        emit({"phase": "dist_link_stages", "batches": 3, "launches": launches["dist_link"],
              "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms),
              "ms_min": min(ms), "ms_max": max(ms), **stages.take()})
        del loader, it, batch, model, opt

        # -- 5v. checks ------------------------------------------------------------
        # world-1 dist batches against one-device batches on the same draws,
        # and three Adam steps from the same weights: bit for bit
        for dedup in (True, False):
            single = NeighborLoader((fs, gs), T.FANOUTS, batch_size=T.BATCH, shuffle=True,
                                    dedup=dedup)
            dl = DistNeighborLoader((fs, gs), T.FANOUTS, mesh, batch_size=T.BATCH,
                                    shuffle=True, dedup=dedup)
            single.sampler = _RecordDraws(single.sampler, 21)
            dl.sampler = _FrameDraws(dl.sampler, single.sampler)
            (m1, o1), (m2, o2) = sage(), sage()
            for i, bs, bd in zip(range(3), single, dl):
                valid = bs.seeds >= 0
                if not (_same_batches(bs, bd, ("seeds", "x"))
                        and torch.equal(bs.y[valid], bd.y[valid])
                        and bool((bd.y[~valid] == -1).all())):
                    raise AssertionError(f"world-1 dist batch {i} (dedup={dedup}) differs "
                                         f"from the one-device batch")
                l1 = float(_loader_step(m1, o1, bs))
                l2 = float(TD.dist_train_step(m2, o2, bd, mesh))
                if l1 != l2:
                    raise AssertionError(f"world-1 dist step {i} (dedup={dedup}): loss {l2}, "
                                         f"one device {l1}")
            emit({"phase": "dist_check_world1", "dedup": dedup, "batches": 3,
                  "batches_equal": True, "losses_equal": True, "last_loss": l1})
        # the link loaders on the same negatives' candidates and draws
        pair = []
        for cls, extra in ((LinkNeighborLoader, {}), (DistLinkNeighborLoader, {"mesh": mesh})):
            kw = {k: v for k, v in link_kw.items() if k not in ("edge_label_index", "dedup")}
            if cls is DistLinkNeighborLoader:
                kw["dedup"] = True
            ld = cls((fs, gs), T.FANOUTS, edge_label_index=eli, **kw, **extra)
            _link_negatives(ld, draws_from=22)
            pair.append(ld)
        pair[0].sampler = _RecordDraws(pair[0].sampler, 23)
        pair[1].sampler = _FrameDraws(pair[1].sampler, pair[0].sampler)
        (m1, o1), (m2, o2) = sage(LINK_OUT), sage(LINK_OUT)
        for i, bs, bd in zip(range(3), *pair):
            if not _same_batches(bs, bd, ("seeds", "x", "edge_label_index", "edge_label")):
                raise AssertionError(f"world-1 dist link batch {i} differs from the "
                                     f"one-device batch")
            l1, l2 = float(TL.link_step(m1, o1, bs)), float(TL.link_step(m2, o2, bd))
            if l1 != l2:
                raise AssertionError(f"world-1 dist link step {i}: loss {l2}, one device {l1}")
        emit({"phase": "dist_check_world1_link", "batches": 3, "batches_equal": True,
              "losses_equal": True})
        del pair, m1, m2, o1, o2

        # small inputs: the card (NCCL) against the CPU (gloo), uniform,
        # weighted and temporal, the same CPU draws; temporal edges no newer
        # than their targets
        sm = small_cpu
        rows_s = np.repeat(np.arange(sm.num_nodes), np.diff(sm.indptr.numpy()))
        rng = np.random.default_rng(24)
        w_s = rng.uniform(0.05, 1.0, len(rows_s)).astype(np.float32)
        t_s = rng.integers(0, T_RANGE, len(rows_s)).astype(np.int32)
        it_s = rng.integers(0, T_RANGE, sm.num_nodes)
        checked = 0
        for variant, vkw in (("uniform", {}), ("weighted", dict(weight_attr="w")),
                             ("temporal", dict(time_attr="t", input_time=it_s))):
            sides = {}
            for where, m in (("cpu", cpu_mesh), ("card", mesh)):
                gs_s, fs_s = GraphStore(device=m.device), FeatureStore(device=m.device)
                gs_s.put_edge_index((sm.indices.numpy(), rows_s), ("n", "to", "n"),
                                    num_nodes=(sm.num_nodes, sm.num_nodes))
                fs_s["x"], fs_s["y"], fs_s["w"], fs_s["t"] = sm.feats, sm.labels, w_s, t_s
                ld = DistNeighborLoader((fs_s, gs_s), (10, 10), m, batch_size=64,
                                        shuffle=True, dedup=True, **vkw)
                inner, DS.sample_owned = DS.sample_owned, _cpu_draws(25)
                try:
                    sides[where] = [b for _, b in zip(range(3), ld)]
                finally:
                    DS.sample_owned = inner
                if variant == "temporal":
                    csr_t = gs_s.finalize().edge_attr_to_csr_order(("n", "to", "n"), t_s)
                    for b in sides[where]:
                        iid = b.input_id.cpu().numpy()
                        st = torch.as_tensor(np.where(iid >= 0, it_s[np.maximum(iid, 0)], 0),
                                             device=m.device)
                        checked += _check_times(b.sample, st, csr_t)
            if not all(_same_batches(a, b, ("seeds", "x", "y"))
                       for a, b in zip(sides["cpu"], sides["card"])):
                raise AssertionError(f"small {variant} dist loader: card and CPU differ")
            emit({"phase": "small_input_agreement_dist", "variant": variant, "batches": 3,
                  "equal": True})
        emit({"phase": "dist_temporal_check", "edges_checked": checked})

        # -- 5y. the dist loader on a 1 x 1 hierarchical mesh ------------------
        launches["hier_gather"], rows["hier_gather"] = hier_gather(
            dev, emit, (fs, gs), mesh, counters, check_launches, cuda_ms, hbm)
    finally:
        D.finalize()
    return launches, rows


def hier_gather(dev, emit, data, mesh, counters, check_launches, cuda_ms, hbm):
    """Phase 5y (see the module docstring): ``DistNeighborLoader`` on a 1 x 1
    hierarchical mesh against the flat loader, then its feature gather and
    ``HierarchicalDistArray.gather_with_stats`` at a batch's level.  Returns
    the hierarchical loader's launches and row 1's numbers at the owner's
    read."""
    import torch

    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch.loader import DistNeighborLoader
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import (
        gather_rows,
        gather_rows_ref,
        read_rows,
    )
    from cugraph_gnn_tpu_torch.parallel.mesh import create_hierarchical_mesh
    from cugraph_gnn_tpu_torch.store.hierarchical import HierarchicalDistArray

    batches = 3
    hmesh = create_hierarchical_mesh(1, dev)
    kw = dict(batch_size=T.BATCH, shuffle=True, dedup=True, seed=7)
    flat_loader = DistNeighborLoader(data, T.FANOUTS, mesh, **kw)
    flat = [b for _, b in zip(range(batches), flat_loader)]
    loader = DistNeighborLoader(data, T.FANOUTS, hmesh, **kw)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    hier = [b for _, b in zip(range(batches), loader)]
    torch.cuda.synchronize()
    got = check_launches("hierarchical dist loader", batches)
    for i, (a, b) in enumerate(zip(flat, hier)):
        if not _same_batches(a, b, ("seeds", "x", "y")):
            raise AssertionError(f"hierarchical dist loader batch {i} differs from the flat "
                                 f"loader's")
    ids = hier[-1].sample.input_nodes
    arr = HierarchicalDistArray(loader.features.data, loader.features.book, hmesh)
    reads = []

    def owner_read(t, local):
        reads.append(local)
        return read_rows(t, local)

    rows_h, cross = arr.gather_with_stats(ids, read=owner_read)
    if not _bits_equal(rows_h.cpu(), hier[-1].x.cpu()) or int(cross[0]):
        raise AssertionError(f"HierarchicalDistArray.gather_with_stats differs from the "
                             f"loader's features (cross-node count {int(cross[0])})")
    table, local = arr.data, reads[0]
    if not torch.equal(gather_rows(table, local).view(torch.int32),
                       gather_rows_ref(table, local).view(torch.int32)):
        raise AssertionError("row gather at the hierarchical owner read differs from the "
                             "plain version")
    f, n = table.shape[1], local.numel()
    nbytes = 4 * n + 4 * f * n + 4 * f * n        # every id distinct: read once, write once
    row = {"kernel": "gather_rows", "path": "hier_gather", "ids": ids.numel(),
           "distinct": n, "out_dtype": "float32",
           "ms": cuda_ms(lambda: gather_rows(table, local)),
           "plain_ms": cuda_ms(lambda: gather_rows_ref(table, local)),
           "library_ms": cuda_ms(lambda: torch.index_select(table, 0, local)),
           "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "bit_equal": True}
    emit(row)
    emit({"phase": "hier_gather", "mesh": hmesh.shape, "backend": hmesh.backend,
          "batches": batches, "batches_equal_flat": True, "ids": ids.numel(),
          "valid": int((ids >= 0).sum()), "distinct": n, "cross_node_ids": int(cross[0]),
          "launches": got,
          "hier_ms": cuda_ms(lambda: loader.gather_features(ids)),
          "flat_ms": cuda_ms(lambda: flat_loader.gather_features(ids))})
    return got, row


def _zeroed(counters) -> None:
    for fn in counters:
        fn.launches = 0


def _counted(counters, want, what) -> dict:
    """Each wrapper's launches since the last ``_zeroed``; raises unless
    they are ``want`` (row 1 and row 2 by name) and nothing else."""
    got = {fn.__name__: fn.launches for fn in counters}
    expect = {**{name: 0 for name in got}, **want}
    if got != expect:
        raise AssertionError(f"{what}: kernel launches {got}, expected {expect}")
    return got


def _same_bytes(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def checkpoint_round_trip(emit, what, obj, mesh) -> dict:
    """Phase 5z's checkpoints: ``utils/orbax_ckpt.py``'s DCP save and
    restore of ``obj`` (a ``DistArray``, or a ``DistEmbedding`` with its
    optimizer state) on ``mesh`` into a temporary directory, deleted
    afterwards: seconds and GB/s each way; every restored tensor bit-equal."""
    import shutil
    import tempfile

    import torch

    from cugraph_gnn_tpu_torch.utils import orbax_ckpt as O

    emb = hasattr(obj, "table")
    saved = ([obj.table.data] + [obj._state[k] for k in sorted(obj._state)] if emb
             else [obj.data])
    nbytes = sum(t.numel() * t.element_size() for t in saved)
    root = tempfile.mkdtemp(prefix="dcp_")
    try:
        path = os.path.join(root, what)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (O.save_embedding if emb else O.save_dist_array)(path, obj)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = (O.restore_embedding if emb else O.restore_dist_array)(path, mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        files = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    finally:
        shutil.rmtree(root)
    got = ([back.table.data] + [back._state[k] for k in sorted(back._state)] if emb
           else [back.data])
    equal = len(got) == len(saved) and all(
        a.device == b.device and _same_bytes(a, b) for a, b in zip(got, saved))
    row = {"phase": "surface_checkpoint", "what": what, "world": mesh.world,
           "backend": mesh.backend, "tensors": len(saved), "bytes": nbytes,
           "file_bytes": files, "save_s": save_s, "restore_s": restore_s,
           "save_gb_per_s": nbytes / save_s / 1e9, "restore_gb_per_s": nbytes / restore_s / 1e9,
           "bit_equal": equal}
    emit(row)
    if not equal:
        raise AssertionError(f"checkpoint of {what}: the restored tensors differ")
    return row


NATIVE_FILES = (97_000_003, 61_000_011, 98_435_442)   # ~256 MB in three files
NATIVE_OFFSET = 4_097                                 # not 4 KiB aligned


def surface(dev, emit, graph, gs, counters):
    """Phase 5z (see the module docstring).  Returns rows 1 and 2's
    launches on its paths (the doctor, the traced batches, the meter)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cugraph_gnn_tpu_torch import _native, doctor
    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch.data import FeatureStore
    from cugraph_gnn_tpu_torch.loader import NeighborLoader
    from cugraph_gnn_tpu_torch.models import GraphSAGE
    from cugraph_gnn_tpu_torch.store.dist_array import DistArray
    from cugraph_gnn_tpu_torch.store.partition import PartitionBook
    from cugraph_gnn_tpu_torch.utils import distributed as D
    from cugraph_gnn_tpu_torch.utils import profiling

    launches = {}

    # the doctor: the card, and the ring sample through row 2's kernel
    _zeroed(counters)
    report = doctor.smoke_check()
    launches["doctor"] = _counted(counters, {"fused_uniform_sample": 1}, "doctor")
    emit({"phase": "surface_doctor", **report})
    if report["platform"] != "cuda" or report["sample_kernel_launches"] != 1:
        raise AssertionError(f"the doctor's report {report}")

    # the native host code: degrees over the graph's 121M neighbor ids, and a
    # ~256 MB three-file list read back across its boundaries (warm: the
    # files were just written)
    if not _native.have_native():
        raise AssertionError("the host library did not build")
    ids = graph.indices.cpu().numpy()
    t0 = time.perf_counter()
    deg = _native.degrees(ids, graph.num_nodes)
    deg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    deg_np = _native.degrees_np(ids, graph.num_nodes)
    deg_np_s = time.perf_counter() - t0
    del ids
    root = tempfile.mkdtemp(prefix="filelist_")
    try:
        raw = graph.feats.reshape(-1)[:sum(NATIVE_FILES) // 4 + 1].cpu().numpy().view(np.uint8)
        paths, start = [], 0
        for i, size in enumerate(NATIVE_FILES):
            paths.append(os.path.join(root, f"part_{i}.bin"))
            raw[start:start + size].tofile(paths[-1])
            start += size
        length = sum(NATIVE_FILES) - 2 * NATIVE_OFFSET
        want = raw[NATIVE_OFFSET:NATIVE_OFFSET + length]
        reads = {}
        for name, fn in (("native", lambda: _native.load_filelist_bytes(
                             paths, NATIVE_OFFSET, length)),
                         ("native_direct", lambda: _native.load_filelist_bytes(
                             paths, NATIVE_OFFSET, length, use_direct=True)),
                         ("numpy", lambda: _native.load_filelist_bytes_np(
                             paths, NATIVE_OFFSET, length))):
            t0 = time.perf_counter()
            got = fn()
            dt = time.perf_counter() - t0
            reads[name] = {"s": dt, "gb_per_s": length / dt / 1e9,
                           "equal": bool(np.array_equal(got, want))}
            del got
    finally:
        shutil.rmtree(root)
    equal = bool(np.array_equal(deg, deg_np)) and all(r["equal"] for r in reads.values())
    emit({"phase": "surface_native", "degrees_ids": int(graph.indices.numel()),
          "degrees_s": deg_s, "degrees_numpy_s": deg_np_s, "files": list(NATIVE_FILES),
          "offset": NATIVE_OFFSET, "bytes": length, "reads": reads, "cache": "warm",
          "equal_to_numpy": equal})
    if not equal:
        raise AssertionError(f"native degrees or file-list reads differ from numpy: {reads}")

    # the trace around three of 5b's loader batches (dedup, batch 1024,
    # fanouts 10/10), each in an annotate region
    fs = FeatureStore(device=dev)
    fs["x"] = graph.feats
    fs["y"] = graph.labels
    torch.manual_seed(0)
    model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, T.CLASSES, num_layers=len(T.FANOUTS),
                      dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    batches = iter(NeighborLoader((fs, gs), num_neighbors=T.FANOUTS, batch_size=T.BATCH,
                                  shuffle=True, dedup=True))
    _loader_step(model, opt, next(batches))        # warm-up, outside the counts
    torch.cuda.synchronize()
    _zeroed(counters)
    root = tempfile.mkdtemp(prefix="trace_")
    try:
        t0 = time.perf_counter()
        with profiling.trace(root) as tr:
            for _ in range(3):
                with profiling.annotate("loader-batch"):
                    _loader_step(model, opt, next(batches))
            torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        trace_bytes = os.path.getsize(tr.path)
        with open(tr.path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(root)
    launches["trace"] = _counted(counters, {"gather_rows": 3, "fused_uniform_sample": 6},
                                 "traced batches")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in e["name"] for e in kernels)
             for k in ("gather_rows_kernel", "uniform_sample_groups", "uniform_sample_rows")}
    regions = sum(e.get("name") == "loader-batch" for e in events)
    device_us = sum(e.get("dur", 0) for e in kernels)
    emit({"phase": "surface_trace", "batches": 3, "events": len(events),
          "kernel_events": len(kernels), "kernel_us": device_us, "named": found,
          "annotate_regions": regions, "trace_bytes": trace_bytes, "trace_s": trace_s})
    if not (found["gather_rows_kernel"] == 3 and regions >= 3
            and found["uniform_sample_groups"] + found["uniform_sample_rows"] == 6):
        raise AssertionError(f"the trace names {found} and {regions} regions")

    # the meter on 5b's step (a loader batch and its Adam step), beside the
    # same step's CUDA-event times
    meter = profiling.PerformanceMeter(warmup=2, iters=10)
    _zeroed(counters)
    meter_ms = meter.run(lambda acc: acc + _loader_step(model, opt, next(batches)),
                         name="loader_step", items_per_iter=T.BATCH)
    steps = meter.warmup + 1 + meter.iters + 1
    ev = []
    for _ in range(10):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        _loader_step(model, opt, next(batches))
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    event_ms = [a.elapsed_time(b) for a, b in ev]
    steps += len(ev)
    launches["meter"] = _counted(counters, {"gather_rows": steps,
                                            "fused_uniform_sample": 2 * steps}, "meter")
    emit({"phase": "surface_meter", "meter_ms": meter_ms, "meter": meter.metrics,
          "event_ms_mean": sum(event_ms) / len(event_ms), "event_ms": event_ms,
          "batches": steps})
    if not (0 < meter_ms < 1e4):
        raise AssertionError(f"the meter measured {meter_ms} ms")
    del batches, model, opt

    # the checkpoint of 5b's float32 x as a DistArray at world 1 over NCCL
    mesh = D.init(init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        _require_nccl(mesh)
        x = DistArray(graph.feats, PartitionBook.even(graph.num_nodes, 1), mesh)
        checkpoint_round_trip(emit, "loader_x", x, mesh)
    finally:
        D.finalize()
    return launches


OGBN = ("2449029", "61859140", "100")   # ogbn-products: nodes, undirected edges, F


def examples(dev, emit, counters):
    """Phase 5zz (see the module docstring).  Returns rows 1 and 2's
    launches on the two training scripts."""
    import shutil
    import tempfile

    import torch

    from cugraph_gnn_tpu_torch.examples import node_classification, ogbn_convert, ogbn_train

    launches = {}
    root = tempfile.mkdtemp(prefix="ogbn_")
    try:
        t0 = time.perf_counter()
        ogbn_convert.main(["--synthetic", *OGBN, "--parts", "8", "--out", root])
        convert_s = time.perf_counter() - t0
        _zeroed(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = ogbn_train.main(["--dir", root, "--epochs", "1", "--hidden-dim", "256",
                               "--neighbors", "10,10", "--batch-size", "1024"])
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root)
    ep = out["epochs"][0]
    n, e = int(OGBN[0]), int(OGBN[1])                # the 60 / 20 / 20 split's batches
    train, evals = -(-int(0.6 * n) // 1024), (-(-(int(0.8 * n) - int(0.6 * n)) // 1024)
                                              + -(-(n - int(0.8 * n)) // 1024))
    calls = ep["batches"] + evals
    launches["ogbn_train"] = _counted(counters, {"gather_rows": calls,
                                                 "fused_uniform_sample": 2 * calls},
                                      "ogbn_train")
    emit({"phase": "examples_ogbn_train", "convert_s": convert_s, "wall_s": wall,
          "nodes": out["num_nodes"], "directed_edges": out["edges"],
          "feat_dim": out["feat_dim"], "train_batches": ep["batches"], "eval_batches": evals,
          "loss": ep["loss"], "valid_acc": ep["valid_acc"], "test_acc": ep["test_acc"],
          "train_epoch_s": ep["train_s"], "ms_per_train_batch": ep["train_s"] * 1e3 / ep["batches"],
          "launches_per_batch": {k: v / calls for k, v in launches["ogbn_train"].items()},
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if not (out["num_nodes"] == n and out["feat_dim"] == 128 and out["edges"] == 2 * e
            and ep["batches"] == train and math.isfinite(ep["loss"])):
        raise AssertionError(f"ogbn_train: {out}")

    # the smaller run: node_classification at its defaults (10,000 nodes)
    _zeroed(counters)
    t0 = time.perf_counter()
    out = node_classification.main(["--dataset", "synthetic", "--epochs", "2"])
    wall = time.perf_counter() - t0
    calls = 3 * out["batches"]                       # 2 epochs and the evaluation
    launches["node_classification"] = _counted(
        counters, {"gather_rows": calls, "fused_uniform_sample": 2 * calls},
        "node_classification")
    emit({"phase": "examples_node_classification", "wall_s": wall, "losses": out["losses"],
          "train_accuracy": out["train_accuracy"], "batches_per_epoch": out["batches"]})
    if not (out["batches"] == 10 and all(math.isfinite(v) for v in out["losses"])):
        raise AssertionError(f"node_classification: {out}")
    return launches


def _rows_launched(counters, rows, what) -> dict:
    """Each wrapper's launches since the last ``_zeroed``; raises unless
    exactly the wrappers named in ``rows`` launched (some times each)."""
    got = {fn.__name__: fn.launches for fn in counters}
    bad = {k: v for k, v in got.items() if (k in rows) != (v > 0)}
    if bad or not rows:
        raise AssertionError(f"{what}: kernel launches {got}, expected only {sorted(rows)}")
    return got


def _sampled(batches, gathers=1, sampler=2) -> dict:
    """Rows 1 and 2's launches for ``batches`` loader batches."""
    return {"gather_rows": gathers * batches, "fused_uniform_sample": sampler * batches}


BWD_COUNTERS = ("onepass_bwd", "slab_attention_bwd", "slab_attention_bwd_mh")


def _gat_rows(counters) -> set:
    """Full-batch GAT's rows: the attention forward and the one backward
    family that ``backward_design`` picked."""
    bwd = [fn.__name__ for fn in counters if fn.__name__ in BWD_COUNTERS and fn.launches]
    if len(bwd) != 1:
        raise AssertionError(f"full-batch GAT launched the backwards {bwd}")
    return {"slab_attention_spmm_mh", bwd[0]}


@contextlib.contextmanager
def karate_standin():
    """A karate-club stand-in in a temporary file ("src dst weight" rows,
    weight 1), read by the port's ``load_karate`` while the context is open,
    then deleted: 34 nodes in the two groups that
    ``examples/full_batch_training.py`` labels, each pair i < j an edge with
    probability 0.35 inside a group and 0.02 across (``default_rng(0)``),
    plus an edge to the next member of its own group for every node, so that
    none is isolated and node 33 exists.  Yields the file's path."""
    import numpy as np

    from cugraph_gnn_tpu_torch.utils import datasets as DS

    n = 34
    group = np.zeros(n, bool)
    group[[8, 9, 14, 15, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33]] = True
    i, j = np.triu_indices(n, 1)
    keep = np.random.default_rng(0).random(len(i)) < np.where(group[i] == group[j], 0.35, 0.02)
    src, dst = [i[keep]], [j[keep]]
    for g in (group, ~group):
        members = np.nonzero(g)[0]
        src.append(members)
        dst.append(np.roll(members, -1))
    src, dst = np.concatenate(src), np.concatenate(dst)
    key = np.unique(np.minimum(src, dst).astype(np.int64) * n + np.maximum(src, dst))
    fd, path = tempfile.mkstemp(suffix="_karate.csv")
    os.close(fd)
    old = DS.KARATE_DEFAULT
    try:
        np.savetxt(path, np.stack([key // n, key % n, np.ones(len(key))], axis=1),
                   fmt="%d %d %.1f")
        DS.KARATE_DEFAULT = path
        yield path
    finally:
        DS.KARATE_DEFAULT = old
        os.remove(path)


def example_scripts(dev, emit, counters):
    """Phase 5zz, the twelve other scripts' ``main`` at the JAX scripts'
    defaults (see the module docstring).  Returns each run's launches."""
    import importlib.util
    import io

    import torch

    from cugraph_gnn_tpu_torch.embedding.cached import HostManagedCache
    from cugraph_gnn_tpu_torch.examples import (
        cached_embedding_training as CE,
        dist_full_batch_training as DFB,
        fraud_detection as FD,
        full_batch_training as FB,
        hetero_dist_training as HDT,
        hetero_link_pred as HL,
        kg_link_class as KG,
        link_prediction as LP,
        movielens_rec as ML,
        multichip_training as MC,
        rgcn_hetero as RH,
        xgb_downstream as XG,
    )

    have_sklearn = importlib.util.find_spec("sklearn") is not None
    launches = {}

    def run(what, fn, want=None, rows=(), batches=None, argv=None):
        """``fn()`` (a script's main), timed, its stdout kept; launches
        checked: exactly ``want(out)``, or only ``rows``.  ``batches(out)``:
        every batch that launched; the ms a batch are of the training
        batches (``out["train_batches"]`` where the script also sweeps, else
        all), and of the export batches apart."""
        _zeroed(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (_counted(counters, want(out), what) if want is not None
               else _rows_launched(counters, rows(counters) if callable(rows) else rows,
                                   what))
        losses = list(out.get("losses") or [])
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{what}: non-finite loss in {losses}")
        n = batches(out) if batches is not None else None
        n_train = out.get("train_batches", n)
        emit({"phase": f"example_{what}", "argv": argv, "wall_s": wall, "batches": n,
              "ms_per_train_batch": (out["train_s"] * 1e3 / n_train
                                     if n_train and "train_s" in out else None),
              **({"ms_per_export_batch": out["export_s"] * 1e3 / out["export_batches"]}
                 if "export_s" in out else {}),
              "losses_first_last": losses[:1] + losses[-1:],
              **{k: out[k] for k in ("accs", "accuracy", "auc", "downstream", "hit_rate",
                                     "world", "band_fraction", "test_acc") if k in out},
              "launches": {k: v for k, v in got.items() if v},
              "launches_per_batch": {k: v / n for k, v in got.items() if v} if n else None,
              "lines": buf.getvalue().splitlines()[-3:],
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        launches[what] = got
        return out

    def main_of(mod, argv):
        return lambda: mod.main(argv)

    one = ["--epochs", "1"]
    run("fraud_detection", main_of(FD, one), argv=one,
        want=lambda o: _sampled(o["train_batches"] + o["export_batches"]),
        batches=lambda o: o["train_batches"] + o["export_batches"])

    # each step: the lookup's and the update's cache reads, one more a writeback
    wb = [0]
    inner = HostManagedCache._writeback

    def counted(self, s, w, ids):
        wb[0] += int(len(ids) > 0)
        return inner(self, s, w, ids)

    HostManagedCache._writeback = counted
    try:
        run("cached_embedding_training", main_of(CE, one), argv=one,
            want=lambda o: {"gather_rows": 2 * o["steps_per_epoch"] + wb[0],
                            "fused_uniform_sample": 2 * o["steps_per_epoch"],
                            "csr_spmm": o["steps_per_epoch"]},
            batches=lambda o: o["steps_per_epoch"])
    finally:
        HostManagedCache._writeback = inner
    # the typed loaders: a gather per node type, a sampler launch per hop and
    # edge type (none on the temporal hops, which are key-based)
    run("rgcn_hetero", main_of(RH, one), argv=one,
        want=lambda o: _sampled(o["batches"], 3, 6), batches=lambda o: o["batches"])
    for tag, extra in (("hetero_link_pred", []), ("hetero_link_pred_disjoint", ["--disjoint"])):
        run(tag, main_of(HL, one + extra), argv=one + extra,
            want=lambda o: _sampled(o["batches"], 2, 4), batches=lambda o: o["batches"])
    run("kg_link_class", main_of(KG, one), argv=one, want=lambda o: _sampled(o["batches"]),
        batches=lambda o: o["batches"])
    run("movielens_rec", main_of(ML, one), argv=one, want=lambda o: _sampled(o["batches"], 2, 0),
        batches=lambda o: o["batches"])
    run("multichip_training", main_of(MC, one), argv=one,
        want=lambda o: _sampled(len(o["losses"])), batches=lambda o: len(o["losses"]))
    run("hetero_dist_training", main_of(HDT, []), argv=[],
        want=lambda o: _sampled(len(o["losses"]), 2, 4), batches=lambda o: len(o["losses"]))
    run("dist_full_batch_training", main_of(DFB, []), argv=[], rows={"slab_spmm_shard"})
    if have_sklearn:
        run("xgb_downstream", main_of(XG, one), argv=one,
            want=lambda o: _sampled(o["train_batches"] + o["export_batches"]),
            batches=lambda o: o["train_batches"] + o["export_batches"])
    else:
        try:
            XG.main(one)
        except ImportError as e:
            emit({"phase": "example_xgb_downstream_main", "raised": f"ImportError: {e}",
                  "trees_fit": False,
                  "trees_not_fit_because": "scikit-learn is not installed"})
        else:
            raise AssertionError("xgb_downstream ran its trees without scikit-learn")
        args = XG.parse_args(one)
        stats = {}
        run("xgb_downstream_embeddings",
            lambda: (XG.make_embeddings(args, XG.split(args.num_nodes)[0], stats=stats),
                     stats)[1], argv=one,
            want=lambda o: _sampled(o["train_batches"] + o["export_batches"]),
            batches=lambda o: o["train_batches"] + o["export_batches"])
    with karate_standin():
        for model in ("gcn", "sage", "rgcn"):
            run(f"full_batch_training_{model}", main_of(FB, ["--model", model]),
                argv=["--model", model], rows={"slab_spmm"})
        # GAT: the attention forward and the backward that backward_design picks
        run("full_batch_training_gat", main_of(FB, ["--model", "gat"]),
            argv=["--model", "gat"], rows=_gat_rows)
        run("link_prediction", main_of(LP, one), argv=one,
            want=lambda o: _sampled(2 * o["batches"]), batches=lambda o: 2 * o["batches"])
    return launches


# the full-width runs of phase 5zz: each script's own widths at the scale of
# the dataset it stands for
ELLIPTIC = ["--num-nodes", "203769", "--avg-degree", "1", "--feat-dim", "165", "--epochs", "1"]
WIKIKG2 = ["--num-entities", "2500604", "--num-relations", "535", "--num-edges", "16109182"]
ML25M = ["--num-users", "162541", "--num-movies", "62423", "--num-ratings", "25000095"]
MAG_LINK = ["--num-papers", "736389", "--num-authors", "1134649", "--num-writes", "7145660"]
MAG_NODE = ["--num-papers", "736389", "--num-authors", "1134649", "--num-insts", "8740"]
XGB_WIDTH = ["--num_nodes", "203769", "--epochs", "1"]
WIDTH_STEPS = (2, 5)          # warm-up and timed steps


def _levels(levels) -> dict:
    return {"nodes_per_level": [int((lv >= 0).sum()) for lv in levels],
            "slots_per_level": [int(lv.numel()) for lv in levels]}


def _width_steps(emit, counters, what, it, step, per_batch, extra):
    """Phase 5zz's full-width steps: WIDTH_STEPS warm-up and timed batches
    of ``it`` through ``step`` (-> loss, accuracy or None), each timed
    between synchronisations; per batch exactly ``per_batch`` launches."""
    import torch

    warmup, timed = WIDTH_STEPS
    _zeroed(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, accs = [], [], []
    t0 = time.perf_counter()
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batch = next(it)
        loss, acc = step(batch)
        losses.append(float(loss))
        accs.append(None if acc is None else float(acc))
        dt = (time.perf_counter() - t1) * 1e3
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{what}: non-finite loss {losses[-1]} at step {i}")
        if i >= warmup:
            ms.append(dt)
    got = _counted(counters, {k: v * (warmup + timed) for k, v in per_batch.items()}, what)
    emit({"phase": f"example_width_{what}", **extra, "warmup": warmup, "timed": timed,
          "ms_per_step": sum(ms) / len(ms), "ms_min": min(ms), "ms_max": max(ms),
          "losses": losses, "accs": accs, **_levels(batch.sample.levels),
          "launches_per_batch": per_batch,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "steps_wall_s": time.perf_counter() - t0})
    return got


def example_paths(dev, emit, counters):
    """Phase 5zz, the new paths at full width (see the module docstring).
    Returns each run's launches."""
    import importlib.util
    import io

    import torch

    from cugraph_gnn_tpu_torch.examples import (
        fraud_detection as FD,
        hetero_link_pred as HL,
        kg_link_class as KG,
        movielens_rec as ML,
        rgcn_hetero as RH,
        xgb_downstream as XG,
    )
    from cugraph_gnn_tpu_torch.examples.common import loader_step
    from cugraph_gnn_tpu_torch.loader import NeighborLoader

    launches = {}

    class Watched(NeighborLoader):
        """The scripts' loader, keeping its last batch's levels."""
        levels = None

        def __iter__(self):
            for b in super().__iter__():
                Watched.levels = b.sample.levels
                yield b

    def stores(mod, argv):
        t0 = time.perf_counter()
        args = mod.parse_args(argv)
        data = mod.make_data(args)
        t1 = time.perf_counter()
        fs, gs = mod.make_stores(data, dev)
        gs.finalize()
        torch.cuda.synchronize()
        return args, data, fs, gs, {"data_s": t1 - t0, "stores_s": time.perf_counter() - t1}

    def adam(model, args):
        return torch.optim.Adam(model.parameters(), lr=args.lr)

    # fraud detection at Elliptic's size: main (train epoch, export sweep,
    # the downstream model this machine has)
    for mod, what, argv in ((FD, "fraud_detection", ELLIPTIC), (XG, "xgb_downstream", XGB_WIDTH)):
        _zeroed(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mod.NeighborLoader, buf, t0 = Watched, io.StringIO(), time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                if mod is FD or importlib.util.find_spec("sklearn") is not None:
                    out, ran = mod.main(argv), "main"
                else:          # no trees without scikit-learn: the encoder and the export
                    args, out, ran = XG.parse_args(argv), {}, "make_embeddings"
                    XG.make_embeddings(args, XG.split(args.num_nodes)[0], stats=out)
        finally:
            mod.NeighborLoader = NeighborLoader
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = out["train_batches"] + out["export_batches"]
        launches[f"width_{what}"] = _counted(counters, _sampled(calls), f"{what} at width")
        losses = out["losses"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{what} at width: non-finite loss in {losses}")
        emit({"phase": f"example_width_{what}", "argv": argv, "ran": ran, "wall_s": wall,
              "train_batches": out["train_batches"], "export_batches": out["export_batches"],
              "ms_per_train_batch": out["train_s"] * 1e3 / out["train_batches"],
              "ms_per_export_batch": out["export_s"] * 1e3 / out["export_batches"],
              "losses_first_last": losses[:1] + losses[-1:],
              **{k: out[k] for k in ("downstream", "downstream_s", "fit_s", "rf_with_gnn",
                                     "gnn_only", "rf_only", "train_acc", "test_acc")
                 if k in out},
              **({"trees_fit": ran == "main"} if mod is XG else {}),
              **({"trees_not_fit_because": "scikit-learn is not installed"}
                 if ran == "make_embeddings" else {}),
              "lines": buf.getvalue().splitlines()[-2:], **_levels(Watched.levels),
              "launches_per_batch": {k: v / calls for k, v in
                                     launches[f"width_{what}"].items() if v},
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        Watched.levels = None
        torch.cuda.empty_cache()

    # ogbl-wikikg2: 2,500,604 learned entities, 535 relations, edgewise R-GCN
    args, data, fs, gs, setup = stores(KG, WIKIKG2)
    loader = KG.make_loader(fs, gs, data, [10, 10], args.batch_size)
    rel_csr = gs.finalize().edge_attr_to_csr_order(KG.EDGE, data["rel"])
    torch.manual_seed(0)
    model = KG.KGEncoder(args.num_entities, args.hidden_dim, args.num_relations, 2, device=dev)
    opt = adam(model, args)
    launches["width_kg_link_class"] = _width_steps(
        emit, counters, "kg_link_class", iter(loader),
        lambda b: KG.train_step(model, opt, b, rel_csr), _sampled(1),
        {**setup, "argv": WIKIKG2, "triples": len(data["src"]),
         "table_bytes": model.node_emb.numel() * 4})
    del args, data, fs, gs, loader, rel_csr, model, opt
    torch.cuda.empty_cache()

    # MovieLens-25M: temporal link prediction over both orientations
    args, data, fs, gs, setup = stores(ML, ML25M)
    loader = ML.make_loader(fs, gs, data, [10, 10], args.batch_size)
    torch.manual_seed(0)
    model = ML.make_model(gs, args.hidden_dim, 2, dev)
    opt = adam(model, args)
    launches["width_movielens_rec"] = _width_steps(
        emit, counters, "movielens_rec", iter(loader), lambda b: ML.train_step(model, opt, b),
        _sampled(1, 2, 0), {**setup, "argv": ML25M, "positives": int(data["eli"].shape[1])})
    del args, data, fs, gs, loader, model, opt
    torch.cuda.empty_cache()

    # ogbn-mag author-writes-paper link prediction, shared and disjoint
    args, data, fs, gs, setup = stores(HL, MAG_LINK)
    for tag, disjoint in (("hetero_link_pred", False), ("hetero_link_pred_disjoint", True)):
        loader = HL.make_loader(fs, gs, data, [10, 10], args.batch_size, disjoint)
        torch.manual_seed(0)
        model = HL.make_model(gs, args.hidden_dim, 2, dev)
        opt = adam(model, args)
        launches[f"width_{tag}"] = _width_steps(
            emit, counters, tag, iter(loader), lambda b: HL.train_step(model, opt, b),
            _sampled(1, 2, 4), {**setup, "argv": MAG_LINK + (["--disjoint"] if disjoint else [])})
        del loader, model, opt
        torch.cuda.empty_cache()
    del args, data, fs, gs

    # ogbn-mag papers, authors and institutions: typed R-GCN node classification
    args, data, fs, gs, setup = stores(RH, MAG_NODE)
    loader = RH.make_loader(fs, gs, args.num_papers, args.batch_size)
    torch.manual_seed(0)
    model = RH.make_model(gs, args.hidden_dim, dev)
    opt = adam(model, args)
    launches["width_rgcn_hetero"] = _width_steps(
        emit, counters, "rgcn_hetero", iter(loader), lambda b: (loader_step(model, opt, b), None),
        _sampled(1, 3, 6), {**setup, "argv": MAG_NODE, "batch_size": loader.batch_size})
    del args, data, fs, gs, loader, model, opt
    torch.cuda.empty_cache()
    return launches


HETERO_LINK_EDGES = 196_608   # author-writes-paper positives of phase 5s
# each hetero path's launches -> the rows timed at its shapes
HETERO_GATHER_ROWS = {"block": "gather_hetero_block",
                      "loader_typed": "gather_hetero_loader_typed",
                      "loader_dedup": "gather_hetero_loader_dedup",
                      "link": "gather_hetero_link",
                      "dist": "gather_hetero_dist",
                      "dist_link": "gather_hetero_dist_link"}
HETERO_SAMPLER_ROWS = {k: v.replace("gather", "sampler") for k, v in HETERO_GATHER_ROWS.items()}
HETERO_SMALL = {"paper": 3000, "author": 4000, "field": 300}


def _draws_like(sample, seed):
    """CPU uniforms shaped as each (hop, edge type) block of ``sample``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [{n: torch.rand((b.neigh_local.shape[:-1].numel(), b.neigh_local.shape[-1]),
                           generator=g) for n, b in hop.items()} for hop in sample.hops]


class _ListDraws:
    """A hetero loader's sampler fed a given list of per-(hop, edge type)
    CPU uniforms, one entry a batch, moved to its device."""

    def __init__(self, inner, draws):
        self.inner, self.draws, self.calls = inner, draws, 0

    def sample(self, seeds, node_times=None, generator=None):
        u = [{n: a.to(seeds.device) for n, a in h.items()} for h in self.draws[self.calls]]
        self.calls += 1
        return self.inner.sample(seeds, node_times, u=u)


def _fixed_negatives(loader, seed):
    """Make a link loader draw its negatives' candidates from a fresh CPU
    generator every batch, moved to its device."""
    import torch

    from cugraph_gnn_tpu_torch.loader.link_loader import draw_negatives
    from cugraph_gnn_tpu_torch.sampler.negative import NegativeDraws, draw_candidates

    def negatives(ps, n_neg):
        draws = draw_candidates(loader.num_src, loader.num_dst, n_neg, loader.neg,
                                pinned_src=loader.neg.mode == "triplet",
                                rejection=loader._edge_key_sorted is not None,
                                generator=torch.Generator().manual_seed(seed), device="cpu")
        draws = NegativeDraws(*(None if d is None else d.to(loader.device) for d in draws))
        return draw_negatives(ps, n_neg, loader.num_src, loader.num_dst, loader.neg,
                              loader._edge_key_sorted, draws=draws, device=loader.device)

    loader._negatives = negatives


def _sampler_call_rows(emit, calls, names, what, cuda_ms, hbm):
    """Row 2 at each recorded call (indptr, indices, seeds, u, k) of a hetero
    path, in the order hop by hop, edge type by edge type: bit-equal to its
    plain version and between two launches, timed beside it, with its byte
    bound and sector floor."""
    import torch

    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
        fused_uniform_sample,
        fused_uniform_sample_ref,
    )

    rows = []
    for i, (ip, ix, sd, u, k) in enumerate(calls):
        got = fused_uniform_sample(ip, ix, sd, u, k)
        again = fused_uniform_sample(ip, ix, sd, u, k)
        want = fused_uniform_sample_ref(ip, ix, sd, u, k)
        torch.cuda.synchronize()
        if not all(torch.equal(a, w) and torch.equal(a, b) for a, b, w in zip(got, again, want)):
            raise AssertionError(f"sampler at {what} call {i} differs from the plain "
                                 f"version or between two launches")
        nbytes, floor = _sampler_bytes(ip, sd, k, want)
        row = {"kernel": "uniform_sample", "path": what, "hop": i // len(names),
               "etype": names[i % len(names)], "seeds": sd.numel(), "k": k,
               "ms": cuda_ms(lambda: fused_uniform_sample(ip, ix, sd, u, k)),
               "plain_ms": cuda_ms(lambda: fused_uniform_sample_ref(ip, ix, sd, u, k), iters=5),
               "library_ms": None, "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
               "sector_floor_ms": floor / hbm * 1e3, "bit_equal": True}
        emit(row)
        rows.append(row)
    return rows


def hetero_paths(dev, emit, counters, cuda_ms, hbm):
    """Phases 5p-5s (see the module docstring).  Returns each kernel's
    launches on each hetero path, and rows 1 and 2 timed at their shapes."""
    import numpy as np
    import torch

    from cugraph_gnn_tpu_torch import train_hetero as TH
    from cugraph_gnn_tpu_torch import train_link as TL
    from cugraph_gnn_tpu_torch.loader import LinkNeighborLoader, NeighborLoader
    from cugraph_gnn_tpu_torch.loader import link_loader as LL
    from cugraph_gnn_tpu_torch.loader import node_loader as NL
    from cugraph_gnn_tpu_torch.models.zoo import RGCN
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows, gather_rows_ref
    from cugraph_gnn_tpu_torch.sampler import hetero as HS
    from cugraph_gnn_tpu_torch.sampler import neighbor_sampler as NS

    names = [fn.__name__ for fn in counters]
    writes = ("author", "writes", "paper")

    def reset():
        for fn in counters:
            fn.launches = 0

    def check_launches(what, gathers, sampler_calls):
        got = {fn.__name__: fn.launches for fn in counters}
        want = {**{n: 0 for n in names}, "gather_rows": gathers,
                "fused_uniform_sample": sampler_calls}
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
        return got

    real_uniform = NS.uniform_sample
    calls = []

    def recording(indptr, indices, seeds, fanout, *, u=None, generator=None, device=None):
        """The samplers' uniform hop (``neighbor_sampler.one_hop``), its
        inputs kept (the uniforms drawn as ``uniform_sample`` draws them)."""
        if u is None:
            u = torch.rand((seeds.shape[0], fanout), generator=generator, device=device)
        calls.append((indptr, indices, seeds.clone(), u, fanout))
        return real_uniform(indptr, indices, seeds, fanout, u=u, device=device)

    def rgcn(out):
        torch.manual_seed(0)
        m = RGCN(TH.FEAT_DIM, num_relations=len(TH.ETYPES), hidden_features=TH.HIDDEN,
                 out_features=out, device=dev)
        return m, torch.optim.Adam(m.parameters(), lr=TH.LR)

    # -- 5p. the mag-shaped set-up --------------------------------------------------
    t0 = time.perf_counter()
    g = TH.make_synthetic_mag(1, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fs, gs = TH.mag_stores(g, dev)
    store_names = [HS.etype_str(et) for et in gs.finalize().etypes]
    torch.cuda.synchronize()
    emit({"phase": "hetero_setup", "nodes": g.num_nodes, "edges": g.num_edges,
          "max_degree": g.max_degrees, "table": list(g.feats.shape), "graph_s": t1 - t0,
          "stores_s": time.perf_counter() - t1, "store_etypes": store_names})

    launches, rows = {}, {}
    # -- 5q. the typed R-GCN block (train_hetero) -----------------------------------
    model, opt = rgcn(TH.CLASSES)
    gen = torch.Generator(device=dev).manual_seed(2)
    blocks = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    for blk in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, edges = TH.train_block(model, opt, g, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vals = torch.stack(losses).tolist()
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite hetero loss in block {blk}: {vals}")
        emit({"phase": "hetero_train", "block": blk, "warmup": blk == 0, "losses": vals,
              "ms_per_step": dt * 1e3 / TH.REPS, "sampled_edges": int(edges),
              "sampled_edges_per_s": int(edges) / dt,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
    launches["block"] = check_launches("hetero block", TH.REPS * blocks,
                                       2 * len(TH.ETYPES) * blocks)
    emit({"phase": "hetero_launch_counts", "blocks": blocks, "launches": launches["block"]})
    # one more block stage by stage, its uniform hops recorded
    stages = _Stages()
    NS.uniform_sample = recording
    try:
        _, sample = stages.run("sample", TH.sample_block, g, gen)
    finally:
        NS.uniform_sample = real_uniform
    sizes = [lv.shape[1] for lv in sample.levels]
    if sizes != TH.level_sizes():
        raise AssertionError(f"typed level sizes {sizes}, expected {TH.level_sizes()}")
    for i in range(TH.REPS):
        st = sample.step(i)
        x = stages.run("feature_gather", TH.gather_features, st, g.feats)
        stages.run("model", TH.rgcn_step, model, opt, x, st, g.labels)
    took = stages.take()
    emit({"phase": "hetero_stages", "level_sizes": sizes,
          "nodes_per_level_step0": [int((lv[0] >= 0).sum()) for lv in sample.levels],
          "ms_per_step": {k: v / TH.REPS for k, v in took["ms"].items()},
          "host_ms_per_step": {k: v / TH.REPS for k, v in took["host_ms"].items()}})
    rows["sampler_hetero_block"] = _sampler_call_rows(emit, calls, list(TH.ETYPES),
                                                      "hetero_block", cuda_ms, hbm)
    calls.clear()
    # row 1 at the block's gather: 102,912 ids into the f32 table, to bf16
    ids = sample.step(0).input_nodes
    if not torch.equal(gather_rows(g.feats, ids, torch.bfloat16).view(torch.int16),
                       gather_rows_ref(g.feats, ids, torch.bfloat16).view(torch.int16)):
        raise AssertionError("row gather (hetero block) differs from the plain version")
    f = g.feats.shape[1]
    uniq = int(torch.unique(ids[ids >= 0]).numel())
    nbytes = 4 * ids.numel() + 4 * f * uniq + 2 * f * ids.numel()
    rows["gather_hetero_block"] = {
        "kernel": "gather_rows", "path": "hetero_block", "ids": ids.numel(),
        "table": list(g.feats.shape), "out_dtype": "bfloat16",
        "ms": cuda_ms(lambda: gather_rows(g.feats, ids, torch.bfloat16)),
        "plain_ms": cuda_ms(lambda: gather_rows_ref(g.feats, ids, torch.bfloat16)),
        "library_ms": cuda_ms(lambda: torch.index_select(
            g.feats, 0, ids.clamp(min=0)).to(torch.bfloat16)),
        "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "bit_equal": True}
    emit(rows["gather_hetero_block"])
    with torch.no_grad():
        logits = model.batch_call(x, st, list(TH.ETYPES))
    if logits.shape != (TH.BATCH, TH.CLASSES) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"hetero logits {tuple(logits.shape)} not finite")
    del sample, st, x, logits, model, opt

    # -- 5r. the hetero loaders (typed segments, then deduplicated) ----------------------
    def at_extra_batch(what, next_batch):
        """One more batch with its uniform hops recorded, then rows 2 (each
        hop call) and 1 (the paper join: the level's slots, the papers' rows,
        f32 to f32) at its shapes."""
        NS.uniform_sample = recording
        try:
            extra = next_batch()
        finally:
            NS.uniform_sample = real_uniform
        sampler_rows = _sampler_call_rows(emit, calls, store_names, what, cuda_ms, hbm)
        calls.clear()
        local = extra.sample.input_nodes.reshape(-1) - gs.node_offset("paper")
        ok = (local >= 0) & (local < TH.MAG_NODES["paper"])
        ids = torch.where(ok, local, -1)
        gather_row = _gather_row(emit, fs.get_tensor("paper", "x"), ids,
                                 int(torch.unique(ids[ok]).numel()), cuda_ms, hbm,
                                 f"{what} paper join")
        return sampler_rows, gather_row

    def run_loader(what, loader, batches, warmup):
        model, opt = rgcn(TH.CLASSES)
        stages = _Stages()
        stages.wrap(loader.sampler, "sample", "sample")
        stages.wrap(loader, "_gather_y", "labels")
        orig = NL.gather_node_features
        NL.gather_node_features = lambda *a: stages.run("feature_join", orig, *a)
        it = iter(loader)
        ms, by_stage = [], []
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            for i in range(batches):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                batch = next(it)
                loss = stages.run("model", TH.loader_step, model, opt, batch, store_names)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t1) * 1e3
                took = stages.take()
                if i >= warmup:
                    ms.append(dt)
                    by_stage.append(took["ms"])
                loss = float(loss)
                if not math.isfinite(loss):
                    raise AssertionError(f"non-finite {what} loss {loss} at batch {i}")
                emit({"phase": f"{what}_train", "batch": i, "warmup": i < warmup,
                      "loss": loss, "ms": dt, "stages": took,
                      "x_types": sorted(batch.x),
                      "nodes_per_level": [int((lv >= 0).sum()) for lv in batch.sample.levels],
                      "slots_per_level": [int(lv.numel()) for lv in batch.sample.levels],
                      "max_memory_allocated": torch.cuda.max_memory_allocated()})
            got = check_launches(what, 3 * batches, 2 * len(store_names) * batches)
        finally:
            NL.gather_node_features = orig
            del loader.sampler.sample, loader._gather_y
        emit({"phase": f"{what}_launch_counts", "launches": got, "batches": batches,
              "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms),
              "ms_min": min(ms), "ms_max": max(ms),
              "stages_ms_per_batch": {k: sum(d.get(k, 0.0) for d in by_stage) / len(by_stage)
                                      for k in by_stage[0]}})
        rows[f"sampler_{what}"], rows[f"gather_{what}"] = at_extra_batch(
            what, lambda: next(it))
        return got

    kw = dict(input_nodes=("paper", np.arange(TH.MAG_NODES["paper"])), batch_size=TH.BATCH,
              shuffle=True)
    loader = NeighborLoader((fs, gs), TH.FANOUTS, dedup=False, **kw)
    if loader.sampler.seed_type != "paper":
        raise AssertionError("the typed loader did not take typed target segments")
    launches["loader_typed"] = run_loader("hetero_loader_typed", loader, 8, 2)
    del loader
    loader = NeighborLoader((fs, gs), TH.FANOUTS, dedup=True, **kw)
    launches["loader_dedup"] = run_loader("hetero_loader_dedup", loader, 6, 2)
    del loader

    # -- 5s. the typed link batch: author-writes-paper positives ------------------------
    src_w, dst_w = gs.get_edge_index(writes)
    pick = np.random.default_rng(13).choice(len(src_w), HETERO_LINK_EDGES, replace=False)
    t0 = time.perf_counter()
    loader = LinkNeighborLoader((fs, gs), TH.FANOUTS, (writes, np.stack([src_w[pick],
                                                                         dst_w[pick]])),
                                neg_sampling="binary", batch_size=TH.BATCH, shuffle=True,
                                reject_true_edges=True)
    emit({"phase": "hetero_link_setup", "positives": HETERO_LINK_EDGES,
          "batches_per_epoch": len(loader), "setup_s": time.perf_counter() - t0,
          "num_src": loader.num_src, "num_dst": loader.num_dst})
    model, opt = rgcn(TH.HIDDEN)
    enc = TH.RGCNEncoder(model, store_names, dtype=torch.bfloat16)
    stages = _Stages()
    stages.wrap(loader, "_negatives", "negatives")
    stages.wrap(loader.sampler, "sample", "sample")
    orig = LL.gather_node_features
    LL.gather_node_features = lambda *a: stages.run("feature_join", orig, *a)
    it, ms, batches, warmup = iter(loader), [], 6, 2
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        for i in range(batches):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch = next(it)
            loss = stages.run("link_step", TL.link_step, enc, opt, batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t1) * 1e3
            if i >= warmup:
                ms.append(dt)
            loss = float(loss)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite hetero link loss {loss} at batch {i}")
            b = TH.BATCH
            emit({"phase": "hetero_link_train", "batch": i, "warmup": i < warmup,
                  "loss": loss, "ms": dt, "stages": stages.take(),
                  "valid_positives": int((batch.seeds[:b] >= 0).sum()),
                  "valid_negatives": int(((batch.seeds[2 * b:3 * b] >= 0)
                                          & (batch.seeds[3 * b:] >= 0)).sum()),
                  "nodes_per_level": [int((lv >= 0).sum()) for lv in batch.sample.levels],
                  "slots_per_level": [int(lv.numel()) for lv in batch.sample.levels],
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
        launches["link"] = check_launches("hetero link", 3 * batches,
                                          2 * len(store_names) * batches)
    finally:
        LL.gather_node_features = orig
        del loader._negatives, loader.sampler.sample
    rows["sampler_hetero_link"], rows["gather_hetero_link"] = at_extra_batch(
        "hetero_link", lambda: next(it))
    emit({"phase": "hetero_link_launch_counts", "launches": launches["link"],
          "batches": batches, "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms),
          "ms_min": min(ms), "ms_max": max(ms)})
    del loader, model, opt, enc, batch, it
    dist_launches, dist_rows = hetero_dist_paths(dev, emit, fs, gs, store_names, counters,
                                                 rgcn, at_extra_batch, cuda_ms, hbm)
    launches.update(dist_launches)
    rows.update(dist_rows)
    del fs, gs, g
    torch.cuda.empty_cache()

    # -- small input, hetero: card against CPU --------------------------------------------
    small = TH.make_synthetic_mag(3, "cpu", num_nodes=HETERO_SMALL, feat_dim=16, classes=5)
    seeds = torch.randint(0, HETERO_SMALL["paper"], (3, 64), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(4))
    seeds[:, ::9] = -1
    u = _draws_like(HS.hetero_multihop_batched(seeds, generator=torch.Generator().manual_seed(0),
                                               device="cpu", **small.sampler_args()), 5)
    torch.manual_seed(3)
    ref = RGCN(16, num_relations=3, hidden_features=32, out_features=5, device="cpu")
    sides, draws = [], {}
    for d in (torch.device("cpu"), dev):
        gd = TH.SyntheticMag({n: (a.to(d), b.to(d)) for n, (a, b) in small.csrs.items()},
                             small.edge_bases, small.max_degrees, small.num_edges,
                             small.num_nodes, small.feats.to(d), small.labels.to(d))
        sm = HS.hetero_multihop_batched(seeds.to(d), device=d,
                                        u=[{n: a.to(d) for n, a in h.items()} for h in u],
                                        **gd.sampler_args())
        m = RGCN(16, num_relations=3, hidden_features=32, out_features=5, device=d)
        m.load_state_dict(ref.state_dict())
        o = torch.optim.Adam(m.parameters(), lr=TH.LR)
        xs = [TH.gather_features(sm.step(i), gd.feats, torch.float32) for i in range(3)]
        ls = [float(TH.rgcn_step(m, o, xs[i], sm.step(i), gd.labels)) for i in range(3)]
        loaders = {}
        for mode in ("typed", "dedup", "link"):
            fs_d, gs_d = TH.mag_stores(gd, d)
            if mode == "link":
                s_w, d_w = gs_d.get_edge_index(writes)
                ld = LinkNeighborLoader((fs_d, gs_d), (4, 3), (writes, np.stack([s_w[:600],
                                                                                 d_w[:600]])),
                                        neg_sampling="binary", batch_size=128, shuffle=True,
                                        reject_true_edges=True)
                _fixed_negatives(ld, 16)
            else:
                ld = NeighborLoader((fs_d, gs_d), (4, 3), batch_size=128, shuffle=True,
                                    input_nodes=("paper", np.arange(1000)),
                                    dedup=mode == "dedup")
            if d.type == "cpu":     # the draws, shaped as the CPU's first pass
                first = [b for _, b in zip(range(3), ld)]
                ld._epoch = 0
                draws[mode] = [_draws_like(b.sample, 30 + i) for i, b in enumerate(first)]
            ld.sampler = _ListDraws(ld.sampler, draws[mode])
            torch.manual_seed(7)
            mm = RGCN(16, num_relations=3, hidden_features=32,
                      out_features=16 if mode == "link" else 5, device="cpu").to(d)
            oo = torch.optim.Adam(mm.parameters(), lr=TH.LR)
            names_d = [HS.etype_str(et) for et in gs_d.finalize().etypes]
            out = []
            for _, b in zip(range(3), ld):
                if mode == "link":
                    step = TL.link_step(TH.RGCNEncoder(mm, names_d), oo, b)
                else:
                    step = TH.loader_step(mm, oo, b, names_d, dtype=torch.float32)
                out.append((b, float(step)))
            loaders[mode] = out
        sides.append((sm, xs, ls, loaders))
    (sc, xc, lc, ldc), (sg, xg, lg, ldg) = sides
    equal = all(torch.equal(a, b.cpu()) for a, b in zip(sc.levels, sg.levels))
    for hc, hg in zip(sc.hops, sg.hops):
        equal &= all(torch.equal(a, b.cpu()) for n in hc for a, b in zip(hc[n][:3], hg[n][:3]))
    equal &= all(_bits_equal(a, b.cpu()) for a, b in zip(xc, xg))
    loss_diff = max(abs(a - b) for a, b in zip(lc, lg))
    for mode in ("typed", "dedup", "link"):
        for (bc, l1), (bg, l2) in zip(ldc[mode], ldg[mode]):
            a = [bc.seeds] + [bc.x[k] for k in sorted(bc.x)] + bc.sample.levels + [
                t for h in bc.sample.hops for n in sorted(h) for t in h[n][:3]]
            b = [bg.seeds] + [bg.x[k] for k in sorted(bg.x)] + bg.sample.levels + [
                t for h in bg.sample.hops for n in sorted(h) for t in h[n][:3]]
            equal &= all(_bits_equal(p, q.cpu()) if p.is_floating_point()
                         else torch.equal(p, q.cpu()) for p, q in zip(a, b))
            loss_diff = max(loss_diff, abs(l1 - l2))
    if not (equal and loss_diff <= 1e-4):
        raise AssertionError(f"small hetero paths, card vs CPU: equal {equal}, losses differ "
                             f"by {loss_diff}")
    emit({"phase": "small_input_agreement_hetero", "paths": ["block", "typed", "dedup", "link"],
          "steps": 3, "equal": True, "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})
    return launches, rows


class _HeteroRecordDraws:
    """A one-device hetero loader's sampler whose uniforms come from a CPU
    generator (seeded), kept with the batch's levels for
    :class:`_HeteroFrameDraws`."""

    def __init__(self, inner, seed):
        import torch

        self.inner, self.gen, self.last = inner, torch.Generator().manual_seed(seed), None

    def sample(self, seeds, node_times=None, generator=None):
        import torch

        caps = self.inner.level_caps(seeds.shape[0])
        u = [{n: torch.rand((caps[h], f[h]), generator=self.gen).to(seeds.device)
              for n, f in self.inner.fanouts.items() if f is not None and f[h] > 0}
             for h in range(self.inner.num_hops)]
        batch = self.inner.sample(seeds, node_times, u=u)
        self.last = (u, batch.levels)
        return batch


class _HeteroFrameDraws:
    """A world-1 hetero dist sampler taking the draws of the one-device batch
    just recorded: at world 1 a hop's frame is its level's valid targets."""

    def __init__(self, inner, record):
        self.inner, self.record = inner, record

    def sample(self, seeds, node_times=None, generator=None):
        u, levels = self.record.last
        return self.inner.sample(seeds, node_times, u=[
            {n: a[lv >= 0] for n, a in uh.items()} for uh, lv in zip(u, levels)])


def _same_hetero(a, b, fields=("seeds",)) -> bool:
    """Two hetero batches' levels, counts, blocks (by edge type), feature
    dicts and ``fields`` bit for bit equal, on the host."""
    import torch

    def tensors(x):
        yield from x.sample.levels + list(x.sample.level_counts)
        for hop in x.sample.hops:
            for n in sorted(hop):
                yield from (t for t in hop[n] if t is not None)
        for k in sorted(x.x):
            yield x.x[k]
        for f in fields:
            yield getattr(x, f)

    if [sorted(h) for h in a.sample.hops] != [sorted(h) for h in b.sample.hops] or \
            sorted(a.x) != sorted(b.x):
        return False
    return all(_bits_equal(p.cpu(), q.cpu()) if p.is_floating_point()
               else torch.equal(p.cpu(), q.cpu()) for p, q in zip(tensors(a), tensors(b)))


def _check_hetero_times(sample, seed_time, times, bases) -> int:
    """Every sampled edge of a hetero ``sample`` of an edge type with times
    (``times``: name -> per-edge times in CSR order, ``bases``: name -> edge
    base) is no newer than its target's propagated time; raises otherwise.
    Returns the edges checked."""
    import torch

    from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import propagate_times

    st, checked = seed_time, 0
    for h, hop in enumerate(sample.hops):
        for n, blk in hop.items():
            if n not in times:
                continue
            e = blk.edge_ids.long() - bases[n]
            ok = blk.edge_ids >= 0
            if bool((ok & (times[n][e.clamp(min=0)] > st[:, None])).any()):
                raise AssertionError(f"hop {h} {n} sampled an edge newer than its target")
            checked += int(ok.sum())
        loc = torch.cat([b.neigh_local for b in hop.values()], dim=1)
        st = propagate_times(st[None], loc[None], sample.levels[h + 1].shape[0])[0]
    return checked


def hetero_dist_paths(dev, emit, fs, gs, names, counters, rgcn, at_extra_batch, cuda_ms, hbm):
    """Phases 5w and 5x (see the module docstring), on 5p's stores in a new
    NCCL world of 1.  Returns each kernel's launches on the hetero dist
    loader and link paths, and rows 1 and 2 timed at their shapes."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cugraph_gnn_tpu_torch import train_hetero as TH
    from cugraph_gnn_tpu_torch import train_link as TL
    from cugraph_gnn_tpu_torch.data import FeatureStore, GraphStore
    from cugraph_gnn_tpu_torch.loader import (
        DistLinkNeighborLoader,
        DistNeighborLoader,
        LinkNeighborLoader,
        NeighborLoader,
    )
    from cugraph_gnn_tpu_torch.parallel.mesh import create_store_mesh
    from cugraph_gnn_tpu_torch.sampler import hetero_dist as HD
    from cugraph_gnn_tpu_torch.store import dist_array as DA
    from cugraph_gnn_tpu_torch.train_dist import dist_train_step
    from cugraph_gnn_tpu_torch.utils import distributed as D

    per_batch = {fn.__name__: 0 for fn in counters}
    per_batch.update(gather_rows=3, fused_uniform_sample=2 * len(names))
    writes = ("author", "writes", "paper")

    def reset():
        for fn in counters:
            fn.launches = 0

    def check_launches(what, batches):
        got = {fn.__name__: fn.launches for fn in counters}
        want = {k: v * batches for k, v in per_batch.items()}
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got}, expected {want}")
        return got

    def delta(before):
        return {k: DA.EXCHANGES[k] - before[k] for k in before}

    def run(what, loader, step, batches=6, warmup=2):
        """``batches`` batches of ``loader`` through ``step`` (2 warm-up), as
        5t: per batch the loss, times, exchanges, levels and memory."""
        it = iter(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        ms = []
        for i in range(batches):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            before = dict(DA.EXCHANGES)
            batch = next(it)
            in_loader = delta(before)
            loss = step(batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t1) * 1e3
            if i >= warmup:
                ms.append(dt)
            loss = float(loss)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite {what} loss {loss} at batch {i}")
            emit({"phase": f"{what}_train", "batch": i, "warmup": i < warmup, "loss": loss,
                  "ms": dt, "x_types": sorted(batch.x),
                  "sampled_edges": int(sum(b.mask.sum() for hop in batch.sample.hops
                                           for b in hop.values())),
                  "nodes_per_level": [int(c) for c in batch.sample.level_counts],
                  "slots_per_level": [int(lv.numel()) for lv in batch.sample.levels],
                  "loader_exchanges": in_loader,
                  "step_exchanges": {k: v - in_loader[k] for k, v in delta(before).items()},
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
        got = check_launches(what, batches)
        emit({"phase": f"{what}_launch_counts", "launches": got, "batches": batches,
              "batches_timed": len(ms), "ms_per_batch": sum(ms) / len(ms), "ms_min": min(ms),
              "ms_max": max(ms)})
        return it, got

    stages = _Stages()

    def watch(loader):
        """Time each hop's routing, each edge type's sample on the owner and
        the return, each type's feature gather and the labels; undo with the
        returned function."""
        hop = [-1]
        by_graph = {id(dg): n for n, dg in loader.graph.graphs.items()}
        saved = {k: getattr(HD, k) for k in DIST_STAGES}

        def route(*a, **kw):
            hop[0] = (hop[0] + 1) % len(TH.FANOUTS["paper__cites__paper"])
            return stages.run(f"hop{hop[0]}_route", saved["route_to_owners"], *a, **kw)

        HD.route_to_owners = route
        HD.sample_owned = lambda g, *a, **kw: stages.run(
            f"hop{hop[0]}_sample_{by_graph[id(g)]}", saved["sample_owned"], g, *a, **kw)
        HD.route_back = lambda *a, **kw: stages.run(f"hop{hop[0]}_return",
                                                    saved["route_back"], *a, **kw)
        gather = loader.gather
        by_arr = {id(a): nt for nt, a in loader.features.items()}
        loader.gather = lambda arr, ids, fill=0, read=None: stages.run(
            "labels" if read is None else f"feature_gather_{by_arr[id(arr)]}", gather, arr,
            ids, fill, read)

        def undo():
            for k, fn in saved.items():
                setattr(HD, k, fn)
            del loader.gather
        return undo

    mesh = D.init(init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    launches, rows = {}, {}
    try:
        _require_nccl(mesh)
        cpu_mesh = create_store_mesh("cpu", group=dist.new_group([0], backend="gloo"))

        # -- 5w. the hetero dist loader at full width, world 1 over NCCL ---------
        kw = dict(input_nodes=("paper", np.arange(TH.MAG_NODES["paper"])),
                  batch_size=TH.BATCH, shuffle=True)
        t0 = time.perf_counter()
        loader = DistNeighborLoader((fs, gs), TH.FANOUTS, mesh, **kw)
        torch.cuda.synchronize()
        emit({"phase": "hetero_dist_setup", "setup_s": time.perf_counter() - t0,
              "edge_id_bits": loader.graph.edge_id_bits,
              "edge_bases": loader.graph.edge_base_by_etype,
              "shard_edges": {n: int(g.indices.numel()) for n, g in loader.graph.graphs.items()},
              "feature_types": sorted(loader.features), "label_offset": loader.label_offset})
        model, opt = rgcn(TH.CLASSES)
        enc = TH.RGCNEncoder(model, names, dtype=torch.bfloat16)
        it, launches["dist"] = run("hetero_dist_loader", loader,
                                   lambda b: dist_train_step(enc, opt, b, mesh))
        undo = watch(loader)
        try:
            for _ in range(3):
                batch = stages.run("batch", next, it)
                stages.run("step", dist_train_step, enc, opt, batch, mesh)
        finally:
            undo()
        emit({"phase": "hetero_dist_loader_stages", "batches": 3, **stages.take()})
        rows["sampler_hetero_dist"], rows["gather_hetero_dist"] = at_extra_batch(
            "hetero_dist", lambda: next(it))
        with torch.no_grad():
            logits = enc(batch.x, batch.sample)
        if logits.shape != (TH.BATCH, TH.CLASSES) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"hetero dist logits {tuple(logits.shape)} not finite")
        del loader, it, batch, logits, model, opt, enc

        # -- 5x. the hetero dist link loader ---------------------------------------------
        src_w, dst_w = gs.get_edge_index(writes)
        pick = np.random.default_rng(13).choice(len(src_w), HETERO_LINK_EDGES, replace=False)
        eli = (writes, np.stack([src_w[pick], dst_w[pick]]))
        link_kw = dict(neg_sampling="binary", batch_size=TH.BATCH, shuffle=True,
                       reject_true_edges=True)
        loader = DistLinkNeighborLoader((fs, gs), TH.FANOUTS, mesh, edge_label_index=eli,
                                        **link_kw)
        model, opt = rgcn(TH.HIDDEN)
        enc = TH.RGCNEncoder(model, names, dtype=torch.bfloat16)
        it, launches["dist_link"] = run("hetero_dist_link", loader,
                                        lambda b: TL.link_step(enc, opt, b))
        rows["sampler_hetero_dist_link"], rows["gather_hetero_dist_link"] = at_extra_batch(
            "hetero_dist_link", lambda: next(it))
        del loader, it, model, opt, enc

        # -- checks: world-1 hetero dist batches against the one-device loaders ------
        single = NeighborLoader((fs, gs), TH.FANOUTS, dedup=True, **kw)
        dl = DistNeighborLoader((fs, gs), TH.FANOUTS, mesh, **kw)
        single.sampler = _HeteroRecordDraws(single.sampler, 31)
        dl.sampler = _HeteroFrameDraws(dl.sampler, single.sampler)
        (m1, o1), (m2, o2) = rgcn(TH.CLASSES), rgcn(TH.CLASSES)
        for i, bs, bd in zip(range(3), single, dl):
            valid = bs.seeds >= 0
            if not (_same_hetero(bs, bd) and torch.equal(bs.y[valid], bd.y[valid])
                    and bool((bd.y[~valid] == -1).all())):
                raise AssertionError(f"world-1 hetero dist batch {i} differs from the "
                                     f"one-device batch")
            l1 = float(TH.loader_step(m1, o1, bs, names))
            l2 = float(dist_train_step(TH.RGCNEncoder(m2, names, torch.bfloat16), o2, bd,
                                       mesh))
            if l1 != l2:
                raise AssertionError(f"world-1 hetero dist step {i}: loss {l2}, one device {l1}")
        emit({"phase": "hetero_dist_check_world1", "batches": 3, "batches_equal": True,
              "losses_equal": True, "last_loss": l1})
        pair = [LinkNeighborLoader((fs, gs), TH.FANOUTS, eli, **link_kw),
                DistLinkNeighborLoader((fs, gs), TH.FANOUTS, mesh, edge_label_index=eli,
                                       **link_kw)]
        for ld in pair:
            _fixed_negatives(ld, 32)
        pair[0].sampler = _HeteroRecordDraws(pair[0].sampler, 33)
        pair[1].sampler = _HeteroFrameDraws(pair[1].sampler, pair[0].sampler)
        (m1, o1), (m2, o2) = rgcn(TH.HIDDEN), rgcn(TH.HIDDEN)
        e1, e2 = (TH.RGCNEncoder(m, names, dtype=torch.bfloat16) for m in (m1, m2))
        for i, bs, bd in zip(range(3), *pair):
            if not _same_hetero(bs, bd, ("seeds", "edge_label_index", "edge_label")):
                raise AssertionError(f"world-1 hetero dist link batch {i} differs from the "
                                     f"one-device batch")
            l1, l2 = float(TL.link_step(e1, o1, bs)), float(TL.link_step(e2, o2, bd))
            if l1 != l2:
                raise AssertionError(f"world-1 hetero dist link step {i}: loss {l2}, "
                                     f"one device {l1}")
        emit({"phase": "hetero_dist_check_world1_link", "batches": 3, "batches_equal": True,
              "losses_equal": True})
        del single, dl, pair, m1, m2, o1, o2, e1, e2

        # small inputs: the card (NCCL) against the CPU (gloo), uniform, weighted
        # and temporal, the same CPU draws; temporal edges no newer than targets
        small = TH.make_synthetic_mag(3, "cpu", num_nodes=HETERO_SMALL, feat_dim=16, classes=5)
        fs_c, gs_c = TH.mag_stores(small, "cpu")
        rng = np.random.default_rng(34)
        attrs = {}
        for et in gs_c.edge_types:
            n_e = len(gs_c.get_edge_index(et)[0])
            attrs[et] = (rng.uniform(0.05, 1.0, n_e).astype(np.float32),
                         rng.integers(0, T_RANGE, n_e).astype(np.int32))
        it_s = rng.integers(0, T_RANGE, HETERO_SMALL["paper"])
        checked = 0
        for variant, vkw in (("uniform", {}), ("weighted", dict(weight_attr="w")),
                             ("temporal", dict(time_attr="t", input_time=it_s))):
            sides = {}
            for where, m in (("cpu", cpu_mesh), ("card", mesh)):
                gs_s, fs_s = GraphStore(device=m.device), FeatureStore(device=m.device)
                for et in gs_c.edge_types:
                    st_, _, dt_ = et
                    gs_s.put_edge_index(gs_c.get_edge_index(et), et,
                                        num_nodes=(gs_c.num_nodes(st_), gs_c.num_nodes(dt_)))
                    key = "__".join(et)
                    fs_s[(key, "w")], fs_s[(key, "t")] = attrs[et]
                for nt in gs_c.node_types:
                    fs_s[(nt, "x")] = fs_c.get_tensor(nt, "x")
                fs_s[("paper", "y")] = fs_c.get_tensor("paper", "y")
                ld = DistNeighborLoader((fs_s, gs_s), (4, 3), m, batch_size=64, shuffle=True,
                                        input_nodes=("paper", np.arange(HETERO_SMALL["paper"])),
                                        **vkw)
                inner, HD.sample_owned = HD.sample_owned, _cpu_draws(35, HD)
                try:
                    sides[where] = [b for _, b in zip(range(3), ld)]
                finally:
                    HD.sample_owned = inner
                if variant == "temporal":
                    graph_s = gs_s.finalize()
                    times = {"__".join(et): graph_s.edge_attr_to_csr_order(et, attrs[et][1])
                             for et in graph_s.etypes}
                    bases = {"__".join(et): graph_s.csr_by_etype[et][2] for et in graph_s.etypes}
                    for b in sides[where]:
                        iid = b.input_id.cpu().numpy()
                        st = torch.as_tensor(np.where(iid >= 0, it_s[np.maximum(iid, 0)], 0),
                                             device=m.device)
                        checked += _check_hetero_times(b.sample, st, times, bases)
            if not all(_same_hetero(a, b, ("seeds", "y"))
                       for a, b in zip(sides["cpu"], sides["card"])):
                raise AssertionError(f"small {variant} hetero dist loader: card and CPU differ")
            emit({"phase": "small_input_agreement_hetero_dist", "variant": variant,
                  "batches": 3, "equal": True})
        if not checked:
            raise AssertionError("the temporal hetero dist batches sampled no edge")
        emit({"phase": "hetero_dist_temporal_check", "edges_checked": checked})
    finally:
        D.finalize()
    return launches, rows


def _gather_row(emit, table, ids, distinct, cuda_ms, hbm, what):
    """Row 1 on ``table`` (f32 to f32) at ``ids``, ``distinct`` of them
    valid and distinct: bit-equal to its plain version, timed beside it and
    ``index_select``, with its byte bound."""
    import torch

    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import gather_rows, gather_rows_ref

    if not _bits_equal(gather_rows(table, ids), gather_rows_ref(table, ids)):
        raise AssertionError(f"row gather ({what}) differs from the plain version")
    f = table.shape[1]
    nbytes = ids.element_size() * ids.numel() + 4 * f * distinct + 4 * f * ids.numel()
    row = {"kernel": "gather_rows", "path": what, "ids": ids.numel(), "table": list(table.shape),
           "out_dtype": "float32", "ms": cuda_ms(lambda: gather_rows(table, ids)),
           "plain_ms": cuda_ms(lambda: gather_rows_ref(table, ids)),
           "library_ms": cuda_ms(lambda: torch.index_select(table, 0, ids.clamp(min=0))),
           "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "bit_equal": True}
    emit(row)
    return row


def full_batch(dev, emit, cuda_ms, hbm, counters):
    """Phases 6-9 (see the module docstring).  Returns the ``kernels`` rows
    of the band kernel and the CSR SpMM kernel, and what the GAT phases
    reuse: the graph's COO, its ``FullBatchGraph``, f32 features and
    labels."""
    import torch
    from torch.nn import functional as F

    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.models.zoo import GCN, GIN, GraphSAGE
    from cugraph_gnn_tpu_torch.ops import full_batch as FB
    from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
        slab_spmm,
        slab_spmm_band,
        slab_spmm_band_ref,
        slab_spmm_ref,
    )
    from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import csr_spmm, csr_spmm_ref

    # -- 6. full-batch data --------------------------------------------------
    t0 = time.perf_counter()
    g = TF.make_synthetic_banded(0, dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fbg = FullBatchGraph.from_coo(g.src, g.dst, g.num_nodes, reorder="none",
                                  block_rows=TF.BLOCK_ROWS, device=dev)
    torch.cuda.synchronize()
    n, edges = g.num_nodes, g.num_edges
    slabs = {"graph": fbg.slab, "transpose": fbg.slab_t}
    fb_edges = {k: int((s.fb_src >= 0).sum()) for k, s in slabs.items()}
    emit({"phase": "full_batch_data", "nodes": n, "edges": edges,
          "data_s": data_s, "full_batch_graph_s": time.perf_counter() - t0,
          "build_seconds": fbg.build_seconds, "band_fraction": fbg.band_fraction,
          "ell_k": {k: s.ell.shape[1] for k, s in slabs.items()},
          "fallback_edges": fb_edges,
          "max_degree": {k: int(s.degrees.max()) for k, s in slabs.items()},
          "max_fallback_row": {k: int((s.fb_rowptr[1:] - s.fb_rowptr[:-1]).max())
                               for k, s in slabs.items()}})
    if not 0.5 < fbg.band_fraction < 1.0 or not fbg.use_slab:
        raise AssertionError(f"band fraction {fbg.band_fraction}: the slab path "
                             f"and the fallback must both do work")

    # -- 7. full-batch kernels at full width --------------------------------
    check = _check_sum
    gen = torch.Generator(device=dev).manual_seed(5)
    xs = {128: g.feats, 256: torch.randn((n, 256), generator=gen, device=dev)}
    errs = {"slab_spmm": 0.0, "csr_spmm": 0.0}
    for orient, slab in slabs.items():
        reduce = "mean" if orient == "graph" else "sum"
        for f, xf in xs.items():
            for dt in (torch.float32, torch.bfloat16):
                x = xf.to(dt)
                ax = x.float().abs()
                what = f"{orient} F={f} {dt}"
                band = slab_spmm_band(slab, x, torch.float32)
                e_band = check("slab_spmm_band", band,
                               slab_spmm_band_ref(slab, x, torch.float32),
                               slab_spmm_band_ref(slab, ax, torch.float32), what)
                _same_bits("slab_spmm_band", band, slab_spmm_band(slab, x, torch.float32), what)
                del band
                fb_sum = csr_spmm_ref(slab.fallback, x.float())
                fb_mag = csr_spmm_ref(slab.fallback, ax)
                e_new = check("csr_spmm", csr_spmm(slab.fallback, x), fb_sum, fb_mag, what)
                # accumulate mode, as the path calls it, twice: bit for bit
                base = torch.randn((n, f), generator=gen, device=dev)
                acc = csr_spmm(slab.fallback, x, out=base.clone())
                e_fb = check("csr_spmm", acc, base + fb_sum, base.abs() + fb_mag,
                             what + " accumulate")
                if e_new is not None:   # a float32 new output
                    e_fb = max(e_fb, e_new)
                _same_bits("csr_spmm", acc, csr_spmm(slab.fallback, x, out=base.clone()),
                           what + " accumulate")
                del fb_sum, fb_mag, base, acc
                got = slab_spmm(slab, x, reduce, torch.float32)
                e_all = check("slab_spmm", got,
                              slab_spmm_ref(slab, x.float(), reduce, torch.float32),
                              slab_spmm_ref(slab, ax, reduce, torch.float32),
                              f"{what} {reduce}")
                _same_bits("slab_spmm", got, slab_spmm(slab, x, reduce, torch.float32),
                           f"{what} {reduce}")
                del got
                if dt == torch.float32:   # each kernel against its own plain version
                    errs["slab_spmm"] = max(errs["slab_spmm"], e_band, e_all)
                    errs["csr_spmm"] = max(errs["csr_spmm"], e_fb)
                emit({"phase": "full_batch_kernel_check", "orientation": orient,
                      "f": f, "dtype": str(dt), "reduce": reduce,
                      "max_abs_err": {"band": e_band, "csr": e_fb, "slab_spmm": e_all},
                      "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum; "
                                   "bf16 outputs one bf16 ulp more"})
                del x, ax
    torch.cuda.empty_cache()

    def band_csr(slab, dtype):
        """The band's edges as a torch CSR matrix (columns sorted in rows)."""
        r_blk = slab.block_rows
        ell = slab.ell[:n].long()
        base = (torch.arange(n, device=dev) // r_blk) * r_blk - r_blk
        big = torch.iinfo(torch.int64).max
        cols = torch.where(ell >= 0, base[:, None] + ell, big).sort(dim=1).values
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = (cols != big).sum(dim=1).cumsum(0)
        cols = cols[cols != big]
        return torch.sparse_csr_tensor(crow, cols, torch.ones_like(cols, dtype=dtype),
                                       (n, n))

    def fallback_csr(slab, dtype):
        ok = slab.fb_src >= 0
        key = (slab.fb_dst[ok].long() * n + slab.fb_src[ok].long()).sort().values
        cols = key % n
        return torch.sparse_csr_tensor(slab.fb_rowptr, cols,
                                       torch.ones_like(cols, dtype=dtype), (n, n))

    def whole_csr(slab, dtype, reduce):
        """Every edge of the graph (band and fallback) as a torch CSR matrix,
        values 1 / max(degree, 1) for 'mean', else 1: one PyTorch call
        computes ``slab_spmm``'s function with it."""
        r_blk = slab.block_rows
        ell = slab.ell[:n].long()
        rows = torch.arange(n, device=dev)[:, None].expand_as(ell)
        cols = (rows // r_blk) * r_blk - r_blk + ell
        ok = ell >= 0
        fb = slab.fb_src >= 0
        key = torch.cat([rows[ok] * n + cols[ok],
                         slab.fb_dst[fb].long() * n + slab.fb_src[fb].long()]).sort().values
        rows, cols = key // n, key % n
        del key
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.bincount(rows, minlength=n).cumsum(0)
        vals = (1.0 / slab.degrees.clamp(min=1).float())[rows] if reduce == "mean" else \
            torch.ones(rows.numel(), device=dev)
        return torch.sparse_csr_tensor(crow, cols, vals.to(dtype), (n, n))

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / hbm * 1e3, ops / H100_F32_OPS * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    # the three calls of one training step: layer 0 and layer 1 forward
    # (graph, 'mean' as GraphSAGE aggregates), layer 1's backward
    # (transpose, 'sum'); bf16 activations
    step_calls = [("graph", 128), ("graph", 256), ("transpose", 256)]
    timing = {"slab_spmm": [], "csr_spmm": [], "slab_spmm_band": []}
    for orient, f in step_calls:
        slab = slabs[orient]
        reduce = "mean" if orient == "graph" else "sum"
        x = xs[f].to(torch.bfloat16)
        el = x.element_size()
        nnz_band = int((slab.ell[:n] >= 0).sum())
        fb = slab.fallback
        nv = fb_edges[orient]
        src = slab.fb_src[:nv]
        uniq = int(torch.unique(src).numel())
        rows_with = int((fb.rowptr[1:] > fb.rowptr[:-1]).sum())
        # the whole function: the ELL's real entries (not its -1 padding), x
        # once (the fallback's source rows are rows of x), the fallback row
        # pointer and ids, the degrees ('mean'), the output once in x's type
        all_bytes = (4 * nnz_band + x.numel() * el + fb.rowptr.numel() * 8 + nv * 4
                     + (4 * n if reduce == "mean" else 0) + n * f * el)
        a_ms, a_by = bound(all_bytes, (nnz_band + nv) * f)
        a_all = whole_csr(slab, x.dtype, reduce)
        row = {"kernel": "slab_spmm", "orientation": orient, "f": f, "reduce": reduce,
               "dtype": "bfloat16", "band_edges": nnz_band, "fallback_edges": nv,
               "distinct_sources": uniq,
               "ms": cuda_ms(lambda: slab_spmm(slab, x, reduce, torch.float32)),
               "plain_ms": cuda_ms(lambda: slab_spmm_ref(slab, x, reduce, torch.float32),
                                   iters=5),
               "library_ms": cuda_ms(lambda: torch.sparse.mm(a_all, x)),
               "bytes": all_bytes, "bound_ms": a_ms, "bound_by": a_by}
        emit(row)
        timing["slab_spmm"].append(row)
        del a_all

        a_band = band_csr(slab, x.dtype)
        # the band-only mode: the band's real entries, x once, float32 out
        band_bytes = 4 * nnz_band + x.numel() * el + n * f * 4
        b_ms, b_by = bound(band_bytes, nnz_band * f)
        row = {"kernel": "slab_spmm_band", "orientation": orient, "f": f,
               "dtype": "bfloat16", "band_edges": nnz_band,
               "ms": cuda_ms(lambda: slab_spmm_band(slab, x, torch.float32)),
               "plain_ms": cuda_ms(lambda: slab_spmm_band_ref(slab, x, torch.float32),
                                   iters=5),
               "library_ms": cuda_ms(lambda: torch.sparse.mm(a_band, x)),
               "bytes": band_bytes, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        timing["slab_spmm_band"].append(row)
        del a_band

        a_fb = fallback_csr(slab, x.dtype)
        acc = torch.zeros((n, f), dtype=torch.float32, device=dev)
        # accumulate mode, as the path calls it: the row pointer, the valid
        # slots' columns, each distinct source row once, and each output row
        # that has slots read and written once
        fb_bytes = (fb.rowptr.numel() * 8 + nv * 4 + uniq * f * el
                    + 2 * rows_with * f * 4)
        c_ms, c_by = bound(fb_bytes, nv * f)
        row = {"kernel": "csr_spmm", "orientation": orient, "f": f,
               "dtype": "bfloat16", "fallback_edges": nv, "distinct_sources": uniq,
               "rows_with_edges": rows_with,
               "ms": cuda_ms(lambda: csr_spmm(fb, x, out=acc)),
               "plain_ms": cuda_ms(lambda: csr_spmm_ref(fb, x, out=acc), iters=5),
               "library_ms": cuda_ms(lambda: torch.sparse.mm(a_fb, x)),
               "bytes": fb_bytes, "bound_ms": c_ms, "bound_by": c_by}
        emit(row)
        timing["csr_spmm"].append(row)
        del a_fb, acc, x
    del xs
    torch.cuda.empty_cache()

    # -- 8. small input, full batch: card against CPU -----------------------
    small = TF.make_synthetic_banded(3, "cpu", num_nodes=3000, deg=8, band=100,
                                     feat_dim=16, classes=5)
    kw = dict(reorder="none", block_rows=TF.BLOCK_ROWS)
    fb_cpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device="cpu", **kw)
    fb_gpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device=dev, **kw)
    if not fb_cpu.slab.fb_src.shape[0]:
        raise AssertionError("the small graph has no fallback edges")
    feats_gpu, labels_gpu = small.feats.to(dev), small.labels.to(dev)
    for name, cls in (("graphsage", GraphSAGE), ("gcn", GCN)):
        torch.manual_seed(3)
        m_cpu = cls(16, 32, 5, device="cpu")
        m_gpu = cls(16, 32, 5, device=dev)
        m_gpu.load_state_dict(m_cpu.state_dict())
        o_cpu = torch.optim.Adam(m_cpu.parameters(), lr=TF.LR)
        o_gpu = torch.optim.Adam(m_gpu.parameters(), lr=TF.LR)
        loss_diff = 0.0
        for _ in range(3):
            l_cpu = TF.full_batch_step(m_cpu, o_cpu, small.feats, fb_cpu, small.labels)
            l_gpu = TF.full_batch_step(m_gpu, o_gpu, feats_gpu, fb_gpu, labels_gpu)
            loss_diff = max(loss_diff, abs(float(l_cpu) - float(l_gpu)))
        if not loss_diff <= 1e-4:
            raise AssertionError(f"small full-batch {name} f32 steps: card vs CPU "
                                 f"loss differ by {loss_diff}")
        emit({"phase": "small_input_agreement_full_batch", "model": name,
              "steps": 3, "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # -- 9. full-batch train at full width ----------------------------------
    x, labels = g.feats.to(torch.bfloat16), g.labels
    reused = {"src": g.src, "dst": g.dst, "fbg": fbg, "feats": g.feats,
              "labels": labels}
    del g
    torch.cuda.empty_cache()
    steps = 4
    totals = {"slab_spmm": 0, "csr_spmm": 0}
    for name, cls in (("graphsage", GraphSAGE), ("gcn", GCN)):
        torch.manual_seed(0)
        model = cls(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES, dtype=torch.bfloat16,
                    device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        timed = []
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = TF.full_batch_step(model, opt, x, fbg, labels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            v = float(loss)
            if not math.isfinite(v):
                raise AssertionError(f"{name}: non-finite loss at step {step}")
            if step:
                timed.append(dt)
            emit({"phase": "full_batch_train", "model": name, "step": step,
                  "warmup": step == 0, "loss": v, "ms_per_step": dt * 1e3,
                  "edges_per_s": edges / dt})
        launches = {fn.__name__: fn.launches for fn in counters}
        want = {**{fn.__name__: 0 for fn in counters}, "slab_spmm": 3 * steps}
        emit({"phase": "full_batch_launch_counts", "model": name, "steps": steps,
              "launches": launches, "expected": want,
              "ms_per_step": sum(timed) * 1e3 / len(timed),
              "edges_per_s": edges * len(timed) / sum(timed),
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches}, expected {want}")
        for k in totals:
            totals[k] += launches[k]
        emit({"phase": "full_batch_stages", "model": name,
              "ms": _staged_step(model, opt, x, fbg, labels, F)})
        with torch.no_grad():
            logits = model.full_graph(x, fbg)
        if logits.shape != (n, TF.CLASSES) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} not finite")
        del model, opt, logits

    # -- 9b. full-batch GIN at full width --------------------------------------
    # the step's slab SpMM calls, by orientation and reduction
    kernel, calls = FB.slab_spmm, []

    def recording(slab, xs_, reduce, compute_dtype):
        calls.append(("graph" if slab is fbg.slab else
                      "transpose" if slab is fbg.slab_t else "other", reduce))
        return kernel(slab, xs_, reduce, compute_dtype)

    torch.manual_seed(0)
    model = GIN(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES, dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    timed = []
    FB.slab_spmm = recording
    try:
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = TF.full_batch_step(model, opt, x, fbg, labels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            v = float(loss)
            if not math.isfinite(v):
                raise AssertionError(f"gin: non-finite loss at step {step}")
            if step:
                timed.append(dt)
            emit({"phase": "full_batch_train", "model": "gin", "step": step,
                  "warmup": step == 0, "loss": v, "ms_per_step": dt * 1e3,
                  "edges_per_s": edges / dt})
    finally:
        FB.slab_spmm = kernel
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {**{fn.__name__: 0 for fn in counters}, "slab_spmm": 3 * steps}
    want_calls = [("graph", "sum"), ("graph", "sum"), ("transpose", "sum")] * steps
    emit({"phase": "full_batch_launch_counts", "model": "gin", "steps": steps,
          "launches": launches, "expected": want, "calls_per_step": calls[:3],
          "ms_per_step": sum(timed) * 1e3 / len(timed),
          "edges_per_s": edges * len(timed) / sum(timed),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if launches != want or calls != want_calls:
        raise AssertionError(f"gin: kernel launches {launches} / calls {calls[:3]}, "
                             f"expected {want} / {want_calls[:3]}")
    totals["slab_spmm"] += launches["slab_spmm"]
    gin_launches = launches["slab_spmm"]
    emit({"phase": "full_batch_stages", "model": "gin",
          "ms": _staged_step(model, opt, x, fbg, labels, F)})
    with torch.no_grad():
        logits = model.full_graph(x, fbg)
    if logits.shape != (n, TF.CLASSES) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"gin: logits {tuple(logits.shape)} not finite")
    del model, opt, logits
    # row 4's 'sum' over the graph at GIN's two forward shapes (bf16 x, F =
    # 128 and 256), against the plain version's float32 sums, then timed
    gin_rows, gin_err = [], 0.0
    slab = fbg.slab
    nnz_band = int((slab.ell[:n] >= 0).sum())
    nv = fb_edges["graph"]
    x256 = torch.randn((n, 256), generator=gen, device=dev).to(torch.bfloat16)
    for f, xf in ((128, x), (256, x256)):
        for dt in (torch.float32, torch.bfloat16):
            xd = xf.to(dt)
            got = slab_spmm(slab, xd, "sum", torch.float32)
            err = check("slab_spmm", got, slab_spmm_ref(slab, xd.float(), "sum", torch.float32),
                        slab_spmm_ref(slab, xd.float().abs(), "sum", torch.float32),
                        f"graph F={f} {dt} sum")
            _same_bits("slab_spmm", got, slab_spmm(slab, xd, "sum", torch.float32),
                       f"graph F={f} {dt} sum")
            if err is not None:
                gin_err = max(gin_err, err)
            del got
        el = xf.element_size()
        all_bytes = (4 * nnz_band + xf.numel() * el + slab.fallback.rowptr.numel() * 8
                     + nv * 4 + n * f * el)
        b_ms, b_by = bound(all_bytes, (nnz_band + nv) * f)
        a_all = whole_csr(slab, xf.dtype, "sum")
        row = {"kernel": "slab_spmm", "path": "gin", "orientation": "graph", "f": f,
               "reduce": "sum", "dtype": "bfloat16", "band_edges": nnz_band,
               "fallback_edges": nv,
               "ms": cuda_ms(lambda: slab_spmm(slab, xf, "sum", torch.float32)),
               "plain_ms": cuda_ms(lambda: slab_spmm_ref(slab, xf, "sum", torch.float32),
                                   iters=5),
               "library_ms": cuda_ms(lambda: torch.sparse.mm(a_all, xf)),
               "bytes": all_bytes, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        gin_rows.append(row)
        del a_all
    emit({"phase": "full_batch_kernel_check", "model": "gin", "orientation": "graph",
          "reduce": "sum", "max_abs_err_f32": gin_err,
          "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum; "
                       "bf16 outputs one bf16 ulp more"})
    errs["slab_spmm"] = max(errs["slab_spmm"], gin_err)
    del x256

    # -- 9c. full-batch R-GCN at full width -----------------------------------
    rgcn_launches, rgcn_rows, rgcn_err = rgcn_full_batch(
        dev, emit, cuda_ms, counters, reused, x, labels, steps, check, bound, whole_csr)
    totals["slab_spmm"] += rgcn_launches
    errs["slab_spmm"] = max(errs["slab_spmm"], rgcn_err)

    def kernel_row(name, source, replaces, launches, err):
        rows = timing[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err,
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations",
                "library_ms": sum(r["library_ms"] for r in rows)}

    # each row's times are one training step's three calls added together;
    # row 4 also carries GIN's 'sum' calls over the graph (9b)
    row4 = kernel_row("slab_spmm", "cugraph_gnn_tpu_torch/csrc/slab_spmm.cu",
                      "cugraph_gnn_tpu/ops/pallas/slab_kernel.py:267",
                      totals["slab_spmm"], errs["slab_spmm"])
    row4.update(launches_gin=gin_launches,
                **{f"{k}_gin_sum": [r[k] for r in gin_rows]
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                # R-GCN's per-relation calls (9c): forward at F = 128 and 256
                # over relation 0's graph, backward over its transpose
                launches_rgcn=rgcn_launches,
                **{f"{k}_rgcn": [r[k] for r in rgcn_rows]
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
    return reused, [
        row4,
        kernel_row("csr_spmm", "cugraph_gnn_tpu_torch/csrc/csr_spmm.cu",
                   "cugraph_gnn_tpu/ops/pallas/spmm_kernel.py:90",
                   totals["csr_spmm"], errs["csr_spmm"]),
    ]


def rgcn_full_batch(dev, emit, cuda_ms, counters, reused, x, labels, steps, check, bound,
                    whole_csr):
    """Phase 9c (see the module docstring) on phase 6's graph, its features
    ``x`` (bf16) and labels.  Returns row 4's launches on the path, its rows
    timed at R-GCN's three calls of one relation, and its largest
    difference from the plain version."""
    import numpy as np
    import torch
    from torch.nn import functional as F

    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.models.zoo import RGCN
    from cugraph_gnn_tpu_torch.ops import full_batch as FB
    from cugraph_gnn_tpu_torch.ops.full_batch import RelationalFullBatch
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import slab_spmm, slab_spmm_ref

    # 2 relations by endpoint parity (examples/full_batch_training.py)
    src, dst = reused["src"], reused["dst"]
    et = ((src.astype(np.int64) + dst) % 2).astype(np.int32)
    n = x.shape[0]
    t0 = time.perf_counter()
    rfb = RelationalFullBatch(src, dst, et, 2, n, reorder="none", block_rows=TF.BLOCK_ROWS,
                              device=dev)
    torch.cuda.synchronize()
    emit({"phase": "rgcn_full_batch_data", "relations": 2, "nodes": n,
          "edges": [int((et == r).sum()) for r in range(2)],
          "build_s": time.perf_counter() - t0,
          "build_seconds": [g.build_seconds for g in rfb.graphs],
          "band_fraction": [g.band_fraction for g in rfb.graphs],
          "fallback_edges": [int((g.slab.fb_src >= 0).sum()) for g in rfb.graphs]})
    if not all(g.use_slab for g in rfb.graphs):
        raise AssertionError("a relation is off the slab path: it would run the plain version")

    # small input: 3 f32 steps on the card and on the CPU from the same weights
    small = TF.make_synthetic_banded(3, "cpu", num_nodes=3000, deg=8, band=100,
                                     feat_dim=16, classes=5)
    s_et = ((small.src.astype(np.int64) + small.dst) % 2).astype(np.int32)
    torch.manual_seed(3)
    m_cpu = RGCN(16, num_relations=2, hidden_features=32, out_features=5, device="cpu")
    sides = []
    for d in (torch.device("cpu"), dev):
        r_s = RelationalFullBatch(small.src, small.dst, s_et, 2, 3000, reorder="none",
                                  block_rows=TF.BLOCK_ROWS, device=d)
        m = RGCN(16, num_relations=2, hidden_features=32, out_features=5, device=d)
        m.load_state_dict(m_cpu.state_dict())
        o = torch.optim.Adam(m.parameters(), lr=TF.LR)
        sides.append([float(TF.full_batch_step(m, o, small.feats.to(d), r_s,
                                               small.labels.to(d))) for _ in range(3)])
    loss_diff = max(abs(a - b) for a, b in zip(*sides))
    if not loss_diff <= 1e-4:
        raise AssertionError(f"small full-batch rgcn f32 steps: card vs CPU loss differ by "
                             f"{loss_diff}")
    emit({"phase": "small_input_agreement_full_batch", "model": "rgcn", "steps": 3,
          "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # the training path: 1 warm-up and 3 timed steps, each call recorded
    kernel, calls = FB.slab_spmm, []
    slab_of = {id(g.slab): ("graph", r) for r, g in enumerate(rfb.graphs)}
    slab_of.update({id(g.slab_t): ("transpose", r) for r, g in enumerate(rfb.graphs)})

    def recording(slab, xs_, reduce, compute_dtype):
        calls.append((*slab_of.get(id(slab), ("other", -1)), reduce, xs_.shape[1],
                      str(xs_.dtype)))
        return kernel(slab, xs_, reduce, compute_dtype)

    torch.manual_seed(0)
    model = RGCN(TF.FEAT_DIM, num_relations=2, hidden_features=TF.HIDDEN,
                 out_features=TF.CLASSES, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    timed = []
    FB.slab_spmm = recording
    try:
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = TF.full_batch_step(model, opt, x, rfb, labels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            v = float(loss)
            if not math.isfinite(v):
                raise AssertionError(f"rgcn: non-finite loss at step {step}")
            if step:
                timed.append(dt)
            emit({"phase": "full_batch_train", "model": "rgcn", "step": step,
                  "warmup": step == 0, "loss": v, "ms_per_step": dt * 1e3,
                  "edges_per_s": len(src) / dt})
    finally:
        FB.slab_spmm = kernel
    # per step: 2 relations x 2 layers forward, and layer 1's backward over
    # each relation's transpose (layer 0's input needs no gradient)
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {**{fn.__name__: 0 for fn in counters}, "slab_spmm": 6 * steps}
    per_step = sorted(calls[:6])
    want_calls = sorted([("graph", r, "mean", 128, "torch.bfloat16") for r in range(2)]
                        + [("graph", r, "mean", 256, "torch.float32") for r in range(2)]
                        + [("transpose", r, "sum", 256, "torch.float32") for r in range(2)])
    emit({"phase": "full_batch_launch_counts", "model": "rgcn", "steps": steps,
          "launches": launches, "expected": want, "calls_per_step": calls[:6],
          "ms_per_step": sum(timed) * 1e3 / len(timed),
          "edges_per_s": len(src) * len(timed) / sum(timed),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if launches != want or per_step != want_calls or len(calls) != 6 * steps:
        raise AssertionError(f"rgcn: kernel launches {launches} / calls {calls[:6]}, "
                             f"expected {want} / {want_calls}")
    emit({"phase": "full_batch_stages", "model": "rgcn",
          "ms": _staged_step(model, opt, x, rfb, labels, F)})
    with torch.no_grad():
        logits = model.full_graph(x, rfb)
    if logits.shape != (n, TF.CLASSES) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"rgcn: logits {tuple(logits.shape)} not finite")
    del model, opt, logits

    # row 4 at R-GCN's calls of relation 0, against its plain version, then
    # timed: forward F = 128 bf16 and F = 256 f32 'mean', backward F = 256
    # f32 'sum' over the transpose
    gen = torch.Generator(device=dev).manual_seed(6)
    h = torch.randn((n, 256), generator=gen, device=dev)
    g0 = rfb.graphs[0]
    rows, err = [], 0.0
    for orient, slab, xf, reduce in (("graph", g0.slab, x, "mean"),
                                     ("graph", g0.slab, h, "mean"),
                                     ("transpose", g0.slab_t, h, "sum")):
        what = f"rgcn relation 0 {orient} F={xf.shape[1]} {xf.dtype} {reduce}"
        got = slab_spmm(slab, xf, reduce, torch.float32)
        e = check("slab_spmm", got, slab_spmm_ref(slab, xf.float(), reduce, torch.float32),
                  slab_spmm_ref(slab, xf.float().abs(), reduce, torch.float32), what)
        _same_bits("slab_spmm", got, slab_spmm(slab, xf, reduce, torch.float32), what)
        err = max(err, e or 0.0)
        del got
        f, el = xf.shape[1], xf.element_size()
        nnz_band = int((slab.ell[:n] >= 0).sum())
        nv = int((slab.fb_src >= 0).sum())
        nbytes = (4 * nnz_band + xf.numel() * el + slab.fallback.rowptr.numel() * 8 + nv * 4
                  + (4 * n if reduce == "mean" else 0) + n * f * el)
        b_ms, b_by = bound(nbytes, (nnz_band + nv) * f)
        a_all = whole_csr(slab, xf.dtype, reduce)
        row = {"kernel": "slab_spmm", "path": "rgcn", "relation": 0, "orientation": orient,
               "f": f, "reduce": reduce, "dtype": str(xf.dtype), "band_edges": nnz_band,
               "fallback_edges": nv,
               "ms": cuda_ms(lambda: slab_spmm(slab, xf, reduce, torch.float32)),
               "plain_ms": cuda_ms(lambda: slab_spmm_ref(slab, xf, reduce, torch.float32),
                                   iters=5),
               "library_ms": cuda_ms(lambda: torch.sparse.mm(a_all, xf)),
               "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
        del a_all
    emit({"phase": "full_batch_kernel_check", "model": "rgcn", "max_abs_err": err,
          "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum"})
    del rfb, h
    torch.cuda.empty_cache()
    return launches["slab_spmm"], rows, err


def gat_full_batch(dev, emit, cuda_ms, hbm, counters, reused):
    """Phases 10-13 (see the module docstring) on the graph of phase 6.
    Returns the ``kernels`` rows of the attention kernels."""
    import torch
    from torch.nn import functional as F

    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.models.zoo import GAT
    from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import (
        slab_attention_spmm_mh,
        slab_attention_spmm_mh_ref,
    )

    fbg = reused["fbg"]
    n = fbg.num_nodes
    edges = len(reused["src"])

    # -- 10. attention pairs --------------------------------------------------
    t0 = time.perf_counter()
    fbg512 = FullBatchGraph.from_coo(reused["src"], reused["dst"], n, reorder="none",
                                     block_rows=512, device=dev)
    graph512_s = time.perf_counter() - t0
    pairs = {256: fbg.attention_pair, 512: fbg512.attention_pair}
    torch.cuda.synchronize()

    layers = {"layer0": (TF.HEADS, TF.HIDDEN // TF.HEADS), "layer1": (1, TF.CLASSES)}
    # the backward kernels each pair takes, decided by shape before any launch
    designs = {r: {layer: AG.backward_design(p, f) for layer, (_, f) in layers.items()}
               for r, p in pairs.items()}
    emit({"phase": "attention_pairs", "full_batch_graph_512_s": graph512_s,
          "build_seconds": {r: f.build_seconds for r, f in ((256, fbg), (512, fbg512))},
          **{f"R{r}": {"band_fraction": p.fwd.band_fraction,
                       "band_edges": _valid(p.fwd.ell), "fallback_edges": _valid(p.fwd.fb_src),
                       "ell_k": p.fwd.ell.shape[1],
                       "t_ell_k": None if p.t_ell is None else p.t_ell.shape[1],
                       "t_ell_bytes": _nbytes(p.t_ell),
                       "t_ell_real_entries": None if p.t_ell is None else _valid(p.t_ell),
                       "band_csr_bytes": _nbytes(p.t_rowptr, p.t_rows),
                       "band_csr_build_s": p.band_csr_seconds,
                       "backward_design": designs[r]}
             for r, p in pairs.items()}})
    if pairs[256].t_ell is not None or pairs[512].t_ell is None:
        raise AssertionError("R = 256 must have bit planes, R = 512 t_ell")
    if any(p.t_rows is None for p in pairs.values()) or any(
            d != "windows" for per in designs.values() for d, *_ in per.values()):
        raise AssertionError(f"every pair must take the window kernels: {designs}")

    # -- 11. attention kernels at full width ---------------------------------
    def check(name, got, want, magnitude, what):
        """Within 1e-5 absolute plus 1e-5 of ``magnitude``; returns the max
        abs difference."""
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool((diff <= 1e-5 + 1e-5 * magnitude).all()):
            raise AssertionError(f"{name} {what}: off its plain version by "
                                 f"{float(diff.max())}")
        return float(diff.max())

    def bound(nb, ops):
        b_ms, o_ms = nb / hbm * 1e3, ops / H100_F32_OPS * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    names = ("slab_attention_fwd", "slab_attention_bwd_onepass", "slab_attention_bwd",
             "slab_attention_bwd_mh")
    timing = {k: [] for k in names}
    errs = {k: 0.0 for k in names}
    gen = torch.Generator(device=dev).manual_seed(11)
    for r_blk, pair in pairs.items():
        graph = pair.fwd
        e_all = _valid(graph.ell) + _valid(graph.fb_src)
        # index bytes: the real entries of the ELLs (not their -1 padding)
        graph_bytes = 4 * e_all + _nbytes(graph.fb_rowptr)
        for layer, (h, f) in layers.items():
            design, chunk, tile = designs[r_blk][layer]
            x = torch.randn((n, h, f), generator=gen, device=dev)
            ad, as_ = (torch.randn((n, h), generator=gen, device=dev) for _ in range(2))
            g = torch.randn((n, h, f), generator=gen, device=dev)
            what = f"R={r_blk} {layer} H={h} F={f}"
            out, m, s = slab_attention_spmm_mh(graph, x, ad, as_, return_stats=True)
            for a, b in zip((out, m, s), slab_attention_spmm_mh(graph, x, ad, as_,
                                                                return_stats=True)):
                _same_bits("slab_attention_fwd", a, b, what)
            want, m_w, s_w = slab_attention_spmm_mh_ref(graph, x, ad, as_, return_stats=True)
            e_f = check("slab_attention_fwd", out, want,
                        slab_attention_spmm_mh_ref(graph, x.abs(), ad, as_), what)
            if not torch.equal(m, m_w) or not torch.allclose(s, s_w, rtol=1e-5, atol=0):
                raise AssertionError(f"slab_attention_fwd {what}: stats differ")
            errs["slab_attention_fwd"] = max(errs["slab_attention_fwd"], e_f)
            del want, m_w, s_w
            if r_blk == 256 and layer == "layer0":
                xb = x.to(torch.bfloat16)
                e_b = check("slab_attention_fwd", slab_attention_spmm_mh(graph, xb, ad, as_),
                            slab_attention_spmm_mh_ref(graph, xb, ad, as_),
                            slab_attention_spmm_mh_ref(graph, xb.float().abs(), ad, as_),
                            what + " bf16 x")
                emit({"phase": "attention_kernel_check", "kernel": "slab_attention_fwd",
                      "case": what + " bf16 x", "max_abs_err": e_b})
                del xb
            t = (g * out).sum(-1)
            key = ("slab_attention_bwd_onepass" if pair.t_ell is None else
                   "slab_attention_bwd" if h == 1 else "slab_attention_bwd_mh")
            got = AG.slab_attention_bwd_mh(pair, x, ad, as_, m, s, t, g)
            ref = AG.slab_attention_bwd_ref(pair, x, ad, as_, m, s, t, g)
            mag = AG.slab_attention_bwd_ref(pair, x.abs(), ad, as_, m, s, -t.abs(), g.abs())
            e_b = max(check(key, a, b, c, f"{what} {nm}")
                      for a, b, c, nm in zip(got, ref, mag, ("dx", "dad", "das")))
            errs[key] = max(errs[key], e_b)
            del ref, mag
            for a, b in zip(got, AG.slab_attention_bwd_mh(pair, x, ad, as_, m, s, t, g)):
                _same_bits(key, a, b, what)
            del got
            emit({"phase": "attention_kernel_check", "case": what,
                  "backward_design": design, "chunk_elements": chunk, "tile_rows": tile,
                  "max_abs_err": {"slab_attention_fwd": e_f, key: e_b},
                  "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum; "
                               "m equal, s within 1e-5"})
            torch.cuda.empty_cache()

            # times at the main path's calls: both layers at R = 256 (rows 5
            # and 6); at R = 512 the backward (rows 7 and 8)
            hf = h * f
            rows_out = []
            if r_blk == 256:
                fb_ = _nbytes(x, ad, as_) + graph_bytes + 4 * n * hf + 8 * n * h
                rows_out.append(("slab_attention_fwd", fb_, e_all * h * (2 * f + 5),
                                 lambda: slab_attention_spmm_mh(graph, x, ad, as_,
                                                                return_stats=True),
                                 lambda: slab_attention_spmm_mh_ref(graph, x, ad, as_,
                                                                    return_stats=True)))
            bb, b_ops = _attn_bwd_cost(pair, design, h, f, (x, g, ad, as_, m, s, t))
            rows_out.append((key, bb, b_ops,
                             lambda: AG.slab_attention_bwd_mh(pair, x, ad, as_, m, s, t, g),
                             lambda: AG.slab_attention_bwd_ref(pair, x, ad, as_, m, s, t, g)))
            for name, nb, ops, kern, plain in rows_out:
                b_ms, b_by = bound(nb, ops)
                row = {"kernel": name, "block_rows": r_blk, "layer": layer, "heads": h,
                       "f": f, "dtype": "float32", "edges": e_all,
                       **({} if name == "slab_attention_fwd" else
                          {"design": design, "chunk_elements": chunk, "tile_rows": tile}),
                       "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                       "library_ms": None, "bytes": nb, "operations": ops,
                       "bound_ms": b_ms, "bound_by": b_by}
                emit(row)
                timing[name].append(row)
            del x, ad, as_, g, out, m, s, t
            torch.cuda.empty_cache()

    # -- 11b. the one-pass backward's phase probe (row 15) --------------------
    probe = attn_bwd_probe(dev, emit, cuda_ms, pairs[256], pairs[512])

    # -- 11c. the backward's bfloat16 compute mode, and warp per node ---------
    mode_rows, mode_fwd_launches = attn_bwd_modes(dev, emit, cuda_ms, counters, reused,
                                                  pairs, check, bound)

    # -- 12. small input, GAT: card against CPU -------------------------------
    small = TF.make_synthetic_banded(3, "cpu", num_nodes=3000, deg=8, band=100,
                                     feat_dim=16, classes=5)
    kw = dict(reorder="none", block_rows=TF.BLOCK_ROWS)
    fb_cpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device="cpu", **kw)
    fb_gpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device=dev, **kw)
    torch.manual_seed(3)
    m_cpu = GAT(16, 32, 5, heads=TF.HEADS, device="cpu")
    m_gpu = GAT(16, 32, 5, heads=TF.HEADS, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    o_cpu = torch.optim.Adam(m_cpu.parameters(), lr=TF.LR)
    o_gpu = torch.optim.Adam(m_gpu.parameters(), lr=TF.LR)
    loss_diff = 0.0
    for _ in range(3):
        l_cpu = TF.full_batch_step(m_cpu, o_cpu, small.feats, fb_cpu, small.labels)
        l_gpu = TF.full_batch_step(m_gpu, o_gpu, small.feats.to(dev), fb_gpu,
                                   small.labels.to(dev))
        loss_diff = max(loss_diff, abs(float(l_cpu) - float(l_gpu)))
    if not loss_diff <= 1e-4:
        raise AssertionError(f"small full-batch GAT f32 steps: card vs CPU loss "
                             f"differ by {loss_diff}")
    emit({"phase": "small_input_agreement_full_batch", "model": "gat", "steps": 3,
          "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # -- 13. full-batch GAT train at full width ------------------------------
    x, labels = reused["feats"], reused["labels"]
    totals = {fn.__name__: 0 for fn in counters}

    def train(graph, steps, want_per_step, tag):
        torch.manual_seed(0)
        model = GAT(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES, heads=TF.HEADS, device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        timed = []
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = TF.full_batch_step(model, opt, x, graph, labels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            v = float(loss)
            if not math.isfinite(v):
                raise AssertionError(f"gat {tag}: non-finite loss at step {step}")
            if step or steps == 1:
                timed.append(dt)
            emit({"phase": "full_batch_train", "model": "gat", "graph": tag,
                  "step": step, "warmup": step == 0 and steps > 1, "loss": v,
                  "ms_per_step": dt * 1e3, "edges_per_s": edges / dt})
        launches = {fn.__name__: fn.launches for fn in counters}
        want = {**{fn.__name__: 0 for fn in counters},
                **{k: v * steps for k, v in want_per_step.items()}}
        emit({"phase": "full_batch_launch_counts", "model": "gat", "graph": tag,
              "steps": steps, "launches": launches, "expected": want,
              "ms_per_step": sum(timed) * 1e3 / len(timed),
              "edges_per_s": edges * len(timed) / sum(timed),
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if launches != want:
            raise AssertionError(f"gat {tag}: kernel launches {launches}, expected {want}")
        for k in totals:
            totals[k] += launches[k]
        return model, opt

    # R = 256 (bit planes: onepass_bwd) and R = 512 (t_ell pairs: the H = 1
    # and multi-head wrappers, over the window kernels); each 1 warm-up and 3
    # timed steps, then one step stage by stage
    for tag, graph, want_per_step in (
            ("R256", fbg, {"slab_attention_spmm_mh": 2, "onepass_bwd": 2}),
            ("R512", fbg512, {"slab_attention_spmm_mh": 2, "slab_attention_bwd": 1,
                              "slab_attention_bwd_mh": 1})):
        model, opt = train(graph, 4, want_per_step, tag)
        emit({"phase": "full_batch_stages", "model": "gat", "graph": tag,
              "ms": {**_staged_step(model, opt, x, graph, labels, F,
                                    method="attention_spmm_mh", label="attention"),
                     "fallback": "inside the attention kernels"}})
        with torch.no_grad():
            logits = model.full_graph(x, graph)
        if logits.shape != (n, TF.CLASSES) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"gat {tag}: logits {tuple(logits.shape)} not finite")
        del model, opt, logits
        torch.cuda.empty_cache()
    del fbg512
    torch.cuda.empty_cache()

    def kernel_row(name, replaces, counter):
        rows = timing[name]
        return {"name": name, "route": "cuda",
                "source": "cugraph_gnn_tpu_torch/csrc/" + (
                    "slab_attn_fwd.cu" if name == "slab_attention_fwd" else "slab_attn_bwd.cu"),
                "replaces": replaces, "launches": totals[counter],
                "max_abs_err": errs[name], **_summed(rows, totals[counter]),
                "library_ms": None}

    # row 15, the probe: its every-phase time at row 6's two calls, beside
    # row 6's bound and plain version (the same function); it is no kernel
    # of the path, so the main path launches it no time
    row6 = timing["slab_attention_bwd_onepass"]
    probe_row = {
        "name": "slab_attention_bwd_probe", "route": "cuda",
        "source": "cugraph_gnn_tpu_torch/csrc/slab_attn_bwd.cu",
        "replaces": "benchmarks/bwd_kernel_anatomy.py:91",
        "also_replaces": "benchmarks/attn_bwd_probe.py:114", "launches": 0,
        "on_main_path": False, "max_abs_err": 0.0,
        "ms": sum(v["full"] for v in probe.values()),
        "plain_ms": sum(r["plain_ms"] for r in row6),
        "bound_ms": sum(r["bound_ms"] for r in row6), "bound_by": "bytes",
        "library_ms": None, "split_ms": probe}

    # rows 5 and 6: one R = 256 step's two calls added; rows 7 and 8: the
    # R = 512 step's call of each; then phase 11c's rows
    fwd_row = kernel_row("slab_attention_fwd", "cugraph_gnn_tpu/ops/pallas/slab_kernel.py:438",
                         "slab_attention_spmm_mh")
    fwd_row["launches_bwd_modes"] = mode_fwd_launches
    fwd_row["launches"] += mode_fwd_launches
    return [
        fwd_row,
        kernel_row("slab_attention_bwd_onepass",
                   "cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py:333", "onepass_bwd"),
        kernel_row("slab_attention_bwd", "cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py:507",
                   "slab_attention_bwd"),
        kernel_row("slab_attention_bwd_mh",
                   "cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py:689",
                   "slab_attention_bwd_mh"),
    ] + mode_rows, probe_row


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _valid(t):
    return int((t >= 0).sum())


def _attn_bwd_cost(pair, design, h, f, per_node):
    """Bytes and operations of one backward call: the per-node inputs
    ``per_node`` read once, the forward ELL's real entries (not its -1
    padding) and the fallback ids and row pointer, the transpose index the
    design reads (the band CSR by source for the window kernels, t_ell's
    real entries for warp per node) and the fallback CSR by source, dx, dad
    and das written once; about 4F + 10 operations an edge and head.  The
    bfloat16 compute mode moves the same bytes."""
    graph = pair.fwd
    n = graph.num_rows
    e_all = _valid(graph.ell) + _valid(graph.fb_src)
    t_bytes = (4 * _valid(pair.fb_t_dst) + _nbytes(pair.fb_t_rowptr)
               + (_nbytes(pair.t_rowptr, pair.t_rows) if design == "windows"
                  else 4 * _valid(pair.t_ell)))
    nb = (_nbytes(*per_node) + 4 * e_all + _nbytes(graph.fb_rowptr) + t_bytes
          + 4 * n * h * f + 8 * n * h)
    return nb, e_all * h * (4 * f + 10)


# phase 11c's pair past the backward's window: warp per node from R = 527
# on the H100, while the forward's window (4 quads a row) fits up to R = 1019
WARP_PER_NODE_R = 768
# phase 11c's kernels-line rows: (pair, compute dtype, heads > 1) -> name,
# the TPU kernel it stands for, the wrapper that counts it
_MODE_ROWS = {
    (256, "bfloat16", True): ("slab_attention_bwd_onepass_bf16", 333, "onepass_bwd"),
    (256, "bfloat16", False): ("slab_attention_bwd_onepass_bf16", 333, "onepass_bwd"),
    (512, "bfloat16", False): ("slab_attention_bwd_bf16", 507, "slab_attention_bwd"),
    (512, "bfloat16", True): ("slab_attention_bwd_mh_bf16", 689, "slab_attention_bwd_mh"),
    (WARP_PER_NODE_R, "float32", False): ("slab_attention_bwd_warp_per_node", 507,
                                          "slab_attention_bwd"),
    (WARP_PER_NODE_R, "float32", True): ("slab_attention_bwd_mh_warp_per_node", 689,
                                         "slab_attention_bwd_mh"),
    (WARP_PER_NODE_R, "bfloat16", False): ("slab_attention_bwd_warp_per_node_bf16", 507,
                                           "slab_attention_bwd"),
    (WARP_PER_NODE_R, "bfloat16", True): ("slab_attention_bwd_mh_warp_per_node_bf16", 689,
                                          "slab_attention_bwd_mh"),
}


def attn_bwd_modes(dev, emit, cuda_ms, counters, reused, pairs, check, bound):
    """Phase 11c (see the module docstring).  Returns the kernels rows of the
    backward's bfloat16 compute mode (rows 6-8) and of the warp-per-node
    design (rows 7 and 8 past the window) and the forward launches of the
    path's runs."""
    import torch

    from cugraph_gnn_tpu_torch import _native
    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import (
        slab_attention_spmm_mh,
        slab_attention_spmm_mh_ref,
    )

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    n = reused["fbg"].num_nodes
    layers = {"layer0": (TF.HEADS, TF.HIDDEN // TF.HEADS), "layer1": (1, TF.CLASSES)}
    t0 = time.perf_counter()
    indptr, indices, _ = _native.build_csr(reused["dst"], reused["src"], n)
    pair_w = AG.build_attention_slab_pair(indptr, indices, block_rows=WARP_PER_NODE_R,
                                          device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del indptr, indices
    pairs = {**pairs, WARP_PER_NODE_R: pair_w}
    designs = {r: {layer: AG.backward_design(p, f) for layer, (_, f) in layers.items()}
               for r, p in pairs.items()}
    emit({"phase": "attention_bwd_modes_pair", "block_rows": WARP_PER_NODE_R,
          "host_s": build_s, "band_fraction": pair_w.fwd.band_fraction,
          "band_edges": _valid(pair_w.fwd.ell), "fallback_edges": _valid(pair_w.fwd.fb_src),
          "t_ell_k": pair_w.t_ell.shape[1], "t_ell_real_entries": _valid(pair_w.t_ell),
          "backward_design": designs[WARP_PER_NODE_R]})
    if any(d[0] != "warp_per_node" for d in designs[WARP_PER_NODE_R].values()):
        raise AssertionError(f"R = {WARP_PER_NODE_R} must take warp per node: {designs}")

    # the path: the differentiable attention (forward kernel, then the
    # backward kernel with bwd_compute_dtype) at both layers' shapes, each
    # run counted from zero
    runs = [(256, "bfloat16"), (512, "bfloat16"), (WARP_PER_NODE_R, "bfloat16"),
            (WARP_PER_NODE_R, "float32")]
    gen = torch.Generator(device=dev).manual_seed(19)
    launched, fwd_launches = {}, 0
    for r_blk, mode in runs:
        pair = pairs[r_blk]
        want = {fn.__name__: 0 for fn in counters}
        for fn in counters:
            fn.launches = 0
        for layer, (h, f) in layers.items():
            shape = (n, h, f) if h > 1 else (n, f)
            x = torch.randn(shape, generator=gen, device=dev).requires_grad_()
            ad, as_ = (torch.randn(shape[:-1], generator=gen, device=dev).requires_grad_()
                       for _ in range(2))
            g = torch.randn(shape, generator=gen, device=dev)
            make = (AG.differentiable_slab_attention_mh if h > 1
                    else AG.differentiable_slab_attention)
            out = make(pair, bwd_compute_dtype=dtypes[mode])(x, ad, as_)
            (out * g).sum().backward()
            torch.cuda.synchronize()
            if out.shape != shape or not all(bool(torch.isfinite(a).all())
                                             for a in (out, x.grad, ad.grad, as_.grad)):
                raise AssertionError(f"R={r_blk} {layer} {mode}: output or gradients "
                                     f"not finite")
            want["slab_attention_spmm_mh"] += 1
            want[_MODE_ROWS[(r_blk, mode, h > 1)][2]] += 1
            del x, ad, as_, g, out
        got = {fn.__name__: fn.launches for fn in counters}
        emit({"phase": "attention_bwd_modes_launch_counts", "block_rows": r_blk,
              "compute_dtype": mode, "launches": got, "expected": want})
        if got != want:
            raise AssertionError(f"R={r_blk} {mode}: kernel launches {got}, expected {want}")
        launched[(r_blk, mode)] = got
        fwd_launches += got["slab_attention_spmm_mh"]
        torch.cuda.empty_cache()

    # each call against its plain version with the same compute dtype (the
    # forward at the new pair's shape too), then times beside the float32
    # mode on the same inputs
    timed, errs = {}, {}
    for r_blk, mode in runs:
        pair = pairs[r_blk]
        cd = dtypes[mode]
        for layer, (h, f) in layers.items():
            name, line, counter = _MODE_ROWS[(r_blk, mode, h > 1)]
            design, chunk, tile = designs[r_blk][layer]
            what = f"R={r_blk} {layer} H={h} F={f} {mode}"
            x, g = (torch.randn((n, h, f), generator=gen, device=dev) for _ in range(2))
            ad, as_ = (torch.randn((n, h), generator=gen, device=dev) for _ in range(2))
            out, m, s = slab_attention_spmm_mh(pair.fwd, x, ad, as_, return_stats=True)
            if r_blk == WARP_PER_NODE_R and mode == "float32":
                want, m_w, s_w = slab_attention_spmm_mh_ref(pair.fwd, x, ad, as_,
                                                            return_stats=True)
                e_f = check("slab_attention_fwd", out, want,
                            slab_attention_spmm_mh_ref(pair.fwd, x.abs(), ad, as_), what)
                if not torch.equal(m, m_w) or not torch.allclose(s, s_w, rtol=1e-5, atol=0):
                    raise AssertionError(f"slab_attention_fwd {what}: stats differ")
                emit({"phase": "attention_kernel_check", "kernel": "slab_attention_fwd",
                      "case": what, "max_abs_err": e_f})
                del want, m_w, s_w
            t = (g * out).sum(-1)
            del out
            args = (pair, x, ad, as_, m, s, t, g)
            got = AG.slab_attention_bwd_mh(*args, compute_dtype=cd)
            ref = AG.slab_attention_bwd_ref(*args, compute_dtype=cd)
            mag = AG.slab_attention_bwd_ref(pair, x.abs(), ad, as_, m, s, -t.abs(), g.abs())
            err = max(check(name, a, b, c, f"{what} {nm}")
                      for a, b, c, nm in zip(got, ref, mag, ("dx", "dad", "das")))
            errs[name] = max(errs.get(name, 0.0), err)
            del ref, mag
            for a, b in zip(got, AG.slab_attention_bwd_mh(*args, compute_dtype=cd)):
                _same_bits(name, a, b, what)
            if mode == "bfloat16" and all(torch.equal(a, b) for a, b in
                                          zip(got, AG.slab_attention_bwd_mh(*args))):
                raise AssertionError(f"{name} {what}: the bfloat16 mode equals float32")
            del got
            nb, ops = _attn_bwd_cost(pair, design, h, f, (x, g, ad, as_, m, s, t))
            b_ms, b_by = bound(nb, ops)
            row = {"kernel": name, "block_rows": r_blk, "layer": layer, "heads": h, "f": f,
                   "compute_dtype": mode, "design": design, "chunk_elements": chunk,
                   "tile_rows": tile, "max_abs_err": err,
                   "ms": cuda_ms(lambda: AG.slab_attention_bwd_mh(*args, compute_dtype=cd)),
                   "plain_ms": cuda_ms(lambda: AG.slab_attention_bwd_ref(*args,
                                                                         compute_dtype=cd),
                                       iters=3, warmup=1),
                   "library_ms": None, "bytes": nb, "operations": ops,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum"}
            if mode == "bfloat16":   # the float32 mode's time on the same inputs
                row["ms_float32"] = cuda_ms(lambda: AG.slab_attention_bwd_mh(*args))
            emit({"phase": "attention_bwd_modes_kernel", **row})
            timed.setdefault(name, []).append(row)
            del x, g, ad, as_, m, s, t, args
            torch.cuda.empty_cache()
    del pair_w, pairs
    torch.cuda.empty_cache()

    rows = []
    for name, calls in timed.items():
        r_blk, mode = calls[0]["block_rows"], calls[0]["compute_dtype"]
        _, line, counter = _MODE_ROWS[(r_blk, mode, calls[0]["heads"] > 1)]
        launches = launched[(r_blk, mode)][counter]
        rows.append({"name": name, "route": "cuda",
                     "source": "cugraph_gnn_tpu_torch/csrc/slab_attn_bwd.cu",
                     "replaces": f"cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py:{line}",
                     "compute_dtype": mode, "launches": launches, "max_abs_err": errs[name],
                     **_summed(calls, launches),
                     **({"ms_float32": sum(c["ms_float32"] for c in calls)}
                        if mode == "bfloat16" else {}),
                     "library_ms": None})
    return rows, fwd_launches


def _summed(rows, launches):
    """A ``kernels`` row's numbers over its timed calls ``rows`` (one step's
    calls): ms, plain_ms and bound_ms added, what bounds them, the calls,
    the gap launches * (ms - bound) / calls, and, where the calls report
    it, the backward design each layer took."""
    ms, bound = sum(r["ms"] for r in rows), sum(r["bound_ms"] for r in rows)
    out = {"ms": ms, "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": bound,
           "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
           else "operations", "calls": len(rows), "gap_ms": launches * (ms - bound) / len(rows)}
    if "design" in rows[0]:
        out["design"] = {r["layer"]: [r["design"], r["chunk_elements"], r["tile_rows"]]
                         for r in rows}
    return out


# the probe's variants (phase 11b): name -> mask of slab_attn_grad.PROBE_*;
# at R = 512 (256-row tiles) the passes alone with every other phase on
PROBE_VARIANTS = {"full": 15, "dst": 13, "src": 14, "dst_no_exp": 9, "dst_no_dots": 5,
                  "dst_memory": 1, "src_no_exp": 10, "src_no_dots": 6, "src_memory": 2}
PROBE_VARIANTS_512 = {"full": 15, "dst": 13, "src": 14}


def attn_bwd_probe(dev, emit, cuda_ms, pair, pair512=None):
    """Phase 11b (see the module docstring): the one-pass backward's phase
    probe on ``pair`` (R = 256, the band CSR by source) at GAT's two
    layers' shapes, and on ``pair512``'s band CSR (its t_ell left out).
    Returns {layer: {variant: ms}} of ``pair``."""
    import torch

    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import slab_attention_spmm_mh

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    split = {}
    runs = [(pair, pair, PROBE_VARIANTS)]
    if pair512 is not None:
        runs.append((pair512._replace(t_ell=None), pair512, PROBE_VARIANTS_512))
    for p_, real, variants in runs:
        n = p_.fwd.num_rows
        r_blk = p_.fwd.block_rows
        for layer, (h, f) in {"layer0": (TF.HEADS, TF.HIDDEN // TF.HEADS),
                              "layer1": (1, TF.CLASSES)}.items():
            x, g = (torch.randn((n, h, f), generator=gen, device=dev) for _ in range(2))
            ad, as_ = (torch.randn((n, h), generator=gen, device=dev) for _ in range(2))
            out, m, s = slab_attention_spmm_mh(p_.fwd, x, ad, as_, return_stats=True)
            t = (g * out).sum(-1)
            del out
            args = (p_, x, ad, as_, m, s, t, g)
            # every phase on is the kernel's own code: bit for bit the result
            # of the path's wrapper on the pair
            got = AG.onepass_bwd_probe(*args)
            for a, b in zip(got, AG.slab_attention_bwd_mh(real, *args[1:])):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"probe R={r_blk} {layer}: the kernel's code "
                                         f"and the probe's differ")
            del got
            ms = {name: cuda_ms(lambda p=p: AG.onepass_bwd_probe(*args, phases=p),
                                iters=10, warmup=2)
                  for name, p in variants.items()}
            if r_blk == pair.fwd.block_rows:
                split[layer] = ms
            emit({"phase": "attn_bwd_probe", "layer": layer, "heads": h, "f": f,
                  "dtype": "float32", "block_rows": r_blk,
                  "design": AG.backward_design(p_, f), "ms": ms, "masks": variants,
                  "bit_equal_all_phases": True})
            del x, g, ad, as_, m, s, t, args
            torch.cuda.empty_cache()
    emit({"phase": "attn_bwd_probe_done", "seconds": time.perf_counter() - t0})
    return split


# rows 9-14 of the TPU-kernel table: name -> (CUDA source, TPU kernel, counter)
SHARD_ROWS = {
    "slab_spmm_shard": ("slab_spmm_shard.cu", "cugraph_gnn_tpu/ops/dist_full_batch.py:178",
                        "slab_spmm_shard"),
    "slab_attention_fwd_shard": ("slab_attn_fwd.cu",
                                 "cugraph_gnn_tpu/ops/dist_full_batch.py:585",
                                 "slab_attention_spmm_shard"),
    "slab_attention_bwd_onepass_shard": ("slab_attn_bwd_shard.cu",
                                         "cugraph_gnn_tpu/ops/dist_full_batch.py:679",
                                         "onepass_bwd_shard"),
    "slab_attention_bwd_shard": ("slab_attn_bwd_shard.cu",
                                 "cugraph_gnn_tpu/ops/dist_full_batch.py:818",
                                 "slab_attention_bwd_shard"),
    "slab_attention_fwd_mh_shard": ("slab_attn_fwd.cu",
                                    "cugraph_gnn_tpu/ops/dist_full_batch.py:974",
                                    "slab_attention_spmm_mh_shard"),
    "slab_attention_bwd_mh_shard": ("slab_attn_bwd_shard.cu",
                                    "cugraph_gnn_tpu/ops/dist_full_batch.py:1071",
                                    "slab_attention_bwd_mh_shard"),
}


def _check_sum(name, got, f32_sum, magnitude, what):
    """``got`` against the plain version's float32 sum: within 1e-5,
    absolute and relative to ``magnitude`` (the same sum over the terms'
    absolute values, the scale of sum-order rounding); a bf16 ``got`` also
    within one bf16 ulp of the sum.  Returns the max abs difference of a
    float32 ``got`` (None for bf16)."""
    import torch

    torch.cuda.synchronize()
    tol = 1e-5 * (1 + magnitude)
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(f32_sum)
        tol = tol + torch.ldexp(torch.ones_like(f32_sum), e - 8)
    diff = (got.float() - f32_sum).abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{name} {what}: off its plain version by "
                             f"{float(diff.max())}")
    if got.dtype != torch.float32:
        return None
    return float(diff.max()) if diff.numel() else 0.0


def _same_bits(name, a, b, what):
    """Two launches on the same inputs must agree bit for bit (no atomics,
    a fixed order of sums)."""
    import torch

    torch.cuda.synchronize()
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if not torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype])):
        raise AssertionError(f"{name} {what}: two launches differ")


def _close(name, got, want, magnitude, what):
    """``got`` within 1e-5 absolute plus 1e-5 of ``magnitude`` (the plain
    version's sum over the terms' absolute values) of ``want``; returns the
    max abs difference."""
    import torch

    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= 1e-5 + 1e-5 * magnitude).all()):
        raise AssertionError(f"{name} {what}: off by {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def _bwd_row(r_blk, heads):
    """The backward row a shard pair runs: bit planes (R = 256) the
    one-pass row, t_ell (R = 512) the H = 1 or multi-head row."""
    if r_blk * 3 <= 1024:
        return "slab_attention_bwd_onepass_shard"
    return "slab_attention_bwd_shard" if heads == 1 else "slab_attention_bwd_mh_shard"


def shard_kernels(dev, emit, world=4, n=100_000):
    """Phase 14 (see the module docstring) over ``n`` nodes.  Returns each
    row's max abs difference from its plain version."""
    import numpy as np
    import torch

    from cugraph_gnn_tpu_torch import _native
    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as AK
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
        build_slab_graph,
        slab_spmm,
        slab_spmm_band,
        slab_spmm_band_shard,
        slab_spmm_band_shard_ref,
        slab_spmm_shard,
        slab_spmm_shard_ref,
    )

    t0 = time.perf_counter()
    g = TF.make_synthetic_banded(4, "cpu", num_nodes=n, deg=3, far=1, feat_dim=8,
                                 classes=2)
    indptr, indices, _ = _native.build_csr(g.dst, g.src, n)
    rows_np = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    t_indptr, t_indices, _ = _native.build_csr(indices, rows_np, n)
    gen = torch.Generator(device=dev).manual_seed(21)
    errs = {k: 0.0 for k in SHARD_ROWS}
    vs_whole = {k: 0.0 for k in SHARD_ROWS}
    band_errs = {"max_abs_err": 0.0, "vs_whole_graph": 0.0}

    def split(r_blk):
        nb = -(-(-(-n // r_blk)) // world) * world
        return nb // world * r_blk, nb * r_blk

    def pad(t, rows):
        out = t.new_zeros((rows,) + tuple(t.shape[1:]))
        out[:t.shape[0]] = t
        return out

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # row 9: the whole function on each shard's table (its halos and the
    # remote rows its fallback edges read, taken from the whole x), 'mean'
    # over the graph and 'sum' over its transpose, against its plain version
    # and the one-card slab_spmm on the shard's rows; the band-only mode
    # (the balanced plan's) against its plain version and the whole graph's
    # band-only kernel
    r_blk = TF.BLOCK_ROWS
    rs, n_pad = split(r_blk)
    fb_fraction, tail_rows = {}, {}
    for orient, (ip, ix) in {"graph": (indptr, indices),
                             "transpose": (t_indptr, t_indices)}.items():
        slab = build_slab_graph(ip, ix, block_rows=r_blk, device="cpu")
        fb_fraction[orient] = 1.0 - slab.band_fraction
        reduce = "mean" if orient == "graph" else "sum"
        ell = DF._padded(slab.ell.numpy(), n_pad, -1)
        whole_slab = slab.to(dev)
        tables = [DF.shard_table_graph(slab, w, rs, n_pad, world, dev) for w in range(world)]
        tail_rows[orient] = [len(t) for _, t in tables]
        for f, dt in ((128, torch.bfloat16), (256, torch.float32)):
            x = pad(randn(n, f).to(dt), n_pad)
            whole = pad(slab_spmm_band(whole_slab, x[:n].contiguous(), torch.float32), n_pad)
            whole_fn = pad(slab_spmm(whole_slab, x[:n].contiguous(), reduce, torch.float32),
                           n_pad)
            for w in range(world):
                own = slice(w * rs, (w + 1) * rs)
                shard = DF.shard_slab(ell, None, w, rs, r_blk, dev)
                x_ext = DF.halo_rows(x, w, rs, r_blk)
                got = slab_spmm_band_shard(shard, x_ext, torch.float32)
                mag = slab_spmm_band_shard_ref(shard, x_ext.float().abs(), torch.float32)
                what = f"{orient} F={f} {dt} shard {w}"
                band_errs["max_abs_err"] = max(band_errs["max_abs_err"], _close(
                    "slab_spmm_band_shard", got,
                    slab_spmm_band_shard_ref(shard, x_ext, torch.float32), mag, what))
                band_errs["vs_whole_graph"] = max(band_errs["vs_whole_graph"], _close(
                    "slab_spmm_band_shard", got, whole[own], mag, what + " vs the whole graph"))
                graph, tail = tables[w]
                parts = (x[own], x_ext[:r_blk], x_ext[-r_blk:],
                         x[torch.as_tensor(tail, device=dev)])
                got = slab_spmm_shard(graph, *parts, reduce, torch.float32)
                f32 = [a.float() for a in parts]
                mag = slab_spmm_shard_ref(graph, *[a.abs() for a in f32], reduce, torch.float32)
                what = f"{orient} {reduce} F={f} {dt} shard {w}"
                e = _check_sum("slab_spmm_shard", got,
                               slab_spmm_shard_ref(graph, *f32, reduce, torch.float32), mag, what)
                e_w = _check_sum("slab_spmm_shard", got, whole_fn[own].float(), mag,
                                 what + " vs the whole graph")
                if e is not None:
                    errs["slab_spmm_shard"] = max(errs["slab_spmm_shard"], e)
                    vs_whole["slab_spmm_shard"] = max(vs_whole["slab_spmm_shard"], e_w)
                _same_bits("slab_spmm_shard", got,
                           slab_spmm_shard(graph, *parts, reduce, torch.float32), what)
        del whole_slab, x, whole, whole_fn, tables
    if not all(min(v) > 0 for v in tail_rows.values()):
        raise AssertionError(f"the 4-rank shards read no remote rows: {tail_rows}")

    # rows 10-14: each shard's whole attention over its two tables (halo
    # and remote rows taken from the whole arrays, packed as the exchanges
    # pack them) at R = 256 (bit planes), 512 (t_ell, 256-row tiles) and 768
    # (t_ell, warp per node): every backward design
    layers = {"layer0": (4, 64), "layer1": (1, 47)}
    want_design = {256: "windows", 512: "windows", WARP_PER_NODE_R: "warp_per_node"}
    designs, remote = {}, {}
    for r_blk in want_design:
        rs, n_pad = split(r_blk)
        pair = AG.build_attention_slab_pair(indptr, indices, block_rows=r_blk, device="cpu")
        whole = pair.to(dev)
        shards = [DF.shard_attention_tables(pair, w, rs, n_pad, world, dev)
                  for w in range(world)]
        remote[r_blk] = [[len(ta), len(tb)] for _, ta, tb in shards]
        designs[r_blk] = {layer: AG.backward_design(shards[0][0], f)
                          for layer, (_, f) in layers.items()}
        if any(d != want_design[r_blk] for d, *_ in designs[r_blk].values()):
            raise AssertionError(f"R={r_blk} shards must take the {want_design[r_blk]} "
                                 f"kernels: {designs}")
        for layer, (h, f) in layers.items():
            x, gg = pad(randn(n, h, f), n_pad), pad(randn(n, h, f), n_pad)
            ad, as_, t = (pad(randn(n, h), n_pad) for _ in range(3))
            out_w, m_w, s_w = AK.slab_attention_spmm_mh(whole.fwd, x[:n], ad[:n], as_[:n],
                                                        return_stats=True)
            bwd_w = [pad(a, n_pad) for a in AG.slab_attention_bwd_mh(
                whole, x[:n], ad[:n], as_[:n], m_w, s_w, t[:n], gg[:n])]
            out_w, m, s = (pad(a, n_pad) for a in (out_w, m_w, s_w))
            stats = AG.attention_stats(ad, m, s, t)
            stats_mag = AG.attention_stats(ad, m, s, -t.abs())
            fwd_name = "slab_attention_fwd_shard" if h == 1 else "slab_attention_fwd_mh_shard"
            bwd_name = _bwd_row(r_blk, h)
            for w, (sp, tail_a, tail_b) in enumerate(shards):
                own = slice(w * rs, (w + 1) * rs)
                what = f"R={r_blk} {layer} shard {w}"
                table_a, table_a_mag = (DF.halo_table(a, as_, w, rs, r_blk, tail_a)
                                        for a in (x, x.abs()))
                as_ext = DF.halo_rows(as_, w, rs, r_blk)
                args = [table_a, ad[own], as_ext]
                mag_args = [table_a_mag, ad[own], as_ext]
                if h == 1:
                    fwd, ref = AK.slab_attention_spmm_shard, AK.slab_attention_spmm_shard_ref
                    args, mag_args = ([tb.squeeze_heads(), a[:, 0], e[:, 0]]
                                      for tb, a, e in (args, mag_args))
                else:
                    fwd, ref = AK.slab_attention_spmm_mh_shard, AK.slab_attention_spmm_mh_shard_ref
                out, m_s, s_s = fwd(sp.fwd, *args, return_stats=True)
                for a, b in zip((out, m_s, s_s), fwd(sp.fwd, *args, return_stats=True)):
                    _same_bits(fwd_name, a, b, what)
                want, m_r, s_r = ref(sp.fwd, *args, return_stats=True)
                mag = ref(sp.fwd, *mag_args)
                if h == 1:
                    out, want, mag = out[:, None], want[:, None], mag[:, None]
                    m_s, s_s, m_r, s_r = (a[:, None] for a in (m_s, s_s, m_r, s_r))
                errs[fwd_name] = max(errs[fwd_name], _close(fwd_name, out, want, mag, what))
                vs_whole[fwd_name] = max(vs_whole[fwd_name], _close(
                    fwd_name, out, out_w[own], mag, what + " vs the whole graph"))
                if not torch.equal(m_s, m_r) or not torch.equal(m_s, m[own]):
                    raise AssertionError(f"{fwd_name} {what}: m differs")
                _close(fwd_name, s_s, s_r, s_r, what + " s")
                _close(fwd_name, s_s, s[own], s_r, what + " s vs the whole graph")

                def stats_ext(st):
                    ext = DF.halo_rows(st, w, rs, r_blk)
                    ext[..., 2].clamp_(min=1e-16)   # zero halo rows past the ends
                    return ext

                args = (table_a, as_ext, DF.halo_table(gg, stats, w, rs, r_blk, tail_b),
                        stats_ext(stats))
                got = AG.slab_attention_bwd_mh_shard(sp, *args)
                for a, b in zip(got, AG.slab_attention_bwd_mh_shard(sp, *args)):
                    _same_bits(bwd_name, a, b, what)
                want = AG.slab_attention_bwd_shard_ref(sp, *args)
                mag = AG.slab_attention_bwd_shard_ref(
                    sp, table_a_mag, as_ext,
                    DF.halo_table(gg.abs(), stats_mag, w, rs, r_blk, tail_b),
                    stats_ext(stats_mag))
                for a, b, c, wh, nm in zip(got, want, mag, bwd_w, ("dx", "dad", "das")):
                    errs[bwd_name] = max(errs[bwd_name], _close(bwd_name, a, b, c,
                                                               f"{what} {nm}"))
                    vs_whole[bwd_name] = max(vs_whole[bwd_name], _close(
                        bwd_name, a, wh[own], c, f"{what} {nm} vs the whole graph"))
                del got, want, mag, args, table_a, table_a_mag
            del x, gg, ad, as_, t, out_w, m, s, bwd_w, stats, stats_mag
        del whole, shards
        torch.cuda.empty_cache()
    if not all(min(min(r) for r in v) > 0 for v in remote.values()):
        raise AssertionError(f"a 4-rank shard's tables read no remote rows: {remote}")
    emit({"phase": "shard_kernel_check", "world": world, "nodes": n,
          "edges": g.num_edges, "fallback_fraction": fb_fraction,
          "remote_rows_per_shard": tail_rows,
          "attention_remote_rows_per_shard_tables_a_b": remote, "band_only_shard": band_errs,
          "max_abs_err": errs, "max_abs_diff_from_whole_graph_kernel": vs_whole,
          "backward_design": designs, "seconds": time.perf_counter() - t0,
          "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum"})
    return errs


def _require_nccl(mesh) -> None:
    if mesh.backend != "nccl" or mesh.device.type != "cuda":
        raise AssertionError(f"world-1 mesh on {mesh.device} over {mesh.backend}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_full_batch(dev, emit, cuda_ms, hbm, counters, reused, errs):
    """Phases 15-16 (see the module docstring).  Returns the ``kernels``
    rows 9-14; ``errs`` is phase 14's max abs differences."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.nn import functional as F

    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.models.zoo import GAT, GCN
    from cugraph_gnn_tpu_torch.ops import dist_full_batch as DF
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as AK
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
        slab_spmm_band_shard,
        slab_spmm_shard,
        slab_spmm_shard_ref,
    )
    from cugraph_gnn_tpu_torch.utils import distributed as D

    mesh = D.init(init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        _require_nccl(mesh)
        n = reused["fbg"].num_nodes
        edges = len(reused["src"])
        graphs = {}

        def graph(r_blk):
            if r_blk not in graphs:
                t0 = time.perf_counter()
                g = DF.DistFullBatchGraph.from_coo(reused["src"], reused["dst"], n, mesh,
                                                   reorder="none", block_rows=r_blk)
                g._attn_structs()
                torch.cuda.synchronize()
                emit({"phase": "dist_graph", "block_rows": r_blk, "world": mesh.world,
                      "backend": mesh.backend, "seconds": time.perf_counter() - t0,
                      "build_seconds": g.build_seconds, "rows_per_rank": g.rows_per_rank,
                      "n_pad": g.n_pad, "band_fraction": g.band_fraction,
                      "fallback_edges": {("transpose" if k else "graph"): int(v.fb_src.numel())
                                         for k, v in g._spmm.items()},
                      "balanced": {("transpose" if k else "graph"): v.balanced
                                   for k, v in g._spmm.items()}})
                graphs[r_blk] = g
            return graphs[r_blk]

        def node_arrays(g):
            """This rank's features (f32), labels and valid mask on ``g``."""
            return (g.shard(reused["feats"]), g.shard(reused["labels"]),
                    g.shard(torch.ones(n, device=dev)))

        dfbg = graph(TF.BLOCK_ROWS)
        x32, labels, valid = node_arrays(dfbg)
        totals = {fn.__name__: 0 for fn in counters}

        def train(make, graph_, x, steps, want_per_step, tag):
            """``steps`` dist steps of a fresh model on ``graph_`` from x (this
            rank's rows of ``graph_``); checks the launches per step."""
            _, labels, valid = node_arrays(graph_)
            torch.manual_seed(0)
            model = make()
            opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters:
                fn.launches = 0
            timed = []
            for step in range(steps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                loss = TF.dist_full_batch_step(model, opt, x, graph_, labels, valid)
                b.record()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                v = float(loss)
                if not math.isfinite(v):
                    raise AssertionError(f"dist {tag}: non-finite loss at step {step}")
                if step or steps == 1:
                    timed.append(a.elapsed_time(b))
                emit({"phase": "dist_full_batch_train", "model": tag, "step": step,
                      "warmup": step == 0 and steps > 1, "loss": v,
                      "ms_per_step_events": a.elapsed_time(b), "ms_per_step_host": dt * 1e3,
                      "edges_per_s": edges / dt})
            launches = {fn.__name__: fn.launches for fn in counters}
            want = {**{fn.__name__: 0 for fn in counters},
                    **{k: v * steps for k, v in want_per_step.items()}}
            emit({"phase": "dist_full_batch_launch_counts", "model": tag, "steps": steps,
                  "launches": launches, "expected": want,
                  "ms_per_step": sum(timed) / len(timed),
                  "edges_per_s": edges * len(timed) * 1e3 / sum(timed),
                  "max_memory_allocated": torch.cuda.max_memory_allocated()})
            if launches != want:
                raise AssertionError(f"dist {tag}: kernel launches {launches}, "
                                     f"expected {want}")
            for k in totals:
                totals[k] += launches[k]
            return model, opt

        # -- 15. GCN (bf16), gat4h at R = 256 and R = 512 -------------------
        xb = x32.to(torch.bfloat16)
        # a SpMM is one launch of the shard kernel (band, fallback, divide,
        # cast), an attention call, forward or backward, one of its shard
        # entry (band and fallback edges over its tables): no CSR kernel
        model, opt = train(lambda: GCN(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES,
                                       dtype=torch.bfloat16, device=dev),
                           dfbg, xb, 4, {"slab_spmm_shard": 3}, "gcn")
        emit({"phase": "dist_full_batch_stages", "model": "gcn",
              "ms": _staged_step(model, opt, xb, dfbg, labels, F, valid=valid)})
        del model, opt
        gat_r256 = {"slab_attention_spmm_mh_shard": 1, "slab_attention_spmm_shard": 1,
                    "onepass_bwd_shard": 2}

        def gat():
            return GAT(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES, heads=TF.HEADS, device=dev)

        model, opt = train(gat, dfbg, x32, 4, gat_r256, "gat_R256")
        emit({"phase": "dist_full_batch_stages", "model": "gat",
              "ms": _staged_step(model, opt, x32, dfbg, labels, F, valid=valid,
                                 method="attention_spmm_mh", label="attention")})
        with torch.no_grad():
            logits = model.full_graph(x32, dfbg)
        if logits.shape != (dfbg.rows_per_rank, TF.CLASSES) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"dist gat: logits {tuple(logits.shape)} not finite")
        del model, opt, logits
        torch.cuda.empty_cache()
        dfbg512 = graph(512)
        x512, labels512, valid512 = node_arrays(dfbg512)
        model, opt = train(gat, dfbg512, x512, 4,
                           {"slab_attention_spmm_mh_shard": 1, "slab_attention_spmm_shard": 1,
                            "slab_attention_bwd_mh_shard": 1, "slab_attention_bwd_shard": 1},
                           "gat_R512")
        emit({"phase": "dist_full_batch_stages", "model": "gat", "graph": "R512",
              "ms": _staged_step(model, opt, x512, dfbg512, labels512, F, valid=valid512,
                                 method="attention_spmm_mh", label="attention")})
        del model, opt, x512, labels512, valid512
        torch.cuda.empty_cache()

        # reproducibility: one step twice from the same weights and inputs
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        for tag, make, xr in (("gcn", lambda: GCN(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES,
                                                  dtype=torch.bfloat16, device=dev), xb),
                              ("gat", gat, x32)):
            torch.manual_seed(0)
            runs = [make()]
            runs.append(make())
            runs[1].load_state_dict(runs[0].state_dict())
            losses = [TF.dist_full_batch_step(mdl, torch.optim.Adam(mdl.parameters(),
                                                                    lr=TF.LR),
                                              xr, dfbg, labels, valid) for mdl in runs]
            torch.cuda.synchronize()
            same = [torch.equal(a.grad.view(bits[a.dtype]), b.grad.view(bits[b.dtype]))
                    for a, b in zip(runs[0].parameters(), runs[1].parameters())]
            same_loss = torch.equal(losses[0].view(torch.int32), losses[1].view(torch.int32))
            emit({"phase": "dist_repeat_bitwise", "model": tag, "loss": float(losses[0]),
                  "loss_bit_equal": same_loss, "gradients": len(same),
                  "gradients_bit_equal": sum(same)})
            if not same_loss or not all(same):
                raise AssertionError(f"dist {tag}: two steps from the same weights differ "
                                     f"(loss equal {same_loss}, gradients equal "
                                     f"{sum(same)} of {len(same)})")
            del runs, losses
        torch.cuda.empty_cache()

        # -- 16. rows 9-14 at the world-1 path's calls ------------------------
        def bound(nb, ops):
            b_ms, o_ms = nb / hbm * 1e3, ops / H100_F32_OPS * 1e3
            return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts if t is not None)

        timing = {k: [] for k in SHARD_ROWS}
        full_errs = {k: 0.0 for k in SHARD_ROWS}
        gen = torch.Generator(device=dev).manual_seed(31)
        r_blk, rs = dfbg._r_blk, dfbg.rows_per_rank
        xs = {128: x32, 256: torch.randn((rs, 256), generator=gen, device=dev)}
        # row 9 at a GCN step's three calls ('sum', bf16 x): the whole
        # function on the table the path builds (world 1: zero halos, no
        # remote rows), held against its plain version (also on float32 x,
        # for a float32 error) and launched twice bit for bit; timed beside
        # the band-only mode and torch.sparse.mm over the shard's whole CSR
        for orient, f in (("graph", 128), ("graph", 256), ("transpose", 256)):
            band = dfbg._spmm[orient == "transpose"].band
            what = f"world 1 {orient} F={f}"
            for dt in (torch.float32, torch.bfloat16):
                x = xs[f].to(dt)
                prev, nxt = DF._halo_pair(x, r_blk, mesh)
                parts = (x, prev, nxt, x.new_zeros((0, f)))
                got = slab_spmm_shard(band, *parts, "sum", torch.float32)
                f32 = [a.float() for a in parts]
                e = _check_sum("slab_spmm_shard", got,
                               slab_spmm_shard_ref(band, *f32, "sum", torch.float32),
                               slab_spmm_shard_ref(band, *[a.abs() for a in f32], "sum",
                                                   torch.float32), f"{what} {dt}")
                if e is not None:
                    full_errs["slab_spmm_shard"] = max(full_errs["slab_spmm_shard"], e)
                _same_bits("slab_spmm_shard", got,
                           slab_spmm_shard(band, *parts, "sum", torch.float32), what)
                del got
            table = torch.cat(parts)
            # the shard's whole CSR over the table: band and fallback edges
            ell = band.ell.long()
            ok = ell >= 0
            rows_b = torch.arange(rs, device=dev)[:, None].expand_as(ell)
            cols_b = (rows_b // r_blk) * r_blk + ell
            x_rows = table.shape[0]
            key = torch.cat([rows_b[ok] * x_rows + cols_b[ok],
                             band.fb_dst.long() * x_rows + band.fb_src.long()]).sort().values
            crow = torch.zeros(rs + 1, dtype=torch.int64, device=dev)
            crow[1:] = torch.bincount(key // x_rows, minlength=rs).cumsum(0)
            a_all = torch.sparse_csr_tensor(crow, key % x_rows,
                                            torch.ones(key.numel(), dtype=x.dtype, device=dev),
                                            (rs, x_rows))
            nnz_band, n_fb = int(ok.sum()), int(band.fb_src.numel())
            del key, rows_b, cols_b, ok, ell
            # the ELL's real entries, X once, the fallback row pointer and ids,
            # the output once in x's type ('sum': no degrees)
            el = x.element_size()
            nb = (4 * nnz_band + x_rows * f * el + band.fb_rowptr.numel() * 8 + 4 * n_fb
                  + rs * f * el)
            b_ms, b_by = bound(nb, (nnz_band + n_fb) * f)
            x_ext = torch.cat(parts[1:2] + parts[:1] + parts[2:3])
            row = {"kernel": "slab_spmm_shard", "orientation": orient, "f": f, "reduce": "sum",
                   "dtype": "bfloat16", "band_edges": nnz_band, "fallback_edges": n_fb,
                   "remote_rows": 0,
                   "ms": cuda_ms(lambda: slab_spmm_shard(band, *parts, "sum", torch.float32)),
                   "band_only_ms": cuda_ms(lambda: slab_spmm_band_shard(band, x_ext,
                                                                        torch.float32)),
                   "plain_ms": cuda_ms(lambda: slab_spmm_shard_ref(band, *parts, "sum",
                                                                   torch.float32), iters=5),
                   "library_ms": cuda_ms(lambda: torch.sparse.mm(a_all, table)),
                   "bytes": nb, "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            timing["slab_spmm_shard"].append(row)
            del a_all, table, x_ext, parts, x, prev, nxt, f32
        layers = {"layer0": (TF.HEADS, TF.HIDDEN // TF.HEADS), "layer1": (1, TF.CLASSES)}
        no_rows = np.zeros(0, np.int64)
        for r_blk, g in ((256, dfbg), (512, dfbg512)):
            st = g._attn_structs()
            pair = st["pair"]
            rs = g.rows_per_rank
            if st["route_a"] is not None or st["route_b"] is not None:
                raise AssertionError("world 1 planned remote rows")
            e_band = int((pair.fwd.ell >= 0).sum())
            e_fb = int(pair.fwd.fb_src.numel())
            for layer, (h, f) in layers.items():
                # the band by source the kernel reads: the band CSR (window
                # kernels) or t_ell's real entries
                design, chunk, tile = AG.backward_design(pair, f)
                t_bytes = (nbytes(pair.t_rowptr, pair.t_rows) if design == "windows"
                           else 4 * int((pair.t_ell >= 0).sum()))
                x, gg = (torch.randn((rs, h, f), generator=gen, device=dev) for _ in range(2))
                ad, as_, t = (torch.randn((rs, h), generator=gen, device=dev) for _ in range(3))
                # the path's calls, whole (halos, remote rows, launch), and
                # their inputs as the path builds them at world 1 (zero
                # halos, no remote rows)
                out_p, m, s, _, _ = g._attn_fwd(x, ad, as_, 0.2)
                grads_p = g._attn_bwd(*g._attn_fwd(x, ad, as_, 0.2)[3:], ad, m, s, t, gg, 0.2)
                stats, stats_mag = (AG.attention_stats(ad, m, s, tt) for tt in (t, -t.abs()))
                table_a, table_a_mag = (DF.halo_table(a, as_, 0, rs, r_blk, no_rows)
                                        for a in (x, x.abs()))
                table_b, table_b_mag = (DF.halo_table(a, sts, 0, rs, r_blk, no_rows)
                                        for a, sts in ((gg, stats), (gg.abs(), stats_mag)))
                as_ext = DF.halo_rows(as_, 0, rs, r_blk)
                st_ext, st_mag = (DF.halo_rows(a, 0, rs, r_blk) for a in (stats, stats_mag))
                for a in (st_ext, st_mag):
                    a[..., 2].clamp_(min=1e-16)
                as32, g32 = as_.float().contiguous(), gg.float().contiguous()
                calls = []
                if r_blk == 256:
                    args, mag_args = [table_a, ad, as_ext], [table_a_mag, ad, as_ext]
                    if h == 1:
                        name, fwd = "slab_attention_fwd_shard", AK.slab_attention_spmm_shard
                        ref = AK.slab_attention_spmm_shard_ref
                        args, mag_args = ([tb.squeeze_heads(), a[:, 0], e[:, 0]]
                                          for tb, a, e in (args, mag_args))
                    else:
                        name, fwd = "slab_attention_fwd_mh_shard", AK.slab_attention_spmm_mh_shard
                        ref = AK.slab_attention_spmm_mh_shard_ref
                    # x's table (parts and tail) and the halo-extended
                    # alpha_src once, the ELL's real entries, the fallback
                    # row pointer and ids, alpha_dst; out, m and s written
                    nb = (nbytes(*table_a[:3], table_a.tail.data, as_ext, ad) + 4 * e_band
                          + nbytes(pair.fwd.fb_rowptr) + 4 * e_fb + rs * h * f * 4 + 8 * rs * h)
                    calls.append((name, nb, (e_band + e_fb) * h * (2 * f + 5),
                                  lambda fwd=fwd, args=args: fwd(pair.fwd, *args,
                                                                 return_stats=True),
                                  lambda ref=ref, args=args: ref(pair.fwd, *args,
                                                                 return_stats=True),
                                  lambda ref=ref, args=mag_args: (ref(pair.fwd, *args),),
                                  (out_p, m, s),
                                  lambda: g._attn_fwd(x, ad, as_, 0.2)[:3],
                                  lambda: DF._halo_pairs([x, as32], r_blk, mesh),
                                  lambda: DF._gather_packed(as32, x.reshape(rs, -1),
                                                            st["route_a"], mesh)))
                args = (table_a, as_ext, table_b, st_ext)
                # both tables (parts and tails), alpha_src's and the stats'
                # halo-extended rows once, the ELL's real entries, the band
                # by source, both fallback CSRs; dx, dad and das written
                nb = (nbytes(*table_a[:3], table_a.tail.data, *table_b[:3], table_b.tail.data,
                             as_ext, st_ext) + 4 * e_band + t_bytes
                      + nbytes(pair.fwd.fb_rowptr, pair.fb_t_rowptr)
                      + 4 * (e_fb + int(pair.fb_t_dst.numel())) + rs * h * f * 4 + 8 * rs * h)
                calls.append((_bwd_row(r_blk, h), nb, (e_band + e_fb) * h * (4 * f + 10),
                              lambda args=args: AG.slab_attention_bwd_mh_shard(pair, *args),
                              lambda args=args: AG.slab_attention_bwd_shard_ref(pair, *args),
                              lambda: AG.slab_attention_bwd_shard_ref(
                                  pair, table_a_mag, as_ext, table_b_mag, st_mag),
                              grads_p,
                              lambda: g._attn_bwd(table_a, as_ext, ad, m, s, t, gg, 0.2),
                              lambda: DF._halo_pairs([g32, stats], r_blk, mesh),
                              lambda: DF._gather_packed(stats.reshape(rs, -1),
                                                        g32.reshape(rs, -1), st["route_b"],
                                                        mesh)))
                for name, nb, ops, kern, plain, mag, path_out, whole, halos, tail in calls:
                    # the kernel against its plain version on these inputs:
                    # out (fwd; m equal, s within 1e-5) or dx, dad, das;
                    # twice bit for bit, and bit for bit the path's call
                    what = f"world 1 R={r_blk} {layer}"
                    got, want, mags = kern(), plain(), mag()
                    for a, b, c in zip(got, kern(), path_out):
                        _same_bits(name, a, b, what)
                        _same_bits(name, a, c.reshape(a.shape), what + " (the path's call)")
                    for i, (a, b) in enumerate(zip(got, want)):
                        if i < len(mags):
                            full_errs[name] = max(full_errs[name],
                                                  _close(name, a, b, mags[i], what))
                        elif i == 1:
                            if not torch.equal(a, b):
                                raise AssertionError(f"{name} {what}: m differs")
                        else:
                            _close(name, a, b, b, what + " s")
                    del got, want, mags
                    b_ms, b_by = bound(nb, ops)
                    row = {"kernel": name, "block_rows": r_blk, "layer": layer, "heads": h,
                           "f": f, "dtype": "float32", "band_edges": e_band,
                           "fallback_edges": e_fb, "remote_rows": 0,
                           **({"design": design, "chunk_elements": chunk, "tile_rows": tile}
                              if "bwd" in name else {}),
                           "ms": cuda_ms(kern), "whole_ms": cuda_ms(whole),
                           "halo_exchange_ms": cuda_ms(halos),
                           "remote_exchange_ms": cuda_ms(tail),
                           "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                           "library_ms": None, "bytes": nb, "operations": ops,
                           "bound_ms": b_ms, "bound_by": b_by}
                    emit(row)
                    timing[name].append(row)
                del (x, gg, ad, as_, t, m, s, out_p, grads_p, stats, stats_mag, table_a,
                     table_a_mag, table_b, table_b_mag, as_ext, st_ext, st_mag, calls, args)
                torch.cuda.empty_cache()

        emit({"phase": "shard_kernel_check", "world": 1, "nodes": n,
              "max_abs_err": full_errs,
              "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum; m equal, "
                           "s within 1e-5"})

        # where a sharded SpMM call's time goes, beside its kernel: GCN layer
        # 1's forward (bf16, F = 256) at R = 256 (the attention rows above
        # carry theirs)
        st = dfbg._spmm[False]
        xb = xs[256].to(torch.bfloat16)
        prev, nxt = DF._halo_pair(xb, TF.BLOCK_ROWS, mesh)
        empty = xb.new_zeros((0, 256))
        emit({"phase": "dist_call_breakdown", "call": "gcn layer1 spmm forward",
              "whole_ms": cuda_ms(lambda: dfbg._spmm_sharded(xb, transpose=False, reduce="sum",
                                                             compute_dtype=torch.float32)),
              "halo_exchange_ms": cuda_ms(lambda: DF._halo_pair(xb, TF.BLOCK_ROWS, mesh)),
              "remote_exchange_ms": (0.0 if st.route is None else cuda_ms(
                  lambda: DF._dist_gather_planned(xb, st.route, mesh=mesh))),
              "kernel_ms": cuda_ms(lambda: slab_spmm_shard(st.band, xb, prev, nxt, empty, "sum",
                                                           torch.float32))})
        del prev, nxt, empty, dfbg512
        torch.cuda.empty_cache()

        # agreement: one float32 step each through the single-device graph
        # and the world-1 sharded graph, from the same weights
        x32, labels, valid = node_arrays(graph(TF.BLOCK_ROWS))
        for tag, make in (("gcn_f32", lambda: GCN(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES,
                                                  device=dev)), ("gat", gat)):
            torch.manual_seed(0)
            single, sharded = make(), make()
            sharded.load_state_dict(single.state_dict())
            l_s = TF.full_batch_step(single, torch.optim.Adam(single.parameters(), lr=TF.LR),
                                     reused["feats"], reused["fbg"], reused["labels"])
            l_d = TF.dist_full_batch_step(sharded, torch.optim.Adam(sharded.parameters(),
                                                                    lr=TF.LR),
                                          x32, graph(TF.BLOCK_ROWS), labels, valid)
            d_loss = abs(float(l_s) - float(l_d))
            # Adam's first update is lr * g / (|g| + 1e-8): where |g| is small,
            # sum-order noise in g moves it by up to lr, so the parameters are
            # held where |g| >= 1e-5 (the update's slope there is at most
            # lr * 1e-8 / 1e-10 = 0.5 per unit of g).  Each gradient tensor is
            # held to 1e-3 of its own largest entry: the entries are sums of
            # 2.4M nodes' terms of either sign, taken in another order, so
            # rounding is relative to the terms, not to the sum (GCN's first
            # weight, whose sums cancel most, reads ~3.4e-4 on the card)
            with torch.no_grad():
                per = {}
                for (name, a), b in zip(single.named_parameters(), sharded.parameters()):
                    d_g, g_max = float((a.grad - b.grad).abs().max()), float(a.grad.abs().max())
                    per[name] = {
                        "grad_max_abs_diff": d_g, "grad_max_abs": g_max,
                        "grad_diff_over_tensor_max": d_g / g_max if g_max else d_g,
                        "param_max_abs_diff": float((a - b).abs().max()),
                        "param_max_abs_diff_where_grad_ge_1e-5": float(
                            ((a - b).abs() * (a.grad.abs() >= 1e-5)).max()),
                        "entries_with_grad_lt_1e-5": int((a.grad.abs() < 1e-5).sum())}
            worst = max(per, key=lambda k: per[k]["grad_diff_over_tensor_max"])
            d_grad = per[worst]["grad_diff_over_tensor_max"]
            d_param = max(v["param_max_abs_diff_where_grad_ge_1e-5"] for v in per.values())
            emit({"phase": "dist_agreement", "model": tag, "loss_single": float(l_s),
                  "loss_dist": float(l_d), "loss_abs_diff": d_loss,
                  "grad_diff_over_tensor_max": d_grad, "worst_grad_tensor": worst,
                  "param_max_abs_diff_where_grad_ge_1e-5": d_param, "tensors": per,
                  "tolerance": "loss 1e-5 relative; each gradient tensor 1e-3 of its own "
                               "largest entry; parameters 1e-4 where |grad| >= 1e-5"})
            if (d_loss > 1e-5 * max(1.0, abs(float(l_s))) or d_param > 1e-4
                    or any(v["grad_max_abs_diff"] > 1e-3 * v["grad_max_abs"]
                           for v in per.values())):
                raise AssertionError(f"dist {tag} step differs from the single-device "
                                     f"step: loss {d_loss}, gradient {worst} off by "
                                     f"{d_grad} of its largest entry, parameters {d_param}")
            del single, sharded
        torch.cuda.empty_cache()
        del graphs, dfbg
        torch.cuda.empty_cache()
    finally:
        D.finalize()
    if dist.is_initialized():
        raise AssertionError("the process group is still up")

    def kernel_row(name):
        source, replaces, counter = SHARD_ROWS[name]
        rows = timing[name]
        out = {"name": name, "route": "cuda",
               "source": "cugraph_gnn_tpu_torch/csrc/" + source, "replaces": replaces,
               "launches": totals[counter],
               "max_abs_err": max(errs[name], full_errs[name]),
               "max_abs_err_4_ranks": errs[name], "max_abs_err_world_1": full_errs[name],
               **_summed(rows, totals[counter]),
               "library_ms": (None if rows[0]["library_ms"] is None
                              else sum(r["library_ms"] for r in rows))}
        for key in ("band_only_ms", "whole_ms", "halo_exchange_ms", "remote_exchange_ms"):
            if key in rows[0]:
                out[key] = sum(r[key] for r in rows)
        return out

    # row 9: one GCN step's three calls added (the whole function; beside it
    # the band-only mode's time); rows 10 and 13: the R = 256 step's call
    # each; row 11: its two calls; rows 12 and 14: the R = 512 step's call
    # each (each the launch over the tables; beside it the whole call's time
    # and its halo and remote-row exchanges')
    return [kernel_row(name) for name in ("slab_spmm_shard", "slab_attention_fwd_shard",
                                          "slab_attention_bwd_onepass_shard",
                                          "slab_attention_bwd_shard",
                                          "slab_attention_fwd_mh_shard",
                                          "slab_attention_bwd_mh_shard")]


def _staged_step(model, opt, x, fbg, labels, F, method="spmm", label="spmm", valid=None):
    """One full-batch step with CUDA events around its stages: the graph
    aggregations (``fbg.<method>``: the slab SpMMs, forward and backward
    through the transpose, or the attention kernels, forward and backward;
    on a sharded graph with their halo exchanges and fallback exchanges),
    the rest of forward and backward (Linears, ReLU, casts, scores; loss
    backward), the loss and Adam.  With ``valid`` (a ``DistFullBatchGraph``
    step), the loss and the gradients' ``all_reduce`` are
    ``train_full.dist_full_batch_step``'s own (``dist_loss``,
    ``all_reduce_grads``), the latter a stage of its own.  Returns
    milliseconds per stage, the aggregations' under ``label``."""
    import torch

    from cugraph_gnn_tpu_torch import train_full as TF

    def event():
        return torch.cuda.Event(enable_timing=True)

    class Mark(torch.autograd.Function):
        """Identity whose backward records ``ev``: two marks bracket the
        backward of what lies between them."""

        @staticmethod
        def forward(ctx, t, ev):
            ctx.ev = ev
            return t.view_as(t)

        @staticmethod
        def backward(ctx, grad):
            ctx.ev.record()
            return grad, None

    fwd, bwd = [], []

    def timed(graph, h, *args, **kw):
        grad = h.requires_grad
        if grad:
            start, end = event(), event()
            h = Mark.apply(h, end)
        a, b = event(), event()
        a.record()
        out = getattr(graph, method)(h, *args, **kw)
        b.record()
        fwd.append((a, b))
        if grad:
            out = Mark.apply(out, start)
            bwd.append((start, end))
        return out

    class Timed:
        """``graph`` with every ``method`` call bracketed by events (and so
        each relation's graph of a ``RelationalFullBatch``)."""

        def __init__(self, graph):
            self.graph = graph

        def __getattr__(self, name):
            if name == method:
                return lambda *a, **kw: timed(self.graph, *a, **kw)
            if name == "graphs":
                return [Timed(g) for g in self.graph.graphs]
            return getattr(self.graph, name)

    stages = ("forward", "loss", "backward", "adam") + (
        () if valid is None else ("grad_all_reduce",))
    ev = {k: (event(), event()) for k in stages}
    opt.zero_grad(set_to_none=True)
    ev["forward"][0].record()
    logits = model.full_graph(x, Timed(fbg)).float()
    ev["forward"][1].record()
    ev["loss"][0].record()
    if valid is None:
        loss = F.cross_entropy(logits, labels)
    else:
        loss = TF.dist_loss(logits, labels, valid, fbg.mesh.group)
    ev["loss"][1].record()
    ev["backward"][0].record()
    loss.backward()
    ev["backward"][1].record()
    if valid is not None:
        ev["grad_all_reduce"][0].record()
        TF.all_reduce_grads(model, loss, fbg.mesh.group)
        ev["grad_all_reduce"][1].record()
    ev["adam"][0].record()
    opt.step()
    ev["adam"][1].record()
    torch.cuda.synchronize()
    ms = {k: a.elapsed_time(b) for k, (a, b) in ev.items()}
    agg_fwd = sum(a.elapsed_time(b) for a, b in fwd)
    agg_bwd = sum(a.elapsed_time(b) for a, b in bwd)
    return {f"{label}_kernels": agg_fwd + agg_bwd, f"{label}_forward": agg_fwd,
            f"{label}_backward": agg_bwd,
            "linears_and_elementwise": ms["forward"] - agg_fwd
            + ms["backward"] - agg_bwd,
            "loss": ms["loss"], "adam": ms["adam"], f"{label}_calls": [len(fwd), len(bwd)],
            **({} if valid is None else {"grad_all_reduce": ms["grad_all_reduce"]})}


def main() -> None:
    import torch

    probe_only = sys.argv[1:] == ["--probe"]
    if sys.argv[1:] and not probe_only:
        sys.exit("usage: chip_smoke.py [--probe]")

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from cugraph_gnn_tpu_torch import _build, _native
    from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import (
        gather_rows,
        gather_rows_ref,
    )
    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
        fused_uniform_sample,
        fused_uniform_sample_ref,
    )
    from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import (
        multihop_uniform_batched,
    )
    from cugraph_gnn_tpu_torch import train as T
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_kernel as AK
    from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import slab_attention_spmm_mh
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
        slab_spmm,
        slab_spmm_band,
        slab_spmm_band_shard,
        slab_spmm_shard,
    )
    from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import csr_spmm

    wall0 = time.perf_counter()

    # float32 products in full precision on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card ------------------------------------------------------------
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    power_limit = smi.split(",")[-1].strip()
    print(smi)
    print(f"device: {card} (count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")

    def emit(obj):
        print(json.dumps({**obj, "card": card, "power_limit": power_limit,
                          "t_s": time.perf_counter() - wall0}), flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(["gather_rows", "uniform_sample", "slab_spmm", "slab_spmm_shard",
                          "csr_spmm", "slab_attn_fwd", "slab_attn_bwd",
                          "slab_attn_bwd_shard"])
    wall = time.perf_counter() - t0
    for name, b in built.items():
        print(f"build {name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "ptxas" in line:
                print(f"  {line.strip()}")
    t0 = time.perf_counter()
    if not _native.have_native():
        raise RuntimeError("the host graph builders did not build (no g++)")
    emit({"phase": "build", "wall_s": wall,
          "seconds": {n: b.seconds for n, b in built.items()},
          "host_library_s": time.perf_counter() - t0})

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2

    def cuda_ms(fn, iters=20, warmup=3):
        """Median CUDA-event time of ``fn`` with the L2 flushed before each."""
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for a, b in ev:
            flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in ev)[iters // 2]

    if probe_only:
        # the probe phase alone, on phase 6's graph and its pairs at R = 256
        # and 512
        from cugraph_gnn_tpu_torch import train_full as TF
        from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph

        t0 = time.perf_counter()
        g = TF.make_synthetic_banded(0, dev)
        fbg = FullBatchGraph.from_coo(g.src, g.dst, g.num_nodes, reorder="none",
                                      block_rows=TF.BLOCK_ROWS, device=dev)
        pair = fbg.attention_pair
        indptr, indices, _ = _native.build_csr(g.dst, g.src, g.num_nodes)
        pair512 = AG.build_attention_slab_pair(indptr, indices, block_rows=512, device=dev)
        del g
        torch.cuda.synchronize()
        emit({"phase": "probe_data", "seconds": time.perf_counter() - t0})
        attn_bwd_probe(dev, emit, cuda_ms, pair, pair512)
        print(smi)
        return

    # -- 3. kernels at the training path's shapes --------------------------
    t0 = time.perf_counter()
    graph = T.make_synthetic_products(0, dev)
    torch.cuda.synchronize()
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "nodes": graph.num_nodes, "edges": int(graph.indices.shape[0]),
          "max_degree": graph.max_degree})

    gen = torch.Generator(device=dev).manual_seed(1)
    seeds = torch.randint(0, graph.num_nodes, (T.REPS, T.BATCH), generator=gen,
                          device=dev, dtype=torch.int32)
    seeds[:, ::100] = -1          # padded seeds propagate -1 slots downstream
    k = T.FANOUTS[0]
    u0 = torch.rand((T.REPS * T.BATCH, k), generator=gen, device=dev)
    u1 = torch.rand((T.REPS * T.BATCH * (k + 1), T.FANOUTS[1]), generator=gen,
                    device=dev)
    sample = multihop_uniform_batched(graph.indptr, graph.indices, seeds,
                                      T.FANOUTS, u=[u0, u1], device=dev)
    hop_inputs = [(seeds.reshape(-1), u0), (sample.levels[1].reshape(-1), u1)]
    ids = sample.step(0).input_nodes
    assert ids.shape == (123_904,) and bool((ids < 0).any())

    hbm = 3.35e12   # H100 SXM HBM3 bytes/s (data sheet)
    kernels = []

    # B: fused sampler, bit equality (and two launches bit for bit) and
    # timing per hop
    b_rows = []
    for h, (sd, u) in enumerate(hop_inputs):
        kf = u.shape[1]
        got = fused_uniform_sample(graph.indptr, graph.indices, sd, u, kf)
        again = fused_uniform_sample(graph.indptr, graph.indices, sd, u, kf)
        want = fused_uniform_sample_ref(graph.indptr, graph.indices, sd, u, kf)
        torch.cuda.synchronize()
        for name, g, g2, w in zip(("neighbors", "edge_ids", "num_sampled"), got, again, want):
            if not (torch.equal(g, w) and torch.equal(g, g2)):
                raise AssertionError(f"sampler hop {h} {name} differs from the "
                                     f"plain version or between two launches")
        nbytes, floor_bytes = _sampler_bytes(graph.indptr, sd, kf, want)
        row = {
            "kernel": "uniform_sample", "hop": h, "seeds": sd.numel(), "k": kf,
            "ms": cuda_ms(lambda: fused_uniform_sample(
                graph.indptr, graph.indices, sd, u, kf)),
            "plain_ms": cuda_ms(lambda: fused_uniform_sample_ref(
                graph.indptr, graph.indices, sd, u, kf), iters=5),
            "library_ms": None, "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
            "sector_floor_bytes": floor_bytes, "sector_floor_ms": floor_bytes / hbm * 1e3,
            "launches_per_step": 2 / T.REPS, "max_abs_err": 0, "bit_equal": True,
        }
        emit(row)
        b_rows.append(row)
    # the kernel's other shapes: k = 16 and 17 (the last k whose lane groups
    # share a warp, and the first that takes a warp alone), 33 (one thread a
    # seed), on a batch that is not a multiple of 32, and a batch of one seed
    hub = int(torch.argmax(graph.indptr[1:] - graph.indptr[:-1]))
    cases = [(kc, sample.levels[1].reshape(-1)[:10_007]) for kc in (16, 17, 33)]
    cases.append((10, torch.tensor([hub], dtype=torch.int32, device=dev)))
    for kc, sd in cases:
        u = torch.rand((sd.numel(), kc), generator=gen, device=dev)
        got = fused_uniform_sample(graph.indptr, graph.indices, sd, u, kc)
        again = fused_uniform_sample(graph.indptr, graph.indices, sd, u, kc)
        want = fused_uniform_sample_ref(graph.indptr, graph.indices, sd, u, kc)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) and torch.equal(g, g2)
                   for g, g2, w in zip(got, again, want)):
            raise AssertionError(f"sampler at k = {kc}, {sd.numel()} seeds differs from "
                                 f"the plain version or between two launches")
        emit({"phase": "sampler_case", "k": kc, "seeds": sd.numel(), "bit_equal": True})

    # A: row gather, bit equality for both output types, timing to bf16
    for out_dtype in (torch.bfloat16, torch.float32):
        got = gather_rows(graph.feats, ids, out_dtype)
        want = gather_rows_ref(graph.feats, ids, out_dtype)
        torch.cuda.synchronize()
        bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError(f"row gather to {out_dtype} differs from the "
                                 f"plain version")
    a_err = float((got.float() - want.float()).abs().max())
    f = graph.feats.shape[1]
    uniq = int(torch.unique(ids[ids >= 0]).numel())
    a_bytes = 4 * ids.numel() + 4 * f * uniq + 2 * f * ids.numel()
    a_row = {
        "kernel": "gather_rows", "ids": ids.numel(), "table": list(graph.feats.shape),
        "out_dtype": "bfloat16",
        "ms": cuda_ms(lambda: gather_rows(graph.feats, ids, torch.bfloat16)),
        "plain_ms": cuda_ms(lambda: gather_rows_ref(graph.feats, ids,
                                                    torch.bfloat16)),
        "library_ms": cuda_ms(lambda: torch.index_select(
            graph.feats, 0, ids.clamp(min=0)).to(torch.bfloat16)),
        "bytes": a_bytes, "bound_ms": a_bytes / hbm * 1e3,
        "launches_per_step": 1, "max_abs_err": a_err, "bit_equal": True,
    }
    emit(a_row)

    # -- 4. small input: card against CPU ----------------------------------
    small_cpu = T.make_synthetic_products(3, "cpu", num_nodes=2000, feat_dim=16,
                                          classes=5)
    small_gpu = T.SyntheticGraph(small_cpu.indptr.to(dev), small_cpu.indices.to(dev),
                                 small_cpu.feats.to(dev), small_cpu.labels.to(dev),
                                 small_cpu.max_degree)
    torch.manual_seed(3)
    m_cpu = GraphSAGE(16, 32, 5, device="cpu")
    m_gpu = GraphSAGE(16, 32, 5, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    o_cpu = torch.optim.Adam(m_cpu.parameters(), lr=1e-3)
    o_gpu = torch.optim.Adam(m_gpu.parameters(), lr=1e-3)
    g_cpu = torch.Generator().manual_seed(4)
    sd_small = torch.randint(0, 2000, (3, 64), generator=g_cpu, dtype=torch.int32)
    sd_small[:, ::9] = -1
    us = [torch.rand((3 * 64, 4), generator=g_cpu),
          torch.rand((3 * 64 * 5, 3), generator=g_cpu)]
    s_cpu = multihop_uniform_batched(small_cpu.indptr, small_cpu.indices,
                                     sd_small, (4, 3), u=us, device="cpu")
    s_gpu = multihop_uniform_batched(small_gpu.indptr, small_gpu.indices,
                                     sd_small, (4, 3), u=us, device=dev)
    for a, b in zip(s_cpu.levels, s_gpu.levels):
        assert torch.equal(a, b.cpu()), "small sample differs card vs CPU"
    loss_diff = 0.0
    for i in range(3):
        st_cpu, st_gpu = s_cpu.step(i), s_gpu.step(i)
        x_cpu = T.gather_features(st_cpu, small_cpu.feats, torch.float32)
        x_gpu = T.gather_features(st_gpu, small_gpu.feats, torch.float32)
        assert torch.equal(x_cpu, x_gpu.cpu()), "small gather differs card vs CPU"
        l_cpu = T.train_step(m_cpu, o_cpu, x_cpu, st_cpu, small_cpu.labels)
        l_gpu = T.train_step(m_gpu, o_gpu, x_gpu, st_gpu, small_gpu.labels)
        loss_diff = max(loss_diff, abs(float(l_cpu) - float(l_gpu)))
    if not loss_diff <= 1e-4:
        raise AssertionError(f"small f32 train steps: card vs CPU loss differ "
                             f"by {loss_diff}")
    emit({"phase": "small_input_agreement", "steps": 3,
          "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # -- 5. train path at full width ---------------------------------------
    torch.manual_seed(0)
    model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, T.CLASSES, num_layers=len(T.FANOUTS),
                      dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(2)
    blocks = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (gather_rows, fused_uniform_sample, slab_spmm, slab_spmm_band, csr_spmm,
                slab_attention_spmm_mh, AG.onepass_bwd, AG.slab_attention_bwd,
                AG.slab_attention_bwd_mh, slab_spmm_shard, slab_spmm_band_shard,
                AK.slab_attention_spmm_shard, AG.onepass_bwd_shard,
                AG.slab_attention_bwd_shard, AK.slab_attention_spmm_mh_shard,
                AG.slab_attention_bwd_mh_shard, AG.onepass_bwd_probe)
    for fn in counters:
        fn.launches = 0
    for blk in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, edges = T.train_block(model, opt, graph, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vals = torch.stack(losses).tolist()
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite loss in block {blk}: {vals}")
        emit({"phase": "train", "block": blk, "warmup": blk == 0,
              "losses": vals, "ms_per_step": dt * 1e3 / T.REPS,
              "sampled_edges": int(edges), "sampled_edges_per_s": int(edges) / dt,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {**{fn.__name__: 0 for fn in counters},
            "gather_rows": T.REPS * blocks, "fused_uniform_sample": 2 * blocks}
    emit({"phase": "launch_counts", "blocks": blocks, "launches": launches,
          "expected": want})
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # one more block, stage by stage (CUDA events; each stage synchronised)
    ev = {}

    def timed(name, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = fn()
        b.record()
        ev.setdefault(name, []).append((a, b))
        return r

    blk_sample = timed("sample", lambda: T.sample_block(graph, gen))
    for i in range(T.REPS):
        st = blk_sample.step(i)
        x = timed("feature_gather", lambda: T.gather_features(st, graph.feats))
        timed("model", lambda: T.train_step(model, opt, x, st, graph.labels))
    torch.cuda.synchronize()
    stages = {n: sum(a.elapsed_time(b) for a, b in v) / T.REPS for n, v in ev.items()}
    with torch.no_grad():
        logits = model(x, st)
    assert logits.shape == (T.BATCH, T.CLASSES) and bool(torch.isfinite(logits).all())
    emit({"phase": "stages", "ms_per_step": stages})
    sampled_launches = launches
    del sample, blk_sample, hop_inputs, ids, seeds, u0, u1, x, st, logits, model, opt
    loader_launches, loader_b_rows, gs = loader_path(dev, emit, graph, small_cpu, counters,
                                                     cuda_ms, hbm)
    emb_launches, emb_rows = embedding_paths(dev, emit, graph, small_cpu, counters, cuda_ms,
                                             hbm, gs)
    link_launches, link_rows = link_paths(dev, emit, graph, small_cpu, counters, cuda_ms,
                                          hbm, gs)
    variant_launches = sampling_variants(dev, emit, graph, small_cpu, counters, gs)
    dl_launches, dl_rows = dist_paths(dev, emit, graph, small_cpu, counters, cuda_ms, hbm, gs)
    surface_launches = surface(dev, emit, graph, gs, counters)
    # the link path's training, triplet and evaluation batches; GIN's loader
    link_total = {name: sum(link_launches[k][name] for k in ("binary", "triplet", "eval"))
                  for name in ("gather_rows", "fused_uniform_sample")}
    gin_loader = link_launches["gin_loader"]
    block_launches = dict(sampled_launches)
    for name in ("gather_rows", "fused_uniform_sample"):
        sampled_launches[name] += loader_launches[name] + sum(
            v[name] for v in emb_launches.values()) + link_total[name] + gin_loader[name] + sum(
            v[name] for v in variant_launches.values()) + sum(
            v[name] for v in dl_launches.values())
    del graph, gs
    torch.cuda.empty_cache()
    example_launches = examples(dev, emit, counters)
    script_launches = example_scripts(dev, emit, counters)
    script_launches.update(example_paths(dev, emit, counters))
    # the doctor, the traced batches, the meter and the fifteen scripts
    new_launches = {**surface_launches, **example_launches, **script_launches}
    for name in ("gather_rows", "fused_uniform_sample"):
        sampled_launches[name] += sum(v[name] for v in new_launches.values())
    torch.cuda.empty_cache()
    hetero_launches, hetero_rows = hetero_paths(dev, emit, counters, cuda_ms, hbm)
    for name in ("gather_rows", "fused_uniform_sample"):
        sampled_launches[name] += sum(v[name] for v in hetero_launches.values())

    reused, fb_rows = full_batch(dev, emit, cuda_ms, hbm, counters)
    gat_rows, probe_row = gat_full_batch(dev, emit, cuda_ms, hbm, counters, reused)
    shard_errs = shard_kernels(dev, emit)
    dist_rows = dist_full_batch(dev, emit, cuda_ms, hbm, counters, reused, shard_errs)
    del reused
    # row 3: no full-batch path launches it (rows 4 and 9 and the attention
    # kernels take the fallback edges); its numbers are the one-card
    # fallback calls of phase 7 (checked, accumulate mode too), beside the
    # embeddings' dedup sums (phases 5e, 5g): one launch a
    # CachedHostEmbedding step, two a DistEmbedding step
    csr_row = fb_rows[1]
    dd = emb_rows["dedup"]
    emb_csr = sum(v["csr_spmm"] for v in emb_launches.values())
    csr_row.update(launches_embedding=emb_csr, launches=csr_row["launches"] + emb_csr,
                   max_abs_err=max(csr_row["max_abs_err"], dd["max_abs_err"]),
                   **{f"{k}_dedup": dd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "library_ms", "slots")},
                   gap_ms_dedup=emb_csr * (dd["ms"] - dd["bound_ms"]))

    # -- 17. summary --------------------------------------------------------
    kernels.append({
        "name": "gather_rows", "route": "cuda",
        "source": "cugraph_gnn_tpu_torch/csrc/gather_rows.cu",
        "replaces": "cugraph_gnn_tpu/ops/pallas/gather_kernel.py:54",
        "launches": sampled_launches["gather_rows"], "max_abs_err": a_err,
        "ms": a_row["ms"], "plain_ms": a_row["plain_ms"],
        "bound_ms": a_row["bound_ms"], "bound_by": "bytes",
        "library_ms": a_row["library_ms"],
        # launches by path; the gap prices the block's and the loader's at
        # the block's shape, the cache reads (cached embedding, host-located
        # loader) and the DistEmbedding lookup at their own shapes
        "launches_block": block_launches["gather_rows"],
        "launches_loader": loader_launches["gather_rows"],
        **{f"launches_{k}": v["gather_rows"] for k, v in emb_launches.items()},
        **{f"{k}_{at}": emb_rows[at][k] for at in ("cache_read", "dist_lookup")
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        # the link path's at a link batch's 495,616-slot level, GIN's loader
        # batches at the block's shape
        "launches_link": link_total["gather_rows"],
        "launches_gin_loader": gin_loader["gather_rows"],
        **{f"launches_{k}": v["gather_rows"] for k, v in variant_launches.items()},
        **{f"{k}_link": link_rows["gather"][k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        # the weighted, temporal and disjoint loaders' batches at the block's
        # shape, the temporal link batches at the link level's
        "gap_ms": (block_launches["gather_rows"] + loader_launches["gather_rows"]
                   + gin_loader["gather_rows"] + sum(
                       v["gather_rows"] for k, v in variant_launches.items()
                       if k != "link_temporal")) * (a_row["ms"] - a_row["bound_ms"])
        + variant_launches["link_temporal"]["gather_rows"] * (
            link_rows["gather"]["ms"] - link_rows["gather"]["bound_ms"])
        + link_total["gather_rows"] * (link_rows["gather"]["ms"]
                                       - link_rows["gather"]["bound_ms"])
        + (emb_launches["cached"]["gather_rows"] + emb_launches["host_loader"]["gather_rows"])
        * (emb_rows["cache_read"]["ms"] - emb_rows["cache_read"]["bound_ms"])
        + emb_launches["dist"]["gather_rows"]
        * (emb_rows["dist_lookup"]["ms"] - emb_rows["dist_lookup"]["bound_ms"])
        # the hetero paths, each at its own shape (5q-5s): the block's bf16
        # gathers, the loaders' and the link batch's per-type joins priced at
        # their paper join
        + sum(hetero_launches[k]["gather_rows"] * (hetero_rows[r]["ms"]
                                                   - hetero_rows[r]["bound_ms"])
              for k, r in HETERO_GATHER_ROWS.items()),
        **{f"launches_hetero_{k}": v["gather_rows"] for k, v in hetero_launches.items()},
        **{f"{k}_{r}": hetero_rows[r][k] for r in HETERO_GATHER_ROWS.values()
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        # the dist paths (5t-5u): the owner's f32 read at a dist batch's
        # level (the rank-local batches too), the dist link batches at 5h's
        # link level
        **{f"launches_{k}": v["gather_rows"] for k, v in dl_launches.items()},
        **{f"{k}_dist_loader": dl_rows["gather"][k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "ids")},
        "gap_ms_dist": (dl_launches["dist_loader"]["gather_rows"]
                        + dl_launches["dist_local"]["gather_rows"])
        * (dl_rows["gather"]["ms"] - dl_rows["gather"]["bound_ms"])
        + dl_launches["dist_link"]["gather_rows"] * (link_rows["gather"]["ms"]
                                                       - link_rows["gather"]["bound_ms"])
        # 5y: the hierarchical loader's owner reads
        + dl_launches["hier_gather"]["gather_rows"] * (dl_rows["hier_gather"]["ms"]
                                                       - dl_rows["hier_gather"]["bound_ms"]),
        **{f"{k}_hier_gather": dl_rows["hier_gather"][k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "ids", "distinct")}})
    kernels[-1]["gap_ms"] += kernels[-1]["gap_ms_dist"]
    # the hetero dist paths' share of the hetero gap above (5w, 5x)
    kernels[-1]["gap_ms_hetero_dist"] = sum(
        hetero_launches[k]["gather_rows"] * (hetero_rows[HETERO_GATHER_ROWS[k]]["ms"]
                                             - hetero_rows[HETERO_GATHER_ROWS[k]]["bound_ms"])
        for k in ("dist", "dist_link"))
    # the sampler's numbers are one block's two launches (hop 0 + hop 1); its
    # gap prices the block's launches at the block's hops and the loader's
    # at a loader batch's hops
    def sampler_gap(launches, rows):
        return launches * sum(r["ms"] - r["bound_ms"] for r in rows) / len(rows)

    kernels.append({
        "name": "uniform_sample", "route": "cuda",
        "source": "cugraph_gnn_tpu_torch/csrc/uniform_sample.cu",
        "replaces": "cugraph_gnn_tpu/ops/pallas/sample_kernel.py:64",
        "launches": sampled_launches["fused_uniform_sample"], "max_abs_err": 0,
        "ms": sum(r["ms"] for r in b_rows),
        "plain_ms": sum(r["plain_ms"] for r in b_rows),
        "bound_ms": sum(r["bound_ms"] for r in b_rows), "bound_by": "bytes",
        "sector_floor_ms": sum(r["sector_floor_ms"] for r in b_rows),
        "ms_per_hop": [r["ms"] for r in b_rows], "library_ms": None,
        "launches_block": block_launches["fused_uniform_sample"],
        "launches_loader": loader_launches["fused_uniform_sample"],
        **{f"launches_{k}": v["fused_uniform_sample"] for k, v in emb_launches.items()},
        "ms_per_hop_loader": [r["ms"] for r in loader_b_rows],
        "bound_ms_loader": sum(r["bound_ms"] for r in loader_b_rows),
        "sector_floor_ms_loader": sum(r["sector_floor_ms"] for r in loader_b_rows),
        "launches_link": link_total["fused_uniform_sample"],
        "launches_gin_loader": gin_loader["fused_uniform_sample"],
        **{f"launches_{k}": v["fused_uniform_sample"] for k, v in variant_launches.items()},
        "ms_per_hop_link": [r["ms"] for r in link_rows["sampler"]],
        "plain_ms_link": sum(r["plain_ms"] for r in link_rows["sampler"]),
        "bound_ms_link": sum(r["bound_ms"] for r in link_rows["sampler"]),
        "sector_floor_ms_link": sum(r["sector_floor_ms"] for r in link_rows["sampler"]),
        "gap_ms": sampler_gap(block_launches["fused_uniform_sample"], b_rows)
        + sampler_gap(loader_launches["fused_uniform_sample"] + sum(
            v["fused_uniform_sample"] for v in emb_launches.values())
            + gin_loader["fused_uniform_sample"] + variant_launches["disjoint"][
                "fused_uniform_sample"], loader_b_rows)
        + sampler_gap(link_total["fused_uniform_sample"], link_rows["sampler"])
        # the hetero paths, each at its own hop calls (5q-5s)
        + sum(sampler_gap(hetero_launches[k]["fused_uniform_sample"], hetero_rows[r])
              for k, r in HETERO_SAMPLER_ROWS.items()),
        **{f"launches_hetero_{k}": v["fused_uniform_sample"] for k, v in hetero_launches.items()},
        **{f"ms_per_call_{r}": [x["ms"] for x in hetero_rows[r]]
           for r in HETERO_SAMPLER_ROWS.values()},
        **{f"{k}_{r}": sum(x[k] for x in hetero_rows[r]) for r in HETERO_SAMPLER_ROWS.values()
           for k in ("plain_ms", "bound_ms", "sector_floor_ms")},
        # the dist paths (5t-5u, 5y): the owner's hops of a dist batch (the
        # rank-local and hierarchical batches too), the dist link batches at
        # 5h's hops
        **{f"launches_{k}": v["fused_uniform_sample"] for k, v in dl_launches.items()},
        "ms_per_hop_dist_loader": [r["ms"] for r in dl_rows["sampler"]],
        "seeds_per_hop_dist_loader": [r["seeds"] for r in dl_rows["sampler"]],
        **{f"{k}_dist_loader": sum(r[k] for r in dl_rows["sampler"])
           for k in ("plain_ms", "bound_ms", "sector_floor_ms")},
        "gap_ms_dist": sampler_gap(sum(dl_launches[k]["fused_uniform_sample"]
                                       for k in ("dist_loader", "dist_local", "hier_gather")),
                                   dl_rows["sampler"])
        + sampler_gap(dl_launches["dist_link"]["fused_uniform_sample"], link_rows["sampler"])})
    kernels[-1]["gap_ms"] += kernels[-1]["gap_ms_dist"]
    kernels[-1]["gap_ms_hetero_dist"] = sum(
        sampler_gap(hetero_launches[k]["fused_uniform_sample"],
                    hetero_rows[HETERO_SAMPLER_ROWS[k]]) for k in ("dist", "dist_link"))
    # phases 5z and 5zz by path; the gap prices the traced and metered 5b
    # batches and ogbn_train's batches (5b's shape without dedup) at the
    # loader's shape; the doctor's 2-seed ring and node_classification's
    # 10,000-node batches lie far below every timed shape and are not priced,
    # nor are the twelve other scripts' runs (their tables, widths and
    # graphs match no timed call)
    by_name = {row["name"]: row for row in kernels}
    for name, counter, per_launch in (
            ("gather_rows", "gather_rows", a_row["ms"] - a_row["bound_ms"]),
            ("uniform_sample", "fused_uniform_sample",
             sum(r["ms"] - r["bound_ms"] for r in loader_b_rows) / len(loader_b_rows))):
        row = by_name[name]
        row.update({f"launches_{k}": v[counter] for k, v in new_launches.items()})
        row["gap_ms_surface_examples"] = per_launch * sum(
            new_launches[k][counter] for k in ("trace", "meter", "ogbn_train"))
        row["gap_ms"] += row["gap_ms_surface_examples"]
    kernels += fb_rows + gat_rows + dist_rows + [probe_row]
    # the example scripts' launches of rows 3-14 (5zz): cached embeddings'
    # dedup sums, the full-batch models on the karate stand-in, the
    # distributed full batch at world 1
    by_name = {row["name"]: row for row in kernels}
    row_of = {"csr_spmm": "csr_spmm", "slab_spmm": "slab_spmm",
              "slab_attention_spmm_mh": "slab_attention_fwd",
              "onepass_bwd": "slab_attention_bwd_onepass",
              "slab_attention_bwd": "slab_attention_bwd",
              "slab_attention_bwd_mh": "slab_attention_bwd_mh",
              **{v[2]: k for k, v in SHARD_ROWS.items()}}
    for counter, name in row_of.items():
        n = sum(v[counter] for v in script_launches.values())
        if n:
            by_name[name]["launches_examples"] = n
            by_name[name]["launches"] += n
    emit({"phase": "wall", "seconds": time.perf_counter() - wall0})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
