"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; one CUDA card, nvcc)

Builds the port's CUDA kernels from csrc/ (nvcc, first use) and drives the
port's paths through the entry points a user calls, with every kernel's
launch count set to 0 just before a path and read just after it:

1. serving (serve.prepare/run): the bench workload - a 20 Mbp synthetic
   pangenome (8 haplotypes), 16384 reads of 150 bp with 1% errors, min_len
   20, min_occ 1, m=14 seed table, s=19 long-seed dictionary, MEM capacity
   8, tag capacity 8 - through the checkpoint-rank configuration (serve),
   then the dense-rank (serve-dense: its table check is K1's two kernels),
   the ultra-rank and the bucketed-rank ones, a path each, each building
   the dictionary on the card (no cache holds it), checked against the
   native C++ engine; the seed table and the dictionary built through each
   new provider equal the checkpoint builds element for element;
2. the gather-rate probe (gather_probe.sweep): random 64-byte row gathers
   from a [312500, 16] int32 table, independent and as dependent chains;
3. the find-mems and query-tags commands (cli.main) on the bench index
   written as .ri/.tags files, byte-compared with the port's own host route
   (find-mems: native.find_mems_native + query_tags_native +
   format_mems_native; query-tags: native.count_native + TagArray.query),
   then timed per phase on all reads; find-mems --rank-mode ultra and
   bucketed on the same reads byte-equal to the checkpoint run; then
   print-stats, convert-tags and tags-check on the same files (host work,
   no kernel): print-stats' section sums equal the files' sizes and its
   counts the loaded index's, convert-tags of the tags in the algorithm
   format gives the bench .tags file's bytes and the compact writer's, and
   tags-check reports every file's runs;
4. the tag search (tagquery.tag_upper_bound): the descent of the tag search
   tree that K4 and K6 search with, alone, against torch.searchsorted at
   every run head of the bench index, its neighbours, the ends of the int32
   range and a million random values; count-dense: K7 (count.count) through
   dense records on the query-tags reads, equal to the checkpoint rows';
5. the long-seed dictionary (sparsedict.build_sparse_dict_device, the
   build-sdict command): s=19 at the bench index on the card, through both
   rank providers, equal element for element to the port's host build
   (whose seconds are printed beside the card's); every level's kernel
   against its plain version, through checkpoint rows, dense records, ultra
   rows and bucketed runs; s=31 and min_keep=2 on a small synthetic index
   through all four providers; the command's file loaded back and compared;
6. locate (locate.locate_batch, K8) on the bench index: the intervals of
   the first 65536 MEMs the serving run buffered and 32768 random ones (at
   run heads and mid-run, sizes 1 to 200), capacity 64, against its plain
   version on every lane and against the host model (RIndex.run_of and
   chained RIndex.locate_next) on 4096 of them; the lanes' steps replayed
   on the card give the tail buckets' occupancy and the share of steps
   whose bucket holds at most a line of pairs (here and on serve-2g);
7. the index build from text (bwt.bwt_from_lines_device, the build-bwt and
   build-rindex commands): the BWT of the bench text (8 lines, 20,000,008
   characters) built on the card by prefix doubling, equal element for
   element to native SA-IS (whose seconds are printed beside it); each
   kernel against its plain version at the first round (k = 0 and 1) and a
   plateau round (k = 256) and the finish (on the last round's sort payload,
   checked to be the inverse of its ranks; its two launches by events beside
   torch scatter_ and argsort of the inverse it no longer forms); per round the device time at
   k = 1 and k = 256 beside torch.sort's on the same keys, and each round's
   digit passes (the onesweep sort: an up-front count, then a launch a
   pass); at k = 256 the rerank's two launches by events beside what the
   random 4-byte store they replace costs (torch scatter_ against copy_ of
   the same values); the whole
   build's kernels' device time (events around each launch) and its wall;
   build-bwt's launches a sort and two reranks a round (the rerank's
   wrapper counts each of its two launches) and the finish's two;
   the build-bwt file byte-equal to the native BWT's .rl_bwt, and
   build-rindex's .ri byte-equal to the bench index's;
7b. the graph build (graph_build), the per-chromosome index build and the
   tag merge: a genome of three synthetic chromosomes of 833,334 bp and 8
   haplotypes (synth_multi_component_gbz, 20 Mbp of forward text, 40,000,080
   BWT rows with both strands) saved as GBZ files, then extract-text,
   build-bwt on the card (byte-equal to --engine native), build-rindex,
   build-tags (each verified by tags-check --verify-gbz), merge-tags --engine
   host and --engine device on the components' tags in three formats
   (byte-equal, and equal to the whole genome's direct build), and
   find-mems and query-tags on the merged files against the host route;
   then merge_rows (csrc/merge.cu) against its plain version on the whole
   genome's rows, and the BWT kernels' times on its 40 M-row text;
7c. the mesh path (mesh_path), the multi-card path on this one card: on the
   serving workload the model-sharded engine (find_mems_lockstep: one
   launch of the MEM step fused with its shards' rank partials an
   iteration, the iterations replayed as a CUDA graph) over 2 and 4
   virtual model shards in three forms (checkpoint rows, two-level int64
   rows, the run table), every MemResult field equal to K3's on all 16384
   reads, beside the same iterations launched one by one; the engine and
   3a/3b's entry points in a one-rank NCCL group joined by this process
   (the all_reduce captured in the graph); find-mems --mesh 1x1 over such
   a group, byte-equal to find-mems and the native engine; the graph
   build's 40,000,080 rows merged over 2 and 4 virtual data shards equal
   to merge_rows; then the kernels against their plain versions. NCCL
   between cards is not driven (one card);
7d. the api path (api_path), the package's public functions at the bench's
   size: build_index of the bench text's lines equal to the bench index
   (its suffix array held against the index's samples, tails and BWT);
   to_device (its defaults: the card, dense records; then dense=False,
   bucketed runs; dtype=torch.int64, dense records at int64 positions;
   checkpoint rows of 128 positions; checkpoint rows with mem_only stubs)
   and find_mems on all 16384 reads equal to the native engine, each call
   one K3 launch; load_rindex and load_tags of the bench
   files with and without use_mmap, field for field; the end-to-end demo
   (end_to_end.main) on the card printing the lines it prints on the CPU;
8. serve-2g, an index past 2^31 (k_copy_index: every bench line repeated
   108 times, n = 2,160,000,864; int64 positions over two-level checkpoint
   rows): serve.prepare/run on all 16384 reads (m=13 seed table, s=19
   dictionary built on the card), the int64 tag search, locate on 98304
   intervals, find-mems on all reads and query-tags on 1024 reads on the
   index's .ri/.tags files. Counts, every buffered slot and every tag count
   equal the native engine's on the same index; MEMs equal the 1-copy
   run's with bwt_start and size x108; the commands' stdout equals the host
   route's; locate equals the host model on 4096 lanes; the dictionary
   built on the card equals the host build (int64), itself the 1-copy one
   with intervals x108. Each int64 instantiation is held against its plain
   version and timed, and reported beside the int32 one. Then a path of
   its own, serve-2g-bucketed: prepare/run through int64 bucketed runs
   (the same gates against the native engine) and find-mems --rank-mode
   dense on the index's files, which the reference serves through bucketed
   runs past 2^31: stdout byte-equal to the checkpoint run's. Then
   serve-2g-dense: prepare/run through dense records at int64 positions
   (the table check through the row gather and rank6_dense, the seed table,
   the dictionary, K3 and K4 on them) and the public find_mems(to_device(
   big)) at its defaults on all reads, both equal to the checkpoint run;
   the host's free memory before, and the peak memory and seconds of
   to_device. The int64 dense kernels of that path (rank6_dense, K3 and
   both levels) are held against their plain versions and timed on the
   public route's tables, whose lines (540 MB) do not fit in L2.

The m-mer seed table (mertable.build_mer_table_device: the level kernel of
csrc/mertable.cu, one thread per parent, the last launch two levels deep
but through int64 bucketed runs) is held against the host build at m=8 and against its plain version on the
card at m=14 on the bench index (checkpoint rows, dense records, ultra
rows, bucketed runs) and at m=13 on the k-copy index (int64 two-level rows
and int64 bucketed runs), its launches counted by the wrapper, its device time beside
the least bytes the build must move and beside the other schedule of the
same kernel (the last launch two levels deep, or one through bucketed
runs).

The dense rank6 kernel (csrc/dense_rank.cu, through the lines of
ops/tables.py:derive_dense_lines) is held against its plain version (which
reads pos_to_run) on 32768 and on 4,194,304 positions, and the row gather
on 32768 rows and on every record; K2, K3 (the last 512 reads, and all
16384 by events), K7 and both levels through dense records likewise; and,
on the bench index's dense tables at int64 positions, rank6 on 32768
positions, the gather of every int64 record (as int32 words), K3, K7 and
both levels (the *_dense64 entry points), each beside its int32 form.
The ultra and bucketed rank6 kernels (csrc/rankmodes.cu) are held against
their plain versions on 32768 positions (0, n and n + 1 among them), at
int32 on the bench index and at int64 on the k-copy index, and K2, K3 and
the dictionary's level through their providers likewise. Bucketed runs and
3b's shards read the run index (ops/tables.py:derive_run_index); its entries
of rank6_bucketed (bench index), rank6_bucketed64 (serve-2g-bucketed) and
shard_run_rank6 (each shard of the mesh path's runs) in the kernels line
carry `run_index`: the bucket shift, heads a bucket (mean and most), the
share of that kernel's lookups the entry resolves alone (two dependent
loads), and the bytes of the index and of the run records.

find-mems also runs on all 16384 reads with --batch-size 0 (chunks of 4096
reads) and with one launch over them, byte-equal.

The seed-resolving pass (mems.resolve_seeds) is timed beside the same launch
with the dictionary tier alone, with its entries folded into the table's
first 2^20 rows, and with no entry at all: where its time goes.

The script imports and starts nothing of the JAX package
(pangenome_index_tpu), which need not be importable where it runs: that the
port's commands print the same bytes as the JAX command line's native and
host engines is what tests/test_torch_cli.py holds, on the CPU.

Every kernel is held against its plain PyTorch version on the card at its
path's shapes (every value is an integer: tolerance 0); the kernels'
bit-plane rank table is held against the checkpoint rows it is derived from.
Exits non-zero on any failure, and at once where there is no card.

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with the launch count of the path that runs it, its largest
difference from the plain version, its device time (CUDA-graph replay), the
plain version's time, the least time the card could take for the same bytes
and operations (bound_ms: each input and output once, a table that rows are
gathered from at most once), the time of the longest chain of dependent
gathers where the kernel has one (chain_ms), the larger of the two
(floor_ms), and the time of the one PyTorch call that computes the same
function where there is one (library_ms).
"""

import json
import os
import re
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.abspath(__file__))
TAG_CAP = 8       # tag capacity of the serving path
N_LANES = 32768   # K1/K2 comparison batch
N_RANK6_BIG = 1 << 22  # rank6_dense timed again past the launch floor
N_K3 = 512        # K3 comparison: the first and the last reads
N_RANK = 32768    # rank6 through the bit-plane table against the checkpoint rows
N_SEARCH_RANDOM = 1 << 20  # random values of the tag search check
N_WIDE = 8192     # K6 comparison on wide rows: intervals of 2 to 400 tag runs
CLI_FIND_READS = 2048   # find-mems byte comparison: the first bench reads
CLI_QUERY_ERRORS = 1024  # query-tags: bench reads with errors after the exact ones
PROBE_GROUP_BATCH = 65536  # K5 comparison batch (the probe's grouped sweep)
SMALL_INDEX = (20_000, 4, 2)  # base length, haplotypes, seed: the s=31 build
#: kernel -> (source, the TPU kernel or device program it replaces, the path
#: whose launch count the kernels line reports; None: K2, which no path
#: launches since the seed table is built by its own kernel)
SOURCES = {
    "gather_rows": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:39",
                    "serve-dense"),
    "rank6_dense": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:70",
                    "serve-dense"),
    # K1 again at the shapes where the launch is not all of its time: every
    # record of the bench index (the dense table check's gather), and
    # 4,194,304 positions
    "gather_rows_runs": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:39",
                         "serve-dense", "gather_rows"),
    "rank6_dense_4m": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:70",
                       "serve-dense", "rank6_dense"),
    # K1 at int64 positions, the launches of the path past 2^31 that serves
    # through them: rank6 on 32768 positions of the k-copy index (its lines
    # 540 MB, past L2; the bench index's reading, lines in L2, beside it as
    # bench_index), the gather of every int64 record as int32 words (the
    # bench index has the k-copy index's 2,268,338 runs)
    "rank6_dense_int64": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:70",
                          "serve-2g-dense", "rank6_dense"),
    "gather_rows_runs_int64": ("csrc/dense_rank.cu",
                               "pangenome_index_tpu/ops/pallas_rank.py:39",
                               "serve-2g-dense", "gather_rows"),
    "extend": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31", None),
    "mer_level": ("csrc/mertable.cu", "pangenome_index_tpu/ops/mertable.py:84", "serve"),
    "resolve_seeds": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:87", "serve"),
    "find_mems": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43", "serve"),
    "query_mem_tags": ("csrc/tagquery.cu", "pangenome_index_tpu/ops/tagquery.py:71", "serve"),
    "row_gather": ("csrc/gather_probe.cu", "examples/gather_pipeline_probe.py:77", "probe"),
    "gather_chain": ("csrc/gather_probe.cu", "examples/gather_pipeline_probe.py:56", "probe"),
    "count": ("csrc/count.cu", "pangenome_index_tpu/ops/rank.py:196", "query-tags"),
    "query_tags_batch": ("csrc/tagbatch.cu", "pangenome_index_tpu/ops/tagquery.py:32", "find-mems"),
    "tag_upper_bound": ("csrc/tagsearch.cu", "pangenome_index_tpu/ops/tagquery.py:42", "tag-search"),
    "sdict_level": ("csrc/sparsedict.cu", "pangenome_index_tpu/ops/sparsedict.py:100", "build-sdict"),
    "locate_batch": ("csrc/locate.cu", "pangenome_index_tpu/ops/locate.py:29", "locate"),
    "bwt_sort_pairs": ("csrc/bwt.cu", "pangenome_index_tpu/ops/bwt.py:34", "build-bwt"),
    "bwt_rerank": ("csrc/bwt.cu", "pangenome_index_tpu/ops/bwt.py:27", "build-bwt"),
    "bwt_finish": ("csrc/bwt.cu", "pangenome_index_tpu/ops/bwt.py:56", "build-bwt"),
    "merge_rows": ("csrc/merge.cu", "pangenome_index_tpu/parallel/merge.py:26", "graph-build"),
    # the multi-card path (mesh): a model shard's rank6 partials over
    # checkpoint rows (int32; int64 two-level) and over runs, the lockstep
    # MEM step fused with the partials of its shards (3c, which carries 3a
    # and 3b's bodies), a data shard's merge
    "shard_ckpt_rank6": ("csrc/shard.cu", "pangenome_index_tpu/parallel/sharding.py:120",
                         "mesh"),
    "shard_ckpt_rank6_int64": ("csrc/shard.cu",
                               "pangenome_index_tpu/parallel/sharding.py:120", "mesh",
                               "shard_ckpt_rank6"),
    "shard_run_rank6": ("csrc/shard.cu", "pangenome_index_tpu/parallel/sharding.py:154",
                        "mesh"),
    "mem_step_fused": ("csrc/memstep.cu", "pangenome_index_tpu/parallel/engine.py:82", "mesh"),
    "mem_step_fused_int64": ("csrc/memstep.cu", "pangenome_index_tpu/parallel/engine.py:82",
                             "mesh", "mem_step_fused"),
    "mem_step_fused_runs": ("csrc/memstep.cu", "pangenome_index_tpu/parallel/engine.py:82",
                            "mesh", "mem_step_fused"),
    "merge_rows_shard": ("csrc/merge.cu", "pangenome_index_tpu/parallel/merge.py:26", "mesh"),
    # the int64 instantiations, on the serve-2g path (n >= 2^31; the rank
    # step of the chain kernels is the two-level ops/rank.py:79,98): the
    # fourth field is the wrapper whose launches they are
    "extend_int64": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31", None),
    "mer_level_int64": ("csrc/mertable.cu", "pangenome_index_tpu/ops/mertable.py:84",
                        "serve-2g", "mer_level"),
    "resolve_seeds_int64": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:87",
                            "serve-2g", "resolve_seeds"),
    "find_mems_int64": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43", "serve-2g",
                        "find_mems"),
    "query_mem_tags_int64": ("csrc/tagquery.cu", "pangenome_index_tpu/ops/tagquery.py:71",
                             "serve-2g", "query_mem_tags"),
    "query_tags_batch_int64": ("csrc/tagbatch.cu", "pangenome_index_tpu/ops/tagquery.py:32",
                               "serve-2g", "query_tags_batch"),
    "tag_upper_bound_int64": ("csrc/tagsearch.cu", "pangenome_index_tpu/ops/tagquery.py:42",
                              "serve-2g", "tag_upper_bound"),
    "count_int64": ("csrc/count.cu", "pangenome_index_tpu/ops/rank.py:196", "serve-2g",
                    "count"),
    "sdict_level_int64": ("csrc/sparsedict.cu", "pangenome_index_tpu/ops/sparsedict.py:100",
                          "serve-2g", "sdict_level"),
    "locate_batch_int64": ("csrc/locate.cu", "pangenome_index_tpu/ops/locate.py:29",
                           "serve-2g", "locate_batch"),
    # the dense provider (rank6_pallas's, through the lines) inside the chain
    # kernels, on the dense configuration's serving path; K7 on a path of
    # its own (count through dense tables)
    "extend_dense": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31", None),
    "find_mems_dense": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43", "serve-dense",
                        "find_mems"),
    "count_dense": ("csrc/count.cu", "pangenome_index_tpu/ops/rank.py:196", "count-dense",
                    "count"),
    "sdict_level_dense": ("csrc/sparsedict.cu", "pangenome_index_tpu/ops/sparsedict.py:100",
                          "serve-dense", "sdict_level"),
    "mer_level_dense": ("csrc/mertable.cu", "pangenome_index_tpu/ops/mertable.py:84",
                        "serve-dense", "mer_level"),
    # the dense provider at int64 positions (DenseRank<int64_t>), launched
    # past 2^31 on serve-2g-dense and held there on the public route's
    # tables (to_device of the k-copy index; the bench index's int64 dense
    # tables' reading beside it as bench_index); K7 on a path of its own,
    # on the bench index's int64 dense tables
    "find_mems_dense_int64": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43",
                              "serve-2g-dense", "find_mems"),
    "count_dense_int64": ("csrc/count.cu", "pangenome_index_tpu/ops/rank.py:196",
                          "count-dense-int64", "count"),
    "sdict_level_dense_int64": ("csrc/sparsedict.cu",
                                "pangenome_index_tpu/ops/sparsedict.py:100",
                                "serve-2g-dense", "sdict_level"),
    "mer_level_dense_int64": ("csrc/mertable.cu", "pangenome_index_tpu/ops/mertable.py:84",
                              "serve-2g-dense", "mer_level"),
    # the ultra and bucketed rank providers (the XLA rank6 forms
    # ops/rank.py:165 through rank_table, ops/rank.py:22 + :173 through
    # bucket_lo and cum), alone and inside the chain kernels, each on the
    # serving path of its rank configuration
    "rank6_ultra": ("csrc/rankmodes.cu", "pangenome_index_tpu/ops/rank.py:165",
                    "serve-ultra"),
    "rank6_bucketed": ("csrc/rankmodes.cu", "pangenome_index_tpu/ops/rank.py:22",
                       "serve-bucketed"),
    "rank6_bucketed64": ("csrc/rankmodes.cu", "pangenome_index_tpu/ops/rank.py:22",
                         "serve-2g-bucketed", "rank6_bucketed"),
    "mer_level_ultra": ("csrc/mertable.cu", "pangenome_index_tpu/ops/mertable.py:84",
                        "serve-ultra", "mer_level"),
    "mer_level_bucketed": ("csrc/mertable.cu", "pangenome_index_tpu/ops/mertable.py:84",
                           "serve-bucketed", "mer_level"),
    "mer_level_bucketed64": ("csrc/mertable.cu", "pangenome_index_tpu/ops/mertable.py:84",
                             "serve-2g-bucketed", "mer_level"),
    "extend_ultra": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31", None),
    "extend_bucketed": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31", None),
    "extend_bucketed64": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31", None),
    "find_mems_ultra": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43", "serve-ultra",
                        "find_mems"),
    "find_mems_bucketed": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43",
                           "serve-bucketed", "find_mems"),
    "find_mems_bucketed64": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43",
                             "serve-2g-bucketed", "find_mems"),
    "sdict_level_ultra": ("csrc/sparsedict.cu", "pangenome_index_tpu/ops/sparsedict.py:100",
                          "serve-ultra", "sdict_level"),
    "sdict_level_bucketed": ("csrc/sparsedict.cu",
                             "pangenome_index_tpu/ops/sparsedict.py:100", "serve-bucketed",
                             "sdict_level"),
    "sdict_level_bucketed64": ("csrc/sparsedict.cu",
                               "pangenome_index_tpu/ops/sparsedict.py:100",
                               "serve-2g-bucketed", "sdict_level"),
}
#: published peaks of one H100 SXM: device memory bytes/s, and float32
#: operations/s outside the tensor cores (taken for the kernels' 32-bit
#: integer arithmetic too)
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
#: kernels each path must launch (serve and find-mems: seed table and
#: dictionary not cached; serve through checkpoint rows, serve-dense through
#: dense records, where gather_rows and rank6_dense are the table check)
PATH_KERNELS = {
    "serve": ("mer_level", "resolve_seeds", "find_mems", "query_mem_tags", "sdict_level"),
    "serve-dense": ("gather_rows", "rank6_dense", "mer_level", "resolve_seeds", "find_mems",
                    "query_mem_tags", "sdict_level"),
    # the backward search through dense records (query-tags ranks through
    # checkpoint rows, as the reference does)
    "count-dense": ("count",),
    "count-dense-int64": ("count",),
    "probe": ("row_gather", "gather_chain"),
    "find-mems": ("mer_level", "resolve_seeds", "find_mems", "query_tags_batch",
                  "sdict_level"),
    "query-tags": ("count", "query_tags_batch"),
    "tag-search": ("tag_upper_bound",),
    "build-sdict": ("sdict_level",),
    "locate": ("locate_batch",),
    "build-bwt": ("bwt_sort_pairs", "bwt_rerank", "bwt_finish"),
    # extract-text, build-bwt, build-rindex, build-tags, tags-check,
    # merge-tags (host and device), find-mems and query-tags on the merged
    # files (their caches not built)
    "graph-build": ("bwt_sort_pairs", "bwt_rerank", "bwt_finish", "merge_rows", "mer_level",
                    "resolve_seeds", "find_mems", "query_tags_batch", "sdict_level", "count"),
    # print-stats, convert-tags and tags-check: host work, no kernel
    "formats": (),
    # the public functions: find_mems through both to_device forms (no seed
    # tier, as the JAX package's), the end-to-end demo (K3 and K6)
    "api": ("find_mems", "query_tags_batch"),
    # the model-sharded engine over 2 and 4 shards on one card (checkpoint
    # rows, two-level rows, runs: the fused step), in a one-rank NCCL group
    # with distributed_ckpt_rank6 and distributed_rank6 (3a, 3b), find-mems
    # --mesh 1x1 over such a group (the one-card kernels under it), the
    # cross-card merge
    "mesh": ("shard_ckpt_rank6", "shard_run_rank6", "mem_step_fused", "merge_rows_shard",
             "resolve_seeds", "find_mems", "query_tags_batch"),
    "serve-2g": ("mer_level", "resolve_seeds", "find_mems", "query_mem_tags", "sdict_level",
                 "tag_upper_bound", "query_tags_batch", "count", "locate_batch"),
    # the new rank configurations: the table check (rank6), the seed table,
    # the dictionary and the MEMs through their provider; past 2^31 also
    # find-mems --rank-mode dense, which the reference serves through
    # bucketed runs there
    "serve-ultra": ("rank6_ultra", "mer_level", "resolve_seeds", "find_mems", "query_mem_tags",
                    "sdict_level"),
    "serve-bucketed": ("rank6_bucketed", "mer_level", "resolve_seeds", "find_mems",
                       "query_mem_tags", "sdict_level"),
    "serve-2g-bucketed": ("rank6_bucketed", "mer_level", "resolve_seeds", "find_mems",
                          "query_mem_tags", "sdict_level", "query_tags_batch"),
    # past 2^31 through dense records at int64 positions: prepare/run (the
    # table check: the row gather and rank6_dense), then the public
    # find_mems(to_device(big)) at its defaults
    "serve-2g-dense": ("gather_rows", "rank6_dense", "mer_level", "resolve_seeds", "find_mems",
                       "query_mem_tags", "sdict_level"),
}
#: the rank configurations of the serving path, in the order they are served
RANK_CONFIGS = ("checkpoint", "dense", "ultra", "bucketed")
BWT_CHECKED_ROUNDS = (0, 1, 256)  # rounds whose kernels are held against plain
BWT_TIMED_ROUNDS = (1, 256)       # rounds timed beside torch.sort; 256 is reported
N_LOCATE_MEMS = 65536    # locate: the first buffered MEM intervals of the serving run
N_LOCATE_RANDOM = 32768  # locate: random intervals, half at run heads, half mid-run
LOCATE_CAP = 64          # locate: capacity
N_LOCATE_HOST = 4096     # locate: lanes held against the host model's SA
K_COPIES = 108           # serve-2g: the k-copy index, n = 108 * 20,000,008 >= 2^31
MER_M_2G = 13            # serve-2g: the seed table past 2^31 (int64, as the reference caps it)
N_QT_2G = 1024           # serve-2g: query-tags reads, half exact and half with errors


def k_copy_index(idx, tags, k):
    """The r-index and tag array of the text in which each sequence of
    `idx` is repeated k times in a row (sequence i becomes the k
    consecutive sequences i * k .. i * k + k - 1), made from idx's own
    tables with no BWT build: the serve-2g path's index of n = k * idx.n.

    The copies of a suffix are adjacent in the k-copy suffix order (their
    strings are equal up to the separators, which order by sequence), so
    row p of the 1-copy BWT becomes rows k * p .. k * p + k - 1, all of p's
    symbol: a run keeps its symbol with k times its length, and an
    endmarker (each its own logical run) becomes k runs of length 1. Run
    starts, cum and C scale by k (plus j endmarkers before the j-th copy
    of an endmarker run); the suffix at row k * p + j is copy j of p's, so
    its packed SA value is (seq * k + j) * max_len + off with (seq, off)
    those of p: run heads take copy 0 (copy j for an endmarker run), run
    tails copy k - 1. A tag run keeps its graph position with k times its
    length (TagArray.from_runs splits the long ones, as the reference's
    writers do). tests/test_torch_int64.py holds the result against
    build_rindex of the native BWT of the repeated lines."""
    import numpy as np

    from pangenome_index_tpu_torch.models.rindex import RIndex
    from pangenome_index_tpu_torch.models.tagarray import TagArray

    ml = int(idx.max_len)
    is_end = idx.run_sym == 0
    reps = np.where(is_end, k, 1)
    src = np.repeat(np.arange(idx.n_runs), reps)      # the 1-copy run
    j = np.arange(src.size) - np.repeat(np.cumsum(reps) - reps, reps)
    run_len = np.where(is_end[src], 1, k * idx.run_len[src])
    cum = k * idx.cum[src]
    cum[:, 0] += j
    seq, off = np.divmod(idx.samples[src], ml)
    tail_1 = np.empty(idx.n_runs, np.int64)
    tail_1[idx.last_to_run] = idx.last_sorted
    tseq, toff = np.divmod(tail_1[src], ml)
    tails = (tseq * k + np.where(is_end[src], j, k - 1)) * ml + toff
    order = np.argsort(tails, kind="stable")
    big = RIndex(run_sym=idx.run_sym[src], run_start=k * idx.run_start[src] + j,
                 run_len=run_len, cum=cum, C=k * idx.C, n=k * int(idx.n),
                 n_seq=k * int(idx.n_seq), max_len=ml,
                 samples=(seq * k + j) * ml + off, last_sorted=tails[order],
                 last_to_run=order.astype(np.int64))
    big_tags = None
    if tags is not None:
        big_tags = TagArray.from_runs(tags.pos_enc, tags.run_lengths() * k)
    return big, big_tags


GRAPH = (833_334, 8, 3, 0.002, 17)  # graph build: base length, haplotypes, components, site rate, seed
GRAPH_READS = 16384  # find-mems and query-tags on the merged files


def run_index_work(index, first, shift, heads, pos):
    """Per position of `pos`: whether its bucket entry alone resolves its
    run (two dependent loads), and the 64-byte lines of heads it reads past
    a full entry (0 where it reads none), as csrc/rank.cuh:RunIndex reads
    the run index (ops/tables.py:derive_run_index; buckets of 2^shift
    positions from bucket `first` on, over `heads`)."""
    import torch

    from pangenome_index_tpu_torch.ops import rank
    from pangenome_index_tpu_torch.ops.tables import run_index_fields, run_index_slots

    p = pos.long()
    j0, cnt = run_index_fields(index[((p >> shift) - first).clamp(0, index.shape[0] - 1)])
    cap = run_index_slots(shift)
    j = rank.run_of_index(index, first, shift, heads, pos)
    past = (cnt > cap) & (j - j0 >= cap)
    lines = torch.where(past, (j - j0 - cap) // (64 // heads.element_size()) + 1, 0)
    return ~past, lines


def run_index_stats(index, first, shift, heads, rec, pos):
    """What the kernels line reports of a run index: its shift and buckets,
    the heads a bucket (mean and most), the share of the lookups at `pos`
    that the entry resolves alone, and the bytes of the index and of the
    run records."""
    import torch

    counts = torch.bincount((heads.long() >> shift) - first, minlength=index.shape[0])
    resolved, _ = run_index_work(index, first, shift, heads, pos)
    return {"shift": int(shift), "buckets": index.shape[0],
            "heads_a_bucket_mean": float(counts.double().mean()),
            "heads_a_bucket_max": int(counts.max()),
            "resolved_share": float(resolved.double().mean()) if pos.numel() else None,
            "index_bytes": index.numel() * 4,
            "record_bytes": rec.numel() * rec.element_size()}


def graph_build(env, base_len=GRAPH[0]):
    """The graph-build path through the port's command line: a genome of
    GRAPH's synthetic chromosomes (synth_multi_component_gbz; at the full
    base length 20,000,002 bp of forward text, 48 sequences, 40,000,080 BWT
    rows) saved as the whole GBZ and one a component; extract-text of each
    (the generator's lines, each followed by its reverse complement);
    build-bwt on the card of each text, byte-equal to --engine native's;
    build-rindex of the whole genome; build-tags of each component and of
    the whole genome, each verified by tags-check --verify-gbz; merge-tags
    --engine host and --engine device of the components' tags given in
    three formats (algorithm, compressed sdsl, wrapped compressed
    bytecode), byte-equal, and from row n_seq on the direct build's
    positions; find-mems and query-tags on the merged files equal to the
    host route through the native engine. The path's launches are read
    before its kernels are held against their plain versions: merge_rows on
    the whole genome's rows, the BWT kernels' times on its text. `env`
    holds main()'s helpers; returns the seconds of each command's phases."""
    import numpy as np
    import torch

    from pangenome_index_tpu_torch import reset_launches
    from pangenome_index_tpu_torch.core import merge
    from pangenome_index_tpu_torch.formats import ri, tags as tagfmt
    from pangenome_index_tpu_torch.formats.gbz import load_gbz
    from pangenome_index_tpu_torch.formats.gbz_write import save_gbz
    from pangenome_index_tpu_torch.ops import merge as merge_ops
    from pangenome_index_tpu_torch.utils import synth

    check, log, cmd = env.check, env.log, env.port_cmd
    d = env.work_dir
    comp_dir = os.path.join(d, "comp")
    os.makedirs(comp_dir, exist_ok=True)
    _, n_haps, n_comps, site_rate, seed = GRAPH
    t0 = time.perf_counter()
    whole, subs, comp_lines = synth.synth_multi_component_gbz(
        base_len, n_haps, n_comps=n_comps, site_rate=site_rate, seed=seed)
    names = ["whole"] + [f"c{c}" for c in range(n_comps)]
    path = {(name, ext): os.path.join(d, f"{name}.{ext}") for name in names
            for ext in ("gbz", "txt", "rl_bwt", "native.rl_bwt", "tags")}
    for name, g in zip(names, (whole, *subs)):
        save_gbz(g, path[name, "gbz"])
    del whole, subs
    revcomp = bytes.maketrans(b"ACGT", b"TGCA")
    texts = [b"".join(l + b"\n" + l.translate(revcomp)[::-1] + b"\n" for l in lines)
             for lines in comp_lines]
    texts.insert(0, b"".join(texts))
    log(f"graph build: {n_comps} chromosomes of {base_len} bp, {n_haps} haplotypes, site "
        f"rate {site_rate}: {sum(len(t) for t in texts[1:])} characters of text with both "
        f"strands; generated and saved ({time.perf_counter() - t0:.1f} s)")
    seconds = {}

    def run(label, argv):
        sec = cmd(argv, os.path.join(d, label + ".out"))
        seconds[label] = sec
        return sec

    reset_launches()
    t_path = time.perf_counter()
    for name, text in zip(names, texts):
        run(f"extract-text {name}", ["extract-text", path[name, "gbz"], "-o", path[name, "txt"]])
        with open(path[name, "txt"], "rb") as fh:
            check(fh.read() == text, f"extract-text of {name} differs from the generator's lines")
        run(f"build-bwt {name}", ["build-bwt", path[name, "txt"], path[name, "rl_bwt"]])
        run(f"build-bwt --engine native {name}", ["build-bwt", path[name, "txt"],
                                                  path[name, "native.rl_bwt"], "--engine",
                                                  "native"])
        with open(path[name, "rl_bwt"], "rb") as fa, \
                open(path[name, "native.rl_bwt"], "rb") as fb:
            check(fa.read() == fb.read(), f"build-bwt of {name} on the card differs from "
                  "native SA-IS's")
    whole_ri = os.path.join(d, "whole.ri")
    run("build-rindex whole", ["build-rindex", path["whole", "rl_bwt"], "-o", whole_ri])
    for name in names:
        run(f"build-tags {name}", ["build-tags", path[name, "gbz"], path[name, "rl_bwt"],
                                   path[name, "tags"]])
        run(f"tags-check --verify-gbz {name}", ["tags-check", path[name, "tags"],
                                                "--verify-gbz", path[name, "gbz"],
                                                "--verify-rlbwt", path[name, "rl_bwt"]])
        with open(os.path.join(d, f"tags-check --verify-gbz {name}.out")) as fh:
            check(fh.read().endswith(f"{path[name, 'tags']}: verification OK\n"),
                  f"tags-check --verify-gbz of {name} did not print verification OK")
    # the components' tags in three formats: as built (algorithm), compressed
    # sdsl, wrapped compressed bytecode (convert-tags)
    c_tags = [os.path.join(comp_dir, f"c{c}.tags") for c in range(n_comps)]
    os.replace(path["c0", "tags"], c_tags[0])
    with open(c_tags[1], "wb") as fh:
        fh.write(tagfmt.write_compressed_sdsl(tagfmt.load_tags_file(path["c1", "tags"])))
    for c in range(2, n_comps):
        run(f"convert-tags c{c}", ["convert-tags", path[f"c{c}", "tags"], c_tags[c],
                                   "--no-compat", "--wrapped"])
    merged = {e: os.path.join(d, f"merged_{e}.tags") for e in ("host", "device")}
    for e, out in merged.items():
        run(f"merge-tags --engine {e}", ["merge-tags", path["whole", "gbz"], whole_ri,
                                         comp_dir, out, "--engine", e])
    with open(merged["host"], "rb") as fa, open(merged["device"], "rb") as fb:
        check(fa.read() == fb.read(), "merge-tags --engine device differs from --engine host")
    idx = ri.load_file(whole_ri)
    merged_tags = tagfmt.load_tags_file(merged["device"], fmt="sdsl")
    direct = tagfmt.load_tags_file(path["whole", "tags"])
    per_pos = np.repeat(merged_tags.pos_enc, merged_tags.run_lengths())
    check(not per_pos[: idx.n_seq].any() and np.array_equal(
        per_pos[idx.n_seq:], np.repeat(direct.pos_enc, direct.run_lengths())),
        "the merged tags differ from the whole genome's direct build")
    del per_pos, direct
    log(f"graph build: {len(texts) - 1} texts and the whole genome's extracted, built on the "
        f"card equal to native SA-IS, tags verified against each graph; merge-tags host and "
        f"device byte-equal ({os.path.getsize(merged['device'])} bytes, {merged_tags.n_runs} "
        f"runs over {idx.n} rows) and equal to the direct build from row {idx.n_seq} on")
    # serving on the merged files, against the host route (native engine)
    lines = [l for ls in comp_lines for l in ls]
    reads = synth.synth_reads(lines, GRAPH_READS, env.read_len, error_rate=0.01, seed=1)
    exact = synth.synth_reads(lines, GRAPH_READS, env.read_len, error_rate=0.0, seed=2)
    common = [whole_ri, merged["device"]]
    for label, argv, rs, host in (
            ("find-mems merged", ["find-mems", *common, env.write_reads("graph_reads.txt", reads),
                                  str(env.min_len), str(env.min_occ)], reads,
             env.host_find_mems),
            ("query-tags merged", ["query-tags", *common,
                                   env.write_reads("graph_exact.txt", exact)], exact,
             env.host_query_tags)):
        run(label, [*argv, "--tags-format", "sdsl"])
        host(rs, os.path.join(d, label + ".host"), index=idx, tag_array=merged_tags)
        check(env.without_seconds(os.path.join(d, label + ".out"))
              == env.without_seconds(os.path.join(d, label + ".host")),
              f"{label}: stdout differs from the host route (native engine)")
    path_s = time.perf_counter() - t_path
    env.read_launches("graph-build")
    log(f"find-mems and query-tags on the merged files ({GRAPH_READS} reads each): stdout "
        f"byte-equal to the host route through the native engine; the path's commands "
        f"{path_s:.1f} s")
    for label, sec in seconds.items():
        log(f"  {label}: " + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()))

    # merge_rows on the whole genome's rows, against its plain version
    whole = load_gbz(path["whole", "gbz"])
    comps = merge.node_components(whole)
    comp_tags = {}
    for f in c_tags:
        t = tagfmt.load_tags_file(f)
        comp_tags[comps[int(t.pos_enc[0]) >> 11]] = t
    inputs = [env.T(a) for a in merge.device_merge_inputs(whole, idx, comp_tags)]
    n, t_len, C = inputs[0].numel(), inputs[1].numel(), inputs[2].numel() - 1
    # the design: comp once, a stream value and a tag a row, a look-back
    # word a tile and key value
    env.compare("merge_rows", lambda: merge_ops.merge_rows(*inputs),
                lambda: merge_ops.merge_rows_plain(*inputs),
                nbytes=n * (4 + 8) + t_len * 8 + (C + 1) * 8, ops=n * 4,
                design=n * (4 + 8) + t_len * 8 + 8 * (C + 1) * -(-n // merge_ops.TILE))
    phases, _ = env.launch_ms(lambda: merge_ops.merge_rows(*inputs), "pgt_merge_hist",
                              "pgt_merge_scan", "pgt_merge_place")
    log(f"merge_rows on {n} rows, {C} components: its launches by events, "
        + ", ".join(f"{e[4:]} {ms:.4f} ms ({k:g} a call)" for e, (ms, k) in phases.items())
        + f" {env.card}")
    env.merge_inputs = inputs  # the mesh path's cross-card merge takes these rows
    del inputs
    # the BWT kernels on the whole genome's text (k = 256 and the finish),
    # beside the bench text's rows of the kernels line
    with open(path["whole", "txt"], "rb") as fh:
        big = env.bwt_kernel_ms([l for l in fh.read().split(b"\n") if l])
    log(f"BWT kernels on the whole genome's text ({len(texts[0])} rows), device ms (the "
        f"bench text's, {env.bench_rows} rows, in brackets): "
        + ", ".join(f"{k} {v:.4f} ({env.kernels[k]['ms']:.4f})" for k, v in big.items())
        + f" {env.card}")
    for f in os.listdir(d):
        full = os.path.join(d, f)
        if os.path.isfile(full):
            os.remove(full)
    for f in c_tags:
        os.remove(f)
    return seconds


MESH_SHARDS = (2, 4)   # the mesh path: virtual model shards and data shards on one card
MESH_SUPER_SHIFT = 19  # its two-level form: 2^19-position superblocks (39 at 20 M)
MESH_MID_ITERS = 100   # the MEM step is also checked and timed this many iterations in
#: the mesh path's table forms: checkpoint rows (int32), two-level rows
#: (int64), runs (the run-table form, every other --rank-mode)
MESH_FORMS = {"checkpoint": dict(checkpoint=True),
              "two-level": dict(checkpoint=True, super_shift=MESH_SUPER_SHIFT, dtype="int64"),
              "runs": {}}
#: the fused step's kernels line entries by form
FUSED_NAMES = {"checkpoint": "mem_step_fused", "two-level": "mem_step_fused_int64",
               "runs": "mem_step_fused_runs"}


def mesh_path(env):
    """The multi-card path on one card. NCCL between cards is not driven
    here (one card): the model shards and the data shards are virtual, all
    on this card in this process, where a mesh sums their partials by one
    all_reduce (parallel/sharding.py:virtual_shards, parallel/merge.py:
    merge_virtual_shards), and a real one-rank NCCL group is joined twice:
    by this process (multihost.spawn_group of one rank, as the command
    joins it) and by the command line's --mesh 1x1. Main path (launches
    counted): on the serving bench's 16384 reads (m=14 seed table, s=19
    dictionary, capacity 8) the model-sharded engine (find_mems_lockstep:
    one launch of the step fused with the partials of its shards, an
    iteration; on the card the iterations replayed as a CUDA graph) over 2
    and 4 shards in the checkpoint, two-level and run-table forms, every
    MemResult field equal to K3's on all reads and no 3a or 3b launched; in
    the one-rank NCCL group the engine through make_distributed_mem_step
    over 2 virtual shards in each form, its all_reduce captured in the
    graph, equal to K3's, and distributed_ckpt_rank6 (3a) and
    distributed_rank6 (3b) at the engine's first query positions equal to
    the tables' rank6; find-mems --mesh 1x1 on the bench files byte-equal
    to find-mems and to the native engine; the graph-build path's
    40,000,080 rows merged over 2 and 4 data shards equal to merge_rows.
    Then the engine's wall beside K3's, one call of it timed in parts (the
    setup and first launch, the graph's capture and instantiation, the
    replays' host launches and device time, the reads of the active
    count), and each kernel against its plain version."""
    import numpy as np
    import torch

    from pangenome_index_tpu_torch import KERNELS, reset_launches
    from pangenome_index_tpu_torch.ops import merge as merge_ops
    from pangenome_index_tpu_torch.ops import mems, rank, shard_rank
    from pangenome_index_tpu_torch.mems_probe import MEM_CAP, MER_M, MIN_LEN, MIN_OCC, SDICT_S
    from pangenome_index_tpu_torch.parallel import engine as pengine
    from pangenome_index_tpu_torch.parallel import merge as pmerge
    from pangenome_index_tpu_torch.parallel import multihost, sharding
    from pangenome_index_tpu_torch.serve import prepare

    check, log, card, dev = env.check, env.log, env.card, env.dev
    log("mesh path: one card. The model shards and data shards below are virtual (all on "
        "this card; the step computes every shard's partials in place of NCCL's all_reduce); "
        "a one-rank NCCL group is joined by this process and by find-mems --mesh 1x1. NCCL "
        "traffic between cards is not covered: this machine has one.")
    bt = prepare(env.idx, env.tags, env.codes, env.lens, dev, rank_mode="checkpoint",
                 min_occ=MIN_OCC, mer_m=MER_M, sdict_s=SDICT_S, sdict_path=env.sdict_path)
    tables = {}
    for form, kw in MESH_FORMS.items():
        kw = {k: (getattr(torch, v) if k == "dtype" else v) for k, v in kw.items()}
        # padded to 4 shards, which also divides into 2
        tables[form] = sharding.pad_rindex_tables(env.idx, max(MESH_SHARDS), device=dev, **kw)
    n_reads, read_len = bt.codes.shape

    def seed_kw(pd):
        return {k: (v.to(pd) if k in ("mer_table", "sdict_vals") else v)
                for k, v in bt.seed_kw.items()}

    def k3():
        return mems.find_mems(bt.tables, bt.codes, bt.lengths, MIN_LEN, MIN_OCC,
                              capacity=MEM_CAP, **bt.seed_kw)

    def engine(form, S):
        prov = sharding.virtual_shards(tables[form], S, dev)
        return mems.find_mems_lockstep(
            prov.shards, prov.C, prov.n, bt.codes, bt.lengths, MIN_LEN, MIN_OCC,
            capacity=MEM_CAP, with_stats=True, super_base=prov.super_base,
            super_shift=prov.super_shift, **seed_kw(prov.pos_dtype))

    def step_inputs(form, S):
        """The virtual shards of `form`, the step's arguments after them,
        and a zeroed state."""
        prov = sharding.virtual_shards(tables[form], S, dev)
        pd = prov.pos_dtype
        padded, max_iters = mems._prepare(bt.codes, align=8)
        seeds = mems.resolve_seeds(n_reads, read_len + 1, MIN_OCC, **seed_kw(pd))
        args = (prov.C, prov.n, padded, bt.lengths, seeds, read_len, MIN_LEN, MIN_OCC,
                prov.super_base, prov.super_shift)
        return prov, args, mems.step_state(n_reads, MEM_CAP, pd, dev), max_iters

    def engine_parts(form, S, replays):
        """One engine call timed in parts, its graph wrapped so that the
        capture is timed on the host's clock and each of its `replays`
        replays by CUDA events on the stream (device time) and on the
        host's clock (the launch): seconds of the wall, the setup before
        the capture (the shards' views, seed resolution, state, the first
        launch), the capture
        and instantiation, the replays' host launches, the rest of the loop
        (the host blocked in its reads of the active count, and the
        result), the replays' device time, and the loop's wall."""
        orig, t = mems._graph_of, {"launch": 0.0}
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(replays)]
        used = []

        def timed_graph_of(iterations, d):
            t["capture"] = time.perf_counter()
            replay = orig(iterations, d)
            t["loop"] = time.perf_counter()

            def timed():
                a, b = events[len(used)]
                a.record()
                h = time.perf_counter()
                replay()
                t["launch"] += time.perf_counter() - h
                b.record()
                used.append((a, b))

            return timed

        torch.cuda.synchronize()
        mems._graph_of = timed_graph_of
        try:
            t0 = time.perf_counter()
            engine(form, S)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        finally:
            mems._graph_of = orig
        check(len(used) == replays, f"the engine ({form}, {S}) replayed {len(used)} times, "
              f"not {replays}")
        loop = t1 - t["loop"]
        return dict(wall=t1 - t0, setup=t["capture"] - t0, capture=t["loop"] - t["capture"],
                    launch=t["launch"], wait=loop - t["launch"],
                    device=sum(a.elapsed_time(b) for a, b in used) / 1e3, loop=loop)

    def wall_s(fn, reps=3):
        """The least host seconds of fn() to the card's end, of reps calls
        after one more."""
        fn()
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    def counts():
        return {k: KERNELS[k].launches for k in ("mem_step_fused", "shard_ckpt_rank6",
                                                 "shard_run_rank6")}

    want = k3()  # K3's MemResult on all reads (not counted: it is the reference)

    def same_as_k3(got, what):
        for f, g, w in zip(got._fields, got, want):
            check(torch.equal(g.long(), w.long()), f"{what}: {f} differs from K3's")

    merge_in = env.merge_inputs
    reset_launches()
    iters, per_iter = {}, {}
    for form in tables:
        for S in MESH_SHARDS:
            before = counts()
            got, stats = engine(form, S)
            after = counts()
            iters[form, S] = stats["iters"]
            same_as_k3(got, f"the model-sharded engine ({form}, {S} shards)")
            fused = after["mem_step_fused"] - before["mem_step_fused"]
            check(fused == 1 + stats["iters"] and all(
                after[k] == before[k] for k in ("shard_ckpt_rank6", "shard_run_rank6")),
                f"the engine ({form}, {S} shards) launched {after} from {before}: not one "
                f"fused step an iteration and the first")
            per_iter[form, S] = (fused - 1) / stats["iters"]

    # the one-rank NCCL group, joined in this process: the engine's
    # all_reduce captured in its graph; 3a and 3b through their entry points
    def one_rank(rank_, world):
        mesh = sharding.make_mesh(1, 1, dev)
        step = pengine.make_distributed_mem_step(mesh, capacity=MEM_CAP, mer_m=MER_M,
                                                 sdict_m=SDICT_S)
        out = {}
        for form, t in tables.items():
            virt = sharding.virtual_shards(t, 2, dev)
            placed = sharding.ShardedRank(virt.shards, virt.C, virt.n, mesh, virt.super_base)
            check(mesh.groups.get("model") is not None, "the one-rank mesh has no model group")
            kw = seed_kw(t.pos_dtype)
            seed = (kw["mer_table"], kw["mer_keys"], kw["mer_valid"], kw["sdict_vals"],
                    kw["sdict_idx"])
            res, total = step(placed, bt.codes, bt.lengths, MIN_LEN, MIN_OCC, *seed)
            same_as_k3(res, f"the engine in a one-rank NCCL group ({form}, 2 shards)")
            check(int(total) == int(want.count.sum()), "the one-rank group's total differs")
            # timed calls are not the path's drive: their launches are taken back
            drive = {k: fn.launches for k, fn in KERNELS.items()}
            out[form] = wall_s(lambda: step(placed, bt.codes, bt.lengths, MIN_LEN, MIN_OCC,
                                            *seed))
            for k, v in drive.items():
                KERNELS[k].launches = v
            # 3a / 3b at the engine's first query positions, the whole table
            # one shard of the one-rank model group, against the tables' rank6
            _, args, state, _ = step_inputs(form, 1)
            mems.mem_step_plain(state, None, *args)
            pos = mems.query_positions(state)[1].to(t.pos_dtype)
            if t.ckpt is not None:
                got = sharding.distributed_ckpt_rank6(t.ckpt_planes, pos, mesh,
                                                      t.ckpt_super)
            else:
                got = sharding.distributed_rank6(t.run_start, t.run_sym, t.cum, pos, mesh,
                                                 torch.iinfo(t.pos_dtype).max)
            check(torch.equal(got.long(), rank.rank6(t, pos).long()),
                  f"distributed rank6 in the one-rank NCCL group ({form}) differs from "
                  "the tables' rank6")
        return out

    nccl_s = multihost.spawn_group(one_rank, 1, device="cuda")
    out_mesh = os.path.join(env.cli_dir, "find_mesh.txt")
    sec = env.port_cmd(["find-mems", env.ri_path, env.tags_path, env.fm_reads, str(MIN_LEN),
                        str(MIN_OCC), "--tags-format", "bytecode", "--mesh", "1x1"], out_mesh)
    mesh_out = env.without_seconds(out_mesh)
    want_tags = merge_ops.merge_rows(*merge_in)
    for S in MESH_SHARDS:
        check(torch.equal(pmerge.merge_virtual_shards(*merge_in, S), want_tags),
              f"the cross-card merge over {S} data shards differs from merge_rows")
    # merge_rows above is the reference: its launches are not the path's
    KERNELS["merge_rows"].launches = 0
    env.read_launches("mesh")
    merge_s = {S: wall_s(lambda: pmerge.merge_virtual_shards(*merge_in, S))
               for S in MESH_SHARDS}
    for path in ("find_port.txt", "find_host.txt"):
        check(mesh_out == env.without_seconds(os.path.join(env.cli_dir, path)),
              f"find-mems --mesh 1x1 differs from {path}")
    k3_s = wall_s(k3)
    every = mems.ACTIVE_CHECK_EVERY
    engine_s, parts = {}, {}
    for key in iters:
        engine_s[key] = wall_s(lambda: engine(*key))
        # the call of the least wall of 3, in parts
        parts[key] = min((engine_parts(*key, iters[key] // every) for _ in range(3)),
                         key=lambda p: p["wall"])
    log(f"mesh: the model-sharded engine on all {n_reads} reads equals K3 in every field, "
        f"through its CUDA graph ({every} fused steps a replay, no 3a or 3b launch); wall, "
        f"the least of 3 calls after a warm one, beside PR 15's engine of one launch at a "
        f"time (56.47-81.06 ms over these forms and S, PERF.md) and K3 with resolve_seeds "
        f"({k3_s * 1e3:.2f} ms): "
        + ", ".join(f"{form} S={S} {engine_s[form, S] * 1e3:.2f} ms "
                    f"({engine_s[form, S] / k3_s:.1f}x K3), {n} iterations, {n // every} "
                    f"replays, {per_iter[form, S]:.3f} launches an iteration"
                    for (form, S), n in iters.items())
        + f" {card}")
    for (form, S), p in parts.items():
        ms = {k: v * 1e3 for k, v in p.items()}
        log(f"mesh: the engine ({form}, S={S}) in parts, the call of the least wall of 3: "
            f"wall {ms['wall']:.3f} ms = setup and first launch {ms['setup']:.3f} + capture "
            f"and instantiation {ms['capture']:.3f} + loop {ms['loop']:.3f} (replays' host "
            f"launches {ms['launch']:.3f}, host blocked on the active count and the result "
            f"{ms['wait']:.3f}); the {iters[form, S] // every} replays' device time "
            f"{ms['device']:.3f} ms, the card idle {1 - p['device'] / p['loop']:.1%} of the "
            f"loop {card}")
    log(f"mesh: the engine in a one-rank NCCL group (make_distributed_mem_step, 2 shards, "
        f"its all_reduce captured in the graph) equals K3; wall, the least of 3: "
        + ", ".join(f"{form} {v * 1e3:.2f} ms" for form, v in nccl_s.items())
        + f"; distributed_ckpt_rank6 and distributed_rank6 in that group equal the tables' "
        f"rank6 {card}")
    log(f"mesh: find-mems --mesh 1x1 (one-rank NCCL group) on {env.fm_reads}: stdout "
        f"byte-equal to find-mems and to the native engine; "
        + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()) + f" {card}")
    n_rows = merge_in[0].numel()
    log(f"mesh: the cross-card merge of {n_rows} rows equals merge_rows over "
        + ", ".join(f"{S} data shards ({v * 1e3:.2f} ms wall, the least of 3)"
                    for S, v in merge_s.items()) + f" {card}")

    # each kernel against its plain version, at the main path's shapes: the
    # query positions of the engine's first iteration; the step on that
    # state and, timed, on the state MESH_MID_ITERS iterations in (phases 2
    # and 3, emissions and step-3 entries live)
    def step_bytes(before, after, item, seeded, super_base):
        """Bytes the step's own part of the fused step must move from
        `before` to `after`: every read's phase, x, j, k, kp, s in and out
        and its length; a live read's code, two rank vectors (and their
        superblock rows), steps in and out; the last complete interval
        where it changes; an emission's count in and out, and where it is
        stored its k2, s2 and slot; an entering read's seed row."""
        live = (before.phase >= 1) & (before.phase <= 3)
        emitted = after.cnt != before.cnt
        bint2 = live & ((after.k2 != before.k2) | (after.kp2 != before.kp2)
                        | (after.s2 != before.s2))
        entering = (((after.x != before.x) | emitted | (before.phase == 0))
                    & (after.phase >= 1) & (after.phase <= 3))
        stored = emitted & (before.cnt < MEM_CAP)
        n_live, n_bint2, n_emit, n_enter, n_stored = (
            int(v.sum()) for v in (live, bint2, emitted, entering, stored))
        return (n_reads * (2 * (12 + 3 * item) + 4)
                + n_live * (1 + 12 * item + 8)
                + (0 if super_base is None else env.gathered(n_live * 2 * 48, super_base))
                + n_bint2 * 3 * item + n_emit * 8 + n_stored * (4 * item + 4)
                + (n_enter * 4 * item if seeded else 0))

    def owned_reads(sh, pos, item):
        """(positions owned, bytes, lines) of a run shard's partials at pos:
        per owned position its bucket entry and its run's record, each
        distinct one once, and the lines of heads read past full entries
        (the longest position's count: `lines`)."""
        mine = pos[(pos.long() >= sh.lo) & (pos.long() < sh.upper)]
        if not mine.numel():
            return mine, 0, 0
        _, lines = run_index_work(sh.index, sh.first_bucket, sh.shift, sh.run_start, mine)
        j = rank.run_of_index(sh.index, sh.first_bucket, sh.shift, sh.run_start, mine)
        buckets = int(torch.unique(mine.long() >> sh.shift).numel())
        runs = int(torch.unique(j).numel())
        return (mine, buckets * 16 + runs * 8 * item
                + env.gathered(int(lines.sum()) * 64, sh.run_start), int(lines.max()))

    def partial_reads(shards, pos, item):
        """(bytes, operations, dependent loads) of the shards' partials at
        pos: each owned checkpoint row once, or per run shard the entries
        and records of the positions it owns, each once, and the lines of
        heads past full entries; the chain is one row, or an entry, its
        lines and a record."""
        if isinstance(shards[0], shard_rank.CkptShard):
            rows = int(torch.unique(pos.long() >> 6).numel())
            planes = sum(sh.planes.numel() * 4 for sh in shards)
            return min(rows * 64, planes), pos.numel() * 6 * 12, 1
        nbytes = ops = far = 0
        for sh in shards:
            mine, b, lines = owned_reads(sh, pos, item)
            nbytes += b
            ops += mine.numel() * 30
            far = max(far, lines)
        return nbytes, ops, far + 2

    for form, name in (("checkpoint", "shard_ckpt_rank6"),
                       ("two-level", "shard_ckpt_rank6_int64"), ("runs", "shard_run_rank6")):
        prov, args, state, _ = step_inputs(form, 2)
        pd = prov.pos_dtype
        # the first launch: the entry into the first iteration, then every
        # shard's partials at its query positions (their sum: the rank6)
        ranks = torch.zeros((2 * n_reads, 6), dtype=pd, device=dev)
        mems.mem_step_fused(state, ranks, prov.shards, *args, apply=False)
        pos = mems.query_positions(state)[1].to(pd)
        item = torch.empty(0, dtype=pd).element_size()
        sh = prov.shards[0]
        io = pos.numel() * (item + 6 * item)  # the positions in, the partials out
        if form != "runs":
            # the rows of the positions this shard owns, each once
            local = (pos.long() >> 6) - sh.row0
            owned = local[(local >= 0) & (local < sh.planes.shape[0])]
            rows = int(torch.unique(owned).numel())
            env.compare(name, lambda: sh.rank6(pos),
                        lambda: shard_rank.shard_ckpt_rank6_plain(sh.planes, sh.row0, pos),
                        nbytes=io + rows * 64, ops=pos.numel() * 6 * 12, chain=1)
            log(f"{name}: {owned.numel()} of {pos.numel()} positions owned by shard 0 of 2, "
                f"{rows} distinct rows")
        else:
            mine, p_bytes, lines = owned_reads(sh, pos, item)
            env.compare(name, lambda: sh.rank6(pos),
                        lambda: shard_rank.shard_run_rank6_plain(sh, pos),
                        nbytes=io + p_bytes, ops=mine.numel() * 30, chain=lines + 2,
                        library=lambda: torch.searchsorted(sh.run_start, pos, right=True))
            env.kernels[name]["run_index"] = [
                run_index_stats(s_.index, s_.first_bucket, s_.shift, s_.run_start, s_.rec,
                                pos[(pos.long() >= s_.lo) & (pos.long() < s_.upper)])
                for s_ in prov.shards]
            log(f"{name}: {mine.numel()} of {pos.numel()} positions owned by shard 0 of 2 "
                f"(the others cost no load), {p_bytes} bytes of entries, records and "
                f"heads; each shard's run index: {env.kernels[name]['run_index']}")
        # the fused step at the first iteration and MESH_MID_ITERS in
        first = (mems.StepState(*(f.clone() for f in state)), ranks.clone())
        mid = (mems.StepState(*(f.clone() for f in state)), ranks.clone())
        for _ in range(MESH_MID_ITERS):
            mems.mem_step_fused(*mid, prov.shards, *args)
        seeded = args[4] is not None
        for at, (st, st_ranks), record in (("the first iteration", first, False),
                                           (f"iteration {MESH_MID_ITERS}", mid, True)):
            after = mems.StepState(*(f.clone() for f in st))
            mems.mem_step_plain(after, st_ranks, *args)
            nbytes = step_bytes(st, after, item, seeded, prov.super_base)
            # then the rows of the new positions read and the ranks [2B, 6]
            # written
            live, new_pos = mems.query_positions(after)
            new_pos = new_pos[torch.cat((live, live))].to(pd)
            p_bytes, p_ops, p_chain = partial_reads(prov.shards, new_pos, item)
            f_bytes = nbytes + 2 * n_reads * 6 * item + p_bytes
            fst_k, fst_p = (mems.StepState(*(f.clone() for f in st)) for _ in range(2))
            r_k, r_p = st_ranks.clone(), st_ranks.clone()
            env.compare(FUSED_NAMES[form],
                        lambda: (mems.mem_step_fused(fst_k, r_k, prov.shards, *args),
                                 *fst_k, r_k)[1:],
                        lambda: (mems.mem_step_fused_plain(fst_p, r_p, prov.shards, *args),
                                 *fst_p, r_p)[1:],
                        record=record, nbytes=f_bytes, ops=n_reads * 120 + p_ops,
                        chain=1 + p_chain)
            phases = torch.bincount(st.phase.long(), minlength=6).tolist()
            log(f"{FUSED_NAMES[form]} at {at}: reads by phase {phases}, "
                f"{int((after.cnt != st.cnt).sum())} emissions in the step, {nbytes} bytes "
                f"for the step's own part, {f_bytes} in all ({new_pos.numel()} positions' "
                f"partials, {p_bytes} bytes of rows or runs)")
    comp, stream, offsets = merge_in
    half = -(-comp.numel() // 2)
    first = comp[:half].contiguous()
    second = comp[half:].contiguous()
    n2, C = second.numel(), offsets.numel() - 1
    base = torch.bincount(first.long()[first >= 0], minlength=C)[:C]  # the first shard's
    # the design: comp twice (the counts, the placement), a stream value and
    # a tag a row, a look-back word a tile and key value
    env.compare("merge_rows_shard",
                lambda: merge_ops.merge_rows_shard(second, stream, offsets, lambda c: base),
                lambda: merge_ops.merge_rows_shard_plain(second, stream, offsets,
                                                         lambda c: base),
                nbytes=n2 * (4 + 8 + 8) + (C + 1) * 16, ops=n2 * 6,
                design=n2 * (4 + 4 + 8 + 8) + 8 * (C + 1) * -(-n2 // merge_ops.TILE))
    phases, _ = env.launch_ms(
        lambda: merge_ops.merge_rows_shard(second, stream, offsets, lambda c: base),
        "pgt_merge_hist", "pgt_merge_scan", "pgt_merge_place")
    log(f"merge_rows_shard on {n2} rows, {C} components: its launches by events, "
        + ", ".join(f"{e[4:]} {ms:.4f} ms ({k:g} a call)" for e, (ms, k) in phases.items())
        + f" {env.card}")
    for path in ("find_mesh.txt", "find_mesh.txt.err"):
        os.remove(os.path.join(env.cli_dir, path))


#: the index fields build_index must give as the bench index holds them
#: (the bench cache keeps no suffix array: that is checked on its own)
API_INDEX_FIELDS = ("run_sym", "run_start", "run_len", "cum", "C", "n", "n_seq", "max_len",
                    "samples", "last_sorted", "last_to_run")
#: the table forms of the public to_device: its default, dense=False, dense
#: records at int64 positions (the form past 2^31), checkpoint rows of 128
#: positions and checkpoint rows with mem_only stubs (the JAX arguments);
#: "int64" stands for torch.int64
API_FORMS = (("dense records", {}), ("bucketed runs", {"dense": False}),
             ("dense records at int64", {"dtype": "int64"}),
             ("checkpoint rows of 128", {"checkpoint": True, "ckpt_block": 128}),
             ("checkpoint rows, mem_only", {"checkpoint": True, "mem_only": True}))


def api_path(env):
    """The package's public functions at the bench's size, as a library user
    calls them: build_index of the bench text's lines (the native SA-IS
    build) equal to the bench index, which bench_workload builds from the
    same lines by the same native route but caches without its suffix
    array; the suffix array build_index keeps is held against the bench
    index's samples and tails and against its BWT (each row's character is
    the one before its suffix). to_device (cuda: dense records, then
    dense=False: bucketed runs) and find_mems on all 16384 reads, every
    count and buffered (start, end, bwt_start, size) equal to the native
    engine's; the counts of the path show that each find_mems call was one
    K3 launch (the public find_mems, as the JAX package's, passes no seed
    tier: resolve_seeds is not launched). load_rindex and load_tags of the
    bench files with and without use_mmap, every field equal. The
    end-to-end demo on the card, its lines equal to those on the CPU (K3
    and K6 on the card). Then K3 alone by events on the same tables and
    reads, beside the API's wall. `env` holds main()'s helpers and the
    bench workload; returns the seconds of each step."""
    import numpy as np
    import torch

    import pangenome_index_tpu_torch as port
    from pangenome_index_tpu_torch import end_to_end, native
    from pangenome_index_tpu_torch.ops import mems
    from pangenome_index_tpu_torch.utils.alphabet import CODE_TO_BYTE

    check, log, card, idx = env.check, env.log, env.card, env.idx
    seconds = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = time.perf_counter() - t0
        return out

    def same_fields(got, expect, fields, what, dtypes=True):
        for f in fields:
            g, e = getattr(got, f), getattr(expect, f)
            ok = np.array_equal(g, e) and (
                not dtypes or np.asarray(g).dtype == np.asarray(e).dtype)
            check(ok, f"{what}: field {f} differs")

    built = timed("build_index", lambda: port.build_index(env.lines))
    same_fields(built, idx, API_INDEX_FIELDS, "build_index against the bench index")
    n, max_len = built.n, built.max_len
    check(built.sa_seq.shape == built.sa_pos.shape == (n,), "build_index: suffix array shape")
    check(np.array_equal(built.seq_lengths, [len(l) + 1 for l in env.lines]),
          "build_index: sequence lengths")
    packed = built.sa_seq.astype(np.int64) * max_len + built.sa_pos
    check(np.array_equal(packed[idx.run_start], idx.samples),
          "build_index: suffix array at the run heads differs from the bench samples")
    check(np.array_equal(np.sort(packed[idx.run_start + idx.run_len - 1]), idx.last_sorted),
          "build_index: suffix array at the run tails differs from the bench tails")
    del packed
    text = np.frombuffer(b"".join(l + b"\n" for l in env.lines), np.uint8)
    starts = np.concatenate(([0], np.cumsum(built.seq_lengths[:-1])))
    row = starts[built.sa_seq] + built.sa_pos
    before = np.where(built.sa_pos > 0, text[np.maximum(row - 1, 0)], ord("\n"))
    check(np.array_equal(before, np.repeat(CODE_TO_BYTE[idx.run_sym], idx.run_len)),
          "build_index: the suffix array does not give the bench index's BWT")
    del text, starts, row, before
    log(f"api: build_index of {len(env.lines)} lines (n={n}): every index field equal "
        f"to the bench index's, the suffix array gives its samples, tails and BWT; "
        f"{seconds['build_index']:.4f} s (native SA-IS, RLE, the index from the suffix "
        f"array, on {os.cpu_count()} cores) {card}")

    s, e, b, z, cnt = timed("native find_mems", lambda: native.find_mems_native(
        idx, env.codes, env.lens, env.min_len, env.min_occ, capacity=env.mem_cap,
        n_threads=0))
    eff = np.minimum(cnt, env.mem_cap)
    expect = [list(zip(s[i, :k].tolist(), e[i, :k].tolist(), b[i, :k].tolist(),
                       z[i, :k].tolist())) for i, k in enumerate(eff.tolist())]
    port.reset_launches()
    tables = {}
    for form, kw in API_FORMS:
        kw = {k: (torch.int64 if v == "int64" else v) for k, v in kw.items()}
        tables[form] = t = timed(f"to_device ({form})", lambda: port.to_device(built, **kw))
        check(t.run_start.device == env.dev, f"to_device ({form}) is not on {env.dev}")
        check((t.rec is not None) == (form != "bucketed runs")
              and (t.bucket_lo is not None) == (form == "bucketed runs")
              and (t.ckpt is not None) == ("checkpoint" in kw)
              and t.pos_dtype == kw.get("dtype", torch.int32),
              f"to_device ({form}) gave other rank tables")
        if "ckpt_block" in kw:
            check(t.ckpt.shape[1] == 24 and t.ckpt_planes.shape[1] == 16,
                  "to_device (checkpoint rows of 128): rows not 24 words, or planes not 16")
        if kw.get("mem_only"):
            check(t.run_start.shape[0] == t.last_sorted.shape[0] == 1,
                  "to_device (mem_only): the per-run tables are not one-row stubs")
        k3_before = port.KERNELS["find_mems"].launches
        got = timed(f"find_mems ({form})", lambda: port.find_mems(
            t, env.reads, env.min_len, env.min_occ, capacity=env.mem_cap))
        check(port.KERNELS["find_mems"].launches == k3_before + 1,
              f"find_mems through {form} was not one K3 launch")
        check(got == expect, f"find_mems through {form} differs from the native engine")
    log(f"api: find_mems on all {len(env.reads)} reads through "
        + ", ".join(form for form, _ in API_FORMS) + f": {int(cnt.sum())} MEMs, every "
        f"count and buffered slot equal to the native engine's (and so to the int32 dense "
        f"call's)")
    # what mem_only leaves off the card (the tables build-sdict asks for)
    full = port.to_device(built, checkpoint=True, dense=False)
    lean = port.to_device(built, checkpoint=True, dense=False, mem_only=True)
    log(f"api: checkpoint tables on the card {table_bytes(full)} bytes, with mem_only "
        f"{table_bytes(lean)} bytes (the per-run and locate tables as one-row stubs: "
        f"{table_bytes(full) - table_bytes(lean)} bytes fewer) on the bench index")
    del full, lean
    demo = timed(f"end_to_end ({env.dev})", lambda: end_to_end.main(device=env.dev))
    env.read_launches("api")
    got = env.launches["api"]
    check(got["find_mems"] == len(API_FORMS) + 1,
          "the api path's find_mems calls were not one K3 launch each")
    check(got["resolve_seeds"] == 0, "the public find_mems resolved seed tiers")
    check(demo == timed("end_to_end (cpu)", lambda: end_to_end.main(device="cpu")),
          "the demo's lines on the card differ from those on the CPU")
    log(f"api: the end-to-end demo on the card prints the lines it prints on the CPU "
        f"({len(demo)} lines)")

    for path, load, fields in (
            (env.ri_path, port.load_rindex, API_INDEX_FIELDS),
            (env.tags_path, port.load_tags, ("pos_enc", "bwt_start", "total"))):
        name = os.path.basename(path)
        read = timed(f"load {name}", lambda: load(path))
        mapped = timed(f"load {name} (use_mmap)", lambda: load(path, use_mmap=True))
        same_fields(mapped, read, fields, f"{name} loaded through the mapping")
        same_fields(read, idx if load is port.load_rindex else env.tags, fields,
                    f"{name} against the workload's", dtypes=False)
    log(f"api: load_rindex and load_tags of the bench files with and without use_mmap: "
        f"every field equal")

    # K3 alone (events around its launch) on the API's tables and reads, as
    # the public find_mems launches it: no seed tier
    codes_t = torch.from_numpy(env.codes).to(env.dev)
    lens_t = torch.from_numpy(env.lens).to(env.dev)
    for label, sec in seconds.items():
        log(f"api: {label} {sec:.4f} s {card}")
    for form, t in tables.items():
        ms = env.time_ms(lambda: mems.find_mems(t, codes_t, lens_t, env.min_len,
                                                env.min_occ, capacity=env.mem_cap), 5)
        log(f"api: K3 alone through {form}, no seed tier: {ms:.4f} ms (device, events), "
            f"beside the API's find_mems wall {seconds[f'find_mems ({form})']:.4f} s {card}")
    return seconds


def table_bytes_of(x):
    return x.numel() * x.element_size()


def host_memory():
    """The host's memory as free -g shows it (total, used, free, available
    GiB, from /proc/meminfo)."""
    info = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) * 1024
    gib = {k: info.get(k, 0) / 2**30 for k in ("MemTotal", "MemFree", "MemAvailable")}
    return (f"total {gib['MemTotal']:.1f} GiB, free {gib['MemFree']:.1f} GiB, available "
            f"{gib['MemAvailable']:.1f} GiB")


def rss_bytes():
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class PeakRss:
    """This process's largest resident memory (bytes) while the block runs,
    sampled every 5 ms; `start` the resident memory before it."""

    def __enter__(self):
        import threading

        self.start = self.peak = rss_bytes()
        self._stop = threading.Event()

        def watch():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, rss_bytes())

        self._watch = threading.Thread(target=watch, daemon=True)
        self._watch.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._watch.join()
        self.peak = max(self.peak, rss_bytes())


def table_bytes(t):
    """Bytes of every tensor of tables t (what they hold on their device)."""
    return sum(table_bytes_of(v) for v in vars(t).values() if hasattr(v, "element_size"))


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    # the run drives one card: show the process only the first visible one,
    # so that torch.cuda.device_count() in the last line counts what was used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None else visible.split(",")[0]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import pangenome_index_tpu_torch as port
    from pangenome_index_tpu_torch import _build, gather_probe, native
    from pangenome_index_tpu_torch import cli as port_cli
    from pangenome_index_tpu_torch.formats import ri, rlbwt, tags as tagfmt
    from pangenome_index_tpu_torch.ops import (bwt, count, dense_rank, fmd,
                                               gather_probe as probe_ops, locate,
                                               mems, mertable, rank, sparsedict,
                                               tagquery)
    from pangenome_index_tpu_torch.mems_probe import (
        BASE_LEN, MEM_CAP, MER_M, MIN_LEN, MIN_OCC, N_HAPS, N_READS, READ_LEN,
        SDICT_S, TAIL_KERNEL, bench_workload, launch_ms, trace_head, trace_tail)
    from pangenome_index_tpu_torch.ops.tables import (DENSE_CHUNK_LINES, derive_dense_lines,
                                                      rindex_to_device, tags_to_device,
                                                      tail_bucket)
    from pangenome_index_tpu_torch import spans
    from pangenome_index_tpu_torch.serve import prepare, run
    from pangenome_index_tpu_torch.utils import synth

    t_start = time.perf_counter()

    def served(batch):
        """run on the batch, then once more under spans.recording: (the first
        call's result, the recorded call's device milliseconds of mems.find
        and tags.k4, by the spans' events)."""
        kw = dict(min_len=MIN_LEN, min_occ=MIN_OCC, capacity=MEM_CAP, tag_capacity=TAG_CAP)
        res = run(batch, **kw)
        with spans.recording(batch.codes.device) as rec:
            run(batch, **kw)
        return res, {s.name: (s.device[1] - s.device[0]) * 1e-6 for s in rec.spans
                     if s.name in ("mems.find", "tags.k4")}

    def phase(name):
        """Mark where a phase starts, in seconds since the run began."""
        log(f"[{time.perf_counter() - t_start:.1f} s] {name}")

    dev = torch.device("cuda", 0)
    smi = gather_probe.card_name(dev)
    log(smi)
    card = f"[{smi}]"

    # --- 1. build the kernels -------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    native.get_lib()
    log(f"kernel build (nvcc) and native engine build (g++): "
        f"{time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in _build.build_log().splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:  # the mangled kernel name, its instantiation included
            entry = found.group(1)
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {entry}: " + line.split("ptxas info    :")[-1].strip())

    # --- workload (host; the index is cached under .bench_cache/) --------
    t0 = time.perf_counter()
    cache = os.path.join(REPO, ".bench_cache")
    idx, lines, reads, codes, lens, tags, stem = bench_workload(cache)
    log(f"index: n={idx.n} runs={idx.n_runs} tag runs={tags.n_runs} "
        f"({time.perf_counter() - t0:.1f} s)")
    # the index as files for the command line; the serving phase's
    # dictionary cache is the one find-mems reads beside the .ri
    ri_path, tags_path = stem + ".ri", stem + ".tags"
    if not (os.path.exists(ri_path) and os.path.exists(tags_path)):
        t0 = time.perf_counter()
        for path, data in ((ri_path, ri.serialize_encoded(idx)),
                           (tags_path, tagfmt.write_compressed_bytecode(tags))):
            with open(path + ".tmp", "wb") as fh:
                fh.write(data)
            os.replace(path + ".tmp", path)
        log(f"wrote {ri_path} and {tags_path} ({time.perf_counter() - t0:.1f} s)")

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def max_abs_err(got, expect):
        got = got if isinstance(got, tuple) else (got,)
        expect = expect if isinstance(expect, tuple) else (expect,)
        check(len(got) == len(expect), "output arity")
        err = 0
        for g, e in zip(got, expect):
            check(g.shape == e.shape, f"shape {tuple(g.shape)} vs {tuple(e.shape)}")
            err = max(err, int((g.long() - e.long()).abs().max()) if g.numel() else 0)
        return err

    def gathered(nbytes, *tables):
        """Bytes that row reads of `nbytes` in all from `tables` must move:
        no table more than once."""
        return min(nbytes, sum(t.numel() * t.element_size() for t in tables))

    def rank_reads(t, pos):
        """(bytes, chain) of rank6 at `pos` through t's rank provider: the
        bytes the function must read, no table more than once (a checkpoint
        row 64, an ultra row 32; a bucketed query, as the JAX package's
        run_of and rank6 read it, its bucket_lo entry, the 64-byte lines of
        heads from there to its run and the run's start, symbol and counts
        at their widths), and the longest chain of dependent loads of the
        design (1; bucketed: the run index's entry, the lines of heads it
        reads past a full entry, the record), as this run's positions need
        them."""
        n = pos.numel()
        if t.ckpt is not None:
            return gathered(n * 64, t.ckpt_planes), 1
        if t.rank_table is not None:
            return gathered(n * 32, t.rank_table), 1
        if t.rec is not None:  # a run id and a record of 8 positions
            item = t.rec.element_size()
            return gathered(n * item, t.pos_to_run) + gathered(n * 8 * item, t.rec), 2
        item = t.run_start.element_size()
        b = (pos.long() >> 6).clamp(0, t.bucket_lo.shape[0] - 1)
        lines = (rank.run_of(t, pos) - t.bucket_lo[b].long()) // (64 // item) + 1
        _, past = run_index_work(t.run_index, 0, t.run_shift, t.run_start, pos)
        return (gathered(n * item, t.bucket_lo)
                + gathered(int(lines.sum()) * 64 + n * item, t.run_start)
                + gathered(n, t.run_sym) + gathered(n * 6 * item, t.cum),
                2 + int(past.max()))

    def step_reads(t):
        """(bytes, dependent loads) of one extension step's rank reads
        through t's provider, where the positions are not kept: two
        checkpoint rows, two ultra rows, two dense records with their run
        ids, or two bucketed queries, each (the function's own, as rank_reads
        counts it) a bucket_lo entry, a line of heads and the run's start,
        symbol and counts, where the design loads an entry, then a record."""
        item = t.C.element_size()
        if t.ckpt is not None:
            return 128, 1
        if t.rank_table is not None:
            return 64, 1
        if t.rec is not None:  # a run id, then a record of 8 positions, at each end
            return 2 * 9 * item, 2
        return 2 * (item + 64 + 7 * item + 1), 2

    def rank_tables(t):
        """The tables t's rank function reads (bucketed: the JAX package's
        bucket_lo and the runs' start, symbol and counts, its own data,
        where the design reads the run index and records)."""
        if t.ckpt is not None:
            return (t.ckpt_planes,)
        if t.rank_table is not None:
            return (t.rank_table,)
        if t.rec is not None:
            return (t.pos_to_run, t.rec)
        return (t.bucket_lo, t.run_start, t.run_sym, t.cum)

    def locate_work(t, l_start, l_size):
        """What locate (K8) must do on these intervals, and what its design
        does: a dict of the bound's bytes and operations and its chain (the
        function's own: the intervals and outputs once; per lane its run's
        head and sample, per locate_next step the predecessor tail's value,
        run and next sample, each table gathered at most once; the chain the
        longest lane's steps + 1 dependent gathers), the design's bytes
        (per lane a line a level of the run tree, its head and sample; per
        step the bucket's line and the lines of its pairs) and chain (the
        run tree's lines, head and sample, then two loads a step), the
        steps (mean and longest a lane), the bucket occupancy (mean and
        largest over all buckets) and the share of steps whose bucket holds
        at most a line of pairs (two dependent loads), from the lanes
        replayed on the card step by step."""
        item = t.pos_dtype.itemsize
        B = len(l_start)
        st, sz = T(l_start).to(t.pos_dtype), T(l_size).to(t.pos_dtype)
        j = torch.searchsorted(t.run_start, st, right=True) - 1
        emit = sz.long().clamp(0, LOCATE_CAP)
        steps = torch.where(emit > 0, (st - t.run_start[j]).long().clamp(min=0) + emit - 1, 0)
        pair, line = 2 * item, 64 // (2 * item)
        r = t.tail_pairs.shape[0]
        cur, left = t.samples[j], steps
        fits = pair_lines = torch.zeros((), dtype=torch.int64, device=dev)
        while True:
            go = left > 0
            cur, left = cur[go], left[go]
            if not cur.numel():
                break
            lo, m = tail_bucket(t, cur)
            one = m <= line
            first = torch.where(lo > 0, lo - 1, r - 1) * pair // 64
            span = torch.where(one, (lo - 1 + m).clamp(min=0) * pair // 64 - first + 1,
                               torch.log2(m.clamp(min=1).double()).long() + 2)
            fits = fits + one.sum()
            pair_lines = pair_lines + span.sum()
            cur, left = rank.locate_next(t, cur), left - 1
        n_steps, longest = int(steps.sum()), int(steps.max())
        run_lines = len(t.run_tree_levels)
        io = B * (2 * item + LOCATE_CAP * item + 5)
        sizes = (t.tail_lo[1:] - t.tail_lo[:-1]).double()
        return dict(
            nbytes=io + gathered(B * item, t.run_start)
            + gathered((B + n_steps) * item, t.samples)
            + gathered(n_steps * item, t.last_sorted) + gathered(n_steps * item, t.last_to_run),
            ops=(B + n_steps) * 4, chain=longest + 1,
            design=io + B * (run_lines * 64 + 2 * item) + 64 * (n_steps + int(pair_lines)),
            design_chain=run_lines + 2 + 2 * longest, mean_steps=n_steps / B,
            longest=longest, occupancy=(float(sizes.mean()), int(sizes.max())),
            fits=int(fits) / max(n_steps, 1), line=line)

    def log_locate(label, w):
        log(f"{label}: locate_next steps a lane: mean {w['mean_steps']:.2f}, longest "
            f"{w['longest']}; tail buckets hold {w['occupancy'][0]:.4f} tails on average, "
            f"{w['occupancy'][1]} at most; {w['fits']:.6f} of the steps meet a bucket of "
            f"at most {w['line']} tails (two dependent loads); the design's chain "
            f"{w['design_chain']} loads")

    kernels = {}

    def compare(name, kernel, plain, plain_reps=3, record=True, nbytes=0, ops=0,
                chain=None, library=None, design=None):
        """Hold kernel() against plain(); with record, time both (the kernel's
        device time by CUDA-graph replay, the plain version by events around
        eager calls) and the one PyTorch call `library` that computes the
        same function, and work out the bound: `nbytes` moved at the card's
        memory rate or `ops` operations at its peak rate, whichever takes
        longer. `chain`: the steps of the kernel's longest chain of dependent
        gathers, timed at the end at this run's gather latency. `design`:
        the bytes the kernel's own design moves, logged beside the bound."""
        err = max_abs_err(kernel(), plain())
        torch.cuda.synchronize()
        check(err == 0, f"{name}: kernel differs from its plain version by {err}")
        if not record:
            log(f"{name}: identical to its plain version")
            return
        ms, plain_ms = gather_probe.time_ms(kernel), time_ms(plain, plain_reps)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        kernels[name] = dict(
            name=name, route="cuda",
            source="pangenome_index_tpu_torch/" + SOURCES[name][0],
            replaces=SOURCES[name][1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if library is None else gather_probe.time_ms(library),
            chain_steps=chain)
        k = kernels[name]
        log(f"{name}: identical to its plain version; {ms:.4f} ms (device) vs "
            f"plain {plain_ms:.4f} ms, bound {k['bound_ms']:.5f} ms by "
            f"{k['bound_by']} ({nbytes} bytes, {ops} operations)"
            + ("" if library is None else f", library call {k['library_ms']:.4f} ms")
            + ("" if design is None else f"; the design's own bytes {design} "
               f"({design / PEAK_BYTES_S * 1e3:.5f} ms)") + f" {card}")

    launches = {}

    def read_launches(path):
        launches[path] = {name: fn.launches for name, fn in port.KERNELS.items()}
        log(f"launches on the {path} path: {launches[path]}")
        for name in PATH_KERNELS[path]:
            check(launches[path][name] > 0, f"{name} was not launched on the {path} path")

    def on_the_k_copy_index(name, hold):
        """Record kernels[name] again through hold(), on the k-copy index;
        the bench index's reading of it stays beside it as bench_index."""
        first = kernels.pop(name)
        hold()
        kernels[name]["bench_index"] = {k: first[k] for k in (
            "ms", "plain_ms", "bound_ms", "all_reads_ms") if k in first}

    # --- 2. K1 and K2 against their plain versions ------------------------
    phase("K1 and K2")
    t_ck = rindex_to_device(idx, dev, checkpoint=True)
    t_dn = rindex_to_device(idx, dev, dense=True)
    rng = np.random.default_rng(7)
    pos = T(rng.integers(0, idx.n + 1, N_LANES).astype(np.int32))
    rows = T(rng.integers(0, idx.n_runs, N_LANES).astype(np.int32))
    # the kernels' bit-plane rank table against the checkpoint rows it is
    # derived from, both read on the card
    rpos = T(np.concatenate((rng.integers(0, idx.n + 1, N_RANK - 4),
                             [0, 63, idx.n - 1, idx.n])).astype(np.int32))
    check(torch.equal(rank.planes_rank6(t_ck.ckpt_planes, rpos),
                      rank.ckpt_rank6(t_ck, rpos)),
          "rank6 through the bit-plane table differs from the checkpoint rows")
    log(f"bit-plane rank table: rank6 identical to the checkpoint rows at "
        f"{N_RANK} positions")
    rows_l = rows.long()
    compare("gather_rows", lambda: dense_rank.gather_rows(t_dn.rec, rows),
            lambda: dense_rank.gather_rows_plain(t_dn.rec, rows),
            nbytes=N_LANES * (4 + 32) + gathered(N_LANES * 32, t_dn.rec),
            ops=N_LANES * 8,
            library=lambda: torch.index_select(t_dn.rec, 0, rows_l))
    # rank6 through the lines: the bound counts the function's own bytes (a
    # run id of pos_to_run and a 32-byte record a position, as
    # rank6_pallas reads them), the design's bytes read a 16-byte line in
    # place of the run id
    def dense_design(t, p):
        n, item = p.numel(), t.rec.element_size()
        return (n * 7 * item + gathered(n * 16, t.dense_lines)
                + gathered(n * 8 * item, t.rec))

    compare("rank6_dense",
            lambda: dense_rank.rank6_dense(t_dn, pos),
            lambda: dense_rank.rank6_dense_plain(t_dn.rec, t_dn.pos_to_run, pos),
            nbytes=N_LANES * (4 + 24) + rank_reads(t_dn, pos)[0], ops=N_LANES * 16,
            chain=2, design=dense_design(t_dn, pos))
    # K1 at shapes past the launch floor: 4,194,304 positions (every p & 63
    # of 0 and 63 of the first lines among them), and the gather of every
    # record, the dense table check's
    pos4m = T(np.concatenate((np.arange(0, 64 * 4096, 64), np.arange(63, 64 * 4096, 64),
                              np.random.default_rng(71).integers(
                                  0, idx.n + 2, N_RANK6_BIG - 2 * 4096)))
              .astype(np.int32))
    compare("rank6_dense_4m",
            lambda: dense_rank.rank6_dense(t_dn, pos4m),
            lambda: dense_rank.rank6_dense_plain(t_dn.rec, t_dn.pos_to_run, pos4m),
            nbytes=N_RANK6_BIG * (4 + 24) + rank_reads(t_dn, pos4m)[0],
            ops=N_RANK6_BIG * 16, chain=2, design=dense_design(t_dn, pos4m))
    del pos4m
    runs = torch.arange(idx.n_runs, dtype=torch.int32, device=dev)
    runs_l = runs.long()
    compare("gather_rows_runs", lambda: dense_rank.gather_rows(t_dn.rec, runs),
            lambda: dense_rank.gather_rows_plain(t_dn.rec, runs),
            nbytes=idx.n_runs * (4 + 32) + gathered(idx.n_runs * 32, t_dn.rec),
            ops=idx.n_runs * 8,
            library=lambda: torch.index_select(t_dn.rec, 0, runs_l))
    # K1 at int64 positions: the bench index's dense tables at int64 (the
    # form past 2^31; int64 records, the same lines), rank6 at the same
    # 32768 positions, and every int64 record through the row gather as the
    # dense table check takes it, 16 int32 words a record
    t_dn64 = rindex_to_device(idx, dev, dense=True, dtype=torch.int64)
    check(torch.equal(t_dn64.dense_lines, t_dn.dense_lines),
          "the dense lines of the int64 tables differ from the int32 tables'")
    pos64 = pos.long()
    compare("rank6_dense_int64", lambda: dense_rank.rank6_dense(t_dn64, pos64),
            lambda: dense_rank.rank6_dense_plain(t_dn64.rec, t_dn64.pos_to_run, pos64),
            nbytes=N_LANES * (8 + 48) + rank_reads(t_dn64, pos64)[0], ops=N_LANES * 16,
            chain=2, design=dense_design(t_dn64, pos64))
    check(max_abs_err(dense_rank.rank6_dense(t_dn64, pos64),
                      dense_rank.rank6_dense(t_dn, pos)) == 0,
          "rank6 through the int64 dense tables differs from the int32 tables'")
    words64 = t_dn64.rec.view(torch.int32)
    compare("gather_rows_runs_int64", lambda: dense_rank.gather_rows(words64, runs),
            lambda: dense_rank.gather_rows_plain(words64, runs),
            nbytes=idx.n_runs * (4 + 64) + gathered(idx.n_runs * 64, words64),
            ops=idx.n_runs * 16,
            library=lambda: torch.index_select(words64, 0, runs_l))
    del runs, runs_l, pos64, words64
    k = rng.integers(0, idx.n, N_LANES)
    lanes = [T(a.astype(np.int32)) for a in (
        k, rng.integers(0, idx.n, N_LANES),
        rng.integers(1, np.minimum(idx.n - k, 4096) + 1),
        rng.choice(np.array([1, 2, 3, 5]), N_LANES))]
    fwd = T(rng.integers(0, 2, N_LANES).astype(bool))
    # per lane: k, kp, s, code and the direction in, two 64-byte rows, 3 out
    compare("extend", lambda: fmd.extend(t_ck, *lanes, forward=fwd),
            lambda: fmd.extend_plain(t_ck, *lanes, forward=fwd),
            nbytes=N_LANES * (17 + 12) + gathered(N_LANES * 128, t_ck.ckpt_planes),
            ops=N_LANES * 100, chain=1)
    # the ultra and bucketed tables: their builds' seconds (host and upload,
    # through the first use of the card), rank6 through each provider alone
    # at every kind of position, and K2 through them
    table_s = {}
    for mode in ("checkpoint", "dense", "ultra", "bucketed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        made_t = rindex_to_device(idx, dev, **{mode: True})
        torch.cuda.synchronize()
        table_s[mode] = time.perf_counter() - t0
        if mode == "ultra":
            t_ul = made_t
        elif mode == "bucketed":
            t_bk = made_t
        del made_t
    log("rank tables of the bench index, seconds a build (host arrays, upload, the "
        "derived planes and search trees): " + ", ".join(
            f"{m} {v:.4f}" for m, v in table_s.items())
        + f"; ultra rank_table {t_ul.rank_table.numel() * 4} bytes, bucket_lo "
        f"{t_bk.bucket_lo.numel() * 4} + run_start {t_bk.run_start.numel() * 4} + run_sym "
        f"{t_bk.run_sym.numel()} + cum {t_bk.cum.numel() * 4} bytes (the JAX fields), and "
        f"the run index {t_bk.run_index.numel() * 4} + records {t_bk.run_rec.numel() * 4} "
        f"bytes the kernels read; dense pos_to_run {t_dn.pos_to_run.numel() * 4} + rec "
        f"{t_dn.rec.numel() * 4} bytes (the JAX fields), and the lines "
        f"{t_dn.dense_lines.numel() * 4} bytes the kernels read in place of pos_to_run "
        f"{card}")
    rpos6 = T(np.concatenate((rng.integers(0, idx.n + 2, N_LANES - 3),
                              [0, idx.n, idx.n + 1])).astype(np.int32))
    rpos6_l = rpos6.long()
    compare("rank6_ultra", lambda: rank.rank6_ultra(t_ul, rpos6),
            lambda: rank.rank6_ultra_plain(t_ul, rpos6),
            nbytes=N_LANES * (4 + 24) + gathered(N_LANES * 32, t_ul.rank_table),
            ops=N_LANES * 8, chain=1,
            library=lambda: torch.index_select(t_ul.rank_table, 0, rpos6_l))
    bk_bytes, bk_chain = rank_reads(t_bk, rpos6)
    compare("rank6_bucketed", lambda: rank.rank6_bucketed(t_bk, rpos6),
            lambda: rank.rank6_bucketed_plain(t_bk, rpos6),
            nbytes=N_LANES * (4 + 24) + bk_bytes, ops=N_LANES * 40, chain=bk_chain)
    kernels["rank6_bucketed"]["run_index"] = run_index_stats(
        t_bk.run_index, 0, t_bk.run_shift, t_bk.run_start, t_bk.run_rec, rpos6)
    log(f"run index of the bench index: {kernels['rank6_bucketed']['run_index']} "
        f"(the lookups: rank6_bucketed's {N_LANES} positions)")
    for t, what in ((t_dn, "dense"), (t_ul, "ultra"), (t_bk, "bucketed")):
        # per lane: k, kp, s, code and the direction in, 3 out, and the rank
        # reads of both ends
        ext_bytes, ext_chain = rank_reads(t, torch.cat((lanes[0], lanes[0] + lanes[2])))
        compare(f"extend_{what}", lambda: fmd.extend(t, *lanes, forward=fwd),
                lambda: fmd.extend_plain(t, *lanes, forward=fwd),
                nbytes=N_LANES * (17 + 12) + ext_bytes, ops=N_LANES * 100, chain=ext_chain)
    for t, what in ((t_ck, "checkpoint"), (t_dn, "dense"), (t_ul, "ultra"),
                    (t_bk, "bucketed")):
        for f in (None, fwd):
            compare(f"extend ({what}, "
                    f"{'backward' if f is None else 'both directions'})",
                    lambda: fmd.extend(t, *lanes, forward=f),
                    lambda: fmd.extend_plain(t, *lanes, forward=f), record=False)

    # --- 3. the seed table: the level kernel == host build and plain ---------
    phase("seed tables")
    t0 = time.perf_counter()
    check(np.array_equal(mertable.build_mer_table_device(t_ck, 8).cpu().numpy(),
                         mertable.build_mer_table(idx, 8)),
          "m=8 seed table built by the level kernel differs from the host build")
    log(f"m=8 seed table through the level kernel: identical to the host build "
        f"({time.perf_counter() - t0:.1f} s)")
    def once_ms(fn):
        """(fn()'s result, its milliseconds by events around the one call)."""
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def other_schedule(t, m, last):
        """The m-level build through the same kernel with its last launch
        `last` levels deep: the schedule last_depth did not choose, timed
        beside the shipped one."""
        table = mertable.mer_root(t)
        for _ in range(m - last):
            table = mertable.mer_level(t, table, 1)
        return mertable.mer_level(t, table, last)

    def seed_table_ms(t, m, name):
        """The m-mer table built by the level kernel through tables t: held
        against its plain version (build_mer_table_plain, slabs of parents)
        on the card; its launches (max(m - 1, 1), m through int64 bucketed runs,
        counted by the wrapper); the device time of the whole build by
        CUDA-graph replay, beside the other schedule (the last launch two
        levels deep or one); and what the build must move: the table
        written once, levels 1 to m - 2 written and read once (a fused last
        launch keeps level m - 1 in registers), and per
        level the rank reads of its parents of size > 0, no rank table more
        than once a level. The chain is one rank step's dependent loads a
        level."""
        item, last = t.C.element_size(), mertable.last_depth(t)
        before = mertable.mer_level.launches
        table = mertable.build_mer_table_device(t, m)
        made = mertable.mer_level.launches - before
        check(made == max(m - last + 1, 1), f"the m={m} seed table made {made} level launches")
        plain, plain_ms = once_ms(lambda: mertable.build_mer_table_plain(t, m))
        err = max_abs_err(table, plain)
        check(err == 0, f"the m={m} seed table differs from its plain version by {err}")
        del plain
        ms = gather_probe.time_ms(lambda: mertable.build_mer_table_device(t, m), reps=1)
        other_ms = gather_probe.time_ms(lambda: other_schedule(t, m, 3 - last), reps=1)
        occupied, level = [], mertable.mer_root(t)
        for v in range(m):
            occupied.append(int((level[:, 2] > 0).sum()))
            level = mertable.mer_level(t, level) if v < m - 1 else None
        del level
        step_bytes, step_chain = step_reads(t)
        nbytes = (4 ** m * 3 * item + sum(2 * 4 ** v * 3 * item for v in range(1, m - 1))
                  + sum(gathered(c * step_bytes, *rank_tables(t)) for c in occupied))
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        kernels[name] = dict(
            name=name, route="cuda", source="pangenome_index_tpu_torch/" + SOURCES[name][0],
            replaces=SOURCES[name][1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=t_bytes, bound_by="bytes", library_ms=None, chain_steps=m * step_chain)
        log(f"{name}: m={m} seed table ({table.shape[0]} rows, {table.dtype}) identical to "
            f"its plain version ({plain_ms:.1f} ms) in {made} launches; device {ms:.4f} ms "
            f"(CUDA-graph replay of the build, the last launch {last} deep), "
            f"{other_ms:.4f} ms with it {3 - last} deep; bound by bytes {t_bytes:.5f} ms ({nbytes} bytes; parents of size > 0 "
            f"a level: {occupied}), chain {m * step_chain} gathers {card}")
        del table

    seed_table_ms(t_ck, MER_M, "mer_level")

    # --- 3b. the long-seed dictionary on the card --------------------------
    phase("dictionary")
    t0 = time.perf_counter()
    host_keys, host_vals = sparsedict.build_sparse_dict(idx, SDICT_S)
    host_s = time.perf_counter() - t0
    hk_d, hv_d = T(host_keys), T(host_vals)
    card_s = []
    for t, what in ((t_ck, "checkpoint"), (t_ck, "checkpoint"), (t_dn, "dense")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk, dv = sparsedict.build_sparse_dict_device(idx, t, SDICT_S)
        torch.cuda.synchronize()
        card_s.append(f"{what} {time.perf_counter() - t0:.4f} s")
        err = max(max_abs_err(dk, hk_d), max_abs_err(dv, hv_d))
        check(err == 0, f"s={SDICT_S} dictionary built on the card ({what} rank) "
                        f"differs from the host build by {err}")
    log(f"s={SDICT_S} dictionary: {len(host_keys)} entries; built on the card "
        f"({', '.join(card_s)}; the first holds the warm-up) identical to the host "
        f"build, keys and vals (max difference 0); host build {host_s:.4f} s {card}")
    del dk, dv, hk_d, hv_d

    def hold_levels(t, name, host_keys, host_vals):
        """Every level of an s=SDICT_S build through tables t, the kernel
        against its plain version; the level loop's dictionary against the
        host build; every level's device time by CUDA-graph replay, summed;
        recorded as kernels[name]. What a level must move: an
        entry (8 bytes of key, 3 positions), its rank reads (one or two
        64-byte checkpoint rows, or rank_reads at both ends; the table at
        most once a level), a key and 3 positions a
        kept child (the sum of the bounds of the two kernels a level had
        before, expand and scatter: expand was given the interval and the
        rows, scatter the key and the children written)."""
        item = t.C.element_size()
        sd = dict(nbytes=0, ops=0, ms=0.0, plain_ms=0.0, err=0)
        keys_l = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        vals_l = torch.tensor([[[0, 0, t.n]]], dtype=t.pos_dtype, device=dev)
        counts_l = [1]

        def level_out(res):
            """A level's result as compared: the regions packed as far as
            their totals, the block offsets and the totals."""
            return (*sparsedict.sdict_pack(res[0], res[1], res[3].tolist()), res[2], res[3])

        for level in range(SDICT_S):
            entries = sparsedict.sdict_pack(keys_l, vals_l, counts_l)[1]
            D = entries.shape[0]
            got = sparsedict.sdict_level(t, keys_l, vals_l, counts_l, 1, level)
            plain, ms = once_ms(lambda: sparsedict.sdict_level_plain(
                t, keys_l, vals_l, counts_l, 1, level))
            sd["err"] = max(sd["err"], max_abs_err(level_out(got), level_out(plain)))
            sd["plain_ms"] += ms
            sd["ms"] += gather_probe.time_ms(
                lambda: sparsedict.sdict_level(t, keys_l, vals_l, counts_l, 1, level))
            total = int(got[3].sum())
            if t.ckpt is not None:
                rows = D + int(((entries[:, 0] >> 6)
                                != ((entries[:, 0] + entries[:, 2]) >> 6)).sum())
                rank_b = gathered(rows * 64, t.ckpt_planes)
            else:  # a query at each end of the interval
                rows = 2 * D
                rank_b = rank_reads(t, torch.cat((entries[:, 0],
                                                  entries[:, 0] + entries[:, 2])))[0]
            sd["nbytes"] += D * (8 + 3 * item) + rank_b + total * (8 + 3 * item)
            sd["ops"] += D * 460
            log(f"  level {level}: {D} entries, {rows} rank reads, {total} children kept "
                f"({', '.join(str(c) for c in got[3].tolist())} by branch)")
            keys_l, vals_l, counts_l = got[0], got[1], got[3].tolist()
            del got, plain, entries
        check(all(torch.equal(a, T(b).to(a.dtype)) for a, b in zip(
            sparsedict.sdict_pack(keys_l, vals_l, counts_l), (host_keys, host_vals))),
              f"{name}: the level loop's dictionary differs from the host build")
        check(sd["err"] == 0, f"{name}: kernel differs from its plain version by {sd['err']}")
        del keys_l, vals_l
        # one whole build: its level launches, and its time by events
        # around the call
        made = sparsedict.sdict_level.launches
        _, span = once_ms(lambda: sparsedict.build_sparse_dict_device(t.n, t, SDICT_S))
        made = sparsedict.sdict_level.launches - made
        check(made == SDICT_S, f"an s={SDICT_S} build made {made} level launches")
        t_bytes, t_ops = sd["nbytes"] / PEAK_BYTES_S * 1e3, sd["ops"] / PEAK_OPS_S * 1e3
        kernels[name] = dict(
            name=name, route="cuda",
            source="pangenome_index_tpu_torch/" + SOURCES[name][0],
            replaces=SOURCES[name][1], max_abs_err=sd["err"], ms=sd["ms"],
            plain_ms=sd["plain_ms"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, chain_steps=None)
        log(f"{name}: identical to its plain version at all {SDICT_S} levels; "
            f"{sd['ms']:.4f} ms (device, the {SDICT_S} levels of a whole build, each the "
            f"zeroing of its state and the kernel by CUDA-graph replay) vs plain "
            f"{sd['plain_ms']:.4f} ms, bound {kernels[name]['bound_ms']:.5f} ms by "
            f"{kernels[name]['bound_by']} ({sd['nbytes']} bytes, {sd['ops']} "
            f"operations) {card}")
        log(f"a whole s={SDICT_S} build on the card: {span:.4f} ms by events around the "
            f"call, of which the level launches {sd['ms']:.4f}, the rest (the host's "
            f"reads of each level's totals, the last level's pack) {span - sd['ms']:.4f} "
            f"{card}")

    hold_levels(t_ck, "sdict_level", host_keys, host_vals)
    hold_levels(t_dn, "sdict_level_dense", host_keys, host_vals)
    hold_levels(t_dn64, "sdict_level_dense_int64", host_keys, host_vals)
    hold_levels(t_ul, "sdict_level_ultra", host_keys, host_vals)
    hold_levels(t_bk, "sdict_level_bucketed", host_keys, host_vals)
    seed_table_ms(t_dn, MER_M, "mer_level_dense")
    seed_table_ms(t_dn64, MER_M, "mer_level_dense_int64")
    seed_table_ms(t_ul, MER_M, "mer_level_ultra")
    seed_table_ms(t_bk, MER_M, "mer_level_bucketed")
    # s=31 (a key's last two bits) and min_keep=2 on a small index, every provider
    sidx, _ = synth.build_synth_index(*SMALL_INDEX[:2], seed=SMALL_INDEX[2])
    for mode in RANK_CONFIGS:
        st = rindex_to_device(sidx, dev, **{mode: True})
        for s_, keep in ((31, 1), (31, 2), (SDICT_S, 2)):
            hk, hv = sparsedict.build_sparse_dict(sidx, s_, keep)
            dk, dv = sparsedict.build_sparse_dict_device(sidx, st, s_, keep)
            check(torch.equal(dk, T(hk)) and torch.equal(dv, T(hv)) and len(hk) > 0,
                  f"s={s_}, min_keep={keep} on the small index ({mode} rank) differs "
                  f"from the host build")
    log(f"small index (n={sidx.n}): s=31 and min_keep=2 builds on the card "
        f"identical to the host build, all {len(RANK_CONFIGS)} rank providers")
    del t_dn, t_ul, t_bk, sidx, st

    # --- 4./6. the serving path, both rank configurations -----------------
    phase("serving")
    # no cache holds the dictionary: the checkpoint configuration builds it
    # on the card and writes the cache, the dense one is given no cache
    sdict_path = f"{ri_path}.sdict{SDICT_S}.npz"
    if os.path.exists(sdict_path):
        os.remove(sdict_path)
    port.reset_launches()
    results, batches, span_ms = {}, {}, {}

    def serve_config(cfg, path=None):
        batches[cfg] = prepare(idx, tags, codes, lens, dev, rank_mode=cfg,
                               min_occ=MIN_OCC, mer_m=MER_M, sdict_s=SDICT_S,
                               sdict_path=path)
        results[cfg], span_ms[cfg] = served(batches[cfg])

    serve_config("checkpoint", sdict_path)
    read_launches("serve")
    port.reset_launches()
    serve_config("dense")
    read_launches("serve-dense")
    for path in ("serve", "serve-dense"):
        check(launches[path]["sdict_level"] == SDICT_S,
              f"the {path} path did not build the dictionary on the card")
    check(results["checkpoint"].dict_entries == len(host_keys),
          "serving's dictionary differs from the host build")
    # the ultra and bucketed configurations, each a path of its own: the
    # table check, the seed table and the dictionary (no cache) through
    # their provider, then the reads; both tiers equal the checkpoint
    # configuration's element for element
    for cfg in ("ultra", "bucketed"):
        port.reset_launches()
        serve_config(cfg)
        read_launches(f"serve-{cfg}")
        check(launches[f"serve-{cfg}"]["sdict_level"] == SDICT_S,
              f"the {cfg} configuration did not build the dictionary on the card")
        for tier in ("mer_table", "sdict_vals"):
            check(torch.equal(batches[cfg].seed_kw[tier], batches["checkpoint"].seed_kw[tier]),
                  f"the {tier} built through {cfg} rank differs from the checkpoint build")
    log("the seed table and the dictionary built through the ultra and bucketed "
        "providers: identical to the checkpoint builds, element for element")
    for cfg, r in results.items():
        sec = r.seconds
        log(f"serve [{cfg} rank]: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in sec.items()))
        log(f"serve [{cfg} rank]: dictionary {r.dict_entries} entries, window "
            f"hit rate {r.dict_hit_rate:.4f}")
        log(f"serve [{cfg} rank]: mems.find {span_ms[cfg]['mems.find']:.4f} ms, tags.k4 "
            f"{span_ms[cfg]['tags.k4']:.4f} ms (device, the second call's spans) {card}")

    # --- 5. cross-checks against the native engine (all reads) -----------
    phase("native cross-check")
    r = results["checkpoint"]
    for name in ("count", "start", "end", "bwt_start", "size", "tag_nu", "tag_ov"):
        a = getattr(r, name)
        check(a.shape == ((N_READS,) if name == "count" else (N_READS, MEM_CAP)),
              f"{name} shape {a.shape}")
    t0 = time.perf_counter()
    s, e, b, z, cnt = native.find_mems_native(
        idx, codes, lens, MIN_LEN, MIN_OCC, capacity=MEM_CAP, n_threads=0)
    native_s = time.perf_counter() - t0
    check(np.array_equal(r.count, cnt), "MEM counts differ from the native engine")
    for name, ref in (("start", s), ("end", e), ("bwt_start", b), ("size", z)):
        check(np.array_equal(getattr(r, name), ref),
              f"buffered MEM {name} differs from the native engine")
    eff = np.minimum(cnt, MEM_CAP).astype(np.int64)
    ii = np.repeat(np.arange(N_READS), eff)
    within = np.arange(len(ii)) - np.repeat(np.cumsum(eff) - eff, eff)
    qs = b[ii, within]
    qe = qs + z[ii, within] - 1
    _, tuniq, _ = native.query_tags_native(tags, qs, qe, capacity=256,
                                           n_threads=0)
    ok = ~r.tag_ov[ii, within]
    check(np.array_equal(r.tag_nu[ii, within][ok], tuniq[ok]),
          "tag unique counts differ from the native engine")
    check(not r.tag_nu[r.count[:, None] <= np.arange(MEM_CAP)[None, :]].any(),
          "tag counts in empty MEM slots")
    log(f"native cross-check: {int(cnt.sum())} MEMs over {N_READS} reads, "
        f"counts and all {len(ii)} buffered slots identical; tag unique counts "
        f"identical on {int(ok.sum())} slots ({int((~ok).sum())} overflowed); "
        f"native engine {native_s:.2f} s on {os.cpu_count()} cores")

    for cfg in RANK_CONFIGS[1:]:
        d = results[cfg]
        for name in ("count", "start", "end", "bwt_start", "size", "tag_nu", "tag_ov"):
            check(np.array_equal(getattr(d, name), getattr(r, name)),
                  f"{cfg}-rank configuration differs from checkpoint on {name}")
    log(f"{', '.join(RANK_CONFIGS[1:])} rank configurations: counts, buffers and tags "
        f"identical to checkpoint (and so to the native engine) on all {N_READS} reads")

    # --- 6b. locate on the bench index -------------------------------------
    phase("locate")
    # the intervals of the first buffered MEMs of the serving run, and random
    # ones: half at run heads, half mid-run (a chase from the head), sizes 1
    # to 200 inside the BWT
    lrng = np.random.default_rng(17)
    heads_j = lrng.integers(0, idx.n_runs, N_LOCATE_RANDOM)
    long_runs = np.flatnonzero(idx.run_len > 1)
    mid_j = long_runs[lrng.integers(0, len(long_runs), N_LOCATE_RANDOM // 2)]
    rand_start = np.concatenate((
        idx.run_start[heads_j[: N_LOCATE_RANDOM // 2]],
        idx.run_start[mid_j] + lrng.integers(1, idx.run_len[mid_j])))
    rand_size = np.minimum(lrng.integers(1, 201, N_LOCATE_RANDOM), idx.n - rand_start)
    l_start = np.concatenate((qs[:N_LOCATE_MEMS], rand_start)).astype(np.int32)
    l_size = np.concatenate((z[ii, within][:N_LOCATE_MEMS], rand_size)).astype(np.int32)
    ls, lz = T(l_start), T(l_size)
    port.reset_launches()
    located = locate.locate_batch(t_ck, ls, lz, LOCATE_CAP)
    torch.cuda.synchronize()
    read_launches("locate")
    lpos, lcnt = located.positions.cpu().numpy(), located.count.cpu().numpy()
    check(np.array_equal(lcnt, np.minimum(l_size, LOCATE_CAP))
          and np.array_equal(located.overflow.cpu().numpy(), l_size > LOCATE_CAP),
          "locate counts or overflow flags are wrong")
    # the host model's answer for a sample of lanes: the run head's sample,
    # locate_next up to start, then one a row (RIndex.run_of, locate_next)
    t0 = time.perf_counter()
    sample = lrng.choice(len(l_start), N_LOCATE_HOST, replace=False)
    h_start = l_start[sample].astype(np.int64)
    h_emit = np.minimum(l_size[sample], LOCATE_CAP)
    h_run = idx.run_of(h_start)
    cur = idx.samples[h_run].astype(np.int64)
    left = np.where(h_emit > 0, h_start - idx.run_start[h_run], 0)
    while (left > 0).any():
        go = left > 0
        cur[go] = idx.locate_next(cur[go])
        left[go] -= 1
    host_pos = np.zeros((N_LOCATE_HOST, LOCATE_CAP), np.int64)
    for c in range(int(h_emit.max())):
        host_pos[c < h_emit, c] = cur[c < h_emit]
        go = c + 1 < h_emit
        cur[go] = idx.locate_next(cur[go])
    host_s = time.perf_counter() - t0
    bad = np.flatnonzero((lpos[sample] != host_pos).any(axis=1))
    check(len(bad) == 0, f"{len(bad)} locate lanes differ from the host model "
                         f"(lane {sample[bad[:1]]})")
    lw = locate_work(t_ck, l_start, l_size)
    log(f"locate: {len(l_start)} intervals ({N_LOCATE_MEMS} of the serving run's "
        f"MEMs), identical to the host model on {N_LOCATE_HOST} lanes (its "
        f"locate_next chains {host_s:.2f} s); run search tree of "
        f"{len(t_ck.run_tree_levels)} lines {card}")
    log_locate("locate", lw)
    compare("locate_batch", lambda: locate.locate_batch(t_ck, ls, lz, LOCATE_CAP),
            lambda: locate.locate_batch_plain(t_ck, ls, lz, LOCATE_CAP), plain_reps=1,
            nbytes=lw["nbytes"], ops=lw["ops"], chain=lw["chain"], design=lw["design"])
    # the int64 instantiation on the same index and intervals (int64
    # tables over two-level rows of 2^24 positions: two superblocks), so
    # that its cost is seen apart from the k-copy index's larger tables
    t64 = rindex_to_device(idx, dev, checkpoint=True, super_shift=24, dtype=torch.int64)
    ls64, lz64 = ls.long(), lz.long()
    check(max_abs_err(locate.locate_batch(t64, ls64, lz64, LOCATE_CAP), located) == 0,
          "locate through int64 tables differs from the int32 run")
    same_index = {"locate_batch": (kernels["locate_batch"]["ms"], gather_probe.time_ms(
        lambda: locate.locate_batch(t64, ls64, lz64, LOCATE_CAP)))}
    del located, ls, lz, ls64, lz64

    # --- 2 (cont.). K3 and K4 against their plain versions ----------------
    phase("K3, K4 and the tag search")
    per_read = ("mer_keys", "mer_valid", "sdict_idx")

    def seed_reads(kw, min_occ):
        """(bytes, table) of what resolve_seeds must move at this run's
        positions: every position's dictionary index and its seed out; the
        dictionary's row (3 entries) where it has an entry; where that
        misses or is under min_occ, the window's validity, and where the
        window is valid its m-mer key and row. The bound passes each through
        gathered() (no table more than once); the design moves their sum."""
        item = kw["mer_table"].element_size()
        di, mv = kw["sdict_idx"].reshape(-1), kw["mer_valid"].reshape(-1)
        has = di >= 0
        size = kw["sdict_vals"][di.long().clamp(0, kw["sdict_vals"].shape[0] - 1), 2]
        fall = ~has | (size < max(min_occ, 1))
        valid = int((fall & mv).sum())
        return [(di.numel() * 4, kw["sdict_idx"]), (di.numel() * 4 * item, None),
                (int(has.sum()) * 3 * item, kw["sdict_vals"]),
                (int(fall.sum()), kw["mer_valid"]), (valid * 4, kw["mer_keys"]),
                (valid * 3 * item, kw["mer_table"])]

    def seed_bytes(kw, min_occ):
        """(bound bytes, design bytes) of resolve_seeds: seed_reads'."""
        parts = seed_reads(kw, min_occ)
        return (sum(b if t is None else gathered(b, t) for b, t in parts),
                sum(b for b, _ in parts))

    def k3_inputs(bt, sel):
        """find_mems arguments for the reads `sel` of a batch."""
        return (bt.tables, bt.codes[sel].contiguous(), bt.lengths[sel].contiguous(),
                {k: (v[sel].contiguous() if k in per_read else v)
                 for k, v in bt.seed_kw.items()})

    def k3(fn, inputs, **kw):
        """MemResult fields and the per-read step counts."""
        t, c, n, seed_kw = inputs
        res, stats = fn(t, c, n, MIN_LEN, MIN_OCC, capacity=MEM_CAP,
                        with_stats=True, **seed_kw, **kw)
        return (*res, stats["steps"])

    def k3_ms_of(fn):
        """(K3's device ms, resolve_seeds' device ms, fn()'s result): the mean
        of three calls of fn(), each launching both once, by events around
        each launch."""
        spent, out = launch_ms(fn, "pgt_find_mems", "pgt_resolve_seeds")
        check(all(n == 1 for _, n in spent.values()),
              f"a K3 call launched {spent} (ms, launches a call)")
        return spent["pgt_find_mems"][0], spent["pgt_resolve_seeds"][0], out

    def k3_bytes(steps, t):
        """What K3 must move for reads that take `steps` extension steps
        through tables t: codes, lengths and the resolved seed of every read
        position once, a step's rank reads (step_reads: two 64-byte
        checkpoint rows; the rank tables at most once), the MEM buffers,
        counts and steps out."""
        n = steps.numel()
        return (n * ((READ_LEN + 1) * (1 + 16) + 4)
                + gathered(int(steps.sum()) * step_reads(t)[0], *rank_tables(t))
                + n * (3 * MEM_CAP * 4 + 8))

    # reads in input order: both ends hold easy reads and long chains; the
    # last ones' are recorded for each rank provider
    ends = {"first": slice(0, N_K3), "last": slice(N_READS - N_K3, N_READS)}
    k3_names = {"checkpoint": "find_mems", "dense": "find_mems_dense",
                "ultra": "find_mems_ultra", "bucketed": "find_mems_bucketed"}
    for cfg, bt in batches.items():
        for which, sel in ends.items():
            rec = which == "last" and cfg in k3_names
            inputs = k3_inputs(bt, sel)
            st = k3(mems.find_mems, inputs)[-1]
            compare(k3_names[cfg] if rec else
                    f"find_mems ({cfg} rank, {which} {N_K3} reads)",
                    lambda: k3(mems.find_mems, inputs),
                    lambda: k3(mems.find_mems_plain, inputs),
                    plain_reps=1, record=rec, nbytes=k3_bytes(st, bt.tables),
                    ops=int(st.sum()) * 100,
                    chain=int(st.max()) * step_reads(bt.tables)[1])
    # the seed-resolving pass at the whole batch's shape (seed_reads: what
    # this run's positions read of each tier)
    kw = batches["checkpoint"].seed_kw
    n_pos = kw["sdict_idx"].numel()
    seed_bound, seed_design = seed_bytes(kw, MIN_OCC)
    compare("resolve_seeds",
            lambda: mems.resolve_seeds(N_READS, READ_LEN + 1, MIN_OCC, **kw),
            lambda: mems.resolve_seeds_plain(N_READS, READ_LEN + 1, MIN_OCC, **kw),
            nbytes=seed_bound, ops=n_pos * 12, chain=2, design=seed_design)
    # what bounds the seed pass: the same launch with the dictionary tier
    # alone, with its entries folded into the table's first 2^20 rows (12
    # MB, which L2 holds), and with no entry at all (indices and seeds only)
    sd, di = {k: v for k, v in kw.items() if k.startswith("sdict")}, kw["sdict_idx"]
    seed_parts = {"the dictionary tier alone": sd,
                  "its entries folded into its first 2^20 rows":
                      dict(sd, sdict_idx=torch.where(di >= 0, di % (1 << 20), di)),
                  "no entry (the indices and seeds alone)":
                      dict(sd, sdict_idx=torch.full_like(di, -1))}
    seed_ms = {name: gather_probe.time_ms(
        lambda: mems.resolve_seeds(N_READS, READ_LEN + 1, MIN_OCC, **part))
        for name, part in seed_parts.items()}
    dict_bytes = kw["sdict_vals"].numel() * kw["sdict_vals"].element_size()
    log(f"resolve_seeds, where its time goes: both tiers {kernels['resolve_seeds']['ms']:.4f} "
        "ms; " + "; ".join(f"{name} {ms:.4f} ms" for name, ms in seed_ms.items())
        + f" (the dictionary {dict_bytes} bytes, {int((di >= 0).sum())} of {n_pos} "
        f"positions with an entry) {card}")
    del sd, di, seed_parts
    tt = tags_to_device(tags, dev)
    # the tag search tree (64-byte nodes over the run heads) against
    # searchsorted: every head, its neighbours, the ends of the int32 range
    # and random values, through the kernel that is the descent alone
    levels = len(tt.tree_levels)  # lines one search reads: the tree's depth
    heads64 = tags.bwt_start.astype(np.int64)
    sv_all = T(np.concatenate((
        heads64, heads64 - 1, heads64 + 1, [0, 2**31 - 1],
        np.random.default_rng(11).integers(0, idx.n, N_SEARCH_RANDOM))).astype(np.int32))
    port.reset_launches()
    found = tagquery.tag_upper_bound(tt, sv_all)
    read_launches("tag-search")
    check(torch.equal(found.long(), torch.searchsorted(tt.bwt_start, sv_all, right=True)),
          "the tag search tree differs from searchsorted")
    log(f"tag search tree: {tags.n_runs} run heads, {tt.search_tree.shape[0]} lines "
        f"of 64 bytes beside them, depth {levels} (the heads are the last level); "
        f"identical to torch.searchsorted at {sv_all.numel()} values")
    del sv_all, found
    # the search alone at the shape K6 gives it: the starts of the buffered
    # MEM intervals; per value 4 bytes in and out, one line of each internal
    # level of the tree and one leaf line of the heads
    sv = T(qs.astype(np.int32))
    compare("tag_upper_bound", lambda: tagquery.tag_upper_bound(tt, sv),
            lambda: tagquery.tag_upper_bound_plain(tt, sv),
            nbytes=len(qs) * 8 + gathered(len(qs) * 64, tt.bwt_start)
            + gathered(len(qs) * (levels - 1) * 64, tt.search_tree),
            ops=len(qs) * levels * 32, chain=levels,
            library=lambda: torch.searchsorted(tt.bwt_start, sv, right=True))
    del sv
    bufs = (T(r.bwt_start), T(r.size), T(r.count))
    n_slots = int(np.minimum(r.count, MEM_CAP).sum())
    compare("query_mem_tags",
            lambda: tagquery.query_mem_tags(tt, *bufs, capacity=TAG_CAP),
            lambda: tagquery.query_mem_tags_plain(tt, *bufs, capacity=TAG_CAP),
            nbytes=N_READS * (MEM_CAP * (8 + 5) + 4)
            + gathered(n_slots * TAG_CAP * 8, tt.pos_enc, tt.bwt_start),
            ops=n_slots * (2 * levels * 32 + TAG_CAP * TAG_CAP), chain=levels + 1)

    # K3 on the whole batch: the kernel's own device time (by events
    # around its launch) and its time per dependent extension step (set by
    # the longest read's chain)
    bt = batches["checkpoint"]
    whole = k3_inputs(bt, slice(None))
    k3_ms, seeds_ms, k3_out = k3_ms_of(lambda: k3(mems.find_mems, whole))
    k3_steps = k3_out[-1]
    k3_us_step = k3_ms * 1e3 / int(k3_steps.max())
    k3_bound = k3_bytes(k3_steps, bt.tables) / PEAK_BYTES_S * 1e3
    log(f"K3 kernel on all {N_READS} reads: "
        f"{k3_ms:.4f} ms (device), longest read {int(k3_steps.max())} "
        f"steps (mean {float(k3_steps.float().mean()):.2f}): {k3_us_step:.4f} us "
        f"per dependent step; bound by bytes {k3_bound:.5f} ms; the "
        f"seed-resolving pass before it {seeds_ms:.4f} ms (device) {card}")

    # K3 on the whole batch through the dense, ultra and bucketed providers:
    # the same reads and seeds, the same steps
    for cfg in ("dense", "ultra", "bucketed"):
        ms_c, _, out_c = k3_ms_of(lambda: k3(mems.find_mems, k3_inputs(batches[cfg],
                                                                      slice(None))))
        check(max_abs_err(out_c, k3_out) == 0, f"K3 through {cfg} rank differs from "
                                               f"checkpoint on the whole batch")
        kernels[k3_names[cfg]]["all_reads_ms"] = ms_c
        log(f"K3 kernel on all {N_READS} reads, {cfg} rank: {ms_c:.4f} ms (device), "
            f"{ms_c * 1e3 / int(k3_steps.max()):.4f} us per dependent step; "
            f"{ms_c / k3_ms:.3f}x the checkpoint kernel ({k3_ms:.4f} ms) {card}")
        del out_c
    kernels["find_mems"]["all_reads_ms"] = k3_ms

    # K3's int64 instantiation on the same index, reads and seeds
    kw64 = {k: (v.long() if k in ("mer_table", "sdict_vals") else v)
            for k, v in bt.seed_kw.items()}
    whole64 = (t64, whole[1], whole[2], kw64)
    k3_ms64, _, k3_out64 = k3_ms_of(lambda: k3(mems.find_mems, whole64))
    check(max_abs_err(k3_out64, k3_out) == 0, "K3 through int64 tables differs from int32")
    same_index["find_mems"] = (k3_ms, k3_ms64)
    # K3 through the dense records at int64 positions (DenseRank<int64_t>):
    # the last reads against its plain version, all reads by events beside
    # the int32 dense kernel's
    dense64 = (t_dn64, whole[1], whole[2], kw64)
    last64 = k3_inputs(SimpleNamespace(tables=t_dn64, codes=whole[1], lengths=whole[2],
                                       seed_kw=kw64), ends["last"])
    st64 = k3(mems.find_mems, last64)[-1]
    compare("find_mems_dense_int64", lambda: k3(mems.find_mems, last64),
            lambda: k3(mems.find_mems_plain, last64), plain_reps=1,
            nbytes=st64.numel() * ((READ_LEN + 1) * (1 + 32) + 4)
            + gathered(int(st64.sum()) * step_reads(t_dn64)[0], *rank_tables(t_dn64))
            + st64.numel() * (MEM_CAP * 20 + 8),
            ops=int(st64.sum()) * 100, chain=int(st64.max()) * step_reads(t_dn64)[1])
    ms_d64, _, out_d64 = k3_ms_of(lambda: k3(mems.find_mems, dense64))
    check(max_abs_err(out_d64, k3_out) == 0,
          "K3 through int64 dense records differs from checkpoint on the whole batch")
    kernels["find_mems_dense_int64"]["all_reads_ms"] = ms_d64
    log(f"K3 kernel on all {N_READS} reads, dense records at int64 positions: "
        f"{ms_d64:.4f} ms (device), {ms_d64 / kernels['find_mems_dense']['all_reads_ms']:.3f}x "
        f"the int32 dense kernel ({kernels['find_mems_dense']['all_reads_ms']:.4f} ms) {card}")
    del kw64, whole64, k3_out64, dense64, last64, out_d64

    # where serve.run's device time goes: a profiler trace of 5 runs (device
    # activity only: kernels and copies, each counted once). The profiler
    # loses kernel records on the card (mems_probe.launch_ms), so a trace
    # counts only where it holds every K3 and resolve_seeds launch that the
    # wrappers made; three traces are taken at most
    for _ in range(3):
        made = mems.find_mems.launches, mems.resolve_seeds.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_head()
            t0 = time.perf_counter()
            for _ in range(5):
                run(bt, min_len=MIN_LEN, min_occ=MIN_OCC, capacity=MEM_CAP,
                    tag_capacity=TAG_CAP)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            trace_tail()
        made = mems.find_mems.launches - made[0], mems.resolve_seeds.launches - made[1]
        # the program's spans (spans.py) are profiler annotations, which the
        # profiler gives the device time of the work inside them: left out
        evs = sorted((ev for ev in prof.key_averages()
                      if ev.device_time_total > 0 and TAIL_KERNEL not in ev.key
                      and not ev.key.startswith(("serve.", "mems.", "tags."))),
                     key=lambda ev: -ev.device_time_total)
        seen = tuple(sum(ev.count for ev in evs if name in ev.key)
                     for name in ("find_mems_kernel", "resolve_seeds_kernel"))
        if seen == made:
            break
    if seen != made:
        log(f"serve.run x5 under the profiler: device busy share not measured: each of "
            f"3 traces lost kernel records (the last held {seen} of {made} K3 and "
            f"resolve_seeds launches) {card}")
        evs = []
    else:
        dev_ms = sum(ev.device_time_total for ev in evs) / 1e3
        log(f"serve.run x5 under the profiler: wall {wall_ms:.3f} ms, device busy "
            f"{dev_ms:.3f} ms (share {dev_ms / wall_ms:.4f}) {card}")
    for ev in evs[:10]:
        log(f"  {ev.device_time_total / 1e3 / dev_ms:7.2%} "
            f"{ev.device_time_total / 5e3:.4f} ms/run x{ev.count // 5}  {ev.key[:90]}")
    del batches, bt, whole, inputs

    # --- 7. the gather-rate probe -----------------------------------------
    phase("probe")
    port.reset_launches()
    t0 = time.perf_counter()
    records = list(gather_probe.sweep(dev))
    read_launches("probe")
    for rec in records:
        log(json.dumps({**rec, "card": smi}))
    log(f"probe sweep: {time.perf_counter() - t0:.1f} s")
    chain = {rec["B"]: rec["us_per_iter"] for rec in records
             if rec["kind"] == "gather_chain"}
    log(f"dependent 64-byte gather: {chain[N_READS]:.4f} us per iteration at "
        f"B={N_READS} (probe gather_chain, device time) vs K3 "
        f"{k3_us_step:.4f} us per extension step at {N_READS} reads: K3 step "
        f"= {k3_us_step / chain[N_READS]:.2f} dependent gathers {card}")
    prng = np.random.default_rng(0)
    PT = gather_probe.make_table(prng, dev)
    for G in (1, 8, 64):
        gidx = T(gather_probe.grouped_indices(prng, G, PROBE_GROUP_BATCH))
        for depth in probe_ops.DEPTHS:
            compare("row_gather" if (G, depth) == (1, 4)
                    else f"row_gather (G={G}, depth={depth})",
                    lambda: probe_ops.row_gather(PT, gidx, G, depth),
                    lambda: probe_ops.row_gather_plain(PT, gidx, G, depth),
                    record=(G, depth) == (1, 4),
                    nbytes=PROBE_GROUP_BATCH * (4 + 64)
                    + gathered(PROBE_GROUP_BATCH * 64, PT), ops=PROBE_GROUP_BATCH * 16,
                    library=lambda gl=gidx.long(): torch.index_select(PT, 0, gl))
    cidx = T(prng.integers(0, gather_probe.ROWS, N_READS).astype(np.int32))
    compare("gather_chain", lambda: probe_ops.gather_chain(PT, cidx),
            lambda: probe_ops.gather_chain_plain(PT, cidx), plain_reps=1,
            nbytes=N_READS * 8 + gathered(N_READS * probe_ops.ITERS * 64, PT),
            ops=N_READS * probe_ops.ITERS * 24, chain=probe_ops.ITERS)
    del PT

    # --- 8. the find-mems and query-tags commands -------------------------
    phase("commands")
    cli_dir = os.path.join(cache, "cli")
    os.makedirs(cli_dir, exist_ok=True)

    def reads_file(name, rs):
        path = os.path.join(cli_dir, name)
        with open(path, "wb") as fh:
            fh.write(b"\n".join(rs) + b"\n")
        return path

    def without_seconds(path):
        with open(path, "rb") as fh:
            return b"\n".join(l for l in fh.read().splitlines()
                              if b"seconds" not in l)

    def port_cmd(argv, out):
        """The port's command in this process (its launch counts are this
        process's), stdout (fd 1) to `out` and stderr (fd 2) to `out`.err."""
        seconds = {}
        sys.stdout.flush()
        sys.stderr.flush()
        saved = [os.dup(1), os.dup(2)]
        with open(out, "wb") as fo, open(out + ".err", "wb") as fe:
            os.dup2(fo.fileno(), 1)
            os.dup2(fe.fileno(), 2)
            try:
                rc = port_cli.main(argv, seconds)
                sys.stdout.flush()
                sys.stderr.flush()
            finally:
                os.dup2(saved[0], 1)
                os.dup2(saved[1], 2)
                for fd in saved:
                    os.close(fd)
        check(rc == 0, f"port {argv[0]} exited {rc}")
        return seconds

    def host_find_mems(rs, out, index=None, tag_array=None):
        """find-mems by the port's host route: the native engine's MEMs (its
        buffers hold every MEM of a read here), its tag positions, and its
        formatter, to `out` (the bench index and tags unless others are
        given)."""
        index = idx if index is None else index
        tag_array = tags if tag_array is None else tag_array
        t0 = time.perf_counter()
        c, n = port_cli.pack_reads(rs)
        hs, he, hb, hz, hc = native.find_mems_native(index, c, n, MIN_LEN, MIN_OCC,
                                                     capacity=1024)
        check(int(hc.max()) <= 1024, "a read has more than 1024 MEMs")
        hc = hc.astype(np.int64)
        hi = np.repeat(np.arange(len(rs)), hc)
        hw = np.arange(len(hi)) - np.repeat(np.cumsum(hc) - hc, hc)
        hq = hb[hi, hw]
        tpos, tuniq, _ = native.query_tags_native(tag_array, hq, hq + hz[hi, hw] - 1,
                                                  capacity=256)
        check(int(tuniq.max()) <= 256, "a MEM has more than 256 tag positions")
        with open(out, "wb") as fh:
            native.format_mems_native(hc, hs[hi, hw], he[hi, hw], hq, hz[hi, hw],
                                      tuniq, tpos, fh.fileno())
            fh.write(b"\n")
        return time.perf_counter() - t0

    def host_query_tags(rs, out, index=None, tag_array=None):
        """query-tags by the port's host route: the native engine's backward
        search, then the host tag array's query per read, to `out` (the
        bench index and tags unless others are given)."""
        index = idx if index is None else index
        tag_array = tags if tag_array is None else tag_array
        t0 = time.perf_counter()
        first, second = native.count_native(index, *port_cli.pack_reads(rs))
        with open(out, "w") as fh:
            for i, read in enumerate(rs):
                if first[i] > second[i]:
                    continue
                vals, n_runs = tag_array.query(int(first[i]), int(second[i]))
                fh.write(f"Number of unique positions: {len(vals)}\n"
                         + "".join(f"{v}, " for v in vals)
                         + f"\nread_index={i}\tlen={len(read)}\tbwt_start={first[i]}"
                           f"\tbwt_end={second[i]}\truns={n_runs}\n")
        return time.perf_counter() - t0

    common = [ri_path, tags_path]
    fmt = ["--tags-format", "bytecode"]
    fm_reads = reads_file("find_reads.txt", reads[:CLI_FIND_READS])
    mer_cache = f"{ri_path}.mer{MER_M}.npz"
    for cached in (mer_cache, sdict_path):
        if os.path.exists(cached):
            # the first run builds the seed table and the dictionary
            # through their level kernels
            os.remove(cached)
    port.reset_launches()
    sec = port_cmd(["find-mems", *common, fm_reads, str(MIN_LEN), str(MIN_OCC),
                    *fmt], os.path.join(cli_dir, "find_port.txt"))
    read_launches("find-mems")
    check(launches["find-mems"]["find_mems"] >= 2,
          "find-mems ran no escalation tier through K3")
    with open(os.path.join(cli_dir, "find_port.txt.err")) as fh:
        for line in fh:
            if "escalated" in line or "refind" in line:
                log("  port find-mems: " + line.strip())
    host_s = host_find_mems(reads[:CLI_FIND_READS],
                            os.path.join(cli_dir, "find_host.txt"))
    got = without_seconds(os.path.join(cli_dir, "find_port.txt"))
    check(got == without_seconds(os.path.join(cli_dir, "find_host.txt")),
          "find-mems stdout differs from the port's host route (native engine)")
    log(f"find-mems on {CLI_FIND_READS} reads: stdout byte-equal to the host "
        f"route through the native engine ({len(got)} bytes, "
        f"{got.count(b'MEM START')} MEMs; host route {host_s:.1f} s); port "
        + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()))
    # the same reads through the ultra and bucketed rank tables (the caches
    # beside the index written by the run above): the same bytes
    for mode in ("ultra", "bucketed"):
        out_m = os.path.join(cli_dir, f"find_{mode}.txt")
        sec = port_cmd(["find-mems", *common, fm_reads, str(MIN_LEN), str(MIN_OCC), *fmt,
                        "--rank-mode", mode], out_m)
        check(without_seconds(out_m) == got,
              f"find-mems --rank-mode {mode} differs from the checkpoint run")
        log(f"find-mems --rank-mode {mode} on {CLI_FIND_READS} reads: stdout byte-equal to "
            f"the checkpoint run's; " + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items())
            + f" {card}")
        for suffix in ("", ".err"):
            os.remove(out_m + suffix)

    built = os.path.join(cli_dir, f"built.sdict{SDICT_S}.npz")
    if os.path.exists(built):
        os.remove(built)
    port.reset_launches()
    sec = port_cmd(["build-sdict", ri_path, "-o", built, "-s", str(SDICT_S)],
                   os.path.join(cli_dir, "sdict_port.txt"))
    read_launches("build-sdict")
    with np.load(built, allow_pickle=False) as z:
        check(str(z["key"]) == sparsedict.sparse_dict_key(idx, SDICT_S, 1),
              "build-sdict wrote another content key")
        check(np.array_equal(z["keys"], host_keys) and np.array_equal(z["vals"], host_vals)
              and z["vals"].dtype == host_vals.dtype,
              "build-sdict's file differs from the host build")
    with open(os.path.join(cli_dir, "sdict_port.txt.err")) as fh:
        summary = [line.strip() for line in fh if line.startswith("sparse dict")]
    check(len(summary) == 1, "build-sdict printed no summary line")
    log(f"build-sdict: file identical to the host build ({summary[0]}); "
        + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()) + f" {card}")

    exact = synth.synth_reads(lines, N_READS, READ_LEN, error_rate=0.0, seed=2)
    qt_reads = reads_file("query_reads.txt", exact + reads[:CLI_QUERY_ERRORS])
    port.reset_launches()
    sec = port_cmd(["query-tags", *common, qt_reads, *fmt],
                   os.path.join(cli_dir, "query_port.txt"))
    read_launches("query-tags")
    host_s = host_query_tags(exact + reads[:CLI_QUERY_ERRORS],
                             os.path.join(cli_dir, "query_host.txt"))
    got = without_seconds(os.path.join(cli_dir, "query_port.txt"))
    check(got == without_seconds(os.path.join(cli_dir, "query_host.txt")),
          "query-tags stdout differs from the port's host route (native engine)")
    log(f"query-tags on {len(exact) + CLI_QUERY_ERRORS} reads: stdout "
        f"byte-equal to the host route through the native engine ({len(got)} "
        f"bytes, {got.count(b'read_index=')} reads found; host route "
        f"{host_s:.1f} s); port " + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()))

    # --- 8b. the formats-only commands on the bench index's files --------
    # print-stats' section sums are the files' sizes and its counts the
    # loaded index's; convert-tags of the tags written in the algorithm
    # format gives the bench .tags file's bytes (--no-compat) and the
    # compact writer's (--compact --no-compat); tags-check reports every
    # file's runs. Host work: no kernel is launched.
    phase("formats commands")
    port.reset_launches()
    t0 = time.perf_counter()
    file_idx, file_tags = ri.load_file(ri_path), tagfmt.load_tags_file(tags_path)
    stats = os.path.join(cli_dir, "stats_port.txt")
    port_cmd(["print-stats", ri_path, tags_path, "--runtime"], stats)
    with open(stats) as fh:
        text = fh.read()
    totals = {k: int(v) for k, v in re.findall(r"^TOTAL ([^:]*): (\d+) bytes", text, re.M)}
    runtime = sum(getattr(file_idx, f).nbytes for f in (
        "run_sym", "run_start", "cum", "samples", "last_sorted", "last_to_run"))
    check(totals == {"r-index (on disk)": os.path.getsize(ri_path),
                     "tag arrays (compressed)": os.path.getsize(tags_path),
                     "runtime": runtime},
          f"print-stats' totals {totals} are not the files' sizes and the index's arrays")
    check(all(line in text for line in (
        f"Total sequence length (BWT size): {file_idx.n}\n",
        f"BWT runs (r-index): {file_idx.n_runs}\n", f"Tag array runs: {file_tags.n_runs}\n")),
          "print-stats' counts are not the loaded index's")
    algorithm = os.path.join(cli_dir, "bench_algorithm.tags")
    with open(algorithm, "wb") as fh:
        fh.write(tagfmt.write_algorithm(file_tags))
    converted = {flags: os.path.join(cli_dir, f"converted{i}.tags")
                 for i, flags in enumerate((("--no-compat",), ("--compact", "--no-compat")))}
    for flags, out in converted.items():
        port_cmd(["convert-tags", algorithm, out, *flags], out + ".txt")
    with open(converted[("--no-compat",)], "rb") as fa, open(tags_path, "rb") as fb:
        check(fa.read() == fb.read(), "convert-tags --no-compat differs from the bench .tags")
    with open(converted[("--compact", "--no-compat")], "rb") as fh:
        check(fh.read() == tagfmt.write_compressed_bytecode(file_tags, compact=True),
              "convert-tags --compact --no-compat differs from the compact writer's bytes")
    checked = [tags_path, algorithm, *converted.values()]
    check_out = os.path.join(cli_dir, "tags_check.txt")
    port_cmd(["tags-check", *checked], check_out)
    with open(check_out) as fh:
        check(fh.read() == "".join(f"{p}: {file_tags.n_runs} runs, covers {file_tags.total} "
                                   "BWT positions\n" for p in checked),
              "tags-check's lines are not the loaded tags' runs")
    read_launches("formats")
    check(not any(launches["formats"].values()),
          f"the formats commands launched kernels: {launches['formats']}")
    log(f"print-stats, convert-tags (--no-compat, --compact --no-compat) and tags-check on "
        f"the bench index's files: section sums equal the files' sizes ({totals}), counts "
        f"the loaded index's ({file_idx.n_runs} BWT runs, {file_tags.n_runs} tag runs), "
        f"converted files byte-equal, no kernel launched "
        f"({time.perf_counter() - t0:.1f} s, host)")
    for out in (stats, check_out, *(p + ".txt" for p in converted.values())):
        os.remove(out)
        os.remove(out + ".err")
    for path in (algorithm, *converted.values()):
        os.remove(path)
    del file_idx, file_tags

    all_reads = reads_file("all_reads.txt", reads)
    for name, argv in (("find-mems", ["find-mems", *common, all_reads,
                                      str(MIN_LEN), str(MIN_OCC), *fmt]),
                       ("query-tags", ["query-tags", *common, qt_reads, *fmt])):
        t0 = time.perf_counter()
        port.reset_launches()
        sec = port_cmd(argv, os.path.join(cli_dir, f"timed_{name}.txt"))
        log(f"{name} on all {N_READS if name == 'find-mems' else len(exact) + CLI_QUERY_ERRORS} "
            f"reads (caches warm): {time.perf_counter() - t0:.4f} s; "
            + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()) + f" {card}")
        if name == "find-mems":
            chunked = port.KERNELS["find_mems"].launches
    # --batch-size 0 took the reads in chunks of READ_CHUNK: the same bytes
    # as one launch over all of them
    check(chunked >= -(-N_READS // port_cli.READ_CHUNK),
          f"find-mems --batch-size 0 made {chunked} MEM launches for {N_READS} reads")
    port_cmd(["find-mems", *common, all_reads, str(MIN_LEN), str(MIN_OCC), *fmt,
              "--batch-size", str(N_READS)], os.path.join(cli_dir, "one_launch.txt"))
    check(without_seconds(os.path.join(cli_dir, "timed_find-mems.txt"))
          == without_seconds(os.path.join(cli_dir, "one_launch.txt")),
          "find-mems in chunks differs from one launch over all reads")
    log(f"find-mems on all {N_READS} reads: --batch-size 0 ({chunked} MEM launches, "
        f"chunks of {port_cli.READ_CHUNK}) byte-equal to one launch over them")
    for name in ("timed_find-mems.txt", "timed_query-tags.txt", "one_launch.txt"):
        for suffix in ("", ".err"):
            os.remove(os.path.join(cli_dir, name + suffix))

    # --- 9. K6 and K7 against their plain versions, at the commands' shapes
    phase("K6 and K7")
    # the buffered MEM intervals of the serving batch, at the command line's
    # tag capacity
    mq = (T(qs.astype(np.int32)), T(qe.astype(np.int32)))
    n_tagged = int(tagquery.query_tags_batch(tt, *mq, 256).n_unique.sum())
    for ex in (False, True):
        # interval ends in, a capacity-wide row of positions and three counts
        # out, and the runs it reads
        compare("query_tags_batch (exact)" if ex else "query_tags_batch",
                lambda: tagquery.query_tags_batch(tt, *mq, 256, ex),
                lambda: tagquery.query_tags_batch_plain(tt, *mq, 256, ex),
                record=not ex, nbytes=len(qs) * (8 + 256 * 8 + 9)
                + gathered(n_tagged * 8, tt.pos_enc, tt.bwt_start),
                ops=len(qs) * (2 * levels * 32 + 256), chain=levels + 1)
    # the fill of a tensor of K6's output shape: the yardstick of its write
    fill_ms = gather_probe.time_ms(
        lambda: torch.full((len(qs), 256), -1, dtype=torch.int64, device=dev))
    kernels["query_tags_batch"]["fill_ms"] = fill_ms
    log(f"K6 at {len(qs)} intervals x 256: {kernels['query_tags_batch']['ms']:.4f} ms; "
        f"torch.full of the same shape {fill_ms:.4f} ms (device) {card}")
    # K6 on wide rows: intervals from the first row of a run to the first of
    # the run `span` - 1 after it, 2 to 400 runs wide (a thread's, a warp's
    # and the block's sort; rows past the capacity overflow)
    wrng = np.random.default_rng(13)
    spans = np.concatenate((np.arange(2, 402), wrng.integers(2, 401, N_WIDE - 400)))
    first = wrng.integers(0, tags.n_runs - 401, N_WIDE)
    wq = (T(tags.bwt_start[first].astype(np.int32)),
          T(tags.bwt_start[first + spans - 1].astype(np.int32)))
    for ex in (False, True):
        compare(f"query_tags_batch (wide rows{', exact' if ex else ''})",
                lambda: tagquery.query_tags_batch(tt, *wq, 256, ex),
                lambda: tagquery.query_tags_batch_plain(tt, *wq, 256, ex), record=False)
    wide = tagquery.query_tags_batch(tt, *wq, 256)
    check(bool(wide.overflow.any()) and int(wide.n_unique.max()) > 32,
          "the wide-row comparison reached no row past the capacity or the warp's sort")
    log(f"K6 on {N_WIDE} wide rows (2 to 400 runs, capacity 256): "
        f"{int(wide.overflow.sum())} rows past the capacity, widest row "
        f"{int(wide.n_unique.max())} distinct positions; "
        f"{gather_probe.time_ms(lambda: tagquery.query_tags_batch(tt, *wq, 256)):.4f} ms "
        f"(device) {card}")
    del wide, wq
    qcodes, qlens = port_cli.pack_reads(exact + reads[:CLI_QUERY_ERRORS])
    qc, ql = T(qcodes), T(qlens)
    # a read that occurs takes a step per base; one that does not stops at
    # its first empty range, counted here as one step
    found = count.count(t_ck, qc, ql)
    q_steps = int(torch.where(found[0] <= found[1], ql, 1).sum())
    compare("count", lambda: count.count(t_ck, qc, ql),
            lambda: count.count_plain(t_ck, qc, ql), plain_reps=1,
            nbytes=qc.numel() * 4 + len(qlens) * 12
            + gathered(q_steps * 128, t_ck.ckpt_planes),
            ops=q_steps * 60, chain=int(qlens.max()))
    # K7 through dense records, a path of its own: the same reads, the same
    # answers; per step the rank reads of both ends (a run id and a record
    # each, the function's own), the chain two loads a step
    t_dn = rindex_to_device(idx, dev, dense=True)
    port.reset_launches()
    check(max_abs_err(count.count(t_dn, qc, ql), found) == 0,
          "count through dense records differs from checkpoint rows")
    read_launches("count-dense")
    compare("count_dense", lambda: count.count(t_dn, qc, ql),
            lambda: count.count_plain(t_dn, qc, ql), plain_reps=1,
            nbytes=qc.numel() * 4 + len(qlens) * 12
            + gathered(q_steps * step_reads(t_dn)[0], *rank_tables(t_dn)),
            ops=q_steps * 60, chain=int(qlens.max()) * step_reads(t_dn)[1])
    # and through them at int64 positions, a path of its own
    port.reset_launches()
    check(max_abs_err(count.count(t_dn64, qc, ql), found) == 0,
          "count through int64 dense records differs from checkpoint rows")
    read_launches("count-dense-int64")
    compare("count_dense_int64", lambda: count.count(t_dn64, qc, ql),
            lambda: count.count_plain(t_dn64, qc, ql), plain_reps=1,
            nbytes=qc.numel() * 4 + len(qlens) * 20
            + gathered(q_steps * step_reads(t_dn64)[0], *rank_tables(t_dn64)),
            ops=q_steps * 60, chain=int(qlens.max()) * step_reads(t_dn64)[1])
    del t_dn, t_dn64
    check(max_abs_err(count.count(t64, qc, ql), found) == 0,
          "count through int64 tables differs from int32")
    same_index["count"] = (kernels["count"]["ms"],
                           gather_probe.time_ms(lambda: count.count(t64, qc, ql)))
    log("the int64 instantiations on the bench index itself (two-level rows of 2^24 "
        "positions), identical to the int32 runs: " + ", ".join(
            f"{name} {b:.4f} ms vs int32 {a:.4f} ms ({b / a:.3f}x)"
            for name, (a, b) in same_index.items()) + f" (device) {card}")
    del t64

    # --- 10. the index build from text: build-bwt and build-rindex ---------
    phase("BWT build")
    t0 = time.perf_counter()
    nat = native.build_bwt_native(lines)
    native_s = time.perf_counter() - t0
    keys_np, starts_np, _, top_key = bwt.text_keys(lines)
    n_text = keys_np.size
    card_s = []
    for _ in range(2):  # the first holds the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = bwt.bwt_from_lines_device(lines, dev)
        card_s.append(time.perf_counter() - t0)
    for what, g, w in zip(("bwt", "da", "sa_pos", "seq_lengths"), built, nat):
        check(g.shape == w.shape and np.array_equal(g, w),
              f"the card's {what} differs from native SA-IS")
    check([a.dtype for a in built] == [np.dtype(t) for t in ("uint8", "int64", "int64",
                                                             "int64")],
          "the card's BWT arrays are not uint8, int64, int64, int64")
    log(f"BWT of the bench text ({len(lines)} lines, {n_text} characters) built on the "
        f"card: bwt, da, sa_pos and seq_lengths identical to native SA-IS; card "
        f"{card_s[0]:.4f} s (first call) / {card_s[1]:.4f} s wall, native SA-IS "
        f"{native_s:.4f} s on {os.cpu_count()} cores {card}")
    del built
    # the rounds one by one: each kernel against its plain version at the
    # first round and a plateau round, timed at k = 1 and k = 256 beside
    # torch.sort on the same int64 keys
    keys_d, starts_d = T(keys_np), T(starts_np)
    rank_d, top, k = keys_d, top_key, 0
    ks, bwt_err, bwt_plain, timed = [], {}, {}, {}

    def held(name, got, plain):
        """Hold a BWT kernel's result against its plain version's (timed)."""
        want, ms = once_ms(plain)
        bwt_err[name] = max(bwt_err.get(name, 0), max_abs_err(got, want))
        bwt_plain.setdefault(name, ms)
        return want

    while True:
        bits = max(1, top.bit_length())
        if k in BWT_CHECKED_ROUNDS:
            srt = bwt.bwt_sort_pairs(rank_d, k, bits)
            held("bwt_sort_pairs", srt, lambda: bwt.bwt_sort_pairs_plain(rank_d, k, bits))
            new = bwt.bwt_rerank(*srt)
            held("bwt_rerank", new, lambda: bwt.bwt_rerank_plain(*srt))
            if k in BWT_TIMED_ROUNDS:
                pk = bwt.pair_keys(rank_d, k, bits)
                timed[k] = dict(
                    bits=2 * bits, passes=bwt.sort_passes(k, bits),
                    digit=bwt.digit_bits(k, bits),
                    sort=gather_probe.time_ms(lambda: bwt.bwt_sort_pairs(rank_d, k, bits)),
                    rerank=gather_probe.time_ms(lambda: bwt.bwt_rerank(*srt)),
                    torch_sort=time_ms(lambda: torch.sort(pk, stable=True), 10))
                if k == BWT_TIMED_ROUNDS[-1]:  # the kernels line's shapes
                    bwt_plain["bwt_sort_pairs"] = once_ms(
                        lambda: bwt.bwt_sort_pairs_plain(rank_d, k, bits))[1]
                    bwt_plain["bwt_rerank"] = once_ms(lambda: bwt.bwt_rerank_plain(*srt))[1]
                    # where the rerank's time goes: each of its two launches
                    # by events, and what the store it avoids costs here: the
                    # same n values stored at their destinations by one
                    # random 4-byte store each (scatter_), and in order
                    phases, _ = launch_ms(lambda: bwt.bwt_rerank(*srt), "pgt_bwt_rerank_group",
                                          "pgt_bwt_rerank_scatter")
                    dest = srt[1].long()
                    vals = new[0][dest]
                    out = torch.empty_like(vals)
                    timed[k]["phases"] = {e[4:]: ms for e, (ms, _) in phases.items()}
                    timed[k]["scatter_"] = gather_probe.time_ms(
                        lambda: out.scatter_(0, dest, vals))
                    timed[k]["copy_"] = gather_probe.time_ms(lambda: out.copy_(vals))
                    del dest, vals, out
                del pk
            new = (*new, srt[1])
            del srt
        else:
            new = bwt.doubling_round(rank_d, k, bits)
        ks.append(k)
        # order_d: the round's sort payload, the rotation order after the last
        rank_d, top, order_d = new[0], int(new[1]), new[2]
        del new
        if k and top == n_text - 1:
            break
        k = 2 * k if k else 1
        check(k < n_text, "the BWT rounds ended with ranks not distinct")
    check(set(BWT_TIMED_ROUNDS) <= set(ks), f"the BWT build ran rounds {ks} only")
    check(torch.equal(rank_d[order_d.long()],
                      torch.arange(n_text, dtype=torch.int32, device=dev)),
          "the last round's sort payload is not the inverse of its ranks")
    fin = bwt.bwt_finish(order_d, keys_d, starts_d)
    held("bwt_finish", fin, lambda: bwt.bwt_finish_plain(order_d, keys_d, starts_d))
    finish_ms = gather_probe.time_ms(lambda: bwt.bwt_finish(order_d, keys_d, starts_d))
    del fin
    # where the finish's time goes: its two launches by events, and the
    # inverse of the ranks that it no longer forms (the order it reads is
    # the last round's sort payload), as torch scatter_ and argsort
    finish_phases, _ = launch_ms(lambda: bwt.bwt_finish(order_d, keys_d, starts_d),
                                 "pgt_bwt_finish_symbols", "pgt_bwt_finish_read_off")
    dest, ident = rank_d.long(), torch.arange(n_text, dtype=torch.int32, device=dev)
    inverse = torch.empty_like(order_d)
    check(torch.equal(inverse.scatter_(0, dest, ident), order_d),
          "the scatter_ inverse of the last ranks differs from the kept sort payload")
    inverse_ms = {"scatter_": gather_probe.time_ms(lambda: inverse.scatter_(0, dest, ident)),
                  "argsort": gather_probe.time_ms(lambda: torch.argsort(rank_d))}
    del dest, ident, inverse
    check(all(e == 0 for e in bwt_err.values()),
          f"a BWT kernel differs from its plain version: {bwt_err}")
    log(f"BWT rounds: {len(ks)} (k = {', '.join(map(str, ks))}); the sort, rerank and "
        f"finish kernels identical to their plain versions at k = "
        f"{', '.join(map(str, BWT_CHECKED_ROUNDS))} and the finish (on the last round's "
        f"sort payload, the inverse of its ranks)")
    log(f"bwt_finish {finish_ms:.4f} ms (device), its two launches by events: "
        + ", ".join(f"{e[4:]} {ms:.4f} ms" for e, (ms, _) in finish_phases.items())
        + "; the inverse of the ranks it no longer forms: torch scatter_ "
        f"{inverse_ms['scatter_']:.4f} ms, torch argsort {inverse_ms['argsort']:.4f} ms "
        f"{card}")
    for kk, tm in timed.items():
        log(f"  round k={kk}: {tm['bits']}-bit pair keys, {tm['passes']} digit passes of "
            f"{tm['digit']} bits (the sort's launches: the up-front count, the digit "
            f"starts, one a pass): sort {tm['sort']:.4f} ms + rerank {tm['rerank']:.4f} "
            f"ms (device); torch.sort of the same keys {tm['torch_sort']:.4f} ms {card}")
    plateau = timed[BWT_TIMED_ROUNDS[-1]]
    log(f"bwt_rerank at k = {BWT_TIMED_ROUNDS[-1]}, its two launches by events: "
        + ", ".join(f"{e} {ms:.4f} ms" for e, ms in plateau["phases"].items())
        + f" (groups of {1 << bwt.rerank_group_shift(n_text)} destinations: "
        f"{bwt.rerank_groups(n_text)}); the store it replaces, the same {n_text} values "
        f"at their destinations by random 4-byte stores (torch scatter_): "
        f"{plateau['scatter_']:.4f} ms, against {plateau['copy_']:.4f} ms stored in order "
        f"(copy_) {card}")
    # the whole build: its wall time, and the device time of each kernel's
    # launches (every round's) by events around each launch
    t0 = time.perf_counter()
    bwt.bwt_from_lines_device(lines, dev)
    build_wall = time.perf_counter() - t0
    spent, _ = launch_ms(lambda: bwt.bwt_from_lines_device(lines, dev),
                         "pgt_bwt_sort_pairs", "pgt_bwt_rerank_group",
                         "pgt_bwt_rerank_scatter", "pgt_bwt_finish_symbols",
                         "pgt_bwt_finish_read_off", reps=1)
    made = {e[4:]: n for e, (_, n) in spent.items()}
    check(made == {"bwt_sort_pairs": len(ks), "bwt_rerank_group": len(ks),
                   "bwt_rerank_scatter": len(ks), "bwt_finish_symbols": 1,
                   "bwt_finish_read_off": 1},
          f"a BWT build of {len(ks)} rounds made the launches {made}")
    plan, top_r = [], top_key  # each round's digit passes, from its ranks' width
    rank_r = keys_d
    for kk in ks:
        bits_r = max(1, top_r.bit_length())
        plan.append((kk, bwt.sort_passes(kk, bits_r), bwt.digit_bits(kk, bits_r)))
        rank_r, top_t, _ = bwt.doubling_round(rank_r, kk, bits_r)
        top_r = int(top_t)
    del rank_r
    log("the sort's plan a round (k: passes x digit bits; kernel launches a round "
        "2 + passes): " + ", ".join(f"{kk}: {p}x{d}" for kk, p, d in plan)
        + f"; {sum(2 + p for _, p, _ in plan)} sort kernels a build")
    busy = sum(ms for ms, _ in spent.values())
    log(f"a whole BWT build of {n_text} characters: the kernels {busy:.4f} ms (device) in "
        f"{build_wall:.4f} s wall {card}")
    for e, (ms, n) in spent.items():
        log(f"  {ms:.4f} ms x{n:g}  {e[4:]}")
    # bounds at the kernels line's shapes (k = 256): each input and output
    # once (the sort reads rank, the gathered second rank from the same
    # array, and writes keys and payload; the rerank reads both and writes
    # rank; the finish reads order and the symbol keys and writes bwt, da
    # and sa_pos); the design's own bytes beside them
    passes = plateau["passes"]
    # the sort's own bytes: the up-front pass reads rank (8 a key with the
    # shifted read), the first digit pass reads it again and writes a key and
    # payload (20), each later one reads and writes both (24); per tile and
    # digit a look-back word zeroed, then written twice and read at least once
    sort_words = -(-n_text // bwt.TILE) << plateau["digit"]
    bwt_work = {
        "bwt_sort_pairs": (n_text * 16, n_text * passes * 12, plateau["sort"],
                           plateau["torch_sort"],
                           n_text * (28 + 24 * (passes - 1)) + sort_words * 8 * (1 + 3 * passes)),
        # the rerank's own bytes: its first launch reads keys and order and
        # writes the pairs (20), its second reads them and writes rank (12);
        # a look-back word a tile zeroed, written twice and read once, and
        # the groups' cursors (a 128-byte line each, zeroed)
        "bwt_rerank": (n_text * 16, n_text * 4, plateau["rerank"], None,
                       n_text * 32 + -(-n_text // bwt.TILE) * 8 * 4
                       + bwt.rerank_groups(n_text) * 128),
        # the finish's own bytes: its first launch reads the keys and writes
        # a byte each (5), its second reads the order, gathers a byte and
        # writes 17 (22); operations: the byte (2), the previous index (2),
        # the line search (2 a step) and the offset (1)
        "bwt_finish": (n_text * 25, n_text * (5 + 2 * max(1, (len(lines)).bit_length())),
                       finish_ms, None, n_text * 27),
    }
    for name, (nbytes, ops, ms, lib_ms, design) in bwt_work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        kernels[name] = dict(
            name=name, route="cuda", source="pangenome_index_tpu_torch/" + SOURCES[name][0],
            replaces=SOURCES[name][1], max_abs_err=bwt_err[name], ms=ms,
            plain_ms=bwt_plain[name], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=lib_ms,
            chain_steps=None)
        log(f"{name}: identical to its plain version; {ms:.4f} ms (device, k = "
            f"{BWT_TIMED_ROUNDS[-1]}) vs plain {bwt_plain[name]:.4f} ms, bound "
            f"{kernels[name]['bound_ms']:.5f} ms by {kernels[name]['bound_by']} ({nbytes} "
            f"bytes, {ops} operations); the design's own bytes {design} "
            f"({design / PEAK_BYTES_S * 1e3:.5f} ms)"
            + ("" if lib_ms is None else f", torch.sort {lib_ms:.4f} ms") + f" {card}")
    del rank_d, keys_d, starts_d

    # the commands on the text as a file: build-bwt's file against the
    # native BWT's, build-rindex's .ri against the bench index's
    text_path = os.path.join(cli_dir, "bench_text.txt")
    with open(text_path, "wb") as fh:
        fh.write(b"\n".join(lines) + b"\n")
    native_rl = os.path.join(cli_dir, "native.rl_bwt")
    rlbwt.write_rlbwt(native_rl, rlbwt.rlbwt_from_text(nat[0].tobytes()))
    del nat
    port_rl, port_ri = (os.path.join(cli_dir, f"port.{ext}") for ext in ("rl_bwt", "ri"))
    port.reset_launches()
    sec = port_cmd(["build-bwt", text_path, port_rl], os.path.join(cli_dir, "bwt_port.txt"))
    read_launches("build-bwt")
    check(launches["build-bwt"]["bwt_sort_pairs"] == len(ks)
          and launches["build-bwt"]["bwt_rerank"] == 2 * len(ks)
          and launches["build-bwt"]["bwt_finish"] == 2,
          f"build-bwt made the launches {launches['build-bwt']}, not {len(ks)} rounds' "
          "(a sort and the rerank's two a round, the finish's two)")
    with open(port_rl, "rb") as fa, open(native_rl, "rb") as fb:
        check(fa.read() == fb.read(), "build-bwt's file differs from the native BWT's")
    with open(os.path.join(cli_dir, "bwt_port.txt.err")) as fh:
        summary = fh.read().strip().splitlines()[-1]
    log(f"build-bwt: file byte-equal to the native BWT's ({summary}); "
        + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()) + f" {card}")
    sec = port_cmd(["build-rindex", port_rl, "-o", port_ri],
                   os.path.join(cli_dir, "rindex_port.txt"))
    with open(port_ri, "rb") as fa, open(ri_path, "rb") as fb:
        check(fa.read() == fb.read(), "build-rindex's .ri differs from the bench index's")
    with open(os.path.join(cli_dir, "rindex_port.txt.err")) as fh:
        summary = fh.read().strip().splitlines()[-1]
    log(f"build-rindex: .ri byte-equal to the bench index's serialize_encoded "
        f"({summary}); " + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()) + f" {card}")
    for path in (text_path, native_rl, port_rl, port_ri):
        os.remove(path)

    def bwt_kernel_ms(text_lines):
        """Device ms (CUDA-graph replay) of the sort and the rerank at round
        k = 256 and of the finish, on the BWT build of these lines."""
        keys_np, starts_np, _, top_r = bwt.text_keys(text_lines)
        n_r = keys_np.size
        keys_r, starts_r = T(keys_np), T(starts_np)
        rank_r, kk, out = keys_r, 0, {}
        while True:
            bits_r = max(1, top_r.bit_length())
            if kk == BWT_TIMED_ROUNDS[-1]:
                srt = bwt.bwt_sort_pairs(rank_r, kk, bits_r)
                out["bwt_sort_pairs"] = gather_probe.time_ms(
                    lambda: bwt.bwt_sort_pairs(rank_r, kk, bits_r))
                out["bwt_rerank"] = gather_probe.time_ms(lambda: bwt.bwt_rerank(*srt))
                del srt
            rank_r, top_t, order_r = bwt.doubling_round(rank_r, kk, bits_r)
            top_r = int(top_t)
            if kk and top_r == n_r - 1:
                break
            kk = 2 * kk if kk else 1
        out["bwt_finish"] = gather_probe.time_ms(lambda: bwt.bwt_finish(order_r, keys_r,
                                                                        starts_r))
        return out

    # --- 10b. the graph build: a genome of three chromosomes from its GBZ to
    # merged tags, served (graph_build)
    phase("graph build")
    graph_build(env_ns := SimpleNamespace(
        check=check, log=log, port_cmd=port_cmd, work_dir=os.path.join(cli_dir, "graph"), T=T,
        compare=compare, launch_ms=launch_ms, read_launches=read_launches, kernels=kernels,
        card=card, host_find_mems=host_find_mems, host_query_tags=host_query_tags,
        write_reads=reads_file, without_seconds=without_seconds, read_len=READ_LEN,
        min_len=MIN_LEN, min_occ=MIN_OCC, bwt_kernel_ms=bwt_kernel_ms, bench_rows=n_text))

    # --- 10c. the mesh path: the multi-card path on one card ------------
    phase("mesh")
    mesh_path(SimpleNamespace(
        check=check, log=log, port_cmd=port_cmd, cli_dir=cli_dir, T=T, compare=compare,
        read_launches=read_launches, card=card, without_seconds=without_seconds,
        gathered=gathered, idx=idx, tags=tags, codes=codes, lens=lens, dev=dev,
        ri_path=ri_path, tags_path=tags_path, fm_reads=fm_reads, sdict_path=sdict_path,
        merge_inputs=env_ns.merge_inputs, launches=launches, kernels=kernels,
        launch_ms=launch_ms))
    env_ns.merge_inputs = None

    # --- 10d. the api path: the package's public functions (api_path) ----
    phase("api")
    api_path(SimpleNamespace(
        check=check, log=log, card=card, idx=idx, lines=lines, reads=reads, codes=codes,
        lens=lens, tags=tags, ri_path=ri_path, tags_path=tags_path, dev=dev,
        min_len=MIN_LEN, min_occ=MIN_OCC, mem_cap=MEM_CAP, time_ms=time_ms,
        read_launches=read_launches, launches=launches))

    # --- 11. serve-2g: an index of n >= 2^31 through the int64 kernels ---
    # The k-copy index (k_copy_index): the bench index with every line
    # repeated K_COPIES times, n = 2,160,000,864, built from the bench
    # index's tables. Real in n and in the n-sized tables (checkpoint rows,
    # their planes), not in the run-sized ones: r stays ~2.27 M.
    phase("serve-2g: the k-copy index")
    t0 = time.perf_counter()
    big, big_tags = k_copy_index(idx, tags, K_COPIES)
    check(big.n == K_COPIES * idx.n and big.n >= 2**31, "the k-copy index is not past 2^31")
    big_ri, big_tp = os.path.join(cli_dir, "big.ri"), os.path.join(cli_dir, "big.tags")
    for path, data in ((big_ri, ri.serialize_encoded(big)),
                       (big_tp, tagfmt.write_compressed_bytecode(big_tags))):
        with open(path, "wb") as fh:
            fh.write(data)
    log(f"k-copy index: k={K_COPIES}, n={big.n}, {big.n_runs} runs, {big.n_seq} "
        f"sequences, {big_tags.n_runs} tag runs; as files {os.path.getsize(big_ri)} + "
        f"{os.path.getsize(big_tp)} bytes ({time.perf_counter() - t0:.1f} s)")

    # the path: serving, the tag search, locate and both commands, every
    # kernel in its int64 instantiation; the launches of the comparisons
    # below do not count
    phase("serve-2g: serving")
    port.reset_launches()
    b2 = prepare(big, big_tags, codes, lens, dev, min_occ=MIN_OCC, mer_m=MER_M_2G,
                 sdict_s=SDICT_S)
    r2, ms2 = served(b2)
    t2, tt2 = b2.tables, b2.tag_tables
    check(t2.pos_dtype == torch.int64 and tt2.bwt_start.dtype == torch.int64
          and t2.ckpt_super is not None and t2.super_shift == 30,
          "serve-2g's tables are not int64 over two-level rows")
    check(b2.seed_kw["mer_m"] == MER_M_2G, f"serve-2g's seed table is m={b2.seed_kw['mer_m']}")
    sec = r2.seconds
    log(f"serve-2g: " + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()))
    log(f"serve-2g: {t2.super_S.shape[0]} superblocks, {t2.ckpt_planes.shape[0]} checkpoint "
        f"rows; dictionary {r2.dict_entries} entries; mems.find {ms2['mems.find']:.4f} ms, "
        f"tags.k4 {ms2['tags.k4']:.4f} ms (device, the second call's spans) {card}")
    # the tag search over the int64 run heads: every head, its neighbours,
    # both sides of 2^31 and random values, against searchsorted
    heads2 = torch.from_numpy(big_tags.bwt_start).to(dev)
    sv2 = torch.cat((heads2, heads2 - 1, heads2 + 1,
                     T(np.array([0, 2**31 - 1, 2**31, big.n], np.int64)),
                     T(np.random.default_rng(12).integers(0, big.n, N_SEARCH_RANDOM))))
    found2 = tagquery.tag_upper_bound(tt2, sv2)
    check(torch.equal(found2.long(), torch.searchsorted(tt2.bwt_start, sv2, right=True)),
          "the int64 tag search tree differs from searchsorted")
    log(f"int64 tag search tree: {big_tags.n_runs} run heads up to {int(heads2[-1])}, "
        f"{tt2.search_tree.shape[0]} lines of 8 keys, depth {len(tt2.tree_levels)}; identical "
        f"to torch.searchsorted at {sv2.numel()} values")
    del heads2, sv2, found2
    # locate: the first buffered MEMs of the serving run and random
    # intervals, half at run heads, half mid-run
    eff2 = np.minimum(r2.count, MEM_CAP).astype(np.int64)
    ii2 = np.repeat(np.arange(N_READS), eff2)
    wi2 = np.arange(len(ii2)) - np.repeat(np.cumsum(eff2) - eff2, eff2)
    qs2, qz2 = r2.bwt_start[ii2, wi2], r2.size[ii2, wi2]
    lrng = np.random.default_rng(18)
    heads_j = lrng.integers(0, big.n_runs, N_LOCATE_RANDOM)
    long_runs = np.flatnonzero(big.run_len > 1)
    mid_j = long_runs[lrng.integers(0, len(long_runs), N_LOCATE_RANDOM // 2)]
    rand_start = np.concatenate((big.run_start[heads_j[: N_LOCATE_RANDOM // 2]],
                                 big.run_start[mid_j] + lrng.integers(1, big.run_len[mid_j])))
    rand_size = np.minimum(lrng.integers(1, 201, N_LOCATE_RANDOM), big.n - rand_start)
    l_start2 = np.concatenate((qs2[:N_LOCATE_MEMS], rand_start)).astype(np.int64)
    l_size2 = np.concatenate((qz2[:N_LOCATE_MEMS], rand_size)).astype(np.int64)
    ls2, lz2 = T(l_start2), T(l_size2)
    located2 = locate.locate_batch(t2, ls2, lz2, LOCATE_CAP)
    lpos2, lcnt2 = located2.positions.cpu().numpy(), located2.count.cpu().numpy()
    check(np.array_equal(lcnt2, np.minimum(l_size2, LOCATE_CAP)),
          "serve-2g locate counts are wrong")
    del located2
    # the commands on the files of the big index: find-mems on all reads
    # (neither cache: the m=13 table is past the cache's size and the
    # dictionary is built on the card), query-tags on exact and erring reads
    phase("serve-2g: commands")
    big_sdict = f"{big_ri}.sdict{SDICT_S}.npz"
    if os.path.exists(big_sdict):
        os.remove(big_sdict)
    sec_fm = port_cmd(["find-mems", big_ri, big_tp, all_reads, str(MIN_LEN), str(MIN_OCC),
                       *fmt], os.path.join(cli_dir, "big_find_port.txt"))
    qt2_reads = exact[: N_QT_2G // 2] + reads[: N_QT_2G // 2]
    qt2_file = reads_file("big_query_reads.txt", qt2_reads)
    sec_qt = port_cmd(["query-tags", big_ri, big_tp, qt2_file, *fmt],
                      os.path.join(cli_dir, "big_query_port.txt"))
    read_launches("serve-2g")
    # the bucketed configuration past 2^31, a path of its own: prepare/run
    # through int64 bucketed runs (seed table and dictionary built through
    # them), and find-mems --rank-mode dense on the files, which the
    # reference serves through bucketed runs at this n
    phase("serve-2g: bucketed rank")
    port.reset_launches()
    b2b = prepare(big, big_tags, codes, lens, dev, rank_mode="bucketed", min_occ=MIN_OCC,
                  mer_m=MER_M_2G, sdict_s=SDICT_S)
    r2b, ms2b = served(b2b)
    sec_fd = port_cmd(["find-mems", big_ri, big_tp, all_reads, str(MIN_LEN), str(MIN_OCC),
                       *fmt, "--rank-mode", "dense"],
                      os.path.join(cli_dir, "big_find_dense.txt"))
    read_launches("serve-2g-bucketed")
    t2b = b2b.tables
    check(t2b.pos_dtype == torch.int64 and t2b.bucket_lo is not None and t2b.ckpt is None
          and t2b.cum.shape == (big.n_runs, 6), "serve-2g's bucketed tables are not int64 runs")
    check(b2b.seed_kw["mer_m"] == MER_M_2G
          and torch.equal(b2b.seed_kw["mer_table"], b2.seed_kw["mer_table"])
          and torch.equal(b2b.seed_kw["sdict_vals"], b2.seed_kw["sdict_vals"]),
          "serve-2g: the seed table or dictionary built through bucketed runs differs from "
          "the checkpoint build")
    sec = r2b.seconds
    log(f"serve-2g [bucketed rank]: " + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()))
    log(f"serve-2g [bucketed rank]: bucket_lo {t2b.bucket_lo.numel()} entries, seed table "
        f"and dictionary identical to the checkpoint builds; mems.find "
        f"{ms2b['mems.find']:.4f} ms, tags.k4 {ms2b['tags.k4']:.4f} ms (device, the second "
        f"call's spans) {card}")

    # the dense configuration past 2^31, a path of its own: prepare/run
    # through dense records at int64 positions (the table check gathers
    # every int64 record and ranks every run head through them; the seed
    # table, the dictionary, K3 and K4 on them), then the public route at
    # its defaults, find_mems(to_device(big)), on all reads. pos_to_run is
    # 17 GB of int64, filled on the card from the run lengths; the host's
    # memory is read first, and this process's peak resident memory is
    # sampled while to_device runs
    phase("serve-2g: dense records")
    log(f"host memory before the dense tables: {host_memory()}")
    port.reset_launches()
    b2d = prepare(big, big_tags, codes, lens, dev, rank_mode="dense", min_occ=MIN_OCC,
                  mer_m=MER_M_2G, sdict_s=SDICT_S)
    r2d, ms2d = served(b2d)
    t2d = b2d.tables
    check(t2d.pos_dtype == t2d.rec.dtype == torch.int64 and t2d.ckpt is None
          and t2d.dense_lines is not None and t2d.dense_lines.dtype == torch.int32,
          "serve-2g-dense's tables are not int64 dense records over int32 lines")
    check(torch.equal(b2d.seed_kw["mer_table"], b2.seed_kw["mer_table"])
          and torch.equal(b2d.seed_kw["sdict_vals"], b2.seed_kw["sdict_vals"]),
          "serve-2g: the seed table or dictionary built through int64 dense records differs "
          "from the checkpoint build")
    sec = r2d.seconds
    log(f"serve-2g [dense records, int64]: " + ", ".join(f"{k} {v:.4f} s"
                                                        for k, v in sec.items()))
    log(f"serve-2g [dense records, int64]: pos_to_run {table_bytes_of(t2d.pos_to_run)} + rec "
        f"{table_bytes_of(t2d.rec)} bytes (the JAX fields), the lines "
        f"{table_bytes_of(t2d.dense_lines)} bytes the kernels read; seed table and dictionary "
        f"identical to the checkpoint builds; mems.find {ms2d['mems.find']:.4f} ms, tags.k4 "
        f"{ms2d['tags.k4']:.4f} ms (device, the second call's spans) {card}")
    del b2d, t2d
    torch.cuda.empty_cache()
    k3_before = port.KERNELS["find_mems"].launches
    with PeakRss() as peak:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t2p = port.to_device(big)
        torch.cuda.synchronize()
        to_device_s = time.perf_counter() - t0
    check(t2p.pos_dtype == t2p.rec.dtype == torch.int64 and t2p.bucket_lo is None
          and t2p.ckpt is None and t2p.run_start.device == dev,
          "to_device(big) did not give int64 dense records on the card")
    t0 = time.perf_counter()
    mems2p = port.find_mems(t2p, reads, MIN_LEN, MIN_OCC, capacity=MEM_CAP)
    find_s = time.perf_counter() - t0
    check(port.KERNELS["find_mems"].launches == k3_before + 1,
          "find_mems(to_device(big)) was not one K3 launch")
    read_launches("serve-2g-dense")
    # the lines' derivation alone, as to_device ran it (DENSE_CHUNK_LINES a chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lines2 = derive_dense_lines(t2p.pos_to_run)
    torch.cuda.synchronize()
    lines_s = time.perf_counter() - t0
    check(torch.equal(lines2, t2p.dense_lines), "the dense lines differ between derivations")
    log(f"serve-2g public route: to_device(big) {to_device_s:.4f} s (dense records at int64, "
        f"n = {big.n}; this process's resident memory {peak.start} bytes before, "
        f"{peak.peak} at its peak during the call, sampled every 5 ms); the lines derived "
        f"again alone {lines_s:.4f} s ({lines2.shape[0]} lines, "
        f"{-(-lines2.shape[0] // DENSE_CHUNK_LINES)} chunks); find_mems on all {N_READS} "
        f"reads {find_s:.4f} s {card}")
    del lines2  # t2p stays: the int64 dense kernels are held on it below
    torch.cuda.empty_cache()

    # --- the path's answers: against the native engine, and the 1-copy run
    phase("serve-2g: checks")
    t0 = time.perf_counter()
    s_n, e_n, b_n, z_n, c_n = native.find_mems_native(big, codes, lens, MIN_LEN, MIN_OCC,
                                                      capacity=MEM_CAP, n_threads=0)
    native_s = time.perf_counter() - t0
    check(np.array_equal(r2.count, c_n), "serve-2g: MEM counts differ from the native engine")
    for name, ref in (("start", s_n), ("end", e_n), ("bwt_start", b_n), ("size", z_n)):
        check(np.array_equal(getattr(r2, name), ref),
              f"serve-2g: buffered MEM {name} differs from the native engine")
    qe2 = qs2 + qz2 - 1
    _, tuniq2, _ = native.query_tags_native(big_tags, qs2, qe2, capacity=256, n_threads=0)
    ok2 = ~r2.tag_ov[ii2, wi2]
    check(np.array_equal(r2.tag_nu[ii2, wi2][ok2], tuniq2[ok2]),
          "serve-2g: tag unique counts differ from the native engine")
    log(f"serve-2g native cross-check: {int(c_n.sum())} MEMs over {N_READS} reads, counts "
        f"and all {len(ii2)} buffered slots identical; tag unique counts identical on "
        f"{int(ok2.sum())} slots ({int((~ok2).sum())} overflowed); native engine "
        f"{native_s:.2f} s")
    for name, ref in (("count", c_n), ("start", s_n), ("end", e_n), ("bwt_start", b_n),
                      ("size", z_n)):
        check(np.array_equal(getattr(r2b, name), ref),
              f"serve-2g [bucketed rank]: MEM {name} differs from the native engine")
    check(np.array_equal(r2b.tag_nu[ii2, wi2][ok2], tuniq2[ok2])
          and np.array_equal(r2b.tag_nu, r2.tag_nu) and np.array_equal(r2b.tag_ov, r2.tag_ov),
          "serve-2g [bucketed rank]: tag counts differ from the native engine")
    log(f"serve-2g [bucketed rank]: counts and all {len(ii2)} buffered slots identical to "
        f"the native engine's, tag counts too")
    for name in ("count", "start", "end", "bwt_start", "size", "tag_nu", "tag_ov"):
        check(np.array_equal(getattr(r2d, name), getattr(r2, name)),
              f"serve-2g [dense records, int64]: {name} differs from the checkpoint run")
    expect2 = [list(zip(r2.start[i, :k].tolist(), r2.end[i, :k].tolist(),
                        r2.bwt_start[i, :k].tolist(), r2.size[i, :k].tolist()))
               for i, k in enumerate(eff2.tolist())]
    check(mems2p == expect2,
          "serve-2g: find_mems(to_device(big)) differs from the checkpoint run")
    log(f"serve-2g [dense records, int64]: counts, all {len(ii2)} buffered slots and tag "
        f"counts identical to the checkpoint run's; the public find_mems(to_device(big)) "
        f"gives every read's buffered MEMs of the checkpoint run ({sum(map(len, mems2p))})")
    del r2d, mems2p, expect2
    r1 = results["checkpoint"]
    check(np.array_equal(r2.count, r1.count) and np.array_equal(r2.start, r1.start)
          and np.array_equal(r2.end, r1.end), "serve-2g: MEMs differ from the 1-copy run's")
    check(np.array_equal(r2.bwt_start, K_COPIES * r1.bwt_start.astype(np.int64))
          and np.array_equal(r2.size, K_COPIES * r1.size.astype(np.int64)),
          f"serve-2g: bwt_start and size are not {K_COPIES} times the 1-copy run's")
    # tags: the quirk of the reference's run range (START_EVERY_K) makes the
    # counts depend on how the runs are cut, and the k-copy tag array cuts
    # its k times longer runs at 511 rows; the runs that overlap an interval
    # exactly hold the same positions in both
    q1 = (T(r1.bwt_start[ii2, wi2].astype(np.int32)),
          T((r1.bwt_start + r1.size - 1)[ii2, wi2].astype(np.int32)))
    ex1 = tagquery.query_tags_batch(tt, *q1, 256, True)
    ex2 = tagquery.query_tags_batch(tt2, T(qs2), T(qe2), 256, True)
    both = ~(ex1.overflow | ex2.overflow)
    check(torch.equal(ex1.n_unique[both], ex2.n_unique[both]) and int(both.sum()) > 0,
          "serve-2g: the exact tag positions of the MEMs differ from the 1-copy run's")
    quirk_same = int((r2.tag_nu == r1.tag_nu).sum())
    log(f"serve-2g against the 1-copy run: counts, starts and ends identical, bwt_start and "
        f"size {K_COPIES}x; exact tag positions identical on {int(both.sum())} MEMs; the "
        f"reference's tag counts (run range quirk) equal on {quirk_same} of "
        f"{r2.tag_nu.size} slots")
    # locate against the host model on a sample of lanes
    t0 = time.perf_counter()
    sample = lrng.choice(len(l_start2), N_LOCATE_HOST, replace=False)
    h_start = l_start2[sample]
    h_emit = np.minimum(l_size2[sample], LOCATE_CAP)
    h_run = big.run_of(h_start)
    cur = big.samples[h_run].astype(np.int64)
    left = np.where(h_emit > 0, h_start - big.run_start[h_run], 0)
    while (left > 0).any():
        go = left > 0
        cur[go] = big.locate_next(cur[go])
        left[go] -= 1
    host_pos = np.zeros((N_LOCATE_HOST, LOCATE_CAP), np.int64)
    for c in range(int(h_emit.max())):
        host_pos[c < h_emit, c] = cur[c < h_emit]
        go = c + 1 < h_emit
        cur[go] = big.locate_next(cur[go])
    bad = np.flatnonzero((lpos2[sample] != host_pos).any(axis=1))
    check(len(bad) == 0, f"{len(bad)} serve-2g locate lanes differ from the host model")
    log(f"serve-2g locate: {len(l_start2)} intervals, identical to the host model on "
        f"{N_LOCATE_HOST} lanes ({time.perf_counter() - t0:.2f} s)")
    # the commands' stdout against the port's host route on the same files
    host_s = host_find_mems(reads, os.path.join(cli_dir, "big_find_host.txt"), big, big_tags)
    got = without_seconds(os.path.join(cli_dir, "big_find_port.txt"))
    check(got == without_seconds(os.path.join(cli_dir, "big_find_host.txt")),
          "serve-2g: find-mems stdout differs from the host route (native engine)")
    log(f"serve-2g find-mems on all {N_READS} reads: stdout byte-equal to the host route "
        f"({len(got)} bytes, {got.count(b'MEM START')} MEMs; host route {host_s:.1f} s); "
        f"port " + ", ".join(f"{k} {v:.4f} s" for k, v in sec_fm.items()) + f" {card}")
    check(without_seconds(os.path.join(cli_dir, "big_find_dense.txt")) == got,
          "serve-2g: find-mems --rank-mode dense differs from the checkpoint run")
    log(f"serve-2g find-mems --rank-mode dense (served through int64 bucketed runs) on all "
        f"{N_READS} reads: stdout byte-equal to the checkpoint run's ({len(got)} bytes); "
        f"port " + ", ".join(f"{k} {v:.4f} s" for k, v in sec_fd.items()) + f" {card}")
    host_s = host_query_tags(qt2_reads, os.path.join(cli_dir, "big_query_host.txt"), big,
                             big_tags)
    got = without_seconds(os.path.join(cli_dir, "big_query_port.txt"))
    check(got == without_seconds(os.path.join(cli_dir, "big_query_host.txt")),
          "serve-2g: query-tags stdout differs from the host route (native engine)")
    log(f"serve-2g query-tags on {len(qt2_reads)} reads: stdout byte-equal to the host "
        f"route ({len(got)} bytes, {got.count(b'read_index=')} reads found; host route "
        f"{host_s:.1f} s); port " + ", ".join(f"{k} {v:.4f} s" for k, v in sec_qt.items())
        + f" {card}")
    for name in ("big_find_port.txt", "big_find_host.txt", "big_query_port.txt",
                 "big_query_host.txt", "big_find_dense.txt"):
        for suffix in ("", ".err"):
            if os.path.exists(os.path.join(cli_dir, name + suffix)):
                os.remove(os.path.join(cli_dir, name + suffix))
    for path in (big_sdict, big_ri, big_tp, qt2_file):
        if os.path.exists(path):
            os.remove(path)

    # --- the int64 kernels against their plain versions, timed ----------
    phase("serve-2g: the int64 kernels")
    seed_table_ms(t2, MER_M_2G, "mer_level_int64")
    t0 = time.perf_counter()
    host2_keys, host2_vals = sparsedict.build_sparse_dict(big, SDICT_S)
    log(f"s={SDICT_S} host build on the k-copy index: {len(host2_keys)} entries, "
        f"{host2_vals.dtype} ({time.perf_counter() - t0:.1f} s)")
    check(np.array_equal(host2_keys, host_keys)
          and np.array_equal(host2_vals, K_COPIES * host_vals.astype(np.int64)),
          f"the k-copy dictionary is not the 1-copy one with {K_COPIES}x intervals")
    hold_levels(t2, "sdict_level_int64", host2_keys, host2_vals)
    hold_levels(t2b, "sdict_level_bucketed64", host2_keys, host2_vals)
    seed_table_ms(t2b, MER_M_2G, "mer_level_bucketed64")
    on_the_k_copy_index("sdict_level_dense_int64", lambda: hold_levels(
        t2p, "sdict_level_dense_int64", host2_keys, host2_vals))
    on_the_k_copy_index("mer_level_dense_int64", lambda: seed_table_ms(
        t2p, MER_M_2G, "mer_level_dense_int64"))
    del host2_keys, host2_vals
    rng = np.random.default_rng(27)
    k = rng.integers(0, big.n, N_LANES)
    lanes2 = [T(a.astype(np.int64)) for a in (
        k, rng.integers(0, big.n, N_LANES), rng.integers(1, np.minimum(big.n - k, 4096) + 1))]
    code2 = T(rng.choice(np.array([1, 2, 3, 5]), N_LANES).astype(np.int32))
    fwd2 = T(rng.integers(0, 2, N_LANES).astype(bool))
    compare("extend_int64", lambda: fmd.extend(t2, *lanes2, code2, forward=fwd2),
            lambda: fmd.extend_plain(t2, *lanes2, code2, forward=fwd2),
            nbytes=N_LANES * (24 + 4 + 1 + 24) + gathered(N_LANES * 128, t2.ckpt_planes),
            ops=N_LANES * 100, chain=1)
    # the chain kernels across superblock boundaries: intervals that start
    # just before one and end past it
    bnd = T(((rng.integers(1, t2.super_S.shape[0], N_LANES) << t2.super_shift)
             - rng.integers(1, 3000, N_LANES)).astype(np.int64))
    span = T(rng.integers(1, 6000, N_LANES).astype(np.int64))
    compare("extend_int64 (across superblocks)",
            lambda: fmd.extend(t2, bnd, lanes2[1], span, code2, forward=fwd2),
            lambda: fmd.extend_plain(t2, bnd, lanes2[1], span, code2, forward=fwd2),
            record=False)
    ext2_bytes, ext2_chain = rank_reads(t2b, torch.cat((lanes2[0], lanes2[0] + lanes2[2])))
    compare("extend_bucketed64", lambda: fmd.extend(t2b, *lanes2, code2, forward=fwd2),
            lambda: fmd.extend_plain(t2b, *lanes2, code2, forward=fwd2),
            nbytes=N_LANES * (24 + 4 + 1 + 24) + ext2_bytes, ops=N_LANES * 100,
            chain=ext2_chain)
    # bucketed rank6 alone at 32768 positions of the k-copy index, 0, n, n + 1
    # among them
    rpos2 = T(np.concatenate((rng.integers(0, big.n + 2, N_LANES - 3),
                              [0, big.n, big.n + 1])).astype(np.int64))
    bk2_bytes, bk2_chain = rank_reads(t2b, rpos2)
    compare("rank6_bucketed64", lambda: rank.rank6_bucketed(t2b, rpos2),
            lambda: rank.rank6_bucketed_plain(t2b, rpos2),
            nbytes=N_LANES * (8 + 48) + bk2_bytes, ops=N_LANES * 40, chain=bk2_chain)
    kernels["rank6_bucketed64"]["run_index"] = run_index_stats(
        t2b.run_index, 0, t2b.run_shift, t2b.run_start, t2b.run_rec, rpos2)
    log(f"serve-2g-bucketed: run index {kernels['rank6_bucketed64']['run_index']} (the "
        f"lookups: rank6_bucketed64's {N_LANES} positions); the JAX fields bucket_lo "
        f"{t2b.bucket_lo.numel() * 8} + run_start {t2b.run_start.numel() * 8} + run_sym "
        f"{t2b.run_sym.numel()} + cum {t2b.cum.numel() * 8} bytes {card}")
    # dense rank6 alone at the same positions, through the public route's
    # tables
    on_the_k_copy_index("rank6_dense_int64", lambda: compare(
        "rank6_dense_int64", lambda: dense_rank.rank6_dense(t2p, rpos2),
        lambda: dense_rank.rank6_dense_plain(t2p.rec, t2p.pos_to_run, rpos2),
        nbytes=N_LANES * (8 + 48) + rank_reads(t2p, rpos2)[0], ops=N_LANES * 16,
        chain=2, design=dense_design(t2p, rpos2)))
    del lanes2, bnd, span, rpos2
    kw2 = b2.seed_kw
    check(kw2["sdict_vals"].dtype == kw2["mer_table"].dtype == torch.int64,
          "serve-2g's seed tables are not int64")
    n_pos = kw2["sdict_idx"].numel()
    seed_bound, seed_design = seed_bytes(kw2, MIN_OCC)
    compare("resolve_seeds_int64",
            lambda: mems.resolve_seeds(N_READS, READ_LEN + 1, MIN_OCC, **kw2),
            lambda: mems.resolve_seeds_plain(N_READS, READ_LEN + 1, MIN_OCC, **kw2),
            nbytes=seed_bound, ops=n_pos * 12, chain=2, design=seed_design)
    inputs2 = k3_inputs(b2, ends["last"])
    st2 = k3(mems.find_mems, inputs2)[-1]
    n2 = st2.numel()
    compare("find_mems_int64", lambda: k3(mems.find_mems, inputs2),
            lambda: k3(mems.find_mems_plain, inputs2), plain_reps=1,
            nbytes=n2 * ((READ_LEN + 1) * (1 + 32) + 4)
            + gathered(int(st2.sum()) * 128, t2.ckpt_planes) + n2 * (MEM_CAP * 20 + 8),
            ops=int(st2.sum()) * 100, chain=int(st2.max()))
    for which in ("first",):
        inp = k3_inputs(b2, ends[which])
        compare(f"find_mems_int64 ({which} {N_K3} reads)", lambda: k3(mems.find_mems, inp),
                lambda: k3(mems.find_mems_plain, inp), record=False)
    # K3 through the int64 bucketed runs: the last reads against plain, all
    # reads by events
    inputs2b = k3_inputs(b2b, ends["last"])
    st2b = k3(mems.find_mems, inputs2b)[-1]
    compare("find_mems_bucketed64", lambda: k3(mems.find_mems, inputs2b),
            lambda: k3(mems.find_mems_plain, inputs2b), plain_reps=1,
            nbytes=n2 * ((READ_LEN + 1) * (1 + 32) + 4)
            + gathered(int(st2b.sum()) * step_reads(t2b)[0], *rank_tables(t2b))
            + n2 * (MEM_CAP * 20 + 8),
            ops=int(st2b.sum()) * 100, chain=int(st2b.max()) * step_reads(t2b)[1])
    k3_ms2, seeds_ms2, k3_out2 = k3_ms_of(
        lambda: k3(mems.find_mems, k3_inputs(b2, slice(None))))
    k3_ms2b, _, k3_out2b = k3_ms_of(lambda: k3(mems.find_mems, k3_inputs(b2b, slice(None))))
    check(max_abs_err(k3_out2b, k3_out2) == 0,
          "K3 through int64 bucketed runs differs from the two-level rows on the whole batch")
    kernels["find_mems_bucketed64"]["all_reads_ms"] = k3_ms2b
    log(f"K3 int64 bucketed on all {N_READS} reads of the k-copy index: {k3_ms2b:.4f} ms "
        f"(device), {k3_ms2b / k3_ms2:.3f}x the two-level rows' ({k3_ms2:.4f} ms) {card}")
    del inputs2b, k3_out2b
    # K3 through the public route's int64 dense records: the last reads
    # against plain, all reads by events, with the checkpoint run's seeds
    bt2p = SimpleNamespace(tables=t2p, codes=b2.codes, lengths=b2.lengths,
                           seed_kw=b2.seed_kw)
    inputs2p = k3_inputs(bt2p, ends["last"])
    st2p = k3(mems.find_mems, inputs2p)[-1]
    on_the_k_copy_index("find_mems_dense_int64", lambda: compare(
        "find_mems_dense_int64", lambda: k3(mems.find_mems, inputs2p),
        lambda: k3(mems.find_mems_plain, inputs2p), plain_reps=1,
        nbytes=n2 * ((READ_LEN + 1) * (1 + 32) + 4)
        + gathered(int(st2p.sum()) * step_reads(t2p)[0], *rank_tables(t2p))
        + n2 * (MEM_CAP * 20 + 8),
        ops=int(st2p.sum()) * 100, chain=int(st2p.max()) * step_reads(t2p)[1]))
    k3_ms2p, _, k3_out2p = k3_ms_of(lambda: k3(mems.find_mems, k3_inputs(bt2p, slice(None))))
    check(max_abs_err(k3_out2p, k3_out2) == 0,
          "K3 through int64 dense records differs from the two-level rows on the whole batch")
    kernels["find_mems_dense_int64"]["all_reads_ms"] = k3_ms2p
    log(f"K3 int64 dense on all {N_READS} reads of the k-copy index: {k3_ms2p:.4f} ms "
        f"(device), {k3_ms2p / k3_ms2:.3f}x the two-level rows' ({k3_ms2:.4f} ms); on the "
        f"bench index's int64 dense tables "
        f"{kernels['find_mems_dense_int64']['bench_index']['all_reads_ms']:.4f} ms {card}")
    del bt2p, inputs2p, k3_out2p
    k3_steps2 = k3_out2[-1]
    log(f"K3 int64 on all {N_READS} reads of the k-copy index: {k3_ms2:.4f} ms (device), "
        f"longest read {int(k3_steps2.max())} steps: "
        f"{k3_ms2 * 1e3 / int(k3_steps2.max()):.4f} us per dependent step (int32, the "
        f"bench index: {k3_ms:.4f} ms, {k3_us_step:.4f} us); resolve_seeds {seeds_ms2:.4f} "
        f"ms {card}")
    del inputs2, inp, k3_out2
    bufs2 = (T(r2.bwt_start), T(r2.size), T(r2.count))
    levels2 = len(tt2.tree_levels)
    compare("query_mem_tags_int64",
            lambda: tagquery.query_mem_tags(tt2, *bufs2, capacity=TAG_CAP),
            lambda: tagquery.query_mem_tags_plain(tt2, *bufs2, capacity=TAG_CAP),
            nbytes=N_READS * (MEM_CAP * (16 + 5) + 4)
            + gathered(len(ii2) * TAG_CAP * 8, tt2.pos_enc, tt2.bwt_start),
            ops=len(ii2) * (2 * levels2 * 32 + TAG_CAP * TAG_CAP), chain=levels2 + 1)
    sv2 = T(qs2)
    compare("tag_upper_bound_int64", lambda: tagquery.tag_upper_bound(tt2, sv2),
            lambda: tagquery.tag_upper_bound_plain(tt2, sv2),
            nbytes=len(qs2) * 12 + gathered(len(qs2) * 64, tt2.bwt_start)
            + gathered(len(qs2) * (levels2 - 1) * 64, tt2.search_tree),
            ops=len(qs2) * levels2 * 32, chain=levels2,
            library=lambda: torch.searchsorted(tt2.bwt_start, sv2, right=True))
    mq2 = (sv2, T(qe2))
    n_tagged2 = int(tagquery.query_tags_batch(tt2, *mq2, 256).n_unique.sum())
    for ex in (False, True):
        compare("query_tags_batch_int64 (exact)" if ex else "query_tags_batch_int64",
                lambda: tagquery.query_tags_batch(tt2, *mq2, 256, ex),
                lambda: tagquery.query_tags_batch_plain(tt2, *mq2, 256, ex),
                record=not ex, nbytes=len(qs2) * (16 + 256 * 8 + 9)
                + gathered(n_tagged2 * 8, tt2.pos_enc, tt2.bwt_start),
                ops=len(qs2) * (2 * levels2 * 32 + 256), chain=levels2 + 1)
    del bufs2, sv2, mq2
    found2 = count.count(t2, qc, ql)
    q_steps2 = int(torch.where(found2[0] <= found2[1], ql.long(), 1).sum())
    compare("count_int64", lambda: count.count(t2, qc, ql),
            lambda: count.count_plain(t2, qc, ql), plain_reps=1,
            nbytes=qc.numel() * 4 + len(qlens) * 20
            + gathered(q_steps2 * 128, t2.ckpt_planes),
            ops=q_steps2 * 60, chain=int(qlens.max()))
    del found2
    lw2 = locate_work(t2, l_start2, l_size2)
    log_locate("serve-2g locate", lw2)
    compare("locate_batch_int64", lambda: locate.locate_batch(t2, ls2, lz2, LOCATE_CAP),
            lambda: locate.locate_batch_plain(t2, ls2, lz2, LOCATE_CAP), plain_reps=1,
            nbytes=lw2["nbytes"], ops=lw2["ops"], chain=lw2["chain"], design=lw2["design"])
    del b2, t2, tt2, kw2, ls2, lz2, big, big_tags, b2b, t2b, t2p

    for name, entry in kernels.items():
        src_ = SOURCES[name]
        entry["launches"] = (0 if src_[2] is None else
                             launches[src_[2]][src_[3] if len(src_) > 3 else name])
        # the longest chain of dependent gathers, at this run's gather latency
        steps = entry.pop("chain_steps")
        entry["chain_ms"] = None if steps is None else steps * chain[N_READS] / 1e3
        entry["floor_ms"] = max(entry["bound_ms"], entry["chain_ms"] or 0.0)
        log(f"{name}: {entry['ms']:.4f} ms against a floor of "
            f"{entry['floor_ms']:.5f} ms (bytes or operations "
            f"{entry['bound_ms']:.5f}, chain {entry['chain_ms']}): share "
            f"{entry['floor_ms'] / entry['ms']:.4f} {card}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernels[n] for n in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
